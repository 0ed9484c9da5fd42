"""Routes of the acquisition searches: which surface kernel, at which
window.  Host Python only.

acq_plan, the non-coherent search.  Counterpart:
gnss_dsp_tpu/acquire/engine.py::_fused_plan (:293-332) and the integer
planning it calls, pallas_acquire2.plan_aligned / plan_padded (:55-107).
It returns (route, window, data_window, n_valid):

  route        "v2": circular search at the window, kernel K1 with its
               in-kernel reduction; "v2p": the pad2 windows without an
               aligned split, searched at a padded FFT length with K1's
               reduction masked to the n exact linear lags; "v1": the
               circular search at a window with neither (Xona X5,
               W = 30690), the full surface from kernel K7, reduced in
               torch
  window       FFT length of the search
  data_window  samples of data in each block window (2n for pad2 and
               sliding signals, else n); zeros follow up to window
  n_valid      on v2p the n lags that are exact linear correlations,
               reported from 0 (lag - (window - n)), else 0

The route is a property of the signal, not of the device: the CPU takes
it too (the JAX package takes its XLA engine on a CPU, :309), so the
plain versions check the same search the kernels run.  On v2p the port
searches at the reference's own padded length (plan_padded: 65536 for
the 61380 windows, 32768 for 30690), powers of two both; any length of
at least 2n would give the same valid cells.  The reference's last test,
pallas_acquire.plan2 (a balanced split, else its XLA engine), chooses
between two computations of the same circular surface, so the port
does not carry it: every window left over is "v1" (the kernels' own
split is ops/acquire2.wide_split).

mesh_plan, the sharded search.  Counterpart: the plan
gnss_dsp_tpu/parallel/acquire.py:181-183 takes, _fused_plan(window) with
no pad2_n (engine.py:293-333): at the 2n window of the pad2 and sliding
signals (n for the others), "v2" where plan_aligned(window) holds, else
"v1".  The sharded search has no padded route: the pad2 windows with no
aligned split (61380, 30690) take v1, the circular search at 2n lags
(kernel K7).  It returns (route, window); the port's kernels choose
their own split (acquire2.core_plan, acquire2.wide_split).

coh_plan, the extended-coherent search.  Counterpart:
gnss_dsp_tpu/acquire/coherent.py::_coh_fast_plan (:346-385) and the
integer planning it calls, pallas_acquire2.plan_aligned / plan_padded /
pick_g (:61-111) and pallas_acquire_coh.plan_coh / plan_coh_spec
(:60-155).

coh_plan returns (mode, window, data_window, n_valid), or None where the
JAX package takes its XLA einsum engine:

  mode         "spec" (spectral combine, kernel K5) or "blk" (per-block
               kernel, K6)
  window       FFT length of the search (2n linear windows for pad2 and
               sliding signals, padded up to an aligned split where 2n has
               none)
  data_window  samples of data in each window (window - data_window
               zeros follow)
  n_valid      on the padded route the n lags that are exact linear
               correlations (the reduction masks the rest), else 0

The route sets the result (linear 2n windows against circular n windows),
so the port follows it exactly, with the JAX package's own constants.  The
TPU tiling the same functions return (bt, pc, ac) does not set the
result and is not carried over.
"""

from __future__ import annotations


MAX_N1 = 512          # pallas_acquire2.MAX_N1
MATS_BUDGET = 4.0e6   # pallas_acquire2.MATS_BUDGET
_VMEM_LIMIT = 15.75e6  # pallas_acquire_coh._VMEM_LIMIT


def _n1_ok(n1: int) -> bool:
    return (128 % n1 == 0) if n1 <= 128 else (n1 % 128 == 0)


def plan_aligned(n: int):
    """(n1, n2) with n2 % 128 == 0 and n1 = n / n2 a divisor or multiple
    of 128, of least n1 + n2 within the matrix budget; ValueError when
    none exists."""
    best = None
    n2 = 128
    while n2 * 2 <= n:
        if n % n2 == 0:
            n1 = n // n2
            mats = 6 * (n1 * n1 + n2 * n2) + 4 * n1 * n2
            if 2 <= n1 <= MAX_N1 and _n1_ok(n1) and mats <= MATS_BUDGET:
                cost = n1 + n2
                if best is None or cost < best[0]:
                    best = (cost, n1, n2)
        n2 += 128
    if best is None:
        raise ValueError(f"{n} has no 128-aligned two-level split")
    return best[1], best[2]


def plan_padded(window: int, max_pad: int = 16384) -> int:
    """Smallest W' >= window (a multiple of 128) with an aligned split."""
    wf = -(-window // 128) * 128
    while wf <= window + max_pad:
        try:
            plan_aligned(wf)
            return wf
        except ValueError:
            wf += 128
    raise ValueError(f"no aligned split within {max_pad} of {window}")


def acq_plan(sig):
    """(route, window, data_window, n_valid) of the non-coherent search
    of `sig`, as _fused_plan(window, pad2_n) with the Pallas kernels
    enabled."""
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    dw = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    try:
        plan_aligned(dw)
        return ("v2", dw, dw, 0)
    except ValueError:
        pass
    if sig.acq_pad2:
        try:
            return ("v2p", plan_padded(dw), dw, n)
        except ValueError:
            pass
    return ("v1", dw, dw, 0)


def mesh_plan(sig):
    """(route, window) of the sharded search of `sig`, as
    _fused_plan(window) with the Pallas kernels enabled and no pad2_n:
    "v2" (K1) where plan_aligned(window) holds, else "v1" (K7); each
    kernel picks its own split of the window."""
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    try:
        plan_aligned(window)
        return ("v2", window)
    except ValueError:
        return ("v1", window)


def pick_g(n1: int) -> int:
    return 128 // n1 if n1 < 128 else 1


def _divisor_bt(m_coh: int, g: int, cap: int) -> int | None:
    for bt in range(min(cap, m_coh), 0, -1):
        if bt % g == 0 and m_coh % bt == 0:
            return bt
    return None


def fits_blk(window: int, m_coh: int, A: int) -> bool:
    """pallas_acquire_coh.plan_coh is not None."""
    try:
        n1, _ = plan_aligned(window)
    except ValueError:
        return False
    g = pick_g(n1)
    if m_coh % g != 0:
        return False
    if _divisor_bt(m_coh, g, max(1, int(3e6 // (24 * window)))) is None:
        return False
    return int(6e6 // (12 * A * window)) >= 1


def _vmem_spec(window, ac, bt, pc):
    return (8 * ac * window * pc + 24 * bt * window
            + 8 * bt * window + 8 * pc * window + 1.5e6)


def fits_spec(window: int) -> bool:
    """pallas_acquire_coh.plan_coh_spec is not None: an aligned split
    with g == 1 and one alignment slot within the VMEM model (every
    larger plan it then searches includes bt = pc = 1 at that size)."""
    try:
        n1, _ = plan_aligned(window)
    except ValueError:
        return False
    return pick_g(n1) == 1 and _vmem_spec(window, 1, 1, 1) <= _VMEM_LIMIT


def coh_plan(sig, n: int, m_coh: int, A: int):
    """(mode, window, data_window, n_valid) or None (XLA engine), as
    _coh_fast_plan(...)[:4] with the Pallas kernels enabled."""
    dw = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n

    def plan_at(window, n_valid):
        if fits_spec(window):
            return ("spec", window, dw, n_valid)
        if fits_blk(window, m_coh, A):
            return ("blk", window, dw, n_valid)
        return None

    r = plan_at(dw, 0)
    if r is not None:
        return r
    if sig.acq_pad2 or sig.acq_sliding:
        try:
            wf = plan_padded(dw)
        except ValueError:
            return None
        return plan_at(wf, n)
    return None
