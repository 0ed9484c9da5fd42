"""Route of an extended-coherent search: which surface kernel, at which
window.

Counterpart: gnss_dsp_tpu/acquire/coherent.py::_coh_fast_plan (:346-385)
and the integer planning it calls, pallas_acquire2.plan_aligned /
plan_padded / pick_g (:61-111) and pallas_acquire_coh.plan_coh /
plan_coh_spec (:60-155).  Host Python only.

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
