# Frozen copy of gnss_dsp_tpu_torch/ops/track_step.py at commit 196026d.
# Changed: only the plain correlators are kept (the kernel wrappers and launch plans are left out); epl_correlate_plain takes sum_dtype.
"""One tracking step's early/prompt/late correlators (kernels K3 and K4).

Counterparts: gnss_dsp_tpu/ops/pallas_track2.py:386 `epl_correlate2`
(K3, the per-step route's default) and gnss_dsp_tpu/ops/pallas_track.py:274
`epl_correlate` (K4, behind GNSS_DSP_PALLAS_V1).  Kernels:
csrc/track_step.cu (entries track_step_v2, track_step_v1), on the
per-sample body of csrc/track_corr.cuh that K2 shares.

Contract, the JAX kernels' lane layout in the port's types:

  si int32 [C, 9]  vint_e, vint_p, vint_l, coffset_df, n, coffset_p,
                   carr_df, carr_p0, ptr  (DDS phases and increments as
                   int32 bits; ptr the first sample of the block)
  sf f32 [C, 8]    fr_e, fr_p, fr_l, cf, a0, a1, a6, tm (K4 reads the
                   first 4; rows may be any stride apart)
  x complex64 [N]  the chunk; every block lies inside it
  code int8 [C, L] each channel's code, L chips
  nmax             an upper bound on every channel's n
  lens int32 [C]   optional: each channel's code length L_c <= L, its row
                   zero-padded past it (a mixed-signal table); None: L
  -> f32 [C, 6]    E re, E im, P re, P im, L re, L im

For lag k in (E, P, L) and sample i < n the chip index is
(vint_k + floor(fma(i, cf, fr_k))) floor-mod L_c, the subcarrier factor that
of the lag's phase; the sums of the carrier-wiped samples times chip and
factor are taken in float64 and rounded to float32 once.  The TPU layout
machinery of the JAX kernels (extend_code rows, chip_window, one-hot MXU
routing, bf16 operands) has no counterpart.

Each call is one cluster launch: every channel on S CTAs (step_plan), the
block split over them by its actual n (rank_samples), the LUT and a short
code's row staged in shared memory by bulk copies, the ranks' float64
sums stored into rank 0's shared memory (csrc/track_step.cu).  The launch
allocates only its output, makes no copy of contiguous inputs and no host
synchronisation, so one step can be captured by a CUDA graph.

The wrappers take CUDA tensors and nothing else; LAUNCHES_V2 and
LAUNCHES_V1 count their kernel launches.  epl_correlate_plain is the plain
version of both; track/engine picks it for a chunk on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from gnssbench.reference.track import nco

# the launch plan (csrc/track_step.cu's kThreads, kTile, kMaxCluster)
SMS = 132                 # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 16          # CTAs a cluster (above 8 non-portable)
THREADS = 256             # threads a CTA
TILE = 128                # samples a tile

(SI_VINT_E, SI_VINT_P, SI_VINT_L, SI_COFF_DF, SI_N, SI_COFF_P, SI_CARR_DF,
 SI_CARR_P, SI_PTR) = range(9)
(SF_FR_E, SF_FR_P, SF_FR_L, SF_CF, SF_A0, SF_A1, SF_A6, SF_TM) = range(8)

KINDS = ("none", "subc", "tmboc")                       # K3
FAMILIES = ("none", "boc11", "cboc", "tmboc", "rz_even", "rz_odd")   # K4

# CBOC weights sqrt(10/11), sqrt(1/11) as float32 (e1b.py:52)
CBOC_W1 = np.float32(0.953463)
CBOC_W6 = np.float32(0.301511)
_TMBOC_SLOTS = (0, 4, 6, 29)     # BOC(6,1) chips of each 33 (l1cp.py:202)


def subc_kind(subcarrier: str) -> str:
    """K3's kind of a subcarrier: "none", "tmboc", or "subc" (every
    affine family, its coefficients in the sigp lanes)."""
    return subcarrier if subcarrier in KINDS else "subc"


def _square_waves(cp):
    """(bp, boc, boc6) of float32 code phases cp: floor(2 cp) and
    floor(12 cp) decide the square waves (2 vint and 12 vint are even)."""
    bp = torch.remainder(torch.floor(2.0 * cp).to(torch.int64), 2)
    boc = (1 - 2 * bp).to(torch.float32)
    bp6 = torch.remainder(torch.floor(12.0 * cp).to(torch.int64), 2)
    return bp, boc, (1 - 2 * bp6).to(torch.float32)


def _tmboc(chip, boc, boc6):
    """The TMBOC(6,1,4/33) blend at absolute chip indices `chip` (before
    the mod-L wrap, pallas_track2.py:98-100)."""
    u = torch.remainder(chip, 33)
    slot = torch.zeros_like(boc)
    for k in _TMBOC_SLOTS:
        slot = torch.where(u == k, 1.0, slot)
    return slot * boc6 + (1.0 - slot) * boc


def subcarrier_factor(kind, cp, rel, vint, a0, a1, a6, tm):
    """K3's runtime factor (pallas_track2.py:81-104): "subc" is
    a0 + a1 boc + a6 boc6, "tmboc" adds tm (slot boc6 + (1 - slot) boc).
    cp: float32 code phases [C, W]; rel = floor(cp); vint [C, 1]; the
    coefficients [C, 1] float32.  None for "none"."""
    if kind == "none":
        return None
    _, boc, boc6 = _square_waves(cp)
    affine = a0 + a1 * boc + a6 * boc6
    if kind == "subc":
        return affine
    if kind == "tmboc":
        return affine + tm * _tmboc(vint + rel, boc, boc6)
    raise ValueError(f"unknown K3 subcarrier kind {kind!r}")


def family_factor(family, cp, rel, vint):
    """K4's static factor (pallas_track.py:93-112).  None for "none"."""
    if family == "none":
        return None
    bp, boc, boc6 = _square_waves(cp)
    if family == "boc11":
        return boc
    if family == "cboc":
        return float(CBOC_W1) * boc + float(CBOC_W6) * boc6
    if family == "tmboc":
        return _tmboc(vint + rel, boc, boc6)
    if family == "rz_even":
        return (1 - bp).to(torch.float32)
    if family == "rz_odd":
        return bp.to(torch.float32)
    raise ValueError(f"unknown subcarrier family {family!r}")


def epl_correlate_plain(si, sf, x, code, nmax: int, sub: str = "none",
                        v1: bool = False, lens=None, wiped: bool = False,
                        sum_dtype=torch.float64):
    """The plain version of K3 (v1=False, sub a kind of KINDS) and of K4
    (v1=True, sub a family of FAMILIES): the same sums as a gather over
    an [C, nmax] window, on any device.  wiped: also return (m_re, m_im
    f32 [C, nmax] the carrier-wiped samples, the prompt's chip index
    int64 [C, nmax], the mask i < n), what unknown-code recovery bins."""
    # each product is exact in float64: the rounded sum does not depend on
    # the order of summation
    terms, extra = _epl_terms(si, sf, x, code, nmax, sub, v1, lens,
                              with_wiped=True)
    sums = torch.stack([t.to(sum_dtype).sum(-1) for t in terms],
                       dim=1).to(torch.float32)
    return (sums, extra) if wiped else sums


def _epl_terms(si, sf, x, code, nmax, sub, v1, lens=None,
               with_wiped=False):
    """The terms epl_correlate_plain sums, [E re, E im, P re, P im, L re,
    L im], each float64 [C, nmax]: sample i of the block (0 past its n)
    times the lag's chip and factor, exact in float64.  with_wiped: also
    the wiped samples, prompt chip index and mask (epl_correlate_plain's
    wiped tuple)."""
    dev = x.device
    C, L = code.shape
    L = (torch.full((C, 1), L, dtype=torch.int64, device=dev) if lens is None
         else lens.to(dev, torch.int64)[:, None])
    i = torch.arange(int(nmax), dtype=torch.int64, device=dev)
    si = si.to(torch.int64)
    n = si[:, SI_N]
    start = si[:, SI_PTR]
    pos = start[:, None] + i[None, :]
    mask = (i[None, :] < n[:, None]) & (pos < x.shape[0])
    xb = x[torch.clamp(pos, 0, x.shape[0] - 1)]                 # [C, nmax]

    # fused double LUT mix: offset NCO x carrier NCO == one table angle
    ph1 = ((si[:, SI_COFF_P, None] & nco.MASK32)
           + i * si[:, SI_COFF_DF, None]) & nco.MASK32
    ph2 = ((si[:, SI_CARR_P, None] & nco.MASK32)
           + i * si[:, SI_CARR_DF, None]) & nco.MASK32
    idx = ((ph1 >> nco.LUT_SHIFT) + (ph2 >> nco.LUT_SHIFT)) & (nco.NT - 1)
    wc, ws = nco.cos_sin_of_idx(idx)
    xr, xi = xb.real, xb.imag
    w_re, w_im = xr * wc - xi * ws, xr * ws + xi * wc
    m_re, m_im = w_re.to(torch.float64), w_im.to(torch.float64)

    i_f = i.to(torch.float64)[None, :]
    cf = sf[:, SF_CF].to(torch.float64)[:, None]
    coef = [sf[:, k, None] for k in (SF_A0, SF_A1, SF_A6, SF_TM)] \
        if not v1 else None
    out = []
    for lag in range(3):
        vint = si[:, SI_VINT_E + lag, None]
        fr = sf[:, SF_FR_E + lag].to(torch.float64)[:, None]
        # fr + i*cf rounded once to float32 (the kernel's __fmaf_rn): the
        # float64 product of two float32 values is exact
        cp = (i_f * cf + fr).to(torch.float32)
        rel = torch.floor(cp).to(torch.int64)
        cidx = torch.remainder(vint + rel, L)
        if lag == 1:
            cidx_p = cidx
        chips = torch.gather(code, 1, cidx).to(torch.float32)
        f = (family_factor(sub, cp, rel, vint) if v1
             else subcarrier_factor(sub, cp, rel, vint, *coef))
        if f is not None:
            chips = chips * f
        chips = torch.where(mask, chips, 0.0).to(torch.float64)
        out += [m_re * chips, m_im * chips]
    if with_wiped:
        return out, (w_re, w_im, cidx_p, mask)
    return out
