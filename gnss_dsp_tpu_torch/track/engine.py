"""DLL/FLL/PLL tracking over code-period blocks.

Counterpart: gnss_dsp_tpu/track/engine.py (`TrackParams`, `TrackState`,
`init_state`, `sigp_row` :102-177, `_sub_block_len`, `_mode_of`,
`_track_block` :259-376, `_post_block` :379-505, `_step_pallas` :508-610,
`track_scan` :614-681).  Behavioral contract track-gps-l1.py:13-94: per
block a carrier wipeoff with the running LUT-NCO phase, the doppler-aided
code rate, early/prompt/late correlations with the signal's subcarrier,
an FLL_WIDE -> FLL_NARROW -> PLL schedule, a normalized-envelope EML DLL,
and phase/cycle bookkeeping; long code periods run in `sub` sub-blocks.
Extended-coherent tracking (coh_blocks = M > 1): each block's E/P/L are
wiped by the channel's secondary-overlay chip and summed into
TrackState.cacc, the loop filters see the M-period sums and update only
at each M-period boundary (`_post_block`).

Every block is _geometry (block length, lag chip phases, DDS phases, in
the JAX kernels' si/sf lane layout), one E/P/L correlation, then
_post_block (loop filters and bookkeeping).  track_scan routes a chunk by
its device and the route recorded in TrackParams, as the reference does:

  * CUDA, fused_scan: kernel K2 (ops/track_fused) runs the whole loop,
    every subcarrier family, sub-block and code length, coherent or not;
  * CUDA otherwise: the per-step loop (_scan), one launch of K3
    (pallas_v2) or K4 (ops/track_step) per block;
  * CPU: the same loop on the correlators' plain version
    (track_scan_plain), which is K2's plain version too.

Unknown-code recovery (recover_after >= 0, `_recover`): after block
recover_after, each block's carrier-wiped samples, times the sign of the
prompt's I arm, add into the channel's per-chip bins TrackState.acc_re /
acc_im at the prompt's chip index, in sample order, as the reference's
`.at[].add` in its XLA correlator does (:364-375).  The reference sends
recovery to that correlator (driver.py:125-128), so here it always runs
the plain loop, on the chunk's device (the card's too): that is the
reference's route, not a fallback, and no kernel runs.

A mixed-signal scan (track multi, the receiver) carries each channel's
own code length in its sigp L lane; code_tab is then [C, Lmax], each row
zero-padded past its length, and the chip index wraps at the channel's
own length.

Arithmetic follows the JAX engine op for op in float32, and where the
rounding of one operation decides a later integer (a chip index, a DDS
phase, a cycle count) it is pinned down explicitly, as the reference's
float32 XLA program computes it:

  * division by the sample rate is a multiply by inv_fs, the float32
    reciprocal of fs (XLA rewrites division by a constant that way);
  * the chip-phase recurrence fr + i*cf and the loop-state updates
    (carrier phase, carrier and code frequency) are fused multiply-adds,
    rounded once (XLA contracts them); `fma` below computes them exactly
    in float64 and rounds to float32 once, the CUDA kernels with
    __fmaf_rn.  No other line may be contracted (the kernels are built
    with --fmad=false; never use addcmul or lerp here).

The correlator sums accumulate in float64 and round to float32 once, so
their value does not depend on the order of summation: the kernels and
the plain version give the same bits, and the reference's float32 sums
agree with them to float32 rounding.  The subcarrier factor is float32
arithmetic as the reference writes it.  The uint32 carrier-offset phase
`coffset_p` is an int64 tensor in [0, 2^32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import discriminators as disc
from gnss_dsp_tpu_torch.ops import nco, track_fused, track_step
from gnss_dsp_tpu_torch.utils import profiling
from gnss_dsp_tpu_torch.utils import twofloat as tf

ROW_FIELDS = (
    "block", "p_re", "p_im", "carrier_f", "code_f_minus_nominal",
    "phase_deg", "early", "prompt", "late", "code_p", "carrier_p",
)
INT_FIELDS = ("n", "carrier_dcyc", "code_dcyc")


class TrackParams(NamedTuple):
    """Static per-run parameters (python scalars)."""
    fs: float
    chip_rate: float
    cf_hi: float               # chip_rate/fs split to double-f32 (hi part)
    cf_lo: float               # ... lo part
    code_length: int
    carrier_ratio: float
    el_spacing: float
    coffset_df_fixed: int      # int32 DDS increment for -coffset/fs
    nmax: int                  # longest block the chunk tail must cover
    fll_wide_blocks: int       # mode schedule (--loop-dwells)
    fll_narrow_blocks: int
    fll_wide_k: float = 3.0
    fll_narrow_k: float = 0.8
    pll_k1: float = 0.1
    pll_k2: float = 3.5
    dll_k1: float = 2e-5
    dll_k2: float = 0.2
    code_period_ms: float = 1.0
    sub: int = 1               # sub-blocks per code period
    subcarrier: str = "none"   # none|boc11|cboc|tmboc|rz_even|rz_odd
    recover_after: int = -1    # unknown-code recovery after that block
                               # (-1 off; the plain scan, _recover)
    coh_blocks: int = 1        # extended-coherent periods M (1 = off)
    pallas_v2: bool = False    # per-step route: K3 (True) or K4 (False)
    fused_scan: bool = False   # whole-loop kernel K2


# Per-channel runtime signal constants ("sigp" lanes, f32 [C, 12]), the
# JAX engine's layout.  COH is the channel's coherent span M (1 =
# non-coherent), NOV its overlay period in the overlay table (0 = the
# table's width).
SIGP_CF_HI, SIGP_CF_LO, SIGP_EL, SIGP_L, SIGP_SPP, SIGP_SUB, \
    SIGP_A0, SIGP_A1, SIGP_A6, SIGP_COH, SIGP_NOV, SIGP_TM = range(12)
SIGP_LANES = 12

# every non-TMBOC subcarrier factor is affine in the two square waves,
# factor = a0 + a1*boc1 + a6*boc6; TMBOC rides the gate lane TM
SUBC_COEF = {
    "boc11": (0.0, 1.0, 0.0),
    "cboc": (0.0, float(track_step.CBOC_W1), float(track_step.CBOC_W6)),
    "rz_even": (0.5, 0.5, 0.0),
    "rz_odd": (0.5, -0.5, 0.0),
}


def sigp_row(cf_hi, cf_lo, el, L, spp, sub, subcarrier: str = "none",
             coh: int = 1, nov: int = 0) -> np.ndarray:
    """"none" carries the identity coefficients (1, 0, 0), TMBOC zero
    coefficients and the gate tm = 1; coh and nov the coherent lanes."""
    if subcarrier == "none":
        a0, a1, a6 = 1.0, 0.0, 0.0
    elif subcarrier == "tmboc":
        a0, a1, a6 = 0.0, 0.0, 0.0
    elif subcarrier in SUBC_COEF:
        a0, a1, a6 = SUBC_COEF[subcarrier]
    else:
        raise ValueError(f"no sigp coefficients for subcarrier "
                         f"{subcarrier!r}: pass explicit sigp rows")
    tm = 1.0 if subcarrier == "tmboc" else 0.0
    return np.array([cf_hi, cf_lo, el, L, spp, sub, a0, a1, a6,
                     coh, nov, tm], np.float32)


def sigp_from_params(p: TrackParams, C: int, device) -> torch.Tensor:
    row = sigp_row(p.cf_hi, p.cf_lo, p.el_spacing, p.code_length,
                   p.fs * 0.001 * p.code_period_ms, p.sub, p.subcarrier,
                   coh=p.coh_blocks)
    return torch.from_numpy(np.tile(row, (C, 1))).to(device)


class TrackState(NamedTuple):
    """Per-channel loop state, [C]-shaped leaves."""
    ptr: torch.Tensor          # int32 sample index into the current chunk
    code_p_hi: torch.Tensor    # two-float chips in [0, L)
    code_p_lo: torch.Tensor
    code_f_off: torch.Tensor   # f32 Hz offset from nominal chip rate
    carrier_p: torch.Tensor    # f32 cycles in [0, 1)
    carrier_f: torch.Tensor    # f32 Hz
    coffset_p: torch.Tensor    # int64 in [0, 2^32): uint32 fixed-point turns
    prompt1_re: torch.Tensor   # f32 previous prompt (FLL memory)
    prompt1_im: torch.Tensor
    carrier_e1: torch.Tensor   # f32 previous PLL error
    code_e1: torch.Tensor      # f32 previous DLL error
    block: torch.Tensor        # int32 block counter
    stalled: torch.Tensor      # bool: ran out of chunk samples
    n_full: torch.Tensor       # int32 samples in the current code period
    sub_j: torch.Tensor        # int32 sub-block index within the period
    acc_re: torch.Tensor       # f32 [C, bins] code-recovery bins
    acc_im: torch.Tensor       # ... ([C, 1] zeros when recovery is off)
    cacc: torch.Tensor         # f32 [C, 6] coherent E/P/L sums (re, im of
                               # E, P, L; zeros when coh_blocks == 1)


@profiling.span("track.setup")
def init_state(code_p, code_f_off, carrier_p, carrier_f, ptr=0,
               device="cpu", recover_bins: int = 1) -> TrackState:
    c = np.shape(np.atleast_1d(code_p))[0]

    def as1(v, dt):
        a = np.atleast_1d(np.asarray(v))
        if a.shape[0] != c:
            a = np.full(c, a[0] if a.shape[0] else 0)
        return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(device)

    zeros = np.zeros(c)
    code_p64 = np.atleast_1d(np.asarray(code_p, np.float64))
    cp_hi = code_p64.astype(np.float32)
    cp_lo = (code_p64 - cp_hi.astype(np.float64)).astype(np.float32)
    return TrackState(
        ptr=as1(ptr, np.int32),
        code_p_hi=as1(cp_hi, np.float32),
        code_p_lo=as1(cp_lo, np.float32),
        code_f_off=as1(code_f_off, np.float32),
        carrier_p=as1(carrier_p, np.float32),
        carrier_f=as1(carrier_f, np.float32),
        coffset_p=as1(zeros, np.int64),
        prompt1_re=as1(zeros, np.float32),
        prompt1_im=as1(zeros, np.float32),
        carrier_e1=as1(zeros, np.float32),
        code_e1=as1(zeros, np.float32),
        block=as1(zeros, np.int32),
        stalled=as1(zeros, bool),
        n_full=as1(zeros, np.int32),
        sub_j=as1(zeros, np.int32),
        acc_re=torch.zeros((c, int(recover_bins)), dtype=torch.float32,
                           device=device),
        acc_im=torch.zeros((c, int(recover_bins)), dtype=torch.float32,
                           device=device),
        cacc=torch.zeros((c, 6), dtype=torch.float32, device=device),
    )


def _sub_block_len(sub_j, n_full, sub):
    """int(((j+1)*nf)/sub) - int((j*nf)/sub) without the j*nf product
    (overflow-safe split nf = q*sub + r)."""
    q = torch.div(n_full, sub, rounding_mode="floor")
    r = n_full - q * sub
    return (q + torch.div((sub_j + 1) * r, sub, rounding_mode="floor")
            - torch.div(sub_j * r, sub, rounding_mode="floor"))


def _mode_of(block, p: TrackParams):
    """0 until fll_wide_blocks, 1 until +fll_narrow_blocks, then 2."""
    m = (block >= p.fll_wide_blocks).to(torch.int32)
    return torch.where(block >= p.fll_wide_blocks + p.fll_narrow_blocks,
                       2, m)


def fma(a, b, c):
    """a*b + c rounded once to float32: the product of two float32
    values is exact in float64, so the float64 sum rounded to float32 is
    that single rounding (up to a double-rounding tie, ~2^-29 of cases).
    a, b, c: float32 tensors or python floats, broadcastable."""
    d = torch.float64
    a, b, c = (v.to(d) if isinstance(v, torch.Tensor)
               else float(np.float32(v)) for v in (a, b, c))
    return (a * b + c).to(torch.float32)


def _as_i32(v):
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _geometry(x_len: int, chunk_len, ratio, st: TrackState, p: TrackParams,
              coffset_df, sp):
    """One block's geometry for all C channels: the adaptive block length,
    the three lags' integer and fractional chip phases, the two DDS phases
    and increments, as the correlators' si/sf lanes (ops/track_step).
    Returns (si, sf, n, sub_j_next, n_full, ok, cf_dyn)."""
    ifs = nco.inv_fs(p.fs)
    Lf = sp[:, SIGP_L]
    spp = sp[:, SIGP_SPP]
    sub_i = sp[:, SIGP_SUB].to(torch.int32)
    el = sp[:, SIGP_EL]

    # adaptive block length targeting the next code boundary (:160-163),
    # once per period, cut into sub-blocks at the reference's int(j*n/sub)
    # boundaries (track-galileo-e1b.py:164-166)
    code_p = st.code_p_hi + st.code_p_lo
    n_f = torch.where(code_p < Lf / 2, spp * (Lf - code_p) / Lf,
                      spp * (2 * Lf - code_p) / Lf)
    n_full = torch.where(st.sub_j == 0, n_f.to(torch.int32), st.n_full)
    n = _sub_block_len(st.sub_j, n_full, sub_i).to(torch.int32)
    sub_j_next = torch.where(st.sub_j + 1 == sub_i, 0,
                             st.sub_j + 1).to(torch.int32)
    ok = torch.logical_and(torch.logical_not(st.stalled),
                           st.ptr + n <= chunk_len)

    # the reference's dynamic_slice clamps its window into the chunk; the
    # tail pad of track_file keeps that from ever moving it (see track_scan)
    start = torch.clamp(st.ptr, 0, x_len - p.nmax)

    # doppler-aided code rate (:44-48) and the lags' int/frac chip phases
    cf_dyn = (st.code_f_off + st.carrier_f / ratio) * ifs
    cf = sp[:, SIGP_CF_HI] + cf_dyn

    def split(lag):
        v = tf.tf_add_f((st.code_p_hi, st.code_p_lo), lag)
        vint = torch.floor(v[0] + v[1])
        return vint.to(torch.int32), tf.tf_value(tf.tf_add_f(v, -vint))

    (ve, fe), (vp, fp), (vl, fl) = (split(-el), split(torch.zeros_like(el)),
                                    split(el))
    carr_df = nco.freq_to_fixed_t(-st.carrier_f * ifs)
    carr_p0 = nco.fixed_u32(torch.remainder(st.carrier_p, 1.0))
    si = torch.stack([ve, vp, vl, coffset_df.to(torch.int32), n,
                      _as_i32(st.coffset_p), carr_df.to(torch.int32),
                      _as_i32(carr_p0), start.to(torch.int32)], dim=1)
    sf = torch.stack([fe, fp, fl, cf, sp[:, SIGP_A0], sp[:, SIGP_A1],
                      sp[:, SIGP_A6], sp[:, SIGP_TM]], dim=1)
    return si, sf, n, sub_j_next, n_full, ok, cf_dyn


def _post_block(p_early, p_prompt, p_late, n, sub_j_next, n_full_new, ok,
                cf_dyn, st: TrackState, p: TrackParams, coffset_df, sp,
                s_ovl=None):
    """Loop-filter updates and bookkeeping after the three correlations
    (track-gps-l1.py:50-92), for all channels.  Returns (state, row_f
    [C, 11], row_i [C, 3]).

    With p.coh_blocks > 1, s_ovl [C] is this block's overlay chip (+-1):
    it wipes the block's E/P/L, which add into st.cacc; the loop filters
    see the sums and advance only at the channel's M-period boundary u
    (M the sigp COH lane), where cacc resets.  The row carries the
    block's wiped correlators."""
    L = sp[:, SIGP_L]

    coh = p.coh_blocks > 1
    if coh:
        p_early, p_prompt, p_late = ((s_ovl * c[0], s_ovl * c[1])
                                     for c in (p_early, p_prompt, p_late))
        acc = st.cacc + torch.stack([p_early[0], p_early[1], p_prompt[0],
                                     p_prompt[1], p_late[0], p_late[1]],
                                    dim=1)
        M = torch.clamp(sp[:, SIGP_COH].to(torch.int32), min=1)
        u = torch.remainder(st.block + 1, M) == 0
        cacc_new = torch.where(u[:, None], 0.0, acc)
        f_early, f_prompt, f_late = ((acc[:, k], acc[:, k + 1])
                                     for k in (0, 2, 4))
    else:
        cacc_new = st.cacc
        f_early, f_prompt, f_late = p_early, p_prompt, p_late

    # carrier phase bookkeeping (:38-42); dcyc counts whole cycles
    n_f = n.to(torch.float32)
    carrier_p_new = fma(-(n_f * st.carrier_f), nco.inv_fs(p.fs),
                        st.carrier_p)
    t = torch.remainder(carrier_p_new, 1.0)
    carrier_dcyc = torch.round(carrier_p_new - t).to(torch.int32)
    coffset_p_new = (st.coffset_p + n.to(torch.int64)
                     * coffset_df.to(torch.int64)) & nco.MASK32

    # carrier loop (:50-70); prompt1 only refreshed in FLL modes
    mode = _mode_of(st.block, p)
    e_fll = disc.fll_atan(f_prompt, (st.prompt1_re, st.prompt1_im))
    e_pll = disc.pll_costas(f_prompt)
    fll_k = torch.where(mode == 0, p.fll_wide_k, p.fll_narrow_k
                        ).to(torch.float32)
    pll = mode == 2
    carrier_f_new = torch.where(
        pll,
        fma(p.pll_k2, e_pll - st.carrier_e1,
            fma(p.pll_k1, e_pll, st.carrier_f)),
        fma(fll_k, e_fll, st.carrier_f),
    )
    carrier_e1_new = torch.where(pll, e_pll, st.carrier_e1)
    prompt1_re_new = torch.where(pll, st.prompt1_re, f_prompt[0])
    prompt1_im_new = torch.where(pll, st.prompt1_im, f_prompt[1])

    # code loop: normalized-envelope EML DLL (:74-86), on the sums
    def env(c):
        return torch.sqrt(c[0] * c[0] + c[1] * c[1])

    early, prompt, late = env(p_early), env(p_prompt), env(p_late)
    f_e, f_l = (env(f_early), env(f_late)) if coh else (early, late)
    denom = f_l + f_e
    zero = denom == 0
    e_dll = torch.where(zero, 0.0,
                        (f_l - f_e) / torch.where(zero, 1.0, denom))
    code_f_off_new = fma(p.dll_k2, e_dll - st.code_e1,
                         fma(p.dll_k1, e_dll, st.code_f_off))

    if coh:
        # the loop filters advance only at the M-period boundary
        carrier_f_new = torch.where(u, carrier_f_new, st.carrier_f)
        carrier_e1_new = torch.where(u, carrier_e1_new, st.carrier_e1)
        prompt1_re_new = torch.where(u, prompt1_re_new, st.prompt1_re)
        prompt1_im_new = torch.where(u, prompt1_im_new, st.prompt1_im)
        code_f_off_new = torch.where(u, code_f_off_new, st.code_f_off)
        e_dll = torch.where(u, e_dll, st.code_e1)

    # code phase advance (:88-92) in two-float
    cfh = sp[:, SIGP_CF_HI], sp[:, SIGP_CF_LO]
    adv = tf.tf_mul_f(cfh, n_f)
    adv = tf.tf_add_f(adv, n_f * cf_dyn)
    cp_new = tf.tf_add((st.code_p_hi, st.code_p_lo), adv)
    (cp_hi, cp_lo), wraps = tf.tf_mod(cp_new, L)
    tc = cp_hi + cp_lo
    code_dcyc = (wraps * L).to(torch.int32)

    new = TrackState(
        ptr=st.ptr + n,
        code_p_hi=cp_hi,
        code_p_lo=cp_lo,
        code_f_off=code_f_off_new,
        carrier_p=t,
        carrier_f=carrier_f_new,
        coffset_p=coffset_p_new,
        prompt1_re=prompt1_re_new,
        prompt1_im=prompt1_im_new,
        carrier_e1=carrier_e1_new,
        code_e1=e_dll,
        block=st.block + 1,
        stalled=st.stalled,
        n_full=n_full_new,
        sub_j=sub_j_next,
        acc_re=st.acc_re,          # recovery bins: _recover, gated on ok
        acc_im=st.acc_im,
        cacc=cacc_new,
    )
    # freeze the channel if the chunk ran dry (host refills and resumes)
    new = TrackState(*[torch.where(ok.view(-1, *[1] * (b.dim() - 1)), a,
                                   b).to(b.dtype)
                       for a, b in zip(new, st)])
    new = new._replace(stalled=torch.logical_not(ok))

    row_f = torch.stack([
        st.block.to(torch.float32),
        p_prompt[0], p_prompt[1],
        carrier_f_new, code_f_off_new,
        (180.0 / math.pi) * torch.atan2(p_prompt[1], p_prompt[0]),
        early, prompt, late, tc, t,
    ], dim=-1)
    row_i = torch.stack([n, carrier_dcyc, code_dcyc], dim=-1)
    row_f = torch.where(ok[:, None], row_f, float("nan"))
    row_i = torch.where(ok[:, None], row_i, 0)
    return new, row_f, row_i


def plain_correlate(p: TrackParams):
    """The correlators' plain version for p's subcarrier (K3's form; K4's
    static families give the same values).  lens: each channel's code
    length where the table is wider (a mixed-signal scan), else None."""
    kind = track_step.subc_kind(p.subcarrier)
    return lambda si, sf, x, code, lens=None: track_step.epl_correlate_plain(
        si, sf, x, code, p.nmax, kind, lens=lens)


def kernel_correlate(p: TrackParams):
    """K3 (p.pallas_v2) or K4 on p's subcarrier; called through the
    module, one launch a block."""
    if p.pallas_v2:
        kind = track_step.subc_kind(p.subcarrier)
        return lambda si, sf, x, code, lens=None: track_step.epl_correlate2(
            si, sf, x, code, p.nmax, kind, lens)
    if p.subcarrier not in track_step.FAMILIES:
        raise ValueError(f"K4 needs the subcarrier family, got "
                         f"{p.subcarrier!r}")
    return lambda si, sf, x, code, lens=None: track_step.epl_correlate(
        si, sf, x, code, p.nmax, p.subcarrier, lens)


def code_lens(code_tab, sigp):
    """Each channel's code length (int32 [C], the sigp L lane) where one
    differs from the table's width (a mixed-signal table), else None."""
    lens = sigp[:, SIGP_L].to(torch.int32)
    return None if bool((lens == code_tab.shape[1]).all()) else lens


def _recover(st: TrackState, new: TrackState, p: TrackParams, ok, prompt_re,
             wiped):
    """The recovery bins after one block (engine.py:364-375): once block
    > recover_after, the block's wiped samples (m_re, m_im f32 [C,
    nmax], their prompt chip index cidx [C, nmax], mask i < n) times the
    sign of the prompt's I arm add into new.acc_re / acc_im, where ok."""
    m_re, m_im, cidx, mask = wiped
    sgn = torch.where(prompt_re > 0, 1.0, -1.0)
    gate = (st.block > p.recover_after) & ok
    keep = mask & gate[:, None]
    val = torch.stack([m_re, m_im], -1) * sgn[:, None, None]
    acc = nco.accum_rows(torch.stack([st.acc_re, st.acc_im], -1), cidx, val,
                         keep)
    return new._replace(acc_re=acc[..., 0], acc_im=acc[..., 1])


def overlay_chip(overlay, block, sigp):
    """Each channel's overlay chip for `block`: overlay[c, block % nov_c],
    nov_c the sigp NOV lane, or the table's width where that is 0."""
    nov = sigp[:, SIGP_NOV].to(torch.int64)
    nov = torch.where(nov > 0, nov, overlay.shape[1])
    idx = torch.remainder(block.to(torch.int64), nov)
    return torch.gather(overlay, 1, idx[:, None])[:, 0]


def _scan(x, chunk_len, code_tab, state, params, n_blocks: int, ratios,
          coffset_df, sigp, correlate, overlay=None):
    """n_blocks steps of _geometry -> correlate -> _post_block, all
    channels at once.  Once every channel has stalled the rest of the
    rows are NaN/0 and the state stays as it is, as further steps would
    leave them; the loop looks for that every 32 steps.  overlay f32
    [C, nov]: the coherent mode's overlay table (None: all ones)."""
    coh = params.coh_blocks > 1
    if coh and overlay is None:
        overlay = torch.ones((state.ptr.shape[0], 1), device=x.device)
    recover = params.recover_after >= 0
    lens = code_lens(code_tab, sigp)
    rows_f, rows_i = [], []
    st = state
    for b in range(n_blocks):
        if b % 32 == 31 and bool(st.stalled.all()):
            break
        si, sf, n, sj, nfull, ok, cf_dyn = _geometry(
            x.shape[0], chunk_len, ratios, st, params, coffset_df, sigp)
        if recover:
            sums, wiped = track_step.epl_correlate_plain(
                si, sf, x, code_tab, params.nmax,
                track_step.subc_kind(params.subcarrier), lens=lens,
                wiped=True)
        else:
            sums = (correlate(si, sf, x, code_tab) if lens is None
                    else correlate(si, sf, x, code_tab, lens))
        pe, pp, pl = ((sums[:, k], sums[:, k + 1]) for k in (0, 2, 4))
        s_ovl = overlay_chip(overlay, st.block, sigp) if coh else None
        new, rf, ri = _post_block(pe, pp, pl, n, sj, nfull, ok, cf_dyn, st,
                                  params, coffset_df, sigp, s_ovl)
        st = _recover(st, new, params, ok, pp[0], wiped) if recover else new
        rows_f.append(rf)
        rows_i.append(ri)
    C, dev = st.ptr.shape[0], x.device
    for _ in range(n_blocks - len(rows_f)):
        rows_f.append(torch.full((C, 11), float("nan"), device=dev))
        rows_i.append(torch.zeros((C, 3), dtype=torch.int32, device=dev))
    if not rows_f:
        return st, torch.zeros((0, C, 11), device=dev), torch.zeros(
            (0, C, 3), dtype=torch.int32, device=dev)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def track_scan_plain(x, chunk_len, code_tab, state, params,
                     n_blocks: int, ratios, coffset_df, sigp, overlay=None):
    """The plain version of K2 and of the per-step route: n_blocks steps
    of the correlators' plain version, all channels at once, on any
    device.  Arguments as track_scan's, every one but overlay given.
    With params.recover_after >= 0 the recovery scan (the reference's
    route for it)."""
    return _scan(x, chunk_len, code_tab, state, params, n_blocks, ratios,
                 coffset_df, sigp, plain_correlate(params), overlay)


@profiling.span("track.scan")
def track_scan(x_chunk: torch.Tensor, chunk_len, code_tab: torch.Tensor,
               state: TrackState, params: TrackParams, n_blocks: int,
               ratios=None, coffset_df=None, sigp=None, overlay=None):
    """Run up to n_blocks blocks for C channels over one chunk.

    x_chunk: complex64 [N] whose last >= params.nmax samples are the
    tail pad (beyond every chunk_len); code_tab: int8 [C, L], L at least
    every channel's code length (its sigp L lane; rows zero-padded past
    it); state leaves [C] (cacc [C, 6]); ratios f32
    [C] carrier-aiding divisors; coffset_df [C] int32 DDS increments; sigp
    f32 [C, 12]; overlay f32 [C, nov], with params.coh_blocks > 1 the
    secondary-overlay chips, block b of channel c taking
    overlay[c, b % nov_c] (None: all ones).  chunk_len: int or [C].

    Returns (state, rows_f [n_blocks, C, 11], rows_i [n_blocks, C, 3]);
    rows are NaN/0 once a channel exhausts the chunk.  On a CUDA chunk
    this is one launch of kernel K2 (params.fused_scan) or one launch of
    K3 or K4 a block; on a CPU chunk, and only there, the plain loop.
    Recovery (params.recover_after >= 0) runs the plain loop on either
    device, as the reference runs it on its XLA correlator.  The span
    `track.scan` (utils/profiling): the host set-up and the launches."""
    args, overlay = scan_args(x_chunk, chunk_len, code_tab, state, params,
                              n_blocks, ratios, coffset_df, sigp, overlay)
    if x_chunk.device.type == "cpu" or params.recover_after >= 0:
        return track_scan_plain(*args, overlay)
    if params.fused_scan:
        return track_fused.track_scan_fused(*args, overlay)
    return _scan(*args, kernel_correlate(params), overlay)


def scan_args(x_chunk, chunk_len, code_tab, state, params, n_blocks,
              ratios=None, coffset_df=None, sigp=None, overlay=None):
    """track_scan's arguments checked, with their defaults, on x_chunk's
    device: ((x_chunk, chunk_len i32 [C], code_tab, state, params,
    n_blocks, ratios, coffset_df, sigp), overlay)."""
    dev = x_chunk.device
    C = state.ptr.shape[0]
    chunk_len = torch.as_tensor(chunk_len, dtype=torch.int32)
    chunk_len = torch.broadcast_to(chunk_len.to(dev), (C,)).contiguous()
    if ratios is None:
        ratios = torch.full((C,), params.carrier_ratio, dtype=torch.float32,
                            device=dev)
    if coffset_df is None:
        coffset_df = torch.full((C,), params.coffset_df_fixed,
                                dtype=torch.int32, device=dev)
    if sigp is None:
        sigp = sigp_from_params(params, C, dev)
    if int(chunk_len.max()) > x_chunk.shape[0] - params.nmax:
        raise ValueError("x_chunk needs a tail pad of >= params.nmax samples "
                         "beyond chunk_len")
    if (sigp[:, SIGP_L] > code_tab.shape[1]).any():
        raise ValueError("code_tab must be [C, L], L at least every "
                         "channel's code length")
    if params.recover_after >= 0 and (
            sigp[:, SIGP_L] > state.acc_re.shape[1]).any():
        raise ValueError("recovery needs a bin a chip: state.acc_re must "
                         "be [C, >= each channel's code length]")
    if params.coh_blocks > 1 and overlay is not None:
        overlay = overlay.to(dev, torch.float32)
        if (sigp[:, SIGP_NOV] > overlay.shape[1]).any():
            raise ValueError("a channel's overlay period (sigp NOV lane) "
                             "exceeds the overlay table's width")
    args = (x_chunk, chunk_len, code_tab, state, params, int(n_blocks),
            ratios.to(dev, torch.float32), coffset_df.to(dev, torch.int32),
            sigp.to(dev, torch.float32))
    return args, overlay
