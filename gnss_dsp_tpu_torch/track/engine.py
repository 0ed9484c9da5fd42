"""DLL/FLL/PLL tracking over code-period blocks.

Counterpart: gnss_dsp_tpu/track/engine.py (`TrackParams`, `TrackState`,
`init_state`, `sigp_row`, `_sub_block_len`, `_mode_of`, `_track_block`
:259-376, `_post_block` :379-505, `track_scan` :614-681).  Behavioral
contract track-gps-l1.py:13-94: per block a carrier wipeoff with the
running LUT-NCO phase, the doppler-aided code rate, early/prompt/late
correlations, an FLL_WIDE -> FLL_NARROW -> PLL schedule, a
normalized-envelope EML DLL, and phase/cycle bookkeeping.

track_scan runs kernel K2 (ops/track_fused) for a chunk on the card, and
its plain version, track_scan_plain (the gather form of _track_block
plus _post_block, vectorised over channels), for a chunk on the CPU.

Scope: BPSK (subcarrier "none"), one sub-block per code period, no
extended-coherent integration (coh_blocks == 1), no unknown-code
recovery.  Anything else raises NotImplementedError.

Arithmetic follows the JAX engine op for op in float32, and where the
rounding of one operation decides a later integer (a chip index, a DDS
phase, a cycle count) it is pinned down explicitly, as the reference's
float32 XLA program computes it:

  * division by the sample rate is a multiply by inv_fs, the float32
    reciprocal of fs (XLA rewrites division by a constant that way);
  * the chip-phase recurrence fr + i*cf and the loop-state updates
    (carrier phase, carrier and code frequency) are fused multiply-adds,
    rounded once (XLA contracts them); `fma` below computes them exactly
    in float64 and rounds to float32 once, the CUDA kernel with
    __fmaf_rn.  No other line may be contracted (the kernel is built with
    --fmad=false; never use addcmul or lerp here).

The correlator sums accumulate in float64 and round to float32 once, so
their value does not depend on the order of summation: the kernel and
the plain version give the same bits, and the reference's float32 sums
agree with them to float32 rounding.  The uint32 carrier-offset phase
`coffset_p` is an int64 tensor in [0, 2^32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import discriminators as disc
from gnss_dsp_tpu_torch.ops import nco, track_fused
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
    subcarrier: str = "none"
    recover_after: int = -1    # unknown-code recovery (not ported)
    coh_blocks: int = 1        # extended-coherent periods (not ported)


# Per-channel runtime signal constants ("sigp" lanes, f32 [C, 12]), the
# JAX engine's layout.  The subcarrier lanes (A0, A1, A6, TM) and the
# coherent lanes (COH, NOV) carry the BPSK, non-coherent values: the port
# tracks nothing else yet.
SIGP_CF_HI, SIGP_CF_LO, SIGP_EL, SIGP_L, SIGP_SPP, SIGP_SUB, \
    SIGP_A0, SIGP_A1, SIGP_A6, SIGP_COH, SIGP_NOV, SIGP_TM = range(12)
SIGP_LANES = 12


def sigp_row(cf_hi, cf_lo, el, L, spp, sub) -> np.ndarray:
    return np.array([cf_hi, cf_lo, el, L, spp, sub, 1.0, 0.0, 0.0,
                     1.0, 0.0, 0.0], np.float32)


def sigp_from_params(p: TrackParams, C: int, device="cpu") -> torch.Tensor:
    row = sigp_row(p.cf_hi, p.cf_lo, p.el_spacing, p.code_length,
                   p.fs * 0.001 * p.code_period_ms, p.sub)
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


def init_state(code_p, code_f_off, carrier_p, carrier_f, ptr=0,
               device="cpu") -> TrackState:
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


def _track_block(x, chunk_len, code_tab, ratio, st: TrackState,
                 p: TrackParams, coffset_df, sp):
    """One block for all C channels (gather form).  Returns the three
    correlator sums and the block geometry for _post_block."""
    dev = x.device
    ifs = nco.inv_fs(p.fs)
    Lf = sp[:, SIGP_L]
    Li = Lf.to(torch.int64)
    spp = sp[:, SIGP_SPP]
    sub_i = sp[:, SIGP_SUB].to(torch.int32)
    el = sp[:, SIGP_EL]

    # adaptive block length targeting the next code boundary (:160-163)
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
    i = torch.arange(p.nmax, dtype=torch.int64, device=dev)
    mask = i[None, :] < n[:, None]
    start = torch.clamp(st.ptr.to(torch.int64), 0, x.shape[0] - p.nmax)
    xb = x[start[:, None] + i[None, :]]                      # [C, nmax]

    # fused double LUT mix: offset NCO x carrier NCO == one table angle
    ph1 = (st.coffset_p[:, None] + i * coffset_df.to(torch.int64)[:, None]
           ) & nco.MASK32
    carr_df = nco.freq_to_fixed_t(-st.carrier_f * ifs)
    carr_p0 = nco.fixed_u32(torch.remainder(st.carrier_p, 1.0))
    ph2 = (carr_p0[:, None] + i * carr_df[:, None]) & nco.MASK32
    idx = ((ph1 >> nco.LUT_SHIFT) + (ph2 >> nco.LUT_SHIFT)) & (nco.NT - 1)
    wc, ws = nco.cos_sin_of_idx(idx)
    xr, xi = xb.real, xb.imag
    xm_re = xr * wc - xi * ws
    xm_im = xr * ws + xi * wc

    # doppler-aided code rate and E/P/L correlations (:44-48)
    cf_dyn = (st.code_f_off + st.carrier_f / ratio) * ifs
    cf = sp[:, SIGP_CF_HI] + cf_dyn
    i_f = i.to(torch.float32)

    def corr(lag):
        v = tf.tf_add_f((st.code_p_hi, st.code_p_lo), lag)
        vint = torch.floor(v[0] + v[1])
        fr = tf.tf_value(tf.tf_add_f(v, -vint))
        cp_i = fma(i_f, cf[:, None], fr[:, None])        # fr + i*cf
        # floor-mod: the early lag at phase ~0 gives vint = -1 -> L-1
        cidx = torch.remainder(
            vint.to(torch.int64)[:, None] + torch.floor(cp_i).to(torch.int64),
            Li[:, None])
        chips = torch.gather(code_tab, 1, cidx).to(torch.float32)
        chips = torch.where(mask, chips, 0.0).to(torch.float64)
        # chips are +-1: each product is exact, and the float64 sum of
        # a block's products rounds to the same float32 in any order
        return ((xm_re.to(torch.float64) * chips).sum(-1).to(torch.float32),
                (xm_im.to(torch.float64) * chips).sum(-1).to(torch.float32))

    p_early = corr(-el)
    p_prompt = corr(torch.zeros_like(el))
    p_late = corr(el)
    return p_early, p_prompt, p_late, n, sub_j_next, n_full, ok, cf_dyn


def _post_block(p_early, p_prompt, p_late, n, sub_j_next, n_full_new, ok,
                cf_dyn, st: TrackState, p: TrackParams, coffset_df, sp):
    """Loop-filter updates and bookkeeping after the three correlations
    (track-gps-l1.py:50-92), for all channels.  Returns (state, row_f
    [C, 11], row_i [C, 3])."""
    L = sp[:, SIGP_L]

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
    e_fll = disc.fll_atan(p_prompt, (st.prompt1_re, st.prompt1_im))
    e_pll = disc.pll_costas(p_prompt)
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
    prompt1_re_new = torch.where(pll, st.prompt1_re, p_prompt[0])
    prompt1_im_new = torch.where(pll, st.prompt1_im, p_prompt[1])

    # code loop: normalized-envelope EML DLL (:74-86)
    def env(c):
        return torch.sqrt(c[0] * c[0] + c[1] * c[1])

    early, prompt, late = env(p_early), env(p_prompt), env(p_late)
    denom = late + early
    zero = denom == 0
    e_dll = torch.where(zero, 0.0,
                        (late - early) / torch.where(zero, 1.0, denom))
    code_f_off_new = fma(p.dll_k2, e_dll - st.code_e1,
                         fma(p.dll_k1, e_dll, st.code_f_off))

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
    )
    # freeze the channel if the chunk ran dry (host refills and resumes)
    new = TrackState(*[torch.where(ok, a, b).to(b.dtype)
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


def check_supported(p: TrackParams):
    if p.subcarrier != "none" or p.sub != 1:
        raise NotImplementedError(
            f"tracking port covers BPSK with one sub-block per code period; "
            f"got subcarrier={p.subcarrier!r} sub={p.sub}")
    if p.coh_blocks > 1:
        raise NotImplementedError("extended-coherent tracking is not ported")
    if p.recover_after >= 0:
        raise NotImplementedError("unknown-code recovery is not ported")


def track_scan_plain(x, chunk_len, code_tab, state, params,
                     n_blocks: int, ratios, coffset_df, sigp):
    """K2's plain version: n_blocks steps of the gather-form block, all
    channels at once.  Arguments as track_scan's, every one given."""
    rows_f, rows_i = [], []
    st = state
    for _ in range(n_blocks):
        pe, pp, pl, n, sj, nfull, ok, cf_dyn = _track_block(
            x, chunk_len, code_tab, ratios, st, params, coffset_df, sigp)
        st, rf, ri = _post_block(pe, pp, pl, n, sj, nfull, ok, cf_dyn, st,
                                 params, coffset_df, sigp)
        rows_f.append(rf)
        rows_i.append(ri)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def track_scan(x_chunk: torch.Tensor, chunk_len, code_tab: torch.Tensor,
               state: TrackState, params: TrackParams, n_blocks: int,
               ratios=None, coffset_df=None, sigp=None):
    """Run up to n_blocks blocks for C channels over one chunk.

    x_chunk: complex64 [N] whose last >= params.nmax samples are the
    tail pad (beyond every chunk_len); code_tab: int8 [C, L]; state
    leaves [C]; ratios f32 [C] carrier-aiding divisors; coffset_df [C]
    int32 DDS increments; sigp f32 [C, 12].  chunk_len: int or [C].

    Returns (state, rows_f [n_blocks, C, 11], rows_i [n_blocks, C, 3]);
    rows are NaN/0 once a channel exhausts the chunk.  On a CUDA chunk
    this is one launch of kernel K2; on a CPU chunk, and only there, the
    plain loop."""
    check_supported(params)
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
    if int(sigp[:, SIGP_L].max()) > code_tab.shape[1]:
        raise ValueError("code_tab is narrower than the code length")
    args = (x_chunk, chunk_len, code_tab, state, params, int(n_blocks),
            ratios.to(dev, torch.float32), coffset_df.to(dev, torch.int32),
            sigp.to(dev, torch.float32))
    if dev.type == "cpu":
        return track_scan_plain(*args)
    return track_fused.track_scan_fused(*args)
