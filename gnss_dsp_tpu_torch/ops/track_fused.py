"""The whole tracking loop for a chunk: every block of every channel.

Counterpart: gnss_dsp_tpu/ops/pallas_track_fused.py:118-664
(`track_scan_fused`), including the early/prompt/late math it takes from
ops/pallas_track2.py:107-316.  Kernel: csrc/track_fused.cu.

The loop's dependence from block to block is real (the loop filter
closes over each block's correlators), so the kernel runs all blocks of
one channel inside one CTA and the parallelism comes from the channels.
Its plain version is track/engine.track_scan_plain, a Python loop over
blocks vectorised over channels; track/engine.track_scan picks between
the two by the chunk's device.

This module holds the ctypes wrapper and the state packing only.  The
wrapper takes CUDA tensors and nothing else.  LAUNCHES counts kernel
launches.
"""

from __future__ import annotations

import torch

from gnss_dsp_tpu_torch.ops import _build, nco

MAX_CODE = 10230          # chips held in shared memory
LAUNCHES = 0

# int32 state lanes per channel
(I_PTR, I_BLOCK, I_COFF_P, I_COFF_DF, I_STALLED, I_CHUNKLEN,
 I_NFULL, I_SUBJ) = range(8)
NI = 8
# float32 lanes: loop state, the carrier-aiding ratio, then the 12 sigp
# lanes (track/engine.SIGP_*)
(F_CP_HI, F_CP_LO, F_CFO, F_CARR_P, F_CARR_F, F_P1RE, F_P1IM, F_CE1,
 F_DE1, F_RATIO) = range(10)
F_SIGP = 10
NF = 22


def _pack_state(state, chunk_len, ratios, coffset_df, sigp):
    coff_p = state.coffset_p.to(torch.int64)
    coff_p = torch.where(coff_p >= 2**31, coff_p - 2**32, coff_p)
    s_i32 = torch.stack([
        state.ptr.to(torch.int32), state.block.to(torch.int32),
        coff_p.to(torch.int32), coffset_df.to(torch.int32),
        state.stalled.to(torch.int32), chunk_len.to(torch.int32),
        state.n_full.to(torch.int32), state.sub_j.to(torch.int32),
    ], dim=1).contiguous()
    s_f32 = torch.cat([torch.stack([
        state.code_p_hi, state.code_p_lo, state.code_f_off,
        state.carrier_p, state.carrier_f, state.prompt1_re, state.prompt1_im,
        state.carrier_e1, state.code_e1, ratios,
    ], dim=1).to(torch.float32), sigp.to(torch.float32)], dim=1).contiguous()
    return s_i32, s_f32


def _unpack_state(state, sti, stf):
    coff = sti[:, I_COFF_P].to(torch.int64) & nco.MASK32
    return state._replace(
        ptr=sti[:, I_PTR].contiguous(), block=sti[:, I_BLOCK].contiguous(),
        coffset_p=coff, stalled=sti[:, I_STALLED] != 0,
        n_full=sti[:, I_NFULL].contiguous(), sub_j=sti[:, I_SUBJ].contiguous(),
        code_p_hi=stf[:, F_CP_HI].contiguous(),
        code_p_lo=stf[:, F_CP_LO].contiguous(),
        code_f_off=stf[:, F_CFO].contiguous(),
        carrier_p=stf[:, F_CARR_P].contiguous(),
        carrier_f=stf[:, F_CARR_F].contiguous(),
        prompt1_re=stf[:, F_P1RE].contiguous(),
        prompt1_im=stf[:, F_P1IM].contiguous(),
        carrier_e1=stf[:, F_CE1].contiguous(),
        code_e1=stf[:, F_DE1].contiguous(),
    )


def track_scan_fused(x, chunk_len, code_tab, state, params, n_blocks: int,
                     ratios, coffset_df, sigp):
    """(state', rows_f f32 [B, C, 11], rows_i i32 [B, C, 3]) with
    track/engine.track_scan semantics.  x complex64 [N]; chunk_len i32
    [C]; code_tab int8 [C, L]; ratios f32 [C]; coffset_df i32 [C]; sigp
    f32 [C, 12]; every tensor on one CUDA device."""
    global LAUNCHES
    if x.dtype != torch.complex64 or code_tab.dtype != torch.int8:
        raise TypeError("x must be complex64 and code_tab int8")
    if x.device.type != "cuda":
        raise ValueError(
            f"track_fused kernel needs CUDA tensors, got {x.device}")
    C, Lw = code_tab.shape
    if Lw > MAX_CODE:
        raise NotImplementedError(
            f"track_fused kernel holds codes of <= {MAX_CODE} chips")
    for t in (chunk_len, code_tab, ratios, coffset_df, sigp, *state):
        if t.device != x.device:
            raise ValueError("all track_scan_fused tensors must share a device")
    B = int(n_blocks)
    lib = _build.load()
    s_i32, s_f32 = _pack_state(state, chunk_len, ratios, coffset_df, sigp)
    x = x.contiguous()
    code = code_tab.contiguous()
    lut = nco.lut_cos_sin(x.device)
    rows_f = torch.empty((B, C, 11), dtype=torch.float32, device=x.device)
    rows_i = torch.empty((B, C, 3), dtype=torch.int32, device=x.device)
    sti = torch.empty_like(s_i32)
    stf = torch.empty_like(s_f32)
    p = params
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.track_fused(
            x.data_ptr(), int(x.shape[0]), code.data_ptr(), int(Lw),
            s_i32.data_ptr(), s_f32.data_ptr(), lut.data_ptr(),
            rows_f.data_ptr(), rows_i.data_ptr(), sti.data_ptr(),
            stf.data_ptr(), C, B, nco.inv_fs(p.fs), int(p.fll_wide_blocks),
            int(p.fll_narrow_blocks), float(p.fll_wide_k),
            float(p.fll_narrow_k), float(p.pll_k1), float(p.pll_k2),
            float(p.dll_k1), float(p.dll_k2), stream)
    _build.check(err, "track_fused launch")
    LAUNCHES += 1
    return _unpack_state(state, sti, stf), rows_f, rows_i
