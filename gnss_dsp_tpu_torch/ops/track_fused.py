"""The whole tracking loop for a chunk: every block of every channel.

Counterpart: gnss_dsp_tpu/ops/pallas_track_fused.py:118-664
(`track_scan_fused`), including the early/prompt/late math it takes from
ops/pallas_track2.py:107-316.  Kernel: csrc/track_fused.cu.

The loop's dependence from block to block is real (the loop filter
closes over each block's correlators), so the kernel runs all blocks of
one channel on one thread-block cluster of S CTAs (cluster_plan), each
holding the channel's whole state and running the loop filter itself;
the CTAs split each block's samples, staged ahead in shared memory by
bulk copies, and exchange their partial sums through distributed shared
memory.  Its plain version is track/engine.track_scan_plain, a Python
loop over blocks vectorised over channels; track/engine.track_scan picks
between the two by the chunk's device, and takes K2 where
params.fused_scan holds (track/driver.make_params sets it as the
reference's router does).

The kernel covers the reference's scope but recovery and the mesh: the
subcarrier kinds of K3 ("none", "subc", "tmboc", their coefficients in
the sigp lanes), sub-blocks, any code length (codes of <= MAX_CODE chips
are staged in shared memory, longer ones read from device memory) and
the extended-coherent lanes (cacc, the overlay table staged in shared
memory, at most MAX_OVERLAY chips a channel).

This module holds the ctypes wrapper, the launch plan and the state
packing only.  The wrapper takes CUDA tensors and nothing else.
LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import torch

from gnss_dsp_tpu_torch.ops import _build, nco, track_step

MAX_CODE = 10230          # longest code staged in shared memory
MAX_OVERLAY = 1024        # longest overlay row staged in shared memory
LAUNCHES = 0

# the launch plan (csrc/track_fused.cu make_plan mirrors it; the cluster
# size is track_step.cluster_size's)
THREADS = 256             # worker threads a CTA (a 9th warp issues copies)
MAX_CLUSTER = track_step.MAX_CLUSTER
TILE = 128                # samples a bulk copy (1 KiB)
SMEM_BYTES = 227 * 1024   # shared memory a CTA may use
FIXED_BYTES = 32768       # shared memory before the two stage buffers

# int32 state lanes per channel
(I_PTR, I_BLOCK, I_COFF_P, I_COFF_DF, I_STALLED, I_CHUNKLEN,
 I_NFULL, I_SUBJ) = range(8)
NI = 8
# float32 lanes: loop state, the carrier-aiding ratio, the 12 sigp lanes
# (track/engine.SIGP_*), then the 6 coherent sums (TrackState.cacc)
(F_CP_HI, F_CP_LO, F_CFO, F_CARR_P, F_CARR_F, F_P1RE, F_P1IM, F_CE1,
 F_DE1, F_RATIO) = range(10)
F_SIGP = 10
F_CACC = 22
NF = 28


def cluster_plan(C: int, nmax: int, cluster: int | None = None) -> dict:
    """K2's launch plan for C channels whose blocks are at most nmax
    samples: S CTAs a channel (cluster, or the largest power of two <= 16
    with C x S <= 132, 1 past 132 channels), the window of nmax + 2
    samples from the even sample below a block's start in `tiles` tiles
    of TILE samples, tile t on rank t % S, `tpc` tiles a CTA, staged in
    `batches` batches of `k` tiles through two buffers of `stage_bytes`
    each (batches 1: the whole share, the next block's staged while this
    one runs; more where two shares do not fit the shared memory)."""
    S = track_step.cluster_size(C) if cluster is None else int(cluster)
    if not 1 <= S <= MAX_CLUSTER or S & (S - 1) or nmax < 1:
        raise ValueError(f"cluster size must be a power of two <= "
                         f"{MAX_CLUSTER} and nmax >= 1, got {S}, {nmax}")
    tiles = -(-(int(nmax) + 2) // TILE)
    tpc = -(-tiles // S)
    kmax = (SMEM_BYTES - FIXED_BYTES) // (2 * TILE * 8)
    m = -(-tpc // kmax)
    k = -(-tpc // m)
    return dict(cluster=S, tiles=tiles, tpc=tpc, k=k, batches=m,
                stage_bytes=k * TILE * 8,
                smem=FIXED_BYTES + 2 * k * TILE * 8)


def launch_info(nmax: int, cluster: int, kind: str = "none",
                long_code: bool = False) -> dict:
    """The card's view of a K2 plan (track_fused_info): the plan's
    numbers, registers and local bytes a thread, clusters the card holds
    at once, threads a CTA; raises where it differs from cluster_plan."""
    import ctypes

    lib = _build.load()
    info = (ctypes.c_int * 10)()
    _build.check(lib.track_fused_info(
        int(nmax), int(cluster), track_step.KINDS.index(kind),
        int(not long_code), ctypes.addressof(info)), "track_fused_info")
    got = dict(zip(("cluster", "tiles", "tpc", "k", "batches", "smem",
                    "regs", "spill_bytes", "active", "threads"), info))
    want = cluster_plan(1, nmax, cluster)
    for key in ("cluster", "tiles", "tpc", "k", "batches", "smem"):
        if got[key] != want[key]:
            raise RuntimeError(f"K2 plan mismatch at nmax {nmax}, cluster "
                               f"{cluster}: {key} {got[key]} != {want[key]}")
    return got


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
    ], dim=1).to(torch.float32), sigp.to(torch.float32),
        state.cacc.to(torch.float32)], dim=1).contiguous()
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
        cacc=stf[:, F_CACC:F_CACC + 6].contiguous(),
    )


def track_scan_fused(x, chunk_len, code_tab, state, params, n_blocks: int,
                     ratios, coffset_df, sigp, overlay=None, *,
                     cluster: int | None = None):
    """(state', rows_f f32 [B, C, 11], rows_i i32 [B, C, 3]) with
    track/engine.track_scan semantics.  x complex64 [N], N >= params.nmax;
    chunk_len i32 [C]; code_tab int8 [C, L]; ratios f32 [C];
    coffset_df i32 [C]; sigp f32 [C, 12]; overlay f32 [C, nov]
    (params.coh_blocks > 1; None: all ones); every tensor on one CUDA
    device.  cluster: CTAs a channel in place of cluster_plan's choice
    (tests and chip_smoke.py only)."""
    global LAUNCHES
    if x.dtype != torch.complex64 or code_tab.dtype != torch.int8:
        raise TypeError("x must be complex64 and code_tab int8")
    if x.device.type != "cuda":
        raise ValueError(
            f"track_fused kernel needs CUDA tensors, got {x.device}")
    kind = track_step.KINDS.index(track_step.subc_kind(params.subcarrier))
    C, Lw = code_tab.shape
    coh = params.coh_blocks > 1
    if overlay is None or not coh:
        overlay = torch.ones((C, 1), dtype=torch.float32, device=x.device)
    if overlay.dim() != 2 or overlay.shape[0] != C \
            or not 1 <= overlay.shape[1] <= MAX_OVERLAY:
        raise ValueError(f"overlay must be [C, nov] with 1 <= nov <= "
                         f"{MAX_OVERLAY}, got {tuple(overlay.shape)}")
    for t in (chunk_len, code_tab, ratios, coffset_df, sigp, overlay,
              *state):
        if t.device != x.device:
            raise ValueError("all track_scan_fused tensors must share a device")
    B = int(n_blocks)
    if x.shape[0] < params.nmax:
        raise ValueError(f"x must hold nmax = {params.nmax} samples, got "
                         f"{x.shape[0]}")
    plan = cluster_plan(C, params.nmax, cluster)
    lib = _build.load()
    s_i32, s_f32 = _pack_state(state, chunk_len, ratios, coffset_df, sigp)
    x = x.contiguous()
    if x.data_ptr() % 16:           # the bulk copies read 16-byte units
        x = x.clone()
    code = code_tab.contiguous()
    ovl = overlay.to(torch.float32).contiguous()
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
            s_i32.data_ptr(), s_f32.data_ptr(), ovl.data_ptr(),
            int(ovl.shape[1]), lut.data_ptr(), rows_f.data_ptr(),
            rows_i.data_ptr(), sti.data_ptr(), stf.data_ptr(), C, B, kind,
            int(coh), nco.inv_fs(p.fs), int(p.fll_wide_blocks),
            int(p.fll_narrow_blocks), float(p.fll_wide_k),
            float(p.fll_narrow_k), float(p.pll_k1), float(p.pll_k2),
            float(p.dll_k1), float(p.dll_k2), int(p.nmax), plan["cluster"],
            stream)
    _build.check(err, "track_fused launch")
    LAUNCHES += 1
    return _unpack_state(state, sti, stf), rows_f, rows_i
