"""Extended-coherent correlation surfaces with the in-kernel max over
alignments and lags.

Counterpart: gnss_dsp_tpu/ops/pallas_acquire_coh.py, the contracts of
`corr_surface_coh_spec` (K5, :273) and `corr_surface_coh` (K6, :467),
finalized as `_finalize_max` (:158).

K5, rows of F2 [DC, G*A, W] pre-combined per (group g, alignment a):

    s_a[j] = sum_g | ifft(code_f[p] * conj(F2[d, g*A + a])) [j] |

K6, per-block spectra F [DC, B, W], groups of m_coh blocks:

    s_a[j] = sum_g | sum_{m in g} sec_mat[a, m] rot[d, m]
                                  ifft(code_f[p] * conj(F[d, m])) [j] |

with rot = cosang + i sinang.  Both return, per (p, d), the highest
s_a[j] over alignments a and lags j >= W - n_valid (all lags when
n_valid = 0), the lowest such lag, then the lowest alignment:

    (peak f32 [P, DC], idx i32 [P, DC], align i32 [P, DC])

idx counts from W - n_valid.  ifft is the 1/W-scaled inverse DFT.
Inputs are complex64 in NATURAL order (interop.code_ffts_from_split
converts the TPU kernels' permuted split planes).

Kernels: K5 csrc/acquire_coh_spec.cu, one thread-block cluster per
(PRN, doppler) walking all its rows, each transformed across the
cluster (csrc/acq_cluster.cuh) on K1's cores (spec_core_plan: the
register core at the windows of SPEC_CLUSTERS, at 16384 (BATCHED_W) the
batched register core with two rows of a cluster in flight and one
cluster barrier a row; the run-time core at 163840 and any other window
wide_split factors), the max over alignments in the kernel; K6
csrc/acquire_coh.cu at power-of-two W <= 16384, in two stages: the
combine (combine_blk_plain's rows F2 [DC, G*A, W], once per doppler and
group, never per PRN), then K5's alignment loop on the register core
over F2 (K5's own launch and builds), one cluster per (PRN, doppler) and
alignment chunk (blk_plan), the chunks merged in the kernel.

The wrappers launch the CUDA kernel for CUDA tensors and take the plain
version only for CPU tensors.  Each kernel has its own launch counter.
"""

from __future__ import annotations

import functools

import torch

from gnss_dsp_tpu_torch.ops import _build
from gnss_dsp_tpu_torch.ops.acquire2 import (
    check_w, cluster_core_plan, cluster_twiddles, read_launch_info)
from gnss_dsp_tpu_torch.utils import profiling

LAUNCHES_SPEC = 0      # K5
LAUNCHES_BLK = 0       # K6
_PLAIN_CHUNK_BYTES = 1 << 28   # bound on the plain versions' temporaries

# K5's register-core builds (csrc/acquire_coh_spec.cu), which K6's surface
# stage runs too: W -> the cluster sizes built, the kernel's choice first
# (K1's 2 at 4096, where 8 spill; 16 at 32768, 8 at 65536: on 8 CTAs each
# thread keeps its code values in registers there).  Any other
# (W, cluster) takes the run-time core.
SPEC_CLUSTERS = {**{1 << L: (min(8, 1 << (L // 2)),) for L in range(1, 14)},
                 4096: (2,), 16384: (8,), 32768: (16, 8), 65536: (8, 16),
                 81920: (16,)}
# The window of K5's batched register core (csrc/acquire_coh_spec.cu,
# coh_spec_kernel_batch, on 8 CTAs); surface_rows is the register core at
# every other window of SPEC_CLUSTERS
BATCHED_W = 16384
# K6's alignment split (blk_plan): the CTAs of work an SM it aims for, and
# the fewest rows a cluster walks
FILL_CTAS = 8
MIN_ROWS = 8


def finalize_max(q: torch.Tensor, n_valid: int = 0):
    """q [P, dc, A, W] f32 -> (peak, idx, align) [P, dc]: per lag the best
    alignment (lowest on ties), then the best lag (lowest on ties) among
    the n_valid last ones (all when 0), counted from W - n_valid."""
    if n_valid:
        q = q[..., q.shape[-1] - n_valid:]
    best, ab = torch.max(q, dim=2)                  # first max over a
    idx = torch.argmax(best, dim=-1)                # first max over lags
    peak = torch.gather(best, -1, idx[..., None])[..., 0]
    al = torch.gather(ab, -1, idx[..., None])[..., 0]
    return peak, idx.to(torch.int32), al.to(torch.int32)


def _check(F, code_f):
    if F.dtype != torch.complex64 or code_f.dtype != torch.complex64:
        raise TypeError("spectra and code_f must be complex64")
    if F.dim() != 3 or code_f.dim() != 2 or F.shape[2] != code_f.shape[1]:
        raise ValueError(f"shapes {tuple(F.shape)} code_f "
                         f"{tuple(code_f.shape)}: want [DC,rows,W], [P,W]")
    if F.device != code_f.device:
        raise ValueError("spectra and code_f on different devices")


def _dchunk(per_doppler_cells: int) -> int:
    return max(1, int(_PLAIN_CHUNK_BYTES // (per_doppler_cells * 8)))


def surface_spec_plain(f2, code_f, A: int) -> torch.Tensor:
    """K5's surfaces s_a[j], f32 [P, DC, A, W], unreduced."""
    DC, GA, W = f2.shape
    P = code_f.shape[0]
    prod = code_f[:, None, None, :] * torch.conj(f2)[None]
    q = torch.fft.ifft(prod, dim=-1).abs()                    # [P,DC,GA,W]
    return q.reshape(P, DC, GA // A, A, W).sum(dim=2)


def surface_blk_plain(F, code_f, cosang, sinang, sec_mat,
                      m_coh: int) -> torch.Tensor:
    """K6's surfaces s_a[j], f32 [P, DC, A, W], unreduced, as the TPU
    kernel defines them: per-block complex surfaces, rotated,
    overlay-weighted sums per (alignment, group), magnitude, group sum."""
    DC, B, W = F.shape
    P = code_f.shape[0]
    A = sec_mat.shape[0]
    G = B // m_coh
    sg = sec_mat.reshape(A, G, m_coh).to(torch.complex64)
    prod = code_f[:, None, None, :] * torch.conj(F)[None]
    y = torch.fft.ifft(prod, dim=-1) * torch.complex(cosang, sinang)[
        None, :, :, None]
    c = torch.einsum("agm,pdgmw->pdagw", sg, y.reshape(P, DC, G, m_coh, W))
    return c.abs().sum(dim=3)


def corr_surface_coh_spec_plain(f2, code_f, A: int, n_valid: int = 0):
    """Plain PyTorch K5: surface_spec_plain and finalize_max, chunked
    over doppler to bound the [P, dc, G*A, W] temporary."""
    _check(f2, code_f)
    DC, GA, W = f2.shape
    dc = _dchunk(code_f.shape[0] * GA * W)
    outs = [finalize_max(surface_spec_plain(f2[d0:d0 + dc], code_f, A),
                         n_valid) for d0 in range(0, DC, dc)]
    return tuple(torch.cat([o[k] for o in outs], 1) for k in range(3))


def corr_surface_coh_plain(F, code_f, cosang, sinang, sec_mat, m_coh: int,
                           n_valid: int = 0):
    """Plain PyTorch K6: surface_blk_plain and finalize_max, chunked
    over doppler."""
    _check(F, code_f)
    DC, B, W = F.shape
    A = sec_mat.shape[0]
    dc = _dchunk(code_f.shape[0] * max(B, A * (B // m_coh)) * W)
    outs = [finalize_max(surface_blk_plain(
        F[d0:d0 + dc], code_f, cosang[d0:d0 + dc], sinang[d0:d0 + dc],
        sec_mat, m_coh), n_valid) for d0 in range(0, DC, dc)]
    return tuple(torch.cat([o[k] for o in outs], 1) for k in range(3))


def spec_core_plan(W: int, cluster: int = 0):
    """(core, n1, n2, C) K5 runs W on (ops/acquire2.cluster_core_plan
    over SPEC_CLUSTERS): the check of K5's windows, NotImplementedError
    naming W where it has none."""
    return cluster_core_plan(W, cluster, SPEC_CLUSTERS.get(W, ()), "K5")


@functools.lru_cache(maxsize=16)
def spec_launch_info(W: int, device_index: int, cluster: int = 0) -> dict:
    """K5's launch plan at W on the card `device_index`
    (acq_coh_spec_info), as ops/acquire2.launch_info: cluster size,
    dynamic shared memory bytes a CTA, registers and spilled bytes a
    thread, clusters the card holds at once, threads a CTA, n1, n2 and
    the core ("split" or "wide"; the batched core is "split")."""
    return read_launch_info(_build.load().acq_coh_spec_info, W,
                            device_index, cluster,
                            spec_core_plan(W, cluster), "K5")


def combine_blk_plain(F, cosang, sinang, sec_mat, m_coh: int):
    """K6's combine stage in plain PyTorch: F2 complex64 [DC, G*A, W], row
    g*A + a = sum_m sec_mat[a, g*M + m] conj(rot[d, g*M + m])
    F[d, g*M + m] with rot = cosang + i sinang, M = m_coh: the rows K5
    takes (corr_surface_coh_spec_plain(F2, code_f, A, n_valid) is K6's
    result)."""
    DC, B, W = F.shape
    A = sec_mat.shape[0]
    G = B // m_coh
    wc = torch.complex(sec_mat[None] * cosang[:, None, :],
                       -sec_mat[None] * sinang[:, None, :])    # [DC, A, B]
    return torch.einsum("dagm,dgmw->dgaw", wc.reshape(DC, A, G, m_coh),
                        F.reshape(DC, G, m_coh, W)).reshape(DC, G * A, W)


def blk_plan(P: int, DC: int, A: int, G: int, W: int, sm_count: int):
    """(cluster, a_chunk) of K6's surface stage: K5's cluster size at W
    (spec_core_plan, the register core at every W that check_w admits)
    and the alignments a cluster walks.  All A where the P x DC clusters
    give every SM FILL_CTAS CTAs; else A split into at least as many
    chunks as reach that, each of at least MIN_ROWS rows (G an alignment)
    and one alignment."""
    check_w(W, "acquire_coh blk")
    C = spec_core_plan(W)[3]
    have, want = P * DC * C, FILL_CTAS * sm_count
    if have >= want:
        return C, A
    chunks = -(-want // have)
    return C, min(A, max(A // chunks, -(-MIN_ROWS // G), 1))


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def corr_surface_coh_spec(f2, code_f, A: int, n_valid: int = 0, *,
                          cluster: int = 0, surface_rows: bool = False):
    """K5: (peak, idx, align) [P, DC] for pre-combined spectra f2
    complex64 [DC, G*A, W] (row g*A + a) and code_f complex64 [P, W];
    on the card `cluster` CTAs a cluster as spec_core_plan (0: the
    kernel's choice).  `surface_rows` runs surface_rows' build where the
    batched core would (BATCHED_W on 8 CTAs; acq_coh_spec_surface): the
    ablation, bit-equal.  Each launch counts acq.k5.core.batched (on the
    batched core) or acq.k5.core.other (any other core)."""
    global LAUNCHES_SPEC
    _check(f2, code_f)
    DC, GA, W = f2.shape
    if A < 1 or GA % A:
        raise ValueError(f"{GA} rows do not hold whole groups of A={A}")
    if not 0 <= n_valid <= W:
        raise ValueError(f"n_valid={n_valid} outside [0, {W}]")
    if not _on_cuda(f2):
        return corr_surface_coh_spec_plain(f2, code_f, A, n_valid)
    if A > 65535:
        raise NotImplementedError(f"K5 keeps alignments in 16 bits: A={A}")
    dev = f2.device.index if f2.device.index is not None \
        else torch.cuda.current_device()
    info = spec_launch_info(W, dev, cluster)
    tw = (cluster_twiddles(info["n1"], info["n2"], f2.device)
          if info["core"] == "wide" else None)
    lib = _build.load()
    f2 = f2.contiguous()
    code_f = code_f.contiguous()
    P = code_f.shape[0]
    peak = torch.empty((P, DC), dtype=torch.float32, device=f2.device)
    idx, al = (torch.empty((P, DC), dtype=torch.int32, device=f2.device)
               for _ in range(2))
    with torch.cuda.device(f2.device):
        stream = torch.cuda.current_stream(f2.device).cuda_stream
        launch = (lib.acq_coh_spec_surface if surface_rows
                  else lib.acq_coh_spec)
        err = launch(f2.data_ptr(), code_f.data_ptr(),
                     None if tw is None else tw.data_ptr(), peak.data_ptr(),
                     idx.data_ptr(), al.data_ptr(), None, None, P, DC, GA, A,
                     W, n_valid, cluster, A, stream)
    _build.check(err, "acq_coh_spec launch")
    LAUNCHES_SPEC += 1
    batched = (W == BATCHED_W and info["core"] == "split"
               and not surface_rows)
    profiling.count("acq.k5.core.batched" if batched
                    else "acq.k5.core.other")
    return peak, idx, al


def corr_surface_coh(F, code_f, cosang, sinang, sec_mat, m_coh: int,
                     n_valid: int = 0, *, a_chunk: int = 0):
    """K6: (peak, idx, align) [P, DC] for per-block spectra F complex64
    [DC, B, W], code_f complex64 [P, W], the residual rotation
    cosang/sinang f32 [DC, B] and the overlay signs sec_mat f32 [A, B]
    (sec[(a + m) mod N] at global block m); B % m_coh == 0.  On the card
    the surface stage runs `a_chunk` alignments a cluster (0:
    blk_plan's)."""
    global LAUNCHES_BLK
    _check(F, code_f)
    DC, B, W = F.shape
    A = sec_mat.shape[0]
    if m_coh < 1 or B % m_coh:
        raise ValueError(f"B={B} is not a multiple of m_coh={m_coh}")
    if tuple(cosang.shape) != (DC, B) or tuple(sinang.shape) != (DC, B) \
            or sec_mat.dim() != 2 or sec_mat.shape[1] != B:
        raise ValueError("cosang/sinang want [DC, B], sec_mat [A, B]")
    if not 0 <= n_valid <= W:
        raise ValueError(f"n_valid={n_valid} outside [0, {W}]")
    if not _on_cuda(F):
        return corr_surface_coh_plain(F, code_f, cosang, sinang, sec_mat,
                                      m_coh, n_valid)
    if A > 65535:
        raise NotImplementedError(f"K6 keeps alignments in 16 bits: A={A}")
    P = code_f.shape[0]
    G = B // m_coh
    dev = F.device.index if F.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, chunk = blk_plan(P, DC, A, G, W, sms)
    if a_chunk:
        if not 1 <= a_chunk <= A:
            raise ValueError(f"a_chunk={a_chunk} outside [1, {A}]")
        chunk = a_chunk
    spec_launch_info(W, dev)      # the card's build is the host's
    lib = _build.load()
    F = F.contiguous()
    if F.data_ptr() % 16:     # the combine copies 16 bytes at a time
        F = F.clone()
    code_f = code_f.contiguous()
    f32 = dict(dtype=torch.float32, device=F.device)
    cosang = cosang.to(**f32).contiguous()
    sinang = sinang.to(**f32).contiguous()
    sec_mat = sec_mat.to(**f32).contiguous()
    comb = torch.empty((DC, G * A, W), dtype=torch.complex64, device=F.device)
    split = chunk < A
    key = (torch.empty((P, DC), dtype=torch.int64, device=F.device)
           if split else None)
    count = (torch.empty((P, DC), dtype=torch.int32, device=F.device)
             if split else None)
    peak = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    idx, al = (torch.empty((P, DC), dtype=torch.int32, device=F.device)
               for _ in range(2))
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.acq_coh_blk(
            F.data_ptr(), code_f.data_ptr(), cosang.data_ptr(),
            sinang.data_ptr(), sec_mat.data_ptr(), comb.data_ptr(),
            key.data_ptr() if split else None,
            count.data_ptr() if split else None, peak.data_ptr(),
            idx.data_ptr(), al.data_ptr(), P, DC, B, A, m_coh, W, n_valid,
            chunk, stream)
    _build.check(err, "acq_coh_blk launch")
    LAUNCHES_BLK += 1
    return peak, idx, al
