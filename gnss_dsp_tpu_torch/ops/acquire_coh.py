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
cluster (csrc/acq_cluster.cuh), the max over alignments in the kernel;
K6 csrc/acquire_coh.cu, one CTA per (PRN, doppler, alignment) and a
second kernel for the max over alignments.

The wrappers launch the CUDA kernel for CUDA tensors and take the plain
version only for CPU tensors.  Each kernel has its own launch counter.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnss_dsp_tpu_torch.ops import _build
from gnss_dsp_tpu_torch.ops.acquire2 import check_w, twiddles

LAUNCHES_SPEC = 0      # K5
LAUNCHES_BLK = 0       # K6
_PLAIN_CHUNK_BYTES = 1 << 28   # bound on the plain versions' temporaries


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


@functools.lru_cache(maxsize=16)
def spec_launch_info(W: int, device_index: int, cluster: int = 0) -> dict:
    """K5's launch plan at W on the card `device_index` (cluster CTAs, 0:
    the kernel's choice, 8 at W = 16384; 4 is the other build there):
    cluster size, dynamic shared memory bytes a CTA, registers and
    spilled bytes a thread, clusters the card holds at once, threads a
    CTA."""
    lib = _build.load()
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        err = lib.acq_coh_spec_info(W, cluster, info)
    _build.check(err, f"acq_coh_spec_info at W={W}, cluster={cluster}")
    return dict(zip(("cluster", "smem", "regs", "spill_bytes", "active",
                     "threads"), info))


def _outputs(P, DC, A, device):
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((P, DC, A), dtype=f32, device=device),
            torch.empty((P, DC, A), dtype=i32, device=device),
            torch.empty((P, DC), dtype=f32, device=device),
            torch.empty((P, DC), dtype=i32, device=device),
            torch.empty((P, DC), dtype=i32, device=device))


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def corr_surface_coh_spec(f2, code_f, A: int, n_valid: int = 0, *,
                          cluster: int = 0):
    """K5: (peak, idx, align) [P, DC] for pre-combined spectra f2
    complex64 [DC, G*A, W] (row g*A + a) and code_f complex64 [P, W];
    on the card `cluster` CTAs a cluster as spec_launch_info (0: the
    kernel's choice)."""
    global LAUNCHES_SPEC
    _check(f2, code_f)
    DC, GA, W = f2.shape
    if A < 1 or GA % A:
        raise ValueError(f"{GA} rows do not hold whole groups of A={A}")
    if not 0 <= n_valid <= W:
        raise ValueError(f"n_valid={n_valid} outside [0, {W}]")
    if not _on_cuda(f2):
        return corr_surface_coh_spec_plain(f2, code_f, A, n_valid)
    check_w(W, "acquire_coh spec")
    if A > 65535:
        raise NotImplementedError(f"K5 keeps alignments in 16 bits: A={A}")
    lib = _build.load()
    f2 = f2.contiguous()
    code_f = code_f.contiguous()
    P = code_f.shape[0]
    peak = torch.empty((P, DC), dtype=torch.float32, device=f2.device)
    idx, al = (torch.empty((P, DC), dtype=torch.int32, device=f2.device)
               for _ in range(2))
    with torch.cuda.device(f2.device):
        stream = torch.cuda.current_stream(f2.device).cuda_stream
        err = lib.acq_coh_spec(f2.data_ptr(), code_f.data_ptr(),
                               peak.data_ptr(), idx.data_ptr(),
                               al.data_ptr(), P, DC, GA, A, W, n_valid,
                               cluster, stream)
    _build.check(err, "acq_coh_spec launch")
    LAUNCHES_SPEC += 1
    return peak, idx, al


def corr_surface_coh(F, code_f, cosang, sinang, sec_mat, m_coh: int,
                     n_valid: int = 0):
    """K6: (peak, idx, align) [P, DC] for per-block spectra F complex64
    [DC, B, W], code_f complex64 [P, W], the residual rotation
    cosang/sinang f32 [DC, B] and the overlay signs sec_mat f32 [A, B]
    (sec[(a + m) mod N] at global block m); B % m_coh == 0."""
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
    check_w(W, "acquire_coh blk")
    lib = _build.load()
    F = F.contiguous()
    code_f = code_f.contiguous()
    f32 = dict(dtype=torch.float32, device=F.device)
    cosang = cosang.to(**f32).contiguous()
    sinang = sinang.to(**f32).contiguous()
    sec_mat = sec_mat.to(**f32).contiguous()
    P = code_f.shape[0]
    pk, ix, peak, idx, al = _outputs(P, DC, A, F.device)
    tw = twiddles(W, F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.acq_coh_blk(F.data_ptr(), code_f.data_ptr(), tw.data_ptr(),
                              cosang.data_ptr(), sinang.data_ptr(),
                              sec_mat.data_ptr(), pk.data_ptr(),
                              ix.data_ptr(), peak.data_ptr(), idx.data_ptr(),
                              al.data_ptr(), P, DC, B, A, m_coh, W, n_valid,
                              stream)
    _build.check(err, "acq_coh_blk launch")
    LAUNCHES_BLK += 1
    return peak, idx, al
