"""Non-coherent correlation surface with in-kernel (max, argmax, sum).

Counterpart: gnss_dsp_tpu/ops/pallas_acquire2.py:173-350, the
`corr_surface2(reduce=True)` contract.  Kernel: csrc/acquire2.cu.

For PRN p and doppler d:

    s[j] = sum_b | ifft(code_f[p] * conj(F[d, b])) [j] |      (1/W scaled)

    peak[p, d] = max_j s[j]
    idx[p, d]  = lowest natural j with s[j] == peak   (jnp.argmax ties)
    sum[p, d]  = sum_j s[j]

Inputs are complex64 in NATURAL order (the TPU kernel took split bf16
planes in a permuted order; interop.code_ffts_from_split converts).
The kernel takes power-of-two W <= MAX_W: GPS L1 (4096) and the 2n
linear windows of BeiDou B1I/B2I (16384).

corr_surface2 launches the CUDA kernel for CUDA tensors and takes the
plain version only for CPU tensors.  LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import _build

MAX_W = 16384
LAUNCHES = 0
_PLAIN_CHUNK_BYTES = 1 << 28   # bound on the plain version's temporary
_TW_CACHE: dict = {}


def twiddle_table(W: int) -> np.ndarray:
    """The kernel's inverse-FFT twiddles, complex64: e^{2 pi i k/16}
    (k < 16), then for each Stockham pass (radix R = min(16, W/Ns) at
    span Ns) the [R, Ns] table e^{2 pi i r k/(Ns R)}.  float64, rounded
    once."""
    parts = [np.exp(2j * np.pi * np.arange(16) / 16)]
    ns = 1
    while ns < W:
        r = min(16, W // ns)
        rk = np.arange(r)[:, None] * np.arange(ns)[None, :]
        parts.append(np.exp(2j * np.pi * rk / (ns * r)).reshape(-1))
        ns *= r
    return np.concatenate(parts).astype(np.complex64)


def twiddles(W: int, device) -> torch.Tensor:
    """twiddle_table(W) on `device`, cached."""
    key = (W, torch.device(device))
    tw = _TW_CACHE.get(key)
    if tw is None:
        tw = _TW_CACHE[key] = torch.from_numpy(twiddle_table(W)).to(device)
    return tw


def check_w(W: int, what: str):
    """Raise NotImplementedError unless the kernels take this W."""
    if W < 2 or W > MAX_W or W & (W - 1):
        raise NotImplementedError(
            f"{what} kernel takes power-of-two W <= {MAX_W}, got {W}")


def _check(F: torch.Tensor, code_f: torch.Tensor):
    if F.dtype != torch.complex64 or code_f.dtype != torch.complex64:
        raise TypeError("F and code_f must be complex64")
    if F.dim() != 3 or code_f.dim() != 2 or F.shape[2] != code_f.shape[1]:
        raise ValueError(f"shapes F {tuple(F.shape)} code_f "
                         f"{tuple(code_f.shape)}: want [DC,B,W], [P,W]")
    if F.device != code_f.device:
        raise ValueError("F and code_f on different devices")


def corr_surface2_plain(F: torch.Tensor, code_f: torch.Tensor):
    """Plain PyTorch version: ifft, abs, block sum, max/argmax/sum in
    float32, chunked over doppler to bound the [P, dc, B, W] temporary."""
    _check(F, code_f)
    DC, B, W = F.shape
    P = code_f.shape[0]
    dc = max(1, int(_PLAIN_CHUNK_BYTES // (P * B * W * 8)))
    peaks, idxs, sums = [], [], []
    for d0 in range(0, DC, dc):
        prod = code_f[:, None, None, :] * torch.conj(F[d0:d0 + dc])[None]
        q = torch.fft.ifft(prod, dim=-1).abs().sum(dim=2)      # [P, dc, W]
        idx = torch.argmax(q, dim=-1)
        peaks.append(torch.gather(q, -1, idx[..., None])[..., 0])
        idxs.append(idx.to(torch.int32))
        sums.append(q.sum(dim=-1))
    return torch.cat(peaks, 1), torch.cat(idxs, 1), torch.cat(sums, 1)


def corr_surface2(F: torch.Tensor, code_f: torch.Tensor):
    """(peak f32 [P, DC], idx i32 [P, DC], sum f32 [P, DC]) for F
    complex64 [DC, B, W] and code_f complex64 [P, W]."""
    global LAUNCHES
    _check(F, code_f)
    if F.device.type == "cpu":
        return corr_surface2_plain(F, code_f)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    DC, B, W = F.shape
    P = code_f.shape[0]
    check_w(W, "acquire2")
    lib = _build.load()
    F = F.contiguous()
    code_f = code_f.contiguous()
    tw = twiddles(W, F.device)
    peak = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    idx = torch.empty((P, DC), dtype=torch.int32, device=F.device)
    sm = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.acq2_reduce(F.data_ptr(), code_f.data_ptr(), tw.data_ptr(),
                              peak.data_ptr(), idx.data_ptr(), sm.data_ptr(),
                              P, DC, B, W, stream)
    _build.check(err, "acq2_reduce launch")
    LAUNCHES += 1
    return peak, idx, sm
