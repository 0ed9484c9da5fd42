"""Non-coherent correlation surface with in-kernel (max, argmax, sum).

Counterpart: gnss_dsp_tpu/ops/pallas_acquire2.py:173-350, the
`corr_surface2(reduce=True)` contract with its `n_valid` mask
(:254-264).  Kernel: csrc/acquire2.cu.

For PRN p and doppler d:

    s[j] = sum_b | ifft(code_f[p] * conj(F[d, b])) [j] |      (1/W scaled)

    lo         = W - n_valid   (0 when n_valid = 0)
    peak[p, d] = max_{j >= lo} s[j]
    idx[p, d]  = (lowest j >= lo with s[j] == peak) - lo   (jnp.argmax ties)
    sum[p, d]  = sum_{j >= lo} s[j]

n_valid is the padded-window route (acquire/plan.acq_plan "v2p"): the
n_valid last lags of a zero-padded window are the exact linear
correlations, reported from 0.  Inputs are complex64 in NATURAL order
(the TPU kernel took split bf16 planes in a permuted order;
interop.code_ffts_from_split converts).

The kernel takes a power-of-two W <= MAX_W in one CTA's shared memory
(GPS L1 at 4096, the 2n windows of BeiDou B1I/B2I at 16384), and any
other W that wide_split factors as n1 * n2 through the four-step kernel
of csrc/acq_wide.cuh (the padded 32768 and 65536, Galileo E1 at 65536,
GPS L1C and BeiDou B1C at 81920 = 256 * 320, GPS L2CM at 163840 =
320 * 512).  For a W that is not a power of two the kernel divides the
block sum by W once where the plain version scales each inverse
transform: the two differ by float32 rounding (rtol 1e-4 in the card
checks).

corr_surface2 launches the CUDA kernel for CUDA tensors and takes the
plain version only for CPU tensors.  LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import _build

MAX_W = 16384
LAUNCHES = 0
_PLAIN_CHUNK_BYTES = 1 << 28   # bound on the plain version's temporary
_TW_CACHE: dict = {}

# four-step kernel (csrc/acq_wide.cuh): the Stockham radices in the order
# next_radix tries them, the roots of the odd ones after e^{2 pi i k/16}
# in the table header, and the longest sub-transform a tile holds
WIDE_RADICES = (16, 8, 4, 2, 3, 5, 11, 31)
WIDE_ROOTS = (3, 5, 11, 31)
WIDE_TILE = 4096


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


def next_radix(rem: int) -> int:
    """Radix of the four-step kernel's next pass over `rem` (0: none)."""
    for r in WIDE_RADICES:
        if rem % r == 0:
            return r
    return 0


def wide_passes(m: int) -> list:
    """(radix, span) of each Stockham pass of an m-point transform;
    ValueError when m has a factor the passes do not take."""
    out, ns = [], 1
    while ns < m:
        r = next_radix(m // ns)
        if r == 0:
            raise ValueError(f"{m} has a factor other than 2, 3, 5, 11, 31")
        out.append((r, ns))
        ns *= r
    return out


def wide_split(W: int):
    """(n1, n2) of the four-step kernel: the largest divisor n1 <=
    sqrt(W) with n1 and n2 = W / n1 made of the pass radices and both
    <= WIDE_TILE.  NotImplementedError when there is none."""
    for n1 in range(math.isqrt(W), 1, -1):
        n2 = W // n1
        if W % n1 or n2 > WIDE_TILE:
            continue
        try:
            wide_passes(n1)
            wide_passes(n2)
        except ValueError:
            continue
        return n1, n2
    raise NotImplementedError(
        f"W = {W} has no split n1 * n2 into factors 2, 3, 5, 11, 31 with "
        f"both <= {WIDE_TILE}")


def wide_twiddle_table(n1: int, n2: int) -> np.ndarray:
    """The four-step kernel's shared twiddles, complex64: e^{2 pi i k/16}
    (k < 16) and e^{2 pi i k/R} for R in WIDE_ROOTS, then for each pass
    (R, Ns) of the n1-point transform the [R, Ns] table
    e^{2 pi i r k/(Ns R)}, then those of the n2-point one.  float64,
    rounded once."""
    parts = [np.exp(2j * np.pi * np.arange(16) / 16)]
    parts += [np.exp(2j * np.pi * np.arange(r) / r) for r in WIDE_ROOTS]
    for m in (n1, n2):
        for r, ns in wide_passes(m):
            rk = np.arange(r)[:, None] * np.arange(ns)[None, :]
            parts.append(np.exp(2j * np.pi * rk / (ns * r)).reshape(-1))
    return np.concatenate(parts).astype(np.complex64)


def cluster_twiddle_table(n1: int, n2: int) -> np.ndarray:
    """The cluster kernels' twiddles (csrc/acq_cluster.cuh), complex64:
    wide_twiddle_table(n1, n2), then the two tables of the four-step
    twiddle w^t = A[t mod n2] * B[t div n2] (w = e^{2 pi i/W}, W = n1*n2):
    A[u] = w^u for u < n2, B[v] = e^{2 pi i v/n1} for v < n1.  float64,
    rounded once."""
    W = n1 * n2
    return np.concatenate([
        wide_twiddle_table(n1, n2),
        np.exp(2j * np.pi * np.arange(n2) / W).astype(np.complex64),
        np.exp(2j * np.pi * np.arange(n1) / n1).astype(np.complex64)])


def cluster_twiddles(n1: int, n2: int, device) -> torch.Tensor:
    """cluster_twiddle_table(n1, n2) on `device`, cached."""
    return _cached(("cluster", n1, n2),
                   lambda: cluster_twiddle_table(n1, n2), device)


def root_table(W: int) -> np.ndarray:
    """e^{2 pi i t/W} for t < W, complex64 from float64: the four-step
    twiddle w^(j1*k2)."""
    return np.exp(2j * np.pi * np.arange(W) / W).astype(np.complex64)


def _cached(key, make, device):
    key = key + (torch.device(device),)
    t = _TW_CACHE.get(key)
    if t is None:
        t = _TW_CACHE[key] = torch.from_numpy(make()).to(device)
    return t


def twiddles(W: int, device) -> torch.Tensor:
    """twiddle_table(W) on `device`, cached."""
    return _cached(("pow2", W), lambda: twiddle_table(W), device)


def wide_tables(W: int, device):
    """(n1, n2, wide_twiddle_table, root_table) of W on `device`, cached."""
    n1, n2 = wide_split(W)
    tw = _cached(("wide", n1, n2), lambda: wide_twiddle_table(n1, n2),
                 device)
    return n1, n2, tw, _cached(("root", W), lambda: root_table(W), device)


def wide_scratch(P: int, DC: int, B: int, W: int, device):
    """(slots, nseg, rowbuf, acc): the four-step kernel's CTA slots (two
    per SM), its block segments per (PRN, doppler), and its scratch:
    rowbuf complex64 [slots, W] and acc f32 [slots, W], or
    [P*DC*nseg, W] where P*DC falls short of half the slots and each
    (PRN, doppler)'s blocks are split over nseg CTAs, as many as one wave
    of the grid holds."""
    slots = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    nseg = max(1, min(B, slots // (P * DC)))
    return (slots, nseg,
            torch.empty((slots, W), dtype=torch.complex64, device=device),
            torch.empty((slots if nseg == 1 else P * DC * nseg, W),
                        dtype=torch.float32, device=device))


def in_smem(W: int) -> bool:
    """The one-CTA shared-memory kernel takes W (else the four-step)."""
    return 2 <= W <= MAX_W and W & (W - 1) == 0


def check_w(W: int, what: str):
    """Raise NotImplementedError unless W is a power of two <= MAX_W, the
    windows of K1's shared-memory mode, K5 and K6."""
    if not in_smem(W):
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


def surface_plain(F: torch.Tensor, code_f: torch.Tensor):
    """Yields (p0, d0, q) with q = the 1/W-scaled block-summed surface
    f32 [pc, dc, W] of PRNs p0.. and dopplers d0..: ifft, abs, block sum,
    chunked over PRN and doppler to bound the [pc, dc, B, W] temporary."""
    DC, B, W = F.shape
    P = code_f.shape[0]
    row = B * W * 8
    pc = int(np.clip(_PLAIN_CHUNK_BYTES // row, 1, P))
    dc = int(np.clip(_PLAIN_CHUNK_BYTES // (pc * row), 1, DC))
    for d0 in range(0, DC, dc):
        for p0 in range(0, P, pc):
            prod = (code_f[p0:p0 + pc, None, None, :]
                    * torch.conj(F[d0:d0 + dc])[None])
            yield p0, d0, torch.fft.ifft(prod, dim=-1).abs().sum(dim=2)


def corr_surface2_plain(F: torch.Tensor, code_f: torch.Tensor,
                        n_valid: int = 0):
    """Plain PyTorch version: ifft, abs, block sum, then max, first
    argmax and sum over the searched lags, in float32."""
    _check(F, code_f)
    DC, B, W = F.shape
    P = code_f.shape[0]
    peak = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    idx = torch.empty((P, DC), dtype=torch.int32, device=F.device)
    sm = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    for p0, d0, q in surface_plain(F, code_f):
        if n_valid:
            q = q[..., W - n_valid:]
        i = torch.argmax(q, dim=-1)
        pc, dc = q.shape[:2]
        peak[p0:p0 + pc, d0:d0 + dc] = torch.gather(q, -1, i[..., None])[..., 0]
        idx[p0:p0 + pc, d0:d0 + dc] = i.to(torch.int32)
        sm[p0:p0 + pc, d0:d0 + dc] = q.sum(dim=-1)
    return peak, idx, sm


def corr_surface2(F: torch.Tensor, code_f: torch.Tensor, n_valid: int = 0):
    """(peak f32 [P, DC], idx i32 [P, DC], sum f32 [P, DC]) for F
    complex64 [DC, B, W] and code_f complex64 [P, W], over the n_valid
    last lags (all lags when 0)."""
    global LAUNCHES
    _check(F, code_f)
    DC, B, W = F.shape
    if not 0 <= n_valid <= W:
        raise ValueError(f"n_valid {n_valid} outside [0, {W}]")
    if F.device.type == "cpu":
        return corr_surface2_plain(F, code_f, n_valid)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    P = code_f.shape[0]
    wide = None if in_smem(W) else wide_tables(W, F.device)
    lib = _build.load()
    F = F.contiguous()
    code_f = code_f.contiguous()
    peak = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    idx = torch.empty((P, DC), dtype=torch.int32, device=F.device)
    sm = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        if wide is None:
            tw = twiddles(W, F.device)
            err = lib.acq2_reduce(F.data_ptr(), code_f.data_ptr(),
                                  tw.data_ptr(), peak.data_ptr(),
                                  idx.data_ptr(), sm.data_ptr(), P, DC, B, W,
                                  n_valid, stream)
        else:
            n1, n2, tw, root = wide
            slots, nseg, rowbuf, acc = wide_scratch(P, DC, B, W, F.device)
            err = lib.acq2_reduce_wide(
                F.data_ptr(), code_f.data_ptr(), tw.data_ptr(),
                root.data_ptr(), rowbuf.data_ptr(), acc.data_ptr(),
                peak.data_ptr(), idx.data_ptr(), sm.data_ptr(), P, DC, B, W,
                n1, n2, n_valid, slots, nseg, stream)
    _build.check(err, "acq2_reduce launch")
    LAUNCHES += 1
    return peak, idx, sm
