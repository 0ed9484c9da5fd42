"""Non-coherent correlation surface with in-kernel (max, argmax, sum),
or the surface itself.

Counterpart: gnss_dsp_tpu/ops/pallas_acquire2.py:173-350, the
`corr_surface2` contract: reduce=True with its `n_valid` mask (:254-264),
and reduce=False, the natural-order surface (:320-323, 350) of the
sharded search (parallel/acquire).  Kernel: csrc/acquire2.cu.

For PRN p and doppler d:

    s[j] = sum_b | ifft(code_f[p] * conj(F[d, b])) [j] |      (1/W scaled)

    lo         = W - n_valid   (0 when n_valid = 0)
    peak[p, d] = max_{j >= lo} s[j]
    idx[p, d]  = (lowest j >= lo with s[j] == peak) - lo   (jnp.argmax ties)
    sum[p, d]  = sum_{j >= lo} s[j]

With reduce=False it returns s itself, q[p, d, j] = s[j], f32 [P, DC, W]
over every lag (no n_valid).

n_valid is the padded-window route (acquire/plan.acq_plan "v2p"): the
n_valid last lags of a zero-padded window are the exact linear
correlations, reported from 0.  Inputs are complex64 in NATURAL order
(the TPU kernel took split bf16 planes in a permuted order;
interop.code_ffts_from_split converts).

The kernel runs one thread-block cluster per (PRN, doppler) and keeps
every row in the cluster's shared memory (csrc/acq_cluster.cuh), on one
of two cores (core_plan): at the windows of SPLIT_CLUSTERS (GPS L1 at
4096, BeiDou B1I/B2I at 16384, the padded 32768 and 65536, Galileo E1 at
65536, GPS L1C and BeiDou B1C at 81920 = 256 * 320) the sub-transforms
run in registers at compile-time sizes, one build per (W, cluster size);
at any other W that wide_split factors and a cluster of up to
MAX_CLUSTER CTAs holds (GPS L2CM at 163840 = 320 * 512) they run as
Stockham passes at run-time sizes.  Any other window raises
NotImplementedError on a CUDA tensor.  The kernel divides the block sum
by W once where the plain version scales each inverse transform: at a W
that is not a power of two the two differ by float32 rounding (rtol 1e-4
in the card checks).

With reduce=False the kernel runs the same cores and, in place of the
cluster's reduction, each thread stores its lags' sums to q (the store
epilogue of acq_cluster.cuh); launch_info(..., reduce=False) gives that
build's plan.

corr_surface2 launches the CUDA kernel for CUDA tensors and takes the
plain version only for CPU tensors.  LAUNCHES counts the launches with
reduce=True, LAUNCHES_SURFACE those with reduce=False.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import _build

MAX_W = 16384
LAUNCHES = 0
LAUNCHES_SURFACE = 0
_PLAIN_CHUNK_BYTES = 1 << 28   # bound on the plain version's temporary
_TW_CACHE: dict = {}

# the cluster cores' Stockham passes (csrc/acq_cluster.cuh): the radices
# in the order next_radix tries them, the roots of the odd ones after
# e^{2 pi i k/16} in the table header, and the longest sub-transform
WIDE_RADICES = (16, 8, 4, 2, 3, 5, 11, 31)
WIDE_ROOTS = (3, 5, 11, 31)
WIDE_TILE = 4096

# K1 (csrc/acquire2.cu).  The register (Split) core's builds: W -> the
# cluster sizes built, the kernel's choice first; at (32768, 8) and
# (65536, 8) each thread keeps its code values in registers; 81920 =
# 256 x 320 runs its rows on Split<320>.  Any other (W, cluster) takes the
# run-time core.
SPLIT_CLUSTERS = {4096: (2, 1, 4, 8), 16384: (8,), 32768: (8, 16),
                  65536: (8, 16), 81920: (16,)}
# The run-time core's CTA (threads, lags a thread), the largest cluster
# (16 CTAs: non-portable) and the shared memory a CTA may use
WIDE_THREADS, WIDE_PER = 384, 27
MAX_CLUSTER = 16
SMEM_LIMIT = 227 * 1024


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


def _cached(key, make, device):
    key = key + (torch.device(device),)
    t = _TW_CACHE.get(key)
    if t is None:
        t = _TW_CACHE[key] = torch.from_numpy(make()).to(device)
    return t


def check_w(W: int, what: str):
    """Raise NotImplementedError unless W is a power of two <= MAX_W, the
    windows of K6."""
    if not (2 <= W <= MAX_W and W & (W - 1) == 0):
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


def corr_surface_plain(F: torch.Tensor, code_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the surface (corr_surface2 with
    reduce=False, and K7's): ifft, abs, block sum, f32 [P, DC, W]."""
    _check(F, code_f)
    DC, _, W = F.shape
    q = torch.empty((code_f.shape[0], DC, W), dtype=torch.float32,
                    device=F.device)
    for p0, d0, qc in surface_plain(F, code_f):
        q[p0:p0 + qc.shape[0], d0:d0 + qc.shape[1]] = qc
    return q


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


def _stride(m: int) -> int:
    """acq_cluster.cuh stride_of: a transform's stride in shared memory."""
    return (m + (m >> 4)) | 1


def core_plan(W: int, cluster: int = 0):
    """(core, n1, n2, C): the core and the cluster size K1 runs W on, as
    csrc/acquire2.cu chooses them (cluster: 0 for the kernel's choice):
    cluster_core_plan over SPLIT_CLUSTERS."""
    return cluster_core_plan(W, cluster, SPLIT_CLUSTERS.get(W, ()), "K1")


def cluster_core_plan(W: int, cluster: int, built: tuple, what: str):
    """(core, n1, n2, C) of a kernel on the cluster cores of
    csrc/acq_cluster.cuh (K1, K5) whose register core is built at W on
    the cluster sizes `built`, its choice first (cluster: 0 for the
    kernel's choice).  core "split": the register core on a size built,
    n1 = 2^floor(log2(W)/2); core "wide": the run-time core at any other,
    at wide_split(W) over the fewest CTAs (up to MAX_CLUSTER; or
    `cluster`) whose lags (nr * n2) fit WIDE_THREADS * WIDE_PER and whose
    two buffers and twiddle table fit SMEM_LIMIT.  NotImplementedError
    naming `what` and W when there is none."""
    if not 0 <= cluster <= MAX_CLUSTER:
        raise NotImplementedError(f"{what} takes clusters of up to "
                                  f"{MAX_CLUSTER} CTAs, not {cluster}")
    if not cluster and built or cluster in built:
        n1 = 1 << (W.bit_length() - 1) // 2
        return "split", n1, W // n1, cluster or built[0]
    try:
        n1, n2 = wide_split(W)
    except NotImplementedError as e:
        raise NotImplementedError(f"{what}: {e}") from None
    ntw = (16 + sum(WIDE_ROOTS) + sum(r * ns for m in (n1, n2)
                                      for r, ns in wide_passes(m))
           + n1 + n2)
    for C in ([cluster] if cluster else range(1, MAX_CLUSTER + 1)):
        nc, nr = -(-n2 // C), -(-n1 // C)
        if (C - 1) * nc >= n2 or (C - 1) * nr >= n1:
            continue
        buf = max(nc * _stride(n1), nr * _stride(n2))
        if (nr * n2 <= WIDE_THREADS * WIDE_PER
                and (2 * buf + ntw) * 8 <= SMEM_LIMIT):
            return "wide", n1, n2, C
    raise NotImplementedError(
        f"{what}: no cluster of up to {MAX_CLUSTER} CTAs holds a row of W = "
        f"{W} = {n1} x {n2}" + (f" on {cluster} CTAs" if cluster else ""))


@functools.lru_cache(maxsize=64)
def launch_info(W: int, device_index: int, cluster: int = 0,
                reduce: bool = True) -> dict:
    """K1's launch plan at W on the card `device_index` (acq2_info; with
    reduce=False the surface's build, acq2_surface_info): cluster size,
    dynamic shared memory bytes a CTA, registers and spilled bytes a
    thread, clusters the card holds at once, threads a CTA, n1, n2 and the
    core ("split" or "wide").  NotImplementedError where core_plan has
    none."""
    lib = _build.load()
    return read_launch_info(lib.acq2_info if reduce else
                            lib.acq2_surface_info, W, device_index,
                            cluster, core_plan(W, cluster), "K1")


def read_launch_info(info_fn, W: int, device_index: int, cluster: int,
                     plan: tuple, what: str) -> dict:
    """A cluster-core kernel's launch plan from its C entry point
    `info_fn` (acq2_info, acq_coh_spec_info), checked against the host's
    plan (core, n1, n2, C)."""
    info = (ctypes.c_int * 9)()
    with torch.cuda.device(device_index):
        err = info_fn(W, cluster, info)
    _build.check(err, f"{what}'s plan at W={W}, cluster={cluster}")
    got = dict(zip(("cluster", "smem", "regs", "spill_bytes", "active",
                    "threads", "n1", "n2"), info))
    got["core"] = ("split", "wide")[info[8]]
    if (got["core"], got["n1"], got["n2"], got["cluster"]) != tuple(plan):
        raise RuntimeError(f"{what}'s plan at W={W}: kernel {got}, host "
                           f"{plan}")
    return got


def corr_surface2(F: torch.Tensor, code_f: torch.Tensor, n_valid: int = 0,
                  reduce: bool = True, *, cluster: int = 0):
    """(peak f32 [P, DC], idx i32 [P, DC], sum f32 [P, DC]) for F
    complex64 [DC, B, W] and code_f complex64 [P, W], over the n_valid
    last lags (all lags when 0); with reduce=False the surface q f32
    [P, DC, W] instead (n_valid must be 0).  On the card `cluster` CTAs a
    cluster as core_plan (0: the kernel's choice)."""
    global LAUNCHES, LAUNCHES_SURFACE
    _check(F, code_f)
    DC, B, W = F.shape
    if not 0 <= n_valid <= W:
        raise ValueError(f"n_valid {n_valid} outside [0, {W}]")
    if n_valid and not reduce:
        raise ValueError("the surface (reduce=False) covers every lag: "
                         "n_valid must be 0")
    if F.device.type == "cpu":
        if not reduce:
            return corr_surface_plain(F, code_f)
        return corr_surface2_plain(F, code_f, n_valid)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    P = code_f.shape[0]
    dev = F.device.index if F.device.index is not None \
        else torch.cuda.current_device()
    info = launch_info(W, dev, cluster, reduce)
    tw = (cluster_twiddles(info["n1"], info["n2"], F.device)
          if info["core"] == "wide" else None)
    lib = _build.load()
    F = F.contiguous()
    code_f = code_f.contiguous()
    if not reduce:
        q = torch.empty((P, DC, W), dtype=torch.float32, device=F.device)
        with torch.cuda.device(F.device):
            stream = torch.cuda.current_stream(F.device).cuda_stream
            err = lib.acq2_surface(F.data_ptr(), code_f.data_ptr(),
                                   None if tw is None else tw.data_ptr(),
                                   q.data_ptr(), P, DC, B, W, cluster, stream)
        _build.check(err, "acq2_surface launch")
        LAUNCHES_SURFACE += 1
        return q
    peak = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    idx = torch.empty((P, DC), dtype=torch.int32, device=F.device)
    sm = torch.empty((P, DC), dtype=torch.float32, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.acq2_reduce(F.data_ptr(), code_f.data_ptr(),
                              None if tw is None else tw.data_ptr(),
                              peak.data_ptr(), idx.data_ptr(), sm.data_ptr(),
                              P, DC, B, W, n_valid, cluster, stream)
    _build.check(err, "acq2_reduce launch")
    LAUNCHES += 1
    return peak, idx, sm
