"""Non-coherent correlation surface, full and unreduced (kernel K7).

Counterpart: gnss_dsp_tpu/ops/pallas_acquire.py::corr_surface (:183,
pallas_call :221).  Kernel: csrc/acquire.cu.

For PRN p, doppler d and lag j:

    q[p, d, j] = sum_b | ifft(code_f[p] * conj(F[d, b])) [j] |   (1/W scaled)

F complex64 [DC, B, W] and code_f complex64 [P, W] are in NATURAL order,
and so is q f32 [P, DC, W].  The TPU kernel took permuted split bf16
planes and returned q permuted (index j2*n1 + j1), a layout of its
128-lane matrix-unit split that perm_to_natural_index undid; here the
lag axis is natural and the engine needs no index conversion.

It serves the circular route at windows with no aligned split
(acquire/plan.acq_plan "v1": Xona X5 at W = 30690; acquire/plan.mesh_plan
"v1", the sharded search: the 2n windows 30690 and 61380 of the pad2
signals); the engine takes max, first argmax and mean over the lags in
torch.  The kernel transforms each row across a thread-block cluster
(csrc/acq_cluster.cuh) at any W that acquire2.wide_split factors and whose
row a cluster of up to 8 CTAs holds (NotImplementedError otherwise), on
the cluster size that keeps the most CTAs busy at once (W = 30690 = 165 x
186 on 4 CTAs, 61380 = 220 x 279 on 8);
it divides the block sum by W once where the plain version scales each
inverse transform (float32 rounding apart, rtol 1e-4 in the card
checks).  Where P*DC clusters do not fill the card, each (PRN, doppler)'s
blocks are split into segments, summed in order by a second kernel.

corr_surface is the CUDA wrapper: it refuses CPU tensors, and the
engine takes corr_surface_plain for those (acquire2's, the plain version
of K1's surface too).  LAUNCHES counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnss_dsp_tpu_torch.ops import _build
from gnss_dsp_tpu_torch.ops.acquire2 import (  # noqa: F401 (re-export)
    _check, cluster_twiddles, corr_surface_plain, wide_split)

LAUNCHES = 0
_INVALID = 1          # cudaErrorInvalidValue: no cluster holds the row


@functools.lru_cache(maxsize=64)
def launch_info(P: int, DC: int, B: int, W: int, device_index: int,
                cluster: int = 0) -> dict:
    """The kernel's launch plan for P*DC items of B blocks at W on the
    card `device_index` (cluster CTAs, 0: the kernel's choice): cluster
    size, segments per (PRN, doppler), dynamic shared memory bytes a CTA,
    registers and spilled bytes a thread, clusters the card holds at once.
    NotImplementedError when no cluster of up to 8 CTAs holds the row."""
    n1, n2 = wide_split(W)
    lib = _build.load()
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        err = lib.acq_full_info(P, DC, B, W, n1, n2, cluster, info)
    if err == _INVALID:
        raise NotImplementedError(
            f"no cluster of up to 8 CTAs holds a row of W = {W} = "
            f"{n1} x {n2}" + (f" on {cluster} CTAs" if cluster else ""))
    _build.check(err, "acq_full_info")
    keys = ("cluster", "nseg", "smem", "regs", "spill_bytes", "active")
    return dict(zip(keys, info), n1=n1, n2=n2)


def corr_surface(F: torch.Tensor, code_f: torch.Tensor, *,
                 cluster: int = 0) -> torch.Tensor:
    """q f32 [P, DC, W] for CUDA tensors F complex64 [DC, B, W] and
    code_f complex64 [P, W]; `cluster` CTAs a cluster (0: the kernel's
    choice)."""
    global LAUNCHES
    _check(F, code_f)
    if F.device.type != "cuda":
        raise ValueError(f"corr_surface launches a CUDA kernel; got a "
                         f"tensor on {F.device} (corr_surface_plain runs "
                         f"on the CPU)")
    DC, B, W = F.shape
    P = code_f.shape[0]
    dev = F.device.index if F.device.index is not None \
        else torch.cuda.current_device()
    info = launch_info(P, DC, B, W, dev, cluster)
    n1, n2, nseg = info["n1"], info["n2"], info["nseg"]
    tw = cluster_twiddles(n1, n2, F.device)
    lib = _build.load()
    F = F.contiguous()
    code_f = code_f.contiguous()
    q = torch.empty((P, DC, W), dtype=torch.float32, device=F.device)
    part = (torch.empty((P * DC * nseg, W), dtype=torch.float32,
                        device=F.device) if nseg > 1 else q)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.acq_surface_full(
            F.data_ptr(), code_f.data_ptr(), tw.data_ptr(), part.data_ptr(),
            q.data_ptr(), P, DC, B, W, n1, n2, info["cluster"], nseg, stream)
    _build.check(err, "acq_surface_full launch")
    LAUNCHES += 1
    return q
