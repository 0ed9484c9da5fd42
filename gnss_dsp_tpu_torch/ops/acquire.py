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
(acquire/plan.acq_plan "v1": Xona X5 at W = 30690); the engine takes
max, first argmax and mean over the lags in torch.  The kernel is the
four-step kernel that K1 runs at wide W (csrc/acq_wide.cuh), at any W
that acquire2.wide_split factors; it divides the block sum by W once
where the plain version scales each inverse transform (float32
rounding apart, rtol 1e-4 in the card checks).

corr_surface is the CUDA wrapper: it refuses CPU tensors, and the
engine takes corr_surface_plain for those.  LAUNCHES counts launches.
"""

from __future__ import annotations

import torch

from gnss_dsp_tpu_torch.ops import _build
from gnss_dsp_tpu_torch.ops.acquire2 import (
    _check, surface_plain, wide_scratch, wide_tables)

LAUNCHES = 0


def corr_surface_plain(F: torch.Tensor, code_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ifft, abs, block sum, f32 [P, DC, W]."""
    _check(F, code_f)
    DC, _, W = F.shape
    q = torch.empty((code_f.shape[0], DC, W), dtype=torch.float32,
                    device=F.device)
    for p0, d0, qc in surface_plain(F, code_f):
        q[p0:p0 + qc.shape[0], d0:d0 + qc.shape[1]] = qc
    return q


def corr_surface(F: torch.Tensor, code_f: torch.Tensor) -> torch.Tensor:
    """q f32 [P, DC, W] for CUDA tensors F complex64 [DC, B, W] and
    code_f complex64 [P, W]."""
    global LAUNCHES
    _check(F, code_f)
    if F.device.type != "cuda":
        raise ValueError(f"corr_surface launches a CUDA kernel; got a "
                         f"tensor on {F.device} (corr_surface_plain runs "
                         f"on the CPU)")
    DC, B, W = F.shape
    P = code_f.shape[0]
    n1, n2, tw, root = wide_tables(W, F.device)
    lib = _build.load()
    F = F.contiguous()
    code_f = code_f.contiguous()
    q = torch.empty((P, DC, W), dtype=torch.float32, device=F.device)
    slots, nseg, rowbuf, acc = wide_scratch(P, DC, B, W, F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.acq_surface_full(
            F.data_ptr(), code_f.data_ptr(), tw.data_ptr(), root.data_ptr(),
            rowbuf.data_ptr(), acc.data_ptr(), q.data_ptr(), P, DC, B, W,
            n1, n2, slots, nseg, stream)
    _build.check(err, "acq_surface_full launch")
    LAUNCHES += 1
    return q
