"""Squaring detector: boxcar-decimate by n, square, m non-coherent sums.

Counterpart: gnss_dsp_tpu/ops/squaring.py:20-28.  Behavioral contract
gnsstools/squaring.py:13-23:

    r[b] = sum_{k<m} (sum_{l<n} x[b*n*m + k*n + l])^2 / n

Two reshapes and sums on the tensor's device.  It is not a Pallas kernel
in the reference (XLA reductions under jit), so it has no CUDA kernel
here either.
"""

from __future__ import annotations

import torch


def squaring(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """x: complex64 [blocks*n*m] (a tail short of a block is dropped) ->
    complex64 [blocks], on x's device."""
    blocks = x.shape[0] // (n * m)
    s = x[: blocks * n * m].reshape(blocks, m, n).sum(dim=-1)
    sr, si = s.real, s.imag
    # the reference's split-complex square, (sr^2 - si^2, 2 sr si)
    return torch.complex((sr * sr - si * si).sum(dim=-1) / n,
                         (sr * si + si * sr).sum(dim=-1) / n)
