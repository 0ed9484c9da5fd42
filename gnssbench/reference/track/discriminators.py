# Frozen copy of gnss_dsp_tpu_torch/ops/discriminators.py at commit 196026d.
# Changed: nothing.
"""Carrier-loop discriminators, branchless, batched over channels.

Counterpart: gnss_dsp_tpu/ops/discriminators.py (gnsstools
discriminator.py:3-27).  Inputs are (re, im) pairs of float32 tensors:
the loop filter works on the correlator sums' real and imaginary parts
as separate float32 values, exactly as the CUDA kernel does.
"""

from __future__ import annotations

import math

import torch


def pll_costas(x):
    """Costas (sign-insensitive) phase discriminator, radians in
    (-pi/2, pi/2]: atan2 of x flipped into the right half-plane."""
    re, im = x
    flip = torch.where(re > 0, 1.0, -1.0).to(torch.float32)
    return torch.atan2(flip * im, flip * re)


def _ref_atan(x):
    """atan(Im/Re) in (-pi/2, pi/2), pi/2 when Re == 0."""
    re, im = x
    safe_re = torch.where(re == 0, torch.ones_like(re), re)
    t = torch.atan(im / safe_re)
    return torch.where(re == 0, torch.full_like(t, math.pi / 2), t)


def fll_atan(x, x1):
    """FLL discriminator with half-plane unwrap (discriminator.py:9-23)."""
    d = _ref_atan(x) - _ref_atan(x1)
    d = torch.where(d > math.pi / 2, math.pi - d, d)
    d = torch.where(d < -math.pi / 2, -math.pi - d, d)
    return d
