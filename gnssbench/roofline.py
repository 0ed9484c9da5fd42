"""The roofline arithmetic of the benchmark's kernel metrics.

Frozen copy of chip_smoke.py's `bound`, `row_flops`, `surface_bound`,
`sample_ops` and `k2_bound` (with the peaks HBM_BYTES_PER_S and
FP32_FLOP_PER_S) at commit 196026d, unchanged; k1_call_bound_ms is
new: surface_bound at one K1 call's shape, as chip_smoke.py's k1 phase
calls it.

The peaks are the published ones of one H100 SXM (NVIDIA's data sheet:
3.35 TB/s of device memory, 67 TFLOP/s in float32 outside the tensor
cores), which assume the 700 W power limit; the run states the card's
limit beside every share it reports.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the float32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def row_flops(W):
    """Operations per transformed row value: 6 for code x conj(F), the
    usual 5 log2 W of an FFT, 4 for |.|, 1 for the sum over rows."""
    return 6 + 5 * math.log2(W) + 4 + 1


def surface_bound(P, DC, rows, W, out_bytes):
    """bound() of a surface over [P, DC, rows, W]: F and the code read
    once, the outputs written once."""
    return bound(DC * rows * W * 8 + P * W * 8 + out_bytes,
                 P * DC * rows * W * row_flops(W))


def sample_ops(kind):
    """Operations a sample and channel of the tracking correlators: about
    20 (carrier wipe 6, E/P/L chip phases 6, E/P/L sums 6, the DDS index
    2), plus the subcarrier factor's per lag (a family or K3's "subc" 6,
    K3's "tmboc" with its gate 10)."""
    return 20 + 3 * {"none": 0, "tmboc": 10}.get(kind, 6)


def k2_bound(x_numel, chips, rows, samples, kind):
    """bound() of one K2 launch: the chunk read once (8 bytes a sample),
    the chips the lags touch, the rows written (14 values a block and
    channel); the operations of sample_ops."""
    return bound(x_numel * 8 + chips + rows * 14 * 4,
                 samples * sample_ops(kind))


def k1_call_bound_ms(DC, B, W, P, reduce=True):
    """K1's bound for one corr_surface2 call on F [DC, B, W] and code
    spectra [P, W]: surface_bound with the reduction's three [P, DC]
    outputs (reduce) or the whole surface written."""
    out = P * DC * 12 if reduce else P * DC * W * 4
    return surface_bound(P, DC, B, W, out)[0]
