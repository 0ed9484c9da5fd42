"""Squaring-detector filter.

Counterpart: gnss_dsp_tpu/cli/squaring.py:14-61 (behavioral contract
squaring.py:10-42): read raw int8 I/Q, wipe the carrier offset, boxcar-
decimate by 16, square, 100 non-coherent sums, write int16 I/Q to stdout
(baudline food).

  python -m gnss_dsp_tpu_torch.cli.squaring input_file sample_rate \\
      carrier_offset [--device cuda|cpu]

Each round reads b * n * m = 1000 * 16 * 100 samples through utils/io
(short read: EOF), wipes the carrier with ops/frontend.mix_long, its
phase carried over from round to round, runs ops/squaring on the device
and writes round(20 * r) as interleaved int16 I/Q.  --device (default
cuda, or cpu while GNSS_DSP_CPU is set, named on stderr) may stand
anywhere on the line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gnss_dsp_tpu_torch.device import pop_device_arg, resolve_device
from gnss_dsp_tpu_torch.ops.frontend import mix_long
from gnss_dsp_tpu_torch.ops.squaring import squaring
from gnss_dsp_tpu_torch.utils import io as uio

B, N, M = 1000, 16, 100


def main(argv=None) -> int:
    device, argv = pop_device_arg(sys.argv[1:] if argv is None else argv,
                                  "squaring")
    if len(argv) != 3:
        print("usage: squaring file sample_rate carrier_offset "
              "[--device cuda|cpu]", file=sys.stderr)
        return 2
    dev = resolve_device(device)
    filename, fs, coffset = argv[0], float(argv[1]), float(argv[2])
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    out = sys.stdout.buffer
    coffset_phase = 0.0
    y = np.zeros(2 * B, np.int16)
    try:
        while True:
            x = uio.get_samples_complex(fp, B * N * M)
            if x is None:
                return 0
            xs = mix_long(torch.from_numpy(x).to(dev), -coffset / fs,
                          coffset_phase)
            coffset_phase = float(np.mod(coffset_phase
                                         - len(x) * coffset / fs, 1))
            r = squaring(xs, N, M).cpu().numpy()
            y[0::2] = np.round(20 * r.real).astype(np.int16)
            y[1::2] = np.round(20 * r.imag).astype(np.int16)
            y.tofile(out)
    finally:
        if filename != "-":
            fp.close()


def _entry():
    sys.exit(main(sys.argv[1:]))


if __name__ == "__main__":
    _entry()
