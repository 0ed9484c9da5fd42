"""Raw I/Q sample ingest on the host.

Counterpart: gnss_dsp_tpu/utils/io.py.  Format contract
(gnsstools/io.py:3-12): interleaved signed int8 I/Q pairs; a short read
means EOF and yields None.  The deinterleave is numpy (an int8 view,
then one conversion), with the bits of the reference's
utils/native.deinterleave_c64 / deinterleave_f32: int8 -> float32 is
exact.  The reference's g++ helper (utils/native.py) only made this same
host conversion faster and is not carried: the port's hot paths upload
the raw bytes and convert on the device (ops/cplx.from_int8_iq).
"""

from __future__ import annotations

import numpy as np


def get_samples_complex(fp, n: int):
    """Read n complex samples (2n int8 bytes); None at EOF (io.py:3-12)."""
    z = fp.read(2 * int(n))
    if len(z) != 2 * int(n):
        return None
    return bytes_to_complex(z)


def _pairs(z) -> np.ndarray:
    buf = np.frombuffer(z, np.int8) if isinstance(z, (bytes, bytearray,
                                                      memoryview)) else z
    n = buf.shape[0] // 2
    return buf[: 2 * n].reshape(-1, 2).astype(np.float32)


def bytes_to_complex(z) -> np.ndarray:
    """int8 I/Q bytes (or an int8 array) -> complex64 [n]."""
    s = _pairs(z)
    out = np.empty(s.shape[0], np.complex64)
    out.real = s[:, 0]
    out.imag = s[:, 1]
    return out


def bytes_to_split(z):
    """int8 I/Q bytes (or an int8 array) -> planar (re, im) float32 [n]."""
    s = _pairs(z)
    return np.ascontiguousarray(s[:, 0]), np.ascontiguousarray(s[:, 1])


class SampleStream:
    """Chunked streaming reader over an int8 I/Q file or pipe.

    Yields fixed-size numpy complex64 blocks of `block` samples; the final
    partial block is dropped (the reference's EOF-on-short-read rule,
    io.py:5-6)."""

    def __init__(self, fp, block: int):
        self.fp = fp
        self.block = int(block)

    def __iter__(self):
        while True:
            x = get_samples_complex(self.fp, self.block)
            if x is None:
                return
            yield x

    def read(self, n: int):
        return get_samples_complex(self.fp, n)
