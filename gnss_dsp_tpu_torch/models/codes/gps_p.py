"""GPS P-code windowed generator.

Per IS-GPS-200 §3.3.2.2: the P code is the product of X1 (period
15,345,000 chips) and a PRN-delayed X2 (period 15,345,037), truncated to
one week = 6.1871328e12 chips.  X1/X2 are each built from two 12-bit
registers (X1A/X1B, X2A/X2B) with hold states that realize the precession
(X1B held 343 chips at the X1 epoch end, X2A/X2B held 37 extra chips, and
a special extended hold over the final 4092 chips of the week).

The full table is ~6e12 chips, so everything is windowed: `window(prn,
start, n)` materializes n chips on demand as vectorized index arithmetic
into the four short register sequences — the same windowing contract as
the reference (gnsstools/gps/p.py:40-95), validated against its output
hash for the week start and end-of-week wrap (tests/test_codes.py).

PRNs 38..210 select the same code with a day offset (p.py:82-85).
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.models.codes import lfsr

chip_rate = 10230000
code_length = chip_rate * 86400 * 7  # one week of chips

_X1_PERIOD = 15345000
_X2_PERIOD = 15345037

_x1a = lfsr.lfsr_seq(12, (11, 10, 7, 5), [0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0],
                     4092, out_taps=(11,))
_x1b = lfsr.lfsr_seq(12, (11, 10, 9, 8, 7, 4, 1, 0),
                     [0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], 4093, out_taps=(11,))
_x2a = lfsr.lfsr_seq(12, (11, 10, 9, 8, 7, 6, 4, 3, 2, 0),
                     [1, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1], 4092, out_taps=(11,))
_x2b = lfsr.lfsr_seq(12, (11, 8, 7, 3, 2, 1),
                     [0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], 4093, out_taps=(11,))


def _held(seq: np.ndarray, idx: np.ndarray, period: int, hold_from: int,
          hold_index: int) -> np.ndarray:
    """seq[idx mod len(seq)], except positions with idx >= hold_from
    frozen at seq[hold_index] (the ICD hold states)."""
    i = np.where(idx >= hold_from, hold_index, idx % len(seq))
    return seq[i]


def _x1(start: int, n: int) -> np.ndarray:
    idx = (start + np.arange(n, dtype=np.int64)) % _X1_PERIOD
    a = _x1a[idx % 4092]
    b = _held(_x1b, idx, _X1_PERIOD, _X1_PERIOD - 343, 4092)
    return a ^ b


def _x2(start: int, n: int) -> np.ndarray:
    idx = (start + np.arange(n, dtype=np.int64)) % _X2_PERIOD
    a = _held(_x2a, idx, _X2_PERIOD, _X2_PERIOD - 37, 4091)
    b = _held(_x2b, idx, _X2_PERIOD, _X2_PERIOD - 37 - 343, 4092)
    return a ^ b


def _x2_week_end(start: int, n: int) -> np.ndarray:
    """X2 during the final 4092 chips of the week: both registers hold
    through the end-of-week epoch (p.py:66-80)."""
    raw = start + np.arange(n, dtype=np.int64)
    idx_x2 = raw % _X2_PERIOD
    epoch = raw % _X1_PERIOD
    a = np.where(epoch >= _X1_PERIOD - 1069, 4091, idx_x2 % 4092)
    b = np.where(epoch >= _X1_PERIOD - 965, 4092, idx_x2 % 4093)
    return _x2a[a] ^ _x2b[b]


def window(prn: int, start: int, n: int) -> np.ndarray:
    """n chips of P(prn) beginning at chip `start`, uint8 {0,1}."""
    day = (prn - 1) // 37
    prn = prn - 37 * day
    start = (start + chip_rate * 86400 * day) % code_length

    w_x1 = _x1(start, n)
    w_x2 = _x2(start - prn, n)
    idx = (start - prn + np.arange(n, dtype=np.int64)) % code_length
    tail = idx >= code_length - 4092
    if tail.any():
        w_end = _x2_week_end((start - prn) % code_length, n)
        w_x2 = np.where(tail, w_end, w_x2)
    return (w_x1 ^ w_x2).astype(np.uint8)


def window_table(prn: int, start: int, n: int) -> np.ndarray:
    """int8 +-1 window (chip 0 -> +1)."""
    return lfsr.to_pm1(window(prn, start, n))


def first_12_chips(prn: int) -> int:
    """ICD test-vector helper: first 12 chips packed MSB-first as octal int
    (IS-GPS-200J Table 3-Ia; cf. p.py:105-115)."""
    c = window(prn, 0, 12)
    r = 0
    for b in c:
        r = 2 * r + int(b)
    return r


if __name__ == "__main__":
    # ICD self-check, the reference's standalone-module UX
    # (gps/ca.py:135-149): python -m gnss_dsp_tpu_torch.models.codes.gps_p
    from gnss_dsp_tpu_torch.models.codes import selftest

    raise SystemExit(selftest.run("gps_p"))
