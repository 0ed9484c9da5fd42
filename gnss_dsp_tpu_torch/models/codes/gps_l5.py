"""GPS L5 (L5I / L5Q) code tables.

Construction per IS-GPS-705 §3.2.1.1: code = XA xor XB-shifted, where XA
is a 13-bit register short-cycled to 8190 chips (the state 1111111111101
is replaced by all-ones instead of shifting) and XB is a full-period
8191-chip 13-bit register advanced by a per-PRN ICD offset.  Behavioral
contract: gnsstools/gps/l5i.py:73-107 (XA/XB construction and the
xb[(offset+i) mod 8191] indexing), l5q.py for the Q-channel tables.
Secondary codes: NH10 on I, NH20 on Q (l5i.py:10-11, l5q.py:9).
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.models.codes import data, lfsr

chip_rate = 10230000
code_length = 10230

NH10 = np.array([0, 0, 0, 0, 1, 1, 0, 1, 0, 1], np.uint8)
NH20 = np.array([0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0],
                np.uint8)

# register conventions match the reference lists: new bit at x[0], output
# x[12]; taps are positions in the pre-shift state.
_XA_TAPS = (12, 11, 9, 8)
_XB_I_TAPS = (12, 11, 7, 6, 5, 3, 2, 0)
_XB_Q_TAPS = (12, 11, 7, 6, 5, 3, 2, 0)  # same polynomial; offsets differ
_XA_SHORT = lfsr.bits_to_int([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1])
_ALL1 = (1 << 13) - 1


def _make_xa() -> np.ndarray:
    """XA stream over one 10230-chip code period with the short-cycle."""
    x = _ALL1
    tapmask = sum(1 << t for t in _XA_TAPS)
    y = np.empty(code_length, np.uint8)
    for i in range(code_length):
        y[i] = (x >> 12) & 1
        if x == _XA_SHORT:
            x = _ALL1
        else:
            new = (x & tapmask).bit_count() & 1
            x = ((x << 1) | new) & _ALL1
    return y


_xa = None
_xb = None


def _sequences():
    global _xa, _xb
    if _xa is None:
        _xa = _make_xa()
        _xb = lfsr.lfsr_seq(13, _XB_I_TAPS, [1] * 13, 8191, out_taps=(12,))
    return _xa, _xb


def _bits(init_table: str, prns) -> np.ndarray:
    xa, xb = _sequences()
    offs = data.pairs(init_table)
    idx = np.arange(code_length, dtype=np.int64)
    rows = [xa ^ xb[(offs[p] + idx) % 8191] for p in prns]
    return np.stack(rows)


def prns_all() -> tuple:
    return tuple(sorted(data.pairs("gps_l5i_init")))


def l5i_table(prns) -> np.ndarray:
    return lfsr.to_pm1(_bits("gps_l5i_init", prns))


def l5q_table(prns) -> np.ndarray:
    return lfsr.to_pm1(_bits("gps_l5q_init", prns))


if __name__ == "__main__":
    # ICD self-check, the reference's standalone-module UX
    # (gps/ca.py:135-149): python -m gnss_dsp_tpu_torch.models.codes.gps_l5
    from gnss_dsp_tpu_torch.models.codes import selftest

    raise SystemExit(selftest.run("gps_l5"))
