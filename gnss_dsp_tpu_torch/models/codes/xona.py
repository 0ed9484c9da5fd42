"""Xona PULSAR X1 / X5 code tables (memory codes, PRN 0 only in the
published set).

1023-chip (X1) and 10230-chip (X5) hex memory codes with CS100 overlay
on the pilot channels.  Behavioral contract: gnsstools/xona/x1p.py:9-31.
Reference quirk inherited as data: the upstream x5d_strings.py names its
dict x5p_strings; the extraction stored the bits under the x5d family.
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.models.codes import data, lfsr

X1_CHIP_RATE = 1023000
X1_CODE_LENGTH = 1023
X5_CHIP_RATE = 10230000
X5_CODE_LENGTH = 10230


def _memory_table(family: str, prns) -> np.ndarray:
    all_prns, bits = data.memory_bits(family)
    index = {p: i for i, p in enumerate(all_prns)}
    return lfsr.to_pm1(bits[[index[p] for p in prns]])


def x1p_table(prns):
    return _memory_table("xona_x1p", prns)


def x1d_table(prns):
    return _memory_table("xona_x1d", prns)


def x5p_table(prns):
    return _memory_table("xona_x5p", prns)


def x5d_table(prns):
    return _memory_table("xona_x5d", prns)


def x1p_secondary(prn: int) -> np.ndarray:
    return lfsr.to_pm1(data.table("xona_x1p_sec"))


def x5p_secondary(prn: int) -> np.ndarray:
    return lfsr.to_pm1(data.table("xona_x5p_sec"))


if __name__ == "__main__":
    # ICD self-check, the reference's standalone-module UX
    # (gps/ca.py:135-149): python -m gnss_dsp_tpu_torch.models.codes.xona
    from gnss_dsp_tpu_torch.models.codes import selftest

    raise SystemExit(selftest.run("xona"))
