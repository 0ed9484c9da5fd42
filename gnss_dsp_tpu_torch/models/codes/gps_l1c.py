"""GPS L1C (L1Cp pilot / L1Cd data) code tables.

Construction per IS-GPS-800: 10230-chip codes built from a length-10223
Weil sequence with a 7-chip expansion 0110100 spliced in at the per-PRN
insertion point.  The pilot carries an 1800-chip overlay (secondary) code
from one 11-bit LFSR (PRN < 64) or the XOR of two (PRN >= 64, second
polynomial 0o5001).  Behavioral contract: gnsstools/gps/l1cp.py:67-84
(primary), :150-199 (overlay); l1cd.py:72-77.

Modulation: L1Cp is TMBOC(6,1,4/33) — BOC(6,1) in 4 of each 33 chips
(pattern positions 0,4,6,29; l1cp.py:202), L1Cd is BOC(1,1).
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.models.codes import data, lfsr, weil

chip_rate = 1023000
code_length = 10230
N = 10223
EXPANSION = (0, 1, 1, 0, 1, 0, 0)
SEC_LEN = 1800
_SEC_POLY2 = 0o5001

# TMBOC slot pattern over 33 chips: 1 = BOC(6,1) slot (l1cp.py:202)
TMBOC_PATTERN = np.zeros(33, np.int8)
TMBOC_PATTERN[[0, 4, 6, 29]] = 1


def prns_all() -> tuple:
    return tuple(sorted(data.pairs("gps_l1cp_params")))


def _primary(table: str, prns) -> np.ndarray:
    params = data.pairs(table)
    rows = []
    for p in prns:
        w, ins = params[p]
        rows.append(weil.weil_insert(N, w, ins, EXPANSION, code_length))
    return np.stack(rows)


def l1cp_table(prns) -> np.ndarray:
    return lfsr.to_pm1(_primary("gps_l1cp_params", prns))


def l1cd_table(prns) -> np.ndarray:
    return lfsr.to_pm1(_primary("gps_l1cd_params", prns))


def _overlay_lfsr(poly: int, init: int, n: int) -> np.ndarray:
    """11-bit overlay register (l1cp.py:161-175): taps from poly//2 bits,
    new bit = parity(state & taps) prepended, output x[10]."""
    tapbits = [(poly // 2 >> i) & 1 for i in range(11)]
    taps = [i for i, b in enumerate(tapbits) if b]
    return lfsr.lfsr_seq(11, taps, init, n, out_taps=(10,))


def secondary_bits(prn: int) -> np.ndarray:
    params = data.pairs("gps_l1cp_sec_params")[prn]
    if len(params) == 2:
        poly, init = params
        return _overlay_lfsr(poly, init, SEC_LEN)
    poly1, init1, init2 = params
    a = _overlay_lfsr(poly1, init1, SEC_LEN)
    b = _overlay_lfsr(_SEC_POLY2, init2, SEC_LEN)
    return a ^ b


def secondary_table(prn: int) -> np.ndarray:
    return lfsr.to_pm1(secondary_bits(prn))


if __name__ == "__main__":
    # ICD self-check, the reference's standalone-module UX
    # (gps/ca.py:135-149): python -m gnss_dsp_tpu_torch.models.codes.gps_l1c
    from gnss_dsp_tpu_torch.models.codes import selftest

    raise SystemExit(selftest.run("gps_l1c"))
