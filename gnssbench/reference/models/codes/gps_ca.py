# Frozen copy of gnss_dsp_tpu_torch/models/codes/gps_ca.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models; the self-test entry is left out.
"""GPS L1 C/A (and SBAS/QZSS) Gold-code tables.

Construction per IS-GPS-200 §3.3.2.3: C/A(prn) = G1 XOR delay(G2, d_prn),
G1/G2 are 10-bit LFSRs (polys 1+x^3+x^10 and 1+x^2+x^3+x^6+x^8+x^9+x^10)
seeded all-ones.  Behavioral contract: gnsstools/gps/ca.py (chip_rate/
code_length :7-8, shift taps :70-74, delay table :13-68).
"""

from __future__ import annotations

import numpy as np

from gnssbench.reference.models.codes import lfsr

chip_rate = 1023000
code_length = 1023

# G2 delay (chips) per PRN 1..210 — IS-GPS-200 Tables 3-Ia/3-Ib (GPS,
# SBAS 120-158, QZSS 193-202, other GNSS test PRNs).  Index = PRN-1.
G2_DELAY = np.array([
      5,   6,   7,   8,  17,  18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 948, 950,
     67, 103,  91,  19, 679, 225, 625, 946, 638, 161,
   1001, 554, 280, 710, 709, 775, 864, 558, 220, 397,
     55, 898, 759, 367, 299, 1018,
    729, 695, 780, 801, 788, 732,  34, 320, 327, 389,
    407, 525, 405, 221, 761, 260, 326, 955, 653, 699,
    422, 188, 438, 959, 539, 879, 677, 586, 153, 792,
    814, 446, 264, 1015, 278, 536, 819, 156, 957, 159,
    712, 885, 461, 248, 713, 126, 807, 279, 122, 197,
    693, 632, 771, 467, 647, 203, 145, 175,  52,  21,
    237, 235, 886, 657, 634, 762, 355, 1012, 176, 603,
    130, 359, 595,  68, 386, 797, 456, 499, 883, 307,
    127, 211, 121, 118, 163, 628, 853, 484, 289, 811,
    202, 1021, 463, 568, 904, 670, 230, 911, 684, 309,
    644, 932,  12, 314, 891, 212, 185, 675, 503, 150,
    395, 345, 846, 798, 992, 357, 995, 877, 112, 144,
    476, 193, 109, 445, 291,  87, 399, 292, 901, 339,
    208, 711, 189, 263, 537, 663, 942, 173, 900,  30,
    500, 935, 556, 373,  85, 652, 310,
], dtype=np.int64)

PRNS = tuple(range(1, 211))

_g1 = None
_g2 = None
_codes: dict[int, np.ndarray] = {}


def _registers():
    global _g1, _g2
    if _g1 is None:
        # new bit = x[9]^x[2] (gps/ca.py:70-71); x[9]^x[8]^x[7]^x[5]^x[2]^x[1] (:73-74)
        _g1 = lfsr.lfsr_seq(10, (9, 2), [1] * 10, code_length)
        _g2 = lfsr.lfsr_seq(10, (9, 8, 7, 5, 2, 1), [1] * 10, code_length)
    return _g1, _g2


def ca_code(prn: int) -> np.ndarray:
    """C/A code for one PRN, int8 chips in {-1,+1} (chip 0 -> +1)."""
    if prn not in _codes:
        g1, g2 = _registers()
        d = int(G2_DELAY[prn - 1])
        g2d = np.roll(g2, d)
        _codes[prn] = lfsr.xor_pm1(g1, g2d)
    return _codes[prn]


def code_table(prns=PRNS) -> np.ndarray:
    """Stacked table [len(prns), 1023] int8 ±1."""
    return np.stack([ca_code(p) for p in prns])


def first_10_chips(prn: int) -> int:
    """ICD test-vector helper: first 10 chips packed MSB-first (compare to
    IS-GPS-200 Table 3-Ia 'First 10 Chips' octal column; cf. gps/ca.py:135-145)."""
    c = (1 - ca_code(prn)[:10]) // 2  # back to {0,1}
    r = 0
    for b in c:
        r = 2 * r + int(b)
    return r
