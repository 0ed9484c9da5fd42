# Frozen copy of gnss_dsp_tpu_torch/models/codes/glonass.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models; the self-test entry is left out.
"""GLONASS code tables: L1/L2 C/A, P, L3OC.

C/A: one 511-chip m-sequence shared by all satellites (FDMA, no PRN) —
9-bit register, new bit x[8]^x[4], output tapped at x[6] (glonass/ca.py:
10-22).

P: 25-bit m-sequence truncated to 5.11e6 chips (1 s), output x[9]
(glonass/p.py:10-20).  Built once on first use (~5 s pure-python; the
result is memoized packed).

L3OCd/L3OCp: 10230 chips, XOR of a 14-bit register (fixed seed) and a
7-bit register seeded with the channel number n (data) or n+64 (pilot),
MSB-first (l3ocd.py:13-33).  CS5 / NH10 secondaries.
"""

from __future__ import annotations

import numpy as np

from gnssbench.reference.models.codes import lfsr

CA_CHIP_RATE = 511000
CA_CODE_LENGTH = 511
P_CHIP_RATE = 5110000
P_CODE_LENGTH = 5110000
L3_CHIP_RATE = 10230000
L3_CODE_LENGTH = 10230

CS5 = np.array([0, 0, 0, 1, 0], np.uint8)
NH10 = np.array([0, 0, 0, 0, 1, 1, 0, 1, 0, 1], np.uint8)

_ca_bits = None
_p_bits = None


def ca_bits() -> np.ndarray:
    global _ca_bits
    if _ca_bits is None:
        _ca_bits = lfsr.lfsr_seq(9, (8, 4), [1] * 9, CA_CODE_LENGTH,
                                 out_taps=(6,))
    return _ca_bits


def ca_table(prns=None) -> np.ndarray:
    """Same sequence for every channel; rows replicated to match the
    uniform code_table contract."""
    n = len(prns) if prns is not None else 1
    return np.repeat(lfsr.to_pm1(ca_bits())[None, :], n, axis=0)


def p_bits() -> np.ndarray:
    global _p_bits
    if _p_bits is None:
        _p_bits = lfsr.lfsr_seq(25, (24, 2), [1] * 25, P_CODE_LENGTH,
                                out_taps=(9,))
    return _p_bits


def p_table(prns=None) -> np.ndarray:
    n = len(prns) if prns is not None else 1
    return np.repeat(lfsr.to_pm1(p_bits())[None, :], n, axis=0)


def _l3_bits(chans, seed_offset: int) -> np.ndarray:
    g2 = lfsr.lfsr_seq(14, (13, 12, 7, 3),
                       [0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0],
                       L3_CODE_LENGTH, out_taps=(13,))
    # 7-bit register seeded with the channel number, MSB at x[0]
    # (l3ocd.py:19-23), new bit x[6]^x[5], output x[6]
    inits = [
        lfsr.bits_to_int([((c + seed_offset) >> (6 - i)) & 1 for i in range(7)])
        for c in chans
    ]
    g_ch = lfsr.lfsr_seq_batch(7, (6, 5), inits, L3_CODE_LENGTH,
                               out_taps=(6,))
    return g2[None, :] ^ g_ch


def l3ocd_table(chans) -> np.ndarray:
    return lfsr.to_pm1(_l3_bits(chans, 0))


def l3ocp_table(chans) -> np.ndarray:
    return lfsr.to_pm1(_l3_bits(chans, 64))
