# Frozen copy of gnss_dsp_tpu_torch/models/codes/beidou.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models; the self-test entry is left out.
"""BeiDou code tables: B1I/B2I, B1C, B2a, B2b, B3I.

B1I (also transmitted as B2I): 2046-chip Gold-like code, two 11-bit
registers seeded 01010101010; G2 output is the XOR of 2 or 3 per-PRN tap
positions (b1i.py:13-56).  NH20 secondary.

B1Cd/B1Cp: 10230-chip truncated Weil codes, N=10243 (b1cd.py:30-43);
pilot overlay is a 1800-chip truncated Weil of N=3607 (b1cp.py:75-93).
BOC(1,1) modulation on both.

B2ad/B2ap: 13-bit register pairs; G1 seeded all-ones and *restarted* at
chip 8189, G2 seeded from per-PRN ICD bit strings (b2ad.py:41-59).
Secondaries: CS5 (data), 100-chip truncated Weil N=1021 (pilot).

B2bi/B2bq: 10230-chip memory codes (base64 in the ICD; b2bi is also
derivable from the b2bd/b2bp generators below — the reference keeps both
as a cross-check, b2bd.py:1-24).

B3I: 13-bit pair; G1 all-ones with a state-triggered reload (state
1111111111100 -> all ones, b3i.py:41-45), G2 from per-PRN bit strings.
NH20 secondary.
"""

from __future__ import annotations

import numpy as np

from gnssbench.reference.models.codes import data, lfsr, weil

B1I_CHIP_RATE = 2046000
B1I_CODE_LENGTH = 2046
B1C_CHIP_RATE = 1023000
B1C_CODE_LENGTH = 10230
B2_CHIP_RATE = 10230000
B2_CODE_LENGTH = 10230
B3I_CHIP_RATE = 10230000
B3I_CODE_LENGTH = 10230

NH20 = np.array([0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0],
                np.uint8)
CS5 = np.array([0, 0, 0, 1, 0], np.uint8)

_B1C_N = 10243
_B1CP_SEC_N = 3607
_B2AP_SEC_N = 1021


# ---------------- B1I / B2I

def b1i_table(prns) -> np.ndarray:
    taps = data.pairs("bds_b1i_taps")
    seed = [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0]
    g1 = lfsr.lfsr_seq(11, (0, 6, 7, 8, 9, 10), seed, B1I_CODE_LENGTH,
                       out_taps=(10,))
    rows = []
    for p in prns:
        t = taps[p]
        t = (t,) if isinstance(t, int) else t
        g2 = lfsr.lfsr_seq(11, (0, 1, 2, 3, 4, 7, 8, 10), seed,
                           B1I_CODE_LENGTH,
                           out_taps=tuple(x - 1 for x in t))
        rows.append(g1 ^ g2)
    return lfsr.to_pm1(np.stack(rows))


def b1i_prns() -> tuple:
    return tuple(sorted(data.pairs("bds_b1i_taps")))


# ---------------- B1C

def b1cd_table(prns) -> np.ndarray:
    params = data.pairs("bds_b1cd_params")
    rows = [weil.weil_truncate(_B1C_N, *params[p], B1C_CODE_LENGTH)
            for p in prns]
    return lfsr.to_pm1(np.stack(rows))


def b1cp_table(prns) -> np.ndarray:
    params = data.pairs("bds_b1cp_params")
    rows = [weil.weil_truncate(_B1C_N, *params[p], B1C_CODE_LENGTH)
            for p in prns]
    return lfsr.to_pm1(np.stack(rows))


def b1cp_secondary(prn: int) -> np.ndarray:
    w, p = data.pairs("bds_b1cp_sec_params")[prn]
    return lfsr.to_pm1(weil.weil_truncate(_B1CP_SEC_N, w, p, 1800))


def b1c_prns() -> tuple:
    return tuple(sorted(data.pairs("bds_b1cd_params")))


# ---------------- B2a / B2b generator families (13-bit, G1 restart @8189)

_G1_TAPS = {
    "b2ad": (0, 4, 10, 12),
    "b2ap": (2, 5, 6, 12),
    "b2bd": (0, 8, 9, 12),
    "b2bp": (0, 10, 11, 12),
}
_G2_TAPS = {
    "b2ad": (2, 4, 8, 10, 11, 12),
    "b2ap": (0, 4, 6, 7, 11, 12),
    "b2bd": (2, 3, 5, 8, 11, 12),
    "b2bp": (1, 7, 8, 9, 10, 12),
}


def _restart_family(family: str, prns) -> np.ndarray:
    inits = data.init_bits(f"bds_{family}_init")
    all1 = (1 << 13) - 1
    g1 = lfsr.lfsr_seq_batch(13, _G1_TAPS[family], [all1], B2_CODE_LENGTH,
                             out_taps=(12,), reset_at=8189,
                             reset_state=all1)[0]
    g2 = lfsr.lfsr_seq_batch(
        13, _G2_TAPS[family],
        [lfsr.bits_to_int(inits[p]) for p in prns],
        B2_CODE_LENGTH, out_taps=(12,))
    return lfsr.to_pm1(g1[None, :] ^ g2)


def b2ad_table(prns):
    return _restart_family("b2ad", prns)


def b2ap_table(prns):
    return _restart_family("b2ap", prns)


def b2bd_table(prns):
    return _restart_family("b2bd", prns)


def b2bp_table(prns):
    return _restart_family("b2bp", prns)


def b2ap_secondary(prn: int) -> np.ndarray:
    w, p = data.pairs("bds_b2ap_sec_params")[prn]
    return lfsr.to_pm1(weil.weil_truncate(_B2AP_SEC_N, w, p, 100))


def b2a_prns() -> tuple:
    return tuple(int(p) for p in data.table("bds_b2ad_init_prns"))


# ---------------- B2b memory codes

def b2bi_table(prns) -> np.ndarray:
    all_prns, bits = data.memory_bits("bds_b2bi")
    index = {p: i for i, p in enumerate(all_prns)}
    return lfsr.to_pm1(bits[[index[p] for p in prns]])


def b2bq_table(prns) -> np.ndarray:
    all_prns, bits = data.memory_bits("bds_b2bq")
    index = {p: i for i, p in enumerate(all_prns)}
    return lfsr.to_pm1(bits[[index[p] for p in prns]])


def b2b_prns() -> tuple:
    return tuple(data.memory_bits("bds_b2bi")[0])


# ---------------- B3I

def b3i_table(prns) -> np.ndarray:
    inits = data.init_bits("bds_b3i_init")
    # G1: all-ones seed, reload on the ICD-specified state (b3i.py:41-45)
    trigger = lfsr.bits_to_int([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0])
    all1 = (1 << 13) - 1
    tapmask = sum(1 << t for t in (0, 2, 3, 12))
    x = all1
    g1 = np.empty(B3I_CODE_LENGTH, np.uint8)
    for i in range(B3I_CODE_LENGTH):
        g1[i] = (x >> 12) & 1
        if x == trigger:
            x = all1
        else:
            new = (x & tapmask).bit_count() & 1
            x = ((x << 1) | new) & all1
    g2 = lfsr.lfsr_seq_batch(
        13, (0, 4, 5, 6, 8, 9, 11, 12),
        [lfsr.bits_to_int(inits[p]) for p in prns],
        B3I_CODE_LENGTH, out_taps=(12,))
    return lfsr.to_pm1(g1[None, :] ^ g2)


def b3i_prns() -> tuple:
    return tuple(int(p) for p in data.table("bds_b3i_init_prns"))
