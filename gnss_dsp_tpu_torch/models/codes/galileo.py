"""Galileo code tables: E1 (memory), E5a/E5b (LFSR pairs), E6 (memory).

E1-B/E1-C: 4092-chip memory codes from the OS SIS ICD (hex strings; the
bit planes live in data/icd_tables.npz).  Modulated CBOC(6,1,1/11) with
weights sqrt(10/11)/sqrt(1/11) (e1b.py:52-55); E1-C carries the CS25
secondary.

E5a/E5b I/Q: 10230-chip codes, XOR of a fixed all-ones-seeded 14-bit
register and a per-PRN-seeded one, both sampled at x[13]
(e5ai.py:50-83).  Secondaries: CS20 (aI), CS100 per PRN (aQ), CS4 (bI),
CS100 (bQ).

E6-B/E6-C: 5115-chip memory codes (base64 in the ICD; e6b.py:12-32);
E6-C carries CS100 per PRN.
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.models.codes import data, lfsr

E1_CHIP_RATE = 1023000
E1_CODE_LENGTH = 4092
E5_CHIP_RATE = 10230000
E5_CODE_LENGTH = 10230
E6_CHIP_RATE = 5115000
E6_CODE_LENGTH = 5115

# CBOC(6,1,1/11) amplitude weights (e1b.py:52): sqrt(10/11), sqrt(1/11)
CBOC_W1 = 0.9534625892455922
CBOC_W6 = 0.3015113445777636

# (reg1 taps, reg2 taps) per family; positions in the pre-shift state,
# new bit at x[0], output x[13]
_E5_TAPS = {
    "e5ai": ((13, 7, 5, 0), (13, 11, 7, 6, 4, 3)),
    "e5aq": ((13, 7, 5, 0), (13, 11, 7, 6, 4, 3)),
    "e5bi": ((13, 12, 10, 3), (13, 11, 8, 7, 4, 1)),
    "e5bq": ((13, 12, 10, 3), (13, 9, 8, 5, 4, 0)),
}


def _memory_table(family: str, prns) -> np.ndarray:
    all_prns, bits = data.memory_bits(family)
    index = {p: i for i, p in enumerate(all_prns)}
    return lfsr.to_pm1(bits[[index[p] for p in prns]])


def e1b_table(prns):
    return _memory_table("gal_e1b", prns)


def e1c_table(prns):
    return _memory_table("gal_e1c", prns)


def e6b_table(prns):
    return _memory_table("gal_e6b", prns)


def e6c_table(prns):
    return _memory_table("gal_e6c", prns)


def memory_prns(family: str) -> tuple:
    return tuple(data.memory_bits(family)[0])


def _e5_table(family: str, prns) -> np.ndarray:
    t1, t2 = _E5_TAPS[family]
    r1 = lfsr.lfsr_seq(14, t1, [1] * 14, E5_CODE_LENGTH, out_taps=(13,))
    inits = data.pairs(f"gal_{family}_init")
    r2 = lfsr.lfsr_seq_batch(14, t2, [inits[p] for p in prns],
                             E5_CODE_LENGTH, out_taps=(13,))
    return lfsr.to_pm1(r1[None, :] ^ r2)


def e5ai_table(prns):
    return _e5_table("e5ai", prns)


def e5aq_table(prns):
    return _e5_table("e5aq", prns)


def e5bi_table(prns):
    return _e5_table("e5bi", prns)


def e5bq_table(prns):
    return _e5_table("e5bq", prns)


def e5_prns() -> tuple:
    return tuple(sorted(data.pairs("gal_e5ai_init")))


# ---------------- secondaries (+-1 int8)

def e1c_secondary(prn: int) -> np.ndarray:
    return lfsr.to_pm1(data.table("gal_e1c_sec"))


def e5ai_secondary(prn: int) -> np.ndarray:
    return lfsr.to_pm1(data.table("gal_e5ai_sec"))


def e5bi_secondary(prn: int) -> np.ndarray:
    return lfsr.to_pm1(data.table("gal_e5bi_sec"))


def _per_prn_secondary(name: str, prn: int) -> np.ndarray:
    prns = data.table(name + "_prns")
    bits = data.table(name)
    i = int(np.searchsorted(prns, prn))
    assert prns[i] == prn, (name, prn)
    return lfsr.to_pm1(bits[i])


def e5aq_secondary(prn: int) -> np.ndarray:
    return _per_prn_secondary("gal_e5aq_sec", prn)


def e5bq_secondary(prn: int) -> np.ndarray:
    return _per_prn_secondary("gal_e5bq_sec", prn)


def e6c_secondary(prn: int) -> np.ndarray:
    return _per_prn_secondary("gal_e6c_sec", prn)


if __name__ == "__main__":
    # ICD self-check, the reference's standalone-module UX
    # (gps/ca.py:135-149): python -m gnss_dsp_tpu_torch.models.codes.galileo
    from gnss_dsp_tpu_torch.models.codes import selftest

    raise SystemExit(selftest.run("galileo"))
