"""GPS L2C (L2CM / L2CL) code tables.

Construction per IS-GPS-200 §3.2.1.4/.5: a 27-stage Galois LFSR
x -> (x>>1) ^ lsb(x)*0o445112474 seeded from per-PRN ICD initial states,
run 10230 (CM) or 767250 (CL) chips.  Behavioral contract:
gnsstools/gps/l2cm.py:46-56 / l2cl.py (same generator, longer period).

The chips are time-multiplexed on L2 at 1.023 MHz total: CM occupies even
half-chips, CL odd (the reference realizes this as RZ gating inside
correlate, l2cm.py:73,81-91); the engines apply the same gating via the
signal descriptor's subcarrier field ("rz_even"/"rz_odd").
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.models.codes import data, lfsr

chip_rate = 511500
cm_code_length = 10230
cl_code_length = 767250
POLY = 0o445112474

_cm_cache: dict[int, np.ndarray] = {}
_cl_cache: dict[int, np.ndarray] = {}


def prns_all() -> tuple:
    return tuple(sorted(data.pairs("gps_l2cm_init")))


def _build(init_table: str, length: int, cache: dict, prns) -> np.ndarray:
    inits = data.pairs(init_table)
    missing = [p for p in prns if p not in cache]
    if missing:
        out = lfsr.galois_seq_batch(27, POLY, [inits[p] for p in missing], length)
        for p, row in zip(missing, out):
            cache[p] = row
    return np.stack([cache[p] for p in prns])


def cm_bits(prns) -> np.ndarray:
    return _build("gps_l2cm_init", cm_code_length, _cm_cache, prns)


def cl_bits(prns) -> np.ndarray:
    return _build("gps_l2cl_init", cl_code_length, _cl_cache, prns)


def cm_table(prns) -> np.ndarray:
    return lfsr.to_pm1(cm_bits(prns))


def cl_table(prns) -> np.ndarray:
    return lfsr.to_pm1(cl_bits(prns))


def end_state(prn: int, cl: bool = False) -> int:
    """Register state after code_length-1 shifts (ICD end-state vectors,
    l2cm.py:95-133)."""
    inits = data.pairs("gps_l2cl_init" if cl else "gps_l2cm_init")
    n = (cl_code_length if cl else cm_code_length) - 1
    x = inits[prn]
    for _ in range(n):
        x = (x >> 1) ^ (x & 1) * POLY
    return x


if __name__ == "__main__":
    # ICD self-check, the reference's standalone-module UX
    # (gps/ca.py:135-149): python -m gnss_dsp_tpu_torch.models.codes.gps_l2c
    from gnss_dsp_tpu_torch.models.codes import selftest

    raise SystemExit(selftest.run("gps_l2c"))
