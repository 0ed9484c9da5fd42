"""The port's LFSR generator (gnss_dsp_tpu_torch/models/codes/lfsr.py:
a stepped prefix, then the register's recurrence at doubling strides)
against the JAX package's per-chip stepper, bit for bit, on every tap
set that models/codes runs through it:

  * seeded random initial states, R of 1, 3 and 64 rows;
  * n below, at and just past the stepped prefix, past its first
    doubling, and at 2046, 8191 and 10230 chips;
  * the register's own output taps and a drawn set of several;
  * a reset (the BeiDou B2a/B2b G1 restart) before, at and after the
    prefix, on the last chips and past the end;
  * `lfsr_seq` from an int seed and from a bit-list seed, and
    `lfsr_stages` against a run per output stage.
"""

import zlib

import numpy as np
import pytest

from gnss_dsp_tpu_torch.models.codes import beidou, data, galileo, gps_l1c
from gnss_dsp_tpu_torch.models.codes import gps_l5, lfsr


def _overlay_taps(poly):
    """gps_l1c._overlay_lfsr's tap positions of an overlay polynomial."""
    return tuple(i for i in range(11) if (poly // 2 >> i) & 1)


def _registers():
    """{case: [(nbits, taps, out_taps), ...]}: every register models/codes
    builds with lfsr_seq, lfsr_seq_batch or lfsr_stages."""
    regs = {
        "gps_ca": [(10, (9, 2), (9,)), (10, (9, 8, 7, 5, 2, 1), (9,))],
        "gps_p": [(12, (11, 10, 7, 5), (11,)),
                  (12, (11, 10, 9, 8, 7, 4, 1, 0), (11,)),
                  (12, (11, 10, 9, 8, 7, 6, 4, 3, 2, 0), (11,)),
                  (12, (11, 8, 7, 3, 2, 1), (11,))],
        "gps_l5_xb": [(13, gps_l5._XB_I_TAPS, (12,))],
        "glonass_ca": [(9, (8, 4), (6,))],
        "glonass_p": [(25, (24, 2), (9,))],
        "glonass_l3": [(14, (13, 12, 7, 3), (13,)), (7, (6, 5), (6,))],
        "beidou_b1i": [(11, (0, 6, 7, 8, 9, 10), (10,)),
                       (11, (0, 1, 2, 3, 4, 7, 8, 10), (0, 4)),
                       (11, (0, 1, 2, 3, 4, 7, 8, 10), (0, 2, 7))],
        "beidou_b3i": [(13, (0, 4, 5, 6, 8, 9, 11, 12), (12,))],
    }
    for fam, (t1, t2) in galileo._E5_TAPS.items():
        regs[f"galileo_{fam}"] = [(14, t1, (13,)), (14, t2, (13,))]
    for fam in beidou._G1_TAPS:
        regs[f"beidou_{fam}"] = [(13, beidou._G1_TAPS[fam], (12,)),
                                 (13, beidou._G2_TAPS[fam], (12,))]
    polys = {v[0] for v in data.pairs("gps_l1cp_sec_params").values()}
    regs["gps_l1c_overlay"] = [(11, _overlay_taps(p), (10,))
                               for p in sorted(polys | {gps_l1c._SEC_POLY2})]
    return regs


REGISTERS = _registers()


def _lengths(nbits, many):
    """(n, R) pairs: the prefix's edges, then the long runs (only the
    overlays' own length where a case holds many registers)."""
    edges = [(n, (1, 3, 64)[k % 3]) for k, n in
             enumerate((1, nbits - 1, nbits, nbits + 1, 2 * nbits + 1))]
    if many:
        return edges + [(1800, 3)]
    return edges + [(2046, 3), (8191, 1), (10230, 64)]


@pytest.mark.parametrize("case", sorted(REGISTERS))
def test_lfsr_matches_the_stepper(case):
    from gnss_dsp_tpu.models.codes import lfsr as ref

    regs = REGISTERS[case]
    many = len(regs) > 4
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    for i, (nbits, taps, out_taps) in enumerate(regs):
        full = (1 << nbits) - 1
        drawn = tuple(sorted(rng.choice(nbits, size=3, replace=False)))
        for k, (n, r) in enumerate(_lengths(nbits, many)):
            inits = rng.integers(1, full + 1, size=r)
            ot = (out_taps, drawn)[k % 2]
            np.testing.assert_array_equal(
                lfsr.lfsr_seq_batch(nbits, taps, inits, n, out_taps=ot),
                ref.lfsr_seq_batch(nbits, taps, inits, n, out_taps=ot),
                err_msg=f"{taps} n={n} R={r} out={ot}")
        if many and i:
            continue
        n = 2046
        inits = rng.integers(1, full + 1, size=3)
        for at in (nbits - 2, nbits - 1, nbits, 2 * nbits + 3, n - 2, n - 1,
                   n + 5):
            kw = dict(out_taps=out_taps, reset_at=at, reset_state=full)
            np.testing.assert_array_equal(
                lfsr.lfsr_seq_batch(nbits, taps, inits, n, **kw),
                ref.lfsr_seq_batch(nbits, taps, inits, n, **kw),
                err_msg=f"{taps} reset_at={at}")
        seed = int(rng.integers(1, full + 1))
        bits = lfsr.int_to_bits(seed, nbits)
        want = ref.lfsr_seq(nbits, taps, bits, n, out_taps=out_taps)
        for init in (seed, bits):
            np.testing.assert_array_equal(
                lfsr.lfsr_seq(nbits, taps, init, n, out_taps=out_taps), want)
        m = 3 * nbits + 7
        stages = lfsr.lfsr_stages(nbits, taps, seed, m)
        assert stages.shape == (nbits, m)
        for j in range(nbits):
            np.testing.assert_array_equal(
                stages[j], ref.lfsr_seq(nbits, taps, bits, m, out_taps=(j,)))
