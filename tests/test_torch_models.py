"""The port's own host tier (gnss_dsp_tpu_torch.models, utils.synth,
utils.ranges, cli.cn0) against the JAX package's modules it was copied
from, bit for bit:

  * every catalog signal's descriptor fields are equal;
  * the code tables of every PRN of each signal (windows of the
    week-long GPS P code) and the secondary codes are identical;
  * synth_iq / to_int8_iq, the range parsers and cn0 give identical
    output on a seed.
"""

import dataclasses
import io
import sys

import numpy as np
import pytest

from gnss_dsp_tpu_torch.models.signal import all_signals, get_signal

NAMES = sorted(all_signals())


def _jax_signal(name):
    from gnss_dsp_tpu.models import get_signal as jget

    return jget(name)


def test_catalogs_list_the_same_signals():
    from gnss_dsp_tpu.models.signal import all_signals as jall

    assert NAMES == sorted(jall()) and len(NAMES) == 35


@pytest.mark.parametrize("name", NAMES)
def test_signal_descriptor_and_codes_match(name):
    sig, jsig = get_signal(name), _jax_signal(name)
    for f in dataclasses.fields(sig):
        a, b = getattr(sig, f.name), getattr(jsig, f.name)
        if not callable(b):
            assert a == b, f.name
    prns = sig.prns()
    assert prns == jsig.prns()
    if jsig.code_table is None:        # gps-p: week-long code, by windows
        from gnss_dsp_tpu.models.codes import gps_p as jgps_p
        from gnss_dsp_tpu_torch.models.codes import gps_p

        assert sig.code_table is None
        for prn, start in ((1, 0), (37, 123_456_789),
                           (2, gps_p.code_length - 5115)):
            np.testing.assert_array_equal(gps_p.window(prn, start, 10230),
                                          jgps_p.window(prn, start, 10230))
        return
    want = jsig.code_table(tuple(sig.prn_all))
    got = sig.code_table(tuple(sig.prn_all))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if jsig.secondary is not None:
        for p in sig.prn_all:
            np.testing.assert_array_equal(sig.secondary(p), jsig.secondary(p))
    for prop in ("code_period_ms", "sub_blocks"):
        assert getattr(sig, prop) == getattr(jsig, prop)
    assert sig.track_carrier_ratio(1) == jsig.track_carrier_ratio(1)


@pytest.mark.parametrize("subcarrier", ["none", "boc11", "cboc", "tmboc",
                                        "rz_even", "rz_odd"])
def test_synth_matches(subcarrier):
    from gnss_dsp_tpu.utils import synth as jsynth
    from gnss_dsp_tpu_torch.utils import synth

    code = get_signal("gps-l1").code_table((5,))[0].astype(np.float64)
    kw = dict(doppler_hz=1234.5, code_phase=17.25, carrier_phase=0.3,
              cn0_dbhz=45.0, subcarrier=subcarrier, carrier_ratio=1540.0,
              data_bits=np.array([1, -1, -1, 1]), t0=777)
    a = synth.synth_iq(code, 1.023e6, 4.096e6, 20_000,
                       rng=np.random.default_rng(3), **kw)
    b = jsynth.synth_iq(code, 1.023e6, 4.096e6, 20_000,
                        rng=np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(a, b)
    assert synth.to_int8_iq(a, scale=20.0) == jsynth.to_int8_iq(b, scale=20.0)


def test_ranges_match():
    from gnss_dsp_tpu.utils import ranges as jranges
    from gnss_dsp_tpu_torch.utils import ranges

    for s, sep in (("1,3,7-14", "-"), ("-7:7", ":"), ("4", "-")):
        assert ranges.parse_list_ranges(s, sep) == \
            jranges.parse_list_ranges(s, sep)
    assert ranges.parse_list_floats("1,2.5,-3") == \
        jranges.parse_list_floats("1,2.5,-3")


def test_cn0_matches(monkeypatch):
    import gnss_dsp_tpu.cli.cn0 as jcn0
    import gnss_dsp_tpu_torch.cli.cn0 as cn0

    rng = np.random.default_rng(9)
    rows = "".join(f"{i} {rng.normal(500, 20):.3f} {rng.normal(0, 30):.3f}\n"
                   for i in range(700))
    outs = []
    for mod in (cn0, jcn0):
        monkeypatch.setattr(sys, "stdin", io.StringIO(rows))
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stdout", buf)
        assert mod.main(["--time", "300"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].split()) == 2
    x = rng.normal(size=64) + 1j * rng.normal(size=64)
    assert cn0.cn0(x) == jcn0.cn0(x)
