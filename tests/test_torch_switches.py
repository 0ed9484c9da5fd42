"""The reference's environment switches: each entry point that a
switch would move and that the port does not follow refuses to run
while it is set, naming the switch, instead of running the route the
caller asked to leave (gnss_dsp_tpu_torch/device.refuse_switches).

  GNSS_DSP_NO_PALLAS    the reference's acquisition and tracking take its
                        XLA engine (acquire/engine.py:307,
                        acquire/coherent.py:356, track/driver.py:112)
  GNSS_DSP_NO_V2P       its pad2 signals take the v1 route at the
                        unpadded 2n window (acquire/engine.py:318)
  GNSS_DSP_UPLOAD_INT4  its track_file quantises each chunk to 4 bits
                        (track/driver.py:623-627); the port's track_file
                        now does the same, so that case is a parity test:
                        the rows equal the JAX package's under the switch

An empty value is unset, as the reference reads them.  All on the CPU.
"""

import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
from gnss_dsp_tpu_torch.acquire.engine import (
    acquire_signal, acquire_signal_fdma)
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file

ALL = ("GNSS_DSP_NO_PALLAS", "GNSS_DSP_NO_V2P", "GNSS_DSP_UPLOAD_INT4")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ALL:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _acquire(name="gps-l5i"):
    sig = get_signal(name)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    x = torch.zeros(n * 8, dtype=torch.complex64)
    return acquire_signal(sig, x, [1], (-500.0, 500.0, 500.0), ms=3)


def _acquire_fdma():
    sig = get_signal("glonass-l1")
    x = torch.zeros(16384 * 4, dtype=torch.complex64)
    return acquire_signal_fdma(sig, x, [-1, 0], (-500.0, 500.0, 500.0),
                               ms=2)


def _acquire_coherent(name="gps-l1"):
    sig = get_signal(name)
    x = torch.zeros(4096 * 12, dtype=torch.complex64)
    return acquire_signal_coherent(sig, x, [1], (-250.0, 250.0, 250.0),
                                   m_coh=2, ms=4, engine="xla")


def _capture():
    from gnss_dsp_tpu_torch.utils import synth

    sig = get_signal("gps-l1")
    x = synth.synth_iq(sig.code_table((3,))[0], sig.chip_rate, 4.096e6,
                       40_000, doppler_hz=1000.0, code_phase=10.0,
                       cn0_dbhz=None, carrier_ratio=1540.0)
    return synth.to_int8_iq(x, scale=24.0)


def _track():
    ch = [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0)]
    track_file(get_signal("gps-l1"), io.BytesIO(_capture()), 4.096e6, 0.0,
               ch, max_blocks=6, device="cpu")
    return ch[0].rows


# switches an entry point follows, as the reference does
HONOURED = {("track_file", "GNSS_DSP_UPLOAD_INT4")}


def _jax_track():
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu.track.driver import TrackChannel as JChannel
    from gnss_dsp_tpu.track.driver import track_file as jtrack

    ch = [JChannel(prn=3, doppler=1000.0, code_offset=10.0)]
    jtrack(jsig("gps-l1"), io.BytesIO(_capture()), 4.096e6, 0.0, ch,
           max_blocks=6)
    return ch[0].rows


ENTRIES = {"acquire_signal": _acquire,
           "acquire_signal_fdma": _acquire_fdma,
           "acquire_signal_coherent": _acquire_coherent,
           "track_file": _track}
CASES = [("acquire_signal", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal", "GNSS_DSP_NO_V2P"),
         ("acquire_signal_fdma", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal_coherent", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal_coherent", "GNSS_DSP_NO_V2P"),
         ("track_file", "GNSS_DSP_NO_PALLAS"),
         ("track_file", "GNSS_DSP_NO_V2P"),
         ("track_file", "GNSS_DSP_UPLOAD_INT4")]


@pytest.mark.parametrize("entry,switch", CASES)
def test_entry_point_refuses_a_set_switch(clean_env, entry, switch):
    """A switch the port does not follow is refused; one it follows
    (HONOURED) gives the JAX package's rows under the same switch:
    integers equal, floats rtol 2e-5 / atol 2e-4, and not the rows of
    the int8 route."""
    clean_env.setenv(switch, "1")
    if (entry, switch) in HONOURED:
        got, want = ENTRIES[entry](), _jax_track()
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert [a[k] for k in ("block", "samp", "code_cyc")] == \
                [b[k] for k in ("block", "samp", "code_cyc")]
            for k in ("p_re", "p_im", "carrier_f", "prompt", "code_p"):
                np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4)
        clean_env.delenv(switch)
        assert [r["p_re"] for r in ENTRIES[entry]()] != \
            [r["p_re"] for r in got]
        return
    with pytest.raises(NotImplementedError, match=switch):
        ENTRIES[entry]()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_runs_with_the_switches_empty(clean_env, entry):
    """An empty value is unset (os.environ.get is falsy), and an entry
    point does not read a switch outside its list: acquisition runs with
    GNSS_DSP_UPLOAD_INT4 set, and track_file with it empty gives the
    int8 route's rows."""
    if entry == "track_file":
        unset = ENTRIES[entry]()
    for name in ALL:
        clean_env.setenv(name, "")
    if entry != "track_file":
        clean_env.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    got = ENTRIES[entry]()
    assert got
    if entry == "track_file":
        assert got == unset
