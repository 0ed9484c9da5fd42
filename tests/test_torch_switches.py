"""The reference's environment switches that the port does not honour
yet: each entry point that a switch would move refuses to run while it
is set, naming the switch, instead of running the route the caller asked
to leave (gnss_dsp_tpu_torch/device.refuse_switches).

  GNSS_DSP_NO_PALLAS    the reference's acquisition and tracking take its
                        XLA engine (acquire/engine.py:307,
                        acquire/coherent.py:356, track/driver.py:112)
  GNSS_DSP_NO_V2P       its pad2 signals take the v1 route at the
                        unpadded 2n window (acquire/engine.py:318)
  GNSS_DSP_UPLOAD_INT4  its track_file quantises each chunk to 4 bits
                        (track/driver.py:623-627)

An empty value is unset, as the reference reads them.  All on the CPU.
"""

import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
from gnss_dsp_tpu_torch.acquire.engine import acquire_signal
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


def _acquire_coherent(name="gps-l1"):
    sig = get_signal(name)
    x = torch.zeros(4096 * 12, dtype=torch.complex64)
    return acquire_signal_coherent(sig, x, [1], (-250.0, 250.0, 250.0),
                                   m_coh=2, ms=4, engine="xla")


def _track():
    raw = np.zeros(2 * 20_000, np.int8).tobytes()
    return track_file(get_signal("gps-l1"), io.BytesIO(raw), 4.096e6, 0.0,
                      [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0)],
                      max_blocks=2, device="cpu")


ENTRIES = {"acquire_signal": _acquire,
           "acquire_signal_coherent": _acquire_coherent,
           "track_file": _track}
CASES = [("acquire_signal", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal", "GNSS_DSP_NO_V2P"),
         ("acquire_signal_coherent", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal_coherent", "GNSS_DSP_NO_V2P"),
         ("track_file", "GNSS_DSP_NO_PALLAS"),
         ("track_file", "GNSS_DSP_NO_V2P"),
         ("track_file", "GNSS_DSP_UPLOAD_INT4")]


@pytest.mark.parametrize("entry,switch", CASES)
def test_entry_point_refuses_a_set_switch(clean_env, entry, switch):
    clean_env.setenv(switch, "1")
    with pytest.raises(NotImplementedError, match=switch):
        ENTRIES[entry]()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_runs_with_the_switches_empty(clean_env, entry):
    """An empty value is unset (os.environ.get is falsy), and an entry
    point does not read a switch outside its list: acquisition runs with
    GNSS_DSP_UPLOAD_INT4 set."""
    for name in ALL:
        clean_env.setenv(name, "")
    if entry != "track_file":
        clean_env.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    assert ENTRIES[entry]()
