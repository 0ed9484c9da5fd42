"""GNSS_DSP_TIMING outside the receiver: the acquire CLI's "[timing] SIG:
read+upload .. frontend .." and "search .." lines and track_file's
"[track_file timing] read-wait .. upload+convert .. scan+rows .." line,
held against the JAX package's CLIs on the same seeded capture (the JAX
package on the CPU, the port with --device cpu, the plain versions).

The walls differ from run to run, so each stderr line is compared with
its numbers masked: the same lines, in the same order, under the same
labels.  Stdout is byte-equal with the switch set and unset; the
preloaded chunk of the workload runner prints no timing line, as in the
reference.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from gnss_dsp_tpu.cli import acquire as jacq
from gnss_dsp_tpu.cli import track as jtrk
from gnss_dsp_tpu_torch.cli import acquire as tacq
from gnss_dsp_tpu_torch.cli import track as ttrk
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

FS = 4.096e6
PLANTS = ((3, 1000.0, 211.6), (9, -500.0, 803.3))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def env(monkeypatch):
    for name in ("GNSS_DSP_TIMING", "GNSS_DSP_CPU", "GNSS_DSP_NO_PALLAS",
                 "GNSS_DSP_NO_V2P", "GNSS_DSP_UPLOAD_INT4",
                 "GNSS_DSP_NO_FUSED", "GNSS_DSP_PALLAS_V1"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
    return monkeypatch


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """40 ms of GPS L1 at 4.096 MHz, two PRNs at 45 dB-Hz, int8 I/Q."""
    sig = get_signal("gps-l1")
    n = int(FS * 0.040)
    rng = np.random.default_rng(16)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in PLANTS:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, FS, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=45.0,
                      carrier_ratio=sig.carrier_ratio, rng=rng)
    path = tmp_path_factory.mktemp("timing") / "gps_l1.iq"
    path.write_bytes(to_int8_iq(x, scale=16.0))
    return str(path)


def _run(main, *args, **kw):
    """(stdout, stderr) of main(*args) in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(*args, **kw) in (0, None)
    return out.getvalue(), err.getvalue()


def masked(text):
    """The stderr lines with every number masked."""
    return [re.sub(r"\d+\.\d+", "#", line) for line in text.splitlines()]


ACQ = ["--prn", "3,9", "--doppler-search", "-1500,1500,500", "--time", "8"]
COH = ["--prn", "3,9", "--doppler-search", "-1500,1500,250", "--time", "8",
       "--coherent", "4"]
CASES = {
    "acquire": (jacq.main, tacq.main, "gps-l1", ACQ,
                ["[timing] gps-l1: read+upload #s frontend #s",
                 "[timing] gps-l1: search #s"]),
    "acquire --coherent": (jacq.main, tacq.main, "gps-l1", COH,
                           ["[timing] gps-l1: read+upload #s frontend #s"]),
    "track": (jtrk.main, ttrk.main, "gps-l1",
              ["--blocks", "12", "{path}", str(FS), "0",
               "3:1000.0:211.6,9:-500.0:803.3"],
              ["[track_file timing] read-wait # s  upload+convert # s  "
               "scan+rows # s"]),
    "track multi": (jtrk.main, ttrk.main, "multi",
                    ["--blocks", "12", "{path}", str(FS), "0",
                     "gps-l1:3:1000.0:211.6,gps-l1:9:-500.0:803.3"],
                    ["[track_file timing] read-wait # s  upload+convert # s  "
                     "scan+rows # s"]),
}


def _argv(argv, path):
    out = [a.format(path=path) for a in argv]
    return out + ([path, str(FS), "0"] if "{path}" not in argv else [])


@pytest.mark.parametrize("case", sorted(CASES))
def test_timing_lines_match_jax_cli(env, capture, case):
    """Under GNSS_DSP_TIMING the port's CLI prints the JAX CLI's stderr
    lines (numbers masked), in its order and branches, and its stdout is
    byte-equal to its own run with the switch unset."""
    jmain, tmain, signal, argv, want = CASES[case]
    argv = _argv(argv, capture)
    unset, err0 = _run(tmain, signal, argv + ["--device", "cpu"])
    assert "timing" not in err0
    env.setenv("GNSS_DSP_TIMING", "1")
    got, err = _run(tmain, signal, argv + ["--device", "cpu"])
    assert got == unset and got
    assert masked(err) == want, err
    _jout, jerr = _run(jmain, signal, list(argv))
    assert masked(jerr) == want, jerr


def test_timing_has_no_line_on_the_preloaded_chunk(env, capture):
    """The workload runner's preloaded chunk (track_file's single-chunk
    mode) prints no timing line, as the reference's; its rows are the
    streaming run's."""
    env.setenv("GNSS_DSP_TIMING", "1")
    argv = ["--blocks", "12", capture, str(FS), "0", "3:1000.0:211.6",
            "--device", "cpu"]
    streamed, err = _run(ttrk.main, "gps-l1", list(argv))
    assert "[track_file timing]" in err
    cache = {}
    preloaded, err = _run(ttrk.main, "gps-l1", list(argv), x_cache=cache)
    assert cache and preloaded == streamed
    assert "timing" not in err


def test_timing_on_fdma_and_mesh_branches(env, tmp_path):
    """The read+upload line prints before the branches (FDMA, mesh); the
    search line only after the default CDMA search, as in the
    reference's CLI."""
    sig = get_signal("glonass-l1")
    fs = sig.acq_fs
    n = int(fs * 0.008)
    x = synth_iq(sig.code_table((0,))[0], sig.chip_rate, fs, n,
                 doppler_hz=300.0 + sig.fdma_hz, code_phase=100.0,
                 cn0_dbhz=None, carrier_ratio=sig.track_carrier_ratio(1),
                 code_doppler_hz=300.0)
    path = tmp_path / "glo.iq"
    path.write_bytes(to_int8_iq(x, scale=16.0))
    env.setenv("GNSS_DSP_TIMING", "1")
    head = ["[timing] glonass-l1: read+upload #s frontend #s"]
    for extra in ([], ["--mesh", "2"]):
        argv = extra + ["--channel", "0,1", "--doppler-search",
                        "-500,501,250", "--time", "2", str(path), str(fs),
                        "0", "--device", "cpu"]
        out, err = _run(tacq.main, "glonass-l1", argv)
        assert masked(err) == head and out.count("\n") == 2, (extra, err)
