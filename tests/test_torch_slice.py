"""The GPS L1 main path through both packages' CLIs on one capture:
acquire -> track -> C/N0, the JAX package on the CPU (its XLA paths) and
the port with --device cpu (its plain versions).

Capture: noiseless int8 I/Q of three PRNs at 4.096 MHz, 70 ms.
  * acquisition rows: PRN, doppler and code offset exact, metric to
    rtol 1e-4 (float32 FFTs in another order);
  * 60 tracked blocks per channel as 14-column text rows: the integer
    fields (block, code_cyc, carrier_cyc, samp) exact, the float fields to
    rtol 2e-5 / atol 2e-4 (plus 1e-6 of %f printing);
  * the port's rows then go through gnss_dsp_tpu.cli.cn0; the estimate
    matches the one from the reference's rows to 0.05 dB.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

FS = 4.096e6
_TRUTH = ((3, 1230.0, 211.6), (9, -2480.0, 803.3), (22, 760.0, 17.9))
_ACQ_OPTS = ["--prn", "3,9,14,22", "--doppler-search", "-3000,3000,500",
             "--time", "8"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l1")
    n = int(FS * 0.070)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in _TRUTH:
        x += synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                      sig.chip_rate, FS, n, doppler_hz=dop, code_phase=cp,
                      cn0_dbhz=None, carrier_ratio=sig.carrier_ratio)
    path = tmp_path_factory.mktemp("slice") / "gps_l1.iq"
    path.write_bytes(to_int8_iq(x, scale=16.0))
    return str(path)


def _run(main, *args, stdin_text=None):
    out = io.StringIO()
    old = sys.stdin
    try:
        if stdin_text is not None:
            sys.stdin = io.StringIO(stdin_text)
        with contextlib.redirect_stdout(out):
            assert main(*args) == 0
    finally:
        sys.stdin = old
    return out.getvalue()


def _acq_rows(text):
    rows = {}
    for line in text.strip().splitlines():
        f = line.split()
        rows[int(f[1])] = (float(f[3]), float(f[5]), float(f[7]))
    return rows


@pytest.fixture(scope="module")
def acquired(capture):
    from gnss_dsp_tpu.cli import acquire as jcli
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    args = _ACQ_OPTS + [capture, str(FS), "0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
        want = _acq_rows(_run(jcli.main, "gps-l1", args))
    got_text = _run(tcli.main, "gps-l1", args + ["--device", "cpu"])
    return want, _acq_rows(got_text), got_text


def test_acquire_cli_rows_match(acquired):
    want, got, text = acquired
    assert sorted(got) == [3, 9, 14, 22]
    for prn, (dop, metric, code) in want.items():
        gdop, gmetric, gcode = got[prn]
        assert (gdop, gcode) == (dop, code), prn
        assert abs(gmetric - metric) <= 1e-4 * metric + 0.005, prn
    for prn, dop, cp in _TRUTH:
        assert abs(got[prn][0] - dop) <= 250.0
        assert min(abs(got[prn][2] - cp), 1023 - abs(got[prn][2] - cp)) <= 0.5
    assert got[14][1] < 0.5 * min(got[p][1] for p, _, _ in _TRUTH)
    assert text.splitlines()[0].startswith("prn   3 doppler")


def _track_rows(text):
    rows = {}
    for line in text.strip().splitlines():
        tag, rest = line.split(" ", 1)
        rows.setdefault(int(tag[2:]), []).append(rest)
    return rows


@pytest.fixture(scope="module")
def tracked(capture, acquired):
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu_torch.cli import track as tcli

    _, got, _ = acquired
    spec = ",".join(f"{p}:{got[p][0]}:{got[p][2]}" for p, _, _ in _TRUTH)
    args = ["--blocks", "60", capture, str(FS), "0", spec]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
        want = _track_rows(_run(jcli.main, "gps-l1", args))
    port = _track_rows(_run(tcli.main, "gps-l1", ["--device", "cpu"] + args))
    return want, port


def test_track_cli_rows_match(tracked):
    want, got = tracked
    assert sorted(got) == sorted(want) == [3, 9, 22]
    for prn in want:
        a = np.array([[float(v) for v in r.split()] for r in want[prn]])
        b = np.array([[float(v) for v in r.split()] for r in got[prn]])
        assert a.shape == b.shape == (60, 14)
        ints = [0, 9, 11, 13]           # block, code_cyc, carrier_cyc, samp
        np.testing.assert_array_equal(b[:, ints], a[:, ints])
        floats = [c for c in range(14) if c not in ints]
        np.testing.assert_allclose(b[:, floats], a[:, floats], rtol=2e-5,
                                   atol=2e-4 + 1e-6)


def test_port_rows_feed_cn0(tracked):
    import gnss_dsp_tpu.cli.cn0 as cn0

    want, got = tracked
    for prn in want:
        est_t = _run(cn0.main, ["--time", "50"],
                     stdin_text="\n".join(got[prn]) + "\n").split()
        est_j = _run(cn0.main, ["--time", "50"],
                     stdin_text="\n".join(want[prn]) + "\n").split()
        assert len(est_t) == len(est_j) == 1
        assert abs(float(est_t[0]) - float(est_j[0])) <= 0.05
