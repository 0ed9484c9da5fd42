"""The acquire CLI (gnss_dsp_tpu_torch.cli.acquire.main, its CPU plain
versions) against the benchmark's float64 reference of the acquire-all.sh
searches (gnssbench/reference/acquire_all.py), at small sizes: one search
of each kind the deployment runs, every row judged.

  * GPS L1: circular at n, peak over mean;
  * BeiDou B1I: circular-2n at 16384;
  * Galileo E1B: the sliding 2n windows with the BOC(1,1) template at
    65536;
  * GPS L2CM: circular-2n at 163840 (K1's run-time core on the card);
  * GPS L5I and GLONASS L3OCd: the v2p route, the n linear lags of the
    61380 windows padded to 65536;
  * GLONASS L1: the FDMA band search over 2 channels.

The planted satellite is found at its doppler and code offset, and
every row's reported metric lies within METRIC_TOL of the reference's
metric at the reported cell, that cell tying with the row's best.  The
rows of the sky2017-acq configuration carry the lags that
acquire/plan.acq_plan searches.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from gnss_dsp_tpu_torch.acquire.plan import acq_plan
from gnss_dsp_tpu_torch.cli import acquire as acq_cli
from gnss_dsp_tpu_torch.cli.workload import ACQUIRE_ALL
from gnss_dsp_tpu_torch.models import get_signal
from gnssbench import synth
from gnssbench.reference import acquire as ra
from gnssbench.reference import acquire_all as rall
from gnssbench.reference.models import get_signal as ref_signal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CPU's float32 plain surface against float64: relative gaps of a few
# 1e-7 at these sizes; 1e-5 leaves a wide margin and stays far below the
# ~1e-2 gaps between neighbouring cells of a surface, so a wrong cell or
# a shifted lag cannot pass
METRIC_TOL = 1e-5

# (signal, lags, capture fs, --time, rows, dopplers, planted row)
CASES = [
    ("gps-l1", "circular-n", 8.184e6, 4, "3,6", "-400,401,400", 3),
    ("beidou-b1i", "circular-2n", 16.368e6, 3, "7,11", "-400,401,400", 11),
    ("galileo-e1b", "circular-2n", 16.368e6, 8, "5,9", "-100,101,100", 9),
    ("gps-l2cm", "circular-2n", 4.092e6, 40, "2,29", "-20,21,20", 29),
    ("gps-l5i", "linear-n", 32.736e6, 2, "4,25", "-400,401,400", 25),
    ("glonass-l3ocd", "linear-n", 32.736e6, 2, "9,12", "-400,401,400", 9),
    ("glonass-l1", "circular-n", 16.368e6, 3, "-3:-2", "-400,401,400", -3),
]


def _capture(signal, fs, ms, prn, seed, doppler=400.0):
    sig = ref_signal(signal)
    plant = dict(signal=signal, prn=prn, doppler=doppler,
                 code_phase=0.37 * sig.code_length, coffset=120000.0,
                 cn0=52.0)
    raw = synth.synth_band([plant], fs, (ms + 5) / 1000.0, seed, 1, "cpu")
    return raw, plant


def _search(tmp_path, signal, raw, fs, argv, monkeypatch):
    """The CLI's results at full precision, taken where it calls the
    engine."""
    path = tmp_path / f"{signal}.iq"
    raw.tofile(path)
    got = []

    def keep(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            got.extend((r.prn, r.doppler, r.metric, r.code_offset)
                       for r in out)
            return out
        return run
    for name in ("acquire_signal", "acquire_signal_fdma"):
        monkeypatch.setattr(acq_cli, name, keep(getattr(acq_cli, name)))
    with contextlib.redirect_stdout(io.StringIO()):
        assert acq_cli.main(signal, argv + [str(path), str(int(fs)),
                                            "120000", "--device", "cpu"]) == 0
    return got


@pytest.mark.parametrize("signal,lags,fs,ms,rows,grid,planted", CASES,
                         ids=[c[0] for c in CASES])
def test_cli_agrees_with_the_reference(tmp_path, monkeypatch, signal, lags,
                                       fs, ms, rows, grid, planted):
    sig = ref_signal(signal)
    dops = ra.doppler_grid(tuple(float(v) for v in grid.split(",")))
    raw, plant = _capture(signal, fs, ms, planted, 2026, float(dops[-1]))
    opt = "--channel" if sig.fdma_hz else "--prn"
    got = _search(tmp_path, signal, raw, fs,
                  [opt, rows, "--time", str(ms), "--doppler-search", grid],
                  monkeypatch)
    ids = sig.prns(rows)
    err, wrong, missing = rall.judge(sig, raw, fs, 120000.0, ids, dops, ms,
                                     lags, "cpu", METRIC_TOL, ids, got)
    assert (wrong, missing) == (0, 0)
    assert err < METRIC_TOL
    (best,) = [r for r in got if r[0] == planted]
    assert best[1] == plant["doppler"]
    chip = (best[3] - plant["code_phase"]) % sig.code_length
    assert min(chip, sig.code_length - chip) < 0.5
    assert best[2] > 1.5 * max(r[2] for r in got if r[0] != planted)
    # the reference's own results (the control's path) pick the same
    # cells
    want = rall.results(sig, raw, fs, 120000.0, ids, dops, ms, lags, "cpu")
    assert [(r[0], r[1]) for r in want] == [(r[0], r[1]) for r in got]
    for w, g in zip(want, got):
        assert abs(w[2] - g[2]) <= METRIC_TOL * w[2]


def test_judge_finds_a_shifted_lag_and_a_lost_row(tmp_path, monkeypatch):
    """One lag off on the planted row is a wrong cell; a row left out is
    missing; another row's result is counted missing too."""
    sig = ref_signal("gps-l5i")
    raw, _plant = _capture("gps-l5i", 32.736e6, 2, 25, 7)
    got = _search(tmp_path, "gps-l5i", raw, 32.736e6,
                  ["--prn", "4,25", "--time", "2", "--doppler-search",
                   "-400,401,400"], monkeypatch)
    dops = ra.doppler_grid((-400.0, 401.0, 400.0))

    def judged(res):
        return rall.judge(sig, raw, 32.736e6, 120000.0, [4, 25], dops, 2,
                          "linear-n", "cpu", METRIC_TOL, [4, 25], res)
    assert judged(got)[1:] == (0, 0)
    shifted = [(p, d, m, c + sig.code_length / rall.period(sig))
               if p == 25 else (p, d, m, c) for p, d, m, c in got]
    assert judged(shifted)[1] == 1
    assert judged(got[:1])[2] == 1
    assert judged(got + [(7,) + got[0][1:]])[2] == 1


def _config():
    with open(os.path.join(ROOT, "gnssbench", "configs",
                           "sky2017-acq.json")) as f:
        return json.load(f)


def test_configuration_rows_are_acquire_all():
    rows = _config()["acquire"]
    assert [(r["band"], r["signal"], str(r["coffset"])) for r in rows] == [
        (b, s, c) for b, s, c, _out in ACQUIRE_ALL]
    assert all("argv" not in r for r in rows)


@pytest.mark.parametrize("i", range(len(ACQUIRE_ALL)))
def test_row_lags_follow_the_plan(i, monkeypatch):
    """Each row's lags are those acquire/plan.acq_plan searches:
    circular at n, all 2n circular lags at the 2n window, or the n
    linear lags of the padded 2n window (n_valid = n)."""
    for var in ("GNSS_DSP_NO_PALLAS", "GNSS_DSP_NO_V2P"):
        monkeypatch.delenv(var, raising=False)
    row = _config()["acquire"][i]
    sig = get_signal(row["signal"])
    n = rall.period(ref_signal(row["signal"]))
    route, window, data_window, n_valid = acq_plan(sig)
    want = {("v2", n, n, 0): "circular-n",
            ("v2", 2 * n, 2 * n, 0): "circular-2n"}.get(
        (route, window, data_window, n_valid))
    if route == "v2p" and data_window == 2 * n and n_valid == n:
        want = "linear-n"
    assert row["lags"] == want
