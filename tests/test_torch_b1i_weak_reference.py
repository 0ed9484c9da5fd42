"""The acquire CLI's extended-coherent search (gnss_dsp_tpu_torch.cli.
acquire.main with --coherent 20, its CPU plain versions) against the
benchmark's float64 reference of it (gnssbench/reference/coherent.py),
on BeiDou B1I at its own window: W = 16384 (the 2n window of n = 8192 at
8.192 MHz, all 2n lags), 40 blocks in 2 groups of 20, the 20 NH20
alignments, on the spec route (acquire/plan.coh_plan), whose surface on
the CPU is ops/acquire_coh.corr_surface_coh_spec_plain.

The capture holds two satellites whose code periods carry NH20 x D1
signs (gnssbench/entries/coherent.synth_band_bits) and one empty row;
every row's reported doppler, code offset and alignment are the
reference's, and its metric lies within METRIC_TOL of the reference's
metric at that cell.  A search with the NH20 rolled by one chip in the
program's catalog reports the wrong alignment, which the judge counts.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

from gnss_dsp_tpu_torch.acquire.plan import coh_plan
from gnss_dsp_tpu_torch.cli import acquire as acq_cli
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.models.signal import REGISTRY
from gnssbench.entries.coherent import synth_band_bits
from gnssbench.reference import acquire as ra
from gnssbench.reference import coherent as rcoh
from gnssbench.reference.models import get_signal as ref_signal

# the CPU's float32 plain search against float64: relative gaps of a few
# 1e-7 at these sizes; 1e-5 leaves a wide margin and stays far below the
# gaps between neighbouring cells or alignments of a surface
METRIC_TOL = 1e-5

FS = 16.368e6
COFFSET = 120000.0
ROWS = [7, 11, 30]                       # 7 and 11 seeded, 30 empty
GRID = "-50,51,25"                       # 5 dopplers
ARGV = ["--coherent", "20", "--time", "40", "--prn", "7,11,30",
        "--doppler-search", GRID]


def _plants(seed, cn0):
    rng = np.random.default_rng([seed, 11])
    sig = ref_signal("beidou-b1i")
    return [dict(signal="beidou-b1i", prn=prn, doppler=dop,
                 code_phase=round(float(rng.uniform(0, sig.code_length)), 2),
                 coffset=COFFSET, cn0=cn0)
            for prn, dop in ((7, 27.5), (11, -22.0))]


@pytest.fixture(scope="module")
def capture():
    """capture(seed, cn0): (raw, plants, the reference surface as a list)
    of one case, made once a module."""
    made = {}

    def get(seed, cn0):
        if (seed, cn0) not in made:
            plants = _plants(seed, cn0)
            raw = synth_band_bits(plants, FS, 0.045, seed, 1, "cpu")
            surf = list(rcoh.surface(ref_signal("beidou-b1i"), raw, FS,
                                     COFFSET, ROWS, _dops(), 40, "cpu"))
            made[seed, cn0] = raw, plants, surf
        return made[seed, cn0]
    return get


def _dops():
    return ra.doppler_grid(tuple(float(v) for v in GRID.split(",")))


def _search(tmp_path, raw, monkeypatch):
    """The CLI's results with their alignments, taken where it calls the
    engine."""
    path = tmp_path / "b1i.iq"
    raw.tofile(path)
    got = []

    def keep(*a, **k):
        out = run(*a, **k)
        got.extend((r.prn, r.doppler, r.metric, r.code_offset, r.align)
                   for r in out)
        return out
    run = acq_cli.acquire_signal_coherent
    monkeypatch.setattr(acq_cli, "acquire_signal_coherent", keep)
    with contextlib.redirect_stdout(io.StringIO()):
        assert acq_cli.main("beidou-b1i", ARGV + [
            str(path), str(int(FS)), str(COFFSET), "--device", "cpu"]) == 0
    return got


def test_the_search_takes_the_spec_route():
    sig = get_signal("beidou-b1i")
    assert coh_plan(sig, 8192, 20, 20) == ("spec", 16384, 16384, 0)


@pytest.mark.parametrize("seed,cn0", [(2026, 34.0), (3000000123, 34.0),
                                      (2026, 30.0), (3000000123, 30.0)])
def test_cli_agrees_with_the_reference(tmp_path, monkeypatch, capture, seed,
                                       cn0):
    raw, plants, surf = capture(seed, cn0)
    got = _search(tmp_path, raw, monkeypatch)
    sig = ref_signal("beidou-b1i")
    dops = _dops()
    want = rcoh.results_of(sig, surf, ROWS, dops)
    assert [r[0] for r in got] == ROWS
    for w, g in zip(want, got):
        assert (g[1], g[4]) == (w[1], w[4])             # doppler, alignment
        assert g[3] == pytest.approx(w[3], abs=1e-9)    # code offset
        assert abs(g[2] - w[2]) <= METRIC_TOL * w[2]
    err, wrong, missing = rcoh.judge(sig, surf, ROWS, dops, METRIC_TOL,
                                     ROWS, got)
    assert (wrong, missing) == (0, 0) and err < METRIC_TOL
    if cn0 == 34.0:
        # the seeded rows stand out at their code; a D1 edge inside a
        # group moves the best doppler by up to 1 / (2 x 20 ms)
        for p in plants:
            (r,) = [g for g in got if g[0] == p["prn"]]
            assert abs(r[1] - p["doppler"]) <= 37.5
            chip = (r[3] - p["code_phase"]) % sig.code_length
            assert min(chip, sig.code_length - chip) < 0.5
            assert r[2] > 1.25 * got[-1][2]


def test_judge_catches_a_rolled_overlay(tmp_path, monkeypatch, capture):
    """The program's NH20 rolled by one chip: its alignments name the
    reference's neighbours, so the reported cells are wrong."""
    raw, _plants, surf = capture(2026, 34.0)
    sig = REGISTRY["beidou-b1i"]
    nh = sig.secondary
    monkeypatch.setitem(REGISTRY, "beidou-b1i", dataclasses.replace(
        sig, secondary=lambda prn: np.roll(nh(prn), 1)))
    got = _search(tmp_path, raw, monkeypatch)
    err, wrong, missing = rcoh.judge(ref_signal("beidou-b1i"), surf, ROWS,
                                     _dops(), METRIC_TOL, ROWS, got)
    assert missing == 0
    assert wrong >= 2 and err > 100 * METRIC_TOL
