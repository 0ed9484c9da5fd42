"""The real cells on the card, a short window each: the result line is
whole and `correct`.  Run on the card from the checkout's root with
`python -m pytest gnssbench/tests/test_gnssbench_card.py -o addopts=""`;
without a card each test skips."""

import json
import os
import subprocess
import sys

import pytest

from gnssbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.parametrize("cell", ["gps-l1.acquire", "sky2017.receiver",
                                  "gps-l1.track"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    r = subprocess.run([sys.executable, "-m", "gnssbench.run", "--workload",
                        cell, "--seed", str(2 ** 32 + 17), "--seconds", "3",
                        "--trace", str(trace)], cwd=tiny.ROOT,
                       capture_output=True, text=True, timeout=360,
                       env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    spec = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    assert set(out["metrics"]) == {m["name"] for m in spec[kind]
                                   if cell in m.get("workloads", [cell])}
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10


def test_graphed_reference_scan_is_the_frozen_scan(card, monkeypatch):
    """The tracking reference's steps replayed from CUDA graphs give the
    frozen scan's rows bit for bit (head, whole graphs and the rest)."""
    import numpy as np

    from gnssbench import synth
    from gnssbench.reference.track import run as ref_track

    fs = 69984000.0
    chans = [dict(signal="gps-l1", prn=p, doppler=d, code_phase=cp,
                  coffset=-9334875.0, cn0=45.0)
             for p, d, cp in ((3, 1200.0, 100.25), (9, -2300.5, 700.5),
                              (17, 300.0, 5.0))]
    raw = synth.synth_band(chans, fs, 0.2, 77, 1, "cuda")
    graphed = ref_track.track_pass([(raw, chans)], fs, False, "cuda")
    monkeypatch.setattr(ref_track, "GRAPH_STEPS", 10 ** 9)
    eager = ref_track.track_pass([(raw, chans)], fs, False, "cuda")
    assert ref_track.rows_differ(graphed, eager) == 0
    assert sum(len(f) for f, _i in eager) >= 3 * 190
    assert all(np.isfinite(f).all() for f, _i in eager)
