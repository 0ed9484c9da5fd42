"""The reader of `rows_bulk_share.track` on planted counters: 100 x
track.rows.bulk / (track.rows.bulk + track.rows.each); None where the
program counted no row, or counts neither (a tree before the counters)."""

import json
import os

import pytest

from gnss_dsp_tpu_torch.utils import profiling
from gnssbench import run as harness
from gnssbench.tests import tiny

NAME = "rows_bulk_share.track"


@pytest.fixture(scope="module")
def metric():
    spec = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    return {m["name"]: m for m in spec["per_layer"]}[NAME]


@pytest.fixture
def counts(monkeypatch):
    planted = {}
    monkeypatch.setattr(profiling._traced, "counts", planted)
    return planted


@pytest.mark.parametrize("cell", ["gps-l1.track", "sky2017.receiver"])
def test_reads_the_bulk_share(metric, counts, cell):
    reader = harness.Cell(cell).reader("metrics", metric)
    ctx = harness.Layers(None, {}, 10.0, None)
    assert metric["moves"] == "track_msamples_per_s"
    assert metric["layer"] == "track driver rows, track/driver.emit_rows"
    assert cell in metric["workloads"]
    assert reader.read(ctx) is None                  # nothing recorded
    counts["track.rows.each"] = 0
    assert reader.read(ctx) is None                  # no row
    counts["track.rows.each"] = 60_000
    assert reader.read(ctx) == 0.0                   # the receiver's emit
    counts["track.rows.bulk"] = 20_000
    assert reader.read(ctx) == pytest.approx(25.0)
    del counts["track.rows.each"]
    assert reader.read(ctx) == 100.0                 # the track CLI


def test_no_registry_reads_nothing(metric, counts, monkeypatch):
    reader = harness.Cell("gps-l1.track").reader("metrics", metric)
    counts.update({"track.rows.bulk": 10})
    monkeypatch.delattr(profiling, "counts")
    assert reader.read(harness.Layers(None, {}, 10.0, None)) is None
