"""The reader of `pinned_share.track` on planted counters: 100 x
h2d.pinned_bytes / h2d.bytes; None where the program recorded no upload,
or records no pinned bytes at all (a tree before the counter)."""

import json
import os

import pytest

from gnss_dsp_tpu_torch.utils import profiling
from gnssbench import run as harness
from gnssbench.tests import tiny

NAME = "pinned_share.track"


@pytest.fixture(scope="module")
def metric():
    spec = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    return {m["name"]: m for m in spec["per_layer"]}[NAME]


@pytest.fixture
def counts(monkeypatch):
    planted = {}
    monkeypatch.setattr(profiling._traced, "counts", planted)
    return planted


@pytest.mark.parametrize("cell", ["sky2017.receiver", "gps-l1.track"])
def test_reads_the_pinned_share(metric, counts, cell):
    reader = harness.Cell(cell).reader("metrics", metric)
    ctx = harness.Layers(None, {}, 10.0, None)
    assert metric["moves"] == "track_msamples_per_s"
    assert cell in metric["workloads"]
    assert reader.read(ctx) is None                  # nothing recorded
    counts["h2d.bytes"] = 4_000
    assert reader.read(ctx) is None                  # no pinned counter
    counts["h2d.pinned_bytes"] = 3_000
    assert reader.read(ctx) == pytest.approx(75.0)
    counts["h2d.pinned_bytes"] = 0
    assert reader.read(ctx) == 0.0                   # pinning refused
    counts["h2d.bytes"] = 0
    assert reader.read(ctx) is None                  # no upload


def test_no_registry_reads_nothing(metric, counts, monkeypatch):
    reader = harness.Cell("gps-l1.track").reader("metrics", metric)
    counts.update({"h2d.bytes": 10, "h2d.pinned_bytes": 10})
    monkeypatch.delattr(profiling, "counts")
    assert reader.read(harness.Layers(None, {}, 10.0, None)) is None
