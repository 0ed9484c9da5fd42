"""The benchmark's reader of K5's batched-core share
(gnssbench/metrics/k5_batched_share.acq.py) on planted counters: the
program's acq.k5.core.batched over it plus acq.k5.core.other, nothing
where the program counted neither (a tree before the counters) or
records no counters at all."""

import json
import os

import pytest

from gnss_dsp_tpu_torch.utils import profiling
from gnssbench import run as harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "k5_batched_share.acq"


def _reader():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    metric = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert metric["workloads"] == ["b1i-weak.coherent"]
    assert metric["moves"] == "acq_cells_per_s"
    assert metric["source"] == "program_counter"
    return harness.Cell("b1i-weak.coherent").reader("metrics", metric)


def test_reader_takes_the_batched_launches_over_every_k5_launch(monkeypatch):
    counts = {"acq.route.coh_spec": 4, "acq.coh.rows": 8160}
    monkeypatch.setattr(profiling._traced, "counts", counts)
    reader = _reader()
    lay = harness.Layers(None, {}, 30.0, None)
    assert reader.read(lay) is None                 # no K5 counter
    counts["acq.k5.core.batched"] = 12
    assert reader.read(lay) == pytest.approx(100.0)
    counts["acq.k5.core.other"] = 4
    assert reader.read(lay) == pytest.approx(75.0)
    counts["acq.k5.core.batched"] = 0
    assert reader.read(lay) == pytest.approx(0.0)
    monkeypatch.delattr(profiling, "counts")
    assert reader.read(lay) is None                 # a tree before them
