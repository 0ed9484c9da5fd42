"""The b1i-weak.coherent cell on the CPU at a tiny size: its own cut of
the configuration (a few PRNs and dopplers at a low rate, two epochs) on
top of tiny.make, run by the harness with its look for a card skipped:
the last line is `correct`, each planted fault makes it not, the TF32
control reads past metric_err's limit, and the readers of its three
per-layer metrics read K5's calls and the program's span and counters as
they should."""

import json
import os
import types

import pytest

from gnss_dsp_tpu_torch.utils import profiling
from gnssbench import roofline
from gnssbench import run as harness
from gnssbench.tests import tiny

CELL = "b1i-weak.coherent"


def make(tmp) -> str:
    """tiny.make with a cut of b1i-weak beside it: PRNs 6-10 (two seeded
    from 6-9) on 5 dopplers at 16.368 MHz, carrier offset 0, 90 ms of
    band 1 (two 45 ms epoch files), two searches checked."""
    bench = tiny.make(tmp)
    here = os.path.join(os.path.dirname(bench), "gnssbench")
    cfg = tiny._load("configs", "b1i-weak.json")
    row = cfg["acquire"][0]
    row.update(coffset=0, argv=row["argv"][:4] + [
        "--prn", "6-10", "--doppler-search", "-50,51,25"])
    cfg.update(fs=16368000, acquire_capture_s=0.09)
    cfg["sky"]["random"][0].update(coffset=0, satellites=2, prns="6-9",
                                   doppler_hz=[-50.0, 50.0])
    tiny._dump(cfg, here, "configs", "b1i-weak.json")
    tr = tiny._load("traffic", "coherent.json")
    tr.update(check_searches=2, check_rows=1)
    tiny._dump(tr, here, "traffic", "coherent.json")
    return bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make(tmp_path_factory.mktemp("tiny_coh"))


def test_cell_is_correct(bench):
    rc, out = tiny.run(bench, CELL, seconds=3.0)
    assert rc == 0
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"acq_cells_per_s", "acq_search_p95_ms",
                                   "setup_s"}
    assert set(out["checks"]) == {"metric_err", "cells_wrong",
                                  "rows_missing", "repeats_differ"}


@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
def test_fault_is_not_correct(bench, fault):
    rc, out = tiny.run(bench, CELL, "--fault", fault, seconds=3.0)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


def test_control_is_not_correct(bench):
    """The reference in TF32 in the program's place reads past the
    limit that the program's float32 meets."""
    rc, out = tiny.run(bench, CELL, "--control", "tf32-reference",
                       seconds=3.0)
    assert rc == 0
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["metric_err"]["value"] > \
        out["checks"]["metric_err"]["limit"]


def test_search_cells_and_route():
    """A search of the real configuration is 63 x 200 x 8192 x 40 cells
    (the 20 alignments not counted) on the spec route at 16384, and the
    entry's argv is README.md's."""
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan
    from gnss_dsp_tpu_torch.models import get_signal
    from gnssbench.entries.coherent import Coherent

    cfg = tiny._load("configs", "b1i-weak.json")
    (row,) = cfg["acquire"]
    assert row["argv"] == ["--coherent", "20", "--time", "40",
                           "--doppler-search", "-2500,2500,25"]
    entry = Coherent.__new__(Coherent)
    entry.fs = float(cfg["fs"])
    assert entry.search_cells(row) == 63 * 200 * 8192 * 40 == 4_128_768_000
    assert entry._m_coh(row) == 20
    assert coh_plan(get_signal("beidou-b1i"), 8192, 20, 20) == (
        "spec", 16384, 16384, 0)


def _reader(name):
    spec = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    metric = {m["name"]: m for m in spec["per_layer"]}[name]
    assert metric["workloads"] == [CELL]
    return harness.Cell(CELL).reader("metrics", metric)


def test_k5_bound_is_the_launchs():
    """B1I --coherent 20's launch, 63 PRNs x 51 dopplers x 40 rows at
    16384, is bound at 2.546 ms by its operations; on a padded window at
    the search's own 2 n_valid."""
    reader = _reader("k5_roofline.acq")
    f2 = types.SimpleNamespace(shape=(51, 40, 16384))
    code = types.SimpleNamespace(shape=(63, 16384))
    got = reader.bound((f2, code, 20), {}, None)
    assert got == pytest.approx(2.546, abs=5e-4)
    assert got == reader.k5_call_bound_ms(63, 51, 40, 16384)
    assert roofline.surface_bound(63, 51, 40, 16384, 63 * 51 * 12)[1] == \
        "operations"
    wide = types.SimpleNamespace(shape=(12, 40, 65536))
    assert reader.bound((wide, types.SimpleNamespace(shape=(32, 65536)),
                         20, 30690), {}, None) == \
        reader.k5_call_bound_ms(32, 12, 40, 61380)
    assert [k["name"] for k in reader.KERNELS] == ["k5"]
    assert reader.KERNELS[0]["attr"] == "corr_surface_coh_spec"
    assert reader.TRACE == ("coh_spec_kernel", "coh_wide_kernel")


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


def _span(name, t0, t1, parent=None, stream_ms=None):
    return types.SimpleNamespace(
        name=name, parent=parent, request=1, t0=int(t0 * 1e9),
        t1=int(t1 * 1e9),
        events=None if stream_ms is None else (_Event(stream_ms),
                                                _Event(stream_ms)))


def test_coherent_readers_read_the_program(monkeypatch):
    """coh_combine_share.acq: stream seconds of acq.coh.combine over the
    window; coh_spec_share.acq: acq.route.coh_spec over every
    acq.route.coh_*; nothing where the program recorded neither (a tree
    before them), and the spec share ignores the non-coherent routes."""
    spans, counts = [], {"acq.route.v2": 3}
    monkeypatch.setattr(profiling._traced, "spans", spans)
    monkeypatch.setattr(profiling._traced, "counts", counts)
    lay = harness.Layers(None, {}, 10.0, None)
    comb, spec = _reader("coh_combine_share.acq"), _reader(
        "coh_spec_share.acq")
    assert comb.read(lay) is None and spec.read(lay) is None
    root = _span("cli.acquire", 0.0, 6.0)
    spans += [_span("acq.coh.combine", 1.0, 1.1, root, stream_ms=400.0),
              _span("acq.coh.combine", 2.0, 2.1, root, stream_ms=100.0),
              root]
    counts.update({"acq.route.coh_spec": 3, "acq.route.coh_xla": 1,
                   "acq.coh.rows": 24000})
    assert comb.read(lay) == pytest.approx(5.0)
    assert spec.read(lay) == pytest.approx(75.0)
    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "counts")
    assert comb.read(lay) is None and spec.read(lay) is None
