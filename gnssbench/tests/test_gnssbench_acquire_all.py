"""The sky2017-acq.acquire-all cell on the CPU at a tiny size: its own
cut of the configuration (four rows, one of each search kind, at a low
rate and a few ms) on top of tiny.make, run by the harness with its look
for a card skipped: the last line is `correct`, each planted fault makes
it not, and the readers of its three per-layer metrics read the
program's spans and K1's calls as they should."""

import json
import os
import types

import pytest

from gnss_dsp_tpu_torch.utils import profiling
from gnssbench import roofline
from gnssbench import run as harness
from gnssbench.tests import tiny

CELL = "sky2017-acq.acquire-all"

# (signal, lags, argv): the seeds of sky2017-acq on band 1 and 3 lie on
# each row's grid
ROWS = [
    ("gps-l1", 1, "circular-n",
     ["--prn", "20-22", "--time", "4", "--doppler-search", "2000,2801,400"]),
    ("glonass-l1", 1, "circular-n",
     ["--channel", "-3:-2", "--time", "4", "--doppler-search",
      "-1600,-799,400"]),
    ("beidou-b1i", 1, "circular-2n",
     ["--prn", "33-35", "--time", "3", "--doppler-search", "-1000,-199,400"]),
    ("gps-l5i", 3, "linear-n",
     ["--prn", "24-26", "--time", "2", "--doppler-search", "-2000,-1199,400"]),
]


def make(tmp) -> str:
    """tiny.make with a cut of sky2017-acq beside it: the rows above at
    32.736 MHz, every seed's carrier offset 0, 30 ms a band; 13 ms files
    at 8 ms epochs (three), two searches checked."""
    bench = tiny.make(tmp)
    here = os.path.join(os.path.dirname(bench), "gnssbench")
    cfg = tiny._load("configs", "sky2017-acq.json")
    cfg.update(fs=32736000, acquire_capture_s=0.03,
               acquire=[dict(signal=s, band=b, coffset=0, lags=lags,
                             argv=argv) for s, b, lags, argv in ROWS])
    cfg["sky"]["fixed"] = [dict(c, coffset=0.0) for c in cfg["sky"]["fixed"]
                           if c["signal"] in {r[0] for r in ROWS}]
    tiny._dump(cfg, here, "configs", "sky2017-acq.json")
    tr = tiny._load("traffic", "acquire-all.json")
    tr.update(epoch_ms=8, file_ms=13, check_searches=2, check_rows=1)
    tiny._dump(tr, here, "traffic", "acquire-all.json")
    return bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make(tmp_path_factory.mktemp("tiny_acq"))


def test_cell_is_correct(bench):
    rc, out = tiny.run(bench, CELL, seconds=3.0)
    assert rc == 0
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] >= len(ROWS)
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


def _reader(name):
    spec = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    metric = {m["name"]: m for m in spec["per_layer"]}[name]
    assert metric["workloads"] == [CELL]
    return harness.Cell(CELL).reader("metrics", metric)


def test_k1_search_bound_is_the_searchs_window():
    """On v2p the bound is taken at the search's 2n window (61380), not
    at the 65536 K1 pads it to; elsewhere at F's window."""
    reader = _reader("k1_search_roofline.acq")
    F = types.SimpleNamespace(shape=(70, 80, 65536))
    code = types.SimpleNamespace(shape=(32, 65536))
    got = reader.bound((F, code, 30690), {}, None)
    assert got == roofline.k1_call_bound_ms(70, 80, 61380, 32)
    assert got < roofline.k1_call_bound_ms(70, 80, 65536, 32)
    assert reader.bound((F, code), {"n_valid": 30690}, None) == got
    assert reader.bound((F, code, 0), {}, None) == \
        roofline.k1_call_bound_ms(70, 80, 65536, 32)
    assert [k["name"] for k in reader.KERNELS] == ["k1_search"]
    assert reader.TRACE == ("acq2_split_kernel", "acq2_wide_kernel")


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


def test_engine_shares_read_the_program(monkeypatch):
    """code_spectra_share.acq: host seconds of acq.code_spectra over the
    window; mix_fft_share.acq: stream seconds of acq.mix_fft; nothing
    where the program recorded neither (a tree before them)."""
    spans = []
    monkeypatch.setattr(profiling._traced, "spans", spans)
    monkeypatch.setattr(profiling._traced, "counts", {})
    lay = harness.Layers(None, {}, 10.0, None)
    code, mix = _reader("code_spectra_share.acq"), _reader(
        "mix_fft_share.acq")
    assert code.read(lay) is None and mix.read(lay) is None
    root = _span("cli.acquire", 0.0, 6.0)
    spans += [_span("acq.code_spectra", 0.0, 1.5, root),
              _span("acq.code_spectra", 2.0, 2.5, root),
              _span("acq.mix_fft", 3.0, 3.1, root, stream_ms=300.0),
              _span("acq.mix_fft", 4.0, 4.1, root, stream_ms=200.0), root]
    assert code.read(lay) == pytest.approx(20.0)
    assert mix.read(lay) == pytest.approx(5.0)
    monkeypatch.delattr(profiling, "totals")
    assert code.read(lay) is None and mix.read(lay) is None
