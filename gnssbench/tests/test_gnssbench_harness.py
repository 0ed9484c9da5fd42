"""The harness on the CPU at a tiny size: the arguments, the result
line's keys, the refusal without a card, the files found by name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gnssbench import run as harness
from gnssbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def test_arguments():
    a = harness.parse(["--workload", "gps-l1.acquire", "--seed",
                       str(2 ** 33 + 5), "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "gps-l1.acquire", 2 ** 33 + 5, 10.0, 1)
    assert a.fault is None and a.control is None
    with pytest.raises(SystemExit):
        harness.parse(["--workload", "x", "--seed", "1", "--seconds", "1",
                       "--trace", "2"])


@pytest.mark.parametrize("cell", ["gps-l1.acquire", "sky2017.receiver",
                                  "gps-l1.track"])
def test_last_line(bench, cell):
    rc, out = tiny.run(bench, cell)
    assert rc == 0
    assert list(out) == KEYS                    # checks comes last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    spec = json.load(open(bench))
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_card_refused():
    """Without a card the run prints no result and exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "gnssbench.run", "--workload",
                        "gps-l1.acquire", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_jax_loaded_during_the_check_refused(bench, monkeypatch):
    """A module named jax that appears after the window, while what the
    window produced is judged, leaves the run without a result."""
    import types

    from gnssbench import workload

    check = workload.Tracking.check

    def planted(self, limits):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, limits)
    monkeypatch.setattr(workload.Tracking, "check", planted)
    rc, out = tiny.run(bench, "gps-l1.track")
    assert rc != 0 and out is None


def test_without_the_program_refused(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's
    files gives no result."""
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "gnssbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "gnssbench.run", "--workload",
                        "gps-l1.acquire", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_cell_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix, a limit file and a per-layer
    metric added as new files, with new entries in BENCHMARK.json, run
    with no file of the harness edited."""
    bench = tiny.make(tmp_path)
    root = os.path.dirname(bench)
    here = os.path.join(root, "gnssbench")
    spec = json.load(open(bench))
    cfg = json.load(open(os.path.join(here, "configs", "gps-l1.json")))
    cfg["acquire"][0]["argv"] = ["--prn", "5-6", "--time", "8",
                                 "--doppler-search", "-500,500,500"]
    tiny._dump(cfg, here, "configs", "gps-l1-narrow.json")
    tr = json.load(open(os.path.join(here, "traffic",
                                     "acquire-epochs.json")))
    tr.update(epoch_ms=20, file_ms=13)
    tiny._dump(tr, here, "traffic", "acquire-epochs-20.json")
    limits = json.load(open(os.path.join(here, "checks",
                                         "gps-l1.acquire.json")))
    tiny._dump(limits, here, "checks", "gps-l1-narrow.acquire-20.json")
    with open(os.path.join(here, "metrics", "search_count.acq.py"),
              "w") as f:
        f.write("SPANS = []\n\n\ndef read(ctx):\n    return None\n")
    spec["configs"].append(dict(spec["configs"][0], name="gps-l1-narrow",
                                file="gnssbench/configs/gps-l1-narrow.json"))
    spec["workloads"].append(dict(spec["workloads"][0],
                                  name="gps-l1-narrow.acquire-20",
                                  config="gps-l1-narrow",
                                  traffic="acquire-epochs-20"))
    for m in spec["end_to_end"]:
        if "gps-l1.acquire" in m.get("workloads", []):
            m["workloads"].append("gps-l1-narrow.acquire-20")
    spec["per_layer"].append(dict(spec["per_layer"][0],
                                  name="search_count.acq",
                                  workloads=["gps-l1-narrow.acquire-20"]))
    tiny._dump(spec, bench)
    cell = harness.Cell("gps-l1-narrow.acquire-20", bench)
    assert "search_count.acq" in [m["name"] for m in cell.per_layer()]
    rc, out = tiny.run(bench, "gps-l1-narrow.acquire-20")
    assert rc == 0 and out["correct"] is True
    assert out["metrics"]["acq_cells_per_s"]["value"] > 0


def test_any_whole_number_seed(bench):
    """A seed past 32 bits, or below zero, runs and is judged as any."""
    for seed in (2 ** 40 + 3, -7):
        rc, out = tiny.run(bench, "gps-l1.track", seed=seed)
        assert rc == 0 and out["correct"] is True


def test_receiver_loop_is_its_span_less_the_calls_inside():
    """receiver_loop_share.track: the receiver's span less the take,
    upload, scan and rows spans inside it, over the window; nothing
    where the receiver did not run."""
    spec = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    cell = harness.Cell("sky2017.receiver")
    metric = {m["name"]: m for m in spec["per_layer"]}[
        "receiver_loop_share.track"]
    reader = cell.reader("metrics", metric)

    class Spans:
        total = {"track.receiver": 8.0, "track.receiver_scan": 1.0,
                 "track.take": 0.5, "track.from_iq": 1.5,
                 "track.emit_rows": 1.0}
    lay = harness.Layers(Spans, {}, 10.0, None)
    assert reader.read(lay) == pytest.approx(40.0)
    Spans.total = {"track.take": 0.5}
    assert reader.read(lay) is None
