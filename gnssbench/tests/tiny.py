"""A tiny copy of the benchmark in a temporary directory, for the CPU
tests: the real BENCHMARK.json, readers and limits, with configurations
and traffic cut to sizes the CPU runs in seconds (the same files by the
same names, so the harness finds them as it finds the real ones)."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _dump(obj, *parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def make(tmp) -> str:
    """Write the tiny benchmark under tmp; returns its BENCHMARK.json."""
    tmp = str(tmp)
    here = os.path.join(tmp, "gnssbench")
    for d in ("e2e", "metrics", "checks", "entries"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(here, d))
    gps = _load("configs", "gps-l1.json")
    gps.update(fs=8184000, acquire_capture_s=0.06, track_capture_s=0.06,
               acquire=[{"signal": "gps-l1", "band": 1, "coffset": 0,
                         "argv": ["--prn", "1-4", "--time", "10",
                                  "--doppler-search", "-1000,1000,500"]}])
    gps["sky"]["random"][0].update(satellites=2, prns="1-4", coffset=0)
    _dump(gps, here, "configs", "gps-l1.json")
    sky = _load("configs", "sky2017.json")
    keep = [dict(c, coffset=0.0) for c in sky["track"]
            if c["signal"] in ("gps-l1", "galileo-e1b", "gps-l5i")]
    sky.update(fs=16368000, track_capture_s=0.05, track=keep,
               sky={"fixed": keep})
    _dump(sky, here, "configs", "sky2017.json")
    cuts = {"acquire-epochs": dict(epoch_ms=10, file_ms=15, check_searches=2),
            "receiver": dict(chunk_ms=20),
            "track-cli": dict(argv=["--chunk-ms", "20"])}
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        tr = _load("traffic", name)
        tr.update(cuts.get(name[:-5], {}))
        _dump(tr, here, "traffic", name)
    spec = _load(os.pardir, "BENCHMARK.json")
    path = os.path.join(tmp, "BENCHMARK.json")
    _dump(spec, path)
    return path


def run(bench, cell, *extra, seconds=1.5, trace=0, seed=3000000123):
    """(exit code, the result line's object or None) of one run on the
    CPU, the harness's look for a card skipped."""
    import contextlib
    import io

    from gnssbench import run as harness

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace),
                           "--benchmark", bench, *extra], require_card=False)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
