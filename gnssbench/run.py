"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python -m gnssbench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell, its configuration, its traffic,
its end-to-end and per-layer metrics are found by name: BENCHMARK.json
names them, and each is a file of its own under gnssbench/ (configs/,
traffic/ and the entry it names in entries/, checks/, e2e/, metrics/),
so a cell, a mix or a metric is added by adding files.  Set-up synthesises the captures on the card from
the seed, writes them under TMPDIR, loads the program (its kernels build
on a checkout's first run, into the checkout) and warms every shape the
cell uses; then one request after another runs for S seconds.  With
--trace 1 the window runs under torch.profiler with the benchmark's own
spans around the program's layers, and the line carries the per-layer
metrics; with --trace 0 the end-to-end ones.  After the window what the
timed requests produced is judged against the plain reference
(gnssbench/reference), each number against its limit
(gnssbench/checks/CELL.json).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then checks:
each number compared with its limit, which also end standard error.
With no card, with fewer cards than the cell asks for, without the
program beside the benchmark, or with JAX loaded once the window has
closed, it prints no result and exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "gnss_dsp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gnss_dsp_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, no program, JAX loaded)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """A file of the benchmark's own, loaded by its path (its name may
    hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None):
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with everything it names, from files."""

    def __init__(self, name, benchmark=None):
        bench_path = benchmark or os.path.join(ROOT, "BENCHMARK.json")
        here = self.here = os.path.join(os.path.dirname(
            os.path.abspath(bench_path)), os.path.basename(HERE))
        self.spec = load_json(bench_path)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        self.name = name
        self.cell = cells[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[self.cell["config"]]
        self.config = load_json(os.path.join(os.path.dirname(bench_path),
                                             conf["file"]))
        self.traffic = load_json(os.path.join(
            here, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(here, "checks", name + ".json"))

    def end_to_end(self):
        return [m for m in self.spec["end_to_end"]
                if name_in(self.name, m)]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if m["moves"] in e2e and name_in(self.name, m)]

    def reader(self, kind, metric):
        return load_module(os.path.join(self.here, kind,
                                        metric["name"] + ".py"),
                           f"gnssbench_{kind}_{metric['name']}")


def name_in(cell, metric):
    return cell in metric.get("workloads", [cell])


class Window:
    """The timed requests: (start, end, units, search walls, ok)."""

    def __init__(self, t0, t_end, reqs, setup_s):
        self.t0, self.t_end, self.setup_s = t0, t_end, setup_s
        self.done = [r for r in reqs if r[4] and r[1] <= t_end]
        self.t_last = max((r[1] for r in self.done), default=None)

    def rate(self, scale=1.0):
        if not self.done or self.t_last <= self.t0:
            return None
        return sum(r[2] for r in self.done) / (self.t_last - self.t0) * scale

    def search_walls(self):
        return [w for r in self.done for w in r[3]]


class Layers:
    """What per-layer readers read from the traced window."""

    def __init__(self, spans, kernels, window_s, busy_s):
        self.spans, self.kernels = spans, kernels
        self.window_s, self.busy_s = window_s, busy_s

    def share(self, *names):
        got = [self.spans.total[n] for n in names if n in self.spans.total]
        return 100.0 * sum(got) / self.window_s if got else None

    def roofline(self, name):
        calls, dev_s, bound_s = self.kernels.get(name, (0, 0.0, 0.0))
        return 100.0 * bound_s / dev_s if calls and dev_s > 0 else None

    def idle(self):
        if self.busy_s is None:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def run_cell(cell, args, tmp, require_card=True):
    import torch

    from gnssbench import devtrace, workload
    from gnssbench.spans import Patches, Spans

    chips = int(cell.cell["chips"])
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise Refused(f"the cell needs {chips} CUDA card(s); torch sees "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda" if require_card else "cpu")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    entry_cls = cell.reader("entries", {"name": cell.traffic["entry"]}).ENTRY
    layer_metrics = cell.per_layer() if args.trace else []
    readers = {m["name"]: cell.reader("metrics", m) for m in layer_metrics}
    workload.load_program(
        list(entry_cls.MODULES)
        + [w for r in readers.values() for w, _a, _n in getattr(r, "SPANS", [])]
        + [k["where"] for r in readers.values()
           for k in getattr(r, "KERNELS", [])])
    patches = Patches()
    entry = entry_cls(cell.config, cell.traffic, args.seed, tmp, patches,
                      device, fault=args.fault, control=args.control)
    try:
        t = time.perf_counter()
        entry.setup()
        sync()
        print(f"[setup] captures and files {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        t = time.perf_counter()
        entry.warm()
        sync()
        print(f"[setup] warm-up {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        spans = Spans()
        traced_kernels = {}
        if args.trace:
            seen = set()
            for r in readers.values():
                for where, attr, name in getattr(r, "SPANS", []):
                    if (where, attr) not in seen:
                        seen.add((where, attr))
                        patches.wrap(where, attr, spans.span(name))
                for k in getattr(r, "KERNELS", []):
                    if (k["where"], k["attr"]) not in seen:
                        seen.add((k["where"], k["attr"]))
                        patches.wrap(k["where"], k["attr"],
                                     spans.kernel(k["name"], k["bound"]))
                        traced_kernels[k["name"]] = k["trace"]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_PROCESS
        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        reqs, attempted, failed = [], 0, 0
        t0 = time.perf_counter()
        t_end = t0 + float(args.seconds)
        k = 0
        while time.perf_counter() < t_end:
            n0 = len(entry.searches)
            t1 = time.perf_counter()
            attempted += 1
            try:
                units, ok = entry.request(k), True
            except Exception:                  # a failed request counts
                traceback.print_exc()
                units, ok = 0.0, False
                failed += 1
            reqs.append((t1, time.perf_counter(), units,
                         entry.searches[n0:], ok))
            k += 1
        sync()
        t_close = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        patches.undo()
        found = forbidden_loaded()
        if found:
            raise Refused("JAX or the JAX package is loaded in the "
                          f"process: {', '.join(found)}")
        win = Window(t0, t_end, reqs, setup_s)
        device_info = {"platform": "gpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu (a test run)"),
                       "count": chips, "memory_peak_bytes": memory_peak}
        metrics, breakdown = {}, None
        if args.trace:
            t_read = time.perf_counter()
            window_s = t_close - t0
            kernels = spans.kernel_totals()
            events = prof.events()
            dev = devtrace.device_events(events)
            busy_us, how = devtrace.device_busy_us(
                (a, b) for _n, a, b in dev), "trace"
            for name, pats in traced_kernels.items():
                calls = kernels.get(name, (0, 0.0, 0.0))[0]
                kept = sum(1 for n, _a, _b in dev if any(p in n for p in pats))
                print(f"[trace] {name}: {kept} events kept of {calls} "
                      f"launches", file=sys.stderr)
                if calls and kept < 0.9 * calls:
                    busy_us = devtrace.device_busy_us(
                        (a, b) for n, a, b in dev
                        if not any(p in n for p in pats)) \
                        + kernels[name][1] * 1e6
                    how = "trace without " + name + " + its CUDA events"
            print(f"[trace] busy from {how}", file=sys.stderr)
            busy_s = busy_us / 1e6
            device_info.update(busy_s=busy_s, window_s=window_s)
            lay = Layers(spans, kernels, window_s, busy_s)
            for m in layer_metrics:
                v = readers[m["name"]].read(lay)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            t0_us = min((a for _n, a, _b in dev), default=0.0)
            t1_us = max((b for _n, _a, b in dev), default=0.0)
            breakdown = {
                "device_ops": devtrace.top_ops(dev),
                "idle_gaps": devtrace.idle_gaps(
                    dev, devtrace.span_events(events), t0_us, t1_us)}
            print(f"[trace] read in {time.perf_counter() - t_read:.3f} s",
                  file=sys.stderr)
        else:
            for m in cell.end_to_end():
                v = cell.reader("e2e", m).read(win)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        compared, info = entry.check(cell.limits)
        print(f"[check] {time.perf_counter() - t:.3f} s", file=sys.stderr)
    finally:
        patches.undo()
        entry.close()
    checks = {}
    for name, value in compared.items():
        checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = failed == 0 and bool(win.done) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out, info


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the benchmark's own calibration and tests; never set by a check
    ap.add_argument("--fault", choices=("stale", "half", "alter"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--control", choices=("tf32-reference", "float32-sums"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--benchmark", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, require_card=True) -> int:
    args = parse(argv)
    try:
        cell = Cell(args.workload, args.benchmark)
        if importlib.util.find_spec(PROGRAM) is None:
            raise Refused(f"the program ({PROGRAM}) is not beside the "
                          f"benchmark")
        # every cache of the program stays inside the checkout, at fixed
        # paths, so only a checkout's first run builds
        for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                         ("TRITON_CACHE_DIR", "triton")):
            os.environ[var] = os.path.join(ROOT, ".cache", sub)
        os.environ["USE_FLAX"] = "0"
        tmp = tempfile.mkdtemp(prefix="gnssbench-")
        try:
            out, info = run_cell(cell, args, tmp, require_card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        # again after the readers and the comparison, just before the
        # result: whatever they imported counts too
        found = forbidden_loaded()
        if found:
            raise Refused("JAX or the JAX package is loaded in the "
                          f"process: {', '.join(found)}")
    except Refused as e:
        print(f"gnssbench: {e}", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}", file=sys.stderr)
    print(f"[checked] {json.dumps(info)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
