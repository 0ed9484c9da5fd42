"""Profiling: the program's spans and counters, a device sync and a
trace of a block.

Counterpart: gnss_dsp_tpu/utils/profiling.py (`device_sync`, `trace`).
Its `Counters` is not carried: the spans and counters below take its
place.

- `device_sync(token)`: wait for the card's work; torch.cuda.synchronize
  on the device of `token` (any tensor, or a tuple or list whose first
  leaf is one), a no-op on the CPU.
- `trace(log_dir)`: torch.profiler around the block (CPU, and CUDA where
  there is a card), its Chrome trace written to log_dir/trace.json; the
  program's spans lie on its timeline, and after the block `totals()`
  and `counts()` are the block's.

Spans and counters
------------------
Each layer marks its own work: `span(name, device=None)` around a
stretch of it (a context manager, or a decorator of a function) and
`count(name, n=1)` beside it.  They record only while something reads
them:

- While a torch profiler runs (`trace`, or any `torch.profiler.profile`)
  each span enters a record function of its name (a host op, as
  `torch.profiler.record_function` but not drawn on the device's rows),
  so it lies on the profiler's timeline with the kernels and copies it
  launched, and is kept in memory: its name, its parent (the span open
  around it on the same thread), the request it belongs to (the number
  of the outermost span) and its start and end on
  `time.perf_counter_ns`.  A
  span given a CUDA device also records a CUDA event pair on that
  device's current stream; the elapsed times are read by `totals()`.
  `totals()` gives {name: Total(calls, host_s, self_s, stream_s)}, self
  being the span less the spans inside it and stream_s None where no
  event was recorded; `counts()` the counters; `spans()` the spans
  themselves; `reset()` drops them all.
- While a call prints GNSS_DSP_TIMING lines (`Timing`) it keeps its own
  spans and counts, reads its lines from them and drops them when it
  returns, so a long run keeps nothing.  The spans the call names end
  with their device synchronised, so their walls hold the device work
  they launched; no span synchronises at any other time.
- Otherwise a span is a flag check that returns a shared no-op, and a
  count a flag check.

Spans record on the thread that runs the profiler (the profiler's flag
is its thread's) or the timed call, and nowhere else: the tracking
prefetch reader's thread opens none.  A span opened directly inside one
of its own name adds nothing, the outer one holds it (the track CLI's
`multi`, the int4 upload, the sharded scan).

The program's spans and counters:

  cli.acquire, cli.track      the CLIs' main: a request's root
  acquire.read                the capture's file read (cli/acquire)
  upload (device)             the int8 or int4 upload and its conversion
                              (ops/cplx); counter h2d.bytes: the bytes
                              each upload hands to the device, of them
                              h2d.pinned_bytes from pinned memory (the
                              tracking loops' uploads into place)
  frontend (device)           ops/frontend.prepare_baseband
  codes.lfsr                  models/codes/lfsr's register runs (the code
                              tables' LFSR families); counters
                              codes.lfsr.chips: the chips built, of them
                              codes.lfsr.chips_stepped by the per-chip
                              loop, counted once a call
  acq.code_ffts.hit, .miss    counters: acquire/engine's code-spectra LRU
  acq.code_spectra            a miss's host build of the code spectra
                              and their upload (acquire/engine)
  acq.mix_fft (device)        acquire/engine.mix_fft: the doppler mix
                              and forward FFT of the block windows
  acq.route.v2, .v2p, .v1,    counters: the route of each non-coherent
  .xla                        search (acquire/plan.acq_plan)
  acq.route.coh_spec,         counters: the route of each coherent
  .coh_blk, .coh_xla          search (acquire/coherent, plan.coh_plan)
  acq.coh.combine (device)    acquire/coherent's spec combine of a
                              doppler chunk (the fft_combine precompute
                              included); counter acq.coh.rows: the
                              combined rows (dc x G x A) handed to K5
  track.file, track.receiver  track/driver.track_file,
                              track/receiver.track_receiver
  track.setup                 the channels' set-up, first boundaries,
                              state and prefetch readers; counter
                              track.pinned.alloc: the pinned blocks
                              torch's caching host allocator created
                              for the readers' staging slots
  track.refill                a chunk's refill: the takes and the
                              carried samples moved on the device
    track.read_wait           the wait for the prefetch reader's bytes
  track.assemble              a chunk's zeros to its segments' ends,
                              written on the device (track/driver._Chunks)
  track.scan                  track/engine.track_scan: host set-up and
                              launches
  track.rows                  track/driver.emit_rows; counters
                              track.rows.bulk, .each: the rows written
                              a scan at a time (a track/rows.RowText
                              emit) and one at a time (any other emit,
                              kept rows, a scan past the fixed-point
                              range), counted once a call
    track.readback            its rows read back from the device (the
                              bulk path: formatted there, the text and
                              the counters read back)
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

_profiling = torch.autograd._profiler_enabled
# a span is a host op on the profiler's timeline; record_function's user
# annotations are drawn on the device's rows too, where the time between
# a span's kernels would read as device time
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)
_local = threading.local()        # .stack: open spans; .timings: Timing scopes
_requests = itertools.count(1)


def _first_tensor(token):
    while isinstance(token, (tuple, list)):
        token = token[0]
    return token


def device_sync(token=None):
    """Return once the work before it on `token`'s device is done: a
    CUDA synchronize there (on the current card when token is None and
    there is one); nothing to wait for on the CPU."""
    t = _first_tensor(token)
    if t is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block; yields the profiler and writes
    log_dir/trace.json (open it in chrome://tracing or Perfetto).  The
    spans and counts recorded before are dropped on entry."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Store:
    """Closed spans and counters, written by one thread: the one the
    profiler or the timed call runs on."""

    def __init__(self):
        self.spans = []
        self.counts = {}

    def add(self, name: str, n):
        self.counts[name] = self.counts.get(name, 0) + n


_traced = _Store()                # what the profiler's spans keep


class Total(NamedTuple):
    calls: int
    host_s: float                 # the spans' walls on the host clock
    self_s: float                 # less the spans inside them
    stream_s: float | None        # between their CUDA events, or None


def _totals(spans) -> dict:
    inner = {}
    for s in spans:
        if s.parent is not None:
            inner[id(s.parent)] = inner.get(id(s.parent), 0) + s.t1 - s.t0
    out = {}
    for s in spans:
        calls, host, own, stream = out.get(s.name, (0, 0.0, 0.0, None))
        d = s.t1 - s.t0
        if s.events is not None:
            e0, e1 = s.events
            e1.synchronize()
            stream = (stream or 0.0) + e0.elapsed_time(e1) / 1e3
        out[s.name] = Total(calls + 1, host + d / 1e9,
                            own + (d - inner.get(id(s), 0)) / 1e9, stream)
    return out


def totals() -> dict:
    """{span name: Total(calls, host_s, self_s, stream_s)} of the spans
    recorded under the profiler since the last reset()."""
    return _totals(list(_traced.spans))


def counts() -> dict:
    """{counter: count} recorded under the profiler since the last
    reset()."""
    return dict(_traced.counts)


def spans() -> list:
    """The spans recorded under the profiler since the last reset(), in
    the order they closed: each with name, parent (a span or None),
    request, t0 and t1 (perf_counter_ns)."""
    return list(_traced.spans)


def reset():
    """Drop the spans and counts recorded under the profiler."""
    _traced.spans.clear()
    _traced.counts.clear()


def _decorated(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


class _Off:
    """What span() gives while nothing records."""
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


_off = {}


def _noop(name: str) -> _Off:
    off = _off.get(name)
    if off is None:
        off = _off[name] = _Off(name)
    return off


class _Span:
    __slots__ = ("name", "parent", "request", "t0", "t1", "events",
                 "_device", "_sinks", "_rf", "_sync")

    def __init__(self, name, device, sinks, sync):
        self.name, self._device, self._sinks = name, device, sinks
        self._sync = sync
        self.events = self._rf = None

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        self.request = (self.parent.request if self.parent is not None
                        else next(_requests))
        stack.append(self)
        if _traced in self._sinks:
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        if self._device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self._device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._sync:
            torch.cuda.synchronize(self._device)
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self._device))
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _local.stack.pop()
        for store in self._sinks:
            store.spans.append(self)
        self._sinks = None
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


def _sinks():
    timings = getattr(_local, "timings", None)
    sinks = list(timings) if timings else []
    if _profiling():
        sinks.append(_traced)
    return sinks


def span(name: str, device=None):
    """A span of the calling thread's work named `name`: a context
    manager, or a decorator of a function.  device: where the work it
    launches runs; on a CUDA device the recorded span holds a CUDA event
    pair on its current stream (None, False or a CPU device: none)."""
    if not (getattr(_local, "timings", None) or _profiling()):
        return _noop(name)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    if stack and stack[-1].name == name:
        return _noop(name)
    dev = torch.device(device) if device else None
    if dev is not None and dev.type != "cuda":
        dev = None
    timings = getattr(_local, "timings", None) or ()
    sync = dev is not None and any(name in t.sync for t in timings)
    return _Span(name, dev, _sinks(), sync)


def count(name: str, n=1):
    """Add n to the counter `name` where spans record."""
    if not (getattr(_local, "timings", None) or _profiling()):
        return
    for store in _sinks():
        store.add(name, n)


class Timing(_Store):
    """The spans and counts of one call that prints GNSS_DSP_TIMING lines
    (set and non-empty) or, with keep, reports its walls to its caller:
    a context manager around the call's work that records on the calling
    thread while it is open.  The spans named in `sync` end with their
    device synchronised, only while the lines print.  `printing`: the
    lines are asked for."""

    def __init__(self, *sync: str, keep: bool = False):
        super().__init__()
        self.printing = bool(os.environ.get("GNSS_DSP_TIMING"))
        self.on = self.printing or keep
        self.sync = frozenset(sync) if self.printing else frozenset()

    def __enter__(self):
        if self.on:
            if getattr(_local, "timings", None) is None:
                _local.timings = []
            _local.timings.append(self)
        return self

    def __exit__(self, *exc):
        if self.on:
            _local.timings.remove(self)
        return False

    def seconds(self, *names: str) -> float:
        """The host seconds of the spans of these names, summed."""
        return sum(s.t1 - s.t0 for s in self.spans if s.name in names) / 1e9

    def since(self, name: str) -> float:
        """Seconds from the end of the last span `name` to now."""
        ends = [s.t1 for s in self.spans if s.name == name]
        return (time.perf_counter_ns() - max(ends)) / 1e9
