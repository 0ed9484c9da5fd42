"""The benchmark's own spans and kernel timers, wrapped around the calls
into the program's layers.

Each wrapper replaces a function on the module where its caller looks it
up (a name imported with `from x import f` is looked up on the importing
module), so the program is measured as it runs, and restored
afterwards.  Where a span is taken (the traced run only) it synchronises
the card before and after the call, so the span holds the device work
the call launched; a kernel timer records CUDA events around each call
and keeps what the call's roofline bound needs.
"""

from __future__ import annotations

import importlib
import time

from gnssbench.devtrace import SPAN_PREFIX


def _resolve(where: str, attr: str):
    """(owner, name): the module (or the class on it, for "Cls.meth")
    that holds the function the caller looks up."""
    owner = importlib.import_module(where)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


class Patches:
    """Replacements of module attributes, undone in reverse order."""

    def __init__(self):
        self._done = []

    def wrap(self, where: str, attr: str, make):
        """Replace where.attr by make(original)."""
        owner, name = _resolve(where, attr)
        orig = owner.__dict__[name] if isinstance(owner, type) \
            else getattr(owner, name)
        fn = orig.__func__ if isinstance(orig, staticmethod) else orig
        setattr(owner, name, make(fn))
        self._done.append((owner, name, orig))

    def undo(self):
        while self._done:
            owner, name, orig = self._done.pop()
            setattr(owner, name, orig)


class Spans:
    """Synchronised wall time and call count of each named span, and the
    CUDA-event time and bound of each kernel call."""

    def __init__(self):
        import torch

        self.torch = torch
        self.total = {}            # span -> seconds
        self.calls = {}            # span -> calls
        self.kernels = {}          # kernel -> [(start ev, end ev, bound fn)]

    def span(self, name: str):
        torch = self.torch

        def make(fn):
            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.profiler.record_function(SPAN_PREFIX + name):
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
                self.total[name] = (self.total.get(name, 0.0)
                                    + time.perf_counter() - t0)
                self.calls[name] = self.calls.get(name, 0) + 1
                return out
            return timed
        return make

    def kernel(self, name: str, bound_of):
        """A timer around each call: CUDA events on the current stream,
        and bound_of(args, kwargs, out): the call's bound in ms, or a
        function of no arguments that gives it after the window (holding
        only what it needs, so no large tensor outlives the call)."""
        torch = self.torch

        def make(fn):
            def timed(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.kernels.setdefault(name, []).append(
                    (e0, e1, bound_of(a, k, out)))
                return out
            return timed
        return make

    def kernel_totals(self):
        """{kernel: (calls, device seconds, bound seconds)}."""
        self.torch.cuda.synchronize()
        out = {}
        for name, calls in self.kernels.items():
            dev = sum(e0.elapsed_time(e1) for e0, e1, _b in calls) / 1e3
            bnd = sum(b() if callable(b) else b
                      for _e0, _e1, b in calls) / 1e3
            out[name] = (len(calls), dev, bnd)
        return out
