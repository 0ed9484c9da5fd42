"""What the traced run reads from torch.profiler: the device's busy time,
the events a kernel kept, the largest device operations and the longest
idle gaps named by the benchmark span the host was in.

`device_busy_us` is a frozen copy of
gnss_dsp_tpu_torch/tools/main_path.device_busy_us at commit 196026d,
unchanged.  The rest is new.
"""

from __future__ import annotations

SPAN_PREFIX = "gnssbench::"


def device_busy_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def union(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(v) for v in out]


def device_events(events):
    """[(name, start_us, end_us)] of every device-side event (kernels,
    copies, sets) among the profiler's events; the benchmark's own
    spans, which the profiler also shows on the device's timeline, are
    not among them."""
    from torch.autograd import DeviceType

    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in events if e.device_type == DeviceType.CUDA
            and not e.name.startswith(SPAN_PREFIX)]


def span_events(events):
    """[(span name, start_us, end_us)] of the benchmark's own host spans
    (record_function names starting with SPAN_PREFIX) among the
    profiler's events."""
    from torch.autograd import DeviceType

    return [(e.name[len(SPAN_PREFIX):], float(e.time_range.start),
             float(e.time_range.end))
            for e in events
            if e.device_type == DeviceType.CPU
            and e.name.startswith(SPAN_PREFIX)]


def top_ops(dev_events, k=10):
    """[[name, seconds]] of the k device operations that took the most
    time in all, largest first."""
    tot = {}
    for name, a, b in dev_events:
        tot[name] = tot.get(name, 0.0) + (b - a)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:120], us / 1e6] for name, us in top]


def idle_gaps(dev_events, spans, t0_us, t1_us, k=10):
    """[[span name, seconds]] of the k longest stretches of [t0_us,
    t1_us] in which no device event ran, each named by the innermost
    benchmark span the host was in at the gap's middle ("window" where
    it was in none)."""
    busy = union((a, b) for _n, a, b in dev_events)
    gaps, at = [], t0_us
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, t1_us)))
        at = max(at, b)
    if at < t1_us:
        gaps.append((at, t1_us))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:k]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        name = min(inner, key=lambda s: s[2] - s[1])[0] if inner \
            else "window"
        out.append([name, (b - a) / 1e6])
    return out
