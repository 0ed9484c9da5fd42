"""Device time and kernel launches of a call on the card, measured two ways
that check each other.

  profiled_kernels  torch.profiler's CUDA events of `reps` calls: for each
                    kernel or copy, the events the trace kept a call and
                    their mean device time.  The trace has been seen to
                    keep a part of a window's events of a cluster kernel
                    (0.24 a call for a kernel launched once a call), so a
                    caller takes the time only where the share kept is at
                    least KEPT_SHARE.
  graph_ms          CUDA events around replays of a CUDA graph of `calls`
                    calls: the device time a call, each launch's start
                    after the previous one's end included and no host in
                    the way; so at least the kernel's own time.
  graph_nodes       the nodes of a CUDA graph captured from one call
                    (libcuda's graph API): what the call launches, read
                    without the profiler.

Each needs a CUDA card and fn's launches capturable by torch.cuda.graph
(no host synchronisation, no allocation outside torch's allocator).
"""

from __future__ import annotations

import torch

KEPT_SHARE = 0.9


def _capture(fn, calls: int, keep: bool = False):
    """A CUDA graph of `calls` calls of fn, after one eager call on a side
    stream (the build, the caches); with keep, the graph itself is kept
    for reading (not instantiated)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Mean milliseconds a call of fn on the device: CUDA events around
    `reps` replays of a graph of `calls` calls, after one replay."""
    graph = _capture(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (reps * calls)
    del graph
    return ms


# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "KERNEL", 1: "MEMCPY", 2: "MEMSET", 3: "HOST", 4: "GRAPH",
              5: "EMPTY", 6: "WAIT_EVENT", 7: "EVENT_RECORD", 10: "MEM_ALLOC",
              11: "MEM_FREE", 12: "BATCH_MEM_OP", 13: "CONDITIONAL"}


def graph_nodes(fn) -> list:
    """[(node type, mangled kernel name or "")] of a CUDA graph captured
    from one call of fn: what the call launches, read through libcuda's
    graph API (cuGraphGetNodes and friends), without the profiler."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    graph = _capture(fn, 1, keep=True)

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what} returned CUresult {err}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(1, n.value))()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
           "cuGraphNodeGetType")
        name = ""
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: func at word 0, kern at word 7
            params = (ctypes.c_void_p * 16)()
            ok(cu.cuGraphKernelNodeGetParams_v2(node, params),
               "cuGraphKernelNodeGetParams_v2")
            s = ctypes.c_char_p()
            if params[0]:
                ok(cu.cuFuncGetName(ctypes.byref(s),
                                    ctypes.c_void_p(params[0])),
                   "cuFuncGetName")
            else:
                ok(cu.cuKernelGetName(ctypes.byref(s),
                                      ctypes.c_void_p(params[7])),
                   "cuKernelGetName")
            name = s.value.decode()
        out.append((NODE_TYPES.get(kind.value, str(kind.value)), name))
    del graph
    return out


def profiled_kernels(fn, reps: int) -> dict:
    """{name: (events kept a call, mean device ms of those)} of every
    kernel and copy fn launches, from torch.profiler over `reps` calls
    after one warm-up call; the try (of three) whose least share is
    highest, empty where all three traces came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = {e.key: (e.count / reps,
                       e.self_device_time_total / e.count / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count}
        if got and (not best or min(c for c, _ in got.values())
                    > min(c for c, _ in best.values())):
            best = got
        if best and min(c for c, _ in best.values()) >= KEPT_SHARE:
            break
    return best
