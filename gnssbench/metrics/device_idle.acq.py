"""The device's idle share of the traced window: 1 - busy / wall, in %,
busy the union of the device intervals in the torch.profiler trace of
the window (gnssbench/devtrace.device_busy_us).  Where the trace kept
fewer than 0.9 of a timed kernel's launches, busy is the union of the
other device events plus that kernel's CUDA-event time (the harness's
trace reading says which)."""


def read(ctx):
    return ctx.idle()
