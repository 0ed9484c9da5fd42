"""The pageable uploads' bandwidth in tracking: the bytes handed to the
card (the program's counter `h2d.bytes`) over the stream seconds of the
`upload` spans (a CUDA event pair each, around the copy and the
conversion), in GB/s."""


def _program():
    """(span totals, counters) the program recorded over the traced
    window (utils/profiling; the profiler is on for exactly the window),
    or None where the program records none."""
    try:
        from gnss_dsp_tpu_torch.utils import profiling

        return profiling.totals(), profiling.counts()
    except (ImportError, AttributeError):
        return None


def read(ctx):
    got = _program()
    if got is None:
        return None
    up, nbytes = got[0].get("upload"), got[1].get("h2d.bytes", 0)
    if up is None or not up.stream_s or not nbytes:
        return None
    return nbytes / up.stream_s / 1e9
