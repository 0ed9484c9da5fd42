"""The tracking loop's chunk refill less the wait for the reader (the
program's span `track.refill`, its self time: less the `track.read_wait`
inside it): the concatenations of the chunk's bytes, over the traced
window's wall, in %."""


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
    if got is None or 'track.refill' not in got[0]:
        return None
    return 100.0 * got[0]['track.refill'].self_s / ctx.window_s
