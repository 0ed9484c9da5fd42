"""A tracking pass's set-up (the program's spans `track.setup`: the
channels' set-up, first boundaries, loop state and prefetch readers
started): host seconds over the traced window's wall, in %."""


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
    if got is None or 'track.setup' not in got[0]:
        return None
    return 100.0 * got[0]['track.setup'].host_s / ctx.window_s
