"""The tracking loop's wait for the prefetch reader's bytes (the program's
span `track.read_wait` in track/driver._PrefetchReader.take): host
seconds over the traced window's wall, in %.  Refines the take half of
upload_share.track."""


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
    if got is None or 'track.read_wait' not in got[0]:
        return None
    return 100.0 * got[0]['track.read_wait'].host_s / ctx.window_s
