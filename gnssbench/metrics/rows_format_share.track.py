"""The tracking rows less their read-back (the program's span `track.rows`
around track/driver.emit_rows, its self time: less the `track.readback`
inside it): the host counters and each row handed to the caller, who
formats and writes it, over the traced window's wall, in %.  Refines
rows_share.track."""


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
    if got is None or 'track.rows' not in got[0]:
        return None
    return 100.0 * got[0]['track.rows'].self_s / ctx.window_s
