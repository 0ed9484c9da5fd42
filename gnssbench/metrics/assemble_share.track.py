"""The receiver's segmented chunk, zeroed and filled with every band's
bytes (the program's span `track.assemble` in
track/receiver.track_receiver): host seconds over the traced window's
wall, in %.  Refines receiver_loop_share.track."""


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
    if got is None or 'track.assemble' not in got[0]:
        return None
    return 100.0 * got[0]['track.assemble'].host_s / ctx.window_s
