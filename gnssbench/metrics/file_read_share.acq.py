"""The acquire CLI's file read of each capture (the program's span
`acquire.read` in cli/acquire.read_samples, cached branch too): its host
seconds over the traced window's wall, in %.  Refines
read_upload_share.acq, whose outside span also holds the upload."""


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
    if got is None or 'acquire.read' not in got[0]:
        return None
    return 100.0 * got[0]['acquire.read'].host_s / ctx.window_s
