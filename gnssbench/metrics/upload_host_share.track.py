"""The tracking uploads (the program's span `upload` in ops/cplx: the
pageable host-to-device copy of each chunk and its conversion on the
card): host seconds over the traced window's wall, in %.  Refines the
upload half of upload_share.track."""


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
    if got is None or 'upload' not in got[0]:
        return None
    return 100.0 * got[0]['upload'].host_s / ctx.window_s
