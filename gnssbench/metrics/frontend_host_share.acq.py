"""The front end's host time (the program's span `frontend` around
ops/frontend.prepare_baseband: the launches of the wipe-off, the FIR
passes and the resampling): host seconds over the traced window's wall,
in %.  Refines frontend_share.acq, whose outside span synchronises the
card and so also holds the device work."""


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
    if got is None or 'frontend' not in got[0]:
        return None
    return 100.0 * got[0]['frontend'].host_s / ctx.window_s
