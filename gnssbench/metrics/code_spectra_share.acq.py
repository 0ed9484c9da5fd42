"""The code spectra's host build on a miss of the acquisition engine's
LRU (the program's span `acq.code_spectra` in
acquire/engine.device_code_ffts: numpy's float64 build and the upload):
host seconds over the traced window's wall, in %."""


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
    if got is None or "acq.code_spectra" not in got[0]:
        return None
    return 100.0 * got[0]["acq.code_spectra"].host_s / ctx.window_s
