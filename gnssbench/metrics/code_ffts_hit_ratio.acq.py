"""The code-spectra LRU of the acquisition engine
(acquire/engine.device_code_ffts): hits over lookups in the traced
window (the program's counters `acq.code_ffts.hit` and
`acq.code_ffts.miss`), in %."""


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
    hit = got[1].get("acq.code_ffts.hit", 0)
    miss = got[1].get("acq.code_ffts.miss", 0)
    if hit + miss == 0:
        return None
    return 100.0 * hit / (hit + miss)
