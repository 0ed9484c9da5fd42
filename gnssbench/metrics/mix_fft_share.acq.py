"""The acquisition engine's doppler mix and forward FFT (the program's
span `acq.mix_fft` around acquire/engine.mix_fft, with a CUDA event
pair): stream seconds over the traced window's wall, in %."""


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
    if got is None or "acq.mix_fft" not in got[0]:
        return None
    stream_s = got[0]["acq.mix_fft"].stream_s
    return None if stream_s is None else 100.0 * stream_s / ctx.window_s
