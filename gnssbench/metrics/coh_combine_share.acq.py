"""The coherent search's overlay combine (the program's span
`acq.coh.combine` in acquire/coherent.grid_search_coherent_fast, with a
CUDA event pair: each doppler chunk's combine of the per-block spectra
into the (group, alignment) rows K5 takes): stream seconds over the
traced window's wall, in %.  None where the program records no such span
(a tree before it)."""


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
    if got is None or "acq.coh.combine" not in got[0]:
        return None
    stream_s = got[0]["acq.coh.combine"].stream_s
    return None if stream_s is None else 100.0 * stream_s / ctx.window_s
