"""The acquisition's uploads (the program's span `upload` in
ops/cplx.from_int8_iq: the copy of the read-only bytes, the pageable
host-to-device copy, the conversion on the card): host seconds over the
traced window's wall, in %.  Refines read_upload_share.acq."""


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
