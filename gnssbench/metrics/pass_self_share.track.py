"""What a tracking pass spends outside every span inside it: the self
time of the program's pass spans (`cli.track` and `track.file` in the
track CLI, `track.receiver` in the receiver), summed, over the traced
window's wall, in %.  That is the CLI's argument parsing, the chunks'
rebase and pointer shifts, and the waits of the harness's own
synchronising spans around the calls inside."""


def _program():
    """(span totals, counters) the program recorded over the traced
    window (utils/profiling; the profiler is on for exactly the window),
    or None where the program records none."""
    try:
        from gnss_dsp_tpu_torch.utils import profiling

        return profiling.totals(), profiling.counts()
    except (ImportError, AttributeError):
        return None

PASS = ("cli.track", "track.file", "track.receiver")


def read(ctx):
    got = _program()
    if got is None or not any(n in got[0] for n in PASS):
        return None
    own = sum(got[0][n].self_s for n in PASS if n in got[0])
    return 100.0 * own / ctx.window_s
