"""The tracking uploads' share that went up from pinned memory: the
program's counter `h2d.pinned_bytes` over `h2d.bytes` (every upload's
bytes), in %.  100 where the prefetch reader's staging slots are pinned
and every chunk's new bytes go up from them; 0 where pinning was refused
and the slots are pageable."""


def _counts():
    """The counters the program recorded over the traced window
    (utils/profiling; the profiler is on for exactly the window), or None
    where the program records none."""
    try:
        from gnss_dsp_tpu_torch.utils import profiling

        return profiling.counts()
    except (ImportError, AttributeError):
        return None


def read(ctx):
    got = _counts()
    if got is None or "h2d.pinned_bytes" not in got:
        return None
    nbytes = got.get("h2d.bytes", 0)
    if not nbytes:
        return None
    return 100.0 * got["h2d.pinned_bytes"] / nbytes
