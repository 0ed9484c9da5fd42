"""The tracking rows written in bulk: the program's counter
`track.rows.bulk` (rows a track/rows.RowText emit wrote a scan at a
time, formatted on the card) over it plus `track.rows.each` (rows
taken one at a time: any other emit, rows kept on the channels, a
RowText off the card, a scan with a field past the fixed-point range),
in %.
100 in the track CLI; 0 in the receiver's entry, which hands emit_rows
its own per-row emit.  None where the program counts neither (a tree
before the counters) or no row."""


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
    if got is None:
        return None
    bulk = got.get("track.rows.bulk", 0)
    rows = bulk + got.get("track.rows.each", 0)
    if not rows:
        return None
    return 100.0 * bulk / rows
