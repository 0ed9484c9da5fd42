"""The coherent searches that took the spec route (kernel K5): the
program's counter `acq.route.coh_spec` over all its `acq.route.coh_*`
counters (spec, blk: K6, xla: the plain-torch engine), one a search, in
%.  None where the program counts no coherent route (a tree before the
counters)."""


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
    routes = sum(v for k, v in got.items() if k.startswith("acq.route.coh_"))
    if not routes:
        return None
    return 100.0 * got.get("acq.route.coh_spec", 0) / routes
