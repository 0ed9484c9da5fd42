"""K5's launches on its batched core: the program's counter
`acq.k5.core.batched` (launches of ops/acquire_coh.corr_surface_coh_spec
on the card at W = 16384, csrc/acquire_coh_spec.cu's
coh_spec_kernel_batch) over it plus `acq.k5.core.other` (K5's launches
on any other core), in %.  None where the program counts neither (a tree
before the counters) or no K5 launch."""


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
    batched = got.get("acq.k5.core.batched", 0)
    launches = batched + got.get("acq.k5.core.other", 0)
    if not launches:
        return None
    return 100.0 * batched / launches
