"""The acquisition engine's device grid: the doppler mix, the forward FFT, the surface kernel and the per-band reduction (acquire/engine.grid_search).

Read in the traced run from the benchmark's own span around
gnss_dsp_tpu_torch.acquire.engine.grid_search (synchronised), over the traced window's wall, in %."""

SPANS = [("gnss_dsp_tpu_torch.acquire.engine", "grid_search", "acq.grid_search")]


def read(ctx):
    return ctx.share("acq.grid_search")
