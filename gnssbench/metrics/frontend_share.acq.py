"""The front end: carrier wipe-off, the FIR filtfilt and the resampling to the internal rate (ops/frontend.prepare_baseband, as cli/acquire calls it).

Read in the traced run from the benchmark's own span around
gnss_dsp_tpu_torch.cli.acquire.prepare_baseband (synchronised), over the traced window's wall, in %."""

SPANS = [("gnss_dsp_tpu_torch.cli.acquire", "prepare_baseband", "acq.prepare_baseband")]


def read(ctx):
    return ctx.share("acq.prepare_baseband")
