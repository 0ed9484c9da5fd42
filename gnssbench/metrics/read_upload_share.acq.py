"""The acquire CLI's read of the capture: the file read, the int8 upload and its conversion on the card (cli/acquire.read_samples).

Read in the traced run from the benchmark's own span around
gnss_dsp_tpu_torch.cli.acquire.read_samples (synchronised), over the traced window's wall, in %."""

SPANS = [("gnss_dsp_tpu_torch.cli.acquire", "read_samples", "acq.read_samples")]


def read(ctx):
    return ctx.share("acq.read_samples")
