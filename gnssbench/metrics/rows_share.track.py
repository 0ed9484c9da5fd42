"""The tracking rows: each scan's rows read back from the card, the
host counters, and each row handed to the caller, who formats and writes
it (track/driver.emit_rows, looked up by track_file in track/driver and
by track_receiver in track/receiver).

Read in the traced run from the benchmark's own spans around both
(synchronised), over the traced window's wall, in %."""

SPANS = [("gnss_dsp_tpu_torch.track.driver", "emit_rows", "track.emit_rows"),
         ("gnss_dsp_tpu_torch.track.receiver", "emit_rows",
          "track.emit_rows")]


def read(ctx):
    return ctx.share("track.emit_rows")
