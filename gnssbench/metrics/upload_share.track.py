"""The tracking input: the wait for the prefetch reader's bytes
(track/driver._PrefetchReader.take) and the upload of each chunk with its
conversion on the card (ops/cplx.from_iq, which track_file and
track_receiver call).  The receiver's segment assembly between the two
is host code inside track_receiver and is not inside either span.

Read in the traced run from the benchmark's own spans around both
(synchronised), over the traced window's wall, in %."""

SPANS = [("gnss_dsp_tpu_torch.track.driver", "_PrefetchReader.take",
          "track.take"),
         ("gnss_dsp_tpu_torch.ops.cplx", "from_iq", "track.from_iq")]


def read(ctx):
    return ctx.share("track.take", "track.from_iq")
