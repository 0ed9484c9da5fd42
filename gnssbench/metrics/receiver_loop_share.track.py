"""The receiver's own host loop: what track/receiver.track_receiver
spends outside the calls it makes, that is the segment assembly of each
chunk (the bands' buffers grown, a zeroed chunk of every band's segment
filled), the buffers trimmed and the pointers shifted after each scan.

Read in the traced run from the benchmark's own spans (synchronised):
the span around track_receiver, less the spans inside it around the
prefetch reader's take, the upload (ops/cplx.from_iq), the scan
(track_scan, K2 with its set-up) and the rows (emit_rows), over the
traced window's wall, in %."""

SPANS = [("gnss_dsp_tpu_torch.track.receiver", "track_receiver",
          "track.receiver"),
         ("gnss_dsp_tpu_torch.track.receiver", "track_scan",
          "track.receiver_scan"),
         ("gnss_dsp_tpu_torch.track.driver", "_PrefetchReader.take",
          "track.take"),
         ("gnss_dsp_tpu_torch.ops.cplx", "from_iq", "track.from_iq"),
         ("gnss_dsp_tpu_torch.track.receiver", "emit_rows",
          "track.emit_rows")]

INSIDE = ("track.receiver_scan", "track.take", "track.from_iq",
          "track.emit_rows")


def read(ctx):
    total = ctx.spans.total
    if "track.receiver" not in total:
        return None
    rest = total["track.receiver"] - sum(total.get(n, 0.0) for n in INSIDE)
    return 100.0 * rest / ctx.window_s
