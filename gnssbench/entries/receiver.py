"""Entry `receiver`: one pass after another of
track/receiver.track_receiver over every band's capture file, the
configured channels, rows in the track CLI's text format to a sink;
every pass held row for row to the plain reference pass
(gnssbench/workload.Tracking)."""

from __future__ import annotations

import contextlib

from gnssbench.workload import Tracking


class Receiver(Tracking):
    """track/receiver.track_receiver over every band."""

    def run_pass(self):
        from gnss_dsp_tpu_torch.models import get_signal
        from gnss_dsp_tpu_torch.track.driver import (
            TrackChannel, format_row_9, format_row_14)
        from gnss_dsp_tpu_torch.track.receiver import track_receiver

        keys, fmts = [], []
        with contextlib.ExitStack() as stack:
            args = []
            for b in self.bands:
                chs = [c for c in self.chans if int(c["band"]) == b]
                fp = stack.enter_context(open(self.paths[b], "rb"))
                sigs = [get_signal(c["signal"]) for c in chs]
                args.append((fp, sigs,
                             [TrackChannel(prn=int(c["prn"]),
                                           doppler=float(c["doppler"]),
                                           code_offset=float(c["code_phase"]))
                              for c in chs],
                             [float(c["coffset"]) for c in chs]))
                keys += [f"{c['signal']}:{c['prn']} " for c in chs]
                fmts += [format_row_14 if s.row_format == 14 else format_row_9
                         for s in sigs]

            def emit(k, row):
                self.sink.write(keys[k] + fmts[k](row) + "\n")
            track_receiver(args, self.fs,
                           loop_dwells=tuple(self.traffic["loop_dwells"]),
                           chunk_ms=float(self.traffic["chunk_ms"]),
                           emit=emit, device=self.device)
        self.sink.flush()


ENTRY = Receiver
