"""Entry `track_cli`: one pass after another of the track CLI
(cli/track.main) over one band's capture file with the configured
channels of one signal, rows to a sink; every pass held row for row to
the plain reference pass (gnssbench/workload.Tracking)."""

from __future__ import annotations

import contextlib

from gnssbench.workload import Tracking


class TrackCli(Tracking):
    """cli/track.main on one band with one signal's channels."""
    mixed = False

    def run_pass(self):
        from gnss_dsp_tpu_torch.cli import track as trk_cli

        (b,) = self.bands
        c0 = self.chans[0]
        spec = ",".join(f"{c['prn']}:{c['doppler']}:{c['code_phase']}"
                        for c in self.chans)
        dwells = ",".join(str(int(v)) for v in self.traffic["loop_dwells"])
        argv = ["--loop-dwells", dwells] + list(self.traffic.get("argv", [])) \
            + [self.paths[b], str(int(self.fs)), str(c0["coffset"]), spec,
               "--device", str(self.device)]
        with contextlib.redirect_stdout(self.sink):
            rc = trk_cli.main(c0["signal"], argv)
        self.sink.flush()
        if rc != 0:
            raise RuntimeError(f"track {c0['signal']} exited {rc}")


ENTRY = TrackCli
