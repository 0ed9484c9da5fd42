"""Tracking CLI.

Counterpart: gnss_dsp_tpu/cli/track.py:148-298 (`main`, single signal).

  python -m gnss_dsp_tpu_torch.cli.track SIGNAL [options] input_file \\
      sample_rate carrier_offset prn doppler code_offset
  python -m gnss_dsp_tpu_torch.cli.track SIGNAL [options] input_file \\
      sample_rate carrier_offset prn:doppler:code[,prn:doppler:code...]

Prints one row per tracked block in the reference's 9- or 14-column text
format (track-gps-l1.py:176-177); with several channels each row starts
"ch<prn> ".  Adds --device (default cuda).  Not ported here: unknown-code
recovery, extended-coherent tracking, checkpoint/resume and mesh.
"""

from __future__ import annotations

import optparse
import sys

from gnss_dsp_tpu.models import get_signal
from gnss_dsp_tpu_torch.device import pop_device_arg, resolve_device
from gnss_dsp_tpu_torch.track.driver import (
    TrackChannel, format_row_9, format_row_14, track_file,
)


def main(signal: str, argv=None) -> int:
    sig = get_signal(signal)
    label = "chan" if sig.fdma_hz else "prn"
    parser = optparse.OptionParser(
        usage=f"track {signal} [options] input_filename sample_rate "
              f"carrier_offset {label} doppler code_offset")
    parser.disable_interspersed_args()
    parser.add_option("--loop-dwells", default="500,500",
                      help="wide-FLL,narrow-FLL dwell in ms (default %default)")
    parser.add_option("--carrier-phase",
                      help="initial carrier phase in cycles (PLL from start)")
    parser.add_option("--blocks", type="int", default=0,
                      help="stop after N blocks (0 = run to EOF)")
    parser.add_option("--chunk-ms", type="float", default=2000.0,
                      help="device chunk length in ms (default %default)")
    # --device is taken out of argv by pop_device_arg before parsing, so
    # that it may follow the positionals; the option is here for --help
    parser.add_option("--device", default="cuda",
                      help="torch device, anywhere on the line "
                      "(default %default)")
    device, argv = pop_device_arg(sys.argv[2:] if argv is None else argv)
    options, args = parser.parse_args(argv)
    dwells = tuple(int(v) for v in options.loop_dwells.split(","))
    carrier_phase = (float(options.carrier_phase)
                     if options.carrier_phase is not None else 0.0)
    pll = options.carrier_phase is not None

    if len(args) == 4 and ":" in args[3]:
        filename, fs, coffset = args[0], float(args[1]), float(args[2])
        channels = []
        for spec in args[3].split(","):
            p, d, co = spec.split(":")
            channels.append(TrackChannel(
                prn=int(p), doppler=float(d), code_offset=float(co),
                carrier_phase=carrier_phase, pll_from_start=pll))
    elif len(args) == 6:
        filename, fs, coffset = args[0], float(args[1]), float(args[2])
        channels = [TrackChannel(
            prn=int(args[3]), doppler=float(args[4]),
            code_offset=float(args[5]),
            carrier_phase=carrier_phase, pll_from_start=pll)]
    else:
        parser.error(f"expected file fs coffset {label} doppler code_offset"
                     f" (or file fs coffset prn:dop:code,prn:dop:code,...)")
    dev = resolve_device(device)

    fmt = format_row_14 if sig.row_format == 14 else format_row_9
    multi = len(channels) > 1

    def emit(k, row):
        prefix = f"ch{channels[k].prn} " if multi else ""
        print(prefix + fmt(row))

    # left open: the prefetch thread may still be reading ahead
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    track_file(sig, fp, fs, coffset, channels, loop_dwells=dwells,
               chunk_ms=options.chunk_ms,
               max_blocks=options.blocks or None, emit=emit, device=dev)
    return 0


def _entry():
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp_tpu_torch.cli.track SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


if __name__ == "__main__":
    _entry()
