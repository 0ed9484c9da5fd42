"""Tracking CLI.

Counterpart: gnss_dsp_tpu/cli/track.py:148-298 (`main`, single signal).

  python -m gnss_dsp_tpu_torch.cli.track SIGNAL [options] input_file \\
      sample_rate carrier_offset prn doppler code_offset
  python -m gnss_dsp_tpu_torch.cli.track SIGNAL [options] input_file \\
      sample_rate carrier_offset prn:doppler:code[,prn:doppler:code...]

Prints one row per tracked block in the reference's 9- or 14-column text
format (track-gps-l1.py:176-177); with several channels each row starts
"ch<prn> ".  Adds --device (default cuda).  Every signal with a code
table tracks, with its subcarrier, sub-blocks and long code: on the card
kernel K2 runs the whole loop, as the reference routes it; under
GNSS_DSP_NO_FUSED one launch of K3 a block, or of K4 under
GNSS_DSP_PALLAS_V1; --device cpu runs the plain versions.
--coherent M (M = -1: the signal's own overlay length) tracks with
M-period extended-coherent integration on every route, --overlay-phase
the overlay chip of the first tracked code period (from coherent
acquisition); sub-divided signals refuse it, as in the reference.
--mesh N shards the channels over an N-device mesh (N < 0: all devices;
time_shards 1), padding them to a multiple of it: on the card, the cards
torch sees (one card: a 1 x 1 mesh), on the CPU N shards of it
(parallel/mesh.cli_devices); it composes with --coherent on K2.
Not ported here: unknown-code recovery (beidou-b2bi/b2bq raise
NotImplementedError), checkpoint/resume and the mixed-signal `multi`
mode.
"""

from __future__ import annotations

import optparse
import sys

from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.device import pop_device_arg, resolve_device
from gnss_dsp_tpu_torch.parallel.mesh import cli_devices, make_mesh
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
    parser.add_option("--coherent", type="int", default=1, metavar="M",
                      help="extended-coherent tracking: accumulate "
                           "secondary-wiped complex E/P/L over M code "
                           "periods, loop updates at the M boundary; "
                           "-1 = the signal's own overlay length "
                           "(sub-divided signals excluded)")
    parser.add_option("--overlay-phase", type="int", default=0,
                      help="secondary-overlay chip index of the first "
                           "tracked code period (from coherent "
                           "acquisition; default %default)")
    parser.add_option("--chunk-ms", type="float", default=2000.0,
                      help="device chunk length in ms (default %default)")
    parser.add_option("--mesh", type="int", default=0, metavar="N",
                      help="shard channels over an N-device mesh (0 = "
                      "single device, -1 = all devices; channel count "
                      "padded up to the mesh)")
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
                carrier_phase=carrier_phase, pll_from_start=pll,
                overlay_phase=options.overlay_phase))
    elif len(args) == 6:
        filename, fs, coffset = args[0], float(args[1]), float(args[2])
        channels = [TrackChannel(
            prn=int(args[3]), doppler=float(args[4]),
            code_offset=float(args[5]),
            carrier_phase=carrier_phase, pll_from_start=pll,
            overlay_phase=options.overlay_phase)]
    else:
        parser.error(f"expected file fs coffset {label} doppler code_offset"
                     f" (or file fs coffset prn:dop:code,prn:dop:code,...)")
    if options.coherent > 1 and sig.sub_blocks != 1:
        parser.error(f"--coherent needs a whole-period signal; "
                     f"{signal} tracks in {sig.sub_blocks} sub-blocks")
    dev = resolve_device(device)
    mesh = None
    if options.mesh:
        mesh = make_mesh(None if options.mesh < 0 else options.mesh,
                         time_shards=1,
                         devices=cli_devices(dev, options.mesh))

    fmt = format_row_14 if sig.row_format == 14 else format_row_9
    multi = len(channels) > 1

    def emit(k, row):
        prefix = f"ch{channels[k].prn} " if multi else ""
        print(prefix + fmt(row))

    # left open: the prefetch thread may still be reading ahead
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    track_file(sig, fp, fs, coffset, channels, loop_dwells=dwells,
               chunk_ms=options.chunk_ms,
               max_blocks=options.blocks or None, emit=emit, device=dev,
               coherent_blocks=options.coherent, mesh=mesh)
    return 0


def _entry():
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp_tpu_torch.cli.track SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


if __name__ == "__main__":
    _entry()
