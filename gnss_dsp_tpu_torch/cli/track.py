"""Tracking CLI.

Counterpart: gnss_dsp_tpu/cli/track.py (`_preload_chunk` :25-55, `main`
:148-298, `main_multi` :57-147).

  python -m gnss_dsp_tpu_torch.cli.track SIGNAL [options] input_file \\
      sample_rate carrier_offset prn doppler code_offset
  python -m gnss_dsp_tpu_torch.cli.track SIGNAL [options] input_file \\
      sample_rate carrier_offset prn:doppler:code[,prn:doppler:code...]
  python -m gnss_dsp_tpu_torch.cli.track multi [options] input_file \\
      sample_rate carrier_offset \\
      SIG:prn:doppler:code[:coffset[:overlay_phase]][,...]

Prints one row per tracked block in the reference's 9- or 14-column text
format (track-gps-l1.py:176-177); with several channels each row starts
"ch<prn> ", under `multi` "SIG:prn " in each signal's own format.  Adds
--device (default cuda, or cpu while GNSS_DSP_CPU is set, as the
reference pins itself; the switch is named on stderr).  Every signal
with a code table tracks, with its subcarrier, sub-blocks and long
code: on the card kernel K2 runs the whole loop, as the reference routes
it; under GNSS_DSP_NO_FUSED one launch of K3 a block, or of K4 under
GNSS_DSP_PALLAS_V1; --device cpu runs the plain versions.  `multi` tracks channels of different signals
in one scan (one K2 launch a chunk), each with its own carrier offset
(the fifth field, default the carrier_offset argument).
--coherent M (M = -1: each signal's own overlay length) tracks with
M-period extended-coherent integration on every route, --overlay-phase
the overlay chip of the first tracked code period (from coherent
acquisition); sub-divided signals refuse it, as in the reference.
--mesh N shards the channels over an N-device mesh (N < 0: all devices;
time_shards 1), padding them to a multiple of it: on the card, the cards
torch sees (one card: a 1 x 1 mesh), on the CPU N shards of it
(parallel/mesh.cli_devices); it composes with --coherent on K2.
--checkpoint FILE writes the loop state after every chunk, --resume FILE
goes on from it bit for bit (a seekable file, not stdin).  --recover
(the default for beidou-b2bi and b2bq; --no-recover turns it off) sums
the data-wiped samples into per-chip bins after --recover-warmup blocks
on the plain scan, the reference's route for it, and writes them to
--recover-file as "%f %f" rows (under `multi`, RECOVER_FILE-SIG-PRN.ext
a channel).

main(signal, argv, x_cache=dict) is the batched
workload runner's call (cli/workload): a file of at most one --chunk-ms
chunk is uploaded once (_preload_chunk) and tracked in single-chunk mode
(track/driver.track_file's `preloaded`); not under --mesh, --checkpoint
or --resume, nor from stdin.  The rows are those of the same call
without the cache.  A call is the span `cli.track` (utils/profiling).
"""

from __future__ import annotations

import optparse
import os
import sys

import numpy as np

from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.device import (
    default_device, pop_device_arg, resolve_device)
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.parallel.mesh import cli_devices, make_mesh
from gnss_dsp_tpu_torch.track.driver import (
    TrackChannel, format_row_9, format_row_14, track_file,
)
from gnss_dsp_tpu_torch.utils import profiling


def _preload_chunk(path: str, fs: float, chunk_ms: float, cache: dict, *,
                   device):
    """(x, n): the whole file `path` on `device` as complex64, zero-padded
    for every family's margins, shared across CLI calls through `cache`
    (file name -> (x, n); one device a cache), uploaded once; None when the file is longer than one chunk (the streaming
    reader takes it).  The pad is int(fs * 0.006) + 16384 samples, then
    up to a multiple of 1024."""
    n = os.path.getsize(path) // 2
    if n > int(fs * chunk_ms / 1000.0):
        return None
    if path not in cache:
        raw = np.fromfile(path, np.int8, count=2 * n)
        pad = int(fs * 0.006) + 16384
        pad += (-(n + pad)) % 1024
        cache[path] = (cplx.from_int8_iq(raw, pad=pad, device=device), n)
    return cache[path]


def _common_options(parser):
    parser.add_option("--loop-dwells", default="500,500",
                      help="wide-FLL,narrow-FLL dwell in ms (default %default)")
    parser.add_option("--blocks", type="int", default=0,
                      help="stop after N blocks (0 = run to EOF)")
    parser.add_option("--chunk-ms", type="float", default=2000.0,
                      help="device chunk length in ms (default %default; "
                           "also the checkpoint cadence)")
    parser.add_option("--recover-warmup", type="int", default=200,
                      help="blocks to track before accumulating "
                           "(default %default, track-beidou-b2bi.py:47)")
    parser.add_option("--recover-file", default="track-chips.dat",
                      help="recovered-bins output path (default %default)")
    parser.add_option("--mesh", type="int", default=0, metavar="N",
                      help="shard channels over an N-device mesh (0 = "
                      "single device, -1 = all devices; channel count "
                      "padded up to the mesh)")
    # --device is taken out of argv by pop_device_arg before parsing, so
    # that it may follow the positionals; the option is here for --help
    parser.add_option("--device", default=default_device(),
                      help="torch device, anywhere on the line "
                      "(default %default)")


def _mesh(options, dev):
    if not options.mesh:
        return None
    return make_mesh(None if options.mesh < 0 else options.mesh,
                     time_shards=1, devices=cli_devices(dev, options.mesh))


def _write_bins(path, bins):
    # the reference dumps the raw complex bins, one "%f %f" row a chip
    # (track-beidou-b2bi.py:181-184)
    with open(path, "w") as f:
        for v in bins:
            f.write("%f %f\n" % (v.real, v.imag))


@profiling.span("cli.track")
def main_multi(argv=None, x_cache: dict | None = None) -> int:
    """Channels of different signals in one scan over one stream:

      track multi [options] input_file sample_rate carrier_offset \\
          SIG:prn:doppler:code[:coffset[:overlay_phase]][,...]

    Rows print with a "SIG:prn " prefix in each signal's 9- or 14-column
    format.  --recover recovers every channel's code in the one pass
    (bins in RECOVER_FILE-SIG-PRN.ext)."""
    parser = optparse.OptionParser(
        usage="track multi [options] input_filename sample_rate "
              "carrier_offset SIG:prn:doppler:code[,SIG:prn:doppler:code]")
    parser.disable_interspersed_args()
    _common_options(parser)
    parser.add_option("--coherent", type="int", default=1, metavar="M",
                      help="extended-coherent tracking per channel: -1 "
                      "integrates each signal's own overlay length "
                      "(overlay-free signals stay non-coherent); an "
                      "explicit M applies to every channel")
    parser.add_option("--recover", action="store_true", default=False,
                      help="unknown-code recovery for every channel; bins "
                           "land in RECOVER_FILE-SIG-PRN.dat per channel")
    device, argv = pop_device_arg(sys.argv[2:] if argv is None else argv,
                                  "track multi")
    options, args = parser.parse_args(argv)
    if len(args) != 4:
        parser.error("expected file fs coffset SIG:prn:dop:code[,...]")
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    sigs, channels, coffsets = [], [], []
    for spec in args[3].split(","):
        parts = spec.split(":")
        if not 4 <= len(parts) <= 6:
            parser.error(f"bad channel {spec!r}: SIG:prn:doppler:code"
                         f"[:coffset[:overlay_phase]]")
        name, p, d, co = parts[:4]
        sigs.append(get_signal(name))
        channels.append(TrackChannel(
            prn=int(p), doppler=float(d), code_offset=float(co),
            overlay_phase=int(parts[5]) if len(parts) > 5 else 0))
        coffsets.append(float(parts[4]) if len(parts) > 4 else coffset)
    dwells = tuple(int(v) for v in options.loop_dwells.split(","))
    dev = resolve_device(device)
    mesh = _mesh(options, dev)
    fmts = [format_row_14 if s.row_format == 14 else format_row_9
            for s in sigs]

    def emit(k, row):
        print(f"{sigs[k].name}:{channels[k].prn} " + fmts[k](row))

    preloaded = None
    if x_cache is not None and filename != "-" and mesh is None:
        preloaded = _preload_chunk(filename, fs, options.chunk_ms, x_cache,
                                   device=dev)
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    track_file(sigs[0], fp, fs, coffset, channels, loop_dwells=dwells,
               chunk_ms=options.chunk_ms,
               max_blocks=options.blocks or None, emit=emit, device=dev,
               coherent_blocks=options.coherent, mesh=mesh,
               recover_after=(options.recover_warmup if options.recover
                              else -1),
               sigs=sigs, coffsets=coffsets, preloaded=preloaded)
    if options.recover:
        base, ext = os.path.splitext(options.recover_file)
        for s, ch in zip(sigs, channels):
            _write_bins(f"{base}-{s.name}-{ch.prn}{ext}",
                        ch.recovered[: s.code_length])
    return 0


@profiling.span("cli.track")
def main(signal: str, argv=None, x_cache: dict | None = None) -> int:
    if signal == "multi":
        return main_multi(argv, x_cache)
    sig = get_signal(signal)
    label = "chan" if sig.fdma_hz else "prn"
    parser = optparse.OptionParser(
        usage=f"track {signal} [options] input_filename sample_rate "
              f"carrier_offset {label} doppler code_offset")
    parser.disable_interspersed_args()
    _common_options(parser)
    parser.add_option("--carrier-phase",
                      help="initial carrier phase in cycles (PLL from start)")
    parser.add_option("--recover", action="store_true", default=None,
                      help="unknown-code recovery: accumulate data-wiped "
                           "samples into per-chip bins and write them to "
                           "--recover-file at EOF (default on for B2b, "
                           "as in track-beidou-b2bi.py:47-53)")
    parser.add_option("--no-recover", action="store_true", default=False,
                      help="disable unknown-code recovery")
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
    parser.add_option("--checkpoint", metavar="FILE", default=None,
                      help="save resumable loop state to FILE after every "
                           "device chunk (atomic)")
    parser.add_option("--resume", metavar="FILE", default=None,
                      help="resume from a --checkpoint file (input must be "
                           "a seekable file, not a pipe); continues "
                           "bit-exactly and re-emits from the checkpointed "
                           "block")
    device, argv = pop_device_arg(sys.argv[2:] if argv is None else argv,
                                  f"track {signal}")
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
    if options.no_recover:
        recover_after = -1
    elif options.recover:
        recover_after = options.recover_warmup
    else:
        recover_after = options.recover_warmup if sig.recover_default else -1
    if options.resume and filename == "-":
        parser.error("--resume needs a seekable input file, not stdin")
    if options.coherent > 1 and sig.sub_blocks != 1:
        parser.error(f"--coherent needs a whole-period signal; "
                     f"{signal} tracks in {sig.sub_blocks} sub-blocks")
    dev = resolve_device(device)
    mesh = _mesh(options, dev)

    fmt = format_row_14 if sig.row_format == 14 else format_row_9
    multi = len(channels) > 1

    def emit(k, row):
        prefix = f"ch{channels[k].prn} " if multi else ""
        print(prefix + fmt(row))

    preloaded = None
    if (x_cache is not None and filename != "-" and mesh is None
            and options.checkpoint is None and options.resume is None):
        preloaded = _preload_chunk(filename, fs, options.chunk_ms, x_cache,
                                   device=dev)
    # left open: the prefetch thread may still be reading ahead
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    track_file(sig, fp, fs, coffset, channels, loop_dwells=dwells,
               chunk_ms=options.chunk_ms,
               max_blocks=options.blocks or None, emit=emit, device=dev,
               coherent_blocks=options.coherent, mesh=mesh,
               recover_after=recover_after,
               checkpoint_path=options.checkpoint,
               resume_from=options.resume, preloaded=preloaded)
    if recover_after >= 0:
        _write_bins(options.recover_file, channels[0].recovered)
    return 0


def _entry():
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp_tpu_torch.cli.track SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


if __name__ == "__main__":
    _entry()
