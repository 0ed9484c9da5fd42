"""Acquisition CLI.

Counterpart: gnss_dsp_tpu/cli/acquire.py:26-211 (`read_samples` with its
`cache`, `_fmt_row`, `main` on every branch, non-coherent, --coherent and
--mesh, FDMA or not, and `_main_serial`).

  python -m gnss_dsp_tpu_torch.cli.acquire SIGNAL [options] input_file sample_rate carrier_offset
  python -m gnss_dsp_tpu_torch.cli.acquire gps-l2cl [options] input_file fs coffset prn doppler l2cm_code_phase
  python -m gnss_dsp_tpu_torch.cli.acquire glonass-l1-p [options] input_file fs coffset chan doppler ca_code_phase

Output rows are the reference workers' (acquire-gps-l1.py:102).  Adds
--device (default cuda, or cpu while GNSS_DSP_CPU is set, as the
reference pins itself; the switch is named on stderr); a CUDA device
that does not exist is an error, never a silent CPU run.
GNSS_DSP_TIMING prints the reference's stage walls to stderr (:111-128,
177-179): "[timing] SIG: read+upload .. frontend .." after the front end
on every branch (the device synchronised first) and "[timing] SIG:
search .." after the default CDMA search's rows; the serial searches
print neither.  The walls are this call's spans (utils/profiling):
read+upload `acquire.read` and `upload`, frontend `frontend`, search from
the front end's end to the rows written; the call is the span
`cli.acquire`.  --coherent M runs the extended-coherent search
(acquire/coherent.py; M = -1: the full overlay length) on every CDMA
signal with an FFT search, on the card through kernel K5 or K6 where the
route takes one (K5 at every window up to GPS L2CM's 163840).  --mesh N
runs the sharded search (parallel/acquire.acquire_signal_sharded) over a
mesh of N devices (N < 0: all), time_shards 2 where N is even: on the
card, the cards torch sees (one card: a 1 x 1 mesh, as in the JAX
package), on the CPU N shards of it (parallel/mesh.cli_devices).
--mesh and --coherent are mutually exclusive, as in the reference.

FDMA signals (GLONASS L1/L2) take --channel in place of --prn and print
"chan" rows (acquire-glonass-l1.py:96-97): all channels in one search
(acquire_signal_fdma; on the card K1), with --coherent one
acquire_signal_coherent(chan=) a channel (K5), with --mesh
parallel/acquire.acquire_signal_fdma_sharded.  The assisted serial
searches (gps-l2cl, glonass-l1-p/l2-p) take the channel or PRN, the
doppler and the parent code phase after the capture, wipe the carrier
offset off the native-rate samples with no front end, and print one
"code_phase metric" row (acquire-gps-l2cl.py:76), the code phase not
reduced mod L.

main(signal, argv, x_cache=dict) is the batched workload runner's call
(cli/workload): each input file's first samples, as many as the
longest call asks for, are uploaded once, as int8 converted on the
device, and every later call on that file slices the device tensor;
the rows are those of the same call without the cache.
"""

from __future__ import annotations

import optparse
import sys

from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
from gnss_dsp_tpu_torch.acquire.engine import (
    acquire_signal, acquire_signal_fdma)
from gnss_dsp_tpu_torch.acquire.serial import serial_search
from gnss_dsp_tpu_torch.device import (
    default_device, pop_device_arg, resolve_device)
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.ops.frontend import mix_long, prepare_baseband
from gnss_dsp_tpu_torch.parallel.acquire import (
    acquire_signal_fdma_sharded, acquire_signal_sharded)
from gnss_dsp_tpu_torch.parallel.mesh import cli_devices, make_mesh
from gnss_dsp_tpu_torch.utils import profiling


def read_samples(filename, n: int, device, cache: dict | None = None):
    """n complex samples from `filename` ("-" = stdin) as complex64 on
    `device` (raw int8 uploaded, converted on the device); None when the
    input is short.  With `cache` (file name -> the file's first samples
    on the device; one device a cache) a file's first n samples are read
    and uploaded once, and each later call for no more slices them
    there; a call for more reads the file again from its start and
    replaces the entry, so an entry never holds more than the longest
    call asked for (a recorded band runs to tens of GB).  The file read
    is the span `acquire.read` (utils/profiling), the upload cplx's
    `upload`."""
    if cache is not None and filename != "-":
        ent = cache.get(filename)
        if ent is None or ent.shape[0] < n:
            ent = read_samples(filename, n, device)
            if ent is None:
                return None
            cache[filename] = ent
        return ent[:n]
    with profiling.span("acquire.read"):
        fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
        z = fp.read(2 * int(n))
        if filename != "-":
            fp.close()
    if len(z) != 2 * int(n):
        return None
    return cplx.from_int8_iq(z, device=device)


def _fmt_row(sig, r) -> str:
    if sig.fdma_hz:
        return "chan % 2d doppler % 7.1f metric % 7.1f code_offset %7.2f" % (
            r.prn, r.doppler, r.metric, r.code_offset)
    if sig.acq_metric == "peak_mean":
        return "prn %3d doppler % 7.1f metric % 5.2f code_offset %6.1f" % (
            r.prn, r.doppler, r.metric, r.code_offset)
    return "prn %3d doppler % 7.1f metric % 7.1f code_offset %7.2f" % (
        r.prn, r.doppler, r.metric, r.code_offset)


def _device_option(parser):
    # --device is taken out of argv by pop_device_arg before parsing, so
    # that it may follow the positionals; the option is here for --help
    parser.add_option("--device", default=default_device(),
                      help="torch device, anywhere on the line "
                      "(default %default)")


@profiling.span("cli.acquire")
def main(signal: str, argv=None, x_cache: dict | None = None) -> int:
    sig = get_signal(signal)
    argv = sys.argv[2:] if argv is None else argv
    if sig.code_table is None:
        raise NotImplementedError(
            f"{signal}: no code table (code windows only), as in the "
            f"reference")
    if sig.acq_serial:
        return _main_serial(sig, argv, x_cache)
    fdma = bool(sig.fdma_hz)
    usage = (f"acquire {signal} [options] input_filename sample_rate "
             "carrier_offset")
    parser = optparse.OptionParser(usage=usage)
    parser.disable_interspersed_args()
    parser.add_option("--channel" if fdma else "--prn", dest="prn",
                      default=sig.prn_default,
                      help="PRNs/channels to search (default %default)")
    parser.add_option("--doppler-search", metavar="MIN,MAX,INCR",
                      default="%g,%g,%g" % sig.doppler_default,
                      help="Doppler search grid (default %default)")
    parser.add_option("--time", type="int", default=sig.acq_ms_default,
                      help="integration time in ms (default %default)")
    parser.add_option("--coherent", type="int", default=0, metavar="M",
                      help="extended-coherent mode: integrate M code "
                      "periods coherently with the secondary overlay "
                      "wiped off (M=-1: full overlay length); needs a "
                      "correspondingly finer --doppler-search grid")
    parser.add_option("--mesh", type="int", default=0, metavar="N",
                      help="shard the search over an N-device mesh (0 = "
                      "single device, -1 = all devices)")
    _device_option(parser)
    device, argv = pop_device_arg(argv, f"acquire {sig.name}")
    options, args = parser.parse_args(argv)
    if len(args) != 3:
        parser.error("expected input_filename sample_rate carrier_offset")
    if options.mesh and options.coherent:
        parser.error("--mesh and --coherent are mutually exclusive")
    dev = resolve_device(device)
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    ms = options.time
    dops = tuple(float(v) for v in options.doppler_search.split(","))
    prns = sig.prns(options.prn)

    # GNSS_DSP_TIMING: the reference's stage walls, read from this call's
    # spans; the front end's span ends with the device synchronised
    with profiling.Timing("frontend") as timed:
        x = read_samples(filename, int((ms + 5) * fs / 1000), dev, x_cache)
        if x is None:
            print("insufficient samples", file=sys.stderr)
            return 1
        xb = prepare_baseband(x, fs, coffset, sig.acq_fs, sig.acq_lowpass_hz,
                              ms + 2)
    if timed.printing:
        print(f"[timing] {signal}: read+upload "
              f"{timed.seconds('acquire.read', 'upload'):.2f}s "
              f"frontend {timed.seconds('frontend'):.2f}s", file=sys.stderr)
    if options.mesh:
        mesh = make_mesh(None if options.mesh < 0 else options.mesh,
                         devices=cli_devices(dev, options.mesh))
        run = acquire_signal_fdma_sharded if fdma else acquire_signal_sharded
        for r in run(sig, xb, prns, mesh, doppler_search=dops, ms=ms):
            print(_fmt_row(sig, r))
        return 0
    if options.coherent:
        m = None if options.coherent < 0 else options.coherent
        # FDMA: one search a channel, its band offset in its oscillators
        searches = [([c], c) for c in prns] if fdma else [(prns, 0)]
        for ids, chan in searches:
            for r in acquire_signal_coherent(sig, xb, ids, dops, m_coh=m,
                                             ms=ms, chan=chan):
                print(_fmt_row(sig, r))
        return 0
    run = acquire_signal_fdma if fdma else acquire_signal
    for r in run(sig, xb, prns, doppler_search=dops, ms=ms):
        print(_fmt_row(sig, r))
    if timed.printing and not fdma:   # the reference times CDMA only
        print(f"[timing] {signal}: search {timed.since('frontend'):.2f}s",
              file=sys.stderr)
    return 0


@profiling.span("cli.acquire")
def _main_serial(sig, argv, x_cache: dict | None = None) -> int:
    fdma = bool(sig.fdma_hz)
    label = "chan" if fdma else "prn"
    parser = optparse.OptionParser(
        usage=f"acquire {sig.name} [options] input_filename sample_rate "
              f"carrier_offset {label} doppler parent_code_phase")
    parser.disable_interspersed_args()
    parser.add_option("--time", type="int",
                      default=40 if sig.acq_serial == 75 else 80,
                      help="integration time in ms (default %default)")
    _device_option(parser)
    device, argv = pop_device_arg(argv, f"acquire {sig.name}")
    options, args = parser.parse_args(argv)
    if len(args) != 6:
        parser.error("expected file fs coffset %s doppler code_phase" % label)
    dev = resolve_device(device)
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    prn, doppler, phase = int(args[3]), float(args[4]), float(args[5])
    ms = options.time

    x = read_samples(filename, int((ms + 2) * fs / 1000), dev, x_cache)
    if x is None:
        print("insufficient samples", file=sys.stderr)
        return 1
    r = serial_search(sig, mix_long(x, -coffset / fs), prn, doppler,
                      parent_code_phase=phase, fs=fs, ms=ms,
                      chan=prn if fdma else 0)
    # the reference's row: code_phase metric (acquire-gps-l2cl.py:76)
    print("%f %f" % (sig.acq_serial_stride * r.k
                     + sig.acq_serial_scale * phase, r.metric))
    return 0


def _entry():
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp_tpu_torch.cli.acquire SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


if __name__ == "__main__":
    _entry()
