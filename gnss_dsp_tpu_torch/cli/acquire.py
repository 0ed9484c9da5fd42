"""Acquisition CLI.

Counterpart: gnss_dsp_tpu/cli/acquire.py:26-180 (`read_samples`,
`_fmt_row`, and `main` on the single-signal branches, non-coherent and
--coherent).

  python -m gnss_dsp_tpu_torch.cli.acquire SIGNAL [options] input_file sample_rate carrier_offset

Output rows are the reference workers' (acquire-gps-l1.py:102).  Adds
--device (default cuda); a CUDA device that does not exist is an error,
never a silent CPU run.  --coherent M runs the extended-coherent search
(acquire/coherent.py; M = -1: the full overlay length) on every CDMA
signal with an FFT search, on the card through kernel K5 or K6 where the
route takes one (K5 at every window up to GPS L2CM's 163840).  Not ported
here: FDMA and serial searches (they raise NotImplementedError) and the
sharded --mesh search (the option is unknown here).
"""

from __future__ import annotations

import optparse
import sys

from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
from gnss_dsp_tpu_torch.acquire.engine import acquire_signal
from gnss_dsp_tpu_torch.device import pop_device_arg, resolve_device
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.ops.frontend import prepare_baseband


def read_samples(filename, n: int, device):
    """n complex samples from `filename` ("-" = stdin) as complex64 on
    `device` (raw int8 uploaded, converted on the device); None when the
    input is short."""
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    z = fp.read(2 * int(n))
    if filename != "-":
        fp.close()
    if len(z) != 2 * int(n):
        return None
    return cplx.from_int8_iq(z, device=device)


def _fmt_row(sig, r) -> str:
    if sig.acq_metric == "peak_mean":
        return "prn %3d doppler % 7.1f metric % 5.2f code_offset %6.1f" % (
            r.prn, r.doppler, r.metric, r.code_offset)
    return "prn %3d doppler % 7.1f metric % 7.1f code_offset %7.2f" % (
        r.prn, r.doppler, r.metric, r.code_offset)


def main(signal: str, argv=None) -> int:
    sig = get_signal(signal)
    if sig.acq_serial or sig.fdma_hz:
        raise NotImplementedError(
            f"{signal}: serial and FDMA searches are not ported yet")
    usage = (f"acquire {signal} [options] input_filename sample_rate "
             "carrier_offset")
    parser = optparse.OptionParser(usage=usage)
    parser.disable_interspersed_args()
    parser.add_option("--prn", dest="prn", default=sig.prn_default,
                      help="PRNs to search (default %default)")
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
    # --device is taken out of argv by pop_device_arg before parsing, so
    # that it may follow the positionals; the option is here for --help
    parser.add_option("--device", default="cuda",
                      help="torch device, anywhere on the line "
                      "(default %default)")
    device, argv = pop_device_arg(sys.argv[2:] if argv is None else argv)
    options, args = parser.parse_args(argv)
    if len(args) != 3:
        parser.error("expected input_filename sample_rate carrier_offset")
    dev = resolve_device(device)
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    ms = options.time
    dops = tuple(float(v) for v in options.doppler_search.split(","))
    prns = sig.prns(options.prn)

    x = read_samples(filename, int((ms + 5) * fs / 1000), dev)
    if x is None:
        print("insufficient samples", file=sys.stderr)
        return 1
    xb = prepare_baseband(x, fs, coffset, sig.acq_fs, sig.acq_lowpass_hz,
                          ms + 2)
    if options.coherent:
        m = None if options.coherent < 0 else options.coherent
        for r in acquire_signal_coherent(sig, xb, prns, dops, m_coh=m,
                                         ms=ms):
            print(_fmt_row(sig, r))
        return 0
    for r in acquire_signal(sig, xb, prns, doppler_search=dops, ms=ms):
        print(_fmt_row(sig, r))
    return 0


def _entry():
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp_tpu_torch.cli.acquire SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


if __name__ == "__main__":
    _entry()
