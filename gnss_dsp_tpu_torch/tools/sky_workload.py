"""The reference's full workload on the synthetic three-band sky, checked.

Counterpart: the checks of tools/run_sky_workload.py:26-100 of the
repository root.  The workload is acquire-all.sh followed by
track-all-gnss-2017-L1L2L5.sh: 21 acquisitions and 11 tracks on the 2017
three-band capture at 69.984 MHz.

    python -m gnss_dsp_tpu_torch.tools.sky_workload [--capture PATH]
        [--ms MS] [--cn0 DB] [--out DIR] [--shell] [--device cuda|cpu]
        [--synth-on-device]

main synthesises the capture when it is absent (tools/synth_sky.py in
numpy; with --synth-on-device the same sky's bands on --device,
tools/receiver_sky.synth_bands, interleaved by write_container, which is
much faster at 1.5 s), runs the workload, in one process through cli.workload `all` or, with
--shell, through the port's shell workloads (gnss_dsp_tpu_torch/scripts/
acquire-all.sh and track-all-gnss-2017-L1L2L5.sh, one process a
script), and validates the output directory.  Everything goes under
--out (default _work/sky_workload, inside the checkout), never a fixed
path under /tmp.

validate(dest_dir) reads the 32 output files:
  * ACQ_EXPECT: each acquisition of a planted signal reports, in its row
    of top metric, the seed PRN or FDMA channel within one doppler bin
    of the seed doppler and 1 chip of the seed code phase;
  * TRACK_EXPECT: each track has at least 60 rows, the mean carrier_f of
    its last 20 within 8 Hz of the seed doppler and the prompt above
    early and late;
  * the other ten acquisitions (signals the capture does not carry) have
    one row a PRN or channel searched.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

from gnss_dsp_tpu_torch.cli.workload import ACQUIRE_ALL, TRACK_ALL

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCRIPTS = os.path.join(ROOT, "gnss_dsp_tpu_torch", "scripts")

# acquire-all.sh output file -> (seed PRN or channel, doppler, code phase)
ACQ_EXPECT = {
    "acq-gps-l1.dat": (21, 2400.0, 817.50),
    "acq-glonass-l1.dat": (-3, -1200.0, 362.82),
    "acq-galileo-e1b.dat": (24, 250.0, 2838.00),
    "acq-beidou-b1i.dat": (34, -600.0, 562.20),
    "acq-gps-l2cm.dat": (29, 1120.0, 4208.80),
    "acq-glonass-l2.dat": (-2, -1800.0, 470.98),
    "acq-glonass-l3ocd.dat": (9, -1800.0, 9429.00),
    "acq-galileo-e5bi.dat": (24, 200.0, 7919.00),
    "acq-beidou-b2i.dat": (14, -600.0, 1682.90),
    "acq-gps-l5i.dat": (25, -1600.0, 9696.00),
    "acq-galileo-e5ai.dat": (24, 200.0, 7919.00),
}

# track-all-gnss-2017-L1L2L5.sh output file -> seed doppler
TRACK_EXPECT = {
    "track-gps-l1-prn21.dat": 2400.0,
    "track-glonass-l1-m3.dat": -1200.0,
    "track-galileo-e1b-prn24.dat": 250.0,
    "track-beidou-b1i-prn34.dat": -600.0,
    "track-gps-l2cm-prn29.dat": 1120.0,
    "track-glonass-l2-m2.dat": -1800.0,
    "track-glonass-l3ocd-prn9.dat": -1800.0,
    "track-galileo-e5bi-prn24.dat": 200.0,
    "track-beidou-b2i-prn14.dat": -600.0,
    "track-gps-l5i-prn25.dat": -1600.0,
    "track-galileo-e5ai-prn24.dat": 200.0,
}


def _acq_rows(path):
    """(id, doppler, metric, code) of each row of an acquire output."""
    rows = []
    with open(path) as f:
        for line in f:
            t = line.split()
            rows.append((int(t[1]), float(t[3]), float(t[5]), float(t[7])))
    return rows


def check_acq(dest):
    """(lines, failures) over the 21 acquisition files."""
    from gnss_dsp_tpu_torch.models import get_signal

    lines, fails = [], []
    for _band, signal, _co, fn in ACQUIRE_ALL:
        sig = get_signal(signal)
        rows = _acq_rows(os.path.join(dest, fn))
        if fn not in ACQ_EXPECT:
            ok = len(rows) == len(sig.prns())
            lines.append(f"{fn:28s} {len(rows)} rows (not planted) "
                         f"{'OK' if ok else 'FAIL'}")
        else:
            prn, dop, code = ACQ_EXPECT[fn]
            best = max(rows, key=lambda r: r[2])
            step = sig.doppler_default[2]
            ok = (best[0] == prn and abs(best[1] - dop) <= step
                  and abs(best[3] - code) <= 1.0)
            lines.append(f"{fn:28s} want {prn:3d} dop {dop:7.1f} code "
                         f"{code:8.2f} -> got {best[0]:3d} {best[1]:7.1f} "
                         f"{best[3]:8.2f} metric {best[2]:.2f} "
                         f"{'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(fn)
    return lines, fails


def check_track(dest):
    """(lines, failures) over the 11 track files."""
    lines, fails = [], []
    for fn, dop in TRACK_EXPECT.items():
        rows = np.loadtxt(os.path.join(dest, fn), ndmin=2)
        tail = rows[-20:]
        cf = float(np.mean(tail[:, 3]))
        pr = float(np.mean(tail[:, 7]))
        el = float(np.mean(np.maximum(tail[:, 6], tail[:, 8])))
        ok = len(rows) >= 60 and abs(cf - dop) < 8.0 and pr > el
        lines.append(f"{fn:32s} rows {len(rows):5d} carrier {cf:8.2f} "
                     f"(want {dop:7.1f}) P/EL {pr / max(el, 1e-9):.2f} "
                     f"{'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(fn)
    return lines, fails


def validate(dest_dir):
    """(lines, failures) over the workload's 32 output files in
    dest_dir."""
    la, fa = check_acq(dest_dir)
    lt, ft = check_track(dest_dir)
    return la + lt, fa + ft


def output_files():
    """The workload's 32 output file names, acquisitions first."""
    return ([r[3] for r in ACQUIRE_ALL] + [r[6] for r in TRACK_ALL])


def write_container(paths, out):
    """Interleave the three int8 band files paths[1..3] into the
    container of tools/synth_sky.py (1 ms frames, band after band);
    returns the frame count."""
    from gnss_dsp_tpu_torch.tools.synth_sky import FRAME

    bands = [np.fromfile(paths[b], np.int8).reshape(-1, 2 * FRAME)
             for b in (1, 2, 3)]
    np.stack(bands, axis=1).tofile(out)
    return bands[0].shape[0]


def synth_on_device(out, ms, cn0, device):
    """The container of `ms` ms of the 2017 sky at cn0 dB-Hz, its bands
    synthesised on `device` (tools/receiver_sky.synth_bands)."""
    from gnss_dsp_tpu_torch.tools.receiver_sky import BANDS, synth_bands

    paths = {b: f"{out}.band{b}" for b in BANDS}
    synth_bands(paths, ms / 1000.0, cn0=cn0, device=device)
    frames = write_container(paths, out)
    for p in paths.values():
        os.remove(p)
    return frames


def run_shell(capture, dest, device):
    """The port's two shell workloads, one process a script; each one's
    wall to stderr."""
    for script in ("acquire-all.sh", "track-all-gnss-2017-L1L2L5.sh"):
        t0 = time.perf_counter()
        r = subprocess.run(["sh", os.path.join(SCRIPTS, script), capture,
                            dest, device], capture_output=True, text=True,
                           timeout=21600)
        if r.returncode != 0:
            raise RuntimeError(f"{script}: {r.stderr[-3000:]}")
        print(f"[sky_workload] {script}: {time.perf_counter() - t0:.2f} s "
              f"(one process a script)", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("_work", "sky_workload"))
    ap.add_argument("--capture", default=None,
                    help="the container (default OUT/sky.pcap, synthesised "
                         "when absent)")
    ap.add_argument("--ms", type=int, default=1500)
    ap.add_argument("--cn0", type=float, default=45.0)
    ap.add_argument("--shell", action="store_true",
                    help="run the shell workloads instead of cli.workload")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--synth-on-device", action="store_true",
                    help="synthesise an absent capture on --device")
    args = ap.parse_args(argv)

    from gnss_dsp_tpu_torch.cli import workload
    from gnss_dsp_tpu_torch.tools import synth_sky

    os.makedirs(args.out, exist_ok=True)
    capture = args.capture or os.path.join(args.out, "sky.pcap")
    if not os.path.exists(capture) and args.synth_on_device:
        synth_on_device(capture, args.ms, args.cn0, args.device)
    elif not os.path.exists(capture):
        synth_sky.write_capture(capture, args.ms, args.cn0)
    dest = os.path.join(args.out, "shell" if args.shell else "workload")
    if args.shell:
        run_shell(capture, dest, args.device)
    else:
        workload.main(["all", capture, dest, "--device", args.device])
    lines, fails = validate(dest)
    print("\n".join(lines))
    if fails:
        print("FAILURES:", fails)
        return 1
    print(f"ALL {len(ACQ_EXPECT)} planted acquisitions + "
          f"{len(TRACK_EXPECT)} tracks recovered their golden seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
