"""Batched single-process workload runner.

Counterpart: gnss_dsp_tpu/cli/workload.py.  The reference workload
(acquire-all.sh, track-all-gnss-2017-L1L2L5.sh) starts one Python
process a script, 21 acquisitions and 11 tracks, each paying the
runtime's start, the card's initialisation, the kernels' load and a
fresh demux pipe.  This runs the same calls, the same cli.acquire.main
and cli.track.main with the argv the shell scripts build, in one
process: one demux pass over the container, one upload a band shared by
every script on it (the CLIs' x_cache), and each output file holds
exactly the bytes the same CLI call writes without the cache.

    python -m gnss_dsp_tpu_torch.cli.workload acquire-all DATA DEST_DIR
    python -m gnss_dsp_tpu_torch.cli.workload track-all   DATA DEST_DIR
    python -m gnss_dsp_tpu_torch.cli.workload all         DATA DEST_DIR

--device NAME (default cuda, or cpu while GNSS_DSP_CPU is set, named
on stderr once) may stand anywhere and goes to every call.
The stage walls print to stderr.  Both stages run their scripts one
after another.
"""

from __future__ import annotations

import contextlib
import io as _io
import os
import sys
import time

from gnss_dsp_tpu_torch.device import pop_device_arg

_FS = "69984000"
_FRAME = 2 * int(69.984e6 // 1000)      # one band, one 1 ms frame, int8 I/Q

# (band, signal, coffset, outfile): the acquire-all.sh rows, in order
ACQUIRE_ALL = [
    (1, "gps-l1", "-9334875", "acq-gps-l1.dat"),
    (1, "glonass-l1", "17245125", "acq-glonass-l1.dat"),
    (1, "galileo-e1b", "-9334875", "acq-galileo-e1b.dat"),
    (1, "galileo-e1c", "-9334875", "acq-galileo-e1c.dat"),
    (1, "beidou-b1i", "-23656875", "acq-beidou-b1i.dat"),
    (2, "gps-l2cm", "-127126", "acq-gps-l2cm.dat"),
    (2, "glonass-l2", "18272874", "acq-glonass-l2.dat"),
    (2, "glonass-l3ocd", "-25702126", "acq-glonass-l3ocd.dat"),
    (2, "glonass-l3ocp", "-25702126", "acq-glonass-l3ocp.dat"),
    (2, "galileo-e5bi", "-20587126", "acq-galileo-e5bi.dat"),
    (2, "galileo-e5bq", "-20587126", "acq-galileo-e5bq.dat"),
    (2, "beidou-b2i", "-20587126", "acq-beidou-b2i.dat"),
    (3, "gps-l5i", "-15191625", "acq-gps-l5i.dat"),
    (3, "gps-l5q", "-15191625", "acq-gps-l5q.dat"),
    (3, "galileo-e5ai", "-15191625", "acq-galileo-e5ai.dat"),
    (3, "galileo-e5aq", "-15191625", "acq-galileo-e5aq.dat"),
    (3, "glonass-l3ocd", "10383375", "acq-glonass-l3ocd-ch3.dat"),
    (3, "glonass-l3ocp", "10383375", "acq-glonass-l3ocp-ch3.dat"),
    (3, "galileo-e5bi", "15498375", "acq-galileo-e5bi-ch3.dat"),
    (3, "galileo-e5bq", "15498375", "acq-galileo-e5bq-ch3.dat"),
    (3, "beidou-b2i", "15498375", "acq-beidou-b2i-ch3.dat"),
]

# (band, signal, coffset, prn, doppler, code_phase, outfile): the
# track-all-gnss-2017-L1L2L5.sh rows (the 2017-04-27 golden seeds)
TRACK_ALL = [
    (1, "gps-l1", "-9334875", "21", "2400.0", "817.50",
     "track-gps-l1-prn21.dat"),
    (1, "glonass-l1", "17245125", "-3", "-1200.0", "362.82",
     "track-glonass-l1-m3.dat"),
    (1, "galileo-e1b", "-9334875", "24", "250.0", "2838.00",
     "track-galileo-e1b-prn24.dat"),
    (1, "beidou-b1i", "-23656875", "34", "-600.0", "562.20",
     "track-beidou-b1i-prn34.dat"),
    (2, "gps-l2cm", "-127126", "29", "1120.0", "4208.80",
     "track-gps-l2cm-prn29.dat"),
    (2, "glonass-l2", "18272874", "-2", "-1800.0", "470.98",
     "track-glonass-l2-m2.dat"),
    (2, "glonass-l3ocd", "-25702126", "9", "-1800.0", "9429.00",
     "track-glonass-l3ocd-prn9.dat"),
    (2, "galileo-e5bi", "-20587126", "24", "200.0", "7919.00",
     "track-galileo-e5bi-prn24.dat"),
    (2, "beidou-b2i", "-20587126", "14", "-600.0", "1682.90",
     "track-beidou-b2i-prn14.dat"),
    (3, "gps-l5i", "-15191625", "25", "-1600.0", "9696.00",
     "track-gps-l5i-prn25.dat"),
    (3, "galileo-e5ai", "-15191625", "24", "200.0", "7919.00",
     "track-galileo-e5ai-prn24.dat"),
]


def acquire_argv(row, band_path: str) -> list:
    """The argv acquire-all.sh gives the script of an ACQUIRE_ALL row."""
    _band, _signal, coffset, _out = row
    return [band_path, _FS, coffset]


def track_argv(row, band_path: str) -> list:
    """The argv track-all-gnss-2017-L1L2L5.sh gives the script of a
    TRACK_ALL row."""
    _band, _signal, coffset, prn, dop, phase, _out = row
    return [band_path, _FS, coffset, prn, dop, phase]


def demux_bands(data_path: str, dest_dir: str, bands=(1, 2, 3)) -> dict:
    """One pass over the 3-band container -> band{b}.iq int8 files in
    dest_dir (tools/packet2wav_3ch.py's slicing, without a pipe a
    script).  Returns {band: path}."""
    t0 = time.perf_counter()
    paths = {b: os.path.join(dest_dir, f"band{b}.iq") for b in bands}
    with contextlib.ExitStack() as stack:
        outs = {b: stack.enter_context(open(p, "wb"))
                for b, p in paths.items()}
        src = stack.enter_context(open(data_path, "rb"))
        while True:
            frame = src.read(3 * _FRAME)
            if len(frame) < 3 * _FRAME:
                break
            for b in bands:
                outs[b].write(frame[(b - 1) * _FRAME: b * _FRAME])
    print(f"[workload] demux: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return paths


def _check_rc(signal, rc):
    if rc not in (0, None):
        raise RuntimeError(f"workload: {signal} returned {rc}")


def _run_to_file(main_fn, signal, argv, outfile, **kw):
    t0 = time.perf_counter()
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(signal, argv, **kw)
    _check_rc(signal, rc)
    with open(outfile, "w") as f:
        f.write(buf.getvalue())
    print(f"[workload] {os.path.basename(outfile):34s} "
          f"{time.perf_counter() - t0:6.1f} s", file=sys.stderr)


def run_acquire_all(data: str, dest: str, device: str = "cuda") -> None:
    from gnss_dsp_tpu_torch.cli.acquire import main as acquire_main

    os.makedirs(dest, exist_ok=True)
    bands = demux_bands(data, dest)
    t0 = time.perf_counter()
    x_cache: dict = {}       # band file -> the band on the device
    for row in ACQUIRE_ALL:
        _run_to_file(acquire_main, row[1],
                     acquire_argv(row, bands[row[0]]) + ["--device", device],
                     os.path.join(dest, row[3]), x_cache=x_cache)
    print(f"[workload] acquire-all: {len(ACQUIRE_ALL)} scripts in "
          f"{time.perf_counter() - t0:.1f} s (one process)",
          file=sys.stderr)


def run_track_all(data: str, dest: str, device: str = "cuda") -> None:
    from gnss_dsp_tpu_torch.cli.track import main as track_main

    os.makedirs(dest, exist_ok=True)
    bands = demux_bands(data, dest)
    t0 = time.perf_counter()
    # one upload a band, shared by every script on that band
    # (cli.track._preload_chunk)
    x_cache: dict = {}
    for row in TRACK_ALL:
        _run_to_file(track_main, row[1],
                     track_argv(row, bands[row[0]]) + ["--device", device],
                     os.path.join(dest, row[6]), x_cache=x_cache)
    print(f"[workload] track-all: {len(TRACK_ALL)} scripts in "
          f"{time.perf_counter() - t0:.1f} s (one process)",
          file=sys.stderr)


def main(argv=None) -> int:
    device, argv = pop_device_arg(sys.argv[1:] if argv is None else argv,
                                  "workload")
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    what, data = argv[0], argv[1]
    dest = argv[2] if len(argv) > 2 else what.replace("all", "out")
    if what in ("acquire-all", "all"):
        run_acquire_all(data, dest, device)
    if what in ("track-all", "all"):
        run_track_all(data, dest, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
