"""The GPS L1 main path as one scenario, and a profile of it on the card.

    python -m gnss_dsp_tpu_torch.tools.main_path [--out DIR]

synth_capture writes a synthetic GPS L1 capture (eight satellites at
45 dB-Hz, int8 I/Q); run_cli calls a CLI's main() in this process and
returns what it printed.  chip_smoke.py uses both.

Run as a program on a CUDA card, this module drives the acquire CLI and
then the track CLI on chip_smoke.py's capture (2.2 s at 8.184 MHz,
2150 tracked blocks), each once cold and once warm under
torch.profiler with CUDA activity.  It prints one JSON object: per stage
the cold and warm host walls, the device busy time (the union of the
trace's device events: kernels and copies), the idle share
1 - busy / warm wall, and the costliest device events; then the
nvidia-smi name and power limit.  Chrome traces go to DIR (default
chiprun_out/).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

E2E_PRNS = (3, 8, 12, 17, 21, 24, 28, 31)
E2E_DOPS = (-5437.0, -3811.0, -2206.0, -577.0, 1049.0, 2633.0, 4188.0, 5794.0)


def synth_capture(path, fs, seconds, seed=7):
    """Eight GPS L1 satellites summed noiselessly plus ONE noise array at
    45 dB-Hz per satellite, written to `path` as int8 I/Q.  Returns the
    truth: prns, dops, phases (chips), the clip fraction and the scale."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l1")
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    phases = rng.permutation(np.arange(40.0, 1000.0, 117.0))[:8] + 0.37
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in zip(E2E_PRNS, E2E_DOPS, phases):
        x += synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                      sig.chip_rate, fs, n, doppler_hz=dop, code_phase=cp,
                      cn0_dbhz=None, carrier_ratio=sig.carrier_ratio)
    sigma = np.sqrt(fs / (2.0 * 10 ** (45.0 / 10.0)))
    x += (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    scale = 127.0 / (4.0 * float(np.std(x.real)))
    clip = float(np.mean((np.abs(x.real * scale) > 127.5)
                         | (np.abs(x.imag * scale) > 127.5)))
    if clip >= 1e-3:
        raise RuntimeError(f"int8 quantisation clips {clip:.2e} of samples")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=scale))
    return dict(prns=E2E_PRNS, dops=E2E_DOPS, phases=phases, clip=clip,
                scale=scale)


def run_cli(main, *args, stdin_text=None) -> str:
    """main(*args) with stdout captured (and stdin fed, if given); raises
    unless it returns 0."""
    out = io.StringIO()
    old_stdin = sys.stdin
    try:
        if stdin_text is not None:
            sys.stdin = io.StringIO(stdin_text)
        with contextlib.redirect_stdout(out):
            rc = main(*args)
    finally:
        sys.stdin = old_stdin
    if rc != 0:
        raise RuntimeError(f"{main.__module__} returned {rc}")
    return out.getvalue()


def parse_hits(text: str) -> dict:
    """Acquisition CLI rows -> {prn: dict(doppler, metric, code)}."""
    hits = {}
    for line in text.strip().splitlines():
        f = line.split()
        hits[int(f[1])] = dict(doppler=float(f[3]), metric=float(f[5]),
                               code=float(f[7]))
    return hits


def device_busy_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profiled(name, fn, args, out_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    text = run_cli(fn, *args)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(fn, *args)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    # device-side events only (kernels, copies): a host op's device time
    # is its kernels' again
    busy_us = device_busy_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA)
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return text, dict(
        cold_s=cold, warm_s=warm, device_busy_s=busy_us / 1e6,
        idle_share=1.0 - busy_us / 1e6 / warm,
        top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    seconds, blocks = 2.2, 2150

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.device import resolve_device

    resolve_device("cuda")
    os.makedirs(args.out, exist_ok=True)
    fs = 8.184e6
    path = os.path.join(args.out, "main_path.iq")
    truth = synth_capture(path, fs, seconds)
    try:
        text, acq = _profiled("acquire", acq_cli.main,
                              ("gps-l1", [path, str(fs), "0",
                                          "--device", "cuda"]), args.out)
        hits = parse_hits(text)
        spec = ",".join(f"{p}:{hits[p]['doppler']}:{hits[p]['code']}"
                        for p in truth["prns"])
        _, trk = _profiled("track", trk_cli.main,
                           ("gps-l1", ["--blocks", str(blocks),
                                       "--device", "cuda", path, str(fs),
                                       "0", spec]), args.out)
    finally:
        os.remove(path)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(acquire=acq, track=trk, seconds=seconds,
                          blocks=blocks, channels=len(truth["prns"]),
                          card=card), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
