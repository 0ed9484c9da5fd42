"""Acquisition sensitivity curve: non-coherent against extended-coherent.

Counterpart: tools/sensitivity_curve.py of the repository root, the JAX
package's tool, with its defaults, draws and lock rule.  Sweeps C/N0 and
measures the lock rate (code error under 1 chip and doppler within one
bin) of
  (a) the reference's search, 1 ms coherent + `ms` non-coherent
      magnitude sums (acquire/engine.acquire_signal; kernel K1 on the
      card),
  (b) the overlay-wiped extended-coherent search over the same data
      (acquire/coherent.acquire_signal_coherent; kernel K6 on the card),
on `trials` captures a point, each with its own noise, code phase,
on-grid doppler and overlay alignment.  Prints a progress line a point
and a markdown table.

At the default 4.096 MHz, BeiDou B1I searches at W = 8192: K1 on its
run-time core (acquire/plan route "v2") and K6 ("blk") on K5's register
core.

    python -m gnss_dsp_tpu_torch.tools.sensitivity_curve [signal] [trials]
        [--device cuda|cpu]

The device defaults to the card (the CPU while GNSS_DSP_CPU is set); the
CPU runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
from gnss_dsp_tpu_torch.acquire.engine import acquire_signal
from gnss_dsp_tpu_torch.device import pop_device_arg, resolve_device
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.utils.synth import synth_iq

CN0S = (24, 26, 28, 30, 32, 34)
GRID = (-100.0, 101.0, 25.0)


@dataclasses.dataclass
class Trial:
    """One capture: its C/N0, the planted code phase (chips), doppler
    (Hz) and overlay roll, and where it was searched, each search's
    result and lock decision (None for a point drawn but not searched)."""
    cn0: float
    code_phase: float
    doppler: float
    roll: int
    nc: object = None
    co: object = None
    lock_nc: bool | None = None
    lock_co: bool | None = None


@dataclasses.dataclass
class Curve:
    """rows: (cn0, non-coherent locks, coherent locks, seconds) of each
    searched point; trials: every trial, in the order drawn."""
    trials_per_point: int
    rows: list
    trials: list


def run(signame="beidou-b1i", trials=10, cn0s=CN0S, fs=4.096e6, *,
        device, searched=None) -> Curve:
    """The curve of `signame` at acq_fs = fs on `device`.

    The draws are the JAX tool's, from one np.random.default_rng(42) in
    its order: per trial the code phase, the doppler, the overlay roll,
    then the noise inside synth_iq.  searched: the C/N0 points to search
    (default all); the others are drawn only, so that every searched
    trial is the same capture as in the full curve.  Prints a progress
    line a searched point, then the table."""
    dev = resolve_device(device)
    searched = set(cn0s if searched is None else searched)
    sig = dataclasses.replace(get_signal(signame), acq_fs=fs)
    prn = 34 if signame == "beidou-b1i" else 25
    sec = sig.secondary(prn)
    m = len(sec)
    ms = 2 * m
    n = int(fs * (ms + 4) / 1000)
    code = sig.code_table((prn,))[0]
    rng = np.random.default_rng(42)

    def locked(r, cp0, dop0):
        e = abs(r.code_offset - cp0)
        return bool(min(e, sig.code_length - e) < 1.0
                    and abs(r.doppler - dop0) <= GRID[2])

    rows, drawn = [], []
    for cn0 in cn0s:
        hits_nc = hits_co = 0
        t0 = time.perf_counter()
        for _ in range(trials):
            cp0 = float(rng.uniform(1.0, sig.code_length - 1.0))
            dop0 = float(rng.choice(np.arange(*GRID)))
            roll = int(rng.integers(0, m))
            x = synth_iq(code, sig.chip_rate, fs, n, doppler_hz=dop0,
                         code_phase=cp0, cn0_dbhz=cn0,
                         carrier_ratio=sig.carrier_ratio,
                         data_bits=np.roll(sec, -roll), rng=rng)
            t = Trial(cn0, cp0, dop0, roll)
            drawn.append(t)
            if cn0 not in searched:
                continue
            xd = torch.from_numpy(x).to(dev)
            t.nc = acquire_signal(sig, xd, [prn], doppler_search=GRID,
                                  ms=ms)[0]
            t.co = acquire_signal_coherent(sig, xd, [prn], GRID, ms=ms)[0]
            t.lock_nc, t.lock_co = (locked(t.nc, cp0, dop0),
                                    locked(t.co, cp0, dop0))
            hits_nc += t.lock_nc
            hits_co += t.lock_co
        if cn0 not in searched:
            continue
        rows.append((cn0, hits_nc, hits_co, time.perf_counter() - t0))
        print(f"  cn0 {cn0} dB-Hz: non-coherent {hits_nc}/{trials}, "
              f"coherent {hits_co}/{trials}  ({rows[-1][3]:.0f} s)",
              flush=True)

    print(f"\n{signame} ({m}-chip overlay, {ms} ms of data, {trials} "
          "trials/point, random phase/doppler/alignment):\n")
    print("| C/N0 (dB-Hz) | non-coherent lock | extended-coherent lock |")
    print("|---|---|---|")
    for cn0, hn, hc, _ in rows:
        print(f"| {cn0} | {hn}/{trials} | {hc}/{trials} |")
    return Curve(trials, rows, drawn)


def main(argv=None) -> int:
    device, argv = pop_device_arg(sys.argv[1:] if argv is None else argv,
                                  "sensitivity_curve")
    name = argv[0] if argv else "beidou-b1i"
    k = int(argv[1]) if len(argv) > 1 else 10
    run(name, k, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
