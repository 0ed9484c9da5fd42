"""Every catalog signal with an FFT search through the acquire CLI.

    python -m gnss_dsp_tpu_torch.tools.acquire_all [--device cuda] [--out DIR]
                                                   [--coherent]

For each signal that is neither FDMA nor a serial search and has a code
table (29 of the 35; gps-p is registered for its code windows only, as in
the reference): an 85 ms capture at its internal rate from
main_path.synth_at_acq_fs (four satellites at 45 dB-Hz, or all of a
shorter default PRN list), the acquire CLI at its default PRNs and
doppler grid with --time 80, and a check that every planted PRN lies
within one doppler bin and one chip of the truth and above every absent
PRN.  The FDMA and serial signals must raise NotImplementedError.  Prints
one line per signal (route, window, wall, margin) and exits non-zero if
any signal fails.

With --coherent, the same signals through the extended-coherent search
(acquire_signal_coherent, the acquire CLI's --coherent path) instead: a
capture of one planted PRN at 45 dB-Hz carrying its overlay from a random
chip, M = the overlay length where the fused route takes it (K5 or K6 on
the card), M = 2 for the overlay-free signals and for GPS L1CP and BeiDou
B1CP (2 is no multiple of their 1800-chip overlays: the XLA engine, in
plain torch; Xona X5P likewise, whose window no fused route takes),
--time one coherent span and one code period (the 2n linear windows of
the last block reach past the span), the doppler grid about 1 / (2 x
the span) over +-500 Hz, every default PRN: the planted one within one bin
and one chip, above every absent PRN, and on the linear windows with the
truth's alignment.  The line gives the route (spec, blk or xla), W and A.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run_signal(name: str, device: str, work: str) -> dict:
    """Synthesize, acquire and check one signal; returns what was seen."""
    from gnss_dsp_tpu_torch.acquire.plan import acq_plan
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.main_path import (
        parse_hits, run_cli, synth_at_acq_fs)

    sig = get_signal(name)
    route, window, _, n_valid = acq_plan(sig)
    path = os.path.join(work, f"acquire_all_{name}.iq")
    truth = synth_at_acq_fs(path, name, 0.085)
    try:
        t0 = time.perf_counter()
        hits = parse_hits(run_cli(acq_cli.main, name, [
            "--time", "80", path, str(truth["fs"]), "0", "--device", device]))
        wall = time.perf_counter() - t0
    finally:
        os.remove(path)
    r = _check_hits(sig, hits, truth, sig.doppler_default[2])
    return dict(r, name=name, route=route, window=window, n_valid=n_valid,
                prns=len(hits), wall_s=wall)


MAX_SPAN_MS = 100      # the longest coherent span of the sweep


def coherent_m(sig) -> int:
    """M of the --coherent sweep: the overlay length N where the fused
    route takes M = N (plan.coh_plan) within MAX_SPAN_MS, else 2 (GPS
    L1CP's and BeiDou B1CP's 1800-chip overlays span 18 s)."""
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan

    if sig.secondary is None:
        return 2
    N = len(sig.secondary(sig.prns()[0]))
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    fits = N * sig.acq_coherent_ms <= MAX_SPAN_MS
    return N if N > 1 and fits and coh_plan(sig, n, N, N) else 2


def run_signal_coherent(name: str, device: str, work: str) -> dict:
    """Synthesize, acquire coherently and check one signal."""
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.main_path import (
        parse_hits, returns_of, run_cli, synth_at_acq_fs)

    sig = get_signal(name)
    m = coherent_m(sig)
    N = len(sig.secondary(sig.prns()[0])) if sig.secondary else 1
    route = _coherent_route(sig, m, N)
    # one coherent span of blocks; the 2n linear windows of the last block
    # reach one code period past it (blocks round down to m)
    ms = int((m + 1) * sig.acq_coherent_ms)
    step = 1000.0 / (2 * m * sig.acq_coherent_ms)
    path = os.path.join(work, f"acquire_all_coherent_{name}.iq")
    # the XLA engine's circular windows straddle two code periods: where
    # the overlay changes sign inside a block, a doppler 1/(2 x period)
    # off can correlate better than the truth (the linear windows of the
    # fused route do not straddle).  Plant the code phase in the code's
    # first 5% there, so that each block lies 95% in one period.
    truth = synth_at_acq_fs(
        path, name, (ms + 6) / 1000.0, count=1, dop_max=450.0,
        overlay=sig.secondary is not None,
        phase_max=(0.05 * sig.code_length if route[0] == "xla" and N > 1
                   else None))
    try:
        t0 = time.perf_counter()
        with returns_of(acq_cli, "acquire_signal_coherent") as res:
            hits = parse_hits(run_cli(acq_cli.main, name, [
                "--coherent", str(m), "--time", str(ms), "--doppler-search",
                f"-500,500,{step:g}", path, str(truth["fs"]), "0",
                "--device", device]))
        wall = time.perf_counter() - t0
    finally:
        os.remove(path)
    r = _check_hits(sig, hits, truth, step)
    prn, roll = truth["prns"][0], int(truth["rolls"][0])
    got = {x.prn: x for x in res[0]}[prn]
    if got.linear and got.align != (roll + 1) % N:
        r["bad"].append((prn, "align", got.align, (roll + 1) % N))
    return dict(r, name=name, route=route[0], window=route[1], A=N, m=m,
                prns=len(hits), wall_s=wall, dopplers=len(
                    np.arange(-500.0, 500.0, step)))


def _coherent_route(sig, m, N):
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan

    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    fast = coh_plan(sig, n, m, N) if m % N == 0 else None
    return fast[:2] if fast else ("xla", n)


def _check_hits(sig, hits, truth, step) -> dict:
    """Each planted PRN within one doppler bin of `step` Hz and one chip
    of the truth, and above every absent PRN: dict(margin, bad)."""
    L = sig.code_length
    absent = max((h["metric"] for p, h in hits.items()
                  if p not in truth["prns"]), default=None)
    bad = []
    for prn, dop, cp in zip(truth["prns"], truth["dops"], truth["phases"]):
        h = hits[prn]
        dc = abs(h["code"] - cp) % L
        if (abs(h["doppler"] - dop) > step or min(dc, L - dc) > 1.0
                or (absent is not None and h["metric"] <= absent)):
            bad.append((prn, h, float(dop), float(cp)))
    margin = (None if absent is None else
              min(hits[p]["metric"] for p in truth["prns"]) / absent)
    return dict(margin=margin, bad=bad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("_work", "acquire_all"))
    ap.add_argument("--coherent", action="store_true",
                    help="the extended-coherent search instead")
    args = ap.parse_args(argv)

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.device import resolve_device
    from gnss_dsp_tpu_torch.models.signal import all_signals

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    failed = []
    for name, sig in sorted(all_signals().items()):
        if sig.code_table is None:
            print(f"{name:14s} no code table (code windows only), skipped",
                  flush=True)
            continue
        if sig.fdma_hz or sig.acq_serial:
            try:
                acq_cli.main(name, (["--coherent", "-1"] if args.coherent
                                    else []) + ["x.iq", "1e6", "0",
                                                "--device", args.device])
            except NotImplementedError:
                print(f"{name:14s} FDMA/serial: NotImplementedError, as "
                      f"expected", flush=True)
                continue
            failed.append(name)
            print(f"{name:14s} FDMA/serial did not raise", flush=True)
            continue
        if args.coherent:
            r = run_signal_coherent(name, args.device, args.out)
            what = (f"{r['route']:4s} W={r['window']:6d} M={r['m']:4d} "
                    f"A={r['A']:4d} {r['dopplers']:3d} dopplers")
        else:
            r = run_signal(name, args.device, args.out)
            what = (f"{r['route']:3s} W={r['window']:6d} "
                    f"n_valid={r['n_valid']:5d}")
        margin = "-" if r["margin"] is None else f"{r['margin']:.2f}"
        print(f"{name:14s} {what} {r['prns']:2d} PRNs, CLI "
              f"{r['wall_s']:.2f} s, weakest planted / best absent "
              f"{margin}{'  FAILED ' + str(r['bad']) if r['bad'] else ''}",
              flush=True)
        if r["bad"]:
            failed.append(name)
    print(f"{len(failed)} failed: {failed}" if failed else "all passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
