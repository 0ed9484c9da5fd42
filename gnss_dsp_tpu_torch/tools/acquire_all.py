"""Every catalog signal with an FFT search through the acquire CLI.

    python -m gnss_dsp_tpu_torch.tools.acquire_all [--device cuda] [--out DIR]

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
"""

from __future__ import annotations

import argparse
import os
import sys
import time


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
    L, step = sig.code_length, sig.doppler_default[2]
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
    return dict(name=name, route=route, window=window, n_valid=n_valid,
                prns=len(hits), wall_s=wall, margin=margin, bad=bad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("_work", "acquire_all"))
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
                acq_cli.main(name, ["x.iq", "1e6", "0", "--device",
                                    args.device])
            except NotImplementedError:
                print(f"{name:14s} FDMA/serial: NotImplementedError, as "
                      f"expected", flush=True)
                continue
            failed.append(name)
            print(f"{name:14s} FDMA/serial did not raise", flush=True)
            continue
        r = run_signal(name, args.device, args.out)
        margin = "-" if r["margin"] is None else f"{r['margin']:.2f}"
        print(f"{name:14s} {r['route']:3s} W={r['window']:6d} "
              f"n_valid={r['n_valid']:5d} {r['prns']:2d} PRNs, CLI "
              f"{r['wall_s']:.2f} s, weakest planted / best absent "
              f"{margin}{'  FAILED ' + str(r['bad']) if r['bad'] else ''}",
              flush=True)
        if r["bad"]:
            failed.append(name)
    print(f"{len(failed)} failed: {failed}" if failed else "all passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
