"""Every catalog signal with a code table through the track CLI.

    python -m gnss_dsp_tpu_torch.tools.track_all [--device cuda] [--out DIR]

For each of the 32 trackable signals: a capture from synth_track (four
satellites at 45 dB-Hz, or four FDMA channels, at the signal's internal
rate, 0.8 s), the track CLI with each channel's true code phase and its
doppler off by up to 10 Hz, and a check that every channel holds lock:
carrier_f within 5 Hz of the truth over the last 100 rows (10 Hz for the
Xona signals, which start in PLL with hot gains).  Prints one
line per signal (route, wall, worst carrier error, C/N0 of the last 300
rows) and exits non-zero if any signal fails.  beidou-b2bi and
beidou-b2bq (unknown-code recovery) and gps-p (no code table, as in the
reference) must raise NotImplementedError.

synth_track and run_signal are also chip_smoke.py's e2e_track phase;
scan_inputs gives track_scan's arguments for a family, synthesised on the
card, to K2's card tests and chip_smoke.py's k2 phase.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

import numpy as np

# captures are synthesised at each signal's acquisition rate (sig.acq_fs)
CN0_DBHZ = 45.0


def _subcarrier_t(sub, cp):
    """utils.synth.synth_iq's subcarrier factor on float64 code phases."""
    import torch

    bp = torch.remainder(torch.floor(2 * cp), 2)
    boc = 1 - 2 * bp
    if sub == "boc11":
        return boc
    if sub in ("cboc", "tmboc"):
        boc6 = 1 - 2 * torch.remainder(torch.floor(12 * cp), 2)
        if sub == "cboc":
            return 0.953463 * boc + 0.301511 * boc6
        u = torch.remainder(torch.floor(cp), 33)
        slot = ((u == 0) | (u == 4) | (u == 6) | (u == 29)).to(cp.dtype)
        return slot * boc6 + (1 - slot) * boc
    if sub == "rz_even":
        return 1 - bp
    if sub == "rz_odd":
        return bp
    raise ValueError(sub)


def synth_iq_t(code, chip_rate, fs, n, doppler_hz, code_phase, subcarrier,
               carrier_ratio, code_doppler_hz=None, device="cpu",
               data_bits=None):
    """utils.synth.synth_iq (noiseless) in torch on `device`: complex64
    [n].  Phases are float64 in the absolute sample index; the carrier
    phase wraps to [0, 1) before it drops to float32.  data_bits: one +-1
    per code period, period floor(code phase / L) taking
    data_bits[that mod len]."""
    import torch

    t = torch.arange(n, dtype=torch.float64, device=device)
    cd = doppler_hz if code_doppler_hz is None else code_doppler_hz
    cp = code_phase + t * ((chip_rate + cd / carrier_ratio) / fs)
    tab = torch.as_tensor(np.asarray(code, np.float32), device=device)
    chips = tab[torch.remainder(torch.floor(cp).to(torch.int64), len(code))]
    if subcarrier != "none":
        chips = chips * _subcarrier_t(subcarrier, cp).to(torch.float32)
    if data_bits is not None:
        bits = torch.as_tensor(np.asarray(data_bits, np.float32),
                               device=device)
        chips = chips * bits[torch.remainder(
            torch.floor(cp / len(code)).to(torch.int64), len(bits))]
    phi = torch.remainder(doppler_hz / fs * t, 1.0).to(torch.float32) \
        * np.float32(2 * np.pi)
    return torch.complex(chips * torch.cos(phi), chips * torch.sin(phi))


def scan_inputs(name, C, fs, seconds, seed, device, coherent_blocks=1,
                dwells=(8, 8), cn0=CN0_DBHZ):
    """Everything track/engine.track_scan takes for C channels of `name`
    on a `seconds` capture at fs, synthesised on `device`: satellites at
    `cn0` dB-Hz, each code 2-40 ms before its end at sample 0.  The
    channels start at sample 0, so that the code's end (for L2CL and
    GLONASS P its wrap) falls inside the first code period; with
    coherent_blocks > 1 the satellites carry their overlay (from a random
    phase) and the channels start at their first code boundary, as
    track_file aligns them, so that block b carries overlay[c, b].
    Returns dict(params, x (tail-padded), n, tab, st, ratios, cdf, sigp,
    overlay, truth)."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import nco
    from gnss_dsp_tpu_torch.track import engine
    from gnss_dsp_tpu_torch.track.driver import (
        TrackChannel, make_params, overlay_table)

    sig = get_signal(name)
    rng = np.random.default_rng(seed)
    cands = [p for p in sig.prns() if abs(sig.fdma_hz * p) < 0.45 * fs]
    prns = [int(cands[k % len(cands)]) for k in range(C)]
    dops = rng.uniform(-4000, 4000, C).round(1)
    L = sig.code_length
    phases = np.mod(L - rng.uniform(0.002, 0.040, C) * sig.chip_rate,
                    L).round(2)
    rolls = rng.integers(0, 100, C)
    M, overlay, periods = overlay_table(
        sig, [TrackChannel(p, 0.0, 0.0, overlay_phase=int(r))
              for p, r in zip(prns, rolls)], coherent_blocks)
    params = make_params(sig, fs, 0.0, loop_dwells=dwells, coherent_blocks=M)
    n = int(fs * seconds)
    x = torch.zeros(n, dtype=torch.complex64, device=device)
    for p, d, cp, r in zip(prns, dops, phases, rolls):
        # the first code boundary starts period 1, tracked block 0: block b
        # carries overlay chip (roll + b), as overlay_table rolls the row
        bits = (np.roll(sig.secondary(p), 1 - int(r))
                if overlay is not None else None)
        x += synth_iq_t(sig.code_table((p,))[0], sig.chip_rate, fs, n,
                        float(d) + sig.fdma_hz * p, float(cp), sig.subcarrier,
                        sig.track_carrier_ratio(p),
                        code_doppler_hz=float(d), device=device,
                        data_bits=bits)
    g = torch.Generator(device=device).manual_seed(seed)
    sigma = float(np.sqrt(fs / (2.0 * 10 ** (cn0 / 10.0))))
    x += sigma * torch.complex(torch.randn(n, generator=g, device=device),
                               torch.randn(n, generator=g, device=device))
    x = torch.cat([x, torch.zeros(params.nmax + 1024, dtype=x.dtype,
                                  device=device)])
    sigp = engine.sigp_from_params(params, C, device)
    code_p, ptr = phases, np.zeros(C, np.int32)
    if overlay is not None:
        sigp[:, engine.SIGP_NOV] = torch.tensor(periods, dtype=torch.float32,
                                                device=device)
        overlay = torch.from_numpy(overlay).to(device)
        ptr = np.array([int(fs * 0.001 * sig.code_period_ms * (L - cp) / L)
                        for cp in phases], np.int32)
        code_p = phases + ptr * (sig.chip_rate / fs)
    return dict(
        params=params, x=x, n=n,
        tab=torch.from_numpy(sig.code_table(tuple(prns)).astype(np.int8)
                             ).to(device),
        st=engine.init_state(code_p, np.zeros(C), np.zeros(C), dops,
                             ptr=ptr, device=device),
        ratios=torch.tensor([sig.track_carrier_ratio(p) for p in prns],
                            dtype=torch.float32, device=device),
        cdf=torch.tensor([nco.freq_to_fixed(-sig.fdma_hz * p / fs)
                          for p in prns], dtype=torch.int32, device=device),
        sigp=sigp, overlay=overlay,
        truth=dict(prns=prns, dops=dops, phases=phases))


def synth_track(path, name, seconds, count=4, cn0=CN0_DBHZ, seed=5,
                device="cuda"):
    """`count` satellites of signal `name` (FDMA: channels whose carrier
    offset stays under 0.45 fs) at random dopplers, each first code
    boundary 2-40 ms into the capture, plus one noise array at `cn0` dB-Hz
    per satellite, at the signal's acq_fs, written to `path` as int8 I/Q.
    GLONASS channels carry their FDMA offset in the carrier and the
    physical doppler in the code rate.  Returns the truth."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal

    sig = get_signal(name)
    fs = sig.acq_fs
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    cands = [p for p in sig.prns()
             if abs(sig.fdma_hz * p) < 0.45 * fs]
    prns = sorted(rng.permutation(cands)[:count].tolist())
    dops = rng.uniform(-4000.0, 4000.0, len(prns)).round(1)
    L = sig.code_length
    skip = rng.uniform(0.002, 0.040, len(prns))
    phases = np.mod(L - skip * sig.chip_rate, L).round(2)
    x = torch.zeros(n, dtype=torch.complex64, device=device)
    for prn, dop, cp in zip(prns, dops, phases):
        x += synth_iq_t(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                        float(dop) + sig.fdma_hz * prn, float(cp),
                        sig.subcarrier, sig.track_carrier_ratio(prn),
                        code_doppler_hz=float(dop), device=device)
    write_noisy(path, x, fs, cn0, seed)
    return dict(prns=tuple(prns), dops=dops, phases=phases, fs=fs,
                code_length=L)


def write_noisy(path, x, fs, cn0, seed):
    """x (complex64 on its device, unit-amplitude satellites) plus one
    noise array at `cn0` dB-Hz per satellite (a generator seeded with
    `seed` on x's device), written to `path` as int8 I/Q with 4 standard
    deviations at full scale."""
    import torch

    from gnss_dsp_tpu_torch.utils.synth import to_int8_iq

    g = torch.Generator(device=x.device).manual_seed(seed)
    sigma = float(np.sqrt(fs / (2.0 * 10 ** (cn0 / 10.0))))
    x = x + sigma * torch.complex(
        torch.randn(x.shape[0], generator=g, device=x.device),
        torch.randn(x.shape[0], generator=g, device=x.device))
    scale = 127.0 / (4.0 * float(x.real.std()))
    with open(path, "wb") as f:
        f.write(to_int8_iq(x.cpu().numpy(), scale=scale))


def run_signal(name, device, work, seconds=0.8, count=4, seed=5,
               tail=100, dwells=None, cn0_rows=300, keep=False, limit=5.0):
    """synth_track, the track CLI on the capture, and the lock check:
    carrier_f within `limit` Hz of the truth over the last `tail` rows.
    Returns what was seen; `bad` lists the channels out of lock."""
    from gnss_dsp_tpu_torch.cli import cn0 as cn0_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.main_path import run_cli

    sig = get_signal(name)
    path = os.path.join(work, f"track_{name}.iq")
    truth = synth_track(path, name, seconds, count, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    err = (np.full(len(truth["prns"]), 1.0) if sig.track_mode_initial == "PLL"
           else rng.uniform(-10.0, 10.0, len(truth["prns"])).round(1))
    spec = ",".join(f"{p}:{d + e}:{c}" for p, d, e, c in zip(
        truth["prns"], truth["dops"], err, truth["phases"]))
    opts = ["--loop-dwells", f"{dwells[0]},{dwells[1]}"] if dwells else []
    try:
        t0 = time.perf_counter()
        out = run_cli(trk_cli.main, name, opts + [
            path, str(truth["fs"]), "0", spec, "--device", device])
        wall = time.perf_counter() - t0
    finally:
        if not keep:
            os.remove(path)
    # with several channels each row starts "ch<prn> "
    rows = {p: [] for p in truth["prns"]}
    for line in out.splitlines():
        if len(rows) == 1:
            rows[truth["prns"][0]].append(line)
            continue
        tag, rest = line.split(" ", 1)
        rows[int(tag[2:])].append(rest)
    dfs, cn0s, bad = [], [], []
    for prn, dop in zip(truth["prns"], truth["dops"]):
        r = rows[prn]
        cf = np.array([float(v.split()[3]) for v in r[-tail:]])
        df = float(np.abs(cf - dop).max()) if len(r) >= tail else np.inf
        est = run_cli(cn0_cli.main, ["--time", str(cn0_rows)],
                      stdin_text="\n".join(r[-cn0_rows:]) + "\n").split()
        c = float(est[0]) if len(est) == 1 else float("nan")
        dfs.append(df)
        cn0s.append(c)
        if not df <= limit:
            bad.append((prn, len(r), df))
    return dict(name=name, truth=truth, rows=rows, out=out, wall_s=wall,
                max_df=dfs, cn0=cn0s, bad=bad, path=path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("_work", "track_all"))
    args = ap.parse_args(argv)

    from gnss_dsp_tpu_torch.device import resolve_device
    from gnss_dsp_tpu_torch.models.signal import all_signals
    from gnss_dsp_tpu_torch.track.driver import (
        TrackChannel, make_params, track_file)

    device = str(resolve_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    failed, ran = [], 0
    for name, sig in sorted(all_signals().items()):
        if sig.code_table is None or sig.recover_default:
            try:
                track_file(sig, io.BytesIO(), 1e6, 0.0,
                           [TrackChannel(prn=1, doppler=0.0, code_offset=0.0)],
                           device=device)
            except NotImplementedError as e:
                print(f"{name:14s} NotImplementedError, as expected: {e}",
                      flush=True)
                continue
            failed.append(name)
            print(f"{name:14s} did not raise", flush=True)
            continue
        p = make_params(sig, sig.acq_fs, 0.0)
        route = ("K2" if p.fused_scan else "K3" if p.pallas_v2 else "K4")
        # the PLL-start signals (Xona) run hot loop gains from block 0
        # (track-xona-x1p.py:151), whose carrier_f jitters more
        limit = 10.0 if sig.track_mode_initial == "PLL" else 5.0
        r = run_signal(name, device, args.out, dwells=(200, 200), limit=limit)
        ran += 1
        print(f"{name:14s} {route} {sig.subcarrier:7s} sub={sig.sub_blocks:4d}"
              f" L={sig.code_length:7d} fs={r['truth']['fs']:g}: CLI "
              f"{r['wall_s']:.2f} s, worst |carrier_f - truth| "
              f"{max(r['max_df']):.3f} Hz (limit {limit:g}), C/N0 "
              f"{' '.join(f'{c:.1f}' for c in r['cn0'])}"
              f"{'  FAILED ' + str(r['bad']) if r['bad'] else ''}",
              flush=True)
        if r["bad"]:
            failed.append(name)
    print(f"{ran} signals tracked; "
          + (f"{len(failed)} failed: {failed}" if failed else "all passed"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
