#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnss_dsp_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Runs every phase, in this order:
  device  require CUDA; print the card (nvidia-smi name, power limit),
          torch/CUDA versions and the TF32 flags
  build   build both kernels from gnss_dsp_tpu_torch/csrc with nvcc
  k1      acquisition-surface kernel vs its plain version at the sky-search
          shape (32 PRN x 70 doppler x 80 blocks x 4096), with timings
  k2      fused tracking kernel vs its plain version at the tracking bench
          shape (32 channels x 900 blocks, 4.096 MHz), with timings; then
          at the main path's shape (the e2e capture's 8 channels at
          8.184 MHz, int8 ingest on the card) across a chunk that ends
          mid-run, the stall, and the driver's refill with pointer rebase
  e2e     the main path through the CLIs: synthesize a 2.2 s GPS L1
          capture (8.184 MHz, 8 satellites, 45 dB-Hz), acquire it, track
          the hits for 2150 blocks (past the 2000 ms chunk refill and the
          FLL -> PLL switch at block 1000), estimate C/N0 with
          gnss_dsp_tpu.cli.cn0; the launch counters must show both
          kernels on that path

Prints a JSON line of per-kernel results, then the nvidia-smi line, then a
last line {"ok": true, "device": {...}}.  Exits non-zero, without that
line, when any phase fails or no GPU is present.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

KERNELS = {
    "acquire2": dict(route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire2.cu",
                     replaces="gnss_dsp_tpu/ops/pallas_acquire2.py:285"),
    "track_fused": dict(route="cuda",
                        source="gnss_dsp_tpu_torch/csrc/track_fused.cu",
                        replaces="gnss_dsp_tpu/ops/pallas_track_fused.py:536"),
}


def log(msg):
    print(msg, flush=True)


def check(ok, what="check failed"):
    """A failed check raises (unlike assert, also under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------- phase k1

def phase_k1(dev, card, results):
    import torch

    from gnss_dsp_tpu_torch.ops import acquire2

    P, DC, B, W = 32, 70, 80, 4096
    g = torch.Generator(device=dev).manual_seed(1234)
    code_f = torch.exp(1j * 2 * np.pi * torch.rand(
        (P, W), generator=g, device=dev)).to(torch.complex64)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    # one planted correlation peak per PRN: F[d, b] += code_f[p] e^{-2pi i k j/W}
    rng = np.random.default_rng(5)
    dops = rng.permutation(DC)[:P]
    lags = rng.integers(0, W, P)
    k = torch.arange(W, device=dev, dtype=torch.float64)
    for p in range(P):
        ramp = torch.exp(-2j * np.pi * k * float(lags[p]) / W)
        F[int(dops[p])] += 0.5 * (code_f[p].to(torch.complex128)
                                  * ramp).to(torch.complex64)[None, :]
    peak_k, idx_k, sum_k = acquire2.corr_surface2(F, code_f)
    peak_p, idx_p, sum_p = acquire2.corr_surface2_plain(F, code_f)
    torch.cuda.synchronize()
    idx_k, idx_p = idx_k.cpu().numpy(), idx_p.cpu().numpy()
    peak_k, peak_p = peak_k.cpu().numpy(), peak_p.cpu().numpy()
    sum_k, sum_p = sum_k.cpu().numpy(), sum_p.cpu().numpy()
    # code_f * conj(F) = e^{+2 pi i k j/W}: its inverse DFT peaks at -j
    want = (-lags) % W
    planted_k = idx_k[np.arange(P), dops]
    check((planted_k == want).all(), ("planted lag", planted_k, want))
    check((idx_p[np.arange(P), dops] == want).all())
    np.testing.assert_allclose(peak_k, peak_p, rtol=1e-4)
    np.testing.assert_allclose(sum_k, sum_p, rtol=1e-4)
    # away from the planted cells the surface is noise: a differing argmax
    # is allowed only where the plain surface ties at both lags to float32
    # rounding
    diff = np.argwhere(idx_k != idx_p)
    for p, d in diff:
        q = torch.fft.ifft(code_f[p] * torch.conj(F[d]), dim=-1).abs().sum(0)
        a, b = float(q[idx_k[p, d]]), float(q[idx_p[p, d]])
        check(abs(a - b) <= 1e-5 * b, ("argmax differs", p, d, a, b))
    err = float(max(np.abs(peak_k - peak_p).max(), np.abs(sum_k - sum_p).max()))
    ms = cuda_ms(lambda: acquire2.corr_surface2(F, code_f), 5)
    plain_ms = cuda_ms(lambda: acquire2.corr_surface2_plain(F, code_f), 2)
    cells = P * DC * B * W
    log(f"[k1] P={P} DC={DC} B={B} W={W}: idx exact on planted cells, "
        f"{len(diff)} near-tie argmax differences elsewhere, "
        f"max|dpeak|,|dsum| = {err:.3g}")
    log(f"[k1] kernel {ms:.3f} ms ({cells / ms / 1e6:.4g} Gcells/s), "
        f"plain {plain_ms:.3f} ms  [{card}]")
    results["acquire2"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------- phase k2

def phase_k2(dev, card, results):
    import torch

    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import (
        init_state, sigp_from_params, track_scan, track_scan_plain)

    C, NB, fs = 32, 900, 4.096e6
    sig = get_signal("gps-l1")
    rng = np.random.default_rng(3)
    prns = (1 + np.arange(C) % 32).tolist()
    dops = rng.uniform(-4000, 4000, C).round(1)
    phases = rng.uniform(0, 1023, C).round(2)
    n = int(NB * fs * 0.001) + 8192
    code_np = sig.code_table(tuple(prns)).astype(np.int8)
    x = np.zeros(n, np.complex64)
    for k in range(8):
        x += synth_iq(code_np[k].astype(np.float64), sig.chip_rate, fs, n,
                      doppler_hz=float(dops[k]), code_phase=float(phases[k]),
                      cn0_dbhz=None, carrier_ratio=1540.0).astype(np.complex64)
    x += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64) * 0.1
    params = make_params(sig, fs, coffset=0.0, loop_dwells=(200, 200))
    tail = params.nmax + (-(n + params.nmax)) % 1024
    xd = torch.from_numpy(np.concatenate([x, np.zeros(tail, np.complex64)])
                          ).to(dev)
    tab = torch.from_numpy(code_np).to(dev)

    def st0():
        return init_state(code_p=phases, code_f_off=np.zeros(C),
                          carrier_p=np.zeros(C), carrier_f=dops,
                          ptr=np.zeros(C, np.int32), device=dev)

    def run_kernel():
        return track_scan(xd, n, tab, st0(), params, NB)

    def run_plain():
        st = st0()
        return track_scan_plain(
            xd, torch.full((C,), n, dtype=torch.int32, device=dev), tab, st,
            params, NB, torch.full((C,), 1540.0, device=dev),
            torch.zeros(C, dtype=torch.int32, device=dev),
            sigp_from_params(params, C, dev))

    _, rf_k, ri_k = run_kernel()
    _, rf_p, ri_p = run_plain()
    torch.cuda.synchronize()
    rf_k, ri_k = rf_k.cpu().numpy(), ri_k.cpu().numpy()
    rf_p, ri_p = rf_p.cpu().numpy(), ri_p.cpu().numpy()
    H = 200
    np.testing.assert_array_equal(ri_k[:H], ri_p[:H])
    np.testing.assert_allclose(rf_k[:H], rf_p[:H], rtol=2e-5, atol=2e-4)
    same_rows = int((rf_k == rf_p).all(axis=2).sum())
    dcf = np.abs(rf_k[H:, :, 3] - rf_p[H:, :, 3])
    L = sig.code_length
    dcp = np.abs(rf_k[H:, :, 9] - rf_p[H:, :, 9])
    dcp = np.minimum(dcp, L - dcp)
    check(np.nanmax(dcf) <= 0.5, ("carrier_f drift", np.nanmax(dcf)))
    check(np.nanmax(dcp) <= 0.01, ("code_p drift", np.nanmax(dcp)))
    cf_tail = np.nanmedian(rf_k[-50:, :8, 3], axis=0)
    check(np.abs(cf_tail - dops[:8]).max() < 5.0, cf_tail)
    err = float(np.nanmax(np.abs(rf_k[:H] - rf_p[:H])))
    ms = cuda_ms(run_kernel, 3)
    plain_ms = cuda_ms(run_plain, 1)
    samples = float(ri_k[..., 0].sum())
    log(f"[k2] C={C} NB={NB} fs={fs:g}: first {H} blocks rows_i exact, "
        f"rows_f max|d| = {err:.3g}; {same_rows}/{NB * C} rows bit-equal; "
        f"after: max|dcarrier_f| {np.nanmax(dcf):.3g} Hz, "
        f"max|dcode_p| {np.nanmax(dcp):.3g} chip")
    log(f"[k2] kernel {ms:.3f} ms ({samples / ms / 1e3:.4g} Msamples/s), "
        f"plain {plain_ms:.3f} ms  [{card}]")
    results["track_fused"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------- phase k2, main

def phase_k2_main_path(dev, results, work, seconds=0.8, chunk_s=0.35,
                       nb=(400, 300)):
    """K2 against its plain version at the main path's shape: the e2e
    capture's 8 channels at 8.184 MHz, uploaded as int8 and converted on
    the card, each channel starting at its first code boundary as the
    driver aligns it.  The first chunk ends mid-run, so every channel
    stalls; then the driver's refill (drop consumed samples, rebase the
    pointers) and a second launch.  Loop dwells of 150/150 blocks put the
    FLL -> PLL switch inside the first launch."""
    import torch

    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu_torch.ops import cplx
    from gnss_dsp_tpu_torch.tools.main_path import synth_capture
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import (
        init_state, sigp_from_params, track_scan, track_scan_plain)

    fs = 8.184e6
    path = os.path.join(work, "k2_gps_l1.iq")
    truth = synth_capture(path, fs, seconds)
    raw = np.fromfile(path, np.int8)
    os.remove(path)
    sig = get_signal("gps-l1")
    params = make_params(sig, fs, 0.0, loop_dwells=(150, 150))
    L, C = sig.code_length, len(truth["prns"])
    n0 = [int(fs * 0.001 * sig.code_period_ms * (L - cp) / L)
          for cp in truth["phases"]]
    code_p0 = [cp + k * (sig.chip_rate / fs)
               for cp, k in zip(truth["phases"], n0)]
    st = init_state(code_p=np.array(code_p0), code_f_off=np.zeros(C),
                    carrier_p=np.zeros(C), carrier_f=np.array(truth["dops"]),
                    ptr=np.array(n0, np.int32), device=dev)
    tab = torch.from_numpy(sig.code_table(truth["prns"]).astype(np.int8)
                           ).to(dev)
    ratios = torch.tensor([sig.track_carrier_ratio(p) for p in truth["prns"]],
                          dtype=torch.float32, device=dev)
    cdf = torch.full((C,), params.coffset_df_fixed, dtype=torch.int32,
                     device=dev)
    sigp = sigp_from_params(params, C, dev)
    start, err, same, total = 0, 0.0, 0, 0
    for launch, nblk in enumerate(nb):
        nbuf = (int(fs * chunk_s) if launch == 0
                else len(raw) // 2 - start)
        tail = params.nmax + (-(nbuf + params.nmax)) % 1024
        x = cplx.from_int8_iq(raw[2 * start: 2 * (start + nbuf)], pad=tail,
                              device=dev)
        st = st._replace(stalled=torch.zeros_like(st.stalled))
        st_k, rf_k, ri_k = track_scan(x, nbuf, tab, st, params, nblk,
                                      ratios=ratios, coffset_df=cdf,
                                      sigp=sigp)
        st_p, rf_p, ri_p = track_scan_plain(
            x, torch.full((C,), nbuf, dtype=torch.int32, device=dev), tab,
            st, params, nblk, ratios, cdf, sigp)
        torch.cuda.synchronize()
        rf_k, rf_p = rf_k.cpu().numpy(), rf_p.cpu().numpy()
        np.testing.assert_array_equal(ri_k.cpu().numpy(), ri_p.cpu().numpy())
        np.testing.assert_allclose(rf_k, rf_p, rtol=2e-5, atol=2e-4)
        for name, a, b in zip(st_k._fields, st_k, st_p):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-4,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        valid = ~np.isnan(rf_k).any(axis=2)
        err = max(err, float(np.abs(rf_k - rf_p)[valid].max()))
        same += int(((rf_k == rf_p) | (np.isnan(rf_k) & np.isnan(rf_p))
                     ).all(axis=2).sum())
        total += rf_k.shape[0] * C
        rows = int(valid.sum())
        stalled = int(st_k.stalled.sum())
        if launch == 0:
            check(stalled == C, ("first chunk did not stall every channel",
                                 stalled))
        else:
            check(stalled == 0, ("second launch stalled", stalled))
        st = st_k
        consumed = int(st.ptr.min())
        start += consumed
        st = st._replace(ptr=st.ptr - consumed)
        log(f"[k2] main-path shape, launch {launch}: C={C} fs={fs:g} "
            f"chunk {nbuf} samples, {nblk} blocks, {rows} rows, "
            f"{stalled} channels stalled, rebase by {consumed}")
    log(f"[k2] main-path shape: rows_i and state ints exact, rows_f max|d| "
        f"= {err:.3g}, {same}/{total} rows bit-equal across the stall and "
        f"refill")
    r = results["track_fused"]
    r["max_abs_err"] = max(r["max_abs_err"], err)


# --------------------------------------------------------------- phase e2e

def phase_e2e(dev, card, results, work, seconds=2.2, nblocks=2150):
    import torch

    import gnss_dsp_tpu.cli.cn0 as cn0
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import acquire2, track_fused
    from gnss_dsp_tpu_torch.tools.main_path import (
        parse_hits, run_cli, synth_capture)

    fs = 8.184e6
    path = os.path.join(work, "e2e_gps_l1.iq")
    t0 = time.perf_counter()
    truth = synth_capture(path, fs, seconds)
    t_synth = time.perf_counter() - t0
    log(f"[e2e] capture {seconds} s at {fs:g} Hz, 8 PRNs at 45 dB-Hz, "
        f"int8 clip fraction {truth['clip']:.2e} ({t_synth:.1f} s)")

    acquire2.LAUNCHES = 0
    track_fused.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_cli(acq_cli.main, "gps-l1",
                  [path, str(fs), "0", "--device", str(dev)])
    torch.cuda.synchronize()
    t_acq = time.perf_counter() - t0
    hits = parse_hits(out)
    check(sorted(hits) == list(range(1, 33)), out)
    absent = max(h["metric"] for p, h in hits.items()
                 if p not in truth["prns"])
    specs = []
    for prn, dop, cp in zip(truth["prns"], truth["dops"], truth["phases"]):
        h = hits[prn]
        dc = abs(h["code"] - cp)
        dc = min(dc, 1023 - dc)
        check(abs(h["doppler"] - dop) <= 200.0, (prn, h, dop))
        check(dc <= 1.0, (prn, h, cp))
        check(h["metric"] > absent, (prn, h, absent))
        specs.append(f"{prn}:{h['doppler']}:{h['code']}")
        log(f"[e2e] acquire prn {prn:2d}: doppler {h['doppler']:7.1f} "
            f"(truth {dop:7.1f}) code {h['code']:6.1f} (truth {cp:7.2f}) "
            f"metric {h['metric']:.2f}")
    log(f"[e2e] best absent-PRN metric {absent:.2f}; acquire "
        f"{t_acq:.2f} s")

    t0 = time.perf_counter()
    out = run_cli(trk_cli.main, "gps-l1",
                  ["--blocks", str(nblocks), "--device", str(dev), path,
                   str(fs), "0", ",".join(specs)])
    torch.cuda.synchronize()
    t_trk = time.perf_counter() - t0
    rows = {p: [] for p in truth["prns"]}
    for line in out.splitlines():
        tag, rest = line.split(" ", 1)
        rows[int(tag[2:])].append(rest)
    t_cn0 = 0.0
    for prn, dop in zip(truth["prns"], truth["dops"]):
        r = rows[prn]
        # --blocks counts scan steps, as in the reference driver: a
        # channel that stalls for a step at the chunk end emits one row
        # fewer; its rows still run on past the refill
        last = int(r[-1].split()[0])
        check(nblocks - 4 <= len(r) <= nblocks and last == len(r) - 1,
              (prn, len(r), last))
        cf = np.array([float(v.split()[3]) for v in r[-200:]])
        check(np.abs(cf - dop).max() <= 5.0, (prn, np.abs(cf - dop).max()))
        t1 = time.perf_counter()
        est = run_cli(cn0.main, ["--time", "500"],
                      stdin_text="\n".join(r[-500:]) + "\n").split()
        t_cn0 += time.perf_counter() - t1
        check(len(est) == 1, est)
        c = float(est[0])
        check(41.0 <= c <= 47.0, (prn, c))
        log(f"[e2e] track prn {prn:2d}: last-200 |carrier_f - truth| <= "
            f"{np.abs(cf - dop).max():.3f} Hz, C/N0 {c:.2f} dB-Hz")
    la, lt = acquire2.LAUNCHES, track_fused.LAUNCHES
    log(f"[e2e] launches on the main path: acquire2 {la}, track_fused {lt}")
    check(la > 0 and lt > 0, (la, lt))
    check(lt >= 2, "tracking never crossed a chunk refill")
    results["acquire2"]["launches"] = la
    results["track_fused"]["launches"] = lt
    log(f"[e2e] wall: synth {t_synth:.2f} s, acquire {t_acq:.2f} s, "
        f"track {nblocks} blocks x 8 ch {t_trk:.2f} s, cn0 {t_cn0:.2f} s  "
        f"[{card}]")
    os.remove(path)


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("_work", "smoke"),
                    help="scratch directory for the synthetic capture")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gnss_dsp_tpu_torch.device import resolve_device
    from gnss_dsp_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    card = card_line()
    results = {k: dict(name=k, **v, launches=0, max_abs_err=None, ms=None,
                       plain_ms=None) for k, v in KERNELS.items()}
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    _build.load()
    info = _build.BUILD_INFO
    log(f"[build] {os.path.basename(info['path'])} in "
        f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "error" in line or "smem" in line:
            log(f"[build] {line.strip()}")
    os.makedirs(args.out, exist_ok=True)
    phase_k1(dev, card, results)
    phase_k2(dev, card, results)
    phase_k2_main_path(dev, results, args.out)
    phase_e2e(dev, card, results, args.out)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
