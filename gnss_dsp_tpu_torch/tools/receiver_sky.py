"""The 2017 three-band sky: the reference's flagship tracking workload.

    python -m gnss_dsp_tpu_torch.tools.receiver_sky [--seconds S]
        [--chunk-ms MS] [--out DIR] [--device cuda]

Eleven channels of eleven signals over L1, L2 and L5 at 69.984 MHz, the
golden seeds of track-all-gnss-2017-L1L2L5.sh:9-25 with their band
offsets (the JAX package's tools/synth_sky.SEEDS and
tools/run_long_receiver.BANDS).  synth_bands writes the three int8 band
streams, synthesised on the device in chunks (tools/track_all.synth_iq_t
with the absolute sample index, so the chunks join exactly, as
tools/synth_sky.py generates them), every seed at `cn0` dB-Hz.
run_per_band tracks each band with the `track multi` CLI, run_receiver
all of them in one program (track/receiver.track_receiver), and validate
holds each channel as run_long_receiver.validate does: at least 0.9 rows
a millisecond, the median carrier_f of the last 200 rows within 8 Hz of
the seed, the prompt above early and late.  scans_held_to_plain holds
every scan the receiver launches against the plain version on the same
arguments.  main runs both and prints the walls and the capture seconds
a wall second.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

FS = 69.984e6
# band -> [(signal, prn or FDMA channel, doppler, code phase, coffset)]
BANDS = {
    1: [("gps-l1", 21, 2400.0, 817.50, -9334875.0),
        ("glonass-l1", -3, -1200.0, 362.82, 17245125.0),
        ("galileo-e1b", 24, 250.0, 2838.00, -9334875.0),
        ("beidou-b1i", 34, -600.0, 562.20, -23656875.0)],
    2: [("gps-l2cm", 29, 1120.0, 4208.80, -127126.0),
        ("glonass-l2", -2, -1800.0, 470.98, 18272874.0),
        ("glonass-l3ocd", 9, -1800.0, 9429.00, -25702126.0),
        ("galileo-e5bi", 24, 200.0, 7919.00, -20587126.0),
        ("beidou-b2i", 14, -600.0, 1682.90, -20587126.0)],
    3: [("gps-l5i", 25, -1600.0, 9696.00, -15191625.0),
        ("galileo-e5ai", 24, 200.0, 7919.00, -15191625.0)],
}
CHUNK_MS = 125            # synthesis chunk


def synth_bands(paths, seconds, bands=BANDS, fs=FS, cn0=45.0,
                device="cuda", seed=20170427, overlays=None):
    """Write each band's int8 I/Q stream to paths[band]: its seeds (the
    carrier at doppler + FDMA channel + band offset, the code at the
    doppler) and one noise array at cn0 dB-Hz a unit seed, 4 standard
    deviations at int8 100 (tools/synth_sky.write_capture).  overlays:
    {band: [each seed's overlay chip of its first tracked period, or
    None]} plants the secondary codes so that a channel tracked from its
    first code boundary reads that chip first."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t

    n = int(fs * seconds)
    frame = int(fs * CHUNK_MS / 1000)
    sigma = float(np.sqrt(fs / (2.0 * 10 ** (cn0 / 10.0))))
    scale = 100.0 / (4.0 * sigma)
    for b, seeds in bands.items():
        with open(paths[b], "wb") as f:
            for k, t0 in enumerate(range(0, n, frame)):
                m = min(frame, n - t0)
                x = torch.zeros(m, dtype=torch.complex64, device=device)
                for j, (name, prn, dop, cp, coff) in enumerate(seeds):
                    sig = get_signal(name)
                    chan = prn if sig.fdma_hz else 0
                    ph = (overlays or {}).get(b, [None] * len(seeds))[j]
                    bits = (None if ph is None else
                            np.roll(sig.secondary(prn), 1 - int(ph)))
                    x += synth_iq_t(sig.code_table((prn,))[0], sig.chip_rate,
                                    fs, m, dop + sig.fdma_hz * chan + coff,
                                    cp, sig.subcarrier,
                                    sig.track_carrier_ratio(chan),
                                    code_doppler_hz=dop, device=device,
                                    data_bits=bits, t0=t0)
                g = torch.Generator(device=device).manual_seed(
                    seed * 1000 + 100 * b + k)
                x += sigma * torch.complex(
                    torch.randn(m, generator=g, device=device),
                    torch.randn(m, generator=g, device=device))
                iq = torch.view_as_real(x * scale).round().clamp(-127, 127)
                f.write(iq.to(torch.int8).cpu().numpy().tobytes())
    return n


def band_spec(seeds):
    return ",".join(f"{s}:{p}:{d}:{c}:{co}" for s, p, d, c, co in seeds)


def run_per_band(paths, device, chunk_ms, bands=BANDS, fs=FS, extra=()):
    """Each band through `track multi` (cli/track.main_multi), in turn.
    Returns ({"SIG:prn": [row text]}, {band: wall seconds})."""
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.tools.main_path import run_cli

    rows, walls = {}, {}
    for b, seeds in bands.items():
        t0 = time.perf_counter()
        out = run_cli(trk_cli.main, "multi", list(extra) + [
            "--chunk-ms", str(chunk_ms), paths[b], str(fs), "0",
            band_spec(seeds), "--device", str(device)])
        walls[b] = time.perf_counter() - t0
        for s, p, *_ in seeds:
            rows[f"{s}:{p}"] = []
        for line in out.splitlines():
            key, rest = line.split(" ", 1)
            rows[key].append(rest)
    return rows, walls


def run_receiver(paths, device, chunk_ms, bands=BANDS, fs=FS,
                 coherent_blocks=1, overlay_phase=None, stats=None,
                 max_blocks=None):
    """Every band in one program (track_receiver; `stats` its stats
    dict).  Returns ({"SIG:prn": [row dict]}, wall seconds)."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track.driver import TrackChannel
    from gnss_dsp_tpu_torch.track.receiver import track_receiver

    args, fps = [], []
    for b, seeds in bands.items():
        fps.append(open(paths[b], "rb"))
        phases = (overlay_phase or {}).get(b, [0] * len(seeds))
        args.append((fps[-1], [get_signal(s) for s, *_ in seeds],
                     [TrackChannel(prn=p, doppler=d, code_offset=c,
                                   overlay_phase=int(ph))
                      for (_, p, d, c, _co), ph in zip(seeds, phases)],
                     [co for *_x, co in seeds]))
    try:
        t0 = time.perf_counter()
        out = track_receiver(args, fs, chunk_ms=chunk_ms, device=device,
                             coherent_blocks=coherent_blocks, stats=stats,
                             max_blocks=max_blocks)
        wall = time.perf_counter() - t0
    finally:
        for f in fps:
            f.close()
    keys = [f"{s}:{p}" for seeds in bands.values() for s, p, *_ in seeds]
    return {k: ch.rows for k, ch in zip(keys, out)}, wall


@contextlib.contextmanager
def scans_held_to_plain():
    """Within: every scan track_receiver runs is run again by the plain
    version (track/engine.track_scan_plain) on the same arguments, the
    receiver's own (the chunk of band segments, each channel's segment
    end as its chunk_len, pointers inside its band's segment, the state
    after the rebase), and its rows, int rows and state must be
    bit-equal.  Yields a list that receives each held scan's block
    count."""
    import torch

    from gnss_dsp_tpu_torch.track import engine, receiver

    held = []
    scan = receiver.track_scan

    def both(x, chunk_len, code_tab, state, params, n_blocks, **kw):
        k = scan(x, chunk_len, code_tab, state, params, n_blocks, **kw)
        p = engine.track_scan_plain(x, chunk_len, code_tab, state, params,
                                    n_blocks, **kw)
        torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], p[1], rtol=0, atol=0,
                                   equal_nan=True)
        for field, a, b in zip(k[0]._fields, k[0], p[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"state {field}")
        held.append(n_blocks)
        return k

    receiver.track_scan = both
    try:
        yield held
    finally:
        receiver.track_scan = scan


def _fields(row):
    """(carrier_f, early, prompt, late) of a row dict or row text."""
    if isinstance(row, str):
        t = row.split()
        return float(t[3]), float(t[6]), float(t[7]), float(t[8])
    return row["carrier_f"], row["early"], row["prompt"], row["late"]


def validate(rows, seconds, bands=BANDS, tol_hz=8.0):
    """run_long_receiver.validate on each channel: (lines, failures)."""
    lines, fails = [], []
    for seeds in bands.values():
        for s, p, dop, *_ in seeds:
            key = f"{s}:{p}"
            r = rows[key]
            tail = np.array([_fields(v) for v in r[-200:]])
            cf = float(np.median(tail[:, 0]))
            pr = float(np.median(tail[:, 2]))
            el = float(np.median(np.maximum(tail[:, 1], tail[:, 3])))
            ok = (len(r) >= seconds * 1000 * 0.9 and abs(cf - dop) < tol_hz
                  and pr > el)
            lines.append(f"{key:18s} rows {len(r):6d} carrier {cf:9.2f} "
                         f"(want {dop:7.1f}) P/EL {pr / max(el, 1e-9):.2f} "
                         f"{'OK' if ok else 'FAIL'}")
            if not ok:
                fails.append(key)
    return lines, fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--chunk-ms", type=float, default=500.0)
    ap.add_argument("--cn0", type=float, default=45.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("_work", "receiver_sky"))
    args = ap.parse_args(argv)

    from gnss_dsp_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    paths = {b: os.path.join(args.out, f"band{b}.iq") for b in BANDS}
    t0 = time.perf_counter()
    synth_bands(paths, args.seconds, cn0=args.cn0, device=dev)
    print(f"synthesised {args.seconds} s x 3 bands in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fails = []
    per, walls = run_per_band(paths, dev, args.chunk_ms)
    lines, bad = validate(per, args.seconds)
    fails += bad
    print("\n".join(lines))
    one, wall = run_receiver(paths, dev, args.chunk_ms)
    lines, bad = validate(one, args.seconds)
    fails += bad
    print("\n".join(lines))
    total = sum(walls.values())
    print(f"per band: {total:.2f} s wall ({args.seconds / total:.3f} x "
          f"realtime); one program: {wall:.2f} s ({args.seconds / wall:.3f}"
          f" x realtime)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
