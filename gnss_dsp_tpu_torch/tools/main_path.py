"""The GPS L1 main path as one scenario, and a profile of it on the card.

    python -m gnss_dsp_tpu_torch.tools.main_path [--out DIR]

synth_capture writes a synthetic GPS L1 capture (eight satellites at
45 dB-Hz, int8 I/Q); run_cli calls a CLI's main() in this process and
returns what it printed.  chip_smoke.py uses both.

synth_b1i writes the BeiDou B1I capture of the extended-coherent path
(six satellites with their NH20 overlay at 32 dB-Hz, 16.368 MHz), and
synth_at_acq_fs the captures of the wide-window acquisition path (four
satellites, or Xona X5's one, at 45 dB-Hz and the signal's own internal
rate and subcarrier).  synth_fdma writes a GLONASS L1/L2 capture (FDMA
channels, each band offset in its carrier only) and synth_serial one
satellite of an assisted serial search planted at hypothesis k.

synth_coherent_track writes a capture for coherent tracking (satellites
at 32 dB-Hz, all from one overlay phase: the same six B1I satellites at
16.368 MHz, or chip_smoke.py's four GPS L5Q ones at 30.69 MHz),
acquire_coherent runs the acquire CLI's coherent path on it, and
coherent_track_args hands its results to the track CLI (--coherent M
--overlay-phase k).

Run as a program on a CUDA card, this module drives the coherent acquire
CLI on the B1I capture (--coherent 20 --time 40, 63 PRNs, 25 Hz grid),
then the acquire CLI and the track CLI on chip_smoke.py's GPS L1 capture
(2.2 s at 8.184 MHz, 2150 tracked blocks), the coherent acquire CLI on the
same capture (--coherent 8 --time 80, 32 PRNs over +-6 kHz at 62.5 Hz:
K6 at A = 1), the same two with --mesh 1 (the
sharded paths on a 1 x 1 mesh), then the acquire CLI on the
wide-window captures of WIDE_STAGES (default PRNs and doppler grid,
--time 80), the coherent acquire CLI on the captures of COHERENT_WIDE
(K5 at 32768-163840, as chip_smoke.py's e2e_coherent_wide), the FDMA
acquire CLI on an 85 ms GLONASS L1 capture (synth_fdma: 4 of the 15
channels, default grid, --time 80: K1 with one code row), the GLONASS L1 P
serial acquire CLI (synth_serial: channel 3 at hypothesis 417 of 1000,
16.384 MHz, --time 80), the coherent
track CLI (--coherent 20, K2) on a 1.2 s B1I capture from its coherent
acquisition and on a 1.2 s GPS L5Q one (4 satellites at 30.69 MHz, its
acquisition K5 at 65536), then the track CLI on a 2.2 s galileo-e1b
capture of 8 satellites (tools/track_all.synth_track) on K2 and again
under GNSS_DSP_NO_FUSED on the per-step route (K3), each once cold and
once warm under torch.profiler
with CUDA activity.  It prints one JSON object: per stage
the cold and warm host walls, the device busy time (the union of the
trace's device events: kernels and copies), the idle share
1 - busy / warm wall, and the costliest device events (for the GPS L1
--coherent 8 stage also K6's share of the busy time); then the
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

# wide-window acquisitions profiled: K1 padded (n_valid), K1 at 65536,
# K7 at 30690
WIDE_STAGES = ("gps-l5i", "galileo-e1b", "xona-x5d")
# the extended-coherent searches at the wide windows (chip_smoke.py's
# e2e_coherent_wide, profiled here too), one per window class: (signal,
# M, --time ms, doppler step Hz, C/N0 dB-Hz), the grid about 1 / (2 x the
# coherent span) over +-500 Hz.  The CLI prepares --time + 2 ms, and the
# 2n linear windows of the last block reach one code period past it:
# galileo-e1c's 25 blocks of 4 ms need 104 ms (--time 104), gps-l2cm's 2
# of 20 ms need 60 (--time 60; both keep their 25 and 2 blocks)
COHERENT_WIDE = (("gps-l5q", 20, 40, 25.0, 32.0),
                 ("galileo-e1c", 25, 104, 5.0, 32.0),
                 ("galileo-e6c", 100, 100, 5.0, 32.0),
                 ("gps-l1cd", 2, 20, 25.0, 45.0),
                 ("gps-l2cm", 2, 60, 12.5, 45.0))

# the GLONASS L1 P serial stage: (capture rate, FDMA channel, planted
# hypothesis k, C/A code phase, doppler)
SERIAL_P = (16.384e6, 3, 417, 33.0, -700.0)

E2E_PRNS = (3, 8, 12, 17, 21, 24, 28, 31)
E2E_DOPS = (-5437.0, -3811.0, -2206.0, -577.0, 1049.0, 2633.0, 4188.0, 5794.0)


def synth_capture(path, fs, seconds, seed=7):
    """Eight GPS L1 satellites summed noiselessly plus ONE noise array at
    45 dB-Hz per satellite, written to `path` as int8 I/Q.  Returns the
    truth: prns, dops, phases (chips), the clip fraction and the scale."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

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


B1I_PRNS = (6, 11, 19, 27, 37, 45)
B1I_FS = 16.368e6
B1I_COHERENT = ["--coherent", "20", "--time", "40", "--doppler-search",
                "-2500,2500,25"]


def synth_b1i(path, fs, seconds, cn0=32.0, seed=11):
    """Six BeiDou B1I satellites, each with its NH20 overlay from a
    random phase, plus one noise array at `cn0` dB-Hz per satellite,
    written to `path` as int8 I/Q.  Returns the truth."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("beidou-b1i")
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    dops = rng.uniform(-2000.0, 2000.0, len(B1I_PRNS)).round(1)
    phases = rng.uniform(0.0, sig.code_length, len(B1I_PRNS)).round(2)
    rolls = rng.integers(0, 20, len(B1I_PRNS))
    x = np.zeros(n, np.complex64)
    for prn, dop, cp, r in zip(B1I_PRNS, dops, phases, rolls):
        x += synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                      sig.chip_rate, fs, n, doppler_hz=float(dop),
                      code_phase=float(cp), cn0_dbhz=None,
                      carrier_ratio=sig.carrier_ratio,
                      data_bits=np.roll(sig.secondary(prn), -int(r)))
    sigma = np.sqrt(fs / (2.0 * 10 ** (cn0 / 10.0)))
    x += (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    scale = 127.0 / (4.0 * float(np.std(x.real)))
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=scale))
    return dict(prns=B1I_PRNS, dops=dops, phases=phases,
                code_length=sig.code_length)


B1I_TRACK_ROLL = 7         # the capture starts 7 chips into the NH20 overlay
B1I_TRACK_SECONDS = 1.2
# coherent GPS L5Q acquire -> track: 4 satellites at 30.69 MHz, the
# acquisition's K5 at the padded 65536 window over +-500 Hz
L5Q_PRNS = (4, 13, 22, 29)
L5Q_FS = 30.69e6
L5Q_COHERENT = ["--coherent", "20", "--time", "40", "--doppler-search",
                "-500,500,25"]


def synth_coherent_track(path, name, prns, fs, seconds, cn0=32.0,
                         roll=B1I_TRACK_ROLL, seed=13, device="cuda",
                         dmax=2000.0, step=25.0):
    """Satellites `prns` of signal `name` for coherent tracking,
    synthesised on `device`: every satellite from the same overlay phase
    (code period p carries overlay chip (roll + p) mod N, so one
    --overlay-phase serves all), dopplers within 4 Hz of a `step` Hz
    acquisition grid inside +-dmax (as tests/test_coherent.py plants its
    doppler on its grid: a 20 ms coherent PLL pulls in over less than a
    quarter cycle a period), random code phases, one noise array at `cn0`
    dB-Hz per satellite, written to `path` as int8 I/Q.  Returns the
    truth."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t, write_noisy

    sig = get_signal(name)
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    grid = np.round(rng.uniform(-dmax, dmax, len(prns)) / step) * step
    dops = (grid + rng.uniform(-4.0, 4.0, len(prns))).round(1)
    phases = rng.uniform(0.0, sig.code_length, len(prns)).round(2)
    x = torch.zeros(n, dtype=torch.complex64, device=device)
    for prn, dop, cp in zip(prns, dops, phases):
        x += synth_iq_t(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                        float(dop), float(cp), sig.subcarrier,
                        sig.carrier_ratio, device=device,
                        data_bits=np.roll(sig.secondary(prn), -roll))
    write_noisy(path, x, fs, cn0, seed)
    N = len(sig.secondary(prns[0]))
    return dict(prns=tuple(prns), dops=dops, phases=phases, fs=fs, cn0=cn0,
                overlay_phase=(roll + 1) % N, code_length=sig.code_length)


def acquire_coherent(path, name, fs, device, m_coh=20, ms=40,
                     doppler_search=(-2500.0, 2500.0, 25.0), prns=None):
    """The acquire CLI's `name` --coherent m_coh --time ms path on the
    capture at `path` (read_samples, prepare_baseband,
    acquire_signal_coherent; every default PRN unless `prns`), returning
    the CoherentAcqResults: their track_overlay_phase seeds coherent
    tracking."""
    from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
    from gnss_dsp_tpu_torch.cli.acquire import read_samples
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops.frontend import prepare_baseband

    sig = get_signal(name)
    x = read_samples(path, int((ms + 5) * fs / 1000), device)
    xb = prepare_baseband(x, fs, 0.0, sig.acq_fs, sig.acq_lowpass_hz, ms + 2)
    return acquire_signal_coherent(sig, xb, prns or sig.prns(),
                                   doppler_search, m_coh=m_coh, ms=ms)


def coherent_track_args(name, hits, prns, path, fs, device, m=20):
    """The track CLI's arguments for the coherent tracking of `prns` of
    signal `name` from their coherent acquisition `hits` ({prn:
    CoherentAcqResult}): M = m, the overlay phase the hits agree on, PLL
    from the start (as tests/test_coherent.py's handoff)."""
    from gnss_dsp_tpu_torch.models import get_signal

    L = get_signal(name).code_length
    phases = {hits[p].track_overlay_phase(L) for p in prns}
    if len(phases) != 1:
        raise RuntimeError(f"overlay phases disagree: {phases}")
    spec = ",".join(f"{p}:{hits[p].doppler}:{hits[p].code_offset}"
                    for p in prns)
    return ["--coherent", str(m), "--overlay-phase", str(phases.pop()),
            "--carrier-phase", "0", path, str(fs), "0", spec, "--device",
            str(device)]


def synth_at_acq_fs(path, name, seconds, cn0=45.0, seed=5, count=4,
                    dop_max=None, overlay=False, phase_max=None):
    """`count` satellites of signal `name` (its default PRN list; all of
    it when shorter) at random dopplers and random code phases, with its
    subcarrier, plus one noise array at `cn0` dB-Hz per satellite,
    sampled at the signal's acq_fs and written to `path` as int8 I/Q.
    The dopplers lie inside the default grid (and within +-dop_max) and
    are small enough that the code drifts at most half a chip over the
    capture (doppler / carrier_ratio chips per second): the searches do
    not follow code doppler, so a larger drift smears the peak over chips.
    With `overlay` each satellite carries its secondary code from a random
    chip (truth "rolls": code period p carries chip (roll + p) mod N);
    without, no data bit changes sign.  Code phases are random in [0,
    phase_max) chips (default: the code length).  Returns the truth."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

    sig = get_signal(name)
    fs = sig.acq_fs
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    prns = sorted(rng.permutation(sig.prns())[:count].tolist())
    dmin, dmax, _ = sig.doppler_default
    drift = 0.5 * sig.carrier_ratio / seconds
    if dop_max is not None:
        drift = min(drift, dop_max)
    dops = rng.uniform(max(0.8 * dmin, -drift), min(0.8 * dmax, drift),
                       len(prns)).round(1)
    phases = rng.uniform(0.0, phase_max or sig.code_length,
                         len(prns)).round(2)
    rolls = (rng.integers(0, len(sig.secondary(prns[0])), len(prns))
             if overlay else np.zeros(len(prns), np.int64))
    x = np.zeros(n, np.complex64)
    for prn, dop, cp, r in zip(prns, dops, phases, rolls):
        x += synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                      sig.chip_rate, fs, n, doppler_hz=float(dop),
                      code_phase=float(cp), cn0_dbhz=None,
                      subcarrier=sig.subcarrier,
                      carrier_ratio=sig.carrier_ratio,
                      data_bits=(np.roll(sig.secondary(prn), -int(r))
                                 if overlay else None))
    sigma = np.sqrt(fs / (2.0 * 10 ** (cn0 / 10.0)))
    x += (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    scale = 127.0 / (4.0 * float(np.std(x.real)))
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=scale))
    return dict(prns=tuple(prns), dops=dops, phases=phases, fs=fs,
                code_length=sig.code_length, rolls=rolls)


def synth_fdma(path, name, seconds, count=4, cn0=45.0, seed=5,
               dop_max=450.0, device="cuda"):
    """`count` channels of the FDMA signal `name` (GLONASS L1/L2, among
    its default channels) at random dopplers within +-dop_max and random
    code phases, each with its band offset in the carrier only (the code
    rate rides the true doppler), plus one noise array at `cn0` dB-Hz per
    channel, sampled at the signal's acq_fs on `device` and written to
    `path` as int8 I/Q.  Returns the truth (prns: the channels)."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t, write_noisy

    sig = get_signal(name)
    fs = sig.acq_fs
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    chans = sorted(rng.permutation(sig.prns())[:count].tolist())
    dops = rng.uniform(-dop_max, dop_max, len(chans)).round(1)
    phases = rng.uniform(0.0, sig.code_length, len(chans)).round(2)
    x = torch.zeros(n, dtype=torch.complex64, device=device)
    for c, dop, cp in zip(chans, dops, phases):
        x += synth_iq_t(sig.code_table((c,))[0], sig.chip_rate, fs, n,
                        float(dop) + sig.fdma_hz * c, float(cp), "none",
                        sig.track_carrier_ratio(c), code_doppler_hz=float(dop),
                        device=device)
    write_noisy(path, x, fs, cn0, seed)
    return dict(prns=tuple(chans), dops=dops, phases=phases, fs=fs,
                code_length=sig.code_length)


def synth_serial(path, name, fs, seconds, prn, k, parent_code_phase,
                 doppler, cn0=45.0, seed=5, device="cuda"):
    """One satellite of the serial-search signal `name` (GPS L2CL with its
    RZ half-chips, GLONASS P on FDMA channel `prn`) at `fs`, its code at
    chip (k * stride + scale * parent_code_phase) mod L at sample 0, the
    hypothesis k of the assisted search, plus noise at `cn0` dB-Hz,
    written to `path` as int8 I/Q on `device`.  Returns the code phase."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t, write_noisy

    sig = get_signal(name)
    chan = prn if sig.fdma_hz else 0
    phase = (k * sig.acq_serial_stride
             + sig.acq_serial_scale * parent_code_phase) % sig.code_length
    x = synth_iq_t(sig.code_table((prn,))[0], sig.chip_rate, fs,
                   int(fs * seconds), doppler + sig.fdma_hz * chan, phase,
                   sig.subcarrier, sig.track_carrier_ratio(chan),
                   code_doppler_hz=doppler, device=device)
    write_noisy(path, x, fs, cn0, seed)
    return phase


@contextlib.contextmanager
def environ(env):
    """os.environ updated with `env` inside, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def returns_of(module, fn):
    """Yields a list that collects what module.fn returns while inside
    (the acquire CLI prints no overlay alignment: its CoherentAcqResults
    carry it)."""
    seen, orig = [], getattr(module, fn)

    def spy(*a, **kw):
        r = orig(*a, **kw)
        seen.append(r)
        return r

    setattr(module, fn, spy)
    try:
        yield seen
    finally:
        setattr(module, fn, orig)


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


def _profiled(name, fn, args, out_dir, share_of=None):
    """(text, numbers) of the CLI main `fn` on `args`, cold, then warm
    under torch.profiler; with share_of, the device time of the kernels
    whose name contains one of those strings over the busy time
    ("share")."""
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
    out = dict(cold_s=cold, warm_s=warm, device_busy_s=busy_us / 1e6,
               idle_share=1.0 - busy_us / 1e6 / warm,
               top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                    for e in top])
    if share_of:
        out["share"] = sum(e.self_device_time_total for e in ka
                           if any(k in e.key for k in share_of)) / busy_us
    return text, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    seconds, blocks = 2.2, 2150

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.device import resolve_device
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_track

    resolve_device("cuda")
    os.makedirs(args.out, exist_ok=True)
    fs = 8.184e6
    path = os.path.join(args.out, "main_path.iq")
    truth = synth_capture(path, fs, seconds)
    b1i = os.path.join(args.out, "main_path_b1i.iq")
    b1i_truth = synth_b1i(b1i, B1I_FS, 0.050)
    try:
        text, coh = _profiled("acquire_coherent", acq_cli.main,
                              ("beidou-b1i", B1I_COHERENT + [
                                  b1i, str(B1I_FS), "0", "--device", "cuda"]),
                              args.out)
        hits = parse_hits(text)
        for prn, dop in zip(b1i_truth["prns"], b1i_truth["dops"]):
            if abs(hits[prn]["doppler"] - dop) > 25.0:
                raise RuntimeError(f"beidou-b1i prn {prn} missed: {hits[prn]}")
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
        # the flagship's weak-signal search: K6 at A = 1 (its combine
        # kernel, then K5's surface kernel, which this search runs only
        # through K6)
        text, coh_l1 = _profiled(
            "acquire_coherent_gps_l1", acq_cli.main,
            ("gps-l1", ["--coherent", "8", "--time", "80",
                        "--doppler-search", "-6000,6000,62.5", path, str(fs),
                        "0", "--device", "cuda"]), args.out,
            share_of=("combine_", "coh_spec_kernel"))
        hits = parse_hits(text)
        for prn, dop in zip(truth["prns"], truth["dops"]):
            if abs(hits[prn]["doppler"] - dop) > 62.5:
                raise RuntimeError(f"gps-l1 --coherent 8 prn {prn} missed: "
                                   f"{hits[prn]}")
        # the same two calls through the sharded paths (--mesh 1: on one
        # card a 1 x 1 mesh; K1's surface and the torch reduction in place
        # of K1's reduction, K2 through track_scan_sharded)
        _, acq_mesh = _profiled("acquire_mesh", acq_cli.main,
                                ("gps-l1", ["--mesh", "1", path, str(fs),
                                            "0", "--device", "cuda"]),
                                args.out)
        _, trk_mesh = _profiled("track_mesh", trk_cli.main,
                                ("gps-l1", ["--mesh", "1", "--blocks",
                                            str(blocks), "--device", "cuda",
                                            path, str(fs), "0", spec]),
                                args.out)
        wide = {}
        for name in WIDE_STAGES:
            wpath = os.path.join(args.out, f"main_path_{name}.iq")
            wt = synth_at_acq_fs(wpath, name, 0.085)
            try:
                text, wide[name] = _profiled(
                    f"acquire_{name}", acq_cli.main,
                    (name, ["--time", "80", wpath, str(wt["fs"]), "0",
                            "--device", "cuda"]), args.out)
            finally:
                os.remove(wpath)
            hits = parse_hits(text)
            step = get_signal(name).doppler_default[2]
            for prn, dop in zip(wt["prns"], wt["dops"]):
                if abs(hits[prn]["doppler"] - dop) > step:
                    raise RuntimeError(f"{name} prn {prn} missed: {hits[prn]}")
        coh_wide = {}
        for i, (name, m, ms, step, cn0) in enumerate(COHERENT_WIDE):
            wpath = os.path.join(args.out, f"main_path_coh_{name}.iq")
            wt = synth_at_acq_fs(wpath, name, (ms + 6) / 1000.0, cn0=cn0,
                                 seed=30 + i, dop_max=450.0,
                                 overlay=get_signal(name).secondary
                                 is not None)
            try:
                text, coh_wide[name] = _profiled(
                    f"acquire_coherent_{name}", acq_cli.main,
                    (name, ["--coherent", str(m), "--time", str(ms),
                            "--doppler-search", f"-500,500,{step:g}", wpath,
                            str(wt["fs"]), "0", "--device", "cuda"]),
                    args.out)
            finally:
                os.remove(wpath)
            hits = parse_hits(text)
            for prn, dop in zip(wt["prns"], wt["dops"]):
                if abs(hits[prn]["doppler"] - dop) > step:
                    raise RuntimeError(f"{name} prn {prn} missed: {hits[prn]}")
        # GLONASS L1 FDMA (K1, one code row against 15 x 70 increments)
        # and the GLONASS L1 P serial search (1000 hypotheses, no kernel)
        fpath = os.path.join(args.out, "main_path_glonass_l1.iq")
        ft = synth_fdma(fpath, "glonass-l1", 0.085, seed=61)
        try:
            text, fdma = _profiled(
                "acquire_fdma_glonass_l1", acq_cli.main,
                ("glonass-l1", ["--time", "80", fpath, "%d" % ft["fs"], "0",
                                "--device", "cuda"]), args.out)
        finally:
            os.remove(fpath)
        hits = parse_hits(text)
        for chan, dop in zip(ft["prns"], ft["dops"]):
            if abs(hits[chan]["doppler"] - dop) > 200.0:
                raise RuntimeError(f"glonass-l1 chan {chan} missed: "
                                   f"{hits[chan]}")
        spath = os.path.join(args.out, "main_path_glonass_l1_p.iq")
        synth_serial(spath, "glonass-l1-p", SERIAL_P[0], 0.083,
                     *SERIAL_P[1:])
        try:
            text, serial = _profiled(
                "acquire_serial_glonass_l1_p", acq_cli.main,
                ("glonass-l1-p", ["--time", "80", spath, "%d" % SERIAL_P[0],
                                  "0", str(SERIAL_P[1]), str(SERIAL_P[4]),
                                  str(SERIAL_P[3]), "--device", "cuda"]),
                args.out)
        finally:
            os.remove(spath)
        psig = get_signal("glonass-l1-p")
        if text.split()[0] != "%f" % (psig.acq_serial_stride * SERIAL_P[2]
                                      + psig.acq_serial_scale * SERIAL_P[3]):
            raise RuntimeError(f"glonass-l1-p missed: {text}")
        cpath = os.path.join(args.out, "main_path_b1i_track.iq")
        ct = synth_coherent_track(cpath, "beidou-b1i", B1I_PRNS, B1I_FS,
                                  B1I_TRACK_SECONDS)
        try:
            hits = {r.prn: r for r in acquire_coherent(
                cpath, "beidou-b1i", B1I_FS, "cuda")}
            text, coh_trk = _profiled(
                "track_coherent_b1i", trk_cli.main,
                ("beidou-b1i", coherent_track_args(
                    "beidou-b1i", hits, ct["prns"], cpath, B1I_FS, "cuda")),
                args.out)
        finally:
            os.remove(cpath)
        coh_trk["rows"] = len(text.splitlines())
        lpath = os.path.join(args.out, "main_path_l5q_track.iq")
        lt = synth_coherent_track(lpath, "gps-l5q", L5Q_PRNS, L5Q_FS,
                                  B1I_TRACK_SECONDS, dmax=400.0, seed=17)
        try:
            hits = {r.prn: r for r in acquire_coherent(
                lpath, "gps-l5q", L5Q_FS, "cuda",
                doppler_search=(-500.0, 500.0, 25.0))}
            text, l5q_trk = _profiled(
                "track_coherent_l5q", trk_cli.main,
                ("gps-l5q", coherent_track_args(
                    "gps-l5q", hits, lt["prns"], lpath, L5Q_FS, "cuda")),
                args.out)
        finally:
            os.remove(lpath)
        l5q_trk["rows"] = len(text.splitlines())
        # the per-step route last: its ~600,000 device events a call can
        # leave the profiler's later traces without their kernels
        tpath = os.path.join(args.out, "main_path_galileo_e1b.iq")
        tt = synth_track(tpath, "galileo-e1b", seconds, count=8, seed=40)
        try:
            targs = ("galileo-e1b", [tpath, str(tt["fs"]), "0", ",".join(
                f"{p}:{d}:{c}" for p, d, c in zip(
                    tt["prns"], tt["dops"], tt["phases"])),
                "--device", "cuda"])
            text, fam = _profiled("track_galileo_e1b", trk_cli.main, targs,
                                  args.out)
            fam["rows"] = len(text.splitlines())
            with environ({"GNSS_DSP_NO_FUSED": "1"}):
                text, step = _profiled("track_galileo_e1b_no_fused",
                                       trk_cli.main, targs, args.out)
            step["rows"] = len(text.splitlines())
        finally:
            os.remove(tpath)
    finally:
        os.remove(path)
        os.remove(b1i)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(acquire=acq, track=trk,
                          acquire_coherent_gps_l1=coh_l1,
                          acquire_mesh=acq_mesh,
                          track_mesh=trk_mesh, acquire_coherent=coh,
                          acquire_wide=wide, acquire_coherent_wide=coh_wide,
                          track_galileo_e1b=fam,
                          track_step_galileo_e1b=step,
                          track_coherent_b1i=coh_trk,
                          track_coherent_l5q=l5q_trk,
                          acquire_fdma_glonass_l1=fdma,
                          acquire_serial_glonass_l1_p=serial,
                          seconds=seconds,
                          blocks=blocks, channels=len(truth["prns"]),
                          card=card), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
