"""Synthesis of int8 I/Q captures on the card, from the seed.

`subcarrier_t` and `synth_iq_t` are frozen copies of
gnss_dsp_tpu_torch/tools/track_all._subcarrier_t and synth_iq_t at
commit 196026d (unchanged but for the names).  `synth_band` follows
gnss_dsp_tpu_torch/tools/receiver_sky.synth_bands at that commit: each
seed's carrier at doppler + FDMA channel + band offset and its code at
the doppler, one noise array a band at the reference C/N0 a unit seed,
4 standard deviations at int8 100.  Changed: the code tables come from
the benchmark's frozen catalog (gnssbench/reference/models), each seed
carries its own C/N0 (its amplitude against the reference level), the
noise generator is seeded from the run's seed, and the bytes are
returned in memory instead of written to a fixed file.
"""

from __future__ import annotations

import numpy as np

CHUNK_MS = 125            # synthesis chunk
CN0_REF = 45.0            # the noise floor's C/N0 for a unit seed


def subcarrier_t(sub, cp):
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
               data_bits=None, t0=0):
    """utils.synth.synth_iq (noiseless) in torch on `device`: complex64
    [n], samples t0 to t0 + n of the signal.  Phases are float64 in the
    absolute sample index (so chunks with increasing t0 join exactly);
    the carrier phase wraps to [0, 1) before it drops to float32.
    data_bits: one +-1 per code period, period floor(code phase / L)
    taking data_bits[that mod len]."""
    import torch

    t = torch.arange(t0, t0 + n, dtype=torch.float64, device=device)
    cd = doppler_hz if code_doppler_hz is None else code_doppler_hz
    cp = code_phase + t * ((chip_rate + cd / carrier_ratio) / fs)
    tab = torch.as_tensor(np.asarray(code, np.float32), device=device)
    chips = tab[torch.remainder(torch.floor(cp).to(torch.int64), len(code))]
    if subcarrier != "none":
        chips = chips * subcarrier_t(subcarrier, cp).to(torch.float32)
    if data_bits is not None:
        bits = torch.as_tensor(np.asarray(data_bits, np.float32),
                               device=device)
        chips = chips * bits[torch.remainder(
            torch.floor(cp / len(code)).to(torch.int64), len(bits))]
    phi = torch.remainder(doppler_hz / fs * t, 1.0).to(torch.float32) \
        * np.float32(2 * np.pi)
    return torch.complex(chips * torch.cos(phi), chips * torch.sin(phi))


def noise_seed(seed: int, band: int, chunk: int) -> int:
    """The torch.Generator seed of one band's noise chunk: a function of
    the run's seed (any size) alone."""
    return (int(seed) * 1000003 + 1009 * int(band) + int(chunk)) % (1 << 62)


def synth_band(seeds, fs: float, seconds: float, seed: int, band: int,
               device) -> np.ndarray:
    """One band's interleaved int8 I/Q bytes (host int8 [2 n]): the sum
    of its seeds (each a dict with signal, prn, doppler, code_phase,
    coffset, cn0) and the band's noise, quantised as the recording is.
    Every seed's data bits are +1."""
    import torch

    from gnssbench.reference.models import get_signal

    n = int(fs * seconds)
    frame = int(fs * CHUNK_MS / 1000)
    sigma = float(np.sqrt(fs / (2.0 * 10 ** (CN0_REF / 10.0))))
    scale = 100.0 / (4.0 * sigma)
    out = np.empty(2 * n, np.int8)
    for k, t0 in enumerate(range(0, n, frame)):
        m = min(frame, n - t0)
        x = torch.zeros(m, dtype=torch.complex64, device=device)
        for s in seeds:
            sig = get_signal(s["signal"])
            prn = int(s["prn"])
            chan = prn if sig.fdma_hz else 0
            amp = float(10.0 ** ((float(s["cn0"]) - CN0_REF) / 20.0))
            x += amp * synth_iq_t(
                sig.code_table((prn,))[0], sig.chip_rate, fs, m,
                float(s["doppler"]) + sig.fdma_hz * chan + float(s["coffset"]),
                float(s["code_phase"]), sig.subcarrier,
                sig.track_carrier_ratio(chan),
                code_doppler_hz=float(s["doppler"]), device=device, t0=t0)
        g = torch.Generator(device=device).manual_seed(
            noise_seed(seed, band, k))
        x += sigma * torch.complex(
            torch.randn(m, generator=g, device=device),
            torch.randn(m, generator=g, device=device))
        iq = torch.view_as_real(x * scale).round().clamp(-127, 127)
        out[2 * t0:2 * (t0 + m)] = iq.to(torch.int8).reshape(-1).cpu().numpy()
    return out
