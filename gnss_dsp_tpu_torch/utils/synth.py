"""Synthetic GNSS IQ generation (host, float64) for tests and benchmarks.

Generates baseband IQ with a known PRN code, code phase, doppler, C/N0 —
the truth values become assertions for acquisition peaks and tracking
convergence (the reference has no synthetic tier; SURVEY.md §4 implication 3).
"""

from __future__ import annotations

import numpy as np


def synth_iq(code_pm1: np.ndarray, chip_rate: float, fs: float, n: int,
             doppler_hz: float = 0.0, code_phase: float = 0.0,
             carrier_phase: float = 0.0, cn0_dbhz: float | None = 45.0,
             amplitude: float = 1.0, rng=None,
             subcarrier: str = "none",
             carrier_ratio: float | None = None,
             code_doppler_hz: float | None = None,
             data_bits: np.ndarray | None = None,
             t0: int = 0) -> np.ndarray:
    """Complex64 [n] baseband samples of one spread-spectrum signal.

    code_phase in chips at absolute sample 0.  When carrier_ratio is
    given (the f_carrier/chip_rate divisor, e.g. 1540 for GPS L1), the
    code rate is doppler-scaled coherently: chip_rate + doppler/ratio —
    matching the physics the reference's doppler-aided code NCO assumes
    (track-gps-l1.py:44).  cn0_dbhz None => noiseless.

    t0: absolute index of the first generated sample.  All phase ramps
    are affine in the absolute sample index, so generating [0, n) in one
    call or as chunked calls with increasing t0 (and, for noise, one
    shared rng drawn sequentially) is EXACTLY equivalent — the chunked
    long-capture synthesis (tools/synth_sky.py) relies on this.
    """
    L = len(code_pm1)
    t = np.arange(t0, t0 + n, dtype=np.float64)
    # code_doppler_hz: the physical doppler driving the code rate; defaults
    # to the carrier doppler, but differs under FDMA where the carrier
    # frequency also carries a channel IF offset that is NOT doppler
    cd = doppler_hz if code_doppler_hz is None else code_doppler_hz
    eff_chip_rate = chip_rate + (cd / carrier_ratio if carrier_ratio else 0.0)
    # phase bookkeeping stays float64 (a 70 MHz carrier over minutes is
    # ~1e9 cycles — f32 would lose the fractional cycle); everything
    # after the gathers / mod-1 wraps runs float32 for speed (the long
    # sky-capture synthesis is host-CPU-bound here)
    cp = code_phase + t * (eff_chip_rate / fs)
    chips = code_pm1[np.floor(cp).astype(np.int64) % L].astype(np.float32)
    if subcarrier != "none":
        bp = np.floor(2 * cp).astype(np.int64) % 2
        boc = (1 - 2 * bp).astype(np.float32)
        if subcarrier == "boc11":
            chips = chips * boc
        elif subcarrier == "cboc":
            bp6 = np.floor(12 * cp).astype(np.int64) % 2
            chips = chips * (np.float32(0.953463) * boc
                             + np.float32(0.301511)
                             * (1 - 2 * bp6).astype(np.float32))
        elif subcarrier == "tmboc":
            bp6 = np.floor(12 * cp).astype(np.int64) % 2
            boc6 = (1 - 2 * bp6).astype(np.float32)
            pat = np.zeros(33, np.float32)
            pat[[0, 4, 6, 29]] = 1.0
            slot = pat[np.floor(cp).astype(np.int64) % 33]
            chips = chips * (slot * boc6 + (1.0 - slot) * boc)
        elif subcarrier == "rz_even":
            chips = chips * (1 - bp).astype(np.float32)
        elif subcarrier == "rz_odd":
            chips = chips * bp.astype(np.float32)
        else:
            raise ValueError(subcarrier)
    if data_bits is not None:
        # ±1 navigation bit per code period, aligned to code-phase zero
        bits = np.asarray(data_bits, np.float32)
        chips = chips * bits[np.floor(cp / L).astype(np.int64) % len(bits)]
    # wrap the f64 carrier phase to [0, 1) cycles BEFORE dropping to f32
    # (2^-24 cycle resolution after the wrap) and run the trig in f32
    phiw = np.mod(carrier_phase + doppler_hz / fs * t, 1.0
                  ).astype(np.float32) * np.float32(2 * np.pi)
    if amplitude != 1.0:
        chips = chips * np.float32(amplitude)
    sig = np.empty(n, np.complex64)
    sig.real = chips * np.cos(phiw)
    sig.imag = chips * np.sin(phiw)
    if cn0_dbhz is not None:
        rng = rng or np.random.default_rng(0)
        # C/N0 = A^2 / (2 sigma^2 / fs)  =>  sigma = A*sqrt(fs/(2*10^(cn0/10)))
        sigma = amplitude * np.sqrt(fs / (2.0 * 10 ** (cn0_dbhz / 10.0)))
        sig = sig + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return sig.astype(np.complex64)


def to_int8_iq(x: np.ndarray, scale: float = 16.0) -> bytes:
    """Quantize complex samples to the reference's interleaved int8 I/Q
    stream format (io.py:3-12)."""
    out = np.empty(2 * len(x), dtype=np.int8)
    re = np.clip(np.round(np.real(x) * scale), -127, 127)
    im = np.clip(np.round(np.imag(x) * scale), -127, 127)
    out[0::2] = re.astype(np.int8)
    out[1::2] = im.astype(np.int8)
    return out.tobytes()
