"""The plain reference of a non-coherent acquisition search, in float64.

The semantics of the acquire scripts (acquire-gps-l1.py:85-102): mix the
capture to baseband with the carrier offset's oscillator, low-pass it
with a 161-tap Hann FIR run forwards and backwards, resample it linearly
to the signal's internal rate, then for every code row and doppler the
magnitude of the circular FFT correlation of each coherent block with
the row's code, summed over the blocks; the metric is the peak, or the
peak over the mean of the lags, and each row's result is the first
maximum.  The oscillators are the scripts' table oscillators: a 32-bit
phase accumulator whose top 10 bits index a table of 1024 angles
(gnsstools nco.py), so the reference holds the same quantised phases as
any implementation of the scripts.

Everything is worked out here from the signal catalog (the benchmark's
frozen copy), the capture's bytes and the search's arguments: the code
tables, the filter, the oscillator phases and the code spectra.  The
program under test is not imported.

`precision="tf32"` is the control: the same search in float32 with every
operand of the filter and of the spectra's product rounded to TF32's 10
mantissa bits, as a matrix unit running TF32 would take them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NT = 1024                  # oscillator table size
LUT_SHIFT = 22             # 32-bit phase -> top 10 bits
MASK32 = 0xFFFFFFFF


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32's 10 mantissa bits
    (to nearest, ties away from zero)."""
    if v.is_complex():
        return torch.complex(tf32(v.real.contiguous()),
                             tf32(v.imag.contiguous()))
    b = v.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _dtypes(precision):
    if precision == "float64":
        return torch.float64, torch.complex128, lambda v: v
    if precision == "tf32":
        return torch.float32, torch.complex64, tf32
    raise ValueError(precision)


def from_int8(raw: np.ndarray, device, cdtype) -> torch.Tensor:
    """Interleaved int8 I/Q -> complex samples."""
    v = torch.from_numpy(np.asarray(raw, np.int8).reshape(-1, 2).copy())
    v = v.to(device)
    rdt = torch.float64 if cdtype == torch.complex128 else torch.float32
    return torch.complex(v[:, 0].to(rdt), v[:, 1].to(rdt))


def fixed_increment(f: float) -> int:
    """A frequency in cycles a sample as the 32-bit phase increment,
    floor((f mod 1) 2^32)."""
    return int(math.floor(float(np.float64(f) % 1.0) * 2.0 ** 32)) & MASK32


def oscillator(incr: int, n: int, device, cdtype) -> torch.Tensor:
    """exp(2 pi i idx / 1024) of the table oscillator with phase k * incr
    (k < n, from phase 0)."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    idx = ((k * int(incr)) & MASK32) >> LUT_SHIFT
    ang = idx.to(torch.float64) * (2.0 * math.pi / NT)
    return torch.polar(torch.ones_like(ang), ang).to(cdtype)


def lowpass(fs: float, cutoff_hz: float, ntaps: int = 161) -> np.ndarray:
    """scipy.signal.firwin(ntaps, cutoff / (fs / 2), window="hann")."""
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    fc = cutoff_hz / (fs / 2.0)
    h = fc * np.sinc(fc * m) * np.hanning(ntaps)
    return h / np.sum(h)


def _fir(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR with zero initial state along the last axis of [2, n]."""
    nt = h.shape[0]
    xp = torch.nn.functional.pad(v[:, None, :], (nt - 1, 0))
    return torch.nn.functional.conv1d(xp, torch.flip(h, [0]).view(1, 1, nt))[:, 0]


def filtfilt(h: np.ndarray, x: torch.Tensor, rnd) -> torch.Tensor:
    """The FIR forwards then backwards over x extended at each end by
    3 ntaps samples of odd reflection."""
    pad = 3 * len(h)
    rdt = x.real.dtype
    v = torch.stack([x.real, x.imag])
    left = 2 * v[:, :1] - torch.flip(v[:, 1:pad + 1], [1])
    right = 2 * v[:, -1:] - torch.flip(v[:, -pad - 1:-1], [1])
    ht = rnd(torch.from_numpy(h).to(x.device, rdt))
    y = _fir(rnd(torch.cat([left, v, right], 1)), ht)
    y = torch.flip(_fir(rnd(torch.flip(y, [1])), ht), [1])[:, pad:pad + x.shape[0]]
    return torch.complex(y[0], y[1])


def resample(x: torch.Tensor, fs: float, fs_out: float, n_out: int):
    """np.interp of x on the grid t_k = k fs / fs_out."""
    t = np.arange(n_out, dtype=np.float64) * (np.float64(fs) / np.float64(fs_out))
    n = x.shape[0]
    i0 = np.minimum(np.floor(t).astype(np.int64), n - 1)
    w = torch.from_numpy(t - i0).to(x.device, x.real.dtype)
    i0t = torch.from_numpy(i0).to(x.device)
    i1t = torch.clamp(i0t + 1, max=n - 1)
    return x[i0t] * (1 - w) + x[i1t] * w


def code_spectra(sig, prns, n: int, window: int, device, cdtype):
    """Each row's code sampled at n points of one coherent period (chip
    floor(i L / n)), times the BOC(1,1) square wave where the search's
    template takes it, zeros up to the window, FFT."""
    L = sig.code_length
    incr = float(L) / n
    i = np.arange(n, dtype=np.float64)
    idx = np.floor(incr * i).astype(np.int64) % L
    c = sig.code_table(tuple(prns))[:, idx].astype(np.float64)
    if sig.acq_boc_ref:
        c = c * np.where(np.floor(incr * i * 2).astype(np.int64) % 2 == 0,
                         -1.0, 1.0)
    c = np.concatenate([c, np.zeros((c.shape[0], window - n))], axis=1)
    return torch.fft.fft(torch.from_numpy(c).to(device, cdtype), dim=1)


def block_count(sig, ms: int) -> int:
    """Coherent blocks of an ms-long search (the scripts' loop bounds)."""
    if sig.acq_blocks_override:
        return sig.acq_blocks_override
    coh = sig.acq_coherent_ms
    if sig.acq_sliding or (coh > 1 and sig.acq_pad2):
        return max(int(ms // coh) - 1, 1)
    if coh > 1:
        return max(int(ms // coh), 1)
    return int(ms)


def search_cells(sig, rows: int, dopplers: int, ms: int) -> int:
    """The cells of one search: code rows x dopplers x the code-phase
    hypotheses of one coherent period x blocks."""
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    return int(rows) * int(dopplers) * n * block_count(sig, ms)


def doppler_grid(doppler_search):
    dmin, dmax, dinc = doppler_search
    return np.arange(dmin, dmax, dinc)


def surface(sig, raw: np.ndarray, fs: float, coffset: float, prns, dops,
            ms: int, device, precision: str = "float64") -> torch.Tensor:
    """q [P, D, n]: the block-summed correlation magnitude of every code
    row, doppler and code phase (circular search at one code period)."""
    rdt, cdt, rnd = _dtypes(precision)
    if sig.acq_pad2 or sig.acq_sliding:
        raise NotImplementedError(f"{sig.name}: the reference searches "
                                  f"one-period circular windows only")
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    x = from_int8(raw, device, cdt)
    x = x * oscillator(fixed_increment(-coffset / fs), x.shape[0], device, cdt)
    x = filtfilt(lowpass(fs, sig.acq_lowpass_hz), x, rnd)
    x = resample(x, fs, sig.acq_fs, int(round((ms + 2) * sig.acq_fs / 1000.0)))
    B = block_count(sig, ms)
    xb = x[:B * n].reshape(B, n)
    C = rnd(code_spectra(sig, prns, n, n, device, cdt))
    q = torch.empty((len(prns), len(dops), n), dtype=rdt, device=device)
    for d, dop in enumerate(dops):
        w = oscillator(fixed_increment(-dop / sig.acq_fs), n, device, cdt)
        F = rnd(torch.fft.fft(xb * w, dim=-1))                  # [B, n]
        for p0 in range(0, len(prns), 8):
            prod = C[p0:p0 + 8, None, :] * torch.conj(F)[None]
            q[p0:p0 + 8, d] = torch.fft.ifft(prod, dim=-1).abs().sum(1)
    return q


def metric_of(sig, q: torch.Tensor):
    """(metric [P, D, n]) the scripts' metric at every cell: the value,
    or the value over its (row, doppler)'s mean over the lags."""
    if sig.acq_metric == "peak_mean":
        return q / q.mean(dim=-1, keepdim=True)
    return q


def results_of(sig, q: torch.Tensor, prns, dops):
    """[(prn, doppler, metric, code_offset)] as the scripts report them:
    for each row the first maximum over (doppler, lag) of the metric."""
    n = q.shape[-1]
    m = metric_of(sig, q)
    P, D, _ = m.shape
    flat = m.reshape(P, -1)
    best = torch.argmax(flat, dim=1).cpu().numpy()
    vals = flat.max(dim=1).values.cpu().numpy()
    out = []
    for i, prn in enumerate(prns):
        d, k = divmod(int(best[i]), n)
        out.append((int(prn), float(dops[d]), float(vals[i]),
                    (sig.code_length * float(k) / n) % sig.code_length))
    return out


def judge(sig, q64: torch.Tensor, prns, dops, tie: float):
    """A judge of one search's results against its float64 surface q64:
    a function of the results returning (metric_err, cells_wrong,
    rows_missing).  metric_err: the widest relative gap between a
    reported metric and the metric at its reported cell; cells_wrong: the
    rows whose reported cell is off the grid, or whose metric lies below
    its row's best by more than `tie` (relative: a cell within it ties
    with the best at the precision the metric is held to); rows_missing:
    the rows with no result, or more than one."""
    n = q64.shape[-1]
    m = metric_of(sig, q64)
    best = m.reshape(m.shape[0], -1).max(dim=1).values.cpu().numpy()
    m = m.cpu().numpy()

    def of(results):
        by_prn = {}
        for r in results:
            by_prn.setdefault(int(r[0]), []).append(r)
        err = 0.0
        wrong = missing = 0
        for i, prn in enumerate(prns):
            rs = by_prn.get(int(prn), [])
            if len(rs) != 1:
                missing += 1
                continue
            _p, dop, metric, code = rs[0]
            d = int(np.argmin(np.abs(dops - dop)))
            k = int(round(code * n / sig.code_length)) % n
            if abs(dops[d] - dop) > 1e-6 or abs(
                    (sig.code_length * k / n) % sig.code_length - code) > 1e-6:
                wrong += 1
                continue
            at = float(m[i, d, k])
            wrong += int((float(best[i]) - at) > tie * float(best[i]))
            err = max(err, abs(float(metric) - at) / at)
        return err, wrong, missing
    return of
