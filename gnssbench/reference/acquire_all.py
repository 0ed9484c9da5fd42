"""The plain reference of the acquire-all.sh searches (the 21 acquisition
scripts of the 2017-04-27 recording), in float64.

It extends the one-period circular search of reference/acquire.py, whose
front end, oscillators, code sampling, block counts and doppler grids it
takes unchanged, to the two search kinds that file does not hold: the
2n-window searches (the pad2 and sliding templates) and the FDMA band
search.  The semantics are the acquire scripts' (SURVEY.md section 2.4;
acquire-gps-l1.py:26-39 the template, acquire-galileo-e1b.py:19-34 the
sliding windows); each choice the scripts leave open is written here.

Block windows.  A search of n samples a coherent period (n = acq_fs x
coherent ms) sums block_count(sig, ms) coherent blocks.  On a circular-n
search block b is x[b n : (b + 1) n]; on a 2n search (pad2 or sliding)
block b is x[b n : b n + 2n]: stride n, width 2n, so consecutive windows
overlap by n and there are block_count windows.

Code.  Each row's code sampled at n points of one period (chip
floor(i L / n)), times the BOC(1,1) square wave where the search's
template takes it (acq_boc_ref), zeros up to the window (2n on a 2n
search), FFT; the correlation is ifft(C conj(FFT(window))) at the
window's length, its magnitude summed over the blocks.  Every doppler
mixes each block window with the table oscillator from phase 0 (the
scripts' nco(-doppler / fs, 0, window)).

Lags (the configuration row's `lags`).  "circular-n": the n lags of the
circular search at n.  "circular-2n": all 2n circular lags at 2n; the
code sits in the first half of its window, so lags k and k + n both hold
a whole period of a periodic signal and differ only in which samples
they take (a data or secondary-code edge).  "linear-n": the n lags that
are exact linear correlations of the n-sample code with the 2n window,
lag j correlating the code with x[b n + n - j : b n + 2n - j]; at the 2n
circular length these are lags n + j (the zeros of the code's second
half take every other product).  A lag k names the code offset
L k / n mod L chips, so on circular-2n an offset names two lags, k and
k + n: the judge takes the one whose reference metric is nearer the
reported metric.  The metric is the peak, or the peak over the mean of
the reported lags (acq_metric "peak_mean").  Each row's result is the
first maximum over (doppler, lag), dopplers in grid order.

FDMA (GLONASS L1/L2).  Every channel searches the shared code row; the
channel's band offset fdma_hz x chan is in its oscillator, at
-(doppler + fdma_hz chan) / acq_fs cycles a sample, and not in the
reported doppler; each channel's result is the first maximum over its
own dopplers.

Cost.  A surface is computed one doppler at a time and reduced as it
goes (metrics), so that a judge holds a few [rows, lags] values and
never a whole [rows, dopplers, lags] surface: a 65536-window row at 360
dopplers, or GPS L2CM's 163840 at 700, stays within the card's memory.
TF32 is off while the reference computes (its FIR is a convolution,
which a card would otherwise run in TF32); `precision="tf32"` is the
control of reference/acquire.py: float32 with every operand of the
filter and of the spectra's product rounded to TF32's 10 mantissa bits.

It imports nothing of the program under test, nor JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gnssbench.reference import acquire as ra

LAGS = ("circular-n", "circular-2n", "linear-n")


@contextlib.contextmanager
def _tf32_off():
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def period(sig) -> int:
    """n: samples of one coherent period at the signal's internal rate."""
    return int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))


def baseband(sig, raw: np.ndarray, fs: float, coffset: float, ms: int,
             device, precision: str = "float64") -> torch.Tensor:
    """The front end of reference/acquire.py: ms + 2 ms of the capture at
    the signal's internal rate."""
    _rdt, cdt, rnd = ra._dtypes(precision)
    with _tf32_off():
        x = ra.from_int8(raw, device, cdt)
        x = x * ra.oscillator(ra.fixed_increment(-coffset / fs), x.shape[0],
                              device, cdt)
        x = ra.filtfilt(ra.lowpass(fs, sig.acq_lowpass_hz), x, rnd)
        return ra.resample(x, fs, sig.acq_fs,
                           int(round((ms + 2) * sig.acq_fs / 1000.0)))


def windows(x: torch.Tensor, n: int, blocks: int, lags: str):
    """The block windows [blocks, W]: stride n, W = n on circular-n, else
    2n."""
    if lags not in LAGS:
        raise ValueError(lags)
    if lags == "circular-n":
        return x[:blocks * n].reshape(blocks, n)
    return x[:(blocks + 1) * n].unfold(0, 2 * n, n)


def reported(q: torch.Tensor, n: int, lags: str) -> torch.Tensor:
    """The reported lags of a circular surface along its last axis."""
    return q[..., n:2 * n] if lags == "linear-n" else q


def code_offset(sig, k: int, n: int) -> float:
    """Chips of the code offset a reported lag k names."""
    return (sig.code_length * float(k) / n) % sig.code_length


def metrics(sig, raw: np.ndarray, fs: float, coffset: float, ids, dops,
            ms: int, lags: str, device, precision: str = "float64"):
    """Yield (d, m [len(ids), K]) for each doppler index d of the grid:
    the scripts' metric at each reported lag of each row (code row, or
    FDMA channel), K = 2n on circular-2n, else n."""
    rdt, cdt, rnd = ra._dtypes(precision)
    n = period(sig)
    x = baseband(sig, raw, fs, coffset, ms, device, precision)
    xb = windows(x, n, ra.block_count(sig, ms), lags)
    W = xb.shape[-1]
    fdma = bool(sig.fdma_hz)
    chans = [int(i) if fdma else 0 for i in ids]
    C = rnd(ra.code_spectra(sig, list(ids), n, W, device, cdt))
    rows_of = {}
    for r, c in enumerate(chans):
        rows_of.setdefault(c, []).append(r)
    peak_mean = sig.acq_metric == "peak_mean"
    for d, dop in enumerate(dops):
        m = torch.empty((len(ids), n if lags == "linear-n" else W),
                        dtype=rdt, device=device)
        for c, rows in rows_of.items():
            w = ra.oscillator(ra.fixed_increment(
                -(float(dop) + sig.fdma_hz * c) / sig.acq_fs), W, device, cdt)
            F = torch.conj(rnd(torch.fft.fft(xb * w, dim=-1)))     # [B, W]
            for r0 in range(0, len(rows), 8):
                rs = rows[r0:r0 + 8]
                q = torch.fft.ifft(C[rs, None, :] * F[None], dim=-1)
                q = reported(q.abs().sum(1), n, lags)
                m[rs] = q / q.mean(dim=-1, keepdim=True) if peak_mean else q
        yield d, m


def results(sig, raw, fs, coffset, ids, dops, ms, lags, device,
            precision: str = "float64"):
    """[(id, doppler, metric, code_offset)] as the scripts report them:
    each row's first maximum over (doppler, lag)."""
    n = period(sig)
    best = None
    for d, m in metrics(sig, raw, fs, coffset, ids, dops, ms, lags, device,
                        precision):
        v, k = m.max(dim=-1)                       # first max over lags
        if best is None:
            best = [v, k, torch.zeros_like(k)]
            continue
        take = v > best[0]                         # earlier doppler wins ties
        best = [torch.where(take, v, best[0]), torch.where(take, k, best[1]),
                torch.where(take, torch.full_like(k, d), best[2])]
    v, k, d = (t.cpu().numpy() for t in best)
    return [(int(i), float(dops[d[r]]), float(v[r]),
             code_offset(sig, int(k[r]), n)) for r, i in enumerate(ids)]


def judge(sig, raw, fs, coffset, judged, dops, ms, lags, device, tie: float,
          searched, got):
    """(metric_err, cells_wrong, rows_missing) of one search's results
    `got` [(id, doppler, metric, code_offset)] against the float64
    surface of the rows `judged`.  rows_missing: the rows of `searched`
    with no result or more than one, and results of rows not searched;
    cells_wrong: judged rows whose reported cell is off the grid, or
    whose metric lies below the row's best by more than `tie` (relative:
    a cell within it ties with the best at the precision the metric is
    held to); metric_err: the widest relative gap between a judged row's
    reported metric and the reference metric at its reported cell."""
    by_id = {}
    for r in got:
        by_id.setdefault(int(r[0]), []).append(r)
    searched = {int(i) for i in searched}
    missing = sum(len(by_id.get(i, [])) != 1 for i in searched)
    missing += sum(len(v) for i, v in by_id.items() if i not in searched)
    n = period(sig)
    L = sig.code_length
    want = {}                 # row -> (doppler index, candidate lags)
    wrong = 0
    for r, i in enumerate(judged):
        rs = by_id.get(int(i), [])
        if len(rs) != 1:
            continue
        _i, dop, _metric, code = rs[0]
        d = int(np.argmin(np.abs(np.asarray(dops) - dop)))
        k = int(round(code * n / L)) % n
        if abs(dops[d] - dop) > 1e-6 or abs(code_offset(sig, k, n)
                                            - code) > 1e-6:
            wrong += 1
            continue
        want[r] = (d, [k, k + n] if lags == "circular-2n" else [k])
    best = np.full(len(judged), -np.inf)
    at = {}
    for d, m in metrics(sig, raw, fs, coffset, judged, dops, ms, lags,
                        device):
        best = np.maximum(best, m.max(dim=-1).values.cpu().numpy())
        for r, (dr, ks) in want.items():
            if dr == d:
                at[r] = m[r, ks].cpu().numpy()
    err = 0.0
    for r, vals in at.items():
        metric = float(by_id[int(judged[r])][0][2])
        v = float(vals[np.argmin(np.abs(vals - metric))])
        wrong += int(best[r] - v > tie * best[r])
        err = max(err, abs(metric - v) / v)
    return err, wrong, missing
