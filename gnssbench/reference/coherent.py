"""The plain reference of the extended-coherent acquisition search
(acquire --coherent M) on the 2n-window signals, in float64.

The search (README.md's high-sensitivity mode, `--coherent 20` on BeiDou
B1I): M consecutive code periods are summed coherently with the
secondary overlay wiped off, trying every cyclic alignment a of its N
chips, and G = blocks / M such sums are added in magnitude:

    q[p, d, j] = max_a  sum_g | sum_m  s[(a + b) mod N] rot(d, b)
                                        R[p, d, b][j] |,   b = g M + m

Blocks.  blocks = floor(ms / coherent ms), rounded down to whole groups of
M (at least one group).  Block b is the 2n window x[b n : b n + 2n] of the
front end's output (the pad2 and sliding signals' windows; n samples a
code period), as gnssbench/reference/acquire_all.py's "circular-2n".

Correlations.  R[p, d, b] is the complex circular correlation at 2n of
block b, mixed with the doppler's table oscillator from phase 0, with
the row's code sampled at n points and zeros to 2n:
ifft(C_p conj(FFT(window_b osc_d))), all 2n lags.  A lag k names the
code offset L k / n mod L chips, so an offset names two lags, k and
k + n (the judge takes the one whose metric is nearer the reported one).

Rotation.  Every block's oscillator restarts at phase 0, so the carrier
left in block b is turned back by rot(d, b) = exp(-2 pi i frac(u b /
2^32)), u = (incr n) mod 2^32 with incr the oscillator's 32-bit
increment (the uint32 wrap of the scripts' phase accumulator); the phase
is reduced in integers, so it is exact.

Overlay.  s is the row's secondary code (the frozen catalog's, +-1; a
signal without one has N = 1 and s = 1), indexed at the GLOBAL block b.
The metric is the raw coherent peak (no mean over the lags).  Each row's
result is the first maximum over (doppler, lag, alignment), dopplers in
grid order: for each doppler the best alignment of each lag (the lowest
on ties), then the first best lag, then a doppler only when strictly
better than the earlier ones.

Departures from the program, none of which changes a value the
definition gives: the program combines the overlay in spectral space
before one inverse transform a (group, alignment) (the IDFT is linear),
here the per-block correlations are combined in the lag domain; the
program rotates in float32 from a float32 angle, here the rotation's
phase is exact and the sums are float64; the program chunks its dopplers
by memory, here they run one at a time and the rows in blocks of ROWS.

The front end, the oscillators, the code sampling and the doppler grid
are reference/acquire.py's (through reference/acquire_all.baseband).
Only the 2n-window route that searches all 2n lags (W = 2n, no padded
lags) is held here; other routes raise NotImplementedError.

TF32 is off while the reference computes.  `precision="tf32"` is the
control: float32, with every operand of the front end's filter, of the
spectra's product and of the overlay combine rounded to TF32's 10
mantissa bits, as a matrix unit running TF32 would take them.

It imports nothing of the program under test, nor JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnssbench.reference import acquire as ra
from gnssbench.reference import acquire_all as rall

ROWS = 16                 # code rows a block of the correlations


def geometry(sig, ms: int, m_coh: int | None = None):
    """(n, blocks, M, N): samples a code period, blocks searched, periods
    a coherent group, overlay chips."""
    if not (sig.acq_pad2 or sig.acq_sliding):
        raise NotImplementedError(f"{sig.name}: the coherent reference "
                                  f"holds the 2n-window searches only")
    n = rall.period(sig)
    N = len(overlay(sig, sig.prns()[0]))
    M = N if m_coh is None else int(m_coh)
    blocks = max(int(ms / sig.acq_coherent_ms) // M, 1) * M
    return n, blocks, M, N


def overlay(sig, prn: int) -> np.ndarray:
    """The row's secondary code as float64 +-1 chips (ones(1) without)."""
    if sig.secondary is None:
        return np.ones(1)
    return np.asarray(sig.secondary(int(prn)), np.float64)


def weights(sig, prn: int, dop: float, n: int, blocks: int, cdt):
    """w [N, blocks] = s[(a + b) mod N] rot(d, b): the overlay sign and
    the residual rotation of every alignment a and block b."""
    s = overlay(sig, prn)
    N = len(s)
    u = (ra.fixed_increment(-float(dop) / sig.acq_fs) * n) & ra.MASK32
    b = np.arange(blocks, dtype=np.int64)
    frac = ((u * b) & ra.MASK32) / 2.0 ** 32
    rot = np.exp(-2j * math.pi * frac)
    sign = s[(np.arange(N)[:, None] + b[None, :]) % N]
    return torch.from_numpy(sign * rot[None, :]).to(cdt)


def surface(sig, raw: np.ndarray, fs: float, coffset: float, ids, dops,
            ms: int, device, precision: str = "float64",
            m_coh: int | None = None):
    """Yield (d, q [len(ids), N, 2n]) for each doppler index d of the
    grid: the coherent surface of each row at every alignment and lag,
    before the maximum over the alignments."""
    rdt, cdt, rnd = ra._dtypes(precision)
    n, B, M, N = geometry(sig, ms, m_coh)
    G = B // M
    x = rall.baseband(sig, raw, fs, coffset, ms, device, precision)
    with rall._tf32_off():
        xb = rall.windows(x, n, B, "circular-2n")              # [B, 2n]
        W = xb.shape[-1]
        C = rnd(ra.code_spectra(sig, list(ids), n, W, device, cdt))
        for d, dop in enumerate(dops):
            osc = ra.oscillator(ra.fixed_increment(-float(dop) / sig.acq_fs),
                                W, device, cdt)
            F = torch.conj(rnd(torch.fft.fft(xb * osc, dim=-1)))  # [B, W]
            q = torch.empty((len(ids), N, W), dtype=rdt, device=device)
            for r0 in range(0, len(ids), ROWS):
                rows = list(ids[r0:r0 + ROWS])
                R = rnd(torch.fft.ifft(C[r0:r0 + len(rows), None, :]
                                       * F[None], dim=-1))     # [r, B, W]
                w = rnd(torch.stack([weights(sig, p, dop, n, B, cdt)
                                     for p in rows]).to(device))  # [r, N, B]
                S = torch.einsum("ragm,rgmw->rgaw",
                                 w.reshape(len(rows), N, G, M),
                                 R.reshape(len(rows), G, M, W))
                q[r0:r0 + len(rows)] = S.abs().sum(dim=1)
                del R, S
            yield d, q


def results_of(sig, surf, ids, dops):
    """[(id, doppler, metric, code_offset, align)] of a surface (the
    pairs `surface` yields, in grid order), as the program reports them:
    each row's first maximum over (doppler, lag, alignment)."""
    best = None
    n = None
    for d, q in surf:
        n = q.shape[-1] // 2
        v_a, a = q.max(dim=1)                     # best alignment a lag
        v, k = v_a.max(dim=-1)                    # first best lag
        al = torch.gather(a, 1, k[:, None])[:, 0]
        cur = [v, k, al, torch.full_like(k, d)]
        if best is None:
            best = cur
            continue
        take = v > best[0]                        # earlier doppler wins ties
        best = [torch.where(take, c, b) for c, b in zip(cur, best)]
    v, k, al, d = (t.cpu().numpy() for t in best)
    return [(int(i), float(dops[d[r]]), float(v[r]),
             rall.code_offset(sig, int(k[r]), n), int(al[r]))
            for r, i in enumerate(ids)]


def results(sig, raw, fs, coffset, ids, dops, ms, device,
            precision: str = "float64", m_coh: int | None = None):
    """results_of the surface of these rows."""
    return results_of(sig, surface(sig, raw, fs, coffset, ids, dops, ms,
                                   device, precision, m_coh), ids, dops)


def judge(sig, surf, judged, dops, tie: float, searched, got):
    """(metric_err, cells_wrong, rows_missing) of one search's results
    `got` [(id, doppler, metric, code_offset, align)] against the float64
    surface `surf` of the rows `judged` (the pairs `surface` yields).
    rows_missing: the rows of `searched` with no result or more than
    one, and results of rows not searched; cells_wrong: judged rows whose
    reported cell (code offset, doppler, alignment) is off the grid, or
    whose reference metric lies below the row's best by more than `tie`
    (relative); metric_err: the widest relative gap between a judged
    row's reported metric and the reference metric at its reported
    cell."""
    by_id = {}
    for r in got:
        by_id.setdefault(int(r[0]), []).append(r)
    searched = {int(i) for i in searched}
    missing = sum(len(by_id.get(i, [])) != 1 for i in searched)
    missing += sum(len(v) for i, v in by_id.items() if i not in searched)
    n = rall.period(sig)
    L = sig.code_length
    want = {}                 # row -> (doppler index, code lag, alignment)
    wrong = 0
    for r, i in enumerate(judged):
        rs = by_id.get(int(i), [])
        if len(rs) != 1:
            continue
        _i, dop, _metric, code, a = rs[0]
        d = int(np.argmin(np.abs(np.asarray(dops) - dop)))
        k = int(round(code * n / L)) % n
        if abs(dops[d] - dop) > 1e-6 or abs(rall.code_offset(sig, k, n)
                                            - code) > 1e-6 \
                or not 0 <= int(a) < len(overlay(sig, i)):
            wrong += 1
            continue
        want[r] = (d, k, int(a))
    best = np.full(len(judged), -np.inf)
    at = {}
    for d, q in surf:
        best = np.maximum(best, q.reshape(len(judged), -1).max(
            dim=-1).values.cpu().numpy())
        for r, (dr, k, a) in want.items():
            if dr == d:
                at[r] = q[r, a, [k, k + n]].cpu().numpy()
    err = 0.0
    for r, vals in at.items():
        metric = float(by_id[int(judged[r])][0][2])
        v = float(vals[np.argmin(np.abs(vals - metric))])
        wrong += int(best[r] - v > tie * best[r])
        err = max(err, abs(metric - v) / v)
    return err, wrong, missing
