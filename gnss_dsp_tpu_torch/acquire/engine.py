"""Batched FFT circular-correlation acquisition.

Counterpart: gnss_dsp_tpu/acquire/engine.py (`AcqResult`,
`build_code_ffts` :42-54, `block_windows` :57-77, `grid_search` :176-266
on its v2 branch, `_block_count` :269-279, `doppler_grid` :282-290,
`acquire_signal` :367-445).

Per doppler chunk: mix the [B, W] block windows with each doppler's
oscillator, forward FFT (torch.fft, outside the kernel as in the JAX
package), then the correlation surface and its per-(PRN, doppler)
reduction in kernel K1 (ops/acquire2).  Across chunks a strict `>`
keeps the earliest best doppler, and inside a chunk argmax takes the
first maximum, so the winning cell does not depend on the chunking.

Not ported here: the v1/v2p kernel plans, FDMA (acquire_signal_fdma)
and per-chunk results.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnss_dsp_tpu.models.codes import resample_host
from gnss_dsp_tpu_torch.ops import acquire2, nco


@dataclass
class AcqResult:
    prn: int
    doppler: float
    metric: float
    code_offset: float   # chips


def build_code_ffts(sig, prns, n: int, window: int) -> np.ndarray:
    """Host reference waveforms: each PRN's code resampled to n samples
    (one coherent period), times the BOC(1,1) subcarrier where the
    template demands it, zero-padded to `window`, FFT.  float64 host
    math, complex128 out."""
    table = sig.code_table(tuple(prns))
    incr = float(sig.code_length) / n
    c = resample_host(table, 0, 0, incr, n)  # [P, n] f64 +-1
    if sig.acq_boc_ref:
        c = c * nco.boc11_host(0, 0, incr, n)
    if window > n:
        c = np.concatenate([c, np.zeros((c.shape[0], window - n))], axis=1)
    return np.fft.fft(c, axis=1)


def block_windows(x: torch.Tensor, n: int, window: int, blocks: int):
    """The non-coherent block windows [B, W] (stride n; W = n for the
    circular search, 2n for the sliding zero-padded templates)."""
    m = window // n
    rows = blocks + m - 1
    xs = x[: rows * n].reshape(rows, n)
    if m == 1:
        return xs
    return torch.cat([xs[i:i + blocks] for i in range(m)], dim=-1)


def _block_count(sig, ms: int) -> int:
    if sig.acq_blocks_override:   # b2ad quirk: range(80)
        return sig.acq_blocks_override
    coh = sig.acq_coherent_ms
    if sig.acq_sliding:           # galileo e1: ms//4 - 1
        return max(int(ms // coh) - 1, 1)
    if coh > 1 and sig.acq_pad2:  # l2cm: ms//20 - 1
        return max(int(ms // coh) - 1, 1)
    if coh > 1:                   # l1c/b1c: ms//10
        return max(int(ms // coh), 1)
    return int(ms)


def doppler_grid(sig, doppler_search):
    dmin, dmax, dinc = doppler_search
    dops = np.arange(dmin, dmax, dinc)
    fixed = np.array(
        [nco.freq_to_fixed(-d / sig.acq_fs) for d in dops],
        dtype=np.int64,
    ).astype(np.int32)
    return dops, fixed


def grid_search(x: torch.Tensor, code_ffts: torch.Tensor,
                dopp_fixed: torch.Tensor, n: int, window: int, blocks: int,
                peak_mean: bool, dop_chunk: int | None = None):
    """Search the full grid; returns per-PRN (metric f32 [P], code_idx
    i32 [P], dop_idx i64 [P]) tensors.

    x          : complex64 [>= (blocks-1)*n + window] internal-rate samples
    code_ffts  : complex64 [P, window] natural-order code spectra
    dopp_fixed : int [D] per-sample NCO increments
    dop_chunk  : dopplers per kernel call (default: as many as keep the
                 [dc, B, W] spectra under ~1 GB)"""
    P = code_ffts.shape[0]
    D = int(dopp_fixed.shape[0])
    dev = x.device
    xb = block_windows(x, n, window, blocks)                  # [B, W]
    if dop_chunk is None:
        dop_chunk = int(np.clip((1 << 30) // (blocks * window * 8), 1, D))
    best_metric = torch.full((P,), -float("inf"), dtype=torch.float32,
                             device=dev)
    best_code = torch.zeros((P,), dtype=torch.int32, device=dev)
    best_dop = torch.zeros((P,), dtype=torch.int64, device=dev)
    cells = torch.full((1, 1), float(window), dtype=torch.float32, device=dev)
    for d0 in range(0, D, dop_chunk):
        df = dopp_fixed[d0:d0 + dop_chunk].to(dev, torch.int64)
        w = nco.nco_wave(df, torch.zeros_like(df), window)    # [dc, W]
        xr, xi = xb.real[None], xb.imag[None]
        wr, wi = w.real[:, None], w.imag[:, None]
        xw = torch.complex(xr * wr - xi * wi, xr * wi + xi * wr)  # [dc, B, W]
        F = torch.fft.fft(xw, dim=-1)
        peak, code_idx, sm = acquire2.corr_surface2(F, code_ffts)  # [P, dc]
        metric = peak / (sm / cells) if peak_mean else peak
        ch_best = torch.argmax(metric, dim=-1)                # first max
        ch_metric = torch.gather(metric, 1, ch_best[:, None])[:, 0]
        ch_code = torch.gather(code_idx, 1, ch_best[:, None])[:, 0]
        upd = ch_metric > best_metric
        best_metric = torch.where(upd, ch_metric, best_metric)
        best_code = torch.where(upd, ch_code, best_code)
        best_dop = torch.where(upd, ch_best + d0, best_dop)
    return best_metric, best_code, best_dop


# device-resident code-FFT LRU: repeated acquire calls on the same
# (signal, prns, window, device) skip the host FFT build and the upload
_CODE_FFTS_DEV: dict = {}
_CODE_FFTS_CAP = 4


def acquire_signal(sig, x_int: torch.Tensor, prns, doppler_search=None,
                   ms: int = 80) -> list:
    """Run acquisition for one signal over `prns`.

    x_int: complex64 internal-rate samples covering >= ms+2 ms, on the
    device the search runs on.  Returns list[AcqResult] in PRN order."""
    if sig.fdma_hz or sig.acq_serial:
        raise NotImplementedError(
            f"{sig.name}: FDMA and serial searches are not ported yet")
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = _block_count(sig, ms)
    dops, fixed = doppler_grid(sig, doppler_search)
    dev = x_int.device

    key = (sig.name, tuple(prns), n, window, dev)
    code_ffts = _CODE_FFTS_DEV.pop(key, None)
    if code_ffts is None:
        cf_host = build_code_ffts(sig, prns, n, window).astype(np.complex64)
        code_ffts = torch.from_numpy(cf_host).to(dev)
    _CODE_FFTS_DEV[key] = code_ffts            # re-insert = most recent
    while len(_CODE_FFTS_DEV) > _CODE_FFTS_CAP:
        _CODE_FFTS_DEV.pop(next(iter(_CODE_FFTS_DEV)))

    metric, code_idx, dop_idx = grid_search(
        x_int, code_ffts, torch.from_numpy(fixed.astype(np.int64)),
        n=n, window=window, blocks=blocks,
        peak_mean=(sig.acq_metric == "peak_mean"))
    metric = metric.cpu().numpy()
    code_idx = code_idx.cpu().numpy()
    dop_idx = dop_idx.cpu().numpy()
    out = []
    for i, prn in enumerate(prns):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(AcqResult(
            prn=prn, doppler=float(dops[dop_idx[i]]),
            metric=float(metric[i]), code_offset=code,
        ))
    return out
