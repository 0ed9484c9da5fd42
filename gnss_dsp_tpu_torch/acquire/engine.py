"""Batched FFT circular-correlation acquisition.

Counterpart: gnss_dsp_tpu/acquire/engine.py (`AcqResult`,
`build_code_ffts` :42-54, `block_windows` :57-77, `grid_search` :176-266
on its v2, v2p and v1 branches, `_block_count` :269-279, `doppler_grid`
:282-290, `acquire_signal` :367-445).

The route (acquire/plan.acq_plan, the reference's _fused_plan) sets the
search, on every device:

  v2   circular search at the window (n, or 2n for the pad2 and sliding
       templates): kernel K1 (ops/acquire2) with its in-kernel
       (max, argmax, sum)
  v2p  the pad2 windows without an aligned split (30690, 61380): the 2n
       block windows zero-padded to the route's FFT length, and K1's
       reduction masked to the n exact linear lags (n_valid = n)
  v1   circular search at a window with no aligned split (Xona X5,
       30690): the full surface from kernel K7 (ops/acquire), then max,
       first argmax and mean over the lags in torch

Per doppler chunk: mix the block windows with each doppler's
oscillator, forward FFT (torch.fft, outside the kernels as in the JAX
package), then the surface kernel.  Across chunks a strict `>` keeps
the earliest best doppler, and inside a chunk argmax takes the first
maximum, so the winning cell does not depend on the chunking.

Not ported here: FDMA (acquire_signal_fdma), serial searches and
per-chunk results.  The extended-coherent search is in coherent.py and
shares block_windows, mix_fft and the code-spectra LRU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnss_dsp_tpu_torch.acquire.plan import acq_plan
from gnss_dsp_tpu_torch.device import refuse_switches
from gnss_dsp_tpu_torch.models.codes import resample_host
from gnss_dsp_tpu_torch.ops import acquire, acquire2, nco


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


def block_windows(x: torch.Tensor, n: int, window: int, blocks: int,
                  pad_to: int = 0):
    """The non-coherent block windows [B, W] (stride n; W = n for the
    circular search, 2n for the sliding zero-padded templates), followed
    by zeros up to `pad_to` columns when that is larger (the padded-lag
    route of the coherent search)."""
    m = window // n
    rows = blocks + m - 1
    xs = x[: rows * n].reshape(rows, n)
    xb = xs if m == 1 else torch.cat([xs[i:i + blocks] for i in range(m)],
                                     dim=-1)
    if pad_to > window:
        xb = torch.nn.functional.pad(xb, (0, pad_to - window))
    return xb


def mix_fft(xb: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Doppler-mix the [B, W] block windows with each increment of df
    (int64 [dc]) and forward-FFT them: complex64 [dc, B, W] spectra."""
    w = nco.nco_wave(df, torch.zeros_like(df), xb.shape[-1])   # [dc, W]
    xr, xi = xb.real[None], xb.imag[None]
    wr, wi = w.real[:, None], w.imag[:, None]
    xw = torch.complex(xr * wr - xi * wi, xr * wi + xi * wr)  # [dc, B, W]
    return torch.fft.fft(xw, dim=-1)


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


def dop_chunk_for(route: str, P: int, blocks: int, window: int,
                  D: int) -> int:
    """Dopplers per kernel call: as many as keep the [dc, B, W] spectra,
    and on v1 also K7's [P, dc, W] surface, under ~1 GB."""
    per_dc = blocks * window * 8 + (P * window * 4 if route == "v1" else 0)
    return int(np.clip((1 << 30) // per_dc, 1, D))


def surface_v1(F: torch.Tensor, code_ffts: torch.Tensor) -> torch.Tensor:
    """K7's surface on a CUDA tensor, its plain version on a CPU one."""
    if F.device.type == "cpu":
        return acquire.corr_surface_plain(F, code_ffts)
    return acquire.corr_surface(F, code_ffts)


def grid_search(x: torch.Tensor, code_ffts: torch.Tensor,
                dopp_fixed: torch.Tensor, n: int, window: int, blocks: int,
                peak_mean: bool, dop_chunk: int | None = None,
                route: str = "v2", n_valid: int = 0, data_window: int = 0):
    """Search the full grid; returns per-PRN (metric f32 [P], code_idx
    i32 [P], dop_idx i64 [P]) tensors.

    x          : complex64 [>= (blocks-1)*n + data_window] internal-rate
                 samples
    code_ffts  : complex64 [P, window] natural-order code spectra
    dopp_fixed : int [D] per-sample NCO increments
    route      : "v2", "v2p" or "v1" (acquire/plan.acq_plan)
    n_valid    : v2p: the exact linear lags K1's reduction is masked to;
                 code_idx then counts from window - n_valid
    data_window: samples of data per block window (default: window);
                 zeros follow up to window
    dop_chunk  : dopplers per kernel call (default: dop_chunk_for)"""
    P = code_ffts.shape[0]
    D = int(dopp_fixed.shape[0])
    dev = x.device
    xb = block_windows(x, n, data_window or window, blocks, pad_to=window)
    if dop_chunk is None:
        dop_chunk = dop_chunk_for(route, P, blocks, window, D)
    best_metric = torch.full((P,), -float("inf"), dtype=torch.float32,
                             device=dev)
    best_code = torch.zeros((P,), dtype=torch.int32, device=dev)
    best_dop = torch.zeros((P,), dtype=torch.int64, device=dev)
    cells = torch.full((1, 1), float(n_valid or window),
                       dtype=torch.float32, device=dev)
    for d0 in range(0, D, dop_chunk):
        df = dopp_fixed[d0:d0 + dop_chunk].to(dev, torch.int64)
        F = mix_fft(xb, df)
        if route == "v1":
            q = surface_v1(F, code_ffts)                        # [P, dc, W]
            code_idx = torch.argmax(q, dim=-1)                  # first max
            peak = torch.gather(q, -1, code_idx[..., None])[..., 0]
            code_idx = code_idx.to(torch.int32)
            metric = peak / q.mean(dim=-1) if peak_mean else peak
        else:
            peak, code_idx, sm = acquire2.corr_surface2(F, code_ffts,
                                                        n_valid)  # [P, dc]
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
# (signal, prns, route, window, device) skip the host FFT build and the
# upload
_CODE_FFTS_DEV: dict = {}
_CODE_FFTS_CAP = 4


def device_code_ffts(sig, prns, n: int, window: int, device,
                     route: str = "v2") -> torch.Tensor:
    """build_code_ffts as complex64 on `device`, through the LRU."""
    key = (sig.name, tuple(prns), n, route, window, torch.device(device))
    code_ffts = _CODE_FFTS_DEV.pop(key, None)
    if code_ffts is None:
        cf_host = build_code_ffts(sig, prns, n, window).astype(np.complex64)
        code_ffts = torch.from_numpy(cf_host).to(device)
    _CODE_FFTS_DEV[key] = code_ffts            # re-insert = most recent
    while len(_CODE_FFTS_DEV) > _CODE_FFTS_CAP:
        _CODE_FFTS_DEV.pop(next(iter(_CODE_FFTS_DEV)))
    return code_ffts


def acquire_signal(sig, x_int: torch.Tensor, prns, doppler_search=None,
                   ms: int = 80) -> list:
    """Run acquisition for one signal over `prns`.

    x_int: complex64 internal-rate samples covering >= ms+2 ms, on the
    device the search runs on.  Returns list[AcqResult] in PRN order.
    Refuses the reference's route switches GNSS_DSP_NO_PALLAS and
    GNSS_DSP_NO_V2P (device.refuse_switches)."""
    refuse_switches("acquire_signal",
                    ("GNSS_DSP_NO_PALLAS", "GNSS_DSP_NO_V2P"))
    if sig.fdma_hz or sig.acq_serial:
        raise NotImplementedError(
            f"{sig.name}: FDMA (acquire_signal_fdma) and serial searches "
            "(acquire/serial.py) are not ported yet")
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    route, window, data_window, n_valid = acq_plan(sig)
    blocks = _block_count(sig, ms)
    dops, fixed = doppler_grid(sig, doppler_search)
    code_ffts = device_code_ffts(sig, prns, n, window, x_int.device, route)
    metric, code_idx, dop_idx = grid_search(
        x_int, code_ffts, torch.from_numpy(fixed.astype(np.int64)),
        n=n, window=window, blocks=blocks,
        peak_mean=(sig.acq_metric == "peak_mean"), route=route,
        n_valid=n_valid, data_window=data_window)
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
