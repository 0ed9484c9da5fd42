"""Batched FFT circular-correlation acquisition.

Counterpart: gnss_dsp_tpu/acquire/engine.py (`AcqResult`,
`build_code_ffts` :42-54, `block_windows` :57-77, `grid_search` :176-266
on its v2, v2p and v1 branches, `_block_count` :269-279, `doppler_grid`
:282-290, `acquire_signal` :367-445, `acquire_signal_fdma` :448-502).

The route (acquire/plan.acq_plan, the reference's _fused_plan) sets the
search, on every device:

  v2   circular search at the window (n, or 2n for the pad2 and sliding
       templates): kernel K1 (ops/acquire2) with its in-kernel
       (max, argmax, sum)
  v2p  the pad2 windows without an aligned split (30690, 61380): the 2n
       block windows zero-padded to the route's FFT length, and K1's
       reduction masked to the n exact linear lags (n_valid = n)
  v1   circular search at a window with no aligned split (Xona X5,
       30690; the pad2 windows 61380 and 30690 too under
       GNSS_DSP_NO_V2P): the full surface from kernel K7 (ops/acquire),
       then max, first argmax and mean over the lags in torch
  xla  under GNSS_DSP_NO_PALLAS, the reference's XLA engine: the same
       circular search at the data window with the surface in plain
       torch (ops/acquire2.corr_surface_plain), on the CPU only (the
       entry points refuse the switch on a card, device.refuse_no_pallas)

Per doppler chunk: mix the block windows with each doppler's
oscillator, forward FFT (torch.fft, outside the kernels as in the JAX
package), then the surface kernel.  Across chunks a strict `>` keeps
the earliest best doppler, and inside a chunk argmax takes the first
maximum, so the winning cell does not depend on the chunking.

The sharded search (parallel/acquire) takes its parts from here: the
block windows of one time shard (shard_block_windows, the reference's
parallel/acquire.py:76-82), the surface route (surface, the counterpart
of chunk_q_fused :120-144: K1's natural-order surface on v2, K7 on v1,
the plain surface on xla, CPU only)
and the reduction over the lags (surface_metric).

FDMA (GLONASS L1/L2): every channel shares one m-sequence, so
acquire_signal_fdma searches one code row against the increments of all
C channels' bands (each channel's offset folded into its oscillator,
doppler_grid's chan) in one search, and grid_search's `group` reduces the
per-doppler metrics per band: the first maximum inside each channel's D
dopplers, as the reference's one-chunk-per-channel scan (per_chunk=True)
gives it, however the port chunks the dopplers.  acquire_signal(chan=)
searches one channel's band.

The assisted serial searches (GPS L2CL, GLONASS P) are serial.py.  The
extended-coherent search is in coherent.py and shares block_windows,
mix_fft and the code-spectra LRU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnss_dsp_tpu_torch.acquire.plan import acq_plan
from gnss_dsp_tpu_torch.device import refuse_no_pallas
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


def shard_block_windows(x: torch.Tensor, n: int, window: int, blocks: int,
                        t: int, ntime: int) -> torch.Tensor:
    """Time shard t of ntime's block windows: ceil(blocks / ntime) rows
    from block t * that on, rows past the global block count zero (their
    |.| adds exactly nothing to the block sum)."""
    bl = -(-blocks // ntime)
    xb = block_windows(x, n, window, blocks)[t * bl:(t + 1) * bl]
    if xb.shape[0] < bl:
        xb = torch.nn.functional.pad(xb, (0, 0, 0, bl - xb.shape[0]))
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


def doppler_grid(sig, doppler_search, chan: int = 0):
    """(dopplers, int32 NCO increments) of the grid; the FDMA band offset
    of channel `chan` (sig.fdma_hz * chan) is folded into each increment,
    not into the reported doppler."""
    dmin, dmax, dinc = doppler_search
    dops = np.arange(dmin, dmax, dinc)
    offs = sig.fdma_hz * chan
    fixed = np.array(
        [nco.freq_to_fixed(-(d + offs) / sig.acq_fs) for d in dops],
        dtype=np.int64,
    ).astype(np.int32)
    return dops, fixed


def dop_chunk_for(route: str, P: int, blocks: int, window: int,
                  D: int) -> int:
    """Dopplers per kernel call: as many as keep the [dc, B, W] spectra,
    and on v1 and xla also the [P, dc, W] surface, under ~1 GB."""
    per_dc = blocks * window * 8 + (P * window * 4
                                    if route in ("v1", "xla") else 0)
    return int(np.clip((1 << 30) // per_dc, 1, D))


def surface_v1(F: torch.Tensor, code_ffts: torch.Tensor,
               route: str = "v1") -> torch.Tensor:
    """K7's surface on a CUDA tensor, its plain version on a CPU one.
    Route "xla" (GNSS_DSP_NO_PALLAS) is the plain version and runs on the
    CPU only."""
    if F.device.type == "cpu":
        return acquire.corr_surface_plain(F, code_ffts)
    if route == "xla":
        raise RuntimeError("route xla (GNSS_DSP_NO_PALLAS) runs on the CPU "
                           "only")
    return acquire.corr_surface(F, code_ffts)


def surface(F: torch.Tensor, code_ffts: torch.Tensor,
            route: str) -> torch.Tensor:
    """q f32 [P, dc, W], natural lag order: on route "v2" K1's surface
    (reduce=False), on "v1" K7's; on a CPU tensor their plain version (the
    same function), which is also route "xla" (CPU only)."""
    if route == "v2":
        return acquire2.corr_surface2(F, code_ffts, 0, False)
    return surface_v1(F, code_ffts, route)


def surface_metric(q: torch.Tensor, peak_mean: bool):
    """(metric f32 [P, dc], code_idx i32 [P, dc]) of surfaces q [P, dc, W]:
    the first maximum over the lags, divided by the mean when peak_mean."""
    code_idx = torch.argmax(q, dim=-1)                         # first max
    peak = torch.gather(q, -1, code_idx[..., None])[..., 0]
    metric = peak / q.mean(dim=-1) if peak_mean else peak
    return metric, code_idx.to(torch.int32)


def band_best(metric: torch.Tensor, code_idx: torch.Tensor, group: int):
    """The first maximum of each group of `group` consecutive dopplers:
    metric f32 [P, D], code_idx i32 [P, D] -> (metric f32, code_idx i32,
    dop_idx i64, the index within the group), each [P, D // group].  Of
    equal metrics the lower doppler index wins, as the reference's running
    best over doppler chunks."""
    P, D = metric.shape
    if D % group:
        raise ValueError(f"{D} dopplers do not split into groups of {group}")
    metric = metric.reshape(P, D // group, group)
    best = torch.argmax(metric, dim=-1, keepdim=True)          # first max
    return (torch.gather(metric, 2, best)[..., 0],
            torch.gather(code_idx.reshape(P, D // group, group), 2,
                         best)[..., 0],
            best[..., 0])


def grid_search(x: torch.Tensor, code_ffts: torch.Tensor,
                dopp_fixed: torch.Tensor, n: int, window: int, blocks: int,
                peak_mean: bool, dop_chunk: int | None = None,
                route: str = "v2", n_valid: int = 0, data_window: int = 0,
                group: int | None = None):
    """Search the full grid; returns per-PRN (metric f32 [P], code_idx
    i32 [P], dop_idx i64 [P]) tensors, or with `group` per (PRN, group)
    [P, D // group] ones (band_best).

    x          : complex64 [>= (blocks-1)*n + data_window] internal-rate
                 samples
    code_ffts  : complex64 [P, window] natural-order code spectra
    dopp_fixed : int [D] per-sample NCO increments
    route      : "v2", "v2p", "v1" or "xla" (acquire/plan.acq_plan)
    n_valid    : v2p: the exact linear lags K1's reduction is masked to;
                 code_idx then counts from window - n_valid
    data_window: samples of data per block window (default: window);
                 zeros follow up to window
    dop_chunk  : dopplers per kernel call (default: dop_chunk_for)
    group      : the dopplers fall in consecutive groups of this many (an
                 FDMA channel's band each); the results are each group's
                 first maximum, dop_idx its index within the group.  The
                 chunking need not follow the groups."""
    P = code_ffts.shape[0]
    D = int(dopp_fixed.shape[0])
    dev = x.device
    xb = block_windows(x, n, data_window or window, blocks, pad_to=window)
    if dop_chunk is None:
        dop_chunk = dop_chunk_for(route, P, blocks, window, D)
    cells = torch.full((1, 1), float(n_valid or window),
                       dtype=torch.float32, device=dev)
    metrics, codes = [], []
    for d0 in range(0, D, dop_chunk):
        df = dopp_fixed[d0:d0 + dop_chunk].to(dev, torch.int64)
        F = mix_fft(xb, df)
        if route in ("v1", "xla"):
            metric, code_idx = surface_metric(
                surface_v1(F, code_ffts, route), peak_mean)
        else:
            peak, code_idx, sm = acquire2.corr_surface2(F, code_ffts,
                                                        n_valid)  # [P, dc]
            metric = peak / (sm / cells) if peak_mean else peak
        metrics.append(metric)
        codes.append(code_idx)
    best = band_best(torch.cat(metrics, dim=1), torch.cat(codes, dim=1),
                     group or D)
    return best if group else tuple(v[:, 0] for v in best)


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


def _serial_refused(sig, what: str):
    if sig.acq_serial:
        raise ValueError(f"{sig.name} is an assisted serial search: "
                         f"acquire/serial.serial_search, not {what}")


def _results(sig, n: int, ids, metric, code_idx, dopplers):
    """AcqResults of ids[i] with its (metric, natural code index) and
    its doppler dopplers[i]."""
    metric = metric.cpu().numpy()
    code_idx = code_idx.cpu().numpy()
    out = []
    for i, prn in enumerate(ids):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(AcqResult(prn=prn, doppler=float(dopplers[i]),
                             metric=float(metric[i]), code_offset=code))
    return out


def _search(sig, x_int: torch.Tensor, code_ids, ids, dops, fixed,
            ms: int) -> list:
    """The one grid search of acquire_signal and acquire_signal_fdma: the
    code rows of `code_ids` against the NCO increments `fixed` (int [G *
    D], G = len(dops) groups of D = len(dops[0])) on the signal's plan,
    the first maximum per (code row, group).  Returns the AcqResults of
    `ids`, the i-th that of (row i // G, group i % G), its doppler from
    dops[i % G]."""
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    route, window, data_window, n_valid = acq_plan(sig)
    code_ffts = device_code_ffts(sig, code_ids, n, window, x_int.device,
                                 route)
    metric, code_idx, dop_idx = grid_search(
        x_int, code_ffts, torch.from_numpy(np.asarray(fixed, np.int64)),
        n=n, window=window, blocks=_block_count(sig, ms),
        peak_mean=(sig.acq_metric == "peak_mean"), route=route,
        n_valid=n_valid, data_window=data_window, group=len(dops[0]))
    G = len(dops)
    return _results(sig, n, ids, metric.reshape(-1), code_idx.reshape(-1),
                    [dops[i % G][d] for i, d in
                     enumerate(dop_idx.reshape(-1).cpu().numpy())])


def acquire_signal(sig, x_int: torch.Tensor, prns, doppler_search=None,
                   ms: int = 80, chan: int = 0) -> list:
    """Run acquisition for one signal over `prns`.

    x_int: complex64 internal-rate samples covering >= ms+2 ms, on the
    device the search runs on.  chan: the FDMA channel whose band offset
    the oscillators carry (GLONASS L1/L2; 0 for the others).  Returns
    list[AcqResult] in PRN order.  The route follows the reference's
    switches GNSS_DSP_NO_PALLAS and GNSS_DSP_NO_V2P (acquire/plan); on a
    card GNSS_DSP_NO_PALLAS is refused (device.refuse_no_pallas)."""
    _serial_refused(sig, "acquire_signal")
    refuse_no_pallas("acquire_signal", x_int.device)
    dops, fixed = doppler_grid(sig, doppler_search or sig.doppler_default,
                               chan)
    return _search(sig, x_int, prns, prns, [dops], fixed, ms)


def fdma_grid(sig, doppler_search, chans):
    """(per-channel dopplers [C][D], int64 increments [C * D]) of an FDMA
    search: each channel's band, channel after channel."""
    dops_all, fixed_all = [], []
    for chan in chans:
        dops, fixed = doppler_grid(sig, doppler_search, chan)
        dops_all.append(dops)
        fixed_all.append(fixed)
    return dops_all, np.concatenate(fixed_all).astype(np.int64)


def acquire_signal_fdma(sig, x_int: torch.Tensor, chans, doppler_search=None,
                        ms: int = 80) -> list:
    """Every FDMA channel of `chans` in one search (GLONASS L1/L2): the
    shared m-sequence is one code row, searched against all C x D
    increments (fdma_grid), and each channel's result is the first
    maximum over its own D dopplers (band_best).

    x_int: complex64 internal-rate samples covering >= ms+2 ms, on the
    device the search runs on.  Returns list[AcqResult] in channel order
    (prn field = channel); under GNSS_DSP_NO_PALLAS the plain surface on
    the CPU, and a refusal on a card."""
    _serial_refused(sig, "acquire_signal_fdma")
    refuse_no_pallas("acquire_signal_fdma", x_int.device)
    if not sig.fdma_hz:
        raise ValueError(f"{sig.name} is not an FDMA signal")
    dops_all, fixed = fdma_grid(sig, doppler_search or sig.doppler_default,
                                chans)
    return _search(sig, x_int, chans[:1], chans, dops_all, fixed, ms)
