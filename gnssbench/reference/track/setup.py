"""The tracking set-up a scan takes: each channel's parameters, sigp
row, code row, carrier-aiding ratio, carrier-offset increment and its
first code boundary, worked out from the signal catalog and the
channel specs alone.

Frozen copy of gnss_dsp_tpu_torch/track/driver.py (TrackChannel,
make_params, _chan_M, coherent_rows, ChannelSetup, channel_setup,
first_boundary) at commit 196026d.  Changed: imports point at the frozen
copies beside it; the route switches (GNSS_DSP_NO_PALLAS,
GNSS_DSP_PALLAS_V1, GNSS_DSP_NO_FUSED) are not read, since the
reference has one route, the plain scan.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from gnssbench.reference.track import nco
from gnssbench.reference.track.engine import (
    SIGP_COH, SIGP_NOV, TrackParams, sigp_row,
)
from gnssbench.reference.track.track_step import subc_kind
from gnssbench.reference.track.twofloat import tf_from_f64


@dataclass
class TrackChannel:
    prn: int
    doppler: float
    code_offset: float
    carrier_phase: float = 0.0
    pll_from_start: bool = False   # --carrier-phase given
    overlay_phase: int = 0         # overlay chip of the first tracked code
                                   # period (coherent tracking; from
                                   # coherent acquisition)
    # host-side accumulators
    samp: int = 0
    code_cyc: int = 0
    carrier_cyc: int = 0
    rows: list = field(default_factory=list)
    recovered: np.ndarray | None = None   # complex recovery bins a chip


def make_params(sig, fs: float, coffset: float, loop_dwells=(500, 500),
                pll_from_start: bool = False, recover_after: int = -1,
                coherent_blocks: int = 1) -> TrackParams:
    period_ms = sig.code_period_ms
    sub = sig.sub_blocks
    nmax = int(fs * 0.001 * period_ms / sub * 1.5) + 4
    fw, fn = loop_dwells
    if pll_from_start or sig.track_mode_initial == "PLL":
        fw = fn = 0
    cf_hi, cf_lo = tf_from_f64(np.float64(sig.chip_rate) / np.float64(fs))
    return TrackParams(
        fs=float(fs),
        chip_rate=float(sig.chip_rate),
        cf_hi=cf_hi,
        cf_lo=cf_lo,
        code_length=int(sig.code_length),
        carrier_ratio=float(sig.track_carrier_ratio()),
        el_spacing=float(sig.el_spacing),
        coffset_df_fixed=int(nco.freq_to_fixed(-coffset / fs)),
        nmax=nmax,
        fll_wide_blocks=int(fw),
        fll_narrow_blocks=int(fn),
        pll_k1=float(sig.pll_k1),
        pll_k2=float(sig.pll_k2),
        code_period_ms=float(period_ms),
        sub=int(sub),
        subcarrier=str(sig.subcarrier),
        recover_after=int(recover_after),
        coh_blocks=int(coherent_blocks),
    )


def _chan_M(s, coherent_blocks: int) -> int:
    """A channel's coherent span: -1 is its signal's own overlay length
    (1, non-coherent, for an overlay-free signal), else coherent_blocks."""
    if coherent_blocks == -1:
        return max(len(s.secondary(1)) if s.secondary is not None else 1, 1)
    return int(coherent_blocks)


def coherent_rows(sigs, channels, coherent_blocks: int):
    """(M, overlay f32 [C, nov] or None, each row's period, each
    channel's span): M the largest span (1: nothing coherent), each
    channel's secondary code rolled so that block b reads chip
    (overlay_phase + b) mod its period (all ones for a channel at span 1
    or without an overlay), rows zero-padded to the longest
    (driver.py:289-310, 393-415)."""
    spans = [_chan_M(s, coherent_blocks) for s in sigs]
    M = max(spans)
    if M <= 1:
        return 1, None, None, spans
    for s, m in zip(sigs, spans):
        if m > 1 and s.sub_blocks != 1:
            raise ValueError(f"coherent tracking needs a whole-period "
                             f"signal; {s.name} tracks in {s.sub_blocks} "
                             f"sub-blocks")
    rows = [np.roll(np.asarray(s.secondary(ch.prn)
                               if m > 1 and s.secondary is not None
                               else np.ones(1), np.float32),
                    -int(ch.overlay_phase))
            for s, ch, m in zip(sigs, channels, spans)]
    periods = [len(r) for r in rows]
    table = np.zeros((len(rows), max(periods)), np.float32)
    for k, r in enumerate(rows):
        table[k, :len(r)] = r
    return M, table, periods, spans


@dataclass
class ChannelSetup:
    """What a scan of these channels takes besides the chunk and the
    state: the route and envelope (params), and per channel its sigp row,
    code row, carrier-aiding ratio, carrier-offset increment and overlay
    row, all on one device."""
    params: TrackParams
    sigp: torch.Tensor
    code_tab: torch.Tensor
    ratios: torch.Tensor
    coffset_df: torch.Tensor
    overlay: torch.Tensor | None
    blocks_per_scan: int


def channel_setup(sigs, channels, fs: float, coffsets, loop_dwells,
                  coherent_blocks: int, recover_after: int, chunk_ms: float,
                  mixed: bool, dev) -> ChannelSetup:
    """The setup of track_file (driver.py:335-500) for channels of the
    signals `sigs` (one per channel).  mixed: each channel's code row
    from its own signal, zero-padded to the longest, and the launch's
    subcarrier the mix's kind; else one signal's table."""
    sig = sigs[0]
    M, overlay, periods, spans = coherent_rows(sigs, channels,
                                               coherent_blocks)
    pll = all(c.pll_from_start for c in channels)
    params = make_params(sig, fs, coffsets[0], loop_dwells,
                         pll_from_start=pll, recover_after=recover_after,
                         coherent_blocks=M)
    if mixed:
        alls = [make_params(s, fs, 0.0, loop_dwells, pll_from_start=pll,
                            recover_after=recover_after) for s in sigs]
        kinds = {subc_kind(str(s.subcarrier)) for s in sigs}
        kind = "subc" if kinds - {"none"} else "none"
        if "tmboc" in kinds:
            kind = "tmboc"
        params = params._replace(nmax=max(q.nmax for q in alls))
        params = params._replace(subcarrier=kind)
    rows = []
    for s, m in zip(sigs, spans):
        cf_hi, cf_lo = tf_from_f64(np.float64(s.chip_rate) / np.float64(fs))
        rows.append(sigp_row(cf_hi, cf_lo, s.el_spacing, s.code_length,
                             fs * 0.001 * s.code_period_ms, s.sub_blocks,
                             str(s.subcarrier)))
    sigp = torch.from_numpy(np.stack(rows)).to(dev)
    if overlay is not None:
        sigp[:, SIGP_COH] = torch.tensor(spans, dtype=torch.float32,
                                         device=dev)
        sigp[:, SIGP_NOV] = torch.tensor(periods, dtype=torch.float32,
                                         device=dev)
        overlay = torch.from_numpy(overlay).to(dev)
    if mixed:
        tabs = [np.asarray(s.code_table((c.prn,))[0], np.int8)
                for s, c in zip(sigs, channels)]
        code_np = np.zeros((len(channels), max(len(t) for t in tabs)),
                           np.int8)
        for k, t in enumerate(tabs):
            code_np[k, :len(t)] = t
    else:
        code_np = sig.code_table(tuple(c.prn for c in channels)
                                 ).astype(np.int8)
    code_tab = torch.from_numpy(np.ascontiguousarray(code_np)).to(dev)
    ratios = torch.tensor([s.track_carrier_ratio(c.prn)
                           for s, c in zip(sigs, channels)],
                          dtype=torch.float32, device=dev)
    # each channel's carrier-offset wipe: its band's offset and, for an
    # FDMA signal, its channel's (track-glonass-l1.py:161)
    coffset_df = torch.tensor(
        [nco.freq_to_fixed(-(co + (s.fdma_hz or 0.0) * c.prn) / fs)
         for s, c, co in zip(sigs, channels, coffsets)],
        dtype=torch.int32, device=dev)
    sub_ms = min(s.code_period_ms / s.sub_blocks for s in sigs)
    return ChannelSetup(params, sigp, code_tab, ratios, coffset_df, overlay,
                        int(chunk_ms / sub_ms) + 2)


def first_boundary(sigs, channels, fs: float, offsets=None):
    """(ptr int32 [C], code_p float64 [C]): each channel's alignment to
    its first code boundary (:434-442); offsets: each channel's
    segment start in the chunk (the receiver's bands)."""
    ptr0 = np.zeros(len(channels), np.int32)
    code_p0 = np.zeros(len(channels), np.float64)
    for k, (s, ch) in enumerate(zip(sigs, channels)):
        L = s.code_length
        n0 = int(fs * 0.001 * s.code_period_ms * (L - ch.code_offset) / L)
        ptr0[k] = n0 + (0 if offsets is None else offsets[k])
        code_p0[k] = ch.code_offset + n0 * (s.chip_rate / fs)
    return ptr0, code_p0
