"""Host driver for the tracking engine: chunked streaming, multi-channel
batching, row accumulation and reference-format output.

Counterpart: gnss_dsp_tpu/track/driver.py (`TrackChannel`, `make_params`
:117-191, the host int64 counters and `emit_rows` :505-536, the streaming
chunk loop with refill and pointer rebase :580-701, `format_row_14`
:704-711).  N channels share one device-resident chunk, each with its own
pointer; the unbounded counters (samp, code_cyc, carrier_cyc) accumulate
on the host in python ints from per-block deltas.

make_params records the route on the card as the reference's router
chooses it (:178-183): the whole-loop kernel K2 (fused_scan) for every
signal with a code table, every subcarrier family, sub-block and long
code, coherent or not, unless GNSS_DSP_NO_FUSED is set or recovery is on;
else the per-step route on K3, or on K4 when GNSS_DSP_PALLAS_V1 is set
(pallas_v2).

Extended-coherent tracking (coherent_blocks = M, -1 for the signal's own
overlay length) builds the reference's overlay table (:393-413): each
channel's secondary code rolled by its TrackChannel.overlay_phase, the
overlay period in the sigp NOV lane, M in the COH lane.  Only
whole-period signals qualify (:299-306).

With a mesh (parallel/mesh) the channels are padded to a multiple of its
sat axis with clones of channel 0, whose rows are computed but never
emitted (:311-331), and every chunk runs parallel/track.
track_scan_sharded; coherent tracking under a mesh needs the fused
kernel K2 (:318-324).

Not ported here: checkpoint/resume, mixed-signal (`multi`)
and preloaded chunks, the int4 front end (track_file refuses
GNSS_DSP_UPLOAD_INT4, and the route switch GNSS_DSP_NO_PALLAS) and
unknown-code recovery.  The kernels read the plain [C, L] int8 code
table (long codes too: L2CL's 767,250 and GLONASS P's 5,110,000 chips
stay in device memory), so the JAX package's extended code rows have no
counterpart.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from gnss_dsp_tpu_torch.device import refuse_switches, resolve_device
from gnss_dsp_tpu_torch.ops import cplx, nco
from gnss_dsp_tpu_torch.parallel.track import track_scan_sharded
from gnss_dsp_tpu_torch.track.engine import (
    SIGP_NOV, TrackParams, init_state, sigp_from_params, track_scan,
)
from gnss_dsp_tpu_torch.utils.twofloat import tf_from_f64


class _PrefetchReader:
    """Double-buffered host ingest: the next chunk's file read runs on a
    worker thread while the device works on the current chunk.  Yields
    raw interleaved int8 I/Q bytes; the conversion happens on the device
    (cplx.from_int8_iq)."""

    def __init__(self, fp, ahead_samples: int):
        self.fp = fp
        self.q = queue.Queue(maxsize=2)
        self.leftover = np.zeros(0, np.int8)
        self.done = False
        self._chunk = int(ahead_samples)
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            raw = self.fp.read(2 * self._chunk)
            if not raw:
                self.q.put(None)
                return
            n2 = 2 * (len(raw) // 2)
            self.q.put(np.frombuffer(raw, np.int8, count=n2))
            if n2 < 2 * self._chunk:
                self.q.put(None)
                return

    def take(self, want: int):
        """Up to `want` samples of int8 I/Q bytes (short only at EOF);
        None when drained."""
        parts = []
        got = len(self.leftover) // 2
        if got:
            parts.append(self.leftover)
            self.leftover = np.zeros(0, np.int8)
        while got < want and not self.done:
            nxt = self.q.get()
            if nxt is None:
                self.done = True
                break
            parts.append(nxt)
            got += len(nxt) // 2
        if not parts:
            return None
        x = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if len(x) > 2 * want:
            self.leftover = x[2 * want:]
            x = x[: 2 * want]
        return x


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
        pallas_v2=not os.environ.get("GNSS_DSP_PALLAS_V1"),
        fused_scan=recover_after < 0
        and not os.environ.get("GNSS_DSP_NO_FUSED"),
    )


def overlay_table(sig, channels, coherent_blocks: int):
    """(M, overlay f32 [C, nov] or None, each row's period): the coherent
    span and each channel's secondary code rolled so that block b reads
    chip (overlay_phase + b) mod its period, rows zero-padded to the
    longest.  M = -1 is the signal's own overlay length; M = 1 (or an
    overlay-free signal at -1) is non-coherent."""
    nov = len(sig.secondary(1)) if sig.secondary is not None else 1
    M = max(nov, 1) if coherent_blocks == -1 else int(coherent_blocks)
    if M <= 1:
        return 1, None, None
    if sig.sub_blocks != 1:
        raise ValueError(f"coherent tracking needs a whole-period signal; "
                         f"{sig.name} tracks in {sig.sub_blocks} sub-blocks")
    rows = [np.roll(np.asarray(sig.secondary(ch.prn) if sig.secondary
                               is not None else np.ones(1), np.float32),
                    -int(ch.overlay_phase)) for ch in channels]
    periods = [len(r) for r in rows]
    table = np.zeros((len(rows), max(periods)), np.float32)
    for k, r in enumerate(rows):
        table[k, :len(r)] = r
    return M, table, periods


def track_file(sig, fp, fs: float, coffset: float, channels,
               loop_dwells=(500, 500), chunk_ms: float = 2000.0,
               max_blocks: int | None = None, emit=None, device="cuda",
               coherent_blocks: int = 1, mesh=None):
    """Track `channels` (list[TrackChannel]) through the int8 I/Q stream
    `fp` on `device` (the card unless the caller asks for the CPU).
    coherent_blocks: the extended-coherent span M (1 = off, -1 = the
    signal's overlay length; see overlay_table).  mesh: shard the
    channels over its sat axis (parallel/track.track_scan_sharded; the
    chunk and the state stay on `device`).

    emit(channel_index, row_dict) is called once per completed block, in
    block order per chunk.  Returns the channels (rows accumulated when
    emit is None).  Refuses GNSS_DSP_UPLOAD_INT4 (the int4 front end is
    not ported) and the route switches GNSS_DSP_NO_PALLAS and
    GNSS_DSP_NO_V2P (device.refuse_switches)."""
    refuse_switches("track_file")
    if sig.code_table is None:
        raise NotImplementedError(
            f"{sig.name}: no code table (code windows only), as in the "
            f"reference")
    if sig.recover_default:
        raise NotImplementedError(
            f"{sig.name}: unknown-code recovery is not ported")
    dev = resolve_device(device)
    n_emit = len(channels)
    if mesh is not None:
        # pad to a multiple of the sat axis with clones of channel 0
        c0 = channels[0]
        channels = list(channels) + [
            TrackChannel(prn=c0.prn, doppler=c0.doppler,
                         code_offset=c0.code_offset,
                         carrier_phase=c0.carrier_phase,
                         pll_from_start=c0.pll_from_start)
            for _ in range((-len(channels)) % mesh.shape["sat"])]
    M, overlay, periods = overlay_table(sig, channels, coherent_blocks)
    params = make_params(sig, fs, coffset, loop_dwells,
                         pll_from_start=all(c.pll_from_start
                                            for c in channels),
                         coherent_blocks=M)
    if mesh is not None and M > 1 and not params.fused_scan:
        raise ValueError("coherent tracking under a mesh needs the fused "
                         "kernel K2 (GNSS_DSP_NO_FUSED is set)")
    C = len(channels)
    # the signal's constants, subcarrier and coherent lanes, one row per
    # channel; each channel's overlay period in the NOV lane
    sigp = sigp_from_params(params, C, dev)
    if overlay is not None:
        sigp[:, SIGP_NOV] = torch.tensor(periods, dtype=torch.float32,
                                         device=dev)
        overlay = torch.from_numpy(overlay).to(dev)

    # alignment to the first code boundary (:141-143), per channel: the
    # reference discards n0 samples; with a shared stream each channel's
    # pointer starts at its own n0
    L = sig.code_length
    ptr0 = np.zeros(C, np.int32)
    code_p0 = np.zeros(C, np.float64)
    for k, ch in enumerate(channels):
        n0 = int(fs * 0.001 * sig.code_period_ms * (L - ch.code_offset) / L)
        ptr0[k] = n0
        code_p0[k] = ch.code_offset + n0 * (sig.chip_rate / fs)
    state = init_state(
        code_p=code_p0, code_f_off=np.zeros(C),
        carrier_p=np.array([c.carrier_phase for c in channels]),
        carrier_f=np.array([c.doppler for c in channels]),
        ptr=ptr0, device=dev)
    code_tab = torch.from_numpy(np.ascontiguousarray(
        sig.code_table(tuple(c.prn for c in channels)).astype(np.int8))
    ).to(dev)
    ratios = torch.tensor([sig.track_carrier_ratio(c.prn) for c in channels],
                          dtype=torch.float32, device=dev)
    coffset_df = torch.tensor(
        [nco.freq_to_fixed(-(coffset + (sig.fdma_hz or 0.0) * c.prn) / fs)
         for c in channels], dtype=torch.int32, device=dev)

    chunk_samples = int(fs * chunk_ms / 1000.0)
    blocks_per_scan = int(chunk_ms / (sig.code_period_ms / sig.sub_blocks)) + 2
    pad_extra = params.nmax

    def emit_rows(rows_f, rows_i, nb):
        rows_f = rows_f.cpu().numpy()
        rows_i = rows_i.cpu().numpy()
        any_row = False
        for b in range(nb):
            for k, ch in enumerate(channels):
                nn = int(rows_i[b, k, 0])
                if nn == 0:
                    continue
                any_row = True
                if k >= n_emit:            # a mesh-padding clone
                    continue
                ch.samp += nn
                ch.carrier_cyc += int(rows_i[b, k, 1])
                ch.code_cyc += int(rows_i[b, k, 2])
                f = rows_f[b, k]
                row = {
                    "block": int(f[0]), "p_re": float(f[1]),
                    "p_im": float(f[2]),
                    "carrier_f": float(f[3]), "code_f_offset": float(f[4]),
                    "phase_deg": float(f[5]), "early": float(f[6]),
                    "prompt": float(f[7]), "late": float(f[8]),
                    "code_cyc": ch.code_cyc, "code_p": float(f[9]),
                    "carrier_cyc": ch.carrier_cyc,
                    "carrier_p": float(f[10]),
                    "samp": ch.samp,
                }
                if emit is not None:
                    emit(k, row)
                else:
                    ch.rows.append(row)
        return any_row

    buf = np.zeros(0, np.int8)         # interleaved int8 I/Q bytes
    total_blocks = 0
    reader = _PrefetchReader(fp, chunk_samples + pad_extra)
    while True:
        # refill the chunk (the next read already ran on the prefetch
        # thread while the previous scan ran)
        nbuf = len(buf) // 2
        want = chunk_samples + params.nmax - nbuf
        if want > 0:
            xx = reader.take(want)
            if xx is not None and len(xx):
                buf = np.concatenate([buf, xx])
                nbuf = len(buf) // 2
        if nbuf == 0:
            break
        nb = blocks_per_scan
        if max_blocks is not None:
            nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break
        # tail pad >= nmax so every block a channel can start fits; the
        # raw bytes upload as they are and the pad is appended on the
        # device
        tail = pad_extra + (-(nbuf + pad_extra)) % 1024
        x_dev = cplx.from_int8_iq(buf, pad=tail, device=dev)
        state = state._replace(stalled=torch.zeros_like(state.stalled))
        if mesh is not None:
            state, rows_f, rows_i = track_scan_sharded(
                mesh, x_dev, nbuf, code_tab, state, params, nb,
                ratios=ratios, coffset_df=coffset_df, sigp=sigp,
                overlay=overlay)
        else:
            state, rows_f, rows_i = track_scan(
                x_dev, nbuf, code_tab, state, params, nb, ratios=ratios,
                coffset_df=coffset_df, sigp=sigp, overlay=overlay)
        emitted_any = emit_rows(rows_f, rows_i, nb)
        total_blocks += nb
        if max_blocks is not None and total_blocks >= max_blocks:
            break

        # drop fully-consumed samples, rebase pointers (2 bytes/sample)
        ptrs = state.ptr.cpu().numpy()
        consumed = int(ptrs.min())
        buf = buf[2 * consumed:]
        state = state._replace(ptr=state.ptr - consumed)

        if reader.done and not emitted_any:
            break
        if reader.done and bool(state.stalled.all()):
            # every channel is frozen at the data end and no samples can
            # arrive: rebasing cannot unstall them
            break
    return channels[:n_emit]


def format_row_14(row: dict) -> str:
    """The reference 14-column text row (track-gps-l1.py:176-177)."""
    return "%d %f %f %f %f %f %f %f %f %d %f %d %f %d" % (
        row["block"], row["p_re"], row["p_im"], row["carrier_f"],
        row["code_f_offset"], row["phase_deg"], row["early"], row["prompt"],
        row["late"], row["code_cyc"], row["code_p"], row["carrier_cyc"],
        row["carrier_p"], row["samp"],
    )


def format_row_9(row: dict) -> str:
    """The reference 9-column row (e.g. track-galileo-e1b.py:166-167)."""
    return "%d %f %f %f %f %f %f %f %f" % (
        row["block"], row["p_re"], row["p_im"], row["carrier_f"],
        row["code_f_offset"], row["phase_deg"], row["early"], row["prompt"],
        row["late"],
    )
