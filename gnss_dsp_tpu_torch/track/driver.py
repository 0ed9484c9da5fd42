"""Host driver for the tracking engine: chunked streaming, multi-channel
batching, row accumulation and reference-format output.

Counterpart: gnss_dsp_tpu/track/driver.py (`TrackChannel`, `make_params`
:117-191, `track_file` :221-701 with the host int64 counters and
`emit_rows` :505-536, the streaming chunk loop with refill and pointer
rebase :580-701, `format_row_14` :704-711).  N channels share one
device-resident chunk, each with its own pointer; the unbounded counters
(samp, code_cyc, carrier_cyc) accumulate on the host in python ints from
per-block deltas.

make_params records the route on the card as the reference's router
chooses it (:178-183): the whole-loop kernel K2 (fused_scan) for every
signal with a code table, every subcarrier family, sub-block and long
code, coherent or not, unless GNSS_DSP_NO_FUSED is set or recovery is on;
else the per-step route on K3, or on K4 when GNSS_DSP_PALLAS_V1 is set
(pallas_v2).  Recovery runs the plain scan (track/engine).  Under
GNSS_DSP_NO_PALLAS the reference's _pallas_ok (:108-114) sends every scan
to its XLA scan: the port's CPU runs the plain scan anyway, and a card
refuses the switch (device.refuse_no_pallas) in track_file, `track
multi` and the receiver alike.  GNSS_DSP_NO_V2P is an acquisition switch
and moves nothing here.

Mixed signals (`sigs`, the CLI's `track multi`, :256-283, 343-480): each
channel carries its own signal's constants in its sigp row, its own code
row (the [C, Lmax] table zero-padded, each wrapping at its own length),
carrier-aiding ratio, carrier offset (`coffsets`, plus its FDMA channel)
and coherent span; the launch takes the subcarrier kind "tmboc" if any
channel is TMBOC, else "subc" if any has a subcarrier, else "none"; the
loop constants are the first signal's and the block envelope nmax the
largest (channel_setup, shared with track/receiver).

Extended-coherent tracking (coherent_blocks = M, -1 for each signal's own
overlay length) builds the reference's overlay table (:393-413): each
channel's secondary code rolled by its TrackChannel.overlay_phase, the
overlay period in the sigp NOV lane, M in the COH lane.  Only
whole-period signals qualify (:299-306).

With a mesh (parallel/mesh) the channels are padded to a multiple of its
sat axis with clones of channel 0, whose rows are computed but never
emitted (:311-331), and every chunk runs parallel/track.
track_scan_sharded; the recovery bins split over it like the state.
The reference's refusals stand: coherent tracking under a mesh needs
K2, so not with recovery or GNSS_DSP_NO_PALLAS (:318-324), and a
mixed-signal run under a mesh needs K2 and no recovery (:280-283).

Checkpoint/resume (:421-450, 664-690, track/checkpoint): after every
chunk the state and host counters go to one npz (atomic rename); a
resume seeks the stream to the checkpoint's sample and goes on bit for
bit.  Unknown-code recovery (recover_after; None: 200 blocks where every
signal recovers by default, the BeiDou B2b ones, else off) leaves each
channel's complex bins on TrackChannel.recovered.  GNSS_DSP_TIMING prints
the streaming loop's wall split (read-wait, upload+convert, scan+rows;
:585-694) to stderr once at the end, the preloaded chunk nothing, as in
the reference.  GNSS_DSP_UPLOAD_INT4 uploads each chunk as packed 4-bit
I/Q (ops/cplx.from_int4_iq, :623-630).

Single-chunk mode (`preloaded`, :536-575): the batched workload runner
(cli/workload) uploads each band once and hands every script on it the
whole padded band on the device; the scan then runs over that one chunk,
with no reader, no refill and no rebase, until every channel stalls at
the data end or max_blocks.  The reference's gate (:538-546) takes the
streaming reader instead when the pad is short of nmax (the port's
margin, every route's), the length is not a multiple of 1024, or a
checkpoint, a resume or a mesh is asked for.

The kernels read the plain [C, L] int8 code table (long codes too: L2CL's
767,250 and GLONASS P's 5,110,000 chips stay in device memory), so the
JAX package's extended code rows have no counterpart.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gnss_dsp_tpu_torch.device import refuse_no_pallas, resolve_device
from gnss_dsp_tpu_torch.ops import cplx, nco
from gnss_dsp_tpu_torch.utils.profiling import device_sync
from gnss_dsp_tpu_torch.parallel.track import track_scan_sharded
from gnss_dsp_tpu_torch.track import checkpoint
from gnss_dsp_tpu_torch.track.engine import (
    SIGP_COH, SIGP_NOV, TrackParams, init_state, sigp_row, track_scan,
)
from gnss_dsp_tpu_torch.ops.track_step import subc_kind
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
    recovered: np.ndarray | None = None   # complex recovery bins a chip


def make_params(sig, fs: float, coffset: float, loop_dwells=(500, 500),
                pll_from_start: bool = False, recover_after: int = -1,
                coherent_blocks: int = 1) -> TrackParams:
    use_pallas = not os.environ.get("GNSS_DSP_NO_PALLAS")
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
        pallas_v2=use_pallas and not os.environ.get("GNSS_DSP_PALLAS_V1"),
        fused_scan=use_pallas and recover_after < 0
        and not os.environ.get("GNSS_DSP_NO_FUSED"),
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
        if not os.environ.get("GNSS_DSP_PALLAS_V1"):
            # under GNSS_DSP_PALLAS_V1 the launch keeps the first
            # signal's static family, as the reference's does
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


def emit_rows(channels, n_emit, emit, rows_f, rows_i, nb) -> bool:
    """Accumulate the host counters and emit (or keep) each channel's
    rows of a scan, block by block (:505-536); channels from n_emit on
    are clones, computed but never emitted.  True if any channel ran."""
    rows_f = rows_f.cpu().numpy()
    rows_i = rows_i.cpu().numpy()
    any_row = False
    for b in range(nb):
        for k, ch in enumerate(channels):
            nn = int(rows_i[b, k, 0])
            if nn == 0:
                continue
            any_row = True
            if k >= n_emit:
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


def _clone(c0):
    return TrackChannel(prn=c0.prn, doppler=c0.doppler,
                        code_offset=c0.code_offset,
                        carrier_phase=c0.carrier_phase,
                        pll_from_start=c0.pll_from_start)


def track_file(sig, fp, fs: float, coffset: float, channels,
               loop_dwells=(500, 500), chunk_ms: float = 2000.0,
               max_blocks: int | None = None, emit=None, device="cuda",
               coherent_blocks: int = 1, mesh=None,
               recover_after: int | None = None,
               checkpoint_path: str | None = None,
               resume_from: str | None = None, sigs=None, coffsets=None,
               preloaded=None):
    """Track `channels` (list[TrackChannel]) through the int8 I/Q stream
    `fp` on `device` (the card unless the caller asks for the CPU).
    coherent_blocks: the extended-coherent span M (1 = off, -1 = each
    signal's overlay length).  mesh: shard the channels over its sat axis
    (parallel/track.track_scan_sharded; the chunk and the state stay on
    `device`).  sigs: one signal per channel (a mixed-signal run), each
    with its carrier offset in coffsets (default `coffset`).
    recover_after: unknown-code recovery after that many blocks (None:
    the signals' default), the bins left on each channel's .recovered.
    checkpoint_path: write the state after every chunk; resume_from: go
    on from such a file (`fp` seekable).  preloaded: (x, n) with x the
    whole stream's n samples on `device`, complex64, zero-padded to a
    multiple of 1024 (cli/track._preload_chunk): one scan chunk, `fp`
    unread, unless the gate sends the run to the streaming reader.

    emit(channel_index, row_dict) is called once per completed block, in
    block order per chunk.  Returns the channels (rows accumulated when
    emit is None)."""
    mixed = sigs is not None and len({s.name for s in sigs}) > 1
    sigs = [sig] * len(channels) if sigs is None else list(sigs)
    if len(sigs) != len(channels):
        raise ValueError("sigs needs one signal a channel")
    for s in set(sigs):
        if s.code_table is None:
            raise NotImplementedError(
                f"{s.name}: no code table (code windows only), as in the "
                f"reference")
    coffsets = ([coffset] * len(channels) if coffsets is None else
                list(coffsets) + [coffset] * (len(channels) - len(coffsets)))
    if recover_after is None:
        recover_after = (200 if all(s.recover_default for s in sigs)
                         else -1)
    if mixed and mesh is not None and (os.environ.get("GNSS_DSP_NO_FUSED")
                                       or os.environ.get("GNSS_DSP_NO_PALLAS")
                                       or recover_after >= 0):
        raise ValueError("a mixed-signal run under a mesh needs the fused "
                         "kernel K2 (GNSS_DSP_NO_FUSED and GNSS_DSP_NO_PALLAS "
                         "unset) and no recovery (drop --mesh)")
    refuse_no_pallas("track_file", device,
                     *(mesh.devices.flat if mesh is not None else ()))
    dev = resolve_device(device)
    n_emit = len(channels)
    if mesh is not None:
        # pad to a multiple of the sat axis with clones of channel 0
        pad = (-len(channels)) % mesh.shape["sat"]
        channels = list(channels) + [_clone(channels[0])
                                     for _ in range(pad)]
        sigs = sigs + [sigs[0]] * pad
        coffsets = coffsets + [coffsets[0]] * pad
    setup = channel_setup(sigs, channels, fs, coffsets, loop_dwells,
                          coherent_blocks, recover_after, chunk_ms, mixed,
                          dev)
    params = setup.params
    if mesh is not None and params.coh_blocks > 1 and not params.fused_scan:
        raise ValueError("coherent tracking under a mesh needs the fused "
                         "kernel K2 (GNSS_DSP_NO_FUSED or GNSS_DSP_NO_PALLAS "
                         "set, or recovery on: pass recover_after=-1)")
    C = len(channels)

    abs_buf0 = 0          # the stream sample at the chunk's start
    total_blocks = 0
    if resume_from is not None:
        state, host, meta = checkpoint.load(resume_from, dev)
        if state.ptr.shape[0] != C:
            raise ValueError(f"checkpoint holds {state.ptr.shape[0]} "
                             f"channels, this run {C}")
        abs_buf0 = int(meta["abs_buf0"])
        total_blocks = int(meta["total_blocks"])
        fp.seek(2 * abs_buf0)
        for k, ch in enumerate(channels):
            ch.samp = int(host["samp"][k])
            ch.code_cyc = int(host["code_cyc"][k])
            ch.carrier_cyc = int(host["carrier_cyc"][k])
    else:
        ptr0, code_p0 = first_boundary(sigs, channels, fs)
        state = init_state(
            code_p=code_p0, code_f_off=np.zeros(C),
            carrier_p=np.array([c.carrier_phase for c in channels]),
            carrier_f=np.array([c.doppler for c in channels]),
            ptr=ptr0, device=dev,
            recover_bins=(max(s.code_length for s in sigs)
                          if recover_after >= 0 else 1))
    scan = dict(ratios=setup.ratios, coffset_df=setup.coffset_df,
                sigp=setup.sigp, overlay=setup.overlay)

    chunk_samples = int(fs * chunk_ms / 1000.0)
    pad_extra = params.nmax
    if preloaded is not None:
        x_dev, n_file = preloaded
        if (resume_from is not None or checkpoint_path is not None
                or mesh is not None or x_dev.shape[0] % 1024
                or x_dev.shape[0] < n_file + pad_extra):
            preloaded = None
    if preloaded is not None:
        sub_ms = min(s.code_period_ms / s.sub_blocks for s in sigs)
        file_blocks = int(n_file / fs * 1000.0 / sub_ms) + 2
        while True:
            nb = min(setup.blocks_per_scan, file_blocks)
            if max_blocks is not None:
                nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break
            state = state._replace(stalled=torch.zeros_like(state.stalled))
            state, rows_f, rows_i = track_scan(
                x_dev, n_file, setup.code_tab, state, params, nb, **scan)
            total_blocks += nb
            if not emit_rows(channels, n_emit, emit, rows_f, rows_i, nb):
                break
            if bool(state.stalled.all()):
                break
        return _recovered(channels, n_emit, state, recover_after)

    int4 = bool(os.environ.get("GNSS_DSP_UPLOAD_INT4"))
    # GNSS_DSP_TIMING: the reference's wall split of the streaming loop
    # (read wait, upload and conversion, scan and rows), one stderr line
    # at the end; the upload is synchronised only then
    timing = bool(os.environ.get("GNSS_DSP_TIMING"))
    t_read = t_up = t_scan = 0.0
    buf = np.zeros(0, np.int8)         # interleaved int8 I/Q bytes
    reader = _PrefetchReader(fp, chunk_samples + pad_extra)
    while True:
        # refill the chunk (the next read already ran on the prefetch
        # thread while the previous scan ran)
        t0 = time.perf_counter()
        nbuf = len(buf) // 2
        want = chunk_samples + params.nmax - nbuf
        if want > 0:
            xx = reader.take(want)
            if xx is not None and len(xx):
                buf = np.concatenate([buf, xx])
                nbuf = len(buf) // 2
        if nbuf == 0:
            break
        t_read += time.perf_counter() - t0
        nb = setup.blocks_per_scan
        if max_blocks is not None:
            nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break
        # tail pad >= nmax so every block a channel can start fits; the
        # raw bytes upload as they are (or packed to 4 bits) and the pad
        # is appended on the device
        t0 = time.perf_counter()
        tail = pad_extra + (-(nbuf + pad_extra)) % 1024
        x_dev, _ = cplx.from_iq(buf, pad=tail, device=dev, int4=int4)
        if timing:
            device_sync(x_dev)                # the upload's end
            t_up += time.perf_counter() - t0
            t0 = time.perf_counter()
        state = state._replace(stalled=torch.zeros_like(state.stalled))
        if mesh is not None:
            state, rows_f, rows_i = track_scan_sharded(
                mesh, x_dev, nbuf, setup.code_tab, state, params, nb, **scan)
        else:
            state, rows_f, rows_i = track_scan(
                x_dev, nbuf, setup.code_tab, state, params, nb, **scan)
        emitted_any = emit_rows(channels, n_emit, emit, rows_f, rows_i, nb)
        if timing:
            t_scan += time.perf_counter() - t0
        total_blocks += nb
        if max_blocks is not None and total_blocks >= max_blocks:
            break

        # drop fully-consumed samples, rebase pointers (2 bytes/sample)
        consumed = int(state.ptr.min())
        buf = buf[2 * consumed:]
        state = state._replace(ptr=state.ptr - consumed)
        abs_buf0 += consumed
        if checkpoint_path is not None:
            # the pointers are relative to the stream sample abs_buf0, so
            # a resume needs only a seek: no sample is stored
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "wb") as f:
                checkpoint.save(f, state, channels,
                                meta={"abs_buf0": abs_buf0,
                                      "total_blocks": total_blocks})
            os.replace(tmp, checkpoint_path)

        if reader.done and not emitted_any:
            break
        if reader.done and bool(state.stalled.all()):
            # every channel is frozen at the data end and no samples can
            # arrive: rebasing cannot unstall them
            break
    if timing:
        print(f"[track_file timing] read-wait {t_read:.2f} s  "
              f"upload+convert {t_up:.2f} s  scan+rows {t_scan:.2f} s",
              file=sys.stderr)
    return _recovered(channels, n_emit, state, recover_after)


def _recovered(channels, n_emit, state, recover_after):
    """The emitted channels, each with its recovery bins on .recovered
    when recovery ran."""
    if recover_after >= 0:
        acc_re = state.acc_re.cpu().numpy()
        acc_im = state.acc_im.cpu().numpy()
        for k, ch in enumerate(channels[:n_emit]):
            ch.recovered = acc_re[k] + 1j * acc_im[k]
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
