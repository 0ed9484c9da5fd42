"""Host driver for the tracking engine: chunked streaming, multi-channel
batching, row accumulation and reference-format output.

Counterpart: gnss_dsp_tpu/track/driver.py (`TrackChannel`, `make_params`
:117-191, `track_file` :221-701 with the host int64 counters and
`emit_rows` :505-536, the streaming chunk loop with refill and pointer
rebase :580-701; `format_row_14` :704-711 lives in track/rows).  N
channels share one device-resident chunk, each with its own pointer; the
unbounded counters (samp, code_cyc, carrier_cyc) accumulate on the host
in python ints from per-block deltas (a RowText emit's bulk path sums a
scan's deltas in int64 where it formats them, track/rows).

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
the reference: the loop's spans `track.refill`, `track.assemble` with
`upload` (its device synchronised then) and `track.scan` with
`track.rows` (utils/profiling; the call is the span `track.file`).
GNSS_DSP_UPLOAD_INT4 uploads each chunk's new bytes as packed 4-bit I/Q
(ops/cplx, :623-630).

The chunk refill copies no sample on the host (the reference joins the
carried bytes to each read, :74 and :603): the streaming chunk is the
one-band case of the receiver's segmented chunk (_Chunks).  The prefetch
reader's thread reads the stream straight into staging slots, pinned on
a card (torch's caching host allocator keeps them for the next call);
the chunk is built on the device, the samples the last scan left moved
over from the other of two device buffers, zeros and the new slot views
uploaded (cplx.from_iq) written after them.  The rows are the same
bits: int8 samples are exact in complex64 wherever they are moved.

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
from dataclasses import dataclass, field

import numpy as np
import torch

from gnss_dsp_tpu_torch.device import refuse_no_pallas, resolve_device
from gnss_dsp_tpu_torch.ops import cplx, nco
from gnss_dsp_tpu_torch.parallel.track import track_scan_sharded
from gnss_dsp_tpu_torch.track import checkpoint
from gnss_dsp_tpu_torch.track.engine import (
    SIGP_COH, SIGP_NOV, TrackParams, init_state, sigp_row, track_scan,
)
from gnss_dsp_tpu_torch.ops.track_step import subc_kind
from gnss_dsp_tpu_torch.track.rows import (  # noqa: F401 (the row formats)
    RowText, format_row_9, format_row_14,
)
from gnss_dsp_tpu_torch.utils import profiling
from gnss_dsp_tpu_torch.utils.twofloat import tf_from_f64


class _Slot:
    """A staging slot: `a`, room for int8 I/Q bytes (a view of its
    reader's staging block); `event`: the CUDA event recorded after the
    last upload from it (None: nothing in flight)."""

    __slots__ = ("a", "event")

    def __init__(self, a: np.ndarray):
        self.a, self.event = a, None

    def wait(self):
        """Return once no upload reads the slot any more."""
        if self.event is not None:
            self.event.synchronize()


def _read_into(fp, a: np.ndarray) -> int:
    """The bytes read into the int8 array a with fp.readinto: as many as
    fill it unless the stream ends first."""
    buf = memoryview(a).cast("B")
    got = 0
    while got < len(buf):
        n = fp.readinto(buf[got:])
        if not n:
            break
        got += n
    return got


class _PrefetchReader:
    """Prefetched host ingest: a worker thread reads the stream ahead,
    each read straight into a staging slot (SLOTS of them, each
    `ahead_samples` samples) with fp.readinto, while the device works on
    the current chunk.  take hands out views of the slots: raw
    interleaved int8 I/Q bytes, converted on the device
    (cplx.from_iq).  uploaded(), once they are uploaded, records a CUDA event
    after the copies and gives the slots wholly taken back to the worker,
    which waits on that event before it reads into one again.

    The slots are cut from one block, on a CUDA device pinned
    (page-locked, so that an upload from it is an asynchronous DMA).
    torch's caching host allocator keeps the pinned block a reader lets
    go of and hands it to the next reader, so a call after the process's
    first pins nothing new (counter `track.pinned.alloc`: the pinned
    blocks that allocator created for a reader).  Where pinning is
    refused the block is a plain array, uploaded as pageable memory, and
    one stderr line says why.  Starting a reader is part of the span
    `track.setup`, take's wait for the worker the span
    `track.read_wait`."""

    SLOTS = 3

    @profiling.span("track.setup")
    def __init__(self, fp, ahead_samples: int, device="cpu"):
        self.fp = fp
        self.dev = torch.device(device)
        self.done = False
        self._slots = self._staging(2 * int(ahead_samples))
        self._free = queue.Queue()         # slots the worker may read into
        for slot in self._slots:
            self._free.put(slot)
        self._filled = queue.Queue()       # (slot, samples), None, error
        self._stop = threading.Event()
        self._cur = None                   # [slot, samples taken, read]
        self._taken, self._spent = [], []  # the last take's slots
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _staging(self, nbytes: int) -> list:
        """SLOTS slots of nbytes each, cut from one block (a numpy view
        of a pinned tensor on a CUDA device, which it keeps alive)."""
        block = None
        if self.dev.type == "cuda":
            torch.cuda.init()                  # else the stats read {}
            made = torch.cuda.host_memory_stats
            before = made().get("num_host_alloc", 0)
            try:
                block = torch.empty(self.SLOTS * nbytes, dtype=torch.int8,
                                    pin_memory=True).numpy()
            except RuntimeError as e:          # cudaHostAlloc refused
                print(f"track: pinning refused ({e}); the staging slots "
                      f"are pageable", file=sys.stderr)
            profiling.count("track.pinned.alloc",
                            made().get("num_host_alloc", 0) - before)
        if block is None:
            block = np.empty(self.SLOTS * nbytes, np.int8)
        return [_Slot(block[k * nbytes:(k + 1) * nbytes])
                for k in range(self.SLOTS)]

    def _worker(self):
        try:
            while True:
                slot = self._free.get()
                if slot is None or self._stop.is_set():
                    return
                slot.wait()
                n = _read_into(self.fp, slot.a)
                if n >= 2:
                    self._filled.put((slot, n // 2))
                if n < len(slot.a):
                    self._filled.put(None)
                    return
        except Exception as e:     # handed to take, which raises it
            self._filled.put(e)

    def take(self, want: int):
        """Views of the slots holding the next up to `want` samples of
        int8 I/Q bytes (short only at EOF), in order: one part, or two
        where they straddle two slots; None when drained.  Nothing is
        copied: the rest of a slot stays there for the next take."""
        if self._taken:
            self.uploaded()
        parts, got = [], 0
        with profiling.span("track.read_wait"):
            while got < want:
                if self._cur is None:
                    if self.done:
                        break
                    item = self._filled.get()
                    if item is None or isinstance(item, Exception):
                        self.done = True
                        if item is None:
                            break
                        raise item
                    self._cur = [item[0], 0, item[1]]
                slot, at, n = self._cur
                k = min(want - got, n - at)
                parts.append(slot.a[2 * at:2 * (at + k)])
                self._taken.append(slot)
                got += k
                if at + k == n:
                    self._spent.append(slot)
                    self._cur = None
                else:
                    self._cur[1] = at + k
        return parts or None

    def uploaded(self):
        """The last take's parts are uploaded (their copies enqueued on
        the device's current stream): record an event after them on a
        CUDA device, and give the slots wholly taken back to the worker,
        which waits on it before reading into one."""
        ev = None
        if self.dev.type == "cuda" and self._taken:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.dev))
        for slot in self._taken:
            slot.event = ev
        for slot in self._spent:
            self._free.put(slot)
        self._taken, self._spent = [], []

    def close(self):
        """Stop the worker and wait for the uploads from the slots, not
        for the worker's read in flight (a pipe may hold it for a chunk,
        or for ever): the worker ends when that read returns.  The
        uploads are waited for because a dropped slot's pinned block goes
        back to torch's host allocator, which has seen no copy from it
        and may hand it out at once."""
        if self._taken:
            self.uploaded()
        self._stop.set()
        self._free.put(None)
        for slot in self._slots:
            slot.wait()


def segment_capacity(fs: float, chunk_ms: float, nmax: int) -> int:
    """Samples a band's segment holds (the reference's receiver.py:
    196-200): the buffered data (chunk + nmax) and a tail margin of nmax,
    rounded up to 1024."""
    cap = int(fs * chunk_ms / 1000.0) + 2 * int(nmax)
    return cap + (-cap) % 1024


class _Chunks:
    """The device chunk x of B band streams, band b's n[b] samples at the
    start of its segment [b * cap, (b + 1) * cap), each band read by its
    own _PrefetchReader.  x is one of two device buffers in turn: refill
    moves the samples each band's channels (band_of) have not passed over
    from the other, upload writes zeros to each segment's end and the new
    bytes after the carried samples, rebase drops what they passed."""

    def __init__(self, fps, band_of, fs: float, chunk_ms: float, nmax: int,
                 dev):
        B = len(fps)
        self.cap = segment_capacity(fs, chunk_ms, nmax)
        self._ahead = int(fs * chunk_ms / 1000.0) + int(nmax)
        self._int4 = bool(os.environ.get("GNSS_DSP_UPLOAD_INT4"))
        self._band_of = np.asarray(band_of, np.int64)
        self._members = [np.flatnonzero(self._band_of == b) for b in range(B)]
        self._bufs = [torch.empty(B * self.cap, dtype=torch.complex64,
                                  device=dev) for _ in range(2)]
        self.x, self._turn = None, 0
        self.n = [0] * B              # each band's samples in x
        self._keep = [0] * B          # of them carried over
        self._used = [0] * B          # the last chunk's passed by all
        self._parts = [None] * B      # the last take's slot views
        self._readers = []
        try:
            for fp in fps:
                self._readers.append(_PrefetchReader(fp, self._ahead, dev))
        except BaseException:
            self.close()
            raise

    @property
    def done(self) -> bool:
        """Every band's stream is drained."""
        return all(r.done for r in self._readers)

    def refill(self) -> bool:
        """Take each band's next bytes and move its carried samples over
        into the next buffer; False when no band has a sample left."""
        with profiling.span("track.refill"):
            prev, self.x = self.x, self._bufs[self._turn % 2]
            self._turn += 1
            for b, r in enumerate(self._readers):
                keep = max(self.n[b] - self._used[b], 0)
                self._parts[b] = r.take(self._ahead - keep)
                self.n[b] = keep + sum(
                    len(p) for p in self._parts[b] or ()) // 2
                self._keep[b] = keep
                if keep:
                    o, u = b * self.cap, self._used[b]
                    self.x[o:o + keep].copy_(prev[o + u:o + u + keep])
        return any(self.n)

    def upload(self) -> int:
        """Zeros after each band's samples, then its new bytes uploaded
        after its carried samples; the bytes uploaded."""
        with profiling.span("track.assemble"):
            for b, n in enumerate(self.n):
                self.x[b * self.cap + n:(b + 1) * self.cap].zero_()
        nbytes = 0
        for b, r in enumerate(self._readers):
            if self._parts[b]:
                o = b * self.cap
                nbytes += cplx.from_iq(
                    self._parts[b], int4=self._int4,
                    into=self.x[o + self._keep[b]:o + self.n[b]])
                r.uploaded()
        return nbytes

    def rebase(self, state):
        """(state, used): each band drops the samples all of its channels
        have passed, used[b] of them, and its channels' pointers move
        back by as many."""
        ptr = state.ptr.cpu().numpy()
        self._used = [max(int(ptr[m].min()) - b * self.cap, 0)
                      for b, m in enumerate(self._members)]
        shift = torch.from_numpy(np.asarray(self._used, np.int32)
                                 [self._band_of])
        return (state._replace(ptr=state.ptr - shift.to(state.ptr.device)),
                self._used)

    def close(self):
        for r in self._readers:
            r.close()


def print_walls(label: str, timed) -> dict:
    """A tracking loop's wall split from its spans (t_read: the refills;
    t_upload: the zeros and the uploads; t_scan: the scans and the rows),
    printed to stderr when GNSS_DSP_TIMING asks for it."""
    walls = dict(t_read=timed.seconds("track.refill"),
                 t_upload=timed.seconds("track.assemble", "upload"),
                 t_scan=timed.seconds("track.scan", "track.rows"))
    if timed.printing:
        print(f"[{label} timing] read-wait {walls['t_read']:.2f} s  "
              f"upload+convert {walls['t_upload']:.2f} s  scan+rows "
              f"{walls['t_scan']:.2f} s", file=sys.stderr)
    return walls


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


@profiling.span("track.setup")
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


@profiling.span("track.setup")
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


@profiling.span("track.rows")
def emit_rows(channels, n_emit, emit, rows_f, rows_i, nb) -> bool:
    """Accumulate the host counters and emit (or keep) each channel's
    rows of a scan, block by block (:505-536); channels from n_emit on
    are clones, computed but never emitted.  True if any channel ran.

    A RowText emit on a card (track/rows) writes the scan's rows as text
    in one go (RowText.scan, formatted there); any other emit, or None,
    takes them one at a time, a dict a row, as does a RowText elsewhere
    or a scan with a field past the fixed-point range.  The span `track.rows`, the rows'
    read-back (and the bulk path's formatting) `track.readback`;
    counters `track.rows.bulk` and `track.rows.each`, the rows each way,
    once a call."""
    if isinstance(emit, RowText):
        got = emit.scan(channels, n_emit, rows_f, rows_i, nb)
        if got is not None:
            return got
    with profiling.span("track.readback"):
        rows_f = rows_f.cpu().numpy()
        rows_i = rows_i.cpu().numpy()
    any_row = False
    each = 0
    for b in range(nb):
        for k, ch in enumerate(channels):
            nn = int(rows_i[b, k, 0])
            if nn == 0:
                continue
            any_row = True
            if k >= n_emit:
                continue
            each += 1
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
    profiling.count("track.rows.each", each)
    return any_row


def _clone(c0):
    return TrackChannel(prn=c0.prn, doppler=c0.doppler,
                        code_offset=c0.code_offset,
                        carrier_phase=c0.carrier_phase,
                        pll_from_start=c0.pll_from_start)


@profiling.span("track.file")
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
    block order per chunk; a track/rows.RowText emit writes each scan's
    rows as text in one go instead (emit_rows).  Returns the channels
    (rows accumulated when emit is None)."""
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

    if preloaded is not None:
        x_dev, n_file = preloaded
        if (resume_from is not None or checkpoint_path is not None
                or mesh is not None or x_dev.shape[0] % 1024
                or x_dev.shape[0] < n_file + params.nmax):
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

    chunks = _Chunks([fp], [0] * C, fs, chunk_ms, params.nmax, dev)
    # GNSS_DSP_TIMING: the reference's wall split of the streaming loop,
    # from its spans at the end (print_walls); the upload synchronised then
    try:
        with profiling.Timing("upload") as timed:
            while chunks.refill():
                nb = setup.blocks_per_scan
                if max_blocks is not None:
                    nb = min(nb, max_blocks - total_blocks)
                    if nb <= 0:
                        break
                chunks.upload()
                state = state._replace(
                    stalled=torch.zeros_like(state.stalled))
                if mesh is not None:
                    state, rows_f, rows_i = track_scan_sharded(
                        mesh, chunks.x, chunks.n[0], setup.code_tab, state,
                        params, nb, **scan)
                else:
                    state, rows_f, rows_i = track_scan(
                        chunks.x, chunks.n[0], setup.code_tab, state,
                        params, nb, **scan)
                emitted_any = emit_rows(channels, n_emit, emit, rows_f,
                                        rows_i, nb)
                total_blocks += nb
                if max_blocks is not None and total_blocks >= max_blocks:
                    break

                state, used = chunks.rebase(state)
                abs_buf0 += used[0]
                if checkpoint_path is not None:
                    # the pointers are relative to the stream sample
                    # abs_buf0, so a resume needs only a seek: no sample
                    # is stored
                    tmp = checkpoint_path + ".tmp"
                    with open(tmp, "wb") as f:
                        checkpoint.save(f, state, channels,
                                        meta={"abs_buf0": abs_buf0,
                                              "total_blocks": total_blocks})
                    os.replace(tmp, checkpoint_path)

                # once drained: no channel ran, or every channel is frozen
                # at the data end (rebasing cannot unstall them)
                if chunks.done and (not emitted_any
                                    or bool(state.stalled.all())):
                    break
    finally:
        chunks.close()
    print_walls("track_file", timed)
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
