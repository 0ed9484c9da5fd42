"""The single-program multi-band receiver: every channel of every band
in one scan a chunk.

Counterpart: gnss_dsp_tpu/track/receiver.py:47-331 (`track_receiver`).
Each band's int8 stream is packed into its own fixed-capacity segment of
one device chunk (:196-200), and each channel carries its band's segment
end as its own chunk_len (track_scan takes chunk_len [C]); its pointer
starts in its band's segment and moves within it.  So the 2017 sky's 11
channels over L1, L2 and L5 run as one launch of kernel K2 a chunk on
the card (11 clusters), where three `track multi` programs would run
three.  After each chunk every band drops the samples all of its
channels have passed and its channels' pointers move back by as many
(:308-318).  The segment capacity is rounded up to 1024 samples as in
the reference, which moves absolute pointers only, never a row.

The setup is track/driver.track_file's for mixed signals
(driver.channel_setup: each channel's own sigp row, code row, ratio,
carrier offset and coherent span; the launch's subcarrier kind the
mix's; the loop constants the first signal's, nmax the largest).  Every
band is read by its own prefetch thread; GNSS_DSP_UPLOAD_INT4 uploads
each chunk as packed 4-bit I/Q (:283-288).  No recovery, checkpoint or
mesh, as in the reference: run the per-band `track multi` for those.

Not carried: the reference pads the channel list to a multiple of four
with clones of channel 0 (:75-92) so that its TPU kernel's grid steps
hold four channels each.  K2 runs a cluster a channel, and at 11 and 12
channels track_step.cluster_size gives the same 8 CTAs a channel; a
clone runs exactly as channel 0 does, so leaving it out changes neither
a row nor a rebase.

A caller's `stats` dict receives the run's chunks, bytes uploaded a
chunk and the wall split (read wait, upload, scan and rows), which
GNSS_DSP_TIMING=1 prints to stderr at the end, as the reference does.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from gnss_dsp_tpu_torch.device import refuse_no_pallas, resolve_device
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.track.driver import (
    _PrefetchReader, channel_setup, emit_rows, first_boundary,
)
from gnss_dsp_tpu_torch.track.engine import init_state, track_scan


def segment_capacity(fs: float, chunk_ms: float, nmax: int) -> int:
    """Samples a band's segment holds (:196-200): the buffered data
    (chunk + nmax) and a tail margin of nmax, rounded up to 1024."""
    cap = int(fs * chunk_ms / 1000.0) + 2 * int(nmax)
    return cap + (-cap) % 1024


def track_receiver(bands, fs: float, loop_dwells=(500, 500),
                   chunk_ms: float = 2000.0, emit=None,
                   max_blocks: int | None = None, coherent_blocks: int = 1,
                   device="cuda", stats: dict | None = None):
    """Track every channel of every band in one scan a chunk on `device`
    (the card unless the caller asks for the CPU).

    bands: list of (fp, sigs, channels, coffsets), one per band stream
    (fp a binary int8 I/Q stream; sigs, channels and coffsets one per
    channel, as track_file's mixed mode takes them); every band at the
    sample rate fs.  coherent_blocks: each channel's coherent span, as
    track_file's (-1: each signal's own overlay length).

    emit(global_channel_index, row) as in track_file, the channels
    numbered band by band; returns that flat channel list (rows
    accumulated on the channels when emit is None).  stats: a dict that
    receives chunks, upload_bytes (a list, one a chunk), seg_cap and the
    walls t_read, t_upload, t_scan in seconds."""
    sigs, channels, coffsets, band_of = [], [], [], []
    for b, (_fp, bs, bc, bco) in enumerate(bands):
        if not len(bs) == len(bc) == len(bco):
            raise ValueError(f"band {b}: one signal, channel and carrier "
                             f"offset a channel")
        sigs += list(bs)
        channels += list(bc)
        coffsets += list(bco)
        band_of += [b] * len(bc)
    refuse_no_pallas("track_receiver", device)
    dev = resolve_device(device)
    B, C = len(bands), len(channels)
    setup = channel_setup(sigs, channels, fs, coffsets, loop_dwells,
                          coherent_blocks, -1, chunk_ms, True, dev)
    params = setup.params
    chunk_samples = int(fs * chunk_ms / 1000.0)
    seg_cap = segment_capacity(fs, chunk_ms, params.nmax)
    seg_off = [b * seg_cap for b in range(B)]
    ptr0, code_p0 = first_boundary(sigs, channels, fs,
                                   [seg_off[b] for b in band_of])
    state = init_state(
        code_p=code_p0, code_f_off=np.zeros(C),
        carrier_p=np.array([c.carrier_phase for c in channels]),
        carrier_f=np.array([c.doppler for c in channels]),
        ptr=ptr0, device=dev)
    members = [[k for k in range(C) if band_of[k] == b] for b in range(B)]
    band_t = torch.tensor(band_of, dtype=torch.int64, device=dev)
    seg_t = torch.tensor(seg_off, dtype=torch.int32, device=dev)

    int4 = bool(os.environ.get("GNSS_DSP_UPLOAD_INT4"))
    timing = bool(os.environ.get("GNSS_DSP_TIMING"))
    readers = [_PrefetchReader(fp, chunk_samples + params.nmax)
               for fp, *_ in bands]
    bufs = [np.zeros(0, np.int8) for _ in range(B)]
    info = {} if stats is None else stats
    info.update(chunks=0, upload_bytes=[], t_read=0.0, t_upload=0.0,
               t_scan=0.0, seg_cap=seg_cap)
    total_blocks = 0
    while True:
        t0 = time.perf_counter()
        nbufs = []
        for b in range(B):
            want = chunk_samples + params.nmax - len(bufs[b]) // 2
            if want > 0:
                xx = readers[b].take(want)
                if xx is not None and len(xx):
                    bufs[b] = np.concatenate([bufs[b], xx])
            nbufs.append(len(bufs[b]) // 2)
        if not any(nbufs):
            break
        info["t_read"] += time.perf_counter() - t0
        nb = setup.blocks_per_scan
        if max_blocks is not None:
            nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break

        # the segmented chunk: band b's bytes at its offset, zeros after
        # them (0.0 samples on the device)
        t0 = time.perf_counter()
        assembled = np.zeros(2 * B * seg_cap, np.int8)
        for b in range(B):
            assembled[2 * seg_off[b]:2 * seg_off[b] + len(bufs[b])] = bufs[b]
        x_dev, nbytes = cplx.from_iq(assembled, device=dev, int4=int4)
        chunk_end = seg_t[band_t] + torch.tensor(
            nbufs, dtype=torch.int32, device=dev)[band_t]
        if timing and dev.type == "cuda":
            torch.cuda.synchronize(dev)      # the upload's end
        info["t_upload"] += time.perf_counter() - t0
        info["upload_bytes"].append(nbytes)
        t0 = time.perf_counter()
        state = state._replace(stalled=torch.zeros_like(state.stalled))
        state, rows_f, rows_i = track_scan(
            x_dev, chunk_end, setup.code_tab, state, params, nb,
            ratios=setup.ratios, coffset_df=setup.coffset_df,
            sigp=setup.sigp, overlay=setup.overlay)
        emitted_any = emit_rows(channels, C, emit, rows_f, rows_i, nb)
        info["t_scan"] += time.perf_counter() - t0
        info["chunks"] += 1
        total_blocks += nb
        if max_blocks is not None and total_blocks >= max_blocks:
            break

        # each band drops the samples all of its channels have passed
        ptrs = state.ptr.cpu().numpy()
        shift = np.zeros(C, np.int32)
        for b in range(B):
            consumed = max(int(ptrs[members[b]].min()) - seg_off[b], 0)
            bufs[b] = bufs[b][2 * consumed:]
            shift[members[b]] = consumed
        state = state._replace(
            ptr=state.ptr - torch.from_numpy(shift).to(dev))

        done = all(r.done for r in readers)
        if done and not emitted_any:
            break
        if done and bool(state.stalled.all()):
            break
    if timing:
        print(f"[track_receiver timing] read-wait {info['t_read']:.2f} s  "
              f"upload+convert {info['t_upload']:.2f} s  scan+rows "
              f"{info['t_scan']:.2f} s", file=sys.stderr)
    return channels
