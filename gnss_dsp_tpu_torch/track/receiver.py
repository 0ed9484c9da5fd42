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
mix's; the loop constants the first signal's, nmax the largest).  The
chunk is track/driver._Chunks (track_file's is its one-band case): each
band read by its own prefetch thread into its own staging slots, and
built on the device, not on the host as the reference does (:264, 280):
in each segment the samples its channels have not yet passed, moved
over from the other of two device buffers, then zeros to the segment's
end and its new bytes from the slots (one cplx.from_iq a band), written
there.  GNSS_DSP_UPLOAD_INT4 uploads the new bytes as packed 4-bit I/Q
(:283-288).  No recovery, checkpoint or mesh, as in the reference: run
the per-band `track multi` for those.

Not carried: the reference pads the channel list to a multiple of four
with clones of channel 0 (:75-92) so that its TPU kernel's grid steps
hold four channels each.  K2 runs a cluster a channel, and at 11 and 12
channels track_step.cluster_size gives the same 8 CTAs a channel; a
clone runs exactly as channel 0 does, so leaving it out changes neither
a row nor a rebase.

A caller's `stats` dict receives the run's chunks, bytes uploaded a
chunk and the wall split (read wait, upload, scan and rows), which
GNSS_DSP_TIMING=1 prints to stderr at the end (driver.print_walls), as
the reference does.  The walls are the call's spans (utils/profiling):
read wait `track.refill` (the takes and the carried samples), upload
the zeros `track.assemble` with `upload`, scan and rows `track.scan`
with `track.rows`; the call is the span `track.receiver`.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_dsp_tpu_torch.device import refuse_no_pallas, resolve_device
from gnss_dsp_tpu_torch.track.driver import (
    _Chunks, channel_setup, emit_rows, first_boundary, print_walls,
    segment_capacity,
)
from gnss_dsp_tpu_torch.track.engine import init_state, track_scan
from gnss_dsp_tpu_torch.utils import profiling


@profiling.span("track.receiver")
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
    C = len(channels)
    setup = channel_setup(sigs, channels, fs, coffsets, loop_dwells,
                          coherent_blocks, -1, chunk_ms, True, dev)
    params = setup.params
    seg_cap = segment_capacity(fs, chunk_ms, params.nmax)
    ptr0, code_p0 = first_boundary(sigs, channels, fs,
                                   [b * seg_cap for b in band_of])
    state = init_state(
        code_p=code_p0, code_f_off=np.zeros(C),
        carrier_p=np.array([c.carrier_phase for c in channels]),
        carrier_f=np.array([c.doppler for c in channels]),
        ptr=ptr0, device=dev)
    band_t = torch.tensor(band_of, dtype=torch.int64, device=dev)

    info = {} if stats is None else stats
    info.update(chunks=0, upload_bytes=[], seg_cap=seg_cap)
    total_blocks = 0
    chunks = _Chunks([fp for fp, *_ in bands], band_of, fs, chunk_ms,
                     params.nmax, dev)
    try:
        # the walls (GNSS_DSP_TIMING's line, the caller's stats) are the
        # loop's spans; the upload synchronised only while the line prints
        with profiling.Timing("upload", keep=stats is not None) as timed:
            while chunks.refill():
                nb = setup.blocks_per_scan
                if max_blocks is not None:
                    nb = min(nb, max_blocks - total_blocks)
                    if nb <= 0:
                        break
                info["upload_bytes"].append(chunks.upload())
                # each channel's chunk_len: its band's segment end
                chunk_end = torch.tensor(
                    [b * seg_cap + n for b, n in enumerate(chunks.n)],
                    dtype=torch.int32, device=dev)[band_t]
                state = state._replace(
                    stalled=torch.zeros_like(state.stalled))
                state, rows_f, rows_i = track_scan(
                    chunks.x, chunk_end, setup.code_tab, state, params, nb,
                    ratios=setup.ratios, coffset_df=setup.coffset_df,
                    sigp=setup.sigp, overlay=setup.overlay)
                emitted_any = emit_rows(channels, C, emit, rows_f, rows_i,
                                        nb)
                info["chunks"] += 1
                total_blocks += nb
                if max_blocks is not None and total_blocks >= max_blocks:
                    break

                state, _used = chunks.rebase(state)
                if chunks.done and (not emitted_any
                                    or bool(state.stalled.all())):
                    break
    finally:
        chunks.close()
    info.update(print_walls("track_receiver", timed))
    return channels
