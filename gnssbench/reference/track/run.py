"""The plain reference of a tracking pass: every channel of every band
tracked over the whole capture in one chunk by the frozen plain scan.

The bands' streams sit one after another in one chunk, each in its own
segment with a tail margin (as the multi-band receiver packs a chunk),
each channel pointing into its band's segment; a single-band pass is one
segment.  The set-up (parameters, sigp rows, code rows, carrier-aiding
ratios, carrier-offset increments, first code boundaries) is worked out
from the frozen catalog and the channel specs by the frozen set-up.
Rows come back per channel as the blocks the channel ran: float32 [m,
11] and int32 [m, 3] (the per-block fields before any host counter).

On the card the frozen scan's steps are replayed from a CUDA graph of
GRAPH_STEPS steps (`scan`): the same kernels on the same operands in the
same order, so the same bits, without the host's launch of each of the
~600 small operations a step.
"""

from __future__ import annotations

import numpy as np
import torch

from gnssbench.reference.models import get_signal
from gnssbench.reference.track import engine
from gnssbench.reference.track.setup import (
    TrackChannel, channel_setup, first_boundary)


def track_pass(bands, fs: float, mixed: bool, device,
               loop_dwells=(500, 500), sum_dtype=torch.float64):
    """bands: [(raw int8 I/Q bytes of the band, [channel dicts with
    signal, prn, doppler, code_phase, coffset])].  mixed: the set-up of a
    mixed-signal scan (the receiver's, `track multi`'s), else one
    signal's.  Returns [(rows_f, rows_i)] per channel, band by band."""
    sigs, chans, coffs, band_of = [], [], [], []
    for b, (_raw, chs) in enumerate(bands):
        for c in chs:
            sigs.append(get_signal(c["signal"]))
            chans.append(TrackChannel(prn=int(c["prn"]),
                                      doppler=float(c["doppler"]),
                                      code_offset=float(c["code_phase"])))
            coffs.append(float(c["coffset"]))
            band_of.append(b)
    lens = [len(raw) // 2 for raw, _c in bands]
    capture_ms = 1000.0 * max(lens) / fs
    setup = channel_setup(sigs, chans, fs, coffs, loop_dwells, 1, -1,
                          capture_ms, mixed, device)
    p = setup.params
    seg = [n + 2 * p.nmax + (-(n + 2 * p.nmax)) % 1024 for n in lens]
    off = np.concatenate([[0], np.cumsum(seg)[:-1]]).astype(np.int64)
    x = torch.zeros(int(sum(seg)), dtype=torch.complex64, device=device)
    for b, (raw, _c) in enumerate(bands):
        v = torch.from_numpy(np.asarray(raw, np.int8).reshape(-1, 2).copy())
        v = v.to(device).to(torch.float32)
        x[off[b]:off[b] + lens[b]] = torch.complex(v[:, 0], v[:, 1])
    ptr0, code_p0 = first_boundary(sigs, chans, fs,
                                   [int(off[b]) for b in band_of])
    state = engine.init_state(
        code_p=code_p0, code_f_off=np.zeros(len(chans)),
        carrier_p=np.array([c.carrier_phase for c in chans]),
        carrier_f=np.array([c.doppler for c in chans]), ptr=ptr0,
        device=device)
    chunk_len = torch.tensor([int(off[b]) + lens[b] for b in band_of],
                             dtype=torch.int32)
    args, overlay = engine.scan_args(
        x, chunk_len, setup.code_tab, state, p, setup.blocks_per_scan,
        setup.ratios, setup.coffset_df, setup.sigp, setup.overlay)
    _st, rows_f, rows_i = scan(*args, overlay, sum_dtype=sum_dtype)
    return per_channel(rows_f.cpu().numpy(), rows_i.cpu().numpy())


GRAPH_STEPS = 32


def scan(x, chunk_len, code_tab, state, params, n_blocks: int, ratios,
         coffset_df, sigp, overlay=None, sum_dtype=torch.float64):
    """engine.track_scan_plain's result.  On the card (recovery off) its
    loop runs as engine._scan runs it, a step's body replayed from a
    CUDA graph of GRAPH_STEPS steps: the first 31 steps, then a graph
    at a time, each after the loop's look (before every step b with b %
    32 == 31) for all channels stalled, then the rest of the steps; once
    all have stalled, NaN / 0 rows as engine._scan fills them."""
    if x.device.type != "cuda" or params.recover_after >= 0:
        return engine.track_scan_plain(
            x, chunk_len, code_tab, state, params, n_blocks, ratios,
            coffset_df, sigp, overlay, sum_dtype=sum_dtype)
    correlate = engine.plain_correlate(params, sum_dtype)
    coh = params.coh_blocks > 1
    if coh and overlay is None:
        overlay = torch.ones((state.ptr.shape[0], 1), device=x.device)
    lens = engine.code_lens(code_tab, sigp)

    def step(st):
        si, sf, n, sj, nfull, ok, cf_dyn = engine._geometry(
            x.shape[0], chunk_len, ratios, st, params, coffset_df, sigp)
        sums = (correlate(si, sf, x, code_tab) if lens is None
                else correlate(si, sf, x, code_tab, lens))
        pe, pp, pl = ((sums[:, k], sums[:, k + 1]) for k in (0, 2, 4))
        s_ovl = engine.overlay_chip(overlay, st.block, sigp) if coh else None
        return engine._post_block(pe, pp, pl, n, sj, nfull, ok, cf_dyn, st,
                                  params, coffset_df, sigp, s_ovl)

    def steps(st, k):
        rf, ri = [], []
        for _ in range(k):
            st, f, i = step(st)
            rf.append(f)
            ri.append(i)
        return st, rf, ri

    head = min(GRAPH_STEPS - 1, n_blocks)
    st, rows_f, rows_i = steps(state, head)
    b = head
    graph = None
    while b < n_blocks and not bool(st.stalled.all()):
        if n_blocks - b < GRAPH_STEPS:
            st, f, i = steps(st, n_blocks - b)
            rows_f += f
            rows_i += i
            b = n_blocks
            break
        if graph is None:
            static = engine.TrackState(*(t.clone() for t in st))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):      # lazy set-up off the graph
                steps(engine.TrackState(*(t.clone() for t in st)), 1)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                g_st, g_f, g_i = steps(static, GRAPH_STEPS)
                g_f, g_i = torch.stack(g_f), torch.stack(g_i)
        for dst, src in zip(static, st):
            dst.copy_(src)
        graph.replay()
        st = engine.TrackState(*(t.clone() for t in g_st))
        rows_f += list(g_f.clone())
        rows_i += list(g_i.clone())
        b += GRAPH_STEPS
    C, dev = st.ptr.shape[0], x.device
    for _ in range(n_blocks - len(rows_f)):
        rows_f.append(torch.full((C, 11), float("nan"), device=dev))
        rows_i.append(torch.zeros((C, 3), dtype=torch.int32, device=dev))
    if not rows_f:
        return st, torch.zeros((0, C, 11), device=dev), torch.zeros(
            (0, C, 3), dtype=torch.int32, device=dev)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def per_channel(rows_f: np.ndarray, rows_i: np.ndarray):
    """[(rows_f [m, 11], rows_i [m, 3])] per channel of scan rows
    [nb, C, 11] and [nb, C, 3]: the blocks the channel ran (n != 0)."""
    out = []
    for c in range(rows_i.shape[1]):
        ran = rows_i[:, c, 0] != 0
        out.append((rows_f[ran, c], rows_i[ran, c]))
    return out


def rows_differ(got, want) -> int:
    """Rows of `got` that differ from `want` in any bit, channel by
    channel, plus the rows either has beyond the other."""
    bad = 0
    if len(got) != len(want):
        return max(sum(len(f) for f, _i in got),
                   sum(len(f) for f, _i in want))
    for (gf, gi), (wf, wi) in zip(got, want):
        m = min(len(gf), len(wf))
        same = ((gf[:m].view(np.int32) == wf[:m].view(np.int32)).all(1)
                & (gi[:m] == wi[:m]).all(1))
        bad += int((~same).sum()) + abs(len(gf) - len(wf))
    return bad
