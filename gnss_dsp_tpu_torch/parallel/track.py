"""Channel-sharded tracking: the channels split over the mesh's sat axis.

Counterpart: gnss_dsp_tpu/parallel/track.py:28-144 (`track_scan_sharded`).
Tracking runs sequentially in time, so channels are the axis that
shards, with no collective in the loop.  Each sat shard's channels run
once, on the device at (s, 0): the JAX package keeps copies across the
time axis that compute the same values.  The chunk is copied once to
each distinct device; the per-channel state, code table, ratios,
carrier-offset increments, sigp lanes and overlay rows go with their
channels; the rows come back concatenated in channel order, on the
chunk's device.

Each shard is one track_scan on its device: on a card, kernel K2 where
params.fused_scan holds (its cluster_plan picks the cluster size for the
shard's channel count; K2's rows do not depend on it), else K3 or K4 a
block; on the CPU the plain loop.  The reference sends a sharded scan
that does not take K2 to its XLA correlator (:66-69) only because a
pallas_call has no partitioning rule under shard_map; K3 and K4 have no
such limit here, and their rows equal the plain correlator's.  The
sharded rows and state equal the unsharded scan's bit for bit.

multihost=True: each rank runs the sat shards whose (s, 0) device is its
own, and the rows and state are gathered with all_gather_object, so every
rank returns the same values.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gnss_dsp_tpu_torch.track.engine import TrackState, scan_args, track_scan
from gnss_dsp_tpu_torch.utils import profiling


@profiling.span("track.scan")
def track_scan_sharded(mesh, x_chunk: torch.Tensor, chunk_len, code_tab,
                       state: TrackState, params, n_blocks: int, ratios=None,
                       coffset_df=None, sigp=None, overlay=None,
                       multihost: bool = False):
    """track_scan with the C channels split over mesh.shape["sat"] (C a
    multiple of it).  Arguments and returns as track_scan's; the results
    lie on x_chunk's device.  The span `track.scan`, as track_scan's."""
    args, overlay = scan_args(x_chunk, chunk_len, code_tab, state, params,
                              n_blocks, ratios, coffset_df, sigp, overlay)
    x_chunk, chunk_len, code_tab, state, params, n_blocks = args[:6]
    ratios, coffset_df, sigp = args[6:]
    C = state.ptr.shape[0]
    nsat = mesh.shape["sat"]
    if C % nsat:
        raise ValueError(f"{C} channels do not split over {nsat} sat shards")
    Cl = C // nsat
    home = x_chunk.device
    xs, outs = {}, {}
    for s in range(nsat):
        if not mesh.local(s, 0):
            continue
        dev = mesh.devices[s, 0]
        if dev not in xs:
            xs[dev] = x_chunk.to(dev)
        sl = slice(s * Cl, (s + 1) * Cl)
        shard = (xs[dev], chunk_len[sl].to(dev), code_tab[sl].to(dev),
                 TrackState(*(leaf[sl].to(dev) for leaf in state)), params,
                 n_blocks, ratios[sl].to(dev), coffset_df[sl].to(dev),
                 sigp[sl].to(dev))
        ovl = None if overlay is None else overlay[sl].to(dev)
        outs[s] = track_scan(*shard, overlay=ovl)
    if multihost:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, {s: _to(o, torch.device("cpu"))
                                       for s, o in outs.items()})
        for part in every:
            for s, o in part.items():
                outs.setdefault(s, o)
    outs = [_to(outs[s], home) for s in range(nsat)]
    st = TrackState(*(torch.cat([o[0][k] for o in outs])
                      for k in range(len(TrackState._fields))))
    return (st, torch.cat([o[1] for o in outs], dim=1),
            torch.cat([o[2] for o in outs], dim=1))


def _to(out, dev):
    st, rf, ri = out
    return TrackState(*(leaf.to(dev) for leaf in st)), rf.to(dev), ri.to(dev)
