"""Sharded acquisition: the PRN x doppler x code-phase search over a
(sat, time) mesh (parallel/mesh).

Counterpart: gnss_dsp_tpu/parallel/acquire.py (`grid_search_sharded`
:44-139, `acquire_signal_sharded` :160-257).  The PRNs shard over `sat`
(each shard searches its slice of the code spectra), the non-coherent
blocks over `time` (each shard sums |.| over its own block windows);
the one cross-shard term is the sum of the time shards' surfaces, the
reference's psum.  Here it is a sum in time-shard order on the sat row's
first device, so it gives the same bits every run; then, per PRN, the max,
first argmax and mean over the lags, the valid mask and the running best
over doppler chunks (:97-115).

Each shard runs the route of acquire/plan.mesh_plan on its device: at the
2n window of the pad2 and sliding signals, K1's natural-order surface
(ops/acquire2, reduce=False) on v2 and K7 (ops/acquire) on v1, their plain
version on a CPU device (acquire/engine.surface).  The samples are copied
once to each distinct device.

multihost=True runs the same search over the ranks of a torch.distributed
group (parallel/mesh.init_multihost): each rank runs its own shards; where
a sat row's time shards cross ranks their sums meet by all_reduce in a
group per such row (through host memory on gloo); the per-PRN results are
gathered with all_gather_object, so every rank returns the same list.

Not ported here: the FDMA twin (:260-337) and the serial twin (:340-387),
which wait for their single-device modules.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gnss_dsp_tpu_torch.acquire import engine
from gnss_dsp_tpu_torch.acquire.plan import mesh_plan
from gnss_dsp_tpu_torch.device import refuse_switches
from gnss_dsp_tpu_torch.parallel.mesh import rank_group, this_rank


def _row_groups(mesh, multihost: bool) -> dict:
    """{sat row: process group} for the rows whose time shards run on
    more than one rank; every rank asks for every group, in row order
    (parallel/mesh.rank_group makes each once a job)."""
    groups = {}
    if not multihost:
        return groups
    for s in range(mesh.shape["sat"]):
        ranks = {int(r) for r in mesh.ranks[s]}
        if len(ranks) > 1:
            groups[s] = rank_group(ranks)
    return groups


def _all_reduce(q: torch.Tensor, group) -> torch.Tensor:
    if dist.get_backend(group) == "gloo" and q.device.type != "cpu":
        host = q.cpu()
        dist.all_reduce(host, group=group)
        return host.to(q.device)
    dist.all_reduce(q, group=group)
    return q


def mesh_dop_chunk(Pl: int, window: int, D: int) -> int:
    """Dopplers per surface call: the reference's sizing of a fused
    chunk, the [Pl, dc, W] surfaces (and the sum's twin) of a shard
    within about 1.2 GB (:189-198)."""
    return int(np.clip(1.2e9 // (Pl * window * 16), 1, D))


def grid_search_sharded(x: torch.Tensor, code_ffts: torch.Tensor,
                        dopp_fixed, dopp_valid, n: int, window: int,
                        blocks: int, peak_mean: bool, dop_chunk: int, mesh,
                        route: str, multihost: bool = False):
    """Search the full grid over `mesh`; returns per-PRN (metric f32 [P],
    code_idx i32 [P], dop_idx i64 [P]) as numpy arrays.

    x          : complex64 [>= (blocks-1)*n + window] internal-rate samples
                 (any device; copied to the shards' devices)
    code_ffts  : complex64 [P, window] natural-order code spectra,
                 P % mesh.shape["sat"] == 0
    dopp_fixed : int [D] per-sample NCO increments
    dopp_valid : bool [D] shared by every PRN, or [P, D] per PRN
    route      : "v2" (K1's surface) or "v1" (K7), acquire/plan.mesh_plan
    dop_chunk  : dopplers per surface call"""
    nsat, ntime = mesh.shape["sat"], mesh.shape["time"]
    P = code_ffts.shape[0]
    if P % nsat:
        raise ValueError(f"{P} PRNs do not split over {nsat} sat shards")
    Pl = P // nsat
    dopp_fixed = torch.as_tensor(np.asarray(dopp_fixed), dtype=torch.int64)
    valid = torch.as_tensor(np.asarray(dopp_valid), dtype=torch.bool)
    D = int(dopp_fixed.shape[0])
    groups = _row_groups(mesh, multihost)
    me = this_rank()

    # this process's shards: block windows and code spectra on their device
    xs, xb, cf = {}, {}, {}
    for s in range(nsat):
        for t in range(ntime):
            if not mesh.local(s, t):
                continue
            dev = mesh.devices[s, t]
            if dev not in xs:
                xs[dev] = x.to(dev)
            xb[s, t] = engine.shard_block_windows(xs[dev], n, window, blocks,
                                                  t, ntime)
            cf[s, t] = code_ffts[s * Pl:(s + 1) * Pl].to(dev)
    rows = sorted({s for s, _ in xb})
    best = {}
    for s in rows:
        dev = next(mesh.devices[s, t] for t in range(ntime)
                   if (s, t) in xb)
        best[s] = (torch.full((Pl,), -float("inf"), device=dev),
                   torch.zeros((Pl,), dtype=torch.int32, device=dev),
                   torch.zeros((Pl,), dtype=torch.int64, device=dev))
    for d0 in range(0, D, dop_chunk):
        df = dopp_fixed[d0:d0 + dop_chunk]
        vc = valid[..., d0:d0 + dop_chunk]
        for s in rows:
            q = None
            for t in range(ntime):      # the time shards' sum, in order
                if (s, t) not in xb:
                    continue
                dev = mesh.devices[s, t]
                qt = engine.surface(engine.mix_fft(xb[s, t], df.to(dev)),
                                    cf[s, t], route)
                q = qt if q is None else q + qt.to(q.device)
            if s in groups:
                q = _all_reduce(q, groups[s])
            metric, code_idx = engine.surface_metric(q, peak_mean)
            v = (vc[s * Pl:(s + 1) * Pl] if vc.dim() == 2 else vc[None, :])
            metric = torch.where(v.to(q.device), metric, -float("inf"))
            ch_best = torch.argmax(metric, dim=-1)             # first max
            ch_metric = torch.gather(metric, 1, ch_best[:, None])[:, 0]
            ch_code = torch.gather(code_idx, 1, ch_best[:, None])[:, 0]
            bm, bc, bd = best[s]
            upd = ch_metric > bm
            best[s] = (torch.where(upd, ch_metric, bm),
                       torch.where(upd, ch_code, bc),
                       torch.where(upd, ch_best + d0, bd))
    # each sat row's results from the rank of its first shard
    mine = {s: tuple(v.cpu().numpy() for v in best[s]) for s in rows
            if int(mesh.ranks[s, 0]) == me}
    if multihost:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        for part in every:
            mine.update(part)
    return tuple(np.concatenate([mine[s][k] for s in range(nsat)])
                 for k in range(3))


def acquire_signal_sharded(sig, x_int: torch.Tensor, prns, mesh,
                           doppler_search=None, ms: int = 80,
                           dop_chunk: int | None = None,
                           multihost: bool = False) -> list:
    """Mesh-parallel twin of acquire/engine.acquire_signal.

    Pads the PRN list to a multiple of the sat-axis size with copies of
    its first PRN (their results are dropped).  x_int: complex64
    internal-rate samples covering >= ms+2 ms, on any device (every rank
    passes the same samples when multihost).  Returns list[AcqResult] in
    PRN order.  Refuses the reference's route switches, and FDMA and
    serial searches, as acquire_signal does."""
    refuse_switches("acquire_signal_sharded",
                    ("GNSS_DSP_NO_PALLAS", "GNSS_DSP_NO_V2P"))
    if sig.fdma_hz or sig.acq_serial:
        raise NotImplementedError(
            f"{sig.name}: the sharded FDMA and serial searches are not "
            "ported yet")
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    route, window = mesh_plan(sig)
    blocks = engine._block_count(sig, ms)
    dops, fixed = engine.doppler_grid(sig, doppler_search)
    nsat = mesh.shape["sat"]
    prns_pad = list(prns) + [prns[0]] * ((-len(prns)) % nsat)
    if dop_chunk is None:
        dop_chunk = mesh_dop_chunk(len(prns_pad) // nsat, window, len(dops))
    code_ffts = engine.device_code_ffts(sig, prns_pad, n, window,
                                        x_int.device, route)
    metric, code_idx, dop_idx = grid_search_sharded(
        x_int, code_ffts, fixed.astype(np.int64), np.ones(len(dops), bool),
        n=n, window=window, blocks=blocks,
        peak_mean=(sig.acq_metric == "peak_mean"), dop_chunk=dop_chunk,
        mesh=mesh, route=route, multihost=multihost)
    out = []
    for i, prn in enumerate(prns):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(engine.AcqResult(
            prn=prn, doppler=float(dops[dop_idx[i]]),
            metric=float(metric[i]), code_offset=code))
    return out
