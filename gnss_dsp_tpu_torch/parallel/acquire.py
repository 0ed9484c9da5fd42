"""Sharded acquisition: the PRN x doppler x code-phase search over a
(sat, time) mesh (parallel/mesh).

Counterpart: gnss_dsp_tpu/parallel/acquire.py (`grid_search_sharded`
:44-139, `acquire_signal_sharded` :160-257, `acquire_signal_fdma_sharded`
:260-337, `serial_search_sharded` :340-387).  The PRNs shard over `sat`
(each shard searches its slice of the code spectra), the non-coherent
blocks over `time` (each shard sums |.| over its own block windows);
the one cross-shard term is the sum of the time shards' surfaces, the
reference's psum.  Here it is a sum in time-shard order on the sat row's
first device, so it gives the same bits every run; then, per PRN, the max,
first argmax and mean over the lags, and the first maximum over the
dopplers (engine.band_best; the reference's masked running best over
doppler chunks, :97-115, gives the same cell).  In place of the
reference's validity mask each sat row may take its own increments.

Each shard runs the route of acquire/plan.mesh_plan on its device: at the
2n window of the pad2 and sliding signals, K1's natural-order surface
(ops/acquire2, reduce=False) on v2 and K7 (ops/acquire) on v1, their plain
version on a CPU device (acquire/engine.surface), and under
GNSS_DSP_NO_PALLAS the plain version (route "xla", the reference's XLA
engine a shard) on a mesh of CPU shards; a mesh with a card refuses the
switch (device.refuse_no_pallas).  GNSS_DSP_NO_V2P moves nothing: the sharded search has
no padded route, as in the reference.  The samples are copied
once to each distinct device.

multihost=True runs the same search over the ranks of a torch.distributed
group (parallel/mesh.init_multihost): each rank runs its own shards; where
a sat row's time shards cross ranks their sums meet by all_reduce in a
group per such row (through host memory on gloo); the per-PRN results are
gathered with all_gather_object, so every rank returns the same list.

The FDMA twin shards the channels over `sat`: each sat row searches the
one shared code row against its own channels' bands only, and reduces
each band to its first maximum, as acquire/engine.acquire_signal_fdma.
The serial twin splits the hypotheses over every shard; each computes
its q slice with acquire/serial.py and the host takes the maximum.  Both
take multihost=True as the search does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gnss_dsp_tpu_torch.acquire import engine, serial
from gnss_dsp_tpu_torch.acquire.plan import mesh_plan
from gnss_dsp_tpu_torch.device import refuse_no_pallas
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


def _shards(x, mesh, n, window, blocks):
    """This process's shards: {(s, t): [B_local, W] block windows} on
    their devices (the samples copied once to each distinct device)."""
    nsat, ntime = mesh.shape["sat"], mesh.shape["time"]
    xs, xb = {}, {}
    for s in range(nsat):
        for t in range(ntime):
            if not mesh.local(s, t):
                continue
            dev = mesh.devices[s, t]
            if dev not in xs:
                xs[dev] = x.to(dev)
            xb[s, t] = engine.shard_block_windows(xs[dev], n, window, blocks,
                                                  t, ntime)
    return xb


def _row_metrics(x, row_codes, row_fixed, n, window, blocks, peak_mean,
                 dop_chunk, mesh, route, multihost):
    """Yields (s, d0, metric f32 [Pl, dc], code_idx i32 [Pl, dc]) for each
    sat row s that runs in this process and each chunk of its dopplers
    row_fixed[s] (int64 [Dr], every row as long) from d0 on: the surfaces
    of its time shards against its code spectra row_codes[s] (complex64
    [Pl, W]), summed in time-shard order (across ranks by all_reduce),
    then the first maximum over the lags, over the mean when peak_mean."""
    ntime = mesh.shape["time"]
    groups = _row_groups(mesh, multihost)
    xb = _shards(x, mesh, n, window, blocks)
    cf = {(s, t): row_codes[s].to(mesh.devices[s, t]) for s, t in xb}
    rows = sorted({s for s, _ in xb})
    Dr = int(row_fixed[0].shape[0])
    for d0 in range(0, Dr, dop_chunk):
        for s in rows:
            q = None
            for t in range(ntime):      # the time shards' sum, in order
                if (s, t) not in xb:
                    continue
                dev = mesh.devices[s, t]
                df = row_fixed[s][d0:d0 + dop_chunk].to(dev)
                qt = engine.surface(engine.mix_fft(xb[s, t], df), cf[s, t],
                                    route)
                q = qt if q is None else q + qt.to(q.device)
            if s in groups:
                q = _all_reduce(q, groups[s])
            metric, code_idx = engine.surface_metric(q, peak_mean)
            yield s, d0, metric, code_idx


def _gather_rows(mesh, rows: dict, multihost: bool) -> tuple:
    """{sat row: tuple of numpy arrays} of the rows this process reduced
    -> each array concatenated over every row in order; each row's from
    the rank of its first shard, across ranks by all_gather_object."""
    me = this_rank()
    mine = {s: v for s, v in rows.items() if int(mesh.ranks[s, 0]) == me}
    if multihost:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        for part in every:
            mine.update(part)
    return tuple(np.concatenate([mine[s][k] for s in range(mesh.shape["sat"])])
                 for k in range(len(mine[0])))


def grid_search_sharded(x: torch.Tensor, code_ffts: torch.Tensor,
                        dopp_fixed, n: int, window: int, blocks: int,
                        peak_mean: bool, dop_chunk: int, mesh, route: str,
                        multihost: bool = False, group: int | None = None):
    """Search the full grid over `mesh`; returns per code row (metric f32
    [P, G], code_idx i32 [P, G], dop_idx i64 [P, G]) numpy arrays: the
    first maximum of each of the G groups of a row's dopplers
    (engine.band_best, dop_idx within the group).

    x          : complex64 [>= (blocks-1)*n + window] internal-rate samples
                 (any device; copied to the shards' devices)
    code_ffts  : complex64 [P, window] natural-order code spectra,
                 P % mesh.shape["sat"] == 0; sat row s searches its slice
    dopp_fixed : int [D] per-sample NCO increments of every sat row, or
                 int [nsat, D], each sat row's own
    route      : "v2" (K1's surface) or "v1" (K7), acquire/plan.mesh_plan
    dop_chunk  : dopplers per surface call
    group      : dopplers per group (default D: one group a row)"""
    nsat = mesh.shape["sat"]
    P = code_ffts.shape[0]
    if P % nsat:
        raise ValueError(f"{P} PRNs do not split over {nsat} sat shards")
    Pl = P // nsat
    fixed = torch.as_tensor(np.asarray(dopp_fixed), dtype=torch.int64)
    row_fixed = list(fixed) if fixed.dim() == 2 else [fixed] * nsat
    parts = {}
    for s, _, metric, code_idx in _row_metrics(
            x, [code_ffts[s * Pl:(s + 1) * Pl] for s in range(nsat)],
            row_fixed, n, window, blocks, peak_mean, dop_chunk, mesh, route,
            multihost):
        parts.setdefault(s, []).append((metric, code_idx))
    rows = {s: tuple(v.cpu().numpy() for v in engine.band_best(
        torch.cat([c[0] for c in p], dim=1), torch.cat([c[1] for c in p],
                                                       dim=1),
        group or int(row_fixed[0].shape[0]))) for s, p in parts.items()}
    return _gather_rows(mesh, rows, multihost)


def acquire_signal_sharded(sig, x_int: torch.Tensor, prns, mesh,
                           doppler_search=None, ms: int = 80,
                           dop_chunk: int | None = None,
                           multihost: bool = False, chan: int = 0) -> list:
    """Mesh-parallel twin of acquire/engine.acquire_signal.

    Pads the PRN list to a multiple of the sat-axis size with copies of
    its first PRN (their results are dropped).  x_int: complex64
    internal-rate samples covering >= ms+2 ms, on any device (every rank
    passes the same samples when multihost).  chan: the FDMA channel whose
    band offset the oscillators carry.  Returns list[AcqResult] in PRN
    order.  Refuses the serial searches (serial_search_sharded)."""
    engine._serial_refused(sig, "acquire_signal_sharded")
    refuse_no_pallas("acquire_signal_sharded", x_int.device,
                     *mesh.devices.flat)
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    route, window = mesh_plan(sig)
    blocks = engine._block_count(sig, ms)
    dops, fixed = engine.doppler_grid(sig, doppler_search, chan)
    nsat = mesh.shape["sat"]
    prns_pad = list(prns) + [prns[0]] * ((-len(prns)) % nsat)
    if dop_chunk is None:
        dop_chunk = mesh_dop_chunk(len(prns_pad) // nsat, window, len(dops))
    code_ffts = engine.device_code_ffts(sig, prns_pad, n, window,
                                        x_int.device, route)
    metric, code_idx, dop_idx = grid_search_sharded(
        x_int, code_ffts, fixed.astype(np.int64), n=n, window=window,
        blocks=blocks, peak_mean=(sig.acq_metric == "peak_mean"),
        dop_chunk=dop_chunk, mesh=mesh, route=route, multihost=multihost)
    return engine._results(sig, n, prns, torch.from_numpy(metric[:, 0]),
                           torch.from_numpy(code_idx[:, 0]),
                           dops[dop_idx[:, 0]])


def fdma_dop_chunk(window: int, blocks_local: int, Dr: int) -> int:
    """Dopplers per surface call of the FDMA twin (one code row a shard):
    mesh_dop_chunk's surfaces, and no more than engine.dop_chunk_for's
    ~1 GB of [dc, B_local, W] spectra."""
    return min(mesh_dop_chunk(1, window, Dr),
               engine.dop_chunk_for("v2", 1, blocks_local, window, Dr))


def acquire_signal_fdma_sharded(sig, x_int: torch.Tensor, chans, mesh,
                                doppler_search=None, ms: int = 80,
                                dop_chunk: int | None = None,
                                multihost: bool = False) -> list:
    """Mesh twin of acquire/engine.acquire_signal_fdma (GLONASS L1/L2).

    The channels shard over `sat`, padded to a multiple of it with
    copies of the last channel (their results are dropped); the one code
    row (the channels share one m-sequence) is on every shard.  Each sat
    row searches only its own channels' bands, C_l x D increments: the
    reference's SPMD program searches every row against all C x D and
    masks the other channels' bands away (its 2-D dopp_valid), with the
    same result, the first maximum inside each channel's band
    (grid_search_sharded's per-row increments and group).  Returns
    list[AcqResult] in channel order (prn field = channel)."""
    engine._serial_refused(sig, "acquire_signal_fdma_sharded")
    refuse_no_pallas("acquire_signal_fdma_sharded", x_int.device,
                     *mesh.devices.flat)
    if not sig.fdma_hz:
        raise ValueError(f"{sig.name} is not an FDMA signal")
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    route, window = mesh_plan(sig)
    blocks = engine._block_count(sig, ms)
    dops_all, fixed = engine.fdma_grid(sig, doppler_search, chans)
    D = len(dops_all[0])
    nsat, ntime = mesh.shape["sat"], mesh.shape["time"]
    C = len(chans)
    Cl = -(-C // nsat)
    # row s searches channels s*Cl .. s*Cl + Cl - 1 (past C: the last)
    band = [min(i, C - 1) for i in range(nsat * Cl)]
    row_fixed = fixed.reshape(C, D)[band].reshape(nsat, Cl * D)
    if dop_chunk is None:
        dop_chunk = fdma_dop_chunk(window, -(-blocks // ntime), Cl * D)
    code = engine.device_code_ffts(sig, chans[:1], n, window, x_int.device,
                                   route)
    metric, code_idx, dop_idx = (v.reshape(-1) for v in grid_search_sharded(
        x_int, code.repeat(nsat, 1), row_fixed, n=n, window=window,
        blocks=blocks, peak_mean=(sig.acq_metric == "peak_mean"),
        dop_chunk=dop_chunk, mesh=mesh, route=route, multihost=multihost,
        group=D))
    return engine._results(sig, n, chans, torch.from_numpy(metric),
                           torch.from_numpy(code_idx),
                           [dops_all[i][dop_idx[i]] for i in range(C)])


def serial_search_sharded(sig, x: torch.Tensor, prn: int, doppler: float,
                          parent_code_phase: float, fs: float, mesh,
                          ms: int = 40, chan: int = 0, k_chunk: int = 25,
                          multihost: bool = False):
    """Mesh twin of acquire/serial.serial_search: the K hypotheses (75 for
    L2CL, 1000 for GLONASS P) split over every shard of the mesh, sat and
    time flattened (shard s * ntime + t takes the s * ntime + t-th slice),
    K padded with zero starts to a multiple of shards x k_chunk; each
    shard computes its slice k_chunk at a time on its device, the q
    vectors are gathered (across ranks by all_gather_object) and the host
    takes the first maximum over q[:K].  q is the single-device search's
    bit for bit (serial.py sums in float64)."""
    if not sig.acq_serial:
        raise ValueError(f"{sig.name} has no assisted serial search")
    nsat, ntime = mesh.shape["sat"], mesh.shape["time"]
    ndev = nsat * ntime
    geom = serial.hypothesis_geometry(sig, fs, ms, parent_code_phase)
    K = sig.acq_serial
    Kp = -(-K // (ndev * k_chunk)) * (ndev * k_chunk)
    s_int = np.zeros((Kp, geom.blocks), np.int32)
    s_frac = np.zeros((Kp, geom.blocks), np.float32)
    s_int[:K] = geom.s_int
    s_frac[:K] = geom.s_frac
    kl = Kp // ndev
    xw, tab, mine = {}, {}, {}
    for s in range(nsat):
        for t in range(ntime):
            if not mesh.local(s, t):
                continue
            dev = mesh.devices[s, t]
            if dev not in xw:
                xw[dev] = serial.wipe_blocks(sig, x.to(dev), doppler, fs,
                                             chan, geom)
                tab[dev] = serial.device_code(sig, prn, dev)
            j = s * ntime + t
            sl = slice(j * kl, (j + 1) * kl)
            mine[j] = serial.chunked_q(xw[dev], tab[dev], s_int[sl],
                                       s_frac[sl], geom, k_chunk).cpu().numpy()
    if multihost:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        for part in every:
            mine.update(part)
    q = np.concatenate([mine[j] for j in range(ndev)])[:K]
    return serial.best_of(prn, doppler, q, geom)
