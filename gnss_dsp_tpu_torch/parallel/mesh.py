"""The (sat, time) grid of shards the sharded engines run on.

Counterpart: gnss_dsp_tpu/parallel/mesh.py:1-52.  Axes as there:

  sat   the PRN axis of the search and the channel axis of tracking
        (each shard owns a slice; no cross-shard term)
  time  the non-coherent blocks of the search (a sum over the time shards)

A Mesh holds a [sat, time] grid of torch.devices and, for each shard, the
rank of the process that runs it (0 in a single process).  A device may
stand in the grid more than once: the CPU tests hold 8 shards on the one
CPU (the JAX tests hold them on 8 virtual CPU devices), and one card can
hold a 2 x 2 grid.  Shards on one device run one after another.

init_multihost joins a torch.distributed group; the global device list
is then every rank's local devices, rank-major (as jax.devices() orders
them), and make_mesh builds its grid over it.  The backend is the
caller's: "nccl" where each rank owns its own card, "gloo" on the CPU or
where ranks share a card (collectives then go through host memory).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# the global (rank, device) list after init_multihost
_GLOBAL: list = []
# {sorted ranks: process group} made by rank_group since init_multihost
_GROUPS: dict = {}


def this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A [sat, time] grid of shards: devices (torch.device) and ranks
    (the process that runs each shard)."""

    def __init__(self, devices, ranks):
        self.devices = np.empty(np.shape(ranks), dtype=object)
        for idx in np.ndindex(self.devices.shape):
            self.devices[idx] = torch.device(devices[idx[0]][idx[1]])
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.shape = {"sat": self.ranks.shape[0],
                      "time": self.ranks.shape[1]}

    def local(self, s: int, t: int) -> bool:
        """Shard (s, t) runs in this process."""
        return int(self.ranks[s, t]) == this_rank()

    def __repr__(self):
        return (f"Mesh(sat={self.shape['sat']}, time={self.shape['time']}, "
                f"devices={[[str(d) for d in r] for r in self.devices]}, "
                f"ranks={self.ranks.tolist()})")


def default_devices() -> list:
    """This process's devices: each card torch sees.  Raises where there
    is none: a CPU mesh is asked for by name (devices=["cpu"] * n)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card for the mesh (torch.cuda."
                           "is_available() is False); pass devices= to "
                           "shard over the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def cli_devices(device, n: int) -> list:
    """The devices the CLIs' --mesh N shards over for `device`: for a
    CUDA device the cards torch sees from its index on, for the CPU N
    shards of it (one for N < 0)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * max(n, 1)
    return default_devices()[device.index or 0:]


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, backend: str, local_devices=None):
    """Join this process to a group of num_processes ranks through
    torch.distributed (init_method tcp://coordinator_address) on
    `backend`, and gather every rank's local devices (default:
    default_devices()) into the global list make_mesh takes."""
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _GROUPS.clear()
    local = [str(torch.device(d)) for d in (local_devices
                                            or default_devices())]
    every = [None] * num_processes
    dist.all_gather_object(every, local)
    _GLOBAL[:] = [(r, torch.device(d)) for r, devs in enumerate(every)
                  for d in devs]


def rank_group(ranks):
    """The process group of `ranks`, made on first use and kept: every
    rank of the job asks for the same groups in the same order (the rule
    of dist.new_group), so each is made once on every rank."""
    key = tuple(sorted(int(r) for r in ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def make_mesh(n_devices: int | None = None, time_shards: int | None = None,
              devices=None) -> Mesh:
    """A (sat, time) mesh over the first n_devices (default: all) of
    `devices` (default: the global list after init_multihost, else the
    cards, default_devices(); a list may name a device more than once).
    time_shards defaults to 2 when the count is even and above 1, else 1,
    as in the JAX package."""
    if devices is not None:
        pairs = [(this_rank(), torch.device(d)) for d in devices]
    elif _GLOBAL:
        pairs = list(_GLOBAL)
    else:
        pairs = [(0, d) for d in default_devices()]
    if n_devices is not None:
        pairs = pairs[:n_devices]
    nd = len(pairs)
    if nd < 1:
        raise ValueError("a mesh needs at least one device")
    if time_shards is None:
        time_shards = 2 if nd % 2 == 0 and nd > 1 else 1
    if nd % time_shards:
        raise ValueError(f"{nd} devices do not split into {time_shards} "
                         f"time shards")
    shape = (nd // time_shards, time_shards)
    ranks = np.array([r for r, _ in pairs]).reshape(shape)
    devs = [[pairs[s * time_shards + t][1] for t in range(time_shards)]
            for s in range(shape[0])]
    return Mesh(devs, ranks)
