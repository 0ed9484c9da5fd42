"""One rank of a multi-process sharded search or track.

Counterpart: tools/multihost_worker.py of the JAX package, with
torch.distributed in place of jax.distributed:

    python -m gnss_dsp_tpu_torch.tools.multihost_worker PID NPROC PORT \\
        IN.npz OUT.npz [--device cuda|cpu] [--shards K] [--time-shards T]

Each of the NPROC processes joins the gloo group at 127.0.0.1:PORT with
its own K shards of --device (default: 4 on the CPU, as the JAX workers'
4 virtual devices; 1 on a card) and builds its mesh over all NPROC x K,
rank-major: the search over every shard with time_shards T (default
parallel/mesh's: 2 for an even count), tracking with time_shards 1.  The
ranks may share one card (gloo's collectives go through host memory).
Rank 0 writes the gathered results to OUT.npz.

IN.npz, as the JAX package's tests write it: the search (task absent or
"acquire"): sig, acq_fs, x (internal-rate complex samples), prns,
dop_search, ms, dop_chunk; tracking (task "track"): sig, fs, x, prns,
phases, dops, tab, ratios, cdf, coffset, n_blocks.  Two more tasks of
the port: "fdma", the FDMA search (the search's keys, prns the
channels: acquire_signal_fdma_sharded), and "serial", the assisted
serial search over every shard (sig, fs, x native-rate samples, prn,
doppler, parent_code_phase, ms, chan, k_chunk: serial_search_sharded;
OUT.npz holds k, metric and code_offset).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def _acquire(data, dev, mesh, fdma=False):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_fdma_sharded, acquire_signal_sharded)

    sig = dataclasses.replace(get_signal(str(data["sig"])),
                              acq_fs=float(data["acq_fs"]))
    x = torch.from_numpy(np.asarray(data["x"], np.complex64)).to(dev)
    run = acquire_signal_fdma_sharded if fdma else acquire_signal_sharded
    res = run(
        sig, x, [int(p) for p in data["prns"]], mesh,
        doppler_search=tuple(float(v) for v in data["dop_search"]),
        ms=int(data["ms"]), dop_chunk=int(data["dop_chunk"]),
        multihost=True)
    return dict(prn=[r.prn for r in res], doppler=[r.doppler for r in res],
                metric=[r.metric for r in res],
                code_offset=[r.code_offset for r in res])


def _serial(data, dev, mesh):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import serial_search_sharded

    x = torch.from_numpy(np.asarray(data["x"], np.complex64)).to(dev)
    r = serial_search_sharded(
        get_signal(str(data["sig"])), x, int(data["prn"]),
        float(data["doppler"]), float(data["parent_code_phase"]),
        float(data["fs"]), mesh, ms=int(data["ms"]), chan=int(data["chan"]),
        k_chunk=int(data["k_chunk"]), multihost=True)
    return dict(k=r.k, metric=r.metric, code_offset=r.code_offset)


def _track(data, dev, mesh):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.track import track_scan_sharded
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state

    sig = get_signal(str(data["sig"]))
    fs = float(data["fs"])
    x = np.asarray(data["x"], np.complex64)
    params = make_params(sig, fs, coffset=float(data["coffset"]),
                         loop_dwells=(10, 10))
    xp = torch.from_numpy(np.concatenate(
        [x, np.zeros(params.nmax, np.complex64)])).to(dev)
    dops = data["dops"]
    st = init_state(code_p=data["phases"], code_f_off=0 * dops,
                    carrier_p=0 * dops, carrier_f=dops, device=dev)
    st, rf, ri = track_scan_sharded(
        mesh, xp, len(x), torch.from_numpy(data["tab"]).to(dev), st, params,
        int(data["n_blocks"]), ratios=torch.from_numpy(data["ratios"]),
        coffset_df=torch.from_numpy(data["cdf"]), multihost=True)
    return dict(rf=rf.cpu().numpy(), ri=ri.cpu().numpy(),
                **{f: getattr(st, f).cpu().numpy() for f in st._fields})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("in_npz")
    ap.add_argument("out_npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device type of this rank's shards (default "
                    "%(default)s; cpu runs the plain versions)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of --device in this process (default: 4 "
                    "on the CPU, 1 on a card)")
    ap.add_argument("--time-shards", type=int, default=None)
    args = ap.parse_args(argv)

    from gnss_dsp_tpu_torch.device import resolve_device
    from gnss_dsp_tpu_torch.parallel.mesh import init_multihost, make_mesh

    dev = resolve_device(args.device)
    shards = args.shards or (4 if dev.type == "cpu" else 1)
    init_multihost(f"127.0.0.1:{args.port}", args.nproc, args.pid, "gloo",
                   local_devices=[dev] * shards)
    data = np.load(args.in_npz)
    task = str(data["task"]) if "task" in data else "acquire"
    if task == "track":
        out = _track(data, dev, make_mesh(time_shards=1))
    elif task == "serial":
        out = _serial(data, dev, make_mesh(time_shards=args.time_shards))
    else:
        out = _acquire(data, dev, make_mesh(time_shards=args.time_shards),
                       fdma=task == "fdma")
    if args.pid == 0:
        np.savez(args.out_npz, **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {args.pid}/{args.nproc} done over {args.nproc * shards} "
          f"shards of {dev}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
