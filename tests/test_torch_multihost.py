"""The port's sharded search and tracking as two torch.distributed
processes over gloo (gnss_dsp_tpu_torch.tools.multihost_worker), against
the single-process port:

  * the search with 4 CPU shards a rank (the JAX package's
    tests/test_multihost.py layout: a 4 x 2 mesh over 8 shards, each sat
    row inside one rank, the per-PRN results gathered across ranks):
    PRN, doppler and code offset equal to acquire_signal's, metric rtol
    1e-5, and every value equal to the single-process sharded search on
    the same 4 x 2 grid;
  * the search with 1 shard a rank and time_shards 2 (a 1 x 2 mesh: the
    sum over time shards crosses the ranks by all_reduce): every value
    equal to the single-process search on a 1 x 2 grid;
  * tracking with 4 CPU shards a rank (8 channels over an 8 x 1 mesh):
    rows and state equal to the single-process track_scan bit for bit;
  * the FDMA search (15 GLONASS L1 channels over a 4 x 2 mesh, each sat
    row's bands inside one rank) and the GPS L2CL serial search (75
    hypotheses over the 8 shards of both ranks): every value equal to the
    single-process sharded search on the same grid.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _workers(tmp_path, npz, extra=()):
    out_npz = os.path.join(tmp_path, "out.npz")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnss_dsp_tpu_torch.tools.multihost_worker",
         str(pid), "2", str(port), npz, out_npz, "--device", "cpu", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-2000:]
    return np.load(out_npz)


def _search_input(tmp_path):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("gps-l1"), acq_fs=1.024e6)
    ms, grid, dop_chunk = 8, (-2000.0, 2000.0, 250.0), 8
    n = int(sig.acq_fs * 1e-3)
    x = synth_iq(sig.code_table((3,))[0], sig.chip_rate, sig.acq_fs,
                 (ms + 1) * n, doppler_hz=900.0, code_phase=77.0,
                 cn0_dbhz=43.0, rng=np.random.default_rng(3),
                 carrier_ratio=1540.0).astype(np.complex64)
    npz = os.path.join(tmp_path, "in.npz")
    np.savez(npz, sig="gps-l1", acq_fs=sig.acq_fs, x=x,
             prns=list(range(1, 9)), dop_search=grid, ms=ms,
             dop_chunk=dop_chunk)
    return sig, torch.from_numpy(x), list(range(1, 9)), grid, ms, npz


def _sharded(sig, x, prns, grid, ms, nd, ts):
    from gnss_dsp_tpu_torch.parallel.acquire import acquire_signal_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    return acquire_signal_sharded(
        sig, x, prns, make_mesh(nd, ts, devices=["cpu"] * nd),
        doppler_search=grid, ms=ms, dop_chunk=8)


def _as_cols(res):
    return dict(prn=[r.prn for r in res], doppler=[r.doppler for r in res],
                metric=[r.metric for r in res],
                code_offset=[r.code_offset for r in res])


def test_two_process_grid_search(tmp_path):
    from gnss_dsp_tpu_torch.acquire.engine import acquire_signal

    sig, x, prns, grid, ms, npz = _search_input(tmp_path)
    got = _workers(str(tmp_path), npz)
    single = acquire_signal(sig, x, prns, doppler_search=grid, ms=ms)
    for i, r in enumerate(single):
        assert int(got["prn"][i]) == r.prn
        assert float(got["doppler"][i]) == r.doppler
        assert float(got["code_offset"][i]) == r.code_offset
        np.testing.assert_allclose(float(got["metric"][i]), r.metric,
                                   rtol=1e-5)
    same = _as_cols(_sharded(sig, x, prns, grid, ms, 8, 2))
    for k, v in same.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert int(got["prn"][np.argmax(got["metric"])]) == 3


def test_two_process_search_sums_time_across_ranks(tmp_path):
    sig, x, prns, grid, ms, npz = _search_input(tmp_path)
    got = _workers(str(tmp_path), npz, ("--shards", "1",
                                        "--time-shards", "2"))
    same = _as_cols(_sharded(sig, x, prns, grid, ms, 2, 2))
    for k, v in same.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_two_process_tracking(tmp_path):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, track_scan
    from gnss_dsp_tpu_torch.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    fs, C, nb, coffset = 2.048e6, 8, 40, 1000.0
    prns = list(range(1, C + 1))
    dops = np.linspace(-3000.0, 3000.0, C)
    phases = np.linspace(10.0, 950.0, C)
    n = int(fs * 0.05)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=cp,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, cp in zip(prns, dops, phases)).astype(np.complex64)
    tab = sig.code_table(tuple(prns)).astype(np.int8)
    ratios = np.linspace(1200.0, 1600.0, C).astype(np.float32)
    cdf = (np.arange(C) * 1000 - 250000).astype(np.int32)
    npz = os.path.join(tmp_path, "in.npz")
    np.savez(npz, task="track", sig="gps-l1", fs=fs, x=x, prns=prns,
             phases=phases, dops=dops, tab=tab, ratios=ratios, cdf=cdf,
             coffset=coffset, n_blocks=nb)
    got = _workers(str(tmp_path), npz)

    params = make_params(sig, fs, coffset=coffset, loop_dwells=(10, 10))
    xp = torch.from_numpy(np.concatenate(
        [x, np.zeros(params.nmax, np.complex64)]))
    st = init_state(code_p=phases, code_f_off=0 * dops, carrier_p=0 * dops,
                    carrier_f=dops)
    st, rf, ri = track_scan(xp, n, torch.from_numpy(tab), st, params, nb,
                            ratios=torch.from_numpy(ratios),
                            coffset_df=torch.from_numpy(cdf))
    assert (ri[:, :, 0] > 0).all()
    np.testing.assert_array_equal(got["rf"], rf.numpy())
    np.testing.assert_array_equal(got["ri"], ri.numpy())
    for k in st._fields:
        np.testing.assert_array_equal(got[k], getattr(st, k).numpy(),
                                      err_msg=k)


def test_two_process_fdma_search(tmp_path):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_fdma_sharded)
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("glonass-l1"), acq_fs=2.048e6)
    chans, grid, ms = list(range(-7, 8)), (500.0, 2500.0, 250.0), 6
    x = synth_iq(sig.code_table((-3,))[0], sig.chip_rate, sig.acq_fs,
                 int(sig.acq_fs * (ms + 2) / 1000),
                 doppler_hz=1500.0 + sig.fdma_hz * -3, code_phase=100.0,
                 cn0_dbhz=45.0, rng=np.random.default_rng(5),
                 carrier_ratio=sig.track_carrier_ratio(-3),
                 code_doppler_hz=1500.0).astype(np.complex64)
    npz = os.path.join(tmp_path, "in.npz")
    np.savez(npz, task="fdma", sig="glonass-l1", acq_fs=sig.acq_fs, x=x,
             prns=chans, dop_search=grid, ms=ms, dop_chunk=5)
    got = _workers(str(tmp_path), npz)
    same = _as_cols(acquire_signal_fdma_sharded(
        sig, torch.from_numpy(x), chans,
        make_mesh(8, 2, devices=["cpu"] * 8), doppler_search=grid, ms=ms,
        dop_chunk=5))
    for k, v in same.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert int(got["prn"][np.argmax(got["metric"])]) == -3


def test_two_process_serial_search(tmp_path):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import serial_search_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.utils.synth import synth_iq

    sig = get_signal("gps-l2cl")
    fs, ms, pp = 2.048e6, 40, 1234.0
    phase = float((31 * 10230 + pp) % sig.code_length)
    x = synth_iq(sig.code_table((5,))[0], sig.chip_rate, fs,
                 int(fs * (ms + 2) / 1000), doppler_hz=250.0,
                 code_phase=phase, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio).astype(np.complex64)
    npz = os.path.join(tmp_path, "in.npz")
    np.savez(npz, task="serial", sig="gps-l2cl", fs=fs, x=x, prn=5,
             doppler=250.0, parent_code_phase=pp, ms=ms, chan=0, k_chunk=5)
    got = _workers(str(tmp_path), npz)
    same = serial_search_sharded(sig, torch.from_numpy(x), 5, 250.0, pp, fs,
                                 make_mesh(8, 2, devices=["cpu"] * 8),
                                 ms=ms, k_chunk=5)
    assert int(got["k"]) == same.k == 31
    assert float(got["metric"]) == same.metric
    assert float(got["code_offset"]) == same.code_offset == phase


def test_rank_group_made_once():
    """parallel/mesh.rank_group makes a process group once and hands the
    same group to every later search (a sharded search asks for its sat
    rows' groups on every call)."""
    from gnss_dsp_tpu_torch.parallel import mesh

    mesh.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, "gloo",
                        local_devices=["cpu"] * 2)
    try:
        g = mesh.rank_group({0})
        assert mesh.rank_group([0]) is g
        assert list(mesh._GROUPS) == [(0,)]
    finally:
        torch.distributed.destroy_process_group()
        mesh._GLOBAL.clear()
        mesh._GROUPS.clear()
