"""The port's sharded paths (gnss_dsp_tpu_torch.parallel) against the JAX
package's on the CPU.

  * K1's surface (ops/acquire2.corr_surface2 with reduce=False, its plain
    version here) against pallas_acquire2.corr_surface2(reduce=False) in
    interpret mode on the same bf16-rounded spectra: planted argmax exact,
    the surface to rtol 5e-3 (the K1 parity test's bf16 budget: the TPU
    kernel's inverse DFT runs as bf16 matmuls);
  * the sharded route (acquire/plan.mesh_plan) against the JAX package's
    plan_aligned / plan2 at the 2n windows for every catalog signal with
    an FFT search: route, split and window exact;
  * acquire_signal_sharded on a grid of 8 CPU shards against the JAX
    acquire_signal_sharded on the 8 virtual CPU devices
    (tests/conftest.py), at sat x time 4 x 2 and 8 x 1, on GPS L1 (v2) and
    GPS L5I (the pad2 route v1 at 2n lags), with small acq_fs: PRN,
    doppler and code offset exact, metric rtol 1e-5;
  * track_scan_sharded against the port's unsharded track_scan bit for bit
    (rows and state), and against the JAX track_scan_sharded at the
    tracking tolerance rtol 2e-5 / atol 2e-4 (int rows exact);
  * track_file with a mesh whose sat axis does not divide the channels
    (padding clones, never emitted) equals track_file without one, also
    coherent, and refuses coherent tracking under a mesh without K2.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.ops import acquire2


def _planted_spectra(rng, P, DC, B, W, plants):
    code = np.exp(2j * np.pi * rng.random((P, W)))
    F = 0.7 * (rng.standard_normal((DC, B, W))
               + 1j * rng.standard_normal((DC, B, W)))
    k = np.arange(W)
    for p, d, j in plants:
        F[d] += 0.5 * code[p] * np.exp(-2j * np.pi * k * j / W)
    return code, F


def test_k1_surface_plain_matches_pallas_kernel_interpret():
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    W, P, DC, B = 1024, 3, 2, 16
    n1, n2 = pa2.plan_aligned(W)
    g = pa2.pick_g(n1)                 # the kernel takes blocks in groups
    rng = np.random.default_rng(22)
    plants = [(0, 0, 77), (1, 1, 1000), (2, 0, 513)]
    code, F = _planted_spectra(rng, P, DC, B, W, plants)
    assert B % g == 0

    def bf16_perm(a):
        ap = pa2.permute_host2(a, n1, n2)
        return (jnp.asarray(ap.real.astype(np.float32)).astype(jnp.bfloat16),
                jnp.asarray(ap.imag.astype(np.float32)).astype(jnp.bfloat16))

    F16, C16 = bf16_perm(F), bf16_perm(code)
    want = np.asarray(pa2.corr_surface2(F16, C16, n1=n1, n2=n2, bt=g,
                                        reduce=False, interpret=True))

    def natural(split):
        return interop.code_ffts_from_split(
            np.asarray(split[0], np.float32), np.asarray(split[1], np.float32),
            plan=("v2", n1, n2))

    n0 = acquire2.LAUNCHES_SURFACE
    got = acquire2.corr_surface2(natural(F16), natural(C16), 0, False)
    assert acquire2.LAUNCHES_SURFACE == n0       # the plain version ran
    assert got.shape == want.shape == (P, DC, W)
    for p, d, j in plants:
        assert int(got[p, d].argmax()) == int(want[p, d].argmax()) == (-j) % W
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3)
    with pytest.raises(ValueError, match="n_valid"):
        acquire2.corr_surface2(natural(F16), natural(C16), 16, False)


def _fft_signals():
    from gnss_dsp_tpu.models.signal import all_signals

    return sorted(name for name, s in all_signals().items()
                  if s.code_table is not None and not s.acq_serial)


def test_mesh_plan_matches_jax_router():
    """The reference's sharded plan, _fused_plan(window) with no pad2_n on
    an accelerator: plan_aligned's split, else plan2's, at the 2n window
    of the pad2 and sliding signals.  The port's route and window are the
    reference's, and the split its kernel runs (acquire plan_aligned on
    v2, K7's wide_split on v1) is the reference kernel's."""
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu.ops import pallas_acquire as pa
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2
    from gnss_dsp_tpu_torch.acquire.plan import mesh_plan, plan_aligned
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops.acquire2 import wide_split

    names = _fft_signals()
    assert len(names) >= 30
    routes = {}
    for name in names:
        s = jsig(name)
        n = int(round(s.acq_fs * s.acq_coherent_ms / 1000.0))
        window = 2 * n if (s.acq_pad2 or s.acq_sliding) else n
        try:
            want = ("v2", window, pa2.plan_aligned(window))
        except ValueError:
            want = ("v1", window, pa.plan2(window))
        route, w = mesh_plan(get_signal(name))
        got = (route, w, plan_aligned(w) if route == "v2" else wide_split(w))
        assert got == want, name
        routes[name] = got
    assert routes["gps-l5i"] == ("v1", 61380, (220, 279))
    assert routes["galileo-e6b"] == ("v1", 30690, (165, 186))
    assert routes["gps-l2cm"][:2] == ("v2", 163840)
    assert sum(r[1] == 61380 for r in routes.values()) == 13


def _synth(sig, fs, n, plants, seed):
    from gnss_dsp_tpu.utils.synth import synth_iq

    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in plants:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                      carrier_ratio=sig.carrier_ratio)
    return x + 0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                      ).astype(np.complex64)


# (signal, acq_fs, PRNs, grid, ms, planted (prn, doppler, chips))
_SEARCHES = {
    "gps-l1": ("gps-l1", 1.024e6, list(range(1, 9)),
               (-2000.0, 2000.0, 250.0), 8,
               ((3, 1000.0, 77.0), (6, -750.0, 500.5))),
    "gps-l5i": ("gps-l5i", 10.23e6, [1, 2, 3, 4, 5, 6],
                (-1500.0, 1500.0, 500.0), 4,
                ((2, 500.0, 3000.0), (5, -1000.0, 7000.0))),
}


@pytest.mark.parametrize("layout", [(8, 2), (8, 1)])
@pytest.mark.parametrize("case", sorted(_SEARCHES))
def test_acquire_sharded_matches_jax_sharded(case, layout):
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu.parallel import acquire as jpar
    from gnss_dsp_tpu.parallel.mesh import make_mesh as jmesh
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import acquire_signal_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    name, fs, prns, grid, ms, plants = _SEARCHES[case]
    nd, ts = layout
    js = dataclasses.replace(jsig(name), acq_fs=fs)
    ts_ = dataclasses.replace(get_signal(name), acq_fs=fs)
    x = _synth(js, fs, int(fs * (ms + 2) / 1000), plants, seed=nd + ts)
    want = jpar.acquire_signal_sharded(js, x, prns, jmesh(nd, ts),
                                       doppler_search=grid, ms=ms)
    mesh = make_mesh(nd, ts, devices=["cpu"] * nd)
    assert mesh.shape == {"sat": nd // ts, "time": ts}
    got = acquire_signal_sharded(ts_, torch.from_numpy(x), prns, mesh,
                                 doppler_search=grid, ms=ms)
    assert [r.prn for r in got] == prns
    for a, b in zip(want, got):
        assert (b.prn, b.doppler, b.code_offset) == \
            (a.prn, a.doppler, a.code_offset)
        np.testing.assert_allclose(b.metric, a.metric, rtol=1e-5)
    by = {r.prn: r for r in got}
    for prn, dop, cp in plants:
        assert abs(by[prn].doppler - dop) <= grid[2] / 2
        L = ts_.code_length
        assert min(abs(by[prn].code_offset - cp),
                   L - abs(by[prn].code_offset - cp)) <= 1.0


def test_acquire_sharded_pads_prns_and_takes_2d_valid():
    """Three PRNs on four sat shards: padded with copies of the first,
    the same results as one shard; and grid_search_sharded's per-row
    increments (the FDMA twin's form, in place of the reference's 2-D
    validity mask) search each row's own dopplers, in groups."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_sharded, grid_search_sharded)
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    sig = dataclasses.replace(get_signal("gps-l1"), acq_fs=1.024e6)
    grid, ms = (-2000.0, 2000.0, 500.0), 6
    x = torch.from_numpy(_synth(sig, sig.acq_fs, int(1.024e6 * 0.008),
                                ((3, 1000.0, 77.0),), seed=4))
    one = acquire_signal_sharded(sig, x, [3, 7, 9], make_mesh(
        1, devices=["cpu"]), doppler_search=grid, ms=ms)
    four = acquire_signal_sharded(sig, x, [3, 7, 9], make_mesh(
        4, 1, devices=["cpu"] * 4), doppler_search=grid, ms=ms, dop_chunk=3)
    for a, b in zip(one, four):
        assert (b.prn, b.doppler, b.code_offset) == \
            (a.prn, a.doppler, a.code_offset)
        np.testing.assert_allclose(b.metric, a.metric, rtol=1e-6)
    n = 1024
    cf = torch.from_numpy(engine.build_code_ffts(sig, (3, 3), n, n)
                          .astype(np.complex64))
    dops, fixed = engine.doppler_grid(sig, grid)
    # six dopplers a row: row 0 leaves out -2000 and -1500 Hz, row 1
    # -2000 Hz and PRN 3's true doppler 1000 Hz
    keep = [dops > -1200.0, (dops > -2000.0) & (dops != 1000.0)]
    metric, code, dop = grid_search_sharded(
        x, cf, np.stack([fixed[k] for k in keep]).astype(np.int64), n=n,
        window=n, blocks=ms, peak_mean=True, dop_chunk=3,
        mesh=make_mesh(2, 1, devices=["cpu"] * 2), route="v2", group=3)
    assert metric.shape == code.shape == dop.shape == (2, 2)
    row_dops = [dops[k].reshape(2, 3) for k in keep]
    assert row_dops[0][1, dop[0, 1]] == 1000.0
    assert 1000.0 not in row_dops[1]
    assert metric[0, 1] > metric[1].max()


def _track_setup(C=8, nb=40):
    """tests/test_parallel.py's tracking case, every channel on signal
    (a channel with none follows its loop's rounding noise, which the two
    packages round differently): GPS L1 at 2.048 MHz, per-channel ratios
    and FDMA-style offsets."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    fs = 2.048e6
    prns = list(range(1, C + 1))
    dops = np.linspace(-3000.0, 3000.0, C)
    phases = np.linspace(10.0, 950.0, C)
    n = int(fs * 0.05)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=cp,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, cp in zip(prns, dops, phases))
    return dict(sig=sig, fs=fs, x=x.astype(np.complex64), n=n, nb=nb,
                tab=sig.code_table(tuple(prns)).astype(np.int8),
                ratios=np.linspace(1200.0, 1600.0, C).astype(np.float32),
                cdf=(np.arange(C) * 1000 - 250000).astype(np.int32),
                dops=dops, phases=phases, C=C)


def _port_scan(s, mesh=None):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.track import track_scan_sharded
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, track_scan

    params = make_params(get_signal("gps-l1"), s["fs"], coffset=1000.0,
                         loop_dwells=(10, 10))
    xp = torch.from_numpy(np.concatenate(
        [s["x"], np.zeros(params.nmax, np.complex64)]))
    st = init_state(code_p=s["phases"], code_f_off=np.zeros(s["C"]),
                    carrier_p=np.zeros(s["C"]), carrier_f=s["dops"])
    args = (xp, s["n"], torch.from_numpy(s["tab"]), st, params, s["nb"])
    kw = dict(ratios=torch.from_numpy(s["ratios"]),
              coffset_df=torch.from_numpy(s["cdf"]))
    if mesh is None:
        return track_scan(*args, **kw)
    return track_scan_sharded(mesh, *args, **kw)


@pytest.fixture(scope="module")
def track_case():
    s = _track_setup()
    return s, _port_scan(s)


@pytest.mark.parametrize("nsat", [8, 4, 2])
def test_track_sharded_equals_unsharded(track_case, nsat):
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    s, (st_a, rf_a, ri_a) = track_case
    st_b, rf_b, ri_b = _port_scan(s, make_mesh(nsat, 1,
                                               devices=["cpu"] * nsat))
    assert (ri_a[:, :, 0] > 0).all()
    assert torch.equal(ri_a, ri_b)
    assert torch.equal(rf_a.nan_to_num(-1.0), rf_b.nan_to_num(-1.0))
    for k in st_a._fields:
        assert torch.equal(getattr(st_a, k), getattr(st_b, k)), k


def test_track_sharded_matches_jax_sharded(track_case):
    import jax.numpy as jnp

    from gnss_dsp_tpu.parallel.mesh import make_mesh as jmesh
    from gnss_dsp_tpu.parallel.track import track_scan_sharded as jsharded
    from gnss_dsp_tpu.track.driver import make_params as jparams
    from gnss_dsp_tpu.track.engine import init_state as jinit

    s, (st_t, rf_t, ri_t) = track_case
    params = jparams(s["sig"], s["fs"], coffset=1000.0, loop_dwells=(10, 10))
    xd = (jnp.asarray(s["x"].real.copy()), jnp.asarray(s["x"].imag.copy()))
    st = jinit(code_p=s["phases"], code_f_off=np.zeros(s["C"]),
               carrier_p=np.zeros(s["C"]), carrier_f=s["dops"])
    st_j, rf_j, ri_j = jsharded(
        jmesh(8, time_shards=1), xd, jnp.int32(s["n"]),
        jnp.asarray(s["tab"]), st, params, s["nb"],
        ratios=jnp.asarray(s["ratios"]), coffset_df=jnp.asarray(s["cdf"]))
    np.testing.assert_array_equal(ri_t.numpy(), np.asarray(ri_j))
    np.testing.assert_allclose(rf_t.numpy(), np.asarray(rf_j), rtol=2e-5,
                               atol=2e-4)
    got = interop.state_to_numpy(st_t)
    for k in ("ptr", "block", "stalled", "coffset_p"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(st_j, k)),
                                      err_msg=k)
    for k in ("code_p_hi", "carrier_p", "carrier_f", "code_f_off"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(st_j, k)),
                                   rtol=2e-5, atol=2e-4, err_msg=k)


def _track_file(raw, chans, mesh=None, coherent=1, sig="gps-l1",
                fs=2.048e6):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file

    out = track_file(get_signal(sig), io.BytesIO(raw), fs, 0.0,
                     [TrackChannel(prn=p, doppler=d, code_offset=c,
                                   overlay_phase=o)
                      for p, d, c, o in chans],
                     loop_dwells=(10, 10), chunk_ms=30.0, device="cpu",
                     coherent_blocks=coherent, mesh=mesh)
    return [[tuple(r.values()) for r in ch.rows] for ch in out]


def test_track_file_mesh_pads_channels(track_case):
    """3 channels over 2 sat shards (one clone of channel 0, never
    emitted), across chunk refills: the rows equal the unsharded run's."""
    from gnss_dsp_tpu.utils.synth import to_int8_iq
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    s, _ = track_case
    raw = to_int8_iq(s["x"], scale=20.0)
    chans = [(p, d, c, 0) for p, d, c in
             zip((1, 2, 3), s["dops"][:3], s["phases"][:3])]
    want = _track_file(raw, chans)
    got = _track_file(raw, chans, make_mesh(2, 1, devices=["cpu"] * 2))
    assert len(got) == 3 and all(len(r) > 40 for r in got)
    assert got == want


def test_track_file_mesh_coherent(monkeypatch):
    """Coherent tracking (M = 4) of two B1I channels on 2 x 1 and 3 x 1
    meshes equals the unsharded run; without K2 (GNSS_DSP_NO_FUSED) a
    mesh refuses it, as the reference asserts."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq, to_int8_iq
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    sig = get_signal("beidou-b1i")
    fs = 2.046e6
    n = int(fs * 0.06)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=cp,
                     cn0_dbhz=None, carrier_ratio=sig.carrier_ratio)
            for p, d, cp in ((6, 300.0, 100.0), (9, -450.0, 1500.0)))
    raw = to_int8_iq(x.astype(np.complex64), scale=20.0)
    chans = [(6, 300.0, 100.0, 3), (9, -450.0, 1500.0, 7)]
    want = _track_file(raw, chans, coherent=4, sig="beidou-b1i", fs=fs)
    for nsat in (2, 3):
        got = _track_file(raw, chans, make_mesh(nsat, 1,
                                                devices=["cpu"] * nsat),
                          coherent=4, sig="beidou-b1i", fs=fs)
        assert got == want and len(got[0]) > 40
    monkeypatch.setenv("GNSS_DSP_NO_FUSED", "1")
    with pytest.raises(ValueError, match="K2"):
        _track_file(raw, chans, make_mesh(2, 1, devices=["cpu"] * 2),
                    coherent=4, sig="beidou-b1i", fs=fs)
