"""The port's FDMA acquisition (GLONASS L1/L2, gnss_dsp_tpu_torch) against
the JAX package on the CPU, at acq_fs 2.048 MHz (tests/test_parallel.py's
size) unless the CLI sets the catalog's 16.384 MHz.

  * acquire_signal_fdma against the JAX acquire_signal_fdma on the
    mixed-channel capture of tests/test_signals_e2e.py's
    test_acquire_glonass_fdma_batched: channel, doppler and code offset
    exact, metric rtol 1e-4 (float32 FFTs in another order); and against
    the port's own acquire_signal(chan=) a channel: the same cells and the
    same metric bits (each channel's band is the same search);
  * the per-band reduction (grid_search's group) does not depend on the
    doppler chunking, which does not follow the bands;
  * acquire_signal(chan=-3) against the JAX one (test_acquire_glonass_fdma);
  * acquire_signal_coherent(chan=) against the JAX one on
    tests/test_coherent.py's test_coherent_fdma_channel_offset capture,
    searched in its own band and in channel 0's, on the XLA engine (metric
    rtol 1e-4, the rest exact) and on the fused route (the K6 plain
    version against the JAX kernel in interpret mode, metric within 3e-2:
    its bf16 inverse DFT; the cells exact in the channel's own band, where
    the peak stands out);
  * acquire_signal_fdma_sharded on 8 CPU shards against the JAX twin on
    its 8 virtual devices (tests/conftest.py), sat x time 4 x 2 and 8 x 1:
    channel, doppler and code offset exact, metric rtol 1e-5; and equal to
    the port's single-device search in every cell;
  * the FDMA acquire CLI, plain and with --mesh 8, prints the JAX CLI's
    rows: channel, doppler and code offset text for text, the metric
    within rtol 1e-5 (float32 sums in another order; "% 7.1f" of a
    metric near 1.3e6 prints its last digit at 4e-8 of it, so a row may
    differ there).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

GRID = (-2000.0, 2000.0, 200.0)
LIVE = {-2: (1200.0, 300.0), 2: (-900.0, 77.0)}


def _sigs(name="glonass-l1", fs=2.048e6):
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu_torch.models import get_signal

    return (dataclasses.replace(jsig(name), acq_fs=fs),
            dataclasses.replace(get_signal(name), acq_fs=fs))


def make_iq(sig, fs, ms, doppler, code_phase, chan, cn0=None, seed=0):
    """tests/test_parallel.py's make_iq: the band offset in the carrier
    only, the code rate riding the true doppler."""
    from gnss_dsp_tpu.utils.synth import synth_iq

    return synth_iq(sig.code_table((chan,))[0], sig.chip_rate, fs,
                    int(fs * ms / 1000.0),
                    doppler_hz=doppler + sig.fdma_hz * chan,
                    code_phase=code_phase, cn0_dbhz=cn0,
                    rng=np.random.default_rng(seed),
                    carrier_ratio=sig.track_carrier_ratio(chan),
                    code_doppler_hz=doppler)


@pytest.fixture(scope="module")
def batched():
    js, ts = _sigs()
    ms = 16
    x = np.zeros(int(js.acq_fs * (ms + 3) / 1000), np.complex64)
    for chan, (dop, cp) in LIVE.items():
        x += make_iq(js, js.acq_fs, ms + 3, dop, cp, chan)
    return js, ts, x, ms


def _same_cells(a, b):
    assert (b.prn, b.doppler, b.code_offset) == \
        (a.prn, a.doppler, a.code_offset), (a, b)


def test_acquire_signal_fdma_matches_jax_and_the_channel_loop(batched):
    from gnss_dsp_tpu.acquire import engine as jeng
    from gnss_dsp_tpu_torch.acquire import engine as teng

    js, ts, x, ms = batched
    chans = list(range(-3, 4))
    want = jeng.acquire_signal_fdma(js, x, chans, doppler_search=GRID, ms=ms)
    got = teng.acquire_signal_fdma(ts, torch.from_numpy(x), chans,
                                   doppler_search=GRID, ms=ms)
    assert [r.prn for r in got] == chans
    for a, b in zip(want, got):
        _same_cells(a, b)
        np.testing.assert_allclose(b.metric, a.metric, rtol=1e-4)
    for r in got:
        if r.prn in LIVE:
            dop, cp = LIVE[r.prn]
            assert abs(r.doppler - dop) <= 200.0
            assert min(abs(r.code_offset - cp),
                       511 - abs(r.code_offset - cp)) <= 1.0
    dead = max(r.metric for r in got if r.prn not in LIVE)
    assert all(r.metric > 1.5 * dead for r in got if r.prn in LIVE)
    for chan, r in zip(chans, got):
        one = teng.acquire_signal(ts, torch.from_numpy(x), [0],
                                  doppler_search=GRID, ms=ms, chan=chan)[0]
        assert (one.doppler, one.code_offset, one.metric) == \
            (r.doppler, r.code_offset, r.metric)


def test_fdma_bands_do_not_depend_on_the_chunking(batched):
    from gnss_dsp_tpu_torch.acquire import engine as teng

    _, ts, x, ms = batched
    chans = [-3, -2, 2, 5]
    n = int(ts.acq_fs * 1e-3)
    dops, fixed = teng.fdma_grid(ts, GRID, chans)
    cf = torch.from_numpy(teng.build_code_ffts(ts, (0,), n, n)
                          .astype(np.complex64))
    runs = [teng.grid_search(torch.from_numpy(x), cf, torch.from_numpy(fixed),
                             n=n, window=n, blocks=ms, peak_mean=False,
                             dop_chunk=c, group=len(dops[0]))
            for c in (None, 1, 7, 13, 80)]
    assert runs[0][0].shape == (1, 4)
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)
    # each band's index counts within its own 20 dopplers
    idx = runs[0][2][0].numpy()
    assert ((idx >= 0) & (idx < 20)).all()


def test_acquire_signal_chan_matches_jax():
    from gnss_dsp_tpu.acquire import engine as jeng
    from gnss_dsp_tpu_torch.acquire import engine as teng

    js, ts = _sigs()
    ms = 24
    x = make_iq(js, js.acq_fs, ms + 4, 1500.0, 100.0, -3)
    grid = (500.0, 2500.0, 200.0)
    want = jeng.acquire_signal(js, x, [0], doppler_search=grid, ms=ms,
                               chan=-3)
    got = teng.acquire_signal(ts, torch.from_numpy(x), [0],
                              doppler_search=grid, ms=ms, chan=-3)
    _same_cells(want[0], got[0])
    np.testing.assert_allclose(got[0].metric, want[0].metric, rtol=1e-4)
    assert got[0].doppler == 1500.0
    assert abs(got[0].code_offset - 100.0) <= 1.0


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_coherent_chan_matches_jax(engine, monkeypatch):
    from gnss_dsp_tpu.acquire import coherent as jcoh
    from gnss_dsp_tpu_torch.acquire import coherent as tcoh

    if engine == "fused":
        monkeypatch.setenv("GNSS_DSP_PALLAS_INTERPRET", "1")
    js, ts = _sigs()
    chan, doppler, cp0 = -3, 40.0, 123.0
    x = make_iq(js, js.acq_fs, 14, doppler, cp0, chan)
    grid = (-90.0, 91.0, 30.0)
    for c in (chan, 0):
        want = jcoh.acquire_signal_coherent(js, x, [chan], grid, m_coh=8,
                                            ms=8, chan=c, engine=engine)[0]
        got = tcoh.acquire_signal_coherent(ts, torch.from_numpy(x), [chan],
                                           grid, m_coh=8, ms=8, chan=c,
                                           engine=engine)[0]
        if c == chan or engine == "xla":
            # the wrong band's surface is noise, whose argmax the JAX
            # kernel's bf16 inverse DFT moves between near-equal cells
            _same_cells(want, got)
        if c == chan:
            assert abs(got.doppler - doppler) <= 30.0
            assert abs(got.code_offset - cp0) < 1.0
            right = got.metric
        else:
            assert got.metric < right     # the wrong band misses
        np.testing.assert_allclose(got.metric, want.metric,
                                   rtol=1e-4 if engine == "xla" else 3e-2)
    assert got.linear is False and got.n_overlay == 1


@pytest.mark.parametrize("layout", [(8, 2), (8, 1)])
def test_fdma_sharded_matches_jax_sharded(layout):
    from gnss_dsp_tpu.parallel import acquire as jpar
    from gnss_dsp_tpu.parallel.mesh import make_mesh as jmesh
    from gnss_dsp_tpu_torch.acquire import engine as teng
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_fdma_sharded)
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    js, ts = _sigs()
    nd, nt = layout
    chans = list(range(-7, 8))
    ms = 8
    x = make_iq(js, js.acq_fs, ms + 4, 1500.0, 100.0, -3, cn0=45.0)
    kw = dict(doppler_search=(500.0, 2500.0, 250.0), ms=ms)
    want = jpar.acquire_signal_fdma_sharded(js, x, chans, jmesh(nd, nt),
                                            **kw)
    xt = torch.from_numpy(x)
    got = acquire_signal_fdma_sharded(
        ts, xt, chans, make_mesh(nd, nt, devices=["cpu"] * nd),
        dop_chunk=3, **kw)
    single = teng.acquire_signal_fdma(ts, xt, chans, **kw)
    assert [r.prn for r in got] == chans
    for a, b, c in zip(want, got, single):
        _same_cells(a, b)
        _same_cells(c, b)
        np.testing.assert_allclose(b.metric, a.metric, rtol=1e-5)
        np.testing.assert_allclose(b.metric, c.metric, rtol=1e-5)
    best = max(got, key=lambda r: r.metric)
    assert best.prn == -3 and abs(best.doppler - 1500.0) <= 250.0


def _run(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


def _same_rows(got, want, rtol=1e-5):
    """CLI rows: every field but the metric text for text, the metric
    within rtol."""
    assert len(got.splitlines()) == len(want.splitlines())
    for a, b in zip(want.splitlines(), got.splitlines()):
        fa, fb = a.split(), b.split()
        assert fb[:5] + fb[6:] == fa[:5] + fa[6:], (a, b)
        assert abs(float(fb[5]) - float(fa[5])) <= rtol * abs(float(fa[5]))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """4 ms of GLONASS L1 at the catalog's 16.384 MHz, channels -1 and 1
    live, noiseless."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import to_int8_iq

    sig = get_signal("glonass-l1")
    fs = 16.384e6
    x = (make_iq(sig, fs, 11, 600.0, 210.5, -1)
         + make_iq(sig, fs, 11, -400.0, 33.0, 1))
    path = tmp_path_factory.mktemp("fdma_cli") / "glonass_l1.iq"
    path.write_bytes(to_int8_iq(x, scale=20.0))
    return str(path), fs


@pytest.mark.parametrize("mesh", [[], ["--mesh", "8"]], ids=["one", "mesh"])
def test_fdma_cli_matches_jax_cli(capture, mesh):
    from gnss_dsp_tpu.cli import acquire as jcli
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    path, fs = capture
    args = mesh + ["--channel", "-2:2", "--doppler-search", "-1000,1000,200",
                   "--time", "4", path, "%d" % fs, "0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
        want = _run(jcli.main, "glonass-l1", args)
    got = _run(tcli.main, "glonass-l1", args + ["--device", "cpu"])
    _same_rows(got, want)
    rows = {int(r.split()[1]): r.split() for r in got.splitlines()}
    assert sorted(rows) == [-2, -1, 0, 1, 2]
    assert got.splitlines()[0].startswith("chan -2 doppler")
    for chan, dop, cp in ((-1, 600.0, 210.5), (1, -400.0, 33.0)):
        assert abs(float(rows[chan][3]) - dop) <= 100.0
        assert abs(float(rows[chan][7]) - cp) <= 1.0
