"""The port's assisted serial searches (gnss_dsp_tpu_torch.acquire.serial,
GPS L2CL and GLONASS P) against the JAX package on the CPU, at the sizes of
tests/test_parallel.py (L2CL at 2.048 MHz over 40 ms, GLONASS P at
4.096 MHz over 12 ms on FDMA channel 2).

  * hypothesis_geometry bit-equal to the JAX one (the int32 / float32
    split of the float64 start chips);
  * the [K, B, n] chip indices of both programs equal: 0 of 6,144,000
    (L2CL) and 0 of 49,152,000 (GLONASS P) differ, so the JAX program's
    float32 s_frac + i * incr rounds as the port's on these geometries;
  * serial_search: k and code_offset exact; q (every hypothesis, from
    the same chunks) within rtol 5e-5 of the JAX q: the port sums each
    block in float64 and rounds q once, the JAX package sums 40960 or
    16384 float32 products in float32 (largest difference seen 1.3e-5,
    on the small q of the wrong hypotheses), and its oscillator table's
    float32 cos/sin may differ from the port's by one ulp;
  * q does not depend on the chunk of hypotheses (bit for bit);
  * serial_search_sharded on 8 CPU shards against the JAX twin on its 8
    virtual devices: k exact, metric rtol 5e-5, and bit for bit the
    port's single-device search;
  * the serial CLI against the JAX CLI: the code phase field text for
    text, the metric within rtol 5e-5 ("%f" prints the float32 metric to
    1e-6, below the two programs' float32 rounding).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

RTOL = 5e-5

# (signal, prn/chan, fs, ms, k_true, parent code phase, doppler, chan)
CASES = {"l2cl": ("gps-l2cl", 5, 2.048e6, 40, 31, 1234.0, 250.0, 0),
         "glonass_p": ("glonass-l1-p", 2, 4.096e6, 12, 417, 33.0, -700.0, 2)}


def _case(case):
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu.utils.synth import synth_iq
    from gnss_dsp_tpu_torch.models import get_signal

    name, prn, fs, ms, k_true, pp, dop, chan = CASES[case]
    js = jsig(name)
    phase = float((k_true * js.acq_serial_stride + js.acq_serial_scale * pp)
                  % js.code_length)
    x = synth_iq(js.code_table((prn,))[0], js.chip_rate, fs,
                 int(fs * (ms + 4) / 1000.0),
                 doppler_hz=dop + js.fdma_hz * chan, code_phase=phase,
                 cn0_dbhz=None, carrier_ratio=js.track_carrier_ratio(chan),
                 code_doppler_hz=dop)
    return dict(js=js, ts=get_signal(name), prn=prn, fs=fs, ms=ms,
                k_true=k_true, pp=pp, dop=dop, chan=chan, x=x, phase=phase)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(request.param)


def test_hypothesis_geometry_matches_jax(case):
    from gnss_dsp_tpu.acquire import serial as jser
    from gnss_dsp_tpu_torch.acquire import serial as tser

    c = case
    # at 2.04814 MHz a 4 ms or 20 ms block is 8192.56 or 40962.8 samples:
    # n truncates them
    for fs, ms in ((c["fs"], c["ms"]), (c["fs"], c["ms"] + 40),
                   (2.04814e6, c["ms"])):
        want = jser.hypothesis_geometry(c["js"], fs, ms, c["pp"])
        got = tser.hypothesis_geometry(c["ts"], fs, ms, c["pp"])
        for f in ("blocks", "n", "incr", "L", "stride", "phase0"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.s_int.dtype == np.int32 and got.s_frac.dtype == np.float32
        np.testing.assert_array_equal(got.s_int, want.s_int)
        np.testing.assert_array_equal(got.s_frac, want.s_frac)
    assert got.n == round(fs * c["ts"].acq_serial_coh_ms / 1000.0) - 1


def test_code_indices_match_jax(case):
    import jax
    import jax.numpy as jnp

    from gnss_dsp_tpu_torch.acquire import serial as tser

    c = case
    g = tser.hypothesis_geometry(c["ts"], c["fs"], c["ms"], c["pp"])
    n, L = g.n, g.L

    @jax.jit
    def jax_idx(s_int, s_frac, incr):        # acquire/serial.hypothesis_q
        i = jax.lax.broadcasted_iota(jnp.float32, (1, 1, n), 2)
        cp = s_frac[:, :, None] + i * incr
        return jnp.mod(s_int[:, :, None] + jnp.floor(cp).astype(jnp.int32), L)

    want = np.asarray(jax_idx(jnp.asarray(g.s_int), jnp.asarray(g.s_frac),
                              jnp.float32(g.incr)))
    got = tser.code_indices(torch.from_numpy(g.s_int),
                            torch.from_numpy(g.s_frac), g.incr, n, L)
    assert int((got.numpy().transpose(1, 0, 2) != want).sum()) == 0


def _jax_q(c, g):
    import jax.numpy as jnp

    from gnss_dsp_tpu.acquire import serial as jser

    xw = jser.wipe_blocks(c["js"], c["x"], c["dop"], c["fs"], c["chan"], g)
    tab = jnp.asarray(c["js"].code_table((c["prn"],))[0].astype(np.int8))
    return np.asarray(jser._serial_chunk(
        xw, tab, jnp.asarray(g.s_int), jnp.asarray(g.s_frac),
        jnp.float32(g.incr), n=g.n, L=g.L))


def test_serial_search_matches_jax(case):
    from gnss_dsp_tpu.acquire import serial as jser
    from gnss_dsp_tpu_torch.acquire import serial as tser

    c = case
    kw = dict(parent_code_phase=c["pp"], fs=c["fs"], ms=c["ms"],
              chan=c["chan"])
    want = jser.serial_search(c["js"], c["x"], c["prn"], c["dop"], **kw)
    x = torch.from_numpy(c["x"])
    got = tser.serial_search(c["ts"], x, c["prn"], c["dop"], **kw)
    assert got.k == want.k == c["k_true"]
    assert got.code_offset == want.code_offset
    assert abs(got.code_offset - c["phase"]) < 1e-6
    assert (got.prn, got.doppler) == (c["prn"], c["dop"])
    np.testing.assert_allclose(got.metric, want.metric, rtol=RTOL)
    g = tser.hypothesis_geometry(c["ts"], c["fs"], c["ms"], c["pp"])
    xw = tser.wipe_blocks(c["ts"], x, c["dop"], c["fs"], c["chan"], g)
    tab = tser.device_code(c["ts"], c["prn"], "cpu")
    q = [tser.chunked_q(xw, tab, g.s_int, g.s_frac, g, k).numpy()
         for k in (tser.default_k_chunk(len(g.s_int), g), 64)]
    assert q[0].dtype == np.float32 and q[0].shape == (len(g.s_int),)
    assert all(np.array_equal(q[0], other) for other in q[1:])
    assert float(q[0][got.k]) == got.metric
    np.testing.assert_allclose(q[0], _jax_q(c, g), rtol=RTOL)


def test_serial_search_refuses_a_short_capture():
    from gnss_dsp_tpu_torch.acquire import serial as tser

    c = _case("l2cl")
    x = torch.from_numpy(c["x"][:80000])
    with pytest.raises(ValueError, match="81920"):
        tser.serial_search(c["ts"], x, c["prn"], c["dop"],
                           parent_code_phase=c["pp"], fs=c["fs"], ms=c["ms"])


@pytest.mark.parametrize("layout", [(8, 2), (8, 1)])
def test_serial_sharded_matches_jax_sharded(case, layout):
    from gnss_dsp_tpu.parallel import acquire as jpar
    from gnss_dsp_tpu.parallel.mesh import make_mesh as jmesh
    from gnss_dsp_tpu_torch.acquire import serial as tser
    from gnss_dsp_tpu_torch.parallel.acquire import serial_search_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    c = case
    nd, nt = layout
    kw = dict(parent_code_phase=c["pp"], fs=c["fs"], ms=c["ms"],
              chan=c["chan"], k_chunk=5)
    want = jpar.serial_search_sharded(c["js"], c["x"], c["prn"], c["dop"],
                                      mesh=jmesh(nd, nt), **kw)
    x = torch.from_numpy(c["x"])
    got = serial_search_sharded(c["ts"], x, c["prn"], c["dop"],
                                mesh=make_mesh(nd, nt, devices=["cpu"] * nd),
                                **kw)
    kw.pop("k_chunk")
    single = tser.serial_search(c["ts"], x, c["prn"], c["dop"], **kw)
    assert got.k == want.k == single.k == c["k_true"]
    assert got.code_offset == want.code_offset == single.code_offset
    assert got.metric == single.metric
    np.testing.assert_allclose(got.metric, want.metric, rtol=RTOL)


def _run(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


@pytest.mark.parametrize("name", sorted(CASES))
def test_serial_cli_matches_jax_cli(name, tmp_path):
    """The CLI reads the native-rate capture, wipes a carrier offset of
    2.5 kHz off it and runs the search: one "code_phase metric" row."""
    from gnss_dsp_tpu.cli import acquire as jcli
    from gnss_dsp_tpu.utils.synth import to_int8_iq
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    c = _case(name)
    coff = 2500.0
    t = np.arange(len(c["x"]))
    x = c["x"] * np.exp(2j * np.pi * coff / c["fs"] * t).astype(np.complex64)
    path = tmp_path / f"{name}.iq"
    path.write_bytes(to_int8_iq(x, scale=30.0))
    args = ["--time", str(c["ms"]), str(path), "%d" % c["fs"], str(coff),
            str(c["prn"]), str(c["dop"]), str(c["pp"])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
        want = _run(jcli.main, c["js"].name, args).split()
    got = _run(tcli.main, c["ts"].name, args + ["--device", "cpu"]).split()
    assert len(got) == len(want) == 2
    assert got[0] == want[0]
    assert float(got[0]) == (c["k_true"] * c["ts"].acq_serial_stride
                             + c["ts"].acq_serial_scale * c["pp"])
    assert abs(float(got[1]) - float(want[1])) <= RTOL * float(want[1])
