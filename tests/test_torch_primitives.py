"""The port's primitives (gnss_dsp_tpu_torch) against the JAX package on
the same numpy inputs: two-float arithmetic, the NCO, the discriminators,
int8 ingest, and the interop conversions.

Tolerances:
  * error-free transforms (two_sum, two_prod), DDS phases and table
    indices, int8 ingest, interop round-trips: exact;
  * two-float results that pass through a multiply-add (tf_mul_f,
    tf_add, tf_mod): the (hi + lo) value to 2^-40 relative — XLA may
    contract `e + x_lo*y` into one FMA where the port rounds twice;
  * oscillator values: 5e-7 absolute — the port reads one float64-
    rounded table, the JAX package evaluates float32 cos/sin at the
    float32-rounded angle idx*f32(2 pi/1024) (up to 4e-7 off near 2 pi);
  * discriminators: 1e-6 — XLA's float32 atan is within 0.8 ulp, torch's
    is correctly rounded more often (the JAX side runs in an interpreter
    of its own: _jax_discriminators).
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnss_dsp_tpu.ops import cplx as jcplx
from gnss_dsp_tpu.ops import nco as jnco
from gnss_dsp_tpu.utils import twofloat as jtf
from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.ops import cplx as tcplx
from gnss_dsp_tpu_torch.ops import discriminators as tdisc
from gnss_dsp_tpu_torch.ops import nco as tnco
from gnss_dsp_tpu_torch.utils import twofloat as ttf


def _f32(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.asarray(a)


def test_error_free_transforms_exact():
    rng = np.random.default_rng(1)
    a, b = _f32(rng, 4096, 1e3), _f32(rng, 4096, 1e-2)
    for fj, ft in ((jtf.two_sum, ttf.two_sum), (jtf.two_prod, ttf.two_prod)):
        rj = fj(jnp.asarray(a), jnp.asarray(b))
        rt = ft(_t(a), _t(b))
        for x, y in zip(rj, rt):
            np.testing.assert_array_equal(_j(x), y.numpy())


@pytest.mark.parametrize("op", ["tf_add", "tf_add_f", "tf_mul_f", "tf_mod"])
def test_twofloat_ops_match(op):
    rng = np.random.default_rng(2)
    n = 4096
    x64 = rng.uniform(0, 2046, n)
    hi = x64.astype(np.float32)
    lo = (x64 - hi).astype(np.float32)
    y = _f32(rng, n, 30.0)
    ylo = _f32(rng, n, 1e-6)
    xj, xt = (jnp.asarray(hi), jnp.asarray(lo)), (_t(hi), _t(lo))
    if op == "tf_add":
        rj = jtf.tf_add(xj, (jnp.asarray(y), jnp.asarray(ylo)))
        rt = ttf.tf_add(xt, (_t(y), _t(ylo)))
    elif op == "tf_add_f":
        rj, rt = jtf.tf_add_f(xj, jnp.asarray(y)), ttf.tf_add_f(xt, _t(y))
    elif op == "tf_mul_f":
        rj, rt = jtf.tf_mul_f(xj, jnp.asarray(y)), ttf.tf_mul_f(xt, _t(y))
    else:
        L = np.float32(1023.0)
        (rj, kj) = jtf.tf_mod(xj, L)
        (rt, kt) = ttf.tf_mod(xt, torch.full((n,), float(L)))
        np.testing.assert_array_equal(_j(kj), kt.numpy())
    vj = _j(rj[0]).astype(np.float64) + _j(rj[1])
    vt = rt[0].numpy().astype(np.float64) + rt[1].numpy()
    np.testing.assert_allclose(vt, vj, rtol=2.0**-40, atol=1e-12)


def test_tf_from_f64_identical():
    for v in (0.25, 1023.0 / 4.096e6, 1.023e6 / 2.048e6, np.pi):
        assert ttf.tf_from_f64(v) == jtf.tf_from_f64(v)


# float -> 32-bit fixed point at its edges (frac just below 1, tiny
# negative frequencies that round `mod 1` up to 1.0, signed zeros).
# Subnormal inputs are left out: XLA on the CPU flushes them to zero,
# and a carrier below 1e-32 Hz does not occur.
_EDGE_F = np.array([-1e-10, -2.5e-11, -0.0, 0.0, 0.99999994, 0.9999999,
                    1e-3, -1e-3, -0.5, 0.5, 0.49999997, -0.49999997,
                    1e-30, 3.9e-4, -4.4e-4], np.float32)


def test_freq_to_fixed_device_edges_exact():
    rng = np.random.default_rng(3)
    f = np.concatenate([_EDGE_F, rng.uniform(-0.01, 0.01, 2000)
                        .astype(np.float32)])
    want = _j(jnco.freq_to_fixed_jnp(jnp.asarray(f))).astype(np.int64)
    got = tnco.freq_to_fixed_t(_t(f)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -2**31 and got.max() < 2**31


def test_freq_to_fixed_host_identical():
    for f in (-1250.0 / 2.048e6, 900.0 / 4.096e6, -0.3, 0.7, -1e-12, 0.0):
        assert tnco.freq_to_fixed(f) == jnco.freq_to_fixed(f)


def test_phase_indices_exact():
    n = 3000
    dfs = np.array([jnco.freq_to_fixed(v) for v in
                    (-1250.0 / 2.048e6, 900.0 / 4.096e6, -0.49, 0.49)])
    p0s = np.array([0, 2**31 + 12345, 2**32 - 1, 7 << 22], np.int64)
    for df in dfs:
        for p0 in p0s:
            want = _j(jnco.phase_indices(jnp.int32(df), jnp.uint32(p0), n))
            got = tnco.phase_indices(torch.tensor(int(df)),
                                     torch.tensor(int(p0)), n)
            np.testing.assert_array_equal(got.numpy(), want)


def test_oscillator_and_mix_match():
    rng = np.random.default_rng(5)
    n = 5000
    df, p0 = jnco.freq_to_fixed(-3125.0 / 4.096e6), (3 << 30) + 99
    wc, ws = jnco.nco_split(jnp.int32(df), jnp.uint32(p0), n)
    w = tnco.nco_wave(torch.tensor(df), torch.tensor(p0), n)
    np.testing.assert_allclose(w.real.numpy(), _j(wc), rtol=0, atol=5e-7)
    np.testing.assert_allclose(w.imag.numpy(), _j(ws), rtol=0, atol=5e-7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    yj = jcplx.to_numpy(jnco.mix_split(jcplx.from_numpy(x), jnp.int32(df),
                                       jnp.uint32(p0)))
    yt = tnco.mix(_t(x), torch.tensor(df), torch.tensor(p0)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=5e-6)


def test_lut_is_the_rounded_float64_table():
    lut = tnco.lut_cos_sin("cpu").numpy()
    ang = 2 * np.pi * np.arange(1024) / 1024
    np.testing.assert_array_equal(lut[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(lut[:, 1], np.sin(ang).astype(np.float32))


def test_boc11_host_identical():
    for args in ((0, 0, 1023 / 4096, 4096), (3.5, 0.25, 0.37, 777)):
        np.testing.assert_array_equal(tnco.boc11_host(*args),
                                      jnco.boc11_host(*args))


# the JAX package's discriminators on the arrays of argv[1]'s npz, into
# argv[2]: run in an interpreter of its own (_jax_discriminators)
_JAX_DISC = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from gnss_dsp_tpu.ops import discriminators as jdisc
a = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
pll = jdisc.pll_costas((a["re"], a["im"]))
fll = jdisc.fll_atan((a["re"], a["im"]), (a["re1"], a["im1"]))
np.savez(sys.argv[2], pll=np.asarray(pll), fll=np.asarray(fll))
"""


def _jax_discriminators(tmp_path, **arrays):
    """(pll_costas, fll_atan) of gnss_dsp_tpu.ops.discriminators on the
    float32 arrays re, im, re1, im1, computed in a fresh interpreter with
    JAX on the CPU and no persistent compile cache.  In the test process
    itself the JAX executables depend on what other test files did
    before in the same worker: the JAX CLIs that tests call in-process
    switch on the persistent compile cache for the whole process (with
    no minimum compile time, so every eager primitive is served from the
    shared disk cache), and under the tier-1 run fll_atan once came out
    up to 1.7e-4 off in a third of its elements."""
    src, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", GNSS_DSP_NO_COMPILE_CACHE="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    subprocess.run([sys.executable, "-c", _JAX_DISC, str(src), str(out)],
                   cwd=root, env=env, check=True, timeout=300)
    r = np.load(out)
    return r["pll"], r["fll"]


def test_discriminators_match(tmp_path):
    rng = np.random.default_rng(6)
    n = 5000
    re, im = _f32(rng, n, 100.0), _f32(rng, n, 100.0)
    re[:10] = 0.0                      # the reference's Re == 0 branch
    re1, im1 = _f32(rng, n, 100.0), _f32(rng, n, 100.0)
    re1[10:20] = 0.0
    pj, fj = _jax_discriminators(tmp_path, re=re, im=im, re1=re1, im1=im1)
    pt = tdisc.pll_costas((_t(re), _t(im))).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    ft = tdisc.fll_atan((_t(re), _t(im)), (_t(re1), _t(im1))).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-6)
    assert np.abs(ft).max() <= np.pi / 2 + 1e-6


@pytest.mark.parametrize("pad", [0, 1000])
def test_int8_ingest_exact(pad):
    rng = np.random.default_rng(7)
    raw = rng.integers(-128, 128, 2 * 4321).astype(np.int8)
    xr, xi = jcplx.from_int8_iq(raw.tobytes(), pad=pad)
    x = tcplx.from_int8_iq(raw.tobytes(), pad=pad, device="cpu")
    assert x.dtype == torch.complex64 and x.shape[0] == 4321 + pad
    np.testing.assert_array_equal(x.real.numpy(), _j(xr))
    np.testing.assert_array_equal(x.imag.numpy(), _j(xi))


def test_interop_state_round_trip():
    from gnss_dsp_tpu.track.engine import init_state

    st = init_state(code_p=[5.0, 1022.75], code_f_off=[0.0, 1e-3],
                    carrier_p=[0.1, 0.9], carrier_f=[900.0, -2200.0],
                    ptr=[3, 4])
    st = st._replace(coffset_p=jnp.asarray(
        np.array([2**31 + 5, 2**32 - 1], np.uint32)))
    t = interop.state_from_numpy(st)
    assert t.coffset_p.dtype == torch.int64
    assert int(t.coffset_p[1]) == 2**32 - 1
    back = interop.state_to_numpy(t)
    for k, v in back.items():
        np.testing.assert_array_equal(v, _j(getattr(st, k)), err_msg=k)
    assert back["coffset_p"].dtype == np.uint32


def test_interop_params_match_port_make_params():
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.track.driver import make_params as jmake
    from gnss_dsp_tpu_torch.track.driver import make_params as tmake

    # the reference's kernel route on GPS L1: K2 (fused_scan) and, on the
    # per-step route, K3 (pallas_v2)
    sig = get_signal("gps-l1")
    for args in ((4.096e6, 0.0, (500, 500)), (2.048e6, 1250.0, (8, 8))):
        pj = jmake(sig, args[0], coffset=args[1], loop_dwells=args[2],
                   use_pallas=True)
        assert pj.fused_scan and pj.pallas_v2
        assert interop.params_from_jax(pj) == tmake(
            sig, args[0], coffset=args[1], loop_dwells=args[2])


def test_interop_unpermutes_v2_spectra():
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    rng = np.random.default_rng(8)
    W = 1024
    n1, n2 = pa2.plan_aligned(W)
    c = (rng.standard_normal((3, W)) + 1j * rng.standard_normal((3, W))
         ).astype(np.complex64)
    cp = pa2.permute_host2(c, n1, n2)
    got = interop.code_ffts_from_split(cp.real, cp.imag, plan=("v2", n1, n2))
    np.testing.assert_array_equal(got.numpy(), c)
    got = interop.code_ffts_from_split(c.real, c.imag)
    np.testing.assert_array_equal(got.numpy(), c)
