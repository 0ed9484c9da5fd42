"""The port's tracking scan (plain version of kernel K2, vectorised over
channels) against the JAX package's track_scan, on the setup of
tests/test_fused_scan.py: GPS L1 at 2.048 MHz, carrier offset 1250 Hz,
loop dwells (8, 8) so the PLL runs from block 16, 40 blocks, noiseless.

Tolerances:
  * int rows (n, carrier_dcyc, code_dcyc) and ptr/block/stalled/coffset_p
    state: exact;
  * against the JAX XLA scan, every float row field and float state leaf:
    rtol 2e-5, atol 2e-4 (the reference's own engine-to-engine tolerance);
  * against the JAX fused Pallas kernel (interpret mode): loop-state floats
    as above; the correlator-derived fields (p_re, p_im, early, prompt,
    late) to 2^-8 of the block's prompt envelope and phase_deg to
    2^-8 rad — that kernel rounds the wiped samples to bf16 before its
    MXU dot (pallas_track2.py:180-181), 2^-9 relative per sample.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnss_dsp_tpu.models import get_signal
from gnss_dsp_tpu.ops import nco as jnco
from gnss_dsp_tpu.track import engine as jeng
from gnss_dsp_tpu.track.driver import build_code_rows, make_params
from gnss_dsp_tpu.utils import synth
from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.track import engine as teng

FS = 2.048e6
COFFSET = 1250.0
_PRNS = [7, 13]
_DOPS = [900.0, -2200.0]
_PHASES = [5.0, 417.25]
_EXACT_STATE = ("ptr", "block", "stalled", "coffset_p", "n_full", "sub_j")
_FLOAT_STATE = ("code_p_hi", "code_p_lo", "code_f_off", "carrier_p",
                "carrier_f", "prompt1_re", "prompt1_im", "carrier_e1",
                "code_e1", "cacc")
_CORR_FIELDS = (1, 2, 6, 7, 8)        # p_re, p_im, early, prompt, late
_PHASE_FIELD = 5


def _setup(C, pallas, phases=None, seconds=0.06):
    sig = get_signal("gps-l1")
    prns, dops = _PRNS[:C], _DOPS[:C]
    phases = list(phases or _PHASES[:C])
    n = int(FS * seconds)
    code = sig.code_table(tuple(prns))
    x = sum(synth.synth_iq(code[i].astype(np.float64), sig.chip_rate, FS, n,
                           doppler_hz=d, code_phase=cp, cn0_dbhz=None,
                           carrier_ratio=1540.0)
            for i, (d, cp) in enumerate(zip(dops, phases)))
    x = (x * np.exp(2j * np.pi * COFFSET / FS * np.arange(n))
         ).astype(np.complex64)
    params = make_params(sig, FS, coffset=COFFSET, loop_dwells=(8, 8),
                         use_pallas=pallas, chan=prns[0])
    code_np = code.astype(np.int8)
    rows_ext = None
    pad = params.nmax
    if pallas:
        rows_np, pad = build_code_rows(code_np, params, sig.chip_rate / FS)
        rows_ext = jnp.asarray(rows_np)
    tail = pad + (-(n + pad)) % 1024
    xp = np.concatenate([x, np.zeros(tail, np.complex64)])
    st = jeng.init_state(code_p=phases, code_f_off=[0.0] * C,
                         carrier_p=[0.0] * C, carrier_f=dops)
    cdf = np.array([jnco.freq_to_fixed(-COFFSET / FS)] * C, np.int32)
    return dict(params=params, xp=xp, n=n, code=code_np, st=st,
                rows_ext=rows_ext, cdf=cdf, C=C)


def _run_jax(s, nb, chunk_len=None, st=None):
    xd = (jnp.asarray(s["xp"].real.copy()), jnp.asarray(s["xp"].imag.copy()))
    st2, rf, ri = jeng.track_scan(
        xd, jnp.int32(chunk_len or s["n"]), jnp.asarray(s["code"]),
        st if st is not None else s["st"], s["params"], nb,
        ratios=jnp.full((s["C"],), 1540.0, jnp.float32),
        code_rows_ext=s["rows_ext"], coffset_df=jnp.asarray(s["cdf"]))
    return st2, np.asarray(rf), np.asarray(ri)


def _run_port(s, nb, chunk_len=None, st=None):
    st2, rf, ri = teng.track_scan(
        torch.from_numpy(s["xp"]), chunk_len or s["n"],
        torch.from_numpy(s["code"]),
        st if st is not None else interop.state_from_numpy(s["st"], device="cpu"),
        interop.params_from_jax(s["params"]), nb,
        ratios=torch.full((s["C"],), 1540.0),
        coffset_df=torch.from_numpy(s["cdf"]))
    return st2, rf.numpy(), ri.numpy()


def _check_state(st_j, st_t, exact_only=False):
    got = interop.state_to_numpy(st_t)
    for k in _EXACT_STATE:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(st_j, k)),
                                      err_msg=k)
    if not exact_only:
        for k in _FLOAT_STATE:
            np.testing.assert_allclose(got[k], np.asarray(getattr(st_j, k)),
                                       rtol=2e-5, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("C", [1, 2])
def test_plain_scan_matches_jax_xla_scan(C):
    s = _setup(C, pallas=False)
    assert not s["params"].use_pallas
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    assert rf_t.shape == (40, C, 11) and ri_t.shape == (40, C, 3)
    assert (ri_t[:, :, 0] > 0).all()
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    _check_state(st_j, st_t)


@pytest.mark.parametrize("C", [1, 2])
def test_plain_scan_matches_jax_fused_kernel_interpret(C, monkeypatch):
    monkeypatch.setenv("GNSS_DSP_PALLAS_INTERPRET", "1")
    s = _setup(C, pallas=True)
    assert s["params"].fused_scan and s["params"].pallas_v2
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    np.testing.assert_array_equal(ri_t, ri_j)
    loop = [f for f in range(11) if f not in _CORR_FIELDS + (_PHASE_FIELD,)]
    np.testing.assert_allclose(rf_t[..., loop], rf_j[..., loop],
                               rtol=2e-5, atol=2e-4)
    env = rf_j[..., 7:8]
    assert np.all(np.abs(rf_t[..., _CORR_FIELDS] - rf_j[..., _CORR_FIELDS])
                  <= 2.0**-8 * env)
    dphase = np.abs(rf_t[..., _PHASE_FIELD] - rf_j[..., _PHASE_FIELD])
    assert np.all(np.minimum(dphase, 360.0 - dphase)
                  <= np.degrees(2.0**-8))
    _check_state(st_j, st_t, exact_only=True)
    got = interop.state_to_numpy(st_t)
    for k in ("code_p_hi", "code_f_off", "carrier_p", "carrier_f"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(st_j, k)),
                                   rtol=2e-5, atol=2e-4, err_msg=k)


def test_stall_and_refill_match_jax():
    """Mid-scan chunk exhaustion: the channel freezes (NaN/0 rows,
    stalled latched) like the reference, and the refill continues where
    the reference's uninterrupted run does."""
    s = _setup(1, pallas=False)
    nb = 40
    short = int(FS * 0.020)
    _, rf_a, ri_a = _run_jax(s, nb)
    st1, rf_1, ri_1 = _run_port(s, nb, chunk_len=short)
    n1 = int((ri_1[:, 0, 0] > 0).sum())
    assert 15 <= n1 < 25, n1
    assert bool(st1.stalled[0])
    assert np.isnan(rf_1[n1:, :, 0]).all() and (ri_1[n1:] == 0).all()
    st1 = st1._replace(stalled=torch.zeros_like(st1.stalled))
    _, rf_2, ri_2 = _run_port(s, nb - n1, st=st1)
    np.testing.assert_array_equal(ri_1[:n1], ri_a[:n1])
    np.testing.assert_array_equal(ri_2, ri_a[n1:])
    np.testing.assert_allclose(rf_1[:n1], rf_a[:n1], rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(rf_2, rf_a[n1:], rtol=2e-5, atol=2e-4)


def test_early_lag_wraps_at_code_phase_zero():
    """At code phase ~0 the early lag's integer chip is -1, which must
    read chip L-1 (floor-mod), as the reference's jnp.mod does."""
    s = _setup(1, pallas=False, phases=[0.01])
    st_j, rf_j, ri_j = _run_jax(s, 6)
    st_t, rf_t, ri_t = _run_port(s, 6)
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    _check_state(st_j, st_t)


def test_track_scan_requires_a_tail_pad():
    """The reference's dynamic_slice clamps a window that runs past
    the chunk; the port demands a tail pad of >= nmax instead, so both
    always read the same samples."""
    s = _setup(1, pallas=False)
    with pytest.raises(ValueError, match="tail pad"):
        _run_port(s, 2, chunk_len=len(s["xp"]) - s["params"].nmax + 1)


# subcarriers, sub-blocks and the coherent lanes: once refused, now
# tracked on every route; each against the JAX XLA scan (on the CPU the
# port runs the plain version whatever fused_scan says)
@pytest.mark.parametrize("change", [dict(subcarrier="boc11", fused_scan=True),
                                    dict(sub=4, fused_scan=True),
                                    dict(coh_blocks=4)])
def test_former_refusals_match_jax_scan(change):
    s = _setup(2, pallas=False)
    s["params"] = s["params"]._replace(**change)
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    assert (ri_t[:, :, 0] > 0).all()
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    _check_state(st_j, st_t)


def test_unported_modes_raise():
    """Unknown-code recovery, the one mode the port once refused, now runs
    (the plain scan, the reference's route for it): recovery after block
    10 with a bin a chip, the rows and state against the JAX XLA scan's
    as above, the bins visited by both within rtol 1e-5 (atol a few ulps
    of the largest bin) and the same bins visited."""
    s = _setup(1, pallas=False)
    p = s["params"]._replace(recover_after=10)
    L = s["code"].shape[1]
    st_j0 = s["st"]._replace(acc_re=jnp.zeros((1, L), jnp.float32),
                             acc_im=jnp.zeros((1, L), jnp.float32))
    s = dict(s, params=p, st=st_j0)
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    _check_state(st_j, st_t)
    got = interop.state_to_numpy(st_t)
    for k in ("acc_re", "acc_im"):
        want = np.asarray(getattr(st_j, k))
        visited = want != 0
        assert visited.mean() > 0.9
        np.testing.assert_array_equal(got[k] != 0, visited)
        np.testing.assert_allclose(got[k][visited], want[visited], rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
