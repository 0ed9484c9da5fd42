"""The port's per-step tracking scan on the subcarrier, sub-block and
long-code families against the JAX package's track_scan, and the track
CLI on one of them.

Setup: noiseless captures of each signal (its subcarrier; GLONASS P one
FDMA channel, its offset in the carrier and its wipe in coffset_df),
loop dwells (8, 8) so the PLL runs from block 16, 40 sub-blocks of 1 ms,
the same sigp rows to both packages.

Tolerances, as tests/test_torch_track.py holds GPS L1:
  * int rows (n, carrier_dcyc, code_dcyc) and ptr/block/stalled/coffset_p/
    n_full/sub_j state: exact;
  * against the JAX XLA scan, every float row field and float state leaf:
    rtol 2e-5, atol 2e-4 (the reference's engine-to-engine tolerance);
  * against the JAX per-step Pallas route (in test_torch_track_step.py,
    with this file's setup: K3, or K4 under
    GNSS_DSP_PALLAS_V1; interpret mode): loop-state floats as above; the
    correlator fields to 2^-8 of the block's prompt envelope and
    phase_deg to 2^-8 rad -- those kernels round the wiped samples times
    the factor to bf16 (pallas_track2.py:180-181, 206-207), and on a
    noiseless capture that rounding is systematic;
    code_f_minus_nominal, the DLL's output, to 2e-4 plus that bound
    carried through the DLL: e_dll = (L - E)/(L + E) moves by at most
    d = 2 * 2^-8 * P / (E + L), so block b's code_f_off by at most
    (dll_k2 + (b + 1) dll_k1) max d (the subcarrier families' E or L can
    be a third of P, where the bf16 error reaches 4e-4 Hz).

The channels are ones whose loops pull in within the 40 blocks: in mid
pull-in a PLL amplifies float32 rounding differences in its phase.
"""

import contextlib
import io

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

_EXACT_STATE = ("ptr", "block", "stalled", "coffset_p", "n_full", "sub_j")
_FLOAT_STATE = ("code_p_hi", "code_p_lo", "code_f_off", "carrier_p",
                "carrier_f", "prompt1_re", "prompt1_im", "carrier_e1",
                "code_e1")
_CORR_FIELDS = (1, 2, 6, 7, 8)        # p_re, p_im, early, prompt, late
_PHASE_FIELD = 5
_DLL_FIELD = 4                        # code_f_minus_nominal
COFFSET = 1250.0

# name: (fs, [(prn, doppler, code phase at sample 0)]); L2CL and GLONASS P
# start anywhere in their 1.5 s and 1 s codes (no alignment here)
_CASES = {
    "galileo-e1b": (2.048e6, [(11, 900.0, 5.0), (24, 1900.0, 1500.75)]),
    "gps-l1cp": (2.048e6, [(18, 1500.0, 0.01), (5, -700.0, 6000.5)]),
    "gps-l2cm": (2.048e6, [(29, 1120.0, 4208.8)]),
    "gps-l2cl": (2.048e6, [(5, 800.0, 760000.0)]),
    "glonass-l1-p": (8.192e6, [(2, -1300.0, 1234567.5)]),
    "gps-l1": (2.048e6, [(7, 900.0, 5.0), (13, -2200.0, 417.25)]),
}


def _setup(name, pallas, seconds=0.05, cn0=None, case=None):
    sig = get_signal(name)
    fs, chans = case or _CASES[name]
    C = len(chans)
    prns = [c[0] for c in chans]
    n = int(fs * seconds)
    code = sig.code_table(tuple(prns)).astype(np.int8)
    x = sum(synth.synth_iq(code[k].astype(np.float64), sig.chip_rate, fs, n,
                           doppler_hz=d + sig.fdma_hz * p, code_phase=cp,
                           cn0_dbhz=cn0, subcarrier=sig.subcarrier,
                           carrier_ratio=sig.track_carrier_ratio(p),
                           code_doppler_hz=d,
                           rng=np.random.default_rng(k))
            for k, (p, d, cp) in enumerate(chans))
    x = (x * np.exp(2j * np.pi * COFFSET / fs * np.arange(n))
         ).astype(np.complex64)
    params = make_params(sig, fs, coffset=COFFSET, loop_dwells=(8, 8),
                         use_pallas=pallas, chan=prns[0])
    rows_ext, pad = None, params.nmax
    if pallas:
        rows_np, pad = build_code_rows(code, params, sig.chip_rate / fs)
        rows_ext = jnp.asarray(rows_np)
    tail = pad + (-(n + pad)) % 1024
    xp = np.concatenate([x, np.zeros(tail, np.complex64)])
    st = jeng.init_state(code_p=[c[2] for c in chans], code_f_off=[0.0] * C,
                         carrier_p=[0.0] * C, carrier_f=[c[1] for c in chans])
    cdf = np.array([jnco.freq_to_fixed(-(COFFSET + sig.fdma_hz * p) / fs)
                    for p in prns], np.int32)
    ratios = np.array([sig.track_carrier_ratio(p) for p in prns], np.float32)
    sigp = np.stack([jeng.sigp_row(
        *jeng.tf.tf_from_f64(np.float64(sig.chip_rate) / np.float64(fs)),
        sig.el_spacing, sig.code_length, fs * 0.001 * sig.code_period_ms,
        sig.sub_blocks, sig.subcarrier)] * C)
    return dict(params=params, xp=xp, n=n, code=code, st=st,
                rows_ext=rows_ext, cdf=cdf, ratios=ratios, sigp=sigp, C=C)


def _run_jax(s, nb):
    xd = (jnp.asarray(s["xp"].real.copy()), jnp.asarray(s["xp"].imag.copy()))
    st, rf, ri = jeng.track_scan(
        xd, jnp.int32(s["n"]), jnp.asarray(s["code"]), s["st"], s["params"],
        nb, ratios=jnp.asarray(s["ratios"]), code_rows_ext=s["rows_ext"],
        coffset_df=jnp.asarray(s["cdf"]), sigp=jnp.asarray(s["sigp"]))
    return st, np.asarray(rf), np.asarray(ri)


def _run_port(s, nb):
    t = torch.from_numpy
    st, rf, ri = teng.track_scan(
        t(s["xp"]), s["n"], t(s["code"]), interop.state_from_numpy(s["st"], device="cpu"),
        interop.params_from_jax(s["params"]), nb, ratios=t(s["ratios"]),
        coffset_df=t(s["cdf"]), sigp=t(s["sigp"]))
    return st, rf.numpy(), ri.numpy()


def _check_state(st_j, st_t, floats=_FLOAT_STATE):
    got = interop.state_to_numpy(st_t)
    for k in _EXACT_STATE:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(st_j, k)),
                                      err_msg=k)
    for k in floats:
        np.testing.assert_allclose(got[k], np.asarray(getattr(st_j, k)),
                                   rtol=2e-5, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", ["galileo-e1b", "gps-l1cp", "gps-l2cm",
                                  "gps-l2cl", "glonass-l1-p"])
def test_step_scan_matches_jax_xla_scan(name):
    s = _setup(name, pallas=False)
    p = interop.params_from_jax(s["params"])
    assert not p.fused_scan
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    assert (ri_t[:, :, 0] > 0).all()
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    _check_state(st_j, st_t)


# the long codes 10 ms before their end: the code period wraps at block ~10
_WRAP = {"gps-l2cl": (2.048e6, [(5, 800.0, 767250 - 5115.0)]),
         "glonass-l1-p": (8.192e6, [(2, -1300.0, 5110000 - 51100.0)])}


@pytest.mark.parametrize("name", sorted(_WRAP))
def test_long_code_wrap_matches_jax_xla_scan(name):
    """The code-period wrap of L2CL (767,250 chips) and GLONASS P
    (5,110,000): code_dcyc counts the wrap, the chip index wraps mod L."""
    s = _setup(name, pallas=False, case=_WRAP[name])
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    L = get_signal(name).code_length
    assert (ri_t[:, :, 0] > 0).all()
    assert (ri_t[:, 0, 2] == L).sum() == 1          # one wrap
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    _check_state(st_j, st_t)


@pytest.mark.parametrize("sub", ["none", "boc11", "cboc", "tmboc",
                                 "rz_even", "rz_odd"])
def test_sigp_rows_match_jax(sub):
    """The subcarrier lanes (a0, a1, a6, tm) the port's track_file gives
    each family are the JAX engine's."""
    args = (0.25, 1e-9, 0.2, 10230.0, 4096.0, 10)
    np.testing.assert_array_equal(teng.sigp_row(*args, sub),
                                  jeng.sigp_row(*args, sub))


def test_torch_synth_matches_numpy_synth():
    """tools/track_all.synth_iq_t (the card's capture synthesis) is
    utils.synth.synth_iq in torch."""
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t

    for name in ("galileo-e1b", "gps-l1cp", "gps-l2cm", "gps-l2cl",
                 "glonass-l1-p", "gps-l1cd"):
        sig = get_signal(name)
        prn = sig.prns()[1]
        code = sig.code_table((prn,))[0]
        dop = 1234.5 + sig.fdma_hz * prn
        kw = dict(subcarrier=sig.subcarrier,
                  carrier_ratio=sig.track_carrier_ratio(prn),
                  code_doppler_hz=1234.5)
        want = synth.synth_iq(code.astype(np.float64), sig.chip_rate,
                              8.192e6, 20000, doppler_hz=dop,
                              code_phase=17.3, cn0_dbhz=None, **kw)
        got = synth_iq_t(code, sig.chip_rate, 8.192e6, 20000, dop, 17.3,
                         **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


def _run(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


def test_track_cli_subcarrier_family_matches_jax_cli(tmp_path, monkeypatch):
    """galileo-e1b (CBOC, 4 sub-blocks) through both track CLIs, the
    port's with --device cpu: 9-column rows, block exact, floats rtol
    2e-5 / atol 2e-4 (plus 1e-6 of %f printing).  The int8 scale keeps
    the prompt envelope near 16,000, where the reference's float32 sums
    still resolve a small quadrature arm to the absolute tolerance."""
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu_torch.cli import track as tcli

    sig = get_signal("galileo-e1b")
    fs = 2.048e6
    n = int(fs * 0.09)
    truth = ((11, 900.0, 2000.5), (24, -2200.0, 2838.25))
    x = sum(synth.synth_iq(sig.code_table((p,))[0].astype(np.float64),
                           sig.chip_rate, fs, n, doppler_hz=d,
                           code_phase=cp, cn0_dbhz=None,
                           subcarrier=sig.subcarrier,
                           carrier_ratio=sig.carrier_ratio)
            for p, d, cp in truth)
    path = tmp_path / "e1b.iq"
    path.write_bytes(synth.to_int8_iq(x, scale=8.0))
    spec = ",".join(f"{p}:{d + 7.0}:{cp}" for p, d, cp in truth)
    args = ["--blocks", "60", "--loop-dwells", "20,20", str(path), str(fs),
            "0", spec]
    monkeypatch.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
    want = _run(jcli.main, "galileo-e1b", args).strip().splitlines()
    got = _run(tcli.main, "galileo-e1b",
               ["--device", "cpu"] + args).strip().splitlines()
    assert len(got) == len(want) == 2 * 60
    for a, b in zip(want, got):
        ta, ra = a.split(" ", 1)
        tb, rb = b.split(" ", 1)
        assert ta == tb
        fa = np.array(ra.split(), float)
        fb = np.array(rb.split(), float)
        assert fa.shape == fb.shape == (9,)
        assert fa[0] == fb[0]
        np.testing.assert_allclose(fb[1:], fa[1:], rtol=2e-5,
                                   atol=2e-4 + 1e-6)
