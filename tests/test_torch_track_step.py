"""The port's per-step correlators (plain versions of kernels K3 and K4,
ops/track_step) against the JAX package's Pallas kernels in interpret
mode and against a float64 numpy oracle; the port's step scan against the
JAX per-step Pallas route (tolerances and setup in
tests/test_torch_track_families.py); and the route make_params records
for every catalog signal.

Inputs: one tracking step of C channels from a numpy seed (random chunk,
random +-1 code, random DDS phases; channel 0 at code phase ~0, so its
early lag reads chip -1 -> L-1), the same si/sf lanes to both packages.

Tolerances:
  * against epl_correlate2 / epl_correlate (interpret mode): atol 8e-3 of
    the largest sum, rtol 2e-2, as tests/test_pallas.py:145 holds those
    kernels to their oracle: they round the wiped samples times the
    factor to bf16 for the MXU (pallas_track2.py:180-181, 206-207;
    pallas_track.py:207), which the port does not copy;
  * against the float64 oracle: rtol 1e-5 and 1e-6 of the largest sum (the
    plain version sums exact float64 products and rounds once to float32;
    the oracle's table is float64).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnss_dsp_tpu.ops import pallas_track as ptk
from gnss_dsp_tpu.ops import pallas_track2 as ptk2
from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.ops import track_step
from test_torch_track_families import (
    _CORR_FIELDS, _DLL_FIELD, _PHASE_FIELD, _check_state, _run_jax,
    _run_port, _setup)

# (K3 kind, a0, a1, a6, tm, the family it equals): "subc" once for each
# affine family's coefficients (track/engine.SUBC_COEF)
_K3 = [("none", (1.0, 0.0, 0.0, 0.0), "none"),
       ("subc", (0.0, 1.0, 0.0, 0.0), "boc11"),
       ("subc", (0.0, 0.953463, 0.301511, 0.0), "cboc"),
       ("subc", (0.5, 0.5, 0.0, 0.0), "rz_even"),
       ("subc", (0.5, -0.5, 0.0, 0.0), "rz_odd"),
       ("tmboc", (0.0, 0.0, 0.0, 1.0), "tmboc")]
_IDS = [f"{k}-{fam}" for k, _, fam in _K3]
EL = 0.2


def _step(L, n, C=3, seed=0, cf=1.023e6 / 4.096e6):
    """si [C, 9], sf [C, 8] (subcarrier lanes zero), chunk, code, and the
    per-channel code phases."""
    rng = np.random.default_rng(seed)
    n_tiles = -(-n // ptk.TILE)
    nchunk = (n_tiles + 4) * ptk.TILE
    xs = (rng.standard_normal(nchunk) + 1j * rng.standard_normal(nchunk)
          ).astype(np.complex64)
    code = rng.choice([-1, 1], (C, L)).astype(np.int8)
    si = np.zeros((C, 9), np.int32)
    sf = np.zeros((C, 8), np.float32)
    cps = []
    for c in range(C):
        cp = 0.05 if c == 0 else float(rng.uniform(0, L))
        cps.append(cp)
        for k, lag in enumerate((-EL, 0.0, EL)):
            si[c, k] = int(np.floor(cp + lag))
            sf[c, k] = np.float32(cp + lag - np.floor(cp + lag))
        si[c, 3] = int(rng.integers(-(1 << 20), 1 << 20))
        si[c, 4] = n - 7 * c
        si[c, 5] = int(rng.integers(-(1 << 31), 1 << 31))
        si[c, 6] = int(rng.integers(-(1 << 20), 1 << 20))
        si[c, 7] = int(rng.integers(-(1 << 31), 1 << 31))
        si[c, 8] = int(rng.integers(0, 3 * ptk.TILE))
        sf[c, 3] = np.float32(cf * (1 + 1e-6 * c))
    return dict(si=si, sf=sf, xs=xs, code=code, n=n, n_tiles=n_tiles, cf=cf)


def _port(s, sub, v1=False):
    t = torch.from_numpy
    return track_step.epl_correlate_plain(
        t(s["si"]), t(s["sf"]), t(s["xs"]), t(s["code"]), s["n"], sub,
        v1=v1).numpy()


def _jax(s, sub, v1=False, stream=False):
    W = ptk.chip_window(s["cf"])
    rows = ptk.extend_code(s["code"], W, int(np.ceil(
        (s["n_tiles"] + 1) * ptk.TILE * s["cf"])) + 2)
    args = (jnp.asarray(s["si"]), jnp.asarray(s["sf"]),
            jnp.asarray(s["xs"].real.copy())[None, :],
            jnp.asarray(s["xs"].imag.copy())[None, :], jnp.asarray(rows))
    fn = ptk.epl_correlate if v1 else ptk2.epl_correlate2
    return np.asarray(fn(*args, n_tiles=s["n_tiles"], W=W, sub=sub,
                         stream=stream, interpret=True))[:, :6]


def _oracle(s, sub):
    """float64 sums of the step (pallas_track's family forms)."""
    si, sf, xs, code = s["si"], s["sf"], s["xs"], s["code"]
    L = code.shape[1]
    out = np.zeros((si.shape[0], 6))
    for c in range(si.shape[0]):
        nv, ptr = int(si[c, 4]), int(si[c, 8])
        i = np.arange(nv)
        ia = ((int(si[c, 5]) % (1 << 32) + i * np.int64(si[c, 3]))
              % (1 << 32)) >> 22
        ib = ((int(si[c, 7]) % (1 << 32) + i * np.int64(si[c, 6]))
              % (1 << 32)) >> 22
        ang = ((ia + ib) & 1023) * (2 * np.pi / 1024)
        xm = xs[ptr:ptr + nv].astype(np.complex128) * np.exp(1j * ang)
        for k in range(3):
            cp32 = (np.float64(sf[c, k]) + i * np.float64(sf[c, 3])
                    ).astype(np.float32)
            chip = int(si[c, k]) + np.floor(cp32).astype(np.int64)
            w = code[c, chip % L].astype(np.float64)
            bp = np.floor(np.float32(2.0) * cp32).astype(np.int64) % 2
            boc = 1.0 - 2 * bp
            boc6 = 1.0 - 2 * (np.floor((np.float32(12.0) * cp32)
                                       .astype(np.float32)).astype(np.int64)
                              % 2)
            if sub == "boc11":
                w = w * boc
            elif sub == "cboc":
                w = w * (np.float64(np.float32(0.953463)) * boc
                         + np.float64(np.float32(0.301511)) * boc6)
            elif sub == "tmboc":
                slot = np.isin(chip % 33, [0, 4, 6, 29]).astype(np.float64)
                w = w * (slot * boc6 + (1 - slot) * boc)
            elif sub == "rz_even":
                w = w * (1 - bp)
            elif sub == "rz_odd":
                w = w * bp
            p = np.sum(xm * w)
            out[c, 2 * k:2 * k + 2] = p.real, p.imag
    return out


def _bf16_close(got, want):
    np.testing.assert_allclose(got, want, atol=8e-3 * np.abs(want).max(),
                               rtol=2e-2)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", range(len(_K3)), ids=_IDS)
def test_k3_plain_matches_pallas_interpret(case, stream):
    kind, coef, _ = _K3[case]
    # the streamed route is the JAX kernel's for codes over
    # driver._STREAM_CODE_CHIPS (100,000): a synthetic 200,013-chip code
    s = _step(200_013 if stream else 10230, 1500, seed=case)
    s["sf"][:, 4:] = coef
    _bf16_close(_port(s, kind), _jax(s, kind, stream=stream))


@pytest.mark.parametrize("family", [f for _, _, f in _K3])
def test_k4_plain_matches_pallas_interpret(family):
    s = _step(10230, 1500, seed=11)
    _bf16_close(_port(s, family, v1=True), _jax(s, family, v1=True))


@pytest.mark.parametrize("case", range(len(_K3)), ids=_IDS)
def test_plain_forms_match_float64_oracle(case):
    kind, coef, family = _K3[case]
    s = _step(10230, 4100, C=4, seed=20 + case)
    want = _oracle(s, family)
    tol = dict(rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(_port(s, family, v1=True), want, **tol)
    s["sf"][:, 4:] = coef
    got = _port(s, kind)
    np.testing.assert_allclose(got, want, **tol)
    # the static family and its runtime form are one function
    np.testing.assert_array_equal(got, _port(s, family, v1=True))


def test_plain_reads_only_the_block():
    """Samples at and past n, and past the chunk's end, add nothing."""
    s = _step(1023, 2000, C=2, seed=5)
    want = _port(s, "none")
    xs = s["xs"].copy()
    for c in range(2):
        a = int(s["si"][c, 8]) + int(s["si"][c, 4])
        xs[a:] = 1e6
        s2 = dict(s, xs=xs)
        got = _port(s2, "none")
        np.testing.assert_array_equal(got[c], want[c])
        xs = s["xs"].copy()
    s["si"][1, 8] = len(xs) - 100          # a block that runs off the chunk
    got = track_step.epl_correlate_plain(
        *(torch.from_numpy(s[k]) for k in ("si", "sf", "xs", "code")),
        s["n"], "none")
    assert torch.isfinite(got).all()


def test_make_params_route_for_every_signal(monkeypatch):
    """K2 for every signal with a code table unless GNSS_DSP_NO_FUSED or
    recovery; else K3, or K4 under GNSS_DSP_PALLAS_V1 -- the reference's
    switches (track/driver.py:178-184)."""
    from gnss_dsp_tpu_torch.models.signal import all_signals
    from gnss_dsp_tpu_torch.track.driver import make_params

    sigs = {n: s for n, s in all_signals().items() if s.code_table}
    assert len(sigs) == 34
    for env, fused_ok, v2 in ((dict(), True, True),
                              (dict(GNSS_DSP_NO_FUSED="1"), False, True),
                              (dict(GNSS_DSP_NO_FUSED="1",
                                    GNSS_DSP_PALLAS_V1="1"), False, False),
                              (dict(GNSS_DSP_PALLAS_V1="1"), True, False)):
        for k in ("GNSS_DSP_NO_FUSED", "GNSS_DSP_PALLAS_V1"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for name, sig in sigs.items():
            p = make_params(sig, sig.acq_fs, 0.0)
            assert p.fused_scan == fused_ok, name
            assert p.pallas_v2 == v2, name
            assert not make_params(sig, sig.acq_fs, 0.0,
                                   recover_after=200).fused_scan, name


@pytest.mark.parametrize("v1", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("name", ["galileo-e1b", "gps-l1cp", "gps-l1"])
def test_step_scan_matches_jax_pallas_step_route(name, v1, monkeypatch):
    monkeypatch.setenv("GNSS_DSP_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("GNSS_DSP_NO_FUSED", "1")
    if v1:
        monkeypatch.setenv("GNSS_DSP_PALLAS_V1", "1")
    s = _setup(name, pallas=True)
    p = interop.params_from_jax(s["params"])
    assert s["params"].use_pallas and not p.fused_scan
    assert p.pallas_v2 == (not v1)
    st_j, rf_j, ri_j = _run_jax(s, 40)
    st_t, rf_t, ri_t = _run_port(s, 40)
    np.testing.assert_array_equal(ri_t, ri_j)
    loop = [f for f in range(11)
            if f not in _CORR_FIELDS + (_PHASE_FIELD, _DLL_FIELD)]
    np.testing.assert_allclose(rf_t[..., loop], rf_j[..., loop],
                               rtol=2e-5, atol=2e-4)
    env = rf_j[..., 7:8]
    assert np.all(np.abs(rf_t[..., _CORR_FIELDS] - rf_j[..., _CORR_FIELDS])
                  <= 2.0**-8 * env)
    dphase = np.abs(rf_t[..., _PHASE_FIELD] - rf_j[..., _PHASE_FIELD])
    assert np.all(np.minimum(dphase, 360.0 - dphase) <= np.degrees(2.0**-8))
    d = np.maximum.accumulate(2 * 2.0**-8 * rf_j[..., 7]
                              / (rf_j[..., 6] + rf_j[..., 8]), axis=0)
    b = np.arange(40)[:, None]
    k1, k2 = p.dll_k1, p.dll_k2
    assert np.all(np.abs(rf_t[..., _DLL_FIELD] - rf_j[..., _DLL_FIELD])
                  <= 2e-4 + (k2 + (b + 1) * k1) * d)
    _check_state(st_j, st_t, ("code_p_hi", "carrier_p", "carrier_f"))
