"""Extended-coherent tracking (coh_blocks = M > 1) in the port against the
JAX package, and the tracking route for every signal.

  * the plain scan, and the per-step route on the plain correlators (K3's
    and K4's forms), against the JAX XLA scan on the inputs of
    tests/test_fused_scan.py::test_fused_matches_scan_coherent (GPS L1 at
    2.048 MHz, two channels, M = 4, an 8-chip overlay per channel), over
    two launches whose boundary falls mid-period (22 blocks, then 10);
  * the track CLI with --coherent 20 --overlay-phase k against the JAX
    CLI on a small BeiDou B1I capture (NH20 overlay);
  * the acquire-to-track handoff of tests/test_coherent.py:109-147;
  * the parse error for a sub-divided signal;
  * make_params' route (fused_scan, pallas_v2) against the JAX
    make_params(use_pallas=True) for every signal that tracks.

Tolerances, as tests/test_torch_track.py holds the non-coherent scan:
int rows and ptr/block/stalled/coffset_p/n_full/sub_j state exact; every
float row field and float state leaf, cacc among them, to rtol 2e-5 /
atol 2e-4 (the reference's engine-to-engine tolerance); CLI text rows
the same plus 1e-6 of %f printing.
"""

import contextlib
import dataclasses
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnss_dsp_tpu.models import get_signal
from gnss_dsp_tpu.ops import nco as jnco
from gnss_dsp_tpu.track import engine as jeng
from gnss_dsp_tpu.track.driver import make_params as jmake
from gnss_dsp_tpu.utils import synth
from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.models import get_signal as tget
from gnss_dsp_tpu_torch.models.signal import all_signals
from gnss_dsp_tpu_torch.ops import track_step
from gnss_dsp_tpu_torch.track import engine as teng
from gnss_dsp_tpu_torch.track.driver import make_params as tmake

FS = 2.048e6
COFFSET = 1250.0
M = 4
_EXACT_STATE = ("ptr", "block", "stalled", "coffset_p", "n_full", "sub_j")
_FLOAT_STATE = ("code_p_hi", "code_p_lo", "code_f_off", "carrier_p",
                "carrier_f", "prompt1_re", "prompt1_im", "carrier_e1",
                "code_e1", "cacc")
# test_fused_scan.py:111-114: per-channel overlays, the second rolled
_OVERLAY = np.stack([
    np.array([1, 1, -1, 1, -1, -1, 1, 1], np.float32),
    np.roll(np.array([1, -1, -1, 1, 1, 1, -1, 1], np.float32), -3)])


def _setup():
    """test_fused_scan._setup's GPS L1 scene (PRNs 7, 13), the JAX
    params from make_params(use_pallas=False, coherent_blocks=M)."""
    sig = get_signal("gps-l1")
    prns, dops, phases = [7, 13], [900.0, -2200.0], [5.0, 417.25]
    n = int(FS * 0.06)
    code = sig.code_table(tuple(prns))
    x = sum(synth.synth_iq(code[i].astype(np.float64), sig.chip_rate, FS, n,
                           doppler_hz=d, code_phase=cp, cn0_dbhz=None,
                           carrier_ratio=sig.track_carrier_ratio(p))
            for i, (p, d, cp) in enumerate(zip(prns, dops, phases)))
    x = (x * np.exp(2j * np.pi * COFFSET / FS * np.arange(n))
         ).astype(np.complex64)
    params = jmake(sig, FS, coffset=COFFSET, loop_dwells=(8, 8),
                   use_pallas=False, chan=prns[0], coherent_blocks=M)
    tail = params.nmax + (-(n + params.nmax)) % 1024
    xp = np.concatenate([x, np.zeros(tail, np.complex64)])
    st = jeng.init_state(code_p=phases, code_f_off=[0.0] * 2,
                         carrier_p=[0.0] * 2, carrier_f=dops)
    cdf = np.array([jnco.freq_to_fixed(-COFFSET / FS)] * 2, np.int32)
    ratios = np.array([sig.track_carrier_ratio(p) for p in prns], np.float32)
    return dict(params=params, xp=xp, n=n, code=code.astype(np.int8), st=st,
                cdf=cdf, ratios=ratios)


def _run_jax(s, st, nb):
    xd = (jnp.asarray(s["xp"].real.copy()), jnp.asarray(s["xp"].imag.copy()))
    st2, rf, ri = jeng.track_scan(
        xd, jnp.int32(s["n"]), jnp.asarray(s["code"]), st, s["params"], nb,
        ratios=jnp.asarray(s["ratios"]), coffset_df=jnp.asarray(s["cdf"]),
        overlay=jnp.asarray(_OVERLAY))
    return st2, np.asarray(rf), np.asarray(ri)


def _check(st_j, rf_j, ri_j, st_t, rf_t, ri_t):
    assert (ri_t[:, :, 0] > 0).all()
    np.testing.assert_array_equal(ri_t, ri_j)
    np.testing.assert_allclose(rf_t, rf_j, rtol=2e-5, atol=2e-4)
    got = interop.state_to_numpy(st_t)
    for k in _EXACT_STATE:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(st_j, k)),
                                      err_msg=k)
    for k in _FLOAT_STATE:
        np.testing.assert_allclose(got[k], np.asarray(getattr(st_j, k)),
                                   rtol=2e-5, atol=2e-4, err_msg=k)


def _port_scan(s, st, nb, correlate=None):
    """The port's scan on the CPU: track_scan (the plain version), or
    the per-step loop engine._scan on the given correlator."""
    t = torch.from_numpy
    p = interop.params_from_jax(s["params"])
    if correlate is None:
        st2, rf, ri = teng.track_scan(
            t(s["xp"]), s["n"], t(s["code"]), st, p, nb,
            ratios=t(s["ratios"]), coffset_df=t(s["cdf"]),
            overlay=t(_OVERLAY))
    else:
        p = p._replace(fused_scan=False)
        st2, rf, ri = teng._scan(
            t(s["xp"]), torch.full((2,), s["n"], dtype=torch.int32),
            t(s["code"]), st, p, nb, t(s["ratios"]), t(s["cdf"]),
            teng.sigp_from_params(p, 2), correlate(p), t(_OVERLAY))
    return st2, rf.numpy(), ri.numpy()


def _k3_plain(p):
    return lambda si, sf, x, code: track_step.epl_correlate_plain(
        si, sf, x, code, p.nmax, "none")


def _k4_plain(p):
    return lambda si, sf, x, code: track_step.epl_correlate_plain(
        si, sf, x, code, p.nmax, "none", v1=True)


@pytest.mark.parametrize("route", ["plain", "k3_step", "k4_step"])
def test_coherent_scan_matches_jax_xla_scan(route):
    """Rows, state and cacc over 22 blocks (the chunk boundary two
    blocks into period 6) and 10 more from the carried state."""
    s = _setup()
    assert s["params"].coh_blocks == M and not s["params"].fused_scan
    correlate = {"plain": None, "k3_step": _k3_plain,
                 "k4_step": _k4_plain}[route]
    st_j, rf_j, ri_j = _run_jax(s, s["st"], 22)
    st_t, rf_t, ri_t = _port_scan(s, interop.state_from_numpy(s["st"]), 22,
                                  correlate)
    _check(st_j, rf_j, ri_j, st_t, rf_t, ri_t)
    assert float(np.abs(np.asarray(st_j.cacc)).max()) > 0.0
    st_j2, rf_j2, ri_j2 = _run_jax(s, st_j, 10)
    st_t2, rf_t2, ri_t2 = _port_scan(s, st_t, 10, correlate)
    _check(st_j2, rf_j2, ri_j2, st_t2, rf_t2, ri_t2)


def test_coherent_m1_is_the_non_coherent_scan():
    """M = 1 in the sigp COH lane reduces the coherent update to the
    non-coherent one exactly, as the reference's runtime lane does."""
    s = _setup()
    t = torch.from_numpy
    p = interop.params_from_jax(s["params"])
    sigp = teng.sigp_from_params(p, 2)
    sigp[:, teng.SIGP_COH] = 1.0
    args = (t(s["xp"]), s["n"], t(s["code"]),
            interop.state_from_numpy(s["st"]))
    kw = dict(ratios=t(s["ratios"]), coffset_df=t(s["cdf"]))
    _, rf_c, ri_c = teng.track_scan(*args, p, 12, sigp=sigp,
                                    overlay=torch.ones((2, 1)), **kw)
    _, rf_n, ri_n = teng.track_scan(*args, p._replace(coh_blocks=1), 12, **kw)
    assert torch.equal(ri_c, ri_n)
    assert torch.equal(rf_c, rf_n)


@pytest.mark.parametrize("sub", ["none", "cboc", "tmboc"])
def test_sigp_coherent_lanes_match_jax(sub):
    args = (0.25, 1e-9, 0.2, 10230.0, 4096.0, 1)
    np.testing.assert_array_equal(teng.sigp_row(*args, sub, coh=20, nov=20),
                                  jeng.sigp_row(*args, sub, coh=20, nov=20))


def _run(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


def test_track_cli_coherent_matches_jax_cli(tmp_path, monkeypatch):
    """beidou-b1i (NH20) through both track CLIs with --coherent 20
    --overlay-phase 7, the port's with --device cpu: two channels whose
    captures start mid-overlay, 60 blocks (three coherent periods),
    floats rtol 2e-5 / atol 2e-4 plus 1e-6 of %f printing.  The int8 scale keeps the
    prompt envelope near 16,000, as in the galileo-e1b CLI test.  9-column
    rows: block exact."""
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu_torch.cli import track as tcli

    sig = get_signal("beidou-b1i")
    fs = 4.096e6
    n = int(fs * 0.09)
    truth = ((11, 900.0, 700.5), (24, -2200.0, 1838.25))
    sec = sig.secondary(11)
    x = sum(synth.synth_iq(sig.code_table((p,))[0].astype(np.float64),
                           sig.chip_rate, fs, n, doppler_hz=d,
                           code_phase=cp, cn0_dbhz=None,
                           carrier_ratio=sig.carrier_ratio,
                           data_bits=np.roll(sec, -6))
            for p, d, cp in truth)
    path = tmp_path / "b1i.iq"
    path.write_bytes(synth.to_int8_iq(x, scale=4.0))
    spec = ",".join(f"{p}:{d + 7.0}:{cp}" for p, d, cp in truth)
    args = ["--blocks", "60", "--loop-dwells", "20,20", "--coherent", "20",
            "--overlay-phase", "7", str(path), str(fs), "0", spec]
    monkeypatch.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
    want = _run(jcli.main, "beidou-b1i", args).strip().splitlines()
    got = _run(tcli.main, "beidou-b1i",
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


@pytest.mark.parametrize("signal", ["galileo-e1b", "gps-l2cm"])
def test_track_cli_coherent_refuses_sub_divided_signals(signal, tmp_path,
                                                        capsys):
    """--coherent M > 1 on a signal tracked in sub-blocks is a parse
    error (exit 2) in both CLIs, with the same message."""
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu_torch.cli import track as tcli

    path = tmp_path / "empty.iq"
    path.write_bytes(b"")
    args = ["--coherent", "4", str(path), "4096000", "0", "1", "0", "0"]
    msgs = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(signal, list(args))
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1]
    assert "--coherent needs a whole-period signal" in msgs[1]


def test_acquire_to_track_overlay_handoff():
    """tests/test_coherent.py::test_acquire_to_track_overlay_handoff in
    the port, on the CPU: BeiDou B1I at 4.096 MHz and 30 dB-Hz, the
    capture starting mid-overlay; the port's coherent acquisition gives
    the overlay phase of the first tracked period, which seeds coherent
    tracking (M = 20): carrier_f within 1 Hz of the truth over the last
    200 rows."""
    from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file
    from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

    sig = dataclasses.replace(tget("beidou-b1i"), acq_fs=4.096e6)
    prn, doppler, cp0, cn0 = 34, 20.0, 500.0, 30.0
    fs = sig.acq_fs
    sec = sig.secondary(prn)
    true_roll = 7                      # capture starts mid-overlay
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs,
                 int(fs * 0.8), doppler_hz=doppler, code_phase=cp0,
                 cn0_dbhz=cn0, carrier_ratio=sig.carrier_ratio,
                 data_bits=np.roll(sec, -true_roll),
                 rng=np.random.default_rng(2))

    r = acquire_signal_coherent(sig, torch.from_numpy(
        x.astype(np.complex64)), [prn], (-80.0, 81.0, 20.0), ms=40)[0]
    e = abs(r.code_offset - cp0)
    assert min(e, sig.code_length - e) < 1.0, r
    assert abs(r.doppler - doppler) <= 20.0, r
    ovl = r.track_overlay_phase(sig.code_length)
    # period p carries chip (true_roll + p) mod 20; tracking starts at 1
    assert ovl == (true_roll + 1) % 20, (ovl, r.align)

    sigma = np.sqrt(fs / (2 * 10 ** (cn0 / 10)))
    raw = to_int8_iq(x, scale=100.0 / (4 * sigma))
    ch = TrackChannel(prn=prn, doppler=r.doppler, code_offset=r.code_offset,
                      pll_from_start=True, overlay_phase=ovl)
    track_file(sig, io.BytesIO(raw), fs, 0.0, [ch], coherent_blocks=20,
               device="cpu")
    cf = np.array([r_["carrier_f"] for r_ in ch.rows[-200:]])
    assert abs(np.mean(cf) - doppler) < 1.0, np.mean(cf)
    assert np.std(cf) < 1.0, np.std(cf)


_TRACKING = sorted(n for n, s in all_signals().items()
                   if s.code_table is not None and not s.recover_default)


def test_tracking_signal_count():
    assert len(_TRACKING) == 32


@pytest.mark.parametrize("no_fused", [False, True], ids=["fused", "no_fused"])
@pytest.mark.parametrize("name", _TRACKING)
def test_make_params_route_matches_jax(name, no_fused, monkeypatch):
    """The port's make_params equals the JAX make_params(use_pallas=True)
    field for field, the route (fused_scan: K2; pallas_v2: K3, else K4)
    among them, with and without GNSS_DSP_NO_FUSED, and with M = 20 on
    the whole-period signals."""
    monkeypatch.delenv("GNSS_DSP_PALLAS_V1", raising=False)
    if no_fused:
        monkeypatch.setenv("GNSS_DSP_NO_FUSED", "1")
    else:
        monkeypatch.delenv("GNSS_DSP_NO_FUSED", raising=False)
    js, ts = get_signal(name), tget(name)
    coh = 20 if ts.sub_blocks == 1 else 1
    pj = jmake(js, js.acq_fs, 1250.0, use_pallas=True, coherent_blocks=coh)
    pt = tmake(ts, ts.acq_fs, 1250.0, coherent_blocks=coh)
    assert pt.fused_scan == (not no_fused)
    assert interop.params_from_jax(pj) == pt
