"""The port's aux tools against the JAX package's, on the CPU:

  * ops/squaring.squaring against gnss_dsp_tpu/ops/squaring.squaring
    (and the reference's loop, tests/test_utils.py:23): rtol 1e-5, atol
    1e-5 * n * m * max|x|^2;
  * cli/squaring's int16 bytes against the JAX CLI's on a two-round file:
    equal, or one LSB apart where 20 * r lies within float32 rounding of a
    rounding tie (3 of the 4000 values of this file);
  * track/probe.correlation_shape for the four subcarrier kinds and a
    code-length wrap: rtol 1e-5, atol 1e-6 * n; ShapeAccumulator over
    three blocks; the probe's peak at the true code offset
    (tests/test_utils.py:45);
  * cli/spectrum --text rows byte-equal to the JAX CLI's;
  * utils/profiling: Counters.report's format (tests/test_utils.py:67),
    device_sync a no-op on the CPU, trace writing its trace file.
"""

import contextlib
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.ops.squaring import squaring
from gnss_dsp_tpu_torch.track.probe import ShapeAccumulator, correlation_shape


@pytest.mark.parametrize("b,n,m", [(4, 8, 5), (3, 16, 100)])
def test_squaring_matches_jax_and_the_loop(b, n, m):
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops.squaring import squaring as jsq

    rng = np.random.default_rng(b * n * m)
    x = (rng.standard_normal(b * n * m + 7)
         + 1j * rng.standard_normal(b * n * m + 7)).astype(np.complex64)
    got = squaring(torch.from_numpy(x), n, m).numpy()
    rr, ri = jsq((jnp.asarray(x.real), jnp.asarray(x.imag)), n, m)
    atol = 1e-5 * n * m * float(np.abs(x).max()) ** 2
    assert got.shape == (b,) and got.dtype == np.complex64
    np.testing.assert_allclose(got.real, np.asarray(rr), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.imag, np.asarray(ri), rtol=1e-5, atol=atol)
    want = np.zeros(b, complex)
    xd = x.astype(np.complex128)
    for bi in range(b):
        for k in range(m):
            s = xd[bi * n * m + k * n: bi * n * m + (k + 1) * n].sum()
            want[bi] += s * s / n
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def _run_binary_cli(main, argv, path):
    """Run a CLI main that writes binary to sys.stdout.buffer; its bytes."""
    out = path + ".out"
    with open(out, "wb") as f:
        saved = sys.stdout
        sys.stdout = types.SimpleNamespace(buffer=f)
        try:
            rc = main(argv)
        finally:
            sys.stdout = saved
    assert rc == 0
    with open(out, "rb") as f:
        return f.read()


def test_squaring_cli_matches_jax_cli(tmp_path, monkeypatch):
    """Two rounds of 1000 * 16 * 100 samples (and a short tail, dropped
    at EOF) of a weak 3 kHz tone in noise at an int8 level where 20 * r
    stays inside int16, carrier offset 2.5 kHz: int16 I/Q equal to the
    JAX CLI's, or one LSB apart where 20 * r lies within float32 rounding
    of a .5 tie."""
    from gnss_dsp_tpu.cli import squaring as jcli
    from gnss_dsp_tpu_torch.cli import squaring as tcli

    monkeypatch.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
    fs, n = 4.0e6, 2 * 1000 * 16 * 100 + 5000
    rng = np.random.default_rng(3)
    t = np.arange(n)
    x = 0.3 * np.exp(2j * np.pi * 3000.0 * t / fs) + 2 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = np.empty(2 * n, np.int8)
    iq[0::2] = np.clip(np.round(x.real), -127, 127)
    iq[1::2] = np.clip(np.round(x.imag), -127, 127)
    path = str(tmp_path / "sq.iq")
    iq.tofile(path)
    argv = [path, str(fs), "2500"]
    got = np.frombuffer(_run_binary_cli(tcli.main, argv + ["--device", "cpu"],
                                        path), np.int16)
    want = np.frombuffer(_run_binary_cli(jcli.main, argv, path), np.int16)
    assert got.shape == want.shape == (2 * 2 * 1000,)
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1
    assert (np.abs(want) > 100).mean() > 0.5 and np.abs(want).max() < 16000
    # every differing value is a rounding tie: the port's unrounded
    # 20 * r within float32 rounding (1e-5 relative) of a .5
    from gnss_dsp_tpu_torch.ops.frontend import mix_long

    r20 = []
    for k in range(2):
        seg = iq[2 * k * 1600000: 2 * (k + 1) * 1600000].astype(np.float32)
        xs = torch.complex(torch.from_numpy(seg[0::2].copy()),
                           torch.from_numpy(seg[1::2].copy()))
        ph = float(np.mod(-k * 1600000 * 2500 / fs, 1))
        r = squaring(mix_long(xs, -2500 / fs, ph), 16, 100).numpy()
        r20.append(np.stack([20 * r.real, 20 * r.imag], 1).reshape(-1))
    r20 = np.concatenate(r20)
    off = np.abs(np.abs(r20 - np.floor(r20)) - 0.5)
    ties = np.flatnonzero(diff)
    assert (off[ties] <= 1e-5 * np.abs(r20[ties]) + 1e-4).all()
    assert len(ties) <= 8, len(ties)     # 3 of the 4000 values here


CASES = [("gps-l1", "none", 100.0), ("galileo-e1b", "boc11", 2000.5),
         ("galileo-e1b", "cboc", 4090.25), ("gps-l1cp", "tmboc", 10229.0)]


def _block(name, cp, n, fs, seed):
    from gnss_dsp_tpu_torch.utils.synth import synth_iq

    sig = get_signal(name)
    code = sig.code_table((7,))[0]
    x = synth_iq(code, sig.chip_rate, fs, n, code_phase=cp, cn0_dbhz=None,
                 subcarrier="cboc" if name == "galileo-e1b" else
                 ("tmboc" if name == "gps-l1cp" else "none"))
    x += 0.1 * np.random.default_rng(seed).standard_normal(n)
    return sig, code.astype(np.int8), x.astype(np.complex64)


@pytest.mark.parametrize("name,kind,cp", CASES,
                         ids=[c[1] for c in CASES])
def test_correlation_shape_matches_jax(name, kind, cp):
    """Each subcarrier kind at code phases that wrap past the code length
    (gps-l1cp near its 10230-chip end, galileo-e1b near 4092)."""
    import jax.numpy as jnp

    from gnss_dsp_tpu.track.probe import correlation_shape as jshape

    fs, n = 8.184e6, 6000
    sig, code, x = _block(name, cp, n, fs, 1)
    cf = sig.chip_rate / fs
    got = correlation_shape(torch.from_numpy(x), torch.from_numpy(code),
                            np.float32(cp - 0.5), np.float32(cf),
                            np.float32(0.05), 41, sig.code_length,
                            kind).numpy()
    re, im = jshape((jnp.asarray(x.real), jnp.asarray(x.imag)),
                    jnp.asarray(code), jnp.float32(cp - 0.5),
                    jnp.float32(cf), jnp.float32(0.05), 41,
                    sig.code_length, kind)
    np.testing.assert_allclose(got.real, np.asarray(re), rtol=1e-5,
                               atol=1e-6 * n)
    np.testing.assert_allclose(got.imag, np.asarray(im), rtol=1e-5,
                               atol=1e-6 * n)
    assert abs(int(np.argmax(np.abs(got))) - 30) <= 1    # the true offset


def test_shape_accumulator_matches_jax():
    """Three blocks, the second with the prompt's sign flipped: the
    float64 sums equal the JAX accumulator's to float32 rounding."""
    import jax.numpy as jnp

    from gnss_dsp_tpu.track.probe import ShapeAccumulator as JAcc

    fs, n = 4.096e6, 4096
    sig, code, x = _block("gps-l1", 100.4, 3 * n, fs, 2)
    cf = sig.chip_rate / fs
    acc, jacc = ShapeAccumulator(81, 0.05), JAcc(81, 0.05)
    for k, sign in enumerate((1.0, -1.0, 1.0)):
        blk = sign * x[k * n:(k + 1) * n]
        cp = 100.0 + k * n * cf
        acc.update(torch.from_numpy(blk), torch.from_numpy(code), cp, cf,
                   sign, 1023)
        jacc.update((jnp.asarray(blk.real), jnp.asarray(blk.imag)),
                    jnp.asarray(code), cp, cf, sign, 1023)
    assert acc.blocks == jacc.blocks == 3
    assert acc.re.dtype == np.float64
    np.testing.assert_allclose(acc.re, jacc.re, rtol=1e-5, atol=1e-6 * 3 * n)
    np.testing.assert_allclose(acc.im, jacc.im, rtol=1e-5, atol=1e-6 * 3 * n)
    np.testing.assert_array_equal(acc.lags(), jacc.lags())
    peak = acc.lags()[int(np.argmax(np.hypot(acc.re, acc.im)))]
    assert abs(100.0 + peak - 100.4) <= 0.05


def test_spectrum_text_rows_match_jax_cli(tmp_path, capsys):
    from gnss_dsp_tpu.cli import spectrum as jspec
    from gnss_dsp_tpu_torch.cli import spectrum as tspec

    raw = np.random.default_rng(8).integers(-60, 60, 2 * 4096 * 5
                                            ).astype(np.int8)
    path = str(tmp_path / "s.iq")
    raw.tofile(path)
    argv = ["--text", path, "1575420000", "4096000", "1024", "4"]
    assert tspec.main(list(argv)) == 0
    got = capsys.readouterr().out
    assert jspec.main(list(argv)) == 0
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 1024


def test_counters_report_format():
    from gnss_dsp_tpu.utils.profiling import Counters as JCounters
    from gnss_dsp_tpu_torch.utils.profiling import Counters

    c, j = Counters(t0=0.0), JCounters(t0=0.0)
    for k in (c, j):
        k.samples += 1000
        k.cells += 5000
        k.blocks += 7
    r, w = c.report(), j.report()
    assert "Msamples/s" in r and "Gcells/s" in r and "blocks/s" in r
    assert [t.split()[-1] for t in r.split("  ")] == \
        [t.split()[-1] for t in w.split("  ")]
    assert Counters().report().startswith("wall ")


def test_profiling_sync_and_trace_on_the_cpu(tmp_path):
    from gnss_dsp_tpu_torch.utils.profiling import device_sync, trace

    x = torch.ones(4)
    device_sync(x)
    device_sync((x, x))
    with trace(str(tmp_path / "tr")):
        (x * 2).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
