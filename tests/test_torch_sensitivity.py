"""The sensitivity curve on the port (gnss_dsp_tpu_torch/tools/
sensitivity_curve.py) against the JAX package's tool (tools/
sensitivity_curve.py of the repository root), on the CPU at a reduced
size: BeiDou B1I at 4.096 MHz, C/N0 26 and 34 dB-Hz, 2 trials a point.

  * the draws: the first trial's capture bit-equal between the tools;
  * the curve: the same non-coherent and coherent lock counts a point
    (the JAX tool's printed "cn0 .. dB-Hz:" lines);
  * a subset of the points (`searched`) searches the same captures as
    the full curve.
"""

import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.tools import sensitivity_curve as tcurve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CN0S = (26, 34)
TRIALS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_sensitivity_curve", os.path.join(ROOT, "tools",
                                              "sensitivity_curve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spy_synth(monkeypatch, mod):
    """The captures `mod` synthesises, recorded through its synth_iq."""
    seen = []
    orig = mod.synth_iq

    def spy(*a, **kw):
        x = orig(*a, **kw)
        seen.append(np.array(x, copy=True))
        return x

    monkeypatch.setattr(mod, "synth_iq", spy)
    return seen


def _counts(text):
    """{cn0: (non-coherent locks, coherent locks)} of the progress lines."""
    return {int(m[0]): (int(m[1]), int(m[2])) for m in re.findall(
        r"cn0 (\d+) dB-Hz: non-coherent (\d+)/\d+, coherent (\d+)/\d+",
        text)}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX tool's reduced run: its stdout and its captures."""
    mp = pytest.MonkeyPatch()
    try:
        mod = _jax_tool()
        seen = _spy_synth(mp, mod)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.run(cn0s=CN0S, trials=TRIALS)
    finally:
        mp.undo()
    return out.getvalue(), seen


def test_first_capture_is_bit_equal(jax_run, monkeypatch):
    """The port's tool draws the JAX tool's code phase, doppler, roll and
    noise: its first capture equals the JAX tool's bit for bit."""
    _, want = jax_run
    seen = _spy_synth(monkeypatch, tcurve)
    with contextlib.redirect_stdout(io.StringIO()):
        curve = tcurve.run(cn0s=CN0S[:1], trials=1, device="cpu")
    assert seen[0].dtype == want[0].dtype == np.complex64
    assert seen[0].tobytes() == want[0].tobytes()
    assert len(curve.trials) == 1 and curve.trials[0].lock_nc is not None


def test_lock_counts_match_jax_tool(jax_run):
    """The reduced curve on the CPU: the port's per-point lock counts are
    the JAX tool's, its progress lines and table in the same format."""
    text, _ = jax_run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        curve = tcurve.run(cn0s=CN0S, trials=TRIALS, device="cpu")
    want = _counts(text)
    assert sorted(want) == list(CN0S)
    assert _counts(out.getvalue()) == want
    assert {cn0: (hn, hc) for cn0, hn, hc, _ in curve.rows} == want
    table = [line for line in out.getvalue().splitlines()
             if line.startswith("|")]
    assert table == [line for line in text.splitlines()
                     if line.startswith("|")]
    assert len(curve.trials) == len(CN0S) * TRIALS
    for t in curve.trials:
        assert t.lock_nc is not None and t.lock_co is not None


def test_searched_subset_sees_the_same_captures(monkeypatch):
    """searched=(34,) draws the 26 dB-Hz trials without searching them:
    the 34 dB-Hz trials are the same captures, with the same decisions,
    as in the full reduced curve."""
    with contextlib.redirect_stdout(io.StringIO()):
        full = tcurve.run(cn0s=CN0S, trials=TRIALS, device="cpu")
        part = tcurve.run(cn0s=CN0S, trials=TRIALS, device="cpu",
                          searched=(34,))
    assert [r[0] for r in part.rows] == [34]
    for a, b in zip(full.trials, part.trials):
        assert (a.cn0, a.code_phase, a.doppler, a.roll) == \
            (b.cn0, b.code_phase, b.doppler, b.roll)
        if b.cn0 == 34:
            assert (a.lock_nc, a.lock_co, a.nc, a.co) == \
                (b.lock_nc, b.lock_co, b.nc, b.co)
        else:
            assert b.nc is None and b.lock_co is None


def test_card_refused_without_one(monkeypatch):
    """device="cuda" without a card raises before any draw: the tool
    never falls back to the CPU."""
    monkeypatch.delenv("GNSS_DSP_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tcurve.run(cn0s=CN0S, trials=1, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        tcurve.main(["beidou-b1i", "1"])
