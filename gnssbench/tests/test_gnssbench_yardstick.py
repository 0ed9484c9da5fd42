"""The yardstick on the CPU: the cell arithmetic, the frozen roofline
copies against the bounds PERF.md records, the plain references against
planted truth, and the import rules."""

import ast
import os

import numpy as np
import pytest
import torch

from gnssbench import roofline
from gnssbench.reference import acquire as ra
from gnssbench.reference.models import get_signal
from gnssbench.tests import tiny
from gnssbench.entries.acquire import Acquire

# the acquire-all.sh rows (signal, coffset), in order
ACQUIRE_ALL = [
    "gps-l1", "glonass-l1", "galileo-e1b", "galileo-e1c", "beidou-b1i",
    "gps-l2cm", "glonass-l2", "glonass-l3ocd", "glonass-l3ocp",
    "galileo-e5bi", "galileo-e5bq", "beidou-b2i", "gps-l5i", "gps-l5q",
    "galileo-e5ai", "galileo-e5aq", "glonass-l3ocd", "glonass-l3ocp",
    "galileo-e5bi", "galileo-e5bq", "beidou-b2i"]


def _cells(name):
    sig = get_signal(name)
    return ra.search_cells(sig, len(sig.prns()),
                           len(ra.doppler_grid(sig.doppler_default)),
                           sig.acq_ms_default)


def test_gps_l1_search_cells():
    assert _cells("gps-l1") == 32 * 70 * 4096 * 80 == 734_003_200


def test_acquire_all_pass_cells():
    assert round(sum(_cells(s) for s in ACQUIRE_ALL) / 1e8) == 1614


@pytest.mark.parametrize("what,got,want", [
    ("k1 gps-l1", lambda: roofline.surface_bound(32, 70, 80, 4096,
                                                  32 * 70 * 12), (0.778, "operations")),
    ("k1 call", lambda: (roofline.k1_call_bound_ms(70, 80, 4096, 32),
                         "operations"), (0.778, "operations")),
    # the receiver's three launches: 3 bands of 35,202,048-sample
    # segments a chunk (chip_smoke.py e2e_receiver)
    ("k2 receiver", lambda: roofline.k2_bound(
        3 * 3 * 35_202_048, 3 * 11 * 10230, 16_500, 1.155e9, "subc"),
     (0.757, "bytes")),
])
def test_frozen_bounds(what, got, want):
    ms, by = got()
    assert (round(ms, 3), by) == want


def _capture(seeds, fs, seconds, seed=424242):
    from gnssbench import synth
    return synth.synth_band(seeds, fs, seconds, seed, 1, "cpu")


def test_acquisition_reference_finds_planted_truth():
    fs = 8.184e6
    seeds = [dict(signal="gps-l1", prn=3, doppler=1200.0, code_phase=100.25,
                  coffset=250000.0, cn0=47.0),
             dict(signal="gps-l1", prn=6, doppler=-1600.0, code_phase=700.5,
                  coffset=250000.0, cn0=45.0)]
    raw = _capture(seeds, fs, 0.03)
    sig = get_signal("gps-l1")
    prns, dops = [1, 3, 6], ra.doppler_grid((-2000.0, 2000.0, 200.0))
    q = ra.surface(sig, raw[:2 * int(25 * fs / 1000)], fs, 250000.0, prns,
                   dops, 20, "cpu")
    res = {r[0]: r for r in ra.results_of(sig, q, prns, dops)}
    for s in seeds:
        _p, dop, metric, code = res[s["prn"]]
        assert abs(dop - s["doppler"]) < 1e-9
        assert abs(code - s["code_phase"]) < 0.5
        assert metric > 2 * res[1][2]
    assert ra.judge(sig, q, prns, dops, 5e-6)(list(res.values())) == (
        0.0, 0, 0)


def test_reference_filter_is_scipys():
    signal = pytest.importorskip("scipy.signal")
    np.testing.assert_allclose(
        ra.lowpass(69.984e6, 1.5e6),
        signal.firwin(161, 1.5e6 / (69.984e6 / 2), window="hann"),
        rtol=0, atol=1e-15)


def test_tf32_rounds_to_ten_bits():
    u = 2 ** -10                       # TF32's step at 1
    v = torch.tensor([1 + u, 1 + u / 4, 1 + u / 2, 1 + 3 * u / 4])
    assert ra.tf32(v).tolist() == [1 + u, 1.0, 1 + u, 1 + u]


def test_tracking_reference_holds_lock():
    from gnssbench.reference.track import run as rt

    fs = 8.184e6
    seeds = [dict(signal="gps-l1", prn=9, doppler=-800.0, code_phase=300.0,
                  coffset=0.0, cn0=46.0)]
    raw = _capture(seeds, fs, 0.3)
    rows = rt.track_pass([(raw, seeds)], fs, False, "cpu", (100, 100))
    (rf, ri), = rows
    assert len(rf) >= 295
    assert abs(np.median(rf[-50:, 3]) - (-800.0)) < 5.0
    # the PLL holds the phase: the prompt's energy is in its I arm
    assert np.median(np.abs(rf[-50:, 1])) > 5 * np.median(np.abs(rf[-50:, 2]))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(sub=""):
    top = os.path.join(tiny.BENCH, sub)
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    from gnssbench.run import FORBIDDEN

    bad = [(p, m) for p in _sources() for m in _imports(p)
           if m.split(".", 1)[0] in FORBIDDEN]
    assert bad == []
    assert "gnss_dsp_tpu" in FORBIDDEN and "gnss_dsp_tpu_torch" != "gnss_dsp_tpu"


def test_reference_imports_nothing_of_the_program():
    bad = [(p, m) for p in _sources("reference") for m in _imports(p)
           if m.split(".", 1)[0] == "gnss_dsp_tpu_torch"]
    assert bad == []


def test_forbidden_names_are_compared_whole():
    from gnssbench.run import forbidden_loaded

    assert forbidden_loaded(["gnss_dsp_tpu_torch.ops", "numpy"]) == []
    assert forbidden_loaded(["gnss_dsp_tpu.ops", "jax.numpy", "jaxlib"]) == [
        "gnss_dsp_tpu", "jax", "jaxlib"]


def test_search_arguments_follow_the_row():
    a = Acquire.__new__(Acquire)
    a.fs = 69.984e6
    sig, prns, dops, ms, n = a._search_args(
        {"signal": "gps-l1", "argv": ["--prn", "1-4", "--time", "10"]})
    assert (prns, len(dops), ms, n) == ([1, 2, 3, 4], 70, 10,
                                       int(15 * 69.984e6 / 1000))
