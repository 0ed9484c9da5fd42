"""Unknown-code recovery (track/recover.py, ops/nco.accum_code_bins, the
recovery branch of the plain scan, the CLI's --recover): the
counterparts of tests/test_recover_e2e.py and
tests/test_checkpoint.py::test_code_recovery, on the CPU.

Tolerances:
  * accum_code_bins against the JAX package's: rtol 1e-6 (both add in
    sample order in float32; the port's LUT-free inputs are the same);
  * the recovery scan's bins against the JAX XLA scan's: bins visited by
    both, rtol 1e-5 (atol 1e-6 of the largest bin, a few float32 ulps of
    it, for bins that sum to near zero: the two packages' oscillator
    tables differ by an ulp), the same bins visited, the recovered chips
    equal; the rows as the scan's, integers equal, floats rtol 2e-5 /
    atol 2e-4;
  * the mesh run against the single one: bins and rows equal.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu.models import get_signal as jsig
from gnss_dsp_tpu.track.driver import TrackChannel as JChannel
from gnss_dsp_tpu.track.driver import track_file as jtrack
from gnss_dsp_tpu.utils import synth
from gnss_dsp_tpu_torch.models import get_signal as tsig
from gnss_dsp_tpu_torch.ops import nco
from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file
from gnss_dsp_tpu_torch.track.recover import CodeRecovery


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads a worker while this module runs: the test
    workers share the machine's cores, and torch's default of one thread
    a core makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


FS = 22.0e6
INT_KEYS = ("block", "samp", "code_cyc", "carrier_cyc")
FLOAT_KEYS = ("p_re", "p_im", "carrier_f", "code_f_offset", "phase_deg",
              "early", "prompt", "late", "code_p", "carrier_p")
# (signal, prn, doppler): the two B2b memory codes
DUO = [("beidou-b2bi", 19, 800.0), ("beidou-b2bq", 20, -1500.0)]


def capture(duo, ms, seed, cn0=60.0):
    """int8 I/Q of the duo's satellites with random navigation bits, each
    at cn0 dB-Hz, and their codes (tests/test_recover_e2e.py)."""
    rng = np.random.default_rng(seed)
    n = int(FS * ms / 1000)
    x = np.zeros(n, np.complex64)
    codes = []
    for name, prn, dop in duo:
        sig = jsig(name)
        code = sig.code_table((prn,))[0].astype(np.float64)
        codes.append(code)
        x += synth.synth_iq(code, sig.chip_rate, FS, n, doppler_hz=dop,
                            code_phase=0.0, cn0_dbhz=None, amplitude=8.0,
                            carrier_ratio=sig.carrier_ratio,
                            data_bits=rng.choice([-1.0, 1.0], size=ms + 2))
    sigma = 8.0 * np.sqrt(FS / (2.0 * 10 ** (cn0 / 10)))
    x += sigma * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    return synth.to_int8_iq(x, scale=1.0), codes


def recovered_chips(bins, code):
    """(share of bins visited, chip agreement either sign)."""
    rec = np.where(bins.real >= 0, 1.0, -1.0)
    hit = bins.real != 0.0
    agree = (rec[hit] == code[hit]).mean()
    return hit.mean(), max(agree, 1.0 - agree)


def table(rows, keys):
    return np.array([[r[k] for k in keys] for r in rows], np.float64)


def test_accum_code_bins_matches_jax():
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import nco as jnco

    rng = np.random.default_rng(2)
    n, L = 33000, 10230
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * 20
    cp0, incr = 5123.37, 10.23e6 / FS
    jr, ji = jnco.accum_code_bins((jnp.asarray(x.real), jnp.asarray(x.imag)),
                                  jnp.float32(cp0), jnp.float32(incr), L)
    tr, ti = nco.accum_code_bins(torch.from_numpy(x), cp0, incr, L)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6)
    assert ((tr.numpy() != 0) == (np.asarray(jr) != 0)).all()


def test_accum_rows_adds_in_sample_order():
    """The sorted rounds give the float32 sums of a sequential loop."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 7, (3, 200)))
    val = torch.from_numpy((rng.standard_normal((3, 200, 2)) * 1e4).astype(
        np.float32))
    keep = torch.from_numpy(rng.random((3, 200)) < 0.8)
    acc = torch.from_numpy(rng.standard_normal((3, 7, 2)).astype(np.float32))
    want = acc.numpy().copy()
    for c in range(3):
        for i in range(200):
            if keep[c, i]:
                for j in range(2):
                    want[c, idx[c, i], j] = np.float32(
                        want[c, idx[c, i], j] + val[c, i, j].item())
    got = nco.accum_rows(acc, idx, val, keep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_code_recovery_class():
    """CodeRecovery recovers a code from bit-flipped noiseless blocks
    (tests/test_checkpoint.py::test_code_recovery)."""
    sig = tsig("beidou-b2bi")
    code = sig.code_table((25,))[0]
    fs = 30.69e6
    n_ms = int(fs // 1000)
    rng = np.random.default_rng(5)
    rec = CodeRecovery(sig.code_length, warmup_blocks=2)
    cf = sig.chip_rate / fs
    chip_of = (np.arange(n_ms) * cf).astype(np.int64) % sig.code_length
    for _ in range(12):
        x = rng.choice([-1.0, 1.0]) * synth.synth_iq(
            code, sig.chip_rate, fs, n_ms, doppler_hz=0.0, code_phase=0.0,
            cn0_dbhz=None)
        rec.update(torch.from_numpy(x), code_p=0.0, cf=cf,
                   p_prompt_re=float(np.sum(x.real * code[chip_of])))
    assert np.array_equal(rec.chips(), code)
    assert rec.confidence() > 1.0


def test_recovery_scan_matches_jax_scan():
    """B2bI at 22 MHz over 40 ms, recovery after 10 blocks: the port's
    plain recovery scan against the JAX XLA scan, bins and rows."""
    (data, _), sig = capture(DUO[:1], 40, 7), "beidou-b2bi"
    prn, dop = DUO[0][1:]
    jc = [JChannel(prn=prn, doppler=dop, code_offset=0.0)]
    jtrack(jsig(sig), io.BytesIO(data), FS, 0.0, jc, loop_dwells=(10, 10),
           recover_after=10)
    tc = [TrackChannel(prn=prn, doppler=dop, code_offset=0.0)]
    track_file(tsig(sig), io.BytesIO(data), FS, 0.0, tc,
               loop_dwells=(10, 10), recover_after=10, device="cpu")
    np.testing.assert_array_equal(table(tc[0].rows, INT_KEYS),
                                  table(jc[0].rows, INT_KEYS))
    np.testing.assert_allclose(table(tc[0].rows, FLOAT_KEYS),
                               table(jc[0].rows, FLOAT_KEYS), rtol=2e-5,
                               atol=2e-4)
    a, b = jc[0].recovered, tc[0].recovered
    assert a.shape == b.shape == (10230,)
    visited = a.real != 0
    assert visited.mean() > 0.95
    np.testing.assert_array_equal(b.real != 0, visited)
    scale = np.abs(a).max()
    for part in (np.real, np.imag):
        np.testing.assert_allclose(part(b)[visited], part(a)[visited],
                                   rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_array_equal(np.sign(b.real), np.sign(a.real))


def _run_cli(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue().strip().splitlines()


def test_b2bi_cli_recovers_code(tmp_path):
    """The track CLI on B2bI recovers by default (recover_default) after
    --recover-warmup blocks: > 95% of the bins visited, the chips
    > 98% the planted code (either sign), as tests/test_recover_e2e.py
    holds the reference's CLI; a second run writes the same bins."""
    from gnss_dsp_tpu_torch.cli import track as tcli

    data, codes = capture(DUO[:1], 100, 7)
    path = tmp_path / "b2bi.iq"
    path.write_bytes(data)
    prn, dop = DUO[0][1:]
    chips = [tmp_path / "a.dat", tmp_path / "b.dat"]
    for out in chips:
        rows = _run_cli(tcli.main, "beidou-b2bi",
                        ["--loop-dwells", "10,10", "--recover-warmup", "10",
                         "--recover-file", str(out), "--device", "cpu",
                         str(path), str(FS), "0", str(prn), str(dop), "0"])
        assert len(rows) > 60
    bins = np.loadtxt(chips[0])
    assert bins.shape == (10230, 2)
    assert chips[0].read_text() == chips[1].read_text()
    hit, agree = recovered_chips(bins[:, 0] + 1j * bins[:, 1], codes[0])
    assert hit > 0.95 and agree > 0.98, (hit, agree)


def test_recovery_under_mesh_matches_single():
    """Recovery under a two-shard CPU mesh (the bins split over the sat
    axis like the state; one channel and its clone): bins and rows
    equal to the single run."""
    data, _ = capture(DUO[:1], 40, 7)
    prn, dop = DUO[0][1:]

    def run(mesh):
        ch = TrackChannel(prn=prn, doppler=dop, code_offset=0.0)
        track_file(tsig("beidou-b2bi"), io.BytesIO(data), FS, 0.0, [ch],
                   loop_dwells=(10, 10), recover_after=10, mesh=mesh,
                   device="cpu")
        return ch

    a = run(None)
    b = run(make_mesh(2, 1, devices=["cpu"] * 2))
    np.testing.assert_array_equal(a.recovered, b.recovered)
    keys = INT_KEYS + FLOAT_KEYS
    np.testing.assert_array_equal(table(a.rows, keys), table(b.rows, keys))
    assert np.abs(a.recovered).sum() > 0


def test_multi_recover_two_codes_one_pass(tmp_path):
    """`track multi --recover` on B2bI + B2bQ recovers both memory codes
    in one pass, each to its own RECOVER_FILE-SIG-PRN.dat."""
    from gnss_dsp_tpu_torch.cli import track as tcli

    data, codes = capture(DUO, 100, 11)
    path = tmp_path / "b2b.iq"
    path.write_bytes(data)
    spec = ",".join(f"{n}:{p}:{d}:0" for n, p, d in DUO)
    out = tmp_path / "chips.dat"
    _run_cli(tcli.main, "multi",
             ["--loop-dwells", "10,10", "--recover", "--recover-warmup",
              "10", "--recover-file", str(out), "--device", "cpu",
              str(path), str(FS), "0", spec])
    for (name, prn, _), code in zip(DUO, codes):
        bins = np.loadtxt(tmp_path / f"chips-{name}-{prn}.dat")
        hit, agree = recovered_chips(bins[:, 0] + 1j * bins[:, 1], code)
        assert hit > 0.95 and agree > 0.97, (name, hit, agree)


def test_refusals_are_the_references():
    """Recovery with coherent tracking under a mesh, and a mixed-signal
    recovery under a mesh, refuse (driver.py:280-283, 318-323)."""
    data = b"\0" * 200_000
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="mesh"):
        track_file(tsig("beidou-b1i"), io.BytesIO(data), 4.096e6, 0.0,
                   [TrackChannel(prn=34, doppler=0.0, code_offset=0.0)],
                   recover_after=10, coherent_blocks=20, mesh=mesh,
                   device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        track_file(tsig(DUO[0][0]), io.BytesIO(data), FS, 0.0,
                   [TrackChannel(prn=p, doppler=d, code_offset=0.0)
                    for _, p, d in DUO], sigs=[tsig(n) for n, *_ in DUO],
                   recover_after=10, mesh=mesh, device="cpu")
