"""Mixed-signal tracking (`track multi`): channels of different signals
in one scan, each with its own sigp row, code row (the [C, Lmax] table),
ratio, carrier offset and coherent span.  The port (--device cpu, the
plain versions) against the JAX package's track_file(sigs=...) on its
XLA scan, the counterparts of tests/test_track_multi.py.

Tolerances:
  * integer row fields (block, samp, code_cyc, carrier_cyc) and the
    CLI's printed integers: equal;
  * float row fields against the JAX XLA scan: rtol 2e-5, atol 2e-4 (the
    reference's engine-to-engine tolerance, tests/test_fused_scan.py);
  * the port's multi run against its own single-signal runs, and a mesh
    run against the unsharded one: equal (the plain correlator's float64
    sums do not depend on the window's width or the launch's kind).
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
from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads a worker while this module runs: the test
    workers share the machine's cores, and torch's default of one thread
    a core makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


FS = 4.096e6
COFF = 900.0
INT_KEYS = ("block", "samp", "code_cyc", "carrier_cyc")
FLOAT_KEYS = ("p_re", "p_im", "carrier_f", "code_f_offset", "phase_deg",
              "early", "prompt", "late", "code_p", "carrier_p")

# (signal, prn or FDMA channel, doppler, code phase, carrier offset)
MIXES = {
    # BPSK, an FDMA channel and B1I, each at its own carrier offset
    "bpsk_fdma_b1i": [("gps-l1", 7, 900.0, 317.25, COFF),
                      ("glonass-l1", -3, -700.0, 41.5, COFF),
                      ("beidou-b1i", 34, 400.0, 1500.6, -150.0)],
    # TMBOC in a mix: the launch's kind "tmboc", tm = 0 for the others
    "tmboc": [("gps-l1cp", 3, 700.0, 5100.4, COFF),
              ("gps-l1", 7, 900.0, 317.25, COFF),
              ("galileo-e1b", 24, -1500.0, 2047.3, COFF)],
    # a long code beside a short one: L2CL's 767,250 chips set Lmax (at
    # LONG_FS, below)
    "long_code": [("gps-l2cl", 7, 900.0, 767200.5, COFF),
                  ("gps-l1", 21, -1200.0, 317.25, COFF)],
}
# L2CL's mix runs at 2.048 MHz: at 4.096 MHz its code rate is 1023/8192
# of the sample rate, exact in float32, and its RZ half-chip edges fall
# on samples, where the reference's float32 XLA scan and the port's
# single-rounded fr + i*cf can place one sample of an early or late sum
# on either side (0.36 of 50,000 in one block, seen once)
MIX_FS = {"long_code": 2.048e6}
# the coherent mix: B1I integrates its NH20 (M = -1), GPS L1 stays at 1
COHERENT = [("beidou-b1i", 34, 400.0, 1500.6, COFF),
            ("gps-l1", 7, 900.0, 317.25, COFF)]


def scene(mix, seconds=0.05, overlays=False, fs=FS):
    """int8 I/Q bytes of the mix's satellites (noiseless), each at its
    doppler plus its carrier offset (and FDMA channel), the code at its
    true doppler; overlays: each carries its secondary code."""
    n = int(fs * seconds)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp, coff in mix:
        sig = jsig(name)
        chan = prn if sig.fdma_hz else 0
        bits = (np.asarray(sig.secondary(prn), np.float64)
                if overlays and sig.secondary is not None else None)
        x += synth.synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                            sig.chip_rate, fs, n,
                            doppler_hz=dop + (sig.fdma_hz or 0.0) * chan
                            + coff, code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(chan),
                            code_doppler_hz=dop, subcarrier=sig.subcarrier,
                            data_bits=bits)
    return synth.to_int8_iq(x, scale=24.0)


def run_jax(data, mix, blocks, fs=FS, **kw):
    sigs = [jsig(m[0]) for m in mix]
    chans = [JChannel(prn=p, doppler=d, code_offset=cp)
             for _, p, d, cp, _c in mix]
    jtrack(sigs[0], io.BytesIO(data), fs, 0.0, chans, loop_dwells=(8, 8),
           max_blocks=blocks, sigs=sigs, coffsets=[m[4] for m in mix], **kw)
    return chans


def run_port(data, mix, blocks, fs=FS, **kw):
    sigs = [tsig(m[0]) for m in mix]
    chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
             for _, p, d, cp, _c in mix]
    track_file(sigs[0], io.BytesIO(data), fs, 0.0, chans, loop_dwells=(8, 8),
               max_blocks=blocks, sigs=sigs, coffsets=[m[4] for m in mix],
               device="cpu", **kw)
    return chans


def table(rows, keys):
    return np.array([[r[k] for k in keys] for r in rows], np.float64)


def compare_jax(jchans, tchans, min_rows=20):
    for a, b in zip(jchans, tchans):
        assert len(a.rows) == len(b.rows) >= min_rows
        np.testing.assert_array_equal(table(b.rows, INT_KEYS),
                                      table(a.rows, INT_KEYS))
        np.testing.assert_allclose(table(b.rows, FLOAT_KEYS),
                                   table(a.rows, FLOAT_KEYS),
                                   rtol=2e-5, atol=2e-4)


def equal_rows(a, b):
    assert len(a.rows) == len(b.rows) > 0
    keys = INT_KEYS + FLOAT_KEYS
    np.testing.assert_array_equal(table(a.rows, keys), table(b.rows, keys))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_multi_matches_jax_multi(mix):
    fs = MIX_FS.get(mix, FS)
    data = scene(MIXES[mix], fs=fs)
    compare_jax(run_jax(data, MIXES[mix], 40, fs),
                run_port(data, MIXES[mix], 40, fs))


def test_multi_coherent_mixed_matches_jax():
    """Per-channel coherent spans in one scan (-1: B1I integrates its
    NH20, GPS L1 has no overlay and stays non-coherent)."""
    data = scene(COHERENT, 0.06, overlays=True)
    compare_jax(run_jax(data, COHERENT, 44, coherent_blocks=-1),
                run_port(data, COHERENT, 44, coherent_blocks=-1), 40)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_multi_equals_single_signal_runs(mix):
    fs = MIX_FS.get(mix, FS)
    data = scene(MIXES[mix], 0.035, fs=fs)
    multi = run_port(data, MIXES[mix], 30, fs)
    for m, got in zip(MIXES[mix], multi):
        single = run_port(data, [m], 30, fs)[0]
        equal_rows(single, got)


def test_multi_mesh_equals_multi():
    """Two CPU sat shards: the channels (three, padded with a clone of
    channel 0) and their sigp and code rows split; rows equal."""
    mix = MIXES["bpsk_fdma_b1i"]
    data = scene(mix)
    a = run_port(data, mix, 30)
    b = run_port(data, mix, 30, mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    for x, y in zip(a, b):
        equal_rows(x, y)


def _run_cli(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue().strip().splitlines()


def test_multi_cli_matches_jax_cli(tmp_path, monkeypatch):
    """`track multi` through both CLIs: the same "SIG:prn " prefixes in
    the same order, each signal's 9 or 14 columns, integers equal,
    floats rtol 2e-5 / atol 2e-4 (plus 1e-6 of %f printing)."""
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu_torch.cli import track as tcli

    mix = MIXES["bpsk_fdma_b1i"]
    path = tmp_path / "mix.iq"
    path.write_bytes(scene(mix))
    spec = ",".join(f"{n}:{p}:{d}:{cp}:{co}" for n, p, d, cp, co in mix)
    args = ["--blocks", "25", "--loop-dwells", "6,6", str(path), str(FS),
            "0", spec]
    monkeypatch.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
    want = _run_cli(jcli.main, "multi", args)
    got = _run_cli(tcli.main, "multi", args + ["--device", "cpu"])
    assert len(got) == len(want) == 3 * 25
    for a, b in zip(want, got):
        ta, ra = a.split(" ", 1)
        tb, rb = b.split(" ", 1)
        assert ta == tb
        fa = np.array(ra.split(), float)
        fb = np.array(rb.split(), float)
        ncol = 14 if jsig(ta.split(":")[0]).row_format == 14 else 9
        assert fa.shape == fb.shape == (ncol,)
        ints = [0] + ([9, 11, 13] if ncol == 14 else [])
        np.testing.assert_array_equal(fb[ints], fa[ints])
        fl = [k for k in range(1, ncol) if k not in ints]
        np.testing.assert_allclose(fb[fl], fa[fl], rtol=2e-5,
                                   atol=2e-4 + 1e-6)


def test_multi_refusals_are_the_references():
    """A mixed-signal run under a mesh refuses recovery (the reference's
    driver.py:282-283); a bad channel spec is a parse error."""
    from gnss_dsp_tpu_torch.cli import track as tcli

    mix = MIXES["bpsk_fdma_b1i"]
    with pytest.raises(ValueError, match="mesh"):
        run_port(b"\0" * 40000, mix, 2, recover_after=10,
                 mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    with pytest.raises(SystemExit):
        tcli.main("multi", ["x.iq", "4096000", "0", "gps-l1:7:900",
                            "--device", "cpu"])
