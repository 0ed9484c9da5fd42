"""--mesh N on the port's acquire and track CLIs, on the captures of
tests/test_cli_mesh.py (GPS L1 at 4.096 MHz, 62 ms, noiseless):

  * `acquire --device cpu --mesh 8` (a 4 x 2 grid of CPU shards) prints
    the rows of the same CLI without --mesh, text for text, and the rows
    of the JAX CLI with --mesh 8 on its 8 virtual CPU devices (text for
    text, the reference's own tolerance between its single and sharded
    CLIs);
  * `track --device cpu --mesh 8` on 8 channels, and on one channel padded
    with 7 clones that are never emitted, prints the rows of the same CLI
    without --mesh byte for byte, and the JAX CLI's with --mesh 8 to its
    tolerance there (rtol 2e-4 / atol 5e-4, the channel tags and the int
    columns exact);
  * --mesh with --coherent on acquire is a usage error, as in the
    reference.
"""

import contextlib
import io

import numpy as np
import pytest

FS = 4.096e6
_PLANTS = [(5, 1200.0, 300.25), (9, -800.0, 700.0)]
_TRACKED = [(21, 900.0, 512.5), (5, -400.0, 100.0)]


def _mkfile(path, prns_dops_cps):
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l1")
    n = int(FS * 0.062)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in prns_dops_cps:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, FS, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                      carrier_ratio=1540.0)
    path.write_bytes(to_int8_iq(x, scale=20.0))
    return str(path)


def _run(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_mesh")
    return (_mkfile(d / "acq.iq", _PLANTS),
            _mkfile(d / "trk.iq", _TRACKED))


def _jax_cli(main, signal, args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
        return _run(main, signal, args)


def test_acquire_cli_mesh_matches_single_and_jax(captures):
    from gnss_dsp_tpu.cli import acquire as jcli
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    args = ["--prn", "5,9,17", "--doppler-search", "-1400,1400,200",
            "--time", "30", captures[0], "%d" % FS, "0"]
    single = _run(tcli.main, "gps-l1", ["--device", "cpu"] + args)
    sharded = _run(tcli.main, "gps-l1", ["--device", "cpu", "--mesh", "8"]
                   + args)
    assert single == sharded and len(single.splitlines()) == 3
    assert _jax_cli(jcli.main, "gps-l1", ["--mesh", "8"] + args) == sharded
    rows = {int(r.split()[1]): r.split() for r in sharded.splitlines()}
    for prn, dop, cp in _PLANTS:
        assert abs(float(rows[prn][3]) - dop) <= 100.0
        assert abs(float(rows[prn][7]) - cp) <= 1.0


def test_acquire_cli_refuses_mesh_with_coherent(captures):
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    with pytest.raises(SystemExit):
        tcli.main("gps-l1", ["--device", "cpu", "--mesh", "2",
                             "--coherent", "4", captures[0], "%d" % FS, "0"])


def _floats(text):
    return [np.array([float(v) for v in r.split()[1:]])
            for r in text.splitlines()]


@pytest.mark.parametrize("chans", ["eight", "one"])
def test_track_cli_mesh_matches_single_and_jax(captures, chans):
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu_torch.cli import track as tcli

    if chans == "eight":
        spec = [",".join(f"{p}:{d}:{c}" for p, d, c in _TRACKED * 4)]
    else:
        spec = [str(v) for v in _TRACKED[0]]
    args = (["--loop-dwells", "10,10", "--blocks", "30", captures[1],
             "%d" % FS, "0"] + spec)
    single = _run(tcli.main, "gps-l1", ["--device", "cpu"] + args)
    sharded = _run(tcli.main, "gps-l1", ["--device", "cpu", "--mesh", "8"]
                   + args)
    n = 8 if chans == "eight" else 1
    assert len(sharded.splitlines()) == 30 * n
    assert sharded == single
    jax_rows = _jax_cli(jcli.main, "gps-l1", ["--mesh", "8"] + args)
    assert len(jax_rows.splitlines()) == 30 * n
    for lj, lt in zip(jax_rows.splitlines(), sharded.splitlines()):
        tj, tt = lj.split(), lt.split()
        if n > 1:
            assert tj[0] == tt[0]                   # chNN tag
            tj, tt = tj[1:], tt[1:]
        a = np.array([float(v) for v in tj])
        b = np.array([float(v) for v in tt])
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=5e-4)
        np.testing.assert_array_equal(a[[0, 9, 11, 13]], b[[0, 9, 11, 13]])
