"""Checkpoint and exact resume (track/checkpoint.py, the resume branch of
track/driver.track_file, the CLI's --checkpoint/--resume): the
counterparts of tests/test_checkpoint.py, on the CPU.

  * resume is bit-exact within the port, through the API (scan level),
    the CLI (a run stopped by --blocks after its first checkpoints, then
    --resume) and a two-shard mesh: rows equal;
  * the file is the reference's format, and a checkpoint the JAX package
    wrote resumes in the port: the port's resumed rows against the JAX
    package's uninterrupted run, integers equal, floats rtol 2e-5 /
    atol 2e-4 (the reference's engine-to-engine tolerance).
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
from gnss_dsp_tpu_torch.track import checkpoint
from gnss_dsp_tpu_torch.track.driver import TrackChannel, make_params, \
    track_file
from gnss_dsp_tpu_torch.track.engine import init_state, track_scan


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads a worker while this module runs: the test
    workers share the machine's cores, and torch's default of one thread
    a core makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


FS = 2.048e6
PRN, DOP, CP0 = 21, 1200.0, 300.0
INT_KEYS = ("block", "samp", "code_cyc", "carrier_cyc")
FLOAT_KEYS = ("p_re", "p_im", "carrier_f", "code_f_offset", "phase_deg",
              "early", "prompt", "late", "code_p", "carrier_p")


def capture(seconds=0.3):
    sig = jsig("gps-l1")
    x = synth.synth_iq(sig.code_table((PRN,))[0], sig.chip_rate, FS,
                       int(FS * seconds), doppler_hz=DOP, code_phase=CP0,
                       cn0_dbhz=None, carrier_ratio=1540.0)
    return synth.to_int8_iq(x, scale=24.0)


def table(rows, keys):
    return np.array([[r[k] for k in keys] for r in rows], np.float64)


def by_block(rows):
    return {r["block"]: tuple(r[k] for k in INT_KEYS + FLOAT_KEYS)
            for r in rows}


def test_scan_resume_bitexact(tmp_path):
    """100 blocks, or 40, a checkpoint, a load and 60 more: rows and
    state equal (tests/test_checkpoint.py:43-63)."""
    sig = tsig("gps-l1")
    p = make_params(sig, FS, 1000.0, loop_dwells=(50, 50))
    x = torch.from_numpy(np.frombuffer(capture(0.15), np.int8).astype(
        np.float32).reshape(-1, 2).copy()).contiguous()
    x = torch.view_as_complex(torch.nn.functional.pad(x, (0, 0, 0, 8192)))
    n = x.shape[0] - 8192
    tab = torch.from_numpy(sig.code_table((PRN, 5)).astype(np.int8))
    st0 = init_state(code_p=[CP0, 700.0], code_f_off=[0.0, 0.0],
                     carrier_p=[0.0, 0.0], carrier_f=[DOP, -300.0])
    st_a, rf_a, ri_a = track_scan(x, n, tab, st0, p, 100)
    st_1, rf_1, ri_1 = track_scan(x, n, tab, st0, p, 40)
    path = tmp_path / "ck.npz"
    checkpoint.save(str(path), st_1, meta={"blocks": 40})
    st_l, host, meta = checkpoint.load(str(path), "cpu")
    assert meta == {"blocks": 40} and host == {}
    st_2, rf_2, ri_2 = track_scan(x, n, tab, st_l, p, 60)
    assert torch.equal(rf_a[:40].nan_to_num(), rf_1.nan_to_num())
    assert torch.equal(rf_a[40:].nan_to_num(), rf_2.nan_to_num())
    assert torch.equal(ri_a[40:], ri_2)
    for f in st_a._fields:
        assert torch.equal(getattr(st_a, f), getattr(st_2, f)), f


def _cli(argv):
    from gnss_dsp_tpu_torch.cli import track as tcli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main("gps-l1", argv) == 0
    return out.getvalue().strip().splitlines()


def test_cli_checkpoint_resume_bitexact(tmp_path):
    """The track CLI with --chunk-ms 100 --checkpoint stops after 250
    blocks (two chunks checkpointed), then --resume runs to the end of
    the file: the rows joined at the checkpointed block equal an
    uninterrupted run's, text for text."""
    path = tmp_path / "l1.iq"
    path.write_bytes(capture(0.4))
    ck = tmp_path / "ck.npz"
    base = ["--loop-dwells", "50,50", "--chunk-ms", "100", "--device",
            "cpu", str(path), str(int(FS)), "0", str(PRN), str(DOP),
            str(CP0)]
    full = _cli(base)
    assert len(full) > 380
    first = _cli(["--checkpoint", str(ck), "--blocks", "250"] + base)
    assert ck.exists() and not (tmp_path / "ck.npz.tmp").exists()
    rest = _cli(["--resume", str(ck)] + base)
    start = int(rest[0].split()[0])
    assert 0 < start < 250
    joined = [r for r in first if int(r.split()[0]) < start] + rest
    assert joined == full


def test_cli_refuses_resume_from_stdin():
    with pytest.raises(SystemExit):
        _cli(["--resume", "ck.npz", "--device", "cpu", "-", "2048000", "0",
              "21", "1200", "300"])


def test_mesh_checkpoint_resume_bitexact(tmp_path):
    """--mesh composes with --checkpoint/--resume (two CPU sat shards,
    three channels padded with a clone): the resumed run's rows equal
    the sharded uninterrupted run's, keyed by block."""
    raw = capture(0.2)
    ck = str(tmp_path / "mesh.npz")
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)

    def run(**kw):
        chans = [TrackChannel(prn=PRN, doppler=DOP, code_offset=CP0),
                 TrackChannel(prn=5, doppler=-300.0, code_offset=700.0),
                 TrackChannel(prn=9, doppler=250.0, code_offset=12.5)]
        track_file(tsig("gps-l1"), io.BytesIO(raw), FS, 0.0, chans,
                   loop_dwells=(8, 8), mesh=mesh, device="cpu", **kw)
        return chans

    full = run(max_blocks=150)
    run(max_blocks=70, checkpoint_path=ck, chunk_ms=30.0)
    res = run(max_blocks=150, checkpoint_path=ck, resume_from=ck,
              chunk_ms=30.0)
    for a, b in zip(full, res):
        fa, fb = by_block(a.rows), by_block(b.rows)
        assert len(fb) >= 80 and min(fb) < 70
        for k in fb:
            assert fa[k] == fb[k], k


def test_checkpoint_format_is_the_references(tmp_path):
    """The port's npz holds the JAX package's fields with its dtypes
    (coffset_p uint32, the recovery bins, the host counters)."""
    from gnss_dsp_tpu.track import checkpoint as jck

    raw = capture(0.05)
    paths = {}
    for name, sig, chan, run in (
            ("jax", jsig, JChannel, jtrack),
            ("port", tsig, TrackChannel,
             lambda *a, **k: track_file(*a, device="cpu", **k))):
        paths[name] = str(tmp_path / f"{name}.npz")
        run(sig("gps-l1"), io.BytesIO(raw), FS, 0.0,
            [chan(prn=PRN, doppler=DOP, code_offset=CP0)],
            loop_dwells=(8, 8), chunk_ms=20.0, max_blocks=30,
            checkpoint_path=paths[name])
    with np.load(paths["jax"]) as a, np.load(paths["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    st, host, meta = jck.load(paths["port"])
    assert meta["total_blocks"] == 22 and int(host["prn"][0]) == PRN


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX package wrote after two 20 ms chunks resumes
    in the port; the port's rows from there match the JAX package's
    uninterrupted run."""
    raw = capture(0.12)
    ck = str(tmp_path / "jax.npz")
    kw = dict(loop_dwells=(8, 8), chunk_ms=20.0)
    full = [JChannel(prn=PRN, doppler=DOP, code_offset=CP0)]
    jtrack(jsig("gps-l1"), io.BytesIO(raw), FS, 0.0, full, max_blocks=100,
           **kw)
    jtrack(jsig("gps-l1"), io.BytesIO(raw), FS, 0.0,
           [JChannel(prn=PRN, doppler=DOP, code_offset=CP0)], max_blocks=50,
           checkpoint_path=ck, **kw)
    got = [TrackChannel(prn=PRN, doppler=DOP, code_offset=CP0)]
    track_file(tsig("gps-l1"), io.BytesIO(raw), FS, 0.0, got,
               max_blocks=100, resume_from=ck, device="cpu", **kw)
    start = got[0].rows[0]["block"]
    assert 20 <= start < 50
    want = [r for r in full[0].rows if r["block"] >= start]
    assert len(want) == len(got[0].rows) >= 50
    np.testing.assert_array_equal(table(got[0].rows, INT_KEYS),
                                  table(want, INT_KEYS))
    np.testing.assert_allclose(table(got[0].rows, FLOAT_KEYS),
                               table(want, FLOAT_KEYS), rtol=2e-5,
                               atol=2e-4)
