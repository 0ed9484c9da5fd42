"""The port stands alone and hides nothing:

  * every module of gnss_dsp_tpu_torch (and chip_smoke.py) imports
    without loading jax or any module of the JAX package gnss_dsp_tpu, in
    a fresh interpreter;
  * asking for CUDA where there is none raises, and never runs on the CPU;
  * a CPU run launches no kernel (every launch counter stays 0);
  * a kernel wrapper given CPU tensors raises instead of running its
    plain version (the choice is the engine's, by the tensor's device);
  * a kernel build that cannot run raises (no fallback);
  * chip_smoke.py exits non-zero, printing no result, without a card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import pkgutil

    import gnss_dsp_tpu_torch

    names = ["gnss_dsp_tpu_torch"]
    for m in pkgutil.walk_packages(gnss_dsp_tpu_torch.__path__,
                                   "gnss_dsp_tpu_torch."):
        names.append(m.name)
    return names


def test_port_imports_no_jax():
    names = _port_modules()
    assert "gnss_dsp_tpu_torch.ops.acquire2" in names
    assert "gnss_dsp_tpu_torch.ops.track_fused" in names
    for m in ("ops.acquire_coh", "acquire.coherent", "acquire.plan",
              "ops.acquire", "models.catalog", "models.codes.selftest",
              "utils.synth", "utils.ranges", "cli.cn0", "ops.track_step",
              "tools.track_all", "parallel.mesh", "parallel.acquire",
              "parallel.track", "tools.multihost_worker", "track.receiver",
              "track.checkpoint", "track.recover", "cli.workload",
              "cli.squaring", "cli.spectrum", "track.probe", "ops.squaring",
              "utils.io", "utils.profiling", "tools.synth_sky",
              "tools.packet2wav_3ch", "tools.sky_workload",
              "tools.gen_compat_scripts", "tools.sensitivity_curve"):
        assert "gnss_dsp_tpu_torch." + m in names
    code = ("import importlib, sys\n"
            f"for n in {names!r} + ['chip_smoke']:\n"
            "    importlib.import_module(n)\n"
            "import gnss_dsp_tpu_torch.models as m\n"
            "m.get_signal('gps-l1').code_table((1,))\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'gnss_dsp_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'gnss_dsp_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_cuda_request_without_a_card_raises(monkeypatch, tmp_path):
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    iq = tmp_path / "x.iq"
    iq.write_bytes(np.zeros(2 * 400_000, np.int8).tobytes())
    with pytest.raises(RuntimeError, match="is_available"):
        acq_cli.main("gps-l1", [str(iq), "4096000", "0", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="is_available"):
        trk_cli.main("gps-l1", ["--device", "cuda", str(iq), "4096000", "0",
                                "3", "1000", "10"])
    with pytest.raises(RuntimeError, match="is_available"):
        acq_cli.main("gps-l1", ["--mesh", "2", str(iq), "4096000", "0"])
    with pytest.raises(RuntimeError, match="is_available"):
        trk_cli.main("gps-l1", ["--mesh", "-1", str(iq), "4096000", "0",
                                "3", "1000", "10"])
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    assert make_mesh(devices=["cpu"] * 2).shape == {"sat": 1, "time": 2}
    assert resolve_device("cpu").type == "cpu"


def test_drop_ins_import_no_jax(tmp_path):
    """A drop-in wrapper and the demuxer, run as the shell workloads run
    them, load neither jax nor the JAX package; the wrapper's CLI asks
    for the card by default, which raises without one."""
    iq = tmp_path / "x.iq"
    iq.write_bytes(np.zeros(2 * 400_000, np.int8).tobytes())
    code = ("import runpy, sys\n"
            "sys.argv = ['acquire-gps-l1.py', '--prn', '1', '--time', '2',"
            f" {str(iq)!r}, '4096000', '0', '--device', 'cpu']\n"
            "try:\n"
            "    runpy.run_path('gnss_dsp_tpu_torch/scripts/acquire-gps-l1.py',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gnss_dsp_tpu')"
            " or m.startswith(('jax.', 'gnss_dsp_tpu.')))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("prn   1 doppler")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(
        "gnss_dsp_tpu_torch", "scripts", "squaring.py"), str(iq), "4096000",
        "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=env)
    assert r.returncode != 0 and "is_available" in r.stderr


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """cli.workload and cli.squaring ask for CUDA unless --device says
    otherwise, which raises here; the probe, the squaring op and the
    preloaded chunk stay on their tensors' device."""
    from gnss_dsp_tpu_torch.cli import squaring as sq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.cli import workload
    from gnss_dsp_tpu_torch.ops.squaring import squaring
    from gnss_dsp_tpu_torch.track.probe import correlation_shape

    iq = tmp_path / "x.iq"
    iq.write_bytes(np.zeros(2 * 1_700_000, np.int8).tobytes())
    cap = tmp_path / "c.pcap"
    cap.write_bytes(np.zeros(3 * 2 * 69984 * 2, np.int8).tobytes())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sq_cli.main([str(iq), "4096000", "0"])
    with pytest.raises(RuntimeError, match="is_available"):
        workload.main(["acquire-all", str(cap), str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="is_available"):
        workload.main(["track-all", str(cap), str(tmp_path / "o")])
    with pytest.raises(TypeError):
        trk_cli._preload_chunk(str(iq), 4.096e6, 2000.0, {})
    x = torch.ones(64, dtype=torch.complex64)
    assert squaring(x, 4, 2).device.type == "cpu"
    c = correlation_shape(x, torch.ones(10, dtype=torch.int8), 0.0, 0.25,
                          0.5, 5, 10)
    assert c.device.type == "cpu" and c.shape == (5,)


def test_track_file_defaults_to_the_card(monkeypatch):
    """track_file runs on the card unless the caller asks for the CPU: its
    default asks for CUDA, which raises here, and device="cpu" runs."""
    import io

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file

    sig = get_signal("galileo-e1b")
    raw = np.zeros(2 * 20_000, np.int8).tobytes()

    def chans():
        return [TrackChannel(prn=11, doppler=900.0, code_offset=4000.0)]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        track_file(sig, io.BytesIO(raw), 2.048e6, 0.0, chans())
    out = track_file(sig, io.BytesIO(raw), 2.048e6, 0.0, chans(),
                     device="cpu")
    assert len(out[0].rows) > 0


def test_receiver_and_recovery_default_to_the_card(monkeypatch, tmp_path):
    """The receiver, a recovery run (B2bI by default) and a checkpoint's
    load ask for CUDA unless told otherwise, which raises here; on the
    CPU they run and launch no kernel.  CodeRecovery takes no device: its
    bins lie on the device of the blocks it is given."""
    import inspect
    import io

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_fused, track_step
    from gnss_dsp_tpu_torch.track import checkpoint
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file
    from gnss_dsp_tpu_torch.track.engine import init_state
    from gnss_dsp_tpu_torch.track.receiver import track_receiver
    from gnss_dsp_tpu_torch.track.recover import CodeRecovery

    raw = np.zeros(2 * 60_000, np.int8).tobytes()
    l1, b2b = get_signal("gps-l1"), get_signal("beidou-b2bi")

    def bands():
        return [(io.BytesIO(raw), [l1],
                 [TrackChannel(prn=3, doppler=0.0, code_offset=10.0)], [0.0])]

    def recover(**kw):
        ch = [TrackChannel(prn=19, doppler=0.0, code_offset=0.0)]
        track_file(b2b, io.BytesIO(raw), 22e6, 0.0, ch, **kw)
        return ch[0]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        track_receiver(bands(), 4.096e6)
    with pytest.raises(RuntimeError, match="is_available"):
        recover()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, init_state([0.0], [0.0], [0.0], [0.0]))
    with pytest.raises(RuntimeError, match="is_available"):
        checkpoint.load(path)
    assert checkpoint.load(path, "cpu")[0].ptr.device.type == "cpu"
    assert list(inspect.signature(CodeRecovery).parameters) == [
        "code_length", "warmup_blocks"]
    rec = CodeRecovery(1023, warmup_blocks=0)
    rec.update(torch.ones(4096, dtype=torch.complex64), 0.0, 0.25, 1.0)
    assert rec.acc_re.device.type == "cpu" and rec.chips().shape == (1023,)
    before = (track_fused.LAUNCHES, track_step.LAUNCHES_V2)
    assert len(track_receiver(bands(), 4.096e6, device="cpu")[0].rows) > 0
    assert recover(device="cpu", recover_after=0).recovered.shape == (10230,)
    assert (track_fused.LAUNCHES, track_step.LAUNCHES_V2) == before


def test_cpu_run_launches_no_kernel():
    from gnss_dsp_tpu_torch.acquire.engine import surface_v1
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire, acquire2, acquire_coh
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, track_scan

    from gnss_dsp_tpu_torch.ops import track_step

    def counters():
        return (acquire2.LAUNCHES, track_fused.LAUNCHES,
                acquire_coh.LAUNCHES_SPEC, acquire_coh.LAUNCHES_BLK,
                acquire.LAUNCHES, track_step.LAUNCHES_V2,
                track_step.LAUNCHES_V1, acquire2.LAUNCHES_SURFACE)

    before = counters()
    g = torch.Generator().manual_seed(0)
    F = torch.randn((2, 4, 64), generator=g, dtype=torch.complex64)
    code = torch.randn((2, 64), generator=g, dtype=torch.complex64)
    peak, idx, sm = acquire2.corr_surface2(F, code)
    assert peak.shape == (2, 2) and idx.dtype == torch.int32
    peak, idx, sm = acquire2.corr_surface2(F, code, 32)
    assert int(idx.max()) < 32
    assert surface_v1(F, code).shape == (2, 2, 64)
    assert acquire2.corr_surface2(F, code, 0, False).shape == (2, 2, 64)
    peak, idx, al = acquire_coh.corr_surface_coh_spec(F, code, 2)
    assert peak.shape == (2, 2) and al.dtype == torch.int32
    peak, idx, al = acquire_coh.corr_surface_coh(
        F, code, torch.ones((2, 4)), torch.zeros((2, 4)), torch.ones((1, 4)),
        2)
    assert peak.shape == (2, 2) and int(al.max()) == 0
    sig = get_signal("gps-l1")
    p = make_params(sig, 2.048e6, 0.0)
    x = torch.zeros(40_000, dtype=torch.complex64)
    st = init_state([3.0], [0.0], [0.0], [500.0])
    tab = torch.from_numpy(sig.code_table((5,)).astype(np.int8))
    _, rf, ri = track_scan(x, 30_000, tab, st, p, 3)
    assert ri.shape == (3, 1, 3) and (ri[:, 0, 0] > 0).all()
    for name, v1 in (("galileo-e1b", False), ("gps-l1cp", True)):
        sig = get_signal(name)
        p = make_params(sig, 2.048e6, 0.0)._replace(pallas_v2=not v1)
        assert p.fused_scan
        tab = torch.from_numpy(sig.code_table((5,)).astype(np.int8))
        for fused in (True, False):
            _, rf, ri = track_scan(x, 30_000, tab, st,
                                   p._replace(fused_scan=fused), 3)
            assert (ri[:, 0, 0] > 0).all()
    assert counters() == before == (0,) * 8


def test_track_kernel_wrapper_refuses_cpu_tensors():
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, sigp_from_params

    sig = get_signal("gps-l1")
    p = make_params(sig, 2.048e6, 0.0)
    n0 = track_fused.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        track_fused.track_scan_fused(
            torch.zeros(40_000, dtype=torch.complex64),
            torch.full((1,), 30_000, dtype=torch.int32),
            torch.from_numpy(sig.code_table((5,)).astype(np.int8)),
            init_state([3.0], [0.0], [0.0], [500.0]), p, 3,
            torch.full((1,), 1540.0), torch.zeros(1, dtype=torch.int32),
            sigp_from_params(p, 1, device="cpu"))
    assert track_fused.LAUNCHES == n0


def test_track_step_wrappers_refuse_cpu_tensors():
    from gnss_dsp_tpu_torch.ops import track_step

    si = torch.zeros((2, 9), dtype=torch.int32)
    sf = torch.zeros((2, 8), dtype=torch.float32)
    x = torch.zeros(8192, dtype=torch.complex64)
    code = torch.ones((2, 1023), dtype=torch.int8)
    n0 = (track_step.LAUNCHES_V2, track_step.LAUNCHES_V1)
    with pytest.raises(ValueError, match="CUDA"):
        track_step.epl_correlate2(si, sf, x, code, 4096, "subc")
    with pytest.raises(ValueError, match="CUDA"):
        track_step.epl_correlate(si, sf, x, code, 4096, "cboc")
    with pytest.raises(ValueError, match="kind"):
        track_step.epl_correlate2(si, sf, x, code, 4096, "cboc")
    assert (track_step.LAUNCHES_V2, track_step.LAUNCHES_V1) == n0


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    from gnss_dsp_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(1, "launch")


def test_build_hash_follows_the_sources():
    from gnss_dsp_tpu_torch.ops import _build

    srcs = [os.path.basename(p) for p in _build._sources()]
    assert srcs == ["acq_cluster.cuh", "acquire.cu", "acquire2.cu",
                    "acquire_coh.cu", "acquire_coh_spec.cu",
                    "cluster_launch.cuh",
                    "track_corr.cuh", "track_fused.cu", "track_rows.cu",
                    "track_step.cu"]
    path = _build.lib_path()
    assert path.startswith(os.path.join(ROOT, "gnss_dsp_tpu_torch", "_build"))
    assert path == _build.lib_path()


def test_build_flags_per_source():
    """The tracking kernels and the rows' text keep --fmad=false; the
    cluster surface kernels K1, K5, K6 and K7 build with contraction; the
    flags are the same but for that one."""
    from gnss_dsp_tpu_torch.ops import _build

    pinned = ["track_fused.cu", "track_rows.cu", "track_step.cu"]
    for src in pinned:
        assert "--fmad=false" in _build.flags(src), src
    for src in ("acquire.cu", "acquire2.cu", "acquire_coh.cu",
                "acquire_coh_spec.cu"):
        assert "--fmad=false" not in _build.flags(src), src
        assert _build.flags(src) + ["--fmad=false"] == _build.flags(pinned[0])
    assert all("-gencode" in _build.flags(s) and "arch=compute_90a,code=sm_90a"
               in _build.flags(s) for s in pinned)


def test_build_compiles_every_source_once():
    from gnss_dsp_tpu_torch.ops import _build

    steps, objs = _build.build_steps("nvcc", "/x/lib")
    compiles, (link,) = steps
    cus = sorted(os.path.basename(c[-1]) for c in compiles)
    assert cus == sorted(os.path.basename(p) for p in _build._sources()
                         if p.endswith(".cu"))
    assert len(set(cus)) == len(cus) == 7
    for cmd in compiles:
        assert cmd[1:-4] == _build.flags(cmd[-1])
        assert cmd[-4:-2] == ["-c", "-o"] and cmd[-2] in objs
    assert link[:3] == ["nvcc", "-shared", "-o"] and link[4:] == objs


def test_build_hash_follows_the_flags(monkeypatch):
    from gnss_dsp_tpu_torch.ops import _build

    path = _build.lib_path()
    monkeypatch.setattr(_build, "FMA_SOURCES", ("acquire.cu",))
    assert "--fmad=false" in _build.flags("acquire_coh_spec.cu")
    assert _build.lib_path() != path
    monkeypatch.undo()
    assert _build.lib_path() == path


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout



def test_chip_smoke_refuses_gnss_dsp_cpu(monkeypatch, capsys):
    """chip_smoke.py holds the card: with GNSS_DSP_CPU set (which pins the
    port's CLIs to the CPU) it stops at its start, naming the switch,
    before it asks for the card, and prints no result."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setenv("GNSS_DSP_CPU", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert smoke.main([]) != 0
    out = capsys.readouterr()
    assert "GNSS_DSP_CPU" in out.err and '"ok"' not in out.out
