"""The port stands alone and hides nothing:

  * every module of gnss_dsp_tpu_torch (and chip_smoke.py) imports
    without loading jax, in a fresh interpreter;
  * asking for CUDA where there is none raises, and never runs on the CPU;
  * a CPU run launches no kernel (both launch counters stay 0);
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
    code = ("import importlib, sys\n"
            f"for n in {names!r} + ['chip_smoke']:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'jaxlib')\n"
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
    assert resolve_device("cpu").type == "cpu"


def test_cpu_run_launches_no_kernel():
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire2, track_fused
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, track_scan

    la, lt = acquire2.LAUNCHES, track_fused.LAUNCHES
    g = torch.Generator().manual_seed(0)
    F = torch.randn((2, 3, 64), generator=g, dtype=torch.complex64)
    code = torch.randn((2, 64), generator=g, dtype=torch.complex64)
    peak, idx, sm = acquire2.corr_surface2(F, code)
    assert peak.shape == (2, 2) and idx.dtype == torch.int32
    sig = get_signal("gps-l1")
    p = make_params(sig, 2.048e6, 0.0)
    x = torch.zeros(40_000, dtype=torch.complex64)
    st = init_state([3.0], [0.0], [0.0], [500.0])
    tab = torch.from_numpy(sig.code_table((5,)).astype(np.int8))
    _, rf, ri = track_scan(x, 30_000, tab, st, p, 3)
    assert ri.shape == (3, 1, 3) and (ri[:, 0, 0] > 0).all()
    assert (acquire2.LAUNCHES, track_fused.LAUNCHES) == (la, lt) == (0, 0)


def test_track_kernel_wrapper_refuses_cpu_tensors():
    from gnss_dsp_tpu.models import get_signal
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
            sigp_from_params(p, 1))
    assert track_fused.LAUNCHES == n0


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
    assert srcs == ["acquire2.cu", "track_fused.cu"]
    path = _build.lib_path()
    assert path.startswith(os.path.join(ROOT, "gnss_dsp_tpu_torch", "_build"))
    assert path == _build.lib_path()


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

