"""Build and load the port's CUDA kernels.

On first use, nvcc compiles gnss_dsp_tpu_torch/csrc/*.cu into one shared
library with a plain C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/libgnss_kernels_<hash>.so csrc/*.cu

The output lives in gnss_dsp_tpu_torch/_build/ and its name carries a
hash of the sources and flags, so a changed source rebuilds.  --fmad=false
keeps nvcc from contracting a*b + c into a fused multiply-add: the
two-float code phase and the chip-boundary recurrence round differently
when contracted.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}     # seconds, log, path of the library in use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p: ctypes would pass a bare python int as a 32-bit int)
SIGNATURES = {
    "acq2_reduce": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "track_fused": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _F, _I, _I, _F, _F, _F, _F, _F, _F, _P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")


def lib_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgnss_kernels_{h.hexdigest()[:16]}.so")


def load():
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cus = [p for p in _sources() if p.endswith(".cu")]
            cmd = [_nvcc(), *FLAGS, "-o", tmp, *cus]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log, path=out)
        _lib = lib
        return lib


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point (a
    refused launch never runs and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
