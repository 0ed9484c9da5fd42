"""Build and load the port's CUDA kernels.

On first use, nvcc compiles each gnss_dsp_tpu_torch/csrc/*.cu to an object,
all of them at once in parallel processes, and links them into one shared
library with a plain C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v [--fmad=false]
         -c -o X.o csrc/X.cu                           (one per source)
    nvcc -shared -o _build/libgnss_kernels_<hash>.so *.o

On an H100 host with 8 cores the three sources of the first port built
in 5.9 s this way, against 10.6-11.1 s for one nvcc line over all of them.

Flags are per source (flags()).  --fmad=false keeps nvcc from contracting
a*b + c into a fused multiply-add: the two-float code phase and the
chip-boundary recurrence of the tracking kernels round differently when
contracted.  The cluster surface kernels K1 (acquire2.cu), K5
(acquire_coh_spec.cu), K6 (acquire_coh.cu) and K7 (acquire.cu) are held
to rtol 1e-4 and build with contraction (FMA_SOURCES).

The output lives in gnss_dsp_tpu_torch/_build/ and its name carries a
hash of the sources (headers included) and of each source's flags, so a
changed source or flag rebuilds.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources built with FMA contraction; every other one with --fmad=false
FMA_SOURCES = ("acquire.cu", "acquire2.cu", "acquire_coh.cu",
               "acquire_coh_spec.cu")

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}     # seconds, log, path of the library in use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p: ctypes would pass a bare python int as a 32-bit int)
SIGNATURES = {
    "acq2_reduce": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "acq2_info": [_I, _I, _P],
    "acq2_surface": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "acq2_surface_info": [_I, _I, _P],
    "acq_surface_full": [_P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "acq_full_info": [_I, _I, _I, _I, _I, _I, _I, _P],
    "track_fused": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _F, _F,
                    _I, _I, _P],
    "track_fused_info": [_I, _I, _I, _I, _P],
    "acq_coh_spec": [_P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "acq_coh_spec_surface": [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "acq_coh_spec_info": [_I, _I, _P],
    "acq_coh_blk": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "track_step_v2": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P,
                      _I, _I, _I, _I, _P],
    "track_step_v1": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P,
                      _I, _I, _I, _I, _P],
    "track_step_floor": [_I, _I, _P],
    "track_step_info": [_I, _I, _I, _I, _P],
    "track_rows": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   ctypes.c_longlong, _P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def flags(source: str) -> list:
    """nvcc's flags for one csrc/*.cu source."""
    pin = [] if os.path.basename(source) in FMA_SOURCES else ["--fmad=false"]
    return BASE_FLAGS + pin


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
        if path.endswith(".cu"):
            h.update(" ".join(flags(path)).encode())
    return os.path.join(BUILD_DIR, f"libgnss_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands in parallel; (returncode, cmd, output) each."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in procs]
    return [(rc, c, text) for c, text, rc in outs]


def build_steps(nvcc: str, tag: str):
    """(steps, objects): the nvcc commands that build the library at
    `tag`.tmp, one compile per .cu source (run together), then the link."""
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(p)}.o" for p in cus]
    return ([[[nvcc, *flags(cu), "-c", "-o", o, cu]
              for cu, o in zip(cus, objs)],
             [[nvcc, "-shared", "-o", f"{tag}.tmp", *objs]]], objs)


def _compile(out: str) -> str:
    """Build the library at `out`; returns nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out}.{os.getpid()}"
    steps, objs = build_steps(_nvcc(), tag)
    log = ""
    try:
        for cmds in steps:
            for rc, cmd, text in _run_all(cmds):
                log += text
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n"
                                       f"{' '.join(cmd)}\n{text}")
        os.replace(f"{tag}.tmp", out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


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
            log = _compile(out)
        lib = ctypes.CDLL(out)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log, path=out)
        _lib = lib
        return lib


def ptxas_summary(log: str, pattern: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, smem}} from nvcc
    -Xptxas -v output, for the entry functions whose (mangled) name
    matches the regular expression `pattern`."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point (a
    refused launch never runs and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
