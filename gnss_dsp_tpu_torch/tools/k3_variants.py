"""Time kernels K3 and K4 (csrc/track_step.cu), build variants of them and
another tree's, on the card in one call and with one timing function.

    python -m gnss_dsp_tpu_torch.tools.k3_variants
        [--runs base,lut_ldg,stage,parent,stamps+stage,...]
        [--parent DIR]

Runs go in the order given (repeat a name to interleave, e.g.
parent,base,base,parent); a run joins variants with "+".  For each run
this tool copies the csrc of its tree (this repository; --parent for
`parent`) to _work/k3_variants/RUN/csrc, patches it, builds it there with
that tree's ops/_build.py, and in a fresh interpreter (cwd the tree)
calls that tree's per-step correlator as its engine does
(track/engine.kernel_correlate) on the lanes of one step: K3 and K4 at
the tracking bench shape (32 GPS L1 channels at 4.096 MHz) and K3 at the
GPS L1 e2e shape (8 channels at 8.184 MHz), each launch held against the
tree's plain version (one float32 ulp) and a second launch (bit-equal).
Every run, the parent's too, is timed by this repository's tools/timing:
the nodes of a CUDA graph of one call, torch.profiler's kernels with the
events its trace kept a call, and CUDA events over replays of a graph of
50 calls.

  base       the sources as they are
  barrier    the ranks' sums written into rank 0's shared memory with
             plain stores behind a cluster barrier (arrive.release,
             wait.acquire) instead of st.async on rank 0's mbarrier
  lut_ldg    the carrier LUT read from device memory (through L1) instead
             of staged in shared memory by a bulk copy
  chip_ldg   every code's chips read from device memory with __ldg, as
             the long codes are, instead of the short codes' row staged in
             shared memory by a bulk copy
  stage      the rank's tiles of samples (as many as 227 KB of shared
             memory holds) staged in shared memory by bulk copies the
             lanes of warp 0 issue once si has arrived, instead of read
             with __ldg in the sample loop
  threads512 512 threads a CTA instead of 256
  ctas2x     clusters up to twice as large: C x S <= 264 (2 CTAs an SM at
             32 channels) instead of 132
  ctas4x     C x S <= 528
  stamps     clock64() marks in thread 0 of every CTA at the kernel's
             K34_MARK hooks, with the %globaltimer nanoseconds at its
             entry and exit; the run launches 20 times at each case's
             shape and prints the mean cycles of each phase, the CTAs'
             entry and exit spread and the launch's span instead of
             times.  The extra stores make its times no yardstick.
  parent     the tree at --parent as it is (e.g. `git archive` of the
             parent commit unpacked under _work/)

It prints one JSON line per run (each case's graph nodes, profiler
kernels and graph time, and ptxas's registers and spills of the step
kernels and K2), then the nvidia-smi name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from gnss_dsp_tpu_torch.tools.variants import prepare, repo_root, run_child

RUNS = ("base", "barrier", "lut_ldg", "chip_ldg", "stage", "threads512",
        "ctas2x", "ctas4x", "stamps", "parent")

STAMP_DEFS = r"""
__device__ unsigned long long k34_stamp_buf[4096 * 12];
__device__ __forceinline__ long long k34_gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K34_MARK_INIT                                            \
  long long k34_t[9];                                            \
  k34_t[0] = clock64();                                          \
  const long long k34_g0 = k34_gtime();
#define K34_MARK(k) k34_t[k] = clock64()
#define K34_MARK_END                                             \
  if (threadIdx.x == 0 && blockIdx.x < 4096) {                   \
    unsigned long long* o = k34_stamp_buf + (size_t)blockIdx.x * 12; \
    for (int j = 1; j < 9; ++j)                                  \
      o[j - 1] = (unsigned long long)(k34_t[j] - k34_t[j - 1]);  \
    o[8] = (unsigned long long)(clock64() - k34_t[0]);           \
    o[9] = (unsigned long long)k34_g0;                           \
    o[10] = (unsigned long long)k34_gtime();                     \
    o[11] = 1;                                                   \
  }
"""
STAMP_READER = r"""
extern "C" int k34_stamps(void* host, int n) {
  if (n > 4096 * 12) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, k34_stamp_buf,
                                   (size_t)n * sizeof(unsigned long long));
}
"""
# the phases the hooks close, in order (thread 0 of a CTA)
PHASES = ("issue", "syncthreads", "geometry", "copy_wait", "samples",
          "cta_reduce", "cluster_start_wait", "dsmem_and_barrier")

# (file, old, new): each old must be found exactly once
PATCHES = {
    "lut_ldg": (
        ("track_step.cu",
         "    clusterk::bulk_copy(fx.lut, a.lut, kLut * (uint32_t)sizeof("
         "float2),\n                        &fx.bar[0]);\n", ""),
        ("track_step.cu", "kLut * (uint32_t)sizeof(float2) + code_bytes",
         "code_bytes"),
        ("track_step.cu", "fx.lut, g, L, coef,", "a.lut, g, L, coef,"),
    ),
    "chip_ldg": (
        ("track_step.cu", "return L <= kMaxCode ? kernel_of<true>(v1, sel) "
         ": kernel_of<false>(v1, sel);", "return kernel_of<false>(v1, sel);"),
    ),
    "barrier": (
        ("track_step.cu",
         "    if (rank != 0) {\n"
         "      // into rank 0's part[rank], completing on its bar[1]\n"
         "      clusterk::st_async_b64(clusterk::map_rank(&fx.part[rank][tid], "
         "0), v,\n"
         "                             clusterk::map_rank(&fx.bar[1], 0));\n"
         "    } else {\n"
         "      clusterk::mbar_wait(&fx.bar[1], 0);\n"
         "      double t = 0.0;\n"
         "      t += v;\n"
         "      for (int r = 1; r < S; ++r) t += fx.part[r][tid];\n"
         "      a.out[(size_t)c * 6 + tid] = (float)t;\n"
         "    }\n"
         "  }\n",
         "    *cluster.map_shared_rank(&fx.part[rank][tid], 0) = v;\n"
         "  }\n"
         "  clusterk::cluster_arrive();\n"
         "  clusterk::cluster_wait();\n"
         "  if (rank == 0 && tid < 6) {\n"
         "    double t = 0.0;\n"
         "    for (int r = 0; r < S; ++r) t += fx.part[r][tid];\n"
         "    a.out[(size_t)c * 6 + tid] = (float)t;\n"
         "  }\n"),
    ),
    "stage": (
        ("track_step.cu",
         "constexpr int kSmemBytes = (int)((sizeof(Smem) + 127) / 128 * 128);\n",
         "constexpr int kSmemBytes = (int)((sizeof(Smem) + 127) / 128 * 128);\n"
         "constexpr int kMaxStageTiles =\n"
         "    (int)((clusterk::kMaxSmem - kSmemBytes) / (kTile * 8));\n"
         "int stage_tiles(int nmax, int S) {\n"
         "  const int tpc = ((nmax + kTile) / kTile + S - 1) / S;\n"
         "  return tpc < kMaxStageTiles ? tpc : kMaxStageTiles;\n"
         "}\n"),
        ("track_step.cu", "  unsigned long long bar[2];",
         "  unsigned long long bar[3];"),
        ("track_step.cu", "  int S;   // CTAs a channel, the cluster size\n",
         "  int S;   // CTAs a channel, the cluster size\n"
         "  int stage;   // tiles of samples a rank stages at most\n"),
        ("track_step.cu", "  Smem& fx = *reinterpret_cast<Smem*>(smem);\n",
         "  Smem& fx = *reinterpret_cast<Smem*>(smem);\n"
         "  float2* stage = reinterpret_cast<float2*>(smem + kSmemBytes);\n"),
        ("track_step.cu", "    clusterk::mbar_init(&fx.bar[1]);\n",
         "    clusterk::mbar_init(&fx.bar[1]);\n"
         "    clusterk::mbar_init(&fx.bar[2]);\n"),
        ("track_step.cu", "  const int w0 = start - off;\n",
         "  const int w0 = start - off;\n"
         "  const int need = (nloop + off + kTile - 1) / kTile;\n"
         "  const int mine = need > rank ? (need - rank + S - 1) / S : 0;\n"
         "  const bool aligned = ((uintptr_t)a.x & 15) == 0;\n"
         "  const int whole = aligned ? max(0, (a.nx - w0) / kTile) : 0;\n"
         "  const int nstage = min(min(mine, a.stage),\n"
         "                         whole > rank ? (whole - rank + S - 1) / S"
         " : 0);\n"
         "  if (warp == 0) {\n"
         "    __syncwarp();\n"
         "    if (lane == 0)\n"
         "      clusterk::mbar_expect_tx(&fx.bar[2],\n"
         "                               (uint32_t)(nstage * kTile * 8));\n"
         "    __syncwarp();\n"
         "    for (int u = lane; u < nstage; u += 32)\n"
         "      clusterk::bulk_copy(stage + u * kTile,\n"
         "                          a.x + w0 + (rank + S * u) * kTile,\n"
         "                          kTile * 8, &fx.bar[2]);\n"
         "  }\n"),
        ("track_step.cu", "  clusterk::mbar_wait(&fx.bar[0], 0);\n",
         "  clusterk::mbar_wait(&fx.bar[0], 0);\n"
         "  clusterk::mbar_wait(&fx.bar[2], 0);\n"),
        ("track_step.cu",
         "  if (pos0 < off) pos0 += stride;   // before the block's first "
         "sample\n",
         "  int e0 = tid;\n"
         "  if (pos0 < off) {\n    pos0 += stride;\n    e0 += kThreads;\n"
         "  }\n"),
        ("track_step.cu",
         "    for (int pos = pos0; pos - off < nloop; pos += stride)\n",
         "    for (int pos = pos0, e = e0; pos - off < nloop;\n"
         "         pos += stride, e += kThreads)\n"),
        ("track_step.cu", "          __ldg(xw + pos), pos - off,",
         "          e < nstage * kTile ? stage[e] : __ldg(xw + pos), "
         "pos - off,"),
        ("track_step.cu", "(float*)out, nmax, cluster};",
         "(float*)out, nmax, cluster,\n"
         "                  stage_tiles(nmax, cluster)};"),
        ("track_step.cu",
         "                                       (size_t)kSmemBytes,\n"
         "                                       (cudaStream_t)stream, args);",
         "                                       (size_t)kSmemBytes +\n"
         "                                       args.stage * kTile * 8,\n"
         "                                       (cudaStream_t)stream, args);"),
    ),
    "threads512": (
        ("track_step.cu", "constexpr int kThreads = 256;",
         "constexpr int kThreads = 512;"),
    ),
    "stamps": (
        ("track_step.cu", "#define K34_MARK_INIT\n#define K34_MARK(k)\n"
         "#define K34_MARK_END\n", STAMP_DEFS),
        ("track_step.cu", "}  // namespace\n",
         "}  // namespace\n" + STAMP_READER),
    ),
}
# the Python mirror of a patched plan (ops/track_step constants)
PY_OVERRIDES = {"threads512": {"THREADS": 512},
                "ctas2x": {"SMS": 2 * 132}, "ctas4x": {"SMS": 4 * 132}}

# (tag, signal, channels, fs, v1, seed): the cases of every run
CASES = (("k3", "gps-l1", 32, 4.096e6, False, 31),
         ("k4", "gps-l1", 32, 4.096e6, True, 41),
         ("k3", "gps-l1", 8, 8.184e6, False, 32))

# run in a fresh interpreter at the tree's root: argv = csrc build cases
# overrides stamps(0/1) timing.py
CHILD = r"""
import ctypes, importlib.util, json, sys
csrc, build, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
overrides, stamps = json.loads(sys.argv[4]), sys.argv[5] == "1"
sys.path.insert(0, ".")
from gnss_dsp_tpu_torch.ops import _build as b
b.CSRC, b.BUILD_DIR = csrc, build
lib = b.load()
import numpy as np
import torch
import chip_smoke as cs
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.ops import track_step as ts
from gnss_dsp_tpu_torch.track import engine
from gnss_dsp_tpu_torch.track.driver import make_params
# the timing of the tool's own repository, whatever the tree
spec = importlib.util.spec_from_file_location("k3_timing", sys.argv[6])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
for k, v in overrides.items():
    setattr(ts, k, v)
card = cs.card_line()
dev = torch.device("cuda", 0)
out = []


def lanes(C, fs, nmax, seed):
    # one step's lanes at a GPS L1 shape: n of a millisecond, random
    # phases and starts, a random chunk and code
    rng = np.random.default_rng(seed)
    n = int(fs * 1e-3)
    nx = 64 * nmax
    si = np.zeros((C, 9), np.int32)
    sf = np.zeros((C, 8), np.float32)
    cp = rng.uniform(0, 1023, C)
    for k, lag in enumerate((-0.5, 0.0, 0.5)):
        si[:, k] = np.floor(cp + lag)
        sf[:, k] = cp + lag - np.floor(cp + lag)
    si[:, 3] = rng.integers(-(1 << 20), 1 << 20, C)
    si[:, 4] = n + rng.integers(-3, 4, C)
    si[:, 5] = rng.integers(-(1 << 31), 1 << 31, C)
    si[:, 6] = rng.integers(-(1 << 20), 1 << 20, C)
    si[:, 7] = rng.integers(-(1 << 31), 1 << 31, C)
    si[:, 8] = rng.integers(0, nx - nmax, C)
    sf[:, 3] = 1.023e6 / fs
    x = (rng.standard_normal(nx) + 1j * rng.standard_normal(nx)
         ).astype(np.complex64)
    code = rng.choice([-1, 1], (C, 1023)).astype(np.int8)
    return [torch.from_numpy(a).to(dev) for a in (si, sf, x, code)]


for tag, name, C, fs, v1, seed in cases:
    params = make_params(get_signal(name), fs, 0.0)._replace(
        fused_scan=False, pallas_v2=not v1)
    nmax = params.nmax
    si, sf, x, code = lanes(C, fs, nmax, seed)
    kern = engine.kernel_correlate(params)
    call = lambda: kern(si, sf, x, code)
    if not stamps:
        got = call()
        want = ts.epl_correlate_plain(si, sf, x, code, nmax, "none", v1=v1)
        env = want.abs().amax(dim=1, keepdim=True)
        ulp = torch.nextafter(env, torch.full_like(env, np.inf)) - env
        err = float((got - want).abs().max())
        assert bool(((got - want).abs() <= ulp).all()), (tag, err)
        assert torch.equal(got, call()), (tag, "two launches differ")
        nodes = timing.graph_nodes(call)
        prof = timing.profiled_kernels(call, 50)
        out.append(dict(
            tag=tag, name=name, C=C, fs=fs, nmax=nmax, max_abs_err=err,
            graph_nodes=[f"{k} {n}" for k, n in nodes],
            profiler={k: dict(kept=c, us=t * 1e3)
                      for k, (c, t) in prof.items()},
            profiler_us=(sum(t for _, t in prof.values()) * 1e3
                         if prof and min(c for c, _ in prof.values())
                         >= timing.KEPT_SHARE else None),
            graph_us=timing.graph_ms(call, 50, 5) * 1e3))
        continue
    read = lib.k34_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    runs = []
    for _ in range(20):
        call()
        torch.cuda.synchronize()
        buf = np.zeros((4096, 12), np.uint64)
        b.check(read(buf.ctypes.data, buf.size), "k34_stamps")
        rows = buf[buf[:, 11] == 1].astype(np.float64)
        buf[:] = 0
        runs.append(rows)
    rows = np.concatenate(runs[5:])
    per = [r for r in runs[5:]]
    ghz = rows[:, 8].sum() / (rows[:, 10] - rows[:, 9]).sum()
    S = ts.step_plan(C)["cluster"]
    rank = np.concatenate([np.arange(r.shape[0]) % S for r in per])
    out.append(dict(tag=tag, name=name, C=C, fs=fs, ctas=int(per[0].shape[0]),
                    total_by_rank=[round(float(rows[rank == k, 8].mean()), 1)
                                   for k in range(S)],
                    ghz=round(float(ghz), 4),
                    cycles={p: round(float(rows[:, j].mean()), 1)
                            for j, p in enumerate(%PHASES%)},
                    cycles_total=round(float(rows[:, 8].mean()), 1),
                    cycles_total_max=round(float(rows[:, 8].max()), 1),
                    entry_spread_ns=float(np.mean([r[:, 9].max() - r[:, 9].min()
                                                   for r in per])),
                    exit_spread_ns=float(np.mean([r[:, 10].max() - r[:, 10].min()
                                                  for r in per])),
                    span_ns=float(np.mean([r[:, 10].max() - r[:, 9].min()
                                           for r in per]))))
print("RUN " + json.dumps(dict(card=card, cases=out,
                               log=b.BUILD_INFO["log"])))
""".replace("%PHASES%", repr(PHASES))


def short_name(mangled: str) -> str:
    """kernel<template arguments> of a mangled step, K2 or parent kernel
    name (the anonymous namespace's hash dropped)."""
    m = re.search(r"(step_kernel|track_fused_kernel|epl_tiles|epl_finish"
                  r"|floor_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default="base,lut_ldg,chip_ldg,stage")
    ap.add_argument("--parent", default=None,
                    help="root of the tree the `parent` runs time")
    args = ap.parse_args(argv)
    root = repo_root()
    sys.path.insert(0, root)
    from gnss_dsp_tpu_torch.ops._build import ptxas_summary

    timing = os.path.join(root, "gnss_dsp_tpu_torch", "tools", "timing.py")
    card = None
    for name in args.runs.split(","):
        parts = name.split("+")
        if not set(parts) <= set(RUNS):
            raise SystemExit(f"unknown run {name!r}: {RUNS}")
        if "parent" in parts and (len(parts) > 1 or not args.parent):
            raise SystemExit("a parent run stands alone and needs --parent")
        tree = os.path.abspath(args.parent) if name == "parent" else root
        work = os.path.join(root, "_work", "k3_variants", name)
        csrc = prepare(tree, work, [p for v in parts
                                    for p in PATCHES.get(v, ())], name)
        overrides = {k: v for p in parts for k, v in
                     PY_OVERRIDES.get(p, {}).items()}
        got, lines = run_child(
            CHILD, (csrc, os.path.join(work, "build"), json.dumps(CASES),
                    json.dumps(overrides), "1" if "stamps" in parts else "0",
                    timing),
            tree, "RUN", f"run {name}")
        card = got["card"]
        for c in got["cases"]:
            if "graph_nodes" in c:
                c["graph_nodes"] = [" ".join(map(short_name, n.split()))
                                    for n in c["graph_nodes"]]
                c["profiler"] = {short_name(k): v
                                 for k, v in c["profiler"].items()}
        print(json.dumps(dict(
            run=name, cases=got["cases"],
            kernels={short_name(k): v for k, v in ptxas_summary(
                got["log"], r"step_kernel|epl_tiles|epl_finish"
                r"|track_fused_kernel").items()})), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
