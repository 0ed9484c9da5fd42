"""Time build variants of kernel K2 (csrc/track_fused.cu) on the card.

    python -m gnss_dsp_tpu_torch.tools.k2_variants
        [--variants base,stamps,...] [--root DIR]

For each variant this tool copies the csrc of the repository at --root
(default: this one) to _work/k2_variants/NAME/csrc, patches it, builds it
there with that tree's ops/_build.py, and runs that tree's chip_smoke.py
phase k2 in a fresh interpreter (cwd --root): K2 against its plain
version at the tracking bench shape (32 GPS L1 channels x 900 blocks at
4.096 MHz) and at every family shape (e2e_track's five, the coherent B1I
and GPS L5Q ones), with its checks, then timed with CUDA events.

  base        the sources as they are
  stamps      clock64() marks in thread 0 of CTA rank 0 of every channel
              (< 64), summed over the launch's blocks by phase and written
              to a __device__ buffer the tool reads after each launch
              (k2_stamps); with the cycles and the %globaltimer
              nanoseconds of the whole block loop, so cycles convert to
              microseconds at the clock the card ran.  On the cluster
              kernel the phases are its K2_MARK hooks; on a one-CTA kernel
              (an older tree at --root) marks are put at its phase
              boundaries.  The extra syncs make its times no yardstick.
  threads512  512 worker threads a CTA instead of 256 (one CTA an SM)
  spread      one CTA an SM: the launch asks for 116 KB of shared memory
              a CTA, whatever the plan's stages need
  unroll4     the sample loop unrolled by 4 instead of 2
  fmodmod     the filter's floor-mod by 1 through fmodf(a, 1) instead of
              copysignf(a - truncf(a), a) (the same bits)

It prints one JSON line per variant (bench and family times, the k2 log
lines, ptxas's registers and spills of the K2 kernels, and with stamps
the split a block of each launch shape), then the nvidia-smi name and
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gnss_dsp_tpu_torch.tools.variants import prepare, repo_root, run_child

VARIANTS = ("base", "stamps", "threads512", "spread", "unroll4", "fmodmod")

# phases of a block, by mark slot
HOOK_PHASES = ("serial", "tma_wait", "samples", "cta_reduce", "dsmem_write",
               "cluster_barrier", "rank_sum")
ONE_CTA_PHASES = ("geometry", "barrier1", "samples", "warp_reduce",
                  "barrier2", "filter", "barrier3")

# the reader of the device buffer (per channel: 8 phase sums, blocks,
# loop cycles, loop nanoseconds); each launch rewrites the rows of its
# channels
STAMP_READER = r"""
extern "C" int k2_stamps(void* host, int n) {
  if (n > 64 * 11) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, k2_stamp_buf,
                                   (size_t)n * sizeof(unsigned long long));
}
"""
STAMP_DEFS = r"""
__device__ __forceinline__ long long k2_gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K2_MARK_INIT                                              \
  long long k2_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};                 \
  long long k2_last = clock64();                                  \
  const long long k2_c0 = k2_last, k2_g0 = k2_gtime();
#define K2_MARK(k)                                                \
  do {                                                            \
    const long long k2_now = clock64();                           \
    k2_acc[k] += k2_now - k2_last;                                \
    k2_last = k2_now;                                             \
  } while (0)
#define K2_MARK_END(rank0, c, blocks)                             \
  do {                                                            \
    if ((rank0) && threadIdx.x == 0 && (c) < 64) {                \
      unsigned long long* o = k2_stamp_buf + (size_t)(c) * 11;    \
      for (int j = 0; j < 8; ++j) o[j] = (unsigned long long)k2_acc[j]; \
      o[8] = (unsigned long long)(blocks);                        \
      o[9] = (unsigned long long)(clock64() - k2_c0);             \
      o[10] = (unsigned long long)(k2_gtime() - k2_g0);           \
    }                                                             \
  } while (0)
"""
STAMP_BUF = "\n__device__ unsigned long long k2_stamp_buf[64 * 11];\n"


def _hook_patches():
    """stamps on the cluster kernel: define its K2_MARK hooks."""
    return (
        ("track_fused.cu", "#define K2_MARK_INIT\n#define K2_MARK(k)\n"
         "#define K2_MARK_END(rank0, c, blocks)\n",
         STAMP_BUF + STAMP_DEFS),
        ("track_fused.cu", "}  // namespace\n",
         "}  // namespace\n" + STAMP_READER),
    )


def _one_cta_patches():
    """stamps on a one-CTA-a-channel kernel: marks at its phase
    boundaries (thread 0 runs the geometry and the filter)."""
    f = "track_fused.cu"
    return (
        (f, "namespace {\n\nusing gnss_track::kLut;",
         "namespace {\n" + STAMP_BUF + STAMP_DEFS + "\nusing gnss_track::kLut;"),
        (f, "  const int tid = threadIdx.x;\n",
         "  const int tid = threadIdx.x;\n  K2_MARK_INIT\n"),
        (f, "  for (int b = 0; b < B; ++b) {\n    if (tid == 0) {",
         "  for (int b = 0; b < B; ++b) {\n    k2_last = clock64();\n"
         "    if (tid == 0) {"),
        (f, "      g_carr_p0 = fixed_u32(mod1(carr_p));\n    }\n"
            "    __syncthreads();\n",
         "      g_carr_p0 = fixed_u32(mod1(carr_p));\n    }\n    K2_MARK(0);\n"
         "    __syncthreads();\n    K2_MARK(1);\n"),
        (f, "          tid, g_n, blockDim.x, acc);\n    }\n",
         "          tid, g_n, blockDim.x, acc);\n    }\n    K2_MARK(2);\n"),
        (f, "      for (int j = 0; j < 6; ++j) red[tid >> 5][j] = acc[j];\n"
            "    }\n    __syncthreads();\n",
         "      for (int j = 0; j < 6; ++j) red[tid >> 5][j] = acc[j];\n"
         "    }\n    K2_MARK(3);\n    __syncthreads();\n    K2_MARK(4);\n"),
        (f, "        stalled = 0;\n      }\n    }\n    __syncthreads();\n  }\n",
         "        stalled = 0;\n      }\n    }\n    K2_MARK(5);\n"
         "    __syncthreads();\n    K2_MARK(6);\n  }\n"
         "  K2_MARK_END(true, c, B);\n"),
        (f, "}  // namespace\n", "}  // namespace\n" + STAMP_READER),
    )


# (file, old, new): each old must be found exactly once
PATCHES = {
    "threads512": (("track_fused.cu", "constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;"),
                   ("track_fused.cu", "constexpr int kMinBlocks = 2;",
                    "constexpr int kMinBlocks = 1;")),
    "spread": (("track_fused.cu",
                "cluster, (size_t)pl.smem, (cudaStream_t)stream",
                "cluster, (size_t)max(pl.smem, 116 * 1024), "
                "(cudaStream_t)stream"),),
    "unroll4": (("track_fused.cu", "#pragma unroll 2\n",
                 "#pragma unroll 4\n"),),
    "fmodmod": (("track_fused.cu", "  float m = copysignf(a - truncf(a), a);",
                 "  float m = fmodf(a, 1.0f);"),),
}

# run in a fresh interpreter at the repository root: argv = csrc build
# stamps(0/1)
CHILD = r"""
import ctypes, json, sys
csrc, build, stamps = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path.insert(0, ".")
from gnss_dsp_tpu_torch.ops import _build as b
b.CSRC, b.BUILD_DIR = csrc, build
lib = b.load()
import numpy as np
import torch
import chip_smoke as cs
from gnss_dsp_tpu_torch.ops import track_fused as tf
card = cs.card_line()
dev = torch.device("cuda", 0)
marks = {}
if stamps:
    read = lib.k2_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    orig = tf.track_scan_fused

    def spy(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        buf = np.zeros((64, 11), np.uint64)
        b.check(read(buf.ctypes.data, buf.size), "k2_stamps")
        C, p = a[3].ptr.shape[0], a[4]
        key = f"C{C} nmax{p.nmax} L{a[2].shape[1]} M{p.coh_blocks}"
        if hasattr(tf, "cluster_plan"):
            S = kw.get("cluster") or tf.cluster_plan(C, p.nmax)["cluster"]
            key += f" S{S}"
        marks[key] = buf[:min(C, 64)].tolist()
        return out

    tf.track_scan_fused = spy
results = {"track_fused": {}}
cs.phase_k2(dev, card, results)
print("VARIANT " + json.dumps(dict(card=card, bench=results["track_fused"],
                                   marks=marks, log=b.BUILD_INFO["log"])))
"""


def split(rows, phases):
    """Per-block mean cycles and microseconds of each phase over the
    channels of one launch (rows of k2_stamp_buf), at the clock the loop
    ran (its cycles over its %globaltimer nanoseconds)."""
    rows = [r for r in rows if r[8] > 0]
    if not rows:
        return None
    blocks = sum(r[8] for r in rows)
    ghz = sum(r[9] for r in rows) / max(1, sum(r[10] for r in rows))
    cyc = {p: sum(r[k] for r in rows) / blocks for k, p in enumerate(phases)}
    return dict(channels=len(rows), blocks=blocks / len(rows),
                ghz=round(ghz, 4),
                us_a_block={p: round(v / ghz / 1e3, 4) for p, v in cyc.items()},
                us_block_total=round(sum(cyc.values()) / ghz / 1e3, 4))


def patches_of(root: str, name: str) -> tuple:
    """(the variant's patches of ROOT's csrc, the stamp phases or None)."""
    if name != "stamps":
        return PATCHES.get(name, ()), None
    with open(os.path.join(root, "gnss_dsp_tpu_torch", "csrc",
                           "track_fused.cu")) as f:
        hooked = "#define K2_MARK(k)\n" in f.read()
    if hooked:
        return _hook_patches(), HOOK_PHASES
    return _one_cta_patches(), ONE_CTA_PHASES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--root", default=repo_root())
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from gnss_dsp_tpu_torch.ops._build import ptxas_summary

    card = None
    for name in args.variants.split(","):
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}: {VARIANTS}")
        patches, phases = patches_of(root, name)
        work = os.path.join(root, "_work", "k2_variants", name)
        csrc = prepare(root, work, patches, name)
        got, lines = run_child(CHILD, (csrc, os.path.join(work, "build"),
                                       "1" if phases else "0"),
                               root, "VARIANT", f"variant {name}")
        card = got["card"]
        k2_log = [x for x in lines if x.startswith("[k2]")]
        fams = [json.loads(x[len("[k2] families "):]) for x in k2_log
                if x.startswith("[k2] families ")]
        out = dict(
            variant=name,
            bench=dict({k: got["bench"].get(k) for k in ("ms", "plain_ms",
                                                         "bound_ms")},
                       **{k: got["bench"].get("shapes", [{}])[0].get(k)
                          for k in ("direct_ms", "s1_ms", "plan")}),
            families=[{k: f.get(k) for k in ("name", "channels", "ms",
                                             "direct_ms", "s1_ms", "bound_ms",
                                             "blocks", "plan")}
                      for f in (fams[0] if fams else [])],
            k2_kernels=ptxas_summary(got["log"], r"track_fused_kernel"),
            k2_log=[x for x in k2_log if not x.startswith("[k2] families ")])
        if phases:
            out["split"] = {k: split(v, phases)
                            for k, v in got["marks"].items()}
        print(json.dumps(out), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
