"""Time kernel K6 (csrc/acquire_coh.cu), build variants of it and another
tree's K6, on the card in one call and with one timing function.

    python -m gnss_dsp_tpu_torch.tools.k6_variants
        [--runs parent,base,nosplit,cluster1,cluster4,fp32,fp32+tile416,
                mma,fused,stamps,base,parent]
        [--parent DIR]

Runs go in the order given (repeat a name to interleave).  For each run
this tool copies the csrc of its tree (this repository; --parent for
`parent`) to _work/k6_variants/RUN/csrc, patches it, builds it there with
that tree's ops/_build.py, and in a fresh interpreter (cwd the tree)
calls that tree's ops/acquire_coh.corr_surface_coh, as the coherent
engine does, at the two shapes of chip_smoke's phase k6: GPS L1
--coherent 8 (32 PRN x 102 dopplers x 80 blocks in groups of 8, A = 1,
W = 4096) and Xona X1P --coherent 100 (1 PRN x 70 dopplers x 200 blocks
in groups of 100, A = 100, its overlay), one planted cell per PRN.  Each
result is held against the tree's plain version (planted cells exact,
peak rtol 1e-4).  Every run, the parent's too, is timed by this
repository's tools/timing (torch.profiler's kernels, with the events its
trace kept a call) and by CUDA events over 10 calls.  Each run (but
stamps) then calls its tree's acquire CLI on the two searches end to end
(--device cuda): gps-l1 --coherent 8 --time 80 over +-6 kHz at 62.5 Hz
on a 0.2 s capture of 8 satellites at 8.184 MHz, and xona-x1p --coherent
100 --time 200 over +-500 Hz at 5 Hz on chip_smoke's 206 ms capture (the
tree's tools/main_path synthesises both), and gives the host wall of a
call (the median of 5 after a cold one) and K6's launches in it.

  base      the sources and the plan as they are
  nosplit   the alignments not split over clusters (a_chunk = A)
  cluster1  the surface on 1 CTA a cluster at 4096 (K5's build there, and
            ops/acquire_coh.SPEC_CLUSTERS, patched; K1's 2 the choice)
  cluster4  on 4
  fp32      the combine on combine_tile, float32 FMAs on a register tile
            of 8 alignments x 4 lags a thread (the source below), at A = 1
            too
  tile416   combine_tile's CTA at most 416 threads (13 rows of
            alignments, not 16): up to 152 registers a thread, not 128
            (after fp32: fp32+tile416)
  mma       the 3xTF32 combine (combine_mma) at A = 1 too
  fused     at A = 1 no combined rows in device memory: the surface's
            load stage sums each group's blocks itself (its cp.async of a
            row becomes m_coh weighted loads of F), no combine launch
  stamps    clock64() marks in thread 0 of each combine CTA (its cycles)
            and of rank 0 of each surface cluster (set-up, the row
            transforms of its alignments, the cluster's reduction and the
            merge), with %globaltimer at entry and exit; the run prints
            the mean cycles of each phase and the clock instead of times.
            The extra stores make its times no yardstick.
  parent    the tree at --parent as it is (e.g. `git archive` of the
            parent commit unpacked under _work/)

It prints one JSON line per run (each case's kernels and time, ptxas's
registers and spills of K6's kernels), then the nvidia-smi name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from gnss_dsp_tpu_torch.tools.variants import prepare, repo_root, run_child

RUNS = ("base", "nosplit", "cluster1", "cluster4", "fp32", "tile416", "mma",
        "fused", "stamps", "parent")
# the wrapper's keywords of a run (this tree's corr_surface_coh); -1: A
KWARGS = {"nosplit": {"a_chunk": -1}}
# the cluster size a run builds and plans at 4096
CLUSTER_4096 = {"cluster1": 1, "cluster4": 4}

STAMP_DEFS = r"""using clusterk::launch_cluster;
__device__ unsigned long long k6_stamp_buf[16384 * 8];
__device__ __forceinline__ long long k6_gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
SURFACE_MARKS = (
    ("  const int item = blockIdx.x / C;\n  const int p = item % s.P;\n"
     "  const int A = kAlign ? s.A : 1;\n",
     "  const int item = blockIdx.x / C;\n  const int p = item % s.P;\n"
     "  const int A = kAlign ? s.A : 1;\n"
     "  long long k6_t[3] = {clock64(), 0, 0};\n"
     "  const long long k6_g0 = k6_gtime();\n"),
    ("  cluster_arrive();           // pairs with the first row's wait\n",
     "  cluster_arrive();           // pairs with the first row's wait\n"
     "  k6_t[1] = clock64();\n"),
    ("  cluster_wait();             // nobody reads this CTA's yb any more\n",
     "  cluster_wait();             // nobody reads this CTA's yb any more\n"
     "  k6_t[2] = clock64();\n"),
    ("    if (kChunk && nch > 1) {\n      merge_chunk(s, o, b, nch, W);\n"
     "      return;\n    }\n",
     "    if (kChunk && item < 16384) {\n"
     "      unsigned long long* r = k6_stamp_buf + (size_t)item * 8;\n"
     "      if (nch > 1) merge_chunk(s, o, b, nch, W);\n"
     "      const long long t3 = clock64();\n"
     "      r[0] = k6_t[1] - k6_t[0];\n      r[1] = k6_t[2] - k6_t[1];\n"
     "      r[2] = t3 - k6_t[2];\n      r[3] = t3 - k6_t[0];\n"
     "      r[4] = k6_g0;\n      r[5] = k6_gtime();\n"
     "      r[6] = (unsigned long long)(a1 - a0) * G;\n      r[7] = 1;\n"
     "      if (nch > 1) return;\n    }\n"
     "    if (kChunk && nch > 1) {\n      merge_chunk(s, o, b, nch, W);\n"
     "      return;\n    }\n"),
)
# the surface's stamps live in the unit that launches it (K5's source;
# acq_cluster.cuh's names are private to each unit)
SURFACE_EXPORT = (
    "}  // namespace\n",
    "}  // namespace\n"
    "extern \"C\" int k6_stamps(void* host, int n) {\n"
    "  if (n > 16384 * 8) return (int)cudaErrorInvalidValue;\n"
    "  return (int)cudaMemcpyFromSymbol(host, acqc::k6_stamp_buf,\n"
    "                                   (size_t)n * 8);\n}\n"
    "extern \"C\" int k6_stamps_clear() {\n"
    "  void* a;\n"
    "  cudaError_t e = cudaGetSymbolAddress(&a, acqc::k6_stamp_buf);\n"
    "  if (e == cudaSuccess)\n"
    "    e = cudaMemset(a, 0, sizeof(acqc::k6_stamp_buf));\n"
    "  return (int)e;\n}\n")
COMBINE_MARKS = (
    ("namespace {\n\n// ---- stage 1: the combine",
     "namespace {\n\n"
     "__device__ unsigned long long k6_comb_buf[65536 * 4];\n"
     "#define K6_COMB_END                                                 \\\n"
     "  if (threadIdx.x == 0 && threadIdx.y == 0) {                      \\\n"
     "    const size_t q = blockIdx.x + (size_t)gridDim.x * blockIdx.y;   \\\n"
     "    if (q < 65536) {                                               \\\n"
     "      unsigned long long* r = k6_comb_buf + q * 4;                 \\\n"
     "      r[0] = clock64() - k6_c0;                                    \\\n"
     "      r[1] = k6_cg0;                                               \\\n"
     "      r[2] = acqc::k6_gtime();                                     \\\n"
     "      r[3] = 1;                                                    \\\n"
     "    }                                                              \\\n"
     "  }\n"
     "#define K6_COMB_BEGIN \\\n"
     "  const long long k6_c0 = clock64(), k6_cg0 = acqc::k6_gtime();\n"
     "\n// ---- stage 1: the combine"),
    ("__global__ void __launch_bounds__(kST) combine_stream(CombineArgs c) {\n",
     "__global__ void __launch_bounds__(kST) combine_stream(CombineArgs c) {\n"
     "  K6_COMB_BEGIN\n"),
    ("    if (e < c.W) out[e] = acc[v];\n  }\n}\n",
     "    if (e < c.W) out[e] = acc[v];\n  }\n  K6_COMB_END\n}\n"),
    ("    combine_mma(CombineArgs c) {\n",
     "    combine_mma(CombineArgs c) {\n  K6_COMB_BEGIN\n"),
    ("              comp ? make_float2(y, x1) : make_float2(x0, y);\n"
     "      }\n    }\n  }\n}\n",
     "              comp ? make_float2(y, x1) : make_float2(x0, y);\n"
     "      }\n    }\n  }\n  K6_COMB_END\n}\n"),
    ("}  // namespace\n",
     "}  // namespace\n"
     "extern \"C\" int k6_comb_stamps(void* host, int n) {\n"
     "  if (n > 65536 * 4) return (int)cudaErrorInvalidValue;\n"
     "  return (int)cudaMemcpyFromSymbol(host, k6_comb_buf, (size_t)n * 8);\n"
     "}\n"
     "extern \"C\" int k6_comb_clear() {\n"
     "  void* a;\n"
     "  cudaError_t e = cudaGetSymbolAddress(&a, k6_comb_buf);\n"
     "  if (e == cudaSuccess) e = cudaMemset(a, 0, sizeof(k6_comb_buf));\n"
     "  return (int)e;\n}\n"),
)
# fp32: the float32 combine, a register tile a thread (its source), taken
# at every A
FP32_TILE = r"""// A >= 2: grid (DC * G * nw, ceil(A / (RY TA))), nw = ceil(W / (32 TW)),
// block (32, RY).  Thread (x, y) owns lags w0 + x + 32 j (j < TW) and
// alignments a0 + y + RY i (i < TA): a warp shares its alignments, so its
// weight loads are broadcasts and its F loads 32 consecutive values.
// Shared memory, two buffers of [kBK][32 TW] F values and [kBK][RY TA]
// weights; the F tile of the next kBK blocks is copied by cp.async, and
// the inputs of its weights loaded into registers (kBK TA / 32 a thread),
// while this one is summed.
constexpr int kTA = 8, kTW = 4;
constexpr int kMaxRY = 16;
constexpr int kWPer = kBK * kTA / 32;     // weights a thread a tile

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int TA, int TW>
__global__ void __launch_bounds__(32 * kMaxRY) combine_tile(CombineArgs c) {
  constexpr int BW = 32 * TW;
  extern __shared__ __align__(16) float2 sm[];
  const int RY = blockDim.y, BA = RY * TA;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx, nt = 32 * RY;
  const int nw = (c.W + BW - 1) / BW;
  const int dg = blockIdx.x / nw;
  const int d = dg / c.G, g = dg % c.G;
  const int w0 = (blockIdx.x % nw) * BW, a0 = blockIdx.y * BA;
  // buffer b: F at sm + b*kBK*BW, weights at sm + (2*BW + b*BA)*kBK
  auto fs = [&](int b) { return sm + b * kBK * BW; };
  auto ws = [&](int b) { return sm + (2 * BW + b * BA) * kBK; };
  const float2* f = c.F + ((size_t)d * c.B + (size_t)g * c.M) * c.W + w0;
  const int nk = (c.M + kBK - 1) / kBK;
  const int wl = min(BW, c.W - w0);     // lags of this tile (W even)

  // the F tile of blocks k*kBK .. into fs(b) (zeros past M and W)
  auto stage = [&](int k, int b) {
    for (int e = tid; e < kBK * BW / 2; e += nt) {
      const int m = e / (BW / 2), w = (e % (BW / 2)) * 2;
      float2* dst = fs(b) + m * BW + w;
      const int mm = k * kBK + m;
      if (mm < c.M && w < wl)
        acqc::cp_async16(dst, f + (size_t)mm * c.W + w);
      else
        dst[0] = dst[1] = make_float2(0.f, 0.f);
    }
    acqc::cp_async_commit();
  };
  // its weights: element e = tid + nt*u of ws(b) (m = e / BA, a = e % BA)
  // from (sec, cos, sin) loaded into wr[u] (zeros past M and A), then
  // stored once they have arrived
  float wr[kWPer][3];
  auto load_w = [&](int k) {
#pragma unroll
    for (int u = 0; u < kWPer; ++u) {
      const int e = tid + nt * u;
      const int m = k * kBK + e / BA, a = a0 + e % BA;
      const bool in = m < c.M && a < c.A;
      const size_t dm = (size_t)d * c.B + g * c.M + m;
      wr[u][0] = in ? __ldg(c.sec + (size_t)a * c.B + g * c.M + m) : 0.f;
      wr[u][1] = in ? __ldg(c.cosang + dm) : 0.f;
      wr[u][2] = in ? __ldg(c.sinang + dm) : 0.f;
    }
  };
  auto store_w = [&](int b) {
#pragma unroll
    for (int u = 0; u < kWPer; ++u)
      ws(b)[tid + nt * u] =
          make_float2(wr[u][0] * wr[u][1], -wr[u][0] * wr[u][2]);
  };

  float2 acc[TA][TW];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TW; ++j) acc[i][j] = make_float2(0.f, 0.f);
  stage(0, 0);
  load_w(0);
  store_w(0);
  for (int k = 0; k < nk; ++k) {
    const int b = k & 1;
    if (k + 1 < nk) {
      stage(k + 1, b ^ 1);
      load_w(k + 1);
      cp_async_wait_one();    // tile k has landed, k + 1 may be in flight
    } else {
      acqc::cp_async_wait_all();
    }
    __syncthreads();
    const float2* fb = fs(b);
    const float2* wb = ws(b);
    const int mk = min(kBK, c.M - k * kBK);   // blocks in this tile
#pragma unroll
    for (int m = 0; m < kBK; ++m) {
      if (m == mk) break;
      float2 fv[TW], wv[TA];
#pragma unroll
      for (int j = 0; j < TW; ++j) fv[j] = fb[m * BW + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < TA; ++i) wv[i] = wb[m * BA + ty + RY * i];
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TW; ++j) cmac(acc[i][j], wv[i], fv[j]);
    }
    if (k + 1 < nk) store_w(b ^ 1);   // read after the next barrier
    __syncthreads();          // buffer b is free for tile k + 2
  }
  float2* out = c.C + ((size_t)dg * c.A) * c.W + w0;
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const int a = a0 + ty + RY * i;
    if (a >= c.A) continue;
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int w = tx + 32 * j;
      if (w < wl) out[(size_t)a * c.W + w] = acc[i][j];
    }
  }
}

// rows of alignments a block of combine_tile: RY <= kMaxRY with the fewest
// tiles of RY*TA alignments, then the fewest rows
inline int tile_ry(int A) {
  const int per = kTA * kMaxRY;
  const int tiles = (A + per - 1) / per;
  return (A + kTA * tiles - 1) / (kTA * tiles);
}

inline size_t tile_smem(int RY) {
  return (size_t)2 * kBK * (32 * kTW + RY * kTA) * sizeof(float2);
}

"""
FP32_LAUNCH = r"""  {
    const int RY = tile_ry(c.A);
    const size_t smem = tile_smem(RY);
    auto k = combine_tile<kTA, kTW>;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long n = dg * ((c.W + 32 * kTW - 1) / (32 * kTW));
    const int na = (c.A + RY * kTA - 1) / (RY * kTA);
    if (n > 0x7fffffffLL || na > 65535) return (int)cudaErrorInvalidValue;
    k<<<dim3((unsigned)n, (unsigned)na), dim3(32, RY), smem, stream>>>(c);
    return (int)cudaGetLastError();
  }
"""
MMA_AT_A1 = ("acquire_coh.cu", "  if (c.A == 1) {\n", "  if (false) {\n")
# fused: the surface's stage_row sums group i's blocks of F (A = 1), a
# launch of K5's kernel with those inputs, which K6 takes at A = 1
FUSED_SURFACE = r"""extern "C" int k6_fused_surface(
    const void* F, const void* code_f, const void* cosang,
    const void* sinang, const void* sec, void* peak, void* idx, void* al,
    int P, int DC, int B, int m_coh, int W, int n_valid, void* stream) {
  Launch l;
  if (W > 16384 || !spec_launch(l, W, 0)) return (int)cudaErrorInvalidValue;
  SurfaceArgs s = {};
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.al = (int*)al;
  s.P = P;
  s.DC = DC;
  s.rows = B / m_coh;
  s.A = 1;
  s.lo = n_valid ? W - n_valid : 0;
  s.a_chunk = 1;
  s.cosang = (const float*)cosang;
  s.sinang = (const float*)sinang;
  s.sec = (const float*)sec;
  s.fuse_m = m_coh;
  s.fuse_b = B;
  return (int)acqc::launch_cluster(l.kernel, P * DC * l.C, l.T, l.C, l.smem,
                                   (cudaStream_t)stream, s);
}

"""
# (file, old, new): each old must be found exactly once, in this order
PATCHES = {
    **{run: (("acquire_coh_spec.cu", "const int choice = L == 12 ? 2 :",
              f"const int choice = L == 12 ? {c} :"),
             ("acquire_coh_spec.cu",
              "case 12: l = launch_of<Spec<12, 2>>(); break;",
              f"case 12: l = launch_of<Spec<12, {c}>>(); break;"))
       for run, c in CLUSTER_4096.items()},
    "fp32": (("acquire_coh.cu", "// A >= 2 on the tensor cores, 3xTF32",
              FP32_TILE + "// A >= 2 on the tensor cores, 3xTF32"),
             MMA_AT_A1,
             ("acquire_coh.cu", "  const int MW = mma_warps(c.A);\n",
              FP32_LAUNCH + "  const int MW = mma_warps(c.A);\n")),
    "tile416": (("acquire_coh.cu", "constexpr int kMaxRY = 16;",
                 "constexpr int kMaxRY = 13;"),),
    "mma": (MMA_AT_A1,),
    "stamps": (("acq_cluster.cuh", "using clusterk::launch_cluster;\n",
                STAMP_DEFS),)
    + tuple(("acq_cluster.cuh", o, n) for o, n in SURFACE_MARKS)
    + (("acquire_coh_spec.cu",) + SURFACE_EXPORT,)
    + tuple(("acquire_coh.cu", o, n) for o, n in COMBINE_MARKS),
    "fused": (
        ("acq_cluster.cuh",
         "  int a_chunk;            // alignments a cluster (kChunk)\n",
         "  int a_chunk;            // alignments a cluster (kChunk)\n"
         "  const float* cosang;    // [DC, B] (fused combine, A = 1)\n"
         "  const float* sinang;\n  const float* sec;       // [1, B]\n"
         "  int fuse_m, fuse_b;     // m_coh, B (0: no fused combine)\n"),
        ("acq_cluster.cuh",
         "  auto stage_row = [&](int i) {\n"
         "    const float2* row = s.F + ((size_t)d * s.rows + i) * W + c0;\n",
         "  auto stage_row = [&](int i) {\n"
         "    if (kChunk && s.fuse_m) {   // group i's sum of its blocks\n"
         "      const float2* f0 = s.F + ((size_t)d * s.fuse_b +\n"
         "                                (size_t)i * s.fuse_m) * W + c0;\n"
         "      for (int e = tid; e < K::E; e += K::T) {\n"
         "        const int k1 = udiv(e, NC), c = umod(e, NC);\n"
         "        float2 acc = make_float2(0.f, 0.f);\n"
         "        for (int m = 0; m < s.fuse_m; ++m) {\n"
         "          const size_t dm = (size_t)d * s.fuse_b + i * s.fuse_m"
         " + m;\n"
         "          const float sg = __ldg(s.sec + i * s.fuse_m + m);\n"
         "          const float wx = sg * __ldg(s.cosang + dm);\n"
         "          const float wy = -sg * __ldg(s.sinang + dm);\n"
         "          const float2 v = __ldg(f0 + (size_t)m * W + c +"
         " (size_t)N2 * k1);\n"
         "          acc.x = fmaf(wx, v.x, acc.x);\n"
         "          acc.x = fmaf(-wy, v.y, acc.x);\n"
         "          acc.y = fmaf(wx, v.y, acc.y);\n"
         "          acc.y = fmaf(wy, v.x, acc.y);\n"
         "        }\n"
         "        stage[k1 * NC + c] = acc;\n"
         "      }\n"
         "      return;\n"
         "    }\n"
         "    const float2* row = s.F + ((size_t)d * s.rows + i) * W + c0;\n"),
        ("acquire_coh_spec.cu", "// K5.  F2: complex64 [DC, GA, W]",
         FUSED_SURFACE + "// K5.  F2: complex64 [DC, GA, W]"),
        ("acquire_coh.cu", "// K6.  F: complex64 [DC, B, W]",
         "extern \"C\" int k6_fused_surface(\n"
         "    const void* F, const void* code_f, const void* cosang,\n"
         "    const void* sinang, const void* sec, void* peak, void* idx,\n"
         "    void* al, int P, int DC, int B, int m_coh, int W, int n_valid,"
         "\n    void* stream);\n\n// K6.  F: complex64 [DC, B, W]"),
        ("acquire_coh.cu",
         "  const int e = launch_combine(c, DC, (cudaStream_t)stream);\n",
         "  if (A == 1)\n"
         "    return k6_fused_surface(F, code_f, cosang, sinang, sec_mat, "
         "peak,\n                            idx, al, P, DC, B, m_coh, W, "
         "n_valid, stream);\n"
         "  const int e = launch_combine(c, DC, (cudaStream_t)stream);\n"),
    ),
}

# (tag, P, DC, B, m_coh, A, seed): the cases of every run
CASES = (("gps-l1 --coherent 8", 32, 102, 80, 8, 1, 77),
         ("xona-x1p --coherent 100", 1, 70, 200, 100, 100, 78))

# run in a fresh interpreter at the tree's root: argv = csrc build cases
# kwargs stamps(0/1) timing.py
CHILD = r"""
import ctypes, importlib.util, json, sys
csrc, build, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
kwargs, stamps = json.loads(sys.argv[4]), sys.argv[5] == "1"
cluster_4096 = int(sys.argv[7])
sys.path.insert(0, ".")
from gnss_dsp_tpu_torch.ops import _build as b
b.CSRC, b.BUILD_DIR = csrc, build
lib = b.load()
import numpy as np
import torch
import chip_smoke as cs
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.ops import acquire_coh
spec = importlib.util.spec_from_file_location("k6_timing", sys.argv[6])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
card = cs.card_line()
dev = torch.device("cuda", 0)
x1p = get_signal("xona-x1p")
if cluster_4096:      # the build at 4096 the run's patch made the choice
    acquire_coh.SPEC_CLUSTERS[4096] = (cluster_4096,)
out = []


def inputs(P, DC, B, m_coh, A, seed):
    # noise spectra, one planted cell per PRN (chip_smoke's k6 cases)
    g = torch.Generator(device=dev).manual_seed(seed)
    W = 4096
    code = torch.exp(2j * np.pi * torch.rand((P, W), generator=g,
                                             device=dev)).to(torch.complex64)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    ang = 2 * np.pi * torch.rand((DC, B), generator=g, device=dev)
    sec = np.asarray(x1p.secondary(x1p.prns()[0]) if A > 1 else [1.0],
                     np.float32)
    sec_mat = torch.from_numpy(sec[(np.arange(A)[:, None]
                                    + np.arange(B)[None, :]) % A]).to(dev)
    rng = np.random.default_rng(seed)
    dops = rng.permutation(DC)[:P]
    plants = [(p, int(dops[p]), int(rng.integers(A)), int(rng.integers(W)))
              for p in range(P)]
    k = torch.arange(W, device=dev, dtype=torch.float64)
    for p, d, a, j in plants:
        rot = torch.exp(1j * ang[d].to(torch.float64))
        ramp = code[p].to(torch.complex128) * torch.exp(2j * np.pi * k * j / W)
        F[d] += (0.5 * sec_mat[a].to(torch.float64)[:, None] * rot[:, None]
                 * ramp[None]).to(torch.complex64)
    return (F, code, torch.cos(ang), torch.sin(ang), sec_mat, m_coh), plants


for tag, P, DC, B, m_coh, A, seed in cases:
    args, plants = inputs(P, DC, B, m_coh, A, seed)
    kw = {k: (A if v == -1 else v) for k, v in kwargs.items()}
    call = lambda: acquire_coh.corr_surface_coh(*args, **kw)
    got = call()
    want = acquire_coh.corr_surface_coh_plain(*args)
    for p, d, a, j in plants:
        assert (int(got[1][p, d]), int(got[2][p, d])) == (j, a), (tag, p)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    case = dict(tag=tag, P=P, DC=DC, B=B, m_coh=m_coh, A=A, kwargs=kw)
    if not stamps:
        prof = timing.profiled_kernels(call, 20)
        case.update(
            ms=cs.cuda_ms(call, 10),
            profiler={k: dict(kept=c, ms=t) for k, (c, t) in prof.items()},
            profiler_ms=(sum(t for _, t in prof.values()) if prof and
                         min(c for c, _ in prof.values()) >= timing.KEPT_SHARE
                         else None))
        out.append(case)
        continue
    for name in ("k6_stamps", "k6_comb_stamps"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    runs_s, runs_c = [], []
    for _ in range(5):
        b.check(lib.k6_stamps_clear(), "k6_stamps_clear")
        b.check(lib.k6_comb_clear(), "k6_comb_clear")
        call()
        torch.cuda.synchronize()
        buf = np.zeros((16384, 8), np.uint64)
        b.check(lib.k6_stamps(buf.ctypes.data, buf.size), "k6_stamps")
        runs_s.append(buf[buf[:, 7] == 1].astype(np.float64))
        cb = np.zeros((65536, 4), np.uint64)
        b.check(lib.k6_comb_stamps(cb.ctypes.data, cb.size), "k6_comb")
        runs_c.append(cb[cb[:, 3] == 1].astype(np.float64))
    s = np.concatenate(runs_s[1:])
    c = np.concatenate(runs_c[1:])
    ghz = s[:, 3].sum() / (s[:, 5] - s[:, 4]).sum()
    rows = s[:, 6].mean()
    case.update(
        ghz=round(float(ghz), 4), clusters=int(runs_s[-1].shape[0]),
        rows_a_cluster=float(rows),
        cycles=dict(setup=round(float(s[:, 0].mean()), 1),
                    rows=round(float(s[:, 1].mean()), 1),
                    reduce_and_merge=round(float(s[:, 2].mean()), 1),
                    total=round(float(s[:, 3].mean()), 1)),
        ns_a_row_in_a_cluster=round(float(s[:, 1].mean() / rows / ghz), 2),
        combine_ctas=int(runs_c[-1].shape[0]),
        combine_cycles=round(float(c[:, 0].mean()), 1),
        combine_span_us=float(np.mean([(r[:, 2].max() - r[:, 1].min()) / 1e3
                                       for r in runs_c[1:]])),
        surface_span_us=float(np.mean([(r[:, 5].max() - r[:, 4].min()) / 1e3
                                       for r in runs_s[1:]])))
    out.append(case)

if not stamps:
    import os, statistics, time
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.tools import main_path as mp
    os.makedirs(os.path.dirname(os.path.abspath(build)), exist_ok=True)
    l1 = os.path.join(os.path.dirname(build), "gps_l1.iq")
    mp.synth_capture(l1, 8.184e6, 0.2)
    x1 = os.path.join(os.path.dirname(build), "xona_x1p.iq")
    t = mp.synth_at_acq_fs(x1, "xona-x1p", 0.206, seed=40, count=1,
                           dop_max=450.0, overlay=True, phase_max=0.05 * 1023)
    for tag, argv in (
            ("gps-l1 --coherent 8", ["gps-l1", "--coherent", "8", "--time",
             "80", "--doppler-search", "-6000,6000,62.5", l1, "8184000", "0",
             "--device", "cuda"]),
            ("xona-x1p --coherent 100", ["xona-x1p", "--coherent", "100",
             "--time", "200", "--doppler-search", "-500,500,5", x1,
             str(t["fs"]), "0", "--device", "cuda"])):
        mp.run_cli(acq_cli.main, *argv[:1], argv[1:])
        walls, n0 = [], acquire_coh.LAUNCHES_BLK
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hits = mp.parse_hits(mp.run_cli(acq_cli.main, *argv[:1], argv[1:]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out.append(dict(tag="cli " + tag,
                        wall_ms=statistics.median(walls) * 1e3,
                        walls_ms=[w * 1e3 for w in walls],
                        k6_launches=(acquire_coh.LAUNCHES_BLK - n0) // 5,
                        prns=len(hits)))
print("RUN " + json.dumps(dict(card=card, cases=out,
                               log=b.BUILD_INFO["log"])))
"""


def short_name(mangled: str) -> str:
    """A K6 kernel's name without its namespaces and arguments, with the
    surface build's cluster size (SpecN<n1, n2, C>)."""
    m = re.search(r"(coh_spec_kernel|combine_tile|combine_stream"
                  r"|combine_mma|surface_kernel|coh_combine_kernel)", mangled)
    if not m:
        return mangled
    c = re.search(r"SpecNILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    return m.group(1) + (f"<{c.group(1)},{c.group(2)},{c.group(3)}>"
                         if c else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default="parent,base,nosplit,cluster1,cluster4,"
                                      "fp32,fp32+tile416,mma,fused,stamps,"
                                      "base,parent")
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
        work = os.path.join(root, "_work", "k6_variants", name)
        csrc = prepare(tree, work, [p for v in parts
                                    for p in PATCHES.get(v, ())], name)
        kwargs = {k: v for p in parts for k, v in KWARGS.get(p, {}).items()}
        c4096 = max([CLUSTER_4096.get(p, 0) for p in parts])
        got, _ = run_child(
            CHILD, (csrc, os.path.join(work, "build"), json.dumps(CASES),
                    json.dumps(kwargs), "1" if "stamps" in parts else "0",
                    timing, c4096),
            tree, "RUN", f"run {name}")
        card = got["card"]
        for c in got["cases"]:
            if "profiler" in c:
                c["profiler"] = {short_name(k): v
                                 for k, v in c["profiler"].items()}
        kernels = {}
        for k, v in ptxas_summary(
                got["log"], r"coh_spec_kernel.*SpecNILi64ELi64E|combine_"
                r"|surface_kernel|coh_combine_kernel").items():
            kernels.setdefault(short_name(k), v)
        print(json.dumps(dict(run=name, cases=got["cases"], kernels=kernels)),
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
