// Non-coherent acquisition surface with in-kernel reduction (kernel K1).
//
// Replaces the TPU kernel gnss_dsp_tpu/ops/pallas_acquire2.py::corr_surface2
// (reduce=True, pallas_call at :325, body _kernel :173).  For each PRN p and
// doppler d it computes
//
//     s[j] = (1/W) * sum_b | IDFT_W( code_f[p] * conj(F[d, b]) ) [j] |
//
// and returns (max_j s, lowest j reaching the max, sum_j s) in one launch.
// No value of a row, and no part of the [P, DC, W] surface, goes to device
// memory: each row is transformed across the CTAs of one thread-block
// cluster per (p, d), the transpose read from the other CTAs' shared memory
// (acq_cluster.cuh), and each thread keeps the |.| sums of its lags in
// registers across the blocks.  The cluster reduces (max, lowest lag, sum)
// in a fixed order, so two launches give the same bits.
//
// Two cores of acq_cluster.cuh, by W:
//
// * 4096, 16384, 32768, 65536 and 81920 (GPS L1 and Xona X1, BeiDou
//   B1I/B2I, the padded Galileo E6 and L5/E5/B2a/B3I/L3OC windows,
//   Galileo E1, GPS L1C and BeiDou B1C): surface_rows, the core K5 runs,
//   with one alignment and the sum: the sub-transforms n1 =
//   2^floor(log2(W)/2) and n2 = W/n1 in registers at compile-time sizes
//   (Split; at 81920 = 256 x 320 the rows are 16 threads of 20 values,
//   then 20 of 16), one kernel per (W, cluster size).  At 65536 a row
//   (512 KiB) with the code spectrum's slice beside it needs the shared
//   memory of 16 CTAs (a non-portable cluster); with each thread's code
//   values in registers (kCodeRegs) it fits 8, and so runs 32768 and
//   65536.  81920 takes 16 CTAs of 320 threads.
// * every other W that ops/acquire2.wide_split factors (163840 = 320 x
//   512 for GPS L2CM, whose 320-point rows would need 640 threads a CTA
//   even on 16 CTAs): wide_rows, the core K5 runs there too, on the
//   run-time row_transform K7 runs (Stockham passes in shared memory,
//   radix 16/8/4/2 and direct 3/5/11/31 with compile-time roots) over the
//   fewest CTAs, up to 16, whose two buffers fit: 16 at 163840.  There is
//   no room beside the buffers for a staged copy of the next block (K7's
//   `stage`), so each row's slice of F and the code are read from L2 in
//   batches.
//
// What bounds it on the card: the float32 operations of the transforms
// (~5 log2 W per value and row) against the shared-memory traffic (per
// value and row, the Split core: the staged load, two exchanges, the yb
// store and the remote read; the run-time core: each pass's read and
// write, and the transposed read); F is read from device memory once per
// doppler, the P clusters of one doppler side by side.
//
// n_valid (the padded-window route, pallas_acquire2.py:254-264): the max,
// the argmax and the sum run over the lags j >= W - n_valid only, and the
// index is reported as j - (W - n_valid).  n_valid = 0 searches all lags.
// The block sums are divided by W once, where the plain version scales
// each transform (exact at a power of two W).
//
// reduce=False (acq2_surface, pallas_acquire2.py:320-323, 350): the same
// cores with the store epilogue (kStore) in place of the cluster's
// reduction: each thread writes the 1/W-scaled block sums of its lags to
// q[p, d, lag], f32 [P, DC, W] in natural lag order, for the sharded
// search's sum over time shards (parallel/acquire.py).  The extra cost is
// that write, 4 bytes a cell, against the 8 bytes a cell and block of F
// read.

#include "acq_cluster.cuh"

namespace {

using acqc::Plan;
using acqc::Spec;
using acqc::SpecN;
using acqc::SurfaceArgs;
using acqc::WideArgs;
using acqc::wide_plan;
using acqc::wide_smem;

// ---- the windows of the register core ------------------------------------

template <class K, bool kStore>
__global__ void __launch_bounds__(K::T, K::kMinBlocks)
    acq2_split_kernel(const __grid_constant__ SurfaceArgs s) {
  acqc::surface_rows<K, false, !kStore, kStore>(s);
}

using SplitKernel = void (*)(const SurfaceArgs);

struct SplitLaunch {
  SplitKernel kernel;
  int C, T, n1, n2;
  size_t smem;
};

// the build of K for the reduction, or with kStore for the surface
template <class K>
SplitLaunch split_of(bool store) {
  return {store ? &acq2_split_kernel<K, true>
                : &acq2_split_kernel<K, false>,
          K::N2 / K::NC, K::T, K::N1, K::N2, K::kSmem};
}

// The kernels built, (W, C), the choice first: 4096 on 2 CTAs (1, 4, 8);
// 16384 on 8; 32768 and 65536 on 8 with each thread's code values in
// registers (16 with them in shared memory); 81920 = 256 x 320 on 16 (its
// rows on Split<320>).  Where a row's shared memory leaves an SM only one
// or two CTAs, the builds that keep more threads on an SM won on the
// card, spills and all (PERF.md section 6).  Any other (W, C) runs the
// run-time core.
bool split_launch(SplitLaunch& l, int W, int C, bool store) {
  switch (W) {
    case 4096:
      switch (C) {
        case 0: case 2: l = split_of<Spec<12, 2>>(store); return true;
        case 1: l = split_of<Spec<12, 1>>(store); return true;
        case 4: l = split_of<Spec<12, 4>>(store); return true;
        case 8: l = split_of<Spec<12, 8>>(store); return true;
      }
      return false;
    case 16384:
      if (C != 0 && C != 8) return false;
      l = split_of<Spec<14, 8>>(store);
      return true;
    case 32768:
      if (C == 0 || C == 8) l = split_of<Spec<15, 8, true>>(store);
      else if (C == 16) l = split_of<Spec<15, 16>>(store);
      else return false;
      return true;
    case 65536:
      if (C == 0 || C == 8) l = split_of<Spec<16, 8, true>>(store);
      else if (C == 16) l = split_of<Spec<16, 16>>(store);
      else return false;
      return true;
    case 81920:
      if (C != 0 && C != 16) return false;
      l = split_of<SpecN<256, 320, 16>>(store);
      return true;
  }
  return false;
}

// ---- other W on the run-time core (acq_cluster.cuh wide_rows) -----------

template <bool kStore>
__global__ void __launch_bounds__(acqc::kWT, 1)
    acq2_wide_kernel(const __grid_constant__ WideArgs s) {
  acqc::wide_rows<false, !kStore, kStore>(s);
}

// K1's plan at W on `cluster` CTAs, for the reduction or the surface
int info_of(int W, int cluster, bool store, int* info) {
  SplitLaunch l;
  cudaError_t e;
  if (split_launch(l, W, cluster, store)) {
    e = acqc::cluster_info(l.kernel, l.T, l.C, l.smem, info);
    info[6] = l.n1;
    info[7] = l.n2;
    info[8] = 0;
  } else {
    Plan pl;
    if (!wide_plan(pl, W, cluster)) return (int)cudaErrorInvalidValue;
    e = acqc::cluster_info(store ? &acq2_wide_kernel<true>
                                 : &acq2_wide_kernel<false>,
                           acqc::kWT, pl.C, wide_smem(pl), info);
    info[6] = pl.n1;
    info[7] = pl.n2;
    info[8] = 1;
  }
  return (int)e;
}

// One launch of K1: the reduction into peak, idx, sum (q null) or, with
// q, the surface
int launch(const void* F, const void* code_f, const void* tw, void* peak,
           void* idx, void* sum, void* q, int P, int DC, int B, int W,
           int n_valid, int cluster, void* stream) {
  const bool store = q != nullptr;
  if (P < 1 || DC < 1 || B < 1 || n_valid < 0 || n_valid > W ||
      (store && n_valid != 0))
    return (int)cudaErrorInvalidValue;
  const int lo = n_valid ? W - n_valid : 0;
  SplitLaunch l;
  if (split_launch(l, W, cluster, store)) {
    const long long grid = (long long)P * DC * l.C;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    SurfaceArgs s = {};
    s.F = (const float2*)F;
    s.code_f = (const float2*)code_f;
    s.peak = (float*)peak;
    s.idx = (int*)idx;
    s.sum = (float*)sum;
    s.q = (float*)q;
    s.P = P;
    s.DC = DC;
    s.rows = B;
    s.A = 1;
    s.lo = lo;
    return (int)acqc::launch_cluster(l.kernel, (int)grid, l.T, l.C, l.smem,
                                     (cudaStream_t)stream, s);
  }
  WideArgs s = {};
  if (tw == nullptr || !wide_plan(s.plan, W, cluster))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)P * DC * s.plan.C;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.sum = (float*)sum;
  s.q = (float*)q;
  s.P = P;
  s.DC = DC;
  s.rows = B;
  s.A = 1;
  s.lo = lo;
  return (int)acqc::launch_cluster(
      store ? &acq2_wide_kernel<true> : &acq2_wide_kernel<false>, (int)grid,
      acqc::kWT, s.plan.C, wide_smem(s.plan), (cudaStream_t)stream, s);
}

}  // namespace

// K1's launch plan at W with `cluster` CTAs (0: the kernel's own choice):
// info[0] cluster size, [1] dynamic shared memory bytes a CTA, [2]
// registers a thread, [3] local (spilled) bytes a thread, [4] clusters the
// card holds at once (cudaOccupancyMaxActiveClusters), [5] threads a CTA,
// [6] n1, [7] n2, [8] the core: 0 Split (registers, compile-time sizes),
// 1 row_transform (run-time sizes; takes cluster_twiddle_table(n1, n2)).
// Returns a cudaError_t (cudaErrorInvalidValue: K1 does not take W on
// `cluster` CTAs).  acq2_surface_info: the same for the surface's build.
extern "C" int acq2_info(int W, int cluster, int* info) {
  return info_of(W, cluster, false, info);
}

extern "C" int acq2_surface_info(int W, int cluster, int* info) {
  return info_of(W, cluster, true, info);
}

// K1.  F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: complex64
// cluster_twiddle_table(n1, n2) for the run-time core (unread by the Split
// core, may be null there); outputs peak f32, idx i32 (lag - lo), sum f32
// [P, DC].  cluster: as acq2_info.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int acq2_reduce(const void* F, const void* code_f, const void* tw,
                           void* peak, void* idx, void* sum, int P, int DC,
                           int B, int W, int n_valid, int cluster,
                           void* stream) {
  return launch(F, code_f, tw, peak, idx, sum, nullptr, P, DC, B, W, n_valid,
                cluster, stream);
}

// K1 with reduce=False: q f32 [P, DC, W], the 1/W-scaled block sums in
// natural lag order; the other arguments as acq2_reduce's (every lag: no
// n_valid).
extern "C" int acq2_surface(const void* F, const void* code_f,
                            const void* tw, void* q, int P, int DC, int B,
                            int W, int cluster, void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return launch(F, code_f, tw, nullptr, nullptr, nullptr, q, P, DC, B, W, 0,
                cluster, stream);
}
