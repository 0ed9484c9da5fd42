// Extended-coherent acquisition surface, spectral combine (kernel K5).
//
// Replaces gnss_dsp_tpu/ops/pallas_acquire_coh.py::corr_surface_coh_spec
// (pallas_call at :305, body _kernel_spec :190, finalize _finalize_max
// :158).  Its rows are spectra already combined across each group's blocks
// (F2[d, g*A + a] = sum_m conj(w[a, m]) F[d, g*M + m]); alignment a's
// surface is
//
//     s_a[j] = (1/W) * sum_g | IDFT_W( code_f[p] * conj(F2[d, g*A + a]) ) [j] |
//
// and the kernel reports, per (p, d), the highest s_a[j] over alignments
// and the lags j >= lo = W - n_valid (all lags when n_valid = 0), the
// lowest such lag, then the lowest alignment (_finalize_max's ties), with
// the lag counted from lo.
//
// Design: K1's two cluster cores of acq_cluster.cuh with the alignment
// loop: one thread-block cluster of C CTAs per (p, d) walks all A
// alignments and G groups of its G*A rows (alignment-major: the G rows of
// alignment a, then a + 1), each row a four-step transform W = n1 * n2
// split over the cluster with no value in device memory.  Each thread sums
// |x| of its lags in registers across the G groups, then keeps per lag the
// running (peak, lowest alignment) over the A alignments in registers too.
// The cluster then reduces (peak, lowest lag >= lo, its alignment) through
// distributed shared memory and writes it: no [P, DC, A] scratch and no
// second kernel, and no pass over alignment chunks as the TPU kernel makes
// where its VMEM does not hold them all.  The cores, by W (K1's builds at
// those windows):
//
// * surface_rows, the sub-transforms in registers at compile-time sizes:
//   powers of two W <= 16384 (n1 = 2^floor(log2(W)/2), C = min(8, n1) but
//   K1's 2 at 4096, where 8 spill; 4 CTAs the other build at 16384), with
//   the alignments split over clusters where the caller asks (a_chunk <
//   A: K6's surface stage, csrc/acquire_coh.cu); 32768 (Galileo E6) on 16
//   CTAs, 8 with
//   each thread's code values in registers the other build; 65536 (the
//   padded L5/E5/B2a/B3I/L3OC and Galileo E1 windows) on 8 with the code
//   in registers, 16 the other build; 81920 = 256 x 320 (GPS L1C, BeiDou
//   B1C) on 16;
// * wide_rows, row_transform's Stockham passes at run-time sizes: every
//   other W that ops/acquire2.wide_split factors (163840 = 320 x 512 for
//   GPS L2CM, on 16 CTAs), and a built window on a cluster size it has no
//   build for.  It takes cluster_twiddle_table(n1, n2).
//
// What bounds it on the card: the float32 operations of the transforms
// (~5 log2 W per value and row) and the shared-memory traffic (per value
// and row: the staged load, two exchanges, the yb store and the remote
// read; the run-time core: each pass's read and write).

#include "acq_cluster.cuh"

namespace {

using acqc::Plan;
using acqc::Spec;
using acqc::SpecN;
using acqc::SurfaceArgs;
using acqc::WideArgs;

// the alignment chunks (kChunk) where the merge key holds the lag
template <class K>
__global__ void __launch_bounds__(K::T, K::kMinBlocks)
    coh_spec_kernel(const __grid_constant__ SurfaceArgs s) {
  acqc::surface_rows<K, true, false, false, (K::W <= 16384)>(s);
}

__global__ void __launch_bounds__(acqc::kWT, 1)
    coh_wide_kernel(const __grid_constant__ WideArgs s) {
  acqc::wide_rows<true, false>(s);
}

using Kernel = void (*)(const SurfaceArgs);

struct Launch {
  Kernel kernel;
  int C, T, n1, n2;
  size_t smem;
};

template <class K>
Launch launch_of() {
  return {coh_spec_kernel<K>, K::N2 / K::NC, K::T, K::N1, K::N2, K::kSmem};
}

// The register core's builds, (W, C), the choice first: log2 W = 1 .. 14
// on C = min(8, n1) CTAs but 2 at 4096 (K1's build: 8 CTAs spill there),
// and 4 at 16384; 32768 on 16, and 8 with the
// code values in registers (Galileo E6C's per-PRN launches hold 10
// clusters: 16 CTAs each spread them over more SMs, PERF.md section 6);
// 65536 on 8 with the code values in registers, and 16; 81920 on 16.
// Any other (W, C) runs the run-time core.
bool spec_launch(Launch& l, int W, int C) {
  switch (W) {
    case 32768:
      if (C == 0 || C == 16) l = launch_of<Spec<15, 16>>();
      else if (C == 8) l = launch_of<Spec<15, 8, true>>();
      else return false;
      return true;
    case 65536:
      if (C == 0 || C == 8) l = launch_of<Spec<16, 8, true>>();
      else if (C == 16) l = launch_of<Spec<16, 16>>();
      else return false;
      return true;
    case 81920:
      if (C != 0 && C != 16) return false;
      l = launch_of<SpecN<256, 320, 16>>();
      return true;
  }
  if (W < 2 || W > 16384 || (W & (W - 1))) return false;
  const int L = acqc::ilog2(W);
  const int n1 = 1 << (L / 2);
  const int choice = L == 12 ? 2 : n1 < 8 ? n1 : 8;
  if (C == 0) C = choice;
  if (C != choice && !(L == 14 && C == 4)) return false;
  switch (L) {
    case 1: l = launch_of<Spec<1, 1>>(); break;
    case 2: l = launch_of<Spec<2, 2>>(); break;
    case 3: l = launch_of<Spec<3, 2>>(); break;
    case 4: l = launch_of<Spec<4, 4>>(); break;
    case 5: l = launch_of<Spec<5, 4>>(); break;
    case 6: l = launch_of<Spec<6, 8>>(); break;
    case 7: l = launch_of<Spec<7, 8>>(); break;
    case 8: l = launch_of<Spec<8, 8>>(); break;
    case 9: l = launch_of<Spec<9, 8>>(); break;
    case 10: l = launch_of<Spec<10, 8>>(); break;
    case 11: l = launch_of<Spec<11, 8>>(); break;
    case 12: l = launch_of<Spec<12, 2>>(); break;
    case 13: l = launch_of<Spec<13, 8>>(); break;
    default: l = C == 4 ? launch_of<Spec<14, 4>>() : launch_of<Spec<14, 8>>();
  }
  return l.C == C;
}

}  // namespace

// The launch plan of K5 at W with `cluster` CTAs (0: the kernel's own
// choice), as acq2_info: info[0] cluster size, [1] dynamic shared memory
// bytes a CTA, [2] registers a thread, [3] local (spilled) bytes a thread,
// [4] clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// [5] threads a CTA, [6] n1, [7] n2, [8] the core: 0 Split (registers,
// compile-time sizes), 1 row_transform (run-time sizes; takes
// cluster_twiddle_table(n1, n2)).  Returns a cudaError_t
// (cudaErrorInvalidValue: K5 does not take W on `cluster` CTAs).
extern "C" int acq_coh_spec_info(int W, int cluster, int* info) {
  Launch l;
  cudaError_t e;
  if (spec_launch(l, W, cluster)) {
    e = acqc::cluster_info(l.kernel, l.T, l.C, l.smem, info);
    info[6] = l.n1;
    info[7] = l.n2;
    info[8] = 0;
  } else {
    Plan pl;
    if (!acqc::wide_plan(pl, W, cluster)) return (int)cudaErrorInvalidValue;
    e = acqc::cluster_info(coh_wide_kernel, acqc::kWT, pl.C,
                           acqc::wide_smem(pl), info);
    info[6] = pl.n1;
    info[7] = pl.n2;
    info[8] = 1;
  }
  return (int)e;
}

// K5.  F2: complex64 [DC, GA, W] (row g*A + a); code_f: complex64 [P, W];
// tw: complex64 cluster_twiddle_table(n1, n2) for the run-time core
// (unread by the register core, may be null there); outputs peak f32, idx
// i32 (lag - lo), al i32 [P, DC].  cluster: as acq_coh_spec_info.
// a_chunk: alignments a cluster (A: all; below A only on the register
// core at W <= 16384, the chunks merged in key u64 and count u32 [P, DC]
// scratch, which are zeroed here and unread where a_chunk = A).  Returns
// the cudaError_t of the first call that fails (0 = launched).
extern "C" int acq_coh_spec(const void* F2, const void* code_f,
                            const void* tw, void* peak, void* idx, void* al,
                            void* key, void* count, int P, int DC, int GA,
                            int A, int W, int n_valid, int cluster,
                            int a_chunk, void* stream) {
  if (P < 1 || DC < 1 || A < 1 || A > 65535 || GA < A || GA % A != 0 ||
      n_valid < 0 || n_valid > W || a_chunk < 1 || a_chunk > A)
    return (int)cudaErrorInvalidValue;
  const int lo = n_valid ? W - n_valid : 0;
  const int nch = (A + a_chunk - 1) / a_chunk;
  const cudaStream_t st = (cudaStream_t)stream;
  Launch l;
  if (spec_launch(l, W, cluster)) {
    if (nch > 1 && (W > 16384 || key == nullptr || count == nullptr))
      return (int)cudaErrorInvalidValue;
    const long long grid = (long long)P * DC * nch * l.C;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (nch > 1) {
      const size_t cells = (size_t)P * DC;
      cudaError_t m = cudaMemsetAsync(key, 0, cells * 8, st);
      if (m == cudaSuccess) m = cudaMemsetAsync(count, 0, cells * 4, st);
      if (m != cudaSuccess) return (int)m;
    }
    SurfaceArgs s = {};
    s.F = (const float2*)F2;
    s.code_f = (const float2*)code_f;
    s.peak = (float*)peak;
    s.idx = (int*)idx;
    s.al = (int*)al;
    s.key = (unsigned long long*)key;
    s.count = (unsigned int*)count;
    s.P = P;
    s.DC = DC;
    s.rows = GA;
    s.A = A;
    s.lo = lo;
    s.a_chunk = a_chunk;
    return (int)acqc::launch_cluster(l.kernel, (int)grid, l.T, l.C, l.smem,
                                     st, s);
  }
  WideArgs s = {};
  if (tw == nullptr || nch > 1 || !acqc::wide_plan(s.plan, W, cluster))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)P * DC * s.plan.C;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.F = (const float2*)F2;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.al = (int*)al;
  s.P = P;
  s.DC = DC;
  s.rows = GA;
  s.A = A;
  s.lo = lo;
  return (int)acqc::launch_cluster(coh_wide_kernel, (int)grid, acqc::kWT,
                                   s.plan.C, acqc::wide_smem(s.plan), st, s);
}
