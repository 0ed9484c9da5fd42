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
//   powers of two W <= 8192 (n1 = 2^floor(log2(W)/2), C = min(8, n1) but
//   K1's 2 at 4096, where 8 spill; 16384 on 8 only as the ablation of the
//   batched core), with the alignments split over clusters where the
//   caller asks (a_chunk < A: K6's surface stage, csrc/acquire_coh.cu);
//   32768 (Galileo E6) on 16 CTAs, 8 with each
//   thread's code values in registers the other build; 65536 (the padded
//   L5/E5/B2a/B3I/L3OC and Galileo E1 windows) on 8 with the code in
//   registers, 16 the other build; 81920 = 256 x 320 (GPS L1C, BeiDou
//   B1C) on 16;
// * the batched core below (coh_spec_kernel_batch), surface_rows'
//   transform and reduction at 16384 = 128 x 128 on 8 CTAs with two rows
//   of a cluster in flight and one cluster barrier a row, alignment chunks
//   as surface_rows;
// * wide_rows, row_transform's Stockham passes at run-time sizes: every
//   other W that ops/acquire2.wide_split factors (163840 = 320 x 512 for
//   GPS L2CM, on 16 CTAs), and a built window on a cluster size it has no
//   build for (16384 on 4 CTAs).  It takes cluster_twiddle_table(n1, n2).
//
// What bounds it on the card: the float32 operations of the transforms
// (~5 log2 W per value and row) and the shared-memory traffic (per value
// and row: the staged load, two exchanges, the yb store and the remote
// read; the run-time core: each pass's read and write).  On the register
// cores the registers and shared memory of a row in flight leave 3 CTAs
// (12 warps) an SM, and a row waits on its cluster's barriers: the batched
// core takes one a row where surface_rows takes two.

#include "acq_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using acqc::Plan;
using acqc::Spec;
using acqc::SpecN;
using acqc::SurfaceArgs;
using acqc::WideArgs;
using clusterk::cluster_arrive;
using clusterk::cluster_wait;

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

// ---- The batched register core (W = 16384) --------------------------------
//
// surface_rows' transform and reduction (acq_cluster.cuh, with kAlign and
// kChunk) at 16384 = 128 x 128 on 8 CTAs, with two rows of a cluster in
// flight at once and one cluster barrier a row where surface_rows takes
// two.  A cluster walks its n = (a1 - a0) * G rows in surface_rows' order
// (the G groups of alignment a0, then of a0 + 1, ...); the next row's
// cp.async is issued behind the column step, as surface_rows does.
//
// yb has two buffers, row i writing buffer i mod 2.  A CTA may write its
// row-i columns once it has passed row i - 1's cluster barrier: every
// reader of buffer i mod 2 (row i - 2) arrived there after its reads.  So
// a row takes one cluster barrier: arrive after the yb store, wait before
// the remote reads.
//
// The code values of the column role's cells are read through L1 each row,
// not kept in shared memory: that leaves room for yb's second buffer at 3
// CTAs (12 warps) an SM.  Each bit reversal is the expression rev below,
// a constant once the loops unroll.
//
// A row's arithmetic is surface_rows': the same split, twiddles and
// cabs_approx.  acc sums a row's |x| in the order of the groups and folds
// into the running (best, lowest alignment) at an alignment's last group,
// alignments ascending, so the results are surface_rows' bits.

// bitrev(x, bits) for bits <= 4 as one expression.  acqc::bitrev's loop
// over the bits is left as a loop of uniform-register instructions in the
// unrolled code (some 25 a call, 64 calls a row).
__device__ __forceinline__ int rev(int x, int bits) {
  return (((x & 1) << 3) | ((x & 2) << 1) | ((x >> 1) & 2) |
          ((x >> 3) & 1)) >> (4 - bits);
}

// acqc::split_in and acqc::split_c (power-of-two N) on rev
template <int N>
__device__ __forceinline__ int split_in(int m) {
  return acqc::Split<N>::Q * rev(m, acqc::Split<N>::LR);
}

template <int N, int M>
__device__ __forceinline__ void split_c(float2 (&out)[M],
                                        const float2* __restrict__ xb, int ld,
                                        int col, int t) {
  using S = acqc::Split<N>;
  static_assert(!S::kMixed && S::LR <= 4 && M >= S::RO, "step C's outputs");
#pragma unroll
  for (int h = 0; h < S::H; ++h) {
    const int a = t * S::H + h;
    float2 u[S::Q];
#pragma unroll
    for (int s = 0; s < S::Q; ++s)
      u[s] = xb[(a * S::Q + rev(s, S::LQ)) * ld + col];
    acqc::dft_pow2<S::Q>(u);
#pragma unroll
    for (int b = 0; b < S::Q; ++b) out[h * S::Q + b] = u[b];
  }
}

// the batched core's layout: surface_rows' Spec<14, 8>, and its shared
// memory, float2: stage[E], xb[E], yb[2][NC*YS], wN1[N1], wN2[N2],
// wA[N2], wS[Q1][NC]
struct Batched : Spec<14, 8> {
  static constexpr int kYb = NC * YS;                // one buffer of yb
  static constexpr int kOffXb = E, kOffYb = 2 * E;
  static constexpr int kOffW1 = kOffYb + 2 * kYb;
  static constexpr int kOffW2 = kOffW1 + N1, kOffWA = kOffW2 + N2;
  static constexpr int kOffWS = kOffWA + N2;
  static constexpr size_t kSmem =
      (size_t)(kOffWS + S1::Q * NC) * sizeof(float2);
  // CTAs an SM holds by shared memory: 3, which caps a thread at 170
  // registers
  static constexpr int kMinBlocks = (int)((227 * 1024) / (kSmem + 1024));
  static_assert(kMinBlocks >= 1 && kMinBlocks * T <= 512,
                "one CTA's shared memory and threads");
  static_assert(NC % 2 == 0 && S1::Q > 1 && S2::Q > 1 && !S1::kMixed &&
                    !S2::kMixed && !kCodeRegs,
                "power-of-two rows and columns of at least two threads");
};

__global__ void __launch_bounds__(Batched::T, Batched::kMinBlocks)
    coh_spec_kernel_batch(const __grid_constant__ SurfaceArgs s) {
  using K = Batched;
  using S1 = K::S1;
  using S2 = K::S2;
  constexpr int N1 = K::N1, N2 = K::N2, W = K::W, NC = K::NC, NR = K::NR;
  constexpr int E = K::E, T = K::T, kYb = K::kYb;
  constexpr int R1 = S1::R, Q1 = S1::Q, R2 = S2::R, RO2 = S2::RO;
  constexpr int C = N2 / NC;
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / C;
  const int p = item % s.P;
  const int A = s.A;
  // the alignments [a0, a1) of this cluster (acq_cluster.cuh's kChunk)
  const int nch = (A + s.a_chunk - 1) / s.a_chunk;
  const int d = item / s.P / nch;
  const int a0 = (item / s.P % nch) * s.a_chunk;
  const int a1 = min(A, a0 + s.a_chunk);
  const int G = s.rows / A;
  const int n = (a1 - a0) * G;           // rows this cluster walks
  const int tid = threadIdx.x;
  float2* stage = smem;
  float2* xb = smem + K::kOffXb;
  float2* wN1 = smem + K::kOffW1;
  float2* wN2 = smem + K::kOffW2;
  float2* wA = smem + K::kOffWA;
  float2* wS = smem + K::kOffWS;
  const int c0 = rank * NC;
  // column role (tid < TC): column c0 + col, thread t1 of its transform;
  // row role (tid < TR): row j1 = rank*NR + jl, thread t2 of its transform
  const int t1 = acqc::udiv(tid, NC), col = acqc::umod(tid, NC);
  const int t2 = acqc::udiv(tid, NR), jl = acqc::umod(tid, NR);
  const int j1 = rank * NR + jl;

  // this CTA's slice of the walk's row i into stage, [k1][col]; walk row i
  // is group i mod G of alignment a0 + i / G
  auto stage_row = [&](int i) {
    const int ia = i / G;
    const float2* row =
        s.F + ((size_t)d * s.rows + (i - ia * G) * A + a0 + ia) * W + c0;
    for (int e = tid; e < E / 2; e += T) {
      const int k1 = acqc::udiv(e, NC / 2), c = acqc::umod(e, NC / 2) * 2;
      acqc::cp_async16(stage + k1 * NC + c, row + c + (size_t)N2 * k1);
    }
    acqc::cp_async_commit();
  };

  stage_row(0);
  for (int i = tid; i < N1; i += T) wN1[i] = acqc::unit_root(i, N1);
  for (int i = tid; i < N2; i += T) {
    wN2[i] = acqc::unit_root(i, N2);
    wA[i] = acqc::unit_root(i, W);
  }
  // the code value v[m] of thread (t1, col): code_f[p] at column c0 + col,
  // k1 = t1 + Q1 bitrev(m)
  const float2* cf = s.code_f + (size_t)p * W + c0 + col;
  __syncthreads();
  // the four-step twiddle of step C's cell out[h*Q1 + b]: gb[h] * wS[b][col]
  // (surface_rows')
  auto w_of = [&](int t) {
    t = acqc::umod(t, W);
    return acqc::cmul(wA[acqc::umod(t, N2)], wN1[acqc::udiv(t, N2)]);
  };
  float2 gb[S1::H];
#pragma unroll
  for (int h = 0; h < S1::H; ++h)
    gb[h] = w_of(tid < K::TC ? (t1 * S1::H + h) * (c0 + col) : 0);
  for (int e = tid; e < Q1 * NC; e += T)
    wS[e] = w_of(R1 * acqc::udiv(e, NC) * (c0 + acqc::umod(e, NC)));

  // per lag: the sum over the groups of one alignment, the best such sum
  // over the alignments so far and its alignment (16 bits, two to a
  // register)
  float acc[RO2], best[RO2];
  uint32_t besta[(RO2 + 1) / 2];
#pragma unroll
  for (int o = 0; o < RO2; ++o) {
    acc[o] = 0.f;
    best[o] = -INFINITY;
  }
#pragma unroll
  for (int o = 0; o < (RO2 + 1) / 2; ++o) besta[o] = 0;
  for (int i = 0; i < n; ++i) {
    acqc::cp_async_wait_all();
    __syncthreads();          // stage holds row i; xb is free
    float2 v[R1];
    if (tid < K::TC) {
#pragma unroll
      for (int m = 0; m < R1; ++m) {
        const int k1 = t1 + Q1 * rev(m, S1::LR);
        v[m] = acqc::cmul_conj(__ldg(cf + (size_t)N2 * k1),
                               stage[k1 * NC + col]);
      }
      acqc::split_ab<N1>(v, t1, wN1);
      acqc::split_put<N1>(v, xb, NC, col, t1);
    }
    __syncthreads();          // stage read out, xb complete
    if (i + 1 < n) stage_row(i + 1);
    if (tid < K::TC) {
      split_c<N1>(v, xb, NC, col, t1);
#pragma unroll
      for (int o = 0; o < R1; ++o)
        v[o] = acqc::cmul(v[o], acqc::cmul(gb[o / Q1],
                                           wS[(o % Q1) * NC + col]));
    }
    float2* yb = smem + K::kOffYb + (i & 1) * kYb;
    if (tid < K::TC) {
#pragma unroll
      for (int o = 0; o < R1; ++o)
        yb[col * K::YS + acqc::split_index<N1>(o, t1)] = v[o];
    }
    cluster_arrive();
    cluster_wait();           // every CTA's yb holds row i's columns
    float2 z[R2];             // step C's RO2 <= R2 outputs reuse it
    if (tid < K::TRA) {
#pragma unroll
      for (int m = 0; m < R2; ++m) {
        const int k2 = t2 + split_in<N2>(m);
        z[m] = *cluster.map_shared_rank(
            yb + acqc::umod(k2, NC) * K::YS + j1, acqc::udiv(k2, NC));
      }
      acqc::split_ab<N2>(z, t2, wN2);
      acqc::split_put<N2>(z, xb, NR, jl, t2);
    }
    __syncthreads();          // xb complete
    if (tid < K::TRC) {
      split_c<N2>(z, xb, NR, jl, t2);
#pragma unroll
      for (int o = 0; o < RO2; ++o) acc[o] += acqc::cabs_approx(z[o]);
      const int ia = i / G;
      if (i - ia * G == G - 1) {         // alignment a0 + ia is complete
        const int a = a0 + ia;
#pragma unroll
        for (int o = 0; o < RO2; ++o) {
          if (acc[o] > best[o]) {        // a ascending: the lowest on ties
            const int sh = (o & 1) * 16;
            best[o] = acc[o];
            besta[o / 2] =
                (besta[o / 2] & ~(0xffffu << sh)) | ((uint32_t)a << sh);
          }
          acc[o] = 0.f;
        }
      }
    }
  }
  // (cluster_best's first cluster barrier follows every CTA's last reads)

  // (peak, lowest lag >= lo reaching it, its alignment) over the thread's
  // lags, then the cluster
  acqc::Best b = {-INFINITY, W, 0, 0.f};
  if (tid < K::TRC) {
#pragma unroll
    for (int o = 0; o < RO2; ++o) {
      const int j = j1 + N1 * acqc::split_index<N2>(o, t2);
      if (j >= s.lo && acqc::better(best[o], j, b.v, b.j)) {
        b.v = best[o];
        b.j = j;
        b.a = (int)((besta[o / 2] >> ((o & 1) * 16)) & 0xffffu);
      }
    }
  }
  if (acqc::cluster_best<T, false>(b)) {
    const size_t o = (size_t)p * s.DC + d;
    if (nch > 1) {
      acqc::merge_chunk(s, o, b, nch, W);
      return;
    }
    s.peak[o] = b.v / (float)W;   // exact at a power of two W
    s.idx[o] = b.j - s.lo;
    s.al[o] = b.a;
  }
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
// 16384 on the batched core (surface_rows' build there only with
// `surface`, the ablation); 32768 on 16, and 8 with the code values in
// registers (Galileo E6C's per-PRN launches hold 10 clusters: 16 CTAs
// each spread them over more SMs, PERF.md section 6); 65536 on 8 with the
// code values in registers, and 16; 81920 on 16.
// Any other (W, C) runs the run-time core.
bool spec_launch(Launch& l, int W, int C, bool surface) {
  if (W == 16384 && !surface && (C == 0 || C == 8)) {
    l = {coh_spec_kernel_batch, 8, Batched::T, Batched::N1, Batched::N2,
         Batched::kSmem};
    return true;
  }
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
  if (C != choice) return false;
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
    default: l = launch_of<Spec<14, 8>>();
  }
  return l.C == C;
}

}  // namespace

// The launch plan of K5 at W with `cluster` CTAs (0: the kernel's own
// choice), as acq2_info: info[0] cluster size, [1] dynamic shared memory
// bytes a CTA, [2] registers a thread, [3] local (spilled) bytes a thread,
// [4] clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// [5] threads a CTA, [6] n1, [7] n2, [8] the core: 0 Split (registers,
// compile-time sizes; the batched core at 16384), 1 row_transform
// (run-time sizes; takes cluster_twiddle_table(n1, n2)).  Returns a
// cudaError_t (cudaErrorInvalidValue: K5 does not take W on `cluster`
// CTAs).
extern "C" int acq_coh_spec_info(int W, int cluster, int* info) {
  Launch l;
  cudaError_t e;
  if (spec_launch(l, W, cluster, false)) {
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
// scratch, which are zeroed here and unread where a_chunk = A).  surface:
// surface_rows' build where the batched core would run (acq_coh_spec_surface).
// Returns the cudaError_t of the first call that fails (0 = launched).
static int coh_spec(const void* F2, const void* code_f, const void* tw,
                    void* peak, void* idx, void* al, void* key, void* count,
                    int P, int DC, int GA, int A, int W, int n_valid,
                    int cluster, int a_chunk, bool surface, void* stream) {
  if (P < 1 || DC < 1 || A < 1 || A > 65535 || GA < A || GA % A != 0 ||
      n_valid < 0 || n_valid > W || a_chunk < 1 || a_chunk > A)
    return (int)cudaErrorInvalidValue;
  const int lo = n_valid ? W - n_valid : 0;
  const int nch = (A + a_chunk - 1) / a_chunk;
  const cudaStream_t st = (cudaStream_t)stream;
  Launch l;
  if (spec_launch(l, W, cluster, surface)) {
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

// K5 as coh_spec, the batched core at 16384 (K6's surface stage,
// csrc/acquire_coh.cu, launches it too)
extern "C" int acq_coh_spec(const void* F2, const void* code_f,
                            const void* tw, void* peak, void* idx, void* al,
                            void* key, void* count, int P, int DC, int GA,
                            int A, int W, int n_valid, int cluster,
                            int a_chunk, void* stream) {
  return coh_spec(F2, code_f, tw, peak, idx, al, key, count, P, DC, GA, A, W,
                  n_valid, cluster, a_chunk, false, stream);
}

// K5 as acq_coh_spec, on surface_rows' build (Spec<14, 8>) where the
// batched core would run: the ablation (chip_smoke.py, the card tests)
extern "C" int acq_coh_spec_surface(const void* F2, const void* code_f,
                                    const void* tw, void* peak, void* idx,
                                    void* al, void* key, void* count, int P,
                                    int DC, int GA, int A, int W, int n_valid,
                                    int cluster, int a_chunk, void* stream) {
  return coh_spec(F2, code_f, tw, peak, idx, al, key, count, P, DC, GA, A, W,
                  n_valid, cluster, a_chunk, true, stream);
}
