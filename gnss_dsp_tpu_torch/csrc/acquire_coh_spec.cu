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
// Design: one thread-block cluster of C CTAs per (p, d) walks all A
// alignments and G groups of its G*A rows.  Each row is a four-step
// transform W = n1 * n2 (n1 = 2^floor(log2(W)/2)) split over the cluster,
// with no value in device memory:
//
//   load     CTA r owns the columns k2 in [r*nc, (r+1)*nc) (nc = n2/C).
//            Its slice of the row, X[k2 + n2*k1] for every k1, was copied
//            into `stage` by cp.async while the previous row transformed;
//            times conj of code_f[p] (kept in shared memory for the whole
//            cluster life), into registers
//   columns  n1-point IDFTs over k1, in registers and one exchange
//            (acq_cluster.cuh Split), then times w^(j1*k2): for a thread's
//            cells j1 = a + 16 b the product of w^(a*k2) (made once, in
//            registers) and w^(16*b*k2) (a [Q][nc] table in shared
//            memory), both from two small tables (w^t = A[t mod n2] *
//            B[t div n2]); stored to yb[k2 - r*nc][j1]
//   cluster barrier
//   rows     CTA r owns the rows j1 in [r*nr, (r+1)*nr) (nr = n1/C): it
//            reads Y[j1, k2] for its j1 from the yb of the CTA owning k2
//            (cluster.map_shared_rank), then n2-point IDFTs over k2 in
//            registers and one exchange: x[j1 + n1*j2]
//
// Each thread sums |x| of its 16 lags in registers across the G groups,
// then keeps per lag the running (peak, lowest alignment) over the A
// alignments in registers too.  The cluster then reduces (peak, lowest
// lag, its alignment) through distributed shared memory and writes it: no
// [P, DC, A] scratch and no second kernel.  Clusters d*P + p: the P
// clusters of one doppler run side by side and read its F2 rows from L2.
//
// What bounds it on the card: the float32 operations of the transforms
// (~5 log2 W per value and row) and the shared-memory traffic (per value
// and row: the staged load, two exchanges, the yb store and the remote
// read).  All sizes are compile-time: one kernel per log2 W and C.
//
// W must be a power of two, 2 <= W <= 16384.  At W = 16384 (128 x 128)
// the cluster is 8 CTAs of 128 threads (66 KB of shared memory each, three
// to an SM), or 4 of 256 (130 KB, one to an SM).  A wider W keeps n1 <= n2
// <= 2 n1 with 16-value threads, so 32768 (128 x 256) needs only a
// step C of 16 threads a transform.

#include "acq_cluster.cuh"

namespace {

struct SpecArgs {
  const float2* F2;       // [DC, GA, W]
  const float2* code_f;   // [P, W]
  float* peak;            // [P, DC]
  int* idx;               // [P, DC], lag - lo
  int* al;                // [P, DC]
  int P, DC, GA, A, lo;
};

struct Best {
  float v;
  int j, a;
};

// higher value, then lower lag
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && j < bj);
}

// The compile-time layout of log2 W = L over C CTAs.
template <int L, int C>
struct Spec {
  static constexpr int N1 = 1 << (L / 2), N2 = 1 << (L - L / 2);
  static constexpr int W = N1 * N2;
  using S1 = acqc::Split<N1>;
  using S2 = acqc::Split<N2>;
  static constexpr int NC = N2 / C, NR = N1 / C;     // columns, rows a CTA
  static constexpr int LNC = acqc::ilog2(NC), LNR = acqc::ilog2(NR);
  static constexpr int LN2 = acqc::ilog2(N2);
  static constexpr int TC = NC * S1::Q, TR = NR * S2::Q;
  static constexpr int T = TC > TR ? (TC > 32 ? TC : 32) : (TR > 32 ? TR : 32);
  static constexpr int E = W / C;                    // values a CTA holds
  static constexpr int YS = N1 + 1;                  // yb row stride (odd)
  // shared memory, float2: stage[E], code[E], xb[E], yb[NC*YS], wN1[N1],
  // wN2[N2], wA[N2], wS[Q1][NC]
  static constexpr int kOffCode = E, kOffXb = 2 * E, kOffYb = 3 * E;
  static constexpr int kOffW1 = kOffYb + NC * YS;
  static constexpr int kOffW2 = kOffW1 + N1, kOffWA = kOffW2 + N2;
  static constexpr int kOffWS = kOffWA + N2;
  static constexpr size_t kSmem =
      (size_t)(kOffWS + S1::Q * NC) * sizeof(float2);
  static constexpr int kPerSm = (int)((227 * 1024) / (kSmem + 1024));
  // CTAs an SM holds by shared memory, as long as a thread keeps 128
  // registers
  static constexpr int kMinBlocks =
      kPerSm < 1 ? 1 : (kPerSm * T > 512 ? (T >= 512 ? 1 : 512 / T) : kPerSm);
  static_assert(C >= 1 && C <= 8 && NR >= 1, "C CTAs must each own a row");
  static_assert(kSmem <= 227 * 1024, "one CTA's shared memory");
};

template <int L, int C>
__global__ void __launch_bounds__(Spec<L, C>::T, Spec<L, C>::kMinBlocks)
    coh_spec_kernel(const __grid_constant__ SpecArgs s) {
  using namespace acqc;
  using K = Spec<L, C>;
  using S1 = typename K::S1;
  using S2 = typename K::S2;
  constexpr int N1 = K::N1, N2 = K::N2, W = K::W, NC = K::NC, NR = K::NR;
  constexpr int R1 = S1::R, Q1 = S1::Q, R2 = S2::R, Q2 = S2::Q;
  extern __shared__ __align__(16) float2 smem[];
  __shared__ Best red[K::T / 32 > 0 ? K::T / 32 : 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / C;
  const int p = item % s.P;
  const int d = item / s.P;
  const int tid = threadIdx.x;
  float2* stage = smem;
  float2* code = smem + K::kOffCode;
  float2* xb = smem + K::kOffXb;
  float2* yb = smem + K::kOffYb;
  float2* wN1 = smem + K::kOffW1;
  float2* wN2 = smem + K::kOffW2;
  float2* wA = smem + K::kOffWA;
  float2* wS = smem + K::kOffWS;
  const int G = s.GA / s.A;
  const int c0 = rank * NC;
  // column role (tid < TC): column c0 + col, thread t1 of its transform;
  // row role (tid < TR): row j1 = rank*NR + jl, thread t2 of its transform
  const int t1 = tid >> K::LNC, col = tid & (NC - 1);
  const int t2 = tid >> K::LNR, jl = tid & (NR - 1);
  const int j1 = rank * NR + jl;

  // this CTA's slice of row i of F2 into stage, [k1][col]
  auto stage_row = [&](int i) {
    const float2* row = s.F2 + ((size_t)d * s.GA + i) * W + c0;
    if constexpr (NC >= 2) {
      for (int e = tid; e < K::E / 2; e += K::T) {
        const int k1 = e >> (K::LNC - 1), c = (e & (NC / 2 - 1)) * 2;
        cp_async16(stage + k1 * NC + c, row + c + (size_t)N2 * k1);
      }
    } else {
      for (int k1 = tid; k1 < N1; k1 += K::T)
        cp_async8(stage + k1, row + (size_t)N2 * k1);
    }
    cp_async_commit();
  };

  stage_row(0);
  for (int i = tid; i < N1; i += K::T) wN1[i] = unit_root(i, N1);
  for (int i = tid; i < N2; i += K::T) {
    wN2[i] = unit_root(i, N2);
    wA[i] = unit_root(i, W);
  }
  {
    const float2* cf = s.code_f + (size_t)p * W + c0;
    for (int e = tid; e < K::E; e += K::T) {
      const int k1 = e >> K::LNC, c = e & (NC - 1);
      code[e] = __ldg(cf + c + (size_t)N2 * k1);
    }
  }
  __syncthreads();
  // The four-step twiddle w^(j1*k2) of step C's cell out[h*Q1 + b] (j1 =
  // t1*H1 + h + R1*b) is gb[h] * wS[b][col]: gb[h] = w^((t1*H1 + h)*k2)
  // in registers, wS[b][col] = w^(R1*b*k2) in shared memory, each from
  // the two small tables, w^t = wA[t mod n2] * wN1[t div n2].
  auto w_of = [&](int t) {
    t &= W - 1;
    return cmul(wA[t & (N2 - 1)], wN1[t >> K::LN2]);
  };
  float2 gb[S1::H];
#pragma unroll
  for (int h = 0; h < S1::H; ++h)
    gb[h] = w_of(tid < K::TC ? (t1 * S1::H + h) * (c0 + col) : 0);
  for (int e = tid; e < Q1 * NC; e += K::T)
    wS[e] = w_of(R1 * (e >> K::LNC) * (c0 + (e & (NC - 1))));
  cluster_arrive();           // pairs with the first row's wait

  // per lag: the best sum over the alignments so far, and its alignment
  // (16 bits, two to a register: A <= 65535)
  float best[R2];
  uint32_t besta[(R2 + 1) / 2];
#pragma unroll
  for (int o = 0; o < R2; ++o) best[o] = -INFINITY;
#pragma unroll
  for (int o = 0; o < (R2 + 1) / 2; ++o) besta[o] = 0;
  for (int a = 0; a < s.A; ++a) {
    float acc[R2];
#pragma unroll
    for (int o = 0; o < R2; ++o) acc[o] = 0.f;
    for (int g = 0; g < G; ++g) {
      cp_async_wait_all();
      __syncthreads();        // stage holds row g*A + a; xb is free
      float2 v[R1];
      if (tid < K::TC) {
#pragma unroll
        for (int m = 0; m < R1; ++m) {
          const int e = (t1 + Q1 * bitrev(m, S1::LR)) * NC + col;
          v[m] = cmul_conj(code[e], stage[e]);
        }
        split_ab<N1>(v, t1, wN1);
        if constexpr (Q1 > 1) split_put<N1>(v, xb, NC, col, t1);
      }
      __syncthreads();        // stage read out, xb complete
      if (g + 1 < G)
        stage_row((g + 1) * s.A + a);
      else if (a + 1 < s.A)
        stage_row(a + 1);
      if (tid < K::TC) {
        if constexpr (Q1 > 1) split_c<N1>(v, xb, NC, col, t1);
#pragma unroll
        for (int o = 0; o < R1; ++o)
          v[o] = cmul(v[o], cmul(gb[o / Q1], wS[(o % Q1) * NC + col]));
      }
      cluster_wait();         // the last row's readers of yb are done
      if (tid < K::TC) {
#pragma unroll
        for (int o = 0; o < R1; ++o)
          yb[col * K::YS + split_index<N1>(o, t1)] = v[o];
      }
      cluster_arrive();
      cluster_wait();         // every CTA's yb holds this row's columns
      float2 z[R2];
      if (tid < K::TR) {
#pragma unroll
        for (int m = 0; m < R2; ++m) {
          const int k2 = t2 + Q2 * bitrev(m, S2::LR);
          const float2* src = cluster.map_shared_rank(
              yb + (k2 & (NC - 1)) * K::YS + j1, k2 >> K::LNC);
          z[m] = *src;
        }
        split_ab<N2>(z, t2, wN2);
        if constexpr (Q2 > 1) split_put<N2>(z, xb, NR, jl, t2);
      }
      cluster_arrive();       // this CTA's reads of the others are done
      __syncthreads();        // xb complete
      if (tid < K::TR) {
        if constexpr (Q2 > 1) split_c<N2>(z, xb, NR, jl, t2);
#pragma unroll
        for (int o = 0; o < R2; ++o)
          acc[o] += cabs_approx(z[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < R2; ++o) {
      if (acc[o] > best[o]) {  // a ascending: the lowest alignment on ties
        const int sh = (o & 1) * 16;
        best[o] = acc[o];
        besta[o / 2] = (besta[o / 2] & ~(0xffffu << sh)) | ((uint32_t)a << sh);
      }
    }
  }
  cluster_wait();             // nobody reads this CTA's yb any more

  // (peak, lowest lag >= lo reaching it, its alignment) over this CTA
  Best b = {-INFINITY, W, 0};
  if (tid < K::TR) {
#pragma unroll
    for (int o = 0; o < R2; ++o) {
      const int j = j1 + N1 * split_index<N2>(o, t2);
      if (j >= s.lo && better(best[o], j, b.v, b.j))
        b = {best[o], j, (int)((besta[o / 2] >> ((o & 1) * 16)) & 0xffffu)};
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, b.v, o);
    const int oj = __shfl_down_sync(0xffffffffu, b.j, o);
    const int oa = __shfl_down_sync(0xffffffffu, b.a, o);
    if (better(ov, oj, b.v, b.j)) b = {ov, oj, oa};
  }
  if ((tid & 31) == 0) red[tid >> 5] = b;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < K::T / 32; ++w)
      if (better(red[w].v, red[w].j, red[0].v, red[0].j)) red[0] = red[w];
  }
  cluster.sync();             // every CTA's red[0] is final
  if (rank == 0 && tid == 0) {
    Best c = red[0];
    for (int r = 1; r < C; ++r) {
      const Best o = *cluster.map_shared_rank(&red[0], r);
      if (better(o.v, o.j, c.v, c.j)) c = o;
    }
    const size_t o = (size_t)p * s.DC + d;
    s.peak[o] = c.v * (1.0f / (float)W);   // exact: W is a power of two
    s.idx[o] = c.j - s.lo;
    s.al[o] = c.a;
  }
  cluster.sync();             // rank 0 has read the others' red[0]
}

using Kernel = void (*)(const SpecArgs);

struct Launch {
  Kernel kernel;
  int C, T;
  size_t smem;
};

template <int L, int C>
Launch launch_of() {
  using K = Spec<L, C>;
  return {coh_spec_kernel<L, C>, C, K::T, K::kSmem};
}

// The kernels built: log2 W = 1 .. 14, C = min(8, n1) CTAs a cluster (the
// choice), and 4 CTAs at W = 16384.
bool spec_launch(Launch& l, int W, int C) {
  if (W < 2 || W > 16384 || (W & (W - 1))) return false;
  const int L = acqc::ilog2(W);
  const int n1 = 1 << (L / 2);
  const int choice = n1 < 8 ? n1 : 8;
  if (C == 0) C = choice;
  if (C != choice && !(L == 14 && C == 4)) return false;
  switch (L) {
    case 1: l = launch_of<1, 1>(); break;
    case 2: l = launch_of<2, 2>(); break;
    case 3: l = launch_of<3, 2>(); break;
    case 4: l = launch_of<4, 4>(); break;
    case 5: l = launch_of<5, 4>(); break;
    case 6: l = launch_of<6, 8>(); break;
    case 7: l = launch_of<7, 8>(); break;
    case 8: l = launch_of<8, 8>(); break;
    case 9: l = launch_of<9, 8>(); break;
    case 10: l = launch_of<10, 8>(); break;
    case 11: l = launch_of<11, 8>(); break;
    case 12: l = launch_of<12, 8>(); break;
    case 13: l = launch_of<13, 8>(); break;
    default: l = C == 4 ? launch_of<14, 4>() : launch_of<14, 8>(); break;
  }
  return l.C == C;
}

cudaLaunchConfig_t cluster_config(const Launch& l, int grid,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3((unsigned)l.T, 1, 1);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The launch plan of K5 at W with `cluster` CTAs (0: the kernel's own
// choice): info[0] cluster size, [1] dynamic shared memory bytes a CTA,
// [2] registers a thread, [3] local (spilled) bytes a thread, [4] clusters
// the card holds at once (cudaOccupancyMaxActiveClusters), [5] threads a
// CTA.  Returns a cudaError_t (cudaErrorInvalidValue: no such kernel).
extern "C" int acq_coh_spec_info(int W, int cluster, int* info) {
  Launch l;
  if (!spec_launch(l, W, cluster)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, l.kernel);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(l, l.C, 0, attr);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, l.kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  info[0] = l.C;
  info[1] = (int)l.smem;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = active;
  info[5] = l.T;
  return 0;
}

// K5.  F2: complex64 [DC, GA, W] (row g*A + a); code_f: complex64 [P, W];
// outputs peak f32, idx i32, al i32 [P, DC].  cluster: as
// acq_coh_spec_info.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int acq_coh_spec(const void* F2, const void* code_f, void* peak,
                            void* idx, void* al, int P, int DC, int GA, int A,
                            int W, int n_valid, int cluster, void* stream) {
  Launch l;
  if (P < 1 || DC < 1 || A < 1 || A > 65535 || GA < A || GA % A != 0 ||
      n_valid < 0 ||
      n_valid > W || !spec_launch(l, W, cluster))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)P * DC * l.C;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  SpecArgs s = {};
  s.F2 = (const float2*)F2;
  s.code_f = (const float2*)code_f;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.al = (int*)al;
  s.P = P;
  s.DC = DC;
  s.GA = GA;
  s.A = A;
  s.lo = n_valid ? W - n_valid : 0;
  cudaError_t e = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(l, (int)grid, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, l.kernel, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
