// Non-coherent acquisition surface, full and unreduced (kernel K7).
//
// Replaces the TPU kernel gnss_dsp_tpu/ops/pallas_acquire.py::corr_surface
// (pallas_call at :221, body _kernel :120-177).  For each PRN p, doppler d
// and lag j it writes
//
//     q[p, d, j] = (1/W) * sum_b | IDFT_W( code_f[p] * conj(F[d, b]) ) [j] |
//
// in natural lag order.  The TPU kernel's permuted layout (q index
// j2*n1 + j1, perm_to_natural_index) came from its 128-lane matrix-unit
// split and is not carried over.
//
// Design: one thread-block cluster per (p, d) and block segment.  Each of
// its rows is transformed across the cluster's C CTAs by the four-step
// core of acq_cluster.cuh, with no value in device memory; each CTA keeps
// the |.| sums of its lags in registers across the segment's blocks, then
// writes them once, in natural order.  While a row transforms, the CTA's
// slice of the next block of F is copied into shared memory by cp.async
// (`stage`): the loads of F were a fifth of a row's time.  At Xona X5
// (W = 30690 = 165 * 186 = (3*5*11) * (2*3*31)) the fewest CTAs whose
// shares and stage fit are C = 4: 47 columns and 42 rows each (the last
// CTA 45 and 39), radix 3, 5, 11 over the columns and 2, 3, 31 over the
// rows.  384 threads keep 168 registers (at 512 the 128-register cap
// spilled the radix-31 butterflies).  With one PRN (Xona X5) the (p, d)
// alone would not fill the card, so each (p, d)'s blocks are split into
// nseg segments, one cluster each (nseg from the clusters the card holds
// at once), and a second kernel sums the segments in a fixed order: two
// launches give the same bits, with no atomics.
//
// What bounds it on the card: F, read once from device memory (8 bytes a
// cell), against the direct radix-11 and radix-31 DFTs and the
// shared-memory passes.

#include "acq_cluster.cuh"

namespace {

constexpr int kT = 384;                 // threads per CTA (168 registers)
constexpr int kPer = 27;                // values per thread and CTA row share
constexpr int kMaxE = kT * kPer;        // values per CTA

struct FullArgs {
  const float2* F;        // [DC, B, W]
  const float2* code_f;   // [P, W]
  const float2* tw;       // ops/acquire2.cluster_twiddle_table(n1, n2)
  float* out;             // q [P, DC, W] when nseg = 1, else [P*DC*nseg, W]
  int P, DC, B, nseg;
  acqc::Plan plan;
};

__global__ void __launch_bounds__(kT, 1)
    full_kernel(const __grid_constant__ FullArgs s) {
  using namespace acqc;
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Plan& pl = s.plan;
  const int W = pl.W, n1 = pl.n1, n2 = pl.n2;
  const Share h = share_of(pl, (int)cluster.block_rank());
  const int El = h.nc * n1;               // values loaded (column layout)
  const int Ea = h.nr * n2;               // values summed (row layout)
  const int unit = blockIdx.x / pl.C;      // (item, segment), item = d*P + p
  const int item = unit / s.nseg;
  const int seg = unit - item * s.nseg;
  const int p = item % s.P;
  const int d = item / s.P;
  const int b0 = (int)((long long)s.B * seg / s.nseg);
  const int b1 = (int)((long long)s.B * (seg + 1) / s.nseg);
  float2* buf_a = smem;
  float2* buf_b = smem + pl.buf;
  float2* stage = buf_b + pl.buf;         // [El]: F's slice, load order
  float2* tw = stage + pl.nc * n1;
  const int tid = threadIdx.x;
  // this CTA's columns of block b of F into stage, by cp.async
  auto stage_row = [&](int b) {
    const float2* row = s.F + ((size_t)d * s.B + b) * W + h.c0;
    for (int e = tid; e < El; e += kT) {
      const int k1 = fdiv(e, h.ncd);
      cp_async8(stage + e, row + (e - k1 * h.nc) + (size_t)n2 * k1);
    }
    cp_async_commit();
  };
  stage_row(b0);
  for (int i = tid; i < pl.ntw; i += kT) tw[i] = s.tw[i];
  const float2* cf = s.code_f + (size_t)p * W + h.c0;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int b = b0; b < b1; ++b) {
    cp_async_wait_all();
    __syncthreads();             // tw and block b staged; last row read out
    for (int e0 = tid; e0 < El; e0 += kBatch * kT) {
      float2 c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kT;
        if (e < El) {
          const int k1 = fdiv(e, h.ncd);
          c[u] = __ldg(cf + (e - k1 * h.nc) + (size_t)n2 * k1);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kT;
        if (e < El) {
          const int k1 = fdiv(e, h.ncd);
          buf_a[at(e - k1 * h.nc, pl.col.S, k1)] = cmul_conj(c[u], stage[e]);
        }
      }
    }
    __syncthreads();             // the row is in buf_a; stage may be refilled
    if (b + 1 < b1) stage_row(b + 1);
    const float2* z = row_transform<kT>(pl, h, buf_a, buf_b, tw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kT;
      if (e < Ea) {
        const int t = fdiv(e, pl.n2_d);
        const float2 v = z[at(t, pl.row.S, e - t * n2)];
        acc[i] += cabs_approx(v);
      }
    }
  }
  const bool whole = s.nseg == 1;
  float* o = s.out + (size_t)(whole ? (size_t)p * s.DC + d : unit) * W;
  const float fw = (float)W;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kT;
    if (e < Ea) {
      const int t = fdiv(e, pl.n2_d);
      o[h.j10 + t + n1 * (e - t * n2)] = whole ? acc[i] / fw : acc[i];
    }
  }
}

// q[p, d, j] = (sum of the nseg segments of item d*P + p, in order) / W
__global__ void __launch_bounds__(256)
    segment_sum_kernel(const float* __restrict__ part, float* __restrict__ q,
                       int P, int DC, int nseg, int W) {
  const size_t n = (size_t)P * DC * W;
  const float fw = (float)W;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (size_t)gridDim.x * 256) {
    const size_t pd = i / W;
    const size_t item = (pd % DC) * P + pd / DC;
    const float* pp = part + item * nseg * W + (i - pd * W);
    float v = pp[0];
    for (int g = 1; g < nseg; ++g) v += pp[(size_t)g * W];
    q[i] = v / fw;
  }
}

// shared memory of a CTA: the two buffers, the staged F slice, the tables
size_t full_smem(const acqc::Plan& pl) {
  return acqc::cluster_smem(pl, pl.nc * pl.n1);
}

// K7's plan at W = n1 * n2 over C CTAs (0: the fewest, up to 8, whose
// shares fit kMaxE values and the shared memory of a CTA)
bool full_plan(acqc::Plan& pl, int W, int n1, int n2, int C) {
  for (int c = C ? C : 1; c <= (C ? C : 8); ++c) {
    if (acqc::make_plan(pl, W, n1, n2, c) && pl.nr * n2 <= kMaxE &&
        full_smem(pl) <= acqc::kMaxSmem)
      return true;
  }
  return false;
}

// segments per (p, d): the count up to min(B, 8) whose clusters fill the
// waves of `active` clusters best (the fewest on ties); 1 when the items
// alone fill four waves
int segments(long long items, int B, int active) {
  if (active < 1 || items >= 4LL * active) return 1;
  int best = 1;
  double eff = 0.0;
  for (int n = 1; n <= B && n <= 8; ++n) {
    const long long units = items * n;
    const long long waves = (units + active - 1) / active;
    const double e = (double)units / (double)(waves * active);
    if (e > eff + 1e-9) {
      eff = e;
      best = n;
    }
  }
  return best;
}

}  // namespace

// The launch plan of K7 for P*DC items of B blocks at W = n1 * n2 over
// `cluster` CTAs (0: the kernel's own choice): info[0] cluster size, [1]
// segments per (p, d), [2] dynamic shared memory bytes a CTA, [3]
// registers a thread, [4] local (spilled) bytes a thread, [5] clusters the
// card holds at once (cudaOccupancyMaxActiveClusters).
// Returns a cudaError_t (cudaErrorInvalidValue: no cluster holds the row).
extern "C" int acq_full_info(int P, int DC, int B, int W, int n1, int n2,
                             int cluster, int* info) {
  acqc::Plan pl;
  if (P < 1 || DC < 1 || B < 1 || !full_plan(pl, W, n1, n2, cluster))
    return (int)cudaErrorInvalidValue;
  const size_t smem = full_smem(pl);
  int ci[6];
  const cudaError_t e = acqc::cluster_info(full_kernel, kT, pl.C, smem, ci);
  if (e != cudaSuccess) return (int)e;
  info[0] = pl.C;
  info[1] = segments((long long)P * DC, B, ci[4]);
  info[2] = (int)smem;
  info[3] = ci[2];
  info[4] = ci[3];
  info[5] = ci[4];
  return 0;
}

// K7.  F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: complex64
// cluster_twiddle_table(n1, n2); part: f32 [P*DC*nseg, W] scratch (unused
// when nseg = 1); q: f32 [P, DC, W].  cluster and nseg as acq_full_info
// gives them.  Returns the cudaError_t of the launches (0 = launched).
extern "C" int acq_surface_full(const void* F, const void* code_f,
                                const void* tw, void* part, void* q, int P,
                                int DC, int B, int W, int n1, int n2,
                                int cluster, int nseg, void* stream) {
  FullArgs s = {};
  if (P < 1 || DC < 1 || B < 1 || nseg < 1 || nseg > B ||
      !full_plan(s.plan, W, n1, n2, cluster))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)P * DC;
  const long long grid = items * nseg * s.plan.C;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.out = (float*)(nseg == 1 ? q : part);
  s.P = P;
  s.DC = DC;
  s.B = B;
  s.nseg = nseg;
  const cudaError_t e =
      acqc::launch_cluster(full_kernel, (int)grid, kT, s.plan.C,
                           full_smem(s.plan), (cudaStream_t)stream, s);
  if (e != cudaSuccess || nseg == 1) return (int)e;
  segment_sum_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)q, P, DC, nseg, W);
  return (int)cudaGetLastError();
}
