// One tracking step's early/prompt/late sums for every channel (kernels K3
// and K4), one cluster launch a step.
//
// Replaces the TPU kernels
//   K3 gnss_dsp_tpu/ops/pallas_track2.py::epl_correlate2 (pallas_call :419),
//      the per-step route's default: the subcarrier is a runtime kind
//      ("none", "subc", "tmboc") and its coefficients ride in sf lanes 4-7;
//   K4 gnss_dsp_tpu/ops/pallas_track.py::epl_correlate (pallas_call :311),
//      the route behind GNSS_DSP_PALLAS_V1: the subcarrier family ("none",
//      "boc11", "cboc", "tmboc", "rz_even", "rz_odd") is a compile-time
//      constant.
// Both compute the same six sums (track_corr.cuh's per-sample body); they
// differ only in where the subcarrier comes from.  None of the TPU
// machinery carries over: no one-hot MXU routing, no row groups, no
// extended code rows, no bf16 operands.  Each lag's chip index is computed
// directly and the chip read from the plain int8 [C, L] table with __ldg,
// so a long code (GLONASS P: 5.11 MB a channel) stays in device memory,
// which is all the TPU kernels' stream=True does.
//
// What bounds it on the card: one step moves C n 8 bytes of samples
// (n ~ 4100 at GPS L1 4.096 MHz) and does ~20 operations a sample; at 32
// channels that is ~1 MB, well under a microsecond at 3.35 TB/s.  So the
// launch and the latency chain inside it set the time (clock stamps inside
// the kernel: the first read of the lanes, the sample loop of ~120
// instructions a sample, the reductions), and the design cuts each link:
//   - one launch a step: each channel runs on a thread-block cluster of S
//     CTAs (S a power of two up to 16, ops/track_step.cluster_size: the
//     largest with C x S <= 132 SMs), grid C x S.  Each rank stores its six
//     float64 partial sums into rank 0's shared memory with st.async, which
//     completes on an mbarrier of rank 0; rank 0 adds them in rank order,
//     rounds to float32 once and writes the channel's row.  No float64
//     scratch in device memory, no second kernel, no float atomics, and no
//     cluster-wide barrier at the end;
//   - the ranks split the block by its actual n, read from si on the card:
//     tiles of kTile samples from the even sample below ptr, tile t on rank
//     t % S (K2's dealing), so every rank holds samples wherever n >=
//     S kTile, whatever nmax is;
//   - every load is issued before the first wait: the lanes, and by one
//     thread the bulk copies (cp.async.bulk, TMA) of the 8 KiB carrier LUT
//     and of a short code's row (L <= kMaxCode; longer codes, L2CL's and
//     GLONASS P's, are read with __ldg from device memory) into shared
//     memory on an mbarrier, landing while the geometry (Block,
//     compare_wrap_ok) is computed; the sample loop reads the samples with
//     __ldg.  Staging them by bulk copies as well (a `stage` variant)
//     measured slower: the copies can only be issued once si has arrived,
//     a second latency in the chain.
//
// Determinism in a fixed order that is a function of (n, ptr, S) only:
// thread j of a rank adds the samples of its slots j, j + 256, ... (slot
// e = the rank's tile u = e / kTile, sample e % kTile of it) in that order,
// warp shuffles fold each warp (shfl_down by 16 ... 1), the CTA adds its
// warps in order, rank 0 adds the ranks in order.  Each product is exact
// in float64, so the result is the plain version's (float64 sums rounded
// once) up to a double-rounding tie; tests/test_torch_track_step_plan.py
// emulates this order in numpy.

#include <cooperative_groups.h>

#include <type_traits>

#include "cluster_launch.cuh"
#include "track_corr.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gnss_track;

constexpr int kThreads = 256;
constexpr int kTile = 128;          // samples a tile
constexpr int kMaxCluster = 16;
constexpr int kMaxCode = 10230;     // longest code staged in shared memory

// si lanes (the JAX kernels' layout, ops/track_step.py SI_*)
enum { SI_VINT_E, SI_VINT_P, SI_VINT_L, SI_COFF_DF, SI_N, SI_COFF_P,
       SI_CARR_DF, SI_CARR_P, SI_PTR, NSI };
// sf lanes: fr_e, fr_p, fr_l, cf, then K3's a0, a1, a6, tm
enum { SF_FR_E, SF_FR_P, SF_FR_L, SF_CF, SF_A0, SF_A1, SF_A6, SF_TM };

// A CTA's shared memory (dynamic, kSmemBytes).
struct Smem {
  float2 lut[kLut];                   // the carrier LUT (bulk copy)
  int8_t chips[kMaxCode + 32];        // the code row's 16-byte words
  double part[kMaxCluster][6];        // the ranks' partial sums (rank 0's)
  double red[kThreads / 32][6];       // the warps' sums
  unsigned long long bar[2];          // LUT and code, rank sums
};
constexpr int kSmemBytes = (int)((sizeof(Smem) + 127) / 128 * 128);

// A cluster size the launch takes (ops/track_step.cluster_size's S).
bool cluster_ok(int S) {
  return S >= 1 && S <= kMaxCluster && !(S & (S - 1));
}

struct Args {
  const float2* x;
  int nx;
  const int8_t* code;
  int L;
  const int* si;
  const float* sf;
  int sf_stride;
  const int* lens;   // each channel's code length (<= L), or null: L
  const float2* lut;
  float* out;
  int nmax;
  int S;   // CTAs a channel, the cluster size
};

template <int K, bool kSmemCode>
__global__ void __launch_bounds__(kThreads)
step_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& fx = *reinterpret_cast<Smem*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S;
  const int rank = (int)cluster.block_rank();
  int c;   // the channel: the cluster's index in the grid
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(c));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int L = a.lens ? a.lens[c] : a.L;
  const int8_t* row = a.code + (size_t)c * a.L;
  // the lanes, every load issued before any wait
  const int* s = a.si + (size_t)c * NSI;
  const float* f = a.sf + (size_t)c * a.sf_stride;
  const int start = s[SI_PTR];
  const int nloop = max(0, min(min(s[SI_N], a.nmax), a.nx - start));
  Block g{(uint32_t)s[SI_COFF_P], (uint32_t)s[SI_COFF_DF],
          (uint32_t)s[SI_CARR_P], (uint32_t)s[SI_CARR_DF], f[SF_CF],
          {s[SI_VINT_E], s[SI_VINT_P], s[SI_VINT_L]},
          {f[SF_FR_E], f[SF_FR_P], f[SF_FR_L]}, false};
  Coef coef{0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (K == SUB_AFFINE || K == SUB_AFFINE_TMBOC)
    coef = Coef{f[SF_A0], f[SF_A1], f[SF_A6],
                K == SUB_AFFINE_TMBOC ? f[SF_TM] : 0.0f};
  // the 16-byte words that hold the code row (short codes): each holds a
  // byte of the row, so it lies in a mapped page of the table
  const uintptr_t r0 = (uintptr_t)row & ~(uintptr_t)15;
  const uint32_t code_bytes =
      kSmemCode ? (uint32_t)((((uintptr_t)row + L + 15) & ~(uintptr_t)15) - r0)
                : 0u;
  if (tid == 0) {
    clusterk::mbar_init(&fx.bar[0]);
    clusterk::mbar_init(&fx.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // rank 0's bar[1] completes when the other ranks' sums have landed
    clusterk::mbar_expect_tx(&fx.bar[1],
                             (uint32_t)((S - 1) * 6 * sizeof(double)));
    clusterk::mbar_expect_tx(&fx.bar[0],
                             kLut * (uint32_t)sizeof(float2) + code_bytes);
    clusterk::bulk_copy(fx.lut, a.lut, kLut * (uint32_t)sizeof(float2),
                        &fx.bar[0]);
    if (kSmemCode)
      clusterk::bulk_copy(fx.chips, (const void*)r0, code_bytes, &fx.bar[0]);
  }
  // waited on before the first store into rank 0's shared memory: every
  // CTA of the cluster has started and rank 0's mbarriers are initialised
  clusterk::cluster_arrive_relaxed();

  // this rank's share of the block: samples 0 <= i < nloop sit at window
  // position i + off from w0, tile t = position / kTile on rank t % S
  const int off = start & 1;
  const int w0 = start - off;
  __syncthreads();   // this CTA's mbarriers are initialised

  // the geometry, while the LUT and the code row are in flight
  g.cmp = compare_wrap_ok(g, nloop, L);
  const int shift = (int)((uintptr_t)row - r0);
  const float2* xw = a.x + w0;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  clusterk::mbar_wait(&fx.bar[0], 0);
  // thread tid's slots e = tid, tid + kThreads, ... hold the samples at
  // window positions pos0, pos0 + stride, ...: slot e is sample e % kTile
  // of the rank's tile e / kTile = tid / kTile + k kThreads / kTile
  static_assert(kThreads % kTile == 0, "a pass of the CTA covers whole tiles");
  const int stride = S * kThreads;
  int pos0 = (rank + S * (tid / kTile)) * kTile + tid % kTile;
  if (pos0 < off) pos0 += stride;   // before the block's first sample
  auto correlate = [&](auto cmp) {
#pragma unroll 2
    for (int pos = pos0; pos - off < nloop; pos += stride)
      epl_sample<K, decltype(cmp)::value>(
          __ldg(xw + pos), pos - off, fx.lut, g, L, coef,
          [&](int k) {
            if constexpr (kSmemCode) return (int)fx.chips[shift + k];
            else return (int)__ldg(row + k);
          },
          acc);
  };
  if (g.cmp) correlate(std::true_type{});
  else correlate(std::false_type{});

#pragma unroll
  for (int j = 0; j < 6; ++j) acc[j] = warp_sum(acc[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) fx.red[warp][j] = acc[j];
  }
  __syncthreads();
  clusterk::cluster_wait();
  if (tid < 6) {
    double v = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) v += fx.red[w][tid];
    if (rank != 0) {
      // into rank 0's part[rank], completing on its bar[1]
      clusterk::st_async_b64(clusterk::map_rank(&fx.part[rank][tid], 0), v,
                             clusterk::map_rank(&fx.bar[1], 0));
    } else {
      clusterk::mbar_wait(&fx.bar[1], 0);
      double t = 0.0;
      t += v;
      for (int r = 1; r < S; ++r) t += fx.part[r][tid];
      a.out[(size_t)c * 6 + tid] = (float)t;
    }
  }
}

// An empty kernel on the same grid, cluster and shared memory: the launch
// floor under step_kernel's time.
__global__ void __launch_bounds__(kThreads) floor_kernel(const Args) {}

using Kernel = void (*)(Args);

// K3's kinds 0-2 and K4's families 0-5 (v1), the code staged in shared
// memory (L <= kMaxCode) or read from device memory
template <bool kSmemCode>
Kernel kernel_of(int v1, int sel) {
  if (!v1) {
    switch (sel) {
      case 0: return step_kernel<SUB_BPSK, kSmemCode>;
      case 1: return step_kernel<SUB_AFFINE, kSmemCode>;
      case 2: return step_kernel<SUB_AFFINE_TMBOC, kSmemCode>;
    }
    return nullptr;
  }
  switch (sel) {
    case 0: return step_kernel<SUB_BPSK, kSmemCode>;
    case 1: return step_kernel<SUB_BOC11, kSmemCode>;
    case 2: return step_kernel<SUB_CBOC, kSmemCode>;
    case 3: return step_kernel<SUB_TMBOC, kSmemCode>;
    case 4: return step_kernel<SUB_RZ_EVEN, kSmemCode>;
    case 5: return step_kernel<SUB_RZ_ODD, kSmemCode>;
  }
  return nullptr;
}

Kernel kernel_of(int v1, int sel, int L) {
  return L <= kMaxCode ? kernel_of<true>(v1, sel) : kernel_of<false>(v1, sel);
}

int launch(int v1, int sel, const void* x, int nx, const void* code, int L,
           const void* si, const void* sf, int sf_stride, const void* lens,
           const void* lut, void* out, int C, int nmax, int cluster,
           void* stream) {
  const Kernel k = kernel_of(v1, sel, L);
  if (k == nullptr || nx < 1 || L < 1 || C < 1 || nmax < 1 ||
      sf_stride < (v1 ? 4 : 8) || !cluster_ok(cluster) ||
      (long long)C * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args args{(const float2*)x, nx, (const int8_t*)code, L,
                  (const int*)si, (const float*)sf, sf_stride,
                  (const int*)lens, (const float2*)lut,
                  (float*)out, nmax, cluster};
  return (int)clusterk::launch_cluster(k, C * cluster, kThreads, cluster,
                                       (size_t)kSmemBytes,
                                       (cudaStream_t)stream, args);
}

}  // namespace

// x: complex64 [nx]; code: int8 [C, L]; si: int32 [C, 9]; sf: float32
// [C, >= lanes] rows sf_stride floats apart; lens: null, or int32 [C]
// each channel's code length (<= L, its row zero-padded past it); lut: float32 [1024, 2],
// 16-byte aligned; out: float32 [C, 6].  nmax bounds every channel's n;
// cluster: the CTAs a channel (cluster_size's S).  Returns the
// cudaError_t of the one launch (0 = launched); a cluster the card cannot
// hold is refused, never run on fewer CTAs.

// K3: kind 0 = "none", 1 = "subc", 2 = "tmboc"; sf has 8 lanes.
extern "C" int track_step_v2(const void* x, int nx, const void* code, int L,
                             const void* si, const void* sf, int sf_stride,
                             const void* lens, const void* lut, void* out,
                             int C, int nmax, int cluster, int kind,
                             void* stream) {
  return launch(0, kind, x, nx, code, L, si, sf, sf_stride, lens, lut,
                out, C, nmax, cluster, stream);
}

// K4: family 0 = "none", 1 = "boc11", 2 = "cboc", 3 = "tmboc",
// 4 = "rz_even", 5 = "rz_odd"; sf has at least 4 lanes.
extern "C" int track_step_v1(const void* x, int nx, const void* code, int L,
                             const void* si, const void* sf, int sf_stride,
                             const void* lens, const void* lut, void* out,
                             int C, int nmax, int cluster, int family,
                             void* stream) {
  return launch(1, family, x, nx, code, L, si, sf, sf_stride, lens, lut,
                out, C, nmax, cluster, stream);
}

// The launch floor: floor_kernel on the grid, cluster and shared memory of
// a step of C channels on `cluster` CTAs a channel.
extern "C" int track_step_floor(int C, int cluster, void* stream) {
  if (C < 1 || !cluster_ok(cluster)) return (int)cudaErrorInvalidValue;
  const Args args{};
  return (int)clusterk::launch_cluster(floor_kernel, C * cluster, kThreads,
                                       cluster, (size_t)kSmemBytes,
                                       (cudaStream_t)stream, args);
}

// The kernel for (v1, sel) and a code of L chips on `cluster` CTAs a
// channel: info[0] S, [1] dynamic shared memory bytes a CTA, [2] registers
// a thread, [3] local (spilled) bytes a thread, [4] clusters the card
// holds at once, [5] threads a CTA.
extern "C" int track_step_info(int cluster, int v1, int sel, int L,
                               void* info) {
  const Kernel k = kernel_of(v1, sel, L);
  if (k == nullptr || L < 1 || !cluster_ok(cluster))
    return (int)cudaErrorInvalidValue;
  return (int)clusterk::cluster_info(k, kThreads, cluster,
                                     (size_t)kSmemBytes, (int*)info);
}
