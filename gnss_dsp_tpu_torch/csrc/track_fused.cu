// The whole tracking loop for one chunk in one launch (kernel K2).
//
// Replaces the TPU kernel
// gnss_dsp_tpu/ops/pallas_track_fused.py::track_scan_fused (pallas_call at
// :616, body _kernel :118), including the early/prompt/late math it takes
// from ops/pallas_track2.py (tile_contrib :107, finalize_contrib :278).
//
// The loop filter closes over each block's correlators, so one channel's
// blocks are sequential.  Each channel runs on a thread-block cluster of S
// CTAs (S a power of two up to 16, ops/track_fused.cluster_plan: the
// largest with C x S <= 132 SMs), grid C x S.  Every CTA keeps the whole
// channel state in the registers of its warp 0 and runs the serial part
// itself, from the same inputs, so every CTA holds the same bits:
//   1. warp 0 runs filter(b - 1) and geometry(b) as one serial section
//      (track/engine._post_block, then _geometry): the adaptive block
//      length n (the q/r split of _sub_block_len), whether the chunk still
//      holds the block (ok), the three lags' integer and fractional chip
//      phases, the two DDS phases and increments; with coh set
//      (extended-coherent tracking, M = the sigp COH lane) the filter first
//      wipes the block's E/P/L by the overlay chip overlay[c, block %
//      nov_c], adds them into the six cacc sums, lets the filters see the
//      sums and advance only where (block + 1) % M == 0, and resets cacc
//      there; the row keeps the block's wiped values.  It hands the
//      geometry to the CTA through shared memory (Geo, by b & 1) before
//      the block's one __syncthreads;
//   2. a producer warp beside the 256 workers issues the bulk copies
//      (cp.async.bulk, TMA), one a lane, of the NEXT block's sample window into the other of two stage buffers: its
//      start, ptr + n, is known at this block's geometry (clamped into x as
//      the engine clamps it, engine.py:257), its length nmax + 2 from the
//      even sample below the start (16-byte copies), dealt round-robin to
//      the S CTAs in tiles of kTile samples, so any n spreads evenly;
//   3. the CTA waits on this block's stage mbarrier and correlates the
//      samples of its own tiles with track_corr.cuh's epl_sample (the
//      fused double-LUT carrier wipe, three chip reads, the subcarrier
//      factor of K3's runtime kind K, six float64 sums: each product of a
//      float32 sample and a float32 factor is exact); it reads samples only
//      from the stage;
//   4. warp shuffles and the warps in order reduce the CTA's six sums, and
//      the CTA writes them into slot [b & 1][rank] of every CTA's shared
//      memory (cluster.map_shared_rank);
//   5. one split cluster barrier (arrive.release, wait.acquire); warp 0
//      of every CTA then sums the S partials in rank order, so all hold
//      the same bits, and goes on to 1.  Rank 0 writes the rows and the
//      final state.
// Why one cluster barrier a block is enough: CTA X writes slot [b & 1] of
// CTA Y before barrier b, and Y reads it after barrier b and before it
// arrives at barrier b + 1.  X writes that slot again only at block b + 2,
// after it has passed barrier b + 1, which Y reached only after its read.
// The stage buffer block b + 1 fills was last read in block b - 1, before
// every thread of the CTA arrived at barrier b - 1, which the producer
// has passed when it issues the copy.  Where a CTA's share of the window does
// not fit two stages (L5-class rates on many channels: the plan's batches
// m > 1), the share streams through the two buffers in m batches, each
// issued while the one before is correlated, with a __syncthreads between
// the batches of a block.
// Codes of <= kMaxCode chips are copied to shared memory once (template
// kSmemCode); longer ones (GPS L2CL 767,250 chips, GLONASS P 5,110,000)
// are read with __ldg straight from the int8 [C, L] table in device
// memory: a block's three lags touch a window of about n cf + 2 chips,
// neighbouring threads read the same or the next chip, and the window
// stays in L1/L2.  The overlay rows (<= kMaxOverlay chips) are staged in
// shared memory.  None of the TPU machinery carries over: no one-hot MXU
// routing, no 128-lane packing, no scalar prefetch, no tile padding; the
// TPU kernel's double-buffered window DMA (:137-161, :185-193) becomes
// step 2.
//
// What bounds it on the card: latency of the per-block chain (the serial
// filter and geometry, two __syncthreads and one cluster barrier), not
// bandwidth: each block reads about nmax samples once.
//
// Rounding is pinned down to match the plain version (ops/track_fused.py):
// built with --fmad=false; the multiply-adds the reference rounds once are
// __fmaf_rn here; division by fs is a multiply by inv_fs.

#include <cooperative_groups.h>

#include <type_traits>

#include "cluster_launch.cuh"
#include "track_corr.cuh"

namespace {

namespace cg = cooperative_groups;
using gnss_track::kLut;
using clusterk::bulk_copy;
using clusterk::mbar_expect_tx;
using clusterk::mbar_init;
using clusterk::mbar_wait;

constexpr int kThreads = 256;         // the workers of a CTA
constexpr int kBlock = kThreads + 32;  // and one producer warp
// CTAs an SM must hold: two keep a 16-CTA cluster of every channel of the
// 8-channel shapes resident at once (one CTA an SM holds 7 such clusters)
constexpr int kMinBlocks = 2;
constexpr int kMaxCode = 10230;
constexpr int kMaxOverlay = 1024;
constexpr int kMaxCluster = 16;
constexpr int kTile = 128;            // samples a bulk copy (1 KiB)
constexpr int kFixedBytes = 32768;    // shared memory before the stages

// int32 state lanes (ops/track_fused.py I_*)
enum { I_PTR, I_BLOCK, I_COFF_P, I_COFF_DF, I_STALLED, I_CHUNKLEN, I_NFULL,
       I_SUBJ, NI };
// float32 lanes (F_*): loop state, ratio, the 12 sigp lanes, the 6 cacc
enum { F_CP_HI, F_CP_LO, F_CFO, F_CARR_P, F_CARR_F, F_P1RE, F_P1IM, F_CE1,
       F_DE1, F_RATIO, F_SIGP, F_CACC = F_SIGP + 12, NF = F_CACC + 6 };
// sigp lanes (track/engine.SIGP_*)
enum { S_CF_HI, S_CF_LO, S_EL, S_L, S_SPP, S_SUB, S_A0, S_A1, S_A6, S_COH,
       S_NOV, S_TM };

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kRadToDeg = 57.295779513082320876f;

struct Loop {
  float fs_inv;
  int fll_wide, fll_narrow;
  float fll_wide_k, fll_narrow_k, pll_k1, pll_k2, dll_k1, dll_k2;
};

// The staging plan (ops/track_fused.cluster_plan mirrors it): the window
// of nmax + 2 samples in `tiles` tiles of kTile, tile t on rank t % S, tpc
// tiles a CTA, in m batches of k tiles; each of the two stage buffers
// holds k tiles.
struct Plan {
  int S, tiles, tpc, k, m;
  int stage;       // samples a stage buffer (k * kTile)
  int smem;        // dynamic shared memory bytes a CTA
};

bool make_plan(int nmax, int S, Plan& p) {
  if (S < 1 || S > kMaxCluster || (S & (S - 1)) || nmax < 1) return false;
  p.S = S;
  p.tiles = (nmax + 2 + kTile - 1) / kTile;
  p.tpc = (p.tiles + S - 1) / S;
  const int kmax =
      (int)((clusterk::kMaxSmem - kFixedBytes) / (2 * kTile * sizeof(float2)));
  p.m = (p.tpc + kmax - 1) / kmax;
  p.k = (p.tpc + p.m - 1) / p.m;
  p.stage = p.k * kTile;
  p.smem = kFixedBytes + 2 * p.stage * (int)sizeof(float2);
  return true;
}

// A block's geometry as warp 0 hands it to the CTA.
struct Geo {
  gnss_track::Block g;
  int start;     // the window's start, clamped into x
  int ok;        // the chunk holds the block
  int nloop;     // samples to correlate, min(n, nmax)
  int next;      // the next block's window start (-1: none is staged)
  int waited;    // batches waited before this block
  int drain;     // not ok, but a window was staged for it: wait once
};

// Shared memory before the stage buffers.
struct Fixed {
  double part[2][kMaxCluster][6];   // the ranks' partial sums, by b & 1
  double red[kThreads / 32][6];     // the warps' sums
  unsigned long long full[2];       // the stage buffers' mbarriers
  Geo geo[2];                       // by b & 1
  float2 lut[kLut];
  float ovl[kMaxOverlay];
  int8_t chips[kMaxCode];
};
static_assert(sizeof(Fixed) <= kFixedBytes, "fixed shared memory too large");

struct Args {
  const float2* x;
  int nx;
  const int8_t* code;
  int code_stride;
  const int* s_i32;
  const float* s_f32;
  const float* ovl;
  int nov;
  const float2* lut;
  float* rows_f;
  int* rows_i;
  int* sti_out;
  float* stf_out;
  int C, B, coh, nmax;
  Plan pl;
  Loop lp;
};

// ---- two-float arithmetic (utils/twofloat.py), no contraction
struct TF { float hi, lo; };

__device__ __forceinline__ TF two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  const float e = (a - (s - bb)) + (b - bb);
  return {s, e};
}
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = a * 4097.0f;
  hi = c - (c - a);
  lo = a - hi;
}
__device__ __forceinline__ TF two_prod(float a, float b) {
  const float p = a * b;
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  const float e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
  return {p, e};
}
__device__ __forceinline__ TF tf_add(TF x, TF y) {
  TF s = two_sum(x.hi, y.hi);
  const float e = s.lo + x.lo + y.lo;
  return two_sum(s.hi, e);
}
__device__ __forceinline__ TF tf_add_f(TF x, float y) {
  TF s = two_sum(x.hi, y);
  return two_sum(s.hi, s.lo + x.lo);
}
__device__ __forceinline__ TF tf_mul_f(TF x, float y) {
  TF p = two_prod(x.hi, y);
  return two_sum(p.hi, p.lo + x.lo * y);
}
__device__ __forceinline__ TF tf_mod(TF x, float m, float& k) {
  const float v = x.hi + x.lo;
  k = floorf(v / m);
  TF r = tf_add_f(x, -k * m);
  const bool under = (r.hi + r.lo) < 0.0f;
  const bool over = (r.hi + r.lo) >= m;
  k = k - (under ? 1.0f : 0.0f) + (over ? 1.0f : 0.0f);
  return tf_add_f(r, (under ? m : 0.0f) - (over ? m : 0.0f));
}

// floor-mod by 1 (torch.remainder / jnp.mod).  fmodf(a, 1) exactly, zero's
// sign included: a - truncf(a) is exact (Sterbenz for |a| >= 1), and
// cheaper than fmodf in the serial section.
__device__ __forceinline__ float mod1(float a) {
  float m = copysignf(a - truncf(a), a);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}
// floor(frac * 2^32) for frac in [0, 1], saturating at 2^32 - 1
__device__ __forceinline__ uint32_t fixed_u32(float frac) {
  const float s = frac * 4294967296.0f;
  return (s >= 4294967296.0f) ? 0xFFFFFFFFu : (uint32_t)s;
}

// discriminators (ops/discriminators.py)
__device__ __forceinline__ float ref_atan(float re, float im) {
  const float safe = (re == 0.0f) ? 1.0f : re;
  const float t = atanf(im / safe);
  return (re == 0.0f) ? kHalfPi : t;
}
__device__ __forceinline__ float fll_atan(float re, float im, float re1,
                                          float im1) {
  float d = ref_atan(re, im) - ref_atan(re1, im1);
  if (d > kHalfPi) d = kPi - d;
  if (d < -kHalfPi) d = -kPi - d;
  return d;
}
__device__ __forceinline__ float pll_costas(float re, float im) {
  const float flip = (re > 0.0f) ? 1.0f : -1.0f;
  return atan2f(flip * im, flip * re);
}

// Issue batch q of this rank's share of the window that starts at `start`
// into stage buffer `buf` (every lane of one warp: lane 0 sets the
// expected bytes, then the lanes issue a tile each).  Copies stop at the
// even sample below nx: no block reads past chunk_len <= nx - nmax.
__device__ __forceinline__ void issue_batch(const Args& a, int rank, int q,
                                            int start, float2* buf,
                                            unsigned long long* bar,
                                            int lane) {
  const Plan& p = a.pl;
  const int w0 = start & ~1;
  const int nxe = a.nx & ~1;
  const int u0 = q * p.k, u1 = min(u0 + p.k, p.tpc);
  if (lane == 0) {
    uint32_t bytes = 0;
    for (int u = u0; u < u1; ++u) {
      const int ts = w0 + (rank + p.S * u) * kTile;
      if (rank + p.S * u >= p.tiles || ts >= nxe) break;
      bytes += (uint32_t)min(kTile, nxe - ts) * (uint32_t)sizeof(float2);
    }
    mbar_expect_tx(bar, bytes);
  }
  __syncwarp();
  for (int u = u0 + lane; u < u1; u += 32) {
    const int ts = w0 + (rank + p.S * u) * kTile;
    if (rank + p.S * u >= p.tiles || ts >= nxe) break;
    bulk_copy(buf + (u - u0) * kTile, a.x + ts,
              (uint32_t)min(kTile, nxe - ts) * (uint32_t)sizeof(float2), bar);
  }
}

template <int K, bool kSmemCode>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
track_fused_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fixed& fx = *reinterpret_cast<Fixed*>(smem);
  float2* stage = reinterpret_cast<float2*>(smem + kFixedBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const Plan& pl = a.pl;
  const int S = pl.S;
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool producer = warp == kThreads / 32;   // issues the bulk copies
  const bool writer = rank == 0 && tid == 0;
  const int* si = a.s_i32 + (size_t)c * NI;
  const float* sf = a.s_f32 + (size_t)c * NF;
  const float* sp = sf + F_SIGP;
  const int L = (int)sp[S_L];
  const float Lf = sp[S_L];
  const int8_t* row = a.code + (size_t)c * a.code_stride;
  const Loop& lp = a.lp;
  auto buffer = [&](int i) { return stage + (i & 1) * pl.stage; };
  auto full = [&](int i) { return &fx.full[i & 1]; };

  for (int i = tid; i < kLut; i += kBlock) fx.lut[i] = a.lut[i];
  if constexpr (kSmemCode) {
    for (int i = tid; i < L; i += kBlock) fx.chips[i] = row[i];
  }
  for (int i = tid; i < a.nov; i += kBlock)
    fx.ovl[i] = a.ovl[(size_t)c * a.nov + i];
  if (tid == 0) {
    mbar_init(&fx.full[0]);
    mbar_init(&fx.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  gnss_track::Coef coef{0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (K == gnss_track::SUB_AFFINE ||
                K == gnss_track::SUB_AFFINE_TMBOC)
    coef = gnss_track::Coef{sp[S_A0], sp[S_A1], sp[S_A6],
                            K == gnss_track::SUB_AFFINE_TMBOC ? sp[S_TM]
                                                              : 0.0f};

  // the loop state, meaningful in warp 0 (its lanes hold the same bits)
  int ptr = si[I_PTR], block = si[I_BLOCK], stalled = si[I_STALLED];
  const int chunk_len = si[I_CHUNKLEN];
  int n_full_s = si[I_NFULL], sub_j = si[I_SUBJ];
  uint32_t coff_p = (uint32_t)si[I_COFF_P];
  const uint32_t coff_df = (uint32_t)si[I_COFF_DF];
  float cp_hi = sf[F_CP_HI], cp_lo = sf[F_CP_LO], cfo = sf[F_CFO];
  float carr_p = sf[F_CARR_P], carr_f = sf[F_CARR_F];
  float p1re = sf[F_P1RE], p1im = sf[F_P1IM];
  float ce1 = sf[F_CE1], de1 = sf[F_DE1];
  float cacc[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) cacc[j] = sf[F_CACC + j];
  const float ratio = sf[F_RATIO];
  const float cf_hi = sp[S_CF_HI], cf_lo = sp[S_CF_LO], el = sp[S_EL];
  const float spp = sp[S_SPP];
  const int sub = (int)sp[S_SUB];
  // coherent span M and the overlay period (0 in the lane: the table's)
  const int M = max((int)sp[S_COH], 1);
  const int nov_c = ((int)sp[S_NOV] > 0) ? (int)sp[S_NOV] : a.nov;
  // the block's geometry, carried from the geometry to the loop filter
  int n = 0, n_full = 0, sub_j_next = 0;
  bool ok = false;
  float cf_dyn = 0.0f;
  gnss_track::Block g{};
  // batches waited before this block; whether one was issued for it
  int n_waited = 0;
  bool pending = false;

  auto geometry = [&]() {
    // adaptive block length targeting the next code boundary
    const float code_p = cp_hi + cp_lo;
    const float n_f0 = (code_p < Lf / 2.0f) ? spp * (Lf - code_p) / Lf
                                            : spp * (2.0f * Lf - code_p) / Lf;
    n_full = (sub_j == 0) ? (int)n_f0 : n_full_s;
    const int q = n_full / sub;
    const int r = n_full - q * sub;
    n = q + ((sub_j + 1) * r) / sub - (sub_j * r) / sub;
    sub_j_next = (sub_j + 1 == sub) ? 0 : sub_j + 1;
    ok = (stalled == 0) && (ptr + n <= chunk_len);

    cf_dyn = (cfo + carr_f / ratio) * lp.fs_inv;
    g.cf = cf_hi + cf_dyn;
    const float lags[3] = {-el, 0.0f, el};
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const TF v = tf_add_f({cp_hi, cp_lo}, lags[l]);
      const float vint = floorf(v.hi + v.lo);
      const TF f = tf_add_f(v, -vint);
      g.vint[l] = (int)vint;
      g.fr[l] = f.hi + f.lo;
    }
    g.coff_p = coff_p;
    g.coff_df = coff_df;
    g.carr_df = fixed_u32(mod1(-carr_f * lp.fs_inv));  // freq_to_fixed bits
    g.carr_p = fixed_u32(mod1(carr_p));
    g.cmp = gnss_track::compare_wrap_ok(g, min(n, a.nmax), L);
  };
  // the window start of a block at pointer p, clamped into x
  auto window = [&](int p) { return max(0, min(p, a.nx - a.nmax)); };
  // block b's geometry for the CTA (warp 0, after geometry())
  auto publish = [&](int b) {
    if (lane == 0) {
      Geo& G = fx.geo[b & 1];
      G.g = g;
      G.start = window(ptr);
      G.ok = ok ? 1 : 0;
      G.nloop = min(n, a.nmax);
      G.next = (ok && b + 1 < a.B) ? window(ptr + n) : -1;
      G.waited = n_waited;
      G.drain = (!ok && pending) ? 1 : 0;
    }
  };

  if (warp == 0) {
    geometry();
    pending = ok;
    publish(0);
  }
  // every CTA of the cluster runs (distributed shared memory may be
  // written), the mbarriers are initialised and block 0's geometry is out
  clusterk::cluster_arrive();
  clusterk::cluster_wait();
  if (producer && fx.geo[0].ok)
    issue_batch(a, rank, 0, fx.geo[0].start, buffer(0), full(0), lane);

  for (int b = 0; b < a.B; ++b) {
    // warp 0 rewrites geo[b & 1] for block b + 2, after every thread has
    // passed this block's closing __syncthreads
    const Geo& G = fx.geo[b & 1];
    float w[6];
    if (G.ok) {
      const gnss_track::Block gb = G.g;
      const int start = G.start, next = G.next, waited = G.waited;
      const int nloop = G.nloop;
      const int off = start & 1;
      // this rank's tiles among those that hold samples below nloop
      const int need = (nloop + off + kTile - 1) / kTile;
      const int mine = need > rank ? (need - rank + S - 1) / S : 0;
      double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int q = 0; q < pl.m; ++q) {
        // stage the batch after this one (this block's next, or the next
        // block's first) into the buffer batch q - 1 has left
        const int i = waited + q;
        if (producer) {
          if (q + 1 < pl.m)
            issue_batch(a, rank, q + 1, start, buffer(i + 1), full(i + 1),
                        lane);
          else if (next >= 0)
            issue_batch(a, rank, 0, next, buffer(i + 1), full(i + 1), lane);
        } else {
          mbar_wait(full(i), (uint32_t)((i >> 1) & 1));
        }
        const float2* buf = buffer(i);
        const int e0 = producer ? pl.stage : tid;   // workers only
        const int e1 = min(pl.stage, max(0, (mine - q * pl.k) * kTile));
        auto correlate = [&](auto cmp) {
#pragma unroll 2
          for (int e = e0; e < e1; e += kThreads) {
            const int t = rank + S * (q * pl.k + e / kTile);
            const int s = t * kTile + (e & (kTile - 1)) - off;
            if (s >= 0 && s < nloop)
              gnss_track::epl_sample<K, decltype(cmp)::value>(
                  buf[e], s, fx.lut, gb, L, coef,
                  [&](int k) {
                    if constexpr (kSmemCode) return (int)fx.chips[k];
                    else return (int)__ldg(row + k);
                  },
                  acc);
          }
        };
        if (gb.cmp) correlate(std::true_type{});
        else correlate(std::false_type{});
        if (q + 1 < pl.m) __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[j] = gnss_track::warp_sum(acc[j]);
      if (lane == 0 && !producer) {
#pragma unroll
        for (int j = 0; j < 6; ++j) fx.red[warp][j] = acc[j];
      }
      __syncthreads();
      if (tid < 6 * S) {
        const int j = tid % 6;
        double v = 0.0;
        for (int k = 0; k < kThreads / 32; ++k) v += fx.red[k][j];
        *cluster.map_shared_rank(&fx.part[b & 1][rank][j], tid / 6) = v;
      }
      clusterk::cluster_arrive();
      clusterk::cluster_wait();
      if (warp == 0) {
        double v = 0.0;
        if (lane < 6)
          for (int r = 0; r < S; ++r) v += fx.part[b & 1][r][lane];
#pragma unroll
        for (int j = 0; j < 6; ++j) w[j] = (float)__shfl_sync(~0u, v, j);
      }
    } else if (G.drain) {
      // the chunk ran dry: drain the window issued for this block
      mbar_wait(full(G.waited), (uint32_t)((G.waited >> 1) & 1));
    }

    if (warp == 0) {
      n_waited += ok ? pl.m : (pending ? 1 : 0);
      pending = ok && b + 1 < a.B;
      // the loop filter and bookkeeping (_post_block); f: what the
      // filters see (the M-period sums when coherent), w the block's
      // correlators (overlay-wiped when coherent)
      float* rf = a.rows_f + ((size_t)b * a.C + c) * 11;
      int* ri = a.rows_i + ((size_t)b * a.C + c) * 3;
      if (!ok) {
        if (writer) {
          for (int j = 0; j < 11; ++j) rf[j] = __int_as_float(0x7fc00000);
          ri[0] = ri[1] = ri[2] = 0;
        }
        stalled = 1;
      } else {
        float f[6];
        bool u = true;
        if (a.coh) {
          const float s_ovl = fx.ovl[block % nov_c];
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            w[j] = s_ovl * w[j];
            f[j] = cacc[j] + w[j];
          }
          u = ((block + 1) % M) == 0;
        } else {
#pragma unroll
          for (int j = 0; j < 6; ++j) f[j] = w[j];
        }
        // carrier phase bookkeeping; dcyc counts whole cycles
        const float n_f = (float)n;
        const float carr_p_new =
            __fmaf_rn(-(n_f * carr_f), lp.fs_inv, carr_p);
        const float t = mod1(carr_p_new);
        const uint32_t coff_p_new = coff_p + (uint32_t)n * coff_df;

        // carrier loop; prompt1 only refreshed in FLL modes; each mode
        // computes only its own discriminator
        int mode = (block >= lp.fll_wide) ? 1 : 0;
        if (block >= lp.fll_wide + lp.fll_narrow) mode = 2;
        float carr_f_new, ce1_new, p1re_new, p1im_new;
        if (mode == 2) {
          const float e_pll = pll_costas(f[2], f[3]);
          carr_f_new = __fmaf_rn(lp.pll_k2, e_pll - ce1,
                                 __fmaf_rn(lp.pll_k1, e_pll, carr_f));
          ce1_new = e_pll;
          p1re_new = p1re;
          p1im_new = p1im;
        } else {
          const float e_fll = fll_atan(f[2], f[3], p1re, p1im);
          const float fll_k = (mode == 0) ? lp.fll_wide_k : lp.fll_narrow_k;
          carr_f_new = __fmaf_rn(fll_k, e_fll, carr_f);
          ce1_new = ce1;
          p1re_new = f[2];
          p1im_new = f[3];
        }

        // code loop: normalized-envelope EML DLL on the filters' sums
        const float early = sqrtf(w[0] * w[0] + w[1] * w[1]);
        const float late = sqrtf(w[4] * w[4] + w[5] * w[5]);
        const float f_e = a.coh ? sqrtf(f[0] * f[0] + f[1] * f[1]) : early;
        const float f_l = a.coh ? sqrtf(f[4] * f[4] + f[5] * f[5]) : late;
        const float denom = f_l + f_e;
        float e_dll = (denom == 0.0f) ? 0.0f : (f_l - f_e) / denom;
        float cfo_new = __fmaf_rn(lp.dll_k2, e_dll - de1,
                                  __fmaf_rn(lp.dll_k1, e_dll, cfo));
        if (!u) {
          // coherent: the filters advance only at the M-period boundary
          carr_f_new = carr_f;
          ce1_new = ce1;
          p1re_new = p1re;
          p1im_new = p1im;
          cfo_new = cfo;
          e_dll = de1;
        }

        // code phase advance in two-float
        TF adv = tf_mul_f({cf_hi, cf_lo}, n_f);
        adv = tf_add_f(adv, n_f * cf_dyn);
        const TF cp_new = tf_add({cp_hi, cp_lo}, adv);
        float wraps;
        const TF cpm = tf_mod(cp_new, Lf, wraps);

        if (writer) {
          rf[0] = (float)block;
          rf[1] = w[2];
          rf[2] = w[3];
          rf[3] = carr_f_new;
          rf[4] = cfo_new;
          rf[5] = kRadToDeg * atan2f(w[3], w[2]);
          rf[6] = early;
          rf[7] = sqrtf(w[2] * w[2] + w[3] * w[3]);
          rf[8] = late;
          rf[9] = cpm.hi + cpm.lo;
          rf[10] = t;
          ri[0] = n;
          ri[1] = (int)rintf(carr_p_new - t);
          ri[2] = (int)(wraps * Lf);
        }

        ptr += n;
        cp_hi = cpm.hi;
        cp_lo = cpm.lo;
        cfo = cfo_new;
        carr_p = t;
        carr_f = carr_f_new;
        coff_p = coff_p_new;
        p1re = p1re_new;
        p1im = p1im_new;
        ce1 = ce1_new;
        de1 = e_dll;
        if (a.coh) {
#pragma unroll
          for (int j = 0; j < 6; ++j) cacc[j] = u ? 0.0f : f[j];
        }
        block += 1;
        n_full_s = n_full;
        sub_j = sub_j_next;
        stalled = 0;
      }
      if (b + 1 < a.B) {
        geometry();
        publish(b + 1);
      }
    }
    __syncthreads();
  }

  if (writer) {
    int* so = a.sti_out + (size_t)c * NI;
    float* fo = a.stf_out + (size_t)c * NF;
    so[I_PTR] = ptr;
    so[I_BLOCK] = block;
    so[I_COFF_P] = (int)coff_p;
    so[I_COFF_DF] = (int)coff_df;
    so[I_STALLED] = stalled;
    so[I_CHUNKLEN] = chunk_len;
    so[I_NFULL] = n_full_s;
    so[I_SUBJ] = sub_j;
    fo[F_CP_HI] = cp_hi;
    fo[F_CP_LO] = cp_lo;
    fo[F_CFO] = cfo;
    fo[F_CARR_P] = carr_p;
    fo[F_CARR_F] = carr_f;
    fo[F_P1RE] = p1re;
    fo[F_P1IM] = p1im;
    fo[F_CE1] = ce1;
    fo[F_DE1] = de1;
    for (int j = F_RATIO; j < F_CACC; ++j) fo[j] = sf[j];
#pragma unroll
    for (int j = 0; j < 6; ++j) fo[F_CACC + j] = cacc[j];
  }
}

using Kernel = void (*)(Args);

Kernel kernel_of(int kind, bool smem_code) {
  using namespace gnss_track;
  switch (kind) {
    case 0:
      return smem_code ? track_fused_kernel<SUB_BPSK, true>
                       : track_fused_kernel<SUB_BPSK, false>;
    case 1:
      return smem_code ? track_fused_kernel<SUB_AFFINE, true>
                       : track_fused_kernel<SUB_AFFINE, false>;
    default:
      return smem_code ? track_fused_kernel<SUB_AFFINE_TMBOC, true>
                       : track_fused_kernel<SUB_AFFINE_TMBOC, false>;
  }
}

}  // namespace

// x: complex64 [nx], 16-byte aligned; code: int8 [C, code_stride]
// (code_stride = L, every channel's code length); s_i32/s_f32: packed
// state [C, 8] / [C, 28]; ovl: float32 [C, nov] overlay chips (read when
// coh != 0); lut: f32 [1024, 2]; kind: K3's subcarrier kind, 0 "none", 1
// "subc", 2 "tmboc"; nmax: the longest block (params.nmax; nx >= nmax);
// cluster: the CTAs a channel (cluster_plan's S); outputs rows_f [B,
// C, 11], rows_i [B, C, 3], sti_out [C, 8], stf_out [C, 28].  Returns the
// cudaError_t of the launch (0 = launched); a cluster the card cannot
// hold is refused, never run on fewer CTAs.
extern "C" int track_fused(const void* x, int nx, const void* code,
                           int code_stride, const void* s_i32,
                           const void* s_f32, const void* ovl, int nov,
                           const void* lut, void* rows_f, void* rows_i,
                           void* sti_out, void* stf_out, int C, int B,
                           int kind, int coh, float fs_inv, int fll_wide,
                           int fll_narrow, float fll_wide_k,
                           float fll_narrow_k, float pll_k1, float pll_k2,
                           float dll_k1, float dll_k2, int nmax, int cluster,
                           void* stream) {
  Plan pl;
  if (C < 1 || B < 0 || code_stride < 1 || nov < 1 || nov > kMaxOverlay ||
      kind < 0 || kind > 2 || !make_plan(nmax, cluster, pl) ||
      nx < nmax || (long long)C * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args args{(const float2*)x, nx, (const int8_t*)code, code_stride,
                  (const int*)s_i32, (const float*)s_f32, (const float*)ovl,
                  nov, (const float2*)lut, (float*)rows_f, (int*)rows_i,
                  (int*)sti_out, (float*)stf_out, C, B, coh, nmax, pl,
                  Loop{fs_inv, fll_wide, fll_narrow, fll_wide_k, fll_narrow_k,
                       pll_k1, pll_k2, dll_k1, dll_k2}};
  return (int)clusterk::launch_cluster(
      kernel_of(kind, code_stride <= kMaxCode), C * cluster, kBlock,
      cluster, (size_t)pl.smem, (cudaStream_t)stream, args);
}

// K2's launch plan for nmax on `cluster` CTAs: info[0] S, [1] tiles, [2]
// tiles a CTA, [3] tiles a batch, [4] batches, [5] dynamic shared memory
// bytes a CTA, [6] registers a thread, [7] local (spilled) bytes a thread,
// [8] clusters the card holds at once, [9] threads a CTA.
extern "C" int track_fused_info(int nmax, int cluster, int kind,
                                int smem_code, void* info) {
  Plan pl;
  if (kind < 0 || kind > 2 || !make_plan(nmax, cluster, pl))
    return (int)cudaErrorInvalidValue;
  int ci[6];
  const cudaError_t e = clusterk::cluster_info(
      kernel_of(kind, smem_code != 0), kBlock, cluster, (size_t)pl.smem,
      ci);
  if (e != cudaSuccess) return (int)e;
  int* o = (int*)info;
  o[0] = pl.S;
  o[1] = pl.tiles;
  o[2] = pl.tpc;
  o[3] = pl.k;
  o[4] = pl.m;
  o[5] = pl.smem;
  o[6] = ci[2];
  o[7] = ci[3];
  o[8] = ci[4];
  o[9] = kBlock;
  return 0;
}
