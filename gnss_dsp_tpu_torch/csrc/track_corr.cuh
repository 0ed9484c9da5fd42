// The per-sample early/prompt/late body shared by the tracking kernels:
// K2 (track_fused.cu) and K3/K4 (track_step.cu), every subcarrier.
//
// For sample i of a block: the fused double-LUT carrier wipe, then for
// each of the three lags its chip index (vint + floor(fma(i, cf, fr)))
// floor-mod L, the chip, the subcarrier factor, and the products with the
// wiped sample added to six float64 sums.  The floor-mod is two or three
// compares where the block's geometry keeps every index in [-L, 3L)
// (Block::cmp, set once a block by compare_wrap_ok), and an integer % by
// L only where it does not.  The chips are +-1 and the factors float32,
// so each product is exact in float64 and the rounded sum does not depend
// on the order of summation (up to a double-rounding tie).
//
// Rounding is pinned to match the plain versions: build with --fmad=false;
// the chip-phase recurrence is __fmaf_rn, rounded once, as the reference's
// XLA program contracts it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gnss_track {

constexpr int kLut = 1024;

// Subcarrier factor, a template parameter of the body.  The K3 kinds read
// runtime coefficients (gnss_dsp_tpu/ops/pallas_track2.py:81-104), the K4
// families are compile-time constants (gnss_dsp_tpu/ops/pallas_track.py:93-112).
enum Sub {
  SUB_BPSK,          // no factor (K2, K3 "none", K4 "none")
  SUB_AFFINE,        // K3 "subc": a0 + a1 boc + a6 boc6
  SUB_AFFINE_TMBOC,  // K3 "tmboc": affine + tm (slot boc6 + (1 - slot) boc)
  SUB_BOC11,         // K4 families
  SUB_CBOC,
  SUB_TMBOC,
  SUB_RZ_EVEN,
  SUB_RZ_ODD,
};

struct Coef { float a0, a1, a6, tm; };

// CBOC weights sqrt(10/11), sqrt(1/11) as float32 (Galileo E1 ICD)
constexpr float kCbocW1 = 0.953463f;
constexpr float kCbocW6 = 0.301511f;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// cp: the lag's fractional code phase fma(i, cf, fr); chip: its absolute
// chip index vint + floor(cp) before the wrap (the TMBOC slot is taken
// from it, as the reference does).  floor(2 cp) and floor(12 cp) decide
// the square waves: 2 vint and 12 vint are even.
template <int K>
__device__ __forceinline__ float sub_factor(float cp, int chip, const Coef& k) {
  const int bp = floor_mod((int)floorf(2.0f * cp), 2);
  const float boc = (float)(1 - 2 * bp);
  if constexpr (K == SUB_BOC11) return boc;
  if constexpr (K == SUB_RZ_EVEN) return (float)(1 - bp);
  if constexpr (K == SUB_RZ_ODD) return (float)bp;
  const int bp6 = floor_mod((int)floorf(12.0f * cp), 2);
  const float boc6 = (float)(1 - 2 * bp6);
  if constexpr (K == SUB_CBOC) return kCbocW1 * boc + kCbocW6 * boc6;
  const float affine = k.a0 + k.a1 * boc + k.a6 * boc6;
  if constexpr (K == SUB_AFFINE) return affine;
  const int u = floor_mod(chip, 33);
  const float slot = (u == 0 || u == 4 || u == 6 || u == 29) ? 1.0f : 0.0f;
  const float tmboc = slot * boc6 + (1.0f - slot) * boc;
  if constexpr (K == SUB_TMBOC) return tmboc;
  return affine + k.tm * tmboc;
}

// The geometry of one block, as the engine's _geometry lays it out.
struct Block {
  uint32_t coff_p, coff_df;   // carrier-offset DDS phase and increment
  uint32_t carr_p, carr_df;   // carrier NCO phase and increment
  float cf;                   // chips per sample
  int vint[3];                // E, P, L integer chip
  float fr[3];                // E, P, L fractional chip
  bool cmp;                   // every chip index in [-L, 3L) (compare_wrap_ok)
};

// Whether every chip index vint[l] + floor(fma(i, cf, fr[l])) of the
// samples 0 <= i < n lies in [-L, 3L).  The rounded fma is monotone in i,
// so the two ends bound it.  The tracking geometry keeps vint in [-1, L]
// and fr in [0, 1]; a block of nmax samples spans nmax cf < 2L - 2 chips
// for every catalog signal (tests/test_torch_track_fused_plan.py), so this
// holds but for a state far outside the code.
__device__ __forceinline__ bool compare_wrap_ok(const Block& g, int n, int L) {
  if (n <= 0) return true;
  const float last = (float)(n - 1);
  bool ok = true;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const long long a = (long long)g.vint[l] + (long long)floorf(g.fr[l]);
    const long long z = (long long)g.vint[l] +
                        (long long)floorf(__fmaf_rn(last, g.cf, g.fr[l]));
    ok = ok && a >= -(long long)L && z >= -(long long)L &&
         a < 3LL * L && z < 3LL * L;
  }
  return ok;
}

// chip index c floor-mod L: by compares where c is in [-L, 3L) (kCmp, a
// template parameter so that the loop holds no integer division)
template <bool kCmp>
__device__ __forceinline__ int wrap_chip(int c, int L) {
  if constexpr (!kCmp) return floor_mod(c, L);
  if (c < 0) c += L;
  if (c >= L) c -= L;
  if (c >= L) c -= L;
  return c;
}

// Adds sample i of the block, s, to acc[6] = E re, E im, P re, P im, L re,
// L im.  chip_at(k) reads chip k of the channel's code (0 <= k < L) as an
// int in {-1, 0, 1}: its sign is applied to the exact float64 product of
// the wiped sample and the lag's factor, which is the product with the
// chip-times-factor float the plain version forms, bit for bit, without
// the int-to-float and float-to-double conversions a lag (the SM's
// conversion rate, 16 a clock, set the pace of the sample loop).  kCmp is
// the block's Block::cmp.
template <int K, bool kCmp, class ChipAt>
__device__ __forceinline__ void epl_sample(float2 s, int i, const float2* lut,
                                           const Block& g, int L,
                                           const Coef& coef, ChipAt chip_at,
                                           double acc[6]) {
  const uint32_t ui = (uint32_t)i;
  const uint32_t ph1 = g.coff_p + ui * g.coff_df;
  const uint32_t ph2 = g.carr_p + ui * g.carr_df;
  const float2 w = lut[((ph1 >> 22) + (ph2 >> 22)) & (kLut - 1)];
  const double m_re = (double)(s.x * w.x - s.y * w.y);
  const double m_im = (double)(s.x * w.y + s.y * w.x);
  const float fi = (float)i;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const float cp = __fmaf_rn(fi, g.cf, g.fr[l]);
    const int chip = g.vint[l] + (int)floorf(cp);
    // floor-mod: the early lag at phase ~0 gives -1 -> L-1
    const int v = chip_at(wrap_chip<kCmp>(chip, L));
    double p_re = m_re, p_im = m_im;
    if constexpr (K != SUB_BPSK) {
      const double f = (double)sub_factor<K>(cp, chip, coef);
      p_re = m_re * f;
      p_im = m_im * f;
    }
    acc[2 * l] += v == 0 ? 0.0 : (v < 0 ? -p_re : p_re);
    acc[2 * l + 1] += v == 0 ? 0.0 : (v < 0 ? -p_im : p_im);
  }
}

// Adds samples i = begin, begin + stride, ... < end of the block at xb.
template <int K, bool kCmp, class ChipAt>
__device__ __forceinline__ void epl_samples(const float2* __restrict__ xb,
                                            const float2* lut, const Block& g,
                                            int L, const Coef& coef,
                                            ChipAt chip_at, int begin, int end,
                                            int stride, double acc[6]) {
  for (int i = begin; i < end; i += stride)
    epl_sample<K, kCmp>(xb[i], i, lut, g, L, coef, chip_at, acc);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace gnss_track
