// The per-sample early/prompt/late body shared by the tracking kernels:
// K2 (track_fused.cu, BPSK) and K3/K4 (track_step.cu, every subcarrier).
//
// For sample i of a block: the fused double-LUT carrier wipe, then for
// each of the three lags its chip index (vint + floor(fma(i, cf, fr)))
// floor-mod L, the chip, the subcarrier factor, and the products with the
// wiped sample added to six float64 sums.  The chips are +-1 and the
// factors float32, so each product is exact in float64 and the rounded sum
// does not depend on the order of summation (up to a double-rounding tie).
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
};

// Adds samples i = begin, begin + stride, ... < end of the block at xb to
// acc[6] = E re, E im, P re, P im, L re, L im.  chip_at(k) reads chip k of
// the channel's code (0 <= k < L).
template <int K, class ChipAt>
__device__ __forceinline__ void epl_samples(const float2* __restrict__ xb,
                                            const float2* lut, const Block& g,
                                            int L, const Coef& coef,
                                            ChipAt chip_at, int begin, int end,
                                            int stride, double acc[6]) {
  for (int i = begin; i < end; i += stride) {
    const uint32_t ui = (uint32_t)i;
    const uint32_t ph1 = g.coff_p + ui * g.coff_df;
    const uint32_t ph2 = g.carr_p + ui * g.carr_df;
    const float2 w = lut[((ph1 >> 22) + (ph2 >> 22)) & (kLut - 1)];
    const float2 s = xb[i];
    const double m_re = (double)(s.x * w.x - s.y * w.y);
    const double m_im = (double)(s.x * w.y + s.y * w.x);
    const float fi = (float)i;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const float cp = __fmaf_rn(fi, g.cf, g.fr[l]);
      const int chip = g.vint[l] + (int)floorf(cp);
      // floor-mod: the early lag at phase ~0 gives -1 -> L-1
      float c = chip_at(floor_mod(chip, L));
      if constexpr (K != SUB_BPSK) c = c * sub_factor<K>(cp, chip, coef);
      const double cd = (double)c;
      acc[2 * l] += m_re * cd;
      acc[2 * l + 1] += m_im * cd;
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace gnss_track
