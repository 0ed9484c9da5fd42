// The whole tracking loop for one chunk in one launch (kernel K2).
//
// Replaces the TPU kernel
// gnss_dsp_tpu/ops/pallas_track_fused.py::track_scan_fused (pallas_call at
// :616, body _kernel :118), including the early/prompt/late math it takes
// from ops/pallas_track2.py (tile_contrib :107, finalize_contrib :278).
//
// One CTA of 256 threads per channel loops over the B blocks: the loop
// filter closes over each block's correlators, so blocks are sequential and
// the parallelism is the channel count.  Per block:
//   1. thread 0 computes the geometry: the adaptive block length n (the
//      sub-block's share of the code period, the q/r split of
//      track/engine._sub_block_len), whether the chunk still holds the
//      block (ok), the integer and fractional code phase of the three
//      lags, and the two DDS phases/increments (track/engine.py
//      _geometry);
//   2. every thread strides over the samples i < n: the fused double-LUT
//      carrier wipe, three chip reads, the subcarrier factor of K3's
//      runtime kind (template K: "none", "subc" = a0 + a1 boc + a6 boc6,
//      "tmboc" adds tm times the TMBOC blend at the absolute chip index),
//      and six partial sums (float64: each product of a float32 sample and
//      a float32 factor is exact); this body is track_corr.cuh's
//      epl_samples, shared with K3 and K4;
//   3. warp shuffles and shared memory reduce the sums;
//   4. thread 0 runs the loop filter and bookkeeping (_post_block), writes
//      the block's rows and keeps the state in registers.  With coh set
//      (extended-coherent tracking, M = the sigp COH lane), it first wipes
//      the block's E/P/L by the channel's overlay chip
//      overlay[c, block % nov_c], adds them into the six cacc sums, lets
//      the filters see the sums and advance only where (block + 1) % M ==
//      0, and resets cacc there; the row keeps the block's wiped values.
// Codes of <= kMaxCode chips are copied to shared memory once (template
// kSmemCode); longer ones (GPS L2CL 767,250 chips, GLONASS P 5,110,000)
// are read with __ldg straight from the int8 [C, L] table in device
// memory: a block's three lags touch a window of about n cf + 2 chips
// (~1,000 for L2CL's 1 ms sub-block, ~5,100 for GLONASS P), neighbouring
// threads read the same or the next chip, and the window stays in L1/L2,
// so a copy into shared memory would add a barrier a block and save
// little.  This is the port's form of the TPU kernel's streamed code
// window (:264-304).  The overlay rows (<= kMaxOverlay chips) are staged
// in shared memory.
// None of the TPU machinery carries over: no one-hot MXU routing, no
// 128-lane packing, no scalar prefetch, no window DMA, no tile padding.
//
// What bounds it on the card: latency of the per-block chain (three
// barriers and the scalar loop filter), not bandwidth: each block reads n
// samples once.  State lives in registers and shared memory across blocks,
// so there is no launch per block.
//
// Rounding is pinned down to match the plain version (ops/track_fused.py):
// built with --fmad=false; the multiply-adds the reference rounds once are
// __fmaf_rn here; division by fs is a multiply by inv_fs.

#include "track_corr.cuh"

namespace {

using gnss_track::kLut;

constexpr int kThreads = 256;
constexpr int kMaxCode = 10230;
constexpr int kMaxOverlay = 1024;

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

// floor-mod by 1 (torch.remainder / jnp.mod)
__device__ __forceinline__ float mod1(float a) {
  float m = fmodf(a, 1.0f);
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

template <int K, bool kSmemCode>
__global__ void __launch_bounds__(kThreads)
track_fused_kernel(const float2* __restrict__ x,
                   const int8_t* __restrict__ code, int code_stride,
                   const int* __restrict__ s_i32,
                   const float* __restrict__ s_f32,
                   const float* __restrict__ ovl_g, int nov,
                   const float2* __restrict__ lut_g,
                   float* __restrict__ rows_f, int* __restrict__ rows_i,
                   int* __restrict__ sti_out, float* __restrict__ stf_out,
                   int C, int B, int coh, Loop lp) {
  __shared__ float2 lut[kLut];
  __shared__ int8_t chips[kSmemCode ? kMaxCode : 1];
  __shared__ float ovl[kMaxOverlay];
  __shared__ double red[kThreads / 32][6];
  // block geometry, broadcast from thread 0
  __shared__ int g_n, g_ok, g_ptr;
  __shared__ int g_vint[3];
  __shared__ float g_fr[3];
  __shared__ float g_cf;
  __shared__ uint32_t g_coff_p, g_coff_df, g_carr_p0, g_carr_df;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int* si = s_i32 + (size_t)c * NI;
  const float* sf = s_f32 + (size_t)c * NF;
  const float* sp = sf + F_SIGP;
  const int L = (int)sp[S_L];
  const float Lf = sp[S_L];
  const int8_t* row = code + (size_t)c * code_stride;

  for (int i = tid; i < kLut; i += blockDim.x) lut[i] = lut_g[i];
  if constexpr (kSmemCode) {
    for (int i = tid; i < L; i += blockDim.x) chips[i] = row[i];
  }
  for (int i = tid; i < nov; i += blockDim.x)
    ovl[i] = ovl_g[(size_t)c * nov + i];
  gnss_track::Coef coef{0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (K == gnss_track::SUB_AFFINE ||
                K == gnss_track::SUB_AFFINE_TMBOC)
    coef = gnss_track::Coef{sp[S_A0], sp[S_A1], sp[S_A6],
                            K == gnss_track::SUB_AFFINE_TMBOC ? sp[S_TM]
                                                              : 0.0f};

  // loop state (meaningful in thread 0)
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
  const int nov_c = ((int)sp[S_NOV] > 0) ? (int)sp[S_NOV] : nov;
  // per-block values carried from the geometry to the loop filter
  int n = 0, n_full = 0, sub_j_next = 0;
  bool ok = false;
  float cf_dyn = 0.0f;

  for (int b = 0; b < B; ++b) {
    if (tid == 0) {
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
      const float cf = cf_hi + cf_dyn;
      const float lags[3] = {-el, 0.0f, el};
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const TF v = tf_add_f({cp_hi, cp_lo}, lags[l]);
        const float vint = floorf(v.hi + v.lo);
        const TF f = tf_add_f(v, -vint);
        g_vint[l] = (int)vint;
        g_fr[l] = f.hi + f.lo;
      }
      g_cf = cf;
      g_n = n;
      g_ok = ok ? 1 : 0;
      g_ptr = ptr;
      g_coff_p = coff_p;
      g_coff_df = coff_df;
      const uint32_t df = fixed_u32(mod1(-carr_f * lp.fs_inv));
      g_carr_df = df;   // int32 bits of freq_to_fixed
      g_carr_p0 = fixed_u32(mod1(carr_p));
    }
    __syncthreads();

    double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (g_ok) {
      const gnss_track::Block g{g_coff_p, g_coff_df, g_carr_p0, g_carr_df,
                                g_cf, {g_vint[0], g_vint[1], g_vint[2]},
                                {g_fr[0], g_fr[1], g_fr[2]}};
      gnss_track::epl_samples<K>(
          x + g_ptr, lut, g, L, coef,
          [&](int k) {
            if constexpr (kSmemCode) return (float)chips[k];
            else return (float)__ldg(row + k);
          },
          tid, g_n, blockDim.x, acc);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j] = gnss_track::warp_sum(acc[j]);
    if ((tid & 31) == 0) {
#pragma unroll
      for (int j = 0; j < 6; ++j) red[tid >> 5][j] = acc[j];
    }
    __syncthreads();

    if (tid == 0) {
      // w: the block's correlators (overlay-wiped when coherent); f: what
      // the loop filters see (the M-period sums when coherent)
      float w[6], f[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        double s = 0.0;
        for (int k = 0; k < kThreads / 32; ++k) s += red[k][j];
        w[j] = (float)s;
      }
      bool u = true;
      if (coh) {
        const float s_ovl = ovl[block % nov_c];
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
      float* rf = rows_f + ((size_t)b * C + c) * 11;
      int* ri = rows_i + ((size_t)b * C + c) * 3;
      if (!ok) {
        for (int j = 0; j < 11; ++j) rf[j] = __int_as_float(0x7fc00000);
        ri[0] = ri[1] = ri[2] = 0;
        stalled = 1;
      } else {
        // carrier phase bookkeeping; dcyc counts whole cycles
        const float n_f = (float)n;
        const float carr_p_new = __fmaf_rn(-(n_f * carr_f), lp.fs_inv, carr_p);
        const float t = mod1(carr_p_new);
        const int carrier_dcyc = (int)rintf(carr_p_new - t);
        const uint32_t coff_p_new = coff_p + (uint32_t)n * coff_df;

        // carrier loop; prompt1 only refreshed in FLL modes
        int mode = (block >= lp.fll_wide) ? 1 : 0;
        if (block >= lp.fll_wide + lp.fll_narrow) mode = 2;
        const float e_fll = fll_atan(f[2], f[3], p1re, p1im);
        const float e_pll = pll_costas(f[2], f[3]);
        const float fll_k = (mode == 0) ? lp.fll_wide_k : lp.fll_narrow_k;
        float carr_f_new, ce1_new, p1re_new, p1im_new;
        if (mode == 2) {
          carr_f_new = __fmaf_rn(lp.pll_k2, e_pll - ce1,
                                 __fmaf_rn(lp.pll_k1, e_pll, carr_f));
          ce1_new = e_pll;
          p1re_new = p1re;
          p1im_new = p1im;
        } else {
          carr_f_new = __fmaf_rn(fll_k, e_fll, carr_f);
          ce1_new = ce1;
          p1re_new = f[2];
          p1im_new = f[3];
        }

        // code loop: normalized-envelope EML DLL on the filters' sums
        const float early = sqrtf(w[0] * w[0] + w[1] * w[1]);
        const float prompt = sqrtf(w[2] * w[2] + w[3] * w[3]);
        const float late = sqrtf(w[4] * w[4] + w[5] * w[5]);
        const float f_e = coh ? sqrtf(f[0] * f[0] + f[1] * f[1]) : early;
        const float f_l = coh ? sqrtf(f[4] * f[4] + f[5] * f[5]) : late;
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
        const float tc = cpm.hi + cpm.lo;
        const int code_dcyc = (int)(wraps * Lf);

        rf[0] = (float)block;
        rf[1] = w[2];
        rf[2] = w[3];
        rf[3] = carr_f_new;
        rf[4] = cfo_new;
        rf[5] = kRadToDeg * atan2f(w[3], w[2]);
        rf[6] = early;
        rf[7] = prompt;
        rf[8] = late;
        rf[9] = tc;
        rf[10] = t;
        ri[0] = n;
        ri[1] = carrier_dcyc;
        ri[2] = code_dcyc;

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
        if (coh) {
#pragma unroll
          for (int j = 0; j < 6; ++j) cacc[j] = u ? 0.0f : f[j];
        }
        block += 1;
        n_full_s = n_full;
        sub_j = sub_j_next;
        stalled = 0;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    int* so = sti_out + (size_t)c * NI;
    float* fo = stf_out + (size_t)c * NF;
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

template <int K, bool kSmemCode>
int launch(const void* x, const void* code, int code_stride,
           const void* s_i32, const void* s_f32, const void* ovl, int nov,
           const void* lut, void* rows_f, void* rows_i, void* sti_out,
           void* stf_out, int C, int B, int coh, const Loop& lp,
           cudaStream_t st) {
  track_fused_kernel<K, kSmemCode><<<C, kThreads, 0, st>>>(
      (const float2*)x, (const int8_t*)code, code_stride, (const int*)s_i32,
      (const float*)s_f32, (const float*)ovl, nov, (const float2*)lut,
      (float*)rows_f, (int*)rows_i, (int*)sti_out, (float*)stf_out, C, B,
      coh, lp);
  return (int)cudaGetLastError();
}

}  // namespace

// x: complex64 [nx]; code: int8 [C, code_stride] (code_stride = L, every
// channel's code length); s_i32/s_f32: packed state [C, 8] / [C, 28];
// ovl: float32 [C, nov] overlay chips (read when coh != 0); lut: f32
// [1024, 2]; kind: K3's subcarrier kind, 0 "none", 1 "subc", 2 "tmboc";
// outputs rows_f [B, C, 11], rows_i [B, C, 3], sti_out [C, 8], stf_out
// [C, 28].  Returns the cudaError_t of the launch (0 = launched).
extern "C" int track_fused(const void* x, int nx, const void* code,
                           int code_stride, const void* s_i32,
                           const void* s_f32, const void* ovl, int nov,
                           const void* lut, void* rows_f, void* rows_i,
                           void* sti_out, void* stf_out, int C, int B,
                           int kind, int coh, float fs_inv, int fll_wide,
                           int fll_narrow, float fll_wide_k,
                           float fll_narrow_k, float pll_k1, float pll_k2,
                           float dll_k1, float dll_k2, void* stream) {
  if (C < 1 || B < 0 || nx < 1 || code_stride < 1 || nov < 1 ||
      nov > kMaxOverlay || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Loop lp{fs_inv, fll_wide, fll_narrow, fll_wide_k, fll_narrow_k,
                pll_k1, pll_k2, dll_k1, dll_k2};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool smem = code_stride <= kMaxCode;
#define K2_ARGS x, code, code_stride, s_i32, s_f32, ovl, nov, lut, rows_f, \
                rows_i, sti_out, stf_out, C, B, coh, lp, st
  using namespace gnss_track;
  switch (kind) {
    case 0:
      return smem ? launch<SUB_BPSK, true>(K2_ARGS)
                  : launch<SUB_BPSK, false>(K2_ARGS);
    case 1:
      return smem ? launch<SUB_AFFINE, true>(K2_ARGS)
                  : launch<SUB_AFFINE, false>(K2_ARGS);
    default:
      return smem ? launch<SUB_AFFINE_TMBOC, true>(K2_ARGS)
                  : launch<SUB_AFFINE_TMBOC, false>(K2_ARGS);
  }
#undef K2_ARGS
}
