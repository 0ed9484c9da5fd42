// One tracking step's early/prompt/late sums for every channel (kernels K3
// and K4).
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
// channels that is ~1 MB, well under a microsecond at 3.35 TB/s.  Launch
// latency and the host's per-step work set the time.  The grid splits each
// channel's block into tiles of kTile samples, grid (tile, channel), so
// that the L5-class rates (n ~ 46k at 30.69 MHz) fill the SMs instead of
// one CTA per channel.
//
// Determinism without float atomics: each CTA reduces its tile with warp
// shuffles in a fixed tree and writes six float64 partials to a [C, T, 6]
// scratch; epl_finish sums the tiles in tile order and rounds to float32
// once.  Two launches give the same bits, and the plain version (float64
// sums rounded once) the same bits up to a double-rounding tie.

#include "track_corr.cuh"

namespace {

using namespace gnss_track;

constexpr int kThreads = 256;
constexpr int kTile = 2048;

// si lanes (the JAX kernels' layout, ops/track_step.py SI_*)
enum { SI_VINT_E, SI_VINT_P, SI_VINT_L, SI_COFF_DF, SI_N, SI_COFF_P,
       SI_CARR_DF, SI_CARR_P, SI_PTR, NSI };
// sf lanes: fr_e, fr_p, fr_l, cf, then K3's a0, a1, a6, tm
enum { SF_FR_E, SF_FR_P, SF_FR_L, SF_CF, SF_A0, SF_A1, SF_A6, SF_TM };

template <int K>
__global__ void __launch_bounds__(kThreads)
epl_tiles(const float2* __restrict__ x, int nx,
          const int8_t* __restrict__ code, int L,
          const int* __restrict__ si, const float* __restrict__ sf,
          int sf_lanes, const float2* __restrict__ lut_g,
          double* __restrict__ part, int T) {
  __shared__ float2 lut[kLut];
  __shared__ double red[kThreads / 32][6];
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < kLut; i += kThreads) lut[i] = lut_g[i];
  __syncthreads();

  const int* s = si + (size_t)c * NSI;
  const float* f = sf + (size_t)c * sf_lanes;
  const int start = s[SI_PTR];
  // samples [begin, end) of the block; never past the chunk
  const int begin = t * kTile;
  const int end = min(min(s[SI_N], begin + kTile), nx - start);
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (begin < end) {
    Block g{(uint32_t)s[SI_COFF_P], (uint32_t)s[SI_COFF_DF],
            (uint32_t)s[SI_CARR_P], (uint32_t)s[SI_CARR_DF], f[SF_CF],
            {s[SI_VINT_E], s[SI_VINT_P], s[SI_VINT_L]},
            {f[SF_FR_E], f[SF_FR_P], f[SF_FR_L]}, false};
    g.cmp = compare_wrap_ok(g, end, L);
    Coef coef{0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (K == SUB_AFFINE || K == SUB_AFFINE_TMBOC)
      coef = Coef{f[SF_A0], f[SF_A1], f[SF_A6],
                  K == SUB_AFFINE_TMBOC ? f[SF_TM] : 0.0f};
    const int8_t* row = code + (size_t)c * L;
    auto chip_at = [&](int k) { return (int)__ldg(row + k); };
    if (g.cmp)
      epl_samples<K, true>(x + start, lut, g, L, coef, chip_at, begin + tid,
                           end, kThreads, acc);
    else
      epl_samples<K, false>(x + start, lut, g, L, coef, chip_at, begin + tid,
                            end, kThreads, acc);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) acc[j] = warp_sum(acc[j]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) red[tid >> 5][j] = acc[j];
  }
  __syncthreads();
  if (tid < 6) {
    double v = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) v += red[w][tid];
    part[((size_t)c * T + t) * 6 + tid] = v;
  }
}

// out[c, j] = float32(sum over tiles t, in order, of part[c, t, j])
__global__ void epl_finish(const double* __restrict__ part, int C, int T,
                           float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C * 6) return;
  const int c = k / 6, j = k % 6;
  double v = 0.0;
  for (int t = 0; t < T; ++t) v += part[((size_t)c * T + t) * 6 + j];
  out[k] = (float)v;
}

template <int K>
int launch(const void* x, int nx, const void* code, int L, const void* si,
           const void* sf, int sf_lanes, const void* lut, void* part,
           void* out, int C, int T, cudaStream_t st) {
  epl_tiles<K><<<dim3(T, C), kThreads, 0, st>>>(
      (const float2*)x, nx, (const int8_t*)code, L, (const int*)si,
      (const float*)sf, sf_lanes, (const float2*)lut, (double*)part, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  epl_finish<<<(C * 6 + 127) / 128, 128, 0, st>>>((const double*)part, C, T,
                                                  (float*)out);
  return (int)cudaGetLastError();
}

bool bad_args(int nx, int L, int sf_lanes, int C, int T, int need_lanes) {
  return nx < 1 || L < 1 || C < 1 || T < 1 || C > 65535 ||
         sf_lanes < need_lanes;
}

}  // namespace

// x: complex64 [nx]; code: int8 [C, L]; si: int32 [C, 9]; sf: float32
// [C, sf_lanes]; lut: float32 [1024, 2]; part: float64 [C, T, 6] scratch;
// out: float32 [C, 6].  T tiles of 2048 samples must cover every
// channel's n.  Returns the cudaError_t of the launches (0 = launched).

// K3: kind 0 = "none", 1 = "subc", 2 = "tmboc"; sf has 8 lanes.
extern "C" int track_step_v2(const void* x, int nx, const void* code, int L,
                             const void* si, const void* sf, int sf_lanes,
                             const void* lut, void* part, void* out, int C,
                             int T, int kind, void* stream) {
  if (bad_args(nx, L, sf_lanes, C, T, 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<SUB_BPSK>(x, nx, code, L, si, sf, sf_lanes, lut,
                                    part, out, C, T, st);
    case 1: return launch<SUB_AFFINE>(x, nx, code, L, si, sf, sf_lanes, lut,
                                      part, out, C, T, st);
    case 2: return launch<SUB_AFFINE_TMBOC>(x, nx, code, L, si, sf, sf_lanes,
                                            lut, part, out, C, T, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K4: family 0 = "none", 1 = "boc11", 2 = "cboc", 3 = "tmboc",
// 4 = "rz_even", 5 = "rz_odd"; sf has at least 4 lanes.
extern "C" int track_step_v1(const void* x, int nx, const void* code, int L,
                             const void* si, const void* sf, int sf_lanes,
                             const void* lut, void* part, void* out, int C,
                             int T, int family, void* stream) {
  if (bad_args(nx, L, sf_lanes, C, T, 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (family) {
    case 0: return launch<SUB_BPSK>(x, nx, code, L, si, sf, sf_lanes, lut,
                                    part, out, C, T, st);
    case 1: return launch<SUB_BOC11>(x, nx, code, L, si, sf, sf_lanes, lut,
                                     part, out, C, T, st);
    case 2: return launch<SUB_CBOC>(x, nx, code, L, si, sf, sf_lanes, lut,
                                    part, out, C, T, st);
    case 3: return launch<SUB_TMBOC>(x, nx, code, L, si, sf, sf_lanes, lut,
                                     part, out, C, T, st);
    case 4: return launch<SUB_RZ_EVEN>(x, nx, code, L, si, sf, sf_lanes, lut,
                                       part, out, C, T, st);
    case 5: return launch<SUB_RZ_ODD>(x, nx, code, L, si, sf, sf_lanes, lut,
                                      part, out, C, T, st);
  }
  return (int)cudaErrorInvalidValue;
}
