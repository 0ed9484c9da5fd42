// Non-coherent acquisition surface with in-kernel reduction (kernel K1).
//
// Replaces the TPU kernel gnss_dsp_tpu/ops/pallas_acquire2.py::corr_surface2
// (reduce=True, pallas_call at :325, body _kernel :173).  For each PRN p and
// doppler d it computes
//
//     s[j] = (1/W) * sum_b | IDFT_W( code_f[p] * conj(F[d, b]) ) [j] |
//
// and returns (max_j s, lowest j reaching the max, sum_j s).  The [P, DC, W]
// surface never goes to device memory.
//
// Design: one CTA of 256 threads per (p, d).  The PRN's code spectrum stays
// in registers (16 values per thread at W = 4096); each thread owns the lags
// j = tid + 256*t, so |.| accumulates in registers too.  Per block b the CTA
// forms the product into shared memory and runs an inverse Stockham FFT
// there: radix-16 passes (each thread does one 16-point DFT in registers
// per pass), a smaller radix for the last pass when W is not a power of 16,
// and ping-pong buffers.  Shared arrays are padded by one element per 16 so
// the strided pass writes do not hit one bank.  The twiddles are computed on
// the host in float64 and rounded once (acquire2.twiddle_table): the first
// 16 entries are e^{2 pi i k / 16}, then one table per pass laid out
// [r][k] so a warp reads consecutive entries.
//
// What bounds it on the card: shared-memory traffic of the FFT passes
// (about 8 shared reads or writes of 8 bytes per cell), not device memory:
// F is read once per PRN and the code spectrum once per CTA.  A later
// change should batch several PRNs per CTA so one F read feeds them all.
//
// W must be a power of two, 2 <= W <= 4096.  At W = 4096 a CTA uses about
// 102 KB of dynamic shared memory, which needs the opt-in attribute.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 4096;
constexpr int kPer = kMaxW / kThreads;   // lags (and code bins) per thread

__host__ __device__ constexpr int padded(int e) { return e + (e >> 4); }

__host__ __device__ constexpr int ilog2(int r) {
  return r <= 1 ? 0 : 1 + ilog2(r >> 1);
}

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int y = 0;
  for (int b = 0; b < bits; ++b) y |= ((x >> b) & 1) << (bits - 1 - b);
  return y;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// R-point inverse DFT in registers, natural order in and out: the caller
// loads the inputs in bit-reversed order, then radix-2 DIT stages.
// w16[k] = e^{+2 pi i k / 16}.
template <int R>
__device__ __forceinline__ void dft_reg(float2 (&v)[R], const float2* w16) {
#pragma unroll
  for (int len = 2; len <= R; len <<= 1) {
#pragma unroll
    for (int i = 0; i < R; i += len) {
#pragma unroll
      for (int k = 0; k < len / 2; ++k) {
        const float2 u = v[i + k];
        const float2 t = (k == 0) ? v[i + k + len / 2]
                                  : cmul(w16[k * (16 / len)], v[i + k + len / 2]);
        v[i + k] = make_float2(u.x + t.x, u.y + t.y);
        v[i + k + len / 2] = make_float2(u.x - t.x, u.y - t.y);
      }
    }
  }
}

// One Stockham pass of radix R at span Ns (product of the earlier radices):
// read j + r*W/R, twiddle by e^{+2 pi i r k/(Ns R)} (k = j mod Ns), R-point
// DFT, write (j - k)*R + k + r*Ns.
template <int R>
__device__ __forceinline__ void stockham_pass(const float2* in, float2* out,
                                              const float2* tw_pass,
                                              const float2* w16, int W,
                                              int Ns) {
  constexpr int LR = ilog2(R);
  const int items = W / R;
  for (int j = threadIdx.x; j < items; j += blockDim.x) {
    const int k = j & (Ns - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 a = in[padded(j + r * items)];
      v[bitrev(r, LR)] = (r == 0) ? a : cmul(a, tw_pass[r * Ns + k]);
    }
    dft_reg<R>(v, w16);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[padded(d + r * Ns)] = v[r];
  }
}

__host__ __device__ inline int twiddle_count(int W) {
  int n = 16, ns = 1;
  while (ns < W) {
    const int r = (W / ns < 16) ? W / ns : 16;
    n += r * ns;
    ns *= r;
  }
  return n;
}

__global__ void __launch_bounds__(kThreads)
acq2_reduce_kernel(const float2* __restrict__ F,
                   const float2* __restrict__ code_f,
                   const float2* __restrict__ tw_g, float* __restrict__ peak,
                   int* __restrict__ idx_out, float* __restrict__ sum_out,
                   int DC, int B, int W) {
  extern __shared__ float2 smem[];
  const int plen = padded(W);
  float2* buf_a = smem;
  float2* buf_b = smem + plen;
  float2* tw = smem + 2 * plen;
  const int ntw = twiddle_count(W);
  const int tid = threadIdx.x;
  const int d = blockIdx.x;
  const int p = blockIdx.y;

  for (int i = tid; i < ntw; i += blockDim.x) tw[i] = tw_g[i];

  float2 cf[kPer];
  float acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = tid + t * kThreads;
    cf[t] = (e < W) ? code_f[(size_t)p * W + e] : make_float2(0.f, 0.f);
    acc[t] = 0.f;
  }
  __syncthreads();

  for (int b = 0; b < B; ++b) {
    const float2* fb = F + ((size_t)d * B + b) * W;
    // product code_f * conj(F)
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = tid + t * kThreads;
      if (e < W) {
        const float2 f = fb[e];
        const float2 c = cf[t];
        buf_a[padded(e)] = make_float2(c.x * f.x + c.y * f.y,
                                       c.y * f.x - c.x * f.y);
      }
    }
    __syncthreads();

    float2* in = buf_a;
    float2* out = buf_b;
    int ns = 1;
    int off = 16;
    while (ns < W) {
      const int r = (W / ns < 16) ? W / ns : 16;
      switch (r) {
        case 16: stockham_pass<16>(in, out, tw + off, tw, W, ns); break;
        case 8: stockham_pass<8>(in, out, tw + off, tw, W, ns); break;
        case 4: stockham_pass<4>(in, out, tw + off, tw, W, ns); break;
        default: stockham_pass<2>(in, out, tw + off, tw, W, ns); break;
      }
      off += r * ns;
      ns *= r;
      __syncthreads();
      float2* tmp = in;
      in = out;
      out = tmp;
    }

#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = tid + t * kThreads;
      if (e < W) {
        const float2 v = in[padded(e)];
        acc[t] += sqrtf(v.x * v.x + v.y * v.y);
      }
    }
    __syncthreads();
  }

  // (max, lowest index reaching it, sum) over the CTA's W lags
  float bv = -INFINITY;
  int bi = W;
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = tid + t * kThreads;
    if (e < W) {
      if (acc[t] > bv) { bv = acc[t]; bi = e; }
      s += acc[t];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ float ws[kThreads / 32];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) { wv[warp] = bv; wi[warp] = bi; ws[warp] = s; }
  __syncthreads();
  if (tid == 0) {
    bv = wv[0]; bi = wi[0]; s = ws[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (wv[w] > bv || (wv[w] == bv && wi[w] < bi)) { bv = wv[w]; bi = wi[w]; }
      s += ws[w];
    }
    const float inv_w = 1.0f / (float)W;   // exact: W is a power of two
    peak[(size_t)p * DC + d] = bv * inv_w;
    idx_out[(size_t)p * DC + d] = bi;
    sum_out[(size_t)p * DC + d] = s * inv_w;
  }
}

}  // namespace

// F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: complex64
// [twiddle_count(W)]; outputs peak/sum f32 [P, DC], idx i32 [P, DC].
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int acq2_reduce(const void* F, const void* code_f, const void* tw,
                           void* peak, void* idx, void* sum, int P, int DC,
                           int B, int W, void* stream) {
  if (W < 2 || W > kMaxW || (W & (W - 1)) != 0 || P < 1 || DC < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t shmem =
      (size_t)(2 * padded(W) + twiddle_count(W)) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      acq2_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(DC, P);
  acq2_reduce_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float2*)F, (const float2*)code_f, (const float2*)tw,
      (float*)peak, (int*)idx, (float*)sum, DC, B, W);
  return (int)cudaGetLastError();
}
