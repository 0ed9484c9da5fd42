// Correlation surfaces in shared memory, shared by the acquisition kernels
// K1 (acquire2.cu) and K6 (acquire_coh.cu).
//
// One CTA owns one (PRN p, doppler d, alignment a) cell.  For each of its
// rows it forms a spectrum in shared memory, runs an inverse FFT there in
// place, and adds |.| into per-thread accumulators:
//
//     s[j] = (1/W) * sum_rows | IDFT_W( spectrum_row ) [j] |
//
// then reduces s to (max, lowest lag j >= lo reaching it, sum over the
// lags j >= lo) and writes them at (p, d, a).  What a row is depends on
// the kernel:
//
//   kRows     row r is code_f[p] * conj(F[d, r*A + a]): K1 (A = 1, the
//             blocks)
//   kCombine  row g is code_f[p] * conj(sum_m w[a, g*M + m] F[d, g*M + m])
//             with w = sec[a, m] * conj(rot[d, m]): K6.  The IDFT is
//             linear, so this is sum_m sec * rot * IDFT(code_f * conj(F_m)),
//             the coherent per-block sum of the TPU kernel, with one IDFT
//             per group instead of one per block and alignment.
//
// Inverse FFT: Stockham passes of radix 16 (a smaller radix for the last
// pass when W is not a power of 16), in place in ONE shared buffer: every
// thread loads its butterflies' inputs into registers, the CTA syncs, then
// every thread writes its outputs.  So a row of W = 16384 (128 KiB plus
// padding) fits where two ping-pong buffers would not.  The shared array is
// padded by one element per 16 so the strided pass writes do not hit one
// bank.  The twiddles (acquire2.twiddle_table: e^{2 pi i k/16}, then one
// [R][Ns] table per pass) are float64 values rounded once; they sit in
// shared memory when they fit beside the buffer, else they are read from
// device memory (L2).
//
// Threads: T threads per CTA, each owns PER = kMaxW / T lags
// j = tid + T*t, so the |.| accumulators stay in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace acq {
namespace {   // each translation unit keeps its own instantiations

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

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
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

// One Stockham pass of radix R at span Ns (product of the earlier radices),
// in place: read j + r*W/R, twiddle by e^{+2 pi i r k/(Ns R)} (k = j mod Ns),
// R-point DFT, sync, write (j - k)*R + k + r*Ns, sync.
template <int R, int T, int PER>
__device__ __forceinline__ void pass_inplace(float2* buf,
                                             const float2* tw_pass,
                                             const float2* w16, int W,
                                             int Ns) {
  constexpr int LR = ilog2(R);
  constexpr int Q = (PER / R) > 0 ? PER / R : 1;   // butterflies per thread
  const int items = W / R;
  float2 v[Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = threadIdx.x + q * T;
    if (j < items) {
      const int k = j & (Ns - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 a = buf[padded(j + r * items)];
        v[q][bitrev(r, LR)] = (r == 0) ? a : cmul(a, tw_pass[r * Ns + k]);
      }
      dft_reg<R>(v[q], w16);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = threadIdx.x + q * T;
    if (j < items) {
      const int k = j & (Ns - 1);
      const int d = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[padded(d + r * Ns)] = v[q][r];
    }
  }
  __syncthreads();
}

// Unscaled inverse DFT of buf[padded(0..W)] in place.  tw: the whole
// twiddle table (shared or device memory); w16: its first 16 entries in
// shared memory.
template <int T, int PER>
__device__ void ifft_inplace(float2* buf, const float2* tw,
                             const float2* w16, int W) {
  int ns = 1;
  int off = 16;
  while (ns < W) {
    const int r = (W / ns < 16) ? W / ns : 16;
    switch (r) {
      case 16: pass_inplace<16, T, PER>(buf, tw + off, w16, W, ns); break;
      case 8: pass_inplace<8, T, PER>(buf, tw + off, w16, W, ns); break;
      case 4: pass_inplace<4, T, PER>(buf, tw + off, w16, W, ns); break;
      default: pass_inplace<2, T, PER>(buf, tw + off, w16, W, ns); break;
    }
    off += r * ns;
    ns *= r;
  }
}

enum RowKind { kRows = 0, kCombine = 1 };

struct SurfaceArgs {
  const float2* F;       // kRows: [DC, rows_per_d, W]; kCombine: [DC, B, W]
  const float2* code_f;  // [P, W]
  const float2* tw;      // twiddle table, device memory
  const float* cosang;   // kCombine: [DC, B]
  const float* sinang;   // kCombine: [DC, B]
  const float* sec_mat;  // kCombine: [A, B]
  float* peak;           // [P, DC, A]
  int* idx;              // [P, DC, A], lag - lo
  float* sum;            // [P, DC, A] or null
  int P, DC, A, W;
  int rows_per_d;        // kRows: rows of F per doppler; kCombine: B
  int nrows;             // rows summed per CTA (kRows) or groups (kCombine)
  int m_coh;             // kCombine: blocks per group
  int lo;                // lowest lag searched and summed (W - n_valid, or 0)
  int tw_in_smem;
};

// dynamic shared memory of one CTA, in bytes
inline size_t surface_smem(int W, int ntw, int tw_in_smem, int m_coh) {
  return ((size_t)padded(W) + (tw_in_smem ? ntw : 16) + (size_t)m_coh) *
         sizeof(float2);
}

// CTA blockIdx.x = (d*A + a)*P + p: the P CTAs that read the same rows run
// side by side, so each row comes from device memory about once.
template <int T, int PER, int KIND>
__global__ void __launch_bounds__(T) surface_kernel(SurfaceArgs s) {
  extern __shared__ float2 smem[];
  const int W = s.W;
  float2* buf = smem;
  float2* w16 = smem + padded(W);
  const int ntw = s.tw_in_smem ? twiddle_count(W) : 16;
  float2* wts = w16 + ntw;                        // kCombine: [m_coh]
  const int tid = threadIdx.x;
  const int p = blockIdx.x % s.P;
  const int da = blockIdx.x / s.P;
  const int a = da % s.A;
  const int d = da / s.A;

  for (int i = tid; i < ntw; i += T) w16[i] = s.tw[i];
  const float2* tw = s.tw_in_smem ? w16 : s.tw;
  const float2* cf = s.code_f + (size_t)p * W;

  float acc[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) acc[t] = 0.f;
  __syncthreads();

  for (int r = 0; r < s.nrows; ++r) {
    if (KIND == kRows) {
      const float2* fb =
          s.F + ((size_t)d * s.rows_per_d + (size_t)r * s.A + a) * W;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int e = tid + t * T;
        if (e < W) buf[padded(e)] = cmul_conj(__ldg(cf + e), __ldg(fb + e));
      }
    } else {
      const int M = s.m_coh;
      const int m0 = r * M;
      for (int m = tid; m < M; m += T) {
        const size_t dm = (size_t)d * s.rows_per_d + m0 + m;
        const float sg = s.sec_mat[(size_t)a * s.rows_per_d + m0 + m];
        wts[m] = make_float2(sg * s.cosang[dm], -sg * s.sinang[dm]);
      }
      __syncthreads();
      const float2* fg = s.F + ((size_t)d * s.rows_per_d + m0) * W;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int e = tid + t * T;
        if (e < W) {
          float2 acc_c = make_float2(0.f, 0.f);
          for (int m = 0; m < M; ++m) {
            const float2 f = __ldg(fg + (size_t)m * W + e);
            const float2 w = wts[m];
            acc_c.x += w.x * f.x - w.y * f.y;
            acc_c.y += w.x * f.y + w.y * f.x;
          }
          buf[padded(e)] = cmul_conj(__ldg(cf + e), acc_c);
        }
      }
    }
    __syncthreads();
    ifft_inplace<T, PER>(buf, tw, w16, W);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int e = tid + t * T;
      if (e < W) {
        const float2 v = buf[padded(e)];
        acc[t] += sqrtf(v.x * v.x + v.y * v.y);
      }
    }
    __syncthreads();
  }

  // (max, lowest lag >= lo reaching it, sum over the lags >= lo)
  float bv = -INFINITY;
  int bi = W;
  float sm = 0.f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = tid + t * T;
    if (e < W && e >= s.lo) {
      if (acc[t] > bv) { bv = acc[t]; bi = e; }
      sm += acc[t];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    sm += __shfl_down_sync(0xffffffffu, sm, o);
  }
  __shared__ float wv[T / 32];
  __shared__ int wi[T / 32];
  __shared__ float ws[T / 32];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) { wv[warp] = bv; wi[warp] = bi; ws[warp] = sm; }
  __syncthreads();
  if (tid == 0) {
    bv = wv[0]; bi = wi[0]; sm = ws[0];
    for (int w = 1; w < T / 32; ++w) {
      if (wv[w] > bv || (wv[w] == bv && wi[w] < bi)) { bv = wv[w]; bi = wi[w]; }
      sm += ws[w];
    }
    const float inv_w = 1.0f / (float)W;   // exact: W is a power of two
    const size_t o = ((size_t)p * s.DC + d) * s.A + a;
    s.peak[o] = bv * inv_w;
    s.idx[o] = bi - s.lo;
    if (s.sum) s.sum[o] = sm * inv_w;
  }
}

constexpr int kMaxW = 16384;
constexpr int kSmallW = 4096;     // W <= kSmallW: 256 threads, else 1024
constexpr size_t kTwSmemBytes = 100 * 1024;

inline bool supported_w(int W) {
  return W >= 2 && W <= kMaxW && (W & (W - 1)) == 0;
}

// Launch the surface kernel for (P, DC, A) CTAs.  Returns a cudaError_t.
template <int KIND>
inline int launch_surface(SurfaceArgs s, cudaStream_t stream) {
  if (!supported_w(s.W) || s.P < 1 || s.DC < 1 || s.A < 1 || s.nrows < 0)
    return (int)cudaErrorInvalidValue;
  const int ntw = twiddle_count(s.W);
  s.tw_in_smem =
      surface_smem(s.W, ntw, 1, KIND == kCombine ? s.m_coh : 0) <= kTwSmemBytes;
  const size_t shmem = surface_smem(s.W, ntw, s.tw_in_smem,
                                    KIND == kCombine ? s.m_coh : 0);
  const long long ctas = (long long)s.P * s.DC * s.A;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (s.W <= kSmallW) {
    auto k = surface_kernel<256, kSmallW / 256, KIND>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    if (e != cudaSuccess) return (int)e;
    k<<<(unsigned)ctas, 256, shmem, stream>>>(s);
  } else {
    auto k = surface_kernel<1024, kMaxW / 1024, KIND>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    if (e != cudaSuccess) return (int)e;
    k<<<(unsigned)ctas, 1024, shmem, stream>>>(s);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace acq
