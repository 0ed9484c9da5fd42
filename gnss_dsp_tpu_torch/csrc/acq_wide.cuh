// Correlation surfaces at windows a CTA's shared memory cannot hold: the
// wide mode of kernel K1 (acquire2.cu, the reduced surface).
//
// For PRN p, doppler d and block b the row IDFT_W(code_f[p] * conj(F[d, b]))
// has W complex values: 245,520 bytes at W = 30690 and 1.25 MiB at 163840,
// more than the 232,448 bytes a CTA can have.  So the inverse DFT runs as a
// four-step transform W = n1 * n2 through a scratch row in device memory:
//
//   k = k2 + n2*k1, j = j1 + n1*j2, w = e^{+2 pi i / W}
//   column pass  for each k2: an n1-point IDFT over k1 of X[k2 + n2*k1],
//                times w^(j1*k2), stored at row[j1*n2 + k2]
//   row pass     for each j1: an n2-point IDFT over k2 of row[j1*n2 + k2],
//                which is x[j1 + n1*j2]; |x| is added at acc[j1*n2 + j2]
//
// Both passes take tiles of whole sub-transforms (kWideTile elements) into
// shared memory and run mixed-radix Stockham passes there, out of place
// between two buffers: radix 16, 8, 4 and 2 as in acq_surface.cuh (bit-
// reversed loads, radix-2 stages in registers), and 3, 5, 11 and 31 as
// direct DFTs.  The radix order is next_radix below, which
// ops/acquire2.wide_twiddle_table follows.  Twiddles are float64 values
// rounded once to complex64: e^{2 pi i k/16}, the roots of 3, 5, 11 and 31
// (kWideHdr values, in shared memory), one [R][Ns] table per pass of each
// sub-length (shared memory), and w^t for t < W (device memory, read once
// per column element).
//
// One CTA owns one unit at a time and walks over the units with a grid
// stride.  A unit is one (p, d) = (item % P, item / P), so the P CTAs of
// one doppler run side by side and read the same F rows; where there are
// fewer (p, d) than CTA slots, the blocks of each (p, d) are split into
// nseg segments, one unit each, so the grid still fills the card.  A CTA's
// scratch row (slot blockIdx.x of rowbuf [slots, W]) and its unit's |.|
// accumulator (acc: slot blockIdx.x of [slots, W] when nseg = 1, else
// unit u of [P*DC*nseg, W]) are its own: every value is made by one thread
// in a fixed order (blocks ascending), so a run gives the same bits every
// time and needs no atomics.  The reduction follows over the natural lags
// j, reading acc[(j % n1)*n2 + j / n1] summed over the segments in order:
// in the same CTA when nseg = 1, else in a second kernel, one CTA per
// (p, d).  (Kernel K7, the full surface, has its own cluster design in
// acquire.cu.)
//
// Offsets into F, the scratch and the outputs are 64-bit: one launch may
// hold ~2^27 complex values of F.

#pragma once

#include "acq_surface.cuh"

namespace acq {
namespace {

constexpr int kWideT = 256;        // threads per CTA
constexpr int kWideTile = 4096;    // complex elements per shared buffer
// twiddle header: e^{2 pi i k/16} (16), then the roots of 3, 5, 11, 31
constexpr int kWideHdr = 16 + 3 + 5 + 11 + 31;

template <int R>
__host__ __device__ constexpr int root_off() {
  return R == 3 ? 16 : R == 5 ? 19 : R == 11 ? 24 : 35;
}

// radix of the next Stockham pass over the remaining length rem; 0 when
// rem has a factor the passes do not take
__host__ __device__ inline int next_radix(int rem) {
  if (rem % 16 == 0) return 16;
  if (rem % 8 == 0) return 8;
  if (rem % 4 == 0) return 4;
  if (rem % 2 == 0) return 2;
  if (rem % 3 == 0) return 3;
  if (rem % 5 == 0) return 5;
  if (rem % 11 == 0) return 11;
  if (rem % 31 == 0) return 31;
  return 0;
}

// entries of the per-pass twiddle tables of an m-point transform; -1 when
// m does not factor into the radices
__host__ __device__ inline int wide_table_len(int m) {
  int n = 0, ns = 1;
  while (ns < m) {
    const int r = next_radix(m / ns);
    if (r == 0) return -1;
    n += r * ns;
    ns *= r;
  }
  return n;
}

// One Stockham pass of radix R at span ns over nb transforms of length m
// stored one after another: read j + r*m/R, twiddle by e^{2 pi i r k/(ns R)}
// (k = j mod ns), R-point inverse DFT, write (j - k)*R + k + s*ns.
template <int R>
__device__ __forceinline__ void wide_pass(const float2* src, float2* dst,
                                          int nb, int m, int ns,
                                          const float2* twp,
                                          const float2* hdr) {
  const int items = m / R;
  const int total = nb * items;
  for (int u = threadIdx.x; u < total; u += kWideT) {
    const int t = u / items;
    const int j = u - t * items;
    const int k = j % ns;
    const int base = t * m;
    const int d = base + (j - k) * R + k;
    float2 v[R];
    if constexpr ((R & (R - 1)) == 0) {
      constexpr int LR = ilog2(R);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 a = src[padded(base + j + r * items)];
        v[bitrev(r, LR)] = (r == 0) ? a : cmul(a, twp[r * ns + k]);
      }
      dft_reg<R>(v, hdr);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[padded(d + r * ns)] = v[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 a = src[padded(base + j + r * items)];
        v[r] = (r == 0) ? a : cmul(a, twp[r * ns + k]);
      }
      const float2* wr = hdr + root_off<R>();
#pragma unroll
      for (int s = 0; s < R; ++s) {
        float2 y = v[0];
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 w = wr[(r * s) % R];
          y.x += v[r].x * w.x - v[r].y * w.y;
          y.y += v[r].x * w.y + v[r].y * w.x;
        }
        dst[padded(d + s * ns)] = y;
      }
    }
  }
  __syncthreads();
}

// Unscaled inverse DFTs of nb length-m transforms in a[padded(t*m + e)];
// returns the buffer (a or b) that holds the result.
__device__ float2* wide_ifft(float2* a, float2* b, int nb, int m,
                             const float2* twm, const float2* hdr) {
  int ns = 1, off = 0;
  while (ns < m) {
    const int r = next_radix(m / ns);
    switch (r) {
      case 16: wide_pass<16>(a, b, nb, m, ns, twm + off, hdr); break;
      case 8: wide_pass<8>(a, b, nb, m, ns, twm + off, hdr); break;
      case 4: wide_pass<4>(a, b, nb, m, ns, twm + off, hdr); break;
      case 2: wide_pass<2>(a, b, nb, m, ns, twm + off, hdr); break;
      case 3: wide_pass<3>(a, b, nb, m, ns, twm + off, hdr); break;
      case 5: wide_pass<5>(a, b, nb, m, ns, twm + off, hdr); break;
      case 11: wide_pass<11>(a, b, nb, m, ns, twm + off, hdr); break;
      default: wide_pass<31>(a, b, nb, m, ns, twm + off, hdr); break;
    }
    float2* t = a;
    a = b;
    b = t;
    off += r * ns;
    ns *= r;
  }
  return a;
}

struct WideArgs {
  const float2* F;       // [DC, B, W]
  const float2* code_f;  // [P, W]
  const float2* tw;      // header, then the n1 tables, then the n2 tables
  const float2* root;    // [W]: e^{2 pi i t/W}
  float2* rowbuf;        // [slots, W] scratch
  float* acc;            // [slots, W] scratch, or [P*DC*nseg, W] if nseg > 1
  float* peak;           // [P, DC]
  int* idx;              // [P, DC], lag - lo
  float* sum;            // [P, DC]
  int P, DC, B, W, n1, n2;
  int nseg;              // block segments per (p, d)
  int lo;                // lowest lag searched and summed
};

inline size_t wide_smem(int n1, int n2) {
  return ((size_t)2 * padded(kWideTile) + kWideHdr + wide_table_len(n1) +
          wide_table_len(n2)) * sizeof(float2);
}

// |.| of lag j (at o = (j % n1)*n2 + j / n1) summed over the nseg
// segment accumulators of one (p, d), in segment order
__device__ __forceinline__ float wide_at(const float* acc, int nseg,
                                         size_t W, size_t o) {
  float v = acc[o];
  for (int g = 1; g < nseg; ++g) v += acc[(size_t)g * W + o];
  return v;
}

// (max, lowest lag >= lo reaching it, sum over lags >= lo) of (p, d).  All
// threads of the CTA call it.
__device__ void wide_finish(const WideArgs& s, int p, int d,
                            const float* acc, int nseg) {
  const int W = s.W, n1 = s.n1, n2 = s.n2;
  const int tid = threadIdx.x;
  const float fw = (float)W;
  float bv = -INFINITY;
  int bi = W;
  float sm = 0.f;
  for (int j = s.lo + tid; j < W; j += kWideT) {
    const float v = wide_at(acc, nseg, W, (size_t)(j % n1) * n2 + j / n1);
    if (v > bv) { bv = v; bi = j; }
    sm += v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    sm += __shfl_down_sync(0xffffffffu, sm, o);
  }
  __shared__ float wv[kWideT / 32];
  __shared__ int wi[kWideT / 32];
  __shared__ float ws[kWideT / 32];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) { wv[warp] = bv; wi[warp] = bi; ws[warp] = sm; }
  __syncthreads();
  if (tid == 0) {
    bv = wv[0]; bi = wi[0]; sm = ws[0];
    for (int w = 1; w < kWideT / 32; ++w) {
      if (wv[w] > bv || (wv[w] == bv && wi[w] < bi)) { bv = wv[w]; bi = wi[w]; }
      sm += ws[w];
    }
    const size_t o = (size_t)p * s.DC + d;
    s.peak[o] = bv / fw;
    s.idx[o] = bi - s.lo;
    s.sum[o] = sm / fw;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kWideT, 2) wide_kernel(WideArgs s) {
  extern __shared__ float2 smem[];
  float2* bufa = smem;
  float2* bufb = smem + padded(kWideTile);
  float2* hdr = bufb + padded(kWideTile);
  const int W = s.W, n1 = s.n1, n2 = s.n2;
  const int len1 = wide_table_len(n1);
  const int ntw = kWideHdr + len1 + wide_table_len(n2);
  const float2* tw1 = hdr + kWideHdr;
  const float2* tw2 = tw1 + len1;
  const int tid = threadIdx.x;
  for (int i = tid; i < ntw; i += kWideT) hdr[i] = s.tw[i];
  __syncthreads();

  float2* row = s.rowbuf + (size_t)blockIdx.x * W;
  const int tc = kWideTile / n1;     // columns per tile
  const int tr = kWideTile / n2;     // rows per tile
  const long long units = (long long)s.P * s.DC * s.nseg;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long item = u / s.nseg;
    const int seg = (int)(u % s.nseg);
    const int p = (int)(item % s.P);
    const int d = (int)(item / s.P);
    const int b0 = (int)((long long)s.B * seg / s.nseg);
    const int b1 = (int)((long long)s.B * (seg + 1) / s.nseg);
    float* acc = s.acc + (size_t)(s.nseg > 1 ? u : blockIdx.x) * W;
    const float2* cf = s.code_f + (size_t)p * W;
    for (int b = b0; b < b1; ++b) {
      const float2* fb = s.F + ((size_t)d * s.B + b) * W;
      // column pass: tiles of nc adjacent columns k2 = c0 + t
      for (int c0 = 0; c0 < n2; c0 += tc) {
        const int nc = min(tc, n2 - c0);
        for (int e = tid; e < nc * n1; e += kWideT) {
          const int k1 = e / nc;
          const int t = e - k1 * nc;
          const size_t k = (size_t)(c0 + t) + (size_t)n2 * k1;
          bufa[padded(t * n1 + k1)] = cmul_conj(__ldg(cf + k), __ldg(fb + k));
        }
        __syncthreads();
        const float2* res = wide_ifft(bufa, bufb, nc, n1, tw1, hdr);
        for (int e = tid; e < nc * n1; e += kWideT) {
          const int j1 = e / nc;
          const int t = e - j1 * nc;
          const int k2 = c0 + t;
          const float2 v = res[padded(t * n1 + j1)];
          row[(size_t)j1 * n2 + k2] =
              cmul(v, __ldg(s.root + (size_t)j1 * k2));   // j1*k2 < W
        }
        __syncthreads();
      }
      // row pass: tiles of nr whole rows j1 = r0 + t, contiguous in row[]
      for (int r0 = 0; r0 < n1; r0 += tr) {
        const int nr = min(tr, n1 - r0);
        const float2* src = row + (size_t)r0 * n2;
        for (int e = tid; e < nr * n2; e += kWideT) bufa[padded(e)] = src[e];
        __syncthreads();
        const float2* res = wide_ifft(bufa, bufb, nr, n2, tw2, hdr);
        float* ac = acc + (size_t)r0 * n2;
        for (int e = tid; e < nr * n2; e += kWideT) {
          const float2 v = res[padded(e)];
          const float m = sqrtf(v.x * v.x + v.y * v.y);
          ac[e] = (b == b0) ? m : ac[e] + m;
        }
        __syncthreads();
      }
    }
    if (s.nseg == 1) wide_finish(s, p, d, acc, 1);
  }
}

// second pass of a split launch: one CTA per (p, d) over its nseg
// segment accumulators
__global__ void __launch_bounds__(kWideT) wide_finish_kernel(WideArgs s) {
  const int item = blockIdx.x;
  wide_finish(s, item % s.P, item / s.P,
                      s.acc + (size_t)item * s.nseg * s.W, s.nseg);
}

inline bool wide_ok(int W, int n1, int n2) {
  return n1 >= 2 && n2 >= 2 && (long long)n1 * n2 == W &&
         n1 <= kWideTile && n2 <= kWideTile && wide_table_len(n1) >= 0 &&
         wide_table_len(n2) >= 0;
}

// Launch over min(P*DC*nseg, slots) CTAs, then, when nseg > 1, the second
// pass over P*DC.  Returns a cudaError_t.
inline int launch_wide(WideArgs s, int slots, cudaStream_t stream) {
  const long long items = (long long)s.P * s.DC;
  if (!wide_ok(s.W, s.n1, s.n2) || s.P < 1 || s.DC < 1 || s.B < 1 ||
      s.nseg < 1 || s.nseg > s.B || slots < 1 || s.lo < 0 || s.lo >= s.W ||
      items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = wide_smem(s.n1, s.n2);
  auto k = wide_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const long long units = items * s.nseg;
  const int grid = (int)(units < slots ? units : slots);
  k<<<grid, kWideT, shmem, stream>>>(s);
  e = cudaGetLastError();
  if (e != cudaSuccess || s.nseg == 1) return (int)e;
  wide_finish_kernel<<<(unsigned)items, kWideT, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace acq
