// A row transform held across a thread-block cluster, shared by the
// acquisition kernels K1 (acquire2.cu), K5 (acquire_coh_spec.cu), K6's
// surface stage (acquire_coh.cu) and K7 (acquire.cu).
//
// A surface row is the unscaled inverse DFT of W complex values,
// IDFT_W(code_f[p] * conj(F_row)).  At W = 16384 the row (128 KiB) leaves
// one CTA per SM, and at W = 30690 (245,520 bytes) it does not fit one CTA
// at all.  Here the row is split over the C CTAs of a cluster and runs as a
// four-step transform W = n1 * n2 whose transpose goes through distributed
// shared memory (DSMEM), so no value of a row goes to device memory.  Two
// cores share the cluster barriers, the register DFTs with compile-time
// roots and the asynchronous copies below: row_transform, for any W whose
// factors are 2, 3, 5, 11, 31, with run-time sizes (described here; K7,
// and wide_rows at the end of the file: K1 and K5 at 163840), and Split,
// power-of-two and 320-point sub-transforms with compile-time sizes and
// the values in registers (surface_rows: K1, K5 and K6 at 2 to 81920).
// The cluster's reduction (cluster_best) follows; the launch helpers
// are cluster_launch.cuh's.
// row_transform:
//
//   k = k2 + n2*k1, j = j1 + n1*j2, w = e^{+2 pi i / W}
//   column pass  CTA r owns the columns k2 = r*nc + t (nc = ceil(n2/C),
//                fewer in the last CTAs): it loads X[k2 + n2*k1] into its
//                own shared memory, one transform contiguous per column,
//                and runs its n1-point IDFTs over k1
//   cluster barrier
//   transpose    CTA r owns the rows j1 = r*nr + t (nr = ceil(n1/C)): it
//                reads Y[j1, k2] for every k2 from the CTA that owns column
//                k2 (cluster.map_shared_rank), times w^(j1*k2), into its
//                other buffer, one transform contiguous per row
//   cluster barrier (split: arrive after the reads, wait before the buffer
//                the others read is written again)
//   row pass     its n2-point IDFTs over k2: x[j1 + n1*j2]
//
// Sub-transforms: out-of-place Stockham passes between two shared buffers,
// radix 16, 8, 4, 2 (radix-2 stages in registers, compile-time roots of
// 16) and 3, 5, 11, 31 (direct DFTs over conjugate pairs, compile-time
// roots).  The radix order is next_radix below, which
// ops/acquire2.wide_passes follows.  The per-pass twiddles (e^{2 pi i r k
// /(ns R)}, ops/acquire2.wide_twiddle_table) sit in shared memory.  The
// four-step twiddle comes from two small tables, w^t = A[t mod n2] *
// B[t div n2] with A[u] = w^u (n2 entries) and B[v] = e^{2 pi i v/n1} (n1
// entries), after the pass tables (ops/acquire2.cluster_twiddle_table).
//
// Index math: every division by a run-time size is a multiply-high by a
// magic number (FastDiv), set up once: on the host in the plan, which the
// kernels take as a __grid_constant__ parameter, or once per CTA for its
// own share (share_of).
//
// Layout: transform t of a buffer starts at t*S (S = m + m/16, made odd)
// and its element e sits at t*S + e + e/16: the passes' strided accesses
// and the transposed accesses (consecutive threads on consecutive t) do
// not pile onto one bank.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace acqc {
namespace cg = cooperative_groups;
namespace {   // each translation unit keeps its own instantiations

using clusterk::cluster_arrive;
using clusterk::cluster_info;
using clusterk::cluster_wait;
using clusterk::kMaxSmem;
using clusterk::launch_cluster;

constexpr int kMaxPasses = 12;
// twiddle header of ops/acquire2.wide_twiddle_table: e^{2 pi i k/16}, then
// the roots of 3, 5, 11, 31 (not read here: the DFTs use constants)
constexpr int kHdr = 16 + 3 + 5 + 11 + 31;

// x / d for 0 <= x < 2^31 by a multiply-high (the round-up method:
// m = floor(2^32 (2^s - d) / d) + 1, s = ceil(log2 d))
struct FastDiv {
  uint32_t d, m, s;
};

__host__ __device__ inline FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t m = ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1;
  return {d, (uint32_t)m, s};
}

__device__ __forceinline__ int fdiv(int x, const FastDiv& f) {
  return (int)((__umulhi((uint32_t)x, f.m) + (uint32_t)x) >> f.s);
}

struct Pass {
  int R, ns, tw;        // radix, span, offset of its [R][ns] table
  FastDiv items;        // m / R butterflies per transform
  FastDiv nsd;          // ns
};

struct Sub {            // the passes of an m-point transform
  int m, S, np;
  Pass p[kMaxPasses];
};

struct Plan {
  int W, n1, n2, C;
  int nc, nr;           // columns, rows of the first CTAs (the last: fewer)
  int buf;              // float2 per shared buffer
  int ntw, twA, twB;    // twiddle table length, offsets of A and B
  Sub col, row;         // n1-point, n2-point
  FastDiv nc_d, n2_d;
};

// What CTA `rank` owns: columns c0 + [0, nc), rows j10 + [0, nr)
struct Share {
  int c0, nc, j10, nr;
  FastDiv ncd, nrd;
};

__device__ inline Share share_of(const Plan& pl, int rank) {
  Share h;
  h.c0 = rank * pl.nc;
  h.nc = min(pl.nc, pl.n2 - h.c0);
  h.j10 = rank * pl.nr;
  h.nr = min(pl.nr, pl.n1 - h.j10);
  h.ncd = make_div((uint32_t)h.nc);
  h.nrd = make_div((uint32_t)h.nr);
  return h;
}

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

inline int stride_of(int m) { return (m + (m >> 4)) | 1; }

// the passes of an m-point transform whose tables start at *off; false
// when m has a factor the passes do not take
inline bool make_sub(Sub& s, int m, int* off) {
  s.m = m;
  s.S = stride_of(m);
  s.np = 0;
  int ns = 1;
  while (ns < m) {
    const int r = next_radix(m / ns);
    if (r == 0 || s.np == kMaxPasses) return false;
    Pass& p = s.p[s.np++];
    p.R = r;
    p.ns = ns;
    p.tw = *off;
    p.items = make_div((uint32_t)(m / r));
    p.nsd = make_div((uint32_t)ns);
    *off += r * ns;
    ns *= r;
  }
  return true;
}

// The plan of W = n1 * n2 over a cluster of C CTAs; false when a CTA
// would own no column or no row, or a factor has a prime the passes do
// not take.
inline bool make_plan(Plan& pl, int W, int n1, int n2, int C) {
  if (n1 < 1 || n2 < 1 || (long long)n1 * n2 != W || C < 1) return false;
  pl.W = W;
  pl.n1 = n1;
  pl.n2 = n2;
  pl.C = C;
  pl.nc = (n2 + C - 1) / C;
  pl.nr = (n1 + C - 1) / C;
  if ((C - 1) * pl.nc >= n2 || (C - 1) * pl.nr >= n1) return false;
  int off = kHdr;
  if (!make_sub(pl.col, n1, &off) || !make_sub(pl.row, n2, &off)) return false;
  pl.twA = off;
  pl.twB = off + n2;
  pl.ntw = off + n2 + n1;
  const int bc = pl.nc * pl.col.S, br = pl.nr * pl.row.S;
  pl.buf = bc > br ? bc : br;
  pl.nc_d = make_div((uint32_t)pl.nc);
  pl.n2_d = make_div((uint32_t)n2);
  return true;
}

__device__ __forceinline__ int at(int t, int S, int e) {
  return t * S + e + (e >> 4);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// |v| by the hardware square root (sqrt.approx.f32, relative error within
// 2^-22; 0 and inf exact): the surfaces are held to rtol 1e-4, and the
// IEEE sqrtf's refinement was a large part of the kernels' |.| sums
__device__ __forceinline__ float cabs_approx(float2 v) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(v.x * v.x + v.y * v.y));
  return r;
}

__host__ __device__ constexpr int ilog2(int r) {
  return r <= 1 ? 0 : 1 + ilog2(r >> 1);
}

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int y = 0;
  for (int b = 0; b < bits; ++b) y |= ((x >> b) & 1) << (bits - 1 - b);
  return y;
}

// e^{2 pi i k/16} as compile-time constants (float64 values rounded once)
__device__ __forceinline__ float2 root16(int k) {
  constexpr float c[16] = {1.f, 0.923879504f, 0.707106769f, 0.382683426f,
                           0.f, -0.382683426f, -0.707106769f, -0.923879504f,
                           -1.f, -0.923879504f, -0.707106769f, -0.382683426f,
                           0.f, 0.382683426f, 0.707106769f, 0.923879504f};
  return make_float2(c[k & 15], c[(k + 12) & 15]);
}

// v * e^{2 pi i k/16}; k is a constant once the callers' loops unroll, and
// k = 4, 8, 12 are exact swaps and signs
__device__ __forceinline__ float2 rot16(float2 v, int k) {
  if (k == 0) return v;
  if (k == 4) return make_float2(-v.y, v.x);
  if (k == 8) return make_float2(-v.x, -v.y);
  if (k == 12) return make_float2(v.y, -v.x);
  return cmul(v, root16(k));
}

// one radix-2 DIT stage of span LEN, then the next: the stages are
// template arguments, so every index below is a compile-time constant and
// v stays in registers
template <int R, int LEN>
__device__ __forceinline__ void dit_stages(float2 (&v)[R]) {
  if constexpr (LEN <= R) {
#pragma unroll
    for (int i = 0; i < R; i += LEN) {
#pragma unroll
      for (int k = 0; k < LEN / 2; ++k) {
        const float2 u = v[i + k];
        const float2 t = rot16(v[i + k + LEN / 2], k * (16 / LEN));
        v[i + k] = make_float2(u.x + t.x, u.y + t.y);
        v[i + k + LEN / 2] = make_float2(u.x - t.x, u.y - t.y);
      }
    }
    dit_stages<R, 2 * LEN>(v);
  }
}

// R-point inverse DFT in registers, natural order in and out, R a power of
// two <= 16: the caller loads in bit-reversed order, then radix-2 DIT stages
template <int R>
__device__ __forceinline__ void dft_pow2(float2 (&v)[R]) {
  dit_stages<R, 2>(v);
}

// cos and sin of 2 pi k/R for the odd radices (float64 rounded once)
template <int R>
__device__ __forceinline__ float2 root_odd(int k) {
  if constexpr (R == 3) {
    constexpr float c[3] = {1.f, -0.5f, -0.5f};
    constexpr float s[3] = {0.f, 0.866025388f, -0.866025388f};
    return make_float2(c[k], s[k]);
  } else if constexpr (R == 5) {
    constexpr float c[5] = {1.f, 0.309017003f, -0.809017003f, -0.809017003f,
                            0.309017003f};
    constexpr float s[5] = {0.f, 0.95105654f, 0.587785244f, -0.587785244f,
                            -0.95105654f};
    return make_float2(c[k], s[k]);
  } else if constexpr (R == 11) {
    constexpr float c[11] = {1.f, 0.841253519f, 0.415415019f, -0.142314836f,
                             -0.654860735f, -0.959492981f, -0.959492981f,
                             -0.654860735f, -0.142314836f, 0.415415019f,
                             0.841253519f};
    constexpr float s[11] = {0.f, 0.540640831f, 0.909631968f, 0.989821434f,
                             0.755749583f, 0.281732559f, -0.281732559f,
                             -0.755749583f, -0.989821434f, -0.909631968f,
                             -0.540640831f};
    return make_float2(c[k], s[k]);
  } else {
    static_assert(R == 31, "odd radices: 3, 5, 11, 31");
    constexpr float c[31] = {
        1.f, 0.979529917f, 0.918957829f, 0.820763469f, 0.68896693f,
        0.528963983f, 0.347305238f, 0.151427776f, -0.0506491698f,
        -0.250652522f, -0.440394163f, -0.612105966f, -0.758758128f,
        -0.874346614f, -0.954139233f, -0.994869351f, -0.994869351f,
        -0.954139233f, -0.874346614f, -0.758758128f, -0.612105966f,
        -0.440394163f, -0.250652522f, -0.0506491698f, 0.151427776f,
        0.347305238f, 0.528963983f, 0.68896693f, 0.820763469f, 0.918957829f,
        0.979529917f};
    constexpr float s[31] = {
        0.f, 0.20129852f, 0.394355863f, 0.571268201f, 0.724792778f,
        0.848644257f, 0.937752128f, 0.988468349f, 0.998716533f, 0.968077123f,
        0.897804558f, 0.790775716f, 0.651372492f, 0.485301971f, 0.299363136f,
        0.10116832f, -0.10116832f, -0.299363136f, -0.485301971f,
        -0.651372492f, -0.790775716f, -0.897804558f, -0.968077123f,
        -0.998716533f, -0.988468349f, -0.937752128f, -0.848644257f,
        -0.724792778f, -0.571268201f, -0.394355863f, -0.20129852f};
    return make_float2(c[k], s[k]);
  }
}

// R-point inverse DFT for odd R over conjugate pairs, each output stored
// as it is made (out[s] at dst[base + at(d + s*ns)]):
// y_s = v_0 + sum_{r <= R/2} (v_r + v_{R-r}) cos + i (v_r - v_{R-r}) sin
// at the angle 2 pi r s / R
template <int R>
__device__ __forceinline__ void dft_odd_store(const float2 (&v)[R],
                                              float2* __restrict__ dst,
                                              int base, int d, int ns) {
  constexpr int H = R / 2;
  float2 a[H + 1], b[H + 1];
  float2 y0 = v[0];
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    a[r] = make_float2(v[r].x + v[R - r].x, v[r].y + v[R - r].y);
    b[r] = make_float2(v[r].x - v[R - r].x, v[r].y - v[R - r].y);
    y0 = make_float2(y0.x + a[r].x, y0.y + a[r].y);
  }
  dst[base + d + (d >> 4)] = y0;
#pragma unroll
  for (int s = 1; s <= H; ++s) {
    float2 p = v[0], q = make_float2(0.f, 0.f);  // y_s = p + q, y_{R-s} = p - q
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const float2 w = root_odd<R>((r * s) % R);
      p.x += a[r].x * w.x;
      p.y += a[r].y * w.x;
      q.x -= b[r].y * w.y;
      q.y += b[r].x * w.y;
    }
    const int e1 = d + s * ns, e2 = d + (R - s) * ns;
    dst[base + e1 + (e1 >> 4)] = make_float2(p.x + q.x, p.y + q.y);
    dst[base + e2 + (e2 >> 4)] = make_float2(p.x - q.x, p.y - q.y);
  }
}

// One Stockham pass of radix R over nb transforms of stride S: butterfly
// (t, j) reads j + r*m/R, twiddles by e^{2 pi i r k/(ns R)} (k = j mod ns),
// runs the R-point DFT and writes (j - k)*R + k + s*ns.
template <int R, int T>
__device__ __forceinline__ void pass(const float2* __restrict__ src,
                                     float2* __restrict__ dst, int nb, int S,
                                     const Pass& ps,
                                     const float2* __restrict__ tw) {
  const int items = (int)ps.items.d;
  const int total = nb * items;
  const int ns = ps.ns;
  const float2* twp = tw + ps.tw;
  for (int u = threadIdx.x; u < total; u += T) {
    const int t = fdiv(u, ps.items);
    const int j = u - t * items;
    const int jq = fdiv(j, ps.nsd);
    const int k = j - jq * ns;
    const int base = t * S;
    float2 v[R];
    constexpr int LR = ilog2(R);
    constexpr bool kPow2 = (R & (R - 1)) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {   // v[r] = input bitrev(r) for powers of 2
      const int rr = kPow2 ? bitrev(r, LR) : r;
      const int e = j + rr * items;
      float2 a = src[base + e + (e >> 4)];
      if (rr > 0 && ns > 1) a = cmul(a, twp[rr * ns + k]);
      v[r] = a;
    }
    const int d = jq * ns * R + k;
    if constexpr (kPow2) {
      dft_pow2<R>(v);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int e = d + s * ns;
        dst[base + e + (e >> 4)] = v[s];
      }
    } else {
      dft_odd_store<R>(v, dst, base, d, ns);
    }
  }
}

// nb unscaled inverse DFTs of sub.m points held in a (stride sub.S), out of
// place between a and b; returns the buffer that holds the result.  Every
// pass ends with __syncthreads().
template <int T>
__device__ float2* sub_ifft(float2* a, float2* b, int nb, const Sub& sub,
                            const float2* tw) {
  for (int i = 0; i < sub.np; ++i) {
    const Pass& ps = sub.p[i];
    switch (ps.R) {
      case 16: pass<16, T>(a, b, nb, sub.S, ps, tw); break;
      case 8: pass<8, T>(a, b, nb, sub.S, ps, tw); break;
      case 4: pass<4, T>(a, b, nb, sub.S, ps, tw); break;
      case 2: pass<2, T>(a, b, nb, sub.S, ps, tw); break;
      case 3: pass<3, T>(a, b, nb, sub.S, ps, tw); break;
      case 5: pass<5, T>(a, b, nb, sub.S, ps, tw); break;
      case 11: pass<11, T>(a, b, nb, sub.S, ps, tw); break;
      default: pass<31, T>(a, b, nb, sub.S, ps, tw); break;
    }
    __syncthreads();
    float2* x = a;
    a = b;
    b = x;
  }
  return a;
}

// 8-byte asynchronous copy from device to shared memory (cp.async), and
// the wait for every copy this thread committed
__device__ __forceinline__ void cp_async8(float2* smem, const float2* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loads in flight per thread in the load and transpose loops: each takes
// kBatch values into registers, then stores them, so one latency of
// device or distributed shared memory covers kBatch values.
constexpr int kBatch = 8;

// Shared memory of one CTA: the two buffers, then `extra` float2 of the
// kernel's own, then the twiddle table.
inline size_t cluster_smem(const Plan& pl, int extra) {
  return ((size_t)2 * pl.buf + extra + pl.ntw) * sizeof(float2);
}

// Transform one row whose product code_f * conj(F) the caller has put in
// buf_a in the column layout (element k1 of local column t at
// at(t, col.S, k1), X index k2 + n2*k1 with k2 = h.c0 + t).  Returns the
// buffer that holds the row-pass result: element j2 of local row t (lag
// (h.j10 + t) + n1*j2) at at(t, row.S, j2).  Every thread of every CTA of
// the cluster calls it; it ends after a __syncthreads().
template <int T>
__device__ float2* row_transform(const Plan& pl, const Share& h,
                                 float2* buf_a, float2* buf_b,
                                 const float2* tw) {
  cg::cluster_group cluster = cg::this_cluster();
  float2* x = sub_ifft<T>(buf_a, buf_b, h.nc, pl.col, tw);
  float2* y = x == buf_a ? buf_b : buf_a;
  cluster_arrive();           // the column results are visible to the cluster
  cluster_wait();
  const int S1 = pl.col.S, S2 = pl.row.S;
  const float2* twA = tw + pl.twA;
  const float2* twB = tw + pl.twB;
  const int E = h.nr * pl.n2;
  for (int e0 = threadIdx.x; e0 < E; e0 += kBatch * T) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T;
      if (e < E) {
        const int k2 = fdiv(e, h.nrd);  // consecutive threads: consecutive j1
        const int jl = e - k2 * h.nr;
        const int src = fdiv(k2, pl.nc_d);
        const float2* rem = cluster.map_shared_rank(x, src);
        v[u] = rem[at(k2 - src * pl.nc, S1, h.j10 + jl)];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T;
      if (e < E) {
        const int k2 = fdiv(e, h.nrd);
        const int jl = e - k2 * h.nr;
        const int tt = (h.j10 + jl) * k2;  // < W
        const int hi = fdiv(tt, pl.n2_d);
        const float2 w = cmul(twA[tt - hi * pl.n2], twB[hi]);
        y[at(jl, S2, k2)] = cmul(v[u], w);
      }
    }
  }
  cluster_arrive();           // this CTA's reads of the others are done
  __syncthreads();
  cluster_wait();             // nobody reads x any more: it may be written
  return sub_ifft<T>(y, x, h.nr, pl.row, tw);
}

// ---- Sub-transforms held in registers (K1, K5) -------------------------
//
// A sub-transform of N = R * Q points (power-of-two N <= 256, and N = 320)
// runs on Q threads that each hold R values, thread t holding x[t + Q*m]
// for m < R, with compile-time sizes throughout:
//
//   step A  v[a] = sum_m x[t + Q m] w_R^(a m)   an R-point DFT in registers
//   step B  v[a] *= w_N^(a t)                   (Q > 1)
//   step C  y[a + R b] = sum_t v_t[a] w_Q^(b t) from the exchange buffer
//           xb[(a*Q + t)*ld + col], on QO threads of RO values each
//
// At a power of two R = min(N, 16) and Q <= R: step C runs on the same Q
// threads, thread t' taking the H = R/Q transforms a = t'*H + h and holding
// y[(t'*H + h) + R*b] in out[h*Q + b].  At N = 320 = 20 * 16 (the rows of
// 81920 = 256 * 320) Q = 16 does not divide R = 20: step A runs on 16
// threads of 20 values (a 20 = 4 * 5-point DFT with compile-time roots),
// step C on QO = 20 threads, thread a holding y[a + 20 b] in out[b] for
// b < 16.  With Q = 1 steps B and C vanish.  The per-thread index math is
// shifts, masks and multiplies by constants.

template <int N>
struct Split {
  static constexpr int R = N < 16 ? N : 16;   // values a thread, step A
  static constexpr int Q = N / R;             // threads a transform, step A
  static constexpr int H = R / Q;             // step-C transforms a thread
  static constexpr int RO = R, QO = Q;        // values, threads: step C
  static constexpr int LR = ilog2(R), LQ = ilog2(Q);
  static constexpr bool kMixed = false;
  static_assert(N >= 1 && (N & (N - 1)) == 0 && Q <= R, "N: 1 .. 256");
};

template <>
struct Split<320> {
  static constexpr int R = 20, Q = 16, H = 1, RO = 16, QO = 20;
  static constexpr int LR = 0, LQ = 4;
  static constexpr bool kMixed = true;
};

// e^{2 pi i k/20}, k < 20, as compile-time constants (float64 rounded once)
__device__ __forceinline__ float2 root20(int k) {
  constexpr float c[20] = {
      1.f, 0.951056516f, 0.809016994f, 0.587785252f, 0.309016994f, 0.f,
      -0.309016994f, -0.587785252f, -0.809016994f, -0.951056516f, -1.f,
      -0.951056516f, -0.809016994f, -0.587785252f, -0.309016994f, 0.f,
      0.309016994f, 0.587785252f, 0.809016994f, 0.951056516f};
  return make_float2(c[k], c[(k + 15) % 20]);
}

// 5-point inverse DFT in registers, natural order in and out, over the
// conjugate pairs as dft_odd_store
__device__ __forceinline__ void dft5(float2 (&v)[5]) {
  const float2 a1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
  const float2 b1 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
  const float2 a2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
  const float2 b2 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
  const float2 x0 = v[0];
  v[0] = make_float2(x0.x + a1.x + a2.x, x0.y + a1.y + a2.y);
#pragma unroll
  for (int s = 1; s <= 2; ++s) {
    const float2 w1 = root_odd<5>(s), w2 = root_odd<5>((2 * s) % 5);
    const float2 p = make_float2(x0.x + a1.x * w1.x + a2.x * w2.x,
                                 x0.y + a1.y * w1.x + a2.y * w2.x);
    const float2 q = make_float2(-(b1.y * w1.y + b2.y * w2.y),
                                 b1.x * w1.y + b2.x * w2.y);
    v[s] = make_float2(p.x + q.x, p.y + q.y);
    v[5 - s] = make_float2(p.x - q.x, p.y - q.y);
  }
}

// 20-point inverse DFT in registers, natural order in and out: with m =
// m4 + 4 m5 and a = a5 + 5 a4, 5-point DFTs over m5, the twiddle
// w20^(a5 m4), then 4-point DFTs over m4
__device__ __forceinline__ void dft20(float2 (&v)[20]) {
  float2 z[4][5];
#pragma unroll
  for (int m4 = 0; m4 < 4; ++m4) {
#pragma unroll
    for (int m5 = 0; m5 < 5; ++m5) z[m4][m5] = v[m4 + 4 * m5];
    dft5(z[m4]);
#pragma unroll
    for (int a5 = 1; a5 < 5; ++a5)
      if (m4 > 0) z[m4][a5] = cmul(z[m4][a5], root20(a5 * m4));
  }
#pragma unroll
  for (int a5 = 0; a5 < 5; ++a5) {
    float2 u[4] = {z[0][a5], z[2][a5], z[1][a5], z[3][a5]};  // bit-reversed
    dft_pow2<4>(u);
#pragma unroll
    for (int a4 = 0; a4 < 4; ++a4) v[a5 + 5 * a4] = u[a4];
  }
}

// the offset of v[m]'s input, x[t + split_in(m)]: bit-reversed for the
// power-of-two DFTs, natural for the 20-point one
template <int N>
__device__ __forceinline__ int split_in(int m) {
  using S = Split<N>;
  if constexpr (S::kMixed) return S::Q * m;
  else return S::Q * bitrev(m, S::LR);
}

// steps A and B on v, loaded as v[m] = x[t + split_in(m)]; wN[k] =
// e^{2 pi i k/N}
template <int N>
__device__ __forceinline__ void split_ab(float2 (&v)[Split<N>::R], int t,
                                         const float2* __restrict__ wN) {
  using S = Split<N>;
  if constexpr (S::kMixed) dft20(v);
  else dft_pow2<S::R>(v);
  if constexpr (S::Q > 1) {
#pragma unroll
    for (int a = 1; a < S::R; ++a) v[a] = cmul(v[a], wN[a * t]);
  }
}

// the exchange store of steps A and B's results
template <int N>
__device__ __forceinline__ void split_put(const float2 (&v)[Split<N>::R],
                                          float2* __restrict__ xb, int ld,
                                          int col, int t) {
  using S = Split<N>;
#pragma unroll
  for (int a = 0; a < S::R; ++a) xb[(a * S::Q + t) * ld + col] = v[a];
}

// step C for thread t (< QO): out[o] = y[split_index(o, t)], o < RO
template <int N, int M>
__device__ __forceinline__ void split_c(float2 (&out)[M],
                                        const float2* __restrict__ xb, int ld,
                                        int col, int t) {
  using S = Split<N>;
  static_assert(M >= S::RO, "step C's outputs");
#pragma unroll
  for (int h = 0; h < S::H; ++h) {
    const int a = t * S::H + h;
    float2 u[S::Q];
#pragma unroll
    for (int s = 0; s < S::Q; ++s)
      u[s] = xb[(a * S::Q + bitrev(s, S::LQ)) * ld + col];
    dft_pow2<S::Q>(u);
#pragma unroll
    for (int b = 0; b < S::Q; ++b) out[h * S::Q + b] = u[b];
  }
}

// the index y[.] that out[o] holds after step C, for thread t
template <int N>
__device__ __forceinline__ int split_index(int o, int t) {
  using S = Split<N>;
  if constexpr (S::kMixed) return t + S::R * o;
  else return t * S::H + (o >> S::LQ) + S::R * (o & (S::Q - 1));
}

// e^{2 pi i k/n}, float64 rounded once
__device__ __forceinline__ float2 unit_root(int k, int n) {
  double s, c;
  sincospi(2.0 * (double)k / (double)n, &s, &c);
  return make_float2((float)c, (float)s);
}

// 16-byte asynchronous copy from device to shared memory, past L1
__device__ __forceinline__ void cp_async16(float2* smem, const float2* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// ---- The cluster's (peak, lowest lag, alignment, sum) ---------------------

struct Best {
  float v;    // the highest value
  int j, a;   // its lowest lag, its alignment
  float s;    // the sum of the values
};

// higher value, then lower lag
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && j < bj);
}

__device__ __forceinline__ void take(Best& c, const Best& o) {
  if (better(o.v, o.j, c.v, c.j)) {
    c.v = o.v;
    c.j = o.j;
    c.a = o.a;
  }
}

// Reduce every thread's b over a cluster of CTAs of T threads, in a fixed
// order: a shuffle tree in each warp, the warps in order, then the ranks
// in order, so the sum (kSum) has the same bits every launch.  Every
// thread of the cluster calls it; thread 0 of rank 0 gets true and the
// result in b.  It ends in a cluster barrier, after which no CTA reads
// another's shared memory.
template <int T, bool kSum>
__device__ __forceinline__ bool cluster_best(Best& b) {
  static_assert(T % 32 == 0, "whole warps");
  __shared__ Best red[T / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best x;
    x.v = __shfl_down_sync(0xffffffffu, b.v, o);
    x.j = __shfl_down_sync(0xffffffffu, b.j, o);
    x.a = __shfl_down_sync(0xffffffffu, b.a, o);
    if constexpr (kSum) b.s += __shfl_down_sync(0xffffffffu, b.s, o);
    take(b, x);
  }
  if ((tid & 31) == 0) red[tid >> 5] = b;
  __syncthreads();
  if (tid == 0) {
    Best c = red[0];
    for (int w = 1; w < T / 32; ++w) {
      take(c, red[w]);
      if constexpr (kSum) c.s += red[w].s;
    }
    red[0] = c;
  }
  cluster.sync();             // every CTA's red[0] is final
  const bool lead = cluster.block_rank() == 0 && tid == 0;
  if (lead) {
    b = red[0];
    for (unsigned r = 1; r < cluster.num_blocks(); ++r) {
      const Best o = *cluster.map_shared_rank(&red[0], r);
      take(b, o);
      if constexpr (kSum) b.s += o.s;
    }
  }
  cluster.sync();             // rank 0 has read the others' red[0]
  return lead;
}

// ---- The surface over Split rows (K1 at 4096 to 81920, K5, K6) ----------
//
// One thread-block cluster of C CTAs per (PRN p, doppler d) walks the
// rows of F[d] (K1: the B blocks; K5 and K6: the G*A combined rows, row
// g*A + a) and computes, per row, IDFT_W(code_f[p] * conj(F[d, row])).
// Each row is a four-step transform W = n1 * n2 (power-of-two n1 <= 256,
// n2 <= 256 or 320) split over the cluster, with no value in device
// memory:
//
//   load     CTA r owns the columns k2 in [r*nc, (r+1)*nc) (nc = n2/C).
//            Its slice of the row, X[k2 + n2*k1] for every k1, was copied
//            into `stage` by cp.async while the previous row transformed;
//            times conj of code_f[p] (in shared memory, or with kCodeRegs
//            in each thread's registers, for the whole cluster life), into
//            registers
//   columns  n1-point IDFTs over k1, in registers and one exchange
//            (Split), then times w^(j1*k2): for a thread's cells j1 = a +
//            16 b the product of w^(a*k2) (made once, in registers) and
//            w^(16*b*k2) (a [Q][nc] table in shared memory), both from two
//            small tables (w^t = A[t mod n2] * B[t div n2]); stored to
//            yb[k2 - r*nc][j1]
//   cluster barrier
//   rows     CTA r owns the rows j1 in [r*nr, (r+1)*nr) (nr = n1/C): it
//            reads Y[j1, k2] for its j1 from the yb of the CTA owning k2
//            (cluster.map_shared_rank), then n2-point IDFTs over k2 in
//            registers and one exchange: x[j1 + n1*j2]
//
// Each thread sums |x| of its R2 lags in registers across the rows (K5:
// across the G groups of one alignment, keeping per lag the running (peak,
// lowest alignment) over the A alignments, kAlign).  The cluster then
// reduces (peak, lowest lag >= lo, its alignment) and, with kSum, the sum
// over the lags >= lo (cluster_best), and writes them scaled by 1/W; with
// kStore (K1's natural-order surface) each thread instead writes its lags'
// sums, scaled by 1/W, to q[p, d, lag]: the NR threads of one transform
// step hold NR consecutive lags, so each store is NR floats in a row.
// Clusters d*P + p: the P clusters of one doppler run side by side and
// read its rows from L2.  All sizes are compile-time: one kernel per
// (n1, n2, C).
//
// With kChunk (K5's builds at W <= 16384; K6's surface stage splits)
// the alignments are split over clusters, a_chunk each: cluster
// (d*nch + c)*P + p walks alignments [c*a_chunk, (c+1)*a_chunk) of
// (p, d), nch = ceil(A / a_chunk), and where nch > 1 the chunks meet in
// one 64-bit atomicMax on key[p, d] (merge_chunk): the peak's float bits
// (non-negative, so they order as the values) above (16383 - lag) << 16
// | (65535 - a), so the highest key is _finalize_max's winner whatever
// the order the chunks arrive in; the chunk that arrives last
// (count[p, d]) decodes it.  key and count are zero at the launch.

struct SurfaceArgs {
  const float2* F;        // [DC, rows, W]
  const float2* code_f;   // [P, W]
  float* peak;            // [P, DC]
  int* idx;               // [P, DC], lag - lo
  int* al;                // [P, DC]: the alignment (kAlign)
  float* sum;             // [P, DC]: the sum over the lags >= lo (kSum)
  float* q;               // [P, DC, W]: the surface, natural lags (kStore)
  unsigned long long* key;  // [P, DC]: the chunks' merge (kChunk, nch > 1)
  unsigned int* count;    // [P, DC]: the chunks merged (kChunk, nch > 1)
  int P, DC, rows, A, lo;
  int a_chunk;            // alignments a cluster (kChunk)
};

// The compile-time layout of W = n1 * n2 over C CTAs (Spec: the power of
// two 2^L, n1 = 2^floor(L/2)).  Index math divides by NC, NR, n2 and W as
// unsigned constants: shifts and masks at a power of two.
template <int N1_, int N2_, int C, bool kCodeRegs_ = false>
struct SpecN {
  static constexpr int N1 = N1_, N2 = N2_;
  static constexpr int W = N1 * N2;
  static constexpr bool kCodeRegs = kCodeRegs_;
  using S1 = Split<N1>;
  using S2 = Split<N2>;
  static constexpr int NC = N2 / C, NR = N1 / C;     // columns, rows a CTA
  // threads of the column role, and of the row role's steps A and C
  static constexpr int TC = NC * S1::Q, TRA = NR * S2::Q, TRC = NR * S2::QO;
  static constexpr int TR = TRA > TRC ? TRA : TRC;
  static constexpr int T = TC > TR ? (TC > 32 ? TC : 32) : (TR > 32 ? TR : 32);
  static constexpr int E = W / C;                    // values a CTA holds
  static constexpr int YS = N1 + 1;                  // yb row stride (odd)
  // shared memory, float2: stage[E], code[E] (not with kCodeRegs), xb[E],
  // yb[NC*YS], wN1[N1], wN2[N2], wA[N2], wS[Q1][NC]
  static constexpr int kOffCode = E;
  static constexpr int kOffXb = kCodeRegs ? E : 2 * E, kOffYb = kOffXb + E;
  static constexpr int kOffW1 = kOffYb + NC * YS;
  static constexpr int kOffW2 = kOffW1 + N1, kOffWA = kOffW2 + N2;
  static constexpr int kOffWS = kOffWA + N2;
  static constexpr size_t kSmem =
      (size_t)(kOffWS + S1::Q * NC) * sizeof(float2);
  static constexpr int kPerSm = (int)((227 * 1024) / (kSmem + 1024));
  // CTAs an SM holds by shared memory, as long as a thread keeps 128
  // registers
  static constexpr int kMinBlocks =
      kPerSm < 1 ? 1 : (kPerSm * T > 512 ? (T >= 512 ? 1 : 512 / T) : kPerSm);
  static_assert(C >= 1 && C <= 16 && NR * C == N1 && NC * C == N2,
                "C CTAs must each own whole rows and columns");
  static_assert(!S1::kMixed && (NC == 1 || NC % 2 == 0),
                "power-of-two columns, staged in pairs");
  static_assert(kSmem <= 227 * 1024, "one CTA's shared memory");
};

template <int L, int C, bool kCodeRegs = false>
using Spec = SpecN<1 << (L / 2), 1 << (L - L / 2), C, kCodeRegs>;

__device__ __forceinline__ int udiv(int x, int d) {
  return (int)((unsigned)x / (unsigned)d);
}

__device__ __forceinline__ int umod(int x, int d) {
  return (int)((unsigned)x % (unsigned)d);
}

// (peak, lag, alignment) of one alignment chunk into key[o]; the chunk
// that arrives last writes the winner of all nch, scaled by 1/W
__device__ __forceinline__ void merge_chunk(const SurfaceArgs& s, size_t o,
                                            const Best& b, int nch, int W) {
  const unsigned long long k =
      (unsigned long long)__float_as_uint(b.v) << 32 |
      (unsigned)(16383 - (b.j - s.lo)) << 16 | (unsigned)(65535 - b.a);
  atomicMax(s.key + o, k);
  __threadfence();            // the key before the count
  if (atomicAdd(s.count + o, 1u) + 1 == (unsigned)nch) {
    __threadfence();
    const unsigned long long w = atomicMax(s.key + o, 0ull);  // every chunk's
    s.peak[o] = __uint_as_float((unsigned)(w >> 32)) / (float)W;
    s.idx[o] = 16383 - (int)((w >> 16) & 0xffffu);
    s.al[o] = 65535 - (int)(w & 0xffffu);
  }
}

template <class K, bool kAlign, bool kSum, bool kStore = false,
          bool kChunk = false>
__device__ __forceinline__ void surface_rows(const SurfaceArgs& s) {
  using S1 = typename K::S1;
  using S2 = typename K::S2;
  constexpr int N1 = K::N1, N2 = K::N2, W = K::W, NC = K::NC, NR = K::NR;
  constexpr int R1 = S1::R, Q1 = S1::Q, R2 = S2::R, Q2 = S2::Q;
  constexpr int RO2 = S2::RO;                // lags a row-role thread sums
  constexpr int C = N2 / NC;
  constexpr bool kCodeRegs = K::kCodeRegs;
  static_assert(!kChunk || (kAlign && !kSum && !kStore && W <= 16384),
                "alignment chunks: K6's key holds a lag in 14 bits");
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / C;
  const int p = item % s.P;
  const int A = kAlign ? s.A : 1;
  // the alignments [a0, a1) of this cluster: all of them but with kChunk
  const int nch = kChunk ? (A + s.a_chunk - 1) / s.a_chunk : 1;
  const int d = item / s.P / nch;
  const int a0 = kChunk ? (item / s.P % nch) * s.a_chunk : 0;
  const int a1 = kChunk ? min(A, a0 + s.a_chunk) : A;
  const int tid = threadIdx.x;
  float2* stage = smem;
  float2* code = smem + K::kOffCode;
  float2* xb = smem + K::kOffXb;
  float2* yb = smem + K::kOffYb;
  float2* wN1 = smem + K::kOffW1;
  float2* wN2 = smem + K::kOffW2;
  float2* wA = smem + K::kOffWA;
  float2* wS = smem + K::kOffWS;
  const int G = s.rows / A;
  const int c0 = rank * NC;
  // column role (tid < TC): column c0 + col, thread t1 of its transform;
  // row role (tid < TR): row j1 = rank*NR + jl, thread t2 of its transform
  const int t1 = udiv(tid, NC), col = umod(tid, NC);
  const int t2 = udiv(tid, NR), jl = umod(tid, NR);
  const int j1 = rank * NR + jl;

  // this CTA's slice of row i of F into stage, [k1][col]
  auto stage_row = [&](int i) {
    const float2* row = s.F + ((size_t)d * s.rows + i) * W + c0;
    if constexpr (NC >= 2) {
      for (int e = tid; e < K::E / 2; e += K::T) {
        const int k1 = udiv(e, NC / 2), c = umod(e, NC / 2) * 2;
        cp_async16(stage + k1 * NC + c, row + c + (size_t)N2 * k1);
      }
    } else {
      for (int k1 = tid; k1 < N1; k1 += K::T)
        cp_async8(stage + k1, row + (size_t)N2 * k1);
    }
    cp_async_commit();
  };

  stage_row(a0);
  for (int i = tid; i < N1; i += K::T) wN1[i] = unit_root(i, N1);
  for (int i = tid; i < N2; i += K::T) {
    wN2[i] = unit_root(i, N2);
    wA[i] = unit_root(i, W);
  }
  const float2* cf = s.code_f + (size_t)p * W + c0;
  // the code values of the column role's cells: with kCodeRegs thread
  // (t1, col) keeps its R1 of them in registers, cr[m] at stage index
  // (t1 + Q1 bitrev(m))*NC + col; else the CTA's slice, [k1][col]
  [[maybe_unused]] float2 cr[kCodeRegs ? R1 : 1];
  if constexpr (kCodeRegs) {
    if (tid < K::TC) {
#pragma unroll
      for (int m = 0; m < R1; ++m)
        cr[m] = __ldg(cf + col + (size_t)N2 * (t1 + Q1 * bitrev(m, S1::LR)));
    }
  } else {
    for (int e = tid; e < K::E; e += K::T) {
      const int k1 = udiv(e, NC), c = umod(e, NC);
      code[e] = __ldg(cf + c + (size_t)N2 * k1);
    }
  }
  __syncthreads();
  // The four-step twiddle w^(j1*k2) of step C's cell out[h*Q1 + b] (j1 =
  // t1*H1 + h + R1*b) is gb[h] * wS[b][col]: gb[h] = w^((t1*H1 + h)*k2)
  // in registers, wS[b][col] = w^(R1*b*k2) in shared memory, each from
  // the two small tables, w^t = wA[t mod n2] * wN1[t div n2].
  auto w_of = [&](int t) {
    t = umod(t, W);
    return cmul(wA[umod(t, N2)], wN1[udiv(t, N2)]);
  };
  float2 gb[S1::H];
#pragma unroll
  for (int h = 0; h < S1::H; ++h)
    gb[h] = w_of(tid < K::TC ? (t1 * S1::H + h) * (c0 + col) : 0);
  for (int e = tid; e < Q1 * NC; e += K::T)
    wS[e] = w_of(R1 * udiv(e, NC) * (c0 + umod(e, NC)));
  cluster_arrive();           // pairs with the first row's wait

  // per lag: the sum over the rows (of one alignment), and with kAlign the
  // best such sum over the alignments so far and its alignment (16 bits,
  // two to a register: A <= 65535)
  float acc[RO2];
  [[maybe_unused]] float best[kAlign ? RO2 : 1];
  [[maybe_unused]] uint32_t besta[kAlign ? (RO2 + 1) / 2 : 1];
  if constexpr (kAlign) {
#pragma unroll
    for (int o = 0; o < RO2; ++o) best[o] = -INFINITY;
#pragma unroll
    for (int o = 0; o < (RO2 + 1) / 2; ++o) besta[o] = 0;
  }
  for (int a = a0; a < a1; ++a) {
#pragma unroll
    for (int o = 0; o < RO2; ++o) acc[o] = 0.f;
    for (int g = 0; g < G; ++g) {
      cp_async_wait_all();
      __syncthreads();        // stage holds row g*A + a; xb is free
      float2 v[R1];
      if (tid < K::TC) {
#pragma unroll
        for (int m = 0; m < R1; ++m) {
          const int e = (t1 + Q1 * bitrev(m, S1::LR)) * NC + col;
          float2 c;
          if constexpr (kCodeRegs) c = cr[m];
          else c = code[e];
          v[m] = cmul_conj(c, stage[e]);
        }
        split_ab<N1>(v, t1, wN1);
        if constexpr (Q1 > 1) split_put<N1>(v, xb, NC, col, t1);
      }
      __syncthreads();        // stage read out, xb complete
      if (g + 1 < G)
        stage_row((g + 1) * A + a);
      else if (a + 1 < a1)
        stage_row(a + 1);
      if (tid < K::TC) {
        if constexpr (Q1 > 1) split_c<N1>(v, xb, NC, col, t1);
#pragma unroll
        for (int o = 0; o < R1; ++o)
          v[o] = cmul(v[o], cmul(gb[o / Q1], wS[(o % Q1) * NC + col]));
      }
      cluster_wait();         // the last row's readers of yb are done
      if (tid < K::TC) {
#pragma unroll
        for (int o = 0; o < R1; ++o)
          yb[col * K::YS + split_index<N1>(o, t1)] = v[o];
      }
      cluster_arrive();
      cluster_wait();         // every CTA's yb holds this row's columns
      float2 z[R2];                // step C's RO2 <= R2 outputs reuse it
      if (tid < K::TRA) {
#pragma unroll
        for (int m = 0; m < R2; ++m) {
          const int k2 = t2 + split_in<N2>(m);
          const float2* src = cluster.map_shared_rank(
              yb + umod(k2, NC) * K::YS + j1, udiv(k2, NC));
          z[m] = *src;
        }
        split_ab<N2>(z, t2, wN2);
        if constexpr (Q2 > 1) split_put<N2>(z, xb, NR, jl, t2);
      }
      cluster_arrive();       // this CTA's reads of the others are done
      __syncthreads();        // xb complete
      if (tid < K::TRC) {
        if constexpr (Q2 > 1) split_c<N2>(z, xb, NR, jl, t2);
#pragma unroll
        for (int o = 0; o < RO2; ++o)
          acc[o] += cabs_approx(z[o]);
      }
    }
    if constexpr (kAlign) {
#pragma unroll
      for (int o = 0; o < RO2; ++o) {
        if (acc[o] > best[o]) {  // a ascending: the lowest alignment on ties
          const int sh = (o & 1) * 16;
          best[o] = acc[o];
          besta[o / 2] =
              (besta[o / 2] & ~(0xffffu << sh)) | ((uint32_t)a << sh);
        }
      }
    }
  }
  cluster_wait();             // nobody reads this CTA's yb any more

  if constexpr (kStore) {
    static_assert(!kAlign, "the stored surface has one alignment");
    if (tid < K::TRC) {
      float* o = s.q + ((size_t)p * s.DC + d) * W + j1;
#pragma unroll
      for (int o2 = 0; o2 < RO2; ++o2)
        o[N1 * split_index<N2>(o2, t2)] = acc[o2] / (float)W;
    }
    return;
  }

  // (peak, lowest lag >= lo reaching it, its alignment, sum) over the
  // thread's lags, then the cluster
  Best b = {-INFINITY, W, 0, 0.f};
  if (tid < K::TRC) {
#pragma unroll
    for (int o = 0; o < RO2; ++o) {
      const int j = j1 + N1 * split_index<N2>(o, t2);
      float val;
      if constexpr (kAlign) val = best[o];
      else val = acc[o];
      if (j >= s.lo) {
        if (better(val, j, b.v, b.j)) {
          b.v = val;
          b.j = j;
          if constexpr (kAlign)
            b.a = (int)((besta[o / 2] >> ((o & 1) * 16)) & 0xffffu);
        }
        if constexpr (kSum) b.s += val;
      }
    }
  }
  if (cluster_best<K::T, kSum>(b)) {
    const size_t o = (size_t)p * s.DC + d;
    if (kChunk && nch > 1) {
      merge_chunk(s, o, b, nch, W);
      return;
    }
    s.peak[o] = b.v / (float)W;   // exact at a power of two W
    s.idx[o] = b.j - s.lo;
    if constexpr (kAlign) s.al[o] = b.a;
    if constexpr (kSum) s.sum[o] = b.s / (float)W;
  }
}

// ---- The surface over run-time rows (K1 and K5 at 163840) ---------------
//
// For the windows surface_rows has no build for (163840 = 320 x 512 for
// GPS L2CM, whose 320-point rows would need 640 threads a CTA even on 16
// CTAs): one cluster per (p, d) walks the rows of F[d] (K1: the B
// blocks; K5: row g*A + a, all G groups of one alignment, then the next),
// each through row_transform over the fewest CTAs, up to 16, whose two
// buffers fit (wide_plan).  There is no room beside the buffers for a
// staged copy of the next row, so each row's slice of F and the code are
// read from L2 in batches.  A thread sums |x| of its kWPer lags of the
// row layout in registers across the rows (K5: the G groups of one
// alignment, then folds the sums into its running per-lag (peak, lowest
// alignment), kAlign); the cluster then reduces as surface_rows does.
// With kStore (K1's natural-order surface) consecutive threads take
// consecutive local rows t of one j2 (lag j10 + t + n1*j2), so that each
// thread's sums, scaled by 1/W, are stored to q[p, d, lag] in runs of nr
// floats; otherwise consecutive j2 of one row.

constexpr int kWT = 384;                // threads a CTA
constexpr int kWPer = 27;               // lags a thread
constexpr int kWMaxE = kWT * kWPer;     // lags a CTA
constexpr int kMaxCluster = 16;

struct WideArgs {
  const float2* F;        // [DC, rows, W]
  const float2* code_f;   // [P, W]
  const float2* tw;       // ops/acquire2.cluster_twiddle_table(n1, n2)
  float* peak;            // [P, DC]
  int* idx;               // [P, DC], lag - lo
  int* al;                // [P, DC]: the alignment (kAlign)
  float* sum;             // [P, DC]: the sum over the lags >= lo (kSum)
  float* q;               // [P, DC, W]: the surface, natural lags (kStore)
  int P, DC, rows, A, lo;
  Plan plan;
};

template <bool kAlign, bool kSum, bool kStore = false>
__device__ __forceinline__ void wide_rows(const WideArgs& s) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Plan& pl = s.plan;
  const int W = pl.W, n1 = pl.n1, n2 = pl.n2;
  const Share h = share_of(pl, (int)cluster.block_rank());
  const int El = h.nc * n1;               // values loaded (column layout)
  const int Ea = h.nr * n2;               // lags summed (row layout)
  const int item = blockIdx.x / pl.C;     // d*P + p
  const int p = item % s.P;
  const int d = item / s.P;
  float2* buf_a = smem;
  float2* buf_b = smem + pl.buf;
  float2* tw = buf_b + pl.buf;
  const int tid = threadIdx.x;
  for (int i = tid; i < pl.ntw; i += kWT) tw[i] = s.tw[i];
  const float2* cf = s.code_f + (size_t)p * W + h.c0;
  const int A = kAlign ? s.A : 1;
  const int G = s.rows / A;
  // element e of the thread's lags: local row t, column j2 (lag j10 + t +
  // n1*j2) of the row-pass result
  auto cell = [&](int e, int& t, int& j2) {
    if constexpr (kStore) {
      j2 = fdiv(e, h.nrd);
      t = e - j2 * h.nr;
    } else {
      t = fdiv(e, pl.n2_d);
      j2 = e - t * n2;
    }
  };

  // per lag: the sum over the rows (of one alignment), and with kAlign the
  // best such sum over the alignments so far and its alignment (16 bits,
  // two to a register: A <= 65535)
  float acc[kWPer];
  [[maybe_unused]] float best[kAlign ? kWPer : 1];
  [[maybe_unused]] uint32_t besta[kAlign ? (kWPer + 1) / 2 : 1];
  if constexpr (kAlign) {
#pragma unroll
    for (int i = 0; i < kWPer; ++i) best[i] = -INFINITY;
#pragma unroll
    for (int i = 0; i < (kWPer + 1) / 2; ++i) besta[i] = 0;
  }
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int i = 0; i < kWPer; ++i) acc[i] = 0.f;
    for (int g = 0; g < G; ++g) {
      const float2* fb = s.F + ((size_t)d * s.rows + g * A + a) * W + h.c0;
      __syncthreads();           // tw in place; the last row read out
      for (int e0 = tid; e0 < El; e0 += kBatch * kWT) {
        float2 c[kBatch], f[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kWT;
          if (e < El) {
            const int k1 = fdiv(e, h.ncd);
            const size_t o = (size_t)(e - k1 * h.nc) + (size_t)n2 * k1;
            c[u] = __ldg(cf + o);
            f[u] = __ldg(fb + o);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kWT;
          if (e < El) {
            const int k1 = fdiv(e, h.ncd);
            buf_a[at(e - k1 * h.nc, pl.col.S, k1)] = cmul_conj(c[u], f[u]);
          }
        }
      }
      __syncthreads();           // the row is in buf_a
      const float2* z = row_transform<kWT>(pl, h, buf_a, buf_b, tw);
#pragma unroll
      for (int i = 0; i < kWPer; ++i) {
        const int e = tid + i * kWT;
        if (e < Ea) {
          int t, j2;
          cell(e, t, j2);
          acc[i] += cabs_approx(z[at(t, pl.row.S, j2)]);
        }
      }
    }
    if constexpr (kAlign) {
#pragma unroll
      for (int i = 0; i < kWPer; ++i) {
        if (acc[i] > best[i]) {  // a ascending: the lowest alignment on ties
          const int sh = (i & 1) * 16;
          best[i] = acc[i];
          besta[i / 2] =
              (besta[i / 2] & ~(0xffffu << sh)) | ((uint32_t)a << sh);
        }
      }
    }
  }

  if constexpr (kStore) {
    static_assert(!kAlign, "the stored surface has one alignment");
    float* o = s.q + ((size_t)p * s.DC + d) * W + h.j10;
    const float fw = (float)W;
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int e = tid + i * kWT;
      if (e < Ea) {
        int t, j2;
        cell(e, t, j2);
        o[t + n1 * j2] = acc[i] / fw;
      }
    }
    return;   // row_transform's last cluster barrier: no CTA reads ours
  }

  // (peak, lowest lag >= lo reaching it, its alignment, sum) over the
  // thread's lags (element e of the row layout is lag j10 + t + n1*j2),
  // then the cluster
  Best bst = {-INFINITY, W, 0, 0.f};
#pragma unroll
  for (int i = 0; i < kWPer; ++i) {
    const int e = tid + i * kWT;
    if (e < Ea) {
      int t, j2;
      cell(e, t, j2);
      const int j = h.j10 + t + n1 * j2;
      float val;
      if constexpr (kAlign) val = best[i];
      else val = acc[i];
      if (j >= s.lo) {
        if (better(val, j, bst.v, bst.j)) {
          bst.v = val;
          bst.j = j;
          if constexpr (kAlign)
            bst.a = (int)((besta[i / 2] >> ((i & 1) * 16)) & 0xffffu);
        }
        if constexpr (kSum) bst.s += val;
      }
    }
  }
  if (cluster_best<kWT, kSum>(bst)) {
    const size_t o = (size_t)p * s.DC + d;
    const float fw = (float)W;
    s.peak[o] = bst.v / fw;
    s.idx[o] = bst.j - s.lo;
    if constexpr (kAlign) s.al[o] = bst.a;
    if constexpr (kSum) s.sum[o] = bst.s / fw;
  }
}

// m made of the factors 2, 3, 5, 11 and 31 only
inline bool radix_ok(int m) {
  static const int kPrimes[] = {2, 3, 5, 11, 31};
  for (int r : kPrimes)
    while (m % r == 0) m /= r;
  return m == 1;
}

// ops/acquire2.wide_split: the largest n1 <= sqrt(W) dividing W with n1
// and n2 = W / n1 made of the pass radices and n2 <= 4096
inline bool wide_split(int W, int* n1, int* n2) {
  int r = 1;
  while ((long long)(r + 1) * (r + 1) <= W) ++r;
  for (int a = r; a > 1; --a) {
    if (W % a || W / a > 4096 || !radix_ok(a) || !radix_ok(W / a)) continue;
    *n1 = a;
    *n2 = W / a;
    return true;
  }
  return false;
}

inline size_t wide_smem(const Plan& pl) { return cluster_smem(pl, 0); }

// wide_rows' plan of W over C CTAs (0: the fewest, up to 16, whose lags
// fit kWMaxE a CTA and whose buffers fit its shared memory)
inline bool wide_plan(Plan& pl, int W, int C) {
  int n1, n2;
  if (W < 2 || C < 0 || C > kMaxCluster || !wide_split(W, &n1, &n2))
    return false;
  for (int c = C ? C : 1; c <= (C ? C : kMaxCluster); ++c) {
    if (make_plan(pl, W, n1, n2, c) && pl.nr * n2 <= kWMaxE &&
        wide_smem(pl) <= kMaxSmem)
      return true;
  }
  return false;
}

}  // namespace
}  // namespace acqc
