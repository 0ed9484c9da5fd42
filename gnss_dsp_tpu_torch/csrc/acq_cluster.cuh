// A row transform held across a thread-block cluster, shared by the
// acquisition kernels K5 (acquire_coh_spec.cu) and K7 (acquire.cu).
//
// A surface row is the unscaled inverse DFT of W complex values,
// IDFT_W(code_f[p] * conj(F_row)).  At W = 16384 the row (128 KiB) leaves
// one CTA per SM, and at W = 30690 (245,520 bytes) it does not fit one CTA
// at all.  Here the row is split over the C CTAs of a cluster and runs as a
// four-step transform W = n1 * n2 whose transpose goes through distributed
// shared memory (DSMEM), so no value of a row goes to device memory.  Two
// cores share the cluster barriers, the register DFTs with compile-time
// roots and the asynchronous copies below: K7's row_transform, for any W
// whose factors are 2, 3, 5, 11, 31, with run-time sizes (described
// here), and K5's power-of-two Split at the end of the file, with
// compile-time sizes and the values in registers (acquire_coh_spec.cu).
// K7's row_transform:
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
// roots).  The radix order is next_radix of acq_wide.cuh, which
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

namespace acqc {
namespace cg = cooperative_groups;
namespace {   // each translation unit keeps its own instantiations

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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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

// ---- Power-of-two rows held in registers (K5) ----------------------------
//
// At a power-of-two W every sub-transform is N = R * Q points (N <= 256):
// Q threads share one transform, thread t holding x[t + Q*m] for m < R
// (R = min(N, 16) values, compile-time sizes throughout):
//
//   step A  v[a] = sum_m x[t + Q m] w_R^(a m)   an R-point DFT in registers
//   step B  v[a] *= w_N^(a t)                   (Q > 1)
//   step C  y[a + R b] = sum_t v_t[a] w_Q^(b t) thread t' takes the H = R/Q
//           a = t'*H + h, reads v_t[a] from the exchange buffer xb[(a*Q +
//           t)*ld + col] for t < Q and runs H Q-point DFTs: it holds y[(t'*H
//           + h) + R*b] in out[h*Q + b]
//
// With Q = 1 steps B and C vanish.  The per-thread index math is shifts
// and masks by constants.

template <int N>
struct Split {
  static constexpr int R = N < 16 ? N : 16;   // values a thread
  static constexpr int Q = N / R;             // threads a transform
  static constexpr int H = R / Q;             // step-C transforms a thread
  static constexpr int LR = ilog2(R), LQ = ilog2(Q);
  static_assert(N >= 1 && (N & (N - 1)) == 0 && Q <= R, "N: 1 .. 256");
};

// steps A and B on v, loaded as v[m] = x[t + Q bitrev(m)]; wN[k] =
// e^{2 pi i k/N}
template <int N>
__device__ __forceinline__ void split_ab(float2 (&v)[Split<N>::R], int t,
                                         const float2* __restrict__ wN) {
  using S = Split<N>;
  dft_pow2<S::R>(v);
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

// step C: out[h*Q + b] = y[(t*H + h) + R*b]
template <int N>
__device__ __forceinline__ void split_c(float2 (&out)[Split<N>::R],
                                        const float2* __restrict__ xb, int ld,
                                        int col, int t) {
  using S = Split<N>;
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
  return t * S::H + (o >> S::LQ) + S::R * (o & (S::Q - 1));
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

}  // namespace
}  // namespace acqc
