// Extended-coherent acquisition surface, per block (kernel K6).  The
// spectral-combine kernel K5 has its own file, acquire_coh_spec.cu.
//
// K6 replaces pallas_acquire_coh.py::corr_surface_coh (pallas_call at
// :508, body _kernel :333).  There the per-block complex surfaces are
// rotated, weighted by the overlay and summed over each group of m_coh
// blocks before the magnitude:
//
//     s_a[j] = (1/W) * sum_g | sum_m sec[a, m] rot[d, m]
//                                     IDFT_W( code_f[p] * conj(F[d, m]) ) [j] |
//
// It then reports, per (p, d), the highest s_a[j] over alignments and the
// lags j >= lo = W - n_valid (all lags when n_valid = 0), the lowest such
// lag, then the lowest alignment (the TPU kernel's _finalize_max ties), with
// the lag counted from lo.
//
// The IDFT is linear, so each group's sum is ONE IDFT of the combined
// spectrum code_f[p] * conj(C[d, g*A + a]) with
//
//     C[d, g*A + a] = sum_{m < m_coh} sec[a, g*M + m] conj(rot[d, g*M + m])
//                                     F[d, g*M + m]
//
// which does not depend on the PRN.  Two stages, one launch each:
//
// 1. combine: C for every (d, g), a complex [A x m_coh] . [m_coh x W]
//    product, into device memory in the row order K5 takes (g*A + a).
//    Each F value is read from device memory once.  A = 1 (GPS L1, no
//    overlay): combine_stream, a streaming sum (each thread 4 lags, every
//    block of its group); A >= 2 (Xona X1P: A = m_coh = 100): combine_mma,
//    the product on the tensor cores in 3xTF32 (float32's accuracy), a CTA
//    per (128 lags, 112 alignments, d, g) that stages F tiles of kBK
//    blocks by cp.async and splits each operand once into shared memory.
//    On an H100 at X1P's shape it took 1.15 ms where a float32 register
//    tile took 1.55 (PERF.md section 6, the `fp32` variant).
// 2. surface: K5's own launch (acquire_coh_spec.cu, acq_coh_spec) over C,
//    its alignment loop on acq_cluster.cuh's register core: one cluster
//    per (p, d) and alignment chunk walks the G rows of each of its
//    alignments, sums |x| in registers, keeps per lag the running (peak,
//    lowest alignment), and the cluster reduces it (cluster_best).  Where
//    P x DC clusters would not fill the card (X1P: 1 PRN x 70 dopplers),
//    ops/acquire_coh.blk_plan splits the alignments over clusters and
//    their (peak, lag, alignment) meet in one 64-bit atomicMax
//    (merge_chunk).  No [P, DC, A] scratch and no second reduction kernel.
//
// What bounds it on the card: at A = 1 the bytes (F read once, C written
// and read once) and the surface's transforms; at A = 100 the combine's
// operations (8 a block value and alignment; on the tensor cores three
// TF32 products of each) against the transforms of G*A rows a (p, d).
//
// W must be a power of two, 2 <= W <= 16384; A <= 65535.

#include "acq_cluster.cuh"

namespace {

// ---- stage 1: the combine ------------------------------------------------

struct CombineArgs {
  const float2* F;       // [DC, B, W]
  const float* cosang;   // [DC, B]
  const float* sinang;   // [DC, B]
  const float* sec;      // [A, B]
  float2* C;             // [DC, G*A, W], row g*A + a
  int B, A, M, W, G;
};

// sec[a, m] conj(rot[d, m]) at global block m
__device__ __forceinline__ float2 weight(const CombineArgs& c, int d, int a,
                                         int m) {
  const size_t dm = (size_t)d * c.B + m;
  const float sg = __ldg(c.sec + (size_t)a * c.B + m);
  return make_float2(sg * __ldg(c.cosang + dm), -sg * __ldg(c.sinang + dm));
}

// acc += w f as four fused multiply-adds (written as one expression, the
// difference of products would round once more and take a third op)
__device__ __forceinline__ void cmac(float2& acc, float2 w, float2 f) {
  acc.x = fmaf(w.x, f.x, acc.x);
  acc.x = fmaf(-w.y, f.y, acc.x);
  acc.y = fmaf(w.x, f.y, acc.y);
  acc.y = fmaf(w.y, f.x, acc.y);
}

// A = 1: grid DC * G * nw, nw = ceil(W / (kST * kSV)); block dg * nw + t
// of (d, g) = (dg / G, dg % G); thread t sums lags w0 + t + kST*v over the
// group's M blocks
constexpr int kST = 256, kSV = 4;

__global__ void __launch_bounds__(kST) combine_stream(CombineArgs c) {
  const int nw = (c.W + kST * kSV - 1) / (kST * kSV);
  const int dg = blockIdx.x / nw;
  const int d = dg / c.G, g = dg % c.G;
  const int w0 = (blockIdx.x % nw) * kST * kSV + threadIdx.x;
  const float2* f = c.F + ((size_t)d * c.B + (size_t)g * c.M) * c.W;
  float2 acc[kSV];
#pragma unroll
  for (int v = 0; v < kSV; ++v) acc[v] = make_float2(0.f, 0.f);
  for (int m = 0; m < c.M; ++m) {
    const float2 w = weight(c, d, 0, g * c.M + m);
    const float2* row = f + (size_t)m * c.W;
#pragma unroll
    for (int v = 0; v < kSV; ++v) {
      const int e = w0 + v * kST;
      if (e < c.W) cmac(acc[v], w, __ldg(row + e));
    }
  }
  float2* out = c.C + (size_t)dg * c.W;
#pragma unroll
  for (int v = 0; v < kSV; ++v) {
    const int e = w0 + v * kST;
    if (e < c.W) out[e] = acc[v];
  }
}

constexpr int kBK = 16;                    // blocks a staged F tile

// A >= 2 on the tensor cores, 3xTF32: the complex product as the real one
//
//   [Re C; Im C][2a + c, w] = sum_k Wr[2a + c, k] Fr[k, w],  k = 2m + c'
//   Wr = [[wr, -wi], [wi, wr]] a (a, m),  Fr[2m + c', w] = F[m, w].c'
//
// by mma.sync m16n8k8 (tf32 in, float32 sums), each operand x split into
// big = tf32(x) and small = tf32(x - big) and the product taken as small
// big + big small + big big: float32's accuracy (one TF32 product keeps
// ~11 bits, the rtol 1e-4 the surfaces are held to needs more).  Grid
// (DC * G * nw, ceil(A / (16 MW))), nw = ceil(W / (kLG kMN)); a CTA of
// kLG x MW warps: warp (l, v) owns real rows 32 v .. + 32 (two m16
// tiles, 16 alignments) and the kMN lags of group l (kMN / 8 n8 tiles).
// Each tile of kBK blocks: F copied raw by cp.async, then split once into
// big and small planes Fr[k][w] (row stride kFK: a fragment's 32 loads
// hit 32 banks); the weights, loaded into registers while the tile before
// is summed, split once into planes of wr and wi [a][m], which the kLG
// lag groups share: a lane's Wr element is one of them, its sign flipped
// for -wi (exact in tf32), both fixed by the lane.
constexpr int kMN = 64;                    // lags a warp
constexpr int kLG = 2;                     // lag groups a CTA
constexpr int kMaxMW = 7;                  // warps a lag group (112 alignments)
constexpr int kFK = kLG * kMN + 8;         // Fr plane row stride, words
constexpr int kWA = kBK + 1;               // wr / wi plane row stride, words
constexpr int kMU = kBK * 16 / (32 * kLG); // weights a thread stages a tile

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// at most 448 threads: up to 146 registers a thread
__global__ void __launch_bounds__(32 * kLG * kMaxMW, 1)
    combine_mma(CombineArgs c) {
  constexpr int NT = kMN / 8, NH = NT / 2, BW = kLG * kMN;
  extern __shared__ __align__(16) float2 sm[];
  const int MW = blockDim.x / (32 * kLG), AL = 16 * MW;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = (tid >> 5) % MW, lg = (tid >> 5) / MW, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;        // fragment group, thread
  const int nw = (c.W + BW - 1) / BW;
  const int dg = blockIdx.x / nw;
  const int d = dg / c.G, g = dg % c.G;
  const int w0 = (blockIdx.x % nw) * BW, a0 = blockIdx.y * AL;
  // shared memory: raw F [kBK][BW] float2, then the tf32 planes Fr big and
  // small [2 kBK][kFK], wr big and small, wi big and small [AL][kWA]
  float2* raw = sm;
  uint32_t* fb = reinterpret_cast<uint32_t*>(sm + kBK * BW);
  uint32_t* fsm = fb + 2 * kBK * kFK;
  // 4 planes of AL * kWA, 8 words apart in bank: a fragment's loads from
  // the wr and the wi plane at one (a, m) fall in different banks
  uint32_t* wp = fsm + 2 * kBK * kFK;
  const int wplane = AL * kWA + 8;
  const float2* f = c.F + ((size_t)d * c.B + (size_t)g * c.M) * c.W + w0;
  const int nk = (c.M + kBK - 1) / kBK;
  const int wl = min(BW, c.W - w0);

  auto stage = [&](int k) {
    for (int e = tid; e < kBK * BW / 2; e += nt) {
      const int m = e / (BW / 2), w = (e % (BW / 2)) * 2;
      float2* dst = raw + m * BW + w;
      const int mm = k * kBK + m;
      if (mm < c.M && w < wl)
        acqc::cp_async16(dst, f + (size_t)mm * c.W + w);
      else
        dst[0] = dst[1] = make_float2(0.f, 0.f);
    }
    acqc::cp_async_commit();
  };
  // the weights (m, a) = (e % kBK, e / kBK), e = tid + nt u: their (sec,
  // cos, sin) into registers, zeros past M and A
  float wr[kMU][3];
  auto load_w = [&](int k) {
#pragma unroll
    for (int u = 0; u < kMU; ++u) {
      const int e = tid + nt * u;
      const int m = k * kBK + e % kBK, a = a0 + e / kBK;
      const bool in = m < c.M && a < c.A;
      const size_t dm = (size_t)d * c.B + g * c.M + m;
      wr[u][0] = in ? __ldg(c.sec + (size_t)a * c.B + g * c.M + m) : 0.f;
      wr[u][1] = in ? __ldg(c.cosang + dm) : 0.f;
      wr[u][2] = in ? __ldg(c.sinang + dm) : 0.f;
    }
  };
  auto put = [](uint32_t* big, uint32_t* small, int i, float x) {
    const uint32_t b = tf32(x);
    big[i] = b;
    small[i] = tf32(x - __uint_as_float(b));
  };
  // the planes of the staged tile: Fr from raw, wr and wi from registers
  auto split = [&]() {
    for (int e = tid; e < kBK * BW; e += nt) {
      const int m = e / BW, w = e % BW;
      const float2 v = raw[e];
      put(fb, fsm, 2 * m * kFK + w, v.x);
      put(fb, fsm, (2 * m + 1) * kFK + w, v.y);
    }
#pragma unroll
    for (int u = 0; u < kMU; ++u) {
      const int e = tid + nt * u;
      const int i = (e / kBK) * kWA + e % kBK;
      put(wp, wp + wplane, i, wr[u][0] * wr[u][1]);
      put(wp + 2 * wplane, wp + 3 * wplane, i, -wr[u][0] * wr[u][2]);
    }
  };
  // a lane's Wr elements (row 2a + comp, column 2m + cq): wr where comp ==
  // cq, else wi, negated for (comp, cq) = (0, 1)
  const int comp = gq & 1, cq = tq & 1;
  const uint32_t* wab = wp + (comp == cq ? 0 : 2 * wplane);
  const uint32_t sgn = comp == 0 && cq == 1 ? 0x80000000u : 0u;

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  stage(0);
  load_w(0);
  for (int k = 0; k < nk; ++k) {
    acqc::cp_async_wait_all();
    __syncthreads();          // raw holds tile k; the planes are free
    split();
    __syncthreads();          // the planes hold tile k; raw is free
    if (k + 1 < nk) {
      stage(k + 1);
      load_w(k + 1);
    }
    const int sk = (min(kBK, c.M - k * kBK) + 3) / 4;   // k8 steps
#pragma unroll
    for (int s8 = 0; s8 < kBK / 4; ++s8) {
      if (s8 == sk) break;
      // a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4):
      // alignment 16 warp + 8 i + g / 2 (+ 4), block 4 s8 + t / 2 (+ 2)
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = (16 * warp + 8 * i + (gq >> 1) + 4 * (q & 1)) * kWA +
                        4 * s8 + (tq >> 1) + 2 * (q >> 1);
          ab[i][q] = wab[e] ^ sgn;
          as[i][q] = wab[e + wplane] ^ sgn;
        }
      }
      // b0 (k t, n g), b1 (k t + 4, n g); half the n8 tiles at a time,
      // the three products term by term: consecutive mma's add into
      // different accumulators
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bb[NH][2], bs[NH][2];
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int e = (8 * s8 + tq) * kFK + lg * kMN + 8 * (h * NH + j) + gq;
          bb[j][0] = fb[e];
          bs[j][0] = fsm[e];
          bb[j][1] = fb[e + 4 * kFK];
          bs[j][1] = fsm[e + 4 * kFK];
        }
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(acc[i][h * NH + j], as[i], bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(acc[i][h * NH + j], ab[i], bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(acc[i][h * NH + j], ab[i], bb[j][0], bb[j][1]);
      }
    }
  }
  // c0, c1: row gq, lags 2 tq, 2 tq + 1; c2, c3: row gq + 8.  The lanes gq
  // and gq ^ 1 (lane ^ 4) hold the two components of one alignment: the
  // even one stores lag 2 tq, the odd one lag 2 tq + 1
  const int al = 16 * warp + (gq >> 1);
  float2* out = c.C + ((size_t)dg * c.A) * c.W + w0 + lg * kMN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = a0 + al + 8 * i + 4 * h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        const float y = __shfl_xor_sync(0xffffffffu, comp ? x0 : x1, 4);
        const int w = lg * kMN + 8 * j + 2 * tq + comp;
        if (a < c.A && w < wl)
          out[(size_t)a * c.W + w - lg * kMN] =
              comp ? make_float2(y, x1) : make_float2(x0, y);
      }
    }
  }
}

inline int mma_warps(int A) {
  const int tiles = (A + 16 * kMaxMW - 1) / (16 * kMaxMW);
  return (A + 16 * tiles - 1) / (16 * tiles);
}

inline size_t mma_smem(int MW) {
  return (size_t)kBK * kLG * kMN * sizeof(float2) +
         ((size_t)4 * kBK * kFK + (size_t)4 * (16 * MW * kWA + 8)) *
             sizeof(uint32_t);
}

int launch_combine(const CombineArgs& c, int DC, cudaStream_t stream) {
  const long long dg = (long long)DC * c.G;
  if (c.A == 1) {
    const long long n = dg * ((c.W + kST * kSV - 1) / (kST * kSV));
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    combine_stream<<<(unsigned)n, kST, 0, stream>>>(c);
    return (int)cudaGetLastError();
  }
  const int MW = mma_warps(c.A);
  const size_t smem = mma_smem(MW);
  cudaError_t e = cudaFuncSetAttribute(
      combine_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n = dg * ((c.W + kLG * kMN - 1) / (kLG * kMN));
  const int na = (c.A + 16 * MW - 1) / (16 * MW);
  if (n > 0x7fffffffLL || na > 65535) return (int)cudaErrorInvalidValue;
  combine_mma<<<dim3((unsigned)n, (unsigned)na), 32 * kLG * MW, smem,
                stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// K5's launch (acquire_coh_spec.cu), the surface stage
extern "C" int acq_coh_spec(const void* F2, const void* code_f,
                            const void* tw, void* peak, void* idx, void* al,
                            void* key, void* count, int P, int DC, int GA,
                            int A, int W, int n_valid, int cluster,
                            int a_chunk, void* stream);

// K6.  F: complex64 [DC, B, W]; code_f: complex64 [P, W]; cosang, sinang
// f32 [DC, B]; sec_mat f32 [A, B]; comb: complex64 [DC, (B/m_coh)*A, W]
// scratch (the combined rows); key u64, count u32 [P, DC] scratch, read
// only where a_chunk < A (may be null otherwise); outputs peak f32, idx
// i32 (lag - lo), al i32 [P, DC].  a_chunk: alignments a cluster
// (ops/acquire_coh.blk_plan).  Returns the cudaError_t of the first
// launch that fails (0 = both launched).
extern "C" int acq_coh_blk(const void* F, const void* code_f,
                           const void* cosang, const void* sinang,
                           const void* sec_mat, void* comb, void* key,
                           void* count, void* peak, void* idx, void* al,
                           int P, int DC, int B, int A, int m_coh, int W,
                           int n_valid, int a_chunk, void* stream) {
  if (P < 1 || DC < 1 || A < 1 || A > 65535 || m_coh < 1 || B < m_coh ||
      B % m_coh != 0 || n_valid < 0 || n_valid > W || a_chunk < 1 ||
      a_chunk > A || W < 2 || W > 16384 || (W & (W - 1)))
    return (int)cudaErrorInvalidValue;
  const int G = B / m_coh;
  if ((long long)G * A > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CombineArgs c = {(const float2*)F, (const float*)cosang,
                   (const float*)sinang, (const float*)sec_mat,
                   (float2*)comb, B, A, m_coh, W, G};
  const int e = launch_combine(c, DC, (cudaStream_t)stream);
  if (e) return e;
  return acq_coh_spec(comb, code_f, nullptr, peak, idx, al, key, count, P,
                      DC, G * A, A, W, n_valid, 0, a_chunk, stream);
}
