// A tracking scan's rows as the track CLI's text, written on the card.
//
// Replaces no TPU kernel: the reference formats each row on the host, a
// dict, a `"%d %f ..." %` and a print a row (track-gps-l1.py:176-177,
// gnss_dsp_tpu/track/driver.py:505-536), which took four fifths of a
// GPS L1 tracking pass's wall.  Here one thread writes one row's line,
// byte for byte what Python prints:
//
//   %f of a float32 x: `-` where x's sign bit is set and x is not NaN,
//   then q = rint(|x| * 1e6) as integer part `.` six digits.  A float32
//   has a 24-bit significand and 1e6 = 2^6 * 15625 with 15625 < 2^14,
//   so the double product is exact and rint (to nearest, ties to even)
//   is Python's correctly rounded %f.  NaN prints `nan`, infinities
//   `inf` / `-inf`.  |x| >= kFixedMax does not fit int64: the scan is
//   flagged and the host formats it row by row.
//   %d of the block: the float32 truncated toward zero (Python's int()).
//   %d of samp, code_cyc, carrier_cyc: each channel's running int64 sums
//   of the row deltas from its host counters at the scan's start.
//
// Rows go block-major, then by channel; a row with n == 0 and a clone
// (k >= E) write nothing.  Four launches on the caller's stream:
//   [1] rows_counters_kernel, a CTA a channel: the running counters
//       (a block-wide scan over the blocks);
//   [2] rows_length_kernel, a thread a row: each line's length (the
//       writer run without stores), any-row and overflow flags;
//   [3] rows_offsets_kernel, one CTA: the exclusive scan of the lengths,
//       the text's bytes and lines;
//   [4] rows_write_kernel, a thread a row: the line at its offset.
//
// Bound: ~56 bytes read and ~150 written a row (4 MB for a 2 s GPS L1
// chunk of 10 channels, ~1.2 us at 3.35 TB/s); in practice the digit
// loops and four launches, tens of microseconds, against ~0.23 s a
// chunk for the host's formatting.  The plain version is the row-by-row
// path, format_row_14/9 a row (track/rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 11;             // rows_f lanes
constexpr int kInts = 3;                // rows_i lanes: n, carrier, code
constexpr int kHead = 4;                // bytes, lines, any row, overflow
constexpr double kFixedMax = 9.2e12;    // rint(|x| * 1e6) fits int64 below
constexpr int kChanThreads = 256;
constexpr int kRowThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

// Exclusive prefix sum of v over the CTA (blockDim.x a multiple of 32,
// at most 1024); every thread calls it.  sh: 32 shared slots.
__device__ long long block_exclusive_scan(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  const long long r = (warp ? sh[warp - 1] : 0) + x - v;
  __syncthreads();
  return r;
}

__device__ __forceinline__ int ndigits(unsigned long long v) {
  int n = 1;
  unsigned long long p = 10ULL;
  while (n < 19 && v >= p) {
    ++n;
    p *= 10ULL;
  }
  return n;
}

// A line being written at p (W) or only measured (!W): n is its length.
template <bool W>
struct Line {
  char* p;
  int n;

  __device__ __forceinline__ void put(char c) {
    if (W) p[n] = c;
    ++n;
  }

  __device__ __forceinline__ void digits(unsigned long long v, int nd) {
    if (W) {
      if (v <= 0xffffffffULL) {
        unsigned u = (unsigned)v;
        for (int i = nd - 1; i >= 0; --i) {
          p[n + i] = (char)('0' + u % 10u);
          u /= 10u;
        }
      } else {
        for (int i = nd - 1; i >= 0; --i) {
          p[n + i] = (char)('0' + (int)(v % 10ULL));
          v /= 10ULL;
        }
      }
    }
    n += nd;
  }

  __device__ void integer(long long v) {       // %d
    const unsigned long long u =
        v < 0 ? 0ULL - (unsigned long long)v : (unsigned long long)v;
    if (v < 0) put('-');
    digits(u, ndigits(u));
  }

  __device__ void fixed(float x) {             // %f
    if (isnan(x)) {
      put('n'); put('a'); put('n');
      return;
    }
    if (signbit(x)) put('-');
    if (isinf(x)) {
      put('i'); put('n'); put('f');
      return;
    }
    const unsigned long long q =
        (unsigned long long)rint(fabs((double)x) * 1e6);
    const unsigned long long ip = q / 1000000ULL;
    digits(ip, ndigits(ip));
    put('.');
    digits(q - ip * 1000000ULL, 6);
  }
};

// One row's line: prefix, then the 9 or 14 columns of format_row_9 / 14;
// c: the channel's samp, code_cyc, carrier_cyc after the row.
template <bool W>
__device__ int write_line(char* p, const uint8_t* pre, int plen,
                          const float* f, bool wide, const long long* c) {
  Line<W> o{p, 0};
  for (int i = 0; i < plen; ++i) o.put((char)pre[i]);
  o.integer((long long)f[0]);
  for (int j = 1; j <= 8; ++j) {
    o.put(' ');
    o.fixed(f[j]);
  }
  if (wide) {
    o.put(' '); o.integer(c[1]);               // code_cyc
    o.put(' '); o.fixed(f[9]);                 // code_p
    o.put(' '); o.integer(c[2]);               // carrier_cyc
    o.put(' '); o.fixed(f[10]);                // carrier_p
    o.put(' '); o.integer(c[0]);               // samp
  }
  o.put('\n');
  return o.n;
}

__device__ __forceinline__ bool fits(float x) {
  return !isfinite(x) || fabs((double)x) < kFixedMax;
}

// [1] channel blockIdx.x's counters after each of its rows: run[b, k] =
// c0[k] + the deltas of its rows 0..b with n != 0; head's final counters.
__global__ void __launch_bounds__(kChanThreads)
rows_counters_kernel(const int* __restrict__ ri, int nb, int C, int E,
                     const long long* __restrict__ c0,
                     long long* __restrict__ run,
                     long long* __restrict__ head) {
  __shared__ long long sh[32];
  const int k = blockIdx.x;
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int b0 = min(nb, (int)threadIdx.x * per);
  const int b1 = min(nb, b0 + per);
  long long s[3] = {0, 0, 0};                  // samp, code, carrier
  for (int b = b0; b < b1; ++b) {
    const int* r = ri + ((long long)b * C + k) * kInts;
    if (r[0] != 0) {
      s[0] += r[0];
      s[1] += r[2];
      s[2] += r[1];
    }
  }
  long long e[3];
  for (int j = 0; j < 3; ++j)
    e[j] = c0[3 * k + j] + block_exclusive_scan(s[j], sh);
  for (int b = b0; b < b1; ++b) {
    const int* r = ri + ((long long)b * C + k) * kInts;
    if (r[0] != 0) {
      e[0] += r[0];
      e[1] += r[2];
      e[2] += r[1];
    }
    long long* o = run + ((long long)b * E + k) * 3;
    o[0] = e[0];
    o[1] = e[1];
    o[2] = e[2];
  }
  if (threadIdx.x == blockDim.x - 1)
    for (int j = 0; j < 3; ++j) head[kHead + 3 * k + j] = e[j];
}

struct Rows {
  const float* rf;
  const int* ri;
  int nb, C, E;
  const uint8_t* pre;
  const int* pre_off;
  const int* wide;
  const long long* run;
};

// [2] each row's line length (0: nothing written); head[2] when any
// channel (clones too) ran a block, head[3] when a field does not fit.
__global__ void __launch_bounds__(kRowThreads)
rows_length_kernel(const Rows a, int* __restrict__ len,
                   long long* __restrict__ head) {
  const long long R = (long long)a.nb * a.C;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < R;
  const int n = valid ? a.ri[r * kInts] : 0;
  const int k = (int)(r % a.C);
  int L = 0;
  bool bad = false;
  if (n != 0 && k < a.E) {
    const float* f = a.rf + r * kFields;
    const bool w = a.wide[k] != 0;
    bad = !(isfinite(f[0]) && fabs((double)f[0]) < kFixedMax);
    for (int j = 1; j <= (w ? 10 : 8); ++j) bad = bad || !fits(f[j]);
    if (!bad)
      L = write_line<false>(nullptr, a.pre + a.pre_off[k],
                            a.pre_off[k + 1] - a.pre_off[k], f, w,
                            a.run + ((r / a.C) * a.E + k) * 3);
  }
  if (valid) len[r] = L;
  const unsigned any = __ballot_sync(kAll, n != 0);
  const unsigned over = __ballot_sync(kAll, bad);
  if ((threadIdx.x & 31) == 0) {
    if (any) head[2] = 1;
    if (over) head[3] = 1;
  }
}

// [3] off[r]: the bytes of the lines before row r; head[0] the text's
// bytes, head[1] its lines (both 0 where the scan is flagged); head[3]
// also if the text would pass cap.
__global__ void __launch_bounds__(kScanThreads)
rows_offsets_kernel(const int* __restrict__ len, long long R,
                    long long* __restrict__ off, long long* __restrict__ head,
                    long long cap) {
  __shared__ long long sh[32];
  const long long per = (R + blockDim.x - 1) / blockDim.x;
  const long long r0 = min(R, (long long)threadIdx.x * per);
  const long long r1 = min(R, r0 + per);
  long long s = 0, m = 0;
  for (long long r = r0; r < r1; ++r) {
    s += len[r];
    m += len[r] != 0;
  }
  long long e = block_exclusive_scan(s, sh);
  const long long lines = block_exclusive_scan(m, sh) + m;
  for (long long r = r0; r < r1; ++r) {
    off[r] = e;
    e += len[r];
  }
  if (threadIdx.x == blockDim.x - 1) {
    const bool flagged = head[3] != 0 || e > cap;
    head[0] = flagged ? 0 : e;
    head[1] = flagged ? 0 : lines;
    head[3] = flagged ? 1 : 0;
  }
}

// [4] each row's line at its offset, unless the scan is flagged.
__global__ void __launch_bounds__(kRowThreads)
rows_write_kernel(const Rows a, const int* __restrict__ len,
                  const long long* __restrict__ off,
                  const long long* __restrict__ head, char* __restrict__ text) {
  if (head[3] != 0) return;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)a.nb * a.C || len[r] == 0) return;
  const int k = (int)(r % a.C);
  write_line<true>(text + off[r], a.pre + a.pre_off[k],
                   a.pre_off[k + 1] - a.pre_off[k], a.rf + r * kFields,
                   a.wide[k] != 0, a.run + ((r / a.C) * a.E + k) * 3);
}

}  // namespace

// rows_f f32 [nb.., C, 11], rows_i i32 [nb.., C, 3]; channels 0..E-1
// written (prefix bytes pre[pre_off[k]:pre_off[k+1]], wide[k] != 0 for
// 14 columns), counters0 int64 [E, 3] (samp, code_cyc, carrier_cyc at the
// scan's start).  Scratch: run int64 [nb, E, 3], len int32 [nb * C], off
// int64 [nb * C].  head int64 [4 + 3 E]: text bytes, lines, any row,
// overflow, then the counters after the scan.  text: cap bytes.
extern "C" int track_rows(const void* rows_f, const void* rows_i, int nb,
                          int C, int E, const void* pre, const void* pre_off,
                          const void* wide, const void* counters0, void* run,
                          void* len, void* off, void* head, void* text,
                          long long cap, void* stream) {
  if (nb < 0 || C < 1 || E < 0 || E > C || cap < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      head, 0, sizeof(long long) * (kHead + 3 * (size_t)E), s);
  if (err != cudaSuccess) return (int)err;
  long long* h = (long long*)head;
  if (E > 0)
    rows_counters_kernel<<<E, kChanThreads, 0, s>>>(
        (const int*)rows_i, nb, C, E, (const long long*)counters0,
        (long long*)run, h);
  const long long R = (long long)nb * C;
  if (R > 0) {
    const Rows a{(const float*)rows_f, (const int*)rows_i, nb, C, E,
                 (const uint8_t*)pre, (const int*)pre_off, (const int*)wide,
                 (const long long*)run};
    const unsigned grid = (unsigned)((R + kRowThreads - 1) / kRowThreads);
    rows_length_kernel<<<grid, kRowThreads, 0, s>>>(a, (int*)len, h);
    rows_offsets_kernel<<<1, kScanThreads, 0, s>>>(
        (const int*)len, R, (long long*)off, h, cap);
    rows_write_kernel<<<grid, kRowThreads, 0, s>>>(
        a, (const int*)len, (const long long*)off, h, (char*)text);
  }
  return (int)cudaGetLastError();
}
