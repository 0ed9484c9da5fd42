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
// Two designs, by W:
//
// * power-of-two W <= 16384: the row-surface kernel of acq_surface.cuh with
//   one alignment (A = 1): one CTA per (p, d), rows = the B blocks, an
//   in-place inverse Stockham FFT in shared memory per block, |.|
//   accumulated in registers.  What bounds it on the card: shared-memory
//   traffic of the FFT passes (about 8 shared reads or writes of 8 bytes
//   per cell, per pass), not device memory: the P CTAs of one doppler run
//   side by side, so each F block comes from device memory about once and
//   then from L2.  A later change should batch several PRNs per CTA so one
//   F read feeds them all.
// * any other W = n1 * n2 with n1, n2 <= 4096 made of the factors 2, 3, 5,
//   11 and 31 (32768 and 65536, 81920 = 256 * 320, 163840 = 320 * 512): the
//   four-step kernel of acq_wide.cuh, through a scratch row and accumulator
//   per CTA in device memory.  What bounds it: the scratch traffic, about
//   40 bytes of device memory (or L2) per cell against 16 of F, and the
//   direct radix-5 passes; it is the simple design, speed is later work.
//
// n_valid (the padded-window route, pallas_acquire2.py:254-264): the max,
// the argmax and the sum run over the lags j >= W - n_valid only, and the
// index is reported as j - (W - n_valid).  n_valid = 0 searches all lags.

#include "acq_surface.cuh"
#include "acq_wide.cuh"

// F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: complex64
// [twiddle_count(W)]; outputs peak/sum f32 [P, DC], idx i32 [P, DC].
// Power-of-two W <= 16384.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int acq2_reduce(const void* F, const void* code_f, const void* tw,
                           void* peak, void* idx, void* sum, int P, int DC,
                           int B, int W, int n_valid, void* stream) {
  if (B < 1 || n_valid < 0 || n_valid > W) return (int)cudaErrorInvalidValue;
  acq::SurfaceArgs s = {};
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.sum = (float*)sum;
  s.P = P;
  s.DC = DC;
  s.A = 1;
  s.W = W;
  s.rows_per_d = B;
  s.nrows = B;
  s.lo = n_valid ? W - n_valid : 0;
  return acq::launch_surface<acq::kRows>(s, (cudaStream_t)stream);
}

// The same contract at other W = n1 * n2 (acq_wide.cuh).  tw: the
// wide_twiddle_table(n1, n2) of ops/acquire2.py; root: complex64 [W];
// rowbuf complex64 [slots, W] and acc f32 [slots, W] (nseg = 1) or
// [P*DC*nseg, W] scratch.
extern "C" int acq2_reduce_wide(const void* F, const void* code_f,
                                const void* tw, const void* root,
                                void* rowbuf, void* acc, void* peak,
                                void* idx, void* sum, int P, int DC, int B,
                                int W, int n1, int n2, int n_valid, int slots,
                                int nseg, void* stream) {
  if (n_valid < 0 || n_valid > W) return (int)cudaErrorInvalidValue;
  acq::WideArgs s = {};
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.root = (const float2*)root;
  s.rowbuf = (float2*)rowbuf;
  s.acc = (float*)acc;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.sum = (float*)sum;
  s.P = P;
  s.DC = DC;
  s.B = B;
  s.W = W;
  s.n1 = n1;
  s.n2 = n2;
  s.nseg = nseg;
  s.lo = n_valid ? W - n_valid : 0;
  return acq::launch_wide(s, slots, (cudaStream_t)stream);
}
