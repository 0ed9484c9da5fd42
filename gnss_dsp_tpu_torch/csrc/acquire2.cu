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
// Design: the row-surface kernel of acq_surface.cuh with one alignment
// (A = 1): one CTA per (p, d), rows = the B blocks, an in-place inverse
// Stockham FFT in shared memory per block, |.| accumulated in registers.
//
// What bounds it on the card: shared-memory traffic of the FFT passes
// (about 8 shared reads or writes of 8 bytes per cell, per pass), not
// device memory: the P CTAs of one doppler run side by side, so each F
// block comes from device memory about once and then from L2.  A later
// change should batch several PRNs per CTA so one F read feeds them all.
//
// W must be a power of two, 2 <= W <= 16384.

#include "acq_surface.cuh"

// F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: complex64
// [twiddle_count(W)]; outputs peak/sum f32 [P, DC], idx i32 [P, DC].
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int acq2_reduce(const void* F, const void* code_f, const void* tw,
                           void* peak, void* idx, void* sum, int P, int DC,
                           int B, int W, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
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
  return acq::launch_surface<acq::kRows>(s, (cudaStream_t)stream);
}
