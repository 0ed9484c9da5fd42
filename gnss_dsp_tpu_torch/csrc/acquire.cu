// Non-coherent acquisition surface, full and unreduced (kernel K7).
//
// Replaces the TPU kernel gnss_dsp_tpu/ops/pallas_acquire.py::corr_surface
// (pallas_call at :221, body _kernel :120-177).  For each PRN p, doppler d
// and lag j it writes
//
//     q[p, d, j] = (1/W) * sum_b | IDFT_W( code_f[p] * conj(F[d, b]) ) [j] |
//
// in natural lag order.  The TPU kernel's permuted layout (q index
// j2*n1 + j1, perm_to_natural_index) came from its 128-lane matrix-unit
// split and is not carried over.
//
// Design: the four-step kernel of acq_wide.cuh, shared with K1's wide
// windows: one CTA per (p, d) at a time, the B rows through a scratch row
// and accumulator in device memory, then the surface written in natural
// order.  With one PRN (Xona X5) a launch holds fewer (p, d) than the card
// has CTA slots, so each (p, d)'s blocks are split over several CTAs and
// a second pass sums their accumulators in a fixed order.  At Xona X5
// (W = 30690 = 165 * 186 = (3*5*11) * (2*3*31)) the passes are radix 3,
// 5, 11 over the columns and 2, 3, 31 over the rows.
//
// What bounds it on the card: the scratch traffic (about 40 bytes of
// device memory or L2 per cell, against 8 bytes of F per cell read from
// device memory) and the direct radix-11 and radix-31 DFTs (11 and 31
// complex multiply-adds per value); the [P, DC, W] output is small beside
// F (one float per lag per (p, d) against B complex values).

#include "acq_wide.cuh"

// F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: the
// wide_twiddle_table(n1, n2) of ops/acquire2.py; root: complex64 [W];
// rowbuf complex64 [slots, W] and acc f32 [slots, W] (nseg = 1) or
// [P*DC*nseg, W] scratch; q: f32 [P, DC, W].  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int acq_surface_full(const void* F, const void* code_f,
                                const void* tw, const void* root,
                                void* rowbuf, void* acc, void* q, int P,
                                int DC, int B, int W, int n1, int n2,
                                int slots, int nseg, void* stream) {
  acq::WideArgs s = {};
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.root = (const float2*)root;
  s.rowbuf = (float2*)rowbuf;
  s.acc = (float*)acc;
  s.q = (float*)q;
  s.P = P;
  s.DC = DC;
  s.B = B;
  s.W = W;
  s.n1 = n1;
  s.n2 = n2;
  s.nseg = nseg;
  return acq::launch_wide<false>(s, slots, (cudaStream_t)stream);
}
