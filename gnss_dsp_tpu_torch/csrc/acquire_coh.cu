// Extended-coherent acquisition surface, per block (kernel K6).  The
// spectral-combine kernel K5 has its own cluster design in
// acquire_coh_spec.cu.
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
// Design: one CTA per (p, d, a) runs the row-surface kernel of
// acq_surface.cuh and writes its (max, lowest lag); a second small kernel
// combines the A alignments of each (p, d).  K6 uses the linearity of the
// IDFT: for each group it forms sum_m sec[a, m] conj(rot[d, m]) F[d, m] in
// shared memory and runs ONE IDFT, instead of one per block kept in A
// complex accumulators (the TPU kernel's VMEM-resident accC[A, W], which
// would not fit a CTA at A = 100).
//
// What bounds it on the card: the combine, m_coh complex loads of F per
// cell and group; the CTAs of one doppler run side by side (blockIdx.x =
// (d*A + a)*P + p), so those loads are L2 hits after the first.
//
// W must be a power of two, 2 <= W <= 16384.

#include "acq_surface.cuh"

namespace {

// per (p, d): highest peak over a, then lowest lag, then lowest a
__global__ void coh_combine_kernel(const float* __restrict__ pk,
                                   const int* __restrict__ ix,
                                   float* __restrict__ peak,
                                   int* __restrict__ idx,
                                   int* __restrict__ al, int PD, int A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PD) return;
  const float* v = pk + (size_t)i * A;
  const int* j = ix + (size_t)i * A;
  float bv = v[0];
  int bi = j[0];
  int ba = 0;
  for (int a = 1; a < A; ++a) {
    if (v[a] > bv || (v[a] == bv && j[a] < bi)) {
      bv = v[a];
      bi = j[a];
      ba = a;
    }
  }
  peak[i] = bv;
  idx[i] = bi;
  al[i] = ba;
}

int combine(const void* pk, const void* ix, void* peak, void* idx, void* al,
            int P, int DC, int A, cudaStream_t stream) {
  const int PD = P * DC;
  coh_combine_kernel<<<(PD + 255) / 256, 256, 0, stream>>>(
      (const float*)pk, (const int*)ix, (float*)peak, (int*)idx, (int*)al,
      PD, A);
  return (int)cudaGetLastError();
}

}  // namespace

// K6.  F: complex64 [DC, B, W]; code_f: complex64 [P, W]; tw: complex64
// twiddle table; cosang, sinang f32 [DC, B]; sec_mat f32 [A, B]; pk_part
// f32 / ix_part i32 [P, DC, A] scratch; outputs peak f32, idx i32, al i32
// [P, DC].
extern "C" int acq_coh_blk(const void* F, const void* code_f, const void* tw,
                           const void* cosang, const void* sinang,
                           const void* sec_mat, void* pk_part, void* ix_part,
                           void* peak, void* idx, void* al, int P, int DC,
                           int B, int A, int m_coh, int W, int n_valid,
                           void* stream) {
  if (A < 1 || m_coh < 1 || B < m_coh || B % m_coh != 0 || n_valid < 0 ||
      n_valid > W)
    return (int)cudaErrorInvalidValue;
  acq::SurfaceArgs s = {};
  s.F = (const float2*)F;
  s.code_f = (const float2*)code_f;
  s.tw = (const float2*)tw;
  s.cosang = (const float*)cosang;
  s.sinang = (const float*)sinang;
  s.sec_mat = (const float*)sec_mat;
  s.peak = (float*)pk_part;
  s.idx = (int*)ix_part;
  s.P = P;
  s.DC = DC;
  s.A = A;
  s.W = W;
  s.rows_per_d = B;
  s.nrows = B / m_coh;
  s.m_coh = m_coh;
  s.lo = n_valid ? W - n_valid : 0;
  int e = acq::launch_surface(s, (cudaStream_t)stream);
  if (e) return e;
  return combine(pk_part, ix_part, peak, idx, al, P, DC, A,
                 (cudaStream_t)stream);
}
