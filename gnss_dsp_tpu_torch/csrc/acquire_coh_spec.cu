// Extended-coherent acquisition surface, spectral combine (kernel K5).
//
// Replaces gnss_dsp_tpu/ops/pallas_acquire_coh.py::corr_surface_coh_spec
// (pallas_call at :305, body _kernel_spec :190, finalize _finalize_max
// :158).  Its rows are spectra already combined across each group's blocks
// (F2[d, g*A + a] = sum_m conj(w[a, m]) F[d, g*M + m]); alignment a's
// surface is
//
//     s_a[j] = (1/W) * sum_g | IDFT_W( code_f[p] * conj(F2[d, g*A + a]) ) [j] |
//
// and the kernel reports, per (p, d), the highest s_a[j] over alignments
// and the lags j >= lo = W - n_valid (all lags when n_valid = 0), the
// lowest such lag, then the lowest alignment (_finalize_max's ties), with
// the lag counted from lo.
//
// Design: the cluster surface core of acq_cluster.cuh (surface_rows, with
// the alignment loop): one thread-block cluster of C CTAs per (p, d)
// walks all A alignments and G groups of its G*A rows, each row a
// four-step transform W = n1 * n2 split over the cluster with no value in
// device memory, the sub-transforms in registers at compile-time sizes.
// Each thread sums |x| of its 16 lags in registers across the G groups,
// then keeps per lag the running (peak, lowest alignment) over the A
// alignments in registers too.  The cluster then reduces (peak, lowest
// lag, its alignment) through distributed shared memory and writes it: no
// [P, DC, A] scratch and no second kernel.
//
// What bounds it on the card: the float32 operations of the transforms
// (~5 log2 W per value and row) and the shared-memory traffic (per value
// and row: the staged load, two exchanges, the yb store and the remote
// read).  All sizes are compile-time: one kernel per log2 W and C.
//
// W must be a power of two, 2 <= W <= 16384.  At W = 16384 (128 x 128)
// the cluster is 8 CTAs of 128 threads (66 KB of shared memory each, three
// to an SM), or 4 of 256 (130 KB, one to an SM).

#include "acq_cluster.cuh"

namespace {

using acqc::Spec;
using acqc::SurfaceArgs;

template <int L, int C>
__global__ void __launch_bounds__(Spec<L, C>::T, Spec<L, C>::kMinBlocks)
    coh_spec_kernel(const __grid_constant__ SurfaceArgs s) {
  acqc::surface_rows<Spec<L, C>, true, false>(s);
}

using Kernel = void (*)(const SurfaceArgs);

struct Launch {
  Kernel kernel;
  int C, T;
  size_t smem;
};

template <int L, int C>
Launch launch_of() {
  using K = Spec<L, C>;
  return {coh_spec_kernel<L, C>, C, K::T, K::kSmem};
}

// The kernels built: log2 W = 1 .. 14, C = min(8, n1) CTAs a cluster (the
// choice), and 4 CTAs at W = 16384.
bool spec_launch(Launch& l, int W, int C) {
  if (W < 2 || W > 16384 || (W & (W - 1))) return false;
  const int L = acqc::ilog2(W);
  const int n1 = 1 << (L / 2);
  const int choice = n1 < 8 ? n1 : 8;
  if (C == 0) C = choice;
  if (C != choice && !(L == 14 && C == 4)) return false;
  switch (L) {
    case 1: l = launch_of<1, 1>(); break;
    case 2: l = launch_of<2, 2>(); break;
    case 3: l = launch_of<3, 2>(); break;
    case 4: l = launch_of<4, 4>(); break;
    case 5: l = launch_of<5, 4>(); break;
    case 6: l = launch_of<6, 8>(); break;
    case 7: l = launch_of<7, 8>(); break;
    case 8: l = launch_of<8, 8>(); break;
    case 9: l = launch_of<9, 8>(); break;
    case 10: l = launch_of<10, 8>(); break;
    case 11: l = launch_of<11, 8>(); break;
    case 12: l = launch_of<12, 8>(); break;
    case 13: l = launch_of<13, 8>(); break;
    default: l = C == 4 ? launch_of<14, 4>() : launch_of<14, 8>(); break;
  }
  return l.C == C;
}

}  // namespace

// The launch plan of K5 at W with `cluster` CTAs (0: the kernel's own
// choice): info[0] cluster size, [1] dynamic shared memory bytes a CTA,
// [2] registers a thread, [3] local (spilled) bytes a thread, [4] clusters
// the card holds at once (cudaOccupancyMaxActiveClusters), [5] threads a
// CTA.  Returns a cudaError_t (cudaErrorInvalidValue: no such kernel).
extern "C" int acq_coh_spec_info(int W, int cluster, int* info) {
  Launch l;
  if (!spec_launch(l, W, cluster)) return (int)cudaErrorInvalidValue;
  return (int)acqc::cluster_info(l.kernel, l.T, l.C, l.smem, info);
}

// K5.  F2: complex64 [DC, GA, W] (row g*A + a); code_f: complex64 [P, W];
// outputs peak f32, idx i32, al i32 [P, DC].  cluster: as
// acq_coh_spec_info.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int acq_coh_spec(const void* F2, const void* code_f, void* peak,
                            void* idx, void* al, int P, int DC, int GA, int A,
                            int W, int n_valid, int cluster, void* stream) {
  Launch l;
  if (P < 1 || DC < 1 || A < 1 || A > 65535 || GA < A || GA % A != 0 ||
      n_valid < 0 ||
      n_valid > W || !spec_launch(l, W, cluster))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)P * DC * l.C;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  SurfaceArgs s = {};
  s.F = (const float2*)F2;
  s.code_f = (const float2*)code_f;
  s.peak = (float*)peak;
  s.idx = (int*)idx;
  s.al = (int*)al;
  s.P = P;
  s.DC = DC;
  s.rows = GA;
  s.A = A;
  s.lo = n_valid ? W - n_valid : 0;
  return (int)acqc::launch_cluster(l.kernel, (int)grid, l.T, l.C, l.smem,
                                   (cudaStream_t)stream, s);
}
