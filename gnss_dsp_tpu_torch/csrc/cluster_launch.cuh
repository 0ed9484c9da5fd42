// Thread-block cluster helpers shared by the cluster kernels: the split
// cluster barrier, the mbarriers and bulk copies (TMA) that stage device
// memory into shared memory, and the launch (its dynamic shared memory,
// the non-portable cluster size above 8 CTAs, cudaLaunchKernelEx).  Used
// by acq_cluster.cuh (K1, K5, K7), track_fused.cu (K2) and track_step.cu
// (K3, K4).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace clusterk {
namespace {   // each translation unit keeps its own instantiations

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// an arrival that orders no memory: pairs with a later cluster_wait that
// only has to know every CTA of the cluster has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// ---- mbarriers, bulk copies and remote stores (PTX)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this CTA's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the shared::cluster address of p (this CTA's shared memory) in the CTA
// of the cluster with rank `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}
// 8 bytes into another CTA's shared memory (shared::cluster addresses from
// map_rank), completing 8 bytes of the transaction count of its mbarrier
__device__ __forceinline__ void st_async_b64(uint32_t dst, double v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxPortable = 8;   // larger clusters are non-portable (16)

inline cudaLaunchConfig_t cluster_config(int grid, int T, int C, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3((unsigned)T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The attributes a cluster kernel needs before a launch: its dynamic
// shared memory, and above 8 CTAs the non-portable cluster size.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int C, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > kMaxPortable)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// A cluster kernel's launch plan: info[0] C, [1] dynamic shared memory
// bytes a CTA, [2] registers a thread, [3] local (spilled) bytes a thread,
// [4] clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// [5] threads a CTA.
template <typename Kernel>
inline cudaError_t cluster_info(Kernel kernel, int T, int C, size_t smem,
                                int* info) {
  cudaError_t e = prepare(kernel, C, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(C, T, C, smem, 0, attr);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return e;
  info[0] = C;
  info[1] = (int)smem;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = active;
  info[5] = T;
  return cudaSuccess;
}

// Launch a cluster kernel over `grid` CTAs; above 8 CTAs a cluster only
// where the card holds one such cluster at once.  Returns the launch's
// cudaError_t.
template <typename Kernel, typename Args>
inline cudaError_t launch_cluster(Kernel kernel, int grid, int T, int C,
                                  size_t smem, cudaStream_t stream,
                                  const Args& args) {
  cudaError_t e = prepare(kernel, C, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(grid, T, C, smem, stream, attr);
  if (C > kMaxPortable) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (active < 1) return cudaErrorLaunchOutOfResources;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace clusterk
