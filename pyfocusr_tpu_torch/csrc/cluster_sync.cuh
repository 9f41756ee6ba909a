// Thread-block cluster primitives for Hopper (sm_90a), shared by csrc/jv.cu,
// csrc/knn.cu and the latency probes of tools/jv_chain_floor.cu: the
// cluster barrier, addresses in and loads from another CTA's shared memory,
// mbarriers, stores into another CTA's shared memory that signal its
// mbarrier, and the launch of one cluster or of a grid of clusters.

#pragma once

#include <cuda_runtime.h>

namespace cluster_sync {

// All threads of all CTAs of the cluster; orders shared (local and
// distributed) and global memory accesses across it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_u32(unsigned local, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Two 32-bit words from another CTA's shared memory (a cluster address).
__device__ __forceinline__ float2 ld_cluster_v2f32(unsigned addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of asynchronous stores.
__device__ __forceinline__ void mbar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of the given parity has completed; acquires at
// cluster scope, so stores counted on the mbarrier are visible.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// 16 bytes into another CTA's shared memory (`slot`, a cluster address),
// counted on that CTA's mbarrier `bar`.
__device__ __forceinline__ void st_async_v4(unsigned slot, unsigned bar, int a,
                                            int b, int c, int d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(slot), "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar)
      : "memory");
}

// The launch configuration of `grid` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory, in clusters of `cluster` CTAs along x.
inline void cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr,
                           dim3 grid, int cluster, int threads, size_t smem,
                           cudaStream_t stream) {
  config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory and, above 8,
// clusters of a non-portable size.
template <typename... Params>
cudaError_t cluster_attributes(void (*kernel)(Params...), int cluster, size_t smem) {
  cudaError_t err = cudaSuccess;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// One cluster of `cluster` CTAs of `threads` threads with `smem` bytes of
// dynamic shared memory, on `stream`.  Returns the launch's
// cudaGetLastError() (0 on success), or -2 if the card cannot schedule the
// cluster (cudaOccupancyMaxActiveClusters is 0).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cluster_attributes(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cluster_config(config, attr, dim3(cluster, 1, 1), cluster, threads, smem, stream);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -2;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A grid of `grid` CTAs in clusters of `cluster` CTAs along x (grid.x a
// multiple of it), on `stream`.  Returns the launch's error (0 on success).
template <typename... Params, typename... Args>
int launch_grid_of_clusters(void (*kernel)(Params...), dim3 grid, int cluster,
                            int threads, size_t smem, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = cluster_attributes(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cluster_config(config, attr, grid, cluster, threads, smem, stream);
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cluster_sync
