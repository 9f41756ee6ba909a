// Probes of the two latencies that chain the Jonker-Volgenant search's steps
// on the card (csrc/jv.cu), for tools/jv_chain_floor.py.
//
//   * chase: one block follows a chain of dependent loads.  Every step loads
//     one slice of one row of an [n, n] int32 buffer (one word a thread,
//     like a CTA's slice of a cost row), and the slice's first word names the
//     next (row, slice) pair, 16 slices to a row, so each load waits for the
//     one before and the chain covers the whole buffer.
//   * exchange: one cluster of kClusterSize CTAs of kThreads threads runs
//     the JV step's exchange without the load and the relax.  Mode 0: one
//     bare cluster barrier (arrive.release / wait.acquire).  Mode 1: every
//     warp stores a 16-byte candidate into a slot of every CTA (distributed
//     shared memory, parity-buffered), one cluster barrier, and every thread
//     merges the slots.  Mode 2: the same slots written with st.async, which
//     signals the receiving CTA's mbarrier, and no cluster barrier (the
//     exchange of csrc/jv.cu).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../pyfocusr_tpu_torch/csrc/cluster_sync.cuh"

namespace cg = cooperative_groups;
using namespace cluster_sync;

namespace {

// The JV kernel's cluster: 16 CTAs of 256 threads.
constexpr int kClusterSize = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kClusterSize * kWarps;

__global__ void chase_kernel(const int* buf, long long row_len, int slice,
                             int steps, int start, int* out) {
  int at = start;  // row * 16 + slice index
  int acc = 0;
  for (int k = 0; k < steps; ++k) {
    const int* words = buf + (size_t)(at >> 4) * row_len + (at & 15) * slice;
    acc += __ldcg(words + threadIdx.x);
    at = __ldcg(words);
  }
  out[threadIdx.x] = at + acc;
}

__global__ void __launch_bounds__(kThreads, 1)
    exchange_kernel(int iters, int exchange, int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __shared__ int4 slots[2][kSlots];
  __shared__ __align__(8) unsigned long long bars[2];
  int4* my_slot = nullptr;
  unsigned to_slot[2] = {0u, 0u}, to_bar[2] = {0u, 0u};
  if (lane < kClusterSize) {
    my_slot = cluster.map_shared_rank(&slots[0][0], lane) + rank * kWarps + warp;
    for (int p = 0; p < 2; ++p) {
      to_slot[p] = cluster_u32(smem_u32(&slots[p][rank * kWarps + warp]), lane);
      to_bar[p] = cluster_u32(smem_u32(&bars[p]), lane);
    }
  }
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) mbar_init(smem_u32(&bars[p]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_barrier();
  int acc = 0;
  for (int k = 0; k < iters; ++k) {
    if (exchange == 2) {
      const int p = k & 1;
      if (threadIdx.x == 0) mbar_arrive_expect(smem_u32(&bars[p]), kSlots * 16);
      if (lane < kClusterSize) st_async_v4(to_slot[p], to_bar[p], k, rank, warp, acc);
      mbar_wait(smem_u32(&bars[p]), (k >> 1) & 1);
      int m = 0x7fffffff;
#pragma unroll
      for (int s = lane; s < kSlots; s += 32) m = min(m, slots[p][s].w);
      acc += __reduce_min_sync(0xffffffffu, (unsigned)m) + 1;
    } else if (exchange == 1) {
      if (lane < kClusterSize) {
        my_slot[(k & 1) * kSlots] = make_int4(k, rank, warp, acc);
      }
      cluster_barrier();
      int m = 0x7fffffff;
#pragma unroll
      for (int s = lane; s < kSlots; s += 32) m = min(m, slots[k & 1][s].w);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      acc += m + 1;
    } else {
      cluster_barrier();
      ++acc;
    }
  }
  if (threadIdx.x == 0) out[rank] = acc;
}

}  // namespace

// One chase of `steps` dependent slice loads with `slice` threads (one word
// each); out receives `slice` ints.  Returns cudaGetLastError().
extern "C" int pyfocusr_chase(const int* buf, long long row_len, int slice,
                              int steps, int start, int* out, void* stream) {
  chase_kernel<<<1, slice, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, row_len, slice, steps, start, out);
  return (int)cudaGetLastError();
}

// `iters` exchanges of mode `exchange` (0, 1, 2) on one cluster; out receives
// kClusterSize ints.  Returns cudaGetLastError(), or -2 if the card cannot
// schedule the cluster.
extern "C" int pyfocusr_exchange(int iters, int exchange, int* out,
                                 void* stream) {
  return launch_cluster(exchange_kernel, kClusterSize, kThreads, 0,
                        static_cast<cudaStream_t>(stream), iters, exchange, out);
}
