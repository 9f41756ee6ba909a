// Jonker-Volgenant shortest-augmenting-path augmentation for Hopper (sm_90a).
//
// Replaces the TPU kernel `jv_device_pallas` / `_jv_row_call` /
// `_jv_row_kernel` (pyfocusr_tpu/ops/pallas_kernels.py:422-621): given a
// dense f32 cost [n, n], feasible duals (u, v) and the partial matching the
// tight-edge bulk phase left, it runs, for every free row in ascending order,
// a Dijkstra search over reduced costs for the shortest augmenting path,
// applies the deferred dual updates of scipy's `_lsap`, and flips the
// matching along the path, under a global budget of Dijkstra steps.
//
// One launch of one thread-block cluster does all of it.  The TPU version
// makes one kernel call per free row and hands spc / scanned / rvis /
// min_val back to the caller for the dual updates, because its compiler
// cannot gather from on-chip memory; a CUDA cluster can, so the loop over
// free rows, each search, its dual updates and its augmentation all happen
// here.
//
// Exactness.  The result is the optimum only if every comparison sees the
// values the reference sees, so the arithmetic is the reference's, in its
// order, with separately rounded f32 operations:
//   r_j     = ((min_val + C[i][j]) - u_i) - v_j
//   better  = !scanned_j && r_j < spc_j            (strict)
//   j1      = lowest column index attaining min_j (scanned_j ? 1e30 : spc_j)
//   u[i0]  += min_val
//   u[i]    = (u[i] + min_val) - spc[col4row[i]]   other visited rows i,
//                                                  col4row before the flip
//   v[j]    = v[j] - (min_val - spc[j])            scanned columns j
// There is no product, so nothing can contract into an FMA; the plain
// PyTorch version (ops/jv_kernel.py) does the same operations and the two
// agree exactly: same col4row, same step count, same duals.  The argmin is a
// minimum over (value, column) pairs, a total order, so the order in which
// the partial minima are merged cannot change it.
//
// What bounds it on the H100: the search is sequential in its steps.  A step
// needs one cost row (4 n bytes, fetched from device memory or L2 at an
// address known only when the previous step's argmin is), a relax over n
// columns, and an argmin over them.  Arithmetic is not the limit (5 f32
// operations a column); the chain is: row load latency, then the reduction,
// then the exchange that tells every worker the next row.  On one H100 a
// dependent row-slice load from device memory takes 0.37 us and a cluster
// barrier 0.53 us (tools/jv_chain_floor.py); this kernel takes 1.22 us a
// step at n = 10242, the one-block kernel it replaced 2.84
// (tools/torch_paths_ab.py; PERF.md).
//
// What the design does about it:
//   * One cluster of kClusterSize CTAs (16, a non-portable size, on 16 SMs)
//     of kThreads threads each.  CTA r owns the contiguous column range
//     [r w, (r + 1) w), w = ceil(n / kClusterSize), so a step loads a slice
//     of 4 w bytes on each SM (2.5 KB at n = 10242) instead of a 40 KB row on
//     one, and the lowest-index tie-break stays a plain (value, column)
//     minimum across CTAs.  Thread t of a CTA owns its columns t, t +
//     kThreads, ...: it alone reads and writes their state during a search,
//     and issues the loads of all of them before it uses the first, so a
//     step waits for memory once.  The kernel is instantiated for 1, 2, 3,
//     4, 8 and 16 columns a thread and launched with the least that holds
//     ceil(w / kThreads) (3 at n = 10242; above 16, rounds of 16): with a
//     fixed 16, the loads and guards of absent columns took most of the
//     step (1.85 us against 1.22 us at n = 10242, one H100).  A CTA with no
//     columns (n < kClusterSize w) still takes part in every exchange.
//   * Resident state.  Each CTA keeps v, spc (f32), path, row4col (i32) and
//     scanned (one byte) of its own columns in its own shared memory: 17 w
//     bytes, 11 KB at n = 10242.  kMaxColsPerCta columns fit the 227 KB a
//     block may take beside the exchange slots, so n <= kMaxN; larger n is
//     refused by the wrapper (no fallback).  u and col4row are touched at
//     single indices and stay in global memory, read through L2 (ld.cg)
//     because another SM writes them.
//   * One exchange per step, no __syncthreads and no cluster barrier.  Every
//     warp reduces its columns to one candidate with two __reduce_min_sync
//     (the value as an order-preserving unsigned key, then the lowest column
//     among the lanes at that key), looks up the column's owner row in the
//     CTA's own row4col, and writes (key, column, owner) into a slot of every
//     CTA's shared memory with st.async, which signals the receiving CTA's
//     mbarrier with the bytes it delivered.  A CTA waits on its own mbarrier
//     (expecting kClusterSize x kWarps slots) and every thread of every CTA
//     reduces the same candidates to the same j1, min_val and next row.  On
//     one H100 a bare cluster barrier of 16 CTAs takes 0.53 us, the exchange
//     built on it 1.02 us, this one 0.37 us (tools/jv_chain_floor.py): the
//     mbarrier is signalled by the stores themselves.  Slots and mbarriers
//     are double-buffered by exchange parity: a CTA writes buffer p again
//     only after its own exchange p ^ 1 completed, which needs every warp of
//     every CTA to have sent its next candidate, and each warp's candidate
//     depends on its reads of buffer p.  The thread that owns j1 marks it
//     scanned.
//   * Per search: the u update of a visited row i != i_start is done by the
//     owner of its column col4row[i] = j, a scanned column other than the
//     sink whose row4col is i (so no list of visited rows is kept); rank 0
//     adds min_val to u[i_start]; the v update is local.  One thread of rank
//     0 flips the path, reading path and writing row4col through distributed
//     shared memory.  Cluster barriers separate the dual update, the flip
//     and the next search's reset.
//   * Every CTA reduces the same candidates, so every CTA takes the same
//     decisions (sink, step count, budget) and meets the same barriers.
//   * Measured on one H100 and not kept: an L2 prefetch of the row that owns
//     the runner-up candidate (slower), 8 CTAs or 128- or 512-thread CTAs
//     (slower at n = 10242), spinning on mbarrier.test_wait (no faster).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_sync.cuh"

namespace cg = cooperative_groups;
using namespace cluster_sync;

namespace {

constexpr int kClusterSize = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Candidates exchanged per step: one per warp of the cluster.
constexpr int kSlots = kClusterSize * kWarps;
// 17 bytes of search state a column: 12800 columns take 217 600 bytes,
// which leaves room for the exchange slots (2 x kSlots x 16 bytes) within
// the 232 448 bytes of shared memory a block may take.
constexpr int kMaxColsPerCta = 12800;
constexpr int kMaxN = kClusterSize * kMaxColsPerCta;
constexpr float kBig = 1e30f;

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kSlots % 32 == 0, "the exchange is read by whole warps");
static_assert(kClusterSize >= 1 && kClusterSize <= 16, "H100 cluster sizes");
static_assert(17 * kMaxColsPerCta + 2 * kSlots * 16 + 16 <= 232448,
              "search state, slots and mbarriers fit one block's shared memory");

constexpr unsigned kFull = 0xffffffffu;

struct __align__(16) Slot {
  unsigned key;  // order-preserving key of the candidate's value
  int idx;       // its column; n for none
  int owner;     // row4col of that column; -1 for a free column
  int pad;
};

// Unsigned keys that order as the floats do (no NaN in a search).  -0.0
// takes +0.0's key, so equal values tie on the column as in torch.argmin;
// a search never forms -0.0 (its first min_val is +0.0, and a sum or
// difference is -0.0 only from a -0.0 operand), so the value comes back
// from the key unchanged.
__device__ __forceinline__ unsigned value_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// kBatch: columns a thread relaxes per round of loads.
template <int kBatch>
__global__ void __launch_bounds__(kThreads, 1)
    jv_cluster_kernel(const float* __restrict__ cost, int n, int width,
                      const int* __restrict__ free_rows, int budget, float* u,
                      float* v_glob, int* row4col_glob, int* col4row,
                      int* steps_used) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int lo = min(rank * width, n);
  const int cols = min(lo + width, n) - lo;

  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* spc = v + width;
  int* path = reinterpret_cast<int*>(spc + width);
  int* r4c = path + width;
  unsigned char* scanned = reinterpret_cast<unsigned char*>(r4c + width);
  __shared__ Slot slots[2][kSlots];
  __shared__ __align__(8) unsigned long long bars[2];

  for (int jl = tid; jl < cols; jl += kThreads) {
    v[jl] = v_glob[lo + jl];
    r4c[jl] = row4col_glob[lo + jl];
  }
  const unsigned bar0 = smem_u32(&bars[0]);
  const unsigned bar1 = smem_u32(&bars[1]);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Lane l < kClusterSize of each warp sends the warp's candidate to rank l,
  // into this warp's place in the slots.
  unsigned to_slot0 = 0u, to_slot1 = 0u, to_bar0 = 0u, to_bar1 = 0u;
  if (lane < kClusterSize) {
    to_slot0 = cluster_u32(smem_u32(&slots[0][rank * kWarps + warp]), lane);
    to_slot1 = cluster_u32(smem_u32(&slots[1][rank * kWarps + warp]), lane);
    to_bar0 = cluster_u32(bar0, lane);
    to_bar1 = cluster_u32(bar1, lane);
  }
  // Every CTA has started, loaded its columns and set up its mbarriers
  // before anything is sent to it.
  cluster_barrier();

  int steps_left = budget;
  unsigned exchange = 0;  // exchanges so far: buffer exchange & 1
  for (int k = 0; k < n && steps_left > 0; ++k) {
    const int i_start = free_rows[k];
    if (i_start >= n) break;  // the list is ascending, padded with n

    // A thread resets the columns it alone touches during the search.
    for (int jl = tid; jl < cols; jl += kThreads) {
      spc[jl] = kBig;
      scanned[jl] = 0;
      path[jl] = -1;
    }

    int i_cur = i_start;
    float min_val = 0.0f;
    int sink = -1;
    int steps = 0;
    while (sink < 0 && steps < steps_left) {
      const int p = exchange & 1;
      const unsigned bar = p ? bar1 : bar0;
      if (tid == 0) mbar_arrive_expect(bar, kSlots * (unsigned)sizeof(Slot));
      const float u_i = __ldcg(u + i_cur);
      const float* row = cost + (size_t)i_cur * n + lo;
      float best_val = kBig;
      int best_idx = n;
      for (int base = 0; base < cols; base += kBatch * kThreads) {
        // All of the batch's loads are issued before the first is used.
        float c[kBatch], s[kBatch], vj[kBatch];
        bool done[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int jl = base + b * kThreads + tid;
          const bool in = jl < cols;
          c[b] = in ? __ldg(row + jl) : 0.0f;
          s[b] = in ? spc[jl] : kBig;
          vj[b] = in ? v[jl] : 0.0f;
          done[b] = in ? scanned[jl] != 0 : true;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int jl = base + b * kThreads + tid;
          if (jl >= cols) break;
          if (!done[b]) {
            const float r =
                __fsub_rn(__fsub_rn(__fadd_rn(min_val, c[b]), u_i), vj[b]);
            if (r < s[b]) {
              s[b] = r;
              spc[jl] = r;
              path[jl] = i_cur;
            }
          }
          // Columns rise within a thread, so a strict '<' keeps the lowest.
          const float masked = done[b] ? kBig : s[b];
          if (masked < best_val || best_idx == n) {
            best_val = masked;
            best_idx = lo + jl;
          }
        }
      }
      // The warp's candidate: lowest key, then lowest column at that key.
      const unsigned key = value_key(best_val);
      const unsigned wkey = __reduce_min_sync(kFull, key);
      const int widx = (int)__reduce_min_sync(
          kFull, key == wkey ? (unsigned)best_idx : 0xffffffffu);
      if (lane < kClusterSize) {
        st_async_v4(p ? to_slot1 : to_slot0, p ? to_bar1 : to_bar0, (int)wkey,
                    widx, widx < n ? r4c[widx - lo] : -1, 0);
      }
      mbar_wait(bar, (exchange >> 1) & 1);
      ++exchange;

      // Every thread merges the same candidates.
      unsigned mkey = 0xffffffffu, midx = 0xffffffffu;
      int mown = -1;
#pragma unroll
      for (int q = 0; q < kSlots / 32; ++q) {
        const Slot got = slots[p][lane + 32 * q];
        if (got.key < mkey || (got.key == mkey && (unsigned)got.idx < midx)) {
          mkey = got.key;
          midx = (unsigned)got.idx;
          mown = got.owner;
        }
      }
      const unsigned gkey = __reduce_min_sync(kFull, mkey);
      const unsigned gidx = __reduce_min_sync(kFull, mkey == gkey ? midx : 0xffffffffu);
      const int owner = (int)__reduce_max_sync(
          kFull, (mkey == gkey && midx == gidx) ? (unsigned)(mown + 1) : 0u) - 1;
      min_val = key_value(gkey);
      const int jl1 = (int)gidx - lo;
      if (jl1 >= 0 && jl1 < cols && jl1 % kThreads == tid) scanned[jl1] = 1;
      if (owner < 0) {
        sink = (int)gidx;
      } else {
        i_cur = owner;
      }
      ++steps;
    }
    steps_left -= steps;
    if (sink < 0) break;  // budget exhausted: this row and the rest stay free

    // Deferred dual updates, with the matching as it was before the flip: a
    // visited row other than i_start is row4col[j] of a scanned column j
    // other than the sink, and its col4row is j.
    for (int jl = tid; jl < cols; jl += kThreads) {
      if (scanned[jl]) {
        const float s = spc[jl];
        if (lo + jl != sink) {
          const int i = r4c[jl];
          u[i] = __fsub_rn(__fadd_rn(__ldcg(u + i), min_val), s);
        }
        v[jl] = __fsub_rn(v[jl], __fsub_rn(min_val, s));
      }
    }
    if (rank == 0 && tid == 0) {
      u[i_start] = __fadd_rn(__ldcg(u + i_start), min_val);
    }
    cluster_barrier();  // row4col is read above, rewritten below

    // Flip the matching along the path that ends in the free column `sink`.
    if (rank == 0 && tid == 0) {
      int j = sink;
      while (j >= 0) {
        const int owner_rank = j / width;
        const int jl = j - owner_rank * width;
        const int i = cluster.map_shared_rank(path, owner_rank)[jl];
        cluster.map_shared_rank(r4c, owner_rank)[jl] = i;
        const int j_next = col4row[i];
        col4row[i] = j;
        j = j_next;
      }
    }
    cluster_barrier();  // path and row4col are rewritten above, read below
  }

  // No CTA leaves while a slot it sent may be in flight or another CTA may
  // still read its shared memory.
  cluster_barrier();
  for (int jl = tid; jl < cols; jl += kThreads) {
    v_glob[lo + jl] = v[jl];
    row4col_glob[lo + jl] = r4c[jl];
  }
  if (rank == 0 && tid == 0) *steps_used = budget - steps_left;
}

}  // namespace

// The library's configuration, which the wrapper holds against its own:
// cluster size, threads per CTA, largest n, and the static shared memory of
// one CTA (the exchange slots and mbarriers).
extern "C" int pyfocusr_jv_config(int* cluster_size, int* threads, int* max_n,
                                  int* static_smem_bytes) {
  *cluster_size = kClusterSize;
  *threads = kThreads;
  *max_n = kMaxN;
  *static_smem_bytes = 2 * kSlots * (int)sizeof(Slot) + 16;
  return 0;
}

// Plain C entry point, loaded through ctypes.  All pointers are contiguous
// device arrays: cost f32 [n, n] (read only); free_rows i32 [n], the rows
// with col4row < 0 in ascending order, then n; u, v f32 [n] and row4col,
// col4row i32 [n], updated in place; steps_used i32 [1].  Launches one
// cluster of kClusterSize CTAs on `stream` without synchronising and
// returns cudaGetLastError() (0 on success), -1 for an n the CTAs' shared
// memory cannot hold (the Python wrapper rejects it before calling), or -2
// if the card cannot schedule the cluster.
extern "C" int pyfocusr_jv_f32(const float* cost, int n, const int* free_rows,
                               int budget, float* u, float* v, int* row4col,
                               int* col4row, int* steps_used, int device,
                               void* stream) {
  if (n < 1 || n > kMaxN) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int width = (n + kClusterSize - 1) / kClusterSize;
  // v, spc, path, row4col, then the byte mask rounded up to a word.
  const size_t smem = (size_t)width * 16 + (((size_t)width + 3) / 4) * 4;
  // The instance with the fewest columns a thread that holds the CTA's.
  const auto go = [&](auto kernel) {
    return launch_cluster(kernel, kClusterSize, kThreads, smem,
                          static_cast<cudaStream_t>(stream), cost, n, width,
                          free_rows, budget, u, v, row4col, col4row, steps_used);
  };
  const int per_thread = (width + kThreads - 1) / kThreads;
  if (per_thread <= 1) return go(jv_cluster_kernel<1>);
  if (per_thread <= 2) return go(jv_cluster_kernel<2>);
  if (per_thread <= 3) return go(jv_cluster_kernel<3>);
  if (per_thread <= 4) return go(jv_cluster_kernel<4>);
  if (per_thread <= 8) return go(jv_cluster_kernel<8>);
  return go(jv_cluster_kernel<16>);
}
