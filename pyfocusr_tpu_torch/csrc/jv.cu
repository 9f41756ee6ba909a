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
// One launch does all of it.  The TPU version makes one kernel call per free
// row and hands spc / scanned / rvis / min_val back to the caller for the
// dual updates, because its compiler cannot gather from on-chip memory; a
// CUDA block can, so the loop over free rows, each search, its dual updates
// and its augmentation all happen here.
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
// agree exactly: same col4row, same step count.
//
// What bounds it on the H100: the search is sequential in its steps.  A step
// needs one cost row (4 n bytes, fetched from device memory or L2 at an
// address known only when the previous step's argmin is), a relax over n
// columns, and a block-wide (min, lowest index) reduction.  It is bound by
// the latency of that chain, and by the bytes of the rows it visits, not by
// arithmetic.
//
// What the design does about it:
//   * One block of 1024 threads on one SM; the other 131 SMs idle.  Thread t
//     owns columns t, t + 1024, ...: it alone reads and writes their v, spc
//     and scanned entries, so the relax needs no synchronisation, and its
//     cost-row loads are coalesced.  A thread issues the loads of all its
//     columns (16 at a time) before it uses the first: with one load in
//     flight per thread a step at n = 10242 cost eleven round trips to
//     device memory (5.3 us measured), with all in flight it costs one.
//   * Resident state.  v and spc (f32) and scanned (one byte) live in shared
//     memory, 9 n bytes: 92 KB at n = 10242, and n <= 25600 fits the 227 KB a
//     block may take.  Larger n is refused by the wrapper (no fallback).  u,
//     row4col, col4row, the predecessor array `path` and the list of visited
//     rows are touched at single indices during a search and stay in global
//     memory (L1/L2).
//   * The visited-row mask of the reference is a list here (a row is visited
//     at most once per search), so the u update costs the path's length, not
//     n.
//   * Two __syncthreads per step: after the warps' partial minima are in
//     shared memory, and after warp 0 has merged them, looked up the owner of
//     the chosen column and published (next row, min_val, sink).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;
// Columns a thread relaxes per round of loads: 16 covers n <= 16384 in one
// round, so a step waits for device memory once, not once per column.
constexpr int kBatch = 16;

struct Cand {
  float val;
  int idx;
};

__device__ __forceinline__ Cand cand_min(Cand a, Cand b) {
  return (b.val < a.val || (b.val == a.val && b.idx < a.idx)) ? b : a;
}

__device__ __forceinline__ Cand warp_cand_min(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.val = __shfl_xor_sync(0xffffffffu, c.val, off);
    o.idx = __shfl_xor_sync(0xffffffffu, c.idx, off);
    c = cand_min(c, o);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
    jv_kernel(const float* __restrict__ cost, int n,
              const int* __restrict__ free_rows, int budget, float* u,
              float* v_glob, int* row4col, int* col4row, int* path,
              int* visited, int* steps_used) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* spc = v + n;
  unsigned char* scanned = reinterpret_cast<unsigned char*>(spc + n);

  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int sh_i_cur;
  __shared__ int sh_sink;
  __shared__ float sh_min_val;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int j = tid; j < n; j += kThreads) v[j] = v_glob[j];

  int steps_left = budget;
  for (int k = 0; k < n && steps_left > 0; ++k) {
    const int i_start = free_rows[k];
    if (i_start >= n) break;  // the list is ascending, padded with n

    // The previous search's spc is read by other threads in its dual update.
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      spc[j] = kBig;
      scanned[j] = 0;
      path[j] = -1;
    }

    int i_cur = i_start;
    float min_val = 0.0f;
    int sink = -1;
    int steps = 0;
    while (sink < 0 && steps < steps_left) {
      if (tid == 0 && steps < n) visited[steps] = i_cur;
      const float u_i = u[i_cur];
      const float* row = cost + (size_t)i_cur * n;
      Cand best = {kBig, n};
      for (int base = 0; base < n; base += kBatch * kThreads) {
        // All of the batch's loads are issued before the first is used.
        float c[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = base + b * kThreads + tid;
          c[b] = j < n ? __ldg(row + j) : 0.0f;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = base + b * kThreads + tid;
          if (j >= n) break;
          const bool was_scanned = scanned[j] != 0;
          float s = spc[j];
          if (!was_scanned) {
            const float r =
                __fsub_rn(__fsub_rn(__fadd_rn(min_val, c[b]), u_i), v[j]);
            if (r < s) {
              s = r;
              spc[j] = r;
              path[j] = i_cur;
            }
          }
          // j rises within a thread, so a strict '<' keeps the lowest index.
          const float masked = was_scanned ? kBig : s;
          if (masked < best.val || best.idx == n) best = {masked, j};
        }
      }
      best = warp_cand_min(best);
      if (lane == 0) {
        red_val[warp] = best.val;
        red_idx[warp] = best.idx;
      }
      __syncthreads();
      if (warp == 0) {
        Cand c = {red_val[lane], red_idx[lane]};
        c = warp_cand_min(c);
        if (lane == 0) {
          const int j1 = c.idx;
          scanned[j1] = 1;
          const int owner = row4col[j1];
          sh_min_val = c.val;
          sh_sink = owner < 0 ? j1 : -1;
          sh_i_cur = owner < 0 ? i_cur : owner;
        }
      }
      __syncthreads();
      min_val = sh_min_val;
      sink = sh_sink;
      i_cur = sh_i_cur;
      ++steps;
    }
    steps_left -= steps;
    if (sink < 0) break;  // budget exhausted: this row and the rest stay free

    // Deferred dual updates, with col4row as it was before the flip.
    const int n_vis = min(steps, n);
    for (int t = tid; t < n_vis; t += kThreads) {
      const int i = visited[t];
      if (i == i_start) {
        u[i] = __fadd_rn(u[i], min_val);
      } else {
        u[i] = __fsub_rn(__fadd_rn(u[i], min_val), spc[col4row[i]]);
      }
    }
    for (int j = tid; j < n; j += kThreads) {
      if (scanned[j]) v[j] = __fsub_rn(v[j], __fsub_rn(min_val, spc[j]));
    }
    __syncthreads();  // col4row is read above, rewritten below

    // Flip the matching along the path that ends in the free column `sink`.
    if (tid == 0) {
      int j = sink;
      while (j >= 0) {
        const int i = path[j];
        row4col[j] = i;
        const int j_next = col4row[i];
        col4row[i] = j;
        j = j_next;
      }
    }
  }

  __syncthreads();
  for (int j = tid; j < n; j += kThreads) v_glob[j] = v[j];
  if (tid == 0) *steps_used = budget - steps_left;
}

}  // namespace

// Plain C entry point, loaded through ctypes.  All pointers are contiguous
// device arrays: cost f32 [n, n] (read only); free_rows i32 [n], the rows
// with col4row < 0 in ascending order, then n; u, v f32 [n] and row4col,
// col4row i32 [n], updated in place; path, visited i32 [n] scratch;
// steps_used i32 [1].  Launches one block on `stream` without synchronising
// and returns cudaGetLastError() (0 on success), or -1 for an n the block's
// shared memory cannot hold, which the Python wrapper rejects before calling.
extern "C" int pyfocusr_jv_f32(const float* cost, int n, const int* free_rows,
                               int budget, float* u, float* v, int* row4col,
                               int* col4row, int* path, int* visited,
                               int* steps_used, int device, void* stream) {
  constexpr int kMaxN = 25600;
  if (n < 1 || n > kMaxN) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // v and spc need 4-byte alignment: round the byte mask up to a word.
  const size_t smem = (size_t)n * 8 + (((size_t)n + 3) / 4) * 4;
  err = cudaFuncSetAttribute(jv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  jv_kernel<<<1, kThreads, smem, s>>>(cost, n, free_rows, budget, u, v,
                                      row4col, col4row, path, visited,
                                      steps_used);
  return (int)cudaGetLastError();
}
