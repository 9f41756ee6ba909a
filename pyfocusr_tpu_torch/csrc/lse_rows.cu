// Sinkhorn dual update for Hopper (sm_90a): one logsumexp per row, or per
// column, of a dense f32 cost matrix.
//
// Replaces the TPU kernel `_lse_rows_pallas` / `_lse_rows_kernel`
// (pyfocusr_tpu/ops/pallas_kernels.py:265-296) with the same function:
//
//   out_i = -(m_i + log(max(s_i, 1e-30)) / inv_t)
//   m_i   = max_j (vec_j - C_ij)
//   s_i   = sum_j exp(((vec_j - C_ij) - m_i) * inv_t)
//
// `pyfocusr_lse_rows_f32` reduces along the rows of C (the f update, vec = g);
// `pyfocusr_lse_cols_f32` reduces down the columns of C (the g update,
// vec = f): the function the TPU version gets by running the row kernel on a
// transpose it materialises once.  Here no transpose is made.
//
// What bounds it on the H100: each call reads the matrix once (4 n^2 bytes,
// 420 MB at n = 10242) and does ~7 flops and one exp per element, so it is
// bound by device-memory bandwidth, and one annealing schedule makes 840 such
// calls.
//
// What the design does about it:
//   * One pass over C per call.  The max and the sum are taken together as an
//     online pair (m, s), rescaling s when the running max rises; a two-pass
//     reduction would read each element twice, and down the columns the
//     second read would come from device memory again.  Four elements are
//     taken per update, so the rescale costs one exp per four elements at
//     most.  (m, s) pairs merge as s = s1 e^((m1-M) inv_t) + s2 e^((m2-M)
//     inv_t), M = max(m1, m2): the result differs from the two-pass plain
//     version by a few ulp of s, i.e. ~1e-6 / inv_t in the output.
//   * Rows: one block of 256 threads per row; a warp's 32 lanes read 32
//     consecutive floats (one 128-byte line), four independent loads in
//     flight per thread; the block's pairs merge by warp shuffles and one
//     pass through shared memory.
//   * Columns: no transpose.  A block owns 32 consecutive columns and one
//     chunk of rows; each of its 8 warps reads rows of 32 consecutive floats
//     (coalesced) and keeps one (m, s) per lane = per column.  The row axis
//     is split into `row_chunks` so that ~1e3 blocks fill the 132 SMs even
//     when n / 32 is small; the chunks' partial pairs go to a [row_chunks,
//     n_cols] workspace and a second small kernel merges them.
//   * No padding and no sentinels: the ragged edge is masked by index.  The
//     TPU version's 1e30 padding, dual masking and (256, n_pad) VMEM block
//     (which stops it at n = 8192) have no counterpart.
//   * f32 only; the TPU version's optional bf16 cost stream is not carried.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFloor = 1e-30f;

struct Pair {
  float m;  // running max of a = vec - C
  float s;  // sum of exp((a - m) * inv_t)
};

__device__ __forceinline__ Pair empty_pair() { return {-FLT_MAX, 0.0f}; }

__device__ __forceinline__ Pair merge(Pair a, Pair b, float inv_t) {
  const float M = fmaxf(a.m, b.m);
  // An empty side has m = -FLT_MAX and s = 0: its factor is exp(-huge) = 0
  // (or exp(0) = 1 when both are empty) and its term is 0 either way.
  return {M, a.s * expf((a.m - M) * inv_t) + b.s * expf((b.m - M) * inv_t)};
}

// Add up to four values a[k] (those with ok[k]) to the pair.
__device__ __forceinline__ void add4(Pair& p, const float (&a)[4],
                                     const bool (&ok)[4], float inv_t) {
  float m4 = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < 4; ++k) m4 = ok[k] ? fmaxf(m4, a[k]) : m4;
  if (m4 > p.m) {
    p.s *= expf((p.m - m4) * inv_t);
    p.m = m4;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ok[k]) p.s += expf((a[k] - p.m) * inv_t);
  }
}

__device__ __forceinline__ float finish(Pair p, float inv_t) {
  return -(p.m + logf(fmaxf(p.s, kFloor)) / inv_t);
}

__device__ __forceinline__ Pair warp_merge(Pair p, float inv_t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Pair o;
    o.m = __shfl_xor_sync(0xffffffffu, p.m, off);
    o.s = __shfl_xor_sync(0xffffffffu, p.s, off);
    p = merge(p, o, inv_t);
  }
  return p;
}

// out[i] for row i = blockIdx.x: reduce over the n_cols entries of the row.
__global__ void __launch_bounds__(kThreads)
    lse_rows_kernel(const float* __restrict__ cost,
                    const float* __restrict__ vec, int n_cols, float inv_t,
                    float* __restrict__ out) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_s[kWarps];
  const float* row = cost + (size_t)blockIdx.x * n_cols;
  Pair p = empty_pair();
  for (int base = 0; base < n_cols; base += 4 * kThreads) {
    float a[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = base + k * kThreads + threadIdx.x;
      ok[k] = j < n_cols;
      a[k] = ok[k] ? __ldg(vec + j) - __ldg(row + j) : 0.0f;
    }
    add4(p, a, ok, inv_t);
  }
  p = warp_merge(p, inv_t);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sm_m[warp] = p.m;
    sm_s[warp] = p.s;
  }
  __syncthreads();
  if (warp == 0) {
    const int lane = threadIdx.x;
    Pair q = lane < kWarps ? Pair{sm_m[lane], sm_s[lane]} : empty_pair();
    q = warp_merge(q, inv_t);
    if (lane == 0) out[blockIdx.x] = finish(q, inv_t);
  }
}

// Partial pairs of 32 columns (blockIdx.x) over one chunk of rows
// (blockIdx.y): part_m / part_s are [gridDim.y, n_cols].
__global__ void __launch_bounds__(kThreads)
    lse_cols_partial_kernel(const float* __restrict__ cost,
                            const float* __restrict__ vec, int n_rows,
                            int n_cols, int rows_per_chunk, float inv_t,
                            float* __restrict__ part_m,
                            float* __restrict__ part_s) {
  __shared__ float sm_m[kWarps][32];
  __shared__ float sm_s[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  const bool col_ok = j < n_cols;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(n_rows, r0 + rows_per_chunk);
  Pair p = empty_pair();
  for (int base = r0 + warp; base < r1; base += 4 * kWarps) {
    float a[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kWarps;
      ok[k] = col_ok && i < r1;
      a[k] = ok[k] ? __ldg(vec + i) - __ldg(cost + (size_t)i * n_cols + j)
                   : 0.0f;
    }
    add4(p, a, ok, inv_t);
  }
  sm_m[warp][lane] = p.m;
  sm_s[warp][lane] = p.s;
  __syncthreads();
  if (warp == 0 && col_ok) {
    Pair q = {sm_m[0][lane], sm_s[0][lane]};
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      q = merge(q, Pair{sm_m[w][lane], sm_s[w][lane]}, inv_t);
    }
    part_m[(size_t)blockIdx.y * n_cols + j] = q.m;
    part_s[(size_t)blockIdx.y * n_cols + j] = q.s;
  }
}

// out[j] from the row chunks' partial pairs of column j.
__global__ void __launch_bounds__(kThreads)
    lse_cols_finish_kernel(const float* __restrict__ part_m,
                           const float* __restrict__ part_s, int n_cols,
                           int row_chunks, float inv_t,
                           float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_cols) return;
  Pair q = {part_m[j], part_s[j]};
  for (int r = 1; r < row_chunks; ++r) {
    q = merge(q, Pair{part_m[(size_t)r * n_cols + j],
                      part_s[(size_t)r * n_cols + j]}, inv_t);
  }
  out[j] = finish(q, inv_t);
}

}  // namespace

// Plain C entry points, loaded through ctypes.  cost f32 [n_rows, n_cols] is
// a contiguous device array; outputs and workspaces are allocated by the
// caller.  Both launch on `stream` without synchronising and return
// cudaGetLastError() (0 on success).

// out[i] over the columns of row i; vec f32 [n_cols], out f32 [n_rows].
extern "C" int pyfocusr_lse_rows_f32(const float* cost, const float* vec,
                                     int n_rows, int n_cols, float inv_t,
                                     float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lse_rows_kernel<<<n_rows, kThreads, 0, s>>>(cost, vec, n_cols, inv_t, out);
  return (int)cudaGetLastError();
}

// out[j] over the rows of column j; vec f32 [n_rows], out f32 [n_cols],
// part_m and part_s f32 [row_chunks, n_cols] workspaces, 1 <= row_chunks.
extern "C" int pyfocusr_lse_cols_f32(const float* cost, const float* vec,
                                     int n_rows, int n_cols, float inv_t,
                                     int row_chunks, float* part_m,
                                     float* part_s, float* out, int device,
                                     void* stream) {
  if (row_chunks < 1 || row_chunks > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_chunk = (n_rows + row_chunks - 1) / row_chunks;
  const dim3 grid((n_cols + 31) / 32, row_chunks);
  lse_cols_partial_kernel<<<grid, kThreads, 0, s>>>(
      cost, vec, n_rows, n_cols, rows_per_chunk, inv_t, part_m, part_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lse_cols_finish_kernel<<<(n_cols + kThreads - 1) / kThreads, kThreads, 0,
                           s>>>(part_m, part_s, n_cols, row_chunks, inv_t,
                                out);
  return (int)cudaGetLastError();
}
