// One step of the wide eigensolver's Chebyshev filter for Hopper (sm_90a):
// the ELL sparse product with the three-term recurrence folded in.
//
// No TPU kernel stands behind it: the JAX package computes the step as XLA
// products (an ELL gather-einsum, or on a TPU dense 128 x 128 patch blocks)
// inside the filter loop of `chebyshev_eigpairs_wide`
// (pyfocusr_tpu/ops/eigen.py).  As PyTorch operators over the ELL table the
// step is four or more launches on a CUDA device (the gather-einsum, the
// diagonal term, the subtractions), each reading and writing whole blocks.
//
// Contract (`cheb_step_plain` in ops/cheb_step_kernel.py): for the ELL table
// nbr int32 [n, d] (a padding slot has weight 0; its index must still lie in
// [0, n)), w f32 [n, d] = alpha s_i w_ij s_j and a_diag f32 [n] =
// alpha (sd_i - c mask_i) of `pipeline.ell_filter_factory`,
//     y_i   = a_diag_i t_i - sum_k w_{i,k} t_{nbr(i,k)}
//     out_i = 0.5 y_i           (first step of a chunk)
//     out_i = y_i - tprev_i     (every later step)
// over rows of b f32 columns.  `out` may be `tprev` (each element of out
// reads only the same element of tprev, in the same thread, before it is
// written); it must not overlap `t`.  Sums in f32 in neighbour order, FMA
// contracted: the plain version is a reference within rounding.  Slots of
// weight 0 are skipped (their product is 0 for finite t).
//
// What bounds it on the H100: the step reads the current block t and the
// previous block and writes one block, 3 n b 4 bytes, plus the table's
// n d 8 bytes: 65 MB at n = 40962, b = 128, d = 6, 19.4 us at 3.35 TB/s.
// The operations, 2 b (d + 1) a row, are 64 MFLOP, ~1 us at 67 TFLOP/s.  So
// it is bound by memory traffic, and each row of t is read by its own row
// and by ~6 neighbours: those repeated reads must come from the L2 (50 MB)
// and not from device memory.
//
// What the design does about it:
//   * A row a group of lanes: at b = 128 a warp owns a row, and each lane
//     holds 4 columns as a float4, so each neighbour's 512-byte row is one
//     coalesced read.  Narrower blocks give a row the fewest lanes (a power
//     of two) that cover its b / 4 float4s (b / 1 floats where b is not a
//     multiple of 4 or a pointer is not 16-byte aligned), so one warp holds
//     several rows; wider ones loop over the columns.  The wrapper picks
//     this from b (`cheb_step_kernel.plan`).
//   * A row's d indices and weights are read once, one slot a lane, and
//     broadcast across its lanes by shuffles; the neighbours' rows are then
//     loaded four at a time, all four in flight before the first is used,
//     with the row's own and its previous-block entries issued before them.
//   * Cache policy by last use: the previous block is read once and never
//     again (`ld.global.cs`, evict first); t goes through the read-only
//     path and stays in L2 for its neighbours; out is stored normally, so
//     that it is in L2 as the next step's t.  At b = 128 the three blocks
//     are 63 MB at 40962 rows, t and out 42 MB of it.
//   * The wrapper writes out over tprev from the third step on, so a chunk
//     of steps allocates two blocks once and nothing a step; the step reads
//     no scalar from the host and the host reads nothing back, so a chunk
//     can be captured in a CUDA graph.
//   * Overflow edges (hub vertices above the ELL width) are not in the
//     kernel: the wrapper adds them after it with one `index_add_`.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Neighbour rows a lane has in flight before it uses the first.
constexpr int kBatch = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& v) { v = 0.f; }

__device__ __forceinline__ float4 load_ro(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load_last(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_last(const float* p) { return __ldcs(p); }

__device__ __forceinline__ void fma_acc(float w, const float4& x, float4& acc) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}
__device__ __forceinline__ void fma_acc(float w, float x, float& acc) { acc = fmaf(w, x, acc); }

__device__ __forceinline__ float finish(float a, float t, float acc, float p, int first) {
  const float y = fmaf(a, t, -acc);
  return first ? 0.5f * y : y - p;
}
__device__ __forceinline__ float4 finish(float a, const float4& t, const float4& acc,
                                         const float4& p, int first) {
  return make_float4(finish(a, t.x, acc.x, p.x, first), finish(a, t.y, acc.y, p.y, first),
                     finish(a, t.z, acc.z, p.z, first), finish(a, t.w, acc.w, p.w, first));
}

// One step over n rows of `units` vectors of VEC floats; a row takes
// 1 << lanes_log2 lanes (`units` <= that many, or a loop over the columns).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    cheb_step_kernel(const float* __restrict__ t, const float* tprev, float* out,
                     const int* __restrict__ nbr, const float* __restrict__ w,
                     const float* __restrict__ a_diag, int n, int d, int units,
                     int lanes_log2, int first) {
  using V = typename Vec<VEC>::T;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const long long row_ll =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 >> lanes_log2) +
      (lane >> lanes_log2);
  // Rows past n run the shuffles with the last row and store nothing: every
  // lane of a warp takes part in every shuffle.
  const bool live = row_ll < n;
  const int row = live ? (int)row_ll : n - 1;
  const V* T = reinterpret_cast<const V*>(t);
  const V* P = reinterpret_cast<const V*>(tprev);
  V* O = reinterpret_cast<V*>(out);
  const float a = __ldg(a_diag + row);
  const int* nrow = nbr + (size_t)row * d;
  const float* wrow = w + (size_t)row * d;

  for (int u0 = 0; u0 < units; u0 += lanes) {
    const int u = u0 + sub;
    const bool col = u < units;
    const size_t at = (size_t)row * units + u;
    V self, prev, acc;
    zero(self);
    zero(prev);
    zero(acc);
    if (live && col) {
      self = load_ro(T + at);
      if (!first) prev = load_last(P + at);
    }
    for (int d0 = 0; d0 < d; d0 += lanes) {
      const int slot = d0 + sub;
      const int my_j = slot < d ? __ldg(nrow + slot) : row;
      const float my_w = slot < d ? __ldg(wrow + slot) : 0.f;
      const int dn = min(lanes, d - d0);
      for (int k = 0; k < dn; k += kBatch) {
        int j[kBatch];
        float wk[kBatch];
        V x[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          j[q] = __shfl_sync(kFull, my_j, k + q, lanes);
          wk[q] = __shfl_sync(kFull, my_w, k + q, lanes);
          // A source lane past the row's slots wraps inside the row's lanes.
          if (k + q >= dn) wk[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          zero(x[q]);
          if (wk[q] != 0.f && live && col) x[q] = load_ro(T + (size_t)j[q] * units + u);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) fma_acc(wk[q], x[q], acc);
      }
    }
    if (live && col) O[at] = finish(a, self, acc, prev, first);
  }
}

}  // namespace

// One filter step: t, tprev, out f32 [n, b] (row-major, contiguous; out may
// be tprev, must not overlap t; tprev unread when `first`), nbr int32 [n, d],
// w f32 [n, d], a_diag f32 [n].  vec 4 (b % 4 == 0 and every block 16-byte
// aligned) or 1; lanes_log2 in [0, 5]: the lanes a row takes.  Launches on
// `stream`; returns 0 or a CUDA error code.
extern "C" int pyfocusr_cheb_step_f32(const float* t, const float* tprev, float* out,
                                      const int* nbr, const float* w,
                                      const float* a_diag, int n, int d, int b,
                                      int vec, int lanes_log2, int first, int device,
                                      void* stream) {
  if ((vec != 1 && vec != 4) || b < 1 || b % vec != 0 || d < 1 || lanes_log2 < 0 ||
      lanes_log2 > 5)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long rows_per_block = (long long)kWarps * (32 >> lanes_log2);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    cheb_step_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, tprev, out, nbr, w, a_diag, n, d, b / 4, lanes_log2, first);
  else
    cheb_step_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, tprev, out, nbr, w, a_diag, n, d, b, lanes_log2, first);
  return (int)cudaGetLastError();
}
