// Exact brute-force k-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel `knn_pallas` / `_knn_kernel`
// (pyfocusr_tpu/ops/pallas_kernels.py:647-796) with the same contract:
//   * squared distances are direct f32 sums  sum_d (q_d - r_d)^2, accumulated
//     in dimension order with separately rounded multiply and add (no FMA
//     contraction, never the |q|^2 + |r|^2 - 2 q.r identity), so the result
//     is bit-identical to the plain PyTorch version in ops/knn_kernel.py;
//   * the running top-k is ascending, ties go to the lower reference index;
//   * non-finite reference coordinates are replaced by 1e30, so such rows
//     square to inf and never win;
//   * a slot without a neighbour (fewer than k finite candidates, or a
//     squared distance >= 1e29) reports index = nr and distance = inf;
//   * distances are returned Euclidean (correctly rounded sqrt), indices as
//     int32.
//
// What bounds it on the H100: the work is nq * nr * D subtract-multiply-add
// steps plus one compare per pair; the data is tiny (10242 x 3 floats is
// 120 KB), so the kernel is bound by issue rate and latency, not by memory.
// At the main path's shapes (~1e4 queries) one thread per query would fill
// less than a tenth of the card's thread slots.
//
// What the design does about it: GROUP consecutive lanes of a warp share one
// query and split the reference axis between them, so ~1e4 queries become
// ~8e4 threads; each lane keeps its own sorted top-k in registers (K is a
// template parameter, D is padded to 3, 8 or 16 and unrolled so the query
// row stays in registers).  Reference points are staged through shared
// memory tile by tile, stored dimension-major so the GROUP lanes read
// consecutive words (no bank conflicts) and lanes of other queries read the
// same words (broadcast).  At the end the GROUP partial lists are merged with
// warp shuffles under the lexicographic (distance, index) order, which keeps
// the lower-index tie rule whatever lane a candidate came from.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // lanes per query; divides the warp
constexpr int kQueriesPerBlock = kThreads / kGroup;
constexpr int kTile = 512;  // reference points per shared-memory tile

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the ascending list (bd, bi) if it beats the last entry.
// A NaN distance compares false and is never inserted.
template <int K>
__device__ __forceinline__ void push(float d, int i, float (&bd)[K],
                                     int (&bi)[K]) {
  if (!lex_less(d, i, bd[K - 1], bi[K - 1])) return;
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    if (lex_less(bd[t], bi[t], bd[t - 1], bi[t - 1])) {
      const float tf = bd[t];
      bd[t] = bd[t - 1];
      bd[t - 1] = tf;
      const int ti = bi[t];
      bi[t] = bi[t - 1];
      bi[t - 1] = ti;
    }
  }
}

template <int K, int DP>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ ref, const float* __restrict__ query,
               int nr, int nq, int d, float* __restrict__ out_d,
               int* __restrict__ out_i) {
  __shared__ float tile[DP][kTile];

  const int lane = threadIdx.x % kGroup;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.x / kGroup;
  const bool active = qi < nq;

  float q[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    q[c] = (active && c < d) ? query[(size_t)qi * d + c] : 0.0f;
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = nr;
  }

  for (int base = 0; base < nr; base += kTile) {
    const int n_tile = min(kTile, nr - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < n_tile * DP; e += kThreads) {
      const int j = e / DP;
      const int c = e - j * DP;
      float v = 0.0f;  // padded dimensions add (0 - 0)^2 = 0 exactly
      if (c < d) {
        v = ref[(size_t)(base + j) * d + c];
        if (!isfinite(v)) v = 1e30f;
      }
      tile[c][j] = v;
    }
    __syncthreads();
    for (int j = lane; j < n_tile; j += kGroup) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const float diff = __fsub_rn(q[c], tile[c][j]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      push<K>(acc, base + j, bd, bi);
    }
  }

  // Butterfly merge of the GROUP lanes' lists; every lane of the warp takes
  // part (inactive query slots included) so the full shuffle mask is valid.
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      od[t] = __shfl_xor_sync(0xffffffffu, bd[t], off);
      oi[t] = __shfl_xor_sync(0xffffffffu, bi[t], off);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) push<K>(od[t], oi[t], bd, bi);
  }

  if (active && lane == 0) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const bool bad = bi[t] >= nr || !(bd[t] < 1e29f);
      out_d[(size_t)qi * K + t] =
          bad ? CUDART_INF_F : __fsqrt_rn(fmaxf(bd[t], 0.0f));
      out_i[(size_t)qi * K + t] = bad ? nr : bi[t];
    }
  }
}

template <int K>
void launch_k(const float* ref, const float* query, int nr, int nq, int d,
              float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((nq + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (d <= 3) {
    knn_kernel<K, 3><<<grid, kThreads, 0, stream>>>(ref, query, nr, nq, d,
                                                    out_d, out_i);
  } else if (d <= 8) {
    knn_kernel<K, 8><<<grid, kThreads, 0, stream>>>(ref, query, nr, nq, d,
                                                    out_d, out_i);
  } else {
    knn_kernel<K, 16><<<grid, kThreads, 0, stream>>>(ref, query, nr, nq, d,
                                                     out_d, out_i);
  }
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ref f32 [nr, d] and query
// f32 [nq, d] are contiguous device arrays; out_d f32 [nq, k] and out_i
// i32 [nq, k] are allocated by the caller.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success), or -1 for an
// unsupported k / d, which the Python wrapper rejects before calling.
extern "C" int pyfocusr_knn_f32(const float* ref, const float* query, int nr,
                                int nq, int d, int k, float* out_d, int* out_i,
                                int device, void* stream) {
  if (d < 1 || d > 16) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      launch_k<1>(ref, query, nr, nq, d, out_d, out_i, s);
      break;
    case 2:
      launch_k<2>(ref, query, nr, nq, d, out_d, out_i, s);
      break;
    case 3:
      launch_k<3>(ref, query, nr, nq, d, out_d, out_i, s);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
