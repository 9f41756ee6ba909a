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
// What bounds it on the H100: the work is nq * nr pairs of D subtractions,
// multiplies and adds plus a compare, none of which may fuse into an FMA, so
// each takes a full issue slot of a lane (132 SMs x 128 lanes x 1.98 GHz =
// 3.345e13 lane instructions a second).  The data is tiny (10242 x 3 floats
// is 120 KB), so the kernel is bound by issue, not by memory.  Two things
// keep it from that bound at the main path's shapes: ICP asks for 2000
// queries against 10242 references, which by queries alone fills a third of
// the card; and a pair that costs 3 D ALU instructions (D subtractions and
// multiplies, D - 1 adds, one compare: 9 at D = 3) must not also cost a
// shared-memory load per coordinate.
//
// What the design does about it:
//   * register blocking: a thread owns kQ queries, so one 16-byte shared
//     load of a reference point (xyz and a pad; two or four loads at wider
//     D) feeds kQ pairs; kGroup lanes share the same queries and split the
//     CTA's references between them, interleaved;
//   * the reference axis is also split across the CTAs of a thread-block
//     cluster (1-16 CTAs, chosen so that the grid holds about two CTAs per
//     SM), each scanning one contiguous range.  At the end each lane group
//     merges its lanes' lists with warp shuffles, writes them to shared
//     memory, and after one cluster barrier the CTAs merge the ranks' lists
//     through distributed shared memory, query by query, in rank order.
//     Ranks own increasing index ranges and every merge is lexicographic in
//     (distance, index), so the lower-index tie rule holds across splits;
//     there is no workspace, no atomic and no second launch;
//   * within a lane candidates arrive in increasing index order, so the scan
//     admits a candidate on a strict distance compare alone;
//   * an optional device flag `done` makes every CTA return at once: a
//     captured ICP iteration replayed after convergence launches the kernel
//     and leaves its outputs as they were.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "cluster_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // lanes sharing a thread's queries; divides the warp
constexpr int kQ = 4;      // queries a thread owns
constexpr int kQueriesPerCta = kThreads / kGroup * kQ;
constexpr int kTileBytes = 16384;  // shared-memory tile of reference points
constexpr int kMaxSplit = 16;      // CTAs of a cluster (non-portable above 8)
constexpr int kCtasPerSm = 2;      // the split aims at this many CTAs a SM
constexpr int kMinRefsPerCta = 256;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the ascending list (bd, bi) if it beats the last entry
// under the (distance, index) order.  A NaN distance is never inserted.
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

// push() for a candidate whose index exceeds every index in the list (a
// lane's scan): a tie in distance keeps the earlier entry, so the strict
// distance compare alone is the lexicographic one.
template <int K>
__device__ __forceinline__ void scan_push(float d, int i, float (&bd)[K],
                                          int (&bi)[K]) {
  if (!(d < bd[K - 1])) return;
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    if (bd[t] < bd[t - 1]) {
      const float tf = bd[t];
      bd[t] = bd[t - 1];
      bd[t - 1] = tf;
      const int ti = bi[t];
      bi[t] = bi[t - 1];
      bi[t - 1] = ti;
    }
  }
}

template <int K>
__device__ __forceinline__ void write_out(const float (&bd)[K],
                                          const int (&bi)[K], int nr, int qi,
                                          float* out_d, int* out_i) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const bool bad = bi[t] >= nr || !(bd[t] < 1e29f);
    out_d[(size_t)qi * K + t] =
        bad ? CUDART_INF_F : __fsqrt_rn(fmaxf(bd[t], 0.0f));
    out_i[(size_t)qi * K + t] = bad ? nr : bi[t];
  }
}

// Grid (splits, query tiles), clusters of `splits` CTAs along x: CTA
// `rank` = blockIdx.x scans references [rank * chunk, (rank + 1) * chunk).
// DC dimensions are computed (D padded with zeros, which add (0 - 0)^2 = 0
// exactly); SP is the shared-memory stride of a point in floats (a multiple
// of 4, for 16-byte loads).
template <int K, int DC, int SP>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ ref, const float* __restrict__ query,
               int nr, int nq, int d, int chunk, const int* __restrict__ done,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kTileRefs = kTileBytes / (SP * 4);
  __shared__ __align__(16) float tile[kTileRefs * SP];
  __shared__ __align__(8) float2 part[kQueriesPerCta * K];

  const int rank = blockIdx.x;
  const int splits = gridDim.x;
  const int lane = threadIdx.x % kGroup;
  const int group = threadIdx.x / kGroup;
  const int q_tile = blockIdx.y * kQueriesPerCta;

  const int skip = done != nullptr ? *done : 0;
  float q[kQ][DC];
#pragma unroll
  for (int t = 0; t < kQ; ++t) {
    const int qi = q_tile + group * kQ + t;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      q[t][c] = (qi < nq && c < d) ? query[(size_t)qi * d + c] : 0.0f;
    }
  }
  // Every CTA of every cluster reads the same flag, so a cluster returns
  // whole, before any of its barriers (the flag's load overlaps the
  // queries').
  if (skip != 0) return;
  float bd[kQ][K];
  int bi[kQ][K];
#pragma unroll
  for (int t = 0; t < kQ; ++t) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[t][s] = CUDART_INF_F;
      bi[t][s] = nr;
    }
  }

  const int r_begin = min(nr, rank * chunk);
  const int r_end = min(nr, r_begin + chunk);
  for (int base = r_begin; base < r_end; base += kTileRefs) {
    const int n_tile = min(kTileRefs, r_end - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < n_tile * SP; e += kThreads) {
      const int j = e / SP;
      const int c = e - j * SP;
      float v = 0.0f;
      if (c < d) {
        v = ref[(size_t)(base + j) * d + c];
        if (!isfinite(v)) v = 1e30f;
      }
      tile[e] = v;
    }
    __syncthreads();
    const float4* tile4 = reinterpret_cast<const float4*>(tile);
#pragma unroll 4
    for (int j = lane; j < n_tile; j += kGroup) {
      float r[SP];
#pragma unroll
      for (int m = 0; m < SP / 4; ++m) {
        const float4 v = tile4[j * (SP / 4) + m];
        r[4 * m] = v.x;
        r[4 * m + 1] = v.y;
        r[4 * m + 2] = v.z;
        r[4 * m + 3] = v.w;
      }
      const int idx = base + j;
#pragma unroll
      for (int t = 0; t < kQ; ++t) {
        // 0 + x is x exactly for the square x (never -0), so the sum
        // starts at the first square, as the plain version's does.
        const float d0 = __fsub_rn(q[t][0], r[0]);
        float acc = __fmul_rn(d0, d0);
#pragma unroll
        for (int c = 1; c < DC; ++c) {
          const float diff = __fsub_rn(q[t][c], r[c]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        scan_push<K>(acc, idx, bd[t], bi[t]);
      }
    }
  }

  // Butterfly merge of the kGroup lanes' lists; every lane of the warp takes
  // part (inactive query slots included) so the full shuffle mask is valid.
#pragma unroll
  for (int t = 0; t < kQ; ++t) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(0xffffffffu, bd[t][s], off);
        oi[s] = __shfl_xor_sync(0xffffffffu, bi[t][s], off);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) push<K>(od[s], oi[s], bd[t], bi[t]);
    }
  }

  if (splits == 1) {
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < kQ; ++t) {
        const int qi = q_tile + group * kQ + t;
        if (qi < nq) write_out<K>(bd[t], bi[t], nr, qi, out_d, out_i);
      }
    }
    return;
  }

  // Across the cluster: each CTA publishes its lists, then merges the
  // queries ql = rank + splits * m of the tile over every rank, in order.
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kQ; ++t) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        part[(group * kQ + t) * K + s] =
            make_float2(bd[t][s], __int_as_float(bi[t][s]));
      }
    }
  }
  cluster_sync::cluster_barrier();
  const int ql = rank + splits * threadIdx.x;
  if (ql < kQueriesPerCta && q_tile + ql < nq) {
    float md[K];
    int mi[K];
    const unsigned local = cluster_sync::smem_u32(&part[ql * K]);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[s] = CUDART_INF_F;
      mi[s] = nr;
    }
    for (int r = 0; r < splits; ++r) {
      const unsigned remote = cluster_sync::cluster_u32(local, r);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float2 v = cluster_sync::ld_cluster_v2f32(remote + 8u * s);
        push<K>(v.x, __float_as_int(v.y), md, mi);
      }
    }
    write_out<K>(md, mi, nr, q_tile + ql, out_d, out_i);
  }
  // No CTA leaves while another may still read its shared memory.
  cluster_sync::cluster_barrier();
}

// The split of the reference axis for nq queries against nr references:
// doubled while the grid holds fewer than kCtasPerSm CTAs a SM and each CTA
// keeps at least kMinRefsPerCta references.
int plan_splits(int nq, int nr, int sms) {
  const int tiles = (nq + kQueriesPerCta - 1) / kQueriesPerCta;
  int splits = 1;
  while (splits < kMaxSplit && tiles * splits < kCtasPerSm * sms &&
         nr / (2 * splits) >= kMinRefsPerCta) {
    splits *= 2;
  }
  return splits;
}

template <int K, int DC, int SP>
int launch(const float* ref, const float* query, int nr, int nq, int d,
           int splits, const int* done, float* out_d, int* out_i,
           cudaStream_t stream) {
  auto kernel = knn_kernel<K, DC, SP>;
  const int chunk = (nr + splits - 1) / splits;
  const dim3 grid(splits, (nq + kQueriesPerCta - 1) / kQueriesPerCta);
  return cluster_sync::launch_grid_of_clusters(kernel, grid, splits, kThreads,
                                               0, stream, ref, query, nr, nq,
                                               d, chunk, done, out_d, out_i);
}

template <int K>
int launch_k(const float* ref, const float* query, int nr, int nq, int d,
             int splits, const int* done, float* out_d, int* out_i,
             cudaStream_t stream) {
  if (d <= 3) {
    return launch<K, 3, 4>(ref, query, nr, nq, d, splits, done, out_d, out_i,
                           stream);
  }
  if (d <= 8) {
    return launch<K, 8, 8>(ref, query, nr, nq, d, splits, done, out_d, out_i,
                           stream);
  }
  return launch<K, 16, 16>(ref, query, nr, nq, d, splits, done, out_d, out_i,
                           stream);
}

// The split for nq queries against nr references on `device`, from its SM
// count.
cudaError_t device_splits(int nq, int nr, int device, int* splits) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) *splits = plan_splits(nq, nr, sms);
  return err;
}

}  // namespace

// The launch shape for nq queries against nr references on `device`:
// out[0] query tiles, out[1] the split (CTAs a cluster), out[2] queries a
// CTA, out[3] threads a CTA, out[4] lanes sharing a query, out[5] queries a
// thread, out[6] reference points a shared-memory tile at D <= 3.  Returns
// the error of the SM-count query (0 on success).
extern "C" int pyfocusr_knn_plan(int nq, int nr, int device, int* out) {
  const cudaError_t err = device_splits(nq, nr, device, &out[1]);
  if (err != cudaSuccess) return (int)err;
  out[0] = (nq + kQueriesPerCta - 1) / kQueriesPerCta;
  out[2] = kQueriesPerCta;
  out[3] = kThreads;
  out[4] = kGroup;
  out[5] = kQ;
  out[6] = kTileBytes / 16;
  return 0;
}

// Plain C entry point, loaded through ctypes.  ref f32 [nr, d] and query
// f32 [nq, d] are contiguous device arrays; out_d f32 [nq, k] and out_i
// i32 [nq, k] are allocated by the caller; `done` is a device int32 flag or
// null.  Launches on `stream` without synchronising and returns the
// launch's error (0 on success), or -1 for an unsupported k / d, which the
// Python wrapper rejects before calling.
extern "C" int pyfocusr_knn_f32(const float* ref, const float* query, int nr,
                                int nq, int d, int k, const int* done,
                                float* out_d, int* out_i, int device,
                                void* stream) {
  if (d < 1 || d > 16) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  int splits = 1;
  err = device_splits(nq, nr, device, &splits);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch_k<1>(ref, query, nr, nq, d, splits, done, out_d, out_i, s);
    case 2:
      return launch_k<2>(ref, query, nr, nq, d, splits, done, out_d, out_i, s);
    case 3:
      return launch_k<3>(ref, query, nr, nq, d, splits, done, out_d, out_i, s);
    default:
      return -1;
  }
}
