// Exact brute-force k-nearest-neighbour search for Hopper (sm_90a), for
// k = 4..128: the part of the TPU kernel that csrc/knn.cu (k = 1..3) leaves.
//
// Replaces the TPU kernel `knn_pallas` / `_knn_kernel`
// (pyfocusr_tpu/ops/pallas_kernels.py:647-796) for 4 <= k <= 128, with the
// contract of csrc/knn.cu and of the plain version `knn_plain` in
// ops/knn_kernel.py, which it equals bit for bit:
//   * squared distances are direct f32 sums  sum_d (q_d - r_d)^2 in
//     dimension order, multiply and add rounded separately (no FMA);
//   * ascending top-k, ties to the lower reference index;
//   * non-finite reference coordinates become 1e30 (such rows never win);
//   * a slot without a neighbour (fewer than k finite candidates, or a
//     squared distance >= 1e29) reports (inf, nr);
//   * Euclidean distances (correctly rounded sqrt) f32, indices int32.
//
// What bounds it on the H100: each pair costs 3 D unfused lane instructions
// (D subtractions, D multiplies, D - 1 adds, one compare), the data is a few
// hundred KB, so the distance work is issue-bound as in csrc/knn.cu.  What a
// large k adds is the running list: a candidate that beats the k-th entry
// has to be inserted into a sorted list of k.  Scanning references in index
// order, a query sees about k (1 + ln(nr / k)) insertions (690 at k = 128,
// nr = 10242), against nr candidates, so the list work is rare but wide.
//
// What the design does about it:
//   * a warp owns kQW queries and keeps each one's list spread over its 32
//     lanes, sorted by (distance, index): entry p = 32 r + lane in register
//     r of that lane, KP = ceil(k / 32) registers (templated, 1-4), so a list
//     of 128 costs four registers a lane;
//   * the lanes take 32 consecutive references at a time; one ballot finds
//     the candidates that beat the k-th entry (almost never, once the list
//     has filled), and each one, lowest lane first, is inserted by the whole
//     warp: a ballot per register counts the entries it beats (its place),
//     and one shuffle per register moves every later entry up one place.
//     The other candidates of the step are then checked again against the
//     new k-th entry;
//   * the block's 8 warps share reference tiles staged in shared memory, one
//     16-byte load a point at D <= 3, read once for the warp's kQW queries;
//   * an optional device flag `done` makes every block return at once, and
//     an optional 64-bit device counter receives the number of insertions
//     (what the list maintenance of these inputs cost; null on the path).
//
// Simple before fast: one warp a query pair means 641 blocks at 10242
// queries and no split of the reference axis, so a small query count leaves
// SMs idle.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQW = 2;  // queries a warp owns
constexpr int kQueriesPerCta = kWarps * kQW;
constexpr int kTileBytes = 16384;  // shared-memory tile of reference points
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Entry r of this lane's registers where r is only known at run time.
template <int KP, typename T>
__device__ __forceinline__ T pick(const T (&v)[KP], int r) {
  T out = v[0];
#pragma unroll
  for (int s = 1; s < KP; ++s) {
    if (s == r) out = v[s];
  }
  return out;
}

// Inserts (cd, ci) into the warp's sorted list (ld, li) of 32 KP entries:
// its place is the number of entries it beats, and every entry from that
// place on moves up one.  Every lane of the warp calls it with the same
// candidate.
template <int KP>
__device__ __forceinline__ void insert(float cd, int ci, float (&ld)[KP],
                                       int (&li)[KP], int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    pos += __popc(__ballot_sync(kFull, lex_less(ld[r], li[r], cd, ci)));
  }
  float pd[KP];
  int pi[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    // The entry one place below: the lane below in the same register, or
    // for lane 0 lane 31 of the register below.
    const float up_d = __shfl_up_sync(kFull, ld[r], 1);
    const int up_i = __shfl_up_sync(kFull, li[r], 1);
    const float wrap_d = __shfl_sync(kFull, ld[r > 0 ? r - 1 : 0], 31);
    const int wrap_i = __shfl_sync(kFull, li[r > 0 ? r - 1 : 0], 31);
    pd[r] = lane == 0 ? wrap_d : up_d;
    pi[r] = lane == 0 ? wrap_i : up_i;
  }
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    const int p = 32 * r + lane;
    if (p > pos) {
      ld[r] = pd[r];
      li[r] = pi[r];
    } else if (p == pos) {
      ld[r] = cd;
      li[r] = ci;
    }
  }
}

// Grid (ceil(nq / kQueriesPerCta)); warp w of block b owns queries
// (b kWarps + w) kQW + t, t < kQW.  DC dimensions are computed (D padded
// with zeros, which add (0 - 0)^2 = 0 exactly); SP is the shared-memory
// stride of a point in floats (a multiple of 4, for 16-byte loads).
template <int KP, int DC, int SP>
__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float* __restrict__ ref,
                    const float* __restrict__ query, int nr, int nq, int d,
                    int k, const int* __restrict__ done,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    unsigned long long* __restrict__ insertions) {
  constexpr int kTileRefs = kTileBytes / (SP * 4);
  static_assert(kTileRefs % 32 == 0, "a tile holds whole steps of 32");
  __shared__ __align__(16) float tile[kTileRefs * SP];

  // Every thread reads the same flag, so the block returns whole, before
  // any of its barriers.
  if (done != nullptr && *done != 0) return;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kQW;
  float q[kQW][DC];
#pragma unroll
  for (int t = 0; t < kQW; ++t) {
    const int qi = q0 + t;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      q[t][c] = (qi < nq && c < d) ? query[(size_t)qi * d + c] : 0.0f;
    }
  }
  float ld[kQW][KP];
  int li[kQW][KP];
  float wd[kQW];  // the k-th entry, the bar a candidate has to beat
  int wi[kQW];
#pragma unroll
  for (int t = 0; t < kQW; ++t) {
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      ld[t][r] = CUDART_INF_F;
      li[t][r] = nr;
    }
    wd[t] = CUDART_INF_F;
    wi[t] = nr;
  }
  const int kr = (k - 1) >> 5;  // register and lane of the k-th entry
  const int kl = (k - 1) & 31;
  unsigned long long inserted = 0;

  for (int base = 0; base < nr; base += kTileRefs) {
    const int n_tile = min(kTileRefs, nr - base);
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
    for (int j0 = 0; j0 < n_tile; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < n_tile;  // j < kTileRefs: the load is in bounds
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
      for (int t = 0; t < kQW; ++t) {
        // 0 + x is x exactly for the square x, so the sum starts at the
        // first square, as the plain version's does.
        const float d0 = __fsub_rn(q[t][0], r[0]);
        float acc = __fmul_rn(d0, d0);
#pragma unroll
        for (int c = 1; c < DC; ++c) {
          const float diff = __fsub_rn(q[t][c], r[c]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        // A squared distance >= 1e29 (or NaN) never fills a slot: the
        // slot keeps (inf, nr), which is what the plain version reports.
        bool want = valid && acc < 1e29f && lex_less(acc, idx, wd[t], wi[t]);
        unsigned m = __ballot_sync(kFull, want);
        while (m != 0u) {
          const int src = __ffs((int)m) - 1;
          const float cd = __shfl_sync(kFull, acc, src);
          insert<KP>(cd, base + j0 + src, ld[t], li[t], lane);
          wd[t] = __shfl_sync(kFull, pick<KP>(ld[t], kr), kl);
          wi[t] = __shfl_sync(kFull, pick<KP>(li[t], kr), kl);
          ++inserted;
          want = want && lane > src && lex_less(acc, idx, wd[t], wi[t]);
          m = __ballot_sync(kFull, want);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kQW; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) continue;
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int p = 32 * r + lane;
      if (p < k) {
        const bool bad = li[t][r] >= nr || !(ld[t][r] < 1e29f);
        out_d[(size_t)qi * k + p] =
            bad ? CUDART_INF_F : __fsqrt_rn(fmaxf(ld[t][r], 0.0f));
        out_i[(size_t)qi * k + p] = bad ? nr : li[t][r];
      }
    }
  }
  if (insertions != nullptr && lane == 0) atomicAdd(insertions, inserted);
}

template <int KP, int DC, int SP>
int launch(const float* ref, const float* query, int nr, int nq, int d, int k,
           const int* done, float* out_d, int* out_i,
           unsigned long long* insertions, cudaStream_t stream) {
  const int blocks = (nq + kQueriesPerCta - 1) / kQueriesPerCta;
  knn_topk_kernel<KP, DC, SP><<<blocks, kThreads, 0, stream>>>(
      ref, query, nr, nq, d, k, done, out_d, out_i, insertions);
  return (int)cudaGetLastError();
}

template <int KP>
int launch_kp(const float* ref, const float* query, int nr, int nq, int d,
              int k, const int* done, float* out_d, int* out_i,
              unsigned long long* insertions, cudaStream_t s) {
  if (d <= 3) {
    return launch<KP, 3, 4>(ref, query, nr, nq, d, k, done, out_d, out_i,
                            insertions, s);
  }
  if (d <= 8) {
    return launch<KP, 8, 8>(ref, query, nr, nq, d, k, done, out_d, out_i,
                            insertions, s);
  }
  return launch<KP, 16, 16>(ref, query, nr, nq, d, k, done, out_d, out_i,
                            insertions, s);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ref f32 [nr, d] and query f32
// [nq, d] are contiguous device arrays; out_d f32 [nq, k] and out_i i32
// [nq, k] are allocated by the caller; `done` is a device int32 flag or
// null; `insertions` a device uint64 counter or null.  Launches on `stream`
// without synchronising and returns the launch's error (0 on success), or -1
// for a k or d the kernel does not take, which the Python wrapper rejects
// before calling.
extern "C" int pyfocusr_knn_topk_f32(const float* ref, const float* query,
                                     int nr, int nq, int d, int k,
                                     const int* done, float* out_d,
                                     int* out_i,
                                     unsigned long long* insertions,
                                     int device, void* stream) {
  if (d < 1 || d > 16 || k < 4 || k > 128) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1:
      return launch_kp<1>(ref, query, nr, nq, d, k, done, out_d, out_i,
                          insertions, s);
    case 2:
      return launch_kp<2>(ref, query, nr, nq, d, k, done, out_d, out_i,
                          insertions, s);
    case 3:
      return launch_kp<3>(ref, query, nr, nq, d, k, done, out_d, out_i,
                          insertions, s);
    default:
      return launch_kp<4>(ref, query, nr, nq, d, k, done, out_d, out_i,
                          insertions, s);
  }
}
