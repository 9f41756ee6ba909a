// Streamed CPD E-step for Hopper (sm_90a): the Gaussian responsibilities of
// Coherent Point Drift, reduced without ever forming the [M, N] matrix.
//
// Replaces the TPU kernels `_estep_den_kernel` and `_estep_row_kernel`
// behind `cpd_estep_pallas` (pyfocusr_tpu/ops/pallas_kernels.py:105,131,159)
// with the same two passes, each one launch:
//
//   den pass:  den_n = max(sum_m exp(-|x_n - ty_m|^2 / 2 s2) + c, 1e-30)
//              (raw exp, no max-rescaling: cycpd's semantics)
//              Pt1_n = 1 - c / den_n,  L = -sum_n log den_n + D N log(s2) / 2
//   row pass:  p_mn = exp(-|x_n - ty_m|^2 / 2 s2) / den_n
//              P1_m = sum_n p_mn,   PX_m = sum_n p_mn x_n,   Np = sum_m P1_m
//
// with c = (2 pi s2)^(D/2) w/(1-w) M/N.  sigma2 is read from the device, so
// the caller never reads it back and the launches can be captured in a CUDA
// graph; `done` (optional, on the device) makes both passes return at once
// when it is set, so iterations replayed after EM has converged cost nothing.
//
// Squared distances are direct differences sum_d (x_d - ty_d)^2, not the
// |x|^2 + |ty|^2 - 2 x.ty identity the TPU kernels take from the MXU: the
// identity cancels when sigma2 is small late in EM, and at D = 3 it would
// feed the tensor cores a depth of 3 in TF32, which breaks the f32 rule.
//
// What bounds it on the H100: per (m, n) pair the den pass issues ~9
// instructions with one exponential, the row pass ~13 with one; the inputs
// are a few hundred KB and stay in L2.  So the bound is the special-function
// units (16 exp per SM per clock: 0.050 ms for both passes at 10242^2) or
// instruction issue (~22 per pair at 128 lanes x 132 SMs: ~0.07 ms), not
// bytes.
//
// What the design does about it:
//   * exp2 by one `ex2.approx.ftz.f32` with log2(e) / (2 sigma2) folded into
//     one multiplier: one MUFU op per pair and no `expf` range reduction.
//   * A warp owns R output rows (4; 8 at D = 4-6; 2 where more would leave
//     the card short of warps, and at D > 8); every lane holds them in
//     registers and takes every 32nd point of the other cloud, so one
//     shared-memory load feeds R pairs.
//   * The other cloud is staged by the block as float4 vectors: (x, y, z, 0)
//     in the den pass and (x, y, z, 1/den) in the row pass at D <= 3, one
//     16-byte load per point; wider D takes 2-5 vectors (instances for 3, 6,
//     8, 16).
//   * Each warp reduces the whole other cloud, so no chunk workspace and no
//     merge pass exist: the 32 lanes' sums are merged by a fixed xor-shuffle
//     tree, identical in every lane.  At 10242 points that is 2561 warps,
//     one wave of ~19 warps an SM.  Np and L are sums over blocks: each
//     block writes its sum, and the last block to finish (an integer
//     counter, reset for the next launch) adds them in block order.  No
//     float atomics: the results repeat bit for bit.
//   * The ragged edges are masked by index; the TPU version's +-1e15
//     padding has no counterpart.
//
// Those instances hold a row and its PX accumulators in registers, so they
// stop at D = 16.  Wider coordinates (spectral features with xyz or node
// features appended) take the tiled instance, `estep_den_wide` /
// `estep_row_wide`, which computes the same contract for any D.  Per pair
// it costs 2 D lane instructions of distance in each pass (a subtraction and
// an FMA a dimension: the f32 rule forbids the identity), D FMAs of PX in
// the row pass and an exponential in each: at D = 19, 5000^2, about 0.08 ms
// of issue at the card's peak against a bound of 0.059 ms (8 D + 7 flops a
// pair at 67 TFLOP/s).  What the design does about it:
//   * a CTA of 4 warps owns 32 output rows; a thread holds 4 rows x 4 points
//     of a 64-point tile of the other cloud, so a float4 shared load of a
//     row or a point feeds 4 pairs (one load to 16 lane instructions).  Rows
//     and tile are staged as [point][dim] with a pitch of an odd number of
//     float4 (no bank conflicts), D rounded up to 4 (up to 64 at once; wider
//     D in chunks of 64);
//   * the other cloud is split across the `splits` CTAs of a thread-block
//     cluster (1-8, planned in ops/cpd_estep_kernel.py for up to 16 CTAs a
//     SM: 157 row tiles at 5000 points are too few for 132 SMs); after the
//     sweep the ranks' sums are added in rank order through distributed
//     shared memory, each CTA finishing a share of the rows;
//   * the row pass writes the tile's p to shared memory, and each thread
//     then adds p x for 4 rows x 4 dimensions over a share of the tile's
//     points (a float4 of p and one of x to 16 FMAs) into accumulators held
//     for the whole sweep, for up to 64 dimensions (blockIdx.z takes further
//     slabs of 64, each redoing the distances); the shares' sums are added
//     in a fixed order, then the ranks', and PX is written once;
//   * exp(x) of the plain version's rounded exponent by one ex2.approx and a
//     one-FMA correction of the rounding of x log2(e) (exp_of_exponent),
//     about 2 ulp, where the accurate expf costs ~9 instructions;
//   * padded points carry a weight of 0 (1/den in the row pass), so the
//     ragged tile needs no index test.  No float atomics: the results
//     repeat bit for bit.

// f32 only, D >= 1.

#include <cuda_runtime.h>

#include "cluster_sync.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 512;  // points of the other cloud per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// Rows a warp owns: kRows at D <= 3 and at 7-8, kRowsD6 at 4-6 (a staged
// point is two float4 there, so it is worth feeding more rows); 2 at D > 8
// and below kWideMin rows, where more rows a warp would leave the card
// short of warps (132 SMs x 16 warps x kRows rows).
constexpr int kRows = 4;
constexpr int kRowsD6 = 8;
constexpr int kWideMin = 132 * 16 * kRows;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Stages points [base, base + cols) of P [n, D] as V float4 vectors each,
// component `extra_at` holding extra[point] when extra is not null.
template <int V>
__device__ void stage(float4 (*dst)[V], const float* __restrict__ P, int D,
                      int base, int cols, const float* __restrict__ extra,
                      int extra_at) {
  for (int e = threadIdx.x; e < cols * V; e += kThreads) {
    const int r = e / V;
    const int d0 = (e % V) * 4;
    const float* src = P + (size_t)(base + r) * D;
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + i;
      w[i] = (extra != nullptr && d == extra_at) ? extra[base + r]
                                                 : (d < D ? src[d] : 0.0f);
    }
    dst[r][e % V] = make_float4(w[0], w[1], w[2], w[3]);
  }
}

// Sum over the blocks of the grid of one value per block, in block order
// (x fastest, then y, then z): every block writes its value to block_sums;
// the last block to arrive at `counter` adds them (thread t takes blocks t,
// t + kThreads, ..., then a fixed tree) and returns true in thread 0 with
// the total in *total.  The counter is reset to 0 for the next launch.
__device__ bool grid_sum(float block_value, float* block_sums, int* counter,
                         float* total) {
  __shared__ int last;
  __shared__ float red[kThreads];
  const int blocks = (int)(gridDim.x * gridDim.y * gridDim.z);
  const int block = (int)(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));
  if (threadIdx.x == 0) block_sums[block] = block_value;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == blocks - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  float s = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += kThreads) s += __ldcg(&block_sums[b]);
  red[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  *total = red[0];
  return threadIdx.x == 0;
}

// Sum of one value per warp (lane 0's) in warp order, in every thread.
__device__ float block_sum_of_warps(float warp_value) {
  __shared__ float per_warp[kWarps];
  if ((threadIdx.x & 31) == 0) per_warp[threadIdx.x >> 5] = warp_value;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += per_warp[w];
  return s;
}

struct Args {
  const float* X;       // [N, D]
  const float* TY;      // [M, D]
  int N, M, D;
  const float* sigma2;  // device scalar
  const int* done;      // device flag, or null
  float* inv_den;       // [N], written by the den pass, read by the row pass
  float* block_sums;    // [blocks]
  int* counter;         // zero between launches
};

// ---------------------------------------------------------------- den pass
// A warp owns R rows of X and reduces over all of TY.
template <int DP, int R>
__global__ void __launch_bounds__(kThreads)
    estep_den_kernel(Args a, float outlier_coef, float* __restrict__ pt1,
                     float* __restrict__ L) {
  constexpr int V = (DP + 3) / 4;
  if (a.done != nullptr && *a.done) return;
  __shared__ float4 sty[kTile][V];
  const int lane = threadIdx.x & 31;
  const float s2 = *a.sigma2;
  const float scale = -kLog2e / (2.0f * s2);
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  float x[R][DP];
  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int n = row0 + j;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      x[j][d] = (n < a.N && d < a.D) ? a.X[(size_t)n * a.D + d] : 0.0f;
    }
    acc[j] = 0.0f;
  }
  for (int base = 0; base < a.M; base += kTile) {
    const int cols = min(kTile, a.M - base);
    __syncthreads();  // the previous tile has been read
    stage<V>(sty, a.TY, a.D, base, cols, nullptr, -1);
    __syncthreads();
#pragma unroll 4
    for (int r = lane; r < cols; r += 32) {
      float4 t[V];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = sty[r][v];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float d2 = 0.0f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          const float diff = x[j][d] - comp(t[d / 4], d % 4);
          d2 = fmaf(diff, diff, d2);
        }
        acc[j] += fast_exp2(d2 * scale);
      }
    }
  }
  const float c = outlier_coef > 0.0f
                      ? powf(2.0f * 3.14159265358979f * s2, 0.5f * a.D) * outlier_coef
                      : 0.0f;
  float log_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float v = fmaxf(warp_sum(acc[j]) + c, 1e-30f);
    const int n = row0 + j;
    if (n < a.N) {
      const float inv = 1.0f / v;
      if (lane == j) {
        a.inv_den[n] = inv;
        pt1[n] = 1.0f - c * inv;
      }
      log_sum += logf(v);
    }
  }
  float total;
  if (grid_sum(block_sum_of_warps(log_sum), a.block_sums, a.counter, &total)) {
    *L = -total + (float)a.D * (float)a.N * logf(s2) / 2.0f;
  }
}

// ---------------------------------------------------------------- row pass
// A warp owns R rows of TY and reduces over all of X.  p1px is P1 [M] then
// PX [M, D].
template <int DP, int R>
__global__ void __launch_bounds__(kThreads)
    estep_row_kernel(Args a, float* __restrict__ p1px, float* __restrict__ Np) {
  constexpr int V = (DP + 4) / 4;  // x_n, then 1 / den_n at component DP
  if (a.done != nullptr && *a.done) return;
  __shared__ float4 sx[kTile][V];
  const int lane = threadIdx.x & 31;
  const float scale = -kLog2e / (2.0f * *a.sigma2);
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  float ty[R][DP];
  float px[R][DP];
  float p1[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int m = row0 + j;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      ty[j][d] = (m < a.M && d < a.D) ? a.TY[(size_t)m * a.D + d] : 0.0f;
      px[j][d] = 0.0f;
    }
    p1[j] = 0.0f;
  }
  for (int base = 0; base < a.N; base += kTile) {
    const int cols = min(kTile, a.N - base);
    __syncthreads();
    stage<V>(sx, a.X, a.D, base, cols, a.inv_den, DP);
    __syncthreads();
#pragma unroll 4
    for (int r = lane; r < cols; r += 32) {
      float4 t[V];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = sx[r][v];
      const float inv = comp(t[DP / 4], DP % 4);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float d2 = 0.0f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          const float diff = comp(t[d / 4], d % 4) - ty[j][d];
          d2 = fmaf(diff, diff, d2);
        }
        const float p = fast_exp2(d2 * scale) * inv;
        p1[j] += p;
#pragma unroll
        for (int d = 0; d < DP; ++d) px[j][d] = fmaf(p, comp(t[d / 4], d % 4), px[j][d]);
      }
    }
  }
  float p1_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float s = warp_sum(p1[j]);
    const int m = row0 + j;
    if (m < a.M) {
      if (lane == j) p1px[m] = s;
      p1_sum += s;
    }
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const float v = warp_sum(px[j][d]);
      if (m < a.M && d < a.D && lane == j) p1px[a.M + (size_t)m * a.D + d] = v;
    }
  }
  float total;
  if (grid_sum(block_sum_of_warps(p1_sum), a.block_sums, a.counter, &total)) {
    *Np = total;
  }
}

// ------------------------------------------------ D > 16: the tiled instance
constexpr int kRegisterD = 16;   // widest D of the register-resident instances
constexpr int kWideOwn = 32;     // output rows a CTA owns
constexpr int kWideTile = 64;    // points of the other cloud a shared-memory tile
constexpr int kWideMaxSplit = 8; // CTAs of a cluster splitting the other cloud
constexpr int kPPitch = kWideOwn + 4;  // p tile [point][row]: conflict-free float4 stores

// Dimensions staged at once for D in (16, 32] and above 32: the row pass
// keeps PX's accumulators for DP dimensions in registers, and D > 64 is
// taken 64 dimensions at a time (chunks of the distance, slabs of PX).
int wide_dp(int D) { return D <= 32 ? 32 : 64; }

// Width of a staged chunk in floats (D, or DP, rounded up to 4) and the
// pitch of a staged point: a number of float4 that is odd, so the 16 points
// a half-warp reads with one float4 load each sit in distinct bank groups.
struct WideLayout {
  int groups;  // float4 groups of the widest chunk
  int pitch;   // floats
};

__host__ __device__ inline WideLayout wide_layout(int D, int DP) {
  const int width = D < DP ? D : DP;
  const int groups = (width + 3) / 4;
  return {groups, 4 * (groups % 2 == 1 ? groups : groups + 1)};
}

// e^x for the E-step's exponent x = d2 * -(1 / 2 sigma2) <= 0, rounded as
// the plain version rounds it: 2^y by one ex2.approx for y = x log2(e)
// rounded, times 1 + lo ln 2 for the rounding lo of that product (one FMA
// and a product with log2(e)'s low part).  x is clamped at -126 (e^x flushes
// to 0 below ~-87.3, as the den's 1e-30 floor makes harmless) so that -inf
// gives 0; NaN stays NaN.
__device__ __forceinline__ float exp_of_exponent(float x) {
  constexpr float kLog2eHi = 1.44269502162933349609375f;
  constexpr float kLog2eLo = 1.925963033500011e-08f;
  constexpr float kLn2 = 0.693147180559945309f;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(x) : "f"(x), "f"(-126.0f));
  const float y = x * kLog2eHi;
  float lo = fmaf(x, kLog2eHi, -y);
  lo = fmaf(x, kLog2eLo, lo);
  const float r = fast_exp2(y);
  return fmaf(r, lo * kLn2, r);
}

// Stages float4 groups [0, groups) of dimensions [c0, c0 + 4 groups) of rows
// [base, base + count) of P [n, D] into s (ROWS rows of `pitch` floats),
// zeros past D and past count.  kThreads / ROWS threads share a row.
template <int ROWS>
__device__ __forceinline__ void stage_wide(float* s, const float* __restrict__ P, int D,
                                           int base, int count, int c0, int groups,
                                           int pitch) {
  constexpr int kPerRow = kThreads / ROWS;
  const int r = threadIdx.x / kPerRow;
  const float* src = P + (size_t)(base + min(r, count - 1)) * D;
  for (int g = threadIdx.x % kPerRow; g < groups; g += kPerRow) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = c0 + 4 * g + i;
      v[i] = (r < count && d < D) ? __ldg(src + d) : 0.0f;
    }
    *reinterpret_cast<float4*>(s + r * pitch + 4 * g) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The tile of the other cloud (D <= 64: one chunk) held in registers from
// its load out of device memory to its store into shared memory, so that
// the next tile's loads are in flight while this one is computed.  Two
// threads share a point; `weight` (1/den in the row pass) or 1 for a point
// of the tile, 0 past it.
template <int DP>
struct TilePrefetch {
  static constexpr int kPerRow = kThreads / kWideTile;
  static constexpr int kMax = DP / 4 / kPerRow;  // float4 groups a thread
  float4 v[kMax];
  float w;

  __device__ __forceinline__ void load(const float* __restrict__ P, int D, int base,
                                       int count, int groups,
                                       const float* __restrict__ weight) {
    const int r = threadIdx.x / kPerRow;
    const float* src = P + (size_t)(base + min(r, count - 1)) * D;
#pragma unroll
    for (int m = 0; m < kMax; ++m) {
      const int g = threadIdx.x % kPerRow + kPerRow * m;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * g + i;
        x[i] = (g < groups && r < count && d < D) ? __ldg(src + d) : 0.0f;
      }
      v[m] = make_float4(x[0], x[1], x[2], x[3]);
    }
    if (threadIdx.x < kWideTile) {
      w = threadIdx.x < count ? (weight != nullptr ? __ldg(weight + base + threadIdx.x) : 1.0f)
                              : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* s, float* s_w, int groups, int pitch) const {
    const int r = threadIdx.x / kPerRow;
#pragma unroll
    for (int m = 0; m < kMax; ++m) {
      const int g = threadIdx.x % kPerRow + kPerRow * m;
      if (g < groups) *reinterpret_cast<float4*>(s + r * pitch + 4 * g) = v[m];
    }
    if (threadIdx.x < kWideTile) s_w[threadIdx.x] = w;
  }
};

// Adds the squared distances of the thread's 4 own rows (`own`, rows 4 tr +
// j) to its 4 points of the tile (`other`, points tc + 16 i) over `groups`
// float4 groups of a staged chunk, fmaf in dimension order.
__device__ __forceinline__ void wide_d2(float (&d2)[4][4], const float* own,
                                        const float* other, int pitch, int groups) {
#pragma unroll 2
  for (int g = 0; g < groups; ++g) {
    float4 a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = *reinterpret_cast<const float4*>(own + j * pitch + 4 * g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = *reinterpret_cast<const float4*>(other + 16 * i * pitch + 4 * g);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float t = a[j].x - b[i].x;
        d2[j][i] = fmaf(t, t, d2[j][i]);
        t = a[j].y - b[i].y;
        d2[j][i] = fmaf(t, t, d2[j][i]);
        t = a[j].z - b[i].z;
        d2[j][i] = fmaf(t, t, d2[j][i]);
        t = a[j].w - b[i].w;
        d2[j][i] = fmaf(t, t, d2[j][i]);
      }
    }
  }
}

// A float of CTA `rank`'s shared memory at the address of `local` in this
// CTA (the cluster's split); this CTA's own when there is no split.
__device__ __forceinline__ float rank_value(const float* local, int rank, int splits) {
  if (splits == 1) return *local;
  return cluster_sync::ld_cluster_f32(
      cluster_sync::cluster_u32(cluster_sync::smem_u32(local), rank));
}

__device__ __forceinline__ void split_barrier(int splits) {
  if (splits > 1) {
    cluster_sync::cluster_barrier();
  } else {
    __syncthreads();
  }
}

// The staged tiles of both wide passes.  The row pass reuses the space for
// its warps' PX partial sums once the sweep is over.
template <int DP>
struct WideTiles {
  float own[kWideOwn * (DP + 4)];
  float other[kWideTile * (DP + 4)];
  float p[kWideTile * kPPitch];  // row pass: p of the tile, [point][row]
};

// The den pass for D > 16.  Grid (splits, own tiles), clusters of `splits`
// CTAs along x: CTA `rank` owns rows [32 y, 32 y + 32) of X and sums over
// TY rows [rank chunk, (rank + 1) chunk); the ranks' sums are added in rank
// order through distributed shared memory.  A thread holds 4 rows x 4
// points of a 64-point tile (tr = thread / 16, tc = thread % 16).
template <int DP>
__global__ void __launch_bounds__(kThreads)
    estep_den_wide(Args a, float outlier_coef, int chunk, float* __restrict__ pt1,
                   float* __restrict__ L) {
  if (a.done != nullptr && *a.done) return;
  __shared__ __align__(16) WideTiles<DP> sm;
  __shared__ float s_w[kWideTile];
  __shared__ float s_part[kWideOwn];
  const int rank = blockIdx.x, splits = gridDim.x;
  const int own0 = blockIdx.y * kWideOwn;
  const int n_own = min(kWideOwn, a.N - own0);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float s2 = *a.sigma2;
  const float neg = -(1.0f / (2.0f * s2));
  const int o_begin = min(a.M, rank * chunk), o_end = min(a.M, o_begin + chunk);
  const WideLayout lay = wide_layout(a.D, DP);
  const int nch = (a.D + DP - 1) / DP;
  const float* own = sm.own + 4 * tr * lay.pitch;
  const float* other = sm.other + tc * lay.pitch;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  TilePrefetch<DP> pre;
  if (nch == 1) {
    stage_wide<kWideOwn>(sm.own, a.X, a.D, own0, n_own, 0, lay.groups, lay.pitch);
    if (o_begin < o_end) {
      pre.load(a.TY, a.D, o_begin, min(kWideTile, o_end - o_begin), lay.groups, nullptr);
    }
  }
  for (int base = o_begin; base < o_end; base += kWideTile) {
    const int cnt = min(kWideTile, o_end - base);
    float d2[4][4] = {};
    if (nch == 1) {
      __syncthreads();  // the previous tile has been read
      pre.store(sm.other, s_w, lay.groups, lay.pitch);
      __syncthreads();
      const int next = base + kWideTile;
      if (next < o_end) pre.load(a.TY, a.D, next, min(kWideTile, o_end - next), lay.groups, nullptr);
      wide_d2(d2, own, other, lay.pitch, lay.groups);
    }
    for (int c = 0; nch > 1 && c < nch; ++c) {
      const int groups = (min(DP, a.D - c * DP) + 3) / 4;
      __syncthreads();  // the previous chunk has been read
      stage_wide<kWideOwn>(sm.own, a.X, a.D, own0, n_own, c * DP, groups, lay.pitch);
      stage_wide<kWideTile>(sm.other, a.TY, a.D, base, cnt, c * DP, groups, lay.pitch);
      if (c == 0 && threadIdx.x < kWideTile) s_w[threadIdx.x] = threadIdx.x < cnt ? 1.0f : 0.0f;
      __syncthreads();
      wide_d2(d2, own, other, lay.pitch, groups);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = s_w[tc + 16 * i];  // 0 past the tile
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(exp_of_exponent(d2[j][i] * neg), w, acc[j]);
    }
  }
  // The 16 threads of a row group, by a fixed xor tree.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (tc == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s_part[4 * tr + j] = acc[j];
  }
  split_barrier(splits);  // every rank's sums are published
  const float c = outlier_coef > 0.0f
                      ? powf(2.0f * 3.14159265358979f * s2, 0.5f * a.D) * outlier_coef
                      : 0.0f;
  float log_sum = 0.0f;
  // This CTA finishes rows rank, rank + splits, ... of the tile.
  const int r = rank + splits * threadIdx.x;
  if (r < n_own) {
    float s = 0.0f;
    for (int q = 0; q < splits; ++q) s += rank_value(&s_part[r], q, splits);
    const float v = fmaxf(s + c, 1e-30f);
    const float inv = 1.0f / v;
    a.inv_den[own0 + r] = inv;
    pt1[own0 + r] = 1.0f - c * inv;
    log_sum = logf(v);
  }
  split_barrier(splits);  // no CTA leaves while another reads its sums
  float total;
  if (grid_sum(block_sum_of_warps(warp_sum(log_sum)), a.block_sums, a.counter, &total)) {
    *L = -total + (float)a.D * (float)a.N * logf(s2) / 2.0f;
  }
}

// The row pass for D > 16: as the den pass with the roles swapped (a CTA
// owns 32 rows of TY and sums over X with 1/den), plus PX for dimensions
// [DP z, DP z + DP) of blockIdx.z (one slab for D <= 64).  Each tile's p
// goes to shared memory; then a thread adds p x for 4 rows x 4 dimensions
// over its share of the tile's points (two float4 loads to 16 FMAs) into
// accumulators held for the whole sweep.  At the end the threads' sums are
// added in slice order, then the ranks' in rank order.  P1 and Np come
// from slab 0.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    estep_row_wide(Args a, int chunk, float* __restrict__ p1px, float* __restrict__ Np) {
  if (a.done != nullptr && *a.done) return;
  constexpr int kPxPitch = DP + 1;
  constexpr int kMaxSlices = 4;
  static_assert(kMaxSlices * kWideOwn * kPxPitch <= sizeof(WideTiles<DP>) / 4,
                "the slices' PX sums fit in the tiles' space");
  __shared__ __align__(16) WideTiles<DP> sm;
  __shared__ float s_w[kWideTile];
  __shared__ float s_p1[kWideOwn];
  const int rank = blockIdx.x, splits = gridDim.x, slab = blockIdx.z;
  const int own0 = blockIdx.y * kWideOwn;
  const int n_own = min(kWideOwn, a.M - own0);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float neg = -(1.0f / (2.0f * *a.sigma2));
  const int o_begin = min(a.N, rank * chunk), o_end = min(a.N, o_begin + chunk);
  const WideLayout lay = wide_layout(a.D, DP);
  const int nch = (a.D + DP - 1) / DP;
  const int slab_groups = (min(DP, a.D - slab * DP) + 3) / 4;
  const float* own = sm.own + 4 * tr * lay.pitch;
  const float* other = sm.other + tc * lay.pitch;
  float p1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // PX as 4 rows x 4 dimensions a thread: `items` (row group, dimension
  // group) pairs, the tile's points split `slices` ways among the threads
  // that share an item (points slice, slice + slices, ...).
  const int items = (kWideOwn / 4) * slab_groups;
  const int slices = min(kMaxSlices, kThreads / items);
  const int item = threadIdx.x % items, slice = threadIdx.x / items;
  const int rg = item % (kWideOwn / 4), dg = item / (kWideOwn / 4);
  const bool px_thread = slice < slices;
  float px[4][4] = {};
  TilePrefetch<DP> pre;
  if (nch == 1) {
    stage_wide<kWideOwn>(sm.own, a.TY, a.D, own0, n_own, 0, lay.groups, lay.pitch);
    if (o_begin < o_end) {
      pre.load(a.X, a.D, o_begin, min(kWideTile, o_end - o_begin), lay.groups, a.inv_den);
    }
  }
  for (int base = o_begin; base < o_end; base += kWideTile) {
    const int cnt = min(kWideTile, o_end - base);
    float d2[4][4] = {};
    if (nch == 1) {
      __syncthreads();  // the previous tile and its p have been read
      pre.store(sm.other, s_w, lay.groups, lay.pitch);
      __syncthreads();
      const int next = base + kWideTile;
      if (next < o_end) {
        pre.load(a.X, a.D, next, min(kWideTile, o_end - next), lay.groups, a.inv_den);
      }
      wide_d2(d2, own, other, lay.pitch, lay.groups);
    }
    for (int c = 0; nch > 1 && c < nch; ++c) {
      const int groups = (min(DP, a.D - c * DP) + 3) / 4;
      __syncthreads();  // the previous chunk, or tile and p, has been read
      stage_wide<kWideOwn>(sm.own, a.TY, a.D, own0, n_own, c * DP, groups, lay.pitch);
      stage_wide<kWideTile>(sm.other, a.X, a.D, base, cnt, c * DP, groups, lay.pitch);
      if (c == 0 && threadIdx.x < kWideTile) {
        s_w[threadIdx.x] = threadIdx.x < cnt ? a.inv_den[base + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      wide_d2(d2, own, other, lay.pitch, groups);
    }
    if (nch > 1 && slab != nch - 1) {  // PX's slab is not the last chunk
      __syncthreads();
      stage_wide<kWideTile>(sm.other, a.X, a.D, base, cnt, slab * DP, slab_groups, lay.pitch);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = s_w[tc + 16 * i];  // 1/den, 0 past the tile: p = 0 there
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = exp_of_exponent(d2[j][i] * neg) * w;
        p1[j] += p[j];
      }
      *reinterpret_cast<float4*>(&sm.p[(tc + 16 * i) * kPPitch + 4 * tr]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // the tile's p is complete
    if (px_thread) {
      for (int pt = slice; pt < kWideTile; pt += slices) {
        const float4 pv = *reinterpret_cast<const float4*>(&sm.p[pt * kPPitch + 4 * rg]);
        const float4 xv = *reinterpret_cast<const float4*>(sm.other + pt * lay.pitch + 4 * dg);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          px[j][0] = fmaf(pr[j], xv.x, px[j][0]);
          px[j][1] = fmaf(pr[j], xv.y, px[j][1]);
          px[j][2] = fmaf(pr[j], xv.z, px[j][2]);
          px[j][3] = fmaf(pr[j], xv.w, px[j][3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) p1[j] += __shfl_xor_sync(kFull, p1[j], off);
  }
  float* part = reinterpret_cast<float*>(&sm);  // [slice][row][kPxPitch]
  __syncthreads();  // the tiles are no longer read
  if (tc == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s_p1[4 * tr + j] = p1[j];
  }
  if (px_thread) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[(slice * kWideOwn + 4 * rg + j) * kPxPitch + 4 * dg + i] = px[j][i];
      }
    }
  }
  __syncthreads();
  // Slice order, into slice 0's slots.
  for (int e = threadIdx.x; e < kWideOwn * 4 * slab_groups; e += kThreads) {
    const int row = e / (4 * slab_groups), d = e - row * 4 * slab_groups;
    float s = part[row * kPxPitch + d];
    for (int q = 1; q < slices; ++q) s += part[(q * kWideOwn + row) * kPxPitch + d];
    part[row * kPxPitch + d] = s;
  }
  split_barrier(splits);  // every rank's sums are published
  // This CTA finishes rows rank, rank + splits, ... of the tile: P1 (slab 0)
  // and the slab's PX columns, each summed over the ranks in rank order.
  float p1_sum = 0.0f;
  const int rows_here = n_own > rank ? (n_own - rank + splits - 1) / splits : 0;
  const int cols = 1 + min(DP, a.D - slab * DP);
  for (int e = threadIdx.x; e < rows_here * cols; e += kThreads) {
    const int rr = e / cols, col = e - rr * cols;
    const int r = rank + splits * rr;
    float s = 0.0f;
    if (col == 0) {
      if (slab == 0) {
        for (int q = 0; q < splits; ++q) s += rank_value(&s_p1[r], q, splits);
        p1px[own0 + r] = s;
        p1_sum += s;
      }
    } else {
      for (int q = 0; q < splits; ++q) s += rank_value(&part[r * kPxPitch + col - 1], q, splits);
      p1px[a.M + (size_t)(own0 + r) * a.D + slab * DP + col - 1] = s;
    }
  }
  split_barrier(splits);  // no CTA leaves while another reads its sums
  float total;
  if (grid_sum(block_sum_of_warps(warp_sum(p1_sum)), a.block_sums, a.counter, &total)) {
    *Np = total;
  }
}

int padded(int D) { return D <= 3 ? 3 : D <= 6 ? 6 : D <= 8 ? 8 : 16; }

// Rows a warp owns for `rows` output rows at width D <= 16.
int rows_per_warp(int rows, int D) {
  if (rows < kWideMin || padded(D) > 8) return 2;
  return padded(D) == 6 ? kRowsD6 : kRows;
}

int blocks_for(int rows, int D) {
  const int per_block = kWarps * rows_per_warp(rows, D);
  return (rows + per_block - 1) / per_block;
}

int wide_tiles(int rows) { return (rows + kWideOwn - 1) / kWideOwn; }

// PX slabs of the wide row pass (blockIdx.z): one up to D = 64.
int wide_slabs(int D) { return (D + wide_dp(D) - 1) / wide_dp(D); }

int den_blocks(int N, int D, int splits) {
  return D > kRegisterD ? splits * wide_tiles(N) : blocks_for(N, D);
}

int row_blocks(int M, int D, int splits) {
  return D > kRegisterD ? splits * wide_tiles(M) * wide_slabs(D) : blocks_for(M, D);
}

bool bad_shape(int N, int M, int D) { return N < 1 || M < 1 || D < 1; }

bool bad_split(int D, int splits) {
  return D > kRegisterD && (splits < 1 || splits > kWideMaxSplit);
}

// Makes `device` current if it is not (a CUDA graph capture may be under way,
// so nothing else is called).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// The wide passes: `splits` CTAs a cluster, each taking ceil(n / splits)
// points of the other cloud.
template <int DP>
int den_wide_launch(const Args& a, float coef, float* pt1, float* L, int splits,
                    cudaStream_t s) {
  const int chunk = (a.M + splits - 1) / splits;
  return cluster_sync::launch_grid_of_clusters(
      estep_den_wide<DP>, dim3(splits, wide_tiles(a.N), 1), splits, kThreads, 0, s, a,
      coef, chunk, pt1, L);
}

template <int DP>
int row_wide_launch(const Args& a, float* p1px, float* Np, int splits, cudaStream_t s) {
  const int chunk = (a.N + splits - 1) / splits;
  return cluster_sync::launch_grid_of_clusters(
      estep_row_wide<DP>, dim3(splits, wide_tiles(a.M), wide_slabs(a.D)), splits, kThreads,
      0, s, a, chunk, p1px, Np);
}

template <int DP, int R>
void den_launch(const Args& a, float coef, float* pt1, float* L, int blocks,
                cudaStream_t s) {
  estep_den_kernel<DP, R><<<blocks, kThreads, 0, s>>>(a, coef, pt1, L);
}

template <int DP, int R>
void row_launch(const Args& a, float* p1px, float* Np, int blocks, cudaStream_t s) {
  estep_row_kernel<DP, R><<<blocks, kThreads, 0, s>>>(a, p1px, Np);
}

}  // namespace

// Plain C entry points, loaded through ctypes.  Every one returns 0 on
// success, -1 for shapes the kernels do not take, or a CUDA error code.
// `den_splits` / `splits` are the wide passes' cluster sizes (1-8, chosen by
// the caller, ops/cpd_estep_kernel.py::plan); D <= 16 ignores them.

// Blocks of the den pass and of the row pass for X [N, D] and TY [M, D],
// into out[2]: the caller sizes the block-sum workspaces from them.
extern "C" int pyfocusr_cpd_estep_plan(int N, int M, int D, int den_splits,
                                       int row_splits, int* out) {
  if (bad_shape(N, M, D) || bad_split(D, den_splits) || bad_split(D, row_splits)) return -1;
  out[0] = den_blocks(N, D, den_splits);
  out[1] = row_blocks(M, D, row_splits);
  return 0;
}

// The den pass: Pt1 and 1/den f32 [N] and L f32 [1] from X, TY, the device
// scalar sigma2 and the outlier coefficient w / (1 - w) * M / N (0 for w =
// 0).  block_sums f32 [blocks] and counter int32 [1] (zero before the first
// launch) are its workspace.
extern "C" int pyfocusr_cpd_estep_den_f32(
    const float* X, const float* TY, int N, int M, int D, const float* sigma2,
    float outlier_coef, const int* done, float* inv_den, float* block_sums,
    int* counter, float* pt1, float* L, int splits, int device, void* stream) {
  if (bad_shape(N, M, D) || bad_split(D, splits)) return -1;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{X, TY, N, M, D, sigma2, done, inv_den, block_sums, counter};
  if (D > kRegisterD) {
    return wide_dp(D) == 32 ? den_wide_launch<32>(a, outlier_coef, pt1, L, splits, s)
                            : den_wide_launch<64>(a, outlier_coef, pt1, L, splits, s);
  }
  const int blocks = blocks_for(N, D);
  const bool wide = rows_per_warp(N, D) > 2;
  switch (padded(D)) {
    case 3: (wide ? den_launch<3, kRows> : den_launch<3, 2>)(a, outlier_coef, pt1, L, blocks, s); break;
    case 6: (wide ? den_launch<6, kRowsD6> : den_launch<6, 2>)(a, outlier_coef, pt1, L, blocks, s); break;
    case 8: (wide ? den_launch<8, kRows> : den_launch<8, 2>)(a, outlier_coef, pt1, L, blocks, s); break;
    default: den_launch<16, 2>(a, outlier_coef, pt1, L, blocks, s);
  }
  return (int)cudaGetLastError();
}

// The row pass: p1px f32 [M * (D + 1)] (P1 [M] then PX [M, D]) and Np f32
// [1], from X, TY and 1/den of the den pass; block_sums f32 [blocks] and
// counter int32 [1] as in the den pass (a workspace of its own).
extern "C" int pyfocusr_cpd_estep_rows_f32(
    const float* X, const float* TY, int N, int M, int D, const float* sigma2,
    const int* done, float* inv_den, float* block_sums, int* counter,
    float* p1px, float* Np, int splits, int device, void* stream) {
  if (bad_shape(N, M, D) || bad_split(D, splits)) return -1;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{X, TY, N, M, D, sigma2, done, inv_den, block_sums, counter};
  if (D > kRegisterD) {
    return wide_dp(D) == 32 ? row_wide_launch<32>(a, p1px, Np, splits, s)
                            : row_wide_launch<64>(a, p1px, Np, splits, s);
  }
  const int blocks = blocks_for(M, D);
  const bool wide = rows_per_warp(M, D) > 2;
  switch (padded(D)) {
    case 3: (wide ? row_launch<3, kRows> : row_launch<3, 2>)(a, p1px, Np, blocks, s); break;
    case 6: (wide ? row_launch<6, kRowsD6> : row_launch<6, 2>)(a, p1px, Np, blocks, s); break;
    case 8: (wide ? row_launch<8, kRows> : row_launch<8, 2>)(a, p1px, Np, blocks, s); break;
    default: row_launch<16, 2>(a, p1px, Np, blocks, s);
  }
  return (int)cudaGetLastError();
}
