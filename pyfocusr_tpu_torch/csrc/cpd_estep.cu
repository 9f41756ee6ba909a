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
// features appended) take the chunked instance, `estep_den_chunked` /
// `estep_row_chunked`, which computes the same contract for any D:
//   * a warp owns kChunkRows rows and each lane kChunkPts points of a tile of
//     kChunkTile points of the other cloud, so a lane holds kChunkRows x
//     kChunkPts squared distances in registers and nothing sized by D;
//   * the tile is staged transposed, kChunkDims dimensions at a time, in a
//     padded [dim][point] array, so a lane reads its points without bank
//     conflicts; the warp's own rows are read once a dimension from L1;
//   * the row pass writes the tile's p (times 1/den) to shared memory, then
//     each lane owns one dimension of a chunk and sums p x over the tile;
//     the warp adds the tile's sums into its own rows of PX in device
//     memory (zeroed first, owned by the warp, so no atomics);
//   * exp is the accurate `expf` of exp(d2 * -(1 / 2 s2)), the plain
//     version's formula: the fast ex2 of the instances above reaches 8.6e-6
//     of scale at D = 6 against the 1e-5 gate, and longer sums grow it.
// Per (m, n) pair both passes issue about 5 D + 30 instructions (the
// distance twice, PX once, two expf), so at D = 19 the chunked instance is
// issue-bound.
//
// f32 only, D >= 1.

#include <cuda_runtime.h>

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

// Sum over the blocks of the grid of one value per block, in block order:
// every block writes its value to block_sums; the last block to arrive at
// `counter` adds them (thread t takes blocks t, t + kThreads, ..., then a
// fixed tree) and returns true in thread 0 with the total in *total.  The
// counter is reset to 0 for the next launch.
__device__ bool grid_sum(float block_value, float* block_sums, int* counter,
                         float* total) {
  __shared__ int last;
  __shared__ float red[kThreads];
  if (threadIdx.x == 0) block_sums[blockIdx.x] = block_value;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  float s = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) s += __ldcg(&block_sums[b]);
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

// ------------------------------------------------ D > 16: the chunked instance
constexpr int kRegisterD = 16;     // widest D of the register-resident instances
constexpr int kChunkRows = 4;   // rows a warp owns
constexpr int kChunkPts = 4;    // points of the other cloud a lane takes a tile
constexpr int kChunkTile = 32 * kChunkPts;
constexpr int kChunkDims = 32;             // dimensions staged at once
constexpr int kChunkPitch = kChunkTile + 1;  // padded: conflict-free columns

// Stages dimensions [c0, c0 + dc) of points [base, base + cols) of P [n, D]
// transposed into s[dim][point], zero past `cols`.  Consecutive threads take
// consecutive dimensions of a point: coalesced reads, and a pitch of
// kChunkTile + 1 spreads the writes over the banks.
__device__ void stage_chunk(float (*s)[kChunkPitch], const float* __restrict__ P,
                           int D, int base, int cols, int c0, int dc) {
  for (int e = threadIdx.x; e < kChunkTile * dc; e += kThreads) {
    const int j = e / dc;
    const int dd = e - j * dc;
    s[dd][j] = j < cols ? P[(size_t)(base + j) * D + c0 + dd] : 0.0f;
  }
}

// Squared distances of the warp's kChunkRows rows of `own` [*, D] (rows
// clamped into range by the caller) to the lane's kChunkPts points of the
// tile of `other`, fmaf in dimension order, the tile staged chunk by chunk
// into `s` by the whole block.
__device__ void chunk_d2(float (&d2)[kChunkPts][kChunkRows], const float* __restrict__ own,
                        const int (&rows)[kChunkRows], const float* __restrict__ other,
                        int D, int base, int cols, float (*s)[kChunkPitch], int lane) {
#pragma unroll
  for (int i = 0; i < kChunkPts; ++i) {
#pragma unroll
    for (int j = 0; j < kChunkRows; ++j) d2[i][j] = 0.0f;
  }
  for (int c0 = 0; c0 < D; c0 += kChunkDims) {
    const int dc = min(kChunkDims, D - c0);
    __syncthreads();  // the previous chunk has been read
    stage_chunk(s, other, D, base, cols, c0, dc);
    __syncthreads();
    for (int dd = 0; dd < dc; ++dd) {
      float xr[kChunkRows];
#pragma unroll
      for (int j = 0; j < kChunkRows; ++j) xr[j] = __ldg(&own[(size_t)rows[j] * D + c0 + dd]);
#pragma unroll
      for (int i = 0; i < kChunkPts; ++i) {
        const float t = s[dd][lane + 32 * i];
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j) {
          const float diff = xr[j] - t;
          d2[i][j] = fmaf(diff, diff, d2[i][j]);
        }
      }
    }
  }
}

// The den pass for D > 16: a warp owns kChunkRows rows of X and reduces over
// all of TY.
__global__ void __launch_bounds__(kThreads)
    estep_den_chunked(Args a, float outlier_coef, float* __restrict__ pt1,
                   float* __restrict__ L) {
  if (a.done != nullptr && *a.done) return;
  __shared__ float sty[kChunkDims][kChunkPitch];
  const int lane = threadIdx.x & 31;
  const float s2 = *a.sigma2;
  const float neg = -(1.0f / (2.0f * s2));
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kChunkRows;
  int rows[kChunkRows];
  float acc[kChunkRows];
#pragma unroll
  for (int j = 0; j < kChunkRows; ++j) {
    rows[j] = min(row0 + j, a.N - 1);
    acc[j] = 0.0f;
  }
  for (int base = 0; base < a.M; base += kChunkTile) {
    const int cols = min(kChunkTile, a.M - base);
    float d2[kChunkPts][kChunkRows];
    chunk_d2(d2, a.X, rows, a.TY, a.D, base, cols, sty, lane);
#pragma unroll
    for (int i = 0; i < kChunkPts; ++i) {
      if (lane + 32 * i < cols) {
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j) acc[j] += expf(d2[i][j] * neg);
      }
    }
  }
  const float c = outlier_coef > 0.0f
                      ? powf(2.0f * 3.14159265358979f * s2, 0.5f * a.D) * outlier_coef
                      : 0.0f;
  float log_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kChunkRows; ++j) {
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

// The row pass for D > 16: a warp owns kChunkRows rows of TY and reduces
// over all of X; p1px is P1 [M] then PX [M, D].
__global__ void __launch_bounds__(kThreads)
    estep_row_chunked(Args a, float* __restrict__ p1px, float* __restrict__ Np) {
  if (a.done != nullptr && *a.done) return;
  __shared__ float sx[kChunkDims][kChunkPitch];
  __shared__ __align__(16) float sp[kWarps][kChunkRows][kChunkTile];
  __shared__ float sinv[kChunkTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float neg = -(1.0f / (2.0f * *a.sigma2));
  const int row0 = (blockIdx.x * kWarps + warp) * kChunkRows;
  float* px = p1px + a.M;
  int rows[kChunkRows];
  float p1[kChunkRows];
#pragma unroll
  for (int j = 0; j < kChunkRows; ++j) {
    rows[j] = min(row0 + j, a.M - 1);
    p1[j] = 0.0f;
    if (row0 + j < a.M) {
      // Lane l owns dimensions l, l + 32, ...: the same lane adds to them
      // below, so no barrier orders the zeroing.
      for (int d = lane; d < a.D; d += 32) px[(size_t)(row0 + j) * a.D + d] = 0.0f;
    }
  }
  for (int base = 0; base < a.N; base += kChunkTile) {
    const int cols = min(kChunkTile, a.N - base);
    __syncthreads();  // the previous tile's 1/den and p have been read
    for (int e = threadIdx.x; e < kChunkTile; e += kThreads) {
      sinv[e] = e < cols ? a.inv_den[base + e] : 0.0f;
    }
    float d2[kChunkPts][kChunkRows];
    chunk_d2(d2, a.TY, rows, a.X, a.D, base, cols, sx, lane);  // its barriers publish sinv
#pragma unroll
    for (int i = 0; i < kChunkPts; ++i) {
      const int jj = lane + 32 * i;
      const float inv = sinv[jj];  // 0 past the tile: p = 0 there
#pragma unroll
      for (int j = 0; j < kChunkRows; ++j) {
        const float p = expf(d2[i][j] * neg) * inv;
        p1[j] += p;
        sp[warp][j][jj] = p;
      }
    }
    __syncwarp();
    for (int c0 = 0; c0 < a.D; c0 += kChunkDims) {
      const int dc = min(kChunkDims, a.D - c0);
      __syncthreads();
      stage_chunk(sx, a.X, a.D, base, cols, c0, dc);
      __syncthreads();
      if (lane < dc) {
        float acc[kChunkRows];
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j) acc[j] = 0.0f;
        for (int jj = 0; jj < cols; jj += 4) {  // zero p and x past the tile
          const float x0 = sx[lane][jj], x1 = sx[lane][jj + 1];
          const float x2 = sx[lane][jj + 2], x3 = sx[lane][jj + 3];
#pragma unroll
          for (int j = 0; j < kChunkRows; ++j) {
            const float4 p4 = *reinterpret_cast<const float4*>(&sp[warp][j][jj]);
            acc[j] = fmaf(p4.x, x0, acc[j]);
            acc[j] = fmaf(p4.y, x1, acc[j]);
            acc[j] = fmaf(p4.z, x2, acc[j]);
            acc[j] = fmaf(p4.w, x3, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j) {
          if (row0 + j < a.M) px[(size_t)(row0 + j) * a.D + c0 + lane] += acc[j];
        }
      }
    }
  }
  float p1_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kChunkRows; ++j) {
    const float s = warp_sum(p1[j]);
    const int m = row0 + j;
    if (m < a.M) {
      if (lane == j) p1px[m] = s;
      p1_sum += s;
    }
  }
  float total;
  if (grid_sum(block_sum_of_warps(p1_sum), a.block_sums, a.counter, &total)) {
    *Np = total;
  }
}

int padded(int D) { return D <= 3 ? 3 : D <= 6 ? 6 : D <= 8 ? 8 : 16; }

// Rows a warp owns for `rows` output rows at width D.
int rows_per_warp(int rows, int D) {
  if (D > kRegisterD) return kChunkRows;
  if (rows < kWideMin || padded(D) > 8) return 2;
  return padded(D) == 6 ? kRowsD6 : kRows;
}

int blocks_for(int rows, int D) {
  const int per_block = kWarps * rows_per_warp(rows, D);
  return (rows + per_block - 1) / per_block;
}

bool bad_shape(int N, int M, int D) { return N < 1 || M < 1 || D < 1; }

// Makes `device` current if it is not (a CUDA graph capture may be under way,
// so nothing else is called).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
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

// Blocks of the den pass and of the row pass for X [N, D] and TY [M, D],
// into out[2]: the caller sizes the block-sum workspaces from them.
extern "C" int pyfocusr_cpd_estep_plan(int N, int M, int D, int* out) {
  if (bad_shape(N, M, D)) return -1;
  out[0] = blocks_for(N, D);
  out[1] = blocks_for(M, D);
  return 0;
}

// The den pass: Pt1 and 1/den f32 [N] and L f32 [1] from X, TY, the device
// scalar sigma2 and the outlier coefficient w / (1 - w) * M / N (0 for w =
// 0).  block_sums f32 [blocks] and counter int32 [1] (zero before the first
// launch) are its workspace.
extern "C" int pyfocusr_cpd_estep_den_f32(
    const float* X, const float* TY, int N, int M, int D, const float* sigma2,
    float outlier_coef, const int* done, float* inv_den, float* block_sums,
    int* counter, float* pt1, float* L, int device, void* stream) {
  if (bad_shape(N, M, D)) return -1;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{X, TY, N, M, D, sigma2, done, inv_den, block_sums, counter};
  const int blocks = blocks_for(N, D);
  if (D > kRegisterD) {
    estep_den_chunked<<<blocks, kThreads, 0, s>>>(a, outlier_coef, pt1, L);
    return (int)cudaGetLastError();
  }
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
    float* p1px, float* Np, int device, void* stream) {
  if (bad_shape(N, M, D)) return -1;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{X, TY, N, M, D, sigma2, done, inv_den, block_sums, counter};
  const int blocks = blocks_for(M, D);
  if (D > kRegisterD) {
    estep_row_chunked<<<blocks, kThreads, 0, s>>>(a, p1px, Np);
    return (int)cudaGetLastError();
  }
  const bool wide = rows_per_warp(M, D) > 2;
  switch (padded(D)) {
    case 3: (wide ? row_launch<3, kRows> : row_launch<3, 2>)(a, p1px, Np, blocks, s); break;
    case 6: (wide ? row_launch<6, kRowsD6> : row_launch<6, 2>)(a, p1px, Np, blocks, s); break;
    case 8: (wide ? row_launch<8, kRows> : row_launch<8, 2>)(a, p1px, Np, blocks, s); break;
    default: row_launch<16, 2>(a, p1px, Np, blocks, s);
  }
  return (int)cudaGetLastError();
}
