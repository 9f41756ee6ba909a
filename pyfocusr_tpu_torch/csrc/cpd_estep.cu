// Streamed CPD E-step for Hopper (sm_90a): the Gaussian responsibilities of
// Coherent Point Drift, reduced without ever forming the [M, N] matrix.
//
// Replaces the TPU kernels `_estep_den_kernel` and `_estep_row_kernel`
// behind `cpd_estep_pallas` (pyfocusr_tpu/ops/pallas_kernels.py:105,131,159)
// with the same two passes:
//
//   den pass:  den_n = max(sum_m exp(-|x_n - ty_m|^2 / 2 s2) + c, 1e-30)
//              (raw exp, no max-rescaling: cycpd's semantics)
//   row pass:  p_mn = exp(-|x_n - ty_m|^2 / 2 s2) / den_n
//              P1_m = sum_n p_mn,   PX_m = sum_n p_mn x_n
//
// Pt1, Np and the log-likelihood L are O(N) reductions of den and P1 left to
// the caller (ops/cpd_estep_kernel.py).
//
// Squared distances are direct differences sum_d (x_d - ty_d)^2, not the
// |x|^2 + |ty|^2 - 2 x.ty identity the TPU kernels take from the MXU: on CUDA
// cores both cost the same, and the differences do not cancel when sigma2 is
// small late in EM.  The exponential is `expf` (full accuracy, ~2 ulp).
//
// What bounds it on the H100: each (m, n) element costs one exp and ~3D + 2
// (den pass) or ~5D + 3 (row pass) f32 operations; the inputs are a few
// hundred KB (10242 x 3 floats is 123 KB) and stay in L2.  So the bound is
// the rate of the special-function units (16 exp per SM per clock) or the
// f32 rate, not bytes: ~25-30 us per pass at 10242^2.
//
// What the design does about it:
//   * A thread owns one output row (x_n in the den pass, ty_m in the row
//     pass) and keeps its coordinates and sums in registers; D is a template
//     parameter (padded to 3, 6, 8 or 16 with zeros) so the loops unroll.
//   * The other cloud is staged through shared memory in tiles of kTile
//     rows; every thread of the block reads the same word (a broadcast).
//   * The TPU carries den, P1 and PX across a sequential grid in VMEM; here
//     blocks run in no order, so each reduction is a loop inside the block.
//     One thread per row would give only 41 blocks of 256 at n = 10242 (20
//     at 5000) for 132 SMs, so the reduced axis is split into `chunks`
//     (blockIdx.y) that write partial sums to a workspace, and a second small
//     kernel adds the chunks in order.  No float atomics: the sums repeat
//     bit for bit from run to run.
//   * The ragged edges are masked by index; the TPU version's +-1e15
//     padding has no counterpart.
//
// f32 only, 1 <= D <= 16.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // rows of the reduced cloud per shared-memory tile

// params[0] = 1 / (2 sigma2), params[1] = c (outlier term), on the device so
// that the caller never reads sigma2 back to the host.

// Partial den over one chunk of TY rows (blockIdx.y); part is [chunks, N].
template <int DP>
__global__ void __launch_bounds__(kThreads)
    estep_den_partial_kernel(const float* __restrict__ X,
                             const float* __restrict__ TY, int N, int M, int D,
                             int rows_per_chunk,
                             const float* __restrict__ params,
                             float* __restrict__ part) {
  __shared__ float sty[kTile][DP];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool active = n < N;
  float x[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    x[d] = (active && d < D) ? X[(size_t)n * D + d] : 0.0f;
  }
  const float neg_inv2s2 = -params[0];
  const int m0 = blockIdx.y * rows_per_chunk;
  const int m1 = min(M, m0 + rows_per_chunk);
  float acc = 0.0f;
  for (int base = m0; base < m1; base += kTile) {
    const int rows = min(kTile, m1 - base);
    __syncthreads();  // the previous tile has been read
    for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
      const int r = e / DP;
      const int d = e % DP;
      sty[r][d] = (r < rows && d < D) ? TY[(size_t)(base + r) * D + d] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float d2 = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        const float diff = x[d] - sty[r][d];
        d2 = fmaf(diff, diff, d2);
      }
      acc += expf(d2 * neg_inv2s2);
    }
  }
  if (active) part[(size_t)blockIdx.y * N + n] = acc;
}

// den and 1/den from the chunks' partial sums, added in chunk order.
__global__ void __launch_bounds__(kThreads)
    estep_den_finish_kernel(const float* __restrict__ part, int N, int chunks,
                            const float* __restrict__ params,
                            float* __restrict__ den,
                            float* __restrict__ inv_den) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float s = part[n];
  for (int k = 1; k < chunks; ++k) s += part[(size_t)k * N + n];
  const float v = fmaxf(s + params[1], 1e-30f);
  den[n] = v;
  inv_den[n] = 1.0f / v;
}

// Partial P1 and PX over one chunk of X columns (blockIdx.y).  part is
// [chunks, M * (D + 1)]: per chunk, P1 [M] then PX [M, D] row-major.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    estep_row_partial_kernel(const float* __restrict__ X,
                             const float* __restrict__ TY,
                             const float* __restrict__ inv_den, int N, int M,
                             int D, int cols_per_chunk,
                             const float* __restrict__ params,
                             float* __restrict__ part) {
  __shared__ float sx[kTile][DP + 1];  // x_n, then 1 / den_n
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool active = m < M;
  float ty[DP];
  float px[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    ty[d] = (active && d < D) ? TY[(size_t)m * D + d] : 0.0f;
    px[d] = 0.0f;
  }
  float p1 = 0.0f;
  const float neg_inv2s2 = -params[0];
  const int n0 = blockIdx.y * cols_per_chunk;
  const int n1 = min(N, n0 + cols_per_chunk);
  for (int base = n0; base < n1; base += kTile) {
    const int cols = min(kTile, n1 - base);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * (DP + 1); e += kThreads) {
      const int r = e / (DP + 1);
      const int d = e % (DP + 1);
      float v = 0.0f;
      if (r < cols) {
        if (d == DP) {
          v = inv_den[base + r];
        } else if (d < D) {
          v = X[(size_t)(base + r) * D + d];
        }
      }
      sx[r][d] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < cols; ++r) {
      float d2 = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        const float diff = sx[r][d] - ty[d];
        d2 = fmaf(diff, diff, d2);
      }
      const float p = expf(d2 * neg_inv2s2) * sx[r][DP];
      p1 += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) px[d] = fmaf(p, sx[r][d], px[d]);
    }
  }
  if (!active) return;
  float* out = part + (size_t)blockIdx.y * M * (D + 1);
  out[m] = p1;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    if (d < D) out[M + (size_t)m * D + d] = px[d];
  }
}

// out[e] = sum over chunks k (in order) of part[k * len + e].
__global__ void __launch_bounds__(kThreads)
    estep_sum_chunks_kernel(const float* __restrict__ part, long long len,
                            int chunks, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= len) return;
  float s = part[e];
  for (int k = 1; k < chunks; ++k) s += part[(size_t)k * len + e];
  out[e] = s;
}

template <int DP>
cudaError_t launch_den(const float* X, const float* TY, int N, int M, int D,
                       int chunks, const float* params, float* part,
                       cudaStream_t s) {
  const int per_chunk = (M + chunks - 1) / chunks;
  const dim3 grid((N + kThreads - 1) / kThreads, chunks);
  estep_den_partial_kernel<DP><<<grid, kThreads, 0, s>>>(
      X, TY, N, M, D, per_chunk, params, part);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_rows(const float* X, const float* TY, const float* inv_den,
                        int N, int M, int D, int chunks, const float* params,
                        float* part, cudaStream_t s) {
  const int per_chunk = (N + chunks - 1) / chunks;
  const dim3 grid((M + kThreads - 1) / kThreads, chunks);
  estep_row_partial_kernel<DP><<<grid, kThreads, 0, s>>>(
      X, TY, inv_den, N, M, D, per_chunk, params, part);
  return cudaGetLastError();
}

bool bad_shape(int N, int M, int D, int chunks) {
  return N < 1 || M < 1 || D < 1 || D > 16 || chunks < 1 || chunks > 65535;
}

}  // namespace

// Plain C entry points, loaded through ctypes.  X f32 [N, D] and TY f32
// [M, D] are contiguous device arrays; params f32 [2] = (1 / (2 sigma2), c)
// lies on the device; outputs and workspaces are allocated by the caller.
// Both launch on `stream` without synchronising and return
// cudaGetLastError() (0 on success, -1 for shapes the kernels do not take).

// den f32 [N] and inv_den f32 [N]; part f32 [chunks, N] workspace, the TY
// rows split into `chunks`.
extern "C" int pyfocusr_cpd_estep_den_f32(const float* X, const float* TY,
                                          int N, int M, int D,
                                          const float* params, int chunks,
                                          float* part, float* den,
                                          float* inv_den, int device,
                                          void* stream) {
  if (bad_shape(N, M, D, chunks)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 3) {
    err = launch_den<3>(X, TY, N, M, D, chunks, params, part, s);
  } else if (D <= 6) {
    err = launch_den<6>(X, TY, N, M, D, chunks, params, part, s);
  } else if (D <= 8) {
    err = launch_den<8>(X, TY, N, M, D, chunks, params, part, s);
  } else {
    err = launch_den<16>(X, TY, N, M, D, chunks, params, part, s);
  }
  if (err != cudaSuccess) return (int)err;
  estep_den_finish_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, N, chunks, params, den, inv_den);
  return (int)cudaGetLastError();
}

// p1px f32 [M * (D + 1)]: P1 [M] then PX [M, D]; part f32 [chunks, M * (D +
// 1)] workspace, the X rows split into `chunks`; inv_den from the den pass.
extern "C" int pyfocusr_cpd_estep_rows_f32(const float* X, const float* TY,
                                           const float* inv_den, int N, int M,
                                           int D, const float* params,
                                           int chunks, float* part,
                                           float* p1px, int device,
                                           void* stream) {
  if (bad_shape(N, M, D, chunks)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 3) {
    err = launch_rows<3>(X, TY, inv_den, N, M, D, chunks, params, part, s);
  } else if (D <= 6) {
    err = launch_rows<6>(X, TY, inv_den, N, M, D, chunks, params, part, s);
  } else if (D <= 8) {
    err = launch_rows<8>(X, TY, inv_den, N, M, D, chunks, params, part, s);
  } else {
    err = launch_rows<16>(X, TY, inv_den, N, M, D, chunks, params, part, s);
  }
  if (err != cudaSuccess) return (int)err;
  const long long len = (long long)M * (D + 1);
  const long long blocks = (len + kThreads - 1) / kThreads;
  estep_sum_chunks_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(part, len,
                                                                chunks, p1px);
  return (int)cudaGetLastError();
}
