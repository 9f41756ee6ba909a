// The 3x3 close of Umeyama's method for Hopper (sm_90a): from the weighted
// cross-covariance of an ICP iteration to its similarity transform.
//
// No TPU kernel stands behind it: the JAX package leaves this step to
// `jnp.linalg.svd` and `det` inside its `lax.while_loop`
// (pyfocusr_tpu/ops/icp.py:31-58).  In PyTorch, `torch.linalg.svd` of a
// CUDA tensor waits for the host, so it cannot be captured in the CUDA graph
// of an ICP iteration; this kernel takes its place on the card.
//
// Contract, that of `umeyama_close_plain` in ops/umeyama_kernel.py: for
// cov f32 [3, 3] (cov = sum_i w_i (dst_i - mu_d)(src_i - mu_s)^T), var_s
// (the weighted variance of src), mu_s, mu_d f32 [3] and with_scale,
//     U S Vt = svd(cov),  d = sign(det U det Vt),
//     R = U diag(1, 1, d) Vt,
//     s = sum(S diag(1, 1, d)) / max(var_s, 1e-30)  (1 without scale),
//     t = mu_d - s R mu_s,
// written as out f32 [13] = (s, R row-major, t).
//
// Why it can match torch.linalg.svd / jnp.linalg.svd up to rounding,
// whatever signs and order an SVD picks: write U = [u1 u2 u3], V = [v1 v2
// v3].  Any SVD has u3 = e_u (u1 x u2), v3 = e_v (v1 x v2) with e = +-1, and
// det U det V = e_u e_v = d, so d u3 v3^T = (u1 x u2)(v1 x v2)^T and
//     R = u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T,
// the same for every sign choice of the pairs (u_i, v_i) and of the third
// columns; likewise sum(S diag(1, 1, d)) = trace(R^T cov).  R depends on
// the top two singular pairs only through u1 v1^T + u2 v2^T, which is also
// unchanged by a rotation inside a repeated singular value.  So whenever
// the singular values are distinct (or the first two repeat), R and s are
// functions of cov alone, and the reflection case (det cov < 0) goes
// through the third term without a sign test.  Only a repeated second and
// third singular value with det cov < 0 leaves R undetermined; then any
// SVD, this one included, picks one of the optimal rotations.
//
// How: one thread, in f64.  Cyclic Jacobi on cov^T cov (kSweeps sweeps of
// the three rotations, each skipped where its off-diagonal entry is zero)
// gives V; the columns are sorted by eigenvalue; B = cov V gives u1 = b1 /
// |b1| and u2 from b2 less its u1 part, so u3 is never formed from a tiny
// third singular value.  The result is rounded to f32 once.  f64 carries
// the 16 digits that squaring cov into cov^T cov costs, so the f32 output
// is the exact transform of the f32 input up to its last bits.  Nothing is
// read back to the host.
//
// What bounds it: one thread's chain of dependent f64 operations (the
// rotations of a sweep depend on each other, and each holds a division, a
// square root, a reciprocal square root and another division); the card
// does ~300 f64 operations in well under a nanosecond of its peak rate, so
// the bound is the chain's latency, not a rate.

#include <cuda_runtime.h>

namespace {

// Jacobi sweeps (three rotations each).  The last is margin: chip_smoke.py
// reports, for each covariance it checks, the fewest sweeps whose rounded
// result already equals this kernel's, and bounds the kernel by that chain.
constexpr int kSweeps = 5;

__device__ __forceinline__ void rotate(double (&S)[3][3], double (&V)[3][3],
                                       int p, int q) {
  const double apq = S[p][q];
  if (apq == 0.0) return;
  const int r = 3 - p - q;
  const double theta = (S[q][q] - S[p][p]) / (2.0 * apq);
  // t = tan of the rotation angle, the root of t^2 + 2 theta t - 1 = 0 of
  // smaller magnitude; for a huge theta, 1 / (2 theta) without theta^2.
  const double t =
      fabs(theta) > 1e150
          ? 0.5 / theta
          : (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = rsqrt(t * t + 1.0);
  const double s = t * c;
  const double srp = S[r][p], srq = S[r][q];
  S[p][p] -= t * apq;
  S[q][q] += t * apq;
  S[p][q] = S[q][p] = 0.0;
  S[r][p] = S[p][r] = c * srp - s * srq;
  S[r][q] = S[q][r] = s * srp + c * srq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double vkp = V[k][p], vkq = V[k][q];
    V[k][p] = c * vkp - s * vkq;
    V[k][q] = s * vkp + c * vkq;
  }
}

__device__ __forceinline__ void swap_cols(double (&lam)[3], double (&V)[3][3],
                                          int a, int b) {
  const double tl = lam[a];
  lam[a] = lam[b];
  lam[b] = tl;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double tv = V[k][a];
    V[k][a] = V[k][b];
    V[k][b] = tv;
  }
}

__device__ __forceinline__ void cross(const double (&a)[3], const double (&b)[3],
                                      double (&out)[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double norm3(const double (&a)[3]) {
  return sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
}

// A unit vector orthogonal to the unit vector a (for a rank-deficient cov,
// whose missing singular directions any SVD chooses freely).
__device__ __forceinline__ void orthogonal_unit(const double (&a)[3],
                                                double (&out)[3]) {
  int m = 0;  // the axis least aligned with a
  if (fabs(a[1]) < fabs(a[m])) m = 1;
  if (fabs(a[2]) < fabs(a[m])) m = 2;
  double e[3] = {0.0, 0.0, 0.0};
  e[m] = 1.0;
  cross(a, e, out);
  const double n = norm3(out);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] /= n;
}

__global__ void umeyama3_kernel(const float* __restrict__ cov,
                                const float* __restrict__ var_s,
                                const float* __restrict__ mu_s,
                                const float* __restrict__ mu_d, int with_scale,
                                float* __restrict__ out) {
  double A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = (double)cov[3 * i + j];
  }
  // S = A^T A, V = I.
  double S[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S[i][j] = A[0][i] * A[0][j] + A[1][i] * A[1][j] + A[2][i] * A[2][j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate(S, V, 0, 1);
    rotate(S, V, 0, 2);
    rotate(S, V, 1, 2);
  }
  double lam[3] = {S[0][0], S[1][1], S[2][2]};
  if (lam[0] < lam[1]) swap_cols(lam, V, 0, 1);
  if (lam[0] < lam[2]) swap_cols(lam, V, 0, 2);
  if (lam[1] < lam[2]) swap_cols(lam, V, 1, 2);

  double v1[3], v2[3], b1[3], b2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v1[k] = V[k][0];
    v2[k] = V[k][1];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b1[i] = A[i][0] * v1[0] + A[i][1] * v1[1] + A[i][2] * v1[2];
    b2[i] = A[i][0] * v2[0] + A[i][1] * v2[1] + A[i][2] * v2[2];
  }
  double u1[3], u2[3];
  const double n1 = norm3(b1);
  if (n1 > 0.0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u1[k] = b1[k] / n1;
  } else {  // cov = 0: R = V V^T = I
#pragma unroll
    for (int k = 0; k < 3; ++k) u1[k] = v1[k];
  }
  const double p = u1[0] * b2[0] + u1[1] * b2[1] + u1[2] * b2[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) b2[k] -= p * u1[k];
  const double n2 = norm3(b2);
  if (n2 > 1e-300 && n2 > 1e-15 * n1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u2[k] = b2[k] / n2;
  } else {  // rank <= 1: the second direction is free
    orthogonal_unit(u1, u2);
  }
  double w[3], z[3];
  cross(u1, u2, w);
  cross(v1, v2, z);

  double R[3][3];
  double trace = 0.0;  // trace(R^T cov) = sum(S diag(1, 1, d))
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i][j] = u1[i] * v1[j] + u2[i] * v2[j] + w[i] * z[j];
      trace += R[i][j] * A[i][j];
    }
  }
  const double s =
      with_scale ? trace / fmax((double)var_s[0], 1e-30) : 1.0;
  out[0] = (float)s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[1 + 3 * i + j] = (float)R[i][j];
    const double rm = R[i][0] * (double)mu_s[0] + R[i][1] * (double)mu_s[1] +
                      R[i][2] * (double)mu_s[2];
    out[10 + i] = (float)((double)mu_d[i] - s * rm);
  }
}

}  // namespace

// Plain C entry point, loaded through ctypes.  cov f32 [9], var_s f32 [1],
// mu_s and mu_d f32 [3] and out f32 [13] are device arrays.  Launches one
// thread on `stream` without synchronising and returns the launch's error
// (0 on success).
extern "C" int pyfocusr_umeyama3_f32(const float* cov, const float* var_s,
                                     const float* mu_s, const float* mu_d,
                                     int with_scale, float* out, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  umeyama3_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      cov, var_s, mu_s, mu_d, with_scale, out);
  return (int)cudaGetLastError();
}
