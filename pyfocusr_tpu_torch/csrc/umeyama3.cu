// The 3x3 close of Umeyama's method for Hopper (sm_90a), and ICP's update
// kernel around it: from the nearest neighbours of an ICP iteration to its
// similarity transform, the moved source and the loop's stop flag, in one
// launch.
//
// No TPU kernel stands behind it: the JAX package leaves this step to
// `jnp.linalg.svd` and `det` inside its `lax.while_loop`
// (pyfocusr_tpu/ops/icp.py:31-58, the loop body :110-129).  In PyTorch,
// `torch.linalg.svd` of a CUDA tensor waits for the host, so it cannot be
// captured in the CUDA graph of an ICP iteration; these kernels take its
// place on the card.
//
// The close, `close3` (shared by both kernels).  Contract, that of
// `umeyama_close_plain` in ops/umeyama_kernel.py: for the weighted
// cross-covariance cov = sum_i w_i (dst_i - mu_d)(src_i - mu_s)^T, the
// weighted variance var_s of src, the means mu_s, mu_d and with_scale,
//     U S Vt = svd(cov),  d = sign(det U det Vt),
//     R = U diag(1, 1, d) Vt,
//     s = sum(S diag(1, 1, d)) / max(var_s, 1e-30)  (1 without scale),
//     t = mu_d - s R mu_s,
// computed in f64 and rounded once to f32 as (s, R row-major, t).
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
// How: one thread, in f64.  Cyclic Jacobi on cov^T cov gives V.  A
// rotation is skipped where its off-diagonal entry is negligible against
// the diagonal at f64 rounding (|apq| <= 2^-53 sqrt(app aqq)), and the
// sweeps stop after a sweep that rotated nothing (at most kSweeps).  A
// rotation takes no division: with d = aqq - app, h = 2 apq and
// r = hypot(d, h), tan = sgn(d) h / (|d| + r), so
//     g = rsqrt((|d| + r)^2 + h^2),  c = (|d| + r) g,  s = sgn(d) h g,
//     tan apq = sgn(d) (r - |d|) / 2   (h^2 = (r - |d|)(r + |d|)),
// the same rotation as the textbook's theta = d / h form up to f64
// rounding.  The columns are sorted by eigenvalue; B = cov V gives u1 =
// b1 / |b1| and u2 from b2 less its u1 part (each by a reciprocal square
// root), so u3 is never formed from a tiny third singular value.  f64
// carries the 16 digits that squaring cov into cov^T cov costs, so the f32
// output is the exact transform of its input up to its last bits.
//
// `umeyama3_kernel`: the close alone, one thread, on f32 moments (for
// `ops/icp.umeyama`, the cohort's Procrustes and `vtk_functions`).
//
// `icp_step_kernel`: one ICP iteration after the k-NN, the update of
// `icp_step_plain` in ops/umeyama_kernel.py.  If the loop's done flag
// ctrl[1] is set it returns at once and writes nothing.  Otherwise, with
// matched_i = target[idx_i] and sc_i = src_i - mu_s:
//   1. f64 sums over the rows of wn_i matched_i, wn_i matched_i sc_i^T and
//      wn_i sc_i, so mu_d = sum wn_i matched_i and
//      cov = sum wn_i matched_i sc_i^T - mu_d (sum wn_i sc_i)^T
//      (= sum wn_i (matched_i - mu_d) sc_i^T: one pass, no second sweep
//      over the rows after mu_d);
//   2. the close on those f64 moments, rounded once;
//   3. new_i = f32(s R src_i + t) computed in f64 from the rounded s, R, t;
//      delta = f32(sum_i wn_i (mask_i > 0 ? |new_i - moved_i| : 0)) in f64,
//      so a masked row adds exactly 0 even where its step is inf or NaN;
//   4. writes s, R, t, moved, delta; ctrl[0] += 1; ctrl[1] = !(delta >
//      threshold) || ctrl[0] >= max_iterations (a NaN stops the loop).
// One cluster of `ctas` CTAs (1 to kMaxCtas, ops/umeyama_kernel.plan) that
// reduce through distributed shared memory: each CTA stores its sums in its
// own shared memory, one cluster barrier, and every CTA reads them all in
// rank order and runs the close itself (the same bits in each); each CTA
// then stores its motion into CTA 0's shared memory, and after a second
// cluster barrier CTA 0 adds them and writes the scalars.  Sums are
// in a fixed order (rows strided by thread, xor-shuffle trees, warps and
// ranks in order): the results repeat bit for bit.
//
// What bounds them: the close is one thread's chain of dependent f64
// operations (per rotation a square root, a reciprocal square root and
// seven FMA-class steps on its longest path); the card does its ~300 f64 operations in
// well under a nanosecond of its peak rate, so the bound is the chain's
// latency, not a rate.  The step adds ~60 bytes a row (a few hundred KB,
// in L2), and its time is latency too: the launch, two dependent memory
// round trips (the index, then the matched row), the rows' f64 arithmetic
// (~2 SM clocks a row, its f32-to-f64 conversions running at a quarter of
// the FMA rate: the reason a cluster takes more than 512 rows), the
// block reductions and the close's chain.  What the design does about it:
// every load whose address is known is issued at the start, in flight with
// the flag's; a thread's first kRows rows stay in registers from the
// moments to the update; the scalars pass through shared memory so that
// their loads complete there; the 15 sums are reduced by halves (16
// shuffles a warp, not 75); before this kernel an ICP iteration spent ~40
// small torch launches on the same work.

#include <cuda_runtime.h>

#include "cluster_sync.cuh"

namespace {

// The cap on Jacobi sweeps (three rotations each); they stop earlier once
// a sweep rotates nothing.  chip_smoke.py reads it and reports, for each
// covariance it checks, the rotations that ran.
constexpr int kSweeps = 5;

// (2^-53)^2: apq is negligible where apq^2 <= kNegligible2 |app aqq|.
constexpr double kNegligible2 = 1.232595164407831e-32;

// The update kernel's CTA, the rows a thread holds in registers at once
// (its first kRows rows, loaded at the start and kept through the close;
// the planner gives a thread one row up to kMaxCtas * kThreads rows,
// ops/umeyama_kernel.plan) and its largest cluster.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;
constexpr int kMaxCtas = 16;
// The f64 sums of the moments: wn m (3), wn m sc^T (9), wn sc (3); a
// sixteenth, zero, pads the warp's reduction.
constexpr int kSums = 15;

__device__ __forceinline__ bool rotate(double (&S)[3][3], double (&V)[3][3],
                                       int p, int q) {
  const double apq = S[p][q];
  if (apq == 0.0 || apq * apq <= kNegligible2 * fabs(S[p][p] * S[q][q])) {
    return false;
  }
  const int r = 3 - p - q;
  const double d = S[q][q] - S[p][p];
  const double h = 2.0 * apq;
  const double hh = h * h;
  const double root = sqrt(fma(d, d, hh));
  const double ad = fabs(d);
  const double den = ad + root;
  const double g = rsqrt(fma(den, den, hh));
  const double sg = d >= 0.0 ? 1.0 : -1.0;
  const double c = den * g;
  const double s = sg * h * g;
  const double tapq = sg * 0.5 * (root - ad);
  const double srp = S[r][p], srq = S[r][q];
  S[p][p] -= tapq;
  S[q][q] += tapq;
  S[p][q] = S[q][p] = 0.0;
  S[r][p] = S[p][r] = c * srp - s * srq;
  S[r][q] = S[q][r] = s * srp + c * srq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double vkp = V[k][p], vkq = V[k][q];
    V[k][p] = c * vkp - s * vkq;
    V[k][q] = s * vkp + c * vkq;
  }
  return true;
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

__device__ __forceinline__ double dot3(const double (&a)[3], const double (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// A unit vector orthogonal to the unit vector a (for a rank-deficient cov,
// whose missing singular directions any SVD chooses freely): a x e for the
// axis e least aligned with a (the first of equals), by selects, so that no
// array is indexed at run time (which would put it in local memory).
__device__ __forceinline__ void orthogonal_unit(const double (&a)[3],
                                                double (&out)[3]) {
  const double a0 = fabs(a[0]), a1 = fabs(a[1]), a2 = fabs(a[2]);
  const bool m1 = a1 < a0;
  const bool m2 = a2 < (m1 ? a1 : a0);
  const double e[3] = {(!m1 && !m2) ? 1.0 : 0.0, (m1 && !m2) ? 1.0 : 0.0,
                       m2 ? 1.0 : 0.0};
  cross(a, e, out);
  const double g = rsqrt(dot3(out, out));
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] *= g;
}

// The close in one thread: out = f32 (s, R row-major, t).
__device__ __forceinline__ void close3(const double (&A)[3][3], double var_s,
                       const double (&mu_s)[3], const double (&mu_d)[3],
                       int with_scale, float* out) {
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
    const bool a = rotate(S, V, 0, 1);
    const bool b = rotate(S, V, 0, 2);
    const bool c = rotate(S, V, 1, 2);
    if (!(a || b || c)) break;
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
  const double n1sq = dot3(b1, b1);
  if (n1sq > 0.0) {
    const double g1 = rsqrt(n1sq);
#pragma unroll
    for (int k = 0; k < 3; ++k) u1[k] = b1[k] * g1;
  } else {  // cov = 0: R = V V^T = I
#pragma unroll
    for (int k = 0; k < 3; ++k) u1[k] = v1[k];
  }
  const double p = dot3(u1, b2);
#pragma unroll
  for (int k = 0; k < 3; ++k) b2[k] -= p * u1[k];
  const double n2sq = dot3(b2, b2);
  if (n2sq > 0.0 && n2sq > 1e-30 * n1sq) {
    const double g2 = rsqrt(n2sq);
#pragma unroll
    for (int k = 0; k < 3; ++k) u2[k] = b2[k] * g2;
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
  const double s = with_scale ? trace / fmax(var_s, 1e-30) : 1.0;
  out[0] = (float)s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[1 + 3 * i + j] = (float)R[i][j];
    const double rm = R[i][0] * mu_s[0] + R[i][1] * mu_s[1] + R[i][2] * mu_s[2];
    out[10 + i] = (float)(mu_d[i] - s * rm);
  }
}

__global__ void umeyama3_kernel(const float* __restrict__ cov,
                                const float* __restrict__ var_s,
                                const float* __restrict__ mu_s,
                                const float* __restrict__ mu_d, int with_scale,
                                float* __restrict__ out) {
  double A[3][3], ms[3], md[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = (double)cov[3 * i + j];
    ms[i] = (double)mu_s[i];
    md[i] = (double)mu_d[i];
  }
  close3(A, (double)var_s[0], ms, md, with_scale, out);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The warp's sums of 16 values a lane, as a reduce-scatter by halves: at
// each step a lane keeps half of its values and adds its partner's copies
// of them (8 + 4 + 2 + 1 shuffles, then one for the last pair), so lane l
// returns the sum over the warp of value l / 2 (16 shuffles, not 80).
template <int H>
__device__ __forceinline__ void halve(double (&v)[16], int lane) {
  const bool upper = (lane & (2 * H)) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const double send = upper ? v[k] : v[k + H];
    const double keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

__device__ __forceinline__ double warp_sum16(double (&v)[16], int lane) {
  halve<8>(v, lane);  // partner: lane ^ 16
  halve<4>(v, lane);  // lane ^ 8
  halve<2>(v, lane);  // lane ^ 4
  halve<1>(v, lane);  // lane ^ 2
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// The moments' sums of one row: matched row m, source row x, weight w.
__device__ __forceinline__ void add_moments(double (&acc)[16], const float (&m)[3],
                                            const float (&x)[3], float w,
                                            const double (&ms)[3]) {
  const double wd = (double)w;
  const double sc[3] = {(double)x[0] - ms[0], (double)x[1] - ms[1],
                        (double)x[2] - ms[2]};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double wm = wd * (double)m[a];
    acc[a] += wm;
#pragma unroll
    for (int b = 0; b < 3; ++b) acc[3 + 3 * a + b] = fma(wm, sc[b], acc[3 + 3 * a + b]);
    acc[12 + a] = fma(wd, sc[a], acc[12 + a]);
  }
}

// The update of one row: its moved row s R x + t in f64, rounded once and
// stored over `old`; returns the row's term of the mean motion (exactly 0
// where the mask drops the row).
__device__ __forceinline__ double update_row(double s, const double (&R)[3][3],
                                             const double (&t)[3], const float (&x)[3],
                                             const float (&old)[3], float mk, float w,
                                             float* __restrict__ row) {
  double step2 = 0.0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double rx =
        fma(R[a][2], (double)x[2], fma(R[a][1], (double)x[1], R[a][0] * (double)x[0]));
    const float nm = (float)fma(s, rx, t[a]);
    const double dx = (double)nm - (double)old[a];
    step2 = fma(dx, dx, step2);
    row[a] = nm;
  }
  return mk > 0.0f ? sqrt(step2) * (double)w : 0.0;
}

__global__ void __launch_bounds__(kThreads) icp_step_kernel(
    const float* __restrict__ target, const int* __restrict__ idx,
    const float* __restrict__ src, const float* __restrict__ mask,
    const float* __restrict__ wn, const float* __restrict__ mu_s,
    const float* __restrict__ var_s, const float* __restrict__ threshold, int n,
    int max_iterations, int with_scale, float* __restrict__ s_out,
    float* __restrict__ R_out, float* __restrict__ t_out,
    float* __restrict__ moved, float* __restrict__ delta_out,
    int* __restrict__ ctrl) {
  __shared__ double sums[kSums];  // this CTA's sums
  __shared__ double warp_sums[kWarps][kSums];
  __shared__ double motions[kMaxCtas];  // CTA 0's: slot r, CTA r's motion
  __shared__ double warp_motions[kWarps];
  __shared__ double totals[kSums];  // the cluster's sums
  __shared__ float result[13];  // the close: s, R, t
  __shared__ float scalars[2];  // var_s, threshold

  const int rank = blockIdx.x;
  const int ctas = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = ctas * kThreads;
  const int first = rank * kThreads + threadIdx.x;
  // Every load whose address is known goes out at once, before the flag is
  // known: the scalars and the thread's first kRows rows (rows first,
  // first + stride, ...), whose moved row and mask stay in registers until
  // the update.  Every CTA reads the same flag, which only CTA 0 writes
  // after the last cluster barrier, so a cluster returns whole, before any
  // barrier.
  const int count = ctrl[0];
  const int done = ctrl[1];
  const float ms_f[3] = {mu_s[0], mu_s[1], mu_s[2]};
  const float var = var_s[0];
  const float thr = threshold[0];
  int j[kRows];
  float x[kRows][3], w[kRows], old[kRows][3], mk[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = first + u * stride;
    const bool row = i < n;
    j[u] = row ? idx[i] : -1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[u][a] = row ? src[3 * (size_t)i + a] : 0.0f;
      old[u][a] = row ? moved[3 * (size_t)i + a] : 0.0f;
    }
    w[u] = row ? wn[i] : 0.0f;
    mk[u] = row ? mask[i] : 0.0f;
  }
  if (done != 0) return;
  // Through shared memory, so that their loads complete here, in flight
  // with the rows', and not where the close and the flag first use them.
  if (threadIdx.x == 0) {
    scalars[0] = var;
    scalars[1] = thr;
  }
  const double ms[3] = {(double)ms_f[0], (double)ms_f[1], (double)ms_f[2]};

  // 1. The moments' sums: the first batch from its registers, the later
  // ones (more than kRows rows a thread) loaded here, a batch's loads before
  // its arithmetic.
  double acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0;
  for (int base = first; base < n; base += kRows * stride) {
    const bool held = base == first;
    int jb[kRows];
    float xb[kRows][3], wb[kRows], m[kRows][3];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = base + u * stride;
      const bool row = i < n;
      jb[u] = held ? j[u] : (row ? idx[i] : -1);
#pragma unroll
      for (int a = 0; a < 3; ++a) xb[u][a] = held ? x[u][a] : (row ? src[3 * (size_t)i + a] : 0.0f);
      wb[u] = held ? w[u] : (row ? wn[i] : 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int a = 0; a < 3; ++a) m[u][a] = jb[u] >= 0 ? target[3 * (size_t)jb[u] + a] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (jb[u] >= 0) add_moments(acc, m[u], xb[u], wb[u], ms);
    }
  }
  {
    const double v = warp_sum16(acc, lane);
    if ((lane & 1) == 0 && lane / 2 < kSums) warp_sums[warp][lane / 2] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += warp_sums[k][threadIdx.x];
    sums[threadIdx.x] = v;
  }
  // Every CTA of the cluster has started and stored its sums before any
  // reads them; the barrier after the update keeps each alive until then.
  cluster_sync::cluster_barrier();

  // 2. The close, in thread 0 of every CTA (the same sums in the same
  // order, so the same bits).
  if (threadIdx.x < kSums) {
    const unsigned slot = cluster_sync::smem_u32(&sums[threadIdx.x]);
    double v = 0.0;
    for (int r = 0; r < ctas; ++r) {
      v += cluster_sync::ld_cluster_f64(cluster_sync::cluster_u32(slot, r));
    }
    totals[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double A[3][3], md[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      md[a] = totals[a];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        A[a][b] = fma(-md[a], totals[12 + b], totals[3 + 3 * a + b]);
      }
    }
    close3(A, (double)scalars[0], ms, md, with_scale, result);
    if (rank == 0) {
      s_out[0] = result[0];
#pragma unroll
      for (int k = 0; k < 9; ++k) R_out[k] = result[1 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t_out[k] = result[10 + k];
    }
  }
  __syncthreads();

  // 3. The update and the masked motion: the first batch's moved rows and
  // mask from registers (its source rows and weights again, from L1).
  const double s = (double)result[0];
  double R[3][3], t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) R[a][b] = (double)result[1 + 3 * a + b];
    t[a] = (double)result[10 + a];
  }
  double motion = 0.0;
  for (int base = first; base < n; base += kRows * stride) {
    const bool held = base == first;
    float xb[kRows][3], ob[kRows][3], kb[kRows], wb[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = base + u * stride;
      const bool row = i < n;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        xb[u][a] = row ? src[3 * (size_t)i + a] : 0.0f;
        ob[u][a] = held ? old[u][a] : (row ? moved[3 * (size_t)i + a] : 0.0f);
      }
      kb[u] = held ? mk[u] : (row ? mask[i] : 0.0f);
      wb[u] = row ? wn[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = base + u * stride;
      if (i < n) motion += update_row(s, R, t, xb[u], ob[u], kb[u], wb[u], moved + 3 * (size_t)i);
    }
  }
  motion = warp_sum(motion);
  if (lane == 0) warp_motions[warp] = motion;
  __syncthreads();

  // 4. The scalars, by thread 0 of CTA 0.
  if (threadIdx.x == 0) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += warp_motions[k];
    cluster_sync::st_cluster_f64(
        cluster_sync::cluster_u32(cluster_sync::smem_u32(&motions[rank]), 0), v);
  }
  cluster_sync::cluster_barrier();
  if (rank == 0 && threadIdx.x == 0) {
    double v = 0.0;
    for (int r = 0; r < ctas; ++r) v += motions[r];
    const float delta = (float)v;
    delta_out[0] = delta;
    ctrl[0] = count + 1;
    ctrl[1] = (!(delta > scalars[1]) || count + 1 >= max_iterations) ? 1 : 0;
  }
}

}  // namespace

// Plain C entry points, loaded through ctypes; every pointer is a device
// array.  Each launches on `stream` without synchronising and returns the
// launch's error (0 on success).

// The close alone: cov f32 [9], var_s f32 [1], mu_s and mu_d f32 [3], out
// f32 [13]; one thread.
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

// One ICP update after the k-NN: target f32 [M, 3], idx int32 [n], src f32
// [n, 3], mask and wn f32 [n], mu_s f32 [3], var_s and threshold f32 [1];
// writes s f32 [1], R f32 [9], t f32 [3], moved f32 [n, 3], delta f32 [1]
// and ctrl int32 [2] (iteration count, done flag).  One cluster of `ctas`
// CTAs (1 to kMaxCtas) of kThreads threads.
extern "C" int pyfocusr_icp_step_f32(
    const float* target, const int* idx, const float* src, const float* mask,
    const float* wn, const float* mu_s, const float* var_s,
    const float* threshold, int n, int max_iterations, int with_scale, float* s,
    float* R, float* t, float* moved, float* delta, int* ctrl, int ctas,
    int device, void* stream) {
  if (ctas < 1 || ctas > kMaxCtas) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return cluster_sync::launch_grid_of_clusters(
      icp_step_kernel, dim3(ctas, 1, 1), ctas, kThreads, 0,
      static_cast<cudaStream_t>(stream), target, idx, src, mask, wn, mu_s,
      var_s, threshold, n, max_iterations, with_scale, s, R, t, moved, delta,
      ctrl);
}
