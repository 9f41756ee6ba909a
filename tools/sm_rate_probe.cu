// Probe kernels for the per-SM issue rates the CPD E-step kernel leans on:
// f32 fused multiply-adds, f32 adds and `ex2.approx.ftz.f32` exponentials,
// each as eight independent chains per thread; and, for the one-thread
// chain of the Umeyama close (csrc/umeyama3.cu), the latency in clocks of
// one dependent f64 operation: FMA, division, square root and reciprocal
// square root.  Built and timed by tools/sm_rate_probe.py.

#include <cuda_runtime.h>

__global__ void ffma_kernel(float* out, int iters, float a) {
  float v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 0.001f + i;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaf(v[i], a, 0.5f);
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void fadd_kernel(float* out, int iters, float a) {
  float v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 0.001f + i;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] - a;
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ex2_kernel(float* out, int iters, float a) {
  float v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 0.001f + i;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y;
      asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v[i] * a));
      v[i] = y;
    }
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One thread: `iters` dependent f64 operations of kind W (0 fma, 1
// division, 2 sqrt, 3 rsqrt) between two clock64() reads, unrolled by 8;
// out[0] the clocks, out[1] the value (kept so the chain is not optimised
// away).
template <int W>
__global__ void f64_chain_kernel(long long* out, int iters, double a) {
  double v = 1.0 + a;
  const long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < iters; ++k) {
    if (W == 0) v = fma(v, a, 0.5);
    if (W == 1) v = 1.5 / v;
    if (W == 2) v = sqrt(v);
    if (W == 3) v = rsqrt(v);
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = __double_as_longlong(v);
}

extern "C" int probe_f64_chain(long long* out, int which, int iters) {
  if (which == 0) f64_chain_kernel<0><<<1, 1>>>(out, iters, 0.999);
  if (which == 1) f64_chain_kernel<1><<<1, 1>>>(out, iters, 0.999);
  if (which == 2) f64_chain_kernel<2><<<1, 1>>>(out, iters, 0.999);
  if (which == 3) f64_chain_kernel<3><<<1, 1>>>(out, iters, 0.999);
  return (int)cudaGetLastError();
}

// which: 0 ffma, 1 fadd, 2 ex2.  Returns cudaGetLastError().
extern "C" int probe_run(int which, float* out, int blocks, int threads, int iters) {
  if (which == 0) ffma_kernel<<<blocks, threads>>>(out, iters, 0.999f);
  if (which == 1) fadd_kernel<<<blocks, threads>>>(out, iters, 0.001f);
  if (which == 2) ex2_kernel<<<blocks, threads>>>(out, iters, -0.01f);
  return (int)cudaGetLastError();
}
