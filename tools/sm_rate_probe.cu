// Probe kernels for the per-SM issue rates the CPD E-step kernel leans on:
// f32 fused multiply-adds, f32 adds and `ex2.approx.ftz.f32` exponentials,
// each as eight independent chains per thread.  Built and timed by
// tools/sm_rate_probe.py.

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

// which: 0 ffma, 1 fadd, 2 ex2.  Returns cudaGetLastError().
extern "C" int probe_run(int which, float* out, int blocks, int threads, int iters) {
  if (which == 0) ffma_kernel<<<blocks, threads>>>(out, iters, 0.999f);
  if (which == 1) fadd_kernel<<<blocks, threads>>>(out, iters, 0.001f);
  if (which == 2) ex2_kernel<<<blocks, threads>>>(out, iters, -0.01f);
  return (int)cudaGetLastError();
}
