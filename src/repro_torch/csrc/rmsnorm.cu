// rmsnorm.cu -- rmsnorm in one summation order fixed by d alone,
// hand-written for Hopper (sm_90a).
//
// Not a TPU kernel: the reference computes rmsnorm in XLA
// (repro/models/layers.py:221).  The port needs its own because a row's
// bits must not depend on the rows beside it: a speculative verify
// normalizes 16 rows where a decode step normalizes 4, and the engine
// prefills 64-row chunks where the synchronous oracle prefills the whole
// prompt.  torch's CUDA reduction picks its block shape, and so its
// summation order, from the shape of the whole tensor.
//
// y[r, :] = x[r, :] * (1 / sqrt(sum(x[r, :]^2) / d + eps)) * (1 + gamma)
//
// The order, for any d (the plain twin in kernels/rmsnorm.py repeats it
// op for op):
//  * one block of kThreads = 128 threads per row;
//  * thread t sums x[t]^2, x[t + 128]^2, x[t + 256]^2, ... in sequence
//    (each square rounded, then added: no FMA contraction);
//  * the 128 partials are summed by a fixed shared-memory tree, halving
//    64, 32, ..., 1 (a thread past d holds 0, which adds nothing);
//  * ms = total / d, r = 1 / sqrt(ms + eps), y = (x * r) * (1 + gamma),
//    each op rounded to nearest in f32.
// Every op is an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so the kernel computes what the twin does.
//
// What bounds it on an H100: bytes (x read twice, the second time from
// L2; gamma; y written) and, at a decode step's 4 rows, launch latency.
// The point is one launch in place of ~8 small torch ops a norm.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               float* __restrict__ y, int d, float eps) {
  __shared__ float part[kThreads];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * d;
  float acc = 0.0f;
  for (int i = t; i < d; i += kThreads) {
    const float v = load(x, base + i);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  part[t] = acc;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) part[t] = __fadd_rn(part[t], part[t + h]);
    __syncthreads();
  }
  const float ms = __fdiv_rn(part[0], (float)d);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  for (int i = t; i < d; i += kThreads) {
    const float v = load(x, base + i);
    y[base + i] = __fmul_rn(__fmul_rn(v, r), __fadd_rn(1.0f, gamma[i]));
  }
}

}  // namespace

// x (rows, d) f32 (bf16 = 0) or bf16 (bf16 = 1); gamma (d,) f32; y (rows,
// d) f32.  One block a row.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* y,
                              int64_t rows, int d, float eps, int bf16,
                              void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rows);
  if (bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(gamma), static_cast<float*>(y), d, eps);
  } else {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(y), d, eps);
  }
  return (int)cudaGetLastError();
}
