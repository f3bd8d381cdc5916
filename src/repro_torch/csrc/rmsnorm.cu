// rmsnorm.cu -- rmsnorm and layernorm in one summation order fixed by d
// alone, and rmsnorm fused with the residual add before it and the
// activation cast after it, hand-written for Hopper (sm_90a).
//
// Not TPU kernels: the reference computes both norms in XLA
// (repro/models/layers.py:221 and :228).  The port needs its own because
// a row's bits must not depend on the rows beside it: a speculative
// verify normalizes 16 rows where a decode step normalizes 4, and the
// engine prefills 64-row chunks where the synchronous oracle prefills the
// whole prompt.  torch's CUDA reduction picks its block shape, and so its
// summation order, from the shape of the whole tensor.
//
// rmsnorm:   y[r, :] = x * (1 / sqrt(sum(x^2) / d + eps)) * (1 + gamma)
// layernorm: mu = sum(x) / d;  var = sum((x - mu)^2) / d (a second pass,
//            not E[x^2] - mu^2);
//            y[r, :] = ((x - mu) * (1 / sqrt(var + eps))) * gamma + beta
// add_rmsnorm: s = x + y in the dtype the model's residual_add gives
//            (same-dtype pairs add in f32 and round to their dtype, as
//            torch's CUDA add does; a mixed pair stays f32), s written
//            out, then rmsnorm of s, rounded to the reading layer's
//            activation dtype.  y may be absent (the first norm, over the
//            embedding): rmsnorm and cast alone.
//
// The order of every row sum, for any d (the plain twins in
// kernels/rmsnorm.py and kernels/layernorm.py repeat it op for op):
//  * one block of kThreads = 128 threads per row;
//  * thread t starts at 0 and adds v[t], v[t + 128], v[t + 256], ... in
//    sequence (each v -- a square, a difference squared -- rounded, then
//    added: no FMA contraction);
//  * the 128 partials are summed by a fixed shared-memory tree, halving
//    64, 32, ..., 1 (a thread past d holds 0, which adds nothing);
//  * every later op rounded to nearest in f32, in the order written
//    above.
// Every op is an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), so a kernel computes what its twin
// does.
//
// What bounds them on an H100: bytes (x read two or three times, the
// later passes from L2; gamma, beta; y written) and, at a decode step's
// 4 rows, launch latency.  The point is one launch in place of ~8 small
// torch ops a norm; add_rmsnorm makes it one launch in place of three
// (the add, the norm, the cast), and reads s once: a thread keeps its
// d / 128 values in registers between the sum and the scale.  Loads stay
// one element a thread: thread t's values are t + 128 j, so a 16-byte
// load would give a thread 4-8 values of other threads' partials, and the
// order above would change; a warp's loads are still coalesced (32
// adjacent elements an instruction).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// The block's sum of each thread's partial ``v``, by the fixed tree;
// every thread gets it.  ``part`` is free again on return.
__device__ __forceinline__ float tree_sum(float* part, float v) {
  const int t = threadIdx.x;
  part[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) part[t] = __fadd_rn(part[t], part[t + h]);
    __syncthreads();
  }
  const float total = part[0];
  __syncthreads();
  return total;
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
  const float ms = __fdiv_rn(tree_sum(part, acc), (float)d);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  for (int i = t; i < d; i += kThreads) {
    const float v = load(x, base + i);
    y[base + i] = __fmul_rn(__fmul_rn(v, r), __fadd_rn(1.0f, gamma[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ y,
                 int d, float eps) {
  __shared__ float part[kThreads];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * d;
  float acc = 0.0f;
  for (int i = t; i < d; i += kThreads) {
    acc = __fadd_rn(acc, load(x, base + i));
  }
  const float mu = __fdiv_rn(tree_sum(part, acc), (float)d);
  acc = 0.0f;
  for (int i = t; i < d; i += kThreads) {
    const float c = __fsub_rn(load(x, base + i), mu);
    acc = __fadd_rn(acc, __fmul_rn(c, c));
  }
  const float var = __fdiv_rn(tree_sum(part, acc), (float)d);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = t; i < d; i += kThreads) {
    const float c = __fsub_rn(load(x, base + i), mu);
    y[base + i] = __fadd_rn(__fmul_rn(__fmul_rn(c, r), gamma[i]), beta[i]);
  }
}

// add_rmsnorm's dtypes (kernels/rmsnorm.py DT_CODES)
enum Dt { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float load_dt(const void* p, int64_t i, int dt) {
  if (dt == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// f32 -> dt and back: round to nearest even with torch's CUDA casts'
// intrinsics (c10::BFloat16 and c10::Half call __float2bfloat16 and
// __float2half on sm_80 and later), so a NaN gets the payload torch's
// .to(dtype) gives on the card.
__device__ __forceinline__ float round_dt(float v, int dt) {
  if (dt == kBF16) return __bfloat162float(__float2bfloat16(v));
  if (dt == kF16) return __half2float(__float2half(v));
  return v;
}

__device__ __forceinline__ void store_dt(void* p, int64_t i, float v,
                                         int dt) {
  if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else if (dt == kF16)
    static_cast<__half*>(p)[i] = __float2half(v);
  else
    static_cast<float*>(p)[i] = v;
}

// v[j] = p[base + t + 128 j] as f32 (0 past d), the dtype chosen once for
// the whole row so that its NPT loads issue back to back
template <int NPT>
__device__ __forceinline__ void load_row(const void* __restrict__ p, int dt,
                                         int64_t base, int t, int d,
                                         float (&v)[NPT]) {
  if (dt == kBF16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + base;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int i = t + kThreads * j;
      v[j] = i < d ? __bfloat162float(q[i]) : 0.0f;
    }
  } else if (dt == kF16) {
    const __half* q = static_cast<const __half*>(p) + base;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int i = t + kThreads * j;
      v[j] = i < d ? __half2float(q[i]) : 0.0f;
    }
  } else {
    const float* q = static_cast<const float*>(p) + base;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int i = t + kThreads * j;
      v[j] = i < d ? q[i] : 0.0f;
    }
  }
}

// s = x (+ y), one row a block.  NPT > 0: thread t keeps s[t + 128 j],
// j < NPT, in registers (d <= 128 NPT), and issues every load of x, y and
// gamma before its first store, so the loads are in flight together (a
// store between them would order the next load behind it); NPT = 0: any
// d, s written in the sum pass and read again in the scale pass (from
// res, or x when y is absent).
template <int NPT>
__global__ void __launch_bounds__(kThreads)
add_rmsnorm_kernel(const void* __restrict__ x, const void* __restrict__ y,
                   const float* __restrict__ gamma, void* __restrict__ res,
                   void* __restrict__ out, int d, float eps, int x_dt,
                   int y_dt, int res_dt, int out_dt) {
  __shared__ float part[kThreads];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * d;
  float acc = 0.0f;
  if constexpr (NPT > 0) {
    constexpr bool kGamma = NPT <= 40;   // gamma in registers too
    float s[NPT], g[kGamma ? NPT : 1];
    load_row<NPT>(x, x_dt, base, t, d, s);
    if constexpr (kGamma) {
#pragma unroll
      for (int j = 0; j < NPT; ++j)
        g[j] = t + kThreads * j < d ? gamma[t + kThreads * j] : 0.0f;
    }
    if (y != nullptr) {
      float v[NPT];
      load_row<NPT>(y, y_dt, base, t, d, v);
#pragma unroll
      for (int j = 0; j < NPT; ++j)
        if (t + kThreads * j < d)
          s[j] = round_dt(__fadd_rn(s[j], v[j]), res_dt);
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (t + kThreads * j < d) acc = __fadd_rn(acc, __fmul_rn(s[j], s[j]));
    const float ms = __fdiv_rn(tree_sum(part, acc), (float)d);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int i = t + kThreads * j;
      if (i >= d) continue;
      if (y != nullptr) store_dt(res, base + i, s[j], res_dt);
      float gj;
      if constexpr (kGamma) gj = g[j]; else gj = gamma[i];
      store_dt(out, base + i,
               __fmul_rn(__fmul_rn(s[j], r), __fadd_rn(1.0f, gj)), out_dt);
    }
  } else {
    for (int i = t; i < d; i += kThreads) {
      float v = load_dt(x, base + i, x_dt);
      if (y != nullptr) {
        v = round_dt(__fadd_rn(v, load_dt(y, base + i, y_dt)), res_dt);
        store_dt(res, base + i, v, res_dt);
      }
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    const float ms = __fdiv_rn(tree_sum(part, acc), (float)d);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
    const void* src = y != nullptr ? res : x;
    const int src_dt = y != nullptr ? res_dt : x_dt;
    for (int i = t; i < d; i += kThreads)
      store_dt(out, base + i,
               __fmul_rn(__fmul_rn(load_dt(src, base + i, src_dt), r),
                         __fadd_rn(1.0f, gamma[i])),
               out_dt);
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

// x (rows, d) f32 (bf16 = 0) or bf16 (bf16 = 1); gamma, beta (d,) f32; y
// (rows, d) f32.  One block a row.
extern "C" int layernorm_launch(const void* x, const void* gamma,
                                const void* beta, void* y, int64_t rows,
                                int d, float eps, int bf16, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rows);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (bf16) {
    layernorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, static_cast<float*>(y),
        d, eps);
  } else {
    layernorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(y), d, eps);
  }
  return (int)cudaGetLastError();
}

// x, y (rows, d) in dtype codes x_dt, y_dt (0 f32, 1 bf16, 2 f16); y may
// be NULL (no add: res unused).  gamma (d,) f32.  res (rows, d) in res_dt,
// the dtype of x + y (x_dt when both are one dtype, else f32); out (rows,
// d) in out_dt.  One block a row; a thread keeps its values in registers
// up to d = 8192.
extern "C" int add_rmsnorm_launch(const void* x, const void* y,
                                  const void* gamma, void* res, void* out,
                                  int64_t rows, int d, float eps, int x_dt,
                                  int y_dt, int res_dt, int out_dt,
                                  void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (x == nullptr || gamma == nullptr || out == nullptr ||
      (y != nullptr && res == nullptr) || x_dt < 0 || x_dt > 2 ||
      y_dt < 0 || y_dt > 2 || res_dt < 0 || res_dt > 2 || out_dt < 0 ||
      out_dt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rows);
  const float* g = static_cast<const float*>(gamma);
  const int per = (d + kThreads - 1) / kThreads;   // values a thread
#define ADD_RMSNORM(NPT)                                                   \
  add_rmsnorm_kernel<NPT><<<grid, kThreads, 0, s>>>(x, y, g, res, out, d, \
                                                    eps, x_dt, y_dt,       \
                                                    res_dt, out_dt)
  if (per <= 8) ADD_RMSNORM(8);
  else if (per <= 16) ADD_RMSNORM(16);
  else if (per <= 32) ADD_RMSNORM(32);
  else if (per <= 40) ADD_RMSNORM(40);
  else if (per <= 64) ADD_RMSNORM(64);
  else ADD_RMSNORM(0);
#undef ADD_RMSNORM
  return (int)cudaGetLastError();
}
