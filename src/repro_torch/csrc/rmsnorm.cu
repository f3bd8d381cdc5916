// rmsnorm.cu -- rmsnorm and layernorm in one summation order fixed by d
// alone, and each fused with the residual add before it and the
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
// add_layernorm: the same s, then layernorm of s in layernorm's order
//            (c = s - mu kept in place of s), rounded the same way.
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
// 4 rows, launch latency and what one SM keeps in flight for its row.
// The point is one launch in place of ~8 small torch ops a norm;
// add_rmsnorm and add_layernorm make it one launch in place of three (the
// add, the norm, the cast), and read s once: a thread keeps its d / 128
// values in registers between the sums and the scale.  Loads stay one
// element a thread: thread t's values are t + 128 j, so a 16-byte load
// would give a thread 4-8 values of other threads' partials, and the
// order above would change; a warp's loads are still coalesced (32
// adjacent elements an instruction).  add_layernorm's 16-byte variant
// (add_layernorm_vec_kernel, d 5121-8192) keeps the order by summing from
// a shared-memory copy of the row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <initializer_list>

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

// gamma[t + 128 (j0 + j)] and beta's, j < N, into g and b (0 past d)
template <int N>
__device__ __forceinline__ void load_params(const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            int t, int d, int j0,
                                            float (&g)[N], float (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = t + kThreads * (j0 + j);
    g[j] = i < d ? gamma[i] : 0.0f;
    b[j] = i < d ? beta[i] : 0.0f;
  }
}

// add_rmsnorm_kernel's row, layernorm's arithmetic: s = x (+ y) written
// to res as soon as it is formed (every load of x and y is issued before
// it), mu = sum(s) / d, c = s - mu kept in place of s, var = sum(c * c) /
// d, out = round_out(((c * r) * gamma) + beta).  gamma and beta go to
// registers kPart values at a time, every load of a part issued before
// its first use: NPT <= 32, all of them with the row; wider rows (64
// values of s and of y already hold 128 registers at NPT 64) in two
// halves, the first in flight during the variance's tree sum, the second
// after the first half's stores (one exposed round trip, where reading
// them in the scale loop serialised one a value).  NPT = 0: any d, s
// read back from res (or x) by the variance and the scale passes.
template <int NPT>
__global__ void __launch_bounds__(kThreads)
add_layernorm_kernel(const void* __restrict__ x, const void* __restrict__ y,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, void* __restrict__ res,
                     void* __restrict__ out, int d, float eps, int x_dt,
                     int y_dt, int res_dt, int out_dt) {
  __shared__ float part[kThreads];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * d;
  float acc = 0.0f;
  if constexpr (NPT > 0) {
    constexpr int kPart = NPT <= 32 ? NPT : NPT / 2;
    float s[NPT], g[kPart], b[kPart];
    load_row<NPT>(x, x_dt, base, t, d, s);
    if constexpr (kPart == NPT) load_params<kPart>(gamma, beta, t, d, 0, g, b);
    if (y != nullptr) {
      float v[NPT];
      load_row<NPT>(y, y_dt, base, t, d, v);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int i = t + kThreads * j;
        if (i < d) {
          s[j] = round_dt(__fadd_rn(s[j], v[j]), res_dt);
          store_dt(res, base + i, s[j], res_dt);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (t + kThreads * j < d) acc = __fadd_rn(acc, s[j]);
    const float mu = __fdiv_rn(tree_sum(part, acc), (float)d);
    acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (t + kThreads * j >= d) continue;
      s[j] = __fsub_rn(s[j], mu);
      acc = __fadd_rn(acc, __fmul_rn(s[j], s[j]));
    }
    if constexpr (kPart < NPT) load_params<kPart>(gamma, beta, t, d, 0, g, b);
    const float var = __fdiv_rn(tree_sum(part, acc), (float)d);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int j0 = 0; j0 < NPT; j0 += kPart) {
      if (j0 > 0) load_params<kPart>(gamma, beta, t, d, j0, g, b);
#pragma unroll
      for (int j = 0; j < kPart; ++j) {
        const int i = t + kThreads * (j0 + j);
        if (i < d)
          store_dt(out, base + i,
                   __fadd_rn(__fmul_rn(__fmul_rn(s[j0 + j], r), g[j]), b[j]),
                   out_dt);
      }
    }
  } else {
    for (int i = t; i < d; i += kThreads) {
      float v = load_dt(x, base + i, x_dt);
      if (y != nullptr) {
        v = round_dt(__fadd_rn(v, load_dt(y, base + i, y_dt)), res_dt);
        store_dt(res, base + i, v, res_dt);
      }
      acc = __fadd_rn(acc, v);
    }
    const float mu = __fdiv_rn(tree_sum(part, acc), (float)d);
    const void* src = y != nullptr ? res : x;
    const int src_dt = y != nullptr ? res_dt : x_dt;
    acc = 0.0f;
    for (int i = t; i < d; i += kThreads) {
      const float c = __fsub_rn(load_dt(src, base + i, src_dt), mu);
      acc = __fadd_rn(acc, __fmul_rn(c, c));
    }
    const float var = __fdiv_rn(tree_sum(part, acc), (float)d);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    for (int i = t; i < d; i += kThreads) {
      const float c = __fsub_rn(load_dt(src, base + i, src_dt), mu);
      store_dt(out, base + i,
               __fadd_rn(__fmul_rn(__fmul_rn(c, r), gamma[i]), beta[i]),
               out_dt);
    }
  }
}

// Eight values from p[i..i+7] as f32 (16 or 32 bytes, aligned to 16).
__device__ __forceinline__ void load8(const void* __restrict__ p, int dt,
                                      int64_t i, float (&v)[8]) {
  if (dt == kF32) {
    const float4* q =
        reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
  const uint4 u = *reinterpret_cast<const uint4*>(
      static_cast<const unsigned short*>(p) + i);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const unsigned short h = (unsigned short)(w[e / 2] >> (16 * (e % 2)));
    v[e] = dt == kBF16 ? __bfloat162float(__ushort_as_bfloat16(h))
                       : __half2float(__ushort_as_half(h));
  }
}

// v rounded to dt and stored at p[i..i+7], as store_dt would one by one.
__device__ __forceinline__ void store8(void* __restrict__ p, int dt,
                                       int64_t i, const float (&v)[8]) {
  if (dt == kF32) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned short h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      h[e] = dt == kBF16 ? __bfloat16_as_ushort(__float2bfloat16(v[2 * k + e]))
                         : __half_as_ushort(__float2half(v[2 * k + e]));
    w[k] = (unsigned)h[0] | ((unsigned)h[1] << 16);
  }
  *reinterpret_cast<uint4*>(static_cast<unsigned short*>(p) + i) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// add_layernorm_kernel's arithmetic with 16-byte loads and stores, for d a
// multiple of 8 up to 1024 NV and every pointer aligned to 16 bytes.  A
// load of one element a thread moves 64 bytes a warp instruction, and one
// block a row has only 4 warps to keep loads in flight: at d 8192 the
// register variant (NPT 64) took as long as layernorm_launch's three
// passes.  Up to NPT 40 it is the faster (d 4096: 0.0087 against 0.0105
// ms, L2 flushed), so the launcher takes this one above d 5120 only, and
// instantiates NV = 8.  Here
// thread t takes the eight-value pieces t + 128 m, m < NV: s = x (+ y) in
// that layout (elementwise, so the same bits in any layout), written to
// res and to the row's f32 copy in shared memory; then gamma's and beta's
// pieces are loaded, in flight while each thread sums its strided values
// t + 128 j from shared memory in layernorm's order (so mu, var and r are
// the register variant's bits); the output, elementwise again, reads s
// back from shared memory.
template <int NV>
__global__ void __launch_bounds__(kThreads)
add_layernorm_vec_kernel(const void* __restrict__ x,
                         const void* __restrict__ y,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         void* __restrict__ res, void* __restrict__ out,
                         int d, float eps, int x_dt, int y_dt, int res_dt,
                         int out_dt) {
  __shared__ __align__(16) float row[kThreads * 8 * NV];
  __shared__ float part[kThreads];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * d;
  {
    float s[NV][8];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = 8 * (t + kThreads * m);
      if (i < d) load8(x, x_dt, base + i, s[m]);
    }
    if (y != nullptr) {
      float v[NV][8];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int i = 8 * (t + kThreads * m);
        if (i < d) load8(y, y_dt, base + i, v[m]);
      }
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int i = 8 * (t + kThreads * m);
        if (i >= d) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          s[m][e] = round_dt(__fadd_rn(s[m][e], v[m][e]), res_dt);
        store8(res, res_dt, base + i, s[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = 8 * (t + kThreads * m);
      if (i >= d) continue;
      store8(row, kF32, i, s[m]);
    }
  }
  float g[NV][8], b[NV][8];
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int i = 8 * (t + kThreads * m);
    if (i >= d) continue;
    load8(gamma, kF32, i, g[m]);
    load8(beta, kF32, i, b[m]);
  }
  __syncthreads();
  float acc = 0.0f;
  for (int i = t; i < d; i += kThreads) acc = __fadd_rn(acc, row[i]);
  const float mu = __fdiv_rn(tree_sum(part, acc), (float)d);
  acc = 0.0f;
  for (int i = t; i < d; i += kThreads) {
    const float c = __fsub_rn(row[i], mu);
    acc = __fadd_rn(acc, __fmul_rn(c, c));
  }
  const float var = __fdiv_rn(tree_sum(part, acc), (float)d);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int i = 8 * (t + kThreads * m);
    if (i >= d) continue;
    float o[8];
    load8(row, kF32, i, o);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(o[e], mu), r), g[m][e]),
                       b[m][e]);
    store8(out, out_dt, base + i, o);
  }
}

// The fused launches' arguments: the pointers each needs, dtype codes in
// 0..2, and res and out apart from x, y and each other (the kernels take
// them __restrict__, so nvcc may move a load of x past a store to res).
bool fused_args_ok(const void* x, const void* y, const void* res,
                   const void* out, int x_dt, int y_dt, int res_dt,
                   int out_dt) {
  for (int dt : {x_dt, y_dt, res_dt, out_dt})
    if (dt < 0 || dt > 2) return false;
  if (x == nullptr || out == nullptr || out == x || out == y) return false;
  return y == nullptr || (res != nullptr && res != x && res != y &&
                          res != out);
}

// the register variant for d, or 0 (re-reading) past 128 x 64
int fused_npt(int d) {
  const int per = (d + kThreads - 1) / kThreads;   // values a thread
  for (int npt : {8, 16, 32, 40, 64})
    if (per <= npt) return npt;
  return 0;
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
  if (gamma == nullptr ||
      !fused_args_ok(x, y, res, out, x_dt, y_dt, res_dt, out_dt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rows);
  const float* g = static_cast<const float*>(gamma);
#define ADD_RMSNORM(NPT)                                                   \
  add_rmsnorm_kernel<NPT><<<grid, kThreads, 0, s>>>(x, y, g, res, out, d, \
                                                    eps, x_dt, y_dt,       \
                                                    res_dt, out_dt)
  switch (fused_npt(d)) {
    case 8: ADD_RMSNORM(8); break;
    case 16: ADD_RMSNORM(16); break;
    case 32: ADD_RMSNORM(32); break;
    case 40: ADD_RMSNORM(40); break;
    case 64: ADD_RMSNORM(64); break;
    default: ADD_RMSNORM(0);
  }
#undef ADD_RMSNORM
  return (int)cudaGetLastError();
}

// add_rmsnorm_launch's arguments with layernorm's beta (d,) f32 beside
// gamma.  d a multiple of 8 in 5121..8192 with every pointer (NULL
// included) aligned to 16 bytes takes the 16-byte variant; any other row
// the register variants by d, as add_rmsnorm_launch.
extern "C" int add_layernorm_launch(const void* x, const void* y,
                                    const void* gamma, const void* beta,
                                    void* res, void* out, int64_t rows,
                                    int d, float eps, int x_dt, int y_dt,
                                    int res_dt, int out_dt, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (gamma == nullptr || beta == nullptr ||
      !fused_args_ok(x, y, res, out, x_dt, y_dt, res_dt, out_dt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rows);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  bool vec = d % 8 == 0 && d > 40 * kThreads && d <= 64 * kThreads;
  for (const void* p : {x, y, gamma, beta, (const void*)res,
                        (const void*)out})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (vec) {
    add_layernorm_vec_kernel<8><<<grid, kThreads, 0, s>>>(
        x, y, g, b, res, out, d, eps, x_dt, y_dt, res_dt, out_dt);
    return (int)cudaGetLastError();
  }
#define ADD_LAYERNORM(NPT)                                                 \
  add_layernorm_kernel<NPT><<<grid, kThreads, 0, s>>>(                     \
      x, y, g, b, res, out, d, eps, x_dt, y_dt, res_dt, out_dt)
  switch (fused_npt(d)) {
    case 8: ADD_LAYERNORM(8); break;
    case 16: ADD_LAYERNORM(16); break;
    case 32: ADD_LAYERNORM(32); break;
    case 40: ADD_LAYERNORM(40); break;
    case 64: ADD_LAYERNORM(64); break;
    default: ADD_LAYERNORM(0);
  }
#undef ADD_LAYERNORM
  return (int)cudaGetLastError();
}
