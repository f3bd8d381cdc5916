// flash_decode.cu -- one-token GQA attention over a contiguous packed KV
// cache, hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, _decode_kernel (the Pallas
// body behind flash_decode()).  For every sequence b and KV head h the G
// query heads of the group attend over the first min(len[b], S) positions
// of K/V (B, S, H, dh), held as packed (e, m) containers (e5m2 u8 under
// the transprecision policy) or f32.  The reference's grid walks the cache
// in block_kv = 256 tiles carrying (m, l, acc) in VMEM scratch; here one
// block walks its own tiles in a loop.
//
// What bounds it on an H100: bytes.  Each live K/V element is read once at
// container width (1 B for binary8) and feeds G = 4 multiply-adds, far
// below the ridge point.  At the serving shape (B = 4, H = 8) the grid is
// only B * H = 32 blocks on 132 SMs, so a step is latency-bound; splitting
// S across blocks is later work.
//
// The simple design, and what it does about that:
//  * One block per (sequence, KV head) serves all G query rows, so each
//    K/V byte is read from device memory once per step, not G times.
//  * Each kT-row tile of K and V is decoded ONCE into shared memory
//    (coalesced container loads, codec.cuh; e5m2 / bf16 / f16 through the
//    hardware conversion, exact, NaN canonicalized) and then read by all
//    G rows of the group.
//  * Scores: one warp per K row, lanes across head_dim (conflict-free
//    shared reads), G dot products per row reduced by warp shuffles.
//  * Online softmax in f32 with the reference's NEG_INF = -1e30 sentinel
//    (one warp per query head), then P @ V with one thread per head_dim
//    column.
//  * Tiles at or past min(len, S) are skipped, and a tile's rows past the
//    length are not read.  In the reference they are loaded and fully
//    masked, which leaves (m, l, acc) unchanged, so skipping is exact.
//    Zero valid tokens give a zero output and (m, l) = (NEG_INF, 0), the
//    reference's _finalize.
// Optional (m, l) outputs feed a later shard merge.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // KV rows per shared-memory tile
constexpr float kNegInf = -1e30f;

template <typename T, int E, int M, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int S, int H, int dh,
                    float scale, int rt_e, int rt_m) {
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kTile][dh]
  float* v_s = k_s + kTile * dh;      // [kTile][dh]
  float* q_s = v_s + kTile * dh;      // [G][dh]
  float* acc_s = q_s + G * dh;        // [G][dh]
  float* p_s = acc_s + G * dh;        // [G][kTile]
  float* m_s = p_s + G * kTile;       // [G]
  float* l_s = m_s + G;               // [G]
  float* a_s = l_s + G;               // [G]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qbase = ((size_t)b * H + h) * G * dh;
  const int len = min(max(lengths[b], 0), S);
  const size_t row_stride = (size_t)H * dh;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)h * dh;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)h * dh;

  for (int i = tid; i < G * dh; i += kThreads) {
    q_s[i] = q[qbase + i];
    acc_s[i] = 0.0f;
  }
  if (tid < G) { m_s[tid] = kNegInf; l_s[tid] = 0.0f; }

  for (int base = 0; base < len; base += kTile) {
    const int rows = min(kTile, len - base);

    // ---- decode the K and V tile into shared memory ----------------------
    for (int i = tid; i < rows * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const size_t off = (size_t)(base + r) * row_stride + d;
      k_s[i] = codec::decode_t<E, M>((uint32_t)kb[off], rt_e, rt_m);
      v_s[i] = codec::decode_t<E, M>((uint32_t)vb[off], rt_e, rt_m);
    }
    __syncthreads();

    // ---- scores s[g][r] = (q[g] . k[r]) * scale ---------------------------
    for (int r = warp; r < rows; r += kWarps) {
      float kd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        kd[i] = d < dh ? k_s[r * dh + d] : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < dh) s = fmaf(q_s[g * dh + d], kd[i], s);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) p_s[g * kTile + r] = s * scale;
      }
    }
    __syncthreads();

    // ---- online softmax update, one warp per query head -------------------
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * kTile + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(p_s[g * kTile + r] - m_new);
        p_s[g * kTile + r] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P @ V -----------------------------------------
    for (int d = tid; d < dh; d += kThreads) {
      float pv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pv[g] = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float vv = v_s[r * dh + d];
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g] = fmaf(p_s[g * kTile + r], vv, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc_s[g * dh + d] = acc_s[g * dh + d] * a_s[g] + pv[g];
    }
    __syncthreads();
  }
  __syncthreads();   // the init above when no tile ran

  for (int i = tid; i < G * dh; i += kThreads) {
    const float l = l_s[i / dh];
    out[qbase + i] = l > 0.0f ? acc_s[i] / l : 0.0f;
  }
  if (m_out != nullptr && tid < G) {
    m_out[((size_t)b * H + h) * G + tid] = m_s[tid];
    l_out[((size_t)b * H + h) * G + tid] = l_s[tid];
  }
}

template <typename T, int E, int M, int G>
cudaError_t launch_g(const float* q, const void* k, const void* v,
                     const int* lengths, float* out, float* m_out,
                     float* l_out, int B, int S, int H, int dh, float scale,
                     int rt_e, int rt_m, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTile * dh + 2 * G * dh + G * kTile + 3 * G);
  auto kern = flash_decode_kernel<T, E, M, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), lengths, out,
      m_out, l_out, S, H, dh, scale, rt_e, rt_m);
  return cudaGetLastError();
}

template <typename T, int E, int M>
cudaError_t launch_fmt(int G, const float* q, const void* k, const void* v,
                       const int* lengths, float* out, float* m_out,
                       float* l_out, int B, int S, int H, int dh, float scale,
                       int rt_e, int rt_m, cudaStream_t s) {
  switch (G) {
    case 1: return launch_g<T, E, M, 1>(q, k, v, lengths, out, m_out, l_out, B, S, H, dh, scale, rt_e, rt_m, s);
    case 2: return launch_g<T, E, M, 2>(q, k, v, lengths, out, m_out, l_out, B, S, H, dh, scale, rt_e, rt_m, s);
    case 4: return launch_g<T, E, M, 4>(q, k, v, lengths, out, m_out, l_out, B, S, H, dh, scale, rt_e, rt_m, s);
    case 8: return launch_g<T, E, M, 8>(q, k, v, lengths, out, m_out, l_out, B, S, H, dh, scale, rt_e, rt_m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt_code as in qmm.cu: 0 f32 / binary32, 1 binary8, 2 binary8alt,
// 3 binary16, 4 binary16alt, 5/6/7 any other (rt_e, rt_m) in u8/u16/u32.
// m_out / l_out may be null.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* m_out, void* l_out,
                                   int B, int S, int H, int G, int dh,
                                   float scale, int fmt_code, int rt_e,
                                   int rt_m, void* stream) {
  const float* Q = static_cast<const float*>(q);
  const int* L = static_cast<const int*>(lengths);
  float* O = static_cast<float*>(out);
  float* MO = static_cast<float*>(m_out);
  float* LO = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(G, Q, k, v, L, O, MO, LO, B, S, H, dh, scale, rt_e, rt_m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
