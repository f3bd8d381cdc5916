// flash_prefill.cu -- chunked causal GQA prefill attention with online
// softmax, hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, _prefill_kernel (the Pallas
// body behind flash_prefill(), which the paged prefill delegates to).
// q (B, Sq, H, G, dh) f32 attends causally (key position <= q_offset +
// query index), optionally inside a sliding window and with a
// bidirectional prefix, over K/V (B, Skv, H, dh) given as packed (e, m)
// containers or as f32.
//
// What bounds it on an H100: at the serving shapes (one 64-token chunk
// against a few hundred cached tokens) the work is tiny -- a few MFLOP and
// a few hundred KB per layer -- so the launch and the small grid bound it;
// the f32 x f32 contract keeps the products on CUDA cores (no TF32 or bf16
// mma), so at long contexts it would be bound by CUDA-core FLOPs.
//
// The simple design, and what it does about that:
//  * One block per (q tile, KV head, batch row).  A q tile is 64 rows:
//    64 / G query positions x the G heads of the group, so each K/V tile
//    is decoded once for the whole group.
//  * A loop over 32-row KV tiles takes the place of the reference's
//    "arbitrary" grid axis.  Tiles that are surely fully masked (strictly
//    future tiles, tiles left of the window, unless inside the prefix) are
//    skipped by the rule at flash_attention.py:268-279; a skipped tile
//    would leave (m, l, acc) bit-unchanged, so skipping is exact.
//  * K/V tiles are decoded through codec.cuh into shared memory as f32
//    (32 x 128 x 4 B = 16 KB each; the q tile takes 33 KB), all within
//    one block's dynamic shared memory.
//  * Masks are generated from indices in registers; scores, the online
//    softmax (reference sentinel NEG_INF = -1e30, exact-zero masking) and
//    the accumulator stay in f32.  Each thread owns one head_dim column of
//    its rows' accumulator in registers.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // q rows (position x group head) per block
constexpr int kBKV = 32;      // KV rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool allowed(int qi, int ki, int Skv, int window,
                                        int prefix_len) {
  bool ok = ki <= qi;
  if (window > 0) ok = ok && (ki > qi - window);
  if (prefix_len > 0) ok = ok || (ki < prefix_len);
  return ok && ki < Skv;
}

template <typename T, int E, int M, int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     int Sq, int Skv, int H, int G, float scale, int window,
                     int prefix_len, int q_offset, int rt_e, int rt_m) {
  constexpr int kRowsPerThread = kRows * DH / kThreads;  // acc registers
  constexpr int kRowGroups = kThreads / DH;
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kRows][DH + 1]
  float* Ks = Qs + kRows * (DH + 1);         // [kBKV][DH + 1]
  float* Vs = Ks + kBKV * (DH + 1);          // [kBKV][DH]
  float* Ss = Vs + kBKV * DH;                // [kRows][kBKV + 1]
  float* m_s = Ss + kRows * (kBKV + 1);      // [kRows]
  float* l_s = m_s + kRows;                  // [kRows]
  float* a_s = l_s + kRows;                  // [kRows]

  const int bq = kRows / G;                  // query positions per block
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nq = min(bq, Sq - q0);           // real positions in this tile

  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int qp = q0 + r / G, g = r % G;
    Qs[r * (DH + 1) + d] =
        qp < Sq ? q[((((size_t)b * Sq + qp) * H + h) * G + g) * DH + d]
                : 0.0f;
  }
  if (tid < kRows) { m_s[tid] = kNegInf; l_s[tid] = 0.0f; }

  const int dcol = tid % DH;                 // this thread's head_dim column
  const int rgrp = tid / DH;                 // and its block of rows
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  const int qi_min = q_offset + q0;
  const int qi_max = q_offset + q0 + nq - 1;
  const int n_tiles = (Skv + kBKV - 1) / kBKV;
  // score tile: thread (ty, tx) computes rows ty*4..ty*4+3, cols tx, tx+16
  const int ty = tid / 16, tx = tid % 16;

  for (int t = 0; t < n_tiles; ++t) {
    const int ki_min = t * kBKV, ki_max = ki_min + kBKV - 1;
    bool live = ki_min <= qi_max;
    if (window > 0) live = live && (ki_max > qi_min - window);
    if (prefix_len > 0) live = live || (ki_min < prefix_len);
    if (!live) continue;                     // uniform across the block

    __syncthreads();                         // previous tile fully consumed
    for (int i = tid; i < kBKV * DH; i += kThreads) {
      const int c = i / DH, d = i % DH, kp = ki_min + c;
      float kv = 0.0f, vv = 0.0f;
      if (kp < Skv) {
        const size_t off = (((size_t)b * Skv + kp) * H + h) * DH + d;
        kv = codec::decode_t<E, M>((uint32_t)k[off], rt_e, rt_m);
        vv = codec::decode_t<E, M>((uint32_t)v[off], rt_e, rt_m);
      }
      Ks[c * (DH + 1) + d] = kv;
      Vs[c * DH + d] = vv;
    }
    __syncthreads();

    {
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) { s[i][0] = 0.0f; s[i][1] = 0.0f; }
      for (int d = 0; d < DH; ++d) {
        const float k0 = Ks[tx * (DH + 1) + d];
        const float k1 = Ks[(tx + 16) * (DH + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = Qs[(ty * 4 + i) * (DH + 1) + d];
          s[i][0] = fmaf(qv, k0, s[i][0]);
          s[i][1] = fmaf(qv, k1, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int qi = q_offset + q0 + r / G;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          Ss[r * (kBKV + 1) + c] =
              allowed(qi, ki_min + c, Skv, window, prefix_len)
                  ? s[i][j] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    if (tid < kRows) {
      const int r = tid;
      const int qi = q_offset + q0 + r / G;
      float mx = kNegInf;
      for (int c = 0; c < kBKV; ++c) mx = fmaxf(mx, Ss[r * (kBKV + 1) + c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = 0; c < kBKV; ++c) {
        const float p = allowed(qi, ki_min + c, Skv, window, prefix_len)
                            ? expf(Ss[r * (kBKV + 1) + c] - m_new) : 0.0f;
        Ss[r * (kBKV + 1) + c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      a_s[r] = alpha;
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rgrp + i * kRowGroups;
      float pv = 0.0f;
#pragma unroll 8
      for (int c = 0; c < kBKV; ++c)
        pv = fmaf(Ss[r * (kBKV + 1) + c], Vs[c * DH + dcol], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rgrp + i * kRowGroups;
    const int qp = q0 + r / G, g = r % G;
    if (qp >= Sq) continue;
    const float l = l_s[r];
    out[((((size_t)b * Sq + qp) * H + h) * G + g) * DH + dcol] =
        l > 0.0f ? acc[i] / l : 0.0f;
  }
}

template <typename T, int E, int M, int DH>
cudaError_t launch_dh(const float* q, const void* k, const void* v,
                      float* out, int B, int Sq, int Skv, int H, int G,
                      float scale, int window, int prefix_len, int q_offset,
                      int rt_e, int rt_m, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (kRows * (DH + 1) + kBKV * (DH + 1) + kBKV * DH +
       kRows * (kBKV + 1) + 3 * kRows);
  auto kern = flash_prefill_kernel<T, E, M, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int bq = kRows / G;
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), out, Sq, Skv, H,
      G, scale, window, prefix_len, q_offset, rt_e, rt_m);
  return cudaGetLastError();
}

template <typename T, int E, int M>
cudaError_t launch_fmt(int dh, const float* q, const void* k, const void* v,
                       float* out, int B, int Sq, int Skv, int H, int G,
                       float scale, int window, int prefix_len, int q_offset,
                       int rt_e, int rt_m, cudaStream_t s) {
  switch (dh) {
    case 64: return launch_dh<T, E, M, 64>(q, k, v, out, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
    case 128: return launch_dh<T, E, M, 128>(q, k, v, out, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt_code as in qmm.cu.  window <= 0: no sliding window.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Skv, int H, int G, int dh,
                                    float scale, int window, int prefix_len,
                                    int q_offset, int fmt_code, int rt_e,
                                    int rt_m, void* stream) {
  const float* Q = static_cast<const float*>(q);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || kRows % G != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(dh, Q, k, v, O, B, Sq, Skv, H, G, scale, window, prefix_len, q_offset, rt_e, rt_m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
