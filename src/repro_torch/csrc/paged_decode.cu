// paged_decode.cu -- one-token GQA attention over a paged, packed KV pool,
// hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_attention.py, _paged_decode_kernel (the
// Pallas body behind paged_decode()).  For every sequence b and KV head h
// the G query heads of the group attend over the sequence's pages, found
// through its row of the block table; pages hold packed (e, m) containers
// (e5m2 u8 under the transprecision policy) or f32.
//
// What bounds it on an H100: bytes.  Each mapped, live page of K and V is
// read once (container width: 1 B per element for binary8) and every
// element feeds G = 4 multiply-adds per operand, far below the ridge
// point; the batch of 4 sequences x 8 KV heads also gives only 32 blocks,
// so at serving sizes launch latency dominates.
//
// The simple design, and what it does about that:
//  * One block per (sequence, KV head) computes all G query rows, so each
//    K/V byte is read from device memory once per step, not G times.
//  * The block reads its own row of the block table and walks the pages
//    in a loop (the reference's scalar-prefetch index map).  Pages past the
//    sequence length or unmapped (table entry < 0) are skipped: in the
//    reference they are fetched as page 0 and fully masked, which leaves
//    (m, l, acc) bit-unchanged, so skipping is exact.
//  * Scores: one warp per K row, lanes across head_dim (coalesced row
//    reads), decoded in registers through codec.cuh, G dot products per
//    row reduced by warp shuffles.
//  * Online softmax in f32 with the reference's NEG_INF = -1e30 sentinel,
//    then P @ V with one thread per head_dim column (coalesced V rows).
//    Zero valid tokens give a zero output (the reference's _finalize).
// Optional (m, l) outputs feed a later shard merge.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename T, int E, int M, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int H, int dh, int page, int n_pages, float scale,
                    int rt_e, int rt_m) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [G][dh]
  float* acc_s = q_s + G * dh;       // [G][dh]
  float* p_s = acc_s + G * dh;       // [G][page]
  float* m_s = p_s + G * page;       // [G]
  float* l_s = m_s + G;              // [G]
  float* a_s = l_s + G;              // [G]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qbase = ((size_t)b * H + h) * G * dh;
  const int len = min(lengths[b], n_pages * page);

  for (int i = tid; i < G * dh; i += kThreads) {
    q_s[i] = q[qbase + i];
    acc_s[i] = 0.0f;
  }
  if (tid < G) { m_s[tid] = kNegInf; l_s[tid] = 0.0f; }
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int base = p * page;
    if (base >= len) break;               // every later position is masked
    const int phys = tables[(size_t)b * n_pages + p];
    if (phys < 0) continue;               // unmapped: fully masked page
    const int rows = min(page, len - base);

    // ---- scores s[g][r] = (q[g] . k[r]) * scale ---------------------------
    for (int r = warp; r < rows; r += kWarps) {
      const T* krow = kpool + (((size_t)phys * page + r) * H + h) * dh;
      float kd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        kd[i] = d < dh ? codec::decode_t<E, M>((uint32_t)krow[d], rt_e, rt_m) : 0.0f;
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
        if (lane == 0) p_s[g * page + r] = s * scale;
      }
    }
    __syncthreads();

    // ---- online softmax update, one warp per query head -------------------
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * page + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(p_s[g * page + r] - m_new);
        p_s[g * page + r] = e;
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
        const float v = codec::decode_t<E, M>(
            (uint32_t)vpool[(((size_t)phys * page + r) * H + h) * dh + d],
            rt_e, rt_m);
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g] = fmaf(p_s[g * page + r], v, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc_s[g * dh + d] = acc_s[g * dh + d] * a_s[g] + pv[g];
    }
    __syncthreads();
  }

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
cudaError_t launch_g(const float* q, const void* kp, const void* vp,
                     const int* lengths, const int* tables, float* out,
                     float* m_out, float* l_out, int B, int H, int dh,
                     int page, int n_pages, float scale, int rt_e, int rt_m,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * G * dh + G * page + 3 * G);
  auto kern = paged_decode_kernel<T, E, M, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), lengths,
      tables, out, m_out, l_out, H, dh, page, n_pages, scale, rt_e, rt_m);
  return cudaGetLastError();
}

template <typename T, int E, int M>
cudaError_t launch_fmt(int G, const float* q, const void* kp, const void* vp,
                       const int* lengths, const int* tables, float* out,
                       float* m_out, float* l_out, int B, int H, int dh,
                       int page, int n_pages, float scale, int rt_e, int rt_m,
                       cudaStream_t s) {
  switch (G) {
    case 1: return launch_g<T, E, M, 1>(q, kp, vp, lengths, tables, out, m_out, l_out, B, H, dh, page, n_pages, scale, rt_e, rt_m, s);
    case 2: return launch_g<T, E, M, 2>(q, kp, vp, lengths, tables, out, m_out, l_out, B, H, dh, page, n_pages, scale, rt_e, rt_m, s);
    case 4: return launch_g<T, E, M, 4>(q, kp, vp, lengths, tables, out, m_out, l_out, B, H, dh, page, n_pages, scale, rt_e, rt_m, s);
    case 8: return launch_g<T, E, M, 8>(q, kp, vp, lengths, tables, out, m_out, l_out, B, H, dh, page, n_pages, scale, rt_e, rt_m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt_code as in qmm.cu: 0 f32 / binary32, 1 binary8, 2 binary8alt,
// 3 binary16, 4 binary16alt, 5/6/7 any other (rt_e, rt_m) in u8/u16/u32.
// m_out / l_out may be null.
extern "C" int paged_decode_launch(const void* q, const void* kpool,
                                   const void* vpool, const void* lengths,
                                   const void* tables, void* out, void* m_out,
                                   void* l_out, int B, int H, int G, int dh,
                                   int page, int n_pages, float scale,
                                   int fmt_code, int rt_e, int rt_m,
                                   void* stream) {
  const float* Q = static_cast<const float*>(q);
  const int* L = static_cast<const int*>(lengths);
  const int* TB = static_cast<const int*>(tables);
  float* O = static_cast<float*>(out);
  float* MO = static_cast<float*>(m_out);
  float* LO = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(G, Q, kpool, vpool, L, TB, O, MO, LO, B, H, dh, page, n_pages, scale, rt_e, rt_m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
