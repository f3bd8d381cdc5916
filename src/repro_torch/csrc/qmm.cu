// qmm.cu -- transprecision matmul with a fused epilogue, hand-written for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/qmatmul.py, _qmm_kernel (the Pallas body behind
// qmatmul() and qmm_ffn()).  out = quantize?(act(a @ B + bias) * (a @ G))
// with a (M, K) f32 activations, B / G (K, N) packed weights in their
// (e, m) containers (u8 / u16 / u32, or f32), f32 products and f32
// accumulation.
//
// What bounds it on an H100: in the serving decode step M <= 4, so each
// weight element is used for at most 4 FMAs -- the kernel is bound by the
// bytes of the packed weight stream (15.0 GB of bf16 per llama3-8b step,
// 4.5 ms at 3.35 TB/s).  At prefill (M = 64) each weight is used 64
// times: about 1 TFLOP per chunk, bound by the f32 CUDA cores (67 TFLOP/s)
// because the f32 x f32 product contract rules out TF32 and bf16 mma.
//
// The simple design, and what it does about that.  Two kernels share the
// codec and the epilogue:
//  * qmm_gemv (M <= 8, the decode regime): a block owns a 64-column strip
//    for BM = 4 or 8 rows; 256 threads = 16 column-threads x 16
//    K-threads; a column-thread holds 4 adjacent columns, so a half-warp
//    reads a 64-column weight row as one vector load per thread (4 B for
//    u8, 8 B for u16, 16 B for u32/f32), coalesced.  Each thread issues 4
//    weight rows before its first FMA.  The 16 K-threads meet in a
//    fixed-order shared-memory reduction.  Narrow matrices give fewer
//    64-column strips than the card has SMs (wk/wv: 16), so the K range
//    is split across blocks (grid.z) until about two blocks per SM exist;
//    the partial sums then meet, in split order, in qmm_splitk (sums are
//    deterministic).
//  * qmm_tiled (M > 8, prefill; the five compile-time formats -- a
//    run-time (e, m) stays on qmm_gemv): 64 x 64 output tiles, K in steps of 32
//    through shared memory (the weight tile decoded once into f32 there),
//    4 x 4 outputs per thread in registers, so each weight is read once
//    per 64 rows of activations instead of once per 8.
//  * Weights are decoded in registers through codec.cuh (hardware
//    conversions for bf16 / f16 / e5m2, specialised at compile time).  The
//    gate weight G is streamed in the same K sweep (the gated FFN in one
//    launch); bias, nonlinearity, gate and output quantization run in the
//    epilogue.  Ragged M, K and N are masked in the kernel, with no
//    padding copies.
// Speed work still open: cp.async/TMA pipelines and a tensor-core path for
// M > 32 under a wider precision contract.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 16;          // column-threads per block
constexpr int kTK = 16;          // K-threads per block
constexpr int kVec = 4;          // columns per column-thread
constexpr int kBN = kTN * kVec;  // 64 columns per block
constexpr int kWarps = kThreads / 32;

enum Act { kNone = 0, kSilu = 1, kGelu = 2, kRelu2 = 3 };

template <typename TB>
__device__ __forceinline__ void load4(const TB* __restrict__ row, int n,
                                      int N, bool vec, uint32_t out[kVec]) {
  if (vec && n + kVec <= N) {
    if (sizeof(TB) == 1) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row + n));
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = (w >> (8 * j)) & 0xffu;
    } else if (sizeof(TB) == 2) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + n));
      out[0] = w.x & 0xffffu; out[1] = w.x >> 16;
      out[2] = w.y & 0xffffu; out[3] = w.y >> 16;
    } else {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + n));
      out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      out[j] = (n + j < N) ? (uint32_t)__ldg(row + n + j) : 0u;
  }
}

__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case kSilu: return x * (1.0f / (1.0f + expf(-x)));
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kRelu2: { const float r = x > 0.0f ? x : 0.0f; return r * r; }
    default: return x;
  }
}

// The fused epilogue, in the reference's order: + bias, act, * gate,
// quantize to (out_e, out_m) when out_e > 0.
struct Epilogue {
  const float* bias;
  int act, out_e, out_m;
  bool gated;

  __device__ __forceinline__ float operator()(float r, float gsum,
                                              int col) const {
    if (bias != nullptr) r += bias[col];
    r = apply_act(r, act);
    if (gated) r *= gsum;
    if (out_e > 0) r = codec::quantize_value(r, out_e, out_m, false);
    return r;
  }
};

// ---------------------------------------------------------------------------
// decode regime: weight-streaming GEMV, optional split-K
// ---------------------------------------------------------------------------

template <typename TB, int E, int M, int BM>
__global__ void __launch_bounds__(kThreads, BM <= 4 ? 2 : 1)
qmm_gemv(const float* __restrict__ a, const TB* __restrict__ b,
         const TB* __restrict__ g, float* __restrict__ out,
         float* __restrict__ ws, Epilogue ep, int Mrows, int K, int N,
         int k_chunk, int rt_e, int rt_m, int vec) {
  __shared__ float red[kWarps][BM][kBN];
  const int tid = threadIdx.x;
  const int tn = tid % kTN, tk = tid / kTN;
  const int n = blockIdx.x * kBN + tn * kVec;
  const int m0 = blockIdx.y * BM;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  const bool gated = g != nullptr;

  const float* arow[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int r = m0 + i < Mrows ? m0 + i : Mrows - 1;  // masked at store
    arow[i] = a + (size_t)r * K;
  }

  float acc[BM][kVec], gac[BM][kVec];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) { acc[i][j] = 0.0f; gac[i][j] = 0.0f; }

  // kU weight rows per thread per trip, all issued before the first FMA;
  // at BM = 4 the register budget leaves room for two blocks per SM.
  constexpr int kU = 4;
  int k = k_lo + tk;
  for (; k + (kU - 1) * kTK < k_hi; k += kU * kTK) {
    uint32_t wb[kU][kVec], gb[kU][kVec];
    float av[kU][BM];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      load4<TB>(b + (size_t)(k + u * kTK) * N, n, N, vec, wb[u]);
      if (gated) load4<TB>(g + (size_t)(k + u * kTK) * N, n, N, vec, gb[u]);
#pragma unroll
      for (int i = 0; i < BM; ++i) av[u][i] = __ldg(arow[i] + k + u * kTK);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float w = codec::decode_t<E, M>(wb[u][j], rt_e, rt_m);
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i][j] = fmaf(av[u][i], w, acc[i][j]);
      }
      if (gated) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float w = codec::decode_t<E, M>(gb[u][j], rt_e, rt_m);
#pragma unroll
          for (int i = 0; i < BM; ++i)
            gac[i][j] = fmaf(av[u][i], w, gac[i][j]);
        }
      }
    }
  }
  for (; k < k_hi; k += kTK) {
    uint32_t wb[kVec];
    load4<TB>(b + (size_t)k * N, n, N, vec, wb);
    float av[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) av[i] = __ldg(arow[i] + k);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float w = codec::decode_t<E, M>(wb[j], rt_e, rt_m);
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i][j] = fmaf(av[i], w, acc[i][j]);
    }
    if (gated) {
      load4<TB>(g + (size_t)k * N, n, N, vec, wb);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float w = codec::decode_t<E, M>(wb[j], rt_e, rt_m);
#pragma unroll
        for (int i = 0; i < BM; ++i) gac[i][j] = fmaf(av[i], w, gac[i][j]);
      }
    }
  }

  // K-thread reduction: the two K-threads of a warp by shuffle, then the
  // eight warps through shared memory in a fixed order.  Each thread then
  // owns kSlots outputs o = tid + s * kThreads of the BM x kBN tile.
  constexpr int kSlots = (BM * kBN + kThreads - 1) / kThreads;
  const int warp = tid / 32, lane = tid % 32;
  float tot[kSlots], gtot[kSlots];
  for (int pass = 0; pass < (gated ? 2 : 1); ++pass) {
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = pass == 0 ? acc[i][j] : gac[i][j];
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 16) red[warp][i][tn * kVec + j] = v;
      }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int o = tid + s * kThreads;
      float sum = 0.0f;
      if (o < BM * kBN) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w][o / kBN][o % kBN];
      }
      if (pass == 0) tot[s] = sum; else gtot[s] = sum;
    }
    __syncthreads();
  }

  const size_t plane = (size_t)Mrows * N;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int o = tid + s * kThreads;
    const int row = m0 + o / kBN, col = blockIdx.x * kBN + o % kBN;
    if (o >= BM * kBN || row >= Mrows || col >= N) continue;
    const size_t idx = (size_t)row * N + col;
    if (gridDim.z == 1) {
      out[idx] = ep(tot[s], gated ? gtot[s] : 0.0f, col);
    } else {  // split-K partials: [split][row][col], gate after all splits
      ws[blockIdx.z * plane + idx] = tot[s];
      if (gated) ws[(gridDim.z + blockIdx.z) * plane + idx] = gtot[s];
    }
  }
}

// Sum the split-K partials in split order, then the epilogue.
__global__ void qmm_splitk(const float* __restrict__ ws,
                           float* __restrict__ out, Epilogue ep, int Mrows,
                           int N, int splits) {
  const size_t plane = (size_t)Mrows * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < plane; idx += (size_t)gridDim.x * blockDim.x) {
    float r = 0.0f, gs = 0.0f;
    for (int z = 0; z < splits; ++z) r += ws[z * plane + idx];
    if (ep.gated)
      for (int z = 0; z < splits; ++z) gs += ws[(splits + z) * plane + idx];
    out[idx] = ep(r, gs, (int)(idx % N));
  }
}

// ---------------------------------------------------------------------------
// prefill regime: shared-memory tiles, each weight read once per 64 rows
// ---------------------------------------------------------------------------

constexpr int kTM = 64, kTNT = 64, kTKT = 32;   // tile M, N, K

template <typename TB, int E, int M>
__global__ void __launch_bounds__(kThreads)
qmm_tiled(const float* __restrict__ a, const TB* __restrict__ b,
          const TB* __restrict__ g, float* __restrict__ out, Epilogue ep,
          int Mrows, int K, int N, int rt_e, int rt_m) {
  __shared__ float As[kTKT][kTM + 4];     // A tile, transposed: [k][m]
  __shared__ float Bs[kTKT][kTNT];        // decoded weight tile
  __shared__ float Gs[kTKT][kTNT];        // decoded gate tile
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // 4 x 4 outputs per thread
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTNT;
  const bool gated = g != nullptr;

  float acc[4][4], gac[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc[i][j] = 0.0f; gac[i][j] = 0.0f; }

  for (int k0 = 0; k0 < K; k0 += kTKT) {
    for (int e = tid; e < kTM * kTKT; e += kThreads) {
      const int r = e / kTKT, c = e % kTKT;
      const int row = m0 + r, kk = k0 + c;
      As[c][r] = (row < Mrows && kk < K) ? a[(size_t)row * K + kk] : 0.0f;
    }
    for (int e = tid; e < kTKT * kTNT; e += kThreads) {
      const int r = e / kTNT, c = e % kTNT;
      const int kk = k0 + r, col = n0 + c;
      const bool in = kk < K && col < N;
      const size_t off = (size_t)kk * N + col;
      Bs[r][c] = in ? codec::decode_t<E, M>((uint32_t)b[off], rt_e, rt_m)
                    : 0.0f;
      if (gated)
        Gs[r][c] = in ? codec::decode_t<E, M>((uint32_t)g[off], rt_e, rt_m)
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTKT; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (gated) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Gs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            gac[i][j] = fmaf(av[i], bv[j], gac[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < Mrows && col < N)
        out[(size_t)row * N + col] = ep(acc[i][j], gac[i][j], col);
    }
}

template <typename TB, int E, int M>
cudaError_t launch_fmt(const float* a, const void* b, const void* g,
                       float* out, float* ws, Epilogue ep, int Mrows, int K,
                       int N, int splits, int rt_e, int rt_m, int vec,
                       cudaStream_t stream) {
  const TB* B = static_cast<const TB*>(b);
  const TB* G = static_cast<const TB*>(g);
  const int nb = (N + kBN - 1) / kBN;
  // the tiled kernel is built for the compile-time formats only (E >= 0);
  // a run-time (e, m) takes the GEMV kernel at any M
  if constexpr (E >= 0) {
    if (Mrows > 8) {
      const dim3 grid((N + kTNT - 1) / kTNT, (Mrows + kTM - 1) / kTM);
      qmm_tiled<TB, E, M><<<grid, kThreads, 0, stream>>>(
          a, B, G, out, ep, Mrows, K, N, rt_e, rt_m);
      return cudaGetLastError();
    }
  }
  const int k_chunk = (K + splits - 1) / splits;
  if (Mrows <= 4) {
    qmm_gemv<TB, E, M, 4><<<dim3(nb, 1, splits), kThreads, 0, stream>>>(
        a, B, G, out, ws, ep, Mrows, K, N, k_chunk, rt_e, rt_m, vec);
  } else {
    qmm_gemv<TB, E, M, 8><<<dim3(nb, (Mrows + 7) / 8, splits), kThreads, 0,
                            stream>>>(a, B, G, out, ws, ep, Mrows, K, N,
                                      k_chunk, rt_e, rt_m, vec);
  }
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int plane = Mrows * N;
    const int blocks = (plane + 255) / 256 < 1024 ? (plane + 255) / 256 : 1024;
    qmm_splitk<<<blocks, 256, 0, stream>>>(ws, out, ep, Mrows, N, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// fmt_code: 0 f32 / binary32 (u32 bits), 1 binary8 (5,2) u8,
// 2 binary8alt (4,3) u8, 3 binary16 (5,10) u16, 4 binary16alt (8,7) u16,
// 5 any other (rt_e, rt_m) in u8, 6 in u16, 7 in u32.
// out_e == 0: no output quantization.  splits > 1 (M <= 8 only) needs
// ws: (gated ? 2 : 1) * splits * M * N floats.
extern "C" int qmm_launch(const void* a, const void* b, const void* g,
                          const void* bias, void* out, void* ws, int M,
                          int K, int N, int splits, int fmt_code, int rt_e,
                          int rt_m, int act, int out_e, int out_m, int vec,
                          void* stream) {
  const float* A = static_cast<const float*>(a);
  float* O = static_cast<float*>(out);
  float* W = static_cast<float*>(ws);
  const Epilogue ep{static_cast<const float*>(bias), act, out_e, out_m,
                    g != nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && (M > 8 || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(A, b, g, O, W, ep, M, K, N, splits, rt_e, rt_m, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
