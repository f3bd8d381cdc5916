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
// What bounds it on an H100: at the serving shape (one 64-token chunk of
// 8 KV heads x 4 query heads against a few hundred cached tokens) the work
// is ~0.1 GFLOP and ~0.3 MB a layer: 1.5 us of f32 operations, less of
// bytes.  What holds it is latency: too few blocks for 132 SMs, barriers,
// and serial loops.  Tensor cores would not help: the work is tiny, and
// the contract (1e-6 absolute, tests/test_conformance.py) keeps the
// products in f32 on CUDA cores.
//
// The design, for parallelism and latency:
//  * One block per 16 (query position, group head) rows -- the rows of
//    q flattened over (position, G) -- per KV head and batch row: 16 x 8
//    = 128 blocks at the serve shape (Sq = 64, G = 4, H = 8).  Each K/V
//    tile is decoded once for all the block's rows; G may be any size
//    (a position's heads may span two blocks).
//  * Four warps, each owning 4 rows.  Scores put the 32 lanes across the
//    32 keys of a tile (q rows read from shared memory as broadcasts, K
//    rows as conflict-free float4s); the row max and sum are warp
//    shuffles; for P.V the lanes go across head_dim and each key's
//    probability comes by shuffle.  The softmax and P.V never leave the
//    warp, and the accumulator stays in registers.
//  * K/V tiles of 32 keys come in 16 B a thread by cp.async into a
//    two-stage ring of packed bytes, so tile t + 1 loads while tile t
//    computes.  The thread that copied a chunk decodes it through
//    codec.cuh (hardware conversions for e5m2, bf16 and f16) into one of
//    two f32 tiles, so one barrier per tile is all the block needs.
//  * Tiles that are surely fully masked (strictly future tiles, tiles
//    left of the window, unless inside the prefix) are skipped by the
//    rule at flash_attention.py:268-279; a skipped tile would leave
//    (m, l, acc) bit-unchanged, so skipping is exact.
//  * Masks come from indices in registers; scores, the online softmax
//    (reference sentinel NEG_INF = -1e30, exact-zero masking) and the
//    accumulator are f32; a row with l = 0 is written as zeros.
//  * Every G from 1 up (the rows are flattened over (position, G)) and
//    every head_dim dh that is a multiple of 8 up to 256: the kernel is
//    instantiated for a padded width DH of 32, 64, 128 or 256 and zero-
//    fills q, K and V past dh in shared memory (zeros add nothing to a
//    score, and the padded columns are not written).  head_dim 64 and 128
//    (kExact) run with dh fixed at compile time, as before the widening.  A row of dh packed
//    containers that is not a multiple of 16 bytes (u8 with dh = 8, 24,
//    ...) comes in as 8 B copies.  At DH = 256 an f32 ring of two stages
//    does not fit beside the decoded tiles, so f32 containers take one
//    stage there (tile t + 1 still loads while tile t computes).

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // flattened q rows a block
constexpr int kBKV = 32;                       // keys a tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool allowed(int qi, int ki, int Skv, int window,
                                        int prefix_len) {
  bool ok = ki <= qi;
  if (window > 0) ok = ok && (ki > qi - window);
  if (prefix_len > 0) ok = ok || (ki < prefix_len);
  return ok && ki < Skv;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 8 : 0));
}

// stages of the packed ring (one where two would not fit)
template <typename T, int DH>
__host__ __device__ constexpr int raw_stages() {
  return sizeof(T) == 4 && DH == 256 ? 1 : 2;
}

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * DH + 2 * kBKV * (DH + 4) + 2 * kBKV * DH) +
         raw_stages<T, DH>() * 2 * kBKV * DH * sizeof(T);
}

// kCols consecutive floats of shared memory
template <int kCols>
__device__ __forceinline__ void load_cols(const float* p, float v[kCols]) {
  if constexpr (kCols == 1) {
    v[0] = p[0];
  } else if constexpr (kCols == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < kCols; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  }
}

template <typename T, int E, int M, int DH, bool kExact>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     int Sq, int Skv, int H, int G, int dh, float scale,
                     int window, int prefix_len, int q_offset, int rt_e,
                     int rt_m, int vec) {
  constexpr int kKS = DH + 4;                  // f32 K row stride
  constexpr int kCols = DH / 32;               // P.V columns a lane
  constexpr int kRawRow = DH * sizeof(T);      // bytes of one key's padded row
  constexpr int kRawTile = kBKV * kRawRow;     // bytes of a K (or V) tile
  constexpr int kChunks = kRawTile / 16;
  constexpr int kPer = 16 / sizeof(T);         // elements a chunk
  constexpr int kRS = raw_stages<T, DH>();
  if (kExact) dh = DH;
  const int row_bytes = dh * (int)sizeof(T);   // bytes of one key's row
  const bool half = row_bytes % 16 != 0;       // copied as 8 B halves
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRows][DH]
  float* Ks = Qs + kRows * DH;                 // [2][kBKV][kKS]
  float* Vs = Ks + 2 * kBKV * kKS;             // [2][kBKV][DH]
  unsigned char* raw =                         // [kRS stages][K, V][kRawTile]
      reinterpret_cast<unsigned char*>(Vs + 2 * kBKV * DH);

  const int rows = Sq * G;
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int fr = r0 + i / DH, d = i % DH;
    const int qp = fr / G, g = fr % G;
    Qs[i] = fr < rows && d < dh
                ? q[((((size_t)b * Sq + qp) * H + h) * G + g) * dh + d]
                : 0.0f;
  }

  const int qi_min = q_offset + r0 / G;
  const int qi_max = q_offset + (min(r0 + kRows, rows) - 1) / G;
  const int n_tiles = (Skv + kBKV - 1) / kBKV;
  auto next_live = [&](int t) {
    for (; t < n_tiles; ++t) {
      const int ki_min = t * kBKV, ki_max = ki_min + kBKV - 1;
      bool live = ki_min <= qi_max;
      if (window > 0) live = live && (ki_max > qi_min - window);
      if (prefix_len > 0) live = live || (ki_min < prefix_len);
      if (live) break;
    }
    return min(t, n_tiles);
  };

  // this thread's chunks of tile t -> ring stage st (zero past Skv and
  // past dh)
  auto load = [&](int t, int st) {
    if (t >= n_tiles) return;
    unsigned char* rk = raw + st * 2 * kRawTile;
    unsigned char* rv = rk + kRawTile;
    for (int c = tid; c < kChunks; c += kThreads) {
      const int kp = t * kBKV + c / (kRawRow / 16);
      const int e0 = (c % (kRawRow / 16)) * kPer;
      const bool in = kp < Skv && e0 < dh;
      const size_t off = (((size_t)b * Skv + kp) * H + h) * dh + e0;
      if (vec && !half) {
        cp_async16(rk + 16 * c, in ? k + off : k, in);
        cp_async16(rv + 16 * c, in ? v + off : v, in);
      } else if (vec) {
        const bool hi = in && e0 + kPer / 2 < dh;
        cp_async8(rk + 16 * c, in ? k + off : k, in);
        cp_async8(rv + 16 * c, in ? v + off : v, in);
        cp_async8(rk + 16 * c + 8, hi ? k + off + kPer / 2 : k, hi);
        cp_async8(rv + 16 * c + 8, hi ? v + off + kPer / 2 : v, hi);
      } else {
        T* dk = reinterpret_cast<T*>(rk + 16 * c);
        T* dv = reinterpret_cast<T*>(rv + 16 * c);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool ej = kp < Skv && e0 + j < dh;
          dk[j] = ej ? k[off + j] : T(0);
          dv[j] = ej ? v[off + j] : T(0);
        }
      }
    }
  };

  // the chunks this thread copied into stage st -> f32 tile f
  auto decode = [&](int st, int f) {
    const unsigned char* rk = raw + st * 2 * kRawTile;
    const unsigned char* rv = rk + kRawTile;
    float* ks = Ks + f * kBKV * kKS;
    float* vs = Vs + f * kBKV * DH;
    for (int c = tid; c < kChunks; c += kThreads) {
      const int key = c / (kRawRow / 16);
      const int e0 = (c % (kRawRow / 16)) * kPer;
      const T* sk = reinterpret_cast<const T*>(rk + 16 * c);
      const T* sv = reinterpret_cast<const T*>(rv + 16 * c);
#pragma unroll
      for (int j = 0; j < kPer; j += 4) {
        float4 kv4, vv4;
        kv4.x = codec::decode_t<E, M>((uint32_t)sk[j], rt_e, rt_m);
        kv4.y = codec::decode_t<E, M>((uint32_t)sk[j + 1], rt_e, rt_m);
        kv4.z = codec::decode_t<E, M>((uint32_t)sk[j + 2], rt_e, rt_m);
        kv4.w = codec::decode_t<E, M>((uint32_t)sk[j + 3], rt_e, rt_m);
        vv4.x = codec::decode_t<E, M>((uint32_t)sv[j], rt_e, rt_m);
        vv4.y = codec::decode_t<E, M>((uint32_t)sv[j + 1], rt_e, rt_m);
        vv4.z = codec::decode_t<E, M>((uint32_t)sv[j + 2], rt_e, rt_m);
        vv4.w = codec::decode_t<E, M>((uint32_t)sv[j + 3], rt_e, rt_m);
        *reinterpret_cast<float4*>(ks + key * kKS + e0 + j) = kv4;
        *reinterpret_cast<float4*>(vs + key * DH + e0 + j) = vv4;
      }
    }
  };

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int qi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    qi[i] = q_offset + (r0 + warp * kRowsPerWarp + i) / G;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // raw stage st holds tile ta (and with two stages stage st ^ 1 tile tb);
  // f32 tile f = it & 1 holds the tile being computed
  int ta = next_live(0);
  int tb = next_live(ta + 1);
  load(ta, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if constexpr (kRS == 2) {
    load(tb, 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; ta < n_tiles; ++it) {
    const int f = it & 1;
    const int st = kRS == 2 ? f : 0;
    if constexpr (kRS == 2) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    decode(st, f);
    __syncthreads();          // tile ta decoded; the previous one consumed
    const int tc = next_live(tb + 1);
    // stage st's bytes were this thread's own
    if constexpr (kRS == 2) {
      load(tc, st);
    } else {
      load(tb, st);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* ks = Ks + f * kBKV * kKS;
    const float* vs = Vs + f * kBKV * DH;
    const int ki = ta * kBKV + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const float* krow = ks + lane * kKS;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + (warp * kRowsPerWarp + i) * DH + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    float p[kRowsPerWarp], alpha[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool ok = allowed(qi[i], ki, Skv, window, prefix_len);
      const float sv = ok ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sv));
      p[i] = ok ? expf(sv - m_new) : 0.0f;
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + warp_sum(p[i]);
      m[i] = m_new;
    }
    float pv[kRowsPerWarp][kCols];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kBKV; ++c) {
      float vv[kCols];
      load_cols<kCols>(vs + c * DH + lane * kCols, vv);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pc = __shfl_sync(0xffffffffu, p[i], c);
#pragma unroll
        for (int j = 0; j < kCols; ++j) pv[i][j] = fmaf(pc, vv[j], pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
    ta = tb;
    tb = tc;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int fr = r0 + warp * kRowsPerWarp + i;
    if (fr >= rows) continue;
    const int qp = fr / G, g = fr % G;
    float* o = out + ((((size_t)b * Sq + qp) * H + h) * G + g) * dh +
               lane * kCols;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (lane * kCols + j < dh) o[j] = l[i] > 0.0f ? acc[i][j] / l[i] : 0.0f;
  }
}

template <typename T, int E, int M, int DH, bool kExact>
cudaError_t launch_dh(const float* q, const void* k, const void* v,
                      float* out, int B, int Sq, int Skv, int H, int G,
                      int dh, float scale, int window, int prefix_len,
                      int q_offset, int rt_e, int rt_m, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>();
  auto kern = flash_prefill_kernel<T, E, M, DH, kExact>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const uintptr_t mask = (dh * sizeof(T)) % 16 ? 7u : 15u;
  const int vec = (((uintptr_t)k | (uintptr_t)v) & mask) == 0;
  const dim3 grid((Sq * G + kRows - 1) / kRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), out, Sq, Skv, H,
      G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, vec);
  return cudaGetLastError();
}

template <typename T, int E, int M>
cudaError_t launch_fmt(int dh, const float* q, const void* k, const void* v,
                       float* out, int B, int Sq, int Skv, int H, int G,
                       float scale, int window, int prefix_len, int q_offset,
                       int rt_e, int rt_m, cudaStream_t s) {
  if (dh < 8 || dh > 256 || dh % 8 != 0) return cudaErrorInvalidValue;
  if constexpr (E >= 0) {
    if (dh == 128) return launch_dh<T, E, M, 128, true>(q, k, v, out, B, Sq, Skv, H, G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
    if (dh == 64) return launch_dh<T, E, M, 64, true>(q, k, v, out, B, Sq, Skv, H, G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
  }
  if (dh <= 32) return launch_dh<T, E, M, 32, false>(q, k, v, out, B, Sq, Skv, H, G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
  if (dh <= 64) return launch_dh<T, E, M, 64, false>(q, k, v, out, B, Sq, Skv, H, G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
  if (dh <= 128) return launch_dh<T, E, M, 128, false>(q, k, v, out, B, Sq, Skv, H, G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
  return launch_dh<T, E, M, 256, false>(q, k, v, out, B, Sq, Skv, H, G, dh, scale, window, prefix_len, q_offset, rt_e, rt_m, s);
}

}  // namespace

// fmt_code as in qmm.cu.  window <= 0: no sliding window.  G >= 1; dh a
// multiple of 8 in 8..256.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Skv, int H, int G, int dh,
                                    float scale, int window, int prefix_len,
                                    int q_offset, int fmt_code, int rt_e,
                                    int rt_m, void* stream) {
  const float* Q = static_cast<const float*>(q);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0) return (int)cudaErrorInvalidValue;
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
