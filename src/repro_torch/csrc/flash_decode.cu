// flash_decode.cu -- one-token GQA attention over a contiguous packed KV
// cache, hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, _decode_kernel (the Pallas
// body behind flash_decode()).  For every sequence b and KV head h the G
// query heads of the group attend over the first min(len[b], S) positions
// of K/V (B, S, H, dh), held as packed (e, m) containers (e5m2 u8 under
// the transprecision policy) or f32.  The reference's grid walks the cache
// in block_kv = 256 tiles carrying (m, l, acc) in VMEM scratch.
//
// What bounds it on an H100: bytes, at a scale where latency rules.  Each
// live K/V element is read once at container width (1 B for binary8) and
// feeds G = 4 multiply-adds, far below the ridge point; at the serving
// shape (B = 4, H = 8, 144 live positions) a call moves ~1.3 MB, 0.4 us
// at 3.35 TB/s.  One block per (sequence, KV head) walking its tiles in
// turn gave 32 blocks for 132 SMs and a serial chain of tile latencies.
//
// The design: a split KV walk and a merge.
//  * Fixed pieces.  Each row's walk is cut into pieces of kPiece = 64
//    positions; a row has ceil(len / 64) of them, a function of its own
//    length only.  The grid is (H, B, ceil(S / 64)); a block whose piece
//    starts at or past its row's length exits at once.  At the serve
//    shape that is 96 working blocks, each with one tile.
//  * A piece's K and V rows (the h-th dh-wide slice of each position)
//    come in by cp.async, 16 B a thread, as packed bytes into shared
//    memory, all in flight together; rows past the length are not read.
//  * Scores: the dh-wide row of K is dh * item / 16 chunks of 16 B; the
//    thread that owns a chunk decodes it (codec.cuh; e5m2 / bf16 / f16
//    through the hardware conversion, exact) and takes its G partial dot
//    products with q, and the chunks of one row meet by warp shuffles.
//  * The piece's softmax in f32, one warp per query head (max, exp, sum);
//    then P @ V with one thread per head_dim column (and per row slice
//    when dh < 128), each V element decoded once for all G heads.  The
//    block writes its normalized partial o = P @ V / l and (m, l).
//  * The merge, a second small launch with one block per (sequence, KV
//    head), reads the row's partials in piece order and combines them by
//    the reference's formula (repro/kernels/dispatch.py, _merge_partials):
//    w_i = exp(m_i - max m) * l_i, out = sum w_i o_i / sum w_i, with an
//    explicit zero guard.  The residuals keep their unsplit meaning: m is
//    the row's max score and l = sum w_i the softmax denominator under it.
//    Zero valid positions give a zero output and (m, l) = (NEG_INF, 0),
//    the reference's _finalize.
//  * A row's result depends on its own length and data only, not on B,
//    S or the other rows, so a speculative verify (the same kernel per
//    position) and a decode step give the same bits.
// Optional (m, l) outputs feed a later shard merge.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 64;           // KV positions a block walks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// The 16 / sizeof(T) containers of a 16 B chunk, widened.
template <typename T>
__device__ __forceinline__ void unpack16(const unsigned char* p,
                                         uint32_t out[16 / sizeof(T)]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * i + j] = (word[i] >> (8 * j)) & 0xffu;
    } else if constexpr (sizeof(T) == 2) {
      out[2 * i] = word[i] & 0xffffu;
      out[2 * i + 1] = word[i] >> 16;
    } else {
      out[i] = word[i];
    }
  }
}

// One piece of one (sequence, KV head): its normalized partial
// (o [G][dh], m [G], l [G]) into part_o / part_ml at [b][h][piece].
// dh is a power of two in 16..128 and dh * sizeof(T) in 16..512 (the
// wrapper checks), so a row is 1..32 chunks of 16 B and kThreads / dh
// threads share a head_dim column in P @ V.
template <typename T, int E, int M, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_piece(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int S, int H, int dh, float scale, int rt_e, int rt_m,
                   int aligned) {
  constexpr int kPer = 16 / sizeof(T);            // containers a chunk
  const int h = blockIdx.x, b = blockIdx.y, piece = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int base = piece * kPiece;
  if (base >= len) return;
  const int rows = min(kPiece, len - base);
  const int npieces = gridDim.z;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_bytes = dh * (int)sizeof(T);
  unsigned char* k_s = smem_raw;                          // [kPiece][row]
  unsigned char* v_s = k_s + kPiece * row_bytes;          // [kPiece][row]
  float* q_s = reinterpret_cast<float*>(v_s + kPiece * row_bytes);  // [G][dh]
  float* p_s = q_s + G * dh;                              // [G][kPiece]
  float* m_s = p_s + G * kPiece;                          // [G]
  float* l_s = m_s + G;                                   // [G]
  float* red = l_s + G;                 // [kThreads / dh - 1][G][dh]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t pos_stride = (size_t)H * dh;               // containers
  const size_t off0 = ((size_t)b * S + base) * pos_stride + (size_t)h * dh;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + off0);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + off0);
  const size_t pos_bytes = pos_stride * sizeof(T);

  // ---- K and V rows of the piece -> shared memory, 16 B a thread --------
  const int cpr = row_bytes / 16;                         // chunks a row
  for (int c = tid; c < rows * cpr; c += kThreads) {
    const int r = c / cpr, j = c % cpr;
    const size_t g_off = (size_t)r * pos_bytes + (size_t)j * 16;
    const int s_off = r * row_bytes + j * 16;
    if (aligned) {
      cp_async16(k_s + s_off, kg + g_off, true);
      cp_async16(v_s + s_off, vg + g_off, true);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        k_s[s_off + i] = kg[g_off + i];
        v_s[s_off + i] = vg[g_off + i];
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const size_t qbase = ((size_t)b * H + h) * G * dh;
  for (int i = tid; i < G * dh; i += kThreads) q_s[i] = q[qbase + i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- scores s[g][r] = (q[g] . k[r]) * scale ---------------------------
  // cpr consecutive lanes own one row (cpr divides 32); the trip count is
  // the same for every lane of a warp, so all take part in the shuffles
  for (int c0 = 0; c0 < rows * cpr; c0 += kThreads) {
    const int c = c0 + tid;
    const bool live = c < rows * cpr;
    const int r = c / cpr, j = c % cpr;
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = 0.0f;
    if (live) {
      uint32_t w[kPer];
      unpack16<T>(k_s + r * row_bytes + j * 16, w);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float kv = codec::decode_t<E, M>(w[e], rt_e, rt_m);
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] = fmaf(q_s[g * dh + j * kPer + e], kv, part[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = part[g];
      for (int o = 1; o < cpr; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (live && j == 0) p_s[g * kPiece + r] = s * scale;
    }
  }
  __syncthreads();

  // ---- the piece's softmax, one warp per query head ---------------------
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * kPiece + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int r = lane; r < rows; r += 32) {
      const float e = expf(p_s[g * kPiece + r] - mx);
      p_s[g * kPiece + r] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) { m_s[g] = mx; l_s[g] = sum; }
  }
  __syncthreads();

  // ---- P @ V: column d, rows rs, rs + nsplit, ... -------------------------
  const int nsplit = kThreads / dh;
  const int d = tid % dh, rs = tid / dh;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  for (int r = rs; r < rows; r += nsplit) {
    const T raw = *reinterpret_cast<const T*>(v_s + r * row_bytes +
                                              d * (int)sizeof(T));
    const float vv = codec::decode_t<E, M>((uint32_t)raw, rt_e, rt_m);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(p_s[g * kPiece + r], vv, acc[g]);
  }
  // the row slices meet in slice order
  if (rs > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[((rs - 1) * G + g) * dh + d] = acc[g];
  }
  __syncthreads();
  if (rs == 0) {
    const size_t part = ((size_t)b * H + h) * npieces + piece;
    for (int i = 1; i < nsplit; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += red[((i - 1) * G + g) * dh + d];
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      part_o[(part * G + g) * dh + d] = acc[g] / l_s[g];
    if (d < G) {
      part_ml[part * 2 * G + d] = m_s[d];
      part_ml[part * 2 * G + G + d] = l_s[d];
    }
  }
}

// The merge of one (sequence, KV head): the row's ceil(len / kPiece)
// partials in piece order, by the reference's _merge_partials formula.
__global__ void __launch_bounds__(kThreads)
flash_decode_merge(const float* __restrict__ part_o,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int S, int H, int G, int dh, int npieces) {
  __shared__ float gm_s[8];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), S);
  const int n = (len + kPiece - 1) / kPiece;
  const size_t part0 = ((size_t)b * H + h) * npieces;
  if (tid < G) {
    float gm = kNegInf;
    for (int i = 0; i < n; ++i)
      gm = fmaxf(gm, part_ml[(part0 + i) * 2 * G + tid]);
    gm_s[tid] = gm;
  }
  __syncthreads();
  const size_t obase = ((size_t)b * H + h) * G * dh;
  for (int o = tid; o < G * dh; o += kThreads) {
    const int g = o / dh;
    const float gm = gm_s[g];
    float num = 0.0f, den = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float* ml = part_ml + (part0 + i) * 2 * G;
      const float w = expf(ml[g] - gm) * ml[G + g];
      num += w * part_o[(part0 + i) * G * dh + o];
      den += w;
    }
    // explicit zero guard (a subnormal epsilon would be flushed)
    out[obase + o] = den > 0.0f ? num / den : 0.0f;
    if (m_out != nullptr && o % dh == 0) {
      m_out[((size_t)b * H + h) * G + g] = gm;
      l_out[((size_t)b * H + h) * G + g] = den;
    }
  }
}

template <typename T, int E, int M, int G>
cudaError_t launch_g(const float* q, const void* k, const void* v,
                     const int* lengths, float* out, float* m_out,
                     float* l_out, float* part_o, float* part_ml, int B,
                     int S, int H, int dh, float scale, int rt_e, int rt_m,
                     int aligned, cudaStream_t stream) {
  const int npieces = (S + kPiece - 1) / kPiece;
  const size_t smem = 2 * (size_t)kPiece * dh * sizeof(T) +
                      sizeof(float) * (G * dh + G * kPiece + 2 * G +
                                       (kThreads / dh - 1) * G * dh);
  auto kern = flash_decode_piece<T, E, M, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (npieces > 0) {
    kern<<<dim3(H, B, npieces), kThreads, smem, stream>>>(
        q, static_cast<const T*>(k), static_cast<const T*>(v), lengths,
        part_o, part_ml, S, H, dh, scale, rt_e, rt_m, aligned);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  flash_decode_merge<<<dim3(H, B), kThreads, 0, stream>>>(
      part_o, part_ml, lengths, out, m_out, l_out, S, H, G, dh, npieces);
  return cudaGetLastError();
}

template <typename T, int E, int M>
cudaError_t launch_fmt(int G, const float* q, const void* k, const void* v,
                       const int* lengths, float* out, float* m_out,
                       float* l_out, float* po, float* pml, int B, int S,
                       int H, int dh, float scale, int rt_e, int rt_m,
                       int aligned, cudaStream_t s) {
  switch (G) {
    case 1: return launch_g<T, E, M, 1>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, dh, scale, rt_e, rt_m, aligned, s);
    case 2: return launch_g<T, E, M, 2>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, dh, scale, rt_e, rt_m, aligned, s);
    case 4: return launch_g<T, E, M, 4>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, dh, scale, rt_e, rt_m, aligned, s);
    case 8: return launch_g<T, E, M, 8>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, dh, scale, rt_e, rt_m, aligned, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt_code as in qmm.cu: 0 f32 / binary32, 1 binary8, 2 binary8alt,
// 3 binary16, 4 binary16alt, 5/6/7 any other (rt_e, rt_m) in u8/u16/u32.
// m_out / l_out may be null.  part_o: B * H * ceil(S / 64) * G * dh
// floats and part_ml: B * H * ceil(S / 64) * 2 * G floats of scratch.
// G in (1, 2, 4, 8); dh a power of two in 16..128 with dh * container
// bytes in 16..512.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* m_out, void* l_out,
                                   void* part_o, void* part_ml, int B, int S,
                                   int H, int G, int dh, float scale,
                                   int fmt_code, int rt_e, int rt_m,
                                   void* stream) {
  const int item = fmt_code == 0 || fmt_code == 7 ? 4
                   : fmt_code == 3 || fmt_code == 4 || fmt_code == 6 ? 2 : 1;
  if (dh < 16 || dh > 128 || (dh & (dh - 1)) != 0 || dh * item < 16 ||
      part_o == nullptr || part_ml == nullptr)
    return (int)cudaErrorInvalidValue;
  const int aligned =
      (((uintptr_t)k | (uintptr_t)v) & 15u) == 0 &&
      ((size_t)H * dh * item) % 16 == 0;
  const float* Q = static_cast<const float*>(q);
  const int* L = static_cast<const int*>(lengths);
  float* O = static_cast<float*>(out);
  float* MO = static_cast<float*>(m_out);
  float* LO = static_cast<float*>(l_out);
  float* PO = static_cast<float*>(part_o);
  float* PML = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(G, Q, k, v, L, O, MO, LO, PO, PML, B, S, H, dh, scale, rt_e, rt_m, aligned, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
