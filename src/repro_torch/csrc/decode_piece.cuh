// decode_piece.cuh -- the split KV walk shared by the two one-token decode
// kernels: flash_decode.cu (a contiguous cache) and paged_decode.cu (a page
// pool read through block tables).
//
// A decode kernel cuts each row's walk into fixed pieces and runs one block
// per (KV head, sequence, piece).  The block calls attend() with the
// piece's K and V rows, found by an offset function of the position inside
// the piece, and writes the piece's normalized partial (o, m, l).  A
// second launch, merge(), combines a row's partials in piece order by the
// reference's formula (repro/kernels/dispatch.py, _merge_partials).  Only
// where the rows come from differs between the two kernels.
//
// The shapes taken: any G from 1 to kMaxGroup and any head_dim dh that is
// a multiple of 8 from 8 to 256, in every container (f32, u16, u8).
//  * G: the query heads of a group live in registers, so G is padded to a
//    compile-time group tile GT of 4, 8 or 16 (group_tile()); the padded
//    heads carry zero queries and are never written.
//  * dh: a K or V row of dh containers is kept in shared memory padded to
//    a multiple of 16 bytes (zero-filled), so the scores always read whole
//    16 B chunks.  Rows whose width is not a multiple of 16 bytes (u8 with
//    dh = 8, 24, ...) come in as 8 B copies, the rest as 16 B copies.
//    P @ V gives each thread one head_dim column; dh < 128 leaves
//    128 / dh row slices that meet in slice order, dh > 128 loops over
//    128-column passes.
//  * The head_dims most configs use (64 and 128) also have instantiations
//    with dh a compile-time constant (DHC), whose loops and index math
//    fold away: the generality costs the serving shape no time.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "codec.cuh"

namespace piece {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;   // the reference's finite sentinel

// the compile-time group tile G is padded to
__host__ __device__ inline int group_tile(int G) {
  return G <= 4 ? 4 : G <= 8 ? 8 : 16;
}

// the shapes the kernels take (the wrappers check the same in Python)
__host__ __device__ inline bool shape_ok(int G, int dh) {
  return G >= 1 && G <= kMaxGroup && dh >= 8 && dh <= kMaxHeadDim &&
         dh % 8 == 0;
}

// bytes of one padded K or V row in shared memory
__host__ __device__ constexpr int row_stride(int dh, int item) {
  return (dh * item + 15) & ~15;
}

// lanes that share a row of cpr 16 B chunks in the scores: the least
// power of two >= cpr, at most a warp
__host__ __device__ constexpr int lanes_per_row(int cpr) {
  return cpr <= 1 ? 1 : cpr <= 2 ? 2 : cpr <= 4 ? 4 : cpr <= 8 ? 8
       : cpr <= 16 ? 16 : 32;
}

// dynamic shared memory of one piece block of plen positions
__host__ __device__ inline size_t smem_bytes(int plen, int dh, int item,
                                             int gt) {
  const int rs = row_stride(dh, item);
  const int ncol = dh < kThreads ? dh : kThreads;
  const int nsplit = kThreads / ncol;
  return 2 * (size_t)plen * rs +
         sizeof(float) * ((size_t)gt * (rs / item) + (size_t)gt * plen +
                          2 * gt + (size_t)(nsplit - 1) * gt * dh);
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

// One piece of one (sequence, KV head): `rows` positions (at most plen)
// whose K and V rows start off(r) bytes past kbase and vbase (off(r) < 0:
// an unmapped position, masked).  q: the group's G x dh queries; DHC > 0
// fixes dh = DHC at compile time (dh_arg is then DHC too).  Writes
// the normalized partial o [G][dh] to po and (m [G], l [G]) to pml; a
// piece with no valid position gives o = 0, m = NEG_INF, l = 0.
// `aligned`: kbase, vbase and every row 16 B aligned (8 B where a row is
// not a multiple of 16 bytes); else the rows are copied byte by byte.
template <typename T, int E, int M, int GT, int DHC, typename Off>
__device__ __forceinline__ void attend(
    const unsigned char* __restrict__ kbase,
    const unsigned char* __restrict__ vbase, Off off, int rows, int plen,
    const float* __restrict__ q, int G, int dh_arg, float scale, int rt_e,
    int rt_m, int aligned, float* __restrict__ po, float* __restrict__ pml) {
  constexpr int kItem = sizeof(T);
  constexpr int kPer = 16 / kItem;               // containers a chunk
  const int dh = DHC > 0 ? DHC : dh_arg;
  const int row_bytes = dh * kItem;
  const int rs = row_stride(dh, kItem);
  const int dq = rs / kItem;                     // padded q row
  const int cpr = rs / 16;                       // chunks a row
  const bool half = row_bytes != rs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw;                         // [plen][rs]
  unsigned char* v_s = k_s + (size_t)plen * rs;          // [plen][rs]
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)plen * rs);  // [GT][dq]
  float* p_s = q_s + GT * dq;                            // [GT][plen]
  float* m_s = p_s + GT * plen;                          // [GT]
  float* l_s = m_s + GT;                                 // [GT]
  float* red = l_s + GT;               // [nsplit - 1][GT][dh]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- K and V rows -> shared memory (unmapped rows and pads zeroed) ----
  for (int c = tid; c < rows * cpr; c += kThreads) {
    const int r = c / cpr, j = c % cpr;
    const long long o = off(r);
    const bool ok = o >= 0;
    const size_t g_off = (size_t)(ok ? o : 0) + (size_t)j * 16;
    unsigned char* ks = k_s + r * rs + j * 16;
    unsigned char* vs = v_s + r * rs + j * 16;
    if (aligned && !half) {
      cp_async16(ks, kbase + g_off, ok);
      cp_async16(vs, vbase + g_off, ok);
    } else if (aligned) {
      const bool hi = ok && j * 16 + 8 < row_bytes;
      cp_async8(ks, kbase + g_off, ok);
      cp_async8(vs, vbase + g_off, ok);
      cp_async8(ks + 8, kbase + g_off + (hi ? 8 : 0), hi);
      cp_async8(vs + 8, vbase + g_off + (hi ? 8 : 0), hi);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool in = ok && j * 16 + i < row_bytes;
        ks[i] = in ? kbase[g_off + i] : 0;
        vs[i] = in ? vbase[g_off + i] : 0;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < GT * dq; i += kThreads) {
    const int g = i / dq, d = i % dq;
    q_s[i] = g < G && d < dh ? q[g * dh + d] : 0.0f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- scores s[g][r] = (q[g] . k[r]) * scale ---------------------------
  // lpr consecutive lanes own a row (a power of two dividing 32), each
  // summing the chunks j = sub, sub + lpr, ...; the trip count is the same
  // for every thread, so all lanes take part in the shuffles.  A masked
  // row scores -inf, so its exp is exactly 0 even when no row is valid.
  const int lpr = lanes_per_row(cpr);
  const int sub = tid % lpr;
  for (int r0 = 0; r0 < rows; r0 += kThreads / lpr) {
    const int r = r0 + tid / lpr;
    const bool live = r < rows;
    float part[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) part[g] = 0.0f;
    if (live) {
      for (int j = sub; j < cpr; j += lpr) {
        uint32_t w[kPer];
        unpack16<T>(k_s + r * rs + j * 16, w);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const float kv = codec::decode_t<E, M>(w[e], rt_e, rt_m);
#pragma unroll
          for (int g = 0; g < GT; ++g)
            part[g] = fmaf(q_s[g * dq + j * kPer + e], kv, part[g]);
        }
      }
    }
    const bool mapped = live && off(r) >= 0;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s = part[g];
      for (int o = 1; o < lpr; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (live && sub == 0)
        p_s[g * plen + r] = mapped ? s * scale : __uint_as_float(0xff800000u);
    }
  }
  __syncthreads();

  // ---- the piece's softmax, one warp per query head ---------------------
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * plen + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int r = lane; r < rows; r += 32) {
      const float e = expf(p_s[g * plen + r] - mx);
      p_s[g * plen + r] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) { m_s[g] = mx; l_s[g] = sum; }
  }
  __syncthreads();

  // ---- P @ V: column d, rows rsl, rsl + nsplit, ... ----------------------
  const int ncol = dh < kThreads ? dh : kThreads;
  const int nsplit = kThreads / ncol;
  const int dl = tid % ncol, rsl = tid / ncol;
  for (int d0 = 0; d0 < dh; d0 += ncol) {
    const int d = d0 + dl;
    const bool act = rsl < nsplit && d < dh;
    float acc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[g] = 0.0f;
    if (act) {
      for (int r = rsl; r < rows; r += nsplit) {
        const T raw = *reinterpret_cast<const T*>(v_s + r * rs + d * kItem);
        const float vv = codec::decode_t<E, M>((uint32_t)raw, rt_e, rt_m);
#pragma unroll
        for (int g = 0; g < GT; ++g)
          acc[g] = fmaf(p_s[g * plen + r], vv, acc[g]);
      }
    }
    if (nsplit > 1) {            // the row slices meet in slice order
      if (act && rsl > 0) {
#pragma unroll
        for (int g = 0; g < GT; ++g) red[((rsl - 1) * GT + g) * dh + d] = acc[g];
      }
      __syncthreads();
    }
    if (act && rsl == 0) {
      for (int i = 1; i < nsplit; ++i) {
#pragma unroll
        for (int g = 0; g < GT; ++g) acc[g] += red[((i - 1) * GT + g) * dh + d];
      }
#pragma unroll
      for (int g = 0; g < GT; ++g)
        if (g < G) po[g * dh + d] = l_s[g] > 0.0f ? acc[g] / l_s[g] : 0.0f;
    }
  }
  if (tid < G) {
    pml[tid] = m_s[tid];
    pml[G + tid] = l_s[tid];
  }
}

// The merge of one (sequence, KV head): the row's ceil(min(len, cap) /
// plen) partials in piece order, by the reference's _merge_partials
// formula: w_i = exp(m_i - max m) * l_i, out = sum w_i o_i / sum w_i with
// an explicit zero guard.  The residuals keep their unsplit meaning: m is
// the row's max score, l = sum w_i the softmax denominator under it; no
// valid position gives a zero output and (m, l) = (NEG_INF, 0).
__global__ void __launch_bounds__(kThreads)
merge(const float* __restrict__ part_o, const float* __restrict__ part_ml,
      const int* __restrict__ lengths, float* __restrict__ out,
      float* __restrict__ m_out, float* __restrict__ l_out, int cap, int H,
      int G, int dh, int npieces, int plen) {
  __shared__ float gm_s[kMaxGroup];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), cap);
  const int n = (len + plen - 1) / plen;
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

}  // namespace piece
