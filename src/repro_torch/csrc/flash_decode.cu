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
// The design: a split KV walk and a merge (decode_piece.cuh, shared with
// paged_decode.cu).
//  * Fixed pieces.  Each row's walk is cut into pieces of kPiece = 64
//    positions; a row has ceil(len / 64) of them, a function of its own
//    length only.  The grid is (H, B, ceil(S / 64)); a block whose piece
//    starts at or past its row's length exits at once.  At the serve
//    shape that is 96 working blocks, each with one tile.
//  * A piece's K and V rows (the h-th dh-wide slice of each position)
//    come in by cp.async, 16 B a thread, as packed bytes into shared
//    memory, all in flight together; rows past the length are not read.
//  * Scores: the dh-wide row of K is a run of 16 B chunks; the thread that
//    owns a chunk decodes it (codec.cuh; e5m2 / bf16 / f16 through the
//    hardware conversion, exact) and takes its G partial dot products
//    with q, and the chunks of one row meet by warp shuffles.
//  * The piece's softmax in f32, one warp per query head (max, exp, sum);
//    then P @ V with one thread per head_dim column (and per row slice
//    when dh < 128), each V element decoded once for all G heads.  The
//    block writes its normalized partial o = P @ V / l and (m, l).
//  * The merge, a second small launch with one block per (sequence, KV
//    head), combines the row's partials in piece order by the reference's
//    formula (repro/kernels/dispatch.py, _merge_partials) with an explicit
//    zero guard.  Zero valid positions give a zero output and (m, l) =
//    (NEG_INF, 0), the reference's _finalize.
//  * A row's result depends on its own length and data only, not on B,
//    S or the other rows, so a speculative verify (the same kernel per
//    position) and a decode step give the same bits.
//  * Every G from 1 to 16 (padded to a group tile of 4, 8 or 16) and every
//    head_dim that is a multiple of 8 up to 256 (decode_piece.cuh).
// Optional (m, l) outputs feed a later shard merge.

#include <cuda_runtime.h>
#include <cstdint>

#include "decode_piece.cuh"

namespace {

constexpr int kPiece = 64;           // KV positions a block walks

// One piece of one (sequence, KV head): its normalized partial
// (o [G][dh], m [G], l [G]) into part_o / part_ml at [b][h][piece].
template <typename T, int E, int M, int GT, int DHC>
__global__ void __launch_bounds__(piece::kThreads)
flash_decode_piece(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int S, int H, int G, int dh, float scale, int rt_e,
                   int rt_m, int aligned) {
  if (DHC > 0) dh = DHC;
  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int base = p * kPiece;
  if (base >= len) return;
  const long long pos_bytes = (long long)H * dh * sizeof(T);
  const size_t off0 = (((size_t)b * S + base) * H + h) * dh * sizeof(T);
  const size_t part = ((size_t)b * H + h) * gridDim.z + p;
  piece::attend<T, E, M, GT, DHC>(
      reinterpret_cast<const unsigned char*>(k) + off0,
      reinterpret_cast<const unsigned char*>(v) + off0,
      [=](int r) { return r * pos_bytes; }, min(kPiece, len - base), kPiece,
      q + ((size_t)b * H + h) * G * dh, G, dh, scale, rt_e, rt_m, aligned,
      part_o + part * G * dh, part_ml + part * 2 * G);
}

template <typename T, int E, int M, int GT, int DHC>
cudaError_t launch_g(const float* q, const void* k, const void* v,
                     const int* lengths, float* out, float* m_out,
                     float* l_out, float* part_o, float* part_ml, int B,
                     int S, int H, int G, int dh, float scale, int rt_e,
                     int rt_m, int aligned, cudaStream_t stream) {
  const int npieces = (S + kPiece - 1) / kPiece;
  const size_t smem = piece::smem_bytes(kPiece, dh, sizeof(T), GT);
  auto kern = flash_decode_piece<T, E, M, GT, DHC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (npieces > 0) {
    kern<<<dim3(H, B, npieces), piece::kThreads, smem, stream>>>(
        q, static_cast<const T*>(k), static_cast<const T*>(v), lengths,
        part_o, part_ml, S, H, G, dh, scale, rt_e, rt_m, aligned);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  piece::merge<<<dim3(H, B), piece::kThreads, 0, stream>>>(
      part_o, part_ml, lengths, out, m_out, l_out, S, H, G, dh, npieces,
      kPiece);
  return cudaGetLastError();
}

// the head_dims most configs use run an instantiation with dh fixed at
// compile time (the paper formats; run-time formats take the generic one)
template <typename T, int E, int M, int GT>
cudaError_t launch_dh(const float* q, const void* k, const void* v,
                      const int* lengths, float* out, float* m_out,
                      float* l_out, float* po, float* pml, int B, int S,
                      int H, int G, int dh, float scale, int rt_e, int rt_m,
                      int aligned, cudaStream_t s) {
  if constexpr (E >= 0) {
    if (dh == 128) return launch_g<T, E, M, GT, 128>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s);
    if (dh == 64) return launch_g<T, E, M, GT, 64>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s);
  }
  return launch_g<T, E, M, GT, 0>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s);
}

template <typename T, int E, int M>
cudaError_t launch_fmt(const float* q, const void* k, const void* v,
                       const int* lengths, float* out, float* m_out,
                       float* l_out, float* po, float* pml, int B, int S,
                       int H, int G, int dh, float scale, int rt_e, int rt_m,
                       int aligned, cudaStream_t s) {
  switch (piece::group_tile(G)) {
    case 4: return launch_dh<T, E, M, 4>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s);
    case 8: return launch_dh<T, E, M, 8>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s);
    default: return launch_dh<T, E, M, 16>(q, k, v, lengths, out, m_out, l_out, po, pml, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s);
  }
}

}  // namespace

// fmt_code as in qmm.cu: 0 f32 / binary32, 1 binary8, 2 binary8alt,
// 3 binary16, 4 binary16alt, 5/6/7 any other (rt_e, rt_m) in u8/u16/u32.
// m_out / l_out may be null.  part_o: B * H * ceil(S / 64) * G * dh
// floats and part_ml: B * H * ceil(S / 64) * 2 * G floats of scratch.
// G in 1..16; dh a multiple of 8 in 8..256.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* m_out, void* l_out,
                                   void* part_o, void* part_ml, int B, int S,
                                   int H, int G, int dh, float scale,
                                   int fmt_code, int rt_e, int rt_m,
                                   void* stream) {
  const int item = fmt_code == 0 || fmt_code == 7 ? 4
                   : fmt_code == 3 || fmt_code == 4 || fmt_code == 6 ? 2 : 1;
  if (!piece::shape_ok(G, dh) || part_o == nullptr || part_ml == nullptr)
    return (int)cudaErrorInvalidValue;
  const uintptr_t mask = (dh * item) % 16 ? 7u : 15u;
  const int aligned = (((uintptr_t)k | (uintptr_t)v) & mask) == 0;
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
    case 0: err = launch_fmt<uint32_t, 8, 23>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(Q, k, v, L, O, MO, LO, PO, PML, B, S, H, G, dh, scale, rt_e, rt_m, aligned, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
