// paged_decode.cu -- one-token GQA attention over a paged, packed KV pool,
// hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_attention.py, _paged_decode_kernel (the
// Pallas body behind paged_decode()).  For every sequence b and KV head h
// the G query heads of the group attend over the sequence's pages, found
// through its row of the block table; pages hold packed (e, m) containers
// (e5m2 u8 under the transprecision policy) or f32.
//
// What bounds it on an H100: bytes, at a scale where latency rules.  Each
// mapped, live K/V element is read once at container width (1 B for
// binary8) and feeds G = 4 multiply-adds, far below the ridge point; at
// the serving shape (B = 4, H = 8, 144 live positions, page 64) a call
// moves ~1.3 MB, 0.4 us at 3.35 TB/s.  One block per (sequence, KV head)
// walking its pages in turn gave 32 blocks for 132 SMs, three barriers a
// page and K/V read straight from device memory.
//
// The design: flash_decode.cu's split KV walk and merge, reading through
// the block table (decode_piece.cuh holds the piece body and the merge
// both kernels run).
//  * Fixed pieces of whole pages: a piece is max(1, 64 / page) pages (64
//    positions at page 8, 16, 32 or 64; one page above 64), fixed by the
//    page size alone.  A row has ceil(len / piece) of them, a function of
//    its own length only.  The grid is (H, B, ceil(pages_per_seq / pages
//    a piece)); a block whose piece starts at or past its row's length
//    exits at once.
//  * A block reads its own entries of the block table (the reference's
//    scalar-prefetch index map) and brings the piece's K and V rows of
//    head h in by cp.async into shared memory: position r of a page sits
//    at (page * page_size + r) * H * dh + h * dh.  An unmapped page (table
//    entry < 0) is not read: its rows are zero-filled and score -inf, so
//    they add nothing; a piece whose pages are all unmapped gives
//    m = NEG_INF and l = 0 (in the reference such a page is fetched as
//    page 0 and fully masked, which leaves (m, l, acc) unchanged).
//  * Scores from 16 B chunks reduced by shuffles, the piece's softmax and
//    P @ V in f32, each K/V element decoded once through codec.cuh; the
//    block writes its normalized partial (o, m, l).
//  * The merge, a second small launch from the same C entry, combines a
//    row's partials in piece order by the reference's _merge_partials
//    formula with its explicit zero guard; (m, l) keep their unsplit
//    meaning.
//  * A row's result depends only on its own length, table row and data,
//    not on B, on the table's width or on the rows beside it, so a
//    speculative verify (one call per position) and a decode step give the
//    same bits.
//  * Every G from 1 to 16 and every head_dim that is a multiple of 8 up to
//    256 (decode_piece.cuh).
// Optional (m, l) outputs feed a later shard merge.

#include <cuda_runtime.h>
#include <cstdint>

#include "decode_piece.cuh"

namespace {

constexpr int kPiecePositions = 64;

__host__ __device__ inline int pages_a_piece(int page) {
  return page < kPiecePositions ? kPiecePositions / page : 1;
}

// One piece of one (sequence, KV head): its normalized partial
// (o [G][dh], m [G], l [G]) into part_o / part_ml at [b][h][piece].
template <typename T, int E, int M, int GT, int DHC>
__global__ void __launch_bounds__(piece::kThreads)
paged_decode_piece(const float* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool,
                   const int* __restrict__ lengths,
                   const int* __restrict__ tables,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int H, int G, int dh, int page, int n_pages, float scale,
                   int rt_e, int rt_m, int aligned) {
  if (DHC > 0) dh = DHC;
  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  // the compile-time head_dims run pages of 64 positions (launch_dh): a
  // piece is then one page, one run of rows from its start
  constexpr bool kOnePage = DHC > 0;
  if (kOnePage) page = kPiecePositions;
  const int ppp = kOnePage ? 1 : pages_a_piece(page);
  const int plen = ppp * page;
  const int* trow = tables + (size_t)b * n_pages + (size_t)p * ppp;
  const int phys0 = trow[0];      // the piece's first page, beside its length
  const int len = min(max(lengths[b], 0), n_pages * page);
  const int base = p * plen;
  if (base >= len) return;
  const long long row_bytes = (long long)dh * sizeof(T);
  const long long pos_bytes = H * row_bytes;
  // a piece of one page (page >= 64) is one run of rows from its start;
  // else page sizes are powers of two in practice: shift and mask then
  const long long row0 =
      phys0 < 0 ? -1 : (long long)phys0 * page * pos_bytes + h * row_bytes;
  const bool pow2 = (page & (page - 1)) == 0;
  const int shift = __ffs(page) - 1;
  auto off = [=](int r) -> long long {
    if (ppp == 1) return row0 < 0 ? -1 : row0 + r * pos_bytes;
    const int pi = pow2 ? r >> shift : r / page;
    const int pr = pow2 ? r & (page - 1) : r % page;
    const int phys = pi == 0 ? phys0 : trow[pi];
    return phys < 0 ? -1
                    : ((long long)phys * page + pr) * pos_bytes +
                          h * row_bytes;
  };
  const size_t part = ((size_t)b * H + h) * gridDim.z + p;
  piece::attend<T, E, M, GT, DHC>(
      reinterpret_cast<const unsigned char*>(kpool),
      reinterpret_cast<const unsigned char*>(vpool), off,
      min(plen, len - base), plen, q + ((size_t)b * H + h) * G * dh, G, dh,
      scale, rt_e, rt_m, aligned, part_o + part * G * dh,
      part_ml + part * 2 * G);
}

template <typename T, int E, int M, int GT, int DHC>
cudaError_t launch_g(const float* q, const void* kp, const void* vp,
                     const int* lengths, const int* tables, float* out,
                     float* m_out, float* l_out, float* part_o,
                     float* part_ml, int B, int H, int G, int dh, int page,
                     int n_pages, float scale, int rt_e, int rt_m,
                     int aligned, cudaStream_t stream) {
  const int ppp = pages_a_piece(page), plen = ppp * page;
  const int npieces = (n_pages + ppp - 1) / ppp;
  const size_t smem = piece::smem_bytes(plen, dh, sizeof(T), GT);
  auto kern = paged_decode_piece<T, E, M, GT, DHC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (npieces > 0) {
    kern<<<dim3(H, B, npieces), piece::kThreads, smem, stream>>>(
        q, static_cast<const T*>(kp), static_cast<const T*>(vp), lengths,
        tables, part_o, part_ml, H, G, dh, page, n_pages, scale, rt_e, rt_m,
        aligned);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  piece::merge<<<dim3(H, B), piece::kThreads, 0, stream>>>(
      part_o, part_ml, lengths, out, m_out, l_out, n_pages * page, H, G, dh,
      npieces, plen);
  return cudaGetLastError();
}

// the head_dims most configs use run an instantiation with dh and a page
// of 64 positions fixed at compile time (the paper formats at the
// default page; run-time formats and other pages take the generic one)
template <typename T, int E, int M, int GT>
cudaError_t launch_dh(const float* q, const void* kp, const void* vp,
                      const int* lengths, const int* tables, float* out,
                      float* m_out, float* l_out, float* po, float* pml,
                      int B, int H, int G, int dh, int page, int n_pages,
                      float scale, int rt_e, int rt_m, int aligned,
                      cudaStream_t s) {
  if constexpr (E >= 0) {
    if (page != kPiecePositions)
      return launch_g<T, E, M, GT, 0>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
    if (dh == 128) return launch_g<T, E, M, GT, 128>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
    if (dh == 64) return launch_g<T, E, M, GT, 64>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
  }
  return launch_g<T, E, M, GT, 0>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
}

template <typename T, int E, int M>
cudaError_t launch_fmt(const float* q, const void* kp, const void* vp,
                       const int* lengths, const int* tables, float* out,
                       float* m_out, float* l_out, float* po, float* pml,
                       int B, int H, int G, int dh, int page, int n_pages,
                       float scale, int rt_e, int rt_m, int aligned,
                       cudaStream_t s) {
  switch (piece::group_tile(G)) {
    case 4: return launch_dh<T, E, M, 4>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
    case 8: return launch_dh<T, E, M, 8>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
    default: return launch_dh<T, E, M, 16>(q, kp, vp, lengths, tables, out, m_out, l_out, po, pml, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s);
  }
}

}  // namespace

// fmt_code as in qmm.cu: 0 f32 / binary32, 1 binary8, 2 binary8alt,
// 3 binary16, 4 binary16alt, 5/6/7 any other (rt_e, rt_m) in u8/u16/u32.
// m_out / l_out may be null.  With P = ceil(n_pages / pages a piece),
// part_o: B * H * P * G * dh floats and part_ml: B * H * P * 2 * G floats
// of scratch.  G in 1..16; dh a multiple of 8 in 8..256; page >= 1.
extern "C" int paged_decode_launch(const void* q, const void* kpool,
                                   const void* vpool, const void* lengths,
                                   const void* tables, void* out, void* m_out,
                                   void* l_out, void* part_o, void* part_ml,
                                   int B, int H, int G, int dh, int page,
                                   int n_pages, float scale, int fmt_code,
                                   int rt_e, int rt_m, void* stream) {
  const int item = fmt_code == 0 || fmt_code == 7 ? 4
                   : fmt_code == 3 || fmt_code == 4 || fmt_code == 6 ? 2 : 1;
  if (!piece::shape_ok(G, dh) || page < 1 || part_o == nullptr ||
      part_ml == nullptr)
    return (int)cudaErrorInvalidValue;
  const uintptr_t mask = (dh * item) % 16 ? 7u : 15u;
  const int aligned = (((uintptr_t)kpool | (uintptr_t)vpool) & mask) == 0;
  const float* Q = static_cast<const float*>(q);
  const int* L = static_cast<const int*>(lengths);
  const int* TB = static_cast<const int*>(tables);
  float* O = static_cast<float*>(out);
  float* MO = static_cast<float*>(m_out);
  float* LO = static_cast<float*>(l_out);
  float* PO = static_cast<float*>(part_o);
  float* PML = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 1: err = launch_fmt<uint8_t, 5, 2>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 2: err = launch_fmt<uint8_t, 4, 3>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 3: err = launch_fmt<uint16_t, 5, 10>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 4: err = launch_fmt<uint16_t, 8, 7>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(Q, kpool, vpool, L, TB, O, MO, LO, PO, PML, B, H, G, dh, page, n_pages, scale, rt_e, rt_m, aligned, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
