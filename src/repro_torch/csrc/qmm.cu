// qmm.cu -- transprecision matmul with a fused epilogue, hand-written for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/qmatmul.py, _qmm_kernel (the Pallas body behind
// qmatmul() and qmm_ffn()).  out = quantize?(act(a @ B + bias) * (a @ G))
// with a (M, K) f32 activations, B / G (K, N) packed weights in their
// (e, m) containers (u8 / u16 / u32, or f32), f32 products and f32
// accumulation.
//
// What bounds it on an H100.  In the serving decode step M = 4, so each
// weight element is used for at most 4 FMAs: the kernel is bound by the
// bytes of the packed weight stream (15.0 GB of bf16 per llama3-8b step,
// 4.5 ms at 3.35 TB/s).  A prefill chunk (M = 64) or a speculative verify
// (M = B * k = 16) reuses each weight M times: 2 * 64 * 6.98 G weights =
// 0.89 TFLOP a chunk, 13.3 ms on the f32 CUDA cores (67 TFLOP/s) against
// 4.17 ms of bf16 weight bytes.
//
// The precision argument for tensor cores.  Every packed weight format is
// exact in TF32 (e8m10): binary16alt is e8m7, binary8 e5m2, binary8alt
// e4m3, binary16 e5m10 (its subnormals, down to 2^-24, are normal TF32
// values).  Only the f32 activation is split: a_hi = cvt.rna.tf32(a),
// a_lo = cvt.rna.tf32(a - a_hi), both TF32 values, and
// |a - a_hi - a_lo| <= max(2^-22 |a|, 2^-137) (the second term only where
// a - a_hi is an f32 subnormal).  Products of TF32 values have at most 22
// significant bits, so a_hi * b and a_lo * b are exact in f32, and two TF32
// mma passes give a @ B to within 2^-22 |a| @ |b| plus the accumulation.
// Hopper's tensor cores do not round their internal f32 additions to
// nearest, so each 32-deep K step accumulates in the mma accumulator and
// is then added ("promoted") into a separate f32 register sum with
// ordinary FADD; this bounds what the tensor core's additions can lose
// over K = 14336.  The port's contract (1e-6 in units of |a| @ |b|) holds
// with room.  Two TF32 passes at 495 TFLOP/s cost 3.6 ms a chunk, under
// the 4.17 ms of weight bytes: on tensor cores the chunk is bound by bytes.
//
// One summation order per format.  The route is fixed by the weight
// format (tensor cores for the packed formats, CUDA cores for binary32 and
// run-time formats), and each route's K split is a function of K and N
// only.  Within a route the row tile changes with M, but every row tile
// sums an output's products in the same order, so a row's bits do not
// depend on the rows beside it: a decode step over B rows, the speculative
// verify over B * k rows and a 64-row prefill chunk give the same row bit
// for bit (the speculative decoder's exactness rests on it).
//  * qmm_tc (binary8, binary8alt, binary16, binary16alt at every M; entry
//    point qmm_tc_launch): split-TF32 mma.sync.m16n8k8 on tensor cores.
//    A block owns BM rows x 128 weight columns, BM = 16, 32 or 64 picked
//    by M (a decode step of 4 rows and the verify's 16 take the 16-row
//    tile; its masked rows are zero-filled on load and never stored);
//    four warps across N, each 32 columns, and one or two across M.  For
//    the gated FFN the 128 columns are 64 of B and the same 64 of G, so a
//    thread holds both sums of its outputs and a gated block costs the
//    registers of an ungated one.  A one-pass kernel (qmm_split_a) splits
//    each activation once per launch into a_hi and a_lo (scratch the
//    wrapper allocates; a split inside the blocks would be repeated by
//    every block column).  The packed weight tile (32 x 128 at 1 or 2
//    bytes) and the two activation tiles go through a ring of 3-4
//    shared-memory stages by cp.async, 16 B a thread, so the next tiles
//    load while this one multiplies; one barrier per stage.  Weights are
//    decoded between shared memory and the fragment registers (a bf16
//    decode is one shift); no f32 weight tile exists.  A thread reads 4
//    adjacent weight columns and gives one to each of its 4 n8 tiles, so
//    its outputs are adjacent columns.  The a_lo pass over all of a
//    warp's tiles precedes the a_hi pass, so the two mma into one
//    accumulator do not wait on each other.  Where the tiles give fewer
//    blocks than the SMs hold at once (wk/wv, and wq/wo/w_out at
//    N = 4096), K is split across blocks in multiples of 32, as many as
//    make a 64-row launch one balanced wave (kernels/qmatmul.py,
//    tiled_splits), and the partials meet in qmm_splitk in split order.
//    An mma's rows are independent, so a row's sum does not depend on
//    the tile height either.  Ragged M, K and N are masked (zero-filled
//    copies); a shape whose rows are not 16-byte aligned loads element by
//    element into the same stages.
//  * qmm_tc_grouped (entry point qmm_tc_grouped_launch): the MoE expert
//    product, every expert's block of one weight (or of the gated pair,
//    with qmm_tc's epilogue) in one kernel, only the experts with kept
//    rows streaming; each work unit repeats qmm_tc's tile arithmetic and
//    the K split is qmm_tc's, so its rows equal a per-expert qmm_tc
//    launch's bit for bit (see its section below).
//  * binary32 / f32 weights (not exact in TF32) and run-time (e, m)
//    formats, at every M; entry point qmm_launch, row tile picked by M
//    (kernels/qmatmul.py, f32_tile_m).  The order of an output's sum: the
//    split's K range is cut into 16 residue classes k = k_lo + r (mod 16);
//    each class is one fmaf chain in k order from 0.0f; classes 2w and
//    2w + 1 are added; the eight pair sums are added in order w = 0..7
//    from 0.0f; the K splits (gemv_splits, a function of K and N) meet in
//    qmm_splitk in split order.  Two kernels keep that order:
//    - qmm_gemv (M <= 8, BM = 4 or 8 rows a row block) streams the
//      weights for the decode step: a block owns a 64-column strip; 256
//      threads = 16 column-threads x 16 K-threads (the K-thread is the
//      residue class); a column-thread holds 4 adjacent columns, so a
//      half-warp reads a 64-column weight row as one vector load per
//      thread (4 B for u8, 8 B for u16, 16 B for u32/f32), coalesced.
//      Each thread issues 4 weight rows before its first FMA.  Narrow
//      matrices give fewer strips than the card has SMs (wk/wv: 16), so
//      the K range is split across blocks (grid.z) until about two blocks
//      of a row block per SM exist.
//    - qmm_tile (M > 8; BM = 16, 32 or 64 rows a block, picked by M)
//      serves the verify and the prefill chunk (0.89 TFLOP, 13.3 ms at
//      67 TFLOP/s), reusing each weight for every row from registers: a
//      block owns BM rows x 32 weight columns of one K split (16 columns
//      of B and the same 16 of G when gated); its threads are the 16
//      residue classes, and a thread keeps one class's chains of BM / 4
//      or BM / 8 rows x 8 columns in registers (64 rows: 512 threads, a
//      warp a class, 16 warps an SM; 16 and 32 rows: 256 threads, two or
//      three blocks an SM).  Activation (BM x 128) and weight (128 x 32)
//      tiles come into shared memory by a 3-stage cp.async ring, 16 B a
//      thread; per k a thread reads its activations and 8 weights from
//      shared memory, the next k's while this k's FMAs issue.  Weights
//      are decoded between shared memory and registers (a bit cast for
//      binary32).  At the end every class's sums go through shared
//      memory (the stage buffers reused) and meet in the order above, so
//      qmm_tile's rows equal qmm_gemv's bit for bit.  The order keeps
//      sixteen chains of every output live, which caps a block at 2048
//      outputs and its copies at 3 N K floats a 64-row launch; those
//      copies cost about as much as the FMAs and do not overlap with
//      them (PERF.md section 6, tools/bench_qmm_tile.py).
//  * The gate weight G is streamed in the same K sweep (the gated FFN in
//    one launch); bias, nonlinearity, gate and output quantization run in
//    the epilogue, in the reference's order.
//  * Packed activations (the reference's fmt_a, the ops API's matmul):
//    a_code names A's format as fmt_code names the weights' (0: f32).
//    Decoding is exact, so A is decoded once per launch through codec.cuh
//    before the product and the summation order stays the one above: on
//    the tensor cores inside qmm_split_a, which makes its one pass over A
//    anyway; on the CUDA cores by qmm_decode_a into f32 scratch that the
//    GEMV and qmm_tile then read as their activation.  A product on
//    packed A equals the product on its decoded f32 values bit for bit.
// Speed work still open: wgmma with TMA for qmm_tc, and a GEMV that
// reaches the decode step's byte bound.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

// kernels/qmatmul.py builds this file as seven units in parallel: unit 0
// (GEMV, both entry points), one tensor-core unit per packed format
// (-DQMM_UNIT=1..4, fmt_code 1..4) and two qmm_tile units (5: binary32,
// 6: the run-time formats), linked into one library.
#ifndef QMM_UNIT
#define QMM_UNIT 0
#endif
#define QMM_TC_UNIT (QMM_UNIT >= 1 && QMM_UNIT <= 4)
#define QMM_TILE_UNIT (QMM_UNIT >= 5)

// a tensor-core unit's launcher (qmm_tc_launch dispatches to it)
#define QMM_TC_PARAMS                                                     \
  const void *a, float *asplit, const void *b, const void *g,            \
      const float *bias, float *out, float *ws, int M, int K, int N,       \
      int splits, int k_chunk, int act, int out_e, int out_m, int promote, \
      int a_code, int a_e, int a_m, cudaStream_t stream
extern "C" int qmm_tc_fmt1(QMM_TC_PARAMS);
extern "C" int qmm_tc_fmt2(QMM_TC_PARAMS);
extern "C" int qmm_tc_fmt3(QMM_TC_PARAMS);
extern "C" int qmm_tc_fmt4(QMM_TC_PARAMS);

// a tensor-core unit's grouped (MoE expert) launcher
#define QMM_GROUPED_PARAMS                                                 \
  const float *a, const void *b, const void *g, float *out, float *ws,     \
      int *counts, const int *rows, int n_exp, int C, int K, int N,        \
      int splits, int k_chunk, int act, int out_e, int out_m, int n_sm,    \
      cudaStream_t stream
extern "C" int qmm_tc_grouped_fmt1(QMM_GROUPED_PARAMS);
extern "C" int qmm_tc_grouped_fmt2(QMM_GROUPED_PARAMS);
extern "C" int qmm_tc_grouped_fmt3(QMM_GROUPED_PARAMS);
extern "C" int qmm_tc_grouped_fmt4(QMM_GROUPED_PARAMS);

// a qmm_tile unit's launcher (qmm_launch calls it for tile_m > 8)
#define QMM_TILE_PARAMS                                                    \
  const float *a, const void *b, const void *g, const float *bias,        \
      float *out, float *ws, int M, int K, int N, int splits, int tile_m, \
      int fmt_code, int rt_e, int rt_m, int act, int out_e, int out_m,    \
      cudaStream_t stream
extern "C" int qmm_tile_f32(QMM_TILE_PARAMS);
extern "C" int qmm_tile_rt(QMM_TILE_PARAMS);

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 16;          // column-threads per block
constexpr int kTK = 16;          // K-threads per block
constexpr int kVec = 4;          // columns per column-thread
constexpr int kBN = kTN * kVec;  // 64 columns per block
constexpr int kWarps = kThreads / 32;

enum Act { kNone = 0, kSilu = 1, kGelu = 2, kRelu2 = 3 };

constexpr int kTcBK = 32;   // tensor-core kernel: K per stage and promotion

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

// 16 B global -> shared copies, zero-filled where pred is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#if QMM_UNIT == 0

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
  // grid (row blocks, strips, splits): the row blocks of one strip run
  // side by side, so all but the first find the strip's weights in L2
  const int n = blockIdx.y * kBN + tn * kVec;
  const int m0 = blockIdx.x * BM;
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
    const int row = m0 + o / kBN, col = blockIdx.y * kBN + o % kBN;
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

#endif  // QMM_UNIT == 0

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

#if QMM_TC_UNIT

// ---------------------------------------------------------------------------
// the packed formats at every M: split-TF32 mma.sync on tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128;            // block columns: 4 warps x 32
constexpr int kTcAStride = kTcBK + 8; // floats per activation row in smem
constexpr int kTcBPad = 16;           // bytes after each weight row

template <int BM>
struct TcShape {
  static constexpr int kMT = BM >= 32 ? 2 : 1;        // m16 tiles a warp
  static constexpr int kWarpsM = BM / (16 * kMT);
  static constexpr int kThreads = 32 * 4 * kWarpsM;   // 4 warps across N
  static constexpr int kStages = BM == 64 ? 3 : 4;
  static constexpr int kMinBlocks = 512 / kThreads;   // <= 128 registers
};

template <typename TB, int BM>
constexpr size_t tc_smem_bytes() {
  return TcShape<BM>::kStages *
         (sizeof(float) * 2 * BM * kTcAStride +
          kTcBK * (kTcBN * sizeof(TB) + kTcBPad));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// a = hi + lo + r with hi, lo TF32 values and |r| <= max(2^-22 |a|,
// 2^-137).  Where cvt.rna rounds a finite a past the largest TF32 value,
// hi is a truncated instead; Inf and NaN stay in hi (lo = 0), so
// hi * b + lo * b is what a * b is.  (kernels/qmatmul.py, split_tf32, is
// the same function in PyTorch.)
__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  float h = tf32_rna(a);
  if (isinf(h) && !isinf(a))
    h = __uint_as_float(__float_as_uint(a) & 0xffffe000u);
  hi = h;
  lo = isfinite(a) ? tf32_rna(a - h) : 0.0f;
}

// The activation (M x K) -> its TF32 parts a_hi and a_lo (each M x K),
// once per launch, before the tensor-core kernel reads them.  TA = float:
// f32 activations; else containers of (EA, MA) (EA < 0: (rt_e, rt_m) at
// run time), each decoded exactly through codec.cuh before its split.
template <typename TA, int EA, int MA>
__global__ void qmm_split_a(const TA* __restrict__ a,
                            float* __restrict__ hi, float* __restrict__ lo,
                            size_t n, int vec, int rt_e, int rt_m) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (sizeof(TA) < 4 || EA != 8 || MA != 23) {
    for (; i < n; i += stride)
      split_tf32(codec::decode_t<EA, MA>((uint32_t)a[i], rt_e, rt_m), hi[i],
                 lo[i]);
  } else if (vec) {
    for (; 4 * i < n; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(a)[i];
      float4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      reinterpret_cast<float4*>(hi)[i] = h;
      reinterpret_cast<float4*>(lo)[i] = l;
    }
  } else {
    for (; i < n; i += stride) split_tf32(a[i], hi[i], lo[i]);
  }
}

// qmm_split_a for the activation format a_code (fmt_code numbering)
inline cudaError_t split_a(const void* a, float* a_hi, float* a_lo, size_t n,
                           int a_code, int a_e, int a_m,
                           cudaStream_t stream) {
  const int vec_a = a_code == 0 && n % 4 == 0 &&
      (((uintptr_t)a | (uintptr_t)a_hi | (uintptr_t)a_lo) & 15u) == 0;
  const size_t work = vec_a ? n / 4 : n;
  const int blocks = (int)((work + 255) / 256 < 2048 ? (work + 255) / 256
                                                      : 2048);
  switch (a_code) {
    case 0: qmm_split_a<float, 8, 23><<<blocks, 256, 0, stream>>>(static_cast<const float*>(a), a_hi, a_lo, n, vec_a, a_e, a_m); break;
    case 1: qmm_split_a<uint8_t, 5, 2><<<blocks, 256, 0, stream>>>(static_cast<const uint8_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    case 2: qmm_split_a<uint8_t, 4, 3><<<blocks, 256, 0, stream>>>(static_cast<const uint8_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    case 3: qmm_split_a<uint16_t, 5, 10><<<blocks, 256, 0, stream>>>(static_cast<const uint16_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    case 4: qmm_split_a<uint16_t, 8, 7><<<blocks, 256, 0, stream>>>(static_cast<const uint16_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    case 5: qmm_split_a<uint8_t, -1, -1><<<blocks, 256, 0, stream>>>(static_cast<const uint8_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    case 6: qmm_split_a<uint16_t, -1, -1><<<blocks, 256, 0, stream>>>(static_cast<const uint16_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    case 7: qmm_split_a<uint32_t, -1, -1><<<blocks, 256, 0, stream>>>(static_cast<const uint32_t*>(a), a_hi, a_lo, n, 0, a_e, a_m); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Packed weight -> f32 bit pattern, exact and TF32-representable for the
// four packed formats.  NaN stays NaN (payloads need not be canonical: a
// NaN operand makes the mma's sum NaN whatever its bits).
template <int E, int M>
__device__ __forceinline__ uint32_t tc_decode(uint32_t w) {
  if constexpr (E == 8 && M == 7) {
    return w << 16;
  } else if constexpr (E == 5 && M == 10) {
    return __float_as_uint(__half2float(__ushort_as_half((unsigned short)w)));
  } else if constexpr (E == 5 && M == 2) {
    return __float_as_uint(
        __half2float(__ushort_as_half((unsigned short)(w << 8))));
  } else {
    return __float_as_uint(codec::decode_t<E, M>(w, E, M));
  }
}

// 4 adjacent weight columns of one smem row (8 B for u16, 4 B for u8).
template <typename TB>
__device__ __forceinline__ void load_cols(const unsigned char* p,
                                          uint32_t w[4]) {
  if constexpr (sizeof(TB) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x & 0xffffu; w[1] = v.x >> 16;
    w[2] = v.y & 0xffffu; w[3] = v.y >> 16;
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = (v >> (8 * j)) & 0xffu;
  }
}

// 2 adjacent weight columns (4 B for u16, 2 B for u8).
template <typename TB>
__device__ __forceinline__ void load_pair(const unsigned char* p,
                                          uint32_t w[2]) {
  if constexpr (sizeof(TB) == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    w[0] = v & 0xffffu; w[1] = v >> 16;
  } else {
    const uint32_t v = *reinterpret_cast<const unsigned short*>(p);
    w[0] = v & 0xffu; w[1] = v >> 8;
  }
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (t, g), b1 (t + 4,
// g); C c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, ...).  The mma's k and n
// indices are labels: in K step s, mma k t is real k 8s + 2t and mma k
// t + 4 is 8s + 2t + 1 (so a thread's two A values sit side by side).
// A warp owns 32 columns of the block's 128-column weight tile and runs
// four n8 tiles; in tile p, mma column c is
//  * ungated: warp column 4c + p (a thread reads 4 adjacent weight
//    columns and owns 8 adjacent outputs);
//  * gated: the tile holds 64 columns of B and the same 64 of G side by
//    side, a warp 16 of each; tiles 0, 1 are B's warp column 2c + p and
//    tiles 2, 3 G's same columns, so a thread holds a(B) and a(G) of the
//    same 4 adjacent outputs and the gate stays in registers.
// Either way a thread keeps 16 accumulators per m16 tile, plus their
// promoted sums.
// Activation rows m0.. (those below Mrows) x K [k0, k_hi) of a (rows of
// K floats) -> a stage of BM x kTcAStride floats: cp.async 16 B a thread,
// zero-filled past the edges; element by element when the rows are not
// 16 B aligned.
template <int BM>
__device__ __forceinline__ void tc_load_a(float* dst0,
                                          const float* __restrict__ a,
                                          int Mrows, int K, int m0, int k0,
                                          int k_hi, int aligned) {
  constexpr int kACh = kTcBK / 4;                 // 16 B chunks per A row
  for (int c = threadIdx.x; c < BM * kACh; c += TcShape<BM>::kThreads) {
    const int r = c / kACh, kc = (c % kACh) * 4;
    const int row = m0 + r, k = k0 + kc;
    float* dst = dst0 + r * kTcAStride + kc;
    if (aligned) {
      const bool in = row < Mrows && k < k_hi;
      cp_async16(dst, in ? a + (size_t)row * K + k : a, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = (row < Mrows && k + j < k_hi)
                     ? a[(size_t)row * K + k + j] : 0.0f;
    }
  }
}

// Weight rows [k0, k_hi) x the tile's 128 smem columns from n0 (gated: 64
// of B and the same 64 of G side by side) -> a stage, as tc_load_a.
template <typename TB, int BM>
__device__ __forceinline__ void tc_load_b(unsigned char* dst0,
                                          const TB* __restrict__ b,
                                          const TB* __restrict__ g, int N,
                                          int n0, int k0, int k_hi,
                                          int aligned) {
  constexpr int kItem = sizeof(TB);
  constexpr int kBRow = kTcBN * kItem + kTcBPad;  // bytes per weight row
  constexpr int kBCh = kTcBN * kItem / 16;        // 16 B chunks per row
  constexpr int kPer = 16 / kItem;                // weights per chunk
  const bool gated = g != nullptr;
  for (int c = threadIdx.x; c < kTcBK * kBCh; c += TcShape<BM>::kThreads) {
    const int r = c / kBCh, cc = c % kBCh, k = k0 + r;
    // gated: the row's first half is B's columns, the second G's
    const bool second = gated && cc >= kBCh / 2;
    const TB* src = second ? g : b;
    const int col = n0 + (second ? cc - kBCh / 2 : cc) * kPer;
    const size_t off = (size_t)k * N + col;
    unsigned char* dst = dst0 + r * kBRow + cc * 16;
    if (aligned) {
      const bool in = k < k_hi && col < N;
      cp_async16(dst, in ? src + off : src, in);
    } else {
      TB* d = reinterpret_cast<TB*>(dst);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        d[j] = (k < k_hi && col + j < N) ? src[off + j] : TB(0);
    }
  }
}

// One 32-deep K tile of a warp's outputs from a stage, into acc: for each
// 8 of K, the a_lo pass over the warp's four n8 tiles, then the a_hi pass
// (the two mma into one accumulator stand kMT * 4 issues apart).  SPLIT:
// `as` holds the raw f32 activation and each fragment value is split into
// its TF32 parts as it is read (`al` unused); else `as` and `al` hold the
// parts.  bs: the stage's weights at this thread's first column.
template <typename TB, int E, int M, int BM, bool SPLIT>
__device__ __forceinline__ void tc_mma_tile(
    const float* as, const float* al, const unsigned char* bs, bool gated,
    int wm0, int gid, int tig, float (&acc)[TcShape<BM>::kMT][4][4]) {
  constexpr int kMT = TcShape<BM>::kMT;
  constexpr int kItem = sizeof(TB);
  constexpr int kBRow = kTcBN * kItem + kTcBPad;
#pragma unroll
  for (int s = 0; s < kTcBK / 8; ++s) {
    const int kk = 8 * s + 2 * tig;
    uint32_t ah[kMT][4], alo[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int r = (wm0 + 16 * i + gid) * kTcAStride + kk;
      const float2 h0 = *reinterpret_cast<const float2*>(as + r);
      const float2 h1 =
          *reinterpret_cast<const float2*>(as + r + 8 * kTcAStride);
      if constexpr (SPLIT) {
        const float v[4] = {h0.x, h1.x, h0.y, h1.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float hi, lo;
          split_tf32(v[q], hi, lo);
          ah[i][q] = __float_as_uint(hi);
          alo[i][q] = __float_as_uint(lo);
        }
      } else {
        const float2 l0 = *reinterpret_cast<const float2*>(al + r);
        const float2 l1 =
            *reinterpret_cast<const float2*>(al + r + 8 * kTcAStride);
        ah[i][0] = __float_as_uint(h0.x); ah[i][1] = __float_as_uint(h1.x);
        ah[i][2] = __float_as_uint(h0.y); ah[i][3] = __float_as_uint(h1.y);
        alo[i][0] = __float_as_uint(l0.x); alo[i][1] = __float_as_uint(l1.x);
        alo[i][2] = __float_as_uint(l0.y); alo[i][3] = __float_as_uint(l1.y);
      }
    }
    uint32_t w0[4], w1[4];             // weight rows kk and kk + 1
    const unsigned char* p = bs + kk * kBRow;
    if (gated) {
      load_pair<TB>(p, w0);
      load_pair<TB>(p + kTcBN / 2 * kItem, w0 + 2);
      load_pair<TB>(p + kBRow, w1);
      load_pair<TB>(p + kBRow + kTcBN / 2 * kItem, w1 + 2);
    } else {
      load_cols<TB>(p, w0);
      load_cols<TB>(p + kBRow, w1);
    }
    uint32_t b0[4], b1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b0[q] = tc_decode<E, M>(w0[q]);
      b1[q] = tc_decode<E, M>(w1[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma_tf32(acc[i][q], alo[i], b0[q], b1[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma_tf32(acc[i][q], ah[i], b0[q], b1[q]);
  }
}

// The tensor core's sum of 32 products -> the FADD sums tot.
template <int BM>
__device__ __forceinline__ void tc_promote(
    float (&tot)[TcShape<BM>::kMT][4][4],
    float (&acc)[TcShape<BM>::kMT][4][4]) {
#pragma unroll
  for (int i = 0; i < TcShape<BM>::kMT; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tot[i][p][j] += acc[i][p][j];
        acc[i][p][j] = 0.0f;
      }
}

// A warp's outputs of a tile (rows m0 + wm0 + ..., those below Mrows;
// columns from n0 + wn0), each tot + acc: through the epilogue into out,
// or with a K split (splits > 1) as split z's partials into ws + z *
// plane + idx (the gate's at (splits + z) * plane).  c element j of n8
// tile p holds row (j < 2 ? gid : gid + 8); its column is 8 tig + 4
// (j & 1) + p (ungated) or 4 tig + 2 (j & 1) + (p & 1) (gated, p < 2 for
// B and p >= 2 for G).
template <int BM>
__device__ __forceinline__ void tc_store(
    const float (&tot)[TcShape<BM>::kMT][4][4],
    const float (&acc)[TcShape<BM>::kMT][4][4], float* out, float* ws,
    const Epilogue& ep, bool gated, int Mrows, int N, int m0, int n0,
    int wm0, int wn0, int gid, int tig, int z, int splits, size_t plane) {
  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < TcShape<BM>::kMT; ++i)
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int row = m0 + wm0 + 16 * i + gid + 8 * hrow;
      if (row >= Mrows) continue;
#pragma unroll
      for (int half = 0; half < (gated ? 1 : 2); ++half) {
        // 4 adjacent outputs: v (and the gate sums gv when gated)
        float v[4], gv[4];
        int col0;
        if (gated) {
          col0 = n0 + wn0 + 4 * tig;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 2 * hrow + (u >> 1), p = u & 1;
            v[u] = tot[i][p][j] + acc[i][p][j];
            gv[u] = tot[i][p + 2][j] + acc[i][p + 2][j];
          }
        } else {
          col0 = n0 + wn0 + 8 * tig + 4 * half;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int j = 2 * hrow + half;
            v[p] = tot[i][p][j] + acc[i][p][j];
            gv[p] = 0.0f;
          }
        }
        const size_t idx = (size_t)row * N + col0;
        float* dst = out + idx;
        float* gdst = nullptr;
        if (splits == 1) {
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = ep(v[u], gv[u], col0 + u);
        } else {   // partials [split][row][col], the gate's after all
          dst = ws + z * plane + idx;
          if (gated) gdst = ws + (splits + z) * plane + idx;
        }
        if (vec_out && col0 + 3 < N) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(v[0], v[1], v[2], v[3]);
          if (gdst != nullptr)
            *reinterpret_cast<float4*>(gdst) =
                make_float4(gv[0], gv[1], gv[2], gv[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (col0 + u >= N) continue;
            dst[u] = v[u];
            if (gdst != nullptr) gdst[u] = gv[u];
          }
        }
      }
    }
}

// qmm_tc's tile: rows m0 .. m0 + BM - 1 (those below Mrows) x the block's
// columns from n0, over K split z of `splits`, through a ring of kStages
// shared-memory stages (a_hi, a_lo and weight tiles).
template <typename TB, int E, int M, int BM>
__device__ __forceinline__ void tc_tile(
    unsigned char* smem_raw, const float* __restrict__ a_hi,
    const float* __restrict__ a_lo, const TB* __restrict__ b,
    const TB* __restrict__ g, float* __restrict__ out,
    float* __restrict__ ws, const Epilogue& ep, int Mrows, int K, int N,
    int k_chunk, int aligned, int promote, int m0, int n0, int z,
    int splits, size_t plane) {
  using S = TcShape<BM>;
  constexpr int kMT = S::kMT, kStages = S::kStages;
  constexpr int kItem = sizeof(TB);
  constexpr int kAStage = BM * kTcAStride;                  // floats
  constexpr int kBStage = kTcBK * (kTcBN * kItem + kTcBPad);  // bytes
  const bool gated = g != nullptr;

  float* As = reinterpret_cast<float*>(smem_raw);   // [stage][BM][stride]
  float* Al = As + kStages * kAStage;               // the same for a_lo
  unsigned char* Bs =
      reinterpret_cast<unsigned char*>(Al + kStages * kAStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp / 4) * 16 * kMT;
  const int wn0 = (warp % 4) * (gated ? 16 : 32);   // warp's first output
  const int k_lo = z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kTcBK - 1) / kTcBK : 0;
  // this thread's weight columns in a smem row, in bytes
  const int boff = gated ? (wn0 + 2 * gid) * kItem : (wn0 + 4 * gid) * kItem;

  auto load_tile = [&](int kt, int st) {
    const int k0 = k_lo + kt * kTcBK;
    tc_load_a<BM>(As + st * kAStage, a_hi, Mrows, K, m0, k0, k_hi, aligned);
    tc_load_a<BM>(Al + st * kAStage, a_lo, Mrows, K, m0, k0, k_hi, aligned);
    tc_load_b<TB, BM>(Bs + st * kBStage, b, g, N, n0, k0, k_hi, aligned);
  };

  float acc[kMT][4][4], tot[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) { acc[i][p][j] = 0.0f; tot[i][p][j] = 0.0f; }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    cp_async_wait<kStages - 2>();      // this thread's copies of tile kt
    __syncthreads();                   // tile kt visible; kt - 1 consumed
    {
      const int nk = kt + kStages - 1;
      if (nk < n_kt) load_tile(nk, nk % kStages);
      cp_async_commit();
    }
    tc_mma_tile<TB, E, M, BM, false>(As + st * kAStage, Al + st * kAStage,
                                     Bs + st * kBStage + boff, gated, wm0,
                                     gid, tig, acc);
    if (promote) tc_promote<BM>(tot, acc);
  }
  cp_async_wait<0>();
  tc_store<BM>(tot, acc, out, ws, ep, gated, Mrows, N, m0, n0, wm0, wn0, gid,
               tig, z, splits, plane);
}

template <typename TB, int E, int M, int BM>
__global__ void __launch_bounds__(TcShape<BM>::kThreads,
                                  TcShape<BM>::kMinBlocks)
qmm_tc(const float* __restrict__ a_hi, const float* __restrict__ a_lo,
       const TB* __restrict__ b, const TB* __restrict__ g,
       float* __restrict__ out, float* __restrict__ ws, Epilogue ep,
       int Mrows, int K, int N, int k_chunk, int aligned, int promote) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bn = g != nullptr ? kTcBN / 2 : kTcBN;  // output columns a block
  tc_tile<TB, E, M, BM>(smem_raw, a_hi, a_lo, b, g, out, ws, ep, Mrows, K,
                        N, k_chunk, aligned, promote, blockIdx.y * BM,
                        blockIdx.x * bn, blockIdx.z, gridDim.z,
                        (size_t)Mrows * N);
}

template <typename TB, int E, int M, int BM>
cudaError_t launch_tc_bm(const float* a_hi, const float* a_lo, const TB* b,
                         const TB* g, float* out, float* ws, Epilogue ep,
                         int Mrows, int K, int N, int splits, int k_chunk,
                         int aligned, int promote, cudaStream_t stream) {
  auto kern = qmm_tc<TB, E, M, BM>;
  constexpr size_t smem = tc_smem_bytes<TB, BM>();
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int bn = g != nullptr ? kTcBN / 2 : kTcBN;
  const dim3 grid((N + bn - 1) / bn, (Mrows + BM - 1) / BM, splits);
  kern<<<grid, TcShape<BM>::kThreads, smem, stream>>>(
      a_hi, a_lo, b, g, out, ws, ep, Mrows, K, N, k_chunk, aligned,
      promote);
  return cudaGetLastError();
}

// asplit: 2 * M * K floats for a_hi and a_lo
template <typename TB, int E, int M>
cudaError_t launch_tc(const void* a, float* asplit, const void* bv,
                      const void* gv, float* out, float* ws, Epilogue ep,
                      int Mrows, int K, int N, int splits, int k_chunk,
                      int promote, int a_code, int a_e, int a_m,
                      cudaStream_t stream) {
  const TB* b = static_cast<const TB*>(bv);
  const TB* g = static_cast<const TB*>(gv);
  const size_t n = (size_t)Mrows * K;
  float* a_hi = asplit;
  float* a_lo = asplit + n;
  if (n > 0) {
    const cudaError_t e = split_a(a, a_hi, a_lo, n, a_code, a_e, a_m,
                                  stream);
    if (e != cudaSuccess) return e;
  }
  const int aligned =
      K % 4 == 0 && (N * (int)sizeof(TB)) % 16 == 0 &&
      (((uintptr_t)a_hi | (uintptr_t)a_lo | (uintptr_t)b | (uintptr_t)g) &
       15u) == 0;
  cudaError_t e;
  if (Mrows <= 16)
    e = launch_tc_bm<TB, E, M, 16>(a_hi, a_lo, b, g, out, ws, ep, Mrows, K,
                                   N, splits, k_chunk, aligned, promote,
                                   stream);
  else if (Mrows <= 32)
    e = launch_tc_bm<TB, E, M, 32>(a_hi, a_lo, b, g, out, ws, ep, Mrows, K,
                                   N, splits, k_chunk, aligned, promote,
                                   stream);
  else
    e = launch_tc_bm<TB, E, M, 64>(a_hi, a_lo, b, g, out, ws, ep, Mrows, K,
                                   N, splits, k_chunk, aligned, promote,
                                   stream);
  if (e != cudaSuccess || splits == 1) return e;
  const int plane = Mrows * N;
  const int blocks = (plane + 255) / 256 < 1024 ? (plane + 255) / 256 : 1024;
  qmm_splitk<<<blocks, 256, 0, stream>>>(ws, out, ep, Mrows, N, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the MoE expert product: every expert's packed block in one kernel a call
// ---------------------------------------------------------------------------
//
// a (E, C, K) f32, B (and G when gated) (E, K, N) packed, rows (E,) int32
// on the device: expert e's rows [0, rows[e]) get ep(a[e] @ B[e], a[e] @
// G[e]) -- qmm_tc's epilogue: act, gate, output format --, rows
// [rows[e], C) +0.  Replaces the reference's _grouped_qmm
// (repro/models/layers.py), which unrolls one qmatmul an expert and a
// weight, every expert streaming whether a row of it was kept or not.
// Bound by the live experts' weight bytes (a qwen3-moe decode step of 2
// tokens touches at most 16 of 128 experts a layer).  One kernel a call
// (the MoE layer makes two: the gated pair, then w_out), reading the
// counts on the device (no host synchronisation):
//  * the work list: each block scans the counts into its own shared
//    memory (each expert's kept rows and its first (expert, row tile)
//    item); an expert with no kept row has no item and costs no byte;
//  * a persistent grid (the blocks an SM holds x the SMs) walks the work
//    units (item, column tile, K split) with qmm_tc's tile arithmetic
//    (the shared tc_* device functions: its warp layout, the a_lo pass
//    before the a_hi pass, the 32-deep promotion, its stores).  The
//    activation comes into shared memory as it is, and each stage's kept
//    rows are split into their TF32 parts there once (split_tf32, the
//    function qmm_split_a applies), so no split copy of a exists in
//    device memory and the parts are the same bits;
//  * the cp.async ring runs across units: a block's K tiles of all its
//    units form one sequence, so the next unit's first weight tiles are
//    in flight while this unit computes and stores;
//  * the grid writes the dead rows' +0 while its first copies fly;
//  * with a K split, each unit stores its partials and arrives on a
//    counter per (item, column tile) after a fence; the last of a tile's
//    splits to arrive (the block reads its count one unit later, so the
//    atomic's round trip overlaps the next unit) sums the partials in
//    split order from 0.0f, as qmm_splitk does, applies the epilogue and
//    sets the counter back to 0 for the next call.  No value is added
//    atomically.
// The K split is tiled_splits(K, N, gated), the per-expert launch's, and
// an mma's rows are independent, so every row equals the per-expert loop
// (one qmm_tc launch an expert: kernels/qmatmul.py qmm_grouped_loop and
// qmm_grouped_ffn_loop) bit for bit.

// the copy ring's bytes: qmm_tc's stages x (raw activation tile, weight
// tile), and one a_lo tile
template <typename TB, int BM>
constexpr size_t gr_stage_bytes() {
  return TcShape<BM>::kStages *
             (sizeof(float) * BM * kTcAStride +
              kTcBK * (kTcBN * sizeof(TB) + kTcBPad)) +
         sizeof(float) * BM * kTcAStride;
}

constexpr int kGrLoads = 16;   // split partials a reducing thread has in flight

// one unit of the walk: expert e's row tile t, column tile nt, K split z
struct GrUnit {
  int e, t, nt, z, live, k_lo, k_hi, n_kt;
};

// unit u: the items of one (column tile, split) side by side (a row
// tile's neighbours are its expert's other row tiles, which share its
// weights); item s is expert e's row tile s - first[e], e the last expert
// whose first item is at most s (an empty expert's successor shares its
// first item, so e has items)
__device__ __forceinline__ GrUnit gr_unit(long long u, const int* first,
                                          const int* live, int n_exp,
                                          int count, int n_tiles,
                                          int k_chunk, int K) {
  GrUnit w;
  const int s = (int)(u % count);
  const int rest = (int)(u / count);
  w.nt = rest % n_tiles;
  w.z = rest / n_tiles;
  int lo = 0, hi = n_exp - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= s) lo = mid; else hi = mid - 1;
  }
  w.e = lo;
  w.t = s - first[lo];
  w.live = live[lo];
  w.k_lo = w.z * k_chunk;
  w.k_hi = min(K, w.k_lo + k_chunk);
  w.n_kt = (w.k_hi - w.k_lo + kTcBK - 1) / kTcBK;
  return w;
}

// The first `rows` rows of a raw activation stage into their TF32 parts
// (split_tf32, the function qmm_split_a applies): a_hi in place, a_lo into
// `al`.  The rows past them are zero-filled in `as` and never stored, and
// an mma row depends on its own A row alone, so their a_lo is not read
// into any stored output.
template <int BM>
__device__ __forceinline__ void gr_split_rows(float* as, float* al,
                                              int rows) {
  for (int c = threadIdx.x; c < rows * kTcBK; c += TcShape<BM>::kThreads) {
    const int i = (c / kTcBK) * kTcAStride + c % kTcBK;
    float hi, lo;
    split_tf32(as[i], hi, lo);
    as[i] = hi;
    al[i] = lo;
  }
}

template <typename TB, int E, int M, int BM>
__global__ void __launch_bounds__(TcShape<BM>::kThreads,
                                  TcShape<BM>::kMinBlocks)
qmm_tc_grouped(const float* __restrict__ a, const TB* __restrict__ b,
               const TB* __restrict__ g, float* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ counts,
               const int* __restrict__ rows, Epilogue ep, int n_exp, int C,
               int K, int N, int k_chunk, int splits, int aligned) {
  using S = TcShape<BM>;
  constexpr int kMT = S::kMT, kThreads = S::kThreads;
  constexpr int kStages = S::kStages;
  constexpr int kItem = sizeof(TB);
  constexpr int kAStage = BM * kTcAStride;                  // floats
  constexpr int kBStage = kTcBK * (kTcBN * kItem + kTcBPad);  // bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  float* As = reinterpret_cast<float*>(smem_raw);   // [stage][BM][stride]
  float* Al = As + kStages * kAStage;               // a_lo of one tile
  unsigned char* Bs = reinterpret_cast<unsigned char*>(Al + kAStage);
  int* first = reinterpret_cast<int*>(Bs + kStages * kBStage);
  int* live = first + n_exp + 1;

  const bool gated = g != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp / 4) * 16 * kMT;
  const int wn0 = (warp % 4) * (gated ? 16 : 32);   // warp's first output
  const int boff = gated ? (wn0 + 2 * gid) * kItem : (wn0 + 4 * gid) * kItem;
  const int bn = gated ? kTcBN / 2 : kTcBN;         // output columns a tile
  const int n_tiles = (N + bn - 1) / bn;
  const int m_tiles = (C + BM - 1) / BM;
  const size_t plane = (size_t)n_exp * C * N;

  // the work list: kept rows and row tiles an expert, scanned by warp 0
  for (int e = tid; e < n_exp; e += kThreads) {
    const int l = min(max(rows[e], 0), C);
    live[e] = l;
    first[e] = (l + BM - 1) / BM;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < n_exp; base += 32) {
      const int i = base + lane;
      const int v = i < n_exp ? first[i] : 0;
      int s = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += o;
      }
      if (i < n_exp) first[i] = carry + s - v;
      carry += __shfl_sync(0xffffffffu, s, 31);
    }
    if (lane == 0) first[n_exp] = carry;
  }
  __syncthreads();
  const int count = first[n_exp];
  const long long units = (long long)count * n_tiles * splits;
  auto unit = [&](long long u) {
    return gr_unit(u, first, live, n_exp, count, n_tiles, k_chunk, K);
  };

  // stage `st` <- K tile `kt` of unit w (the activation as it is, rows
  // past the expert's kept rows zero-filled)
  auto load_tile = [&](const GrUnit& w, int kt, int st) {
    const int k0 = w.k_lo + kt * kTcBK;
    tc_load_a<BM>(As + st * kAStage, a + (size_t)w.e * C * K, w.live, K,
                  w.t * BM, k0, w.k_hi, aligned);
    tc_load_b<TB, BM>(Bs + st * kBStage, b + (size_t)w.e * K * N,
                      gated ? g + (size_t)w.e * K * N : nullptr, N,
                      w.nt * bn, k0, w.k_hi, aligned);
  };

  float acc[kMT][4][4], tot[kMT][4][4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) { acc[i][p][j] = 0.0f; tot[i][p][j] = 0.0f; }
  };

  // the sum of a tile's split partials in split order from 0.0f, then
  // the epilogue (qmm_splitk's arithmetic), by the tile's last arrival;
  // a thread issues kGrLoads partial loads before it adds the first, so
  // their round trips to L2 overlap
  auto reduce = [&](const GrUnit& w) {
    const int m0 = w.t * BM, n0 = w.nt * bn;
    float* outE = out + (size_t)w.e * C * N;
    const float* wsE = ws + (size_t)w.e * C * N;
    const int nr = min(BM, w.live - m0), nc = min(bn, N - n0);
    auto in_order = [&](const float* p, size_t idx) {
      float sum = 0.0f;
      for (int z0 = 0; z0 < splits; z0 += kGrLoads) {
        float v[kGrLoads];
#pragma unroll
        for (int j = 0; j < kGrLoads; ++j)
          v[j] = z0 + j < splits ? __ldcg(p + (z0 + j) * plane + idx) : 0.0f;
#pragma unroll
        for (int j = 0; j < kGrLoads; ++j)
          if (z0 + j < splits) sum += v[j];
      }
      return sum;
    };
    for (int o = tid; o < nr * nc; o += kThreads) {
      const int r = o / nc, c = o % nc;
      const size_t idx = (size_t)(m0 + r) * N + n0 + c;
      const float sum = in_order(wsE, idx);
      const float gsum = gated ? in_order(wsE + splits * plane, idx) : 0.0f;
      outE[idx] = ep(sum, gsum, n0 + c);
    }
  };

  // A unit's split arrives after its partials are stored: the barrier
  // orders every thread's stores before thread 0's fence, whose gpu scope
  // takes them along (a semaphore's release, as CUTLASS's serial split-K
  // reduction does it), then thread 0 bumps the tile's counter.  The
  // count it gets back is read one unit later (its round trip overlaps
  // the next unit's work); the same fence then orders the other splits'
  // partials before the block's reads of them, should this one be last.
  GrUnit pend{};
  bool pending = false;
  int pend_count = 0;                  // thread 0's: the counter it saw
  auto arrive = [&](const GrUnit* w) {
    __syncthreads();
    if (tid == 0) {
      last = 0;
      if (pending) {
        last = pend_count == splits - 1;
        if (last)                      // every split has arrived
          counts[(pend.e * m_tiles + pend.t) * n_tiles + pend.nt] = 0;
      }
      __threadfence();
      if (w != nullptr)
        pend_count = atomicAdd(
            counts + (w->e * m_tiles + w->t) * n_tiles + w->nt, 1);
    }
    __syncthreads();
    if (last) reduce(pend);
    pending = w != nullptr;
    if (w != nullptr) pend = *w;
  };

  // unit w's outputs (qmm_tc's stores: the result, or the split's
  // partials and their arrival)
  auto finish = [&](const GrUnit& w) {
    tc_store<BM>(tot, acc, out + (size_t)w.e * C * N,
                 ws != nullptr ? ws + (size_t)w.e * C * N : nullptr, ep,
                 gated, w.live, N, w.t * BM, w.nt * bn, wm0, wn0, gid, tig,
                 w.z, splits, plane);
    if (splits > 1) arrive(&w);
  };

  // the copy cursor runs kStages - 1 K tiles ahead of the compute
  // cursor, across unit boundaries
  long long ul = blockIdx.x;
  GrUnit wl{};
  int ktl = 0;
  if (ul < units) wl = unit(ul);
  auto issue = [&](int st) {
    if (ul >= units) return;
    load_tile(wl, ktl, st);
    if (++ktl == wl.n_kt) {
      ktl = 0;
      ul += gridDim.x;
      if (ul < units) wl = unit(ul);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }

  // the dead rows' +0, while the first copies are in flight
  for (int R = blockIdx.x; R < n_exp * C; R += gridDim.x) {
    if (R % C < live[R / C]) continue;
    float* o = out + (size_t)R * N;
    if ((N & 3) == 0) {
      for (int c = tid; c < N / 4; c += kThreads)
        reinterpret_cast<float4*>(o)[c] = make_float4(0.0f, 0.0f, 0.0f,
                                                      0.0f);
    } else {
      for (int c = tid; c < N; c += kThreads) o[c] = 0.0f;
    }
  }

  long long uc = blockIdx.x;
  GrUnit wc{};
  if (uc < units) wc = unit(uc);
  int ktc = 0, step = 0;
  clear();
  while (uc < units) {
    cp_async_wait<kStages - 2>();      // this thread's copies of this tile
    __syncthreads();                   // visible; the last tile consumed
    issue((step + kStages - 1) % kStages);
    cp_async_commit();
    const int st = step % kStages;
    // each kept activation value split once, for all four warps
    gr_split_rows<BM>(As + st * kAStage, Al, min(BM, wc.live - wc.t * BM));
    __syncthreads();
    tc_mma_tile<TB, E, M, BM, false>(As + st * kAStage, Al,
                                     Bs + st * kBStage + boff, gated, wm0,
                                     gid, tig, acc);
    tc_promote<BM>(tot, acc);
    ++step;
    if (++ktc == wc.n_kt) {
      finish(wc);
      clear();
      ktc = 0;
      uc += gridDim.x;
      if (uc < units) wc = unit(uc);
    }
  }
  cp_async_wait<0>();
  if (pending) arrive(nullptr);        // the last unit's arrival
}

template <typename TB, int E, int M, int BM>
cudaError_t launch_grouped_bm(const float* a, const TB* b, const TB* g,
                              float* out, float* ws, int* counts,
                              const int* rows, const Epilogue& ep, int n_exp,
                              int C, int K, int N, int splits, int k_chunk,
                              int aligned, int n_sm, cudaStream_t stream) {
  auto kern = qmm_tc_grouped<TB, E, M, BM>;
  const size_t smem =
      gr_stage_bytes<TB, BM>() + (2 * (size_t)n_exp + 1) * sizeof(int);
  static size_t sized = 0;   // the shared memory last asked for
  static int per_sm = 0;     // blocks an SM holds with it
  if (smem != sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int held = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &held, kern, TcShape<BM>::kThreads, smem);
    if (e != cudaSuccess) return e;
    per_sm = held > 0 ? held : 1;
    sized = smem;
  }
  const int bn = g != nullptr ? kTcBN / 2 : kTcBN;
  const long long most = (long long)n_exp * ((C + BM - 1) / BM) *
                         ((N + bn - 1) / bn) * splits;
  const long long held = (long long)per_sm * n_sm;
  const int grid = (int)(most < held ? most : held);
  kern<<<grid, TcShape<BM>::kThreads, smem, stream>>>(
      a, b, g, out, ws, counts, rows, ep, n_exp, C, K, N, k_chunk, splits,
      aligned);
  return cudaGetLastError();
}

// ws: (g ? 2 : 1) * splits * E * C * N floats when splits > 1; counts: E *
// ceil(C / tile) * ceil(N / (g ? 64 : 128)) ints, all 0 (left at 0)
template <typename TB, int E, int M>
cudaError_t launch_grouped(const float* a, const void* bv, const void* gv,
                           float* out, float* ws, int* counts,
                           const int* rows, const Epilogue& ep, int n_exp,
                           int C, int K, int N, int splits, int k_chunk,
                           int n_sm, cudaStream_t stream) {
  const TB* b = static_cast<const TB*>(bv);
  const TB* g = static_cast<const TB*>(gv);
  const int aligned =
      K % 4 == 0 && (N * (int)sizeof(TB)) % 16 == 0 &&
      (((uintptr_t)a | (uintptr_t)b | (uintptr_t)g) & 15u) == 0;
  if (C <= 16)
    return launch_grouped_bm<TB, E, M, 16>(a, b, g, out, ws, counts, rows,
                                           ep, n_exp, C, K, N, splits,
                                           k_chunk, aligned, n_sm, stream);
  if (C <= 32)
    return launch_grouped_bm<TB, E, M, 32>(a, b, g, out, ws, counts, rows,
                                           ep, n_exp, C, K, N, splits,
                                           k_chunk, aligned, n_sm, stream);
  return launch_grouped_bm<TB, E, M, 64>(a, b, g, out, ws, counts, rows, ep,
                                         n_exp, C, K, N, splits, k_chunk,
                                         aligned, n_sm, stream);
}

#endif  // QMM_TC_UNIT

#if QMM_TILE_UNIT

// ---------------------------------------------------------------------------
// binary32 and run-time formats at M > 8: register-tiled CUDA-core kernel
// in the GEMV's summation order
// ---------------------------------------------------------------------------

constexpr int kTlBN = 32;              // weight columns a block
constexpr int kTlBK = 128;             // K per stage: 8 k of each class
constexpr int kTlStages = 3;
constexpr int kTlAP = kTlBK + 4;       // floats per activation row in smem
constexpr int kTlRedP = kTlBN + 1;     // floats per row of the class sums

template <typename TB>
__host__ __device__ constexpr int tl_wrow() {  // bytes per weight row in smem
  return kTlBN * (int)sizeof(TB) + 16;
}

// A qmm_tile block: 16 residue classes x kPer threads; a class's threads
// are kRG row groups x kCG column groups, a thread kRM rows (rg + kRG i)
// x kCN weight columns.  64 rows take 512 threads (a warp per class, 64
// chains a thread: 16 warps an SM); 16 and 32 rows 256 (two classes a
// warp), at two or three blocks an SM.
template <int BM>
struct TlShape {
  static constexpr int kThreads = BM == 64 ? 512 : 256;
  static constexpr int kPer = kThreads / 16;            // threads a class
  static constexpr int kRG = BM == 64 ? 8 : 4;
  static constexpr int kCG = kPer / kRG;
  static constexpr int kRM = BM / kRG;
  static constexpr int kCN = kTlBN / kCG;
  static constexpr int kMinBlocks = BM == 64 ? 1 : BM == 32 ? 2 : 3;
};

template <typename TB, int BM>
constexpr size_t tl_smem_bytes() {
  constexpr size_t stages =
      kTlStages * (sizeof(float) * BM * kTlAP + kTlBK * tl_wrow<TB>());
  constexpr size_t red = sizeof(float) * 16 * BM * kTlRedP;
  return stages > red ? stages : red;
}

// N adjacent containers from shared memory (aligned to the run's size
// up to 16 B) -> their bits, one per word.
template <typename TB, int N>
__device__ __forceinline__ void smem_run(const unsigned char* p,
                                         uint32_t* w) {
  constexpr int kWords = N * (int)sizeof(TB) / 4;
  uint32_t word[kWords];
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      word[4 * q] = v.x; word[4 * q + 1] = v.y;
      word[4 * q + 2] = v.z; word[4 * q + 3] = v.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    word[0] = v.x; word[1] = v.y;
  } else {
    static_assert(kWords == 1, "runs of 4, 8 or 16k bytes");
    word[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (sizeof(TB) == 4) {
      w[j] = word[j];
    } else if constexpr (sizeof(TB) == 2) {
      w[j] = (word[j / 2] >> (16 * (j % 2))) & 0xffffu;
    } else {
      w[j] = (word[j / 4] >> (8 * (j % 4))) & 0xffu;
    }
  }
}

// Thread tid is residue class cls = tid / kPer, rows rg + kRG i (rg =
// tid % kRG) and column group cg = (tid / kRG) % kCG: columns kCN cg ...
// kCN (cg + 1) - 1 ungated, or B's and G's columns kCN / 2 cg ... gated.  In a stage, class cls takes
// the k = cls, cls + 16, cls + 32, cls + 48 of the 64; a k past the split
// is skipped, not multiplied by a zero-filled weight, so every chain is
// the GEMV's chain bit for bit (signed zeros and NaN included).  In a
// full stage the fragment of the next k (BM / 8 activations, 16 decoded
// weights) is read from shared memory while this k's FMAs issue.
template <typename TB, int E, int M, int BM, bool kGated>
__global__ void __launch_bounds__(TlShape<BM>::kThreads,
                                  TlShape<BM>::kMinBlocks)
qmm_tile(const float* __restrict__ a, const TB* __restrict__ b,
         const TB* __restrict__ g, float* __restrict__ out,
         float* __restrict__ ws, Epilogue ep, int Mrows, int K, int N,
         int k_chunk, int rt_e, int rt_m, int aligned) {
  using S = TlShape<BM>;
  constexpr int kThreads = S::kThreads, kRG = S::kRG, kCG = S::kCG;
  constexpr int kRM = S::kRM, kCN = S::kCN;
  constexpr int kItem = sizeof(TB);
  constexpr int kWRow = tl_wrow<TB>();
  constexpr int kAStage = BM * kTlAP;              // floats
  constexpr int kWStage = kTlBK * kWRow;           // bytes
  constexpr int kACh = kTlBK / 4;                  // 16 B chunks per A row
  constexpr int kWCh = kTlBN * kItem / 16;         // per weight row
  constexpr int kPer = 16 / kItem;                 // weights per chunk
  constexpr int kU = kTlBK / 16;                   // k of a class a stage
  constexpr int bn = kGated ? kTlBN / 2 : kTlBN;   // output columns a block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [stage][BM][kTlAP]
  unsigned char* Ws = smem_raw + sizeof(float) * kTlStages * kAStage;

  const int tid = threadIdx.x;
  const int cls = tid / S::kPer, rg = tid % kRG, cg = (tid / kRG) % kCG;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * bn;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kTlBK - 1) / kTlBK : 0;
  const int n_full = k_hi > k_lo ? (k_hi - k_lo) / kTlBK : 0;

  // stage `st` <- K tile `kt`: cp.async 16 B a thread, zero-filled past
  // the edges; element by element when rows are not 16 B aligned
  auto load_tile = [&](int kt, int st) {
    const int k0 = k_lo + kt * kTlBK;
    float* as = As + st * kAStage;
    for (int c = tid; c < BM * kACh; c += kThreads) {
      const int r = c / kACh, kc = (c % kACh) * 4;
      const int row = m0 + r, k = k0 + kc;
      float* dst = as + r * kTlAP + kc;
      if (aligned) {
        const bool in = row < Mrows && k < k_hi;
        cp_async16(dst, in ? a + (size_t)row * K + k : a, in);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = (row < Mrows && k + j < k_hi)
                       ? a[(size_t)row * K + k + j] : 0.0f;
      }
    }
    unsigned char* wsm = Ws + st * kWStage;
    for (int c = tid; c < kTlBK * kWCh; c += kThreads) {
      const int r = c / kWCh, cc = c % kWCh, k = k0 + r;
      // gated: the row's first half is B's columns, the second G's
      const bool second = kGated && cc >= kWCh / 2;
      const TB* src = second ? g : b;
      const int col = n0 + (second ? cc - kWCh / 2 : cc) * kPer;
      const size_t off = (size_t)k * N + col;
      unsigned char* dst = wsm + r * kWRow + cc * 16;
      if (aligned) {
        const bool in = k < k_hi && col < N;
        cp_async16(dst, in ? src + off : src, in);
      } else {
        TB* d = reinterpret_cast<TB*>(dst);
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          d[j] = (k < k_hi && col + j < N) ? src[off + j] : TB(0);
      }
    }
  };

  // this thread's weight columns in a smem row, in bytes
  const int boff = (kGated ? kCN / 2 : kCN) * cg * kItem;
  const int goff = (kTlBN / 2 + kCN / 2 * cg) * kItem;

  // one k's fragment: activations of rows rg + kRG i and decoded weights
  auto fragment = [&](const float* as, const unsigned char* wp, float* av,
                      float* wv) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) av[i] = as[kRG * i * kTlAP];
    uint32_t wb[kCN];
    if constexpr (kGated) {
      smem_run<TB, kCN / 2>(wp + boff, wb);
      smem_run<TB, kCN / 2>(wp + goff, wb + kCN / 2);
    } else {
      smem_run<TB, kCN>(wp + boff, wb);
    }
#pragma unroll
    for (int j = 0; j < kCN; ++j)
      wv[j] = codec::decode_t<E, M>(wb[j], rt_e, rt_m);
  };

  float acc[kRM][kCN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCN; ++j) acc[i][j] = 0.0f;
  auto fma_fragment = [&](const float* av, const float* wv) {
#pragma unroll
    for (int j = 0; j < kCN; ++j)
#pragma unroll
      for (int i = 0; i < kRM; ++i) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  };

#pragma unroll
  for (int s = 0; s < kTlStages - 1; ++s) {
    if (s < n_kt) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kTlStages;
    cp_async_wait<kTlStages - 2>();    // this thread's copies of tile kt
    __syncthreads();                   // tile kt visible; kt - 1 consumed
    {
      const int nk = kt + kTlStages - 1;
      if (nk < n_kt) load_tile(nk, nk % kTlStages);
      cp_async_commit();
    }
    const float* as = As + st * kAStage + rg * kTlAP + cls;
    const unsigned char* wrow = Ws + st * kWStage + cls * kWRow;
    if (kt < n_full) {                 // every class has its kU k here
      float av[2][kRM], wv[2][kCN];
      fragment(as, wrow, av[0], wv[0]);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (u + 1 < kU)
          fragment(as + 16 * (u + 1), wrow + 16 * (u + 1) * kWRow,
                   av[(u + 1) & 1], wv[(u + 1) & 1]);
        fma_fragment(av[u & 1], wv[u & 1]);
      }
    } else {                           // the split's last, partial stage
      const int kc = k_lo + kt * kTlBK + cls;    // this class's first k
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (kc + 16 * u < k_hi) {
          float av[kRM], wv[kCN];
          fragment(as + 16 * u, wrow + 16 * u * kWRow, av, wv);
          fma_fragment(av, wv);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the stages are free for the sums

  // every class's sums into shared memory, laid out [class][row][slot]
  // (slot c is output column c, and gated, slot 16 + c its gate sum);
  // then per output classes 2w and 2w + 1 are added and the eight pair
  // sums added in order w = 0..7 from 0.0f, qmm_gemv's order
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCN; ++j) {
      const int slot =
          kGated ? (j < kCN / 2 ? kCN / 2 * cg + j
                                : kTlBN / 2 + kCN / 2 * cg + j - kCN / 2)
                 : kCN * cg + j;
      red[(cls * BM + rg + kRG * i) * kTlRedP + slot] = acc[i][j];
    }
  __syncthreads();
  const size_t plane = (size_t)Mrows * N;
  for (int o = tid; o < BM * bn; o += kThreads) {
    const int r = o / bn, c = o % bn;
    const int row = m0 + r, col = n0 + c;
    if (row >= Mrows || col >= N) continue;
    float sum = 0.0f, gsum = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w)
      sum += red[(2 * w * BM + r) * kTlRedP + c] +
             red[((2 * w + 1) * BM + r) * kTlRedP + c];
    if constexpr (kGated) {
#pragma unroll
      for (int w = 0; w < 8; ++w)
        gsum += red[(2 * w * BM + r) * kTlRedP + 16 + c] +
                red[((2 * w + 1) * BM + r) * kTlRedP + 16 + c];
    }
    const size_t idx = (size_t)row * N + col;
    if (gridDim.z == 1) {
      out[idx] = ep(sum, gsum, col);
    } else {  // split-K partials: [split][row][col], gate after all splits
      ws[blockIdx.z * plane + idx] = sum;
      if (kGated) ws[(gridDim.z + blockIdx.z) * plane + idx] = gsum;
    }
  }
}

template <typename TB, int E, int M, int BM, bool kGated>
cudaError_t launch_tile_bm(const float* a, const TB* b, const TB* g,
                           float* out, float* ws, Epilogue ep, int Mrows,
                           int K, int N, int splits, int k_chunk, int rt_e,
                           int rt_m, int aligned, cudaStream_t stream) {
  auto kern = qmm_tile<TB, E, M, BM, kGated>;
  constexpr size_t smem = tl_smem_bytes<TB, BM>();
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int bn = kGated ? kTlBN / 2 : kTlBN;
  // row blocks on grid x: the row blocks of one column tile run side by
  // side and share its weights through L2
  const dim3 grid((Mrows + BM - 1) / BM, (N + bn - 1) / bn, splits);
  kern<<<grid, TlShape<BM>::kThreads, smem, stream>>>(
      a, b, g, out, ws, ep, Mrows, K, N, k_chunk, rt_e, rt_m, aligned);
  return cudaGetLastError();
}

template <typename TB, int E, int M, int BM>
cudaError_t launch_tile_g(const float* a, const TB* b, const TB* g,
                          float* out, float* ws, Epilogue ep, int Mrows,
                          int K, int N, int splits, int k_chunk, int rt_e,
                          int rt_m, int aligned, cudaStream_t stream) {
  if (g != nullptr)
    return launch_tile_bm<TB, E, M, BM, true>(a, b, g, out, ws, ep, Mrows, K,
                                              N, splits, k_chunk, rt_e, rt_m,
                                              aligned, stream);
  return launch_tile_bm<TB, E, M, BM, false>(a, b, g, out, ws, ep, Mrows, K,
                                             N, splits, k_chunk, rt_e, rt_m,
                                             aligned, stream);
}

template <typename TB, int E, int M>
cudaError_t launch_tile(const float* a, const void* bv, const void* gv,
                        float* out, float* ws, Epilogue ep, int Mrows, int K,
                        int N, int splits, int tile_m, int rt_e, int rt_m,
                        cudaStream_t stream) {
  const TB* b = static_cast<const TB*>(bv);
  const TB* g = static_cast<const TB*>(gv);
  const int k_chunk = (K + splits - 1) / splits;   // as qmm_gemv's
  const int aligned =
      K % 4 == 0 && k_chunk % 4 == 0 && (N * (int)sizeof(TB)) % 16 == 0 &&
      (((uintptr_t)a | (uintptr_t)b | (uintptr_t)g) & 15u) == 0;
  cudaError_t e;
  switch (tile_m) {
    case 16: e = launch_tile_g<TB, E, M, 16>(a, b, g, out, ws, ep, Mrows, K, N, splits, k_chunk, rt_e, rt_m, aligned, stream); break;
    case 32: e = launch_tile_g<TB, E, M, 32>(a, b, g, out, ws, ep, Mrows, K, N, splits, k_chunk, rt_e, rt_m, aligned, stream); break;
    case 64: e = launch_tile_g<TB, E, M, 64>(a, b, g, out, ws, ep, Mrows, K, N, splits, k_chunk, rt_e, rt_m, aligned, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const int plane = Mrows * N;
  const int blocks = (plane + 255) / 256 < 1024 ? (plane + 255) / 256 : 1024;
  qmm_splitk<<<blocks, 256, 0, stream>>>(ws, out, ep, Mrows, N, splits);
  return cudaGetLastError();
}

#endif  // QMM_TILE_UNIT

#if QMM_UNIT == 0

// A packed activation (M x K containers of (EA, MA); EA < 0: (rt_e, rt_m)
// at run time) -> exact f32, once per launch, for the CUDA-core route.
template <typename TA, int EA, int MA>
__global__ void qmm_decode_a(const TA* __restrict__ a,
                             float* __restrict__ out, size_t n, int rt_e,
                             int rt_m) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = codec::decode_t<EA, MA>((uint32_t)a[i], rt_e, rt_m);
}

// qmm_decode_a for the activation format a_code 1..7 (fmt_code numbering)
cudaError_t decode_a(const void* a, float* out, size_t n, int a_code,
                     int a_e, int a_m, cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  switch (a_code) {
    case 1: qmm_decode_a<uint8_t, 5, 2><<<blocks, 256, 0, stream>>>(static_cast<const uint8_t*>(a), out, n, a_e, a_m); break;
    case 2: qmm_decode_a<uint8_t, 4, 3><<<blocks, 256, 0, stream>>>(static_cast<const uint8_t*>(a), out, n, a_e, a_m); break;
    case 3: qmm_decode_a<uint16_t, 5, 10><<<blocks, 256, 0, stream>>>(static_cast<const uint16_t*>(a), out, n, a_e, a_m); break;
    case 4: qmm_decode_a<uint16_t, 8, 7><<<blocks, 256, 0, stream>>>(static_cast<const uint16_t*>(a), out, n, a_e, a_m); break;
    case 5: qmm_decode_a<uint8_t, -1, -1><<<blocks, 256, 0, stream>>>(static_cast<const uint8_t*>(a), out, n, a_e, a_m); break;
    case 6: qmm_decode_a<uint16_t, -1, -1><<<blocks, 256, 0, stream>>>(static_cast<const uint16_t*>(a), out, n, a_e, a_m); break;
    case 7: qmm_decode_a<uint32_t, -1, -1><<<blocks, 256, 0, stream>>>(static_cast<const uint32_t*>(a), out, n, a_e, a_m); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename TB, int E, int M>
cudaError_t launch_fmt(const float* a, const void* b, const void* g,
                       float* out, float* ws, Epilogue ep, int Mrows, int K,
                       int N, int splits, int tile_m, int rt_e, int rt_m,
                       int vec, cudaStream_t stream) {
  const TB* B = static_cast<const TB*>(b);
  const TB* G = static_cast<const TB*>(g);
  const int nb = (N + kBN - 1) / kBN;
  const int k_chunk = (K + splits - 1) / splits;
  if (tile_m == 4) {
    qmm_gemv<TB, E, M, 4><<<dim3((Mrows + 3) / 4, nb, splits), kThreads, 0,
                            stream>>>(a, B, G, out, ws, ep, Mrows, K, N,
                                      k_chunk, rt_e, rt_m, vec);
  } else {
    qmm_gemv<TB, E, M, 8><<<dim3((Mrows + 7) / 8, nb, splits), kThreads, 0,
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

#endif  // QMM_UNIT == 0

}  // namespace

#if QMM_UNIT == 0

// fmt_code: 0 f32 / binary32 (u32 bits), 1 binary8 (5,2) u8,
// 2 binary8alt (4,3) u8, 3 binary16 (5,10) u16, 4 binary16alt (8,7) u16,
// 5 any other (rt_e, rt_m) in u8, 6 in u16, 7 in u32.
// out_e == 0: no output quantization.  splits > 1 needs ws:
// (gated ? 2 : 1) * splits * M * N floats.  This entry takes fmt_code 0
// and 5-7 at every M (1-4 go to qmm_tc_launch); tile_m picks the kernel
// and its rows a block (kernels/qmatmul.py, f32_tile_m): 4 or 8 the GEMV,
// 16, 32 or 64 qmm_tile.  Both sum an output in one order.  a_code: the
// activation's format (0: f32; 1-7 packed, (a_e, a_m) for 5-7), decoded
// into adec (M * K floats of scratch) before the product.
extern "C" int qmm_launch(const void* a, void* adec, const void* b,
                          const void* g, const void* bias, void* out,
                          void* ws, int M, int K, int N, int splits,
                          int fmt_code, int rt_e, int rt_m, int act,
                          int out_e, int out_m, int vec, int tile_m,
                          int a_code, int a_e, int a_m, void* stream) {
  const float* A = static_cast<const float*>(a);
  float* O = static_cast<float*>(out);
  float* W = static_cast<float*>(ws);
  const float* bs = static_cast<const float*>(bias);
  const Epilogue ep{bs, act, out_e, out_m, g != nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || splits < 1 || (splits > 1 && ws == nullptr) ||
      (a_code != 0 && adec == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a_code != 0) {
    float* AD = static_cast<float*>(adec);
    const cudaError_t e = decode_a(a, AD, (size_t)M * K, a_code, a_e, a_m,
                                   s);
    if (e != cudaSuccess) return (int)e;
    A = AD;
  }
  if (tile_m == 16 || tile_m == 32 || tile_m == 64) {
    if (fmt_code == 0)
      return qmm_tile_f32(A, b, g, bs, O, W, M, K, N, splits, tile_m,
                          fmt_code, rt_e, rt_m, act, out_e, out_m, s);
    if (fmt_code >= 5 && fmt_code <= 7)
      return qmm_tile_rt(A, b, g, bs, O, W, M, K, N, splits, tile_m,
                         fmt_code, rt_e, rt_m, act, out_e, out_m, s);
    return (int)cudaErrorInvalidValue;
  }
  if (tile_m != 4 && tile_m != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (fmt_code) {
    case 0: err = launch_fmt<uint32_t, 8, 23>(A, b, g, O, W, ep, M, K, N, splits, tile_m, rt_e, rt_m, vec, s); break;
    case 5: err = launch_fmt<uint8_t, -1, -1>(A, b, g, O, W, ep, M, K, N, splits, tile_m, rt_e, rt_m, vec, s); break;
    case 6: err = launch_fmt<uint16_t, -1, -1>(A, b, g, O, W, ep, M, K, N, splits, tile_m, rt_e, rt_m, vec, s); break;
    case 7: err = launch_fmt<uint32_t, -1, -1>(A, b, g, O, W, ep, M, K, N, splits, tile_m, rt_e, rt_m, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The tensor-core path: fmt_code 1-4 at any M >= 1.  asplit: 2 * M * K
// floats of scratch for the split activation.  splits > 1 needs k_chunk a
// multiple of 32 with (splits - 1) * k_chunk < K, and ws as above.
// promote = 0 keeps the whole K sweep in the mma accumulator (for
// measuring what the promotion buys; the serving path passes 1).  a_code:
// the activation's format as in qmm_launch, decoded in qmm_split_a.
extern "C" int qmm_tc_launch(const void* a, void* asplit, const void* b,
                             const void* g, const void* bias, void* out,
                             void* ws, int M, int K, int N, int splits,
                             int k_chunk, int fmt_code, int act, int out_e,
                             int out_m, int promote, int a_code, int a_e,
                             int a_m, void* stream) {
  if (M < 1 || asplit == nullptr || splits < 1 || k_chunk < 1 ||
      (splits > 1 && (ws == nullptr || k_chunk % kTcBK != 0 ||
                      (long long)(splits - 1) * k_chunk >= K)))
    return (int)cudaErrorInvalidValue;
  if (splits == 1) k_chunk = K > 0 ? K : 1;
  float* AS = static_cast<float*>(asplit);
  const float* bs = static_cast<const float*>(bias);
  float* O = static_cast<float*>(out);
  float* W = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt_code) {
    case 1: return qmm_tc_fmt1(a, AS, b, g, bs, O, W, M, K, N, splits, k_chunk, act, out_e, out_m, promote, a_code, a_e, a_m, s);
    case 2: return qmm_tc_fmt2(a, AS, b, g, bs, O, W, M, K, N, splits, k_chunk, act, out_e, out_m, promote, a_code, a_e, a_m, s);
    case 3: return qmm_tc_fmt3(a, AS, b, g, bs, O, W, M, K, N, splits, k_chunk, act, out_e, out_m, promote, a_code, a_e, a_m, s);
    case 4: return qmm_tc_fmt4(a, AS, b, g, bs, O, W, M, K, N, splits, k_chunk, act, out_e, out_m, promote, a_code, a_e, a_m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The MoE expert product (qmm_tc_grouped above), one kernel a call: a
// (E, C, K) f32, b and g (E, K, N) in fmt_code 1-4 (g NULL: ungated),
// rows (E,) int32, out (E, C, N) f32; act, out_e, out_m: the epilogue as
// qmm_tc_launch's.  splits > 1 needs ws ((g ? 2 : 1) * splits * E * C * N
// floats), counts (E * ceil(C / tile) * ceil(N / (g ? 64 : 128)) ints,
// all 0, which the kernel leaves at 0; tile = 16, 32 or 64 by C), k_chunk
// a multiple of 32 and (splits - 1) * k_chunk < K.  n_sm: the card's SMs.
extern "C" int qmm_tc_grouped_launch(const void* a, const void* b,
                                     const void* g, void* out, void* ws,
                                     void* counts, const void* rows,
                                     int n_exp, int C, int K, int N,
                                     int splits, int k_chunk, int fmt_code,
                                     int act, int out_e, int out_m, int n_sm,
                                     void* stream) {
  if (n_exp < 1 || C < 1 || K < 1 || N < 1 || n_sm < 1 || a == nullptr ||
      b == nullptr || out == nullptr || rows == nullptr || splits < 1 ||
      k_chunk < 1 || act < 0 || act > 3 ||
      (splits > 1 && (ws == nullptr || counts == nullptr ||
                      k_chunk % kTcBK != 0 ||
                      (long long)(splits - 1) * k_chunk >= K)))
    return (int)cudaErrorInvalidValue;
  if (splits == 1) k_chunk = K;
  const float* A = static_cast<const float*>(a);
  float* O = static_cast<float*>(out);
  float* W = static_cast<float*>(ws);
  int* CN = static_cast<int*>(counts);
  const int* R = static_cast<const int*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt_code) {
    case 1: return qmm_tc_grouped_fmt1(A, b, g, O, W, CN, R, n_exp, C, K, N, splits, k_chunk, act, out_e, out_m, n_sm, s);
    case 2: return qmm_tc_grouped_fmt2(A, b, g, O, W, CN, R, n_exp, C, K, N, splits, k_chunk, act, out_e, out_m, n_sm, s);
    case 3: return qmm_tc_grouped_fmt3(A, b, g, O, W, CN, R, n_exp, C, K, N, splits, k_chunk, act, out_e, out_m, n_sm, s);
    case 4: return qmm_tc_grouped_fmt4(A, b, g, O, W, CN, R, n_exp, C, K, N, splits, k_chunk, act, out_e, out_m, n_sm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#elif QMM_TC_UNIT  // the launchers of one packed format

#if QMM_UNIT == 1
#define QMM_TC_FN qmm_tc_fmt1
#define QMM_GROUPED_FN qmm_tc_grouped_fmt1
#define QMM_TC_FMT uint8_t, 5, 2      // binary8
#elif QMM_UNIT == 2
#define QMM_TC_FN qmm_tc_fmt2
#define QMM_GROUPED_FN qmm_tc_grouped_fmt2
#define QMM_TC_FMT uint8_t, 4, 3      // binary8alt
#elif QMM_UNIT == 3
#define QMM_TC_FN qmm_tc_fmt3
#define QMM_GROUPED_FN qmm_tc_grouped_fmt3
#define QMM_TC_FMT uint16_t, 5, 10    // binary16
#elif QMM_UNIT == 4
#define QMM_TC_FN qmm_tc_fmt4
#define QMM_GROUPED_FN qmm_tc_grouped_fmt4
#define QMM_TC_FMT uint16_t, 8, 7     // binary16alt
#endif

extern "C" int QMM_TC_FN(QMM_TC_PARAMS) {
  const Epilogue ep{bias, act, out_e, out_m, g != nullptr};
  return (int)launch_tc<QMM_TC_FMT>(a, asplit, b, g, out, ws, ep, M, K, N,
                                    splits, k_chunk, promote, a_code, a_e,
                                    a_m, stream);
}

extern "C" int QMM_GROUPED_FN(QMM_GROUPED_PARAMS) {
  const Epilogue ep{nullptr, act, out_e, out_m, g != nullptr};
  return (int)launch_grouped<QMM_TC_FMT>(a, b, g, out, ws, counts, rows, ep,
                                         n_exp, C, K, N, splits, k_chunk,
                                         n_sm, stream);
}

#elif QMM_UNIT == 5  // qmm_tile for binary32 / f32 weights

extern "C" int qmm_tile_f32(QMM_TILE_PARAMS) {
  const Epilogue ep{bias, act, out_e, out_m, g != nullptr};
  if (fmt_code != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_tile<uint32_t, 8, 23>(a, b, g, out, ws, ep, M, K, N,
                                           splits, tile_m, rt_e, rt_m,
                                           stream);
}

#elif QMM_UNIT == 6  // qmm_tile for the run-time (e, m) formats

extern "C" int qmm_tile_rt(QMM_TILE_PARAMS) {
  const Epilogue ep{bias, act, out_e, out_m, g != nullptr};
  switch (fmt_code) {
    case 5: return (int)launch_tile<uint8_t, -1, -1>(a, b, g, out, ws, ep, M, K, N, splits, tile_m, rt_e, rt_m, stream);
    case 6: return (int)launch_tile<uint16_t, -1, -1>(a, b, g, out, ws, ep, M, K, N, splits, tile_m, rt_e, rt_m, stream);
    case 7: return (int)launch_tile<uint32_t, -1, -1>(a, b, g, out, ws, ep, M, K, N, splits, tile_m, rt_e, rt_m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // QMM_UNIT
