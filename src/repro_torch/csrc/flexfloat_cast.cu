// flexfloat_cast.cu -- the FlexFloat cast and round path as elementwise
// kernels, hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flexfloat_cast.py, the three Pallas bodies behind
// its one pallas_call (_run_elementwise):
//   _cast_kernel   (flexfloat_cast)     f32 -> f32 rounded to (e, m)
//                  (flexfloat_cast_sr_launch: the same with stochastic
//                  rounding on explicit random words, which the reference
//                  computes as XLA arithmetic in quantize_tile,
//                  repro/kernels/codec.py:93-98, not as a Pallas body)
//   _encode_kernel (quantize_encode)    f32 -> rounded, packed container
//   _decode_kernel (dequantize_decode)  container -> exact f32
// All three call codec.cuh, the same bit math every other kernel of the
// port decodes with, so these kernels are also the exhaustive proof that
// the device codec is bit-identical to the plain one (kernels/codec.py).
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once (8 B for cast, 5/6/8 B for pack and unpack).  The run-time (e, m)
// codec costs a few dozen integer instructions an element, near the
// card's integer rate per byte of HBM, so pack is specialised.
//
// cast and unpack: the TPU kernel tiles a 2-D view in (256, 256) VMEM
// blocks; here the tensor is one flat array of n elements and a
// grid-stride loop walks it, four elements per thread per iteration with
// 16-byte f32 loads or stores (and 4-, 8- or 16-byte container accesses)
// when the wrapper found both pointers aligned, then a scalar tail.  The
// format (e, m) and saturate are run-time arguments, so any format
// get_format accepts runs; the container type is a template argument.
//
// pack (quantize_encode): one kernel per format for the paper's four
// formats -- binary8 (5,2), binary8alt (4,3), binary16 (5,10) and
// binary16alt (8,7) -- and the run-time codec per container for any
// other (e, m); the wrapper picks it by the format alone (fmt_code, as
// qmm's).  A specialised kernel is quantize and encode fused on the f32
// bits with the format's constants folded (encode_fused): binary16alt is
// the f32 round-to-nearest-even at bit 16 with the codec's NaN (overflow
// carries into Inf by itself); the others keep the codec's subnormal
// branch with constant shifts.  Every thread makes one 16-byte store (16
// u8, 8 u16 or 4 u32 containers from 4, 2 or 1 float4 loads) and the
// grid covers the array once, planned by the wrapper
// (kernels/flexfloat_cast.py, encode_plan); a grid of one resident wave
// with a grid-stride loop measured 4 % slower.  A misaligned pointer
// takes one element a thread.  Bit-identical to the codec:
// chip_smoke.py's casts phase holds every kernel to the plain codec on
// every pattern.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float cast_one(float x, int e, int m, bool sat) {
  return codec::quantize_value(x, e, m, sat);
}

// quantize_value then encode_value (codec.cuh) for a compile-time (E, M),
// fused on the f32 bits: the packed field, bit-identical to the codec.
template <int E, int M>
__device__ __forceinline__ uint32_t encode_fused(float x) {
  constexpr int kBias = (1 << (E - 1)) - 1;
  constexpr int kEmin = 1 - kBias, kQe = kEmin - M;
  constexpr int kShift = 23 - M;
  constexpr uint32_t kExpAll = (1u << E) - 1u;
  constexpr uint32_t kNaN = (kExpAll << M) | (1u << (M - 1));
  constexpr uint32_t kInfField = kExpAll << M;
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign_t = (u >> 31) << (E + M);
  const uint32_t mag = u & codec::kMag;
  // round to nearest even at bit kShift
  const uint32_t rnd = ((1u << (kShift - 1)) - 1u) + ((mag >> kShift) & 1u);
  if constexpr (E == 8) {
    // the f32 range: a target subnormal is the same rounding of an f32
    // subnormal, and a finite value that rounds past the largest one
    // carries into the exponent field as Inf
    return sign_t | (mag > codec::kInf ? kNaN : (mag + rnd) >> kShift);
  } else {
    if (mag > codec::kInf) return sign_t | kNaN;
    const int ef = (int)(mag >> 23);
    if (ef < kEmin + 127) {
      // below the normal range: integer RNE of sig * 2^exp2 to quantum
      // 2^qe, which is the field (2^M: the smallest normal)
      const uint32_t sig = ef > 0 ? (mag & codec::kMant) | codec::kOne : mag;
      const int s_amt = codec::imin(codec::imax(kQe - (codec::imax(ef, 1) - 150), 1), 25);
      const uint32_t half = 1u << (s_amt - 1);
      const uint32_t rem = sig & ((1u << s_amt) - 1u);
      uint32_t out_i = sig >> s_amt;
      if (rem > half || (rem == half && (out_i & 1u))) out_i += 1u;
      return sign_t | out_i;
    }
    const uint32_t mag_r = (mag + rnd) & ~((1u << kShift) - 1u);
    if ((int)(mag_r >> 23) > kBias + 127) return sign_t | kInfField;
    return sign_t | ((mag_r >> kShift) - ((uint32_t)(127 - kBias) << M));
  }
}

// One container: the fused kernel for E >= 0, the run-time codec else.
template <typename T, int E, int M>
__device__ __forceinline__ T encode_t(float x, int e, int m) {
  if constexpr (E < 0) {
    return (T)codec::encode_value(codec::quantize_value(x, e, m, false), e,
                                  m);
  } else {
    return (T)encode_fused<E, M>(x);
  }
}

// Four-element container vectors for the aligned body.
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<uint16_t> { using type = ushort4; };
template <> struct Vec4<uint32_t> { using type = uint4; };

// kSR: stochastic rounding, with r[i] the random word of element i (read
// beside x, 16 bytes a thread in the aligned body: 12 bytes an element
// move in all).
template <bool kSR>
__device__ __forceinline__ float cast_t(float x, uint32_t r, int e, int m,
                                        bool sat) {
  if constexpr (kSR) {
    return codec::quantize_value_sr(x, e, m, sat, r);
  } else {
    return cast_one(x, e, m, sat);
  }
}

template <bool kSR>
__global__ void __launch_bounds__(kThreads)
cast_kernel(const float* __restrict__ x, const uint32_t* __restrict__ r,
            float* __restrict__ y, int64_t n, int e, int m, int sat,
            int vec) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int64_t i = i0; i < n4; i += stride) {
      float4 v = x4[i];
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kSR) w = r4[i];
      v.x = cast_t<kSR>(v.x, w.x, e, m, sat);
      v.y = cast_t<kSR>(v.y, w.y, e, m, sat);
      v.z = cast_t<kSR>(v.z, w.z, e, m, sat);
      v.w = cast_t<kSR>(v.w, w.w, e, m, sat);
      y4[i] = v;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + i0; i < n; i += stride)
    y[i] = cast_t<kSR>(x[i], kSR ? r[i] : 0u, e, m, sat);
}

// Thread i of the grid encodes vector trip i (vec = 16 / sizeof(T)
// containers, one 16 B store; both pointers 16 B aligned) when i < n /
// vec, and the tail element n / vec * vec + i when that is below n; with
// vec = 0 it encodes element i.  The grid covers the larger count once
// (kernels/flexfloat_cast.py, encode_plan): no grid-stride loop, so every
// thread's loads are in flight at once.
template <typename T, int E, int M>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, T* __restrict__ y, int64_t n,
              int e, int m, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerWord = 4 / sizeof(T);
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nv = vec ? n / kVec : 0;
  if (i < nv) {
    const float4* x4 = reinterpret_cast<const float4*>(x) + i * (kVec / 4);
    float f[kVec];
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 v = x4[q];
      f[4 * q] = v.x; f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z; f[4 * q + 3] = v.w;
    }
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = 0u;
#pragma unroll
      for (int b = 0; b < kPerWord; ++b)
        w[j] |= (uint32_t)encode_t<T, E, M>(f[j * kPerWord + b], e, m)
                << (8 * sizeof(T) * b);
    }
    reinterpret_cast<uint4*>(y)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int64_t t = nv * kVec + i;
  if (t < n) y[t] = encode_t<T, E, M>(x[t], e, m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ x, float* __restrict__ y, int64_t n,
              int e, int m, int vec) {
  using V = typename Vec4<T>::type;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const V* x4 = reinterpret_cast<const V*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int64_t i = i0; i < n4; i += stride) {
      const V v = x4[i];
      float4 o;
      o.x = codec::decode_bits((uint32_t)v.x, e, m);
      o.y = codec::decode_bits((uint32_t)v.y, e, m);
      o.z = codec::decode_bits((uint32_t)v.z, e, m);
      o.w = codec::decode_bits((uint32_t)v.w, e, m);
      y4[i] = o;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + i0; i < n; i += stride)
    y[i] = codec::decode_bits((uint32_t)x[i], e, m);
}

// Enough blocks to cover n once, capped at 16 per SM (the grid-stride loop
// takes the rest).
int grid_for(int64_t n, int vec, int n_sm) {
  const int64_t items = vec ? (n / 4 + (n % 4)) : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)16 * n_sm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// n elements; e, m the format; vec = 1 when both pointers are aligned for
// the four-element accesses (16 B for f32, 4 * container bytes).
extern "C" int flexfloat_cast_launch(const void* x, void* y, int64_t n,
                                     int e, int m, int saturate, int vec,
                                     int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cast_kernel<false><<<grid_for(n, vec, n_sm), kThreads, 0, s>>>(
      static_cast<const float*>(x), nullptr, static_cast<float*>(y), n, e,
      m, saturate, vec);
  return (int)cudaGetLastError();
}

// The same cast with stochastic rounding: rbits holds one uniform u32 word
// an element (the wrapper's explicit random bits, as the plain version
// quantize_tile(..., rbits) takes them); vec = 1 when x, rbits and y are
// all 16 B aligned.
extern "C" int flexfloat_cast_sr_launch(const void* x, const void* rbits,
                                        void* y, int64_t n, int e, int m,
                                        int saturate, int vec, int n_sm,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cast_kernel<true><<<grid_for(n, vec, n_sm), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(rbits),
      static_cast<float*>(y), n, e, m, saturate, vec);
  return (int)cudaGetLastError();
}

// fmt_code (kernels/_build.py, fmt_code) picks the kernel: 1 binary8,
// 2 binary8alt, 3 binary16, 4 binary16alt (specialised; (e, m) must be
// the format's), 5 / 6 / 7 any other (e, m) in u8 / u16 / u32, 0
// binary32.  vec: 0, or 16 / container bytes with both pointers 16 B
// aligned; blocks: the grid (kernels/flexfloat_cast.py, encode_plan),
// at least max(n / vec, the tail) / 256 blocks, or n / 256 with vec 0.
extern "C" int quantize_encode_launch(const void* x, void* y, int64_t n,
                                      int e, int m, int fmt_code, int vec,
                                      int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(x);
  static const int kSpec[5][3] = {{8, 23, 4}, {5, 2, 1}, {4, 3, 1},
                                  {5, 10, 2}, {8, 7, 2}};
  const int bytes = fmt_code <= 4 ? kSpec[fmt_code < 0 ? 0 : fmt_code][2]
                    : fmt_code == 5 ? 1 : fmt_code == 6 ? 2 : 4;
  if (fmt_code < 0 || fmt_code > 7 || blocks < 1 ||
      (fmt_code >= 1 && fmt_code <= 4 &&
       (e != kSpec[fmt_code][0] || m != kSpec[fmt_code][1])) ||
      (vec != 0 && vec != 16 / bytes))
    return (int)cudaErrorInvalidValue;
  uint8_t* Y8 = static_cast<uint8_t*>(y);
  uint16_t* Y16 = static_cast<uint16_t*>(y);
  uint32_t* Y32 = static_cast<uint32_t*>(y);
  switch (fmt_code) {
    case 1: encode_kernel<uint8_t, 5, 2><<<blocks, kThreads, 0, s>>>(X, Y8, n, e, m, vec); break;
    case 2: encode_kernel<uint8_t, 4, 3><<<blocks, kThreads, 0, s>>>(X, Y8, n, e, m, vec); break;
    case 3: encode_kernel<uint16_t, 5, 10><<<blocks, kThreads, 0, s>>>(X, Y16, n, e, m, vec); break;
    case 4: encode_kernel<uint16_t, 8, 7><<<blocks, kThreads, 0, s>>>(X, Y16, n, e, m, vec); break;
    case 5: encode_kernel<uint8_t, -1, -1><<<blocks, kThreads, 0, s>>>(X, Y8, n, e, m, vec); break;
    case 6: encode_kernel<uint16_t, -1, -1><<<blocks, kThreads, 0, s>>>(X, Y16, n, e, m, vec); break;
    default: encode_kernel<uint32_t, -1, -1><<<blocks, kThreads, 0, s>>>(X, Y32, n, e, m, vec); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int dequantize_decode_launch(const void* x, void* y, int64_t n,
                                        int e, int m, int container_bytes,
                                        int vec, int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* Y = static_cast<float*>(y);
  const int g = grid_for(n, vec, n_sm);
  switch (container_bytes) {
    case 1: decode_kernel<uint8_t><<<g, kThreads, 0, s>>>(static_cast<const uint8_t*>(x), Y, n, e, m, vec); break;
    case 2: decode_kernel<uint16_t><<<g, kThreads, 0, s>>>(static_cast<const uint16_t*>(x), Y, n, e, m, vec); break;
    case 4: decode_kernel<uint32_t><<<g, kThreads, 0, s>>>(static_cast<const uint32_t*>(x), Y, n, e, m, vec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
