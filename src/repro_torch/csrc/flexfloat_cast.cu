// flexfloat_cast.cu -- the FlexFloat cast and round path as elementwise
// kernels, hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flexfloat_cast.py, the three Pallas bodies behind
// its one pallas_call (_run_elementwise):
//   _cast_kernel   (flexfloat_cast)     f32 -> f32 rounded to (e, m)
//   _encode_kernel (quantize_encode)    f32 -> rounded, packed container
//   _decode_kernel (dequantize_decode)  container -> exact f32
// All three call codec.cuh, the same bit math every other kernel of the
// port decodes with, so these kernels are also the exhaustive proof that
// the device codec is bit-identical to the plain one (kernels/codec.py).
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once (8 B for cast, 5/6/8 B for pack and unpack) and costs a few dozen
// integer instructions, below the card's integer rate per byte of HBM.
//
// The design, and what it does about that: the TPU kernel tiles a 2-D
// view in (256, 256) VMEM blocks; here the tensor is one flat array of n
// elements and a grid-stride loop walks it, four elements per thread per
// iteration with 16-byte f32 loads or stores (and 4-, 8- or 16-byte
// container accesses) when the wrapper found both pointers aligned, then
// a scalar tail.  Any n works (0-d, 1-d, ragged); the format (e, m) and
// saturate are run-time arguments, so any format get_format accepts runs,
// not only the paper's four.  The container type is a template argument.

#include <cuda_runtime.h>
#include <cstdint>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float cast_one(float x, int e, int m, bool sat) {
  return codec::quantize_value(x, e, m, sat);
}

template <typename T>
__device__ __forceinline__ T encode_one(float x, int e, int m) {
  return (T)codec::encode_value(codec::quantize_value(x, e, m, false), e, m);
}

// Four-element container vectors for the aligned body.
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<uint16_t> { using type = ushort4; };
template <> struct Vec4<uint32_t> { using type = uint4; };

__global__ void __launch_bounds__(kThreads)
cast_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n,
            int e, int m, int sat, int vec) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int64_t i = i0; i < n4; i += stride) {
      float4 v = x4[i];
      v.x = cast_one(v.x, e, m, sat);
      v.y = cast_one(v.y, e, m, sat);
      v.z = cast_one(v.z, e, m, sat);
      v.w = cast_one(v.w, e, m, sat);
      y4[i] = v;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + i0; i < n; i += stride) y[i] = cast_one(x[i], e, m, sat);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, T* __restrict__ y, int64_t n,
              int e, int m, int vec) {
  using V = typename Vec4<T>::type;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    V* y4 = reinterpret_cast<V*>(y);
    for (int64_t i = i0; i < n4; i += stride) {
      const float4 v = x4[i];
      V o;
      o.x = encode_one<T>(v.x, e, m);
      o.y = encode_one<T>(v.y, e, m);
      o.z = encode_one<T>(v.z, e, m);
      o.w = encode_one<T>(v.w, e, m);
      y4[i] = o;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + i0; i < n; i += stride) y[i] = encode_one<T>(x[i], e, m);
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
  cast_kernel<<<grid_for(n, vec, n_sm), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, e, m,
      saturate, vec);
  return (int)cudaGetLastError();
}

// container_bytes selects the output container: 1 u8, 2 u16, 4 u32.
extern "C" int quantize_encode_launch(const void* x, void* y, int64_t n,
                                      int e, int m, int container_bytes,
                                      int vec, int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(x);
  const int g = grid_for(n, vec, n_sm);
  switch (container_bytes) {
    case 1: encode_kernel<uint8_t><<<g, kThreads, 0, s>>>(X, static_cast<uint8_t*>(y), n, e, m, vec); break;
    case 2: encode_kernel<uint16_t><<<g, kThreads, 0, s>>>(X, static_cast<uint16_t*>(y), n, e, m, vec); break;
    case 4: encode_kernel<uint32_t><<<g, kThreads, 0, s>>>(X, static_cast<uint32_t*>(y), n, e, m, vec); break;
    default: return (int)cudaErrorInvalidValue;
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
