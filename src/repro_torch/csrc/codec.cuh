// The transprecision codec as CUDA __device__ functions.
//
// The same bit math as repro_torch/kernels/codec.py (the plain version the
// CPU tests hold bit-identical to the JAX codec, repro/kernels/codec.py):
// quantize (RNE to (e, m) with gradual underflow and Inf/NaN, or
// stochastic rounding in the normal range with a random word), encode
// (exact member of (e, m) -> packed field) and decode (packed field ->
// exact f32).  All three kernels (qmm.cu, paged_decode.cu,
// flash_prefill.cu) include this header and decode their packed tiles in
// registers through decode_bits().  The subnormal paths are integer-only,
// so the result does not depend on the FTZ/DAZ mode a kernel compiles
// with.  When (e, m) are compile-time constants (the kernels' template
// parameters), the compiler folds the format arithmetic away.
#pragma once

#include <cuda_fp16.h>

#include <cstdint>

namespace codec {

constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kMag = 0x7fffffffu;
constexpr uint32_t kExp = 0x7f800000u;
constexpr uint32_t kMant = 0x007fffffu;
constexpr uint32_t kQNaN = 0x7fc00000u;
constexpr uint32_t kInf = 0x7f800000u;
constexpr uint32_t kQuiet = 0x00400000u;
constexpr uint32_t kOne = 0x00800000u;

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// f32 bit pattern of i * 2^qe for integers 0 <= i < 2^24, with no FP
// arithmetic on possibly-denormal values.
__device__ __forceinline__ uint32_t int_times_pow2_bits(uint32_t i, int qe) {
  if (i == 0u) return 0u;
  const uint32_t thresh = 1u << imax(0, imin(-126 - qe, 23));
  if (i >= thresh) {
    // float(i) is exact (i < 2^24); add qe to its biased exponent
    return __float_as_uint(__uint2float_rn(i)) + (uint32_t)(qe * (1 << 23));
  }
  return i << imax(qe + 149, 0);
}

// Packed (e, m) field -> exact f32.  e == 8, m == 23 is binary32 (bitcast).
__device__ __forceinline__ float decode_bits(uint32_t b, int e, int m) {
  if (e == 8 && m == 23) return __uint_as_float(b);
  const int bias = (1 << (e - 1)) - 1;
  const int qe = (1 - bias) - m;
  const uint32_t sign = ((b >> (e + m)) & 1u) << 31;
  const uint32_t exp_t = (b >> m) & ((1u << e) - 1u);
  const uint32_t mant_t = b & ((1u << m) - 1u);
  uint32_t mag;
  if (exp_t == (1u << e) - 1u) {
    mag = kExp | (mant_t != 0u ? kQuiet : 0u);
  } else if (exp_t == 0u) {
    mag = int_times_pow2_bits(mant_t, qe);
  } else {
    mag = ((uint32_t)((int)exp_t - bias + 127) << 23) | (mant_t << (23 - m));
  }
  return __uint_as_float(sign | mag);
}

__device__ __forceinline__ float canonical_nan(uint32_t sign_bit) {
  return __uint_as_float((sign_bit << 31) | kQNaN);
}

// decode_bits() specialised at compile time: E, M >= 0 name the format,
// E < 0 takes (rt_e, rt_m) at run time.  The formats with a hardware
// conversion decode through it, which is exact for every finite value
// (subnormals included) and for +/-Inf; NaN is canonicalized as in
// decode_bits (sign kept, quiet bit only), so the result is bit-identical.
template <int E, int M>
__device__ __forceinline__ float decode_t(uint32_t b, int rt_e, int rt_m) {
  if constexpr (E == 8 && M == 23) {
    return __uint_as_float(b);
  } else if constexpr (E == 8 && M == 7) {        // bf16: an f32's top half
    const float f = __uint_as_float(b << 16);
    return f != f ? canonical_nan((b >> 15) & 1u) : f;
  } else if constexpr (E == 5 && M == 10) {       // IEEE half
    const float f = __half2float(__ushort_as_half((unsigned short)b));
    return f != f ? canonical_nan((b >> 15) & 1u) : f;
  } else if constexpr (E == 5 && M == 2) {        // e5m2: a half's top byte
    const float f = __half2float(__ushort_as_half((unsigned short)(b << 8)));
    return f != f ? canonical_nan((b >> 7) & 1u) : f;
  } else if constexpr (E < 0) {
    return decode_bits(b, rt_e, rt_m);
  } else {
    return decode_bits(b, E, M);
  }
}

// f32 -> nearest member of (e, m) (RNE), IEEE overflow to +/-Inf (or to
// +/-max_normal with saturate), gradual underflow, canonical quiet NaN.
// With kSR, stochastic rounding in the normal range: the increment added
// below the cut is the top (23 - m) bits of the random word r instead of
// RNE's half-ulp (the reference's jax.random.bits(...) >> (32 - shift),
// repro/kernels/codec.py:93-98); below the normal range it stays RNE, as
// in the reference.
template <bool kSR>
__device__ __forceinline__ float quantize_core(float x, int e, int m,
                                               bool saturate, uint32_t r) {
  if (e == 8 && m == 23) return x;
  const int bias = (1 << (e - 1)) - 1;
  const int emax = bias, emin = 1 - bias, qe = emin - m;
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign = u & kSign;
  const uint32_t mag = u & kMag;
  const int ef = (int)(mag >> 23);
  if (ef == 255) {
    return __uint_as_float(sign | ((mag & kMant) != 0u ? kQNaN : kInf));
  }
  if (ef - 127 < emin) {
    // subnormal in the target: integer RNE of sig * 2^exp2 to quantum 2^qe
    const uint32_t mant_f = mag & kMant;
    const uint32_t sig = ef > 0 ? (mant_f | kOne) : mant_f;
    const int exp2 = imax(ef, 1) - 150;
    const int s_amt = imin(imax(qe - exp2, 1), 25);
    const uint32_t half = 1u << (s_amt - 1);
    const uint32_t rem = sig & ((1u << s_amt) - 1u);
    uint32_t out_i = sig >> s_amt;
    if (rem > half || (rem == half && (out_i & 1u))) out_i += 1u;
    return __uint_as_float(sign | int_times_pow2_bits(out_i, qe));
  }
  const int shift = 23 - m;
  uint32_t mag_r = mag;
  if (shift > 0) {
    uint32_t rnd;
    if constexpr (kSR) {
      rnd = r >> (32 - shift);
    } else {
      rnd = ((1u << (shift - 1)) - 1u) + ((mag >> shift) & 1u);
    }
    mag_r = (mag + rnd) & ~((1u << shift) - 1u);
  }
  if ((int)(mag_r >> 23) > emax + 127) {
    const uint32_t max_bits = ((uint32_t)(emax + 127) << 23) |
                              (((1u << m) - 1u) << (23 - m));
    mag_r = saturate ? max_bits : kInf;
  }
  return __uint_as_float(sign | mag_r);
}

__device__ __forceinline__ float quantize_value(float x, int e, int m,
                                                bool saturate) {
  return quantize_core<false>(x, e, m, saturate, 0u);
}

// Stochastic rounding with the random word r (one a value).
__device__ __forceinline__ float quantize_value_sr(float x, int e, int m,
                                                   bool saturate,
                                                   uint32_t r) {
  return quantize_core<true>(x, e, m, saturate, r);
}

// Exact member of (e, m) -> packed field (low 1 + e + m bits).
__device__ __forceinline__ uint32_t encode_value(float x, int e, int m) {
  if (e == 8 && m == 23) return __float_as_uint(x);
  const int bias = (1 << (e - 1)) - 1;
  const int emin = 1 - bias, qe = emin - m;
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign_t = (u >> 31) << (e + m);
  const uint32_t mag = u & kMag;
  const int ef = (int)(mag >> 23);
  const uint32_t mant_f = mag & kMant;
  uint32_t field;
  if (ef == 255) {
    field = (((1u << e) - 1u) << m) | (mant_f != 0u ? (1u << (m - 1)) : 0u);
  } else if (ef - 127 < emin) {
    const uint32_t sig = ef > 0 ? (mant_f | kOne) : mant_f;
    const int exp2 = imax(ef, 1) - 150;
    const int s_amt = imin(imax(qe - exp2, 0), 31);
    field = sig >> s_amt;
  } else {
    field = ((uint32_t)(ef - 127 + bias) << m) | (mant_f >> (23 - m));
  }
  return sign_t | field;
}

}  // namespace codec
