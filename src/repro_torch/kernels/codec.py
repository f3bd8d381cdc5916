"""The transprecision codec in plain PyTorch: ONE place where a format's
(e, m, bias) becomes shifts and masks.

The port's copy of ``repro.kernels.codec``.  The same bit math exists once
more, as ``__device__`` functions, in ``repro_torch/csrc/codec.cuh``, which
every CUDA kernel includes; this module is the plain version the CPU tests
hold bit-identical to the JAX codec.

Everything runs on int64 tensors holding the u32 bit pattern: torch has
no ``>>``, ``+`` or ``>`` on ``torch.uint32`` on the CPU.  The subnormal
paths are integer-only, as in the reference, so flush-to-zero settings
on either side cannot matter.

Tile functions
--------------
``quantize_tile(x, e, m)``    f32 -> f32 members of (e, m): RNE (or
                              stochastic from explicit random bits),
                              gradual underflow, Inf/NaN.
``encode_tile(x, fmt)``       already-quantized f32 -> packed (e, m) field
                              in the narrowest unsigned container.
``decode_tile(bits, fmt)``    exact expansion of packed fields to f32.
``encode_fused(x, fmt)``      f32 -> packed field, quantize and encode in
                              one pass: the specialised pack kernel's
                              arithmetic (``csrc/flexfloat_cast.cu``,
                              ``encode_fused``), for the tests.
``tf32_round(x)``             f32 -> nearest TF32 (``cvt.rna``), the
                              tensor-core qmm's activation split.
``pack_word_tile(payload)``   uint8/uint16 lanes -> uint32 words (the
                              FPU's 4 x 8 b / 2 x 16 b vector word).
``unpack_word_tile(w, dt)``   the inverse.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import format_constants, get_format

# ---------------------------------------------------------------------------
# The f32 field masks.  These hex constants appear ONLY in this module.
# ---------------------------------------------------------------------------
SIGN_F32 = 0x8000_0000
MAG_F32 = 0x7FFF_FFFF
EXP_F32 = 0x7F80_0000
MANT_F32 = 0x007F_FFFF
QNAN_F32 = 0x7FC0_0000
INF_F32 = 0x7F80_0000
QUIET_BIT_F32 = 0x0040_0000
IMPLICIT_ONE_F32 = 0x0080_0000

# TF32, the tensor cores' operand format (e8m10): an f32 without its
# low 13 mantissa bits
TF32_DROPPED = 0x1FFF

_I64 = torch.int64
_CHUNK = 1 << 24  # elements per slice of the int64 bit math


def bits32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its u32 bit pattern, held in int64 (0 .. 2^32 - 1)."""
    x = x.to(torch.float32).contiguous()
    return x.view(torch.int32).to(_I64) & 0xFFFF_FFFF


def float32(u: torch.Tensor) -> torch.Tensor:
    """u32 bit pattern (int64 in 0 .. 2^32 - 1) -> f32."""
    signed = torch.where(u >= (1 << 31), u - (1 << 32), u)
    return signed.to(torch.int32).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32``: a finite value past the largest TF32 value
    rounds to Inf; Inf and NaN pass through."""
    u = bits32(x)
    mag = u & MAG_F32
    r = torch.where(mag < INF_F32, (mag + (TF32_DROPPED + 1) // 2)
                    & ~TF32_DROPPED, mag)
    return float32((u & SIGN_F32) | r)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 toward zero (the low 13 mantissa bits dropped)."""
    return float32(bits32(x) & ~TF32_DROPPED)


def _where(c, a, b):
    """``torch.where`` with python-int operands promoted to int64."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=_I64, device=c.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=_I64, device=c.device)
    return torch.where(c, a, b)


# ---------------------------------------------------------------------------
# quantize: f32 -> f32 members of (e, m)
# ---------------------------------------------------------------------------

def _by_chunks(fn, x, *extra):
    """``fn`` over flat slices of at most ``_CHUNK`` elements, so the
    int64 temporaries stay bounded on multi-GB tensors (elementwise, so
    the result is the same as one call)."""
    n = x.numel()
    if n <= _CHUNK:
        return fn(x, *extra)
    flat = [t.reshape(-1) if t is not None else None for t in (x,) + extra]
    outs = [fn(*(t[i:i + _CHUNK] if t is not None else None for t in flat))
            for i in range(0, n, _CHUNK)]
    return torch.cat(outs).reshape(x.shape)


def quantize_tile(x, e: int, m: int, saturate: bool = False,
                  rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round f32 values to format (e, m): RNE, or stochastic rounding in
    the normal range when ``rbits`` (uniform u32 random bits, one per
    element, any integer dtype) is given.  IEEE gradual underflow and
    Inf/NaN semantics.  Returns f32."""
    x = torch.as_tensor(x).to(torch.float32)
    if e == 8 and m == 23:
        return x
    return _by_chunks(lambda xs, rb: _quantize(xs, e, m, saturate, rb), x,
                      rbits)


def _quantize(x, e, m, saturate, rbits):
    c = format_constants(e, m)
    u = bits32(x)
    sign = u & SIGN_F32
    mag = u & MAG_F32
    ef = mag >> 23
    is_naninf = ef == 255
    is_nan = is_naninf & ((mag & MANT_F32) != 0)

    # ---- normal path: integer RNE (or stochastic) at cut `shift` ----------
    shift = c["shift"]
    if shift > 0:
        if rbits is None:
            lsb = (mag >> shift) & 1
            rnd = ((1 << (shift - 1)) - 1) + lsb
        else:
            rnd = (rbits.to(_I64) & 0xFFFF_FFFF) >> (32 - shift)
        mag_r = (mag + rnd) & (~((1 << shift) - 1) & 0xFFFF_FFFF)
    else:
        mag_r = mag
    ovf = (mag_r >> 23) > (c["emax"] + 127)
    over = int(bits32(torch.tensor(c["max_normal"]))) if saturate \
        else INF_F32
    mag_r = _where(ovf, over, mag_r)
    normal = sign | mag_r

    # ---- subnormal path: pure-integer RNE to quantum 2^qe -----------------
    qe = c["qe"]
    mant_f = mag & MANT_F32
    sig = torch.where(ef > 0, mant_f | IMPLICIT_ONE_F32, mant_f)
    exp2 = torch.clamp(ef, min=1) - 150
    s_amt = torch.clamp(qe - exp2, 1, 25)
    half = torch.ones_like(s_amt) << (s_amt - 1)
    rem = sig & ((torch.ones_like(s_amt) << s_amt) - 1)
    out_i = sig >> s_amt
    round_up = (rem > half) | ((rem == half) & ((out_i & 1) == 1))
    out_i = out_i + round_up.to(_I64)
    sub = sign | _int_times_pow2_bits(out_i, qe)

    use_sub = (ef - 127) < c["emin"]
    out = torch.where(use_sub, sub, normal)

    # ---- Inf / NaN ---------------------------------------------------------
    special = sign | _where(is_nan, QNAN_F32, INF_F32)
    out = torch.where(is_naninf, special, out)
    return float32(out)


def _int_times_pow2_bits(i: torch.Tensor, qe: int) -> torch.Tensor:
    """Bit pattern of ``i * 2^qe`` for small non-negative integers ``i``
    (< 2^24) without FP arithmetic: ``bits(float(i)) + (qe << 23)`` for an
    f32-normal result, ``i << (qe + 149)`` for an f32-denormal one."""
    thresh = 1 << max(0, min(-126 - qe, 23))
    norm_bits = bits32(i.to(torch.float32)) + qe * (1 << 23)
    den_bits = i << max(qe + 149, 0)
    b = torch.where(i >= thresh, norm_bits, den_bits)
    return _where(i == 0, 0, b)


# ---------------------------------------------------------------------------
# encode: quantized f32 -> packed (e, m) container bits
# ---------------------------------------------------------------------------

def encode_tile(x, fmt) -> torch.Tensor:
    """Pack f32 values (already exact members of ``fmt``) into the (e, m)
    bit field, in the narrowest unsigned container (uint8/16/32)."""
    fmt = get_format(fmt)
    x = torch.as_tensor(x).to(torch.float32)
    if fmt.is_binary32:
        return bits32(x).to(torch.uint32)
    return _by_chunks(lambda xs: _encode(xs, fmt), x)


def encode_fused(x, fmt) -> torch.Tensor:
    """``encode_tile(quantize_tile(x))`` in one pass on the f32 bits, as
    the pack kernel of a specialised format computes it
    (``csrc/flexfloat_cast.cu``, ``encode_fused``): with e = 8 the
    round to nearest even at bit 23 - m and the NaN field (overflow
    carries into Inf by itself); below 8, NaN, the subnormal branch (an
    integer RNE whose result is the field) and the normal branch with
    its overflow to Inf.  The serving path does not call it; the tests
    hold it bit-identical to the codec."""
    fmt = get_format(fmt)
    x = torch.as_tensor(x).to(torch.float32)
    if fmt.is_binary32:
        return bits32(x).to(torch.uint32)
    return _by_chunks(lambda xs: _encode_fused(xs, fmt), x)


def _encode_fused(x, fmt):
    e, m = fmt.e, fmt.m
    bias = (1 << (e - 1)) - 1
    emin = 1 - bias
    shift = 23 - m
    exp_all = (1 << e) - 1
    nan = (exp_all << m) | (1 << (m - 1))
    u = bits32(x)
    sign_t = (u >> 31) << (e + m)
    mag = u & MAG_F32
    is_nan = mag > INF_F32
    rnd = ((1 << (shift - 1)) - 1) + ((mag >> shift) & 1)
    if e == 8:
        field = torch.where(is_nan, nan, (mag + rnd) >> shift)
    else:
        ef = mag >> 23
        sig = torch.where(ef > 0, (mag & MANT_F32) | IMPLICIT_ONE_F32, mag)
        s_amt = torch.clamp((emin - m) - (torch.clamp(ef, min=1) - 150),
                            1, 25)
        one = torch.ones_like(s_amt)
        half = torch.bitwise_left_shift(one, s_amt - 1)
        rem = sig & (torch.bitwise_left_shift(one, s_amt) - 1)
        out_i = torch.bitwise_right_shift(sig, s_amt)
        out_i = out_i + ((rem > half) | ((rem == half) & ((out_i & 1) == 1))
                         ).to(_I64)
        mag_r = (mag + rnd) & ~((1 << shift) - 1)
        normal = torch.where((mag_r >> 23) > bias + 127, exp_all << m,
                             (mag_r >> shift) - ((127 - bias) << m))
        field = torch.where(is_nan, nan,
                            torch.where(ef < emin + 127, out_i, normal))
    return (sign_t | field).to(fmt.container_dtype)


def _encode(x, fmt):
    c = format_constants(fmt.e, fmt.m)
    u = bits32(x)
    sign_t = (u >> 31) << (fmt.e + fmt.m)
    mag = u & MAG_F32
    ef = mag >> 23
    mant_f = mag & MANT_F32

    exp_t = ef - 127 + c["bias"]
    mant_t = mant_f >> (23 - fmt.m)
    normal = (exp_t << fmt.m) | mant_t

    sig = torch.where(ef > 0, mant_f | IMPLICIT_ONE_F32, mant_f)
    exp2 = torch.clamp(ef, min=1) - 150
    s_amt = torch.clamp(c["qe"] - exp2, 0, 31)
    denorm = sig >> s_amt

    is_naninf = ef == 255
    is_nan = is_naninf & (mant_f != 0)
    special = (((1 << fmt.e) - 1) << fmt.m) | _where(
        is_nan, 1 << (fmt.m - 1), 0)

    use_sub = (ef - 127) < c["emin"]
    field = torch.where(is_naninf, special,
                        torch.where(use_sub, denorm, normal))
    # negative exp_t only arises on the (unused) normal branch of
    # subnormal inputs; mask to the field width before narrowing
    out = (sign_t | field) & ((1 << fmt.bits) - 1)
    return out.to(fmt.container_dtype)


# ---------------------------------------------------------------------------
# decode: packed (e, m) container bits -> exact f32
# ---------------------------------------------------------------------------

def decode_tile(bits: torch.Tensor, fmt) -> torch.Tensor:
    """Exact expansion of packed (e, m) bit fields to float32.  Inf/NaN
    fields decode to +/-Inf and the canonical quiet NaN."""
    fmt = get_format(fmt)
    bits = torch.as_tensor(bits)
    if fmt.is_binary32:
        return float32(bits.to(_I64) & 0xFFFF_FFFF)
    return _by_chunks(lambda bs: _decode(bs, fmt), bits)


def _decode(bits, fmt):
    b = bits.to(_I64) & 0xFFFF_FFFF
    c = format_constants(fmt.e, fmt.m)
    sign = ((b >> (fmt.e + fmt.m)) & 1) << 31
    exp_t = (b >> fmt.m) & ((1 << fmt.e) - 1)
    mant_t = b & fmt.mant_mask

    normal = ((exp_t - c["bias"] + 127) << 23) | (mant_t << (23 - fmt.m))
    denorm = _int_times_pow2_bits(mant_t, c["qe"])

    is_special = exp_t == (1 << fmt.e) - 1
    special = EXP_F32 | _where(mant_t != 0, QUIET_BIT_F32, 0)

    mag = torch.where(is_special, special,
                      torch.where(exp_t == 0, denorm, normal))
    return float32(sign | mag)


# ---------------------------------------------------------------------------
# word packing: 4 x 8 b / 2 x 16 b lanes per u32 (the FPU's vector word)
# ---------------------------------------------------------------------------

def pack_word_tile(payload: torch.Tensor) -> torch.Tensor:
    """Pack a uint8/uint16 payload into uint32 words along the last axis,
    lane i in bits [8 i, 8 i + 8) (16-bit lanes alike): the FPU's 4 x 8 b
    / 2 x 16 b word layout.  Requires divisibility."""
    item = payload.element_size()
    if item == 4:
        return payload.to(torch.uint32)
    lanes = 4 // item
    *lead, n = payload.shape
    if n % lanes:
        raise ValueError(f"pack_word_tile: last axis {n} is not a multiple "
                         f"of {lanes} lanes")
    grouped = payload.to(_I64).reshape(*lead, n // lanes, lanes)
    shifts = torch.arange(lanes, dtype=_I64, device=payload.device) \
        * (8 * item)
    return torch.sum(grouped << shifts, dim=-1).to(torch.uint32)


def unpack_word_tile(words: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`pack_word_tile`: uint32 words -> ``dtype``
    (``torch.uint8`` / ``uint16`` / ``uint32``) lanes."""
    item = dtype.itemsize
    if item == 4:
        return words.to(dtype)
    lanes = 4 // item
    shifts = torch.arange(lanes, dtype=_I64, device=words.device) \
        * (8 * item)
    parts = ((words.to(_I64) & 0xFFFF_FFFF)[..., None] >> shifts) \
        & ((1 << (8 * item)) - 1)
    *lead, n, _ = parts.shape
    return parts.reshape(*lead, n * lanes).to(dtype)
