"""Plain oracles for the kernels' public operations: the port of
``repro.kernels.ref``.

Each kernel wrapper in ``repro_torch.kernels`` must match these bit for
bit (quantization) or to f32 matmul tolerance (qmatmul).  They run the
port's plain codec on whatever device their inputs lie on and never
launch a kernel of this package.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.formats import FpFormat

from .flexfloat_cast import (dequantize_decode_plain, flexfloat_cast_plain,
                             quantize_encode_plain)
from .qmatmul import qmatmul_plain


def flexfloat_cast_ref(x, fmt, *, saturate: bool = False):
    """Oracle for the cast kernel: sanitize f32 -> (e, m), return f32."""
    return flexfloat_cast_plain(x, fmt, saturate=saturate)


def quantize_encode_ref(x, fmt):
    """Oracle for the fused quantize + pack kernel: f32 -> container."""
    return quantize_encode_plain(x, fmt)


def dequantize_ref(payload, fmt):
    return dequantize_decode_plain(payload, fmt)


def qmatmul_ref(a_payload, b_payload, fmt_a: Optional[FpFormat],
                fmt_b: Optional[FpFormat],
                out_fmt: Optional[FpFormat] = None, *, gate_payload=None,
                bias=None, act: Optional[str] = None):
    """Oracle for the transprecision matmul: decode, f32 matmul, the
    kernel's epilogue in its order (bias -> act -> gate -> quantize)."""
    return qmatmul_plain(a_payload, b_payload, fmt_a, fmt_b, out_fmt,
                         gate_payload=gate_payload, bias=bias, act=act)
