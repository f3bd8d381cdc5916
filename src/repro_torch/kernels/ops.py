"""Public wrappers around the kernels, with the plain oracle path: the
port of ``repro.kernels.ops``.

``use_pallas`` keeps the reference's spelling and default (True).  With
it, a CUDA tensor goes to the package's CUDA kernel (``flexfloat_cast``,
``quantize_encode``, ``dequantize_decode``, ``qmatmul``); with
``use_pallas=False`` it goes to ``kernels/ref.py``.  A CPU tensor takes
the plain version either way, as every wrapper of the port does.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.formats import get_format

from . import ref
from .flexfloat_cast import dequantize_decode, flexfloat_cast, quantize_encode
from .qmatmul import qmatmul


def cast(x, fmt, *, saturate: bool = False, use_pallas: bool = True):
    """Sanitize to (e, m); f32 in and out."""
    fmt = get_format(fmt)
    if use_pallas:
        return flexfloat_cast(x, fmt, saturate=saturate)
    return ref.flexfloat_cast_ref(x, fmt, saturate=saturate)


def pack(x, fmt, *, use_pallas: bool = True):
    """Fused sanitize + pack into the narrow container."""
    fmt = get_format(fmt)
    if use_pallas:
        return quantize_encode(x, fmt)
    return ref.quantize_encode_ref(x, fmt)


def unpack(payload, fmt, *, use_pallas: bool = True):
    fmt = get_format(fmt)
    if use_pallas:
        return dequantize_decode(payload, fmt)
    return ref.dequantize_ref(payload, fmt)


def matmul(a_payload, b_payload, fmt_a=None, fmt_b=None,
           out_fmt: Optional[str] = None, *, use_pallas: bool = True):
    """Transprecision matmul on packed operands, f32 accumulation.  The
    CUDA kernel takes f32 activations (``fmt_a=None``) or packed ones,
    which it decodes itself."""
    if use_pallas:
        return qmatmul(a_payload, b_payload, fmt_a, fmt_b, out_fmt)
    return ref.qmatmul_ref(a_payload, b_payload, fmt_a, fmt_b, out_fmt)
