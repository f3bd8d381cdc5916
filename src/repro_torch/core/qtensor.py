"""Packed narrow-format tensor storage.

The port's copy of ``repro.core.qtensor``: a :class:`QTensor` keeps the
exact (e, m) bit pattern of every element in the narrowest unsigned
container (uint8/uint16/uint32) plus the format, and
``decode(encode(x)) == quantize(x)`` bit for bit.  On a CUDA tensor the
codec runs as the ``quantize_encode`` / ``dequantize_decode`` kernels
(``kernels/flexfloat_cast.py``; on a ``meta`` tensor their shape route),
on a CPU tensor as their plain versions (``kernels/codec.py``).  For the
formats with a native torch dtype,
``to_native`` / ``from_native`` reinterpret the payload (paper flow step
5), and ``pack_words`` / ``unpack_words`` give the FPU's 32-bit vector
word layout.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels._route import route
from repro_torch.kernels.codec import (decode_tile, encode_tile,
                                       pack_word_tile, unpack_word_tile)
from repro_torch.kernels.flexfloat_cast import (dequantize_decode,
                                                quantize_encode)

from .flexfloat import quantize
from .formats import _NATIVE, FpFormat, get_format


def encode(x: torch.Tensor, fmt: Union[FpFormat, str], *,
           assume_quantized: bool = False) -> torch.Tensor:
    """Pack f32 values into the (e, m) bit field (uint8/16/32 container).

    A tensor that already has ``fmt``'s native torch dtype holds exact
    members of the format, so its container is a bitcast of it (bit-
    identical to round + pack, and free of the codec's int64
    temporaries on multi-GB weight matrices); so is binary32.  Any other
    CUDA tensor takes the fused round + pack kernel (rounding a member of
    the format is the identity, so ``assume_quantized`` changes nothing
    there)."""
    fmt = get_format(fmt)
    if fmt.native_dtype is not None and x.dtype == fmt.native_dtype:
        return x.contiguous().view(fmt.container_dtype)
    if route(x) != "cpu":              # the kernel, or its shape route
        if fmt.is_binary32:
            return x.to(torch.float32).contiguous().view(torch.uint32)
        return quantize_encode(x, fmt)
    if not assume_quantized:
        x = quantize(x, fmt)
    return encode_tile(x, fmt)


def decode(bits: torch.Tensor, fmt: Union[FpFormat, str]) -> torch.Tensor:
    """Exact expansion of packed (e, m) bit fields to float32."""
    fmt = get_format(fmt)
    if route(bits) != "cpu":           # the kernel, or its shape route
        if fmt.is_binary32:
            return bits.contiguous().view(torch.float32)
        return dequantize_decode(bits, fmt)
    return decode_tile(bits, fmt)


class QTensor:
    """A tensor stored in packed (e, m) format."""

    def __init__(self, payload: torch.Tensor, fmt: FpFormat):
        self.payload = payload
        self.fmt = get_format(fmt)

    @classmethod
    def quantize(cls, x, fmt, **kw):
        fmt = get_format(fmt)
        if kw:
            x = quantize(x, fmt, **kw)
            return cls(encode(x, fmt, assume_quantized=True), fmt)
        return cls(encode(x, fmt), fmt)

    def dequantize(self) -> torch.Tensor:
        return decode(self.payload, self.fmt)

    def to_native(self) -> torch.Tensor:
        """Reinterpret the payload as the matching native dtype."""
        nd = self.fmt.native_dtype
        if nd is None:
            raise ValueError(f"{self.fmt} has no native torch dtype")
        return self.payload.view(nd)

    @classmethod
    def from_native(cls, x: torch.Tensor) -> "QTensor":
        rev = {dt: FpFormat(e, m) for (e, m), dt in _NATIVE.items()}
        if x.dtype not in rev:
            raise ValueError(f"{x.dtype} is no native dtype of a format "
                             f"(the port has {sorted(map(str, rev))})")
        fmt = rev[x.dtype]
        return cls(x.view(fmt.container_dtype), fmt)

    @property
    def shape(self):
        return self.payload.shape

    @property
    def nbytes(self) -> int:
        return self.payload.numel() * self.payload.element_size()

    def __repr__(self):  # pragma: no cover
        return f"QTensor({tuple(self.payload.shape)}, {self.fmt.name})"


def pack_words(payload: torch.Tensor) -> torch.Tensor:
    """Pack a uint8/uint16 payload into uint32 words along the last axis --
    the FPU's 4x8b / 2x16b word layout.  Requires divisibility."""
    return pack_word_tile(payload)


def unpack_words(words: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`pack_words`."""
    return unpack_word_tile(words, dtype)
