"""Packed narrow-format tensor storage.

The port's copy of ``repro.core.qtensor``: a :class:`QTensor` keeps the
exact (e, m) bit pattern of every element in the narrowest unsigned
container (uint8/uint16/uint32) plus the format, and
``decode(encode(x)) == quantize(x)`` bit for bit.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels.codec import decode_tile, encode_tile

from .flexfloat import quantize
from .formats import FpFormat, get_format


def encode(x: torch.Tensor, fmt: Union[FpFormat, str], *,
           assume_quantized: bool = False) -> torch.Tensor:
    """Pack f32 values into the (e, m) bit field (uint8/16/32 container).

    A tensor that already has ``fmt``'s native torch dtype holds exact
    members of the format, so its container is a bitcast of it (bit-
    identical to round + pack, and free of the codec's int64
    temporaries on multi-GB weight matrices)."""
    fmt = get_format(fmt)
    if fmt.native_dtype is not None and x.dtype == fmt.native_dtype:
        return x.contiguous().view(fmt.container_dtype)
    if not assume_quantized:
        x = quantize(x, fmt)
    return encode_tile(x, fmt)


def decode(bits: torch.Tensor, fmt: Union[FpFormat, str]) -> torch.Tensor:
    """Exact expansion of packed (e, m) bit fields to float32."""
    return decode_tile(bits, get_format(fmt))


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

    @property
    def shape(self):
        return self.payload.shape

    @property
    def nbytes(self) -> int:
        return self.payload.numel() * self.payload.element_size()

    def __repr__(self):  # pragma: no cover
        return f"QTensor({tuple(self.payload.shape)}, {self.fmt.name})"
