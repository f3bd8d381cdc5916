"""FlexFloat sanitization: bit-exact rounding of f32 values to (e, m).

The port's copy of ``repro.core.flexfloat``.  The bit manipulation lives in
:func:`repro_torch.kernels.codec.quantize_tile`; this module is the
FlexFloat-semantics API on top of it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.codec import quantize_tile

from .formats import FpFormat, get_format


def quantize(x: torch.Tensor, fmt: Union[FpFormat, str], *,
             saturate: bool = False,
             rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sanitize ``x`` (any float dtype) to format ``fmt``; returns float32.

    saturate: clamp overflow to +/-max_normal instead of +/-Inf.
    rbits: uniform u32 random bits, one per element, for stochastic
        rounding in the normal range (the reference draws them from a JAX
        key inside the call; the port takes them explicitly).
    """
    fmt = get_format(fmt)
    x = torch.as_tensor(x)
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    if fmt.is_binary32:
        return x
    return quantize_tile(x, fmt.e, fmt.m, saturate, rbits)
