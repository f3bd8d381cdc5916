"""FlexFloat sanitization: bit-exact rounding of f32 values to (e, m).

The port's copy of ``repro.core.flexfloat``: :func:`quantize` and the
transprecision operators on top of it.  A CUDA tensor goes to the
``flexfloat_cast`` kernel (``kernels/flexfloat_cast.py``); a CPU tensor
to its plain version, :func:`repro_torch.kernels.codec.quantize_tile`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels._route import route
from repro_torch.kernels.codec import quantize_tile
from repro_torch.kernels.flexfloat_cast import flexfloat_cast

from .formats import FpFormat, get_format


def quantize(x: torch.Tensor, fmt: Union[FpFormat, str], *,
             saturate: bool = False,
             rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sanitize ``x`` (any float dtype) to format ``fmt``; returns float32.

    saturate: clamp overflow to +/-max_normal instead of +/-Inf.
    rbits: uniform u32 random bits, one per element, for stochastic
        rounding in the normal range (the reference draws them from a JAX
        key inside the call; the port takes them explicitly).  On a CUDA
        tensor the cast kernel reads them (``flexfloat_cast_sr_launch``).
    """
    fmt = get_format(fmt)
    x = torch.as_tensor(x)
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    if route(x) != "cpu":              # the kernel, or its shape route
        if rbits is None:
            return flexfloat_cast(x, fmt, saturate=saturate)
        return flexfloat_cast(x, fmt, saturate=saturate, rbits=rbits)
    return quantize_tile(x, fmt.e, fmt.m, saturate, rbits)


def quantize_pytree(tree, fmt, **kw):
    """Apply :func:`quantize` to every floating leaf of a tree of dicts,
    lists and tuples; other leaves pass through."""
    fmt = get_format(fmt)
    if isinstance(tree, dict):
        return {k: quantize_pytree(v, fmt, **kw) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_pytree(v, fmt, **kw) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return quantize(tree, fmt, **kw)
    return tree


# ---------------------------------------------------------------------------
# Transprecision arithmetic (FlexFloat operator semantics): each op computes
# in the f32 container and sanitizes the result to the *output* format.
# Operands must already be members of their formats (every producer
# quantizes), as in FlexFloat's strict typing.
# ---------------------------------------------------------------------------

def ff_add(a, b, fmt, **kw):
    return quantize(a + b, fmt, **kw)


def ff_sub(a, b, fmt, **kw):
    return quantize(a - b, fmt, **kw)


def ff_mul(a, b, fmt, **kw):
    return quantize(a * b, fmt, **kw)


def ff_div(a, b, fmt, **kw):
    return quantize(a / b, fmt, **kw)


def ff_fma(a, b, c_, fmt, **kw):
    # the paper's FPU has no fused 8/16-bit FMA: mul -> round -> add ->
    # round, what two slice ops produce
    return quantize(quantize(a * b, fmt, **kw) + c_, fmt, **kw)


def ff_cast(x, src_fmt, dst_fmt, **kw):
    """Explicit cast between formats (a value exact in ``src_fmt`` needs
    only the rounding to ``dst_fmt``)."""
    del src_fmt
    return quantize(x, dst_fmt, **kw)


def quantization_error(x, fmt):
    """|x - Q(x)|."""
    return torch.abs(x - quantize(x, fmt))
