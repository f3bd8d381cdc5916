"""binary8 (e5m2) gradient compression with error feedback: the port of
``repro.optim.grad_compress``'s single-device half.

:func:`compress` rounds ``g + residual`` to the format (round to
nearest even) and packs it into the format's container; the new
residual is what the rounding lost, so the time-averaged transmitted
signal tracks the true gradient.
:func:`decompress` unpacks.  On a CUDA tensor the round and the pack are
the ``flexfloat_cast`` kernels; on a CPU tensor their plain versions.
The reductions over devices (``compressed_psum`` and the all-gather
form) come with multi-device training.
"""
from __future__ import annotations

import torch

from repro_torch.core.flexfloat import quantize
from repro_torch.core.formats import BINARY8, FpFormat
from repro_torch.core.qtensor import decode, encode


@torch.no_grad()
def compress(g, residual, fmt: FpFormat = BINARY8):
    """Returns ``(packed_payload, new_residual)``; ``residual`` None
    starts the error feedback at zero.  Rounds to nearest even (the
    reference's ``key=None``)."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    q = quantize(gf, fmt)
    return encode(q, fmt, assume_quantized=True), gf - q


@torch.no_grad()
def decompress(payload, fmt: FpFormat = BINARY8) -> torch.Tensor:
    return decode(payload, fmt)
