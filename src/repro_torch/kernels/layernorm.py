"""layernorm in one summation order fixed by d alone: the CUDA kernel
(``layernorm_launch`` in ``csrc/rmsnorm.cu``) and its plain PyTorch twin.

A port-only kernel, as rmsnorm's: the reference computes layernorm in
XLA (``repro/models/layers.py:228``), and torch's CUDA reductions order
their sums by the shape of the whole tensor, so without a fixed order a
verify row and a decode row of a layernorm model normalize to different
bits.

Both versions compute the reference's formula for each row of d values,
in f32 with every op rounded to nearest, each row sum in rmsnorm's order
(128 strided partials added to 0 in sequence, then the halving tree:
``rmsnorm.row_mean_plain``):

* ``mu = sum(x) / d``;
* ``var = sum((x - mu)^2) / d``, a second pass (not E[x^2] - mu^2);
* ``y = ((x - mu) * (1 / sqrt(var + eps))) * gamma + beta``.

:func:`layernorm_f32` launches the kernel on a CUDA tensor and runs
:func:`layernorm_plain` on a CPU one.  It returns f32; the caller applies
the policy's activation cast.
"""
from __future__ import annotations

import torch

from . import _build
from .rmsnorm import LIB, norm_operands, row_mean_plain


def layernorm_plain(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """The twin, in the kernel's order."""
    xf = x.to(torch.float32)
    c = xf - row_mean_plain(xf)
    r = 1.0 / torch.sqrt(row_mean_plain(c * c) + eps)
    return (c * r) * gamma.to(torch.float32) + beta.to(torch.float32)


def layernorm_f32(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """layernorm of ``x`` (..., d) with ``gamma``, ``beta`` (d,), as f32:
    the kernel on a CUDA tensor (one launch), the twin on a CPU one."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    x, (g, b), y, rows = norm_operands("layernorm", x, gamma=gamma,
                                       beta=beta)
    if rows == 0:
        return y
    LIB.launch("layernorm_launch", _build.ptr(x), _build.ptr(g),
               _build.ptr(b), _build.ptr(y), rows, x.shape[-1], float(eps),
               int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device),
               kernel="layernorm")
    return y


def layernorm_hbm_bytes(rows: int, d: int, in_bytes: int) -> int:
    """Bytes one call must move: x read once, gamma and beta (f32) read
    once, y (f32) written once."""
    return rows * d * (in_bytes + 4) + 2 * d * 4
