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

:func:`add_layernorm` is the layernorm decoder's norm in one launch
(``add_layernorm_launch``), as ``rmsnorm.add_rmsnorm`` is the rmsnorm
decoder's: the residual add before it, layernorm in the order above over
``s`` read from memory once (kept on chip between the sums and the
scale), and the cast to the reading layer's activation dtype.  Its plain version is
those three steps (:func:`add_layernorm_plain`), and the kernel equals it
bit for bit.
"""
from __future__ import annotations

import torch

from . import _build
from ._route import route, shape_route
from .rmsnorm import (LIB, add_rmsnorm_hbm_bytes, fused_norm_diff,
                      launch_fused, norm_flops, norm_operands, residual_add,
                      row_mean_plain)


def layernorm_plain(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """The twin, in the kernel's order."""
    xf = x.to(torch.float32)
    c = xf - row_mean_plain(xf)
    r = 1.0 / torch.sqrt(row_mean_plain(c * c) + eps)
    return (c * r) * gamma.to(torch.float32) + beta.to(torch.float32)


def layernorm_f32(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """layernorm of ``x`` (..., d) with ``gamma``, ``beta`` (d,), as f32:
    the kernel on a CUDA tensor (one launch), the twin on a CPU one."""
    where = route(x)
    if where == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    x, (g, b), y, rows = norm_operands("layernorm", x, gamma=gamma,
                                       beta=beta)
    if where == "meta":
        d = x.shape[-1]
        return shape_route(
            "layernorm", y, flops=norm_flops(rows, d, "layernorm"),
            nbytes=layernorm_hbm_bytes(rows, d, x.element_size()))
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


def add_layernorm_plain(x, y, gamma, beta, out_dtype, eps: float = 1e-5):
    """The plain version: ``s = residual_add(x, y)`` (``s = x`` when
    ``y`` is None), then ``layernorm_plain(s)`` cast to ``out_dtype``.
    Returns ``(s, normed)``."""
    s = x if y is None else residual_add(x, y)
    return s, layernorm_plain(s, gamma, beta, eps).to(out_dtype)


def add_layernorm(x, y, gamma, beta, out_dtype, eps: float = 1e-5):
    """The residual stream ``s = x + y`` and its layernorm in
    ``out_dtype``, ``(s, normed)``: one kernel launch on a CUDA tensor
    (f32, bf16 or f16 operands, ``rmsnorm.fused_norm_takes``; others
    raise), the plain version on a CPU one.  ``y`` None normalizes ``x``
    alone (``s`` is ``x``).  When an operand needs a gradient the launch
    goes through ``rmsnorm.FusedNormFn`` (the same launch; the backward
    recomputes the plain version)."""
    if route(x) == "cpu":
        return add_layernorm_plain(x, y, gamma, beta, out_dtype, eps)
    if _build.needs_grad(x, y, gamma, beta):
        return fused_norm_diff(
            lambda *a: _add_layernorm_cuda(*a, out_dtype, eps),
            lambda *a: add_layernorm_plain(*a, out_dtype, eps), x, y, gamma,
            beta)
    return _add_layernorm_cuda(x, y, gamma, beta, out_dtype, eps)


def _add_layernorm_cuda(x, y, gamma, beta, out_dtype, eps):
    return launch_fused("add_layernorm", x, y, out_dtype, eps, gamma=gamma,
                        beta=beta)


def add_layernorm_hbm_bytes(rows: int, d: int, x_bytes: int, y_bytes: int,
                            res_bytes: int, out_bytes: int) -> int:
    """Bytes one :func:`add_layernorm` must move: ``add_rmsnorm``'s and
    beta (f32) read once."""
    return add_rmsnorm_hbm_bytes(rows, d, x_bytes, y_bytes, res_bytes,
                                 out_bytes) + d * 4
