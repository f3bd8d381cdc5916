"""rmsnorm in one summation order fixed by d alone: the CUDA kernel
(``csrc/rmsnorm.cu``) and its plain PyTorch twin.

A port-only kernel: the reference computes rmsnorm in XLA.  The port
needs a row's bits to be free of the rows beside it (a speculative verify
normalizes 16 rows where a decode step normalizes 4; the engine prefills
in chunks where the synchronous oracle prefills the whole prompt), and
torch's CUDA reduction shapes its summation order by the whole tensor.

Both versions compute, for each row of d values, in f32 with every op
rounded to nearest:

* 128 partial sums, partial t summing ``x[t + 128 j]^2`` over j in
  sequence (the square rounded before the add);
* a halving tree over the partials (64, 32, ..., 1), zeros past d;
* ``ms = total / d``, ``r = 1 / sqrt(ms + eps)``,
  ``y = (x * r) * (1 + gamma)``.

:func:`rmsnorm_f32` launches the kernel on a CUDA tensor and runs
:func:`rmsnorm_plain` on a CPU one.  It returns f32; the caller applies
the policy's activation cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

THREADS = 128   # csrc/rmsnorm.cu kThreads: the partials of a row

LIB = _build.register(_build.KernelLib("rmsnorm", {
    "rmsnorm_launch": [_build.P, _build.P, _build.P, _build.I64, _build.I32,
                       _build.F32, _build.I32, _build.P],
}))


def mean_square_plain(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis in the kernel's order (keepdim).
    ``xf`` is f32."""
    d = xf.shape[-1]
    n = -(-d // THREADS)
    sq = xf * xf
    if n * THREADS != d:
        sq = F.pad(sq, (0, n * THREADS - d))
    sq = sq.reshape(*xf.shape[:-1], n, THREADS)
    acc = sq[..., 0, :]
    for j in range(1, n):
        acc = acc + sq[..., j, :]
    h = THREADS // 2
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    # a tensor divisor: torch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, one ulp off where 1 / d is
    # not exact (d = 5120)
    return acc / torch.full_like(acc, float(d))


def rmsnorm_plain(x, gamma, eps: float = 1e-6) -> torch.Tensor:
    """The twin: f32 ``(x * r) * (1 + gamma)`` in the kernel's order."""
    xf = x.to(torch.float32)
    r = 1.0 / torch.sqrt(mean_square_plain(xf) + eps)
    return (xf * r) * (1.0 + gamma.to(torch.float32))


def rmsnorm_f32(x, gamma, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm of ``x`` (..., d) with ``gamma`` (d,), as f32: the kernel
    on a CUDA tensor (one launch), the twin on a CPU one."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    g = gamma.to(torch.float32).contiguous()
    _build.check_operands("rmsnorm", x.device, x=x, gamma=g)
    if g.shape != (d,):
        raise ValueError(f"rmsnorm: gamma must be ({d},), got "
                         f"{tuple(g.shape)}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    LIB.launch("rmsnorm_launch", _build.ptr(x), _build.ptr(g),
               _build.ptr(y), rows, d, float(eps),
               int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    return y


def rmsnorm_hbm_bytes(rows: int, d: int, in_bytes: int) -> int:
    """Bytes one call must move: x read once, gamma (f32) read once, y
    (f32) written once."""
    return rows * d * (in_bytes + 4) + d * 4
