"""rmsnorm in one summation order fixed by d alone: the CUDA kernels
(``csrc/rmsnorm.cu``) and their plain PyTorch twins.

A port-only kernel: the reference computes rmsnorm in XLA.  The port
needs a row's bits to be free of the rows beside it (a speculative verify
normalizes 16 rows where a decode step normalizes 4; the engine prefills
in chunks where the synchronous oracle prefills the whole prompt), and
torch's CUDA reduction shapes its summation order by the whole tensor.

Both versions compute, for each row of d values, in f32 with every op
rounded to nearest:

* 128 partial sums, partial t adding ``x[t + 128 j]^2`` over j to 0 in
  sequence (the square rounded before the add);
* a halving tree over the partials (64, 32, ..., 1), zeros past d;
* ``ms = total / d``, ``r = 1 / sqrt(ms + eps)``,
  ``y = (x * r) * (1 + gamma)``.

:func:`rmsnorm_f32` launches the kernel on a CUDA tensor and runs
:func:`rmsnorm_plain` on a CPU one.  It returns f32; the caller applies
the policy's activation cast.

:func:`add_rmsnorm` is the decoder's norm in one launch: the residual
add before it (``residual_add``), rmsnorm in the same order, and the
cast to the reading layer's activation dtype, for f32, bf16 and f16
tensors (``fused_norm_takes``).  Its plain version is those three steps
(:func:`add_rmsnorm_plain`), and the kernel equals it bit for bit.
``kernels/layernorm.add_layernorm`` does the same for layernorm through
:func:`launch_fused`.

Training differentiates the fused norms through :class:`FusedNormFn`: its
forward is the kernel launch, its backward the plain version recomputed
under autograd.  A launch on an operand that needs a gradient outside
it raises (``_build.check_no_grad``), so no gradient is dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._route import route, shape_route

THREADS = 128   # csrc/rmsnorm.cu kThreads: the partials of a row

# one library for both norms (``kernels/layernorm.py`` holds the
# layernorm entry's wrapper); a launch counts under its entry point
LIB = _build.register(_build.KernelLib("rmsnorm", {
    "rmsnorm_launch": [_build.P, _build.P, _build.P, _build.I64, _build.I32,
                       _build.F32, _build.I32, _build.P],
    "layernorm_launch": [_build.P, _build.P, _build.P, _build.P, _build.I64,
                         _build.I32, _build.F32, _build.I32, _build.P],
    "add_rmsnorm_launch": [_build.P] * 5 + [_build.I64, _build.I32,
                                            _build.F32] + [_build.I32] * 4
    + [_build.P],
    "add_layernorm_launch": [_build.P] * 6 + [_build.I64, _build.I32,
                                              _build.F32] + [_build.I32] * 4
    + [_build.P],
}))
# the dtypes add_rmsnorm's kernel reads and writes (csrc/rmsnorm.cu, Dt)
DT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def row_mean_plain(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis in the kernels' order (keepdim): 128
    partials, partial t adding ``v[t + 128 j]`` to 0 in sequence, the
    halving tree, one division by d.  ``v`` is f32."""
    d = v.shape[-1]
    n = -(-d // THREADS)
    if n * THREADS != d:
        v = F.pad(v, (0, n * THREADS - d))
    v = v.reshape(*v.shape[:-1], n, THREADS)
    acc = torch.zeros_like(v[..., 0, :])
    for j in range(n):
        acc = acc + v[..., j, :]
    h = THREADS // 2
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    # a tensor divisor: torch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, one ulp off where 1 / d is
    # not exact (d = 5120)
    return acc / torch.full_like(acc, float(d))


def mean_square_plain(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis in the kernel's order (keepdim).
    ``xf`` is f32."""
    return row_mean_plain(xf * xf)


def rmsnorm_plain(x, gamma, eps: float = 1e-6) -> torch.Tensor:
    """The twin: f32 ``(x * r) * (1 + gamma)`` in the kernel's order."""
    xf = x.to(torch.float32)
    r = 1.0 / torch.sqrt(mean_square_plain(xf) + eps)
    return (xf * r) * (1.0 + gamma.to(torch.float32))


def norm_operands(what: str, x, **params):
    """``x`` as a contiguous f32 or bf16 tensor, each (d,) parameter as
    contiguous f32, the f32 output, and the row count: what a norm kernel
    of this library takes."""
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    ps = {k: p.to(torch.float32).contiguous() for k, p in params.items()}
    _build.check_operands(what, x.device, x=x, **ps)
    for k, p in ps.items():
        if p.shape != (d,):
            raise ValueError(f"{what}: {k} must be ({d},), got "
                             f"{tuple(p.shape)}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return x, list(ps.values()), y, (x.numel() // d if d else 0)


def rmsnorm_f32(x, gamma, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm of ``x`` (..., d) with ``gamma`` (d,), as f32: the kernel
    on a CUDA tensor (one launch), the twin on a CPU one."""
    where = route(x)
    if where == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    x, (g,), y, rows = norm_operands("rmsnorm", x, gamma=gamma)
    if where == "meta":
        d = x.shape[-1]
        return shape_route(
            "rmsnorm", y, flops=norm_flops(rows, d, "rmsnorm"),
            nbytes=rmsnorm_hbm_bytes(rows, d, x.element_size()))
    if rows == 0:
        return y
    LIB.launch("rmsnorm_launch", _build.ptr(x), _build.ptr(g),
               _build.ptr(y), rows, x.shape[-1], float(eps),
               int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    return y


def rmsnorm_hbm_bytes(rows: int, d: int, in_bytes: int) -> int:
    """Bytes one call must move: x read once, gamma (f32) read once, y
    (f32) written once."""
    return rows * d * (in_bytes + 4) + d * 4


# operations a normalized element costs: rmsnorm squares, adds, scales
# by r and by (1 + gamma); layernorm subtracts the mean, squares, adds,
# scales by r and gamma, adds beta and sums the mean; a residual add is one
NORM_OPS = {"rmsnorm": 4, "layernorm": 7}


def norm_flops(rows: int, d: int, kind: str, add: bool = False) -> int:
    """Operations of one norm call over ``rows`` x ``d`` (with the
    residual add when ``add``); the per-row square root and divide are
    left out."""
    return rows * d * (NORM_OPS[kind] + (1 if add else 0))


def residual_add(x, y):
    """The decoder's residual add: a same-dtype pair adds in that dtype
    (torch computes in f32 and rounds), else through f32.  torch float8
    has no arithmetic, so an 8-bit pair adds in f32 and rounds back."""
    if x.dtype == y.dtype:
        if x.dtype == torch.float8_e5m2:
            return (x.to(torch.float32) + y.to(torch.float32)).to(x.dtype)
        return x + y
    return x.to(torch.float32) + y.to(torch.float32)


def residual_dtype(x_dtype, y_dtype):
    """The dtype :func:`residual_add` gives (``y_dtype`` None: no add)."""
    if y_dtype is None or x_dtype == y_dtype:
        return x_dtype
    return torch.float32


def fused_norm_takes(x_dtype, y_dtype, out_dtype) -> bool:
    """Whether :func:`add_rmsnorm`'s kernel takes these dtypes: f32, bf16
    or f16 for x, y (None: no add) and the output.  Any other (an 8-bit
    residual or activation) takes the three steps apart; the caller
    chooses before it calls."""
    return all(dt in DT_CODES for dt in (x_dtype, out_dtype)) \
        and (y_dtype is None or y_dtype in DT_CODES)


def add_rmsnorm_plain(x, y, gamma, out_dtype, eps: float = 1e-6):
    """The plain version: ``s = residual_add(x, y)`` (``s = x`` when
    ``y`` is None), then ``rmsnorm_plain(s)`` cast to ``out_dtype``.
    Returns ``(s, normed)``."""
    s = x if y is None else residual_add(x, y)
    return s, rmsnorm_plain(s, gamma, eps).to(out_dtype)


def add_rmsnorm(x, y, gamma, out_dtype, eps: float = 1e-6):
    """The residual stream ``s = x + y`` and its rmsnorm in ``out_dtype``,
    ``(s, normed)``: one kernel launch on a CUDA tensor (f32, bf16 or f16
    operands, see :func:`fused_norm_takes`; others raise), the plain
    version on a CPU one.  ``y`` None normalizes ``x`` alone (``s`` is
    ``x``).  When an operand needs a gradient the launch goes through
    :class:`FusedNormFn` (the same launch; the backward recomputes the
    plain version)."""
    if route(x) == "cpu":
        return add_rmsnorm_plain(x, y, gamma, out_dtype, eps)
    if _build.needs_grad(x, y, gamma):
        return fused_norm_diff(
            lambda *a: _add_rmsnorm_cuda(*a, out_dtype, eps),
            lambda *a: add_rmsnorm_plain(*a, out_dtype, eps), x, y, gamma)
    return _add_rmsnorm_cuda(x, y, gamma, out_dtype, eps)


class FusedNormFn(torch.autograd.Function):
    """A fused add + norm + cast whose forward is ``launch(x, y,
    *params)`` (the kernel: ``(s, normed)``) and whose backward
    recomputes ``plain(x, y, *params)``, the kernel's plain version, under
    autograd and returns its gradients of ``x``, ``y`` and the (d,)
    parameters, the recompute backward of ``flash_prefill_diff``.  The
    kernel equals its plain version bit for bit, so the gradients are
    those of the forward that ran.  With ``y`` None the output is
    ``normed`` alone (``s`` is ``x``; :func:`fused_norm_diff` returns it
    beside)."""

    @staticmethod
    def forward(ctx, launch, plain, x, y, *params):
        s, out = launch(x, y, *params)
        ctx.plain = plain
        ctx.has_y = y is not None
        ctx.save_for_backward(x, y, *params)
        return (s, out) if ctx.has_y else out

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in saved]
            s, out = ctx.plain(*leaves)
        outs = (s, out) if ctx.has_y else (out,)
        want = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(outs, want, grads, allow_unused=True))
        return (None, None) + tuple(None if t is None else next(got)
                                    for t in leaves)


def fused_norm_diff(launch, plain, x, y, *params):
    """``(s, normed)`` through :class:`FusedNormFn`."""
    if y is None:
        return x, FusedNormFn.apply(launch, plain, x, y, *params)
    return FusedNormFn.apply(launch, plain, x, y, *params)


def _add_rmsnorm_cuda(x, y, gamma, out_dtype, eps):
    return launch_fused("add_rmsnorm", x, y, out_dtype, eps, gamma=gamma)


def launch_fused(what, x, y, out_dtype, eps, **params):
    """One ``{what}_launch`` of the fused add + norm + cast on the card:
    checks the operands, makes ``s`` (a new tensor of ``residual_add``'s
    dtype; ``x`` itself when ``y`` is None) and the output, and passes the
    (d,) parameters as f32 in the order given.  Returns ``(s, normed)``."""
    y_dtype = None if y is None else y.dtype
    if not fused_norm_takes(x.dtype, y_dtype, out_dtype):
        raise ValueError(f"{what}: no kernel for x {x.dtype}, y "
                         f"{y_dtype}, out {out_dtype}")
    if y is not None and y.shape != x.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} differ")
    d = x.shape[-1]
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    ps = {k: p.to(torch.float32).contiguous() for k, p in params.items()}
    _build.check_operands(what, x.device, x=x, y=y, **ps)
    for k, p in ps.items():
        if p.shape != (d,):
            raise ValueError(f"{what}: {k} must be ({d},), got "
                             f"{tuple(p.shape)}")
    res_dtype = residual_dtype(x.dtype, y_dtype)
    s = x if y is None else torch.empty(x.shape, dtype=res_dtype,
                                        device=x.device)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if route(x) == "meta":
        y_bytes = 0 if y is None else y.element_size()
        res_bytes = 0 if y is None else s.element_size()
        nbytes = add_rmsnorm_hbm_bytes(rows, d, x.element_size(), y_bytes,
                                       res_bytes, out.element_size())
        kind = "layernorm" if what == "add_layernorm" else "rmsnorm"
        return shape_route(what, (s, out),
                           flops=norm_flops(rows, d, kind, y is not None),
                           nbytes=nbytes + 4 * d * (len(ps) - 1))
    if rows == 0:
        return s, out
    LIB.launch(f"{what}_launch", _build.ptr(x), _build.ptr(y),
               *(_build.ptr(p) for p in ps.values()),
               _build.ptr(None if y is None else s), _build.ptr(out), rows,
               d, float(eps), DT_CODES[x.dtype],
               DT_CODES[y_dtype if y is not None else x.dtype],
               DT_CODES[res_dtype], DT_CODES[out_dtype],
               _build.stream_ptr(x.device), kernel=what)
    return s, out


def add_rmsnorm_hbm_bytes(rows: int, d: int, x_bytes: int, y_bytes: int,
                          res_bytes: int, out_bytes: int) -> int:
    """Bytes one :func:`add_rmsnorm` must move: x and y read once, gamma
    (f32) read once, s and the output written once (``y_bytes`` 0: no
    add, so neither y nor s)."""
    add = y_bytes + res_bytes if y_bytes else 0
    return rows * d * (x_bytes + add + out_bytes) + d * 4
