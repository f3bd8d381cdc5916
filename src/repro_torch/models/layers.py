"""Policy-aware primitives shared by the model: the port of
``repro.models.layers`` for the dense decoder.

Every parameter-consuming contraction goes through :func:`pdot` /
:func:`peinsum`, which resolve their implementation in the matmul
registry (``kernels/dispatch.py``):

``"xla"``
    torch matmul/einsum.  Packed (:class:`QTensor`) weights are
    dequantized first and multiplied in f32.  Plain weights in native
    mode are rounded to bf16 whenever either operand is not f32 (the
    reference's ``_dot_xla`` computes in bf16 then, f16 weights
    included); bf16 x bf16 products are exact in f32, so multiplying the
    rounded operands in f32 is that computation up to summation order.
``"qmm_pallas"``
    ``kernels/qmatmul.qmatmul``: the CUDA kernel on a card, its plain
    version on the CPU.  Plain (unpacked) weights take the "xla" path.

torch float8 tensors have no arithmetic, so every op on activations
widens first.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.flexfloat import quantize
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import dispatch
from repro_torch.kernels.qmatmul import apply_act, qmatmul, qmm_ffn
from repro_torch.kernels.rmsnorm import rmsnorm_f32

F32 = torch.float32


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=F32, device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=F32, device=device)
    return (w * scale).to(dtype)


def _impl(policy: PrecisionPolicy) -> str:
    return policy.matmul_impl or "xla"


def pdot(x, w, policy: PrecisionPolicy, role: str, *, out_act: bool = True):
    """x @ w under the transprecision contract for weight role ``role``."""
    return dispatch.resolve_matmul(_impl(policy)).dot(
        x, w, policy, role, out_act=out_act)


def peinsum(expr, a, b, policy: PrecisionPolicy, role: str, *,
            out_act: bool = True):
    return dispatch.resolve_matmul(_impl(policy)).einsum(
        expr, a, b, policy, role, out_act=out_act)


def _finish(y, policy: PrecisionPolicy, out_act: bool):
    if not out_act:
        return y
    if policy.mode == "native":
        return y.to(policy.dtype("act"))
    return quantize(y, policy.fmt("act"))


def _compute_operands(a, b):
    """Native-mode operands as the reference computes them: bf16 unless
    both are f32, held in f32 for the matmul (exact products)."""
    if a.dtype == F32 and b.dtype == F32:
        return a, b
    return (a.to(torch.bfloat16).to(F32), b.to(torch.bfloat16).to(F32))


def _dot_xla(x, w, policy, role, *, out_act=True):
    if isinstance(w, QTensor):
        y = torch.matmul(x.to(F32), w.dequantize())
        return _finish(y, policy, out_act)
    if policy.mode == "native":
        y = torch.matmul(*_compute_operands(x, w))
        return y.to(policy.dtype("act")) if out_act else y
    y = torch.matmul(x.to(F32), w.to(F32))
    return quantize(y, policy.fmt("act")) if out_act else y


def _einsum_xla(expr, a, b, policy, role, *, out_act=True):
    if isinstance(a, QTensor) or isinstance(b, QTensor):
        af = a.dequantize() if isinstance(a, QTensor) else a.to(F32)
        bf = b.dequantize() if isinstance(b, QTensor) else b.to(F32)
        return _finish(torch.einsum(expr, af, bf), policy, out_act)
    if policy.mode == "native":
        y = torch.einsum(expr, *_compute_operands(a, b))
        return y.to(policy.dtype("act")) if out_act else y
    y = torch.einsum(expr, a.to(F32), b.to(F32))
    return quantize(y, policy.fmt("act")) if out_act else y


@dispatch.register_matmul("xla")
class _XlaMatmul:
    dot = staticmethod(_dot_xla)
    einsum = staticmethod(_einsum_xla)


def _out_fmt(policy, out_act):
    """Output sanitization the kernel fuses (emulated mode only)."""
    return policy.fmt("act") if (out_act and policy.mode == "emulated") \
        else None


def _dot_qmm(x, w, policy, role, *, out_act=True):
    if not isinstance(w, QTensor):
        return _dot_xla(x, w, policy, role, out_act=out_act)
    lead, K = x.shape[:-1], x.shape[-1]
    y = qmatmul(x.reshape(-1, K).to(F32).contiguous(), w.payload, None,
                w.fmt, _out_fmt(policy, out_act))
    y = y.reshape(*lead, w.shape[-1])
    if out_act and policy.mode == "native":
        y = y.to(policy.dtype("act"))
    return y


@dispatch.register_matmul("qmm_pallas")
class _QmmMatmul:
    dot = staticmethod(_dot_qmm)
    einsum = staticmethod(_einsum_xla)   # activation-only contractions


def act_cast(x, policy: PrecisionPolicy, role: str = "act"):
    if policy.mode == "native":
        return x.to(policy.dtype(role))
    return quantize(x, policy.fmt(role))


def rmsnorm(x, gamma, policy, eps=1e-6):
    """``kernels/rmsnorm``: one launch on a card, its twin on the CPU,
    both summing in an order fixed by d alone, so a row normalizes to
    the same bits whatever rows are beside it (a verify row as the
    decode row, a prefill chunk's row as the whole prompt's)."""
    return act_cast(rmsnorm_f32(x, gamma, eps), policy)


def norm_init(d, device=None):
    return {"gamma": torch.zeros((d,), dtype=F32, device=device)}


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device) -> torch.Tensor:
    """Built once per (theta, width, device): a host -> device copy per
    call would stall the host on every layer."""
    freqs = np.exp(-np.log(theta) * np.arange(half) / half)
    return torch.tensor(freqs.astype(np.float32), device=device)


def rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: (..., S).  The frequencies are built
    in float64 numpy and multiplied in f32, as JAX does."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = _rope_freqs(float(theta), half, x.device)
    ang = positions[..., :, None].to(F32) * freqs
    cos, sin = torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def ffn_init(gen, d, ff, gated, use_bias, dtype, device=None):
    p = {"w_in": dense_init(gen, (d, ff), dtype=dtype, device=device),
         "w_out": dense_init(gen, (ff, d), dtype=dtype, device=device)}
    if gated:
        p["w_gate"] = dense_init(gen, (d, ff), dtype=dtype, device=device)
    if use_bias:
        p["b_in"] = torch.zeros((ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def ffn_apply(p, x, policy, cfg):
    if _impl(policy) == "qmm_pallas" and isinstance(p["w_in"], QTensor) \
            and isinstance(p.get("w_gate", p["w_in"]), QTensor):
        return _ffn_apply_fused(p, x, policy, cfg)
    h = pdot(x, p["w_in"], policy, "ffn_w", out_act=False)
    if "b_in" in p:
        h = h + p["b_in"].to(F32)
    a = apply_act(h.to(F32), cfg.act_fn)
    if "w_gate" in p:
        a = a * pdot(x, p["w_gate"], policy, "ffn_w", out_act=False)
    a = act_cast(a, policy)
    y = pdot(a, p["w_out"], policy, "ffn_w")
    if "b_out" in p:
        y = act_cast(y.to(F32) + p["b_out"].to(F32), policy)
    return y


def _ffn_apply_fused(p, x, policy, cfg):
    """``act_cast(act(x @ w_in + b_in) * (x @ w_gate))`` in ONE kernel
    launch, then the down projection."""
    w_in, w_gate = p["w_in"], p.get("w_gate")
    assert w_gate is None or w_gate.fmt == w_in.fmt, (w_in.fmt, w_gate.fmt)
    lead, K = x.shape[:-1], x.shape[-1]
    a = qmm_ffn(x.reshape(-1, K).to(F32).contiguous(), w_in.payload,
                w_gate.payload if w_gate is not None else None, w_in.fmt,
                bias=p["b_in"].to(F32) if "b_in" in p else None,
                act=cfg.act_fn, out_fmt=_out_fmt(policy, True))
    if policy.mode == "native":
        a = a.to(policy.dtype("act"))
    y = pdot(a.reshape(*lead, -1), p["w_out"], policy, "ffn_w")
    if "b_out" in p:
        y = act_cast(y.to(F32) + p["b_out"].to(F32), policy)
    return y


def residual_add(x, y):
    """Same-dtype add in that dtype, else through f32.  torch float8 has
    no arithmetic, so an 8-bit pair adds in f32 and rounds back."""
    if x.dtype == y.dtype:
        if x.dtype == torch.float8_e5m2:
            return (x.to(F32) + y.to(F32)).to(x.dtype)
        return x + y
    return x.to(F32) + y.to(F32)


def embed_lookup(table, tokens, policy, scale=False):
    e = table[tokens.long()]
    e = e.to(policy.dtype("act") if policy.mode == "native" else F32)
    if scale:
        e = e.to(F32) * np.float32(np.sqrt(table.shape[1]))
    return act_cast(e, policy) if policy.mode == "emulated" else e


def lm_logits(x, head_w, policy):
    y = pdot(x, head_w, policy, "embed_w", out_act=False)
    if policy.mode == "emulated":
        return quantize(y, policy.fmt("logits"))
    return y.to(policy.dtype("logits"))
