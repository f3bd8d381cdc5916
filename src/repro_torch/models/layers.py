"""Policy-aware primitives shared by the model: the port of
``repro.models.layers`` for the dense and MoE decoders.

Every parameter-consuming contraction goes through :func:`pdot` /
:func:`peinsum` / :func:`pgrouped_dot`, which resolve their
implementation in the matmul registry (``kernels/dispatch.py``):

``"xla"``
    torch matmul/einsum.  Packed (:class:`QTensor`) weights are
    dequantized first and multiplied in f32.  Plain weights in native
    mode are rounded to bf16 whenever either operand is not f32 (the
    reference's ``_dot_xla`` computes in bf16 then, f16 weights
    included; its grouped form always does); bf16 x bf16 products are
    exact in f32, so multiplying the rounded operands in f32 is that
    computation up to summation order.
``"qmm_pallas"``
    ``kernels/qmatmul.qmatmul``: the CUDA kernel on a card, its plain
    version on the CPU; the grouped form launches it once per expert.
    Plain (unpacked) weights take the "xla" path.

The LM head of a tied embedding is the plain table transposed (the
packed store does not pack the table): :func:`lm_logits` multiplies it
in blocks of :data:`HEAD_ROWS` rows, so a row's logits do not depend on
the rows beside it, as qmm's do not.

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
from repro_torch.kernels.layernorm import layernorm_f32
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


def pgrouped_dot(a, w, policy: PrecisionPolicy, role: str):
    """Batched expert matmul ``(E, M, K) @ (E, K, N) -> (E, M, N)`` (MoE
    grouped FFN).  Returns raw f32 (callers ``act_cast`` as needed)."""
    return dispatch.resolve_matmul(_impl(policy)).grouped(a, w, policy, role)


def _finish(y, policy: PrecisionPolicy, out_act: bool):
    if not out_act:
        return y
    if policy.mode == "native":
        return y.to(policy.dtype("act"))
    return quantize(y, policy.fmt("act"))


def _compute_operands(a, b, policy):
    """The operands of a plain product as the reference computes it, held
    in f32 for the matmul: in native mode bf16 unless both are f32
    (exact products), else f32."""
    if policy.mode != "native" or (a.dtype == F32 and b.dtype == F32):
        return a.to(F32), b.to(F32)
    return (a.to(torch.bfloat16).to(F32), b.to(torch.bfloat16).to(F32))


def _dot_xla(x, w, policy, role, *, out_act=True):
    if isinstance(w, QTensor):
        y = torch.matmul(x.to(F32), w.dequantize())
    else:
        y = torch.matmul(*_compute_operands(x, w, policy))
    return _finish(y, policy, out_act)


def _einsum_xla(expr, a, b, policy, role, *, out_act=True):
    if isinstance(a, QTensor) or isinstance(b, QTensor):
        af = a.dequantize() if isinstance(a, QTensor) else a.to(F32)
        bf = b.dequantize() if isinstance(b, QTensor) else b.to(F32)
        y = torch.einsum(expr, af, bf)
    else:
        y = torch.einsum(expr, *_compute_operands(a, b, policy))
    return _finish(y, policy, out_act)


def _grouped_xla(a, w, policy, role):
    if isinstance(w, QTensor):
        return torch.einsum("eck,ekn->ecn", a.to(F32), w.dequantize())
    if policy.mode == "native":
        # the reference's grouped form computes in bf16 in native mode,
        # f32 operands included
        bf = torch.bfloat16
        return torch.einsum("eck,ekn->ecn", a.to(bf).to(F32),
                            w.to(bf).to(F32))
    return torch.einsum("eck,ekn->ecn", a.to(F32), w.to(F32))


@dispatch.register_matmul("xla")
class _XlaMatmul:
    dot = staticmethod(_dot_xla)
    einsum = staticmethod(_einsum_xla)
    grouped = staticmethod(_grouped_xla)


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


def _grouped_qmm(a, w, policy, role):
    if not isinstance(w, QTensor):
        return _grouped_xla(a, w, policy, role)
    # one launch per expert on its packed block, as the reference unrolls
    # it: every expert streams, rows kept or not
    a = a.to(F32)
    return torch.stack([qmatmul(a[e].contiguous(), w.payload[e], None,
                                w.fmt) for e in range(a.shape[0])])


@dispatch.register_matmul("qmm_pallas")
class _QmmMatmul:
    dot = staticmethod(_dot_qmm)
    einsum = staticmethod(_einsum_xla)   # activation-only contractions
    grouped = staticmethod(_grouped_qmm)


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


def layernorm(x, gamma, beta, policy, eps=1e-5):
    """``kernels/layernorm``: rmsnorm's row-count-free order for the
    mean and the (two-pass) variance."""
    return act_cast(layernorm_f32(x, gamma, beta, eps), policy)


def apply_norm(x, p, policy, kind):
    if kind == "rmsnorm":
        return rmsnorm(x, p["gamma"], policy)
    return layernorm(x, p["gamma"], p["beta"], policy)


def norm_init(d, kind, device=None):
    if kind == "rmsnorm":
        return {"gamma": torch.zeros((d,), dtype=F32, device=device)}
    return {"gamma": torch.ones((d,), dtype=F32, device=device),
            "beta": torch.zeros((d,), dtype=F32, device=device)}


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


HEAD_ROWS = 8           # rows a product of an unpacked head
HEAD_COLS = 32768       # vocab columns widened to f32 at a time


def _head_plain(x, w, policy):
    """``x @ w`` for an unpacked head (a tied embedding's table,
    transposed), the reference's plain product: f32 products of the
    operands as :func:`_compute_operands` takes them, with f32 sums.  ``torch.matmul`` picks its algorithm by the shape, so rows go
    in zero-padded blocks of ``HEAD_ROWS``: each block is the same call
    whatever the row count, and a verify row's logits equal the decode
    row's.  The weight is widened ``HEAD_COLS`` columns at a time, never
    whole (command-r's table is 8.4 GB in f32)."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = w.shape[-1]
    xf = x.reshape(-1, K)
    M = xf.shape[0]
    pad = -M % HEAD_ROWS
    out = torch.empty((M + pad, N), dtype=F32, device=x.device)
    for n0 in range(0, N, HEAD_COLS):
        # widened in the table's own layout: the product takes the
        # transposed operand as it is, no transposing copy
        xc, wc = _compute_operands(xf, w[:, n0:n0 + HEAD_COLS], policy)
        xc = torch.nn.functional.pad(xc, (0, 0, 0, pad))
        for m0 in range(0, M + pad, HEAD_ROWS):
            out[m0:m0 + HEAD_ROWS, n0:n0 + wc.shape[1]] = torch.matmul(
                xc[m0:m0 + HEAD_ROWS], wc)
    return out[:M].reshape(*lead, N)


def lm_logits(x, head_w, policy):
    if isinstance(head_w, QTensor):
        y = pdot(x, head_w, policy, "embed_w", out_act=False)
    else:
        y = _head_plain(x, head_w, policy)
    if policy.mode == "emulated":
        return quantize(y, policy.fmt("logits"))
    return y.to(policy.dtype("logits"))
