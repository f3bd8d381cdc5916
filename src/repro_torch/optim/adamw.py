"""AdamW with transprecision state formats: the port of
``repro.optim.adamw``.

Master weights and the second moment stay binary32; the first moment
takes the policy's ``optim_m`` format (binary16alt under
transprecision); the model's weights are the master rounded to the
policy's storage formats (:func:`materialize_params`, the role of each
leaf read off its path as the reference reads it).

The update is the reference's, op for op in f32:
``g * scale`` (global-norm clip), ``m b1 + (1 - b1) g``,
``v b2 + (1 - b2) g^2``, ``(m / c1) / (sqrt(v / c2) + eps)`` with
``c = 1 - b^step``, ``master - lr (upd + wd master)``, written as XLA
compiles the reference on the CPU: ``m b1 + t``, ``v b2 + t`` and the
master update as fused multiply-adds (``torch.addcmul``, one rounding;
``t`` the rounded other product), and ``(m / c1) / d`` as
``m / (c1 d)`` (XLA's simplifier folds the two divisions).  So the
port's step equals the reference's bit for bit when the clip does not
act.  When it acts, the scale is
``clip / gnorm`` and the two packages sum the squares in different
orders: the norm, and with it every update, may differ by an ulp.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.flexfloat import quantize
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.tree import (flatten_with_path, leaves, path_str,
                                   tree_map, unflatten)

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    master: Any          # f32 (policy "master")
    m: Any               # policy "optim_m"
    v: Any               # policy "optim_v"


def _state_dtype(policy: PrecisionPolicy, role: str) -> torch.dtype:
    return policy.dtype(role) if policy.mode == "native" else F32


def init(params, policy: PrecisionPolicy) -> AdamWState:
    """``params`` are the (possibly narrow) model weights; the master is
    an f32 copy (never an alias of a param)."""
    master = tree_map(lambda p: p.detach().to(F32, copy=True), params)
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=_state_dtype(
        policy, "optim_m"), device=p.device), params)
    v = tree_map(lambda p: torch.zeros(p.shape, dtype=_state_dtype(
        policy, "optim_v"), device=p.device), params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      master=master, m=m, v=v)


def global_norm_scale(grads, grad_clip: float) -> torch.Tensor:
    """``min(1, clip / sqrt(sum g^2 + 1e-16))`` in f32, written as XLA
    compiles it (``clip * rsqrt(...)``): the squares of each leaf summed,
    then the leaves added in tree order."""
    gl = leaves(grads)
    total = None
    for g in gl:
        s = torch.sum(torch.square(g.to(F32)))
        total = s if total is None else total + s
    return torch.clamp(grad_clip * torch.rsqrt(total + 1e-16), max=1.0)


@torch.no_grad()
def apply(grads, state: AdamWState, policy: PrecisionPolicy, *,
          lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float = 1.0, clip_scale=None):
    """Returns ``(new_master, new_state)``; ``grads`` has the params'
    structure.  ``state`` is donated, as the reference's train step
    donates it: the new master and moments are written into its tensors
    (no second copy of the state is ever held) and returned in a new
    ``AdamWState``.  ``clip_scale``, when given, is the clip factor
    (the sharded train step computes it from the whole gradient, each
    rank holding blocks of it)."""
    step = state.step + 1
    dev = state.step.device
    if clip_scale is not None:
        scale = clip_scale
    elif grad_clip:
        scale = global_norm_scale(grads, grad_clip)
    else:
        scale = torch.ones((), dtype=F32, device=dev)
    sf = step.to(F32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=dev), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=dev), sf)
    b1_t, b2_t = (torch.tensor(b, dtype=F32, device=dev) for b in (b1, b2))
    one_b1 = torch.tensor(1 - b1, dtype=F32, device=dev)
    one_b2 = torch.tensor(1 - b2, dtype=F32, device=dev)
    neg_lr = torch.tensor(-lr, dtype=F32, device=dev)

    def upd(g, mm, vv, mw):
        g = g.to(F32) * scale
        mf = torch.addcmul(one_b1 * g, mm.to(F32), b1_t)
        vf = torch.addcmul(one_b2 * torch.square(g), vv.to(F32), b2_t)
        # XLA rewrites (m / c1) / d as m / (c1 d), and the master update
        # as one fused multiply-add
        u = mf / (c1 * (torch.sqrt(vf / c2) + eps))
        new_master = torch.addcmul(mw, neg_lr, u + weight_decay * mw)
        del u
        if policy.mode == "native":
            out = mf.to(mm.dtype), vf.to(vv.dtype), new_master
        else:
            out = (quantize(mf, policy.fmt("optim_m")),
                   quantize(vf, policy.fmt("optim_v")), new_master)
        for dst, src in zip((mm, vv, mw), out):
            dst.copy_(src)
        return mm, vv, mw

    out = [upd(*xs) for xs in zip(leaves(grads), leaves(state.m),
                                  leaves(state.v), leaves(state.master))]
    new_m = unflatten(grads, [o[0] for o in out])
    new_v = unflatten(grads, [o[1] for o in out])
    new_master = unflatten(grads, [o[2] for o in out])
    return new_master, AdamWState(step=step, master=new_master, m=new_m,
                                  v=new_v)


def param_role(path) -> str:
    """The storage role of a param leaf from its path, the reference's
    rule (``repro/optim/adamw.py:99-126``): norms (and the mixes, the
    decay lambda, ``ln_*``) ``norm_w``; the embedding and head
    ``embed_w``; FFN and channel-mix weights (``ffn``, ``cm_``, ``w_in``,
    ``w_out``, ``conv``) ``ffn_w``; the router ``router_w``; the rest
    ``attn_w``.  The tests run in this order, so an MoE router under
    ``ffn`` is ``ffn_w``, as in the reference."""
    keys = path_str(path).lower()
    if "norm" in keys or "ln_" in keys or "mu" in keys or "lam" in keys:
        return "norm_w"
    if "embed" in keys or "head" in keys:
        return "embed_w"
    if "ffn" in keys or "cm_" in keys or "w_in" in keys \
            or "w_out" in keys or "conv" in keys:
        return "ffn_w"
    if "router" in keys:
        return "router_w"
    return "attn_w"


@torch.no_grad()
def materialize_params(state: AdamWState, params_like,
                       policy: PrecisionPolicy):
    """The master weights cast into the policy's storage formats (a new
    tensor for every leaf, never an alias of the master)."""
    out = []
    for (path, _), mw in zip(flatten_with_path(params_like),
                             leaves(state.master)):
        role = param_role(path)
        if policy.mode == "native":
            out.append(mw.to(policy.dtype(role), copy=True))
        else:
            out.append(quantize(mw, policy.fmt(role)))
    return unflatten(params_like, out)
