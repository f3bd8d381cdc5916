"""Mixture-of-Experts FFN with sort-based token dispatch: the port of
``repro.models.moe``'s global path (``_moe_apply_global``).

Tokens are routed top-k, sorted by expert id, packed into (E, C, d) with
capacity dropping, run through the grouped expert FFN
(:func:`~repro_torch.models.layers.grouped_ffn_in` and
:func:`~repro_torch.models.layers.pgrouped_dot`: under ``qmm_pallas`` on
packed experts two grouped launches a layer, the gated pair with its
epilogue and w_out, each reading each expert's kept-row count
``Routing.rows`` on the device and streaming only the experts with a
kept row; the reference unrolls one launch per expert and weight) and
combined back with the router weights.  Nothing here waits for the
device: the counts stay there (no ``bincount``, whose CUDA version reads
its maximum on the host).  The expert-parallel ``moe_apply_sharded`` waits
for multi-device.

Where the reference's order is not torch's default, the port fixes it:

* top-k is a stable descending sort, so ties go to the lower expert id,
  as ``jax.lax.top_k``'s do;
* the dispatch sort is stable (``jnp.argsort`` is);
* the combine adds each token's K contributions to 0 in ascending expert
  id, the order in which the reference's ``zeros(T, d).at[st].add``
  applies its sorted updates, with no atomics (``index_add_`` on a CUDA
  tensor adds in a different order from run to run).

Capacity depends on the number of rows T, so which tokens are dropped --
and so the outputs -- depend on the rows that share a call, in the
reference too: a verify round over B * (k + 1) rows can drop what a
B-row decode step keeps.  Up to 8 rows nothing is ever dropped (C >= 8).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.policy import PrecisionPolicy

from .layers import (F32, act_cast, dense_init, grouped_ffn_in, pdot,
                     pgrouped_dot)


def moe_init(gen: torch.Generator, cfg, dtype, device=None):
    """Router (f32) and the experts' (E, d, ff) / (E, ff, d) weights; the
    reference's ``dense_init`` takes fan-in from the first axis, E."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {
        "router": dense_init(gen, (d, E), dtype=F32, device=device),
        "w_in": dense_init(gen, (E, d, ff), dtype=dtype, device=device),
        "w_out": dense_init(gen, (E, ff, d), dtype=dtype, device=device),
    }
    if cfg.gated_ffn:
        p["w_gate"] = dense_init(gen, (E, d, ff), dtype=dtype, device=device)
    return p


def capacity(cfg, T: int) -> int:
    """Rows each expert takes for T tokens, the reference's host int."""
    C = int(math.ceil(cfg.capacity_factor * T * cfg.moe_topk
                      / cfg.moe_experts))
    return max(8, min(C, T))


class Routing(NamedTuple):
    top_p: torch.Tensor   # (T, K) renormalized router weights
    top_e: torch.Tensor   # (T, K) chosen experts, highest weight first
    aux: torch.Tensor     # Switch-style load-balancing loss
    C: int                # capacity
    order: torch.Tensor   # (T * K,) the stable sort by expert id
    keep: torch.Tensor    # (T * K,) sorted entry within capacity
    dest: torch.Tensor    # (T * K,) its row of (E * C + 1); E * C drops
    rows: torch.Tensor    # (E,) int32 kept rows an expert, min(count, C)


def moe_route(p, xt, cfg, policy: PrecisionPolicy) -> Routing:
    """Routing and dispatch indices of the (T, d) tokens ``xt``."""
    T = xt.shape[0]
    E, K = cfg.moe_experts, cfg.moe_topk
    dev = xt.device
    logits = pdot(xt, p["router"], policy, "router_w",
                  out_act=False).to(F32)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt.values[:, :K], srt.indices[:, :K]
    total = top_p[:, 0]
    for k in range(1, K):                     # the K weights left to right
        total = total + top_p[:, k]
    top_p = act_cast(top_p / total[:, None], policy, "router_probs")

    me = torch.mean(probs, dim=0)
    hot = torch.nn.functional.one_hot(top_e, E)          # (T, K, E)
    ce = torch.mean(hot.to(F32).sum(1), dim=0)
    aux = E * torch.sum(me * ce / K)

    C = capacity(cfg, T)
    flat_e = top_e.reshape(T * K)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = hot.sum((0, 1))                             # bincount
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[se]
    keep = pos < C
    dest = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    rows = torch.clamp(counts, max=C).to(torch.int32)
    return Routing(top_p, top_e, aux, C, order, keep, dest, rows)


def moe_apply(p, x, cfg, policy: PrecisionPolicy):
    """x: (B, S, d) -> ((B, S, d), load-balancing aux loss)."""
    B, S, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = B * S
    xt = x.reshape(T, d)
    r = moe_route(p, xt, cfg, policy)
    C = r.C
    st = torch.div(r.order, K, rounding_mode="floor")   # token of each
    sp = r.top_p.reshape(T * K)[r.order]

    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xe[r.dest] = xt[st]
    xe = xe[:E * C].reshape(E, C, d)

    a = grouped_ffn_in(xe, p, policy, cfg.act_fn, r.rows)
    ye = pgrouped_dot(a, p["w_out"], policy, "ffn_w", rows=r.rows)
    ye = act_cast(ye, policy).reshape(E * C, d)

    gathered = ye[torch.where(r.keep, r.dest, 0)]
    gathered = torch.where(r.keep[:, None], gathered,
                           torch.zeros((), dtype=ye.dtype, device=ye.device))
    weighted = gathered.to(F32) * sp[:, None].to(F32)
    yt = combine(weighted, r.order, T, K)
    return act_cast(yt.reshape(B, S, d), policy), r.aux


def combine(weighted, order, T: int, K: int) -> torch.Tensor:
    """``zeros(T, d).at[order // K].add(weighted)`` in the reference's
    order: each token's K sorted rows added to 0 in sorted (= ascending
    expert) order, K whole-tensor adds, no atomics."""
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=order.device)
    mine = torch.sort(rank.reshape(T, K), dim=1).values
    yt = torch.zeros((T, weighted.shape[-1]), dtype=F32,
                     device=weighted.device)
    for k in range(K):
        yt = yt + weighted[mine[:, k]]
    return yt
