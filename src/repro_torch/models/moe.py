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
its maximum on the host).

Under an ambient mesh (``core/ambient_mesh.use_mesh``) with a ``model``
dim and ``cfg.moe_impl == "shard_map"``, :func:`moe_apply_sharded` runs
the reference's expert-parallel schedule; under the sharded train step's
split batch the global path first gathers the data shards' tokens
(:func:`_moe_apply_gathered`), so it routes over the global batch as the
reference's GSPMD step does.

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

from repro_torch.core import collectives as coll
from repro_torch.core.ambient_mesh import (axis_names, batch_split_axes,
                                           dp_axes, dp_size,
                                           get_ambient_mesh, model_axis_size)
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qtensor import QTensor

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


def top_k(p, xt, cfg, policy: PrecisionPolicy):
    """``(top_p, top_e, hot, aux)`` of the (T, d) tokens ``xt``: the
    renormalized top-K router weights and experts, their (T, K, E)
    one-hot, and the Switch-style aux loss."""
    E, K = cfg.moe_experts, cfg.moe_topk
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
    return top_p, top_e, hot, E * torch.sum(me * ce / K)


def moe_route(p, xt, cfg, policy: PrecisionPolicy) -> Routing:
    """Routing and dispatch indices of the (T, d) tokens ``xt``."""
    T = xt.shape[0]
    E, K = cfg.moe_experts, cfg.moe_topk
    dev = xt.device
    top_p, top_e, hot, aux = top_k(p, xt, cfg, policy)

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
    """x: (B, S, d) -> ((B, S, d), load-balancing aux loss).  Takes the
    expert-parallel path when the config asks for it and the ambient mesh
    has a ``model`` dim, as the reference's does; under a split batch the
    global path gathers the tokens first."""
    mesh = get_ambient_mesh()
    if mesh is not None:
        if cfg.moe_impl == "shard_map" and "model" in axis_names(mesh):
            return moe_apply_sharded(p, x, cfg, policy, mesh)
        if batch_split_axes():
            return _moe_apply_gathered(p, x, cfg, policy, mesh)
    return _moe_apply_global(p, x, cfg, policy)


def _moe_apply_gathered(p, x, cfg, policy: PrecisionPolicy, mesh):
    """The global path over the whole batch when each rank holds its rows:
    the data shards' tokens gathered (``coll.gather_rows``, whose
    backward sums every rank's cotangent of a row), routed together
    (capacity from the global T, drops decided over all tokens, the aux
    over all tokens, as the reference's GSPMD step computes
    ``_moe_apply_global``), the rank's rows kept."""
    axes = batch_split_axes()
    rows = x.shape[0]
    y, aux = _moe_apply_global(p, coll.gather_rows(x, mesh, axes), cfg,
                               policy)
    i = coll.axes_index(mesh, axes)
    return y[i * rows:(i + 1) * rows], aux


def _moe_apply_global(p, x, cfg, policy: PrecisionPolicy):
    """The reference's ``_moe_apply_global``: global sort-based
    dispatch."""
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


# ---------------------------------------------------------------------------
# the expert-parallel path (the reference's ``moe_apply_sharded``)
# ---------------------------------------------------------------------------

def _own_experts(w, E: int, E_loc: int, j: int):
    """Model rank ``j``'s ``E_loc`` experts of ``w``: ``w`` itself when it
    is already the rank's block (the sharded train step keeps expert
    leaves as their ``("model", None, None)`` blocks), else its slice."""
    if w.shape[0] == E_loc:
        return w
    if w.shape[0] == E:
        return w[j * E_loc:(j + 1) * E_loc]
    raise ValueError(f"an expert leaf of {tuple(w.shape)} is neither the "
                     f"{E} experts nor a block of {E_loc}")


def moe_apply_sharded(p, x, cfg, policy: PrecisionPolicy, mesh):
    """Expert parallelism over ``mesh``'s ``model`` dim, the reference's
    ``shard_map`` schedule (``repro/models/moe.py:123-214``): the tokens
    of each data shard are routed locally with capacity ``max(8,
    ceil(cf * T_loc * K / E))``, ``T_loc = B * S / n_dp``; model rank j
    owns experts ``[j E_loc, (j + 1) E_loc)`` and computes their part of
    every local token's output; the parts are summed over ``model``
    (``coll.sum_over``, differentiable); the aux loss is averaged over
    the data-parallel dims and over ``model``.

    Packed experts are dequantized first, as the reference does
    (``repro/models/moe.py:126-132``): the local grouped product runs on
    plain arrays (``pgrouped_dot``), so this path launches no grouped
    kernel, in the reference neither.  Unlike the global path, the expert
    outputs enter the combine unrounded (the reference's ``ye`` is not
    ``act_cast`` here), so under a narrow activation format the two paths
    differ even on one rank; under binary32 they agree bit for bit.

    ``x`` is this rank's rows when the ambient mesh says the batch is
    split (they must be split over every data-parallel dim, as
    ``shard_map``'s ``P(dp)`` splits them); otherwise every rank holds
    the whole batch, takes its rows and gathers the outputs back.
    Gradients follow the sharded train step's convention
    (``core/collectives.py``): the tokens and router weights enter the
    rank's part through ``coll.enter_partial``, whose backward sums the
    model ranks' parts."""
    p = {k: (v.dequantize() if isinstance(v, QTensor) else v)
         for k, v in p.items()}
    B, S, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    dp = dp_axes(mesh)
    n_model = model_axis_size(mesh)
    n_dp = dp_size(mesh)
    if E % n_model:
        raise ValueError(f"{E} experts do not divide over {n_model} model "
                         f"ranks")
    E_loc = E // n_model
    split = batch_split_axes()
    if split:
        if n_dp > 1 and tuple(split) != tuple(dp):
            raise ValueError(f"the expert-parallel MoE needs the batch split "
                             f"over every data-parallel dim {dp}, got "
                             f"{tuple(split)}")
        xb = x
    else:
        if B % n_dp:
            raise ValueError(f"batch {B} does not divide over {n_dp} data "
                             f"shards")
        i = coll.axes_index(mesh, dp)
        xb = x[i * (B // n_dp):(i + 1) * (B // n_dp)]
    T = xb.shape[0] * S
    C = max(8, int(math.ceil(cfg.capacity_factor * T * K / E)))
    j = coll.axis_index(mesh, "model")
    dev = x.device

    xt = xb.reshape(T, d)
    top_p, top_e, _, aux = top_k(p, xt, cfg, policy)
    if dp:
        aux = coll.mean_over(aux, mesh, dp)
    aux = coll.mean_over(aux, mesh, "model")

    flat_e = top_e.reshape(T * K)
    mine = torch.div(flat_e, E_loc, rounding_mode="floor") == j
    loc_e = torch.where(mine, flat_e - j * E_loc,
                        torch.full_like(flat_e, E_loc))
    order = torch.sort(loc_e, stable=True).indices   # foreign ones last
    se = loc_e[order]
    st = torch.div(order, K, rounding_mode="floor")
    sp = coll.enter_partial(top_p, mesh, "model").reshape(T * K)[order]
    counts = (loc_e[:, None] == torch.arange(E_loc, device=dev)).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    own = se < E_loc
    pos = torch.arange(T * K, device=dev) - torch.where(
        own, starts[torch.clamp(se, max=E_loc - 1)], 0)
    keep = own & (pos < C)
    dest = torch.where(keep, se * C + pos, torch.full_like(se, E_loc * C))

    xp = coll.enter_partial(xt, mesh, "model")
    xe = torch.zeros((E_loc * C + 1, d), dtype=x.dtype, device=dev)
    xe[dest] = xp[st]
    xe = xe[:E_loc * C].reshape(E_loc, C, d)
    rows = torch.clamp(counts, max=C).to(torch.int32)
    w = {k: _own_experts(p[k], E, E_loc, j)
         for k in ("w_in", "w_gate", "w_out") if k in p}
    a = grouped_ffn_in(xe, w, policy, cfg.act_fn, rows)
    ye = pgrouped_dot(a, w["w_out"], policy, "ffn_w",
                      rows=rows).reshape(E_loc * C, d)

    gathered = ye[torch.where(keep, dest, 0)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=ye.dtype, device=dev))
    weighted = gathered * sp[:, None].to(F32)
    yt = coll.sum_over(combine(weighted, order, T, K), mesh, "model")
    y = act_cast(yt, policy).reshape(xb.shape)
    if not split and n_dp > 1:
        y = coll.all_gather_cat(y, mesh, dp, dim=0)
    return y, aux
