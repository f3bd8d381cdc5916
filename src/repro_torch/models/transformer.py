"""The decoder-only LM: the port of ``repro.models.transformer`` for the
``dense`` and ``moe`` families, rmsnorm or layernorm (rwkv, rglru,
prefix-LM and enc-dec wait).  Parameters are plain nested dicts of tensors,
made on ``cuda`` unless the caller passes ``device="cpu"``; the forward
entry points run on the device their parameters live on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels.paged_cache import PagedKVCache

from . import attention as attn
from . import moe as moe_mod
from .base import ModelConfig
from .layers import (apply_norm, dense_init, embed_lookup, ffn_apply,
                     ffn_init, lm_logits, norm_init, residual_add)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _policy(self, policy: PrecisionPolicy) -> PrecisionPolicy:
        """Lift the config's ``matmul_impl`` into the policy (the policy
        override wins)."""
        if policy.matmul_impl is None and self.cfg.matmul_impl != "xla":
            policy = dataclasses.replace(policy,
                                         matmul_impl=self.cfg.matmul_impl)
        return policy

    def init_params(self, gen: torch.Generator, policy: PrecisionPolicy,
                    device=None) -> Dict[str, Any]:
        """Random weights from ``gen`` (normal, 1/sqrt(fan_in) scale, the
        embedding at unit scale), stored in the policy's dtypes on
        ``device`` (default ``cuda``; raises when no card is present
        unless ``device="cpu"``).  ``gen`` must live on that device."""
        cfg = self.cfg
        device = resolve_device(device)
        edt = policy.dtype("embed_w")
        params: Dict[str, Any] = {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0,
                                dtype=edt, device=device),
            "final_norm": norm_init(cfg.d_model, cfg.norm, device),
            "layers": [],
        }
        if not cfg.tied_embeddings:
            params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                        dtype=edt, device=device)
        for li in range(cfg.n_layers):
            lp = policy.at_layer(li)
            fdt = lp.dtype("ffn_w")
            params["layers"].append({
                "norm1": norm_init(cfg.d_model, cfg.norm, device),
                "mix": attn.attn_init(gen, cfg, lp.dtype("attn_w"), device),
                "norm2": norm_init(cfg.d_model, cfg.norm, device),
                "ffn": (moe_mod.moe_init(gen, cfg, fdt, device)
                        if cfg.moe_experts else
                        ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                                 cfg.use_bias, fdt, device)),
            })
        return params

    def _head_w(self, params):
        if self.cfg.tied_embeddings:
            return params["embed"].T
        return params["head"]

    def _block(self, layer, x, lp, attend):
        """One decoder block around the attention call ``attend(h)``; the
        MoE FFN's aux loss is dropped (serving), as the reference's
        serving paths drop it."""
        cfg = self.cfg
        h = apply_norm(x, layer["norm1"], lp, cfg.norm)
        a, st = attend(h)
        x = residual_add(x, a)
        h = apply_norm(x, layer["norm2"], lp, cfg.norm)
        if cfg.moe_experts:
            f, _ = moe_mod.moe_apply(layer["ffn"], h, cfg, lp)
        else:
            f = ffn_apply(layer["ffn"], h, lp, cfg)
        return residual_add(x, f), st

    def _logits(self, params, x, policy):
        x = apply_norm(x, params["final_norm"], policy, self.cfg.norm)
        return lm_logits(x, self._head_w(params), policy)

    def init_state(self, batch_size, capacity, policy, device=None):
        """Contiguous per-layer KV caches (the synchronous loop's) on
        ``device`` (default ``cuda``, as :meth:`init_params`)."""
        cfg = self.cfg
        device = resolve_device(device)
        shape = (batch_size, capacity, cfg.n_kv, cfg.head_dim)
        return [attn.KVCache(
            k=torch.zeros(shape, dtype=policy.dtype("kv_cache", li),
                          device=device),
            v=torch.zeros(shape, dtype=policy.dtype("kv_cache", li),
                          device=device), pos=0)
            for li in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, params, batch, policy: PrecisionPolicy,
                capacity: Optional[int] = None):
        """Full-sequence forward; returns (last-position logits (B, 1, V),
        contiguous per-layer caches of ``capacity``)."""
        cfg = self.cfg
        policy = self._policy(policy)
        tokens = batch["tokens"]
        capacity = capacity or tokens.shape[1]
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        chunk = cfg.attn_chunk if x.shape[1] > cfg.attn_chunk else None
        states = []
        for li, layer in enumerate(params["layers"]):
            lp = policy.at_layer(li)
            x, st = self._block(layer, x, lp, lambda h, lp=lp, layer=layer:
                                attn.prefill_to_cache(layer["mix"], h, cfg,
                                                      lp, capacity,
                                                      chunk=chunk))
            states.append(st)
        return self._logits(params, x[:, -1:, :], policy), states

    @torch.no_grad()
    def prefill_chunk(self, params, tokens, states, policy: PrecisionPolicy,
                      *, slot: int, q_offset: int):
        """One chunked-prefill step for ONE sequence (tokens (1, C)) into
        ``slot`` of the per-layer paged caches.  Returns (last-position
        logits, new_states)."""
        cfg = self.cfg
        policy = self._policy(policy)
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        chunk = cfg.attn_chunk if tokens.shape[1] > cfg.attn_chunk else None
        new_states = list(states)
        for li, layer in enumerate(params["layers"]):
            lp = policy.at_layer(li)
            x, new_states[li] = self._block(
                layer, x, lp, lambda h, lp=lp, layer=layer, li=li:
                attn.prefill_paged_chunk(layer["mix"], h, cfg, lp,
                                         states[li], slot, q_offset,
                                         chunk=chunk))
        return self._logits(params, x[:, -1:, :], policy), new_states

    @torch.no_grad()
    def verify_step(self, params, tokens, states, policy: PrecisionPolicy):
        """Speculative-verify forward: K tokens per slot in ONE batched
        step, logits for every position.

        tokens: (B, K); position ``i`` of row ``b`` is the token the
        sequence consumes at cache position ``seq_lens[b] + i``.  Returns
        (logits (B, K, V), new paged states with K entries appended per
        mapped slot), where ``logits[:, i]`` is what the i-th of K
        sequential :meth:`decode_step` calls gives: every other layer acts
        row-wise, and attention goes per position through the same decode
        backend (``attention.verify_paged``).  The two agree bit for bit
        on the CPU plain path and on the card, where qmm sums a row in one
        order at every M, the norms' sums do not depend on the row count
        and an unpacked (tied) head multiplies fixed row blocks.  Not on
        an MoE config, in the reference neither: expert capacity depends
        on the row count, so verify may drop tokens a decode step keeps.

        Needs an all-attention decoder over paged caches, as in the
        reference: recurrent layer states cannot roll back rejected
        positions."""
        cfg = self.cfg
        policy = self._policy(policy)
        if any(kind != "attn" for kind in cfg.attn_pattern):
            raise ValueError(
                f"arch {cfg.arch}: verify_step needs an all-attention "
                f"pattern -- recurrent layer states cannot roll back "
                f"rejected speculative positions")
        if not all(isinstance(s, PagedKVCache) for s in states):
            raise ValueError("verify_step runs over paged KV caches")
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        new_states = list(states)
        for li, layer in enumerate(params["layers"]):
            lp = policy.at_layer(li)
            x, new_states[li] = self._block(
                layer, x, lp, lambda h, lp=lp, layer=layer, li=li:
                attn.verify_paged(layer["mix"], h, cfg, lp, states[li]))
        return self._logits(params, x, policy), new_states

    @torch.no_grad()
    def decode_step(self, params, tokens, states, policy: PrecisionPolicy):
        """tokens: (B, 1).  Returns (logits (B, 1, V), new states)."""
        cfg = self.cfg
        policy = self._policy(policy)
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        new_states = list(states)
        for li, layer in enumerate(params["layers"]):
            lp = policy.at_layer(li)
            x, new_states[li] = self._block(
                layer, x, lp, lambda h, lp=lp, layer=layer, li=li:
                attn.mha(layer["mix"], h, cfg, lp, cache=states[li]))
        return self._logits(params, x, policy), new_states
