"""The LM: the port of ``repro.models.transformer`` for the ``dense`` and
``moe`` families, the ``vlm`` prefix-LM, the attention-free ``ssm``
(rwkv6), the ``hybrid`` (RG-LRU blocks and local attention) and the
``audio`` encoder-decoder (whisper: an encoder over stub frame
embeddings, with no final norm, and a cross attention after every
decoder block's self-attention), rmsnorm or layernorm.  Per-layer kinds
(attn | rwkv | rglru) come from ``cfg.attn_pattern``.  Attention layers keep their KV
in caches (contiguous, or the engine's page pool); recurrent layers keep
a per-sequence state (``RwkvState`` / ``RglruState``), which chunked
prefill threads through ``pstates``.  Parameters are plain nested dicts
of tensors, made on ``cuda`` unless the caller passes ``device="cpu"``;
the forward entry points run on the device their parameters live on.
:meth:`Model.train_loss` is the training forward (the others run under
``torch.no_grad``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels.paged_cache import PagedKVCache

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .base import ModelConfig
from .layers import (add_norm, dense_init, embed_lookup, ffn_apply,
                     ffn_init, lm_head_loss, lm_logits, norm_init,
                     residual_add)


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
        unless ``device="cpu"``).  ``gen`` must live on that device.  An
        enc-dec config's decoder layers also hold ``norm_x`` and
        ``xattn`` (in their layer's dtypes), and ``params["encoder"]``
        its encoder blocks, drawn after the decoder's in the global
        dtypes, as the reference's are."""
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
        for li, kind in enumerate(cfg.attn_pattern):
            lp = policy.at_layer(li)
            fdt = lp.dtype("ffn_w")
            layer: Dict[str, Any] = {
                "norm1": norm_init(cfg.d_model, cfg.norm, device)}
            if kind == "attn":
                layer["mix"] = attn.attn_init(gen, cfg, lp.dtype("attn_w"),
                                              device)
            elif kind == "rwkv":
                layer["mix"] = rwkv_mod.rwkv_init(gen, cfg,
                                                  lp.dtype("attn_w"), device)
            else:
                # the reference makes rglru's weights in the ffn_w dtype
                layer["mix"] = rglru_mod.rglru_init(gen, cfg, fdt, device)
            layer["norm2"] = norm_init(cfg.d_model, cfg.norm, device)
            if kind != "rwkv":  # rwkv's channel mix lives in its "mix"
                layer["ffn"] = (moe_mod.moe_init(gen, cfg, fdt, device)
                                if cfg.moe_experts else
                                ffn_init(gen, cfg.d_model, cfg.d_ff,
                                         cfg.gated_ffn, cfg.use_bias, fdt,
                                         device))
            if cfg.encoder_layers:  # the decoder's cross attention
                layer["norm_x"] = norm_init(cfg.d_model, cfg.norm, device)
                layer["xattn"] = attn.attn_init(gen, cfg, lp.dtype("attn_w"),
                                                device, cross=True)
            params["layers"].append(layer)
        if cfg.encoder_layers:
            params["encoder"] = [{
                "norm1": norm_init(cfg.d_model, cfg.norm, device),
                "mix": attn.attn_init(gen, cfg, policy.dtype("attn_w"),
                                      device),
                "norm2": norm_init(cfg.d_model, cfg.norm, device),
                "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                                cfg.use_bias, policy.dtype("ffn_w"), device),
            } for _ in range(cfg.encoder_layers)]
        return params

    def _head_w(self, params):
        if self.cfg.tied_embeddings:
            return params["embed"].T
        return params["head"]

    def _block(self, layer, kind, x, f, lp, attend, state=None,
               enc_out=None):
        """One decoder block of kind ``kind``.  ``x`` is the residual
        stream before the previous block's FFN output ``f`` joins it
        (None before the first block), so each norm takes its residual
        add with it (``add_norm``: one launch on the kernel route).  An
        attention block calls ``attend(h)``; a recurrent block carries
        ``state`` (an rwkv block's channel mix takes the FFN's place).
        With ``enc_out`` (an enc-dec config) the ``norm_x`` -> cross
        attention step runs between the mixer and ``norm2``.  Returns
        ``(x, f, state, aux)`` with this block's FFN output not yet
        added; ``aux`` is the MoE FFN's load-balancing loss (None for
        another FFN), which :meth:`train_loss` adds up and the serving
        paths drop, as the reference's do."""
        cfg = self.cfg
        x, h = add_norm(x, f, layer["norm1"], lp, cfg.norm)
        if kind == "attn":
            a, st = attend(h)
        elif kind == "rwkv":
            a, st = rwkv_mod.time_mix(layer["mix"], h, cfg, lp, state=state)
        else:
            a, st = rglru_mod.rglru_block(layer["mix"], h, cfg, lp,
                                          state=state)
        if enc_out is not None:
            x, h = add_norm(x, a, layer["norm_x"], lp, cfg.norm)
            a, _ = attn.mha(layer["xattn"], h, cfg, lp, kv_source=enc_out)
        x, h = add_norm(x, a, layer["norm2"], lp, cfg.norm)
        aux = None
        if kind == "rwkv":
            f, st = rwkv_mod.channel_mix(layer["mix"], h, cfg, lp, state=st)
        elif cfg.moe_experts:
            f, aux = moe_mod.moe_apply(layer["ffn"], h, cfg, lp)
        else:
            f = ffn_apply(layer["ffn"], h, lp, cfg)
        return x, f, st, aux

    def _encode(self, params, embeds, policy):
        """The encoder over ``embeds`` (B, T, d): pre-norm blocks of
        non-causal self-attention and the FFN, and no final norm, so the
        last block's FFN output joins the stream in a plain residual add
        (the one add outside ``add_norm``)."""
        cfg = self.cfg
        x, f = embeds, None
        for layer in params["encoder"]:
            x, h = add_norm(x, f, layer["norm1"], policy, cfg.norm)
            a, _ = attn.mha(layer["mix"], h, cfg, policy, causal=False)
            x, h = add_norm(x, a, layer["norm2"], policy, cfg.norm)
            f = ffn_apply(layer["ffn"], h, policy, cfg)
        return residual_add(x, f)

    def _enc_out(self, params, embeds, dtype, policy):
        """The encoder output of ``embeds``, cast to ``dtype`` (the
        embedding output's) first, as the reference casts it."""
        if embeds is None:
            raise ValueError(
                f"arch {self.cfg.arch} is enc-dec: pass encoder_embeds "
                f"(B, {self.cfg.encoder_len}, {self.cfg.d_model}) or "
                f"enc_out")
        return self._encode(params, embeds.to(dtype), policy)

    def _logits(self, params, x, f, policy):
        """The last block's FFN output ``f`` joins ``x``, the final norm,
        the head."""
        _, h = add_norm(x, f, params["final_norm"], policy, self.cfg.norm)
        return lm_logits(h, self._head_w(params), policy)

    def train_loss(self, params, batch, policy: PrecisionPolicy,
                   loss_count=None):
        """The training loss of ``batch`` (``tokens``, ``labels`` (B, S);
        optionally ``label_mask``, a prefix-LM's ``prefix_embeds`` and an
        enc-dec config's ``encoder_embeds``): the whole-sequence causal
        forward, each block under ``torch.utils.checkpoint`` when
        ``cfg.remat`` (its activations recomputed in the backward, the
        reference's ``jax.checkpoint``), the chunked cross-entropy of the
        token positions (a prefix's rows are sliced off before it), and
        an MoE config's ``0.01 * aux / n_layers``.  Attention follows
        ``decode_impl``: under ``flash_pallas`` the ``flash_prefill``
        kernel with a recompute backward.  Not under ``torch.no_grad``:
        the caller differentiates it.  ``loss_count`` divides the
        summed cross-entropy instead of this batch's count (the sharded
        train step passes the global count over the data shards, so the
        shards' losses average to the global-batch mean)."""
        cfg = self.cfg
        policy = self._policy(policy)
        x = embed_lookup(params["embed"], batch["tokens"], policy,
                         scale=cfg.embed_scale)
        prefix_len = 0
        if cfg.prefix_len and "prefix_embeds" in batch:
            pe = batch["prefix_embeds"].to(device=x.device, dtype=x.dtype)
            x = torch.cat([pe, x], dim=1)
            prefix_len = pe.shape[1]
        enc_out = None
        if cfg.encoder_layers:
            enc_out = self._enc_out(params, batch.get("encoder_embeds"),
                                    x.dtype, policy)
        chunk = cfg.attn_chunk if x.shape[1] > cfg.attn_chunk else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        f = None
        for li, (kind, layer) in enumerate(zip(cfg.attn_pattern,
                                               params["layers"])):
            lp = policy.at_layer(li)

            def run(x, f, layer=layer, kind=kind, lp=lp):
                x, f, _, aux = self._block(
                    layer, kind, x, f, lp, lambda h: attn.mha(
                        layer["mix"], h, cfg, lp, prefix_len=prefix_len,
                        chunk=chunk), enc_out=enc_out)
                return x, f, aux

            if cfg.remat:
                x, f, aux = checkpoint(run, x, f, use_reentrant=False)
            else:
                x, f, aux = run(x, f)
            if aux is not None:
                aux_total = aux_total + aux
        _, h = add_norm(x, f, params["final_norm"], policy, cfg.norm)
        if prefix_len:
            h = h[:, prefix_len:]
        loss = lm_head_loss(h, self._head_w(params), batch["labels"], policy,
                            n_chunks=cfg.loss_chunks,
                            label_mask=batch.get("label_mask"),
                            count=loss_count)
        if cfg.moe_experts:
            loss = loss + 0.01 * aux_total / max(cfg.n_layers, 1)
        return loss

    def recurrent_state(self, batch_size, policy, device=None) -> List:
        """Zero states of the recurrent layers for ``batch_size``
        sequences, None at the attention layers (whose KV the caller
        keeps)."""
        cfg = self.cfg
        out: List[Any] = []
        for li, kind in enumerate(cfg.attn_pattern):
            lp = policy.at_layer(li)
            if kind == "rwkv":
                out.append(rwkv_mod.rwkv_init_state(cfg, batch_size, lp,
                                                    device))
            elif kind == "rglru":
                out.append(rglru_mod.rglru_init_state(cfg, batch_size, lp,
                                                      device))
            else:
                out.append(None)
        return out

    def init_state(self, batch_size, capacity, policy, device=None):
        """Per-layer decode states on ``device`` (default ``cuda``, as
        :meth:`init_params`): contiguous KV caches of ``capacity`` rows
        (at most the window) for attention layers, zero recurrent states
        for the others (the synchronous loop's)."""
        cfg = self.cfg
        device = resolve_device(device)
        cap = capacity if cfg.window is None else min(capacity, cfg.window)
        shape = (batch_size, cap, cfg.n_kv, cfg.head_dim)
        states = self.recurrent_state(batch_size, policy, device)
        for li, kind in enumerate(cfg.attn_pattern):
            if kind == "attn":
                dt = policy.dtype("kv_cache", li)
                states[li] = attn.KVCache(
                    k=torch.zeros(shape, dtype=dt, device=device),
                    v=torch.zeros(shape, dtype=dt, device=device), pos=0)
        return states

    @torch.no_grad()
    def prefill(self, params, batch, policy: PrecisionPolicy,
                capacity: Optional[int] = None):
        """Full-sequence forward; returns (last-position logits (B, 1, V),
        per-layer decode states: contiguous caches of ``capacity`` (at
        most the window) for attention layers, the recurrent states after
        the prompt for the others).

        A prefix-LM config takes ``batch["prefix_embeds"]`` (B, P, d)
        before the tokens, cast to the embedding's dtype (f32 under
        ``embed_scale``), and attends over the P prefix rows
        bidirectionally.  The default capacity is every row computed,
        prefix and tokens, so the cache keeps the prefix and its ``pos``
        counts it.  The reference's default is the tokens alone
        (``src/repro/models/transformer.py:236``), which keeps only the
        last ``S`` rows of the ring and so drops the prefix from decode;
        its ``synchronous_generate`` passes a capacity that keeps them,
        and the port follows that.

        An enc-dec config takes ``batch["encoder_embeds"]`` (B, T, d),
        cast to the embedding output's dtype and encoded once; every
        decoder block attends over the encoder output after its
        self-attention."""
        cfg = self.cfg
        policy = self._policy(policy)
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        prefix_len = 0
        if cfg.prefix_len and "prefix_embeds" in batch:
            pe = batch["prefix_embeds"].to(device=x.device, dtype=x.dtype)
            x = torch.cat([pe, x], dim=1)
            prefix_len = pe.shape[1]
        enc_out = None
        if cfg.encoder_layers:
            enc_out = self._enc_out(params, batch.get("encoder_embeds"),
                                    x.dtype, policy)
        capacity = capacity or x.shape[1]
        chunk = cfg.attn_chunk if x.shape[1] > cfg.attn_chunk else None
        states = self.recurrent_state(x.shape[0], policy, x.device)
        f = None
        for li, (kind, layer) in enumerate(zip(cfg.attn_pattern,
                                               params["layers"])):
            lp = policy.at_layer(li)
            x, f, states[li], _ = self._block(
                layer, kind, x, f, lp, lambda h, lp=lp, layer=layer:
                attn.prefill_to_cache(layer["mix"], h, cfg, lp, capacity,
                                      prefix_len=prefix_len, chunk=chunk),
                state=states[li], enc_out=enc_out)
        return self._logits(params, x[:, -1:, :], f[:, -1:, :],
                            policy), states

    @torch.no_grad()
    def prefill_chunk(self, params, tokens, states, pstates,
                      policy: PrecisionPolicy, *, slot: int, q_offset: int):
        """One chunked-prefill step for ONE sequence (tokens (1, C)).

        Attention layers write the chunk's K/V into ``slot`` of the
        per-layer paged caches in ``states``; recurrent layers carry
        their own B = 1 state through ``pstates`` (None at attention
        layers), and their entries of ``states`` pass through untouched:
        the scheduler writes ``pstates`` into the batched state when the
        prompt completes.  Returns (last-position logits, new_states,
        new_pstates).  Decoder-only: a prefix-LM prefills its prefix and
        prompt whole (:meth:`prefill`), and so does an enc-dec config."""
        cfg = self.cfg
        policy = self._policy(policy)
        if cfg.prefix_len or cfg.encoder_layers:
            raise ValueError(
                "prefill_chunk is decoder-only; prefix-LM / enc-dec archs "
                "prefill whole-prompt (Model.prefill)")
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        chunk = cfg.attn_chunk if tokens.shape[1] > cfg.attn_chunk else None
        new_states, new_pstates = list(states), list(pstates)
        f = None
        for li, (kind, layer) in enumerate(zip(cfg.attn_pattern,
                                               params["layers"])):
            lp = policy.at_layer(li)
            x, f, st, _ = self._block(
                layer, kind, x, f, lp, lambda h, lp=lp, layer=layer, li=li:
                attn.prefill_paged_chunk(layer["mix"], h, cfg, lp,
                                         states[li], slot, q_offset,
                                         chunk=chunk),
                state=pstates[li])
            if kind == "attn":
                new_states[li] = st
            else:
                new_pstates[li] = st
        return self._logits(params, x[:, -1:, :], f[:, -1:, :],
                            policy), new_states, new_pstates

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

        Needs an all-attention decoder-only config over paged caches, as
        in the reference: recurrent layer states cannot roll back
        rejected positions, and neither a prefix-LM nor an enc-dec
        config reaches speculation."""
        cfg = self.cfg
        policy = self._policy(policy)
        if cfg.encoder_layers or cfg.prefix_len:
            raise ValueError(
                "verify_step is decoder-only (no prefix / encoder context)")
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
        f = None
        for li, layer in enumerate(params["layers"]):
            lp = policy.at_layer(li)
            x, f, new_states[li], _ = self._block(
                layer, "attn", x, f, lp, lambda h, lp=lp, layer=layer, li=li:
                attn.verify_paged(layer["mix"], h, cfg, lp, states[li]))
        return self._logits(params, x, f, policy), new_states

    @torch.no_grad()
    def decode_step(self, params, tokens, states, policy: PrecisionPolicy,
                    enc_out=None, encoder_embeds=None):
        """tokens: (B, 1).  Returns (logits (B, 1, V), new states):
        attention layers append to their caches (contiguous or paged),
        recurrent layers take one recurrent step of every row.  An
        enc-dec config attends over ``enc_out``, or encodes
        ``encoder_embeds`` anew when ``enc_out`` is None (the whole
        encoder a step, as the reference does): the same computation on
        the same input, so the two give the same bits."""
        cfg = self.cfg
        policy = self._policy(policy)
        x = embed_lookup(params["embed"], tokens, policy,
                         scale=cfg.embed_scale)
        if cfg.encoder_layers and enc_out is None:
            enc_out = self._enc_out(params, encoder_embeds, x.dtype, policy)
        new_states = list(states)
        f = None
        for li, (kind, layer) in enumerate(zip(cfg.attn_pattern,
                                               params["layers"])):
            lp = policy.at_layer(li)
            x, f, new_states[li], _ = self._block(
                layer, kind, x, f, lp, lambda h, lp=lp, layer=layer, li=li:
                attn.mha(layer["mix"], h, cfg, lp, cache=states[li]),
                state=states[li], enc_out=enc_out)
        return self._logits(params, x, f, policy), new_states
