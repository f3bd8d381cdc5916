"""Speculative decoding: a binary8 packed draft model sharing the page
pool.  The port of ``repro.engine.speculative``.

The draft is the transprecision approximation -- binary8 weights and
binary8 KV -- and exact greedy acceptance is the accuracy constraint:
``Model.verify_step`` computes what k sequential ``decode_step`` calls
compute, so an accepted token is the token non-speculative decode emits.

One speculation **round** replaces one batched decode step:

1. **Propose** -- k greedy draft ``decode_step``s from each slot's
   pending token against the draft's own KV pages: proposals
   ``q_1 .. q_k``.
2. **Verify** -- ONE target ``verify_step`` over ``[pending, q_1 ..
   q_{k-1}]``; its per-position argmax ``t_1 .. t_k``.
3. **Accept** -- with ``j`` leading positions where ``t_i == q_i``, emit
   ``t_1 .. t_m``, ``m = min(j + 1, k)``.
4. **Roll back** -- both sides appended k entries; the device lengths drop
   to ``base + m`` (``truncate_seq_lens``) and the scheduler truncates the
   host ``PagePool`` in both namespaces.

Draft and target KV share one ``PagePool``: the target in namespace
``""``, the draft under :data:`DRAFT_NAMESPACE`.  A round keeps the
pending tokens on the device; the scheduler makes one device -> host
transfer per round.

Resilience hooks, as in the reference: a round takes the fault
injector's ``nan_mask`` (poison a slot's verify logits) and ``div_mask``
(shift a slot's proposals off the target's argmax), each passed only when
such a fault is armed; and :meth:`SpeculativeDecoder.shadow_step` keeps
the draft KV in lockstep with the target while the circuit breaker holds
speculation open and the engine decodes plain.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels import paged_cache

from .worker import poison

DRAFT_NAMESPACE = "draft"


class SpeculativeDecoder:
    """The draft side of speculative serving: the draft model, its packed
    params, its per-layer paged KV caches (the target's pool geometry,
    pages from the shared ``PagePool`` under the ``draft`` namespace) and
    the propose -> verify -> rollback round.  ``Engine`` calls
    :meth:`setup` once and then :meth:`round` in place of its batched
    decode step."""

    NS = DRAFT_NAMESPACE

    def __init__(self, draft_model, draft_cfg, draft_policy, draft_params,
                 *, k: int):
        if k < 1:
            raise ValueError(f"--speculate-k must be >= 1, got {k}")
        self.model = draft_model
        self.cfg = draft_cfg
        self.policy = draft_policy
        self.params = draft_params
        self.k = int(k)
        self.states: Optional[List] = None
        self._target = None

    def setup(self, engine) -> None:
        """Check draft / target compatibility, build the draft's paged
        caches over the engine's pool geometry and device, and bind the
        target model the rounds verify with."""
        for name, cfg in (("target", engine.cfg), ("draft", self.cfg)):
            if cfg.encoder_layers or cfg.prefix_len:
                raise ValueError(
                    f"speculative decoding: {name} arch {cfg.arch} is not "
                    f"decoder-only (enc-dec / prefix-LM context cannot "
                    f"roll back)")
            if any(kind != "attn" for kind in cfg.attn_pattern):
                raise ValueError(
                    f"speculative decoding: {name} arch {cfg.arch} has "
                    f"recurrent layers (their state cannot roll back "
                    f"rejected positions)")
        if self.cfg.vocab != engine.cfg.vocab:
            raise ValueError(
                f"draft vocab {self.cfg.vocab} != target vocab "
                f"{engine.cfg.vocab}: proposals would index a different "
                f"token space")
        if self.cfg.window is not None and engine.capacity > self.cfg.window:
            raise ValueError(
                f"draft arch {self.cfg.arch}: engine capacity "
                f"{engine.capacity} exceeds the draft's sliding window "
                f"{self.cfg.window}")
        self.states = [
            paged_cache.init_paged_cache(
                engine.slots, engine.num_pages, engine.page,
                engine.pages_per_seq, self.cfg.n_kv, self.cfg.head_dim,
                self.policy.dtype("kv_cache", layer=li),
                device=engine.device)
            for li in range(self.cfg.n_layers)]
        self._target = (engine.model, engine.policy)

    def push_tables(self, tables: torch.Tensor) -> None:
        """The draft namespace's block tables (already on the device)."""
        self.states = [paged_cache.set_block_tables(s, tables)
                       for s in self.states]

    def prefill_prompt(self, slot: int, prompt: List[int]) -> None:
        """Write ``prompt``'s draft KV into ``slot``'s draft pages in one
        whole-prompt chunk (tables pushed by the caller)."""
        t = torch.tensor([list(prompt)], dtype=torch.int32,
                         device=self.states[0].seq_lens.device)
        _, self.states, _ = self.model.prefill_chunk(
            self.params, t, self.states, [None] * len(self.states),
            self.policy, slot=slot, q_offset=0)

    def release_slot(self, slot: int) -> None:
        """Reset ``slot``'s draft device row (eviction or completion)."""
        self.states = [paged_cache.release_slot(s, slot)
                       for s in self.states]

    @torch.no_grad()
    def shadow_step(self, tokens) -> None:
        """While the circuit breaker holds speculation open, advance the
        draft KV by the token the target just consumed (the scheduler
        decodes plain; the draft's logits are dropped): the draft cache
        stays in lockstep with the target, so acceptance has a chance the
        moment the breaker re-probes."""
        _, self.states = self.model.decode_step(self.params, tokens,
                                                self.states, self.policy)

    @torch.no_grad()
    def round(self, params, tokens, states, nan_mask=None, div_mask=None):
        """One speculation round with the target's ``params`` from its
        pending ``tokens`` (n, 1) over its paged ``states``.  Returns
        device tensors ``(tgt (n, k), m (n,), accepted (n,), pending
        (n, 1), bad (n,))`` and the target's new states; the draft's
        states are updated on ``self``.  ``nan_mask`` / ``div_mask`` are
        the fault injector's per-slot host masks (None = no fault, and
        then nothing is launched for them)."""
        target_model, target_policy = self._target
        k = self.k
        t, dstates = tokens, self.states
        dbases = [s.seq_lens for s in dstates]
        props = []
        for _ in range(k):
            dlogits, dstates = self.model.decode_step(self.params, t,
                                                      dstates, self.policy)
            t = torch.argmax(dlogits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
            props.append(t[:, 0])
        props = torch.stack(props, dim=1)                      # (n, k)
        if div_mask is not None:
            # injected draft divergence: shift a masked slot's proposals
            # off the target argmax (+1 mod vocab never matches); only
            # acceptance can suffer -- greedy verification stays exact
            div = torch.as_tensor(div_mask, dtype=torch.bool).to(
                props.device)[:, None]
            props = torch.where(div, (props + 1) % self.cfg.vocab, props)
        v = torch.cat([tokens, props[:, :-1]], dim=1)          # (n, k)
        bases = [s.seq_lens for s in states]
        logits, states = target_model.verify_step(params, v, states,
                                                  target_policy)
        if nan_mask is not None:
            logits = poison(logits, nan_mask)
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)     # (n, k)
        bad = ~torch.isfinite(logits).all(dim=2).all(dim=1)
        matches = (tgt == props).to(torch.int32)
        accepted = torch.cumprod(matches, dim=1).sum(dim=1)
        m = torch.clamp(accepted + 1, max=k)
        states = [paged_cache.truncate_seq_lens(s, b + m)
                  for s, b in zip(states, bases)]
        self.states = [paged_cache.truncate_seq_lens(s, b + m)
                       for s, b in zip(dstates, dbases)]
        pending = torch.gather(tgt, 1, (m - 1).long()[:, None])
        return tgt, m, accepted, pending, bad, states
