"""Prefill and decode workers: the compute the scheduler drives.

The prefill worker runs ``Model.prefill_chunk`` one chunk (default: one
page) at a time, writing each chunk's K/V page by page into the pool, so
the transient staging buffer is one chunk per layer.  The decode worker
runs one batched ``decode_step`` and returns the argmax tokens and the
NaN/Inf guard verdicts, computed on the device.
"""
from __future__ import annotations

import torch


class PrefillTask:
    """One in-flight prompt: chunk cursor and result."""

    def __init__(self, request, slot: int, n_tokens: int, worker: int = 0):
        self.request = request
        self.slot = slot
        self.n_tokens = n_tokens
        self.worker = worker
        self.offset = 0
        self.done = False
        self.logits = None


class PrefillWorker:
    def __init__(self, model, cfg, policy, transport, stats, *,
                 chunk_tokens: int):
        if not chunk_tokens or chunk_tokens <= 0:
            raise ValueError("repro_torch's engine prefills in chunks; "
                             "--prefill-chunk must be positive (whole-prompt "
                             "prefill into pages is not ported yet)")
        self.model, self.cfg, self.policy = model, cfg, policy
        self.transport = transport
        self.stats = stats
        self.chunk_tokens = int(chunk_tokens)

    def step(self, task: PrefillTask, view_states, slot: int):
        """Advance ``task`` by one chunk; returns the updated states."""
        C = min(self.chunk_tokens, task.n_tokens - task.offset)
        toks = task.request.prompt[task.offset:task.offset + C]
        t = torch.tensor([toks], dtype=torch.int32,
                         device=self.transport.device)
        logits, view_states = self.model.prefill_chunk(
            self.transport.params, t, view_states, self.policy, slot=slot,
            q_offset=task.offset)
        self.stats.note_prefill_transient(C)
        task.offset += C
        if task.offset >= task.n_tokens:
            task.done = True
            task.logits = logits
        return view_states


class DecodeWorker:
    """One batched decode step over the shared page pool."""

    def __init__(self, model, policy):
        self.model, self.policy = model, policy

    def step(self, params, tokens, states):
        logits, states = self.model.decode_step(params, tokens, states,
                                                self.policy)
        last = logits[:, -1, :]
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        bad = ~torch.isfinite(last).all(dim=-1)
        return nxt, bad, states
