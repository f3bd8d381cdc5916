"""Prefill and decode workers: the compute the scheduler drives.

The prefill worker runs ``Model.prefill_chunk`` one chunk (default: one
page) at a time, writing each chunk's K/V page by page into the view its
transport hands it (the decode pool itself, or a streamed transport's
private source pool), so the transient staging buffer is one chunk per
layer.  ``chunk_tokens == 0``, or a prefix-LM config (whose prefix
rows need the whole-sequence path), is whole-prompt prefill: one
``Model.prefill`` into a contiguous cache of the prefix and prompt rows,
then a bulk ``write_prefill`` of all of them into the pages.  Recurrent
layers (rwkv / rglru) keep a B = 1 state per prompt in the task's
``pstates``, threaded through every chunk (or set by the whole-prompt
step); the scheduler writes it into the slot's row of the batched state
when the prompt completes.  The decode worker runs one batched
``decode_step`` and returns the argmax tokens and the NaN/Inf guard
verdicts, computed on the device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_cache


class PrefillTask:
    """One in-flight prompt: chunk cursor, stream cursor, and result."""

    def __init__(self, request, slot: int, n_tokens: int, worker: int = 0):
        self.request = request
        self.slot = slot
        self.n_tokens = n_tokens   # KV rows the prompt occupies
        self.worker = worker       # prefill worker / transport index
        self.offset = 0            # tokens already prefilled
        self.streamed = 0          # pages already handed to the decode pool
        self.done = False
        self.logits = None         # last-position logits once done
        self.pstates = None        # B=1 recurrent-layer states (rwkv/rglru)


def make_batch(cfg, prompt, device) -> dict:
    """The prefill batch of one prompt: its tokens and, for a prefix-LM
    config, ``cfg.prefix_len`` zero stub patch embeddings (f32), for an
    enc-dec config ``cfg.encoder_len`` zero stub frame embeddings (f32),
    as the reference serves them."""
    batch = {"tokens": torch.tensor([list(prompt)], dtype=torch.int32,
                                    device=device)}
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.zeros(
            (1, cfg.prefix_len, cfg.d_model), dtype=torch.float32,
            device=device)
    if cfg.encoder_layers:
        batch["encoder_embeds"] = torch.zeros(
            (1, cfg.encoder_len, cfg.d_model), dtype=torch.float32,
            device=device)
    return batch


class PrefillWorker:
    """Runs prompts into the transport-provided page-pool view.

    chunk_tokens > 0 on a decoder-only config: page-granular chunked
    prefill (transient staging = one chunk).  chunk_tokens == 0, or a
    prefix-LM config: one-shot ``Model.prefill`` followed by a bulk
    ``write_prefill`` (transient staging = the prefix and the prompt)."""

    def __init__(self, model, cfg, policy, transport, stats, *,
                 chunk_tokens: int):
        if chunk_tokens is None or chunk_tokens < 0:
            raise ValueError(f"--prefill-chunk must be >= 0 (0 = whole-"
                             f"prompt prefill), got {chunk_tokens}")
        self.model, self.cfg, self.policy = model, cfg, policy
        self.transport = transport
        self.stats = stats
        self.chunk_tokens = int(chunk_tokens)
        self.chunked = self.chunk_tokens > 0 and not cfg.prefix_len

    def _tokens(self, toks) -> torch.Tensor:
        return torch.tensor([list(toks)], dtype=torch.int32,
                            device=self.transport.device)

    def step(self, task: PrefillTask, view_states, slot: int):
        """Advance ``task`` by one chunk (or the whole prompt); returns
        the updated state view for the transport to absorb."""
        if not self.chunked:
            return self._whole_step(task, view_states, slot)
        C = min(self.chunk_tokens, task.n_tokens - task.offset)
        toks = task.request.prompt[task.offset:task.offset + C]
        logits, view_states, task.pstates = self.model.prefill_chunk(
            self.transport.params, self._tokens(toks), view_states,
            task.pstates, self.policy, slot=slot, q_offset=task.offset)
        self.stats.note_prefill_transient(C)
        task.offset += C
        if task.offset >= task.n_tokens:
            task.done = True
            task.logits = logits
        return view_states

    def _whole_step(self, task: PrefillTask, view_states, slot: int):
        batch = make_batch(self.cfg, task.request.prompt,
                           self.transport.device)
        logits, one = self.model.prefill(self.transport.params, batch,
                                         self.policy, None)
        view_states = list(view_states)
        for li, kind in enumerate(self.cfg.attn_pattern):
            if kind == "attn":
                view_states[li] = paged_cache.write_prefill(
                    view_states[li], slot, one[li].k[0], one[li].v[0])
            else:
                task.pstates[li] = one[li]
        self.stats.note_prefill_transient(task.n_tokens)
        task.offset = task.n_tokens
        task.done = True
        task.logits = logits
        return view_states


class DecodeWorker:
    """One batched decode step over the shared page pool.

    Returns ``(next_tokens, bad, states)``: the argmax and the NaN/Inf
    guard (``bad[s]``: slot ``s``'s logits hold a non-finite value) are
    computed on the device, so the scheduler's one host transfer a step
    carries the verdict.  ``nan_mask`` is the fault injector's per-slot
    poison mask (a host bool array), passed only on a step where a
    ``nan_logits`` fault is armed: a step without one launches nothing
    for it."""

    def __init__(self, model, policy):
        self.model, self.policy = model, policy

    def step(self, params, tokens, states, nan_mask=None):
        logits, states = self.model.decode_step(params, tokens, states,
                                                self.policy)
        if nan_mask is not None:
            logits = poison(logits, nan_mask)
        last = logits[:, -1, :]
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        bad = ~torch.isfinite(last).all(dim=-1)
        return nxt, bad, states


def poison(logits: torch.Tensor, mask) -> torch.Tensor:
    """``logits`` with the rows of ``mask`` (a host bool array over the
    slots) set to NaN: the injected ``nan_logits`` fault."""
    m = torch.as_tensor(mask, dtype=torch.bool).to(logits.device)
    return torch.where(m.view(-1, *([1] * (logits.dim() - 1))),
                       torch.full((), float("nan"), dtype=logits.dtype,
                                  device=logits.device), logits)
