"""Synchronous single-request reference loop: the engine's oracle.

Each prompt (after a prefix-LM's zero stub patch embeddings) is
prefilled whole into contiguous KV caches of ``capacity`` rows (at most
the window) and the recurrent layers' states after the prompt, and
decoded greedily one request at a time.  Under binary32 the engine's
greedy tokens must match this loop token for token.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch import resolve_device

from .worker import make_batch


def synchronous_generate(model, cfg, policy, params, prompts, *,
                         max_new: int, capacity: int,
                         device=None) -> List[List[int]]:
    """Greedy-decode each prompt independently on ``device`` (default
    ``cuda``; raises when no card is present unless ``device="cpu"``);
    returns the generated token lists (first token included, like
    ``Request.generated``)."""
    device = resolve_device(device)
    outs: List[List[int]] = []
    for prompt in prompts:
        logits, states = model.prefill(
            params, make_batch(cfg, prompt, device), policy, capacity)
        toks = [int(torch.argmax(logits[0, -1]))]
        while len(toks) < max_new:
            t = torch.tensor([[toks[-1]]], dtype=torch.int32, device=device)
            logits, states = model.decode_step(params, t, states, policy)
            toks.append(int(torch.argmax(logits[0, -1, :])))
        outs.append(toks)
    return outs
