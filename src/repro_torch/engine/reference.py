"""Synchronous single-request reference loop: the engine's oracle.

Each prompt (after a prefix-LM's zero stub patch embeddings, or over an
enc-dec config's zero stub frame embeddings) is prefilled whole into
contiguous KV caches of ``capacity`` rows (at most the window) and the
recurrent layers' states after the prompt, and decoded greedily one
request at a time.  Under binary32 the engine's greedy tokens must match
this loop token for token.

An enc-dec config's decode steps get the prefill's zero
``encoder_embeds`` too, as the reference's ``ServeTuner`` passes them
(``_decode_extra``).  A stated departure: the reference's loop passes
none, and its ``decode_step`` then fails on ``None.astype`` at the first
decode step.
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
        batch = make_batch(cfg, prompt, device)
        extra = {k: batch[k] for k in ("encoder_embeds",) if k in batch}
        logits, states = model.prefill(params, batch, policy, capacity)
        toks = [int(torch.argmax(logits[0, -1]))]
        while len(toks) < max_new:
            t = torch.tensor([[toks[-1]]], dtype=torch.int32, device=device)
            logits, states = model.decode_step(params, t, states, policy,
                                               **extra)
            toks.append(int(torch.argmax(logits[0, -1, :])))
        outs.append(toks)
    return outs
