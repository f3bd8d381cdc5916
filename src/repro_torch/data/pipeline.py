"""Deterministic synthetic training data: the port of
``repro.data.pipeline``.

A batch is a pure function of ``(seed, step, host_id)``: it is drawn by a
``torch.Generator`` seeded from those three, so a restart or a resharded
resume recomputes any step's batch exactly (skip-ahead is a call with a
later step).  The stream is the reference's low-entropy one: tokens
below ``min(vocab, 97)``, a per-row ramp ``arange(S + 1) + randint(0,
7)`` taken mod ``min(vocab, 97)`` except where the ramp is a multiple
of 3, where a uniform token stands; ``labels`` are ``tokens`` shifted by
one.  A prefix-LM config's batch carries ``prefix_embeds`` and an
enc-dec config's ``encoder_embeds``, ``0.02 * N(0, 1)`` in f32.

The reference draws with ``jax.random`` (threefry), which torch does not
have, so the batches agree with the reference's in structure, dtypes,
ranges and distribution, not bit for bit; a test that compares the two
packages feeds both the reference's batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Markov-ish synthetic token stream (a pure function of the step)."""

    def __init__(self, dcfg: DataConfig, mcfg: ModelConfig):
        self.dcfg = dcfg
        self.mcfg = mcfg
        if dcfg.global_batch % dcfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = dcfg.global_batch // dcfg.n_hosts

    def _generator(self, step: int) -> torch.Generator:
        """The CPU generator of ``step``'s host shard, seeded from
        ``(seed, step, host_id)`` through numpy's ``SeedSequence``."""
        seq = np.random.SeedSequence([self.dcfg.seed, step,
                                      self.dcfg.host_id])
        seed = int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))
        return torch.Generator().manual_seed(seed)

    def batch_at(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """The host-local shard of the global batch for ``step``: int32
        ``tokens`` / ``labels`` (B, S) and the stub embeddings, drawn on
        the CPU and moved to ``device`` (default: left on the CPU)."""
        g = self._generator(step)
        B, S, V = self.host_batch, self.dcfg.seq_len, self.mcfg.vocab
        top = min(V, 97)
        base = torch.randint(0, top, (B, S + 1), generator=g,
                             dtype=torch.int32)
        ramp = (torch.arange(S + 1, dtype=torch.int32)[None, :]
                + torch.randint(0, 7, (B, 1), generator=g,
                                dtype=torch.int32))
        toks = torch.where(ramp % 3 == 0, base, ramp % top)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        cfg = self.mcfg
        if cfg.prefix_len:
            batch["prefix_embeds"] = 0.02 * torch.randn(
                (B, cfg.prefix_len, cfg.d_model), generator=g)
        if cfg.encoder_layers:
            batch["encoder_embeds"] = 0.02 * torch.randn(
                (B, cfg.encoder_len, cfg.d_model), generator=g)
        if device is not None:
            batch = {k: v.to(device) for k, v in batch.items()}
        return batch

    def state(self, step: int) -> Dict[str, int]:
        """Checkpointable pipeline state."""
        return {"seed": self.dcfg.seed, "step": step,
                "host_id": self.dcfg.host_id, "n_hosts": self.dcfg.n_hosts}

    @classmethod
    def restore(cls, state: Dict[str, int], dcfg: DataConfig,
                mcfg: ModelConfig) -> "SyntheticLM":
        if state["seed"] != dcfg.seed:
            raise ValueError("data seed changed across restore")
        return cls(dcfg, mcfg)
