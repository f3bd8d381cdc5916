"""Calibration prompt sampling for the serve-time precision tuner: the
port's copy of ``repro.tuning.calibrate`` (numpy only; the digests are the
reference's).

The paper's tuning flow is data-driven: per-variable formats are searched
against representative *input sets* and then joined (phase 2) so the
binding generalizes beyond any single input.  At LLM scale the input sets
are token prompts.  Two sources:

``synthetic_calibration``
    Held-out batches drawn from the model's vocabulary with a fixed seed --
    the offline path ``python -m repro_torch.tuning`` uses, and exactly the
    distribution ``launch/serve.py`` serves in its synthetic-traffic loop,
    so the tuned binding is measured on the traffic it will serve.

``CalibrationTap``
    A live-traffic reservoir the engine feeds: pass one to
    ``Engine(calibration_tap=...)`` and every *admitted* prompt is offered
    to a bounded reservoir sample (Vitter's algorithm R, deterministic
    seed).  Once enough traffic has flowed, ``sets()`` partitions the
    reservoir into calibration sets for a ServeTuner run -- online
    autotuning against what the deployment actually serves.

Every ``CalibrationSet`` carries a content digest; the tuner records the
joint digest in the artifact's provenance so a tuned policy is traceable
to the exact token streams it was calibrated on.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CalibrationSet:
    """One input set of the search: a batch of token prompts."""
    prompts: Tuple[Tuple[int, ...], ...]

    @property
    def digest(self) -> str:
        h = hashlib.sha256()
        for p in self.prompts:
            h.update(b"|")
            h.update(np.asarray(p, np.int64).tobytes())
        return h.hexdigest()[:16]

    def __len__(self) -> int:
        return len(self.prompts)


def digest_of(sets: Sequence[CalibrationSet]) -> str:
    """Joint content digest over all calibration sets (provenance)."""
    h = hashlib.sha256()
    for s in sets:
        h.update(s.digest.encode())
    return h.hexdigest()[:16]


def synthetic_calibration(cfg, *, n_sets: int = 2, prompts_per_set: int = 4,
                          prompt_len: int = 16,
                          seed: int = 0) -> List[CalibrationSet]:
    """Held-out synthetic prompt sets (same token distribution as the
    synthetic serving traffic in ``launch/serve.py``)."""
    sets = []
    for i in range(n_sets):
        rng = np.random.default_rng(seed + 1000 * (i + 1))
        prompts = tuple(
            tuple(rng.integers(0, min(cfg.vocab, 97),
                               prompt_len).tolist())
            for _ in range(prompts_per_set))
        sets.append(CalibrationSet(prompts))
    return sets


class CalibrationTap:
    """Bounded reservoir sample of live serving traffic.

    ``observe(prompt)`` is called by the engine at admission time (cheap:
    one RNG draw + at most one list write, never touches device state).
    """

    def __init__(self, capacity: int = 256, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._reservoir: List[Tuple[int, ...]] = []
        self.n_observed = 0

    def observe(self, prompt: Sequence[int]) -> None:
        self.n_observed += 1
        if len(self._reservoir) < self.capacity:
            self._reservoir.append(tuple(int(t) for t in prompt))
            return
        j = int(self._rng.integers(0, self.n_observed))
        if j < self.capacity:
            self._reservoir[j] = tuple(int(t) for t in prompt)

    def __len__(self) -> int:
        return len(self._reservoir)

    def sets(self, *, n_sets: int = 2,
             prompts_per_set: int = 4) -> List[CalibrationSet]:
        """Partition the reservoir into calibration sets (raises until
        enough traffic has been observed)."""
        need = n_sets * prompts_per_set
        if len(self._reservoir) < need:
            raise ValueError(
                f"calibration tap holds {len(self._reservoir)} prompts; "
                f"{need} needed for {n_sets} sets x {prompts_per_set} -- "
                f"serve more traffic before tuning")
        return [
            CalibrationSet(tuple(
                self._reservoir[i * prompts_per_set + j]
                for j in range(prompts_per_set)))
            for i in range(n_sets)]
