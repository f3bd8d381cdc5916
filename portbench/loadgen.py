"""The one traffic generator: every mix under ``portbench/traffic/`` is a
JSON file of parameters that this module reads.

Written for the benchmark in place of ``src/repro_torch/launch/serve.py``'s
prompts (a fixed length, ids below 97), which measure nothing a user
sends.  A mix gives:

``lengths``
    ``{"prompt": D, "output": D, "pool": N, "block": B}`` with each ``D``
    a log-normal ``{"median": m, "sigma": s, "min": lo, "max": hi}``.
    The pool holds ``N`` requests whose lengths are the distribution's
    quantiles at ``(i + 1/2) / N``, in ``N / B`` blocks of ``B``: each
    block holds one prompt length from each of the B prompt strata and one
    output length from each of the B output strata, paired the same way
    in every block.  A seed orders the blocks and the requests inside
    each, so every seed serves the same sizes and any run of a few blocks
    (a window's worth) carries nearly the same work: a seed changes which
    request comes when, not how much work a window holds.
``arrivals``
    ``{"kind": "closed", "clients": C}``: C clients, each sending its next
    request when its last one has finished (callers that wait for their
    reply).  No other kind is read yet.
``engine``
    the serving engine's knobs for this mix (slots, page size, capacity,
    prefill chunk, prefill workers).

Token ids are uniform over the whole vocabulary.  Everything is drawn
from the run's seed; the same seed gives the same requests in the same
order.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import gcd
from statistics import NormalDist
from typing import List

import numpy as np

_STRIDE = 7919          # a prime: which member of its stratum each
#                         block takes, the same for every seed


@dataclass
class Spec:
    """One request as the generator hands it out."""
    index: int              # position in the stream
    prompt: List[int]
    max_new: int


def _seed_words(seed: int) -> List[int]:
    """Any whole number, negative or past 64 bits, as SeedSequence words."""
    s = int(seed)
    words = [0 if s >= 0 else 1]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            return words


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        _seed_words(seed) + [int(x) for x in stream]))


def lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` stratified lengths of a clipped log-normal."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def pool(mix: dict) -> np.ndarray:
    """(N / B, B, 2) prompt and output lengths of the mix's pool, block by
    block, seed-free."""
    ln = mix["lengths"]
    n, b = int(ln["pool"]), int(ln["block"])
    k = n // b
    if k * b != n or k % _STRIDE == 0:
        raise ValueError(f"pool {n} must be a multiple of block {b} and "
                         f"the blocks no multiple of {_STRIDE}")
    p = lengths(ln["prompt"], n).reshape(b, k)   # p[j, c]: stratum j
    o = lengths(ln["output"], n).reshape(b, k)
    j = np.arange(b)
    pair = (j * _scatter(b)) % b                 # output stratum of j
    blocks = [np.stack([p[j, c], o[pair, (c * _STRIDE) % k]], axis=1)
              for c in range(k)]
    return np.stack(blocks)


def _scatter(b: int) -> int:
    """A multiplier coprime to ``b`` near b / golden ratio: prompt stratum
    j meets output stratum j * a mod b, which keeps the two nearly
    uncorrelated."""
    a = max(1, round(b * 0.618034))
    while gcd(a, b) != 1:
        a += 1
    return a


class Stream:
    """The seeded, endless request stream of one mix: the pool in a seeded
    order, then again in another, and so on."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, int(vocab)
        self.blocks = pool(mix)
        if mix["arrivals"]["kind"] != "closed":
            raise ValueError(f"arrivals kind {mix['arrivals']['kind']!r}: "
                             "only closed loops are generated")
        self._next = 0
        self._order: List[np.ndarray] = []

    def _size(self, i: int):
        k, b = self.blocks.shape[:2]
        epoch, at = divmod(i, k * b)
        while len(self._order) <= epoch:
            g = rng(self.seed, 1, len(self._order))
            order = g.permutation(k)
            self._order.append(np.stack([
                self.blocks[c][g.permutation(b)] for c in order]
            ).reshape(k * b, 2))
        return self._order[epoch][at]

    def take(self) -> Spec:
        i = self._next
        self._next += 1
        plen, olen = (int(x) for x in self._size(i))
        prompt = rng(self.seed, 3, i).integers(0, self.vocab, plen).tolist()
        return Spec(i, prompt, olen)
