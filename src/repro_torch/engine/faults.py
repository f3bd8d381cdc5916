"""Deterministic, seeded fault injection for the serving engine.

The port's copy of ``repro.engine.faults``: the same plan spelling, JSON
form, sticky arming and seeded bit flips (:meth:`FaultInjector.corrupt`
flips the reference's bit for the same seed and the same bytes, on a
torch tensor's raw container bytes).

A :class:`FaultPlan` is a *schedule*: a list of faults keyed by engine
step index, plus one PRNG seed for the byte-level details (which bit of
which page a corruption flips).  The same plan against the same request
set produces the same faults at the same points every run -- which is what
lets the chaos tests pin a hard invariant: under a schedule of
*recoverable* faults, the engine's greedy tokens are **bit-identical** to
the fault-free run (see ``docs/resilience.md`` for the recovery matrix).

Fault kinds (``Fault.kind``):

``chunk_drop`` / ``chunk_dup`` / ``page_corrupt``
    Transport faults, consumed by ``StreamedTransport`` during page
    handoff: the chunk copy is skipped entirely, performed twice, or lands
    with one seeded bit flipped in a destination page.  Detected by the
    per-page CRC check; recovered by refetch.
``nan_logits``
    Poisons one decoding slot's logits to NaN on the device (the mask is
    built on the host only when the fault is armed, so a step with no
    fault launches exactly what it launches without the injector).
    Detected by the finite guard; recovered by page quarantine + replay.
``draft_div``
    Forces the draft model's proposals off the target's argmax for one
    round (every proposal shifted by +1 mod vocab).  Exact greedy
    acceptance already guarantees correctness; repeated divergence trips
    the speculative circuit breaker.
``step_exception``
    Raises :class:`SimulatedFault` just before a batched step runs.
    Recovered by the retry wrapper (the exception fires before the step
    launches anything, so a re-run is bit-identical).
``pool_exhaust``
    Makes one page-growth attempt report pool exhaustion, forcing the
    LIFO eviction/requeue path.

Arming is **sticky**: a fault scheduled for step ``s`` fires at the first
*opportunity* at or after ``s`` (e.g. a ``chunk_drop@3`` waits for the
next streamed copy), so every scheduled fault is accounted for -- the
chaos tests assert ``injector.all_fired`` and that the stats counters
explain every injected fault.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

KINDS = ("chunk_drop", "chunk_dup", "page_corrupt", "nan_logits",
         "draft_div", "step_exception", "pool_exhaust")
TRANSPORT_KINDS = ("chunk_drop", "chunk_dup", "page_corrupt")


class SimulatedFault(RuntimeError):
    """The injected step exception: transient by construction, so the
    engine's retry wrapper treats it as retriable."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` at engine ``step`` (1-based, matching
    the ``step`` field of the stats records), optionally pinned to a
    ``slot`` for the kinds that target one sequence."""

    kind: str
    step: int
    slot: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; legal kinds: "
                f"{', '.join(KINDS)}")
        if self.step < 1:
            raise ValueError(
                f"fault step must be >= 1 (steps are 1-based), "
                f"got {self.step}")

    @property
    def spec(self) -> str:
        tail = f"/{self.slot}" if self.slot is not None else ""
        return f"{self.kind}@{self.step}{tail}"


class FaultPlan:
    """An immutable, seeded schedule of :class:`Fault` entries.

    Build directly, via :meth:`parse` (the compact CLI spelling
    ``"page_corrupt@2,chunk_drop@3/1,seed=7"``), or via :meth:`load`
    (inline spec or a ``.json`` file with
    ``{"seed": 7, "faults": [{"kind": ..., "step": ..., "slot": ...}]}``).
    """

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults = tuple(sorted(faults, key=lambda f: f.step))
        self.seed = int(seed)

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def describe(self) -> str:
        body = ",".join(f.spec for f in self.faults) or "<empty>"
        return f"{body} (seed={self.seed})"

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``"kind@step[/slot],...,seed=N"`` -- entries in any order,
        repeats allowed (each repeat is one more scheduled fault)."""
        faults: List[Fault] = []
        seed = 0
        for raw in spec.split(","):
            item = raw.strip()
            if not item:
                continue
            if item.startswith("seed="):
                seed = int(item[len("seed="):])
                continue
            if "@" not in item:
                raise ValueError(
                    f"fault spec entry {item!r} is not 'kind@step[/slot]' "
                    f"or 'seed=N'")
            kind, _, at = item.partition("@")
            slot: Optional[int] = None
            if "/" in at:
                at, _, s = at.partition("/")
                slot = int(s)
            faults.append(Fault(kind.strip(), int(at), slot))
        return cls(faults, seed=seed)

    @classmethod
    def from_json(cls, doc: dict) -> "FaultPlan":
        faults = [Fault(f["kind"], int(f["step"]),
                        f.get("slot"))
                  for f in doc.get("faults", ())]
        return cls(faults, seed=int(doc.get("seed", 0)))

    @classmethod
    def load(cls, spec: str) -> "FaultPlan":
        """CLI entry point: a ``.json`` path or an inline compact spec."""
        if spec.endswith(".json") or os.path.exists(spec):
            with open(spec) as f:
                return cls.from_json(json.load(f))
        return cls.parse(spec)

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [{"kind": f.kind, "step": f.step,
                            **({"slot": f.slot} if f.slot is not None
                               else {})}
                           for f in self.faults]}


class FaultInjector:
    """Consumes a :class:`FaultPlan` during an engine run.

    The scheduler calls :meth:`begin_step` once per loop iteration and
    then polls the kind-specific hooks at each injection point; a fault is
    *taken* (moved from pending to fired, counted in the stats) exactly
    once, at the first opportunity at or after its scheduled step.  With
    an empty plan every hook is a cheap no-op, so the engine carries the
    injector unconditionally.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, stats=None):
        self.plan = plan if plan is not None else FaultPlan()
        self.stats = stats
        self.pending: List[Fault] = list(self.plan)
        self.fired: List[Fault] = []
        self.rng = np.random.default_rng(self.plan.seed)
        self.step = 0

    def begin_step(self, step: int) -> None:
        self.step = int(step)

    @property
    def all_fired(self) -> bool:
        return not self.pending

    def take(self, kind: str) -> Optional[Fault]:
        """Pop the earliest armed (scheduled step <= current step) fault
        of ``kind``, if any."""
        if not self.pending:
            return None
        for i, f in enumerate(self.pending):
            if f.step > self.step:
                break  # pending is step-sorted
            if f.kind == kind:
                self.fired.append(self.pending.pop(i))
                if self.stats is not None:
                    self.stats.note_fault(kind)
                return f
        return None

    def take_transport(self) -> Optional[Fault]:
        """One armed transport fault (drop/dup/corrupt), earliest first."""
        if not self.pending:
            return None
        for i, f in enumerate(self.pending):
            if f.step > self.step:
                break
            if f.kind in TRANSPORT_KINDS:
                self.fired.append(self.pending.pop(i))
                if self.stats is not None:
                    self.stats.note_fault(f.kind)
                return f
        return None

    def slot_mask(self, kind: str, decoding: Sequence[int],
                  n_slots: int) -> Optional[np.ndarray]:
        """Armed ``nan_logits`` / ``draft_div`` faults as a per-slot bool
        mask over ``n_slots`` (None when nothing is armed).  A fault
        pinned to a slot that is not currently decoding falls back to the
        first decoding slot, so a scheduled fault always lands."""
        if not self.pending or not decoding:
            return None
        mask = None
        f = self.take(kind)
        while f is not None:
            if mask is None:
                mask = np.zeros(n_slots, np.bool_)
            si = f.slot if f.slot in decoding else decoding[0]
            mask[si] = True
            f = self.take(kind)
        return mask

    def maybe_raise(self) -> None:
        """Raise an armed ``step_exception`` as :class:`SimulatedFault`."""
        f = self.take("step_exception")
        if f is not None:
            raise SimulatedFault(
                f"injected step exception (scheduled step {f.step}, "
                f"fired step {self.step})")

    def pool_exhausted(self) -> bool:
        """True when an armed ``pool_exhaust`` fault fires on this growth
        attempt (the scheduler then walks its normal eviction path)."""
        return self.take("pool_exhaust") is not None

    def corrupt(self, pages):
        """Flip one seeded bit somewhere in the raw bytes of a page stack
        (any dtype -- the flip happens on the byte view, exactly the
        single-event-upset model CRC32 always detects).  A torch tensor
        comes back as a new tensor of its dtype on its device, a numpy
        array as a new array; the source is untouched."""
        if isinstance(pages, torch.Tensor):
            src = pages.detach().contiguous()
            host = src.reshape(-1).view(torch.uint8).cpu().numpy().copy()
            self._flip(host)
            out = torch.from_numpy(host).to(src.device)
            return out.view(src.dtype).reshape(src.shape)
        host = np.array(np.asarray(pages), copy=True)
        self._flip(host.view(np.uint8).reshape(-1))
        return host

    def _flip(self, flat: np.ndarray) -> None:
        i = int(self.rng.integers(0, flat.size))
        flat[i] ^= np.uint8(1 << int(self.rng.integers(0, 8)))
