"""Recovery machinery for the serving engine: classified errors, retry
policy, checksummed page handoff, and the speculative circuit breaker.

The port's copy of ``repro.engine.resilience``: the same error classes,
kinds and exit codes (70-75 here; ``kernels.paged_cache.PoolError`` holds
76), the same retry schedule and breaker, and :func:`page_checksums` over
torch page stacks -- the raw container bytes copied to the host and
hashed with ``zlib.crc32``, so the same page bytes give the reference's
CRCs.  The recovery matrix (fault -> detection -> action -> determinism
guarantee) is ``docs/resilience.md``.

* **Classified, never bare.**  Every failure the engine can surface is an
  :class:`EngineError` subclass with a stable ``kind`` tag and a distinct
  process ``exit_code`` (the serve CLI maps them).
* **Deterministic recovery.**  Every recoverable fault's recovery path
  restores bit-identical greedy tokens: CRC refetch restores the exact
  page bytes, a step retry re-runs a step that wrote nothing (the
  injected exception fires before any launch), and the NaN quarantine
  replays through the synchronous oracle.  Unrecoverable faults fail
  loudly as classified results -- never hangs, never silent corruption.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# classified errors (exit codes 70-75 here; paged_cache.PoolError holds 76)
# ---------------------------------------------------------------------------

class EngineError(RuntimeError):
    """Base class for every classified serving failure.

    ``kind`` is the stable machine-readable tag (stats counters and the
    structured stderr line key off it); ``exit_code`` is what the serve
    CLI exits with so supervisors can distinguish failure modes without
    parsing tracebacks.
    """

    exit_code = 70
    kind = "engine"


class DeadlineExceeded(EngineError):
    """A request ran past its per-request step deadline; its slot (if any)
    was released and the request carries this error instead of tokens."""

    exit_code = 71
    kind = "deadline"


class DeadLetterRequest(EngineError):
    """A request was evicted-and-requeued more than ``max_requeues`` times;
    rather than thrash the pool forever it fails as a dead letter."""

    exit_code = 72
    kind = "dead_letter"


class TransportError(EngineError):
    """Streamed page handoff failed for good: per-page CRC mismatches
    persisted through every refetch attempt."""

    exit_code = 73
    kind = "transport"


class StepFailure(EngineError):
    """A batched step kept raising through every retry attempt."""

    exit_code = 74
    kind = "step"


class WatchdogTimeout(EngineError):
    """Consecutive engine steps exceeded the wall-clock watchdog budget."""

    exit_code = 75
    kind = "watchdog"


def exit_code_for(exc) -> Optional[int]:
    """Distinct process exit code for a classified error, else None
    (covers :class:`EngineError` subtypes AND
    :class:`~repro_torch.kernels.paged_cache.PoolError`, which lives in the
    kernels layer so the allocator never imports the engine)."""
    code = getattr(type(exc), "exit_code", None)
    return int(code) if isinstance(code, int) else None


def format_error(exc, *, requests: Optional[int] = None) -> str:
    """One-line structured stderr summary for a classified error."""
    kind = getattr(type(exc), "kind", "error")
    parts = [f"[serve:error] kind={kind}", f"exit={exit_code_for(exc)}"]
    if requests is not None:
        parts.append(f"requests={requests}")
    parts.append(f'detail="{exc}"')
    return " ".join(parts)


# ---------------------------------------------------------------------------
# retries with capped exponential backoff
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: attempt ``i`` sleeps
    ``min(backoff_s * 2**i, backoff_cap_s)`` after a failure.  The engine
    default keeps delays tiny (faults here are simulated or transient);
    ``backoff_s=0`` disables sleeping entirely for tests."""

    max_attempts: int = 4
    backoff_s: float = 0.002
    backoff_cap_s: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"RetryPolicy.max_attempts must be >= 1, "
                f"got {self.max_attempts}")

    def delay_s(self, attempt: int) -> float:
        return min(self.backoff_s * (2 ** attempt), self.backoff_cap_s)

    def sleep(self, attempt: int) -> None:
        d = self.delay_s(attempt)
        if d > 0:
            time.sleep(d)


def with_retries(fn, policy: RetryPolicy, stats=None, *,
                 retriable=(Exception,), what: str = "step"):
    """Run ``fn`` up to ``policy.max_attempts`` times; re-raise anything
    outside ``retriable`` immediately, and raise :class:`StepFailure`
    when every attempt failed.  ``fn`` must be effect-free until it
    raises: the port writes KV into its pools in place, so the engine's
    injected step exception fires before its step launches anything, and
    a retry re-runs the same computation on the same state."""
    last = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203 -- retry loop
            last = e
            if stats is not None:
                stats.note_retry()
            policy.sleep(attempt)
    raise StepFailure(
        f"{what} failed {policy.max_attempts} consecutive attempts; "
        f"last error: {last}") from last


# ---------------------------------------------------------------------------
# checksummed page handoff
# ---------------------------------------------------------------------------

def _page_bytes(pages) -> np.ndarray:
    """(n_pages, ...) page stack -> (n_pages, bytes) uint8 on the host:
    a torch tensor's raw container bytes (any dtype, float8 included),
    or a numpy array's."""
    if isinstance(pages, torch.Tensor):
        t = pages.detach().contiguous()
        t = t.reshape(t.shape[0], -1).view(torch.uint8)
        return t.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(pages))
    return a.reshape(a.shape[0], -1).view(np.uint8)


def page_checksums(k_pages, v_pages) -> List[int]:
    """Per-page CRC32 over the packed payload bytes of ``(n_pages, page,
    n_kv, head_dim)`` K/V page stacks (torch tensors on any device, or
    numpy arrays).

    The pool tensors ARE the packed containers (f8 / bf16 / f16 / u32
    storage), so hashing their raw bytes is a CRC over the packed words --
    any bit flip anywhere in a page's K or V payload changes its
    checksum.  Computed from the source pool before the copy and
    recomputed from the decode pool after it; a mismatch triggers a
    refetch (see ``StreamedTransport``)."""
    kh = _page_bytes(k_pages)
    vh = _page_bytes(v_pages)
    return [zlib.crc32(vh[i].tobytes(), zlib.crc32(kh[i].tobytes()))
            for i in range(kh.shape[0])]


# ---------------------------------------------------------------------------
# speculative circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Classic closed -> open -> half-open breaker over speculation rounds.

    A round *fails* when the batch-wide acceptance rate is at or below
    ``min_accept_rate`` (default 0.0: not a single draft proposal matched
    the target -- the signature of a diverged/poisoned draft).  After
    ``fail_rounds`` consecutive failures the breaker opens: the engine
    falls back to plain batched decode (exact by construction) for
    ``cooldown_steps`` engine steps, keeping the draft KV warm with a
    shadow decode step so acceptance has a chance when the breaker
    half-opens and probes one speculative round.  A failed probe re-opens
    immediately; a successful one closes the breaker.
    """

    def __init__(self, *, fail_rounds: int = 3, cooldown_steps: int = 8,
                 min_accept_rate: float = 0.0):
        if fail_rounds < 1 or cooldown_steps < 1:
            raise ValueError(
                f"CircuitBreaker needs fail_rounds >= 1 and "
                f"cooldown_steps >= 1, got {fail_rounds}/{cooldown_steps}")
        self.fail_rounds = fail_rounds
        self.cooldown_steps = cooldown_steps
        self.min_accept_rate = float(min_accept_rate)
        self.state = "closed"          # closed | open | half_open
        self.failures = 0
        self.trips = 0
        self._reopen_at = 0

    def allows(self, step: int) -> bool:
        """May this engine step run a speculation round?  Flips open ->
        half_open (one probe round) once the cooldown has elapsed."""
        if self.state == "open":
            if step >= self._reopen_at:
                self.state = "half_open"
                return True
            return False
        return True

    def record(self, *, step: int, proposed: int, accepted: int,
               stats=None) -> None:
        """Account one speculation round's outcome."""
        if proposed <= 0:
            return
        if accepted / proposed > self.min_accept_rate:
            self.failures = 0
            self.state = "closed"
            return
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.fail_rounds:
            self.state = "open"
            self._reopen_at = step + self.cooldown_steps
            self.failures = 0
            self.trips += 1
            if stats is not None:
                stats.note_breaker_trip()
