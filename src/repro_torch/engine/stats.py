"""EngineStats: structured per-step observability for the serving engine.

The port's copy of ``repro.engine.stats``, counters and summary keys
unchanged.  One dict per engine step -- queue depth, in-flight prefill,
decode batch size, tokens emitted this step, and the ``PagePool.stats()``
snapshot -- appended to ``records`` and, when an output path is given,
written as one JSON line per step (plus a final ``"kind": "summary"``
line).

The summary carries time-to-first-token per request (from *enqueue*, the
queue-wait component reported apart), decode tokens/s, evictions,
per-prefill-worker chunk counts, the peak transient prefill staging size,
the speculation counters, and the resilience counters: every injected
fault is explained by some combination of them.  TTFT is taken on the
host clock after the step that produced the first token synchronised
with the device, so it is end to end.

Request accounting is conservation-checked: every enqueued request ends
as exactly one of ``completed`` or ``failures``, and the summary's
``requests`` is their sum.  ``EngineStats`` is a context manager; the
scheduler closes the JSONL stream in a ``finally``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class EngineStats:
    def __init__(self, out_path: Optional[str] = None):
        self.out_path = out_path
        self.records: List[dict] = []
        self.ttft_s: Dict[int, float] = {}      # rid -> s to first token
        self.queue_wait_s: Dict[int, float] = {}  # rid -> s enqueue->admit
        self._enqueued_t: Dict[int, float] = {}
        self._admitted_t: Dict[int, float] = {}
        # request conservation: every enqueued request terminates as
        # exactly one of completed / failures (summary pins the sum)
        self.admitted = 0
        self.completed = 0
        self.decode_tokens = 0
        self.evictions = 0
        # chunks each prefill worker ran (worker index -> count): the
        # per-worker utilization column of the router's scaling story
        self.prefill_chunks: Dict[int, int] = {}
        # speculative decoding: batched target forward steps (decode steps
        # or verify rounds), draft proposals judged, proposals accepted
        self.target_steps = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # largest contiguous K/V staging buffer any prefill step built, in
        # tokens (chunked prefill: one chunk; whole-prompt: the prompt)
        self.peak_prefill_transient_tokens = 0
        # resilience: fault-injection and recovery accounting (see
        # docs/resilience.md) -- every injected fault must be explained by
        # some combination of these counters
        self.faults_injected = 0
        self.faults_by_kind: Dict[str, int] = {}
        self.retries = 0
        self.crc_mismatches = 0
        self.quarantines = 0
        self.quarantined_pages = 0
        self.degraded_steps = 0
        self.breaker_trips = 0
        self.watchdog_trips = 0
        self.failures = 0
        self.failures_by_kind: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self._fh = open(out_path, "w") if out_path else None

    # -- event hooks (called by scheduler / workers) -------------------------
    def note_enqueued(self, rid) -> None:
        """The request entered the serving queue: the TTFT clock starts
        here (a router submission waits in the queue before any slot
        sees it, and that wait is part of what the user experiences)."""
        self._enqueued_t.setdefault(rid, time.perf_counter())

    def note_admitted(self, rid) -> None:
        # first admission only: a re-admission after eviction keeps the
        # original clock, so TTFT stays end-to-end from the user's view
        if rid not in self._admitted_t:
            now = time.perf_counter()
            self.admitted += 1
            self._admitted_t[rid] = now
            self.queue_wait_s[rid] = now - self._enqueued_t.get(rid, now)

    def note_first_token(self, rid) -> None:
        start = self._enqueued_t.get(rid, self._admitted_t.get(rid))
        if rid not in self.ttft_s and start is not None:
            self.ttft_s[rid] = time.perf_counter() - start

    def note_completed(self) -> None:
        """One request finished with its full token budget (no error)."""
        self.completed += 1

    def note_prefill_chunk(self, worker: int) -> None:
        """Prefill worker ``worker`` ran one chunk this engine step."""
        self.prefill_chunks[worker] = self.prefill_chunks.get(worker, 0) + 1

    def note_prefill_transient(self, n_tokens: int) -> None:
        self.peak_prefill_transient_tokens = max(
            self.peak_prefill_transient_tokens, int(n_tokens))

    def note_decode_tokens(self, n: int) -> None:
        self.decode_tokens += int(n)

    def note_eviction(self) -> None:
        self.evictions += 1

    def note_target_step(self) -> None:
        """One batched target forward (a decode step or a verify round)."""
        self.target_steps += 1

    def note_spec_round(self, *, proposed: int, accepted: int) -> None:
        """One speculation round: ``proposed`` draft tokens judged by the
        verify step across the batch, ``accepted`` of them matched the
        target's argmax."""
        self.spec_rounds += 1
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)

    # -- resilience hooks ----------------------------------------------------
    def note_fault(self, kind: str) -> None:
        """One injected fault actually fired (FaultInjector.take)."""
        self.faults_injected += 1
        self.faults_by_kind[kind] = self.faults_by_kind.get(kind, 0) + 1

    def note_retry(self) -> None:
        """One recovery retry: a page refetch or a re-run batched step."""
        self.retries += 1

    def note_crc_mismatch(self) -> None:
        """A streamed page chunk failed its CRC check at absorb."""
        self.crc_mismatches += 1

    def note_quarantine(self, pages: int) -> None:
        """One sequence's pages were quarantined (NaN/Inf logit guard)."""
        self.quarantines += 1
        self.quarantined_pages += int(pages)

    def note_degraded_step(self) -> None:
        """One engine step decoded plain while the breaker held
        speculation open."""
        self.degraded_steps += 1

    def note_breaker_trip(self) -> None:
        self.breaker_trips += 1

    def note_watchdog_trip(self) -> None:
        self.watchdog_trips += 1

    def note_failure(self, kind: str) -> None:
        """A request finished with a classified EngineError result."""
        self.failures += 1
        self.failures_by_kind[kind] = self.failures_by_kind.get(kind, 0) + 1

    # -- per-step record ------------------------------------------------------
    def step_record(self, *, step: int, queue_depth: int, prefilling: int,
                    decoding: int, new_tokens: int,
                    pool_stats: dict) -> dict:
        rec = {
            "kind": "step",
            "step": step,
            "t_s": round(time.perf_counter() - self._t0, 6),
            "queue_depth": queue_depth,
            "prefilling": prefilling,
            "decoding": decoding,
            "new_tokens": new_tokens,
        }
        rec.update({f"pool_{k}": v for k, v in pool_stats.items()})
        self.records.append(rec)
        self._emit(rec)
        return rec

    # -- end of run -----------------------------------------------------------
    def summary(self, *, kv_bytes_per_token: int = 0,
                faults_unfired: int = 0) -> dict:
        dt = time.perf_counter() - self._t0
        ttft = sorted(self.ttft_s.values())
        qwait = sorted(self.queue_wait_s.values())
        steps = len(self.records)
        s = {
            "kind": "summary",
            # conservation: every terminal request is completed XOR failed
            # (len(ttft_s) would drop requests that failed pre-first-token)
            "requests": self.completed + self.failures,
            "admitted": self.admitted,
            "completed": self.completed,
            "steps": steps,
            "elapsed_s": round(dt, 6),
            "decode_tokens": self.decode_tokens,
            "tokens_per_s": round(self.decode_tokens / dt, 3) if dt > 0
            else 0.0,
            "ttft_mean_s": round(sum(ttft) / len(ttft), 6) if ttft else None,
            "ttft_max_s": round(ttft[-1], 6) if ttft else None,
            # the queue-wait component of TTFT (enqueue -> first
            # admission): under the router this is the backpressure /
            # burst-absorption number, distinct from prefill latency
            "queue_wait_mean_s": round(sum(qwait) / len(qwait), 6)
            if qwait else None,
            "queue_wait_max_s": round(qwait[-1], 6) if qwait else None,
            "prefill_chunks_by_worker": {
                str(w): c for w, c in sorted(self.prefill_chunks.items())},
            "prefill_utilization_by_worker": {
                str(w): round(c / steps, 4)
                for w, c in sorted(self.prefill_chunks.items())}
            if steps else {},
            "evictions": self.evictions,
            # steps-per-token < 1.0 means speculation is paying: fewer
            # batched target forwards than tokens emitted.  accept_rate is
            # None for non-speculative runs (no proposals to judge).
            "target_steps": self.target_steps,
            "steps_per_token": round(self.target_steps / self.decode_tokens,
                                     4) if self.decode_tokens else None,
            "spec_rounds": self.spec_rounds,
            "accept_rate": round(self.spec_accepted / self.spec_proposed, 4)
            if self.spec_proposed else None,
            "peak_prefill_transient_tokens":
                self.peak_prefill_transient_tokens,
            "peak_prefill_transient_bytes":
                self.peak_prefill_transient_tokens * int(kv_bytes_per_token),
            # resilience accounting (docs/resilience.md): counters must
            # explain every injected fault, and failures are classified
            # results on the requests, never hangs
            "faults_injected": self.faults_injected,
            # scheduled faults whose trigger never came up (e.g. a
            # draft_div plan on a non-speculative run) -- chaos CI pins
            # this to 0 so a plan silently not exercising a path is loud
            "faults_unfired": int(faults_unfired),
            "faults_by_kind": dict(sorted(self.faults_by_kind.items())),
            "retries": self.retries,
            "crc_mismatches": self.crc_mismatches,
            "quarantines": self.quarantines,
            "quarantined_pages": self.quarantined_pages,
            "degraded_steps": self.degraded_steps,
            "breaker_trips": self.breaker_trips,
            "watchdog_trips": self.watchdog_trips,
            "deadline_misses": self.failures_by_kind.get("deadline", 0),
            "dead_letters": self.failures_by_kind.get("dead_letter", 0),
            "failures": self.failures,
        }
        self._emit(s)
        return s

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # context-manager form: ``with EngineStats(path) as stats: ...``
    # guarantees the JSONL handle closes even when the run raises
    def __enter__(self) -> "EngineStats":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def _emit(self, rec: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
