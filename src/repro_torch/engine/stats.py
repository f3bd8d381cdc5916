"""EngineStats: per-step records and the end-of-run summary.

The port of the core of ``repro.engine.stats`` and its speculation
counters (the resilience counters wait with their features).  TTFT is
measured from enqueue on the host clock after the step that produced the
first token synchronised with the device, so it is end to end.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class EngineStats:
    def __init__(self, out_path: Optional[str] = None):
        self.out_path = out_path
        self.records: List[dict] = []
        self.ttft_s: Dict[int, float] = {}
        self.queue_wait_s: Dict[int, float] = {}
        self._enqueued_t: Dict[int, float] = {}
        self._admitted_t: Dict[int, float] = {}
        self.admitted = 0
        self.completed = 0
        self.decode_tokens = 0
        self.evictions = 0
        self.prefill_chunks: Dict[int, int] = {}
        # batched target forwards (decode steps or verify rounds), and the
        # speculation rounds, draft proposals judged and accepted
        self.target_steps = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.peak_prefill_transient_tokens = 0
        self.failures = 0
        self._t0 = time.perf_counter()
        self._fh = open(out_path, "w") if out_path else None

    def note_enqueued(self, rid) -> None:
        self._enqueued_t.setdefault(rid, time.perf_counter())

    def note_admitted(self, rid) -> None:
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
        self.completed += 1

    def note_prefill_chunk(self, worker: int) -> None:
        self.prefill_chunks[worker] = self.prefill_chunks.get(worker, 0) + 1

    def note_prefill_transient(self, n_tokens: int) -> None:
        self.peak_prefill_transient_tokens = max(
            self.peak_prefill_transient_tokens, int(n_tokens))

    def note_decode_tokens(self, n: int) -> None:
        self.decode_tokens += int(n)

    def note_eviction(self) -> None:
        self.evictions += 1

    def note_target_step(self) -> None:
        self.target_steps += 1

    def note_spec_round(self, *, proposed: int, accepted: int) -> None:
        """One speculation round: ``proposed`` draft tokens judged by the
        verify step across the batch, ``accepted`` of them matched."""
        self.spec_rounds += 1
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)

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

    def summary(self, *, kv_bytes_per_token: int = 0) -> dict:
        dt = time.perf_counter() - self._t0
        ttft = sorted(self.ttft_s.values())
        qwait = sorted(self.queue_wait_s.values())
        s = {
            "kind": "summary",
            "requests": self.completed + self.failures,
            "admitted": self.admitted,
            "completed": self.completed,
            "steps": len(self.records),
            "elapsed_s": round(dt, 6),
            "decode_tokens": self.decode_tokens,
            "tokens_per_s": round(self.decode_tokens / dt, 3) if dt > 0
            else 0.0,
            "ttft_mean_s": round(sum(ttft) / len(ttft), 6) if ttft else None,
            "ttft_max_s": round(ttft[-1], 6) if ttft else None,
            "queue_wait_mean_s": round(sum(qwait) / len(qwait), 6)
            if qwait else None,
            "prefill_chunks_by_worker": {
                str(w): c for w, c in sorted(self.prefill_chunks.items())},
            "evictions": self.evictions,
            # steps_per_token < 1 means speculation pays: fewer batched
            # target forwards than tokens emitted; accept_rate is None
            # without speculation
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
            "failures": self.failures,
        }
        self._emit(s)
        return s

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _emit(self, rec: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
