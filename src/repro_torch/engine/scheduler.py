"""Continuous-batching scheduler over one shared page pool: the port of
the core of ``repro.engine.scheduler``.

Each engine step does, in order:

1. **Admission** -- while the prefill worker is idle and a slot is free,
   pop the queue head if ``PagePool.can_admit`` says its KV (plus one
   decode token) fits, and reserve its pages.
2. **One prefill chunk** (default: one page of tokens) for the prompt in
   flight, written straight into the pool; the last chunk's logits give
   the request's first token.
3. **Growth / eviction** -- every decoding slot gets a mapped page for its
   next token; when the pool runs dry the most recently admitted sequence
   is evicted back to the queue head (LIFO) and its pages reused.
4. **One batched decode step** over every decoding slot, or with a
   :class:`~repro_torch.engine.speculative.SpeculativeDecoder` one
   speculation round (k draft steps + one target verify); a mid-prefill
   slot's block-table row is masked to -1, so its writes drop and its
   length stays.

With speculation every slot also owns pages in the pool's ``draft``
namespace: admission reserves both sides, growth maps this round's worst
case (k tokens, clamped to what the request can still emit) on both,
acceptance truncates both, and finishing or eviction frees both.

The argmax tokens and the NaN/Inf verdicts (a round's targets, emit and
accept counts) cross to the host in one transfer per step
(:func:`_host`).  A slot whose logits are not finite fails with a
classified ``NonFiniteLogits`` result (the reference's
quarantine-and-replay, fault injection, the speculative circuit breaker,
deadlines and the router wait).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import paged_cache

from .stats import EngineStats
from .transport import ColocatedTransport
from .worker import DecodeWorker, PrefillTask, PrefillWorker


class NonFiniteLogits(RuntimeError):
    kind = "non_finite"


def _host(*tensors) -> List[np.ndarray]:
    """The loop's single device -> host synchronization point per step:
    every tensor as int32, in one copy, back in its own shape."""
    flat = torch.cat([t.to(torch.int32).reshape(-1) for t in tensors])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


class Request:
    def __init__(self, rid: int, prompt: List[int], max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False
        self.evictions = 0
        self.error: Optional[Exception] = None

    @property
    def failed(self) -> bool:
        return self.error is not None

    def reset(self):
        """Requeued after eviction: generation restarts from the prompt."""
        self.generated = []
        self.evictions += 1
        self.error = None


class Engine:
    """Paged continuous-batching engine over a fixed number of slots.  Its
    pools and token buffers live on ``device`` (default ``cuda``; raises
    when no card is present unless ``device="cpu"``), which must be the
    device the parameters live on."""

    def __init__(self, model, cfg, policy, params, *, slots: int,
                 capacity: int,
                 page_size: int = paged_cache.DEFAULT_PAGE_SIZE,
                 pool_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 transport=None, stats: Optional[EngineStats] = None,
                 speculative=None, device=None):
        self.model, self.cfg, self.policy = model, cfg, policy
        self.params = params
        self.slots = slots
        self.capacity = capacity
        self.device = resolve_device(device)
        if cfg.window is not None and capacity > cfg.window:
            raise ValueError(
                f"arch {cfg.arch}: --capacity {capacity} exceeds the "
                f"sliding window {cfg.window}")
        page = paged_cache.validate_page_size(page_size)
        self.page = page
        self.pages_per_seq = -(-capacity // page)
        if pool_pages is None:
            self.num_pages = slots * self.pages_per_seq
        elif pool_pages > 0:
            self.num_pages = pool_pages
        else:
            raise ValueError(
                f"--pool-pages must be positive, got {pool_pages}")
        self.pool = paged_cache.PagePool(self.num_pages, page, slots,
                                         self.pages_per_seq)
        self.stats = stats if stats is not None else EngineStats()
        # each layer owns its pool, so the KV format may vary by layer
        self.states = [
            paged_cache.init_paged_cache(
                slots, self.num_pages, page, self.pages_per_seq, cfg.n_kv,
                cfg.head_dim, policy.dtype("kv_cache", layer=li),
                device=self.device)
            for li in range(cfg.n_layers)]
        self.transport = transport if transport is not None \
            else ColocatedTransport()
        self.transport.setup(self)
        chunk_tokens = page if prefill_chunk is None else prefill_chunk
        self.prefill_worker = PrefillWorker(model, cfg, policy,
                                            self.transport, self.stats,
                                            chunk_tokens=chunk_tokens)
        self.decode_worker = DecodeWorker(model, policy)
        self.spec = speculative
        if self.spec is not None:
            self.spec.setup(self)
        self.kv_bytes_per_token = sum(
            cfg.n_kv * cfg.head_dim * 2
            * policy.dtype("kv_cache", layer=li).itemsize
            for li in range(cfg.n_layers))
        self.summary: Optional[dict] = None

        self._queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * slots
        self._admitted_at = [0] * slots
        self._admissions = 0
        self._task: Optional[PrefillTask] = None
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
        self._terminal = 0
        self.decode_steps = 0
        self._engine_step = 0
        self._new_tokens = 0

    # ------------------------------------------------------------------ utils
    def _push_tables(self, mask_slots=()) -> None:
        """Mirror the host block tables onto the device; ``mask_slots``
        hides mid-prefill slots from the decode step."""
        tables = self.pool.tables
        if mask_slots:
            tables = tables.copy()
            for si in mask_slots:
                tables[si] = -1
        # one host -> device copy per push, shared by every layer
        if self.spec is not None:
            dtables = self.pool.ns_tables(self.spec.NS).copy()
            for si in mask_slots:
                dtables[si] = -1
            both = torch.as_tensor(np.stack([tables, dtables])).to(
                self.device)
            dev = both[0]
            self.spec.push_tables(both[1])
        else:
            dev = torch.as_tensor(tables).to(self.device)
        for li in range(len(self.states)):
            self.states[li] = paged_cache.set_block_tables(self.states[li],
                                                           dev)

    def _check_feasible(self, r: Request) -> None:
        worst = self.pool.pages_for(len(r.prompt) + r.max_new)
        total = worst * (2 if self.spec is not None else 1)
        if worst > self.pages_per_seq or total > self.num_pages:
            raise ValueError(
                f"a single request needs {total} pages (prompt "
                f"{len(r.prompt)} + max-new {r.max_new}, page size "
                f"{self.page}"
                + (", x2 for the draft namespace"
                   if self.spec is not None else "")
                + f") but the pool offers min({self.pages_per_seq} "
                f"per-seq, {self.num_pages} total); raise "
                f"--capacity/--pool-pages")

    def enqueue(self, r: Request) -> Request:
        self._check_feasible(r)
        self.stats.note_enqueued(r.rid)
        self._queue.append(r)
        return r

    def has_work(self) -> bool:
        return bool(self._queue or self._task
                    or any(s is not None for s in self._slots))

    def finalize(self) -> Optional[dict]:
        if self.summary is None:
            self.summary = self.stats.summary(
                kv_bytes_per_token=self.kv_bytes_per_token)
            self.stats.close()
        return self.summary

    def _release_slot_state(self, si: int) -> None:
        self.pool.free_slot(si)        # every namespace at once
        for li in range(len(self.states)):
            self.states[li] = paged_cache.release_slot(self.states[li], si)
        if self.spec is not None:
            self.spec.release_slot(si)
        if self._task is not None and self._task.slot == si:
            self._task = None
        self._slots[si] = None

    def _evict(self, si: int) -> None:
        r = self._slots[si]
        self._release_slot_state(si)
        r.reset()
        self.stats.note_eviction()
        self._queue.insert(0, r)

    def _newest_active(self) -> Optional[int]:
        active = [si for si in range(self.slots)
                  if self._slots[si] is not None]
        return max(active, key=lambda si: self._admitted_at[si]) \
            if active else None

    def _finish_slot(self, si: int) -> None:
        self._slots[si].done = True
        self._terminal += 1
        self.stats.note_completed()
        self._release_slot_state(si)

    def _fail_slot(self, si: int, what: str) -> None:
        r = self._slots[si]
        r.error = NonFiniteLogits(f"request {r.rid}: non-finite {what}")
        self._terminal += 1
        self.stats.failures += 1
        self._release_slot_state(si)

    def _complete_prefill(self, task: PrefillTask) -> None:
        r, si = task.request, task.slot
        last = task.logits[0, -1]
        am, fin = _host(torch.argmax(last), torch.isfinite(last).all())
        if not bool(fin):
            self._fail_slot(si, "prefill logits")
            return
        r.generated.append(int(am))
        self.stats.note_first_token(r.rid)
        self.stats.note_decode_tokens(1)
        self._new_tokens += 1
        # as in the reference, the slot joins the decode batch even when
        # max_new == 1; completion is checked after each decode token
        self._tokens[si, 0] = int(am)
        if self.spec is not None:
            # the target prompt has landed; write the draft's KV for it
            # (the draft tables were pushed with the prefill chunk's)
            self.spec.prefill_prompt(si, r.prompt)

    def _round_tokens(self, si: int) -> int:
        """Tokens slot ``si`` may append this step: 1, or with speculation
        k clamped to what its request can still emit."""
        if self.spec is None:
            return 1
        r = self._slots[si]
        return min(self.spec.k, r.max_new - len(r.generated))

    def _grow(self, si: int) -> bool:
        """Map pages for this step's appends, in both namespaces under
        speculation."""
        need = int(self.pool.lens[si]) + self._round_tokens(si)
        ok = self.pool.ensure_capacity(si, need)
        if ok and self.spec is not None:
            ok = self.pool.ensure_capacity(si, need, ns=self.spec.NS)
        return ok

    def _spec_round(self, decoding: List[int]) -> None:
        """One speculation round over the decoding slots, in place of the
        batched decode step."""
        tgt_d, m_d, acc_d, pending, bad_d, self.states = self.spec.round(
            self.params, self._tokens, self.states)
        self.decode_steps += 1
        self.stats.note_target_step()
        tgt, m, acc, bad = _host(tgt_d, m_d, acc_d, bad_d)
        proposed = accepted = 0
        for si in decoding:
            if bool(bad[si]):
                self._fail_slot(si, "verify logits")
                continue
            r = self._slots[si]
            L = int(self.pool.lens[si])
            gi = self._round_tokens(si)
            # positions at or past gi had no page mapped for them; the
            # device rollback kept base + m, so clamp the host view alike
            mi = min(int(m[si]), gi)
            r.generated.extend(int(t) for t in tgt[si, :mi])
            self.stats.note_decode_tokens(mi)
            self._new_tokens += mi
            proposed += gi
            accepted += min(int(acc[si]), gi)
            self.pool.truncate(si, L + mi)
            self.pool.truncate(si, L + mi, ns=self.spec.NS)
            if len(r.generated) >= r.max_new:
                self._finish_slot(si)
        self.stats.note_spec_round(proposed=proposed, accepted=accepted)
        self._tokens = pending

    # -------------------------------------------------------------------- step
    def step(self) -> None:
        n = self.slots
        self._new_tokens = 0
        # ---- admission: one prompt in flight --------------------------------
        if self._queue and self._task is None:
            si = next((i for i in range(n) if self._slots[i] is None), None)
            need = len(self._queue[0].prompt)
            needs = (need + 1, need) if self.spec is not None \
                else (need + 1,)
            if si is not None and self.pool.can_admit(*needs):
                r = self._queue.pop(0)
                ok = self.pool.allocate(si, need)
                if self.spec is not None:
                    ok = ok and self.pool.allocate(si, need,
                                                   ns=self.spec.NS)
                assert ok, (si, need)   # can_admit held above
                self._slots[si] = r
                self._admissions += 1
                self._admitted_at[si] = self._admissions
                self.stats.note_admitted(r.rid)
                self._task = PrefillTask(r, si, need)
        # ---- one prefill chunk ----------------------------------------------
        ran_chunks = 0
        if self._task is not None:
            task = self._task
            self._push_tables()
            ran_chunks = 1
            self.stats.note_prefill_chunk(task.worker)
            view, vslot = self.transport.prefill_view(self, task)
            view = self.prefill_worker.step(task, view, vslot)
            self.transport.absorb(self, task, view)
            if task.done:
                self._task = None
                self._complete_prefill(task)
        # ---- growth: a mapped page for every decoding slot's next token ----
        task_slots = {self._task.slot} if self._task is not None else set()
        for si in range(n):
            if self._slots[si] is None or si in task_slots:
                continue
            while self._slots[si] is not None:
                if self._grow(si):
                    break
                victim = self._newest_active()
                self._evict(victim)
                task_slots = {self._task.slot} if self._task is not None \
                    else set()
                if victim == si:
                    break
        # ---- one batched decode step over the page pool ---------------------
        decoding = [si for si in range(n)
                    if self._slots[si] is not None and si not in task_slots]
        if decoding:
            self._push_tables(mask_slots=task_slots)
        if decoding and self.spec is not None:
            self._spec_round(decoding)
        elif decoding:
            nxt, bad_d, self.states = self.decode_worker.step(
                self.params, self._tokens, self.states)
            self.decode_steps += 1
            self.stats.note_target_step()
            nxt_h, bad = _host(nxt, bad_d)
            for si in decoding:
                if bool(bad[si]):
                    self._fail_slot(si, "decode logits")
                    continue
                r = self._slots[si]
                self.pool.note_decode_step(si)
                r.generated.append(int(nxt_h[si]))
                self.stats.note_decode_tokens(1)
                self._new_tokens += 1
                if len(r.generated) >= r.max_new:
                    self._finish_slot(si)
            self._tokens = nxt[:, None]
        elif self.has_work() and not ran_chunks:
            raise RuntimeError(
                "engine stalled: queue non-empty but no slot admissible "
                "and no sequence decoding")
        self._engine_step += 1
        self.stats.step_record(
            step=self._engine_step, queue_depth=len(self._queue),
            prefilling=ran_chunks, decoding=len(decoding),
            new_tokens=self._new_tokens, pool_stats=self.pool.stats())

    def run(self, reqs: List[Request]) -> List[Request]:
        """Drive a fixed request list to completion."""
        for r in reqs:
            self._check_feasible(r)
        for r in reqs:
            self.enqueue(r)
        base = self._terminal
        try:
            while self._terminal - base < len(reqs):
                self.step()
        finally:
            self.finalize()
        return reqs
