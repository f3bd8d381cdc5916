"""Continuous-batching scheduler over one shared page pool: the port of
``repro.engine.scheduler``.

Each engine step does, in order:

1. **Deadlines** -- requests (queued or slotted) past their per-request
   step deadline fail with a classified
   :class:`~repro_torch.engine.resilience.DeadlineExceeded` result (slot
   released, never a hang).  Deadlines count engine steps since the
   request was enqueued.
2. **Admission** -- while a prefill worker is idle and a slot is free,
   pop the queue head if ``PagePool.can_admit`` says its KV (plus one
   decode token) fits, and reserve its pages.  With one prefill worker
   (the default) one prompt is in flight; with N workers, N prompts, each
   through its own transport.
3. **One prefill chunk per in-flight prompt** (default: one page of
   tokens; ``prefill_chunk=0`` prefills the whole prompt at once),
   landing in the decode pool through the worker's transport; the last
   chunk's logits give the request's first token.  A prefix-LM request
   occupies its prefix rows and its prompt's, always prefilled whole, so
   its slot's length after prefill counts the prefix (the reference's
   engine drops those rows; its ``synchronous_generate`` keeps them).
   Recurrent layers (rwkv / rglru) have no pages: a prompt carries its
   own B = 1 state through its chunks, and when the prompt completes
   that state replaces its slot's row of the batched recurrent state
   (``_insert_slot``), so a reused slot starts from the new prompt's
   state, never from its last occupant's.
4. **Growth / eviction** -- every decoding slot gets a mapped page for
   its next token(s); when the pool runs dry the most recently admitted
   sequence is evicted back to the queue head (LIFO) and its pages
   reused.  A request evicted more than ``max_requeues`` times fails as a
   :class:`~repro_torch.engine.resilience.DeadLetterRequest`.
5. **One batched decode step** over every decoding slot, or with a
   :class:`~repro_torch.engine.speculative.SpeculativeDecoder` one
   speculation round; a mid-prefill slot's block-table row is masked to
   -1, so its writes drop and its length stays.

:meth:`Engine.run` drives a fixed request list to completion; the async
router (:mod:`repro_torch.engine.router`) feeds the same loop through
:meth:`Engine.enqueue` / :meth:`Engine.step` / :meth:`Engine.finalize`;
``step()`` returns the requests that reached a terminal state.

**Self-healing** (``docs/resilience.md`` has the recovery matrix): the
decode step and the speculation round run through a retry wrapper (the
injected step exception fires before the step launches anything, so a
re-run starts from the same pool bytes and lengths and is bit-identical,
although the port writes KV in place); the argmax tokens and the NaN/Inf
verdicts cross to the host in one transfer per step (:func:`_host`); a
slot with non-finite logits has its pages quarantined (never recycled)
and its request replays through
:func:`~repro_torch.engine.reference.synchronous_generate`, the oracle
the engine's tokens are pinned to; a
:class:`~repro_torch.engine.resilience.CircuitBreaker` drops persistent
draft divergence back to plain decode (draft KV kept warm by a shadow
step) and re-probes after a cooldown; and an optional wall-clock watchdog
turns wedged steps into a classified
:class:`~repro_torch.engine.resilience.WatchdogTimeout`.  An engine on a
card loads (and on a fresh checkout builds) every kernel library when it
is constructed, so the build never counts against the watchdog.

Deterministic fault schedules (:class:`~repro_torch.engine.faults.
FaultPlan`) exercise every path: under a plan of recoverable faults the
greedy tokens are bit-identical to the fault-free run.  With no fault
armed, the injector's hooks launch nothing and sync nothing.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build, paged_cache

from . import resilience
from .faults import FaultInjector, FaultPlan, SimulatedFault
from .reference import synchronous_generate
from .stats import EngineStats
from .transport import ColocatedTransport
from .worker import DecodeWorker, PrefillTask, PrefillWorker


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


def _insert_slot(batched, one, slot: int):
    """A recurrent layer's batched state with row ``slot`` replaced by the
    1-sequence state ``one`` (a new tensor per field: the decode step's
    earlier states stay as they were)."""
    fields = []
    for all_f, one_f in zip(batched, one):
        f = all_f.clone()
        f[slot:slot + 1] = one_f.to(f.device)
        fields.append(f)
    return type(batched)(*fields)


class Request:
    def __init__(self, rid: int, prompt: List[int], max_new: int,
                 deadline_steps: Optional[int] = None):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_steps = deadline_steps  # overrides the engine default
        self.generated: List[int] = []
        self.done = False
        self.evictions = 0
        self.error: Optional[Exception] = None  # classified EngineError
        self.enqueued_step = 0     # engine step at enqueue (deadline base)

    @property
    def failed(self) -> bool:
        return self.error is not None

    def reset(self):
        """Requeued after eviction: generation restarts from the prompt,
        and any stale classified error is cleared."""
        self.generated = []
        self.evictions += 1
        self.error = None


class Engine:
    """Paged continuous-batching engine over a fixed number of slots.  Its
    pools and token buffers live on ``device`` (default ``cuda``; raises
    when no card is present unless ``device="cpu"``), which must be the
    device the parameters live on.

    prefill_chunk: tokens prefilled per engine step (``None``: one page;
    ``0``: the whole prompt in one step).

    transport: one transport, or a list with one per concurrent prefill
    worker (the engine runs as many workers as it is given transports; a
    ``StreamedTransport`` owns a single-slot source pool and serves one
    worker).

    calibration_tap: a ``tuning.CalibrationTap`` offered every admitted
    prompt (the serve-time tuner's live-traffic reservoir).

    Resilience knobs, as in the reference: ``fault_plan``,
    ``deadline_steps`` (default per-request deadline in engine steps from
    enqueue), ``max_requeues`` (evictions a request survives before it
    dead-letters; None = forever), ``retry_policy``, ``breaker`` (default
    one with stock thresholds under speculation), ``watchdog_s`` /
    ``watchdog_limit`` (wall-clock budget per step; ``watchdog_limit``
    consecutive over-budget steps raise ``WatchdogTimeout``).
    """

    def __init__(self, model, cfg, policy, params, *, slots: int,
                 capacity: int,
                 page_size: int = paged_cache.DEFAULT_PAGE_SIZE,
                 pool_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 transport=None,
                 stats: Optional[EngineStats] = None,
                 speculative=None, calibration_tap=None,
                 fault_plan: Optional[FaultPlan] = None,
                 deadline_steps: Optional[int] = None,
                 max_requeues: Optional[int] = None,
                 retry_policy: Optional[resilience.RetryPolicy] = None,
                 breaker: Optional[resilience.CircuitBreaker] = None,
                 watchdog_s: Optional[float] = None,
                 watchdog_limit: int = 3, device=None):
        self.model, self.cfg, self.policy = model, cfg, policy
        self.calibration_tap = calibration_tap
        self.params = params
        self.slots = slots
        self.capacity = capacity
        if cfg.encoder_layers:
            raise ValueError(
                f"arch {cfg.arch}: the serving engine is decoder-only "
                f"(enc-dec decode needs per-step encoder context)")
        self.device = resolve_device(device)
        # only attention layers have pages; the others keep recurrent
        # states, one row a slot
        self.attn_layers = [li for li, k in enumerate(cfg.attn_pattern)
                            if k == "attn"]
        if (self.attn_layers and cfg.window is not None
                and capacity > cfg.window):
            raise ValueError(
                f"arch {cfg.arch}: --capacity {capacity} exceeds the "
                f"sliding window {cfg.window}; the paged engine keeps every "
                f"cached token, which matches windowed attention only while "
                f"capacity <= window -- lower --capacity")
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

        self.injector = FaultInjector(fault_plan, self.stats)
        self.retry_policy = (retry_policy if retry_policy is not None
                             else resilience.RetryPolicy())
        self.deadline_steps = deadline_steps
        self.max_requeues = max_requeues
        self.watchdog_s = watchdog_s
        self.watchdog_limit = int(watchdog_limit)
        if self.device.type == "cuda":
            # nvcc runs at first use (minutes on a fresh checkout): do it
            # now, so no timed step ever waits for a build
            _build.build_all()

        # each attention layer owns its pool, so the KV format may vary
        # by layer; recurrent layers hold one state row a slot
        self.states = model.recurrent_state(slots, policy, self.device)
        for li in self.attn_layers:
            self.states[li] = paged_cache.init_paged_cache(
                slots, self.num_pages, page, self.pages_per_seq, cfg.n_kv,
                cfg.head_dim, policy.dtype("kv_cache", layer=li),
                device=self.device)

        if transport is None:
            transports = [ColocatedTransport()]
        elif isinstance(transport, (list, tuple)):
            transports = list(transport)
            if not transports:
                raise ValueError("transport=[] gives no prefill worker")
        else:
            transports = [transport]
        if len(set(map(id, transports))) != len(transports):
            raise ValueError(
                "the same transport instance appears twice in the worker "
                "list; each prefill worker needs its own transport")
        self.transports = transports
        self.transport = transports[0]
        self.n_prefill_workers = len(transports)
        for tr in self.transports:
            tr.setup(self)
        chunk_tokens = page if prefill_chunk is None else prefill_chunk
        self.prefill_workers = [
            PrefillWorker(model, cfg, policy, tr, self.stats,
                          chunk_tokens=chunk_tokens)
            for tr in self.transports]
        self.decode_worker = DecodeWorker(model, policy)
        self.spec = speculative
        if self.spec is not None:
            self.spec.setup(self)
        self.breaker = breaker if breaker is not None else (
            resilience.CircuitBreaker() if speculative is not None
            else None)
        self.kv_bytes_per_token = sum(
            cfg.n_kv * cfg.head_dim * 2
            * policy.dtype("kv_cache", layer=li).itemsize
            for li in self.attn_layers)
        self.summary: Optional[dict] = None

        # serving-loop state: run() and the async router drive the same
        # incremental step machine (enqueue -> step* -> finalize)
        self._queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * slots
        self._admitted_at = [0] * slots  # admission counter per slot
        self._admissions = 0             # (LIFO eviction: newest first)
        self._tasks: List[PrefillTask] = []  # in-flight prompts
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
        self._terminal = 0        # requests that reached a terminal state
        self._step_done: List[Request] = []  # terminal this step
        self.decode_steps = 0
        self._engine_step = 0
        self._progressed = False  # non-step progress (failures) this step
        self._new_tokens = 0
        self._wd_over = 0         # consecutive over-budget steps
        self._finalized = False

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
        for li in self.attn_layers:
            self.states[li] = paged_cache.set_block_tables(self.states[li],
                                                           dev)

    def _init_pstates(self, transport):
        """Zero B = 1 recurrent states for a fresh prompt on the prefill
        worker's device (None at attention layers, whose KV goes
        straight into the pages)."""
        return self.model.recurrent_state(1, self.policy, transport.device)

    def _release_pages(self, si: int) -> None:
        """Reset ``si``'s device table row and length in every pool."""
        for li in self.attn_layers:
            self.states[li] = paged_cache.release_slot(self.states[li], si)

    def _rows(self, r: Request) -> int:
        """KV rows ``r``'s prefill lands: a prefix-LM's prefix rows and
        the prompt's (the slot's length after prefill)."""
        return self.cfg.prefix_len + len(r.prompt)

    def _check_feasible(self, r: Request) -> None:
        worst = self.pool.pages_for(self._rows(r) + r.max_new)
        total = worst * (2 if self.spec is not None else 1)
        if worst > self.pages_per_seq or total > self.num_pages:
            prefix = (f"prefix {self.cfg.prefix_len} + "
                      if self.cfg.prefix_len else "")
            raise ValueError(
                f"a single request needs {total} pages ({prefix}prompt "
                f"{len(r.prompt)} + max-new {r.max_new}, page size "
                f"{self.page}"
                + (", x2 for the draft namespace"
                   if self.spec is not None else "")
                + f") but the pool offers min({self.pages_per_seq} "
                f"per-seq, {self.num_pages} total); raise "
                f"--capacity/--pool-pages")

    def _deadline_of(self, r: Request) -> Optional[int]:
        return (r.deadline_steps if r.deadline_steps is not None
                else self.deadline_steps)

    def _task_for_slot(self, si: int) -> Optional[PrefillTask]:
        for task in self._tasks:
            if task.slot == si:
                return task
        return None

    # ----------------------------------------------------- serving interface
    def enqueue(self, r: Request) -> Request:
        """Admit ``r`` into the serving queue (an infeasible request is
        rejected here, at submission); the deadline clock starts now."""
        self._check_feasible(r)
        r.enqueued_step = self._engine_step
        self.stats.note_enqueued(r.rid)
        self._queue.append(r)
        return r

    def has_work(self) -> bool:
        """True while any request is queued, prefilling, or decoding."""
        return bool(self._queue or self._tasks
                    or any(s is not None for s in self._slots))

    def finalize(self) -> Optional[dict]:
        """Emit the summary line and close the stats stream (idempotent;
        run() calls it in a ``finally``)."""
        if not self._finalized:
            self._finalized = True
            self.summary = self.stats.summary(
                kv_bytes_per_token=self.kv_bytes_per_token,
                faults_unfired=len(self.injector.pending))
            self.stats.close()
        return self.summary

    # --------------------------------------------------------- step internals
    def _fail_request(self, r: Request, err: Exception) -> None:
        """Classified failure result: the request completes with
        ``r.error`` set, never hangs the loop."""
        r.error = err
        self._terminal += 1
        self._step_done.append(r)
        self._progressed = True
        self.stats.note_failure(getattr(type(err), "kind", "engine"))

    def _release_slot_state(self, si: int) -> None:
        """Free ``si`` everywhere: pool pages (all namespaces), device
        table rows, draft rows, and any in-flight prefill."""
        self.pool.free_slot(si)        # every namespace at once
        self._release_pages(si)
        if self.spec is not None:
            self.spec.release_slot(si)
        task = self._task_for_slot(si)
        if task is not None:
            self.transports[task.worker].abort(self, task)
            self._tasks.remove(task)
        self._slots[si] = None

    def _evict(self, si: int) -> None:
        # an eviction IS step progress: the requeued request becomes
        # admissible next iteration
        r = self._slots[si]
        self._release_slot_state(si)
        r.reset()
        self._progressed = True
        self.stats.note_eviction()
        if (self.max_requeues is not None
                and r.evictions > self.max_requeues):
            self._fail_request(r, resilience.DeadLetterRequest(
                f"request {r.rid} evicted {r.evictions} times "
                f"(max_requeues={self.max_requeues}); failing instead "
                f"of thrashing the pool"))
        else:
            self._queue.insert(0, r)

    def _newest_active(self) -> Optional[int]:
        active = [si for si in range(self.slots)
                  if self._slots[si] is not None]
        return max(active, key=lambda si: self._admitted_at[si]) \
            if active else None

    def _finish_slot(self, si: int) -> None:
        r = self._slots[si]
        r.done = True
        self._terminal += 1
        self._step_done.append(r)
        self.stats.note_completed()
        self._release_slot_state(si)

    def _quarantine_and_replay(self, si: int) -> int:
        """The NaN/Inf guard tripped for ``si``'s prefill, decode or verify
        logits: pull its pages out of circulation (suspect memory is never
        recycled) and regenerate the request through the synchronous
        oracle, which the engine's tokens are pinned to, so recovery keeps
        the determinism contract.  -> tokens emitted now."""
        r = self._slots[si]
        pages = self.pool.quarantine_slot(si)
        self._release_pages(si)
        if self.spec is not None:
            self.spec.release_slot(si)
        self._slots[si] = None
        self.stats.note_quarantine(pages)
        prev = len(r.generated)
        out = synchronous_generate(
            self.model, self.cfg, self.policy, self.params,
            [r.prompt], max_new=r.max_new,
            capacity=max(self.capacity, self._rows(r) + r.max_new),
            device=self.device)
        r.generated = list(out[0])
        r.done = True
        self._terminal += 1
        self._step_done.append(r)
        self._progressed = True
        self.stats.note_completed()
        self.stats.note_first_token(r.rid)
        self.stats.note_decode_tokens(len(r.generated) - prev)
        return len(r.generated) - prev

    def _complete_prefill(self, task: PrefillTask) -> None:
        """A prompt's last chunk just landed: write its recurrent states
        into the slot's rows, read its first token (one host transfer)
        and hand the slot to the decode batch."""
        r, si = task.request, task.slot
        tr = self.transports[task.worker]
        for li, kind in enumerate(self.cfg.attn_pattern):
            if kind != "attn":
                self.states[li] = _insert_slot(
                    self.states[li], tr.to_decode(task.pstates[li]), si)
        last = task.logits[0, -1]
        am, fin = _host(torch.argmax(last), torch.isfinite(last).all())
        if not bool(fin):
            self._new_tokens += self._quarantine_and_replay(si)
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

    # -------------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """One engine iteration; returns the requests that reached a
        terminal state (done or classified failure) during it."""
        n = self.slots
        self._step_done = []
        step = self._engine_step + 1    # 1-based, matches stats records
        self.injector.begin_step(step)
        t_step = time.perf_counter()
        self._new_tokens = 0
        self._progressed = False
        # ---- deadlines: expired requests fail classified, never hang ----
        for r in list(self._queue):
            dl = self._deadline_of(r)
            if dl is not None and self._engine_step - r.enqueued_step >= dl:
                self._queue.remove(r)
                self._fail_request(r, resilience.DeadlineExceeded(
                    f"request {r.rid} still queued after its "
                    f"{dl}-step deadline"))
        for si in range(n):
            r = self._slots[si]
            dl = self._deadline_of(r) if r is not None else None
            if dl is not None and self._engine_step - r.enqueued_step >= dl:
                self._release_slot_state(si)
                self._fail_request(r, resilience.DeadlineExceeded(
                    f"request {r.rid} exceeded its {dl}-step deadline "
                    f"({len(r.generated)}/{r.max_new} tokens)"))
        # ---- admission: one prompt in flight per idle prefill worker ----
        while self._queue and len(self._tasks) < self.n_prefill_workers:
            si = next((i for i in range(n) if self._slots[i] is None), None)
            if si is None:
                break
            need = self._rows(self._queue[0])
            needs = ((need + 1, need) if self.spec is not None
                     else (need + 1,))
            if not self.pool.can_admit(*needs):
                break
            r = self._queue.pop(0)
            ok = self.pool.allocate(si, need)
            if self.spec is not None:
                ok = ok and self.pool.allocate(si, need, ns=self.spec.NS)
            assert ok, (si, need)  # can_admit held above
            self._slots[si] = r
            self._admissions += 1
            self._admitted_at[si] = self._admissions
            self.stats.note_admitted(r.rid)
            if self.calibration_tap is not None:
                self.calibration_tap.observe(r.prompt)
            busy = {t.worker for t in self._tasks}
            wi = next(w for w in range(self.n_prefill_workers)
                      if w not in busy)
            task = PrefillTask(r, si, need, worker=wi)
            task.pstates = self._init_pstates(self.transports[wi])
            self.transports[wi].begin(self, task)
            self._tasks.append(task)
        # ---- one prefill chunk per task (decode below still runs) -------
        ran_chunks = 0
        if self._tasks:
            self._push_tables()
            for task in list(self._tasks):
                ran_chunks += 1
                self.stats.note_prefill_chunk(task.worker)
                tr = self.transports[task.worker]
                try:
                    view, vslot = tr.prefill_view(self, task)
                    view = self.prefill_workers[task.worker].step(
                        task, view, vslot)
                    tr.absorb(self, task, view)
                    if task.done:
                        tr.finish(self, task)
                except resilience.TransportError:
                    # checksum refetch exhausted: the handoff cannot be
                    # trusted, so recompute the request from its prompt
                    # (bounded by max_requeues like any other eviction)
                    self._evict(task.slot)
                    continue
                if task.done:
                    self._tasks.remove(task)
                    self._complete_prefill(task)
        # ---- growth: every decoding slot needs a mapped page for its
        # next token(s); evict LIFO when the pool runs dry --------------
        use_spec = (self.spec is not None
                    and self.breaker.allows(step))
        task_slots = {t.slot for t in self._tasks}
        for si in range(n):
            if self._slots[si] is None or si in task_slots:
                continue
            while self._slots[si] is not None:
                L = int(self.pool.lens[si])
                if use_spec:
                    # this round's worst case in BOTH namespaces: k
                    # appends, clamped to what the request can still emit
                    gi = min(self.spec.k, self._slots[si].max_new
                             - len(self._slots[si].generated))
                    ok = (self.pool.ensure_capacity(si, L + gi)
                          and self.pool.ensure_capacity(
                              si, L + gi, ns=self.spec.NS))
                elif self.spec is not None:
                    # degraded (breaker-open) step: one token, but the
                    # draft shadow append needs its page too
                    ok = (self.pool.ensure_capacity(si, L + 1)
                          and self.pool.ensure_capacity(
                              si, L + 1, ns=self.spec.NS))
                else:
                    ok = self.pool.ensure_capacity(si, L + 1)
                if ok and self.injector.pool_exhausted():
                    ok = False  # injected exhaustion: walk the normal
                if ok:          # eviction/requeue path below
                    break
                victim = self._newest_active()
                self._evict(victim)
                task_slots = {t.slot for t in self._tasks}
                if victim == si:
                    break
        # ---- one batched decode step over the page pool ---------------
        decoding = [si for si in range(n)
                    if self._slots[si] is not None and si not in task_slots]
        if decoding and use_spec:
            self._spec_round(step, decoding, task_slots)
        elif decoding:
            self._push_tables(mask_slots=task_slots)
            # None unless a fault is armed: then nothing is launched for it
            nan_mask = self.injector.slot_mask("nan_logits", decoding, n)

            def _decode_call():
                self.injector.maybe_raise()
                return self.decode_worker.step(self.params, self._tokens,
                                               self.states, nan_mask)

            nxt, bad_d, self.states = resilience.with_retries(
                _decode_call, self.retry_policy, self.stats,
                retriable=(SimulatedFault,), what="decode step")
            self.decode_steps += 1
            self.stats.note_target_step()
            if self.spec is not None:
                # breaker open: plain decode, but keep the draft KV in
                # lockstep so the half-open probe can accept again
                self.spec.shadow_step(self._tokens)
                self.stats.note_degraded_step()
            nxt_h, bad = _host(nxt, bad_d)
            for si in decoding:
                if bool(bad[si]):
                    self._new_tokens += self._quarantine_and_replay(si)
                    continue
                r = self._slots[si]
                self.pool.note_decode_step(si)
                if self.spec is not None:
                    self.pool.note_decode_step(si, ns=self.spec.NS)
                r.generated.append(int(nxt_h[si]))
                self.stats.note_decode_tokens(1)
                self._new_tokens += 1
                if len(r.generated) >= r.max_new:
                    self._finish_slot(si)
            self._tokens = nxt[:, None]
        elif self.has_work() and not ran_chunks and not self._progressed:
            # pre-run feasibility makes this unreachable without page
            # quarantine; with it, a loud classified error beats a hang
            raise resilience.EngineError(
                "engine stalled: queue non-empty but no slot "
                "admissible and no sequence decoding (quarantined "
                f"pages: {len(self.pool.quarantined)})")
        self._engine_step += 1
        self.stats.step_record(
            step=self._engine_step, queue_depth=len(self._queue),
            prefilling=ran_chunks, decoding=len(decoding),
            new_tokens=self._new_tokens, pool_stats=self.pool.stats())
        if self.watchdog_s is not None:
            if time.perf_counter() - t_step > self.watchdog_s:
                self.stats.note_watchdog_trip()
                self._wd_over += 1
                if self._wd_over >= self.watchdog_limit:
                    raise resilience.WatchdogTimeout(
                        f"{self._wd_over} consecutive engine steps over "
                        f"the {self.watchdog_s}s watchdog budget")
            else:
                self._wd_over = 0
        return self._step_done

    def _spec_round(self, step: int, decoding: List[int],
                    task_slots) -> None:
        """One speculation round (k draft steps + 1 verify) over the
        decoding slots, in place of the batched decode step."""
        self._push_tables(mask_slots=task_slots)
        nan_mask = self.injector.slot_mask("nan_logits", decoding,
                                           self.slots)
        div_mask = self.injector.slot_mask("draft_div", decoding,
                                           self.slots)

        def _spec_call():
            self.injector.maybe_raise()
            return self.spec.round(self.params, self._tokens, self.states,
                                   nan_mask=nan_mask, div_mask=div_mask)

        (tgt_d, m_d, acc_d, pending, bad_d,
         self.states) = resilience.with_retries(
            _spec_call, self.retry_policy, self.stats,
            retriable=(SimulatedFault,), what="speculation round")
        self.decode_steps += 1
        self.stats.note_target_step()
        tgt, m, acc, bad = _host(tgt_d, m_d, acc_d, bad_d)
        proposed = accepted = 0
        for si in decoding:
            if bool(bad[si]):
                self._new_tokens += self._quarantine_and_replay(si)
                continue
            r = self._slots[si]
            L = int(self.pool.lens[si])
            gi = min(self.spec.k, r.max_new - len(r.generated))
            # positions >= gi had no page mapped for them; the device
            # rollback kept base + m, so clamp the host view alike
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
        self.breaker.record(step=step, proposed=proposed,
                            accepted=accepted, stats=self.stats)
        self._tokens = pending

    # -------------------------------------------------------------------- run
    def run(self, reqs: List[Request]) -> List[Request]:
        """Drive a fixed request list to completion."""
        for r in reqs:
            self._check_feasible(r)   # all-or-nothing, before any enqueue
        for r in reqs:
            self.enqueue(r)
        base = self._terminal
        try:
            while self._terminal - base < len(reqs):
                self.step()
        finally:
            self.finalize()
        return reqs
