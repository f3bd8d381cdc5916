"""Asyncio request router: the process-level serving front-end.

The port of ``repro.engine.router``: the same tickets, streams,
backpressure and error routing.  On a card the engine thread binds the
engine's device before it steps, and every kernel wrapper takes its
launch stream from ``torch.cuda.current_stream`` in the calling thread,
so the engine thread's kernels and torch ops queue on one stream.

The engine's step loop is synchronous and deterministic; real traffic is
neither.  The router bridges the two: clients ``await submit(...)`` from
any number of coroutines, the engine steps on a dedicated background
thread, and every submission gets back a :class:`RouterTicket` -- an
awaitable terminal :class:`~repro_torch.engine.scheduler.Request` plus an
optional per-token async stream.  Request flow::

    submit() ──> pending list ──> Engine.enqueue() ──> slot + prefill
    (client      (thread-safe     (engine thread,      worker ──> decode
     coroutine)   handoff)         FIFO arrival order)  batch ──> ticket

Multiple **prefill workers** run concurrently: the engine is built with
one transport per worker (``Engine(transport=[...])``),
so each worker prefills its own prompt through its own transport (with
``--disaggregate``, its own
:class:`~repro_torch.engine.transport.StreamedTransport` source pool)
while the single decode batch keeps emitting.  Tokens stay bit-identical to
:func:`~repro_torch.engine.reference.synchronous_generate` regardless of
arrival timing -- evictions restart a request from its prompt, so
scheduling can cost steps, never content.

**Error-kind routing** (the classified
:class:`~repro_torch.engine.resilience.EngineError` taxonomy;
docs/resilience.md has the full recovery matrix):

=============  ==================================================
kind           router behavior
=============  ==================================================
deadline       fail THAT request: its ticket resolves with
               ``request.error`` set; everything else keeps serving
dead_letter    same -- a per-request terminal result, not a fault
transport      invisible here: CRC refetch happens inside the
               streamed transport; exhaustion evicts + recomputes
pool           backpressure: the request waits in the queue (and
               ``max_pending`` makes ``submit()`` itself await)
step/watchdog  fatal: the engine thread is wedged or lying, so every
engine         outstanding ticket fails with the same classified
               error and the router refuses new submissions
=============  ==================================================

Infeasible requests (a prompt that cannot fit the pool at all) are
rejected synchronously: ``submit()`` raises ``ValueError`` before the
request ever reaches the queue.

The engine thread owns ALL engine and device state; the event loop owns all
futures and streams.  The two touch only through the pending list (under
a condition variable) and ``loop.call_soon_threadsafe``.
"""
from __future__ import annotations

import asyncio
import threading
from typing import Dict, List, Optional

import torch

from .scheduler import Engine, Request

_STREAM_END = object()


class RouterTicket:
    """One submitted request: an awaitable result + a token stream.

    ``await ticket.result()`` returns the terminal Request -- check
    ``request.error`` for per-request classified failures (deadline,
    dead-letter); only an engine-fatal error raises.  ``async for tok in
    ticket.tokens()`` streams tokens as decode emits them; an eviction
    rolls uncommitted tokens back, which the stream reports as one
    ``None`` marker before restarting from the prompt.
    """

    def __init__(self, request: Request, loop: asyncio.AbstractEventLoop):
        self.request = request
        self._loop = loop
        self._done: asyncio.Future = loop.create_future()
        self._stream: asyncio.Queue = asyncio.Queue()
        self._emitted = 0

    @property
    def rid(self):
        return self.request.rid

    async def result(self) -> Request:
        return await self._done

    async def tokens(self):
        while True:
            t = await self._stream.get()
            if t is _STREAM_END:
                return
            yield t

    # -- event-loop side (reached via call_soon_threadsafe) ------------------
    def _emit_new(self) -> None:
        gen = self.request.generated
        if len(gen) < self._emitted:  # evicted: tokens were uncommitted
            self._stream.put_nowait(None)
            self._emitted = 0
        for t in gen[self._emitted:]:
            self._stream.put_nowait(t)
        self._emitted = len(gen)

    def _resolve(self) -> None:
        self._emit_new()
        self._stream.put_nowait(_STREAM_END)
        if not self._done.done():
            self._done.set_result(self.request)

    def _fail(self, exc: BaseException) -> None:
        self._stream.put_nowait(_STREAM_END)
        if not self._done.done():
            self._done.set_exception(exc)


class Router:
    """Async front-end over one :class:`~repro_torch.engine.scheduler.Engine`.

    max_pending: cap on requests in flight (queued + serving); when full,
        ``submit()`` awaits until a request terminates -- the router's
        backpressure, matching the pool-exhaustion row of the routing
        table (None = unbounded).

    Usage::

        async with Router(engine, max_pending=8) as router:
            t = await router.submit(prompt, max_new=16)
            result = await t.result()

    ``close()`` drains in-flight work, stops the engine thread, and
    finalizes the engine (summary line + closed stats stream).  After an
    engine-fatal error every outstanding ticket carries the exception and
    ``router.fatal`` holds it; ``close()`` itself never raises it again.
    """

    _IDLE_WAIT_S = 0.05  # engine-thread nap while queue empty (safety poll)

    def __init__(self, engine: Engine, *, max_pending: Optional[int] = None):
        self.engine = engine
        self.max_pending = max_pending
        self.fatal: Optional[BaseException] = None
        self._pending: List[RouterTicket] = []  # submitted, not yet enqueued
        self._live: Dict[object, RouterTicket] = {}  # rid -> ticket
        self._cond = threading.Condition()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._next_rid = 0
        self._cuda_index = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Router":
        """Start the engine thread (idempotent; ``async with`` calls it).
        Submissions made before start() just wait in the pending list --
        handy for tests that want a deterministic arrival burst."""
        if self._thread is None:
            self._bind_loop()
            # the card the engine's "cuda" means in this (the caller's)
            # thread; the engine thread binds it before it steps
            dev = self.engine.device
            self._cuda_index = None if dev.type != "cuda" else (
                dev.index if dev.index is not None
                else torch.cuda.current_device())
            self._thread = threading.Thread(
                target=self._serve_loop, name="engine-router", daemon=True)
            self._thread.start()
        return self

    async def close(self) -> Optional[dict]:
        """Drain outstanding work, stop the engine thread, finalize the
        engine; returns the engine summary."""
        with self._cond:
            self._closing = True
            self._cond.notify()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join)
            self._thread = None
        else:
            self.engine.finalize()  # never started: still emit the summary
        return self.engine.summary

    async def __aenter__(self) -> "Router":
        return self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.close()

    def _bind_loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
            if self.max_pending is not None:
                self._sem = asyncio.Semaphore(self.max_pending)
        return self._loop

    # ------------------------------------------------------------ submission
    async def submit(self, prompt, max_new: int, *,
                     deadline_steps: Optional[int] = None,
                     rid=None) -> RouterTicket:
        """Submit one request; returns its ticket.  Awaits while
        ``max_pending`` requests are already in flight (backpressure);
        raises ``ValueError`` immediately for an infeasible request and
        the engine's classified error if the router is down."""
        if rid is None:
            while self._next_rid in self._live:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        return await self.submit_request(
            Request(rid, list(prompt), max_new, deadline_steps))

    async def submit_request(self, request: Request) -> RouterTicket:
        """``submit()`` for a caller-built Request (serve.py constructs
        its request list up front; a retry path resubmits after
        ``Request.reset()``)."""
        loop = self._bind_loop()
        if self._sem is not None:
            await self._sem.acquire()
        try:
            if self.fatal is not None:
                raise self.fatal
            if self._closing:
                raise RuntimeError("router is closed to new submissions")
            if request.rid in self._live or any(
                    t.rid == request.rid for t in self._pending):
                raise ValueError(f"duplicate request id {request.rid!r}")
            # reject-at-submit: an impossible request must fail the caller
            # now, not stall the engine later
            self.engine._check_feasible(request)
        except BaseException:
            if self._sem is not None:
                self._sem.release()
            raise
        ticket = RouterTicket(request, loop)
        with self._cond:
            self._pending.append(ticket)
            self._cond.notify()
        return ticket

    # ---------------------------------------------------------- engine thread
    def _serve_loop(self) -> None:
        eng = self.engine
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while True:
                with self._cond:
                    fresh, self._pending = self._pending, []
                    if not fresh and not eng.has_work():
                        if self._closing:
                            break
                        self._cond.wait(timeout=self._IDLE_WAIT_S)
                        continue
                for t in fresh:  # FIFO arrival order
                    self._live[t.rid] = t
                    eng.enqueue(t.request)
                finished = eng.step()
                self._publish(finished)
        except BaseException as e:
            # engine-fatal (step exhaustion, watchdog, stall): the loop
            # state is untrustworthy, so every outstanding ticket fails
            # with the same classified error and the router goes down
            self.fatal = e
            with self._cond:
                fresh, self._pending = self._pending, []
            for t in fresh:
                self._live[t.rid] = t
            tickets, self._live = list(self._live.values()), {}
            if self._loop is not None and tickets:
                exc = e

                def _fail_all():
                    for t in tickets:
                        t._fail(exc)
                    if self._sem is not None:
                        for _ in tickets:
                            self._sem.release()
                self._loop.call_soon_threadsafe(_fail_all)
        finally:
            eng.finalize()

    def _publish(self, finished: List[Request]) -> None:
        """Marshal one step's progress onto the event loop: stream new
        tokens for live tickets, resolve terminal ones, release their
        backpressure slots."""
        done = [self._live.pop(r.rid) for r in finished
                if r.rid in self._live]
        live = list(self._live.values())
        if self._loop is None or not (done or live):
            return

        def _flush():
            for t in live:
                t._emit_new()
            for t in done:
                t._resolve()
            if self._sem is not None:
                for _ in done:
                    self._sem.release()
        self._loop.call_soon_threadsafe(_flush)


async def run_router(engine: Engine, reqs: List[Request], *,
                     max_pending: Optional[int] = None) -> List[Request]:
    """Serve a prepared request list through a Router and await every
    terminal result (in submission order)."""
    async with Router(engine, max_pending=max_pending) as router:
        tickets = [await router.submit_request(r) for r in reqs]
        return [await t.result() for t in tickets]
