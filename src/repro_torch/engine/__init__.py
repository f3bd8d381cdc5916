"""Serving engine: paged continuous batching with chunked prefill,
disaggregated page-streaming transports, speculative decoding, seeded
fault injection and recovery, and an asyncio router -- the port of
``repro.engine``, exporting the reference's names.

* :mod:`~repro_torch.engine.scheduler` -- continuous batching over the
  shared ``PagePool``: deadlines, admission, chunked prefill interleaved
  with decode, growth, LIFO eviction, quarantine and replay.
* :mod:`~repro_torch.engine.worker` -- the prefill (chunked or
  whole-prompt) and decode steps.
* :mod:`~repro_torch.engine.transport` -- colocated or streamed
  (CRC-checksummed) page handoff.
* :mod:`~repro_torch.engine.stats` -- per-step JSONL observability.
* :mod:`~repro_torch.engine.reference` -- the synchronous oracle.
* :mod:`~repro_torch.engine.speculative` -- the binary8 packed draft.
* :mod:`~repro_torch.engine.faults` / :mod:`~repro_torch.engine.
  resilience` -- fault schedules and the recovery machinery.
* :mod:`~repro_torch.engine.router` -- the asyncio front-end.
"""
from .faults import Fault, FaultInjector, FaultPlan, SimulatedFault
from .reference import synchronous_generate
from .resilience import (CircuitBreaker, DeadLetterRequest,
                         DeadlineExceeded, EngineError, RetryPolicy,
                         StepFailure, TransportError, WatchdogTimeout,
                         exit_code_for, format_error)
from .router import Router, RouterTicket, run_router
from .scheduler import Engine, Request
from .speculative import DRAFT_NAMESPACE, SpeculativeDecoder
from .stats import EngineStats
from .transport import ColocatedTransport, StreamedTransport
from .worker import DecodeWorker, PrefillTask, PrefillWorker

__all__ = [
    "CircuitBreaker", "ColocatedTransport", "DRAFT_NAMESPACE",
    "DeadLetterRequest", "DeadlineExceeded", "DecodeWorker", "Engine",
    "EngineError", "EngineStats", "Fault", "FaultInjector", "FaultPlan",
    "PrefillTask", "PrefillWorker", "Request", "RetryPolicy", "Router",
    "RouterTicket", "SimulatedFault", "SpeculativeDecoder", "StepFailure",
    "StreamedTransport", "TransportError", "WatchdogTimeout",
    "exit_code_for", "format_error", "run_router",
    "synchronous_generate",
]
