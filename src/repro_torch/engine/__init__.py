"""Serving engine: paged continuous batching with chunked prefill and
speculative decoding."""
from .reference import synchronous_generate
from .scheduler import Engine, NonFiniteLogits, Request
from .speculative import DRAFT_NAMESPACE, SpeculativeDecoder
from .stats import EngineStats
from .transport import ColocatedTransport

__all__ = ["ColocatedTransport", "DRAFT_NAMESPACE", "Engine", "EngineStats",
           "NonFiniteLogits", "Request", "SpeculativeDecoder",
           "synchronous_generate"]
