"""Serving engine: paged continuous batching with chunked prefill."""
from .reference import synchronous_generate
from .scheduler import Engine, NonFiniteLogits, Request
from .stats import EngineStats
from .transport import ColocatedTransport

__all__ = ["ColocatedTransport", "Engine", "EngineStats", "NonFiniteLogits",
           "Request", "synchronous_generate"]
