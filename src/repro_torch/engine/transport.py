"""Page-handoff transport.  The port has the colocated one: prefill
writes straight into the decode pool, so the chunk's scatter IS the
handoff (``StreamedTransport`` waits)."""
from __future__ import annotations


class ColocatedTransport:
    """Zero-copy handoff: the prefill worker writes the decode pool."""

    name = "colocated"

    def setup(self, engine) -> None:
        self.params = engine.params
        self.device = engine.device

    def prefill_view(self, engine, task):
        return engine.states, task.slot

    def absorb(self, engine, task, view_states) -> None:
        engine.states = view_states
