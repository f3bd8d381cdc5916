"""Straggler / step-time watchdog: the port of
``repro.runtime.watchdog`` (pure Python, the same arithmetic).

Tracks per-step wall time with an EWMA + variance estimate; a step slower
than ``mean + k * std`` (and ``min_ratio * mean``) is flagged.  On a real
pod this feeds the control plane (demote the slice, checkpoint-and-remesh);
here the reaction is a callback the trainer wires to checkpoint+remesh, and
tests drive it with injected delays.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional


class StepWatchdog:
    def __init__(self, k_sigma: float = 4.0, min_ratio: float = 1.5,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.k = k_sigma
        self.min_ratio = min_ratio
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: List[tuple] = []
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was flagged as a straggler."""
        dt = time.monotonic() - self._t0
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        flagged = False
        if self.n >= self.warmup:
            std = max(self.var, 1e-12) ** 0.5
            if dt > self.mean + self.k * std and dt > self.min_ratio * self.mean:
                flagged = True
                self.events.append((step, dt))
                if self.on_straggler:
                    self.on_straggler(step, dt)
        # EWMA update (straggler steps still update slowly so a permanent
        # slowdown eventually becomes the new normal instead of infinite
        # flagging)
        alpha = 0.2 if not flagged else 0.02
        delta = dt - self.mean
        self.mean += alpha * delta
        self.var = (1 - alpha) * (self.var + alpha * delta * delta)
        self.n += 1
        return flagged
