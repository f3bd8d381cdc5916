"""The traced run: ``torch.profiler`` over the measured window, device
activity only, reduced to intervals, sums by kernel and idle gaps.

The profiler records the card's kernels, copies and sets (CUPTI) with
timestamps on the host's wall clock, which the benchmark's own spans
(``time.perf_counter``) are mapped onto by one measured offset.  A gap
in which no device activity ran is named by the benchmark's innermost
host span open at its middle: ``prefill_chunk`` or ``decode_step`` (the
host inside the model step, launching), ``engine_step`` (the scheduler
around them) or ``client`` (the benchmark between steps).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace of anonymous
    units, template arguments and parameters."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged copy of ``intervals`` (start, end)."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Device activity inside [t_open, t_close] (seconds on the host's
    ``perf_counter`` clock), and the host spans to name idle gaps by."""

    def __init__(self, events: Sequence[Tuple[float, float, str]],
                 t_open: float, t_close: float,
                 spans: Sequence[Tuple[float, float, str]] = ()):
        self.t_open, self.t_close = t_open, t_close
        self.note = ""
        self.events = [(max(a, t_open), min(b, t_close), n)
                       for a, b, n in events if b > t_open and a < t_close]
        self.spans = sorted(spans)
        self.busy = union([(a, b) for a, b, _ in self.events])
        self.by_name: Dict[str, float] = {}
        for a, b, n in self.events:
            k = short_name(n)
            self.by_name[k] = self.by_name.get(k, 0.0) + (b - a)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def time_of(self, patterns: Sequence[str]) -> float:
        """Summed device seconds of activities whose short name contains
        one of ``patterns``."""
        return sum(t for n, t in self.by_name.items()
                   if any(p in n for p in patterns))

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals inside the window."""
        out, at = [], self.t_open
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.t_close:
            out.append((at, self.t_close))
        return out

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open on the host at ``t``."""
        best: Optional[Tuple[float, str]] = None
        for a, b, n in self.spans:
            if a > t:
                break
            if b >= t and (best is None or b - a < best[0]):
                best = (b - a, n)
        return best[1] if best is not None else "client"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a]
                              for a, b in gaps]}


def _clock_offset() -> float:
    """Wall clock minus perf_counter, in seconds, at the tightest of a few
    readings."""
    best = None
    for _ in range(9):
        p0 = time.perf_counter()
        w = time.time_ns()
        p1 = time.perf_counter()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, w / 1e9 - (p0 + p1) / 2)
    return best[1]


class _Window:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.offset = _clock_offset()

    def read(self, t_open: float, t_close: float, steps, calls) -> DeviceTrace:
        torch.cuda.synchronize()
        self.prof.stop()
        results = self.prof.profiler.kineto_results
        cuda = torch.autograd.DeviceType.CUDA
        off = self.offset
        events = [(e.start_ns() / 1e9 - off, e.end_ns() / 1e9 - off, e.name())
                  for e in results.events() if e.device_type() == cuda]
        spans = [(s.t0, s.t1, "engine_step") for s in steps] + \
            [(c.t0, c.t1, c.kind) for c in calls]
        tr = DeviceTrace(events, t_open, t_close, spans)
        tr.note = (f"trace: {len(events)} device activities, "
                   f"{len(tr.events)} inside the window; first at "
                   f"{min((a for a, _, _ in events), default=0) - t_open:+.4f}"
                   f" s, last ends at "
                   f"{max((b for _, b, _ in events), default=0) - t_close:+.4f}"
                   f" s from the window's ends; read in "
                   f"{time.perf_counter() - t_close:.3f} s")
        return tr


def start(enabled: bool) -> Optional[_Window]:
    """A started profiler whose ``read`` stops it and gives the window's
    :class:`DeviceTrace`, or None."""
    return _Window() if enabled else None
