"""TPContext: the FlexFloat programming model, instrumented.

The port of ``repro.apps.common``.  Apps are written against named
*variables* (the paper's tunable memory locations), whose values are f32
tensors on ``ctx.device``.  Every operation:
  * loads its operands (counted, at the operand's format width; packed word
    accesses when the section is vectorizable and the format is narrow),
  * inserts an explicit cast when an operand's format differs from the
    output variable's format (counted: FlexFloat's strict typing),
  * computes in the f32 container and sanitizes the result to the output
    variable's format (:func:`~repro_torch.core.flexfloat.quantize`: the
    ``flexfloat_cast`` kernel on a card),
  * records the result's dynamic range (drives exponent-width selection).

The counts come from shapes alone, host integers.  The ranges stay on the
device as one 0-d minimum and maximum per operation, reduced and read in
one transfer when :attr:`TPContext.ranges` is read, so an operation never
waits for the device.

``vec=True`` marks ops inside sections the paper tags as vectorizable: with
a <=16-bit format they count as SIMD issues and packed memory accesses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.flexfloat import quantize
from repro_torch.core.formats import BINARY32, FpFormat, get_format
from repro_torch.core.stats import OpStats

F32 = torch.float32


@dataclasses.dataclass
class TVal:
    value: torch.Tensor
    name: str


class TPContext:
    """The instrumented FlexFloat context on ``device`` (default ``cuda``;
    raises when no card is present unless ``device="cpu"``)."""

    def __init__(self, formats: Optional[Dict[str, FpFormat]] = None,
                 count: bool = True, device=None):
        self.formats = {k: get_format(v) for k, v in (formats or {}).items()}
        self.count = count
        self.device = resolve_device(device)
        self.stats = OpStats()
        self.sizes: Dict[str, int] = {}
        # per variable: the 0-d min / max |finite nonzero| of each result
        self._lo: Dict[str, List[torch.Tensor]] = {}
        self._hi: Dict[str, List[torch.Tensor]] = {}

    # ------------------------------------------------------------- variables
    def fmt(self, name: str) -> FpFormat:
        return self.formats.get(name, BINARY32)

    def var(self, name: str, value) -> TVal:
        """Declare + store a named variable (input binding)."""
        if isinstance(value, torch.Tensor):
            v = value.to(self.device, F32)
        else:
            v = torch.as_tensor(np.asarray(value, np.float32),
                                device=self.device)
        q = quantize(v, self.fmt(name))
        self._result(name, q)
        if self.count:
            self.stats.mem(self.fmt(name), q.numel(), vec=False)
        return TVal(q, name)

    def _result(self, name: str, q: torch.Tensor) -> None:
        """Size and dynamic range of a result stored to ``name``."""
        self.sizes[name] = max(self.sizes.get(name, 0), q.numel())
        if q.numel() == 0:
            return
        a = q.abs()
        # NaN fails both comparisons; +/-0 is no range, Inf no finite one
        self._lo.setdefault(name, []).append(
            torch.where(a > 0, a, math.inf).amin())
        self._hi.setdefault(name, []).append(
            torch.where(a < math.inf, a, 0.0).amax())

    @property
    def ranges(self) -> Dict[str, Tuple[float, float]]:
        """Variable -> (min, max) |finite nonzero| value stored to it, for
        the variables that held one: one device-to-host transfer."""
        names = list(self._lo)
        if not names:
            return {}
        lohi = torch.stack([torch.stack([torch.stack(self._lo[n]).amin(),
                                         torch.stack(self._hi[n]).amax()])
                            for n in names]).tolist()
        return {n: (lo, hi) for n, (lo, hi) in zip(names, lohi)
                if lo != math.inf}

    # ------------------------------------------------------------------- ops
    def _binary(self, out_name, a: TVal, b: TVal, fn, vec: bool) -> TVal:
        ofmt = self.fmt(out_name)
        q = quantize(fn(a.value, b.value), ofmt)
        self._result(out_name, q)
        if self.count:
            n = max(math.prod(torch.broadcast_shapes(a.value.shape,
                                                     b.value.shape)), 1)
            svec = vec and ofmt.bits <= 16
            for t in (a, b):
                tf = self.fmt(t.name)
                self.stats.mem(tf, min(t.value.numel(), n),
                               vec=svec and tf.bits <= 16)
                self.stats.cast(tf, ofmt, min(t.value.numel(), n))
            self.stats.fp_op(ofmt, n, vec=svec)
            self.stats.mem(ofmt, q.numel(), vec=svec)   # result store
            self.stats.other(1)                         # loop/addr overhead
        return TVal(q, out_name)

    def add(self, out, a, b, vec=False):
        return self._binary(out, a, b, torch.add, vec)

    def sub(self, out, a, b, vec=False):
        return self._binary(out, a, b, torch.sub, vec)

    def mul(self, out, a, b, vec=False):
        return self._binary(out, a, b, torch.mul, vec)

    def fma(self, out, a, b, c, vec=False):
        """mul -> round -> add -> round (the FPU has no fused narrow FMA)."""
        t = self.mul(out, a, b, vec=vec)
        return self.add(out, t, c, vec=vec)

    def reduce_sum(self, out, a: TVal, axis=None, vec=False) -> TVal:
        """Tree reduction: n-1 adds in the output format (summed by
        ``torch.sum`` in f32)."""
        ofmt = self.fmt(out)
        av = a.value
        raw = torch.sum(av, dtype=F32) if axis is None \
            else torch.sum(av, dim=axis, dtype=F32)
        q = quantize(raw, ofmt)
        self._result(out, q)
        if self.count:
            n_adds = max(av.numel() - q.numel(), 0)
            afmt = self.fmt(a.name)
            svec = vec and ofmt.bits <= 16
            self.stats.cast(afmt, ofmt, av.numel())
            self.stats.mem(afmt, av.numel(), vec=svec and afmt.bits <= 16)
            self.stats.fp_op(ofmt, n_adds, vec=svec)
            self.stats.mem(ofmt, q.numel(), vec=False)
            self.stats.other(1)
        return TVal(q, out)

    def special(self, out, a: TVal, fn, n_equiv_b32_ops: int = 8) -> TVal:
        """div/sqrt/exp etc. (``fn`` of torch functions on the f32 value):
        executed as binary32 software/FPU sequences (the transprecision
        FPU supports add/sub/mul/casts only)."""
        ofmt = self.fmt(out)
        q = quantize(fn(a.value), ofmt)
        self._result(out, q)
        if self.count:
            self.stats.mem(self.fmt(a.name), a.value.numel(), vec=False)
            self.stats.fp_op(BINARY32, q.numel() * n_equiv_b32_ops,
                             vec=False)
            self.stats.cast(BINARY32, ofmt, q.numel())
            self.stats.mem(ofmt, q.numel(), vec=False)
            self.stats.other(2)
        return TVal(q, out)

    def other(self, n: int):
        if self.count:
            self.stats.other(n)


# ---------------------------------------------------------------------------
# app protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AppSpec:
    name: str
    variables: Sequence[str]

    def run(self, ctx: TPContext, inputs) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def reference(self, inputs) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def gen_inputs(self, seed: int):  # pragma: no cover
        raise NotImplementedError


def rel_error(out, ref: np.ndarray) -> float:
    """Relative RMS error; the tuner's constraint (SQNR = -20 log10(eps)).
    ``out`` may be a tensor on any device: one transfer, then f64 on the
    host."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    denom = float(np.sqrt(np.mean(ref ** 2))) + 1e-300
    if not np.all(np.isfinite(out)):
        return float("inf")
    return float(np.sqrt(np.mean((out - ref) ** 2)) / denom)
