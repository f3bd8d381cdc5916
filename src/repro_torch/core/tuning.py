"""Precision tuning: a deterministic reimplementation of DistributedSearch
(fpPrecisionTuning) + the FlexFloat wrapper's precision->format mapping.
The port of ``repro.core.tuning``: every evaluation runs the app on a
:class:`~repro_torch.apps.common.TPContext` on the tuner's device.

Interface mirrors the original tool (paper Sec. II/III-B):
  * constraint: program output must satisfy a target SQNR, expressed here as
    relative RMS error eps (SQNR_dB = -20 log10 eps);
  * phase 1 (per input set): heuristic search of minimal per-variable
    precision bits -- coordinate descent with binary search, exploring with
    wide (8-bit) exponents so precision and range are tuned independently;
  * phase 2 ("statistical refinement"): join bindings across input sets by
    taking the per-variable max precision;
  * wrapper: observed dynamic ranges pick the exponent width, then the
    precision interval maps to a storage format (V1 = {b8, b16, b32},
    V2 = V1 + {b16alt}), exactly the paper's interval mapping;
  * final verification re-runs with the *actual* formats (narrow exponents
    included) and escalates formats greedily until the constraint holds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch import resolve_device
from repro_torch.apps.common import AppSpec, TPContext, rel_error

from .formats import BINARY8, BINARY16, BINARY16ALT, BINARY32, FpFormat
from .policy import PrecisionPolicy

# verification-failure escalation chains, per type system (V1 has no
# binary16alt: the paper's Table I premise)
_ESCALATION = {
    "V2": {"binary8": BINARY16ALT, "binary16alt": BINARY16,
           "binary16": BINARY32},
    "V1": {"binary8": BINARY16, "binary16": BINARY32},
}


@dataclasses.dataclass
class TuneResult:
    app: str
    eps: float
    type_system: str
    precisions: Dict[str, int]          # tuned precision bits (mantissa+1)
    formats: Dict[str, FpFormat]        # final storage formats
    needs_wide: Dict[str, bool]
    sizes: Dict[str, int]               # elements per variable
    final_error: float
    n_evals: int

    def elements_by_format(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v, f in self.formats.items():
            out[f.name] = out.get(f.name, 0) + self.sizes.get(v, 1)
        return out

    def vars_by_format(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v, f in self.formats.items():
            out[f.name] = out.get(f.name, 0) + 1
        return out

    def bytes_tuned(self) -> int:
        """Storage bytes of every tuned variable at container width."""
        return sum(self.sizes.get(v, 1) * (f.bits // 8)
                   for v, f in self.formats.items())

    def bytes_f32(self) -> int:
        """The same variables in the all-binary32 baseline."""
        return sum(self.sizes.get(v, 1) * 4 for v in self.formats)

    def to_artifact(self) -> dict:
        """The tuned binding as a versioned policy artifact -- the same
        exchange format the serve-time tuner (``repro.tuning``) emits, so
        ``launch/report.py`` and the benches read apps and serving
        bindings through one loader (``PrecisionPolicy.from_artifact``).
        App variables become flat policy keys; emulated mode, because the
        apps run through the FlexFloat sanitizer, not native dtypes."""
        policy = PrecisionPolicy(
            formats=dict(self.formats), mode="emulated")
        return policy.to_artifact(provenance={
            "tuner": "repro_torch.core.tuning.Tuner",
            "app": self.app,
            "eps": self.eps,
            "type_system": self.type_system,
            "precisions": dict(self.precisions),
            "needs_wide": dict(self.needs_wide),
            "sizes": dict(self.sizes),
            "final_error": self.final_error,
            "n_evals": self.n_evals,
            "fmt_histogram": self.vars_by_format(),
            "elements_by_format": self.elements_by_format(),
            "bytes": self.bytes_tuned(),
            "bytes_f32": self.bytes_f32(),
        })


def _fits_5bit_exponent(lo: float, hi: float) -> bool:
    # overflow is catastrophic (saturation/Inf); underflow into denormals is
    # graceful, so only the high end forces an 8-bit exponent (the wrapper's
    # configuration map encodes the same asymmetry)
    return hi <= BINARY16.max_normal and lo >= BINARY16.min_denormal


def map_format(precision_bits: int, needs_wide: bool,
               type_system: str) -> FpFormat:
    """The wrapper's interval mapping (paper Sec. III-A / Fig. 4 bands)."""
    p = precision_bits
    if type_system == "V1":
        if p <= 3 and not needs_wide:
            return BINARY8
        if p <= 11 and not needs_wide:
            return BINARY16
        return BINARY32
    # V2
    if p <= 3 and not needs_wide:
        return BINARY8
    if p <= 8:
        return BINARY16ALT          # b32-range 16-bit type
    if p <= 11 and not needs_wide:
        return BINARY16
    return BINARY32


class Tuner:
    """The search on ``device`` (default ``cuda``; raises when no card is
    present unless ``device="cpu"``)."""

    def __init__(self, app: AppSpec, eps: float, *, n_input_sets: int = 3,
                 type_system: str = "V2", max_rounds: int = 3, device=None):
        self.device = resolve_device(device)
        self.app = app
        self.eps = eps
        self.sets = [app.gen_inputs(seed=1000 + i)
                     for i in range(n_input_sets)]
        self.refs = [app.reference(s) for s in self.sets]
        self.type_system = type_system
        self.max_rounds = max_rounds
        self.n_evals = 0

    # -- evaluation -----------------------------------------------------------
    def _error(self, formats: Dict[str, FpFormat], set_idx: int) -> float:
        ctx = TPContext(formats, count=False, device=self.device)
        out = self.app.run(ctx, self.sets[set_idx])
        self.n_evals += 1
        return rel_error(out, self.refs[set_idx])

    def _error_prec(self, prec: Dict[str, int], set_idx: int) -> float:
        # exploration uses wide exponents: precision-only effect
        fmts = {v: FpFormat(8, max(min(p - 1, 23), 1))
                for v, p in prec.items()}
        return self._error(fmts, set_idx)

    # -- phase 1: per-set coordinate descent ----------------------------------
    def _tune_one_set(self, set_idx: int) -> Dict[str, int]:
        prec = {v: 24 for v in self.app.variables}
        if self._error_prec(prec, set_idx) > self.eps:
            # container precision cannot meet eps -- keep max everywhere
            return prec
        for _round in range(self.max_rounds):
            changed = False
            for v in self.app.variables:
                lo, hi, best = 2, prec[v], prec[v]
                while lo <= hi:
                    mid = (lo + hi) // 2
                    trial = dict(prec)
                    trial[v] = mid
                    if self._error_prec(trial, set_idx) <= self.eps:
                        best, hi = mid, mid - 1
                    else:
                        lo = mid + 1
                if best != prec[v]:
                    prec[v] = best
                    changed = True
            if not changed:
                break
        return prec

    # -- full pipeline ---------------------------------------------------------
    def run(self) -> TuneResult:
        per_set = [self._tune_one_set(i) for i in range(len(self.sets))]
        prec = {v: max(ps[v] for ps in per_set) for v in self.app.variables}

        # observed ranges with final precisions (wide-exponent run)
        ctx = TPContext({v: FpFormat(8, max(min(p - 1, 23), 1))
                         for v, p in prec.items()}, count=True,
                        device=self.device)
        self.app.run(ctx, self.sets[0])
        ranges = dict(ctx.ranges)
        sizes = dict(ctx.sizes)
        needs_wide = {}
        for v in self.app.variables:
            lo, hi = ranges.get(v, (1.0, 1.0))
            needs_wide[v] = not _fits_5bit_exponent(lo, hi)

        formats = {v: map_format(prec[v], needs_wide[v], self.type_system)
                   for v in self.app.variables}

        # verification with true narrow formats + greedy escalation
        def worst_error(fm):
            return max(self._error(fm, i) for i in range(len(self.sets)))

        esc = _ESCALATION[self.type_system]
        err = worst_error(formats)
        guard = 0
        while err > self.eps and guard < 4 * len(formats):
            guard += 1
            best_v, best_err = None, err
            for v in self.app.variables:
                cur = formats[v]
                if cur is BINARY32:
                    continue
                nxt = esc[cur.name]
                trial = dict(formats)
                trial[v] = nxt
                e = worst_error(trial)
                if e < best_err:
                    best_v, best_err = v, e
            if best_v is None:  # no single step helps: widen everything once
                for v in self.app.variables:
                    if formats[v] is not BINARY32:
                        formats[v] = esc[formats[v].name]
                err = worst_error(formats)
                continue
            formats[best_v] = esc[formats[best_v].name]
            err = best_err

        return TuneResult(
            app=self.app.name, eps=self.eps, type_system=self.type_system,
            precisions=prec, formats=formats, needs_wide=needs_wide,
            sizes=sizes, final_error=err, n_evals=self.n_evals)


def tune(app: AppSpec, eps: float, **kw) -> TuneResult:
    return Tuner(app, eps, **kw).run()
