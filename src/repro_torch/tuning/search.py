"""Serve-time precision search: the paper's tuning flow at LLM scale.

The port of ``repro.tuning.search``.  ``core/tuning.py::Tuner`` binds
per-variable (e, m) formats for the paper's embedded kernels by coordinate
descent under a relative-RMS-error constraint.  :class:`ServeTuner` is the
same three-phase structure lifted to a serving model:

  * **variables** are policy bindings instead of scalars: the global
    weight/activation roles (``embed_w`` / ``attn_w`` / ``ffn_w`` /
    ``act`` / ``attn_probs``) plus the KV cache *per depth group* --
    hierarchical ``layers.{li}.kv_cache`` keys, so shallow layers may keep
    a wider cache format than deep ones;
  * **the search ladder** is the paper's V2 type system restricted to the
    native points (binary8 -> binary16alt -> binary16 -> binary32): the
    candidate policies run in native mode, so the binding the search
    measures is bit-identical to the binding serving executes;
  * **the constraint** is distributional: mean KL divergence of the
    candidate's next-token distribution from the binary32 reference,
    measured at the prefill boundary and over ``decode_steps``
    teacher-forced decode positions (decode positions are what make the
    KV-cache formats observable at all);
  * **phase 1** tunes each calibration set independently, **phase 2**
    joins by widest-per-variable, **verification** re-checks the joined
    binding on every set and greedily escalates the single most helpful
    variable until the budget holds -- the apps tuner's shape.

Every accepted candidate is priced by the platform's memory-energy model
(``core/energy.py``).  The forward runs through ``Model.prefill`` /
``Model.decode_step`` on the tuner's device (default ``cuda``): on a card
the attention goes to the flash kernels under the serving default
``flash_pallas``, and the unpacked projections to ``torch.matmul``, the
reference's ``xla`` spelling for parameters that are not packed.  The
log-probabilities are taken on the device; the KL is summed on the host
in f64.  A candidate's weights are drawn from a ``torch.Generator``
seeded with ``seed`` (or handed over by ``params_for(policy)``), and at
most one weight set is kept between candidates: at full width one set is
8-32 GB.  An enc-dec config's prefills and decode steps all get zero stub
frame embeddings, as the reference's do.

Every config is tuned.  On the recurrent configs (rwkv6, recurrentgemma)
the ``layers.{li}.kv_cache`` binding of a depth group sets that layer's
recurrent state format (``policy.at_layer(li)``, as in the reference),
rwkv6 has no ``attn`` layer and so no ``attn_probs`` variable, and the
KV bytes per token count attention layers only.  Candidates run
whole-prompt ``Model.prefill``, so a state is rounded once at the
prompt's end, as the reference's candidates are.

A prefix-LM (paligemma-3b) departs from the reference on purpose: its
candidates prefill ``make_batch``'s ``prefix_len`` zero stub patch
embeddings before the prompt, and ``_capacity`` counts those rows, so
every decode position attends over the prefix as the port's engine
serves it.  The reference sizes its capacity without the prefix
(``src/repro/tuning/search.py:169-170``); its ``_build_cache`` then keeps
only the last rows as a ring, and its KL references decode over a
context that has lost the prefix.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import energy
from repro_torch.core.formats import (BINARY8, BINARY16, BINARY16ALT,
                                      BINARY32, FpFormat)
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.engine.worker import make_batch
from repro_torch.kernels import dispatch
from repro_torch.models import qparams

from .calibrate import CalibrationSet, digest_of

# the native points of the paper's V2 type system, narrowest first -- the
# escalation chain binary8 -> binary16alt -> binary16 -> binary32 matches
# core/tuning.py::_ESCALATION["V2"]
LADDER: Tuple[FpFormat, ...] = (BINARY8, BINARY16ALT, BINARY16, BINARY32)
_WIDEST = len(LADDER) - 1

# roles the search binds globally; everything else (norm/logits) stays
# binary32 -- the paper's "range-critical variables at binary32" rule
WEIGHT_ROLES = ("embed_w", "attn_w", "ffn_w")
_PROTECTED = {"router_w": BINARY32, "norm_w": BINARY32,
              "router_probs": BINARY32, "logits": BINARY32}


@dataclasses.dataclass
class ServeTuneResult:
    """Outcome of one ServeTuner run (everything the artifact records)."""
    arch: str
    eps: float                       # KL budget
    formats: Dict[str, FpFormat]     # searched policy keys -> final format
    final_kl: float
    n_evals: int
    calibration: str                 # joint digest of the input sets
    decode_steps: int
    weight_bytes: int
    weight_bytes_f32: int
    kv_bytes_per_token: int
    kv_bytes_per_token_f32: int
    energy_pj_per_token: float
    energy_f32_pj_per_token: float
    context_tokens: int              # KV footprint the energy is priced at
    decode_impl: Optional[str] = None
    matmul_impl: Optional[str] = None

    def fmt_histogram(self) -> Dict[str, int]:
        """Searched variables per final format (Table-1-style column)."""
        out: Dict[str, int] = {}
        for f in self.formats.values():
            out[f.name] = out.get(f.name, 0) + 1
        return out

    def to_policy(self) -> PrecisionPolicy:
        return PrecisionPolicy(
            formats={**_PROTECTED, **self.formats}, mode="native",
            default_fmt=BINARY32, decode_impl=self.decode_impl,
            matmul_impl=self.matmul_impl)

    def to_artifact(self) -> dict:
        total = self.weight_bytes + self.kv_bytes_per_token
        total_f32 = self.weight_bytes_f32 + self.kv_bytes_per_token_f32
        return self.to_policy().to_artifact(provenance={
            "tuner": "repro_torch.tuning.search.ServeTuner",
            "arch": self.arch,
            "eps": self.eps,
            "final_kl": self.final_kl,
            "n_evals": self.n_evals,
            "calibration": self.calibration,
            "decode_steps": self.decode_steps,
            "fmt_histogram": self.fmt_histogram(),
            "weight_bytes": self.weight_bytes,
            "weight_bytes_f32": self.weight_bytes_f32,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_bytes_per_token_f32": self.kv_bytes_per_token_f32,
            "bytes_vs_f32": total / max(total_f32, 1),
            "energy_pj_per_token": self.energy_pj_per_token,
            "energy_f32_pj_per_token": self.energy_f32_pj_per_token,
            "context_tokens": self.context_tokens,
        })


def kv_layer_groups(cfg, kv_groups: int) -> List[List[int]]:
    """Contiguous depth groups of decoder layers for per-group KV binding
    (every decoder layer stores its per-token state under ``kv_cache``)."""
    n = len(cfg.attn_pattern)
    g = max(1, min(kv_groups, n))
    bounds = [round(i * n / g) for i in range(g + 1)]
    return [list(range(bounds[i], bounds[i + 1]))
            for i in range(g) if bounds[i] < bounds[i + 1]]


class ServeTuner:
    """Phase-1 / phase-2 / verify precision search over a serving model.

    ``device``: where the candidates run (default ``cuda``; raises when no
    card is present unless ``device="cpu"``).  ``decode_impl`` defaults to
    the serving default there (``flash_pallas`` on a card), and the result
    pins the one the search ran.  ``params_for(policy)``, when given,
    returns a candidate's weights (e.g. weights carried across from the
    JAX package) in place of random ones from ``seed``."""

    def __init__(self, model, cfg, sets: Sequence[CalibrationSet], *,
                 eps: float = 0.05, decode_steps: int = 4,
                 kv_groups: int = 2, max_rounds: int = 2,
                 decode_impl: Optional[str] = None,
                 matmul_impl: Optional[str] = None, seed: int = 0,
                 device=None,
                 params_for: Optional[Callable[[PrecisionPolicy],
                                               object]] = None):
        if not sets:
            raise ValueError("ServeTuner needs at least one calibration set")
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.sets = list(sets)
        self.eps = eps
        self.decode_steps = max(1, decode_steps)
        self.max_rounds = max_rounds
        if decode_impl is None:
            decode_impl = dispatch.default_serving_impl(self.device)
        self.decode_impl, self.matmul_impl = decode_impl, matmul_impl
        self.seed = seed
        self.params_for = params_for
        self.n_evals = 0

        # searched variables: name -> the policy keys the binding writes
        self.variables: Dict[str, Tuple[str, ...]] = {
            r: (r,) for r in WEIGHT_ROLES}
        if any(k == "attn" for k in cfg.attn_pattern) or cfg.encoder_layers:
            self.variables["attn_probs"] = ("attn_probs",)
        self.variables["act"] = ("act",)
        for group in kv_layer_groups(cfg, kv_groups):
            name = (f"kv_cache[{group[0]}:{group[-1] + 1}]"
                    if len(group) > 1 else f"kv_cache[{group[0]}]")
            self.variables[name] = tuple(
                f"layers.{li}.kv_cache" for li in group)

        # a prefix-LM's cache holds its prefix rows too (the stated
        # departure from the reference, which sizes without them)
        self._capacity = (cfg.prefix_len
                          + max(len(p) for s in self.sets for p in s.prompts)
                          + self.decode_steps)
        self._params_key: Optional[Tuple[str, ...]] = None
        self._params_val = None
        self._refs = [self._reference(s) for s in self.sets]

    # -- policy / params construction -----------------------------------------
    def _policy(self, assign: Dict[str, int]) -> PrecisionPolicy:
        formats = dict(_PROTECTED)
        for var, idx in assign.items():
            for key in self.variables[var]:
                formats[key] = LADDER[idx]
        return PrecisionPolicy(formats=formats, mode="native",
                               default_fmt=BINARY32,
                               decode_impl=self.decode_impl,
                               matmul_impl=self.matmul_impl)

    def _params(self, policy: PrecisionPolicy):
        """The candidate's weights: they depend only on the weight-role
        formats, so candidates that move activation / KV formats share
        them.  One set is kept: the previous one is dropped before the
        next is built."""
        key = tuple(policy.fmt(r).name for r in WEIGHT_ROLES)
        if key != self._params_key:
            self._params_key = self._params_val = None
            if self.params_for is not None:
                params = self.params_for(policy)
            else:
                gen = torch.Generator(device=self.device).manual_seed(
                    self.seed)
                params = self.model.init_params(gen, policy,
                                                device=self.device)
            self._params_key, self._params_val = key, params
        return self._params_val

    # -- evaluation ------------------------------------------------------------
    def _tokens(self, toks) -> torch.Tensor:
        return torch.tensor([list(toks)], dtype=torch.int32,
                            device=self.device)

    @staticmethod
    def _logp(logits) -> np.ndarray:
        """Log-probabilities of the last position, on the device, then
        to the host."""
        return torch.log_softmax(logits[0, -1].to(torch.float32),
                                 dim=-1).cpu().numpy()

    def _run(self, policy, prompt, forced: Optional[List[int]] = None):
        """Teacher-forced forward: log-probs at the prefill boundary and
        ``decode_steps - 1`` decode positions; returns (logp (T, V),
        greedy tokens)."""
        params = self._params(policy)
        batch = make_batch(self.cfg, prompt, self.device)
        # an enc-dec config's zero frames go to every decode step too
        extra = {k: batch[k] for k in ("encoder_embeds",) if k in batch}
        logits, states = self.model.prefill(params, batch, policy,
                                            self._capacity)
        logp = [self._logp(logits)]
        toks = [int(np.argmax(logp[0]))]
        for step in range(self.decode_steps - 1):
            t = forced[step] if forced is not None else toks[-1]
            logits, states = self.model.decode_step(
                params, self._tokens([t]), states, policy, **extra)
            logp.append(self._logp(logits))
            toks.append(int(np.argmax(logp[-1])))
        return np.stack(logp), toks

    def _reference(self, cal: CalibrationSet):
        """binary32 run per prompt: (ref log-probs, greedy teacher tokens)."""
        policy = self._policy({v: _WIDEST for v in self.variables})
        return [self._run(policy, p) for p in cal.prompts]

    def _error(self, assign: Dict[str, int], set_idx: int) -> float:
        """Mean KL(ref || candidate) over prompts and positions, in f64."""
        policy = self._policy(assign)
        self.n_evals += 1
        kls = []
        for prompt, (ref_logp, ref_toks) in zip(
                self.sets[set_idx].prompts, self._refs[set_idx]):
            cand_logp, _ = self._run(policy, prompt, forced=ref_toks)
            ref64 = ref_logp.astype(np.float64)
            p = np.exp(ref64)
            kls.append(float(np.mean(np.sum(
                p * (ref64 - cand_logp.astype(np.float64)), axis=-1))))
        return float(np.mean(kls))

    # -- phase 1: per-set coordinate descent ----------------------------------
    def _tune_one_set(self, set_idx: int) -> Dict[str, int]:
        assign = {v: _WIDEST for v in self.variables}
        for _round in range(self.max_rounds):
            changed = False
            for v in self.variables:
                lo, hi, best = 0, assign[v] - 1, assign[v]
                while lo <= hi:
                    mid = (lo + hi) // 2
                    trial = dict(assign)
                    trial[v] = mid
                    if self._error(trial, set_idx) <= self.eps:
                        best, hi = mid, mid - 1
                    else:
                        lo = mid + 1
                if best != assign[v]:
                    assign[v] = best
                    changed = True
            if not changed:
                break
        return assign

    # -- pricing ---------------------------------------------------------------
    def _bytes(self, policy: PrecisionPolicy) -> Tuple[int, int]:
        """(weight bytes, KV bytes per cached token) under ``policy``,
        from shapes and dtypes alone (the weights made on the ``meta``
        device, which allocates nothing)."""
        shapes = self.model.init_params(None, policy, device="meta")
        wb = sum(t.numel() * t.element_size()
                 for t in qparams.tree_leaves(shapes))
        cfg = self.cfg
        kvb = sum(cfg.n_kv * cfg.head_dim * 2
                  * policy.dtype("kv_cache", layer=li).itemsize
                  for li, k in enumerate(cfg.attn_pattern) if k == "attn")
        return wb, kvb

    # -- full pipeline ---------------------------------------------------------
    def run(self) -> ServeTuneResult:
        per_set = [self._tune_one_set(i) for i in range(len(self.sets))]
        # phase 2: widest-per-variable join across calibration sets
        assign = {v: max(ps[v] for ps in per_set) for v in self.variables}

        def worst_error(a):
            return max(self._error(a, i) for i in range(len(self.sets)))

        # verification + greedy escalation (same loop as core Tuner.run)
        err = worst_error(assign)
        guard = 0
        while err > self.eps and guard < 4 * len(assign):
            guard += 1
            best_v, best_err = None, err
            for v in self.variables:
                if assign[v] == _WIDEST:
                    continue
                trial = dict(assign)
                trial[v] += 1
                e = worst_error(trial)
                if e < best_err:
                    best_v, best_err = v, e
            if best_v is None:  # no single step helps: widen everything once
                assign = {v: min(i + 1, _WIDEST)
                          for v, i in assign.items()}
                err = worst_error(assign)
                continue
            assign[best_v] += 1
            err = best_err

        formats = {key: LADDER[idx] for var, idx in assign.items()
                   for key in self.variables[var]}
        tuned = self._policy(assign)
        base = self._policy({v: _WIDEST for v in self.variables})
        wb, kvb = self._bytes(tuned)
        wb32, kvb32 = self._bytes(base)
        ctx = self._capacity
        return ServeTuneResult(
            arch=self.cfg.arch, eps=self.eps, formats=formats,
            final_kl=err, n_evals=self.n_evals,
            calibration=digest_of(self.sets),
            decode_steps=self.decode_steps,
            weight_bytes=wb, weight_bytes_f32=wb32,
            kv_bytes_per_token=kvb, kv_bytes_per_token_f32=kvb32,
            energy_pj_per_token=energy.stream_energy_pj(wb + kvb * ctx),
            energy_f32_pj_per_token=energy.stream_energy_pj(
                wb32 + kvb32 * ctx),
            context_tokens=ctx,
            decode_impl=self.decode_impl, matmul_impl=self.matmul_impl)


def tune_serving(model, cfg, sets, **kw) -> ServeTuneResult:
    return ServeTuner(model, cfg, sets, **kw).run()
