"""One run of one cell: set-up, warm-up, the measured window, the check
of what the window served, and the result line.

The system under test is ``repro_torch``'s serving engine, driven through
``Engine.enqueue`` / ``Engine.step`` by the benchmark's own clients
(``loadgen``).  The benchmark records on the host clock, from its own
code: when each request was sent, each engine step's start and end, when
each token became visible (after the ``Engine.step`` that produced it
returned, which follows that step's device sync), and the calls into the
model step (``Model.prefill_chunk``, ``Model.decode_step``: rows and
offsets, host spans).  From the program it reads only ``EngineStats``
(queue waits, per-step records) and, in a traced run, the device's kernel
intervals and names from ``torch.profiler``.
"""
from __future__ import annotations

import gc
import math
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench import loadgen, weights
from portbench import tracing
from portbench.tracing import DeviceTrace

# top-level module names that must never be loaded in a run's process
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of :data:`BANNED`."""
    import sys
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in BANNED})


def percentile(values, q: float) -> Optional[float]:
    """Nearest-rank percentile (the smallest value with at least q % of
    the values at or below it); None for no values."""
    v = sorted(values)
    if not v:
        return None
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def now() -> float:
    return time.perf_counter()


@dataclass
class Req:
    """One request as its client sees it."""
    spec: loadgen.Spec
    request: object             # the engine's Request
    sent: float                 # when the client sent it
    seen: int = 0               # tokens seen so far
    times: List[float] = field(default_factory=list)  # one per token
    done: Optional[float] = None
    failed: bool = False
    restarts: int = 0

    @property
    def plen(self) -> int:
        return len(self.spec.prompt)


@dataclass
class Call:
    """A call into the model step: ``kind`` prefill_chunk / decode_step,
    its host span, its token rows and (a chunk) its first position."""
    kind: str
    t0: float
    t1: float
    rows: int
    offset: int = 0


@dataclass
class Step:
    """One ``Engine.step`` as the benchmark saw it."""
    t0: float
    t1: float
    calls: List[Call]
    tokens: int = 0             # tokens that became visible
    dec_lens: List[int] = field(default_factory=list)  # rows each
    #                             decode-produced token attended over

    @property
    def chunks(self) -> List[Call]:
        return [c for c in self.calls if c.kind == "prefill_chunk"]

    @property
    def decodes(self) -> List[Call]:
        return [c for c in self.calls if c.kind == "decode_step"]


class ModelSpans:
    """Records every call into the model step (the benchmark's own span
    around the program's ``prefill_chunk`` and ``decode_step``)."""

    def __init__(self, model):
        self.calls: List[Call] = []
        pc, ds = model.prefill_chunk, model.decode_step

        def prefill_chunk(params, tokens, states, pstates, policy, *, slot,
                          q_offset):
            t0 = now()
            out = pc(params, tokens, states, pstates, policy, slot=slot,
                     q_offset=q_offset)
            self.calls.append(Call("prefill_chunk", t0, now(),
                                   int(tokens.shape[1]), int(q_offset)))
            return out

        def decode_step(params, tokens, states, policy, **kw):
            t0 = now()
            out = ds(params, tokens, states, policy, **kw)
            self.calls.append(Call("decode_step", t0, now(),
                                   int(tokens.shape[0])))
            return out

        model.prefill_chunk = prefill_chunk
        model.decode_step = decode_step


class Loop:
    """The closed-loop clients and the engine's step loop: each client
    sends its next request when its last one has finished."""

    def __init__(self, engine, stream: loadgen.Stream, mix: dict,
                 spans: ModelSpans):
        self.engine, self.stream, self.spans = engine, stream, spans
        self.clients = int(mix["arrivals"]["clients"])
        self.reqs: Dict[int, Req] = {}
        self.active: Dict[int, Req] = {}
        self.steps: List[Step] = []

    def _send(self, spec: loadgen.Spec, t: float) -> None:
        from repro_torch.engine import Request
        r = Request(spec.index, spec.prompt, spec.max_new)
        rec = Req(spec, r, t)
        self.reqs[spec.index] = rec
        self.active[spec.index] = rec
        self.engine.enqueue(r)

    def start(self) -> None:
        t = now()
        for _ in range(self.clients):
            self._send(self.stream.take(), t)

    def step(self) -> Step:
        i0 = len(self.spans.calls)
        t0 = now()
        done = self.engine.step()
        t1 = now()
        st = Step(t0, t1, self.spans.calls[i0:])
        for rec in list(self.active.values()):
            n = len(rec.request.generated)
            if n < rec.seen:            # evicted and restarted
                rec.restarts += 1
                rec.seen, rec.times = 0, []
            if n == rec.seen:
                continue
            first = 1 if rec.seen == 0 else 0
            st.dec_lens += [rec.plen + j for j in range(rec.seen + first, n)]
            st.tokens += n - rec.seen
            rec.times += [t1] * (n - rec.seen)
            rec.seen = n
        for r in done:
            rec = self.active.pop(r.rid)
            rec.done, rec.failed = t1, bool(r.failed)
            self._send(self.stream.take(), t1)
        self.steps.append(st)
        return st


@dataclass
class Run:
    """What a metric reader reads: the cell, the window, the benchmark's
    records, the program's ``EngineStats``, and the trace (traced runs)."""
    cell: object
    sizes: dict
    n_active: int
    setup_s: float
    t_open: float
    t_close: float
    loop: Loop
    stats: object               # the program's EngineStats
    records: List[dict]         # its step records inside the window
    trace: Optional[DeviceTrace] = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def inside(self, t: Optional[float]) -> bool:
        return t is not None and self.t_open < t <= self.t_close

    @property
    def steps(self) -> List[Step]:
        """Engine steps that ran inside the window."""
        return [s for s in self.loop.steps
                if s.t0 >= self.t_open and s.t1 <= self.t_close]

    @property
    def requests(self) -> List[Req]:
        return list(self.loop.reqs.values())


def ttfts(run: Run) -> List[float]:
    """Time to first token, from the client's send, of every request
    whose first token became visible inside the window."""
    return [r.times[0] - r.sent for r in run.requests
            if r.times and run.inside(r.times[0])]


def itl_gaps(run: Run) -> List[float]:
    """Every gap between consecutive tokens of one request, both visible
    inside the window (two tokens of one step: a gap of 0)."""
    out: List[float] = []
    for r in run.requests:
        ts = [t for t in r.times if run.inside(t)]
        out += [b - a for a, b in zip(ts, ts[1:])]
    return out


def _warm(engine, mix: dict) -> bool:
    w = mix.get("warmup", {})
    need_adm = int(w.get("admitted", mix["engine"]["slots"]))
    need_done = int(w.get("completed", 0))
    s = engine.stats
    return s.admitted >= need_adm and s.completed >= need_done


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device) -> str:
    """The card's name, count and power limit, for an earlier line."""
    if torch.device(device).type != "cuda":
        return f"device: {device} (no card)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return (f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; nvidia-smi name, power.limit: "
            f"{smi.replace(chr(10), ' | ')}")


def build_engine(cell, sizes: dict, params_w: dict, device):
    """The program under test: its model, its packed weights, its engine,
    configured as the cell's files say."""
    import dataclasses

    from repro_torch.core.policy import get_policy
    from repro_torch.engine import ColocatedTransport, Engine, EngineStats
    from repro_torch.models import qparams
    from repro_torch.models.base import ModelConfig
    from repro_torch.models.transformer import Model

    pol = cell.config["policy"]
    policy = get_policy(pol["name"], decode_impl=pol["decode_impl"],
                        matmul_impl=pol["matmul_impl"])
    if sizes["rms_norm_eps"] != 1e-6:
        raise ValueError("the program's rmsnorm runs eps 1e-6; the "
                         "configuration states "
                         f"{sizes['rms_norm_eps']}")
    mcfg = ModelConfig(arch=cell.config["name"],
                       **cell.family.port_config(sizes))
    mcfg = dataclasses.replace(mcfg, decode_impl=pol["decode_impl"],
                               matmul_impl=pol["matmul_impl"])
    model = Model(mcfg)
    params = params_w
    if pol["matmul_impl"] == "qmm_pallas":
        params = qparams.encode_params(params_w, policy)
    eng = cell.traffic["engine"]
    engine = Engine(model, mcfg, policy, params, slots=int(eng["slots"]),
                    capacity=int(eng["capacity"]),
                    page_size=int(eng["page_size"]),
                    prefill_chunk=int(eng["prefill_chunk"]),
                    transport=[ColocatedTransport()
                               for _ in range(int(eng["prefill_workers"]))],
                    stats=EngineStats(), device=device)
    return engine


def pick_sample(finished: List[Req], seed: int, k: int) -> List[Req]:
    """The longest finished request and ``k - 1`` others drawn from the
    seed."""
    if not finished:
        return []
    by_rid = sorted(finished, key=lambda r: r.spec.index)
    longest = max(by_rid, key=lambda r: (r.plen + r.spec.max_new,
                                         -r.spec.index))
    rest = [r for r in by_rid if r is not longest]
    take = min(len(rest), max(0, k - 1))
    idx = loadgen.rng(seed, 4).choice(len(rest), take, replace=False) \
        if take else []
    return [longest] + [rest[i] for i in sorted(idx)]


def served_gap(family, w: dict, sizes: dict, sample: List[Req], device,
               others: Optional[Dict[str, dict]] = None
               ) -> Tuple[float, int, Dict[str, float]]:
    """The widest gap by which a served token's logit lies below the
    reference's best, over every served token of ``sample``, and the
    number of tokens compared.  ``others`` names further computations
    (keyword arguments of the family's ``logits``, such as the control's
    ``weight_fmt``): each picks its own best token at every position of
    the same prompts and served tokens, and its widest gap below the
    reference's best is returned under its name."""
    if not sample:
        return 0.0, 0, {name: 0.0 for name in others or {}}
    seqs, at, served = [], [], []
    for rec in sample:
        toks = list(rec.request.generated)
        seqs.append(torch.tensor(rec.spec.prompt + toks[:-1],
                                 dtype=torch.int64, device=device))
        at.append(torch.arange(rec.plen - 1, rec.plen - 1 + len(toks),
                               device=device))
        served.append(torch.tensor(toks, dtype=torch.int64, device=device))
    ref = family.logits(w, sizes, seqs, at)

    def widest(picks):
        return max((float((lg.max(dim=-1).values
                           - lg.gather(1, tok[:, None])[:, 0]).max())
                    for lg, tok in zip(ref, picks)), default=0.0)

    more = {name: widest([x.argmax(dim=-1) for x in
                          family.logits(w, sizes, seqs, at, **kw)])
            for name, kw in (others or {}).items()}
    return widest(served), sum(int(t.numel()) for t in served), more


def judge(cell, gap: float, n_tok: int, n_failed: int, n_short: int
          ) -> Dict[str, dict]:
    """The numbers that decide ``correct``, each beside its limit."""
    return {
        "logit_gap": {"value": gap, "limit": float(cell.limits["logit_gap"]),
                      "holds": "<="},
        "compared_tokens": {"value": n_tok, "limit": 1, "holds": ">="},
        "failed_requests": {"value": n_failed, "limit": 0, "holds": "<="},
        "short_answers": {"value": n_short, "limit": 0, "holds": "<="},
    }


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] if c["holds"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def checks_with(result: dict, other: str) -> Dict[str, dict]:
    """A result's checks with the gap of ``other`` (one of its
    ``other_gaps``) in the program's place: what the check would say had
    that computation served the tokens."""
    checks = dict(result["checks"])
    checks["logit_gap"] = dict(checks["logit_gap"],
                               value=result["other_gaps"][other])
    return checks


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: Optional[float] = None, say=print,
             others: Optional[Dict[str, dict]] = None) -> dict:
    """Run ``cell`` once and return its result line (a dict whose last key
    is ``checks``).  ``others`` (``control.py`` only, never a benchmark
    run) also reads the gaps of further computations on the same sample
    (``served_gap``), under the result's ``other_gaps``."""
    t_start = now() if t_start is None else t_start
    sizes = cell.family.sizes(cell.config)
    mix = cell.traffic
    say(card_line(device))
    t0 = now()
    w = weights.dense_weights(sizes, seed, device)
    _sync(device)
    t_w = now() - t0
    engine = build_engine(cell, sizes, weights.port_params(w), device)
    spans = ModelSpans(engine.model)
    stream = loadgen.Stream(mix, seed, sizes["vocab"])
    loop = Loop(engine, stream, mix, spans)
    _sync(device)
    t_e = now() - t0 - t_w
    loop.start()
    while not _warm(engine, mix):
        loop.step()
    _sync(device)
    t_warm = now() - t0 - t_w - t_e
    rec0 = len(engine.stats.records)
    tw = tracing.start(trace and torch.device(device).type == "cuda")
    t_open = now()
    setup_s = t_open - t_start
    while now() < t_open + seconds:
        loop.step()
    _sync(device)
    t_close = now()
    records = engine.stats.records[rec0:]
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if torch.device(device).type == "cuda" else 0
    dtrace = tw.read(t_open, t_close, loop.steps, spans.calls) \
        if tw is not None else None
    run = Run(cell, sizes, cell.family.param_count(sizes), setup_s, t_open,
              t_close, loop, engine.stats, records, dtrace)
    win = run.steps
    say(f"setup: {setup_s:.3f} s (weights {t_w:.3f}, engine and kernels "
        f"{t_e:.3f}, warm-up {t_warm:.3f} over {len(loop.steps) - len(win)} "
        f"steps); window {run.window_s:.3f} s, {len(win)} steps, "
        f"{sum(1 for s in win if s.chunks)} with a prefill chunk")
    if dtrace is not None:
        say(dtrace.note)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    sent = [r for r in run.requests if run.inside(r.sent)]
    failed = [r for r in run.requests if r.failed and run.inside(r.done)]
    finished = [r for r in run.requests if run.inside(r.done)
                and not r.failed]
    short = [r for r in finished
             if len(r.request.generated) != r.spec.max_new]
    say(f"requests: sent in window {len(sent)}, finished in window "
        f"{len(finished)}, failed {len(failed)}, in flight at close "
        f"{len(loop.active)}, restarted {sum(r.restarts for r in run.requests)}")
    tt = ttfts(run)
    say(f"samples: ttft {len(tt)} requests (p90 {percentile(tt, 90)} s, "
        f"not bounded), itl {len(itl_gaps(run))} gaps, tokens "
        f"{sum(s.tokens for s in run.steps)}, steps without a prefill chunk "
        f"{sum(1 for s in run.steps if not s.chunks)}")

    # the program's state goes before the reference runs
    sample = pick_sample(finished, seed, int(mix["sample"]["requests"]))
    del engine, loop.engine, spans
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_r = now()
    gap, n_tok, more = served_gap(cell.family, w, sizes, sample, device,
                                  others)
    say(f"reference: {len(sample)} requests, {n_tok} served tokens, "
        f"{now() - t_r:.3f} s")
    checks = judge(cell, gap, n_tok, len(failed), len(short))
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                   else torch.device(device).type,
                   "kind": torch.cuda.get_device_name(0)
                   if torch.device(device).type == "cuda" else str(device),
                   "count": int(cell.chips),
                   "memory_peak_bytes": peak}
    result = {"correct": correct(checks), "attempted": len(sent),
              "failed": len(failed), "metrics": metrics,
              "device": device_info}
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        result["breakdown"] = dtrace.breakdown()
    if others:
        result["other_gaps"] = more
    result["checks"] = checks
    return result
