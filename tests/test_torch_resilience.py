"""Fault injection and recovery in the port, held to the JAX package on
the CPU.

Mirrors ``tests/test_resilience.py``: the fault plan's spelling and JSON
form, the injector's sticky arming and seeded bit flip, the page CRCs of
every paper KV format, the classified errors (kinds, exit codes, the
structured stderr line) and the circuit breaker's event trace, each
equal to the reference's on the same inputs; then the chaos invariant
(a streamed transport, a binary8 draft, and one of every recoverable
fault: the tokens equal the JAX oracle's, and the summary counters the
JAX engine's on the same plan and weights), and the unrecoverable paths
(deadlines, dead letters, CRC exhaustion, step-retry exhaustion and the
watchdog under a patched clock), each classified as the reference
classifies it.  Reduced llama3-8b, weights carried across from the JAX
package by ``models/convert.py``, ``device="cpu"``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import engine as J  # noqa: E402
from repro.core.formats import get_format as jget_format  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.engine import resilience as jres  # noqa: E402
from repro.kernels import paged_cache as jpc  # noqa: E402
from repro.models import qparams as jqparams  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch import engine as T  # noqa: E402
from repro_torch.core.formats import BINARY8  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import resilience as tres  # noqa: E402
from repro_torch.engine import scheduler  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

CHAOS = ("page_corrupt@1,chunk_drop@3,chunk_dup@4,nan_logits@5,"
         "step_exception@6,draft_div@7,pool_exhaust@8,seed=11")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.payload), tree.fmt.name)
    return np.asarray(tree)


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, length).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    """Reduced llama3-8b target weights (binary32) and the binary8 packed
    draft's, from the JAX package, for both sides.  The draft keeps
    binary8 weights and binary8 KV but computes in binary32: the
    reference's bf16 activations round differently under XLA's excess
    precision (ROADMAP Queue 3, item 3), which would change its
    proposals -- and so the acceptance counters, never the tokens."""
    jmodel, jcfg = jbuild("llama3-8b", reduced=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0),
                                 jget_policy("binary32"))
    b8 = jget_format("binary8")
    jdpol = jget_policy("binary32", kv_fmt=b8, decode_impl="paged") \
        .with_overrides(embed_w=b8, attn_w=b8, ffn_w=b8)
    jdparams = jqparams.encode_params(
        jmodel.init_params(jax.random.PRNGKey(0), jdpol), jdpol)
    model, cfg = build("llama3-8b", reduced=True)
    return dict(
        jmodel=jmodel, jcfg=jcfg, jparams=jparams, jdpol=jdpol,
        jdparams=jdparams, model=model, cfg=cfg,
        params=params_from_numpy(_to_numpy(jparams), device="cpu"),
        dparams=params_from_numpy(_to_numpy(jdparams), device="cpu"))


def _jpol(kv="binary32"):
    return jget_policy("binary32", kv_fmt=jget_format(kv),
                       decode_impl="paged")


def _tpol(kv="binary32"):
    return get_policy("binary32", kv_fmt=kv, decode_impl="paged")


def _tdraft(w, k=3):
    dpol = get_policy("binary32", kv_fmt=BINARY8, decode_impl="paged") \
        .with_overrides(embed_w=BINARY8, attn_w=BINARY8, ffn_w=BINARY8)
    return T.SpeculativeDecoder(w["model"], w["cfg"], dpol, w["dparams"],
                                k=k)


def _jdraft(w, k=3):
    return J.SpeculativeDecoder(w["jmodel"], w["jcfg"], w["jdpol"],
                                w["jdparams"], k=k)


def _oracle(w, prompts, max_new, capacity=64, kv="binary32"):
    """The JAX synchronous oracle's tokens."""
    return J.synchronous_generate(w["jmodel"], w["jcfg"], _jpol(kv),
                                  w["jparams"], prompts, max_new=max_new,
                                  capacity=capacity)


def _tengine(w, kv="binary32", **kw):
    return T.Engine(w["model"], w["cfg"], _tpol(kv), w["params"],
                    device="cpu", **kw)


def _jengine(w, kv="binary32", **kw):
    return J.Engine(w["jmodel"], w["jcfg"], _jpol(kv), w["jparams"], **kw)


# ----------------------------------------------------------- fault plans
def test_fault_plan_parse_json_and_describe_match_reference(tmp_path):
    spec = "page_corrupt@2,chunk_drop@5/1, nan_logits@3 ,seed=9"
    tp, jp = T.FaultPlan.parse(spec), J.FaultPlan.parse(spec)
    assert tp.to_json() == jp.to_json()
    assert tp.describe() == jp.describe()
    assert [f.spec for f in tp] == [f.spec for f in jp]
    doc = tp.to_json()
    assert T.FaultPlan.from_json(doc).to_json() == doc
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(doc))
    assert T.FaultPlan.load(str(p)).to_json() == \
        J.FaultPlan.load(str(p)).to_json()
    assert T.FaultPlan.load(CHAOS).to_json() == \
        J.FaultPlan.load(CHAOS).to_json()
    for bad in ("nan_logits", "bogus@2", "nan_logits@0"):
        with pytest.raises(ValueError):
            J.FaultPlan.parse(bad)
        with pytest.raises(ValueError):
            T.FaultPlan.parse(bad)


def test_injector_sticky_arming_matches_reference():
    """The same calls on both injectors give the same faults, masks and
    counters, step by step."""
    spec = ("step_exception@3,nan_logits@2,draft_div@2/1,pool_exhaust@4,"
            "chunk_drop@1,page_corrupt@5,seed=5")
    ts, js = T.EngineStats(), J.EngineStats()
    ti = T.FaultInjector(T.FaultPlan.parse(spec), ts)
    ji = J.FaultInjector(J.FaultPlan.parse(spec), js)
    trace = []
    for step in range(1, 8):
        outs = []
        for inj in (ti, ji):
            inj.begin_step(step)
            nan = inj.slot_mask("nan_logits", [0, 2], 4)
            div = inj.slot_mask("draft_div", [0, 2], 4)
            tr = inj.take_transport()
            try:
                inj.maybe_raise()
                raised = False
            except (T.SimulatedFault, J.SimulatedFault):
                raised = True
            outs.append((None if nan is None else nan.tolist(),
                         None if div is None else div.tolist(),
                         tr and tr.spec, raised, inj.pool_exhausted(),
                         inj.all_fired))
        assert outs[0] == outs[1], step
        trace.append(outs[0])
    assert trace[-1][-1]            # every fault fired
    assert ts.faults_by_kind == js.faults_by_kind
    assert ts.faults_injected == js.faults_injected == 6


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "float32",
                                   "bfloat16", "float8_e5m2", "float16"])
def test_corrupt_flips_the_reference_bit(dtype):
    """Same seed, same bytes: the port flips the reference's bit, on a
    torch tensor of the page dtype (source untouched)."""
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, size=2 * 8 * 2 * 4 * 4, dtype=np.uint8)
    npdt = {"bfloat16": ml_dtypes.bfloat16,
            "float8_e5m2": ml_dtypes.float8_e5m2}.get(dtype, dtype)
    pages = raw.view(npdt).reshape(2, 8, 2, -1)
    want = J.FaultInjector(J.FaultPlan(seed=7)).corrupt(pages)
    tdt = getattr(torch, dtype)
    tp = torch.from_numpy(raw.copy()).view(tdt).reshape(pages.shape)
    before = tp.clone()
    got = T.FaultInjector(T.FaultPlan(seed=7)).corrupt(tp)
    assert got.dtype == tdt and got.shape == tp.shape
    assert torch.equal(tp.view(torch.uint8), before.view(torch.uint8))
    np.testing.assert_array_equal(
        got.reshape(-1).view(torch.uint8).numpy(),
        np.asarray(want).reshape(-1).view(np.uint8))


@pytest.mark.parametrize("fmt", ["binary8", "binary16", "binary16alt",
                                 "binary32"])
def test_page_checksums_match_reference(fmt):
    """Per-page CRCs of a pool in each paper KV format (the pool dtype the
    policy stores it in), from the same page bytes."""
    jdt = jget_policy("binary32", kv_fmt=jget_format(fmt)).dtype(
        "kv_cache")
    tdt = get_policy("binary32", kv_fmt=fmt).dtype("kv_cache")
    rng = np.random.default_rng(1)
    shape = (3, 8, 2, 4)
    width = np.dtype(jdt).itemsize
    raw = rng.integers(0, 256, size=int(np.prod(shape)) * width * 2,
                       dtype=np.uint8)
    k_raw, v_raw = np.split(raw, 2)
    jk = jnp.asarray(k_raw.view(jdt).reshape(shape))
    jv = jnp.asarray(v_raw.view(jdt).reshape(shape))
    tk = torch.from_numpy(k_raw.copy()).view(tdt).reshape(shape)
    tv = torch.from_numpy(v_raw.copy()).view(tdt).reshape(shape)
    want = jres.page_checksums(jk, jv)
    assert tres.page_checksums(tk, tv) == want
    flipped = T.FaultInjector(T.FaultPlan(seed=2)).corrupt(tk)
    assert tres.page_checksums(flipped, tv) != want


# ----------------------------------------------------- classified errors
def test_classified_errors_match_reference():
    names = ("EngineError", "DeadlineExceeded", "DeadLetterRequest",
             "TransportError", "StepFailure", "WatchdogTimeout")
    for name in names:
        te, je = getattr(tres, name), getattr(jres, name)
        assert (te.kind, te.exit_code) == (je.kind, je.exit_code)
        assert tres.exit_code_for(te("x")) == jres.exit_code_for(je("x"))
        for req in (None, 3):
            assert tres.format_error(te("page 3 bad"), requests=req) == \
                jres.format_error(je("page 3 bad"), requests=req)
    assert (tpc.PoolError.kind, tpc.PoolError.exit_code) == \
        (jpc.PoolError.kind, jpc.PoolError.exit_code) == ("pool", 76)
    assert tres.exit_code_for(ValueError("x")) is None
    assert [getattr(tres, n).exit_code for n in names] == list(range(70, 76))


@pytest.mark.parametrize("side", ["port", "reference"])
def test_with_retries_recovers_then_exhausts_classified(side):
    E, mod = (T, tres) if side == "port" else (J, jres)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise E.SimulatedFault("boom")
        return "ok"

    stats = E.EngineStats()
    pol = mod.RetryPolicy(max_attempts=4, backoff_s=0.0)
    assert mod.with_retries(flaky, pol, stats,
                            retriable=(E.SimulatedFault,)) == "ok"
    assert stats.retries == 2

    def always():
        raise E.SimulatedFault("still down")

    with pytest.raises(mod.StepFailure, match="decode step"):
        mod.with_retries(always, pol, retriable=(E.SimulatedFault,),
                         what="decode step")
    with pytest.raises(KeyError):   # non-retriable passes straight through
        mod.with_retries(lambda: {}["x"], pol,
                         retriable=(E.SimulatedFault,))
    assert mod.RetryPolicy(backoff_s=0.01, backoff_cap_s=0.02).delay_s(5) \
        == 0.02
    with pytest.raises(ValueError):
        mod.RetryPolicy(max_attempts=0)


def test_circuit_breaker_event_trace_matches_reference():
    """A seeded stream of allows / record events: the same states,
    failures and trips after every event, and the same stats trips."""
    rng = np.random.default_rng(4)
    ts, js = T.EngineStats(), J.EngineStats()
    tb = tres.CircuitBreaker(fail_rounds=2, cooldown_steps=3)
    jb = jres.CircuitBreaker(fail_rounds=2, cooldown_steps=3)
    for step in range(1, 120):
        allowed = [tb.allows(step), jb.allows(step)]
        assert allowed[0] == allowed[1]
        if allowed[0]:
            proposed = int(rng.integers(0, 5))
            accepted = int(rng.integers(0, proposed + 1)) \
                if rng.random() < 0.5 else 0
            tb.record(step=step, proposed=proposed, accepted=accepted,
                      stats=ts)
            jb.record(step=step, proposed=proposed, accepted=accepted,
                      stats=js)
        assert (tb.state, tb.failures, tb.trips) == \
            (jb.state, jb.failures, jb.trips)
    assert tb.trips > 1 and ts.breaker_trips == js.breaker_trips == tb.trips
    with pytest.raises(ValueError):
        tres.CircuitBreaker(cooldown_steps=0)


# --------------------------------------------------- the chaos invariant
SUMMARY_KEYS = ("faults_injected", "faults_unfired", "faults_by_kind",
                "retries", "crc_mismatches", "quarantines",
                "quarantined_pages", "degraded_steps", "breaker_trips",
                "deadline_misses", "dead_letters", "failures", "evictions",
                "requests", "completed", "admitted", "decode_tokens",
                "steps", "target_steps", "spec_rounds",
                "prefill_chunks_by_worker")


@pytest.mark.parametrize("kv", ["binary8", "binary32"])
def test_chaos_plan_tokens_match_jax_oracle(weights, kv):
    """The reference's chaos plan (one of every recoverable fault), page
    8, a streamed transport and a binary8 draft (k = 3): the port's
    tokens equal the JAX synchronous oracle's, every fault fires, and the
    counters explain every fault."""
    w = weights
    prompts = _prompts(3, 16)
    want = _oracle(w, prompts, 10, kv=kv)
    eng = _tengine(w, kv, slots=2, capacity=64, page_size=8, pool_pages=32,
                   transport=T.StreamedTransport(), speculative=_tdraft(w),
                   fault_plan=T.FaultPlan.parse(CHAOS))
    reqs = [T.Request(i, list(p), 10) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.generated for r in reqs] == want
    assert all(r.done and r.error is None for r in reqs)
    assert eng.injector.all_fired, [f.spec for f in eng.injector.pending]
    s = eng.summary
    assert s["faults_injected"] == 7 and s["faults_unfired"] == 0
    assert set(s["faults_by_kind"]) == {
        "page_corrupt", "chunk_drop", "chunk_dup", "nan_logits",
        "step_exception", "draft_div", "pool_exhaust"}
    assert s["crc_mismatches"] >= 2 and s["retries"] >= 3
    assert s["quarantines"] == 1 and s["quarantined_pages"] > 0
    assert s["evictions"] >= 1 and s["failures"] == 0


def test_chaos_plan_counters_match_jax_engine(weights):
    """The chaos plan through both engines on the same weights, binary8
    KV: the same tokens and the same summary counters.  The draft
    proposes one token a round here: at k > 1 the reference's round
    leaves its draft's device lengths un-rolled-back (it reads the draft
    bases after the proposal loop, ``src/repro/engine/speculative.py:136``),
    so its draft accepts less often than the port's and the
    acceptance-driven counters (rounds, pages held at quarantine)
    differ, never the tokens."""
    w = weights
    prompts = _prompts(3, 16)
    kw = dict(slots=2, capacity=64, page_size=8, pool_pages=32)
    out = {}
    for side, E, mk, dr in (("t", T, _tengine, _tdraft),
                            ("j", J, _jengine, _jdraft)):
        eng = mk(w, "binary8", transport=E.StreamedTransport(),
                 speculative=dr(w, k=1), fault_plan=E.FaultPlan.parse(CHAOS),
                 **kw)
        reqs = [E.Request(i, list(p), 10) for i, p in enumerate(prompts)]
        eng.run(reqs)
        assert eng.injector.all_fired
        out[side] = ([r.generated for r in reqs],
                     {k: eng.summary[k] for k in SUMMARY_KEYS})
    assert out["t"] == out["j"]
    assert out["t"][0] == _oracle(w, prompts, 10, kv="binary8")
    assert out["t"][1]["faults_injected"] == 7


def test_nan_guard_quarantines_and_replays_plain_decode(weights):
    """Non-speculative NaN: the slot's pages leave circulation and the
    request finishes with the oracle's tokens (the port used to fail it
    with an error of its own)."""
    w = weights
    prompts = _prompts(2, 8)
    want = _oracle(w, prompts, 4, capacity=32)
    eng = _tengine(w, slots=2, capacity=32, page_size=8,
                   fault_plan=T.FaultPlan.parse("nan_logits@2"))
    reqs = [T.Request(i, list(p), 4) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.generated for r in reqs] == want
    assert all(r.done and not r.failed for r in reqs)
    s = eng.summary
    assert s["quarantines"] == 1 and s["failures"] == 0
    assert eng.pool.stats()["quarantined_pages"] == s["quarantined_pages"] > 0


def test_no_fault_step_launches_nothing_for_the_injector(weights,
                                                         monkeypatch):
    """With no fault armed the decode step gets no mask (nothing is
    launched for it), and the loop crosses to the host once a step."""
    w = weights
    masks, calls = [], []
    real_step = T.DecodeWorker.step
    real_host = scheduler._host

    def spy_step(self, params, tokens, states, nan_mask=None):
        masks.append(nan_mask)
        return real_step(self, params, tokens, states, nan_mask)

    def spy_host(*t):
        calls.append(len(t))
        return real_host(*t)

    monkeypatch.setattr(T.DecodeWorker, "step", spy_step)
    monkeypatch.setattr(scheduler, "_host", spy_host)
    eng = _tengine(w, slots=2, capacity=32, page_size=8,
                   fault_plan=T.FaultPlan.parse("nan_logits@3"))
    eng.run([T.Request(i, p, 4) for i, p in enumerate(_prompts(2, 8))])
    armed = [m for m in masks if m is not None]
    assert len(armed) == 1 and masks[0] is None
    assert len(calls) == eng.decode_steps + 2   # + one per prefill


# ------------------------------------- unrecoverable paths, classified
def test_crc_exhaustion_recomputes_like_reference(weights):
    """Every refetch corrupted: TransportError inside the transport, the
    request recomputed from its prompt -- the reference's tokens and
    counters; with max_requeues=0 it dead-letters, as in the reference."""
    w = weights
    prompts = _prompts(1, 8)
    plan = ",".join(["page_corrupt@1"] * 4) + ",seed=2"
    kw = dict(slots=1, capacity=32, page_size=8)
    out = {}
    for side, E, mk in (("t", T, _tengine), ("j", J, _jengine)):
        eng = mk(w, transport=E.StreamedTransport(),
                 fault_plan=E.FaultPlan.parse(plan),
                 retry_policy=E.RetryPolicy(max_attempts=4, backoff_s=0.0),
                 **kw)
        reqs = [E.Request(0, list(prompts[0]), 4)]
        eng.run(reqs)
        out[side] = ([r.generated for r in reqs],
                     {k: eng.summary[k] for k in SUMMARY_KEYS})
    assert out["t"] == out["j"]
    assert out["t"][0] == _oracle(w, prompts, 4, capacity=32)
    assert out["t"][1]["crc_mismatches"] == 4
    assert out["t"][1]["evictions"] == 1

    eng = _tengine(w, transport=T.StreamedTransport(), max_requeues=0,
                   fault_plan=T.FaultPlan.parse(plan),
                   retry_policy=T.RetryPolicy(max_attempts=4, backoff_s=0.0),
                   **kw)
    r = T.Request(0, list(prompts[0]), 4)
    eng.run([r])
    assert isinstance(r.error, T.DeadLetterRequest) and not r.done
    assert tres.exit_code_for(r.error) == 72


def test_step_exception_retry_exhaustion_raises_stepfailure(weights):
    w = weights
    plan = ",".join(["step_exception@2"] * 3)
    for E, mk in ((T, _tengine), (J, _jengine)):
        eng = mk(w, slots=1, capacity=32, page_size=8,
                 fault_plan=E.FaultPlan.parse(plan),
                 retry_policy=E.RetryPolicy(max_attempts=2, backoff_s=0.0))
        with pytest.raises(E.StepFailure) as ei:
            eng.run([E.Request(0, _prompts(1, 8)[0], 4)])
        assert eng.stats.retries == 2
        assert ei.value.exit_code == 74 and ei.value.kind == "step"


def test_deadlines_and_dead_letters_match_reference(weights):
    """One slot, three requests under a 3-step deadline (one overrides
    it), then a dead letter after one injected exhaustion: the port's
    results, classes and counters are the reference's."""
    w = weights
    p = _prompts(3, 8)
    res = {}
    for side, E, mk in (("t", T, _tengine), ("j", J, _jengine)):
        reqs = [E.Request(0, p[0], 8), E.Request(1, p[1], 2,
                                                 deadline_steps=50),
                E.Request(2, p[2], 8)]
        eng = mk(w, slots=1, capacity=32, page_size=8, deadline_steps=3)
        eng.run(reqs)
        dl = E.Request(3, p[0], 8)
        eng2 = mk(w, slots=1, capacity=32, page_size=8, max_requeues=0,
                  fault_plan=E.FaultPlan.parse("pool_exhaust@2"))
        eng2.run([dl])
        res[side] = ([(r.done, r.generated, type(r.error).__name__,
                       getattr(r.error, "exit_code", None))
                      for r in reqs + [dl]],
                     {k: eng.summary[k] for k in SUMMARY_KEYS},
                     {k: eng2.summary[k] for k in SUMMARY_KEYS})
    assert res["t"] == res["j"]
    outcome = [(d, e) for d, _, e, _ in res["t"][0]]
    assert outcome == [(False, "DeadlineExceeded"), (True, "NoneType"),
                       (False, "DeadlineExceeded"),
                       (False, "DeadLetterRequest")]
    assert res["t"][1]["deadline_misses"] == 2
    assert res["t"][2]["dead_letters"] == 1


def test_watchdog_trips_on_a_patched_clock(weights, monkeypatch):
    """A clock that advances 1 s per reading: every step is over a 0.5 s
    budget, so the third consecutive one raises WatchdogTimeout (75),
    the summary line still written; at a 5 s budget the run finishes."""
    w = weights
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    monkeypatch.setattr(scheduler.time, "perf_counter", clock)
    eng = _tengine(w, slots=1, capacity=32, page_size=8, watchdog_s=0.5)
    with pytest.raises(T.WatchdogTimeout) as ei:
        eng.run([T.Request(0, _prompts(1, 8)[0], 8)])
    assert ei.value.exit_code == 75 and ei.value.kind == "watchdog"
    assert eng.stats.watchdog_trips == 3 and eng.summary is not None
    eng = _tengine(w, slots=1, capacity=32, page_size=8, watchdog_s=5.0)
    r = T.Request(0, _prompts(1, 8)[0], 4)
    eng.run([r])
    assert r.done and eng.stats.watchdog_trips == 0


def test_breaker_opens_on_divergence_and_recovers(weights):
    """Two fully diverged rounds trip the breaker; the engine decodes
    plain through the cooldown (draft KV kept warm by the shadow step);
    the tokens stay the oracle's."""
    w = weights
    prompts = _prompts(1, 8)
    eng = _tengine(w, slots=1, capacity=64, page_size=8,
                   speculative=_tdraft(w, k=3),
                   breaker=T.CircuitBreaker(fail_rounds=2, cooldown_steps=3),
                   fault_plan=T.FaultPlan.parse("draft_div@2,draft_div@3"))
    reqs = [T.Request(0, list(prompts[0]), 12)]
    eng.run(reqs)
    assert [r.generated for r in reqs] == _oracle(w, prompts, 12)
    s = eng.summary
    assert s["breaker_trips"] >= 1 and s["degraded_steps"] >= 2
    assert s["faults_by_kind"] == {"draft_div": 2} and s["failures"] == 0


def test_serve_cli_exit_codes(weights, capsys):
    """``cli_main`` maps classified results to the reference's exit codes
    and stderr lines: 0, 71 for a deadline, 75 for the watchdog, 72 for a
    CRC-exhausted request that may not requeue."""
    base = ["--arch", "llama3-8b", "--reduced", "--requests", "2",
            "--slots", "1", "--prompt-len", "8", "--max-new", "2",
            "--capacity", "32", "--page-size", "8", "--decode-impl",
            "paged", "--device", "cpu"]
    assert tserve.cli_main(base) == 0
    capsys.readouterr()
    assert tserve.cli_main(base + ["--deadline-steps", "1"]) == 71
    err = capsys.readouterr().err
    assert "[serve:error] kind=deadline exit=71" in err and "requests=1" in err
    assert tserve.cli_main(base + ["--max-new", "8", "--watchdog-s",
                                   "0.0"]) == 75
    assert "[serve:error] kind=watchdog exit=75" in capsys.readouterr().err
    crc = ",".join(["page_corrupt@1"] * 4)
    assert tserve.cli_main(base + ["--disaggregate", "--fault-plan", crc,
                                   "--max-requeues", "0"]) == 72
    out = capsys.readouterr()
    assert "kind=dead_letter exit=72" in out.err
    assert "[serve] resilience: faults=4" in out.out
