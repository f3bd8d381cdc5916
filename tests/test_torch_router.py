"""The port's router, prefill workers, streamed transport and
whole-prompt prefill, held to the JAX package on the CPU.

Mirrors ``tests/test_router.py`` and the engine cases of
``tests/test_engine.py``: two prefill workers (colocated or streamed)
and the asyncio router with ``max_pending`` serve the single-worker
tokens, which are the JAX oracle's; a mid-prefill eviction and
readmission of the same request id stays exact on both transports; the
token stream, backpressure, reject-at-submit and the engine-fatal path
behave as the reference's; the CRC catches a bit flipped during the
page transfer; and ``--prefill-chunk 0`` gives the chunked tokens.
Reduced llama3-8b under binary32, weights carried across from the JAX
package, ``device="cpu"``."""
import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import engine as J  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch import engine as T  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import transport as transport_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, length).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def served():
    """(port model, cfg, policy, params) with the JAX weights, and the
    JAX oracle over them."""
    jmodel, jcfg = jbuild("llama3-8b", reduced=True)
    jpol = jget_policy("binary32", decode_impl="paged")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jpol)
    model, cfg = build("llama3-8b", reduced=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")

    def oracle(prompts, max_new, capacity):
        return J.synchronous_generate(jmodel, jcfg, jpol, jparams, prompts,
                                      max_new=max_new, capacity=capacity)

    return model, cfg, get_policy("binary32", decode_impl="paged"), \
        params, oracle


def _engine(served, **kw):
    model, cfg, pol, params, _ = served
    kw.setdefault("slots", 2)
    kw.setdefault("capacity", 64)
    kw.setdefault("page_size", 8)
    return T.Engine(model, cfg, pol, params, device="cpu", **kw)


async def _serve_burst(engine, reqs, **kw):
    """Every request submitted BEFORE the engine thread starts: the
    arrival burst is deterministic."""
    router = T.Router(engine, **kw)
    tickets = [await router.submit_request(r) for r in reqs]
    router.start()
    out = [await t.result() for t in tickets]
    await router.close()
    return out


# ----------------------------------------------------------- determinism
@pytest.mark.parametrize("transport", ["colocated", "streamed"])
def test_two_prefill_workers_match_single_and_oracle(served, transport):
    """Engine.run with two prefill tasks in flight (one transport each)
    emits the single-worker tokens, the JAX oracle's, and both workers
    ran chunks."""
    prompts = _prompts(4, 16)
    want = served[4](prompts, 4, 64)
    cls = T.ColocatedTransport if transport == "colocated" \
        else T.StreamedTransport
    eng = _engine(served, transport=[cls(), cls()])
    reqs = [T.Request(i, list(p), 4) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.generated for r in reqs] == want
    one = _engine(served)
    single = [T.Request(i, list(p), 4) for i, p in enumerate(prompts)]
    one.run(single)
    assert [r.generated for r in single] == want
    s = eng.summary
    assert set(s["prefill_chunks_by_worker"]) == {"0", "1"}
    assert s["requests"] == s["completed"] + s["failures"] == 4
    assert s["queue_wait_mean_s"] is not None


def test_router_two_workers_max_pending_match_oracle(served):
    """Async submissions through 2 streamed workers with max_pending 2,
    a deadline failure riding along: the oracle's tokens for the rest."""
    prompts = _prompts(4, 16)
    want = served[4](prompts, 4, 64)
    eng = _engine(served, transport=[T.StreamedTransport(),
                                     T.StreamedTransport()])
    reqs = [T.Request(i, list(p), 4) for i, p in enumerate(prompts)]
    doomed = T.Request(99, _prompts(1, 16, seed=3)[0], 4, deadline_steps=1)
    out = asyncio.run(_serve_burst(eng, [doomed] + reqs))
    assert isinstance(doomed.error, T.DeadlineExceeded)
    assert [r.generated for r in out[1:]] == want
    assert all(r.done and r.error is None for r in out[1:])
    out2 = asyncio.run(T.run_router(
        _engine(served, transport=[T.ColocatedTransport(),
                                   T.ColocatedTransport()]),
        [T.Request(i, list(p), 4) for i, p in enumerate(prompts)],
        max_pending=2))
    assert [r.generated for r in out2] == want
    s = eng.summary
    assert s["failures"] == s["deadline_misses"] == 1
    assert s["requests"] == 5


class _AbortCounting:
    def __init__(self):
        self.aborts = 0

    def abort(self, engine, task):
        self.aborts += 1
        super().abort(engine, task)


class _AbortColocated(_AbortCounting, T.ColocatedTransport):
    pass


class _AbortStreamed(_AbortCounting, T.StreamedTransport):
    def __init__(self):
        _AbortCounting.__init__(self)
        T.StreamedTransport.__init__(self)


@pytest.mark.parametrize("cls", [_AbortColocated, _AbortStreamed],
                         ids=["colocated", "streamed"])
def test_mid_prefill_abort_and_readmission_same_rid(served, cls):
    """An 80-token prompt evicted mid-prefill (the transport's abort
    fires with pages already handed over) and readmitted under the same
    request id, under the router: the oracle's tokens."""
    p0, p1 = _prompts(1, 7)[0], _prompts(1, 80, seed=1)[0]
    want = [served[4]([p0], 12, 96)[0], served[4]([p1], 4, 96)[0]]
    tr = cls()
    eng = _engine(served, capacity=96, pool_pages=12, transport=tr)
    reqs = [T.Request(0, list(p0), 12), T.Request(1, list(p1), 4)]
    out = asyncio.run(_serve_burst(eng, reqs))
    assert [r.generated for r in out] == want
    assert reqs[1].evictions >= 1 and tr.aborts >= 1
    assert reqs[1].error is None and eng.summary["evictions"] >= 1


def test_router_streams_tokens(served):
    [p] = _prompts(1, 8)
    want = served[4]([p], 4, 32)[0]

    async def go():
        async with T.Router(_engine(served, slots=1,
                                    capacity=32)) as router:
            t = await router.submit(p, 4)
            seen = [tok async for tok in t.tokens()]
            return seen, await t.result()

    seen, r = asyncio.run(go())
    assert seen == want == r.generated


def test_router_backpressure_and_reject(served):
    prompts = _prompts(2, 8)

    async def go():
        async with T.Router(_engine(served, capacity=32),
                            max_pending=1) as router:
            with pytest.raises(ValueError):
                await router.submit(list(range(1000)), 4)
            t0 = await router.submit(prompts[0], 4)
            assert router._sem.locked()
            r0 = await t0.result()
            r1 = await (await router.submit(prompts[1], 4)).result()
        return r0, r1

    r0, r1 = asyncio.run(go())
    assert r0.done and r1.done and not r0.failed and not r1.failed


def test_router_fatal_fails_outstanding_tickets(served):
    """An engine-fatal error (the watchdog) fails every outstanding ticket
    with the same classified error; the router then refuses submissions
    and the summary is still written."""
    [p] = _prompts(1, 8)

    async def go():
        eng = _engine(served, slots=1, capacity=32, watchdog_s=0.0,
                      watchdog_limit=1)
        router = T.Router(eng)
        t = await router.submit(p, 4)
        router.start()
        with pytest.raises(T.WatchdogTimeout):
            await t.result()
        assert isinstance(router.fatal, T.WatchdogTimeout)
        with pytest.raises(T.WatchdogTimeout):
            await router.submit(p, 4)
        await router.close()
        return eng

    assert asyncio.run(go()).summary is not None


# ---------------------------------------------------- streamed transport
def test_crc_catches_corruption_during_device_transfer(served, monkeypatch):
    """A bit flipped DURING the page transfer is detected (the CRC is
    taken from the source pool before it) and refetched clean."""
    prompts = _prompts(2, 16)
    want = served[4](prompts, 4, 32)
    real = transport_mod._device_transfer
    state = {"armed": True}

    def corrupting(x, device):
        out = real(x, device).clone()
        if state["armed"]:
            state["armed"] = False
            out.view(-1).view(torch.uint8)[0] ^= 0x10
        return out

    monkeypatch.setattr(transport_mod, "_device_transfer", corrupting)
    tr = T.StreamedTransport()
    eng = _engine(served, capacity=32, transport=tr)
    tr._cross = True     # one device: force the transfer branch
    reqs = [T.Request(i, list(p), 4) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.generated for r in reqs] == want
    assert not state["armed"]
    s = eng.summary
    assert s["crc_mismatches"] >= 1 and s["retries"] >= 1
    assert s["failures"] == 0


def test_streamed_transport_refuses_two_inflight_prefills(served):
    tr = T.StreamedTransport()
    eng = _engine(served, capacity=32, transport=tr)
    tr.begin(eng, object())
    with pytest.raises(ValueError, match="own transport"):
        tr.begin(eng, object())
    with pytest.raises(ValueError, match="own transport"):
        _engine(served, capacity=32, transport=[tr, tr])


# --------------------------------------------------------- stats repairs
def test_requests_accounting_and_summary_on_a_raising_run(served,
                                                          tmp_path):
    """requests == completed + failures, a request that deadlines
    mid-prefill counted; a run that raises still writes its summary line
    and closes the stream."""
    out = tmp_path / "engine.jsonl"
    eng = _engine(served, stats=T.EngineStats(str(out)))
    ok = T.Request(0, _prompts(1, 8)[0], 4)
    doomed = T.Request(1, _prompts(1, 32, seed=1)[0], 4, deadline_steps=2)
    eng.run([ok, doomed])
    assert ok.done and isinstance(doomed.error, T.DeadlineExceeded)
    s = eng.summary
    assert (s["requests"], s["completed"], s["failures"], s["admitted"],
            s["deadline_misses"]) == (2, 1, 1, 2, 1)
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [ln for ln in lines if ln["kind"] == "summary"] == [s]

    out2 = tmp_path / "raise.jsonl"
    eng = _engine(served, slots=1, capacity=32,
                  stats=T.EngineStats(str(out2)), watchdog_s=0.0,
                  watchdog_limit=1)
    with pytest.raises(T.WatchdogTimeout):
        eng.run([T.Request(0, _prompts(1, 8)[0], 4)])
    assert eng.stats._fh is None
    lines = [json.loads(ln) for ln in out2.read_text().splitlines()]
    assert lines[-1]["kind"] == "summary" == eng.summary["kind"]


# ------------------------------------------------- whole-prompt prefill
def test_whole_prompt_prefill_matches_chunked(served):
    """``prefill_chunk=0``: one Model.prefill and a bulk write_prefill
    per prompt; the chunked tokens, the oracle's, and a transient staging
    buffer of the whole prompt."""
    prompts = _prompts(3, 20)
    want = served[4](prompts, 5, 64)
    for transport in (T.ColocatedTransport(), T.StreamedTransport()):
        eng = _engine(served, prefill_chunk=0, transport=transport)
        reqs = [T.Request(i, list(p), 5) for i, p in enumerate(prompts)]
        eng.run(reqs)
        assert [r.generated for r in reqs] == want
        assert eng.summary["peak_prefill_transient_tokens"] == 20
    with pytest.raises(ValueError, match="prefill-chunk"):
        _engine(served, prefill_chunk=-1)


def test_serve_cli_router_disaggregate_matches_jax_cli(served, capsys):
    """The port's CLI with ``--disaggregate --router --prefill-workers 2
    --max-pending 2`` and ``--prefill-chunk 0``: the JAX CLI's tokens on
    the same weights, and the reference's ``router:`` line."""
    flags = ["--arch", "llama3-8b", "--reduced", "--policy", "binary32",
             "--page-size", "8", "--requests", "3", "--slots", "2",
             "--prompt-len", "9", "--max-new", "4", "--capacity", "16",
             "--decode-impl", "paged"]
    want = jserve.main(flags)
    capsys.readouterr()
    params = served[3]
    for extra in (["--disaggregate", "--router", "--prefill-workers", "2",
                   "--max-pending", "2"], ["--prefill-chunk", "0"]):
        got = tserve.main(flags + extra + ["--device", "cpu"], params=params)
        out = capsys.readouterr().out
        assert [r.generated for r in got] == [r.generated for r in want]
        assert ("[serve] router: 2 prefill worker(s)" in out) == \
            ("--router" in extra)
        assert ("transport: streamed" in out) == ("--disaggregate" in extra)
