"""Speculative decoding in the port, held to the JAX package on the CPU.

Mirrors ``tests/test_speculative.py``: the paged-cache functions the
round needs (``append_block``, ``truncate_seq_lens``, ``set_seq_len``)
bit-identical to the JAX ones and to sequential ``append_decode``; the
``PagePool`` namespaces with the JAX allocator's bookkeeping under seeded
interleavings; ``verify_step`` bit-identical to k sequential
``decode_step`` calls for every base decode backend (the plain paths: on
the card the matmul sums in another order at M = B * k, see
``chip_smoke.py``); speculative greedy tokens equal to non-speculative
ones, to the synchronous oracle under eviction, and to the JAX
``SpeculativeDecoder``'s on the same weights; and a vocab mismatch
rejected."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.formats import BINARY8 as JBINARY8  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineStats as JEngineStats  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import SpeculativeDecoder as JSpecDecoder  # noqa: E402
from repro.kernels import paged_cache as jpc  # noqa: E402
from repro.models import qparams as jqparams  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch.core.formats import BINARY8, PAPER_FORMATS  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import (Engine, EngineStats, Request,  # noqa: E402
                                SpeculativeDecoder, synchronous_generate)
from repro_torch.engine import scheduler  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.models import qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.payload), tree.fmt.name)
    return np.asarray(tree)


def _prompts(cfg, n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, min(cfg.vocab, 97), length).tolist()
            for _ in range(n)]


def _draft_policy():
    return get_policy("transprecision", decode_impl="paged").with_overrides(
        embed_w=BINARY8, attn_w=BINARY8, ffn_w=BINARY8)


def _draft(model, cfg, k=4, seed=0):
    """Binary8 packed draft; seed 0 shares the target's weights (high
    acceptance), another seed gives an unrelated draft."""
    dpol = _draft_policy()
    gen = torch.Generator().manual_seed(seed)
    dparams = qparams.encode_params(
        model.init_params(gen, dpol, device="cpu"), dpol)
    return SpeculativeDecoder(model, cfg, dpol, dparams, k=k)


@pytest.fixture(scope="module")
def served():
    model, cfg = build("llama3-8b", reduced=True)
    pol = get_policy("binary32", decode_impl="paged")
    gen = torch.Generator().manual_seed(0)
    return model, cfg, pol, model.init_params(gen, pol, device="cpu")


# ------------------------------------------------------------ paged_cache
def test_append_block_matches_sequential_append_decode_and_jax():
    """A K-token block append lands the payloads and lengths of K
    single-token appends, including a frozen (unmapped) slot whose writes
    drop -- and the JAX ``append_block``'s, bit for bit."""
    rng = np.random.default_rng(0)
    B, K, n_kv, dh, page, pps = 2, 3, 2, 4, 8, 4
    tables = np.full((B, pps), -1, np.int32)
    tables[0] = [0, 1, 2, 3]
    k = rng.standard_normal((B, K, n_kv, dh)).astype(np.float32)
    v = rng.standard_normal((B, K, n_kv, dh)).astype(np.float32)

    def fresh():
        c = tpc.init_paged_cache(B, B * pps, page, pps, n_kv, dh,
                                 torch.float32, device="cpu")
        c = tpc.set_block_tables(c, tables)
        return c._replace(seq_lens=torch.tensor([7, 0], dtype=torch.int32))

    blk = tpc.append_block(fresh(), torch.from_numpy(k), torch.from_numpy(v))
    seq = fresh()
    for i in range(K):
        seq = tpc.append_decode(seq, torch.from_numpy(k[:, i:i + 1]),
                                torch.from_numpy(v[:, i:i + 1]))
    assert torch.equal(blk.k_pool, seq.k_pool)
    assert torch.equal(blk.v_pool, seq.v_pool)
    assert blk.seq_lens.tolist() == seq.seq_lens.tolist() == [10, 0]

    jc = jpc.set_block_tables(jpc.init_paged_cache(
        B, B * pps, page, pps, n_kv, dh, jnp.float32), jnp.asarray(tables))
    jc = jpc.append_block(jc._replace(seq_lens=jnp.asarray([7, 0],
                                                           jnp.int32)),
                          jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(blk.k_pool.numpy(), np.asarray(jc.k_pool))
    np.testing.assert_array_equal(blk.v_pool.numpy(), np.asarray(jc.v_pool))
    np.testing.assert_array_equal(blk.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))


def test_truncate_and_set_seq_len_match_jax():
    lens = np.array([5, 12, 0, 30], np.int32)
    cut = np.array([9, 7, 3, 30], np.int32)
    t = tpc.init_paged_cache(4, 8, 8, 4, 1, 4, torch.float32, device="cpu")
    j = jpc.init_paged_cache(4, 8, 8, 4, 1, 4, jnp.float32)
    t = t._replace(seq_lens=torch.from_numpy(lens.copy()))
    j = j._replace(seq_lens=jnp.asarray(lens))
    t = tpc.set_seq_len(tpc.truncate_seq_lens(t, torch.from_numpy(cut)), 2,
                        6)
    j = jpc.set_seq_len(jpc.truncate_seq_lens(j, jnp.asarray(cut)), 2, 6)
    assert t.seq_lens.tolist() == np.asarray(j.seq_lens).tolist() \
        == [5, 7, 6, 30]
    assert t.seq_lens.dtype == torch.int32


def test_pool_truncate_frees_exactly_past_pages():
    pool = tpc.PagePool(num_pages=8, page_size=8, n_slots=2, pages_per_seq=4)
    assert pool.allocate(0, 20)             # 3 pages
    owned = list(pool.owned[0])
    assert pool.truncate(0, 9) == 1         # 9 tokens -> 2 pages
    assert pool.owned[0] == owned[:2] and pool.lens[0] == 9
    assert owned[2] in pool.free
    assert pool.truncate(0, 8) == 1         # page boundary -> 1 page
    assert pool.truncate(0, 0) == 0         # one page stays mapped
    assert pool.tables[0].tolist() == [owned[0], -1, -1, -1]


def test_pool_namespace_interleavings_match_jax():
    """Seeded allocate / grow / truncate / free interleavings over two
    namespaces give the JAX allocator's results, free list, tables and
    lengths after every operation, and never double-map a page."""
    rng = np.random.default_rng(0)
    pools = [tpc.PagePool(6, 8, 3, 3), jpc.PagePool(6, 8, 3, 3)]
    for _ in range(400):
        op = str(rng.choice(["alloc", "grow", "truncate", "free"]))
        slot = int(rng.integers(0, 3))
        ns = str(rng.choice(["", "draft"]))
        toks = int(rng.integers(0, 40))
        outs = []
        for pool in pools:
            if op == "alloc" and slot not in pool.ns_owned(ns):
                outs.append(pool.allocate(slot, toks, ns=ns))
            elif op == "grow" and slot in pool.ns_owned(ns):
                outs.append(pool.ensure_capacity(slot, toks, ns=ns))
            elif op == "truncate" and slot in pool.ns_owned(ns):
                n = min(toks, int(pool.ns_lens(ns)[slot]))
                outs.append(pool.truncate(slot, n, ns=ns))
            elif op == "free":
                try:
                    outs.append(pool.free_slot(slot))
                except (tpc.PoolError, jpc.PoolError):
                    outs.append("error")
        assert outs[:1] == outs[1:]
        tp, jp = pools
        assert tp.free == jp.free
        for name in ("", "draft"):
            np.testing.assert_array_equal(tp.ns_tables(name),
                                          jp.ns_tables(name))
            np.testing.assert_array_equal(tp.ns_lens(name),
                                          jp.ns_lens(name))
        owned = [p for t in tp.namespaces
                 for pages in tp.ns_owned(t).values() for p in pages]
        assert len(owned) == len(set(owned))
        assert sorted(owned + tp.free) == list(range(6))


# ----------------------------------------------------------- verify_step
def _paged_setup(model, cfg, pol, params, prompts, K):
    """Prefill ``prompts`` into fresh paged caches, one slot each, with
    room for K more tokens (the engine's layout)."""
    slots, page = len(prompts), 8
    pps = -(-(max(len(p) for p in prompts) + K + 1) // page)
    pool = tpc.PagePool(slots * pps, page, slots, pps)
    states = [tpc.init_paged_cache(slots, slots * pps, page, pps, cfg.n_kv,
                                   cfg.head_dim, pol.dtype("kv_cache"),
                                   device="cpu")
              for _ in range(cfg.n_layers)]
    for si, p in enumerate(prompts):
        assert pool.allocate(si, len(p) + K)
    states = [tpc.set_block_tables(s, pool.tables) for s in states]
    for si, p in enumerate(prompts):
        _, states, _ = model.prefill_chunk(
            params, torch.tensor([p], dtype=torch.int32), states,
            [None] * len(states), pol, slot=si, q_offset=0)
    return states


@pytest.mark.parametrize("impl", dispatch.BASE_IMPLS)
@pytest.mark.parametrize("policy_name", ["binary32", "transprecision"])
def test_verify_step_bitidentical_to_sequential_decode(policy_name, impl):
    """The verify entry point IS K decode steps on the plain path: the
    logits of every position and the resulting caches bit for bit."""
    model, cfg = build("llama3-8b", reduced=True)
    pol = get_policy(policy_name, decode_impl=impl)
    params = model.init_params(torch.Generator().manual_seed(0), pol,
                               device="cpu")
    K = 3
    prompts = [_prompts(cfg, 1, 7)[0], _prompts(cfg, 1, 12, seed=1)[0]]
    v = torch.tensor(np.random.default_rng(2).integers(
        0, min(cfg.vocab, 97), (len(prompts), K)), dtype=torch.int32)

    sv = _paged_setup(model, cfg, pol, params, prompts, K)
    seq = []
    for i in range(K):
        lg, sv = model.decode_step(params, v[:, i:i + 1], sv, pol)
        seq.append(lg[:, 0])
    seq = torch.stack(seq, dim=1)
    bv = _paged_setup(model, cfg, pol, params, prompts, K)
    blk, bv = model.verify_step(params, v, bv, pol)

    assert torch.equal(blk.float().view(torch.int32),
                       seq.float().view(torch.int32))
    for a, b in zip(bv, sv):
        assert torch.equal(a.k_pool.view(torch.uint8),
                           b.k_pool.view(torch.uint8))
        assert torch.equal(a.v_pool.view(torch.uint8),
                           b.v_pool.view(torch.uint8))
        assert torch.equal(a.seq_lens, b.seq_lens)


def test_verify_step_needs_paged_caches(served):
    model, cfg, pol, params = served
    states = model.init_state(1, 16, pol, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        model.verify_step(params, torch.zeros((1, 2), dtype=torch.int32),
                          states, pol)


# ------------------------------------------------------- engine exactness
def _run_engine(model, cfg, pol, params, prompts, max_new, *, spec=None,
                **kw):
    reqs = [Request(i, list(p), max_new) for i, p in enumerate(prompts)]
    eng = Engine(model, cfg, pol, params, slots=2, capacity=64, page_size=8,
                 speculative=spec, stats=EngineStats(), device="cpu", **kw)
    eng.run(reqs)
    assert all(r.done and not r.failed for r in reqs)
    return [r.generated for r in reqs], eng.summary


SPEC_CASES = [(f.name, "paged") for f in PAPER_FORMATS] + [
    ("binary32", "xla"), ("binary32", "flash_pallas")]


@pytest.mark.parametrize("kv_fmt,impl", SPEC_CASES,
                         ids=[f"{f}-{i}" for f, i in SPEC_CASES])
def test_speculative_tokens_equal_non_speculative(kv_fmt, impl):
    """Speculative == non-speculative greedy tokens under every paper KV
    format and every base decode backend."""
    model, cfg = build("llama3-8b", reduced=True)
    pol = get_policy("binary32", kv_fmt=kv_fmt, decode_impl=impl)
    params = model.init_params(torch.Generator().manual_seed(0), pol,
                               device="cpu")
    prompts = _prompts(cfg, 3, 16)
    want, _ = _run_engine(model, cfg, pol, params, prompts, 10)
    got, s = _run_engine(model, cfg, pol, params, prompts, 10,
                         spec=_draft(model, cfg))
    assert got == want
    assert s["accept_rate"] is not None and s["accept_rate"] > 0
    assert s["steps_per_token"] < 1.0 and s["spec_rounds"] > 0


def test_unrelated_draft_still_exact(served):
    """A draft with other weights proposes mostly wrong tokens: rounds
    roll back, and the stream is still the non-speculative one."""
    model, cfg, pol, params = served
    prompts = _prompts(cfg, 2, 12)
    want, _ = _run_engine(model, cfg, pol, params, prompts, 8)
    got, s = _run_engine(model, cfg, pol, params, prompts, 8,
                         spec=_draft(model, cfg, seed=1))
    assert got == want and s["accept_rate"] is not None


def test_mid_speculation_eviction_matches_oracle(served):
    """A tight pool forces eviction while a round appends to both
    namespaces: the evicted sequence's draft and target pages come back
    together, it requeues, and the tokens still match the synchronous
    oracle."""
    model, cfg, pol, params = served
    p0 = _prompts(cfg, 1, 7)[0]
    p1 = _prompts(cfg, 1, 40, seed=1)[0]
    oracle = [synchronous_generate(model, cfg, pol, params, [p0], max_new=12,
                                   capacity=96, device="cpu")[0],
              synchronous_generate(model, cfg, pol, params, [p1], max_new=4,
                                   capacity=96, device="cpu")[0]]

    def run(spec, pool_pages):
        reqs = [Request(0, list(p0), 12), Request(1, list(p1), 4)]
        eng = Engine(model, cfg, pol, params, slots=2, capacity=96,
                     page_size=8, pool_pages=pool_pages, speculative=spec,
                     stats=EngineStats(), device="cpu")
        eng.run(reqs)
        assert eng.pool.pages_used == 0
        return [r.generated for r in reqs], sum(r.evictions for r in reqs)

    want, _ = run(None, 24)
    assert want == oracle
    got, evictions = run(_draft(model, cfg), 15)
    assert evictions >= 1
    assert got == oracle


def test_speculative_rejects_vocab_mismatch(served):
    model, cfg, pol, params = served
    bad_cfg = dataclasses.replace(cfg, vocab=cfg.vocab + 1)
    spec = SpeculativeDecoder(model, bad_cfg, _draft_policy(), params, k=2)
    with pytest.raises(ValueError, match="vocab"):
        Engine(model, cfg, pol, params, slots=1, capacity=32, page_size=8,
               speculative=spec, device="cpu")
    with pytest.raises(ValueError, match="speculate-k"):
        SpeculativeDecoder(model, cfg, _draft_policy(), params, k=0)


def test_one_host_transfer_per_round(served, monkeypatch):
    """A speculation round crosses to the host once (targets, emit and
    accept counts, verdicts in one copy), plus once per finished
    prefill."""
    model, cfg, pol, params = served
    calls = []
    real = scheduler._host

    def spy(*t):
        calls.append(len(t))
        return real(*t)

    monkeypatch.setattr(scheduler, "_host", spy)
    reqs = [Request(i, p, 6) for i, p in enumerate(_prompts(cfg, 2, 9))]
    eng = Engine(model, cfg, pol, params, slots=2, capacity=32, page_size=8,
                 speculative=_draft(model, cfg, k=3), stats=EngineStats(),
                 device="cpu")
    eng.run(reqs)
    assert calls.count(4) == eng.decode_steps == eng.stats.spec_rounds
    assert calls.count(2) == len(reqs)          # one per finished prefill
    assert len(calls) == eng.decode_steps + len(reqs)


def test_speculative_tokens_match_jax_engine():
    """The JAX engine and the port's, speculative, on the same target
    (binary32) and draft (binary8 packed) weights carried across: the
    same greedy tokens, which are the non-speculative ones."""
    jmodel, jcfg = jbuild("llama3-8b", reduced=True)
    jpol = jget_policy("binary32", decode_impl="paged")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jpol)
    jdpol = jget_policy("transprecision", decode_impl="paged") \
        .with_overrides(embed_w=JBINARY8, attn_w=JBINARY8, ffn_w=JBINARY8)
    jdparams = jqparams.encode_params(
        jmodel.init_params(jax.random.PRNGKey(0), jdpol), jdpol)
    prompts = _prompts(jcfg, 3, 16)
    jreqs = [JRequest(i, list(p), 8) for i, p in enumerate(prompts)]
    JEngine(jmodel, jcfg, jpol, jparams, slots=2, capacity=64, page_size=8,
            speculative=JSpecDecoder(jmodel, jcfg, jdpol, jdparams, k=3),
            stats=JEngineStats()).run(jreqs)

    model, cfg = build("llama3-8b", reduced=True)
    pol = get_policy("binary32", decode_impl="paged")
    params = params_from_numpy(_to_numpy(jparams), device="cpu")
    dparams = params_from_numpy(_to_numpy(jdparams), device="cpu")
    spec = SpeculativeDecoder(model, cfg, _draft_policy(), dparams, k=3)
    got, _ = _run_engine(model, cfg, pol, params, prompts, 8, spec=spec)
    assert got == [r.generated for r in jreqs]
    want, _ = _run_engine(model, cfg, pol, params, prompts, 8)
    assert got == want
