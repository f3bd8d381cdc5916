"""paligemma-3b, the prefix-LM (``vlm``: a gemma decoder over 256 stub
patch embeddings, MQA, gelu FFN, tied head), reduced, against the JAX
package on the CPU.  Weights come from the reference's ``init_params``
(``PRNGKey(0)``) and cross by ``models/convert.params_from_numpy``.

The stub prefix the engines serve is zeros, and a zero row stays zero
through every layer (its norm is 0, so are q, k, v and the FFN), so a
serve exercises the bidirectional prefix only trivially; greedy tokens
on random weights repeat the prompt's last token.  Every check here that
can tell right from wrong therefore compares logits on random, non-zero
prefix embeddings (seeded numpy):

* ``Model.prefill`` and one ``decode_step`` at an explicit capacity:
  binary32 within 1e-5 x max(1, max|logit|) (the tied head multiplies by
  the unit-scale table, scaled by sqrt(d)), transprecision (JAX compiled
  with ``xla_allow_excess_precision`` off) as ``tests/test_torch_model.py``
  holds it: the plain spellings within 1e-5 x max(1, max|logit|), the
  kernel spellings within 2^-8 x max|logit|;
* the engine's route (whole prefill with the default capacity,
  ``write_prefill`` into the pages, a paged ``decode_step``) bit for bit
  the contiguous route (``synchronous_generate``'s) under one decode
  spelling;
* the departure from the reference: its ``prefill(capacity=None)``
  keeps only the tokens' rows of the cache (its engine's path), the
  port keeps the prefix too, as the reference's ``synchronous_generate``
  does.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.engine.reference import \
    synchronous_generate as jsync  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import (ColocatedTransport, Engine,  # noqa: E402
                                Request, StreamedTransport,
                                synchronous_generate)
from repro_torch.engine import worker  # noqa: E402
from repro_torch.kernels import paged_cache  # noqa: E402
from repro_torch.launch.serve import build_draft  # noqa: E402
from repro_torch.models import qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from test_torch_model import _close, _f32, _jit, to_numpy  # noqa: E402

ARCH = "paligemma-3b"
PROMPT = [3, 17, 42, 7, 99, 1, 64, 23, 5, 88, 12]   # 11 tokens
CAP, PAGE = 32, 8        # prefix 8 + 11 tokens + decode, in 4 pages of 8
FIELDS = ("arch", "family", "n_layers", "d_model", "n_heads", "n_kv",
          "d_ff", "vocab", "head_dim", "prefix_len", "rope_theta", "norm",
          "act_fn", "gated_ffn", "tied_embeddings", "embed_scale",
          "use_bias", "moe_experts", "loss_chunks", "attn_pattern",
          "window")


def _prefix(seed=0):
    """Random, non-zero stub patch embeddings (1, P, d), f32."""
    cfg = configs.get(ARCH, reduced=True)
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, cfg.prefix_len, cfg.d_model)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _numpy_params(pol):
    jmodel, _ = jbuild(ARCH, reduced=True)
    return to_numpy(jmodel.init_params(jax.random.PRNGKey(0),
                                       jget_policy(pol)))


def _port(pol, decode_impl="xla", matmul_impl="xla"):
    model, cfg = build(ARCH, reduced=True)
    policy = get_policy(pol, decode_impl=decode_impl,
                        matmul_impl=matmul_impl)
    params = params_from_numpy(_numpy_params(pol), device="cpu")
    if matmul_impl == "qmm_pallas":
        params = qparams.encode_params(params, policy)
    return model, cfg, policy, params


@functools.lru_cache(maxsize=None)
def _jax_logits(pol, capacity=CAP):
    """The reference's prefill and first decode step logits on the
    random prefix, at ``capacity`` (None: the reference's default, the
    tokens' rows), and its cache's shape and ``pos``."""
    jmodel, _ = jbuild(ARCH, reduced=True)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")
    jparams = jax.tree.map(jnp.asarray, _numpy_params(pol))
    batch = {"tokens": jnp.asarray([PROMPT], jnp.int32),
             "prefix_embeds": jnp.asarray(_prefix())}
    prefill = _jit(lambda p, b: jmodel.prefill(p, b, jpol, capacity))
    decode = _jit(lambda p, t, s: jmodel.decode_step(p, t, s, jpol))
    lp, st = prefill(jparams, batch)
    ld, _ = decode(jparams, jnp.asarray([[PROMPT[-1]]], jnp.int32), st)
    return (_f32(lp), _f32(ld)), (tuple(st[0].k.shape), int(st[0].pos))


def _batch(prefix):
    return {"tokens": torch.tensor([PROMPT], dtype=torch.int32),
            "prefix_embeds": torch.from_numpy(prefix)}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_is_the_references(reduced):
    """Field for field the reference's config, the same ``param_count``
    (2,508,662,784 at full size), and the reduced init holds exactly that
    many parameters."""
    assert configs.ARCHS[6] == ARCH
    want = jget_config(ARCH, reduced=reduced)
    got = configs.get(ARCH, reduced=reduced)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.param_count() == want.param_count()
    if not reduced:
        assert got.param_count() == 2_508_662_784
        return
    model, cfg = build(ARCH, reduced=True)
    params = model.init_params(torch.Generator().manual_seed(0),
                               get_policy("binary32"), device="cpu")
    assert "head" not in params      # tied: the reference's tree
    assert sum(t.numel() for t in qparams.tree_leaves(params)) \
        == cfg.param_count()
    assert qparams.tree_leaves(params_from_numpy(
        _numpy_params("binary32"), device="cpu"))[0].shape \
        == (cfg.vocab, cfg.d_model)


@pytest.mark.parametrize("pol,spell", [
    ("binary32", ("xla", "xla")), ("binary32", ("paged", "qmm_pallas")),
    ("transprecision", ("xla", "xla")),
    ("transprecision", ("paged", "qmm_pallas"))],
    ids=["binary32-plain", "binary32-kernel", "transprecision-plain",
         "transprecision-kernel"])
def test_prefix_logits_match_jax(pol, spell):
    """Prefill over a random prefix and one decode step at capacity
    ``CAP``, against the reference's ``xla`` spellings.  The kernel
    spellings' whole prefill attends over the unrounded K/V as the
    reference's ``xla`` prefill does; their decode reads the binary8
    cache as the reference's ``xla`` decode does."""
    want, _ = _jax_logits(pol)
    model, cfg, policy, params = _port(pol, *spell)
    lp, st = model.prefill(params, _batch(_prefix()), policy, CAP)
    ld, _ = model.decode_step(params, torch.tensor([[PROMPT[-1]]]), st,
                              policy)
    assert st[0].k.shape[1] == CAP
    assert st[0].pos == cfg.prefix_len + len(PROMPT)
    scale = max(float(np.abs(w).max()) for w in want)
    tol = (2.0 ** -8 * scale if pol == "transprecision"
           and spell[0] != "xla" else 1e-5 * max(1.0, scale))
    for got, w in zip((lp, ld), want):
        _close(got, w, tol)
        assert np.isfinite(_f32(got)).all()


def test_prefix_reaches_every_layer():
    """The logits on the random prefix differ from those on the zero
    prefix the engines serve, and from those on no prefix at all."""
    model, cfg, policy, params = _port("binary32")
    outs = []
    for prefix in (_prefix(), np.zeros_like(_prefix()), None):
        batch = _batch(prefix) if prefix is not None else \
            {"tokens": torch.tensor([PROMPT], dtype=torch.int32)}
        lp, _ = model.prefill(params, batch, policy, CAP)
        outs.append(lp)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2
    assert float((outs[1] - outs[2]).abs().max()) > 1e-2


def _paged_states(cfg, policy, slots=1):
    pps = CAP // PAGE
    tables = np.arange(slots * pps, dtype=np.int32).reshape(slots, pps)
    return [paged_cache.set_block_tables(paged_cache.init_paged_cache(
        slots, slots * pps, PAGE, pps, cfg.n_kv, cfg.head_dim,
        policy.dtype("kv_cache", layer=li), device="cpu"), tables)
        for li in range(cfg.n_layers)]


@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
@pytest.mark.parametrize("dec", ["paged", "flash_pallas"])
def test_engine_route_equals_contiguous_route(pol, dec):
    """The engine's route -- ``prefill`` at its default capacity (the
    prefix and prompt rows), ``write_prefill`` of every row into the
    slot's pages, a paged ``decode_step`` -- bit for bit the contiguous
    route ``synchronous_generate`` takes (``prefill`` at ``CAP``, a
    contiguous ``decode_step``), under one decode spelling and
    ``qmm_pallas``.  Both read ``CAP`` positions (4 pages of 8; the
    contiguous cache as one ``CAP``-row page), so the attention sums
    alike.  The slot's length after prefill is prefix + prompt, and the
    first decode token ropes at that position."""
    model, cfg, policy, params = _port(pol, dec, "qmm_pallas")
    batch = _batch(_prefix())
    rows = cfg.prefix_len + len(PROMPT)
    lp, one = model.prefill(params, batch, policy, None)
    assert [c.k.shape[1] for c in one] == [rows] * cfg.n_layers
    states = [paged_cache.write_prefill(s, 0, c.k[0], c.v[0])
              for s, c in zip(_paged_states(cfg, policy), one)]
    assert all(int(s.seq_lens[0]) == rows for s in states)
    tok = torch.tensor([[PROMPT[-1]]], dtype=torch.int32)
    ld, states = model.decode_step(params, tok, states, policy)
    assert all(int(s.seq_lens[0]) == rows + 1 for s in states)

    cp, cst = model.prefill(params, batch, policy, CAP)
    cd, cst = model.decode_step(params, tok, cst, policy)
    assert cst[0].pos == rows + 1
    assert torch.equal(lp, cp)
    assert torch.equal(ld, cd)


def _serve(pol, transport, reqs):
    """An engine serve of ``reqs`` over 2 slots, whole-prompt prefill
    forced by the prefix; returns (tokens, each request's slot length
    right after its prefill)."""
    model, cfg, policy, params = _port(pol, "paged", "qmm_pallas")
    lens = []
    real = worker.PrefillWorker._whole_step

    def whole(self, task, view, slot):
        view = real(self, task, view, slot)
        lens.append(int(view[0].seq_lens[slot]))
        return view
    worker.PrefillWorker._whole_step = whole
    try:
        eng = Engine(model, cfg, policy, params, slots=2, capacity=CAP,
                     page_size=PAGE, transport=transport, device="cpu")
        eng.run(reqs)
    finally:
        worker.PrefillWorker._whole_step = real
    assert all(w.chunked is False for w in eng.prefill_workers)
    return [r.generated for r in reqs], lens


@pytest.mark.parametrize("transport", ["colocated", "streamed"])
def test_engine_tokens_equal_synchronous_generate(transport):
    """binary32: an engine serve's greedy tokens equal the port's and
    the reference's ``synchronous_generate`` (zero prefix, capacity
    ``CAP``), and every slot's length after prefill is prefix + prompt
    (with the streamed transport, the length its handoff publishes)."""
    prompts = [PROMPT, PROMPT[:5], [9, 8, 7, 6, 5, 4, 3]]
    reqs = [Request(i, list(p), 4) for i, p in enumerate(prompts)]
    tr = ColocatedTransport() if transport == "colocated" \
        else StreamedTransport()
    got, lens = _serve("binary32", tr, reqs)
    model, cfg, policy, params = _port("binary32", "paged", "qmm_pallas")
    assert sorted(lens) == sorted(cfg.prefix_len + len(p) for p in prompts)
    port = synchronous_generate(model, cfg, policy, params, prompts,
                                max_new=4, capacity=CAP, device="cpu")
    jmodel, jcfg = jbuild(ARCH, reduced=True)
    ref = jsync(jmodel, jcfg, jget_policy("binary32", decode_impl="xla"),
                jax.tree.map(jnp.asarray, _numpy_params("binary32")),
                prompts, max_new=4, capacity=CAP)
    assert got == port == ref


def test_reference_prefill_drops_the_prefix():
    """The pinned departure: the reference's ``prefill(capacity=None)``
    -- its engine's whole-prompt prefill -- returns a cache of the
    tokens' rows only, at ``pos`` prefix + tokens (the ring keeps the
    last ``len(prompt)`` rows, so decode attends without the prefix),
    and its first decode step's logits differ from those at a capacity
    that keeps the prefix.  The port's default keeps every row, and the
    engine's route over them (``write_prefill``, a paged decode step)
    gives the reference's decode logits at the explicit capacity."""
    cfg = configs.get(ARCH, reduced=True)
    rows = cfg.prefix_len + len(PROMPT)
    (_, ld_none), (shape, pos) = _jax_logits("binary32", None)
    (_, ld_cap), _ = _jax_logits("binary32")
    assert shape == (1, len(PROMPT), cfg.n_kv, cfg.head_dim)
    assert pos == rows
    assert float(np.abs(ld_none - ld_cap).max()) > 1e-2

    model, cfg, policy, params = _port("binary32", "paged")
    _, one = model.prefill(params, _batch(_prefix()), policy, None)
    assert one[0].k.shape[1] == rows and one[0].pos == rows
    states = [paged_cache.write_prefill(s, 0, c.k[0], c.v[0])
              for s, c in zip(_paged_states(cfg, policy), one)]
    ld, _ = model.decode_step(params, torch.tensor([[PROMPT[-1]]]), states,
                              policy)
    scale = max(1.0, float(np.abs(ld_cap).max()))
    _close(ld, ld_cap, 1e-5 * scale)


def _refuse_speculative(model, cfg, policy, params):
    Engine(model, cfg, policy, params, slots=2, capacity=CAP,
           page_size=PAGE, device="cpu",
           speculative=build_draft(model, cfg, k=2, device="cpu"))


def _refuse_chunk(model, cfg, policy, params):
    model.prefill_chunk(params, torch.tensor([PROMPT], dtype=torch.int32),
                        _paged_states(cfg, policy), [None] * cfg.n_layers,
                        policy, slot=0, q_offset=0)


def _refuse_verify(model, cfg, policy, params):
    model.verify_step(params, torch.tensor([PROMPT[:2]], dtype=torch.int32),
                      _paged_states(cfg, policy), policy)


@pytest.mark.parametrize("call", [_refuse_speculative, _refuse_chunk,
                                  _refuse_verify],
                         ids=["SpeculativeDecoder", "prefill_chunk",
                              "verify_step"])
def test_prefix_lm_refusals(call):
    """What the prefix-LM does not take, as in the reference: chunked
    prefill, the verify step and speculation (prefix context cannot roll
    back)."""
    with pytest.raises(ValueError, match="prefix"):
        call(*_port("binary32", "paged"))
