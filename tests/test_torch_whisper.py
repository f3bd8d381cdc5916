"""whisper-tiny, the encoder-decoder (``audio``: a 4 + 4 layer
transformer over 1500 stub frame embeddings, biases, layernorm, an
ungated gelu FFN, no rope, an untied head), reduced (2 + 2 layers, d 64,
30 frames, vocab 256), against the JAX package on the CPU.  Weights come
from the reference's ``init_params`` (``PRNGKey(0)``) and cross by
``models/convert.params_from_numpy``.

The stub frames the engines serve are zeros, and zeros make the encoder
output zero (layernorm with beta 0, then zero attention, then gelu(0 +
0)), so every cross attention adds nothing and a serve is a decoder-only
LM.  The biases and the norms' betas are zero at init too.  Every check
here that can tell right from wrong therefore runs on random encoder
embeddings (normal, 0.02 scale) and random biases, gammas and betas
(seeded numpy), written into the reference's tree before it crosses:

* ``_encode`` and ``mha`` alone (the encoder's non-causal self-attention
  and a decoder layer's cross attention over a random encoder output);
* ``prefill`` (logits and the caches' payloads) and four
  ``decode_step(encoder_embeds=)`` calls under the spellings ``xla``,
  ``flash_pallas`` + ``qmm_pallas`` and ``paged`` + ``qmm_pallas`` (their
  plain versions on the CPU), against the reference under the same
  decode spelling (its Pallas kernels in interpret mode: the flash
  kernels do not round the probabilities to ``attn_probs`` as the
  ``xla`` spelling does) and the ``xla`` matmul, compiled with XLA's
  excess precision off (``tests/test_torch_model.py``): within 1e-5 x
  max|logit| under binary32, 2^-8 x max|logit| under transprecision
  (measured: 2.4e-7 of 3.33 in every case);
* ``decode_step(enc_out=)`` bit for bit ``decode_step(encoder_embeds=)``.

Also: the port's ``synchronous_generate`` passes the prefill's zero
frames to every decode step, as the reference's ``ServeTuner`` does; the
reference's own loop passes none and fails on ``None.astype`` (the
departure, pinned); ``ServeTuner`` on reduced whisper against the
reference's; the packed store's per-layer formats; the refusals.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget_config  # noqa: E402
from repro.core.formats import BINARY8 as JBINARY8  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.engine.reference import \
    synchronous_generate as jsync  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import qparams as jqparams  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.formats import BINARY8  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.engine import Engine, synchronous_generate  # noqa: E402
from repro_torch.engine import worker  # noqa: E402
from repro_torch.kernels import paged_cache  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.tuning import ServeTuner, synthetic_calibration  # noqa
from test_torch_model import _close, _f32, _jit, to_numpy  # noqa: E402
from test_torch_serve_tuner import (_child_result,  # noqa: E402
                                    _reference_weights, _start_child)

ARCH = "whisper-tiny"
PROMPT = [3, 17, 42, 7, 99, 1, 64, 23, 5, 88, 12]   # 11 tokens
NEXT = [5, 200, 31, 77]                             # 4 decode tokens
CAP = 16
FIELDS = ("arch", "family", "n_layers", "d_model", "n_heads", "n_kv",
          "d_ff", "vocab", "head_dim", "encoder_layers", "encoder_len",
          "rope_theta", "norm", "act_fn", "gated_ffn", "tied_embeddings",
          "embed_scale", "use_bias", "prefix_len", "loss_chunks",
          "attn_pattern", "window")
SPELLS = (("xla", "xla"), ("flash_pallas", "qmm_pallas"),
          ("paged", "qmm_pallas"))
RANDOM = {"b_in": (0.0, 0.1), "b_out": (0.0, 0.1), "gamma": (1.0, 0.1),
          "beta": (0.0, 0.1)}


def _tol(pol, scale):
    return (2.0 ** -8 if pol == "transprecision" else 1e-5) * scale


def _dtypes(pol):
    """The activation dtype of ``pol`` in torch and in JAX."""
    return ((torch.float32, jnp.float32) if pol == "binary32"
            else (torch.bfloat16, jnp.bfloat16))


def _embeds(seed=0):
    """Random stub frame embeddings (1, T, d), f32, 0.02 scale."""
    cfg = configs.get(ARCH, reduced=True)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, cfg.encoder_len, cfg.d_model))
            * 0.02).astype(np.float32)


def _randomize(tree, rng):
    """The biases, gammas and betas of a numpy tree drawn anew (mean,
    scale of ``RANDOM``), in each leaf's own dtype."""
    if isinstance(tree, dict):
        return {k: (np.asarray(jnp.asarray(
            RANDOM[k][0] + RANDOM[k][1] * rng.normal(size=v.shape),
            v.dtype)) if k in RANDOM else _randomize(v, rng))
            for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    return tree


@functools.lru_cache(maxsize=None)
def _numpy_params(pol):
    jmodel, _ = jbuild(ARCH, reduced=True)
    tree = to_numpy(jmodel.init_params(jax.random.PRNGKey(0),
                                       jget_policy(pol)))
    return _randomize(tree, np.random.default_rng(7))


def _jparams(pol):
    return jax.tree.map(jnp.asarray, _numpy_params(pol))


def _port(pol, decode_impl="xla", matmul_impl="xla"):
    model, cfg = build(ARCH, reduced=True)
    policy = get_policy(pol, decode_impl=decode_impl,
                        matmul_impl=matmul_impl)
    params = params_from_numpy(_numpy_params(pol), device="cpu")
    if matmul_impl == "qmm_pallas":
        params = qparams.encode_params(params, policy)
    return model, cfg, policy, params


_TORCH_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_NP_INT = {1: np.uint8, 2: np.int16, 4: np.int32}


def _cache_bits(states):
    """(k, v) of every layer's contiguous cache as the integers of the
    payloads' width (either package's tensors)."""
    out = []
    for s in states:
        for t in (s.k, s.v):
            if isinstance(t, torch.Tensor):
                a = t.contiguous().view(_TORCH_INT[t.element_size()]).numpy()
            else:
                a = np.asarray(t)
                a = a.view(_NP_INT[a.dtype.itemsize])
            out.append(a.astype(np.int64))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(pol, dec):
    """The reference's prefill logits and cache bits, and its logits of
    four ``decode_step(encoder_embeds=)`` calls, on random frames, under
    the decode spelling ``dec`` (its Pallas kernels in interpret mode)
    and the ``xla`` matmul."""
    jmodel, _ = jbuild(ARCH, reduced=True)
    jpol = jget_policy(pol, decode_impl=dec, matmul_impl="xla")
    emb = jnp.asarray(_embeds())
    prefill = _jit(lambda p, b: jmodel.prefill(p, b, jpol, CAP))
    decode = _jit(lambda p, t, s, e: jmodel.decode_step(
        p, t, s, jpol, encoder_embeds=e))
    params = _jparams(pol)
    lp, st = prefill(params, {"tokens": jnp.asarray([PROMPT], jnp.int32),
                              "encoder_embeds": emb})
    bits = _cache_bits(st)
    logits = [_f32(lp)]
    for t in NEXT:
        ld, st = decode(params, jnp.asarray([[t]], jnp.int32), st, emb)
        logits.append(_f32(ld))
    return logits, bits


def _batch(emb):
    return {"tokens": torch.tensor([PROMPT], dtype=torch.int32),
            "encoder_embeds": torch.from_numpy(emb)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_is_the_references(reduced):
    """Field for field the reference's config, the same ``param_count``
    (56,378,880 at full size: the encoder's blocks and the decoder's
    cross attention included), and the reduced init holds exactly that
    many parameters, in the reference's tree."""
    assert configs.ARCHS[9:] == (ARCH,)
    want = jget_config(ARCH, reduced=reduced)
    got = configs.get(ARCH, reduced=reduced)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.param_count() == want.param_count()
    if not reduced:
        assert got.param_count() == 56_378_880
        return
    model, cfg = build(ARCH, reduced=True)
    params = model.init_params(torch.Generator().manual_seed(0),
                               get_policy("binary32"), device="cpu")
    assert sum(t.numel() for t in qparams.tree_leaves(params)) \
        == cfg.param_count()
    ref = _numpy_params("binary32")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(params) == shapes(ref)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
def test_encode_matches_jax(pol):
    """``_encode`` on random frames: the encoder's blocks (non-causal
    self-attention, the biased gelu FFN) and no final norm."""
    jmodel, _ = jbuild(ARCH, reduced=True)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")
    model, cfg, policy, params = _port(pol)
    dt, jdt = _dtypes(pol)
    emb = _embeds(1)
    want = _jit(lambda p, e: jmodel._encode(p, e, jpol))(
        _jparams(pol), jnp.asarray(emb).astype(jdt))
    got = model._encode(params, torch.from_numpy(emb).to(dt), policy)
    assert got.dtype == dt and got.shape == (1, cfg.encoder_len,
                                             cfg.d_model)
    _close(got, want, _tol(pol, float(np.abs(_f32(want)).max())))


@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
@pytest.mark.parametrize("kind", ["cross", "encoder"])
def test_mha_non_causal_matches_jax(pol, kind):
    """``mha`` alone: a decoder layer's cross attention (``kv_source``,
    5 query rows over 30 source rows) and the encoder's self-attention
    (``causal=False``), plain torch over unrounded K/V as the reference's
    XLA branch; neither returns a cache."""
    _, jcfg = jbuild(ARCH, reduced=True)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")
    _, cfg, policy, params = _port(pol)
    rng = np.random.default_rng(3)
    dt, jdt = _dtypes(pol)
    S = 5 if kind == "cross" else cfg.encoder_len
    x = rng.normal(size=(1, S, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(1, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    path = ("layers", 1, "xattn") if kind == "cross" \
        else ("encoder", 1, "mix")
    tp, jp = params, _jparams(pol)
    for k in path:
        tp, jp = tp[k], jp[k]
    if kind == "cross":
        want, wcache = _jit(lambda p, xx, ss: jattn.mha(
            p, xx, jcfg, jpol, kv_source=ss))(
            jp, jnp.asarray(x).astype(jdt), jnp.asarray(src).astype(jdt))
        tkw = {"kv_source": torch.from_numpy(src).to(dt)}
    else:
        want, wcache = _jit(lambda p, xx: jattn.mha(
            p, xx, jcfg, jpol, causal=False))(jp, jnp.asarray(x).astype(jdt))
        tkw = {"causal": False}
    got, cache = tattn.mha(tp, torch.from_numpy(x).to(dt), cfg, policy,
                           **tkw)
    assert cache is None and wcache is None
    _close(got, want, _tol(pol, float(np.abs(_f32(want)).max())))
    with pytest.raises(ValueError, match="no KV cache"):
        tattn.mha(tp, torch.from_numpy(x).to(dt), cfg, policy,
                  cache_capacity=CAP, **tkw)


# ---------------------------------------------------------------------------
# the model's serving entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spell", SPELLS,
                         ids=["-".join(s) for s in SPELLS])
@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
def test_logits_and_cache_match_jax(pol, spell):
    """``prefill`` on random frames at capacity ``CAP`` and four
    ``decode_step(encoder_embeds=)`` calls against the reference under
    the same decode spelling: logits at the stated tolerance; the
    caches: binary32's f32 K/V within 1e-5 x their max (the two f32
    projections sum in another order), transprecision's e5m2 payloads
    bit for bit the reference's (the bf16 and e5m2 roundings absorb
    that order); and ``enc_out=`` gives ``encoder_embeds=``'s logits bit
    for bit."""
    want, want_bits = _jax_run(pol, spell[0])
    model, cfg, policy, params = _port(pol, *spell)
    emb = torch.from_numpy(_embeds())
    lp, st = model.prefill(params, _batch(_embeds()), policy, CAP)
    got_bits = _cache_bits(st)
    enc = model._encode(params, emb.to(_dtypes(pol)[0]), policy)
    logits, st_e = [lp], st
    for t in NEXT:
        tok = torch.tensor([[t]], dtype=torch.int32)
        ld, st = model.decode_step(params, tok, st, policy,
                                   encoder_embeds=emb)
        le, st_e = model.decode_step(params, tok, st_e, policy,
                                     enc_out=enc)
        assert torch.equal(ld, le)
        logits.append(ld)
    scale = max(float(np.abs(w).max()) for w in want)
    for got, w in zip(logits, want):
        _close(got, w, _tol(pol, scale))
        assert np.isfinite(_f32(got)).all()
    for g, w in zip(got_bits, want_bits):
        if pol == "binary32":
            g, w = (a.astype(np.int32).view(np.float32) for a in (g, w))
            _close(g, w, 1e-5 * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g, w)


def test_decode_step_needs_encoder_context():
    """An enc-dec ``decode_step`` with neither ``enc_out`` nor
    ``encoder_embeds`` raises a ``ValueError`` naming them (the
    reference fails on ``None.astype``)."""
    model, cfg, policy, params = _port("binary32")
    _, st = model.prefill(params, _batch(_embeds()), policy, CAP)
    with pytest.raises(ValueError, match="encoder_embeds"):
        model.decode_step(params, torch.tensor([[1]]), st, policy)


def test_frames_reach_every_layer():
    """The logits on random frames differ from those on the zero frames
    the engines serve; zero frames give a zero encoder output when the
    biases and betas are zero (the reference's init)."""
    model, cfg, policy, params = _port("binary32")
    outs = [model.prefill(params, _batch(e), policy, CAP)[0]
            for e in (_embeds(), np.zeros_like(_embeds()))]
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2
    init = model.init_params(torch.Generator().manual_seed(0), policy,
                             device="cpu")
    zero = model._encode(init, torch.zeros(1, cfg.encoder_len, cfg.d_model),
                         policy)
    assert not zero.any()


@pytest.mark.parametrize("dec", ["xla", "paged"])
def test_synchronous_generate_tokens_match_reference_loop(dec):
    """binary32: the port's ``synchronous_generate`` (zero frames to the
    prefill and to every decode step) gives the greedy tokens of the
    reference's ``prefill`` + ``decode_step(encoder_embeds=)`` loop."""
    prompts = [PROMPT, PROMPT[:5], [9, 8, 7, 6, 5, 4, 3]]
    model, cfg, policy, params = _port("binary32", dec, "qmm_pallas")
    got = synchronous_generate(model, cfg, policy, params, prompts,
                               max_new=5, capacity=CAP, device="cpu")
    jmodel, _ = jbuild(ARCH, reduced=True)
    jpol = jget_policy("binary32", decode_impl="xla")
    jparams = _jparams("binary32")
    zeros = jnp.zeros((1, cfg.encoder_len, cfg.d_model), jnp.float32)
    prefill = _jit(lambda p, b: jmodel.prefill(p, b, jpol, CAP))
    decode = _jit(lambda p, t, s: jmodel.decode_step(
        p, t, s, jpol, encoder_embeds=zeros))
    want = []
    for prompt in prompts:
        lg, st = prefill(jparams, {"tokens": jnp.asarray([prompt],
                                                         jnp.int32),
                                   "encoder_embeds": zeros})
        toks = [int(jnp.argmax(lg[0, -1]))]
        while len(toks) < 5:
            lg, st = decode(jparams, jnp.asarray([[toks[-1]]], jnp.int32),
                            st)
            toks.append(int(jnp.argmax(lg[0, -1])))
        want.append(toks)
    assert got == want
    assert all(len(t) == 5 for t in got)


def test_reference_synchronous_generate_fails_on_whisper():
    """The departure's witness: the reference's ``synchronous_generate``
    passes no ``encoder_embeds`` to its decode steps, and whisper's
    ``decode_step`` reads ``encoder_embeds.astype``; a single token (no
    decode step) still comes out."""
    jmodel, jcfg = jbuild(ARCH, reduced=True)
    jpol = jget_policy("binary32", decode_impl="xla")
    args = (jmodel, jcfg, jpol, _jparams("binary32"), [PROMPT[:4]])
    assert len(jsync(*args, max_new=1, capacity=CAP)[0]) == 1
    with pytest.raises(AttributeError, match="astype"):
        jsync(*args, max_new=2, capacity=CAP)


def test_packed_store_layer_formats_match_reference():
    """``encode_params`` under a policy that binds layer 1's attention
    and FFN weights to binary8: the encoder's weights take the global
    formats (its leaves have no decoder layer), layer 1's ``xattn`` its
    layer's; the biases, gammas and betas stay plain; every payload
    equals the reference's packed store bit for bit."""
    over = {"layers.1.attn_w": "binary8", "layers.1.ffn_w": "binary8"}
    jpol = jget_policy("transprecision").with_overrides(**{
        k: JBINARY8 for k in over})
    tpol = get_policy("transprecision").with_overrides(**{
        k: BINARY8 for k in over})
    jmodel, _ = jbuild(ARCH, reduced=True)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jpol)
    want = params_from_numpy(to_numpy(jqparams.encode_params(jp, jpol)),
                             device="cpu")
    got = qparams.encode_params(params_from_numpy(to_numpy(jp),
                                                  device="cpu"), tpol)
    fmts = {}

    def walk(g, w, path=()):
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            for k in g:
                walk(g[k], w[k], path + (k,))
        elif isinstance(g, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, path + (i,))
        elif isinstance(g, QTensor):
            assert isinstance(w, QTensor) and g.fmt.name == w.fmt.name
            assert torch.equal(g.payload, w.payload)
            fmts[path] = g.fmt.name
        else:
            assert not isinstance(w, QTensor)
            assert torch.equal(g, w)
    walk(got, want)
    assert fmts[("encoder", 1, "mix", "wq")] == "binary16alt"
    assert fmts[("encoder", 1, "ffn", "w_in")] == "binary16alt"
    assert fmts[("layers", 1, "xattn", "wk")] == "binary8"
    assert fmts[("layers", 1, "ffn", "w_out")] == "binary8"
    assert fmts[("layers", 0, "xattn", "wk")] == "binary16alt"
    assert not isinstance(got["layers"][1]["ffn"]["b_in"], QTensor)
    assert qparams.param_layer(("encoder", 1, "mix", "wq")) is None
    assert qparams.param_layer(("layers", 1, "xattn", "wq")) == 1


# ---------------------------------------------------------------------------
# the serve-time tuner
# ---------------------------------------------------------------------------

_REF_WHISPER_TUNER = """
import os
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import json
from repro.models.registry import build
from repro.tuning import ServeTuner, synthetic_calibration
model, cfg = build("whisper-tiny", reduced=True)
sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=2, prompt_len=8)
tuner = ServeTuner(model, cfg, sets, eps=0.2, decode_steps=2, kv_groups=2,
                   max_rounds=1)
res = tuner.run()
print("REF_WHISPER_TUNER " + json.dumps({
    "variables": list(tuner.variables),
    "formats": {k: f.name for k, f in res.formats.items()},
    "n_evals": res.n_evals, "final_kl": res.final_kl,
    "bytes": [res.weight_bytes, res.weight_bytes_f32,
              res.kv_bytes_per_token, res.kv_bytes_per_token_f32]}))
"""


@pytest.fixture(scope="module", autouse=True)
def ref_tuner():
    """The reference's ``ServeTuner`` run, started in a child when the
    module's first test starts, so that its ~40 s of compiles run beside
    the other tests."""
    child = _start_child(_REF_WHISPER_TUNER)
    yield child
    child.kill()
    child.communicate()


def test_serve_tuner_matches_reference(ref_tuner):
    """``ServeTuner`` on reduced whisper (1 set x 2 prompts x 8 tokens,
    2 decode positions, 2 KV groups over the 2 decoder layers, 1 round,
    eps 0.2) with the reference's weights: the same variables, the same
    per-variable formats and ``n_evals``, the same byte counts (the
    encoder's weights included), and the KL within 20 % relative and
    under eps (``tests/test_torch_serve_tuner.py`` says why)."""
    model, cfg = build(ARCH, reduced=True)
    jmodel, _ = jbuild(ARCH, reduced=True)
    sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=2,
                                 prompt_len=8)
    tuner = ServeTuner(model, cfg, sets, eps=0.2, decode_steps=2,
                       kv_groups=2, max_rounds=1, device="cpu",
                       params_for=_reference_weights(jmodel))
    res = tuner.run()
    want = _child_result(ref_tuner, "REF_WHISPER_TUNER", 300)
    assert list(tuner.variables) == want["variables"]
    assert "attn_probs" in tuner.variables
    assert {k: f.name for k, f in res.formats.items()} == want["formats"]
    assert res.n_evals == want["n_evals"]
    assert res.final_kl == pytest.approx(want["final_kl"], rel=0.2, abs=0)
    assert res.final_kl <= 0.2
    assert [res.weight_bytes, res.weight_bytes_f32, res.kv_bytes_per_token,
            res.kv_bytes_per_token_f32] == want["bytes"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refuse_engine(model, cfg, policy, params):
    Engine(model, cfg, policy, params, slots=2, capacity=CAP, page_size=8,
           device="cpu")


def _refuse_serve(model, cfg, policy, params):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "1", "--slots", "1", "--prompt-len", "4",
                "--max-new", "2", "--capacity", str(CAP), "--page-size",
                "8"])


def _refuse_speculative(model, cfg, policy, params):
    lmodel, lcfg = build("llama3-8b", reduced=True)
    lpol = get_policy("binary32", decode_impl="paged")
    lparams = lmodel.init_params(torch.Generator().manual_seed(0), lpol,
                                 device="cpu")
    Engine(lmodel, lcfg, lpol, lparams, slots=2, capacity=CAP, page_size=8,
           device="cpu", speculative=serve.build_draft(
               lmodel, lcfg, arch=ARCH, reduced=True, k=2, device="cpu"))


def _paged_states(cfg, policy):
    return [paged_cache.set_block_tables(paged_cache.init_paged_cache(
        1, 2, 8, 2, cfg.n_kv, cfg.head_dim, policy.dtype("kv_cache"),
        device="cpu"), np.arange(2, dtype=np.int32)[None])
        for _ in range(cfg.n_layers)]


def _refuse_chunk(model, cfg, policy, params):
    model.prefill_chunk(params, torch.tensor([PROMPT[:4]], dtype=torch.int32),
                        _paged_states(cfg, policy), [None] * cfg.n_layers,
                        policy, slot=0, q_offset=0)


def _refuse_verify(model, cfg, policy, params):
    model.verify_step(params, torch.tensor([PROMPT[:2]], dtype=torch.int32),
                      _paged_states(cfg, policy), policy)


@pytest.mark.parametrize("call,match", [
    (_refuse_engine, "serving engine is decoder-only"),
    (_refuse_serve, "serving engine is decoder-only"),
    (_refuse_speculative, "draft arch whisper-tiny is not decoder-only"),
    (_refuse_chunk, "prefill_chunk is decoder-only"),
    (_refuse_verify, "verify_step is decoder-only")],
    ids=["Engine", "serve", "SpeculativeDecoder", "prefill_chunk",
         "verify_step"])
def test_enc_dec_refusals(call, match):
    """What the enc-dec config does not take, with the reference's
    messages: the paged engine (and so the serve CLI), speculation,
    chunked prefill and the verify step."""
    with pytest.raises(ValueError, match=match):
        call(*_port("binary32", "paged"))


def test_make_batch_gives_zero_frames():
    """The engine worker's batch (the synchronous loop's) carries
    ``encoder_len`` zero f32 frames, as the reference's."""
    cfg = configs.get(ARCH, reduced=True)
    b = worker.make_batch(cfg, PROMPT[:3], "cpu")
    assert b["encoder_embeds"].shape == (1, cfg.encoder_len, cfg.d_model)
    assert b["encoder_embeds"].dtype == torch.float32
    assert not b["encoder_embeds"].any()
