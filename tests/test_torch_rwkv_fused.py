"""The reference's ``rwkv_fused`` experiment in the port: rwkv6's five
token-shift projections as one wide product (``wrkvg``) and the channel
mix's two as one (``cm_kr``), through the lerp identity
``mix(x, xx, m) @ W = x @ W + (xx - x) @ (m * W)``.

Weights are the reference's ``init_params(PRNGKey(0))`` of reduced
rwkv6-1.6b with ``rwkv_fused=1``, carried across by
``models/convert.py``; inputs are seeded numpy.  Tolerances:

* the port's fused path against its own unfused path on concatenated
  weights: binary32, 1e-5 (the reference's own check,
  ``tests/test_perf_variants.py``); under transprecision the fused path
  rounds ``m * W`` to bf16, so the two are other computations;
* the port's fused modules and model against the reference's fused
  ones: binary32 1e-6 x max(1, max|ref|) for ``time_mix`` /
  ``channel_mix``, 1e-5 for the logits (24 more products deep);
  transprecision (JAX compiled with XLA's excess precision off) 2^-8 x
  max|ref| (a bf16 rounding may land one ulp apart where the summation
  orders differ) and every e5m2 state element equal;
* the engine's tokens equal to the reference engine's (binary32);
* one ``train_loss`` within 1e-5 relative, its gradients within 1e-4 x
  max|g| of ``jax.grad``'s, and the AdamW step on the reference's
  gradients: masters and stored params within 2e-4 x lr of the
  reference's (ROADMAP Queue 3 item 10's gaps).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro.engine import scheduler as jscheduler  # noqa: E402
from repro.models import qparams as jqparams  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.registry import build_from_config  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.engine import Engine, Request  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import qparams, rwkv6  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_model import _close, _f32, to_numpy  # noqa: E402

ARCH = "rwkv6-1.6b"
PROMPT = [3, 17, 42, 7, 99, 1, 64, 23, 5, 88, 12, 30, 2]   # 13: 8 + 5
JIT_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}
_jax_jit = jax.jit


def _jit(f, **kw):
    """jax.jit with every bf16 rounding honoured, at XLA's lowest backend
    optimization level (``tests/test_torch_recurrent.py``'s)."""
    return _jax_jit(f, compiler_options=JIT_OPTIONS, **kw)


def _cfgs():
    return (dataclasses.replace(jget_config(ARCH, reduced=True),
                                rwkv_fused=1),
            dataclasses.replace(configs.get(ARCH, reduced=True),
                                rwkv_fused=1))


@functools.lru_cache(maxsize=None)
def _numpy_params(pol):
    """The reference's fused init, compiled once; under transprecision
    the binary32 draws cast to the reference's dtypes."""
    jcfg, _ = _cfgs()
    jm = build_from_config(jcfg)
    key = jax.random.PRNGKey(0)
    if pol == "binary32":
        return to_numpy(_jit(lambda k: jm.init_params(
            k, jget_policy(pol)))(key))
    shapes = jax.eval_shape(lambda k: jm.init_params(
        k, jget_policy(pol)), key)
    return jax.tree.map(lambda a, sd: np.asarray(jnp.asarray(a).astype(
        sd.dtype)), _numpy_params("binary32"), shapes)


def _jparams(pol):
    return jax.tree.map(jnp.asarray, _numpy_params(pol))


def test_fused_config_and_leaves():
    """``ModelConfig(rwkv_fused=1)`` is accepted; the fused layer holds
    the reference's leaves at its shapes, as many parameters as the
    reference's, ``wrkvg`` under ``attn_w`` and ``cm_kr`` under
    ``ffn_w``, packed to the reference's bytes under transprecision."""
    jcfg, cfg = _cfgs()
    assert cfg.rwkv_fused == 1
    model = Model(cfg)
    pol = get_policy("transprecision")
    params = model.init_params(torch.Generator(), pol, device="meta")
    mix = params["layers"][0]["mix"]
    jmix = _numpy_params("transprecision")["layers"][0]["mix"]
    assert {k: tuple(v.shape) for k, v in mix.items()} == \
        {k: tuple(v.shape) for k, v in jmix.items()}
    d, ff = cfg.d_model, cfg.d_ff
    assert tuple(mix["wrkvg"].shape) == (d, 4 * d + rwkv6.RANK)
    assert tuple(mix["cm_kr"].shape) == (d, ff + d)
    assert qparams.param_role(("layers", 0, "mix", "wrkvg")) == "attn_w"
    assert qparams.param_role(("layers", 0, "mix", "cm_kr")) == "ffn_w"
    tp = params_from_numpy(_numpy_params("transprecision"), device="cpu")
    packed = qparams.encode_params(tp, pol)
    jp = jax.eval_shape(lambda p: jqparams.encode_params(
        p, jget_policy("transprecision")), _jparams("transprecision"))
    assert qparams.packed_bytes(packed) == jqparams.packed_bytes(jp)
    assert isinstance(packed["layers"][0]["mix"]["wrkvg"], qparams.QTensor)
    assert packed["layers"][0]["mix"]["wrkvg"].fmt.name == \
        jp["layers"][0]["mix"]["wrkvg"].fmt.name
    w = packed["layers"][0]["mix"]["cm_kr"]
    assert torch.equal(qparams.as_array(w), w.dequantize())
    assert qparams.as_array(w, torch.bfloat16).dtype == torch.bfloat16
    assert sum(t.numel() for t in leaves(tp)) == jcfg.param_count()


@pytest.mark.parametrize("S,with_state", [(1, True), (16, False),
                                          (13, True)])
def test_lerp_identity_in_the_port(S, with_state):
    """binary32: the fused modules on ``wrkvg = [wr|wk|wv|wg|wd1]`` and
    ``cm_kr = [cm_k|cm_r]`` equal the unfused ones within 1e-5, the
    reference's own check, with and without a carried state."""
    cfg = configs.get(ARCH, reduced=True)
    pol = get_policy("binary32", decode_impl="xla", matmul_impl="xla")
    p = rwkv6.rwkv_init(torch.Generator().manual_seed(0), cfg,
                        torch.float32, device="cpu")
    pf = {k: p[k] for k in ("mu", "wo", "w0", "wd2", "u", "ln_g", "ln_b",
                            "cm_mu", "cm_v")}
    pf["wrkvg"] = torch.cat([p["wr"], p["wk"], p["wv"], p["wg"], p["wd1"]],
                            dim=1)
    pf["cm_kr"] = torch.cat([p["cm_k"], p["cm_r"]], dim=1)
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.normal(size=(2, S, cfg.d_model))
                         .astype(np.float32) * 0.5)
    st = None
    if with_state:
        st = rwkv6.RwkvState(*(torch.from_numpy(
            rng.normal(size=tuple(f.shape)).astype(np.float32) * 0.5)
            for f in rwkv6.rwkv_init_state(cfg, 2, pol, "cpu")))
    for fn in (rwkv6.time_mix, rwkv6.channel_mix):
        (o1, s1), (o2, s2) = fn(p, x, cfg, pol, st), fn(pf, x, cfg, pol, st)
        np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-5,
                                   atol=1e-5)
        if st is not None:
            for a, b in zip(s1, s2):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-5)


MODULE_CASES = [(1, True), (8, False), (13, True)]


def _inputs(pol, S, with_state, seed):
    jcfg, _ = _cfgs()
    jpol = jget_policy(pol)
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, S, jcfg.d_model))
                               .astype(np.float32)).astype(jpol.dtype("act")))
    if not with_state:
        return x, None
    st = jrwkv.rwkv_init_state(jcfg, 2, jpol)
    return x, tuple(np.asarray(jnp.asarray(
        rng.normal(size=f.shape).astype(np.float32) * 0.5).astype(f.dtype))
        for f in st)


@functools.lru_cache(maxsize=None)
def _jax_modules(pol):
    """The reference's fused time mix, then channel mix on its output,
    for every case in one compiled call."""
    jcfg, _ = _cfgs()
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")

    def block(p, x, st):
        st = None if st is None else jrwkv.RwkvState(*st)
        a, st = jrwkv.time_mix(p, x, jcfg, jpol, state=st)
        f, st = jrwkv.channel_mix(p, a, jcfg, jpol, state=st)
        return (a, f), st
    jp = _jparams(pol)["layers"][0]["mix"]
    args = []
    for S, w in MODULE_CASES:
        x, st = _inputs(pol, S, w, seed=S)
        args.append((jnp.asarray(x), None if st is None
                     else tuple(jnp.asarray(f) for f in st)))
    outs = _jit(lambda p, a: [block(p, x, st) for x, st in a])(jp, args)
    return dict(zip(MODULE_CASES, outs))


@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
@pytest.mark.parametrize("S,with_state", MODULE_CASES)
def test_fused_modules_match_reference(S, with_state, pol):
    """The port's fused ``time_mix`` + ``channel_mix`` against the
    reference's on the same numpy weights, inputs and states."""
    _, cfg = _cfgs()
    tpol = get_policy(pol, decode_impl="xla", matmul_impl="xla")
    x, state = _inputs(pol, S, with_state, seed=S)
    jouts, jst = _jax_modules(pol)[(S, with_state)]
    p = params_from_numpy(_numpy_params(pol)["layers"][0]["mix"],
                          device="cpu")
    st = None if state is None else rwkv6.RwkvState(
        *(tensor_from_numpy(f) for f in state))
    a, st = rwkv6.time_mix(p, tensor_from_numpy(x), cfg, tpol, state=st)
    f, st = rwkv6.channel_mix(p, a, cfg, tpol, state=st)
    tol = 1e-6 if pol == "binary32" else 2.0 ** -8
    for got, want in zip((a, f), jouts):
        w = _f32(want)
        _close(got, w, tol * max(1.0, float(np.abs(w).max())))
    assert (st is None) == (jst is None)
    if st is not None:
        for g, w in zip(st, jst):
            w = np.asarray(w)
            if w.dtype.name == "float8_e5m2":
                np.testing.assert_array_equal(
                    g.view(torch.uint8).numpy(), w.view(np.uint8))
            else:
                _close(g, w, tol * max(1.0, float(np.abs(_f32(w)).max())))


@functools.lru_cache(maxsize=None)
def _jax_model(pol):
    """The reference's whole prefill (13 tokens) and a decode step over
    its states, compiled once: (prefill logits, decode logits)."""
    jcfg, _ = _cfgs()
    jm = build_from_config(jcfg)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")
    toks = jnp.asarray([PROMPT], jnp.int32)

    def run(p):
        lp, st = jm.prefill(p, {"tokens": toks}, jpol, 24)
        ld, _ = jm.decode_step(p, jnp.asarray([[PROMPT[-1]]], jnp.int32), st,
                               jpol)
        return lp, ld
    return _jit(run)(_jparams(pol))


@pytest.mark.parametrize("pol,matmul", [("binary32", "xla"),
                                        ("binary32", "qmm_pallas"),
                                        ("transprecision", "xla"),
                                        ("transprecision", "qmm_pallas")])
def test_fused_model_logits_match_reference(pol, matmul):
    """Reduced fused rwkv6: ``prefill`` and ``decode_step`` logits
    against the reference's, on the plain store and on the packed store
    (``qmm_pallas``: ``x @ wrkvg`` on the packed leaf, ``dxx @ wm`` on
    the dequantized and scaled copy)."""
    _, cfg = _cfgs()
    model = Model(cfg)
    tpol = get_policy(pol, decode_impl="xla", matmul_impl=matmul)
    tp = params_from_numpy(_numpy_params(pol), device="cpu")
    if matmul == "qmm_pallas":
        tp = qparams.encode_params(tp, tpol)
    toks = torch.tensor([PROMPT], dtype=torch.int32)
    lp, st = model.prefill(tp, {"tokens": toks}, tpol, 24)
    ld, _ = model.decode_step(tp, torch.tensor([[PROMPT[-1]]]), st, tpol)
    want = _jax_model(pol)
    scale = max(1.0, max(float(np.abs(_f32(w)).max()) for w in want))
    tol = (1e-5 if pol == "binary32" else 2.0 ** -8) * scale
    for g, w in zip((lp, ld), want):
        _close(g, w, tol)
        assert np.isfinite(_f32(g)).all()


def test_fused_engine_matches_reference_engine():
    """binary32, engine against engine: 3 requests of 13 tokens over 2
    slots in chunks of 8 + 5, 5 new tokens; the port serves the packed
    store through ``qmm_pallas``."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, 13).tolist() for _ in range(3)]
    jreqs = [jscheduler.Request(i, list(p), 5) for i, p in enumerate(prompts)]
    try:
        jax.jit = _jit      # the reference's workers compile like _jit
        jscheduler.Engine(build_from_config(jcfg), jcfg,
                          jget_policy("binary32", decode_impl="xla"),
                          _jparams("binary32"), slots=2, capacity=24,
                          page_size=8).run(jreqs)
    finally:
        jax.jit = _jax_jit
    pol = get_policy("binary32", decode_impl="paged",
                     matmul_impl="qmm_pallas")
    params = qparams.encode_params(params_from_numpy(
        _numpy_params("binary32"), device="cpu"), pol)
    reqs = [Request(i, list(p), 5) for i, p in enumerate(prompts)]
    Engine(Model(cfg), cfg, pol, params, slots=2, capacity=24, page_size=8,
           device="cpu").run(reqs)
    assert all(r.done and not r.failed for r in reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_fused_train_step_matches_reference():
    """binary32: ``train_loss`` of the fused config (batch 2 x 16, the
    reference's numpy batch), its gradients (``wrkvg`` gets both terms'
    gradient) and one AdamW step against the reference's."""
    jcfg, cfg = _cfgs()
    jm = build_from_config(jcfg)
    jp, tp = jget_policy("binary32"), get_policy("binary32")
    jparams = _jparams("binary32")
    batch = {k: np.asarray(v) for k, v in SyntheticLM(
        DataConfig(global_batch=2, seq_len=16), jcfg).batch_at(0).items()}

    def jstep(p):
        loss, g = jax.value_and_grad(lambda q: jm.train_loss(q, batch, jp))(p)
        _, st = jadamw.apply(g, jadamw.init(p, jp), jp, lr=1e-3)
        return loss, g, st, jadamw.materialize_params(st, p, jp)
    jloss, jgrads, jst, jnew = _jit(jstep)(jparams)
    model = Model(cfg)
    params = params_from_numpy(_numpy_params("binary32"), device="cpu")
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    loss, grads = loss_and_grads(model, params, tb, tp)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(
            1e-30, float(np.abs(w).max()))
    gw = grads["layers"][0]["mix"]["wrkvg"]
    assert float(gw.abs().max()) > 0
    # AdamW on the reference's gradients: an element whose gradient is
    # near AdamW's eps moves by up to lr with a gradient 1e-4 apart
    jg = params_from_numpy(to_numpy(jgrads), device="cpu")
    _, st = adamw.apply(jg, adamw.init(params, tp), tp, lr=1e-3)
    new = adamw.materialize_params(st, params, tp)
    for a, b in zip(leaves(st.master), jax.tree.leaves(jst.master)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2e-4 * 1e-3
    for a, b in zip(leaves(new), jax.tree.leaves(jnew)):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2e-4 * 1e-3
    assert np.isfinite(float(loss))
