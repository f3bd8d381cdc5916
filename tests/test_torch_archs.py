"""The ninth slice's configs -- yi-9b, mistral-nemo-12b, command-r-35b
(layernorm, tied head), granite-moe-1b-a400m and qwen3-moe-30b-a3b (MoE)
-- reduced, against the JAX package on the CPU, weights carried across
by ``models/convert.params_from_numpy`` (packed payload bits included).

The JAX side serves its ``xla`` spellings over the packed store (the
dequantize path: f32 products of the stored values); the port serves
the same and its kernel spellings (``paged`` / ``qmm_pallas``, whose
plain versions run on the CPU):

* binary32: logits of ``prefill``, ``prefill_chunk`` and ``decode_step``
  within 1e-5 x max(1, max|logit|) -- the tied heads (command-r,
  granite) multiply by the unit-scale embedding table, so their logits
  reach ~25, where 1e-5 is five f32 ulps -- and greedy tokens of
  ``synchronous_generate`` equal;
* transprecision (JAX compiled with ``xla_allow_excess_precision`` off,
  see ``tests/test_torch_model.py``), the engine's path (``prefill_chunk``
  and ``decode_step`` over paged caches): within 2^-8 x max|logit|, a
  bf16 rounding may flip by one ulp where the summation orders differ;
* the logits for the three configs with new layers: reduced yi-9b and
  mistral-nemo-12b are reduced llama3-8b but for the name (checked
  here), whose logits ``tests/test_torch_model.py`` holds;
* the serving CLIs, engine against engine: MoE outputs depend on which
  rows share a call (expert capacity follows the row count), so the
  port's engine must batch the reference's rows, idle slots included;
* one interpret-mode case: granite's decode step on the JAX Pallas qmm.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget_config  # noqa: E402
from repro.core.formats import get_format as jget_format  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.engine.reference import \
    synchronous_generate as jsync  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import qparams as jqparams  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import synchronous_generate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from test_torch_model import (_close, _f32, _jit, _run_jax,  # noqa: E402
                              _run_port, to_numpy)

ARCHS = ("yi-9b", "mistral-nemo-12b", "command-r-35b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
# the configs whose reduced form is not reduced llama3-8b (whose logits
# ``tests/test_torch_model.py`` holds): layernorm and a tied head, MoE
NEW_LAYERS = ARCHS[2:]
# (decode_impl, matmul_impl) of the port's side.  Under transprecision
# the attention stays ``xla`` on both sides: the kernel spellings attend
# over the binary8-rounded cache where ``xla``'s prefill attends over the
# unrounded K/V, in the reference too
SPELLINGS = {"binary32": (("xla", "xla"), ("paged", "qmm_pallas")),
             "transprecision": (("xla", "xla"), ("xla", "qmm_pallas"))}


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@functools.lru_cache(maxsize=None)
def _numpy_params(arch, pol):
    """Random weights (the port's init, seed 0; torch's generator is
    quicker here than the JAX package's) as numpy, packed as
    ``qparams.encode_params`` packs a native policy's store: each matmul
    weight's container is a bitcast of its values, ``(payload, format
    name)`` as ``params_from_numpy`` takes it."""
    model, _ = build(arch, reduced=True)
    policy = get_policy(pol)
    params = model.init_params(torch.Generator().manual_seed(0), policy,
                               device="cpu")
    jpol = jget_policy(pol)

    def pack(t, path=()):
        if isinstance(t, dict):
            return {k: pack(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [pack(v, path + (i,)) for i, v in enumerate(t)]
        t = _numpy(t)
        role = jqparams.ROLE_BY_NAME.get(path[-1])
        if role is None:
            return t
        li = path[1] if path[0] == "layers" else None
        fmt = jpol.fmt(role, layer=li)
        assert t.dtype == fmt.native_dtype, (path, t.dtype, fmt)
        return (t.view(fmt.container_dtype), fmt.name)
    return pack(params)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return JQTensor(jnp.asarray(tree[0]), jget_format(tree[1]))
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree)


def _models(arch, pol, jmatmul="xla"):
    """The JAX model, policy and packed params, and the port's model,
    config and the same params carried across."""
    jmodel, jcfg = jbuild(arch, reduced=True)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl=jmatmul)
    tree = _numpy_params(arch, pol)
    model, cfg = build(arch, reduced=True)
    return ((jmodel, jcfg, jpol, _to_jax(tree)),
            (model, cfg, params_from_numpy(tree, device="cpu")))


def test_configs_are_the_references():
    assert configs.ARCHS[1:] == ARCHS
    for arch in ARCHS:
        for reduced in (False, True):
            want = jget_config(arch, reduced=reduced)
            got = configs.get(arch, reduced=reduced)
            for f in ("arch", "family", "n_layers", "d_model", "n_heads",
                      "n_kv", "d_ff", "vocab", "head_dim", "rope_theta",
                      "norm", "act_fn", "gated_ffn", "tied_embeddings",
                      "use_bias", "moe_experts", "moe_topk",
                      "capacity_factor", "loss_chunks", "attn_pattern"):
                assert getattr(got, f) == getattr(want, f), (arch, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """``param_count`` / ``active_param_count`` of the full configs are
    the reference's, and the reduced init holds exactly that many."""
    for reduced in (False, True):
        want = jget_config(arch, reduced=reduced)
        got = configs.get(arch, reduced=reduced)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    model, cfg = build(arch, reduced=True)
    params = model.init_params(torch.Generator().manual_seed(0),
                               get_policy("binary32"), device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == cfg.param_count()


@pytest.mark.parametrize("arch", NEW_LAYERS)
def test_binary32_logits_match_jax(arch):
    j, (model, cfg, tparams) = _models(arch, "binary32")
    want = _run_jax(*j)
    scale = max(1.0, max(float(np.abs(_f32(w)).max()) for w in want))
    for spell in SPELLINGS["binary32"]:
        pol = get_policy("binary32", decode_impl=spell[0],
                         matmul_impl=spell[1])
        for got, w in zip(_run_port(model, cfg, pol, tparams), want):
            _close(got, w, 1e-5 * scale)


def test_reduced_dense_configs_equal_reduced_llama():
    """Reduced yi-9b and mistral-nemo-12b differ from reduced llama3-8b
    (whose logits ``tests/test_torch_model.py`` holds under binary32 and
    transprecision) in the name alone, so the logits tests here take the
    three configs with new layers; all five take the greedy tokens."""
    llama = configs.get("llama3-8b", reduced=True)
    for arch in ("yi-9b", "mistral-nemo-12b"):
        cfg = configs.get(arch, reduced=True)
        assert dataclasses.replace(cfg, arch=llama.arch,
                                   loss_chunks=llama.loss_chunks) == llama


@pytest.mark.parametrize("arch", NEW_LAYERS)
def test_transprecision_logits_match_jax(arch):
    j, (model, cfg, tparams) = _models(arch, "transprecision")
    want = _run_jax(*j, whole=False)
    scale = max(float(np.abs(_f32(w)).max()) for w in want)
    for spell in SPELLINGS["transprecision"]:
        pol = get_policy("transprecision", decode_impl=spell[0],
                         matmul_impl=spell[1])
        for got, w in zip(_run_port(model, cfg, pol, tparams, whole=False),
                          want):
            _close(got, w, 2.0 ** -8 * scale)
            assert np.isfinite(_f32(got)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_binary32_greedy_tokens_match_jax(arch):
    """``synchronous_generate`` with whole-prompt prefill (13 tokens: MoE
    capacity drops tokens there) on both sides."""
    (jm, jcfg, jpol, jparams), (model, cfg, tparams) = _models(arch,
                                                               "binary32")
    prompts = [[3, 17, 42, 7, 99, 1, 64, 23, 5, 88, 12, 30, 2],
               [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11, 12, 13]]   # one compile
    want = jsync(jm, jcfg, jpol, jparams, prompts, max_new=5, capacity=24)
    pol = get_policy("binary32", decode_impl="flash_pallas",
                     matmul_impl="qmm_pallas")
    got = synchronous_generate(model, cfg, pol, tparams, prompts,
                               max_new=5, capacity=24, device="cpu")
    assert got == want


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b"])
def test_serve_engine_tokens_match_jax_engine(arch):
    """The serving CLIs under binary32, 3 requests over 2 slots: the
    port's engine (``paged``) gives the JAX engine's tokens (``xla``),
    both on the plain matmul spelling (the reference's grouped form
    computes in bf16 there, and so does the port's)."""
    flags = ["--arch", arch, "--reduced", "--policy", "binary32",
             "--page-size", "8", "--requests", "3", "--slots", "2",
             "--prompt-len", "8", "--max-new", "5", "--capacity", "24",
             "--matmul-impl", "xla"]
    want = jserve.main(flags + ["--decode-impl", "xla"])
    jmodel, _ = jbuild(arch, reduced=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0),
                                 jget_policy("binary32"))
    params = params_from_numpy(to_numpy(jparams), device="cpu")
    got = tserve.main(flags + ["--decode-impl", "paged", "--device", "cpu"],
                      params=params)
    assert all(r.done and not r.failed for r in got)
    assert [r.prompt for r in got] == [r.prompt for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]


def test_granite_decode_step_matches_jax_pallas_qmm():
    """One transprecision decode step on the packed store: the port's
    qmm (its plain version) against the JAX Pallas qmm in interpret mode,
    one launch per expert on both sides."""
    (jm, _, jpol, jparams), (model, cfg, tparams) = _models(
        "granite-moe-1b-a400m", "transprecision", jmatmul="qmm_pallas")
    toks = np.array([[3], [5]], np.int32)
    step = _jit(lambda p, t, s: jm.decode_step(p, t, s, jpol))
    want, _ = step(jparams, jnp.asarray(toks), jm.init_state(2, 16, jpol))
    pol = get_policy("transprecision", decode_impl="xla",
                     matmul_impl="qmm_pallas")
    got, _ = model.decode_step(tparams, torch.from_numpy(toks),
                               model.init_state(2, 16, pol, device="cpu"),
                               pol)
    scale = float(np.abs(_f32(want)).max())
    _close(got, want, 2.0 ** -8 * scale)
    np.testing.assert_array_equal(_f32(got).argmax(-1), _f32(want).argmax(-1))
