"""Training in the port against the JAX package: the loss.

Each case builds the reference's params with ``Model.init_params(
PRNGKey(0), ...)``, carries them across with ``models/convert.py`` and
feeds both packages the reference's numpy batch
(``repro.data.pipeline.SyntheticLM``, batch 2 x 16).

* ``Model.train_loss`` on every reduced config: within 1e-4 relative
  under transprecision, the reference compiled with XLA's excess
  precision off (measured: within 2e-6), and within 1e-5 relative under
  binary32 (measured: within 1e-7; six configs in
  ``test_torch_train_grads.py`` with their gradients).
* ``layers.lm_head_loss`` (chunked cross-entropy) against the
  reference's, loss and gradient.
* ``cfg.remat`` changes no bit; the flash_pallas spelling trains as the
  xla spelling under binary32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ARCHS = ("llama3-8b", "yi-9b", "mistral-nemo-12b", "command-r-35b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "paligemma-3b",
         "rwkv6-1.6b", "recurrentgemma-2b", "whisper-tiny")
GRAD_ARCHS = ("llama3-8b", "granite-moe-1b-a400m", "rwkv6-1.6b",
              "recurrentgemma-2b", "paligemma-3b", "whisper-tiny")
NO_EXCESS = {"xla_allow_excess_precision": False}
BF16 = torch.bfloat16


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def _setup(arch, pol):
    jmodel, jcfg = jbuild(arch, reduced=True)
    jpol = jget_policy(pol)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jpol)
    batch = {k: np.asarray(v) for k, v in SyntheticLM(
        DataConfig(global_batch=2, seq_len=16), jcfg).batch_at(0).items()}
    model, _ = build(arch, reduced=True)
    tparams = params_from_numpy(to_numpy(jparams), device="cpu")
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    return (jmodel, jpol, jparams, batch), (model, get_policy(pol), tparams,
                                            tbatch)


def _rel(got, want):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_transprecision(arch):
    (jm, jp, jparams, b), (m, tp, tparams, tb) = _setup(arch,
                                                        "transprecision")
    want = jax.jit(lambda p: jm.train_loss(p, b, jp),
                   compiler_options=NO_EXCESS)(jparams)
    got = m.train_loss(tparams, tb, tp)
    assert got.dtype == torch.float32 and got.grad_fn is None
    assert _rel(got, want) <= 1e-4, (float(got), float(want))


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(GRAD_ARCHS)))
def test_train_loss_binary32(arch):
    (jm, jp, jparams, b), (m, tp, tparams, tb) = _setup(arch, "binary32")
    want = jax.jit(lambda p: jm.train_loss(p, b, jp))(jparams)
    assert _rel(m.train_loss(tparams, tb, tp), want) <= 1e-5


@pytest.mark.parametrize("mask", [False, True])
def test_lm_head_loss_matches_reference(mask):
    """Chunked cross-entropy, a tied (transposed) head, a chunk count
    that does not divide S (7 -> 5 chunks of 3 over S 15)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 15, 24)).astype(np.float32)
    table = rng.normal(size=(50, 24)).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 15)).astype(np.int32)
    lm = (rng.random((2, 15)) > 0.3).astype(np.float32) if mask else None
    jp, tp = jget_policy("binary32"), get_policy("binary32")
    want, jg = jax.jit(jax.value_and_grad(lambda w: jlayers.lm_head_loss(
        jnp.asarray(x), w.T, jnp.asarray(labels), jp, n_chunks=7,
        label_mask=None if lm is None else jnp.asarray(lm))))(
            jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    got = tlayers.lm_head_loss(torch.tensor(x), tt.T, torch.tensor(labels),
                               tp, n_chunks=7, label_mask=None if lm is None
                               else torch.tensor(lm))
    assert _rel(got, want) <= 1e-6
    (g,) = torch.autograd.grad(got, tt)
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def _reduced_llama(**kw):
    model, cfg = build("llama3-8b", reduced=True)
    if kw:
        model = Model(dataclasses.replace(cfg, **kw))
    pol = get_policy("binary32")
    params = model.init_params(torch.Generator().manual_seed(0), pol,
                               device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=(2, 17)),
                        dtype=torch.int32)
    return model, pol, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_remat_changes_no_bit():
    """``cfg.remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the same loss and grads, bit for bit."""
    m1, pol, params, batch = _reduced_llama()
    m0 = Model(dataclasses.replace(m1.cfg, remat=False))
    assert m1.cfg.remat
    l1, g1 = loss_and_grads(m1, params, batch, pol)
    l0, g0 = loss_and_grads(m0, params, batch, pol)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g0)))


def test_flash_spelling_trains_as_the_xla_spelling():
    """binary32: the flash_pallas spelling's loss and grads (its plain
    version on the CPU, through ``flash_prefill_diff``) equal the xla
    spelling's within 1e-5 x max |g|; nothing but the attention core
    differs."""
    m, pol, params, batch = _reduced_llama()
    lf, gf = loss_and_grads(m, params, batch,
                            get_policy("binary32", decode_impl="flash_pallas"))
    lx, gx = loss_and_grads(m, params, batch,
                            get_policy("binary32", decode_impl="xla"))
    assert _rel(lf, lx) <= 1e-6
    for a, b in zip(leaves(gf), leaves(gx)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
