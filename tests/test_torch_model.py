"""The port's dense decoder against the JAX package on reduced llama3-8b,
weights carried across by ``models/convert.params_from_numpy``.

Logits of ``prefill`` (whole prompt into a contiguous cache),
``prefill_chunk`` (two chunks into a paged cache) and ``decode_step``
(over both caches):

* binary32: equal within 1e-5, for the plain spellings (xla / xla) and for
  the kernel spellings (paged / qmm_pallas, whose plain versions run on
  the CPU) against the JAX ``xla`` path -- all f32 math, only summation
  orders differ.
* transprecision: the same spellings on both sides, the JAX kernels in
  interpret mode.  The JAX side is compiled with XLA's
  ``xla_allow_excess_precision`` off: by default XLA may skip the bf16
  rounding between fused elementwise ops, which moves its logits by ~1 %
  of their range; with every bf16 cast honoured, the plain spellings agree
  within 1e-5.  The kernel spellings (chunked prefill and paged decode,
  the engine's path) sum in another order than the Pallas kernels, so a
  bf16 rounding may flip by one ulp: within 2^-8 x max|logit|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.kernels import paged_cache as jpc  # noqa: E402
from repro.models import qparams as jqparams  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.models import qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

PROMPT = [3, 17, 42, 7, 99, 1, 64, 23, 5, 88, 12]   # 11 tokens: chunks 8 + 3
PAGE, PPS = 8, 3


def to_numpy(tree):
    """The JAX -> numpy half of carrying weights across."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.payload), tree.fmt.name)
    return np.asarray(tree)


def _models(pol, decode_impl, matmul_impl, jdecode=None, jmatmul=None):
    jmodel, jcfg = jbuild("llama3-8b", reduced=True)
    jpol = jget_policy(pol, decode_impl=jdecode or decode_impl,
                       matmul_impl=jmatmul or matmul_impl)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jpol)
    model, cfg = build("llama3-8b", reduced=True)
    tpol = get_policy(pol, decode_impl=decode_impl, matmul_impl=matmul_impl)
    tparams = params_from_numpy(to_numpy(jparams), device="cpu")
    if matmul_impl == "qmm_pallas":
        tparams = qparams.encode_params(tparams, tpol)
    if (jmatmul or matmul_impl) == "qmm_pallas":
        jparams = jqparams.encode_params(jparams, jpol)
    return (jmodel, jcfg, jpol, jparams), (model, cfg, tpol, tparams)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


def _close(got, want, tol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol, f"max |port - jax| = {err:.3e} > {tol:.3e}"


def _jit(f, **kw):
    """jax.jit with every bf16 rounding honoured (see the module doc)."""
    return jax.jit(f, compiler_options={"xla_allow_excess_precision": False},
                   **kw)


def _run_jax(jm, jcfg, jpol, jparams, whole=True):
    toks = jnp.asarray([PROMPT], jnp.int32)
    decode = _jit(lambda p, t, s: jm.decode_step(p, t, s, jpol))
    chunk = _jit(lambda p, t, s, off: jm.prefill_chunk(
        p, t, s, [None] * jcfg.n_layers, jpol, slot=1, q_offset=off)[:2],
        static_argnums=(3,))
    out = []
    if whole:
        prefill = _jit(lambda p, t: jm.prefill(p, {"tokens": t}, jpol, 16))
        lp, st = prefill(jparams, toks)
        ld, _ = decode(jparams, jnp.asarray([[PROMPT[-1]]], jnp.int32), st)
        out = [lp, ld]
    caches = [jpc.set_block_tables(jpc.init_paged_cache(
        2, 4, PAGE, PPS, jcfg.n_kv, jcfg.head_dim, jpol.dtype("kv_cache")),
        np.array([[-1, -1, -1], [2, 0, 3]], np.int32))
        for _ in range(jcfg.n_layers)]
    c1, caches = chunk(jparams, toks[:, :8], caches, 0)
    c2, caches = chunk(jparams, toks[:, 8:], caches, 8)
    lpd, _ = decode(jparams, jnp.asarray([[0], [PROMPT[-1]]], jnp.int32),
                    caches)
    return out + [c1, c2, lpd[1]]


def _run_port(m, cfg, pol, params, whole=True):
    toks = torch.tensor([PROMPT], dtype=torch.int32)
    out = []
    if whole:
        lp, st = m.prefill(params, {"tokens": toks}, pol, 16)
        ld, _ = m.decode_step(params, torch.tensor([[PROMPT[-1]]]), st, pol)
        out = [lp, ld]
    caches = [tpc.set_block_tables(tpc.init_paged_cache(
        2, 4, PAGE, PPS, cfg.n_kv, cfg.head_dim, pol.dtype("kv_cache")),
        np.array([[-1, -1, -1], [2, 0, 3]], np.int32))
        for _ in range(cfg.n_layers)]
    none = [None] * cfg.n_layers
    c1, caches, _ = m.prefill_chunk(params, toks[:, :8], caches, none, pol,
                                    slot=1, q_offset=0)
    c2, caches, _ = m.prefill_chunk(params, toks[:, 8:], caches, none, pol,
                                    slot=1, q_offset=8)
    lpd, _ = m.decode_step(params, torch.tensor([[0], [PROMPT[-1]]]),
                           caches, pol)
    return out + [c1, c2, lpd[1]]


@pytest.mark.parametrize("spell", [("xla", "xla"), ("paged", "qmm_pallas")],
                         ids=["plain", "kernel-spellings"])
def test_binary32_logits_match_jax(spell):
    j, t = _models("binary32", *spell, jdecode="xla", jmatmul="xla")
    for got, want in zip(_run_port(*t), _run_jax(*j)):
        _close(got, want, 1e-5)


def test_transprecision_plain_logits_match_jax():
    j, t = _models("transprecision", "xla", "xla")
    for got, want in zip(_run_port(*t), _run_jax(*j)):
        _close(got, want, 1e-5)


def test_transprecision_kernel_spellings_match_jax_kernels():
    """Chunked prefill + paged decode with packed weights: the port's
    plain kernel versions against the Pallas kernels in interpret mode."""
    j, t = _models("transprecision", "paged", "qmm_pallas")
    outs = list(zip(_run_port(*t, whole=False), _run_jax(*j, whole=False)))
    scale = max(float(np.abs(_f32(w)).max()) for _, w in outs)
    for got, want in outs:
        _close(got, want, 2.0 ** -8 * scale)
        assert np.isfinite(_f32(got)).all()


def test_params_from_numpy_keeps_payload_bits():
    (_, _, _, jparams), (_, _, _, tparams) = _models(
        "transprecision", "paged", "qmm_pallas")
    jw = jparams["layers"][1]["ffn"]["w_gate"]
    tw = tparams["layers"][1]["ffn"]["w_gate"]
    assert tw.fmt.name == jw.fmt.name == "binary16alt"
    np.testing.assert_array_equal(tw.payload.to(torch.int32).numpy(),
                                  np.asarray(jw.payload).astype(np.int32))
    assert tparams["embed"].dtype == torch.bfloat16   # the table stays plain
    assert not isinstance(tparams["embed"], JQTensor)


@pytest.mark.parametrize("rows", [1, 4, 16])
@pytest.mark.parametrize("d", [64, 4096, 5120, 8192])
def test_rmsnorm_matches_jax(rows, d):
    """rmsnorm sums the squares in an order fixed by d alone (128
    strided per-thread partials, then a tree: ``kernels/rmsnorm.py``,
    the order of its CUDA kernel); under binary32 it differs from the
    reference's one mean by the order of a sum of d positive terms only,
    within 1e-6 relative, and each row equals the row normalized
    alone."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    rng = np.random.default_rng(rows * d)
    x = (rng.normal(size=(rows, d)) * 3.0).astype(np.float32)
    gamma = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    want = np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(gamma),
                                      jget_policy("binary32")))
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                          get_policy("binary32"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for r in range(rows):
        alone = tlayers.rmsnorm(torch.from_numpy(x[r:r + 1]),
                                torch.from_numpy(gamma),
                                get_policy("binary32"))
        assert torch.equal(alone[0], got[r])
