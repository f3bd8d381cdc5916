"""The port's MoE FFN (``models/moe.py``) against the JAX package's
global dispatch (``repro.models.moe._moe_apply_global``) on the CPU, for
the reduced granite-moe-1b-a400m and qwen3-moe-30b-a3b, the weights made
by the reference's ``moe_init`` and carried across as numpy.

* Routing: the same chosen experts, capacity, ``keep`` and ``dest`` as
  the reference's dispatch arithmetic (repeated here op for op), at the
  published capacity factor and at one small enough to drop tokens; ties
  go to the lower expert id, as ``jax.lax.top_k``'s.
* Outputs within 1e-5 x max(1, max|y|) under binary32 (the reference's
  init takes an expert's fan-in from E, so |y| reaches ~30 here, where
  1e-5 is a few f32 ulps), on the plain spelling (the
  reference's grouped form computes in bf16 there, the port's too) and
  on the packed store (``qmm_pallas`` on the port's side: f32 products);
  within 2^-7 x max|y| under transprecision, one bf16 ulp of the largest
  output: the output is bf16, and a rounding may flip by one ulp where
  the summation orders differ.
* The combine adds each token's K contributions in the reference's
  order: bit for bit a sequential scatter-add in sorted order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.models import moe, qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")


def _jax_dispatch(p, xt, cfg, policy):
    """The reference's routing and dispatch indices, the lines of
    ``_moe_apply_global`` that compute them."""
    T = xt.shape[0]
    E, K = cfg.moe_experts, cfg.moe_topk
    logits = jlayers.pdot(xt, p["router"], policy, "router_w",
                          out_act=False).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, K)
    C = max(8, min(int(np.ceil(cfg.capacity_factor * T * K / E)), T))
    flat_e = top_e.reshape(T * K)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * K, dtype=jnp.int32) - starts[se].astype(jnp.int32)
    keep = pos < C
    dest = jnp.where(keep, se.astype(jnp.int32) * C + pos, E * C)
    return (np.asarray(top_e), C, np.asarray(order), np.asarray(keep),
            np.asarray(dest))


def _case(arch, pol, capacity_factor, seed=0, T=(2, 13)):
    cfg = configs.get(arch, reduced=True)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jpol = jget_policy(pol)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg,
                       jpol.dtype("ffn_w"))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*T, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jpol.dtype("act"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    xt = torch.from_numpy(x).to(get_policy(pol).dtype("act"))
    return cfg, jpol, jp, xj, tp, xt


def _f32(a):
    return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference(arch, capacity_factor):
    cfg, jpol, jp, xj, tp, xt = _case(arch, "binary32", capacity_factor)
    T = xt.shape[0] * xt.shape[1]
    top_e, C, order, keep, dest = _jax_dispatch(
        jp, xj.reshape(T, -1), cfg, jpol)
    r = moe.moe_route(tp, xt.reshape(T, -1), cfg, get_policy("binary32"))
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    assert r.C == C == moe.capacity(cfg, T)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.dest.numpy(), dest)
    if capacity_factor < 1:              # the small factor drops tokens
        assert keep.sum() < T * cfg.moe_topk


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_binary32_output_matches_reference(arch, capacity_factor, packed):
    cfg, jpol, jp, xj, tp, xt = _case(arch, "binary32", capacity_factor)
    pol = get_policy("binary32", matmul_impl="qmm_pallas" if packed
                     else "xla")
    if packed:
        jp = {k: JQTensor.from_native(v) for k, v in jp.items()}
        tp = qparams.encode_params(tp, pol)
    want, waux = jax.jit(lambda p, x: jmoe._moe_apply_global(
        p, x, cfg, jpol))(jp, xj)
    got, aux = moe.moe_apply(tp, xt, cfg, pol)
    scale = max(1.0, float(np.abs(_f32(want)).max()))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_transprecision_output_matches_reference(arch):
    cfg, jpol, jp, xj, tp, xt = _case(arch, "transprecision", 0.25)
    pol = get_policy("transprecision", matmul_impl="qmm_pallas")
    want, _ = jax.jit(lambda p, x: jmoe._moe_apply_global(p, x, cfg, jpol),
                      compiler_options={"xla_allow_excess_precision":
                                        False})(jp, xj)
    got, _ = moe.moe_apply(qparams.encode_params(tp, pol), xt, cfg, pol)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(_f32(want)).max())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=2.0 ** -7 * scale)


def test_top_k_ties_go_to_the_lower_expert():
    """A zero router: every probability ties, and both sides pick experts
    0 .. K-1 for every token."""
    cfg, jpol, jp, xj, tp, xt = _case("qwen3-moe-30b-a3b", "binary32", 1.25)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    T = xt.shape[0] * xt.shape[1]
    top_e = _jax_dispatch(jp, xj.reshape(T, -1), cfg, jpol)[0]
    r = moe.moe_route(tp, xt.reshape(T, -1), cfg, get_policy("binary32"))
    np.testing.assert_array_equal(top_e, np.tile(np.arange(cfg.moe_topk),
                                                 (T, 1)))
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.top_p.numpy(),
                                  np.full((T, cfg.moe_topk),
                                          1.0 / cfg.moe_topk, np.float32))


@pytest.mark.parametrize("K", [1, 2, 8])
def test_combine_is_the_sequential_sorted_scatter_add(K):
    """The CPU's ``index_add_`` adds its rows one after another in index
    order, as XLA's CPU scatter-add applies the reference's sorted
    updates: the port's combine (no atomics, so the card gives the same
    bits) equals it bit for bit."""
    T, E, d = 37, 16, 24
    rng = np.random.default_rng(K)
    top_e = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    order = torch.sort(torch.from_numpy(top_e.reshape(-1)),
                       stable=True).indices
    weighted = torch.from_numpy(
        (rng.normal(size=(T * K, d)) * 10.0 ** rng.integers(
            -3, 4, size=(T * K, 1))).astype(np.float32))
    want = torch.zeros((T, d)).index_add_(
        0, torch.div(order, K, rounding_mode="floor"), weighted)
    assert torch.equal(moe.combine(weighted, order, T, K), want)
