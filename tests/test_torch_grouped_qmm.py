"""The MoE expert product on the CPU: ``qmatmul.qmm_grouped`` (one
``qmm_tc_grouped_launch`` a weight on a card) against the JAX package.

* ``qmm_grouped_plain`` against the reference's ``_grouped_qmm``
  (``repro.models.layers``, its Pallas qmatmul in interpret mode, as the
  JAX package's own CPU tests run it) in the four packed formats, with
  counts that hold an empty expert, one row, a partial count and a full
  one: kept rows within 1e-6 x |x| @ |w| (the qmm contract), the rest +0.
  The reference computes every row of the (zero-padded) dispatch; the
  grouped product only the kept ones.
* ``Routing.rows`` equal to the reference's ``min(bincount(top_e), C)``
  at the published capacity factor and at one that drops tokens.
* The plan: the grouped launch's K split is ``tiled_splits(K, N)``, the
  per-expert product's, at the qwen3-moe and granite-moe expert shapes,
  so each row is summed in the order of its expert's own qmm_tc launch.
* The MoE layer through ``qmm_grouped`` equals it through the per-expert
  loop bit for bit on the CPU, and a tensor off the CPU never takes the
  plain version.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.core.formats import get_format as jget_format  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.qtensor import decode  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import qmatmul as tq  # noqa: E402
from repro_torch.models import layers, moe, qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

PACKED = ["binary8", "binary8alt", "binary16", "binary16alt"]
MOE_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")


def _counts(E, C, rng):
    """An empty expert, one row, a full one, a partial count, then
    seeded counts in 0..C."""
    fixed = [0, 1, C, C // 2]
    return np.array(fixed + list(rng.integers(0, C + 1, size=E - 4)),
                    np.int32)


def _dispatched(E, C, K, rows, rng):
    """Activations as the dispatch packs them: rows below the count
    seeded, the rest zero."""
    a = rng.normal(size=(E, C, K)).astype(np.float32)
    a[np.arange(C)[None, :] >= rows[:, None]] = 0.0
    return a


@pytest.mark.parametrize("E,C,K,N", [(4, 8, 128, 64), (8, 20, 256, 192)])
@pytest.mark.parametrize("fmt", PACKED)
def test_plain_matches_reference_grouped_qmm(fmt, E, C, K, N):
    rng = np.random.default_rng(E * 1000 + C + len(fmt))
    rows = _counts(E, C, rng)
    a = _dispatched(E, C, K, rows, rng)
    w = np.array(jqt.encode(jnp.asarray(rng.normal(size=(E, K, N)),
                                        jnp.float32), fmt))
    jw = jqt.QTensor(jnp.asarray(w), jget_format(fmt))
    want = np.asarray(jlayers._grouped_qmm(
        jnp.asarray(a), jw, jget_policy("transprecision",
                                        matmul_impl="qmm_pallas"), "ffn_w"))
    got = tq.qmm_grouped_plain(torch.from_numpy(a), torch.from_numpy(w),
                               fmt, torch.from_numpy(rows)).numpy()
    wf = decode(torch.from_numpy(w), get_format(fmt)).double().numpy()
    unit = np.abs(a).astype(np.float64) @ np.abs(wf) + 1.0
    kept = np.arange(C)[None, :] < rows[:, None]
    err = np.abs(got - want) / unit
    assert err[kept].max() <= 1e-6, err[kept].max()
    dead = got[~kept]
    assert np.all(dead == 0.0) and not np.signbit(dead).any()
    assert np.all(want[~kept] == 0.0)       # the reference's padding rows


@pytest.mark.parametrize("fmt", PACKED)
def test_wrapper_on_cpu_is_the_plain_version_and_ignores_dead_rows(fmt):
    """Rows past the count never reach the result: NaN there gives the
    same +0 rows and the same kept rows, bit for bit."""
    E, C, K, N = 6, 8, 64, 48
    rng = np.random.default_rng(len(fmt))
    rows = _counts(E, C, rng)
    a = _dispatched(E, C, K, rows, rng)
    w = np.array(jqt.encode(jnp.asarray(rng.normal(size=(E, K, N)),
                                        jnp.float32), fmt))
    noisy = a.copy()
    noisy[np.arange(C)[None, :] >= rows[:, None]] = np.nan
    args = (torch.from_numpy(w), fmt, torch.from_numpy(rows))
    got = tq.qmm_grouped(torch.from_numpy(noisy), *args)
    want = tq.qmm_grouped_plain(torch.from_numpy(a), *args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    loop = tq.qmm_grouped_loop(torch.from_numpy(a), torch.from_numpy(w),
                               fmt)
    kept = torch.arange(C)[None, :] < torch.from_numpy(rows)[:, None]
    assert torch.equal(got[kept].view(torch.int32),
                       loop[kept].view(torch.int32))


@functools.lru_cache(maxsize=None)
def _reference_params(arch, seed):
    """The reference's ``moe_init`` weights (the capacity factor does not
    enter them), made once an arch."""
    cfg = configs.get(arch, reduced=True)
    return jmoe.moe_init(jax.random.PRNGKey(seed), cfg,
                         jget_policy("binary32").dtype("ffn_w"))


def _route_case(arch, capacity_factor, T, seed):
    cfg = dataclasses.replace(configs.get(arch, reduced=True),
                              capacity_factor=capacity_factor)
    jpol = jget_policy("binary32")
    jp = _reference_params(arch, seed)
    x = np.random.default_rng(seed).normal(
        size=(T, cfg.d_model)).astype(np.float32)
    logits = jlayers.pdot(jnp.asarray(x), jp["router"], jpol, "router_w",
                          out_act=False).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe_topk)
    C = max(8, min(int(np.ceil(capacity_factor * T * cfg.moe_topk
                               / cfg.moe_experts)), T))
    counts = np.asarray(jnp.bincount(top_e.reshape(-1),
                                     length=cfg.moe_experts))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    r = moe.moe_route(tp, torch.from_numpy(x), cfg, get_policy("binary32"))
    return r, np.minimum(counts, C), counts, C


@pytest.mark.parametrize("T", [2, 26])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_rows_match_reference(arch, capacity_factor, T):
    r, want, counts, C = _route_case(arch, capacity_factor, T, seed=3)
    assert r.C == C
    assert r.rows.dtype == torch.int32
    np.testing.assert_array_equal(r.rows.numpy(), want)
    # the kept entries of each expert are its rows, packed at the front
    assert int(r.keep.sum()) == int(want.sum())
    if capacity_factor < 1 and T > 8:
        assert (counts > C).any()          # the small factor drops


SHAPES = {   # (E, K, N) of w_in / w_gate and w_out, published widths
    "qwen3-moe-30b-a3b": ((128, 2048, 768), (128, 768, 2048)),
    "granite-moe-1b-a400m": ((32, 1024, 512), (32, 512, 1024)),
}


@pytest.mark.parametrize("C", [8, 20, 64])
@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_grouped_plan_keeps_the_per_expert_k_split(arch, C):
    for E, K, N in SHAPES[arch]:
        tile, splits, k_chunk = tq.grouped_plan(C, K, N, 132)
        assert (splits, k_chunk) == tq.tiled_splits(K, N, 132)
        assert (splits, k_chunk) == tq.qmm_plan(
            K, N, get_format("binary16alt"), False, 132)[1:]
        assert tile == tq.tc_tile_m(C)
        assert (splits - 1) * k_chunk < K and k_chunk % tq.TC_BK == 0 \
            or splits == 1


@pytest.mark.parametrize("fmt,item", [("binary16alt", 2), ("binary8", 1)])
def test_grouped_hbm_bytes_count_live_experts_once(fmt, item):
    """Three experts with kept rows stream their weights; 12 kept rows
    read their activations; all 5 x 8 rows of the result are written."""
    K, N = 2048, 768
    assert tq.qmm_grouped_hbm_bytes([0, 3, 8, 0, 1], K, N, fmt, 8) \
        == 3 * K * N * item + 12 * K * 4 + 5 * 8 * N * 4


def _moe_case(arch, pol_name, seed=0):
    cfg = configs.get(arch, reduced=True)
    pol = get_policy(pol_name, matmul_impl="qmm_pallas")
    gen = torch.Generator().manual_seed(seed)
    p = qparams.encode_params(
        moe.moe_init(gen, cfg, pol.dtype("ffn_w"), device="cpu"), pol)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32)).to(pol.dtype("act"))
    return cfg, pol, p, x


@pytest.mark.parametrize("pol_name", ["transprecision", "binary32"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_equals_the_per_expert_loop(arch, pol_name, monkeypatch):
    cfg, pol, p, x = _moe_case(arch, pol_name)
    calls = []
    real, real_ffn = tq.qmm_grouped, tq.qmm_grouped_ffn

    def grouped(a, payload, fmt, rows):
        calls.append(rows.clone())
        return real(a, payload, fmt, rows)

    def grouped_ffn(a, w_in, w_gate, fmt, rows, **kw):
        calls.append(rows.clone())
        return real_ffn(a, w_in, w_gate, fmt, rows, **kw)
    monkeypatch.setattr(layers, "qmm_grouped", grouped)
    monkeypatch.setattr(layers, "qmm_grouped_ffn", grouped_ffn)
    got, aux = moe.moe_apply(p, x, cfg, pol)
    impl = dispatch.resolve_matmul("qmm_pallas")
    monkeypatch.setattr(impl, "grouped", staticmethod(
        lambda a, w, policy, role, rows=None:
        tq.qmm_grouped_loop(a.to(torch.float32), w.payload, w.fmt)))
    monkeypatch.setattr(layers, "qmm_grouped_ffn",
                        lambda a, w_in, w_gate, fmt, rows, **kw:
                        tq.qmm_grouped_ffn_loop(a, w_in, w_gate, fmt, **kw))
    want, waux = moe.moe_apply(p, x, cfg, pol)
    assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                       else got.view(torch.int32),
                       want.view(torch.int16) if want.dtype == torch.bfloat16
                       else want.view(torch.int32))
    assert torch.equal(aux, waux)
    packed = p["w_in"].fmt.name != "binary32"
    # the gated pair in one call, then w_out
    assert len(calls) == (2 if packed else 0)
    r = moe.moe_route(p, x.reshape(-1, cfg.d_model), cfg, pol)
    assert all(torch.equal(c, r.rows) for c in calls)


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    seen = []
    # meta stands in for a CUDA tensor: routed as one (on meta itself the
    # wrapper takes the shape route, tests/test_torch_dryrun.py)
    monkeypatch.setattr(tq, "route", lambda t: "cuda")
    monkeypatch.setattr(tq, "qmm_grouped_plain",
                        lambda *a: pytest.fail("plain version on meta"))
    monkeypatch.setattr(tq, "_qmm_grouped_cuda",
                        lambda a, b, fmt, rows: seen.append(a.device))
    a = torch.empty((4, 8, 64), device="meta")
    w = torch.empty((4, 64, 32), dtype=torch.uint16, device="meta")
    rows = torch.empty((4,), dtype=torch.int32, device="meta")
    tq.qmm_grouped(a, w, "binary16alt", rows)
    assert seen == [torch.device("meta")]


def test_grouped_rejects_formats_without_a_tensor_core_route():
    a = torch.empty((2, 8, 64), device="meta")
    w = torch.empty((2, 64, 32), dtype=torch.uint32, device="meta")
    rows = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="per-expert loop"):
        tq.qmm_grouped(a, w, "binary32", rows)


# ---------------------------------------------------------------------------
# the gated pair in one call: qmm_grouped_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", PACKED)
def test_gated_plain_matches_reference_gated_pair(fmt):
    """``qmm_grouped_ffn_plain`` against the reference's MoE up-projection
    ``silu(_grouped_qmm(w_in)) * _grouped_qmm(w_gate)`` (its Pallas
    qmatmul in interpret mode) with an empty expert, one row, a full and
    a partial count.  Each product is within 1e-6 x |x| @ |w| of its
    exact value (the qmm contract, U below), silu's slope is below 1.1,
    and the two libraries' silu and product roundings may differ by a few
    ulps: the kept rows within 1e-6 (1.1 U_in |g| + U_g |h| + 1e-6 U_in
    U_g) + 5e-7 |result|; the dead rows +0 (the reference's are silu(0) *
    0 of its zero padding)."""
    E, C, K, N = 5, 8, 64, 64
    rng = np.random.default_rng(11 + len(fmt))
    rows = _counts(E, C, rng)
    a = _dispatched(E, C, K, rows, rng)
    ws = [np.array(jqt.encode(jnp.asarray(rng.normal(size=(E, K, N)),
                                          jnp.float32), fmt))
          for _ in range(2)]
    jpol = jget_policy("transprecision", matmul_impl="qmm_pallas")
    h, g = (np.asarray(jlayers._grouped_qmm(
        jnp.asarray(a), jqt.QTensor(jnp.asarray(w), jget_format(fmt)), jpol,
        "ffn_w")) for w in ws)
    want = np.asarray(jax.nn.silu(jnp.asarray(h)) * jnp.asarray(g))
    got = tq.qmm_grouped_ffn(torch.from_numpy(a), torch.from_numpy(ws[0]),
                             torch.from_numpy(ws[1]), fmt,
                             torch.from_numpy(rows), act="silu").numpy()
    u_in, u_g = (np.abs(a).astype(np.float64)
                 @ np.abs(decode(torch.from_numpy(w), get_format(fmt))
                          .double().numpy()) + 1.0 for w in ws)
    tol = 1e-6 * (1.1 * u_in * np.abs(g) + u_g * np.abs(h)
                  + 1e-6 * u_in * u_g) + 5e-7 * np.abs(want)
    kept = np.arange(C)[None, :] < rows[:, None]
    assert np.all(np.abs(got - want)[kept] <= tol[kept])
    dead = got[~kept]
    assert np.all(dead == 0.0) and not np.signbit(dead).any()
    assert np.all(want[~kept] == 0.0)


@pytest.mark.parametrize("act,gated,out_fmt", [("silu", True, None),
                                               ("gelu", False, None),
                                               ("silu", True, "binary8")])
def test_gated_wrapper_ignores_dead_rows_and_equals_the_loop(act, gated,
                                                             out_fmt):
    """NaN past the counts changes no bit; the kept rows equal the
    per-expert ``qmm_ffn`` loop (the oracle on the card) bit for bit, the
    ungated form and a fused output format included."""
    E, C, K, N, fmt = 6, 8, 64, 48, "binary16alt"
    rng = np.random.default_rng(5)
    rows = _counts(E, C, rng)
    a = _dispatched(E, C, K, rows, rng)
    w_in, w_gate = (torch.from_numpy(np.array(jqt.encode(jnp.asarray(
        rng.normal(size=(E, K, N)), jnp.float32), fmt))) for _ in range(2))
    w_gate = w_gate if gated else None
    noisy = a.copy()
    noisy[np.arange(C)[None, :] >= rows[:, None]] = np.nan
    kw = dict(act=act, out_fmt=out_fmt)
    rt = torch.from_numpy(rows)
    got = tq.qmm_grouped_ffn(torch.from_numpy(noisy), w_in, w_gate, fmt, rt,
                             **kw)
    want = tq.qmm_grouped_ffn_plain(torch.from_numpy(a), w_in, w_gate, fmt,
                                    rt, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    loop = tq.qmm_grouped_ffn_loop(torch.from_numpy(a), w_in, w_gate, fmt,
                                   **kw)
    kept = torch.arange(C)[None, :] < rt[:, None]
    assert torch.equal(got[kept].view(torch.int32),
                       loop[kept].view(torch.int32))
    assert not torch.signbit(got[~kept]).any() and (got[~kept] == 0).all()


@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_gated_grouped_plan_keeps_the_per_expert_gated_split(arch):
    """The gated call splits K as the per-expert gated ``qmm_ffn`` launch
    does (``tiled_splits(..., gated=True)``), so a loop of ``qmm_ffn``
    over the experts is its exact oracle."""
    E, K, N = SHAPES[arch][0]
    for C in (8, 20):
        tile, splits, k_chunk = tq.grouped_plan(C, K, N, 132, gated=True)
        assert (splits, k_chunk) == tq.tiled_splits(K, N, 132, True)
        assert (splits, k_chunk) == tq.qmm_plan(
            K, N, get_format("binary16alt"), True, 132)[1:]
        assert tile == tq.tc_tile_m(C)


def test_gated_hbm_bytes_count_both_weights_of_live_experts():
    K, N = 2048, 768
    assert tq.qmm_grouped_hbm_bytes([0, 3, 8, 0, 1], K, N, "binary16alt", 8,
                                    gated=True) \
        == 2 * 3 * K * N * 2 + 12 * K * 4 + 5 * 8 * N * 4


def test_gated_call_off_the_cpu_takes_the_kernel_dispatch(monkeypatch):
    seen = []
    monkeypatch.setattr(tq, "route", lambda t: "cuda")   # meta as CUDA
    monkeypatch.setattr(tq, "qmm_grouped_ffn_plain",
                        lambda *a, **k: pytest.fail("plain version on meta"))
    monkeypatch.setattr(tq, "_qmm_grouped_cuda",
                        lambda a, b, fmt, rows, gate=None, act=None,
                        out_fmt=None: seen.append((a.device, gate.device,
                                                   act)))
    a = torch.empty((4, 8, 64), device="meta")
    w = torch.empty((4, 64, 32), dtype=torch.uint16, device="meta")
    rows = torch.empty((4,), dtype=torch.int32, device="meta")
    tq.qmm_grouped_ffn(a, w, w, "binary16alt", rows, act="silu")
    assert seen == [(torch.device("meta"), torch.device("meta"), "silu")]
