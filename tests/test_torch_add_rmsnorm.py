"""``add_rmsnorm`` (``kernels/rmsnorm.py``), the decoder's norm fused with
the residual add before it and the activation cast after it, on the CPU.

* Its plain version equals the three steps it replaces -- ``residual_add``,
  ``rmsnorm_plain``, the cast -- bit for bit, for bf16, f16 and f32 pairs,
  a mixed pair, no add (``y=None``, the first norm) and d 64, 1024 and
  5120, and a row's bits do not depend on the rows beside it (the CUDA
  kernel, ``csrc/rmsnorm.cu``, keeps the same order; ``chip_smoke.py``
  holds it to this plain version bit for bit on the card).
* Against the JAX package: ``x + y`` then the reference's rmsnorm, within
  one bf16 ulp under transprecision and 1e-6 relative under binary32.
* ``layers.add_norm`` takes the fused call exactly where its dtypes and
  the policy allow (native rmsnorm over f32, bf16 or f16) and the three
  steps otherwise (layernorm, emulated mode, 8-bit activations).
* Reduced llama3-8b and reduced qwen3-moe: the logits of a prefill chunk,
  a decode step and a verify step on the fused route (``add_norm`` and
  the MoE gated pair in one grouped call) equal those of the parent's
  unfused composition bit for bit, and a llama3-8b decode step makes
  2 L + 1 fused norms and no standalone residual add.
* A tensor off the CPU takes the kernel's dispatch, never the plain
  version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels.qmatmul import apply_act  # noqa: E402
from repro_torch.models import layers, moe, qparams  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
ROW_COUNTS = (1, 2, 4, 9, 16, 33, 64)


def _pair(rows, d, xdt, ydt, seed=0):
    rng = np.random.default_rng(seed + d)
    x = torch.from_numpy((rng.normal(size=(rows, d)) * 3.0)
                         .astype(np.float32)).to(xdt)
    y = torch.from_numpy((rng.normal(size=(rows, d)) * 2.0)
                         .astype(np.float32)).to(ydt)
    gamma = torch.from_numpy((rng.normal(size=(d,)) * 0.1)
                             .astype(np.float32))
    return x, y, gamma


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


# (x dtype, y dtype or None, out dtype)
DTYPES = [(BF16, BF16, BF16), (F32, F32, F32), (F16, F16, F16),
          (F32, BF16, BF16), (BF16, None, BF16), (F32, None, F32)]


@pytest.mark.parametrize("d", [64, 1024, 5120])
@pytest.mark.parametrize("xdt,ydt,odt", DTYPES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_plain_is_the_three_steps_and_free_of_the_row_count(xdt, ydt, odt,
                                                            d):
    x, y, gamma = _pair(64, d, xdt, ydt or xdt)
    y = None if ydt is None else y
    s, n = trms.add_rmsnorm(x, y, gamma, odt)
    want_s = x if y is None else layers.residual_add(x, y)
    want_n = trms.rmsnorm_plain(want_s, gamma).to(odt)
    assert s.dtype == trms.residual_dtype(xdt, ydt) == want_s.dtype
    assert n.dtype == odt
    assert torch.equal(_bits(s), _bits(want_s))
    assert torch.equal(_bits(n), _bits(want_n))
    for m in ROW_COUNTS:
        sm, nm = trms.add_rmsnorm(x[:m], None if y is None else y[:m],
                                  gamma, odt)
        assert torch.equal(_bits(sm), _bits(s[:m])), m
        assert torch.equal(_bits(nm), _bits(n[:m])), m


@pytest.mark.parametrize("pol", ["transprecision", "binary32"])
def test_matches_jax_residual_add_and_rmsnorm(pol):
    """The reference's ``x + y`` then its rmsnorm (XLA excess precision
    off): one bf16 ulp under transprecision (its ``mean`` sums in another
    order), 1e-6 relative under binary32."""
    dt = BF16 if pol == "transprecision" else F32
    x, y, gamma = _pair(16, 4096, dt, dt, seed=3)
    jpol = jget_policy(pol)
    fn = jax.jit(lambda a, b, g: jlayers.rmsnorm(a + b, g, jpol),
                 compiler_options={"xla_allow_excess_precision": False})

    def jarr(t):
        if t.dtype == BF16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())
    want = np.asarray(fn(jarr(x), jarr(y), jnp.asarray(gamma.numpy())))
    _, got = layers.add_norm(x, y, {"gamma": gamma}, get_policy(pol),
                             "rmsnorm")
    if dt == BF16:
        ulps = np.abs(got.view(torch.int16).numpy().astype(np.int32)
                      - want.view(np.int16).astype(np.int32))
        assert ulps.max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_add_norm_picks_the_route_by_kind_policy_and_dtype(monkeypatch):
    fused = []
    real = layers.add_rmsnorm
    monkeypatch.setattr(layers, "add_rmsnorm",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    x, y, gamma = _pair(4, 256, BF16, BF16)
    p = {"gamma": gamma, "beta": torch.zeros(256)}
    nat = get_policy("transprecision")
    cases = [
        (x, y, nat, "rmsnorm", True),
        (x, None, nat, "rmsnorm", True),
        (x.float(), y.float(), get_policy("binary32"), "rmsnorm", True),
        (x, y, nat, "layernorm", False),
        (x.float(), y.float(), get_policy("transprecision", mode="emulated"),
         "rmsnorm", False),
        (x.to(torch.float8_e5m2), y.to(torch.float8_e5m2), nat, "rmsnorm",
         False),
        (x, y, nat.with_overrides(act="binary8"), "rmsnorm", False),
    ]
    for xi, yi, pol, kind, want_fused in cases:
        fused.clear()
        s, n = layers.add_norm(xi, yi, p, pol, kind)
        assert bool(fused) == want_fused, (xi.dtype, pol.mode, kind)
        want_s = xi if yi is None else layers.residual_add(xi, yi)
        assert torch.equal(_bits(s), _bits(want_s))
        assert torch.equal(_bits(n),
                           _bits(layers.apply_norm(want_s, p, pol, kind)))


def _unfused_add_norm(x, y, p, policy, kind):
    """The parent's composition: the add, the norm kernel, the cast."""
    s = x if y is None else layers.residual_add(x, y)
    return s, layers.apply_norm(s, p, policy, kind)


def _unfused_grouped_ffn_in(xe, p, policy, act, rows):
    """The parent's MoE up-projection: two grouped products, torch ops."""
    h = layers.pgrouped_dot(xe, p["w_in"], policy, "ffn_w", rows=rows)
    a = apply_act(h.to(F32), act)
    if "w_gate" in p:
        a = a * layers.pgrouped_dot(xe, p["w_gate"], policy, "ffn_w",
                                    rows=rows)
    return layers.act_cast(a, policy)


def _logits(arch, pol_name):
    """A prefill chunk, a decode step and a verify step (dense only) of
    the reduced ``arch`` under ``qmm_pallas`` / ``paged``, weights from
    the port's init (seed 0)."""
    model, cfg = build(arch, reduced=True)
    pol = get_policy(pol_name, decode_impl="paged", matmul_impl="qmm_pallas")
    params = qparams.encode_params(model.init_params(
        torch.Generator().manual_seed(0), pol, device="cpu"), pol)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 12))
                            .astype(np.int32))

    def caches():
        return [tpc.set_block_tables(tpc.init_paged_cache(
            2, 4, 8, 2, cfg.n_kv, cfg.head_dim, pol.dtype("kv_cache"),
            device="cpu"), np.array([[0, 1], [2, 3]], np.int32))
            for _ in range(cfg.n_layers)]
    out = []
    st = caches()
    for slot in (0, 1):
        lc, st, _ = model.prefill_chunk(params, toks, st, [None] * len(st),
                                        pol, slot=slot, q_offset=0)
        out.append(lc)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2))
                           .astype(np.int32))
    ld, _ = model.decode_step(params, nxt[:, :1], st, pol)
    out.append(ld)
    if not cfg.moe_experts:
        lv, _ = model.verify_step(params, nxt, st, pol)
        out.append(lv)
    return out


@pytest.mark.parametrize("pol_name", ["transprecision", "binary32"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_fused_route_logits_equal_the_unfused_composition(arch, pol_name,
                                                          monkeypatch):
    fused = _logits(arch, pol_name)
    with monkeypatch.context() as m:
        m.setattr(transformer, "add_norm", _unfused_add_norm)
        m.setattr(moe, "grouped_ffn_in", _unfused_grouped_ffn_in)
        plain = _logits(arch, pol_name)
    assert len(fused) == len(plain)
    for a, b in zip(fused, plain):
        assert torch.equal(_bits(a), _bits(b))


def test_a_decode_step_makes_one_fused_norm_a_norm(monkeypatch):
    """Reduced llama3-8b, one decode step: 2 L + 1 ``add_rmsnorm`` calls,
    the first without an add, and no residual add outside them."""
    calls, adds = [], []
    real = layers.add_rmsnorm
    monkeypatch.setattr(layers, "add_rmsnorm", lambda x, y, *a, **k: (
        calls.append(y is None), real(x, y, *a, **k))[1])
    monkeypatch.setattr(layers, "residual_add",
                        lambda *a: adds.append(1) or trms.residual_add(*a))
    model, cfg = build("llama3-8b", reduced=True)
    pol = get_policy("transprecision", decode_impl="paged",
                     matmul_impl="qmm_pallas")
    params = qparams.encode_params(model.init_params(
        torch.Generator().manual_seed(0), pol, device="cpu"), pol)
    st = [tpc.set_block_tables(tpc.init_paged_cache(
        1, 2, 8, 2, cfg.n_kv, cfg.head_dim, pol.dtype("kv_cache"),
        device="cpu"), np.array([[0, 1]], np.int32))
        for _ in range(cfg.n_layers)]
    model.decode_step(params, torch.tensor([[5]], dtype=torch.int32), st,
                      pol)
    assert calls == [True] + [False] * (2 * cfg.n_layers)
    assert adds == []


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(trms, "add_rmsnorm_plain",
                        lambda *a: pytest.fail("plain version on meta"))
    monkeypatch.setattr(trms, "_add_rmsnorm_cuda",
                        lambda x, y, g, odt, eps: seen.append(
                            (x.device, y.device, odt)))
    x = torch.empty((4, 128), dtype=BF16, device="meta")
    trms.add_rmsnorm(x, x, torch.empty((128,), device="meta"), BF16)
    assert seen == [(torch.device("meta"), torch.device("meta"), BF16)]


def test_bytes_and_dtypes_the_kernel_takes():
    assert trms.add_rmsnorm_hbm_bytes(4, 4096, 2, 2, 2, 2) \
        == 4 * 4096 * 8 + 4096 * 4
    assert trms.add_rmsnorm_hbm_bytes(4, 4096, 2, 0, 0, 2) \
        == 4 * 4096 * 4 + 4096 * 4
    assert trms.residual_dtype(BF16, F32) == F32
    assert trms.residual_dtype(F16, None) == F16
    assert trms.fused_norm_takes(BF16, None, F16)
    assert not trms.fused_norm_takes(torch.float8_e5m2, BF16, BF16)
    assert not trms.fused_norm_takes(BF16, BF16, torch.float8_e5m2)
    with pytest.raises(ValueError, match="no kernel"):
        trms._add_rmsnorm_cuda(torch.empty((2, 8), dtype=torch.float8_e5m2,
                                           device="meta"), None,
                               torch.empty((8,), device="meta"), BF16, 1e-6)
