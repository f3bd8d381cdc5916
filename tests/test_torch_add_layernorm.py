"""``add_layernorm`` (``kernels/layernorm.py``), the layernorm decoder's
norm fused with the residual add before it and the activation cast after
it, on the CPU.

* Its plain version equals the three steps it replaces -- ``residual_add``,
  ``layernorm_plain``, the cast -- bit for bit, for bf16, f16 and f32
  pairs, a mixed pair and no add (``y=None``, the first norm), at d 64,
  384 (whisper-tiny's width), 8192 (command-r-35b's) and 8320 (past the
  kernel's register variants), and a row's bits do not depend on the
  rows beside it (the CUDA kernel, ``add_layernorm_launch`` in
  ``csrc/rmsnorm.cu``, keeps the same order; ``chip_smoke.py`` holds it
  to this plain version bit for bit on the card).
* Against the JAX package: ``x + y`` then the reference's layernorm,
  with ``tests/test_torch_layernorm.py``'s tolerances (1e-6 of the row's
  largest output under binary32; one bf16 ulp plus that under
  transprecision).
* ``layers.add_norm`` takes ``add_layernorm`` for native layernorm over
  f32, bf16 or f16 and the three steps for emulated mode and 8-bit
  dtypes, as it takes ``add_rmsnorm`` for rmsnorm.
* Reduced command-r-35b: the logits of a prefill chunk, a decode step
  and a verify step on the fused route equal those of the three-step
  composition bit for bit, and a decode step makes 2 L + 1 fused norms
  and no standalone residual add.
* A tensor off the CPU takes the kernel's dispatch, never the plain
  version, and the launch passes the entry point's arguments.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import layernorm as tln  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.models import layers, qparams, transformer  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
ROW_COUNTS = (1, 2, 4, 9, 16, 33, 64)


def _pair(rows, d, xdt, ydt, seed=0):
    rng = np.random.default_rng(seed + d)
    x = torch.from_numpy((rng.normal(size=(rows, d)) * 3.0 + 1.5)
                         .astype(np.float32)).to(xdt)
    y = torch.from_numpy((rng.normal(size=(rows, d)) * 2.0)
                         .astype(np.float32)).to(ydt)
    gamma = torch.from_numpy((1.0 + rng.normal(size=(d,)) * 0.1)
                             .astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=(d,)) * 0.1)
                            .astype(np.float32))
    return x, y, gamma, beta


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


# (x dtype, y dtype or None, out dtype)
DTYPES = [(BF16, BF16, BF16), (F32, F32, F32), (F16, F16, F16),
          (F32, BF16, BF16), (BF16, None, BF16), (F32, None, F32)]


@pytest.mark.parametrize("d", [64, 384, 8192, 8320])
@pytest.mark.parametrize("xdt,ydt,odt", DTYPES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_plain_is_the_three_steps_and_free_of_the_row_count(xdt, ydt, odt,
                                                            d):
    x, y, gamma, beta = _pair(64, d, xdt, ydt or xdt)
    y = None if ydt is None else y
    s, n = tln.add_layernorm(x, y, gamma, beta, odt)
    want_s = x if y is None else trms.residual_add(x, y)
    want_n = tln.layernorm_plain(want_s, gamma, beta).to(odt)
    assert s.dtype == trms.residual_dtype(xdt, ydt) == want_s.dtype
    assert n.dtype == odt
    assert torch.equal(_bits(s), _bits(want_s))
    assert torch.equal(_bits(n), _bits(want_n))
    for m in ROW_COUNTS:
        sm, nm = tln.add_layernorm(x[:m], None if y is None else y[:m],
                                   gamma, beta, odt)
        assert torch.equal(_bits(sm), _bits(s[:m])), m
        assert torch.equal(_bits(nm), _bits(n[:m])), m


def _jarr(t):
    if t.dtype == BF16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("d", [384, 8192])
@pytest.mark.parametrize("pol", ["transprecision", "binary32"])
def test_matches_jax_residual_add_and_layernorm(pol, d):
    """The reference's ``x + y`` then its layernorm (XLA excess precision
    off).  Its ``mean`` sums in another order, so: 1e-6 of the row's
    largest output under binary32, one bf16 ulp plus that under
    transprecision (where beta cancels the normalized term, a few f32
    ulps are many bf16 ulps of a tiny output)."""
    dt = BF16 if pol == "transprecision" else F32
    x, y, gamma, beta = _pair(16, d, dt, dt, seed=3)
    jpol = jget_policy(pol)
    fn = jax.jit(lambda a, b, g, be: jlayers.layernorm(a + b, g, be, jpol),
                 compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(fn(_jarr(x), _jarr(y), jnp.asarray(gamma.numpy()),
                         jnp.asarray(beta.numpy())))
    _, got = layers.add_norm(x, y, {"gamma": gamma, "beta": beta},
                             get_policy(pol), "layernorm")
    assert got.dtype == dt
    got = got.to(F32).numpy()
    mag = np.abs(want)
    if dt == BF16:
        ulp = (mag.view(np.uint16) + 1).view(mag.dtype).astype(np.float32) \
            - mag.astype(np.float32)
    else:
        ulp = np.zeros(mag.shape, np.float32)
    want = want.astype(np.float32)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= ulp + 1e-6 * scale).all()


def test_add_norm_picks_the_route_by_kind_policy_and_dtype(monkeypatch):
    taken = []
    for name in ("add_rmsnorm", "add_layernorm"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **k:
                            taken.append(_n) or _f(*a, **k))
    x, y, gamma, beta = _pair(4, 256, BF16, BF16)
    p = {"gamma": gamma, "beta": beta}
    nat = get_policy("transprecision")
    cases = [
        (x, y, nat, "layernorm", "add_layernorm"),
        (x, None, nat, "layernorm", "add_layernorm"),
        (x.float(), y.float(), get_policy("binary32"), "layernorm",
         "add_layernorm"),
        (x.half(), y.half(), get_policy("binary32"), "layernorm",
         "add_layernorm"),
        (x, y, nat, "rmsnorm", "add_rmsnorm"),
        (x.float(), y.float(), get_policy("transprecision", mode="emulated"),
         "layernorm", None),
        (x.to(torch.float8_e5m2), y.to(torch.float8_e5m2), nat, "layernorm",
         None),
        (x, y, nat.with_overrides(act="binary8"), "layernorm", None),
    ]
    for xi, yi, pol, kind, want in cases:
        taken.clear()
        s, n = layers.add_norm(xi, yi, p, pol, kind)
        assert taken == ([want] if want else []), (xi.dtype, pol.mode, kind)
        want_s = xi if yi is None else layers.residual_add(xi, yi)
        assert torch.equal(_bits(s), _bits(want_s))
        assert torch.equal(_bits(n),
                           _bits(layers.apply_norm(want_s, p, pol, kind)))


def _three_steps(x, y, p, policy, kind):
    """The parent's composition: the add, the norm kernel, the cast."""
    s = x if y is None else layers.residual_add(x, y)
    return s, layers.apply_norm(s, p, policy, kind)


def _setup(pol_name, batch=2):
    model, cfg = build("command-r-35b", reduced=True)
    pol = get_policy(pol_name, decode_impl="paged", matmul_impl="qmm_pallas")
    params = qparams.encode_params(model.init_params(
        torch.Generator().manual_seed(0), pol, device="cpu"), pol)
    tables = np.arange(2 * batch, dtype=np.int32).reshape(batch, 2)
    st = [tpc.set_block_tables(tpc.init_paged_cache(
        batch, 2 * batch, 8, 2, cfg.n_kv, cfg.head_dim,
        pol.dtype("kv_cache"), device="cpu"), tables)
        for _ in range(cfg.n_layers)]
    return model, cfg, pol, params, st


def _logits(pol_name):
    """A prefill chunk a slot, a decode step and a verify step of reduced
    command-r-35b under ``qmm_pallas`` / ``paged``, weights from the
    port's init (seed 0)."""
    model, cfg, pol, params, st = _setup(pol_name)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 12))
                            .astype(np.int32))
    out = []
    for slot in (0, 1):
        lc, st, _ = model.prefill_chunk(params, toks, st, [None] * len(st),
                                        pol, slot=slot, q_offset=0)
        out.append(lc)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2))
                           .astype(np.int32))
    ld, _ = model.decode_step(params, nxt[:, :1], st, pol)
    lv, _ = model.verify_step(params, nxt, st, pol)
    return out + [ld, lv]


@pytest.mark.parametrize("pol_name", ["transprecision", "binary32"])
def test_fused_route_logits_equal_the_three_steps(pol_name, monkeypatch):
    fused = _logits(pol_name)
    with monkeypatch.context() as m:
        m.setattr(transformer, "add_norm", _three_steps)
        plain = _logits(pol_name)
    assert len(fused) == len(plain) == 4
    for a, b in zip(fused, plain):
        assert torch.equal(_bits(a), _bits(b))


def test_a_decode_step_makes_one_fused_norm_a_norm(monkeypatch):
    """Reduced command-r-35b, one decode step: 2 L + 1 ``add_layernorm``
    calls, the first without an add, and no residual add or three-step
    norm outside them."""
    calls, apart = [], []
    real = layers.add_layernorm
    monkeypatch.setattr(layers, "add_layernorm", lambda x, y, *a, **k: (
        calls.append(y is None), real(x, y, *a, **k))[1])
    for name in ("residual_add", "apply_norm"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=fn:
                            apart.append(_n) or _f(*a))
    model, cfg, pol, params, st = _setup("transprecision", batch=1)
    model.decode_step(params, torch.tensor([[5]], dtype=torch.int32), st,
                      pol)
    assert calls == [True] + [False] * (2 * cfg.n_layers)
    assert apart == []


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(tln, "add_layernorm_plain",
                        lambda *a: pytest.fail("plain version on meta"))
    monkeypatch.setattr(tln, "_add_layernorm_cuda",
                        lambda x, y, g, b, odt, eps: seen.append(
                            (x.device, y.device, odt)))
    x = torch.empty((4, 128), dtype=BF16, device="meta")
    p = torch.empty((128,), device="meta")
    tln.add_layernorm(x, x, p, p, BF16)
    assert seen == [(torch.device("meta"), torch.device("meta"), BF16)]


@pytest.mark.parametrize("with_y", [True, False])
def test_the_launch_passes_the_entry_points_arguments(monkeypatch, with_y):
    """``launch_fused`` on meta tensors, the library call recorded (each
    pointer as its tensor): one argument for each of
    ``add_layernorm_launch``'s parameters in its order (x, y, gamma,
    beta, res, out, rows, d, eps, the four dtype codes, the stream), and
    no residual buffer without an add."""
    seen = []
    # meta stands in for a CUDA tensor: routed as one (on meta itself the
    # launch takes the shape route, tests/test_torch_dryrun.py)
    monkeypatch.setattr(trms, "route", lambda t: "cuda")
    monkeypatch.setattr(trms.LIB, "launch", lambda sym, *a, kernel=None:
                        seen.append((sym, a, kernel)))
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: "stream")
    x = torch.empty((3, 2, 384), dtype=F32, device="meta")
    y = torch.empty((3, 2, 384), dtype=BF16, device="meta") if with_y \
        else None
    gamma = torch.empty((384,), device="meta")
    beta = torch.empty((384,), device="meta")
    s, n = tln.add_layernorm(x, y, gamma, beta, F16)
    assert s.dtype == F32 and n.dtype == F16 and (s is x) != with_y
    ((sym, args, kernel),) = seen
    assert sym == "add_layernorm_launch" and kernel == "add_layernorm"
    assert len(args) == len(trms.LIB.signatures[sym]) == 14
    assert args[0] is x and args[1] is y
    assert args[2] is gamma and args[3] is beta
    assert args[4] is (s if with_y else None) and args[5] is n
    assert args[6:9] == (6, 384, 1e-5)
    assert args[9:] == (0, 1 if with_y else 0, 0, 2, "stream")


def test_bytes_and_dtypes_the_kernel_takes():
    assert tln.add_layernorm_hbm_bytes(4, 8192, 2, 2, 2, 2) \
        == 4 * 8192 * 8 + 2 * 8192 * 4
    assert tln.add_layernorm_hbm_bytes(4, 8192, 2, 0, 0, 2) \
        == 4 * 8192 * 4 + 2 * 8192 * 4
    with pytest.raises(ValueError, match="no kernel"):
        tln._add_layernorm_cuda(torch.empty((2, 8), dtype=torch.float8_e5m2,
                                            device="meta"), None,
                                torch.empty((8,), device="meta"),
                                torch.empty((8,), device="meta"), BF16, 1e-5)
    with pytest.raises(ValueError, match="beta must be"):
        tln._add_layernorm_cuda(torch.empty((2, 8), device="meta"), None,
                                torch.empty((8,), device="meta"),
                                torch.empty((4,), device="meta"), BF16, 1e-5)
