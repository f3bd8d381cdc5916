"""Training gradients in the port against the JAX package, and the
differentiable kernels.

* Gradients against ``jax.grad`` under binary32 on reduced llama3-8b,
  granite-moe, rwkv6, recurrentgemma, paligemma and whisper (the
  reference's params and numpy batch, ``test_torch_train._setup``):
  the loss within 1e-5 relative and every leaf within 1e-4 x its max
  |g| (measured: within 4e-6).  The MoE experts' weights are the
  exception, within 2^-8 x max |g| (bf16's precision; measured:
  3.4e-4): in native mode both packages compute the grouped expert
  product on bf16-rounded operands (the reference's ``_grouped_xla``,
  f32 operands included), so those weights' grads sum bf16-rounded
  terms, rounded at other places in each package, and the two land an
  ulp or two apart (9 of 8192 elements of a w_out differ by more than
  one ulp of themselves).
* ``flash_prefill_diff`` against ``jax.vjp`` of the reference's (its
  Pallas forward in interpret mode, its XLA recompute backward), with a
  window, a prefix and a q offset: the output within 1e-6, the grads
  within 1e-5 x max |g|.
* The fused norms' ``autograd.Function`` (a kernel forward, a plain
  recompute backward) gives the plain version's gradients bit for bit;
  a kernel launch that would drop a gradient raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import flatten_with_path  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import layernorm as tln  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

from test_torch_train import BF16, GRAD_ARCHS, _rel, _setup  # noqa: E402


def _jleaves_by_path(jtree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (("k", k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (("i", i),))
        else:
            out[path] = np.asarray(t, np.float32)
    walk(jtree, ())
    return out


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grads_binary32(arch):
    (jm, jp, jparams, b), (m, tp, tparams, tb) = _setup(arch, "binary32")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, b, jp)))(jparams)
    loss, grads = loss_and_grads(m, tparams, tb, tp)
    assert _rel(loss, jl) <= 1e-5
    want = _jleaves_by_path(jg)
    got = flatten_with_path(grads)
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        g = g.float().numpy()
        assert g.shape == w.shape, path
        names = [k for _, k in path]
        experts = "ffn" in names and m.cfg.moe_experts \
            and names[-1] != "router"
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= (2.0 ** -8 if experts else 1e-4), (path, err)


PREFILL_CASES = [  # Sq, Skv, q_offset, window, prefix_len
    (16, 16, 0, None, 0), (8, 24, 16, None, 0), (16, 16, 0, 5, 0),
    (16, 16, 0, None, 6), (8, 20, 12, 7, 3)]


@pytest.mark.parametrize("Sq,Skv,q_offset,window,prefix", PREFILL_CASES)
def test_flash_prefill_diff_matches_reference_vjp(Sq, Skv, q_offset, window,
                                                  prefix):
    rng = np.random.default_rng(Sq + Skv + q_offset)
    B, H, G, dh = 2, 2, 2, 8
    q = rng.normal(size=(B, Sq, H, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, H, dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, H, dh)).astype(np.float32)
    g = rng.normal(size=q.shape).astype(np.float32)
    scale = float(1 / np.sqrt(dh))
    kw = dict(window=window, prefix_len=prefix, q_offset=q_offset)
    want, vjp = jax.vjp(lambda a, b_, c: jfa.flash_prefill_diff(
        a, b_, c, scale=scale, **kw), q, k, v)
    wants = vjp(jnp.asarray(g))
    xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tfa.flash_prefill_diff(*xs, scale=scale, **kw)
    assert type(out.grad_fn).__name__ == "PrefillDiffFnBackward"
    assert np.abs(out.detach().numpy() - np.asarray(want)).max() <= 1e-6
    gots = torch.autograd.grad(out, xs, torch.tensor(g))
    for got, w in zip(gots, wants):
        w = np.asarray(w)
        err = np.abs(got.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, err


def test_training_attention_goes_through_prefill_diff():
    """``_prefill_flash`` sends float K/V that need a gradient through
    ``flash_prefill_diff``; without grad (serving) the plain call."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(1, 8, 2, 2, 8)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(1, 8, 2, 8)), dtype=torch.float32)
    pol = get_policy("binary32")
    kw = dict(scale=0.25, policy=pol, window=None, prefix_len=0, chunk=None)
    out = tatt._prefill_flash(q, k.requires_grad_(), k, **kw)
    assert type(out.grad_fn).__name__ == "PrefillDiffFnBackward"
    with torch.no_grad():
        plain = tatt._prefill_flash(q, k, k, **kw)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def _norm_cases():
    rng = np.random.default_rng(5)

    def t(shape, dt=torch.float32):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32) \
            .to(dt)
    return [("rms", t((3, 40)), None, t((40,)) * 0.1, None, BF16),
            ("rms", t((3, 40), BF16), t((3, 40), BF16), t((40,)) * 0.1,
             None, BF16),
            ("rms", t((2, 5, 130)), t((2, 5, 130), BF16), t((130,)), None,
             torch.float32),
            ("ln", t((3, 40), BF16), t((3, 40), BF16), t((40,)), t((40,)),
             BF16),
            ("ln", t((4, 384)), None, t((384,)), t((384,)), torch.float32)]


@pytest.mark.parametrize("case", range(5))
def test_fused_norm_function_gives_the_plain_gradients(case):
    """``FusedNormFn`` with the plain version standing in for the kernel
    launch: outputs and the grads of x, y, gamma (and beta) equal a
    direct autograd of the plain version, bit for bit."""
    kind, x, y, gamma, beta, odt = _norm_cases()[case]
    params = (gamma,) if kind == "rms" else (gamma, beta)
    plain = (trms.add_rmsnorm_plain if kind == "rms"
             else tln.add_layernorm_plain)
    launches = []

    def launch(*a):
        launches.append(1)
        with torch.no_grad():
            return plain(*a, odt)

    def run(fn):
        ins = [t if t is None else t.clone().requires_grad_()
               for t in (x, y) + params]
        s, out = fn(*ins)
        gs = torch.randn(s.shape, generator=torch.Generator().manual_seed(1))
        go = torch.randn(out.shape,
                         generator=torch.Generator().manual_seed(2))
        loss = (out.float() * go).sum()
        if y is not None:   # else s is x itself, outside both functions
            loss = loss + (s.float() * gs).sum()
        live = [t for t in ins if t is not None]
        return (s, out), torch.autograd.grad(loss, live)

    got_out, got = run(lambda *a: trms.fused_norm_diff(
        launch, lambda *b: plain(*b, odt), *a))
    want_out, want = run(lambda *a: plain(*a, odt))
    assert launches == [1]
    for a, b in zip(got_out + got, want_out + want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_kernel_launch_never_drops_a_gradient():
    """On a non-CPU tensor (``meta`` stands in for the card) an operand
    that requires grad reaches the kernel only through its Function:
    the fused norms' forward runs with grad mode off; a direct launch
    raises; under ``torch.no_grad`` the serving call is unchanged."""
    meta = dict(device="meta")
    x = torch.empty((4, 128), dtype=BF16, **meta).requires_grad_()
    gamma = torch.empty((128,), **meta)
    seen = []

    def fake_launch(x_, y_, g_, odt, eps):
        seen.append(torch.is_grad_enabled())
        return x_.detach() if y_ is None else torch.empty_like(x_), \
            torch.empty(x_.shape, dtype=odt, device="meta")
    real = trms._add_rmsnorm_cuda
    trms._add_rmsnorm_cuda = fake_launch
    try:
        s, out = trms.add_rmsnorm(x, x, gamma, BF16)
        assert type(out.grad_fn).__name__ == "FusedNormFnBackward"
        with torch.no_grad():
            trms.add_rmsnorm(x, x, gamma, BF16)
    finally:
        trms._add_rmsnorm_cuda = real
    assert seen == [False, False]
    with pytest.raises(RuntimeError, match="records no gradient"):
        _build.check_operands("add_rmsnorm", x.device, x=x)
    with pytest.raises(RuntimeError, match="records no gradient"):
        tfa._prefill_cuda(torch.empty((1, 4, 1, 1, 8), **meta)
                          .requires_grad_(), torch.empty((1, 4, 1, 8), **meta),
                          torch.empty((1, 4, 1, 8), **meta), None, 0.5, None,
                          0, 0)
    from repro_torch.kernels import flexfloat_cast
    with pytest.raises(RuntimeError, match="records no gradient"):
        flexfloat_cast.flexfloat_cast(torch.empty(8, **meta)
                                      .requires_grad_(), "binary8")
