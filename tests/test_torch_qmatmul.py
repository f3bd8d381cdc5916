"""The port's qmatmul (its plain version on the CPU) against the JAX
Pallas kernel in interpret mode: both shape regimes (M <= 32 GEMV and
M > 32 square), the gated epilogue with bias, every activation and the
fused output quantization.  Tolerance 1e-6 in units of |x| @ |w| (the
reference's own ``tests/test_kernels.py`` contract: products are exact,
only the summation order differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.core.formats import get_format as jget  # noqa: E402
from repro.kernels import qmatmul as jq  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402
from repro_torch.kernels import qmatmul as tq  # noqa: E402

FMTS = ["binary8", "binary16", "binary16alt", "binary32"]


def _case(fmt_name, M, K, N, seed, gated=False, bias=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = np.asarray(jqt.encode(jnp.asarray(rng.normal(size=(K, N)),
                                          jnp.float32), fmt_name))
    g = np.asarray(jqt.encode(jnp.asarray(rng.normal(size=(K, N)),
                                          jnp.float32), fmt_name)) \
        if gated else None
    b = rng.normal(size=(N,)).astype(np.float32) if bias else None
    return x, w, g, b


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _scale(x, w, g, b, fmt_name, act):
    xa = np.abs(x)
    wf = np.abs(np.asarray(jqt.decode(jnp.asarray(w), fmt_name)))
    sh = xa @ wf + 1.0
    if b is not None:
        sh = sh + np.abs(b)
    sg = 1.0
    if g is not None:
        sg = xa @ np.abs(np.asarray(jqt.decode(jnp.asarray(g), fmt_name))) \
            + 1.0
    if act == "relu2":
        sg = sg * 2.0 * sh   # d(r^2) = 2 r dr
    return sh * sg


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("mkn", [(1, 256, 384), (3, 100, 70), (40, 96, 130)],
                         ids=["gemv", "ragged", "square"])
def test_qmatmul_matches_pallas_interpret(fmt, mkn):
    M, K, N = mkn
    x, w, _, _ = _case(fmt, M, K, N, seed=M + K)
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jnp.asarray(w), None, fmt,
                                 interpret=True))
    got = tq.qmatmul(_t(x), _t(w), None, fmt).numpy()
    assert got.shape == (M, N)
    err = np.abs(got - want)
    assert (err <= 1e-6 * _scale(x, w, None, None, fmt, None)).all(), \
        err.max()


@pytest.mark.parametrize("fmt", ["binary8", "binary16alt"])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_qmm_ffn_gated_bias_epilogue(fmt, act):
    M, K, N = 5, 128, 96
    x, w, g, b = _case(fmt, M, K, N, seed=17, gated=True, bias=True)
    want = np.asarray(jq.qmm_ffn(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(g), fmt, bias=jnp.asarray(b),
                                 act=act, interpret=True))
    got = tq.qmm_ffn(_t(x), _t(w), _t(g), fmt, bias=_t(b), act=act).numpy()
    err = np.abs(got - want)
    assert (err <= 1e-6 * _scale(x, w, g, b, fmt, act)).all(), err.max()


@pytest.mark.parametrize("out_fmt", ["binary8", "binary16alt"])
def test_fused_output_quantization(out_fmt):
    """out_fmt rounds the epilogue result: equal to quantizing the plain
    result outside, and within one out_fmt ulp of the JAX kernel (the f32
    sums may differ in their last bits)."""
    from repro_torch.core.flexfloat import quantize
    M, K, N = 3, 100, 70
    x, w, g, _ = _case("binary16", M, K, N, seed=5, gated=True)
    of = jget(out_fmt)
    want = np.asarray(jq.qmm_ffn(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(g), "binary16", act="silu",
                                 out_fmt=of, interpret=True))
    got = tq.qmm_ffn(_t(x), _t(w), _t(g), "binary16", act="silu",
                     out_fmt=get_format(out_fmt))
    raw = tq.qmm_ffn(_t(x), _t(w), _t(g), "binary16", act="silu")
    fo = get_format(out_fmt)
    assert torch.equal(got.view(torch.int32),
                       quantize(raw, fo).view(torch.int32))
    ulp = 2.0 ** -of.m * np.abs(want)
    assert (np.abs(got.numpy() - want) <= ulp + 1e-6 *
            _scale(x, w, g, None, "binary16", "silu")).all()


def test_qmatmul_takes_float_weights_and_packed_activations():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    xp = np.asarray(jqt.encode(jnp.asarray(x), "binary16"))
    want = np.asarray(jq.qmatmul(jnp.asarray(xp), jnp.asarray(w), "binary16",
                                 None, interpret=True))
    got = tq.qmatmul(_t(xp), _t(w), "binary16", None).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_hbm_byte_model():
    assert tq.qmm_hbm_bytes(4, 4096, 4096, "binary16alt") == (
        4096 * 4096 * 2 + 4 * 4096 * 4 + 4 * 4096 * 4)
    assert tq.qmm_hbm_bytes(1, 8, 16, "binary8", gated=True, bias=True) == (
        2 * 8 * 16 + 8 * 4 + 16 * 4 + 16 * 4)


A_FMTS = ["binary8", "binary8alt", "binary16", "binary16alt"]


@pytest.mark.parametrize("fmt_b", FMTS + ["binary8alt"])
@pytest.mark.parametrize("fmt_a", A_FMTS)
def test_qmatmul_packed_activations_and_weights(fmt_a, fmt_b):
    """Packed A and packed B in every paper format against the JAX kernel
    in interpret mode, 1e-6 in units of |a| @ |w| (A decoded): the
    operand the CUDA kernel now decodes itself."""
    M, K, N = 5, 96, 70
    rng = np.random.default_rng(len(fmt_a) * 7 + len(fmt_b))
    x = rng.normal(size=(M, K)).astype(np.float32)
    xp = np.asarray(jqt.encode(jnp.asarray(x), fmt_a))
    _, w, _, _ = _case(fmt_b, M, K, N, seed=23)
    want = np.asarray(jq.qmatmul(jnp.asarray(xp), jnp.asarray(w), fmt_a,
                                 fmt_b, interpret=True))
    got = tq.qmatmul(_t(xp), _t(w), fmt_a, fmt_b).numpy()
    xd = np.asarray(jqt.decode(jnp.asarray(xp), fmt_a))
    err = np.abs(got - want)
    assert (err <= 1e-6 * _scale(xd, w, None, None, fmt_b, None)).all(), \
        err.max()
