"""The port's ``kernels/ops.py`` (the cast kernels' plain versions on the
CPU) against the JAX package's ``repro.kernels.ops``: ``cast``, ``pack``
and ``unpack`` bit for bit (NaN included: both codecs write the canonical
quiet NaN) against the Pallas kernels in interpret mode
(``use_pallas=True``) and against the jnp oracles (``use_pallas=False``),
on ragged, 0-d, 1-d and 3-d inputs, for the paper's formats, binary8alt
and arbitrary flexfloat formats; ``matmul`` within 1e-6 in units of
|a| @ |b|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402
from repro_torch.kernels import flexfloat_cast as tff  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FORMATS = ["binary8", "binary8alt", "binary16", "binary16alt", "binary32",
           "flexfloat<6,9>", "flexfloat<3,4>"]
SHAPES = [(), (1,), (37,), (7, 129), (3, 5, 11)]


def _jfmt(name):
    from repro.core.formats import FpFormat as JFmt
    f = get_format(name)
    return JFmt(f.e, f.m)


def _rand(shape, seed):
    """Normal values at a wide scale, uniform f32 bit patterns, and the
    specials (+/-Inf, NaN, signed zeros, f32 denormals, huge values)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    x = rng.normal(scale=4.0, size=n).astype(np.float32)
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    x[1::2] = bits[1::2].view(np.float32)
    specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-30, -3e38,
                         6e-8, 1e-45], np.float32)
    k = min(n, len(specials))
    x[:k] = specials[:k]
    return x.reshape(shape)


def _same_bits(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel", "oracle"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_cast_pack_unpack_bit_identical_to_jax(fmt, shape, use_pallas):
    x = _rand(shape, seed=len(shape) * 7 + get_format(fmt).m)
    jf = _jfmt(fmt)
    xt = torch.from_numpy(x.copy())
    for saturate in (False, True):
        _same_bits(tops.cast(xt, fmt, saturate=saturate,
                             use_pallas=use_pallas),
                   jops.cast(jnp.asarray(x), jf, saturate=saturate,
                             use_pallas=use_pallas))
    want_p = jops.pack(jnp.asarray(x), jf, use_pallas=use_pallas)
    got_p = tops.pack(xt, fmt, use_pallas=use_pallas)
    _same_bits(got_p, want_p)
    _same_bits(tops.unpack(got_p, fmt, use_pallas=use_pallas),
               jops.unpack(want_p, jf, use_pallas=use_pallas))


@pytest.mark.parametrize("fmt", ["binary8", "binary8alt", "binary16",
                                 "binary16alt", "flexfloat<6,9>"])
def test_unpack_every_container_pattern(fmt):
    """Every 2^8 / 2^16 container pattern through unpack, and through
    pack(unpack(.)), against the JAX kernels in interpret mode."""
    f = get_format(fmt)
    pats = np.arange(1 << f.bits, dtype=np.int64).astype(
        {1: np.uint8, 2: np.uint16}[f.container_bytes])
    jf = _jfmt(fmt)
    want = jops.unpack(jnp.asarray(pats), jf)
    got = tops.unpack(torch.from_numpy(pats.copy()), fmt)
    _same_bits(got, want)
    _same_bits(tops.pack(got, fmt), jops.pack(want, jf))


def test_binary32_cast_returns_its_input():
    x = torch.randn(5)
    assert tff.flexfloat_cast(x, "binary32") is x


def test_byte_model():
    assert tff.elementwise_hbm_bytes(10, 4, 1) == 50


MATMUL_CASES = [("binary8", "binary8", None, (5, 33, 7)),
                ("binary16", "binary16alt", "binary32", (3, 64, 17)),
                (None, "binary8", None, (9, 40, 24)),
                (None, "binary16alt", None, (1, 128, 70))]


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel", "oracle"])
@pytest.mark.parametrize("fmt_a,fmt_b,out_fmt,mkn", MATMUL_CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}" for c in MATMUL_CASES])
def test_matmul_matches_jax(fmt_a, fmt_b, out_fmt, mkn, use_pallas):
    from repro.core.qtensor import decode as jdecode
    from repro.core.qtensor import encode as jencode
    m, k, n = mkn
    rng = np.random.default_rng(m * n)
    a = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(k, n)), jnp.float32)
    ap = jencode(a, _jfmt(fmt_a)) if fmt_a else a
    bp = jencode(b, _jfmt(fmt_b)) if fmt_b else b
    want = np.asarray(jops.matmul(
        ap, bp, _jfmt(fmt_a) if fmt_a else None,
        _jfmt(fmt_b) if fmt_b else None,
        _jfmt(out_fmt) if out_fmt else None, use_pallas=use_pallas))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = tops.matmul(t(ap), t(bp), fmt_a, fmt_b, out_fmt,
                      use_pallas=use_pallas).numpy()
    ad = np.abs(np.asarray(jdecode(ap, _jfmt(fmt_a)) if fmt_a else a))
    bd = np.abs(np.asarray(jdecode(bp, _jfmt(fmt_b)) if fmt_b else b))
    unit = ad @ bd + 1.0
    assert got.shape == (m, n)
    assert np.all(np.abs(got - want) <= 1e-6 * unit)


def test_ref_is_the_plain_path():
    x = torch.from_numpy(_rand((4, 9), 3))
    assert torch.equal(tref.flexfloat_cast_ref(x, "binary8").view(
        torch.int32), tff.flexfloat_cast_plain(x, "binary8").view(
        torch.int32))
    assert torch.equal(tref.quantize_encode_ref(x, "binary16"),
                       tff.quantize_encode_plain(x, "binary16"))
