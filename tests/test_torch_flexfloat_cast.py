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


# --- the pack kernel's plan: the kernel a format takes, the vector width
# and grid, and the fused arithmetic of the specialised kernels ---------

SPECIALISED = ["binary8", "binary8alt", "binary16", "binary16alt"]
RUN_TIME = ["flexfloat<6,9>", "flexfloat<3,4>", "binary32",
            "flexfloat<8,15>", "flexfloat<5,11>", "flexfloat<8,23>"]


@pytest.mark.parametrize("fmt", SPECIALISED + RUN_TIME)
def test_encode_kernel_is_picked_by_the_format(fmt):
    """Exactly the paper's four formats have a pack kernel of their own;
    any other (e, m), every u32 format among them, takes the run-time
    codec of its container."""
    want = fmt if fmt in SPECIALISED else "run-time"
    assert tff.encode_kernel(fmt) == want
    assert tff.encode_kernel(get_format(fmt)) == want
    if get_format(fmt).container_bytes == 4:
        assert want == "run-time"


# n of a 0-d input (1), 1-d ragged lengths around the vector widths, a
# 3-d and a llama3-8b FFN weight's element count
COVER_N = [1, 3, 4, 7, 8, 9, 15, 16, 17, 31, 33, 100_003, 3 * 1021 * 7]


def _encode_cover(n: int, vec: int, blocks: int) -> np.ndarray:
    """How many times the encode kernel writes each of n elements under
    ``tff.encode_plan``'s (vec, blocks): thread i of the grid writes
    elements [i * vec, (i + 1) * vec) when i < n // vec, and element
    n // vec * vec + i when that is below n (vec = 0: element i).  The
    plan is right when every count is 1."""
    i = np.arange(blocks * tff.ENCODE_THREADS)
    nv = n // vec if vec else 0
    hits = np.zeros(n, np.int64)
    trips = i[i < nv]
    np.add.at(hits, (trips[:, None] * vec + np.arange(vec)).ravel(), 1)
    tail = nv * vec + i
    np.add.at(hits, tail[tail < n], 1)
    return hits


@pytest.mark.parametrize("aligned", [True, False], ids=["16B", "scalar"])
@pytest.mark.parametrize("container_bytes", [1, 2, 4])
@pytest.mark.parametrize("n", COVER_N)
def test_encode_plan_writes_every_element_once(n, container_bytes,
                                               aligned):
    vec, blocks = tff.encode_plan(n, container_bytes, aligned)
    assert vec == (16 // container_bytes if aligned else 0)
    hits = _encode_cover(n, vec, blocks)
    assert hits.shape == (n,) and bool((hits == 1).all())
    # no thread without work beyond the last block
    assert (blocks - 1) * tff.ENCODE_THREADS < max(n // vec, n % vec, 1) \
        if vec else (blocks - 1) * tff.ENCODE_THREADS < n


def test_encode_plan_at_the_weight_shape():
    """A 4096 x 14336 weight: one 16-byte store a thread, 8 bf16 or 16
    binary8 containers, a thread per store."""
    n = 4096 * 14336
    assert tff.encode_plan(n, 2, True) == (8, n // 8 // 256)
    assert tff.encode_plan(n, 1, True) == (16, n // 16 // 256)
    assert tff.encode_plan(n, 2, False) == (0, n // 256)
    assert tff.encode_plan(5, 2, True) == (8, 1)


def _pack_inputs(fmt, seed):
    """Every container pattern's value, the midpoints of neighbours (the
    ties), one f32 ulp either side of each, just past the largest value,
    seeded f32 bit patterns and the specials."""
    from repro_torch.kernels import codec as tcodec
    f = get_format(fmt)
    pats = torch.arange(1 << f.bits, dtype=torch.int64).to(f.container_dtype)
    vals = tcodec.decode_tile(pats, f)
    fin = vals[torch.isfinite(vals)].double().unique()
    mids = ((fin[1:] + fin[:-1]) / 2).float()
    top = torch.tensor([f.max_normal * (1 + 2.0 ** -(f.m + 1))]).float()
    base = torch.cat([vals, mids, top, -top])
    near = [torch.nextafter(base, torch.full_like(base, s))
            for s in (float("inf"), float("-inf"))]
    rand = torch.from_numpy(_rand((200_000,), seed))
    return torch.cat([base, *near, rand])


@pytest.mark.parametrize("fmt", SPECIALISED + ["flexfloat<8,9>",
                                               "flexfloat<3,4>"])
def test_fused_encode_is_bit_identical_to_jax(fmt):
    """``codec.encode_fused``, the specialised pack kernels' arithmetic
    in PyTorch, against the JAX codec's quantize then encode on every
    pattern, tie and boundary of the format and seeded f32 bits."""
    from repro.kernels import codec as jcodec
    from repro_torch.kernels import codec as tcodec
    f = get_format(fmt)
    x = _pack_inputs(fmt, seed=f.m)
    want = jcodec.encode_tile(
        jcodec.quantize_tile(jnp.asarray(x.numpy()), f.e, f.m), _jfmt(fmt))
    _same_bits(tcodec.encode_fused(x, f), want)
    _same_bits(tff.quantize_encode_plain(x, f), want)
