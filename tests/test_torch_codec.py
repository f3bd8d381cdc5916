"""The port's plain codec held bit-identical to the JAX codec.

Every 2^8 / 2^16 container pattern through ``decode_tile``, and dense f32
sweeps (uniform bit patterns plus each format's edges and round-to-even
ties) through ``quantize_tile`` and ``encode_tile``, for the paper's
formats, binary8alt and two arbitrary flexfloat formats.  Also: torch's
CPU f32 -> float8_e5m2 / bfloat16 casts (the port's KV write and
activation cast) against the codec, and the packed-store bitcast path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import codec as jcodec  # noqa: E402
from repro_torch.core import qtensor as tq  # noqa: E402
from repro_torch.core.formats import (BINARY8, BINARY8ALT, BINARY16,  # noqa: E402
                                      BINARY16ALT, BINARY32, FpFormat)
from repro_torch.kernels import codec as tcodec  # noqa: E402

FORMATS = [BINARY8, BINARY8ALT, BINARY16, BINARY16ALT, BINARY32,
           FpFormat(6, 5), FpFormat(3, 4)]
IDS = [f.name for f in FORMATS]


def _jfmt(fmt):
    from repro.core.formats import FpFormat as JFmt
    return JFmt(fmt.e, fmt.m)


def _f32_sweep(fmt, n=60_000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    with np.errstate(over="ignore"):
        edges = _edges(fmt)
    k = np.arange(1, 64, dtype=np.float32)
    half = (1.0 + (2 * k + 1) * 2.0 ** (-fmt.m - 1)).astype(np.float32)
    sub = rng.integers(0, 2**23, size=20_000, dtype=np.uint32).view(
        np.float32)
    return np.concatenate([x, edges, half, -half, sub, -sub])


def _edges(fmt):
    return np.array([0.0, -0.0, fmt.min_denormal, fmt.min_normal,
                      fmt.max_normal, np.inf, -np.inf, np.nan,
                      fmt.max_normal * (1 + 2.0 ** (-fmt.m - 1)),
                      fmt.max_normal * (1 + 2.0 ** (-fmt.m)),
                      fmt.min_denormal / 2, fmt.min_denormal * 0.4999,
                      fmt.min_denormal * 1.5, 1.0, -1.0], dtype=np.float32)


def _bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.uint32)


def _torch_f32(a: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f.bits <= 16],
                         ids=[f.name for f in FORMATS if f.bits <= 16])
def test_decode_every_container_pattern_bit_identical(fmt):
    n = 1 << fmt.bits
    pats = np.arange(n, dtype=np.uint32)
    want = jcodec.decode_tile(jnp.asarray(pats), _jfmt(fmt))
    got = tcodec.decode_tile(torch.from_numpy(pats.astype(np.int64)), fmt)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
@pytest.mark.parametrize("saturate", [False, True], ids=["ieee", "sat"])
def test_quantize_and_encode_sweep_bit_identical(fmt, saturate):
    x = _f32_sweep(fmt, seed=fmt.bits)
    jq = jcodec.quantize_tile(jnp.asarray(x), fmt.e, fmt.m, saturate)
    tq_ = tcodec.quantize_tile(_torch_f32(x), fmt.e, fmt.m, saturate)
    np.testing.assert_array_equal(_bits(tq_.numpy()), _bits(jq))
    je = np.asarray(jcodec.encode_tile(jq, _jfmt(fmt))).astype(np.int64)
    te = tcodec.encode_tile(tq_, fmt)
    assert te.dtype == fmt.container_dtype
    np.testing.assert_array_equal(te.to(torch.int64).numpy(), je)
    # and back: decode(encode(quantize(x))) == quantize(x)
    back = tcodec.decode_tile(te, fmt)
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(jq))


@pytest.mark.parametrize("fmt", [BINARY8, BINARY16ALT], ids=lambda f: f.name)
def test_stochastic_rounding_from_shared_random_bits(fmt):
    """The reference draws its bits from a JAX key inside the call; the
    port takes them explicitly -- the same bits give the same result."""
    x = _f32_sweep(fmt, n=50_000, seed=3)
    key = jax.random.PRNGKey(7)
    rbits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    want = jcodec.quantize_tile(jnp.asarray(x), fmt.e, fmt.m, False, key)
    got = tcodec.quantize_tile(_torch_f32(x), fmt.e, fmt.m, False,
                               torch.from_numpy(rbits.astype(np.int64)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("fmt,dtype", [(BINARY8, torch.float8_e5m2),
                                       (BINARY16ALT, torch.bfloat16),
                                       (BINARY16, torch.float16)],
                         ids=["e5m2", "bf16", "f16"])
def test_torch_cpu_casts_match_the_codec(fmt, dtype):
    """The KV write and activation casts are torch casts: bit-identical to
    round-to-nearest-even encode on every non-NaN input (NaN stays NaN;
    its payload is torch's own)."""
    x = _f32_sweep(fmt, seed=11)
    xt = _torch_f32(x)
    got = xt.to(dtype).view(fmt.container_dtype).to(torch.int64)
    want = tcodec.encode_tile(tcodec.quantize_tile(xt, fmt.e, fmt.m),
                              fmt).to(torch.int64)
    nan = torch.isnan(xt)
    assert bool(((got == want) | nan).all())
    assert bool(torch.isnan(tcodec.decode_tile(got[nan], fmt)).all())


@pytest.mark.parametrize("fmt", [BINARY8, BINARY16, BINARY16ALT, BINARY32],
                         ids=lambda f: f.name)
def test_qtensor_bitcast_path_equals_codec_path(fmt):
    """Packing a native-dtype tensor is a bitcast; it equals round + pack."""
    x = _torch_f32(_f32_sweep(fmt, n=20_000, seed=5))
    x = x[torch.isfinite(x)].to(fmt.native_dtype)
    fast = tq.encode(x, fmt)
    slow = tcodec.encode_tile(tcodec.quantize_tile(x.to(torch.float32),
                                                   fmt.e, fmt.m), fmt)
    assert fast.dtype == slow.dtype == fmt.container_dtype
    np.testing.assert_array_equal(fast.to(torch.int64).numpy(),
                                  slow.to(torch.int64).numpy())
    q = tq.QTensor.quantize(x, fmt)
    np.testing.assert_array_equal(q.dequantize().numpy(),
                                  x.to(torch.float32).numpy())


def test_chunked_codec_equals_one_call(monkeypatch):
    """Large tensors run the bit math in slices; the result is the same."""
    x = _torch_f32(_f32_sweep(BINARY8, n=5_000, seed=9))
    whole = tcodec.encode_tile(tcodec.quantize_tile(x, 5, 2), BINARY8)
    monkeypatch.setattr(tcodec, "_CHUNK", 777)
    sliced = tcodec.encode_tile(tcodec.quantize_tile(x, 5, 2), BINARY8)
    assert torch.equal(whole, sliced)
    assert torch.equal(tcodec.decode_tile(whole, BINARY8).view(torch.int32),
                       tcodec.decode_tile(sliced, BINARY8).view(torch.int32))
