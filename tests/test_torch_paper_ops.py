"""The port's paper-half operators held to the JAX package, bit for bit.

* word packing: ``kernels/codec.pack_word_tile`` / ``unpack_word_tile``
  and ``core/qtensor.pack_words`` / ``unpack_words`` for every container
  width (uint8, uint16, uint32), and ``QTensor.to_native`` /
  ``from_native`` for the formats with a native dtype;
* the FlexFloat operators (``ff_add/sub/mul/div/fma/cast``,
  ``quantization_error``) and ``quantize_pytree`` for the four paper
  formats and a run-time (6, 9), on seeded numpy inputs that are members
  of their formats;
* ``core/energy.cost`` of the reference cache's binary32 baseline stats
  equal to the cache's baseline cost, for every app.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import flexfloat as jff  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.core.formats import FpFormat as JFmt  # noqa: E402
from repro.kernels import codec as jcodec  # noqa: E402
from repro_torch.core import energy, flexfloat as tff  # noqa: E402
from repro_torch.core import qtensor as tqt  # noqa: E402
from repro_torch.core.formats import (BINARY8, BINARY16, BINARY16ALT,  # noqa: E402
                                      BINARY32, FpFormat, get_format)
from repro_torch.core.stats import OpStats  # noqa: E402
from repro_torch.kernels import codec as tcodec  # noqa: E402

CACHE = os.path.join(os.path.dirname(__file__), "..", "results", "paper",
                     "tuning_cache.json")
FORMATS = [BINARY8, BINARY16, BINARY16ALT, BINARY32, FpFormat(6, 9)]
IDS = [f.name for f in FORMATS]
CONTAINERS = [(np.uint8, torch.uint8), (np.uint16, torch.uint16),
              (np.uint32, torch.uint32)]


def _jfmt(fmt):
    return JFmt(fmt.e, fmt.m)


def _payload(np_dt, shape, seed):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(np_dt).max
    return rng.integers(0, hi, size=shape, dtype=np.uint64,
                        endpoint=True).astype(np_dt)


def _to_np(t: torch.Tensor) -> np.ndarray:
    """A uint8/16/32 torch tensor as numpy, bits unchanged."""
    signed = {torch.uint8: torch.uint8, torch.uint16: torch.int16,
              torch.uint32: torch.int32}[t.dtype]
    unsigned = {torch.uint8: np.uint8, torch.uint16: np.uint16,
                torch.uint32: np.uint32}[t.dtype]
    return t.view(signed).numpy().view(unsigned)


def _from_np(a: np.ndarray) -> torch.Tensor:
    signed = {np.uint8: np.uint8, np.uint16: np.int16, np.uint32: np.int32}
    tdt = {np.uint8: torch.uint8, np.uint16: torch.uint16,
           np.uint32: torch.uint32}
    return torch.from_numpy(a.view(signed[a.dtype.type]).copy()).view(
        tdt[a.dtype.type])


@pytest.mark.parametrize("np_dt,t_dt", CONTAINERS,
                         ids=["u8", "u16", "u32"])
def test_word_packing_matches_reference(np_dt, t_dt):
    payload = _payload(np_dt, (3, 5, 16), seed=np.dtype(np_dt).itemsize)
    want = np.asarray(jcodec.pack_word_tile(jnp.asarray(payload)))
    got = tcodec.pack_word_tile(_from_np(payload))
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_to_np(got), want)
    np.testing.assert_array_equal(_to_np(tqt.pack_words(_from_np(payload))),
                                  np.asarray(jqt.pack_words(
                                      jnp.asarray(payload))))
    back_want = np.asarray(jcodec.unpack_word_tile(jnp.asarray(want),
                                                   np_dt))
    back = tcodec.unpack_word_tile(got, t_dt)
    assert back.dtype == t_dt
    np.testing.assert_array_equal(_to_np(back), back_want)
    np.testing.assert_array_equal(_to_np(back), payload)
    np.testing.assert_array_equal(
        _to_np(tqt.unpack_words(tqt.pack_words(_from_np(payload)), t_dt)),
        np.asarray(jqt.unpack_words(jqt.pack_words(jnp.asarray(payload)),
                                    np_dt)))


def test_word_packing_needs_whole_words():
    with pytest.raises(ValueError, match="multiple of 4 lanes"):
        tcodec.pack_word_tile(torch.zeros((3, 6), dtype=torch.uint8))


@pytest.mark.parametrize("name", ["binary8", "binary16", "binary16alt",
                                  "binary32"])
def test_native_views_match_reference(name):
    fmt = get_format(name)
    x = np.random.default_rng(1).normal(0, 4, (7, 9)).astype(np.float32)
    jq = jqt.QTensor.quantize(jnp.asarray(x), name)
    tq = tqt.QTensor.quantize(torch.from_numpy(x), name)
    np.testing.assert_array_equal(_to_np(tq.payload), np.asarray(jq.payload))
    nat = tq.to_native()
    assert nat.dtype == fmt.native_dtype
    jnat = jq.to_native()
    np.testing.assert_array_equal(
        nat.to(torch.float32).numpy(), np.asarray(jnat, np.float32))
    back = tqt.QTensor.from_native(nat)
    jback = jqt.QTensor.from_native(jnat)
    assert back.fmt == fmt and back.fmt.e == jback.fmt.e \
        and back.fmt.m == jback.fmt.m
    np.testing.assert_array_equal(_to_np(back.payload),
                                  np.asarray(jback.payload))


def test_native_views_refuse_formats_without_one():
    q = tqt.QTensor.quantize(torch.ones(4), FpFormat(6, 9))
    with pytest.raises(ValueError, match="no native torch dtype"):
        q.to_native()
    with pytest.raises(ValueError, match="no native dtype"):
        tqt.QTensor.from_native(torch.ones(4, dtype=torch.float64))


def _members(fmt, shape, seed, scale=3.0):
    """Seeded f32 values that are exact members of ``fmt``."""
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)
    return np.array(jff.quantize(jnp.asarray(x), _jfmt(fmt)))


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_ff_operators_match_reference(fmt):
    jf = _jfmt(fmt)
    a, b, c = (_members(fmt, (64, 33), s) for s in (1, 2, 3))
    b = np.where(b == 0, np.float32(1), b)       # no 0/0 in ff_div
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    ja, jb, jc = (jnp.asarray(v) for v in (a, b, c))
    for name in ("ff_add", "ff_sub", "ff_mul", "ff_div"):
        _same_bits(getattr(tff, name)(ta, tb, fmt),
                   getattr(jff, name)(ja, jb, jf))
    _same_bits(tff.ff_fma(ta, tb, tc, fmt), jff.ff_fma(ja, jb, jc, jf))
    _same_bits(tff.ff_fma(ta, tb, tc, fmt, saturate=True),
               jff.ff_fma(ja, jb, jc, jf, saturate=True))
    wide = np.random.default_rng(4).normal(0, 1e3, (50,)).astype(np.float32)
    _same_bits(tff.ff_cast(torch.from_numpy(wide), BINARY32, fmt),
               jff.ff_cast(jnp.asarray(wide), None, jf))
    _same_bits(tff.quantization_error(torch.from_numpy(wide), fmt),
               jff.quantization_error(jnp.asarray(wide), jf))


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_quantize_pytree_matches_reference(fmt):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 300, (8, 5)).astype(np.float32)
    y = rng.normal(0, 1e-3, (11,)).astype(np.float32)
    z = rng.integers(0, 9, (4,)).astype(np.int32)
    tree = {"w": torch.from_numpy(x), "b": [torch.from_numpy(y),
                                           torch.from_numpy(z)]}
    jtree = {"w": jnp.asarray(x), "b": [jnp.asarray(y), jnp.asarray(z)]}
    got = tff.quantize_pytree(tree, fmt, saturate=True)
    want = jff.quantize_pytree(jtree, _jfmt(fmt), saturate=True)
    _same_bits(got["w"], want["w"])
    _same_bits(got["b"][0], want["b"][0])
    assert got["b"][1].dtype == torch.int32
    np.testing.assert_array_equal(got["b"][1].numpy(),
                                  np.asarray(want["b"][1]))


def _stats_from_payload(p) -> OpStats:
    s = OpStats()
    for field in ("fp_elems", "fp_instrs", "mem_words"):
        for k, v in p[field].items():
            name, vec = k.split("|")
            getattr(s, field)[(name, bool(int(vec)))] = v
    for k, v in p["casts"].items():
        src, dst = k.split("|")
        s.casts[(src, dst)] = v
    s.other_instrs = p["other"]
    return s


def test_energy_cost_of_cached_baselines():
    with open(CACHE) as f:
        apps = json.load(f)["apps"]
    for name, entry in apps.items():
        stats = _stats_from_payload(entry["baseline"]["stats"])
        rep = energy.cost(stats)
        want = entry["baseline"]["cost"]
        got = {"cycles": rep.cycles, "energy_pj": rep.energy_pj,
               "fp_pj": rep.energy_fp_pj, "mem_pj": rep.energy_mem_pj,
               "other_pj": rep.energy_other_pj, "mem_words": rep.mem_words}
        assert got == want, name
        assert stats.narrow_fraction() == \
            entry["baseline"]["stats"]["narrow_fraction"]
        tuned = entry["eps0.1|V2"]
        rel = energy.relative(
            energy.cost(_stats_from_payload(tuned["stats"])), rep)
        assert rel == tuned["relative"], name
