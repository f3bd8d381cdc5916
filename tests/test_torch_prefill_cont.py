"""The port's ``attention.prefill_from_cache`` (continuation prefill into
a contiguous cache) against the JAX package's, on the same weights and
inputs, and against one whole prefill.

* Against the reference's function, ``xla`` and ``flash_pallas``
  spellings (the reference's Pallas kernel in interpret mode), over a
  binary32 cache and a binary8 (e5m2) one, everything else binary32:
  outputs within 1e-5 absolute (outputs are O(1)); the binary8 cache's
  K/V bit for bit.  No bitwise cache check under binary32: XLA's CPU
  matmul rounds a 20-row and a 12-row projection differently, and the
  reference's own test of its function (``tests/test_dispatch.py::
  test_prefill_from_cache_matches_full_prefill``) fails on that
  assertion here, by at most 4.8e-7.
* Against one whole prefill of the same rows under binary32: within
  1e-5.
* The reference's refusals: a ring (sliding-window) cache and a chunk
  past the capacity raise ``ValueError``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.formats import BINARY8 as JBINARY8  # noqa: E402
from repro.core.policy import binary32_policy as jbinary32  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models.base import ModelConfig as JConfig  # noqa: E402
from repro_torch.core.formats import BINARY8  # noqa: E402
from repro_torch.core.policy import binary32_policy  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models.base import ModelConfig  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

BASE = dict(arch="t", family="dense", n_layers=1, d_model=64, n_heads=4,
            n_kv=2, d_ff=128, vocab=64)
CAP, FIRST, S = 48, 20, 12          # cache rows, cached rows, chunk rows


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    d, q, kv = 64, 4 * 16, 2 * 16
    return {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)),
                         ("wo", (q, d)))}


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.normal(size=(2, FIRST + S, 64))).astype(np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("kv", ["binary32", "binary8"])
@pytest.mark.parametrize("impl", ["xla", "flash_pallas"])
def test_matches_the_reference_function(impl, kv):
    """The cache is the reference's own (``prefill_to_cache`` of the first
    20 rows), carried across as its bits, so both functions start from
    the same cache."""
    jpol = jbinary32(kv_fmt=JBINARY8 if kv == "binary8" else None)
    tpol = binary32_policy(kv_fmt=BINARY8 if kv == "binary8" else None)
    jcfg = JConfig(**BASE, decode_impl=impl)
    tcfg = ModelConfig(**BASE, decode_impl=impl)
    w, x = _weights(), _inputs()
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: _t(v) for k, v in w.items()}
    _, jcache = jatt.prefill_to_cache(jp, jnp.asarray(x[:, :FIRST]), jcfg,
                                      jpol, capacity=CAP)
    want, jnew = jatt.prefill_from_cache(jp, jnp.asarray(x[:, FIRST:]),
                                         jcfg, jpol, jcache, q_offset=FIRST)
    tcache = tatt.KVCache(k=_t(jcache.k), v=_t(jcache.v), pos=FIRST)
    got, tnew = tatt.prefill_from_cache(tp, _t(x[:, FIRST:]), tcfg, tpol,
                                        tcache, q_offset=FIRST)
    assert got.dtype == torch.float32 and got.shape == (2, S, 64)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= 1e-5, f"max |port - jax| {err:.3e} > 1e-5"
    assert tnew.pos == int(jnew.pos) == FIRST + S
    assert tnew.k.dtype == (torch.float8_e5m2 if kv == "binary8"
                            else torch.float32)
    # the rows before q_offset are the cache's, untouched
    assert torch.equal(tnew.k[:, :FIRST], tcache.k[:, :FIRST])
    if kv == "binary8":
        for t, j in ((tnew.k, jnew.k), (tnew.v, jnew.v)):
            np.testing.assert_array_equal(
                t.view(torch.uint8).numpy(),
                np.asarray(j).view(np.uint8))
    else:
        kerr = np.abs(tnew.k.numpy() - np.asarray(jnew.k)).max()
        assert kerr <= 1e-6, kerr
    # the input cache is not written
    assert torch.equal(tcache.k, _t(jcache.k))


@pytest.mark.parametrize("impl", ["xla", "flash_pallas"])
def test_two_chunks_equal_one_whole_prefill(impl):
    """binary32: the first 20 rows prefilled, the next 12 continued,
    against the 32 rows prefilled at once, within 1e-5."""
    pol = binary32_policy()
    cfg = ModelConfig(**BASE, decode_impl=impl)
    p = {k: _t(v) for k, v in _weights().items()}
    x = _t(_inputs())
    with torch.no_grad():
        whole, cache_whole = tatt.prefill_to_cache(p, x, cfg, pol, CAP)
        out1, cache = tatt.prefill_to_cache(p, x[:, :FIRST], cfg, pol, CAP)
    out2, cache = tatt.prefill_from_cache(p, x[:, FIRST:], cfg, pol, cache,
                                          FIRST)
    for got, want in ((out1, whole[:, :FIRST]), (out2, whole[:, FIRST:])):
        err = float((got - want).abs().max())
        assert err <= 1e-5, err
    assert cache.pos == FIRST + S
    kerr = float((cache.k[:, :FIRST + S] - cache_whole.k[:, :FIRST + S])
                 .abs().max())
    assert kerr <= 1e-6, kerr


def test_refuses_a_ring_cache_and_an_overflow():
    pol = binary32_policy()
    p = {k: _t(v) for k, v in _weights().items()}
    x = _t(_inputs())[:, :S]
    ring = ModelConfig(**BASE, window=16)
    cache = tatt.KVCache(k=torch.zeros((2, 16, 2, 16)),
                         v=torch.zeros((2, 16, 2, 16)), pos=0)
    with pytest.raises(ValueError, match="ring-buffer"):
        tatt.prefill_from_cache(p, x, ring, pol, cache, 0)
    cfg = ModelConfig(**BASE)
    cache = tatt.KVCache(k=torch.zeros((2, CAP, 2, 16)),
                         v=torch.zeros((2, CAP, 2, 16)), pos=40)
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        tatt.prefill_from_cache(p, x, cfg, pol, cache, 40)
    # a window wider than the cache is no ring: it continues
    wide = ModelConfig(**BASE, window=64)
    out, new = tatt.prefill_from_cache(p, x, wide, pol, cache, 0)
    assert new.pos == S and torch.isfinite(out).all()


def test_runs_without_autograd():
    """Like ``prefill``, it records no graph even on weights that
    require grad."""
    pol = binary32_policy()
    p = {k: _t(v).requires_grad_() for k, v in _weights().items()}
    cache = tatt.KVCache(k=torch.zeros((2, CAP, 2, 16)),
                         v=torch.zeros((2, CAP, 2, 16)), pos=0)
    out, _ = tatt.prefill_from_cache(p, _t(_inputs())[:, :S],
                                     ModelConfig(**BASE), pol, cache, 0)
    assert out.grad_fn is None and not out.requires_grad
