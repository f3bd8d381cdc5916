"""The port's flash_prefill (its plain version on the CPU) against the JAX
package: the XLA oracle ``_prefill_xla_reference`` on decoded K/V, and the
Pallas kernel in interpret mode, within 1e-6, over causal continuation
chunks (``q_offset``), sliding windows, a bidirectional prefix, and packed
or float K/V."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402


def _case(fmt, Sq=16, Skv=40, H=2, G=4, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, Sq, H, G, dh)).astype(np.float32)
    kf = rng.normal(size=(1, Skv, H, dh)).astype(np.float32)
    vf = rng.normal(size=(1, Skv, H, dh)).astype(np.float32)
    if fmt is None:
        return q, kf, vf, kf, vf
    kp = np.asarray(jqt.encode(jnp.asarray(kf), fmt))
    vp = np.asarray(jqt.encode(jnp.asarray(vf), fmt))
    kd = np.asarray(jqt.decode(jnp.asarray(kp), fmt))
    vd = np.asarray(jqt.decode(jnp.asarray(vp), fmt))
    return q, kp, vp, kd, vd


CASES = [("binary8", 0, None, 0), ("binary8", 16, None, 0),
         ("binary8", 21, None, 0), ("binary16alt", 8, None, 0),
         (None, 0, None, 0), (None, 24, None, 0), ("binary8", 21, 6, 0),
         (None, 10, None, 5)]


@pytest.mark.parametrize("fmt,q_offset,window,prefix", CASES,
                         ids=[f"{c[0] or 'f32'}-off{c[1]}-w{c[2]}-p{c[3]}"
                              for c in CASES])
def test_flash_prefill_matches_xla_reference(fmt, q_offset, window, prefix):
    q, kp, vp, kd, vd = _case(fmt, seed=q_offset + 1)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    want = np.asarray(jfa._prefill_xla_reference(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), scale, window,
        prefix, q_offset))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = tfa.flash_prefill(t(q), t(kp), t(vp), fmt, window=window,
                            prefix_len=prefix, q_offset=q_offset)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_flash_prefill_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode), packed continuation
    chunk over a longer cache: several KV blocks, pruned future tiles."""
    q, kp, vp, _, _ = _case("binary8", Sq=16, Skv=64, seed=9)
    want = np.asarray(jfa.flash_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), "binary8",
        q_offset=24, block_q=8, block_kv=16, interpret=True))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = tfa.flash_prefill(t(q), t(kp), t(vp), "binary8", q_offset=24)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_prefill_byte_model():
    assert tfa.prefill_hbm_bytes(1, 64, 128, 8, 4, 128, "binary8") == (
        2 * 64 * 8 * 4 * 128 * 4 + 2 * 128 * 8 * 128)


@pytest.mark.parametrize("fmt", ["binary8", "binary16alt", None],
                         ids=lambda f: f or "f32")
@pytest.mark.parametrize("G,dh,q_offset,window,prefix",
                         [(10, 16, 16, None, 0), (10, 256, 16, None, 0),
                          (2, 256, 21, 6, 0), (10, 16, 10, None, 5)],
                         ids=["G10-dh16", "G10-dh256", "G2-dh256-window",
                              "G10-dh16-prefix"])
def test_flash_prefill_at_the_widened_shapes(fmt, G, dh, q_offset, window,
                                             prefix):
    """head_dim 16 and 256 at G 10 and 2 (the shapes the CUDA kernel was
    widened to), against the XLA oracle on decoded K/V: within 1e-6 at
    head_dim 16; within 2e-6 at head_dim 256, where each of the two f32
    functions can lie more than 1e-6 from the same formula evaluated in
    f64 (each score sums 256 products), so that no f32 pair is held to
    1e-6 of each other there."""
    q, kp, vp, kd, vd = _case(fmt, Sq=16, Skv=40, G=G, dh=dh,
                              seed=G + dh)
    scale = float(1.0 / np.sqrt(dh))
    want = np.asarray(jfa._prefill_xla_reference(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), scale, window,
        prefix, q_offset))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = tfa.flash_prefill(t(q), t(kp), t(vp), fmt, window=window,
                            prefix_len=prefix, q_offset=q_offset)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 if dh <= 128 else 2e-6)
