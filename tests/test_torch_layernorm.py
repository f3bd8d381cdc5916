"""layernorm's plain twin (``kernels/layernorm.py``), on the CPU.

The twin sums in the CUDA kernel's order (``layernorm_launch`` in
``csrc/rmsnorm.cu``): rmsnorm's 128 per-thread partials, each adding its
strided values to 0 in sequence, then a halving tree, for the mean and
again for the two-pass variance.  Here: the twin equals a scalar model
of the kernel's threads; a row's bits do not depend on the number of
rows beside it at d 8192 (command-r-35b) and 384 (whisper-tiny's width);
under binary32 it is within 1e-6 of the JAX layernorm relative to the
row's largest output (the reference's ``mean`` sums in another order),
and under transprecision its bf16 result is within one ulp of the JAX
layernorm's plus that 1e-6 (where beta cancels the normalized term, a
few f32 ulps are many bf16 ulps of a tiny output).  ``chip_smoke.py``
holds the kernel to the twin bit for bit on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import layernorm as tln  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

ROW_COUNTS = (1, 2, 4, 8, 9, 16, 17, 33, 64, 100, 128)


def _inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed + d)
    x = (rng.normal(size=(rows, d)) * 3.0 + 1.5).astype(np.float32)
    gamma = (1.0 + rng.normal(size=(d,)) * 0.1).astype(np.float32)
    beta = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    return x, gamma, beta


def _kernel_model(row, gamma, beta, eps=np.float32(1e-5)):
    """The kernel for one row, thread by thread, in float32."""
    d = row.shape[0]
    f = np.float32

    def tree_sum(values):
        part = np.zeros(trms.THREADS, np.float32)
        for t in range(trms.THREADS):
            acc = f(0.0)
            for i in range(t, d, trms.THREADS):
                acc = f(acc + values[i])
            part[t] = acc
        h = trms.THREADS // 2
        while h:
            part[:h] = part[:h] + part[h:2 * h]
            h //= 2
        return part[0]

    mu = f(tree_sum(row) / f(d))
    c = (row - mu).astype(np.float32)
    var = f(tree_sum((c * c).astype(np.float32)) / f(d))
    r = f(f(1.0) / f(np.sqrt(f(var + eps))))
    return ((c * r).astype(np.float32) * gamma + beta).astype(np.float32)


@pytest.mark.parametrize("d", [64, 200, 384, 1000])
def test_twin_computes_in_the_kernels_order(d):
    x, gamma, beta = _inputs(3, d)
    got = tln.layernorm_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                              torch.from_numpy(beta)).numpy()
    want = np.stack([_kernel_model(r, gamma, beta) for r in x])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [384, 8192])
def test_twin_rows_do_not_depend_on_the_row_count(d):
    x, gamma, beta = _inputs(128, d)
    xt, gt, bt = map(torch.from_numpy, (x, gamma, beta))
    full = tln.layernorm_plain(xt, gt, bt)
    for m in ROW_COUNTS:
        assert torch.equal(tln.layernorm_plain(xt[:m], gt, bt), full[:m]), m
    for pol in ("binary32", "transprecision"):
        policy = get_policy(pol)
        whole = tlayers.layernorm(xt, gt, bt, policy)
        for m in (1, 4, 16, 64):
            assert torch.equal(tlayers.layernorm(xt[:m], gt, bt, policy),
                               whole[:m])


@pytest.mark.parametrize("d", [64, 384, 8192])
def test_binary32_layernorm_matches_jax(d):
    x, gamma, beta = _inputs(16, d)
    want = np.asarray(jlayers.layernorm(
        *map(jnp.asarray, (x, gamma, beta)), jget_policy("binary32")))
    got = tlayers.apply_norm(torch.from_numpy(x),
                             {"gamma": torch.from_numpy(gamma),
                              "beta": torch.from_numpy(beta)},
                             get_policy("binary32"), "layernorm").numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


@pytest.mark.parametrize("d", [64, 8192])
def test_transprecision_layernorm_within_one_ulp_of_jax(d):
    x, gamma, beta = _inputs(16, d)
    fn = jax.jit(lambda a, g, b: jlayers.layernorm(
        a, g, b, jget_policy("transprecision")),
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(fn(*map(jnp.asarray, (x, gamma, beta))))
    got = tlayers.layernorm(*map(torch.from_numpy, (x, gamma, beta)),
                            get_policy("transprecision"))
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    mag = np.abs(want)
    ulp = (mag.view(np.uint16) + 1).view(mag.dtype).astype(np.float32) \
        - mag.astype(np.float32)
    want = want.astype(np.float32)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= ulp + 1e-6 * scale).all()


def test_norm_init_and_apply_norm_follow_the_reference():
    for kind in ("rmsnorm", "layernorm"):
        want = jlayers.norm_init(8, kind)
        got = tlayers.norm_init(8, kind, device="cpu")
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    x = torch.from_numpy(_inputs(2, 8)[0])
    p = tlayers.norm_init(8, "rmsnorm", device="cpu")
    assert torch.equal(tlayers.apply_norm(x, p, get_policy("binary32"),
                                          "rmsnorm"),
                       tlayers.rmsnorm(x, p["gamma"],
                                       get_policy("binary32")))


def test_layernorm_takes_any_leading_shape_and_bf16():
    x, gamma, beta = _inputs(6, 256)
    xt = torch.from_numpy(x).reshape(2, 3, 256)
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    y = tln.layernorm_f32(xt, gt, bt)
    assert y.shape == (2, 3, 256) and y.dtype == torch.float32
    assert torch.equal(y.reshape(6, 256),
                       tln.layernorm_f32(xt.reshape(6, 256), gt, bt))
    xb = xt.to(torch.bfloat16)
    assert torch.equal(tln.layernorm_f32(xb, gt, bt),
                       tln.layernorm_f32(xb.float(), gt, bt))
    assert tln.layernorm_hbm_bytes(4, 8192, 2) == 4 * 8192 * 6 + 8192 * 8
