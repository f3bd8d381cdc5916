"""rmsnorm's plain twin (``kernels/rmsnorm.py``), on the CPU.

The twin sums in the CUDA kernel's order (``csrc/rmsnorm.cu``): 128
per-thread partials, each summing ``x[t + 128 j]^2`` in sequence, then a
halving tree.  Here: the twin equals a scalar model of the kernel's
threads; a row's bits do not depend on the number of rows beside it at
d 1024, 2048, 4096, 5120 and 8192 (``chip_smoke.py`` holds the kernel
to the same on the card, and to the twin); and under transprecision the
bf16 result is within one ulp of the JAX rmsnorm's, whose one ``mean``
sums in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

ROW_COUNTS = (1, 2, 4, 8, 9, 16, 17, 33, 64, 100, 128)


def _inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed + d)
    x = (rng.normal(size=(rows, d)) * 3.0).astype(np.float32)
    gamma = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    return x, gamma


def _kernel_model(row: np.ndarray) -> np.float32:
    """The kernel's sum for one row, thread by thread, in float32."""
    d = row.shape[0]
    part = np.zeros(trms.THREADS, np.float32)
    for t in range(trms.THREADS):
        acc = np.float32(0.0)
        for i in range(t, d, trms.THREADS):
            acc = np.float32(acc + np.float32(row[i] * row[i]))
        part[t] = acc
    h = trms.THREADS // 2
    while h:
        part[:h] = part[:h] + part[h:2 * h]
        h //= 2
    return np.float32(part[0] / np.float32(d))


@pytest.mark.parametrize("d", [64, 200, 384, 4096])
def test_twin_sums_in_the_kernels_order(d):
    x, _ = _inputs(3, d)
    got = trms.mean_square_plain(torch.from_numpy(x))[:, 0].numpy()
    want = np.array([_kernel_model(r) for r in x], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1024, 2048, 4096, 5120, 8192])
def test_twin_rows_do_not_depend_on_the_row_count(d):
    x, gamma = _inputs(128, d)
    xt, gt = torch.from_numpy(x), torch.from_numpy(gamma)
    full = trms.rmsnorm_plain(xt, gt)
    for m in ROW_COUNTS:
        assert torch.equal(trms.rmsnorm_plain(xt[:m], gt), full[:m]), m
    for pol in ("binary32", "transprecision"):
        policy = get_policy(pol)
        whole = tlayers.rmsnorm(xt, gt, policy)
        for m in (1, 4, 16, 64):
            assert torch.equal(tlayers.rmsnorm(xt[:m], gt, policy),
                               whole[:m])


@pytest.mark.parametrize("d", [64, 4096, 5120, 8192])
def test_transprecision_rmsnorm_within_one_ulp_of_jax(d):
    """transprecision: the bf16 outputs within one bf16 ulp of the JAX
    rmsnorm's, computed with XLA's excess precision off (binary32 is
    held at 1e-6 relative in ``test_torch_model.py``)."""
    x, gamma = _inputs(16, d)
    fn = jax.jit(lambda a, g: jlayers.rmsnorm(
        a, g, jget_policy("transprecision")),
        compiler_options={"xla_allow_excess_precision": False})
    wb = np.asarray(fn(jnp.asarray(x), jnp.asarray(gamma))).view(np.int16)
    gb = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                         get_policy("transprecision")).view(torch.int16)
    ulps = np.abs(gb.numpy().astype(np.int32) - wb.astype(np.int32))
    assert ulps.max() <= 1


def test_rmsnorm_takes_any_leading_shape_and_bf16():
    x, gamma = _inputs(6, 256)
    xt = torch.from_numpy(x).reshape(2, 3, 256)
    gt = torch.from_numpy(gamma)
    y = trms.rmsnorm_f32(xt, gt)
    assert y.shape == (2, 3, 256) and y.dtype == torch.float32
    assert torch.equal(y.reshape(6, 256), trms.rmsnorm_f32(xt.reshape(6, 256),
                                                           gt))
    xb = xt.to(torch.bfloat16)
    assert torch.equal(trms.rmsnorm_f32(xb, gt),
                       trms.rmsnorm_f32(xb.float(), gt))
    assert trms.rmsnorm_hbm_bytes(4, 4096, 2) == 4 * 4096 * 6 + 4096 * 4
