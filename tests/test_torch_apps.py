"""The six paper apps of the port against the JAX package's, on the CPU.

For each app, one evaluation at binary32 and one under a seeded narrow
binding (each variable one of binary8, binary16, binary16alt and a
run-time (6, 9)), on ``gen_inputs(seed=1000)``, through the port's
``TPContext(device="cpu")`` and the reference's ``TPContext``:

* binary32: output within 1e-6 relative RMS (``rel_error``) of the
  reference's (``TPContext.reduce_sum`` sums with ``torch.sum``, the
  reference with ``np.sum``: another order, so not bit for bit);
* the narrow binding: output bit-identical;
* both: every ``OpStats`` counter and every variable's size equal;
* the dynamic ranges (min and max |finite nonzero| value per variable):
  equal under the narrow binding; at binary32 within 1e-6 of the
  variable's max (the smallest value of a reduction with cancellation,
  e.g. SVM's ``dot`` at 1.4e-3 beside values of order 1, moves by more
  than 1e-6 of itself when the summation order changes; measured: 2.7e-6
  relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.apps.common import TPContext as JContext  # noqa: E402
from repro.apps.conv import Conv as JConv  # noqa: E402
from repro.apps.dwt import Dwt as JDwt  # noqa: E402
from repro.apps.jacobi import Jacobi as JJacobi  # noqa: E402
from repro.apps.knn import Knn as JKnn  # noqa: E402
from repro.apps.pca import Pca as JPca  # noqa: E402
from repro.apps.svm import Svm as JSvm  # noqa: E402
from repro.core.formats import get_format as jget_format  # noqa: E402
from repro_torch.apps import all_apps  # noqa: E402
from repro_torch.apps.common import TPContext, rel_error  # noqa: E402

REF_APPS = {"JACOBI": JJacobi, "KNN": JKnn, "PCA": JPca, "DWT": JDwt,
            "SVM": JSvm, "CONV": JConv}
APPS = {a.name: a for a in all_apps()}
NARROW = ("binary8", "binary16", "binary16alt", "flexfloat<6,9>")


def _binding(app, narrow):
    if not narrow:
        return {}
    rng = np.random.default_rng(len(app.name) * 1000 + 7)
    return {v: NARROW[int(rng.integers(0, len(NARROW)))]
            for v in app.variables}


def _stats(s):
    return (dict(s.fp_elems), dict(s.fp_instrs), dict(s.casts),
            dict(s.mem_words), s.other_instrs)


@pytest.mark.parametrize("narrow", [False, True], ids=["binary32", "narrow"])
@pytest.mark.parametrize("name", list(APPS))
def test_app_matches_reference(name, narrow):
    app, ref_app = APPS[name], REF_APPS[name]()
    assert tuple(app.variables) == tuple(ref_app.variables)
    inputs = app.gen_inputs(seed=1000)
    binding = _binding(app, narrow)

    jctx = JContext({k: jget_format(v) for k, v in binding.items()})
    want = np.asarray(ref_app.run(jctx, inputs), np.float64)
    ctx = TPContext(binding, device="cpu")
    out = app.run(ctx, inputs)
    got = out.numpy().astype(np.float64)
    assert got.shape == want.shape

    if narrow:
        np.testing.assert_array_equal(
            got.astype(np.float32).view(np.uint32),
            want.astype(np.float32).view(np.uint32))
    else:
        assert rel_error(out, want) <= 1e-6

    assert _stats(ctx.stats) == _stats(jctx.stats)
    assert ctx.sizes == jctx.sizes
    ranges = ctx.ranges
    assert set(ranges) == set(jctx.ranges)
    for v, (lo, hi) in jctx.ranges.items():
        if narrow:
            assert ranges[v] == (lo, hi), v
        else:
            assert abs(ranges[v][0] - lo) <= 1e-6 * hi, v
            assert abs(ranges[v][1] - hi) <= 1e-6 * hi, v


def test_context_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPContext({})
