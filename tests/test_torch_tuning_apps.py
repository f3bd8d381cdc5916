"""The port's precision tuner (``core/tuning.py``) on the CPU against the
reference.

* One binding of the reference's cache ``results/paper/tuning_cache.json``
  per app (the cheapest eps of each, V2, ``n_input_sets=2`` as the cache
  was made): the port's artifact provenance equals the cache's in every
  key (formats, precisions, needs_wide, sizes, n_evals, bytes, ...) but
  the tuner's name, and ``final_error`` is within 1e-5 relative.
* A V1 tune of DWT and SVM against the reference's ``tune`` run here.
* ``TuneResult.to_artifact`` written by ``save_artifact`` loads through
  the port's ``load_policy`` as an emulated policy with the tuned
  formats.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.apps.dwt import Dwt as JDwt  # noqa: E402
from repro.apps.svm import Svm as JSvm  # noqa: E402
from repro.core.tuning import tune as jtune  # noqa: E402
from repro_torch.apps import all_apps  # noqa: E402
from repro_torch.core.tuning import Tuner, map_format, tune  # noqa: E402
from repro_torch.tuning import load_policy, save_artifact  # noqa: E402

CACHE = os.path.join(os.path.dirname(__file__), "..", "results", "paper",
                     "tuning_cache.json")
APPS = {a.name: a for a in all_apps()}
# the cheapest eps of each app (port on one CPU core: JACOBI ~9 s, PCA
# ~9 s, the others under 1 s)
CHEAPEST = {"JACOBI": 1e-3, "KNN": 1e-1, "PCA": 1e-1, "DWT": 1e-1,
            "SVM": 1e-1, "CONV": 1e-1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The apps run thousands of small tensor ops: one intra-op thread is
    as fast alone and does not oversubscribe the cores beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache():
    with open(CACHE) as f:
        return json.load(f)["apps"]


def _provenance_matches(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "tuner":
            continue
        if k == "final_error":
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=0)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name", list(CHEAPEST))
def test_cached_binding_reproduced(name, cache):
    eps = CHEAPEST[name]
    res = tune(APPS[name], eps, n_input_sets=2, type_system="V2",
               device="cpu")
    art = res.to_artifact()
    want = cache[name][f"eps{eps:g}|V2"]["artifact"]
    assert art["formats"] == want["formats"]
    assert art["mode"] == "emulated"
    _provenance_matches(art["provenance"], want["provenance"])
    assert art["provenance"]["tuner"] == "repro_torch.core.tuning.Tuner"


@pytest.mark.parametrize("name,ref_cls", [("DWT", JDwt), ("SVM", JSvm)])
def test_v1_tune_matches_reference(name, ref_cls):
    got = tune(APPS[name], 1e-2, n_input_sets=2, type_system="V1",
               device="cpu")
    want = jtune(ref_cls(), 1e-2, n_input_sets=2, type_system="V1")
    assert {v: f.name for v, f in got.formats.items()} == \
        {v: f.name for v, f in want.formats.items()}
    assert got.precisions == want.precisions
    assert got.needs_wide == want.needs_wide
    assert got.sizes == want.sizes
    assert got.n_evals == want.n_evals
    assert got.final_error == pytest.approx(want.final_error, rel=1e-5,
                                            abs=0)
    assert "binary16alt" not in got.vars_by_format()


def test_map_format_intervals():
    for ts in ("V1", "V2"):
        for p in range(1, 25):
            for wide in (False, True):
                f = map_format(p, wide, ts)
                assert f.precision >= min(p, 24)
                assert not (ts == "V1" and f.name == "binary16alt")


def test_artifact_loads_as_emulated_policy(tmp_path):
    res = tune(APPS["SVM"], 1e-1, n_input_sets=2, device="cpu")
    path = tmp_path / "svm.json"
    save_artifact(res.to_artifact(), path)
    policy = load_policy(str(path))
    assert policy.mode == "emulated"
    assert {k: f.name for k, f in policy.formats.items()} == \
        {k: f.name for k, f in res.formats.items()}
    assert json.loads(path.read_text())["provenance"]["n_evals"] == \
        res.n_evals
    assert res.bytes_tuned() < res.bytes_f32()
    assert np.isfinite(res.final_error) and res.final_error <= 1e-1


def test_tuner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tuner(APPS["DWT"], 1e-1, n_input_sets=1)
