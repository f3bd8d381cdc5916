"""Tuned policy artifacts in the port, held to the JAX package on the
CPU: ``PrecisionPolicy.to_artifact`` / ``from_artifact`` and
``tuning.artifact.load_policy`` / ``is_artifact_spec``.

Both committed artifacts (``results/tuned/llama3-8b.reduced.json``,
native binary8 per role and per layer; ``results/tuned/
jacobi.eps0.01.json``, emulated) load unchanged and give the reference's
``fmt(role, layer)`` for every role and layer; the strict-load errors and
the ``--kv-fmt`` / pinned-knob conflicts raise as the reference's do;
and the serve CLI serves reduced llama3-8b under the llama3 artifact."""
import json
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import policy as jpolicy  # noqa: E402
from repro.tuning import artifact as jart  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.tuning import artifact as tart  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = [os.path.join(ROOT, "results", "tuned", name)
             for name in ("llama3-8b.reduced.json", "jacobi.eps0.01.json")]


def _roles(path):
    with open(path) as f:
        keys = json.load(f)["formats"]
    flat = {k for k in keys if "." not in k}
    return sorted(set(tpolicy.DEFAULT_ROLES) | flat)


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_committed_artifact_loads_as_reference(path):
    tp = tpolicy.PrecisionPolicy.from_artifact(path)
    jp = jpolicy.PrecisionPolicy.from_artifact(path)
    assert (tp.mode, tp.default_fmt.name, tp.decode_impl, tp.matmul_impl) \
        == (jp.mode, jp.default_fmt.name, jp.decode_impl, jp.matmul_impl)
    for role in _roles(path):
        for layer in (None, 0, 1, 2, 31):
            assert tp.fmt(role, layer).name == jp.fmt(role, layer).name, \
                (role, layer)
        for layer in (0, 1, 2):
            assert tp.at_layer(layer).fmt(role).name == \
                jp.at_layer(layer).fmt(role).name
    prov = {"eps": 0.1, "tuner": "test"}
    assert tp.to_artifact(prov) == jp.to_artifact(prov)
    with open(path) as f:
        doc = json.load(f)
    assert tp.to_artifact(doc["provenance"]) == doc   # unchanged round trip
    assert tpolicy.PrecisionPolicy.from_artifact(doc).to_artifact() == \
        jpolicy.PrecisionPolicy.from_artifact(doc).to_artifact()
    for spec, kw in ((path, {}), (path, {"decode_impl": "paged"}),
                     (path, {"matmul_impl": "qmm_pallas"})):
        a = tart.load_policy(spec, **kw)
        b = jart.load_policy(spec, **kw)
        assert a.to_artifact() == b.to_artifact()


def _bad_docs(tmp_path):
    with open(ARTIFACTS[0]) as f:
        good = json.load(f)
    docs = {
        "version": dict(good, version=2),
        "unknown_key": dict(good, extra=1),
        "unknown_format": dict(good, formats={"act": "binary7"}),
        "missing": {k: v for k, v in good.items() if k != "mode"},
        "schema": dict(good, schema="other"),
        "formats_list": dict(good, formats=["binary8"]),
        "not_object": [good],
    }
    out = {name: doc for name, doc in docs.items()}
    bad_json = tmp_path / "bad.json"
    bad_json.write_text("{not json")
    out["not_json"] = str(bad_json)
    return out


def test_strict_load_errors_raise_as_reference(tmp_path):
    for name, doc in _bad_docs(tmp_path).items():
        msgs = []
        for pol in (tpolicy, jpolicy):
            with pytest.raises(ValueError) as ei:
                pol.PrecisionPolicy.from_artifact(doc)
            msgs.append(str(ei.value).split(":")[0])
        assert msgs[0] == msgs[1], name


def test_load_policy_conflicts_and_named_specs(tmp_path):
    art = ARTIFACTS[0]
    for kw in ({"kv_fmt": "binary16"},):
        for mod in (tart, jart):
            with pytest.raises(ValueError, match="kv-fmt"):
                mod.load_policy(art, **kw)
    pinned = tmp_path / "pinned.json"
    with open(art) as f:
        doc = json.load(f)
    pinned.write_text(json.dumps(dict(doc, decode_impl="paged")))
    for mod in (tart, jart):
        with pytest.raises(ValueError, match="conflicts"):
            mod.load_policy(str(pinned), decode_impl="xla")
        assert mod.load_policy(str(pinned),
                               decode_impl="paged").decode_impl == "paged"
        with pytest.raises(ValueError, match="neither a named policy"):
            mod.load_policy("binary31")
    for spec in ("binary32", "transprecision", art, "x/y", "p.json",
                 "binary31", 3):
        assert tart.is_artifact_spec(spec) == jart.is_artifact_spec(spec)
    for name in ("binary32", "transprecision"):
        a = tart.load_policy(name, kv_fmt="binary16", decode_impl="paged")
        b = jart.load_policy(name, kv_fmt="binary16", decode_impl="paged")
        assert a.to_artifact() == b.to_artifact()


def test_serve_cli_under_the_llama3_artifact(capsys):
    """``--policy results/tuned/llama3-8b.reduced.json``: binary8 weights,
    activations and KV per layer, served on the CPU; every request gets
    its tokens, and ``--kv-fmt`` next to the artifact is refused."""
    flags = ["--reduced", "--policy", ARTIFACTS[0], "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "9",
             "--max-new", "4", "--capacity", "16", "--page-size", "8"]
    for extra in (["--decode-impl", "paged", "--matmul-impl",
                   "qmm_pallas"], ["--decode-impl", "flash_pallas"]):
        reqs = tserve.main(flags + extra)
        out = capsys.readouterr().out
        assert "kv format: binary8" in out
        assert all(r.done and not r.failed and len(r.generated) == 4
                   for r in reqs)
        assert all(0 <= t < 256 for r in reqs for t in r.generated)
    with pytest.raises(ValueError, match="kv-fmt"):
        tserve.main(flags + ["--kv-fmt", "binary16"])
