"""The port's serve-time tuner, calibration sets and codec dispatch, on
the CPU against the JAX package.

* ``ServeTuner`` on reduced llama3-8b, 1 calibration set x 2 prompts x 8
  tokens, ``decode_steps=2``, ``kv_groups=2``, ``max_rounds=1``, eps 0.2
  (the reference's ``tests/test_tuning.py`` run), with the reference's
  weights handed over by ``params_for`` (``models/convert.py``): the same
  per-variable formats and ``n_evals`` as the reference's ``ServeTuner``,
  and equal byte counts.  The reference runs in a child with XLA's excess
  precision off (its search jits internally, and by default XLA skips
  bf16 roundings between fused ops); the port computes the KL in f64
  where the reference sums in f32.  The KL of a candidate with binary8
  weights and KV and binary32 activations and probabilities is within
  1e-3 relative of the reference's.  With binary8 activations the two
  sides' f32 matmuls (torch's and XLA's summation orders, 1e-7 apart)
  round a few activations to different binary8 neighbours, 25 % apart,
  and the KL moves by percents (measured: 1.9 % with binary8 activations
  alone, 11.5 % with every variable binary8), so ``final_kl`` of the
  all-binary8 result is held within 20 % relative and both under eps.
* ``synthetic_calibration`` digests equal to the reference's, and
  ``CalibrationTap``'s reservoir and the engine's feed as in the
  reference's test.
* The codec's dispatch: ``quantize``, ``encode`` and ``decode`` call the
  kernel wrappers for a tensor that is not on the CPU and the plain codec
  for a CPU tensor (a ``meta`` tensor stands in for a CUDA one here,
  with the wrappers replaced by recorders); ``rbits`` off the CPU raises.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.formats import get_format as jget_format  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.tuning import calibrate as jcal  # noqa: E402
from repro_torch.core import flexfloat as tff  # noqa: E402
from repro_torch.core import qtensor as tqt  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy, get_policy  # noqa: E402
from repro_torch.engine import Engine, Request  # noqa: E402
from repro_torch.kernels import codec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.tuning import (CalibrationTap, ServeTuner,  # noqa: E402
                                digest_of, synthetic_calibration)
from repro_torch.tuning import __main__ as tune_cli  # noqa: E402

_REF_SERVE_TUNER = """
import os
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import json
from repro.models.registry import build
from repro.tuning import ServeTuner, synthetic_calibration
model, cfg = build("llama3-8b", reduced=True)
sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=2, prompt_len=8)
tuner = ServeTuner(model, cfg, sets, eps=0.2, decode_steps=2, kv_groups=2,
                   max_rounds=1)
res = tuner.run()
wide_act = {v: 3 if v in ("act", "attn_probs") else 0
            for v in tuner.variables}
print("REF_SERVE_TUNER " + json.dumps({
    "kl_wide_act": tuner._error(wide_act, 0),
    "formats": {k: f.name for k, f in res.formats.items()},
    "n_evals": res.n_evals, "final_kl": res.final_kl,
    "bytes": [res.weight_bytes, res.weight_bytes_f32,
              res.kv_bytes_per_token, res.kv_bytes_per_token_f32],
    "calibration": res.calibration}))
"""


def _start_child(code: str) -> subprocess.Popen:
    """Start ``code`` in a fresh interpreter (it runs while the port's
    side runs here)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _child_result(proc: subprocess.Popen, marker: str, timeout: int):
    """The JSON the child printed after ``marker`` (its output on
    failure)."""
    out, err = proc.communicate(timeout=timeout)
    line = next((ln for ln in out.splitlines()
                 if ln.startswith(marker + " ")), None)
    if line is None:
        pytest.fail(f"child never printed {marker!r} (exit "
                    f"{proc.returncode})\n{out}\n{err}")
    return json.loads(line[len(marker) + 1:])


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.payload), tree.fmt.name)
    return np.asarray(tree)


def _reference_weights(jmodel):
    """``params_for``: the reference's weights for a candidate policy (its
    ``init_params(PRNGKey(0), policy)``), carried across as numpy."""
    def params_for(policy):
        jpol = JPolicy(formats={k: jget_format(f.name)
                                for k, f in policy.formats.items()},
                       mode=policy.mode,
                       default_fmt=jget_format(policy.default_fmt.name))
        return params_from_numpy(
            _to_numpy(jmodel.init_params(jax.random.PRNGKey(0), jpol)),
            device="cpu")
    return params_for


def test_serve_tuner_matches_reference():
    child = _start_child(_REF_SERVE_TUNER)
    try:
        model, cfg = build("llama3-8b", reduced=True)
        jmodel, _ = jbuild("llama3-8b", reduced=True)
        sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=2,
                                     prompt_len=8)
        tuner = ServeTuner(model, cfg, sets, eps=0.2, decode_steps=2,
                           kv_groups=2, max_rounds=1, device="cpu",
                           params_for=_reference_weights(jmodel))
        res = tuner.run()
        want = _child_result(child, "REF_SERVE_TUNER", 300)
    finally:
        child.kill()
    assert {k: f.name for k, f in res.formats.items()} == want["formats"]
    assert res.n_evals == want["n_evals"]
    assert res.final_kl == pytest.approx(want["final_kl"], rel=0.2, abs=0)
    wide_act = {v: 3 if v in ("act", "attn_probs") else 0
                for v in tuner.variables}
    assert tuner._error(wide_act, 0) == pytest.approx(want["kl_wide_act"],
                                                      rel=1e-3, abs=0)
    assert [res.weight_bytes, res.weight_bytes_f32, res.kv_bytes_per_token,
            res.kv_bytes_per_token_f32] == want["bytes"]
    assert res.calibration == want["calibration"]
    assert res.final_kl <= 0.2
    assert PrecisionPolicy.from_artifact(res.to_artifact()) \
        == res.to_policy()
    assert any(k.startswith("layers.") for k in res.formats)
    assert res.decode_impl is None      # the CPU default: the config's


def test_synthetic_calibration_digests_match_reference():
    _, cfg = build("llama3-8b", reduced=True)
    _, jcfg = jbuild("llama3-8b", reduced=True)
    for kw in (dict(n_sets=2, prompts_per_set=4, prompt_len=16, seed=0),
               dict(n_sets=3, prompts_per_set=2, prompt_len=9, seed=5)):
        got = synthetic_calibration(cfg, **kw)
        want = jcal.synthetic_calibration(jcfg, **kw)
        assert [s.prompts for s in got] == [s.prompts for s in want]
        assert [s.digest for s in got] == [s.digest for s in want]
        assert digest_of(got) == jcal.digest_of(want)


def test_calibration_tap_reservoir_and_engine_feed():
    tap, jtap = CalibrationTap(capacity=4, seed=0), \
        jcal.CalibrationTap(capacity=4, seed=0)
    for i in range(32):
        tap.observe([i, i + 1])
        jtap.observe([i, i + 1])
    assert len(tap) == 4 and tap.n_observed == 32
    assert tap._reservoir == jtap._reservoir
    with pytest.raises(ValueError, match="serve more traffic"):
        tap.sets(n_sets=4, prompts_per_set=2)
    sets = tap.sets(n_sets=2, prompts_per_set=2)
    assert [s.digest for s in sets] == \
        [s.digest for s in jtap.sets(n_sets=2, prompts_per_set=2)]
    # the engine feeds every admitted prompt to the tap
    model, cfg = build("llama3-8b", reduced=True)
    pol = get_policy("binary32", decode_impl="paged")
    params = model.init_params(torch.Generator().manual_seed(0), pol,
                               device="cpu")
    tap2 = CalibrationTap(capacity=8)
    eng = Engine(model, cfg, pol, params, slots=2, capacity=32,
                 page_size=8, calibration_tap=tap2, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, min(cfg.vocab, 97), 8).tolist()
               for _ in range(3)]
    eng.run([Request(i, p, 3) for i, p in enumerate(prompts)])
    assert tap2.n_observed == 3
    assert sorted(tuple(p) for p in prompts) == sorted(tap2._reservoir)


@pytest.fixture
def recorders(monkeypatch):
    """The three kernel wrappers, as the codec modules bound them,
    replaced by recorders."""
    calls = []

    def rec(name):
        def fn(x, fmt, **kw):
            calls.append((name, x.device.type, fmt.name, kw))
            return x
        return fn
    monkeypatch.setattr(tff, "flexfloat_cast", rec("flexfloat_cast"))
    monkeypatch.setattr(tqt, "quantize_encode", rec("quantize_encode"))
    monkeypatch.setattr(tqt, "dequantize_decode", rec("dequantize_decode"))
    return calls


def test_codec_dispatch_by_device(recorders):
    off_cpu = torch.empty((3, 5), device="meta")
    tff.quantize(off_cpu, "binary8", saturate=True)
    tqt.encode(off_cpu, "binary16alt")
    tqt.encode(off_cpu, "binary16alt", assume_quantized=True)
    tqt.decode(torch.empty((3, 5), dtype=torch.uint8, device="meta"),
               "binary8")
    assert recorders == [
        ("flexfloat_cast", "meta", "binary8", {"saturate": True}),
        ("quantize_encode", "meta", "binary16alt", {}),
        ("quantize_encode", "meta", "binary16alt", {}),
        ("dequantize_decode", "meta", "binary8", {})]
    # stochastic rounding routes to the cast kernel with its bits
    bits = torch.empty((3, 5), dtype=torch.int64, device="meta")
    tff.quantize(off_cpu, "binary8", rbits=bits)
    name, dev, fmt, kw = recorders[-1]
    assert (name, dev, fmt, sorted(kw)) == ("flexfloat_cast", "meta",
                                            "binary8", ["rbits", "saturate"])
    assert kw["rbits"] is bits and kw["saturate"] is False
    # binary32 and native-dtype payloads are bitcasts, not the codec
    assert tqt.encode(off_cpu, "binary32").dtype == torch.uint32
    assert tqt.encode(off_cpu.to(torch.bfloat16), "binary16alt").dtype \
        == torch.uint16
    assert tqt.decode(torch.empty(4, dtype=torch.uint32, device="meta"),
                      "binary32").dtype == torch.float32
    assert len(recorders) == 5

    # a CPU tensor takes the plain codec and never a wrapper
    x = torch.linspace(-3, 3, 15).reshape(3, 5)
    q = tff.quantize(x, "binary8", saturate=True)
    assert torch.equal(q, codec.quantize_tile(x, 5, 2, True))
    p = tqt.encode(x, "binary16alt")
    assert torch.equal(p, codec.encode_tile(codec.quantize_tile(x, 8, 7),
                                            "binary16alt"))
    assert torch.equal(tqt.decode(p, "binary16alt"),
                       codec.decode_tile(p, "binary16alt"))
    assert len(recorders) == 5


def test_serve_tuner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    model, cfg = build("llama3-8b", reduced=True)
    sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=1,
                                 prompt_len=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeTuner(model, cfg, sets)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_cli.main(["--reduced", "--sets", "1", "--prompts", "1",
                       "--prompt-len", "4"])
