"""The port's serve-time tuner on the recurrent and prefix-LM configs,
on the CPU against the JAX package.

* rwkv6-1.6b and recurrentgemma-2b, reduced, 1 calibration set x 2
  prompts x 8 tokens, ``decode_steps=2``, ``kv_groups=2``,
  ``max_rounds=1``, eps 0.2 (``tests/test_torch_serve_tuner.py``'s run),
  with the reference's weights handed over by ``params_for``: the same
  variables (every layer in the ``kv_cache`` groups, the recurrent state
  bound through them; no ``attn_probs`` on rwkv6), the same final formats,
  ``n_evals`` and byte counts (KV bytes per token: attention layers
  only) as the reference's ``ServeTuner``, run in a child with XLA's
  excess precision off.  The KL of the candidate with binary8 weights and
  KV (the recurrent states) and binary32 activations is within 1e-3
  relative of the reference's; ``final_kl`` within 20 % relative, as in
  the llama3-8b test (binary8 activations round a few values to other
  neighbours under the two sides' matmul orders).
* paligemma-3b, reduced, the stated departure: the port counts the
  ``prefix_len`` zero stub rows in ``_capacity`` and prefills them before
  every prompt.  Held to a subclass of the reference's ``ServeTuner``
  local to this test whose capacity counts the prefix (the same search
  and bytes), each candidate's log-probs to the reference's
  ``Model.prefill(..., capacity=prefix_len + C)`` / ``decode_step`` on
  the same weights, and the departure pinned: the reference's own
  ``ServeTuner`` (capacity without the prefix) gives other reference
  log-probs.
* The CLI on the three configs writes an artifact that the serve CLI
  loads with ``--policy PATH``.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.engine.worker import make_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.tuning import (ServeTuner,  # noqa: E402
                                synthetic_calibration)
from repro_torch.tuning import __main__ as tune_cli  # noqa: E402
from test_torch_serve_tuner import (_child_result,  # noqa: E402
                                    _reference_weights, _start_child)

RECURRENT = ("rwkv6-1.6b", "recurrentgemma-2b")
PALI = "paligemma-3b"
TUNE = dict(eps=0.2, decode_steps=2, kv_groups=2, max_rounds=1)

_PRELUDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import json
import numpy as np
from repro.models.registry import build
from repro.tuning import ServeTuner, synthetic_calibration
model, cfg = build(ARCH, reduced=True)
sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=2, prompt_len=8)
KW = dict(eps=0.2, decode_steps=2, kv_groups=2, max_rounds=1)

def probe(tuner):
    return {v: 3 if v in ("act", "attn_probs") else 0
            for v in tuner.variables}

def summary(tuner, res):
    return {"variables": {k: list(v) for k, v in tuner.variables.items()},
            "kl_probe": tuner._error(probe(tuner), 0),
            "formats": {k: f.name for k, f in res.formats.items()},
            "n_evals": res.n_evals, "final_kl": res.final_kl,
            "capacity": tuner._capacity,
            "bytes": [res.weight_bytes, res.weight_bytes_f32,
                      res.kv_bytes_per_token, res.kv_bytes_per_token_f32],
            "calibration": res.calibration}
"""

_REF_RECURRENT = _PRELUDE + """
tuner = ServeTuner(model, cfg, sets, **KW)
print("REF_TUNER " + json.dumps(summary(tuner, tuner.run())))
"""

# the reference's search with the prefix counted in its capacity: the
# subclass lives in this child only; src/repro is not changed
_REF_PREFIX = _PRELUDE + """
class PrefixTuner(ServeTuner):
    def _reference(self, cal):
        if not getattr(self, "_prefix_counted", False):
            self._capacity += self.cfg.prefix_len
            self._prefix_counted = True
        return super()._reference(cal)

tuner = PrefixTuner(model, cfg, sets, **KW)
out = summary(tuner, tuner.run())
# each candidate's log-probs on the reference's prefill / decode_step
cands = {"binary32": {v: 3 for v in tuner.variables},
         "probe": probe(tuner)}
out["kl_binary8"] = tuner._error({v: 0 for v in tuner.variables}, 0)
out["logp"] = {}
for name, assign in cands.items():
    jits = tuner._jits(tuner._policy(assign))
    out["logp"][name] = [
        tuner._run(jits, p, forced=ref_toks)[0].tolist()
        for p, (_, ref_toks) in zip(sets[0].prompts, tuner._refs[0])]
out["ref_logp"] = [r[0].tolist() for r in tuner._refs[0]]
out["ref_toks"] = [r[1] for r in tuner._refs[0]]
# the departure: the reference's own tuner sizes without the prefix
plain = ServeTuner(model, cfg, sets, **KW)
out["plain_capacity"] = plain._capacity
out["plain_ref_logp"] = [r[0].tolist() for r in plain._refs[0]]
print("REF_TUNER " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def children():
    """The reference's runs, started together in children that run
    while the port's side runs here."""
    procs = {a: _start_child(_REF_RECURRENT.replace("ARCH", repr(a)))
             for a in RECURRENT}
    procs[PALI] = _start_child(_REF_PREFIX.replace("ARCH", repr(PALI)))
    results = {}

    def get(arch):
        if arch not in results:
            results[arch] = _child_result(procs[arch], "REF_TUNER", 400)
        return results[arch]
    try:
        yield get
    finally:
        for p in procs.values():
            p.kill()
            p.communicate()


def _port_tuner(arch):
    model, cfg = build(arch, reduced=True)
    jmodel, _ = jbuild(arch, reduced=True)
    sets = synthetic_calibration(cfg, n_sets=1, prompts_per_set=2,
                                 prompt_len=8)
    tuner = ServeTuner(model, cfg, sets, device="cpu",
                       params_for=_reference_weights(jmodel), **TUNE)
    return tuner, cfg, sets


def _probe(tuner):
    return {v: 3 if v in ("act", "attn_probs") else 0
            for v in tuner.variables}


def _check_search(tuner, res, want):
    assert {k: list(v) for k, v in tuner.variables.items()} \
        == want["variables"]
    assert {k: f.name for k, f in res.formats.items()} == want["formats"]
    assert res.n_evals == want["n_evals"]
    assert res.final_kl == pytest.approx(want["final_kl"], rel=0.2, abs=0)
    assert [res.weight_bytes, res.weight_bytes_f32, res.kv_bytes_per_token,
            res.kv_bytes_per_token_f32] == want["bytes"]
    assert res.calibration == want["calibration"]
    assert tuner._capacity == want["capacity"]
    assert res.final_kl <= TUNE["eps"]
    assert PrecisionPolicy.from_artifact(res.to_artifact()) \
        == res.to_policy()


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_tuner_matches_reference_on_recurrent(arch, children):
    tuner, cfg, _ = _port_tuner(arch)
    res = tuner.run()
    want = children(arch)
    _check_search(tuner, res, want)
    assert tuner._error(_probe(tuner), 0) == pytest.approx(
        want["kl_probe"], rel=1e-3, abs=0)
    # every layer is in a kv_cache group; attention layers alone have
    # KV bytes per token; rwkv6 has no attn_probs variable
    groups = [k for v in tuner.variables.values() for k in v
              if k.endswith(".kv_cache")]
    assert groups == [f"layers.{li}.kv_cache"
                      for li in range(len(cfg.attn_pattern))]
    n_attn = sum(k == "attn" for k in cfg.attn_pattern)
    assert ("attn_probs" in tuner.variables) == bool(n_attn)
    assert res.kv_bytes_per_token_f32 == n_attn * cfg.n_kv \
        * cfg.head_dim * 2 * 4
    if cfg.window is not None:
        assert tuner._capacity <= cfg.window


def test_recurrent_state_takes_the_kv_cache_binding():
    """A layer's ``kv_cache`` binding sets its recurrent state's dtype:
    the state a candidate prefill returns is binary8 (e5m2) in a group
    bound to binary8 and f32 in one bound to binary32."""
    for arch in RECURRENT:
        tuner, cfg, sets = _port_tuner(arch)
        names = [v for v in tuner.variables if v.startswith("kv_cache")]
        assign = {v: 3 for v in tuner.variables}
        assign[names[0]] = 0
        policy = tuner._policy(assign)
        _, states = tuner.model.prefill(
            tuner._params(policy), make_batch(cfg, sets[0].prompts[0],
                                              "cpu"),
            policy, tuner._capacity)
        narrow = set(tuner.variables[names[0]])
        for li, st in enumerate(states):
            want = torch.float8_e5m2 if f"layers.{li}.kv_cache" in narrow \
                else torch.float32
            # a KVCache, RwkvState or RglruState: its float tensors
            dts = {t.dtype for t in st if isinstance(t, torch.Tensor)
                   and t.is_floating_point()}
            assert want in dts, (arch, li, dts)


def test_prefix_lm_search_matches_prefix_counting_reference(children):
    tuner, cfg, _ = _port_tuner(PALI)
    res = tuner.run()
    want = children(PALI)
    _check_search(tuner, res, want)
    assert tuner._capacity == cfg.prefix_len + 8 + 2
    assert tuner._error(_probe(tuner), 0) == pytest.approx(
        want["kl_probe"], rel=1e-3, abs=0)


# log-prob tolerances by candidate: f32 arithmetic apart in its order
# (binary32); binary8 weights and KV over f32 activations.  With binary8
# activations the two sides' matmul orders move a few activations to
# other binary8 neighbours, 25 % apart, and log-probs of ~-70 move by
# units: that candidate is held by its KL instead
LOGP_TOL = {"binary32": 1e-4, "probe": 1e-3}


@pytest.mark.parametrize("cand", sorted(LOGP_TOL))
def test_prefix_lm_candidate_logp_match_reference(cand, children):
    tuner, _, sets = _port_tuner(PALI)
    want = children(PALI)
    assign = ({v: 3 for v in tuner.variables} if cand == "binary32"
              else _probe(tuner))
    policy = tuner._policy(assign)
    for prompt, ref_toks, wlogp in zip(sets[0].prompts, want["ref_toks"],
                                       want["logp"][cand]):
        got, _ = tuner._run(policy, prompt, forced=ref_toks)
        np.testing.assert_allclose(got, np.asarray(wlogp, np.float32),
                                   rtol=0, atol=LOGP_TOL[cand])


def test_prefix_lm_binary8_candidate_kl_matches_reference(children):
    tuner, _, _ = _port_tuner(PALI)
    want = children(PALI)
    got = tuner._error({v: 0 for v in tuner.variables}, 0)
    assert got == pytest.approx(want["kl_binary8"], rel=0.2, abs=0)


def test_prefix_lm_departure_from_reference_tuner(children):
    """The port's reference log-probs equal the prefix-counting
    reference's and differ from the reference's own ``ServeTuner``'s,
    whose capacity leaves the prefix rows out."""
    tuner, cfg, _ = _port_tuner(PALI)
    want = children(PALI)
    assert want["plain_capacity"] == want["capacity"] - cfg.prefix_len
    for (got, _), kept, dropped in zip(tuner._refs[0], want["ref_logp"],
                                       want["plain_ref_logp"]):
        kept, dropped = np.asarray(kept), np.asarray(dropped)
        np.testing.assert_allclose(got, kept, rtol=0, atol=1e-4)
        # the prefill boundary reads no cache; the decode position does
        np.testing.assert_allclose(kept[0], dropped[0], rtol=0, atol=1e-5)
        assert np.abs(kept[1:] - dropped[1:]).max() > 1e-3


@pytest.mark.parametrize("arch", RECURRENT + (PALI,))
def test_tune_cli_artifact_serves(arch, tmp_path):
    path = str(tmp_path / f"{arch}.json")
    res = tune_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--sets", "1", "--prompts", "2", "--prompt-len",
                         "8", "--decode-steps", "2", "--max-rounds", "1",
                         "--eps", "0.2", "--out", path])
    assert res.final_kl <= 0.2
    _, cfg = build(arch, reduced=True)
    reqs = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--policy", path, "--requests", "2", "--slots", "2",
                       "--prompt-len", "8", "--max-new", "3",
                       "--capacity", str(cfg.prefix_len + 16),
                       "--page-size", "8"])
    assert [len(r.generated) for r in reqs] == [3, 3]
    assert all(r.done and not r.failed for r in reqs)
