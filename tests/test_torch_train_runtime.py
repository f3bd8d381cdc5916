"""The port's training runtime against the JAX package: AdamW, gradient
compression, checkpoints, the data pipeline, the watchdog, the mesh
arithmetic and the train CLI.

* ``adamw.apply`` + ``materialize_params``, one step of reduced
  llama3-8b from the same numpy grads and state (the reference jitted
  with XLA's excess precision off).  Measured: without the clip acting,
  binary32's moments bit for bit and 19 of 106,816 master elements 1-2
  ulps apart (XLA's CPU fusion contracts products into FMAs, which
  ``adamw.py`` copies where it can); under transprecision v bit for bit
  and 5 bf16 moments one bf16 ulp apart; with the clip acting the two
  packages sum the squared norm in different orders, so every update
  may move by an ulp.  Held: m and v within one ulp of their format
  (with the clip acting, or within 1e-5 x the leaf's max: a moment that
  cancels near 0 is many of its ulps off), the master within 2e-4 x lr
  (one f32 ulp of a weight near 1 is 1.2e-4 x lr), the materialized
  params within one ulp of their format or the master's 2e-4 x lr.
* ``grad_compress``: payloads and residuals bit for bit the
  reference's; the residual is the rounding error; error feedback cuts
  the bias of the time-averaged signal (``tests/test_distributed.py:
  119-147``).
* A checkpoint the reference's ``CheckpointManager`` wrote of reduced
  llama3-8b's ``(params, opt_state)`` restores into the port's tree bit
  for bit, and the port's own checkpoints restore the same way; a
  restart repeats the uninterrupted run bit for bit.
* ``SyntheticLM``: the reference's stream in structure and properties
  (it draws with ``jax.random``, the port with ``torch.Generator``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.core.formats import BINARY8 as JBINARY8  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynth  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.runtime.elastic import best_mesh_shape as jbest  # noqa: E402
from repro.runtime.watchdog import StepWatchdog as JWatchdog  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.formats import BINARY8  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime.watchdog import StepWatchdog  # noqa: E402

NO_EXCESS = {"xla_allow_excess_precision": False}
MANT = {torch.float32: 23, torch.bfloat16: 7}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def _t(tree):
    return params_from_numpy(to_numpy(tree), device="cpu")


def _jstate_to_port(st):
    return adamw.AdamWState(step=torch.tensor(int(st.step),
                                              dtype=torch.int32),
                            master=_t(st.master), m=_t(st.m), v=_t(st.v))


def _within_ulps(got, want, n, atol=0.0, rel=0.0):
    """Every element of ``got`` within ``n`` ulps (of its own dtype) of
    the numpy tree ``want``, or within ``atol``, or within ``rel`` x its
    leaf's max |want|."""
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - MANT[g.dtype])
        d = np.abs(g.float().numpy() - w)
        tol = max(atol, rel * float(np.abs(w).max()))
        assert ((d <= n * ulp) | (d <= tol)).all()


@pytest.mark.parametrize("clip_acts", [False, True])
@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
def test_adamw_step_matches_reference(pol, clip_acts):
    jm, _ = jbuild("llama3-8b", reduced=True)
    jp, tp = jget_policy(pol), get_policy(pol)
    params = jm.init_params(jax.random.PRNGKey(0), jp)
    rng = np.random.default_rng(0)
    scale = 1.0 if clip_acts else 1e-4       # global norm ~300 or ~0.03
    g1, g2 = (jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                           .astype(np.float32), params) for _ in range(2))
    step = jax.jit(lambda g, s: jadamw.apply(g, s, jp, lr=1e-3),
                   compiler_options=NO_EXCESS)
    _, st1 = step(g1, jadamw.init(params, jp))
    _, st2 = step(g2, st1)
    want_params = jadamw.materialize_params(st2, params, jp)
    got_master, got = adamw.apply(_t(g2), _jstate_to_port(st1), tp, lr=1e-3)
    assert int(got.step) == 2 and got_master is got.master
    rel = 1e-5 if clip_acts else 0.0
    _within_ulps(got.m, st2.m, 1, rel=rel)
    _within_ulps(got.v, st2.v, 1, rel=rel)
    err = max(float(np.abs(a.numpy() - np.asarray(b)).max())
              for a, b in zip(leaves(got.master), jax.tree.leaves(st2.master)))
    assert err <= 2e-4 * 1e-3, err
    if pol == "binary32" and not clip_acts:
        for a, b in zip(leaves(got.m) + leaves(got.v),
                        jax.tree.leaves(st2.m) + jax.tree.leaves(st2.v)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got_params = adamw.materialize_params(got, _t(params), tp)
    for a, b in zip(leaves(got_params), jax.tree.leaves(want_params)):
        assert a.dtype == tp.dtype("attn_w") or a.dtype == torch.float32
        assert a.dtype == _t(np.asarray(b)).dtype
    _within_ulps(got_params, want_params, 1, atol=2e-4 * 1e-3)


def test_adamw_updates_the_donated_state_in_place():
    """``apply`` writes into the state it is given (the reference's step
    donates it) and gives the bits a fresh copy of that state gives."""
    jm, _ = jbuild("llama3-8b", reduced=True)
    pol = get_policy("transprecision")
    params = _t(jm.init_params(jax.random.PRNGKey(0),
                               jget_policy("transprecision")))
    grads = tree_map(lambda p: torch.randn(p.shape).to(p.dtype), params)
    st = adamw.init(params, pol)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        leaves(st.master), leaves(params)))
    copy = adamw.AdamWState(*(tree_map(torch.clone, t) for t in st))
    keep = [t.data_ptr() for t in leaves(st)[1:]]
    _, got = adamw.apply(grads, st, pol)
    _, want = adamw.apply(grads, copy, pol)
    assert [t.data_ptr() for t in leaves(got)[1:]] == keep
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-1.6b",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_materialize_roles_match_reference(arch):
    """The role-from-path rule on every leaf kind (an MoE router under
    ``ffn``, rwkv's ``mu`` / ``ln_*`` / decay LoRA, rglru's gates and
    ``lam``, the encoder and cross attention): the same dtypes and bits."""
    jm, _ = jbuild(arch, reduced=True)
    jp, tp = jget_policy("transprecision"), get_policy("transprecision")
    params = jm.init_params(jax.random.PRNGKey(0), jp)
    st = jadamw.init(params, jp)
    want = jadamw.materialize_params(st, params, jp)
    got = adamw.materialize_params(adamw.init(_t(params), tp), _t(params),
                                   tp)
    for a, b in zip(leaves(got), leaves(_t(want))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_compress_matches_reference_and_error_feedback():
    rng = np.random.default_rng(0)
    g = rng.normal(scale=1e-3, size=(4, 256)).astype(np.float32)
    res = rng.normal(scale=1e-5, size=(4, 256)).astype(np.float32)
    for r in (None, res):
        jp_, jr = jgc.compress(jnp.asarray(g), None if r is None
                               else jnp.asarray(r), JBINARY8)
        tp_, tr = grad_compress.compress(torch.tensor(g), None if r is None
                                         else torch.tensor(r), BINARY8)
        assert tp_.dtype == torch.uint8
        np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        deq = grad_compress.decompress(tp_, BINARY8)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(
            jgc.decompress(jp_, JBINARY8)))
        full = g if r is None else g + r
        np.testing.assert_allclose((deq + tr).numpy(), full, rtol=0,
                                   atol=1e-9)
    # error feedback: the time-averaged signal tracks the mean
    true = torch.tensor(np.random.default_rng(1).normal(scale=1e-4,
                                                        size=(512,)),
                        dtype=torch.float32)
    acc_ef, acc_naive, res_t = torch.zeros(512), torch.zeros(512), None
    for _ in range(64):
        p, res_t = grad_compress.compress(true, res_t, BINARY8)
        acc_ef += grad_compress.decompress(p, BINARY8)
        p2, _ = grad_compress.compress(true, None, BINARY8)
        acc_naive += grad_compress.decompress(p2, BINARY8)
    err_ef = float(torch.linalg.norm(acc_ef / 64 - true))
    err_naive = float(torch.linalg.norm(acc_naive / 64 - true))
    assert err_ef < 0.2 * err_naive, (err_ef, err_naive)


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    jm, _ = jbuild("llama3-8b", reduced=True)
    jp = jget_policy("transprecision")
    params = jm.init_params(jax.random.PRNGKey(0), jp)
    st = jadamw.init(params, jp)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 1e-3, jnp.float32), params)
    _, st = jadamw.apply(g, st, jp)
    params = jadamw.materialize_params(st, params, jp)
    JCkpt(str(tmp_path), async_save=False).save(7, (params, st),
                                                extra={"note": "ref"})
    tp = get_policy("transprecision")
    model, _ = build("llama3-8b", reduced=True)
    like_p = model.init_params(torch.Generator().manual_seed(1), tp,
                               device="cpu")
    like = (like_p, adamw.init(like_p, tp))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    (tparams, tst), meta = mgr.restore(7, like)
    assert meta["step"] == 7 and meta["extra"] == {"note": "ref"}
    assert isinstance(tst, adamw.AdamWState) and int(tst.step) == 1
    assert tst.step.dtype == torch.int32
    for a, b in zip(leaves((tparams, tst)), leaves((_t(params),
                                                    _jstate_to_port(st)))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_layout_gc_and_atomicity(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [torch.ones(2, dtype=torch.bfloat16),
                  {"c": torch.tensor(3, dtype=torch.int32),
                   "e": torch.full((3,), 0.25).to(torch.float8_e5m2)}]}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, tree_map(lambda x: (x.float() * s).to(x.dtype), tree),
                 extra={"step": s})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    files = sorted(os.listdir(tmp_path / "step_3"))
    assert files == ["k:a.npy", "k:b|i:0.npy", "k:b|i:1|k:c.npy",
                     "k:b|i:1|k:e.npy", "manifest.json"]
    raw = np.load(tmp_path / "step_3" / "k:b|i:0.npy")
    assert raw.dtype == np.uint16          # bf16 as its container
    restored, meta = mgr.restore(3, tree)
    assert meta["keys"]["k:b|i:0"]["dtype"] == "bfloat16"
    assert meta["keys"]["k:b|i:1|k:e"]["dtype"] == "float8_e5m2"
    for a, b in zip(leaves(restored), leaves(tree)):
        assert a.dtype == b.dtype
        assert torch.equal(a.float(), b.float() * 3)
    os.makedirs(tmp_path / "step_9.tmp")   # a writer that died
    assert mgr.latest_step() == 3


def test_restart_is_bit_exact(tmp_path):
    """Three steps, a checkpoint, a restore and three more steps give the
    six uninterrupted steps' params bit for bit (the counterpart of
    ``tests/test_distributed.py:47-76``)."""
    pol = get_policy("binary32")
    model, cfg = build("llama3-8b", reduced=True)
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=32), cfg)
    params = model.init_params(torch.Generator().manual_seed(0), pol,
                               device="cpu")
    step = ttrain.make_train_step(model, pol, 1e-3)
    p1, o1 = params, adamw.init(params, pol)
    for i in range(6):
        _, p1, o1 = step(p1, o1, data.batch_at(i))
    mgr = CheckpointManager(str(tmp_path))
    p2, o2 = params, adamw.init(params, pol)
    for i in range(3):
        _, p2, o2 = step(p2, o2, data.batch_at(i))
    mgr.save(2, (p2, o2), extra={"data": data.state(2)})
    _, p2, o2 = step(p2, o2, data.batch_at(3))    # lost in the crash
    mgr.wait()
    (p2, o2), meta = mgr.restore(2, (p2, o2))
    for i in range(meta["extra"]["data"]["step"] + 1, 6):
        _, p2, o2 = step(p2, o2, data.batch_at(i))
    for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b)


def _ramp_ok(tokens, labels, top):
    """The stream's structure: labels are tokens shifted by one, and in
    each row, for one offset r in [0, 7), every position t with (t + r)
    % 3 != 0 holds (t + r) % top."""
    toks = np.concatenate([tokens, labels[:, -1:]], axis=1)
    assert (toks[:, 1:-1] == labels[:, :-1]).all()
    t = np.arange(toks.shape[1])
    for row in toks:
        assert any(((row == (t + r) % top) | ((t + r) % 3 == 0)).all()
                   for r in range(7))
    assert toks.min() >= 0 and toks.max() < top


@pytest.mark.parametrize("arch", ["llama3-8b", "paligemma-3b",
                                  "whisper-tiny"])
def test_data_pipeline_has_the_reference_properties(arch):
    model, cfg = build(arch, reduced=True)
    dcfg = DataConfig(seed=3, global_batch=4, seq_len=24)
    data = SyntheticLM(dcfg, cfg)
    ref = JSynth(JData(seed=3, global_batch=4, seq_len=24),
                 jbuild(arch, reduced=True)[1]).batch_at(5)
    b = data.batch_at(5)
    assert sorted(b) == sorted(ref)
    for k, v in b.items():
        r = np.asarray(ref[k])
        assert tuple(v.shape) == r.shape, k
        assert str(v.dtype).split(".")[-1] == r.dtype.name, k
    top = min(cfg.vocab, 97)
    _ramp_ok(b["tokens"].numpy(), b["labels"].numpy(), top)
    _ramp_ok(np.asarray(ref["tokens"]), np.asarray(ref["labels"]), top)
    for k in ("prefix_embeds", "encoder_embeds"):
        if k in b:
            assert abs(float(b[k].std()) - 0.02) < 0.002
    # a pure function of (seed, step, host): skip-ahead and restarts
    again = SyntheticLM(dcfg, cfg).batch_at(5)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(data.batch_at(6)["tokens"], b["tokens"])
    halves = [SyntheticLM(DataConfig(seed=3, global_batch=4, seq_len=24,
                                     n_hosts=2, host_id=h), cfg).batch_at(5)
              for h in (0, 1)]
    assert all(h["tokens"].shape == (2, 24) for h in halves)
    assert not torch.equal(halves[0]["tokens"], halves[1]["tokens"])
    assert SyntheticLM.restore(data.state(5), dcfg, cfg).host_batch == 4
    with pytest.raises(ValueError, match="seed"):
        SyntheticLM.restore(data.state(5), DataConfig(seed=4), cfg)


def test_watchdog_and_mesh_match_reference():
    rng = np.random.default_rng(2)
    delays = [0.1 + 0.001 * (i % 3) for i in range(20)] + [0.5, 0.11] \
        + list(0.1 + 0.3 * rng.random(40))
    got, want = [], []
    wd = StepWatchdog(k_sigma=3.0, min_ratio=1.4, warmup_steps=3,
                      on_straggler=lambda s, dt: got.append(s))
    jwd = JWatchdog(k_sigma=3.0, min_ratio=1.4, warmup_steps=3,
                    on_straggler=lambda s, dt: want.append(s))
    for i, dt in enumerate(delays):
        assert wd.observe(i, dt) == jwd.observe(i, dt)
    assert got == want and 20 in got
    assert (wd.mean, wd.var) == (jwd.mean, jwd.var)
    for n in (1, 2, 3, 7, 12, 16, 240, 256, 512, 1000):
        for pm in (1, 4, 16):
            assert elastic.best_mesh_shape(n, prefer_model=pm) == \
                jbest(n, prefer_model=pm)
    mesh = elastic.make_elastic_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="start a process group"):
        elastic.make_elastic_mesh(8, device="cpu")
    devs = [torch.device("cpu")]
    assert elastic.surviving_devices_after([1], devs) == devs
    assert elastic.surviving_devices_after([0], devs) == []


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "llama3-8b", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    losses = ttrain.main(argv + ["--steps", "3"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "attention=xla" in out and "mesh={'data': 1, 'model': 1}" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    more = ttrain.main(argv + ["--steps", "5", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(more) == 2 and all(np.isfinite(more))
    # the same steps as one uninterrupted run
    straight = ttrain.main(argv + ["--steps", "5", "--ckpt-dir",
                                   str(tmp_path / "b")])
    assert straight[:3] == losses and straight[3:] == more
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            ttrain.main(["--reduced", "--steps", "1"])
        else:
            raise RuntimeError("no CUDA device check on a card")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-1.6b",
                                  "recurrentgemma-2b", "paligemma-3b",
                                  "whisper-tiny"])
def test_train_cli_on_every_family(arch, tmp_path):
    """Three transprecision steps: from the second on, every leaf is in
    the storage dtype ``materialize_params`` gives its path (rwkv's f32
    decay LoRA becomes bf16, an MoE router bf16), and the forward still
    runs."""
    losses = ttrain.main(["--arch", arch, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "8", "--device", "cpu",
                          "--ckpt-every", "0", "--ckpt-dir", str(tmp_path),
                          "--log-every", "10"])
    assert len(losses) == 3 and all(np.isfinite(losses))
