"""The mesh decode wrappers (``flash_shmap``, ``ring``) and the mesh
module, on the CPU with gloo, against the JAX package.

* Spellings: ``legal_impls()``, ``canonicalize_impl`` and
  ``validate_impl`` equal the reference's on every spelling and on bad
  ones; ``PrecisionPolicy`` and ``ModelConfig`` take every legal one.
* The byte models ``attention_hbm_bytes``, ``ring_ppermute_bytes`` and
  ``paged_ring_ppermute_bytes`` equal the reference's on a grid.
* 2 processes (mesh (1, 2)), then 4 (mesh (2, 2): the batch split over
  the data dim; and mesh (1, 4) over the same group: a ring of four,
  whose shards take three hops), started with ``sys.executable`` on
  ``tests/torch_mesh_rank.py`` through a ``file://`` rendezvous, each
  under a 120 s timeout: all 11 spellings on seeded inputs (B 4, S 96,
  H 2, G 4, dh 32; a contiguous cache and a pool of 24 shuffled pages
  of 16; lengths 96, 0, 7 and 53 on the two-way meshes: an empty row,
  one inside the first shard, one across the shard boundary; 53, 0, 30
  and 79 on the four-way one: rows ending inside the 2nd, 3rd and 4th
  of its 24-row shards), binary8 and binary32, within the conformance
  tolerance of the reference's ``flash_decode_reference`` (contiguous
  bases) or ``paged_decode_reference`` (``paged``)
  (``tests/test_conformance.py``: 1e-6, 2e-2 for the ``xla`` base on a
  narrow format), every rank's output the same (bit for bit but under
  ``ring``, whose ranks fold the shards in their own rotation order:
  within 1e-6), the empty row exactly 0, and the sharded branch taken by
  every wrapped spelling.  With two ranks a ring's next and previous
  rank are one rank; the four-way ring tells the directions and the
  shard owners apart.
* The engine on the 2 ranks (reduced llama3-8b, binary32, 3 requests x
  (8 + 5) over 2 slots, capacity 24, page 8): under every wrapped
  spelling the greedy tokens equal the base spelling's and the
  reference's single-device ``synchronous_generate``; in one process
  with no mesh each wrapped spelling falls back to its base.
* ``_merge_partials`` against the reference's under
  ``jax.vmap(axis_name="model")`` and ``_ring_fold`` against the
  reference's, on host-split shards with empty ones, in several rotation
  orders.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.formats import get_format as jget_format  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.qtensor import encode as jencode  # noqa: E402
from repro.engine.reference import \
    synchronous_generate as jsync  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch.core.policy import (PrecisionPolicy,  # noqa: E402
                                     binary32_policy, get_policy)
from repro_torch.engine import Engine, Request  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402,F401
from repro_torch.models.base import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.tuning.artifact import save_artifact  # noqa: E402
from test_torch_model import to_numpy  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_mesh_rank.py")
TIMEOUT = 120
B, S, H, G, DH = 4, 96, 2, 4, 32
RAGGED = (96, 0, 7, 53)
RAGGED_1X4 = (53, 0, 30, 79)
PAGE, NUM_PAGES = 16, 24
FMTS = ("binary8", "binary32")
WORLDS = (2, 4)
# mesh -> (ranks, the npz suffix of its lengths and tables)
MESHES = {"1x2": (2, ""), "2x2": (4, ""), "1x4": (4, "_1x4")}
IMPLS = jdispatch.legal_impls()
WRAPPED = tuple(s for s in IMPLS if len(dispatch.canonicalize_impl(s)) > 1)
SHARDED = ("_shmap_decode", "_shmap_decode_paged", "_ring_decode",
           "_ring_decode_paged")
PROMPTS = [[3, 17, 42, 7, 99, 1, 64, 23], [9, 8, 7, 6, 5, 4, 3, 2],
           [11, 22, 33, 44, 55, 66, 77, 88]]
MAX_NEW, CAPACITY = 5, 24


def _base_of(impl):
    return dispatch.canonicalize_impl(impl)[-1]


def _tol(impl, fmt):
    """The conformance suite's tolerance: the ``xla`` base computes on
    bf16 operands for a narrow format."""
    return 2e-2 if _base_of(impl) == "xla" and fmt != "binary32" else 1e-6


def _shuffled_tables(needs, seed=1):
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(NUM_PAGES).tolist())
    tables = np.full((B, S // PAGE), -1, np.int32)
    for b, need in enumerate(needs):
        for p in range(need):
            tables[b, p] = next(perm)
    return tables


def _scattered_pool(payload, tables):
    pool = np.zeros((NUM_PAGES, PAGE) + payload.shape[2:], payload.dtype)
    for b in range(B):
        for p in range(tables.shape[1]):
            if tables[b, p] >= 0:
                pool[tables[b, p]] = payload[b, p * PAGE:(p + 1) * PAGE]
    return pool


def _inputs(path):
    """The seeded cases every rank reads, and the reference's oracles by
    (case suffix, format, base kind)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, H, G, DH)).astype(np.float32)
    k = rng.normal(size=(B, S, H, DH)).astype(np.float32)
    v = rng.normal(size=(B, S, H, DH)).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(DH))
    arrays = dict(q=q, scale=scale, prompts=np.asarray(PROMPTS, np.int64),
                  max_new=MAX_NEW)
    oracle = {}
    for case, ragged, needs, seed in (("", RAGGED, [6, 0, 1, 4], 1),
                                      ("_1x4", RAGGED_1X4, [4, 0, 2, 5],
                                       2)):
        lengths = np.asarray(ragged, np.int32)
        tables = _shuffled_tables(needs, seed)
        arrays.update({f"lengths{case}": lengths, f"tables{case}": tables})
        for fmt in FMTS:
            jf = jget_format(fmt)
            kp = np.asarray(jencode(jnp.asarray(k), jf))
            vp = np.asarray(jencode(jnp.asarray(v), jf))
            kpool = _scattered_pool(kp, tables)
            vpool = _scattered_pool(vp, tables)
            arrays.update({f"k_{fmt}": kp, f"v_{fmt}": vp,
                           f"kpool{case}_{fmt}": kpool,
                           f"vpool{case}_{fmt}": vpool})
            oracle[case, fmt, "contiguous"] = np.asarray(
                jfa.flash_decode_reference(
                    jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jf,
                    jnp.asarray(lengths), scale=float(scale)))
            oracle[case, fmt, "paged"] = np.asarray(
                jpa.paged_decode_reference(
                    jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
                    jf, jnp.asarray(lengths), jnp.asarray(tables),
                    scale=float(scale)))
    np.savez(path, **arrays)
    return oracle


def _engine_params(path):
    """Reduced llama3-8b's binary32 weights from the reference, saved for
    the ranks, and the reference's ``synchronous_generate`` tokens."""
    jmodel, jcfg = jbuild("llama3-8b", reduced=True)
    jpol = jget_policy("binary32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jpol)
    torch.save(params_from_numpy(to_numpy(jparams), device="cpu"), path)
    return jsync(jmodel, jcfg, jpol, jparams, PROMPTS, max_new=MAX_NEW,
                 capacity=CAPACITY)


def _spawn(world, root, inputs, params):
    """Start ``world`` ranks; returns a function that waits for them (each
    under its own timeout) and reads their reports."""
    out = os.path.join(root, f"world{world}")
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE),
                                                   "src"),
               OMP_NUM_THREADS="1")
    argv = [os.path.join(root, f"rendezvous{world}"), inputs, out]
    if params is not None:
        argv.append(params)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world)]
                              + argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]

    def wait():
        try:
            for r, p in enumerate(procs):
                try:
                    _, err = p.communicate(timeout=TIMEOUT)
                except subprocess.TimeoutExpired:
                    pytest.fail(f"world {world}: rank {r} did not finish "
                                f"within {TIMEOUT} s")
                if p.returncode:
                    pytest.fail(f"world {world}: rank {r} exited "
                                f"{p.returncode}\n{err}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                rep = json.load(f)
            rep["out"] = dict(np.load(os.path.join(out, f"rank{r}.npz")))
            ranks.append(rep)
        return ranks
    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks, one world after the other (one thread a rank,
    so that the suite's other workers keep their cores); the 2-rank
    world also serves the engine."""
    root = str(tmp_path_factory.mktemp("mesh"))
    inputs = os.path.join(root, "inputs.npz")
    oracle = _inputs(inputs)
    params = os.path.join(root, "params.pt")
    want_tokens = _engine_params(params)
    ranks = {w: _spawn(w, root, inputs, params if w == 2 else None)()
             for w in WORLDS}
    return dict(oracle=oracle, ranks=ranks, tokens=want_tokens)


# ---------------------------------------------------------------------------
# spellings and byte models
# ---------------------------------------------------------------------------

BAD = ("flash_shmap+ring+xla", "ring+ring", "bogus", "flash_shmap+",
       "xla+paged", "paged+flash_shmap", "ring+flash_shmap", "")


def test_spellings_match_reference():
    assert dispatch.legal_impls() == jdispatch.legal_impls()
    assert dispatch.WRAPPER_IMPLS == jdispatch.WRAPPER_IMPLS
    for spec in IMPLS + BAD:
        assert dispatch.canonicalize_impl(spec) \
            == jdispatch.canonicalize_impl(spec)
    for spec in IMPLS:
        assert dispatch.validate_impl(spec) == spec
        assert callable(dispatch.resolve_decode(spec))
        assert dispatch.resolve_prefill(spec) \
            is dispatch.resolve_prefill(_base_of(spec))
    for spec in BAD:
        with pytest.raises(ValueError):
            jdispatch.validate_impl(spec)
        with pytest.raises(ValueError, match="legal spellings"):
            dispatch.validate_impl(spec)
    assert dispatch.canonicalize_impl("ring") == ("ring", "xla")


def test_policy_and_config_take_every_spelling():
    for spec in IMPLS:
        assert PrecisionPolicy(formats={}, decode_impl=spec).decode_impl \
            == spec
        assert ModelConfig(arch="t", family="dense", n_layers=1, d_model=64,
                           n_heads=4, n_kv=2, d_ff=128, vocab=64,
                           decode_impl=spec).decode_impl == spec
    with pytest.raises(ValueError, match="legal spellings"):
        PrecisionPolicy(formats={}, decode_impl="ring+ring")


@pytest.mark.parametrize("fmt", [None, "binary8", "binary16alt",
                                 "binary32"], ids=lambda f: f or "f32")
def test_byte_models_match_reference(fmt):
    for batch, seq, n_kv, dh, g in [(1, 64, 8, 128, 4), (4, 256, 1, 256, 8),
                                    (3, 96, 2, 32, 1)]:
        assert tfa.attention_hbm_bytes(batch, seq, n_kv, dh, fmt, g=g) \
            == jfa.attention_hbm_bytes(batch, seq, n_kv, dh, fmt, g=g)
        for n in (1, 2, 4, 8):
            assert tfa.ring_ppermute_bytes(batch, seq, n_kv, dh, fmt,
                                           n_devices=n) \
                == jfa.ring_ppermute_bytes(batch, seq, n_kv, dh, fmt,
                                           n_devices=n)
    for pages, page, n_kv, dh in [(24, 16, 2, 32), (64, 64, 8, 128)]:
        for n in (1, 2, 4, 8):
            assert tpa.paged_ring_ppermute_bytes(pages, page, n_kv, dh, fmt,
                                                 n_devices=n) \
                == jpa.paged_ring_ppermute_bytes(pages, page, n_kv, dh, fmt,
                                                 n_devices=n)


# ---------------------------------------------------------------------------
# the mesh module and the fallbacks, in this process
# ---------------------------------------------------------------------------

class _StubMesh:
    """Enough of a DeviceMesh for the gating (no process group)."""
    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, dim):
        return self.shape[dim]


def test_mesh_helpers_and_ambient_mesh():
    stub = _StubMesh((2, 4, 8), ("pod", "data", "model"))
    assert mesh_mod.dp_axes(stub) == ("pod", "data")
    assert mesh_mod.model_axis_size(stub) == 8
    assert mesh_mod.dp_size(stub) == 8
    assert mesh_mod.production_shape() == ((16, 16), ("data", "model"))
    assert mesh_mod.production_shape(multi_pod=True) \
        == ((2, 16, 16), ("pod", "data", "model"))
    assert dispatch._batch_pspec(stub, 16) == ("pod", "data")
    assert dispatch._batch_pspec(stub, 12) is None
    assert mesh_mod.get_ambient_mesh() is None
    assert dispatch.default_serving_impl("cuda") == "flash_pallas"
    with mesh_mod.use_mesh(stub):
        assert mesh_mod.get_ambient_mesh() is stub
        assert dispatch.default_serving_impl("cuda") \
            == "flash_shmap+flash_pallas"
        assert dispatch.default_serving_impl("cpu") is None
        with mesh_mod.use_mesh(_StubMesh((2,), ("data",))):
            assert dispatch.default_serving_impl("cuda") == "flash_pallas"
        assert mesh_mod.get_ambient_mesh() is stub
    assert mesh_mod.get_ambient_mesh() is None
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
        with pytest.raises(RuntimeError, match="process group"):
            mesh_mod.make_production_mesh()


@pytest.fixture
def spies(monkeypatch):
    calls = []
    for name in SHARDED:
        monkeypatch.setattr(dispatch, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    return calls


def test_wrapper_fallback_conditions(spies):
    """The reference's fallbacks: no mesh, no ``model`` dim, a storage
    axis the model size does not divide, or residuals asked for -- the
    base runs unsharded and no sharded branch is called."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(2, 2, 4, 32)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(2, 90, 2, 32)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 90, 2, 32)), dtype=torch.float32)
    n = torch.tensor([90, 11], dtype=torch.int32)
    pol = binary32_policy()
    for impl in WRAPPED:
        if _base_of(impl) == "paged":
            continue
        want = dispatch.resolve_decode(_base_of(impl))(
            q, k, v, n, scale=0.17, policy=pol)
        fn = dispatch.resolve_decode(impl)
        for mesh in (None, _StubMesh((2,), ("data",)),
                     _StubMesh((1, 4), ("data", "model"))):   # 90 % 4
            with mesh_mod.use_mesh(mesh):
                assert torch.equal(fn(q, k, v, n, scale=0.17, policy=pol),
                                   want)
        with mesh_mod.use_mesh(_StubMesh((1, 2), ("data", "model"))):
            o, m, l = fn(q, k, v, n, scale=0.17, policy=pol,
                         return_residuals=True)
        wo, wm, wl = dispatch.resolve_decode(_base_of(impl))(
            q, k, v, n, scale=0.17, policy=pol, return_residuals=True)
        assert torch.equal(o, wo) and torch.equal(m, wm) \
            and torch.equal(l, wl)
    assert spies == []


def test_wrapped_spellings_fall_back_in_the_engine_without_mesh(spies):
    """One process, no mesh: every wrapped spelling serves its base's
    tokens."""
    model, cfg = build("llama3-8b", reduced=True)
    params = model.init_params(torch.Generator().manual_seed(0),
                               get_policy("binary32"), device="cpu")

    def tokens(impl):
        eng = Engine(model, cfg, get_policy("binary32", decode_impl=impl),
                     params, slots=2, capacity=CAPACITY, page_size=8,
                     device="cpu")
        reqs = [Request(i, p, 3) for i, p in enumerate(PROMPTS)]
        eng.run(reqs)
        return [r.generated for r in reqs]
    base = {b: tokens(b) for b in dispatch.BASE_IMPLS}
    for impl in WRAPPED:
        assert tokens(impl) == base[_base_of(impl)], impl
    assert spies == []


def test_serve_refuses_disaggregate_with_a_wrapped_spelling():
    for impl in ("flash_shmap", "ring+paged"):
        with pytest.raises(ValueError, match="disaggregate"):
            serve.main(["--arch", "llama3-8b", "--reduced", "--device",
                        "cpu", "--decode-impl", impl, "--disaggregate",
                        "--requests", "1"])


def test_tuned_artifact_with_a_wrapped_spelling_serves(tmp_path):
    """A tuned artifact pinning ``flash_shmap+paged`` loads and serves
    (no mesh here: the base's tokens)."""
    from repro_torch.tuning.artifact import load_policy
    src = os.path.join(os.path.dirname(HERE), "results", "tuned",
                       "llama3-8b.reduced.json")
    pol = load_policy(src)
    flags = ["--arch", "llama3-8b", "--reduced", "--device", "cpu",
             "--requests", "2", "--slots", "2", "--prompt-len", "8",
             "--max-new", "3", "--capacity", "24", "--page-size", "8"]
    got = {}
    for impl in ("flash_shmap+paged", "paged"):
        path = str(tmp_path / f"{impl}.json")
        art = PrecisionPolicy(formats=pol.formats, mode=pol.mode,
                              default_fmt=pol.default_fmt, decode_impl=impl,
                              matmul_impl=pol.matmul_impl).to_artifact()
        save_artifact(art, path)
        assert load_policy(path).decode_impl == impl
        got[impl] = [r.generated for r in serve.main(flags + ["--policy",
                                                              path])]
    assert got["flash_shmap+paged"] == got["paged"]
    assert all(len(g) == 3 for g in got["paged"])


# ---------------------------------------------------------------------------
# the merge and the fold against the reference's on host-split shards
# ---------------------------------------------------------------------------

def _host_split(n, fmt="binary8", seed=5):
    """Per-shard partials of the reference's oracle at each shard's local
    lengths, stacked on a leading shard axis (row 1 leaves every shard
    empty, row 2 all but the first), and the unsplit oracle."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(B, H, G, DH)), jnp.float32)
    jf = jget_format(fmt)
    kp, vp = (jencode(jnp.asarray(rng.normal(size=(B, S, H, DH)),
                                  jnp.float32), jf) for _ in range(2))
    oracle = jax.jit(lambda q, k, v, n, res: jfa.flash_decode_reference(
        q, k, v, jf, n, return_residuals=res), static_argnums=4)
    lengths = np.asarray(RAGGED, np.int32)
    s_loc = S // n
    parts = []
    for i in range(n):
        local = np.clip(lengths - i * s_loc, 0, s_loc).astype(np.int32)
        sl = slice(i * s_loc, (i + 1) * s_loc)
        parts.append([np.asarray(t) for t in oracle(
            q, kp[:, sl], vp[:, sl], jnp.asarray(local), True)])
    o, m, l = (np.stack([p[j] for p in parts]) for j in range(3))
    whole = np.asarray(oracle(q, kp, vp, jnp.asarray(lengths), False))
    return o, m, l, whole


@pytest.mark.parametrize("n", [2, 4, 8])
def test_merge_partials_matches_reference(n):
    o, m, l, whole = _host_split(n)
    assert (l[:, 1] == 0).all() and (m[:, 1] == jfa.NEG_INF).all()
    got = dispatch._merge_partials(torch.from_numpy(o), torch.from_numpy(m),
                                   torch.from_numpy(l)).numpy()
    want = np.asarray(jax.vmap(jdispatch._merge_partials,
                               axis_name="model")(o, m, l))
    for i in range(n):        # every member of the axis holds the merge
        np.testing.assert_allclose(got, want[i], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)
    assert not np.isnan(got).any() and (got[1] == 0).all()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_fold_matches_reference_in_any_order(n):
    o, m, l, whole = _host_split(n, seed=6)
    rng = np.random.default_rng(n)
    orders = [list(range(n)), list(range(n))[::-1]] + [
        rng.permutation(n).tolist() for _ in range(2)]
    for order in orders:
        acc, m_run, l_run = dispatch._ring_state(torch.zeros(B, H, G, DH))
        jacc, jm, jl = jdispatch._ring_state(jnp.zeros((B, H, G, DH)))
        for i in order:
            acc, m_run, l_run = dispatch._ring_fold(
                acc, m_run, l_run, torch.from_numpy(o[i]),
                torch.from_numpy(m[i]), torch.from_numpy(l[i]))
            jacc, jm, jl = jdispatch._ring_fold(jacc, jm, jl, o[i], m[i],
                                                l[i])
            np.testing.assert_allclose(acc.numpy(), np.asarray(jacc),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(m_run.numpy(), np.asarray(jm))
            np.testing.assert_allclose(l_run.numpy(), np.asarray(jl),
                                       rtol=1e-6, atol=0)
        got = dispatch._ring_finalize(acc, l_run).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jdispatch._ring_finalize(jacc, jl)), rtol=0,
            atol=1e-6)
        np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)
        assert not np.isnan(got).any() and (got[1] == 0).all()


def test_empty_shard_folds_and_merges_to_a_no_op():
    """(0, NEG_INF, 0) leaves a running state bit for bit as it was and
    adds nothing to a merge."""
    o, m, l, _ = _host_split(2, seed=7)
    o0, m0, l0 = (torch.from_numpy(t[0]) for t in (o, m, l))
    empty = (torch.zeros_like(o0), torch.full_like(m0, jfa.NEG_INF),
             torch.zeros_like(l0))
    state = dispatch._ring_fold(*dispatch._ring_state(o0), o0, m0, l0)
    again = dispatch._ring_fold(*state, *empty)
    for a, b in zip(state, again):
        assert torch.equal(a, b)
    fresh = dispatch._ring_fold(*dispatch._ring_state(o0), *empty)
    assert torch.equal(dispatch._ring_finalize(fresh[0], fresh[2]),
                       torch.zeros_like(o0))
    merged = dispatch._merge_partials(*(torch.stack([x, e]) for x, e in
                                        zip((o0, m0, l0), empty)))
    alone = dispatch._merge_partials(o0[None], m0[None], l0[None])
    assert torch.equal(merged, alone)
    both_empty = dispatch._merge_partials(*(torch.stack([e, e])
                                            for e in empty))
    assert torch.equal(both_empty, torch.zeros_like(o0))


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_spelling_matches_oracle(mesh, impl, fmt, runs):
    world, case = MESHES[mesh]
    ranks = runs["ranks"][world]
    key = f"{fmt}__{impl}"
    want = runs["oracle"][case, fmt, "paged" if _base_of(impl) == "paged"
                          else "contiguous"]
    first = ranks[0]["out"][f"{mesh}__{key}"]
    for r, rep in enumerate(ranks):
        got = rep["out"][f"{mesh}__{key}"]
        assert not np.isnan(got).any()
        err = float(np.abs(got - want).max())
        assert err <= _tol(impl, fmt), (mesh, r, impl, fmt, err)
        if dispatch.canonicalize_impl(impl)[0] == "ring":
            # rank i folds the shards of i, i-1, ...: another order on
            # every rank, the same softmax within f32 rounding
            np.testing.assert_allclose(got, first, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, first)  # the same bits
        assert (got[1] == 0).all()                    # the empty row
        taken = rep["meshes"][mesh]["taken"][key]
        if impl in WRAPPED:
            wrapper = dispatch.canonicalize_impl(impl)[0]
            want_branch = {"flash_shmap": "_shmap_decode",
                           "ring": "_ring_decode"}[wrapper] + (
                "_paged" if _base_of(impl) == "paged" else "")
            assert taken == [want_branch], (r, taken)
        else:
            assert taken == []


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_ranks_and_default_serving_impl(mesh, runs):
    ranks = runs["ranks"][MESHES[mesh][0]]
    n_data, n_model = (int(n) for n in mesh.split("x"))
    coords = sorted(tuple(r["meshes"][mesh]["coordinate"]) for r in ranks)
    assert coords == [(d, m) for d in range(n_data)
                      for m in range(n_model)]
    assert all(r["meshes"][mesh]["default_cuda"]
               == "flash_shmap+flash_pallas" for r in ranks)


@pytest.mark.parametrize("impl", WRAPPED)
def test_engine_tokens_under_a_mesh(impl, runs):
    ranks = runs["ranks"][2]
    for rep in ranks:
        assert rep["tokens"][impl] == rep["tokens"][_base_of(impl)]
        assert rep["tokens"][impl] == runs["tokens"]
        assert rep["engine_taken"][impl], impl
        assert rep["tokens"][impl] == ranks[0]["tokens"][impl]
    assert all(len(t) == MAX_NEW for t in runs["tokens"])
