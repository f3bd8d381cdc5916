"""The port's sharding rules (``launch/sharding.py``) against the JAX
package's (``repro.launch.sharding``), on the CPU with no ranks.

* ``param_spec`` leaf for leaf on all ten configs at full size, on the
  meshes (16, 16), (2, 16, 16) with ``pod``, (2, 4), (1, 2), (2, 2) and
  (1, 4): the reference's shapes from ``jax.eval_shape`` (no
  allocation), the port's from its ``meta`` device, the reference given
  a mesh with only ``.shape`` and ``.axis_names`` (all its rules read).
* ``tree_param_shardings`` on the AdamW state (the reference's own tree
  walk, with its ``NamedSharding`` replaced by a box in this test's
  namespace, since a duck mesh cannot make one), ``batch_spec`` on a
  grid of batch sizes, and ``tree_state_shardings`` on the decode states
  of the reduced configs.
* Per-rank bytes (``tree_block_bytes``) equal the sum the reference's
  specs give, and the block shapes divide.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import flatten_with_path  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x4": (("data", "model"), (2, 4)),
    "1x2": (("data", "model"), (1, 2)),
    "2x2": (("data", "model"), (2, 2)),
    "1x4": (("data", "model"), (1, 4)),
}


class DuckMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


class Box:
    """Stands in for the reference's ``NamedSharding`` (a leaf)."""

    def __init__(self, mesh, spec):
        self.spec = spec


def meshes(name):
    names, sizes = MESHES[name]
    return DuckMesh(names, sizes), sharding.MeshShape(names, sizes)


def jspec(spec) -> tuple:
    """A spec's entries as plain tuples, a one-name tuple as its name
    (JAX's ``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    def one(e):
        if isinstance(e, (list, tuple)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(one(e) for e in spec)


@pytest.fixture(scope="module")
def shapes():
    """Per config: the reference's flat (path, shape) list (eval_shape)
    and the port's meta param tree, under transprecision."""
    out = {}
    for arch in configs.ARCHS:
        jmodel, _ = jbuild(arch)
        jpol = jget_policy("transprecision")
        jtree = jax.eval_shape(
            lambda k: jmodel.init_params(k, jpol), jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
        jflat = [("|".join(jsharding._pstr(p) for p in path),
                  tuple(leaf.shape)) for path, leaf in flat]
        model, _ = build(arch)
        params = model.init_params(torch.Generator(),
                                   get_policy("transprecision"),
                                   device="meta")
        out[arch] = (jflat, params)
    return out


def test_configs_are_the_reference_s():
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_spec_matches_reference(shapes, arch, mesh_name):
    jmesh, mesh = meshes(mesh_name)
    jflat, params = shapes[arch]
    flat = flatten_with_path(params)
    assert [(sharding.path_name(p), tuple(t.shape)) for p, t in flat] \
        == jflat
    got = [s.spec for _, s in flatten_with_path(
        sharding.tree_param_shardings(params, mesh))]
    want = [jspec(jsharding.param_spec(path, shape, jmesh))
            for path, shape in jflat]
    assert got == want
    # every block shape divides, and the per-rank bytes are the specs'
    total = 0
    for (_, t), spec in zip(flat, want):
        blk = sharding.block_shape(tuple(t.shape), spec, mesh)
        total += int(np.prod(blk)) * t.element_size()
    shs = sharding.tree_param_shardings(params, mesh)
    assert sharding.tree_block_bytes(params, shs) == total
    assert any(s != (None,) * len(s) for s in got) or \
        mesh.size(len(mesh.sizes) - 1) == 1 or arch == "whisper-tiny"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rwkv_fused_param_spec_matches_reference(mesh_name):
    """rwkv6-1.6b with ``rwkv_fused=1`` at full size: ``wrkvg`` (2048,
    8256) and ``cm_kr`` (2048, 9216) fall to column-parallel, leaf for
    leaf the reference's specs."""
    import dataclasses

    from repro.models.registry import build_from_config
    from repro_torch.models.transformer import Model

    jcfg = dataclasses.replace(jconfigs.get("rwkv6-1.6b"), rwkv_fused=1)
    jtree = jax.eval_shape(lambda k: build_from_config(jcfg).init_params(
        k, jget_policy("transprecision")), jax.random.PRNGKey(0))
    jflat = [("|".join(jsharding._pstr(p) for p in path), tuple(leaf.shape))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    cfg = dataclasses.replace(configs.get("rwkv6-1.6b"), rwkv_fused=1)
    params = Model(cfg).init_params(torch.Generator(),
                                    get_policy("transprecision"),
                                    device="meta")
    jmesh, mesh = meshes(mesh_name)
    flat = flatten_with_path(params)
    assert [(sharding.path_name(p), tuple(t.shape)) for p, t in flat] \
        == jflat
    got = [s.spec for _, s in flatten_with_path(
        sharding.tree_param_shardings(params, mesh))]
    assert got == [jspec(jsharding.param_spec(path, shape, jmesh))
                   for path, shape in jflat]
    specs = dict(zip([p for p, _ in jflat], got))
    for leaf in ("wrkvg", "cm_kr"):
        assert specs[f"layers|0|mix|{leaf}"] == (None, "model")


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x4", "1x4"])
@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b"])
def test_adamw_state_shardings_match_reference(shapes, arch, mesh_name,
                                               monkeypatch):
    jmesh, mesh = meshes(mesh_name)
    jmodel, _ = jbuild(arch)
    jpol = jget_policy("transprecision")
    jstate = jax.eval_shape(
        lambda k: jadamw.init(jmodel.init_params(k, jpol), jpol),
        jax.random.PRNGKey(0))
    monkeypatch.setattr(jsharding, "NamedSharding", Box)
    want = [jspec(b.spec) for b in jax.tree_util.tree_leaves(
        jsharding.tree_param_shardings(jstate, jmesh),
        is_leaf=lambda x: isinstance(x, Box))]
    params = shapes[arch][1]
    state = adamw.init(params, get_policy("transprecision"))
    got = [s.spec for _, s in flatten_with_path(
        sharding.tree_param_shardings(state, mesh))]
    assert got == want
    assert got[0] == ()            # the step counter is replicated


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_matches_reference(mesh_name):
    jmesh, mesh = meshes(mesh_name)
    for b in (1, 2, 3, 4, 8, 16, 32, 64, 512, 1024):
        for extra in (0, 1, 2):
            assert jspec(sharding.batch_spec(b, mesh, extra)) == \
                jspec(jsharding.batch_spec(b, jmesh, extra))


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_state_shardings_match_reference(arch, monkeypatch):
    """The decode states of the reduced configs (B 4, capacity 16)."""
    B, cap = 4, 16
    jmodel, _ = jbuild(arch, reduced=True)
    jpol = jget_policy("transprecision")
    jstate = jax.eval_shape(lambda: jmodel.init_state(B, cap, jpol))
    model, _ = build(arch, reduced=True)
    state = model.init_state(B, cap, get_policy("transprecision"),
                             device="meta")
    shapes = [tuple(getattr(t, "shape", ())) for _, t in
              flatten_with_path(state) if t is not None]
    assert shapes == [tuple(x.shape)
                      for x in jax.tree_util.tree_leaves(jstate)]
    monkeypatch.setattr(jsharding, "NamedSharding", Box)
    for mesh_name in MESHES:
        jmesh, mesh = meshes(mesh_name)
        want = [jspec(b.spec) for b in jax.tree_util.tree_leaves(
            jsharding.tree_state_shardings(jstate, jmesh, B),
            is_leaf=lambda x: isinstance(x, Box))]
        got = [jspec(s.spec) for _, s in flatten_with_path(
            sharding.tree_state_shardings(state, mesh, B))
            if s is not None]
        assert got == want, mesh_name


def test_scalar_sharding_and_errors():
    _, mesh = meshes("2x4")
    assert sharding.scalar_sharding(mesh).spec == ()
    assert sharding.block_shape((8, 6), ("model", None), mesh) == (2, 6)
    assert sharding.block_shape((8, 6), (("data", "model"), None),
                                mesh) == (1, 6)
    with pytest.raises(ValueError, match="divide"):
        sharding.block_shape((6, 6), ("model", None), mesh)


def test_one_rank_dims_run_no_collective():
    """A dim of one rank has nothing to reduce or gather: on the (1, 1)
    grid (a ``MeshShape``, no process group) every collective and
    placement helper hands its input back, and the differentiable forms
    pass values and cotangents through.  A sum of a dtype gloo cannot
    add refuses before any collective."""
    from repro_torch.core import collectives as coll

    one = sharding.MeshShape(("data", "model"), (1, 1))
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    dp = ("data",)
    assert coll.all_reduce_sum(t, one, dp) is t
    assert coll.all_gather_cat(t, one, ("data", "model"), dim=1) is t
    assert coll.axes_index(one, ("data", "model")) == 0
    spec = (("data", "model"), "model")
    assert sharding.local_block(t, spec, one) is t
    assert sharding.gather_block(t, spec, one) is t
    x = t.clone().requires_grad_(True)
    outs = [coll.sum_over(x, one, "model"), coll.enter_partial(x, one, dp),
            coll.mean_over(x, one, dp), coll.gather_rows(x, one, dp)]
    for y in outs:
        assert torch.equal(y, t) and y is not x
    (g,) = torch.autograd.grad(sum((k + 1) * y.sum()
                                   for k, y in enumerate(outs)), x)
    assert torch.equal(g, torch.full_like(t, 10.0))
    two = sharding.MeshShape(("data", "model"), (2, 1))
    with pytest.raises(TypeError, match="cannot sum"):
        coll.all_reduce_sum(torch.zeros(4, dtype=torch.uint16), two, dp)
