"""Sharding rules: logical roles -> a spec per dimension on a mesh; the
port of ``repro.launch.sharding``.

MaxText/t5x-style: a table of (path-keyword, dim-preference) rules,
applied with divisibility checks and a replicate fallback, so every
config (6-head whisper, 10-head recurrentgemma, 49155-vocab granite,
...) gets a valid sharding on a 16-wide model dim.  Megatron pairing:
column-parallel in-projections, row-parallel out-projections.  The rules
are the reference's, keyword for keyword.

A spec is a tuple with one entry per dimension, as the reference's
``PartitionSpec`` holds them: ``None`` (replicated), a dim name
(``"model"``) or a tuple of dim names (``("pod", "data")``, taken
together in row-major order).  :class:`NamedSharding` pairs a spec with
its mesh, as JAX's does.  A mesh is a ``DeviceMesh`` from
``launch/mesh.py`` or, for the rules alone, a :class:`MeshShape` (dim
names and sizes, no ranks): the rules read only the dims' names and
sizes, so the production meshes' specs and per-rank bytes are computed
without 256 processes.

Placement: a sharded leaf is stored as this rank's block, a plain
tensor, beside its ``NamedSharding``; ``local_block`` narrows a full
tensor to the block and ``gather_block`` gathers the blocks back (both
in ``core/collectives.py``, re-exported here).  The rules shard only
dimensions that divide evenly, so every block of a leaf has one shape.
(``torch.distributed.tensor.DTensor`` is not used: on gloo it refuses
uint16, the container of packed binary16 and binary16alt leaves, and
the kernels' wrappers and AdamW take plain tensors.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.core.ambient_mesh import (  # noqa: F401 (re-exported)
    MeshShape, axis_size, dp_axes)
from repro_torch.core.collectives import (  # noqa: F401 (re-exported)
    block_shape, gather_block, local_block, sharded_dims)
from repro_torch.core.tree import flatten_with_path, unflatten

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the counterpart of JAX's ``NamedSharding``)."""
    mesh: Any
    spec: Spec


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def param_spec(path: str, shape, mesh) -> Spec:
    """The spec of a parameter identified by its flattened path."""
    m = axis_size(mesh, "model")
    path = path.lower()
    nd = len(shape)

    def col(last_first=True):
        """shard the output (last) dim, else the input dim, else
        replicate."""
        dims = [None] * nd
        order = [nd - 1, 0] if last_first else [0, nd - 1]
        for d in order:
            if _div(shape[d], m):
                dims[d] = "model"
                return tuple(dims)
        return tuple(dims)

    if nd <= 1 or "norm" in path or "ln_" in path or "|mu" in path \
            or "lam" in path or "conv" in path or "b_" in path \
            or "w0" in path or "|u" in path or "cm_mu" in path:
        # small/1D: shard only if it's a wide vector divisible by m
        if nd == 1 and shape[0] >= 4096 and _div(shape[0], m):
            return ("model",)
        return (None,) * nd

    if "router" in path:
        return (None,) * nd  # tiny, routing-critical: replicate

    if "embed" in path:
        # (vocab, d): prefer vocab sharding
        if _div(shape[0], m):
            return ("model", None)
        if _div(shape[1], m):
            return (None, "model")
        return (None, None)

    if "head" in path:  # (d, vocab) -> column-parallel over vocab
        if _div(shape[1], m):
            return (None, "model")
        if _div(shape[0], m):
            return ("model", None)
        return (None, None)

    if nd == 3:  # MoE experts (E, d, ff) / (E, ff, d): expert-parallel
        if _div(shape[0], m):
            return ("model", None, None)
        return (None,) * nd

    # row-parallel out-projections (match the column-parallel producers)
    if any(k in path for k in ("wo", "w_out", "cm_v")):
        return col(last_first=False)

    # column-parallel in-projections: wq/wk/wv/wg, ffn w_in/w_gate, rwkv
    # r/k/v/g, rglru branch/gate, cm_k, cm_r, rec/in gates
    return col(last_first=True)


def batch_spec(batch_size: int, mesh, extra_dims: int = 1) -> Spec:
    """Shard the leading batch dim over as many data-parallel dims as
    divide it."""
    axes = []
    prod = 1
    for a in dp_axes(mesh):
        if _div(batch_size, prod * axis_size(mesh, a)):
            axes.append(a)
            prod *= axis_size(mesh, a)
    lead = tuple(axes) if axes else None
    return (lead,) + (None,) * extra_dims


def path_name(path) -> str:
    """A tree path as the reference's rules read it: keys and indices
    joined by ``|`` (``layers|0|mix|wq``)."""
    return "|".join(str(v) for _, v in path)


def tree_param_shardings(params, mesh):
    """A tree of :class:`NamedSharding` in ``params``' structure (an
    AdamW state's too: its ``step`` scalar is replicated)."""
    return unflatten(params, [
        NamedSharding(mesh, param_spec(path_name(p), tuple(leaf.shape),
                                       mesh))
        for p, leaf in flatten_with_path(params)])


def tree_state_shardings(state, mesh, batch_size: int):
    """Shardings for decode states / KV caches: batch over the
    data-parallel dims; the heads-or-head_dim dim over model when
    divisible.  ``None`` leaves (a layer without a state) stay ``None``;
    a Python number (a cache's ``pos``) is a replicated scalar."""
    m = axis_size(mesh, "model")
    blead = batch_spec(batch_size, mesh, extra_dims=0)[0]

    def one(leaf):
        if leaf is None:
            return None
        shape = tuple(getattr(leaf, "shape", ()))
        dims: list = [None] * len(shape)
        if len(shape) and shape[0] == batch_size:
            dims[0] = blead
        # shard the largest non-batch dim divisible by m (kv heads,
        # head_dim, rglru width, rwkv dh)
        cands = sorted(range(1, len(shape)), key=lambda d: -shape[d])
        for d in cands:
            if _div(shape[d], m) and shape[d] >= m:
                dims[d] = "model"
                break
        return NamedSharding(mesh, tuple(dims))

    return unflatten(state, [one(leaf) for _, leaf in
                             flatten_with_path(state)])


def scalar_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# placement of whole trees
# ---------------------------------------------------------------------------

def _pairs(tree, shardings):
    return zip([leaf for _, leaf in flatten_with_path(tree)],
               [s for _, s in flatten_with_path(shardings)])


def tree_local_blocks(tree, shardings):
    """Every leaf of a full tree narrowed to this rank's block."""
    return unflatten(tree, [local_block(t, s.spec, s.mesh)
                            for t, s in _pairs(tree, shardings)])


def tree_gather(tree, shardings):
    """Every leaf of a tree of blocks gathered to its full tensor."""
    return unflatten(tree, [gather_block(t, s.spec, s.mesh)
                            for t, s in _pairs(tree, shardings)])


def tree_block_bytes(tree, shardings) -> int:
    """Bytes one rank stores for ``tree`` (leaves may be ``meta``)."""
    total = 0
    for t, s in _pairs(tree, shardings):
        n = 1
        for x in block_shape(tuple(t.shape), s.spec, s.mesh):
            n *= x
        total += n * t.element_size()
    return total


def batch_rows(batch, mesh):
    """This rank's rows of every leaf of ``batch`` (dim 0, the batch,
    split by :func:`batch_spec` over the data-parallel dims)."""
    spec = batch_spec(batch["tokens"].shape[0], mesh, extra_dims=0)
    return {k: local_block(v, spec + (None,) * (v.dim() - 1), mesh)
            for k, v in batch.items()}
