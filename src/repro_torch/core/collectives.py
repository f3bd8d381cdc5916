"""Collectives over the named dims of a mesh, plain and differentiable:
what ``jax.lax.psum`` / ``pmean`` / ``all_gather`` over an axis name do
inside the reference's ``shard_map``.

A dim's process group is ``mesh.get_group(axis)``; its ranks are in the
order of the rank's coordinate along that dim.  A dim of one rank has
nothing to reduce or gather and issues no collective, so a
:class:`~repro_torch.core.ambient_mesh.MeshShape` of such dims (the
(1, 1) grid of one device) runs every function here with no process
group.  Several dims taken together (the data-parallel dims
``("pod", "data")``) are reduced over each in turn, the innermost first,
with no private ``DeviceMesh`` API: a sum over them adds the innermost
dim's values first, then those sums across the next dim out, so it sums
in another order than one flat reduction would.  A gather over them
concatenates the innermost dim's blocks first, which gives the blocks in
row-major order of the dims' coordinates, as a ``PartitionSpec`` entry
``("pod", "data")`` orders them.

On a :class:`~repro_torch.core.ambient_mesh.MeshShape` (a mesh's dims
without ranks, read as rank 0) a collective over a dim of more than one
rank takes the shape route of ``kernels/_route.py``: it records its kind
under the reference's HLO name and its result's bytes, and returns a
``meta`` tensor of its result's shape (``launch/dryrun.py``).

gloo (the CPU backend) has no float8 or 16/32-bit unsigned integers: a
gather moves such tensors as the signed integers of their width; a sum
refuses them.

Placement (``launch/sharding.py`` re-exports it): a sharded leaf is
stored as this rank's block, a plain tensor, beside its spec (a tuple
with one entry per dimension: ``None``, a dim name or a tuple of dim
names); :func:`local_block` narrows a full tensor to the block and
:func:`gather_block` gathers the blocks back.

The differentiable forms are ``autograd.Function``s for the one
convention the port's sharded training uses: every rank of a dim
computes the same loss from the same (replicated) values, so a
replicated cotangent needs no reduction.  So :func:`sum_over` (the
expert-parallel combine) passes its cotangent through unchanged,
:func:`enter_partial` (a replicated value entering a computation whose
ranks each hold a part of the result) sums its cotangents over the dim,
:func:`mean_over` (the aux loss over data shards) passes its cotangent
through (the data-parallel gradients are averaged afterwards), and
:func:`gather_rows` (the dense MoE's tokens over data shards) sums its
cotangents and keeps the rank's rows.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from repro_torch.kernels._route import meta_empty, record_collective

from .ambient_mesh import MeshShape, axis_names, axis_size

Axes = Union[str, Sequence[str]]

# dtypes gloo cannot move, gathered as the signed integers of their width
_WIRE = {torch.uint16: torch.int16, torch.uint32: torch.int32,
         torch.float8_e5m2: torch.int8, torch.float8_e4m3fn: torch.int8}


def as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``mesh``'s dim ``axis`` (0 on a dim
    of one rank)."""
    return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0


def axes_size(mesh, axes: Axes) -> int:
    n = 1
    for a in as_axes(axes):
        n *= axis_size(mesh, a)
    return n


def axes_index(mesh, axes: Axes) -> int:
    """This rank's block along ``axes`` taken together (row-major)."""
    i = 0
    for a in as_axes(axes):
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    return i


def _live(mesh, axes: Axes) -> Tuple[str, ...]:
    """The dims of ``axes`` that ``mesh`` has with more than one rank,
    innermost first."""
    names = axis_names(mesh)
    return tuple(a for a in reversed(as_axes(axes))
                 if a in names and axis_size(mesh, a) > 1)


def all_reduce_sum(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, each dim in turn: a new tensor, or
    ``t`` itself when no dim of ``axes`` has more than one rank."""
    import torch.distributed as dist
    live = _live(mesh, axes)
    if not live:
        return t
    if t.dtype in _WIRE:
        raise TypeError(f"gloo cannot sum {t.dtype}: decode it first")
    if isinstance(mesh, MeshShape):
        out = meta_empty(t.shape, t.dtype)
        for _ in live:
            record_collective("all-reduce", out)
        return out
    out = t.clone()
    for a in live:
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


def all_gather_cat(t: torch.Tensor, mesh, axes: Axes,
                   dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` over ``axes`` concatenated along ``dim`` in
    row-major order of their coordinates (``t`` itself when no dim of
    ``axes`` has more than one rank)."""
    import torch.distributed as dist
    for a in _live(mesh, axes):
        t = t.contiguous()
        n = axis_size(mesh, a)
        if isinstance(mesh, MeshShape):
            shape = list(t.shape)
            shape[dim] *= n
            t = record_collective("all-gather",
                                  meta_empty(shape, t.dtype))
            continue
        if t.dtype in _WIRE:
            wt = t.view(_WIRE[t.dtype])
            parts = [torch.empty_like(wt) for _ in range(n)]
            dist.all_gather(parts, wt, group=mesh.get_group(a))
            parts = [p.view(t.dtype) for p in parts]
        else:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=mesh.get_group(a))
        t = torch.cat(parts, dim=dim)
    return t


def _fresh(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A Function's output: a view when the collective had nothing to do
    and handed back its input."""
    return x.view_as(x) if out is x else out


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _fresh(all_reduce_sum(x, mesh, axes), x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _fresh(all_reduce_sum(x, mesh, axes), x) \
            / axes_size(mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, x.shape[0]
        return _fresh(all_gather_cat(x, mesh, axes, dim=0), x)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axes)
        i = axes_index(ctx.mesh, ctx.axes)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


def sum_over(x, mesh, axes: Axes):
    """``psum`` of rank parts into a replicated value; its cotangent is
    passed to every part unchanged."""
    return _SumOver.apply(x, mesh, as_axes(axes))


def enter_partial(x, mesh, axes: Axes):
    """``x`` unchanged; the cotangents the ranks' parts give it are
    summed over ``axes``."""
    return _EnterPartial.apply(x, mesh, as_axes(axes))


def mean_over(x, mesh, axes: Axes):
    """``pmean`` over ``axes``; the cotangent passes through unchanged
    (the data-parallel gradient is averaged afterwards)."""
    return _MeanOver.apply(x, mesh, as_axes(axes))


def gather_rows(x, mesh, axes: Axes):
    """The ranks' rows (dim 0) over ``axes`` in row-major order; the
    cotangent of the rank's rows is the sum of every rank's for them."""
    return _GatherRows.apply(x, mesh, as_axes(axes))


# ---------------------------------------------------------------------------
# placement: a rank's block of a leaf, and the gather back
# ---------------------------------------------------------------------------

def sharded_dims(spec) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim, axes) of every sharded dimension of ``spec``."""
    return [(d, as_axes(e)) for d, e in enumerate(spec) if e is not None]


def block_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(shape)
    for d, axes in sharded_dims(spec):
        n = axes_size(mesh, axes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({n} ranks)")
        out[d] //= n
    return tuple(out)


def local_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` (a copy when a dim is split, so the
    full tensor can be freed; ``full`` itself when none is split, every
    sharded dim having one rank)."""
    dims = [(d, axes) for d, axes in sharded_dims(spec)
            if axes_size(mesh, axes) > 1]
    if not dims:
        return full
    out = full
    for d, axes in dims:
        n = axes_size(mesh, axes)
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        size = full.shape[d] // n
        out = out.narrow(d, axes_index(mesh, axes) * size, size)
    return out.clone()


def gather_block(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block (``local`` itself when no
    dim is split).  Every rank of the sharded dims takes part."""
    for d, axes in sharded_dims(spec):
        local = all_gather_cat(local, mesh, axes, dim=d)
    return local
