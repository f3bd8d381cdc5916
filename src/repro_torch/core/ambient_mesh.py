"""The process's ambient device mesh, the axis helpers the mesh decode
wrappers read, and the meshes themselves: the port of ``repro.compat``'s
``use_mesh`` / ``get_ambient_mesh`` and of ``repro.launch.mesh``'s
``make_mesh``.

It sits below the kernels (``kernels/dispatch.py`` reads it on every
wrapped decode call), the checkpoints and the elastic runtime, and
imports nothing of the port; ``launch/mesh.py`` re-exports these names.
:func:`make_mesh` builds a ``DeviceMesh`` over the running process group
(``torch.distributed`` is imported only there); :class:`MeshShape` is a
mesh's dim names and sizes without ranks, for the sharding rules and for
the (1, 1) grid of one device with no process group.

``use_mesh(mesh)`` makes ``mesh`` the ambient mesh for the ``with``
block and ``get_ambient_mesh()`` returns it (None outside any block).
``use_mesh(mesh, batch_split=axes)`` also says that the activations of
the block hold only this rank's rows of the batch, split over the dims
``axes`` (the lead of ``launch/sharding.batch_spec``, as the sharded
train step feeds them); ``batch_split_axes()`` reads it.  Without it
every rank holds the whole batch (the serving engine hands every rank
all operands).
The ambient mesh is process-wide, not per thread, so the engine's decode
steps see it from the router's worker thread too.  A mesh is anything
with ``mesh_dim_names`` and ``size(dim)``, as a
``torch.distributed.device_mesh.DeviceMesh`` has.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

_AMBIENT: list = []   # the stack of (mesh, batch_split) set by use_mesh


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes without ranks: what the rules read
    (``mesh_dim_names`` and ``size(dim)``, as a ``DeviceMesh`` has).  It
    stands for rank 0 (every coordinate 0).  A collective over a dim of
    one rank runs none; over a wider dim it takes the shape route
    (``core/collectives.py``): recorded and answered with a ``meta``
    tensor of its result's shape."""
    mesh_dim_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def size(self, dim) -> int:
        if isinstance(dim, str):
            dim = self.mesh_dim_names.index(dim)
        return self.sizes[dim]

    def get_local_rank(self, dim: str) -> int:
        return 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.mesh_dim_names, self.sizes))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group's
    ranks (row-major), its dims named ``axes``.  Raises ``RuntimeError``
    when no process group is running and ``ValueError`` when the world
    size is not the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a running process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    return mesh.size(axis_names(mesh).index(axis))


def dp_axes(mesh) -> tuple:
    """The data-parallel dim names of a mesh (everything but 'model')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def model_axis_size(mesh) -> int:
    return axis_size(mesh, "model")


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n


@contextlib.contextmanager
def use_mesh(mesh, batch_split: tuple = ()):
    """Make ``mesh`` the ambient mesh inside the ``with`` block (nested
    blocks stack; the previous mesh comes back on exit)."""
    _AMBIENT.append((mesh, tuple(batch_split)))
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_ambient_mesh() -> Optional[object]:
    """The mesh of the innermost ``use_mesh`` block, or None."""
    return _AMBIENT[-1][0] if _AMBIENT else None


def batch_split_axes() -> tuple:
    """The dims the innermost ``use_mesh`` block's batch is split over
    (empty: every rank holds the whole batch)."""
    return _AMBIENT[-1][1] if _AMBIENT else ()
