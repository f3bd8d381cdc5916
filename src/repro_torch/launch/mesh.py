"""Device meshes over ``torch.distributed``: the port of
``repro.launch.mesh`` and of the ambient-mesh helpers of
``repro.compat`` (``use_mesh``, ``get_ambient_mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``("data", "model")``, or ``("pod", "data", "model")`` for the
multi-pod shape; the mesh decode wrappers of ``kernels/dispatch.py``
shard a cache's storage axis over its ``model`` dim and the batch over
the others.  The caller starts the default process group first
(``torch.distributed.init_process_group`` with its address, world size
and rank): nothing here reads a cluster's environment, and importing
this module touches no process-group state.

Single pod: 16 x 16 = 256 ranks.  Multi-pod: 2 x 16 x 16 = 512, a
leading pure data-parallel ``pod`` dim.

``use_mesh(mesh)``, ``get_ambient_mesh()`` and the axis helpers live in
``core/ambient_mesh.py``, below the kernels that read them, and are
re-exported here.
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.ambient_mesh import (  # noqa: F401 (re-exported)
    axis_names, axis_size, dp_axes, dp_size, get_ambient_mesh,
    model_axis_size, use_mesh)


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


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) ``("data", "model")``,
    or (2, 16, 16) with a leading ``pod`` dim."""
    return make_mesh(*production_shape(multi_pod), device_type)
