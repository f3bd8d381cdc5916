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

``use_mesh(mesh)``, ``get_ambient_mesh()``, the axis helpers and
``make_mesh`` live in ``core/ambient_mesh.py``, below the kernels, the
checkpoints and the elastic runtime that read them, and are re-exported
here.  The data-parallel dims taken together (``("pod", "data")``) have
no process group of their own: the collectives of
``core/collectives.py`` reduce and gather over them one dim after the
other.
"""
from __future__ import annotations

from repro_torch.core.ambient_mesh import (  # noqa: F401 (re-exported)
    axis_names, axis_size, dp_axes, dp_size, get_ambient_mesh, make_mesh,
    model_axis_size, use_mesh)


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
