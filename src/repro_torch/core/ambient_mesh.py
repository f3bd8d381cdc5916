"""The process's ambient device mesh and the axis helpers the mesh decode
wrappers read: the port of ``repro.compat``'s ``use_mesh`` /
``get_ambient_mesh``.

It sits below the kernels (``kernels/dispatch.py`` reads it on every
wrapped decode call) and imports nothing: ``launch/mesh.py`` builds the
meshes and re-exports these names.

``use_mesh(mesh)`` makes ``mesh`` the ambient mesh for the ``with``
block and ``get_ambient_mesh()`` returns it (None outside any block).
The ambient mesh is process-wide, not per thread, so the engine's decode
steps see it from the router's worker thread too.  A mesh is anything
with ``mesh_dim_names`` and ``size(dim)``, as a
``torch.distributed.device_mesh.DeviceMesh`` has.
"""
from __future__ import annotations

import contextlib
from typing import Optional

_AMBIENT: list = []   # the stack of meshes set by ``use_mesh``


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
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block (nested
    blocks stack; the previous mesh comes back on exit)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_ambient_mesh() -> Optional[object]:
    """The mesh of the innermost ``use_mesh`` block, or None."""
    return _AMBIENT[-1] if _AMBIENT else None
