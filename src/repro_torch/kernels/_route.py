"""Where a kernel's wrapper sends its operands, and the shape route.

Every wrapper of a hand-written kernel asks :func:`route` once, on the
tensor whose device decides it:

``"cuda"``
    launch the kernel (a kernel that fails to build or launch raises);
``"cpu"``
    run the kernel's plain PyTorch version;
``"meta"``
    the shape route: no launch and no plain version.  The wrapper
    returns empty ``meta`` tensors of its outputs' shapes and dtypes and
    adds the kernel's operations and bytes to every active
    :class:`CostCount` (:func:`shape_route`).  The bytes come from the
    kernel's byte model beside it (each input read once, each output
    written once); the operations are written beside them.  Where the
    work depends on the data (a cache's valid lengths, an expert's kept
    rows), a ``meta`` tensor holds none, so the count is the most the
    shapes allow.

Any other device raises.  The collectives of ``core/collectives.py`` and
the ring's neighbour pass take the same route on a mesh without ranks
(``core/ambient_mesh.MeshShape``, read as rank 0): they record their kind
under the reference's HLO names and the bytes of their result
(:func:`record_collective`) and return ``meta`` tensors of the result's
shape.  ``launch/dryrun.py`` runs whole steps this way.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from . import _build

# the reference's names of the collectives (``launch/hlo_analysis.py``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def route(t: torch.Tensor) -> str:
    """``"cuda"``, ``"cpu"`` or ``"meta"`` for ``t``'s device; raise on
    any other."""
    kind = t.device.type
    if kind in ("cuda", "cpu", "meta"):
        return kind
    raise RuntimeError(f"repro_torch's kernels run on cuda (the kernel), "
                       f"cpu (its plain version) or meta (the shape "
                       f"route); got a tensor on {t.device}")


class CostCount:
    """What the shape route recorded while it was active: per kernel
    name its calls, operations and bytes; per collective kind its count
    and result bytes."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: Dict[str, Dict[str, float]] = {
            k: {"count": 0, "bytes": 0.0} for k in COLLECTIVES}

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)

    def add_collective(self, kind: str, nbytes: float) -> None:
        c = self.collectives[kind]
        c["count"] += 1
        c["bytes"] += float(nbytes)

    @property
    def flops(self) -> float:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())


_ACTIVE: List[CostCount] = []


@contextlib.contextmanager
def count_costs():
    """A :class:`CostCount` that every shape-route call inside the
    ``with`` block adds to (nested counts each get every record)."""
    count = CostCount()
    _ACTIVE.append(count)
    try:
        yield count
    finally:
        _ACTIVE.remove(count)


def meta_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def shape_route(name: str, outputs, *, flops: float, nbytes: float,
                **operands):
    """Record one kernel call of ``name`` and return ``outputs`` (the
    caller's ``meta`` tensors) unchanged.  Like a launch, it refuses
    ``operands`` that autograd would need a gradient of
    (``_build.check_no_grad``): its outputs record no gradient either."""
    _build.check_no_grad(name, **operands)
    for count in _ACTIVE:
        count.add_kernel(name, flops, nbytes)
    return outputs


def record_collective(kind: str, result: torch.Tensor) -> torch.Tensor:
    """Record one collective of ``kind`` moving ``result``'s bytes and
    return ``result``."""
    nbytes = result.numel() * result.element_size()
    for count in _ACTIVE:
        count.add_collective(kind, nbytes)
    return result
