"""Elastic scaling over ``torch.distributed``: the port of
``repro.runtime.elastic``.

``best_mesh_shape`` picks the (data, model) grid the reference picks for
a device count; :func:`make_elastic_mesh` builds that grid as a
``DeviceMesh`` over the running process group (one rank a device), or,
with no process group, the (1, 1) grid of one device as a ``MeshShape``;
a larger grid then raises and says to start a process group.
``surviving_devices_after`` drops the devices of failed hosts, a host
being a rank.  The reference's flow after a failure holds: rebuild the
mesh on the survivors, re-derive the shardings with the same rules
(``launch/sharding.py``) and restore the last checkpoint onto them
(``CheckpointManager.restore(..., shardings=)``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.ambient_mesh import MeshShape, make_mesh


def best_mesh_shape(n_devices: int, prefer_model: int = 16,
                    min_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) grid with model width <= prefer_model,
    maximal utilization, model a power-of-two divisor."""
    best = (1, 1)
    best_used = 0
    m = prefer_model
    while m >= min_model:
        data = n_devices // m
        used = data * m
        if used > best_used or (used == best_used and m > best[1]):
            best, best_used = (data, m), used
        m //= 2
    return best


def local_devices(device=None) -> List[torch.device]:
    """The local CUDA devices (``device`` alone when it is not CUDA)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_elastic_mesh(n_devices: Optional[int] = None, device=None):
    """The ``best_mesh_shape`` grid of ``n_devices`` (default: the
    process group's world size, else 1) as a ``("data", "model")``
    ``DeviceMesh`` over the running process group, on ``device``'s type
    (default ``cuda``).  With no process group the (1, 1) grid is a
    ``MeshShape``, and a larger grid raises."""
    import torch.distributed as dist

    running = dist.is_available() and dist.is_initialized()
    if n_devices is None:
        n_devices = dist.get_world_size() if running else 1
    data, model = best_mesh_shape(n_devices)
    if not running:
        if data * model > 1:
            raise RuntimeError(
                f"a ({data}, {model}) mesh needs {data * model} ranks: start "
                f"a process group first (torch.distributed."
                f"init_process_group, or the train CLI's --init-method "
                f"--world-size --rank, or torchrun)")
        return MeshShape(("data", "model"), (1, 1))
    return make_mesh((data, model), ("data", "model"),
                     resolve_device(device).type)


def surviving_devices_after(failed_host_ids, devices=None):
    """The devices whose host (process index, the rank) is not in
    ``failed_host_ids``: the local devices belong to this rank, 0 with
    no process group."""
    devices = devices if devices is not None else local_devices()
    host = 0
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        host = torch.distributed.get_rank()
    return [] if host in set(failed_host_ids) else list(devices)
