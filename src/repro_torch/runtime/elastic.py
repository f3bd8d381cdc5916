"""Elastic scaling on the local CUDA devices: the port of
``repro.runtime.elastic``'s device-count arithmetic.

``best_mesh_shape`` picks the (data, model) grid the reference picks for
a device count; ``surviving_devices_after`` drops the devices of failed
hosts.  Training runs on one card: :func:`make_elastic_mesh` returns the
(1, 1) grid of one device, and a larger grid raises, since the port has
no sharding rules yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}


def local_devices(device=None) -> List[torch.device]:
    """The local CUDA devices (``device`` alone when it is not CUDA)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_elastic_mesh(n_devices: int = 1, device=None) -> Mesh:
    """The (1, 1) grid of ``device`` (default ``cuda``, the current
    card).  A device count whose best grid is larger raises: sharding is
    not ported."""
    data, model = best_mesh_shape(n_devices)
    if data * model > 1:
        raise NotImplementedError(
            f"a ({data}, {model}) mesh needs sharding, which repro_torch "
            f"does not port yet; train on one device")
    return Mesh(devices=((resolve_device(device),),))


def surviving_devices_after(failed_host_ids, devices=None):
    """The devices whose host is not in ``failed_host_ids``: local
    devices belong to this process's host, rank 0 unless
    ``torch.distributed`` says otherwise."""
    devices = devices if devices is not None else local_devices()
    host = 0
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        host = torch.distributed.get_rank()
    return [] if host in set(failed_host_ids) else list(devices)
