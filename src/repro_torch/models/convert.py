"""Carry weights across from the JAX package, as numpy.

``params_from_numpy(tree)`` turns a param tree of nested dicts/lists of
numpy arrays into the port's params.  A packed leaf arrives as
``(payload ndarray, format name)`` and becomes a
:class:`~repro_torch.core.qtensor.QTensor` whose payload bits are the
same bits.  Narrow float arrays (ml_dtypes ``bfloat16`` /
``float8_e5m2``) are reinterpreted through their integer container, so
their bits go across unchanged too.  No JAX is imported here: the caller
does the JAX -> numpy side (``np.asarray`` on every leaf).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QTensor

# numpy dtype name -> (integer view, torch dtype) for the ml_dtypes floats
_NARROW = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _NARROW:
        view, dt = _NARROW[a.dtype.name]
        t = torch.from_numpy(np.array(a).view(view)).view(dt)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device) if device is not None else t


def params_from_numpy(tree, device=None):
    """Nested dicts/lists of numpy arrays (packed leaves as
    ``(payload, format name)``) -> the port's param tree on ``device``
    (default ``cuda``; raises when no card is present unless
    ``device="cpu"``)."""
    return _convert(tree, resolve_device(device))


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1],
                                                                 str):
        payload, name = tree
        return QTensor(tensor_from_numpy(payload, device), get_format(name))
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return tensor_from_numpy(tree, device)
