"""binary8 (e5m2) gradient compression with error feedback: the port of
``repro.optim.grad_compress``.

:func:`compress` rounds ``g + residual`` to the format (round to
nearest even, or stochastic rounding with explicit random bits
``rbits``, the reference's ``key``) and packs it into the format's
container; the new residual is what the rounding lost, so the
time-averaged transmitted signal tracks the true gradient.
:func:`decompress` unpacks.  On a CUDA tensor the round and the pack are
the ``flexfloat_cast`` kernels (stochastic rounding is the cast kernel
reading the bits); on a CPU tensor their plain versions.

The reductions run over a named dim of the ambient mesh
(``core/ambient_mesh.use_mesh``; a tuple of names, as the reference's
``axis_name`` may be, is reduced over each dim in turn):

* :func:`compressed_psum`: decode, then an ``all_reduce`` sum of the f32
  values (the reference's ``psum``; the wire carries f32);
* :func:`compressed_allgather_sum`: an ``all_gather`` of the packed uint8
  payloads (4x fewer wire bytes than f32), then decode and sum in rank
  order;
* :func:`tree_compress_psum`: :func:`compressed_psum` over a gradient
  tree.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ambient_mesh import get_ambient_mesh
from repro_torch.core.collectives import all_gather_cat, all_reduce_sum
from repro_torch.core.flexfloat import quantize
from repro_torch.core.formats import BINARY8, FpFormat
from repro_torch.core.qtensor import decode, encode
from repro_torch.core.tree import leaves, unflatten


@torch.no_grad()
def compress(g, residual, fmt: FpFormat = BINARY8,
             rbits: Optional[torch.Tensor] = None):
    """Returns ``(packed_payload, new_residual)``; ``residual`` None
    starts the error feedback at zero.  Rounds to nearest even, or with
    ``rbits`` (u32 random words, one an element: the reference draws
    them from its ``key``) stochastically in the normal range."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    q = quantize(gf, fmt, rbits=rbits)
    return encode(q, fmt, assume_quantized=True), gf - q


@torch.no_grad()
def decompress(payload, fmt: FpFormat = BINARY8) -> torch.Tensor:
    return decode(payload, fmt)


def _mesh():
    mesh = get_ambient_mesh()
    if mesh is None:
        raise RuntimeError("a compressed reduction runs over a named dim "
                           "of the ambient mesh: call it inside "
                           "launch.mesh.use_mesh(mesh)")
    return mesh


@torch.no_grad()
def compressed_psum(g, residual, axis_name, fmt: FpFormat = BINARY8,
                    rbits: Optional[torch.Tensor] = None):
    """Quantize -> decode -> sum over ``axis_name``; returns ``(summed,
    new_residual)``."""
    payload, new_res = compress(g, residual, fmt, rbits)
    return all_reduce_sum(decompress(payload, fmt), _mesh(),
                          axis_name), new_res


@torch.no_grad()
def compressed_allgather_sum(g, residual, axis_name,
                             fmt: FpFormat = BINARY8,
                             rbits: Optional[torch.Tensor] = None):
    """All-gather the packed payloads (W, ...) over ``axis_name``, decode
    them and add the W rows in rank order; returns ``(summed,
    new_residual)``."""
    payload, new_res = compress(g, residual, fmt, rbits)
    rows = decompress(all_gather_cat(payload[None], _mesh(), axis_name),
                      fmt)
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total, new_res


@torch.no_grad()
def tree_compress_psum(grads, residuals, axis_name,
                       fmt: FpFormat = BINARY8):
    """Error-feedback compressed reduction over a whole gradient tree;
    returns ``(summed tree, residual tree)``."""
    flat_g = leaves(grads)
    flat_r = leaves(residuals) if residuals is not None \
        else [None] * len(flat_g)
    out = [compressed_psum(g, r, axis_name, fmt)
           for g, r in zip(flat_g, flat_r)]
    return (unflatten(grads, [s for s, _ in out]),
            unflatten(grads, [r for _, r in out]))
