"""The parallel prefix scan of the recurrent layers: a copy of
``jax.lax.associative_scan``'s odd/even recursion in PyTorch.

rwkv6's cross-chunk state and the RG-LRU's diagonal recurrence combine
with ``(a1, s1) . (a2, s2) = (a1 a2, a2 s1 + s2)``.  The combine is
associative in exact arithmetic, not in floating point: a sequential
scan sums in another order than the reference's recursion and moves the
last bits, and under transprecision the state is then rounded to binary8
(e5m2), where a last-bit change can move an element by a whole step.
So the port combines the elements in the reference's order: pairs
first, the scan of the pairs by recursion, then the even elements from
the odd ones (JAX's ``_scan``).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def _sl(x: torch.Tensor, dim: int, start: int, stop: int,
        step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... of
    ``dim`` (``even`` is as long as ``odd`` or one longer)."""
    n_odd = odd.shape[dim]
    both = torch.stack([_sl(even, dim, 0, n_odd), odd], dim=dim + 1)
    out = both.flatten(dim, dim + 1)
    if even.shape[dim] > n_odd:
        out = torch.cat([out, _sl(even, dim, n_odd, n_odd + 1)], dim=dim)
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     dim: int) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``fn(lhs_tuple, rhs_tuple) -> tuple``, combining in
    ``jax.lax.associative_scan``'s order."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(_sl(e, dim, 0, n - 1, 2) for e in elems),
                 tuple(_sl(e, dim, 1, n, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    tail = tuple(_sl(e, dim, 2, n, 2) for e in elems)
    if n % 2 == 0:
        even = fn(tuple(_sl(o, dim, 0, o.shape[dim] - 1) for o in odd),
                  tail)
    else:
        even = fn(odd, tail)
    even = tuple(torch.cat([_sl(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def linear_combine(lhs, rhs):
    """The first-order linear recurrence's combine, ``h -> a h + b``
    composed: ``(a1 a2, a2 b1 + b2)``; ``b`` may carry trailing axes
    past ``a``'s (rwkv's (dk, dv) state over a per-dk decay).  ``a2 b1 +
    b2`` is one fused multiply-add (one rounding), as XLA's fusion of the
    reference's combine computes it."""
    a1, b1 = lhs
    a2, b2 = rhs
    extra = b1.dim() - a1.dim()
    return a1 * a2, torch.addcmul(b2, a2.reshape(*a2.shape,
                                                 *([1] * extra)), b1)
