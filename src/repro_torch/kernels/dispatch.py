"""Backend registries: one dispatch point for attention decode, attention
prefill and the model's matmuls.

The port keeps the reference's spellings (``repro.kernels.dispatch``) so
both serving CLIs take the same flags.  What each spelling maps to here:

decode (``decode_impl``)::

    "xla"           the plain dequantize path: the cache is widened with
                    torch casts, then dot / masked softmax / dot
                    (``models/attention.py:_decode_xla``).
    "paged"         the block-table decode over the page pool:
                    ``kernels/paged_attention.paged_decode``, the CUDA
                    kernel ``csrc/paged_decode.cu`` on a CUDA tensor, its
                    plain version on a CPU tensor.
    "flash_pallas"  ``kernels/flash_attention.flash_decode`` over a
                    contiguous cache: the CUDA kernel
                    ``csrc/flash_decode.cu`` on a CUDA tensor, its plain
                    version on a CPU tensor.  A paged cache reaches it
                    through the gather bridge in ``models/attention.py``
                    (every slot's pages gathered contiguous, positions at
                    or past ``seq_lens`` masked).  The serving default on
                    a card, as the reference's on its accelerator.

prefill::

    "xla"           plain masked softmax (``_prefill_xla``).
    "flash_pallas"  ``kernels/flash_attention.flash_prefill``: the CUDA
    "paged"         kernel ``csrc/flash_prefill.cu`` (both spellings reach
                    it, as ``_prefill_paged`` delegates in the reference).

matmul (``matmul_impl``)::

    "xla"           torch matmul; packed weights are dequantized first.
    "qmm_pallas"    ``kernels/qmatmul.qmatmul`` / ``qmm_ffn``: the CUDA
                    kernel ``csrc/qmm.cu`` streaming packed weights.

The wrapper spellings ``flash_shmap`` and ``ring`` (sequence- or
pool-sharded decode over a device mesh) are not ported yet and are
rejected with that reason.

Contracts are the reference's (see ``repro.kernels.dispatch``); the
backends register themselves from ``models/attention.py`` and
``models/layers.py`` at import.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

BASE_IMPLS = ("xla", "flash_pallas", "paged")
WRAPPER_IMPLS = ("flash_shmap", "ring")      # reference-only for now
MATMUL_IMPLS = ("xla", "qmm_pallas")

_DECODE: dict = {}
_PREFILL: dict = {}
_MATMUL: dict = {}


def legal_impls() -> tuple:
    """Every ``decode_impl`` spelling the port accepts."""
    return BASE_IMPLS


def canonicalize_impl(spec: str) -> tuple:
    return tuple(p.strip() for p in str(spec).split("+"))


def validate_impl(spec: Optional[str], *, allow_none: bool = True,
                  what: str = "decode_impl") -> Optional[str]:
    if spec is None:
        if allow_none:
            return None
        raise ValueError(f"{what} must be set; legal values: {legal_impls()}")
    parts = canonicalize_impl(spec)
    if parts[0] in WRAPPER_IMPLS:
        raise ValueError(
            f"{what} {spec!r}: the mesh wrappers {WRAPPER_IMPLS} are not "
            f"ported to repro_torch yet; legal spellings are "
            f"{list(legal_impls())}")
    if parts not in {(b,) for b in BASE_IMPLS}:
        raise ValueError(f"unknown {what} {spec!r}; legal spellings are "
                         f"{list(legal_impls())}")
    return spec


def default_serving_impl(device=None) -> Optional[str]:
    """Serving default when no ``--decode-impl`` is given:
    ``flash_pallas`` (the fused packed-KV flash decode kernel) on a card,
    as the reference returns it on its accelerator; ``None`` (the model
    config's default) on the CPU, where the plain path is the honest
    baseline."""
    if device is not None and torch.device(device).type == "cuda":
        return "flash_pallas"
    return None


def legal_matmul_impls() -> tuple:
    return MATMUL_IMPLS


def validate_matmul_impl(spec: Optional[str], *, allow_none: bool = True,
                         what: str = "matmul_impl") -> Optional[str]:
    if spec is None:
        if allow_none:
            return None
        raise ValueError(
            f"{what} must be set; legal values: {legal_matmul_impls()}")
    if spec not in MATMUL_IMPLS:
        raise ValueError(f"unknown {what} {spec!r}; legal spellings are "
                         f"{list(legal_matmul_impls())}")
    return spec


def register_matmul(name: str) -> Callable:
    assert name in MATMUL_IMPLS, name

    def deco(backend):
        _MATMUL[name] = backend
        return backend
    return deco


def resolve_matmul(spec: Optional[str]):
    return _MATMUL[validate_matmul_impl(spec, allow_none=False)]


def register_decode(name: str) -> Callable:
    assert name in BASE_IMPLS, name

    def deco(fn):
        _DECODE[name] = fn
        return fn
    return deco


def register_prefill(name: str) -> Callable:
    assert name in BASE_IMPLS, name

    def deco(fn):
        _PREFILL[name] = fn
        return fn
    return deco


def resolve_decode(spec: str) -> Callable:
    return _DECODE[validate_impl(spec, allow_none=False)]


def resolve_prefill(spec: str) -> Callable:
    return _PREFILL[validate_impl(spec, allow_none=False)]
