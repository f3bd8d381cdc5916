"""Chunked causal GQA prefill attention: the CUDA kernel and its plain
PyTorch version.

The port of the prefill half of ``repro.kernels.flash_attention``
(``flash_decode`` and ``flash_prefill_diff`` are not ported yet).
``flash_prefill(q, k, v, fmt, ...)`` attends q (B, Sq, H, G, dh) causally
-- key position <= ``q_offset`` + query index, optionally inside a sliding
``window`` and with a bidirectional ``prefix_len`` -- over K/V
(B, Skv, H, dh), packed (e, m) containers when ``fmt`` is set or floats.
On a CUDA tensor it launches ``csrc/flash_prefill.cu``; on a CPU tensor
it runs ``flash_prefill_plain`` (the reference's ``_prefill_xla_reference``
order: one masked softmax in f32 over decoded K/V).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import FpFormat, get_format

from . import _build
from .codec import decode_tile

NEG_INF = -1e30  # finite sentinel: keeps exp(m_prev - m_new) well-defined

LIB = _build.register(_build.KernelLib("flash_prefill", {
    "flash_prefill_launch": [_build.P] * 4 + [_build.I32] * 6 + [
        _build.F32] + [_build.I32] * 6 + [_build.P],
}))


def payload_to_f32(x: torch.Tensor, fmt: Optional[FpFormat]) -> torch.Tensor:
    """Packed tile -> exact f32 (identity cast for floats)."""
    if fmt is None:
        return x.to(torch.float32)
    return decode_tile(x, fmt)


def prefill_mask(Sq: int, Skv: int, q_offset: int, window: Optional[int],
                 prefix_len: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: causal, sliding-window and bidirectional prefix."""
    qi = q_offset + torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Skv, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    if prefix_len:
        m = m | (ki < prefix_len)
    return m


def flash_prefill_plain(q, k, v, fmt=None, *, scale: Optional[float] = None,
                        window: Optional[int] = None, prefix_len: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """The plain version: decode K/V, one masked f32 softmax."""
    fmt = get_format(fmt) if fmt is not None else None
    dh = q.shape[-1]
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    kf = payload_to_f32(k, fmt)
    vf = payload_to_f32(v, fmt)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), kf) \
        * np.float32(scale)
    m = prefill_mask(q.shape[1], k.shape[1], q_offset, window, prefix_len,
                     q.device)
    s = torch.where(m[None, None, None], s,
                    torch.tensor(NEG_INF, dtype=torch.float32,
                                 device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, vf)


def _prefill_cuda(q, k, v, fmt, scale, window, prefix_len, q_offset):
    B, Sq, H, G, dh = q.shape
    Skv = k.shape[1]
    _build.check_operands("flash_prefill", q.device, q=q, k=k, v=v)
    want = torch.float32 if fmt is None else fmt.container_dtype
    if q.dtype != torch.float32 or k.dtype != want or v.dtype != want:
        raise ValueError(f"flash_prefill: q must be float32 and K/V {want}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in (64, 128) or 64 % G:
        raise ValueError(f"flash_prefill: the CUDA kernel takes head_dim 64 "
                         f"or 128 and a group size dividing 64, got dh={dh}, "
                         f"G={G}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_prefill: window must be positive, got "
                         f"{window}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0:
        return out
    efmt = fmt if fmt is not None else get_format("binary32")
    p = _build.ptr
    LIB.launch("flash_prefill_launch", p(q), p(k), p(v), p(out), B, Sq, Skv,
               H, G, dh, float(scale), window or 0, prefix_len, q_offset,
               _build.fmt_code(fmt), efmt.e, efmt.m,
               _build.stream_ptr(q.device))
    return out


def flash_prefill(q, k_payload, v_payload, fmt=None, *,
                  scale: Optional[float] = None,
                  window: Optional[int] = None, prefix_len: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """Chunked causal GQA prefill with online softmax.

    q: (B, Sq, H, G, dh) float; k_payload / v_payload: (B, Skv, H, dh)
    packed containers (``fmt`` set) or floats.  Returns (B, Sq, H, G, dh)
    float32."""
    fmt = get_format(fmt) if fmt is not None else None
    B, Sq, H, G, dh = q.shape
    Skv = k_payload.shape[1]
    assert k_payload.shape == v_payload.shape == (B, Skv, H, dh), (
        q.shape, k_payload.shape, v_payload.shape)
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_payload, v_payload, fmt, scale=scale,
                                   window=window, prefix_len=prefix_len,
                                   q_offset=q_offset)
    return _prefill_cuda(q, k_payload, v_payload, fmt, scale, window,
                         prefix_len, q_offset)


def prefill_hbm_bytes(B: int, Sq: int, Skv: int, H: int, G: int, dh: int,
                      fmt) -> int:
    """Bytes one prefill call must move: q in and out (f32), K and V read
    once at container width."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    return 2 * B * Sq * H * G * dh * 4 + 2 * B * Skv * H * dh * item
