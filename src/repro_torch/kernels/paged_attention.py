"""One-token GQA attention over a paged, packed KV pool: the CUDA kernel and
its plain PyTorch version.

The port of ``repro.kernels.paged_attention``.  ``paged_decode`` attends
q (B, H, G, dh) over the page pools (num_pages, page, H, dh) through block
tables (B, pages_per_seq) with per-sequence lengths; unmapped entries
(-1) and positions at or past the length are masked; lengths are clamped
to ``pages_per_seq * page``.  On a CUDA tensor it launches
``csrc/paged_decode.cu``; on a CPU tensor it runs
``paged_decode_plain`` (the reference's ``paged_decode_reference`` order:
gather, decode, one masked f32 softmax).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import get_format

from . import _build
from .flash_attention import NEG_INF, payload_to_f32
from .paged_cache import gather_pages

LIB = _build.register(_build.KernelLib("paged_decode", {
    "paged_decode_launch": [_build.P] * 8 + [_build.I32] * 6 + [
        _build.F32] + [_build.I32] * 3 + [_build.P],
}))


def paged_decode_plain(q, k_pool, v_pool, fmt, lengths, block_tables, *,
                       scale: Optional[float] = None,
                       return_residuals: bool = False):
    """The plain version: gather the pool contiguous through the block
    table, decode, masked softmax in f32 (length AND mapped-page mask)."""
    fmt = get_format(fmt) if fmt is not None else None
    B, H, G, dh = q.shape
    page = k_pool.shape[1]
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    k = payload_to_f32(gather_pages(k_pool, block_tables), fmt)
    v = payload_to_f32(gather_pages(v_pool, block_tables), fmt)
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k) \
        * np.float32(scale)
    S = s.shape[-1]
    pos = torch.arange(S, device=q.device)[None, :]
    mapped = torch.repeat_interleave(block_tables >= 0, page, dim=1)
    valid = (pos < lengths.to(torch.int64)[:, None]) & mapped
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.tensor(NEG_INF, dtype=torch.float32,
                                           device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(vmask, p, torch.zeros((), device=q.device))
    num = torch.einsum("bhgs,bshd->bhgd", p, v)
    den = torch.sum(p, dim=-1, keepdim=True)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                      torch.zeros((), device=q.device))
    if return_residuals:
        return out, m[..., 0], den[..., 0]
    return out


def _paged_cuda(q, k_pool, v_pool, fmt, lengths, tables, scale,
                return_residuals):
    B, H, G, dh = q.shape
    page, n_pages = k_pool.shape[1], tables.shape[1]
    _build.check_operands("paged_decode", q.device, q=q, k_pool=k_pool,
                          v_pool=v_pool, lengths=lengths, tables=tables)
    want = torch.float32 if fmt is None else fmt.container_dtype
    if q.dtype != torch.float32 or k_pool.dtype != want \
            or v_pool.dtype != want:
        raise ValueError(f"paged_decode: q must be float32 and the pools "
                         f"{want}, got {q.dtype}, {k_pool.dtype}")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32:
        raise ValueError("paged_decode: lengths and block tables must be "
                         "int32")
    if G not in (1, 2, 4, 8) or dh > 128:
        raise ValueError(f"paged_decode: the CUDA kernel takes G in "
                         f"(1, 2, 4, 8) and head_dim <= 128, got G={G}, "
                         f"dh={dh}")
    out = torch.empty((B, H, G, dh), dtype=torch.float32, device=q.device)
    m = l = None
    if return_residuals:
        m = torch.empty((B, H, G), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, G), dtype=torch.float32, device=q.device)
    if B and H:
        efmt = fmt if fmt is not None else get_format("binary32")
        p = _build.ptr
        LIB.launch("paged_decode_launch", p(q), p(k_pool), p(v_pool),
                   p(lengths), p(tables), p(out), p(m), p(l), B, H, G, dh,
                   page, n_pages, float(scale), _build.fmt_code(fmt), efmt.e,
                   efmt.m, _build.stream_ptr(q.device))
    return (out, m, l) if return_residuals else out


def paged_decode(q, k_pool, v_pool, fmt, lengths, block_tables, *,
                 scale: Optional[float] = None,
                 return_residuals: bool = False):
    """Single-token GQA attention over a paged packed KV pool.

    q: (B, H, G, dh) float; k_pool / v_pool: (num_pages, page, H, dh)
    packed containers (``fmt`` set) or floats; lengths: (B,) int32;
    block_tables: (B, pages_per_seq) int32, -1 = unmapped.  Returns
    (B, H, G, dh) float32, plus the flash partials (m, l) of shape
    (B, H, G) with ``return_residuals``."""
    fmt = get_format(fmt) if fmt is not None else None
    B, H, G, dh = q.shape
    num_pages, page = k_pool.shape[0], k_pool.shape[1]
    assert k_pool.shape == v_pool.shape == (num_pages, page, H, dh), (
        q.shape, k_pool.shape, v_pool.shape)
    n_pages = block_tables.shape[1]
    assert block_tables.shape == (B, n_pages), block_tables.shape
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    lengths = torch.clamp(lengths.to(torch.int32), max=n_pages * page)
    tables = block_tables.to(torch.int32)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, fmt, lengths, tables,
                                  scale=scale,
                                  return_residuals=return_residuals)
    return _paged_cuda(q, k_pool, v_pool, fmt, lengths.contiguous(),
                       tables.contiguous(), scale, return_residuals)


def paged_hbm_bytes(lengths, n_kv: int, head_dim: int, fmt, *,
                    page_size: int, g: int = 1) -> int:
    """Bytes one paged decode call must move: the live tokens of K and V
    (container width; the kernel reads only ``min(page, len - base)`` rows
    of a sequence's last page), the block-table entries of live pages, the
    lengths, q in and out."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    lengths = np.asarray(lengths, np.int64)
    pages = int((-(-lengths // page_size)).sum())
    kv = 2 * int(lengths.sum()) * n_kv * head_dim * item
    return (kv + pages * 4 + len(lengths) * 4
            + 2 * len(lengths) * n_kv * g * head_dim * 4)
