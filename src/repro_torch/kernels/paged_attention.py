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

The kernel walks each row in fixed pieces of whole pages
(``piece_pages``: about ``PIECE_POSITIONS`` positions, fixed by the page
size alone) and merges the pieces' partials in piece order;
``paged_decode_split_plain`` is that walk in PyTorch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import get_format

from . import _build
from ._route import route
from .flash_attention import (F64, NEG_INF, check_kernel_shape, decode_shape,
                              payload_to_f32)
from .paged_cache import gather_pages

LIB = _build.register(_build.KernelLib("paged_decode", {
    "paged_decode_launch": [_build.P] * 10 + [_build.I32] * 6 + [
        _build.F32] + [_build.I32] * 3 + [_build.P],
}))
# positions a piece of the kernel's walk covers, in whole pages
# (kPiecePositions in csrc/paged_decode.cu)
PIECE_POSITIONS = 64
# shared memory a block may use on an H100 (bytes)
SMEM_LIMIT = 232448


def piece_pages(page: int) -> int:
    """Pages a piece of the kernel's walk: max(1, 64 // page), a
    function of the page size alone."""
    return max(1, PIECE_POSITIONS // page)


def paged_pieces(lengths, page: int, n_pages: int):
    """Pieces of the kernel's walk per row: ceil(min(len, n_pages *
    page) / piece), a function of the row's own length (and the page
    size) only."""
    cap = n_pages * page
    live = torch.clamp(torch.as_tensor(lengths).to(torch.int64), 0, cap)
    plen = piece_pages(page) * page
    return -(-live // plen)


def piece_smem_bytes(page: int, dh: int, item: int, G: int) -> int:
    """Shared memory of one block of the kernel (``smem_bytes`` in
    csrc/decode_piece.cuh): the piece's K and V rows padded to 16 bytes,
    q, the scores and the row slices of P @ V, at the group tile."""
    gt = 4 if G <= 4 else 8 if G <= 8 else 16
    plen = piece_pages(page) * page
    rs = -(-dh * item // 16) * 16
    nsplit = 128 // min(dh, 128)
    return 2 * plen * rs + 4 * (gt * (rs // item) + gt * plen + 2 * gt
                                + (nsplit - 1) * gt * dh)


def paged_decode_split_plain(q, k_pool, v_pool, fmt, lengths, block_tables,
                             *, scale: Optional[float] = None,
                             return_residuals: bool = False):
    """The CUDA kernel's walk in PyTorch, for tests and ``chip_smoke.py``
    (the serving path does not call it): each row's first
    min(len, n_pages * page) positions in pieces of ``piece_pages(page)``
    pages, a normalized partial (o, m, l) per piece (an unmapped page's
    positions masked; no valid position gives o = 0, m = NEG_INF,
    l = 0), merged in piece order by the reference's ``_merge_partials``
    formula, w_i = exp(m_i - max m) * l_i, out = sum w_i o_i / sum w_i.
    Row by row and piece by piece, so a row's bits depend on its own
    length, table row and data only.  The residuals are the unsplit
    (m, l).  As ``flash_decode_split_plain``, the walk runs in f64 and is
    rounded to f32 once at the end."""
    fmt = get_format(fmt) if fmt is not None else None
    B, H, G, dh = q.shape
    page, n_pages = k_pool.shape[1], block_tables.shape[1]
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    plen = piece_pages(page) * page
    dev = q.device
    zero = torch.zeros((), dtype=F64, device=dev)
    neg = torch.tensor(NEG_INF, dtype=F64, device=dev)
    out = torch.zeros((B, H, G, dh), dtype=torch.float32, device=dev)
    m_out = torch.full((B, H, G), NEG_INF, dtype=torch.float32, device=dev)
    l_out = torch.zeros((B, H, G), dtype=torch.float32, device=dev)
    live = torch.clamp(lengths.to(torch.int64), 0, n_pages * page).tolist()
    for b in range(B):
        kb = payload_to_f32(gather_pages(k_pool, block_tables[b:b + 1])[0],
                            fmt).to(F64)
        vb = payload_to_f32(gather_pages(v_pool, block_tables[b:b + 1])[0],
                            fmt).to(F64)
        mapped_b = torch.repeat_interleave(block_tables[b] >= 0, page)
        parts = []
        for base in range(0, live[b], plen):
            sl = slice(base, min(base + plen, live[b]))
            k, v, mapped = kb[sl], vb[sl], mapped_b[sl]
            s = torch.einsum("hgd,shd->hgs", q[b].to(F64), k) \
                * float(np.float32(scale))
            s = torch.where(mapped, s, neg)
            m = torch.amax(s, dim=-1)
            p = torch.where(mapped, torch.exp(s - m[..., None]), zero)
            l = torch.sum(p, dim=-1)
            o = torch.einsum("hgs,shd->hgd", p, v)
            o = torch.where(l[..., None] > 0,
                            o / torch.where(l > 0, l, 1.0)[..., None], zero)
            parts.append((o, m, l))
        if not parts:
            continue
        gm = parts[0][1]
        for _, m, _ in parts[1:]:
            gm = torch.maximum(gm, m)
        num = torch.zeros((H, G, dh), dtype=F64, device=dev)
        den = torch.zeros((H, G), dtype=F64, device=dev)
        for o, m, l in parts:                                 # piece order
            w = torch.exp(m - gm) * l
            num = num + w[..., None] * o
            den = den + w
        out[b] = torch.where(den[..., None] > 0,
                             num / torch.where(den > 0, den, 1.0)[..., None],
                             zero)
        m_out[b], l_out[b] = gm, den
    if return_residuals:
        return out, m_out, l_out
    return out


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
    check_kernel_shape("paged_decode", G, dh)
    smem = piece_smem_bytes(page, dh, k_pool.element_size(), G)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_decode: a piece of page {page} at "
                         f"head_dim {dh} in {k_pool.dtype} needs {smem} "
                         f"bytes of shared memory, over the {SMEM_LIMIT} a "
                         f"block may use; take a smaller page")
    out = torch.empty((B, H, G, dh), dtype=torch.float32, device=q.device)
    m = l = None
    if return_residuals:
        m = torch.empty((B, H, G), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, G), dtype=torch.float32, device=q.device)
    if B and H:
        P = max(-(-n_pages // piece_pages(page)), 1)
        part_o = torch.empty((B, H, P, G, dh), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, P, 2, G), dtype=torch.float32,
                              device=q.device)
        efmt = fmt if fmt is not None else get_format("binary32")
        p = _build.ptr
        LIB.launch("paged_decode_launch", p(q), p(k_pool), p(v_pool),
                   p(lengths), p(tables), p(out), p(m), p(l), p(part_o),
                   p(part_ml), B, H, G, dh, page, n_pages, float(scale),
                   _build.fmt_code(fmt), efmt.e, efmt.m,
                   _build.stream_ptr(q.device))
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
    where = route(q)
    if where == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, fmt, lengths, tables,
                                  scale=scale,
                                  return_residuals=return_residuals)
    if where == "meta":
        # no lengths on meta: every row's whole table counts as live
        S = n_pages * page
        return decode_shape("paged_decode", q, S, fmt, return_residuals,
                            paged_hbm_bytes([S] * B, H, dh, fmt,
                                            page_size=page, g=G),
                            k=k_pool, v=v_pool)
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


def paged_ring_ppermute_bytes(num_pages: int, page_size: int, n_kv: int,
                              head_dim: int, fmt, *, n_devices: int) -> int:
    """Bytes ONE rank sends per decode step under ``ring+paged``: its
    (num_pages / n_devices)-page K and V pool shards, passed whole on
    each of the n_devices - 1 rotations (the block table stays and is
    rewritten locally, so only payload bytes move)."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    shard = (num_pages // n_devices) * page_size * n_kv * head_dim * item
    return 2 * shard * (n_devices - 1)
