"""Fused GQA attention over packed K/V: one-token decode and chunked
causal prefill, the CUDA kernels and their plain PyTorch versions.

The port of ``repro.kernels.flash_attention``, with
``flash_prefill_diff``, the differentiable prefill of training: the
kernel's forward and a backward that recomputes the plain version.

``flash_decode(q, k, v, fmt, lengths)`` attends one query token per
sequence, q (B, H, G, dh), over a contiguous cache K/V (B, S, H, dh) --
packed (e, m) containers when ``fmt`` is set, else floats -- masking
positions at or past ``lengths`` (clamped to S).  On a CUDA tensor it
launches ``csrc/flash_decode.cu``; on a CPU tensor it runs
``flash_decode_plain`` (the reference's ``flash_decode_reference`` order:
decode, one masked f32 softmax).

``flash_prefill(q, k, v, fmt, ...)`` attends q (B, Sq, H, G, dh) causally
-- key position <= ``q_offset`` + query index, optionally inside a sliding
``window`` and with a bidirectional ``prefix_len`` -- over K/V
(B, Skv, H, dh).  On a CUDA tensor it launches ``csrc/flash_prefill.cu``;
on a CPU tensor it runs ``flash_prefill_plain`` (the reference's
``_prefill_xla_reference`` order: one masked softmax in f32 over decoded
K/V).

The two kernels are separate libraries with launch counts of their own.
Both, and ``paged_attention.paged_decode``, take every head_dim that is a
multiple of 8 up to ``MAX_HEAD_DIM`` and every group size G from 1 to
``MAX_GROUP`` (prefill: any G), in every KV format (``check_kernel_shape``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import FpFormat, get_format

from . import _build
from ._route import meta_empty, route, shape_route
from .codec import decode_tile

NEG_INF = -1e30  # finite sentinel: keeps exp(m_prev - m_new) well-defined
F64 = torch.float64  # the precision of the split twins' walk
# KV positions one block of the decode kernel walks (kPiece in
# csrc/flash_decode.cu)
DECODE_PIECE = 64
# the shapes the CUDA attention kernels take (csrc/decode_piece.cuh,
# csrc/flash_prefill.cu): query heads per KV head up to MAX_GROUP for the
# decode kernels (any for prefill, whose rows are flattened over G), and
# head_dim in steps of HEAD_DIM_STEP up to MAX_HEAD_DIM
MAX_GROUP = 16
MAX_HEAD_DIM = 256
HEAD_DIM_STEP = 8


def check_kernel_shape(kernel: str, G: int, dh: int, *,
                       max_group: Optional[int] = MAX_GROUP) -> None:
    """Raise ``ValueError`` naming what the CUDA attention kernels take
    unless 1 <= G <= ``max_group`` (None: no upper limit) and ``dh`` is a
    multiple of ``HEAD_DIM_STEP`` from 8 to ``MAX_HEAD_DIM``."""
    g_ok = G >= 1 and (max_group is None or G <= max_group)
    if not (g_ok and HEAD_DIM_STEP <= dh <= MAX_HEAD_DIM
            and dh % HEAD_DIM_STEP == 0):
        groups = "from 1" if max_group is None else f"from 1 to {max_group}"
        raise ValueError(
            f"{kernel}: the CUDA kernel takes a group size G {groups} and "
            f"a head_dim that is a multiple of {HEAD_DIM_STEP} from "
            f"{HEAD_DIM_STEP} to {MAX_HEAD_DIM}, got G={G}, head_dim={dh}")

DECODE_LIB = _build.register(_build.KernelLib("flash_decode", {
    "flash_decode_launch": [_build.P] * 9 + [_build.I32] * 5 + [
        _build.F32] + [_build.I32] * 3 + [_build.P],
}))
LIB = _build.register(_build.KernelLib("flash_prefill", {
    "flash_prefill_launch": [_build.P] * 4 + [_build.I32] * 6 + [
        _build.F32] + [_build.I32] * 6 + [_build.P],
}))


def payload_to_f32(x: torch.Tensor, fmt: Optional[FpFormat]) -> torch.Tensor:
    """Packed tile -> exact f32 (identity cast for floats)."""
    if fmt is None:
        return x.to(torch.float32)
    return decode_tile(x, fmt)


def flash_decode_plain(q, k_payload, v_payload, fmt, lengths, *,
                       scale: Optional[float] = None,
                       return_residuals: bool = False):
    """The plain version: decode K/V, masked f32 softmax (max -> exp ->
    PV / sum), in ``flash_decode_reference``'s order."""
    fmt = get_format(fmt) if fmt is not None else None
    dh = q.shape[-1]
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    k = payload_to_f32(k_payload, fmt)
    v = payload_to_f32(v_payload, fmt)
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k) \
        * np.float32(scale)
    valid = (torch.arange(s.shape[-1], device=q.device)[None, :]
             < lengths.to(torch.int64)[:, None])
    vmask = valid[:, None, None, :]
    zero = torch.zeros((), device=q.device)
    s = torch.where(vmask, s, torch.tensor(NEG_INF, dtype=torch.float32,
                                           device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), zero)
    num = torch.einsum("bhgs,bshd->bhgd", p, v)
    den = torch.sum(p, dim=-1, keepdim=True)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), zero)
    if return_residuals:
        return out, m[..., 0], den[..., 0]
    return out


def decode_pieces(lengths, S: int, piece: int = DECODE_PIECE):
    """Pieces of the decode kernel's walk per row: ceil(min(len, S) /
    piece), a function of the row's own length."""
    live = torch.clamp(torch.as_tensor(lengths).to(torch.int64), 0, S)
    return -(-live // piece)


def flash_decode_split_plain(q, k_payload, v_payload, fmt, lengths, *,
                             scale: Optional[float] = None,
                             piece: int = DECODE_PIECE,
                             return_residuals: bool = False):
    """The CUDA kernel's walk in PyTorch, for tests and ``chip_smoke.py``
    (the serving path does not call it): each row's first min(len, S)
    positions in pieces of ``piece``, a normalized partial (o, m, l) per
    piece, merged in piece order by the reference's ``_merge_partials``
    formula, w_i = exp(m_i - max m) * l_i, out = sum w_i o_i / sum w_i.
    The residuals are the unsplit (m, l).  The walk is computed in f64
    on the decoded f32 operands and rounded to f32 once at the end
    (``F64``), so the twin stands within the kernel's own f32 error of it
    at any head_dim and length, not within the sum of two f32 errors
    (which exceeds 1e-6 at head_dim 256)."""
    fmt = get_format(fmt) if fmt is not None else None
    B, H, G, dh = q.shape
    S = k_payload.shape[1]
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    P = -(-S // piece)
    k = payload_to_f32(k_payload, fmt).to(F64)
    v = payload_to_f32(v_payload, fmt).to(F64)
    pad = P * piece - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhgd,bshd->bhgs", q.to(F64), k) \
        * float(np.float32(scale))
    live = torch.clamp(lengths.to(torch.int64), 0, S)
    valid = torch.arange(P * piece, device=q.device)[None, :] < live[:, None]
    vmask = valid[:, None, None, :].reshape(B, 1, 1, P, piece)
    s = s.reshape(B, H, G, P, piece)
    zero = torch.zeros((), device=q.device)
    s = torch.where(vmask, s, torch.tensor(NEG_INF, dtype=F64,
                                           device=q.device))
    m = torch.amax(s, dim=-1)                                # (B, H, G, P)
    p = torch.where(vmask, torch.exp(s - m[..., None]), zero)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgps,bpshd->bhgpd", p,
                     v.reshape(B, P, piece, H, dh))
    o = torch.where(l[..., None] > 0,
                    o / torch.where(l > 0, l, 1.0)[..., None], zero)
    gm = torch.amax(m, dim=-1, keepdim=True)
    w = torch.exp(m - gm) * l
    num = torch.zeros((B, H, G, dh), dtype=F64, device=q.device)
    den = torch.zeros((B, H, G), dtype=F64, device=q.device)
    for i in range(P):                                       # piece order
        num = num + w[..., i, None] * o[..., i, :]
        den = den + w[..., i]
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], zero)
    if return_residuals:
        return out.float(), gm[..., 0].float(), den.float()
    return out.float()


def _decode_cuda(q, k, v, fmt, lengths, scale, return_residuals):
    B, H, G, dh = q.shape
    S = k.shape[1]
    _build.check_operands("flash_decode", q.device, q=q, k=k, v=v,
                          lengths=lengths)
    want = torch.float32 if fmt is None else fmt.container_dtype
    if q.dtype != torch.float32 or k.dtype != want or v.dtype != want:
        raise ValueError(f"flash_decode: q must be float32 and K/V {want}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError("flash_decode: lengths must be int32")
    check_kernel_shape("flash_decode", G, dh)
    out = torch.empty((B, H, G, dh), dtype=torch.float32, device=q.device)
    m = l = None
    if return_residuals:
        m = torch.empty((B, H, G), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, G), dtype=torch.float32, device=q.device)
    if B and H:
        P = -(-S // DECODE_PIECE)
        part_o = torch.empty((B, H, max(P, 1), G, dh), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, max(P, 1), 2, G), dtype=torch.float32,
                              device=q.device)
        efmt = fmt if fmt is not None else get_format("binary32")
        p = _build.ptr
        DECODE_LIB.launch("flash_decode_launch", p(q), p(k), p(v),
                          p(lengths), p(out), p(m), p(l), p(part_o),
                          p(part_ml), B, S, H, G, dh, float(scale),
                          _build.fmt_code(fmt), efmt.e, efmt.m,
                          _build.stream_ptr(q.device))
    return (out, m, l) if return_residuals else out


def flash_decode(q, k_payload, v_payload, fmt, lengths, *,
                 scale: Optional[float] = None,
                 return_residuals: bool = False):
    """Single-token GQA attention over a contiguous packed KV cache.

    q: (B, H, G, dh) float; k_payload / v_payload: (B, S, H, dh) packed
    containers (``fmt`` set) or floats; lengths: (B,) valid slots per
    sequence, clamped to S.  Returns (B, H, G, dh) float32, plus the flash
    partials (m, l) of shape (B, H, G) with ``return_residuals``; a
    zero-length row gives zeros and (m, l) = (NEG_INF, 0)."""
    fmt = get_format(fmt) if fmt is not None else None
    B, H, G, dh = q.shape
    S = k_payload.shape[1]
    assert k_payload.shape == v_payload.shape == (B, S, H, dh), (
        q.shape, k_payload.shape, v_payload.shape)
    if scale is None:
        scale = float(1.0 / np.sqrt(dh))
    lengths = torch.clamp(lengths.to(torch.int32), max=S)
    where = route(q)
    if where == "cpu":
        return flash_decode_plain(q, k_payload, v_payload, fmt, lengths,
                                  scale=scale,
                                  return_residuals=return_residuals)
    if where == "meta":
        # no lengths on meta: every one of the S slots counts as live
        return decode_shape("flash_decode", q, S, fmt, return_residuals,
                            decode_hbm_bytes([S] * B, S, H, dh, fmt, g=G),
                            k=k_payload, v=v_payload)
    return _decode_cuda(q, k_payload, v_payload, fmt, lengths.contiguous(),
                        scale, return_residuals)


def decode_flops(B: int, H: int, G: int, dh: int, live: int) -> int:
    """Operations of one decode call over ``live`` slots a row: the
    scores and the weighted sum, a multiply and an add each per element
    (the softmax's few per score left out)."""
    return 4 * B * H * G * dh * live


def decode_shape(name, q, S: int, fmt, return_residuals: bool,
                 nbytes: int, **operands):
    """The shape route of a decode kernel: ``meta`` outputs (and
    partials) of ``q``'s shape, ``S`` live slots a row."""
    B, H, G, dh = q.shape
    out = meta_empty(q.shape, torch.float32)
    if return_residuals:
        out = (out, meta_empty((B, H, G), torch.float32),
               meta_empty((B, H, G), torch.float32))
    return shape_route(name, out, flops=decode_flops(B, H, G, dh, S),
                       nbytes=nbytes, q=q, **operands)


def decode_hbm_bytes(lengths, S: int, n_kv: int, head_dim: int, fmt, *,
                     g: int = 1) -> int:
    """Bytes one flash decode call must move: the live tokens of K and V
    (``min(len, S)`` rows per sequence, container width), the lengths,
    q in and out (f32)."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    live = np.minimum(np.asarray(lengths, np.int64), S)
    kv = 2 * int(live.sum()) * n_kv * head_dim * item
    return kv + len(live) * 4 + 2 * len(live) * n_kv * g * head_dim * 4


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


def visible_pairs(Sq: int, Skv: int, q_offset: int,
                  window: Optional[int], prefix_len: int) -> int:
    """(query, key) pairs :func:`prefill_mask` lets through, counted
    row by row without the (Sq, Skv) mask."""
    qi = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qi, Skv - 1)                  # last key seen, causal
    lo = np.zeros_like(qi) if window is None \
        else np.maximum(qi - window + 1, 0)
    n = np.maximum(hi - lo + 1, 0)
    if prefix_len:
        p = min(prefix_len, Skv)
        # keys below the prefix are always seen: add those the causal
        # (and window) range left out
        n = n + p - np.clip(np.minimum(hi, p - 1) - lo + 1, 0, p)
    return int(n.sum())


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
    check_kernel_shape("flash_prefill", G, dh, max_group=None)
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
    where = route(q)
    if where == "cpu":
        return flash_prefill_plain(q, k_payload, v_payload, fmt, scale=scale,
                                   window=window, prefix_len=prefix_len,
                                   q_offset=q_offset)
    if where == "meta":
        pairs = visible_pairs(Sq, Skv, q_offset, window, prefix_len)
        return shape_route(
            "flash_prefill", meta_empty(q.shape, torch.float32),
            flops=4 * B * H * G * dh * pairs,
            nbytes=prefill_hbm_bytes(B, Sq, Skv, H, G, dh, fmt), q=q,
            k=k_payload, v=v_payload)
    return _prefill_cuda(q, k_payload, v_payload, fmt, scale, window,
                         prefix_len, q_offset)


class PrefillDiffFn(torch.autograd.Function):
    """``flash_prefill`` on float K/V with a gradient: the forward is the
    kernel (its plain version on a CPU tensor), the backward recomputes
    :func:`flash_prefill_plain` under autograd and returns its gradients
    of q, k and v -- the reference's recompute backward through
    ``_prefill_xla_reference`` (``repro/kernels/flash_attention.py:
    408-414``).  Nothing but q, k and v is kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, prefix_len, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, window=window, prefix_len=prefix_len,
                        q_offset=q_offset)
        return flash_prefill(q, k, v, None, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_prefill_plain(*qkv, None, **ctx.args)
        return (*torch.autograd.grad(out, qkv, g), None, None, None, None)


def flash_prefill_diff(q, k, v, *, scale: float,
                       window: Optional[int] = None, prefix_len: int = 0,
                       q_offset: int = 0) -> torch.Tensor:
    """Differentiable :func:`flash_prefill` on float32 q (B, Sq, H, G, dh)
    and K/V (B, Skv, H, dh) (:class:`PrefillDiffFn`).  This is what
    ``models/attention.py`` sends training-time causal attention through
    under ``decode_impl="flash_pallas"``."""
    return PrefillDiffFn.apply(q, k, v, float(scale), window, prefix_len,
                               q_offset)


def prefill_hbm_bytes(B: int, Sq: int, Skv: int, H: int, G: int, dh: int,
                      fmt) -> int:
    """Bytes one prefill call must move: q in and out (f32), K and V read
    once at container width."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    return 2 * B * Sq * H * G * dh * 4 + 2 * B * Skv * H * dh * item


def attention_hbm_bytes(batch: int, seq: int, n_kv: int, head_dim: int,
                        fmt, *, g: int = 1) -> int:
    """The reference's model of the bytes one decode step streams through
    attention: the whole K and V payloads of ``seq`` slots (container
    width; the dominant term) plus the ``g`` f32 query rows per KV
    head."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    kv = 2 * batch * seq * n_kv * head_dim * item
    return kv + batch * n_kv * g * head_dim * 4


def ring_ppermute_bytes(batch: int, seq: int, n_kv: int, head_dim: int,
                        fmt, *, n_devices: int) -> int:
    """Bytes ONE rank sends per decode step under the ``ring`` wrapper
    over a contiguous cache: its (seq / n_devices)-slot K and V shards,
    passed to the next rank on each of the n_devices - 1 rotations, at
    container width (the packed formats shrink the transfer as they
    shrink HBM traffic)."""
    item = 4 if fmt is None else get_format(fmt).container_bytes
    shard = batch * (seq // n_devices) * n_kv * head_dim * item
    return 2 * shard * (n_devices - 1)
