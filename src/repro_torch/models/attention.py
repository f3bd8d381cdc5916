"""Grouped-query attention with transprecision KV caches: the port of
``repro.models.attention`` for the dense decoder.

Paths: prefill through the prefill registry, decode against a contiguous
:class:`KVCache` (the synchronous reference loop) or against a paged
:class:`~repro_torch.kernels.paged_cache.PagedKVCache` (the engine),
:func:`prefill_paged_chunk`, the engine's chunked prefill straight into
one slot's pages, :func:`prefill_from_cache`, a continuation prefill
into a contiguous cache, and the non-causal attention of an encoder and
of a decoder's cross attention (``mha(causal=False)``, ``mha(kv_source=)``),
plain torch over unrounded K/V as the reference's XLA branch is.

Registered backends (``kernels/dispatch.py`` says what each spelling maps
to): decode ``xla`` / ``flash_pallas`` / ``paged``; prefill ``xla`` /
``flash_pallas`` / ``paged``.  :func:`verify_paged` is the speculative
verify step's attention: K positions per slot through the same decode
backends.  The KV write into the pool stays a torch cast
(``.to(float8_e5m2)``), as the reference's is an XLA ``astype``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qtensor import decode as _qdecode
from repro_torch.kernels import _build, dispatch, paged_cache
from repro_torch.kernels.flash_attention import (NEG_INF, flash_decode,
                                                 flash_prefill,
                                                 flash_prefill_diff)
from repro_torch.kernels.paged_attention import paged_decode
from repro_torch.kernels.paged_cache import PagedKVCache

from .layers import act_cast, dense_init, pdot, peinsum, rope

F32 = torch.float32


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, n_kv, dh) in kv_cache dtype
    v: torch.Tensor
    pos: int         # next write position (monotonic)

    @property
    def capacity(self):
        return self.k.shape[1]


def attn_init(gen, cfg, dtype, device=None, cross: bool = False):
    """wq, wk, wv, wo; a cross attention's (``cross``) are the same four,
    its K/V projected from the encoder output (:func:`mha`'s
    ``kv_source``)."""
    del cross
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (d, cfg.q_dim), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, cfg.kv_dim), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, cfg.kv_dim), dtype=dtype, device=device),
        "wo": dense_init(gen, (cfg.q_dim, d), dtype=dtype, device=device),
    }


def _split_heads(x, n, dh):
    B, S, _ = x.shape
    return x.reshape(B, S, n, dh)


def _neg_inf(device):
    return torch.tensor(NEG_INF, dtype=F32, device=device)


def _gqa_scores(q, k, policy):
    """q: (B, Sq, n_kv, G, dh); k: (B, Skv, n_kv, dh) -> (B, n_kv, G, Sq,
    Skv), f32 accumulation."""
    return peinsum("bqhgd,bkhd->bhgqk", q, k, policy, "attn_w",
                   out_act=False)


def _softmax_weighted(scores_f32, v, policy, valid=None):
    """f32 softmax, probs cast to attn_probs, then probs @ v; ``valid``
    zeroes fully-masked rows (plain softmax would give the mean of V)."""
    probs = torch.softmax(scores_f32, dim=-1)
    if valid is not None:
        probs = torch.where(valid, probs, torch.zeros((), device=probs.device))
    probs = act_cast(probs, policy, "attn_probs")
    return peinsum("bhgqk,bkhd->bqhgd", probs, v, policy, "attn_w")


def _causal_mask(sq, skv, q_offset, window: Optional[int], device):
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(skv, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m


def _dequant_cache(ck, cv, policy):
    if policy.mode == "native" and ck.dtype != F32:
        # e5m2 -> bf16 is exact; the dots accumulate in f32
        return ck.to(torch.bfloat16), cv.to(torch.bfloat16)
    return (act_cast(ck.to(F32), policy), act_cast(cv.to(F32), policy))


def _cache_payload(ck, cv, policy):
    """Cache tensors -> (k_payload, v_payload, fmt) for the packed-KV
    kernels: a native narrow cache is bitcast to its container (the e5m2
    pool is read as uint8); f32 and emulated caches pass as f32."""
    fmt = policy.fmt("kv_cache")
    if policy.mode == "native" and not fmt.is_binary32:
        return (ck.view(fmt.container_dtype), cv.view(fmt.container_dtype),
                fmt)
    return ck.to(F32), cv.to(F32), None


# ---------------------------------------------------------------------------
# registered decode backends
# ---------------------------------------------------------------------------

@dispatch.register_decode("xla")
def _decode_xla(q, ck, cv, n_valid, *, scale, policy,
                return_residuals: bool = False):
    """The plain dequantize path."""
    kk, vv = _dequant_cache(ck, cv, policy)
    qg = q[:, None]
    scores = _gqa_scores(qg, kk, policy).to(F32) * scale
    valid = (torch.arange(ck.shape[1], device=q.device)[None, :]
             < n_valid.to(torch.int64)[:, None])
    vmask = valid[:, None, None, None, :]
    scores = torch.where(vmask, scores, _neg_inf(q.device))
    if not return_residuals:
        return _softmax_weighted(scores, vv, policy, vmask)[:, 0]
    m = torch.amax(scores, dim=-1)
    e = torch.exp(scores - m[..., None])
    e = torch.where(vmask, e, torch.zeros((), device=q.device))
    l = torch.sum(e, dim=-1)
    ln = l[..., None]
    probs = act_cast(torch.where(ln > 0, e / torch.where(ln > 0, ln, 1.0),
                                 torch.zeros((), device=q.device)),
                     policy, "attn_probs")
    out = peinsum("bhgqk,bkhd->bqhgd", probs, vv, policy, "attn_w",
                  out_act=False)
    return out[:, 0], m[..., 0], l[..., 0]


@dispatch.register_decode("flash_pallas")
def _decode_flash_pallas(q, ck, cv, n_valid, *, scale, policy,
                         return_residuals: bool = False):
    """Fused packed-KV flash decode over a contiguous cache:
    ``kernels/flash_attention.flash_decode`` (the CUDA kernel on a card)
    reads container-width bytes and decodes them in the kernel."""
    kp, vp, fmt = _cache_payload(ck, cv, policy)
    return flash_decode(q.to(F32).contiguous(), kp, vp, fmt,
                        n_valid.to(torch.int32), scale=scale,
                        return_residuals=return_residuals)


@dispatch.register_decode("paged")
def _decode_paged(q, ck, cv, n_valid, *, scale, policy, block_tables=None,
                  return_residuals: bool = False):
    """Block-table decode over the page pool: ``kernels/paged_attention``
    (the CUDA kernel on a card)."""
    if block_tables is None:
        raise ValueError(
            "decode_impl 'paged' reads the cache through a block table; "
            "pass block_tables=(B, pages_per_seq) int32")
    kp, vp, fmt = _cache_payload(ck, cv, policy)
    return paged_decode(q.to(F32).contiguous(), kp, vp, fmt,
                        n_valid.to(torch.int32), block_tables, scale=scale,
                        return_residuals=return_residuals)


# ---------------------------------------------------------------------------
# registered prefill backends
# ---------------------------------------------------------------------------

@dispatch.register_prefill("xla")
def _prefill_xla(qg, k, v, *, scale, policy, window, prefix_len, chunk,
                 q_offset: int = 0, fmt=None):
    """Plain masked softmax (q-chunked for long sequences)."""
    if fmt is not None:
        k = act_cast(_qdecode(k, fmt), policy)
        v = act_cast(_qdecode(v, fmt), policy)
    S, skv = qg.shape[1], k.shape[1]
    dev = qg.device
    bounds = [(0, S)]
    if chunk is not None and S > chunk:
        bounds = [(lo, min(lo + chunk, S)) for lo in range(0, S, chunk)]
    outs = []
    for lo, hi in bounds:
        kv_hi = skv
        if len(bounds) > 1:
            kv_hi = min(max(q_offset + hi, prefix_len), skv)
        scores = _gqa_scores(qg[:, lo:hi], k[:, :kv_hi], policy).to(F32) \
            * scale
        m = _causal_mask(hi - lo, kv_hi, q_offset + lo, window, dev)
        if prefix_len:
            m = m | (torch.arange(kv_hi, device=dev)[None, :] < prefix_len)
        scores = torch.where(m[None, None, None], scores, _neg_inf(dev))
        outs.append(_softmax_weighted(scores, v[:, :kv_hi], policy))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


@dispatch.register_prefill("flash_pallas")
def _prefill_flash(qg, k, v, *, scale, policy, window, prefix_len, chunk,
                   q_offset: int = 0, fmt=None):
    """Fused chunked-causal prefill: ``kernels/flash_attention`` (the
    CUDA kernel on a card), reading packed K/V when ``fmt`` is set.  Float
    K/V that autograd records (training) go through
    ``flash_prefill_diff``: the same kernel forward, a recompute
    backward."""
    del chunk  # the kernel tiles the queries itself
    qg = qg.to(F32).contiguous()
    if fmt is None:
        k, v = k.to(F32).contiguous(), v.to(F32).contiguous()
        if _build.needs_grad(qg, k, v):
            return act_cast(flash_prefill_diff(
                qg, k, v, scale=scale, window=window, prefix_len=prefix_len,
                q_offset=q_offset), policy)
    out = flash_prefill(qg, k.contiguous(), v.contiguous(), fmt,
                        scale=scale, window=window, prefix_len=prefix_len,
                        q_offset=q_offset)
    return act_cast(out, policy)


@dispatch.register_prefill("paged")
def _prefill_paged(qg, k, v, *, scale, policy, window, prefix_len, chunk,
                   q_offset: int = 0, fmt=None):
    """Paging is a property of the cache, not of prefill K/V: attention
    delegates to the fused flash prefill, as in the reference."""
    return _prefill_flash(qg, k, v, scale=scale, policy=policy,
                          window=window, prefix_len=prefix_len, chunk=chunk,
                          q_offset=q_offset, fmt=fmt)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def decode_impl(cfg, policy: PrecisionPolicy) -> str:
    """The policy override wins over the config default."""
    return policy.decode_impl or cfg.decode_impl


def _qkv(p, x, cfg, policy, kv_source=None):
    """q from ``x``; k and v from ``kv_source`` (cross attention) or
    ``x``."""
    n_kv, dh = cfg.n_kv, cfg.head_dim
    src = x if kv_source is None else kv_source
    q = _split_heads(pdot(x, p["wq"], policy, "attn_w"), cfg.n_heads, dh)
    k = _split_heads(pdot(src, p["wk"], policy, "attn_w"), n_kv, dh)
    v = _split_heads(pdot(src, p["wv"], policy, "attn_w"), n_kv, dh)
    return q, k, v


def _full_attention(p, x, cfg, policy, kv_source):
    """Non-causal attention with no cache, the reference's plain branch
    (``_gqa_scores`` + ``_softmax_weighted``): an encoder's
    self-attention (``kv_source`` None, rope at positions 0..S-1 when the
    config ropes) or a decoder's cross attention, K/V projected from
    ``kv_source`` (no rope).  K/V stay the projections' activations: no
    KV-cache format rounds them."""
    B, S, _ = x.shape
    n_kv, dh = cfg.n_kv, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, policy, kv_source)
    if kv_source is None and cfg.rope_theta > 0:
        positions = torch.arange(S, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    scale = np.float32(1.0 / np.sqrt(dh))
    qg = q.reshape(B, S, n_kv, cfg.n_heads // n_kv, dh)
    scores = _gqa_scores(qg, k, policy).to(F32) * scale
    out = _softmax_weighted(scores, v, policy).reshape(B, S, cfg.q_dim)
    return pdot(out, p["wo"], policy, "attn_w"), None


def mha(p, x, cfg, policy: PrecisionPolicy, *, causal: bool = True,
        prefix_len: int = 0, cache=None, kv_source=None,
        chunk: Optional[int] = None, cache_capacity: Optional[int] = None):
    """Causal self-attention: prefill (``cache`` None), or one decode
    token against a contiguous ``KVCache`` or a ``PagedKVCache``.
    ``causal=False`` (an encoder) or a ``kv_source`` (cross attention
    over the encoder output, which disables causality) attends over
    every position with no cache (:func:`_full_attention`).  Returns
    (out, new_cache)."""
    if kv_source is not None or not causal:
        if cache is not None or cache_capacity is not None:
            raise ValueError("non-causal and cross attention keep no "
                             "KV cache")
        return _full_attention(p, x, cfg, policy, kv_source)
    B, S, _ = x.shape
    n_kv, dh = cfg.n_kv, cfg.head_dim
    G = cfg.n_heads // n_kv
    dev = x.device
    q, k, v = _qkv(p, x, cfg, policy)

    paged = isinstance(cache, PagedKVCache)
    cache_pos = 0
    if cache is not None:
        cache_pos = cache.seq_lens.to(torch.int64)[:, None] if paged \
            else cache.pos
    if cfg.rope_theta > 0:
        positions = torch.arange(S, device=dev)[None, :] + cache_pos
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    scale = np.float32(1.0 / np.sqrt(dh))
    qg = q.reshape(B, S, n_kv, G, dh)
    impl = decode_impl(cfg, policy)
    fn_name = dispatch.canonicalize_impl(impl)[-1]

    new_cache = None
    if paged:
        if S != 1:
            raise ValueError("paged KV caches decode one token at a time; "
                             "prefill lands via prefill_paged_chunk")
        if cfg.window is not None and cache.capacity > cfg.window:
            raise ValueError(
                f"paged KV cache capacity {cache.capacity} exceeds the "
                f"sliding window {cfg.window}")
        new_cache = paged_cache.append_decode(cache, k, v)
        fn = dispatch.resolve_decode(impl)
        if fn_name == "paged":
            out = fn(qg[:, 0], new_cache.k_pool, new_cache.v_pool,
                     new_cache.seq_lens, scale=scale, policy=policy,
                     block_tables=new_cache.block_tables)
        else:
            # contiguous-impl bridge: gather every slot's pages; positions
            # at or past seq_lens (and unmapped pages) are masked
            ckg = paged_cache.gather_pages(new_cache.k_pool,
                                           new_cache.block_tables)
            cvg = paged_cache.gather_pages(new_cache.v_pool,
                                           new_cache.block_tables)
            out = fn(qg[:, 0], ckg, cvg, new_cache.seq_lens, scale=scale,
                     policy=policy)
        out = act_cast(out, policy)[:, None]
    elif cache is not None:
        if S != 1:
            raise ValueError("a contiguous cache decodes one token at a "
                             "time in repro_torch")
        ring = cfg.window is not None and cache.capacity == cfg.window
        slot = cache.pos % cache.capacity if ring \
            else min(cache.pos, cache.capacity - 1)
        ck, cv = cache.k.clone(), cache.v.clone()
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
        new_cache = KVCache(k=ck, v=cv, pos=cache.pos + 1)
        n_valid = min(cache.pos + 1, cache.capacity) if ring \
            else cache.pos + 1
        fn = dispatch.resolve_decode(impl)
        lengths = torch.full((B,), n_valid, dtype=torch.int32, device=dev)
        if fn_name == "paged":
            lengths = torch.clamp(lengths, max=ck.shape[1])
            kp_, vp_, tbl = paged_cache.paged_view_of_contiguous(ck, cv)
            out = fn(qg[:, 0], kp_, vp_, lengths, scale=scale, policy=policy,
                     block_tables=tbl)
        else:
            out = fn(qg[:, 0], ck, cv, lengths, scale=scale, policy=policy)
        out = act_cast(out, policy)[:, None]
    else:
        fn = dispatch.resolve_prefill(impl)
        out = fn(qg, k, v, scale=scale, policy=policy, window=cfg.window,
                 prefix_len=prefix_len, chunk=chunk)

    if cache_capacity is not None and cache is None:
        new_cache = _build_cache(k, v, cfg, policy, cache_capacity, S)

    out = out.reshape(B, S, cfg.q_dim)
    return pdot(out, p["wo"], policy, "attn_w"), new_cache


def verify_paged(p, x, cfg, policy: PrecisionPolicy, cache: PagedKVCache):
    """Speculative-verify attention: append ``K`` tokens per slot to the
    paged cache, then attend each position through the registered decode
    backend -- position by position the computation of ``K`` sequential
    single-token :func:`mha` decode calls.

    x: (B, K, d).  The projections, rope and output matmul run once over
    all K positions (one weight pass instead of K); the attention core is
    a loop over positions through the same decode contract the plain
    decode step uses: position ``i`` sees ``n_valid = min(seq_lens_before
    + i + 1, seq_lens_after)``, and entries written for later positions
    sit at or beyond that bound, where every backend masks them.  For a
    contiguous backend one gather of the pages serves all K positions.
    Returns (out (B, K, d), new_cache with K appended per mapped slot)."""
    B, K, _ = x.shape
    n_kv, dh = cfg.n_kv, cfg.head_dim
    G = cfg.n_heads // n_kv
    if cfg.window is not None and cache.capacity > cfg.window:
        raise ValueError(
            f"paged KV cache capacity {cache.capacity} exceeds the sliding "
            f"window {cfg.window}")
    q, k, v = _qkv(p, x, cfg, policy)
    base = cache.seq_lens.to(torch.int64)
    if cfg.rope_theta > 0:
        positions = base[:, None] + torch.arange(K, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = paged_cache.append_block(cache, k, v)

    scale = np.float32(1.0 / np.sqrt(dh))
    qg = q.reshape(B, K, n_kv, G, dh)
    impl = decode_impl(cfg, policy)
    fn = dispatch.resolve_decode(impl)
    paged_base = dispatch.canonicalize_impl(impl)[-1] == "paged"
    if not paged_base:
        ckg = paged_cache.gather_pages(new_cache.k_pool,
                                       new_cache.block_tables)
        cvg = paged_cache.gather_pages(new_cache.v_pool,
                                       new_cache.block_tables)
    after = new_cache.seq_lens.to(torch.int64)
    outs = []
    for i in range(K):
        n_valid = torch.minimum(base + (i + 1), after).to(torch.int32)
        if paged_base:
            o = fn(qg[:, i], new_cache.k_pool, new_cache.v_pool, n_valid,
                   scale=scale, policy=policy,
                   block_tables=new_cache.block_tables)
        else:
            o = fn(qg[:, i], ckg, cvg, n_valid, scale=scale, policy=policy)
        outs.append(act_cast(o, policy))
    out = torch.stack(outs, dim=1).reshape(B, K, cfg.q_dim)
    return pdot(out, p["wo"], policy, "attn_w"), new_cache


def _build_cache(k, v, cfg, policy, capacity: int, S: int) -> KVCache:
    """A fresh contiguous cache from prefill K/V (post-rope); position p
    lives at slot p % cap in a full ring."""
    dt = policy.dtype("kv_cache")
    cap = capacity if cfg.window is None else min(capacity, cfg.window)
    take = min(S, cap)
    kk = k[:, S - take:].to(dt)
    vv = v[:, S - take:].to(dt)
    if take == cap and (S - take) % cap:
        shift = (S - take) % cap
        return KVCache(k=torch.roll(kk, shift, dims=1),
                       v=torch.roll(vv, shift, dims=1), pos=S)
    shape = (k.shape[0], cap, cfg.n_kv, cfg.head_dim)
    ck = torch.zeros(shape, dtype=dt, device=k.device)
    cv = torch.zeros(shape, dtype=dt, device=k.device)
    ck[:, :take] = kk
    cv[:, :take] = vv
    return KVCache(k=ck, v=cv, pos=S)


def prefill_to_cache(p, x, cfg, policy, capacity: int, prefix_len: int = 0,
                     chunk=None):
    """Prefill attention AND the populated contiguous cache for decode;
    the first ``prefix_len`` rows attend bidirectionally."""
    return mha(p, x, cfg, policy, prefix_len=prefix_len, chunk=chunk,
               cache_capacity=capacity)


@torch.no_grad()
def prefill_from_cache(p, x, cfg, policy, cache: KVCache, q_offset: int,
                       prefix_len: int = 0, chunk=None):
    """Continuation prefill against a contiguous cache: write the chunk's
    K/V (x: (B, S, d)) at rows [q_offset, q_offset + S) in the cache
    format, then attend the chunk's queries causally over the whole cache
    through the prefill registry, reading the cache's payload
    (``_cache_payload``: on a card under ``flash_pallas`` the
    ``flash_prefill`` kernel over the e5m2 bytes at ``q_offset``; rows at
    or past ``q_offset + S`` are masked).  The first ``prefix_len`` rows
    attend bidirectionally.  Raises ``ValueError`` on a ring cache (a
    sliding window's, capacity == window) and on a chunk past the
    capacity, as the reference does.  Returns (out, new cache with pos =
    q_offset + S); ``cache`` is not written."""
    B, S, _ = x.shape
    n_kv, dh = cfg.n_kv, cfg.head_dim
    G = cfg.n_heads // n_kv
    if cfg.window is not None and cache.capacity == cfg.window:
        raise ValueError("prefill_from_cache does not support ring-buffer "
                         "(sliding-window) caches; decode step-by-step")
    if q_offset + S > cache.capacity:
        raise ValueError(f"chunk [{q_offset}, {q_offset + S}) exceeds cache "
                         f"capacity {cache.capacity}")
    q, k, v = _qkv(p, x, cfg, policy)
    if cfg.rope_theta > 0:
        positions = torch.arange(S, device=x.device)[None, :] + q_offset
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    ck, cv = cache.k.clone(), cache.v.clone()
    ck[:, q_offset:q_offset + S] = k.to(ck.dtype)
    cv[:, q_offset:q_offset + S] = v.to(cv.dtype)
    new_cache = KVCache(k=ck, v=cv, pos=q_offset + S)

    scale = np.float32(1.0 / np.sqrt(dh))
    qg = q.reshape(B, S, n_kv, G, dh)
    fn = dispatch.resolve_prefill(decode_impl(cfg, policy))
    kp, vp, fmt = _cache_payload(ck, cv, policy)
    out = fn(qg, kp, vp, scale=scale, policy=policy, window=cfg.window,
             prefix_len=prefix_len, chunk=chunk, q_offset=q_offset, fmt=fmt)
    out = out.reshape(B, S, cfg.q_dim)
    return pdot(out, p["wo"], policy, "attn_w"), new_cache


def prefill_paged_chunk(p, x, cfg, policy, cache: PagedKVCache, slot: int,
                        q_offset: int, chunk=None):
    """One chunked-prefill step for ONE sequence (x: (1, S, d)) straight
    into its pages: write the chunk's K/V at [q_offset, q_offset + S),
    then attend causally over the slot's gathered pages through the
    prefill registry.  Returns (out, new_cache)."""
    B, S, _ = x.shape
    n_kv, dh = cfg.n_kv, cfg.head_dim
    G = cfg.n_heads // n_kv
    if B != 1:
        raise ValueError("prefill_paged_chunk is per-sequence (B == 1)")
    if cfg.window is not None and cache.capacity > cfg.window:
        raise ValueError(
            f"paged KV cache capacity {cache.capacity} exceeds the sliding "
            f"window {cfg.window}")
    if q_offset + S > cache.capacity:
        raise ValueError(f"chunk [{q_offset}, {q_offset + S}) exceeds the "
                         f"slot capacity {cache.capacity}")
    q, k, v = _qkv(p, x, cfg, policy)
    positions = torch.arange(S, device=x.device)[None, :] + q_offset
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = paged_cache.write_chunk(cache, slot, k[0], v[0], q_offset)

    scale = np.float32(1.0 / np.sqrt(dh))
    qg = q.reshape(B, S, n_kv, G, dh)
    fn = dispatch.resolve_prefill(decode_impl(cfg, policy))
    tbl = new_cache.block_tables[slot:slot + 1]
    ck = paged_cache.gather_pages(new_cache.k_pool, tbl)
    cv = paged_cache.gather_pages(new_cache.v_pool, tbl)
    kp, vp, fmt = _cache_payload(ck, cv, policy)
    out = fn(qg, kp, vp, scale=scale, policy=policy, window=cfg.window,
             prefix_len=0, chunk=chunk, q_offset=q_offset, fmt=fmt)
    out = out.reshape(B, S, cfg.q_dim)
    return pdot(out, p["wo"], policy, "attn_w"), new_cache
