"""Block-table (paged) packed-KV cache: one shared page pool per layer.

The port's copy of ``repro.kernels.paged_cache``.  Two halves:

:class:`PagedKVCache`
    The device state: pools, block tables and sequence lengths.  The
    pools hold the whole KV working set, so the port writes them **in
    place** (the reference's functional scatter would copy every pool on
    every token); the small tables and lengths are replaced functionally,
    so a caller holding an older ``PagedKVCache`` still sees its own
    tables and lengths.

:class:`PagePool`
    The host allocator (free list, per-slot page ownership), copied from
    the reference as it is.

The device functions are the reference's: ``append_decode``,
``append_block`` (K tokens per slot, the speculative verify write),
``write_chunk``, ``write_prefill``, ``set_seq_len``,
``truncate_seq_lens`` (the speculative rollback), ``release_slot``,
``set_block_tables``, ``gather_pages`` and ``paged_view_of_contiguous``.

Unmapped block-table entries are ``-1``.  Writes through an unmapped entry
are dropped: JAX drops them with ``mode="drop"``, torch's ``index_put``
raises on an out-of-range index, so the port masks the rows explicitly.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

DEFAULT_PAGE_SIZE = 64
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


class PoolError(RuntimeError):
    """Classified page-allocator misuse (double free, unknown slot)."""

    exit_code = 76
    kind = "pool"


def validate_page_size(page_size: int) -> int:
    """Pages are a multiple of 8 tokens, as in the reference (u32-word
    alignment of every packed format's lanes)."""
    if page_size <= 0 or page_size % 8:
        raise ValueError(
            f"page_size {page_size} must be a positive multiple of 8 "
            f"(u32-word alignment of the packed codec lanes + f32 sublane "
            f"tile)")
    return page_size


class PagedKVCache(NamedTuple):
    """k_pool / v_pool: (num_pages, page_size, n_kv, head_dim) in the
    kv_cache storage dtype; block_tables: (n_slots, pages_per_seq) int32,
    -1 = unmapped; seq_lens: (n_slots,) int32."""
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    block_tables: torch.Tensor
    seq_lens: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k_pool.shape[0]

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[1]

    @property
    def n_slots(self) -> int:
        return self.block_tables.shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.block_tables.shape[1]

    @property
    def capacity(self) -> int:
        return self.pages_per_seq * self.page_size


def init_paged_cache(n_slots: int, num_pages: int, page_size: int,
                     pages_per_seq: int, n_kv: int, head_dim: int,
                     dtype, device=None) -> PagedKVCache:
    validate_page_size(page_size)
    shape = (num_pages, page_size, n_kv, head_dim)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=dtype, device=device),
        v_pool=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((n_slots, pages_per_seq), -1,
                                dtype=torch.int32, device=device),
        seq_lens=torch.zeros((n_slots,), dtype=torch.int32, device=device))


def _scatter_tokens(pool, phys, off, vals) -> None:
    """pool[phys[i], off[i]] = vals[i] in place, skipping unmapped rows
    (phys < 0), without a host sync (a boolean-mask index would wait for
    the device to count the rows).  An unmapped row repeats the first
    mapped row's write -- same place, same value, so the duplicate is
    harmless -- or, when no row is mapped, writes pool[0, 0] back onto
    itself."""
    keep = phys >= 0
    vals = vals.to(pool.dtype)
    any_keep = keep.any()
    # first mapped row, as a 1-element index: a 0-d index tensor would be
    # read back to the host
    j = torch.argmax(keep.to(torch.int32)).view(1)
    src_p = torch.where(any_keep, phys[j], 0)
    src_o = torch.where(any_keep, off[j], 0)
    fill = torch.where(any_keep, vals[j].view(_bits(pool)),
                       pool[0, 0].view(_bits(pool)))
    rows = keep.view((-1,) + (1,) * (vals.dim() - 1))
    vals = torch.where(rows, vals.view(_bits(pool)), fill).view(pool.dtype)
    pool.index_put_((torch.where(keep, phys, src_p).long(),
                     torch.where(keep, off, src_o).long()), vals)


def _bits(t) -> torch.dtype:
    """The signed integer dtype of ``t``'s width (``torch.where`` has no
    float8 kernel; the scatter moves bits)."""
    return {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]


def append_decode(cache: PagedKVCache, k, v) -> PagedKVCache:
    """Append one decode token per slot at position ``seq_lens[s]``.

    k / v: (n_slots, 1, n_kv, head_dim), cast to the pool dtype here.
    Slots whose next position has no mapped page are dropped and their
    length does not advance."""
    pos = cache.seq_lens.long()
    lp = torch.clamp(pos // cache.page_size, 0, cache.pages_per_seq - 1)
    rows = torch.arange(cache.n_slots, device=pos.device)
    phys = cache.block_tables[rows, lp].long()
    off = pos % cache.page_size
    mapped = (phys >= 0) & (pos < cache.capacity)
    phys = torch.where(mapped, phys, -1)
    _scatter_tokens(cache.k_pool, phys, off, k[:, 0])
    _scatter_tokens(cache.v_pool, phys, off, v[:, 0])
    return cache._replace(
        seq_lens=torch.where(mapped, pos + 1, pos).to(torch.int32))


def append_block(cache: PagedKVCache, k, v) -> PagedKVCache:
    """Append ``K`` tokens per slot at positions ``seq_lens[s] + i``.

    k / v: (n_slots, K, n_kv, head_dim), cast to the pool dtype here.
    Token ``i`` of slot ``s`` lands where ``K`` sequential
    :func:`append_decode` calls would put it (same cast, same drops), so
    the speculative verify path stays bit-identical to plain decode.  A
    slot's length advances by its run of *leading* mapped positions."""
    K = k.shape[1]
    base = cache.seq_lens.long()
    pos = base[:, None] + torch.arange(K, device=base.device)[None, :]
    lp = torch.clamp(pos // cache.page_size, 0, cache.pages_per_seq - 1)
    phys = torch.gather(cache.block_tables.long(), 1, lp)
    mapped = (phys >= 0) & (pos < cache.capacity)
    phys = torch.where(mapped, phys, -1)
    off = pos % cache.page_size
    tail = tuple(k.shape[2:])
    _scatter_tokens(cache.k_pool, phys.reshape(-1), off.reshape(-1),
                    k.reshape((-1,) + tail))
    _scatter_tokens(cache.v_pool, phys.reshape(-1), off.reshape(-1),
                    v.reshape((-1,) + tail))
    adv = torch.cumprod(mapped.to(torch.int64), dim=1).sum(dim=1)
    return cache._replace(seq_lens=(base + adv).to(torch.int32))


def write_chunk(cache: PagedKVCache, slot: int, k, v,
                offset: int) -> PagedKVCache:
    """Scatter one prefill chunk (positions offset..offset+S-1) of one
    sequence into ``slot``'s mapped pages.  k / v: (S, n_kv, head_dim).
    Unmapped tails are dropped and the recorded length clamped to
    ``offset + #mapped``."""
    S = k.shape[0]
    dev = cache.block_tables.device
    pos = torch.arange(S, device=dev) + offset
    lp = torch.clamp(pos // cache.page_size, 0, cache.pages_per_seq - 1)
    phys = cache.block_tables[slot, lp].long()
    mapped = (phys >= 0) & (pos < cache.capacity)
    n_mapped = mapped.to(torch.int32).sum()
    phys = torch.where(mapped, phys, -1)
    off = pos % cache.page_size
    _scatter_tokens(cache.k_pool, phys, off, k)
    _scatter_tokens(cache.v_pool, phys, off, v)
    lens = cache.seq_lens.clone()
    lens[slot] = offset + n_mapped
    return cache._replace(seq_lens=lens)


def write_prefill(cache: PagedKVCache, slot: int, k, v) -> PagedKVCache:
    """Write a whole prefilled prompt (positions 0..S-1) into ``slot``'s
    pages.  k / v: (S, n_kv, head_dim), e.g. ``KVCache.k[0][:S]`` of the
    transient contiguous prefill cache.  Pages must already be mapped;
    unmapped tails are dropped and the length clamped as in
    :func:`write_chunk`."""
    return write_chunk(cache, slot, k, v, 0)


def set_seq_len(cache: PagedKVCache, slot: int, n) -> PagedKVCache:
    """Host-declared length for ``slot`` (a transport that copies whole
    pages into the pool sets the device length at handoff)."""
    lens = cache.seq_lens.clone()
    lens[slot] = int(n)
    return cache._replace(seq_lens=lens)


def truncate_seq_lens(cache: PagedKVCache, max_lens) -> PagedKVCache:
    """Device half of the speculative rollback: clamp every slot's length
    to ``max_lens`` (per slot).  Entries past the clamp stay as stale pool
    bytes, which every reader masks; :meth:`PagePool.truncate` returns
    the pages past the truncation point to the free list."""
    if not isinstance(max_lens, torch.Tensor):
        max_lens = torch.as_tensor(np.asarray(max_lens, np.int64))
    return cache._replace(seq_lens=torch.minimum(
        cache.seq_lens, max_lens.to(cache.seq_lens.device,
                                    torch.int32)))


def release_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Unmap a slot (free/evict); pool bytes stay stale on purpose."""
    if not 0 <= int(slot) < cache.n_slots:
        raise PoolError(
            f"release_slot: slot {slot} outside 0..{cache.n_slots - 1}")
    tables = cache.block_tables.clone()
    lens = cache.seq_lens.clone()
    tables[slot] = -1
    lens[slot] = 0
    return cache._replace(block_tables=tables, seq_lens=lens)


def set_block_tables(cache: PagedKVCache, tables) -> PagedKVCache:
    """Push a host-refreshed block table (array-like, or an int32 tensor
    already on the device, which several layers may share) into the
    device state."""
    if not isinstance(tables, torch.Tensor):
        tables = torch.as_tensor(np.asarray(tables, np.int32))
    return cache._replace(block_tables=tables.to(cache.block_tables.device))


def paged_view_of_contiguous(ck, cv, page_size: int = DEFAULT_PAGE_SIZE):
    """View a contiguous (B, S, H, dh) cache as (pools, block_tables) with
    the identity paging (zero-padded when ``page_size`` does not divide
    S; padded slots sit beyond every valid length)."""
    B, S = ck.shape[0], ck.shape[1]
    page = max(8, min(page_size, S))
    n_pages = -(-S // page)
    pad = n_pages * page - S
    if pad:
        z = torch.zeros((B, pad) + tuple(ck.shape[2:]), dtype=ck.dtype,
                        device=ck.device)
        ck = torch.cat([ck, z], dim=1)
        cv = torch.cat([cv, z], dim=1)
    shape = (B * n_pages, page) + tuple(ck.shape[2:])
    tables = torch.arange(B * n_pages, dtype=torch.int32,
                          device=ck.device).reshape(B, n_pages)
    return ck.reshape(shape), cv.reshape(shape), tables


def gather_pages(pool, block_tables):
    """Materialize the contiguous (B, pages_per_seq * page_size, H, dh)
    view of a paged pool (unmapped pages come back as physical page 0;
    callers mask them)."""
    tbl = torch.clamp(block_tables.long(), 0, pool.shape[0] - 1)
    signed = _SIGNED_VIEW.get(pool.dtype)
    # CUDA has no indexing kernel for uint16/uint32: gather the same bits
    # through the signed view of equal width
    g = pool.view(signed)[tbl].view(pool.dtype) if signed else pool[tbl]
    B, P, page = g.shape[0], g.shape[1], g.shape[2]
    return g.reshape((B, P * page) + tuple(g.shape[3:]))


def read_pages(pool, ids) -> torch.Tensor:
    """The physical pages ``ids`` (int tensor) of a pool, as a new
    (len(ids), page, H, dh) tensor of the pool's dtype."""
    signed = _SIGNED_VIEW.get(pool.dtype)
    if signed:
        return pool.view(signed)[ids.long()].view(pool.dtype)
    return pool[ids.long()]


def write_pages(pool, ids, pages) -> None:
    """pool[ids] = pages in place: whole physical pages, bits unchanged
    (the streamed transport's handoff copy)."""
    signed = _SIGNED_VIEW.get(pool.dtype)
    if signed:
        pool.view(signed)[ids.long()] = pages.view(signed)
    else:
        pool[ids.long()] = pages


# ---------------------------------------------------------------------------
# host-side allocator, as in the reference
# ---------------------------------------------------------------------------

class PagePool:
    """Free-list page allocator + host mirror of tables and lengths, with
    namespaces (one physical free list behind several logical page maps).
    Freed pages return to the free list in LIFO order."""

    def __init__(self, num_pages: int, page_size: int, n_slots: int,
                 pages_per_seq: int):
        validate_page_size(page_size)
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.pages_per_seq = pages_per_seq
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ns: dict = {}
        self._ensure_ns("")
        self.peak_pages_used = 0
        self.quarantined: List[int] = []

    def _ensure_ns(self, ns: str) -> dict:
        if ns not in self._ns:
            self._ns[ns] = {
                "owned": {},
                "lens": np.zeros(self.n_slots, np.int64),
                "tables": np.full((self.n_slots, self.pages_per_seq), -1,
                                  np.int32),
            }
        return self._ns[ns]

    @property
    def owned(self) -> dict:
        return self._ns[""]["owned"]

    @property
    def lens(self) -> np.ndarray:
        return self._ns[""]["lens"]

    @property
    def tables(self) -> np.ndarray:
        return self._ns[""]["tables"]

    @property
    def namespaces(self) -> tuple:
        return tuple(self._ns)

    def ns_owned(self, ns: str = "") -> dict:
        return self._ensure_ns(ns)["owned"]

    def ns_lens(self, ns: str = "") -> np.ndarray:
        return self._ensure_ns(ns)["lens"]

    def ns_tables(self, ns: str = "") -> np.ndarray:
        return self._ensure_ns(ns)["tables"]

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def pages_used(self) -> int:
        return self.num_pages - len(self.free)

    def occupancy(self) -> float:
        return self.pages_used / max(self.num_pages, 1)

    def internal_fragmentation(self) -> float:
        slots = self.pages_used * self.page_size
        if slots == 0:
            return 0.0
        valid = sum(float(ns["lens"].sum()) for ns in self._ns.values())
        return 1.0 - valid / slots

    def can_admit(self, n_tokens: int, *more_tokens: int) -> bool:
        needs = [self.pages_for(max(n, 1)) for n in (n_tokens,) + more_tokens]
        return (sum(needs) <= len(self.free)
                and max(needs) <= self.pages_per_seq)

    def _check_slot(self, op: str, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise PoolError(
                f"{op}: slot {slot} outside 0..{self.n_slots - 1}")

    def _owned_pages(self, op: str, slot: int, space: dict,
                     ns: str) -> List[int]:
        pages = space["owned"].get(slot)
        if pages is None:
            raise PoolError(
                f"{op}: slot {slot} owns no pages in namespace {ns!r}")
        return pages

    def allocate(self, slot: int, n_tokens: int, *, ns: str = "") -> bool:
        self._check_slot("allocate", slot)
        space = self._ensure_ns(ns)
        if slot in space["owned"]:
            raise PoolError(
                f"allocate: slot {slot} already allocated in namespace "
                f"{ns!r}")
        if not self.can_admit(n_tokens):
            return False
        need = self.pages_for(max(n_tokens, 1))
        pages = [self.free.pop() for _ in range(need)]
        space["owned"][slot] = pages
        space["tables"][slot, :need] = pages
        space["lens"][slot] = n_tokens
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return True

    def ensure_capacity(self, slot: int, n_tokens: int, *,
                        ns: str = "") -> bool:
        self._check_slot("ensure_capacity", slot)
        space = self._ensure_ns(ns)
        pages = self._owned_pages("ensure_capacity", slot, space, ns)
        need = self.pages_for(n_tokens)
        if need > self.pages_per_seq:
            return False
        while len(pages) < need:
            if not self.free:
                return False
            pg = self.free.pop()
            space["tables"][slot, len(pages)] = pg
            pages.append(pg)
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return True

    def note_decode_step(self, slot: int, *, ns: str = "") -> None:
        self._ensure_ns(ns)["lens"][slot] += 1

    def truncate(self, slot: int, n_tokens: int, *, ns: str = "") -> int:
        self._check_slot("truncate", slot)
        space = self._ensure_ns(ns)
        pages = self._owned_pages("truncate", slot, space, ns)
        keep = self.pages_for(max(n_tokens, 1))
        excess = pages[keep:]
        del pages[keep:]
        self.free.extend(reversed(excess))
        space["tables"][slot, keep:] = -1
        space["lens"][slot] = n_tokens
        return len(excess)

    def free_slot(self, slot: int) -> int:
        self._check_slot("free_slot", slot)
        if not any(slot in space["owned"] for space in self._ns.values()):
            raise PoolError(
                f"free_slot: slot {slot} owns no pages in any namespace "
                f"(double free, or freed after quarantine?)")
        freed = 0
        for space in self._ns.values():
            pages = space["owned"].pop(slot, [])
            self.free.extend(reversed(pages))
            space["tables"][slot] = -1
            space["lens"][slot] = 0
            freed += len(pages)
        return freed

    def quarantine_slot(self, slot: int) -> int:
        self._check_slot("quarantine_slot", slot)
        if not any(slot in space["owned"] for space in self._ns.values()):
            raise PoolError(
                f"quarantine_slot: slot {slot} owns no pages in any "
                f"namespace")
        n = 0
        for space in self._ns.values():
            pages = space["owned"].pop(slot, [])
            self.quarantined.extend(pages)
            space["tables"][slot] = -1
            space["lens"][slot] = 0
            n += len(pages)
        return n

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_used": self.pages_used,
            "peak_pages_used": self.peak_pages_used,
            "quarantined_pages": len(self.quarantined),
            "occupancy": round(self.occupancy(), 4),
            "internal_fragmentation":
                round(self.internal_fragmentation(), 4),
        }
