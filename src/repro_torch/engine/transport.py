"""Page-handoff transport: how finished packed-KV pages reach the decode
pool.  The port of ``repro.engine.transport``.

Block tables make disaggregated prefill cheap: a prefill chunk lands as N
fixed-size pages, so the handoff between a prefill worker and the decode
batch is a set of page copies.  Two transports implement one contract:

:class:`ColocatedTransport`
    Prefill writes straight into the decode pool (zero-copy: the chunk's
    ``write_chunk`` scatter IS the handoff).  The default.

:class:`StreamedTransport`
    The disaggregated mode: the prefill worker owns a private single-slot
    page pool on a *prefill device*, and every finished page is copied
    into the decode pool's physical page once the chunk cursor passes it.
    With two or more cards the source pool (and a copy of the params) sits
    on the second card; on one card it sits beside the decode pool, and
    the handoff is a device-to-device copy within the card.  Nothing
    falls back to the CPU: an engine on the CPU streams on the CPU.

Scheduler-facing contract (driven once per prefill chunk):
``begin`` -> [``prefill_view`` -> worker chunk -> ``absorb``]* ->
``finish`` (or ``abort`` on mid-flight eviction).  Only attention layers
have pools; a recurrent layer's B = 1 prompt state crosses through
``to_decode`` when the prompt completes (the streamed transport's
recurrent states live on its prefill device until then).

**Checksummed handoff.**  A per-page CRC32 over the packed payload bytes
is taken from the *source pool* before the copy and recomputed from the
decode pool after it, so a bit flip anywhere along the path fails
verification instead of being baked into the expectation.  A mismatch
refetches with capped exponential backoff, re-running the copy from the
source pool each attempt; if it persists through every attempt the
transport raises a classified
:class:`~repro_torch.engine.resilience.TransportError` and the scheduler
recomputes the request from its prompt.  Injected transport faults
(``chunk_drop`` / ``chunk_dup`` / ``page_corrupt``) land here too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import paged_cache

from .resilience import TransportError, page_checksums


def _device_transfer(x, device):
    """The cross-device page copy, at module level so fault tests can wrap
    it and corrupt bytes *in flight*: the CRC contract is that corruption
    during the transfer itself is caught and refetched."""
    return x.to(device)


def _tree_to(tree, device):
    """A param tree (dicts, lists, tensors, QTensors) or a recurrent layer
    state (a NamedTuple of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, QTensor):
        return QTensor(tree.payload.to(device), tree.fmt)
    return tree.to(device)


class ColocatedTransport:
    """Zero-copy handoff: the prefill worker writes the decode pool."""

    name = "colocated"

    def setup(self, engine) -> None:
        self.params = engine.params
        self.device = engine.device

    def begin(self, engine, task) -> None:
        pass

    def to_decode(self, state):
        return state

    def prefill_view(self, engine, task):
        return engine.states, task.slot

    def absorb(self, engine, task, view_states) -> None:
        engine.states = view_states

    def finish(self, engine, task) -> None:
        pass  # write_chunk already set the device-side seq_lens

    def abort(self, engine, task) -> None:
        pass  # the scheduler releases the slot's pages + table row


class StreamedTransport:
    """Disaggregated handoff: private prefill pool, page-by-page copies.

    device_index: which card hosts the prefill worker's pool for an engine
    on CUDA (default: card 1 when two or more are present, else card 0);
    ignored for an engine on the CPU."""

    name = "streamed"

    def __init__(self, device_index=None):
        self.device_index = device_index
        self._task = None  # the one in-flight prefill this pool serves

    def setup(self, engine) -> None:
        if engine.device.type == "cuda":
            if self.device_index is None:
                self.device_index = 1 if torch.cuda.device_count() > 1 \
                    else 0
            self.device = torch.device("cuda", self.device_index)
        else:
            self.device = engine.device
        same = engine.device.index if engine.device.index is not None \
            else (0 if engine.device.type == "cuda" else None)
        self._cross = (self.device.type != engine.device.type
                       or self.device.index != same)
        self.params = (_tree_to(engine.params, self.device)
                       if self._cross else engine.params)
        self._decode_device = engine.device
        cfg, policy = engine.cfg, engine.policy
        # single-slot source pool, identity block table: logical page p
        # of the in-flight prompt is physical page p -- sized for the
        # longest admissible sequence, reused across requests (stale
        # bytes are overwritten; lengths reset in begin())
        ident = np.arange(engine.pages_per_seq, dtype=np.int32)[None, :]
        self.src_states = [None] * cfg.n_layers
        for li in engine.attn_layers:
            self.src_states[li] = paged_cache.set_block_tables(
                paged_cache.init_paged_cache(
                    1, engine.pages_per_seq, engine.page,
                    engine.pages_per_seq, cfg.n_kv, cfg.head_dim,
                    policy.dtype("kv_cache", layer=li), device=self.device),
                ident)

    def begin(self, engine, task) -> None:
        if self._task is not None:
            raise ValueError(
                "StreamedTransport's single-slot source pool serves one "
                "in-flight prefill at a time; give each prefill worker "
                "its own transport "
                "(Engine(transport=[StreamedTransport(), ...]))")
        self._task = task
        for li in engine.attn_layers:
            self.src_states[li] = paged_cache.set_seq_len(
                self.src_states[li], 0, 0)

    def to_decode(self, state):
        return _tree_to(state, self._decode_device) if self._cross \
            else state

    def prefill_view(self, engine, task):
        return self.src_states, 0

    def absorb(self, engine, task, view_states) -> None:
        self.src_states = view_states
        # stream every page the chunk cursor has fully passed
        self._copy_pages(engine, task, task.streamed,
                         task.offset // engine.page)

    def finish(self, engine, task) -> None:
        # flush the ragged final page, then publish the slot's length on
        # the decode side (pages arrived by copy, not write_chunk)
        self._copy_pages(engine, task, task.streamed,
                         engine.pool.pages_for(task.n_tokens))
        for li in engine.attn_layers:
            engine.states[li] = paged_cache.set_seq_len(
                engine.states[li], task.slot, task.n_tokens)
        self._task = None

    def abort(self, engine, task) -> None:
        self._task = None  # begin() resets the source lengths next task

    def _copy_pages(self, engine, task, lo: int, hi: int) -> None:
        if lo >= hi:
            return
        injector = engine.injector
        retry = engine.retry_policy
        dst_ids = torch.as_tensor(engine.pool.tables[task.slot, lo:hi]
                                  .astype(np.int64)).to(engine.device)
        for li in engine.attn_layers:
            src = self.src_states[li]
            # the source pool's pages lo..hi-1 (identity table), copied
            # out so a later chunk cannot change them under the CRC
            src_k = src.k_pool[lo:hi].clone()
            src_v = src.v_pool[lo:hi].clone()
            # prefill-side truth: CRC per page over the packed words,
            # taken from the SOURCE pool BEFORE the transfer -- a bit flip
            # during the transfer itself must fail verification
            want = page_checksums(src_k, src_v)
            dst = engine.states[li]
            for attempt in range(retry.max_attempts):
                kpg, vpg = src_k, src_v
                if self._cross:
                    # the device-to-device transfer, re-run from the
                    # source pool on every refetch attempt
                    kpg = _device_transfer(kpg, engine.device)
                    vpg = _device_transfer(vpg, engine.device)
                fault = injector.take_transport()
                kw, vw = kpg, vpg
                if fault is not None and fault.kind == "page_corrupt":
                    kw = injector.corrupt(kw)
                if fault is None or fault.kind != "chunk_drop":
                    paged_cache.write_pages(dst.k_pool, dst_ids, kw)
                    paged_cache.write_pages(dst.v_pool, dst_ids, vw)
                    if fault is not None and fault.kind == "chunk_dup":
                        # duplicate delivery: the copy is idempotent, so
                        # a replayed chunk must verify clean
                        paged_cache.write_pages(dst.k_pool, dst_ids, kw)
                        paged_cache.write_pages(dst.v_pool, dst_ids, vw)
                # decode-side verification: recompute from the pool the
                # decode step will actually read
                got = page_checksums(
                    paged_cache.read_pages(dst.k_pool, dst_ids),
                    paged_cache.read_pages(dst.v_pool, dst_ids))
                if got == want:
                    break
                engine.stats.note_crc_mismatch()
                engine.stats.note_retry()
                retry.sleep(attempt)
            else:
                raise TransportError(
                    f"slot {task.slot} pages {lo}:{hi} layer {li}: page "
                    f"CRC mismatch persisted through "
                    f"{retry.max_attempts} fetch attempts")
        task.streamed = hi
