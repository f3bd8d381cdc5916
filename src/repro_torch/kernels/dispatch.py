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

wrapper spellings (decode only; prefill resolves to the base)::

    "flash_shmap[+base]"  the cache's storage axis sharded over the
                          ambient mesh's ``model`` dim (the sequence axis
                          of a contiguous cache, the page axis of the
                          ``paged`` pool); each rank attends over its
                          shard through the base and the normalized
                          partials (o, m, l) are gathered over the
                          ``model`` group and merged.
    "ring[+base]"         the same shards, rotated one neighbour a step
                          (``batch_isend_irecv``) and folded into a
                          running (acc, m, l) state; no gather.

A bare wrapper means ``wrapper+xla``.  Without an ambient mesh
(``core/ambient_mesh.use_mesh``, re-exported by ``launch/mesh.py``),
without a ``model`` dim, with a storage axis the model size does not
divide, or when the caller asks for the residuals, a wrapper runs its
base unsharded, as the reference's do.

Contracts are the reference's (see ``repro.kernels.dispatch``); the
backends register themselves from ``models/attention.py`` and
``models/layers.py`` at import.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import ambient_mesh as mesh_mod
from repro_torch.core import collectives as coll

from ._route import meta_empty, record_collective

BASE_IMPLS = ("xla", "flash_pallas", "paged")
WRAPPER_IMPLS = ("flash_shmap", "ring")
DEFAULT_INNER = "xla"  # a bare wrapper spelling means wrapper+xla
MATMUL_IMPLS = ("xla", "qmm_pallas")

_DECODE: dict = {}
_PREFILL: dict = {}
_WRAPPERS: dict = {}
_MATMUL: dict = {}
# resolved callables by (kind, spelling): the model asks once per layer
# per step; a registration empties it
_RESOLVED: dict = {}


def legal_impls() -> tuple:
    """Every accepted ``decode_impl`` spelling, in the reference's
    order."""
    composed = tuple(f"{w}+{b}" for w in WRAPPER_IMPLS for b in BASE_IMPLS)
    return BASE_IMPLS + WRAPPER_IMPLS + composed


def canonicalize_impl(spec: str) -> tuple:
    """``"flash_shmap"`` -> ``("flash_shmap", "xla")``; base -> ``(base,)``."""
    parts = tuple(p.strip() for p in str(spec).split("+"))
    if len(parts) == 1 and parts[0] in WRAPPER_IMPLS:
        parts = (parts[0], DEFAULT_INNER)
    return parts


_LEGAL = frozenset(canonicalize_impl(s) for s in legal_impls())


def validate_impl(spec: Optional[str], *, allow_none: bool = True,
                  what: str = "decode_impl") -> Optional[str]:
    """Check a spelling against the legal set (one wrapper over one base
    at most); returns ``spec`` so callers can validate in-line."""
    if spec is None:
        if allow_none:
            return None
        raise ValueError(f"{what} must be set; legal values: {legal_impls()}")
    if canonicalize_impl(spec) not in _LEGAL:
        raise ValueError(
            f"unknown {what} {spec!r}; legal spellings are "
            f"{list(legal_impls())} (one wrapper composes with one base, "
            f"e.g. 'flash_shmap+flash_pallas' = sequence-sharded fused "
            f"kernel, 'ring+paged' = page pool rotated around the mesh "
            f"ring)")
    return spec


def default_serving_impl(device=None) -> Optional[str]:
    """Serving default when no ``--decode-impl`` is given: on a card
    ``flash_pallas`` (the fused packed-KV flash decode kernel), composed
    with ``flash_shmap`` when the ambient mesh has a ``model`` dim, as
    the reference returns them on its accelerator; ``None`` (the model
    config's default) on the CPU, where the plain path is the honest
    baseline."""
    if device is None or torch.device(device).type != "cuda":
        return None
    mesh = mesh_mod.get_ambient_mesh()
    if mesh is not None and "model" in mesh_mod.axis_names(mesh):
        return "flash_shmap+flash_pallas"
    return "flash_pallas"


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
        _RESOLVED.clear()
        return fn
    return deco


def register_prefill(name: str) -> Callable:
    assert name in BASE_IMPLS, name

    def deco(fn):
        _PREFILL[name] = fn
        _RESOLVED.clear()
        return fn
    return deco


def register_wrapper(name: str) -> Callable:
    assert name in WRAPPER_IMPLS, name

    def deco(factory):
        _WRAPPERS[name] = factory
        _RESOLVED.clear()
        return factory
    return deco


def resolve_decode(spec: str) -> Callable:
    """Spelling -> decode callable, the wrapper applied over its base
    (the factory is told the base's name: a wrapper shards the sequence
    axis of a contiguous cache and the page axis of the ``paged`` pool).
    Composed once per spelling; the wrapper reads the ambient mesh at
    every call."""
    fn = _RESOLVED.get(("decode", spec))
    if fn is None:
        parts = canonicalize_impl(validate_impl(spec, allow_none=False))
        fn = _DECODE[parts[-1]]
        for w in reversed(parts[:-1]):
            fn = _WRAPPERS[w](fn, base=parts[-1])
        _RESOLVED[("decode", spec)] = fn
    return fn


def resolve_prefill(spec: str) -> Callable:
    """Spelling -> prefill callable (the base of the composition)."""
    fn = _RESOLVED.get(("prefill", spec))
    if fn is None:
        parts = canonicalize_impl(validate_impl(spec, allow_none=False))
        fn = _RESOLVED[("prefill", spec)] = _PREFILL[parts[-1]]
    return fn


# ---------------------------------------------------------------------------
# the mesh wrappers.  Every rank is handed the whole operands (as
# shard_map is handed a global array), narrows them to its own rows of the
# batch and its own shard of the storage axis, and ends with the whole
# normalized (B, H, G, dh) output.  flash_shmap and ring share their gating
# (one factory) and differ in the sharded decode they call.
# ---------------------------------------------------------------------------

def _usable(mesh, storage: int, return_residuals: bool) -> bool:
    """The reference's fallback conditions: shard only under a mesh with
    a ``model`` dim that divides the storage axis, and never when the
    caller wants the residuals (a nested wrapper)."""
    return (not return_residuals and mesh is not None
            and "model" in mesh_mod.axis_names(mesh)
            and storage % mesh_mod.model_axis_size(mesh) == 0)


def _sharded_wrapper_factory(sharded: Callable, sharded_paged: Callable
                             ) -> Callable:
    """A wrapper factory around a (contiguous, paged) pair of sharded
    decodes; both registered wrappers come from here."""

    def factory(inner: Callable, base: str = DEFAULT_INNER) -> Callable:
        if base == "paged":
            def wrapped(q, ck, cv, n_valid, *, scale, policy, block_tables,
                        return_residuals: bool = False):
                # ck/cv are the page pools: shard their page axis (0)
                mesh = mesh_mod.get_ambient_mesh()
                if not _usable(mesh, ck.shape[0], return_residuals):
                    return inner(q, ck, cv, n_valid, scale=scale,
                                 policy=policy, block_tables=block_tables,
                                 return_residuals=return_residuals)
                return sharded_paged(inner, mesh, q, ck, cv, n_valid,
                                     block_tables, scale=scale,
                                     policy=policy)
            return wrapped

        def wrapped(q, ck, cv, n_valid, *, scale, policy,
                    return_residuals: bool = False):
            mesh = mesh_mod.get_ambient_mesh()
            if not _usable(mesh, ck.shape[1], return_residuals):
                # no mesh, an indivisible cache or a nested wrapper: the
                # inner backend unsharded
                return inner(q, ck, cv, n_valid, scale=scale, policy=policy,
                             return_residuals=return_residuals)
            return sharded(inner, mesh, q, ck, cv, n_valid, scale=scale,
                           policy=policy)

        return wrapped

    return factory


def _batch_pspec(mesh, batch: int):
    """The batch axis's partition, as the reference's: the mesh's data
    dims when they divide the batch, else None (replicated).  Inside
    ``use_mesh(mesh, batch_split=...)`` the rank's operands hold only its
    own rows already: None (no narrowing, no gather)."""
    if mesh_mod.batch_split_axes():
        return None
    dp = mesh_mod.dp_axes(mesh)
    return dp if batch % max(mesh_mod.dp_size(mesh), 1) == 0 else None


def _batch_rows(mesh, batch: int) -> slice:
    """This rank's rows of the batch: block ``d`` of ``dp_size`` blocks,
    ``d`` the rank's row-major coordinate over the data dims (pod, data),
    or every row when ``_batch_pspec`` replicates the batch."""
    if _batch_pspec(mesh, batch) is None:
        return slice(0, batch)
    d = coll.axes_index(mesh, mesh_mod.dp_axes(mesh))
    per = batch // mesh_mod.dp_size(mesh)
    return slice(d * per, (d + 1) * per)


def _gather_batch(mesh, out: torch.Tensor, batch: int) -> torch.Tensor:
    """This rank's rows -> the whole batch: gathered over the data dims
    in ``_batch_rows`` order (a dim of size 1 holds the rows already and
    issues no collective)."""
    if _batch_pspec(mesh, batch) is None:
        return out
    return coll.all_gather_cat(out, mesh, mesh_mod.dp_axes(mesh))


def _all_gather(mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` of every rank of the ``axis`` group, stacked in rank order
    on a new leading axis (the same tensor on every rank); one name for
    the merge's collective, which the card's mesh phase counts."""
    return coll.all_gather_cat(t[None], mesh, axis)


def _merge_partials(o, m, l):
    """Exact merge of the ranks' normalized flash partials, stacked in
    rank order on axis 0 (``_all_gather`` over the ``model`` group): with
    w_i = exp(m_i - max_j m_j) * l_i the softmax output is
    sum_i w_i o_i / sum_i w_i, summed in rank order, so every rank gets
    the same bits.  An empty shard (0, NEG_INF, 0) has w_i = 0.  The
    reference's ``_merge_partials`` computes the same under ``pmax`` /
    ``psum``."""
    o = o.to(torch.float32)
    gm = torch.amax(m, dim=0)
    w = torch.exp(m - gm) * l
    num = w[0][..., None] * o[0]
    den = w[0]
    for i in range(1, o.shape[0]):
        num = num + w[i][..., None] * o[i]
        den = den + w[i]
    # explicit zero guard (a subnormal epsilon would be flushed to zero)
    den = torch.where(den > 0, den, torch.ones((), device=den.device))
    return num / den[..., None]


def _merge_over_model(mesh, o, m, l):
    """The ``model`` group's partials, gathered in one collective (o, m
    and l side by side on the last axis), merged."""
    dh = o.shape[-1]
    parts = _all_gather(mesh, "model", torch.cat(
        (o.to(torch.float32), m[..., None], l[..., None]), dim=-1))
    return _merge_partials(parts[..., :dh], parts[..., dh],
                           parts[..., dh + 1])


def _local_table(tbl, first: int, p_loc: int):
    """A block table rewritten to the pool-local ids of pages
    [first, first + p_loc); every other entry -1 (masked)."""
    owned = (tbl >= first) & (tbl < first + p_loc)
    return torch.where(owned, tbl - first, torch.full_like(tbl, -1))


def _shmap_decode(inner, mesh, q, ck, cv, n_valid, *, scale, policy):
    """The sharded branch of flash_shmap over a contiguous cache (module
    level, so a test can see it taken): rank ``i`` of the ``model`` group
    attends over cache slots [i*s_loc, (i+1)*s_loc) with its local valid
    count, then the partials are merged."""
    n_model = mesh_mod.model_axis_size(mesh)
    s_loc = ck.shape[1] // n_model
    i = mesh.get_local_rank("model")
    rows = _batch_rows(mesh, q.shape[0])
    sl = slice(i * s_loc, (i + 1) * s_loc)
    local_n = torch.clamp(n_valid[rows] - i * s_loc, 0, s_loc)
    o, m, l = inner(q[rows], ck[rows, sl].contiguous(),
                    cv[rows, sl].contiguous(), local_n,
                    scale=scale, policy=policy, return_residuals=True)
    return _gather_batch(mesh, _merge_over_model(mesh, o, m, l), q.shape[0])


def _shmap_decode_paged(inner, mesh, q, ck, cv, n_valid, block_tables, *,
                        scale, policy):
    """Pool-sharded paged decode: rank ``i`` holds physical pages
    [i*p_loc, (i+1)*p_loc) and reads them through the table rewritten to
    pool-local ids (every other entry -1).  Every token lives on one
    rank, so the partials merge as in the contiguous case."""
    n_model = mesh_mod.model_axis_size(mesh)
    p_loc = ck.shape[0] // n_model
    first = mesh.get_local_rank("model") * p_loc
    rows = _batch_rows(mesh, q.shape[0])
    o, m, l = inner(q[rows], ck[first:first + p_loc],
                    cv[first:first + p_loc], n_valid[rows], scale=scale,
                    policy=policy,
                    block_tables=_local_table(block_tables[rows], first,
                                              p_loc),
                    return_residuals=True)
    return _gather_batch(mesh, _merge_over_model(mesh, o, m, l), q.shape[0])


# ---------------------------------------------------------------------------
# the ring: each rank starts with its own shard, folds it, passes it to
# the next rank of the model group and takes the previous rank's; after
# n_model folds every rank has folded every shard once
# ---------------------------------------------------------------------------

def _ring_fold(acc, m_run, l_run, o, m, l):
    """Fold one shard's normalized partials (o, m, l) into the running
    (acc, m, l) online-softmax state: ``o * l`` is the shard's
    unnormalized weighted-V sum; rescale both sides to the new running
    max and add.  Associative and commutative up to f32 rounding, so any
    rotation order gives the same softmax.  An empty shard
    (0, NEG_INF, 0) folds to an exact no-op."""
    m_new = torch.maximum(m_run, m)
    a_run = torch.exp(m_run - m_new)
    a_in = torch.exp(m - m_new)
    acc = acc * a_run[..., None] + o.to(torch.float32) * (l * a_in)[..., None]
    return acc, m_new, l_run * a_run + l * a_in


def _ring_finalize(acc, l_run):
    """(acc, l) -> normalized output, with an explicit zero guard."""
    pos = l_run > 0
    den = torch.where(pos, l_run, torch.ones((), device=l_run.device))
    return torch.where(pos[..., None], acc / den[..., None],
                       torch.zeros((), device=acc.device))


def _ring_state(q_b):
    """Fresh (acc, m, l) for ``q_b``'s queries: the running max starts
    at the backends' own empty-shard sentinel (``NEG_INF``), so an empty
    shard folds to an exact no-op."""
    from .flash_attention import NEG_INF
    shape = q_b.shape[:-1]
    return (torch.zeros(q_b.shape, dtype=torch.float32, device=q_b.device),
            torch.full(shape, NEG_INF, dtype=torch.float32,
                       device=q_b.device),
            torch.zeros(shape, dtype=torch.float32, device=q_b.device))


def _ring_pass(mesh, *shards):
    """Send each shard to the next rank of the ``model`` group and take
    the previous rank's (``batch_isend_irecv``, neighbours only).  The
    payload travels as bytes, since the collectives take no float8 or
    16-bit integer dtype."""
    import torch.distributed as dist

    if isinstance(mesh, mesh_mod.MeshShape):
        # a mesh without ranks: the shape route (kernels/_route.py)
        return [record_collective("collective-permute",
                                  meta_empty(t.shape, t.dtype))
                for t in shards]
    group = mesh.get_group("model")
    n, i = mesh_mod.model_axis_size(mesh), mesh.get_local_rank("model")
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    ops, outs = [], []
    for t in shards:
        src = t.contiguous().view(torch.uint8)
        dst = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, nxt, group),
                dist.P2POp(dist.irecv, dst, prv, group)]
        outs.append(dst.view(t.dtype))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _ring_decode(inner, mesh, q, ck, cv, n_valid, *, scale, policy):
    """Ring-rotated decode over a contiguous cache's sequence axis: at
    step ``s`` rank ``i`` holds the shard of rank ``(i - s) % n``, attends
    over it with that owner's local valid count and folds the partials;
    the last shard is not passed on."""
    n_model = mesh_mod.model_axis_size(mesh)
    s_loc = ck.shape[1] // n_model
    i = mesh.get_local_rank("model")
    rows = _batch_rows(mesh, q.shape[0])
    q_b, nv_b = q[rows], n_valid[rows]
    k_cur = ck[rows, i * s_loc:(i + 1) * s_loc].contiguous()
    v_cur = cv[rows, i * s_loc:(i + 1) * s_loc].contiguous()
    acc, m_run, l_run = _ring_state(q_b)
    for step in range(n_model):
        owner = (i - step) % n_model
        local_n = torch.clamp(nv_b - owner * s_loc, 0, s_loc)
        o, m, l = inner(q_b, k_cur, v_cur, local_n, scale=scale,
                        policy=policy, return_residuals=True)
        acc, m_run, l_run = _ring_fold(acc, m_run, l_run, o, m, l)
        if step != n_model - 1:
            k_cur, v_cur = _ring_pass(mesh, k_cur, v_cur)
    return _gather_batch(mesh, _ring_finalize(acc, l_run), q.shape[0])


def _ring_decode_paged(inner, mesh, q, ck, cv, n_valid, block_tables, *,
                       scale, policy):
    """Ring-rotated paged decode: the pool shards rotate, the block table
    stays, and at every step it is rewritten to the rotating owner's
    pool-local page ids."""
    n_model = mesh_mod.model_axis_size(mesh)
    p_loc = ck.shape[0] // n_model
    i = mesh.get_local_rank("model")
    rows = _batch_rows(mesh, q.shape[0])
    q_b, nv_b, tbl_b = q[rows], n_valid[rows], block_tables[rows]
    k_cur = ck[i * p_loc:(i + 1) * p_loc]
    v_cur = cv[i * p_loc:(i + 1) * p_loc]
    acc, m_run, l_run = _ring_state(q_b)
    for step in range(n_model):
        owner = (i - step) % n_model
        o, m, l = inner(q_b, k_cur, v_cur, nv_b, scale=scale, policy=policy,
                        block_tables=_local_table(tbl_b, owner * p_loc,
                                                  p_loc),
                        return_residuals=True)
        acc, m_run, l_run = _ring_fold(acc, m_run, l_run, o, m, l)
        if step != n_model - 1:
            k_cur, v_cur = _ring_pass(mesh, k_cur, v_cur)
    return _gather_batch(mesh, _ring_finalize(acc, l_run), q.shape[0])


# the lambdas keep the module globals late-bound, so a test can replace a
# sharded branch with a spy, as tests/test_perf_variants.py does for the
# reference's
register_wrapper("flash_shmap")(_sharded_wrapper_factory(
    lambda *a, **k: _shmap_decode(*a, **k),
    lambda *a, **k: _shmap_decode_paged(*a, **k)))
register_wrapper("ring")(_sharded_wrapper_factory(
    lambda *a, **k: _ring_decode(*a, **k),
    lambda *a, **k: _ring_decode_paged(*a, **k)))
