"""The port's paged cache and paged decode against the JAX package:
``paged_decode`` (its plain version on the CPU) against
``paged_decode_reference`` within 1e-6, the device cache writes
bit-identical, and the host ``PagePool`` with the same bookkeeping under a
fixed sequence of allocate / extend / evict / free."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels import paged_cache as jpc  # noqa: E402
from repro.kernels.paged_attention import paged_decode_reference  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.kernels.paged_attention import (paged_decode,  # noqa: E402
                                                 paged_hbm_bytes)

FMTS = ["binary8", "binary16", "binary16alt", "binary32", None]


def _pool_case(fmt, seed=0, B=4, H=2, G=4, dh=32, page=8, num_pages=12,
               pps=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, G, dh)).astype(np.float32)
    kf = rng.normal(size=(num_pages, page, H, dh)).astype(np.float32)
    vf = rng.normal(size=(num_pages, page, H, dh)).astype(np.float32)
    if fmt is None:
        kp, vp = kf, vf
    else:
        kp = np.asarray(jqt.encode(jnp.asarray(kf), fmt))
        vp = np.asarray(jqt.encode(jnp.asarray(vf), fmt))
    perm = rng.permutation(num_pages)
    tables = np.full((B, pps), -1, np.int32)
    tables[1, :1] = perm[:1]
    tables[2, :3] = perm[1:4]
    tables[3, :4] = perm[4:8]
    tables[2, 1] = -1                       # a hole inside the length
    lengths = np.array([0, 5, 20, 99], np.int32)   # 99 > capacity 32
    return q, kp, vp, lengths, tables


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f or "f32")
def test_paged_decode_matches_jax_reference(fmt):
    q, kp, vp, lengths, tables = _pool_case(fmt, seed=3)
    want, wm, wl = paged_decode_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), fmt,
        jnp.asarray(np.minimum(lengths, tables.shape[1] * kp.shape[1])),
        jnp.asarray(tables), return_residuals=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got, gm, gl = paged_decode(t(q), t(kp), t(vp), fmt, t(lengths),
                               t(tables), return_residuals=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)
    assert (got[0] == 0).all()              # zero length -> zero output


def _np(x):
    """Any pool (JAX or torch, float8 included) -> its raw bits."""
    if isinstance(x, torch.Tensor):
        w = x.element_size()
        return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[w]
                      ).numpy().view(f"u{w}")
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("dtypes", [(jnp.float8_e5m2, torch.float8_e5m2),
                                    (jnp.float32, torch.float32)],
                         ids=["e5m2", "f32"])
def test_cache_writes_bit_identical(dtypes):
    """write_chunk (ragged chunks straddling pages, an unmapped tail) and
    append_decode (an unmapped slot, a slot at capacity) leave the same
    pool bits and lengths as the reference."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(1)
    n_slots, num_pages, page, pps, H, dh = 3, 7, 8, 3, 2, 16
    jpool = jpc.PagePool(num_pages, page, n_slots, pps)
    assert jpool.allocate(0, 13) and jpool.allocate(2, 24)
    jc = jpc.set_block_tables(jpc.init_paged_cache(
        n_slots, num_pages, page, pps, H, dh, jdt), jpool.tables)
    tc = tpc.set_block_tables(tpc.init_paged_cache(
        n_slots, num_pages, page, pps, H, dh, tdt), jpool.tables)
    chunk = rng.normal(size=(20, H, dh)).astype(np.float32)   # 20 > 16 mapped
    for off, c in ((0, 5), (5, 7), (12, 8)):
        jc = jpc.write_chunk(jc, 0, jnp.asarray(chunk[off:off + c]),
                             jnp.asarray(chunk[off:off + c]), off)
        tc = tpc.write_chunk(tc, 0, torch.from_numpy(chunk[off:off + c]),
                             torch.from_numpy(chunk[off:off + c]), off)
    jc = jc._replace(seq_lens=jnp.asarray([13, 0, 24], jnp.int32))
    tc = tc._replace(seq_lens=torch.tensor([13, 0, 24], dtype=torch.int32))
    tok = rng.normal(size=(n_slots, 1, H, dh)).astype(np.float32)
    jc = jpc.append_decode(jc, jnp.asarray(tok), jnp.asarray(tok))
    tc = tpc.append_decode(tc, torch.from_numpy(tok), torch.from_numpy(tok))
    np.testing.assert_array_equal(_np(tc.k_pool), _np(jc.k_pool))
    np.testing.assert_array_equal(_np(tc.v_pool), _np(jc.v_pool))
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))
    g_t = tpc.gather_pages(tc.k_pool, tc.block_tables)
    g_j = jpc.gather_pages(jc.k_pool, jc.block_tables)
    np.testing.assert_array_equal(_np(g_t), _np(g_j))
    jc, tc = jpc.release_slot(jc, 0), tpc.release_slot(tc, 0)
    np.testing.assert_array_equal(tc.block_tables.numpy(),
                                  np.asarray(jc.block_tables))
    with pytest.raises(tpc.PoolError):
        tpc.release_slot(tc, 5)


def test_paged_view_of_contiguous_matches_reference():
    rng = np.random.default_rng(4)
    ck = rng.normal(size=(2, 20, 2, 8)).astype(np.float32)
    jk, jv, jt = jpc.paged_view_of_contiguous(jnp.asarray(ck),
                                              jnp.asarray(ck), 8)
    tk, tv, tt = tpc.paged_view_of_contiguous(torch.from_numpy(ck),
                                              torch.from_numpy(ck), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _pool_state(p):
    return (list(p.free), {k: list(v) for k, v in p.owned.items()},
            p.tables.tolist(), p.lens.tolist(), p.stats(),
            list(p.quarantined))


def test_page_pool_bookkeeping_matches_reference():
    ops = [("allocate", 0, 17), ("allocate", 1, 9), ("allocate", 2, 9),
           ("ensure_capacity", 1, 16), ("ensure_capacity", 1, 17),
           ("ensure_capacity", 1, 25), ("note_decode_step", 1),
           ("free_slot", 0), ("allocate", 2, 24), ("truncate", 2, 9),
           ("allocate", 0, 8), ("quarantine_slot", 1), ("free_slot", 2),
           ("allocate", 1, 3), ("free_slot", 0), ("free_slot", 1)]
    jp = jpc.PagePool(num_pages=6, page_size=8, n_slots=3, pages_per_seq=3)
    tp = tpc.PagePool(num_pages=6, page_size=8, n_slots=3, pages_per_seq=3)
    for op, *args in ops:
        assert getattr(tp, op)(*args) == getattr(jp, op)(*args), (op, args)
        assert _pool_state(tp) == _pool_state(jp), (op, args)
        assert tp.can_admit(9) == jp.can_admit(9)
        assert tp.internal_fragmentation() == jp.internal_fragmentation()
    for pool, err in ((jp, jpc.PoolError), (tp, tpc.PoolError)):
        with pytest.raises(err):
            pool.free_slot(1)               # double free
        with pytest.raises(err):
            pool.allocate(7, 1)             # no such slot


def test_paged_hbm_bytes_counts_whole_live_pages():
    # 2 sequences of 5 + 20 tokens over 1 + 3 live pages of 8 tokens: e5m2
    # K and V for the live tokens only (the last page's dead rows are not
    # read), the 4 live table entries, 2 lengths, q in and out
    assert paged_hbm_bytes([5, 20], 2, 16, "binary8", page_size=8, g=4) == (
        2 * 25 * 2 * 16 * 1 + 4 * 4 + 2 * 4 + 2 * 2 * 2 * 4 * 16 * 4)
