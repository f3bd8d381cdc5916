"""The CUDA paged_decode kernel's walk in PyTorch,
``paged_decode_split_plain`` (pieces of whole pages merged in piece
order), against the JAX package: the XLA oracle ``paged_decode_reference``
at head_dim 16, 128 and 256, G 1, 2 and 10, pages of 16 and 64 and every
KV format, and the Pallas kernel in interpret mode.  The twin is held
within 1e-6 absolute on the output and 1e-6 relative on the residuals
(m, l) to the reference's formula evaluated in f64 on the same decoded
operands (``_exact``), and to the JAX f32 functions themselves within 1e-6
relative on m, 2e-6 absolute on the output and 1e-5 relative on l: at
head_dim 128 and 256 those functions' own f32 results lie farther than
1e-6 (output) and 1e-6 relative (l) from the exact values in some cases,
while the twin walks in f64.  Also the piece count as a
function of a row's own length, a row's bits whatever B and table width
surround it, and the shared-memory model of the kernel."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

FMTS = ["binary8", "binary8alt", "binary16", "binary16alt", "binary32",
        "flexfloat<6,9>", None]


def _case(fmt, *, G, dh, page, B=4, H=2, pps=None, seed=0, lengths=None):
    """Ragged rows over a scattered pool: a zero-length unmapped row, a
    short one, one with a hole inside its length and one above the
    capacity of pps * page (clamped)."""
    rng = np.random.default_rng(seed)
    pps = pps or max(2, 160 // page)
    num_pages = B * pps
    q = rng.normal(size=(B, H, G, dh)).astype(np.float32)
    kf = rng.normal(size=(num_pages, page, H, dh)).astype(np.float32)
    vf = rng.normal(size=(num_pages, page, H, dh)).astype(np.float32)
    if fmt is None:
        kp, vp = kf, vf
    else:
        kp = np.asarray(jqt.encode(jnp.asarray(kf), fmt))
        vp = np.asarray(jqt.encode(jnp.asarray(vf), fmt))
    cap = pps * page
    if lengths is None:
        lengths = [0, page + 5, cap - 3, cap + 40][:B]
    lengths = np.asarray(lengths, np.int32)
    tables = np.full((B, pps), -1, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for b in range(B):
        n = min(-(-int(lengths[b]) // page), pps)
        tables[b, :n] = perm[used:used + n]
        used += n
    if B > 2 and pps > 2:
        tables[2, 1] = -1                     # a hole inside the length
    return q, kp, vp, lengths, tables


def _t(a):
    return torch.from_numpy(np.array(a))


def _exact(q, kp, vp, fmt, lengths, tables):
    """``paged_decode_reference``'s formula (length AND mapped-page mask,
    max, exp, P @ V / sum) in f64 on the decoded operands: (o, m, l)."""
    page = kp.shape[1]

    def gathered(pool):
        x = np.asarray(jqt.decode(jnp.asarray(pool), fmt)) if fmt else pool
        x = x[np.maximum(tables, 0)]
        return x.reshape(q.shape[0], -1, *x.shape[3:]).astype(np.float64)

    k, v = gathered(kp), gathered(vp)
    s = np.einsum("bhgd,bshd->bhgs", q.astype(np.float64), k) \
        * float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    cap = tables.shape[1] * page
    valid = (np.arange(s.shape[-1])[None, :]
             < np.minimum(lengths, cap)[:, None]) \
        & np.repeat(tables >= 0, page, axis=1)
    s = np.where(valid[:, None, None], s, -1e30)
    m = s.max(axis=-1)
    p = np.where(valid[:, None, None], np.exp(s - m[..., None]), 0.0)
    l = p.sum(axis=-1)
    o = np.einsum("bhgs,bshd->bhgd", p, v)
    o = np.where(l[..., None] > 0, o / np.where(l > 0, l, 1.0)[..., None],
                 0.0)
    return o, m, l


def _check(got, want, exact):
    (o, m, l), (wo, wm, wl), (eo, em, el) = got, want, exact
    np.testing.assert_allclose(o.numpy(), eo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), em, rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), el, rtol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(wo), rtol=0, atol=2e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(wl), rtol=1e-5)


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("G,dh", [(1, 16), (2, 16), (10, 16), (1, 128),
                                  (2, 128), (10, 128), (1, 256), (2, 256),
                                  (10, 256)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f or "f32")
def test_split_twin_matches_xla_reference(fmt, G, dh, page):
    q, kp, vp, lengths, tables = _case(fmt, G=G, dh=dh, page=page,
                                       seed=G + dh + page)
    cap = tables.shape[1] * page
    want = jpa.paged_decode_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), fmt,
        jnp.asarray(np.minimum(lengths, cap)), jnp.asarray(tables),
        return_residuals=True)
    got = tpa.paged_decode_split_plain(_t(q), _t(kp), _t(vp), fmt,
                                       _t(lengths), _t(tables),
                                       return_residuals=True)
    _check(got, want, _exact(q, kp, vp, fmt, lengths, tables))
    assert (got[0][0] == 0).all() and (got[2][0] == 0).all()
    assert (got[1][0] == tpa.NEG_INF).all()


@pytest.mark.parametrize("fmt,G,dh,page", [("binary8", 2, 16, 16),
                                           ("binary16alt", 10, 256, 16),
                                           (None, 1, 128, 64)],
                         ids=["binary8-G2-dh16-p16", "binary16alt-G10-dh256",
                              "f32-G1-dh128-p64"])
def test_split_twin_matches_pallas_interpret(fmt, G, dh, page):
    q, kp, vp, lengths, tables = _case(fmt, G=G, dh=dh, page=page, B=3,
                                       pps=4, seed=11)
    want = jpa.paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            fmt, jnp.asarray(lengths), jnp.asarray(tables),
                            return_residuals=True, interpret=True)
    got = tpa.paged_decode_split_plain(_t(q), _t(kp), _t(vp), fmt,
                                       _t(lengths), _t(tables),
                                       return_residuals=True)
    _check(got, want, _exact(q, kp, vp, fmt, lengths, tables))


@pytest.mark.parametrize("page", [8, 16, 24, 64, 128])
def test_piece_count_is_a_function_of_the_row_length(page):
    """ceil(min(len, n_pages * page) / piece), piece = max(1, 64 // page)
    pages, whatever the other rows hold."""
    n_pages = 12
    plen = tpa.piece_pages(page) * page
    assert plen == {8: 64, 16: 64, 24: 48, 64: 64, 128: 128}[page]
    lengths = [0, 1, plen - 1, plen, plen + 1, 3 * plen, n_pages * page,
               n_pages * page + 9]
    want = [-(-min(n, n_pages * page) // plen) for n in lengths]
    assert tpa.paged_pieces(torch.tensor(lengths), page,
                            n_pages).tolist() == want
    for n, w in zip(lengths, want):
        assert tpa.paged_pieces(torch.tensor([n]), page, n_pages).item() == w


@pytest.mark.parametrize("fmt", ["binary8", None], ids=lambda f: f or "f32")
def test_row_bits_do_not_depend_on_batch_or_table_width(fmt):
    """Each row of the twin computed alone, beside rows of other lengths,
    and through a table widened with unmapped columns, equals its row in
    the batch bit for bit."""
    q, kp, vp, lengths, tables = _case(fmt, G=4, dh=16, page=16, seed=5,
                                       lengths=[1, 64, 100, 150])
    full = tpa.paged_decode_split_plain(_t(q), _t(kp), _t(vp), fmt,
                                        _t(lengths), _t(tables))
    wide = np.concatenate([tables, np.full_like(tables, -1)], axis=1)
    for b in range(4):
        alone = tpa.paged_decode_split_plain(
            _t(q[b:b + 1]), _t(kp), _t(vp), fmt, _t(lengths[b:b + 1]),
            _t(tables[b:b + 1]))
        other = lengths.copy()
        other[[i for i in range(4) if i != b]] = [0, 150, 17]
        beside = tpa.paged_decode_split_plain(_t(q), _t(kp), _t(vp), fmt,
                                              _t(other), _t(wide))
        assert torch.equal(alone[0], full[b])
        assert torch.equal(beside[b], full[b])


def test_kernel_shared_memory_fits_every_page_in_use():
    """The piece block's shared memory (``piece_smem_bytes``) fits the
    card's 227 KB at pages 8-64 for every head_dim and G the kernel
    takes and every container width; page 128 fits up to u16 at head_dim
    256; the wrapper raises beyond that."""
    for page in (8, 16, 32, 64):
        for item in (1, 2, 4):
            for dh in range(8, 257, 8):
                assert tpa.piece_smem_bytes(page, dh, item, 16) \
                    <= tpa.SMEM_LIMIT
    assert tpa.piece_smem_bytes(128, 256, 2, 16) <= tpa.SMEM_LIMIT
    assert tpa.piece_smem_bytes(128, 256, 4, 16) > tpa.SMEM_LIMIT
    # the serve shape: 64 positions of 128 B rows of K and V, q, scores
    assert tpa.piece_smem_bytes(64, 128, 1, 4) == (
        2 * 64 * 128 + 4 * (4 * 128 + 4 * 64 + 2 * 4))
