"""The port's flash_decode (its plain version on the CPU) against the JAX
package: the XLA oracle ``flash_decode_reference`` and the Pallas kernel
in interpret mode, within 1e-6 absolute (the reference's own contract,
``tests/test_conformance.py``), over packed and float caches, residuals,
zero-length rows, lengths above S, and an S that is not a multiple of the
reference's KV tile.  Also the ``flash_pallas`` decode spelling through
the registry and the paged gather bridge, and the byte model."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

FMTS = ["binary8", "binary16", "binary16alt", "binary32", None]


def _case(fmt, B=4, S=40, H=2, G=4, dh=16, seed=0,
          lengths=(0, 5, 40, 97)):
    """lengths: a zero-length row, a short one, a full one and one above
    S (clamped to S)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, G, dh)).astype(np.float32)
    kf = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    vf = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    if fmt is None:
        kp, vp = kf, vf
    else:
        kp = np.asarray(jqt.encode(jnp.asarray(kf), fmt))
        vp = np.asarray(jqt.encode(jnp.asarray(vf), fmt))
    return q, kp, vp, np.asarray(lengths, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f or "f32")
def test_flash_decode_matches_xla_reference(fmt):
    q, kp, vp, lengths = _case(fmt, seed=1)
    want, wm, wl = jfa.flash_decode_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), fmt,
        jnp.asarray(np.minimum(lengths, kp.shape[1])),
        return_residuals=True)
    got, gm, gl = tfa.flash_decode(_t(q), _t(kp), _t(vp), fmt, _t(lengths),
                                   return_residuals=True)
    assert got.shape == q.shape and gm.shape == q.shape[:3]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)
    assert (got[0] == 0).all() and (gl[0] == 0).all()


@pytest.mark.parametrize("fmt,S", [("binary8", 40), ("binary16alt", 24),
                                   (None, 33)],
                         ids=["binary8-S40", "binary16alt-S24", "f32-S33"])
def test_flash_decode_matches_pallas_interpret(fmt, S):
    """The Pallas kernel itself, several KV tiles (block_kv 16, so S = 33
    and 40 leave a ragged last tile) and residuals."""
    q, kp, vp, lengths = _case(fmt, S=S, seed=2, lengths=(0, 7, S, S + 9))
    want, wm, wl = jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), fmt,
        jnp.asarray(lengths), block_kv=16, return_residuals=True,
        interpret=True)
    got, gm, gl = tfa.flash_decode(_t(q), _t(kp), _t(vp), fmt, _t(lengths),
                                   return_residuals=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5)


def test_flash_pallas_spelling_serves_the_paged_bridge():
    """``flash_pallas`` resolves for decode, and through the gather bridge
    it agrees with the block-table ``paged`` backend on one paged state
    with invalid (unmapped) slots: both mask the same positions."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import paged_cache as tpc
    from repro_torch.models import attention  # noqa: F401 (registers)

    pol = get_policy("transprecision")
    rng = np.random.default_rng(4)
    B, H, G, dh, page, pps, num_pages = 3, 2, 4, 16, 8, 4, 12
    pool_k = torch.tensor(rng.normal(size=(num_pages, page, H, dh)),
                          dtype=torch.float32).to(torch.float8_e5m2)
    pool_v = torch.tensor(rng.normal(size=(num_pages, page, H, dh)),
                          dtype=torch.float32).to(torch.float8_e5m2)
    tables = torch.tensor([[3, 7, -1, -1], [-1, -1, -1, -1],
                           [0, 1, 2, 5]], dtype=torch.int32)
    lens = torch.tensor([13, 0, 29], dtype=torch.int32)
    q = torch.tensor(rng.normal(size=(B, H, G, dh)), dtype=torch.float32)
    scale = float(1.0 / np.sqrt(dh))
    paged = dispatch.resolve_decode("paged")(
        q, pool_k, pool_v, lens, scale=scale, policy=pol,
        block_tables=tables)
    ck = tpc.gather_pages(pool_k, tables)
    cv = tpc.gather_pages(pool_v, tables)
    flash = dispatch.resolve_decode("flash_pallas")(
        q, ck, cv, lens, scale=scale, policy=pol)
    np.testing.assert_allclose(flash.numpy(), paged.numpy(), rtol=0,
                               atol=1e-6)
    assert (flash[1] == 0).all()


def test_decode_byte_model():
    # live tokens only: min(len, S) rows of K and V at container width
    assert tfa.decode_hbm_bytes([0, 100, 300], 256, 8, 128, "binary8",
                                g=4) == (2 * (100 + 256) * 8 * 128
                                         + 3 * 4 + 2 * 3 * 8 * 4 * 128 * 4)


# The CUDA kernel's split walk: pieces of ``DECODE_PIECE`` positions merged
# in piece order.  Its PyTorch twin is held here, at small widths and with
# small pieces (several per row), to the plain version, to the JAX oracle
# and to the JAX package's own merge of host-split partials.

def _edge_lengths(piece, S):
    """0, 1, each piece edge -1 / +0 / +1 below S, and S."""
    edges = [e + d for e in range(piece, S, piece) for d in (-1, 0, 1)]
    return sorted({0, 1, S, *[e for e in edges if 0 < e < S]})


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f or "f32")
@pytest.mark.parametrize("piece", [8, 16, 64])
def test_split_twin_matches_plain_and_xla_reference(fmt, piece):
    S = 40
    lengths = _edge_lengths(piece, S)
    q, kp, vp, lens = _case(fmt, B=len(lengths), S=S, seed=5,
                            lengths=lengths)
    got, gm, gl = tfa.flash_decode_split_plain(
        _t(q), _t(kp), _t(vp), fmt, _t(lens), piece=piece,
        return_residuals=True)
    plain, pm, pl = tfa.flash_decode_plain(_t(q), _t(kp), _t(vp), fmt,
                                           _t(lens), return_residuals=True)
    want, wm, wl = jfa.flash_decode_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), fmt,
        jnp.asarray(lens), return_residuals=True)
    for ref, rm, rl in ((plain.numpy(), pm.numpy(), pl.numpy()),
                        (np.asarray(want), np.asarray(wm), np.asarray(wl))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gm.numpy(), rm, rtol=1e-6)
        np.testing.assert_allclose(gl.numpy(), rl, rtol=1e-6)
    assert (got[0] == 0).all() and (gl[0] == 0).all()
    assert (gm[0] == tfa.NEG_INF).all()


@pytest.mark.parametrize("fmt", ["binary8", "binary16alt", None],
                         ids=lambda f: f or "f32")
def test_split_twin_matches_jax_merge_of_host_split_pieces(fmt):
    """Each piece through the JAX oracle at its local length (as the
    reference's sharded wrapper splits the cache), the partials merged by
    ``dispatch._merge_partials`` under ``jax.vmap`` over the piece axis
    named ``model``: within 1e-6 of the twin."""
    from repro.kernels import dispatch as jdispatch

    piece, S = 8, 40
    lengths = _edge_lengths(piece, S)
    q, kp, vp, lens = _case(fmt, B=len(lengths), S=S, seed=6,
                            lengths=lengths)
    P = -(-S // piece)
    parts = []
    for i in range(P):
        local = np.clip(lens - i * piece, 0, piece).astype(np.int32)
        sl = slice(i * piece, (i + 1) * piece)
        parts.append(jfa.flash_decode_reference(
            jnp.asarray(q), jnp.asarray(kp[:, sl]), jnp.asarray(vp[:, sl]),
            fmt, jnp.asarray(local), return_residuals=True))
    o, m, l = (jnp.stack([p[j] for p in parts]) for j in range(3))
    merged = jax.vmap(jdispatch._merge_partials, axis_name="model")(o, m, l)
    got = tfa.flash_decode_split_plain(_t(q), _t(kp), _t(vp), fmt,
                                       _t(lens), piece=piece)
    for i in range(P):   # every member of the axis holds the merge
        np.testing.assert_allclose(got.numpy(), np.asarray(merged[i]),
                                   rtol=0, atol=1e-6)


def test_piece_count_is_a_function_of_the_row_length():
    """ceil(min(len, S) / piece) per row at lengths 0, 1, the piece edges
    and S (and above S), whatever the other rows hold; the twin's row is
    the same computed alone or beside rows of other lengths."""
    piece, S = tfa.DECODE_PIECE, 256
    lengths = _edge_lengths(piece, S) + [S + 7]
    want = [-(-min(n, S) // piece) for n in lengths]
    assert tfa.decode_pieces(torch.tensor(lengths), S).tolist() == want
    for i, n in enumerate(lengths):
        assert tfa.decode_pieces(torch.tensor([n]), S).item() == want[i]
    q, kp, vp, lens = _case("binary8", B=4, S=S, H=2, dh=16, seed=7,
                            lengths=(1, 64, 129, 256))
    full = tfa.flash_decode_split_plain(_t(q), _t(kp), _t(vp), "binary8",
                                        _t(lens))
    for b in range(4):
        other = lens.copy()
        other[[i for i in range(4) if i != b]] = [0, S, 65][:3]
        got = tfa.flash_decode_split_plain(_t(q), _t(kp), _t(vp), "binary8",
                                           _t(other))
        assert torch.equal(got[b], full[b])
        alone = tfa.flash_decode_split_plain(
            _t(q[b:b + 1]), _t(kp[b:b + 1]), _t(vp[b:b + 1]), "binary8",
            _t(lens[b:b + 1]))
        np.testing.assert_allclose(alone[0].numpy(), full[b].numpy(),
                                   rtol=0, atol=1e-6)


# The widened shapes: head_dim 16 and 256 at G 10 (recurrentgemma's group),
# and G 2 (the reduced configs'), for every KV format.  The split twin
# walks in f64: it is held within 1e-6 (output) and 1e-6 relative (m, l)
# of the reference's formula evaluated in f64 on the decoded operands, and
# to the JAX f32 oracle within 2e-6 on the output and 1e-5 relative on l
# (that oracle's own f32 error can exceed 1e-6 at head_dim 256).

def _exact_decode(q, kp, vp, fmt, lengths):
    """``flash_decode_reference``'s formula in f64: (o, m, l)."""
    def dec(x):
        x = np.asarray(jqt.decode(jnp.asarray(x), fmt)) if fmt else x
        return x.astype(np.float64)

    k, v = dec(kp), dec(vp)
    s = np.einsum("bhgd,bshd->bhgs", q.astype(np.float64), k) \
        * float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    valid = np.arange(s.shape[-1])[None, :] < np.minimum(
        lengths, k.shape[1])[:, None]
    s = np.where(valid[:, None, None], s, -1e30)
    m = s.max(axis=-1)
    p = np.where(valid[:, None, None], np.exp(s - m[..., None]), 0.0)
    l = p.sum(axis=-1)
    o = np.einsum("bhgs,bshd->bhgd", p, v)
    return (np.where(l[..., None] > 0,
                     o / np.where(l > 0, l, 1.0)[..., None], 0.0), m, l)


WIDE_FMTS = ["binary8", "binary8alt", "binary16", "binary16alt",
             "binary32", "flexfloat<6,9>", None]


@pytest.mark.parametrize("G,dh", [(10, 16), (10, 256), (2, 256)],
                         ids=["G10-dh16", "G10-dh256", "G2-dh256"])
@pytest.mark.parametrize("fmt", WIDE_FMTS, ids=lambda f: f or "f32")
def test_split_twin_at_the_widened_shapes(fmt, G, dh):
    S = 140
    q, kp, vp, lens = _case(fmt, S=S, G=G, dh=dh, seed=G + dh,
                            lengths=(0, 63, 129, S + 9))
    got = tfa.flash_decode_split_plain(_t(q), _t(kp), _t(vp), fmt,
                                       _t(lens), return_residuals=True)
    eo, em, el = _exact_decode(q, kp, vp, fmt, lens)
    wo, wm, wl = jfa.flash_decode_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), fmt,
        jnp.asarray(np.minimum(lens, S)), return_residuals=True)
    o, m, l = (x.numpy() for x in got)
    np.testing.assert_allclose(o, eo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(m, em, rtol=1e-6)
    np.testing.assert_allclose(l, el, rtol=1e-6)
    np.testing.assert_allclose(o, np.asarray(wo), rtol=0, atol=2e-6)
    np.testing.assert_allclose(m, np.asarray(wm), rtol=1e-6)
    np.testing.assert_allclose(l, np.asarray(wl), rtol=1e-5)
    assert (o[0] == 0).all() and (l[0] == 0).all()


def test_split_twin_at_head_dim_256_matches_pallas_interpret():
    q, kp, vp, lens = _case("binary8", S=48, G=10, dh=256, seed=3,
                            lengths=(0, 7, 33, 48))
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(kp),
                            jnp.asarray(vp), "binary8", jnp.asarray(lens),
                            block_kv=16, interpret=True)
    got = tfa.flash_decode_split_plain(_t(q), _t(kp), _t(vp), "binary8",
                                       _t(lens), piece=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(
        got.numpy(), _exact_decode(q, kp, vp, "binary8", lens)[0], rtol=0,
        atol=1e-6)
