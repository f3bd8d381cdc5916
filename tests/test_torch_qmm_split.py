"""The precision argument of qmm's tensor-core kernel, on the CPU.

``csrc/qmm.cu`` runs M > 8 rows on binary8, binary8alt, binary16 and
binary16alt weights as two TF32 tensor-core passes, a_hi @ B + a_lo @ B.
That is exact to 2^-22 |a| @ |b| (plus the f32 accumulation) because
(1) every packed weight decodes to a TF32 value, and (2) the activation
split ``split_tf32`` leaves TF32 parts with a residual of at most
max(2^-22 |a|, 2^-137).  Both facts are checked here on every container
pattern and on seeded and boundary activations, and the two-pass product
(taken in f64) is held to the JAX package's qmatmul (Pallas, interpret
mode) within the port's 1e-6 in units of |a| @ |b|.  The split-K
arithmetic of the kernels' grids is checked at the serving shapes, and
the launch plan (entry point and K split) is checked to depend on the
format and the shape only, never on M."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels import qmatmul as jq  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402
from repro_torch.core.qtensor import decode  # noqa: E402
from repro_torch.kernels import codec as tcodec  # noqa: E402
from repro_torch.kernels import qmatmul as tq  # noqa: E402

PACKED = ["binary8", "binary8alt", "binary16", "binary16alt"]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _is_tf32(x):
    """Finite values whose low 13 mantissa bits are zero (NaN, Inf pass)."""
    return bool(((_bits(x) & 0x1FFF) == 0)[torch.isfinite(x)].all())


@pytest.mark.parametrize("fmt", PACKED)
def test_every_packed_pattern_decodes_to_a_tf32_value(fmt):
    f = get_format(fmt)
    pats = torch.arange(1 << f.bits, dtype=torch.int64).to(f.container_dtype)
    x = decode(pats, f)
    fin = torch.isfinite(x)
    assert _is_tf32(x)
    assert torch.equal(_bits(tcodec.tf32_round(x))[fin], _bits(x)[fin])
    assert bool(torch.isnan(tcodec.tf32_round(x[torch.isnan(x)])).all())


def _activations(kind, rng):
    if kind == "seeded normal":
        return (rng.normal(size=50_000) * 10.0 ** rng.integers(
            -30, 30, size=50_000)).astype(np.float32)
    if kind == "random bit patterns":
        return rng.integers(0, 1 << 32, size=200_000,
                            dtype=np.uint64).astype(np.uint32).view(
                                np.float32)
    if kind == "subnormals":
        return (rng.integers(1, 1 << 23, size=50_000).astype(np.uint32)
                | (rng.integers(0, 2, size=50_000).astype(np.uint32)
                   << 31)).view(np.float32)
    if kind == "boundaries":
        fmax = np.finfo(np.float32).max
        tiny = np.finfo(np.float32).tiny
        p2 = np.float32(2.0) ** np.arange(-149, 128, dtype=np.float32)
        # the first f32 that cvt.rna rounds past the largest TF32 value
        past = np.array([0x7F7FF000], np.uint32).view(np.float32)
        base = np.concatenate([p2, past, [fmax, tiny, 0.0]])
        base = np.concatenate([base, -base]).astype(np.float32)
        with np.errstate(over="ignore"):
            near = [np.nextafter(base, np.float32(np.inf)),
                    np.nextafter(base, np.float32(-np.inf))]
        return np.concatenate([base, *near]).astype(np.float32)
    if kind == "ties":
        # mantissas exactly halfway between two TF32 values, and one f32
        # ulp either side of the halfway point
        m = rng.integers(0, 1 << 10, size=20_000).astype(np.uint32)
        e = rng.integers(1, 254, size=20_000).astype(np.uint32)
        tie = (e << 23) | (m << 13) | np.uint32(0x1000)
        bits = np.concatenate([tie, tie + 1, tie - 1])
        sign = rng.integers(0, 2, size=bits.size).astype(np.uint32) << 31
        return (bits | sign).view(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["seeded normal", "random bit patterns",
                                  "subnormals", "boundaries", "ties"])
def test_split_tf32_parts_and_residual(kind):
    rng = np.random.default_rng(13)
    a = _activations(kind, rng)
    assert a.dtype == np.float32
    a = a[np.isfinite(a)]
    hi, lo = tq.split_tf32(torch.from_numpy(a))
    assert _is_tf32(hi) and _is_tf32(lo)
    assert bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())
    r = np.abs(a.astype(np.float64) - hi.double().numpy()
               - lo.double().numpy())
    bound = np.maximum(2.0 ** -22 * np.abs(a.astype(np.float64)),
                       2.0 ** -137)
    assert (r <= bound).all(), float((r / bound).max())
    # below the values that round past the largest TF32 value, hi is a
    # rounded to the nearest TF32 value (cvt.rna): |a - hi| <= half a
    # TF32 ulp
    a64 = a.astype(np.float64)
    keep = np.abs(a) < np.array([0x7F7FF000], np.uint32).view(np.float32)
    e = np.floor(np.log2(np.maximum(np.abs(a64), 2.0 ** -126)))
    assert (np.abs(a64 - hi.double().numpy())[keep]
            <= 2.0 ** (e - 11)[keep]).all()


def test_split_tf32_ties_round_away_from_zero_and_specials():
    a = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      float("inf"), float("-inf"), float("nan"),
                      3.4028234663852886e38], dtype=torch.float32)
    hi, lo = tq.split_tf32(a)
    assert hi[0].item() == 1 + 2 ** -10 and lo[0].item() == -2 ** -11
    assert hi[1].item() == -(1 + 2 ** -10)
    assert hi[2].item() == 1 + 2 ** -9 and lo[2].item() == -2 ** -11
    assert hi[3].item() == float("inf") and lo[3].item() == 0.0
    assert hi[4].item() == float("-inf") and lo[4].item() == 0.0
    assert torch.isnan(hi[5]) and lo[5].item() == 0.0
    # rna would round the largest f32 up to Inf: hi is a truncated there
    assert torch.isfinite(hi[6]) and hi[6].item() + lo[6].item() > 3.4e38


@pytest.mark.parametrize("fmt", PACKED)
@pytest.mark.parametrize("K", [4096, 14336])
def test_two_pass_product_matches_pallas_interpret(fmt, K):
    """a_hi @ B + a_lo @ B, each product exact and summed in f64, against
    the JAX kernel: within 1e-6 in units of |a| @ |b|."""
    M, N = 9, 16
    rng = np.random.default_rng(K + len(fmt))
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = np.asarray(jqt.encode(jnp.asarray(rng.normal(size=(K, N)),
                                          jnp.float32), fmt))
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jnp.asarray(w), None, fmt,
                                 interpret=True))
    wf = decode(torch.from_numpy(w.copy()), get_format(fmt)).double()
    hi, lo = tq.split_tf32(torch.from_numpy(x))
    got = (hi.double() @ wf + lo.double() @ wf).numpy()
    unit = np.abs(x).astype(np.float64) @ np.abs(wf.numpy()) + 1.0
    err = np.abs(got - want) / unit
    assert err.max() <= 1e-6, err.max()


SERVING = [(M, K, N, gated) for M in (4, 16, 64) for K, N, gated in
           ((4096, 4096, False), (4096, 1024, False), (4096, 14336, True),
            (14336, 4096, False))] + [
               (4, 4096, 128256, False),
               (16, 4096, 128256, False), (128, 4096, 4096, False),
               (128, 4096, 1024, False), (128, 4096, 14336, True)]


@pytest.mark.parametrize("M,K,N,gated", SERVING)
def test_tiled_splits_fill_the_card(M, K, N, gated):
    """Every serving shape of the tensor-core kernel (decode steps at
    M = 4 with the head, prefill chunks at M = 64, the draft's 128-token
    prompt, the verify at M = 16 with its head; the gated FFN covers 64
    outputs a block) puts at least one block
    on each of an H100's 132 SMs, and one 64-row tile of a split launch
    no more than the SMs hold at once; K chunks are multiples of the
    kernel's 32-deep step (so of the mma's 8), cover K, and leave no split
    empty.  The split is a function of K and N alone, so every M sums a
    row in the same order."""
    splits, k_chunk = tq.tiled_splits(K, N, 132, gated)
    bn = tq.TC_BN // 2 if gated else tq.TC_BN
    blocks = -(-M // tq.tc_tile_m(M)) * -(-N // bn) * splits
    assert blocks >= 132
    wave = 132 * tq.TC_BLOCKS_PER_SM
    assert splits == 1 or -(-N // bn) * splits <= wave
    assert splits == 1 or k_chunk % tq.TC_BK == 0
    assert k_chunk % 8 == 0 and k_chunk >= min(K, tq.TC_MIN_CHUNK)
    assert (splits - 1) * k_chunk < K <= splits * k_chunk


@pytest.mark.parametrize("M,fmt,entry", [
    (1, "binary16alt", "qmm_tc_launch"), (8, "binary8", "qmm_tc_launch"),
    (9, "binary8", "qmm_tc_launch"), (16, "binary8alt", "qmm_tc_launch"),
    (64, "binary16", "qmm_tc_launch"), (64, "binary16alt", "qmm_tc_launch"),
    (1, "binary32", "qmm_launch"), (4, None, "qmm_launch"),
    (64, "binary32", "qmm_launch"), (64, None, "qmm_launch"),
    (64, "flexfloat<6,9>", "qmm_launch")])
def test_entry_point_is_fixed_by_format_and_rows(M, fmt, entry):
    """The packed formats take the tensor-core kernel and binary32 /
    float weights and run-time formats the GEMV, at every M."""
    f = get_format(fmt) if fmt is not None else None
    assert tq.qmm_entry(f) == entry
    assert tq.qmm_plan(4096, 4096, f, False, 132)[0] == entry
    assert tq.tc_tile_m(M) in (16, 32, 64)


GEMV_SHAPES = [(4096, 4096, False), (4096, 1024, False),
               (4096, 14336, True), (14336, 4096, False),
               (4096, 128256, False), (100, 70, False), (255, 1030, True)]


@pytest.mark.parametrize("K,N,gated", GEMV_SHAPES)
@pytest.mark.parametrize("fmt", ["binary32", None, "flexfloat<6,9>"])
def test_gemv_split_is_the_same_for_every_m_and_covers_k(K, N, gated, fmt):
    """The GEMV's plan (binary32 / float weights, run-time formats) takes
    no row count, so M = 1 ... 128 share it: the K split, a function of K
    and N, whose chunks (``ceil(K / splits)`` rows, as ``qmm.cu``
    computes them) cover K with no empty split and keep at least 256 rows
    each."""
    f = get_format(fmt) if fmt is not None else None
    assert "M" not in inspect.signature(tq.qmm_plan).parameters
    entry, splits, k_chunk = tq.qmm_plan(K, N, f, gated, 132)
    assert entry == "qmm_launch"
    assert splits == tq.gemv_splits(K, N, 132)
    assert k_chunk == -(-K // splits)
    assert (splits - 1) * k_chunk < K <= splits * k_chunk
    assert splits == 1 or k_chunk >= 256


# --- the CUDA-core route (binary32 / float weights, run-time formats):
# the GEMV up to 8 rows, qmm_tile above, one summation order ---------------

@pytest.mark.parametrize("M,tile,kernel", [
    (1, 4, "qmm_gemv"), (2, 4, "qmm_gemv"), (4, 4, "qmm_gemv"),
    (5, 8, "qmm_gemv"), (8, 8, "qmm_gemv"), (9, 16, "qmm_tile"),
    (16, 16, "qmm_tile"), (17, 32, "qmm_tile"), (32, 32, "qmm_tile"),
    (33, 64, "qmm_tile"), (64, 64, "qmm_tile"), (100, 64, "qmm_tile"),
    (128, 64, "qmm_tile")])
@pytest.mark.parametrize("fmt", ["binary32", None, "flexfloat<6,9>",
                                 "flexfloat<3,4>", "flexfloat<8,15>"])
def test_f32_row_tile_is_picked_by_m(M, tile, kernel, fmt):
    """The row tile follows M (the decode step's 1-8 rows stream the
    weights through the GEMV, a verify or a chunk reuses them in
    qmm_tile), while the entry point stays fixed by the format."""
    f = get_format(fmt) if fmt is not None else None
    assert tq.f32_tile_m(M) == tile
    assert tq.qmm_kernel(f, M) == kernel
    assert tq.qmm_entry(f) == "qmm_launch"
    assert (tile in tq.GEMV_TILES) == (kernel == "qmm_gemv")


@pytest.mark.parametrize("fmt", PACKED)
def test_packed_formats_take_the_tensor_cores_at_every_m(fmt):
    f = get_format(fmt)
    assert {tq.qmm_kernel(f, M) for M in range(1, 129)} == {"qmm_tc"}
    assert {tq.qmm_entry(f) for _ in range(3)} == {"qmm_tc_launch"}


LLAMA = [(4096, 4096, False), (4096, 1024, False), (4096, 14336, True),
         (14336, 4096, False), (4096, 128256, False)]
RAGGED = [(4100, 1030, True), (100, 70, False), (255, 1030, True),
          (130, 77, False)]


@pytest.mark.parametrize("K,N,gated", LLAMA + RAGGED)
@pytest.mark.parametrize("fmt", ["binary32", "flexfloat<6,9>"])
def test_f32_plan_is_the_same_at_every_m(K, N, gated, fmt):
    """Every M from 1 to 128, the GEMV's and qmm_tile's alike, takes one
    (entry, splits, k_chunk): the K split and its residue classes, and
    so the order of a row's sum, do not follow the row tile."""
    f = get_format(fmt)
    plans = {(tq.qmm_kernel(f, M) in ("qmm_gemv", "qmm_tile"),
              tq.qmm_plan(K, N, f, gated, 132)) for M in range(1, 129)}
    assert len(plans) == 1
    plans = {p for _, p in plans}
    entry, splits, k_chunk = plans.pop()
    assert entry == "qmm_launch" and splits == tq.gemv_splits(K, N, 132)
    assert k_chunk == -(-K // splits)


@pytest.mark.parametrize("K,N,gated", LLAMA)
def test_tile_at_the_chunk_fills_the_card_on_aligned_copies(K, N, gated):
    """A 64-row chunk's qmm_tile launch over every llama3-8b projection:
    at least one block per SM of an H100 (132), and the K chunk a
    multiple of 4 with N a multiple of 4 (so the activation and weight
    tiles load by 16 B cp.async, not element by element)."""
    splits = tq.gemv_splits(K, N, 132)
    k_chunk = -(-K // splits)
    bn = 16 if gated else 32
    blocks = -(-64 // tq.f32_tile_m(64)) * -(-N // bn) * splits
    assert blocks >= 132
    assert K % 4 == 0 and k_chunk % 4 == 0 and N % 4 == 0
