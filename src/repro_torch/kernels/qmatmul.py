"""Transprecision matmul with a fused epilogue: the CUDA kernel and its
plain PyTorch version.

The port of ``repro.kernels.qmatmul``.  ``qmatmul(a, b, fmt_a, fmt_b,
out_fmt, gate_payload=, bias=, act=)`` computes::

    out = quantize_{out_fmt}(act(a @ B + bias) * (a @ G))

with ``B``/``G`` packed (e, m) containers (or floats when ``fmt_b`` is
None), f32 products and f32 accumulation.  On a CUDA tensor it launches
``csrc/qmm.cu`` (``_qmm_cuda``) through one of two C entry points, chosen
by the weight format alone (``qmm_entry``):

* ``qmm_tc_launch`` for binary8, binary8alt, binary16 and binary16alt
  weights at every M (decode steps, prefill chunks, the speculative
  verify): split-TF32 tensor-core products, exact to 2^-22 |a| @ |b|
  plus the f32 accumulation (``split_tf32`` is its split in PyTorch);
* ``qmm_launch`` for binary32 / float weights and run-time (e, m)
  formats at every M, on the CUDA cores: the weight-streaming GEMV
  (``qmm_gemv``) for M <= 8 and the register-tiled ``qmm_tile`` above,
  with the row tile picked by M (``f32_tile_m``).

One summation order per format: each route sums a row's products in one
order whatever M is (its K split is a function of K and N only, and the
GEMV and ``qmm_tile`` share theirs), so a row's result does not depend
on the rows beside it: a speculative verify over B * k rows gives the
logits of k decode steps over B rows bit for bit.

Packed activations (``fmt_a`` set) are decoded inside ``qmm.cu``, once
per launch (in ``qmm_split_a`` on the tensor-core route, by
``qmm_decode_a`` into f32 scratch on the CUDA cores).  Decoding is exact
and the summation order is the route's, so the product on packed A equals
the product on its decoded values bit for bit.

On a CPU tensor it runs the plain version (``qmatmul_plain``:
dequantize, then ``torch.matmul`` in f32, then the same epilogue in the
same order).

The MoE expert product ``qmm_grouped(a, payload, fmt, rows)`` (a (E, C,
K), packed (E, K, N), rows (E,) int32) is one ``qmm_tc_grouped_launch``
(one device kernel) for the four packed formats: expert e's rows below
``rows[e]`` get ``a[e] @ B[e]``, the rest +0, and only experts with a
kept row stream their weights.  ``qmm_grouped_ffn(a, w_in, w_gate, fmt,
rows, act=, out_fmt=)`` is its gated form, ``act(a[e] @ W_in[e]) * (a[e]
@ W_gate[e])`` in the same one launch with ``qmm_ffn``'s epilogue.  Their
K split is the per-expert product's (``grouped_plan``), so every row
equals the per-expert loop (``qmm_grouped_loop``, ``qmm_grouped_ffn_loop``:
one ``qmm_tc`` launch an expert) bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import FpFormat, get_format

from . import _build
from ._route import meta_empty, route, shape_route
from .codec import decode_tile, quantize_tile, tf32_round, tf32_truncate

ACTS = {None: 0, "silu": 1, "gelu": 2, "relu2": 3}

# qmm.cu is built as seven units in parallel: the GEMV, the tensor-core
# kernel once per packed format, and qmm_tile for binary32 and for the
# run-time formats
LIB = _build.register(_build.KernelLib("qmm", {
    "qmm_launch": [_build.P] * 7 + [_build.I32] * 15 + [_build.P],
    "qmm_tc_launch": [_build.P] * 7 + [_build.I32] * 13 + [_build.P],
    "qmm_tc_grouped_launch": [_build.P] * 7 + [_build.I32] * 11
    + [_build.P],
}, units=[(f"-DQMM_UNIT={i}",) for i in range(7)]))
TC_FMT_CODES = (1, 2, 3, 4)   # binary8, binary8alt, binary16, binary16alt
TC_BN, TC_BK = 128, 32        # the tensor-core kernel's block columns, K step
TC_MIN_CHUNK = 128            # fewest K rows a split of that kernel takes
# blocks of that kernel's 64-row tile an SM holds at once (256 threads
# under 128 registers each, 77 KB of shared memory)
TC_BLOCKS_PER_SM = 2


def apply_act(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """The epilogue nonlinearities (gelu in its tanh form, as
    ``jax.nn.gelu``'s default)."""
    if name is None:
        return x
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":
        return torch.square(torch.relu(x))
    raise ValueError(name)


def _operand_f32(x: torch.Tensor, fmt: Optional[FpFormat]) -> torch.Tensor:
    return decode_tile(x, fmt) if fmt is not None else x.to(torch.float32)


def qmatmul_plain(a_payload, b_payload, fmt_a, fmt_b,
                  out_fmt: Optional[FpFormat] = None, *, gate_payload=None,
                  bias=None, act: Optional[str] = None) -> torch.Tensor:
    """The plain version: dequantize, f32 matmul, epilogue in the
    reference kernel's order (bias -> act -> gate -> quantize)."""
    fmt_a = get_format(fmt_a) if fmt_a is not None else None
    fmt_b = get_format(fmt_b) if fmt_b is not None else None
    a = _operand_f32(a_payload, fmt_a)
    r = torch.matmul(a, _operand_f32(b_payload, fmt_b))
    if bias is not None:
        r = r + bias.to(torch.float32)
    r = apply_act(r, act)
    if gate_payload is not None:
        r = r * torch.matmul(a, _operand_f32(gate_payload, fmt_b))
    if out_fmt is not None:
        out_fmt = get_format(out_fmt)
        r = quantize_tile(r, out_fmt.e, out_fmt.m, False)
    return r


def _qmm_cuda(a, b, fmt_b, out_fmt, gate, bias, act, *,
              tc_promote: bool = True, tile_m: Optional[int] = None,
              fmt_a: Optional[FpFormat] = None) -> torch.Tensor:
    """The launch.  ``fmt_a`` set: ``a`` holds packed activations in
    ``fmt_a``'s containers, decoded in the kernel.  ``tc_promote=False``
    and a ``tile_m`` other than ``f32_tile_m(M)`` (a GEMV row block of 4
    or 8, or a ``qmm_tile`` of 16, 32 or 64 rows, at any M) exist for
    ``chip_smoke.py``'s checks; the serving path passes neither."""
    M, K = a.shape
    N = b.shape[1]
    want = torch.float32 if fmt_b is None else fmt_b.container_dtype
    _build.check_operands("qmatmul", a.device, a=a, b=b, gate=gate,
                          bias=bias)
    want_a = torch.float32 if fmt_a is None or fmt_a.is_binary32 \
        else fmt_a.container_dtype
    if fmt_a is not None and fmt_a.is_binary32 \
            and a.dtype == fmt_a.container_dtype:
        a = a.view(torch.float32)        # binary32 containers are f32 bits
    if a.dtype != want_a:
        raise ValueError(f"qmatmul: activations must be {want_a} for "
                         f"{fmt_a}, got {a.dtype}")
    if b.dtype != want or (gate is not None and gate.dtype != want):
        raise ValueError(f"qmatmul: weights must be {want} for "
                         f"{fmt_b}, got {b.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (N,)):
        raise ValueError(f"qmatmul: bias must be float32 ({N},)")
    item = b.element_size()
    vec = int(N % 4 == 0 and b.data_ptr() % (4 * item) == 0
              and (gate is None or gate.data_ptr() % (4 * item) == 0))
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    fmt = fmt_b if fmt_b is not None else get_format("binary32")
    oe, om = (out_fmt.e, out_fmt.m) if out_fmt is not None else (0, 0)
    code = _build.fmt_code(fmt_b)
    a_code = _build.fmt_code(fmt_a)
    afmt = fmt_a if fmt_a is not None else get_format("binary32")
    entry, splits, k_chunk = qmm_plan(K, N, fmt_b, gate is not None,
                                      _build.sm_count(a.device))
    tc = entry == "qmm_tc_launch"
    ws = None
    if splits > 1:
        ws = torch.empty(((2 if gate is not None else 1) * splits, M, N),
                         dtype=torch.float32, device=a.device)
    p = _build.ptr
    if tc:
        asplit = torch.empty((2, M, K), dtype=torch.float32, device=a.device)
        LIB.launch("qmm_tc_launch", p(a), p(asplit), p(b), p(gate), p(bias),
                   p(out), p(ws), M, K, N, splits, k_chunk, code, ACTS[act],
                   oe, om, int(tc_promote), a_code, afmt.e, afmt.m,
                   _build.stream_ptr(a.device), kernel="qmm_tc")
    else:
        tile_m = tile_m or f32_tile_m(M)
        adec = None
        if a_code:
            adec = torch.empty((M, K), dtype=torch.float32, device=a.device)
        LIB.launch("qmm_launch", p(a), p(adec), p(b), p(gate), p(bias),
                   p(out), p(ws), M, K, N, splits, code, fmt.e, fmt.m,
                   ACTS[act], oe, om, vec, tile_m, a_code, afmt.e, afmt.m,
                   _build.stream_ptr(a.device),
                   kernel="qmm_gemv" if tile_m in GEMV_TILES
                   else "qmm_tile")
    return out


GEMV_TILES = (4, 8)           # rows a block of the GEMV (qmm_gemv)
F32_TILES = (16, 32, 64)      # rows a block of qmm_tile


def f32_tile_m(M: int) -> int:
    """Rows a block for M rows on the CUDA-core route (binary32 / float
    weights, run-time formats): the GEMV's 4 or 8 up to 8 rows (the
    decode step streams the weights), ``qmm_tile``'s 16, 32 or 64 above
    (a verify or a prefill chunk reuses each weight for every row).
    Both kernels sum an output in the same order, so the tile changes
    with M and a row's bits do not."""
    for t in GEMV_TILES + F32_TILES:
        if M <= t:
            return t
    return F32_TILES[-1]


def qmm_kernel(fmt_b: Optional[FpFormat], M: int) -> str:
    """The kernel a CUDA qmatmul of M rows launches: ``qmm_tc`` (the
    packed formats, every M), ``qmm_gemv`` or ``qmm_tile`` (the rest,
    by M); the name its launches are counted under."""
    if qmm_entry(fmt_b) == "qmm_tc_launch":
        return "qmm_tc"
    return "qmm_gemv" if f32_tile_m(M) in GEMV_TILES else "qmm_tile"


def gemv_splits(K: int, N: int, n_sm: int) -> int:
    """K splits of the CUDA-core route (the GEMV and ``qmm_tile``), a
    function of K and N only (so a row sums in one order at every M):
    enough blocks of one GEMV row block for about two per SM (a 64-column
    strip is one block), each split keeping at least 256 rows of K."""
    strips = -(-N // 64)
    return max(1, min(-(-2 * n_sm // strips), K // 256))


def qmm_entry(fmt_b: Optional[FpFormat]) -> str:
    """The C entry point a CUDA qmatmul takes: the tensor-core kernel for
    the four packed formats, ``qmm_launch`` (the CUDA-core route: the
    GEMV or ``qmm_tile`` by M, see ``f32_tile_m``) for binary32 / float
    weights and run-time (e, m) formats.  It depends on the format alone,
    not on M, and each route sums a row in one order; a fixed choice, not
    a fallback."""
    tc = _build.fmt_code(fmt_b) in TC_FMT_CODES
    return "qmm_tc_launch" if tc else "qmm_launch"


def qmm_plan(K: int, N: int, fmt_b: Optional[FpFormat], gated: bool,
             n_sm: int) -> tuple:
    """(entry point, K splits, K rows a split) of a CUDA qmatmul of any
    number of rows: one summation order per format, so a row of a given
    format and shape is summed in one order whether it is decoded with 3
    others, verified with 15 or prefilled in a 64-row chunk (only the
    row tile, ``f32_tile_m`` or ``tc_tile_m``, follows M)."""
    if qmm_entry(fmt_b) == "qmm_tc_launch":
        return ("qmm_tc_launch",) + tiled_splits(K, N, n_sm, gated)
    splits = gemv_splits(K, N, n_sm)
    return "qmm_launch", splits, -(-K // splits)


def tc_tile_m(M: int) -> int:
    """Rows of the tensor-core kernel's block tile for M rows."""
    return 16 if M <= 16 else 32 if M <= 32 else 64


def tiled_splits(K: int, N: int, n_sm: int, gated: bool = False) -> tuple:
    """(splits, k_chunk) of the tensor-core kernel, a function of K and N
    only: the order in which a row's products are summed then does not
    depend on M, so a prompt prefilled in one call, in 64-token chunks
    or verified 16 rows at a time gives the same rows bit for bit.  The
    N / 128 column tiles (N / 64 when gated: a block's 128 weight columns
    are 64 of B and the same 64 of G) of one 64-row tile are split along
    K into as many parts as fit the blocks the SMs hold at once
    (``TC_BLOCKS_PER_SM``), so a 64-row launch is one balanced wave;
    chunks are multiples of the kernel's 32-deep K step (and so of the
    mma's 8) and no shorter than ``TC_MIN_CHUNK``."""
    tiles = -(-N // (TC_BN // 2 if gated else TC_BN))
    want = n_sm * TC_BLOCKS_PER_SM // tiles
    if want <= 1 or K < 2 * TC_MIN_CHUNK:
        return 1, K
    per = -(-K // want)                     # rounded up: splits <= want
    k_chunk = max(TC_MIN_CHUNK, -(-per // TC_BK) * TC_BK)
    return -(-K // k_chunk), k_chunk


def split_tf32(a: torch.Tensor):
    """The tensor-core kernel's split of an f32 activation, in PyTorch:
    ``a = hi + lo + r`` with ``hi``, ``lo`` TF32 values and
    ``|r| <= max(2^-22 |a|, 2^-137)``.  ``hi`` is ``a`` rounded to TF32
    (truncated where rounding would pass the largest TF32 value), ``lo``
    the rounded remainder; Inf and NaN stay in ``hi`` with ``lo = 0``.
    Used by tests and ``chip_smoke.py``; the serving path does not call
    it."""
    a = a.to(torch.float32)
    hi = tf32_round(a)
    hi = torch.where(torch.isinf(hi) & ~torch.isinf(a), tf32_truncate(a), hi)
    finite = torch.isfinite(a)
    lo = torch.where(finite, tf32_round(torch.where(finite, a - hi, 0.0)),
                     0.0)
    return hi, lo


def qmatmul(a_payload, b_payload, fmt_a, fmt_b,
            out_fmt: Optional[FpFormat] = None, *, gate_payload=None,
            bias=None, act: Optional[str] = None) -> torch.Tensor:
    """(M, K) @ (K, N) on packed transprecision operands; f32
    accumulation; fused epilogue ``+ bias`` -> ``act`` -> ``* (a @ G)``
    -> quantize to ``out_fmt``.  Returns f32 (M, N).

    Activations are f32 (``fmt_a`` None, as every caller on the serving
    path passes) or packed containers of ``fmt_a``, which the CUDA kernel
    decodes itself; the result on packed A equals the result on its
    decoded values bit for bit."""
    fmt_a = get_format(fmt_a) if fmt_a is not None else None
    fmt_b = get_format(fmt_b) if fmt_b is not None else None
    out_fmt = get_format(out_fmt) if out_fmt is not None else None
    (M, K), (K2, N) = a_payload.shape, b_payload.shape
    assert K == K2, (a_payload.shape, b_payload.shape)
    if gate_payload is not None:
        assert gate_payload.shape == b_payload.shape
    if act not in ACTS:
        raise ValueError(act)
    where = route(a_payload)
    if where == "cpu":
        return qmatmul_plain(a_payload, b_payload, fmt_a, fmt_b, out_fmt,
                             gate_payload=gate_payload, bias=bias, act=act)
    if where == "meta":
        gated = gate_payload is not None
        a_item = 4 if fmt_a is None else fmt_a.container_bytes
        nbytes = qmm_hbm_bytes(M, K, N, fmt_b, gated=gated,
                               bias=bias is not None) - M * K * (4 - a_item)
        return shape_route(qmm_kernel(fmt_b, M),
                           meta_empty((M, N), torch.float32),
                           flops=qmm_flops(M, K, N, gated=gated),
                           nbytes=nbytes, a=a_payload, b=b_payload,
                           gate=gate_payload, bias=bias)
    return _qmm_cuda(a_payload, b_payload, fmt_b, out_fmt, gate_payload,
                     bias, act, fmt_a=fmt_a)


def qmm_ffn(x, w_in_payload, w_gate_payload, fmt_w, *, bias=None,
            act: str = "silu", out_fmt: Optional[FpFormat] = None):
    """Fused gated-FFN pair ``act(x @ w_in + bias) * (x @ w_gate)`` in one
    kernel; ``w_gate_payload=None`` gives the ungated form."""
    return qmatmul(x, w_in_payload, None, fmt_w, out_fmt,
                   gate_payload=w_gate_payload, bias=bias, act=act)


def qmm_hbm_bytes(M: int, K: int, N: int, fmt_w, *, gated: bool = False,
                  bias: bool = False) -> int:
    """Bytes one fused qmatmul must move: the packed weight stream (each
    weight read once), f32 activations in, f32 result out, bias."""
    item = 4 if fmt_w is None else get_format(fmt_w).container_bytes
    total = K * N * item * (2 if gated else 1) + M * K * 4 + M * N * 4
    return total + (N * 4 if bias else 0)


def qmm_flops(M: int, K: int, N: int, *, gated: bool = False) -> int:
    """Operations of one qmatmul: a multiply and an add per product
    (two products an output when gated); the epilogue's few per output
    are left out."""
    return 2 * M * K * N * (2 if gated else 1)


def grouped_plan(C: int, K: int, N: int, n_sm: int,
                 gated: bool = False) -> tuple:
    """(row tile, K splits, K rows a split) of the grouped expert
    product: the row tile follows the capacity C (``tc_tile_m``) and the
    K split is ``tiled_splits(K, N, gated)``, the per-expert product's,
    so an expert's rows are summed in the order of its own qmm_tc
    launch."""
    return (tc_tile_m(C),) + tiled_splits(K, N, n_sm, gated)


def _dead_rows_zero(out, rows):
    C = out.shape[1]
    keep = torch.arange(C, device=out.device)[None, :] \
        < rows.to(out.device, torch.int64)[:, None]
    return torch.where(keep[..., None], out, 0.0)


def qmm_grouped_plain(a, payload, fmt, rows) -> torch.Tensor:
    """The plain version of :func:`qmm_grouped`: ``qmatmul_plain`` of
    each expert's block, rows past its count set to +0."""
    fmt = get_format(fmt)
    out = torch.stack([qmatmul_plain(a[e], payload[e], None, fmt)
                       for e in range(a.shape[0])])
    return _dead_rows_zero(out, rows)


def qmm_grouped_ffn_plain(a, w_in, w_gate, fmt, rows, *, act="silu",
                          out_fmt=None) -> torch.Tensor:
    """The plain version of :func:`qmm_grouped_ffn`: ``qmatmul_plain``
    with the gate of each expert's block, rows past its count +0."""
    fmt = get_format(fmt)
    out = torch.stack([qmatmul_plain(
        a[e], w_in[e], None, fmt, out_fmt,
        gate_payload=None if w_gate is None else w_gate[e], act=act)
        for e in range(a.shape[0])])
    return _dead_rows_zero(out, rows)


def qmm_grouped_loop(a, payload, fmt) -> torch.Tensor:
    """One ``qmatmul`` per expert on its packed block, every row of every
    expert, as the reference's ``_grouped_qmm`` unrolls it: the route of
    binary32 and run-time-format experts, and on the card the exact
    oracle of :func:`qmm_grouped` (its rows equal these bit for bit)."""
    a = a.to(torch.float32)
    return torch.stack([qmatmul(a[e].contiguous(), payload[e], None, fmt)
                        for e in range(a.shape[0])])


def qmm_grouped_ffn_loop(a, w_in, w_gate, fmt, *, act="silu",
                         out_fmt=None) -> torch.Tensor:
    """One ``qmm_ffn`` per expert, every row of every expert: on the card
    the exact oracle of :func:`qmm_grouped_ffn` (its kept rows equal
    these bit for bit, and its dead rows the +0 these give a zero row)."""
    a = a.to(torch.float32)
    return torch.stack([qmm_ffn(a[e].contiguous(), w_in[e],
                                None if w_gate is None else w_gate[e], fmt,
                                act=act, out_fmt=out_fmt)
                        for e in range(a.shape[0])])


def _grouped_args(what, a, payload, rows):
    E, C, K = a.shape
    if tuple(payload.shape[:2]) != (E, K) or tuple(rows.shape) != (E,):
        raise ValueError(f"{what}: a {tuple(a.shape)}, weights "
                         f"{tuple(payload.shape)}, rows {tuple(rows.shape)}")


def qmm_grouped(a, payload, fmt, rows) -> torch.Tensor:
    """The MoE expert product: ``a`` (E, C, K) f32, ``payload`` (E, K, N)
    packed in ``fmt`` (binary8, binary8alt, binary16 or binary16alt),
    ``rows`` (E,) int32 kept rows an expert.  Expert e's rows below
    ``rows[e]`` get ``a[e] @ B[e]`` in f32, the rest +0.  On a CUDA tensor
    one ``qmm_tc_grouped_launch`` (one device kernel) that reads the
    counts on the device (no host synchronisation) and streams only
    experts with a kept row; on a CPU tensor the plain version."""
    fmt = get_format(fmt)
    _grouped_args("qmm_grouped", a, payload, rows)
    where = route(a)
    if where == "cpu":
        return qmm_grouped_plain(a, payload, fmt, rows)
    if where == "meta":
        return _grouped_shape(a, payload, fmt, False)
    return _qmm_grouped_cuda(a, payload, fmt, rows)


def qmm_grouped_ffn(a, w_in, w_gate, fmt, rows, *, act: str = "silu",
                    out_fmt: Optional[FpFormat] = None) -> torch.Tensor:
    """The MoE gated pair in one launch, the grouped ``qmm_ffn``: expert
    e's rows below ``rows[e]`` get ``quantize_{out_fmt}(act(a[e] @
    W_in[e]) * (a[e] @ W_gate[e]))``, the rest +0 (``w_gate`` None: the
    ungated ``act(a[e] @ W_in[e])``).  Arguments as :func:`qmm_grouped`;
    on a CUDA tensor one ``qmm_tc_grouped_launch``, on a CPU tensor the
    plain version."""
    fmt = get_format(fmt)
    out_fmt = get_format(out_fmt) if out_fmt is not None else None
    _grouped_args("qmm_grouped_ffn", a, w_in, rows)
    if w_gate is not None and w_gate.shape != w_in.shape:
        raise ValueError(f"qmm_grouped_ffn: w_gate {tuple(w_gate.shape)} "
                         f"!= w_in {tuple(w_in.shape)}")
    if act not in ACTS:
        raise ValueError(act)
    where = route(a)
    if where == "cpu":
        return qmm_grouped_ffn_plain(a, w_in, w_gate, fmt, rows, act=act,
                                     out_fmt=out_fmt)
    if where == "meta":
        return _grouped_shape(a, w_in, fmt, w_gate is not None)
    return _qmm_grouped_cuda(a, w_in, fmt, rows, w_gate, act, out_fmt)


def _grouped_shape(a, b, fmt: FpFormat, gated: bool) -> torch.Tensor:
    """The shape route of the grouped product: a ``meta`` tensor holds
    no kept-row counts, so every expert counts as live with all its C
    rows."""
    _grouped_route(fmt)
    E, C, K = a.shape
    N = b.shape[2]
    name = "qmm_tc_grouped_ffn" if gated else "qmm_tc_grouped"
    return shape_route(
        name, meta_empty((E, C, N), torch.float32),
        flops=E * qmm_flops(C, K, N, gated=gated),
        nbytes=qmm_grouped_hbm_bytes([C] * E, K, N, fmt, C, gated), a=a,
        b=b)


def _grouped_route(fmt: FpFormat) -> None:
    """The grouped kernel takes the four packed formats only."""
    if _build.fmt_code(fmt) not in TC_FMT_CODES:
        raise ValueError(f"qmm_grouped: {fmt.name} weights take the "
                         f"per-expert loop (qmm_grouped_loop)")


# per-tile arrival counters of the grouped kernel's split-K reduce, one
# zeroed int32 buffer a (device, stream): the kernel leaves every counter
# at 0, so calls in order on one stream share it, and calls on two
# streams, which may run at once, never do
_TILE_COUNTS: dict = {}


def _tile_counts(device, n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TILE_COUNTS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
        _TILE_COUNTS[key] = t
    return t


def _qmm_grouped_cuda(a, b, fmt: FpFormat, rows, gate=None, act=None,
                      out_fmt: Optional[FpFormat] = None) -> torch.Tensor:
    E, C, K = a.shape
    N = b.shape[2]
    _grouped_route(fmt)
    code = _build.fmt_code(fmt)
    _build.check_operands("qmm_grouped", a.device, a=a, b=b, gate=gate,
                          rows=rows)
    if a.dtype != torch.float32 or b.dtype != fmt.container_dtype \
            or (gate is not None and gate.dtype != b.dtype) \
            or rows.dtype != torch.int32:
        raise ValueError(f"qmm_grouped: want f32 a, {fmt.container_dtype} "
                         f"weights, int32 rows; got {a.dtype}, {b.dtype}, "
                         f"{rows.dtype}")
    out = torch.empty((E, C, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    n_sm = _build.sm_count(a.device)
    gated = gate is not None
    tile_m, splits, k_chunk = grouped_plan(C, K, N, n_sm, gated)
    ws = counts = None
    if splits > 1:
        ws = torch.empty(((2 if gated else 1) * splits, E, C, N),
                         dtype=torch.float32, device=a.device)
        n_tiles = -(-N // (TC_BN // 2 if gated else TC_BN))
        counts = _tile_counts(a.device, E * -(-C // tile_m) * n_tiles)
    oe, om = (out_fmt.e, out_fmt.m) if out_fmt is not None else (0, 0)
    p = _build.ptr
    LIB.launch("qmm_tc_grouped_launch", p(a), p(b), p(gate), p(out), p(ws),
               p(counts), p(rows), E, C, K, N, splits, k_chunk, code,
               ACTS[act], oe, om, n_sm, _build.stream_ptr(a.device),
               kernel="qmm_tc_grouped_ffn" if gated or act is not None
               else "qmm_tc_grouped")
    return out


def qmm_grouped_hbm_bytes(rows, K: int, N: int, fmt, C: int,
                          gated: bool = False) -> int:
    """Bytes one grouped product of capacity ``C`` must move: the weights
    of the experts with a kept row (each read once; both of the pair when
    ``gated``), the kept rows' f32 activations in, and the whole (E, C,
    N) f32 result out (the dead rows' +0 included)."""
    rows = [int(r) for r in rows]
    item = get_format(fmt).container_bytes
    weights = sum(1 for r in rows if r > 0) * K * N * item
    return weights * (2 if gated else 1) + sum(rows) * K * 4 \
        + len(rows) * C * N * 4
