"""The yardstick: the card's peaks, the model's operations a token, and
each kernel's operations and bytes.  Frozen copies, so that a change to
the program cannot move the measure it is judged by.

Copied from (and kept apart from, on purpose):

* ``src/repro_torch/launch/dryrun.py`` ``model_flops`` (2 x active
  parameters a token served) and ``src/repro_torch/models/base.py``
  ``ModelConfig.param_count`` (its dense branch);
* ``src/repro_torch/kernels/qmatmul.py`` ``qmm_flops`` and
  ``qmm_hbm_bytes``;
* ``src/repro_torch/kernels/paged_attention.py`` ``paged_hbm_bytes``
  and ``src/repro_torch/kernels/flash_attention.py`` ``decode_flops``,
  ``prefill_hbm_bytes`` and ``visible_pairs`` (causal, no window).

Where a kernel's work depends on the data, the count is what the data
needs: a decode call reads only the valid rows of each sequence, a
prefill chunk only the keys its causal mask lets through.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: bf16 / fp16 tensor cores, HBM3.
# The weights are served in binary16alt (bf16), so a share of 989 TFLOP/s
# cannot pass 100 % whatever a kernel does inside.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def dense_param_count(c: dict) -> int:
    """Parameters of a dense GQA decoder with rmsnorm, a gated FFN and an
    untied head (the dense branch of ``ModelConfig.param_count``): the
    embedding and the head are counted, as the program's model_flops
    counts them."""
    d, ff, v, L = c["d_model"], c["d_ff"], c["vocab"], c["n_layers"]
    qd, kvd = c["n_heads"] * c["head_dim"], c["n_kv"] * c["head_dim"]
    attn = d * qd + 2 * d * kvd + qd * d
    ffn = 3 * d * ff
    return 2 * v * d + L * (2 * d + attn + ffn) + d


def model_flops(n_active: int, tokens: int) -> float:
    """``model_flops`` of ``tokens`` served tokens: 2 x active params."""
    return 2.0 * n_active * tokens


def qmm_flops(M: int, K: int, N: int, gated: bool = False) -> int:
    """A multiply and an add per product; two products an output when
    gated."""
    return 2 * M * K * N * (2 if gated else 1)


def qmm_bytes(M: int, K: int, N: int, w_item: int, gated: bool = False) -> int:
    """Packed weights at their stored width read once (twice the columns
    when gated), f32 activations in once, f32 outputs out once."""
    return K * N * w_item * (2 if gated else 1) + M * K * 4 + M * N * 4


def decode_attn_flops(rows: int, n_heads: int, head_dim: int) -> int:
    """Scores and the weighted sum over ``rows`` valid cached rows of one
    sequence: a multiply and an add each per element."""
    return 4 * n_heads * head_dim * rows


def decode_attn_bytes(lengths, n_kv: int, n_heads: int, head_dim: int,
                      kv_item: int, page: int) -> int:
    """One paged decode call over the sequences of ``lengths``: their
    valid K and V rows at container width, the block-table entries of
    their live pages, the lengths, q in and out (f32)."""
    lengths = [int(n) for n in lengths]
    pages = sum(-(-n // page) for n in lengths)
    kv = 2 * sum(lengths) * n_kv * head_dim * kv_item
    return kv + 4 * pages + 4 * len(lengths) \
        + 2 * len(lengths) * n_heads * head_dim * 4


def causal_pairs(rows: int, offset: int) -> int:
    """(query, key) pairs of a causal chunk of ``rows`` queries at
    positions ``offset`` ... ``offset + rows - 1``."""
    return rows * offset + rows * (rows + 1) // 2


def prefill_attn_flops(rows: int, offset: int, n_heads: int,
                       head_dim: int) -> int:
    return 4 * n_heads * head_dim * causal_pairs(rows, offset)


def prefill_attn_bytes(rows: int, offset: int, n_kv: int, n_heads: int,
                       head_dim: int, kv_item: int) -> int:
    """q in and out (f32) and the ``offset + rows`` K and V rows the
    causal chunk can see, read once at container width."""
    return 2 * rows * n_heads * head_dim * 4 \
        + 2 * (offset + rows) * n_kv * head_dim * kv_item
