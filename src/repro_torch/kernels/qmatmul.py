"""Transprecision matmul with a fused epilogue: the CUDA kernel and its
plain PyTorch version.

The port of ``repro.kernels.qmatmul``.  ``qmatmul(a, b, fmt_a, fmt_b,
out_fmt, gate_payload=, bias=, act=)`` computes::

    out = quantize_{out_fmt}(act(a @ B + bias) * (a @ G))

with ``B``/``G`` packed (e, m) containers (or floats when ``fmt_b`` is
None), f32 products and f32 accumulation.  On a CUDA tensor it launches
``csrc/qmm.cu`` (``_qmm_cuda``); on a CPU tensor it runs the plain
version (``qmatmul_plain``: dequantize, then ``torch.matmul`` in f32, then
the same epilogue in the same order), which is also the library yardstick
on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import FpFormat, get_format

from . import _build
from .codec import decode_tile, quantize_tile

ACTS = {None: 0, "silu": 1, "gelu": 2, "relu2": 3}

LIB = _build.register(_build.KernelLib("qmm", {
    "qmm_launch": [_build.P] * 6 + [_build.I32] * 11 + [_build.P],
}))
GEMV_MAX_M = 8   # above this the kernel takes its shared-memory tiled path


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


def _qmm_cuda(a, b, fmt_b, out_fmt, gate, bias, act) -> torch.Tensor:
    M, K = a.shape
    N = b.shape[1]
    want = torch.float32 if fmt_b is None else fmt_b.container_dtype
    _build.check_operands("qmatmul", a.device, a=a, b=b, gate=gate,
                          bias=bias)
    if a.dtype != torch.float32:
        raise ValueError(f"qmatmul: activations must be float32, got "
                         f"{a.dtype}")
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
    splits = gemv_splits(M, K, N, _build.sm_count(a.device))
    ws = None
    if splits > 1:
        ws = torch.empty(((2 if gate is not None else 1) * splits, M, N),
                         dtype=torch.float32, device=a.device)
    p = _build.ptr
    LIB.launch("qmm_launch", p(a), p(b), p(gate), p(bias), p(out), p(ws),
               M, K, N, splits, _build.fmt_code(fmt_b), fmt.e, fmt.m,
               ACTS[act], oe, om, vec, _build.stream_ptr(a.device))
    return out


def gemv_splits(M: int, K: int, N: int, n_sm: int) -> int:
    """K splits for the decode-regime kernel: enough blocks for about two
    per SM (a 64-column strip is one block), each split keeping at least
    256 rows of K; 1 for the tiled regime."""
    if M > GEMV_MAX_M:
        return 1
    strips = -(-N // 64)
    return max(1, min(-(-2 * n_sm // strips), K // 256))


def qmatmul(a_payload, b_payload, fmt_a, fmt_b,
            out_fmt: Optional[FpFormat] = None, *, gate_payload=None,
            bias=None, act: Optional[str] = None) -> torch.Tensor:
    """(M, K) @ (K, N) on packed transprecision operands; f32
    accumulation; fused epilogue ``+ bias`` -> ``act`` -> ``* (a @ G)``
    -> quantize to ``out_fmt``.  Returns f32 (M, N).

    The CUDA kernel takes f32 activations (``fmt_a`` None), as every
    caller on the serving path passes; packed activations are a plain-
    version (CPU) feature."""
    fmt_a = get_format(fmt_a) if fmt_a is not None else None
    fmt_b = get_format(fmt_b) if fmt_b is not None else None
    out_fmt = get_format(out_fmt) if out_fmt is not None else None
    (M, K), (K2, N) = a_payload.shape, b_payload.shape
    assert K == K2, (a_payload.shape, b_payload.shape)
    if gate_payload is not None:
        assert gate_payload.shape == b_payload.shape
    if act not in ACTS:
        raise ValueError(act)
    if a_payload.device.type == "cpu":
        return qmatmul_plain(a_payload, b_payload, fmt_a, fmt_b, out_fmt,
                             gate_payload=gate_payload, bias=bias, act=act)
    if fmt_a is not None:
        raise ValueError("qmatmul: the CUDA kernel takes float32 "
                         "activations (fmt_a=None)")
    return _qmm_cuda(a_payload, b_payload, fmt_b, out_fmt, gate_payload,
                     bias, act)


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
