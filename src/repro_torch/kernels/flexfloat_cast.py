"""FlexFloat sanitization (f32 -> (e, m)), fused quantize + pack, and
unpack: the CUDA kernels and their plain PyTorch versions.

The port of ``repro.kernels.flexfloat_cast``.  ``flexfloat_cast``,
``quantize_encode`` and ``dequantize_decode`` keep the reference's
signatures without the Pallas ``block`` / ``interpret`` arguments
(``flexfloat_cast`` also takes ``rbits``, the explicit random words of
stochastic rounding).  On a
CUDA tensor each launches its kernel in ``csrc/flexfloat_cast.cu`` (one
flat grid-stride pass over any shape and element count); on a CPU tensor
it runs the plain version, the port's int64 codec
(``kernels/codec.py``).  binary32 ``flexfloat_cast`` returns ``x``
without a launch, as in the reference.  ``quantize_encode`` launches a
kernel specialised for each of the paper's four formats (the run-time
codec for any other (e, m)), with the vector width and grid of
``encode_plan``.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import get_format

from . import _build
from ._route import route, shape_route
from .codec import decode_tile, encode_tile, quantize_tile

_SIG = [_build.P, _build.P, _build.I64] + [_build.I32] * 5 + [_build.P]
LIB = _build.register(_build.KernelLib("flexfloat_cast", {
    "flexfloat_cast_launch": _SIG,
    "flexfloat_cast_sr_launch": [_build.P] + _SIG,
    "quantize_encode_launch": _SIG,
    "dequantize_decode_launch": _SIG,
}))


def flexfloat_cast_plain(x, fmt, *, saturate: bool = False,
                         rbits=None) -> torch.Tensor:
    fmt = get_format(fmt)
    return quantize_tile(torch.as_tensor(x).to(torch.float32), fmt.e, fmt.m,
                         saturate, rbits)


def u32_words(rbits, like: torch.Tensor) -> torch.Tensor:
    """``rbits`` (any integer dtype, ``like``'s shape) as contiguous int32
    words on ``like``'s device: the low 32 bits of each value, as the
    plain version reads them."""
    r = torch.as_tensor(rbits, device=like.device)
    if tuple(r.shape) != tuple(like.shape):
        raise ValueError(f"rbits has shape {tuple(r.shape)}, the input "
                         f"{tuple(like.shape)}")
    if r.dtype in (torch.int32, torch.uint32):
        return r.contiguous().view(torch.int32)
    if r.is_floating_point() or r.dtype == torch.bool:
        raise ValueError(f"rbits must be integers, got {r.dtype}")
    r = r.to(torch.int64) & 0xFFFF_FFFF
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)


def quantize_encode_plain(x, fmt) -> torch.Tensor:
    fmt = get_format(fmt)
    return encode_tile(quantize_tile(torch.as_tensor(x).to(torch.float32),
                                     fmt.e, fmt.m), fmt)


def dequantize_decode_plain(payload, fmt) -> torch.Tensor:
    return decode_tile(torch.as_tensor(payload), get_format(fmt))


def _launch(symbol: str, x, out, fmt, third: int) -> torch.Tensor:
    """One flat launch over ``x`` into ``out`` (same shape, contiguous)."""
    _build.check_no_grad(symbol, x=x)
    n = x.numel()
    if n == 0:
        return out
    vec = int(x.data_ptr() % (4 * x.element_size()) == 0
              and out.data_ptr() % (4 * out.element_size()) == 0)
    LIB.launch(symbol, _build.ptr(x), _build.ptr(out), n, fmt.e, fmt.m,
               third, vec, _build.sm_count(x.device),
               _build.stream_ptr(x.device))
    return out


def flexfloat_cast(x, fmt, *, saturate: bool = False,
                   rbits=None) -> torch.Tensor:
    """Sanitize ``x`` to ``fmt``: round to nearest even, gradual
    underflow, overflow to +/-Inf (or +/-max_normal with ``saturate``),
    canonical NaN.  Returns float32 of ``x``'s shape.  With ``rbits``
    (uniform random u32 words, one an element, any integer dtype)
    stochastic rounding in the normal range (``flexfloat_cast_sr_launch``:
    the same kernel reading the words beside ``x``)."""
    fmt = get_format(fmt)
    x = torch.as_tensor(x).to(torch.float32)
    if fmt.is_binary32:
        return x
    where = route(x)
    if where == "cpu":
        return flexfloat_cast_plain(x, fmt, saturate=saturate, rbits=rbits)
    if where == "meta":
        n = x.numel()
        name = "flexfloat_cast" if rbits is None else "flexfloat_cast_sr"
        return shape_route(name, torch.empty_like(x, device="meta"),
                           flops=n, nbytes=elementwise_hbm_bytes(
                               n, 4 if rbits is None else 8, 4), x=x)
    x = x.contiguous()
    if rbits is None:
        return _launch("flexfloat_cast_launch", x, torch.empty_like(x), fmt,
                       int(saturate))
    words = u32_words(rbits, x)
    _build.check_no_grad("flexfloat_cast_sr", x=x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x, words, out)))
    LIB.launch("flexfloat_cast_sr_launch", _build.ptr(x), _build.ptr(words),
               _build.ptr(out), n, fmt.e, fmt.m, int(saturate), vec,
               _build.sm_count(x.device), _build.stream_ptr(x.device))
    return out


def quantize_encode(x, fmt) -> torch.Tensor:
    """Fused sanitize + pack: f32 -> the (e, m) field in the format's
    uint8 / uint16 / uint32 container."""
    fmt = get_format(fmt)
    x = torch.as_tensor(x).to(torch.float32)
    where = route(x)
    if where == "cpu":
        return quantize_encode_plain(x, fmt)
    out = torch.empty(x.shape, dtype=fmt.container_dtype, device=x.device)
    n = x.numel()
    if where == "meta":
        return shape_route("quantize_encode", out, flops=n,
                           nbytes=elementwise_hbm_bytes(
                               n, 4, fmt.container_bytes), x=x)
    x = x.contiguous()
    _build.check_no_grad("quantize_encode", x=x)
    if n == 0:
        return out
    vec, blocks = encode_plan(
        n, fmt.container_bytes,
        x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    LIB.launch("quantize_encode_launch", _build.ptr(x), _build.ptr(out), n,
               fmt.e, fmt.m, _build.fmt_code(fmt), vec, blocks,
               _build.stream_ptr(x.device))
    return out


def dequantize_decode(payload, fmt) -> torch.Tensor:
    """Unpack (e, m) containers to exact f32 values."""
    fmt = get_format(fmt)
    payload = torch.as_tensor(payload)
    where = route(payload)
    if where == "cpu":
        return dequantize_decode_plain(payload, fmt)
    if payload.dtype != fmt.container_dtype:
        raise ValueError(f"dequantize_decode: {fmt.name} payloads are "
                         f"{fmt.container_dtype}, got {payload.dtype}")
    payload = payload.contiguous()
    out = torch.empty(payload.shape, dtype=torch.float32,
                      device=payload.device)
    if where == "meta":
        n = payload.numel()
        return shape_route("dequantize_decode", out, flops=n,
                           nbytes=elementwise_hbm_bytes(
                               n, fmt.container_bytes, 4), payload=payload)
    return _launch("dequantize_decode_launch", payload, out, fmt,
                   fmt.container_bytes)


# the encode kernel's threads a block (csrc/flexfloat_cast.cu, kThreads)
ENCODE_THREADS = 256
# the formats with a kernel of their own (fmt_code 1-4, the paper's)
ENCODE_SPECIALISED = ("binary8", "binary8alt", "binary16", "binary16alt")


def encode_kernel(fmt) -> str:
    """The encode kernel a format takes: its own for the paper's four
    formats, the run-time codec of its container for any other; picked
    by the format alone (``_build.fmt_code``), a fixed choice."""
    code = _build.fmt_code(get_format(fmt))
    return ENCODE_SPECIALISED[code - 1] if 1 <= code <= 4 else "run-time"


def encode_plan(n: int, container_bytes: int, aligned: bool) -> tuple:
    """(vec, blocks) of an encode launch over n elements: vec containers a
    thread with one 16-byte store (0: one element a thread, for a pointer
    that is not 16-byte aligned), and a grid with one thread per vector
    trip or per tail element, whichever are more."""
    vec = 16 // container_bytes if aligned else 0
    items = max(n // vec, n % vec) if vec else n
    return vec, max(1, -(-items // ENCODE_THREADS))


def elementwise_hbm_bytes(n: int, in_bytes: int, out_bytes: int) -> int:
    """Bytes one elementwise pass must move: each input element read once,
    each output element written once."""
    return n * (in_bytes + out_bytes)
