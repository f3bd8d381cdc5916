"""Floating-point format descriptors for the transprecision type system.

The port's copy of ``repro.core.formats``: the paper's four formats
(binary8 1/5/2, binary16 1/5/10, binary16alt 1/8/7, binary32 1/8/23), the
beyond-paper binary8alt (1/4/3), and arbitrary ``flexfloat<e, m>``.

Torch dtypes: binary8 -> ``float8_e5m2``, binary16 -> ``float16``,
binary16alt -> ``bfloat16``, binary32 -> ``float32``.  binary8alt has no
torch dtype: torch's ``float8_e4m3fn`` has no Inf and a max of 448, while
binary8alt is IEEE e4m3 (max 240, with Inf), so binary8alt stays packed
(``native_dtype`` is None).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, order=True)
class FpFormat:
    """An IEEE-754-style binary format with ``e`` exponent and ``m``
    mantissa bits: one sign bit, biased exponent, implicit leading one,
    gradual underflow, +/-Inf and NaN."""

    e: int
    m: int
    name: str = dataclasses.field(default="", compare=False)

    def __post_init__(self):
        if not (1 <= self.e <= 8):
            raise ValueError(f"exponent bits must be in [1, 8], got {self.e}")
        if not (1 <= self.m <= 23):
            raise ValueError(f"mantissa bits must be in [1, 23], got {self.m}")
        if not self.name:
            object.__setattr__(self, "name", f"flexfloat<{self.e},{self.m}>")

    @property
    def bits(self) -> int:
        return 1 + self.e + self.m

    @property
    def bias(self) -> int:
        return (1 << (self.e - 1)) - 1

    @property
    def emax(self) -> int:
        return self.bias

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def max_normal(self) -> float:
        return float((2.0 - 2.0 ** (-self.m)) * 2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.emin)

    @property
    def min_denormal(self) -> float:
        return float(2.0 ** (self.emin - self.m))

    @property
    def precision(self) -> int:
        return self.m + 1

    @property
    def container_dtype(self) -> torch.dtype:
        """Narrowest unsigned integer torch dtype that holds the field."""
        if self.bits <= 8:
            return torch.uint8
        if self.bits <= 16:
            return torch.uint16
        return torch.uint32

    @property
    def container_bytes(self) -> int:
        return self.container_dtype.itemsize

    @property
    def native_dtype(self) -> Optional[torch.dtype]:
        """The torch dtype with identical (e, m) semantics, if one exists."""
        return _NATIVE.get((self.e, self.m))

    @property
    def is_binary32(self) -> bool:
        return self.e == 8 and self.m == 23

    @property
    def exp_mask(self) -> int:
        return ((1 << self.e) - 1) << self.m

    @property
    def mant_mask(self) -> int:
        return (1 << self.m) - 1

    @property
    def sign_mask(self) -> int:
        return 1 << (self.e + self.m)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


_NATIVE = {
    (5, 2): torch.float8_e5m2,
    (5, 10): torch.float16,
    (8, 7): torch.bfloat16,
    (8, 23): torch.float32,
}

BINARY8 = FpFormat(5, 2, "binary8")
BINARY16 = FpFormat(5, 10, "binary16")
BINARY16ALT = FpFormat(8, 7, "binary16alt")
BINARY32 = FpFormat(8, 23, "binary32")

PAPER_FORMATS = (BINARY8, BINARY16, BINARY16ALT, BINARY32)
BY_NAME = {f.name: f for f in PAPER_FORMATS}
BINARY8ALT = FpFormat(4, 3, "binary8alt")
BY_NAME[BINARY8ALT.name] = BINARY8ALT


def get_format(name_or_fmt) -> FpFormat:
    if isinstance(name_or_fmt, FpFormat):
        return name_or_fmt
    if isinstance(name_or_fmt, str):
        if name_or_fmt in BY_NAME:
            return BY_NAME[name_or_fmt]
        if name_or_fmt.startswith("flexfloat<"):
            e, m = name_or_fmt[len("flexfloat<"):-1].split(",")
            return FpFormat(int(e), int(m))
    raise KeyError(f"unknown format {name_or_fmt!r}")


@lru_cache(maxsize=None)
def format_constants(e: int, m: int):
    """Pre-computed constants used by the quantizers (hashable args)."""
    fmt = FpFormat(e, m)
    qe = fmt.emin - fmt.m  # exponent of the smallest denormal quantum
    return dict(
        bias=fmt.bias,
        emax=fmt.emax,
        emin=fmt.emin,
        qe=qe,
        shift=23 - fmt.m,
        max_normal=np.float32(fmt.max_normal),
    )
