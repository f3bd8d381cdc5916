"""Operation / cast / memory-access accounting (paper Figs. 4-6): the
port's copy of ``repro.core.stats`` (plain Python, host integers).

Counters distinguish format x {scalar, vector}: a vector op on an 8-bit
format processes 4 lanes per 32-bit slice-group (2 lanes for 16-bit), and a
vectorized memory access moves a packed 32-bit word -- the two effects that
produce the paper's cycle and memory-access reductions.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Tuple

from .formats import FpFormat


def lanes_of(fmt: FpFormat) -> int:
    return max(1, 32 // fmt.bits)


@dataclasses.dataclass
class OpStats:
    # (fmt_name, vectorized) -> element count
    fp_elems: Dict[Tuple[str, bool], int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    # (fmt_name, vectorized) -> issued instruction count
    fp_instrs: Dict[Tuple[str, bool], int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    # (src_fmt, dst_fmt) -> element count
    casts: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    # (fmt_name, vectorized) -> 32-bit word accesses
    mem_words: Dict[Tuple[str, bool], int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    other_instrs: int = 0  # non-FP core instructions (loop/addr/compare)

    # ---- recording ----------------------------------------------------------
    def fp_op(self, fmt: FpFormat, n: int, vec: bool):
        ln = lanes_of(fmt) if vec else 1
        self.fp_elems[(fmt.name, vec)] += n
        self.fp_instrs[(fmt.name, vec)] += -(-n // ln)

    def cast(self, src: FpFormat, dst: FpFormat, n: int):
        if src.name != dst.name:
            self.casts[(src.name, dst.name)] += n

    def mem(self, fmt: FpFormat, n: int, vec: bool):
        if vec:
            words = -(-n * fmt.bits // 32)
        else:
            words = n  # scalar access moves one (<=32-bit) word per element
        self.mem_words[(fmt.name, vec)] += words

    def other(self, n: int):
        self.other_instrs += n

    # ---- summaries ----------------------------------------------------------
    def total_fp_elems(self) -> int:
        return sum(self.fp_elems.values())

    def fp_elems_by_fmt(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for (name, _v), n in self.fp_elems.items():
            out[name] += n
        return dict(out)

    def narrow_fraction(self) -> float:
        """Fraction of FP operations executed below 32 bit (paper: ~90%)."""
        tot = self.total_fp_elems()
        if not tot:
            return 0.0
        narrow = sum(n for (name, _v), n in self.fp_elems.items()
                     if name != "binary32")
        return narrow / tot

    def vector_fraction(self) -> float:
        tot = self.total_fp_elems()
        if not tot:
            return 0.0
        return sum(n for (_f, v), n in self.fp_elems.items() if v) / tot

    def total_casts(self) -> int:
        return sum(self.casts.values())

    def total_mem_words(self) -> int:
        return sum(self.mem_words.values())

    def merge(self, other: "OpStats"):
        for k, v in other.fp_elems.items():
            self.fp_elems[k] += v
        for k, v in other.fp_instrs.items():
            self.fp_instrs[k] += v
        for k, v in other.casts.items():
            self.casts[k] += v
        for k, v in other.mem_words.items():
            self.mem_words[k] += v
        self.other_instrs += other.other_instrs
