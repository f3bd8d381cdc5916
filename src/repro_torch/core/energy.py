"""Energy and cycle model of the transprecision platform (paper Sec. V):
the port's copy of ``repro.core.energy`` (plain Python).

The paper reports relative results on PULPino + the transprecision FPU in
65 nm; it does not publish a full per-op energy table, so we construct one
from its stated anchors and cited designs, then validate that the emergent
aggregates land on the paper's claims (tests/test_paper_claims.py):

  * ~19.4 pJ/FLOP competitive energy for a 32-bit FPU op (Kaul et al.
    comparison, Sec. II) -> E_fp32 = 20 pJ;
  * narrower slices scale energy with datapath width (Tong/Rzayev refs):
    16-bit ~ 1/2, 8-bit ~ 1/4;
  * a vector op activates all slices of one width: per-instruction energy
    equals the 32-bit op, but 2/4 elements complete per issue;
  * TCDM/SRAM access ~ 12 pJ per 32-bit word in 65 nm; vector accesses move
    packed words;
  * non-FP core instruction (fetch/decode/ALU/agen) ~ 7 pJ;
  * instruction overhead of any FP issue ~ 5 pJ (shared pipeline), which is
    what vectorization amortizes;
  * casts are 1-cycle single-slice ops.

Cycle model (paper Sec. V-A): b32/b16 arithmetic = 1/cycle throughput,
2-cycle latency (the virtual platform measured b16 == b32 cycles); b8 and
all casts = 1 cycle; loads = 1 cycle/word; vector ops = 1 issue.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .formats import BY_NAME, FpFormat, get_format
from .stats import OpStats, lanes_of

# Datapath energy scales with slice width; issue overhead (fetch/decode/
# regfile/pipeline control) does NOT -- so a *scalar* narrow op saves only
# its datapath share, and the real wins come from SIMD (lanes amortize the
# issue) and packed memory words.  This asymmetry is what makes the paper's
# PCA exceed its baseline (scalar narrow ops + many casts) while KNN wins
# big (vectorized binary8).
E_FPU = {8: 6.0, 16: 10.0, 32: 13.0}   # pJ datapath per lane by width
E_ISSUE = 12.0                          # pJ per issued FP instruction
E_MEM_WORD = 12.0                       # pJ per 32-bit TCDM word access
E_OTHER = 7.0                           # pJ per non-FP instruction
E_CAST = 10.0                           # pJ per cast (full slice pass)


@dataclasses.dataclass
class CostReport:
    cycles: float
    energy_pj: float
    energy_fp_pj: float
    energy_mem_pj: float
    energy_other_pj: float
    mem_words: int
    breakdown: Dict[str, float]


def _width(fmt_name: str) -> int:
    return get_format(fmt_name).bits if fmt_name in BY_NAME else 32


def cost(stats: OpStats) -> CostReport:
    e_fp = 0.0
    cycles = 0.0
    # FP arithmetic
    for (fname, vec), n_instr in stats.fp_instrs.items():
        w = _width(fname)
        ln = lanes_of(get_format(fname)) if vec else 1
        e_fp += n_instr * (E_ISSUE + ln * E_FPU[min(32, max(8, w if w in
                                                            (8, 16, 32)
                                                            else 32))])
        cycles += n_instr  # 1/cycle throughput (b32/b16 pipelined; b8 1-cyc)
    # casts: 1 cycle, single slice
    n_casts = stats.total_casts()
    e_fp += n_casts * (E_ISSUE + E_CAST)
    cycles += n_casts
    # memory
    words = stats.total_mem_words()
    e_mem = words * E_MEM_WORD
    cycles += words
    # non-FP
    e_other = stats.other_instrs * E_OTHER
    cycles += stats.other_instrs

    total = e_fp + e_mem + e_other
    return CostReport(
        cycles=cycles, energy_pj=total, energy_fp_pj=e_fp,
        energy_mem_pj=e_mem, energy_other_pj=e_other, mem_words=words,
        breakdown={"fp": e_fp, "mem": e_mem, "other": e_other})


def stream_energy_pj(n_bytes: int) -> float:
    """Energy to stream ``n_bytes`` through the memory port.

    Accesses move packed 32-bit words (the paper's vectorized-memory
    premise), so narrow containers save energy exactly in proportion to
    their byte footprint.  The serve-time tuner prices each candidate
    binding with this: one decode step streams the weight store plus the
    KV working set once.
    """
    return -(-int(n_bytes) // 4) * E_MEM_WORD


def relative(tuned: CostReport, baseline: CostReport) -> Dict[str, float]:
    return {
        "cycles": tuned.cycles / baseline.cycles,
        "energy": tuned.energy_pj / baseline.energy_pj,
        "mem_accesses": tuned.mem_words / baseline.mem_words,
    }
