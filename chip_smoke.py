"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--out DIR] [--phases a,b,...]
                          [--src DIR]

Run from the root of a checkout.  Phases:

1. build       -- compile every CUDA kernel of ``src/repro_torch/csrc``
                  (one nvcc per source, all started together) into
                  ``build/kernels/``.
2. kernels     -- qmm (its tensor-core kernel for the packed formats,
                  its GEMV and qmm_tile for binary32), paged_decode,
                  flash_prefill and flash_decode against their plain
                  PyTorch versions on the card, at the serving path's
                  shapes, at ragged edge shapes and at the widened
                  attention shapes (head_dim 8-256, G 1-16), qmm at every
                  projection, expert block, router and untied head of
                  yi-9b, mistral-nemo-12b, command-r-35b, granite-moe
                  and qwen3-moe, with the stated tolerances; qmm on
                  packed activations bit-identical to qmm on the
                  decoded ones; qmm,
                  flash_decode and paged_decode rows bit-identical
                  whatever rows are beside them, qmm_tile bit-identical
                  to the GEMV; times each kernel, its plain version and
                  a library yardstick (qmm per decode step, per prefill
                  chunk and per verify round, packed and binary32; one
                  qwen3-moe expert launch).
3. casts       -- torch's CUDA f32 -> float8_e5m2 / bfloat16 casts (the
                  KV write and the activation cast) against the plain
                  codec; the three flexfloat_cast kernels bit-identical to
                  the plain codec (every container pattern, 2^24 seeded
                  f32 patterns plus every boundary, the four specialised
                  pack formats and a run-time format of each container,
                  0-d / odd / 3-d / misaligned inputs); the cast kernel on
                  all 2^32 f32 patterns for binary8, binary16,
                  binary16alt and binary8alt, saturate off and on; their
                  times on one llama3-8b FFN weight.
4. ops         -- the ops API (``kernels/ops.py``: pack, unpack, cast,
                  matmul) on a 4096 x 14336 weight, the cast kernels'
                  main path, against its oracle path; the matmul on
                  packed activations of the four paper formats at M = 4
                  and 64, one qmm_tc launch each, timed.
5. serve       -- ``repro_torch.launch.serve.main`` on full-width,
                  full-depth llama3-8b (random weights from the seed),
                  ``--decode-impl paged``, asserting the launch counts per
                  decode step and per prefill chunk (and per qmm kernel:
                  all 193 on tensor cores in both; and 65 rmsnorm).
6. serve_flash -- the same workload under ``--decode-impl flash_pallas``
                  (the serving default on a card): 32 flash_decode and no
                  paged_decode per decode step.
7. speculative -- ``--speculate-k 4`` with the binary8 draft, asserting
                  the launch counts per round and per verify, that no
                  token differs from serve_flash, and that the target as
                  its own draft has every proposal accepted.
8. serve_f32   -- ``--policy binary32``, ``paged``, 2 requests x (128 +
                  8): 193 qmm per decode step on the GEMV, per prefill
                  chunk 192 on qmm_tile and the head on the GEMV.
   serve_reduced -- ``--arch llama3-8b --reduced`` (head_dim 16, G 2)
                  under ``paged`` and ``flash_pallas``: every request gets
                  its tokens, the attention launches go to the CUDA
                  kernels, the first-step logits agree with the plain
                  path; then once under the tuned artifact ``--policy
                  results/tuned/llama3-8b.reduced.json``.
9. logits      -- a prefill chunk, a decode step and a speculative verify
                  step of a 2-layer, full-width model: kernel path against
                  plain path, and verify against sequential decode bit for
                  bit (logits, K/V pool bits, lengths), under binary32 and
                  transprecision, with paged and flash_pallas decode, for
                  llama3-8b and command-r-35b (layernorm, tied head); a
                  2-layer qwen3-moe: kernel path against plain path, and
                  the qmm router's experts equal the plain product's.
10. resilience -- the engine's fault and recovery surface at full width
                  (``run_resilience``): the streamed handoff with the
                  router and two prefill workers, bit for bit the
                  colocated run, without and with a seeded fault plan;
                  binary32 quarantine and replay equal to the engine and
                  to synchronous_generate; the speculative circuit
                  breaker; the CLI's exit codes; rmsnorm rows bit-identical
                  at every row count at d 1024-8192, the kernel against
                  its twin, and its times; layernorm bit-identical to its
                  twin, its rows at every row count at d 8192 and 384,
                  and its times.
11. archs      -- ``serve.main`` on yi-9b, mistral-nemo-12b, command-r-35b,
                  granite-moe-1b-a400m and qwen3-moe-30b-a3b at full width
                  and depth (transprecision, qmm_pallas, flash_pallas, 2 x
                  (64 + 8)), mistral-nemo and granite also under paged:
                  launches per decode step and prefill chunk by kernel,
                  the experts' qmm launches, tok/s, peak memory, the
                  device busy share of a decode step, each model freed
                  before the next.
12. paper      -- the six paper apps on ``TPContext(device="cuda")``:
                  each binary32 baseline, ``tune`` at eps 1e-1, 1e-2 and
                  1e-3 (V2, 2 input sets) with the tuned runs' stats and
                  cost, and PCA's manual_vec runs, all equal to
                  ``results/paper/tuning_cache.json`` (final_error within
                  1e-5 relative); every quantize on the flexfloat_cast
                  kernel (launches per evaluation), none on the plain
                  codec.
13. serve_tune -- ``python -m repro_torch.tuning`` on full-width,
                  full-depth llama3-8b (1 set x 2 prompts x 16 tokens, 2
                  decode positions, 2 KV groups, 1 round, eps 0.1):
                  KL within eps, fewer bytes than binary32, the artifact
                  round-trips, 32 flash_prefill a prefill and 32
                  flash_decode a decode step; then the artifact serves 2
                  requests x (16 + 8) with packed weights.
14. profile    -- short paged and speculative serve runs under
                  torch.profiler: device busy share and the kernels that
                  take the device time; the host syncs of a tiny serve.

``--phases build,timing --src OTHER/src`` times another checkout's
qmm (decode step, prefill chunk, verify round, packed and binary32),
flash_prefill, paged_decode, flash_decode and the three cast kernels
with this script's timing code, e.g. a parent commit unpacked into a
git-ignored directory, to set its kernels beside this checkout's in one
chip call.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
without that line, when there is no CUDA device, when it is not run from
a checkout, when a phase other than profile is left out, or when any
phase fails.  Longer reports go to ``--out`` (default ``chiprun_out/``):
``chip_smoke_report.json``, the serve phases' stats JSONL, ``ptxas.txt``
and the tuned artifact ``serve_tune.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3

# the serve phase's workload: full llama3-8b, 8 requests x (128 prompt
# + 32 new tokens) over 4 slots, capacity 256, page 64
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_MAX_NEW = 8, 4, 128, 32
SERVE_CAPACITY, SERVE_PAGE = 256, 64
NORMS = 65                  # rmsnorm launches a llama3-8b step: 2 x 32 + 1


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of a callable: CUDA events around each call,
    the 50 MB L2 flushed before it, and a ~1 ms device-side sleep queued
    ahead of the first event so the host has enqueued the whole call
    before the device reaches it (the events then see device time only,
    not the Python wrapper's enqueue time).  ``host_us`` measures that
    enqueue time separately."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    def host_us(self, fn, iters: int = 50) -> float:
        """Host microseconds per call to enqueue ``fn`` (the device is
        kept busy by a long sleep, so no call waits for it)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / iters * 1e6


# ---------------------------------------------------------------------------
# phase 1: the tensor-core kernel is compiled to tensor-core instructions
# ---------------------------------------------------------------------------

def check_tc_sass(lib, report):
    """``cuobjdump -sass`` of the built qmm library: every instantiation
    of the tensor-core kernel ``qmm_tc`` must hold HMMA (or HGMMA)
    instructions.  Counts per function go to the report."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib.so_path)],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] = counts.get(fn, 0) + 1
    tc = {f: n for f, n in counts.items() if "qmm_tc" in f}
    ok = bool(tc) and all(n > 0 for n in tc.values())
    report["qmm_tc_sass_hmma"] = tc
    print(f"[build] cuobjdump -sass libqmm.so: {len(tc)} qmm_tc functions, "
          f"HMMA/HGMMA counts {sorted(tc.values())} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_qmm(torch, np, report):
    """qmm against qmatmul_plain, within 1e-6 in units of |x| @ |w| (the
    reference's contract): the serving shapes at M = 1, 4, 16 and 64 (the
    tensor-core kernel for the packed formats), every paper format at
    M = 1, 4 and 64 (binary32 on the GEMV, and on qmm_tile at 64), the
    tensor-core path at M in (9, 16, 17, 33, 100), qmm_tile at M in (9,
    16, 17, 33, 64, 100, 128), ragged K and N with split-K, gated + bias,
    a run-time format and out_fmt; then the error at K = 14336 with and
    without the promotion of the tensor core's partial sums; then rows
    bit-identical whatever M is, for every packed format and binary32,
    and qmm_tile bit-identical to the GEMV over the same rows."""
    from repro_torch.core.formats import (BINARY8, BINARY8ALT, BINARY16,
                                          BINARY16ALT, BINARY32, get_format)
    from repro_torch.core.qtensor import decode
    from repro_torch.kernels import qmatmul as Q

    FLEX69 = get_format("flexfloat<6,9>")
    gen = torch.Generator(device="cuda").manual_seed(report["seed"])

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def pack(w, fmt):
        return _pack_weight(w, fmt)

    worst = 0.0
    worst_tc = 0.0
    worst_tile = 0.0
    tc_units = {}          # worst error in acc units on the tensor cores

    def case(name, M, K, N, fmt, gated=False, bias=False, act=None,
             out_fmt=None, promote=True):
        nonlocal worst, worst_tc, worst_tile
        x = rand(M, K)
        wp = pack(rand(K, N), fmt)
        gp = pack(rand(K, N), fmt) if gated else None
        b = rand(N) if bias else None
        if promote:
            got = Q.qmatmul(x, wp, None, fmt, out_fmt, gate_payload=gp,
                            bias=b, act=act)
        else:
            got = Q._qmm_cuda(x, wp, fmt, out_fmt, gp, b, act,
                              tc_promote=False)
        want = Q.qmatmul_plain(x, wp, None, fmt, out_fmt, gate_payload=gp,
                               bias=b, act=act)
        torch.cuda.synchronize()
        xa = x.abs()
        sh = xa @ decode(wp, fmt).abs() + 1.0
        if b is not None:
            sh = sh + b.abs()
        sg = (xa @ decode(gp, fmt).abs() + 1.0) if gated else 1.0
        if act == "relu2":
            sg = 2.0 * sh   # d(r^2) = 2 r dr: the square doubles the unit
        err = (got - want).abs()
        if out_fmt is not None:
            # the output rounding may flip one out_fmt ulp where the f32
            # sums differ in their last bits: measure in that ulp
            tol = 2.0 ** -out_fmt.m * want.abs() + 1e-6 * sh * sg
        else:
            tol = 1e-6 * sh * sg
        norm = float((err / (sh * sg)).max())
        ok = bool((err <= tol).all())
        tc = Q.qmm_entry(fmt) == "qmm_tc_launch"
        path = Q.qmm_kernel(fmt, M)[4:]
        report["cases"].append(dict(kernel="qmm", case=name, M=M, K=K, N=N,
                                    fmt=fmt.name, gated=gated, act=act,
                                    path=path, promote=promote,
                                    max_abs_err=float(err.max()),
                                    max_err_in_acc_units=norm, ok=ok))
        print(f"[kernels] qmm {name:<28} M={M:<3} K={K:<5} N={N:<6} "
              f"{fmt.name:<11} {path:<9} max|err|={float(err.max()):.3e} "
              f"({norm:.2e} x |x|@|w|, tol 1e-6) {'ok' if ok else 'FAIL'}")
        if out_fmt is None and promote:
            if tc and fmt == BINARY16ALT:
                worst_tc = max(worst_tc, float(err.max()))
            elif path == "tile":
                worst_tile = max(worst_tile, float(err.max()))
            elif not tc:
                worst = max(worst, float(err.max()))
        if tc and promote and out_fmt is None:
            tc_units[fmt.name] = max(tc_units.get(fmt.name, 0.0), norm)
        del x, wp, gp, b, got, want, sh, sg, err
        return ok, norm

    def run(*a, **k):
        return case(*a, **k)[0]

    ok = True
    # the serving path: binary16alt weights on tensor cores, M = 1 (the
    # prefill's head row) / 4 decode, 16 verify and 64 prefill
    for M in (1, 4, 16, 64):
        ok &= run("wq/wo", M, 4096, 4096, BINARY16ALT)
        ok &= run("wk/wv", M, 4096, 1024, BINARY16ALT)
        ok &= run("ffn gated silu", M, 4096, 14336, BINARY16ALT, gated=True,
                  act="silu")
        ok &= run("w_out", M, 14336, 4096, BINARY16ALT)
    ok &= run("head", 4, 4096, 128256, BINARY16ALT)
    ok &= run("head", 16, 4096, 128256, BINARY16ALT)
    # every paper format, plain and gated-silu with bias, edge shapes
    for fmt in (BINARY8, BINARY8ALT, BINARY16, BINARY16ALT, BINARY32):
        for M in (1, 4, 64):
            ok &= run("plain", M, 4096, 4096, fmt)
            ok &= run("gated silu + bias", M, 4096, 1024, fmt, gated=True,
                      bias=True, act="silu")
        ok &= run("ragged", 3, 100, 70, fmt)
        ok &= run("ragged gated silu + bias", 3, 100, 70, fmt, gated=True,
                  bias=True, act="silu")
    # the tensor-core path on each packed format: every tile height, a
    # second row of tiles, ragged M / K / N (unaligned rows load element
    # by element), gated + bias, out_fmt
    for fmt in (BINARY8, BINARY8ALT, BINARY16, BINARY16ALT):
        for M in (9, 16, 17, 33, 100):
            ok &= run("tc rows", M, 4096, 1024, fmt)
        ok &= run("tc gated silu + bias", 33, 4096, 1024, fmt, gated=True,
                  bias=True, act="silu")
        ok &= run("tc ragged", 9, 100, 70, fmt)
        ok &= run("tc ragged split-K", 17, 4100, 1030, fmt, gated=True,
                  bias=True, act="silu")
        ok &= run("tc aligned ragged N", 33, 4096, 1040, fmt)
        ok &= run("tc out_fmt binary16alt", 17, 4100, 1030, fmt, gated=True,
                  act="silu", out_fmt=BINARY16ALT)
    # binary32 above 8 rows: qmm_tile at every tile height, a second row
    # of tiles, gated + bias, ragged M / K / N with split-K (unaligned
    # rows load element by element), and a run-time format (fmt_code 6)
    for M in (9, 16, 17, 33, 64, 100, 128):
        ok &= run("tile rows", M, 4096, 1024, BINARY32)
    for M in (33, 64):
        ok &= run("tile gated silu + bias", M, 4096, 1024, BINARY32,
                  gated=True, bias=True, act="silu")
    ok &= run("tile ragged split-K", 17, 4100, 1030, BINARY32, gated=True,
              bias=True, act="silu")
    ok &= run("tile run-time format", 64, 4096, 1024, FLEX69, gated=True,
              bias=True, act="silu")
    ok &= run("ragged gelu(tanh)", 5, 130, 77, BINARY8, bias=True,
              act="gelu")
    ok &= run("ragged relu2", 33, 100, 70, BINARY16, act="relu2")
    ok &= run("ragged out_fmt binary16alt", 3, 100, 70, BINARY8,
              gated=True, act="silu", out_fmt=BINARY16ALT)
    report["qmm_max_abs_err"] = worst
    report["qmm_tile_max_abs_err"] = worst_tile
    report["qmm_tc_max_abs_err"] = worst_tc
    report["qmm_tc_units_by_fmt"] = tc_units

    # the promotion of the tensor core's sums into FADD, at the longest K
    # of the path (w_out, K = 14336, M = 64); without it is measured, not
    # held to the tolerance
    promo = {}
    for fmt in (BINARY8, BINARY8ALT, BINARY16, BINARY16ALT):
        good, with_p = case("w_out promoted", 64, 14336, 4096, fmt)
        ok &= good
        _, without = case("w_out not promoted (measured)", 64, 14336, 4096,
                          fmt, promote=False)
        promo[fmt.name] = dict(promoted=with_p, not_promoted=without)
    report["qmm_tc_promotion"] = promo
    print(f"[kernels] qmm tensor cores, worst error in units of |x|@|w| "
          f"by format: {tc_units}; at K = 14336 with / without the "
          f"promotion: {promo}")

    # a row's result does not depend on M (the kernel is fixed by the
    # format and its K split by K and N, and each output's sum runs in a
    # fixed order): the first rows of a 128-row input through M = 1 ...
    # 100 are bit-identical to its own rows, as the decode step (4 rows),
    # the verify (16), the chunks (64) and the draft's prompt (128) need
    inv = {}
    for fmt in (BINARY8, BINARY8ALT, BINARY16, BINARY16ALT, BINARY32):
        for name, K, N, gated in (("wq", 4096, 4096, False),
                                  ("ffn gated silu", 4096, 14336, True),
                                  ("w_out", 14336, 4096, False),
                                  ("head", 4096, 128256, False)):
            x = rand(128, K)
            wp = pack(rand(K, N), fmt)
            gp = pack(rand(K, N), fmt) if gated else None
            act = "silu" if gated else None
            full = Q.qmatmul(x, wp, None, fmt, gate_payload=gp, act=act)
            inv[f"{fmt.name} {name}"] = all(torch.equal(
                Q.qmatmul(x[:m].contiguous(), wp, None, fmt,
                          gate_payload=gp, act=act), full[:m])
                for m in ROW_COUNTS)
            del x, wp, gp, full
            torch.cuda.empty_cache()
    ok &= all(inv.values())
    report["qmm_rows_invariant_in_M"] = inv
    print(f"[kernels] qmm rows of a 128-row input bit-identical through "
          f"M = {ROW_COUNTS}: {inv} "
          f"{'ok' if all(inv.values()) else 'FAIL'}")

    # the CUDA-core route's two kernels sum in one order: qmm_tile at its
    # row tile against the GEMV's 8-row blocks over the same rows, bit for
    # bit (ragged and split-K shapes, gated, a run-time format)
    same = {}
    for fmt, M, K, N, gated in ((BINARY32, 64, 4096, 4096, False),
                                (BINARY32, 100, 14336, 4096, False),
                                (BINARY32, 33, 4096, 14336, True),
                                (BINARY32, 17, 4100, 1030, True),
                                (FLEX69, 64, 4096, 1024, True)):
        x = rand(M, K)
        wp = pack(rand(K, N), fmt)
        gp = pack(rand(K, N), fmt) if gated else None
        b = rand(N) if gated else None
        act = "silu" if gated else None
        tile = Q._qmm_cuda(x, wp, fmt, None, gp, b, act)
        gemv = Q._qmm_cuda(x, wp, fmt, None, gp, b, act, tile_m=8)
        same[f"{fmt.name} M={M} K={K} N={N} gated={gated}"] = \
            torch.equal(tile, gemv)
        del x, wp, gp, b, tile, gemv
    ok &= all(same.values())
    report["qmm_tile_equals_gemv"] = same
    print(f"[kernels] qmm_tile bit-identical to the GEMV's 8-row blocks: "
          f"{same} {'ok' if all(same.values()) else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok


def arch_qmm_cases(cfg):
    """The packed products a full-width ``cfg`` serves, as ``(name,
    M values, K, N, gated, binary32)``: the attention projections and
    the dense fused gated FFN with w_out at a decode step's 4 rows and a
    64-row chunk, or the MoE experts' blocks (M = capacity rows: 8 at a
    decode step, 64 in a chunk's worth) and the binary32 router; the
    untied head at M 4 (a tied head is ``torch.matmul``).  Products of
    one shape are one case."""
    d, ff = cfg.d_model, cfg.d_ff
    rows = [("wq", (4, 64), d, cfg.q_dim, False, False),
            ("wk/wv", (4, 64), d, cfg.kv_dim, False, False),
            ("wo", (4, 64), cfg.q_dim, d, False, False)]
    if cfg.moe_experts:
        rows += [("router", (4, 64), d, cfg.moe_experts, False, True),
                 ("expert w_in/w_gate", (8, 64), d, ff, False, False),
                 ("expert w_out", (8, 64), ff, d, False, False)]
    else:
        rows += [("ffn gated silu" if cfg.gated_ffn else "ffn silu",
                  (4, 64), d, ff, cfg.gated_ffn, False),
                 ("w_out", (4, 64), ff, d, False, False)]
    if not cfg.tied_embeddings:
        rows.append(("head", (4,), d, cfg.vocab, False, False))
    cases = {}
    for name, Ms, K, N, gated, f32 in rows:
        key = (Ms, K, N, gated, f32)
        cases[key] = f"{cases[key]}/{name}" if key in cases else name
    return [(name,) + key for key, name in cases.items()]


def check_qmm_archs(torch, report, timer):
    """qmm at the ninth slice's shapes, taken from each full config by
    :func:`arch_qmm_cases`, against qmatmul_plain, within 1e-6 in units
    of |x| @ |w| + 1 (``check_qmm``'s tolerance): every packed product
    of yi-9b, mistral-nemo-12b, command-r-35b, granite-moe and qwen3-moe
    on the tensor cores (binary16alt), and the binary32 routers (K x E)
    on the GEMV (M 4) and ``qmm_tile`` (M 64).  Then one qwen3 expert
    launch (M 8, K 2048, N 768) timed against its bound and
    torch.matmul."""
    from repro_torch import configs
    from repro_torch.core.formats import BINARY16ALT, BINARY32
    from repro_torch.core.qtensor import decode
    from repro_torch.kernels import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 13)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ok, worst, res = True, {"all": 0.0, "expert": 0.0}, {}
    cases = [(arch, name, M, K, N, gated, BINARY32 if f32 else BINARY16ALT)
             for arch in ARCHS
             for name, Ms, K, N, gated, f32 in arch_qmm_cases(
                 configs.get(arch))
             for M in Ms]
    for arch, name, M, K, N, gated, fmt in cases:
        x = rand(M, K)
        wp = _pack_weight(rand(K, N), fmt)
        gp = _pack_weight(rand(K, N), fmt) if gated else None
        act = "silu" if gated else None
        got = Q.qmatmul(x, wp, None, fmt, gate_payload=gp, act=act)
        want = Q.qmatmul_plain(x, wp, None, fmt, gate_payload=gp, act=act)
        xa = x.abs()
        unit = xa @ decode(wp, fmt).abs() + 1.0
        if gated:
            unit = unit * (xa @ decode(gp, fmt).abs() + 1.0)
        err = (got - want).abs()
        norm = float((err / unit).max())
        good = norm <= 1e-6
        ok &= good
        for k in ("all", "expert") if name.startswith("expert") \
                else ("all",):
            worst[k] = max(worst[k], float(err.max()))
        key = f"{arch} {name} M={M} K={K} N={N} {fmt.name}"
        res[key] = norm
        report["cases"].append(dict(kernel="qmm", case=f"{arch} {name}",
                                    M=M, K=K, N=N, fmt=fmt.name,
                                    gated=gated, path=Q.qmm_kernel(fmt, M),
                                    max_abs_err=float(err.max()),
                                    max_err_in_acc_units=norm, ok=good))
        print(f"[kernels] qmm {key:<58} {Q.qmm_kernel(fmt, M):<8} "
              f"max|err|={float(err.max()):.3e} ({norm:.2e} x |x|@|w|, "
              f"tol 1e-6) {'ok' if good else 'FAIL'}")
        del x, wp, gp, got, want, xa, unit, err
    torch.cuda.empty_cache()
    report["qmm_archs_max_abs_err"] = worst["all"]
    report["qmm_expert_max_abs_err"] = worst["expert"]

    qwen3 = configs.get("qwen3-moe-30b-a3b")   # one expert launch, M 8
    M, K, N = 8, qwen3.d_model, qwen3.d_ff
    x = rand(M, K)
    wp = _pack_weight(rand(K, N), BINARY16ALT)
    wf = _unpack_weight(wp, BINARY16ALT)
    t_k = timer(lambda: Q.qmatmul(x, wp, None, BINARY16ALT))
    t_p = timer(lambda: Q.qmatmul_plain(x, wp, None, BINARY16ALT), iters=5)
    t_l = timer(lambda: torch.matmul(x, wf))
    host = timer.host_us(lambda: Q.qmatmul(x, wp, None, BINARY16ALT))
    nbytes = Q.qmm_hbm_bytes(M, K, N, BINARY16ALT)
    bound, by = qmm_bound(Q, BINARY16ALT, nbytes, 2 * M * K * N)
    report["timings"].append(dict(
        kernel="qmm_tc_expert", M=M, K=K, N=N, fmt="binary16alt", ms=t_k,
        plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
        bytes=nbytes, host_us=host))
    print(f"[timing] qmm_tc one qwen3 expert M={M} K={K} N={N} binary16alt: "
          f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  torch.matmul "
          f"{t_l:.4f} ms  bound {bound:.5f} ms ({by})  host {host:.1f} us")
    print(f"[kernels] qmm at the ninth slice's shapes: {len(res)} cases, "
          f"worst {max(res.values()):.2e} x |x|@|w| (tol 1e-6) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


A_FORMATS = ("binary8", "binary8alt", "binary16", "binary16alt")


def check_qmm_packed_a(torch, np, report):
    """qmm on packed activations (``fmt_a``, decoded inside qmm.cu): for
    each of the four paper formats of A, every weight format (the four
    packed ones on the tensor cores, binary32 on the GEMV at M = 4 and on
    qmm_tile at M = 64) and the gated form with bias, the product equals
    the product on the decoded activations bit for bit, and is within
    1e-6 in units of |a| @ |w| of the plain version."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import decode, encode
    from repro_torch.kernels import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 9)
    ok, res = True, {}
    K, N = 4096, 1024
    for wname in A_FORMATS + ("binary32",):
        wf = get_format(wname)
        w = _pack_weight(torch.randn((K, N), generator=gen, device="cuda"),
                         wf)
        g = _pack_weight(torch.randn((K, N), generator=gen, device="cuda"),
                         wf)
        wd, gd = _unpack_weight(w, wf).abs(), _unpack_weight(g, wf).abs()
        bias = torch.randn((N,), generator=gen, device="cuda")
        for aname in A_FORMATS:
            af = get_format(aname)
            for M in (4, 64):
                a = encode(torch.randn((M, K), generator=gen, device="cuda"),
                           af)
                ad = decode(a, af)
                for gated in (False, True):
                    kw = dict(gate_payload=g, bias=bias, act="silu") \
                        if gated else {}
                    got = Q.qmatmul(a, w, af, wf, **kw)
                    same = torch.equal(got, Q.qmatmul(ad, w, None, wf, **kw))
                    want = Q.qmatmul_plain(a, w, af, wf, **kw)
                    unit = ad.abs() @ wd + 1.0
                    if gated:
                        unit = (unit + bias.abs()) * (ad.abs() @ gd + 1.0)
                    err = float(((got - want).abs() / unit).max())
                    good = same and err <= 1e-6
                    ok &= good
                    res[f"{aname} x {wname} M={M}"
                        f"{' gated' if gated else ''}"] = dict(
                            bit_identical=same, err_in_acc_units=err,
                            kernel=Q.qmm_kernel(wf, M), ok=good)
                del a, ad
        del w, g, wd, gd
        torch.cuda.empty_cache()
    report["qmm_packed_a"] = res
    bad = {k: v for k, v in res.items() if not v["ok"]}
    worst = max(v["err_in_acc_units"] for v in res.values())
    print(f"[kernels] qmm packed activations ({', '.join(A_FORMATS)}) x "
          f"every weight format at M = 4 and 64, plain and gated: "
          f"{len(res) - len(bad)} of {len(res)} bit-identical to the "
          f"product on the decoded A and within 1e-6 of the plain version "
          f"(worst {worst:.2e} x |a|@|w|); failing {bad} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


# the row counts a row's result must not depend on: decode steps (1-8
# slots), a verify (B * k), prefill chunks and the draft's prompt (128:
# the whole input, the run every other row count is held to)
ROW_COUNTS = (1, 2, 4, 8, 9, 16, 17, 33, 64, 100, 128)

LLAMA_PROJ = [("wq", 4096, 4096, False), ("wk", 4096, 1024, False),
              ("wv", 4096, 1024, False), ("wo", 4096, 4096, False),
              ("ffn", 4096, 14336, True), ("w_out", 14336, 4096, False)]


def _pack_weight(w, fmt):
    """f32 weights -> ``fmt``'s container: a bitcast through the native
    dtype (binary32 is its own), so no int64 temporaries of the codec
    stand beside a 128256-wide head."""
    from repro_torch.core.qtensor import encode
    if fmt.is_binary32:
        return w.contiguous().view(fmt.container_dtype)
    return encode(w.to(fmt.native_dtype), fmt)


def _unpack_weight(wp, fmt):
    """``_pack_weight``'s inverse: a bitcast for binary32, else the
    codec's exact decode."""
    from repro_torch.core.qtensor import decode
    import torch
    if fmt.is_binary32:
        return wp.view(torch.float32)
    return decode(wp, fmt)


TF32_PEAK_FLOPS = 495e12    # H100 SXM, TF32 on the tensor cores, dense


def qmm_bound(Q, fmt, nbytes, flops):
    """(bound ms, "bytes" or "operations") of one qmm: the larger of its
    bytes over the HBM rate and its operations over the rate of the
    units that keep its precision: binary32 and run-time formats are f32
    products on the CUDA cores (67 TFLOP/s); the packed formats are
    exact in TF32, and the f32 activation takes two TF32 passes on the
    tensor cores (split-TF32, 2 x flops at 495 TFLOP/s)."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if Q.qmm_entry(fmt) == "qmm_tc_launch":
        b_ops = 2 * flops / TF32_PEAK_FLOPS * 1e3
    else:
        b_ops = flops / F32_PEAK_FLOPS * 1e3
    return (b_bytes, "bytes") if b_bytes >= b_ops else (b_ops, "operations")


def time_qmm(torch, np, report, timer):
    """qmm at the main path's shapes, binary16alt weights: per decode step
    (M = 4 slots, 193 launches = 32 x (wq, wk, wv, wo, gated ffn, w_out) +
    the head at N = 128256), per prefill chunk (M = 64, the 192 without
    the head) and per verify round (M = 16, the 193); and binary32 weights
    (the GEMV per decode step, qmm_tile per chunk and per verify).  Each
    shape: kernel, plain version, and torch.matmul on dequantized f32
    weights with TF32 off (timed only, never called by the port); bytes,
    operations and the bound (``qmm_bound``, the larger).  Uses only the
    API every slice of the port has, so ``--src`` can time an earlier
    checkout's kernels at the same shapes."""
    from repro_torch.core.formats import BINARY16ALT, BINARY32
    from repro_torch.kernels import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 8)
    layers = [(n, K, N, g, 32) for n, K, N, g in LLAMA_PROJ]
    head = [("head", 4096, 128256, False, 1)]
    for key, M, fmt, shapes in (
            ("qmm_step", 4, BINARY16ALT, layers + head),
            ("qmm_chunk", 64, BINARY16ALT, layers),
            ("qmm_verify", 16, BINARY16ALT, layers + head),
            ("qmm_step_f32", 4, BINARY32, layers + head),
            ("qmm_chunk_f32", 64, BINARY32, layers),
            ("qmm_verify_f32", 16, BINARY32, layers + head)):
        totals = dict(M=M, fmt=fmt.name, launches=0, ms=0.0, plain_ms=0.0,
                      library_ms=0.0, bytes=0, flops=0)
        for name, K, N, gated, mult in shapes:
            x = torch.randn((M, K), generator=gen, device="cuda")
            wp = _pack_weight(torch.randn((K, N), generator=gen,
                                          device="cuda"), fmt)
            gp = _pack_weight(torch.randn((K, N), generator=gen,
                                          device="cuda"), fmt) \
                if gated else None
            act = "silu" if gated else None
            wf = _unpack_weight(wp, fmt)
            gf = _unpack_weight(gp, fmt) if gated else None
            t_k = timer(lambda: Q.qmatmul(x, wp, None, fmt, gate_payload=gp,
                                          act=act))
            t_p = timer(lambda: Q.qmatmul_plain(x, wp, None, fmt,
                                                gate_payload=gp, act=act),
                        iters=5)
            if gated:
                t_l = timer(lambda: torch.nn.functional.silu(x @ wf)
                            * (x @ gf))
            else:
                t_l = timer(lambda: torch.matmul(x, wf))
            nbytes = Q.qmm_hbm_bytes(M, K, N, fmt, gated=gated)
            flops = 2 * M * K * N * (2 if gated else 1)
            bound, by = qmm_bound(Q, fmt, nbytes, flops)
            report["timings"].append(dict(
                kernel="qmm", per=key, fmt=fmt.name, shape=name, M=M, K=K,
                N=N, launches_per=mult, ms=t_k, plain_ms=t_p,
                library_ms=t_l, bound_ms=bound, bound_by=by, bytes=nbytes,
                flops=flops, f32_floor_ms=flops / F32_PEAK_FLOPS * 1e3))
            print(f"[timing] qmm {key[4:]:<10} {name:<6} M={M:<2} K={K:<5} "
                  f"N={N:<6} {fmt.name:<11} kernel {t_k:.4f} ms  plain "
                  f"{t_p:.4f} ms  torch.matmul {t_l:.4f} ms  bound "
                  f"{bound:.4f} ms ({by})")
            for k, v in (("launches", mult), ("ms", mult * t_k),
                         ("plain_ms", mult * t_p), ("library_ms",
                                                    mult * t_l),
                         ("bytes", mult * nbytes), ("flops", mult * flops)):
                totals[k] += v
            del x, wp, gp, wf, gf
            torch.cuda.empty_cache()
        totals["bound_ms"], totals["bound_by"] = qmm_bound(
            Q, fmt, totals["bytes"], totals["flops"])
        totals["f32_floor_ms"] = totals["flops"] / F32_PEAK_FLOPS * 1e3
        report[key] = totals
        print(f"[timing] qmm per {key[4:]} (M = {M}, {fmt.name}, "
              f"{totals['launches']} launches): kernel {totals['ms']:.3f} ms"
              f"  plain {totals['plain_ms']:.2f} ms  torch.matmul "
              f"{totals['library_ms']:.3f} ms  bound {totals['bound_ms']:.3f}"
              f" ms ({totals['bound_by']})  f32 CUDA-core floor "
              f"{totals['f32_floor_ms']:.3f} ms")


def _paged_inputs(torch, np, fmt, seed, B=4, H=8, G=4, dh=128, page=64,
                  pps=8, lengths=(0, 37, 300, 700)):
    """B ragged sequences over a pool of 64 pages: (at the defaults)
    lengths 0, 37, 300 and one beyond the pps * page capacity; scattered
    pages; -1 table tails; a zero-length row unmapped and a hole inside
    a length."""
    from repro_torch.core.qtensor import encode
    rng = np.random.default_rng(seed)
    num_pages = 64
    q = torch.tensor(rng.normal(size=(B, H, G, dh)), dtype=torch.float32)
    kf = torch.tensor(rng.normal(size=(num_pages, page, H, dh)),
                      dtype=torch.float32)
    vf = torch.tensor(rng.normal(size=(num_pages, page, H, dh)),
                      dtype=torch.float32)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    perm = rng.permutation(num_pages)
    tables = np.full((B, pps), -1, np.int32)
    used = 0
    for b in range(B):
        n = min(-(-int(lengths[b]) // page), pps)
        if used + n > num_pages:
            perm, used = rng.permutation(num_pages), 0
        tables[b, :n] = perm[used:used + n]
        used += n
    if int(lengths[0]) == 0:
        tables[0, 0] = -1      # zero length and unmapped
    holes = [b for b in range(B) if -(-int(lengths[b]) // page) > 3]
    if holes:
        tables[holes[0], 2] = -1   # a hole inside the length: masked
    kp = encode(kf, fmt) if fmt is not None else kf
    vp = encode(vf, fmt) if fmt is not None else vf
    dev = lambda t: t.to("cuda").contiguous()  # noqa: E731
    return (dev(q), dev(kp), dev(vp), dev(lengths),
            dev(torch.tensor(tables)), page)


# paged_decode cases: (fmt name, shape overrides, lengths); None = f32
PAGED_SERVE = dict(B=4, H=8, G=4, dh=128, page=64, pps=8)
PAGED_CASES = (
    [(f, {}, (0, 37, 300, 700)) for f in ("binary8", "binary16alt",
                                          "binary32", None)]
    + [(f, dict(page=16, pps=32), (0, 1, 63, 64, 65, 129, 300, 511))
       for f in ("binary8", "binary16alt", None)]
    + [(f, dict(G=G, dh=dh, page=page, pps=512 // page), lens)
       for f in ("binary8", "binary16alt", None)
       for G, dh in ((2, 16), (10, 256), (2, 256), (10, 16), (4, 8),
                     (1, 24))
       for page, lens in ((16, (0, 17, 200, 511)), (64, (0, 64, 129, 600)))])


def check_paged(torch, np, report, timer):
    """paged_decode against its walk in PyTorch
    (``paged_decode_split_plain``), within 1e-6 on the output and 1e-5 on
    the residuals (m absolute, l relative), and at the serve shape also
    against ``paged_decode_plain`` within 1e-6 (elsewhere that difference,
    the sum of two f32 errors, is measured): the serve shape (H 8, G 4,
    dh 128, page 64) in e5m2, bf16, binary32 and f32; page 16 at ragged
    lengths around the 64-position pieces; head_dim 16 and 256 and G 2
    and 10 (and dh 8 and 24, rows narrower than or not a multiple of 16
    bytes in e5m2) at pages 16 and 64; every case with a zero-length
    unmapped row, a hole inside a length and a length above the
    capacity.  Then a row's bits do not depend on B or on the table's
    width: each row alone, and beside other rows in a wider table, equals
    its row in the batch."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import paged_attention as PA

    ok, worst = True, 0.0
    for fname, shp, lengths in PAGED_CASES:
        fmt = get_format(fname) if fname is not None else None
        kw = dict(PAGED_SERVE, **shp)
        q, kp, vp, lens, tbl, page = _paged_inputs(
            torch, np, fmt, report["seed"], lengths=lengths, B=len(lengths),
            **{k: v for k, v in kw.items() if k != "B"})
        got, gm, gl = PA.paged_decode(q, kp, vp, fmt, lens, tbl,
                                      return_residuals=True)
        twin, tm, tl = PA.paged_decode_split_plain(q, kp, vp, fmt, lens, tbl,
                                                   return_residuals=True)
        want = PA.paged_decode_plain(
            q, kp, vp, fmt, torch.clamp(lens, max=tbl.shape[1] * page), tbl)
        torch.cuda.synchronize()
        err = float((got - twin).abs().max())
        perr = float((got - want).abs().max())
        rerr = max(float((gm - tm).abs().max()),
                   float(((gl - tl).abs() / tl.clamp(min=1.0)).max()))
        zero_ok = all(bool((got[b] == 0).all()) for b in range(len(lengths))
                      if lengths[b] == 0)
        good = err <= 1e-6 and rerr <= 1e-5 and zero_ok
        if not shp:                 # the serve shape: the plain version too
            good &= perr <= 1e-6
        ok &= good
        name = fname or "f32"
        report["cases"].append(dict(kernel="paged_decode", fmt=name,
                                    lengths=list(lengths), **kw,
                                    max_abs_err=err, plain_err=perr,
                                    residual_err=rerr, ok=good))
        print(f"[kernels] paged_decode {name:<11} H={kw['H']} "
              f"G={kw['G']:<2} dh={kw['dh']:<3} page={page:<2} "
              f"lengths={list(lengths)} max|err|={err:.3e} against the "
              f"split twin (tol 1e-6; plain {perr:.1e}"
              f"{', tol 1e-6' if not shp else ', measured'}) residuals "
              f"{rerr:.1e} (tol 1e-5) zero-length rows zero: {zero_ok} "
              f"{'ok' if good else 'FAIL'}")
        worst = max(worst, err)
    report["paged_max_abs_err"] = worst

    from repro_torch.core.formats import BINARY8
    q, kp, vp, lens, tbl, page = _paged_inputs(
        torch, np, BINARY8, report["seed"] + 1, lengths=(1, 64, 144, 300))
    full = PA.paged_decode(q, kp, vp, BINARY8, lens, tbl)
    indep = True
    for b in range(4):
        alone = PA.paged_decode(q[b:b + 1], kp, vp, BINARY8, lens[b:b + 1],
                                tbl[b:b + 1])
        wide = torch.cat([tbl, torch.full_like(tbl, -1)], dim=1)
        other = lens.clone()
        other[torch.arange(4, device="cuda") != b] = torch.tensor(
            [0, 512, 65], dtype=torch.int32, device="cuda")
        beside = PA.paged_decode(q, kp, vp, BINARY8, other, wide)
        indep &= torch.equal(alone[0], full[b]) and torch.equal(beside[b],
                                                                full[b])
    ok &= indep
    report["paged_rows_independent"] = indep
    print(f"[kernels] paged_decode rows bit-identical alone and beside rows "
          f"of other lengths in a wider table: {indep} "
          f"{'ok' if indep else 'FAIL'}")
    return ok


def _prefill_inputs(torch, np, fmt, seed, Skv=256, B=1, Sq=64, H=8, G=4,
                    dh=128):
    from repro_torch.core.qtensor import encode
    rng = np.random.default_rng(seed + 1)
    q = torch.tensor(rng.normal(size=(B, Sq, H, G, dh)), dtype=torch.float32)
    kf = torch.tensor(rng.normal(size=(B, Skv, H, dh)), dtype=torch.float32)
    vf = torch.tensor(rng.normal(size=(B, Skv, H, dh)), dtype=torch.float32)
    kp = encode(kf, fmt) if fmt is not None else kf
    vp = encode(vf, fmt) if fmt is not None else vf
    return q.cuda(), kp.cuda().contiguous(), vp.cuda().contiguous()


def check_prefill(torch, np, report, timer):
    """flash_prefill against flash_prefill_plain, 1e-6 absolute (the
    reference's contract): the serve shape (B 1, Sq 64, H 8, G 4, dh 128,
    Skv 256) at q offsets 0 / 64 / 100, with a window and a prefix, e5m2
    and f32; then B = 2, Sq = 1 / 17 / 100 (row tiles that do not
    divide), q_offset 192, G = 1 / 8 / 32 and dh = 64; then the widened
    shapes: head_dim 16 and 256 at G 2 and 10 in e5m2, bf16 and f32,
    head_dim 8 and 24 in e5m2 (rows narrower than, or not a multiple of,
    16 bytes) and head_dim 40, 72 and 200 (padded widths)."""
    from repro_torch.core.formats import BINARY8, BINARY16ALT
    from repro_torch.kernels import flash_attention as FA

    ok, worst = True, 0.0
    serve = dict(B=1, Sq=64, G=4, dh=128)
    cases = [(BINARY8, 0, None, 0), (BINARY8, 64, None, 0),
             (BINARY8, 100, None, 0), (None, 0, None, 0),
             (None, 64, None, 0), (None, 100, None, 0),
             (BINARY8, 100, 48, 0), (None, 64, None, 16)]
    cases = [(f, q, w, p, serve) for f, q, w, p in cases]
    cases += [(BINARY8, 64, None, 0, dict(serve, B=2)),
              (BINARY8, 100, None, 0, dict(serve, Sq=1)),
              (BINARY8, 0, None, 0, dict(serve, Sq=17)),
              (None, 30, 40, 0, dict(serve, Sq=17)),
              (BINARY8, 0, None, 0, dict(serve, Sq=100)),
              (BINARY8, 192, None, 0, serve),
              (BINARY8, 64, None, 0, dict(serve, G=1)),
              (BINARY16ALT, 64, None, 0, dict(serve, G=8)),
              (BINARY8, 10, None, 8, dict(serve, Sq=17, G=32, dh=64)),
              (BINARY8, 64, None, 0, dict(serve, dh=64)),
              (BINARY16ALT, 100, 48, 0, dict(serve, B=2, Sq=17, dh=64))]
    cases += [(fmt, 64, None, 0, dict(serve, G=G, dh=dh))
              for fmt in (BINARY8, BINARY16ALT, None)
              for G, dh in ((2, 16), (10, 256), (2, 256), (10, 16))]
    cases += [(BINARY8, 100, 48, 0, dict(serve, Sq=17, G=10, dh=256)),
              (None, 30, None, 8, dict(serve, B=2, Sq=17, G=10, dh=16)),
              (BINARY8, 64, None, 0, dict(serve, G=2, dh=8)),
              (BINARY8, 0, None, 0, dict(serve, Sq=17, G=1, dh=24)),
              (BINARY16ALT, 64, None, 0, dict(serve, G=3, dh=40)),
              (None, 64, None, 0, dict(serve, G=5, dh=72)),
              (BINARY8, 64, None, 0, dict(serve, G=16, dh=200))]
    for fmt, q_off, window, prefix, shp in cases:
        q, kp, vp = _prefill_inputs(torch, np, fmt, report["seed"], **shp)
        got = FA.flash_prefill(q, kp, vp, fmt, window=window,
                               prefix_len=prefix, q_offset=q_off)
        want = FA.flash_prefill_plain(q, kp, vp, fmt, window=window,
                                      prefix_len=prefix, q_offset=q_off)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        good = err <= 1e-6
        ok &= good
        name = fmt.name if fmt is not None else "f32"
        report["cases"].append(dict(kernel="flash_prefill", fmt=name,
                                    q_offset=q_off, window=window,
                                    prefix_len=prefix, **shp,
                                    max_abs_err=err, ok=good))
        print(f"[kernels] flash_prefill {name:<11} B={shp['B']} "
              f"Sq={shp['Sq']:<3} G={shp['G']:<2} dh={shp['dh']:<3} Skv=256 "
              f"q_offset={q_off:<3} window={window} prefix={prefix} "
              f"max|err|={err:.3e} (tol 1e-6) {'ok' if good else 'FAIL'}")
        if fmt == BINARY8:
            worst = max(worst, err)
    report["prefill_max_abs_err"] = worst
    return ok


def time_attention(torch, np, report, timer, serve_len):
    """Times at the serving shapes: paged decode of 4 slots holding
    ``serve_len`` tokens; prefill of the second 64-token chunk (q_offset
    64) and of the first (q_offset 0) over a 256-token slot, e5m2 K/V."""
    from repro_torch.core.formats import BINARY8
    from repro_torch.core.qtensor import decode, encode
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    rng = np.random.default_rng(report["seed"] + 2)
    B, H, G, dh, page, pps = 4, 8, 4, 128, 64, 4
    num_pages = B * pps
    q = torch.tensor(rng.normal(size=(B, H, G, dh)), dtype=torch.float32,
                     device="cuda")
    kp = encode(torch.randn(num_pages, page, H, dh, device="cuda"), BINARY8)
    vp = encode(torch.randn(num_pages, page, H, dh, device="cuda"), BINARY8)
    tables = torch.tensor(rng.permutation(num_pages).reshape(B, pps),
                          dtype=torch.int32, device="cuda")
    lens = torch.full((B,), serve_len, dtype=torch.int32, device="cuda")
    t_k = timer(lambda: PA.paged_decode(q, kp, vp, BINARY8, lens, tables))
    t_p = timer(lambda: PA.paged_decode_plain(q, kp, vp, BINARY8, lens,
                                              tables), iters=10)
    host = timer.host_us(lambda: PA.paged_decode(q, kp, vp, BINARY8, lens,
                                                 tables))
    nbytes = PA.paged_hbm_bytes([serve_len] * B, H, dh, BINARY8,
                                page_size=page, g=G)
    flops = 4 * dh * H * G * serve_len * B     # q.k and p.v, 2 ops each
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    report["timings"].append(dict(
        kernel="paged_decode", B=B, length=serve_len, ms=t_k, plain_ms=t_p,
        library_ms=None, bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bytes=nbytes, flops=flops, host_us=host))
    print(f"[timing] paged_decode B=4 len={serve_len} kernel {t_k:.4f} ms  "
          f"plain {t_p:.4f} ms  bound {max(b_bytes, b_ops):.6f} ms  host "
          f"{host:.1f} us/call")

    Sq, Skv = 64, 256
    qq = torch.randn(1, Sq, H, G, dh, device="cuda")
    kc = encode(torch.randn(1, Skv, H, dh, device="cuda"), BINARY8)
    vc = encode(torch.randn(1, Skv, H, dh, device="cuda"), BINARY8)
    kd, vd = decode(kc, BINARY8), decode(vc, BINARY8)
    qs = qq.reshape(1, Sq, H * G, dh).transpose(1, 2)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    for q_off in (64, 0):
        t_fk = timer(lambda: FA.flash_prefill(qq, kc, vc, BINARY8,
                                              q_offset=q_off))
        t_fp = timer(lambda: FA.flash_prefill_plain(qq, kc, vc, BINARY8,
                                                    q_offset=q_off),
                     iters=10)
        # library yardstick: SDPA on dequantized K/V with the same mask
        mask = FA.prefill_mask(Sq, Skv, q_off, None, 0, "cuda")
        t_fl = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask))
        host = timer.host_us(lambda: FA.flash_prefill(qq, kc, vc, BINARY8,
                                                      q_offset=q_off))
        live = sum(q_off + i + 1 for i in range(Sq))  # keys each query needs
        flops = 4 * dh * H * G * live
        nbytes = FA.prefill_hbm_bytes(1, Sq, q_off + Sq, H, G, dh, BINARY8)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / F32_PEAK_FLOPS * 1e3
        report["timings"].append(dict(
            kernel="flash_prefill", Sq=Sq, Skv=Skv, q_offset=q_off, ms=t_fk,
            plain_ms=t_fp, library_ms=t_fl, bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            bytes=nbytes, flops=flops, host_us=host))
        print(f"[timing] flash_prefill Sq=64 Skv=256 q_offset={q_off:<2} "
              f"kernel {t_fk:.4f} ms  plain {t_fp:.4f} ms  SDPA {t_fl:.4f} "
              f"ms  bound {max(b_bytes, b_ops):.5f} ms  host {host:.1f} "
              f"us/call")


def _decode_inputs(torch, np, fmt, seed, S, lengths, G=4, dh=128):
    """The serve shape's gathered cache: B = 4 sequences, H = 8 KV heads,
    G = 4, dh = 128, K/V (4, S, 8, 128) packed or f32 (or another G and
    dh)."""
    from repro_torch.core.qtensor import encode
    rng = np.random.default_rng(seed)
    B, H = len(lengths), 8
    q = torch.tensor(rng.normal(size=(B, H, G, dh)), dtype=torch.float32)
    kf = torch.tensor(rng.normal(size=(B, S, H, dh)), dtype=torch.float32)
    vf = torch.tensor(rng.normal(size=(B, S, H, dh)), dtype=torch.float32)
    kp = encode(kf, fmt) if fmt is not None else kf
    vp = encode(vf, fmt) if fmt is not None else vf
    return (q.cuda(), kp.cuda().contiguous(), vp.cuda().contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def check_flash_decode(torch, np, report):
    """flash_decode against flash_decode_plain at the serve shape (S =
    256: 4 pages of 64 gathered, lengths around 144) for e5m2, bf16 and
    f32, at ragged lengths (0, 1, each edge of the kernel's 64-position
    pieces -1 / +0 / +1, S), and at the edges: a length above S, S = 200
    (not a multiple of a piece), and at the widened shapes (head_dim 16
    and 256 at G 2 and 10, head_dim 8 and 24 in e5m2); residuals (m, l)
    on every case, and the kernel's walk in PyTorch
    (``flash_decode_split_plain``) beside it.  At the widened shapes the
    kernel is held to the split twin (whose scores are summed in f64) and
    its difference from the plain version, the sum of two f32 errors, is
    measured.
    Tolerance 1e-6 absolute on the output, the reference's contract; 1e-5
    on m and relative 1e-5 on l.  Then a row's bits do not depend on the
    rows beside it: each row of the serve shape alone, and beside rows of
    other lengths, equals its row in the batch."""
    from repro_torch.core.formats import BINARY8, BINARY16ALT
    from repro_torch.kernels import flash_attention as FA

    ok, worst = True, 0.0
    serve = dict(G=4, dh=128)
    cases = [(fmt, 256, [141, 144, 147, 150], serve) for fmt in
             (BINARY8, BINARY16ALT, None)]
    cases += [(fmt, 256, lengths, serve) for fmt in (BINARY8, None)
              for lengths in ([0, 1, 63, 64], [65, 127, 128, 129],
                              [191, 192, 193, 256])]
    cases += [(BINARY8, 256, [0, 144, 256, 999], serve),
              (BINARY8, 200, [0, 1, 199, 300], serve),
              (None, 200, [64, 65, 128, 200], serve)]
    cases += [(fmt, 256, [0, 17, 144, 300], dict(G=G, dh=dh))
              for fmt in (BINARY8, BINARY16ALT, None)
              for G, dh in ((2, 16), (10, 256), (2, 256), (10, 16))]
    cases += [(BINARY8, 200, [0, 1, 65, 199], dict(G=4, dh=8)),
              (BINARY8, 256, [0, 64, 129, 256], dict(G=1, dh=24)),
              (BINARY16ALT, 256, [5, 63, 128, 256], dict(G=16, dh=200))]
    for fmt, S, lengths, shp in cases:
        q, kp, vp, lens = _decode_inputs(torch, np, fmt, report["seed"] + 3,
                                         S, lengths, **shp)
        got, gm, gl = FA.flash_decode(q, kp, vp, fmt, lens,
                                      return_residuals=True)
        want, wm, wl = FA.flash_decode_plain(
            q, kp, vp, fmt, torch.clamp(lens, max=S), return_residuals=True)
        twin = FA.flash_decode_split_plain(q, kp, vp, fmt, lens)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        terr = float((got - twin).abs().max())
        rerr = max(float((gm - wm).abs().max()),
                   float(((gl - wl).abs() / wl.clamp(min=1.0)).max()))
        zero_ok = all(bool((got[b] == 0).all()) for b in range(4)
                      if lengths[b] == 0)
        good = terr <= 1e-6 and rerr <= 1e-5 and zero_ok
        if shp == serve:            # the serve shape: the plain version too
            good &= err <= 1e-6
        ok &= good
        name = fmt.name if fmt is not None else "f32"
        report["cases"].append(dict(kernel="flash_decode", fmt=name, S=S,
                                    lengths=lengths, **shp, max_abs_err=err,
                                    twin_err=terr, residual_err=rerr,
                                    ok=good))
        print(f"[kernels] flash_decode {name:<11} B=4 H=8 G={shp['G']:<2} "
              f"dh={shp['dh']:<3} S={S} "
              f"lengths={lengths} max|err|={err:.3e} "
              f"({'tol 1e-6' if shp == serve else 'measured'}; against "
              f"the split twin {terr:.1e}, tol 1e-6) residuals {rerr:.1e} "
              f"(tol 1e-5) {'ok' if good else 'FAIL'}")
        worst = max(worst, terr)
    report["flash_decode_max_abs_err"] = worst

    q, kp, vp, lens = _decode_inputs(torch, np, BINARY8, report["seed"] + 3,
                                     256, [1, 64, 144, 256])
    full = FA.flash_decode(q, kp, vp, BINARY8, lens)
    indep = True
    for b in range(4):
        alone = FA.flash_decode(q[b:b + 1], kp[b:b + 1], vp[b:b + 1],
                                BINARY8, lens[b:b + 1])
        other = lens.clone()
        other[torch.arange(4, device="cuda") != b] = torch.tensor(
            [0, 256, 65], dtype=torch.int32, device="cuda")
        beside = FA.flash_decode(q, kp, vp, BINARY8, other)
        indep &= torch.equal(alone[0], full[b]) and torch.equal(beside[b],
                                                                full[b])
    ok &= indep
    report["flash_decode_rows_independent"] = indep
    print(f"[kernels] flash_decode rows bit-identical alone and beside rows "
          f"of other lengths: {indep} {'ok' if indep else 'FAIL'}")
    return ok


def time_flash_decode(torch, np, report, timer, serve_len):
    """flash_decode at the serve shape: 4 slots holding ``serve_len``
    tokens in a gathered 256-token cache, e5m2; yardstick SDPA on the
    dequantized K/V with the length mask (timed only, never called by
    the port)."""
    from repro_torch.core.formats import BINARY8
    from repro_torch.core.qtensor import decode
    from repro_torch.kernels import flash_attention as FA

    B, H, G, dh, S = 4, 8, 4, 128, 256
    q, kp, vp, lens = _decode_inputs(torch, np, BINARY8, report["seed"] + 4,
                                     S, [serve_len] * B)
    t_k = timer(lambda: FA.flash_decode(q, kp, vp, BINARY8, lens))
    t_p = timer(lambda: FA.flash_decode_plain(q, kp, vp, BINARY8, lens),
                iters=10)
    kd, vd = decode(kp, BINARY8), decode(vp, BINARY8)
    qs = q.reshape(B, H * G, 1, dh)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[
        :, None, None, :]
    t_l = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    host = timer.host_us(lambda: FA.flash_decode(q, kp, vp, BINARY8, lens))
    nbytes = FA.decode_hbm_bytes([serve_len] * B, S, H, dh, BINARY8, g=G)
    flops = 4 * dh * H * G * serve_len * B
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    report["timings"].append(dict(
        kernel="flash_decode", B=B, S=S, length=serve_len, ms=t_k,
        plain_ms=t_p, library_ms=t_l, bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bytes=nbytes, flops=flops, host_us=host))
    print(f"[timing] flash_decode B=4 S=256 len={serve_len} kernel "
          f"{t_k:.4f} ms  plain {t_p:.4f} ms  SDPA {t_l:.4f} ms  bound "
          f"{max(b_bytes, b_ops):.6f} ms  host {host:.1f} us/call")


def time_kernels(torch, np, report, timer):
    """qmm, paged_decode, flash_prefill and flash_decode at the serving
    shapes (the kernels phase, and alone for ``--src``)."""
    serve_len = SERVE_PROMPT + SERVE_MAX_NEW // 2
    time_qmm(torch, np, report, timer)
    time_attention(torch, np, report, timer, serve_len)
    time_flash_decode(torch, np, report, timer, serve_len)


# ---------------------------------------------------------------------------
# phases 3-4: casts and the ops path
# ---------------------------------------------------------------------------

def _boundaries(torch, fmt):
    """Every pattern of a <= 17-bit format as f32, the midpoints between
    neighbours (round-to-even ties) and one f32 ulp either side of each."""
    from repro_torch.core.qtensor import decode
    n = 1 << fmt.bits
    vals = decode(torch.arange(n, dtype=torch.int64).to(
        fmt.container_dtype), fmt).cuda()
    fin = vals[torch.isfinite(vals)].double().unique()
    mids = ((fin[1:] + fin[:-1]) / 2).float()
    top = torch.tensor([fmt.max_normal * (1 + 2.0 ** -(fmt.m + 1))],
                       dtype=torch.float64, device="cuda").float()
    base = torch.cat([vals, mids, top, -top])
    up = torch.nextafter(base, torch.full_like(base, float("inf")))
    dn = torch.nextafter(base, torch.full_like(base, -float("inf")))
    return torch.cat([base, up, dn])


def check_casts(torch, np, report):
    from repro_torch.core.formats import BINARY8, BINARY16ALT
    from repro_torch.kernels.flexfloat_cast import (dequantize_decode_plain
                                                    as decode,
                                                    quantize_encode_plain
                                                    as encode)

    rng = np.random.default_rng(report["seed"])
    bits = rng.integers(0, 1 << 32, size=1 << 24, dtype=np.uint64)
    rand = torch.from_numpy(bits.astype(np.int64)).cuda()
    rand = torch.where(rand >= (1 << 31), rand - (1 << 32), rand)
    rand = rand.to(torch.int32).view(torch.float32)
    # f32 subnormals and the targets' subnormal ranges, densely
    sub = torch.from_numpy(rng.integers(0, 1 << 23, size=1 << 20,
                                        dtype=np.int64)).cuda()
    sub = sub.to(torch.int32).view(torch.float32)
    ok = True
    for fmt, dt in ((BINARY8, torch.float8_e5m2),
                    (BINARY16ALT, torch.bfloat16)):
        x = torch.cat([rand, sub, -sub, _boundaries(torch, fmt),
                       _boundaries(torch, BINARY8)])
        nan = torch.isnan(x)
        # compare as int64 (CUDA has no indexing on uint16)
        got = x.to(dt).view(fmt.container_dtype).to(torch.int64)
        want = encode(x, fmt).to(torch.int64)
        mism = int(((got != want) & ~nan).sum())
        nan_ok = bool(torch.isnan(decode(got[nan], fmt)).all())
        nan_payload = int((got[nan] != want[nan]).sum())
        good = mism == 0 and nan_ok
        ok &= good
        report["casts"].append(dict(
            target=str(dt), inputs=int(x.numel()), non_nan_mismatches=mism,
            nan_inputs=int(nan.sum()), nan_stays_nan=nan_ok,
            nan_payload_differs=nan_payload, ok=good))
        print(f"[casts] f32 -> {str(dt):<20} {x.numel()} inputs: "
              f"{mism} mismatches on non-NaN inputs; NaN -> NaN: {nan_ok} "
              f"(payload differs from the codec's on {nan_payload} of "
              f"{int(nan.sum())} NaNs) {'ok' if good else 'FAIL'}")
    return ok


# the four pack kernels of their own, and a run-time format of each
# container (u8, u16, u32)
CAST_FORMATS = ("binary8", "binary8alt", "binary16", "binary16alt",
                "flexfloat<3,4>", "flexfloat<6,9>", "flexfloat<5,11>")


def _seeded_f32(torch, np, seed, n):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    t = torch.from_numpy(bits.astype(np.int64)).cuda()
    t = torch.where(t >= (1 << 31), t - (1 << 32), t)
    return t.to(torch.int32).view(torch.float32)


def _mismatches(a, b) -> int:
    """Elements whose bits differ (f32 compared as bit patterns, so NaN
    is held to the codec's canonical NaN bit for bit)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a.to(torch.int64) != b.to(torch.int64)).sum())


def check_cast_kernels(torch, np, report):
    """The three flexfloat_cast kernels bit-identical to the plain codec:
    every container pattern (2^8, 2^16, 2^17) through unpack and
    pack(unpack); 2^24 seeded f32 patterns plus every boundary of the
    format through cast (with and without saturate) and pack; for the
    four formats with a pack kernel of their own and a run-time format
    of each container (``CAST_FORMATS``); on the flat array, a 0-d, an
    odd 1-d, a 3-d input and a misaligned view (the scalar path)."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import flexfloat_cast as FF

    rand = _seeded_f32(torch, np, report["seed"] + 5, 1 << 24)
    ok = True
    for name in CAST_FORMATS:
        fmt = get_format(name)
        pats = torch.arange(1 << fmt.bits, dtype=torch.int64,
                            device="cuda").to(fmt.container_dtype)
        x = torch.cat([rand, _boundaries(torch, fmt)])
        views = {"flat": x, "0-d": x[5].reshape(()),
                 "1-d odd": x[:100_003], "3-d": x[:3 * 1021 * 7].reshape(
                     3, 1021, 7), "misaligned": x[1:77_778]}
        res = {}
        un = FF.dequantize_decode(pats, fmt)
        res["unpack patterns"] = _mismatches(
            un, FF.dequantize_decode_plain(pats, fmt))
        res["pack(unpack) patterns"] = _mismatches(
            FF.quantize_encode(un, fmt), FF.quantize_encode_plain(un, fmt))
        for vname, xv in views.items():
            for sat in (False, True):
                res[f"cast sat={sat} {vname}"] = _mismatches(
                    FF.flexfloat_cast(xv, fmt, saturate=sat),
                    FF.flexfloat_cast_plain(xv, fmt, saturate=sat))
            res[f"pack {vname}"] = _mismatches(
                FF.quantize_encode(xv, fmt),
                FF.quantize_encode_plain(xv, fmt))
        res["unpack misaligned"] = _mismatches(
            FF.dequantize_decode(pats[3:], fmt),
            FF.dequantize_decode_plain(pats[3:], fmt))
        torch.cuda.synchronize()
        bad = {k: v for k, v in res.items() if v}
        good = not bad
        ok &= good
        kern = FF.encode_kernel(fmt) if hasattr(FF, "encode_kernel") \
            else None
        report["cast_kernels"].append(dict(
            fmt=name, f32_inputs=int(x.numel()), patterns=1 << fmt.bits,
            encode_kernel=kern, mismatches=res, ok=good))
        print(f"[casts] flexfloat_cast/encode/decode kernels {name:<15} "
              f"(pack kernel: {kern}) "
              f"{x.numel()} f32 inputs + {1 << fmt.bits} patterns, "
              f"{len(res)} checks: "
              + ("0 mismatches ok" if good else f"mismatches {bad} FAIL"))
        del x, pats, un
    torch.cuda.empty_cache()
    return ok


# the 2^32 sweep: the paper's 8- and 16-bit formats, chunks of 2^28 f32
SWEEP_FORMATS = ("binary8", "binary16", "binary16alt", "binary8alt")
SWEEP_CHUNK = 1 << 28


def check_cast_sweep(torch, report):
    """flexfloat_cast bit-identical to flexfloat_cast_plain on every one of
    the 2^32 f32 bit patterns, for ``SWEEP_FORMATS``, with saturate off
    and on (NaN held to the codec's canonical NaN bit for bit): each chunk
    of 2^28 patterns made on the card once and cast 8 ways."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import flexfloat_cast as FF

    fmts = [get_format(n) for n in SWEEP_FORMATS]
    mism = {f"{f.name} sat={sat}": 0 for f in fmts for sat in (False, True)}
    t0 = time.perf_counter()
    for start in range(0, 1 << 32, SWEEP_CHUNK):
        u = torch.arange(start, start + SWEEP_CHUNK, dtype=torch.int64,
                         device="cuda")
        x = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
        del u
        x = x.view(torch.float32)
        for fmt in fmts:
            for sat in (False, True):
                got = FF.flexfloat_cast(x, fmt, saturate=sat)
                want = FF.flexfloat_cast_plain(x, fmt, saturate=sat)
                mism[f"{fmt.name} sat={sat}"] += int(
                    (got.view(torch.int32) != want.view(torch.int32)).sum())
                del got, want
        del x
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ok = not any(mism.values())
    report["cast_sweep"] = dict(patterns=1 << 32, formats=list(SWEEP_FORMATS),
                                mismatches=mism, seconds=secs, ok=ok)
    print(f"[casts] flexfloat_cast on all 2^32 f32 patterns x "
          f"{', '.join(SWEEP_FORMATS)} x saturate off/on against "
          f"flexfloat_cast_plain: mismatches {mism} in {secs:.1f} s "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def time_cast_kernels(torch, np, report, timer):
    """cast, pack and unpack of one llama3-8b FFN weight (4096 x 14336
    f32) to binary16alt and binary8, beside the byte bound; the yardstick
    is torch's own cast where a torch dtype is the same format (bf16, f16,
    e5m2; binary8alt has none)."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import flexfloat_cast as FF

    gen = torch.Generator(device="cuda").manual_seed(report["seed"])
    w = torch.randn((4096, 14336), generator=gen, device="cuda")
    n = w.numel()
    for name in ("binary16alt", "binary8", "binary16", "binary8alt"):
        fmt = get_format(name)
        nat = fmt.native_dtype
        p = FF.quantize_encode(w, fmt)
        cb = fmt.container_bytes
        rows = (("flexfloat_cast", lambda: FF.flexfloat_cast(w, fmt),
                 lambda: FF.flexfloat_cast_plain(w, fmt),
                 (lambda: w.to(nat).float()) if nat is not None else None,
                 4, 4),
                ("quantize_encode", lambda: FF.quantize_encode(w, fmt),
                 lambda: FF.quantize_encode_plain(w, fmt),
                 (lambda: w.to(nat)) if nat is not None else None, 4, cb),
                ("dequantize_decode", lambda: FF.dequantize_decode(p, fmt),
                 lambda: FF.dequantize_decode_plain(p, fmt),
                 (lambda: p.view(nat).float()) if nat is not None else None,
                 cb, 4))
        for kname, kern, plain, lib, ib, ob in rows:
            t_k = timer(kern)
            t_p = timer(plain, iters=3, warmup=1)
            t_l = timer(lib) if lib is not None else None
            nbytes = FF.elementwise_hbm_bytes(n, ib, ob)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            report["timings"].append(dict(
                kernel=kname, fmt=name, shape=[4096, 14336], ms=t_k,
                plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                bound_by="bytes", bytes=nbytes))
            print(f"[timing] {kname:<17} {name:<11} 4096x14336 kernel "
                  f"{t_k:.4f} ms  plain {t_p:.4f} ms  torch cast "
                  + (f"{t_l:.4f} ms" if t_l is not None else "none")
                  + f"  bound {bound:.4f} ms")
        del p
    del w
    torch.cuda.empty_cache()


def run_ops(torch, np, report, libs):
    """The ops path (``kernels/ops.py``, the reference's entry point to
    the cast kernels, with ``use_pallas=True`` as its default): pack one
    llama3-8b FFN weight (4096 x 14336) to binary16alt, unpack it, cast
    the activations of a 4-slot decode step, and multiply; each result
    against the oracle path (``use_pallas=False``): the casts bit for
    bit, the product within 1e-6 in units of |a| @ |w|."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 6)
    w = torch.randn((4096, 14336), generator=gen, device="cuda")
    a = torch.randn((4, 4096), generator=gen, device="cuda")
    for lib in libs:
        lib.reset_counts()              # counts of the ops path only
    wp = ops.pack(w, "binary16alt")
    wd = ops.unpack(wp, "binary16alt")
    ac = ops.cast(a, "binary16alt", saturate=True)
    y = ops.matmul(ac, wp, None, "binary16alt")
    torch.cuda.synchronize()
    counts = {lib.name: dict(lib.by_symbol) for lib in libs}
    res = {
        "pack": _mismatches(wp, ops.pack(w, "binary16alt", use_pallas=False)),
        "unpack": _mismatches(wd, ops.unpack(wp, "binary16alt",
                                             use_pallas=False)),
        "cast": _mismatches(ac, ops.cast(a, "binary16alt", saturate=True,
                                         use_pallas=False)),
    }
    want = ops.matmul(ac, wp, None, "binary16alt", use_pallas=False)
    unit = ac.abs() @ wd.abs() + 1.0
    mm_err = float(((y - want).abs() / unit).max())
    ff = counts["flexfloat_cast"]
    launched = (ff.get("flexfloat_cast_launch", 0) == 1
                and ff.get("quantize_encode_launch", 0) == 1
                and ff.get("dequantize_decode_launch", 0) == 1
                and counts["qmm"].get("qmm_tc_launch", 0) == 1
                and counts["qmm"].get("qmm_launch", 0) == 0)
    ok = not any(res.values()) and mm_err <= 1e-6 and launched
    report["ops"] = dict(launches=counts, mismatches=res,
                         matmul_err_in_acc_units=mm_err, ok=ok)
    print(f"[ops] pack/unpack/cast/matmul on a 4096x14336 weight: "
          f"mismatches {res}, matmul {mm_err:.2e} x |a|@|w| (tol 1e-6), "
          f"launches {counts} {'ok' if ok else 'FAIL'}")
    ok &= run_ops_packed_a(torch, report, libs, gen, wp, wd)
    del w, a, wp, wd, y, want, unit
    torch.cuda.empty_cache()
    return ok


def run_ops_packed_a(torch, report, libs, gen, wp, wd):
    """The ops path's matmul on packed activations (the reference's
    ``fmt_a``): for each paper format of A at M = 4 and 64 against the
    binary16alt 4096 x 14336 weight, the product is bit-identical to the
    product on the decoded A and within 1e-6 in units of |a| @ |w| of the
    oracle path; each call is one launch of qmm_tc (counted by kernel,
    the pack and unpack around it not counted); then the packed-A calls
    are timed beside the f32-A call at the same shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as Q

    timer = Timer(torch)
    ok, rows = True, {}
    for aname in A_FORMATS:
        for M in (4, 64):
            ap = ops.pack(torch.randn((M, 4096), generator=gen,
                                      device="cuda"), aname)
            torch.cuda.synchronize()
            for lib in libs:
                lib.reset_counts()
            y = ops.matmul(ap, wp, aname, "binary16alt")
            torch.cuda.synchronize()
            launches = dict(libs[0].by_kernel)
            total = sum(lib.launches for lib in libs)
            ad = ops.unpack(ap, aname)
            same = torch.equal(y, ops.matmul(ad, wp, None, "binary16alt"))
            want = ops.matmul(ap, wp, aname, "binary16alt", use_pallas=False)
            err = float(((y - want).abs() / (ad.abs() @ wd.abs()
                                               + 1.0)).max())
            abs_err = float((y - want).abs().max())
            good = same and err <= 1e-6 and launches == {"qmm_tc": 1} \
                and total == 1
            ok &= good
            t = timer(lambda: ops.matmul(ap, wp, aname, "binary16alt"))
            t_f32 = timer(lambda: ops.matmul(ad, wp, None, "binary16alt"))
            t_plain = timer(lambda: ops.matmul(ap, wp, aname, "binary16alt",
                                               use_pallas=False), iters=5)
            nbytes = 4096 * 14336 * 2 + ap.numel() * ap.element_size() \
                + M * 14336 * 4
            bound, by = qmm_bound(Q, Q.get_format("binary16alt"), nbytes,
                                  2 * M * 4096 * 14336)
            rows[f"{aname} M={M}"] = dict(
                bit_identical=same, err_in_acc_units=err, max_abs_err=abs_err,
                launches=launches,
                ms=t, f32_a_ms=t_f32, plain_ms=t_plain, bound_ms=bound,
                bound_by=by, ok=good)
            print(f"[ops] matmul packed A {aname:<11} M={M:<2} x binary16alt "
                  f"4096x14336: bit-identical to the decoded A {same}, "
                  f"{err:.2e} x |a|@|w| (tol 1e-6), launches {launches}; "
                  f"{t:.4f} ms (f32 A {t_f32:.4f} ms, plain {t_plain:.3f} "
                  f"ms, bound {bound:.4f} ms) {'ok' if good else 'FAIL'}")
            if aname == "binary8" and M == 64:
                report["timings"].append(dict(
                    kernel="qmm_packed_a", fmt_a=aname, M=M, ms=t,
                    plain_ms=t_plain, library_ms=None, bound_ms=bound,
                    bound_by=by, bytes=nbytes, f32_a_ms=t_f32))
            del ap, ad, y, want
    report["ops_packed_a"] = rows
    report["ops_packed_a_launches"] = sum(
        r["launches"].get("qmm_tc", 0) for r in rows.values())
    report["qmm_packed_a_max_abs_err"] = max(r["max_abs_err"]
                                            for r in rows.values())
    return ok


# ---------------------------------------------------------------------------
# phases 5-7: serve, serve_flash, speculative
# ---------------------------------------------------------------------------

def _serve_argv(args, decode_impl, requests, max_new, stats, extra=(),
                policy="transprecision"):
    return ["--arch", "llama3-8b", "--policy", policy,
            "--decode-impl", decode_impl, "--matmul-impl", "qmm_pallas",
            "--page-size", str(SERVE_PAGE), "--requests", str(requests),
            "--slots", str(SERVE_SLOTS), "--prompt-len", str(SERVE_PROMPT),
            "--max-new", str(max_new), "--capacity", str(SERVE_CAPACITY),
            "--seed", str(args.seed), "--stats-out",
            os.path.join(args.out, stats), *extra]


QMM_KERNELS = ("qmm_gemv", "qmm_tile", "qmm_tc")


def _qmm_kernels(lib, before=None):
    """qmm launches by kernel (``QMM_KERNELS`` order), less ``before``."""
    now = tuple(lib.by_kernel.get(k, 0) for k in QMM_KERNELS)
    return now if before is None else tuple(a - b for a, b in
                                            zip(now, before))


def _drive_serve(torch, libs, argv, hooks, params=None):
    """``serve.main(argv)`` with every launch count set to 0 just before
    and read just after, and the launches of each call of each hooked
    method ``hooks[name] = (class, attribute)`` recorded as a tuple in
    ``libs`` order; ``per[name + "/kern"]`` holds the same calls' qmm
    launches by kernel (qmm_gemv, qmm_tile, qmm_tc)."""
    from repro_torch.launch import serve

    per = {name: [] for name in hooks}
    per.update({name + "/kern": [] for name in hooks})
    per.update({name + "/tokens": [] for name in hooks})
    saved = []
    for name, (cls, attr) in hooks.items():
        fn = getattr(cls, attr)
        saved.append((cls, attr, fn))

        def wrapped(self, *a, _fn=fn, _name=name, **k):
            before = [lib.launches for lib in libs]
            kern = _qmm_kernels(libs[0])
            out = _fn(self, *a, **k)
            per[_name].append(tuple(lib.launches - b0 for lib, b0
                                    in zip(libs, before)))
            per[_name + "/kern"].append(_qmm_kernels(libs[0], kern))
            toks = a[1] if len(a) > 1 else None
            per[_name + "/tokens"].append(
                toks.numel() if isinstance(toks, torch.Tensor) else None)
            return out
        setattr(cls, attr, wrapped)
    torch.cuda.reset_peak_memory_stats()
    for lib in libs:
        lib.reset_counts()               # counts of the main path only
    t0 = time.perf_counter()
    try:
        reqs = serve.main(argv, params=params)
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    launches["qmm_by_entry"] = dict(libs[0].by_symbol)
    launches["qmm_by_kernel"] = dict(libs[0].by_kernel)
    launches["norms_by_entry"] = dict(libs[5].by_symbol)
    return reqs, per, launches, wall, torch.cuda.max_memory_allocated()


def _serve_summary(args, stats):
    with open(os.path.join(args.out, stats)) as f:
        return [json.loads(line) for line in f][-1]


def _counts_ok(seen, want) -> bool:
    return bool(seen) and all(c == want for c in seen)


# the binary32 serve: 2 requests x (128 prompt + 8 new tokens)
F32_REQUESTS, F32_MAX_NEW = 2, 8


def run_serve(torch, report, libs, args, decode_impl="paged", key="serve",
              policy="transprecision"):
    """The serving path on full-width, full-depth llama3-8b: every decode
    step must launch 193 qmm and 32 of the decode backend's kernel
    (``paged_decode`` for ``paged``, ``flash_decode`` for
    ``flash_pallas``), every prefill chunk 193 qmm and 32 flash_prefill.
    Under ``transprecision`` (8 requests x (128 + 32)) every qmm on bf16
    weights takes the tensor-core kernel; under ``binary32`` (2 requests
    x (128 + 8), f32 weights in u32 containers, an f32 KV cache) every qmm
    runs on the CUDA cores: a decode step's 193 and a chunk's head (its
    last position, M = 1) on the GEMV, a chunk's 192 at M = 64 on
    qmm_tile.  Launch tuples are (qmm, paged_decode, flash_prefill,
    flash_decode, flexfloat_cast, norms): 65 rmsnorm launches (two a
    layer and the final norm) a step and a chunk; qmm by kernel
    (qmm_gemv, qmm_tile, qmm_tc)."""
    from repro_torch.engine import worker

    f32 = policy == "binary32"
    requests, max_new = (F32_REQUESTS, F32_MAX_NEW) if f32 \
        else (SERVE_REQUESTS, SERVE_MAX_NEW)
    stats = f"{key}_stats.jsonl"
    argv = _serve_argv(args, decode_impl, requests, max_new, stats,
                       policy=policy)
    reqs, per, launches, wall, peak = _drive_serve(
        torch, libs, argv, {"decode": (worker.DecodeWorker, "step"),
                            "prefill": (worker.PrefillWorker, "step")})
    want_dec = (193, 32, 0, 0, 0, NORMS) if decode_impl == "paged" \
        else (193, 0, 0, 32, 0, NORMS)
    want_pre = (193, 0, 32, 0, 0, NORMS)
    # the packed weights take the tensor-core kernel at every M (a decode
    # step, a 64-token chunk and its head); binary32 the CUDA cores
    want_dec_k, want_pre_k = ((193, 0, 0), (1, 192, 0)) if f32 \
        else ((0, 0, 193), (0, 0, 193))
    ok = all(r.done and not r.failed for r in reqs)
    ok &= all(len(r.generated) == max_new for r in reqs)
    ok &= all(0 <= t < 128256 for r in reqs for t in r.generated)
    ok &= _counts_ok(per["decode"], want_dec)
    ok &= _counts_ok(per["prefill"], want_pre)
    ok &= _counts_ok(per["decode/kern"], want_dec_k)
    ok &= _counts_ok(per["prefill/kern"], want_pre_k)
    summary = _serve_summary(args, stats)
    tokens = sum(len(r.generated) for r in reqs)
    report[key] = dict(
        policy=policy, decode_impl=decode_impl, requests=len(reqs),
        tokens=tokens, wall_s=wall, tok_per_s=summary["tokens_per_s"],
        ttft_mean_s=summary["ttft_mean_s"], ttft_max_s=summary["ttft_max_s"],
        decode_steps=len(per["decode"]),
        prefill_chunks=len(per["prefill"]),
        launches=launches, peak_mem_bytes=peak,
        per_decode_step=sorted(set(per["decode"])),
        per_prefill_chunk=sorted(set(per["prefill"])),
        qmm_kernels_per_decode_step=sorted(set(per["decode/kern"])),
        qmm_kernels_per_prefill_chunk=sorted(set(per["prefill/kern"])),
        decode_launches_by_kernel=[sum(c) for c in zip(*per["decode/kern"])],
        prefill_launches_by_kernel=[sum(c)
                                    for c in zip(*per["prefill/kern"])],
        generated=[r.generated for r in reqs], ok=ok)
    print(f"[{key}] llama3-8b full (32 layers, d_model 4096), {policy}, "
          f"decode {decode_impl}: {len(reqs)} requests done, {tokens} "
          f"tokens in {wall:.2f} s, {summary['tokens_per_s']} tok/s, TTFT "
          f"mean {summary['ttft_mean_s']} s (max {summary['ttft_max_s']} "
          f"s), peak memory {peak / 1e9:.2f} GB")
    print(f"[{key}] launches {launches}; per decode step (qmm, paged, "
          f"prefill, flash_decode, cast, norms) "
          f"{sorted(set(per['decode']))} (want "
          f"{want_dec}); per prefill chunk {sorted(set(per['prefill']))} "
          f"(want {want_pre}); qmm by kernel (qmm_gemv, qmm_tile, qmm_tc) "
          f"per decode step {sorted(set(per['decode/kern']))} (want "
          f"{want_dec_k}), per prefill chunk "
          f"{sorted(set(per['prefill/kern']))} (want {want_pre_k}) "
          f"{'ok' if ok else 'FAIL'}")
    if key == "serve_flash" and "serve" in report:
        base = report["serve"]["generated"]
        diff = sum(a != b for ga, gb in zip(base, report[key]["generated"])
                   for a, b in zip(ga, gb))
        report[key]["tokens_differing_from_paged"] = diff
        print(f"[{key}] tokens differing from the paged run: {diff} of "
              f"{tokens} (both exact to rounding; not asserted)")
    return ok


# the reduced serve: llama3-8b --reduced (2 layers, head_dim 16, G 2),
# 4 requests x (40 prompt + 8 new) over 2 slots, page 16
RED_REQUESTS, RED_SLOTS, RED_PROMPT, RED_MAX_NEW, RED_PAGE = 4, 2, 40, 8, 16
ARTIFACT = os.path.join(ROOT, "results", "tuned", "llama3-8b.reduced.json")


def run_serve_reduced(torch, report, libs, args):
    """``serve --arch llama3-8b --reduced`` (head_dim 16, G 2: shapes the
    attention kernels took only once widened) under ``paged`` and
    ``flash_pallas``: every request gets all its tokens; every decode
    step launches 13 qmm and 2 of the decode backend's kernel, every
    prefill chunk 13 qmm and 2 flash_prefill (launch tuples as in
    :func:`run_serve`); then the first-step logits of the reduced model
    (a 40-token prefill chunk and a decode step) on the kernel path
    against the plain path, at the logits phase's tolerance for
    transprecision (2^-5 x max|logit|), with the kernel path's attention
    launches counted."""
    from repro_torch.engine import worker
    from repro_torch.models.registry import build

    ok = True
    model, cfg = build("llama3-8b", reduced=True)
    layers = cfg.n_layers
    qmm_n = 6 * layers + 1
    norms = 2 * layers + 1
    for dec in ("paged", "flash_pallas"):
        key = f"serve_reduced_{dec}"
        stats = f"{key}_stats.jsonl"
        argv = ["--arch", "llama3-8b", "--reduced", "--policy",
                "transprecision", "--decode-impl", dec, "--matmul-impl",
                "qmm_pallas", "--page-size", str(RED_PAGE), "--requests",
                str(RED_REQUESTS), "--slots", str(RED_SLOTS), "--prompt-len",
                str(RED_PROMPT), "--max-new", str(RED_MAX_NEW),
                "--capacity", str(4 * RED_PAGE), "--seed", str(args.seed),
                "--stats-out", os.path.join(args.out, stats)]
        reqs, per, launches, wall, _ = _drive_serve(
            torch, libs, argv, {"decode": (worker.DecodeWorker, "step"),
                                "prefill": (worker.PrefillWorker, "step")})
        want_dec = (qmm_n, layers, 0, 0, 0, norms) if dec == "paged" \
            else (qmm_n, 0, 0, layers, 0, norms)
        want_pre = (qmm_n, 0, layers, 0, 0, norms)
        good = len(reqs) == RED_REQUESTS
        good &= all(r.done and not r.failed for r in reqs)
        good &= all(len(r.generated) == RED_MAX_NEW for r in reqs)
        good &= all(0 <= t < cfg.vocab for r in reqs for t in r.generated)
        good &= _counts_ok(per["decode"], want_dec)
        good &= _counts_ok(per["prefill"], want_pre)
        summary = _serve_summary(args, stats)
        report[key] = dict(
            decode_impl=dec, requests=len(reqs), wall_s=wall,
            tok_per_s=summary["tokens_per_s"], launches=launches,
            decode_steps=len(per["decode"]),
            prefill_chunks=len(per["prefill"]),
            per_decode_step=sorted(set(per["decode"])),
            per_prefill_chunk=sorted(set(per["prefill"])),
            generated=[r.generated for r in reqs], ok=good)
        print(f"[serve_reduced] llama3-8b --reduced (2 layers, head_dim "
              f"{cfg.head_dim}, G {cfg.n_heads // cfg.n_kv}), decode {dec}: "
              f"{len(reqs)} requests, {sum(len(r.generated) for r in reqs)} "
              f"tokens in {wall:.2f} s; per decode step "
              f"{sorted(set(per['decode']))} (want {want_dec}), per prefill "
              f"chunk {sorted(set(per['prefill']))} (want {want_pre}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good

        res = {}
        for path, pair in (("kernel", (dec, "qmm_pallas")),
                           ("plain", ("xla", "xla"))):
            for lib in libs:
                lib.reset_counts()
            res[path] = _first_step_logits(torch, model, cfg,
                                           "transprecision", *pair,
                                           args.seed, prompt=RED_PROMPT,
                                           page=RED_PAGE)
            if path == "kernel":
                attn = (libs[2].launches,
                        libs[1].launches if dec == "paged"
                        else libs[3].launches)
        rel = 2.0 ** -5
        for i, what in enumerate(("prefill chunk", "decode step")):
            a, b = res["kernel"][i], res["plain"][i]
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            good = err <= rel * max(scale, 1.0) and bool(
                torch.isfinite(a).all()) and attn == (layers, layers)
            ok &= good
            report["logits"].append(dict(policy="transprecision",
                                         config="llama3-8b reduced",
                                         decode_impl=dec, what=what,
                                         max_abs_err=err, max_abs_logit=scale,
                                         tol_rel=rel,
                                         attention_launches=attn, ok=good))
            print(f"[serve_reduced] logits {dec:<12} {what:<13} reduced: "
                  f"max|kernel - plain| = {err:.3e} (max|logit| "
                  f"{scale:.3f}, tol {rel:.2e} x that), attention launches "
                  f"(flash_prefill, decode) {attn} (want ({layers}, "
                  f"{layers})) {'ok' if good else 'FAIL'}")
    ok &= run_serve_artifact(torch, report, libs, args, cfg)
    return ok


def run_serve_artifact(torch, report, libs, args, cfg):
    """The reduced serve once more under the committed tuned artifact
    ``--policy results/tuned/llama3-8b.reduced.json`` (native mode,
    binary8 weights, activations, attention probabilities and per-layer
    KV): every request gets its tokens, and a decode step and a chunk
    launch what the transprecision run launches."""
    from repro_torch.engine import worker

    key = "serve_artifact"
    stats = f"{key}_stats.jsonl"
    layers = cfg.n_layers
    argv = ["--arch", "llama3-8b", "--reduced", "--policy", ARTIFACT,
            "--decode-impl", "paged", "--matmul-impl", "qmm_pallas",
            "--page-size", str(RED_PAGE), "--requests", str(RED_REQUESTS),
            "--slots", str(RED_SLOTS), "--prompt-len", str(RED_PROMPT),
            "--max-new", str(RED_MAX_NEW), "--capacity", str(4 * RED_PAGE),
            "--seed", str(args.seed), "--stats-out",
            os.path.join(args.out, stats)]
    reqs, per, launches, wall, _ = _drive_serve(
        torch, libs, argv, {"decode": (worker.DecodeWorker, "step"),
                            "prefill": (worker.PrefillWorker, "step")})
    want_dec = (6 * layers + 1, layers, 0, 0, 0, 2 * layers + 1)
    want_pre = (6 * layers + 1, 0, layers, 0, 0, 2 * layers + 1)
    good = len(reqs) == RED_REQUESTS
    good &= all(r.done and not r.failed and len(r.generated) == RED_MAX_NEW
                for r in reqs)
    good &= all(0 <= t < cfg.vocab for r in reqs for t in r.generated)
    good &= _counts_ok(per["decode"], want_dec)
    good &= _counts_ok(per["prefill"], want_pre)
    summary = _serve_summary(args, stats)
    report[key] = dict(policy=os.path.relpath(ARTIFACT, ROOT),
                       requests=len(reqs), wall_s=wall,
                       tok_per_s=summary["tokens_per_s"], launches=launches,
                       per_decode_step=sorted(set(per["decode"])),
                       per_prefill_chunk=sorted(set(per["prefill"])),
                       generated=[r.generated for r in reqs], ok=good)
    print(f"[serve_reduced] --policy {os.path.relpath(ARTIFACT, ROOT)}: "
          f"{len(reqs)} requests, {sum(len(r.generated) for r in reqs)} "
          f"tokens in {wall:.2f} s; per decode step "
          f"{sorted(set(per['decode']))} (want {want_dec}), per chunk "
          f"{sorted(set(per['prefill']))} (want {want_pre}) "
          f"{'ok' if good else 'FAIL'}")
    return good


SPEC_K, SPEC_REQUESTS, SPEC_MAX_NEW, SPEC_POOL_PAGES = 4, 4, 16, 32


def run_speculative(torch, report, libs, args):
    """Speculative serving on full-width, full-depth llama3-8b: target
    ``transprecision`` with ``flash_pallas`` decode and packed bf16
    weights, draft binary8 (weights and KV) with ``paged`` decode; 4
    requests x (128 prompt + 16 new), 4 slots, capacity 256, page 64,
    k = 4, and a pool of 32 pages (4 pages per slot in each of the two
    namespaces).  Per round the launches must be k draft decode steps of
    (193 qmm + 32 paged_decode) plus one verify of 193 qmm + 32 * k
    flash_decode; per draft prompt prefill 193 qmm + 32 flash_prefill;
    every qmm on the tensor cores.  Speculation is exact: no token may
    differ from the ``serve_flash`` run (verify runs qmm at M = 16,
    decode at M = 4, and a row sums in one order at every M); at a
    request's first divergence the target's top-2 logit gap is reported.
    The target as its own draft must have every proposal accepted."""
    from repro_torch.core.policy import get_policy
    from repro_torch.engine import (Engine, EngineStats, Request,
                                    SpeculativeDecoder, speculative, worker)
    from repro_torch.models import qparams
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    k = SPEC_K
    stats = "speculative_stats.jsonl"
    argv = _serve_argv(args, "flash_pallas", SPEC_REQUESTS, SPEC_MAX_NEW,
                       stats, ("--speculate-k", str(k), "--pool-pages",
                               str(SPEC_POOL_PAGES)))
    model, cfg = build("llama3-8b")
    policy = get_policy("transprecision", decode_impl="flash_pallas",
                        matmul_impl="qmm_pallas")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, policy, device="cuda")
    reqs, per, launches, wall, peak = _drive_serve(
        torch, libs, argv,
        {"round": (speculative.SpeculativeDecoder, "round"),
         "verify": (Model, "verify_step"),
         "draft_prefill": (speculative.SpeculativeDecoder, "prefill_prompt"),
         "prefill": (worker.PrefillWorker, "step"),
         "decode": (worker.DecodeWorker, "step")}, params=params)
    want_round = (k * 193 + 193, k * 32, 0, k * 32, 0, (k + 1) * NORMS)
    want_pre = (193, 0, 32, 0, 0, NORMS)
    # by qmm kernel (qmm_gemv, qmm_tile, qmm_tc): a verify of B slots
    # x k tokens runs its 193 projections (head included) on tensor cores
    # at every B * k (16 with every slot decoding), a prompt prefill too
    verify_q = list(zip(per["verify/tokens"], per["verify/kern"]))
    want_pre_q = (0, 0, 193)
    ok = all(r.done and not r.failed for r in reqs)
    ok &= all(len(r.generated) == SPEC_MAX_NEW for r in reqs)
    ok &= all(0 <= t < 128256 for r in reqs for t in r.generated)
    ok &= _counts_ok(per["round"], want_round)
    ok &= _counts_ok(per["draft_prefill"], want_pre)
    ok &= _counts_ok(per["prefill"], want_pre)
    ok &= bool(verify_q) and all(q == (0, 0, 193) for _, q in verify_q)
    ok &= any(m == SERVE_SLOTS * k for m, _ in verify_q)
    ok &= _counts_ok(per["draft_prefill/kern"], want_pre_q)
    ok &= _counts_ok(per["prefill/kern"], want_pre_q)
    ok &= not per["decode"]
    summary = _serve_summary(args, stats)
    tokens = sum(len(r.generated) for r in reqs)

    # tokens against the non-speculative flash_pallas run (same prompts:
    # the first requests of serve_flash): none may differ; the target's
    # top-2 logit gap at a request's first divergence says how near a tie
    # a fault showed
    diverged = []
    ref = report.get("serve_flash", {}).get("generated")
    n_diff = None
    packed = qparams.encode_params(params, policy)
    if ref is not None:
        n_diff = 0
        for r, want in zip(reqs, ref):
            pairs = list(zip(r.generated, want))
            n_diff += sum(a != b for a, b in pairs)
            j = next((i for i, (a, b) in enumerate(pairs) if a != b), None)
            if j is None:
                continue
            toks = torch.tensor([r.prompt + r.generated[:j]],
                                dtype=torch.int32, device="cuda")
            logits, _ = model.prefill(packed, {"tokens": toks}, policy)
            row = logits[0, -1].float()
            top = torch.topk(row, 2).values
            diverged.append(dict(
                request=r.rid, position=j, speculative=r.generated[j],
                plain=want[j], top2_gap=float(top[0] - top[1]),
                logit_speculative=float(row[r.generated[j]]),
                logit_plain=float(row[want[j]])))
    ok &= n_diff == 0

    # the target as its own draft proposes the target's own greedy tokens,
    # and verify gives decode's logits bit for bit: every proposal is
    # accepted, a rate of exactly 1.0
    self_reqs = [Request(r.rid, list(r.prompt), SPEC_MAX_NEW) for r in reqs]
    eng = Engine(model, cfg, policy, packed, slots=SERVE_SLOTS,
                 capacity=SERVE_CAPACITY, page_size=SERVE_PAGE,
                 pool_pages=SPEC_POOL_PAGES, stats=EngineStats(),
                 speculative=SpeculativeDecoder(model, cfg, policy, packed,
                                                k=k), device="cuda")
    eng.run(self_reqs)
    self_rate = eng.summary["accept_rate"]
    self_ok = all(r.done and not r.failed for r in self_reqs) \
        and self_rate == 1.0
    ok &= self_ok
    report["speculative_self_draft"] = dict(
        accept_rate=self_rate, tok_per_s=eng.summary["tokens_per_s"],
        steps_per_token=eng.summary["steps_per_token"],
        generated=[r.generated for r in self_reqs], ok=self_ok)
    print(f"[speculative] self-draft (the target proposes for itself): "
          f"accept rate {self_rate} (want 1.0), "
          f"{eng.summary['tokens_per_s']} tok/s "
          f"{'ok' if self_ok else 'FAIL'}")
    del packed, params, eng
    torch.cuda.empty_cache()
    report["speculative"] = dict(
        k=k, requests=len(reqs), tokens=tokens, wall_s=wall,
        tok_per_s=summary["tokens_per_s"],
        ttft_mean_s=summary["ttft_mean_s"], ttft_max_s=summary["ttft_max_s"],
        accept_rate=summary["accept_rate"],
        steps_per_token=summary["steps_per_token"],
        rounds=len(per["round"]), launches=launches, peak_mem_bytes=peak,
        per_round=sorted(set(per["round"])),
        per_draft_prefill=sorted(set(per["draft_prefill"])),
        per_prefill_chunk=sorted(set(per["prefill"])),
        qmm_kernels_per_verify=sorted(set(verify_q)),
        qmm_kernels_per_prefill=sorted(set(per["prefill/kern"]
                                           + per["draft_prefill/kern"])),
        tokens_differing_from_serve_flash=n_diff, first_divergences=diverged,
        generated=[r.generated for r in reqs], ok=ok)
    print(f"[speculative] llama3-8b full, k={k}, draft binary8: "
          f"{len(reqs)} requests done, {tokens} tokens in {wall:.2f} s, "
          f"{summary['tokens_per_s']} tok/s, accept rate "
          f"{summary['accept_rate']}, steps/token "
          f"{summary['steps_per_token']}, TTFT mean "
          f"{summary['ttft_mean_s']} s, peak memory {peak / 1e9:.2f} GB")
    print(f"[speculative] launches {launches}; per round "
          f"{sorted(set(per['round']))} (want {want_round}); per draft "
          f"prompt {sorted(set(per['draft_prefill']))} and per target chunk "
          f"{sorted(set(per['prefill']))} (want {want_pre}); qmm by kernel "
          f"(qmm_gemv, qmm_tile, qmm_tc) per verify by rows "
          f"{sorted(set(verify_q))} (want (0, 0, 193)), per prompt "
          f"{sorted(set(per['prefill/kern'] + per['draft_prefill/kern']))}"
          f" (want {want_pre_q}) {'ok' if ok else 'FAIL'}")
    print(f"[speculative] tokens differing from serve_flash: {n_diff} "
          f"(want 0); first divergences (prefill logits of the context) "
          f"{diverged} {'ok' if n_diff == 0 else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 9: where the serve time goes (torch.profiler over Engine.run)
# ---------------------------------------------------------------------------

def _profiled_serve(torch, argv, window=None, params=None, cpu=True):
    """``serve.main(argv, params=params)`` under torch.profiler: the
    whole of ``Engine.run``, or with ``window = n`` only n engine steps
    taken once every prompt is prefilled (a steady decode window);
    ``cpu=False`` traces the device activity alone (a qwen3-moe step
    launches ~19k kernels).  Returns (device busy seconds from the CUDA
    rows, wall seconds, the top ten CUDA rows, decode steps or rounds in
    the profile, the key_averages rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import scheduler
    from repro_torch.launch import serve

    prof = profile(activities=([ProfilerActivity.CPU] if cpu else [])
                   + [ProfilerActivity.CUDA])
    box = {"left": window}
    cls, attr = (scheduler.Engine, "run") if window is None \
        else (scheduler.Engine, "step")
    orig = getattr(cls, attr)

    def profiled(self, *a):
        steady = not self._tasks and not self._queue
        if window is not None and not (box["left"] and steady):
            return orig(self, *a)
        if "t0" not in box:
            torch.cuda.synchronize()
            prof.start()
            box["t0"], box["steps0"] = time.perf_counter(), self.decode_steps
        out = orig(self, *a)
        if window is not None:
            box["left"] -= 1
        if window is None or box["left"] == 0:
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - box["t0"]
            prof.stop()
            box["steps"] = self.decode_steps - box["steps0"]
        return out

    setattr(cls, attr, profiled)
    try:
        serve.main(argv, params=params)
    finally:
        setattr(cls, attr, orig)
        if "t0" in box and "wall" not in box:
            prof.stop()
    if "wall" not in box:
        raise RuntimeError(f"the profile window of {window} steady steps "
                           f"was not reached")

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # only the device's own rows (kernels, memcpys, memsets): a CPU op's
    # row also carries the device time of what it launched, so summing
    # every row would count that time twice (torch's table footer sums
    # the same rows)
    rows = prof.key_averages()           # costly on a long trace: once
    events = [e for e in rows
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = [dict(name=e.key[:80], count=e.count, device_ms=dev_us(e) / 1e3)
           for e in sorted(events, key=dev_us, reverse=True)[:10]]
    return busy, box["wall"], top, box["steps"], rows


def run_profile(torch, report, args):
    """Where the serve time goes: ``Engine.run`` under torch.profiler for
    a short ``paged`` serve and a short speculative one (device busy
    share, the kernels that take the device time), then the host syncs
    of a tiny serve counted by torch's sync debug mode."""
    from repro_torch.launch import serve

    base = ["--arch", "llama3-8b", "--policy", "transprecision",
            "--matmul-impl", "qmm_pallas", "--page-size", "64",
            "--requests", "4", "--slots", "4", "--prompt-len", "128",
            "--capacity", "256", "--seed", str(args.seed)]
    # the speculative run is profiled over a window of 3 rounds: a round
    # traces some 20000 events, and summing a long trace takes minutes
    runs = (("serve", ["--decode-impl", "paged", "--max-new", "8"], None),
            ("speculative", ["--decode-impl", "flash_pallas", "--max-new",
                             "16", "--speculate-k", str(SPEC_K),
                             "--pool-pages", str(SPEC_POOL_PAGES)], 3))
    report["profile"] = {}
    for name, extra, window in runs:
        busy, wall, top, steps, rows = _profiled_serve(torch, base + extra,
                                                       window)
        report["profile"][name] = dict(
            wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
            decode_steps=steps, top=top)
        with open(os.path.join(args.out, f"profile_{name}.txt"), "w") as f:
            f.write(rows.table(row_limit=40))
        what = "the whole run" if window is None \
            else f"{window} steady steps"
        print(f"[profile] {name} 4 requests x (128 + {extra[3]}), "
              f"{what}: wall {wall:.3f} s, {steps} decode steps or rounds, "
              f"device busy {busy:.3f} s ({100 * busy / wall:.1f} %)")
        for e in top:
            print(f"[profile]   {e['device_ms']:9.2f} ms  x{e['count']:<6} "
                  f"{e['name'][:70]}")
        del rows
    busy = report["profile"]["serve"]["device_busy_s"]

    # where the host waits for the device: torch's sync debug mode warns
    # at every synchronizing call; count them by the Python line
    syncs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            serve.main(["--arch", "llama3-8b", "--policy", "transprecision",
                        "--decode-impl", "paged", "--matmul-impl",
                        "qmm_pallas", "--page-size", "64", "--requests", "2",
                        "--slots", "2", "--prompt-len", "64", "--max-new",
                        "3", "--capacity", "128", "--seed", str(args.seed)])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    report["profile"]["serve"]["host_syncs"] = syncs
    for where, n in sorted(syncs.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   sync x{n:<5} {where}")
    return busy > 0


# ---------------------------------------------------------------------------
# phase 8: logits, kernel path against plain path
# ---------------------------------------------------------------------------

# the phase's tolerances on max|kernel - plain| in units of max|logit|.
# binary32: both paths compute f32 products with f32 sums; only the
# summation order differs (K up to 22528), so 1e-4 x max|logit|.
# transprecision: the plain path rounds attention probabilities to bf16
# (attn_probs), the fused kernels keep them f32, and one bf16 ulp is
# 2^-8 of a value, so 2^-5 x max|logit|.
LOGIT_TOL = {"binary32": 1e-4, "transprecision": 2.0 ** -5}


def check_logits(torch, report, args, qmm_lib):
    """Logits of a 2-layer, full-width model: kernel path against plain
    path (prefill chunk, decode step), then verify against sequential
    decode bit for bit (:func:`check_verify_logits`), then rmsnorm's rows
    at every row count.  The binary32 kernel-path runs take the CUDA-core
    route (``qmm_launch``: the GEMV and qmm_tile): their launches are
    counted."""
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    _, full = build("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=2)
    model = Model(cfg)
    ok = True
    f32 = 0

    def f32_launches():
        return qmm_lib.by_symbol.get("qmm_launch", 0)

    for pol, rel in LOGIT_TOL.items():
        res = {}
        for path, (dec, mm) in (("kernel", ("paged", "qmm_pallas")),
                                ("plain", ("xla", "xla"))):
            before = f32_launches()
            res[path] = _first_step_logits(torch, model, cfg, pol, dec, mm,
                                           args.seed, prompt=64, page=64)
            if pol == "binary32" and path == "kernel":
                f32 += f32_launches() - before
        for i, what in enumerate(("prefill chunk", "decode step")):
            a, b = res["kernel"][i], res["plain"][i]
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            same_argmax = bool((a.argmax(-1) == b.argmax(-1)).all())
            good = err <= rel * max(scale, 1.0) and bool(
                torch.isfinite(a).all())
            ok &= good
            report["logits"].append(dict(policy=pol, what=what,
                                         max_abs_err=err, max_abs_logit=scale,
                                         tol_rel=rel, argmax_equal=same_argmax,
                                         ok=good))
            print(f"[logits] {pol:<14} {what:<13} 2-layer full width: "
                  f"max|kernel - plain| = {err:.3e} (max|logit| {scale:.3f},"
                  f" tol {rel:.2e} x that), argmax equal: {same_argmax} "
                  f"{'ok' if good else 'FAIL'}")
    for pol in ("binary32", "transprecision"):
        for dec in ("paged", "flash_pallas"):
            before = f32_launches()
            ok &= check_verify_logits(torch, report, args, model, cfg, pol,
                                      dec)
            if pol == "binary32":
                f32 += f32_launches() - before
    report["logits_f32_launches"] = f32
    ok &= f32 > 0
    ok &= check_logits_archs(torch, report, args)
    return ok


def check_logits_archs(torch, report, args):
    """The ninth slice's two new layer kinds at 2 layers, full width:
    command-r-35b (layernorm, the tied head on ``torch.matmul`` in
    8-row blocks) under binary32 and transprecision, kernel path against
    plain path, then verify against sequential decode bit for bit
    (:func:`check_verify_logits`) under both, with paged and
    flash_pallas; qwen3-moe-30b-a3b (MoE) under transprecision, kernel
    path against plain path, and in every router call of the kernel path
    the experts the qmm router picks equal to those the plain product
    picks on the same rows.  The two paths' own picks (their inputs
    differ by the attention probabilities' bf16 rounding) are counted,
    not held.  No MoE verify check: expert capacity follows the row
    count, so verify does not equal decode there, in the reference
    neither."""
    from repro_torch.models import moe
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    ok = True
    for arch, pols in (("command-r-35b", ("binary32", "transprecision")),
                       ("qwen3-moe-30b-a3b", ("transprecision",))):
        _, full = build(arch)
        cfg = dataclasses.replace(full, n_layers=2)
        model = Model(cfg)
        for pol in pols:
            res, picks, agree = {}, {}, []
            real = moe.moe_route

            def route(p, xt, c, policy, _path=None):
                r = real(p, xt, c, policy)
                picks[_path].append(r.top_e)
                if _path == "kernel":
                    plain = real(p, xt, c, dataclasses.replace(
                        policy, matmul_impl="xla"))
                    agree.append((int((plain.top_e == r.top_e).all(-1)
                                      .sum()), xt.shape[0]))
                return r
            for path, (dec, mm) in (("kernel", ("paged", "qmm_pallas")),
                                    ("plain", ("xla", "xla"))):
                picks[path] = []
                moe.moe_route = lambda *a, _p=path: route(*a, _path=_p)
                try:
                    res[path] = _first_step_logits(
                        torch, model, cfg, pol, dec, mm, args.seed,
                        prompt=64, page=64)
                finally:
                    moe.moe_route = real
            rel = LOGIT_TOL[pol]
            for i, what in enumerate(("prefill chunk", "decode step")):
                a, b = res["kernel"][i], res["plain"][i]
                err = float((a - b).abs().max())
                scale = float(b.abs().max())
                good = err <= rel * max(scale, 1.0) and bool(
                    torch.isfinite(a).all())
                ok &= good
                report["logits"].append(dict(
                    arch=arch, policy=pol, what=what, max_abs_err=err,
                    max_abs_logit=scale, tol_rel=rel,
                    argmax_equal=bool((a.argmax(-1) == b.argmax(-1)).all()),
                    ok=good))
                print(f"[logits] {arch} {pol:<14} {what:<13} 2-layer full "
                      f"width: max|kernel - plain| = {err:.3e} (max|logit| "
                      f"{scale:.3f}, tol {rel:.2e} x that) "
                      f"{'ok' if good else 'FAIL'}")
            if cfg.moe_experts:
                same = sum(a for a, _ in agree)
                rows = sum(n for _, n in agree)
                paths = sum(int((a == b).all(-1).sum()) for a, b in
                            zip(picks["kernel"], picks["plain"]))
                good = rows > 0 and same == rows \
                    and len(agree) == 2 * cfg.n_layers
                ok &= good
                report["logits"].append(dict(
                    arch=arch, policy=pol, what="router picks",
                    rows=rows, rows_same_experts=same,
                    rows_same_experts_across_paths=paths, ok=good))
                print(f"[logits] {arch} {pol}: the qmm router's experts "
                      f"equal the plain product's in {same} of {rows} "
                      f"rows ({len(agree)} router calls) "
                      f"{'ok' if good else 'FAIL'}; the kernel and plain "
                      f"paths pick the same experts in {paths} of {rows} "
                      f"rows (measured)")
            else:
                for dec in ("paged", "flash_pallas"):
                    ok &= check_verify_logits(torch, report, args, model,
                                              cfg, pol, dec)
        del model
        torch.cuda.empty_cache()
    return ok


def _first_step_logits(torch, model, cfg, pol, dec, mm, seed, *, prompt,
                       page):
    """Logits of one prefill chunk of ``prompt`` random tokens (seeded)
    into a one-slot paged cache of 4 pages of ``page``, then of one
    decode step, under ``pol`` with decode backend ``dec`` and matmul
    ``mm`` (``qmm_pallas`` packs the weights): the kernel path
    (paged / flash_pallas, qmm_pallas) or the plain one (xla, xla)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import paged_cache
    from repro_torch.models import qparams

    policy = get_policy(pol, decode_impl=dec, matmul_impl=mm)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, policy, device="cuda")
    if mm == "qmm_pallas":
        params = qparams.encode_params(params, policy)
    states = [paged_cache.set_block_tables(
        paged_cache.init_paged_cache(
            1, 4, page, 4, cfg.n_kv, cfg.head_dim,
            policy.dtype("kv_cache"), device="cuda"),
        [[0, 1, 2, 3]]) for _ in range(cfg.n_layers)]
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (1, prompt), generator=g)
    lp, states = model.prefill_chunk(params, toks.cuda(), states, policy,
                                     slot=0, q_offset=0)
    ld, _ = model.decode_step(params, toks[:, -1:].cuda(), states, policy)
    out = (lp.float(), ld.float())
    del params, states
    torch.cuda.empty_cache()
    return out


def _bits(t):
    """A tensor's raw bytes, for comparing payloads bit for bit."""
    import torch
    return t.contiguous().view(-1).view(torch.uint8)


def check_verify_logits(torch, report, args, model, cfg, pol, dec,
                        k=SPEC_K):
    """The speculative verify step on the card, bit for bit: at 2 layers
    full width, ``qmm_pallas`` with ``dec`` decode (``paged`` or
    ``flash_pallas``), 4 slots holding 64-token prompts, ``verify_step``
    over k tokens against k sequential ``decode_step`` calls.  Verify runs
    every projection at M = 4 * k = 16, decode at M = 4; each kernel sums
    a row in one order at every M, attention goes per position through
    the decode kernel, and rmsnorm sums in an order free of the row count,
    so the logits, every layer's K/V pool bits and the lengths are equal
    (``torch.equal``), as ``tests/test_speculative.py`` holds the
    reference."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import paged_cache
    from repro_torch.models import qparams

    policy = get_policy(pol, decode_impl=dec, matmul_impl="qmm_pallas")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = qparams.encode_params(
        model.init_params(gen, policy, device="cuda"), policy)
    B, page, pps = 4, 64, 2
    g = torch.Generator().manual_seed(args.seed + 7)
    prompts = torch.randint(0, cfg.vocab, (B, 64), generator=g)
    v = torch.randint(0, cfg.vocab, (B, k), generator=g).to(
        torch.int32).cuda()
    tables = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)

    def fresh():
        states = [paged_cache.set_block_tables(paged_cache.init_paged_cache(
            B, B * pps, page, pps, cfg.n_kv, cfg.head_dim,
            policy.dtype("kv_cache"), device="cuda"), tables)
            for _ in range(cfg.n_layers)]
        for si in range(B):
            _, states = model.prefill_chunk(
                params, prompts[si:si + 1].to(torch.int32).cuda(), states,
                policy, slot=si, q_offset=0)
        return states

    st = fresh()
    seq = []
    for i in range(k):
        lg, st = model.decode_step(params, v[:, i:i + 1], st, policy)
        seq.append(lg[:, 0].float())
    seq = torch.stack(seq, dim=1)
    blk, bst = model.verify_step(params, v, fresh(), policy)
    blk = blk.float()
    err = float((blk - seq).abs().max())
    same_logits = torch.equal(blk, seq)
    pools_equal = all(torch.equal(_bits(a.k_pool), _bits(b.k_pool))
                      and torch.equal(_bits(a.v_pool), _bits(b.v_pool))
                      for a, b in zip(bst, st))
    lens_ok = all(bool(torch.equal(a.seq_lens, b.seq_lens))
                  for a, b in zip(bst, st))
    good = same_logits and pools_equal and lens_ok \
        and bool(torch.isfinite(blk).all())
    report["logits"].append(dict(arch=cfg.arch, policy=pol, decode_impl=dec,
                                 what=f"verify k={k} vs {k} decode steps",
                                 max_abs_err=err, logits_equal=same_logits,
                                 kv_pools_equal=pools_equal,
                                 seq_lens_equal=lens_ok, ok=good))
    print(f"[logits] {cfg.arch} {pol} verify_step (k={k}) vs {k} decode "
          f"steps, 2-layer full width, {dec}: logits equal: {same_logits} "
          f"(max|diff| "
          f"{err:.3e}), K/V pool bits equal: {pools_equal}, lengths equal: "
          f"{lens_ok} {'ok' if good else 'FAIL'}")
    del params
    torch.cuda.empty_cache()
    return good


# granite-moe, qwen3-moe, llama3-8b, mistral-nemo, command-r
RMS_DIMS = (1024, 2048, 4096, 5120, 8192)
LN_DIMS = (8192, 384)           # command-r; whisper-tiny's, for later


def check_rmsnorm_rows(torch, report, args):
    """rmsnorm (``models/layers.py``, the ``csrc/rmsnorm.cu`` kernel) on
    the card gives a row the same bits whatever the number of rows beside
    it (ROW_COUNTS), at d_model 1024, 2048, 4096, 5120 and 8192, under
    binary32 and transprecision; the kernel is within 1e-6 relative of
    its plain twin (``kernels/rmsnorm.rmsnorm_plain``, run on the card) on
    f32 and bf16 inputs; beside it, whether a single ``torch.mean`` over
    the rows would be free of the row count (measured, not asserted)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator(device="cuda").manual_seed(args.seed + 9)
    res, twin, mean_rows = {}, {}, {}
    err = 0.0
    for d in RMS_DIMS:
        x = torch.randn((128, d), generator=g, device="cuda") * 3.0
        gamma = torch.randn((d,), generator=g, device="cuda") * 0.1
        for pol in ("binary32", "transprecision"):
            policy = get_policy(pol)
            full = rmsnorm(x, gamma, policy)
            res[f"{pol}/{d}"] = all(
                torch.equal(rmsnorm(x[:m], gamma, policy), full[:m])
                for m in ROW_COUNTS)
        for xin in (x, x.to(torch.bfloat16)):
            k = rms.rmsnorm_f32(xin, gamma)
            p = rms.rmsnorm_plain(xin, gamma)
            rel = float(((k - p).abs() / p.abs().clamp_min(1e-30)).max())
            twin[f"{xin.dtype}/{d}"] = rel
            err = max(err, float((k - p).abs().max()))
        sq = x * x
        whole = torch.mean(sq, dim=-1)
        mean_rows[d] = sum(torch.equal(torch.mean(sq[:m], dim=-1), whole[:m])
                           for m in ROW_COUNTS)
    good = all(res.values()) and max(twin.values()) <= 1e-6
    report["rmsnorm_rows_invariant"] = res
    report["rmsnorm_twin_max_rel_err"] = twin
    report["rmsnorm_max_abs_err"] = err
    report["torch_mean_rows_invariant"] = mean_rows
    print(f"[rmsnorm] rows bit-identical through {ROW_COUNTS} rows at d "
          f"{RMS_DIMS}: {res}; kernel vs twin max relative error {twin} "
          f"(tol 1e-6) {'ok' if good else 'FAIL'}; one torch.mean over m "
          f"rows equal to its rows of 128 for how many of the "
          f"{len(ROW_COUNTS)} row counts (measured): {mean_rows}")
    return good


def check_layernorm_rows(torch, report, args):
    """layernorm (``models/layers.py``, ``layernorm_launch`` of
    ``csrc/rmsnorm.cu``) on the card: the kernel bit-identical to its
    plain twin (``kernels/layernorm.layernorm_plain``, run on the card)
    on f32 and bf16 inputs, and a row's bits free of the number of rows
    beside it (ROW_COUNTS) under binary32 and transprecision, at d 8192
    (command-r-35b) and 384; beside it, whether ``F.layer_norm`` is free
    of the row count (measured, not asserted)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import layernorm as ln
    from repro_torch.models.layers import layernorm

    g = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    rows, twin, lib_rows = {}, {}, {}
    err = 0.0
    for d in LN_DIMS:
        x = torch.randn((128, d), generator=g, device="cuda") * 3.0 + 1.5
        gamma = 1.0 + torch.randn((d,), generator=g, device="cuda") * 0.1
        beta = torch.randn((d,), generator=g, device="cuda") * 0.1
        for pol in ("binary32", "transprecision"):
            policy = get_policy(pol)
            full = layernorm(x, gamma, beta, policy)
            rows[f"{pol}/{d}"] = all(
                torch.equal(layernorm(x[:m], gamma, beta, policy), full[:m])
                for m in ROW_COUNTS)
        for xin in (x, x.to(torch.bfloat16)):
            k = ln.layernorm_f32(xin, gamma, beta)
            p = ln.layernorm_plain(xin, gamma, beta)
            twin[f"{xin.dtype}/{d}"] = torch.equal(k, p)
            err = max(err, float((k - p).abs().max()))
        whole = torch.nn.functional.layer_norm(x, (d,), gamma, beta, 1e-5)
        lib_rows[d] = sum(torch.equal(torch.nn.functional.layer_norm(
            x[:m], (d,), gamma, beta, 1e-5), whole[:m]) for m in ROW_COUNTS)
    good = all(rows.values()) and all(twin.values())
    report["layernorm_rows_invariant"] = rows
    report["layernorm_twin_equal"] = twin
    report["layernorm_max_abs_err"] = err
    report["layer_norm_rows_invariant"] = lib_rows
    print(f"[layernorm] kernel bit-identical to its twin: {twin}; rows "
          f"bit-identical through {ROW_COUNTS} rows at d {LN_DIMS}: {rows} "
          f"{'ok' if good else 'FAIL'}; F.layer_norm over m rows equal to "
          f"its rows of 128 for how many of the {len(ROW_COUNTS)} row "
          f"counts (measured): {lib_rows}")
    return good


def time_layernorm(torch, report, timer):
    """The layernorm kernel at a decode step's rows (4) and a prefill
    chunk's (64), d 8192 (command-r-35b), bf16 activations in, f32 out:
    beside its twin on the card, ``F.layer_norm`` (one PyTorch call for
    the same function, on the f32 of the input) and the byte bound
    (``layernorm_hbm_bytes``)."""
    from repro_torch.kernels import layernorm as ln

    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 12)
    d = 8192
    gamma = 1.0 + torch.randn((d,), generator=g, device="cuda") * 0.1
    beta = torch.randn((d,), generator=g, device="cuda") * 0.1
    for rows in (4, 64):
        x = (torch.randn((rows, d), generator=g, device="cuda") * 3.0).to(
            torch.bfloat16)
        xf = x.float()
        t_k = timer(lambda: ln.layernorm_f32(x, gamma, beta))
        t_p = timer(lambda: ln.layernorm_plain(x, gamma, beta))
        t_l = timer(lambda: torch.nn.functional.layer_norm(
            xf, (d,), gamma, beta, 1e-5))
        host = timer.host_us(lambda: ln.layernorm_f32(x, gamma, beta))
        nbytes = ln.layernorm_hbm_bytes(rows, d, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="layernorm", rows=rows, d=d, ms=t_k, plain_ms=t_p,
            library_ms=t_l, bound_ms=bound, bound_by="bytes", bytes=nbytes,
            host_us=host))
        print(f"[timing] layernorm {rows:>3} x {d} bf16 -> f32: kernel "
              f"{t_k:.4f} ms  twin {t_p:.4f} ms  F.layer_norm {t_l:.4f} ms"
              f"  bound {bound:.5f} ms  host {host:.1f} us")


def _rmsnorm_torch_ops(torch, x, gamma, eps=1e-6):
    """The port's rmsnorm before the kernel: 128-wide ``torch.sum``
    partials, a sum of the partials, ``rsqrt``, two products -- the torch
    ops one kernel launch replaced (about 8 a norm)."""
    xf = x.float()
    d = xf.shape[-1]
    part = torch.sum((xf * xf).reshape(-1, 128), dim=-1)
    ms = torch.sum(part.reshape(*xf.shape[:-1], d // 128), dim=-1,
                   keepdim=True) / d
    return xf * torch.rsqrt(ms + eps) * (1.0 + gamma.float())


def time_rmsnorm(torch, report, timer):
    """The rmsnorm kernel at a decode step's rows (4) and a prefill
    chunk's (64), d 4096, bf16 activations in, f32 out: beside its twin
    on the card, the torch ops it replaced, ``F.rms_norm`` (one PyTorch
    call for the same function, on the f32 of the input) and the byte
    bound."""
    from repro_torch.kernels import rmsnorm as rms

    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 10)
    d = 4096
    gamma = torch.randn((d,), generator=g, device="cuda") * 0.1
    weight = 1.0 + gamma
    for rows in (4, 64):
        x = (torch.randn((rows, d), generator=g, device="cuda") * 3.0).to(
            torch.bfloat16)
        xf = x.float()
        t_k = timer(lambda: rms.rmsnorm_f32(x, gamma))
        t_p = timer(lambda: rms.rmsnorm_plain(x, gamma))
        t_o = timer(lambda: _rmsnorm_torch_ops(torch, x, gamma))
        t_l = timer(lambda: torch.nn.functional.rms_norm(
            xf, (d,), weight=weight, eps=1e-6))
        host = timer.host_us(lambda: rms.rmsnorm_f32(x, gamma))
        nbytes = rms.rmsnorm_hbm_bytes(rows, d, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="rmsnorm", rows=rows, d=d, ms=t_k, plain_ms=t_p,
            torch_ops_ms=t_o, library_ms=t_l, bound_ms=bound,
            bound_by="bytes", bytes=nbytes, host_us=host))
        print(f"[timing] rmsnorm {rows:>3} x {d} bf16 -> f32: kernel "
              f"{t_k:.4f} ms  twin {t_p:.4f} ms  torch ops before it "
              f"{t_o:.4f} ms  F.rms_norm {t_l:.4f} ms  bound {bound:.5f} ms"
              f"  host {host:.1f} us")


# ---------------------------------------------------------------------------
# phase 10: resilience -- faults, recovery, streamed handoff, the router
# ---------------------------------------------------------------------------

# (a) and (b): 4 requests x (128 prompt + 16 new), page 64, transprecision
RES_REQUESTS, RES_MAX_NEW = 4, 16
RES_ROUTER = ("--disaggregate", "--router", "--prefill-workers", "2")
# (b): one of each fault the streamed, transprecision run can take, and a
# pool of 10 pages where 4 sequences of 144 tokens need 12: an eviction
RES_FAULTS = ("chunk_drop@1,chunk_dup@2,page_corrupt@3,step_exception@5,"
              "pool_exhaust@6,seed=3")
RES_FAULT_KINDS = {"chunk_drop", "chunk_dup", "page_corrupt",
                   "step_exception", "pool_exhaust"}
RES_POOL = 10
# (c): binary32, 2 requests x (128 + 8), nan_logits at step 3.  (d):
# 4 x (128 + 48), k = 4: every decoding slot's proposals diverged in the
# rounds of steps 3, 4 and 5 (with one prefill worker the first decodes
# at step 2), three failed rounds that open the breaker; under
# transprecision that alone, under binary32 also a nan_logits at step 8,
# inside the breaker's cooldown
RES_F32_MAX_NEW, RES_SPEC_MAX_NEW = 8, 48
RES_DIV_ONLY = ",".join(f"draft_div@{s}/{slot}" for s in (3, 4, 5)
                        for slot in range(SERVE_SLOTS))
RES_DIV = RES_DIV_ONLY + ",nan_logits@8"


def _res_serve(torch, libs, args, name, argv, params):
    """One serve through ``_drive_serve`` (decode and prefill hooked) with
    the engine's host transfers (``scheduler._host``) counted; returns
    the requests, per-call launches, launches, wall, the summary line and
    the host-transfer count."""
    from repro_torch.engine import scheduler, worker

    calls = [0]
    real = scheduler._host

    def counted(*t):
        calls[0] += 1
        return real(*t)

    scheduler._host = counted
    try:
        reqs, per, launches, wall, _ = _drive_serve(
            torch, libs, argv, {"decode": (worker.DecodeWorker, "step"),
                                "prefill": (worker.PrefillWorker, "step")},
            params=params)
    finally:
        scheduler._host = real
    summary = _serve_summary(args, f"{name}_stats.jsonl")
    print(f"[resilience] {name}: {len(reqs)} requests, "
          f"{sum(len(r.generated) for r in reqs)} tokens in {wall:.2f} s, "
          f"{summary['tokens_per_s']} tok/s, {len(per['decode'])} decode "
          f"steps, {len(per['prefill'])} prefill chunks, host transfers "
          f"{calls[0]}; counters faults={summary['faults_injected']} "
          f"(unfired {summary['faults_unfired']}, "
          f"{summary['faults_by_kind']}), retries={summary['retries']}, "
          f"crc_mismatches={summary['crc_mismatches']}, "
          f"quarantines={summary['quarantines']}, "
          f"evictions={summary['evictions']}, "
          f"degraded_steps={summary['degraded_steps']}, "
          f"breaker_trips={summary['breaker_trips']}, "
          f"failures={summary['failures']}, prefill chunks by worker "
          f"{summary['prefill_chunks_by_worker']}")
    return reqs, per, launches, wall, summary, calls[0]


def _res_breaker_serve(torch, libs, args, name, argv, params):
    """``_res_serve`` with the circuit breaker's state recorded after each
    round it records; returns ``_res_serve``'s tuple plus those states."""
    from repro_torch.engine import resilience

    states = []
    real = resilience.CircuitBreaker.record

    def record(self, *a, **k):
        real(self, *a, **k)
        states.append(self.state)

    resilience.CircuitBreaker.record = record
    try:
        return _res_serve(torch, libs, args, name, argv, params) + (states,)
    finally:
        resilience.CircuitBreaker.record = real


def _res_record(out, runs):
    """Keep each ``_res_breaker_serve`` run's numbers in the report."""
    for name, run in runs.items():
        out[name] = dict(tok_per_s=run[4]["tokens_per_s"], wall_s=run[3],
                         decode_steps=len(run[1]["decode"]),
                         host_transfers=run[5], summary=run[4],
                         breaker_states=run[6])


def _breaker_ok(tag, spec_run, clean_run, quarantines):
    """Check (d) on one speculative run against the plain serve of the
    same requests: no token differs, every request got its tokens, the
    breaker opened and closed again with degraded steps between, and the
    run quarantined ``quarantines`` slots.  Prints one line."""
    spec = [r.generated for r in spec_run[0]]
    clean = [r.generated for r in clean_run[0]]
    s, states = spec_run[4], spec_run[6]
    opened = "open" in states
    reclosed = opened and "closed" in states[states.index("open"):]
    n_diff = sum(a != b for ga, gb in zip(spec, clean)
                 for a, b in zip(ga, gb))
    good = n_diff == 0 and all(len(g) == RES_SPEC_MAX_NEW for g in spec)
    good &= s["breaker_trips"] >= 1 and reclosed
    good &= s["degraded_steps"] >= 1 and s["quarantines"] == quarantines
    good &= s["faults_unfired"] == 0 and s["failures"] == 0
    runs_of = []   # the breaker's state after each round, run-length
    for st in states:
        if runs_of and runs_of[-1][0] == st:
            runs_of[-1][1] += 1
        else:
            runs_of.append([st, 1])
    print(f"[resilience] (d) speculative k={SPEC_K}, {tag}: tokens "
          f"differing from the plain serve {n_diff} (want 0); breaker "
          f"state after each round {runs_of} (opens, then closes again: "
          f"{reclosed}); trips {s['breaker_trips']}, degraded steps "
          f"{s['degraded_steps']}, accept rate {s['accept_rate']}, "
          f"quarantines {s['quarantines']} (want {quarantines}) "
          f"{'ok' if good else 'FAIL'}")
    return good


def run_resilience(torch, report, libs, args, timer):
    """The serving engine's resilience surface at full width llama3-8b,
    on weights made once per policy from the seed (the serve and
    serve_f32 phases' weights) and passed to ``serve.main(..., params=)``:

    (a) ``--disaggregate --router --prefill-workers 2`` (streamed,
        CRC-checked handoff, two workers, the asyncio router), 4 x
        (128 + 16), transprecision, paged: the tokens of a plain
        colocated run bit for bit; a decode step 193 qmm + 32
        paged_decode + 65 rmsnorm, a chunk 193 + 32 flash_prefill + 65;
        one host transfer a decode step (and one a finished prefill).
    (b) the same with a seeded plan of chunk_drop, chunk_dup,
        page_corrupt, step_exception and pool_exhaust and a 10-page pool
        (an eviction): the tokens of (a); every fault fired and explained
        by its counters; the launch counts of (a).
    (c) ``--policy binary32``, 2 x (128 + 8), a nan_logits fault:
        quarantine and replay give the fault-free engine's tokens and
        ``synchronous_generate``'s on the card, bit for bit.
    (d) ``--speculate-k 4`` (binary8 draft), 4 x (128 + 48): three
        rounds with every proposal diverged trip the breaker, it opens
        and closes again, with degraded one-token steps between; no token
        differs from the plain serve under the same policy.  Under
        transprecision (packed weights, binary8 KV) the draft_div rounds
        alone; under binary32 also one nan_logits, since a replay runs
        ``synchronous_generate``, whose whole-prompt prefill attends over
        the unrounded K/V where the engine reads the pool's.  That a
        replay under a binary8 KV leaves the engine's tokens is measured
        here, not held: a transprecision nan_logits run, 2 x (128 + 8),
        against the fault-free engine and ``synchronous_generate``.
    (e) ``cli_main`` in process: 71 for a deadline plan; 72 for a CRC-
        exhausted request that may not requeue (the reference recomputes
        a request whose handoff fails its CRC, so a TransportError (73)
        never reaches the CLI: with ``--max-requeues 0`` the recompute is
        refused and the request dead-letters).
    Also: rmsnorm and layernorm rows (``check_rmsnorm_rows``,
    ``check_layernorm_rows``) and their timings."""
    from repro_torch.core.policy import get_policy
    from repro_torch.engine import synchronous_generate
    from repro_torch.launch import serve
    from repro_torch.models import qparams
    from repro_torch.models.registry import build

    ok = check_rmsnorm_rows(torch, report, args)
    ok &= check_layernorm_rows(torch, report, args)
    time_rmsnorm(torch, report, timer)
    time_layernorm(torch, report, timer)
    out = report["resilience"] = {}
    model, cfg = build("llama3-8b")

    def weights(pol):
        policy = get_policy(pol, decode_impl="paged",
                            matmul_impl="qmm_pallas")
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        return policy, qparams.encode_params(
            model.init_params(gen, policy, device="cuda"), policy)

    want_dec = (193, 32, 0, 0, 0, NORMS)
    want_pre = (193, 0, 32, 0, 0, NORMS)

    # ---- (a) streamed handoff + router, no faults ----------------------
    policy, params = weights("transprecision")
    runs = {}
    for name, extra in (("plain", ()), ("router", RES_ROUTER),
                        ("faults", RES_ROUTER + (
                            "--fault-plan", RES_FAULTS, "--pool-pages",
                            str(RES_POOL)))):
        key = f"resilience_{name}"
        argv = _serve_argv(args, "paged", RES_REQUESTS, RES_MAX_NEW,
                           f"{key}_stats.jsonl", extra)
        runs[name] = _res_serve(torch, libs, args, key, argv, params)
    base = [r.generated for r in runs["plain"][0]]
    for name, (reqs, per, launches, wall, summary, host) in runs.items():
        good = all(r.done and not r.failed and len(r.generated)
                   == RES_MAX_NEW for r in reqs)
        good &= [r.generated for r in reqs] == base
        good &= _counts_ok(per["decode"], want_dec)
        good &= _counts_ok(per["prefill"], want_pre)
        good &= summary["failures"] == 0
        if name != "faults":
            # no eviction: one transfer a decode step, one a prefill
            good &= host == len(per["decode"]) + RES_REQUESTS
        if name != "plain":
            good &= set(summary["prefill_chunks_by_worker"]) == {"0", "1"}
        if name == "faults":
            good &= summary["faults_injected"] == len(
                RES_FAULTS.split(",")) - 1
            good &= summary["faults_unfired"] == 0
            good &= set(summary["faults_by_kind"]) == RES_FAULT_KINDS
            good &= summary["crc_mismatches"] >= 2   # corrupt + drop
            good &= summary["retries"] >= 3          # 2 refetches + 1 step
            good &= summary["evictions"] >= 1
        out[name] = dict(tok_per_s=summary["tokens_per_s"], wall_s=wall,
                         decode_steps=len(per["decode"]),
                         prefill_chunks=len(per["prefill"]),
                         per_decode_step=sorted(set(per["decode"])),
                         per_prefill_chunk=sorted(set(per["prefill"])),
                         host_transfers=host, launches=launches,
                         summary=summary, ok=good)
        print(f"[resilience] ({'a' if name != 'faults' else 'b'}) {name}: "
              f"tokens equal to the colocated run: "
              f"{[r.generated for r in reqs] == base}; per decode step "
              f"{sorted(set(per['decode']))} (want {want_dec}), per chunk "
              f"{sorted(set(per['prefill']))} (want {want_pre}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good

    # ---- (d) under transprecision: the breaker alone; a replay measured
    tp = {}
    for name, requests, max_new, extra in (
            ("tp_clean48", RES_REQUESTS, RES_SPEC_MAX_NEW, ()),
            ("tp_spec", RES_REQUESTS, RES_SPEC_MAX_NEW,
             ("--speculate-k", str(SPEC_K), "--fault-plan", RES_DIV_ONLY)),
            ("tp_clean", F32_REQUESTS, RES_F32_MAX_NEW, ()),
            ("tp_nan", F32_REQUESTS, RES_F32_MAX_NEW,
             ("--fault-plan", "nan_logits@3"))):
        key = f"resilience_{name}"
        argv = _serve_argv(args, "paged", requests, max_new,
                           f"{key}_stats.jsonl", extra)
        tp[name] = _res_breaker_serve(torch, libs, args, key, argv, params)
    good_dt = _breaker_ok("transprecision target, draft_div only",
                          tp["tp_spec"], tp["tp_clean48"], quarantines=0)
    tp_clean = [r.generated for r in tp["tp_clean"][0]]
    tp_nan = [r.generated for r in tp["tp_nan"][0]]
    tp_sync = synchronous_generate(model, cfg, policy, params,
                                   [r.prompt for r in tp["tp_clean"][0]],
                                   max_new=RES_F32_MAX_NEW,
                                   capacity=SERVE_CAPACITY, device="cuda")
    s_tn = tp["tp_nan"][4]
    def n_diff(x, y):
        return sum(a != b for a, b in zip(x, y))

    # per request: tokens differing from the fault-free engine's, from
    # synchronous_generate's, and the oracle's from the engine's
    per_req = [(n_diff(n, c), n_diff(n, y), n_diff(y, c))
               for n, c, y in zip(tp_nan, tp_clean, tp_sync)]
    tp_diff = sum(d[0] for d in per_req)
    tp_sync_diff = sum(d[2] for d in per_req)
    print(f"[resilience] transprecision nan_logits (measured, not held): "
          f"tokens differing from the fault-free engine's {tp_diff} of "
          f"{sum(map(len, tp_clean))}, synchronous_generate's from the "
          f"engine's {tp_sync_diff}; per request (faulted run vs engine, "
          f"faulted run vs synchronous_generate, synchronous_generate vs "
          f"engine) {per_req}; quarantines {s_tn['quarantines']}, "
          f"failures {s_tn['failures']}")
    _res_record(out, tp)
    out["tp_nan_tokens_differing"] = per_req
    out["d_tp_ok"] = good_dt
    ok &= good_dt
    del params, runs, tp
    torch.cuda.empty_cache()

    # ---- (c) quarantine + replay under binary32 ------------------------
    policy, params = weights("binary32")
    f32 = {}
    for name, requests, max_new, extra in (
            ("f32_clean", F32_REQUESTS, RES_F32_MAX_NEW, ()),
            ("f32_nan", F32_REQUESTS, RES_F32_MAX_NEW,
             ("--fault-plan", "nan_logits@3")),
            ("f32_clean48", RES_REQUESTS, RES_SPEC_MAX_NEW, ()),
            ("f32_spec", RES_REQUESTS, RES_SPEC_MAX_NEW,
             ("--speculate-k", str(SPEC_K), "--fault-plan", RES_DIV))):
        key = f"resilience_{name}"
        argv = _serve_argv(args, "paged", requests, max_new,
                           f"{key}_stats.jsonl", extra, policy="binary32")
        f32[name] = _res_breaker_serve(torch, libs, args, key, argv, params)
    prompts = [r.prompt for r in f32["f32_clean"][0]]
    t0 = time.perf_counter()
    sync = synchronous_generate(model, cfg, policy, params, prompts,
                                max_new=RES_F32_MAX_NEW,
                                capacity=SERVE_CAPACITY, device="cuda")
    sync_s = time.perf_counter() - t0
    clean = [r.generated for r in f32["f32_clean"][0]]
    nan_run = [r.generated for r in f32["f32_nan"][0]]
    s_nan = f32["f32_nan"][4]
    good_c = clean == nan_run == sync and s_nan["quarantines"] == 1 \
        and s_nan["faults_unfired"] == 0 and s_nan["failures"] == 0
    print(f"[resilience] (c) binary32 nan_logits: replayed tokens equal to "
          f"the fault-free engine's: {nan_run == clean}, to "
          f"synchronous_generate on the card ({sync_s:.2f} s): "
          f"{clean == sync}; quarantines {s_nan['quarantines']} "
          f"(pages {s_nan['quarantined_pages']}) "
          f"{'ok' if good_c else 'FAIL'}")
    good_d = _breaker_ok("binary32 target, with a nan_logits",
                         f32["f32_spec"], f32["f32_clean48"], quarantines=1)
    _res_record(out, f32)
    out["f32_sync_s"] = sync_s
    out["c_ok"], out["d_ok"] = good_c, good_d
    ok &= good_c and good_d

    # ---- (e) exit codes -------------------------------------------------
    codes = {}
    base_e = ["--arch", "llama3-8b", "--policy", "binary32",
              "--decode-impl", "paged", "--matmul-impl", "qmm_pallas",
              "--page-size", str(SERVE_PAGE), "--slots", "1",
              "--prompt-len", str(SERVE_PROMPT), "--max-new", "2",
              "--capacity", str(SERVE_CAPACITY), "--seed", str(args.seed)]
    codes["deadline"] = serve.cli_main(
        base_e + ["--requests", "2", "--deadline-steps", "1"], params=params)
    codes["crc_exhausted"] = serve.cli_main(
        base_e + ["--requests", "1", "--disaggregate", "--max-requeues",
                  "0", "--fault-plan", ",".join(["page_corrupt@1"] * 4)],
        params=params)
    good_e = codes == {"deadline": 71, "crc_exhausted": 72}
    out["exit_codes"] = codes
    print(f"[resilience] (e) cli_main exit codes {codes} (want deadline 71, "
          f"CRC-exhausted request with --max-requeues 0: 72) "
          f"{'ok' if good_e else 'FAIL'}")
    ok &= good_e
    del params
    torch.cuda.empty_cache()
    out["ok"] = ok
    return ok


# ---------------------------------------------------------------------------
# archs: the ninth slice's configs served at full width and depth
# ---------------------------------------------------------------------------

ARCHS = ("yi-9b", "mistral-nemo-12b", "command-r-35b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
ARCHS_PAGED = ("mistral-nemo-12b", "granite-moe-1b-a400m")
ARCH_REQUESTS, ARCH_SLOTS, ARCH_PROMPT, ARCH_MAX_NEW = 2, 2, 64, 8
ARCH_CAPACITY, ARCH_PAGE = 128, 64


def arch_launches(cfg, decode_impl):
    """What a decode step and a prefill chunk of ``cfg`` launch under
    transprecision with packed weights: ``(tuple per decode step, tuple
    per chunk, qmm by kernel per decode step, per chunk)``, tuples in
    ``libs`` order (qmm, paged_decode, flash_prefill, flash_decode,
    flexfloat_cast, norms), qmm by kernel (qmm_gemv, qmm_tile, qmm_tc).
    A layer: wq, wk, wv, wo, then the fused gated FFN and w_out (dense)
    or the binary32 router and w_in, w_gate, w_out once per expert
    (MoE), all packed bf16 on the tensor cores except the router (the
    GEMV at a decode step's 2 rows, qmm_tile in a 64-row chunk); the
    untied head one qmm_tc, the tied one ``torch.matmul``; two norms a
    layer and the final one."""
    L = cfg.n_layers
    head = 0 if cfg.tied_embeddings else 1
    tc = L * (4 + (3 * cfg.moe_experts if cfg.moe_experts else 2)) + head
    router = L if cfg.moe_experts else 0
    norms = 2 * L + 1
    dec = (tc + router, L if decode_impl == "paged" else 0, 0,
           0 if decode_impl == "paged" else L, 0, norms)
    pre = (tc + router, 0, L, 0, 0, norms)
    return dec, pre, (router, 0, tc), (0, router, tc)


def _arch_serve(torch, report, libs, args, arch, decode_impl, params, cfg):
    """One counted serve of ``arch`` over ``params``; the checks of
    :func:`run_archs`.  Returns (ok, the report entry)."""
    from repro_torch.engine import worker
    from repro_torch.models import moe

    key = f"{arch}/{decode_impl}"
    stats = f"archs_{arch}_{decode_impl}_stats.jsonl"
    argv = ["--arch", arch, "--policy", "transprecision",
            "--decode-impl", decode_impl, "--matmul-impl", "qmm_pallas",
            "--page-size", str(ARCH_PAGE), "--requests", str(ARCH_REQUESTS),
            "--slots", str(ARCH_SLOTS), "--prompt-len", str(ARCH_PROMPT),
            "--max-new", str(ARCH_MAX_NEW), "--capacity",
            str(ARCH_CAPACITY), "--seed", str(args.seed), "--stats-out",
            os.path.join(args.out, stats)]
    # the experts' launches: qmm_tc launches inside the grouped products
    real, experts = moe.pgrouped_dot, [0]

    def counted(*a, **k):
        before = libs[0].by_kernel.get("qmm_tc", 0)
        out = real(*a, **k)
        experts[0] += libs[0].by_kernel.get("qmm_tc", 0) - before
        return out
    moe.pgrouped_dot = counted
    try:
        reqs, per, launches, wall, peak = _drive_serve(
            torch, libs, argv, {"decode": (worker.DecodeWorker, "step"),
                                "prefill": (worker.PrefillWorker, "step")},
            params=params)
    finally:
        moe.pgrouped_dot = real
    want_dec, want_pre, want_dec_k, want_pre_k = arch_launches(
        cfg, decode_impl)
    norm_entry = "layernorm_launch" if cfg.norm == "layernorm" \
        else "rmsnorm_launch"
    calls = len(per["decode"]) + len(per["prefill"])
    ok = all(r.done and not r.failed for r in reqs)
    ok &= all(len(r.generated) == ARCH_MAX_NEW for r in reqs)
    ok &= all(0 <= t < cfg.vocab for r in reqs for t in r.generated)
    ok &= _counts_ok(per["decode"], want_dec)
    ok &= _counts_ok(per["prefill"], want_pre)
    ok &= _counts_ok(per["decode/kern"], want_dec_k)
    ok &= _counts_ok(per["prefill/kern"], want_pre_k)
    ok &= launches["norms_by_entry"] == {norm_entry: calls * want_dec[5]}
    ok &= experts[0] == calls * 3 * cfg.moe_experts * cfg.n_layers
    summary = _serve_summary(args, stats)
    entry = dict(
        arch=arch, decode_impl=decode_impl, n_layers=cfg.n_layers,
        d_model=cfg.d_model, params=cfg.param_count(),
        requests=len(reqs), tokens=sum(len(r.generated) for r in reqs),
        wall_s=wall, tok_per_s=summary["tokens_per_s"],
        ttft_mean_s=summary["ttft_mean_s"], decode_steps=len(per["decode"]),
        prefill_chunks=len(per["prefill"]), launches=launches,
        expert_qmm_tc_launches=experts[0], peak_mem_bytes=peak,
        per_decode_step=sorted(set(per["decode"])),
        per_prefill_chunk=sorted(set(per["prefill"])),
        qmm_kernels_per_decode_step=sorted(set(per["decode/kern"])),
        qmm_kernels_per_prefill_chunk=sorted(set(per["prefill/kern"])),
        want=dict(decode=want_dec, prefill=want_pre, decode_kern=want_dec_k,
                  prefill_kern=want_pre_k),
        generated=[r.generated for r in reqs], ok=ok)
    print(f"[archs] {arch} full ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), transprecision, qmm_pallas, {decode_impl}: "
          f"{len(reqs)} requests, {entry['tokens']} tokens in {wall:.2f} s, "
          f"{summary['tokens_per_s']} tok/s, TTFT mean "
          f"{summary['ttft_mean_s']} s, peak memory {peak / 1e9:.2f} GB "
          f"({report['nvidia_smi']})")
    print(f"[archs] {arch} {decode_impl}: per decode step "
          f"{entry['per_decode_step']} (want {want_dec}), per prefill chunk "
          f"{entry['per_prefill_chunk']} (want {want_pre}); qmm by kernel "
          f"(gemv, tile, tc) {entry['qmm_kernels_per_decode_step']} / "
          f"{entry['qmm_kernels_per_prefill_chunk']} (want {want_dec_k} / "
          f"{want_pre_k}); norms {launches['norms_by_entry']}; expert "
          f"qmm_tc launches {experts[0]} {'ok' if ok else 'FAIL'}")
    return ok, entry


def run_archs(torch, report, libs, args):
    """``serve.main`` on each of the ninth slice's configs at full width
    and full depth (random weights from ``--seed``, made once a config
    and served as they are): transprecision, ``qmm_pallas``,
    ``flash_pallas``, 2 requests x (64 + 8) over 2 slots, page 64,
    capacity 128; mistral-nemo-12b and granite-moe once more under
    ``paged``.  Asserted: every request gets its tokens; the launches of
    every decode step and every prefill chunk, by library and by qmm
    kernel (``arch_launches``); the norm kind (layernorm only for
    command-r); the experts' qmm_tc launches (3 x E a layer a call: every
    expert streams, kept rows or not); and each model freed before the
    next is built.  Measured: tok/s, TTFT, peak memory (init and serve)
    and the device busy share of one steady decode step (torch.profiler,
    device activity only).  MoE tokens are not held to speculative
    exactness (see ``check_logits_archs``)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models.registry import build

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    out = report["archs"] = {}
    ok = True
    for arch in ARCHS:
        model, cfg = build(arch)
        policy = get_policy("transprecision", decode_impl="flash_pallas",
                            matmul_impl="qmm_pallas")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = model.init_params(gen, policy, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        for dec in ("flash_pallas",) + (("paged",) if arch in ARCHS_PAGED
                                        else ()):
            good, entry = _arch_serve(torch, report, libs, args, arch, dec,
                                      params, cfg)
            entry.update(init_s=init_s, init_peak_mem_bytes=init_peak)
            ok &= good
            out[f"{arch}/{dec}"] = entry
        argv = ["--arch", arch, "--policy", "transprecision",
                "--decode-impl", "flash_pallas", "--matmul-impl",
                "qmm_pallas", "--page-size", str(ARCH_PAGE), "--requests",
                str(ARCH_REQUESTS), "--slots", str(ARCH_SLOTS),
                "--prompt-len", str(ARCH_PROMPT), "--max-new", "4",
                "--capacity", str(ARCH_CAPACITY), "--seed", str(args.seed)]
        busy, wall, top, steps, rows = _profiled_serve(
            torch, argv, window=1, params=params, cpu=False)
        out[f"{arch}/flash_pallas"].update(
            step_wall_s=wall, step_device_busy_s=busy,
            step_busy_share=busy / wall, step_top=top[:5])
        print(f"[archs] {arch}: one steady decode step {wall * 1e3:.1f} ms "
              f"wall, device busy {busy * 1e3:.2f} ms "
              f"({100 * busy / wall:.1f} %); top: "
              + ", ".join(f"{e['name'][:40]} {e['device_ms']:.2f} ms "
                          f"x{e['count']}" for e in top[:3]))
        del params, model, rows
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base
        freed = left < (256 << 20)
        ok &= freed
        out[f"{arch}/flash_pallas"]["left_after_free_bytes"] = left
        print(f"[archs] {arch} freed: {left / 1e6:.1f} MB left above the "
              f"phase's start {'ok' if freed else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 11: paper -- the six apps, their tuner and the energy model
# ---------------------------------------------------------------------------

PAPER_CACHE = os.path.join(ROOT, "results", "paper", "tuning_cache.json")
PAPER_EPS = (1e-1, 1e-2, 1e-3)


def _stats_payload(stats):
    """The reference cache's stats payload (``benchmarks/paper_results``)."""
    return {
        "fp_elems": {f"{k[0]}|{int(k[1])}": v
                     for k, v in stats.fp_elems.items()},
        "fp_instrs": {f"{k[0]}|{int(k[1])}": v
                      for k, v in stats.fp_instrs.items()},
        "casts": {f"{k[0]}|{k[1]}": v for k, v in stats.casts.items()},
        "mem_words": {f"{k[0]}|{int(k[1])}": v
                      for k, v in stats.mem_words.items()},
        "other": stats.other_instrs,
        "narrow_fraction": stats.narrow_fraction(),
        "vector_fraction": stats.vector_fraction(),
        "total_casts": stats.total_casts(),
    }


def _cost_payload(rep):
    return {"cycles": rep.cycles, "energy_pj": rep.energy_pj,
            "fp_pj": rep.energy_fp_pj, "mem_pj": rep.energy_mem_pj,
            "other_pj": rep.energy_other_pj, "mem_words": rep.mem_words}


def _counted_run(app, formats, inputs):
    """One counted run on the card: (stats payload, cost payload, the
    CostReport)."""
    from repro_torch.apps.common import TPContext
    from repro_torch.core import energy
    ctx = TPContext(formats, device="cuda")
    app.run(ctx, inputs)
    rep = energy.cost(ctx.stats)
    return _stats_payload(ctx.stats), _cost_payload(rep), rep


def _binding_diffs(art, want):
    """Keys of the tuned artifact that differ from the cache's: every
    provenance key but the tuner's name and final_error exactly, and the
    formats; (diffs, relative final_error deviation)."""
    got_p, want_p = art["provenance"], want["provenance"]
    diffs = [k for k in want_p if k not in ("tuner", "final_error")
             and got_p.get(k) != want_p[k]]
    if art["formats"] != want["formats"]:
        diffs.append("formats")
    dev = abs(got_p["final_error"] - want_p["final_error"]) \
        / max(abs(want_p["final_error"]), 1e-300)
    return diffs, dev


def run_paper(torch, report, libs):
    """The paper's six apps on the card, held to the reference's cache
    ``results/paper/tuning_cache.json`` (read, never written): for each
    app the binary32 baseline (``gen_inputs(seed=1000)``), then
    ``tune(app, eps, n_input_sets=2, type_system="V2")`` at eps 1e-1,
    1e-2 and 1e-3 with the tuned run's stats and cost, and PCA's
    ``manual_vec`` runs of the three bindings (the cache re-tunes for
    them; the tuner is deterministic, so the binding is the one just
    tuned).  Formats, precisions, needs_wide, sizes, n_evals and the
    other provenance keys equal the cache's, final_error within 1e-5
    relative, every count of the stats payload, the cost and the
    ``relative`` entries equal.  Every evaluation's quantize runs on
    ``TPContext(device="cuda")``, so through the flexfloat_cast kernel:
    its launches are counted per evaluation, and the plain codec's bit
    math must meet no CUDA tensor (``codec._quantize`` / ``_encode`` /
    ``_decode`` are watched)."""
    from repro_torch.apps import all_apps
    from repro_torch.apps.pca import Pca
    from repro_torch.core import energy
    from repro_torch.core.tuning import tune
    from repro_torch.kernels import codec

    with open(PAPER_CACHE) as f:
        cache = json.load(f)["apps"]
    ff = libs[4]
    plain_on_card = []
    saved = {n: getattr(codec, n) for n in ("_quantize", "_encode",
                                             "_decode")}

    def watched(name, fn):
        def w(x, *a, **k):
            if x.is_cuda:
                plain_on_card.append(name)
            return fn(x, *a, **k)
        return w
    for n, fn in saved.items():
        setattr(codec, n, watched(n, fn))
    ok, rows, worst_dev = True, {}, 0.0
    for lib in libs:
        lib.reset_counts()               # counts of the apps' path only
    t_all = time.perf_counter()
    try:
        for app in all_apps():
            per_eval = []
            run = app.run

            def counted(ctx, inputs, _run=run, _per=per_eval):
                before = ff.launches
                out = _run(ctx, inputs)
                _per.append(ff.launches - before)
                return out
            app.run = counted
            t0 = time.perf_counter()
            entry = cache[app.name]
            inputs = app.gen_inputs(seed=1000)
            stats, cost, base = _counted_run(app, {}, inputs)
            res_app = {"baseline": dict(
                stats_equal=stats == entry["baseline"]["stats"],
                cost_equal=cost == entry["baseline"]["cost"])}
            good = all(res_app["baseline"].values())
            tuned = {}
            for eps in PAPER_EPS:
                key = f"eps{eps:g}|V2"
                res = tune(app, eps, n_input_sets=2, type_system="V2",
                           device="cuda")
                tuned[eps] = res
                diffs, dev = _binding_diffs(res.to_artifact(),
                                            entry[key]["artifact"])
                stats, cost, rep = _counted_run(app, res.formats,
                                                inputs)
                row = dict(binding_diffs=diffs, final_error=res.final_error,
                           final_error_rel_dev=dev, n_evals=res.n_evals,
                           stats_equal=stats == entry[key]["stats"],
                           cost_equal=cost == entry[key]["cost"],
                           relative_equal=energy.relative(rep, base)
                           == entry[key]["relative"])
                row["ok"] = (not diffs and dev <= 1e-5 and row["stats_equal"]
                             and row["cost_equal"] and row["relative_equal"])
                worst_dev = max(worst_dev, dev)
                good &= row["ok"]
                res_app[key] = row
            if app.name == "PCA":
                mv = Pca()
                mv.manual_vec = True
                for eps in PAPER_EPS:
                    key = f"eps{eps:g}|V2|manual_vec"
                    stats, cost, rep = _counted_run(mv, tuned[eps].formats,
                                                    inputs)
                    row = dict(stats_equal=stats == entry[key]["stats"],
                               cost_equal=cost == entry[key]["cost"],
                               relative_equal=energy.relative(rep, base)
                               == entry[key]["relative"])
                    row["ok"] = all(row.values())
                    good &= row["ok"]
                    res_app[key] = row
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            app.run = run
            res_app.update(
                wall_s=wall, evaluations=len(per_eval),
                launches_per_evaluation=dict(
                    min=min(per_eval), max=max(per_eval),
                    mean=sum(per_eval) / len(per_eval)),
                flexfloat_cast_launches=sum(per_eval), ok=good)
            rows[app.name] = res_app
            ok &= good
            print(f"[paper] {app.name:<6} baseline + 3 V2 bindings"
                  f"{' + 3 manual_vec' if app.name == 'PCA' else ''}: "
                  f"{len(per_eval)} evaluations on the card in {wall:.2f} "
                  f"s, flexfloat_cast launches per evaluation "
                  f"{min(per_eval)}-{max(per_eval)} (mean "
                  f"{sum(per_eval) / len(per_eval):.1f}), n_evals "
                  f"{[tuned[e].n_evals for e in PAPER_EPS]}; equal to the "
                  f"cache: {good} "
                  + ("ok" if good else f"FAIL {res_app}"))
    finally:
        for n, fn in saved.items():
            setattr(codec, n, fn)
    total = time.perf_counter() - t_all
    launches = dict(ff.by_symbol)
    ok &= launches.get("flexfloat_cast_launch", 0) > 0
    ok &= not plain_on_card
    report["paper"] = dict(apps=rows, wall_s=total,
                           worst_final_error_rel_dev=worst_dev,
                           launches={lib.name: lib.launches for lib in libs},
                           flexfloat_cast_by_entry=launches,
                           plain_codec_calls_on_card=len(plain_on_card),
                           ok=ok)
    print(f"[paper] 18 V2 bindings and PCA's manual_vec runs against "
          f"results/paper/tuning_cache.json: largest final_error deviation "
          f"{worst_dev:.2e} (tol 1e-5 relative); flexfloat_cast launches "
          f"{launches}; plain codec calls on CUDA tensors "
          f"{len(plain_on_card)}; {total:.1f} s {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 12: serve_tune -- the serve-time tuner at full width, then serving
# its artifact
# ---------------------------------------------------------------------------

TUNE_EPS = 0.1
TUNE_ARGV = ("--arch", "llama3-8b", "--sets", "1", "--prompts", "2",
             "--prompt-len", "16", "--decode-steps", "2", "--kv-groups",
             "2", "--max-rounds", "1", "--eps", str(TUNE_EPS))
TUNED_REQUESTS, TUNED_PROMPT, TUNED_MAX_NEW = 2, 16, 8


def run_serve_tune(torch, report, libs, args):
    """``python -m repro_torch.tuning`` (``__main__.main``) on full-width,
    full-depth llama3-8b with the card's default decode (``flash_pallas``):
    1 calibration set x 2 prompts of 16 tokens, 2 decode positions, 2 KV
    depth groups, 1 round, eps 0.1, writing ``serve_tune.json`` under
    ``--out``.  Holds: final KL <= eps; tuned bytes below the binary32
    bytes; the artifact round-trips to ``to_policy()``; every prefill
    launches 32 flash_prefill and every decode step 32 flash_decode (so
    no attention ran the plain path on the card); peak memory under the
    card's.  Then the artifact serves 2 requests x (16 + 8) through
    ``serve.main(["--policy", path, ...])`` with packed weights."""
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models.transformer import Model
    from repro_torch.tuning import __main__ as tune_cli

    path = os.path.join(args.out, "serve_tune.json")
    argv = list(TUNE_ARGV) + ["--seed", str(args.seed), "--out", path]
    calls = {"prefill": 0, "decode": 0}
    saved = {k: getattr(Model, a) for k, a in (("prefill", "prefill"),
                                               ("decode", "decode_step"))}

    def counting(kind):
        def fn(self, *a, **k):
            calls[kind] += 1
            return saved[kind](self, *a, **k)
        return fn
    Model.prefill, Model.decode_step = counting("prefill"), \
        counting("decode")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for lib in libs:
        lib.reset_counts()               # counts of the tuner's path only
    t0 = time.perf_counter()
    try:
        res = tune_cli.main(argv)
    finally:
        Model.prefill, Model.decode_step = saved["prefill"], saved["decode"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {lib.name: lib.launches for lib in libs}
    layers = configs.get("llama3-8b").n_layers
    attn = (libs[2].launches, libs[3].launches)
    want_attn = (layers * calls["prefill"], layers * calls["decode"])
    total = res.weight_bytes + res.kv_bytes_per_token
    total32 = res.weight_bytes_f32 + res.kv_bytes_per_token_f32
    card_mem = torch.cuda.get_device_properties(0).total_memory
    checks = dict(
        kl_within_eps=res.final_kl <= TUNE_EPS,
        bytes_below_f32=total < total32,
        artifact_round_trips=PrecisionPolicy.from_artifact(
            res.to_artifact()) == res.to_policy(),
        attention_on_kernels=attn == want_attn and min(attn) > 0,
        decode_is_flash=res.decode_impl == "flash_pallas",
        memory_under_card=peak < card_mem)
    print(f"[serve_tune] llama3-8b full (32 layers, d_model 4096): KL "
          f"{res.final_kl:.4g} (eps {TUNE_EPS}), {res.n_evals} evals, "
          f"formats {res.fmt_histogram()}, bytes {total}/{total32} "
          f"({total / total32:.3f}x f32), {calls['prefill']} prefills and "
          f"{calls['decode']} decode steps: (flash_prefill, flash_decode) "
          f"launches {attn} (want {want_attn}); peak memory "
          f"{peak / 1e9:.2f} GB of {card_mem / 1e9:.2f}; {wall:.1f} s; "
          f"checks {checks}")
    torch.cuda.empty_cache()

    stats = "serve_tune_stats.jsonl"
    serve_argv = ["--arch", "llama3-8b", "--policy", path, "--matmul-impl",
                  "qmm_pallas", "--requests", str(TUNED_REQUESTS), "--slots",
                  str(TUNED_REQUESTS), "--prompt-len", str(TUNED_PROMPT),
                  "--max-new", str(TUNED_MAX_NEW), "--capacity", "64",
                  "--page-size", "16", "--seed", str(args.seed),
                  "--stats-out", os.path.join(args.out, stats)]
    reqs, _, served, swall, speak = _drive_serve(torch, libs, serve_argv,
                                                 {})
    checks["artifact_serves"] = (
        len(reqs) == TUNED_REQUESTS
        and all(r.done and not r.failed and len(r.generated) == TUNED_MAX_NEW
                and all(0 <= t < 128256 for t in r.generated)
                for r in reqs)
        and served["flash_decode"] > 0 and served["flash_prefill"] > 0)
    ok = all(checks.values())
    report["serve_tune"] = dict(
        argv=argv, final_kl=res.final_kl, n_evals=res.n_evals,
        formats={k: f.name for k, f in res.formats.items()},
        fmt_histogram=res.fmt_histogram(), bytes=total, bytes_f32=total32,
        prefills=calls["prefill"], decode_steps=calls["decode"],
        launches=launches, wall_s=wall, peak_mem_bytes=peak,
        card_mem_bytes=card_mem, serve_launches=served, serve_wall_s=swall,
        serve_peak_mem_bytes=speak,
        generated=[r.generated for r in reqs], checks=checks, ok=ok)
    print(f"[serve_tune] --policy {os.path.relpath(path, ROOT)}: "
          f"{len(reqs)} requests x ({TUNED_PROMPT} + {TUNED_MAX_NEW}) in "
          f"{swall:.2f} s, launches {served} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

ALL_PHASES = ("build", "kernels", "casts", "ops", "serve", "serve_flash",
              "speculative", "serve_f32", "serve_reduced", "logits",
              "resilience", "archs", "paper", "serve_tune", "profile")


def kernel_rows(report):
    """The ``{"kernels": [...]}`` entries: one per kernel, its launches
    from the main-path run that drives it (the serve phase for qmm's
    tensor-core kernel, paged_decode and flash_prefill, serve_flash for
    flash_decode, the paper phase for flexfloat_cast (the ops phase's
    when paper did not run), the ops phase for the pack and unpack
    kernels and for qmm on packed activations, serve_f32 for qmm's
    CUDA-core kernels).  qmm has
    five rows: ``qmm_gemv`` (``qmm_launch`` at M <= 8, binary32 weights,
    times per decode step, launches of serve_f32's decode steps and
    heads), ``qmm_tile`` (``qmm_launch`` at M > 8, binary32, times and
    launches per prefill chunk), ``qmm_tc`` (``qmm_tc_launch``, times and
    launches per prefill chunk), ``qmm_tc_decode_step`` (the same kernel,
    times and launches per decode step) and ``qmm_packed_a`` (the same
    kernel on binary8 activations, M = 64, the ops phase's launches).
    ``rmsnorm`` and ``layernorm`` are port-only kernels (their
    ``replaces`` names the reference's XLA norm): times at a decode
    step's 4 rows, launches of the serve phase and of the archs phase's
    command-r-35b serve.  ``qmm_tc_expert``: one qwen3-moe expert launch
    (M 8, K 2048, N 768) timed, the archs phase's qwen3-moe serve's
    expert launches."""
    def timing(name, **match):
        return next((t for t in report["timings"] if t["kernel"] == name
                     and all(t.get(k) == v for k, v in match.items())), None)

    serve = report.get("serve", {}).get("launches", {})
    flash = report.get("serve_flash", {}).get("launches", {})
    archs = report.get("archs", {})
    ops_counts = report.get("ops", {}).get("launches", {}).get(
        "flexfloat_cast", {})
    paper_counts = report.get("paper", {}).get("flexfloat_cast_by_entry",
                                               ops_counts)
    casts_ok = bool(report.get("cast_kernels")) and all(
        c["ok"] for c in report["cast_kernels"]) and report.get(
            "cast_sweep", {}).get("ok", False)
    cast_err = 0.0 if casts_ok else None
    ff_src = "src/repro_torch/csrc/flexfloat_cast.cu"
    qmm_src, qmm_tpu = ("src/repro_torch/csrc/qmm.cu",
                        "src/repro/kernels/qmatmul.py:85")
    def by_kernel(key, what, kernel):
        counts = report.get(key, {}).get(f"{what}_launches_by_kernel")
        return counts[QMM_KERNELS.index(kernel)] if counts else 0

    f32_all = report.get("serve_f32", {}).get("launches", {}).get(
        "qmm_by_kernel", {})
    rows = [
        ("qmm_gemv", qmm_src, qmm_tpu, f32_all.get("qmm_gemv", 0),
         report.get("qmm_max_abs_err"), report.get("qmm_step_f32")),
        ("qmm_tile", qmm_src, qmm_tpu, f32_all.get("qmm_tile", 0),
         report.get("qmm_tile_max_abs_err"), report.get("qmm_chunk_f32")),
        ("qmm_tc", qmm_src, qmm_tpu, by_kernel("serve", "prefill", "qmm_tc"),
         report.get("qmm_tc_max_abs_err"), report.get("qmm_chunk")),
        ("qmm_tc_decode_step", qmm_src, qmm_tpu,
         by_kernel("serve", "decode", "qmm_tc"),
         report.get("qmm_tc_max_abs_err"), report.get("qmm_step")),
        ("qmm_packed_a", qmm_src, qmm_tpu,
         report.get("ops_packed_a_launches", 0),
         report.get("qmm_packed_a_max_abs_err"), timing("qmm_packed_a")),
        ("paged_decode", "src/repro_torch/csrc/paged_decode.cu",
         "src/repro/kernels/paged_attention.py:52",
         serve.get("paged_decode", 0), report.get("paged_max_abs_err"),
         timing("paged_decode")),
        ("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
         "src/repro/kernels/flash_attention.py:257",
         serve.get("flash_prefill", 0), report.get("prefill_max_abs_err"),
         timing("flash_prefill", q_offset=64)),
        ("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
         "src/repro/kernels/flash_attention.py:112",
         flash.get("flash_decode", 0),
         report.get("flash_decode_max_abs_err"), timing("flash_decode")),
        ("flexfloat_cast", ff_src,
         "src/repro/kernels/flexfloat_cast.py:33",
         paper_counts.get("flexfloat_cast_launch", 0), cast_err,
         timing("flexfloat_cast", fmt="binary16alt")),
        ("quantize_encode", ff_src,
         "src/repro/kernels/flexfloat_cast.py:37",
         ops_counts.get("quantize_encode_launch", 0), cast_err,
         timing("quantize_encode", fmt="binary16alt")),
        ("dequantize_decode", ff_src,
         "src/repro/kernels/flexfloat_cast.py:42",
         ops_counts.get("dequantize_decode_launch", 0), cast_err,
         timing("dequantize_decode", fmt="binary16alt")),
        # port-only: the reference's rmsnorm is XLA, not a TPU kernel
        ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:221",
         serve.get("norms_by_entry", {}).get("rmsnorm_launch", 0),
         report.get("rmsnorm_max_abs_err"), timing("rmsnorm", rows=4)),
        # port-only, as rmsnorm: the reference's layernorm is XLA
        ("layernorm", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:228",
         archs.get("command-r-35b/flash_pallas", {}).get("launches", {})
         .get("norms_by_entry", {}).get("layernorm_launch", 0),
         report.get("layernorm_max_abs_err"), timing("layernorm", rows=4)),
        ("qmm_tc_expert", qmm_src, qmm_tpu,
         archs.get("qwen3-moe-30b-a3b/flash_pallas", {}).get(
             "expert_qmm_tc_launches", 0),
         report.get("qmm_expert_max_abs_err"), timing("qmm_tc_expert")),
    ]
    kernels = []
    for name, source, replaces, launches, err, t in rows:
        if t is None:
            continue
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=err, ms=t["ms"],
                            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t.get("bound_by", "bytes"),
                            library_ms=t["library_ms"]))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--src", default=SRC,
                    help="the src/ directory whose repro_torch to drive "
                    "(another checkout's, to time its kernels beside "
                    "this one's with --phases build,timing)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    src = os.path.abspath(args.src)

    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        fail("run from the root of a checkout (src/repro_torch not found)",
             2)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the port on a CUDA card", 2)
    sys.path.insert(0, src)
    from repro_torch.kernels import (_build, flash_attention, flexfloat_cast,
                                     paged_attention, qmatmul, rmsnorm)

    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    libs = (qmatmul.LIB, paged_attention.LIB, flash_attention.LIB,
            flash_attention.DECODE_LIB, flexfloat_cast.LIB, rmsnorm.LIB)
    report = dict(seed=args.seed, src=src, cases=[], timings=[], casts=[],
                  cast_kernels=[], logits=[],
                  device=torch.cuda.get_device_name(0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report["nvidia_smi"] = smi
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {smi}")

    results = {}
    timer = None
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "build":
                secs = _build.build_all()
                report["build_s"] = secs
                print(f"[build] {len(libs)} libraries in {secs:.1f} s "
                      f"(build/kernels/{_build.build_dir().name})")
                with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
                    for lib in libs:
                        f.write(f"== {lib.name}\n{lib.ptxas_report()}\n")
                ok = True
                if hasattr(qmatmul, "TC_FMT_CODES"):
                    ok = check_tc_sass(qmatmul.LIB, report)
            elif phase == "kernels":
                timer = timer or Timer(torch)
                ok = check_qmm(torch, np, report)
                ok &= check_qmm_packed_a(torch, np, report)
                ok &= check_paged(torch, np, report, timer)
                ok &= check_prefill(torch, np, report, timer)
                ok &= check_flash_decode(torch, np, report)
                ok &= check_qmm_archs(torch, report, timer)
                time_kernels(torch, np, report, timer)
            elif phase == "timing":
                # the kernels' times alone (for --src)
                timer = timer or Timer(torch)
                time_kernels(torch, np, report, timer)
                time_cast_kernels(torch, np, report, timer)
                ok = True
            elif phase == "casts":
                timer = timer or Timer(torch)
                ok = check_casts(torch, np, report)
                ok &= check_cast_kernels(torch, np, report)
                ok &= check_cast_sweep(torch, report)
                time_cast_kernels(torch, np, report, timer)
            elif phase == "ops":
                ok = run_ops(torch, np, report, libs)
            elif phase == "serve":
                ok = run_serve(torch, report, libs, args)
            elif phase == "serve_flash":
                ok = run_serve(torch, report, libs, args, "flash_pallas",
                               "serve_flash")
            elif phase == "speculative":
                ok = run_speculative(torch, report, libs, args)
            elif phase == "serve_f32":
                ok = run_serve(torch, report, libs, args, "paged",
                               "serve_f32", policy="binary32")
            elif phase == "serve_reduced":
                ok = run_serve_reduced(torch, report, libs, args)
            elif phase == "logits":
                ok = check_logits(torch, report, args, qmatmul.LIB)
            elif phase == "resilience":
                timer = timer or Timer(torch)
                ok = run_resilience(torch, report, libs, args, timer)
            elif phase == "archs":
                ok = run_archs(torch, report, libs, args)
            elif phase == "paper":
                ok = run_paper(torch, report, libs)
            elif phase == "serve_tune":
                ok = run_serve_tune(torch, report, libs, args)
            elif phase == "profile":
                ok = run_profile(torch, report, args)
            else:
                raise ValueError(f"unknown phase {phase!r}")
        except Exception:  # noqa: BLE001 -- reported, and the run fails
            traceback.print_exc()
            ok = False
        torch.cuda.synchronize()
        results[phase] = ok
        secs = time.perf_counter() - t0
        report.setdefault("phase_seconds", {})[phase] = secs
        print(f"[phase] {phase}: {'ok' if ok else 'FAILED'} in "
              f"{secs:.1f} s", flush=True)

    kernels = kernel_rows(report)
    report["kernels"] = kernels
    report["phases"] = results
    with open(os.path.join(args.out, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if not all(results.values()) or set(ALL_PHASES) - {"profile"} \
            - set(phases):
        fail(f"phases: {results}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
