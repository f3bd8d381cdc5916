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
                  attention shapes (head_dim 8-256, G 1-16) and at
                  paligemma-3b's (the 256-row bidirectional prefix, MQA
                  decode: H 1, G 8, dh 256) and recurrentgemma-2b's (H 1,
                  G 10, dh 256, chunks of 64 and 36 under its window),
                  qmm at every projection, expert block, router and
                  untied head of yi-9b, mistral-nemo-12b, command-r-35b,
                  granite-moe, qwen3-moe, paligemma-3b, rwkv6-1.6b and
                  recurrentgemma-2b (each gated FFN with its config's
                  activation: paligemma's and recurrentgemma's gelu),
                  with the stated tolerances; qmm on
                  packed activations bit-identical to qmm on the
                  decoded ones; qmm,
                  flash_decode and paged_decode rows bit-identical
                  whatever rows are beside them, qmm_tile bit-identical
                  to the GEMV; times each kernel, its plain version and
                  a library yardstick (qmm per decode step, per prefill
                  chunk and per verify round, packed and binary32; one
                  qwen3-moe expert launch); the MoE expert product
                  (qmm_grouped, and qmm_grouped_ffn for the gated pair:
                  one device kernel a call) at qwen3-moe's and
                  granite-moe's expert shapes, C 8 and 20, binary16alt
                  and binary8, under router, empty, full and dropped
                  counts: bit for bit the per-expert qmm_tc and qmm_ffn
                  loops, dead rows +0, and timed at qwen3's 2- and
                  4-token routing beside torch.bmm; add_rmsnorm (the
                  residual add, rmsnorm and the cast in one launch) bit
                  for bit its plain version at 1-64 rows and every
                  served rmsnorm width, NaN and Inf rows included;
                  add_layernorm (the same for layernorm) bit for bit its
                  plain version at 1-100 rows, d 384, 8192 and 8320.
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
                  all 193 on tensor cores in both; and 65 norms, each
                  one fused add_rmsnorm, no standalone residual add).
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
                  llama3-8b and command-r-35b (layernorm, tied head);
                  llama3-8b's and command-r-35b's logits on the fused
                  norm route bit for bit those on the three-step route
                  (add, norm, cast); a
                  2-layer qwen3-moe: kernel path against plain path, and
                  the qmm router's experts equal the plain product's;
                  2-layer qwen3-moe and granite-moe logits on the grouped
                  expert product bit for bit those on the per-expert
                  loops; 2-layer paligemma-3b on random prefix
                  embeddings: kernel path against plain path, the
                  engine's route (whole prefill, write_prefill, paged
                  decode) bit for bit the contiguous route, and the
                  random prefix's logits apart from the zero prefix's;
                  2-layer rwkv6-1.6b and 3-layer recurrentgemma-2b over
                  a 100-token prompt chunked 64 + 36 with the recurrent
                  states carried: kernel path against plain path, and
                  under binary32 the chunked route against the whole
                  prompt.
10. resilience -- the engine's fault and recovery surface at full width
                  (``run_resilience``): the streamed handoff with the
                  router and two prefill workers, bit for bit the
                  colocated run, without and with a seeded fault plan;
                  binary32 quarantine and replay equal to the engine and
                  to synchronous_generate; the speculative circuit
                  breaker; the CLI's exit codes; rmsnorm rows bit-identical
                  at every row count at d 1024-8192, the kernel against
                  its twin, and its times (add_rmsnorm's too); layernorm
                  bit-identical to its
                  twin, its rows at every row count at d 8192 and 384,
                  and its times (add_layernorm's too).
11. archs      -- ``serve.main`` on yi-9b, mistral-nemo-12b, command-r-35b,
                  granite-moe-1b-a400m, qwen3-moe-30b-a3b,
                  paligemma-3b (after its 256 stub prefix rows, capacity
                  384), rwkv6-1.6b and recurrentgemma-2b (2 x (100 + 8),
                  the prompt in chunks of 64 + 36) at full width and
                  depth (transprecision, qmm_pallas, flash_pallas, 2 x
                  (64 + 8)), mistral-nemo, granite, paligemma and
                  recurrentgemma also under paged:
                  launches per decode step and prefill chunk by kernel
                  (every norm one fused add_rmsnorm or add_layernorm, no
                  standalone residual add), the tied heads' torch.matmul
                  pieces, the gated FFN's launches, every slot's rows
                  when its prompt lands (prefix + prompt), the tokens of
                  every prefill call,
                  the experts' launches (2 grouped calls a layer, one
                  device kernel each, no per-expert qmm_tc), one MoE
                  layer with no host synchronisation, tok/s, peak
                  memory, the device busy share and device activities of
                  a decode step, each model freed before the next.
    encdec     -- whisper-tiny, the encoder-decoder, at full width and
                  depth (4 + 4 layers, d 384, 1500 frames, vocab
                  51,865; transprecision, qmm_pallas): (a) on random
                  frame embeddings and random biases, gammas and betas,
                  a 64-token prefill and 8 decode steps that re-encode,
                  kernel route (flash_pallas, paged) against plain route
                  within LOGIT_TOL under binary32 and transprecision,
                  ``enc_out=`` bit for bit ``encoder_embeds=``, and the
                  random frames' logits apart from the zero frames'; (b)
                  ``synchronous_generate`` of 2 x (64 + 8) at capacity
                  128 under flash_pallas and paged, the launches of
                  every prefill and decode step asserted (65 qmm_tc, 4
                  attention kernels, 21 add_layernorm), TTFT, tok/s, peak
                  memory and one profiled decode step; (c) ``python -m
                  repro_torch.tuning --arch whisper-tiny`` (KL within
                  eps, fewer bytes than binary32, the artifact
                  round-trips, 4 flash_prefill a prefill and 4
                  flash_decode a decode step); (d) flash_prefill,
                  flash_decode, paged_decode (H 6, G 1, dh 64) and
                  add_layernorm (d 384, 1 and 1500 rows) against their
                  plain versions, and every kernel at its shapes timed
                  beside its bound and a library call, the plain torch
                  encoder and cross attention cores beside SDPA.  Its
                  qmm products (M 1, 64, 1500; the FFN's bias in the
                  epilogue) are held in the kernels phase.
    train      -- training at full width (``run_train``): llama3-8b (d
                  4096, 32 H, 8 KV, d_ff 14,336, vocab 128,256) cut to 4
                  layers by ``dataclasses.replace``: ``flash_prefill_diff``
                  at its attention shape (B 8, S 128, H 8, G 4, dh 128)
                  against an eager autograd of the plain version, timed
                  with the plain recompute backward; step 0's loss and
                  grads on flash_pallas against xla (binary32 and
                  transprecision); the train forward's last logits
                  against ``Model.prefill``; 8 transprecision steps
                  (batch 8 x 128, lr 1e-3): finite, decreasing losses,
                  each step's wall and device time, 8 ``flash_prefill``
                  and 17 ``add_rmsnorm`` launches a step (the remat
                  recompute included) and nothing else, the peak memory;
                  a checkpoint at step 3 restored and resumed bit for
                  bit; whisper-tiny at full depth for 4 steps (its
                  encoder's grads non-zero); ``launch.train.main`` on
                  four reduced configs.
    prefill_cont -- ``attention.prefill_from_cache`` at llama3-8b's full
                  width, one layer: a 64-row chunk at q_offset 64 over a
                  64-row e5m2 cache through one ``flash_prefill`` launch,
                  within 1e-6 of the plain version; under binary32
                  within 1e-5 x max|out| of one whole prefill; the ring
                  and overflow ``ValueError``s; the kernel timed.
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
    tune_archs -- the same tuner run on rwkv6-1.6b, recurrentgemma-2b
                  and paligemma-3b at full width and depth (the
                  recurrent states bound through the kv_cache groups;
                  paligemma's 256 zero prefix rows prefilled and counted
                  in the capacity): KL within eps, fewer bytes, the
                  artifact round-trips, one flash_prefill a prefill and
                  one flash_decode a decode step per attention layer
                  (recurrentgemma 8, paligemma 18, rwkv6 none); checks
                  that do not saturate as the KL does on random weights:
                  every candidate prefill's recurrent states and caches
                  in their layer's kv_cache binding's dtype (a candidate
                  with two among them seen), the capacity counting the
                  prefix rows, every decode step reading them; each
                  artifact serves 2 requests x (16 + 8).
    mesh       -- (a) a 1-rank NCCL process group and the (1, 1)
                  ("data", "model") mesh made ambient: the serving
                  default under it is flash_shmap+flash_pallas, and
                  llama3-8b at full width serves 2 x (64 + 8) through
                  flash_shmap+flash_pallas, flash_shmap+paged,
                  ring+flash_pallas and ring+paged under binary32 and
                  transprecision: the sharded branch taken once a layer
                  a decode step, 32 launches of the base's kernel a
                  step, tokens equal the base spelling's and logits
                  within 1e-6 x max|logit|; one steady transprecision
                  decode step of flash_pallas and its two wrapped
                  spellings profiled with its host ops; (b)
                  flash_decode and paged_decode at shard-local inputs
                  split on the host
                  (2, 4 and 8 shards of the serve shape and paligemma's
                  MQA shape, rows with nothing live in a shard and
                  all -1 tables among them): (o, m, l) against the
                  split twins, empty rows exactly (0, NEG_INF, 0), and
                  the port's merge and ring fold of the shards within
                  1e-6 of the unsharded kernel; the byte models at each
                  split.
    train_mesh -- multi-device training on a 1-rank NCCL mesh (its own
                  process group, started after mesh's is destroyed):
                  (a) llama3-8b at full width, 4 of 32 layers, batch 8 x
                  128, flash_pallas, transprecision: 3 sharded steps
                  (params and AdamW state by tree_param_shardings, the
                  batch by batch_spec) whose losses equal the train
                  phase's unsharded steps bit for bit, 8 flash_prefill
                  and 17 add_rmsnorm a step and nothing else, peak GB
                  and device ms; a checkpoint saved under the mesh
                  restores with shardings= bit for bit; 2 more steps
                  with the gradients reduced in binary8 with stochastic
                  rounding (the stochastic cast kernel, one launch a
                  leaf); (b) granite-moe-1b-a400m at full size,
                  moe_impl="shard_map", binary32: 3 steps whose losses
                  equal moe_impl="dense"'s bit for bit; (c)
                  qwen3-moe-30b-a3b at full width, forward only: a
                  64-row chunk and a decode step under shard_map (its
                  packed leaves dequantized) against the dense packed
                  path, at 48 layers finite and reported, at 2 layers
                  within 2^-5 x max|logit|; (d) the stochastic cast
                  kernel bit for bit its plain version with the same
                  bits (4096 x 14336 f32 and ragged sizes, the four
                  paper formats), timed against its 12-byte bound;
                  compressed_psum, compressed_allgather_sum and
                  tree_compress_psum over step (a)'s gradients on the
                  1-rank mesh (a dim of one rank runs no collective)
                  bit for bit decompress(compress(...)), their wire
                  bytes; (e) params + AdamW state per rank under (1,
                  2), (1, 4), (2, 4) and (16, 16) for llama3-8b at 32
                  layers and qwen3-moe-30b-a3b, from the rules on the
                  meta device.
    rwkv_fused -- rwkv6-1.6b with rwkv_fused=1 (the reference's fused
                  token shift: wrkvg 2048 x 8256, cm_kr 2048 x 9216) at
                  full width and depth through serve.main(["--set",
                  "rwkv_fused=1", ...]): 2 x (100 + 8) in chunks of 64 +
                  36, 97 qmm_tc, 48 dequantize_decode, 48 plain dxx @ wm
                  products and 49 add_layernorm a decode step or chunk;
                  one profiled steady decode step beside the unfused
                  config's; dequantize_decode at the two leaves bit for
                  bit and timed, the derived weights and their products
                  timed; logits at 2 layers, kernel route against the
                  plain route; one training step at 4 layers.
    dryrun     -- the compile-only tooling: the single-mesh sweep of
                  launch/dryrun.py on the host (10 configs x 4 shapes on
                  meta tensors, 21 jobs started after the build at
                  nice 19; 32 ok, the 8
                  long_500k of the quadratic configs skipped), rwkv6's
                  train_4k with and without rwkv_fused=1 (5 all-gathers
                  fewer a layer), the report's tables to
                  dryrun_report.md, and llama3-8b decode_32k at rank 0's
                  share run for real on the card: its bytes against the
                  cell's gathered arguments, its device time against the
                  cell's t_memory_s, within the stated tolerances.
14. profile    -- short paged and speculative serve runs under
                  torch.profiler: device busy share and the kernels that
                  take the device time; one steady decode step's device
                  activities; the host syncs of a tiny serve.

``--phases build,archs --archs command-r-35b`` serves one config alone
(with ``--src``, another checkout's, for its tokens and launches).
``--phases build,timing --src OTHER/src`` times another checkout's
qmm (decode step, prefill chunk, verify round, packed and binary32),
flash_prefill, paged_decode, flash_decode and the three cast kernels
with this script's timing code, e.g. a parent commit unpacked into a
git-ignored directory, to set its kernels beside this checkout's in one
chip call; ``--phases build,steps --src OTHER/src`` profiles one steady
decode step of full-width llama3-8b and qwen3-moe there (wall, device
busy time, device activities, norm and grouped expert kernels).

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
import contextlib
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
NORMS = 65                  # norm launches a llama3-8b step: 2 x 32 + 1,
                            # each a fused add_rmsnorm (the first adds
                            # nothing)


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

# counts each function's HMMA / HGMMA instructions in a SASS listing (run
# in a process of its own: the qmm library's listing is large)
_SASS_COUNT = r"""
import json, subprocess, sys
sass = subprocess.run([sys.argv[1], "-sass", sys.argv[2]],
                      capture_output=True, text=True).stdout
counts, fn = {}, None
for line in sass.splitlines():
    if "Function :" in line:
        fn = line.split("Function :")[1].strip()
        counts[fn] = 0
    elif fn is not None and ("HMMA" in line or "HGMMA" in line):
        counts[fn] += 1
print(json.dumps(counts))
"""


def start_tc_sass(lib):
    """Start ``cuobjdump -sass`` of the built qmm library and the count of
    each function's HMMA / HGMMA instructions in a process of its own, so
    the next phases run beside it; :func:`check_tc_sass` reads it."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.Popen([sys.executable, "-c", _SASS_COUNT, tool,
                             str(lib.so_path)], stdout=subprocess.PIPE,
                            text=True)


def check_tc_sass(proc, report):
    """The result of :func:`start_tc_sass`: every instantiation of the
    tensor-core kernel ``qmm_tc`` must hold HMMA (or HGMMA) instructions.
    Counts per function go to the report."""
    out, _ = proc.communicate(timeout=900)
    counts = json.loads(out) if proc.returncode == 0 else {}
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


def arch_step_products(cfg):
    """The products one decode step or prefill call of ``cfg`` launches
    on ``qmm_tc``, by shape: ``[(names, K, N, gated act or None,
    launches)]``.  A layer: its mixer's (attention wq, wk, wv, wo; rwkv's
    time mix wr, wk, wv, wg, wo and channel mix cm_k, cm_v, cm_r, or
    under ``rwkv_fused`` wrkvg, wo, cm_kr and cm_v; the
    RG-LRU block's w_branch, w_gate, w_rec_gate, w_in_gate, w_out), then
    but for rwkv the fused gated FFN (one ``qmm_ffn``) and w_out; an MoE
    layer's experts are grouped launches and its router binary32, both
    apart.  The untied head is apart too (its rows are the step's, 1 in
    a prefill call: only the last position's logits)."""
    d, ff, w = cfg.d_model, cfg.d_ff, cfg.rglru_width
    gate = cfg.act_fn if cfg.gated_ffn else None
    prods = {}

    def add(name, K, N, act=None, n=1):
        names, c = prods.get((K, N, act), ((), 0))
        prods[(K, N, act)] = (names + ((name,) if name not in names
                                       else ()), c + n)
    for kind in cfg.attn_pattern:
        if kind == "attn":
            add("wq", d, cfg.q_dim)
            add("wk/wv", d, cfg.kv_dim, n=2)
            add("wo", cfg.q_dim, d)
        elif kind == "rwkv" and cfg.rwkv_fused:
            add("wrkvg", d, 4 * d + RWKV_RANK)
            add("wo", d, d)
            add("cm_kr", d, ff + d)
            add("cm_v", ff, d)
        elif kind == "rwkv":
            add("wr/wk/wv/wg/wo/cm_r", d, d, n=6)
            add("cm_k", d, ff)
            add("cm_v", ff, d)
        else:
            add("w_branch/w_gate", d, w, n=2)
            add("w_rec_gate/w_in_gate", w, w, n=2)
            add("rglru w_out", w, d)
        if kind != "rwkv" and not cfg.moe_experts:
            add(f"ffn gated {cfg.act_fn}" if gate else f"ffn {cfg.act_fn}",
                d, ff, gate)
            add("w_out", ff, d)
    return [("/".join(names), K, N, act, c)
            for (K, N, act), (names, c) in prods.items()]


RWKV_RANK = 64              # rwkv6's decay LoRA rank (wrkvg's last 64)


def fused_dense(cfg) -> int:
    """Plain products a call of ``cfg`` runs outside the kernels on a
    derived weight: under ``rwkv_fused`` two a rwkv layer (``dxx @ wm``
    in the time mix and the channel mix), each beside one
    ``dequantize_decode`` of its packed leaf (``qparams.as_array``)."""
    return 2 * cfg.attn_pattern.count("rwkv") if cfg.rwkv_fused else 0


def arch_qmm_cases(cfg):
    """The packed products a full-width ``cfg`` serves, as ``(name,
    M values, K, N, act of the gated epilogue or None, binary32)``, from
    the kinds of its layers: the attention projections, rwkv's time mix
    (wr, wk, wv, wg, wo) and channel mix (cm_k, cm_v, cm_r), the RG-LRU
    block's w_branch, w_gate, w_rec_gate, w_in_gate and w_out, and the
    dense fused gated FFN (with the config's own activation) with w_out,
    at a decode step's rows (4; a recurrent config's 2) and its prefill
    calls' (a 64-row chunk, a recurrent config's 64 and 36, a
    prefix-LM's whole prompt), or the MoE experts' blocks (M = capacity
    rows: 8 at a decode step, 64 in a chunk's worth; w_in with w_gate as
    one gated product, as ``qmm_ffn`` serves it) and the binary32
    router; the untied head at the decode rows (a tied head is
    ``torch.matmul``).  Products of one shape are one case."""
    d, ff = cfg.d_model, cfg.d_ff
    Ms = ((ARCH_SLOTS if recurrent(cfg) else 4),) + (
        (cfg.prefix_len + ARCH_PROMPT,) if cfg.prefix_len
        else arch_chunks(cfg))
    gate = cfg.act_fn if cfg.gated_ffn else None
    rows = [(name, Ms, K, N, act, False)
            for name, K, N, act, _ in arch_step_products(cfg)]
    if cfg.moe_experts:
        rows += [("router", Ms, d, cfg.moe_experts, None, True),
                 ("expert w_in/w_gate", (8, 64), d, ff, gate, False),
                 ("expert w_out", (8, 64), ff, d, None, False)]
    if not cfg.tied_embeddings:
        rows.append(("head", Ms[:1], d, cfg.vocab, None, False))
    cases = {}
    for name, Ms, K, N, gated, f32 in rows:
        key = (Ms, K, N, gated, f32)
        cases[key] = f"{cases[key]}/{name}" if key in cases else name
    return [(name,) + key for key, name in cases.items()]


def check_qmm_archs(torch, report, timer):
    """qmm at the served configs' shapes, taken from each full config by
    :func:`arch_qmm_cases`, against qmatmul_plain, within 1e-6 in units
    of |x| @ |w| + 1 (``check_qmm``'s tolerance): every packed product
    of yi-9b, mistral-nemo-12b, command-r-35b, granite-moe, qwen3-moe,
    paligemma-3b, rwkv6-1.6b and recurrentgemma-2b on the tensor cores
    (binary16alt), each gated FFN
    with its config's activation (paligemma's gelu epilogue at its
    decode step's and whole prompt's rows), and the binary32 routers
    (K x E) on the GEMV (M 4) and ``qmm_tile`` (M 64); and whisper-tiny's
    (``encdec_qmm_cases``: M 1, 64 and 1500, the ungated gelu FFN with
    its bias in the epilogue, the head's ragged N 51,865); and the fused
    rwkv6's ``wrkvg`` (K 2048, N 8256) and ``cm_kr`` (N 9216) at M 2, 64
    and 36.  Then one qwen3
    expert launch (M 8, K 2048, N 768) timed against its bound and
    torch.matmul, and paligemma's gated gelu FFN (``time_qmm_gelu``)."""
    from repro_torch import configs
    from repro_torch.core.formats import BINARY16ALT, BINARY32
    from repro_torch.core.qtensor import decode
    from repro_torch.kernels import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 13)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ok, worst, res = True, {"all": 0.0, "expert": 0.0}, {}
    cases = [(arch, name, M, K, N, act, act is not None,
              BINARY32 if f32 else BINARY16ALT, False)
             for arch in ARCHS
             for name, Ms, K, N, act, f32 in arch_qmm_cases(
                 configs.get(arch))
             for M in Ms]
    # the fused rwkv6's two wide products (N 8256 and 9216; its wo, cm_v
    # and head are rwkv6's)
    cases += [(FUSED_LABEL, name, M, K, N, act, False, BINARY16ALT, False)
              for name, Ms, K, N, act, _ in arch_qmm_cases(fused_cfg())
              if name in ("wrkvg", "cm_kr") for M in Ms]
    # whisper-tiny's ungated gelu FFN, the bias in the epilogue
    cases += [(ENCDEC_ARCH, name, M, K, N, act, False, BINARY16ALT, bias)
              for name, M, K, N, act, bias in encdec_qmm_cases(
                  configs.get(ENCDEC_ARCH))]
    for arch, name, M, K, N, act, gated, fmt, bias in cases:
        x = rand(M, K)
        wp = _pack_weight(rand(K, N), fmt)
        gp = _pack_weight(rand(K, N), fmt) if gated else None
        b = rand(N) * 0.1 if bias else None
        got = Q.qmatmul(x, wp, None, fmt, gate_payload=gp, bias=b, act=act)
        want = Q.qmatmul_plain(x, wp, None, fmt, gate_payload=gp, bias=b,
                               act=act)
        xa = x.abs()
        unit = xa @ decode(wp, fmt).abs() + 1.0
        if gated:
            unit = unit * (xa @ decode(gp, fmt).abs() + 1.0)
        err = (got - want).abs()
        norm = float((err / unit).max())
        good = norm <= 1e-6
        ok &= good
        for k in (("all", "expert") if name.startswith("expert")
                  else ("all", "whisper") if arch == ENCDEC_ARCH
                  else ("all", "fused") if arch == FUSED_LABEL
                  else ("all", "gelu") if act == "gelu" else ("all",)):
            worst[k] = max(worst.get(k, 0.0), float(err.max()))
        key = f"{arch} {name[:28]} M={M} K={K} N={N} {fmt.name}" \
            + (" +bias" if bias else "")
        res[key] = norm
        report["cases"].append(dict(kernel="qmm", case=f"{arch} {name}",
                                    M=M, K=K, N=N, fmt=fmt.name,
                                    gated=gated, act=act, bias=bias,
                                    path=Q.qmm_kernel(fmt, M),
                                    max_abs_err=float(err.max()),
                                    max_err_in_acc_units=norm, ok=good))
        print(f"[kernels] qmm {key:<60} {Q.qmm_kernel(fmt, M):<8} "
              f"max|err|={float(err.max()):.3e} ({norm:.2e} x |x|@|w|, "
              f"tol 1e-6) {'ok' if good else 'FAIL'}")
        del x, wp, gp, b, got, want, xa, unit, err
    torch.cuda.empty_cache()
    report["qmm_archs_max_abs_err"] = worst["all"]
    report["qmm_expert_max_abs_err"] = worst["expert"]
    report["qmm_gelu_max_abs_err"] = worst.get("gelu")
    report["qmm_whisper_max_abs_err"] = worst.get("whisper")
    report["qmm_fused_max_abs_err"] = worst.get("fused")

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
    print(f"[kernels] qmm at the served configs' shapes: {len(res)} "
          f"cases, worst {max(res.values()):.2e} x |x|@|w| (tol 1e-6) "
          f"{'ok' if ok else 'FAIL'}")
    time_qmm_gelu(torch, report, timer)
    return ok


RECURRENT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")


def time_qmm_recurrent(torch, report, timer):
    """qmm_tc at rwkv6-1.6b's (also with ``rwkv_fused=1``: wrkvg, wo,
    cm_kr, cm_v) and recurrentgemma-2b's widths, binary16alt:
    every packed product of a decode step (M 2, the 2 slots; the untied
    head at N 65,536 included) and of a 64-row prefill chunk (the head at
    the last row), each shape timed once and counted as often as the
    step launches it (``arch_step_products``): kernel, plain version and
    ``torch.matmul`` on the dequantized f32 weights (the gated gelu FFN:
    ``gelu(x @ w_in) * (x @ w_gate)``), and the bound of the step's bytes
    and operations (``qmm_bound``).  Then the fused norms at their
    decode rows: ``add_layernorm`` at 2 x 2048 (rwkv6: bf16 + bf16 ->
    bf16) and ``add_rmsnorm`` at 2 x 2560 (recurrentgemma: the f32
    residual of its scaled embedding + bf16 -> f32 residual, bf16
    rows), beside their plain versions, the torch sequence that computes
    the same and the byte bound."""
    from repro_torch import configs
    from repro_torch.core.formats import BINARY16ALT
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.kernels import rmsnorm as rms

    fmt = BINARY16ALT
    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 21)
    for arch, cfg in [(a, configs.get(a)) for a in RECURRENT_ARCHS] \
            + [(FUSED_LABEL, fused_cfg())]:
        prods = arch_step_products(cfg)
        head = [] if cfg.tied_embeddings else [
            ("head", cfg.d_model, cfg.vocab, None, 1)]
        for per, M in (("decode_step", ARCH_SLOTS), ("chunk", ARCH_PAGE)):
            totals = dict(arch=arch, per=per, M=M, fmt=fmt.name,
                          launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                          bytes=0, flops=0)
            for name, K, N, act, mult in prods + head:
                rows = 1 if name == "head" and per == "chunk" else M
                x = torch.randn((rows, K), generator=gen, device="cuda")
                wp = _pack_weight(torch.randn((K, N), generator=gen,
                                              device="cuda"), fmt)
                gp = _pack_weight(torch.randn((K, N), generator=gen,
                                              device="cuda"), fmt) \
                    if act else None
                wf = _unpack_weight(wp, fmt)
                gf = _unpack_weight(gp, fmt) if act else None
                t_k = timer(lambda: Q.qmatmul(x, wp, None, fmt,
                                              gate_payload=gp, act=act))
                t_p = timer(lambda: Q.qmatmul_plain(
                    x, wp, None, fmt, gate_payload=gp, act=act), iters=5)
                if act:
                    t_l = timer(lambda: torch.nn.functional.gelu(
                        x @ wf, approximate="tanh") * (x @ gf))
                else:
                    t_l = timer(lambda: torch.matmul(x, wf))
                nbytes = Q.qmm_hbm_bytes(rows, K, N, fmt, gated=bool(act))
                flops = 2 * rows * K * N * (2 if act else 1)
                bound, by = qmm_bound(Q, fmt, nbytes, flops)
                report["timings"].append(dict(
                    kernel="qmm_recurrent", arch=arch, per=per, shape=name,
                    M=rows, K=K, N=N, act=act, launches_per=mult, ms=t_k,
                    plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                    bound_by=by, bytes=nbytes, flops=flops))
                print(f"[timing] qmm {arch} {per:<11} {name[:24]:<24} "
                      f"x{mult:<3} M={rows:<2} K={K:<5} N={N:<6} kernel "
                      f"{t_k:.4f} ms  plain {t_p:.4f} ms  torch.matmul "
                      f"{t_l:.4f} ms  bound {bound:.4f} ms ({by})")
                for k, v in (("launches", mult), ("ms", mult * t_k),
                             ("plain_ms", mult * t_p),
                             ("library_ms", mult * t_l),
                             ("bytes", mult * nbytes),
                             ("flops", mult * flops)):
                    totals[k] += v
                del x, wp, gp, wf, gf
                torch.cuda.empty_cache()
            totals["bound_ms"], totals["bound_by"] = qmm_bound(
                Q, fmt, totals["bytes"], totals["flops"])
            report["timings"].append(dict(kernel=f"qmm_tc_{arch}_{per}",
                                          **totals))
            print(f"[timing] qmm {arch} per {per} (M = {M}, {fmt.name}, "
                  f"{totals['launches']} launches): kernel "
                  f"{totals['ms']:.3f} ms  plain {totals['plain_ms']:.2f} ms"
                  f"  torch.matmul {totals['library_ms']:.3f} ms  bound "
                  f"{totals['bound_ms']:.3f} ms ({totals['bound_by']})")

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 22)
    for name, d, xdt in (("add_layernorm", 2048, bf),
                         ("add_rmsnorm", 2560, torch.float32)):
        rows = ARCH_SLOTS
        gamma = torch.randn((d,), generator=g, device="cuda") * 0.1
        beta = torch.randn((d,), generator=g, device="cuda") * 0.1
        x = (torch.randn((rows, d), generator=g, device="cuda") * 3.0).to(xdt)
        y = (torch.randn((rows, d), generator=g, device="cuda") * 2.0).to(bf)
        if name == "add_layernorm":
            fn = lambda: ln.add_layernorm(x, y, gamma, beta, bf)  # noqa
            plain = lambda: ln.add_layernorm_plain(  # noqa: E731
                x, y, gamma, beta, bf)
            seq = lambda: torch.nn.functional.layer_norm(  # noqa: E731
                (x + y).float(), (d,), gamma, beta, 1e-5).to(bf)
            nbytes = ln.add_layernorm_hbm_bytes(rows, d, 2, 2, 2, 2)
        else:
            fn = lambda: rms.add_rmsnorm(x, y, gamma, bf)  # noqa: E731
            plain = lambda: rms.add_rmsnorm_plain(x, y, gamma, bf)  # noqa
            seq = lambda: torch.nn.functional.rms_norm(  # noqa: E731
                x + y.float(), (d,), weight=1.0 + gamma, eps=1e-6).to(bf)
            nbytes = rms.add_rmsnorm_hbm_bytes(rows, d, 4, 2, 4, 2)
        t_f, t_p, t_s = timer(fn), timer(plain), timer(seq)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel=f"{name}_recurrent", rows=rows, d=d,
            x_dtype=str(xdt), ms=t_f, plain_ms=t_p, torch_sequence_ms=t_s,
            library_ms=None, bound_ms=bound, bound_by="bytes",
            bytes=nbytes))
        print(f"[timing] {name} {rows} x {d} ({xdt} + bf16): kernel "
              f"{t_f:.4f} ms  plain {t_p:.4f} ms  torch sequence "
              f"{t_s:.4f} ms  bound {bound:.6f} ms")


def time_qmm_gelu(torch, report, timer):
    """paligemma-3b's fused gated gelu FFN (``qmm_ffn``: act(x @ w_in) *
    (x @ w_gate) with the tanh-form gelu in ``qmm_tc``'s epilogue), K
    2048, N 16384, binary16alt, at its decode step's 2 rows and its whole
    prompt's 320 (256 prefix + 64 tokens): kernel, plain version, and
    ``gelu(x @ w_in, approximate="tanh") * (x @ w_gate)`` on the widened
    weights (three torch calls; no one call computes it), beside the
    bound."""
    from repro_torch import configs
    from repro_torch.core.formats import BINARY16ALT as fmt
    from repro_torch.kernels import qmatmul as Q

    cfg = configs.get("paligemma-3b")
    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 14)
    K, N = cfg.d_model, cfg.d_ff
    wp = _pack_weight(torch.randn((K, N), generator=gen, device="cuda"),
                      fmt)
    gp = _pack_weight(torch.randn((K, N), generator=gen, device="cuda"),
                      fmt)
    wf, gf = _unpack_weight(wp, fmt), _unpack_weight(gp, fmt)
    gelu = torch.nn.functional.gelu
    for M in (ARCH_SLOTS, cfg.prefix_len + ARCH_PROMPT):
        x = torch.randn((M, K), generator=gen, device="cuda")
        t_k = timer(lambda: Q.qmm_ffn(x, wp, gp, fmt, act="gelu"))
        t_p = timer(lambda: Q.qmatmul_plain(x, wp, None, fmt,
                                            gate_payload=gp, act="gelu"),
                    iters=5)
        t_l = timer(lambda: gelu(x @ wf, approximate="tanh") * (x @ gf))
        nbytes = Q.qmm_hbm_bytes(M, K, N, fmt, gated=True)
        flops = 4 * M * K * N
        bound, by = qmm_bound(Q, fmt, nbytes, flops)
        report["timings"].append(dict(
            kernel="qmm_tc_gelu", M=M, K=K, N=N, fmt=fmt.name, ms=t_k,
            plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
            bytes=nbytes, flops=flops))
        print(f"[timing] qmm_tc gated gelu FFN (paligemma) M={M:<3} K={K} "
              f"N={N} binary16alt: kernel {t_k:.4f} ms  plain {t_p:.4f} ms"
              f"  gelu(x@w_in)*(x@w_gate) {t_l:.4f} ms  bound {bound:.5f} "
              f"ms ({by})")
        del x
    del wp, gp, wf, gf
    torch.cuda.empty_cache()


MOE_ARCHS = ("qwen3-moe-30b-a3b", "granite-moe-1b-a400m")


def grouped_shapes():
    """``(arch, weight, E, K, N)`` of each MoE config's expert products:
    w_in / w_gate (d_model -> d_ff) and w_out (d_ff -> d_model)."""
    from repro_torch import configs
    out = []
    for arch in MOE_ARCHS:
        cfg = configs.get(arch)
        E, d, ff = cfg.moe_experts, cfg.d_model, cfg.d_ff
        out += [(arch, "w_in/w_gate", E, d, ff), (arch, "w_out", E, ff, d)]
    return out


def router_rows(torch, arch, T, seed):
    """Kept rows an expert for ``T`` tokens through ``arch``'s full-width
    router (random f32 weights and tokens from ``seed``): ``moe_route``'s
    ``rows``, at its capacity."""
    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.models import moe

    cfg = configs.get(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = {"router": torch.randn((cfg.d_model, cfg.moe_experts),
                               generator=gen, device="cuda")
         / cfg.d_model ** 0.5}
    xt = torch.randn((T, cfg.d_model), generator=gen, device="cuda")
    return moe.moe_route(p, xt, cfg, get_policy("binary32")).rows


def _dispatched(torch, gen, E, C, K, rows, fill):
    """(E, C, K) activations as the dispatch packs them: rows below the
    count seeded, the rest ``fill``."""
    a = torch.randn((E, C, K), generator=gen, device="cuda")
    dead = torch.arange(C, device="cuda")[None, :] >= rows[:, None].long()
    return a.masked_fill(dead[..., None], fill), dead


def check_qmm_grouped(torch, report):
    """The MoE expert product (``qmm_grouped`` and its gated form
    ``qmm_grouped_ffn``, one ``qmm_tc_grouped_launch`` each) at
    qwen3-moe's (E 128, 2048 -> 768 and 768 -> 2048) and granite-moe's
    (E 32, 1024 <-> 512) expert shapes, C 8 and 20, binary16alt and
    binary8 weights, with the counts of a real router at 2 and 4 tokens
    (top-8), all experts empty, one expert full and dropped counts (up to
    3 C, clamped to C).  Held in each case: every row of ``qmm_grouped``
    bit for bit the per-expert ``qmm_tc`` loop (``qmm_grouped_loop``) on
    the dispatch's zero-padded input, and every row of the gated call
    (silu, a second weight as the gate) bit for bit the per-expert
    ``qmm_ffn`` loop (``qmm_grouped_ffn_loop``), while both grouped calls
    get NaN in the dead rows (they must never read them); kept rows within
    1e-6 x |x| @ |w| + 1 of the plain version, and the gated call's
    within 1e-6 x (|x| @ |w_in| + 1)(|x| @ |w_gate| + 1) (``check_qmm``'s
    gated tolerance); dead rows +0."""
    from repro_torch.core.formats import BINARY8, BINARY16ALT
    from repro_torch.kernels import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 21)
    ok, worst, gworst, res = True, 0.0, 0.0, []
    for arch, weight, E, K, N in grouped_shapes():
        for fmt in (BINARY16ALT, BINARY8):
            wp = _pack_weight(torch.randn((E, K, N), generator=gen,
                                          device="cuda"), fmt)
            gp = _pack_weight(torch.randn((E, K, N), generator=gen,
                                          device="cuda"), fmt)
            wabs = _unpack_weight(wp, fmt).abs()
            gabs = _unpack_weight(gp, fmt).abs()
            for C in (8, 20):
                one = torch.zeros(E, dtype=torch.int32, device="cuda")
                one[E // 3] = C
                counts = {
                    "router 2 tokens": router_rows(torch, arch, 2, 5),
                    "router 4 tokens": router_rows(torch, arch, 4, 6),
                    "all empty": torch.zeros_like(one),
                    "one full": one,
                    "dropped": torch.clamp(torch.randint(
                        0, 3 * C + 1, (E,), generator=gen, device="cuda"),
                        max=C).to(torch.int32)}
                for what, rows in counts.items():
                    a, dead = _dispatched(torch, gen, E, C, K, rows, 0.0)
                    noisy = a.masked_fill(dead[..., None], float("nan"))
                    got = Q.qmm_grouped(noisy, wp, fmt, rows)
                    loop = Q.qmm_grouped_loop(a, wp, fmt)
                    want = Q.qmm_grouped_plain(a, wp, fmt, rows)
                    gated = Q.qmm_grouped_ffn(noisy, wp, gp, fmt, rows,
                                              act="silu")
                    gloop = Q.qmm_grouped_ffn_loop(a, wp, gp, fmt,
                                                   act="silu")
                    gwant = Q.qmm_grouped_ffn_plain(a, wp, gp, fmt, rows,
                                                    act="silu")
                    torch.cuda.synchronize()
                    same = torch.equal(got.view(torch.int32),
                                       loop.view(torch.int32))
                    gsame = torch.equal(gated.view(torch.int32),
                                        gloop.view(torch.int32))
                    unit = torch.bmm(a.abs(), wabs) + 1.0
                    err = torch.where(dead[..., None], 0.0,
                                      (got - want).abs())
                    norm = float((err / unit).max())
                    gerr = torch.where(dead[..., None], 0.0,
                                       (gated - gwant).abs())
                    gunit = unit * (torch.bmm(a.abs(), gabs) + 1.0)
                    gnorm = float((gerr / gunit).max())
                    gerr = float(gerr.max())
                    gworst = max(gworst, gerr)
                    zero = bool((got.view(torch.int32)[dead] == 0).all()) \
                        and bool((gated.view(torch.int32)[dead] == 0).all())
                    good = same and gsame and zero and norm <= 1e-6 \
                        and gnorm <= 1e-6
                    ok &= good
                    worst = max(worst, float(err.max()))
                    live = int((rows > 0).sum())
                    res.append(dict(kernel="qmm_tc_grouped", arch=arch,
                                    weight=weight, E=E, C=C, K=K, N=N,
                                    fmt=fmt.name, counts=what,
                                    live_experts=live,
                                    kept_rows=int(rows.sum()),
                                    bits_equal_loop=same,
                                    gated_bits_equal_loop=gsame,
                                    dead_rows_zero=zero,
                                    max_abs_err=float(err.max()),
                                    max_err_in_acc_units=norm,
                                    gated_max_abs_err=gerr,
                                    gated_max_err_in_acc_units=gnorm,
                                    ok=good))
                    print(f"[kernels] qmm_grouped {arch[:6]} {weight:<11} "
                          f"E={E} C={C:<2} K={K:<4} N={N:<4} "
                          f"{fmt.name:<11} {what:<15} live {live:>3}: "
                          f"= loop bit for bit {same}, gated = qmm_ffn "
                          f"loop {gsame}, dead rows +0 {zero}, "
                          f"{norm:.2e} x |x|@|w|, gated {gnorm:.2e} "
                          f"(tol 1e-6) {'ok' if good else 'FAIL'}")
                    del a, dead, noisy, got, loop, want, unit, err, gated, \
                        gloop, gwant, gunit
            del wp, gp, wabs, gabs
            torch.cuda.empty_cache()
    report["cases"].extend(res)
    report["qmm_grouped_max_abs_err"] = worst
    report["qmm_grouped_ffn_max_abs_err"] = gworst
    print(f"[kernels] qmm_grouped: {len(res)} cases, "
          f"{sum(r['bits_equal_loop'] for r in res)} bit for bit the "
          f"per-expert loop, gated {sum(r['gated_bits_equal_loop'] for r in res)}"
          f" bit for bit the per-expert qmm_ffn loop, gated against the "
          f"plain version worst "
          f"{max(r['gated_max_err_in_acc_units'] for r in res):.2e} (tol "
          f"1e-6) {'ok' if ok else 'FAIL'}")
    return ok


def time_qmm_grouped(torch, report, timer):
    """The MoE layer's two grouped calls at qwen3-moe's expert shapes
    (binary16alt) with the counts of its full-width router at 2 and 4
    tokens: the gated pair (``qmm_grouped_ffn``, silu, at 2048 -> 768)
    and w_out (``qmm_grouped``, 768 -> 2048).  Each: the kernel (CUDA
    events, L2 flushed), the plain version, the host microseconds a call
    and the bound of the live experts' bytes (``qmm_grouped_hbm_bytes``);
    w_out beside ``torch.bmm`` on the widened (E, K, N) f32 weights
    (every expert, every row: timed only, never called by the port).  No
    one PyTorch call computes the gated pair; beside it: ``torch.bmm`` on
    the two weights side by side (the products alone), the same shape's
    ungated ``qmm_grouped`` (w_in's call before the pair was fused) and
    the composition the fused call replaced (two ungated grouped calls,
    silu, the product, the bf16 cast)."""
    from repro_torch.core.formats import BINARY16ALT
    from repro_torch.kernels import qmatmul as Q

    fmt = BINARY16ALT
    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 22)
    for arch, weight, E, K, N in grouped_shapes():
        if arch != "qwen3-moe-30b-a3b":
            continue
        gated = weight == "w_in/w_gate"
        wp = _pack_weight(torch.randn((E, K, N), generator=gen,
                                      device="cuda"), fmt)
        gp = _pack_weight(torch.randn((E, K, N), generator=gen,
                                      device="cuda"), fmt) if gated else None
        wf = _unpack_weight(wp, fmt)
        if gated:
            wf = torch.cat([wf, _unpack_weight(gp, fmt)], dim=2)
        for T in (2, 4):
            rows = router_rows(torch, arch, T, 7 + T)
            C = 8
            a, _ = _dispatched(torch, gen, E, C, K, rows, 0.0)
            extra = {}
            if gated:
                def call():
                    return Q.qmm_grouped_ffn(a, wp, gp, fmt, rows,
                                             act="silu")

                def plain():
                    return Q.qmm_grouped_ffn_plain(a, wp, gp, fmt, rows,
                                                   act="silu")

                def unfused():
                    h = Q.qmm_grouped(a, wp, fmt, rows)
                    return (Q.apply_act(h, "silu")
                            * Q.qmm_grouped(a, gp, fmt, rows)).to(
                                torch.bfloat16)
                extra = dict(
                    ungated_ms=timer(lambda: Q.qmm_grouped(a, wp, fmt, rows)),
                    unfused_ms=timer(unfused))
            else:
                def call():
                    return Q.qmm_grouped(a, wp, fmt, rows)

                def plain():
                    return Q.qmm_grouped_plain(a, wp, fmt, rows)
            t_k = timer(call)
            t_p = timer(plain, iters=5)
            t_b = timer(lambda: torch.bmm(a, wf))
            host = timer.host_us(call)
            rl = rows.tolist()
            nbytes = Q.qmm_grouped_hbm_bytes(rl, K, N, fmt, C, gated=gated)
            flops = (2 if gated else 1) * 2 * sum(rl) * K * N
            bound, by = qmm_bound(Q, fmt, nbytes, flops)
            live = sum(r > 0 for r in rl)
            name = "qmm_tc_grouped_ffn" if gated else "qmm_tc_grouped"
            report["timings"].append(dict(
                kernel=name, arch=arch, shape=weight, tokens=T,
                E=E, C=C, K=K, N=N, fmt=fmt.name, live_experts=live,
                kept_rows=sum(rl), ms=t_k, plain_ms=t_p,
                library_ms=None if gated else t_b,
                bmm_ms=t_b, bound_ms=bound, bound_by=by, bytes=nbytes,
                host_us=host, **extra))
            more = "".join(f"  {k[:-3]} {v:.4f} ms" for k, v in extra.items())
            print(f"[timing] {name} qwen3 {weight:<11} {T} tokens "
                  f"({live} of {E} experts live, {sum(rl)} rows) E={E} "
                  f"C={C} K={K} N={N} {fmt.name}: kernel {t_k:.4f} ms  "
                  f"plain {t_p:.4f} ms  torch.bmm{' (both weights)' if gated else ''} "
                  f"{t_b:.4f} ms{more}  bound {bound:.5f} ms ({by})  host "
                  f"{host:.1f} us")
            del a
        del wp, gp, wf
        torch.cuda.empty_cache()


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


# paligemma-3b's decode (MQA: one KV head of 256, 8 query heads) over
# its 256 prefix rows and a 64-token prompt: lengths 320-336, ragged
# across the 64-position pieces, in a 384-row slot
MQA_SHAPE = dict(H=1, G=8, dh=256)
MQA_S, MQA_LENGTHS = 384, (320, 323, 329, 336)

# recurrentgemma-2b's local attention layers: one KV head of 256, 10
# query heads (G 10 runs the group-tile-16 instantiations), a 128-row slot
# (its 100-token prompt + 8 new, at most the 2048 window) at ragged
# lengths around a serve's 101-108
RG_SHAPE = dict(H=1, G=10, dh=256)
RG_S, RG_LENGTHS = 128, (100, 103, 107, 110)
# its prefill chunks: 64 rows at q_offset 0, then 36 at 64, over the
# slot's 128 gathered rows, window 2048
RG_CHUNK = dict(B=1, Sq=64, Skv=RG_S, **RG_SHAPE)

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
       for page, lens in ((16, (0, 17, 200, 511)), (64, (0, 64, 129, 600)))]
    + [(f, dict(MQA_SHAPE, page=64, pps=MQA_S // 64), MQA_LENGTHS)
       for f in ("binary8", None)]
    + [(f, dict(RG_SHAPE, page=64, pps=RG_S // 64), RG_LENGTHS)
       for f in ("binary8", None)])


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
    capacity, but paligemma-3b's MQA shape (H 1, G 8, dh 256, page 64,
    lengths 320-336 in e5m2 and f32), which has the hole only, and
    recurrentgemma-2b's (H 1, G 10, dh 256, page 64, lengths 100-110 in
    a 128-row slot, e5m2 and f32), which has neither.  Then a
    row's bits do not depend on B or on the table's
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
        for key, shape in (("paged_mqa_max_abs_err", MQA_SHAPE),
                           ("paged_rg_max_abs_err", RG_SHAPE)):
            if all(kw[k] == v for k, v in shape.items()):
                report[key] = max(report.get(key, 0.0), err)
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


# paligemma-3b's whole-prompt prefill: 256 prefix + 64 tokens, MQA
PREFIX_SERVE = dict(B=1, Sq=320, Skv=320, H=1, G=8, dh=256)


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
    16 bytes) and head_dim 40, 72 and 200 (padded widths); and
    paligemma-3b's whole prompt (``PREFIX_SERVE``: H 1, G 8, dh 256, Sq =
    Skv = 320, prefix 256) in e5m2 and f32; recurrentgemma-2b's chunks
    (``RG_CHUNK``: H 1, G 10, dh 256 over the slot's 128 rows, window
    2048): 64 rows at q_offset 0 and 36 at 64 in e5m2 and f32, and the
    36 under a window of 48, which cuts keys."""
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
    # paligemma-3b's whole prompt: MQA (H 1, G 8, dh 256), 256
    # bidirectional prefix rows before 64 causal ones
    cases += [(fmt, 0, None, 256, PREFIX_SERVE) for fmt in (BINARY8, None)]
    # recurrentgemma-2b's chunks of its 100-token prompt
    cases += [(fmt, q_off, 2048, 0, dict(RG_CHUNK, Sq=sq))
              for fmt in (BINARY8, None) for q_off, sq in ((0, 64), (64, 36))]
    cases += [(BINARY8, 64, 48, 0, dict(RG_CHUNK, Sq=36))]
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
              f"Sq={shp['Sq']:<3} H={shp.get('H', 8)} G={shp['G']:<2} "
              f"dh={shp['dh']:<3} Skv={shp.get('Skv', 256)} "
              f"q_offset={q_off:<3} window={window} prefix={prefix} "
              f"max|err|={err:.3e} (tol 1e-6) {'ok' if good else 'FAIL'}")
        if fmt == BINARY8:
            worst = max(worst, err)
        if shp is PREFIX_SERVE:
            report["prefill_prefix_max_abs_err"] = max(
                report.get("prefill_prefix_max_abs_err", 0.0), err)
        if shp.get("Skv") == RG_S and shp.get("G") == RG_SHAPE["G"]:
            report["prefill_rg_max_abs_err"] = max(
                report.get("prefill_rg_max_abs_err", 0.0), err)
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


def _decode_inputs(torch, np, fmt, seed, S, lengths, G=4, dh=128, H=8):
    """The serve shape's gathered cache: B = 4 sequences, H = 8 KV heads,
    G = 4, dh = 128, K/V (4, S, 8, 128) packed or f32 (or another G, dh
    and H)."""
    from repro_torch.core.qtensor import encode
    rng = np.random.default_rng(seed)
    B = len(lengths)
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
    measured; so at paligemma-3b's MQA shape (H 1, G 8, dh 256, lengths
    320-336 ragged in a gathered 384) and recurrentgemma-2b's (H 1, G 10,
    dh 256, lengths 100-110 in a gathered 128) in e5m2 and f32.
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
    # paligemma-3b's decode: MQA over the prefix and the prompt
    cases += [(fmt, MQA_S, list(MQA_LENGTHS), MQA_SHAPE)
              for fmt in (BINARY8, None)]
    # recurrentgemma-2b's local attention: G 10 over a 128-row slot
    cases += [(fmt, RG_S, list(RG_LENGTHS), RG_SHAPE)
              for fmt in (BINARY8, None)]
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
        print(f"[kernels] flash_decode {name:<11} B=4 H={shp.get('H', 8)} "
              f"G={shp['G']:<2} "
              f"dh={shp['dh']:<3} S={S} "
              f"lengths={lengths} max|err|={err:.3e} "
              f"({'tol 1e-6' if shp == serve else 'measured'}; against "
              f"the split twin {terr:.1e}, tol 1e-6) residuals {rerr:.1e} "
              f"(tol 1e-5) {'ok' if good else 'FAIL'}")
        worst = max(worst, terr)
        if shp is MQA_SHAPE:
            report["flash_decode_mqa_max_abs_err"] = max(
                report.get("flash_decode_mqa_max_abs_err", 0.0), terr)
        if shp is RG_SHAPE:
            report["flash_decode_rg_max_abs_err"] = max(
                report.get("flash_decode_rg_max_abs_err", 0.0), terr)
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


def time_prefix_attention(torch, np, report, timer):
    """The attention kernels at paligemma-3b's served shapes (MQA: H 1,
    G 8, dh 256, e5m2): flash_prefill over its whole prompt (256
    bidirectional prefix rows + 64 causal, ``PREFIX_SERVE``) beside SDPA
    with the same prefix | causal mask; flash_decode of its 2 slots
    holding 324 rows (the middle of a serve's 321-327) in a gathered
    384-row cache beside SDPA; paged_decode of the same rows in pages of
    64 (no library call takes block tables)."""
    _time_served_attention(
        torch, np, report, timer, label="paligemma", shape=MQA_SHAPE,
        prefill=PREFIX_SERVE, q_offset=0, window=None, prefix=256,
        S=MQA_S, n=324, seeds=(5, 6),
        names=("flash_prefill_prefix", "flash_decode_mqa",
               "paged_decode_mqa"))


def time_recurrentgemma_attention(torch, np, report, timer):
    """The attention kernels at recurrentgemma-2b's served shapes (H 1,
    G 10, dh 256, e5m2, window 2048): flash_prefill over its first
    64-row chunk (q_offset 0 over the slot's 128 gathered rows) beside
    SDPA with the same causal mask; flash_decode of its 2 slots holding
    104 rows (the middle of a serve's 101-108) in a gathered 128-row
    cache beside SDPA; paged_decode of the same rows in pages of 64."""
    _time_served_attention(
        torch, np, report, timer, label="recurrentgemma", shape=RG_SHAPE,
        prefill=RG_CHUNK, q_offset=0, window=2048, prefix=0, S=RG_S, n=104,
        seeds=(14, 15),
        names=("flash_prefill_rg", "flash_decode_rg", "paged_decode_rg"))


def _time_served_attention(torch, np, report, timer, *, label, shape,
                           prefill, q_offset, window, prefix, S, n, seeds,
                           names, B=None, prefill_f32=False):
    """flash_prefill at ``prefill`` (e5m2; f32 K/V with ``prefill_f32``,
    as a whole-prompt prefill attends) beside SDPA with the same mask;
    flash_decode of ``B`` slots (default ``ARCH_SLOTS``) holding ``n``
    rows in a gathered
    ``S``-row cache beside SDPA; paged_decode of the same rows in pages
    of 64 (the decode kernels only when ``names`` names them).  SDPA runs
    on the dequantized K/V repeated to the query heads (timed only, never
    called by the port)."""
    from repro_torch.core.formats import BINARY8
    from repro_torch.core.qtensor import decode
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, G, dh = shape["H"], shape["G"], shape["dh"]
    Sq, Skv = prefill["Sq"], prefill["Skv"]
    pf = None if prefill_f32 else BINARY8
    q, kp, vp = _prefill_inputs(torch, np, pf, report["seed"] + seeds[0],
                                **prefill)
    kd, vd = (kp, vp) if pf is None else (decode(kp, pf), decode(vp, pf))
    qs = q.reshape(1, Sq, H * G, dh).transpose(1, 2)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = FA.prefill_mask(Sq, Skv, q_offset, window, prefix, "cuda")
    kw = dict(window=window, prefix_len=prefix, q_offset=q_offset)
    t_k = timer(lambda: FA.flash_prefill(q, kp, vp, pf, **kw))
    t_p = timer(lambda: FA.flash_prefill_plain(q, kp, vp, pf, **kw),
                iters=10)
    t_l = timer(lambda: sdpa(qs, ks, vs, attn_mask=mask))
    live = int(mask.sum())                    # keys each query needs
    flops = 4 * dh * H * G * live
    nbytes = FA.prefill_hbm_bytes(1, Sq, Skv, H, G, dh, pf)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    report["timings"].append(dict(
        kernel=names[0], fmt="f32" if pf is None else pf.name,
        prefix_len=prefix, window=window,
        q_offset=q_offset, **prefill, ms=t_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bytes=nbytes, flops=flops))
    print(f"[timing] flash_prefill {label} Sq={Sq} Skv={Skv} H={H} G={G} "
          f"dh={dh} {'f32' if pf is None else pf.name} q_offset={q_offset} "
          f"window={window} prefix={prefix}: "
          f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  SDPA {t_l:.4f} ms  "
          f"bound {max(b_bytes, b_ops):.5f} ms")
    if len(names) == 1:
        return
    B = ARCH_SLOTS if B is None else B

    q, kp, vp, lens = _decode_inputs(torch, np, BINARY8, report["seed"]
                                     + seeds[1], S, [n] * B, **shape)
    kd, vd = decode(kp, BINARY8), decode(vp, BINARY8)
    qs = q.reshape(B, H * G, 1, dh)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[
        :, None, None, :]
    flops = 4 * dh * H * G * n * B
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    page = 64
    # the same rows as B slots of S // page pages each (a permuted table)
    kpg = kp.reshape(B * S // page, page, H, dh)
    vpg = vp.reshape(B * S // page, page, H, dh)
    perm = torch.randperm(B * S // page, generator=torch.Generator()
                          .manual_seed(report["seed"]))
    inv = torch.argsort(perm)
    kpg, vpg = kpg[perm].contiguous(), vpg[perm].contiguous()
    tables = inv.reshape(B, S // page).to(torch.int32).cuda()
    for name, fn, plain, lib, nbytes in (
            (names[1],
             lambda: FA.flash_decode(q, kp, vp, BINARY8, lens),
             lambda: FA.flash_decode_plain(q, kp, vp, BINARY8, lens),
             lambda: sdpa(qs, ks, vs, attn_mask=mask),
             FA.decode_hbm_bytes([n] * B, S, H, dh, BINARY8, g=G)),
            (names[2],
             lambda: PA.paged_decode(q, kpg, vpg, BINARY8, lens, tables),
             lambda: PA.paged_decode_plain(q, kpg, vpg, BINARY8, lens,
                                           tables),
             None,
             PA.paged_hbm_bytes([n] * B, H, dh, BINARY8, page_size=page,
                                g=G))):
        t_k = timer(fn)
        t_p = timer(plain, iters=10)
        t_l = timer(lib) if lib is not None else None
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel=name, B=B, S=S, length=n, **shape, ms=t_k,
            plain_ms=t_p, library_ms=t_l, bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            bytes=nbytes, flops=flops))
        print(f"[timing] {name} {label} B={B} len={n} H={H} G={G} dh={dh}: "
              f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
              + (f"SDPA {t_l:.4f} ms  " if t_l is not None else "")
              + f"bound {max(b_bytes, b_ops):.6f} ms")
    del q, kp, vp, kpg, vpg
    torch.cuda.empty_cache()


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


GROUPED_KERNELS = ("qmm_tc_grouped", "qmm_tc_grouped_ffn")


def _grouped_launches(lib) -> int:
    """The MoE expert product's launches: w_out's and the gated pair's."""
    return sum(lib.by_kernel.get(k, 0) for k in GROUPED_KERNELS)


def _drive_serve(torch, libs, argv, hooks, params=None):
    """``serve.main(argv)`` with every launch count set to 0 just before
    and read just after, and the launches of each call of each hooked
    method ``hooks[name] = (class, attribute)`` recorded as a tuple in
    ``libs`` order; ``per[name + "/kern"]`` holds the same calls' qmm
    launches by kernel (qmm_gemv, qmm_tile, qmm_tc) and
    ``per[name + "/grouped"]`` their grouped launches (``qmm_tc_grouped``
    and ``qmm_tc_grouped_ffn``)."""
    from repro_torch.launch import serve

    per = {name: [] for name in hooks}
    per.update({name + "/kern": [] for name in hooks})
    per.update({name + "/tokens": [] for name in hooks})
    per.update({name + "/grouped": [] for name in hooks})
    saved = []
    for name, (cls, attr) in hooks.items():
        fn = getattr(cls, attr)
        saved.append((cls, attr, fn))

        def wrapped(self, *a, _fn=fn, _name=name, **k):
            before = [lib.launches for lib in libs]
            kern = _qmm_kernels(libs[0])
            grouped = _grouped_launches(libs[0])
            out = _fn(self, *a, **k)
            per[_name + "/grouped"].append(
                _grouped_launches(libs[0]) - grouped)
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


@contextlib.contextmanager
def _counting(module, names):
    """Count the calls of ``module``'s functions ``names`` made inside the
    block: yields ``{name: calls}``."""
    counts = dict.fromkeys(names, 0)
    real = {k: getattr(module, k) for k in names}

    def counted(name):
        def fn(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return fn
    for k in names:
        setattr(module, k, counted(k))
    try:
        yield counts
    finally:
        for k, fn in real.items():
            setattr(module, k, fn)


# the three-step norm route's standalone add and norm: none on a served path
NORM_APART = ("residual_add", "apply_norm")


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
    flash_decode, flexfloat_cast, norms): 65 norm launches (two a
    layer and the final norm) a step and a chunk, every one a fused
    ``add_rmsnorm`` (the residual add and the activation cast inside it:
    no standalone residual add and no three-step norm in the run); qmm
    by kernel (qmm_gemv, qmm_tile, qmm_tc)."""
    from repro_torch.engine import worker
    from repro_torch.models import layers

    f32 = policy == "binary32"
    requests, max_new = (F32_REQUESTS, F32_MAX_NEW) if f32 \
        else (SERVE_REQUESTS, SERVE_MAX_NEW)
    stats = f"{key}_stats.jsonl"
    argv = _serve_argv(args, decode_impl, requests, max_new, stats,
                       policy=policy)
    with _counting(layers, NORM_APART) as apart:
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
    calls = len(per["decode"]) + len(per["prefill"])
    want_norms = {"add_rmsnorm_launch": calls * NORMS}
    ok &= launches["norms_by_entry"] == want_norms
    ok &= not any(apart.values())
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
        norms_apart=apart,
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
          f"{sorted(set(per['prefill/kern']))} (want {want_pre_k}); "
          f"norms by entry {launches['norms_by_entry']} (want "
          f"{want_norms}), standalone residual adds and three-step norms "
          f"{apart} (want 0) {'ok' if ok else 'FAIL'}")
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
    KV): every request gets its tokens, a decode step and a chunk launch
    what the transprecision run launches, and every norm takes the
    three-step route (``rmsnorm_launch``: binary8 is no dtype of the
    fused kernel)."""
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
    # binary8 activations are no dtype of add_rmsnorm's kernel: every norm
    # takes the three steps (torch's add, the rmsnorm kernel, the cast)
    calls = len(per["decode"]) + len(per["prefill"])
    want_norms = {"rmsnorm_launch": calls * (2 * layers + 1)}
    good &= launches["norms_by_entry"] == want_norms
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
          f"{sorted(set(per['prefill']))} (want {want_pre}); norms by "
          f"entry {launches['norms_by_entry']} (want {want_norms}) "
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

def _profiled_serve(torch, argv, window=None, params=None, cpu=False):
    """``serve.main(argv, params=params)`` under torch.profiler: the
    whole of ``Engine.run``, or with ``window = n`` only n engine steps
    taken once every prompt is prefilled (a steady decode window).  It
    traces the device activity alone unless ``cpu`` (the CPU ops' rows of
    a long run take minutes to sum; a window of one step is cheap).
    Returns (device busy seconds from the CUDA rows, wall seconds, the
    top ten CUDA rows, decode steps or rounds in the profile, the
    key_averages rows)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import scheduler
    from repro_torch.launch import serve

    prof = profile(activities=[ProfilerActivity.CUDA]
                   + ([ProfilerActivity.CPU] if cpu else []))
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

    rows = prof.key_averages()           # costly on a long trace: once
    events = device_rows(rows)
    busy = sum(_dev_us(e) for e in events) / 1e6
    top = [dict(name=e.key[:80], count=e.count, device_ms=_dev_us(e) / 1e3)
           for e in sorted(events, key=_dev_us, reverse=True)[:10]]
    return busy, box["wall"], top, box["steps"], rows


def _dev_us(e):
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def device_rows(rows):
    """The device's own rows of a profile's ``key_averages()`` (kernels,
    memcpys, memsets): a CPU op's row also carries the device time of
    what it launched, so summing every row would count that time twice
    (torch's table footer sums the same rows)."""
    from torch.autograd import DeviceType
    return [e for e in rows
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def device_counts(rows, *names):
    """(device activities, then those whose name holds each of
    ``names``) in a profile."""
    ev = device_rows(rows)
    return (sum(e.count for e in ev),) + tuple(
        sum(e.count for e in ev if n in e.key) for n in names)


STEP_ARCHS = ("llama3-8b", "qwen3-moe-30b-a3b")


def run_steps(torch, report, args):
    """One steady decode step of full-width, full-depth llama3-8b and
    qwen3-moe under torch.profiler (the archs phase's serve:
    transprecision, ``qmm_pallas``, ``flash_pallas``, 2 requests x (64 +
    4) over 2 slots, page 64, random weights from ``--seed``, profiled
    once every prompt is prefilled): wall, device busy time, device
    activities and the norm and grouped expert kernels among them.  Uses
    only the serve CLI and the kernel names, so ``--phases build,steps
    --src OTHER/src`` profiles another checkout with the same code: run
    parent, change, change, parent, each in its own process."""
    report["steps"] = {}
    for arch in STEP_ARCHS:
        argv = ["--arch", arch, "--policy", "transprecision",
                "--decode-impl", "flash_pallas", "--matmul-impl",
                "qmm_pallas", "--page-size", "64", "--requests", "2",
                "--slots", "2", "--prompt-len", "64", "--max-new", "4",
                "--capacity", "128", "--seed", str(args.seed)]
        busy, wall, top, steps, rows = _profiled_serve(
            torch, argv, window=1)
        # "rmsnorm_kernel" also names add_rmsnorm_kernel
        acts, grouped, old, norms, rms = device_counts(
            rows, "qmm_tc_grouped", "qmm_grouped_", "add_rmsnorm",
            "rmsnorm_kernel")
        rms -= norms
        report["steps"][arch] = dict(
            wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
            device_activities=acts, grouped_kernels=grouped + old,
            add_rmsnorm_kernels=norms, rmsnorm_kernels=rms, top=top[:6])
        print(f"[steps] {arch}: decode step wall {wall * 1e3:.2f} ms, "
              f"device busy {busy * 1e3:.3f} ms "
              f"({100 * busy / wall:.1f} %), {acts} device activities, "
              f"grouped expert kernels {grouped + old}, add_rmsnorm {norms}"
              f", rmsnorm {rms}", flush=True)
        del rows
        torch.cuda.empty_cache()
    return True


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
    # and one steady decode step of the paged serve: the device
    # activities a step (kernels, copies, sets), the fused norms among
    # them.  Every run traces the device activity alone (the CPU ops'
    # rows took most of the phase's time to sum)
    runs = (("serve", ["--decode-impl", "paged", "--max-new", "8"], None),
            ("speculative", ["--decode-impl", "flash_pallas", "--max-new",
                             "16", "--speculate-k", str(SPEC_K),
                             "--pool-pages", str(SPEC_POOL_PAGES)], 3),
            ("decode_step", ["--decode-impl", "paged", "--max-new", "8"],
             1))
    report["profile"] = {}
    for name, extra, window in runs:
        busy, wall, top, steps, rows = _profiled_serve(
            torch, base + extra, window)
        acts, norms = device_counts(rows, "add_rmsnorm")
        report["profile"][name] = dict(
            wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
            decode_steps=steps, device_activities=acts,
            add_rmsnorm_kernels=norms, top=top)
        with open(os.path.join(args.out, f"profile_{name}.txt"), "w") as f:
            f.write(rows.table(row_limit=40))
        what = "the whole run" if window is None \
            else f"{window} steady steps"
        print(f"[profile] {name} 4 requests x (128 + {extra[3]}), "
              f"{what}: wall {wall:.3f} s, {steps} decode steps or rounds, "
              f"device busy {busy:.3f} s ({100 * busy / wall:.1f} %), "
              f"{acts} device activities ({norms} add_rmsnorm)")
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
    ok &= check_fused_norm_logits(torch, report, args, model, cfg)
    ok &= check_logits_archs(torch, report, args)
    ok &= check_grouped_logits(torch, report, args)
    ok &= check_prefix_logits(torch, report, args)
    ok &= check_recurrent_logits(torch, report, args)
    return ok


def _prefix_logits(torch, model, cfg, pol, dec, mm, seed, batch, route):
    """The prefill and first decode step logits of ``batch`` (tokens and
    prefix embeddings) under ``pol`` with decode ``dec`` and matmul
    ``mm``, along one of two routes: ``"engine"`` (``prefill`` at its
    default capacity, the prefix and prompt rows; ``write_prefill`` of
    them into a one-slot paged cache of ``arch_capacity`` rows; a paged
    ``decode_step``) or ``"contiguous"`` (``synchronous_generate``'s:
    ``prefill`` into a contiguous cache of ``arch_capacity`` rows, a
    contiguous ``decode_step``).  Returns ((prefill, decode) logits,
    every layer's length after prefill, flash_prefill launches)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_cache
    from repro_torch.models import qparams

    policy = get_policy(pol, decode_impl=dec, matmul_impl=mm)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, policy, device="cuda")
    if mm == "qmm_pallas":
        params = qparams.encode_params(params, policy)
    cap = arch_capacity(cfg)
    pps = cap // ARCH_PAGE
    before = FA.LIB.launches
    last = batch["tokens"][:, -1:]
    if route == "engine":
        lp, one = model.prefill(params, batch, policy, None)
        states = [paged_cache.write_prefill(paged_cache.set_block_tables(
            paged_cache.init_paged_cache(
                1, pps, ARCH_PAGE, pps, cfg.n_kv, cfg.head_dim,
                policy.dtype("kv_cache", layer=li), device="cuda"),
            [list(range(pps))]), 0, c.k[0], c.v[0])
            for li, c in enumerate(one)]
        lens = [int(s.seq_lens[0]) for s in states]
    else:
        lp, states = model.prefill(params, batch, policy, cap)
        lens = [int(s.pos) for s in states]
    launches = FA.LIB.launches - before
    ld, _ = model.decode_step(params, last, states, policy)
    out = (lp.float(), ld.float())
    del params, states
    torch.cuda.empty_cache()
    return out, lens, launches


def check_prefix_logits(torch, report, args):
    """paligemma-3b at 2 layers, full width, on random prefix embeddings
    (seeded numpy; the served stub prefix is zeros, which stay zero
    through every layer and so test the bidirectional mask only
    trivially) before a 64-token prompt:

    * kernel path (``paged``, ``qmm_pallas``) against plain path
      (``xla``, ``xla``) along the engine's route, under binary32 and
      transprecision, at ``LOGIT_TOL``: with the agreement on random
      prefix rows this holds ``flash_prefill``'s prefix mask (one launch
      a layer);
    * the engine's route (whole prefill, ``write_prefill``, paged decode)
      against the contiguous route (``synchronous_generate``'s) under one
      decode spelling (``paged``, ``flash_pallas``), both policies, bit
      for bit: both read 384 positions of one slot in pages of 64 (the
      contiguous cache as its paged view), so every kernel sums alike;
      every layer's length after prefill is prefix + prompt;
    * under binary32, the logits on the random prefix differ from those
      on the zero prefix by more than the kernel-path tolerance (and by
      far more than the kernel and plain paths differ): the prefix
      reaches the logits through every layer on the kernel route.  The
      margin is modest: the sqrt(d)-scaled token embedding dominates its
      own residual stream, so its tied logit (~d) dominates the row."""
    import numpy as np
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    _, full = build("paligemma-3b")
    cfg = dataclasses.replace(full, n_layers=2)
    model = Model(cfg)
    rng = np.random.default_rng(args.seed + 23)
    prefix = torch.tensor(rng.normal(size=(1, cfg.prefix_len, cfg.d_model)),
                          dtype=torch.float32, device="cuda")
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, ARCH_PROMPT)),
                        dtype=torch.int32, device="cuda")
    batch = {"tokens": toks, "prefix_embeds": prefix}
    rows = cfg.prefix_len + ARCH_PROMPT
    ok = True
    kernel = {}
    for pol, rel in LOGIT_TOL.items():
        res = {}
        for path, (dec, mm) in (("kernel", ("paged", "qmm_pallas")),
                                ("plain", ("xla", "xla"))):
            res[path] = _prefix_logits(torch, model, cfg, pol, dec, mm,
                                       args.seed, batch, "engine")
        kernel[pol] = res["kernel"]
        launches = res["kernel"][2]
        for i, what in enumerate(("whole prefill", "decode step")):
            a, b = res["kernel"][0][i], res["plain"][0][i]
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            good = err <= rel * max(scale, 1.0) and bool(
                torch.isfinite(a).all()) and launches == cfg.n_layers
            ok &= good
            report["logits"].append(dict(
                arch=cfg.arch, policy=pol, what=f"{what}, random prefix",
                max_abs_err=err, max_abs_logit=scale, tol_rel=rel,
                flash_prefill_launches=launches,
                argmax_equal=bool((a.argmax(-1) == b.argmax(-1)).all()),
                ok=good))
            print(f"[logits] {cfg.arch} {pol:<14} {what:<13} 2-layer full "
                  f"width, random 256-row prefix: max|kernel - plain| = "
                  f"{err:.3e} (max|logit| {scale:.3f}, tol {rel:.2e} x "
                  f"that), flash_prefill launches {launches} (want "
                  f"{cfg.n_layers}) {'ok' if good else 'FAIL'}")
    for pol in LOGIT_TOL:
        for dec in ("paged", "flash_pallas"):
            eng = kernel[pol] if dec == "paged" else _prefix_logits(
                torch, model, cfg, pol, dec, "qmm_pallas", args.seed, batch,
                "engine")
            con = _prefix_logits(torch, model, cfg, pol, dec, "qmm_pallas",
                                 args.seed, batch, "contiguous")
            same = [torch.equal(_bits(a), _bits(b))
                    for a, b in zip(eng[0], con[0])]
            err = float((eng[0][1] - con[0][1]).abs().max())
            lens_ok = eng[1] == [rows] * cfg.n_layers == con[1]
            good = all(same) and lens_ok
            ok &= good
            report["logits"].append(dict(
                arch=cfg.arch, policy=pol, decode_impl=dec,
                what="engine route vs contiguous route, random prefix",
                bits_equal=dict(zip(("whole prefill", "decode step"), same)),
                max_abs_err=err, lengths_after_prefill=eng[1], ok=good))
            print(f"[logits] {cfg.arch} {pol:<14} {dec:<12} 2-layer full "
                  f"width: the engine's route (whole prefill, write_prefill,"
                  f" paged decode) bit for bit the contiguous route's "
                  f"(prefill, decode step) {same} (max|diff| {err:.3e}); "
                  f"lengths after prefill {eng[1]} / {con[1]} (want {rows}:"
                  f" prefix + prompt) {'ok' if good else 'FAIL'}")
    zero = _prefix_logits(torch, model, cfg, "binary32", "paged",
                          "qmm_pallas", args.seed,
                          dict(batch, prefix_embeds=torch.zeros_like(prefix)),
                          "engine")
    rel = LOGIT_TOL["binary32"]
    for i, what in enumerate(("whole prefill", "decode step")):
        a, b = kernel["binary32"][0][i], zero[0][i]
        diff = float((a - b).abs().max())
        tol = rel * max(float(b.abs().max()), 1.0)
        good = diff > tol
        ok &= good
        report["logits"].append(dict(
            arch=cfg.arch, policy="binary32",
            what=f"{what}, random vs zero prefix", max_abs_diff=diff,
            must_exceed=tol, ok=good))
        print(f"[logits] {cfg.arch} binary32 {what:<13} kernel route: "
              f"max|random prefix - zero prefix| = {diff:.3e} (must exceed "
              f"the kernel-path tolerance {tol:.3e}) "
              f"{'ok' if good else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return ok


def check_fused_norm_logits(torch, report, args, model, cfg):
    """A 2-layer, full-width model's prefill chunk and decode step under
    binary32 and transprecision (``qmm_pallas``, paged and flash_pallas):
    logits on the fused norm route (``add_norm``: one ``add_rmsnorm`` or
    ``add_layernorm`` launch a norm) bit for bit those on the three-step
    route (torch's add, the norm kernel, the cast: the composition before
    the fused kernels), with the norm launches of each route counted
    (2 x 2 + 1 a call, on ``add_rmsnorm_launch`` or ``rmsnorm_launch``
    for llama3-8b, ``add_layernorm_launch`` or ``layernorm_launch`` for
    command-r-35b)."""
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models import layers, transformer

    def three_steps(x, y, p, policy, kind):
        s = x if y is None else layers.residual_add(x, y)
        return s, layers.apply_norm(s, p, policy, kind)

    real = transformer.add_norm
    per_call = 2 * cfg.n_layers + 1
    want = {"fused": {f"add_{cfg.norm}_launch": 2 * per_call},
            "three steps": {f"{cfg.norm}_launch": 2 * per_call}}
    ok = True
    for pol in ("binary32", "transprecision"):
        for dec in ("paged", "flash_pallas"):
            res, counts = {}, {}
            for route in ("fused", "three steps"):
                before = dict(rms.LIB.by_symbol)
                if route == "three steps":
                    transformer.add_norm = three_steps
                try:
                    res[route] = _first_step_logits(
                        torch, model, cfg, pol, dec, "qmm_pallas", args.seed,
                        prompt=64, page=64)
                finally:
                    transformer.add_norm = real
                counts[route] = {k: v - before.get(k, 0)
                                 for k, v in rms.LIB.by_symbol.items()
                                 if v != before.get(k, 0)}
            same = [torch.equal(_bits(a), _bits(b))
                    for a, b in zip(res["fused"], res["three steps"])]
            good = all(same) and counts == want
            ok &= good
            report["logits"].append(dict(
                arch=cfg.arch, policy=pol, decode_impl=dec,
                what="fused norm route vs three steps",
                bits_equal=dict(zip(("prefill chunk", "decode step"), same)),
                norm_launches=counts, ok=good))
            print(f"[logits] {cfg.arch} {pol:<14} {dec:<12} 2-layer full "
                  f"width: logits on the fused norm route bit for bit the "
                  f"three-step route's (prefill chunk, decode step) {same}; "
                  f"norm launches {counts} {'ok' if good else 'FAIL'}")
    return ok


def check_grouped_logits(torch, report, args):
    """The MoE configs at 2 layers, full width, transprecision, paged:
    a prefill chunk's and a decode step's logits with every expert
    product on the grouped calls (the serving route: the gated pair in
    one ``qmm_grouped_ffn``, w_out in one ``qmm_grouped``) bit for bit
    those with the per-expert loops (``qmm_grouped_ffn_loop``: one
    ``qmm_ffn`` an expert; ``qmm_grouped_loop``: one ``qmm_tc`` an
    expert; the reference's unrolled scheme), with the launches of each
    route counted."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.models import layers
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    impl = dispatch.resolve_matmul("qmm_pallas")
    real, real_ffn = impl.grouped, layers.qmm_grouped_ffn

    def loop(a, w, policy, role, rows=None):
        return Q.qmm_grouped_loop(a.to(torch.float32), w.payload, w.fmt)

    def ffn_loop(a, w_in, w_gate, fmt, rows, **kw):
        return Q.qmm_grouped_ffn_loop(a, w_in, w_gate, fmt, **kw)

    ok = True
    for arch in MOE_ARCHS:
        _, full = build(arch)
        cfg = dataclasses.replace(full, n_layers=2)
        model = Model(cfg)
        res, counts = {}, {}
        for route in ("grouped", "loop"):
            before = dict(Q.LIB.by_kernel)
            if route == "loop":
                impl.grouped = staticmethod(loop)
                layers.qmm_grouped_ffn = ffn_loop
            try:
                res[route] = _first_step_logits(
                    torch, model, cfg, "transprecision", "paged",
                    "qmm_pallas", args.seed, prompt=64, page=64)
            finally:
                impl.grouped = staticmethod(real)
                layers.qmm_grouped_ffn = real_ffn
            counts[route] = {k: v - before.get(k, 0)
                             for k, v in Q.LIB.by_kernel.items()
                             if v != before.get(k, 0)}
        same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(res["grouped"], res["loop"])]
        # two calls (chunk, step) x 2 layers x (the gated pair, w_out);
        # the loops E qmm_tc launches each
        good = all(same) \
            and counts["grouped"].get("qmm_tc_grouped") == 4 \
            and counts["grouped"].get("qmm_tc_grouped_ffn") == 4 \
            and not any(k in counts["loop"] for k in GROUPED_KERNELS) \
            and counts["loop"].get("qmm_tc", 0) \
            - counts["grouped"].get("qmm_tc", 0) == 8 * cfg.moe_experts
        ok &= good
        report["logits"].append(dict(
            arch=arch, policy="transprecision",
            what="grouped route vs per-expert loop",
            bits_equal=dict(zip(("prefill chunk", "decode step"), same)),
            launches=counts, ok=good))
        print(f"[logits] {arch} transprecision 2-layer full width: the "
              f"grouped route's logits bit for bit the per-expert loop's "
              f"(prefill chunk, decode step) {same}; qmm launches grouped "
              f"{counts['grouped']}, loop {counts['loop']} "
              f"{'ok' if good else 'FAIL'}")
        del model
        torch.cuda.empty_cache()
    return ok


def check_logits_archs(torch, report, args):
    """The ninth slice's two new layer kinds at 2 layers, full width:
    command-r-35b (layernorm, the tied head on ``torch.matmul`` in
    8-row blocks) under binary32 and transprecision, kernel path against
    plain path, then verify against sequential decode bit for bit
    (:func:`check_verify_logits`) under both, with paged and
    flash_pallas, and its fused ``add_layernorm`` route against the three
    steps (:func:`check_fused_norm_logits`); qwen3-moe-30b-a3b (MoE) under transprecision, kernel
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
        if cfg.norm == "layernorm":
            ok &= check_fused_norm_logits(torch, report, args, model, cfg)
        del model
        torch.cuda.empty_cache()
    return ok


# the chunked route's distance from the whole prompt under binary32, in
# units of max|logit|: the reference's own tolerance for its chunked
# against its recurrent forms (tests/test_recurrent.py: 2e-4, 3e-4)
CHUNKED_TOL = 2e-4


def _recurrent_logits(torch, model, cfg, params, policy, toks, route):
    """The prefill and first decode step logits of ``toks`` (1, 100)
    along ``route``: ``"chunked"`` (the engine's: ``prefill_chunk`` of 64
    then 36 tokens with ``pstates`` into one slot of 2 pages of 64,
    then ``decode_step`` over the pages and the carried states) or
    ``"whole"`` (the synchronous loop's: ``prefill`` of the 100 at
    capacity 128, then ``decode_step``)."""
    from repro_torch.kernels import paged_cache

    if route == "whole":
        lp, states = model.prefill(params, {"tokens": toks}, policy,
                                   RG_S)
    else:
        states = [paged_cache.set_block_tables(
            paged_cache.init_paged_cache(
                1, 2, ARCH_PAGE, 2, cfg.n_kv, cfg.head_dim,
                policy.dtype("kv_cache"), device="cuda"), [[0, 1]])
            if k == "attn" else None for k in cfg.attn_pattern]
        ps = model.recurrent_state(1, policy, "cuda")
        at = 0
        for n in arch_chunks(cfg):
            lp, states, ps = model.prefill_chunk(
                params, toks[:, at:at + n], states, ps, policy, slot=0,
                q_offset=at)
            at += n
        states = [p if k != "attn" else st for k, p, st in
                  zip(cfg.attn_pattern, ps, states)]
    ld, _ = model.decode_step(params, toks[:, -1:], states, policy)
    return lp.float(), ld.float()


def check_recurrent_logits(torch, report, args):
    """rwkv6-1.6b at 2 layers and recurrentgemma-2b at 3 (one attention
    layer), full width, seeded weights and a 100-token prompt: the
    chunked route's (64 + 36 with ``pstates``, then a decode step)
    kernel path (``qmm_pallas`` with ``paged``; recurrentgemma also
    ``flash_pallas``) against the plain path (xla, xla) under binary32
    and transprecision at ``LOGIT_TOL``; and under binary32 the chunked
    route against the whole prompt (``prefill`` + ``decode_step``) on
    the kernel path within ``CHUNKED_TOL`` x max|logit|.  Under
    transprecision the recurrent states are rounded to e5m2 at every
    chunk end, so the two routes are different computations (in the
    reference too), and are not compared."""
    from repro_torch.models.registry import build

    ok = True
    for arch, layers in (("rwkv6-1.6b", 2), ("recurrentgemma-2b", 3)):
        _, full = build(arch)
        ok &= recurrent_logit_checks(
            torch, report, args, arch,
            dataclasses.replace(full, n_layers=layers))
    return ok


def recurrent_logit_checks(torch, report, args, label, cfg):
    """:func:`check_recurrent_logits`' checks of one config ``cfg``
    (full width, cut in depth), reported under ``label``."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models import qparams
    from repro_torch.models.transformer import Model

    ok = True
    layers = cfg.n_layers
    model = Model(cfg)
    g = torch.Generator().manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab, (1, RECURRENT_PROMPT),
                         generator=g).to(torch.int32).cuda()
    kernels = [("paged", "qmm_pallas")] + (
        [("flash_pallas", "qmm_pallas")]
        if "attn" in cfg.attn_pattern else [])
    for pol in LOGIT_TOL:
        res = {}
        for dec, mm in kernels + [("xla", "xla")]:
            policy = get_policy(pol, decode_impl=dec, matmul_impl=mm)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            params = model.init_params(gen, policy, device="cuda")
            if mm == "qmm_pallas":
                params = qparams.encode_params(params, policy)
            res[dec] = _recurrent_logits(torch, model, cfg, params,
                                         policy, toks, "chunked")
            if pol == "binary32" and dec == "paged":
                res["whole"] = _recurrent_logits(
                    torch, model, cfg, params, policy, toks, "whole")
            del params
            torch.cuda.empty_cache()
        pairs = [(dec, "xla", LOGIT_TOL[pol]) for dec, _ in kernels]
        if pol == "binary32":
            pairs.append(("paged", "whole", CHUNKED_TOL))
        for a_key, b_key, rel in pairs:
            for i, what in enumerate(("prefill", "decode step")):
                a, b = res[a_key][i], res[b_key][i]
                err = float((a - b).abs().max())
                scale = float(b.abs().max())
                good = err <= rel * max(scale, 1.0) and bool(
                    torch.isfinite(a).all())
                ok &= good
                kind = ("chunked vs whole" if b_key == "whole" else
                        f"kernel ({a_key}) vs plain")
                report["logits"].append(dict(
                    arch=label, policy=pol, what=f"{kind} {what}",
                    layers=layers, max_abs_err=err,
                    max_abs_logit=scale, tol_rel=rel,
                    argmax_equal=bool((a.argmax(-1) == b.argmax(-1))
                                      .all()), ok=good))
                print(f"[logits] {label} {pol:<14} {kind} {what}, "
                      f"{layers}-layer full width, 64 + 36: max|diff| "
                      f"= {err:.3e} (max|logit| {scale:.3f}, tol "
                      f"{rel:.2e} x that) {'ok' if good else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return ok


def _first_step_logits(torch, model, cfg, pol, dec, mm, seed, *, prompt,
                       page, params=None):
    """Logits of one prefill chunk of ``prompt`` random tokens (seeded)
    into a one-slot paged cache of 4 pages of ``page``, then of one
    decode step, under ``pol`` with decode backend ``dec`` and matmul
    ``mm`` (``qmm_pallas`` packs the weights): the kernel path
    (paged / flash_pallas, qmm_pallas) or the plain one (xla, xla).
    ``params``: served as they are (else made from ``seed``)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import paged_cache
    from repro_torch.models import qparams

    policy = get_policy(pol, decode_impl=dec, matmul_impl=mm)
    if params is None:
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
    lp, states, _ = model.prefill_chunk(params, toks.cuda(), states,
                                        [None] * len(states), policy,
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
            _, states, _ = model.prefill_chunk(
                params, prompts[si:si + 1].to(torch.int32).cuda(), states,
                [None] * len(states), policy, slot=si, q_offset=0)
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


# the served rmsnorm widths (1024-5120), then 8192 (the widest a thread
# keeps in registers, gamma read from memory) and 8320 (past it: the
# kernel's two-pass variant that reads the residual back)
ADD_RMS_DIMS = RMS_DIMS + (2560, 8320)     # 2560: recurrentgemma-2b
ADD_RMS_ROWS = (1, 2, 3, 4, 8, 9, 16, 17, 33, 64)


def check_add_rmsnorm(torch, report, args):
    """``add_rmsnorm`` (``add_rmsnorm_launch`` of ``csrc/rmsnorm.cu``) on
    the card bit for bit its plain version (``residual_add``, then
    ``rmsnorm_plain``, then the cast, run on the card) in both outputs,
    the residual and the normed row, at 1-64 rows and every served
    rmsnorm width (1024, 2048, 2560, 4096, 5120) and the kernel's two
    widest
    variants (8192, 8320), for bf16, f32 and f16 pairs,
    a mixed pair (f32 + bf16) and no add (the first norm), with a NaN
    row, an Inf row and a row past bf16's range in the inputs; and a
    row's bits free of the rows beside it (each row count against the
    64-row call)."""
    from repro_torch.kernels import rmsnorm as rms

    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    combos = ((bf, bf, bf), (f32, f32, f32), (f16, f16, f16),
              (f32, bf, bf), (bf, None, bf))
    g = torch.Generator(device="cuda").manual_seed(args.seed + 13)
    res, worst = {}, 0.0
    for d in ADD_RMS_DIMS:
        gamma = torch.randn((d,), generator=g, device="cuda") * 0.1
        for xdt, ydt, odt in combos:
            x = torch.randn((64, d), generator=g, device="cuda") * 3.0
            y = torch.randn((64, d), generator=g, device="cuda") * 2.0
            x[5, 7] = float("nan")
            y[9, 100] = float("inf")
            x[12, 3] = 3.0e38 if xdt != f16 else 6.0e4
            x = x.to(xdt)
            y = None if ydt is None else y.to(ydt)
            s64, n64 = rms.add_rmsnorm(x, y, gamma, odt)
            good = True
            for m in ADD_RMS_ROWS:
                ym = None if y is None else y[:m]
                s, n = rms.add_rmsnorm(x[:m], ym, gamma, odt)
                ps, pn = rms.add_rmsnorm_plain(x[:m], ym, gamma, odt)
                good &= torch.equal(_bits(s), _bits(ps)) \
                    and torch.equal(_bits(n), _bits(pn)) \
                    and torch.equal(_bits(s), _bits(s64[:m])) \
                    and torch.equal(_bits(n), _bits(n64[:m]))
                fin = torch.isfinite(pn)
                if fin.any():
                    worst = max(worst, float((n.float() - pn.float())
                                             [fin].abs().max()))
            key = f"{d}/{str(xdt)[6:]}+{str(ydt)[6:]}->{str(odt)[6:]}"
            res[key] = good
    ok = all(res.values())
    report["add_rmsnorm_bits_equal_plain"] = res
    report["add_rmsnorm_max_abs_err"] = worst
    print(f"[kernels] add_rmsnorm: residual and normed rows bit for bit "
          f"the plain version (add, rmsnorm_plain, cast) at {ADD_RMS_ROWS} "
          f"rows, d {ADD_RMS_DIMS}, with NaN / Inf / 3e38 inputs, and free "
          f"of the row count: {sum(res.values())} of {len(res)} "
          f"(width, dtypes) cases {'ok' if ok else 'FAIL'}")
    if not ok:
        print(f"[kernels] add_rmsnorm cases: {res}")
    return ok


# whisper-tiny's width (the register variant NPT 8), rwkv6-1.6b's,
# command-r-35b's (the 16-byte variant, or on misaligned rows the register
# variant NPT 64) and past 8192 (the re-reading variant)
ADD_LN_DIMS = (384, 2048, 8192, 8320)
ADD_LN_ROWS = (1, 4, 64, 100)


def _misaligned(torch, t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past a 16-byte boundary: ``add_layernorm_launch`` then takes its
    register variants, not the 16-byte one."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def check_add_layernorm(torch, report, args):
    """``add_layernorm`` (``add_layernorm_launch`` of ``csrc/rmsnorm.cu``)
    on the card bit for bit its plain version (``residual_add``, then
    ``layernorm_plain``, then the cast, run on the card) in both outputs,
    the residual and the normed row, at 1, 4, 64 and 100 rows and d 384,
    2048, 8192 and 8320, for bf16, f32 and f16 pairs, a mixed pair (f32 +
    bf16)
    and no add (the first norm), with a NaN row, an Inf row and a row past
    bf16's range in the inputs, on aligned rows and on misaligned ones
    (at d 8192 the 16-byte variant, and the register variant); and a
    row's bits free of
    the rows beside it (each row count against the 100-row call)."""
    from repro_torch.kernels import layernorm as ln

    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    combos = ((bf, bf, bf), (f32, f32, f32), (f16, f16, f16),
              (f32, bf, bf), (bf, None, bf), (f32, None, f32))
    g = torch.Generator(device="cuda").manual_seed(args.seed + 14)
    n_rows = max(ADD_LN_ROWS)
    res, worst = {}, 0.0
    for d in ADD_LN_DIMS:
        gamma = 1.0 + torch.randn((d,), generator=g, device="cuda") * 0.1
        beta = torch.randn((d,), generator=g, device="cuda") * 0.1
        for xdt, ydt, odt in combos:
            x = torch.randn((n_rows, d), generator=g, device="cuda") * 3.0
            x += 1.5
            y = torch.randn((n_rows, d), generator=g, device="cuda") * 2.0
            x[2, 7] = float("nan")
            y[3, 100] = float("inf")
            x[50, 3] = 3.0e38 if xdt != f16 else 6.0e4
            x = x.to(xdt)
            y = None if ydt is None else y.to(ydt)
            s_all, n_all = ln.add_layernorm(x, y, gamma, beta, odt)
            good = True
            for m in ADD_LN_ROWS:
                ym = None if y is None else y[:m]
                s, n = ln.add_layernorm(x[:m], ym, gamma, beta, odt)
                ps, pn = ln.add_layernorm_plain(x[:m], ym, gamma, beta, odt)
                ms, mn = ln.add_layernorm(_misaligned(torch, x[:m]), ym,
                                          gamma, beta, odt)
                good &= torch.equal(_bits(s), _bits(ps)) \
                    and torch.equal(_bits(n), _bits(pn)) \
                    and torch.equal(_bits(ms), _bits(ps)) \
                    and torch.equal(_bits(mn), _bits(pn)) \
                    and torch.equal(_bits(s), _bits(s_all[:m])) \
                    and torch.equal(_bits(n), _bits(n_all[:m]))
                fin = torch.isfinite(pn)
                if fin.any():
                    worst = max(worst, float((n.float() - pn.float())
                                             [fin].abs().max()))
            key = f"{d}/{str(xdt)[6:]}+{str(ydt)[6:]}->{str(odt)[6:]}"
            res[key] = good
    ok = all(res.values())
    report["add_layernorm_bits_equal_plain"] = res
    report["add_layernorm_max_abs_err"] = worst
    print(f"[kernels] add_layernorm: residual and normed rows bit for bit "
          f"the plain version (add, layernorm_plain, cast) at {ADD_LN_ROWS} "
          f"rows, d {ADD_LN_DIMS}, aligned and misaligned, with NaN / Inf "
          f"/ 3e38 inputs, and free "
          f"of the row count: {sum(res.values())} of {len(res)} "
          f"(width, dtypes) cases {'ok' if ok else 'FAIL'}")
    if not ok:
        print(f"[kernels] add_layernorm cases: {res}")
    return ok


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
    (``layernorm_hbm_bytes``).  Then ``add_layernorm`` at the same rows,
    bf16 + bf16 -> bf16 residual and bf16 normed rows (command-r's norm
    under transprecision): beside its plain version, the three launches
    it replaced (torch's add, the layernorm kernel, the bf16 cast), the
    torch sequence ``x + y; F.layer_norm(s.float(), ...).to(bfloat16)``
    and its byte bound (``add_layernorm_hbm_bytes``; no one PyTorch call
    computes the three)."""
    from repro_torch.kernels import layernorm as ln

    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 12)
    d = 8192
    bf = torch.bfloat16
    gamma = 1.0 + torch.randn((d,), generator=g, device="cuda") * 0.1
    beta = torch.randn((d,), generator=g, device="cuda") * 0.1
    for rows in (4, 64):
        x = (torch.randn((rows, d), generator=g, device="cuda") * 3.0).to(bf)
        y = (torch.randn((rows, d), generator=g, device="cuda") * 2.0).to(bf)
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

        def three():
            s = x + y
            return s, ln.layernorm_f32(s, gamma, beta).to(bf)
        t_f = timer(lambda: ln.add_layernorm(x, y, gamma, beta, bf))
        xm = _misaligned(torch, x)
        t_r = timer(lambda: ln.add_layernorm(xm, y, gamma, beta, bf))
        t_fp = timer(lambda: ln.add_layernorm_plain(x, y, gamma, beta, bf))
        t_3 = timer(three)
        t_seq = timer(lambda: torch.nn.functional.layer_norm(
            (x + y).float(), (d,), gamma, beta, 1e-5).to(bf))
        host_f = timer.host_us(lambda: ln.add_layernorm(x, y, gamma, beta,
                                                        bf))
        host_3 = timer.host_us(three)
        nbytes = ln.add_layernorm_hbm_bytes(rows, d, 2, 2, 2, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="add_layernorm", rows=rows, d=d, ms=t_f, plain_ms=t_fp,
            register_variant_ms=t_r, three_launches_ms=t_3, torch_sequence_ms=t_seq, library_ms=None,
            bound_ms=bound, bound_by="bytes", bytes=nbytes, host_us=host_f,
            three_launches_host_us=host_3))
        print(f"[timing] add_layernorm {rows:>3} x {d} bf16 + bf16 -> bf16: "
              f"kernel {t_f:.4f} ms (register variant, misaligned x: "
              f"{t_r:.4f})  plain {t_fp:.4f} ms  add + layernorm "
              f"kernel + cast {t_3:.4f} ms  x + y; F.layer_norm().to(bf16) "
              f"{t_seq:.4f} ms  bound {bound:.6f} ms  host {host_f:.1f} us "
              f"(the three: {host_3:.1f} us)")


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
    bound.  Then ``add_rmsnorm`` at the same rows, bf16 + bf16 -> bf16
    residual and bf16 normed rows (the transprecision decoder's norm):
    beside its plain version, the three launches it replaced (torch's
    add, the rmsnorm kernel, the bf16 cast), the torch sequence ``x + y;
    F.rms_norm(...).to(bfloat16)`` and its byte bound (no one PyTorch
    call computes the three)."""
    from repro_torch.kernels import rmsnorm as rms

    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 10)
    d = 4096
    gamma = torch.randn((d,), generator=g, device="cuda") * 0.1
    weight = 1.0 + gamma
    bf = torch.bfloat16
    for rows in (4, 64):
        x = (torch.randn((rows, d), generator=g, device="cuda") * 3.0).to(bf)
        y = (torch.randn((rows, d), generator=g, device="cuda") * 2.0).to(bf)
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

        def three():
            s = x + y
            return s, rms.rmsnorm_f32(s, gamma).to(bf)
        t_f = timer(lambda: rms.add_rmsnorm(x, y, gamma, bf))
        t_fp = timer(lambda: rms.add_rmsnorm_plain(x, y, gamma, bf))
        t_3 = timer(three)
        t_seq = timer(lambda: torch.nn.functional.rms_norm(
            (x + y).float(), (d,), weight=weight, eps=1e-6).to(bf))
        host_f = timer.host_us(lambda: rms.add_rmsnorm(x, y, gamma, bf))
        host_3 = timer.host_us(three)
        nbytes = rms.add_rmsnorm_hbm_bytes(rows, d, 2, 2, 2, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="add_rmsnorm", rows=rows, d=d, ms=t_f, plain_ms=t_fp,
            three_launches_ms=t_3, torch_sequence_ms=t_seq, library_ms=None,
            bound_ms=bound, bound_by="bytes", bytes=nbytes, host_us=host_f,
            three_launches_host_us=host_3))
        print(f"[timing] add_rmsnorm {rows:>3} x {d} bf16 + bf16 -> bf16: "
              f"kernel {t_f:.4f} ms  plain {t_fp:.4f} ms  add + rmsnorm "
              f"kernel + cast {t_3:.4f} ms  x + y; F.rms_norm().to(bf16) "
              f"{t_seq:.4f} ms  bound {bound:.6f} ms  host {host_f:.1f} us "
              f"(the three: {host_3:.1f} us)")


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
# archs: the configs past llama3-8b served at full width and depth
# ---------------------------------------------------------------------------

ARCHS = ("yi-9b", "mistral-nemo-12b", "command-r-35b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "paligemma-3b",
         "rwkv6-1.6b", "recurrentgemma-2b")
ARCHS_PAGED = ("mistral-nemo-12b", "granite-moe-1b-a400m", "paligemma-3b",
               "recurrentgemma-2b")
ARCH_REQUESTS, ARCH_SLOTS, ARCH_PROMPT, ARCH_MAX_NEW = 2, 2, 64, 8
ARCH_PAGE = 64
# the recurrent configs' prompt: 100 tokens, chunked 64 + 36, so every
# recurrent state crosses a chunk edge
RECURRENT_PROMPT = 100


def recurrent(cfg) -> bool:
    return any(k != "attn" for k in cfg.attn_pattern)


def arch_prompt(cfg) -> int:
    """The archs phase's prompt length of ``cfg``: 64, or 100 for the
    recurrent configs."""
    return RECURRENT_PROMPT if recurrent(cfg) else ARCH_PROMPT


def arch_chunks(cfg):
    """The tokens of each prefill call of one prompt: pages of 64 (64 +
    36 for a recurrent config's 100), or a prefix-LM's whole prompt
    (prefix rows and tokens) in one call."""
    n = arch_prompt(cfg)
    if cfg.prefix_len:
        return (cfg.prefix_len + n,)
    return (ARCH_PAGE,) * (n // ARCH_PAGE) + ((n % ARCH_PAGE,)
                                              if n % ARCH_PAGE else ())


def arch_capacity(cfg) -> int:
    """Each slot's KV capacity in the archs phase: a request's rows (a
    prefix-LM's prefix, the prompt and the new tokens) in whole pages:
    128 for the decoder-only configs (the recurrent ones' 100 + 8 too,
    at most recurrentgemma's window of 2048), 384 for paligemma-3b's 256
    + 64 + 8."""
    rows = cfg.prefix_len + arch_prompt(cfg) + ARCH_MAX_NEW
    return -(-rows // ARCH_PAGE) * ARCH_PAGE


# the tied heads' column pieces: (pieces, the last one's width)
WANT_HEAD_PIECES = {"command-r-35b": (8, 26624),
                    "granite-moe-1b-a400m": (2, 16387),
                    "paligemma-3b": (8, 27840),
                    "recurrentgemma-2b": (8, 26624)}


def head_pieces(cfg):
    """The tied head's column pieces (``models/layers._head_plain``
    widens ``HEAD_COLS`` columns at a time): (pieces, last piece's
    width); (0, 0) for an untied head, which is one qmm."""
    from repro_torch.models.layers import HEAD_COLS
    if not cfg.tied_embeddings:
        return 0, 0
    n = -(-cfg.vocab // HEAD_COLS)
    return n, cfg.vocab - (n - 1) * HEAD_COLS


def arch_launches(cfg, decode_impl):
    """What a decode step and a prefill chunk of ``cfg`` launch under
    transprecision with packed weights: ``(tuple per decode step, tuple
    per chunk, qmm by kernel per decode step, per chunk, grouped
    launches per step or chunk)``, tuples in ``libs`` order (qmm,
    paged_decode, flash_prefill, flash_decode, flexfloat_cast, norms),
    qmm by kernel (qmm_gemv, qmm_tile, qmm_tc).  A layer: the products
    of ``arch_step_products`` (attention 4, rwkv 8 with its channel mix,
    RG-LRU 5, then but for rwkv the fused gated FFN and w_out), an MoE
    layer also the binary32 router, one grouped launch for the gated
    pair (``qmm_tc_grouped_ffn``) and one for w_out (``qmm_tc_grouped``),
    all packed bf16 on the tensor cores except the router (the GEMV at a
    decode step's 2 rows, qmm_tile in a 64-row chunk); one
    attention call an attention layer; the untied head one qmm_tc, the
    tied one ``torch.matmul``; two norms a layer and the final one, each
    one fused launch with its residual add and cast (``add_rmsnorm`` for
    the rmsnorm configs, ``add_layernorm`` for command-r and rwkv6);
    under ``rwkv_fused`` two ``dequantize_decode`` a layer
    (``fused_dense``).  A
    prefix-LM's "chunk" is its whole prompt (prefix and tokens in one
    call), which launches what a chunk does; a recurrent config's 36-row
    chunk launches what its 64-row one does."""
    L = cfg.n_layers
    A = cfg.attn_pattern.count("attn")
    head = 0 if cfg.tied_embeddings else 1
    tc = sum(p[-1] for p in arch_step_products(cfg)) + head
    router = L if cfg.moe_experts else 0
    grouped = 2 * L if cfg.moe_experts else 0
    norms = 2 * L + 1
    qmm = tc + router + grouped
    casts = fused_dense(cfg)          # as_array's dequantize_decode
    dec = (qmm, A if decode_impl == "paged" else 0, 0,
           0 if decode_impl == "paged" else A, casts, norms)
    pre = (qmm, 0, A, 0, casts, norms)
    return dec, pre, (router, 0, tc), (0, router, tc), grouped


def _arch_serve(torch, report, libs, args, arch, decode_impl, params, cfg,
                extra=(), label=None):
    """One counted serve of ``arch`` over ``params`` (``extra``: more
    serve flags, e.g. ``--set rwkv_fused=1``; ``label`` names its stats
    file); the checks of :func:`run_archs`.  Returns (ok, the report
    entry)."""
    from repro_torch.engine import worker
    from repro_torch.models import layers, moe

    stats = f"archs_{label or arch}_{decode_impl}_stats.jsonl"
    argv = [*extra, "--arch", arch, "--policy", "transprecision",
            "--decode-impl", decode_impl, "--matmul-impl", "qmm_pallas",
            "--page-size", str(ARCH_PAGE), "--requests", str(ARCH_REQUESTS),
            "--slots", str(ARCH_SLOTS), "--prompt-len",
            str(arch_prompt(cfg)), "--max-new", str(ARCH_MAX_NEW),
            "--capacity", str(arch_capacity(cfg)), "--seed", str(args.seed),
            "--stats-out", os.path.join(args.out, stats)]
    # each slot's length when its prompt has landed: the prefix rows and
    # the prompt's (read from the first attention layer's pool in the
    # prefill call, before the hooks' counts close; an attention-free
    # config has no pool, and its prompt cursor is read), and the tokens
    # of every prefill call
    real_step = worker.PrefillWorker.step
    landed, chunks = [], []
    first_attn = next((li for li, k in enumerate(cfg.attn_pattern)
                       if k == "attn"), None)

    def step(self, task, view, slot):
        at = task.offset
        view = real_step(self, task, view, slot)
        chunks.append(task.offset - at)
        if task.done:
            landed.append(task.offset if first_attn is None
                          else int(view[first_attn].seq_lens[slot]))
        return view
    # the dense gated FFN's launches (one qmm_tc each) by the call's rows:
    # a decode step's (at most ARCH_SLOTS) or a prefill call's
    real_ffn = layers.qmm_ffn
    ffn_rows = {"decode": 0, "prefill": 0}

    def ffn(x, *a, **k):
        ffn_rows["decode" if x.shape[0] <= ARCH_SLOTS else "prefill"] += 1
        return real_ffn(x, *a, **k)
    # the experts' launches inside the grouped products (the gated pair's
    # and w_out's): qmm_tc_grouped_ffn and qmm_tc_grouped, and per-expert
    # qmm_tc (none)
    real = {k: getattr(moe, k) for k in ("pgrouped_dot", "grouped_ffn_in")}
    experts, per_expert = [0], [0]

    def counted(fn):
        def wrapped(*a, **k):
            by = libs[0].by_kernel
            before = _grouped_launches(libs[0]), by.get("qmm_tc", 0)
            out = fn(*a, **k)
            experts[0] += _grouped_launches(libs[0]) - before[0]
            per_expert[0] += by.get("qmm_tc", 0) - before[1]
            return out
        return wrapped
    for k, fn in real.items():
        setattr(moe, k, counted(fn))
    worker.PrefillWorker.step = step
    layers.qmm_ffn = ffn
    try:
        with _counting(layers, NORM_APART) as apart, \
                _counting(layers, ("_compute_operands",)) as head:
            reqs, per, launches, wall, peak = _drive_serve(
                torch, libs, argv,
                {"decode": (worker.DecodeWorker, "step"),
                 "prefill": (worker.PrefillWorker, "step")}, params=params)
    finally:
        worker.PrefillWorker.step = real_step
        layers.qmm_ffn = real_ffn
        for k, fn in real.items():
            setattr(moe, k, fn)
    want_dec, want_pre, want_dec_k, want_pre_k, want_grouped = \
        arch_launches(cfg, decode_impl)
    norm_entry = f"add_{cfg.norm}_launch"
    calls = len(per["decode"]) + len(per["prefill"])
    ok = all(r.done and not r.failed for r in reqs)
    ok &= all(len(r.generated) == ARCH_MAX_NEW for r in reqs)
    ok &= all(0 <= t < cfg.vocab for r in reqs for t in r.generated)
    ok &= _counts_ok(per["decode"], want_dec)
    ok &= _counts_ok(per["prefill"], want_pre)
    ok &= _counts_ok(per["decode/kern"], want_dec_k)
    ok &= _counts_ok(per["prefill/kern"], want_pre_k)
    ok &= launches["norms_by_entry"] == {norm_entry: calls * want_dec[5]}
    ok &= not any(apart.values())
    ok &= _counts_ok(per["decode/grouped"], want_grouped)
    ok &= _counts_ok(per["prefill/grouped"], want_grouped)
    ok &= experts[0] == calls * want_grouped and per_expert[0] == 0
    # the tied head: one torch.matmul a column piece (a call's logits are
    # at most 2 rows, one 8-row block), and the fused rwkv's products on
    # its derived weights (fused_dense); every other plain product is on
    # a kernel.  The dense gated FFN: one qmm_ffn a layer a call
    pieces, last = head_pieces(cfg)
    ok &= (pieces, last) == WANT_HEAD_PIECES.get(arch, (0, 0))
    ok &= head["_compute_operands"] == calls * (pieces + fused_dense(cfg))
    L = 0 if cfg.moe_experts else sum(k != "rwkv" for k in cfg.attn_pattern)
    want_ffn = {"decode": len(per["decode"]) * L,
                "prefill": len(per["prefill"]) * L}
    ok &= ffn_rows == want_ffn
    want_rows = cfg.prefix_len + arch_prompt(cfg)
    ok &= landed == [want_rows] * ARCH_REQUESTS
    want_chunks = list(arch_chunks(cfg)) * ARCH_REQUESTS
    ok &= chunks == want_chunks
    summary = _serve_summary(args, stats)
    entry = dict(
        arch=arch, decode_impl=decode_impl, n_layers=cfg.n_layers,
        d_model=cfg.d_model, params=cfg.param_count(),
        requests=len(reqs), tokens=sum(len(r.generated) for r in reqs),
        wall_s=wall, tok_per_s=summary["tokens_per_s"],
        ttft_mean_s=summary["ttft_mean_s"], decode_steps=len(per["decode"]),
        prefill_chunks=len(per["prefill"]), launches=launches,
        norms_apart=apart,
        grouped_launches=experts[0], expert_qmm_tc_launches=per_expert[0],
        grouped_by_kernel={k: launches["qmm_by_kernel"].get(k, 0)
                           for k in GROUPED_KERNELS},
        grouped_per_decode_step=sorted(set(per["decode/grouped"])),
        grouped_per_prefill_chunk=sorted(set(per["prefill/grouped"])),
        peak_mem_bytes=peak, capacity=arch_capacity(cfg),
        head_pieces=pieces, head_last_piece_cols=last,
        head_matmul_pieces=head["_compute_operands"],
        qmm_ffn_rows=ffn_rows, act=cfg.act_fn,
        slot_rows_after_prefill=landed, prefill_call_tokens=chunks,
        attention_layers=cfg.attn_pattern.count("attn"),
        per_decode_step=sorted(set(per["decode"])),
        per_prefill_chunk=sorted(set(per["prefill"])),
        qmm_kernels_per_decode_step=sorted(set(per["decode/kern"])),
        qmm_kernels_per_prefill_chunk=sorted(set(per["prefill/kern"])),
        want=dict(decode=want_dec, prefill=want_pre, decode_kern=want_dec_k,
                  prefill_kern=want_pre_k, grouped=want_grouped),
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
          f"{want_pre_k}); grouped per step / chunk "
          f"{entry['grouped_per_decode_step']} / "
          f"{entry['grouped_per_prefill_chunk']} (want {want_grouped}); "
          f"norms {launches['norms_by_entry']} (want {norm_entry} x "
          f"{want_dec[5]} a call), standalone residual adds and three-step "
          f"norms {apart} (want 0); per-expert qmm_tc launches "
          f"{per_expert[0]} (want 0); head torch.matmul pieces "
          f"{head['_compute_operands']} (want {calls} calls x "
          f"{pieces + fused_dense(cfg)}"
          f"{f', the last {last} columns wide' if pieces else ''}); gated "
          f"{cfg.act_fn} qmm_ffn launches {ffn_rows} (want {want_ffn}); "
          f"slot rows after prefill {landed} (want "
          f"{want_rows} each{' = prefix + prompt' if cfg.prefix_len else ''})"
          f"; tokens a prefill call {chunks} (want {want_chunks}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok, entry


def check_moe_no_sync(torch, report, arch, cfg, params, seed):
    """Layer 0's MoE FFN (``moe_apply``) of the full-width ``params`` on
    2 tokens under ``torch.cuda.set_sync_debug_mode("error")``: any torch
    op that waits for the device raises.  The output must equal an
    unwatched run's bit for bit."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models import moe

    policy = get_policy("transprecision", decode_impl="flash_pallas",
                        matmul_impl="qmm_pallas").at_layer(0)
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    x = torch.randn((1, 2, cfg.d_model), generator=gen,
                    device="cuda").to(policy.dtype("act"))
    p = params["layers"][0]["ffn"]
    want, _ = moe.moe_apply(p, x, cfg, policy)
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = moe.moe_apply(p, x, cfg, policy)
    except RuntimeError as e:       # a synchronising op
        err, got = str(e).splitlines()[0], None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = got is not None and torch.equal(got, want)
    ok = err is None and same
    report.setdefault("moe_no_sync", {})[arch] = dict(
        error=err, equal_to_unwatched=same, ok=ok)
    print(f"[archs] {arch}: one MoE layer under set_sync_debug_mode"
          f"(\"error\"): {'no host synchronisation' if err is None else err}"
          f", output equal to an unwatched run {same} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def run_archs(torch, report, libs, args):
    """``serve.main`` on each config past llama3-8b at full width and
    full depth (random weights from ``--seed``, made once a config and
    served as they are): transprecision, ``qmm_pallas``,
    ``flash_pallas``, 2 requests x (64 + 8) over 2 slots (the recurrent
    configs 2 x (100 + 8), the prompt in chunks of 64 + 36), page 64,
    capacity ``arch_capacity`` (128; paligemma-3b 384, after its 256
    zero stub prefix rows); mistral-nemo-12b, granite-moe, paligemma-3b
    and recurrentgemma-2b once more under ``paged``.  Asserted: every
    request gets its tokens; the launches of every decode step and every
    prefill chunk (paligemma: every whole prompt), by library and by qmm
    kernel (``arch_launches``: rwkv6 193 ``qmm_tc`` and no attention,
    recurrentgemma 174 ``qmm_tc`` and 8 attention calls); the norm kind
    (fused add_layernorm for command-r and rwkv6, fused add_rmsnorm for
    the rest, and no standalone residual add or three-step norm); the
    tied heads' ``torch.matmul`` pieces (``head_pieces``); one
    ``qmm_ffn`` a layer with an FFN a call; every slot's length when its
    prompt lands (prefix + prompt) and the tokens of every prefill call
    (``arch_chunks``); the experts' launches
    (two grouped calls a layer a step or chunk, the gated pair and w_out,
    and no per-expert qmm_tc), one device kernel a grouped call in the
    profiled step; one MoE layer of each MoE config with no host
    synchronisation (``check_moe_no_sync``); and each model freed before
    the next is built.  Measured: tok/s, TTFT, peak memory (init and
    serve) and the device busy share and device activities of one
    steady decode step (torch.profiler, device activity only).  MoE
    tokens are not held to speculative exactness (see
    ``check_logits_archs``)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models.registry import build

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    out = report["archs"] = {}
    ok = True
    for arch in args.archs.split(","):
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
        if cfg.moe_experts:
            ok &= check_moe_no_sync(torch, report, arch, cfg, params,
                                    args.seed)
        argv = ["--arch", arch, "--policy", "transprecision",
                "--decode-impl", "flash_pallas", "--matmul-impl",
                "qmm_pallas", "--page-size", str(ARCH_PAGE), "--requests",
                str(ARCH_REQUESTS), "--slots", str(ARCH_SLOTS),
                "--prompt-len", str(arch_prompt(cfg)), "--max-new", "4",
                "--capacity", str(arch_capacity(cfg)), "--seed",
                str(args.seed)]
        busy, wall, top, steps, rows = _profiled_serve(
            torch, argv, window=1, params=params)
        # device activities of the step; the grouped expert product's
        # device kernels: one a call, two a MoE layer (the split and
        # reduce kernels of the three-launch design are gone)
        acts, grouped, old = device_counts(rows, "qmm_tc_grouped",
                                           "qmm_grouped_")
        want = 2 * cfg.n_layers if cfg.moe_experts else 0
        good = grouped == want and old == 0
        ok &= good
        out[f"{arch}/flash_pallas"].update(
            step_wall_s=wall, step_device_busy_s=busy,
            step_busy_share=busy / wall, step_top=top[:5],
            step_device_activities=acts, step_grouped_kernels=grouped)
        print(f"[archs] {arch}: one steady decode step {wall * 1e3:.1f} ms "
              f"wall, device busy {busy * 1e3:.2f} ms "
              f"({100 * busy / wall:.1f} %), {acts} device activities, "
              f"grouped device kernels {grouped} (want {want}), "
              f"split / reduce kernels {old} (want 0) "
              f"{'ok' if good else 'FAIL'}; top: "
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
    from repro_torch.tuning import __main__ as tune_cli

    path = os.path.join(args.out, "serve_tune.json")
    argv = list(TUNE_ARGV) + ["--seed", str(args.seed), "--out", path]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _model_calls(torch, libs) as per:   # the tuner's path only
        res = tune_cli.main(argv)
    calls = {k: len(per[k]) for k in ("prefill", "decode")}
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
# phase encdec: whisper-tiny, the encoder-decoder, through prefill/decode,
# synchronous_generate and the serve-time tuner
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-tiny"
# the synchronous serve: 2 prompts x (64 + 8) at capacity 128
ENC_PROMPTS, ENC_PROMPT, ENC_MAX_NEW, ENC_CAPACITY = 2, 64, 8, 128
ENC_STEPS = 8              # decode steps of the logits checks
ENC_DECODE_LEN = 72        # rows a decode step reads in the kernel rows
WHISPER_SHAPE = dict(H=6, G=1, dh=64)
WHISPER_PREFILL = dict(B=1, Sq=ENC_PROMPT, Skv=ENC_PROMPT, **WHISPER_SHAPE)
WHISPER_LN_ROWS = (1, 1500)
ENC_TUNE_ARGV = ("--arch", ENCDEC_ARCH, "--sets", "1", "--prompts", "2",
                 "--prompt-len", "16", "--decode-steps", "2", "--kv-groups",
                 "2", "--max-rounds", "1", "--eps", str(TUNE_EPS))
AFFINE = {"b_in": 0.0, "b_out": 0.0, "gamma": 1.0, "beta": 0.0}


def encdec_products(cfg, M):
    """The packed products one call of an enc-dec ``cfg`` launches on
    ``qmm_tc`` when it encodes (every prefill, and every decode step
    given ``encoder_embeds``), by shape: ``[(names, rows, K, N, act,
    bias, launches)]``.  The encoder's blocks at its ``encoder_len`` rows
    (wq, wk, wv, wo, the ungated FFN with its bias and activation in one
    ``qmm_ffn``, w_out), each decoder layer's self-attention projections,
    cross-attention wq and wo and FFN at the call's ``M`` rows, its cross
    wk and wv at the encoder's rows, and the untied head at one row (a
    prefill's last position, or the decode row).  w_out's bias is a torch
    add after the product (the reference rounds before and after it)."""
    d, ff, T = cfg.d_model, cfg.d_ff, cfg.encoder_len
    q, kv, act, bias = cfg.q_dim, cfg.kv_dim, cfg.act_fn, cfg.use_bias
    prods = {}

    def add(name, rows, K, N, a=None, b=False, n=1):
        names, c = prods.get((rows, K, N, a, b), ((), 0))
        prods[(rows, K, N, a, b)] = (
            names + ((name,) if name not in names else ()), c + n)
    for _ in range(cfg.encoder_layers):
        add("enc wq", T, d, q)
        add("enc wk/wv", T, d, kv, n=2)
        add("enc wo", T, q, d)
        add(f"enc ffn {act}", T, d, ff, act, bias)
        add("enc w_out", T, ff, d)
    for _ in range(cfg.n_layers):
        add("wq", M, d, q)
        add("wk/wv", M, d, kv, n=2)
        add("wo", M, q, d)
        add("xattn wq", M, d, q)
        add("xattn wk/wv", T, d, kv, n=2)
        add("xattn wo", M, q, d)
        add(f"ffn {act}", M, d, ff, act, bias)
        add("w_out", M, ff, d)
    add("head", 1, d, cfg.vocab)
    return [("/".join(names),) + key + (c,)
            for key, (names, c) in prods.items()]


def encdec_qmm_cases(cfg):
    """The distinct packed products of an enc-dec ``cfg``'s decode steps
    (M 1) and whole-prompt prefills (M 64), as ``(name, M, K, N, act,
    bias)``: M 1, 64 and the encoder's 1500."""
    cases = {}
    for M in (1, ENC_PROMPT):
        for name, rows, K, N, act, bias, _ in encdec_products(cfg, M):
            cases.setdefault((rows, K, N, act, bias), name)
    return [(name,) + key for key, name in cases.items()]


def encdec_launches(cfg, decode_impl):
    """What a whole-prompt prefill and a decode step (with
    ``encoder_embeds``) of an enc-dec ``cfg`` launch under transprecision
    with packed weights: ``(tuple per decode step, tuple per prefill,
    qmm launches a call)``, tuples in ``libs`` order (qmm, paged_decode,
    flash_prefill, flash_decode, flexfloat_cast, norms).  Every product
    of ``encdec_products`` on ``qmm_tc`` (whisper-tiny: encoder 4 x 6,
    decoder 4 x 10, the head: 65, 32 of them at 1500 rows); one attention
    kernel a decoder layer, its self-attention (the encoder's and the
    cross attention are plain torch, as in the reference); two norms an
    encoder layer, three a decoder layer and the final one, each one
    fused ``add_layernorm`` (21)."""
    E, L = cfg.encoder_layers, cfg.n_layers
    qmm = sum(p[-1] for p in encdec_products(cfg, 1))
    norms = 2 * E + 3 * L + 1
    paged = decode_impl == "paged"
    dec = (qmm, L if paged else 0, 0, 0 if paged else L, 0, norms)
    pre = (qmm, 0, L, 0, 0, norms)
    return dec, pre, qmm


def _random_affine(torch, params, seed):
    """``params`` with every bias, gamma and beta drawn anew (normal, 0.1
    scale about 0 or 1, in the leaf's dtype): at init they are 0 and 1,
    and a served run cannot show a fault in them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: ((AFFINE[k] + 0.1 * torch.randn(
                v.shape, generator=g, device=v.device)).to(v.dtype)
                if k in AFFINE else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(params)


def _encdec_logits(torch, model, cfg, pol, dec, mm, seed, toks, nxt, emb):
    """Logits of ``prefill`` at capacity ``ENC_CAPACITY`` and of the
    decode steps feeding ``nxt`` (teacher-forced) with
    ``encoder_embeds=emb``, on random weights, biases, gammas and betas
    from ``seed``; beside every step the same step with ``enc_out=`` the
    encoder output of ``emb``.  Returns (logits, each step's two logits
    bit for bit equal, attention launches)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import qparams

    policy = get_policy(pol, decode_impl=dec, matmul_impl=mm)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = _random_affine(torch, model.init_params(gen, policy,
                                                     device="cuda"),
                            seed + 1)
    if mm == "qmm_pallas":
        params = qparams.encode_params(params, policy)
    libs = (FA.LIB, FA.DECODE_LIB, PA.LIB)
    before = [lib.launches for lib in libs]
    lp, st = model.prefill(params, {"tokens": toks, "encoder_embeds": emb},
                           policy, ENC_CAPACITY)
    dt = policy.dtype("act") if policy.mode == "native" else torch.float32
    enc = model._enc_out(params, emb, dt, model._policy(policy))
    out, same, st_e = [lp.float()], [], st
    for t in nxt:
        tok = torch.tensor([[t]], dtype=torch.int32, device="cuda")
        ld, st = model.decode_step(params, tok, st, policy,
                                   encoder_embeds=emb)
        le, st_e = model.decode_step(params, tok, st_e, policy, enc_out=enc)
        same.append(torch.equal(_bits(ld), _bits(le)))
        out.append(ld.float())
    launches = [lib.launches - b for lib, b in zip(libs, before)]
    del params, st, st_e, enc
    torch.cuda.empty_cache()
    return out, same, launches


def check_encdec_logits(torch, report, args, model, cfg):
    """whisper-tiny at full width and depth on random frame embeddings
    (normal, 0.02 scale) and random biases, gammas and betas (the served
    zero frames give a zero encoder output, and the init's zero biases
    and betas hide faults in them): a 64-token prompt's prefill at
    capacity 128 and 8 teacher-forced decode steps with
    ``encoder_embeds=`` (the whole encoder a step).  Kernel route
    (``qmm_pallas`` under ``flash_pallas`` and under ``paged``) against
    the plain route (``xla``, ``xla``) within ``LOGIT_TOL`` x max|logit|,
    under binary32 and transprecision; every step's logits with
    ``enc_out=`` bit for bit those with ``encoder_embeds=``; the kernel
    route's attention launches (one flash_prefill a decoder layer in the
    prefill, one decode kernel a layer in each of the two decode calls a
    step); and under binary32 the random frames' logits apart from the
    zero frames' by more than the tolerance."""
    import numpy as np

    rng = np.random.default_rng(args.seed + 41)
    emb = torch.tensor(rng.normal(size=(1, cfg.encoder_len, cfg.d_model))
                       * 0.02, dtype=torch.float32, device="cuda")
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, ENC_PROMPT)),
                        dtype=torch.int32, device="cuda")
    nxt = rng.integers(0, cfg.vocab, ENC_STEPS).tolist()
    L = cfg.n_layers
    ok, kernel = True, {}
    for pol, rel in LOGIT_TOL.items():
        plain, psame, _ = _encdec_logits(torch, model, cfg, pol, "xla",
                                         "xla", args.seed, toks, nxt, emb)
        for dec in ("flash_pallas", "paged"):
            got, same, launches = _encdec_logits(
                torch, model, cfg, pol, dec, "qmm_pallas", args.seed, toks,
                nxt, emb)
            kernel[(pol, dec)] = got
            want_l = [L, 2 * L * ENC_STEPS if dec == "flash_pallas" else 0,
                      2 * L * ENC_STEPS if dec == "paged" else 0]
            errs = [float((a - b).abs().max()) for a, b in zip(got, plain)]
            scale = max(float(b.abs().max()) for b in plain)
            good = (max(errs) <= rel * max(scale, 1.0)
                    and all(bool(torch.isfinite(a).all()) for a in got)
                    and all(same) and all(psame) and launches == want_l)
            ok &= good
            report["logits"].append(dict(
                arch=cfg.arch, policy=pol, decode_impl=dec,
                what="prefill and 8 decode steps, random frames and "
                     "affine", max_abs_err=max(errs), errs=errs,
                max_abs_logit=scale, tol_rel=rel,
                enc_out_bits_equal=all(same) and all(psame),
                attention_launches=launches, ok=good))
            print(f"[encdec] logits {pol:<14} {dec:<12} full width and "
                  f"depth, random frames: max|kernel - plain| over the "
                  f"prefill and {ENC_STEPS} decode steps = {max(errs):.3e} "
                  f"(max|logit| {scale:.3f}, tol {rel:.2e} x that); "
                  f"enc_out= bit for bit encoder_embeds= {all(same)} / "
                  f"plain {all(psame)}; (flash_prefill, flash_decode, "
                  f"paged_decode) launches {launches} (want {want_l}) "
                  f"{'ok' if good else 'FAIL'}")
    zero, _, _ = _encdec_logits(torch, model, cfg, "binary32",
                                "flash_pallas", "qmm_pallas", args.seed,
                                toks, nxt, torch.zeros_like(emb))
    rand = kernel[("binary32", "flash_pallas")]
    diff = min(float((a - b).abs().max()) for a, b in zip(rand, zero))
    tol = LOGIT_TOL["binary32"] * max(float(b.abs().max()) for b in zero)
    good = diff > tol
    ok &= good
    report["logits"].append(dict(
        arch=cfg.arch, policy="binary32",
        what="random vs zero frames, kernel route", min_max_abs_diff=diff,
        must_exceed=tol, ok=good))
    print(f"[encdec] logits binary32 kernel route: random frames against "
          f"zero frames, the least over the {ENC_STEPS + 1} calls of "
          f"max|diff| = {diff:.3e} (must exceed {tol:.3e}) "
          f"{'ok' if good else 'FAIL'}")
    return ok


@contextlib.contextmanager
def _model_calls(torch, libs):
    """Every launch count set to 0, then for each ``Model.prefill`` and
    ``Model.decode_step`` call made inside the block its launches (a
    tuple in ``libs`` order) under ``per["prefill"]`` /
    ``per["decode"]``, its qmm launches by kernel under ``per[kind +
    "/kern"]``, and each prefill's time to its logits under
    ``per["ttft"]``: yields ``per``."""
    from repro_torch.models.transformer import Model

    per = {"prefill": [], "decode": [], "prefill/kern": [],
           "decode/kern": [], "ttft": []}
    saved = {k: getattr(Model, a) for k, a in (("prefill", "prefill"),
                                               ("decode", "decode_step"))}

    def counted(kind):
        def fn(self, *a, **k):
            before = [lib.launches for lib in libs]
            kern = _qmm_kernels(libs[0])
            t0 = time.perf_counter()
            out = saved[kind](self, *a, **k)
            if kind == "prefill":
                torch.cuda.synchronize()
                per["ttft"].append(time.perf_counter() - t0)
            per[kind].append(tuple(lib.launches - b for lib, b
                                   in zip(libs, before)))
            per[kind + "/kern"].append(_qmm_kernels(libs[0], kern))
            return out
        return fn
    Model.prefill, Model.decode_step = counted("prefill"), \
        counted("decode")
    for lib in libs:
        lib.reset_counts()               # counts of the main path only
    try:
        yield per
    finally:
        Model.prefill, Model.decode_step = saved["prefill"], \
            saved["decode"]


def _encdec_serve(torch, libs, args, model, cfg, params, policy, prompts):
    """``synchronous_generate`` of ``prompts`` on the card, its calls'
    launches recorded (``_model_calls``), the encoder's final residual
    adds and the three-step norms counted."""
    from repro_torch.engine import synchronous_generate
    from repro_torch.models import layers, transformer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _model_calls(torch, libs) as per, \
            _counting(layers, NORM_APART) as apart, \
            _counting(transformer, ("residual_add",)) as enc_add:
        toks = synchronous_generate(model, cfg, policy, params, prompts,
                                    max_new=ENC_MAX_NEW,
                                    capacity=ENC_CAPACITY, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    launches["qmm_by_kernel"] = dict(libs[0].by_kernel)
    launches["norms_by_entry"] = dict(libs[5].by_symbol)
    return (toks, per, launches, wall, torch.cuda.max_memory_allocated(),
            apart, enc_add["residual_add"])


def _profile_encdec_step(torch, model, cfg, params, policy, prompt):
    """One steady decode step (after a prefill and one step) under
    torch.profiler, device activity only: (wall s, device busy s, device
    activities, top rows, the median wall s of five unprofiled runs of
    the same step)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine.worker import make_batch

    batch = make_batch(cfg, prompt, "cuda")
    emb = batch["encoder_embeds"]
    _, st = model.prefill(params, batch, policy, ENC_CAPACITY)
    tok = torch.tensor([[prompt[-1]]], dtype=torch.int32, device="cuda")
    _, st = model.decode_step(params, tok, st, policy, encoder_embeds=emb)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.decode_step(params, tok, st, policy, encoder_embeds=emb)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, tok, st, policy, encoder_embeds=emb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    events = device_rows(rows)
    busy = sum(_dev_us(e) for e in events) / 1e6
    top = [dict(name=e.key[:80], count=e.count, device_ms=_dev_us(e) / 1e3)
           for e in sorted(events, key=_dev_us, reverse=True)[:8]]
    return wall, busy, sum(e.count for e in events), top, \
        sorted(walls)[2]


def run_encdec_serve(torch, report, libs, args, model, cfg):
    """``synchronous_generate`` of 2 prompts x (64 + 8) at capacity 128
    on full-width, full-depth whisper-tiny (transprecision, ``qmm_pallas``,
    random weights from ``--seed``, the served zero frames to the
    prefill and to every decode step) under ``flash_pallas`` and
    ``paged``: each prefill and each decode step launches what
    ``encdec_launches`` says (65 qmm_tc, 4 attention kernels, 21 fused
    add_layernorm, no three-step norm), the encoder's one plain residual
    add a call; every prompt gets its tokens.  Measured: TTFT (each
    prefill to its logits), tok/s, peak memory, and under flash_pallas
    one steady decode step's wall, device busy share and top device
    rows."""
    import numpy as np
    from repro_torch.core.policy import get_policy
    from repro_torch.models import qparams

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, min(cfg.vocab, 97), ENC_PROMPT).tolist()
               for _ in range(ENC_PROMPTS)]
    out = report["encdec"]["serve"] = {}
    ok = True
    for dec in ("flash_pallas", "paged"):
        policy = get_policy("transprecision", decode_impl=dec,
                            matmul_impl="qmm_pallas")
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = qparams.encode_params(
            model.init_params(gen, policy, device="cuda"), policy)
        toks, per, launches, wall, peak, apart, enc_add = _encdec_serve(
            torch, libs, args, model, cfg, params, policy, prompts)
        want_dec, want_pre, qmm = encdec_launches(cfg, dec)
        calls = len(per["prefill"]) + len(per["decode"])
        good = (len(toks) == ENC_PROMPTS
                and all(len(t) == ENC_MAX_NEW for t in toks)
                and all(0 <= t < cfg.vocab for r in toks for t in r)
                and len(per["prefill"]) == ENC_PROMPTS
                and len(per["decode"]) == ENC_PROMPTS * (ENC_MAX_NEW - 1)
                and _counts_ok(per["decode"], want_dec)
                and _counts_ok(per["prefill"], want_pre)
                and _counts_ok(per["decode/kern"], (0, 0, qmm))
                and _counts_ok(per["prefill/kern"], (0, 0, qmm))
                and launches["norms_by_entry"]
                == {"add_layernorm_launch": calls * want_dec[5]}
                and not any(apart.values()) and enc_add == calls)
        ok &= good
        tokens = sum(len(t) for t in toks)
        entry = out[dec] = dict(
            prompts=ENC_PROMPTS, prompt_len=ENC_PROMPT, max_new=ENC_MAX_NEW,
            capacity=ENC_CAPACITY, tokens=tokens, wall_s=wall,
            tok_per_s=tokens / wall, ttft_s=per["ttft"],
            ttft_mean_s=sum(per["ttft"]) / len(per["ttft"]),
            peak_mem_bytes=peak, prefills=len(per["prefill"]),
            decode_steps=len(per["decode"]), launches=launches,
            per_decode_step=sorted(set(per["decode"])),
            per_prefill=sorted(set(per["prefill"])),
            qmm_tc_decode=sum(k[2] for k in per["decode/kern"]),
            qmm_tc_prefill=sum(k[2] for k in per["prefill/kern"]),
            norms_apart=apart, encoder_residual_adds=enc_add,
            want=dict(decode=want_dec, prefill=want_pre), generated=toks,
            ok=good)
        print(f"[encdec] synchronous_generate {ENC_PROMPTS} x "
              f"({ENC_PROMPT} + {ENC_MAX_NEW}) full width and depth, "
              f"transprecision, qmm_pallas, {dec}: {tokens} tokens in "
              f"{wall:.3f} s, {tokens / wall:.2f} tok/s, TTFT mean "
              f"{entry['ttft_mean_s']:.4f} s, peak memory "
              f"{peak / 1e9:.3f} GB ({report['nvidia_smi']})")
        print(f"[encdec] {dec}: per decode step {entry['per_decode_step']} "
              f"(want {want_dec}), per prefill {entry['per_prefill']} (want "
              f"{want_pre}); qmm_tc {entry['qmm_tc_decode']} in decode "
              f"steps, {entry['qmm_tc_prefill']} in prefills ({qmm} a "
              f"call); norms {launches['norms_by_entry']}, three-step "
              f"{apart} (want 0), the encoder's plain residual adds "
              f"{enc_add} (want {calls}) {'ok' if good else 'FAIL'}")
        if dec == "flash_pallas":
            swall, busy, acts, top, bare = _profile_encdec_step(
                torch, model, cfg, params, policy, prompts[0])
            entry.update(step_wall_s=swall, step_device_busy_s=busy,
                         step_busy_share=busy / swall,
                         step_device_activities=acts, step_top=top,
                         step_wall_unprofiled_s=bare)
            print(f"[encdec] one steady decode step (the encoder included):"
                  f" {swall * 1e3:.2f} ms wall under the profiler "
                  f"({bare * 1e3:.2f} ms without), device busy "
                  f"{busy * 1e3:.3f} ms ({100 * busy / swall:.1f} % of the "
                  f"profiled wall), {acts} device activities; top: "
                  + ", ".join(f"{e['name'][:40]} {e['device_ms']:.3f} ms "
                              f"x{e['count']}" for e in top[:4]))
        del params
        torch.cuda.empty_cache()
    return ok


def run_encdec_tune(torch, report, libs, args):
    """``python -m repro_torch.tuning --arch whisper-tiny`` at full width
    and depth on the card (``flash_pallas``, the card's default): 1
    calibration set x 2 prompts of 16 tokens, 2 decode positions, 2 KV
    depth groups, 1 round, eps 0.1, zero frames to every prefill and
    decode.  Holds: KL <= eps; tuned bytes below the binary32 bytes; the
    artifact round-trips to ``to_policy()``; every prefill launches 4
    flash_prefill and every decode step 4 flash_decode (no attention of
    the decoder ran plain on the card)."""
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.tuning import __main__ as tune_cli

    L = configs.get(ENCDEC_ARCH).n_layers
    path = os.path.join(args.out, "encdec_tune.json")
    argv = list(ENC_TUNE_ARGV) + ["--seed", str(args.seed), "--out", path]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _model_calls(torch, libs) as calls:
        res = tune_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # (flash_prefill, flash_decode) launches of each call
    per = {k: [c[2:4] for c in calls[k]] for k in ("prefill", "decode")}
    total = res.weight_bytes + res.kv_bytes_per_token
    total32 = res.weight_bytes_f32 + res.kv_bytes_per_token_f32
    checks = dict(
        kl_within_eps=res.final_kl <= TUNE_EPS,
        bytes_below_f32=total < total32,
        artifact_round_trips=PrecisionPolicy.from_artifact(
            res.to_artifact()) == res.to_policy(),
        prefills_on_flash_prefill=_counts_ok(per["prefill"], (L, 0)),
        decodes_on_flash_decode=_counts_ok(per["decode"], (0, L)),
        decode_is_flash=res.decode_impl == "flash_pallas")
    ok = all(checks.values())
    report["encdec"]["tune"] = dict(
        argv=argv, final_kl=res.final_kl, n_evals=res.n_evals,
        formats={k: f.name for k, f in res.formats.items()},
        fmt_histogram=res.fmt_histogram(), bytes=total, bytes_f32=total32,
        prefills=len(per["prefill"]), decode_steps=len(per["decode"]),
        wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated(),
        checks=checks, ok=ok)
    print(f"[encdec] python -m repro_torch.tuning --arch {ENCDEC_ARCH} "
          f"(full width and depth): KL {res.final_kl:.4g} (eps {TUNE_EPS}),"
          f" {res.n_evals} evals, formats {res.fmt_histogram()}, bytes "
          f"{total}/{total32} ({total / total32:.3f}x f32), "
          f"{len(per['prefill'])} prefills and {len(per['decode'])} decode "
          f"steps, (flash_prefill, flash_decode) a call "
          f"{sorted(set(per['prefill']))} / {sorted(set(per['decode']))} "
          f"(want ({L}, 0) / (0, {L})); {wall:.1f} s; checks {checks} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def check_encdec_kernels(torch, np, report, timer):
    """The attention kernels and add_layernorm at whisper-tiny's shapes
    (H 6, G 1, dh 64; d 384): flash_prefill over the 64-row prompt (Sq =
    Skv = 64, q_offset 0) on f32 K/V (a whole-prompt prefill's) and e5m2,
    flash_decode and paged_decode of one slot holding 72 of 128 rows
    (e5m2, pages of 64), each within 1e-6 of its plain version;
    add_layernorm at 1 and 1500 rows (bf16 + bf16 -> bf16, f32 + f32 ->
    f32, no add) bit for bit its plain version."""
    from repro_torch.core.formats import BINARY8
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import paged_attention as PA

    ok, errs = True, {}
    for fmt in (None, BINARY8):
        q, kp, vp = _prefill_inputs(torch, np, fmt, report["seed"] + 42,
                                    **WHISPER_PREFILL)
        got = FA.flash_prefill(q, kp, vp, fmt)
        want = FA.flash_prefill_plain(q, kp, vp, fmt)
        errs[f"flash_prefill {'f32' if fmt is None else fmt.name}"] = \
            float((got - want).abs().max())
    S, B, page = ENC_CAPACITY, 1, 64
    q, kp, vp, lens = _decode_inputs(torch, np, BINARY8, report["seed"] + 43,
                                     S, [ENC_DECODE_LEN] * B,
                                     **WHISPER_SHAPE)
    got = FA.flash_decode(q, kp, vp, BINARY8, lens)
    want = FA.flash_decode_plain(q, kp, vp, BINARY8, lens)
    errs["flash_decode e5m2"] = float((got - want).abs().max())
    H, dh = WHISPER_SHAPE["H"], WHISPER_SHAPE["dh"]
    kpg = kp.reshape(B * S // page, page, H, dh).flip(0).contiguous()
    vpg = vp.reshape(B * S // page, page, H, dh).flip(0).contiguous()
    tables = torch.arange(B * S // page - 1, -1, -1, dtype=torch.int32,
                          device="cuda").reshape(B, S // page)
    got = PA.paged_decode(q, kpg, vpg, BINARY8, lens, tables)
    want = PA.paged_decode_plain(q, kpg, vpg, BINARY8, lens, tables)
    errs["paged_decode e5m2"] = float((got - want).abs().max())
    torch.cuda.synchronize()
    for k, e in errs.items():
        good = e <= 1e-6
        ok &= good
        print(f"[encdec] {k} at whisper-tiny's H 6, G 1, dh 64: max|kernel "
              f"- plain| = {e:.3e} (tol 1e-6) {'ok' if good else 'FAIL'}")
    report["prefill_whisper_max_abs_err"] = max(
        errs["flash_prefill f32"], errs["flash_prefill binary8"])
    report["flash_decode_whisper_max_abs_err"] = errs["flash_decode e5m2"]
    report["paged_whisper_max_abs_err"] = errs["paged_decode e5m2"]

    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 44)
    d = 384
    gamma = 1.0 + torch.randn((d,), generator=g, device="cuda") * 0.1
    beta = torch.randn((d,), generator=g, device="cuda") * 0.1
    res = {}
    for rows in WHISPER_LN_ROWS:
        for xdt, ydt in ((bf, bf), (f32, f32), (bf, None), (f32, None)):
            x = (torch.randn((rows, d), generator=g, device="cuda") * 3.0
                 ).to(xdt)
            y = None if ydt is None else (torch.randn(
                (rows, d), generator=g, device="cuda") * 2.0).to(ydt)
            s, n = ln.add_layernorm(x, y, gamma, beta, xdt)
            ps, pn = ln.add_layernorm_plain(x, y, gamma, beta, xdt)
            res[f"{rows}/{str(xdt)[6:]}+{str(ydt)[6:]}"] = torch.equal(
                _bits(s), _bits(ps)) and torch.equal(_bits(n), _bits(pn))
    good = all(res.values())
    ok &= good
    report["add_layernorm_d384_bits_equal_plain"] = res
    report["add_layernorm_d384_max_abs_err"] = 0.0 if good else None
    print(f"[encdec] add_layernorm d 384 at {WHISPER_LN_ROWS} rows bit for "
          f"bit its plain version: {res} {'ok' if good else 'FAIL'}")
    return ok


def time_encdec_kernels(torch, np, report, timer):
    """Times at whisper-tiny's shapes (CUDA events, L2 flushed): every
    packed product of a decode step (M 1, the encoder's and the cross
    K/V's 1500 rows) and of a whole-prompt prefill (M 64), each shape
    timed once and counted as often as the call launches it
    (``encdec_products``), binary16alt: kernel, plain version and
    ``torch.matmul`` on the dequantized weights (the biased gelu FFN:
    ``gelu(x @ w_in + b_in)``, two calls), and the bound of the call's
    bytes and operations; the attention kernels (``_time_served_attention``:
    flash_prefill over the 64-row prompt on f32 K/V, then e5m2;
    flash_decode and paged_decode of one slot at 72 of 128 rows);
    add_layernorm at 1 and 1500 rows; and the plain torch attention cores
    the path runs beside the kernels (the encoder's self-attention, 1500
    x 1500, and the cross attention of one decode row and of the 64-row
    prompt over 1500 encoder rows: scores, f32 softmax, probabilities
    rounded to bf16, weighted sum), beside SDPA."""
    from repro_torch import configs
    from repro_torch.core.formats import BINARY16ALT as fmt
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.models import attention as A

    cfg = configs.get(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 45)
    gelu = torch.nn.functional.gelu
    for per, M in (("decode_step", 1), ("prefill", ENC_PROMPT)):
        totals = dict(arch=ENCDEC_ARCH, per=per, M=M, fmt=fmt.name,
                      launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                      bytes=0, flops=0)
        for name, rows, K, N, act, bias, mult in encdec_products(cfg, M):
            x = torch.randn((rows, K), generator=gen, device="cuda")
            wp = _pack_weight(torch.randn((K, N), generator=gen,
                                          device="cuda"), fmt)
            wf = _unpack_weight(wp, fmt)
            b = torch.randn((N,), generator=gen, device="cuda") * 0.1 \
                if bias else None
            t_k = timer(lambda: Q.qmatmul(x, wp, None, fmt, bias=b,
                                          act=act))
            t_p = timer(lambda: Q.qmatmul_plain(x, wp, None, fmt, bias=b,
                                                act=act), iters=5)
            if act:
                t_l = timer(lambda: gelu(torch.addmm(b, x, wf),
                                         approximate="tanh"))
            else:
                t_l = timer(lambda: torch.matmul(x, wf))
            nbytes = Q.qmm_hbm_bytes(rows, K, N, fmt, bias=bias)
            flops = 2 * rows * K * N
            bound, by = qmm_bound(Q, fmt, nbytes, flops)
            report["timings"].append(dict(
                kernel="qmm_whisper", per=per, shape=name, M=rows, K=K, N=N,
                act=act, bias=bias, launches_per=mult, ms=t_k, plain_ms=t_p,
                library_ms=t_l, bound_ms=bound, bound_by=by, bytes=nbytes,
                flops=flops))
            print(f"[timing] qmm whisper {per:<11} {name[:26]:<26} "
                  f"x{mult:<2} M={rows:<4} K={K:<4} N={N:<5} kernel "
                  f"{t_k:.4f} ms  plain {t_p:.4f} ms  torch {t_l:.4f} ms"
                  f"  bound {bound:.5f} ms ({by})")
            for k, v in (("launches", mult), ("ms", mult * t_k),
                         ("plain_ms", mult * t_p),
                         ("library_ms", mult * t_l),
                         ("bytes", mult * nbytes), ("flops", mult * flops)):
                totals[k] += v
            del x, wp, wf, b
        totals["bound_ms"], totals["bound_by"] = qmm_bound(
            Q, fmt, totals["bytes"], totals["flops"])
        report["timings"].append(dict(kernel=f"qmm_tc_whisper_{per}",
                                      **totals))
        print(f"[timing] qmm whisper per {per} ({fmt.name}, "
              f"{totals['launches']} launches): kernel {totals['ms']:.3f} ms"
              f"  plain {totals['plain_ms']:.2f} ms  torch "
              f"{totals['library_ms']:.3f} ms  bound "
              f"{totals['bound_ms']:.4f} ms ({totals['bound_by']})")
    torch.cuda.empty_cache()

    for f32_kv, names in ((True, ("flash_prefill_whisper",
                                  "flash_decode_whisper",
                                  "paged_decode_whisper")),
                          (False, ("flash_prefill_whisper_e5m2",))):
        _time_served_attention(
            torch, np, report, timer, label="whisper", shape=WHISPER_SHAPE,
            prefill=WHISPER_PREFILL, q_offset=0, window=None, prefix=0,
            S=ENC_CAPACITY, n=ENC_DECODE_LEN, seeds=(46, 47), names=names,
            B=1, prefill_f32=f32_kv)

    bf = torch.bfloat16
    d = cfg.d_model
    gamma = 1.0 + torch.randn((d,), generator=gen, device="cuda") * 0.1
    beta = torch.randn((d,), generator=gen, device="cuda") * 0.1
    for rows in WHISPER_LN_ROWS:
        x = (torch.randn((rows, d), generator=gen, device="cuda") * 3.0
             ).to(bf)
        y = (torch.randn((rows, d), generator=gen, device="cuda") * 2.0
             ).to(bf)
        t_f = timer(lambda: ln.add_layernorm(x, y, gamma, beta, bf))
        t_p = timer(lambda: ln.add_layernorm_plain(x, y, gamma, beta, bf))
        t_s = timer(lambda: torch.nn.functional.layer_norm(
            (x + y).float(), (d,), gamma, beta, 1e-5).to(bf))
        nbytes = ln.add_layernorm_hbm_bytes(rows, d, 2, 2, 2, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="add_layernorm_whisper", rows=rows, d=d, ms=t_f,
            plain_ms=t_p, torch_sequence_ms=t_s, library_ms=None,
            bound_ms=bound, bound_by="bytes", bytes=nbytes))
        print(f"[timing] add_layernorm whisper {rows:>4} x {d} bf16 + bf16 "
              f"-> bf16: kernel {t_f:.4f} ms  plain {t_p:.4f} ms  x + y; "
              f"F.layer_norm().to(bf16) {t_s:.4f} ms  bound {bound:.6f} ms")

    # the plain attention cores the path runs (no TPU kernel: XLA in the
    # reference), per call and per layer
    policy = get_policy("transprecision")
    H, dh, T = cfg.n_kv, cfg.head_dim, cfg.encoder_len
    scale = np.float32(1.0 / np.sqrt(dh))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kk = torch.randn((1, T, H, dh), generator=gen, device="cuda").to(bf)
    vv = torch.randn((1, T, H, dh), generator=gen, device="cuda").to(bf)
    for what, Sq in (("encoder self-attention", T),
                     ("cross attention, decode row", 1),
                     ("cross attention, prompt", ENC_PROMPT)):
        qg = torch.randn((1, Sq, H, 1, dh), generator=gen,
                         device="cuda").to(bf)

        def core():
            s = A._gqa_scores(qg, kk, policy).to(torch.float32) * scale
            return A._softmax_weighted(s, vv, policy)
        qs, ks, vs = (qg[:, :, :, 0].transpose(1, 2),
                      kk.transpose(1, 2), vv.transpose(1, 2))
        t_c = timer(core)
        t_l = timer(lambda: sdpa(qs, ks, vs))
        report["timings"].append(dict(
            kernel="whisper_plain_attention", what=what, Sq=Sq, Skv=T, H=H,
            dh=dh, ms=t_c, sdpa_ms=t_l, layers_per_call=cfg.n_layers))
        print(f"[timing] plain torch attention core, whisper {what} (Sq "
              f"{Sq}, Skv {T}, H {H}, dh {dh}, bf16): {t_c:.4f} ms a layer"
              f" ({cfg.n_layers} a call)  SDPA {t_l:.4f} ms")


def run_encdec(torch, np, report, libs, args, timer):
    """whisper-tiny, the encoder-decoder, at full width and full depth
    (4 + 4 layers, d 384, 1500 frames, vocab 51,865): (a) logits on
    random frames and affine parameters (``check_encdec_logits``); (b)
    ``synchronous_generate`` with its launch counts
    (``run_encdec_serve``); (c) the serve-time tuner's CLI
    (``run_encdec_tune``); (d) the kernels at its shapes against their
    plain versions (``check_encdec_kernels``; its qmm products are in
    ``check_qmm_archs``) and timed (``time_encdec_kernels``)."""
    from repro_torch.models.registry import build

    report["encdec"] = {}
    model, cfg = build(ENCDEC_ARCH)
    ok = check_encdec_logits(torch, report, args, model, cfg)
    ok &= run_encdec_serve(torch, report, libs, args, model, cfg)
    ok &= run_encdec_tune(torch, report, libs, args)
    ok &= check_encdec_kernels(torch, np, report, timer)
    time_encdec_kernels(torch, np, report, timer)
    return ok


# ---------------------------------------------------------------------------
# train: training at full width on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_LAYERS = "llama3-8b", 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 128, 8, 1e-3
TRAIN_CKPT = 3                 # the step checkpointed, restored, resumed
TRAIN_SHAPE = dict(B=TRAIN_BATCH, Sq=TRAIN_SEQ, Skv=TRAIN_SEQ, H=8, G=4,
                   dh=128)     # llama3-8b's attention at the train batch
TRAIN_CLI_ARCHS = ("granite-moe-1b-a400m", "rwkv6-1.6b", "recurrentgemma-2b",
                   "paligemma-3b")
WHISPER_TRAIN = dict(batch=2, seq=64, steps=4)
# step 0 on the flash_pallas spelling against the xla spelling: loss
# (relative) and every grad leaf (max |diff| over its max |g|).  Under
# binary32 both are f32 math; under transprecision the xla spelling
# rounds the probabilities to bf16 (attn_probs) where the kernel keeps
# them f32, as in the reference.
TRAIN_ROUTE_TOL = {"binary32": (1e-5, 1e-4),
                   "transprecision": (1e-3, 5e-2)}
PREFILL_DIFF_TOL = 1e-5        # grads, over max |g| of the eager autograd
LAST_LOGITS_TOL = 1e-5         # over max |logit|


def _train_model(cfg_arch=TRAIN_ARCH, layers=TRAIN_LAYERS):
    """llama3-8b at full width, cut to ``layers`` layers in depth."""
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(configs.get(cfg_arch), n_layers=layers)
    return Model(cfg), cfg


def _leaf_errs(torch, got, want):
    """Per leaf max |got - want| / max |want| (0 when both are 0)."""
    from repro_torch.core.tree import leaves
    out = []
    for a, b in zip(leaves(got), leaves(want)):
        a, b = a.float(), b.float()
        m = float(b.abs().max())
        d = float((a - b).abs().max())
        out.append(d / m if m else d)
    return out


def check_prefill_diff(torch, np, report, timer):
    """``flash_prefill_diff`` at the train shape (B 8, Sq = Skv 128, H 8,
    G 4, dh 128, f32 K/V, causal): one ``flash_prefill`` launch forward,
    within 1e-6 x max(1, max |out|) of ``flash_prefill_plain``; its q, k,
    v grads against an
    eager autograd of ``flash_prefill_plain`` within 1e-5 x max |g|;
    timed (row 7e) beside its plain version, its bound and SDPA, with the
    backward's plain recompute timed beside."""
    from repro_torch.kernels import flash_attention as FA

    s = TRAIN_SHAPE
    B, Sq, H, G, dh = s["B"], s["Sq"], s["H"], s["G"], s["dh"]
    scale = float(1.0 / np.sqrt(dh))
    q, k, v = _prefill_inputs(torch, np, None, report["seed"] + 31, **s)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    FA.LIB.reset_counts()
    out = FA.flash_prefill_diff(*qkv, scale=scale)
    launches = FA.LIB.launches
    g = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(
                        report["seed"] + 32))
    got = torch.autograd.grad(out, qkv, g)
    ref_in = [t.detach().clone().requires_grad_() for t in qkv]
    ref = FA.flash_prefill_plain(*ref_in, None, scale=scale)
    want = torch.autograd.grad(ref, ref_in, g)
    fwd_err = float((out.detach() - ref.detach()).abs().max())
    fwd_tol = 1e-6 * max(1.0, float(ref.detach().abs().max()))
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]
    ok = launches == 1 and fwd_err <= fwd_tol \
        and max(errs) <= PREFILL_DIFF_TOL and out.grad_fn is not None
    report["prefill_diff"] = dict(launches=launches, fwd_max_abs_err=fwd_err,
                                  grad_rel_errs=errs, ok=ok)
    report["prefill_train_max_abs_err"] = fwd_err
    print(f"[train] flash_prefill_diff B={B} S={Sq} H={H} G={G} dh={dh}: "
          f"{launches} launch forward, max|fwd - plain| {fwd_err:.3e} (tol "
          f"{fwd_tol:.3e}), dq/dk/dv max|diff|/max|g| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {PREFILL_DIFF_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")

    qd, kd, vd = (t.detach() for t in qkv)
    t_k = timer(lambda: FA.flash_prefill(qd, kd, vd))
    t_p = timer(lambda: FA.flash_prefill_plain(qd, kd, vd), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = qd.reshape(B, Sq, H * G, dh).transpose(1, 2)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    t_l = timer(lambda: sdpa(qs, ks, vs, is_causal=True))

    def backward():
        xs = [t.detach().requires_grad_() for t in (qd, kd, vd)]
        torch.autograd.grad(FA.flash_prefill_plain(*xs, None, scale=scale),
                            xs, g)
    t_b = timer(backward, iters=10)
    live = B * Sq * (Sq + 1) // 2                # keys the queries need
    flops = 4 * dh * H * G * live
    nbytes = FA.prefill_hbm_bytes(B, Sq, Sq, H, G, dh, None)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    report["timings"].append(dict(
        kernel="flash_prefill_train", fmt="f32", **s, ms=t_k, plain_ms=t_p,
        library_ms=t_l, bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bytes=nbytes, flops=flops, backward_plain_ms=t_b))
    print(f"[timing] flash_prefill train B={B} Sq=Skv={Sq} H={H} G={G} "
          f"dh={dh} f32 causal: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
          f"SDPA {t_l:.4f} ms  bound {max(b_bytes, b_ops):.5f} ms  "
          f"backward (plain recompute) {t_b:.4f} ms")
    return ok


def check_train_norm(torch, report, timer):
    """add_rmsnorm at the train step's rows (B x S = 1024, d 4096, bf16
    residual and output, f32 gamma) on the route the train step takes:
    x, y and gamma need a gradient, so the launch goes through
    ``FusedNormFn``.  Both outputs bit for bit ``add_rmsnorm_plain``'s,
    and the grads of x, y and gamma (from random bf16 output grads) bit
    for bit an eager autograd of the plain version.  Then timed beside
    its plain version and ``x + y; F.rms_norm`` (row 9e)."""
    from repro_torch.kernels import rmsnorm as RN
    rows, d = TRAIN_BATCH * TRAIN_SEQ, 4096
    bf = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(report["seed"] + 33)
    x, y, g_s, g_n = (torch.randn((rows, d), device="cuda", generator=gen)
                      .to(bf) for _ in range(4))
    gamma = 0.1 * torch.randn((d,), device="cuda", generator=gen)

    got_in = [t.clone().requires_grad_() for t in (x, y, gamma)]
    RN.LIB.reset_counts()
    got = RN.add_rmsnorm(*got_in, bf)
    launches = RN.LIB.launches
    routed = all(t.grad_fn is not None
                 and type(t.grad_fn).__name__ == "FusedNormFnBackward"
                 for t in got)
    got_g = torch.autograd.grad(got, got_in, (g_s, g_n))
    want_in = [t.clone().requires_grad_() for t in (x, y, gamma)]
    want = RN.add_rmsnorm_plain(*want_in, bf)
    want_g = torch.autograd.grad(want, want_in, (g_s, g_n))
    pairs = list(zip(got, want)) + list(zip(got_g, want_g))
    errs = [float((a.detach().float() - b.detach().float()).abs().max())
            for a, b in pairs]
    bits = all(torch.equal(a.detach(), b.detach()) for a, b in pairs)
    ok = launches == 1 and routed and bits
    report["train_norm"] = dict(launches=launches, routed=routed,
                                max_abs_errs=dict(zip(
                                    ("s", "normed", "dx", "dy", "dgamma"),
                                    errs)), bit_for_bit=bits, ok=ok)
    report["add_rmsnorm_train_max_abs_err"] = max(errs)
    print(f"[train] add_rmsnorm rows={rows} d={d} bf16 through FusedNormFn: "
          f"{launches} launch, s/normed/dx/dy/dgamma max|diff| vs the plain "
          f"version's autograd {', '.join(f'{e:.3e}' for e in errs)} (bit "
          f"for bit: {bits}) {'ok' if ok else 'FAIL'}")
    del got_in, got, got_g, want_in, want, want_g

    t_k = timer(lambda: RN.add_rmsnorm(x, y, gamma, bf))
    t_p = timer(lambda: RN.add_rmsnorm_plain(x, y, gamma, bf), iters=10)
    t_l = timer(lambda: torch.nn.functional.rms_norm(
        (x + y).float(), (d,), 1.0 + gamma, 1e-6).to(bf))
    nbytes = RN.add_rmsnorm_hbm_bytes(rows, d, 2, 2, 2, 2)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    report["timings"].append(dict(
        kernel="add_rmsnorm_train", rows=rows, d=d, ms=t_k, plain_ms=t_p,
        library_ms=t_l, bound_ms=bound, bound_by="bytes", bytes=nbytes))
    print(f"[timing] add_rmsnorm train rows={rows} d={d} bf16: kernel "
          f"{t_k:.4f} ms  plain {t_p:.4f} ms  torch {t_l:.4f} ms  bound "
          f"{bound:.5f} ms")
    return ok


def _route_check(torch, report, model, data, pol_name):
    """Step 0's loss and grads on the flash_pallas spelling (the kernels)
    against the xla spelling (plain torch attention), same params and
    batch, within ``TRAIN_ROUTE_TOL``."""
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.train import loss_and_grads

    gen = torch.Generator("cuda").manual_seed(report["seed"] + 34)
    pol = get_policy(pol_name, decode_impl="flash_pallas")
    params = model.init_params(gen, pol, device="cuda")
    batch = data.batch_at(0, device="cuda")
    lf, gf = loss_and_grads(model, params, batch, pol)
    lx, gx = loss_and_grads(model, params, batch,
                            get_policy(pol_name, decode_impl="xla"))
    l_err = abs(float(lf) - float(lx)) / abs(float(lx))
    g_errs = _leaf_errs(torch, gf, gx)
    lt, gt = TRAIN_ROUTE_TOL[pol_name]
    ok = l_err <= lt and max(g_errs) <= gt
    report["train"][f"route_{pol_name}"] = dict(
        loss_flash=float(lf), loss_xla=float(lx), loss_rel_err=l_err,
        grad_rel_err_max=max(g_errs), grad_rel_err_median=float(
            sorted(g_errs)[len(g_errs) // 2]), tol=[lt, gt], ok=ok)
    print(f"[train] step 0 {pol_name}: loss flash_pallas {float(lf):.6f} "
          f"xla {float(lx):.6f} (rel {l_err:.2e}, tol {lt:g}); grads "
          f"max|diff|/max|g| worst leaf {max(g_errs):.2e} (tol {gt:g}) "
          f"{'ok' if ok else 'FAIL'}")
    del params, gf, gx
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _last_logits_check(torch, report, model, params, batch, pol):
    """The train forward's last-position logits (its final-norm output
    through the head) against ``Model.prefill``'s on the same params,
    batch and route.  The forward runs as the train step's does, every
    param leaf requiring grad, so its attention and norms go through
    ``flash_prefill_diff`` and ``FusedNormFn``: ``L`` flash_prefill and
    ``2 L + 1`` add_rmsnorm launches (no backward, so no recompute), and
    the final hidden state carries a ``grad_fn``."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.models import layers, transformer

    seen = {}
    real = transformer.lm_head_loss

    def spy(h, head_w, labels, policy, **kw):
        seen["h"] = h.detach()
        seen["grad_fn"] = h.grad_fn is not None
        return real(h, head_w, labels, policy, **kw)
    live = unflatten(params, [p.detach().requires_grad_(True)
                              for p in leaves(params)])
    transformer.lm_head_loss = spy
    FA.LIB.reset_counts()
    RN.LIB.reset_counts()
    try:
        loss = model.train_loss(live, batch, pol)
    finally:
        transformer.lm_head_loss = real
    launches = (FA.LIB.launches, RN.LIB.by_symbol.get("add_rmsnorm_launch",
                                                        0))
    L = model.cfg.n_layers
    routed = seen["grad_fn"] and loss.grad_fn is not None \
        and launches == (L, 2 * L + 1)
    del loss, live
    with torch.no_grad():
        got = layers.lm_logits(seen["h"][:, -1:], model._head_w(params), pol)
    want, _ = model.prefill(params, {"tokens": batch["tokens"]}, pol)
    err = float((got - want).abs().max()) / float(want.abs().max())
    ok = err <= LAST_LOGITS_TOL and routed
    report["train"]["last_logits"] = dict(
        rel_err=err, bitwise=bool(torch.equal(got, want)),
        grad_fn=seen["grad_fn"], launches=list(launches), ok=ok)
    print(f"[train] train forward (grad on: {launches[0]} flash_prefill, "
          f"{launches[1]} add_rmsnorm launches, want {L}, {2 * L + 1}; "
          f"grad_fn {seen['grad_fn']}) last-position logits vs "
          f"Model.prefill: max|diff|/max|logit| {err:.3e} (tol "
          f"{LAST_LOGITS_TOL:g}, bit for bit: {torch.equal(got, want)}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def _meta_like(torch, tree):
    """``tree`` with every tensor leaf replaced by an empty ``meta``
    tensor of its shape and dtype: the structure to restore into."""
    from repro_torch.core.tree import leaves, unflatten
    return unflatten(tree, [torch.empty(t.shape, dtype=t.dtype,
                                        device="meta")
                            for t in leaves(tree)])


def _train_steps(torch, step_fn, params, opt, data, steps, libs, *,
                 want=None, on_step=None):
    """Run ``steps`` (an iterable of step numbers): per step the loss,
    the wall and device milliseconds and the kernel launches (every
    count set to 0 just before the step, read just after)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    rows = []
    ok = True
    for step in steps:
        batch = data.batch_at(step, device="cuda")
        for lib in libs:
            lib.reset_counts()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        loss, params, opt = step_fn(params, opt, batch)
        b.record()
        loss = float(loss)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(flash_prefill=FA.LIB.launches,
                      norms=dict(RN.LIB.by_symbol),
                      others=sum(lib.launches for lib in libs
                                 if lib not in (FA.LIB, RN.LIB)))
        row = dict(step=step, loss=loss, wall_ms=wall,
                   device_ms=a.elapsed_time(b), launches=counts)
        if want is not None:
            good = counts["flash_prefill"] == want[0] and counts["norms"] \
                == {"add_rmsnorm_launch": want[1]} and counts["others"] == 0
            row["launches_ok"] = good
            ok &= good
        rows.append(row)
        if on_step is not None:
            on_step(step, params, opt)
        print(f"[train] step {step} loss {loss:.6f} wall {wall:.1f} ms "
              f"device {row['device_ms']:.1f} ms launches "
              f"flash_prefill {counts['flash_prefill']} add_rmsnorm "
              f"{counts['norms'].get('add_rmsnorm_launch', 0)} others "
              f"{counts['others']}"
              + ("" if want is None else
                 f" (want {want[0]}, {want[1]}, 0: "
                 f"{'ok' if row['launches_ok'] else 'FAIL'})"))
    return rows, params, opt, ok


def run_train(torch, np, report, libs, args, timer):
    """Training at full width on one card.  llama3-8b (d 4096, 32 H, 8
    KV, d_ff 14,336, vocab 128,256) cut to ``TRAIN_LAYERS`` layers by
    ``dataclasses.replace``: (a) ``flash_prefill_diff`` at its attention
    shape and ``add_rmsnorm`` through ``FusedNormFn`` at the step's rows,
    each against an eager autograd of its plain version, timed; (b) step
    0's loss and grads on the kernel spelling against the xla spelling,
    binary32 and transprecision; (c) the train forward's last-position
    logits (a forward with grad on) against ``Model.prefill``; (d) ``TRAIN_STEPS`` transprecision
    steps (batch 8, seq 128, lr 1e-3, flash_pallas): finite losses, the
    last below the first, per step the wall and device time and the
    launches (flash_prefill layers x 2 with the remat recompute,
    add_rmsnorm 4 L + 1, nothing else), the peak memory; (e) a checkpoint
    at step ``TRAIN_CKPT``, restored and resumed: steps 4-7's losses and
    the final params and master bit for bit the uninterrupted run's; (f)
    whisper-tiny at full depth (4 + 4 layers, 1500 frames, batch 2) for 4
    steps, its encoder's grads non-zero; (g) ``launch.train.main`` on
    four reduced configs."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.policy import get_policy
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw

    report["train"] = {}
    secs = report["train"]["seconds"] = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - t_lap[0]
        t_lap[0] = now
    ok = check_prefill_diff(torch, np, report, timer)
    ok &= check_train_norm(torch, report, timer)
    lap("kernels")
    model, cfg = _train_model()
    L = cfg.n_layers
    print(f"[train] {TRAIN_ARCH} d {cfg.d_model} H {cfg.n_heads} KV "
          f"{cfg.n_kv} d_ff {cfg.d_ff} vocab {cfg.vocab}, depth cut to "
          f"{L} of 32 layers (dataclasses.replace), "
          f"{cfg.param_count():,} params; batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}")
    report["train"]["config"] = dict(arch=TRAIN_ARCH, n_layers=L,
                                     reduced=f"n_layers 32 -> {L}",
                                     params=cfg.param_count())
    data = SyntheticLM(DataConfig(seed=args.seed, global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ), cfg)
    for pol_name in ("binary32", "transprecision"):
        ok &= _route_check(torch, report, model, data, pol_name)
    lap("routes")

    pol = get_policy("transprecision", decode_impl="flash_pallas")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(report["seed"])
    params = model.init_params(gen, pol, device="cuda")
    opt = adamw.init(params, pol)
    ok &= _last_logits_check(torch, report, model, params,
                             data.batch_at(0, device="cuda"), pol)
    step_fn = train_cli.make_train_step(model, pol, TRAIN_LR)
    want = (2 * L, 4 * L + 1)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=1)
    saved = {}

    def on_step(step, p, o):
        if step == TRAIN_CKPT:
            t0 = time.perf_counter()
            mgr.save(step, (p, o), extra={"data": data.state(step)})
            saved["host_copy_s"] = time.perf_counter() - t0
    try:
        rows, params, opt, good = _train_steps(
            torch, step_fn, params, opt, data, range(TRAIN_STEPS), libs,
            want=want, on_step=on_step)
        ok &= good
        lap("steps")
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [r["loss"] for r in rows]
        fin = all(np.isfinite(losses)) and losses[-1] < losses[0]
        ok &= fin
        print(f"[train] {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (finite and decreasing: {fin}); peak "
              f"{peak:.2f} GB allocated")
        t0 = time.perf_counter()
        mgr.wait()
        saved["write_wait_s"] = time.perf_counter() - t0
        # the uninterrupted run's end state to the host, the card freed
        # for the resumed run
        like = (params, opt)
        final_params = [t.cpu() for t in leaves(params)]
        final_master = [t.cpu() for t in leaves(opt.master)]
        like = tuple(_meta_like(torch, t) for t in like)
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (p2, o2), meta = mgr.restore(TRAIN_CKPT, like, device="cuda")
        saved["restore_s"] = time.perf_counter() - t0
        start = meta["extra"]["data"]["step"] + 1
        rows2, p2, o2, good = _train_steps(
            torch, step_fn, p2, o2, data, range(start, TRAIN_STEPS), libs,
            want=want)
        ok &= good
        lap("resume")
        same_loss = [r["loss"] for r in rows2] == losses[start:]
        same_params = all(torch.equal(a, b.cpu()) for a, b in zip(
            final_params, leaves(p2)))
        same_master = all(torch.equal(a, b.cpu()) for a, b in zip(
            final_master, leaves(o2.master)))
        resume_ok = same_loss and same_params and same_master
        ok &= resume_ok
        print(f"[train] checkpoint at step {TRAIN_CKPT} (host copy "
              f"{saved['host_copy_s']:.1f} s, write wait "
              f"{saved['write_wait_s']:.1f} s, restore "
              f"{saved['restore_s']:.1f} s), resumed steps {start}-"
              f"{TRAIN_STEPS - 1}: losses {same_loss}, params {same_params}, "
              f"master {same_master} bit for bit "
              f"{'ok' if resume_ok else 'FAIL'}")
        report["train"].update(
            steps=rows, resumed=rows2, peak_gb=peak, losses=losses,
            finite_decreasing=fin, checkpoint=saved,
            resume_bit_exact=dict(losses=same_loss, params=same_params,
                                  master=same_master),
            launches_per_step=dict(flash_prefill=want[0],
                                   add_rmsnorm=want[1]),
            flash_prefill_launches=sum(r["launches"]["flash_prefill"]
                                       for r in rows),
            add_rmsnorm_launches=sum(r["launches"]["norms"].get(
                "add_rmsnorm_launch", 0) for r in rows))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del p2, o2, final_params, final_master
    gc.collect()
    torch.cuda.empty_cache()
    ok &= _train_whisper(torch, np, report, args)
    lap("whisper")
    ok &= _train_cli(torch, report)
    lap("cli")
    print("[train] seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items()))
    return ok


def _train_whisper(torch, np, report, args):
    """whisper-tiny at full depth (4 encoder + 4 decoder layers, 1500
    frames of 0.02 N(0, 1), batch 2, 64 tokens), transprecision,
    flash_pallas: the encoder's grads non-zero at step 0, then 4 steps
    with finite, decreasing losses."""
    from repro_torch.core.policy import get_policy
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import build
    from repro_torch.optim import adamw

    model, cfg = build(ENCDEC_ARCH)
    w = WHISPER_TRAIN
    pol = get_policy("transprecision", decode_impl="flash_pallas")
    gen = torch.Generator("cuda").manual_seed(report["seed"] + 35)
    params = model.init_params(gen, pol, device="cuda")
    data = SyntheticLM(DataConfig(seed=args.seed, global_batch=w["batch"],
                                  seq_len=w["seq"]), cfg)
    _, grads = train_cli.loss_and_grads(model, params,
                                        data.batch_at(0, device="cuda"), pol)
    enc = [float(g.abs().max()) for p, g in flatten_with_path(grads)
           if p[0] == ("k", "encoder")]
    enc_ok = len(enc) > 0 and min(enc) > 0
    step_fn = train_cli.make_train_step(model, pol, TRAIN_LR)
    opt = adamw.init(params, pol)
    losses = []
    for step in range(w["steps"]):
        loss, params, opt = step_fn(params, opt,
                                    data.batch_at(step, device="cuda"))
        losses.append(float(loss))
    fin = all(np.isfinite(losses)) and losses[-1] < losses[0]
    ok = enc_ok and fin
    report["train"]["whisper"] = dict(losses=losses, encoder_leaves=len(enc),
                                      encoder_min_max_abs_grad=min(enc),
                                      ok=ok)
    print(f"[train] {ENCDEC_ARCH} {cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, {cfg.encoder_len} frames, batch {w['batch']}: "
          f"{len(enc)} encoder leaves, smallest max|grad| {min(enc):.3e}; "
          f"losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"{'ok' if ok else 'FAIL'}")
    del params, opt, grads
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _train_cli(torch, report):
    """``python -m repro_torch.launch.train --reduced --steps 3 --batch 2
    --seq 32 --ckpt-every 0`` on ``TRAIN_CLI_ARCHS`` (its ``main``, in
    this process): 3 finite losses each."""
    import tempfile

    import numpy as np

    from repro_torch.launch import train as train_cli

    ok = True
    report["train"]["cli"] = {}
    for arch in TRAIN_CLI_ARCHS:
        with tempfile.TemporaryDirectory(prefix="train_cli_") as d:
            losses = train_cli.main(["--arch", arch, "--reduced", "--steps",
                                     "3", "--batch", "2", "--seq", "32",
                                     "--ckpt-every", "0", "--ckpt-dir", d])
        good = len(losses) == 3 and all(np.isfinite(x) for x in losses)
        ok &= good
        report["train"]["cli"][arch] = losses
        print(f"[train] launch.train --arch {arch} --reduced: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)} "
              f"{'ok' if good else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# prefill_cont: continuation prefill into a contiguous cache
# ---------------------------------------------------------------------------

CONT_ROWS = 64                 # the cached rows, and the chunk after them
CONT_CAPACITY = 128


def run_prefill_cont(torch, np, report, libs, args, timer):
    """``attention.prefill_from_cache`` at llama3-8b's full width, one
    layer: the first 64 rows prefilled into a 128-row cache, then a
    64-row chunk at q_offset 64.  Transprecision (e5m2 cache,
    flash_pallas): one ``flash_prefill`` launch over the cache's bytes,
    its output within 1e-6 of ``flash_prefill_plain`` on the same
    payload, the new rows equal to the cast of the chunk's K/V;
    binary32: the chunk's output within 1e-5 x max |out| of one whole
    prefill of the 128 rows; the ring-cache and overflow ``ValueError``s;
    the kernel timed at this shape."""
    from repro_torch.core.formats import BINARY8
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as attn

    _, cfg = _train_model(layers=1)
    rep = report["prefill_cont"] = {}
    ok = True
    gen = torch.Generator("cuda").manual_seed(report["seed"] + 36)
    x = torch.randn((1, 2 * CONT_ROWS, cfg.d_model), device="cuda",
                    generator=gen)
    for pol_name in ("transprecision", "binary32"):
        pol = get_policy(pol_name, decode_impl="flash_pallas")
        p = attn.attn_init(gen, cfg, pol.dtype("attn_w"), "cuda")
        xa = x.to(pol.dtype("act"))
        with torch.no_grad():
            _, cache = attn.prefill_to_cache(p, xa[:, :CONT_ROWS], cfg, pol,
                                             CONT_CAPACITY)
        seen = []
        real = attn.flash_prefill

        def spy(q, k, v, fmt=None, **kw):
            out = real(q, k, v, fmt, **kw)
            seen.append((out, FA.flash_prefill_plain(q, k, v, fmt, **kw)))
            return out
        for lib in libs:
            lib.reset_counts()
        attn.flash_prefill = spy
        try:
            out, new = attn.prefill_from_cache(p, xa[:, CONT_ROWS:], cfg,
                                               pol, cache, CONT_ROWS)
        finally:
            attn.flash_prefill = real
        torch.cuda.synchronize()
        launches = FA.LIB.launches
        others = sum(lib.launches for lib in libs) - launches
        err = float((seen[0][0] - seen[0][1]).abs().max())
        good = launches == 1 and others == 0 and err <= 1e-6 \
            and new.pos == 2 * CONT_ROWS
        entry = dict(flash_prefill_launches=launches, other_launches=others,
                     core_max_abs_err=err)
        if pol_name == "transprecision":
            good &= cache.k.dtype == torch.float8_e5m2
            report["prefill_cont_max_abs_err"] = err
            rep["launches"] = launches
        else:
            with torch.no_grad():
                whole, _ = attn.prefill_to_cache(p, xa, cfg, pol,
                                                 CONT_CAPACITY)
            rel = float((out - whole[:, CONT_ROWS:]).abs().max()) / float(
                whole.abs().max())
            entry["vs_whole_rel_err"] = rel
            good &= rel <= 1e-5
        # the cached rows stay; the chunk's K/V (after rope) land at
        # [64, 128) in the cache format
        with torch.no_grad():
            _, k, v = attn._qkv(p, xa[:, CONT_ROWS:], cfg, pol)
            pos = torch.arange(CONT_ROWS, 2 * CONT_ROWS, device="cuda")
            k = attn.rope(k, pos[None, :], cfg.rope_theta)
        good &= torch.equal(new.k[:, :CONT_ROWS], cache.k[:, :CONT_ROWS]) \
            and torch.equal(new.k[:, CONT_ROWS:], k.to(new.k.dtype)) \
            and torch.equal(new.v[:, CONT_ROWS:], v.to(new.v.dtype))
        entry["ok"] = good
        rep[pol_name] = entry
        ok &= good
        print(f"[prefill_cont] {pol_name}: {launches} flash_prefill, "
              f"{others} other launches, core max|kernel - plain| "
              f"{err:.3e} (tol 1e-6)"
              + (f", vs one whole prefill max|diff|/max|out| "
                 f"{entry['vs_whole_rel_err']:.3e} (tol 1e-5)"
                 if "vs_whole_rel_err" in entry else "")
              + f" {'ok' if good else 'FAIL'}")
    # the reference's refusals
    raised = []
    for what, c, cap, off in (("ring", dataclasses.replace(cfg, window=64),
                               64, 0),
                              ("overflow", cfg, CONT_CAPACITY, 100)):
        shape = (1, cap, c.n_kv, c.head_dim)
        cache = attn.KVCache(k=torch.zeros(shape, device="cuda"),
                             v=torch.zeros(shape, device="cuda"), pos=off)
        try:
            attn.prefill_from_cache(p, xa[:, :CONT_ROWS], c, pol, cache, off)
        except ValueError as e:
            raised.append(what)
            print(f"[prefill_cont] {what}: ValueError({e})")
    ok &= raised == ["ring", "overflow"]
    rep["refusals"] = raised
    # the kernel at this shape: Sq 64 at q_offset 64 over the 128-row e5m2
    # cache (rows past 127 masked)
    s = dict(B=1, Sq=CONT_ROWS, Skv=CONT_CAPACITY, H=cfg.n_kv,
             G=cfg.n_heads // cfg.n_kv, dh=cfg.head_dim)
    q, kp, vp = _prefill_inputs(torch, np, BINARY8, report["seed"] + 37, **s)
    from repro_torch.core.qtensor import decode
    kd, vd = decode(kp, BINARY8), decode(vp, BINARY8)
    H, G, dh = s["H"], s["G"], s["dh"]
    qs = q.reshape(1, CONT_ROWS, H * G, dh).transpose(1, 2)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = FA.prefill_mask(CONT_ROWS, CONT_CAPACITY, CONT_ROWS, None, 0,
                           "cuda")
    t_k = timer(lambda: FA.flash_prefill(q, kp, vp, BINARY8,
                                         q_offset=CONT_ROWS))
    t_p = timer(lambda: FA.flash_prefill_plain(q, kp, vp, BINARY8,
                                               q_offset=CONT_ROWS), iters=10)
    t_l = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    live = int(mask.sum())
    flops = 4 * dh * H * G * live
    nbytes = FA.prefill_hbm_bytes(1, CONT_ROWS, CONT_CAPACITY, H, G, dh,
                                  BINARY8)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    report["timings"].append(dict(
        kernel="flash_prefill_cont", fmt="binary8", q_offset=CONT_ROWS, **s,
        ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bytes=nbytes, flops=flops))
    print(f"[timing] flash_prefill cont Sq={CONT_ROWS} Skv={CONT_CAPACITY} "
          f"q_offset={CONT_ROWS} e5m2: kernel {t_k:.4f} ms  plain "
          f"{t_p:.4f} ms  SDPA {t_l:.4f} ms  bound "
          f"{max(b_bytes, b_ops):.5f} ms")
    return ok


# ---------------------------------------------------------------------------
# phase tune_archs: the serve-time tuner on the recurrent and prefix-LM
# configs at full width and depth, then serving each artifact
# ---------------------------------------------------------------------------

TUNE_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b", "paligemma-3b")
TUNE_PROMPT, TUNE_DECODE = 16, 2  # TUNE_ARGV's --prompt-len, --decode-steps
# the storage dtype of each format of the tuner's ladder, written out here
# so that the binding check does not read the port's own mapping
LADDER_DTYPES = {"binary8": "float8_e5m2", "binary16alt": "bfloat16",
                 "binary16": "float16", "binary32": "float32"}


@contextlib.contextmanager
def _tune_bindings(torch, cfg):
    """Inside the block: every ``Model.prefill`` call's capacity, its
    attention caches' rows and write position, and for each recurrent
    layer whether the state it returns is stored in the dtype of that
    layer's ``layers.{li}.kv_cache`` binding in the candidate's policy
    (rwkv6's wkv state ``s``, the RG-LRU's conv history ``conv``; an
    attention cache's K likewise); every ``flash_decode`` call's cache
    rows and fewest valid rows.  These do not saturate as the KL can: a
    candidate whose two KV groups differ must give two dtypes.  Yields
    ``seen``."""
    import inspect
    from repro_torch.models import attention
    from repro_torch.models.transformer import Model

    seen = dict(capacities=set(), cache_rows=set(), cache_pos=set(),
                states_checked=0, states_wrong=[], mixed_calls=0,
                decode_rows=set(), decode_min_valid=None)
    real_prefill, real_fd = Model.prefill, attention.flash_decode
    sig = inspect.signature(real_prefill)

    def prefill(self, *a, **k):
        arg = sig.bind(self, *a, **k).arguments
        logits, states = real_prefill(self, *a, **k)
        seen["capacities"].add(arg.get("capacity"))
        dts = set()
        for li, (kind, st) in enumerate(zip(cfg.attn_pattern, states)):
            if kind == "attn":
                seen["cache_rows"].add(int(st.k.shape[1]))
                seen["cache_pos"].add(int(st.pos))
                t = st.k
            else:
                t = st.s if kind == "rwkv" else st.conv
            fmt = arg["policy"].formats[f"layers.{li}.kv_cache"]
            want = getattr(torch, LADDER_DTYPES[fmt.name])
            seen["states_checked"] += kind != "attn"
            dts.add(t.dtype)
            if t.dtype != want:
                seen["states_wrong"].append((li, str(t.dtype), str(want)))
        seen["mixed_calls"] += len(dts) > 1
        return logits, states

    def flash_decode(q, kp, vp, fmt, n_valid, *a, **k):
        seen["decode_rows"].add(int(kp.shape[1]))
        lo = int(n_valid.min())
        old = seen["decode_min_valid"]
        seen["decode_min_valid"] = lo if old is None else min(old, lo)
        return real_fd(q, kp, vp, fmt, n_valid, *a, **k)

    Model.prefill, attention.flash_decode = prefill, flash_decode
    try:
        yield seen
    finally:
        Model.prefill, attention.flash_decode = real_prefill, real_fd


def _binding_checks(cfg, seen) -> dict:
    """What ``_tune_bindings`` saw, held: every layer's state or cache in
    its ``kv_cache`` binding's dtype, and a candidate with two dtypes
    among them; the capacity, prefix rows included, within the window;
    the decode steps reading every cached row, paligemma's prefix
    too."""
    cap = cfg.prefix_len + TUNE_PROMPT + TUNE_DECODE
    rows = cap if cfg.window is None else min(cap, cfg.window)
    checks = dict(capacity_counts_prefix=seen["capacities"] == {cap},
                  capacity_within_window=cfg.window is None
                  or cap <= cfg.window)
    if any(k != "attn" for k in cfg.attn_pattern):
        checks.update(
            recurrent_states_take_kv_binding=seen["states_checked"] > 0
            and not seen["states_wrong"])
    checks.update(mixed_kv_bindings_seen=seen["mixed_calls"] > 0)
    if "attn" in cfg.attn_pattern:
        checks.update(
            caches_hold_prefix=seen["cache_rows"] == {rows}
            and seen["cache_pos"] == {cfg.prefix_len + TUNE_PROMPT},
            decode_reads_prefix=seen["decode_rows"] == {rows}
            and seen["decode_min_valid"] is not None
            and seen["decode_min_valid"] >= cfg.prefix_len + TUNE_PROMPT + 1)
    return checks


def run_tune_archs(torch, report, libs, args):
    """``python -m repro_torch.tuning`` (``__main__.main``) on rwkv6-1.6b,
    recurrentgemma-2b and paligemma-3b at full width and depth with
    llama3-8b's arguments (``TUNE_ARGV``: 1 set x 2 prompts x 16 tokens,
    2 decode positions, 2 KV groups, 1 round, eps 0.1) and the card's
    default decode (``flash_pallas``).  Holds, for each: KL <= eps; tuned
    bytes below the binary32 bytes; the artifact round-trips to
    ``to_policy()``; every prefill launches one ``flash_prefill`` and
    every decode step one ``flash_decode`` per attention layer and no
    ``paged_decode`` (recurrentgemma 8, paligemma 18, rwkv6 none), so no
    attention ran the plain path on the card.  Then each artifact serves
    2 requests x (16 + 8) through ``serve.main(["--policy", path, ...])``
    with packed weights (paligemma's capacity holds its 256 prefix
    rows)."""
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.tuning import __main__ as tune_cli

    rep = report["tune_archs"] = {}
    ok = True
    for arch in TUNE_ARCHS:
        cfg = configs.get(arch)
        n_attn = sum(k == "attn" for k in cfg.attn_pattern)
        path = os.path.join(args.out, f"tune_{arch}.json")
        argv = list(TUNE_ARGV) + ["--seed", str(args.seed), "--out", path]
        argv[argv.index("--arch") + 1] = arch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the binding spy wraps Model.prefill first, so that it binds the
        # arguments against the method's own signature
        with _tune_bindings(torch, cfg) as seen, \
                _model_calls(torch, libs) as calls:
            res = tune_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # (paged_decode, flash_prefill, flash_decode) launches of each call
        per = {k: [c[1:4] for c in calls[k]] for k in ("prefill", "decode")}
        total = res.weight_bytes + res.kv_bytes_per_token
        total32 = res.weight_bytes_f32 + res.kv_bytes_per_token_f32
        bindings = _binding_checks(cfg, seen)
        checks = dict(
            **bindings,
            kl_within_eps=res.final_kl <= TUNE_EPS,
            bytes_below_f32=total < total32,
            artifact_round_trips=PrecisionPolicy.from_artifact(
                res.to_artifact()) == res.to_policy(),
            prefills_on_flash_prefill=_counts_ok(per["prefill"],
                                                 (0, n_attn, 0)),
            decodes_on_flash_decode=_counts_ok(per["decode"],
                                               (0, 0, n_attn)),
            decode_is_flash=res.decode_impl == "flash_pallas")
        print(f"[tune_archs] {arch} full ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}): KL {res.final_kl:.4g} (eps {TUNE_EPS}), "
              f"{res.n_evals} evals, formats {res.fmt_histogram()}, bytes "
              f"{total}/{total32} ({total / total32:.3f}x f32), "
              f"{len(per['prefill'])} prefills and {len(per['decode'])} "
              f"decode steps, (paged_decode, flash_prefill, flash_decode) a "
              f"call {sorted(set(per['prefill']))} / "
              f"{sorted(set(per['decode']))} (want (0, {n_attn}, 0) / "
              f"(0, 0, {n_attn})); peak {peak / 1e9:.2f} GB; {wall:.1f} s")
        print(f"[tune_archs] {arch} bindings: prefill capacities "
              f"{sorted(seen['capacities'])}, cache rows "
              f"{sorted(seen['cache_rows'])} at pos "
              f"{sorted(seen['cache_pos'])}, decode rows "
              f"{sorted(seen['decode_rows'])} with >= "
              f"{seen['decode_min_valid']} valid; {seen['states_checked']} "
              f"recurrent states checked against their kv_cache binding, "
              f"{len(seen['states_wrong'])} wrong, {seen['mixed_calls']} "
              f"prefills with mixed state dtypes; {bindings}")
        torch.cuda.empty_cache()
        serve_argv = ["--arch", arch, "--policy", path, "--matmul-impl",
                      "qmm_pallas", "--requests", str(TUNED_REQUESTS),
                      "--slots", str(TUNED_REQUESTS), "--prompt-len",
                      str(TUNED_PROMPT), "--max-new", str(TUNED_MAX_NEW),
                      "--capacity", str(cfg.prefix_len + 32),
                      "--page-size", "16", "--seed", str(args.seed)]
        reqs, _, served, swall, speak = _drive_serve(torch, libs,
                                                     serve_argv, {})
        checks["artifact_serves"] = (
            len(reqs) == TUNED_REQUESTS
            and all(r.done and not r.failed
                    and len(r.generated) == TUNED_MAX_NEW
                    and all(0 <= t < cfg.vocab for t in r.generated)
                    for r in reqs)
            and served["paged_decode"] == 0
            and (served["flash_decode"] > 0) == bool(n_attn))
        good = all(checks.values())
        ok &= good
        rep[arch] = dict(
            argv=argv, final_kl=res.final_kl, n_evals=res.n_evals,
            formats={k: f.name for k, f in res.formats.items()},
            fmt_histogram=res.fmt_histogram(), bytes=total,
            bytes_f32=total32, prefills=len(per["prefill"]),
            decode_steps=len(per["decode"]), wall_s=wall,
            peak_mem_bytes=peak, serve_launches=served, serve_wall_s=swall,
            serve_peak_mem_bytes=speak, binding=dict(
                capacities=sorted(seen["capacities"]),
                cache_rows=sorted(seen["cache_rows"]),
                cache_pos=sorted(seen["cache_pos"]),
                decode_rows=sorted(seen["decode_rows"]),
                decode_min_valid=seen["decode_min_valid"],
                states_checked=seen["states_checked"],
                states_wrong=seen["states_wrong"],
                mixed_calls=seen["mixed_calls"]),
            generated=[r.generated for r in reqs], checks=checks, ok=good)
        print(f"[tune_archs] {arch} --policy {os.path.relpath(path, ROOT)}: "
              f"{len(reqs)} requests x ({TUNED_PROMPT} + {TUNED_MAX_NEW}) in "
              f"{swall:.2f} s, launches {served}; checks {checks} "
              f"{'ok' if good else 'FAIL'}")
        torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase mesh: the mesh decode wrappers on a 1-rank NCCL mesh, and the
# kernels at shard-local inputs split on the host
# ---------------------------------------------------------------------------

MESH_BASES = ("flash_pallas", "paged")
MESH_WRAPPED = ("flash_shmap+flash_pallas", "flash_shmap+paged",
                "ring+flash_pallas", "ring+paged")
MESH_BRANCHES = ("_shmap_decode", "_shmap_decode_paged", "_ring_decode",
                 "_ring_decode_paged")
MESH_PROMPT, MESH_MAX_NEW, MESH_CAPACITY = 64, 8, 128
MESH_LOGIT_TOL = 1e-6          # over max |logit| of the base spelling's
MESH_SHARDS = (2, 4, 8)
# the spellings whose decode step is profiled (the paged ones add the
# same host work; the script's time is bounded)
MESH_PROFILED = ("flash_pallas", "flash_shmap+flash_pallas",
                 "ring+flash_pallas")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_branch(impl: str) -> str:
    wrapper, base = impl.split("+")
    return ("_shmap_decode" if wrapper == "flash_shmap" else
            "_ring_decode") + ("_paged" if base == "paged" else "")


def _mesh_serve(torch, report, libs, args):
    """llama3-8b at full width and depth, 2 requests x (64 + 8) over 2
    slots, page 64, capacity 128, under binary32 and transprecision,
    through the bases and the four wrapped spellings under the ambient
    (1, 1) mesh.  Holds for each wrapped spelling: its sharded branch
    taken once per layer a decode step (a spy), 32 launches of its base's
    kernel a decode step, ``flash_shmap``'s merge one ``all_gather`` a
    layer, greedy tokens equal to its base's and every decode step's
    logits within 1e-6 x max |logit| of its base's.  Under
    transprecision ``_mesh_step_profile`` then profiles one steady decode
    step of ``flash_pallas`` and its two wrapped spellings."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch
    from repro_torch.models import qparams
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    model, cfg = build("llama3-8b")
    L = cfg.n_layers
    rep = report["mesh"]["serve"] = {}
    ok = True
    for pname in ("binary32", "transprecision"):
        pol = get_policy(pname, matmul_impl="qmm_pallas")
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        packed = qparams.encode_params(
            model.init_params(gen, pol, device="cuda"), pol)
        runs = {}
        def argv_of(impl, _pname=pname):
            return ["--arch", "llama3-8b", "--policy", _pname,
                    "--decode-impl", impl, "--matmul-impl", "qmm_pallas",
                    "--page-size", "64", "--requests", "2", "--slots", "2",
                    "--prompt-len", str(MESH_PROMPT), "--max-new",
                    str(MESH_MAX_NEW), "--capacity", str(MESH_CAPACITY),
                    "--seed", str(args.seed)]
        for impl in MESH_BASES + MESH_WRAPPED:
            logits = []
            real = Model.decode_step

            def keep(self, *a, _real=real, **k):
                out = _real(self, *a, **k)
                logits.append(out[0].float().cpu())
                return out
            argv = argv_of(impl)
            Model.decode_step = keep
            try:
                with _counting(dispatch, MESH_BRANCHES + ("_all_gather",)) \
                        as branches:
                    reqs, per, launches, wall, _ = _drive_serve(
                        torch, libs, argv,
                        {"decode": (Model, "decode_step")}, params=packed)
            finally:
                Model.decode_step = real
            runs[impl] = dict(
                tokens=[r.generated for r in reqs], logits=logits,
                decode=per["decode"], branches=dict(branches),
                launches=launches, wall_s=wall,
                done=all(r.done and not r.failed for r in reqs))
        if pname == "transprecision":
            ok &= _mesh_step_profile(torch, report, argv_of, packed)
        del packed
        for impl in MESH_WRAPPED:
            run, base = runs[impl], runs[impl.split("+")[1]]
            steps = len(run["decode"])
            # (paged_decode, flash_prefill, flash_decode) a decode step
            kern = (L, 0, 0) if impl.endswith("paged") else (0, 0, L)
            scale = max(float(x.abs().max()) for x in base["logits"])
            lerr = max(float((a - b).abs().max()) for a, b in
                       zip(run["logits"], base["logits"]))
            want_branch = {b: (L * steps if b == _mesh_branch(impl) else 0)
                           for b in MESH_BRANCHES}
            checks = dict(
                done=run["done"],
                branch_taken={b: run["branches"][b]
                              for b in MESH_BRANCHES} == want_branch,
                # flash_shmap: one gather of (o, m, l) a layer (the size-1
                # data dim is not gathered); the 1-rank ring passes nothing
                merge_collectives=run["branches"]["_all_gather"] == (
                    L * steps if impl.startswith("flash_shmap") else 0),
                attention_launches=_counts_ok(
                    [c[1:4] for c in run["decode"]], kern),
                tokens_equal_base=run["tokens"] == base["tokens"],
                logits_within_tol=(len(run["logits"]) == len(base["logits"])
                                   and lerr <= MESH_LOGIT_TOL * scale))
            good = all(checks.values())
            ok &= good
            rep[f"{pname}/{impl}"] = dict(
                decode_steps=steps, branches=run["branches"],
                per_decode_step=sorted(set(run["decode"])),
                logits_max_abs_diff=lerr, logits_scale=scale,
                wall_s=run["wall_s"], base_wall_s=base["wall_s"],
                tokens=run["tokens"], checks=checks, ok=good)
            print(f"[mesh] {pname} {impl}: {steps} decode steps, branch "
                  f"calls {run['branches']} (want {L} a step of "
                  f"{_mesh_branch(impl)}), launches a step "
                  f"{sorted(set(run['decode']))}; tokens equal "
                  f"{impl.split('+')[1]}'s: {checks['tokens_equal_base']}; "
                  f"logits max|diff| {lerr:.3e} of max|logit| {scale:.3g} "
                  f"(tol {MESH_LOGIT_TOL} x); wall {run['wall_s']:.2f} s "
                  f"(base {base['wall_s']:.2f}) {'ok' if good else 'FAIL'}")
        torch.cuda.empty_cache()
    return ok


def _host_rows(rows):
    """The CPU ops' rows of a profile: {name: (calls, self CPU us)}."""
    from torch.autograd import DeviceType
    return {e.key: (e.count, e.self_cpu_time_total) for e in rows
            if e.device_type == DeviceType.CPU}


def _mesh_step_profile(torch, report, argv_of, packed):
    """One steady decode step of ``flash_pallas`` and its two wrapped
    spellings (transprecision) under torch.profiler with the CPU ops
    traced: wall,
    device busy time and activities, host ops and their self CPU time,
    and the host ops a wrapped step adds to its base's (by calls, then
    by self time).  Says where a wrapped step's extra time goes; the
    tracer inflates every wall alike."""
    rep = report["mesh"]["step_profile"] = {}
    host = {}
    for impl in MESH_PROFILED:
        busy, wall, _, steps, rows = _profiled_serve(
            torch, argv_of(impl), window=1, params=packed, cpu=True)
        acts = device_counts(rows)[0]
        host[impl] = _host_rows(rows)
        del rows
        calls = sum(c for c, _ in host[impl].values())
        self_us = sum(t for _, t in host[impl].values())
        rep[impl] = dict(wall_s=wall, device_busy_s=busy, steps=steps,
                         device_activities=acts, host_op_calls=calls,
                         host_self_cpu_s=self_us / 1e6)
        if "+" in impl:
            base = host[impl.split("+")[1]]
            extra = {k: (c - base.get(k, (0, 0))[0],
                         (t - base.get(k, (0, 0))[1]) / 1e3)
                     for k, (c, t) in host[impl].items()
                     if c != base.get(k, (0, 0))[0]}
            top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
            rep[impl]["extra_host_ops"] = [
                dict(name=k[:60], calls=c, self_cpu_ms=ms)
                for k, (c, ms) in top]
            b = rep[impl.split("+")[1]]
            print(f"[mesh] profiled step {impl}: wall {wall * 1e3:.2f} ms "
                  f"(base {b['wall_s'] * 1e3:.2f}), device busy "
                  f"{busy * 1e3:.3f} ms (base {b['device_busy_s'] * 1e3:.3f})"
                  f", {acts} device activities (base "
                  f"{b['device_activities']}), host ops {calls} (base "
                  f"{b['host_op_calls']}), host self CPU "
                  f"{self_us / 1e3:.2f} ms (base "
                  f"{b['host_self_cpu_s'] * 1e3:.2f}); added host ops: "
                  + ", ".join(f"{k[:40]} x{c} {ms:.2f} ms"
                              for k, (c, ms) in top[:5]))
        else:
            print(f"[mesh] profiled step {impl}: wall {wall * 1e3:.2f} ms, "
                  f"device busy {busy * 1e3:.3f} ms, {acts} device "
                  f"activities, host ops {calls}, host self CPU "
                  f"{self_us / 1e3:.2f} ms")
        torch.cuda.empty_cache()
    return all(r["steps"] == 1 for r in rep.values())


def _split_cases(torch, np, seed):
    """The host-split cases: (name, fmt, q, contiguous K/V payload,
    lengths, pools, block tables).  The serve shape (B 4, H 8, G 4, dh
    128; 256 rows of which 144, 144, 7 and 0 live; e5m2) and paligemma's
    MQA decode (B 2, H 1, G 8, dh 256; 324 and 330 of 384; e5m2 and f32),
    each also as a pool of 64-row pages (shuffled, 16 or 32 pages so that
    2, 4 and 8 shards divide it)."""
    from repro_torch.core.formats import BINARY8
    from repro_torch.core.qtensor import encode
    cases = []
    for name, fmt, shp, S, lengths in (
            ("serve", BINARY8, dict(H=8, G=4, dh=128), 256, (144, 144, 7, 0)),
            ("mqa", BINARY8, MQA_SHAPE, MQA_S, (324, 330)),
            ("mqa_f32", None, MQA_SHAPE, MQA_S, (324, 330))):
        rng = np.random.default_rng(seed)
        B, H, G, dh = len(lengths), shp["H"], shp["G"], shp["dh"]
        q = torch.tensor(rng.normal(size=(B, H, G, dh)), dtype=torch.float32)
        kf = torch.tensor(rng.normal(size=(B, S, H, dh)), dtype=torch.float32)
        vf = torch.tensor(rng.normal(size=(B, S, H, dh)), dtype=torch.float32)
        kp = encode(kf, fmt) if fmt is not None else kf
        vp = encode(vf, fmt) if fmt is not None else vf
        pps = S // 64
        num_pages = 8 * -(-(B * pps) // 8)
        perm = rng.permutation(num_pages)
        tables = np.full((B, pps), -1, np.int32)
        for b in range(B):
            tables[b] = perm[b * pps:(b + 1) * pps]
        kpool = torch.zeros((num_pages, 64, H, dh), dtype=kp.dtype)
        vpool = torch.zeros_like(kpool)
        for b in range(B):
            for p in range(pps):
                kpool[tables[b, p]] = kp[b, p * 64:(p + 1) * 64]
                vpool[tables[b, p]] = vp[b, p * 64:(p + 1) * 64]
        dev = lambda t: t.to("cuda").contiguous()  # noqa: E731
        cases.append((name, fmt, dev(q), dev(kp), dev(vp),
                      torch.tensor(lengths, dtype=torch.int32,
                                   device="cuda"),
                      dev(kpool), dev(vpool), dev(torch.tensor(tables))))
    return cases


def check_mesh_split(torch, np, report):
    """The decode kernels at the inputs the mesh wrappers give them, on
    one card: each case split on the host into 2, 4 and 8 shards, each
    shard through the CUDA ``flash_decode`` (the sequence slice, local
    lengths clamp(len - i * s, 0, s)) and ``paged_decode`` (the pool's
    page slice, the table rewritten to pool-local ids by
    ``dispatch._local_table``, -1 elsewhere) with residuals.  Holds: each
    shard's (o, m, l) against the kernel's walk in PyTorch (the split
    twins) within 1e-6 on o, 1e-5 on m and 1e-5 relative on l, as
    ``check_flash_decode`` and ``check_paged`` hold them, and at the
    serve shape o within 1e-6 of the plain version; a row with nothing
    live in its shard exactly (0, NEG_INF, 0), no NaN anywhere; the
    port's ``_merge_partials`` (the shards stacked in rank order, as the
    gather gives them) and ``_ring_fold`` / ``_ring_finalize`` in rank
    order and in reverse within 1e-6 of the unsharded kernel.  Reports
    the byte models at each split: ``attention_hbm_bytes`` of one shard,
    ``ring_ppermute_bytes`` and ``paged_ring_ppermute_bytes``."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    rep = report["mesh"]["split"] = []
    ok = True
    worst = {"flash_decode": 0.0, "paged_decode": 0.0}
    for name, fmt, q, kp, vp, lens, kpool, vpool, tbl in _split_cases(
            torch, np, report["seed"] + 41):
        S = kp.shape[1]
        whole = {"flash_decode": FA.flash_decode(q, kp, vp, fmt, lens),
                 "paged_decode": PA.paged_decode(q, kpool, vpool, fmt, lens,
                                                 tbl)}
        for n in MESH_SHARDS:
            parts = {"flash_decode": [], "paged_decode": []}
            errs = {"flash_decode": [0.0, 0.0, 0.0],
                    "paged_decode": [0.0, 0.0, 0.0]}
            empty_ok, empties = True, 0
            s_loc, p_loc = S // n, kpool.shape[0] // n
            for i in range(n):
                sl = slice(i * s_loc, (i + 1) * s_loc)
                local = torch.clamp(lens - i * s_loc, 0, s_loc)
                ks, vs = kp[:, sl].contiguous(), vp[:, sl].contiguous()
                ltbl = dispatch._local_table(tbl, i * p_loc, p_loc)
                kps = kpool[i * p_loc:(i + 1) * p_loc]
                vps = vpool[i * p_loc:(i + 1) * p_loc]
                for kern, got, twin, plain, live in (
                        ("flash_decode",
                         FA.flash_decode(q, ks, vs, fmt, local,
                                         return_residuals=True),
                         FA.flash_decode_split_plain(
                             q, ks, vs, fmt, local, return_residuals=True),
                         FA.flash_decode_plain(q, ks, vs, fmt, local),
                         local > 0),
                        ("paged_decode",
                         PA.paged_decode(q, kps, vps, fmt, lens, ltbl,
                                         return_residuals=True),
                         PA.paged_decode_split_plain(
                             q, kps, vps, fmt, lens, ltbl,
                             return_residuals=True),
                         PA.paged_decode_plain(q, kps, vps, fmt, lens, ltbl),
                         _paged_live(torch, lens, ltbl, 64))):
                    o, m, l = got
                    e = errs[kern]
                    e[0] = max(e[0], float((o - twin[0]).abs().max()))
                    e[1] = max(e[1], float((m - twin[1]).abs().max()))
                    e[2] = max(e[2], float(((l - twin[2]).abs()
                                            / twin[2].clamp(min=1.0)).max()))
                    if name == "serve":
                        e[0] = max(e[0], float((o - plain).abs().max()))
                    dead = ~live
                    empties += int(dead.sum())
                    empty_ok &= not any(bool(torch.isnan(t).any())
                                        for t in (o, m, l))
                    empty_ok &= bool((o[dead] == 0).all()) \
                        and bool((m[dead] == FA.NEG_INF).all()) \
                        and bool((l[dead] == 0).all())
                    parts[kern].append((o, m, l))
            good = empty_ok
            # the byte models at this split: what one rank's kernel
            # streams, and what it would send a decode step under ring
            # (computed, not measured: one card passes nothing)
            Bq, Hq, Gq, dhq = q.shape
            nbytes = dict(
                shard_hbm_bytes=FA.attention_hbm_bytes(
                    Bq, s_loc, Hq, dhq, fmt, g=Gq),
                ring_send_bytes=FA.ring_ppermute_bytes(
                    Bq, S, Hq, dhq, fmt, n_devices=n),
                paged_ring_send_bytes=PA.paged_ring_ppermute_bytes(
                    kpool.shape[0], kpool.shape[1], Hq, dhq, fmt,
                    n_devices=n))
            entry = dict(case=name, shards=n, empty_rows=empties,
                         empty_exact=empty_ok, **nbytes)
            for kern in parts:
                o, m, l = (torch.stack([p[j] for p in parts[kern]])
                           for j in range(3))
                merged = dispatch._merge_partials(o, m, l)
                folded = []
                for order in (range(n), reversed(range(n))):
                    acc, m_run, l_run = dispatch._ring_state(q)
                    for i in order:
                        acc, m_run, l_run = dispatch._ring_fold(
                            acc, m_run, l_run, o[i], m[i], l[i])
                    folded.append(dispatch._ring_finalize(acc, l_run))
                comb = max(float((t - whole[kern]).abs().max())
                           for t in [merged] + folded)
                e = errs[kern]
                kgood = e[0] <= 1e-6 and e[1] <= 1e-5 and e[2] <= 1e-5 \
                    and comb <= 1e-6
                good &= kgood
                worst[kern] = max(worst[kern], e[0])
                entry[kern] = dict(o_err=e[0], m_err=e[1], l_rel_err=e[2],
                                   combined_err=comb, ok=kgood)
            entry["ok"] = good
            ok &= good
            rep.append(entry)
            fd, pd = entry["flash_decode"], entry["paged_decode"]
            print(f"[mesh] split {name} ({'e5m2' if fmt else 'f32'}) into "
                  f"{n}: flash_decode o/m/l err {fd['o_err']:.1e}/"
                  f"{fd['m_err']:.1e}/{fd['l_rel_err']:.1e}, merged and "
                  f"folded vs unsharded {fd['combined_err']:.1e}; "
                  f"paged_decode {pd['o_err']:.1e}/{pd['m_err']:.1e}/"
                  f"{pd['l_rel_err']:.1e}, combined {pd['combined_err']:.1e};"
                  f" {empties} empty shard rows exactly (0, NEG_INF, 0): "
                  f"{empty_ok}; bytes a rank streams "
                  f"{nbytes['shard_hbm_bytes']}, sends under ring "
                  f"{nbytes['ring_send_bytes']} (paged "
                  f"{nbytes['paged_ring_send_bytes']}) "
                  f"{'ok' if good else 'FAIL'}")
    # the host-split cases count under the two kernels' rows
    report["flash_decode_max_abs_err"] = max(
        report.get("flash_decode_max_abs_err", 0.0), worst["flash_decode"])
    report["paged_max_abs_err"] = max(report.get("paged_max_abs_err", 0.0),
                                      worst["paged_decode"])
    return ok


def _paged_live(torch, lens, tbl, page):
    """Rows with a live position in the table's mapped pages."""
    n_pages = tbl.shape[1]
    pos = torch.arange(n_pages * page, device=tbl.device)[None, :]
    mapped = torch.repeat_interleave(tbl >= 0, page, dim=1)
    return ((pos < lens[:, None].to(torch.int64)) & mapped).any(dim=1)


def run_mesh(torch, np, report, libs, args):
    """(a) A 1-rank NCCL process group (``tcp://localhost``, a free
    port), the (1, 1) ``("data", "model")`` mesh made ambient by
    ``use_mesh``: ``default_serving_impl`` gives
    ``flash_shmap+flash_pallas`` under it, and llama3-8b serves through
    the four wrapped spellings (``_mesh_serve``).  (b) The decode kernels
    at shard-local inputs split on the host (``check_mesh_split``).  A
    failed init fails the phase: there is no fallback."""
    import torch.distributed as dist
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod

    report["mesh"] = {}
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
        init_s = time.perf_counter() - t0
        with mesh_mod.use_mesh(mesh):
            default = dispatch.default_serving_impl("cuda")
            ok = default == "flash_shmap+flash_pallas"
            print(f"[mesh] NCCL (1, 1) mesh in {init_s:.2f} s; "
                  f"default_serving_impl under it: {default}")
            ok &= _mesh_serve(torch, report, libs, args)
    finally:
        dist.destroy_process_group()
    report["mesh"].update(default_serving_impl=default, init_s=init_s)
    ok &= check_mesh_split(torch, np, report)
    return ok


# ---------------------------------------------------------------------------
# phase train_mesh: multi-device training on a 1-rank NCCL mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3           # sharded steps held to the train phase's
MESH_COMPRESS_STEPS = 2        # then steps with binary8 + stochastic grads
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 128, 3
MOE_FWD_ARCH = "qwen3-moe-30b-a3b"
SR_FMTS = ("binary8", "binary8alt", "binary16", "binary16alt")
SR_SHAPES = ((4096, 14336), (1,), (7,), (1000003,), (333, 17))
RANK_MESHES = ((1, 2), (1, 4), (2, 4), (16, 16))
RANK_BYTES_ARCHS = ((TRAIN_ARCH, 32), (MOE_FWD_ARCH, None))
CARD_BYTES = 80e9


def _mesh_train_llama(torch, np, report, libs, args, mesh):
    """(a): the sharded step at the train phase's shape; then the
    checkpoint under the mesh; then the compressed, stochastic steps.
    Returns (ok, the gradients of one step for (d))."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.policy import get_policy
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flexfloat_cast as FF
    from repro_torch.launch import sharding
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw

    out = report["train_mesh"]
    model, cfg = _train_model()
    L = cfg.n_layers
    pol = get_policy("transprecision", decode_impl="flash_pallas")
    data = SyntheticLM(DataConfig(seed=args.seed, global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ), cfg)
    want_losses = report.get("train", {}).get("losses")
    if want_losses is None:
        # the train phase did not run: its unsharded steps, here
        gen = torch.Generator("cuda").manual_seed(report["seed"])
        params = model.init_params(gen, pol, device="cuda")
        opt = adamw.init(params, pol)
        step_fn = train_cli.make_train_step(model, pol, TRAIN_LR)
        want_losses = []
        for s in range(MESH_TRAIN_STEPS):
            loss, params, opt = step_fn(params, opt,
                                        data.batch_at(s, device="cuda"))
            want_losses.append(float(loss))
        del params, opt, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(report["seed"])
    params = model.init_params(gen, pol, device="cuda")
    shs = train_cli.shardings_for(params, pol, mesh)
    params = sharding.tree_local_blocks(params, shs[0])
    opt = adamw.init(params, pol)
    step_fn = train_cli.make_train_step(model, pol, TRAIN_LR, mesh,
                                                shs)
    want = (2 * L, 4 * L + 1)
    rows, params, opt, ok = _train_steps(
        torch, step_fn, params, opt, data, range(MESH_TRAIN_STEPS), libs,
        want=want)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in rows]
    same = losses == want_losses[:MESH_TRAIN_STEPS]
    ok &= same
    train_rows = report.get("train", {}).get("steps", [])
    print(f"[train_mesh] (a) {TRAIN_ARCH} {L} layers on the (1, 1) NCCL "
          f"mesh, sharded step: losses {losses} vs the unsharded "
          f"{want_losses[:MESH_TRAIN_STEPS]} bit for bit: {same}; peak "
          f"{peak:.2f} GB (train phase {report.get('train', {}).get('peak_gb', float('nan')):.2f}); "
          f"device ms {[round(r['device_ms'], 1) for r in rows]} (train "
          f"phase {[round(r['device_ms'], 1) for r in train_rows[:MESH_TRAIN_STEPS]]}) "
          f"{'ok' if ok else 'FAIL'}")
    out["sharded_step"] = dict(steps=rows, losses=losses,
                               unsharded_losses=want_losses, bit_equal=same,
                               peak_gb=peak, launches_per_step=dict(
                                   flash_prefill=want[0],
                                   add_rmsnorm=want[1]))
    out["flash_prefill_launches"] = sum(r["launches"]["flash_prefill"]
                                        for r in rows)

    # the gradients of the next step's batch, for (d)
    _, grads = train_cli.loss_and_grads(
        model, params, data.batch_at(MESH_TRAIN_STEPS, device="cuda"), pol)

    # a checkpoint under the mesh, restored with shardings=
    ckpt_dir = tempfile.mkdtemp(prefix="train_mesh_ckpt_")
    try:
        mgr = CheckpointManager(ckpt_dir, keep=1)
        t0 = time.perf_counter()
        mgr.save(MESH_TRAIN_STEPS - 1, (params, opt),
                 extra={"data": data.state(MESH_TRAIN_STEPS - 1)},
                 shardings=shs)
        mgr.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (p2, o2), _ = mgr.restore(MESH_TRAIN_STEPS - 1,
                                  tuple(_meta_like(torch, t)
                                        for t in (params, opt)),
                                  device="cuda", shardings=shs)
        restore_s = time.perf_counter() - t0
        bits = all(torch.equal(a, b) for a, b in zip(
            leaves((params, opt)), leaves((p2, o2))))
        del p2, o2
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ok &= bits
    out["checkpoint"] = dict(save_s=save_s, restore_s=restore_s,
                             bit_for_bit=bits)
    print(f"[train_mesh] (a) checkpoint under the mesh: save (gather, copy, "
          f"write) {save_s:.1f} s, restore with shardings= {restore_s:.1f} "
          f"s, bit for bit: {bits} {'ok' if bits else 'FAIL'}")

    # binary8 gradients with stochastic rounding: the cast kernel's main
    # path (one launch a leaf, counted per step)
    n_leaves = len(leaves(params))
    step_fn = train_cli.make_train_step(
        model, pol, TRAIN_LR, mesh, shs, compress=True,
        stochastic_seed=args.seed)
    srows = []
    for s in range(MESH_TRAIN_STEPS, MESH_TRAIN_STEPS + MESH_COMPRESS_STEPS):
        for lib in libs:
            lib.reset_counts()
        loss, params, opt = step_fn(params, opt,
                                    data.batch_at(s, device="cuda"))
        loss = float(loss)
        torch.cuda.synchronize()
        by = dict(FF.LIB.by_symbol)
        srows.append(dict(step=s, loss=loss, cast_launches=by))
    sr = sum(r["cast_launches"].get("flexfloat_cast_sr_launch", 0)
             for r in srows)
    good = sr == n_leaves * MESH_COMPRESS_STEPS and all(
        np.isfinite(r["loss"]) and r["cast_launches"].get(
            "flexfloat_cast_launch", 0) == 0 for r in srows)
    ok &= good
    out["compressed_steps"] = srows
    out["sr_launches"] = sr
    print(f"[train_mesh] (a) {MESH_COMPRESS_STEPS} steps with binary8 "
          f"stochastic gradients: losses {[r['loss'] for r in srows]}, "
          f"cast launches {[r['cast_launches'] for r in srows]} (want "
          f"{n_leaves} stochastic a step, no nearest) "
          f"{'ok' if good else 'FAIL'}")
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return ok, grads


def _mesh_train_moe(torch, np, report, libs, args, mesh):
    """(b): granite-moe at full size, binary32: the sharded step with
    ``moe_impl="shard_map"`` against the unsharded step with the dense
    dispatch, bit for bit."""
    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import sharding
    from repro_torch.launch import train as train_cli
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw

    full = configs.get(MOE_TRAIN_ARCH)
    pol = get_policy("binary32", decode_impl="flash_pallas")
    L = full.n_layers
    losses, rows_of = {}, {}
    ok = True
    for impl in ("dense", "shard_map"):
        cfg = dataclasses.replace(full, moe_impl=impl)
        model = Model(cfg)
        data = SyntheticLM(DataConfig(seed=args.seed,
                                      global_batch=MOE_TRAIN_BATCH,
                                      seq_len=MOE_TRAIN_SEQ), cfg)
        gen = torch.Generator("cuda").manual_seed(report["seed"] + 40)
        params = model.init_params(gen, pol, device="cuda")
        if impl == "dense":
            step_fn = train_cli.make_train_step(model, pol, TRAIN_LR)
        else:
            shs = train_cli.shardings_for(params, pol, mesh)
            params = sharding.tree_local_blocks(params, shs[0])
            step_fn = train_cli.make_train_step(
                model, pol, TRAIN_LR, mesh, shs)
        opt = adamw.init(params, pol)
        rows, params, opt, good = _train_steps(
            torch, step_fn, params, opt, data, range(MOE_TRAIN_STEPS), libs,
            want=(2 * L, 4 * L + 1))
        ok &= good
        losses[impl] = [r["loss"] for r in rows]
        rows_of[impl] = rows
        del params, opt, step_fn, model
        gc.collect()
        torch.cuda.empty_cache()
    same = losses["dense"] == losses["shard_map"]
    fin = all(np.isfinite(losses["shard_map"]))
    ok &= same and fin
    report["train_mesh"]["moe"] = dict(arch=MOE_TRAIN_ARCH, policy="binary32",
                                       losses=losses, bit_equal=same,
                                       steps=rows_of)
    print(f"[train_mesh] (b) {MOE_TRAIN_ARCH} full size, binary32, batch "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}: shard_map losses "
          f"{losses['shard_map']} vs dense {losses['dense']} bit for bit: "
          f"{same} {'ok' if ok else 'FAIL'}")
    return ok


def _mesh_moe_forward(torch, report, args, mesh):
    """(c): qwen3-moe at full width, a 64-row chunk and a decode step, the
    dense packed path (grouped kernels) against ``shard_map`` (every
    packed leaf dequantized, as the reference's): at full depth (48
    layers) finite logits and the launches (no grouped kernel under
    shard_map), at 2 layers (the logits phase's MoE depth) the logits
    within the transprecision bound.  Both depths' gaps are reported:
    the reference's shard_map path also dequantizes the binary32 router,
    whose product beside bf16 activations then rounds it to bf16, so
    near-tied routing choices flip and the flips compound with depth
    (ROADMAP Queue 3 item 13)."""
    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import qparams
    from repro_torch.models.transformer import Model

    policy = get_policy("transprecision", decode_impl="paged",
                        matmul_impl="qmm_pallas")
    tol = LOGIT_TOL["transprecision"]
    entry = report["train_mesh"]["moe_forward"] = dict(arch=MOE_FWD_ARCH,
                                                       tol=tol)
    ok = True
    for layers in (None, 2):
        full = configs.get(MOE_FWD_ARCH)
        if layers is not None:
            full = dataclasses.replace(full, n_layers=layers)
        L = full.n_layers
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = qparams.encode_params(
            Model(full).init_params(gen, policy, device="cuda"), policy)
        res, grouped = {}, {}
        for impl in ("dense", "shard_map"):
            cfg = dataclasses.replace(full, moe_impl=impl)
            before = sum(Q.LIB.by_kernel.get(k, 0) for k in GROUPED_KERNELS)
            with mesh_mod.use_mesh(mesh):
                res[impl] = _first_step_logits(
                    torch, Model(cfg), cfg, "transprecision", "paged",
                    "qmm_pallas", args.seed, prompt=64, page=64,
                    params=params)
            grouped[impl] = sum(Q.LIB.by_kernel.get(k, 0)
                                for k in GROUPED_KERNELS) - before
        del params
        gc.collect()
        torch.cuda.empty_cache()
        errs = [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(res["shard_map"], res["dense"])]
        good = grouped["dense"] == 4 * L and grouped["shard_map"] == 0 \
            and all(bool(torch.isfinite(t).all()) for t in res["shard_map"])
        if layers is not None:
            good &= max(errs) <= tol
        ok &= good
        entry[f"layers_{L}"] = dict(rel_errs=dict(zip(
            ("prefill chunk", "decode step"), errs)),
            held=layers is not None, grouped_launches=grouped, ok=good)
        print(f"[train_mesh] (c) {MOE_FWD_ARCH} full width, {L} layers: "
              f"shard_map vs the dense packed path max|diff|/max|logit| "
              f"(chunk, step) {', '.join(f'{e:.3e}' for e in errs)} "
              + (f"(tol {tol:g})" if layers is not None else
                 "(reported: routing flips compound with depth)")
              + f"; grouped kernel launches dense {grouped['dense']} (want "
              f"{4 * L}), shard_map {grouped['shard_map']} (want 0) "
              f"{'ok' if good else 'FAIL'}")
    return ok


def _sr_inputs(torch, gen, shape):
    """Wide-range f32 values (subnormal to overflow of every paper
    format, NaN and +/-Inf among them) and uniform 32-bit words."""
    n = 1
    for d in shape:
        n *= d
    x = torch.randn(shape, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-40, 40, shape, generator=gen, device="cuda")
        .to(torch.float32))
    flat = x.view(-1)
    flat[: min(n, 3)] = torch.tensor([float("nan"), float("inf"),
                                      -float("inf")][: min(n, 3)],
                                     device="cuda")
    bits = torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         generator=gen, device="cuda")
    return x, bits


def _mesh_stochastic(torch, np, report, timer, mesh, grads):
    """(d): the stochastic cast kernel bit for bit its plain version, its
    time; the three compressed reductions over step (a)'s gradients."""
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flexfloat_cast as FF
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import grad_compress as GC

    gen = torch.Generator(device="cuda").manual_seed(report["seed"] + 41)
    ok = True
    worst = 0.0
    cases = []
    for shape in SR_SHAPES:
        x, bits = _sr_inputs(torch, gen, shape)
        for name in SR_FMTS:
            got = FF.flexfloat_cast(x, name, rbits=bits)
            want = FF.flexfloat_cast_plain(x, name, rbits=bits)
            same = torch.equal(got.view(torch.int32),
                               want.view(torch.int32))
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) \
                if bool(fin.any()) else 0.0
            worst = max(worst, err)
            rne = torch.equal(got.view(torch.int32), FF.flexfloat_cast(
                x, name).view(torch.int32))
            good = same and (not rne or x.numel() < 16)
            ok &= good
            cases.append(dict(shape=list(shape), fmt=name, bit_for_bit=same,
                              max_abs_err=err, equals_nearest=rne))
        del x, bits
    report["flexfloat_cast_sr_max_abs_err"] = worst if ok else None
    report["train_mesh"]["sr_cases"] = cases
    print(f"[train_mesh] (d) stochastic cast kernel vs its plain version, "
          f"{len(cases)} cases (shapes {list(SR_SHAPES)} x {SR_FMTS}): "
          f"all bit for bit {all(c['bit_for_bit'] for c in cases)}, none "
          f"equal to nearest rounding on the large shapes "
          f"{'ok' if ok else 'FAIL'}")

    x, bits = _sr_inputs(torch, gen, (4096, 14336))
    n = x.numel()
    for name in ("binary8", "binary16alt"):
        t_k = timer(lambda: FF.flexfloat_cast(x, name, rbits=bits))
        t_p = timer(lambda: FF.flexfloat_cast_plain(x, name, rbits=bits),
                    iters=3, warmup=1)
        nbytes = n * 12
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="flexfloat_cast_sr", fmt=name, shape=[4096, 14336],
            ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=bound,
            bound_by="bytes", bytes=nbytes))
        print(f"[timing] flexfloat_cast_sr {name:<11} 4096x14336 kernel "
              f"{t_k:.4f} ms  plain {t_p:.4f} ms  library none  bound "
              f"{bound:.4f} ms")
    del x, bits

    # the compressed reductions over step (a)'s gradients on the 1-rank
    # mesh (no collective runs over a dim of one rank)
    gl = leaves(grads)
    wire = dict(psum=0, allgather=0)
    same = dict(psum=True, allgather=True, tree=True)
    with mesh_mod.use_mesh(mesh):
        for g in gl:
            payload, res = GC.compress(g, None)
            want = GC.decompress(payload)
            for what, fn in (("psum", GC.compressed_psum),
                             ("allgather", GC.compressed_allgather_sum)):
                s, r = fn(g, None, ("data",))
                same[what] &= torch.equal(s.view(torch.int32),
                                          want.view(torch.int32)) \
                    and torch.equal(r.view(torch.int32),
                                    res.view(torch.int32))
            wire["psum"] += g.numel() * 4
            wire["allgather"] += payload.numel() * payload.element_size()
            del payload, res, want
        tree, _ = GC.tree_compress_psum(grads, None, "data")
        for g, s in zip(gl, leaves(tree)):
            want = GC.decompress(GC.compress(g, None)[0])
            same["tree"] &= torch.equal(s.view(torch.int32),
                                        want.view(torch.int32))
        del tree
    good = all(same.values())
    ok &= good
    report["train_mesh"]["compressed"] = dict(bit_for_bit=same,
                                              wire_bytes=wire,
                                              leaves=len(gl))
    print(f"[train_mesh] (d) compressed_psum / compressed_allgather_sum / "
          f"tree_compress_psum over {len(gl)} gradient leaves on the "
          f"1-rank mesh, bit "
          f"for bit decompress(compress(g)): {same}; wire bytes a rank: "
          f"f32 psum {wire['psum']:,}, uint8 all-gather "
          f"{wire['allgather']:,} {'ok' if good else 'FAIL'}")
    return ok


def rank_bytes(torch, arch, layers):
    """Params + AdamW state one rank stores under each of
    ``RANK_MESHES`` (transprecision), from the rules on ``meta``
    tensors; and the whole tree's bytes, which the port's storage-only
    step also gathers on every rank for the compute."""
    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import sharding
    from repro_torch.launch import train as train_cli
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw

    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    pol = get_policy("transprecision")
    params = Model(cfg).init_params(torch.Generator(), pol, device="meta")
    opt = adamw.init(params, pol)
    one = sharding.MeshShape(("data", "model"), (1, 1))
    p1, o1 = train_cli.shardings_for(params, pol, one)
    out = dict(arch=arch, layers=cfg.n_layers,
               params_bytes=sharding.tree_block_bytes(params, p1),
               opt_bytes=sharding.tree_block_bytes(opt, o1), per_rank={})
    for shape in RANK_MESHES:
        mesh = sharding.MeshShape(("data", "model"), shape)
        ps, os_ = train_cli.shardings_for(params, pol, mesh)
        out["per_rank"]["x".join(map(str, shape))] = dict(
            params=sharding.tree_block_bytes(params, ps),
            opt=sharding.tree_block_bytes(opt, os_))
    return out


def _mesh_rank_bytes(torch, report):
    """(e): per-rank bytes of params + AdamW state."""
    rows = []
    for arch, layers in RANK_BYTES_ARCHS:
        r = rank_bytes(torch, arch, layers)
        rows.append(r)
        stored = {k: (v["params"] + v["opt"]) / 1e9
                  for k, v in r["per_rank"].items()}
        gathered = r["params_bytes"] / 1e9
        print(f"[train_mesh] (e) {arch} ({r['layers']} layers): params "
              f"{r['params_bytes'] / 1e9:.2f} GB + AdamW "
              f"{r['opt_bytes'] / 1e9:.2f} GB in all; stored a rank "
              + ", ".join(f"{k} {v:.2f} GB" for k, v in stored.items())
              + f"; the storage-only step also gathers {gathered:.2f} GB of "
              f"params and holds as many gradient bytes a rank")
    llama = rows[0]
    four = llama["per_rank"]["1x4"]
    need = (four["params"] + four["opt"] + 2 * llama["params_bytes"]) / 1e9
    fits = need * 1e9 < CARD_BYTES
    report["train_mesh"]["rank_bytes"] = dict(rows=rows, llama_1x4_need_gb=need,
                                              llama_fits_four=fits)
    print(f"[train_mesh] (e) {TRAIN_ARCH} at 32 layers on four cards (1, 4): "
          f"{need:.2f} GB a rank before activations (stored blocks + "
          f"gathered params + full gradients) of {CARD_BYTES / 1e9:.0f} GB: "
          f"{'fits' if fits else 'does not fit'}")
    return all(v["params"] > 0 for r in rows for v in r["per_rank"].values())


def run_train_mesh(torch, np, report, libs, args, timer):
    """Multi-device training on a 1-rank NCCL mesh (``tcp://localhost``,
    a free port; its own group, the mesh phase's destroyed before): (a)
    the sharded step, its checkpoint and its compressed stochastic
    gradients; (b) the expert-parallel MoE's training steps; (c) the
    expert-parallel MoE's forward at qwen3-moe's size; (d) the stochastic
    cast kernel and the compressed reductions; (e) per-rank bytes.  A
    failed init fails the phase: there is no fallback."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod

    report["train_mesh"] = {}
    secs = report["train_mesh"]["seconds"] = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
        t0 = time.perf_counter()
        ok, grads = _mesh_train_llama(torch, np, report, libs, args, mesh)
        secs["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok &= _mesh_stochastic(torch, np, report, timer, mesh, grads)
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        secs["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok &= _mesh_train_moe(torch, np, report, libs, args, mesh)
        secs["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok &= _mesh_moe_forward(torch, report, args, mesh)
        secs["c"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    ok &= _mesh_rank_bytes(torch, report)
    secs["e"] = time.perf_counter() - t0
    print("[train_mesh] seconds: " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in secs.items()))
    return ok


# ---------------------------------------------------------------------------
# rwkv_fused: the reference's fused token-shift experiment at full width
# ---------------------------------------------------------------------------

FUSED_ARCH, FUSED_LABEL = "rwkv6-1.6b", "rwkv6-1.6b+fused"
FUSED_SET = ("--set", "rwkv_fused=1")
FUSED_TRAIN_LAYERS, FUSED_TRAIN_BATCH, FUSED_TRAIN_SEQ = 4, 2, 128


def fused_cfg():
    """rwkv6-1.6b with ``rwkv_fused=1``: its five token-shift projections
    one product (``wrkvg``, 2048 x 8256), its channel mix's two one
    (``cm_kr``, 2048 x 9216)."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(FUSED_ARCH), rwkv_fused=1)


def _step_profile(torch, argv, params):
    """One steady decode step of ``serve.main(argv, params=params)`` under
    torch.profiler: wall and device ms, device activities, and the device
    time and launches of the cast kernel's ``decode_kernel`` (the
    dequantize) and of the library's GEMM / GEMV kernels (the plain
    ``torch.matmul`` products: the decay LoRA's, and the fused path's
    ``dxx @ wm``)."""
    busy, wall, top, _, rows = _profiled_serve(torch, argv, window=1,
                                               params=params)
    ev = device_rows(rows)

    def part(pick):
        sel = [e for e in ev if pick(e.key.lower())]
        return sum(e.count for e in sel), sum(_dev_us(e) for e in sel) / 1e3
    dq_n, dq_ms = part(lambda k: "decode_kernel" in k)
    # the library's products: cuBLAS GEMM and GEMV kernels, not qmm's
    mm_n, mm_ms = part(lambda k: ("gemm" in k or "gemv" in k)
                       and "qmm" not in k)
    return dict(wall_ms=wall * 1e3, device_ms=busy * 1e3,
                busy_share=busy / wall, activities=sum(e.count for e in ev),
                dequantize_launches=dq_n, dequantize_ms=dq_ms,
                gemm_launches=mm_n, gemm_ms=mm_ms, top=top[:5])


def time_fused_pieces(torch, report, timer, params, cfg):
    """What the fused path adds to a rwkv6 step, at full width on the
    served packed leaves of layer 0 (binary16alt): ``dequantize_decode``
    of ``wrkvg`` (2048 x 8256) and ``cm_kr`` (2048 x 9216) held bit for
    bit to its plain version and to ``.view(bfloat16).float()`` and timed
    beside both and its byte bound; the derived weight (``as_array``,
    the mixer broadcast, the product and the bf16 rounding:
    ``rwkv6._mix_scaled``); and the plain product ``dxx @ wm`` at a
    decode step's 2 rows and a chunk's 64 (``pdot``: bf16 operands in
    f32, ``torch.matmul``).  A step runs each once a layer per leaf."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flexfloat_cast as FF
    from repro_torch.models import layers, rwkv6

    pol = get_policy("transprecision", matmul_impl="qmm_pallas")
    mix = params["layers"][0]["mix"]
    d, ff = cfg.d_model, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(report["seed"] + 41)
    ok, out = True, {}
    for leaf, m, widths, role in (
            ("wrkvg", mix["mu"], (d, d, d, d, RWKV_RANK), "attn_w"),
            ("cm_kr", mix["cm_mu"], (ff, d), "ffn_w")):
        w = mix[leaf]
        p, fmt = w.payload, w.fmt
        got = FF.dequantize_decode(p, fmt)
        same = torch.equal(got, FF.dequantize_decode_plain(p, fmt)) and \
            torch.equal(got, p.view(torch.bfloat16).float())
        ok &= same
        n = p.numel()
        nbytes = FF.elementwise_hbm_bytes(n, fmt.container_bytes, 4)
        t_k = timer(lambda: FF.dequantize_decode(p, fmt))
        t_p = timer(lambda: FF.dequantize_decode_plain(p, fmt), iters=3,
                    warmup=1)
        t_l = timer(lambda: p.view(torch.bfloat16).float())
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(
            kernel="dequantize_decode_fused", leaf=leaf, fmt=fmt.name,
            shape=list(p.shape), ms=t_k, plain_ms=t_p, library_ms=t_l,
            bound_ms=bound, bound_by="bytes", bytes=nbytes,
            max_abs_err=0.0 if same else None))
        dt = pol.dtype(role)
        t_wm = timer(lambda: rwkv6._mix_scaled(w, m, widths, dt))
        wm = rwkv6._mix_scaled(w, m, widths, dt)
        prods = {}
        for rows in (ARCH_SLOTS, ARCH_PAGE):
            dxx = torch.randn((rows, d), generator=g, device="cuda").to(
                pol.dtype("act"))
            prods[rows] = timer(lambda: layers.pdot(dxx, wm, pol, role,
                                                    out_act=False))
        out[leaf] = dict(shape=list(p.shape), dequantize_ms=t_k,
                         dequantize_plain_ms=t_p, view_float_ms=t_l,
                         dequantize_bound_ms=bound, bit_exact=same,
                         derived_weight_ms=t_wm,
                         product_ms={str(k): v for k, v in prods.items()})
        print(f"[rwkv_fused] {leaf} {tuple(p.shape)} binary16alt: "
              f"dequantize_decode {t_k:.4f} ms (plain {t_p:.3f} ms, "
              f".view(bfloat16).float() {t_l:.4f} ms, bound {bound:.4f} "
              f"ms), bit for bit both {same}; the derived weight m * W "
              f"{t_wm:.4f} ms; dxx @ wm at {ARCH_SLOTS} rows "
              f"{prods[ARCH_SLOTS]:.4f} ms, at {ARCH_PAGE} rows "
              f"{prods[ARCH_PAGE]:.4f} ms {'ok' if same else 'FAIL'}")
        del got, wm
    L = cfg.n_layers
    step = L * sum(v["derived_weight_ms"] + v["product_ms"][str(ARCH_SLOTS)]
                   for v in out.values())
    out["per_decode_step_ms"] = step
    print(f"[rwkv_fused] the derived weights and their products, {L} "
          f"layers: {step:.3f} ms a decode step (dequantize included)")
    report["rwkv_fused"]["pieces"] = out
    torch.cuda.empty_cache()
    return ok


def _fused_train(torch, np, report, args):
    """One training step of the fused config at full width and
    ``FUSED_TRAIN_LAYERS`` layers (transprecision, batch 2 x 128,
    ``launch/train.make_train_step``): a finite loss, and ``wrkvg`` and
    ``cm_kr`` moved by the update (the gradient reaches both terms)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(fused_cfg(), n_layers=FUSED_TRAIN_LAYERS)
    model, pol = Model(cfg), get_policy("transprecision")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, pol, device="cuda")
    before = {k: params["layers"][0]["mix"][k].clone()
              for k in ("wrkvg", "cm_kr")}
    opt = adamw.init(params, pol)
    step = make_train_step(model, pol, TRAIN_LR)
    data = SyntheticLM(DataConfig(global_batch=FUSED_TRAIN_BATCH,
                                  seq_len=FUSED_TRAIN_SEQ), cfg)
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    loss, params, opt = step(params, opt, data.batch_at(0, device="cuda"))
    b.record()
    loss = float(loss)
    torch.cuda.synchronize()
    moved = {k: float((params["layers"][0]["mix"][k].float()
                       != v.float()).float().mean())
             for k, v in before.items()}
    ok = bool(np.isfinite(loss)) and all(f > 0.5 for f in moved.values())
    report["rwkv_fused"]["train"] = dict(
        layers=FUSED_TRAIN_LAYERS, batch=FUSED_TRAIN_BATCH,
        seq=FUSED_TRAIN_SEQ, loss=loss, device_ms=a.elapsed_time(b),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        share_moved=moved, ok=ok)
    print(f"[rwkv_fused] train: {FUSED_TRAIN_LAYERS} layers, full width, "
          f"batch {FUSED_TRAIN_BATCH} x {FUSED_TRAIN_SEQ}, transprecision: "
          f"loss {loss:.6f}, device {a.elapsed_time(b):.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; share of "
          f"elements the step moved {moved} (want finite, > 0.5) "
          f"{'ok' if ok else 'FAIL'}")
    del params, opt, before
    torch.cuda.empty_cache()
    return ok


def run_rwkv_fused(torch, np, report, libs, args, timer):
    """rwkv6-1.6b with ``rwkv_fused=1`` (the reference's experiment: five
    token-shift projections in one product, the channel mix's two in
    one) at full width and depth, random weights from ``--seed``:
    ``serve.main(["--set", "rwkv_fused=1", ...])`` under transprecision,
    ``qmm_pallas`` and ``flash_pallas``, 2 x (100 + 8) in chunks of 64 +
    36 (the archs phase's checks, :func:`_arch_serve`): 97 ``qmm_tc`` a
    decode step or chunk (wrkvg, wo, cm_kr, cm_v a layer and the head),
    48 ``dequantize_decode`` (``as_array`` of wrkvg and cm_kr), 48 plain
    ``dxx @ wm`` products and 49 ``add_layernorm``; tok/s, TTFT, peak
    memory.  One profiled steady decode step of the fused config and of
    the unfused one, in turn (device ms, activities, the dequantize
    kernel's and the GEMMs' device time); the pieces the fused path adds
    (:func:`time_fused_pieces`); the logits at 2 layers, kernel route
    against the plain route (:func:`recurrent_logit_checks`); and one
    training step at 4 layers (:func:`_fused_train`)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    gc.collect()
    torch.cuda.empty_cache()
    out = report["rwkv_fused"] = {}
    secs = {}
    t0 = time.perf_counter()
    cfg = fused_cfg()
    policy = get_policy("transprecision", decode_impl="flash_pallas",
                        matmul_impl="qmm_pallas")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = Model(cfg).init_params(gen, policy, device="cuda")
    init_peak = torch.cuda.max_memory_allocated()
    ok, entry = _arch_serve(torch, report, libs, args, FUSED_ARCH,
                            "flash_pallas", params, cfg, extra=FUSED_SET,
                            label="rwkv6-fused")
    entry["init_peak_mem_bytes"] = init_peak
    out["serve"] = entry
    secs["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    from repro_torch.models import qparams
    ok &= time_fused_pieces(torch, report, timer,
                            qparams.encode_params(params, policy), cfg)
    argv = ["--arch", FUSED_ARCH, "--policy", "transprecision",
            "--decode-impl", "flash_pallas", "--matmul-impl", "qmm_pallas",
            "--page-size", str(ARCH_PAGE), "--requests", str(ARCH_REQUESTS),
            "--slots", str(ARCH_SLOTS), "--prompt-len",
            str(RECURRENT_PROMPT), "--max-new", "4", "--capacity",
            str(arch_capacity(cfg)), "--seed", str(args.seed)]
    steps = out["steps"] = {}
    steps["fused"] = _step_profile(torch, [*FUSED_SET, *argv], params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    model, ucfg = build(FUSED_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, policy, device="cuda")
    steps["unfused"] = _step_profile(torch, argv, params)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    # the counted serve holds the launches; the profile shows the kernel
    # ran (it may drop an event at the window's start: 47 of 48 seen)
    for k, st in steps.items():
        good = (st["dequantize_launches"] > 0) == (k == "fused")
        ok &= good
        print(f"[rwkv_fused] one steady decode step, {k}: wall "
              f"{st['wall_ms']:.1f} ms, device {st['device_ms']:.2f} ms "
              f"({100 * st['busy_share']:.1f} %), {st['activities']} device "
              f"activities; dequantize {st['dequantize_launches']} launches "
              f"(launched {fused_dense(cfg) if k == 'fused' else 0}) "
              f"{st['dequantize_ms']:.3f} ms; GEMMs {st['gemm_launches']} "
              f"launches {st['gemm_ms']:.3f} ms {'ok' if good else 'FAIL'}")
    secs["profile"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ok &= recurrent_logit_checks(torch, report, args, FUSED_LABEL,
                                 dataclasses.replace(cfg, n_layers=2))
    secs["logits"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok &= _fused_train(torch, np, report, args)
    secs["train"] = time.perf_counter() - t0
    out["seconds"] = secs
    print("[rwkv_fused] seconds: " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in secs.items()))
    return ok


# ---------------------------------------------------------------------------
# dryrun: the compile-only tooling on the host, and one cell on the card
# ---------------------------------------------------------------------------

DRYRUN_TIMEOUT_S = 400           # the most the dryrun phase waits
CROSS_ARCH, CROSS_SHAPE = "llama3-8b", "decode_32k"
# the card cross-check's tolerances, stated before its first run: the
# bytes the arguments take on the card within 1 % of the cell's
# gathered_argument_bytes (the allocator rounds each tensor up to 512
# bytes); the device time of the rank's decode step between 0.8 and 3 x
# the cell's t_memory_s (a roofline term is a lower bound at the
# data-sheet rate; 0.8 leaves room for L2 hits of the counted bytes)
CROSS_BYTES_TOL, CROSS_TIME_RANGE = 0.01, (0.8, 3.0)


# one sweep job: run launch/dryrun.main once for each of its shapes
_SWEEP_JOB = r"""
import sys
from repro_torch.launch import dryrun
arch, out, shapes, extra = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
for shape in shapes.split(","):
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                 "--out", out, *extra])
"""


def start_sweep(report, out_dir):
    """Start the single-mesh sweep (10 configs x 4 shapes) and rwkv6's
    train_4k with ``--set rwkv_fused=1`` through ``launch/dryrun.main``:
    a config's train cell in a job of its own (the longest), its other
    shapes in another, every job a host process at the lowest priority
    (``nice`` 19: it takes only the cores the phases leave idle) with no
    card (``CUDA_VISIBLE_DEVICES`` empty), all started at once;
    :func:`finish_sweep` waits for them."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES

    os.makedirs(out_dir, exist_ok=True)
    for fn in os.listdir(out_dir):
        if fn.endswith(".json"):
            os.remove(os.path.join(out_dir, fn))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=report["src"], OMP_NUM_THREADS="1")
    rest = ",".join(s for s in SHAPES if s != "train_4k")
    jobs = [(FUSED_ARCH, "train_4k", "--set", "rwkv_fused=1", "--tag",
             "fused")]
    jobs += [(a, "train_4k") for a in configs.ARCHS]
    jobs += [(a, rest) for a in configs.ARCHS]
    log = open(os.path.join(out_dir, "sweep.log"), "w")
    procs = [subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-c", _SWEEP_JOB, a, out_dir,
         shapes, *extra], env=env, stdout=log, stderr=subprocess.STDOUT)
        for a, shapes, *extra in jobs]
    return dict(procs=procs, log=log, out_dir=out_dir,
                t0=time.perf_counter())


def stop_sweep(job) -> None:
    """Kill what is left of a sweep and close its log."""
    for p in job["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()
    job["log"].close()


def finish_sweep(job):
    """Wait (at most ``DRYRUN_TIMEOUT_S``) for :func:`start_sweep`'s jobs;
    returns (the cells, the jobs' exit codes, seconds from their start to
    this call's end, seconds this call waited)."""
    t0 = time.perf_counter()
    try:
        for p in job["procs"]:
            p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    finally:
        stop_sweep(job)
    waited = time.perf_counter() - t0
    cells = {}
    out_dir = job["out_dir"]
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                cells[fn[:-5]] = json.load(f)
    return (cells, [p.returncode for p in job["procs"]],
            time.perf_counter() - job["t0"], waited)


def _cross_check(torch, report, cell, args):
    """``CROSS_ARCH`` ``CROSS_SHAPE`` at one rank's share on the card:
    rank 0 of the single mesh decodes 8 of the 128 rows over a
    32768-row e5m2 cache, with the whole model's weights (the step
    gathers them): the model's weights and the 8 rows' caches made on
    the card (transprecision, the cell's plain ``xla`` spellings), their
    bytes against the cell's ``gathered_argument_bytes``, and one decode
    step's device time (CUDA events, median of 3 after one warm-up,
    each step on the same inputs) against its ``t_memory_s``."""
    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.models.attention import KVCache
    from repro_torch.models.transformer import Model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get(CROSS_ARCH)
    want = cell["memory"]["gathered_argument_bytes"]
    B = 128 // cell["mesh_shape"]["data"]
    S = 32768
    model, pol = Model(cfg), get_policy("transprecision")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, pol, device="cuda")
    states = [s._replace(pos=S - 1) if isinstance(s, KVCache) else s
              for s in model.init_state(B, S, pol, device="cuda")]
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    times = []
    for i in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, new = model.decode_step(params, tokens, states, pol)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
        finite = bool(torch.isfinite(logits.float()).all())
        del logits, new
    times.sort()
    ms = times[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() - base
    t_mem = cell["roofline"]["t_memory_s"] * 1e3
    bytes_ok = abs(held - want) <= CROSS_BYTES_TOL * want
    lo, hi = CROSS_TIME_RANGE
    time_ok = lo * t_mem <= ms <= hi * t_mem
    ok = bytes_ok and time_ok and finite
    report["dryrun"]["cross_check"] = dict(
        arch=CROSS_ARCH, shape=CROSS_SHAPE, rows=B, cache_rows=S,
        held_bytes=held, gathered_argument_bytes=want,
        argument_size_in_bytes=cell["memory"]["argument_size_in_bytes"],
        bytes_ratio=held / want, bytes_tol=CROSS_BYTES_TOL,
        device_ms=ms, device_ms_all=times, t_memory_ms=t_mem,
        time_ratio=ms / t_mem, time_range=CROSS_TIME_RANGE,
        bytes_per_device=cell["bytes_per_device"], peak_bytes=peak,
        logits_finite=finite, ok=ok)
    print(f"[dryrun] card cross-check {CROSS_ARCH} {CROSS_SHAPE} at rank "
          f"0's share ({B} rows x {S} cached, transprecision, xla): held "
          f"{held / 1e9:.3f} GB against the cell's gathered arguments "
          f"{want / 1e9:.3f} GB (ratio {held / want:.4f}, tol +-"
          f"{CROSS_BYTES_TOL:.0%}; its blocks by the rules "
          f"{cell['memory']['argument_size_in_bytes'] / 1e9:.3f} GB); "
          f"decode step {ms:.2f} ms device (steps {times}) against "
          f"t_memory {t_mem:.2f} ms (ratio {ms / t_mem:.3f}, want "
          f"{lo}-{hi}); peak {peak / 1e9:.2f} GB; logits finite {finite} "
          f"({report['nvidia_smi']}) {'ok' if ok else 'FAIL'}")
    del params, states, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def run_dryrun(torch, report, args, sweep):
    """The compile-only tooling (``launch/dryrun.py``, ``report.py``,
    ``hlo_analysis.py``): (a) the single-mesh sweep on the host (10
    configs x 4 shapes on ``meta`` tensors, no kernel launched): 40
    cells, 32 ok and the 8 ``long_500k`` cells of the quadratic configs
    skipped, none in error; (b) rwkv6-1.6b's train_4k with and without
    ``--set rwkv_fused=1``: 5 all-gathers fewer a layer (wr, wk, wv, wg,
    wd1 -> wrkvg; cm_k, cm_r -> cm_kr); the report's tables rendered to
    ``dryrun_report.md``; (c) the card cross-check
    (:func:`_cross_check`)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, SUBQUADRATIC
    from repro_torch.launch import report as rep

    out = report["dryrun"] = {}
    cells, rcs, secs, waited = finish_sweep(sweep)
    out_dir = sweep["out_dir"]
    single = {k: v for k, v in cells.items() if not v.get("tag")}
    status = [v["status"] for v in single.values()]
    skipped = sorted((v["arch"], v["shape"]) for v in single.values()
                     if v["status"] == "skipped")
    want_skip = sorted((a, "long_500k") for a in configs.ARCHS
                       if a not in SUBQUADRATIC)
    ok = (len(single) == len(configs.ARCHS) * len(SHAPES)
          and status.count("ok") == 32 and skipped == want_skip
          and "error" not in status and all(rc == 0 for rc in rcs))
    fused = next(v for v in cells.values() if v.get("tag") == "fused")
    plain = single[f"{FUSED_ARCH}__train_4k__single__transprecision"]
    ag = [c["collectives"]["all-gather"]["count"] for c in (plain, fused)]
    L = fused_cfg().n_layers
    fewer = ag[0] - ag[1] == 5 * L
    ok &= fewer
    with open(os.path.join(args.out, "dryrun_report.md"), "w") as f:
        f.write(rep.render(out_dir))
    roof = {f"{v['arch']} {v['shape']}": dict(
        dominant=v["roofline"]["dominant"],
        bound_s=v["roofline"]["bound_step_time_s"],
        t_compute_s=v["roofline"]["t_compute_s"],
        t_memory_s=v["roofline"]["t_memory_s"],
        t_collective_s=v["roofline"]["t_collective_s"],
        useful=v["roofline"]["useful_flops_ratio"],
        model_flops=v["roofline"]["model_flops"], run_s=v["run_s"])
        for v in single.values() if v["status"] == "ok"}
    out.update(cells=len(single), ok_cells=status.count("ok"),
               skipped=skipped, rcs=rcs, seconds=secs, waited_s=waited,
               rwkv_train_all_gathers=dict(unfused=ag[0], fused=ag[1]),
               rwkv_train_flops=dict(unfused=plain["flops_per_device"],
                                     fused=fused["flops_per_device"]),
               rooflines=roof)
    print(f"[dryrun] single-mesh sweep on the host: {len(rcs)} jobs read "
          f"{secs:.1f} s after their start, this phase waited {waited:.1f} "
          f"s for them: {len(single)} cells, "
          f"{status.count('ok')} ok, skipped {len(skipped)} "
          f"(want the 8 long_500k of the quadratic configs: "
          f"{skipped == want_skip}), errors {status.count('error')}, exit "
          f"codes {rcs}; rwkv6 train_4k all-gathers {ag[0]} -> {ag[1]} "
          f"with rwkv_fused=1 (want {5 * L} fewer) "
          f"{'ok' if ok else 'FAIL'}")
    for k, r in sorted(roof.items()):
        print(f"[dryrun] {k:<34} {r['dominant']:<10} bound "
              f"{r['bound_s']:.4g} s (compute {r['t_compute_s']:.4g}, "
              f"memory {r['t_memory_s']:.4g}, collective "
              f"{r['t_collective_s']:.4g}); model/counted flops "
              f"{r['useful']:.4f}")
    cell = single.get(f"{CROSS_ARCH}__{CROSS_SHAPE}__single__transprecision")
    ok &= cell is not None and _cross_check(torch, report, cell, args)
    return ok


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

ALL_PHASES = ("build", "kernels", "casts", "ops", "serve", "serve_flash",
              "speculative", "serve_f32", "serve_reduced", "logits",
              "resilience", "archs", "encdec", "train", "prefill_cont",
              "paper", "serve_tune", "tune_archs", "mesh", "train_mesh",
              "rwkv_fused", "dryrun", "profile")


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
    ``add_rmsnorm``, ``rmsnorm`` and ``add_layernorm`` are port-only
    kernels (their ``replaces`` names the reference's XLA norm): times at
    a decode step's 4 rows; launches of the serve phase (every norm
    fused), of the serve_reduced phase's tuned-artifact serve (binary8
    activations: the three-step route's ``rmsnorm_launch``) and of the
    archs phase's command-r-35b serve (every norm fused;
    ``layernorm_launch``, the three-step route's, runs on no served path
    and is held and timed in the resilience phase).  paligemma-3b's
    shapes have rows of their own, launches from its archs serves:
    ``qmm_tc_gelu`` (the gated gelu FFN, its whole prompt's 320 rows)
    and ``qmm_tc_gelu_decode_step`` (2 rows), ``flash_prefill_prefix``
    (the 256-row prefix, MQA), ``flash_decode_mqa`` and
    ``paged_decode_mqa`` (H 1, G 8, dh 256).  whisper-tiny's shapes have
    rows of their own, launches from the encdec phase's
    ``synchronous_generate`` runs under flash_pallas and paged:
    ``qmm_tc_whisper`` (a whole-prompt prefill's 65 products) and
    ``qmm_tc_whisper_decode_step``, ``flash_prefill_whisper`` (the 64-row
    prompt on f32 K/V), ``flash_decode_whisper``, ``paged_decode_whisper``
    (one slot, 72 of 128 rows) and ``add_layernorm_d384`` (one row).
    Training's shapes, launches from the train phase's 8 steps:
    ``flash_prefill_train`` (B 8, Sq = Skv 128, H 8, G 4, dh 128, f32
    K/V, causal; its forward and the remat recompute) and
    ``add_rmsnorm_train`` (1024 rows, d 4096); the fused rwkv6's
    (``rwkv_fused=1``), launches from the rwkv_fused phase's serve:
    ``qmm_tc_rwkv6_fused`` and ``qmm_tc_rwkv6_fused_decode_step``, and
    ``dequantize_decode_wrkvg`` / ``dequantize_decode_cm_kr`` (2048 x 8256
    and 2048 x 9216, binary16alt); and ``flash_prefill_cont``
    (64 rows at q_offset 64 over a 128-row e5m2 cache), the prefill_cont
    phase's launch.  The
    MoE expert product's two
    calls, timed at qwen3-moe's 2-token routing (E 128, C 8) with the
    archs phase's qwen3-moe serve's launches: ``qmm_tc_grouped_ffn``,
    the gated pair (K 2048, N 768), and ``qmm_tc_grouped``, w_out (K
    768, N 2048).  (One qwen3 expert launch on ``qmm_tc``, the
    reference's unrolled scheme, is still timed into the report as
    ``qmm_tc_expert``, but no longer runs on the main path.)"""
    def timing(name, **match):
        return next((t for t in report["timings"] if t["kernel"] == name
                     and all(t.get(k) == v for k, v in match.items())), None)

    serve = report.get("serve", {}).get("launches", {})
    artifact = report.get("serve_artifact", {}).get("launches", {})
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
    qwen3_grouped = archs.get("qwen3-moe-30b-a3b/flash_pallas", {}).get(
        "grouped_by_kernel", {})
    rwkv = archs.get("rwkv6-1.6b/flash_pallas", {})
    fused = report.get("rwkv_fused", {}).get("serve", {})
    # the fused serve's dequantize launches: one wrkvg and one cm_kr a
    # layer a call
    fused_dq = fused.get("launches", {}).get("flexfloat_cast", 0) // 2
    rg = archs.get("recurrentgemma-2b/flash_pallas", {})
    rg_paged = archs.get("recurrentgemma-2b/paged", {})

    def tc_launches(entry, what):
        """A config's archs serve's qmm_tc launches in its decode steps
        or its prefill calls."""
        per = entry.get(f"qmm_kernels_per_{what}", [])
        calls = entry.get("decode_steps" if what == "decode_step"
                          else "prefill_chunks", 0)
        return per[0][QMM_KERNELS.index("qmm_tc")] * calls \
            if len(per) == 1 else 0

    def norm_launches(entry, entry_name):
        return entry.get("launches", {}).get("norms_by_entry", {}).get(
            entry_name, 0)
    pali = archs.get("paligemma-3b/flash_pallas", {})
    pali_paged = archs.get("paligemma-3b/paged", {})
    whisper = list(report.get("encdec", {}).get("serve", {}).values())
    pali_ffn = pali.get("qmm_ffn_rows", {})
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
        # the cast kernel with stochastic rounding (the reference's is
        # XLA arithmetic in quantize_tile, not a Pallas body); launches
        # of train_mesh's compressed-gradient steps
        ("flexfloat_cast_sr", ff_src, "src/repro/kernels/codec.py:93",
         report.get("train_mesh", {}).get("sr_launches", 0),
         report.get("flexfloat_cast_sr_max_abs_err"),
         timing("flexfloat_cast_sr", fmt="binary8")),
        ("quantize_encode", ff_src,
         "src/repro/kernels/flexfloat_cast.py:37",
         ops_counts.get("quantize_encode_launch", 0), cast_err,
         timing("quantize_encode", fmt="binary16alt")),
        ("dequantize_decode", ff_src,
         "src/repro/kernels/flexfloat_cast.py:42",
         ops_counts.get("dequantize_decode_launch", 0), cast_err,
         timing("dequantize_decode", fmt="binary16alt")),
        # port-only: the reference's rmsnorm is XLA, not a TPU kernel
        ("add_rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:221",
         serve.get("norms_by_entry", {}).get("add_rmsnorm_launch", 0),
         report.get("add_rmsnorm_max_abs_err"),
         timing("add_rmsnorm", rows=4)),
        ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:221",
         artifact.get("norms_by_entry", {}).get("rmsnorm_launch", 0),
         report.get("rmsnorm_max_abs_err"), timing("rmsnorm", rows=4)),
        # port-only, as rmsnorm: the reference's layernorm is XLA
        ("add_layernorm", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:228",
         archs.get("command-r-35b/flash_pallas", {}).get("launches", {})
         .get("norms_by_entry", {}).get("add_layernorm_launch", 0),
         report.get("add_layernorm_max_abs_err"),
         timing("add_layernorm", rows=4)),
        ("qmm_tc_grouped_ffn", qmm_src, qmm_tpu, qwen3_grouped.get(
            "qmm_tc_grouped_ffn", 0),
         report.get("qmm_grouped_ffn_max_abs_err"),
         timing("qmm_tc_grouped_ffn", tokens=2, shape="w_in/w_gate")),
        ("qmm_tc_grouped", qmm_src, qmm_tpu, qwen3_grouped.get(
            "qmm_tc_grouped", 0),
         report.get("qmm_grouped_max_abs_err"),
         timing("qmm_tc_grouped", tokens=2, shape="w_out")),
        # paligemma-3b's shapes: the gated gelu epilogue (its whole
        # prompt's 320 rows and its decode step's 2), the bidirectional
        # 256-row prefix and MQA decode (H 1, G 8, dh 256)
        ("qmm_tc_gelu", qmm_src, qmm_tpu, pali_ffn.get("prefill", 0),
         report.get("qmm_gelu_max_abs_err"),
         timing("qmm_tc_gelu", M=PREFIX_SERVE["Sq"])),
        ("qmm_tc_gelu_decode_step", qmm_src, qmm_tpu,
         pali_ffn.get("decode", 0), report.get("qmm_gelu_max_abs_err"),
         timing("qmm_tc_gelu", M=ARCH_SLOTS)),
        ("flash_prefill_prefix", "src/repro_torch/csrc/flash_prefill.cu",
         "src/repro/kernels/flash_attention.py:257",
         pali.get("launches", {}).get("flash_prefill", 0),
         report.get("prefill_prefix_max_abs_err"),
         timing("flash_prefill_prefix")),
        ("flash_decode_mqa", "src/repro_torch/csrc/flash_decode.cu",
         "src/repro/kernels/flash_attention.py:112",
         pali.get("launches", {}).get("flash_decode", 0),
         report.get("flash_decode_mqa_max_abs_err"),
         timing("flash_decode_mqa")),
        ("paged_decode_mqa", "src/repro_torch/csrc/paged_decode.cu",
         "src/repro/kernels/paged_attention.py:52",
         pali_paged.get("launches", {}).get("paged_decode", 0),
         report.get("paged_mqa_max_abs_err"),
         timing("paged_decode_mqa")),
        # the recurrent configs' widths: qmm_tc per chunk and per decode
        # step (rwkv6 d 2048 / ff 7168 and its 65,536-wide head,
        # recurrentgemma d 2560 / ff 7680), the fused norms at their
        # decode rows, and recurrentgemma's local attention (H 1, G 10,
        # dh 256, window 2048)
        ("qmm_tc_rwkv6", qmm_src, qmm_tpu, tc_launches(rwkv, "prefill_chunk"),
         report.get("qmm_archs_max_abs_err"),
         timing("qmm_tc_rwkv6-1.6b_chunk")),
        ("qmm_tc_rwkv6_decode_step", qmm_src, qmm_tpu,
         tc_launches(rwkv, "decode_step"),
         report.get("qmm_archs_max_abs_err"),
         timing("qmm_tc_rwkv6-1.6b_decode_step")),
        ("qmm_tc_recurrentgemma", qmm_src, qmm_tpu,
         tc_launches(rg, "prefill_chunk"),
         report.get("qmm_archs_max_abs_err"),
         timing("qmm_tc_recurrentgemma-2b_chunk")),
        ("qmm_tc_recurrentgemma_decode_step", qmm_src, qmm_tpu,
         tc_launches(rg, "decode_step"),
         report.get("qmm_archs_max_abs_err"),
         timing("qmm_tc_recurrentgemma-2b_decode_step")),
        # the fused rwkv6 (rwkv_fused=1): qmm_tc per chunk and per decode
        # step (wrkvg 2048 x 8256, wo, cm_kr 2048 x 9216, cm_v, the head),
        # and as_array's dequantize_decode of the two wide leaves
        ("qmm_tc_rwkv6_fused", qmm_src, qmm_tpu,
         tc_launches(fused, "prefill_chunk"),
         report.get("qmm_fused_max_abs_err"),
         timing(f"qmm_tc_{FUSED_LABEL}_chunk")),
        ("qmm_tc_rwkv6_fused_decode_step", qmm_src, qmm_tpu,
         tc_launches(fused, "decode_step"),
         report.get("qmm_fused_max_abs_err"),
         timing(f"qmm_tc_{FUSED_LABEL}_decode_step")),
        ("dequantize_decode_wrkvg", ff_src,
         "src/repro/kernels/flexfloat_cast.py:42", fused_dq,
         (timing("dequantize_decode_fused", leaf="wrkvg") or {}).get(
             "max_abs_err"), timing("dequantize_decode_fused", leaf="wrkvg")),
        ("dequantize_decode_cm_kr", ff_src,
         "src/repro/kernels/flexfloat_cast.py:42", fused_dq,
         (timing("dequantize_decode_fused", leaf="cm_kr") or {}).get(
             "max_abs_err"), timing("dequantize_decode_fused", leaf="cm_kr")),
        ("add_layernorm_d2048", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:228",
         norm_launches(rwkv, "add_layernorm_launch"),
         report.get("add_layernorm_max_abs_err"),
         timing("add_layernorm_recurrent")),
        ("add_rmsnorm_d2560", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:221",
         norm_launches(rg, "add_rmsnorm_launch")
         + norm_launches(rg_paged, "add_rmsnorm_launch"),
         report.get("add_rmsnorm_max_abs_err"),
         timing("add_rmsnorm_recurrent")),
        ("flash_prefill_rg", "src/repro_torch/csrc/flash_prefill.cu",
         "src/repro/kernels/flash_attention.py:257",
         rg.get("launches", {}).get("flash_prefill", 0)
         + rg_paged.get("launches", {}).get("flash_prefill", 0),
         report.get("prefill_rg_max_abs_err"), timing("flash_prefill_rg")),
        ("flash_decode_rg", "src/repro_torch/csrc/flash_decode.cu",
         "src/repro/kernels/flash_attention.py:112",
         rg.get("launches", {}).get("flash_decode", 0),
         report.get("flash_decode_rg_max_abs_err"),
         timing("flash_decode_rg")),
        ("paged_decode_rg", "src/repro_torch/csrc/paged_decode.cu",
         "src/repro/kernels/paged_attention.py:52",
         rg_paged.get("launches", {}).get("paged_decode", 0),
         report.get("paged_rg_max_abs_err"), timing("paged_decode_rg")),
        # whisper-tiny's shapes: qmm_tc per whole-prompt prefill and per
        # decode step (the encoder and the cross K/V at 1500 rows, the
        # biased gelu FFN, the head's N 51,865), the attention kernels at
        # H 6, G 1, dh 64, add_layernorm at d 384
        ("qmm_tc_whisper", qmm_src, qmm_tpu,
         sum(e.get("qmm_tc_prefill", 0) for e in whisper),
         report.get("qmm_whisper_max_abs_err"),
         timing("qmm_tc_whisper_prefill")),
        ("qmm_tc_whisper_decode_step", qmm_src, qmm_tpu,
         sum(e.get("qmm_tc_decode", 0) for e in whisper),
         report.get("qmm_whisper_max_abs_err"),
         timing("qmm_tc_whisper_decode_step")),
        ("flash_prefill_whisper", "src/repro_torch/csrc/flash_prefill.cu",
         "src/repro/kernels/flash_attention.py:257",
         sum(e.get("launches", {}).get("flash_prefill", 0) for e in whisper),
         report.get("prefill_whisper_max_abs_err"),
         timing("flash_prefill_whisper")),
        ("flash_decode_whisper", "src/repro_torch/csrc/flash_decode.cu",
         "src/repro/kernels/flash_attention.py:112",
         sum(e.get("launches", {}).get("flash_decode", 0) for e in whisper),
         report.get("flash_decode_whisper_max_abs_err"),
         timing("flash_decode_whisper")),
        ("paged_decode_whisper", "src/repro_torch/csrc/paged_decode.cu",
         "src/repro/kernels/paged_attention.py:52",
         sum(e.get("launches", {}).get("paged_decode", 0) for e in whisper),
         report.get("paged_whisper_max_abs_err"),
         timing("paged_decode_whisper")),
        ("add_layernorm_d384", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:228",
         sum(norm_launches(e, "add_layernorm_launch") for e in whisper),
         report.get("add_layernorm_d384_max_abs_err"),
         timing("add_layernorm_whisper", rows=1)),
        # training (the train phase, llama3-8b at 4 layers, batch 8 x
        # seq 128): flash_prefill on f32 K/V, causal, its launches with
        # the remat recompute; add_rmsnorm at the step's 1024 rows; and
        # prefill_from_cache's launch over the e5m2 cache (prefill_cont)
        ("flash_prefill_train", "src/repro_torch/csrc/flash_prefill.cu",
         "src/repro/kernels/flash_attention.py:257",
         report.get("train", {}).get("flash_prefill_launches", 0),
         report.get("prefill_train_max_abs_err"),
         timing("flash_prefill_train")),
        ("add_rmsnorm_train", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/models/layers.py:221",
         report.get("train", {}).get("add_rmsnorm_launches", 0),
         report.get("add_rmsnorm_train_max_abs_err"),
         timing("add_rmsnorm_train")),
        ("flash_prefill_cont", "src/repro_torch/csrc/flash_prefill.cu",
         "src/repro/kernels/flash_attention.py:257",
         report.get("prefill_cont", {}).get("launches", 0),
         report.get("prefill_cont_max_abs_err"),
         timing("flash_prefill_cont")),
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
    ap.add_argument("--archs", default=",".join(ARCHS),
                    help="the configs the archs phase serves (a subset "
                    "makes the run exit non-zero, as a subset of phases)")
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
    from repro_torch.kernels import (flash_attention, flexfloat_cast,
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

    jobs = {}                   # the dry-run sweep, once started
    try:
        return _run_phases(torch, np, args, phases, libs, report, smi, jobs)
    finally:
        if "sweep" in jobs:
            stop_sweep(jobs["sweep"])


def _run_phases(torch, np, args, phases, libs, report, smi, jobs):
    """Every phase of ``phases`` in turn, then the report and the last
    lines; returns 0 (a failed phase exits through :func:`fail`).  The
    dry-run sweep starts as the first phase after the build begins (the
    build's nvcc processes would share the host's cores with it) and runs
    on the host beside the phases before its own."""
    from repro_torch.kernels import _build, qmatmul

    results = {}
    timer = None
    sass = None                 # the SASS check, read after the phases
    for phase in phases:
        if "dryrun" in phases and "sweep" not in jobs and phase != "build":
            jobs["sweep"] = start_sweep(
                report, os.path.join(args.out, "dryrun_single"))
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
                    sass = start_tc_sass(qmatmul.LIB)
            elif phase == "kernels":
                timer = timer or Timer(torch)
                ok = check_qmm(torch, np, report)
                ok &= check_qmm_packed_a(torch, np, report)
                ok &= check_paged(torch, np, report, timer)
                ok &= check_prefill(torch, np, report, timer)
                ok &= check_flash_decode(torch, np, report)
                ok &= check_qmm_archs(torch, report, timer)
                ok &= check_qmm_grouped(torch, report)
                ok &= check_add_rmsnorm(torch, report, args)
                ok &= check_add_layernorm(torch, report, args)
                time_kernels(torch, np, report, timer)
                time_prefix_attention(torch, np, report, timer)
                time_recurrentgemma_attention(torch, np, report, timer)
                time_qmm_recurrent(torch, report, timer)
                time_qmm_grouped(torch, report, timer)
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
            elif phase == "encdec":
                timer = timer or Timer(torch)
                ok = run_encdec(torch, np, report, libs, args, timer)
            elif phase == "train":
                timer = timer or Timer(torch)
                ok = run_train(torch, np, report, libs, args, timer)
            elif phase == "prefill_cont":
                timer = timer or Timer(torch)
                ok = run_prefill_cont(torch, np, report, libs, args, timer)
            elif phase == "paper":
                ok = run_paper(torch, report, libs)
            elif phase == "serve_tune":
                ok = run_serve_tune(torch, report, libs, args)
            elif phase == "tune_archs":
                ok = run_tune_archs(torch, report, libs, args)
            elif phase == "mesh":
                ok = run_mesh(torch, np, report, libs, args)
            elif phase == "train_mesh":
                timer = timer or Timer(torch)
                ok = run_train_mesh(torch, np, report, libs, args, timer)
            elif phase == "rwkv_fused":
                timer = timer or Timer(torch)
                ok = run_rwkv_fused(torch, np, report, libs, args, timer)
            elif phase == "dryrun":
                ok = run_dryrun(torch, report, args, jobs["sweep"])
            elif phase == "profile":
                ok = run_profile(torch, report, args)
            elif phase == "steps":
                # one decode step's device activities alone (for --src)
                ok = run_steps(torch, report, args)
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

    if sass is not None:
        results["build"] &= check_tc_sass(sass, report)
    kernels = kernel_rows(report)
    report["kernels"] = kernels
    report["phases"] = results
    with open(os.path.join(args.out, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if not all(results.values()) or set(ALL_PHASES) - {"profile"} \
            - set(phases) or set(ARCHS) - set(args.archs.split(",")):
        fail(f"phases: {results}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
