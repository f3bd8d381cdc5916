"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--out DIR]

Run from the root of a checkout.  Phases:

1. build    -- compile every CUDA kernel of ``src/repro_torch/csrc`` (one
               nvcc per source, in parallel) into ``build/kernels/``.
2. kernels  -- each kernel against its plain PyTorch version on the card,
               at the serving path's shapes and at ragged edge shapes,
               with the stated tolerances; times each kernel, its plain
               version and a library yardstick at the serving shapes.
3. casts    -- torch's CUDA f32 -> float8_e5m2 and f32 -> bfloat16 casts
               (the KV write and the activation cast) against the port's
               plain codec, on 2^24 seeded f32 patterns plus every
               boundary of each target.
4. serve    -- ``repro_torch.launch.serve.main`` on full-width,
               full-depth llama3-8b (random weights from the seed),
               asserting the per-step launch counts of the three kernels.
5. logits   -- one prefill chunk and one decode step of a 2-layer,
               full-width model: kernel path against the plain path on
               the same seeded weights.
6. profile  -- a short serve run under torch.profiler: device busy share
               and the kernels that take the device time.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
without that line, when there is no CUDA device, when it is not run from
a checkout, or when any phase fails.  Longer reports go to ``--out``
(default ``chiprun_out/``).
"""
from __future__ import annotations

import argparse
import dataclasses
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
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_qmm(torch, np, report, timer):
    from repro_torch.core.formats import (BINARY8, BINARY16, BINARY16ALT,
                                          BINARY32)
    from repro_torch.core.qtensor import decode, encode
    from repro_torch.kernels import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(report["seed"])

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def pack(w, fmt):
        # round through the native dtype, so packing is a bitcast (the
        # plain codec's int64 temporaries would not fit beside the
        # 128256-wide head)
        return encode(w.to(fmt.native_dtype), fmt)

    worst = 0.0

    def case(name, M, K, N, fmt, gated=False, bias=False, act=None,
             out_fmt=None):
        nonlocal worst
        x = rand(M, K)
        wp = pack(rand(K, N), fmt)
        gp = pack(rand(K, N), fmt) if gated else None
        b = rand(N) if bias else None
        got = Q.qmatmul(x, wp, None, fmt, out_fmt, gate_payload=gp, bias=b,
                        act=act)
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
        report["cases"].append(dict(kernel="qmm", case=name, M=M, K=K, N=N,
                                    fmt=fmt.name, gated=gated, act=act,
                                    max_abs_err=float(err.max()),
                                    max_err_in_acc_units=norm, ok=ok))
        print(f"[kernels] qmm {name:<28} M={M:<3} K={K:<5} N={N:<6} "
              f"{fmt.name:<11} max|err|={float(err.max()):.3e} "
              f"({norm:.2e} x |x|@|w|, tol 1e-6) {'ok' if ok else 'FAIL'}")
        if fmt == BINARY16ALT and out_fmt is None:
            worst = max(worst, float(err.max()))
        del x, wp, gp, b, got, want, sh, sg, err
        return ok

    ok = True
    # the serving path: binary16alt weights, M = 1 / 4 decode, 64 prefill
    for M in (1, 4, 64):
        ok &= case("wq/wo", M, 4096, 4096, BINARY16ALT)
        ok &= case("wk/wv", M, 4096, 1024, BINARY16ALT)
        ok &= case("ffn gated silu", M, 4096, 14336, BINARY16ALT, gated=True,
                   act="silu")
        ok &= case("w_out", M, 14336, 4096, BINARY16ALT)
    ok &= case("head", 4, 4096, 128256, BINARY16ALT)
    # every paper format, plain and gated-silu with bias, edge shapes
    for fmt in (BINARY8, BINARY16, BINARY16ALT, BINARY32):
        for M in (1, 4, 64):
            ok &= case("plain", M, 4096, 4096, fmt)
            ok &= case("gated silu + bias", M, 4096, 1024, fmt, gated=True,
                       bias=True, act="silu")
        ok &= case("ragged", 3, 100, 70, fmt)
        ok &= case("ragged gated silu + bias", 3, 100, 70, fmt, gated=True,
                   bias=True, act="silu")
    ok &= case("ragged gelu(tanh)", 5, 130, 77, BINARY8, bias=True,
               act="gelu")
    ok &= case("ragged relu2", 33, 100, 70, BINARY16, act="relu2")
    ok &= case("ragged out_fmt binary16alt", 3, 100, 70, BINARY8,
               gated=True, act="silu", out_fmt=BINARY16ALT)
    report["qmm_max_abs_err"] = worst

    # timing at the serving decode step (M = 4 slots): one step is
    # 32 x (wq, wk, wv, wo, gated ffn, w_out) + the head = 193 launches
    shapes = [("wq", 4096, 4096, False, 32), ("wk", 4096, 1024, False, 32),
              ("wv", 4096, 1024, False, 32), ("wo", 4096, 4096, False, 32),
              ("ffn", 4096, 14336, True, 32), ("w_out", 14336, 4096, False,
                                                 32),
              ("head", 4096, 128256, False, 1)]
    M = 4
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0)
    for name, K, N, gated, mult in shapes:
        x = rand(M, K)
        wp = pack(rand(K, N), BINARY16ALT)
        gp = pack(rand(K, N), BINARY16ALT) if gated else None
        act = "silu" if gated else None
        wf = decode(wp, BINARY16ALT)
        gf = decode(gp, BINARY16ALT) if gated else None
        t_k = timer(lambda: Q.qmatmul(x, wp, None, BINARY16ALT,
                                      gate_payload=gp, act=act))
        t_p = timer(lambda: Q.qmatmul_plain(x, wp, None, BINARY16ALT,
                                            gate_payload=gp, act=act),
                    iters=5)
        if gated:
            t_l = timer(lambda: torch.nn.functional.silu(x @ wf) * (x @ gf))
        else:
            t_l = timer(lambda: torch.matmul(x, wf))
        host = timer.host_us(lambda: Q.qmatmul(x, wp, None, BINARY16ALT,
                                               gate_payload=gp, act=act))
        nbytes = Q.qmm_hbm_bytes(M, K, N, BINARY16ALT, gated=gated)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        report["timings"].append(dict(kernel="qmm", shape=name, M=M, K=K,
                                      N=N, launches_per_step=mult, ms=t_k,
                                      plain_ms=t_p, library_ms=t_l,
                                      bound_ms=bound, bytes=nbytes,
                                      host_us=host))
        print(f"[timing] qmm {name:<6} M={M} K={K:<5} N={N:<6} kernel "
              f"{t_k:.4f} ms  plain {t_p:.4f} ms  torch.matmul {t_l:.4f} ms"
              f"  bound {bound:.4f} ms  host {host:.1f} us/call")
        totals["ms"] += mult * t_k
        totals["plain_ms"] += mult * t_p
        totals["library_ms"] += mult * t_l
        totals["bytes"] += mult * nbytes
        del x, wp, gp, wf, gf
    report["qmm_step"] = totals
    torch.cuda.empty_cache()
    return ok


def _paged_inputs(torch, np, fmt, seed):
    """B = 4 ragged sequences over a 64-page pool: lengths 0, 37, 300 and
    one beyond the 512-token capacity; scattered pages; -1 table tails."""
    from repro_torch.core.qtensor import encode
    rng = np.random.default_rng(seed)
    B, H, G, dh, page, num_pages, pps = 4, 8, 4, 128, 64, 64, 8
    q = torch.tensor(rng.normal(size=(B, H, G, dh)), dtype=torch.float32)
    kf = torch.tensor(rng.normal(size=(num_pages, page, H, dh)),
                      dtype=torch.float32)
    vf = torch.tensor(rng.normal(size=(num_pages, page, H, dh)),
                      dtype=torch.float32)
    lengths = torch.tensor([0, 37, 300, 700], dtype=torch.int32)
    perm = rng.permutation(num_pages)
    tables = np.full((B, pps), -1, np.int32)
    used = 0
    for b, n in enumerate([1, 1, 5, 8]):
        tables[b, :n] = perm[used:used + n]
        used += n
    tables[0, 0] = -1          # zero length and unmapped
    tables[2, 3] = -1          # a hole inside the length: masked
    kp = encode(kf, fmt) if fmt is not None else kf
    vp = encode(vf, fmt) if fmt is not None else vf
    dev = lambda t: t.to("cuda").contiguous()  # noqa: E731
    return (dev(q), dev(kp), dev(vp), dev(lengths),
            dev(torch.tensor(tables)), page)


def check_paged(torch, np, report, timer):
    from repro_torch.core.formats import BINARY8, BINARY16ALT, BINARY32
    from repro_torch.kernels import paged_attention as PA

    ok, worst = True, 0.0
    for fmt in (BINARY8, BINARY16ALT, BINARY32, None):
        q, kp, vp, lens, tbl, page = _paged_inputs(torch, np, fmt,
                                                   report["seed"])
        got, gm, gl = PA.paged_decode(q, kp, vp, fmt, lens, tbl,
                                      return_residuals=True)
        want, wm, wl = PA.paged_decode_plain(
            q, kp, vp, fmt, torch.clamp(lens, max=tbl.shape[1] * page), tbl,
            return_residuals=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rerr = max(float((gm - wm).abs().max()),
                   float(((gl - wl).abs() / wl.clamp(min=1.0)).max()))
        zero_ok = bool((got[0] == 0).all())
        good = err <= 1e-6 and rerr <= 1e-5 and zero_ok
        ok &= good
        name = fmt.name if fmt is not None else "f32"
        report["cases"].append(dict(kernel="paged_decode", fmt=name,
                                    max_abs_err=err, residual_err=rerr,
                                    ok=good))
        print(f"[kernels] paged_decode {name:<11} B=4 H=8 G=4 dh=128 "
              f"page=64 max|err|={err:.3e} (tol 1e-6) residuals "
              f"{rerr:.1e} (tol 1e-5) zero-length row zero: {zero_ok} "
              f"{'ok' if good else 'FAIL'}")
        if fmt == BINARY8:
            worst = err
    report["paged_max_abs_err"] = worst
    return ok


def _prefill_inputs(torch, np, fmt, seed, Skv=256):
    from repro_torch.core.qtensor import encode
    rng = np.random.default_rng(seed + 1)
    B, Sq, H, G, dh = 1, 64, 8, 4, 128
    q = torch.tensor(rng.normal(size=(B, Sq, H, G, dh)), dtype=torch.float32)
    kf = torch.tensor(rng.normal(size=(B, Skv, H, dh)), dtype=torch.float32)
    vf = torch.tensor(rng.normal(size=(B, Skv, H, dh)), dtype=torch.float32)
    kp = encode(kf, fmt) if fmt is not None else kf
    vp = encode(vf, fmt) if fmt is not None else vf
    return q.cuda(), kp.cuda().contiguous(), vp.cuda().contiguous()


def check_prefill(torch, np, report, timer):
    from repro_torch.core.formats import BINARY8
    from repro_torch.kernels import flash_attention as FA

    ok, worst = True, 0.0
    cases = [(BINARY8, 0, None, 0), (BINARY8, 64, None, 0),
             (BINARY8, 100, None, 0), (None, 0, None, 0),
             (None, 64, None, 0), (None, 100, None, 0),
             (BINARY8, 100, 48, 0), (None, 64, None, 16)]
    for fmt, q_off, window, prefix in cases:
        q, kp, vp = _prefill_inputs(torch, np, fmt, report["seed"])
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
                                    prefix_len=prefix, max_abs_err=err,
                                    ok=good))
        print(f"[kernels] flash_prefill {name:<8} Sq=64 Skv=256 q_offset="
              f"{q_off:<3} window={window} prefix={prefix} max|err|="
              f"{err:.3e} (tol 1e-6) {'ok' if good else 'FAIL'}")
        if fmt == BINARY8:
            worst = max(worst, err)
    report["prefill_max_abs_err"] = worst
    return ok


def time_attention(torch, np, report, timer, serve_len):
    """Times at the serving shapes: paged decode of 4 slots holding
    ``serve_len`` tokens; prefill of the second 64-token chunk (q_offset
    64) over a 256-token slot, e5m2 K/V."""
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

    Sq, Skv, q_off = 64, 256, 64
    qq = torch.randn(1, Sq, H, G, dh, device="cuda")
    kc = encode(torch.randn(1, Skv, H, dh, device="cuda"), BINARY8)
    vc = encode(torch.randn(1, Skv, H, dh, device="cuda"), BINARY8)
    t_fk = timer(lambda: FA.flash_prefill(qq, kc, vc, BINARY8,
                                          q_offset=q_off))
    t_fp = timer(lambda: FA.flash_prefill_plain(qq, kc, vc, BINARY8,
                                                q_offset=q_off), iters=10)
    # library yardstick: SDPA on dequantized K/V with the same mask
    kd, vd = decode(kc, BINARY8), decode(vc, BINARY8)
    mask = FA.prefill_mask(Sq, Skv, q_off, None, 0, "cuda")
    qs = qq.reshape(1, Sq, H * G, dh).transpose(1, 2)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    t_fl = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    host = timer.host_us(lambda: FA.flash_prefill(qq, kc, vc, BINARY8,
                                                  q_offset=q_off))
    live = sum(q_off + i + 1 for i in range(Sq))   # keys each query needs
    flops = 4 * dh * H * G * live
    nbytes = FA.prefill_hbm_bytes(1, Sq, q_off + Sq, H, G, dh, BINARY8)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F32_PEAK_FLOPS * 1e3
    report["timings"].append(dict(
        kernel="flash_prefill", Sq=Sq, Skv=Skv, q_offset=q_off, ms=t_fk,
        plain_ms=t_fp, library_ms=t_fl, bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bytes=nbytes, flops=flops, host_us=host))
    print(f"[timing] flash_prefill Sq=64 Skv=256 q_offset=64 kernel "
          f"{t_fk:.4f} ms  plain {t_fp:.4f} ms  SDPA {t_fl:.4f} ms  bound "
          f"{max(b_bytes, b_ops):.5f} ms  host {host:.1f} us/call")


# ---------------------------------------------------------------------------
# phase 3: casts
# ---------------------------------------------------------------------------

def _boundaries(torch, fmt):
    """Every pattern of a <= 16-bit format as f32, the midpoints between
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
    from repro_torch.core.qtensor import decode, encode

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


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def run_serve(torch, report, libs, args):
    from repro_torch.engine import worker
    from repro_torch.launch import serve

    qmm, paged, prefill = libs
    per_step = {"decode": [], "prefill": []}

    def counting(kind, fn):
        def wrapped(self, *a, **k):
            before = [lib.launches for lib in libs]
            out = fn(self, *a, **k)
            per_step[kind].append(tuple(lib.launches - b0 for lib, b0
                                        in zip(libs, before)))
            return out
        return wrapped

    orig = (worker.DecodeWorker.step, worker.PrefillWorker.step)
    worker.DecodeWorker.step = counting("decode", orig[0])
    worker.PrefillWorker.step = counting("prefill", orig[1])
    argv = ["--arch", "llama3-8b", "--policy", "transprecision",
            "--decode-impl", "paged", "--matmul-impl", "qmm_pallas",
            "--page-size", str(SERVE_PAGE), "--requests",
            str(SERVE_REQUESTS), "--slots", str(SERVE_SLOTS),
            "--prompt-len", str(SERVE_PROMPT), "--max-new",
            str(SERVE_MAX_NEW), "--capacity", str(SERVE_CAPACITY), "--seed",
            str(args.seed), "--stats-out",
            os.path.join(args.out, "serve_stats.jsonl")]
    torch.cuda.reset_peak_memory_stats()
    for lib in libs:
        lib.launches = 0                 # counts of the main path only
    t0 = time.perf_counter()
    try:
        reqs = serve.main(argv)
    finally:
        worker.DecodeWorker.step, worker.PrefillWorker.step = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    peak = torch.cuda.max_memory_allocated()

    ok = all(r.done and not r.failed for r in reqs)
    ok &= all(len(r.generated) == SERVE_MAX_NEW for r in reqs)
    ok &= all(0 <= t < 128256 for r in reqs for t in r.generated)
    dec_ok = all(c == (193, 32, 0) for c in per_step["decode"])
    pre_ok = all(c == (193, 0, 32) for c in per_step["prefill"])
    ok &= dec_ok and pre_ok and bool(per_step["decode"]) \
        and bool(per_step["prefill"])
    ok &= all(n > 0 for n in launches.values())
    with open(os.path.join(args.out, "serve_stats.jsonl")) as f:
        summary = [json.loads(line) for line in f][-1]
    tokens = sum(len(r.generated) for r in reqs)
    report["serve"] = dict(
        requests=len(reqs), tokens=tokens, wall_s=wall,
        tok_per_s=summary["tokens_per_s"],
        ttft_mean_s=summary["ttft_mean_s"], ttft_max_s=summary["ttft_max_s"],
        decode_steps=len(per_step["decode"]),
        prefill_chunks=len(per_step["prefill"]),
        launches=launches, peak_mem_bytes=peak,
        per_decode_step=sorted(set(per_step["decode"])),
        per_prefill_chunk=sorted(set(per_step["prefill"])), ok=ok)
    print(f"[serve] llama3-8b full (32 layers, d_model 4096): "
          f"{len(reqs)} requests done, {tokens} tokens in {wall:.2f} s, "
          f"{summary['tokens_per_s']} tok/s, TTFT mean "
          f"{summary['ttft_mean_s']} s (max {summary['ttft_max_s']} s), "
          f"peak memory {peak / 1e9:.2f} GB")
    print(f"[serve] launches {launches}; per decode step (qmm, paged, "
          f"prefill) {sorted(set(per_step['decode']))} (want 193, 32, 0); "
          f"per prefill chunk {sorted(set(per_step['prefill']))} (want "
          f"193, 0, 32) {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 6: where the serve time goes (torch.profiler over Engine.run)
# ---------------------------------------------------------------------------

def run_profile(torch, report, args):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import scheduler
    from repro_torch.launch import serve

    box = {}
    orig = scheduler.Engine.run

    def profiled(self, reqs):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = orig(self, reqs)
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - t0
        box["prof"], box["steps"] = prof, self.decode_steps
        return out

    scheduler.Engine.run = profiled
    try:
        serve.main(["--arch", "llama3-8b", "--policy", "transprecision",
                    "--decode-impl", "paged", "--matmul-impl", "qmm_pallas",
                    "--page-size", "64", "--requests", "4", "--slots", "4",
                    "--prompt-len", "128", "--max-new", "8", "--capacity",
                    "256", "--seed", str(args.seed)])
    finally:
        scheduler.Engine.run = orig
    prof, wall = box["prof"], box["wall"]

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # only the device's own rows (kernels, memcpys, memsets): a CPU op's
    # row also carries the device time of what it launched, so summing
    # every row would count that time twice (torch's table footer sums
    # the same rows)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:10]
    report["profile"] = dict(
        wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
        decode_steps=box["steps"],
        top=[dict(name=e.key[:80], count=e.count, device_ms=dev_us(e) / 1e3)
             for e in top])
    with open(os.path.join(args.out, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=40))
    print(f"[profile] serve 4 requests x (128 + 8): wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({100 * busy / wall:.1f} %)")
    for e in top:
        print(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6} "
              f"{e.key[:70]}")

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
    report["profile"]["host_syncs"] = syncs
    for where, n in sorted(syncs.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   sync x{n:<5} {where}")
    return busy > 0


# ---------------------------------------------------------------------------
# phase 5: logits, kernel path against plain path
# ---------------------------------------------------------------------------

def check_logits(torch, report, args):
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import paged_cache
    from repro_torch.models import qparams
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import Model

    _, full = build("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=2)
    model = Model(cfg)
    ok = True
    # binary32: both paths compute f32 products with f32 sums; only the
    # summation order differs (K up to 14336), so 1e-4 x max|logit|.
    # transprecision: the plain path rounds attention probabilities to
    # bf16 (attn_probs), the fused kernels keep them f32, and one bf16
    # ulp is 2^-8 of a value, so 2^-5 x max|logit|.
    for pol, rel in (("binary32", 1e-4), ("transprecision", 2.0 ** -5)):
        res = {}
        for path, (dec, mm) in (("kernel", ("paged", "qmm_pallas")),
                                ("plain", ("xla", "xla"))):
            policy = get_policy(pol, decode_impl=dec, matmul_impl=mm)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            params = model.init_params(gen, policy, device="cuda")
            if mm == "qmm_pallas":
                params = qparams.encode_params(params, policy)
            states = [paged_cache.set_block_tables(
                paged_cache.init_paged_cache(
                    1, 4, 64, 4, cfg.n_kv, cfg.head_dim,
                    policy.dtype("kv_cache"), device="cuda"),
                [[0, 1, 2, 3]]) for _ in range(cfg.n_layers)]
            g = torch.Generator().manual_seed(args.seed)
            toks = torch.randint(0, cfg.vocab, (1, 64), generator=g)
            lp, states = model.prefill_chunk(params, toks.cuda(), states,
                                             policy, slot=0, q_offset=0)
            ld, _ = model.decode_step(
                params, toks[:, -1:].cuda(), states, policy)
            res[path] = (lp.float(), ld.float())
            del params, states
            torch.cuda.empty_cache()
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
    return ok


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--phases",
                    default="build,kernels,casts,serve,logits,profile")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        fail("run from the root of a checkout (src/repro_torch not found)",
             2)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the port on a CUDA card", 2)
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build, flash_attention, paged_attention
    from repro_torch.kernels import qmatmul

    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    libs = (qmatmul.LIB, paged_attention.LIB, flash_attention.LIB)
    report = dict(seed=args.seed, cases=[], timings=[], casts=[], logits=[],
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
            elif phase == "kernels":
                timer = timer or Timer(torch)
                ok = check_qmm(torch, np, report, timer)
                ok &= check_paged(torch, np, report, timer)
                ok &= check_prefill(torch, np, report, timer)
                time_attention(torch, np, report, timer,
                               serve_len=SERVE_PROMPT + SERVE_MAX_NEW // 2)
            elif phase == "casts":
                ok = check_casts(torch, np, report)
            elif phase == "serve":
                ok = run_serve(torch, report, libs, args)
            elif phase == "logits":
                ok = check_logits(torch, report, args)
            elif phase == "profile":
                ok = run_profile(torch, report, args)
            else:
                raise ValueError(f"unknown phase {phase!r}")
        except Exception:  # noqa: BLE001 -- reported, and the run fails
            traceback.print_exc()
            ok = False
        torch.cuda.synchronize()
        results[phase] = ok
        print(f"[phase] {phase}: {'ok' if ok else 'FAILED'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    kernels = []
    rows = (("qmm", qmatmul.LIB, "src/repro_torch/csrc/qmm.cu",
             "src/repro/kernels/qmatmul.py:85"),
            ("paged_decode", paged_attention.LIB,
             "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/paged_attention.py:52"),
            ("flash_prefill", flash_attention.LIB,
             "src/repro_torch/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_attention.py:257"))
    serve_launches = report.get("serve", {}).get("launches", {})
    errs = {"qmm": report.get("qmm_max_abs_err"),
            "paged_decode": report.get("paged_max_abs_err"),
            "flash_prefill": report.get("prefill_max_abs_err")}
    for name, lib, source, replaces in rows:
        if name == "qmm" and "qmm_step" in report:
            t = report["qmm_step"]
            ms, plain, library = t["ms"], t["plain_ms"], t["library_ms"]
            bound, by = t["bytes"] / HBM_BYTES_PER_S * 1e3, "bytes"
        else:
            t = next((x for x in report["timings"] if x["kernel"] == name),
                     None)
            if t is None:
                continue
            ms, plain, library = t["ms"], t["plain_ms"], t["library_ms"]
            bound, by = t["bound_ms"], t.get("bound_by", "bytes")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=serve_launches.get(lib.name, 0),
                            max_abs_err=errs[name], ms=ms, plain_ms=plain,
                            bound_ms=bound, bound_by=by, library_ms=library))
    report["kernels"] = kernels
    report["phases"] = results
    with open(os.path.join(args.out, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if not all(results.values()) or not {
            "build", "kernels", "casts", "serve", "logits"} <= set(phases):
        fail(f"phases: {results}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
