"""Where the MoE expert product's time goes on one CUDA card.

    python3 tools/bench_grouped.py [--src DIR] [--tag NAME] [--out DIR]
                                   [--variants]

At qwen3-moe-30b-a3b's expert shapes (E 128, C 8, binary16alt) with
the counts of its full-width router at 2 and 4 tokens, times each
grouped call (``qmm_grouped`` at w_in's and w_out's shapes and, where
the checkout has it, the gated ``qmm_grouped_ffn``) with
``chip_smoke.Timer`` (CUDA events, the L2 flushed by writing 64 MB)
and with the L2 flushed by reading 64 MB instead (no dirty lines to
write back), beside a streaming yardstick: ``torch.sum`` over as many
f32 bytes as the live experts' weights of one call.  ``--src`` names
the ``src/`` directory whose ``repro_torch`` to time (default: this
checkout's), so an earlier checkout unpacked into a git-ignored
directory can be timed with the same code in the same chip call.
Writes ``<out>/bench_grouped_<tag>.json`` and prints one line a case.

``--variants`` also times probes of the grouped kernel built from
``csrc/qmm.cu`` by text edits (the binary16alt unit alone, into
``build/bench_grouped/``), at the 2-token shapes: ``kernel`` (the source
as it is), ``no_arrival`` (no split-K arrival and no reduce: the split
partials are stored and left), ``no_split`` (each fragment value taken
as its own TF32 high part, no split), ``no_zero`` (the dead rows not
written) and ``no_arrival_no_split``.  The probes are timings only;
their results are not checked (``chip_smoke.py`` checks the kernel).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARRIVAL = "    if (splits > 1) arrive(&w);"
SPLIT = "    split_tf32(as[i], hi, lo);"
NO_SPLIT = "    hi = as[i]; lo = 0.0f;"
ZERO = "  for (int R = blockIdx.x; R < n_exp * C; R += gridDim.x) {"


def variants(src: str) -> dict:
    """Timing probes of the grouped kernel by text edits of its source."""
    no_arrival = src.replace(ARRIVAL, "")
    out = {"kernel": src, "no_arrival": no_arrival,
           "no_split": src.replace(SPLIT, NO_SPLIT),
           "no_zero": src.replace(ZERO, ZERO.replace("R = blockIdx.x",
                                                     "R = n_exp * C")),
           "no_arrival_no_split": no_arrival.replace(SPLIT, NO_SPLIT)}
    for name, text in out.items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"variant {name}: the edit found nothing")
    return out


def build_variants(csrc: str, out_dir: str, nvcc_flags) -> dict:
    """Each variant's unit 4 (binary16alt) as its own library, all nvcc
    processes started together; returns {name: ctypes.CDLL}."""
    from repro_torch.kernels._build import _nvcc
    src = open(os.path.join(csrc, "qmm.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        path = os.path.join(out_dir, f"qmm_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libqmm_{name}.so")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *nvcc_flags, "-I", csrc, "-DQMM_UNIT=4", "-shared",
             "-o", so, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(so)
        fn = lib.qmm_tc_grouped_fmt4
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "reports"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_grouped: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.core.formats import BINARY16ALT
    from repro_torch.kernels import _build
    from repro_torch.kernels import qmatmul as Q

    class ReadFlushed(cs.Timer):
        """``chip_smoke.Timer`` with the L2 flushed by a 64 MB read."""

        def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
            for _ in range(warmup):
                fn()
            times = []
            for _ in range(iters):
                self.flush.sum()
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.build_all()
    written, read = cs.Timer(torch), ReadFlushed(torch)
    probes = None
    if args.variants:
        probes = build_variants(
            os.path.join(os.path.abspath(args.src), "repro_torch", "csrc"),
            os.path.join(ROOT, "build", "bench_grouped"), _build.NVCC_FLAGS)
    fmt, E, C = BINARY16ALT, 128, 8
    arch = "qwen3-moe-30b-a3b"
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 22)
    res = dict(tag=args.tag, src=os.path.abspath(args.src),
               device=torch.cuda.get_device_name(0), cases=[])
    for weight, K, N in (("w_in", 2048, 768), ("w_out", 768, 2048)):
        wp = cs._pack_weight(torch.randn((E, K, N), generator=gen,
                                         device="cuda"), fmt)
        gp = cs._pack_weight(torch.randn((E, K, N), generator=gen,
                                         device="cuda"), fmt)
        for T in (2, 4):
            rows = cs.router_rows(torch, arch, T, 7 + T)
            a, _ = cs._dispatched(torch, gen, E, C, K, rows, 0.0)
            live = int((rows > 0).sum())
            buf = torch.randn((live * K * N // 2,), generator=gen,
                              device="cuda")
            calls = {"qmm_grouped": lambda: Q.qmm_grouped(a, wp, fmt, rows),
                     "stream one weight's bytes": lambda: buf.sum()}
            if weight == "w_in" and hasattr(Q, "qmm_grouped_ffn"):
                calls["qmm_grouped_ffn"] = lambda: Q.qmm_grouped_ffn(
                    a, wp, gp, fmt, rows, act="silu")
            for name, fn in calls.items():
                w_ms, r_ms = written(fn), read(fn)
                res["cases"].append(dict(weight=weight, tokens=T,
                                         live_experts=live, call=name,
                                         write_flushed_ms=w_ms,
                                         read_flushed_ms=r_ms))
                print(f"[bench_grouped] {args.tag} {weight} {T} tokens "
                      f"({live} live) {name}: write-flushed {w_ms:.4f} ms, "
                      f"read-flushed {r_ms:.4f} ms", flush=True)
            if args.variants and T == 2:
                res["cases"] += time_variants(torch, Q, _build, written,
                                              probes, a, wp, gp, rows,
                                              weight, args.tag)
            del a, buf
        del wp, gp
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_grouped_{args.tag}.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    return 0


def time_variants(torch, Q, _build, timer, probes, a, wp, gp, rows, weight,
                  tag):
    """Each probe on the call's operands: ungated, and gated (silu) at
    w_in's shape; the kernel's launch as ``qmm_grouped`` makes it."""
    E, C, K = a.shape
    N = wp.shape[2]
    n_sm = _build.sm_count(a.device)
    out = []
    for gated in ((False, True) if weight == "w_in" else (False,)):
        _, splits, k_chunk = Q.grouped_plan(C, K, N, n_sm, gated)
        ws = torch.empty(((2 if gated else 1) * splits, E, C, N),
                         device="cuda")
        counts = torch.zeros((E * 4 * 32,), dtype=torch.int32,
                             device="cuda")
        o = torch.empty((E, C, N), device="cuda")
        p = _build.ptr
        for name, fn in probes.items():
            def call():
                rc = fn(p(a), p(wp), p(gp if gated else None), p(o), p(ws),
                        p(counts), p(rows), E, C, K, N, splits, k_chunk,
                        Q.ACTS["silu" if gated else None], 0, 0, n_sm,
                        _build.stream_ptr(a.device))
                if rc:
                    raise RuntimeError(f"probe {name}: cudaError {rc}")
            ms = timer(call)
            counts.zero_()
            what = "gated" if gated else "ungated"
            out.append(dict(weight=weight, tokens=2, call=f"probe {name}",
                            gated=gated, write_flushed_ms=ms))
            print(f"[bench_grouped] {tag} {weight} 2 tokens {what} probe "
                  f"{name}: {ms:.4f} ms", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
