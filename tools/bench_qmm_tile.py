"""Where qmm_tile's time goes on the card: the binary32 prefill chunk's
projections (llama3-8b, M = 64) through variants of ``csrc/qmm.cu``'s
qmm_tile built beside it, and the card's own FFMA rate.

    python3 tools/bench_qmm_tile.py [--out DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants (built from the source by text edits, unit 5 only, into
``build/bench_qmm_tile/``):

* ``kernel``   -- the source as it is (64-row tile at M = 64);
* ``kernel@32`` -- the same kernel at its 32-row tile;
* ``no_copy``  -- no global-to-shared copies (shared memory is read as it
  was left): the FMAs, the shared-memory reads and the barriers;
* ``fma_only`` -- neither copies nor activation / weight reads from
  shared memory: the FMAs, the barriers and the epilogue.

Prints each projection's time (CUDA events, L2 flushed, median of 20),
the chunk total over its 192 launches beside ``torch.matmul`` (TF32
off), the FFMA rate of a kernel of independent FMA chains, and the SM
clock sampled during the run.  The variants are timing probes only;
their results are not checked (``chip_smoke.py`` checks the kernel).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FMA_PEAK_SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) fma_peak(float* out, int iters) {
  float c[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) c[j] = threadIdx.x * 0.001f + j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = fmaf(c[j], 0.999f, 0.5f);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += c[j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" int fma_peak_launch(void* out, int blocks, int iters, void* s) {
  fma_peak<<<blocks, 256, 0, (cudaStream_t)s>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def variants(src: str) -> dict:
    """Timing probes of qmm_tile by text edits of its source."""
    no_copy = src.replace("    if (s < n_kt) load_tile(s, s);", "").replace(
        "      if (nk < n_kt) load_tile(nk, nk % kTlStages);", "")
    frag = "    for (int i = 0; i < kRM; ++i) av[i] = as[kRG * i * kTlAP];"
    run = "      smem_run<TB, kCN>(wp + boff, wb);"
    fma_only = no_copy.replace(
        frag, "    for (int i = 0; i < kRM; ++i) av[i] = 1.0f + i;").replace(
        run, "      for (int j = 0; j < kCN; ++j) wb[j] = 0x3f800000u + j;")
    assert no_copy != src and fma_only != no_copy
    return {"kernel": src, "no_copy": no_copy, "fma_only": fma_only}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "bench_qmm_tile"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_qmm_tile: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import qmatmul as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    src = open(os.path.join(csrc, "qmm.cu")).read()
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared"]
    jobs = {}
    for name, text in variants(src).items():
        cu = os.path.join(args.out, f"qmm_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(args.out, f"lib{name}.so")
        jobs[name] = (subprocess.Popen(nvcc + ["-DQMM_UNIT=5", "-o", so, cu]),
                      so)
    cu = os.path.join(args.out, "fma_peak.cu")
    with open(cu, "w") as f:
        f.write(FMA_PEAK_SRC)
    jobs["fma_peak"] = (subprocess.Popen(
        nvcc + ["-o", os.path.join(args.out, "libfma_peak.so"), cu]),
        os.path.join(args.out, "libfma_peak.so"))
    libs = {}
    for name, (proc, so) in jobs.items():
        if proc.wait() != 0:
            print(f"bench_qmm_tile: nvcc failed for {name}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        if name == "fma_peak":
            lib.fma_peak_launch.argtypes = [P, I, I, P]
        else:
            lib.qmm_tile_f32.argtypes = [P] * 6 + [I] * 11 + [P]

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timeit(fn, iters=20):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        ts.sort()
        return ts[len(ts) // 2]

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else None)

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[bench_qmm_tile] {smi}")
    clocks = []

    def clock():
        clocks.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True).stdout.strip())

    outp = torch.empty(132 * 8 * 256, device="cuda")
    blocks, iters = 132 * 8, 20000
    t = timeit(lambda: libs["fma_peak"].fma_peak_launch(
        ptr(outp), blocks, iters, stream()), iters=5)
    clock()
    rate = 2.0 * blocks * 256 * 16 * iters / t / 1e9
    print(f"[bench_qmm_tile] FFMA chains: {rate:.1f} TFLOP/s ({t:.3f} ms)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    M = 64
    shapes = [("wq", 4096, 4096, False, 64), ("wk", 4096, 1024, False, 64),
              ("ffn", 4096, 14336, True, 32), ("w_out", 14336, 4096, False,
                                                 32)]
    runs = [("kernel", 64), ("kernel@32", 32), ("no_copy", 64),
            ("fma_only", 64)]
    total = {name: 0.0 for name, _ in runs}
    total["torch.matmul"] = 0.0
    for sname, K, N, gated, mult in shapes:
        x = torch.randn((M, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda")
        g = torch.randn((K, N), generator=gen, device="cuda") if gated \
            else None
        splits = Q.gemv_splits(K, N, _build.sm_count(x.device))
        ws = torch.empty(((2 if gated else 1) * splits, M, N), device="cuda")
        out = torch.empty((M, N), device="cuda")
        line = f"[bench_qmm_tile] {sname:<6} M={M} K={K:<5} N={N:<6}"
        for name, tile in runs:
            lib = libs[name.split("@")[0]]

            def fn(lib=lib, tile=tile):
                rc = lib.qmm_tile_f32(ptr(x), ptr(w), ptr(g), None, ptr(out),
                                      ptr(ws), M, K, N, splits, tile, 0, 8,
                                      23, 1 if gated else 0, 0, 0, stream())
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")
            ms = timeit(fn)
            clock()
            total[name] += ms * mult
            line += f" {name} {ms:.4f} ms"
        if gated:
            tl = timeit(lambda: torch.nn.functional.silu(x @ w) * (x @ g))
        else:
            tl = timeit(lambda: x @ w)
        total["torch.matmul"] += tl * mult
        print(line + f" torch.matmul {tl:.4f} ms", flush=True)
        del x, w, g, ws, out
    print("[bench_qmm_tile] per chunk (192 launches, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in total.items()))
    print(f"[bench_qmm_tile] clocks.sm MHz sampled: {sorted(set(clocks))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
