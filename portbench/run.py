"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload nemo12b.chat --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Loads the cell's configuration, traffic
mix and metrics by the names in ``BENCHMARK.json``, makes the weights
from the seed, builds (first run in a checkout) or loads the program's
kernels under ``build/``, warms up, measures for ``--seconds``, checks
what the window served against the plain reference and prints one JSON
object as the last line of standard output: the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``.  Exits
non-zero, with no result, when no card (or too few) is present, and when
a module of JAX or of the JAX package is loaded once the window has
closed.
"""
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
from portbench import procenv  # noqa: E402

procenv.set_env(ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import repro_torch  # noqa: F401 -- the program: fail before any output
    from portbench import harness, spec

    procenv.one_thread()

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{banned}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} {c['holds']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
