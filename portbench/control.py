"""Readings for a cell's correctness limit: the program's widest served-token
gap and the control's, on several seeds in one process.

    python3 portbench/control.py --workload nemo12b.chat --seeds 101,102,103 --seconds 10
    python3 portbench/control.py --workload nemo12b.chat --seeds 104 --fault state_unchanged

Each seed is a whole run of the cell (weights, engine, warm-up, a short
window at the cell's own load) whose sample is judged three times: the
program's served tokens against the plain reference (as a benchmark run
reads them); the control, the same reference with its weights rounded to
binary8 (e5m2), the precision below the configuration's binary16alt,
picking the token at each position of the same prompts and served
tokens; and the witness, the reference summing in float64 with the same
rounding points, picking likewise (how far rounding alone moves the
served token).  ``control_correct`` is the harness's own verdict with the
control's gap in the program's place, and has to read false.  With
``--fault`` a fault of ``faults.py`` is planted underneath the timed path
first, and ``correct`` has to read false.  The limit in
``limits/<cell>.json`` lies between the program's largest reading and
the control's smallest.  The benchmark's own runs never run the control.
One JSON line a seed.
"""
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
from portbench import procenv  # noqa: E402

procenv.set_env(ROOT)

# the control, and the witness: the reference summing in float64 with the
# same rounding points, judged like the program
OTHERS = {"control_gap": {"weight_fmt": "e5m2"},
          "float64_gap": {"compute": "float64"}}


def main(argv=None) -> int:
    import argparse

    from portbench import faults

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    procenv.one_thread()
    cell = spec.load_cell(args.workload, ROOT)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        faults.plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False,
                               device=args.device, others=OTHERS,
                               say=lambda m: print(m, file=sys.stderr))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "program_gap": res["checks"]["logit_gap"]["value"],
            **res["other_gaps"],
            "limit": res["checks"]["logit_gap"]["limit"],
            "compared_tokens": res["checks"]["compared_tokens"]["value"],
            "correct": res["correct"],
            "control_correct": harness.correct(
                harness.checks_with(res, "control_gap")),
            "seconds": time.perf_counter() - t0}), flush=True)
        del res
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
