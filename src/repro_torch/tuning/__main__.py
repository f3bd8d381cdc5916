"""Offline tuning CLI: search a serving binding and write the artifact.

``python -m repro_torch.tuning --arch llama3-8b --reduced --eps 0.05 \
      --out results/tuned/llama3-8b.reduced.json [--device cpu]``

The port of ``repro.tuning.__main__``, with the reference's flags plus
``--device`` (default ``cuda``; raises when no card is present unless
``--device cpu``).  ``--seed`` seeds the calibration prompts and the
candidates' random weights.  The written artifact loads everywhere via
``--policy PATH`` (``launch/serve.py``).
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs
from repro_torch.launch.cli import add_backend_args
from repro_torch.models.registry import build

from .artifact import save_artifact
from .calibrate import synthetic_calibration
from .search import ServeTuner


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve-time precision autotuning")
    ap.add_argument("--arch", default="llama3-8b", choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--eps", type=float, default=0.05,
                    help="mean logit-KL budget vs the binary32 reference")
    ap.add_argument("--sets", type=int, default=2,
                    help="calibration input sets (phase-2 joins across)")
    ap.add_argument("--prompts", type=int, default=4,
                    help="prompts per calibration set")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=4,
                    help="teacher-forced decode positions in the metric "
                         "(these are what make KV formats observable)")
    ap.add_argument("--kv-groups", type=int, default=2,
                    help="depth groups sharing one kv_cache binding")
    ap.add_argument("--max-rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    add_backend_args(ap, include_pool=False, include_policy=False)
    ap.add_argument("--out", default=None,
                    help="artifact path (default: print to stdout)")
    args = ap.parse_args(argv)

    model, cfg = build(args.arch, reduced=args.reduced)
    sets = synthetic_calibration(
        cfg, n_sets=args.sets, prompts_per_set=args.prompts,
        prompt_len=args.prompt_len, seed=args.seed)
    tuner = ServeTuner(model, cfg, sets, eps=args.eps,
                       decode_steps=args.decode_steps,
                       kv_groups=args.kv_groups,
                       max_rounds=args.max_rounds,
                       decode_impl=args.decode_impl,
                       matmul_impl=args.matmul_impl, seed=args.seed,
                       device=args.device)
    result = tuner.run()
    artifact = result.to_artifact()
    total = result.weight_bytes + result.kv_bytes_per_token
    total32 = result.weight_bytes_f32 + result.kv_bytes_per_token_f32
    print(f"[tune] {args.arch}: KL {result.final_kl:.3g} "
          f"(eps {args.eps:g}), {result.n_evals} evals, "
          f"formats {result.fmt_histogram()}, "
          f"bytes {total}/{total32} ({total / max(total32, 1):.2f}x f32), "
          f"energy {result.energy_pj_per_token:.3g}/"
          f"{result.energy_f32_pj_per_token:.3g} pJ/token, "
          f"device {tuner.device}, decode {result.decode_impl}")
    if args.out:
        save_artifact(artifact, args.out)
        print(f"[tune] wrote {args.out}")
    else:
        print(json.dumps(artifact, indent=1, sort_keys=True))
    return result


if __name__ == "__main__":
    main()
