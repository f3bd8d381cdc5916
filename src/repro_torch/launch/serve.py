"""Batched serving CLI over :mod:`repro_torch.engine`.

``python -m repro_torch.launch.serve --arch llama3-8b --decode-impl paged
--matmul-impl qmm_pallas``

The port of ``repro.launch.serve`` for this subset of its flags:
``--arch --reduced --requests --slots --prompt-len --max-new --capacity
--policy --decode-impl --matmul-impl --page-size --pool-pages
--prefill-chunk``, plus ``--device`` (default ``cuda``; raises when no
card is present unless ``--device cpu``), ``--seed`` (weights from a
``torch.Generator``, prompts from numpy) and ``--stats-out``.  It prints
the same ``[serve] ... tok/s ...`` summary line, and :func:`main`
returns the ``Request`` list.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.policy import get_policy
from repro_torch.engine import Engine, EngineStats, Request
from repro_torch.kernels import dispatch
from repro_torch.launch.cli import add_backend_args
from repro_torch.models import qparams
from repro_torch.models.registry import build

__all__ = ["Request", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=128)
    add_backend_args(ap, include_pool=True)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens prefilled per engine step (default: one "
                         "page)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--stats-out", default=None,
                    help="write per-step engine stats as JSON lines here")
    return ap.parse_args(argv)


def main(argv=None, *, params=None):
    """Serve ``--requests`` random prompts; returns the Request list.

    ``params``: a ready param tree (e.g. weights carried across from the
    JAX package by ``models/convert.py``) to serve instead of random
    weights from ``--seed``; it is packed here like random ones."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    decode_impl = args.decode_impl or dispatch.default_serving_impl(device)
    policy = get_policy(args.policy, decode_impl=decode_impl,
                        matmul_impl=args.matmul_impl)
    model, cfg = build(args.arch, reduced=args.reduced)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init_params(gen, policy, device=device)
    if (policy.matmul_impl or cfg.matmul_impl) == "qmm_pallas":
        packed = qparams.encode_params(params, policy)
        print(f"[serve] {qparams.describe_packing(params, packed)}")
        params = packed
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, min(cfg.vocab, 97),
                                    args.prompt_len).tolist(),
                    args.max_new)
            for i in range(args.requests)]

    engine = Engine(model, cfg, policy, params, slots=args.slots,
                    capacity=args.capacity, page_size=args.page_size,
                    pool_pages=args.pool_pages,
                    prefill_chunk=args.prefill_chunk,
                    stats=EngineStats(args.stats_out), device=device)
    engine.run(reqs)

    s = engine.summary
    st = engine.pool.stats()
    total_tokens = sum(len(r.generated) for r in reqs)
    dt = max(s["elapsed_s"], 1e-9)
    kv_fmts = sorted({policy.fmt("kv_cache", layer=li).name
                      for li in range(cfg.n_layers)})
    kv_desc = kv_fmts[0] if len(kv_fmts) == 1 \
        else "per-layer[" + ",".join(kv_fmts) + "]"
    print(f"[serve] {len(reqs)} requests, {total_tokens} tokens, "
          f"{engine.decode_steps} batched steps, "
          f"{total_tokens / dt:.1f} tok/s "
          f"(kv format: {kv_desc}, "
          f"decode: {policy.decode_impl or cfg.decode_impl}, "
          f"matmul: {policy.matmul_impl or cfg.matmul_impl}, "
          f"page_size: {engine.page}, pool: {st['peak_pages_used']}/"
          f"{st['num_pages']} pages peak, frag: "
          f"{st['internal_fragmentation']}, "
          f"evictions: {s['evictions']}, "
          f"transport: {engine.transport.name}, "
          f"device: {device}, "
          f"ttft mean: {s['ttft_mean_s']}s, "
          f"peak prefill staging: {s['peak_prefill_transient_tokens']} "
          f"tokens)")
    return reqs


def cli_main(argv=None) -> int:
    reqs = main(argv)
    return 1 if any(r.failed for r in reqs) else 0


if __name__ == "__main__":
    sys.exit(cli_main())
