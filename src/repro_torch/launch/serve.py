"""Batched serving CLI over :mod:`repro_torch.engine`.

``python -m repro_torch.launch.serve --arch llama3-8b --decode-impl paged
--matmul-impl qmm_pallas``

The port of ``repro.launch.serve`` for this subset of its flags:
``--arch --reduced --requests --slots --prompt-len --max-new --capacity
--policy --decode-impl --matmul-impl --page-size --pool-pages
--prefill-chunk --speculate-k --draft-config``, plus ``--device``
(default ``cuda``; raises when no card is present unless ``--device
cpu``), ``--seed`` (weights from a
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
from repro_torch.core.formats import BINARY8
from repro_torch.core.policy import get_policy
from repro_torch.engine import (Engine, EngineStats, Request,
                                SpeculativeDecoder)
from repro_torch.kernels import dispatch
from repro_torch.launch.cli import add_backend_args, add_speculative_args
from repro_torch.models import qparams
from repro_torch.models.registry import build

__all__ = ["Request", "build_draft", "main"]


def build_draft(model, cfg, *, arch=None, reduced=False, k: int,
                seed: int = 0, device=None, matmul_impl=None):
    """The binary8 packed draft side for speculative serving, with the
    reference's draft policy: ``transprecision`` with binary8
    ``embed_w`` / ``attn_w`` / ``ffn_w``, ``decode_impl="paged"``, weights
    packed.  By default the draft is the target's arch with weights from
    the target's seed (the same values, rounded to binary8); ``arch``
    swaps in another arch, whose vocab must match.  The draft follows the
    target's ``matmul_impl``, so on a card it streams its packed weights
    through the qmm kernel."""
    dmodel, dcfg = model, cfg
    if arch is not None and arch != cfg.arch:
        dmodel, dcfg = build(arch, reduced=reduced)
    dpolicy = get_policy("transprecision", decode_impl="paged",
                         matmul_impl=matmul_impl).with_overrides(
        embed_w=BINARY8, attn_w=BINARY8, ffn_w=BINARY8)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dparams = dmodel.init_params(gen, dpolicy, device=device)
    dparams = qparams.encode_params(dparams, dpolicy)
    return SpeculativeDecoder(dmodel, dcfg, dpolicy, dparams, k=k)


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
    add_speculative_args(ap)
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

    speculative = None
    if args.speculate_k:
        speculative = build_draft(model, cfg, arch=args.draft_config,
                                  reduced=args.reduced, k=args.speculate_k,
                                  seed=args.seed, device=device,
                                  matmul_impl=policy.matmul_impl)
        print(f"[serve] speculative: draft={speculative.cfg.arch} "
              f"(binary8 packed weights, binary8 KV), k={args.speculate_k}")

    engine = Engine(model, cfg, policy, params, slots=args.slots,
                    capacity=args.capacity, page_size=args.page_size,
                    pool_pages=args.pool_pages,
                    prefill_chunk=args.prefill_chunk,
                    stats=EngineStats(args.stats_out),
                    speculative=speculative, device=device)
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
          + (f"accept rate: {s['accept_rate']}, "
             f"steps/token: {s['steps_per_token']}, "
             if args.speculate_k else "")
          + f"transport: {engine.transport.name}, "
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
