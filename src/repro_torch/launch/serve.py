"""Batched serving CLI over :mod:`repro_torch.engine`.

``python -m repro_torch.launch.serve --arch llama3-8b --decode-impl paged
--matmul-impl qmm_pallas``

The port of ``repro.launch.serve``: every flag of the reference's dense
path -- ``--arch --reduced --requests --slots --prompt-len --max-new
--capacity --policy (a registry name or a tuned artifact path)
--decode-impl --matmul-impl --page-size --pool-pages --prefill-chunk
(0 = whole-prompt prefill) --disaggregate --stats-out``, the router's
``--router --prefill-workers --max-pending``, the speculative
``--speculate-k --draft-config`` and the resilience ``--fault-plan
--deadline-steps --max-requeues --watchdog-s`` -- plus ``--kv-fmt``
(a named policy's KV format), ``--set key=value`` (a model-config
override, as the reference's dry-run takes it: ``--set rwkv_fused=1``
serves the fused rwkv6 experiment), ``--device`` (default ``cuda``; raises when
no card is present unless ``--device cpu``) and ``--seed`` (weights from
a ``torch.Generator``, prompts from numpy).  It prints the reference's
``[serve]`` lines (the summary, and the ``router:`` and ``resilience:``
lines where they apply); :func:`main` returns the ``Request`` list and
:func:`cli_main` maps a classified engine error to its exit code (70-76)
and one structured stderr line.

A prefix-LM arch (``--arch paligemma-3b``) serves each prompt after
its ``prefix_len`` zero stub patch embeddings, prefilled whole, with
the prefix rows kept in the page pool: ``--capacity`` must hold prefix
+ prompt + ``--max-new`` rows (the engine's feasibility check counts
them).

``--disaggregate`` streams finished KV pages from a private prefill pool
into the decode pool (``StreamedTransport``, CRC-checked): with two or
more cards worker i's pool sits on card 1 + i mod (cards - 1), on one
card beside the decode pool.  It refuses a mesh-wrapped decode spelling
(``flash_shmap[+...]``, ``ring[+...]``), whose pool would be sharded
across the mesh, as the reference does.  The wrapped spellings shard
under a mesh the caller makes ambient (``launch/mesh.use_mesh``) around
:func:`main`, and run their base unsharded without one.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.formats import BINARY8
from repro_torch.core.policy import get_policy
from repro_torch.engine import (ColocatedTransport, Engine, EngineStats,
                                FaultPlan, Request, SpeculativeDecoder,
                                StreamedTransport, exit_code_for,
                                format_error, run_router)
from repro_torch.kernels import dispatch
from repro_torch.launch.cli import (add_backend_args, add_resilience_args,
                                    add_router_args, add_set_arg,
                                    add_speculative_args, parse_overrides)
from repro_torch.models import qparams
from repro_torch.models.registry import build
from repro_torch.models.transformer import Model
from repro_torch.tuning.artifact import load_policy

__all__ = ["Request", "build_draft", "cli_main", "main"]


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
    add_set_arg(ap)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=128)
    add_backend_args(ap, include_pool=True)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens prefilled per engine step (default: one "
                         "page; 0 = whole-prompt prefill)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill into a private pool and stream finished "
                         "KV pages into the decode pool (CRC-checked; on "
                         "a second card when there is one)")
    ap.add_argument("--stats-out", default=None,
                    help="write per-step engine stats as JSON lines here")
    add_router_args(ap)
    add_speculative_args(ap)
    add_resilience_args(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    return ap.parse_args(argv)


def _transports(args, device):
    """One transport per prefill worker: streamed ones with
    ``--disaggregate`` (worker i's pool on card 1 + i mod (cards - 1)
    when there are two or more, else on the decode card)."""
    n = args.prefill_workers
    if not args.disaggregate:
        return [ColocatedTransport() for _ in range(n)]
    ndev = torch.cuda.device_count() if device.type == "cuda" else 1
    return [StreamedTransport(device_index=(1 + i % (ndev - 1))
                              if ndev > 1 else 0) for i in range(n)]


def main(argv=None, *, params=None):
    """Serve ``--requests`` random prompts; returns the Request list.

    ``params``: a ready param tree (random weights made once and served
    several times, or weights carried across from the JAX package by
    ``models/convert.py``) to serve instead of random weights from
    ``--seed``; unpacked leaves are packed here like random ones, packed
    ones (``QTensor``) are served as they are."""
    args = parse_args(argv)
    if args.prefill_workers < 1:
        raise ValueError(
            f"--prefill-workers must be >= 1, got {args.prefill_workers}")
    device = resolve_device(args.device)
    # an artifact pins its knobs: only the explicit flags take part in
    # the conflict check, and the serving default fills in afterwards
    policy = load_policy(args.policy, decode_impl=args.decode_impl,
                         matmul_impl=args.matmul_impl, kv_fmt=args.kv_fmt)
    if policy.decode_impl is None:
        impl = dispatch.default_serving_impl(device)
        if impl is not None:
            policy = dataclasses.replace(policy, decode_impl=impl)
    model, cfg = build(args.arch, reduced=args.reduced)
    if args.set:
        cfg = dataclasses.replace(cfg, **parse_overrides(args.set))
        model = Model(cfg)
    effective_impl = policy.decode_impl or cfg.decode_impl
    if args.disaggregate and len(dispatch.canonicalize_impl(
            effective_impl)) > 1:
        raise ValueError(
            f"--disaggregate streams pages between single-device pools; "
            f"mesh-sharded spelling {effective_impl!r} keeps the pool "
            f"sharded across the mesh -- use a base spelling "
            f"(xla / flash_pallas / paged)")
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

    fault_plan = None
    if args.fault_plan:
        fault_plan = FaultPlan.load(args.fault_plan)
        print(f"[serve] fault plan: {fault_plan.describe()}")

    transports = _transports(args, device)
    engine = Engine(model, cfg, policy, params, slots=args.slots,
                    capacity=args.capacity, page_size=args.page_size,
                    pool_pages=args.pool_pages,
                    prefill_chunk=args.prefill_chunk,
                    transport=transports,
                    stats=EngineStats(args.stats_out),
                    speculative=speculative, fault_plan=fault_plan,
                    deadline_steps=args.deadline_steps,
                    max_requeues=args.max_requeues,
                    watchdog_s=args.watchdog_s, device=device)
    if args.router:
        # async front-end: submissions flow through the Router's queue
        # into the same engine; a ticket's classified per-request failure
        # comes back on the Request, engine-fatal errors raise here
        asyncio.run(run_router(engine, reqs, max_pending=args.max_pending))
        print(f"[serve] router: {args.prefill_workers} prefill worker(s), "
              f"queue wait mean: {engine.summary['queue_wait_mean_s']}s, "
              f"per-worker prefill chunks: "
              f"{engine.summary['prefill_chunks_by_worker']}")
    else:
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
    if fault_plan is not None or s["failures"] or s["faults_injected"]:
        print(f"[serve] resilience: faults={s['faults_injected']} "
              f"(unfired: {s['faults_unfired']}), "
              f"retries={s['retries']}, "
              f"crc_mismatches={s['crc_mismatches']}, "
              f"quarantines={s['quarantines']}, "
              f"degraded_steps={s['degraded_steps']}, "
              f"breaker_trips={s['breaker_trips']}, "
              f"deadline_misses={s['deadline_misses']}, "
              f"dead_letters={s['dead_letters']}, "
              f"failures={s['failures']}")
    return reqs


def cli_main(argv=None, *, params=None) -> int:
    """Process entry point: a classified engine error becomes its exit
    code (70-76) plus one structured stderr line instead of a traceback.
    In-process callers use :func:`main`, which raises."""
    try:
        reqs = main(argv, params=params)
    except Exception as e:  # noqa: BLE001 -- classified errors only
        code = exit_code_for(e)
        if code is None:
            raise  # a real bug deserves its traceback
        print(format_error(e), file=sys.stderr)
        return code
    failed = [r for r in reqs if r.error is not None]
    if failed:
        # requests that failed with classified results (deadline misses,
        # dead letters): the run completed, but the process should not
        # exit 0 -- report the most severe class
        worst = max(failed, key=lambda r: exit_code_for(r.error) or 0)
        print(format_error(worst.error, requests=len(failed)),
              file=sys.stderr)
        return exit_code_for(worst.error) or 70
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
