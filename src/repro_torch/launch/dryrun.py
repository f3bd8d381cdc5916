"""The dry-run: every (config x shape x mesh) cell's step run on
``meta`` tensors, its operations, bytes, collectives and roofline per
rank counted, nothing allocated and nothing launched.  The port of
``repro.launch.dryrun``, with its cells, keys and CLI flags.

``python -m repro_torch.launch.dryrun --all --mesh single --out DIR``

The reference lowers and compiles each cell for 512 host devices and
reads XLA's cost analysis of the SPMD-partitioned HLO.  The port has no
compiler: it runs the cell's step once, on ``meta`` tensors, as rank 0
of the production mesh (``launch/mesh.production_shape``, a
``core/ambient_mesh.MeshShape``: dims without ranks), and counts what
runs:

* **operations per rank**: ``torch.utils.flop_counter.FlopCounterMode``
  over the aten ops, plus the operations the hand-written kernels'
  shape route records (``kernels/_route.py``: on ``meta`` a kernel's
  wrapper returns empty outputs and adds the operations and the bytes of
  its byte model to the count; no kernel launches, no plain version
  runs);
* **bytes per rank**: every aten op's input and output tensors (views
  and allocations excluded), plus the kernels' byte models;
* **collectives per rank**: each collective of ``core/collectives.py``
  and of the decode wrappers records its kind and its result's bytes
  (``launch/hlo_analysis.collective_stats``);
* **memory**: the rank's argument bytes (its blocks of every input by
  the sharding rules: ``tree_param_shardings`` / ``tree_state_shardings``
  / ``batch_spec``), what its compute holds of them after the gathers
  (``gathered_argument_bytes``: every dim split over ``model`` gathered,
  the rank's rows kept), and its output bytes.  Nothing on ``meta``
  gives temporaries or a peak, so those keys of the reference are left
  out.

*The step is the port's own.*  The train cell runs
``launch/train.make_train_step(model, policy, lr, mesh, shardings)``: it
stores params and AdamW state as the rank's blocks, gathers every param
for the compute and runs the whole model on the rank's rows (ROADMAP
Queue 3 item 11).  Prefill, decode and the speculative verify follow
the same convention: the rank's blocks are gathered over ``model``, the
model runs ``prefill`` / ``decode_step`` / ``verify_step`` on the rank's
rows of the batch (``use_mesh(mesh, batch_split=...)``), and the states
it returns are narrowed back to the rank's blocks.  So a rank's
operations are the whole model's on its rows, and ``useful_flops_ratio``
comes out near 1 / (the ``model`` dim's size): the port's own number, not
a fault of the count.

Decode cells attend over a cache of ``seq_len`` rows holding
``seq_len - 1`` tokens; a ``meta`` tensor holds no lengths, so the
attention kernels' byte models count every cached row (the most the
shapes allow), as the reference's static cost analysis does.  Params
are made on ``meta`` (``init_params(None, policy, device="meta")``) and
packed under ``matmul_impl="qmm_pallas"``, as ``launch/serve.py`` packs
them.

Results go to ``--out`` (default ``results/dryrun_torch``; the
reference's sweep lives in ``results/dryrun``), one JSON a cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.shapes import (ALL_SHAPES, SHAPES, runnable,
                                        skip_reason)
from repro_torch.core.ambient_mesh import MeshShape, use_mesh
from repro_torch.core.collectives import (all_gather_cat, as_axes,
                                          block_shape, local_block,
                                          sharded_dims)
from repro_torch.core.qtensor import QTensor
from repro_torch.core.tree import flatten_with_path, unflatten
from repro_torch.kernels import _route, paged_cache
from repro_torch.launch import hlo_analysis, sharding
from repro_torch.launch.cli import (add_backend_args, add_set_arg,
                                    parse_overrides)
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.train import make_train_step, shardings_for
from repro_torch.models import qparams
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.tuning.artifact import is_artifact_spec, load_policy

META = torch.device("meta")
aten = torch.ops.aten
# allocations and metadata: no bytes move
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.detach,
         aten.alias, aten.lift_fresh}


def production_mesh(multi_pod: bool) -> MeshShape:
    """The reference's production mesh as dims without ranks."""
    shape, axes = production_shape(multi_pod)
    return MeshShape(tuple(axes), tuple(shape))


# ---------------------------------------------------------------------------
# trees of blocks (packed leaves and Python numbers included)
# ---------------------------------------------------------------------------

def _on_payload(fn, t):
    if isinstance(t, QTensor):
        return QTensor(fn(t.payload), t.fmt)
    if isinstance(t, torch.Tensor):
        return fn(t)
    return t                                   # a cache's ``pos``


def tree_blocks(tree, shardings):
    """Every leaf of a full tree narrowed to rank 0's block."""
    return unflatten(tree, [
        _on_payload(lambda x: local_block(x, s.spec, s.mesh), t)
        for (_, t), (_, s) in zip(flatten_with_path(tree),
                                  flatten_with_path(shardings))])


def tree_gather_model(tree, shardings):
    """Every dim split over ``model`` gathered (one all-gather a split
    leaf); dims split over the data dims stay the rank's rows."""
    def one(t, s):
        if s is None:
            return t
        for d, axes in sharded_dims(s.spec):
            if "model" in axes:
                t = _on_payload(
                    lambda x: all_gather_cat(x, s.mesh, axes, dim=d), t)
        return t
    return unflatten(tree, [one(t, s) for (_, t), (_, s) in zip(
        flatten_with_path(tree), flatten_with_path(shardings))])


def _entries(spec, model: bool) -> tuple:
    """``spec`` with only the entries that name ``model`` (``model``
    True) or only the others."""
    return tuple(e if e is not None and ("model" in as_axes(e)) == model
                 else None for e in spec)


def tree_bytes(tree, shardings=None, *, gathered: bool = False) -> int:
    """Bytes of a tree's tensors (packed leaves at container width): the
    full tensors, rank 0's blocks (``shardings``), or with ``gathered``
    the blocks with their ``model`` dims whole."""
    total = 0
    pairs = flatten_with_path(tree)
    specs = [None] * len(pairs) if shardings is None else \
        [s for _, s in flatten_with_path(shardings)]
    for (_, t), s in zip(pairs, specs):
        t = t.payload if isinstance(t, QTensor) else t
        if not isinstance(t, torch.Tensor):
            continue
        shape = tuple(t.shape)
        if s is not None:
            spec = _entries(s.spec, False) if gathered else s.spec
            shape = block_shape(shape, spec, s.mesh)
        total += math.prod(shape) * t.element_size()
    return total


# ---------------------------------------------------------------------------
# input specs (meta stand-ins; no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_shardings(batch: dict, mesh) -> dict:
    B = batch["tokens"].shape[0]
    return {k: sharding.NamedSharding(
        mesh, sharding.batch_spec(B, mesh, extra_dims=v.dim() - 1))
        for k, v in batch.items()}


def batch_struct(cfg, B: int, S: int, *, with_labels: bool) -> dict:
    d: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if with_labels:
        d["labels"] = _meta((B, S), torch.int32)
    if cfg.prefix_len:
        d["prefix_embeds"] = _meta((B, cfg.prefix_len, cfg.d_model),
                                   torch.float32)
    if cfg.encoder_layers:
        d["encoder_embeds"] = _meta((B, cfg.encoder_len, cfg.d_model),
                                    torch.float32)
    return d


def input_specs(arch: str, shape_name: str, mesh, policy,
                cfg_overrides=None, speculate_k: int = 0,
                reduced: bool = False):
    """``(model, cfg, args, shardings)``: meta stand-ins of every input
    of the cell at its global shapes, and their shardings on ``mesh``
    (``reduced``: the config's small version, for tests)."""
    cfg = configs.get(arch, reduced=reduced)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    spec = ALL_SHAPES[shape_name]
    model = Model(cfg)
    params = model.init_params(None, policy, device=META)
    if cfg.matmul_impl == "qmm_pallas":
        # the serving store: the cell reads the packed (container-width)
        # weights, as launch/serve.py packs them at load
        params = qparams.encode_params(params, policy)
    B, S = spec.global_batch, spec.seq_len

    if spec.kind == "train":
        p_sh, o_sh = shardings_for(params, policy, mesh)
        opt = adamw.init(params, policy)
        batch = batch_struct(cfg, B, S, with_labels=True)
        return model, cfg, {"params": params, "opt": opt, "batch": batch}, \
            {"params": p_sh, "opt": o_sh,
             "batch": _batch_shardings(batch, mesh)}

    p_sh = sharding.tree_param_shardings(params, mesh)
    if spec.kind == "prefill":
        batch = batch_struct(cfg, B, S, with_labels=False)
        return model, cfg, {"params": params, "batch": batch}, \
            {"params": p_sh, "batch": _batch_shardings(batch, mesh)}

    if speculate_k:
        # the verify half of a speculation round: k tokens a sequence
        # against the engine's paged cache
        if (cfg.encoder_layers or cfg.prefix_len
                or any(k != "attn" for k in cfg.attn_pattern)):
            raise ValueError(
                f"--speculate-k: arch {arch} is not an all-attention "
                f"decoder (verify_step cannot roll back recurrent / "
                f"prefix state)")
        page = paged_cache.DEFAULT_PAGE_SIZE
        pps = -(-S // page)
        states = [paged_cache.init_paged_cache(
            B, B * pps, page, pps, cfg.n_kv, cfg.head_dim,
            policy.dtype("kv_cache", li), device=META)
            for li, _ in enumerate(cfg.attn_pattern)]
        tokens = _meta((B, speculate_k), torch.int32)
    else:
        # decode: one new token against a cache of seq_len rows
        states = [s._replace(pos=s.capacity - 1)
                  if isinstance(s, KVCache) else s
                  for s in model.init_state(B, S, policy, device=META)]
        tokens = _meta((B, 1), torch.int32)
    extra = {}
    if cfg.encoder_layers:
        extra["encoder_embeds"] = _meta((B, cfg.encoder_len, cfg.d_model),
                                        torch.float32)
    args = {"params": params, "tokens": tokens, "states": states,
            "extra": extra}
    shs = {"params": p_sh,
           "tokens": sharding.NamedSharding(
               mesh, sharding.batch_spec(B, mesh, extra_dims=1)),
           "states": sharding.tree_state_shardings(states, mesh, B),
           "extra": {k: sharding.NamedSharding(
               mesh, sharding.batch_spec(B, mesh, extra_dims=2))
               for k in extra}}
    return model, cfg, args, shs


# ---------------------------------------------------------------------------
# step functions (rank 0's)
# ---------------------------------------------------------------------------

def make_step_fn(model, cfg, kind: str, policy, mesh, shardings,
                 lr: float = 3e-4, speculate_k: int = 0):
    """Rank 0's step over its blocks: the train step of
    ``launch/train.py``, or prefill / decode / verify on the rank's rows
    with every ``model`` split gathered and the states narrowed back to
    the rank's blocks."""
    if kind == "train":
        return make_train_step(model, policy, lr, mesh,
                               (shardings["params"], shardings["opt"]))

    def gather(name, tree):
        return tree_gather_model(tree, shardings[name])

    if kind == "prefill":
        split = _lead(shardings["batch"]["tokens"])

        def prefill_step(params, batch):
            with use_mesh(mesh, batch_split=split):
                logits, states = model.prefill(gather("params", params),
                                               batch, policy)
            st_sh = sharding.tree_state_shardings(
                states, mesh, batch["tokens"].shape[0])
            return logits, _narrow_model(states, st_sh)
        return prefill_step

    split = _lead(shardings["tokens"])

    def serve_step(params, tokens, states, extra):
        full = gather("params", params)
        st = gather("states", states)
        with use_mesh(mesh, batch_split=split):
            if speculate_k:
                logits, new = model.verify_step(full, tokens, st, policy)
            else:
                logits, new = model.decode_step(full, tokens, st, policy,
                                                **extra)
        return logits, _narrow_model(new, shardings["states"])
    return serve_step


def _lead(s) -> tuple:
    """The dims a leaf's dim 0 (the batch) is split over."""
    return as_axes(s.spec[0]) if s.spec and s.spec[0] is not None else ()


def _narrow_model(tree, shardings):
    """A tree of the rank's rows narrowed to its ``model`` blocks (no
    collective: each rank keeps its own block)."""
    def one(t, s):
        if s is None:
            return t
        spec = _entries(s.spec, True)
        return _on_payload(lambda x: local_block(x, spec, s.mesh), t)
    return unflatten(tree, [one(t, s) for (_, t), (_, s) in zip(
        flatten_with_path(tree), flatten_with_path(shardings))])


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

class ByteCount(TorchDispatchMode):
    """Bytes of every aten op's input and output tensors (views and
    allocations move none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _FREE:
            self.ops += 1
            for t in pytree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def model_flops(cfg, spec, speculate_k: int = 0) -> float:
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        return 6.0 * n_active * spec.global_batch * spec.seq_len
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.global_batch * spec.seq_len
    # decode: one token per seq; verify: k tokens per seq in one step
    return 2.0 * n_active * spec.global_batch * max(speculate_k, 1)


# ---------------------------------------------------------------------------
# one dry-run cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             policy_name: str = "transprecision",
             cfg_overrides=None, kv_fmt=None, tag: str = "",
             speculate_k: int = 0, mesh=None, reduced: bool = False,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell: its record as the reference writes it.  ``mesh`` (a
    ``MeshShape``) replaces the production mesh and ``reduced`` takes the
    config's small version (tests use both)."""
    spec = ALL_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if not runnable(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "policy": policy_name, "status": "skipped",
                "reason": skip_reason(arch, shape_name)}
    if speculate_k and spec.kind != "decode":
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "policy": policy_name, "status": "skipped",
                "reason": "--speculate-k runs the verify step of a "
                          "speculation round; only serve shapes decode"}
    cfg_overrides = {**spec.cfg_overrides(), **(cfg_overrides or {})}
    policy = load_policy(policy_name, kv_fmt=kv_fmt)
    mesh = production_mesh(multi_pod) if mesh is None else mesh
    n_chips = math.prod(mesh.sizes)
    t0 = time.time()
    model, cfg, ins, shs = input_specs(arch, shape_name, mesh, policy,
                                       cfg_overrides,
                                       speculate_k=speculate_k,
                                       reduced=reduced)
    step = make_step_fn(model, cfg, spec.kind, policy, mesh, shs,
                        speculate_k=speculate_k)
    names = {"train": ("params", "opt", "batch"),
             "prefill": ("params", "batch")}.get(
        spec.kind, ("params", "tokens", "states", "extra"))
    # the train step is handed the global batch and takes its rows itself
    blocks = [ins[n] if n == "batch" and spec.kind == "train"
              else tree_blocks(ins[n], shs[n]) for n in names]
    arg_bytes = sum(tree_bytes(ins[n], shs[n]) for n in names)
    gathered = sum(tree_bytes(ins[n], shs[n], gathered=n in (
        "params", "states")) for n in names)
    t_setup = time.time() - t0
    with FlopCounterMode(display=False) as fc, ByteCount() as bc, \
            _route.count_costs() as cost:
        out = step(*blocks)
    t_run = time.time() - t0 - t_setup

    coll = hlo_analysis.collective_stats(cost)
    coll_bytes = hlo_analysis.total_collective_bytes(coll)
    flops_dev = float(fc.get_total_flops()) + cost.flops
    bytes_dev = float(bc.bytes) + cost.bytes
    mf = model_flops(cfg, spec, speculate_k)
    terms = hlo_analysis.roofline(flops_dev, bytes_dev, coll_bytes, n_chips,
                                  mf)
    mem = {"argument_size_in_bytes": float(arg_bytes),
           "output_size_in_bytes": float(tree_bytes(list(out))),
           "gathered_argument_bytes": float(gathered)}
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.sizes)),
        "n_chips": n_chips, "policy": policy_name, "status": "ok",
        "kind": "verify" if speculate_k else spec.kind,
        "speculate_k": speculate_k,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_bytes,
        "collectives": coll,
        "kernels": {k: dict(v) for k, v in sorted(cost.kernels.items())},
        "aten_flops_per_device": float(fc.get_total_flops()),
        "aten_bytes_per_device": float(bc.bytes),
        "aten_ops": bc.ops,
        "roofline": terms,
        "memory": mem,
        "setup_s": round(t_setup, 2), "run_s": round(t_run, 2),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "overrides": cfg_overrides or {}, "tag": tag,
    }
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_name}"
              f"{tuple(mesh.sizes)} [{policy_name}] ==")
        print("memory:", mem)
        print("counts: flops/dev=%.3e bytes/dev=%.3e" % (flops_dev,
                                                         bytes_dev))
        print("collectives:", {k: v for k, v in coll.items() if v["count"]})
        print("roofline:", {k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in terms.items()})
    return result


# ---------------------------------------------------------------------------
# the sweep over cells (the CLI)
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description="dry-run on meta tensors")
    ap.add_argument("--arch", default=None, choices=configs.ARCHS)
    ap.add_argument("--shape", default=None, choices=list(ALL_SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    add_set_arg(ap)
    add_backend_args(ap, include_pool=False)
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="run the k-token speculative verify step instead "
                         "of single-token decode for decode-kind shapes "
                         "(paged-cache stand-ins)")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    if args.decode_impl is not None:
        overrides["decode_impl"] = args.decode_impl
    if args.matmul_impl is not None:
        overrides["matmul_impl"] = args.matmul_impl
    if is_artifact_spec(args.policy):
        # fail fast (before the sweep) on overrides the artifact pins
        load_policy(args.policy, decode_impl=args.decode_impl,
                    matmul_impl=args.matmul_impl, kv_fmt=args.kv_fmt)
        policy_tag = os.path.splitext(os.path.basename(args.policy))[0]
    else:
        policy_tag = args.policy

    archs = configs.ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = (f"{arch}__{shape}__{'multi' if mp else 'single'}"
                       f"__{policy_tag}"
                       + (f"__{args.tag}" if args.tag else ""))
                fn = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(fn):
                    print("cached:", tag)
                    continue
                try:
                    res = run_cell(arch, shape, multi_pod=mp,
                                   policy_name=args.policy,
                                   cfg_overrides=overrides or None,
                                   kv_fmt=args.kv_fmt,
                                   speculate_k=args.speculate_k,
                                   tag=args.tag)
                except Exception as e:  # record failures, keep sweeping
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "policy": args.policy, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures.append(tag)
                    print("FAILED:", tag, res["error"])
                with open(fn, "w") as f:
                    json.dump(res, f, indent=1)
                results.append(res)
    if failures:
        print(f"\n{len(failures)} failures: {failures}")
        raise SystemExit(1)
    print("\nall cells ok")
    return results


if __name__ == "__main__":
    main()
