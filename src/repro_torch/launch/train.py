"""Training: the port of ``repro.launch.train``, on one device or on a
``("data", "model")`` mesh of ``torch.distributed`` ranks.

``python -m repro_torch.launch.train --arch llama3-8b --reduced --steps 200``

The reference's flags (``--arch --reduced --steps --batch --seq --lr
--policy --ckpt-dir --ckpt-every --resume --log-every``) plus
``--device`` (default ``cuda``; raises when no card is present unless
``--device cpu``), ``--moe-impl`` (``shard_map``: expert-parallel MoE
layers), ``--compress-grads`` (the data-parallel gradient reduction in
binary8 with error feedback) with ``--stochastic-rounding``, and the
process group's ``--init-method --world-size --rank``.  Random weights
from seed 0, the synthetic stream of ``data/pipeline.py``, AdamW in the
policy's state formats, an async checkpoint every ``--ckpt-every``
steps and at the end (keep-last-3, atomic), ``--resume`` from the
newest one, a step-time watchdog, a checkpoint and exit on SIGTERM, and
an error on a non-finite loss.  :func:`main` returns the losses of the
steps it ran.

*The process group* starts only when asked: by the three flags, or by
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); a
group the caller already started is used as it is.  With none the CLI
runs on the (1, 1) grid of one device; with one it takes
``runtime/elastic.make_elastic_mesh``'s grid over the ranks (gloo on the
CPU, NCCL on cards, one card a rank).  Either way it runs the one step
below, and the ``[train]`` line prints the mesh.  A stop on SIGTERM is
agreed across the ranks once a step (the flag's maximum), so every rank
takes part in the same checkpoint.

*The step* (:func:`make_train_step`): params and AdamW state are stored
as each rank's blocks by ``tree_param_shardings``; each rank takes its
rows of ``data.batch_at(step)`` by ``batch_spec`` over the data-parallel
dims; the forward and backward run on the gathered params and the local
rows (an expert-parallel MoE keeps its expert leaves as the rank's
blocks: its experts are the rank's own); the cross-entropy is divided by
the global count over the data shards, so the shards' losses average to
the global-batch mean; the gradients are averaged over the data-parallel
dims (or reduced in binary8 with error feedback); the clip factor comes
from the whole gradient, a sharded leaf's blocks summed over their dims
and a replicated leaf counted once; AdamW updates each rank's blocks.  A
dim of one rank runs no collective, so on the (1, 1) grid every block is
the whole leaf and the step is one device's.  With ``--compress-grads``
the checkpoint also holds every rank's residuals and stochastic
generator (``ErrorFeedback``), restored on ``--resume`` when the data
shards and the rounding are the same, else started at zero.

*A departure from the reference:* its GSPMD step also partitions the
compute (column- and row-parallel products, one all-reduce a block).
The port partitions storage only and gathers every param for the
compute, so each rank's forward and backward are the whole model's on
its rows; the sums of a sharded product are a single device's.

Attention follows the config and the policy (``xla`` unless the policy
names ``flash_pallas``, whose training forward is the ``flash_prefill``
kernel and its backward a plain recompute); the ``[train]`` line says
which ran.  The forward's fused norms are ``add_rmsnorm`` /
``add_layernorm`` launches with a plain recompute backward.

On the card the step is deterministic: its CUDA ops that scatter in the
backward write distinct places (the loss's ``gather`` picks one label a
row; an index's backward, the embedding's included, accumulates through
torch's sort-based ``index_put_``), so a resumed run repeats the
uninterrupted one bit for bit, with compressed gradients too.  The
weights are plain tensors and every product a ``torch.matmul``, as the
reference's ``jnp.dot``s under ``matmul_impl="xla"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import tempfile

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import collectives as coll
from repro_torch.core.ambient_mesh import (MeshShape, axis_names, axis_size,
                                           dp_axes, dp_size, use_mesh)
from repro_torch.core.policy import get_policy
from repro_torch.core.tree import (flatten_with_path, leaves, tree_map,
                                   unflatten)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import sharding
from repro_torch.models import attention as attn
from repro_torch.models.registry import build
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import compressed_psum
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.runtime.watchdog import StepWatchdog


def loss_and_grads(model, params, batch, policy, loss_count=None):
    """The loss and the gradient of every param leaf (zeros for a leaf
    the loss does not read, as ``jax.grad`` gives), by autograd.
    ``loss_count`` divides the summed cross-entropy in place of the
    batch's own count (``Model.train_loss``)."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = model.train_loss(unflatten(params, live), batch, policy,
                            loss_count=loss_count)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), unflatten(params, grads)


_EXPERTS = ("w_in", "w_gate", "w_out")
GRAD_CLIP = 1.0                # adamw.apply's default
ONE_DEVICE = MeshShape(("data", "model"), (1, 1))


def _keeps_block(cfg, path, spec) -> bool:
    """An expert leaf the expert-parallel MoE takes as the rank's block
    (no gather): a 3-D ``w_in`` / ``w_gate`` / ``w_out`` sharded over
    ``model`` on its expert dim."""
    return cfg.moe_impl == "shard_map" and len(spec) == 3 \
        and spec[0] == "model" and path[-1][1] in _EXPERTS


def shardings_for(params, policy, mesh):
    """``(param shardings, AdamW-state shardings)`` of a full param tree
    (real or ``meta``) on ``mesh``: the rules applied to the full shapes,
    the state's through an AdamW state of ``meta`` leaves."""
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)
    return (sharding.tree_param_shardings(params, mesh),
            sharding.tree_param_shardings(adamw.init(meta, policy), mesh))


def sharded_clip_scale(grads, shardings, grad_clip: float) -> torch.Tensor:
    """``adamw.global_norm_scale`` of the whole gradient from the ranks'
    blocks: each leaf's squares summed over the block, then over the
    dims its spec shards (a replicated leaf counted once), the leaves
    added in tree order."""
    total = None
    for g, s in zip(leaves(grads), leaves(shardings)):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        for _, axes in sharding.sharded_dims(s.spec):
            sq = coll.all_reduce_sum(sq, s.mesh, axes)
        total = sq if total is None else total + sq
    return torch.clamp(grad_clip * torch.rsqrt(total + 1e-16), max=1.0)


class ErrorFeedback:
    """The compressed reduction's state: this rank's residual of every
    gradient block (None before the first step: zero), and, with a
    ``seed``, the generator of the stochastic words, one stream a data
    shard (seeded with (seed, data-shard index)): the model ranks of a
    shard draw the same words, so a replicated leaf stays one value."""

    def __init__(self, mesh, seed=None):
        self.mesh, self.seed = mesh, seed
        self.residuals = None
        self.gen = None

    def _generator(self, device):
        if self.seed is not None and self.gen is None:
            self.gen = torch.Generator(device=device).manual_seed(
                self.seed * 65536 + coll.axes_index(self.mesh,
                                                    dp_axes(self.mesh)))
        return self.gen

    def mean(self, blocks):
        """The blocks' mean over the data-parallel dims in binary8, the
        residuals carried to the next step."""
        dp, n_dp = dp_axes(self.mesh), dp_size(self.mesh)
        gen = self._generator(blocks[0].device)
        res = self.residuals or [None] * len(blocks)
        out, self.residuals = [], []
        with use_mesh(self.mesh):
            for g, r in zip(blocks, res):
                bits = None if gen is None else torch.randint(
                    -2 ** 31, 2 ** 31, g.shape, dtype=torch.int32,
                    device=g.device, generator=gen)
                s, nr = compressed_psum(g, r, dp, rbits=bits)
                out.append(s / n_dp)
                self.residuals.append(nr)
        return out

    def tag(self) -> dict:
        """What a checkpoint's state must match to be restored here."""
        return {"data_shards": dp_size(self.mesh),
                "stochastic": self.seed is not None}

    def state(self, params, p_sh):
        """``(tree, shardings)`` for a checkpoint: each residual stacked
        over the data shards (a leading dim split over the data-parallel
        dims, the rest as its param), and the generator's state as int32
        words a data shard."""
        dp = dp_axes(self.mesh)
        res = self.residuals or [
            torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in leaves(params)]
        tree = {"residuals": [r[None] for r in res]}
        shs = {"residuals": [sharding.NamedSharding(self.mesh, (dp,) + s.spec)
                             for s in leaves(p_sh)]}
        gen = self._generator(res[0].device)
        if gen is not None:
            tree["rng"] = gen.get_state().view(torch.int32)[None]
            shs["rng"] = sharding.NamedSharding(self.mesh, (dp, None))
        return tree, shs

    def load(self, tree):
        """The state of :meth:`state`'s tree, restored as this rank's."""
        self.residuals = [r[0] for r in tree["residuals"]]
        if "rng" in tree:
            self._generator(self.residuals[0].device).set_state(
                tree["rng"][0].to("cpu").view(torch.uint8))


def make_train_step(model, policy, lr, mesh=None, shardings=None, *,
                    compress: bool = False, stochastic_seed=None):
    """``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)`` on ``mesh`` (default: the (1, 1) grid of one device):
    ``params`` and ``opt_state`` are this rank's blocks (``shardings`` =
    ``shardings_for(...)``; default: the rules' on the first call's
    params), ``batch`` the global batch (every rank is handed all of it
    and takes its rows).  The loss returned is the global batch's.  On
    the (1, 1) grid every block is the whole leaf and no collective runs.
    ``compress`` reduces the gradients in binary8 with error feedback
    (``compressed_psum`` leaf by leaf, the state in ``train_step.ef``, an
    :class:`ErrorFeedback`); ``stochastic_seed`` rounds them
    stochastically, the words drawn on the device.  The step donates
    ``opt_state``, as the reference's jitted step does: its tensors are
    updated in place."""
    cfg = model.cfg
    mesh = ONE_DEVICE if mesh is None else mesh
    p_sh = None if shardings is None else shardings[0]
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)
    ef = ErrorFeedback(mesh, stochastic_seed) if compress else None

    def train_step(params, opt_state, batch):
        nonlocal p_sh
        if p_sh is None:
            p_sh = sharding.tree_param_shardings(params, mesh)
        B = batch["tokens"].shape[0]
        lead = sharding.batch_spec(B, mesh, extra_dims=0)[0]
        split = coll.as_axes(lead) if lead is not None else ()
        if cfg.moe_impl == "shard_map" and n_dp > 1 and split != dp:
            raise ValueError(f"the expert-parallel MoE needs the batch ({B}) "
                             f"to divide over every data-parallel dim {dp}")
        rows = sharding.batch_rows(batch, mesh)
        dev = rows["tokens"].device
        if "label_mask" in rows:
            own = torch.sum(rows["label_mask"].to(torch.float32))
        else:
            own = torch.tensor(float(rows["labels"].numel()),
                               dtype=torch.float32, device=dev)
        count = coll.all_reduce_sum(own, mesh, dp) / n_dp

        flat = flatten_with_path(params)
        specs = [s.spec for s in leaves(p_sh)]
        kept = [_keeps_block(cfg, p, sp) for (p, _), sp in zip(flat, specs)]
        with torch.no_grad():
            full = [t if k else sharding.gather_block(t, sp, mesh)
                    for (_, t), sp, k in zip(flat, specs, kept)]
        with use_mesh(mesh, batch_split=split):
            loss, grads = loss_and_grads(model, unflatten(params, full),
                                         rows, policy, loss_count=count)
        del full
        with torch.no_grad():
            blocks = [g if k else sharding.local_block(g, sp, mesh)
                      for g, sp, k in zip(leaves(grads), specs, kept)]
            del grads
            if ef is not None:
                blocks = ef.mean(blocks)
            elif n_dp > 1:
                blocks = [coll.all_reduce_sum(g, mesh, dp) / n_dp
                          for g in blocks]
            grads = unflatten(params, blocks)
            scale = sharded_clip_scale(grads, p_sh, GRAD_CLIP)
            _, new_opt = adamw.apply(grads, opt_state, policy, lr=lr,
                                     clip_scale=scale)
            new_params = adamw.materialize_params(new_opt, params, policy)
            loss = coll.all_reduce_sum(loss, mesh, dp) / n_dp
        return loss, new_params, new_opt

    train_step.ef = ef
    return train_step


def mesh_shape(mesh) -> dict:
    """A mesh's ``{dim name: size}``."""
    return {a: axis_size(mesh, a) for a in axis_names(mesh)}


def _start_process_group(args, device: torch.device) -> bool:
    """Start the default process group when asked (the flags, or
    torchrun's environment); returns whether this call started it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    env = os.environ
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if args.init_method is None and not torchrun:
        return False
    if args.init_method is not None:
        if args.world_size is None or args.rank is None:
            raise ValueError("--init-method needs --world-size and --rank")
        kw = dict(init_method=args.init_method, world_size=args.world_size,
                  rank=args.rank)
    else:
        kw = dict(init_method="env://")
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", kw.get("rank", env.get("RANK", 0))))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            **kw)
    return True


def _any_rank(flag: bool, sharded: bool, device) -> bool:
    """Whether any rank has ``flag`` set (every rank calls this once a
    step, so all of them act on a stop together: the checkpoint's
    gathers are collective)."""
    if not sharded:
        return flag
    import torch.distributed as dist
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default="transprecision",
                    choices=["transprecision", "binary32"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--moe-impl", default=None,
                    choices=["dense", "shard_map"],
                    help="an MoE config's dispatch (default: the "
                    "config's); shard_map is expert-parallel over the "
                    "mesh's model dim")
    ap.add_argument("--compress-grads", action="store_true",
                    help="reduce the data-parallel gradients in binary8 "
                    "with error feedback")
    ap.add_argument("--stochastic-rounding", type=int, default=None,
                    metavar="SEED", help="with --compress-grads, round "
                    "stochastically with words from this seed")
    ap.add_argument("--init-method", default=None,
                    help="start a process group at this rendezvous "
                    "(tcp://host:port or file://path)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    if args.stochastic_rounding is not None and not args.compress_grads:
        ap.error("--stochastic-rounding needs --compress-grads")

    device = resolve_device(args.device)
    started = _start_process_group(args, device)
    try:
        return _run(args, device)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, device):
    import torch.distributed as dist

    sharded = dist.is_available() and dist.is_initialized()
    if args.compress_grads and not sharded:
        raise ValueError("--compress-grads reduces the gradients over the "
                         "data ranks: start a process group (--init-method "
                         "--world-size --rank, or torchrun)")
    if sharded and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = not sharded or dist.get_rank() == 0
    policy = get_policy(args.policy)
    model, cfg = build(args.arch, reduced=args.reduced)
    if args.moe_impl is not None and args.moe_impl != cfg.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
        model = type(model)(cfg)
    mesh = make_elastic_mesh(device=device)
    if rank0:
        print(f"[train] arch={args.arch} params={cfg.param_count():,} "
              f"mesh={mesh_shape(mesh)} policy={args.policy} "
              f"attention={attn.decode_impl(cfg, policy)} device={device}"
              + (f" moe={cfg.moe_impl}" if cfg.moe_experts else "")
              + (" grads=binary8" if args.compress_grads else ""))

    data = SyntheticLM(DataConfig(global_batch=args.batch,
                                  seq_len=args.seq), cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, policy, device=device)
    shardings = shardings_for(params, policy, mesh)
    params = sharding.tree_local_blocks(params, shardings[0])
    opt_state = adamw.init(params, policy)
    step_fn = make_train_step(model, policy, args.lr, mesh, shardings,
                              compress=args.compress_grads,
                              stochastic_seed=args.stochastic_rounding)
    ef = step_fn.ef

    def save(step, loss):
        tree, shs = (params, opt_state), shardings
        extra = {"data": data.state(step), "loss": loss}
        if ef is not None:
            ef_tree, ef_sh = ef.state(params, shardings[0])
            tree, shs = tree + (ef_tree,), shs + (ef_sh,)
            extra["error_feedback"] = ef.tag()
        ckpt.save(step, tree, extra=extra, shardings=shs)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        last = ckpt.latest_step()
        like, shs = (params, opt_state), shardings
        restore_ef = ef is not None and \
            ckpt.manifest(last)["extra"].get("error_feedback") == ef.tag()
        if restore_ef:
            ef_tree, ef_sh = ef.state(params, shardings[0])
            like, shs = like + (ef_tree,), shs + (ef_sh,)
        tree, meta = ckpt.restore(last, like, shardings=shs)
        params, opt_state = tree[0], tree[1]
        if restore_ef:
            ef.load(tree[2])
        start_step = meta["step"] + 1
        if rank0:
            print(f"[train] resumed from step {meta['step']}"
                  + ("" if ef is None or restore_ef else
                     "; error feedback starts at zero (the checkpoint "
                     "holds none for this mesh and rounding)"))

    stop = {"flag": False}

    def _sigterm(_sig, _frm):
        stop["flag"] = True
    previous = signal.signal(signal.SIGTERM, _sigterm)
    try:
        wd = StepWatchdog()
        losses = []
        for step in range(start_step, args.steps):
            batch = data.batch_at(step, device=device)
            wd.start()
            loss, params, opt_state = step_fn(params, opt_state, batch)
            loss = float(loss)
            flagged = wd.stop(step)
            losses.append(loss)
            if rank0 and (step % args.log_every == 0
                          or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({wd.mean * 1e3:.0f} ms/step"
                      f"{' STRAGGLER' if flagged else ''})")
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                save(step, loss)
            if _any_rank(stop["flag"], sharded, device):
                if rank0:
                    print("[train] SIGTERM -> checkpoint and exit")
                save(step, loss)
                ckpt.wait()
                sys.exit(0)
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {step}")
        if losses:
            save(args.steps - 1, losses[-1])
            ckpt.wait()
            if rank0:
                print(f"[train] done; loss {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}")
        return losses
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
