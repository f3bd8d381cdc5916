"""Training on one device: the port of ``repro.launch.train``.

``python -m repro_torch.launch.train --arch llama3-8b --reduced --steps 200``

The reference's flags (``--arch --reduced --steps --batch --seq --lr
--policy --ckpt-dir --ckpt-every --resume --log-every``) plus
``--device`` (default ``cuda``; raises when no card is present unless
``--device cpu``).  Random weights from seed 0, the synthetic stream of
``data/pipeline.py``, AdamW in the policy's state formats, an async
checkpoint every ``--ckpt-every`` steps and at the end (keep-last-3,
atomic), ``--resume`` from the newest one, a step-time watchdog, a
checkpoint and exit on SIGTERM, and an error on a non-finite loss.
:func:`main` returns the losses of the steps it ran.

Attention follows the config and the policy (``xla`` unless the policy
names ``flash_pallas``, whose training forward is the ``flash_prefill``
kernel and its backward a plain recompute); the ``[train]`` line says
which ran.  The forward's fused norms are ``add_rmsnorm`` /
``add_layernorm`` launches with a plain recompute backward.

On the card the step is deterministic: its CUDA ops that scatter in the
backward write distinct places (the loss's ``gather`` picks one label a
row; an index's backward, the embedding's included, accumulates through
torch's sort-based ``index_put_``), so a resumed run repeats the
uninterrupted one bit for bit.  The weights are plain tensors and every
product a ``torch.matmul``, as the reference's ``jnp.dot``s under
``matmul_impl="xla"``; sharding over several devices is not ported.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.policy import get_policy
from repro_torch.core.tree import leaves, unflatten
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import attention as attn
from repro_torch.models.registry import build
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.runtime.watchdog import StepWatchdog


def loss_and_grads(model, params, batch, policy):
    """The loss and the gradient of every param leaf (zeros for a leaf
    the loss does not read, as ``jax.grad`` gives), by autograd."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = model.train_loss(unflatten(params, live), batch, policy)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(model, policy, lr):
    """``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)``: the loss and grads by autograd, one ``adamw.apply``,
    the new master cast to the policy's storage formats.  The step
    donates ``opt_state``, as the reference's jitted step does: its
    tensors are updated in place."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, policy)
        _, new_opt = adamw.apply(grads, opt_state, policy, lr=lr)
        new_params = adamw.materialize_params(new_opt, params, policy)
        return loss, new_params, new_opt
    return train_step


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    policy = get_policy(args.policy)
    model, cfg = build(args.arch, reduced=args.reduced)
    mesh = make_elastic_mesh(device=device)
    print(f"[train] arch={args.arch} params={cfg.param_count():,} "
          f"mesh={mesh.shape} policy={args.policy} "
          f"attention={attn.decode_impl(cfg, policy)} device={device}")

    data = SyntheticLM(DataConfig(global_batch=args.batch,
                                  seq_len=args.seq), cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, policy, device=device)
    opt_state = adamw.init(params, policy)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt_state), meta = ckpt.restore(ckpt.latest_step(),
                                                 (params, opt_state))
        start_step = meta["step"] + 1
        print(f"[train] resumed from step {meta['step']}")

    step_fn = make_train_step(model, policy, args.lr)
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
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({wd.mean * 1e3:.0f} ms/step"
                      f"{' STRAGGLER' if flagged else ''})")
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                ckpt.save(step, (params, opt_state),
                          extra={"data": data.state(step), "loss": loss})
            if stop["flag"]:
                print("[train] SIGTERM -> checkpoint and exit")
                ckpt.save(step, (params, opt_state),
                          extra={"data": data.state(step), "loss": loss})
                ckpt.wait()
                sys.exit(0)
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {step}")
        if losses:
            ckpt.save(args.steps - 1, (params, opt_state),
                      extra={"data": data.state(args.steps - 1),
                             "loss": losses[-1]})
            ckpt.wait()
            print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        return losses
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
