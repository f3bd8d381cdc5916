"""One rank of a gloo mesh on the CPU, for ``tests/test_torch_train_mesh.py``
(not collected: its name does not start with ``test_``).

    python tests/torch_train_rank.py RANK WORLD ROOT

Reads ``ROOT/inputs.npz`` and writes ``ROOT/world{WORLD}/rank{RANK}.npz``
and ``rank{RANK}.json``.  With 2 ranks it first runs the train CLI six
times, each starting and destroying its own process group from the
flags (5 steps; 3 steps; ``--resume`` to 5 in the second run's
directory; with binary8 stochastic gradients: 4 steps; 4 steps with a
SIGTERM to rank 1 alone as step 1 starts; ``--resume`` to 4 in that
run's directory), then starts the worker's group through
``file://ROOT/world2/rendezvous`` and runs the meshes (1, 2) and (2, 1);
with 4 ranks the meshes (2, 2) and (1, 4).  On each mesh:

* ``sharded_step``: 3 sharded train steps of reduced llama3-8b under
  binary32 (batch 4 x 16): the losses, the final params gathered, a
  digest of every replicated leaf's block (equal on every rank), and the
  clip factor of a random gradient from the blocks and from the whole;
* ``moe``: the expert-parallel MoE layer of reduced granite-moe (the
  npz's x, layer and cotangent, capacity factors 1.25 and 0.25), the
  rank's output rows and aux, and the gradients of
  ``n_dp * sum(y_rank * cot_rank) + 0.5 * aux`` averaged over the data
  dims (x's divided by n_dp): the true gradient of ``sum(y * cot) + 0.5
  * aux``; and the layer as a server calls it (every rank the whole
  batch and the whole experts, outputs gathered back: ``y_whole``);
* ``dense`` (meshes with two data ranks): the global MoE path under the
  split batch (tokens gathered over the data dim), the same outputs;
* ``compress``: ``compressed_allgather_sum`` (nearest and stochastic),
  ``compressed_psum`` and ``tree_compress_psum`` of the rank's gradient
  and residual over the mesh's dims;
* world 2 saves the (1, 2) step's params and AdamW state with their
  shardings to ``ROOT/ckpt``; world 4 restores it on (2, 2) and (1, 4)
  and checks each block against the files (``reshard_ok``).
"""
import dataclasses
import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: E402
                                            from_host)
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.ambient_mesh import dp_axes, dp_size  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import (flatten_with_path, leaves,  # noqa: E402
                                   path_key, unflatten)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402

STEPS, BATCH, SEQ, LR = 3, 4, 16, 1e-3
CFS = (1.25, 0.25)
AUX_W = 0.5
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
STOP_STEP = 1
CLI = ["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--policy",
       "binary32", "--batch", str(BATCH), "--seq", str(SEQ),
       "--ckpt-every", "0", "--log-every", "100"]


def name(shape) -> str:
    return "x".join(str(n) for n in shape)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


class StopAt(SyntheticLM):
    """The data stream of a rank that receives SIGTERM as it starts step
    ``STOP_STEP`` (the other ranks receive none)."""

    def batch_at(self, step, **kw):
        if step == STOP_STEP:
            signal.raise_signal(signal.SIGTERM)
        return super().batch_at(step, **kw)


def run_cli(rank, world, out_dir):
    """The train CLI on its own process groups; returns the losses of
    each run, or, of a run stopped by SIGTERM, its exit code and its
    checkpoint's step and loss."""
    from repro_torch.kernels import flexfloat_cast
    compressed = ["--compress-grads", "--stochastic-rounding", "7"]
    runs = {}
    for tag, steps, ckpt, extra in (("a", 5, "ckpt_a", []),
                                    ("b", 3, "ckpt_b", []),
                                    ("c", 5, "ckpt_b", ["--resume"]),
                                    ("d", 4, "ckpt_d", compressed),
                                    ("e", 4, "ckpt_e", compressed),
                                    ("f", 4, "ckpt_e",
                                     compressed + ["--resume"])):
        argv = CLI + ["--steps", str(steps), "--ckpt-dir",
                      os.path.join(out_dir, ckpt), "--init-method",
                      "file://" + os.path.join(out_dir, f"cli_{tag}"),
                      "--world-size", str(world), "--rank", str(rank)]
        flexfloat_cast.LIB.reset_counts()
        if tag == "e" and rank == 1:
            train.SyntheticLM = StopAt
        try:
            runs[tag] = train.main(argv + extra)
        except SystemExit as e:
            mgr = CheckpointManager(os.path.join(out_dir, ckpt))
            last = mgr.latest_step()
            runs[tag] = dict(exit=e.code, step=last,
                             loss=mgr.manifest(last)["extra"]["loss"])
        finally:
            train.SyntheticLM = SyntheticLM
        assert not dist.is_initialized()
    return runs


def sharded_steps(mesh, out, report, tag):
    pol = get_policy("binary32")
    model, cfg = build("llama3-8b", reduced=True)
    data = SyntheticLM(DataConfig(global_batch=BATCH, seq_len=SEQ), cfg)
    params = model.init_params(torch.Generator().manual_seed(0), pol,
                               device="cpu")
    shs = train.shardings_for(params, pol, mesh)
    params = sharding.tree_local_blocks(params, shs[0])
    opt = adamw.init(params, pol)
    step = train.make_train_step(model, pol, LR, mesh, shs)
    losses = []
    for s in range(STEPS):
        loss, params, opt = step(params, opt, data.batch_at(s))
        losses.append(float(loss))
    full = sharding.tree_gather(params, shs[0])
    for p, t in flatten_with_path(full):
        out[f"{tag}/params/{path_key(p)}"] = t.numpy()
    # the clip factor from the ranks' blocks against the whole tree's (a
    # replicated leaf counted once); gradients of norm ~2, so it acts
    g = torch.Generator().manual_seed(3)
    grads = unflatten(full, [
        torch.randn(t.shape, generator=g) / (t.numel() * 10) ** 0.5
        for t in leaves(full)])
    out[f"{tag}/clip"] = np.asarray([
        float(train.sharded_clip_scale(sharding.tree_local_blocks(
            grads, shs[0]), shs[0], train.GRAD_CLIP)),
        float(adamw.global_norm_scale(grads, train.GRAD_CLIP))])
    report[tag] = dict(
        losses=losses,
        replicated={path_key(p): digest(t) for (p, t), s in zip(
            flatten_with_path(params), leaves(shs[0]))
            if all(e is None for e in s.spec)},
        blocks={path_key(p): list(t.shape)
                for p, t in flatten_with_path(params)})
    return params, opt, shs


def moe_case(mesh, inp, out, tag, impl):
    """The MoE layer on the rank's rows; the rank's outputs and grads."""
    pol = get_policy("binary32")
    _, cfg = build("granite-moe-1b-a400m", reduced=True)
    n_dp = dp_size(mesh)
    dp = dp_axes(mesh)
    B = inp["moe_x"].shape[0]
    lead = sharding.batch_spec(B, mesh, extra_dims=0)[0]
    split = coll.as_axes(lead) if lead is not None else ()
    i = coll.axes_index(mesh, split) if split else 0
    rows = B // coll.axes_size(mesh, split) if split else B
    for cf in CFS:
        c = dataclasses.replace(cfg, capacity_factor=cf, moe_impl=impl)
        x = torch.from_numpy(inp["moe_x"][i * rows:(i + 1) * rows].copy())
        cot = torch.from_numpy(inp["moe_cot"][i * rows:(i + 1) * rows]
                               .copy())
        p = {k: torch.from_numpy(inp[f"moe_{k}"].copy())
             for k in ("router", "w_in", "w_gate", "w_out")}
        if impl == "shard_map":       # the experts as the rank's blocks
            spec = ("model", None, None)
            p.update({k: sharding.local_block(p[k], spec, mesh)
                      for k in ("w_in", "w_gate", "w_out")})
        live = {k: v.requires_grad_(True) for k, v in p.items()}
        x.requires_grad_(True)
        with mesh_mod.use_mesh(mesh, batch_split=split):
            y, aux = moe.moe_apply(live, x, c, pol)
            obj = n_dp * torch.sum(y * cot) + AUX_W * aux
            grads = torch.autograd.grad(obj, [x] + list(live.values()))
        key = f"{tag}/{impl}/{cf}"
        if impl == "shard_map":
            # as a server calls it: every rank the whole batch and all the
            # experts, the rank's rows computed and gathered back
            full = {k: torch.from_numpy(inp[f"moe_{k}"].copy())
                    for k in ("router", "w_in", "w_gate", "w_out")}
            with torch.no_grad(), mesh_mod.use_mesh(mesh):
                out[f"{key}/y_whole"] = moe.moe_apply(
                    full, torch.from_numpy(inp["moe_x"].copy()), c,
                    pol)[0].numpy()
        out[f"{key}/y"] = y.detach().numpy()
        out[f"{key}/aux"] = np.float32(aux.detach())
        out[f"{key}/gx"] = (grads[0] / n_dp).numpy()
        for k, g in zip(live, grads[1:]):
            out[f"{key}/g_{k}"] = (coll.all_reduce_sum(g, mesh, dp)
                                   / n_dp).numpy()


def compress_case(rank, mesh, inp, out, tag):
    axes = tuple(a for a in ("data", "model")
                 if coll.axes_size(mesh, a) > 1)
    g = torch.from_numpy(inp[f"g{rank}"].copy())
    r = torch.from_numpy(inp[f"r{rank}"].copy())
    bits = torch.from_numpy(inp[f"bits{rank}"].copy())
    with mesh_mod.use_mesh(mesh):
        for what, fn, rb in (("gather", grad_compress.compressed_allgather_sum,
                              None),
                             ("gather_sr",
                              grad_compress.compressed_allgather_sum, bits),
                             ("psum", grad_compress.compressed_psum, None)):
            s, nr = fn(g, r, axes, rbits=rb)
            out[f"{tag}/{what}/sum"] = s.numpy()
            out[f"{tag}/{what}/res"] = nr.numpy()
        tree = {"a": g, "b": [g[:3] * 2]}
        res = {"a": r, "b": [r[:3]]}
        s, nr = grad_compress.tree_compress_psum(tree, res, axes)
        out[f"{tag}/tree/a"] = s["a"].numpy()
        out[f"{tag}/tree/b"] = s["b"][0].numpy()
        out[f"{tag}/tree/res_a"] = nr["a"].numpy()
    out[f"{tag}/axes"] = np.asarray(axes)


def reshard_case(mesh, root, report, tag):
    """Restore the world-2 (1, 2) checkpoint on ``mesh``: every block
    equal to the file's array narrowed for this rank, and gathered back
    to it."""
    pol = get_policy("binary32")
    model, _ = build("llama3-8b", reduced=True)
    full = model.init_params(torch.Generator().manual_seed(0), pol,
                             device="meta")
    shs = train.shardings_for(full, pol, mesh)
    mgr = CheckpointManager(os.path.join(root, "ckpt"))
    step = mgr.latest_step()
    (p, o), meta = mgr.restore(step, (full, adamw.init(full, pol)),
                               device="cpu", shardings=shs)
    ok, shapes = True, {}
    path = os.path.join(root, "ckpt", f"step_{step}")
    for (pth, blk), s in zip(flatten_with_path((p, o)), leaves(shs)):
        k = path_key(pth)
        arr = np.load(os.path.join(path, k.replace("/", "_") + ".npy"))
        want = from_host(arr, meta["keys"][k]["dtype"], "cpu")
        ok &= torch.equal(blk, sharding.local_block(want, s.spec, mesh))
        ok &= torch.equal(sharding.gather_block(blk, s.spec, mesh), want)
        shapes[k] = list(blk.shape)
    report[tag] = dict(ok=bool(ok), step=step, blocks=shapes)


def main():
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.manual_seed(0)
    out_dir = os.path.join(root, f"world{world}")
    inp = np.load(os.path.join(root, "inputs.npz"))
    report, out = {}, {}
    if world == 2:
        report["cli"] = run_cli(rank, world, out_dir)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out_dir, "rendezvous"), world_size=world, rank=rank)
    try:
        for shape in MESHES[world]:
            mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
            tag = name(shape)
            params, opt, shs = sharded_steps(mesh, out, report, tag)
            if shape == (1, 2):
                mgr = CheckpointManager(os.path.join(root, "ckpt"))
                mgr.save(STEPS - 1, (params, opt), shardings=shs)
                mgr.wait()
            moe_case(mesh, inp, out, tag, "shard_map")
            if shape[0] == 2:
                moe_case(mesh, inp, out, tag, "dense")
            compress_case(rank, mesh, inp, out, tag)
            if world == 4:
                reshard_case(mesh, root, report, f"{tag}/reshard")
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
