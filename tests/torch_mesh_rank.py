"""One rank of a gloo mesh on the CPU, for ``tests/test_torch_mesh.py``
(not collected: its name does not start with ``test_``).

    python tests/torch_mesh_rank.py RANK WORLD INIT_FILE INPUTS OUT_DIR
                                    [ENGINE_PARAMS]

Starts a gloo process group of WORLD ranks through ``file://INIT_FILE``,
makes the (WORLD // 2, 2) ``("data", "model")`` mesh, and under it runs
every ``decode_impl`` spelling on the cases in the ``INPUTS`` npz (a
contiguous native cache and a scattered page pool per format), counting
the sharded branches each call takes.  With 4 ranks it also makes the
(1, 4) mesh over the same group and runs every spelling under it on the
npz's ``*_1x4`` lengths and tables: a 4-rank ring, whose shards take
three hops.  With ENGINE_PARAMS (a ``torch.save``d param tree of reduced
llama3-8b) it also serves the prompts of ``INPUTS`` through ``Engine``
under binary32 once per spelling, under the first mesh.  Writes
``OUT_DIR/rank{RANK}.npz`` (keys ``MESH__FMT__SPELLING``) and
``rank{RANK}.json``.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

from repro_torch.core.policy import binary32_policy, get_policy  # noqa: E402
from repro_torch.engine import Engine, Request  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import attention  # noqa: E402,F401 (registers)
from repro_torch.models.registry import build  # noqa: E402

SHARDED = ("_shmap_decode", "_shmap_decode_paged", "_ring_decode",
           "_ring_decode_paged")
NATIVE = {"binary8": torch.float8_e5m2, "binary32": torch.float32}


def spy_branches():
    """Replace the sharded branches with counting wrappers."""
    counts = {name: 0 for name in SHARDED}
    for name in SHARDED:
        real = getattr(dispatch, name)

        def spy(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        setattr(dispatch, name, spy)
    return counts


def native(bits: np.ndarray, fmt: str) -> torch.Tensor:
    return torch.from_numpy(bits).view(NATIVE[fmt])


def mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def run_spellings(inp, counts, case=""):
    """Every spelling on the npz's arrays named with ``case``'s suffix
    (the 1x4 mesh's lengths and tables; the cache payloads are shared)."""
    out, taken = {}, {}
    q = torch.from_numpy(inp["q"])
    lengths = torch.from_numpy(inp["lengths" + case])
    tables = torch.from_numpy(inp["tables" + case])
    scale = float(inp["scale"])
    for fmt in NATIVE:
        pol = binary32_policy(kv_fmt=fmt)
        ck, cv = native(inp[f"k_{fmt}"], fmt), native(inp[f"v_{fmt}"], fmt)
        kpool = native(inp[f"kpool{case}_{fmt}"], fmt)
        vpool = native(inp[f"vpool{case}_{fmt}"], fmt)
        for impl in dispatch.legal_impls():
            before = dict(counts)
            fn = dispatch.resolve_decode(impl)
            if dispatch.canonicalize_impl(impl)[-1] == "paged":
                got = fn(q, kpool, vpool, lengths, scale=scale, policy=pol,
                         block_tables=tables)
            else:
                got = fn(q, ck, cv, lengths, scale=scale, policy=pol)
            out[f"{fmt}__{impl}"] = got.numpy()
            taken[f"{fmt}__{impl}"] = [n for n in SHARDED
                                      if counts[n] > before[n]]
    return out, taken


def run_engine(inp, params_path, counts):
    model, cfg = build("llama3-8b", reduced=True)
    params = torch.load(params_path, weights_only=False)
    prompts = inp["prompts"].tolist()
    tokens, taken = {}, {}
    for impl in dispatch.legal_impls():
        before = dict(counts)
        eng = Engine(model, cfg, get_policy("binary32", decode_impl=impl),
                     params, slots=2, capacity=24, page_size=8,
                     device="cpu")
        reqs = [Request(i, p, int(inp["max_new"]))
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        tokens[impl] = [r.generated for r in reqs]
        taken[impl] = [n for n in SHARDED if counts[n] > before[n]]
    return tokens, taken


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, inputs, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        inp = dict(np.load(inputs))
        counts = spy_branches()
        shapes = [(world // 2, 2)] + ([(1, 4)] if world == 4 else [])
        report, out = {"meshes": {}}, {}
        for shape in shapes:
            name = mesh_name(shape)
            mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
            rep = report["meshes"][name] = {
                "coordinate": mesh.get_coordinate()}
            with mesh_mod.use_mesh(mesh):
                rep["default_cuda"] = dispatch.default_serving_impl("cuda")
                got, rep["taken"] = run_spellings(
                    inp, counts, "_1x4" if shape == (1, 4) else "")
                out.update({f"{name}__{k}": v for k, v in got.items()})
                if len(sys.argv) > 6 and shape == shapes[0]:
                    report["tokens"], report["engine_taken"] = run_engine(
                        inp, sys.argv[6], counts)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
