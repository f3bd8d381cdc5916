"""Seeded random weights, made on the device in the type they are served
in, and handed alike to the program and to the plain reference.

Every matrix of one kind is drawn for all layers in one call (a stack of
layers, each layer's leaf a contiguous view), in bfloat16 (binary16alt,
the configuration's weight format), normal with scale 1 / sqrt(fan in);
the embedding table at unit scale.  The norms' gains are the program's
parametrisation, ``(1 + gamma)``, with gamma ~ 0.1 N(0, 1) in float32 so
that a gain the program dropped or applied twice shows.
"""
from __future__ import annotations

import math

import torch


def dense_weights(c: dict, seed: int, device) -> dict:
    """The weights of a dense GQA decoder of config ``c`` (the numbers of
    ``configs/<name>.json``'s ``run`` block)."""
    L, d, ff, V = c["n_layers"], c["d_model"], c["d_ff"], c["vocab"]
    qd, kvd = c["n_heads"] * c["head_dim"], c["n_kv"] * c["head_dim"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    bf = torch.bfloat16

    def draw(shape, scale):
        return torch.randn(shape, generator=gen, dtype=bf,
                           device=device).mul_(scale)

    w = {"embed": draw((V, d), 1.0)}
    for name, (k, n) in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                         ("wo", (qd, d)), ("w_in", (d, ff)),
                         ("w_gate", (d, ff)), ("w_out", (ff, d))):
        w[name] = draw((L, k, n), 1.0 / math.sqrt(k))
    w["head"] = draw((d, V), 1.0 / math.sqrt(d))
    w["gamma"] = 0.1 * torch.randn((2 * L + 1, d), generator=gen,
                                   dtype=torch.float32, device=device)
    return w


def port_params(w: dict) -> dict:
    """The program's parameter tree over the same tensors (views, no
    copies); the program packs it itself."""
    L = w["wq"].shape[0]
    return {
        "embed": w["embed"],
        "head": w["head"],
        "final_norm": {"gamma": w["gamma"][2 * L]},
        "layers": [{
            "norm1": {"gamma": w["gamma"][2 * li]},
            "mix": {k: w[k][li] for k in ("wq", "wk", "wv", "wo")},
            "norm2": {"gamma": w["gamma"][2 * li + 1]},
            "ffn": {k: w[k][li] for k in ("w_in", "w_gate", "w_out")},
        } for li in range(L)],
    }
