"""Plain reference of a dense grouped-query-attention decoder (the
Mistral / Llama / Yi block), and the matrix products one forward call of
such a model runs.

Written from the published block, not from the program: rmsnorm, rotary
positions (half-split, theta ** (-2i / head_dim)), grouped-query causal
attention, a SiLU-gated FFN, an untied head.  It imports no module of
the program and takes none of its state: only the seeded weights that
the benchmark made and handed to both sides, and the tokens.

Numbers follow the configuration's storage, not the program's code:
float32 arithmetic with TF32 off, every activation rounded to bfloat16
where the transprecision policy stores one (the residual stream, each
norm's output, q / k / v after their projections and after the rotary
step, the attention output, each projection's output, the FFN's gated
activation), K and V rounded to float8 e5m2 (binary8) before attention
reads them, and the logits in float32.  Departures from the published
block, as the configuration runs it: the norms' gains are ``1 + gamma``
(the program's parametrisation of the weight) and eps is the
configuration's ``rms_norm_eps``.

``weight_fmt="e5m2"`` is the control: the same reference with every
weight matrix (the embedding table and the head included) rounded to
binary8, the precision below the configuration's binary16alt.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch

from portbench import costs

F32 = torch.float32


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _e5m2(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e5m2).to(x.dtype)


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off, restored afterwards."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def _weight(t: torch.Tensor, weight_fmt: Optional[str],
            dt: torch.dtype) -> torch.Tensor:
    if weight_fmt is None:
        return t.to(dt)
    if weight_fmt == "e5m2":
        return _e5m2(t.to(dt))
    raise ValueError(f"weight_fmt {weight_fmt!r}")


def _norm(s: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    r = 1.0 / torch.sqrt(torch.mean(s * s, dim=-1, keepdim=True) + eps)
    return _bf((s * r) * (1.0 + gamma.to(s.dtype)))


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, dh) at positions 0 ... S - 1."""
    S, _, dh = x.shape
    half = dh // 2
    inv = (float(theta) ** (-torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half)).to(F32)
    ang = (torch.arange(S, device=x.device, dtype=F32)[:, None]
           * inv[None]).to(x.dtype)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, n_kv: int) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, dh), k / v (S, n_kv, dh)
    -> (S, H * dh); float32 scores and probabilities."""
    S, H, dh = q.shape
    qg = q.reshape(S, n_kv, H // n_kv, dh)
    scores = torch.einsum("skgd,tkd->kgst", qg, k) * (1.0 / math.sqrt(dh))
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("kgst,tkd->skgd", p, v).reshape(S, H * dh)


@torch.no_grad()
def logits(w: dict, c: dict, seqs: Sequence[torch.Tensor],
           at: Sequence[torch.Tensor], *, weight_fmt: Optional[str] = None,
           compute: torch.dtype = F32) -> List[torch.Tensor]:
    """float32 logits of each token sequence in ``seqs`` (1-D int tensors
    on the weights' device) at its positions ``at`` (1-D int tensors),
    layer by layer over all sequences so that one layer's weights are
    widened at a time.  ``c`` holds the run's sizes (``sizes``).
    ``compute=torch.float64`` keeps every rounding point and sums in
    float64: the same computation in another summation order, a witness
    of how far rounding alone moves the logits."""
    if isinstance(compute, str):
        compute = getattr(torch, compute)
    L, H, n_kv = c["n_layers"], c["n_heads"], c["n_kv"]
    dh, eps, theta = c["head_dim"], c["rms_norm_eps"], c["rope_theta"]
    lens = [int(s.numel()) for s in seqs]
    with exact_f32():
        emb = w["embed"]
        x = torch.cat([_weight(emb[s.long()], weight_fmt, compute)
                       for s in seqs])
        f = None
        for li in range(L):
            W = {k: _weight(w[k][li], weight_fmt, compute)
                 for k in ("wq", "wk", "wv", "wo", "w_in", "w_gate",
                           "w_out")}
            s = x if f is None else _bf(x + f)
            h = _norm(s, w["gamma"][2 * li], eps)
            q = _bf(h @ W["wq"])
            k = _bf(h @ W["wk"])
            v = _bf(h @ W["wv"])
            outs, at_row = [], 0
            for n in lens:
                sl = slice(at_row, at_row + n)
                qi = _bf(_rope(q[sl].reshape(n, H, dh), theta))
                ki = _e5m2(_bf(_rope(k[sl].reshape(n, n_kv, dh), theta)))
                vi = _e5m2(v[sl].reshape(n, n_kv, dh))
                outs.append(_bf(_attend(qi, ki, vi, n_kv)))
                at_row += n
            a = _bf(torch.cat(outs) @ W["wo"])
            s = _bf(s + a)
            h = _norm(s, w["gamma"][2 * li + 1], eps)
            g = _bf(torch.nn.functional.silu(h @ W["w_in"])
                    * (h @ W["w_gate"]))
            f = _bf(g @ W["w_out"])
            x = s
            del W
        s = _bf(x + f)
        h = _norm(s, w["gamma"][2 * L], eps)
        starts = torch.tensor([0] + lens[:-1], device=h.device).cumsum(0)
        rows = torch.cat([st + p.to(h.device) for st, p in zip(starts, at)])
        out = (h[rows] @ _weight(w["head"], weight_fmt, compute)).to(F32)
    return list(out.split([int(p.numel()) for p in at]))


def sizes(config: dict) -> dict:
    """The run's numbers under short names, from a configuration file's
    published (Hugging Face) keys."""
    return {
        "n_layers": int(config["num_hidden_layers"]),
        "d_model": int(config["hidden_size"]),
        "n_heads": int(config["num_attention_heads"]),
        "n_kv": int(config["num_key_value_heads"]),
        "head_dim": int(config["head_dim"]),
        "d_ff": int(config["intermediate_size"]),
        "vocab": int(config["vocab_size"]),
        "rope_theta": float(config["rope_theta"]),
        "rms_norm_eps": float(config["rms_norm_eps"]),
    }


def port_config(c: dict) -> dict:
    """The program's ``ModelConfig`` fields for the sizes ``c``."""
    return dict(family="dense", n_layers=c["n_layers"], d_model=c["d_model"],
                n_heads=c["n_heads"], n_kv=c["n_kv"], d_ff=c["d_ff"],
                vocab=c["vocab"], head_dim=c["head_dim"],
                rope_theta=c["rope_theta"], norm="rmsnorm", act_fn="silu",
                gated_ffn=True)


def qmm_products(c: dict, rows: int, head_rows: int):
    """(M, K, N, gated) of every matrix product one model call runs over
    ``rows`` token rows, the head over ``head_rows`` of them: per layer
    wq, wk, wv, wo, the gated pair (one fused product) and w_out."""
    d, ff, V = c["d_model"], c["d_ff"], c["vocab"]
    qd, kvd = c["n_heads"] * c["head_dim"], c["n_kv"] * c["head_dim"]
    layer = [(rows, d, qd, False), (rows, d, kvd, False),
             (rows, d, kvd, False), (rows, qd, d, False),
             (rows, d, ff, True), (rows, ff, d, False)]
    return layer * c["n_layers"] + [(head_rows, d, V, False)]


def param_count(c: dict) -> int:
    return costs.dense_param_count(c)
