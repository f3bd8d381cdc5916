"""The RG-LRU recurrent block (the recurrentgemma / Griffin ``hybrid``
family): the port of ``repro.models.rglru``.

The recurrent branch is linear -> causal depthwise conv1d (width
``conv_width``) -> RG-LRU (a gated diagonal linear recurrence), gated by
a parallel GeLU branch.  The recurrence ``h_t = a_t h_{t-1} + sqrt(1 -
a_t^2) (i_t x_t)`` runs through :func:`~repro_torch.models.scan.
associative_scan` over time, in the reference's combine order; a decode
step is one update.  Decode carries (h, conv history): ``h`` in f32, the
history in the ``kv_cache`` format (binary8 under transprecision),
rounded there at the end of every chunk and step, as in the reference.

The scan, the conv and the gates are no TPU kernels in the reference
(XLA computes them): here they are torch ops on tensors; the five
projections go through ``pdot`` (``qmm_tc`` on a card over packed
weights).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.policy import PrecisionPolicy

from .layers import act_cast, dense_init, pdot
from .scan import associative_scan, linear_combine

F32 = torch.float32
C_SCALE = 8.0  # the "c" constant of the RecurrentGemma paper


class RglruState(NamedTuple):
    h: torch.Tensor      # (B, W) recurrence state, f32
    conv: torch.Tensor   # (B, conv_width - 1, W) conv history, kv_cache


def rglru_init(gen, cfg, dtype, device=None):
    """The block's weights in ``dtype`` (the reference makes them in the
    ``ffn_w`` dtype; ``w_rec_gate`` / ``w_in_gate`` pack under
    ``attn_w``)."""
    d, w = cfg.d_model, cfg.rglru_width

    def dense(shape, scale=None, dt=dtype):
        return dense_init(gen, shape, scale=scale, dtype=dt, device=device)

    return {
        "w_branch": dense((d, w)),
        "w_gate": dense((d, w)),
        "conv_w": dense((cfg.conv_width, w), scale=0.5, dt=F32),
        "conv_b": torch.zeros((w,), dtype=F32, device=device),
        "w_rec_gate": dense((w, w)),
        "w_in_gate": dense((w, w)),
        "lam": 1.0 + 7.0 * torch.rand((w,), generator=gen, dtype=F32,
                                      device=device),
        "w_out": dense((w, d)),
    }


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, written as JAX writes
    it (``F.softplus`` switches to ``x`` past a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def causal_conv(x, w, b, history=None):
    """Depthwise causal conv; x: (B, S, W), w: (K, W); ``history``
    (B, K - 1, W) the rows before ``x`` (zeros when None)."""
    K = w.shape[0]
    if history is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1).to(F32)
    S = x.shape[1]
    out = torch.zeros((x.shape[0], S, x.shape[2]), dtype=F32,
                      device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k][None, None, :]
    return out + b[None, None, :]


def rglru_block(p, x, cfg, policy: PrecisionPolicy, state=None):
    """x: (B, S, d) -> (out, new_state); the state only when one is
    given."""
    B, S, d = x.shape
    gate = gelu(pdot(x, p["w_gate"], policy, "ffn_w",
                     out_act=False).to(F32))
    br_pre = pdot(x, p["w_branch"], policy, "ffn_w")
    hist = state.conv if state is not None else None
    br = act_cast(causal_conv(br_pre, p["conv_w"], p["conv_b"],
                              history=hist), policy)

    # the gates in f32 (range-critical)
    r = torch.sigmoid(pdot(br, p["w_rec_gate"], policy, "attn_w",
                           out_act=False).to(F32))
    i = torch.sigmoid(pdot(br, p["w_in_gate"], policy, "attn_w",
                           out_act=False).to(F32))
    log_a = -C_SCALE * softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    gated_x = beta * (i * br.to(F32))

    if S == 1 and state is not None:
        h = a[:, 0] * state.h.to(F32) + gated_x[:, 0]
        hs = h[:, None, :]
    else:
        h0 = (state.h.to(F32) if state is not None
              else torch.zeros((B, br.shape[-1]), dtype=F32,
                               device=x.device))
        a_sc, b_sc = associative_scan(linear_combine, (a, gated_x), dim=1)
        hs = b_sc + a_sc * h0[:, None, :]
        h = hs[:, -1]

    y = act_cast(hs * gate, policy)
    out = pdot(y, p["w_out"], policy, "ffn_w")

    new_state = None
    if state is not None:
        K = cfg.conv_width
        conv_hist = torch.cat([state.conv.to(br_pre.dtype), br_pre],
                              dim=1)[:, -(K - 1):, :]
        new_state = RglruState(h=h.to(state.h.dtype),
                               conv=conv_hist.to(state.conv.dtype))
    return out, new_state


def rglru_init_state(cfg, batch, policy, device=None) -> RglruState:
    """Zero states: ``h`` f32, the conv history in the ``kv_cache``
    dtype."""
    return RglruState(
        h=torch.zeros((batch, cfg.rglru_width), dtype=F32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.rglru_width),
                         dtype=policy.dtype("kv_cache"), device=device))
