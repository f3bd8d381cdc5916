"""RWKV6 "Finch" time-mix and channel-mix blocks (the attention-free
``ssm`` family): the port of ``repro.models.rwkv6``.

A prefill (or a chunk of one) runs the chunked-parallel form: within a
chunk of ``C`` tokens the interactions are dense f32 products, and the
state crosses chunks through :func:`~repro_torch.models.scan.
associative_scan`, in the reference's combine order.  Decode carries the
O(1) recurrent state (B, H, dk, dv) per layer.  Every ``exp`` argument
within a chunk is <= 0 (decay ratios), so nothing overflows.

``cfg.rwkv_fused`` (the reference's experiment; no config sets it) folds
the five token-shift projections of the time mix into one wide product
and the channel mix's two into one, through the lerp identity ``mix(x,
xx, m) @ W = x @ W + (xx - x) @ (m * W)``: ``wrkvg`` (d, 4d + 64) holds
r, k, v, g and the decay LoRA's first weight side by side, ``cm_kr``
(d, d_ff + d) the channel mix's k and r.  The second term's weight ``wm
= m * W`` is derived anew at every call (``qparams.as_array`` of the
packed leaf, scaled, rounded to the role's storage dtype) and multiplied
as a plain array, outside the packed-weight kernel, as the reference
does.  Because ``wm`` is rounded to the storage dtype, the fused path is
another computation than the unfused one except under binary32.

The wkv recurrence, the decay LoRA and the group norm are no TPU kernels
in the reference (XLA computes them): here they are torch ops on
tensors; the projections go through ``pdot`` (``qmm_tc`` on a card over
packed weights).  The state ``s`` is stored in the ``kv_cache`` format
(binary8 under transprecision) and rounded there at the end of every
chunk and decode step, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.policy import PrecisionPolicy

from .layers import act_cast, dense_init, pdot
from .qparams import as_array
from .scan import associative_scan, linear_combine

F32 = torch.float32
RANK = 64           # the decay LoRA's rank


class RwkvState(NamedTuple):
    s: torch.Tensor          # (B, H, dk, dv) wkv state, kv_cache dtype
    x_prev_tm: torch.Tensor  # (B, d) token-shift state, time-mix
    x_prev_cm: torch.Tensor  # (B, d) token-shift state, channel-mix


def rwkv_init(gen, cfg, dtype, device=None):
    d, ff = cfg.d_model, cfg.d_ff
    H = d // cfg.rwkv_head_dim

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=F32, device=device)

    def w(shape, scale=None, dt=dtype):
        return dense_init(gen, shape, scale=scale, dtype=dt, device=device)

    if cfg.rwkv_fused:
        # the five token-shift projections (r, k, v, g, the decay LoRA's
        # input side) as one product, the channel mix's two as one
        return {
            "mu": uniform((5, d)),
            "wrkvg": w((d, 4 * d + RANK)),
            "wo": w((d, d)),
            "w0": torch.full((d,), -2.0, dtype=F32, device=device),
            "wd2": w((RANK, d), scale=0.1, dt=F32),
            "u": torch.randn((d,), generator=gen, dtype=F32, device=device)
            * 0.1,
            "ln_g": torch.ones((H, cfg.rwkv_head_dim), dtype=F32,
                               device=device),
            "ln_b": torch.zeros((H, cfg.rwkv_head_dim), dtype=F32,
                                device=device),
            "cm_mu": uniform((2, d)),
            "cm_kr": w((d, ff + d)),
            "cm_v": w((ff, d)),
        }
    return {
        "mu": uniform((5, d)),                       # r, k, v, g, w mix
        "wr": w((d, d)), "wk": w((d, d)), "wv": w((d, d)), "wg": w((d, d)),
        "wo": w((d, d)),
        "w0": torch.full((d,), -2.0, dtype=F32, device=device),
        "wd1": w((d, RANK), dt=F32),
        "wd2": w((RANK, d), scale=0.1, dt=F32),
        "u": torch.randn((d,), generator=gen, dtype=F32, device=device)
        * 0.1,                                       # bonus
        "ln_g": torch.ones((H, cfg.rwkv_head_dim), dtype=F32, device=device),
        "ln_b": torch.zeros((H, cfg.rwkv_head_dim), dtype=F32,
                            device=device),
        "cm_mu": uniform((2, d)),
        "cm_k": w((d, ff)), "cm_v": w((ff, d)), "cm_r": w((d, d)),
    }


def _shift(x, x_prev):
    """Token shift: the sequence of x_{t-1} given a chunk and the carried
    last token."""
    prev = x_prev[:, None, :]
    if prev.dtype != x.dtype:
        dt = torch.promote_types(prev.dtype, x.dtype)
        prev, x = prev.to(dt), x.to(dt)
    return torch.cat([prev, x[:, :-1, :]], dim=1)


def _mix(x, xx, m, policy):
    return act_cast(x.to(F32) * (1 - m) + xx.to(F32) * m, policy)


def _silu(x):
    return x * torch.sigmoid(x)


def _mix_scaled(w, m, widths, dtype):
    """The fused path's derived weight ``m * W``: each row i of the
    dense ``W`` (dequantized when packed) times the mixer of its column
    block, ``m[j][i]`` over the ``widths[j]`` columns of block j, in f32,
    rounded to ``dtype`` (the role's storage dtype)."""
    d = m.shape[1]
    mcat = torch.cat([m[j][:, None].expand(d, n)
                      for j, n in enumerate(widths)], dim=1)
    return (as_array(w).to(F32) * mcat).to(dtype)


def _fused_dot(x, xx, w, m, widths, policy, role):
    """``x @ W + (xx - x) @ (m * W)`` in f32 (no activation cast): the
    lerp identity of every mixed projection at once."""
    dxx = act_cast(xx.to(F32) - x.to(F32), policy)
    wm = _mix_scaled(w, m, widths, policy.dtype(role))
    return (pdot(x, w, policy, role, out_act=False)
            + pdot(dxx, wm, policy, role, out_act=False))


def _group_norm(x, g, b, eps=1e-5):
    """x: (..., H, dh) normalized per head (biased variance, as
    ``jnp.var``)."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * g + b


def time_mix(p, x, cfg, policy: PrecisionPolicy, state=None):
    """x: (B, S, d).  Returns (out, new_state); the state only when one
    is given."""
    B, S, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    x_prev = (state.x_prev_tm if state is not None
              else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xx = _shift(x, x_prev)
    mu = p["mu"]

    def mixed(i):
        return _mix(x, xx, mu[i][None, None, :], policy)

    # the decay LoRA in f32 (wd1 / wd2 are f32 at init, bf16 once
    # ``optim.adamw.materialize_params`` stores them as attn_w: JAX
    # promotes them to f32 here)
    if "wrkvg" in p:
        rank = p["wrkvg"].shape[1] - 4 * d
        y = _fused_dot(x, xx, p["wrkvg"], mu, (d, d, d, d, rank), policy,
                       "attn_w")
        r = act_cast(y[..., :d], policy)
        k = act_cast(y[..., d:2 * d], policy)
        v = act_cast(y[..., 2 * d:3 * d], policy)
        g = _silu(y[..., 3 * d:4 * d].to(F32))
        lora = torch.matmul(torch.tanh(y[..., 4 * d:].to(F32)),
                            p["wd2"].to(F32))
    else:
        r = pdot(mixed(0), p["wr"], policy, "attn_w")
        k = pdot(mixed(1), p["wk"], policy, "attn_w")
        v = pdot(mixed(2), p["wv"], policy, "attn_w")
        g = _silu(pdot(mixed(3), p["wg"], policy, "attn_w").to(F32))
        lora = torch.matmul(torch.tanh(torch.matmul(mixed(4).to(F32),
                                                    p["wd1"].to(F32))),
                            p["wd2"].to(F32))
    lw = -torch.exp(p["w0"] + lora)                     # (B, S, d) <= 0

    rh = r.reshape(B, S, H, dh).to(F32)
    kh = k.reshape(B, S, H, dh).to(F32)
    vh = v.reshape(B, S, H, dh).to(F32)
    lwh = lw.reshape(B, S, H, dh)
    u = p["u"].reshape(H, dh)

    if S == 1:
        # ---- the recurrent decode step ----------------------------------
        s_in = state.s.to(F32)
        kv = kh[:, 0, :, :, None] * vh[:, 0, :, None, :]    # (B,H,dk,dv)
        o = torch.einsum("bhk,bhkv->bhv", rh[:, 0],
                         s_in + u[None, :, :, None] * kv)
        s_new = torch.exp(lwh[:, 0])[:, :, :, None] * s_in + kv
        wkv = o[:, None, :, :]                              # (B,1,H,dv)
        new_state = RwkvState(s=s_new.to(state.s.dtype),
                              x_prev_tm=x[:, -1, :],
                              x_prev_cm=state.x_prev_cm)
    else:
        # ---- the chunked parallel form ----------------------------------
        C = min(cfg.rwkv_chunk, S)
        while S % C:
            C -= 1
        nc = S // C
        rc = rh.reshape(B, nc, C, H, dh)
        kc = kh.reshape(B, nc, C, H, dh)
        vc = vh.reshape(B, nc, C, H, dh)
        lc = lwh.reshape(B, nc, C, H, dh)
        cum = torch.cumsum(lc, dim=2)                  # inclusive
        cum_ex = cum - lc                              # exclusive
        cum_end = cum[:, :, -1]                        # (B,nc,H,dh)

        # intra-chunk: A[t,i] = sum_d r_t k_i exp(cum_ex[t] - cum[i]), i<t
        expo = cum_ex[:, :, :, None, :, :] - cum[:, :, None, :, :, :]
        prod = (torch.exp(expo) * rc[:, :, :, None, :, :]
                * kc[:, :, None, :, :, :])
        A = torch.sum(prod, dim=-1)                    # (B,nc,C,C,H)
        ti = torch.tril(torch.ones((C, C), dtype=F32, device=x.device), -1)
        A = A * ti[None, None, :, :, None]
        o_intra = torch.einsum("bntih,bnihv->bnthv", A, vc)
        bonus = torch.einsum("bnthd,bnthd->bnth",
                             rc * u[None, None, None, :, :], kc)
        o_intra = o_intra + bonus[..., None] * vc

        # cross-chunk state through the scan
        k_tail = kc * torch.exp(cum_end[:, :, None] - cum)
        contrib = torch.einsum("bnthk,bnthv->bnhkv", k_tail, vc)
        a_chunk = torch.exp(cum_end)                   # (B,nc,H,dk)
        a_sc, s_sc = associative_scan(linear_combine, (a_chunk, contrib),
                                      dim=1)
        s0 = (state.s.to(F32) if state is not None
              else torch.zeros((B, H, dh, dh), dtype=F32, device=x.device))
        # inclusive -> exclusive (the state entering each chunk)
        s_in = torch.cat([s0[:, None], a_sc[:, :-1, ..., None]
                          * s0[:, None] + s_sc[:, :-1]], dim=1)
        r_tilde = rc * torch.exp(cum_ex)
        o_inter = torch.einsum("bnthk,bnhkv->bnthv", r_tilde, s_in)

        wkv = (o_intra + o_inter).reshape(B, S, H, dh)
        new_state = None
        if state is not None:
            s_fin = a_sc[:, -1][..., None] * s0 + s_sc[:, -1]
            new_state = RwkvState(s=s_fin.to(state.s.dtype),
                                  x_prev_tm=x[:, -1, :],
                                  x_prev_cm=state.x_prev_cm)

    o = _group_norm(wkv, p["ln_g"], p["ln_b"]).reshape(B, S, d)
    o = act_cast(o * g, policy)
    return pdot(o, p["wo"], policy, "attn_w"), new_state


def channel_mix(p, x, cfg, policy: PrecisionPolicy, state=None):
    """The squared-relu channel mix gated by its receptance.  Returns
    (out, new_state); the state only when one is given."""
    B, S, d = x.shape
    x_prev = (state.x_prev_cm if state is not None
              else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xx = _shift(x, x_prev)
    m = p["cm_mu"]
    if "cm_kr" in p:
        ff = p["cm_v"].shape[0]
        y = _fused_dot(x, xx, p["cm_kr"], m, (ff, d), policy, "ffn_w")
        kk, rr = y[..., :ff], y[..., ff:]
    else:
        kk = pdot(_mix(x, xx, m[0], policy), p["cm_k"], policy, "ffn_w",
                  out_act=False)
        rr = pdot(_mix(x, xx, m[1], policy), p["cm_r"], policy, "ffn_w",
                  out_act=False)
    kk = torch.relu(kk.to(F32))
    kk = act_cast(kk * kk, policy)
    vv = pdot(kk, p["cm_v"], policy, "ffn_w")
    rr = torch.sigmoid(rr.to(F32))
    out = act_cast(rr * vv.to(F32), policy)
    new_state = None
    if state is not None:
        new_state = state._replace(x_prev_cm=x[:, -1, :])
    return out, new_state


def rwkv_init_state(cfg, batch, policy, device=None) -> RwkvState:
    """Zero states: ``s`` in the ``kv_cache`` dtype, the token shifts in
    the activation dtype in native mode (f32 in emulated mode)."""
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = d // dh
    dt = policy.dtype("kv_cache")
    adt = policy.dtype("act") if policy.mode == "native" else F32
    return RwkvState(
        s=torch.zeros((batch, H, dh, dh), dtype=dt, device=device),
        x_prev_tm=torch.zeros((batch, d), dtype=adt, device=device),
        x_prev_cm=torch.zeros((batch, d), dtype=adt, device=device))
