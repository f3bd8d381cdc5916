"""The packed parameter store: weights in their (e, m) containers.

The port of ``repro.models.qparams``: every matmul-weight leaf
(``embed_w`` / ``attn_w`` / ``ffn_w`` / ``router_w`` roles, ``head``
included) becomes a :class:`~repro_torch.core.qtensor.QTensor` in the
policy's format for its role and layer; norm scales, biases, the
recurrent layers' f32 leaves (token-shift mixers, decay LoRA, bonus,
group norm, conv filter, lambda) and the embedding *table* (consumed by
a gather) stay plain tensors.  A leaf under ``params["layers"][li]``
(a decoder layer's, its cross attention ``xattn`` included) resolves its
format at layer ``li``; any other leaf (the embedding, the head, an
enc-dec config's ``params["encoder"]``) at the policy's global binding,
as :func:`param_layer` gives None for it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qtensor import QTensor

# the role each call site passes: "wk"/"wv"/"wo" are shared by attention
# and rwkv's time mix, both under "attn_w"; rglru's gates pack under
# "attn_w" although the reference makes them in the ffn_w dtype
_ATTN_W = ("wq", "wk", "wv", "wo", "wr", "wg", "wrkvg", "w_rec_gate",
           "w_in_gate")
_FFN_W = ("w_in", "w_gate", "w_out", "cm_k", "cm_v", "cm_r", "cm_kr",
          "w_branch")
ROLE_BY_NAME = {
    **{n: "attn_w" for n in _ATTN_W},
    **{n: "ffn_w" for n in _FFN_W},
    "head": "embed_w",
    "router": "router_w",
}
PACK_ROLES = ("embed_w", "attn_w", "ffn_w", "router_w")


def map_tree(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` to every tensor / QTensor leaf of a
    nested dict/list tree; ``path`` is the tuple of keys and indices."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    out = []
    map_tree(lambda _, leaf: out.append(leaf), tree)
    return out


def param_role(path) -> Optional[str]:
    name = next((p for p in reversed(path) if isinstance(p, str)), None)
    return ROLE_BY_NAME.get(name) if name is not None else None


def param_layer(path) -> Optional[int]:
    for i, p in enumerate(path[:-1]):
        if p == "layers" and isinstance(path[i + 1], int):
            return path[i + 1]
    return None


def encode_params(params, policy: PrecisionPolicy, *,
                  roles: tuple = PACK_ROLES):
    """Pack every matmul-weight leaf into its policy-role container.  In
    native mode a leaf already holds exact members of its format, so the
    payload is a bitcast of it."""
    def enc(path, leaf):
        role = param_role(path)
        if role is None or role not in roles or isinstance(leaf, QTensor):
            return leaf
        return QTensor.quantize(leaf, policy.fmt(role, param_layer(path)))
    return map_tree(enc, params)


def as_array(w, dtype=None) -> torch.Tensor:
    """A packed-or-plain weight as a dense tensor: a :class:`QTensor`
    dequantized (``dequantize_decode`` on a card), a plain one as it is;
    ``dtype`` casts the result.  For the few sites that scale a weight
    elementwise before a product (rwkv's fused token shift)."""
    arr = w.dequantize() if isinstance(w, QTensor) else w
    return arr if dtype is None else arr.to(dtype)


def packed_bytes(params) -> int:
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def describe_packing(params, packed) -> str:
    raw, pk = packed_bytes(params), packed_bytes(packed)
    return (f"packed weight store: {pk / 1e6:.1f} MB "
            f"(vs {raw / 1e6:.1f} MB unpacked, {raw / max(pk, 1):.2f}x)")
