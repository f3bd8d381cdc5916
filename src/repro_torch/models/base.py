"""Model configuration: the port's copy of ``repro.models.base`` for the
dense and MoE decoders, the prefix-LM (``vlm``: a decoder over stub
patch embeddings), the attention-free ``ssm`` (rwkv6), the ``hybrid``
(RG-LRU blocks and local attention) and the encoder-decoder ``audio``
(whisper: a decoder with cross attention over an encoder of stub frame
embeddings)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
NORMS = ("rmsnorm", "layernorm")
# the global dispatch, and expert parallelism over the ambient mesh
MOE_IMPLS = ("dense", "shard_map")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_len: int = 1500               # stub frame-embedding count

    # vlm
    prefix_len: int = 0                   # stub patch-embedding count

    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (local attn)
    attn_pattern: Tuple[str, ...] = ()    # per-layer kind: attn|rwkv|rglru
    use_bias: bool = False
    norm: str = "rmsnorm"                 # "rmsnorm" | "layernorm"
    act_fn: str = "silu"
    gated_ffn: bool = True
    tied_embeddings: bool = False
    embed_scale: bool = False

    # ssm (rwkv6)
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128
    rwkv_fused: int = 0                   # the reference's experiment knob

    # hybrid (recurrentgemma)
    rglru_width: Optional[int] = None     # recurrent branch width (d_model)
    conv_width: int = 4

    moe_impl: str = "dense"               # "dense" | "shard_map"
    decode_impl: str = "xla"              # attention backend spelling
    matmul_impl: str = "xla"              # matmul backend spelling
    attn_chunk: int = 4096
    loss_chunks: int = 4                  # chunked cross-entropy
    remat: bool = True                    # recompute each block in the
    #                                       training backward

    def __post_init__(self):
        from repro_torch.kernels.dispatch import (validate_impl,
                                                  validate_matmul_impl)
        validate_impl(self.decode_impl, allow_none=False,
                      what="ModelConfig.decode_impl")
        validate_matmul_impl(self.matmul_impl, allow_none=False,
                             what="ModelConfig.matmul_impl")
        if self.family not in FAMILIES:
            raise ValueError(f"repro_torch ports the {FAMILIES} families, "
                             f"got family {self.family!r}")
        if self.norm not in NORMS:
            raise ValueError(f"repro_torch ports {NORMS}, got "
                             f"{self.norm!r}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl is one of {MOE_IMPLS}, got "
                             f"{self.moe_impl!r}")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if not self.attn_pattern:
            if self.family == "ssm":
                pat = ("rwkv",) * self.n_layers
            elif self.family == "hybrid":
                # recurrentgemma: 2 recurrent blocks then 1 local attention
                pat = tuple("attn" if (i % 3) == 2 else "rglru"
                            for i in range(self.n_layers))
            else:
                pat = ("attn",) * self.n_layers
            object.__setattr__(self, "attn_pattern", pat)
        elif len(self.attn_pattern) > self.n_layers:
            # a config cut in depth by dataclasses.replace keeps its
            # first layers' kinds
            object.__setattr__(self, "attn_pattern",
                               tuple(self.attn_pattern[:self.n_layers]))
        elif len(self.attn_pattern) < self.n_layers:
            raise ValueError(f"attn_pattern names {len(self.attn_pattern)} "
                             f"layers, n_layers is {self.n_layers}")
        if self.rglru_width is None and self.family == "hybrid":
            object.__setattr__(self, "rglru_width", self.d_model)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    def _per_expert(self) -> int:
        d, ff = self.d_model, self.d_ff
        return (2 * d * ff + ff * d) if self.gated_ffn else 2 * d * ff

    def param_count(self) -> int:
        """Exact parameter count (the reference's formula): the decoder,
        and an enc-dec config's encoder blocks and per-layer cross
        attention."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        nrm = d if self.norm == "rmsnorm" else 2 * d  # gamma (+beta)
        attn_p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.gated_ffn:
            ffn_p = 2 * d * ff + ff * d
        else:
            ffn_p = 2 * d * ff + (ff + d if self.use_bias else 0)
        n = v * d  # embedding
        if not self.tied_embeddings:
            n += v * d
        for kind in self.attn_pattern:
            n += 2 * nrm  # norm1 + norm2
            if kind == "attn":
                n += attn_p
            elif kind == "rwkv":
                # time-mix: 5 square proj + mu(5d) + w0/u (2d) + rank-64
                # decay lora (128d) + per-head groupnorm (2d);
                # channel-mix: cm_mu(2d) + k/v (2*d*ff) + receptance (d^2)
                n += 5 * d * d + 137 * d
                n += 2 * d + 2 * d * ff + d * d
                continue
            else:
                w = self.rglru_width
                n += 2 * d * w + w * d            # branch, gate, out
                n += w * self.conv_width + w      # conv + bias
                n += 2 * w * w + w                # rec/in gates + lambda
            if self.moe_experts:
                n += d * self.moe_experts + self.moe_experts \
                    * self._per_expert()
            else:
                n += ffn_p
        n += nrm  # final norm
        if self.encoder_layers:
            n += self.encoder_layers * (attn_p + 2 * nrm + ffn_p)
            n += len(self.attn_pattern) * (attn_p + nrm)  # cross attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.param_count()
        inactive = (self.moe_experts - self.moe_topk) * self._per_expert()
        return self.param_count() - self.n_layers * inactive
