"""Model configuration: the port's copy of ``repro.models.base`` for the
dense and MoE decoders (recurrent, prefix-LM and enc-dec fields wait
with their architectures)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe")
NORMS = ("rmsnorm", "layernorm")


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

    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (local attn)
    attn_pattern: Tuple[str, ...] = ()    # per-layer kind; all "attn"
    use_bias: bool = False
    norm: str = "rmsnorm"                 # "rmsnorm" | "layernorm"
    act_fn: str = "silu"
    gated_ffn: bool = True
    tied_embeddings: bool = False
    embed_scale: bool = False

    moe_impl: str = "dense"               # the global dispatch only
    decode_impl: str = "xla"              # attention backend spelling
    matmul_impl: str = "xla"              # matmul backend spelling
    attn_chunk: int = 4096
    loss_chunks: int = 4                  # chunked cross-entropy

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
        if self.moe_impl != "dense":
            raise ValueError(f"repro_torch ports the global MoE dispatch "
                             f"(moe_impl 'dense') only, got "
                             f"{self.moe_impl!r}")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if not self.attn_pattern:
            object.__setattr__(self, "attn_pattern",
                               ("attn",) * self.n_layers)

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
        """Exact parameter count of the decoder (the reference's formula
        for its all-attention families)."""
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
        for _ in self.attn_pattern:
            n += 2 * nrm + attn_p
            if self.moe_experts:
                n += d * self.moe_experts + self.moe_experts \
                    * self._per_expert()
            else:
                n += ffn_p
        return n + nrm  # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.param_count()
        inactive = (self.moe_experts - self.moe_topk) * self._per_expert()
        return self.param_count() - self.n_layers * inactive
