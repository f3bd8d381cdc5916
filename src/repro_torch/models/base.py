"""Model configuration: the port's copy of ``repro.models.base`` for the
dense decoder family (MoE, recurrent, prefix-LM and enc-dec fields wait
with their architectures)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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

    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (local attn)
    attn_pattern: Tuple[str, ...] = ()    # per-layer kind; all "attn"
    use_bias: bool = False
    norm: str = "rmsnorm"
    act_fn: str = "silu"
    gated_ffn: bool = True
    tied_embeddings: bool = False
    embed_scale: bool = False

    decode_impl: str = "xla"              # attention backend spelling
    matmul_impl: str = "xla"              # matmul backend spelling
    attn_chunk: int = 4096

    def __post_init__(self):
        from repro_torch.kernels.dispatch import (validate_impl,
                                                  validate_matmul_impl)
        validate_impl(self.decode_impl, allow_none=False,
                      what="ModelConfig.decode_impl")
        validate_matmul_impl(self.matmul_impl, allow_none=False,
                             what="ModelConfig.matmul_impl")
        if self.family != "dense":
            raise ValueError(f"repro_torch ports the dense decoder only, "
                             f"got family {self.family!r}")
        if self.norm != "rmsnorm":
            raise ValueError(f"repro_torch ports rmsnorm only, got "
                             f"{self.norm!r}")
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
