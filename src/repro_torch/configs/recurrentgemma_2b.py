"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention (window 2048), 1:2 pattern.
[arXiv:2402.19427]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
        vocab=256000, head_dim=256, window=2048, rglru_width=2560,
        tied_embeddings=True, embed_scale=True,
        norm="rmsnorm", act_fn="gelu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="recurrentgemma-2b", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv=1, d_ff=128,
        vocab=256, head_dim=16, window=32, rglru_width=64,
        tied_embeddings=True, embed_scale=True,
        norm="rmsnorm", act_fn="gelu", gated_ffn=True, loss_chunks=2)
