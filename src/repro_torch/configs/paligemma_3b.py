"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384
vocab=257216, SigLIP frontend (stub patch embeddings) + gemma backbone.
[arXiv:2407.07726]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384,
        vocab=257216, head_dim=256, prefix_len=256,
        tied_embeddings=True, embed_scale=True,
        norm="rmsnorm", act_fn="gelu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="paligemma-3b", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=128,
        vocab=256, head_dim=16, prefix_len=8,
        tied_embeddings=True, embed_scale=True,
        norm="rmsnorm", act_fn="gelu", gated_ffn=True, loss_chunks=2)
