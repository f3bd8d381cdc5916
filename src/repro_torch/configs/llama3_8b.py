"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  [arXiv:2407.21783]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
        vocab=128256, rope_theta=500_000.0,
        norm="rmsnorm", act_fn="silu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="llama3-8b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=256, norm="rmsnorm", act_fn="silu", gated_ffn=True)
