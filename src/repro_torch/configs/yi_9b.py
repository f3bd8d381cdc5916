"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11008,
        vocab=64000, norm="rmsnorm", act_fn="silu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="yi-9b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=256, norm="rmsnorm", act_fn="silu", gated_ffn=True,
        loss_chunks=2)
