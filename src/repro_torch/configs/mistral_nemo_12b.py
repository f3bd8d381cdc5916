"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx, head_dim=128.  [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
        vocab=131072, head_dim=128, rope_theta=1_000_000.0,
        norm="rmsnorm", act_fn="silu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="mistral-nemo-12b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=256, head_dim=16, norm="rmsnorm", act_fn="silu",
        gated_ffn=True, loss_chunks=2)
