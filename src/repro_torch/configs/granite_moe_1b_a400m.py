"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512,
        vocab=49155, moe_experts=32, moe_topk=8,
        norm="rmsnorm", act_fn="silu", gated_ffn=True,
        tied_embeddings=True)


def reduced():
    return ModelConfig(
        arch="granite-moe-1b-a400m", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=32,
        vocab=256, moe_experts=4, moe_topk=2,
        norm="rmsnorm", act_fn="silu", gated_ffn=True,
        tied_embeddings=True, loss_chunks=2)
