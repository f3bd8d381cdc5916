"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_ff=768,
        vocab=151936, moe_experts=128, moe_topk=8,
        norm="rmsnorm", act_fn="silu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="qwen3-moe-30b-a3b", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=48,
        vocab=256, moe_experts=8, moe_topk=2,
        norm="rmsnorm", act_fn="silu", gated_ffn=True, loss_chunks=2)
