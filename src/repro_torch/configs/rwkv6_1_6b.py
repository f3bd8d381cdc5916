"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attn-free) d_ff=7168
vocab=65536, data-dependent decay.  [arXiv:2404.05892]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168,
        vocab=65536, rwkv_head_dim=64, rwkv_chunk=16, rope_theta=0.0,
        norm="layernorm", act_fn="relu2", gated_ffn=False)


def reduced():
    return ModelConfig(
        arch="rwkv6-1.6b", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=256, rwkv_head_dim=16, rwkv_chunk=8, rope_theta=0.0,
        norm="layernorm", act_fn="relu2", gated_ffn=False, loss_chunks=2)
