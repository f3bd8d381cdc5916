"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, GQA, no-bias, tied embeddings.  [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528,
        vocab=256000, use_bias=False, tied_embeddings=True,
        norm="layernorm", act_fn="silu", gated_ffn=True)


def reduced():
    return ModelConfig(
        arch="command-r-35b", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=160,
        vocab=256, use_bias=False, tied_embeddings=True,
        norm="layernorm", act_fn="silu", gated_ffn=True, loss_chunks=2)
