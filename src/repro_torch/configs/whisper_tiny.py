"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865, enc-dec with conv frontend (stub frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.models.base import ModelConfig


def full():
    return ModelConfig(
        arch="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536,
        vocab=51865, encoder_layers=4, encoder_len=1500, rope_theta=0.0,
        use_bias=True, norm="layernorm", act_fn="gelu", gated_ffn=False)


def reduced():
    return ModelConfig(
        arch="whisper-tiny", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=256, encoder_layers=2, encoder_len=30, rope_theta=0.0,
        use_bias=True, norm="layernorm", act_fn="gelu", gated_ffn=False,
        loss_chunks=2)
