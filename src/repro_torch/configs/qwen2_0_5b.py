"""qwen2-0.5b — small dense decoder, GQA with QKV bias.

[arXiv:2407.10671] 24L, d_model=896, 14 heads (GQA kv=2, head 64),
d_ff=4864, vocab=151936, QKV bias, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    head_dim=64,
    qkv_bias=True,
    layer_pattern=("attn",),
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)
