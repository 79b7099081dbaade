"""qwen1.5-4b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family card] 40L, d_model=2560, 20 heads (kv=20, MHA,
head 128), d_ff=6912, vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    layer_pattern=("attn",),
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
