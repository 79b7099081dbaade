"""h2o-danube-1.8b — dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L, d_model=2560, 32 heads (GQA kv=8), d_ff=6912,
vocab=32000, SWA (mistral-style sliding window).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    head_dim=80,
    sliding_window=4_096,
    layer_pattern=("local",),       # every layer sliding-window
    mlp_type="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2401.16818",
)
