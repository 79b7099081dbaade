"""qwen3-moe-30b-a3b — fine-grained MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B] 48L, d_model=2048, 32 heads (GQA kv=4, head 128),
per-expert d_ff=768, vocab=151936, 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=128,
    layer_pattern=("moe",),
    n_experts=128,
    n_experts_per_token=8,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
