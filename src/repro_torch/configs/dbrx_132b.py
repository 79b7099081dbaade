"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base] 40L, d_model=6144, 48 heads (GQA kv=8, head 128),
per-expert d_ff=10752, vocab=100352, 16 experts top-4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    head_dim=128,
    layer_pattern=("moe",),
    n_experts=16,
    n_experts_per_token=4,
    mlp_type="swiglu",
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
)
