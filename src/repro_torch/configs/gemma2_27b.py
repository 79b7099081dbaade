"""gemma2-27b — dense with alternating local/global attention + softcaps.

[arXiv:2408.00118] 46L, d_model=4608, 32 heads (GQA kv=16, head 128),
d_ff=36864 (GeGLU; 2·18432 gate+up), vocab=256000; local window 4096
alternating with global layers; attention softcap 50, final-logit softcap 30;
RMSNorm(1+w) with pre+post norms; embeddings scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36_864,               # per-branch width (gate and up are each d×36864)
    vocab_size=256_000,
    head_dim=128,
    sliding_window=4_096,
    layer_pattern=("local", "attn"),   # alternating local, global
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    gemma_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    mlp_type="geglu",
    rope_theta=10_000.0,
    fuse_qkv=True,
    source="arXiv:2408.00118",
)
