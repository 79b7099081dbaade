"""mamba2-780m — attention-free SSM stack with SSD (state-space duality).

[arXiv:2405.21060] 48L, d_model=1536, attn-free, vocab=50280,
ssm_state=128, expand=2 (d_inner=3072), head_dim=64 (48 SSM heads),
conv width 4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # no attention heads; SSM heads below
    n_kv_heads=1,
    d_ff=0,               # mamba blocks have no separate MLP
    vocab_size=50_280,
    head_dim=64,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
