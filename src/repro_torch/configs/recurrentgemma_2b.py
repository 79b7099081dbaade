"""recurrentgemma-2b — Griffin hybrid: RG-LRU recurrence + local attention.

[arXiv:2402.19427] 26 blocks, d_model=2560, 10 heads (MQA kv=1, head 256),
d_ff=7680 (GeGLU), vocab=256000; block pattern 2 recurrent : 1 local-attn
(window 2048); 26 = 8 full (R,R,A) groups + (R,R) tail.

Counted from the parameter definitions, the model has 2,682,237,440
parameters (10.73 GB in float32); ``ModelConfig.param_count`` reports
fewer, as the reference's does, since for an ``rglru`` layer it counts
neither the block's MLP nor its block-diagonal gates.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    sliding_window=2_048,
    layer_pattern=("rglru", "rglru", "local"),
    mlp_type="geglu",
    lru_width=2560,
    conv_width=4,
    gemma_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
