"""internvl2-2b — VLM: InternViT vision encoder + InternLM2-1.8B LM.

[arXiv:2404.16821] LM backbone: 24L, d_model=2048, 16 heads (GQA kv=8,
head 128), d_ff=8192, vocab=92553.

The InternViT + MLP projector frontend is a stub, as in the reference:
a request or a batch carries 256 precomputed patch embeddings (one tile),
prepended to the text tokens; the language model is implemented in full.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    head_dim=128,
    layer_pattern=("attn",),
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,
    source="arXiv:2404.16821",
)
