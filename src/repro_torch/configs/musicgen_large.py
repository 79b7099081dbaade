"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284] 48L, d_model=2048, 32 heads (kv=32, i.e. full MHA),
d_ff=8192 (GELU), vocab=2048 (EnCodec codebook), sinusoidal positions.

The EnCodec codec + text-conditioning frontend is a stub, as in the
reference: a request or a batch carries 64 precomputed conditioning
embeddings, prepended to the token sequence; the language model over
audio tokens is implemented in full.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    layer_pattern=("attn",),
    mlp_type="gelu",
    pos_embed="sinusoidal",
    frontend="audio",
    frontend_tokens=64,
    fuse_qkv=True,
    source="arXiv:2306.05284",
)
