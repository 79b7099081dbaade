"""Models of the port: the decoder for attention blocks, global
(``attn``) and sliding-window (``local``) in any pattern (qwen2-0.5b,
qwen1.5-4b, h2o-danube-1.8b, gemma2-27b), for attention with a
mixture-of-experts FFN (``moe``: qwen3-moe-30b-a3b, dbrx-132b), for
Mamba-2 ``ssd`` blocks
(mamba2-780m), and for RG-LRU blocks mixed with local attention
(recurrentgemma-2b)."""
from repro_torch.models.transformer import (Block, Model, RGLRUBlock,
                                            SSDBlock, cache_defs,
                                            decode_step, forward,
                                            forward_train, init_cache,
                                            init_model, loss_fn, model_defs,
                                            prefill, unembed_matrix)

__all__ = ["Block", "Model", "RGLRUBlock", "SSDBlock", "cache_defs",
           "decode_step", "forward", "forward_train", "init_cache",
           "init_model", "loss_fn", "model_defs", "prefill",
           "unembed_matrix"]
