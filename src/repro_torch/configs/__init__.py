"""Workload and model configurations of the port.

The paper's PSP linear task (:mod:`~repro_torch.configs.psp_linear`) and
the architecture registry: ``get_config("gemma2-27b")`` (or any other
registered name) returns the published configuration,
``reduced(cfg)`` the CPU-smoke variant of the same family (the
reference's ``repro.configs.reduced``, rule for rule).
Every architecture of the reference is registered.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.psp_linear import CONFIG, PSPLinearConfig
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen15
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [_danube, _mamba2, _qwen15, _qwen2, _gemma2,
                        _rgemma, _qwen3moe, _dbrx, _musicgen, _internvl2]}

#: archs allowed to run long_500k (sub-quadratic / windowed decode state),
#: as the reference's: pure full-attention archs skip it
LONG_CONTEXT_ARCHS = (
    "h2o-danube-1.8b",      # SWA everywhere → window-ring cache
    "recurrentgemma-2b",    # RG-LRU + local attention
    "mamba2-780m",          # constant-size SSM state
    "gemma2-27b",           # alternating local/global (global KV sharded)
)


def get_config(name: str) -> ModelConfig:
    """The registered architecture ``name``; raises ``KeyError`` for an
    unknown one."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, *, n_layers: int = 2,
            d_model: int = 256) -> ModelConfig:
    """CPU-smoke variant: same family/flavour, tiny dims.

    Keeps every structural switch (GQA ratio, pattern, softcaps, biases,
    MoE top-k, SSD dims, RG-LRU) while shrinking widths, exactly as the
    reference does, so both packages build the same reduced model.
    """
    n_heads = max(2, cfg.n_heads // 8)
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // ratio)
    head_dim = min(64, max(16, d_model // n_heads))
    pat = cfg.layer_pattern
    # keep the pattern; give patterns longer than n_layers one full group
    layers = max(n_layers, len(pat)) if len(pat) > 1 else n_layers
    if cfg.name == "recurrentgemma-2b":
        layers = 5                      # one (R,R,A) group + (R,R) tail
    changes = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=max(1, min(cfg.d_ff, 4 * d_model)) if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=(64 if cfg.sliding_window else None),
        lru_width=(d_model if cfg.lru_width else None),
        frontend_tokens=(16 if cfg.frontend_tokens else 0),
    )
    if cfg.is_moe:
        changes.update(n_experts=4, n_experts_per_token=2)
    if cfg.family == "ssm":
        changes.update(ssm_state=32, ssm_head_dim=16)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCHS", "CONFIG", "INPUT_SHAPES", "InputShape",
           "LONG_CONTEXT_ARCHS", "ModelConfig", "PSPLinearConfig",
           "get_config", "reduced"]
