"""Model/arch configuration schema (the port's copy of
``repro.configs.base``, field for field, so a configuration means the
same model in both packages).

One :class:`ModelConfig` describes any architecture in the assigned pool:
dense decoders (optionally GQA / sliding-window / logit-softcap /
local-global alternation), MoE decoders, Mamba-2 SSM stacks, RG-LRU hybrid
stacks, and the audio/VLM variants whose modality frontends are stubbed
(``input_specs`` provides precomputed frame/patch embeddings, per spec).

``layer_pattern`` declares the repeating block cycle, e.g.::

    ("attn",)                       # plain decoder
    ("local", "attn")               # gemma2: alternating local/global
    ("rglru", "rglru", "local")     # recurrentgemma 2:1 pattern
    ("ssd",)                        # mamba2
    ("moe",)                        # MoE decoder

The model is scanned over *pattern groups* so heterogeneous patterns still
compile to a small HLO in the reference; the port loops over layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, attention flavour, MLP, numerics."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- attention flavour --------------------------------------------- #
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"         # rope | sinusoidal
    sliding_window: Optional[int] = None   # window for "local" layers
    layer_pattern: Tuple[str, ...] = ("attn",)
    attn_softcap: Optional[float] = None   # gemma2: 50.0
    logit_softcap: Optional[float] = None  # gemma2: 30.0
    post_norms: bool = False        # gemma2: post-attn/post-mlp norms
    gemma_norm: bool = False        # RMSNorm uses (1 + w) scaling
    embed_scale: bool = False       # multiply embeddings by sqrt(d_model)

    # --- mlp ------------------------------------------------------------ #
    mlp_type: str = "swiglu"        # swiglu | geglu | gelu
    #: fuse gate+up into one (D, F, 2) matmul — one backward all-reduce
    #: instead of two (EXPERIMENTS.md §Perf, collective iteration 2)
    fuse_gateup: bool = True
    #: fuse q/k/v into one blocked (D, 16, w, hd) matmul (requires
    #: n_heads % 16 == 0 and n_kv_heads % 16 == 0 and no qkv bias)
    fuse_qkv: bool = False

    # --- moe ------------------------------------------------------------ #
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- ssm (mamba2) ----------------------------------------------------- #
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # --- rglru (recurrentgemma) ------------------------------------------- #
    lru_width: Optional[int] = None  # default d_model
    conv_width: int = 4

    # --- modality frontend stub ------------------------------------------ #
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 0        # patch/conditioning positions prepended

    # --- numerics / structure ------------------------------------------ #
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True

    # provenance (model card / paper the exact numbers come from)
    source: str = ""

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width is None and "rglru" in self.layer_pattern:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def is_moe(self) -> bool:
        """Whether the model has experts."""
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba-2 head count."""
        return self.d_inner // self.ssm_head_dim

    @property
    def n_groups(self) -> int:
        """Number of scanned pattern groups (+ tail handled separately)."""
        return self.n_layers // len(self.layer_pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        """Layers beyond the last full pattern group (e.g. RG-2b: 26 = 8·3+2)."""
        rem = self.n_layers % len(self.layer_pattern)
        return self.layer_pattern[:rem]

    def layer_kinds(self) -> Tuple[str, ...]:
        """The full per-layer block-kind sequence."""
        reps = self.n_layers // len(self.layer_pattern)
        return self.layer_pattern * reps + self.tail_pattern

    # --- parameter counting (for roofline's 6·N·D model-flops term) ----- #
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (experts active per token only
        with ``active_only``)."""
        d, L = self.d_model, self.n_layers
        kinds = self.layer_kinds()
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # unembed
        for kind in kinds:
            if kind in ("attn", "local"):
                hd = self.head_dim
                total += d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d          # o_proj
                total += self._mlp_params(active_only)
            elif kind == "moe":
                hd = self.head_dim
                total += d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
                e = (self.n_experts_per_token if active_only else self.n_experts)
                total += e * 3 * d * self.d_ff + d * self.n_experts  # experts+router
            elif kind == "ssd":
                di, ng, st = self.d_inner, self.ssm_groups, self.ssm_state
                nh = self.ssm_heads
                total += d * (2 * di + 2 * ng * st + nh)  # in_proj
                total += (di + 2 * ng * st) * self.ssm_conv  # conv
                total += di * d + 2 * nh + di              # out_proj, A/D/dt, norm
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * self.conv_width + 3 * w + w * d
            total += 2 * d                                 # norms (approx)
        return total

    def _mlp_params(self, active_only: bool) -> int:
        if self.mlp_type in ("swiglu", "geglu"):
            return 3 * self.d_model * self.d_ff
        return 2 * self.d_model * self.d_ff


@dataclasses.dataclass(frozen=True)
class InputShape:
    """An assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        """Tokens per step: sequence length × global batch."""
        return self.seq_len * self.global_batch


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
