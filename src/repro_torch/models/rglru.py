"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port's counterpart of :mod:`repro.models.rglru` (arXiv:2402.19427).
The temporal-mixing block, without its residual and norm::

    x ─▶ gate branch: GeLU(x·W_y)
      ─▶ x branch:    x·W_x ─ causal-conv(4) ─ RG-LRU ─┐
    out = (h ⊙ gate) · W_out                            ┘

with the gates ``r = σ(blockdiag(W_a)·x + b_a)``, ``i =
σ(blockdiag(W_x)·x + b_x)`` over ``n_heads`` diagonal blocks of the
recurrence width.  The recurrence, its gate product included, runs
through :func:`repro_torch.kernels.ops.rglru_scan`: on the card the
hand-written RG-LRU kernel, one launch per call; its plain version is a
doubling scan in float32 (the reference's ``associative_scan``).

Dtypes and roundings are the reference's: the projections, the conv and
the block-diagonal products (einsum, then the bias) in the compute
dtype; the gates, the decay and the state in float32; the state rounded
to the compute dtype before the gate product.  The conv is the Mamba-2
block's :func:`repro_torch.models.ssm._causal_conv` (the same formula
and rounding order).  Modes: "train" and "prefill" start from h = 0;
"prefill" returns ``{"conv": the trailing K−1 conv inputs (compute
dtype), "h": h at the last position (float32)}``; "decode" (x is
``(B, 1, D)``) takes one step from ``cache["h"]`` and returns a new
cache of the same form.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef
from repro_torch.models.ssm import _causal_conv

__all__ = ["F32_PARAMS", "rglru_apply", "rglru_defs"]

#: the block's parameters the reference reads in float32
F32_PARAMS = ("Lambda",)


def rglru_defs(cfg) -> dict:
    """Parameter definitions of one RG-LRU block (the reference's)."""
    d, w = cfg.d_model, cfg.lru_width
    nb = max(1, cfg.n_heads)            # block-diagonal gate blocks
    if w % nb:
        raise ValueError(f"lru_width {w} is not a multiple of {nb} blocks")
    bw = w // nb
    return {
        "w_y": ParamDef((d, w), ("d_model_w", "lru_w")),
        "w_x": ParamDef((d, w), ("d_model_w", "lru_w")),
        "conv_w": ParamDef((cfg.conv_width, w), ("conv", "lru_w"), scale=0.1),
        "conv_b": ParamDef((w,), ("lru_w",), init="zeros"),
        "a_gate_w": ParamDef((nb, bw, bw), ("ssm_heads_w", None, None)),
        "a_gate_b": ParamDef((w,), ("lru_w",), init="zeros"),
        "i_gate_w": ParamDef((nb, bw, bw), ("ssm_heads_w", None, None)),
        "i_gate_b": ParamDef((w,), ("lru_w",), init="zeros"),
        "Lambda": ParamDef((w,), ("lru_w",), init="ones"),
        "w_out": ParamDef((w, d), ("lru_w", "d_model_w")),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x (B, S, W), W = nb·bw; w (nb, bw, bw) and b (W,) in x's dtype →
    (B, S, W): the per-block product, then the bias, in x's dtype."""
    B, S, W = x.shape
    nb, bw, _ = w.shape
    y = torch.einsum("bsnw,nwv->bsnv", x.reshape(B, S, nb, bw), w)
    return y.reshape(B, S, W) + b


def rglru_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, cfg,
                cache: Optional[dict] = None, mode: str = "train",
                impl: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D) → (out (B, S, D), new cache or None); the residual and
    norm are the caller's.  ``p`` holds the block's parameters in x's
    dtype but ``Lambda`` (float32); differentiable on the plain path."""
    gate = F.gelu(x @ p["w_y"], approximate="tanh")
    xb = x @ p["w_x"]
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                cache.get("conv") if cache else None)
    r_pre = _block_diag(xb, p["a_gate_w"], p["a_gate_b"])
    i_pre = _block_diag(xb, p["i_gate_w"], p["i_gate_b"])
    h0 = cache["h"] if mode == "decode" else None
    y, h_last = ops.rglru_scan(xb, r_pre, i_pre, p["Lambda"], h0, gate,
                               impl=impl)
    new_cache = None if mode == "train" else {"conv": new_conv, "h": h_last}
    return y @ p["w_out"], new_cache
