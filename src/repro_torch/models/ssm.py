"""Mamba-2 block with SSD (state-space duality) sequence mixing.

The port's counterpart of :mod:`repro.models.ssm` (arXiv:2405.21060).
The block::

    x ─ RMSNorm ─ in_proj ─▶ [z | x_in | B | C | dt]   (blocked layout)
                  x_in,B,C ─ causal-conv(4) ─ SiLU
                  y = SSD(x_in, dt, A, B, C) + D·x_in
                  y = RMSNorm(y · SiLU(z)) ─ out_proj

The fused in_proj keeps the reference's blocked layout: its output is
16 blocks of ``[z | x | B | C | dt]`` (``_BLOCKS``), so converted
weights mean the same in both packages.  Prefill and train run SSD in
the chunked dual form through :func:`repro_torch.kernels.ops.ssd`, so on
the card it is the hand-written SSD-scan kernel, and in training its
gradient the hand-written SSD backward; decode is the O(1) recurrence
h ← h·exp(dt·A) + dt·B⊗x in plain PyTorch, as in the reference.  The
reference's ``ssd_chunked`` is :func:`repro_torch.kernels.ssd_scan.ssd_ref`,
the plain version beside the kernel.  Both RMSNorms go through the
port's RMSNorm kernel.

Dtypes are the reference's: A = −exp(A_log) and dt = softplus(dt +
dt_bias) in float32; the projections, D and the conv weights in the
compute dtype (cast once by
:meth:`repro_torch.models.transformer.SSDBlock.weights` for serving, and
in the autograd graph on every training call, where the reference casts
them); the SSM state float32.  softplus has the reference's gradient
(sigmoid, 0.5 at 0: ``dt_bias`` starts at zeros;
:func:`repro_torch.kernels.rglru_scan.softplus`, shared with the RG-LRU
block).  The caches a call
returns are new tensors, as the reference's are: conv states (the
trailing K−1 inputs) in the compute dtype, the state in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import softplus as _softplus
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef

__all__ = ["ssd_apply", "ssd_defs"]

#: shard-block count of the projection layout (the reference's)
_BLOCKS = 16


def _widths(cfg) -> Tuple[int, int, int]:
    """Per-block widths of (z or x, B or C, dt)."""
    di, gs, nh = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    if di % _BLOCKS or nh % _BLOCKS or gs % _BLOCKS:
        raise ValueError(f"d_inner {di}, SSM heads {nh} and groups × state "
                         f"{gs} must be multiples of {_BLOCKS}")
    return di // _BLOCKS, gs // _BLOCKS, nh // _BLOCKS


def ssd_defs(cfg) -> dict:
    """Parameter definitions of one Mamba-2 block (the reference's)."""
    d = cfg.d_model
    di = cfg.d_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    nh = cfg.ssm_heads
    wz, wg, wn = _widths(cfg)
    width = 2 * wz + 2 * wg + wn          # [z | x | B | C | dt] per block
    return {
        "ln": ParamDef((d,), (None,), init="ones"),
        "in_proj": ParamDef((d, _BLOCKS, width),
                            ("d_model_w", "d_inner_w", None)),
        "conv_x_w": ParamDef((cfg.ssm_conv, di), ("conv", "d_inner_act"),
                             scale=0.1),
        "conv_x_b": ParamDef((di,), ("d_inner_act",), init="zeros"),
        "conv_b_w": ParamDef((cfg.ssm_conv, gs), ("conv", None), scale=0.1),
        "conv_b_b": ParamDef((gs,), (None,), init="zeros"),
        "conv_c_w": ParamDef((cfg.ssm_conv, gs), ("conv", None), scale=0.1),
        "conv_c_b": ParamDef((gs,), (None,), init="zeros"),
        "A_log": ParamDef((nh,), ("ssm_heads_w",), init="zeros"),
        "D": ParamDef((nh,), ("ssm_heads_w",), init="ones"),
        "dt_bias": ParamDef((nh,), ("ssm_heads_w",), init="zeros"),
        "norm": ParamDef((di,), ("d_inner_w",), init="ones"),
        "out_proj": ParamDef((di, d), ("d_inner_w", "d_model_w")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C), w: (K, C), both in the
    compute dtype; ``state`` the previous K−1 inputs (zeros if None).

    Returns (y, new_state) where new_state is the trailing K−1 inputs.
    """
    K = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[0], K - 1, x.shape[2], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    y = y + b
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state


def ssd_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, cfg,
              cache: Optional[dict] = None, mode: str = "train",
              impl: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba-2 block (norm + projections + SSD + gate + out), without
    the residual add.

    ``p`` holds the block's parameters with ``in_proj``, ``out_proj``,
    ``D`` and the conv weights in x's dtype; differentiable (the training
    forward casts them in the graph).  mode: "train" (no cache),
    "prefill" (returns the conv states and the final SSM state), "decode"
    (x is (B, 1, D); reads ``cache`` and returns a new one).
    """
    dtype = x.dtype
    B, S, D = x.shape
    di, ng, st = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    gs = ng * st
    wz, wg, _ = _widths(cfg)

    h_in = rmsnorm(x, p["ln"], cfg.norm_eps, cfg.gemma_norm, impl)
    w_in = p["in_proj"]
    proj = (h_in @ w_in.reshape(D, -1)).view(B, S, *w_in.shape[1:])
    # blocked extraction: every slice cuts the trailing dim of a block
    z = proj[..., :wz].reshape(B, S, di)
    x_in = proj[..., wz:2 * wz].reshape(B, S, di)
    Bm = proj[..., 2 * wz:2 * wz + wg].reshape(B, S, gs)
    Cm = proj[..., 2 * wz + wg:2 * wz + 2 * wg].reshape(B, S, gs)
    dt = proj[..., 2 * wz + 2 * wg:].reshape(B, S, nh)

    cs = cache or {}
    x_in, new_cx = _causal_conv(x_in, p["conv_x_w"], p["conv_x_b"],
                                cs.get("conv_x"))
    Bm, new_cb = _causal_conv(Bm, p["conv_b_w"], p["conv_b_b"],
                              cs.get("conv_b"))
    Cm, new_cc = _causal_conv(Cm, p["conv_c_w"], p["conv_c_b"],
                              cs.get("conv_c"))
    x_in = F.silu(x_in).reshape(B, S, nh, hd)
    Bm = F.silu(Bm).reshape(B, S, ng, st)
    Cm = F.silu(Cm).reshape(B, S, ng, st)

    A = -torch.exp(p["A_log"].float())
    dt = _softplus(dt.float() + p["dt_bias"])                 # (B, S, nh)

    if mode == "decode":
        rep = nh // ng
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1).float()   # (B, nh, N)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1).float()
        dA = torch.exp(dt[:, 0] * A)                          # (B, nh)
        upd = torch.einsum("bhn,bhd,bh->bhdn", Bh, x_in[:, 0].float(),
                           dt[:, 0])
        h_new = cache["ssm"] * dA[:, :, None, None] + upd
        y = torch.einsum("bhn,bhdn->bhd", Ch, h_new)
        y = y[:, None].to(dtype)                              # (B, 1, nh, hd)
        new_cache = {"conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc,
                     "ssm": h_new}
    else:
        y, h_final = ops.ssd(x_in, dt, A, Bm, Cm, impl=impl)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv_x": new_cx, "conv_b": new_cb,
                         "conv_c": new_cc, "ssm": h_final}

    y = y + x_in * p["D"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps, impl=impl)
    return y @ p["out_proj"], new_cache
