"""Shared neural layers: RMSNorm, soft-capping, RoPE and sinusoidal
positions, the MLPs, embedding, the chunked cross-entropy.

The port's counterpart of :mod:`repro.models.layers`.  Every RMSNorm
goes through :func:`repro_torch.kernels.ops.rmsnorm` in the reference
model's form (``round_scale=True``: in bfloat16 the scale is rounded
before the product, as ``repro.models.layers._rms_fwd`` rounds it), so
on the card it is the CUDA kernel, and under autograd its backward is
the reference's custom VJP (``_rms_bwd``) as a CUDA kernel too.
Weights arrive in the compute dtype (see
:meth:`repro_torch.models.transformer.Model.weights` and the training
forward).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef, torch_dtype

__all__ = ["apply_rope", "chunked_cross_entropy", "embed_tokens",
           "mlp_apply", "mlp_defs", "rmsnorm", "rope", "rope_angles",
           "sinusoidal_pos", "softcap"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            gemma: bool = False, impl: str = "auto") -> torch.Tensor:
    """RMSNorm with f32 statistics; ``gemma=True`` scales by (1 + w).
    In bfloat16 it computes ``cast(x · cast(m · gain))``, the reference
    model's two roundings."""
    gain = 1.0 + w.float() if gemma else w
    return ops.rmsnorm(x, gain, eps=eps, round_scale=True, impl=impl)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap · tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE frequencies on ``device``, computed in numpy float32 as the
    reference computes them, and copied to the device once."""
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(freq).to(device)


def rope_angles(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the f32 rotation angles, each (S, 1, hd // 2), for
    integer ``positions`` (S,); one pair serves every layer."""
    angles = (positions.to(torch.float32)[:, None]
              * _rope_freq(hd // 2, float(theta), positions.device))
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, hd) by :func:`rope_angles`' (cos, sin),
    half-rotation convention, in f32; returns x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-rotation convention, f32 angles.

    x: (..., S, H, hd); positions: (S,) integer.
    """
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


@functools.lru_cache(maxsize=None)
def _sinusoid_freq(half: int, device: torch.device) -> torch.Tensor:
    """The sinusoidal frequencies exp(−ln(10⁴)·i / half) on ``device``.
    As in the reference, numpy computes them in float64 (``np.log`` of a
    Python float is a float64 scalar, which numpy 2 does not demote) and
    they are rounded to float32 once, where they meet the positions."""
    freq = np.exp(-np.log(10_000.0) * np.arange(half, dtype=np.float32)
                  / half)
    return torch.from_numpy(freq.astype(np.float32)).to(device)


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding (f32): integer positions
    (S,) → (S, d_model), the sines of the f32 angles, then the cosines."""
    ang = (positions.to(torch.float32)[:, None]
           * _sinusoid_freq(d_model // 2, positions.device))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp_defs(cfg) -> dict:
    """Parameter definitions of the MLP: the gated one (``swiglu`` or
    ``geglu``; gate and up fused), or the plain GELU one (``gelu``:
    ``w_up``, ``w_down``; ``fuse_gateup`` does not apply)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "gelu":
        return {"w_up": ParamDef((d, f), ("d_model_w", "d_ff_w")),
                "w_down": ParamDef((f, d), ("d_ff_w", "d_model_w"))}
    if cfg.mlp_type not in ("swiglu", "geglu") or not cfg.fuse_gateup:
        raise NotImplementedError(
            f"mlp_type={cfg.mlp_type!r} fuse_gateup={cfg.fuse_gateup}: the "
            "port has the fused gated MLP and the GELU MLP (no configuration "
            "of the reference unfuses gate and up)")
    # gate and up interleaved on a trailing axis of 2, as in the reference
    return {"w_gu": ParamDef((d, f, 2), ("d_model_w", "d_ff_w", None)),
            "w_down": ParamDef((f, d), ("d_ff_w", "d_model_w"))}


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Gated MLP: down(act(x·gate) · (x·up)), or the GELU MLP:
    down(gelu(x·up)) (tanh GELU, as the reference's); weights in x's
    dtype.

    ``w_gu`` is ``(d, f, 2)`` with gate and up interleaved on the last
    axis, so they are the slices ``[..., 0]`` and ``[..., 1]`` of the
    product, never halves of a ``(d, 2f)`` reshape.
    """
    if "w_gu" not in p:
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    d, f, _ = p["w_gu"].shape
    gu = (x @ p["w_gu"].reshape(d, 2 * f)).view(*x.shape[:-1], f, 2)
    g, u = gu[..., 0], gu[..., 1]
    act = (F.silu(g) if cfg.mlp_type == "swiglu"
           else F.gelu(g, approximate="tanh"))
    return (act * u) @ p["w_down"]


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Gather rows of the f32 table, then cast to the compute dtype."""
    x = embed[tokens].to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model) ** 0.5, dtype=x.dtype)
    return x


def _ce_chunk(hb: torch.Tensor, lb: torch.Tensor, unembed: torch.Tensor,
              cap: Optional[float]) -> torch.Tensor:
    """Σ of (logsumexp − gold logit) over one chunk's valid labels (f32)."""
    logits = softcap((hb @ unembed).float(), cap)           # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(lb >= 0, logz - gold, 0.0).sum()


def chunked_cross_entropy(h: torch.Tensor, labels: torch.Tensor,
                          unembed: torch.Tensor, cfg,
                          chunk: int = 512) -> torch.Tensor:
    """Causal-LM loss without materialising the full (B, S, V) logits.

    h: (B, S, D) hidden states aligned so h[:, i] predicts labels[:, i];
    unembed: (D, V), cast to h's dtype.  S is padded to a chunk multiple
    with label −1 (masked out); each chunk's logits (optionally
    soft-capped) are recomputed in the backward (``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint``), so at most one chunk's are alive.
    Returns the mean over B·S (f32).
    """
    B, S, _ = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    u = unembed.to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S + pad, chunk):
        total = total + checkpoint(_ce_chunk, h[:, i:i + chunk],
                                   labels[:, i:i + chunk], u,
                                   cfg.logit_softcap, use_reentrant=False)
    return total / (B * S)
