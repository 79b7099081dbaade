"""Grouped-query attention with RoPE: projections, prefill and decode.

The port's counterpart of :mod:`repro.models.attention` for full
(global) attention layers on one device.  Prefill attention runs through
:func:`repro_torch.kernels.ops.attention`, so on the card it is the
hand-written flash kernel, reading the grouped K/V heads natively (the
reference repeats them to H heads and pads heads for its 16-way tensor
axis; on one device that padding is the identity and is dropped).
Decode attention against the cache is plain PyTorch, as in the
reference, which runs it outside any kernel.

Prefill positions start at 0 even for left-padded prompts, and pads are
attended: the serving engine relies on exactly that.  Caches are
bfloat16 ``(B, max_len, KV, hd)``: prefill pads them with zeros to
``max_len``; decode writes the new key and value at ``length`` in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.models.params import ParamDef

__all__ = ["attn_apply", "attn_defs", "decode_attention"]


def attn_defs(cfg) -> dict:
    """Parameter definitions: unfused q/k/v/o projections (+ q/k/v bias)."""
    if cfg.fuse_qkv:
        raise NotImplementedError("fused QKV projections: ROADMAP queue 1, "
                                  "item 10")
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("d_model_w", "heads_w", None)),
        "wk": ParamDef((d, kv, hd), ("d_model_w", "kv_heads_w", None)),
        "wv": ParamDef((d, kv, hd), ("d_model_w", "kv_heads_w", None)),
        "wo": ParamDef((h, hd, d), ("heads_w", None, "d_model_w")),
    }
    if cfg.qkv_bias:
        defs.update({
            "bq": ParamDef((h, hd), ("heads_w", None), init="zeros"),
            "bk": ParamDef((kv, hd), ("kv_heads_w", None), init="zeros"),
            "bv": ParamDef((kv, hd), ("kv_heads_w", None), init="zeros"),
        })
    return defs


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     length: int, *,
                     attn_softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, 1, H, hd); ck/cv: (B, S, KV, hd); ``length`` valid entries.
    The reference masks the entries past ``length`` to -1e30, which
    gives them weight exactly 0; here they are sliced away.
    """
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    qr = (q[:, 0] * hd ** -0.5).reshape(B, KV, H // KV, hd).float()
    k = ck[:, :length].float().permute(0, 2, 3, 1)           # (B, KV, hd, S)
    v = cv[:, :length].float().transpose(1, 2)               # (B, KV, S, hd)
    p = torch.softmax(softcap(qr @ k, attn_softcap), dim=-1)  # (B, KV, G, S)
    return (p @ v).reshape(B, 1, H, hd).to(q.dtype)


def attn_apply(p: dict, x: torch.Tensor, *, cfg,
               rot: Tuple[torch.Tensor, torch.Tensor],
               length: Optional[int] = None, cache: Optional[dict] = None,
               mode: str = "train", max_len: Optional[int] = None,
               impl: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA attention with RoPE; weights ``p`` in x's dtype, ``rot`` the
    (cos, sin) of :func:`~repro_torch.models.layers.rope_angles` at
    x's positions.

    mode: "train" (no cache), "prefill" (returns a cache padded to
    ``max_len``), "decode" (x is (B, 1, D); writes the new key and value
    at ``length`` of ``cache`` in place and attends to ``length + 1``
    entries).
    """
    B, S, D = x.shape
    # (B, S, D) @ (D, heads·hd) → (B, S, heads, hd): the reference's
    # einsum "bsd,dhk->bshk" as one matrix product
    proj = lambda w: (x @ w.reshape(D, -1)).view(B, S, *w.shape[1:])
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = apply_rope(q, *rot), apply_rope(k, *rot)

    new_cache = None
    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        ck[:, length] = k[:, 0].to(ck.dtype)
        cv[:, length] = v[:, 0].to(cv.dtype)
        o = decode_attention(q, ck, cv, length + 1,
                             attn_softcap=cfg.attn_softcap)
        new_cache = {"k": ck, "v": cv}
    else:
        o = ops.attention(q, k, v, causal=True, window=None,
                          softcap=cfg.attn_softcap, impl=impl)
        if mode == "prefill":
            L = max(S, max_len or 0)
            new_cache = {}
            for name, t in (("k", k), ("v", v)):
                c = torch.zeros((B, L) + tuple(t.shape[2:]),
                                dtype=torch.bfloat16, device=t.device)
                c[:, :S] = t
                new_cache[name] = c
    wo = p["wo"]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]), new_cache
