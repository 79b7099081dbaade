"""Grouped-query attention with RoPE (or none, under sinusoidal
positions): projections, prefill and decode.

The port's counterpart of :mod:`repro.models.attention` on one device,
for full (global, ``window=None``) and sliding-window (``local``)
layers.  Train and prefill attention run through
:func:`repro_torch.kernels.ops.attention`, so on the card it is the
hand-written flash kernel, reading the grouped K/V heads natively (the
reference repeats them to H heads and pads heads for its 16-way tensor
axis; on one device that padding is the identity and is dropped), the
window as its band.  Decode attention against the cache is plain
PyTorch, as in the reference, which runs it outside any kernel.

Prefill positions start at 0 even for left-padded prompts, and pads are
attended (with a window, they fall out of the band of late queries, as
in the reference): the serving engine relies on exactly that.  Caches
are bfloat16.  A global layer's is ``(B, max_len, KV, hd)``: prefill
pads it with zeros to ``max_len``; decode writes the new key and value
at ``length`` in place.  A ``local`` layer's is a ring of ``w`` slots
(the window), position p at slot p % w: prefill keeps the last w keys
rolled into place, or pads a shorter prompt with zeros to w (w, not
``min(w, max_len)``, as the reference: the serving engine keeps
``max_len >= w``); decode writes at ``length % w`` and attends over the
``min(length + 1, w)`` filled slots (their order does not matter to
softmax).

Projections: ``wq``/``wk``/``wv`` (``(D, heads, hd)``, with biases under
``qkv_bias``), or, where the reference fuses them (``fuse_qkv``, no
bias, both head counts multiples of 16), one ``wqkv`` of shape
``(D, 16, h/16 + 2·kv/16, hd)``: per block its q heads, then k, then v.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.models.params import ParamDef

__all__ = ["attn_apply", "attn_defs", "decode_attention", "fusable_qkv"]

#: fixed block count of the fused-QKV layout, the reference's (one block
#: per shard of its 16-way tensor axis)
_QKV_BLOCKS = 16


def fusable_qkv(cfg) -> bool:
    """Whether q/k/v are one fused ``wqkv``, exactly when the reference
    fuses them (``fuse_qkv``, no bias, both head counts divide 16)."""
    return (cfg.fuse_qkv and not cfg.qkv_bias
            and cfg.n_heads % _QKV_BLOCKS == 0
            and cfg.n_kv_heads % _QKV_BLOCKS == 0)


def attn_defs(cfg) -> dict:
    """Parameter definitions: q/k/v projections, fused or not (+ q/k/v
    bias), and the output projection ``wo``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wo = ParamDef((h, hd, d), ("heads_w", None, "d_model_w"))
    if fusable_qkv(cfg):
        width = h // _QKV_BLOCKS + 2 * (kv // _QKV_BLOCKS)
        return {"wqkv": ParamDef((d, _QKV_BLOCKS, width, hd),
                                 ("d_model_w", "heads_w", None, None)),
                "wo": wo}
    defs = {
        "wq": ParamDef((d, h, hd), ("d_model_w", "heads_w", None)),
        "wk": ParamDef((d, kv, hd), ("d_model_w", "kv_heads_w", None)),
        "wv": ParamDef((d, kv, hd), ("d_model_w", "kv_heads_w", None)),
        "wo": wo,
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

    q: (B, 1, H, hd); ck/cv: (B, S, KV, hd); ``length`` entries written,
    of which the first ``min(length, S)`` are valid (a ring of S slots
    holds S once it has wrapped; slot order is irrelevant to softmax).
    The reference masks the others to -1e30, which gives them weight
    exactly 0; here they are sliced away.
    """
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    n = min(length, ck.shape[1])
    qr = (q[:, 0] * hd ** -0.5).reshape(B, KV, H // KV, hd).float()
    k = ck[:, :n].float().permute(0, 2, 3, 1)                # (B, KV, hd, S)
    v = cv[:, :n].float().transpose(1, 2)                    # (B, KV, S, hd)
    p = torch.softmax(softcap(qr @ k, attn_softcap), dim=-1)  # (B, KV, G, S)
    return (p @ v).reshape(B, 1, H, hd).to(q.dtype)


def _project(p: dict, x: torch.Tensor, cfg):
    """q (B, S, H, hd) and k, v (B, S, KV, hd) of x (B, S, D)."""
    B, S, D = x.shape
    H, KV = cfg.n_heads, cfg.n_kv_heads
    # (B, S, D) @ (D, heads·hd) → (B, S, heads, hd): the reference's
    # einsum "bsd,dhk->bshk" as one matrix product
    proj = lambda w: (x @ w.reshape(D, -1)).view(B, S, *w.shape[1:])
    if "wqkv" in p:
        # (B, S, 16, width, hd): per block its q heads, then k, then v
        nq, nkv = H // _QKV_BLOCKS, KV // _QKV_BLOCKS
        f = proj(p["wqkv"])
        return (f[:, :, :, :nq].reshape(B, S, H, -1),
                f[:, :, :, nq:nq + nkv].reshape(B, S, KV, -1),
                f[:, :, :, nq + nkv:].reshape(B, S, KV, -1))
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _prefill_cache(t: torch.Tensor, window: Optional[int],
                   max_len: Optional[int]) -> torch.Tensor:
    """The bf16 cache of a prefill's keys or values t (B, S, KV, hd): a
    ring of ``window`` slots (position p at p % window), else the
    sequence padded with zeros to ``max_len``."""
    B, S = t.shape[:2]
    if window is not None and S >= window:
        return torch.roll(t[:, S - window:], S % window, dims=1).to(
            torch.bfloat16)
    L = window if window is not None else max(S, max_len or 0)
    c = torch.zeros((B, L) + tuple(t.shape[2:]), dtype=torch.bfloat16,
                    device=t.device)
    c[:, :S] = t
    return c


def attn_apply(p: dict, x: torch.Tensor, *, cfg,
               rot: Optional[Tuple[torch.Tensor, torch.Tensor]],
               window: Optional[int] = None,
               length: Optional[int] = None, cache: Optional[dict] = None,
               mode: str = "train", max_len: Optional[int] = None,
               impl: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA attention with RoPE; weights ``p`` in x's dtype, ``rot`` the
    (cos, sin) of :func:`~repro_torch.models.layers.rope_angles` at
    x's positions (None under ``cfg.pos_embed == "sinusoidal"``, whose
    positions are added to the embeddings instead: q and k are not
    rotated, as in the reference); ``window`` a ``local`` layer's sliding
    window (None: global).

    mode: "train" (no cache), "prefill" (returns a cache: padded to
    ``max_len``, or the window's ring), "decode" (x is (B, 1, D); writes
    the new key and value at ``length`` of ``cache``, or at
    ``length % w`` of a ring, in place and attends to the ``length + 1``
    entries, at most the ring's w).
    """
    B, S, D = x.shape
    q, k, v = _project(p, x, cfg)
    if cfg.pos_embed == "rope":
        q, k = apply_rope(q, *rot), apply_rope(k, *rot)

    new_cache = None
    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        slot = length % ck.shape[1] if window is not None else length
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        o = decode_attention(q, ck, cv, length + 1,
                             attn_softcap=cfg.attn_softcap)
        new_cache = {"k": ck, "v": cv}
    else:
        o = ops.attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap, impl=impl)
        if mode == "prefill":
            new_cache = {"k": _prefill_cache(k, window, max_len),
                         "v": _prefill_cache(v, window, max_len)}
    wo = p["wo"]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]), new_cache
