"""Mixture-of-Experts FFN: a top-k router and experts at fixed capacity.

The port's counterpart of :mod:`repro.models.moe`, on one device: the
reference's unsharded path (``moe_apply`` without a mesh), every expert
local (``first_expert = 0``).  Its expert-parallel ``shard_map`` belongs
to the mesh slice (ROADMAP queue 1, item 15b).

Each step reproduces the reference's, since which tokens are dropped
changes the outputs:

* **router** (:func:`route`) — ``x @ router`` in the compute dtype, then
  float32 softmax, the top k and their renormalised weights
  (:func:`select`).  The top k
  come from a stable descending sort, so that of two equal scores the
  lower expert index comes first, as in ``jax.lax.top_k``
  (``torch.topk`` promises no order for ties, and bf16 logits over 128
  experts do tie); the Switch-style auxiliary loss ``E · Σ_e
  frac_tokens_e · frac_probs_e`` (no gradient through the counts);
* **dispatch** (:func:`dispatch`) — the T·k (token, expert) pairs sorted
  stably by expert; a pair's position in its expert's group is its
  index less the group's start (a left ``searchsorted``); pairs at
  positions past the capacity C (:func:`capacity`) are dropped to a dump
  slot at E·C; the kept tokens are gathered into an ``(E, C, D)``
  buffer;
* **experts** (:func:`experts`) — SwiGLU over each expert's C rows,
  batched matrix products;
* **combine** (:func:`combine`) — each token's k weighted expert outputs
  added in the compute dtype one after another, in ascending expert
  order: the order in which the reference's scatter-add meets them, so
  the sums are deterministic and need no atomics.

Gradients come from autograd, through the renormalised weights and the
auxiliary loss's mean probabilities, never the indices.

:func:`routing` records the experts each :func:`route` call picks and
can make the calls take recorded experts instead, so that a check can
hold two paths (the kernels and the plain version, bf16 and float32
compute) to each other on one routing: a top-k set that rounding flips
sends a token to other experts, which no tolerance on the outputs
describes.  Everything is
plain PyTorch: the reference computes this block without a Pallas kernel
(ROADMAP queue 1, item 10d).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

__all__ = ["capacity", "combine", "dispatch", "experts", "moe_apply",
           "moe_defs", "route", "routing", "select"]

#: the open :func:`routing` block: (its record, the experts to replay or
#: None)
_ROUTING: Optional[Tuple[List[torch.Tensor], Optional[Iterator]]] = None


def moe_defs(cfg) -> dict:
    """Parameter definitions: the router ``(d, E)`` and the experts'
    ``w_gate``/``w_up`` ``(E, d, f)`` and ``w_down`` ``(E, f, d)``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ParamDef((d, e), (None, None)),
            "w_gate": ParamDef((e, d, f), ("experts_w", None, "expert_ff_w")),
            "w_up": ParamDef((e, d, f), ("experts_w", None, "expert_ff_w")),
            "w_down": ParamDef((e, f, d), ("experts_w", "expert_ff_w", None))}


def capacity(tokens: int, cfg) -> int:
    """Rows per expert for ``tokens`` tokens: ceil(T·k/E · factor),
    padded to a multiple of 8 and at least 8 (the reference's
    ``_capacity``)."""
    c = int(math.ceil(tokens * cfg.n_experts_per_token / cfg.n_experts
                      * cfg.moe_capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def route(x: torch.Tensor, router: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing of tokens ``x`` (T, D): (renormalised top-k weights (T, k)
    f32, their experts (T, k) int64, the auxiliary loss f32[])."""
    T, k, E = x.shape[0], cfg.n_experts_per_token, cfg.n_experts
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    top_p, top_i = select(probs, k)
    if _ROUTING is not None:
        seen, replay = _ROUTING
        seen.append(top_i)
        if replay is not None:
            top_i = next(replay)
            top_p = probs.gather(1, top_i)
            top_p = top_p / top_p.sum(-1, keepdim=True)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.index_add_(0, top_i.reshape(-1),
                      torch.ones(T * k, dtype=torch.float32, device=x.device))
    aux = E * torch.sum(counts / (T * k) * probs.mean(0))
    return top_p, top_i, aux


@contextlib.contextmanager
def routing(replay: Optional[Sequence[torch.Tensor]] = None):
    """Within the block, every :func:`route` call appends the experts it
    picks (T, k) to the list this yields, in call order.  With
    ``replay``, such a list from calls of the same token counts in the
    same order, call n sends its tokens to ``replay[n]`` instead, at its
    own probabilities of those experts, renormalised (what it would have
    picked is still recorded).  Blocks do not nest; one thread."""
    global _ROUTING
    if _ROUTING is not None:
        raise RuntimeError("routing blocks do not nest")
    _ROUTING = ([], None if replay is None else iter(replay))
    try:
        yield _ROUTING[0]
    finally:
        _ROUTING = None


def select(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of ``probs`` (T, E), the lower index
    first among equal ones (``jax.lax.top_k``'s order), renormalised to
    sum to 1: (weights (T, k), experts (T, k))."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    return top_p / top_p.sum(-1, keepdim=True), top_i


def dispatch(x: torch.Tensor, top_i: torch.Tensor, cap: int, n_experts: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tokens to expert rows: (the ``(E, C, D)`` buffer, each pair's slot
    (T, k) in the flattened buffer (E·C where dropped), whether it was
    kept (T, k))."""
    T, k = top_i.shape
    dev = x.device
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    group_start = torch.searchsorted(
        se, torch.arange(n_experts, device=dev, dtype=se.dtype))
    pos = torch.arange(T * k, device=dev) - group_start[se]
    ok = pos < cap
    slot = torch.where(ok, se * cap + pos, n_experts * cap)
    # back to the (token, choice) layout of top_i, where each token's k
    # copies are rows of one expand: its backward sums them in order,
    # where a gather by token would add them with atomics on the card
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    slot, ok = slot[inv], ok[inv]
    rows = x.unsqueeze(1).expand(T, k, x.shape[1]).reshape(T * k, -1)
    buf = x.new_zeros(n_experts * cap + 1, x.shape[1]).index_copy(
        0, slot, rows)
    return (buf[:n_experts * cap].view(n_experts, cap, -1),
            slot.view(T, k), ok.view(T, k))


def experts(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert over its rows: h (E, C, D) → (E, C, D)."""
    return torch.bmm(F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up),
                     w_down)


def combine(o: torch.Tensor, top_p: torch.Tensor, top_i: torch.Tensor,
            slot: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Each token's k weighted expert rows of ``o`` (E, C, D), added in
    o's dtype in ascending expert order: y (T, D)."""
    E, C, D = o.shape
    o_flat = o.reshape(E * C, D)
    w = torch.where(ok, top_p, 0.0).to(o.dtype)[..., None]
    c = w * o_flat[slot.clamp(max=E * C - 1)]              # (T, k, D)
    c = torch.where(ok[..., None], c, 0)
    by_expert = top_i.argsort(dim=1)
    c = c.gather(1, by_expert[..., None].expand(-1, -1, D))
    y = c[:, 0]
    for j in range(1, c.shape[1]):
        y = y + c[:, j]
    return y


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on x (B, S, D), weights ``p`` in x's dtype: (y (B, S,
    D), the auxiliary loss f32[]).  Capacity is that of the call's B·S
    tokens, as in the reference."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    top_p, top_i, aux = route(xt, p["router"], cfg)
    h, slot, ok = dispatch(xt, top_i, capacity(B * S, cfg), cfg.n_experts)
    o = experts(h, p["w_gate"], p["w_up"], p["w_down"])
    return combine(o, top_p, top_i, slot, ok).view(B, S, D), aux
