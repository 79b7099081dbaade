"""Mixture-of-Experts FFN: a top-k router and experts at fixed capacity.

The port's counterpart of :mod:`repro.models.moe`: on one device the
reference's unsharded path (``moe_apply`` without a mesh), every expert
local (``first_expert = 0``); over a mesh of ranks with a ``model`` axis
its expert-parallel path (:func:`moe_apply` with ``mesh``), as the
reference's ``shard_map`` lays it out: each ``model`` rank computes
E/model experts starting at ``first = rank · E/model`` on its tokens
(replicated over ``model``, split over ``pod`` × ``data``), at the
capacity of its local token count, and the outputs are summed over
``model`` — no all-to-all.  ``aux`` is averaged over the data axes.

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
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import current_rules

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


def dispatch(x: torch.Tensor, top_i: torch.Tensor, cap: int, n_experts: int,
             first: int = 0, n_local: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tokens to expert rows: (the ``(E, C, D)`` buffer, each pair's slot
    (T, k) in the flattened buffer (E·C where dropped), whether it was
    kept (T, k)).

    With ``n_local``, only experts ``first … first + n_local − 1`` are
    this rank's: the buffer is ``(n_local, C, D)`` and a pair sent to
    another rank's expert counts as not kept here.  A pair's position
    in its expert's group is over all E experts' groups, so each
    expert keeps the same tokens as on one device."""
    T, k = top_i.shape
    dev = x.device
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    group_start = torch.searchsorted(
        se, torch.arange(n_experts, device=dev, dtype=se.dtype))
    pos = torch.arange(T * k, device=dev) - group_start[se]
    ok = pos < cap
    if n_local is not None:
        loc = se - first
        ok = ok & (loc >= 0) & (loc < n_local)
        se, n_experts = loc, n_local
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


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on x (B, S, D), weights ``p`` in x's dtype: (y (B, S,
    D), the auxiliary loss f32[]).  Capacity is that of the call's B·S
    tokens, as in the reference.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.HostMesh`; default the
    current rules' mesh when it is one) with a ``model`` axis of size
    > 1 that divides E runs the expert-parallel path: x is this rank's
    tokens (the same on every ``model`` rank of its data row), and the
    expert leaves of ``p`` are either all E experts or this rank's
    E/model (:func:`repro_torch.convert.expert_slice`).  Otherwise, or
    without a mesh, it is the one-device path.
    """
    B, S, D = x.shape
    if mesh is None:
        rules = current_rules()
        mesh = rules.mesh if rules is not None else None
    model = _model_ranks(mesh, cfg.n_experts)
    xt = x.reshape(B * S, D)
    top_p, top_i, aux = route(xt, p["router"], cfg)
    if not model:
        h, slot, ok = dispatch(xt, top_i, capacity(B * S, cfg),
                               cfg.n_experts)
        o = experts(h, p["w_gate"], p["w_up"], p["w_down"])
        return combine(o, top_p, top_i, slot, ok).view(B, S, D), aux
    e_loc = cfg.n_experts // model
    over = collectives.mesh_axis(mesh, "model")
    first = collectives.axis_index(over) * e_loc
    w = {k: (p[k][first:first + e_loc] if p[k].shape[0] == cfg.n_experts
             else p[k]) for k in ("w_gate", "w_up", "w_down")}
    # the tokens and weights that reach this rank's experts: their
    # gradients are this rank's part, summed over `model` (the auxiliary
    # loss's part, the same on every rank, is not)
    h, slot, ok = dispatch(_GradSumOver.apply(xt, over), top_i,
                           capacity(B * S, cfg), cfg.n_experts, first, e_loc)
    o = experts(h, w["w_gate"], w["w_up"], w["w_down"])
    y = _SumOver.apply(combine(o, _GradSumOver.apply(top_p, over), top_i,
                               slot, ok), over)
    data = collectives.mesh_axis(
        mesh, [a for a in ("pod", "data") if a in mesh.axis_names])
    aux = _SumOver.apply(aux, data) / collectives.axis_size(data)
    return y.view(B, S, D), aux


def _model_ranks(mesh, n_experts: int) -> int:
    """The ``model`` axis size when ``mesh`` is a mesh of ranks whose
    ``model`` axis (> 1) divides E; else 0 (the one-device path)."""
    if mesh is None or not hasattr(mesh, "get_group") \
            or "model" not in mesh.axis_names:
        return 0
    model = int(mesh.shape["model"])
    return model if model > 1 and n_experts % model == 0 else 0


class _GradSumOver(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the ranks of
    an axis: a tensor that is the same on every rank and feeds each
    rank's share of a sum gets the gradients of every share."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return collectives.psum(g.float(), ctx.axis).to(g.dtype), None


class _SumOver(torch.autograd.Function):
    """The sum of a tensor over the ranks of an axis (in float32, back
    in the input's dtype).  The backward passes the gradient through
    unchanged: what consumes the sum is the same on every rank of the
    axis, so each rank's part gets the sum's gradient."""

    @staticmethod
    def forward(ctx, t, axis):
        return collectives.psum(t.float(), axis).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None
