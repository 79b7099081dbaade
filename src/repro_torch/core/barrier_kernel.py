"""The straggler and barrier model of the sweep tick, on tensors.

The port's counterpart of the functions of :mod:`repro.core.barrier_kernel`
that the sweep tick runs: the step-duration model, the full-view and
β-sample barrier predicates, the churn victim/joiner selection and the two
observables of the adaptive policies.  Every function is plain PyTorch on
the device of its inputs; :func:`repro_torch.kernels.psp_tick.psp_tick_ref`
composes them and the CUDA tick (``kernels/csrc/psp_tick.cu``) computes
the same values.

Two rules keep the values equal to the reference's:

* the first-index argmax is the masked min-of-iota form (max, then the
  lowest index attaining it), which is exactly ``jnp.argmax``;
* sums of booleans are cast to int32 (torch sums them to int64).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sampling import (sample_alive_peer_indices,
                                       sample_peer_indices)

__all__ = ["churn_joiner", "churn_victim", "elastic_slack",
           "full_view_allowed", "progress_gap", "sampled_allowed",
           "step_duration"]

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min


def step_duration(u: torch.Tensor, base: torch.Tensor,
                  jitter: float = 1.0) -> torch.Tensor:
    """Duration of one local step: ``base · (1 + jitter·(u − ½))``."""
    return base * (1.0 + jitter * (u - 0.5))


def full_view_allowed(steps: torch.Tensor, staleness: torch.Tensor,
                      alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classic (BSP/SSP) predicate: ``step − min(alive steps) ≤ s``."""
    masked = steps if alive is None else torch.where(
        alive, steps, torch.full_like(steps, _I32_MAX))
    return steps - masked.amin(dim=-1, keepdim=True) <= staleness


def sampled_allowed(steps: torch.Tensor, staleness: torch.Tensor,
                    k_max: int, *, beta: Optional[torch.Tensor] = None,
                    scores: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    alive: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probabilistic (pBSP/pSSP) predicate on a β-sample of ``steps``.

    Each worker draws up to ``k_max`` peers (self excluded; dead peers
    excluded when ``alive`` is given) and advances iff no sampled peer
    lags more than ``staleness`` behind it.

    Args:
      steps: i32[B, W] step counters.
      staleness: bound s, broadcastable against ``steps``.
      k_max: static sample-slot count (≥ 1).
      beta: optional per-row β broadcastable against ``steps``.
      scores: uniform scores f32[W, W] (shared) or f32[B, W, W] (masked).
      u: uniforms f32[W] for the β = 1 path (unmasked only).
      alive: optional bool[B, W] membership mask.

    Returns:
      (allowed bool[B, W], n_sampled i32[B, W]).
    """
    W = steps.shape[-1]
    if alive is None:
        take, valid = sample_peer_indices(W, k_max, scores=scores, u=u)
        peer = steps[..., take.long()]
        valid = torch.broadcast_to(valid, peer.shape)
    else:
        take, valid = sample_alive_peer_indices(alive, k_max, scores=scores)
        full = torch.broadcast_to(steps[..., None, :], take.shape[:-1] + (W,))
        peer = torch.gather(full, -1, take.long())
    if beta is not None:
        slot = torch.arange(take.shape[-1], device=steps.device)
        valid = valid & (slot < beta[..., None])
    lag_ok = steps[..., None] - peer <= staleness[..., None]
    allowed = torch.all(lag_ok | ~valid, dim=-1)
    return allowed, valid.sum(dim=-1, dtype=torch.int32)


def _first_argmax(s: torch.Tensor) -> torch.Tensor:
    """Lowest index attaining each row's maximum (``jnp.argmax``)."""
    iota = torch.arange(s.shape[-1], device=s.device)
    mx = s.amax(dim=-1, keepdim=True)
    return torch.where(s == mx, iota, s.shape[-1]).amin(dim=-1)


def churn_victim(u: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Index of the node a leave event removes: uniform over alive nodes
    (the argmax of the alive-masked uniforms; dead slots score −1)."""
    return _first_argmax(torch.where(alive, u, torch.full_like(u, -1.0)))


def churn_joiner(u: torch.Tensor, alive: torch.Tensor,
                 valid_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Index of the slot a join event revives: uniform over the dead pool
    (``valid_slot`` keeps ragged padding slots out of it)."""
    pool = ~alive if valid_slot is None else (~alive & valid_slot)
    return _first_argmax(torch.where(pool, u, torch.full_like(u, -1.0)))


def progress_gap(steps: torch.Tensor,
                 alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Observed alive-step spread ``max − min`` per row (i32; 0 when no
    worker is alive)."""
    if alive is None:
        return steps.amax(dim=-1) - steps.amin(dim=-1)
    mx = torch.where(alive, steps, torch.full_like(steps, _I32_MIN))
    mn = torch.where(alive, steps, torch.full_like(steps, _I32_MAX))
    gap = mx.amax(dim=-1) - mn.amin(dim=-1)
    return torch.where(alive.any(dim=-1), gap, torch.zeros_like(gap))


def elastic_slack(ema: torch.Tensor, max_advance: torch.Tensor,
                  alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elastic-BSP step credit ``⌊max_advance · (1 − ema_i / max(alive
    ema))⌋`` per worker (i32)."""
    live = ema if alive is None else torch.where(alive, ema,
                                                 torch.zeros_like(ema))
    mx = live.amax(dim=-1, keepdim=True)
    frac = 1.0 - ema / torch.clamp_min(mx, 1e-9)
    return torch.floor(max_advance * frac).to(torch.int32)
