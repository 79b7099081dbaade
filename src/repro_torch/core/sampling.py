"""The ``sampling`` primitive: β peer steps per worker.

The port's counterpart of :mod:`repro.core.sampling`, in two halves:

* the host samplers of the event engine
  (:mod:`repro_torch.core.simulator`), plain numpy copies drawing in the
  reference's order: :class:`CentralSampler` (the *centralised*
  scenario: the server holds the step vector, sampling "is as trivial as
  a counting process", paper §5) and :class:`OverlaySampler` (the
  *distributed* scenario: samples through a structured overlay,
  :mod:`repro_torch.core.overlay`, charging O(β log N) hops);
* the index core on tensors (``sample_peer_indices_jax`` /
  ``sample_alive_peer_indices_jax`` / ``sample_steps_jax`` in the
  reference).  These functions take their uniform noise as an input, so
  a fused kernel and this plain version can be held to the *identical*
  sample: one selects by sorting, the kernel by an equivalent rank test.

Selection order is ``(score, index)``: the k smallest scores, ties broken
by the lower index.  That is the order ``lax.top_k(-scores, k)`` yields;
``torch.topk`` promises no order among ties, so the selection here is a
stable ascending sort.  Self and dead slots carry the sentinel score 2.0
and therefore tie with each other: compare ``take`` only where ``valid``
is true.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.overlay import ChordOverlay, FullMembershipOverlay

__all__ = ["CentralSampler", "OverlaySampler", "StepSample",
           "sample_alive_peer_indices", "sample_peer_indices",
           "sample_steps"]


@dataclasses.dataclass
class StepSample:
    """Result of one sampling call."""

    steps: np.ndarray          # i64[β] — sampled workers' current steps
    worker_ids: np.ndarray     # i64[β]
    cost_hops: int             # control-plane cost charged for this call


class CentralSampler:
    """Server-side sampling: the server already holds all steps."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def sample(self, steps: Sequence[int], beta: Optional[int],
               exclude: Optional[int] = None) -> StepSample:
        """Draw β of ``steps`` uniformly (server-side counting process)."""
        steps = np.asarray(steps)
        ids = np.arange(len(steps))
        if exclude is not None:
            keep = ids != exclude
            ids, pool = ids[keep], steps[keep]
        else:
            pool = steps
        if beta is None:  # classic barrier: full view
            return StepSample(pool, ids, cost_hops=0)
        beta = min(beta, len(pool))
        if beta == 0:
            return StepSample(pool[:0], ids[:0], cost_hops=0)
        # rejection sampling: O(β) per call instead of rng.choice's O(N)
        # permutation.  The selection is the set's iteration order, as
        # the reference's: it is part of the draw stream.
        n = len(pool)
        if beta * 4 < n:
            seen: set = set()
            while len(seen) < beta:
                for v in self._rng.integers(0, n, size=beta):
                    seen.add(int(v))
                    if len(seen) == beta:
                        break
            sel = np.fromiter(seen, dtype=np.int64)
        else:
            sel = self._rng.choice(n, size=beta, replace=False)
        # centralised: zero extra messages, a local counting process
        return StepSample(pool[sel], ids[sel], cost_hops=0)


class OverlaySampler:
    """Node-local sampling through the structured overlay.

    Each call queries β random peers for their step: β lookups of
    O(log N) hops plus β direct step queries.
    """

    def __init__(self, overlay: ChordOverlay | FullMembershipOverlay):
        self.overlay = overlay

    def sample(self, steps: Sequence[int], beta: Optional[int],
               exclude: Optional[int] = None) -> StepSample:
        """Draw β peers through the overlay, charging lookup hops."""
        steps = np.asarray(steps)
        if beta is None:
            beta = len(steps)
        peer_ids = np.asarray(self.overlay.sample(beta, exclude=exclude),
                              dtype=np.int64)
        cost = self.overlay.sample_cost_hops(len(peer_ids)) + len(peer_ids)
        return StepSample(steps[peer_ids], peer_ids, cost_hops=cost)

    def estimate_population(self) -> float:
        """Estimate N from overlay density (paper §4.3)."""
        return self.overlay.estimate_population()


def _k_smallest(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(values, indices) of the k smallest scores per row, (score, index)
    order — a stable sort keeps equal scores in index order."""
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_peer_indices(n: int, beta: int, *, exclude_self: bool = True,
                        scores: torch.Tensor | None = None,
                        u: torch.Tensor | None = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peer indices for each of ``n`` workers: ``k = min(β, n)`` draws
    without replacement, from pre-drawn uniform noise.

    β = 1 (with ``exclude_self``) uses one uniform per worker, ``u`` f32[n],
    spread over the n−1 non-self slots; larger β takes the k smallest of
    the score matrix ``scores`` f32[n, n] (self slots excluded).

    Returns:
      take: i32[n, k] sampled peer indices.
      valid: bool[n, k] — False where β exceeded the peer population.
    """
    k = min(beta, n)
    pop = n - 1 if exclude_self else n
    dev = (u if u is not None else scores).device
    if k <= 0:
        z = torch.zeros((n, 0), dtype=torch.int32, device=dev)
        return z, z.bool()
    if k == 1 and exclude_self:
        draw = torch.floor(u * max(n - 1, 1)).to(torch.int32)
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        take = torch.clamp_max(draw + (draw >= iota).to(torch.int32),
                               n - 1)[..., None]
    else:
        if exclude_self:
            eye = torch.eye(n, dtype=torch.bool, device=dev)
            scores = torch.where(eye, torch.full_like(scores, 2.0), scores)
        _, take = _k_smallest(scores, k)
    slot = torch.arange(k, device=dev)
    valid = torch.broadcast_to(slot < pop, take.shape)
    return take.to(torch.int32), valid


def sample_alive_peer_indices(alive: torch.Tensor, beta: int, *,
                              scores: torch.Tensor,
                              exclude_self: bool = True,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership-masked variant: up to ``min(β, n)`` **alive** peers each.

    Args:
      alive: bool[..., n] membership masks (leading dims are batched).
      beta: sample size β ≥ 0.
      scores: pre-drawn uniform scores f32[..., n, n].
      exclude_self: do not let a worker sample itself.

    Returns:
      take: i32[..., n, k] peer indices, k = min(β, n).
      valid: bool[..., n, k] — False on dead-peer / exhausted-pool slots.
    """
    *lead, n = alive.shape
    k = min(beta, n)
    if k <= 0:
        z = torch.zeros((*lead, n, 0), dtype=torch.int32, device=alive.device)
        return z, z.bool()
    masked = ~alive[..., None, :]
    if exclude_self:
        masked = masked | torch.eye(n, dtype=torch.bool, device=alive.device)
    scores = torch.where(masked, torch.full_like(scores, 2.0), scores)
    vals, take = _k_smallest(scores, k)
    return take.to(torch.int32), vals < 1.5


def sample_steps(steps: torch.Tensor, beta: int, *,
                 exclude_self: bool = True,
                 scores: torch.Tensor | None = None,
                 u: torch.Tensor | None = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The β-sampled step counters of every worker, from pre-drawn noise.

    ``steps`` is i32[W] or a scenario batch i32[B, W]; one index draw
    (:func:`sample_peer_indices` on ``scores`` f32[W, W], or ``u`` f32[W]
    when β = 1) serves every row, and the steps are gathered per row.

    Returns:
      sampled_steps: i32[W, k] (or i32[B, W, k]), k = min(β, W).
      valid: bool of the same shape — False where β exceeded the peer
        population.
    """
    W = steps.shape[-1]
    if min(beta, W) <= 0:
        empty = steps.new_zeros(steps.shape + (0,))
        return empty, empty.bool()
    take, valid = sample_peer_indices(W, beta, exclude_self=exclude_self,
                                      scores=scores, u=u)
    peer = steps[..., take.long()]
    return peer, torch.broadcast_to(valid, peer.shape)
