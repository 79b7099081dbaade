"""The straggler and barrier model of the sweep tick, on tensors.

The port's counterpart of the functions of :mod:`repro.core.barrier_kernel`
that the sweep tick runs: the step-duration model, the full-view and
β-sample barrier predicates, the churn victim/joiner selection and the two
observables of the adaptive policies.  Every function is plain PyTorch on
the device of its inputs; :func:`repro_torch.kernels.psp_tick.psp_tick_ref`
composes them and the CUDA tick (``kernels/csrc/psp_tick.cu``) computes
the same values.  The trainer-facing classes (:class:`BarrierKernel`,
the :class:`BarrierPolicy` family and :func:`make_policy`) package them
for :mod:`repro_torch.core.spmd_psp`, with the β-sample's uniform noise
passed in (``scores`` f32[W, W], or ``u`` f32[W] on the unmasked β = 1
path; :meth:`BarrierKernel.noise_kind` says which) where the reference
draws it from a key.

Two rules keep the values equal to the reference's:

* the first-index argmax is the masked min-of-iota form (max, then the
  lowest index attaining it), which is exactly ``jnp.argmax``;
* sums of booleans are cast to int32 (torch sums them to int64).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.sampling import (sample_alive_peer_indices,
                                       sample_peer_indices)

__all__ = ["BarrierKernel", "BarrierPolicy", "BetaAnnealPolicy",
           "DSSPPolicy", "ElasticBSPPolicy", "POLICY_REGISTRY",
           "churn_joiner", "churn_victim", "elastic_slack",
           "full_view_allowed", "make_policy", "progress_gap",
           "sampled_allowed", "step_duration"]

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


@dataclasses.dataclass(frozen=True)
class BarrierKernel:
    """Trainer-facing bundle of the barrier predicate and straggler model.

    One instance fixes a barrier (name, staleness bound s, sample size β);
    :meth:`allowed` answers "may each worker advance?" for a step vector
    i32[W], from the β-sample's pre-drawn noise.
    """

    barrier: str = "pssp"           # bsp | ssp | asp | pbsp | pssp
    staleness: int = 0              # bound s (SSP family)
    beta: int = 0                   # sample slots (probabilistic family)

    @property
    def is_asp(self) -> bool:
        """ASP never blocks (the predicate is ⊤)."""
        return self.barrier == "asp"

    @property
    def is_full_view(self) -> bool:
        """Classic barriers (and dssp / ebsp stripped of their state)
        evaluate the full step vector."""
        return self.barrier in ("bsp", "ssp", "dssp", "ebsp")

    def sample_slots(self, W: int) -> int:
        """k = min(β, W − 1): the sample slots of a W-worker decide (0
        for ASP and the full-view barriers)."""
        if self.is_asp or self.is_full_view:
            return 0
        return min(self.beta, W - 1)

    def noise_kind(self, W: int, masked: bool) -> Optional[str]:
        """The β-sample noise a decide of W workers reads: ``None``,
        ``"u"`` (f32[W], unmasked β = 1) or ``"scores"`` (f32[W, W]);
        ``masked``: an alive mask is passed.  A β-annealing policy
        samples at its static β, so its noise is its parent's."""
        k = self.sample_slots(W)
        if k <= 0:
            return None
        return "u" if k == 1 and not masked else "scores"

    def allowed(self, steps: torch.Tensor,
                alive: Optional[torch.Tensor] = None, *,
                scores: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bool[W]: may each worker start its next step?"""
        if self.is_asp:
            return torch.ones(steps.shape, dtype=torch.bool,
                              device=steps.device)
        s = torch.tensor(self.staleness, dtype=steps.dtype,
                         device=steps.device)
        if self.is_full_view:
            return full_view_allowed(steps, s, alive)
        k = self.sample_slots(steps.shape[-1])
        if k <= 0:                  # S = ∅ degenerates to ASP
            return torch.ones(steps.shape, dtype=torch.bool,
                              device=steps.device)
        ok, _ = sampled_allowed(steps, torch.broadcast_to(s, steps.shape), k,
                                scores=scores, u=u, alive=alive)
        return ok

    @staticmethod
    def step_duration(u: torch.Tensor, base: torch.Tensor,
                      jitter: float = 1.0) -> torch.Tensor:
        """See :func:`step_duration`."""
        return step_duration(u, base, jitter)


State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BarrierPolicy:
    """A barrier predicate plus its decision state (base: stateless).

    ``decide(state, steps, durations, alive, scores=, u=)`` returns
    (allowed bool[W], new state); the state is a dict of tensors, and
    keys a policy does not own pass through unchanged.
    """

    kernel: BarrierKernel

    @property
    def stateful(self) -> bool:
        """Whether :meth:`init` returns a non-empty state."""
        return False

    def noise_kind(self, W: int, masked: bool) -> Optional[str]:
        """The β-sample noise :meth:`decide` reads (see
        :meth:`BarrierKernel.noise_kind`)."""
        return self.kernel.noise_kind(W, masked)

    def init(self, W: int, device=None) -> State:
        """Initial policy state for a W-worker run (empty when stateless)."""
        del W, device
        return {}

    def decide(self, state: State, steps: torch.Tensor,
               durations: Optional[torch.Tensor] = None,
               alive: Optional[torch.Tensor] = None, *,
               scores: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, State]:
        """(allowed bool[W], new_state): may each worker advance?"""
        del durations
        return self.kernel.allowed(steps, alive, scores=scores, u=u), state


@dataclasses.dataclass(frozen=True)
class DSSPPolicy(BarrierPolicy):
    """Dynamic SSP: the threshold tracks the alive-step spread, clipped
    into ``[lo, s]``; ``lo == s`` is SSP at that bound."""

    lo: int = 0

    @property
    def hi(self) -> int:
        """Upper search bound s (the kernel's static staleness)."""
        return self.kernel.staleness

    @property
    def stateful(self) -> bool:
        """True: carries the ``thr`` scalar."""
        return True

    def init(self, W: int, device=None) -> State:
        """State ``{"thr": i32[]}`` starting at the upper bound s."""
        return {"thr": torch.tensor(self.hi, dtype=torch.int32,
                                    device=device)}

    def decide(self, state, steps, durations=None, alive=None, *,
               scores=None, u=None):
        """SSP predicate at the tracked threshold; thr ← clip(gap, lo, hi)."""
        del durations, scores, u            # the full view reads no noise
        thr = state["thr"].to(steps.dtype)
        allowed = full_view_allowed(steps, thr, alive)
        gap = progress_gap(steps, alive)
        new = torch.clamp(gap, self.lo, self.hi).to(torch.int32)
        return allowed, {**state, "thr": new}


@dataclasses.dataclass(frozen=True)
class ElasticBSPPolicy(BarrierPolicy):
    """Elastic BSP: each worker's sync point is
    ``elastic_slack(ema, max_advance)`` steps ahead of the minimum; the
    EMA tracks observed step durations.  ``max_advance == 0`` is BSP."""

    max_advance: int = 4
    ema_alpha: float = 0.5

    @property
    def stateful(self) -> bool:
        """True: carries the per-worker duration EMA."""
        return True

    def init(self, W: int, device=None) -> State:
        """State ``{"ema": f32[W]}``, zeros."""
        return {"ema": torch.zeros(W, dtype=torch.float32, device=device)}

    def decide(self, state, steps, durations=None, alive=None, *,
               scores=None, u=None):
        """SSP-shaped predicate at the elastic slack; the EMA folds the
        durations."""
        del scores, u                       # the full view reads no noise
        ema = state["ema"]
        slack = elastic_slack(ema, float(self.max_advance), alive)
        allowed = full_view_allowed(steps, slack.to(steps.dtype), alive)
        if durations is not None:
            a = torch.tensor(self.ema_alpha, dtype=torch.float32,
                             device=ema.device)
            new = (1.0 - a) * ema + a * durations.float()
            ema = new if alive is None else torch.where(alive, new, ema)
        return allowed, {**state, "ema": ema}


@dataclasses.dataclass(frozen=True)
class BetaAnnealPolicy(BarrierPolicy):
    """β-annealing pBSP/pSSP: the effective β is
    ``clip(β_min + gap − s, β_min, β_max)``; the sample keeps
    ``k_max = β_max`` slots, so its noise is a static parent's."""

    beta_lo: int = 1

    @property
    def beta_hi(self) -> int:
        """Upper annealing bound β_max (the kernel's static β)."""
        return self.kernel.beta

    @property
    def stateful(self) -> bool:
        """True: carries the annealed ``beta`` scalar."""
        return True

    def init(self, W: int, device=None) -> State:
        """State ``{"beta": i32[]}`` starting at β_min (clipped to W−1)."""
        lo = min(max(self.beta_lo, 0), max(min(self.beta_hi, W - 1), 0))
        return {"beta": torch.tensor(lo, dtype=torch.int32, device=device)}

    def decide(self, state, steps, durations=None, alive=None, *,
               scores=None, u=None):
        """Sampled predicate at the annealed β; β ← clip(lo + gap − s)."""
        del durations
        W = steps.shape[-1]
        k = min(self.beta_hi, W - 1)
        gap = progress_gap(steps, alive)
        lo = min(max(self.beta_lo, 0), max(k, 0))
        new = torch.clamp(gap + (lo - self.kernel.staleness), lo,
                          max(k, 0)).to(torch.int32)
        if k <= 0:                  # S = ∅ degenerates to ASP
            return (torch.ones(steps.shape, dtype=torch.bool,
                               device=steps.device), {**state, "beta": new})
        s = torch.tensor(self.kernel.staleness, dtype=steps.dtype,
                         device=steps.device)
        ok, _ = sampled_allowed(steps, torch.broadcast_to(s, steps.shape), k,
                                beta=state["beta"], scores=scores, u=u,
                                alive=alive)
        return ok, {**state, "beta": new}


#: every barrier-policy name :func:`make_policy` accepts
POLICY_REGISTRY = ("bsp", "ssp", "asp", "pbsp", "pssp",
                   "dssp", "ebsp", "apbsp", "apssp")


def make_policy(name: str, *, staleness: int = 0, beta: int = 0,
                staleness_lo: int = 0, beta_lo: int = 1,
                max_advance: int = 4,
                ema_alpha: float = 0.5) -> BarrierPolicy:
    """A stateless :class:`BarrierPolicy` for the five static names, the
    stateful subclass with its bounds for the adaptive ones."""
    name = name.lower()
    if name not in POLICY_REGISTRY:
        raise ValueError(f"unknown barrier policy {name!r}; options: "
                         f"{sorted(POLICY_REGISTRY)}")
    kern = BarrierKernel(barrier=name, staleness=staleness, beta=beta)
    if name == "dssp":
        return DSSPPolicy(kernel=kern, lo=staleness_lo)
    if name == "ebsp":
        return ElasticBSPPolicy(kernel=kern, max_advance=max_advance,
                                ema_alpha=ema_alpha)
    if name in ("apbsp", "apssp"):
        return BetaAnnealPolicy(kernel=kern, beta_lo=beta_lo)
    return BarrierPolicy(kernel=kern)
