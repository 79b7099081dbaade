"""Barrier control policies (the paper's §4.2 / §6.1), numpy/stdlib only.

The port's copy of :mod:`repro.core.barriers`.  A barrier control decides
whether a worker may advance its local step given (some view of) the
steps of other workers; the same predicate is evaluated on the full step
vector (classic BSP/SSP) or on a β-sample of it (pBSP/pSSP).

Formal definitions (paper §6.1), with ``s_i`` worker i's step and ``S`` the
evaluated subset:

    BSP :  ∀ i,j ∈ V  :  s_i = s_j
    SSP :  ∀ i,j ∈ V  :  |s_i − s_j| ≤ s
    ASP :  ⊤
    pBSP:  ∀ i,j ∈ S⊆V:  s_i = s_j
    pSSP:  ∀ i,j ∈ S⊆V:  |s_i − s_j| ≤ s

At runtime each worker evaluates the *worker-centric* form (paper §6.4):
it waits if any sampled peer lags more than ``staleness`` behind it.
These classes only declare the policy; the sweep engine reads their
fields into per-row tensors (:mod:`repro_torch.core.vector_sim`).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Sequence

import numpy as np

__all__ = ["BarrierControl", "BSP", "SSP", "ASP", "PBSP", "PSSP", "DSSP",
           "EBSP", "APBSP", "APSSP", "make_barrier", "BARRIER_REGISTRY"]


@dataclasses.dataclass(frozen=True)
class BarrierControl:
    """Base class. ``staleness`` is the bound s; ``sample_size`` is β.

    ``sample_size is None`` means "evaluate on the full state" (classic
    methods); an integer β means "evaluate on a β-sample" (probabilistic
    methods).
    """

    staleness: int = 0
    sample_size: Optional[int] = None

    #: registry name, overridden by subclasses
    name: str = "base"

    #: adaptive-policy kind: "" for the static protocols, else one of
    #: "dssp" / "ebsp" / "anneal"
    adaptive: ClassVar[str] = ""

    def view(self, steps: Sequence[int], rng: np.random.Generator,
             self_index: Optional[int] = None) -> np.ndarray:
        """Return the subset of ``steps`` this policy evaluates.

        Classic policies see all of ``steps``; probabilistic ones a
        uniform sample of size β without replacement, with the deciding
        worker (``self_index``) removed from the pool first.
        """
        steps = np.asarray(steps)
        if self.sample_size is None:
            return steps
        if self_index is not None:
            steps = np.delete(steps, self_index)
        beta = min(self.sample_size, len(steps))
        if beta == 0:
            return steps[:0]
        idx = rng.choice(len(steps), size=beta, replace=False)
        return steps[idx]

    def can_pass(self, my_step: int, steps: Sequence[int],
                 rng: np.random.Generator,
                 self_index: Optional[int] = None) -> bool:
        """Worker-centric barrier check: may a worker at ``my_step`` advance?"""
        sampled = self.view(steps, rng, self_index=self_index)
        if sampled.size == 0:
            return True
        return bool(np.all(my_step - sampled <= self.staleness))


@dataclasses.dataclass(frozen=True)
class BSP(BarrierControl):
    """Bulk Synchronous Parallel — lockstep (Algorithm 1)."""

    staleness: int = 0
    sample_size: Optional[int] = None
    name: str = "bsp"


@dataclasses.dataclass(frozen=True)
class SSP(BarrierControl):
    """Stale Synchronous Parallel — bounded staleness (Algorithm 2)."""

    staleness: int = 4
    sample_size: Optional[int] = None
    name: str = "ssp"


@dataclasses.dataclass(frozen=True)
class ASP(BarrierControl):
    """Asynchronous Parallel — no synchronisation (⊤)."""

    staleness: int = 0
    sample_size: Optional[int] = None
    name: str = "asp"

    def view(self, steps, rng, self_index=None):
        """ASP evaluates the empty subset (S = ∅)."""
        return np.asarray(steps)[:0]

    def can_pass(self, my_step, steps, rng, self_index=None):
        """ASP never blocks."""
        return True


@dataclasses.dataclass(frozen=True)
class PBSP(BarrierControl):
    """Probabilistic BSP — BSP composed with the sampling primitive."""

    staleness: int = 0
    sample_size: Optional[int] = 16
    name: str = "pbsp"


@dataclasses.dataclass(frozen=True)
class PSSP(BarrierControl):
    """Probabilistic SSP — the most general PSP method (paper Eq. 5)."""

    staleness: int = 4
    sample_size: Optional[int] = 16
    name: str = "pssp"


@dataclasses.dataclass(frozen=True)
class DSSP(BarrierControl):
    """Dynamic SSP — staleness tracked online in ``[staleness_lo, staleness]``."""

    staleness: int = 4              # upper bound s of the search range
    sample_size: Optional[int] = None
    name: str = "dssp"
    staleness_lo: int = 0           # lower bound r of the search range
    adaptive: ClassVar[str] = "dssp"


@dataclasses.dataclass(frozen=True)
class EBSP(BarrierControl):
    """Elastic BSP — per-worker sync points scheduled from a duration EMA."""

    staleness: int = 0
    sample_size: Optional[int] = None
    name: str = "ebsp"
    max_advance: int = 4            # step credit of an infinitely-fast worker
    ema_alpha: float = 0.5          # duration-EMA smoothing factor
    adaptive: ClassVar[str] = "ebsp"


@dataclasses.dataclass(frozen=True)
class APBSP(BarrierControl):
    """β-annealing pBSP — the sample size follows the observed spread."""

    staleness: int = 0
    sample_size: Optional[int] = 16  # β_max
    name: str = "apbsp"
    sample_size_lo: int = 1          # β_min
    adaptive: ClassVar[str] = "anneal"


@dataclasses.dataclass(frozen=True)
class APSSP(BarrierControl):
    """β-annealing pSSP — :class:`APBSP` with a nonzero staleness bound."""

    staleness: int = 4
    sample_size: Optional[int] = 16  # β_max
    name: str = "apssp"
    sample_size_lo: int = 1          # β_min
    adaptive: ClassVar[str] = "anneal"


BARRIER_REGISTRY = {
    "bsp": BSP,
    "ssp": SSP,
    "asp": ASP,
    "pbsp": PBSP,
    "pssp": PSSP,
    "dssp": DSSP,
    "ebsp": EBSP,
    "apbsp": APBSP,
    "apssp": APSSP,
}

#: names whose ``staleness`` field is configurable (s > 0 is meaningful)
_STALENESS_NAMES = ("ssp", "pssp", "dssp", "apssp")
#: names whose ``sample_size`` field is configurable (the β knob)
_SAMPLED_NAMES = ("pbsp", "pssp", "apbsp", "apssp")


def make_barrier(name: str, *, staleness: Optional[int] = None,
                 sample_size: Optional[int] = None,
                 staleness_lo: Optional[int] = None,
                 sample_size_lo: Optional[int] = None,
                 max_advance: Optional[int] = None,
                 ema_alpha: Optional[float] = None) -> BarrierControl:
    """Factory: ``make_barrier('pssp', staleness=4, sample_size=16)``.

    Each knob is forwarded only to the policies it parameterises, so a
    sweep can pass the same arguments to every barrier name.
    """
    name = name.lower()
    if name not in BARRIER_REGISTRY:
        raise ValueError(
            f"unknown barrier {name!r}; options: {sorted(BARRIER_REGISTRY)}")
    kwargs = {}
    if staleness is not None and name in _STALENESS_NAMES:
        kwargs["staleness"] = staleness
    if sample_size is not None and name in _SAMPLED_NAMES:
        kwargs["sample_size"] = sample_size
    if staleness_lo is not None and name == "dssp":
        kwargs["staleness_lo"] = staleness_lo
    if sample_size_lo is not None and name in ("apbsp", "apssp"):
        kwargs["sample_size_lo"] = sample_size_lo
    if max_advance is not None and name == "ebsp":
        kwargs["max_advance"] = max_advance
    if ema_alpha is not None and name == "ebsp":
        kwargs["ema_alpha"] = ema_alpha
    return BARRIER_REGISTRY[name](**kwargs)
