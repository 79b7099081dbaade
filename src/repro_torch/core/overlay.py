"""Structured overlay (paper §3.2): the port's copy of
:mod:`repro.core.overlay`.

PSP needs two estimates — the total number of nodes and the distribution
of the nodes' current steps — and the paper obtains both by organising
nodes into a structured overlay (Chord / Kademlia).  Node identifiers are
uniform in a circular name space, so

  * the population can be estimated from the *zone density* (observed ids
    per unit of name space), and
  * walking to a uniformly random point of the name space and taking its
    successor yields a uniformly random *node*, which makes the sampling
    primitive statistically correct without any global membership view.

:class:`ChordOverlay` is a Chord-style ring with those two properties:
uniform ids, successor lookup (O(log N) hops charged), join/leave
(churn), zone-density population estimation and uniform node sampling.
The event engine (:mod:`repro_torch.core.simulator`) uses it for the
paper's "distributed scenario".  :class:`FullMembershipOverlay` is the
same interface over a known population.  Both draw from a numpy
generator in the reference's order, so a seeded sequence of joins,
leaves and samples gives the reference's ids, samples and costs.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ChordOverlay", "FullMembershipOverlay"]

ID_BITS = 64
ID_SPACE = 1 << ID_BITS


@dataclasses.dataclass
class _Node:
    node_id: int            # position on the ring
    payload: int            # application handle (worker index)


class ChordOverlay:
    """A Chord-style ring with finger-table lookup and density estimation.

    This is a *protocol-faithful simulation*: lookups count hops the way a
    real deployment would pay network round-trips, which lets the simulator
    charge control-plane costs for sampling.
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._ids: List[int] = []          # sorted ring positions
        self._nodes: Dict[int, _Node] = {}  # id -> node

    # ------------------------------------------------------------------ #
    # membership (churn)
    # ------------------------------------------------------------------ #
    def join(self, payload: int) -> int:
        """Add a node with a fresh uniform id; returns the id."""
        while True:
            nid = int(self._rng.integers(0, ID_SPACE, dtype=np.uint64))
            if nid not in self._nodes:
                break
        bisect.insort(self._ids, nid)
        self._nodes[nid] = _Node(nid, payload)
        return nid

    def leave(self, node_id: int) -> None:
        """Remove a node from the ring."""
        self._ids.remove(node_id)
        del self._nodes[node_id]

    def __len__(self) -> int:
        return len(self._ids)

    # ------------------------------------------------------------------ #
    # lookup
    # ------------------------------------------------------------------ #
    def successor(self, point: int) -> _Node:
        """First node clockwise from ``point`` (wrapping)."""
        if not self._ids:
            raise LookupError("empty overlay")
        i = bisect.bisect_left(self._ids, point)
        if i == len(self._ids):
            i = 0
        return self._nodes[self._ids[i]]

    def lookup_hops(self, point: int) -> int:
        """Number of overlay hops a finger-table lookup would take: O(log N)."""
        n = max(len(self._ids), 1)
        return max(1, int(np.ceil(np.log2(n))))

    # ------------------------------------------------------------------ #
    # the two PSP estimates (paper §3.1)
    # ------------------------------------------------------------------ #
    def estimate_population(self, probes: int = 8) -> float:
        """Zone-density estimate of N.

        Probe ``probes`` uniform points; for each, measure the arc distance to
        its successor.  Arc lengths between consecutive nodes of a uniform
        N-node ring are Exp(N/ID_SPACE) distributed, so
        N̂ = ID_SPACE / mean(arc).  (Standard Chord density estimator.)
        """
        if not self._ids:
            return 0.0
        gaps = []
        for _ in range(probes):
            p = int(self._rng.integers(0, ID_SPACE, dtype=np.uint64))
            succ = self.successor(p)
            gap = (succ.node_id - p) % ID_SPACE
            gaps.append(gap + 1)
        return float(ID_SPACE / np.mean(gaps))

    def sample(self, beta: int, exclude: Optional[int] = None) -> List[int]:
        """Uniformly sample β node payloads via random-point successor walks.

        Duplicate draws are rejected (sampling without replacement, as
        Theorem 2 specifies).  Cost: β · O(log N) overlay hops.
        """
        if len(self._ids) == 0:
            return []
        beta = min(beta, len(self._ids) - (1 if exclude is not None else 0))
        found: Dict[int, int] = {}
        guard = 0
        while len(found) < beta and guard < 64 * max(beta, 1):
            guard += 1
            p = int(self._rng.integers(0, ID_SPACE, dtype=np.uint64))
            node = self.successor(p)
            if node.payload == exclude:
                continue
            found[node.node_id] = node.payload
        return list(found.values())

    def sample_cost_hops(self, beta: int) -> int:
        """Control-plane cost of one sampling call, in overlay hops."""
        return beta * self.lookup_hops(0)


class FullMembershipOverlay:
    """Degenerate overlay used when membership is known (a pod of workers).

    Exposes the same interface so the sampling primitive is backend-agnostic
    — this is precisely the decoupling the paper advocates.
    """

    def __init__(self, population: int, seed: int = 0):
        self._population = population
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._population

    def estimate_population(self, probes: int = 0) -> float:
        """Full membership knows the population exactly."""
        return float(self._population)

    def sample(self, beta: int, exclude: Optional[int] = None) -> List[int]:
        """Draw β uniform peers without replacement (self excluded)."""
        ids = np.arange(self._population)
        if exclude is not None:
            ids = ids[ids != exclude]
        beta = min(beta, len(ids))
        if beta == 0:
            return []
        return list(self._rng.choice(ids, size=beta, replace=False))

    def sample_cost_hops(self, beta: int) -> int:
        """One direct message per sampled peer."""
        return beta
