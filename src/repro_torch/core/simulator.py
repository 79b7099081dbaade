"""The discrete-event simulator of the paper's Actor system (§4–§5).

The port's copy of :mod:`repro.core.simulator`, numpy and the standard
library only.  It reproduces the evaluation workload: P heterogeneous
nodes training a d-parameter **linear model with SGD** through a
parameter server, under a swappable barrier control (BSP / SSP / ASP /
pBSP / pSSP and the adaptive policies), and measures what the paper
plots: per-node progress at a horizon (Fig 1a–1c), the normalized model
error ‖w − w*‖₂/‖w*‖₂ over time (Fig 1d), the server's update count over
time (Fig 1e), straggler sweeps (Fig 2) and scalability sweeps (Fig 3).

* :class:`SimConfig` mirrors the paper's experimental setup and
  :class:`SimResult` holds what the paper plots.
* :func:`draw_static_state` / :func:`sample_poisson_times` are the
  per-seed draws the sweep engine replays, so a config's ground truth,
  node speeds, straggler assignment and churn schedule are bit-identical
  to the reference's.
* :class:`Simulator` / :func:`run_simulation` — the event engine, the
  *semantic reference* the sweep engine is held to.  Its heap orders
  events by ``(t, seq, kind, node)``, and every ``self.rng`` draw sits
  where the reference's does, so a seeded run gives the reference's
  ``SimResult`` field by field.

Barrier sampling is worker-centric and self-excluding (§6.4): a worker
deciding whether to advance samples β *other* workers — centralised
through :class:`~repro_torch.core.sampling.CentralSampler` (the node's
index remapped through the alive mask under churn), distributed through
the overlay's ``exclude`` (:class:`~repro_torch.core.overlay.ChordOverlay`,
charging its hops as control messages).  Control-plane cost is tracked
apart from update messages, as the paper's Fig 1e does.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.barriers import ASP, BSP, BarrierControl
from repro_torch.core.overlay import ChordOverlay
from repro_torch.core.sampling import CentralSampler, OverlaySampler

__all__ = ["SimConfig", "SimResult", "Simulator", "run_simulation",
           "draw_static_state", "sample_poisson_times"]


@dataclasses.dataclass
class SimConfig:
    """Configuration mirroring the paper's experimental setup."""

    n_nodes: int = 100
    duration: float = 40.0          # simulated seconds (paper: 40 s)
    dim: int = 100                  # model dimensionality (paper: 1000)
    batch: int = 8                  # minibatch per local step
    #: learning rate; None ⇒ 0.5/P (server applies P concurrent pushes, so
    #: stability of the quadratic task needs P·lr < 2)
    lr: Optional[float] = None
    base_compute: float = 0.1       # mean seconds per local SGD step
    compute_jitter: float = 0.5     # U[1−j/2, 1+j/2] multiplicative noise
    straggler_frac: float = 0.0     # fraction of slow nodes (Fig 2)
    straggler_slowdown: float = 4.0  # slow nodes are this many × slower
    barrier: BarrierControl = dataclasses.field(default_factory=BSP)
    distributed_sampling: bool = False  # node-local sampling via overlay
    poll_interval: float = 0.02     # waiting-node recheck cadence (sampled)
    measure_interval: float = 0.5   # error/progress trace cadence
    noise_std: float = 0.1          # label noise of the linear task
    churn_join_rate: float = 0.0    # nodes joining per second
    churn_leave_rate: float = 0.0   # nodes leaving per second
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    """Measured outputs of one simulation (the paper's Fig-1 traces)."""

    steps: np.ndarray               # i64[P] final per-node progress
    times: np.ndarray               # f64[M] measurement grid
    errors: np.ndarray              # f64[M] normalized ‖w−w*‖/‖w*‖
    server_updates: np.ndarray      # i64[M] cumulative updates at server
    control_messages: int           # overlay/sampling control-plane cost
    total_updates: int
    mean_progress: float
    final_error: float

    def lag_pmf(self) -> np.ndarray:
        """Empirical pmf of final step lags behind the leader."""
        lags = self.steps.max() - self.steps
        pmf = np.bincount(lags).astype(np.float64)
        return pmf / pmf.sum()


def draw_static_state(cfg: SimConfig,
                      rng: np.random.Generator) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Per-seed static draw: ground truth + per-node mean step times."""
    w_true = rng.normal(size=cfg.dim) / np.sqrt(cfg.dim)
    speed = 1.0 + cfg.compute_jitter * (rng.random(cfg.n_nodes) - 0.5)
    n_slow = int(round(cfg.straggler_frac * cfg.n_nodes))
    slow_ids = rng.choice(cfg.n_nodes, size=n_slow, replace=False)
    speed[slow_ids] *= cfg.straggler_slowdown
    return w_true, cfg.base_compute * speed


def sample_poisson_times(rng: np.random.Generator, rate: float,
                         duration: float) -> np.ndarray:
    """Event times of a Poisson process on (0, duration]: exponential gaps."""
    if rate <= 0.0:
        return np.empty(0)
    times: List[float] = []
    t = rng.exponential(1.0 / rate)
    while t <= duration:
        times.append(t)
        t += rng.exponential(1.0 / rate)
    return np.asarray(times)


# event kinds
_FINISH, _POLL, _MEASURE, _JOIN, _LEAVE = range(5)


class Simulator:
    """Single-run simulator.  See :func:`run_simulation` for the entry point."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        P, d = cfg.n_nodes, cfg.dim
        self.lr = cfg.lr if cfg.lr is not None else 0.5 / P

        # --- linear-regression ground truth & server model ---------------- #
        self.w_true, self.compute_time = draw_static_state(cfg, self.rng)
        self.w = np.zeros(d)
        self.w_true_norm = float(np.linalg.norm(self.w_true))

        # --- node state ---------------------------------------------------- #
        self.steps = np.zeros(P, dtype=np.int64)
        self.alive = np.ones(P, dtype=bool)
        self._all_alive = (cfg.churn_leave_rate == 0.0
                           and cfg.churn_join_rate == 0.0)
        self.pulled_w: List[np.ndarray] = [self.w.copy() for _ in range(P)]

        # --- barrier / sampling backends ----------------------------------- #
        self.barrier = cfg.barrier
        if cfg.distributed_sampling:
            self.overlay = ChordOverlay(seed=cfg.seed + 1)
            self.node_ids = [self.overlay.join(i) for i in range(P)]
            self.sampler = OverlaySampler(self.overlay)
        else:
            self.overlay = None
            self.sampler = CentralSampler(seed=cfg.seed + 1)

        # --- bookkeeping ---------------------------------------------------- #
        self.now = 0.0
        self.total_updates = 0
        self.control_messages = 0
        self._events: List[Tuple[float, int, int, int]] = []
        self._seq = itertools.count()
        self._waiting: Dict[int, int] = {}   # node -> step it wants to start
        self._trace_t: List[float] = []
        self._trace_err: List[float] = []
        self._trace_upd: List[int] = []
        # fast-path state for full-view (deterministic) barriers
        self._full_view = self.barrier.sample_size is None and \
            not isinstance(self.barrier, ASP)
        # --- adaptive barrier-policy state (dssp / ebsp / β-annealing) --- #
        # Mutable mirrors of the BarrierPolicy state pytree; static
        # barriers have kind "" and never touch them.  Decisions read the
        # current state; observations update it at this engine's natural
        # points (finishes for the step spread, starts for the duration
        # EMA) — the engines are equivalent at the distribution level.
        self._adaptive = getattr(self.barrier, "adaptive", "")
        if self._adaptive:
            cap = max(min(int(self.barrier.sample_size or 0), P - 1), 0)
            self._beta_cap = cap
            self._beta_lo = min(max(int(getattr(
                self.barrier, "sample_size_lo", 0)), 0), cap)
            self._pol_thr = int(self.barrier.staleness)
            self._pol_beta = self._beta_lo if self._adaptive == "anneal" \
                else cap
            self._pol_ema = np.zeros(P)

    # ------------------------------------------------------------------ #
    def _push(self, t: float, kind: int, node: int = -1) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, node))

    def _step_duration(self, node: int) -> float:
        # exponential-ish jitter around the node's mean (heterogeneous net+CPU)
        return float(self.compute_time[node] *
                     (0.5 + self.rng.random()))

    # ------------------------------------------------------------------ #
    # SGD mechanics
    # ------------------------------------------------------------------ #
    def _local_gradient(self, node: int) -> np.ndarray:
        """Minibatch gradient of ½‖Xw−y‖² on node-local i.i.d. data."""
        cfg = self.cfg
        X = self.rng.normal(size=(cfg.batch, cfg.dim))
        y = X @ self.w_true + cfg.noise_std * self.rng.normal(size=cfg.batch)
        w_local = self.pulled_w[node]
        return X.T @ (X @ w_local - y) / cfg.batch

    def _push_update(self, node: int) -> None:
        """Node pushes −η·∇f(w_pulled); the server applies it (data plane)."""
        g = self._local_gradient(node)
        self.w -= self.lr * g
        self.total_updates += 1

    def _pull_model(self, node: int) -> None:
        self.pulled_w[node] = self.w.copy()

    # ------------------------------------------------------------------ #
    # barrier plumbing
    # ------------------------------------------------------------------ #
    def _can_pass(self, node: int) -> bool:
        if isinstance(self.barrier, ASP):
            return True
        beta = self.barrier.sample_size
        staleness = self.barrier.staleness
        if self._adaptive == "dssp":
            # dynamic threshold searched in [staleness_lo, staleness]
            staleness = self._pol_thr
        elif self._adaptive == "ebsp":
            # per-node step credit from the duration EMA (the scalar form
            # of barrier_kernel.elastic_slack); slowest node gets 0 — BSP
            live = np.where(self.alive, self._pol_ema, 0.0)
            frac = 1.0 - self._pol_ema[node] / max(float(live.max()), 1e-9)
            staleness = int(np.floor(self.barrier.max_advance * frac))
        elif self._adaptive == "anneal":
            # annealed sample size; β = 0 samples nobody (degenerate ASP,
            # and CentralSampler draws no RNG for an empty sample)
            beta = self._pol_beta
        # avoid the O(N) alive-mask gather on the hot path when there is
        # no churn (the common case)
        all_alive = self._all_alive if hasattr(self, "_all_alive") else True
        alive_steps = self.steps if all_alive else self.steps[self.alive]
        if self.cfg.distributed_sampling and beta is not None:
            sample = self.sampler.sample(self.steps, beta, exclude=node)
            self.control_messages += sample.cost_hops
            pool = sample.steps
        else:
            # The paper's worker-centric check samples β *other* workers
            # (§6.4), so the deciding node is excluded from the pool.  Under
            # churn ``alive_steps`` is compressed, so remap the node's index
            # through the alive mask.
            self_index = node if all_alive else \
                int(np.count_nonzero(self.alive[:node]))
            sample = self.sampler.sample(alive_steps, beta,
                                         exclude=self_index)
            # centralised: counting process at the server — no extra messages
            pool = sample.steps
        if pool.size == 0:
            return True
        return bool(np.all(self.steps[node] - pool <= staleness))

    def _try_advance(self, node: int, from_poll: bool = False) -> None:
        """Barrier check; on success begin the node's next step."""
        if not self.alive[node]:
            return
        if self._can_pass(node):
            self._waiting.pop(node, None)
            self._pull_model(node)
            dur = self._step_duration(node)
            if self._adaptive == "ebsp":
                # fold the freshly drawn duration into the node's EMA —
                # the event engine's observation point for worker speed
                a = self.barrier.ema_alpha
                self._pol_ema[node] = (1.0 - a) * self._pol_ema[node] \
                    + a * dur
            self._push(self.now + dur, _FINISH, node)
        else:
            newly_waiting = node not in self._waiting
            if newly_waiting:
                self._waiting[node] = int(self.steps[node])
            if not self._full_view and (newly_waiting or from_poll):
                # sampled barriers re-draw a fresh sample after a poll
                # interval; wake-triggered re-checks of an already-waiting
                # node must not spawn a second poll chain
                self._push(self.now + self.cfg.poll_interval, _POLL, node)

    def _wake_waiters(self) -> None:
        """Re-check all waiters (global-min movement or membership change)."""
        if not self._waiting:
            return
        for node in list(self._waiting):
            self._try_advance(node)

    # ------------------------------------------------------------------ #
    # event handlers
    # ------------------------------------------------------------------ #
    def _on_finish(self, node: int) -> None:
        if not self.alive[node]:
            return
        self._push_update(node)
        old_min = int(self.steps[self.alive].min())
        self.steps[node] += 1
        thr_moved = False
        if self._adaptive in ("dssp", "anneal"):
            # observe the post-finish alive-step spread and update the
            # carried threshold / sample size (clip into the configured
            # range — the grid engines' block-3b rule at this engine's
            # per-event granularity)
            a_steps = self.steps[self.alive]
            gap = int(a_steps.max() - a_steps.min())
            if self._adaptive == "dssp":
                new = int(np.clip(gap, self.barrier.staleness_lo,
                                  self.barrier.staleness))
                thr_moved = new != self._pol_thr
                self._pol_thr = new
            else:
                self._pol_beta = int(np.clip(
                    self._beta_lo + gap - self.barrier.staleness,
                    self._beta_lo, self._beta_cap))
        self._try_advance(node)
        # full-view waiters are event-woken: on global-min movement, on a
        # DSSP threshold change, and on every finish for Elastic-BSP
        # (a finisher's restart shifts the EMA, so any waiter's slack may
        # have widened).  Wakes draw no RNG for full-view barriers, so
        # the extra re-checks cannot perturb the stream.
        if self._full_view and (
                int(self.steps[self.alive].min()) != old_min or thr_moved
                or self._adaptive == "ebsp"):
            self._wake_waiters()

    def _on_measure(self) -> None:
        err = float(np.linalg.norm(self.w - self.w_true) / self.w_true_norm)
        self._trace_t.append(self.now)
        self._trace_err.append(err)
        self._trace_upd.append(self.total_updates)
        if self.now + self.cfg.measure_interval <= self.cfg.duration + 1e-9:
            self._push(self.now + self.cfg.measure_interval, _MEASURE)

    def _on_leave(self) -> None:
        alive_ids = np.flatnonzero(self.alive)
        if len(alive_ids) > 2:
            node = int(self.rng.choice(alive_ids))
            was_min = int(self.steps[node]) == int(self.steps[alive_ids].min())
            self.alive[node] = False
            if self.overlay is not None:
                self.overlay.leave(self.node_ids[node])
            self._waiting.pop(node, None)
            # Full-view waiters have no poll chain — they are only woken by
            # the global min *moving* on a finish, which a departed node's
            # step never does, so a leave must wake them or they can block
            # forever.  Sampled waiters re-poll on their own; the eager
            # re-check when the departed node was the global minimum just
            # spares them the remaining poll interval.
            if self._full_view or was_min:
                self._wake_waiters()
        if self.cfg.churn_leave_rate > 0:
            self._push(self.now + self.rng.exponential(
                1.0 / self.cfg.churn_leave_rate), _LEAVE)

    def _on_join(self) -> None:
        # a previously departed node re-joins (bounded population model)
        dead = np.flatnonzero(~self.alive)
        if len(dead):
            node = int(self.rng.choice(dead))
            self.alive[node] = True
            self.steps[node] = int(self.steps[self.alive].max())  # fresh start
            if self.overlay is not None:
                self.node_ids[node] = self.overlay.join(node)
            self._try_advance(node)
        if self.cfg.churn_join_rate > 0:
            self._push(self.now + self.rng.exponential(
                1.0 / self.cfg.churn_join_rate), _JOIN)

    # ------------------------------------------------------------------ #
    def run(self) -> SimResult:
        """Drive the event loop to the horizon and assemble the result."""
        cfg = self.cfg
        for node in range(cfg.n_nodes):
            self._push(self._step_duration(node), _FINISH, node)
        self._push(0.0, _MEASURE)
        if cfg.churn_leave_rate > 0:
            self._push(self.rng.exponential(1.0 / cfg.churn_leave_rate), _LEAVE)
        if cfg.churn_join_rate > 0:
            self._push(self.rng.exponential(1.0 / cfg.churn_join_rate), _JOIN)

        while self._events:
            t, _, kind, node = heapq.heappop(self._events)
            if t > cfg.duration:
                break
            self.now = t
            if kind == _FINISH:
                self._on_finish(node)
            elif kind == _POLL:
                if node in self._waiting:
                    self._try_advance(node, from_poll=True)
            elif kind == _MEASURE:
                self._on_measure()
            elif kind == _LEAVE:
                self._on_leave()
            elif kind == _JOIN:
                self._on_join()

        err = float(np.linalg.norm(self.w - self.w_true) / self.w_true_norm)
        return SimResult(
            steps=self.steps.copy(),
            times=np.asarray(self._trace_t),
            errors=np.asarray(self._trace_err),
            server_updates=np.asarray(self._trace_upd),
            control_messages=self.control_messages,
            total_updates=self.total_updates,
            mean_progress=float(self.steps[self.alive].mean()),
            final_error=err,
        )


def run_simulation(cfg: SimConfig) -> SimResult:
    """Run one seeded simulation."""
    return Simulator(cfg).run()
