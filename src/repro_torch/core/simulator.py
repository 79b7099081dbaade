"""Scenario configuration, results and the per-seed static draws.

The port's copy of the numpy parts of :mod:`repro.core.simulator`:
:class:`SimConfig` mirrors the paper's experimental setup (P heterogeneous
nodes training a d-parameter linear model with SGD through a parameter
server, under a swappable barrier control), :class:`SimResult` holds what
the paper plots, and :func:`draw_static_state` /
:func:`sample_poisson_times` are the per-seed draws the sweep engine
replays, so a config's ground truth, node speeds, straggler assignment
and churn schedule are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.barriers import BSP, BarrierControl

__all__ = ["SimConfig", "SimResult", "draw_static_state",
           "sample_poisson_times"]


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
