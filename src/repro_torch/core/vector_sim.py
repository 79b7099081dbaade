"""Batched sweep engine: scenario grouping, static state and results.

The port's counterpart of :mod:`repro.core.vector_sim`, without the numpy
tick methods: every batch runs on the tensor engine
(:mod:`repro_torch.core.vector_sim_torch`).  :class:`VectorSimulator`
builds a batch's static state exactly as the reference does — the same
per-seed draws (:func:`repro_torch.core.simulator.draw_static_state`),
the same batch dynamics stream for the initial busy clocks and churn
schedules — so a config's ground truth, node speeds, straggler
assignment, initial clocks and churn schedule are bit-identical to the
reference's.

:func:`run_sweep` is the entry point::

    from repro_torch.core import SimConfig, make_barrier, run_sweep
    results = run_sweep(configs)                 # on the GPU
    results = run_sweep(configs, device="cpu")   # plain PyTorch tick

Configs are grouped like the reference's jax backend, by
:func:`_merge_key`: ragged ``n_nodes`` (padded with permanently dead
slots), churn-ness and duration (rows freeze at their own horizon) merge
into one batch.  Results come back in input order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.barriers import ASP
from repro_torch.core.simulator import (SimConfig, SimResult,
                                        draw_static_state,
                                        sample_poisson_times)

__all__ = ["VectorSimulator", "run_sweep", "sample_churn_schedules"]


def _group_key(cfg: SimConfig) -> Tuple:
    """Structural fields of a strict batch (the reference's numpy key)."""
    has_churn = cfg.churn_join_rate > 0.0 or cfg.churn_leave_rate > 0.0
    return (cfg.n_nodes, cfg.dim, cfg.batch, float(cfg.duration),
            float(cfg.measure_interval), float(cfg.poll_interval), has_churn)


def _merge_key(cfg: SimConfig) -> Tuple:
    """Relaxed grouping key: ragged P (bucketed to the next power of two),
    churn-ness and duration merge; the tick/measurement cadence and the
    data-plane shapes must agree."""
    p_bucket = 1 << max(0, cfg.n_nodes - 1).bit_length()
    return (p_bucket, cfg.dim, cfg.batch,
            float(cfg.measure_interval), float(cfg.poll_interval))


def sample_churn_schedules(rng: np.random.Generator, leave_rate: float,
                           join_rate: float, duration: float
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One row's Poisson churn schedule: (leave, join) times, leave first."""
    leaves = sample_poisson_times(rng, leave_rate, duration)
    joins = sample_poisson_times(rng, join_rate, duration)
    return leaves, joins


class VectorSimulator:
    """Static state of a batch of B configurations on a fixed tick grid.

    Rows may differ in ``n_nodes`` (padded to the batch maximum), churn
    and duration, as long as their :func:`_merge_key` agrees.  The
    tensor engine reads the arrays set here and writes the final state
    back before :meth:`_results` assembles the per-row results.
    """

    def __init__(self, configs: Sequence[SimConfig],
                 dt: Optional[float] = None):
        if not configs:
            raise ValueError("empty config batch")
        if len({_merge_key(c) for c in configs}) > 1:
            raise ValueError("heterogeneous batch (use run_sweep, which "
                             "groups automatically)")
        self.configs = list(configs)
        B = len(configs)
        c0 = configs[0]
        self.n_true = np.array([c.n_nodes for c in configs], dtype=np.int64)
        P, d = int(self.n_true.max()), c0.dim
        self.B, self.P, self.d, self.batch = B, P, d, c0.batch
        self.row_duration = np.array([float(c.duration) for c in configs])
        self.duration = float(self.row_duration.max())
        self.poll_interval = float(c0.poll_interval)
        self.measure_interval = float(c0.measure_interval)
        self.dt = float(dt) if dt is not None else self.poll_interval
        if self.dt > self.poll_interval + 1e-12:
            # a node finishes/decides at most once per tick: a coarser
            # grid would cap throughput and skip polls
            raise ValueError(
                f"dt={self.dt} must not exceed poll_interval="
                f"{self.poll_interval}")
        self.has_churn = any(c.churn_join_rate > 0.0
                             or c.churn_leave_rate > 0.0 for c in configs)

        # ---- per-row static state: replay the per-seed init ------------ #
        self.valid_slot = np.arange(P) < self.n_true[:, None]
        self.w_true = np.empty((B, d))
        self.compute_time = np.ones((B, P))
        self.lr = np.empty(B)
        self.noise_std = np.empty(B)
        self.staleness = np.zeros(B, dtype=np.int64)
        self.beta = np.full(B, -1, dtype=np.int64)    # -1 = full view
        self.is_asp = np.zeros(B, dtype=bool)
        self.distributed = np.zeros(B, dtype=bool)
        self.is_dssp = np.zeros(B, dtype=bool)
        self.is_ebsp = np.zeros(B, dtype=bool)
        self.is_anneal = np.zeros(B, dtype=bool)
        self.pol_lo = np.zeros(B, dtype=np.int64)
        self.beta_lo = np.zeros(B, dtype=np.int64)
        self.ebsp_range = np.zeros(B)
        self.ebsp_alpha = np.full(B, 0.5)
        for b, cfg in enumerate(configs):
            rng = np.random.default_rng(cfg.seed)
            self.w_true[b], ct = draw_static_state(cfg, rng)
            self.compute_time[b, :cfg.n_nodes] = ct
            # default lr follows the row's TRUE population
            self.lr[b] = cfg.lr if cfg.lr is not None else 0.5 / cfg.n_nodes
            self.noise_std[b] = cfg.noise_std
            bar = cfg.barrier
            self.staleness[b] = bar.staleness
            self.is_asp[b] = isinstance(bar, ASP)
            if not self.is_asp[b] and bar.sample_size is not None:
                self.beta[b] = bar.sample_size
            self.distributed[b] = cfg.distributed_sampling
            kind = getattr(bar, "adaptive", "")
            if kind == "dssp":
                self.is_dssp[b] = True
                self.pol_lo[b] = bar.staleness_lo
            elif kind == "ebsp":
                self.is_ebsp[b] = True
                self.ebsp_range[b] = bar.max_advance
                self.ebsp_alpha[b] = bar.ema_alpha
            elif kind == "anneal":
                self.is_anneal[b] = True
                self.beta_lo[b] = bar.sample_size_lo
        self.full_view = (self.beta < 0) & ~self.is_asp
        self.sampled = self.beta >= 0
        self.adaptive = bool(self.is_dssp.any() or self.is_ebsp.any()
                             or self.is_anneal.any())
        self.beta_cap = np.maximum(np.minimum(self.beta, self.n_true - 1), 0)
        self.beta_lo = np.clip(self.beta_lo, 0, self.beta_cap)
        self.pol_thr = self.staleness.copy()
        self.pol_ema = np.zeros((B, P))
        self.pol_beta = np.where(self.is_anneal, self.beta_lo,
                                 np.maximum(self.beta, 0))
        self.w_true_norm = np.linalg.norm(self.w_true, axis=1)

        # one dynamics stream for the batch, seeded from all rows
        self.rng = np.random.Generator(np.random.SFC64(
            np.random.SeedSequence([int(c.seed) for c in configs]
                                   + [B, P, d])))

        # ---- initial dynamic state ------------------------------------- #
        self.w = np.zeros((B, d))
        self.steps = np.zeros((B, P), dtype=np.int64)
        self.alive = self.valid_slot.copy()
        self.computing = np.ones((B, P), dtype=bool)
        self.event_time = self.compute_time * (0.5 + self.rng.random((B, P)))
        self.ready = self.event_time.copy()
        self.blocked = np.zeros((B, P), dtype=bool)
        self.total_updates = np.zeros(B, dtype=np.int64)
        self.control_messages = np.zeros(B, dtype=np.int64)
        # per-draw control cost of the structured overlay (β lookups of
        # O(log N) hops + β step queries)
        self.hops_per_peer = np.maximum(
            1, np.ceil(np.log2(np.maximum(self.n_true, 2)))
        ).astype(np.int64) + 1

        # ---- tick grid + measurement grid ------------------------------ #
        ticks = np.arange(self.dt, self.duration + 1e-9, self.dt)
        if ticks.size == 0 or ticks[-1] < self.duration - 1e-9:
            ticks = np.append(ticks, self.duration)
        self.ticks = ticks
        self.m_times = np.arange(0.0, self.duration + 1e-9,
                                 self.measure_interval)

        # ---- churn schedules: i64[T, B] events per tick ----------------- #
        if self.has_churn:
            edges = np.concatenate(([0.0], ticks))
            self.leave_counts = np.zeros((ticks.size, B), dtype=np.int64)
            self.join_counts = np.zeros((ticks.size, B), dtype=np.int64)
            for b, cfg in enumerate(configs):
                lt, jt = sample_churn_schedules(
                    self.rng, cfg.churn_leave_rate, cfg.churn_join_rate,
                    float(cfg.duration))
                self.leave_counts[:, b] = np.histogram(lt, bins=edges)[0]
                self.join_counts[:, b] = np.histogram(jt, bins=edges)[0]

    def _results(self, errs: np.ndarray, upds: np.ndarray) -> List[SimResult]:
        """Per-row :class:`SimResult`\\ s from [B, M] traces, each cut at
        its row's own duration."""
        final_err = (np.linalg.norm(self.w - self.w_true, axis=1)
                     / self.w_true_norm)
        out = []
        for b in range(self.B):
            n = int(self.n_true[b])   # drop ragged padding slots
            mb = min(errs.shape[1],
                     int(np.searchsorted(self.m_times,
                                         self.row_duration[b] + 1e-9)))
            out.append(SimResult(
                steps=self.steps[b, :n].copy(),
                times=self.m_times[:mb].copy(),
                errors=errs[b, :mb].copy(),
                server_updates=upds[b, :mb].copy(),
                control_messages=int(self.control_messages[b]),
                total_updates=int(self.total_updates[b]),
                mean_progress=float(self.steps[b][self.alive[b]].mean()),
                final_error=float(final_err[b]),
            ))
        return out


def run_sweep(configs: Sequence[SimConfig], *, dt: Optional[float] = None,
              device=None) -> List[SimResult]:
    """Run a batch of simulations on the tensor sweep engine.

    Args:
      configs: scenario list (any mix of shapes, barriers and churn).
      dt: grid width; defaults to each group's ``poll_interval``.
      device: torch device.  ``None`` means the GPU (``cuda``), and raises
        when no GPU is visible; ``"cpu"`` runs the plain PyTorch tick.
    """
    import torch

    from repro_torch.core import vector_sim_torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("run_sweep: no CUDA device is visible; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    results: List[Optional[SimResult]] = [None] * len(configs)
    groups: Dict[Tuple, List[int]] = {}
    for i, cfg in enumerate(configs):
        groups.setdefault(_merge_key(cfg), []).append(i)
    for idx in groups.values():
        sim = VectorSimulator([configs[i] for i in idx], dt=dt)
        for i, res in zip(idx, vector_sim_torch.run_batch(sim,
                                                          device=device)):
            results[i] = res
    return results  # type: ignore[return-value]
