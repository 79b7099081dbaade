"""Batched sweep engine: scenario grouping, static state and results.

The port's counterpart of :mod:`repro.core.vector_sim`, with two
backends:

* ``"torch"`` (the default) runs every batch on the tensor engine
  (:mod:`repro_torch.core.vector_sim_torch`): one call of the fused tick
  per grid tick, the CUDA kernel on the card.  Configs are grouped like
  the reference's jax backend, by :func:`_merge_key`: ragged ``n_nodes``
  (padded with permanently dead slots), churn-ness and duration (rows
  freeze at their own horizon) merge into one batch.
* ``"numpy"`` is the reference's numpy grid engine, copied method for
  method (:meth:`VectorSimulator.run`): array ops per tick on the host,
  groups strictly by :func:`_group_key`, and gives the reference's
  ``backend="numpy"`` results bit for bit on the same configs.  Its rows
  consume one dynamics stream in finisher order, so rows of one batch
  are not correlated the way the torch backend's shared draws are.

:class:`VectorSimulator` builds a batch's static state exactly as the
reference does — the same per-seed draws
(:func:`repro_torch.core.simulator.draw_static_state`), the same batch
dynamics stream for the initial busy clocks and churn schedules — so a
config's ground truth, node speeds, straggler assignment, initial clocks
and churn schedule are bit-identical to the reference's.

:func:`run_sweep` is the entry point::

    from repro_torch.core import SimConfig, make_barrier, run_sweep
    results = run_sweep(configs)                    # on the GPU
    results = run_sweep(configs, device="cpu")      # plain PyTorch tick
    results = run_sweep(configs, backend="numpy")   # host grid engine

Results come back in input order.

Simulation model of one numpy grid tick of width ``dt`` (the tensor
tick computes the same phases): 0. churn — pre-sampled Poisson leave and
join events fire (a leave kills a random alive node while more than two
are alive; a join revives a dead node at the max alive step); 1. finish
— nodes whose busy clock expired push their SGD update, advance their
step and become deciding; 2. decide — ASP rows pass, full-view rows
(BSP/SSP) pass iff ``step − min(alive steps) ≤ staleness``, sampled rows
draw β alive peers without replacement, excluding themselves; 3. start —
passing nodes pull the server model and draw their next duration,
anchored at their continuous ready time; blocked sampled nodes re-poll
after ``poll_interval``; 4. measure on the ``measure_interval`` grid.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.barriers import ASP
from repro_torch.core.simulator import (SimConfig, SimResult,
                                        draw_static_state,
                                        sample_poisson_times)

__all__ = ["BACKENDS", "VectorSimulator", "run_sweep",
           "sample_churn_schedules"]

_EPS = 1e-9

#: the sweep engine's backends: the tensor tick (default) and the host
#: grid engine
BACKENDS = ("torch", "numpy")


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
    """A batch of B configurations on a fixed tick grid.

    On the torch backend rows may differ in ``n_nodes`` (padded to the
    batch maximum), churn and duration, as long as their
    :func:`_merge_key` agrees; the tensor engine reads the arrays set
    here and writes the final state back before :meth:`_results`
    assembles the per-row results.  The numpy backend takes only batches
    whose :func:`_group_key` agrees, as the reference's, and advances
    them on the host (:meth:`run`).
    """

    def __init__(self, configs: Sequence[SimConfig],
                 dt: Optional[float] = None, backend: str = "torch"):
        if not configs:
            raise ValueError("empty config batch")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {BACKENDS}")
        key_fn = _group_key if backend == "numpy" else _merge_key
        if len({key_fn(c) for c in configs}) > 1:
            raise ValueError("heterogeneous batch (use run_sweep, which "
                             "groups automatically; only the torch "
                             "backend batches ragged P, churn and "
                             "durations)")
        self.configs = list(configs)
        self.backend = backend
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

    # ------------------------------------------------------------------ #
    def _measure(self) -> None:
        err = (np.linalg.norm(self.w - self.w_true, axis=1)
               / self.w_true_norm)
        self._trace_err.append(err)
        self._trace_upd.append(self.total_updates.copy())

    def _apply_updates(self, b_idx: np.ndarray, p_idx: np.ndarray) -> None:
        """Batched SGD pushes for every node that finished this tick.

        The residual is computed directly as X·(w_pulled − w*) − σ·ε, which
        folds the label draw into one projection; minibatch draws are f32
        (the simulation's noise floor is orders of magnitude above f32 eps).
        """
        K = b_idx.size
        X = self.rng.standard_normal((K, self.batch, self.d),
                                     dtype=np.float32)
        diff = (self.pulled[b_idx, p_idx]
                - self.w_true[b_idx]).astype(np.float32)
        eps = self.rng.standard_normal((K, self.batch), dtype=np.float32)
        resid = (np.einsum("kbd,kd->kb", X, diff)
                 - self.noise_std[b_idx, None].astype(np.float32) * eps)
        grads = np.einsum("kb,kbd->kd", resid, X) / self.batch
        # updates within a tick commute: each gradient depends only on the
        # node's pulled (stale) model, so the server sum is order-free.
        # b_idx comes from np.nonzero and is therefore sorted, so the
        # per-row sums are contiguous segments (reduceat ≫ np.add.at).
        rows, starts = np.unique(b_idx, return_index=True)
        self.w[rows] -= (self.lr[rows, None]
                         * np.add.reduceat(grads.astype(np.float64),
                                           starts, axis=0))
        self.total_updates += np.bincount(b_idx, minlength=self.B)

    def _sample_peers(self, bb: np.ndarray, pp: np.ndarray,
                      k: int) -> np.ndarray:
        """i64[K, k] peer indices: uniform without replacement, self excluded.

        For k ≪ P this is vectorized rejection sampling (draw k iid indices
        over the P−1 non-self slots, redraw rows with within-row collisions)
        — O(K·k) versus the O(K·P) of a full argpartition, which remains the
        fallback for dense samples.  No-churn path: every peer is alive.
        """
        K = bb.size
        if 3 * k >= self.P:
            scores = self.rng.random((K, self.P))
            scores[np.arange(K), pp] = 2.0
            return np.argpartition(scores, k - 1, axis=1)[:, :k]
        draw = self.rng.integers(0, self.P - 1, size=(K, k))
        draw += draw >= pp[:, None]          # skip over the self slot
        if k > 1:
            for _ in range(16):
                srt = np.sort(draw, axis=1)
                dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
                if not dup.any():
                    break
                rows = np.flatnonzero(dup)
                redo = self.rng.integers(0, self.P - 1, size=(rows.size, k))
                redo += redo >= pp[rows, None]
                draw[rows] = redo
        return draw

    def _sample_peers_masked(self, bb: np.ndarray, pp: np.ndarray,
                             k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Churn path: k alive-peer indices + validity, self/dead excluded.

        Masked argpartition over uniform scores; a slot is valid iff its
        score stayed below the dead/self sentinel, which caps the effective
        sample at the row's alive-peer count — exactly the event engine's
        ``beta = min(beta, len(pool))`` under a compressed alive pool.
        """
        K = bb.size
        scores = self.rng.random((K, self.P))
        scores[~self.alive[bb]] = 2.0
        scores[np.arange(K), pp] = 2.0
        take = np.argpartition(scores, min(k, self.P - 1), axis=1)[:, :k]
        valid = np.take_along_axis(scores, take, axis=1) < 1.5
        return take, valid

    def _barrier_pass(self, cand: np.ndarray) -> np.ndarray:
        """Masked barrier predicates; bool[B, P], valid where ``cand``."""
        passed = np.zeros((self.B, self.P), dtype=bool)
        passed[self.is_asp] = True
        if self.full_view.any():
            fv = self.full_view
            fv_steps = self.steps[fv]
            # min over *alive* steps: a departed straggler's frozen counter
            # must not gate waiters (the event engine's churn-wake fix)
            masked = np.where(self.alive[fv], fv_steps,
                              np.iinfo(np.int64).max)
            lag = fv_steps - masked.min(axis=1, keepdims=True)
            thr = np.broadcast_to(self.staleness[fv, None], fv_steps.shape)
            if self.adaptive:
                # adaptive rows swap their effective threshold in: DSSP
                # the carried dynamic bound, Elastic-BSP the per-node
                # EMA step credit (same formulas as psp_tick_ref /
                # barrier_kernel.elastic_slack)
                thr = np.where(self.is_dssp[fv, None],
                               self.pol_thr[fv, None], thr)
                if self.is_ebsp.any():
                    live = np.where(self.alive, self.pol_ema, 0.0)
                    frac = 1.0 - self.pol_ema / np.maximum(
                        live.max(axis=1, keepdims=True), 1e-9)
                    slack = np.floor(self.ebsp_range[:, None] * frac
                                     ).astype(np.int64)
                    thr = np.where(self.is_ebsp[fv, None], slack[fv], thr)
            passed[fv] = lag <= thr
        sm = cand & self.sampled[:, None]
        b_idx, p_idx = np.nonzero(sm)
        if b_idx.size:
            betas = self.beta[b_idx]
            if self.adaptive:
                # β-annealing rows sample with their carried β
                betas = np.where(self.is_anneal[b_idx],
                                 self.pol_beta[b_idx], betas)
            for beta in np.unique(betas):
                pick = betas == beta
                bb, pp = b_idx[pick], p_idx[pick]
                k = min(int(beta), self.P - 1)
                if k <= 0:
                    passed[bb, pp] = True   # S = ∅ degenerates to ASP
                    continue
                if self.has_churn:
                    take, valid = self._sample_peers_masked(bb, pp, k)
                    n_sampled = valid.sum(axis=1)
                else:
                    take = self._sample_peers(bb, pp, k)
                    valid = np.ones_like(take, dtype=bool)
                    n_sampled = np.full(bb.size, k)
                peer_steps = self.steps[bb[:, None], take]
                my = self.steps[bb, pp]
                passed[bb, pp] = np.all(
                    (my[:, None] - peer_steps
                     <= self.staleness[bb][:, None]) | ~valid, axis=1)
                dist = self.distributed[bb]
                if dist.any():
                    self.control_messages += (
                        self.hops_per_peer
                        * np.bincount(bb[dist], weights=n_sampled[dist],
                                      minlength=self.B).astype(np.int64))
        return passed

    # ------------------------------------------------------------------ #
    # churn: batched leave/join event processing
    # ------------------------------------------------------------------ #
    def _churn_leave(self, rows: np.ndarray) -> None:
        """One leave event in each flagged row: kill a random alive node.

        Fires only while more than two nodes are alive (the population can
        drop to two), as the event engine; the event is consumed either
        way (a too-small row just skips the effect).
        """
        rows = rows & (self.alive.sum(axis=1) > 2)
        b = np.flatnonzero(rows)
        if b.size == 0:
            return
        scores = self.rng.random((b.size, self.P))
        scores[~self.alive[b]] = -1.0
        victim = scores.argmax(axis=1)
        self.alive[b, victim] = False

    def _churn_join(self, rows: np.ndarray, t: float) -> None:
        """One join event per flagged row: revive a random dead node.

        The joiner restarts at the current max alive step (the event
        engine's fresh-start rule) and decides this tick.
        """
        rows = rows & ~self.alive.all(axis=1)
        b = np.flatnonzero(rows)
        if b.size == 0:
            return
        scores = self.rng.random((b.size, self.P))
        scores[self.alive[b]] = -1.0
        node = scores.argmax(axis=1)
        self.alive[b, node] = True
        fresh = np.where(self.alive[b], self.steps[b],
                         np.iinfo(np.int64).min).max(axis=1)
        self.steps[b, node] = fresh
        self.computing[b, node] = False
        self.event_time[b, node] = t
        self.ready[b, node] = t
        self.blocked[b, node] = False

    def _process_churn(self, t: float, leave_n: np.ndarray,
                       join_n: np.ndarray) -> None:
        """Fire this tick's pre-sampled leave/join events, batched per round
        (several events per row per tick are possible but rare)."""
        leave_n, join_n = leave_n.copy(), join_n.copy()
        while (leave_n > 0).any() or (join_n > 0).any():
            self._churn_leave(leave_n > 0)
            self._churn_join(join_n > 0, t)
            leave_n -= leave_n > 0
            join_n -= join_n > 0

    # ------------------------------------------------------------------ #
    def _tick(self, t: float, tick_index: int) -> None:
        """Advance the whole batch by one grid tick (phases 0–3)."""
        if self.has_churn:
            self._process_churn(t, self.leave_counts[tick_index],
                                self.join_counts[tick_index])

        # 1. finishes: push updates, advance steps, become "deciding"
        fin = self.computing & self.alive & (self.event_time <= t + _EPS)
        # latest finish per row this tick: a full-view waiter unblocked
        # this tick was gated by (at most) that finish, so anchoring
        # there instead of the tick boundary removes the systematic
        # dt/2-per-round quantisation loss for BSP/SSP
        row_unblock = np.full(self.B, t)
        if fin.any():
            b_idx, p_idx = np.nonzero(fin)
            rows, starts = np.unique(b_idx, return_index=True)
            row_last = np.maximum.reduceat(self.event_time[fin], starts)
            row_unblock[rows] = np.minimum(row_last, t)
            self._apply_updates(b_idx, p_idx)
            self.steps[fin] += 1
            self.computing[fin] = False
            self.ready[fin] = self.event_time[fin]  # true finish time
            self.blocked[fin] = False

        # 2. barrier decisions for every due deciding node
        cand = ~self.computing & self.alive & (self.event_time <= t + _EPS)
        if cand.any():
            passed = self._barrier_pass(cand)
            start = cand & passed
            if start.any():
                b_idx, p_idx = np.nonzero(start)
                # anchor at the continuous ready time; a full-view node
                # unblocked by a peer's finish starts at that finish
                # (the grid analogue of the event simulator's
                # min-moved wakeup)
                t0 = np.where(self.blocked[start]
                              & self.full_view[b_idx],
                              np.maximum(row_unblock[b_idx],
                                         self.ready[start]),
                              self.ready[start])
                self.pulled[b_idx, p_idx] = self.w[b_idx]
                dur = (self.compute_time[b_idx, p_idx]
                       * (0.5 + self.rng.random(b_idx.size)))
                self.event_time[start] = t0 + dur
                self.computing[start] = True
                self.blocked[start] = False
                if self.adaptive and self.is_ebsp.any():
                    # Elastic-BSP folds each starter's freshly drawn
                    # duration into its per-node EMA (the grid engines'
                    # observation point — see psp_tick_ref block 3b)
                    eb = self.is_ebsp[b_idx]
                    if eb.any():
                        al = self.ebsp_alpha[b_idx[eb]]
                        old = self.pol_ema[b_idx[eb], p_idx[eb]]
                        self.pol_ema[b_idx[eb], p_idx[eb]] = \
                            (1.0 - al) * old + al * dur[eb]
            fail = cand & ~passed
            if fail.any():
                self.blocked[fail] = True
                # sampled rows re-poll on the poll cadence; full-view
                # rows stay due and re-check next tick
                sm_fail = fail & self.sampled[:, None]
                self.ready[sm_fail] += self.poll_interval
                self.event_time[sm_fail] = self.ready[sm_fail]

        # 2b. adaptive-policy state updates from this tick's observed
        #     post-finish step spread (decisions above used the OLD state)
        if self.adaptive:
            masked = np.where(self.alive, self.steps,
                              np.iinfo(np.int64).min)
            gap = masked.max(axis=1) - np.where(
                self.alive, self.steps, np.iinfo(np.int64).max).min(axis=1)
            gap = np.where(self.alive.any(axis=1), gap, 0)
            self.pol_thr = np.where(
                self.is_dssp,
                np.clip(gap, self.pol_lo, self.staleness), self.pol_thr)
            self.pol_beta = np.where(
                self.is_anneal,
                np.clip(self.beta_lo + gap - self.staleness,
                        self.beta_lo, self.beta_cap), self.pol_beta)

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


    def run(self, device=None, mesh=None) -> List[SimResult]:
        """Advance the batch over the whole tick grid on its backend.

        The numpy backend allocates the host node views and traces here
        (the torch backend keeps its own on the device) and takes no
        ``device`` or ``mesh``; the torch backend runs on ``device`` and
        the ``mesh`` asked for (see :func:`run_sweep`).
        """
        if self.backend == "torch":
            from repro_torch.core import vector_sim_torch
            return vector_sim_torch.run_batch(self, device=_device(device),
                                              mesh=mesh)
        if device is not None or mesh is not None:
            raise ValueError("the numpy backend runs on the host; it "
                             "takes no device or mesh")
        self.pulled = np.zeros((self.B, self.P, self.d))
        self._trace_err: List[np.ndarray] = []
        self._trace_upd: List[np.ndarray] = []
        self._measure()                      # t = 0 trace point
        m_next = 1
        for i, t in enumerate(self.ticks):
            self._tick(t, i)
            # 3. error / server-update traces on the measurement grid
            while m_next < self.m_times.size and \
                    self.m_times[m_next] <= t + _EPS:
                self._measure()
                m_next += 1

        errs = np.stack(self._trace_err, axis=1)        # [B, M]
        upds = np.stack(self._trace_upd, axis=1)        # [B, M]
        return self._results(errs, upds)


def _device(device):
    """The torch device a sweep runs on: ``None`` means the GPU, and
    raises when none is visible."""
    if device is not None:
        return device
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("run_sweep: no CUDA device is visible; pass "
                           "device='cpu' to run on the CPU")
    return "cuda"


def run_sweep(configs: Sequence[SimConfig], *, dt: Optional[float] = None,
              backend: str = "torch", device=None,
              mesh: Optional[Tuple[int, int]] = None) -> List[SimResult]:
    """Run a batch of simulations on the sweep engine.

    Args:
      configs: scenario list (any mix of shapes, barriers and churn).
      dt: grid width; defaults to each group's ``poll_interval``.
      backend: ``"torch"`` (the fused tick; groups by
        :func:`_merge_key`) or ``"numpy"`` (the host grid engine; groups
        strictly by :func:`_group_key`, bit for bit the reference's
        numpy backend).
      device: torch device of the torch backend.  ``None`` means the GPU
        (``cuda``), and raises when no GPU is visible; ``"cpu"`` runs the
        plain PyTorch tick.  The numpy backend takes none: passing one
        raises.
      mesh: the torch backend's ``(rows, nodes)`` placement over the
        ranks of the initialised process group (default
        ``PSP_SWEEP_MESH``, else every rank on ``rows``; see
        :func:`repro_torch.core.sweep_plan.resolve_mesh`); every rank
        calls ``run_sweep`` with the same configs and gets the same
        results.  Without a process group it is one device.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if backend == "numpy" and (device is not None or mesh is not None):
        raise ValueError("the numpy backend runs on the host; it takes "
                         "no device or mesh")
    if backend == "torch":
        device = _device(device)
    key_fn = _group_key if backend == "numpy" else _merge_key
    results: List[Optional[SimResult]] = [None] * len(configs)
    groups: Dict[Tuple, List[int]] = {}
    for i, cfg in enumerate(configs):
        groups.setdefault(key_fn(cfg), []).append(i)
    for idx in groups.values():
        sim = VectorSimulator([configs[i] for i in idx], dt=dt,
                              backend=backend)
        for i, res in zip(idx, sim.run(device, mesh)):
            results[i] = res
    return results  # type: ignore[return-value]
