"""PSP as a training feature: the port of :mod:`repro.core.spmd_psp`.

Workers at heterogeneous speeds, a server model updated by possibly
stale pushes, and a barrier predicate (on a β-sample of the step
counters) gating when each worker may start its next step, as one
training step on one device.  The per-tick protocol is the reference's
(:func:`psp_apply_tick`):

0. with churn, fire due leave / join events (at most one each);
1. every worker computes a gradient on **its own view** (SPMD always
   computes; masks decide what lands);
2. completed, alive workers that have not pushed this step *push*: the
   server applies the masked sum of their gradients through the
   optimizer, only if any worker pushed;
3. the next step's durations are drawn, then completed alive workers
   decide through the barrier policy; those allowed *pull* the server
   model, bump their step and start their next local step;
4. the virtual clock jumps to the next completion or poll.

Layout: the worker axis W leads every view tensor; ``views`` is a tree
(nested dicts and lists, :mod:`repro_torch.tree`) of ``[W, …]`` tensors
shaped like the parameters.  The pull and the join's re-anchor update
the views **in place** (``torch.where(..., out=view)``): a state handed
to :func:`psp_apply_tick` is consumed, and only the returned one is
valid.  Everything else is returned new.

Noise is an input.  Every draw of a tick comes from a per-tick noise
record: ``dur`` f32[W] (the next durations' uniforms), the β-sample's
``scores`` f32[W, W] or, on the unmasked β = 1 path, ``u`` f32[W]
(:meth:`PSPConfig.noise_kind`), and with churn ``leave`` and ``join``
f32[W] (the victim's and joiner's uniforms); at init, ``perm`` f32[W]
(the straggler permutation: the slow flags are permuted by the stable
argsort of these scores) and ``dur``.  :class:`GeneratorNoise` draws the
records from a ``torch.Generator`` on the run's device;
:class:`ReplayNoise` replays given records, which is how the tests feed
the draws the reference makes from its own key splits.  The control
plane stays on the device: a tick reads nothing back to the host.

The churn schedules are numpy draws from ``ChurnConfig.seed``, as in the
reference (:func:`repro_torch.core.vector_sim.sample_churn_schedules`).

Over a mesh of ranks (``mesh=``, a
:class:`~repro_torch.launch.mesh.HostMesh`), the worker axis W is split
over the mesh's worker axes
(:func:`~repro_torch.parallel.sharding.psp_worker_axes`: ``pod`` and
``data``), as the reference's ``psp_workers`` rule lays it out: each
rank holds the views of its W/n workers (``n`` the worker shards;
workers ``idx·W/n …``), computes their losses and gradients on their
own microbatches, and pulls into those views only.  The control plane
(steps, clocks, membership, the server model and optimizer state) stays
replicated: every rank reads the same noise record, as
:class:`ReplayNoise` and :class:`GeneratorNoise` (same seed) give it,
and computes it alike.  The server's masked gradient sum all-gathers the
per-worker masked contributions in worker order and sums them as one
rank does, so the server gradient — and everything after it — is bit
for bit that of one rank for any world size.  (An ``all_reduce`` of
per-rank partial sums would move less, but its result depends on the
summation order.)
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterable, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.barrier_kernel import (BarrierKernel, BarrierPolicy,
                                             churn_joiner, churn_victim,
                                             make_policy)
from repro_torch.core.barriers import BarrierControl, make_barrier
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import psp_worker_axes
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ChurnConfig", "GeneratorNoise", "PSPConfig", "PSPState",
           "ReplayNoise", "apply_external_churn", "elastic_drive",
           "external_drive", "linear_psp_state", "linear_psp_task",
           "local_workers", "make_psp_step_fn", "psp_apply_tick",
           "psp_init", "psp_train_step", "state_from_tree",
           "state_to_tree", "worker_axis"]

Tree = Any
Record = Dict[str, torch.Tensor]

_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Poisson leave / join churn, pre-sampled over ``horizon`` virtual
    seconds at :func:`psp_init` from ``seed``."""

    leave_rate: float = 0.1        # workers leaving per virtual second
    join_rate: float = 0.1         # workers (re)joining per virtual second
    horizon: float = 120.0         # schedule length in virtual seconds
    seed: int = 0                  # schedule RNG seed


@dataclasses.dataclass(frozen=True)
class PSPConfig:
    """Barrier-control configuration of the trainer (the reference's)."""

    barrier: str = "pssp"          # bsp|ssp|asp|pbsp|pssp|dssp|ebsp|ap(b|s)sp
    staleness: int = 4             # s (ignored by bsp/asp)
    sample_size: int = 16          # β (ignored by classic barriers)
    n_workers: int = 8             # W
    base_compute: float = 0.1      # virtual seconds per local step
    compute_jitter: float = 0.5    # per-step U[1−j/2, 1+j/2] noise
    straggler_frac: float = 0.0
    straggler_slowdown: float = 4.0
    poll_interval: float = 0.02    # blocked-worker re-sample cadence
    #: "mean" (pushing-worker mean), "sum", or "mean-alive" (divide by an
    #: EMA of the alive-worker count)
    contribution: str = "mean"
    staleness_lo: int = 0          # DSSP lower search bound r
    sample_size_lo: int = 1        # β-annealing lower bound β_min
    max_advance: int = 4           # Elastic-BSP max run-ahead R
    ema_alpha: float = 0.5         # Elastic-BSP duration-EMA α
    churn: Optional[ChurnConfig] = None

    def make_barrier(self) -> BarrierControl:
        """The configured :class:`BarrierControl` declaration."""
        return make_barrier(self.barrier, staleness=self.staleness,
                            sample_size=self.sample_size,
                            staleness_lo=self.staleness_lo,
                            sample_size_lo=self.sample_size_lo,
                            max_advance=self.max_advance,
                            ema_alpha=self.ema_alpha)

    @property
    def beta(self) -> int:
        """Effective sample size β (0 for classic/ASP barriers)."""
        b = self.make_barrier()
        return 0 if b.sample_size is None else min(b.sample_size,
                                                   self.n_workers - 1)

    @property
    def effective_staleness(self) -> int:
        """Staleness bound s after barrier-specific defaults apply."""
        return int(self.make_barrier().staleness)

    @property
    def is_classic(self) -> bool:
        """Classic barriers evaluate the full step vector."""
        return self.barrier in ("bsp", "ssp")

    @property
    def is_asp(self) -> bool:
        """ASP never blocks."""
        return self.barrier == "asp"

    @property
    def has_churn(self) -> bool:
        """Whether ticks open with the churn phase."""
        return self.churn is not None

    @property
    def barrier_kernel(self) -> BarrierKernel:
        """The barrier predicate and straggler model the trainer runs."""
        return BarrierKernel(barrier=self.barrier,
                             staleness=self.effective_staleness,
                             beta=self.beta)

    @property
    def barrier_policy(self) -> BarrierPolicy:
        """The (possibly stateful) decision policy the trainer runs."""
        return make_policy(self.barrier, staleness=self.effective_staleness,
                           beta=self.beta, staleness_lo=self.staleness_lo,
                           beta_lo=self.sample_size_lo,
                           max_advance=self.max_advance,
                           ema_alpha=self.ema_alpha)

    def noise_kind(self) -> Optional[str]:
        """The β-sample noise a tick's decide reads: ``None``, ``"u"``
        f32[W] or ``"scores"`` f32[W, W]."""
        return self.barrier_policy.noise_kind(self.n_workers,
                                              self.has_churn)


class PSPState(NamedTuple):
    """Training state carried across ticks (the reference's fields but
    its PRNG key: the noise comes with each tick)."""

    server_params: Tree            # the server model
    opt_state: Tree                # optimizer state of the server model
    views: Tree                    # [W, ...] worker views (stale pulls)
    step: torch.Tensor             # i32[W] logical step counters
    busy_until: torch.Tensor       # f32[W] virtual completion times
    pushed: torch.Tensor           # bool[W] pushed the current step?
    now: torch.Tensor              # f32[] virtual wall clock
    slow: torch.Tensor             # bool[W] straggler flags
    tick: torch.Tensor             # i32[] tick counter
    total_pushes: torch.Tensor     # i32[] server update count
    alive: torch.Tensor            # bool[W] worker membership
    leave_times: torch.Tensor      # f32[El] leave schedule
    join_times: torch.Tensor       # f32[Ej] join schedule
    leave_cursor: torch.Tensor     # i32[] next unconsumed leave event
    join_cursor: torch.Tensor      # i32[] next unconsumed join event
    #: adaptive policy state (empty for the five static barriers);
    #: ``contribution="mean-alive"`` keeps its alive-count EMA under
    #: ``"denom"``
    policy: Dict[str, torch.Tensor] = {}


class GeneratorNoise:
    """Noise records from a ``torch.Generator`` on ``device``, drawn in
    call order."""

    def __init__(self, seed: int, device: Any = "cpu"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _u(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def init_record(self, cfg: PSPConfig) -> Record:
        """The straggler permutation's scores and the first durations."""
        W = cfg.n_workers
        return {"perm": self._u(W), "dur": self._u(W)}

    def tick_record(self, cfg: PSPConfig) -> Record:
        """One tick's draws (see the module docstring)."""
        W = cfg.n_workers
        rec = {"dur": self._u(W)}
        kind = cfg.noise_kind()
        if kind == "scores":
            rec["scores"] = self._u(W, W)
        elif kind == "u":
            rec["u"] = self._u(W)
        if cfg.has_churn:
            rec["leave"] = self._u(W)
            rec["join"] = self._u(W)
        return rec


class ReplayNoise:
    """Given noise records: ``init`` for :func:`psp_init`, then one of
    ``ticks`` per tick, in order."""

    def __init__(self, init: Record, ticks: Iterable[Record]):
        self.init = init
        self._ticks = iter(ticks)

    def init_record(self, cfg: PSPConfig) -> Record:
        """The init record."""
        return self.init

    def tick_record(self, cfg: PSPConfig) -> Record:
        """The next tick's record."""
        return next(self._ticks)


def _duration(cfg: PSPConfig, u: torch.Tensor,
              slow: torch.Tensor) -> torch.Tensor:
    """Per-worker duration of one local step from its uniform ``u``."""
    one = torch.ones((), dtype=torch.float32, device=slow.device)
    base = cfg.base_compute * torch.where(slow, cfg.straggler_slowdown * one,
                                          one)
    return BarrierKernel.step_duration(u, base, cfg.compute_jitter)


def _device(tree: Tree) -> torch.device:
    return tree_leaves(tree)[0].device


def worker_axis(mesh) -> Optional[collectives.Axis]:
    """The mesh's worker axes as one collective axis (None without a
    mesh or worker axes)."""
    return collectives.mesh_axis(mesh, psp_worker_axes(mesh))


def local_workers(cfg: PSPConfig, mesh=None) -> slice:
    """The workers whose views this rank holds: all W without a mesh,
    else its W/n block along the worker axes."""
    axis = worker_axis(mesh)
    n = collectives.axis_size(axis)
    if cfg.n_workers % n:
        raise ValueError(f"{cfg.n_workers} workers do not split over "
                         f"{n} worker shards")
    w_loc = cfg.n_workers // n
    lo = collectives.axis_index(axis) * w_loc
    return slice(lo, lo + w_loc)


def psp_init(cfg: PSPConfig, params: Tree,
             opt_init: Callable[[Tree], Tree], noise,
             mesh=None) -> PSPState:
    """The initial state: every view a copy of ``params`` (this rank's
    workers' views over ``mesh``), the slow flags permuted and the first
    durations drawn from ``noise.init_record``."""
    from repro_torch.core.vector_sim import sample_churn_schedules

    w = cfg.n_workers
    mine = local_workers(cfg, mesh)
    dev = _device(params)
    views = tree_map(lambda p: p.unsqueeze(0).repeat(
        (mine.stop - mine.start,) + (1,) * p.dim()), params)
    rec = noise.init_record(cfg)
    n_slow = int(round(cfg.straggler_frac * w))
    slow = torch.arange(w, device=dev) < n_slow
    slow = slow[torch.argsort(rec["perm"].to(dev), stable=True)]
    dur = _duration(cfg, rec["dur"].to(dev), slow)
    if cfg.has_churn:
        rng = np.random.default_rng(cfg.churn.seed)
        lt, jt = sample_churn_schedules(rng, cfg.churn.leave_rate,
                                        cfg.churn.join_rate,
                                        cfg.churn.horizon)
    else:
        lt = jt = np.empty(0)
    policy = dict(cfg.barrier_policy.init(w, device=dev))
    if cfg.contribution == "mean-alive":
        policy["denom"] = torch.tensor(float(w), dtype=torch.float32,
                                       device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return PSPState(
        server_params=params,
        opt_state=opt_init(params),
        views=views,
        step=torch.zeros(w, dtype=torch.int32, device=dev),
        busy_until=dur,
        pushed=torch.zeros(w, dtype=torch.bool, device=dev),
        now=torch.zeros((), dtype=torch.float32, device=dev),
        slow=slow,
        tick=i32(0),
        total_pushes=i32(0),
        alive=torch.ones(w, dtype=torch.bool, device=dev),
        leave_times=f32(lt),
        join_times=f32(jt),
        leave_cursor=i32(0),
        join_cursor=i32(0),
        policy=policy,
    )


def _barrier_allowed(cfg: PSPConfig, step: torch.Tensor,
                     alive: Optional[torch.Tensor] = None, *,
                     scores: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[W]: may each worker start its next step, per the barrier?"""
    return cfg.barrier_kernel.allowed(step, alive, scores=scores, u=u)


def _schedule_due(times: torch.Tensor, cursor: torch.Tensor,
                  now: torch.Tensor) -> torch.Tensor:
    """bool[]: is the next unconsumed schedule event at or before ``now``?
    (read on the device: no host sync)"""
    n = times.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.bool, device=now.device)
    nxt = torch.take(times, torch.clamp(cursor, max=n - 1).long())
    return (cursor < n) & (nxt <= now)


def _masked_rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """``mask`` (W,) shaped to broadcast against a ``[W, …]`` tensor of
    ``ndim`` dims."""
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def _assign_rows(views: Tree, mask: torch.Tensor, params: Tree,
                 mine: slice = slice(None)) -> None:
    """views[i] ← params wherever mask[i], in place; the views are
    workers ``mine`` of the bool[W] ``mask`` (all of them by default)."""
    mask = mask[mine]

    def one(v, p):
        torch.where(_masked_rows(mask, v.dim()), p.unsqueeze(0), v, out=v)
    tree_map(one, views, params)


def _membership_update(state: PSPState, leave_sel: torch.Tensor,
                       join_sel: torch.Tensor,
                       mine: slice = slice(None)) -> PSPState:
    """Apply bool[W] leave / join selections: leavers freeze; joiners are
    re-anchored on the server model (in place, the views of workers
    ``mine``), restart at the max alive step (after both masks land),
    complete now and count as pushed."""
    alive = (state.alive & ~leave_sel) | join_sel
    fresh = torch.where(alive, state.step,
                        torch.full_like(state.step, _I32_MIN)).amax()
    _assign_rows(state.views, join_sel, state.server_params, mine)
    return state._replace(
        step=torch.where(join_sel, fresh, state.step),
        busy_until=torch.where(join_sel, state.now, state.busy_until),
        pushed=state.pushed | join_sel,
        alive=alive,
    )


def _fire_churn(cfg: PSPConfig, state: PSPState, u_leave: torch.Tensor,
                u_join: torch.Tensor, mine: slice = slice(None)
                ) -> PSPState:
    """Phase 0 of a churn tick: fire the due leave and join (≤ 1 each);
    a leave only while more than two workers are alive, a join only if a
    slot is free; due events are consumed either way."""
    iota = torch.arange(cfg.n_workers, device=state.step.device)
    alive = state.alive
    due_l = _schedule_due(state.leave_times, state.leave_cursor, state.now)
    do_l = due_l & (alive.sum() > 2)
    leave_sel = do_l & (iota == churn_victim(u_leave, alive))
    alive = alive & ~leave_sel
    due_j = _schedule_due(state.join_times, state.join_cursor, state.now)
    do_j = due_j & (~alive).any()
    join_sel = do_j & (iota == churn_joiner(u_join, alive))
    state = _membership_update(state, leave_sel, join_sel, mine)
    return state._replace(
        leave_cursor=state.leave_cursor + due_l.to(torch.int32),
        join_cursor=state.join_cursor + due_j.to(torch.int32))


def apply_external_churn(cfg: PSPConfig, state: PSPState, *,
                         leave: Tuple[int, ...] = (),
                         join: Tuple[int, ...] = (),
                         mesh=None) -> PSPState:
    """Apply observed membership changes (host-driven, between ticks):
    no population floor, several workers at once; leaving a dead worker
    or joining an alive one is a no-op."""
    w = cfg.n_workers
    alive = state.alive.cpu().numpy()
    leave_sel = np.zeros(w, bool)
    leave_sel[list(map(int, leave))] = True
    leave_sel &= alive
    join_sel = np.zeros(w, bool)
    join_sel[list(map(int, join))] = True
    join_sel &= ~(alive & ~leave_sel)
    if not leave_sel.any() and not join_sel.any():
        return state
    dev = state.alive.device
    return _membership_update(state, torch.from_numpy(leave_sel).to(dev),
                              torch.from_numpy(join_sel).to(dev),
                              local_workers(cfg, mesh))


def psp_apply_tick(cfg: PSPConfig, opt_update: Callable, state: PSPState,
                   compute: Callable[[PSPState], Tuple[torch.Tensor, Tree]],
                   noise: Record, mesh=None) -> Tuple[PSPState, dict]:
    """One tick of PSP with the gradient source abstracted out.

    ``compute(state) -> (losses f32[W], grads [W, …] tree)`` runs after
    the churn phase — over ``mesh``, this rank's workers' (``[W/n, …]``,
    :func:`local_workers`); ``noise`` is this tick's record.  Returns
    (new_state, metrics); ``state`` is consumed (see the module
    docstring).
    """
    axis = worker_axis(mesh)
    mine = local_workers(cfg, mesh)
    if cfg.has_churn:
        state = _fire_churn(cfg, state, noise["leave"], noise["join"], mine)
    alive = state.alive

    # (1) every worker computes on its own (possibly stale) view
    losses, grads = compute(state)
    losses = collectives.all_gather(losses, axis, 0)

    # (2) completions push; departed workers are masked out
    completed = state.busy_until <= state.now
    push_mask = completed & ~state.pushed & alive
    n_push = push_mask.sum(dtype=torch.int32)
    denom = torch.clamp_min(n_push, 1)
    if cfg.contribution == "mean-alive":
        scale = 1.0 / torch.clamp_min(state.policy["denom"], 1.0)
    elif cfg.contribution == "mean":
        scale = 1.0 / denom
    else:
        scale = None

    mask = push_mask[mine]

    def _masked_sum(g):
        # the masked contributions of every worker, in worker order,
        # summed as on one rank (see the module docstring)
        c = torch.where(_masked_rows(mask, g.dim()), g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        s = collectives.all_gather(c, axis, 0).sum(0)
        return s if scale is None else s * scale

    server_grad = tree_map(_masked_sum, grads)
    any_push = push_mask.any()
    updates, new_opt = opt_update(server_grad, state.opt_state,
                                  state.server_params)
    new_params = tree_map(lambda p, u: torch.where(any_push, p + u, p),
                          state.server_params, updates)
    new_opt = tree_map(lambda new, old: torch.where(any_push, new, old),
                       new_opt, state.opt_state)
    pushed = state.pushed | push_mask

    # (3) the next durations are drawn before the decide (Elastic-BSP's
    # EMA observes them), then completed alive workers decide and pull
    next_dur = _duration(cfg, noise["dur"], state.slow)
    allowed, new_policy = cfg.barrier_policy.decide(
        state.policy, state.step, next_dur,
        alive if cfg.has_churn else None,
        scores=noise.get("scores"), u=noise.get("u"))
    allowed = allowed & completed & alive
    new_step = state.step + allowed.to(torch.int32)
    new_busy = torch.where(allowed, state.now + next_dur, state.busy_until)
    new_pushed = pushed & ~allowed
    _assign_rows(state.views, allowed, new_params, mine)

    if cfg.contribution == "mean-alive":
        new_policy = dict(new_policy)
        new_policy["denom"] = (0.9 * state.policy["denom"]
                               + 0.1 * alive.sum().float())

    # (4) event-driven virtual time: the next completion of a busy alive
    # worker, or the next poll of a blocked one
    blocked = completed & ~allowed & alive
    inf = torch.full_like(new_busy, float("inf"))
    next_busy = torch.where((new_busy > state.now) & alive, new_busy,
                            inf).amin()
    next_poll = torch.where(blocked.any(), state.now + cfg.poll_interval,
                            inf[0])
    next_time = torch.minimum(next_busy, next_poll)
    new_now = torch.where(torch.isfinite(next_time),
                          torch.maximum(state.now, next_time), state.now)

    new_state = state._replace(
        server_params=new_params, opt_state=new_opt, step=new_step,
        busy_until=new_busy, pushed=new_pushed, now=new_now,
        tick=state.tick + 1, total_pushes=state.total_pushes + n_push,
        policy=new_policy)
    if cfg.has_churn:
        n_alive = torch.clamp_min(alive.sum(dtype=torch.int32), 1)
        mean_step = (torch.where(alive, new_step, 0).sum(dtype=torch.int32)
                     / n_alive.float())
        hi = torch.where(alive, new_step, _I32_MIN).amax()
        lo = torch.where(alive, new_step, _I32_MAX).amin()
        step_spread = hi - lo
    else:
        mean_step = new_step.float().mean()
        step_spread = new_step.amax() - new_step.amin()
    metrics = {
        # pushed-worker mean; the all-worker mean on ticks with no push
        "loss": torch.where(any_push,
                            torch.where(push_mask, losses, 0.0).sum()
                            / denom, losses.mean()),
        "pushes": n_push,
        "allowed": allowed.sum(dtype=torch.int32),
        "blocked": blocked.sum(dtype=torch.int32),
        "alive": alive.sum(dtype=torch.int32),
        "mean_step": mean_step,
        "step_spread": step_spread,
        "virtual_time": new_now,
    }
    return new_state, metrics


def psp_train_step(cfg: PSPConfig, grad_fn: Callable, opt_update: Callable,
                   state: PSPState, batch: Tree, noise: Record, mesh=None
                   ) -> Tuple[PSPState, dict]:
    """One tick of PSP training with in-process gradients.

    ``grad_fn(params, microbatch) -> (loss, grads)`` is ONE worker's;
    it runs in a loop over the W workers (over ``mesh``, this rank's
    workers, :func:`local_workers`), on worker ``i``'s view and
    microbatch ``batch[i]`` (the leading axis W of every leaf of
    ``batch``), and the gradients are gathered into ``[W, …]`` buffers.
    """
    mine = local_workers(cfg, mesh)

    def compute(st):
        dev = st.step.device
        losses = torch.empty(mine.stop - mine.start, dtype=torch.float32,
                             device=dev)
        grads = tree_map(torch.empty_like, st.views)
        for i, g_id in enumerate(range(mine.start, mine.stop)):
            loss, g = grad_fn(tree_map(lambda v: v[i], st.views),
                              tree_map(lambda b: b[g_id], batch))
            losses[i] = loss
            tree_map(lambda buf, gi: buf[i].copy_(gi), grads, g)
        return losses, grads

    return psp_apply_tick(cfg, opt_update, state, compute, noise, mesh)


def state_to_tree(state: PSPState) -> dict:
    """The full training state as a field-name → value dict."""
    return state._asdict()


def state_from_tree(tree: dict) -> PSPState:
    """Inverse of :func:`state_to_tree`."""
    return PSPState(**tree)


def make_psp_step_fn(cfg: PSPConfig, grad_fn, opt_update, noise,
                     mesh=None):
    """``step(state, batch)``: :func:`psp_train_step` on the next record
    of the noise source ``noise`` (over ``mesh`` where given)."""
    def step(state, batch):
        return psp_train_step(cfg, grad_fn, opt_update, state, batch,
                              noise.tick_record(cfg), mesh)
    return step


def linear_psp_task(dim: int, lr: float = 0.1, seed: int = 0, *,
                    w_true: Optional[torch.Tensor] = None,
                    device: Any = "cpu"):
    """The paper's linear-regression task for this trainer.

    Returns (w_true f32[dim], grad_fn, opt_update): ``grad_fn(params,
    (x, y))`` for params ``{"w": f32[dim]}`` (loss mean((x·w − y)²)) and
    a plain-SGD ``opt_update`` of step ``lr``.  ``w_true`` is drawn
    N(0, 1/dim) from a generator seeded ``seed`` unless given.
    """
    if w_true is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        w_true = torch.randn(dim, generator=gen, device=device) / np.sqrt(dim)

    def grad_fn(params, batch):
        x, y = batch
        w = params["w"].detach().requires_grad_(True)
        loss = (x @ w - y).square().mean()
        (g,) = torch.autograd.grad(loss, w)
        return loss.detach(), {"w": g}

    def opt_update(g, s, p):
        return tree_map(lambda gi: -lr * gi, g), s

    return w_true, grad_fn, opt_update


def linear_psp_state(cfg: PSPConfig, dim: int, noise,
                     device: Any = "cpu", mesh=None) -> PSPState:
    """The initial state of :func:`elastic_drive`'s run (w = 0)."""
    return psp_init(cfg, {"w": torch.zeros(dim, device=device)},
                    lambda p: None, noise, mesh)


def _batches(cfg: PSPConfig, w_true: torch.Tensor, batch: int,
             seed: int):
    """Endless (x, x·w_true) minibatches, x ~ N(0, 1) (W, batch, dim)."""
    gen = torch.Generator(device=w_true.device)
    gen.manual_seed(seed)
    while True:
        x = torch.randn((cfg.n_workers, batch, w_true.shape[0]),
                        generator=gen, device=w_true.device)
        yield x, x @ w_true


def elastic_drive(cfg: PSPConfig, dim: int, ticks: int, *, batch: int = 16,
                  lr: float = 0.1, task_seed: int = 0, init_seed: int = 1,
                  batch_seed: int = 2, noise=None, xs=None,
                  w_true: Optional[torch.Tensor] = None,
                  device: Any = "cpu", events: Optional[dict] = None,
                  state: Optional[PSPState] = None, start_tick: int = 0,
                  mesh=None):
    """Drive the trainer on the linear task for ``ticks`` ticks.

    ``noise`` defaults to :class:`GeneratorNoise` seeded ``init_seed``;
    ``xs`` (an iterable of x (W, batch, dim), y = x·w_true) defaults to
    normal draws seeded ``batch_seed``.  ``events`` maps a tick to
    ``(leave_ids, join_ids)``, applied by :func:`apply_external_churn`
    just before that tick (see :func:`external_drive`).

    Resume: pass a restored ``state``, the ``noise`` source in the state
    it was checkpointed with, and the ``start_tick`` it was checkpointed
    at; the minibatch stream is fast-forwarded by ``start_tick`` draws,
    so ticks ``start_tick..ticks-1`` consume exactly what the
    uninterrupted run would have.

    Returns (w_true, an iterator of ``(state, metrics)`` after each tick).
    """
    w_true, grad_fn, opt_update = linear_psp_task(
        dim, lr=lr, seed=task_seed, w_true=w_true, device=device)
    noise = noise if noise is not None else GeneratorNoise(init_seed, device)
    data = (iter((x, x @ w_true) for x in xs) if xs is not None
            else _batches(cfg, w_true, batch, batch_seed))
    step = make_psp_step_fn(cfg, grad_fn, opt_update, noise, mesh)
    if state is None:
        state = linear_psp_state(cfg, dim, noise, device, mesh)
    for _ in range(start_tick):
        next(data)

    def _ticks(state):
        for t in range(start_tick, ticks):
            if events and t in events:
                leave, join = events[t]
                state = apply_external_churn(cfg, state, leave=tuple(leave),
                                             join=tuple(join), mesh=mesh)
            state, m = step(state, next(data))
            yield state, m

    return w_true, _ticks(state)


def external_drive(cfg: PSPConfig, dim: int, ticks: int, events: dict,
                   **kw):
    """:func:`elastic_drive` with an explicit leave / join schedule
    ``events`` (tick → (leave_ids, join_ids)), applied just before each
    listed tick."""
    return elastic_drive(cfg, dim, ticks, events=events, **kw)
