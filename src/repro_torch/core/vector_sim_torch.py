"""Tensor backend of the sweep engine: the tick loop, on one device or
sharded over a ``(rows, nodes)`` mesh of ranks.

The port's counterpart of :mod:`repro.core.vector_sim_jax`.  One grid
tick — control plane and data plane — is one call of the fused tick
(:func:`repro_torch.kernels.ops.psp_tick`): the CUDA kernel on a CUDA
device, its plain PyTorch version on the CPU (``PSP_TICK_IMPL`` = ``auto``
| ``cuda`` | ``ref`` overrides).

:func:`run_batch` runs the tick grid as the planner
(:func:`repro_torch.core.sweep_plan.plan_sweep`) lays it out: superticks
of ``stride`` ticks, each drawing its whole noise block at once and
recording one trace point, grouped into chunks; the loop stops once every
row is past its horizon.  Inputs are staged on the device once by
:func:`_prepare` (and the params checked once for the kernel), the state
stays there and is donated to every tick (the kernel updates the server
models and node views in place), and the traces and final state come
back to the host once at the end.

Under an initialised process group the batch runs on the plan's
``(rows, nodes)`` mesh (:func:`repro_torch.parallel.sharding.sweep_mesh`;
``run_sweep(..., mesh=)`` or ``PSP_SWEEP_MESH`` pick it), as the
reference's ``shard_map`` does: each rank holds its row block of the
per-row state, params and ``w``, and of those rows its node block of the
node state (``steps`` … ``pulled``, ``pol_ema``) and node params.  With
more than one node shard a tick is
:func:`~repro_torch.kernels.psp_tick.psp_tick_sharded` on the plain path
and the gathered CUDA tick on the kernel path
(:func:`repro_torch.kernels.ops.psp_tick` with ``node_axis``).  Each
supertick's error trace is taken on the server models gathered over
``rows`` (the real rows, the same shapes on every mesh); the update
counts and the final state are gathered at the end, and every rank of
the group returns the same results (ranks past the mesh receive rank
0's).

Noise: per supertick, the same quantities in the same layout as the
reference (minibatch features and label noise per node, step-duration
jitter per row and node, β-sample scores — per row when ``masked``, else
shared — or the β = 1 uniforms, churn uniforms), drawn by a
``torch.Generator`` on the device seeded from the same ``SeedSequence``
as the reference's key.  Torch's generator is not threefry, so the draws
differ from the reference's and whole sweeps agree with it at the
distribution level.  Any callable ``noise(sup) -> dict`` may replace the
generator (tests inject their own draws).  On a mesh every rank runs the
generator with the same seed, draws the supertick's full-width block
(rows padded as on one rank, :func:`~repro_torch.core.sweep_plan.draw_rows`)
and takes its own rows and nodes (on the gathered kernel path its rows
and every node, so that the tick gathers only the node state): the
results are bit for bit the same on every mesh, at the cost of one
full-width block per rank per supertick (the reference keys its draws by
global row and node id instead).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import env
from repro_torch.core.simulator import SimResult
from repro_torch.core.sweep_plan import (SweepPlan, available_devices,
                                         draw_rows, plan_sweep)
from repro_torch.kernels import ops
from repro_torch.kernels.psp_tick import (NODE_PARAM_KEYS, NODE_STATE_KEYS,
                                          POLICY_STATE_KEYS, STATE_KEYS,
                                          stage_params)
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (SWEEP_NODES_AXIS, SWEEP_ROWS_AXIS,
                                           sweep_mesh)

__all__ = ["GeneratorNoise", "run_batch", "tick_impl", "ticks_to_run"]

Noise = Callable[[int], Dict[str, torch.Tensor]]


def tick_impl() -> str:
    """Tick implementation (``PSP_TICK_IMPL``): ``auto`` | ``cuda`` | ``ref``."""
    return env.get_str("PSP_TICK_IMPL")


def _measure_idx(sim) -> np.ndarray:
    """Global tick index of each measurement point (t > 0)."""
    return np.searchsorted(sim.ticks, sim.m_times[1:] - 1e-9)


def _static(sim) -> Tuple[int, bool]:
    """(k_max, masked) of a batch: the tick's static branches."""
    k_max = int(min(max(int(sim.beta.max(initial=-1)), 0), sim.P - 1))
    masked = sim.has_churn or bool((sim.n_true < sim.P).any())
    return k_max, masked


def _plan(sim, mesh=None) -> SweepPlan:
    """The batch's stride, chunk schedule and mesh."""
    k_max, masked = _static(sim)
    return plan_sweep(sim.ticks.size, _measure_idx(sim), sim.B, sim.P,
                      batch=sim.batch, d=sim.d, k_max=k_max, masked=masked,
                      has_churn=sim.has_churn, mesh=mesh)


def ticks_to_run(sim, mesh=None) -> int:
    """Ticks :func:`run_batch` executes for ``sim`` (the planned chunks
    up to the one that covers the last live record)."""
    plan, rec, n = _plan(sim, mesh), 0, 0
    for n_rec in plan.chunks:
        if rec >= plan.n_rec_live:
            break
        n += n_rec * plan.stride
        rec += n_rec
    return n


class GeneratorNoise:
    """Supertick noise blocks from a ``torch.Generator`` on the device.

    Calling it with a supertick index returns the block for the next
    supertick (the draws follow the call order, which the tick loop keeps
    fixed): every entry has the stride as its leading dimension.
    """

    def __init__(self, seed: int, device: torch.device, *, stride: int,
                 Bp: int, P: int, m: int, d: int, k_max: int, masked: bool,
                 has_churn: bool):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device, self.stride = device, stride
        self.Bp, self.P, self.m, self.d = Bp, P, m, d
        self.k_max, self.masked, self.has_churn = k_max, masked, has_churn

    def _u(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def __call__(self, sup: int) -> Dict[str, torch.Tensor]:
        """The noise block of supertick ``sup``."""
        S, Bp, P = self.stride, self.Bp, self.P
        x = {"X": torch.randn((S, P, self.m, self.d), generator=self.gen,
                              device=self.device),
             "mb": torch.randn((S, P, self.m), generator=self.gen,
                               device=self.device),
             "dur": self._u(S, Bp, P)}
        if self.k_max > 0:
            if self.masked:
                x["scores"] = self._u(S, Bp, P, P)
            elif self.k_max == 1:
                x["u1"] = self._u(S, P)
            else:
                x["scores"] = self._u(S, P, P)
        if self.has_churn:
            x["leave"] = self._u(S, Bp, P)
            x["join"] = self._u(S, Bp, P)
        return x


def _prepare(sim, device: torch.device, mesh=None):
    """Stage a batch on ``device``: (plan, params, carry, t_sched, lc, jc,
    seed), whole (a sharded run takes its blocks from them).  Rows pad to
    the plan's ``b_pad``; padded rows carry a negative horizon and never
    tick."""
    B, P, d = sim.B, sim.P, sim.d
    plan = _plan(sim, mesh)
    Bp = plan.b_pad
    f32, i32 = torch.float32, torch.int32

    def pad_rows(a, fill=0):
        if Bp == B:
            return a
        pad = np.full((Bp - B,) + a.shape[1:], fill, dtype=a.dtype)
        return np.concatenate([a, pad], axis=0)

    def put(a, dtype=None, fill=0):
        a = pad_rows(np.asarray(a), fill)
        return torch.as_tensor(a, dtype=dtype, device=device)

    seed = np.random.SeedSequence(
        [int(c.seed) for c in sim.configs] + [B, P, d]).generate_state(1)[0]
    params = {
        "eps": float(np.float32(max(1e-9, 1e-3 * sim.dt))),
        "poll": float(np.float32(sim.poll_interval)),
        "w_true": put(sim.w_true, f32),
        # padded rows never tick; a unit norm keeps their error finite
        "w_true_norm": put(sim.w_true_norm, f32, 1.0),
        "compute_time": put(sim.compute_time, f32, 1.0),
        "lr": put(sim.lr, f32),
        "noise_std": put(sim.noise_std, f32),
        "horizon": put(sim.row_duration, f32, -1.0),
        "staleness": put(sim.staleness, i32),
        "beta_clip": put(np.clip(sim.beta, 0, sim.n_true - 1), i32),
        "is_asp": put(sim.is_asp),
        "full_view": put(sim.full_view),
        "sampled": put(sim.sampled),
        "valid_slot": put(sim.valid_slot),
        "dist_hops": put(np.where(sim.distributed & sim.sampled,
                                  sim.hops_per_peer, 0), i32),
    }
    if sim.adaptive:
        params.update(
            is_dssp=put(sim.is_dssp), is_ebsp=put(sim.is_ebsp),
            is_anneal=put(sim.is_anneal), pol_lo=put(sim.pol_lo, i32),
            beta_lo=put(sim.beta_lo, i32),
            ebsp_range=put(sim.ebsp_range, f32),
            ebsp_alpha=put(sim.ebsp_alpha, f32))
    carry = {
        "w": torch.zeros((Bp, d), dtype=f32, device=device),
        "pulled": torch.zeros((Bp, P, d), dtype=f32, device=device),
        "steps": torch.zeros((Bp, P), dtype=i32, device=device),
        "alive": put(sim.alive),
        "computing": put(sim.computing),
        "event_time": put(sim.event_time.astype(np.float32), f32, 1.0),
        "ready": put(sim.ready.astype(np.float32), f32, 1.0),
        "blocked": put(sim.blocked),
        "total_updates": torch.zeros(Bp, dtype=i32, device=device),
        "control": torch.zeros(Bp, dtype=i32, device=device),
        "pend_leave": torch.zeros(Bp, dtype=i32, device=device),
        "pend_join": torch.zeros(Bp, dtype=i32, device=device),
    }
    if sim.adaptive:
        carry.update(pol_thr=put(sim.pol_thr, i32),
                     pol_ema=put(sim.pol_ema.astype(np.float32), f32),
                     pol_beta=put(sim.pol_beta, i32))

    # scheduled grid: live ticks, then dead padding past every horizon
    T = sim.ticks.size
    t_sched = np.concatenate(
        [sim.ticks, sim.ticks[-1] + sim.dt * np.arange(1, plan.n_ticks - T + 1)]
    ).astype(np.float32).tolist()
    lc = np.zeros((plan.n_ticks, Bp), np.int32)
    jc = np.zeros((plan.n_ticks, Bp), np.int32)
    if sim.has_churn:
        lc[:T, :B] = sim.leave_counts
        jc[:T, :B] = sim.join_counts
    lc = torch.as_tensor(lc, device=device)
    jc = torch.as_tensor(jc, device=device)
    return plan, params, carry, t_sched, lc, jc, int(seed)


class _Block:
    """This rank's block of a batch on the plan's mesh: its rows
    ``rows`` (of ``b_pad``) and nodes ``nodes`` (of P), and the axes the
    tick and the traces reduce over (None without a process group)."""

    def __init__(self, plan: SweepPlan, P: int, device: torch.device):
        self.row_axis = self.node_axis = None
        self.inside = True
        r = n = 0
        if dist.is_available() and dist.is_initialized():
            dm = sweep_mesh(plan.rows, plan.nodes, device.type)
            coord = dm.get_coordinate()
            self.inside = coord is not None
            if self.inside:
                r, n = coord
                self.row_axis = collectives.mesh_axis(dm, SWEEP_ROWS_AXIS)
                if plan.nodes > 1:
                    self.node_axis = collectives.mesh_axis(
                        dm, SWEEP_NODES_AXIS)
        b_loc = plan.b_pad // plan.rows
        self.rows = slice(r * b_loc, (r + 1) * b_loc)
        self.nodes = slice(n * plan.p_loc, (n + 1) * plan.p_loc)
        self.whole = self.nodes == slice(0, P)

    def take(self, a: torch.Tensor, row_dim: Optional[int],
             node_dim: Optional[int]) -> torch.Tensor:
        """``a``'s block: its rows (``row_dim``; rows past ``a``'s end are
        zeros) and nodes (``node_dim``)."""
        if node_dim is not None and not self.whole:
            a = a.narrow(node_dim, self.nodes.start,
                         self.nodes.stop - self.nodes.start)
        lo, hi = self.rows.start, self.rows.stop
        if row_dim is not None and (lo, hi) != (0, a.shape[row_dim]):
            have = a.narrow(row_dim, min(lo, a.shape[row_dim]),
                            max(0, min(hi, a.shape[row_dim]) - lo))
            if have.shape[row_dim] < hi - lo:
                shape = list(a.shape)
                shape[row_dim] = hi - lo - have.shape[row_dim]
                have = torch.cat([have, a.new_zeros(shape)], dim=row_dim)
            a = have
        return a.contiguous()

    def noise(self, x: Dict[str, torch.Tensor],
              nodes: bool = True) -> Dict[str, torch.Tensor]:
        """A supertick's full-width noise block → this rank's block
        (stride leading; ``X``/``mb``/``u1``/shared ``scores`` by node,
        the rest by row and node; masked ``scores`` keep every peer).
        ``nodes=False`` keeps every node: the gathered kernel path ticks
        at full width and would only gather the slices back."""
        out = {}
        for k, v in x.items():
            if k in ("X", "mb", "u1") or (k == "scores" and v.dim() == 3):
                out[k] = self.take(v, None, 1) if nodes else v
            else:
                out[k] = self.take(v, 1, 2 if nodes else None)
        return out


#: params entries that are not per-row tensors
_HOST_PARAMS = ("eps", "poll")


def run_batch(sim, *, device, noise: Optional[Noise] = None,
              mesh: Optional[Tuple[int, int]] = None) -> List[SimResult]:
    """Run a :class:`~repro_torch.core.vector_sim.VectorSimulator` batch.

    Args:
      sim: the batch's static state.
      device: torch device the sweep runs on (this rank's).
      noise: optional replacement of the generator noise, called once
        per supertick with its index (see :class:`GeneratorNoise`); it
        returns full-width blocks.
      mesh: the ``(rows, nodes)`` placement asked for (see
        :func:`~repro_torch.core.sweep_plan.resolve_mesh`); it matters
        only under an initialised process group, whose every rank calls
        this with the same batch.

    Executes the planned chunks with the fused tick (the implementation
    ``PSP_TICK_IMPL`` selects), one trace record per
    supertick, copies traces and final state to the host once, writes
    the final state back into ``sim`` and returns its results.
    """
    device = torch.device(device)
    B = sim.B
    k_max, masked = _static(sim)
    plan, params, carry, t_sched, lc, jc, seed = _prepare(sim, device, mesh)
    blk = _Block(plan, sim.P, device)
    if not blk.inside:
        return _from_rank0(sim, None)
    if noise is None:
        noise = GeneratorNoise(seed, device, stride=plan.stride,
                               Bp=draw_rows(B), P=sim.P, m=sim.batch,
                               d=sim.d, k_max=k_max, masked=masked,
                               has_churn=sim.has_churn)
    w_true, w_norm = params["w_true"][:B], params["w_true_norm"][:B]
    params = {k: v if k in _HOST_PARAMS else blk.take(
        v, 0, 1 if k in NODE_PARAM_KEYS else None) for k, v in params.items()}
    carry = {k: blk.take(v, 0, 1 if k in NODE_STATE_KEYS else None)
             for k, v in carry.items()}
    lc, jc = blk.take(lc, 1, None), blk.take(jc, 1, None)
    impl = tick_impl()
    kernel = ops.use_kernel(impl, device)
    if kernel:
        if blk.node_axis is not None:
            params = ops.gather_node_params(params, blk.node_axis)
        params = stage_params(params, adaptive=sim.adaptive)
    # the carry is donated to each tick, as the reference donates it to
    # each chunk scan: the kernel updates w and the views in place
    kw = dict(k_max=k_max, has_churn=sim.has_churn, masked=masked,
              adaptive=sim.adaptive, impl=impl, node_axis=blk.node_axis)
    state_keys = STATE_KEYS + (POLICY_STATE_KEYS if sim.adaptive else ())
    errs = torch.empty((plan.n_rec, B), dtype=torch.float32, device=device)
    upds = torch.empty((plan.n_rec, plan.b_pad // plan.rows),
                       dtype=torch.int32, device=device)
    rec = 0
    for n_rec in plan.chunks:
        if rec >= plan.n_rec_live:
            break            # every row is past its horizon: dead chunk
        for sup in range(rec, rec + n_rec):
            x = blk.noise(noise(sup), nodes=not kernel)
            for j in range(plan.stride):
                i = sup * plan.stride + j
                state = {k: carry[k] for k in state_keys}
                rand = {k: v[j] for k, v in x.items()}
                state, out = ops.psp_tick(state, rand, params, t_sched[i],
                                          lc[i], jc[i], **kw)
                carry.update(state)
                carry["total_updates"] = carry["total_updates"] + out["n_fin"]
                carry["control"] = carry["control"] + out["ctrl"]
            w = collectives.all_gather(carry["w"], blk.row_axis, 0)[:B]
            errs[sup] = torch.linalg.vector_norm(w - w_true, dim=1) / w_norm
            upds[sup] = carry["total_updates"]
        rec += n_rec

    def whole(k):
        v = carry[k]
        if k in NODE_STATE_KEYS:
            v = collectives.all_gather(v, blk.node_axis, 1)
        return collectives.all_gather(v, blk.row_axis, 0)[:B].cpu().numpy()

    keys = ["w", "steps", "alive", "total_updates", "control"]
    if sim.adaptive:
        keys += list(POLICY_STATE_KEYS)
    final = {k: whole(k) for k in keys}
    err_t = errs[:plan.n_rec_live].cpu().numpy()
    upd_t = collectives.all_gather(upds[:plan.n_rec_live], blk.row_axis,
                                   1)[:, :B].cpu().numpy()

    # measurement grid: the state after the first tick t with m_j ≤ t +
    # eps lands on a supertick record (the planner guarantees it), plus
    # the t = 0 point (w = 0 ⇒ normalized error exactly 1)
    r_idx = (_measure_idx(sim) + 1) // plan.stride - 1
    errs_m = np.concatenate([np.ones((B, 1)),
                             np.asarray(err_t, np.float64).T[:, r_idx]],
                            axis=1)
    upds_m = np.concatenate([np.zeros((B, 1), np.int64),
                             np.asarray(upd_t, np.int64).T[:, r_idx]], axis=1)
    if plan.n_devices < available_devices():
        return _from_rank0(sim, (final, errs_m, upds_m))
    return _finish(sim, final, errs_m, upds_m)


def _from_rank0(sim, mine) -> List[SimResult]:
    """The results of a batch whose mesh leaves some ranks out: rank 0's,
    broadcast to every rank of the group (each calls this)."""
    box = [mine]
    dist.broadcast_object_list(box, src=0)
    return _finish(sim, *box[0])


def _finish(sim, final, errs_m, upds_m) -> List[SimResult]:
    """Write the final state back into ``sim`` and assemble its
    results."""
    sim.w = np.asarray(final["w"], np.float64)
    sim.steps = np.asarray(final["steps"], np.int64)
    sim.alive = np.asarray(final["alive"])
    sim.total_updates = np.asarray(final["total_updates"], np.int64)
    sim.control_messages = np.asarray(final["control"], np.int64)
    if sim.adaptive:
        sim.pol_thr = np.asarray(final["pol_thr"], np.int64)
        sim.pol_ema = np.asarray(final["pol_ema"], np.float64)
        sim.pol_beta = np.asarray(final["pol_beta"], np.int64)
    return sim._results(errs_m, upds_m)
