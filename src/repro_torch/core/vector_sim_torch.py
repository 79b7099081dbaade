"""Tensor backend of the sweep engine: the tick loop on one device.

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

Noise: per supertick, the same quantities in the same layout as the
reference (minibatch features and label noise per node, step-duration
jitter per row and node, β-sample scores — per row when ``masked``, else
shared — or the β = 1 uniforms, churn uniforms), drawn by a
``torch.Generator`` on the device seeded from the same ``SeedSequence``
as the reference's key.  Torch's generator is not threefry, so the draws
differ from the reference's and whole sweeps agree with it at the
distribution level.  Any callable ``noise(sup) -> dict`` may replace the
generator (tests inject their own draws).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import env
from repro_torch.core.simulator import SimResult
from repro_torch.core.sweep_plan import SweepPlan, plan_sweep
from repro_torch.kernels import ops
from repro_torch.kernels.psp_tick import (POLICY_STATE_KEYS, STATE_KEYS,
                                          stage_params)

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


def _plan(sim) -> SweepPlan:
    """The batch's stride and chunk schedule."""
    k_max, masked = _static(sim)
    return plan_sweep(sim.ticks.size, _measure_idx(sim), sim.B, sim.P,
                      batch=sim.batch, d=sim.d, k_max=k_max, masked=masked,
                      has_churn=sim.has_churn)


def ticks_to_run(sim) -> int:
    """Ticks :func:`run_batch` executes for ``sim`` (the planned chunks
    up to the one that covers the last live record)."""
    plan, rec, n = _plan(sim), 0, 0
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


def _prepare(sim, device: torch.device):
    """Stage a batch on ``device``: (plan, params, carry, t_sched, lc, jc,
    seed).  Rows pad to the plan's ``b_pad``; padded rows carry a negative
    horizon and never tick."""
    B, P, d = sim.B, sim.P, sim.d
    k_max, masked = _static(sim)
    plan = _plan(sim)
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


def run_batch(sim, *, device,
              noise: Optional[Noise] = None) -> List[SimResult]:
    """Run a :class:`~repro_torch.core.vector_sim.VectorSimulator` batch.

    Args:
      sim: the batch's static state.
      device: torch device the sweep runs on.
      noise: optional replacement of the generator noise, called once
        per supertick with its index (see :class:`GeneratorNoise`).

    Executes the planned chunks with the fused tick (the implementation
    ``PSP_TICK_IMPL`` selects), one trace record per
    supertick, copies traces and final state to the host once, writes
    the final state back into ``sim`` and returns its results.
    """
    device = torch.device(device)
    B = sim.B
    k_max, masked = _static(sim)
    plan, params, carry, t_sched, lc, jc, seed = _prepare(sim, device)
    if noise is None:
        noise = GeneratorNoise(seed, device, stride=plan.stride,
                               Bp=plan.b_pad, P=sim.P, m=sim.batch, d=sim.d,
                               k_max=k_max, masked=masked,
                               has_churn=sim.has_churn)
    impl = tick_impl()
    if ops.use_kernel(impl, device):
        params = stage_params(params, adaptive=sim.adaptive)
    # the carry is donated to each tick, as the reference donates it to
    # each chunk scan: the kernel updates w and the views in place
    kw = dict(k_max=k_max, has_churn=sim.has_churn, masked=masked,
              adaptive=sim.adaptive, impl=impl)
    state_keys = STATE_KEYS + (POLICY_STATE_KEYS if sim.adaptive else ())
    errs = torch.empty((plan.n_rec, plan.b_pad), dtype=torch.float32,
                       device=device)
    upds = torch.empty((plan.n_rec, plan.b_pad), dtype=torch.int32,
                       device=device)
    rec = 0
    for n_rec in plan.chunks:
        if rec >= plan.n_rec_live:
            break            # every row is past its horizon: dead chunk
        for sup in range(rec, rec + n_rec):
            x = noise(sup)
            for j in range(plan.stride):
                i = sup * plan.stride + j
                state = {k: carry[k] for k in state_keys}
                rand = {k: v[j] for k, v in x.items()}
                state, out = ops.psp_tick(state, rand, params, t_sched[i],
                                          lc[i], jc[i], **kw)
                carry.update(state)
                carry["total_updates"] = carry["total_updates"] + out["n_fin"]
                carry["control"] = carry["control"] + out["ctrl"]
            errs[sup] = (torch.linalg.vector_norm(
                carry["w"] - params["w_true"], dim=1) / params["w_true_norm"])
            upds[sup] = carry["total_updates"]
        rec += n_rec

    keys = ["w", "steps", "alive", "total_updates", "control"]
    if sim.adaptive:
        keys += list(POLICY_STATE_KEYS)
    final = {k: carry[k][:B].cpu().numpy() for k in keys}
    err_t = errs[:plan.n_rec_live, :B].cpu().numpy()
    upd_t = upds[:plan.n_rec_live, :B].cpu().numpy()

    # measurement grid: the state after the first tick t with m_j ≤ t +
    # eps lands on a supertick record (the planner guarantees it), plus
    # the t = 0 point (w = 0 ⇒ normalized error exactly 1)
    r_idx = (_measure_idx(sim) + 1) // plan.stride - 1
    errs_m = np.concatenate([np.ones((B, 1)),
                             np.asarray(err_t, np.float64).T[:, r_idx]],
                            axis=1)
    upds_m = np.concatenate([np.zeros((B, 1), np.int64),
                             np.asarray(upd_t, np.int64).T[:, r_idx]], axis=1)

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
