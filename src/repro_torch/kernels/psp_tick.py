"""One full PSP sweep-grid tick: plain PyTorch version and the CUDA kernel.

The port's counterpart of :mod:`repro.kernels.psp_tick`.  One grid tick
of the sweep engine (:mod:`repro_torch.core.vector_sim_torch`) is a
*control-plane* update over the ``(B, P)`` scenario state — churn, finish
bookkeeping, the full-view barrier, the β-sample barrier, start/re-poll
anchoring, adaptive-policy updates — and a *data-plane* SGD push (the
minibatch residual, the gradient sum, the server update) plus the pull of
the new server model into the starters' views.

Two implementations with one contract:

* :func:`psp_tick_ref` — plain PyTorch, phase by phase as the reference's
  ``psp_tick_ref``; it runs on any device and is what CPU tensors get;
  :func:`psp_tick_sharded` is the same tick on node-sharded state, its
  cross-node reductions collectives over the sweep mesh's nodes axis.
* :func:`psp_tick_cuda` — the hand-written CUDA tick
  (``kernels/csrc/psp_tick.cu``) in five launches: a per-row prologue
  (churn, finishes, row scalars, the finisher lists), the decisions over
  (row, node tile) blocks, the finishers' residuals, the gradient's
  partial sums, and the server update with the starters' pull.  It
  updates ``state["w"]`` and ``state["pulled"]`` in place (the sweep's
  carry is donated to every tick, as the reference donates it to each
  chunk scan); every other input stays as it was.

:func:`stage_params` checks a batch's params once for the kernel;
:func:`tick_bytes` counts the bytes a tick must move, for its bound.

All randomness (step-duration jitter, β-sample scores or the β = 1
uniforms, churn uniforms, the minibatch blob) is an input, so both
implementations consume identical noise.  A row whose ``horizon`` lies
before the tick's time is frozen: no churn, finishes, decisions or update.

State layout (``B`` rows × ``P`` node slots, ``d``-dim model, ``m``
minibatch rows): ``steps`` i32[B, P], ``alive``/``computing``/``blocked``
bool[B, P], ``event_time``/``ready`` f32[B, P], ``pend_leave``/
``pend_join`` i32[B], ``w`` f32[B, d], ``pulled`` f32[B, P, d]; adaptive
batches add ``pol_thr``/``pol_beta`` i32[B] and ``pol_ema`` f32[B, P].
The scalars ``t``, ``params["eps"]`` and ``params["poll"]`` are host
floats (float32 values).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import barrier_kernel
from repro_torch.parallel import collectives

__all__ = ["DATA_PLANE_BLOCK", "NODE_PARAM_KEYS", "NODE_STATE_KEYS",
           "POLICY_STATE_KEYS", "STATE_KEYS",
           "TickParams", "launch_count", "psp_tick_cuda", "psp_tick_ref",
           "psp_tick_sharded", "reset_launch_count", "stage_params",
           "tick_bytes"]

#: data-plane row-block width of the plain version: the SGD push runs on
#: fixed blocks of this many scenario rows (batches pad with zero rows), so
#: each row's bits do not depend on how rows are grouped.  The sweep
#: planner pads batches to a multiple of it.
DATA_PLANE_BLOCK = 16

#: carried tick state, in canonical order (control plane, then data plane)
STATE_KEYS = ("steps", "alive", "computing", "event_time", "ready",
              "blocked", "pend_leave", "pend_join", "w", "pulled")

#: adaptive barrier-policy state, present only when ``adaptive``
POLICY_STATE_KEYS = ("pol_thr", "pol_ema", "pol_beta")

#: state and params entries with a node dimension (axis 1): what a node
#: shard holds its own slice of under a ``(rows, nodes)`` sweep mesh
NODE_STATE_KEYS = ("steps", "alive", "computing", "event_time", "ready",
                   "blocked", "pulled", "pol_ema")
NODE_PARAM_KEYS = ("compute_time", "valid_slot")

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min

Tensors = Dict[str, torch.Tensor]


def _push_block(X: torch.Tensor, diff: torch.Tensor, fin: torch.Tensor,
                w: torch.Tensor, lr: torch.Tensor, noise_std: torch.Tensor,
                mb: torch.Tensor) -> torch.Tensor:
    """One block of rows' SGD push: the finishers' residuals, their
    gradient sum and the server update (shapes as
    :func:`_data_plane_block`'s); returns the new server models."""
    m = X.shape[1]
    # a contraction, not the reference's broadcast-multiply: at the paper
    # shape the broadcast would hold W·P·m·d floats
    resid = (torch.einsum("kpd,pmd->kpm", diff, X)
             - noise_std[:, None, None] * mb[None])
    resid = torch.where(fin[:, :, None], resid, torch.zeros_like(resid))
    gsum = torch.einsum("kpm,pmd->kd", resid, X) / m
    return w - lr[:, None] * gsum


def _data_plane_block(X: torch.Tensor, diff: torch.Tensor, fin: torch.Tensor,
                      start: torch.Tensor, w: torch.Tensor,
                      pulled: torch.Tensor, lr: torch.Tensor,
                      noise_std: torch.Tensor, mb: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of rows' SGD push and model-view pull.

    Args:
      X: f32[P, m, d] minibatch features (shared across rows).
      diff: f32[W, P, d] node views minus ground truth.
      fin / start: bool[W, P] finisher and starter masks.
      w: f32[W, d] server models; ``pulled`` f32[W, P, d] node views.
      lr / noise_std: f32[W]; ``mb`` f32[P, m] label noise.

    Returns:
      (w', pulled'): updated server models and node views.
    """
    w_new = _push_block(X, diff, fin, w, lr, noise_std, mb)
    pulled_new = torch.where(start[..., None], w_new[:, None, :], pulled)
    return w_new, pulled_new


def _pad_rows(a: torch.Tensor, Bp: int) -> torch.Tensor:
    """``a`` with zero rows appended up to ``Bp`` rows."""
    if a.shape[0] == Bp:
        return a
    return torch.cat([a, a.new_zeros((Bp - a.shape[0],) + a.shape[1:])])


def psp_tick_ref(state: Tensors, rand: Tensors, params: Dict,
                 t: float, leave_n: torch.Tensor, join_n: torch.Tensor, *,
                 k_max: int, has_churn: bool, masked: bool,
                 adaptive: bool = False) -> Tuple[Tensors, Tensors]:
    """One full tick, batched over B scenario rows (plain PyTorch).

    It never writes its inputs: every output is a new tensor (the CUDA
    tick, :func:`psp_tick_cuda`, writes ``w`` and ``pulled`` in place).

    Args:
      state: the tick state (:data:`STATE_KEYS`, plus
        :data:`POLICY_STATE_KEYS` when ``adaptive``).
      rand: pre-drawn noise — ``dur`` f32[B, P]; ``X`` f32[P, m, d] and
        ``mb`` f32[P, m]; ``scores`` (f32[B, P, P] when ``masked`` else
        f32[P, P]) or ``u1`` f32[P] (β = 1, unmasked) when ``k_max > 0``;
        ``leave``/``join`` f32[B, P] when ``has_churn``.
      params: per-row policy tensors — ``staleness``/``beta_clip``/
        ``dist_hops`` i32[B]; ``is_asp``/``full_view``/``sampled`` bool[B];
        ``compute_time`` f32[B, P]; ``valid_slot`` bool[B, P];
        ``horizon``/``lr``/``noise_std`` f32[B]; ``w_true`` f32[B, d];
        host floats ``eps``/``poll``.  When ``adaptive``: ``is_dssp``/
        ``is_ebsp``/``is_anneal`` bool[B], ``pol_lo``/``beta_lo`` i32[B],
        ``ebsp_range``/``ebsp_alpha`` f32[B].
      t: this tick's grid time (a float32 value); rows with
        ``horizon < t`` freeze.
      leave_n / join_n: i32[B] churn events due this tick.
      k_max: static max sample-slot count over the batch.
      has_churn / masked / adaptive: the static branches of the tick.

    Returns:
      (new_state, out) where ``out`` holds ``fin``/``start`` bool[B, P]
      and ``n_fin``/``ctrl`` i32[B].
    """
    steps, alive = state["steps"], state["alive"]
    computing, blocked = state["computing"], state["blocked"]
    event_time, ready = state["event_time"], state["ready"]
    B, P = steps.shape
    dev, f32, i32 = steps.device, torch.float32, torch.int32
    t = torch.tensor(float(t), dtype=f32, device=dev)
    eps = torch.tensor(float(params["eps"]), dtype=f32, device=dev)
    poll = torch.tensor(float(params["poll"]), dtype=f32, device=dev)
    due = t + eps
    iota = torch.arange(P, device=dev)
    active = t <= params["horizon"] + eps

    # 0. churn: at most one pre-sampled leave/join fires per row per tick
    if has_churn:
        pend_l = state["pend_leave"] + leave_n
        pend_j = state["pend_join"] + join_n
        n_alive = alive.sum(dim=1, dtype=i32)
        do_l = active & (pend_l > 0) & (n_alive > 2)
        victim = barrier_kernel.churn_victim(rand["leave"], alive)
        alive = alive & ~(do_l[:, None] & (victim[:, None] == iota))
        pool = ~alive & params["valid_slot"]
        do_j = active & (pend_j > 0) & pool.any(dim=1)
        joiner = barrier_kernel.churn_joiner(rand["join"], alive,
                                             params["valid_slot"])
        sel = do_j[:, None] & (joiner[:, None] == iota)
        alive = alive | sel
        fresh = torch.where(alive, steps,
                            torch.full_like(steps, _I32_MIN)).amax(dim=1)
        steps = torch.where(sel, fresh[:, None], steps)
        computing = computing & ~sel
        event_time = torch.where(sel, t, event_time)
        ready = torch.where(sel, t, ready)
        blocked = blocked & ~sel
        pend_leave = torch.where(active, pend_l - (pend_l > 0).to(i32),
                                 state["pend_leave"])
        pend_join = torch.where(active, pend_j - (pend_j > 0).to(i32),
                                state["pend_join"])
    else:
        pend_leave, pend_join = state["pend_leave"], state["pend_join"]

    # 1. finishes: advance steps, become "deciding"
    fin = computing & alive & (event_time <= due) & active[:, None]
    any_fin = fin.any(dim=1)
    row_last = torch.where(fin, event_time,
                           torch.full_like(event_time, -torch.inf)).amax(1)
    row_unblock = torch.where(any_fin, torch.minimum(row_last, t), t)
    steps = steps + fin.to(i32)
    computing = computing & ~fin
    ready = torch.where(fin, event_time, ready)
    blocked = blocked & ~fin

    # 2. barrier decisions for every due deciding node
    cand = ~computing & alive & (event_time <= due) & active[:, None]
    stal = torch.broadcast_to(params["staleness"][:, None], (B, P))
    beta_eff = params["beta_clip"][:, None]
    if adaptive:
        slack = barrier_kernel.elastic_slack(
            state["pol_ema"], params["ebsp_range"][:, None], alive)
        stal = torch.where(params["is_dssp"][:, None],
                           state["pol_thr"][:, None],
                           torch.where(params["is_ebsp"][:, None], slack,
                                       stal))
        beta_eff = torch.where(params["is_anneal"], state["pol_beta"],
                               params["beta_clip"])[:, None]
    pass_fv = barrier_kernel.full_view_allowed(steps, stal, alive)
    if k_max > 0:
        pass_sm, n_sampled = barrier_kernel.sampled_allowed(
            steps, stal, k_max, beta=beta_eff, scores=rand.get("scores"),
            u=rand.get("u1"), alive=alive if masked else None)
    else:
        pass_sm = torch.ones((B, P), dtype=torch.bool, device=dev)
        n_sampled = torch.zeros((B, P), dtype=i32, device=dev)
    passed = params["is_asp"][:, None] | torch.where(
        params["full_view"][:, None], pass_fv, pass_sm)
    ctrl = torch.where(cand, n_sampled * params["dist_hops"][:, None],
                       torch.zeros_like(n_sampled)).sum(dim=1, dtype=i32)

    # 3. starts / re-polls, anchored at continuous ready times
    start = cand & passed
    t0 = torch.where(blocked & params["full_view"][:, None],
                     torch.maximum(row_unblock[:, None], ready), ready)
    dur = barrier_kernel.step_duration(rand["dur"], params["compute_time"])
    event_time = torch.where(start, t0 + dur, event_time)
    computing = computing | start
    fail = cand & ~passed
    blocked = (blocked | fail) & ~start
    sm_fail = fail & params["sampled"][:, None]
    ready = torch.where(sm_fail, ready + poll, ready)
    event_time = torch.where(sm_fail, ready, event_time)

    # 3b. adaptive-policy updates from this tick's observations
    if adaptive:
        gap = barrier_kernel.progress_gap(steps, alive)
        pol_thr = torch.where(
            params["is_dssp"] & active,
            torch.minimum(torch.maximum(gap, params["pol_lo"]),
                          params["staleness"]),
            state["pol_thr"]).to(i32)
        pol_beta = torch.where(
            params["is_anneal"] & active,
            torch.minimum(torch.maximum(
                params["beta_lo"] + gap - params["staleness"],
                params["beta_lo"]), params["beta_clip"]),
            state["pol_beta"]).to(i32)
        al = params["ebsp_alpha"][:, None]
        pol_ema = torch.where(params["is_ebsp"][:, None] & start,
                              (1.0 - al) * state["pol_ema"] + al * dur,
                              state["pol_ema"])

    # 4. data plane in fixed-width row blocks (pad rows are zero)
    X, mbn = rand["X"], rand["mb"]
    w, pulled = state["w"], state["pulled"]
    diff = pulled - params["w_true"][:, None, :]
    W = DATA_PLANE_BLOCK
    Bp = -(-B // W) * W

    def pad(a):
        return _pad_rows(a, Bp)

    d_p, f_p, s_p = pad(diff), pad(fin), pad(start)
    w_p, pu_p = pad(w), pad(pulled)
    lr_p, ns_p = pad(params["lr"]), pad(params["noise_std"])
    blocks = [_data_plane_block(X, d_p[i:i + W], f_p[i:i + W],
                                s_p[i:i + W], w_p[i:i + W], pu_p[i:i + W],
                                lr_p[i:i + W], ns_p[i:i + W], mbn)
              for i in range(0, Bp, W)]
    w = torch.cat([b[0] for b in blocks])[:B]
    pulled = torch.cat([b[1] for b in blocks])[:B]

    new_state = {"steps": steps, "alive": alive, "computing": computing,
                 "event_time": event_time, "ready": ready,
                 "blocked": blocked, "pend_leave": pend_leave,
                 "pend_join": pend_join, "w": w, "pulled": pulled}
    if adaptive:
        new_state.update(pol_thr=pol_thr, pol_ema=pol_ema,
                         pol_beta=pol_beta)
    out = {"fin": fin, "start": start, "n_fin": fin.sum(dim=1, dtype=i32),
           "ctrl": ctrl}
    return new_state, out


# --------------------------------------------------------------------------- #
# node-sharded plain version (collectives over the sweep mesh's nodes axis)
# --------------------------------------------------------------------------- #
def _arg_first_max(s: torch.Tensor, gids: torch.Tensor, sentinel: int,
                   axis) -> torch.Tensor:
    """Global index of each row's first maximum, across node shards.

    ``s`` (B, P_loc) holds sentinel-masked scores (dead slots −1.0),
    ``gids`` the shard's global node ids.  Exactly the first argmax over
    the whole row: the maximum is an exact float32 ``pmax`` and the
    tie-break takes the lowest global index, so the result does not
    depend on how the nodes are split.
    """
    m = collectives.pmax(s.amax(dim=1), axis)
    i_loc = torch.where(s == m[:, None], gids[None, :],
                        torch.full_like(gids, sentinel)[None, :]).amin(dim=1)
    return collectives.pmin(i_loc, axis)


def psp_tick_sharded(state: Tensors, rand: Tensors, params: Dict,
                     t: float, leave_n: torch.Tensor, join_n: torch.Tensor,
                     *, k_max: int, has_churn: bool, masked: bool,
                     adaptive: bool = False, node_axis=None,
                     ) -> Tuple[Tensors, Tensors]:
    """One tick on node-sharded state: :func:`psp_tick_ref` with the
    cross-node reductions as collectives over ``node_axis`` (a
    :class:`~repro_torch.parallel.collectives.Axis`; None is one shard).

    Every node-dimensioned operand arrives sliced to this rank's
    contiguous ``P_loc = P / nodes`` node block: the state (``steps`` …
    ``pulled``, ``pol_ema``), the per-node noise (``dur``, the score
    rows of its deciding nodes, the churn uniforms, ``X``/``mb``/``u1``)
    and the per-node params (``compute_time``, ``valid_slot``).

    Every output equals :func:`psp_tick_ref`'s for any nodes-axis size,
    because each cross-node reduction is one of

    * an exact collective whose result does not depend on the order:
      ``pmin``/``pmax`` of step counters and event times, integer
      ``psum`` counts, the first-argmax churn choice
      (:func:`_arg_first_max`);
    * a selection over gathered full-width ``steps``/``alive`` (the
      β-sample's peers), with the shard's own score rows;
    * the data-plane contraction on gathered full-width operands at the
      reference's shapes (the one float32 reduction over P); the server
      model is per row, so every shard computes the same ``w`` and pulls
      only its own views.

    The nodes axis must divide P exactly (the planner guarantees it).
    """
    from repro_torch.core.sampling import _k_smallest
    steps, alive = state["steps"], state["alive"]
    computing, blocked = state["computing"], state["blocked"]
    event_time, ready = state["event_time"], state["ready"]
    B, Pl = steps.shape
    dev, f32, i32 = steps.device, torch.float32, torch.int32
    t = torch.tensor(float(t), dtype=f32, device=dev)
    eps = torch.tensor(float(params["eps"]), dtype=f32, device=dev)
    poll = torch.tensor(float(params["poll"]), dtype=f32, device=dev)
    due = t + eps
    gids = (collectives.axis_index(node_axis) * Pl
            + torch.arange(Pl, device=dev))
    active = t <= params["horizon"] + eps

    def nsum(x):
        return collectives.psum(x.sum(dim=1, dtype=i32), node_axis)

    def gather(x, dim=1):
        return collectives.all_gather(x, node_axis, dim)

    # 0. churn, with the row reductions (alive count, victim / joiner
    #    argmax, freshest step) collective
    if has_churn:
        pend_l = state["pend_leave"] + leave_n
        pend_j = state["pend_join"] + join_n
        do_l = active & (pend_l > 0) & (nsum(alive) > 2)
        neg = torch.full_like(rand["leave"], -1.0)
        victim = _arg_first_max(torch.where(alive, rand["leave"], neg),
                                gids, _I32_MAX, node_axis)
        alive = alive & ~(do_l[:, None] & (victim[:, None] == gids))
        pool = ~alive & params["valid_slot"]
        do_j = active & (pend_j > 0) & (nsum(pool) > 0)
        joiner = _arg_first_max(torch.where(pool, rand["join"], neg),
                                gids, _I32_MAX, node_axis)
        sel = do_j[:, None] & (joiner[:, None] == gids)
        alive = alive | sel
        fresh = collectives.pmax(torch.where(
            alive, steps, torch.full_like(steps, _I32_MIN)).amax(dim=1),
            node_axis)
        steps = torch.where(sel, fresh[:, None], steps)
        computing = computing & ~sel
        event_time = torch.where(sel, t, event_time)
        ready = torch.where(sel, t, ready)
        blocked = blocked & ~sel
        pend_leave = torch.where(active, pend_l - (pend_l > 0).to(i32),
                                 state["pend_leave"])
        pend_join = torch.where(active, pend_j - (pend_j > 0).to(i32),
                                state["pend_join"])
    else:
        pend_leave, pend_join = state["pend_leave"], state["pend_join"]

    # 1. finishes (elementwise; row_last is an exact float32 max)
    fin = computing & alive & (event_time <= due) & active[:, None]
    any_fin = nsum(fin) > 0
    row_last = collectives.pmax(torch.where(
        fin, event_time, torch.full_like(event_time, -torch.inf)).amax(1),
        node_axis)
    row_unblock = torch.where(any_fin, torch.minimum(row_last, t), t)
    steps = steps + fin.to(i32)
    computing = computing & ~fin
    ready = torch.where(fin, event_time, ready)
    blocked = blocked & ~fin

    # 2. barrier decisions: the full view's min is a pmin; the β-sample
    #    reads gathered steps / alive with the shard's own score rows
    cand = ~computing & alive & (event_time <= due) & active[:, None]
    steps_full = gather(steps)
    P = steps_full.shape[1]
    piota = torch.arange(P, device=dev)
    stal = torch.broadcast_to(params["staleness"][:, None], (B, Pl))
    beta_eff = params["beta_clip"][:, None]
    if adaptive:
        live = torch.where(alive, state["pol_ema"],
                           torch.zeros_like(state["pol_ema"]))
        mx = collectives.pmax(live.amax(dim=1), node_axis)
        frac = 1.0 - state["pol_ema"] / torch.clamp_min(mx[:, None], 1e-9)
        slack = torch.floor(params["ebsp_range"][:, None] * frac).to(i32)
        stal = torch.where(params["is_dssp"][:, None],
                           state["pol_thr"][:, None],
                           torch.where(params["is_ebsp"][:, None], slack,
                                       stal))
        beta_eff = torch.where(params["is_anneal"], state["pol_beta"],
                               params["beta_clip"])[:, None]
    min_alive = collectives.pmin(torch.where(
        alive, steps, torch.full_like(steps, _I32_MAX)).amin(dim=1),
        node_axis)
    pass_fv = steps - min_alive[:, None] <= stal
    if k_max > 0:
        if masked:
            # per deciding node, the k smallest scores over the whole
            # gathered peer width
            alive_full = gather(alive)
            off = (~alive_full[:, None, :]
                   | (gids[None, :, None] == piota[None, None, :]))
            sc = torch.where(off, torch.full_like(rand["scores"], 2.0),
                             rand["scores"])                 # (B, Pl, P)
            vals, take = _k_smallest(sc, k_max)
            valid = vals < 1.5
            peer = torch.gather(
                torch.broadcast_to(steps_full[:, None, :], (B, Pl, P)),
                2, take)
        elif k_max == 1:
            # one uniform per deciding node, over its P − 1 peers
            draw = torch.floor(rand["u1"] * max(P - 1, 1)).to(i32)
            take = torch.clamp_max(draw + (draw >= gids).to(i32), P - 1)
            peer = steps_full[:, take.long()][:, :, None]
            valid = torch.broadcast_to(
                torch.arange(1, device=dev) < P - 1, peer.shape)
        else:
            # shared scores: the shard's deciding nodes' rows
            sc = torch.where(gids[:, None] == piota[None, :],
                             torch.full_like(rand["scores"], 2.0),
                             rand["scores"])                 # (Pl, P)
            _, take = _k_smallest(sc, k_max)
            peer = steps_full[:, take]                       # (B, Pl, k)
            valid = torch.broadcast_to(
                torch.arange(k_max, device=dev) < P - 1, peer.shape)
        slot = torch.arange(peer.shape[-1], device=dev)
        valid = valid & (slot < beta_eff[..., None])
        lag_ok = steps[..., None] - peer <= stal[..., None]
        pass_sm = torch.all(lag_ok | ~valid, dim=-1)
        n_sampled = valid.sum(dim=-1, dtype=i32)
    else:
        pass_sm = torch.ones((B, Pl), dtype=torch.bool, device=dev)
        n_sampled = torch.zeros((B, Pl), dtype=i32, device=dev)
    passed = params["is_asp"][:, None] | torch.where(
        params["full_view"][:, None], pass_fv, pass_sm)
    ctrl = collectives.psum(torch.where(
        cand, n_sampled * params["dist_hops"][:, None],
        torch.zeros_like(n_sampled)).sum(dim=1, dtype=i32), node_axis)

    # 3. starts / re-polls (elementwise given the row's row_unblock)
    start = cand & passed
    t0 = torch.where(blocked & params["full_view"][:, None],
                     torch.maximum(row_unblock[:, None], ready), ready)
    dur = barrier_kernel.step_duration(rand["dur"], params["compute_time"])
    event_time = torch.where(start, t0 + dur, event_time)
    computing = computing | start
    fail = cand & ~passed
    blocked = (blocked | fail) & ~start
    sm_fail = fail & params["sampled"][:, None]
    ready = torch.where(sm_fail, ready + poll, ready)
    event_time = torch.where(sm_fail, ready, event_time)

    # 3b. adaptive-policy updates: the progress gap from exact collectives
    if adaptive:
        mxs = collectives.pmax(torch.where(
            alive, steps, torch.full_like(steps, _I32_MIN)).amax(dim=1),
            node_axis)
        mns = collectives.pmin(torch.where(
            alive, steps, torch.full_like(steps, _I32_MAX)).amin(dim=1),
            node_axis)
        gap = torch.where(nsum(alive) > 0, mxs - mns,
                          torch.zeros_like(mxs))
        pol_thr = torch.where(
            params["is_dssp"] & active,
            torch.minimum(torch.maximum(gap, params["pol_lo"]),
                          params["staleness"]),
            state["pol_thr"]).to(i32)
        pol_beta = torch.where(
            params["is_anneal"] & active,
            torch.minimum(torch.maximum(
                params["beta_lo"] + gap - params["staleness"],
                params["beta_lo"]), params["beta_clip"]),
            state["pol_beta"]).to(i32)
        al = params["ebsp_alpha"][:, None]
        pol_ema = torch.where(params["is_ebsp"][:, None] & start,
                              (1.0 - al) * state["pol_ema"] + al * dur,
                              state["pol_ema"])

    # 4. data plane: the contraction on gathered full-width operands at
    #    the reference's shapes (a node-sliced partial sum would change
    #    the reduction order); each shard pulls its own views
    X = gather(rand["X"], 0)                     # (P, m, d)
    mbn = gather(rand["mb"], 0)                  # (P, m)
    fin_full = gather(fin)
    diff = gather(state["pulled"]) - params["w_true"][:, None, :]
    W = DATA_PLANE_BLOCK
    Bp = -(-B // W) * W
    d_p, f_p = _pad_rows(diff, Bp), _pad_rows(fin_full, Bp)
    w_p = _pad_rows(state["w"], Bp)
    lr_p = _pad_rows(params["lr"], Bp)
    ns_p = _pad_rows(params["noise_std"], Bp)
    w = torch.cat([_push_block(X, d_p[i:i + W], f_p[i:i + W], w_p[i:i + W],
                               lr_p[i:i + W], ns_p[i:i + W], mbn)
                   for i in range(0, Bp, W)])[:B]
    pulled = torch.where(start[..., None], w[:, None, :], state["pulled"])

    new_state = {"steps": steps, "alive": alive, "computing": computing,
                 "event_time": event_time, "ready": ready,
                 "blocked": blocked, "pend_leave": pend_leave,
                 "pend_join": pend_join, "w": w, "pulled": pulled}
    if adaptive:
        new_state.update(pol_thr=pol_thr, pol_ema=pol_ema,
                         pol_beta=pol_beta)
    out = {"fin": fin, "start": start, "n_fin": nsum(fin), "ctrl": ctrl}
    return new_state, out


# --------------------------------------------------------------------------- #
# Bytes a tick must move
# --------------------------------------------------------------------------- #
def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def tick_bytes(state: Tensors, rand: Tensors, params: Dict,
               fin: torch.Tensor, start: torch.Tensor, *,
               in_place: bool) -> Tuple[int, int]:
    """(read, written) bytes one tick must move on these inputs: each
    input read once, each output written once, counting what this tick's
    data needs (the least any implementation could move).

    Both contracts read every tensor of ``state``/``rand``/``params``
    once, plus ``leave_n``/``join_n``, except the node views and the
    minibatch: ``X``/``mb`` only for nodes that some row pushed.

    * ``in_place=True`` — :func:`psp_tick_cuda`'s contract: a view is
      read only if its node finished and written only if it started; the
      outputs are the (B, P) and (B,) arrays, ``w``, and the scratch the
      data plane needs (a residual of ``m`` floats per finisher).
    * ``in_place=False`` — a tick that returns its views as a new tensor
      (as :func:`psp_tick_ref` does): a view is read if its node finished
      (its residual) or keeps its view (a non-starter, copied to the
      output), and every output is written whole, all ``B·P·d`` views
      included.
    """
    B, P, d = state["pulled"].shape
    m = rand["X"].shape[1]
    n_fin = int(fin.sum())
    pushed = int(fin.any(0).sum())
    views = n_fin if in_place else int((fin | ~start).sum())
    need = {"pulled": 4 * views * d, "X": 4 * pushed * m * d,
            "mb": 4 * pushed * m}
    read = sum(need[k] if k in need else _nbytes(v)
               for group in (state, rand, params) for k, v in group.items()
               if isinstance(v, torch.Tensor)) + 2 * 4 * B
    out = 2 * B * P + 2 * 4 * B           # fin, start; n_fin, ctrl
    if in_place:
        written = (sum(_nbytes(v) for k, v in state.items() if k != "pulled")
                   + 4 * int(start.sum()) * d + out + 4 * n_fin * m)
    else:
        written = sum(_nbytes(v) for v in state.values()) + out
    return read, written


# --------------------------------------------------------------------------- #
# CUDA kernel wrapper
# --------------------------------------------------------------------------- #
_LAUNCHES = 0

#: residual rows per node the kernel holds in registers (``m`` ≤ this)
MAX_M = 16


def launch_count() -> int:
    """Ticks launched through :func:`psp_tick_cuda` since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    """Set the launch count of :func:`psp_tick_cuda` to 0."""
    global _LAUNCHES
    _LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/psp_tick.cu``'s library, its entry points declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("psp_tick")
    lib.psp_tick_launch.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_void_p]
    lib.psp_tick_launch.restype = ctypes.c_int
    lib.psp_tick_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.psp_tick_scratch_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_bytes(B: int, P: int, d: int, m: int) -> int:
    return int(_lib().psp_tick_scratch_bytes(B, P, d, m))


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"psp_tick_cuda: {what} must be a CUDA tensor")


def _check(name: str, x, shape: Tuple[int, ...], dtype: torch.dtype,
           dev: torch.device) -> int:
    """``x``'s data pointer; raises unless ``x`` is a contiguous tensor of
    ``shape`` and ``dtype`` on ``dev``."""
    if (type(x) is torch.Tensor and x.dtype is dtype and x.shape == shape
            and x.is_contiguous() and x.device == dev):
        return x.data_ptr()
    if not isinstance(x, torch.Tensor) or x.device.type != dev.type:
        raise ValueError(f"psp_tick_cuda: {name} must be a CUDA tensor")
    if x.device != dev:
        raise ValueError(f"psp_tick_cuda: {name} is on {x.device}, "
                         f"state on {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"psp_tick_cuda: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != dtype:
        raise ValueError(f"psp_tick_cuda: {name} has dtype {x.dtype}, "
                         f"expected {dtype}")
    raise ValueError(f"psp_tick_cuda: {name} must be contiguous")


_B, _BP, _BD = "B", "BP", "Bd"
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool

#: the per-batch params in the C entry point's operand order (the
#: source's ``enum Slot``, ``CT_`` to ``HORIZON``): shape and dtype
_PARAM_SPEC = (
    ("compute_time", _BP, _F32), ("valid_slot", _BP, _BOOL),
    ("staleness", _B, _I32), ("beta_clip", _B, _I32),
    ("is_asp", _B, _BOOL), ("full_view", _B, _BOOL),
    ("sampled", _B, _BOOL), ("dist_hops", _B, _I32),
    ("is_dssp", _B, _BOOL), ("is_ebsp", _B, _BOOL),
    ("is_anneal", _B, _BOOL), ("pol_lo", _B, _I32),
    ("beta_lo", _B, _I32), ("ebsp_range", _B, _F32),
    ("ebsp_alpha", _B, _F32), ("w_true", _BD, _F32), ("lr", _B, _F32),
    ("noise_std", _B, _F32), ("horizon", _B, _F32))
_ADAPTIVE_PARAMS = frozenset({"is_dssp", "is_ebsp", "is_anneal", "pol_lo",
                              "beta_lo", "ebsp_range", "ebsp_alpha"})


class TickParams(dict):
    """A batch's params, checked and staged for :func:`psp_tick_cuda`.

    The same mapping as the plain dict (so :func:`psp_tick_ref` takes it
    too), plus the data pointers of the per-row tensors in the C entry
    point's order and the host floats ``eps`` and ``poll``; ``key`` =
    (B, P, d, adaptive, device) is what it was staged for.  It holds
    its tensors, so the pointers stay valid while it lives.
    """
    key: tuple
    ptrs: Tuple[Optional[int], ...]
    eps: float
    poll: float


def stage_params(params: Dict, *, adaptive: bool) -> TickParams:
    """Check a batch's params once and stage them for the kernel: every
    tick of the batch then passes the returned :class:`TickParams`
    (:func:`repro_torch.core.vector_sim_torch.run_batch` does)."""
    B, d = params["w_true"].shape
    P = params["compute_time"].shape[-1]
    dev = params["w_true"].device
    _require_cuda(dev, "w_true")
    shapes = {_B: (B,), _BP: (B, P), _BD: (B, d)}
    ptrs = []
    for key, kind, dtype in _PARAM_SPEC:
        if key in _ADAPTIVE_PARAMS and not adaptive:
            ptrs.append(None)
        else:
            ptrs.append(_check(key, params[key], shapes[kind], dtype, dev))
    staged = TickParams(params)
    staged.key = (B, P, d, adaptive, dev)
    staged.ptrs = tuple(ptrs)
    staged.eps = float(params["eps"])
    staged.poll = float(params["poll"])
    return staged


#: the C entry point's argument arrays: operand pointers (per-tick
#: operands, params, outputs, scratch), dims and host floats
_PTRS = ctypes.c_void_p * (21 + len(_PARAM_SPEC) + 16)
_INTS = ctypes.c_int * 9
_FLOATS = ctypes.c_float * 3

#: outputs of the C entry point in its operand order (``O_STEPS`` to
#: ``O_BETA``); the scratch buffer follows
_OUT_KEYS = ("steps", "alive", "computing", "event_time", "ready", "blocked",
             "pend_leave", "pend_join", "fin", "start", "n_fin", "ctrl",
             "pol_thr", "pol_ema", "pol_beta")


def psp_tick_cuda(state: Tensors, rand: Tensors, params: Dict, t: float,
                  leave_n: torch.Tensor, join_n: torch.Tensor, *,
                  k_max: int, has_churn: bool, masked: bool,
                  adaptive: bool = False) -> Tuple[Tensors, Tensors]:
    """The hand-written CUDA tick: same function as :func:`psp_tick_ref`,
    with ``w`` and ``pulled`` updated in place.

    Checks device, dtype, shape and contiguity of every per-tick operand
    (``params`` once per batch, when a :class:`TickParams` staged for
    these dims is passed; a plain dict is staged on every call),
    allocates the outputs with ``torch.empty``, launches the kernel's
    five passes on the current stream and raises if a launch failed.
    Booleans are ``torch.bool``; ``t``, ``eps`` and ``poll`` are host
    floats.

    It writes ``state["w"]`` and ``state["pulled"]``: the returned ``w``
    and ``pulled`` are those tensors, updated in place.  Every other
    input stays as it was.  A caller that needs the old model or views
    clones them first.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    steps = state["steps"]
    dev = steps.device
    _require_cuda(dev, "steps")
    B, P = steps.shape
    d = state["w"].shape[-1]
    m = rand["X"].shape[1]
    if m > MAX_M:
        raise ValueError(f"psp_tick_cuda: minibatch {m} > {MAX_M}")
    if not (isinstance(params, TickParams)
            and params.key == (B, P, d, adaptive, dev)):
        params = stage_params(params, adaptive=adaptive)
    w, pulled = state["w"], state["pulled"]
    bp, b1 = (B, P), (B,)
    ptrs = [_check("steps", steps, bp, _I32, dev),
            _check("alive", state["alive"], bp, _BOOL, dev),
            _check("computing", state["computing"], bp, _BOOL, dev),
            _check("event_time", state["event_time"], bp, _F32, dev),
            _check("ready", state["ready"], bp, _F32, dev),
            _check("blocked", state["blocked"], bp, _BOOL, dev),
            _check("pend_leave", state["pend_leave"], b1, _I32, dev),
            _check("pend_join", state["pend_join"], b1, _I32, dev),
            _check("w", w, (B, d), _F32, dev),
            _check("pulled", pulled, (B, P, d), _F32, dev)]
    if adaptive:
        ptrs += [_check("pol_thr", state["pol_thr"], b1, _I32, dev),
                 _check("pol_beta", state["pol_beta"], b1, _I32, dev),
                 _check("pol_ema", state["pol_ema"], bp, _F32, dev)]
    else:
        ptrs += [None, None, None]
    ptrs += [_check("leave_n", leave_n, b1, _I32, dev),
             _check("join_n", join_n, b1, _I32, dev),
             _check("dur", rand["dur"], bp, _F32, dev)]
    if k_max == 0:
        ptrs.append(None)
    elif k_max == 1 and not masked:
        ptrs.append(_check("u1", rand["u1"], (P,), _F32, dev))
    else:
        ptrs.append(_check("scores", rand["scores"],
                           (B, P, P) if masked else (P, P), _F32, dev))
    if has_churn:
        ptrs += [_check("leave", rand["leave"], bp, _F32, dev),
                 _check("join", rand["join"], bp, _F32, dev)]
    else:
        ptrs += [None, None]
    ptrs += [_check("X", rand["X"], (P, m, d), _F32, dev),
             _check("mb", rand["mb"], (P, m), _F32, dev)]
    ptrs += params.ptrs

    # the outputs, one allocation per dtype and shape
    nf = 3 if adaptive else 2
    out = dict(zip(("alive", "computing", "blocked", "fin", "start"),
                   torch.empty((5, B, P), dtype=_BOOL, device=dev).unbind()))
    out.update(zip(("event_time", "ready", "pol_ema")[:nf],
                   torch.empty((nf, B, P), dtype=_F32, device=dev).unbind()))
    out.update(zip(("pend_leave", "pend_join", "n_fin", "ctrl", "pol_thr",
                    "pol_beta"),
                   torch.empty((6, B), dtype=_I32, device=dev).unbind()))
    out["steps"] = torch.empty((B, P), dtype=_I32, device=dev)
    scratch = torch.empty(_scratch_bytes(B, P, d, m), dtype=torch.uint8,
                          device=dev)
    if not adaptive:
        out["pol_thr"] = out["pol_beta"] = None
    ptrs += [None if out.get(k) is None else out[k].data_ptr()
             for k in _OUT_KEYS]
    ptrs.append(scratch.data_ptr())

    ints = _INTS(B, P, d, m, k_max, int(has_churn), int(masked),
                 int(adaptive), dev.index or 0)
    floats = _FLOATS(float(t), params.eps, params.poll)
    lib = _lib()
    err = lib.psp_tick_launch(_PTRS(*ptrs), ints, floats,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"psp_tick_cuda: launch failed: "
                           f"{_build.error_string(lib, err)}")
    _LAUNCHES += 1

    new_state = {k: out[k] for k in STATE_KEYS if k in out}
    new_state.update(w=w, pulled=pulled)
    if adaptive:
        new_state.update(pol_thr=out["pol_thr"], pol_ema=out["pol_ema"],
                         pol_beta=out["pol_beta"])
    return new_state, {k: out[k] for k in ("fin", "start", "n_fin", "ctrl")}

