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
  ``psp_tick_ref``; it runs on any device and is what CPU tensors get.
* :func:`psp_tick_cuda` — the hand-written CUDA tick
  (``kernels/csrc/psp_tick.cu``) in three launches: the whole control
  plane (one block per scenario row), the residual, and the gradient sum
  with the server update and the pull.

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
from typing import Dict, Tuple

import torch

from repro_torch.core import barrier_kernel

__all__ = ["DATA_PLANE_BLOCK", "POLICY_STATE_KEYS", "STATE_KEYS",
           "psp_tick_cuda", "psp_tick_ref", "launch_count",
           "reset_launch_count"]

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

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min

Tensors = Dict[str, torch.Tensor]


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
    m = X.shape[1]
    # a contraction, not the reference's broadcast-multiply: at the paper
    # shape the broadcast would hold W·P·m·d floats
    resid = (torch.einsum("kpd,pmd->kpm", diff, X)
             - noise_std[:, None, None] * mb[None])
    resid = torch.where(fin[:, :, None], resid, torch.zeros_like(resid))
    gsum = torch.einsum("kpm,pmd->kd", resid, X) / m
    w_new = w - lr[:, None] * gsum
    pulled_new = torch.where(start[..., None], w_new[:, None, :], pulled)
    return w_new, pulled_new


def psp_tick_ref(state: Tensors, rand: Tensors, params: Dict,
                 t: float, leave_n: torch.Tensor, join_n: torch.Tensor, *,
                 k_max: int, has_churn: bool, masked: bool,
                 adaptive: bool = False) -> Tuple[Tensors, Tensors]:
    """One full tick, batched over B scenario rows (plain PyTorch).

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
        if Bp == B:
            return a
        return torch.cat([a, a.new_zeros((Bp - B,) + a.shape[1:])])

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
    """``csrc/psp_tick.cu``'s library, its entry point declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("psp_tick")
    lib.psp_tick_launch.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_void_p]
    lib.psp_tick_launch.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, shape: Tuple[int, ...],
           dtypes: Tuple[torch.dtype, ...]) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of shape and dtype."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"psp_tick_cuda: {name} must be a CUDA tensor")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"psp_tick_cuda: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"psp_tick_cuda: {name} has dtype {x.dtype}, "
                         f"expected one of {dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"psp_tick_cuda: {name} must be contiguous")


# operand order of the C entry point ``psp_tick_launch`` (see the source's
# ``enum Ptr``); booleans travel as int32
_IN_KEYS = (
    ("state", "steps"), ("state", "alive"), ("state", "computing"),
    ("state", "event_time"), ("state", "ready"), ("state", "blocked"),
    ("state", "pend_leave"), ("state", "pend_join"), ("state", "w"),
    ("state", "pulled"), ("state", "pol_thr"), ("state", "pol_beta"),
    ("state", "pol_ema"),
    ("arg", "leave_n"), ("arg", "join_n"),
    ("rand", "dur"), ("rand", "samp"), ("rand", "leave"), ("rand", "join"),
    ("rand", "X"), ("rand", "mb"),
    ("params", "compute_time"), ("params", "valid_slot"),
    ("params", "staleness"), ("params", "beta_clip"), ("params", "is_asp"),
    ("params", "full_view"), ("params", "sampled"), ("params", "dist_hops"),
    ("params", "is_dssp"), ("params", "is_ebsp"), ("params", "is_anneal"),
    ("params", "pol_lo"), ("params", "beta_lo"), ("params", "ebsp_range"),
    ("params", "ebsp_alpha"), ("params", "w_true"), ("params", "lr"),
    ("params", "noise_std"), ("params", "horizon"),
)
_OUT_KEYS = ("steps", "alive", "computing", "event_time", "ready", "blocked",
             "pend_leave", "pend_join", "w", "pulled", "fin", "start",
             "n_fin", "ctrl", "pol_thr", "pol_ema", "pol_beta", "resid")
_BOOL_KEYS = frozenset({"alive", "computing", "blocked", "valid_slot",
                        "is_asp", "full_view", "sampled", "is_dssp",
                        "is_ebsp", "is_anneal"})


def psp_tick_cuda(state: Tensors, rand: Tensors, params: Dict, t: float,
                  leave_n: torch.Tensor, join_n: torch.Tensor, *,
                  k_max: int, has_churn: bool, masked: bool,
                  adaptive: bool = False) -> Tuple[Tensors, Tensors]:
    """The hand-written CUDA tick: same contract as :func:`psp_tick_ref`.

    Checks device, dtype, shape and contiguity of every operand, allocates
    the outputs with ``torch.empty``, launches the kernel's three passes
    on the current stream and raises if the launch failed.  Booleans
    travel as int32.  ``t``, ``eps`` and ``poll`` are host floats.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    B, P = state["steps"].shape
    d = state["w"].shape[-1]
    m = rand["X"].shape[1]
    if m > MAX_M:
        raise ValueError(f"psp_tick_cuda: minibatch {m} > {MAX_M}")
    dev = state["steps"].device
    i32, f32 = torch.int32, torch.float32
    use_u1 = k_max == 1 and not masked
    samp = None
    if k_max > 0:
        samp = rand["u1"] if use_u1 else rand["scores"]
        samp_shape = (P,) if use_u1 else ((B, P, P) if masked else (P, P))
    src = {"state": state, "rand": {**rand, "samp": samp}, "params": params,
           "arg": {"leave_n": leave_n, "join_n": join_n}}
    shapes = {"steps": (B, P), "alive": (B, P), "computing": (B, P),
              "event_time": (B, P), "ready": (B, P), "blocked": (B, P),
              "pend_leave": (B,), "pend_join": (B,), "w": (B, d),
              "pulled": (B, P, d), "pol_thr": (B,), "pol_beta": (B,),
              "pol_ema": (B, P), "leave_n": (B,), "join_n": (B,),
              "dur": (B, P), "leave": (B, P), "join": (B, P),
              "X": (P, m, d), "mb": (P, m), "compute_time": (B, P),
              "valid_slot": (B, P), "w_true": (B, d)}
    f32_keys = {"event_time", "ready", "w", "pulled", "pol_ema", "dur",
                "samp", "leave", "join", "X", "mb", "compute_time",
                "ebsp_range", "ebsp_alpha", "w_true", "lr", "noise_std",
                "horizon"}
    needed = set(k for _, k in _IN_KEYS)
    if not adaptive:
        needed -= {"pol_thr", "pol_beta", "pol_ema", "is_dssp", "is_ebsp",
                   "is_anneal", "pol_lo", "beta_lo", "ebsp_range",
                   "ebsp_alpha"}
    if not has_churn:
        needed -= {"leave", "join"}
    if k_max == 0:
        needed.discard("samp")
    keep = []                      # holds converted operands alive
    ptrs = []
    for group, key in _IN_KEYS:
        if key not in needed:
            ptrs.append(None)
            continue
        x = src[group][key]
        shape = samp_shape if key == "samp" else shapes.get(key, (B,))
        if key in f32_keys:
            _check(key, x, shape, (f32,))
        else:
            _check(key, x, shape,
                   (torch.bool, i32) if key in _BOOL_KEYS else (i32,))
            if x.dtype == torch.bool:
                x = x.to(i32)
        if x.device != dev:
            raise ValueError(f"psp_tick_cuda: {key} is on {x.device}, "
                             f"state on {dev}")
        keep.append(x)
        ptrs.append(x.data_ptr())

    def empty(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"steps": empty(B, P), "alive": empty(B, P),
           "computing": empty(B, P), "event_time": empty(B, P, dtype=f32),
           "ready": empty(B, P, dtype=f32), "blocked": empty(B, P),
           "pend_leave": empty(B), "pend_join": empty(B),
           "w": empty(B, d, dtype=f32), "pulled": empty(B, P, d, dtype=f32),
           "fin": empty(B, P), "start": empty(B, P), "n_fin": empty(B),
           "ctrl": empty(B), "resid": empty(B, P, m, dtype=f32)}
    if adaptive:
        out.update(pol_thr=empty(B), pol_ema=empty(B, P, dtype=f32),
                   pol_beta=empty(B))
    ptrs += [out[k].data_ptr() if k in out else None for k in _OUT_KEYS]

    ints = (ctypes.c_int * 9)(B, P, d, m, k_max, int(has_churn),
                              int(masked), int(adaptive), dev.index or 0)
    floats = (ctypes.c_float * 3)(float(t), float(params["eps"]),
                                  float(params["poll"]))
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    err = lib.psp_tick_launch(ptr_arr, ints, floats, stream)
    if err != 0:
        raise RuntimeError(f"psp_tick_cuda: launch failed: "
                           f"{_build.error_string(lib, err)}")
    _LAUNCHES += 1

    new_state = {"steps": out["steps"], "alive": out["alive"] != 0,
                 "computing": out["computing"] != 0,
                 "event_time": out["event_time"], "ready": out["ready"],
                 "blocked": out["blocked"] != 0,
                 "pend_leave": out["pend_leave"],
                 "pend_join": out["pend_join"], "w": out["w"],
                 "pulled": out["pulled"]}
    if adaptive:
        new_state.update(pol_thr=out["pol_thr"], pol_ema=out["pol_ema"],
                         pol_beta=out["pol_beta"])
    return new_state, {"fin": out["fin"] != 0, "start": out["start"] != 0,
                       "n_fin": out["n_fin"], "ctrl": out["ctrl"]}
