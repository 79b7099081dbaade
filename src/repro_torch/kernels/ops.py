"""Dispatch of the port's kernels between CUDA and their plain versions.

``impl="auto"`` sends CUDA tensors to the kernel and CPU tensors to the
plain PyTorch version; ``"cuda"`` and ``"ref"`` force a path (``ref`` is
how a run holds a kernel against its plain version on the card).  A
CUDA tensor never reaches the plain version unless ``ref`` asks for it,
and ``cuda`` on CPU tensors raises in the wrapper's checks.

* :func:`psp_tick` — the fused PSP sweep tick
  (:mod:`repro_torch.kernels.psp_tick`);
* :func:`attention` — forward attention, grouped-query layout
  (:mod:`repro_torch.kernels.flash_attention`);
* :func:`rmsnorm` — RMSNorm over the trailing axis in either of its two
  forms: ``round_scale=False`` the TPU kernel's (one rounding),
  ``round_scale=True`` the reference model's (in bfloat16 the scale is
  rounded before the product) (:mod:`repro_torch.kernels.rmsnorm`);
* :func:`ssd` — the Mamba-2 chunked SSD scan, with its final state
  (:mod:`repro_torch.kernels.ssd_scan`);
* :func:`rglru_scan` — the RG-LRU recurrence of a recurrentgemma block,
  its gate fused, with its last state
  (:mod:`repro_torch.kernels.rglru_scan`).

:func:`attention`, :func:`rmsnorm` (its ``round_scale=True`` form),
:func:`ssd` and :func:`rglru_scan` are differentiable: when autograd
records (grad enabled and an input requires grad) they run as a
``torch.autograd.Function`` whose forward is the kernel or plain version
above (the attention forward then also returns the row log-sum-exp,
RMSNorm's each row's m, the SSD scan cum and each chunk's entering
state, the RG-LRU kernel the h entering each 64-step tile) and whose
backward is the backward kernel (``flash_attention_bwd_cuda``,
``rmsnorm_bwd_cuda``, ``ssd_bwd_cuda``, ``rglru_scan_bwd_cuda``) or its
plain version, chosen by the same rule.  Otherwise (serving) they are
the forward alone, as before.  ``round_scale=False`` has no backward.

Under a :class:`~repro_torch.roofline.dispatch_cost.DispatchCost` each
of them (and each backward) charges its kernel's formula
(:mod:`repro_torch.roofline.kernel_cost`) and nothing of what runs
inside, kernel or plain version alike.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.psp_tick import (NODE_PARAM_KEYS, NODE_STATE_KEYS,
                                          psp_tick_cuda, psp_tick_ref,
                                          psp_tick_sharded, tick_bytes)
from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_cuda,
                                            rglru_scan_bwd_ref,
                                            rglru_scan_cuda, rglru_scan_ref)
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_ref,
                                         rmsnorm_cuda, rmsnorm_ref)
from repro_torch.kernels.ssd_scan import (ssd_bwd_cuda, ssd_bwd_ref,
                                          ssd_cuda, ssd_ref)
from repro_torch.parallel import collectives
from repro_torch.roofline import kernel_cost as kc
from repro_torch.roofline.dispatch_cost import kernel_region

__all__ = ["IMPLS", "attention", "gather_node_params", "psp_tick",
           "rglru_scan", "rmsnorm", "ssd", "use_kernel"]

IMPLS = ("auto", "cuda", "ref")


def use_kernel(impl: str, device) -> bool:
    """Whether ``impl`` on tensors of ``device`` runs the CUDA kernel.

    An unknown ``impl`` (e.g. a mistyped ``PSP_TICK_IMPL``) raises
    instead of silently running the plain version.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from "
                         + "|".join(IMPLS))
    if impl == "auto":
        return getattr(device, "type", str(device)) == "cuda"
    return impl == "cuda"


def gather_node_params(params, node_axis):
    """``params`` with its node-dimensioned entries gathered to full
    width over ``node_axis`` (what the gathered kernel path takes; a
    sweep gathers them once and stages the result)."""
    out = dict(params)
    for k in NODE_PARAM_KEYS:
        out[k] = collectives.all_gather(params[k], node_axis, 1)
    return out


def _psp_tick_gathered(state, rand, params, t, leave_n, join_n, *,
                       k_max: int, has_churn: bool, masked: bool,
                       adaptive: bool, node_axis):
    """The kernel path under a node-sharded mesh: gather → full tick →
    slice.

    The CUDA tick has no collective form, so each node shard gathers
    the node state to full width, runs
    :func:`~repro_torch.kernels.psp_tick.psp_tick_cuda` unchanged on it
    (the same operand shapes as the unsharded call, so the same bits)
    and keeps its own node slice of the outputs.  ``rand`` and
    ``params`` come at full width: every rank draws every node's noise
    (the sweep takes only its rows of it) and the sweep gathers the node
    params once (:func:`gather_node_params`).  ``w`` (per row) and the
    gathered ``pulled`` are updated in place; the returned ``pulled`` is
    this shard's slice of the gathered one.
    """
    Pl = state["steps"].shape[1]
    st = {k: (collectives.all_gather(v, node_axis, 1)
              if k in NODE_STATE_KEYS else v) for k, v in state.items()}
    P = st["steps"].shape[1]
    if rand["dur"].shape[1] != P or params["compute_time"].shape[1] != P:
        raise ValueError("the gathered kernel tick takes the noise and the "
                         f"node params at the full width {P}")
    new, out = _charged_tick(psp_tick_cuda, st, rand, params, t, leave_n,
                             join_n, k_max=k_max, has_churn=has_churn,
                             masked=masked, adaptive=adaptive)
    off = collectives.axis_index(node_axis) * Pl
    for k in NODE_STATE_KEYS:
        if k in new:
            new[k] = new[k][:, off:off + Pl]
    return new, {**out, "fin": out["fin"][:, off:off + Pl],
                 "start": out["start"][:, off:off + Pl]}


def _charged_tick(fn, state, rand, params, t, leave_n, join_n, **kw):
    """``fn``'s tick inside the cost region: under a
    :class:`~repro_torch.roofline.dispatch_cost.DispatchCost` it charges
    the tick's formula on these (full-width) operands."""
    with kernel_region("psp_tick") as cost:
        if cost is not None:        # the count depends on the tick's data
            n_cand = int(((~state["computing"])
                          & params["sampled"][:, None]).sum())
        new, out = fn(state, rand, params, t, leave_n, join_n, **kw)
        if cost is not None:
            P = state["steps"].shape[1]
            m, d = rand["X"].shape[1], rand["X"].shape[2]
            cost.charge("psp_tick", kc.tick_flops(
                int(out["fin"].sum()), n_cand, m, d, P, k_max=kw["k_max"],
                masked=kw["masked"]), sum(tick_bytes(
                    state, rand, params, out["fin"], out["start"],
                    in_place=True)))
    return new, out


def psp_tick(state, rand, params, t, leave_n, join_n, *, k_max: int,
             has_churn: bool, masked: bool, adaptive: bool = False,
             impl: str = "auto", node_axis=None):
    """One fused PSP sweep-grid tick (see :mod:`repro_torch.kernels.psp_tick`).

    Both paths consume the same pre-drawn noise in ``rand``, so a sweep's
    noise stream is independent of ``impl``.  The kernel updates
    ``state["w"]`` and ``state["pulled"]`` in place; the plain version
    never writes its inputs.

    ``node_axis`` (a :class:`~repro_torch.parallel.collectives.Axis`)
    names the sweep mesh's nodes axis when the caller holds node-sliced
    ``(B, P_loc)`` state: the plain path is then
    :func:`~repro_torch.kernels.psp_tick.psp_tick_sharded` (on the
    shard's noise and params) and the kernel path gathers the state to
    full width, ticks and slices back (:func:`_psp_tick_gathered`, on
    full-width noise and params); both equal the unsharded tick on
    unsharded state.
    """
    kw = dict(k_max=k_max, has_churn=has_churn, masked=masked,
              adaptive=adaptive)
    kernel = use_kernel(impl, state["steps"].device)
    if node_axis is not None:
        if kernel:
            return _psp_tick_gathered(state, rand, params, t, leave_n,
                                      join_n, node_axis=node_axis, **kw)
        return psp_tick_sharded(state, rand, params, t, leave_n, join_n,
                                node_axis=node_axis, **kw)
    return _charged_tick(psp_tick_cuda if kernel else psp_tick_ref, state,
                         rand, params, t, leave_n, join_n, **kw)


def _records(*xs: torch.Tensor) -> bool:
    """Whether autograd records an op on ``xs``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _Attention(torch.autograd.Function):
    """Attention with the flash backward (kernel or plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, kernel):
        kw = dict(causal=causal, window=window, softcap=softcap)
        fn = flash_attention_cuda if kernel else attention_ref
        o, lse = fn(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.kernel = kw, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        fn = flash_attention_bwd_cuda if ctx.kernel else attention_bwd_ref
        saved = ctx.saved_tensors
        with kernel_region("flash_attention_bwd", *_attention_cost(
                saved[0], saved[1], ctx.kw, backward=True)):
            dq, dk, dv = fn(*saved, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _attention_cost(q, k, kw, lse=False, backward=False):
    """(FLOPs, bytes) of one attention call on q (B, S, H, hd), k (B, S,
    KV, hd) under ``kw``'s mask."""
    B, S, H, hd = q.shape
    return (kc.attention_flops(B, S, H, hd, causal=kw["causal"],
                               window=kw["window"], backward=backward),
            kc.attention_bytes(B, S, H, k.shape[2], hd, q.element_size(),
                               lse=lse, backward=backward))


class _RMSNorm(torch.autograd.Function):
    """The model's RMSNorm (``round_scale=True``) with the reference
    model's VJP (kernel or plain version); the forward keeps each row's
    m for it, as ``_rms_fwd`` does."""

    @staticmethod
    def forward(ctx, x, w, eps, kernel):
        fn = rmsnorm_cuda if kernel else rmsnorm_ref
        y, m = fn(x, w, eps, True, return_m=True)
        ctx.save_for_backward(x, w, m)
        ctx.kernel = kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, m = ctx.saved_tensors
        fn = rmsnorm_bwd_cuda if ctx.kernel else rmsnorm_bwd_ref
        with kernel_region("rmsnorm_bwd", 0, kc.rmsnorm_bytes(
                m.numel(), x.shape[-1], x.element_size(), backward=True)):
            dx, dw = fn(x, w, g, m)
        return dx, dw.to(w.dtype), None, None


class _SSD(torch.autograd.Function):
    """The chunked SSD scan with its VJP (kernel or plain version); the
    forward keeps cum and each chunk's entering state for it.  An unused
    output's cotangent arrives as None (h_final's, in training): the
    backward then takes it as zeros without making them."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, kernel):
        ctx.set_materialize_grads(False)
        fn = ssd_cuda if kernel else ssd_ref
        y, h, cum, st = fn(x, dt, A, Bm, Cm, chunk, return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, cum, st)
        ctx.chunk, ctx.kernel = chunk, kernel
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, cum, st = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        fn = ssd_bwd_cuda if ctx.kernel else ssd_bwd_ref
        B, S, nh, hd = x.shape
        ng, N = Bm.shape[2:]
        with kernel_region(
                "ssd_scan_bwd",
                kc.ssd_bwd_flops(B, S, nh, ng, hd, N, ctx.chunk),
                kc.ssd_bwd_bytes(B, S, nh, ng, hd, N, x.element_size(),
                                 False, ctx.chunk, dh is not None)):
            dx, ddt, dA, dB, dC = fn(x, dt, A, Bm, Cm, dy, cum, st, dh,
                                     ctx.chunk)
        return dx, ddt, dA.to(A.dtype), dB, dC, None, None


class _RGLRU(torch.autograd.Function):
    """The RG-LRU scan with its VJP (kernel or plain version); on the
    kernel the forward keeps the h entering each tile for the backward
    kernel.  An unused output's cotangent arrives as None (h_last's, in
    training): the backward then takes it as zeros without making
    them."""

    @staticmethod
    def forward(ctx, x, r_pre, i_pre, lam, h0, gate, kernel):
        ctx.set_materialize_grads(False)
        if kernel:
            y, h_last, states = rglru_scan_cuda(x, r_pre, i_pre, lam, h0,
                                                gate, return_states=True)
        else:
            y, h_last = rglru_scan_ref(x, r_pre, i_pre, lam, h0, gate)
            states = None
        ctx.save_for_backward(x, r_pre, i_pre, lam, h0, gate, states)
        ctx.kernel = kernel
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh):
        x, r_pre, i_pre, lam, h0, gate, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        with kernel_region("rglru_scan_bwd", 0, kc.rglru_bwd_bytes(
                *x.shape, x.element_size(), gate is not None,
                h0 is not None)):
            if ctx.kernel:
                dx, dr, di, dlam, dh0, dgate = rglru_scan_bwd_cuda(
                    x, r_pre, i_pre, lam, dy.contiguous(), states, h0,
                    gate, dh)
            else:
                dx, dr, di, dlam, dh0, dgate = rglru_scan_bwd_ref(
                    x, r_pre, i_pre, lam, dy, h0, gate, dh)
        return dx, dr, di, dlam.to(lam.dtype), dh0, dgate, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Attention: q ``(B, Sq, H, hd)``, k/v ``(B, Sk, KV, hd)`` →
    ``(B, Sq, H, hd)`` in q's dtype (see
    :mod:`repro_torch.kernels.flash_attention`); differentiable when
    autograd records."""
    kernel = use_kernel(impl, q.device)
    train = _records(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap)
    with kernel_region("flash_attention",
                       *_attention_cost(q, k, kw, lse=train)):
        if train:
            return _Attention.apply(q, k, v, causal, window, softcap,
                                    kernel)
        fn = flash_attention_cuda if kernel else attention_ref
        return fn(q, k, v, **kw)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            round_scale: bool = False, impl: str = "auto") -> torch.Tensor:
    """RMS-normalise the trailing axis of ``x`` with gain ``w``;
    ``round_scale`` picks the form (see
    :mod:`repro_torch.kernels.rmsnorm`); the ``round_scale=True`` form is
    differentiable when autograd records."""
    kernel = use_kernel(impl, x.device)
    train = _records(x, w)
    if train and not round_scale:
        raise NotImplementedError("rmsnorm(round_scale=False) has no "
                                  "backward (the reference model's VJP "
                                  "is the round_scale=True form's)")
    D = x.shape[-1]
    with kernel_region("rmsnorm", 0, kc.rmsnorm_bytes(
            x.numel() // max(D, 1), D, x.element_size(), w.element_size(),
            m=train)):
        if train:
            return _RMSNorm.apply(x, w, eps, kernel)
        fn = rmsnorm_cuda if kernel else rmsnorm_ref
        return fn(x, w, eps, round_scale)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: x ``(B, S, nh, hd)``, dt ``(B, S, nh)`` f32, A
    ``(nh,)`` f32, Bm/Cm ``(B, S, ng, N)`` → (y ``(B, S, nh, hd)`` in x's
    dtype, h_final ``(B, nh, hd, N)`` f32); raises unless
    ``S % min(chunk, S) == 0`` (see :mod:`repro_torch.kernels.ssd_scan`);
    differentiable when autograd records."""
    kernel = use_kernel(impl, x.device)
    train = _records(x, dt, A, Bm, Cm)
    B, S, nh, hd = x.shape
    ng, N = Bm.shape[2:]
    with kernel_region(
            "ssd_scan", kc.ssd_flops(B, S, nh, ng, hd, N, chunk),
            kc.ssd_bytes(B, S, nh, ng, hd, N, x.element_size(),
                         states=train, chunk=chunk)):
        if train:
            return _SSD.apply(x, dt, A, Bm, Cm, chunk, kernel)
        fn = ssd_cuda if kernel else ssd_ref
        return fn(x, dt, A, Bm, Cm, chunk)


def rglru_scan(x: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
               lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
               gate: Optional[torch.Tensor] = None, *,
               impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan: x, r_pre, i_pre (and gate) ``(B, S, W)`` in the
    compute dtype, Λ ``(W,)`` and h0 ``(B, W)`` float32 → (y ``(B, S,
    W)``, h_last ``(B, W)`` float32) (see
    :mod:`repro_torch.kernels.rglru_scan`); differentiable when autograd
    records."""
    kernel = use_kernel(impl, x.device)
    with kernel_region("rglru_scan", 0, kc.rglru_bytes(
            *x.shape, x.element_size(), gate is not None, h0 is not None)):
        if _records(*(t for t in (x, r_pre, i_pre, lam, h0, gate)
                      if t is not None)):
            return _RGLRU.apply(x, r_pre, i_pre, lam, h0, gate, kernel)
        fn = rglru_scan_cuda if kernel else rglru_scan_ref
        return fn(x, r_pre, i_pre, lam, h0, gate)
