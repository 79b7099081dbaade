"""Training-step assembly: the port's counterpart of the training half of
:mod:`repro.launch.steps`.

* :func:`make_train_step` — plain synchronous training: loss, gradients,
  clip, optimizer update;
* :func:`make_psp_train_step` — PSP-barrier training
  (:func:`repro_torch.core.spmd_psp.psp_train_step`): W worker views, a
  loop over the workers for their gradients, masked server aggregation.

Both clip each gradient tree to global norm ``clip_norm`` (1.0), as the
reference does.  Gradients are taken with autograd on detached leaves of
the parameter tree, so a worker's view (slices of the ``[W, …]`` views)
goes straight in without a copy.  ``impl`` picks the kernels (``cuda``),
their plain versions (``ref``), or by device (``auto``).  The
prefill/serve steps and the dry-run's abstract inputs are not ported
(the serving engine calls the model directly; the dry-run is ROADMAP
queue 1, item 15).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.spmd_psp import PSPConfig, make_psp_step_fn
from repro_torch.models import loss_fn
from repro_torch.optim import Optimizer, apply_updates, clip_by_norm
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_grad_fn", "make_psp_train_step", "make_train_step"]

Tree = Any


def make_grad_fn(cfg, clip_norm: Optional[float] = 1.0,
                 impl: str = "auto") -> Callable:
    """``grad_fn(params, batch) -> (loss, grads)`` for ONE worker:
    ``batch`` is ``{"tokens": (B, S)[, "embeds": (B, F, D)]}`` or the
    token tensor itself;
    ``grads`` has the params' structure, clipped to ``clip_norm``."""
    def grad_fn(params: Tree, batch) -> Tuple[torch.Tensor, Tree]:
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = loss_fn(p, batch, cfg, impl=impl)
        it = iter(torch.autograd.grad(loss, tree_leaves(p)))
        grads = tree_map(lambda _: next(it), p)
        if clip_norm is not None:
            grads = clip_by_norm(grads, clip_norm)
        return loss.detach(), grads
    return grad_fn


def make_train_step(cfg, optimizer: Optimizer,
                    clip_norm: Optional[float] = 1.0,
                    impl: str = "auto") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss, metrics)``."""
    grad_fn = make_grad_fn(cfg, clip_norm, impl)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, {}
    return train_step


def make_psp_train_step(cfg, psp_cfg: PSPConfig, optimizer: Optimizer,
                        noise, clip_norm: Optional[float] = 1.0,
                        impl: str = "auto") -> Callable:
    """``step(state, batch) -> (state, metrics)``: one PSP tick on the
    per-worker microbatches ``batch`` (leading axis W), with the next
    record of the noise source ``noise``
    (:class:`~repro_torch.core.spmd_psp.GeneratorNoise` or
    :class:`~repro_torch.core.spmd_psp.ReplayNoise`)."""
    return make_psp_step_fn(psp_cfg, make_grad_fn(cfg, clip_norm, impl),
                            optimizer.update, noise)
