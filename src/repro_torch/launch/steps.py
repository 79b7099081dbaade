"""Step assembly shared by the trainer, the server and the dry run: the
port's counterpart of :mod:`repro.launch.steps`.

* :func:`make_train_step` — plain synchronous training: loss, gradients,
  clip, optimizer update;
* :func:`make_psp_train_step` — PSP-barrier training
  (:func:`repro_torch.core.spmd_psp.psp_train_step`): W worker views, a
  loop over the workers for their gradients, masked server aggregation;
* :func:`make_prefill_step` / :func:`make_serve_step` — a prompt's
  prefill and one decode step on a parameter tree;
* :func:`abstract_opt_state`, :func:`abstract_cache` and
  :func:`dryrun_inputs` — the dry run's inputs as
  :class:`~repro_torch.models.params.Abstract` records (nothing
  allocated), and :func:`meta_inputs` to run a step on them on the
  ``meta`` device.

Both training steps clip each gradient tree to global norm ``clip_norm``
(1.0), as the reference does.  Gradients are taken with autograd on
detached leaves of the parameter tree, so a worker's view (slices of the
``[W, …]`` views) goes straight in without a copy.  ``impl`` picks the
kernels (``cuda``), their plain versions (``ref``), or by device
(``auto``).  Buffer donation has no counterpart in torch: the dry run
records the reference's donated arguments and nothing else.  Over a mesh
of ranks, :func:`make_psp_train_step` takes the mesh and splits the
workers over its worker axes (:mod:`repro_torch.core.spmd_psp`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.spmd_psp import PSPConfig, make_psp_step_fn
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.models import (Model, cache_defs, decode_step, loss_fn,
                                model_defs, prefill)
from repro_torch.models.params import (abstract, abstract_params,
                                       torch_dtype, to_meta)
from repro_torch.optim import Optimizer, adamw, apply_updates, clip_by_norm
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["abstract_cache", "abstract_opt_state", "dryrun_inputs",
           "make_grad_fn", "make_prefill_step", "make_psp_train_step",
           "make_serve_step", "make_train_step", "meta_inputs"]

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
                        impl: str = "auto", mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``: one PSP tick on the
    per-worker microbatches ``batch`` (leading axis W), with the next
    record of the noise source ``noise``
    (:class:`~repro_torch.core.spmd_psp.GeneratorNoise` or
    :class:`~repro_torch.core.spmd_psp.ReplayNoise`).  Over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.HostMesh`) each rank computes its
    workers' gradients and holds their views (the state from
    ``psp_init(..., mesh=mesh)``)."""
    return make_psp_step_fn(psp_cfg, make_grad_fn(cfg, clip_norm, impl),
                            optimizer.update, noise, mesh)


def make_prefill_step(cfg, impl: str = "auto") -> Callable:
    """``prefill_step(params, batch) -> (logits (B, V), cache)``: the
    prompt ``batch["tokens"]`` after its frontend rows
    ``batch["embeds"]`` where given, on the parameter tree ``params``."""
    def prefill_step(params, batch):
        return prefill(Model(cfg, params), batch["tokens"],
                       embeds=batch.get("embeds"), impl=impl)
    return prefill_step


def make_serve_step(cfg, impl: str = "auto") -> Callable:
    """``serve_step(params, cache, batch) -> (logits (B, V), cache)``: one
    decode step of ``batch["tokens"]`` (B, 1) on the parameter tree
    ``params``; ``cache["length"]`` is a host int."""
    def serve_step(params, cache, batch):
        return decode_step(Model(cfg, params), cache, batch["tokens"],
                           impl=impl)
    return serve_step


# --------------------------------------------------------------------------- #
# abstract inputs for the dry run
# --------------------------------------------------------------------------- #
def abstract_opt_state(optimizer_name: str, defs: Dict, rules=None) -> Dict:
    """The optimizer state of ``defs`` as records: the int32 step, and
    float32 moments for ``momentum`` (mu) and ``adamw`` (mu, nu)."""
    step = abstract((), torch.int32, (), rules)
    if optimizer_name == "sgd":
        return {"step": step}
    mu = abstract_params(defs, torch.float32, rules)
    if optimizer_name == "momentum":
        return {"step": step, "mu": mu}
    nu = abstract_params(defs, torch.float32, rules)
    return {"step": step, "mu": mu, "nu": nu}


def abstract_cache(cfg, shape, rules=None) -> Dict:
    """The decode shape's cache as records: capacity ``seq_len``,
    holding ``seq_len − 1`` tokens (:func:`meta_inputs` sets
    ``length``)."""
    return abstract_params(cache_defs(cfg, shape.global_batch,
                                      shape.seq_len), torch.bfloat16, rules)


def dryrun_inputs(cfg, shape, rules=None, optimizer_name: str = "adamw",
                  impl: str = "auto") -> Tuple[tuple, Callable,
                                               Tuple[int, ...]]:
    """(abstract_args, step_fn, donate_argnums) for one dry-run combo.

    ``donate_argnums`` are the reference's (train donates the parameters
    and the optimizer state; decode the cache); they are recorded only.
    """
    defs = model_defs(cfg)
    aparams = abstract_params(defs, torch_dtype(cfg.param_dtype), rules)
    if shape.kind == "train":
        astate = abstract_opt_state(optimizer_name, defs, rules)
        batch = make_batch_specs(cfg, shape, rules)
        step = make_train_step(cfg, adamw(1e-4), impl=impl)
        return (aparams, astate, batch), step, (0, 1)
    if shape.kind == "prefill":
        batch = make_batch_specs(cfg, shape, rules)
        return (aparams, batch), make_prefill_step(cfg, impl), ()
    cache = abstract_cache(cfg, shape, rules)
    batch = make_batch_specs(cfg, shape, rules, kind="decode")
    return (aparams, cache, batch), make_serve_step(cfg, impl), (1,)


def meta_inputs(args: tuple, shape) -> tuple:
    """:func:`dryrun_inputs`' records as ``meta`` tensors, ready for its
    step; a decode cache holds ``seq_len − 1`` tokens."""
    out = to_meta(args)
    if shape.kind == "decode":
        out[1]["length"] = shape.seq_len - 1
    return out
