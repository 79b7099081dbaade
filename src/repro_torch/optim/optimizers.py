"""Optimizers as pure transforms of trees of tensors.

The port's counterpart of :mod:`repro.optim.optimizers`, formula for
formula.  ``opt.init(params) -> state``; ``opt.update(grads, state,
params) -> (updates, new_state)``; ``apply_updates(params, updates)``.
The step counter is an int32 tensor on the parameters' device and the
moments are float32, as in the reference; nothing reads a value back to
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_norm",
           "global_norm", "momentum", "sgd"]

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _lr_at(lr: Union[float, Schedule], step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step0(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros32(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An ``(init, update)`` pair."""

    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), in float32."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def clip_by_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale the whole tree by min(1, max_norm / max(‖grads‖, 1e-9))."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads)


def sgd(lr: Union[float, Schedule]) -> Optimizer:
    """Plain SGD: u = −η·g."""
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        eta = _lr_at(lr, state["step"])
        upd = tree_map(lambda g: (-eta * g.float()).to(g.dtype), grads)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(lr: Union[float, Schedule], beta: float = 0.9) -> Optimizer:
    """Heavy ball: μ ← β·μ + g, u = −η·μ."""
    def init(params):
        return {"step": _step0(params), "mu": _zeros32(params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda m, g: beta * m + g.float(), state["mu"], grads)
        eta = _lr_at(lr, state["step"])
        upd = tree_map(lambda m, g: (-eta * m).to(g.dtype), mu, grads)
        return upd, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with bias correction; the learning rate is read at the step
    count before this update, as in the reference."""
    def init(params):
        return {"step": _step0(params), "mu": _zeros32(params),
                "nu": _zeros32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state["nu"], grads)
        t = step.float()
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        eta = _lr_at(lr, state["step"])

        def upd(m, v, p):
            u = -eta * ((m / c1) / (torch.sqrt(v / c2) + eps)
                        + weight_decay * p.float())
            return u.to(p.dtype)

        return (tree_map(upd, mu, nu, params),
                {"step": step, "mu": mu, "nu": nu})

    return Optimizer(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params + updates, leaf by leaf, in the params' dtype."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
