"""Carry inputs and parameters across from the reference and back.

The reference package passes numpy (or jax) arrays; the port passes
tensors.  :func:`tick_inputs_to_torch` maps the reference's sweep-tick
``state`` / ``rand`` / ``params`` dicts onto the port's, dtype for dtype
(bool, int32, float32; 0-d scalars become host floats, as the port keeps
``eps`` and ``poll``), and :func:`to_numpy` maps results back.

Model trees.  The port keeps one block tree per layer in a ``layers``
list (:meth:`repro_torch.models.Model.tree`); the reference stacks the
blocks of pattern position ``j`` along a leading group axis under
``groups[str(j)]``, layer ``g·len(pattern) + j`` being slice ``g``, and
keeps the layers past the last full group (``cfg.tail_pattern``:
recurrentgemma-2b's (R, R)) unstacked under ``tail[str(j)]``, layer
``n_groups·len(pattern) + j``.
:func:`to_reference_layout` and :func:`from_reference_layout` convert
any tree between the two (every dict holding a ``layers`` list is a
model tree, or one shaped like it: AdamW's moments, the PSP worker
views), on numpy arrays or tensors alike.  Checkpoints and snapshots are
written in the reference's layout, so both packages read each other's
archives; :func:`state_to_reference` / :func:`state_from_reference` do
it for a whole PSP state, whose views carry the worker axis W in front
(``[W, G, …]`` in the reference).  :func:`params_from_jax` turns the
reference's ``init_model`` tree (numpy) into the port's
:class:`~repro_torch.models.Model` and :func:`params_to_numpy` is the
inverse, so both packages can compute on the same weights.
:func:`expert_slice` gives an expert-parallel rank its experts of a
model tree, placed by the rules (:func:`repro_torch.models.moe.moe_apply`
with a mesh).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["expert_slice", "from_reference_layout", "params_from_jax",
           "params_to_numpy",
           "state_from_reference", "state_to_reference",
           "tick_inputs_to_torch", "to_numpy", "to_reference_layout",
           "to_torch"]

_DTYPES = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32}


def to_torch(x: Any, device: Any = "cpu") -> Any:
    """One array → tensor of the same dtype (bool, int32 or float32) on
    ``device``; a 0-d array becomes a host float."""
    a = np.asarray(x)
    if a.ndim == 0:
        return float(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype} (bool, int32 or "
                        "float32 expected)")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tick_inputs_to_torch(state: Dict, rand: Dict, params: Dict,
                         device: Any = "cpu") -> Tuple[Dict, Dict, Dict]:
    """The reference's tick dicts as the port's: (state, rand, params)."""
    conv = lambda d: {k: to_torch(v, device) for k, v in d.items()}
    return conv(state), conv(rand), conv(params)


def to_numpy(tree: Dict) -> Dict[str, np.ndarray]:
    """A dict of tensors (or host numbers) → a dict of numpy arrays."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree.items()}


def to_reference_layout(tree: Any, cfg, axis: int = 0) -> Any:
    """``tree`` with every ``layers`` list restacked into the reference's
    ``groups`` and ``tail`` (see the module docstring), along ``axis`` of
    each leaf (0, or 1 behind the views' worker axis).  Numpy leaves
    stack with numpy, tensors with torch; nothing else changes."""
    if not isinstance(tree, dict):
        return tree
    layers = tree.get("layers")
    if not isinstance(layers, list):
        return {k: to_reference_layout(v, cfg, axis) for k, v in tree.items()}
    n_pat = len(cfg.layer_pattern)
    n_body = cfg.n_groups * n_pat
    out = {k: to_reference_layout(v, cfg, axis) for k, v in tree.items()
           if k != "layers"}
    out["groups"] = {str(j): _stack(layers[j:n_body:n_pat], axis)
                     for j in range(n_pat)}
    if layers[n_body:]:
        out["tail"] = {str(j): t for j, t in enumerate(layers[n_body:])}
    return out


def from_reference_layout(tree: Any, cfg, axis: int = 0) -> Any:
    """Inverse of :func:`to_reference_layout`: every ``groups`` dict
    (with its sibling ``tail``) split back into ``cfg.n_layers``
    per-layer trees (tensor slices made contiguous; numpy slices stay
    views)."""
    if not isinstance(tree, dict):
        return tree
    groups = tree.get("groups")
    if not isinstance(groups, dict):
        return {k: from_reference_layout(v, cfg, axis)
                for k, v in tree.items()}
    n_pat = len(cfg.layer_pattern)
    tail = tree.get("tail", {})
    if len(tail) != len(cfg.tail_pattern):
        raise ValueError(f"{len(tail)} tail layers, {cfg.name} has "
                         f"{len(cfg.tail_pattern)}")
    out = {k: from_reference_layout(v, cfg, axis) for k, v in tree.items()
           if k not in ("groups", "tail")}
    out["layers"] = [tree_map(lambda a, g=i // n_pat: _take(a, g, axis),
                              groups[str(i % n_pat)])
                     for i in range(cfg.n_groups * n_pat)]
    out["layers"] += [tail[str(j)] for j in range(len(tail))]
    return out


def state_to_reference(tree: Dict, cfg) -> Dict:
    """A PSP state tree (:func:`~repro_torch.core.spmd_psp.state_to_tree`)
    in the reference's layout; the views' layers stack behind W."""
    return {k: to_reference_layout(v, cfg, 1 if k == "views" else 0)
            for k, v in tree.items()}


def state_from_reference(tree: Dict, cfg) -> Dict:
    """Inverse of :func:`state_to_reference`."""
    return {k: from_reference_layout(v, cfg, 1 if k == "views" else 0)
            for k, v in tree.items()}


def params_from_jax(tree: Dict, cfg, device: Any = "cpu"):
    """The reference's parameter tree → the port's model on ``device``.

    ``tree`` is ``repro.models.init_model``'s output (or a snapshot of
    it) with its leaves as numpy arrays; every leaf becomes a float32
    tensor on ``device``.
    """
    from repro_torch.models import Model

    def conv(a):
        a = np.asarray(a, np.float32)
        if not a.flags.writeable:        # torch.from_numpy wants to own it
            a = a.copy()
        return torch.from_numpy(a).to(device, copy=True)
    return Model(cfg, tree_map(conv, from_reference_layout(tree, cfg)))


def params_to_numpy(model) -> Dict:
    """The port's model → the reference's parameter tree (numpy, layers
    stacked per pattern position under ``groups``)."""
    num = lambda t: t.detach().cpu().numpy()
    return to_reference_layout(tree_map(num, model.tree()), model.cfg)


def _stack(trees, axis: int):
    """Stack the leaves of nested dicts of one structure along a new
    ``axis``."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], axis) for k in trees[0]}
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees, axis)
    return np.stack(trees, axis)


def _take(a, g: int, axis: int):
    """Slice ``g`` of ``a`` along ``axis``."""
    if isinstance(a, torch.Tensor):
        return a.select(axis, g).contiguous()
    return a[(slice(None),) * axis + (g,)]


#: the expert leaves of an MoE FFN's parameters (``moe_defs``)
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_slice(tree: Any, cfg, rules) -> Any:
    """``tree`` with every MoE FFN's expert leaves cut to this rank's
    E/model experts over the rules' mesh, ``rank · E/model`` onward (the
    expert-parallel layout of
    :func:`repro_torch.models.moe.moe_apply`); every other leaf is kept
    as it is (not copied).  An FFN is a dict holding ``router`` and the
    expert leaves.

    As the reference lays its experts out: each leaf is placed by its
    def (:func:`~repro_torch.models.params.place_params` over
    :func:`~repro_torch.models.moe.moe_defs`), then constrained to
    ``("experts_w", None, None)`` (:func:`~repro_torch.parallel.sharding.constrain`,
    as the reference's ``moe_apply`` does before its ``shard_map``:
    experts over ``model``, the FF dimension whole), and this rank's
    shard is taken.  Every rank of the mesh calls it.  Where ``model``
    does not divide E the leaves stay whole.
    """
    from repro_torch.models.moe import moe_defs
    from repro_torch.models.params import place_params
    from repro_torch.parallel.sharding import constrain, use_rules
    if rules is None or rules.mesh is None:
        return tree
    defs = {k: moe_defs(cfg)[k] for k in _EXPERT_LEAVES}

    def walk(t):
        if isinstance(t, dict):
            if "router" in t and all(k in t for k in _EXPERT_LEAVES):
                placed = place_params({k: t[k] for k in _EXPERT_LEAVES},
                                      rules, defs)
                with use_rules(rules):
                    return {**t, **{k: constrain(
                        v, ("experts_w", None, None)).to_local()
                        for k, v in placed.items()}}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(tree)
