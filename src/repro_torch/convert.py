"""Carry inputs and parameters across from the reference and back.

The reference package passes numpy (or jax) arrays; the port passes
tensors.  :func:`tick_inputs_to_torch` maps the reference's sweep-tick
``state`` / ``rand`` / ``params`` dicts onto the port's, dtype for dtype
(bool, int32, float32; 0-d scalars become host floats, as the port keeps
``eps`` and ``poll``), and :func:`to_numpy` maps results back.
:func:`params_from_jax` turns the reference's ``init_model`` parameter
tree (as numpy arrays) into the port's :class:`~repro_torch.models.Model`
by splitting its stacked layer axis, and :func:`params_to_numpy` is the
inverse, so both packages can compute on the same inputs and weights.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["params_from_jax", "params_to_numpy", "tick_inputs_to_torch",
           "to_numpy", "to_torch"]

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


def params_from_jax(tree: Dict, cfg, device: Any = "cpu"):
    """The reference's parameter tree → the port's model on ``device``.

    ``tree`` is ``repro.models.init_model``'s output with its leaves as
    numpy arrays.  The reference stacks the blocks of pattern position
    ``j`` along a leading group axis under ``tree["groups"][str(j)]``;
    layer ``g·len(pattern) + j`` is slice ``g`` of it.  Shapes are
    otherwise the port's own, so nothing but that axis is split.
    """
    from repro_torch.models import Model
    n_pat = len(cfg.layer_pattern)
    conv = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    layers = [tree_map(lambda a, i=i: conv(np.asarray(a)[i // n_pat]),
                   tree["groups"][str(i % n_pat)])
              for i in range(cfg.n_layers)]
    return Model(cfg, {"embed": conv(tree["embed"]),
                       "final_norm": conv(tree["final_norm"]),
                       "layers": layers})


def params_to_numpy(model) -> Dict:
    """The port's model → the reference's parameter tree (numpy, layers
    stacked per pattern position under ``groups``)."""
    n_pat = len(model.cfg.layer_pattern)
    num = lambda t: t.detach().cpu().numpy()
    tree = model.tree()
    layers = [tree_map(num, layer) for layer in tree.pop("layers")]
    return {**tree_map(num, tree),
            "groups": {str(j): _stack(layers[j::n_pat])
                       for j in range(n_pat)}}


def _stack(trees):
    """Stack the leaves of nested dicts of one structure along a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
