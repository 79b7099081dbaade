"""Parameter definitions and their initialisation.

The port's counterpart of :mod:`repro.models.params`.  A model is
described once as a nested dict of :class:`ParamDef` (shape, logical
axes, initializer); :func:`init_params` materialises such a tree with the
reference's law — ``normal(0, scale)``, ``zeros`` or ``ones`` — drawn
from an explicit ``torch.Generator`` on an explicit device.  The numbers
are not those of ``jax.random`` (no generator of one framework replays
the other's); to run both packages on the same weights, carry the
reference's arrays across with :func:`repro_torch.convert.params_from_jax`.

The logical axes are kept for the sharding slice; one device ignores
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["ParamDef", "init_params", "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape, logical axes, initializer and dtype."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones
    scale: float = 0.02
    dtype: Optional[str] = None     # override the tree-wide dtype (caches)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name (``"bfloat16"``, ``"float32"``...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _one(d: ParamDef, dtype: torch.dtype, device, generator) -> torch.Tensor:
    dt = torch_dtype(d.dtype) if d.dtype else dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init != "normal":
        raise ValueError(f"unknown init {d.init!r}")
    x = torch.empty(d.shape, dtype=torch.float32, device=device)
    if device is not None and torch.device(device).type == "meta":
        return x.to(dt)
    return x.normal_(0.0, d.scale, generator=generator).to(dt)


def init_params(defs: Any, *, generator: Optional[torch.Generator] = None,
                device: Any = "cpu", dtype: torch.dtype = torch.float32
                ) -> Any:
    """Materialise a ParamDef tree into tensors of the same structure.

    Leaves are drawn one after another (dict keys in sorted order, lists
    in order) from ``generator``, which must live on ``device``; on the
    ``meta`` device nothing is drawn or allocated.
    """
    def build(node):
        if isinstance(node, ParamDef):
            return _one(node, dtype, device, generator)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return [build(n) for n in node]
    return build(defs)
