"""Collectives over one named dimension of a device mesh.

The port's counterparts of ``jax.lax.axis_index``, ``psum``, ``pmin``,
``pmax`` and the tiled ``all_gather``, built on ``torch.distributed``.
Each takes an :class:`Axis` — a mesh (a
``torch.distributed.device_mesh.DeviceMesh``, or anything with its
``get_group(name)`` and ``get_local_rank(name)``, such as
:class:`repro_torch.launch.mesh.HostMesh`) and one or more of its
dimension names — or ``None`` for "no mesh", where each is the
identity (``axis_index`` 0), as the reference's ``node_axis=None`` is.
Over several names (the trainer's ``("pod", "data")``) a reduction runs
over each dimension in turn and a gather concatenates minor to major,
so the result is in the row-major order of those dimensions.

Every call reaches ``torch.distributed``, also on a group of one rank,
so that a run on one card exercises its backend for real; each counts
itself in :func:`call_counts`.  The inputs are never written: every
function returns a new tensor.  Booleans travel as ``uint8``.

Backends.  A group's backend is the one its process group was made
with: ``nccl`` for CUDA tensors, or ``gloo`` for CPU tensors and for
CUDA tensors when a caller asks for gloo on the card (as several ranks
that share one card must: NCCL puts no two ranks on one GPU).  Gloo
takes CUDA tensors for every call this module makes (``all_reduce``
with sum, min and max, of int32, float32 and uint8; ``all_gather``;
``chip_smoke.py`` phase 21 (b) asks it on the card), and its own CUDA
path moves them faster than a copy through host memory here would, so
nothing is staged.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Axis", "all_gather", "axis_index",
           "axis_size", "call_counts", "mesh_axis", "pmax", "pmin", "psum",
           "reset_call_counts"]

_CALLS: Counter = Counter()


class Axis(NamedTuple):
    """One or more named dimensions of a mesh, major to minor."""

    mesh: Any
    names: Tuple[str, ...]


def mesh_axis(mesh, names: Union[str, Sequence[str]]) -> Optional[Axis]:
    """The :class:`Axis` of ``names`` on ``mesh``; None without a mesh or
    without names."""
    names = (names,) if isinstance(names, str) else tuple(names)
    if mesh is None or not names:
        return None
    return Axis(mesh, names)


def call_counts() -> Dict[str, int]:
    """Collective calls made through this module since the last reset,
    by kind (``all_reduce``, ``all_gather``)."""
    return dict(_CALLS)


def reset_call_counts() -> None:
    """Set every count of :func:`call_counts` to 0."""
    _CALLS.clear()


def axis_size(axis: Optional[Axis]) -> int:
    """The number of ranks along ``axis`` (1 without a mesh)."""
    if axis is None:
        return 1
    n = 1
    for name in axis.names:
        n *= dist.get_world_size(axis.mesh.get_group(name))
    return n


def axis_index(axis: Optional[Axis]) -> int:
    """This rank's index along ``axis``, row-major over its names (0
    without a mesh)."""
    if axis is None:
        return 0
    idx = 0
    for name in axis.names:
        size = dist.get_world_size(axis.mesh.get_group(name))
        idx = idx * size + axis.mesh.get_local_rank(name)
    return idx


def _reduce(x: torch.Tensor, axis: Optional[Axis], op) -> torch.Tensor:
    if axis is None:
        return x
    is_bool = x.dtype == torch.bool
    out = (x.to(torch.uint8) if is_bool else x).clone()
    for name in axis.names:
        group = axis.mesh.get_group(name)
        _CALLS["all_reduce"] += 1
        dist.all_reduce(out, op=op, group=group)
    return out.bool() if is_bool else out


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks of ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MAX)


def _gather_one(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _CALLS["all_gather"] += 1
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, axis: Optional[Axis],
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's ``all_gather(..., tiled=True)``)."""
    if axis is None:
        return x
    is_bool = x.dtype == torch.bool
    out = x.view(torch.uint8) if is_bool else x
    for name in reversed(axis.names):
        out = _gather_one(out, axis.mesh.get_group(name), dim)
    return out.view(torch.bool) if is_bool else out
