"""Parameter definitions and their initialisation.

The port's counterpart of :mod:`repro.models.params`.  A model is
described once as a nested dict of :class:`ParamDef` (shape, logical
axes, initializer); :func:`init_params` materialises such a tree with the
reference's law — ``normal(0, scale)``, ``zeros`` or ``ones`` — drawn
from an explicit ``torch.Generator`` on an explicit device.  The numbers
are not those of ``jax.random`` (no generator of one framework replays
the other's); to run both packages on the same weights, carry the
reference's arrays across with :func:`repro_torch.convert.params_from_jax`.

The same description gives the dry run its stand-ins without
allocating anything: :func:`abstract_params` (one :class:`Abstract`
record per leaf: shape, dtype, and the spec and per-device shape under a
rules table), :func:`spec_tree` and :func:`tree_size_bytes`, with
:func:`per_device_bytes` over such records.  The logical axes are read
by :mod:`repro_torch.parallel.sharding`; :func:`place_params` lays a
tree over a mesh of ranks by them, and running on one device ignores
them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["Abstract", "ParamDef", "abstract", "abstract_params",
           "init_params", "map_defs", "per_device_bytes", "place_params",
           "spec_tree", "to_meta", "torch_dtype", "tree_size_bytes"]


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
    return map_defs(lambda d: _one(d, dtype, device, generator), defs)


def map_defs(fn: Callable[[ParamDef], Any], defs: Any) -> Any:
    """``fn`` applied to every :class:`ParamDef` of ``defs`` (dicts in
    sorted key order, as :func:`init_params` builds them; lists in
    order)."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, defs[k]) for k in sorted(defs)}
    return [map_defs(fn, d) for d in defs]


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A leaf the dry run does not allocate: its shape and dtype, and
    under a rules table its spec and per-device shape (without rules:
    no spec, the whole shape)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[Tuple] = None
    shard: Optional[Tuple[int, ...]] = None

    @property
    def shard_bytes(self) -> int:
        """Bytes of one device's shard."""
        return math.prod(self.shard or self.shape) * self.dtype.itemsize

    def meta(self) -> torch.Tensor:
        """A ``meta`` tensor of this shape and dtype (no storage)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def abstract(shape, dtype: torch.dtype, axes, rules=None) -> Abstract:
    """One :class:`Abstract` of ``shape`` and ``dtype`` with logical
    ``axes``, resolved by ``rules`` where given."""
    from repro_torch.parallel.sharding import shard_shape
    shape = tuple(int(n) for n in shape)
    if rules is None:
        return Abstract(shape, dtype)
    spec = rules.spec(axes, shape)
    shard = (shape if rules.mesh is None
             else shard_shape(spec, shape, rules.mesh))
    return Abstract(shape, dtype, spec, shard)


def abstract_params(defs: Any, dtype: torch.dtype = torch.float32,
                    rules=None) -> Any:
    """The :class:`Abstract` tree of ``defs`` (each leaf in its own dtype
    where the def names one, else ``dtype``), with specs and shard shapes
    when ``rules`` (:class:`~repro_torch.parallel.sharding.AxisRules`)
    are given."""
    return map_defs(lambda d: abstract(
        d.shape, torch_dtype(d.dtype) if d.dtype else dtype, d.axes, rules),
        defs)


def spec_tree(defs: Any, rules) -> Any:
    """Each def's spec under ``rules``, in the defs' structure."""
    return map_defs(lambda d: rules.spec(d.axes, d.shape), defs)


def place_params(params: Any, rules, defs: Any) -> Any:
    """Distribute a parameter tree over the rules' mesh by
    :func:`spec_tree`: each leaf of ``params`` (this rank's whole value,
    the same on every rank) becomes a ``DTensor`` laid out by
    :meth:`~repro_torch.parallel.sharding.AxisRules.sharding` of its def
    in ``defs`` (the reference places its arrays by the shardings of
    ``abstract_params``).  Every rank holds the whole value already, so
    each keeps its own shard and nothing is sent.  A leaf must lie on
    the mesh's device type (gloo ranks sharing a card make their mesh
    with ``device_type="cuda"``).  Without a mesh the
    tree is returned as it is.  The expert-parallel MoE places its
    experts so (:func:`repro_torch.convert.expert_slice`)."""
    if rules is None or rules.mesh is None:
        return params
    from torch.distributed.tensor import distribute_tensor
    mesh = rules.mesh.device_mesh

    def one(d: ParamDef, p):
        if p.device.type != mesh.device_type:      # DTensor would move it
            raise ValueError(f"a {p.device.type} tensor on a "
                             f"{mesh.device_type} mesh")
        return distribute_tensor(p, mesh, rules.sharding(d.axes, d.shape),
                                 src_data_rank=None)

    def walk(d, p):
        if isinstance(d, ParamDef):
            return one(d, p)
        if isinstance(d, dict):
            return {k: walk(v, p[k]) for k, v in d.items()}
        return type(d)(walk(v, q) for v, q in zip(d, p))
    return walk(defs, params)


def tree_size_bytes(defs: Any, bytes_per_el: int = 4) -> int:
    """Total parameter bytes of a ParamDef tree at ``bytes_per_el``
    bytes an element (for memory napkin math)."""
    total = []
    map_defs(lambda d: total.append(math.prod(d.shape) * bytes_per_el),
             defs)
    return sum(total)


def _abstract_leaves(tree: Any):
    if isinstance(tree, Abstract):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _abstract_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _abstract_leaves(v)


def per_device_bytes(tree: Any) -> int:
    """Bytes one device holds of an :class:`Abstract` tree, from the
    shard shapes."""
    return sum(a.shard_bytes for a in _abstract_leaves(tree))


def to_meta(tree: Any) -> Any:
    """An :class:`Abstract` tree as ``meta`` tensors of the same
    structure (other leaves unchanged)."""
    if isinstance(tree, Abstract):
        return tree.meta()
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree
