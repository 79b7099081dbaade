"""Logical-axis sharding rules (MaxText-style) for the production mesh.

The port's counterpart of :mod:`repro.parallel.sharding`, rule for rule.
Arrays in the model are annotated with *logical* axis names
(:class:`~repro_torch.models.params.ParamDef`'s ``axes``); a rules table
maps each logical name to an ordered preference of mesh axes.  When a
spec is resolved, mesh axes that (a) don't exist in the mesh, (b) don't
divide the dimension, or (c) were already consumed by an earlier dim of
the same array, are dropped, so a single rules table covers every
architecture (``heads→model`` silently degrades to replicated for archs
whose head count doesn't divide the 16-way model axis).

The table is built per (ModelConfig, InputShape, mesh) by
:func:`make_rules`.  A mesh here is anything with ``.shape`` (a mapping
from axis name to size) and ``.axis_names``, such as
:class:`repro_torch.launch.mesh.AbstractMesh`: no device stands behind
it, so these rules give each array's spec and per-device shard shape
without a process group.  A :data:`PartitionSpec` is a tuple with one
entry per dimension: ``None`` (replicated) or a tuple of mesh axis
names, major to minor.

Placing arrays on devices needs a process group: over a
:class:`~repro_torch.launch.mesh.HostMesh`,
:meth:`AxisRules.sharding` gives the ``torch.distributed.tensor``
placements of a spec and :func:`constrain` redistributes a ``DTensor``
to them; :func:`sweep_mesh` is the sweep engines' ``(rows, nodes)``
``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["AxisRules", "PSP_WORKER_AXES", "PartitionSpec",
           "SWEEP_NODES_AXIS", "SWEEP_ROWS_AXIS", "constrain",
           "current_rules", "make_rules", "placements",
           "psp_worker_axes", "shard_shape", "spec_for", "sweep_mesh",
           "use_rules"]

MeshAxes = Tuple[str, ...]
#: one entry per dimension: None (replicated) or the mesh axes over
#: which that dimension is split, major to minor
PartitionSpec = Tuple[Optional[MeshAxes], ...]

# --------------------------------------------------------------------------- #
# shared mesh-axis vocabulary (the reference's names: the sweep engines'
# 2-D (rows, nodes) mesh and the axes carrying the PSP trainer's worker
# dimension W)
# --------------------------------------------------------------------------- #

#: scenario-row axis of the sweep engines' 2-D mesh
SWEEP_ROWS_AXIS = "rows"

#: node-slot axis of the sweep engines' 2-D mesh (the P dimension)
SWEEP_NODES_AXIS = "nodes"

#: mesh axes that may carry the SPMD trainer's worker dimension, in
#: major-to-minor order (a multi-pod worker is a (pod, data-row) pair)
PSP_WORKER_AXES: MeshAxes = ("pod", "data")


def sweep_mesh(rows: int, nodes: int = 1, device_type: Optional[str] = None):
    """The sweep engines' ``(rows, nodes)`` ``DeviceMesh``: the first
    ``rows × nodes`` ranks of the initialised process group, rows-major
    (every rank of the group calls it).  Kept per shape and device type
    for as long as the default group is the same, so a sweep of many
    batches makes its groups once."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh
    world = dist.group.WORLD
    key = (rows, nodes, device_type)
    hit = _SWEEP_MESHES.get(key)
    # the entry holds its group, so a later group cannot take its place
    # unseen
    if hit is None or hit[0] is not world:
        hit = _SWEEP_MESHES[key] = (world, device_mesh(
            device_type, (rows, nodes), (SWEEP_ROWS_AXIS, SWEEP_NODES_AXIS)))
    return hit[1]


#: sweep_mesh's meshes: (rows, nodes, device type) → (group, mesh)
_SWEEP_MESHES: Dict[tuple, tuple] = {}


def psp_worker_axes(mesh) -> MeshAxes:
    """The mesh axes carrying the trainer's worker dimension W:
    :data:`PSP_WORKER_AXES` filtered to the axes ``mesh`` has (none
    without a mesh)."""
    if mesh is None:
        return ()
    return tuple(a for a in PSP_WORKER_AXES if a in mesh.axis_names)


class AxisRules:
    """Logical-name → mesh-axes mapping with divisibility-aware
    resolution."""

    def __init__(self, table: Dict[str, MeshAxes], mesh):
        self.table = dict(table)
        self.mesh = mesh

    def mesh_axis_size(self, axis: str) -> int:
        """The size of mesh axis ``axis``; 0 when the mesh lacks it."""
        if self.mesh is None or axis not in self.mesh.shape:
            return 0
        return int(self.mesh.shape[axis])

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> PartitionSpec:
        """Resolve logical axes to a :data:`PartitionSpec` for a concrete
        shape."""
        used: set = set()
        out = []
        for dim, name in zip(shape, logical_axes):
            if name is None or name not in self.table:
                out.append(None)
                continue
            picked = []
            prod = 1
            for ax in self.table[name]:
                size = self.mesh_axis_size(ax)
                if size == 0 or ax in used:
                    continue
                if dim % (prod * size) == 0:
                    picked.append(ax)
                    prod *= size
            used.update(picked)
            out.append(tuple(picked) if picked else None)
        return tuple(out)

    def sharding(self, logical_axes, shape) -> Optional[tuple]:
        """The ``torch.distributed.tensor`` placements of
        :meth:`spec` over the mesh (one per mesh dimension), or None
        without a mesh."""
        if self.mesh is None:
            return None
        return placements(self.spec(logical_axes, shape), self.mesh)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """A spec as ``DTensor`` placements over ``mesh`` (its
    ``axis_names`` and ``shape``): ``Shard(i)`` on each mesh dimension
    that splits tensor dimension ``i``, ``Replicate()`` on the others
    and on a dimension of one rank (a split over one rank keeps the
    whole, and redistributing it then moves nothing).  A dimension split
    over several mesh axes must name them in the mesh's order
    (``DTensor`` shards major to minor in that order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        pos = [names.index(a) for a in axes or ()]
        if pos != sorted(pos):
            raise ValueError(f"dimension {i} splits over {axes}, out of "
                             f"the mesh's order {names}")
        for j in pos:
            if mesh.shape[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def shard_shape(spec: PartitionSpec, shape: Sequence[int],
                mesh) -> Tuple[int, ...]:
    """The per-device shape of an array of ``shape`` laid out by
    ``spec`` over ``mesh``: each dimension divided by the product of its
    axes' sizes (every axis divides it, by :meth:`AxisRules.spec`'s
    construction).  Dimensions past the spec's length are whole."""
    out = []
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        n = 1
        for ax in axes or ():
            n *= int(mesh.shape[ax])
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {axes} ({n} shards)")
        out.append(dim // n)
    return tuple(out)


# --------------------------------------------------------------------------- #
# thread-local active rules (so model code can ask for specs without
# plumbing)
# --------------------------------------------------------------------------- #
_state = threading.local()


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    """Make ``rules`` the current thread's rules inside the block."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def current_rules() -> Optional[AxisRules]:
    """The rules :func:`use_rules` made current on this thread, or None."""
    return getattr(_state, "rules", None)


def spec_for(logical_axes, shape) -> PartitionSpec:
    """The current rules' spec of an array (``()``, fully replicated,
    without rules)."""
    rules = current_rules()
    if rules is None:
        return ()
    return rules.spec(logical_axes, shape)


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Lay ``x`` out by logical names under the current rules.

    A ``DTensor`` is redistributed to the placements of its spec over
    the rules' mesh; any tensor is returned unchanged when no rules (or
    no mesh) are current, and a plain tensor is returned unchanged
    always (it is this rank's whole value, which no layout changes).
    """
    from torch.distributed.tensor import DTensor
    rules = current_rules()
    if rules is None or rules.mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          rules.sharding(logical_axes, x.shape))


# --------------------------------------------------------------------------- #
# rules tables
# --------------------------------------------------------------------------- #
def make_rules(cfg, shape, mesh) -> AxisRules:
    """Build the rules table for one (arch, input-shape, mesh)
    combination, as :func:`repro.parallel.sharding.make_rules` does.

    ``cfg`` needs ``n_heads``; ``shape`` may be a duck type with
    ``kind``/``global_batch``; ``mesh`` None is one device (every spec
    replicated).
    """
    data_axes: MeshAxes = ()
    if mesh is not None:
        names = mesh.axis_names
        data_axes = tuple(a for a in ("pod", "data") if a in names)

    table: Dict[str, MeshAxes] = {
        # activations
        "batch": data_axes,
        "seq": (),
        "qseq": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "d_model": (),              # activations keep d_model unsharded
        "d_ff_act": ("model",),
        "experts_act": ("model",),
        "vocab_act": ("model",),
        "d_inner_act": ("model",),
        "ssm_heads_act": ("model",),
        "lru_act": ("model",),
        # weights (FSDP dim = 'data'; tensor dim = 'model')
        "d_model_w": ("data",),
        "heads_w": ("model",),
        "kv_heads_w": ("model",),
        "d_ff_w": ("model",),
        "vocab_w": ("model",),
        "experts_w": ("model",),
        "expert_ff_w": ("data",),   # FSDP the per-expert FF dim
        "d_inner_w": ("model",),
        "ssm_heads_w": ("model",),
        "lru_w": ("model",),
        "layers": (),
        "conv": (),
        "state": (),
        # kv-cache layout (decode)
        "cache_seq": (),
        "cache_batch": data_axes,
        # attention activations: batch over the data axes
        "attn_batch": data_axes,
    }

    kind = getattr(shape, "kind", "train")
    gbatch = getattr(shape, "global_batch", 0)
    if kind == "decode":
        if gbatch == 1:
            # long_500k: batch unshardable — spread the cache over
            # everything
            table["cache_seq"] = data_axes + ("model",)
        else:
            table["cache_seq"] = ("model",)
    return AxisRules(table, mesh)
