"""Production mesh geometry, as abstract meshes with no device behind
them.

The port's counterpart of :mod:`repro.launch.mesh`.  The reference's
production meshes (TPU pods):

* ``single``: (data 16, model 16), 256 chips;
* ``multi``: (pod 2, data 16, model 16), 512 chips.

Here they are :class:`AbstractMesh` values: axis names and sizes, which
is all :func:`repro_torch.parallel.sharding.make_rules` and
:func:`~repro_torch.parallel.sharding.shard_shape` read.  The port's own
mesh kind is ``card``, one H100: no mesh at all (``None``), so the rules
are the reference's ``make_rules(cfg, shape, None)`` and every spec is
fully replicated.  (A ``(data 1, model 1)`` mesh would give the same
shard shapes but name the size-1 axes in its specs.)

A mesh over real devices (the reference's ``make_host_mesh``) needs a
process group and belongs to the mesh slice (ROADMAP queue 1, item
15b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

__all__ = ["AbstractMesh", "MESH_KINDS", "make_mesh",
           "make_production_mesh"]

#: the dry run's mesh kinds: the reference's two pods and one card
MESH_KINDS = ("single", "multi", "card")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's geometry: axis names, major to minor, and their sizes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_mesh(kind: str) -> Optional[AbstractMesh]:
    """The mesh of a dry-run mesh kind (:data:`MESH_KINDS`): the
    production meshes, or None for ``card`` (one device, no mesh)."""
    if kind not in MESH_KINDS:
        raise ValueError(f"unknown mesh kind {kind!r}; choose from "
                         + "|".join(MESH_KINDS))
    if kind == "card":
        return None
    return make_production_mesh(multi_pod=kind == "multi")
