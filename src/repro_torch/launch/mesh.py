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

Over real devices: :func:`make_host_mesh` (the reference's
``make_host_mesh``) lays a :class:`HostMesh` over the ranks of an
initialised process group, and :func:`spawn_host_world` starts such a
group of processes on this host (the role of the reference's
``benchmarks/_host_mesh.py``, which forces host devices).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["AbstractMesh", "HostMesh", "MESH_KINDS", "make_host_mesh",
           "make_mesh", "make_production_mesh", "spawn_host_world"]

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


# --------------------------------------------------------------------------- #
# meshes over the ranks of a process group
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A ``DeviceMesh`` with the reference mesh's reading: ``axis_names``
    and ``shape`` (axis name → size), which the rules
    (:mod:`repro_torch.parallel.sharding`) read, plus the groups and
    local ranks the collectives (:mod:`repro_torch.parallel.collectives`)
    use."""

    device_mesh: Any

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's dimension names, major to minor."""
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        """The number of ranks the mesh spans."""
        return self.device_mesh.mesh.numel()

    @property
    def device_type(self) -> str:
        """The device type of the mesh's tensors (``cpu`` or ``cuda``)."""
        return self.device_mesh.device_type

    def get_group(self, name: str):
        """The process group along dimension ``name``."""
        return self.device_mesh.get_group(name)

    def get_local_rank(self, name: str) -> int:
        """This rank's index along dimension ``name``."""
        return self.device_mesh.get_local_rank(name)


def device_mesh(device_type: Optional[str], shape: Tuple[int, ...],
                names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the
    initialised default group, rows-major (``init_device_mesh`` when it
    spans the whole world).  ``device_type`` None: ``cuda`` when the
    group's backend is NCCL, else ``cpu``.  Every rank of the world
    calls it; a rank past the mesh gets no coordinate."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh over devices needs an initialised "
                           "process group (torch.distributed."
                           "init_process_group, or spawn_host_world)")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks; "
                         f"the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n == world:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_host_mesh(data: int = 2, model: int = 2, pod: Optional[int] = None,
                   *, device_type: Optional[str] = None) -> HostMesh:
    """A (data, model) mesh — (pod, data, model) with ``pod`` — over the
    ranks of the initialised process group, as the reference's
    ``make_host_mesh`` lays one over its host devices."""
    if pod:
        return HostMesh(device_mesh(device_type, (pod, data, model),
                                    ("pod", "data", "model")))
    return HostMesh(device_mesh(device_type, (data, model),
                                ("data", "model")))


def _rank_main(rank: int, n: int, init: str, backend: str, timeout: float,
               fn: Callable, args: tuple, out) -> None:
    """One rank of :func:`spawn_host_world`: join the group, run ``fn``,
    send (rank, ok, result or traceback) back."""
    import torch
    import torch.distributed as dist
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn_host_world(n: int, fn: Callable, *args: Any,
                     backend: str = "gloo", timeout: float = 60.0,
                     wall: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` processes of this host, each a rank of
    one process group; returns the ranks' results in rank order.

    ``fn`` must be importable by name (the processes are spawned) and
    return something picklable.  The rendezvous is a ``file://`` under a
    fresh temporary directory, so no TCP port can collide; ``timeout``
    bounds each collective (the group's own timeout) and ``wall`` the
    whole run: a rank that fails, or a run past ``wall`` seconds, stops
    every rank and raises.
    """
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="psp_world_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, init, backend, timeout, fn, args, out))
             for r in range(n)]
    deadline = time.monotonic() + wall
    results: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_host_world: {n} ranks of "
                                   f"{getattr(fn, '__name__', fn)} passed "
                                   f"{wall} s; {sorted(results)} done")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_host_world: a rank exited "
                                       f"with code {dead[0]} before its "
                                       "result") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn_host_world: rank {rank} "
                                   f"failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n)]
