"""The Actor system's three engines (paper §4): the port's copy of
:mod:`repro.core.engines`.

The paper's framework exposes three computation engines that share one
swappable ``barrier`` function (Table 1: "Owl+Actor — BSP, ASP, SSP,
PSP"):

* **map-reduce** — BSP-style bulk phases (``map``/``reduce``/``collect``);
* **parameter server** — ``push``/``pull``/``schedule``/``barrier`` with a
  logical central server holding model *and* node states (design
  combination 1: [centralised model, centralised states]);
* **peer-to-peer** — the same four APIs, but barrier state is fully
  distributed: every node samples peers through the structured overlay
  and decides locally (combination 2/4: [*, distributed states]); with
  PSP the server degenerates into a stateless *stream server* for
  updates.

:meth:`Engine.run` drives the discrete-event simulator
(:mod:`repro_torch.core.simulator`) and :meth:`Engine.run_sweep` the
sweep engine (:mod:`repro_torch.core.vector_sim`), on the card unless
told otherwise, so every experiment of the paper is an engine + barrier
combination.  The PSP trainer is :mod:`repro_torch.core.spmd_psp`.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from repro_torch.core.barriers import BSP, BarrierControl, make_barrier
from repro_torch.core.simulator import SimConfig, SimResult, run_simulation
from repro_torch.core.vector_sim import run_sweep

__all__ = [
    "Engine",
    "MapReduceEngine",
    "ParameterServerEngine",
    "P2PEngine",
    "valid_combinations",
]


# --------------------------------------------------------------------------- #
# design-combination matrix (paper §4.1)
# --------------------------------------------------------------------------- #
#: barrier-name -> engines that can host it.  BSP/SSP need centralised state;
#: ASP needs none; pBSP/pSSP run anywhere (that is the point of the paper).
_COMBINATIONS = {
    "bsp": ("mapreduce", "ps"),
    "ssp": ("ps",),
    "asp": ("ps", "p2p"),
    "pbsp": ("ps", "p2p"),
    "pssp": ("ps", "p2p"),
}


def valid_combinations(barrier_name: str) -> Sequence[str]:
    """Engines that can host ``barrier_name`` (paper §4.1 matrix)."""
    return _COMBINATIONS[barrier_name.lower()]


class Engine:
    """Common engine machinery: configure a simulation and run it."""

    name = "base"
    distributed_states = False

    def __init__(self, barrier: BarrierControl | str = "bsp", **overrides):
        if isinstance(barrier, str):
            barrier = make_barrier(barrier)
        self._check_combination(barrier)
        self.barrier = barrier
        self.overrides = overrides

    def _check_combination(self, barrier: BarrierControl) -> None:
        if self.name != "base" and self.name not in _COMBINATIONS[barrier.name]:
            raise ValueError(
                f"{barrier.name} cannot run on the {self.name} engine "
                f"(paper §4.1: needs one of {_COMBINATIONS[barrier.name]}); "
                "only ASP and PSP support distributed barrier state")

    # the four shared APIs (paper §4) — semantic no-op hooks that the
    # simulator enacts; exposed so applications can be written against them.
    def schedule(self, step: int, n_params: int) -> np.ndarray:
        """Which model parameters to update this step (here: all)."""
        return np.arange(n_params)

    def pull(self):
        """Fetch the current model (enacted by the simulator)."""
        raise NotImplementedError("driven by the simulator's event loop")

    def push(self):
        """Submit a local update (enacted by the simulator)."""
        raise NotImplementedError("driven by the simulator's event loop")

    def _config(self, **cfg_kwargs) -> SimConfig:
        cfg_kwargs = {**self.overrides, **cfg_kwargs}
        barrier = cfg_kwargs.pop("barrier", self.barrier)
        if isinstance(barrier, str):
            barrier = make_barrier(barrier)
        self._check_combination(barrier)
        return SimConfig(barrier=barrier,
                         distributed_sampling=self.distributed_states,
                         **cfg_kwargs)

    def run(self, **cfg_kwargs) -> SimResult:
        """Run one discrete-event simulation under this engine's barrier."""
        return run_simulation(self._config(**cfg_kwargs))

    def run_sweep(self, sweep: Iterable[dict], *, backend: str = "torch",
                  device=None, **common) -> List[SimResult]:
        """Run a scenario sweep through the sweep engine.

        ``sweep`` is an iterable of per-scenario :class:`SimConfig`
        override dicts (each may also carry a ``barrier`` name or
        instance); ``common`` applies to every scenario.  Scenarios
        sharing a structural shape are advanced simultaneously
        (:func:`repro_torch.core.vector_sim.run_sweep`, which gets
        ``backend`` and ``device``): the default is the fused tick on the
        card, ``device="cpu"`` its plain version, ``backend="numpy"`` the
        host grid engine.  Results come back in sweep order.
        """
        cfgs = [self._config(**{**common, **kw}) for kw in sweep]
        return run_sweep(cfgs, backend=backend, device=device)


class MapReduceEngine(Engine):
    """Bulk phases: map (local grads) → barrier → reduce (server apply).

    MapReduce "requires map to complete before reducing" (Table 1) — i.e. the
    engine is inherently BSP.
    """

    name = "mapreduce"
    distributed_states = False

    def __init__(self, **overrides):
        super().__init__(BSP(), **overrides)


class ParameterServerEngine(Engine):
    """[centralised model, centralised states] — swappable barrier."""

    name = "ps"
    distributed_states = False


class P2PEngine(Engine):
    """[centralised-or-distributed model, **distributed** states].

    Barrier decisions are taken node-locally from overlay samples; the model
    server (when present) is a stateless stream server.  Only ASP and the
    probabilistic barriers are admissible here — BSP/SSP would need the very
    global view this engine abolishes.
    """

    name = "p2p"
    distributed_states = True
