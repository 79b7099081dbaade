"""Deterministic fault-plan registry for chaos testing: the port's copy
of :mod:`repro.core.faults`, event for event.

A *fault plan* is a seeded, fully materialized schedule of concrete fault
events — "SIGKILL worker 2 at tick 12", "every publish torn for the next
4 versions", "stall worker 0 for 1.5 s at tick 20" — that the chaos
consumers execute verbatim:

* the multi-process cluster harness (:mod:`repro_torch.launch.cluster`)
  executes the **process faults** (``kill`` / ``stall`` / ``hang``) on
  its real worker subprocesses;
* :class:`repro_torch.serving.snapshot_bus.ChaosPublisher` executes the
  **publish faults** (``torn_snapshot`` / ``corrupt_snapshot`` /
  ``delay_publish`` / ``drop_publish`` / ``disk_full``) on the snapshot
  bus.

Plans are *data*, not control flow: a builder draws every target and
time from one seeded ``numpy`` generator at construction, the compiled
event list round-trips through JSON (``to_json`` / ``from_json``), and
re-running the same spec string reproduces the identical plan — which is
what makes a chaos run reproducible and lets the equivalence tests
replay a cluster run's membership trajectory exactly.  The same spec
yields the same plan as the reference's.

Specs are ``name`` or ``name:key=value,key=value`` over the builder
registry (:data:`BUILDERS`): ``none``, ``kill-one``, ``standard``,
``rack``, ``torn-storm``, ``stall-one``.  ``PSP_FAULT_PLAN`` (typed in
:mod:`repro_torch.core.env`) provides an ambient default spec — or a
path to a plan JSON written earlier — for the cluster CLI.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import env

__all__ = ["FaultEvent", "FaultPlan", "BUILDERS", "make_plan",
           "plan_from_env", "PROCESS_KINDS", "PUBLISH_KINDS"]

#: fault kinds executed on worker processes by the cluster coordinator
PROCESS_KINDS = ("kill", "stall", "hang")
#: fault kinds executed on snapshot-bus publications
PUBLISH_KINDS = ("torn_snapshot", "corrupt_snapshot", "delay_publish",
                 "drop_publish", "disk_full")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One concrete fault.

    ``tick`` is the engine tick for process faults and the *publish
    index* (0-based count of publications) for publish faults.
    ``worker`` targets a worker subprocess (process faults; ``None``
    for the serving tier's single decode worker).  ``seconds`` is the
    stall/hang/delay duration; ``count`` widens publish faults to a
    window of consecutive publications (a *storm*).
    """

    kind: str
    tick: int
    worker: Optional[int] = None
    seconds: float = 0.0
    count: int = 1

    def __post_init__(self):
        if self.kind not in PROCESS_KINDS + PUBLISH_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (known: "
                             f"{PROCESS_KINDS + PUBLISH_KINDS})")
        if self.tick < 0 or self.count < 1 or self.seconds < 0:
            raise ValueError(f"invalid fault event {self}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A compiled, immutable schedule of :class:`FaultEvent`\\ s.

    The shape parameters (``n_workers``, ``ticks``) are recorded so a
    consumer can refuse a plan built for a different cluster, and so the
    JSON artifact is self-describing.
    """

    name: str
    seed: int
    n_workers: int
    ticks: int
    events: Tuple[FaultEvent, ...]

    def kills_at(self, tick: int) -> List[int]:
        """Worker ids with a ``kill`` event scheduled at ``tick``."""
        return [e.worker for e in self.events
                if e.kind == "kill" and e.tick == tick
                and e.worker is not None]

    def worker_events(self, worker: int) -> List[FaultEvent]:
        """The ``stall``/``hang`` events a worker executes on itself."""
        return [e for e in self.events
                if e.kind in ("stall", "hang") and e.worker == worker]

    def publish_fault(self, index: int) -> Optional[FaultEvent]:
        """The publish fault covering publication ``index``, if any.

        An event with ``count=k`` covers indices ``tick .. tick+k-1``;
        the first matching event in plan order wins.
        """
        for e in self.events:
            if e.kind in PUBLISH_KINDS and e.tick <= index < e.tick + e.count:
                return e
        return None

    def serving_kill_index(self) -> Optional[int]:
        """Request index at which the serving decode worker dies, if any.

        Serving-tier plans encode the decode-worker death as a ``kill``
        with ``worker=None``; ``tick`` is the submitted-request index.
        """
        for e in self.events:
            if e.kind == "kill" and e.worker is None:
                return e.tick
        return None

    def to_json(self) -> str:
        """Serialize the plan (events and shape) to a JSON string."""
        return json.dumps({
            "name": self.name, "seed": self.seed,
            "n_workers": self.n_workers, "ticks": self.ticks,
            "events": [dataclasses.asdict(e) for e in self.events],
        }, indent=1)

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        """Inverse of :meth:`to_json`."""
        d = json.loads(text)
        return FaultPlan(name=d["name"], seed=int(d["seed"]),
                         n_workers=int(d["n_workers"]),
                         ticks=int(d["ticks"]),
                         events=tuple(FaultEvent(**e) for e in d["events"]))

    def save(self, path: str) -> None:
        """Write the plan JSON to ``path`` (atomic tmp+rename)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)


def _build_none(rng, n_workers, ticks, opts) -> Tuple[FaultEvent, ...]:
    """The empty plan: a no-fault control run."""
    return ()


def _build_kill_one(rng, n_workers, ticks, opts) -> Tuple[FaultEvent, ...]:
    """SIGKILL one seeded-random worker one third of the way in.

    Options: ``worker`` / ``at`` pin the victim / tick explicitly.
    """
    worker = int(opts.get("worker", rng.integers(n_workers)))
    at = int(opts.get("at", max(1, ticks // 3)))
    return (FaultEvent("kill", at, worker=worker),)


def _build_stall_one(rng, n_workers, ticks, opts) -> Tuple[FaultEvent, ...]:
    """Stall one seeded-random worker for ``d`` wall seconds mid-run."""
    worker = int(opts.get("worker", rng.integers(n_workers)))
    at = int(opts.get("at", max(1, ticks // 2)))
    d = float(opts.get("d", 1.0))
    return (FaultEvent("stall", at, worker=worker, seconds=d),)


def _build_standard(rng, n_workers, ticks, opts) -> Tuple[FaultEvent, ...]:
    """The acceptance-criteria mix: one kill, one stall, publish chaos.

    One worker SIGKILLed a third of the way in, a *different* worker
    stalled (``d`` seconds, default 0.5) halfway, a torn-snapshot storm
    of ``k`` publications (default 3), and one delayed publication —
    the "torn snapshots + one worker death + delayed publishes" plan the
    serving chaos run and the cluster bench both execute.
    """
    k = int(opts.get("k", 3))
    d = float(opts.get("d", 0.5))
    victim = int(opts.get("worker", rng.integers(n_workers)))
    straggler = int((victim + 1 + rng.integers(max(1, n_workers - 1)))
                    % n_workers) if n_workers > 1 else victim
    return (
        FaultEvent("kill", max(1, ticks // 3), worker=victim),
        FaultEvent("stall", max(1, ticks // 2), worker=straggler, seconds=d),
        FaultEvent("torn_snapshot", int(opts.get("storm_at", 2)), count=k),
        FaultEvent("delay_publish", int(opts.get("delay_at", 2 + k)),
                   seconds=float(opts.get("delay", 0.2))),
    )


def _build_rack(rng, n_workers, ticks, opts) -> Tuple[FaultEvent, ...]:
    """Correlated rack-level kill: one whole rack dies at the same tick.

    Workers are partitioned into racks of ``g`` (default 2) consecutive
    ids; a seeded-random rack is killed at a seeded mid-run tick.  At
    least one worker always survives (the last partial rack is never
    chosen when it would empty the cluster).
    """
    g = max(1, int(opts.get("g", 2)))
    n_racks = max(1, n_workers // g)
    rack = int(opts.get("rack", rng.integers(n_racks)))
    at = int(opts.get("at", max(1, ticks // 3)))
    members = [w for w in range(rack * g, min((rack + 1) * g, n_workers))]
    if len(members) >= n_workers:        # never kill the whole cluster
        members = members[:-1]
    return tuple(FaultEvent("kill", at, worker=w) for w in members)


def _build_torn_storm(rng, n_workers, ticks, opts) -> Tuple[FaultEvent, ...]:
    """Every publication torn for ``k`` versions, then clean again.

    The serving satellite's storm: a watcher must keep serving its last
    good version through the storm and swap on the first complete
    snapshot after it.  ``corrupt=1`` writes discoverable-but-unloadable
    snapshots instead of invisible torn ones.
    """
    k = int(opts.get("k", 4))
    kind = "corrupt_snapshot" if opts.get("corrupt") else "torn_snapshot"
    return (FaultEvent(kind, int(opts.get("at", 1)), count=k),)


#: registered plan builders: ``name -> (rng, n_workers, ticks, opts) -> events``
BUILDERS: Dict[str, Callable] = {
    "none": _build_none,
    "kill-one": _build_kill_one,
    "stall-one": _build_stall_one,
    "standard": _build_standard,
    "rack": _build_rack,
    "torn-storm": _build_torn_storm,
}


def _parse_spec(spec: str) -> Tuple[str, Dict[str, float]]:
    """Split ``name:key=value,...`` into (name, numeric options dict)."""
    name, _, rest = spec.partition(":")
    opts: Dict[str, float] = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        if not _ or not k:
            raise ValueError(f"bad fault-plan option {item!r} in {spec!r}")
        opts[k.strip()] = float(v)
    return name.strip(), opts


def make_plan(spec: str, *, n_workers: int, ticks: int) -> FaultPlan:
    """Compile a spec string (or plan-JSON path) into a :class:`FaultPlan`.

    ``spec`` is either a path to a plan JSON (loaded verbatim, shape
    checked against ``n_workers``) or a registry spec like
    ``"standard:seed=7,k=4"``.  The ``seed`` option (default 0) seeds
    the builder's generator; all other options are builder-specific.
    """
    if spec.endswith(".json") or os.path.sep in spec:
        with open(spec) as f:
            plan = FaultPlan.from_json(f.read())
        if plan.n_workers != n_workers:
            raise ValueError(f"plan {plan.name!r} was built for "
                             f"{plan.n_workers} workers, cluster has "
                             f"{n_workers}")
        return plan
    name, opts = _parse_spec(spec)
    if name not in BUILDERS:
        raise ValueError(f"unknown fault plan {name!r} "
                         f"(known: {sorted(BUILDERS)})")
    seed = int(opts.pop("seed", 0))
    rng = np.random.default_rng(seed)
    events = BUILDERS[name](rng, n_workers, ticks, opts)
    for e in events:
        if e.kind in PROCESS_KINDS and e.worker is not None \
                and not 0 <= e.worker < n_workers:
            raise ValueError(f"fault targets worker {e.worker} outside "
                             f"0..{n_workers - 1}: {e}")
    return FaultPlan(name=name, seed=seed, n_workers=n_workers,
                     ticks=ticks, events=tuple(events))


def plan_from_env(*, n_workers: int, ticks: int,
                  default: str = "none") -> FaultPlan:
    """The ambient plan: ``PSP_FAULT_PLAN`` if set, else ``default``."""
    spec = env.get_str("PSP_FAULT_PLAN") or default
    return make_plan(spec, n_workers=n_workers, ticks=ticks)
