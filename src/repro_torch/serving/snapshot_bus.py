"""Trainer → server snapshot bus over a shared directory: the port's
counterpart of :mod:`repro.serving.snapshot_bus`.

The bus is the checkpoint subsystem worn sideways: the trainer publishes
versioned model snapshots with the atomic npz + JSON-sidecar protocol of
:mod:`repro_torch.checkpoint` (sidecar renamed first, npz last, so a
discoverable snapshot is always complete), and the server polls the
directory for the newest publishable step.  No socket, no RPC: a crash
on either side leaves at worst a torn write that ``latest_step`` refuses
to select and the next publisher removes.

Snapshots of a model are written in the reference's layout (stacked
``groups``, :func:`repro_torch.convert.to_reference_layout`), so a
reference trainer can feed a port server and the other way round.

* :class:`SnapshotPublisher` — trainer side, over
  :class:`~repro_torch.checkpoint.CheckpointManager`: async writer off
  the training critical path, bounded-queue back-pressure, retention.
  Publishes **serving params only**, stamping each sidecar with its
  version.
* :class:`SnapshotWatcher` — server side.  ``poll()`` returns
  ``(model, version)`` when a *new, loadable* snapshot appeared, else
  ``None``; the model is a :class:`~repro_torch.models.Model` on the
  serving device.  Corrupt, torn
  or config-mismatched snapshots are skipped and the server keeps its
  current version.  Bad steps go into a **bounded blacklist with
  exponential backoff**: a failing step is retried on a jittered
  doubling schedule (a write that completes late still lands), entries
  are capped and expire after a TTL, and every entry at or below the
  served step is dropped, so memory stays O(1) under sustained
  corruption.
* :class:`ChaosPublisher` — executes the publish faults of a
  :class:`~repro_torch.core.faults.FaultPlan` (torn / corrupt snapshot
  writes, delayed / dropped publications, transient disk-full) and
  delegates clean publications to the real manager.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import random
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import (CheckpointManager, CheckpointPolicy,
                                    host_snapshot, latest_step,
                                    read_metadata, restore_checkpoint)
from repro_torch.convert import params_from_jax, to_reference_layout
from repro_torch.core import env
from repro_torch.core.faults import FaultPlan
from repro_torch.models import Model

Tree = Any

__all__ = ["ChaosPublisher", "SnapshotPublisher", "SnapshotWatcher"]


class SnapshotPublisher:
    """Trainer-side publisher: versioned serving snapshots, written
    asynchronously with retention.

    With ``cfg`` the params (a :class:`~repro_torch.models.Model` or its
    :meth:`~repro_torch.models.Model.tree`) are written in the
    reference's layout; without, the tree is written as it is (the
    cluster's ``{"w": …}``).  ``every_steps`` is the cadence of
    :meth:`maybe_publish`; :meth:`publish` writes unconditionally.
    ``keep`` old snapshots stay on disk so a watcher mid-load never sees
    its file deleted under it (``keep=0`` disables GC: the cluster needs
    every version addressable).  Transient write failures retry with
    backoff inside the writer thread.
    """

    def __init__(self, out_dir: str, cfg=None, *,
                 every_steps: Optional[int] = None, keep: int = 3,
                 async_write: bool = True):
        self.out_dir = out_dir
        self.cfg = cfg
        self._mgr = CheckpointManager(
            out_dir, CheckpointPolicy(every_steps=every_steps),
            keep=keep, async_write=async_write)
        self.published = 0

    def maybe_publish(self, step: int, params: Tree,
                      metadata: Optional[dict] = None) -> bool:
        """Publish iff the step cadence fires; returns whether it did."""
        if not self._mgr.should_save(step):
            return False
        self.publish(step, params, metadata)
        return True

    def publish(self, step: int, params: Tree,
                metadata: Optional[dict] = None, *,
                block: bool = False) -> None:
        """Copy ``params`` to the host and enqueue the atomic write."""
        meta = {"kind": "serving_snapshot", "version": step,
                **(metadata or {})}
        tree = host_snapshot(params.tree() if isinstance(params, Model)
                             else params)
        if self.cfg is not None:
            tree = to_reference_layout(tree, self.cfg)
        self._mgr.save(step, tree, meta, block=block)
        self.published += 1

    def wait(self) -> None:
        """Block until every enqueued snapshot is on disk."""
        self._mgr.wait()

    def close(self) -> None:
        """Drain pending publications and stop the writer."""
        self._mgr.close()

    def __enter__(self) -> "SnapshotPublisher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
            return
        try:                    # never mask the in-flight body exception
            self.close()
        except Exception:
            pass


class ChaosPublisher(SnapshotPublisher):
    """A :class:`SnapshotPublisher` that executes a fault plan.

    Each :meth:`publish` call is a *publication index* (0, 1, 2, ...)
    looked up in the plan (:meth:`~repro_torch.core.faults.FaultPlan.
    publish_fault`); covered indices execute the fault instead of, or on
    top of, the clean write:

    * ``torn_snapshot`` — a truncated npz with **no sidecar**: invisible
      to ``latest_step``;
    * ``corrupt_snapshot`` — junk npz *plus* a valid sidecar: the watcher
      discovers it, fails to load it and backs off;
    * ``delay_publish`` — sleep ``seconds``, then publish;
    * ``drop_publish`` — swallow the publication;
    * ``disk_full`` — a one-shot ``ENOSPC`` in the writer, which the
      manager's retry absorbs.

    ``counters`` (``torn``, ``corrupt``, ``delayed``, ``dropped``,
    ``disk_full``) record what fired.
    """

    def __init__(self, out_dir: str, plan: FaultPlan, cfg=None, **kw):
        super().__init__(out_dir, cfg, **kw)
        self.plan = plan
        self.index = 0
        self.counters: Dict[str, int] = {
            "torn": 0, "corrupt": 0, "delayed": 0, "dropped": 0,
            "disk_full": 0}

    def publish(self, step: int, params: Tree,
                metadata: Optional[dict] = None, *,
                block: bool = False) -> None:
        """Publish with the plan's fault (if any) applied to this index."""
        ev = self.plan.publish_fault(self.index)
        self.index += 1
        if ev is None:
            super().publish(step, params, metadata, block=block)
            return
        if ev.kind == "torn_snapshot":
            self._write_junk(step, sidecar=False)
            self.counters["torn"] += 1
        elif ev.kind == "corrupt_snapshot":
            self._write_junk(step, sidecar=True)
            self.counters["corrupt"] += 1
        elif ev.kind == "delay_publish":
            time.sleep(ev.seconds)
            self.counters["delayed"] += 1
            super().publish(step, params, metadata, block=block)
        elif ev.kind == "drop_publish":
            self.counters["dropped"] += 1
        elif ev.kind == "disk_full":
            self.counters["disk_full"] += 1
            self._mgr.inject_write_fault(
                OSError(errno.ENOSPC, "No space left on device (injected)"))
            super().publish(step, params, metadata, block=block)

    def _write_junk(self, step: int, *, sidecar: bool) -> None:
        """Write a deliberately unloadable snapshot for version ``step``."""
        base = os.path.join(self.out_dir, f"step_{step:08d}.npz")
        if sidecar:
            with open(base + ".json", "w") as f:
                json.dump({"kind": "serving_snapshot", "version": step}, f)
        with open(base, "wb") as f:
            f.write(b"PK\x03\x04 this is not a real npz")


@dataclasses.dataclass
class _BadStep:
    """Blacklist entry: failure count + when to retry next."""

    first_seen: float
    fails: int
    next_retry: float


def _device(device) -> torch.device:
    """``device`` with the current CUDA index filled in, as tensors
    report theirs."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class SnapshotWatcher:
    """Server-side poller: loads the newest complete snapshot from a
    directory as a :class:`~repro_torch.models.Model` of ``cfg`` on
    ``device`` (the serving engine's; there is no default, so a model
    never lands on the CPU by accident).

    ``template`` is a parameter tree of ``cfg`` in the reference's
    layout with numpy leaves, e.g.
    :func:`repro_torch.convert.params_to_numpy` of a model of ``cfg``:
    its leaves give the shapes and dtypes the snapshot must have.

    ``poll()`` is cheap when nothing changed (one ``listdir``).  Any
    failure to load a candidate step — torn npz, shape or key mismatch
    from another config, a file deleted between list and read —
    blacklists that step and keeps the current version serving; a newer
    step is still picked up.  Blacklisted steps are retried on a
    jittered exponential-backoff schedule (base ``PSP_BUS_BACKOFF_BASE``,
    doubling per failure up to ``PSP_BUS_BACKOFF_MAX``); the blacklist
    holds at most ``PSP_BUS_BLACKLIST_MAX`` entries (oldest evicted
    first), each expiring after ``PSP_BUS_BLACKLIST_TTL`` seconds, and
    every entry at or below the served step is dropped on a swap.
    ``strict=True`` re-raises instead (tests, one-shot restore).
    """

    def __init__(self, watch_dir: str, template: Tree, cfg, device, *,
                 strict: bool = False,
                 backoff_base: Optional[float] = None,
                 backoff_max: Optional[float] = None,
                 blacklist_max: Optional[int] = None,
                 blacklist_ttl: Optional[float] = None,
                 jitter_seed: Optional[int] = None):
        self.watch_dir = watch_dir
        self.template = template
        self.cfg = cfg
        self.device = _device(device)
        self.strict = strict
        self.loaded_step: Optional[int] = None
        self.bad_steps: Dict[int, _BadStep] = {}
        self.skipped = 0          # failed load attempts (incl. retries)
        self.retries = 0          # backoff-scheduled re-attempts
        self.backoff_base = (env.get_float("PSP_BUS_BACKOFF_BASE")
                             if backoff_base is None else backoff_base)
        self.backoff_max = (env.get_float("PSP_BUS_BACKOFF_MAX")
                            if backoff_max is None else backoff_max)
        self.blacklist_max = (env.get_int("PSP_BUS_BLACKLIST_MAX")
                              if blacklist_max is None else blacklist_max)
        self.blacklist_ttl = (env.get_float("PSP_BUS_BLACKLIST_TTL")
                              if blacklist_ttl is None else blacklist_ttl)
        self._rng = random.Random(jitter_seed)

    def poll(self) -> Optional[Tuple[Model, int]]:
        """Return ``(model, version)`` if a new snapshot is loadable."""
        now = time.monotonic()
        self._evict(now)
        step = latest_step(self.watch_dir)
        if step is None or step == self.loaded_step:
            return None
        bad = self.bad_steps.get(step)
        if bad is not None and now < bad.next_retry:
            return None                       # backing off, serve stale
        if bad is not None:
            self.retries += 1
        try:
            params, _ = restore_checkpoint(self.watch_dir, self.template,
                                           step)
            meta = read_metadata(self.watch_dir, step)
        except Exception:
            if self.strict:
                raise
            self._record_failure(step, bad, now)
            return None
        model = params_from_jax(params, self.cfg, self.device)
        self.loaded_step = step
        # nothing at/below the served step can ever be selected again
        self.bad_steps = {s: b for s, b in self.bad_steps.items()
                          if s > step}
        return model, int(meta.get("version", step))

    def _record_failure(self, step: int, bad: Optional[_BadStep],
                        now: float) -> None:
        """Blacklist ``step`` (or push its retry horizon further out)."""
        self.skipped += 1
        if bad is None:
            bad = _BadStep(first_seen=now, fails=0, next_retry=now)
            self.bad_steps[step] = bad
            while len(self.bad_steps) > max(1, self.blacklist_max):
                del self.bad_steps[min(self.bad_steps)]   # oldest step out
        bad.fails += 1
        delay = min(self.backoff_base * (2.0 ** (bad.fails - 1)),
                    self.backoff_max)
        bad.next_retry = now + delay * (1.0 + 0.5 * self._rng.random())

    def _evict(self, now: float) -> None:
        """Expire blacklist entries older than the retention TTL."""
        if not self.bad_steps:
            return
        self.bad_steps = {
            s: b for s, b in self.bad_steps.items()
            if now - b.first_seen <= self.blacklist_ttl}
