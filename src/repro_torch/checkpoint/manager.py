"""Checkpoint manager: save policies, async writer, retention.

The port's counterpart of :mod:`repro.checkpoint.manager`.  The storage
format (:mod:`repro_torch.checkpoint.checkpoint`) is a dumb atomic
npz writer; this layer decides *when* to save and keeps the write off the
training critical path, Levanter-style:

* **policies** — save every N steps (:attr:`CheckpointPolicy.every_steps`)
  and/or every T wall-clock seconds (:attr:`CheckpointPolicy.every_seconds`);
  either trigger fires a save.  Step policies give the deterministic
  cadence the kill-and-resume equivalence tests pin; time policies bound
  the work lost to a crash on slow configs where a step cadence would be
  hours apart.  Resume correctness never depends on *when* a checkpoint
  was cut — restore is exact for any published step.
* **async writer** — :meth:`CheckpointManager.save` copies the state to
  host memory synchronously (:func:`host_snapshot`: the trainer updates
  its tensors in place, so the copy must be finished before ``save``
  returns) and hands the serialization + rename to a single background
  thread, so training resumes immediately.  A bounded
  queue applies back-pressure instead of accumulating unbounded snapshots
  when the disk is slower than the save cadence.
* **retention / GC** — after each successful write the writer thread keeps
  the newest ``keep`` checkpoints and deletes the rest (npz + sidecar).
* **crash hygiene** — construction removes stale ``*.tmp`` staging files
  and orphan sidecars (a ``.json`` whose ``.npz`` never got published)
  left behind by a killed process, so a resumed run starts from a clean
  directory.

Typical wiring (``repro_torch.launch.train``)::

    with CheckpointManager(dir, CheckpointPolicy(every_steps=50)) as mgr:
        for t in range(start, steps):
            state = step(state)
            mgr.maybe_save(t + 1, state, metadata={"data_step": t + 1})
        mgr.save(steps, state, metadata=..., block=True)
"""
from __future__ import annotations

import dataclasses
import glob
import os
import queue
import re
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import latest_step, save_checkpoint
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["CheckpointPolicy", "CheckpointManager", "host_snapshot"]


def _host_copy(leaf):
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)   # waits for the device
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()                        # numpy has no bfloat16
    return t.numpy()


def host_snapshot(tree: PyTree) -> PyTree:
    """Copy every tensor leaf of ``tree`` to a host numpy array
    (bfloat16 as float32); numpy leaves pass as they are.

    This is the synchronous half of an async save: the copy is finished
    when this returns, so the training loop may overwrite its tensors in
    place while the writer thread serializes at leisure.
    """
    return tree_map(_host_copy, tree)


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """When to cut a checkpoint (either trigger suffices).

    ``every_steps=None`` disables the step cadence, ``every_seconds=None``
    the wall-clock cadence; with both ``None`` only explicit
    :meth:`CheckpointManager.save` calls (e.g. the final save) write.
    """

    every_steps: Optional[int] = None      # save when step % every_steps == 0
    every_seconds: Optional[float] = None  # save when this much wall time passed

    def __post_init__(self):
        if self.every_steps is not None and self.every_steps <= 0:
            raise ValueError(f"every_steps must be positive, "
                             f"got {self.every_steps}")
        if self.every_seconds is not None and self.every_seconds <= 0:
            raise ValueError(f"every_seconds must be positive, "
                             f"got {self.every_seconds}")


class CheckpointManager:
    """Policy-driven async checkpointer over one directory.

    Thread model: one daemon writer thread consumes a bounded queue of
    ``(step, host_tree, metadata)`` snapshots; every disk operation
    (write, rename, GC) happens on that thread, so publication order is
    the enqueue order and retention never races a write.  ``wait()``
    drains the queue (tests and final saves); ``close()`` drains and
    joins.  The manager is also a context manager — the ``with`` exit
    closes it.
    """

    def __init__(self, ckpt_dir: str, policy: CheckpointPolicy | None = None,
                 *, keep: int = 3, async_write: bool = True,
                 queue_size: int = 2, write_retries: int = 3,
                 retry_backoff: float = 0.1):
        self.ckpt_dir = ckpt_dir
        self.policy = policy or CheckpointPolicy()
        self.keep = keep
        self._async = async_write
        self.write_retries = write_retries
        self.retry_backoff = retry_backoff
        self.retried_writes = 0
        self._last_save_time = time.monotonic()
        self._last_saved_step: Optional[int] = None
        os.makedirs(ckpt_dir, exist_ok=True)
        self._clean_stale()
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._error: Optional[BaseException] = None
        self._injected_faults: list = []
        self._thread: Optional[threading.Thread] = None
        if async_write:
            self._thread = threading.Thread(target=self._writer_loop,
                                            name="ckpt-writer", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ #
    # policy
    # ------------------------------------------------------------------ #
    def should_save(self, step: int) -> bool:
        """Does the policy call for a checkpoint at ``step``?"""
        if step == self._last_saved_step:
            return False
        p = self.policy
        if p.every_steps is not None and step % p.every_steps == 0:
            return True
        if (p.every_seconds is not None
                and time.monotonic() - self._last_save_time >= p.every_seconds):
            return True
        return False

    def maybe_save(self, step: int, tree: PyTree,
                   metadata: Optional[dict] = None) -> bool:
        """Save iff the policy fires; returns whether a save was enqueued."""
        if not self.should_save(step):
            return False
        self.save(step, tree, metadata)
        return True

    # ------------------------------------------------------------------ #
    # saving
    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: PyTree, metadata: Optional[dict] = None,
             *, block: bool = False) -> None:
        """Snapshot ``tree`` to host and enqueue the write.

        The device→host copy happens here, on the caller's thread — after
        this returns the caller may mutate/donate its buffers.  With
        ``block=True`` (or a sync manager) the write is also drained
        before returning.
        """
        self._raise_writer_error()
        snap = host_snapshot(tree)
        self._last_save_time = time.monotonic()
        self._last_saved_step = step
        if self._thread is None:
            self._write(step, snap, metadata)
        else:
            self._queue.put((step, snap, metadata))
            if block:
                self.wait()

    def wait(self) -> None:
        """Block until every enqueued checkpoint is on disk."""
        if self._thread is not None:
            self._queue.join()
        self._raise_writer_error()

    def close(self) -> None:
        """Drain pending writes and stop the writer thread."""
        if self._thread is not None:
            self._queue.join()
            self._queue.put(None)           # sentinel: writer exits
            self._thread.join()
            self._thread = None
        self._raise_writer_error()

    def latest_step(self) -> Optional[int]:
        """Newest restorable step in this manager's directory."""
        return latest_step(self.ckpt_dir)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Close on exit; surface writer errors without masking the body.

        A clean ``with`` exit drains and raises any pending writer error
        (the regression the shutdown tests pin).  When the body is
        *already* raising, the writer error must not replace it — the
        original exception stays primary and the writer failure is
        attached as its ``__context__`` via an ordinary chained raise
        swallowed here.
        """
        if exc_type is None:
            self.close()
            return
        try:
            self.close()
        except Exception:
            pass                # body exception stays primary

    def inject_write_fault(self, exc: BaseException) -> None:
        """Chaos hook: make the next write attempt raise ``exc`` once.

        Each injected fault consumes exactly one *attempt* (not one
        save), so ``write_retries >= 1`` turns a single injection into a
        transparently retried transient failure — the path the
        disk-full fault plan and the retry regression tests drive.
        """
        self._injected_faults.append(exc)

    # ------------------------------------------------------------------ #
    # writer thread
    # ------------------------------------------------------------------ #
    def _raise_writer_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint writer thread failed") from err

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, snap, metadata = item
            try:
                self._write(step, snap, metadata)
            except BaseException as e:          # surfaced on next save/wait
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step, snap, metadata):
        """One write, retried with exponential backoff on transient errors.

        ``write_retries`` extra attempts, sleeping ``retry_backoff * 2^i``
        between them — a full disk or flaky mount heals without losing
        the checkpoint; exhausted retries re-raise the last error (into
        ``self._error`` on the async path).
        """
        for attempt in range(self.write_retries + 1):
            try:
                if self._injected_faults:
                    raise self._injected_faults.pop(0)
                save_checkpoint(self.ckpt_dir, step, snap, metadata)
                self._gc()
                return
            except (OSError, IOError):
                if attempt >= self.write_retries:
                    raise
                self.retried_writes += 1
                time.sleep(self.retry_backoff * (2.0 ** attempt))

    def _gc(self):
        """Keep the newest ``keep`` published checkpoints, delete the rest."""
        if self.keep is None or self.keep <= 0:
            return
        steps = sorted(
            int(m.group(1)) for fn in os.listdir(self.ckpt_dir)
            if (m := re.match(r"step_(\d+)\.npz$", fn)))
        for s in steps[:-self.keep]:
            base = os.path.join(self.ckpt_dir, f"step_{s:08d}.npz")
            for path in (base, base + ".json"):
                try:
                    os.remove(path)
                except OSError:
                    pass

    # ------------------------------------------------------------------ #
    # crash hygiene
    # ------------------------------------------------------------------ #
    def _clean_stale(self):
        """Remove ``*.tmp`` staging files and orphan sidecars.

        Both are leftovers of a process killed mid-save: staging files
        never renamed, and sidecars published whose npz rename (the last
        step) never happened.  Only run at construction — a live writer
        in *this* process always publishes npz-last, so anything matching
        here is garbage from a previous life.
        """
        for tmp in glob.glob(os.path.join(self.ckpt_dir, "*.tmp")):
            try:
                os.remove(tmp)
            except OSError:
                pass
        for side in glob.glob(os.path.join(self.ckpt_dir,
                                           "step_*.npz.json")):
            if not os.path.exists(side[:-len(".json")]):
                try:
                    os.remove(side)
                except OSError:
                    pass
