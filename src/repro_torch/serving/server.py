"""Inference server: admission queue + background decode worker.

The port's counterpart of :mod:`repro.serving.server`.  JetStream-offline
inference shape: callers from any thread ``submit()``
into a bounded admission queue and get a ``concurrent.futures.Future``
back; one worker thread owns the :class:`ServingEngine` outright and
loops

    drain inbox → (every ``poll_every`` ticks) poll the snapshot
    watcher and hot-swap → ``engine.step()`` → resolve futures

so the engine never needs locks.  On a CUDA engine the worker thread
makes the engine's device current before it touches it.  Back-pressure is the queue bound:
``submit`` blocks (or raises, with ``block=False``) when the server is
``max_queue`` requests behind.  Requests are never dropped — a swap only
redirects *future* admissions (see :meth:`ServingEngine.set_params`),
and shutdown drains in-flight work before the worker exits.

The worker also keeps the latency book: per-token wall-clock stamps from
``StepResult.emitted``, per-request first-token/total latency, and the
``swap_stall`` — wall time the decode loop spent loading a snapshot
inside :meth:`SnapshotWatcher.poll`, which is exactly the serving-side
cost of a hot-swap.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import torch

from repro_torch.serving.engine import Completion, Request, ServingEngine
from repro_torch.serving.snapshot_bus import SnapshotWatcher

__all__ = ["InferenceServer", "ServerStats"]


@dataclasses.dataclass
class ServerStats:
    """Counters + raw latency samples (seconds) for one server run."""

    submitted: int = 0
    completed: int = 0
    swaps: int = 0
    snapshots_skipped: int = 0
    steps: int = 0
    timeouts: int = 0           # requests failed on their deadline
    worker_restarts: int = 0    # decode-worker crash recoveries
    readmitted: int = 0         # requests re-submitted after a crash
    token_times: List[float] = dataclasses.field(default_factory=list)
    first_token_lat: List[float] = dataclasses.field(default_factory=list)
    request_lat: List[float] = dataclasses.field(default_factory=list)
    swap_stalls: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Tracked:
    future: Future
    t_submit: float
    request: Request            # original request (worker-death re-admission)
    t_first: Optional[float] = None


class InferenceServer:
    """Threaded front-end over a :class:`ServingEngine`.

    ``watcher=None`` serves a fixed snapshot; with a watcher the worker
    polls every ``poll_every`` decode ticks (and when idle); it must
    build its models on the engine's device.  Use as a
    context manager or call :meth:`shutdown`.
    """

    def __init__(self, engine: ServingEngine, *,
                 watcher: Optional[SnapshotWatcher] = None,
                 max_queue: int = 256, poll_every: int = 8,
                 idle_wait: float = 0.01, max_restarts: int = 2):
        if watcher is not None and watcher.device != engine.device:
            raise ValueError(f"the watcher builds models on "
                             f"{watcher.device}, the engine serves on "
                             f"{engine.device}")
        self.engine = engine
        self.watcher = watcher
        self.poll_every = poll_every
        self.max_restarts = max_restarts
        self.stats = ServerStats()
        self._inbox: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._tracked: Dict[int, _Tracked] = {}
        # every snapshot this server has served, pruned to versions still
        # pinned by a live group — the book worker-death re-admission
        # reads to rebuild a cohort on its original params
        self._params_history: Dict[int, object] = {engine.version:
                                                   engine.params}
        self._idle_wait = idle_wait
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._fault: Optional[BaseException] = None
        self._restarts = 0
        self._thread = threading.Thread(target=self._worker,
                                        name="serve-worker", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    # caller side (any thread)
    # ------------------------------------------------------------------ #
    def submit(self, req: Request, *, block: bool = True,
               timeout: Optional[float] = None) -> "Future[Completion]":
        """Enqueue a request; the future resolves to its Completion.

        Blocks when the admission queue is full (back-pressure); with
        ``block=False`` raises ``queue.Full`` instead.
        """
        self._raise_worker_error()
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        fut: "Future[Completion]" = Future()
        self._inbox.put((req, fut, time.monotonic()), block=block,
                        timeout=timeout)
        return fut

    def inject_worker_fault(self, exc: Optional[BaseException] = None) -> None:
        """Chaos hook: make the decode worker raise at its next tick.

        The fault-plan ``kill`` event for the serving tier (one decode
        worker per server — :meth:`repro_torch.core.faults.FaultPlan.
        serving_kill_index`) lands here: the worker thread raises,
        recovery re-admits in-flight requests on their pinned snapshots
        (bit-exact under greedy decode) and the loop continues, up to
        ``max_restarts`` times.
        """
        self._fault = exc or RuntimeError("injected decode-worker fault")

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` (default) finish all admitted
        and queued work first so no request is dropped."""
        self._stop.set()
        self._thread.join()
        if drain:
            self._drain_inbox()
            while self.engine.has_pending():
                self._tick(poll=False)
        # anything still unresolved (drain=False) fails loudly
        for tr in self._tracked.values():
            if not tr.future.done():
                tr.future.set_exception(RuntimeError("server shut down"))
        self._tracked.clear()
        self._raise_worker_error()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------ #
    # worker side (single thread owns the engine)
    # ------------------------------------------------------------------ #
    def _worker(self):
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        while True:
            try:
                self._serve_loop()
                return                          # clean stop
            except BaseException as e:
                if self._stop.is_set() or self._restarts >= self.max_restarts:
                    self._error = e             # surfaced to callers
                    self._stop.set()
                    return
                self._restarts += 1
                self.stats.worker_restarts += 1
                try:
                    self._recover()
                except BaseException as e2:     # recovery itself died
                    self._error = e2
                    self._stop.set()
                    return

    def _serve_loop(self):
        while not self._stop.is_set():
            if self._fault is not None:
                exc, self._fault = self._fault, None
                raise exc
            got = self._drain_inbox()
            self._check_deadlines(time.monotonic())
            if not self.engine.has_pending():
                self._poll_watcher()            # swap while idle is free
                if not got:
                    time.sleep(self._idle_wait)
                continue
            self._tick(poll=self.stats.steps % self.poll_every == 0)

    def _recover(self):
        """Worker-death re-admission: rebuild the engine's request book.

        The crashed step may have left groups inconsistent, so the
        engine is reset and every live request re-submitted from the
        server's own copy — in-flight requests **per version cohort on
        the exact snapshot their group pinned** (``set_params`` to the
        pinned version, submit, ``admit_queued`` to pin the fresh group
        before moving on), still-queued requests last under the current
        snapshot.  Re-decoding restarts each request from token zero,
        which under greedy decode reproduces the identical completion
        (same params, same prompt ⇒ same argmax path) — the re-admitted
        future resolves bit-exact to what the uninterrupted decode would
        have returned.  Per-token latency samples of replayed tokens are
        counted twice in ``stats.token_times``; completions are not.
        """
        latest = (self.engine.params, self.engine.version)
        versions = self.engine.request_versions()
        self.engine.reset()
        cohorts: Dict[Optional[int], List[int]] = {}
        for rid, ver in versions.items():
            if rid in self._tracked:
                cohorts.setdefault(ver, []).append(rid)
        for ver in sorted(v for v in cohorts if v is not None):
            params = self._params_history.get(ver)
            if params is None:                  # history pruned: serve fresh
                params, ver_pin = latest
            else:
                ver_pin = ver
            self.engine.set_params(params, ver_pin)
            self._resubmit(cohorts[ver])
            self.engine.admit_queued()          # pin the cohort's groups
        self.engine.set_params(*latest)
        self._resubmit(cohorts.get(None, []))

    def _resubmit(self, rids: List[int]):
        for rid in rids:
            tr = self._tracked.pop(rid)
            new_rid = self.engine.submit(tr.request)
            self._tracked[new_rid] = tr
            self.stats.readmitted += 1

    def _drain_inbox(self) -> bool:
        got = False
        while True:
            try:
                req, fut, t_sub = self._inbox.get_nowait()
            except queue.Empty:
                return got
            got = True
            if (req.deadline_s is not None
                    and time.monotonic() - t_sub > req.deadline_s):
                self.stats.timeouts += 1        # expired while queued
                fut.set_exception(TimeoutError(
                    f"request missed its {req.deadline_s}s deadline "
                    "in the admission queue"))
                continue
            try:
                rid = self.engine.submit(req)
            except ValueError as e:             # unservable request
                fut.set_exception(e)
                continue
            self._tracked[rid] = _Tracked(fut, t_sub, req)
            self.stats.submitted += 1

    def _check_deadlines(self, now: float):
        """Fail + cancel tracked requests past their deadline."""
        expired = [rid for rid, tr in self._tracked.items()
                   if tr.request.deadline_s is not None
                   and now - tr.t_submit > tr.request.deadline_s]
        for rid in expired:
            tr = self._tracked.pop(rid)
            self.engine.cancel(rid)
            self.stats.timeouts += 1
            tr.future.set_exception(TimeoutError(
                f"request exceeded its {tr.request.deadline_s}s deadline"))

    def _poll_watcher(self):
        if self.watcher is None:
            return
        t0 = time.monotonic()
        loaded = self.watcher.poll()
        self.stats.snapshots_skipped = self.watcher.skipped
        if loaded is None:
            return
        params, version = loaded
        self.engine.set_params(params, version)
        self._params_history[version] = params
        live = set(self.engine.live_versions()) | {version}
        for v in [v for v in self._params_history if v not in live]:
            del self._params_history[v]
        self.stats.swaps += 1
        self.stats.swap_stalls.append(time.monotonic() - t0)

    def _tick(self, *, poll: bool):
        if poll:
            self._poll_watcher()
        self._check_deadlines(time.monotonic())
        res = self.engine.step()
        now = time.monotonic()
        self.stats.steps += 1
        for rid, _tok in res.emitted:
            self.stats.token_times.append(now)
            tr = self._tracked.get(rid)
            if tr is not None and tr.t_first is None:
                tr.t_first = now
                self.stats.first_token_lat.append(now - tr.t_submit)
        for comp in res.completions:
            tr = self._tracked.pop(comp.req_id, None)
            self.stats.completed += 1
            if tr is not None:
                self.stats.request_lat.append(now - tr.t_submit)
                tr.future.set_result(comp)

    def _raise_worker_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("serve worker thread failed") from err
