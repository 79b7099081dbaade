"""Multi-process PSP cluster: coordinator + worker subprocesses over the bus.

The port's counterpart of :mod:`repro.launch.cluster`.  This is the
real-process counterpart of the in-process elastic trainer: a
coordinator owns the :class:`~repro_torch.core.spmd_psp.PSPState` and drives
the tick loop, while N worker subprocesses compute gradients on their
own (possibly stale) snapshot views.  Everything rides the snapshot-bus
file protocol — no sockets, no RPC:

* ``server/``   — the coordinator's :class:`SnapshotPublisher` output:
  version ``v`` is the server params after ``v`` ticks (``v=0`` is the
  init), published every tick with GC disabled so any version a worker
  is told to compute on stays addressable (version-addressed pulls are
  what make the run race-free *and* bit-exact).
* ``ticks/current.json`` — the coordinator's work order (atomic
  replace): tick number, the pushing worker set, and the exact snapshot
  version each pusher's view must be at.  Workers poll it.
* ``pushes/push_t<t>_w<w>.npz`` — a pusher's gradient + loss for one
  tick (atomic tmp+rename).
* ``hb/worker_<w>.json`` — per-worker heartbeat sidecar, written by a
  background thread in the worker on a ``PSP_HB_INTERVAL`` cadence.
  The coordinator detects *death* by ``proc.poll()`` and *hangs* by
  heartbeat staleness (``PSP_HB_TIMEOUT``), escalating a hang to
  SIGKILL.  A fault-injected ``stall`` keeps heartbeating — a stalled
  worker is a straggler to wait for, not a corpse.

Real churn maps onto the elastic trainer's own machinery
(:func:`repro_torch.core.spmd_psp.apply_external_churn`): an observed death is
a *leave* at the current tick; a supervisor respawn that has restored
the latest published snapshot and heartbeats ready is a *join* — the
coordinator re-anchors it exactly like a churn joiner (fresh pull of the
server model, restart at the max alive step, same-tick decide, gradient
masked out of this tick's push).  Live workers are never restarted.

Devices: the coordinator and every worker run on ``--device``: the card
by default, ``cpu`` where asked (the tests).  Workers are fresh
interpreters (``sys.executable -m``), never forks of a process that
touched CUDA.

Determinism: with ``churn=None`` the coordinator owns the run's one
:class:`~repro_torch.core.spmd_psp.GeneratorNoise` and draws each tick's
record exactly where the in-process trainer does; a worker replays the
minibatch stream of :func:`~repro_torch.core.spmd_psp.elastic_drive`
(``_batches``, fast-forwarded to the ordered tick) and computes its
gradient with the same function, on the same shapes, holding its view as
row ``w`` of a ``[W, dim]`` buffer as the trainer holds it; a
non-pusher's gradient is masked to zero by the tick either way.  So
replaying a run's recorded membership events through
:func:`~repro_torch.core.spmd_psp.external_drive` on the same device
reproduces the final server params bit for bit
(``tests/test_torch_cluster.py``).  This does not rest on the
reference's solo-grad ≡ vmap-row identity: the port's trainer computes
each worker's gradient in a loop, as a worker does.

Fault injection: a :class:`~repro_torch.core.faults.FaultPlan` (CLI ``--plan``
or the ``PSP_FAULT_PLAN`` env knob) schedules SIGKILLs (executed by the
coordinator at tick boundaries, including correlated rack groups) and
stalls/hangs (executed by the targeted worker on itself).

CLI::

    PYTHONPATH=src python -m repro_torch.launch.cluster --device cpu \\
        --workers 3 --ticks 30 --dim 16 --plan kill-one \\
        --tick-min-wall 0.5 --dir /tmp/psp_cluster
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core import env
from repro_torch.core.faults import FaultPlan, make_plan, plan_from_env
from repro_torch.core.spmd_psp import (GeneratorNoise, PSPConfig, _batches,
                                       apply_external_churn,
                                       linear_psp_state, linear_psp_task,
                                       psp_apply_tick)
from repro_torch.serving.snapshot_bus import SnapshotPublisher

__all__ = ["run_cluster", "main"]

_POLL = 0.005                   # file-poll cadence (seconds)


# --------------------------------------------------------------------------- #
# small atomic-file helpers (the bus idiom: tmp + rename)
# --------------------------------------------------------------------------- #
def _atomic_json(path: str, obj: dict) -> None:
    """Write ``obj`` as JSON atomically (tmp + rename)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    """Read a JSON file, returning ``None`` when absent or mid-replace."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _atomic_npz(path: str, **arrays) -> None:
    """Write an npz atomically (tmp + rename)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


# --------------------------------------------------------------------------- #
# worker side
# --------------------------------------------------------------------------- #
class _Heartbeat(threading.Thread):
    """Daemon thread writing the worker's heartbeat sidecar.

    ``state`` advances ``boot`` → ``ready`` (snapshot restored) → worker
    progress is visible via ``tick``.  ``suspended`` silences the beat —
    the ``hang`` fault uses it so the coordinator's staleness detector
    has something real to catch (a ``stall`` keeps beating).
    """

    def __init__(self, path: str, worker: int, epoch: int, interval: float):
        super().__init__(name=f"hb-{worker}", daemon=True)
        self.path = path
        self.worker = worker
        self.epoch = epoch
        self.interval = interval
        self.state = "boot"
        self.tick = -1
        self.suspended = False
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def beat(self) -> None:
        """Write one heartbeat record now (atomic).  The worker's main
        thread and the beat thread both call this, and both would stage
        the record under one temporary name: the lock keeps the second
        writer from losing its rename (``FileNotFoundError``)."""
        with self._lock:
            _atomic_json(self.path, {
                "pid": os.getpid(), "worker": self.worker,
                "epoch": self.epoch, "time": time.time(),
                "state": self.state, "tick": self.tick})

    def run(self):
        while not self._stop.is_set():
            if not self.suspended:
                try:
                    self.beat()
                except OSError:
                    pass                    # workdir vanished: dying anyway
            self._stop.wait(self.interval)

    def stop(self) -> None:
        """Stop the beat (worker exit)."""
        self._stop.set()


def _wait_restore(server_dir: str, template, step: Optional[int],
                  timeout: float):
    """Restore a (possibly not-yet-published) snapshot, waiting for it.

    ``step=None`` waits for *any* version (worker warm start), otherwise
    for that exact version — the coordinator publishes asynchronously,
    so a pusher may be told to compute on a version still in the writer
    queue.  Raises ``TimeoutError`` past ``timeout`` seconds.
    """
    deadline = time.monotonic() + timeout
    while True:
        try:
            have = latest_step(server_dir)
            if have is not None and (step is None or
                                     os.path.exists(os.path.join(
                                         server_dir,
                                         f"step_{step:08d}.npz"))):
                return restore_checkpoint(server_dir, template, step)
        except (OSError, ValueError, KeyError):
            pass                            # racing the publisher: retry
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"version {step} never appeared in {server_dir}")
        time.sleep(_POLL)


def _worker_main(a: argparse.Namespace) -> int:
    """Worker subprocess entry: poll orders, compute, push, heartbeat.

    The worker replays the minibatch stream of
    :func:`~repro_torch.core.spmd_psp.elastic_drive`, fast-forwarded to
    the ordered tick, restores its view at exactly the version the order
    names (into row ``w`` of a ``[W, dim]`` buffer, the trainer's
    layout), computes its gradient and pushes it atomically.  Non-pusher
    ticks are acknowledged by heartbeat only.
    """
    dev = torch.device(a.device)
    hb_int = a.hb_interval or env.get_float("PSP_HB_INTERVAL")
    hb = _Heartbeat(os.path.join(a.dir, "hb", f"worker_{a.worker}.json"),
                    a.worker, a.epoch, hb_int)
    hb.beat()
    hb.start()

    plan = None
    plan_path = os.path.join(a.dir, "plan.json")
    if os.path.exists(plan_path):
        with open(plan_path) as f:
            plan = FaultPlan.from_json(f.read())
    my_events = sorted(plan.worker_events(a.worker),
                       key=lambda e: e.tick) if plan else []
    fired: set = set()

    template = {"w": torch.zeros(a.dim, device=dev)}
    w_true, grad_fn, _ = linear_psp_task(a.dim, lr=a.lr, seed=a.task_seed,
                                         device=dev)
    rows = torch.zeros((a.workers, a.dim), device=dev)
    server_dir = os.path.join(a.dir, "server")
    order_path = os.path.join(a.dir, "ticks", "current.json")

    # warm start: the churn-joiner restore path (latest published snapshot)
    _wait_restore(server_dir, template, None, a.io_timeout)
    view_version = -1                       # authoritative version per order
    hb.state = "ready"
    hb.beat()

    data = _batches(PSPConfig(n_workers=a.workers), w_true, a.batch,
                    a.batch_seed)
    drawn = 0
    last_done = -1
    while True:
        order = _read_json(order_path)
        if order is None:
            time.sleep(_POLL)
            continue
        if order.get("stop"):
            break
        t = int(order["tick"])
        if t <= last_done:
            time.sleep(_POLL)
            continue
        for i, ev in enumerate(my_events):  # due self-faults (stall/hang)
            if i in fired or ev.tick > t:
                continue
            fired.add(i)
            if ev.kind == "hang":
                hb.suspended = True         # go dark: hb staleness fires
                time.sleep(ev.seconds)
                hb.suspended = False
            else:
                time.sleep(ev.seconds)      # stall: keep heartbeating
        if a.worker in order["pushers"]:
            need = int(order["views"][str(a.worker)])
            out = os.path.join(a.dir, "pushes", f"push_t{t}_w{a.worker}.npz")
            if not os.path.exists(out):
                if need != view_version:
                    view, _ = _wait_restore(server_dir, template, need,
                                            a.io_timeout)
                    rows[a.worker] = view["w"]
                    view_version = need
                while drawn < t:            # fast-forward the batch stream
                    next(data)
                    drawn += 1
                x, y = next(data)           # the full draw, my row of it
                drawn += 1
                loss, grads = grad_fn({"w": rows[a.worker]},
                                      (x[a.worker], y[a.worker]))
                _atomic_npz(out, loss=loss.cpu().numpy(),
                            g0=grads["w"].cpu().numpy())
        last_done = t
        hb.tick = t
        hb.beat()
    hb.stop()
    return 0


# --------------------------------------------------------------------------- #
# coordinator side
# --------------------------------------------------------------------------- #
class _Supervisor:
    """Spawns, kills, and respawns worker subprocesses.

    One entry per worker slot: the live ``Popen`` (or ``None``), its
    spawn ``epoch`` (0 = original process; bumped per respawn), and the
    respawn timer.  Only *dead* workers are ever (re)spawned — the
    no-restart-of-live-workers property the kill-one test asserts via
    the recorded epochs.
    """

    def __init__(self, workdir: str, args: List[str], *,
                 restart_delay: float, max_respawns: int):
        self.workdir = workdir
        self.args = args
        self.restart_delay = restart_delay
        self.max_respawns = max_respawns
        self.procs: Dict[int, subprocess.Popen] = {}
        self.epochs: Dict[int, int] = {}
        self.respawns: Dict[int, int] = {}
        self.due: Dict[int, float] = {}     # worker -> respawn wall time
        self.logs: List = []

    def spawn(self, w: int) -> None:
        """Start worker ``w`` at its current epoch."""
        e = self.epochs.setdefault(w, 0)
        log = open(os.path.join(self.workdir, "logs",
                                f"worker_{w}.e{e}.log"), "ab")
        self.logs.append(log)
        child_env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = src + os.pathsep + \
            child_env.get("PYTHONPATH", "")
        self.procs[w] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.cluster", "--role",
             "worker", "--worker", str(w), "--epoch", str(e)] + self.args,
            stdout=log, stderr=subprocess.STDOUT, env=child_env)

    def kill(self, w: int) -> None:
        """SIGKILL worker ``w`` (fault execution / hang escalation)."""
        p = self.procs.get(w)
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)

    def reap_deaths(self, known_dead: set) -> List[int]:
        """Worker slots whose process exited since last asked."""
        out = []
        for w, p in self.procs.items():
            if w not in known_dead and p.poll() is not None:
                out.append(w)
        return out

    def schedule_respawn(self, w: int, now: float) -> bool:
        """Queue a respawn of dead worker ``w``; False when exhausted."""
        if self.respawns.get(w, 0) >= self.max_respawns:
            return False
        self.due[w] = now + self.restart_delay
        return True

    def fire_respawns(self, now: float) -> List[int]:
        """Respawn every due worker; returns the slots respawned."""
        fired = [w for w, at in self.due.items() if at <= now]
        for w in fired:
            del self.due[w]
            self.respawns[w] = self.respawns.get(w, 0) + 1
            self.epochs[w] = self.epochs.get(w, 0) + 1
            self.spawn(w)
        return fired

    def shutdown(self, grace: float = 5.0) -> None:
        """Reap everything: wait ``grace`` for clean exits, then kill."""
        deadline = time.monotonic() + grace
        for p in self.procs.values():
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(_POLL)
            if p.poll() is None:
                os.kill(p.pid, signal.SIGKILL)
                p.wait()
        for log in self.logs:
            log.close()


def _hb_age(workdir: str, w: int, now_wall: float) -> Optional[float]:
    """Seconds since worker ``w`` last heartbeat (None = no beat yet)."""
    hb = _read_json(os.path.join(workdir, "hb", f"worker_{w}.json"))
    if hb is None:
        return None
    return now_wall - float(hb.get("time", 0.0))


def _hb_ready(workdir: str, w: int, epoch: int) -> bool:
    """Has worker ``w``'s *current-epoch* process restored and reported?"""
    hb = _read_json(os.path.join(workdir, "hb", f"worker_{w}.json"))
    return (hb is not None and int(hb.get("epoch", -1)) == epoch
            and hb.get("state") in ("ready", "run"))


def run_cluster(cfg: PSPConfig, dim: int, ticks: int, workdir: str, *,
                batch: int = 16, lr: float = 0.1, task_seed: int = 0,
                init_seed: int = 1, batch_seed: int = 2,
                plan: Optional[FaultPlan] = None,
                hb_timeout: Optional[float] = None,
                restart_delay: float = 0.0, max_respawns: int = 1,
                tick_timeout: float = 120.0,
                tick_min_wall: float = 0.0, device: Any = "cuda") -> dict:
    """Drive a full multi-process cluster run; returns the outcome record.

    The coordinator publishes version 0, spawns ``cfg.n_workers`` worker
    subprocesses, and runs ``ticks`` lockstep ticks: observe membership
    changes (deaths → leaves, ready respawns → joins, via
    :func:`apply_external_churn`), issue the work order, execute due
    ``kill`` faults, collect pusher gradients (reissuing the order when
    a pusher dies mid-tick), apply the tick, publish the new version.
    ``cfg.churn`` must be ``None`` — process churn *is* the churn.

    ``tick_min_wall`` throttles the tick rate (seconds of wall clock per
    tick) so short test runs leave a respawned worker time to rejoin
    before the run ends.  The returned dict (also written to
    ``result.json``) carries the recorded membership ``events`` —
    ``[tick, "leave"|"join", worker]`` — whose replay through
    :func:`~repro_torch.core.spmd_psp.external_drive` on ``device`` must
    reproduce ``final_params`` bit-for-bit, plus per-victim recovery
    records and the spawn ``epochs`` proving live workers were never
    restarted.  The coordinator and the workers run on ``device``.
    """
    if cfg.has_churn:
        raise ValueError("run_cluster drives real process churn; pass a "
                         "churn=None PSPConfig")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu'")
    W = cfg.n_workers
    for sub in ("server", "ticks", "pushes", "hb", "logs"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)
    plan = plan or plan_from_env(n_workers=W, ticks=ticks)
    plan.save(os.path.join(workdir, "plan.json"))
    hb_timeout = hb_timeout if hb_timeout is not None \
        else env.get_float("PSP_HB_TIMEOUT")

    _, _, opt_update = linear_psp_task(dim, lr=lr, seed=task_seed,
                                       device=dev)
    noise = GeneratorNoise(init_seed, dev)
    state = linear_psp_state(cfg, dim, noise, dev)

    pub = SnapshotPublisher(os.path.join(workdir, "server"), keep=0,
                            async_write=True)
    pub.publish(0, state.server_params, block=True)

    worker_args = ["--dir", workdir, "--workers", str(W), "--dim", str(dim),
                   "--batch", str(batch), "--lr", str(lr),
                   "--task-seed", str(task_seed),
                   "--batch-seed", str(batch_seed),
                   "--io-timeout", str(tick_timeout), "--device", str(dev)]
    sup = _Supervisor(workdir, worker_args, restart_delay=restart_delay,
                      max_respawns=max_respawns)
    for w in range(W):
        sup.spawn(w)

    v_view = {w: 0 for w in range(W)}
    dead: set = set()
    events: List[Tuple[int, str, int]] = []
    recovery: Dict[int, dict] = {}
    order_path = os.path.join(workdir, "ticks", "current.json")
    wall0 = time.monotonic()
    issue = 0

    def observe_leaves(t: int) -> List[int]:
        """Newly dead workers → leave events at tick ``t``."""
        newly = sup.reap_deaths(dead)
        now = time.monotonic()
        for w in newly:
            dead.add(w)
            events.append((t, "leave", w))
            rec = recovery.setdefault(w, {})
            rec.setdefault("t_kill", now - wall0)
            if sup.schedule_respawn(w, now):
                rec["respawn_scheduled"] = True
        return newly

    try:
        for t in range(ticks):
            t_wall0 = time.monotonic()
            # (a) execute scheduled kill faults for this tick
            for w in plan.kills_at(t):
                if w not in dead:
                    recovery.setdefault(w, {})["t_kill"] = \
                        time.monotonic() - wall0
                    sup.kill(w)
                    while sup.procs[w].poll() is None:
                        time.sleep(_POLL)   # SIGKILL: exit is imminent
            # (b) membership: deaths since last tick → leaves; ready
            # respawns → joins (the churn-joiner re-anchor, version t)
            leaves = observe_leaves(t)
            sup.fire_respawns(time.monotonic())
            joins = [w for w in sorted(dead)
                     if sup.procs[w].poll() is None
                     and _hb_ready(workdir, w, sup.epochs[w])]
            for w in joins:
                dead.discard(w)
                events.append((t, "join", w))
                v_view[w] = t               # fresh pull = current server
                recovery.setdefault(w, {})["t_rejoin"] = \
                    time.monotonic() - wall0
            if leaves or joins:
                state = apply_external_churn(cfg, state,
                                             leave=tuple(leaves),
                                             join=tuple(joins))

            # (c) who pushes this tick (host-readable, deterministic)
            def pushers_of(st) -> List[int]:
                m = (st.busy_until <= st.now) & ~st.pushed & st.alive
                return [int(i) for i in np.flatnonzero(m.cpu().numpy())]

            pushers = pushers_of(state)
            issue += 1
            _atomic_json(order_path, {
                "tick": t, "issue": issue, "pushers": pushers,
                "views": {str(w): v_view[w] for w in pushers}})

            # (d) collect pushes; mid-tick deaths shrink the set
            deadline = time.monotonic() + tick_timeout
            while True:
                missing = [w for w in pushers if not os.path.exists(
                    os.path.join(workdir, "pushes", f"push_t{t}_w{w}.npz"))]
                if not missing:
                    break
                newly = observe_leaves(t)
                if newly:
                    state = apply_external_churn(cfg, state,
                                                 leave=tuple(newly))
                    pushers = pushers_of(state)
                    issue += 1
                    _atomic_json(order_path, {
                        "tick": t, "issue": issue, "pushers": pushers,
                        "views": {str(w): v_view[w] for w in pushers}})
                    continue
                now_wall = time.time()
                for w in missing:           # hang detection: stale beat
                    age = _hb_age(workdir, w, now_wall)
                    if age is not None and age > hb_timeout:
                        sup.kill(w)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"tick {t}: pushers {missing} never pushed "
                        f"within {tick_timeout}s")
                time.sleep(_POLL)

            # (e) stack pusher grads (zeros elsewhere) and apply the tick
            losses = np.zeros((W,), np.float32)
            g = np.zeros((W, dim), np.float32)
            for w in pushers:
                with np.load(os.path.join(
                        workdir, "pushes", f"push_t{t}_w{w}.npz")) as z:
                    losses[w] = z["loss"]
                    g[w] = z["g0"]
                rec = recovery.get(w)
                if rec and "t_rejoin" in rec and "t_push" not in rec:
                    rec["t_push"] = time.monotonic() - wall0
            pushed = (torch.from_numpy(losses).to(dev),
                      {"w": torch.from_numpy(g).to(dev)})
            prev_step = state.step.cpu().numpy()
            state, _ = psp_apply_tick(cfg, opt_update, state,
                                      lambda _: pushed,
                                      noise.tick_record(cfg))

            # (f) pulls: a bumped step counter means the barrier let the
            # worker pull the fresh server model = version t+1
            for w in np.flatnonzero(state.step.cpu().numpy() > prev_step):
                v_view[int(w)] = t + 1
            pub.publish(t + 1, state.server_params)
            lag = tick_min_wall - (time.monotonic() - t_wall0)
            if lag > 0:
                time.sleep(lag)
        _atomic_json(order_path, {"stop": True, "tick": ticks, "issue": -1})
        sup.shutdown()
    finally:
        try:
            _atomic_json(order_path,
                         {"stop": True, "tick": ticks, "issue": -1})
        except OSError:
            pass
        sup.shutdown(grace=0.5)
        pub.wait()
        pub.close()

    wall = time.monotonic() - wall0
    for rec in recovery.values():
        if "t_kill" in rec and "t_push" in rec:
            rec["latency_s"] = rec["t_push"] - rec["t_kill"]
    result = {
        "workers": W, "ticks": ticks, "dim": dim, "batch": batch,
        "barrier": cfg.barrier, "plan": plan.name, "plan_seed": plan.seed,
        "events": [[t, kind, w] for (t, kind, w) in events],
        "epochs": {str(w): sup.epochs.get(w, 0) for w in range(W)},
        "total_pushes": int(state.total_pushes),
        "virtual_time": float(state.now),
        "wall_s": wall,
        "pushes_per_s": int(state.total_pushes) / max(wall, 1e-9),
        "recovery": {str(w): rec for w, rec in recovery.items()},
        "completed": True,
    }
    _atomic_json(os.path.join(workdir, "result.json"), result)
    result["final_params"] = {
        k: v.cpu().numpy() for k, v in state.server_params.items()}
    result["alive"] = state.alive.cpu().numpy().tolist()
    return result


def _coordinator_main(a: argparse.Namespace) -> int:
    """Coordinator CLI entry: build cfg + plan, run, print the record."""
    cfg = PSPConfig(barrier=a.barrier, n_workers=a.workers,
                    staleness=a.staleness, sample_size=a.sample_size,
                    straggler_frac=a.straggler_frac)
    if a.plan:
        plan = make_plan(a.plan, n_workers=a.workers, ticks=a.ticks)
    else:
        plan = plan_from_env(n_workers=a.workers, ticks=a.ticks)
    res = run_cluster(cfg, a.dim, a.ticks, a.dir, batch=a.batch, lr=a.lr,
                      task_seed=a.task_seed, batch_seed=a.batch_seed,
                      plan=plan, restart_delay=a.restart_delay,
                      max_respawns=a.max_respawns,
                      tick_timeout=a.io_timeout,
                      tick_min_wall=a.tick_min_wall, device=a.device)
    res.pop("final_params", None)
    print(json.dumps(res, indent=1))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """CLI dispatcher: ``--role coordinator`` (default) or ``worker``."""
    p = argparse.ArgumentParser(
        description="multi-process PSP cluster over the snapshot bus")
    p.add_argument("--role", choices=("coordinator", "worker"),
                   default="coordinator")
    p.add_argument("--dir", required=True, help="shared working directory")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--ticks", type=int, default=40)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--barrier", default="pbsp")
    p.add_argument("--staleness", type=int, default=3)
    p.add_argument("--sample-size", type=int, default=2)
    p.add_argument("--straggler-frac", type=float, default=0.0)
    p.add_argument("--task-seed", type=int, default=0)
    p.add_argument("--batch-seed", type=int, default=2)
    p.add_argument("--plan", default=None,
                   help="fault-plan spec or JSON path (default: "
                        "PSP_FAULT_PLAN, else none)")
    p.add_argument("--restart-delay", type=float, default=0.0)
    p.add_argument("--max-respawns", type=int, default=1)
    p.add_argument("--tick-min-wall", type=float, default=0.0)
    p.add_argument("--io-timeout", type=float, default=120.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu, for "
                        "the coordinator and every worker")
    # worker-only
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--hb-interval", type=float, default=None)
    a = p.parse_args(argv)
    if a.role == "worker":
        if a.worker is None:
            p.error("--worker is required for --role worker")
        return _worker_main(a)
    return _coordinator_main(a)


if __name__ == "__main__":
    sys.exit(main())
