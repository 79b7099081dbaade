"""Chaos benchmark: recovery latency and goodput under the standard fault
plan.

The port's copy of ``benchmarks/chaos_bench.py``: two segments, one
result (``results/benchmarks_torch/chaos.json`` unless ``--out`` says
otherwise; ``python tools/check_bench.py --chaos --fresh <it>`` gates
its invariants).

* **cluster** — two real multi-process runs of
  :func:`repro_torch.launch.cluster.run_cluster` with the same seeds and
  shape, coordinator and workers on the bench's device: a no-fault run
  and one under the ``standard`` plan (one SIGKILL a third of the way
  in, one stalled straggler halfway).  Measured: **recovery latency**
  (wall seconds from the SIGKILL to the victim's first contributing
  push after its respawn rejoined) and **goodput** (server pushes per
  wall second) of both runs and their ratio.
* **serving** — an open-loop request stream served while a
  :class:`~repro_torch.serving.ChaosPublisher` executes the plan's
  publish faults (a torn-snapshot storm, a delayed publication) on the
  snapshot bus and the decode worker is killed once mid-stream (the
  plan's kill tick, reused as a request index).  Measured: completed and
  dropped requests, swaps that still landed, worker restarts and
  re-admissions, the watcher's skips and retries, tokens/s.  The
  invariant is **zero drops**.

Everything runs on the card by default, on the CPU with ``--device
cpu``.

    PYTHONPATH=src python -m repro_torch.bench.chaos_bench [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.chaos_bench --smoke

``--smoke`` shrinks both segments; its timings are noise, but every
invariant (the victim rejoined and contributed, zero drops, no live
worker restarted) still holds.  It writes a file only where ``--out``
names one.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np

from repro_torch.bench import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_to_numpy
from repro_torch.core.faults import make_plan
from repro_torch.core.spmd_psp import PSPConfig
from repro_torch.launch.cluster import run_cluster
from repro_torch.models import init_model
from repro_torch.serving import (ChaosPublisher, InferenceServer, Request,
                                 ServeConfig, ServingEngine, SnapshotWatcher)

__all__ = ["OUT_PATH", "chaos_suite", "cluster_chaos", "invariants_hold",
           "main", "print_result", "serving_chaos"]

OUT_PATH = str(Path(__file__).resolve().parents[3] / "results"
               / "benchmarks_torch" / "chaos.json")


def cluster_chaos(workers: int = 3, ticks: int = 30, dim: int = 16,
                  batch: int = 4, tick_min_wall: float = 0.5,
                  seed: int = 3, device=None) -> Dict:
    """No-fault vs standard-plan cluster run → recovery + goodput dict."""
    dev = resolve_device(device)
    cfg = PSPConfig(barrier="pbsp", n_workers=workers, staleness=3,
                    sample_size=max(1, workers - 1))

    def _run(plan_spec):
        plan = make_plan(plan_spec, n_workers=workers, ticks=ticks)
        with tempfile.TemporaryDirectory(prefix="psp_chaos_") as d:
            res = run_cluster(cfg, dim, ticks, d, batch=batch, plan=plan,
                              tick_min_wall=tick_min_wall,
                              tick_timeout=120.0, device=dev)
        res.pop("final_params", None)
        return res

    ref = _run("none")
    faulted = _run(f"standard:worker={seed % workers}")
    victims = sorted({w for _t, kind, w in
                      [tuple(e) for e in faulted["events"]]
                      if kind == "leave"})
    latencies = [rec["latency_s"] for rec in faulted["recovery"].values()
                 if "latency_s" in rec]
    live_restarts = sum(e for w, e in faulted["epochs"].items()
                        if int(w) not in victims)
    return {
        "workers": workers, "ticks": ticks, "dim": dim, "batch": batch,
        "plan": faulted["plan"],
        "nofault": {"pushes": ref["total_pushes"],
                    "wall_s": round(ref["wall_s"], 3),
                    "goodput_pushes_per_s": round(ref["pushes_per_s"], 4)},
        "faulted": {"pushes": faulted["total_pushes"],
                    "wall_s": round(faulted["wall_s"], 3),
                    "goodput_pushes_per_s":
                        round(faulted["pushes_per_s"], 4),
                    "events": faulted["events"],
                    "epochs": faulted["epochs"],
                    "recovery": faulted["recovery"]},
        "goodput_ratio": round(faulted["pushes_per_s"]
                               / max(ref["pushes_per_s"], 1e-9), 4),
        "recovery_latency_s": round(max(latencies), 3) if latencies
        else None,
        "victims": victims,
        "live_restarts": live_restarts,
        "completed": bool(ref.get("completed")
                          and faulted.get("completed")),
    }


def serving_chaos(arch: str = "qwen2-0.5b", requests: int = 16,
                  rate_rps: float = 4.0, batch: int = 2, max_new: int = 4,
                  prompt_len: int = 8, seed: int = 0, device=None) -> Dict:
    """Open-loop serving under publish chaos + one decode-worker death."""
    dev = resolve_device(device)
    cfg = reduced(get_config(arch))
    p0 = init_model(cfg, seed=seed, device=dev)
    scfg = ServeConfig(batch=batch, max_len=128, max_new_tokens=max_new,
                       seed=seed)
    plan = make_plan("standard", n_workers=1, ticks=requests)
    kills = [e.tick for e in plan.events if e.kind == "kill"]
    kill_at = min(kills[0], requests - 1) if kills else None

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len)
               .astype(np.int32) for _ in range(requests)]

    with tempfile.TemporaryDirectory(prefix="psp_chaos_serve_") as d:
        pub = ChaosPublisher(d, plan, cfg, async_write=False)
        watcher = SnapshotWatcher(d, params_to_numpy(p0), cfg, dev,
                                  backoff_base=0.05, backoff_max=0.2,
                                  jitter_seed=seed)
        eng = ServingEngine(p0, cfg, scfg, version=0)
        futs = []
        t0 = time.perf_counter()
        with InferenceServer(eng, watcher=watcher, poll_every=2,
                             max_restarts=2) as srv:
            for i in range(requests):
                # one publication per request: the plan's torn storm and
                # delayed publication land on these indices
                pub.publish(i + 1, init_model(cfg, seed=i + 1, device=dev))
                futs.append(srv.submit(Request(prompt=prompts[i])))
                if kill_at is not None and i == kill_at:
                    srv.inject_worker_fault()
                lag = (i + 1) / rate_rps - (time.perf_counter() - t0)
                if lag > 0:
                    time.sleep(lag)
            comps = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.stats

    total_tokens = sum(len(c.tokens) for c in comps)
    return {
        "arch": cfg.name, "requests": requests, "rate_rps": rate_rps,
        "batch": batch, "max_new_tokens": max_new,
        "wall_s": round(wall, 3),
        "completed": len(comps),
        "dropped": requests - len(comps),
        "tokens_per_s": round(total_tokens / wall, 3),
        "versions_served": sorted({c.snapshot_version for c in comps}),
        "swaps": stats.swaps,
        "worker_restarts": stats.worker_restarts,
        "readmitted": stats.readmitted,
        "timeouts": stats.timeouts,
        "snapshots_skipped": stats.snapshots_skipped,
        "watcher_retries": watcher.retries,
        "publish_faults": dict(pub.counters),
    }


def chaos_suite(*, smoke: bool = False, device=None) -> Dict:
    """Run both segments on ``device`` (``None``: the card); ``smoke``
    shrinks the shapes (invariants intact)."""
    if smoke:
        cluster = cluster_chaos(workers=3, ticks=24, tick_min_wall=0.4,
                                device=device)
        serving = serving_chaos(requests=10, rate_rps=8.0, device=device)
    else:
        cluster = cluster_chaos(device=device)
        serving = serving_chaos(device=device)
    return {"smoke": smoke, "cluster": cluster, "serving": serving}


def invariants_hold(res: Dict) -> bool:
    """The bench's exit rule: both cluster runs completed, the victim
    recovered, no live worker restarted, nothing dropped, a swap landed
    and the decode worker's death was survived."""
    c, s = res["cluster"], res["serving"]
    return bool(c["completed"] and c["recovery_latency_s"] is not None
                and c["live_restarts"] == 0 and s["dropped"] == 0
                and s["swaps"] >= 1 and s["worker_restarts"] >= 1)


def print_result(res: Dict) -> None:
    """Both segments' lines, as the reference's CLI prints them."""
    c, s = res["cluster"], res["serving"]
    print(f"cluster: {c['workers']}w x {c['ticks']}t plan={c['plan']}  "
          f"goodput {c['faulted']['goodput_pushes_per_s']:.2f}/s vs "
          f"{c['nofault']['goodput_pushes_per_s']:.2f}/s "
          f"(ratio {c['goodput_ratio']:.2f})")
    print(f"  recovery latency {c['recovery_latency_s']}s  "
          f"victims {c['victims']}  live restarts {c['live_restarts']}")
    print(f"serving: {s['completed']}/{s['requests']} done  "
          f"dropped {s['dropped']}  swaps {s['swaps']}  "
          f"restarts {s['worker_restarts']} "
          f"(readmitted {s['readmitted']})  "
          f"faults {s['publish_faults']}")


def main(argv=None) -> int:
    """CLI entry: run the chaos benchmark, write and print the result;
    exit 1 unless its invariants hold."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run: every invariant still holds, timings "
                         "are noise; writes only an explicit --out")
    a = ap.parse_args(argv)
    res = chaos_suite(smoke=a.smoke, device=a.device)
    if not a.smoke or a.out != OUT_PATH:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {a.out}")
    print_result(res)
    if not invariants_hold(res):
        print("FAIL: chaos invariants violated")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
