"""Serving-tier benchmark: open-loop load with mid-stream snapshot swaps.

The port's copy of ``benchmarks/serve_bench.py``.  An open-loop
generator (arrivals on a fixed schedule, independent of completions)
drives the request-lifecycle
:class:`~repro_torch.serving.ServingEngine` while a
:class:`~repro_torch.serving.SnapshotPublisher` /
:class:`~repro_torch.serving.SnapshotWatcher` pair performs **two
mid-stream hot swaps** (at 1/3 and 2/3 of the arrivals; the second
publication waits for the first swap).  Measured:

* ``tokens_per_s`` — decoded tokens over the serving wall-clock;
* per-token latency (the gap between a request's consecutive tokens),
  per-request latency (scheduled arrival → completion, so queueing
  counts) and first-token latency, each as p50 / p99;
* ``swap_stall_s`` — wall time the decode loop spent in
  ``watcher.poll()`` and ``set_params`` for each swap that loaded;
* ``dropped`` — must be 0: a swap never cancels in-flight work.

:func:`serve_load` runs the reduced config of ``arch`` on the device
(the card by default); :func:`open_loop` is its body for any config and
serve config.  One throwaway request is served first, end to end: on the
card it pays for the first launches and the allocator.  The JSON goes to
``results/benchmarks_torch/serve.json`` unless ``--out`` says otherwise;
``python tools/check_bench.py --serve --fresh <it>`` gates its
invariants.

    PYTHONPATH=src python -m repro_torch.bench.serve_bench [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.serve_bench --smoke

The ``--smoke`` run proves the schema and both swaps; its timings are
not meaningful, and it writes a file only where ``--out`` names one.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.bench import resolve_device
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.convert import params_to_numpy
from repro_torch.models import init_model
from repro_torch.serving import (Request, ServeConfig, ServingEngine,
                                 SnapshotPublisher, SnapshotWatcher)

__all__ = ["OUT_PATH", "main", "open_loop", "print_result", "serve_load"]

OUT_PATH = str(Path(__file__).resolve().parents[3] / "results"
               / "benchmarks_torch" / "serve.json")


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _lat(xs: List[float]) -> Dict[str, float]:
    return {"p50": _pct(xs, 50), "p99": _pct(xs, 99)}


def open_loop(cfg, scfg: ServeConfig, *, requests: int, rate_rps: float,
              prompt_len: int, poll_every: int = 4, seed: int = 0,
              device=None) -> Tuple[Dict, List[ServingEngine]]:
    """One open-loop serving run of ``cfg`` under ``scfg`` with two
    mid-stream swaps (each publication a model of ``cfg`` seeded 1, 2).

    Returns the metrics dict and the engines it served through (the
    warm-up's and the measured one), whose ``prefill_calls`` and
    ``decode_steps`` count the model calls made."""
    dev = resolve_device(device)
    p0 = init_model(cfg, seed=seed, device=dev)
    eng = ServingEngine(p0, cfg, scfg, version=0)

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len)
               .astype(np.int32) for _ in range(requests)]
    # arrival indices that trigger a snapshot publication; the second
    # waits for the first swap to land so the run always measures two
    # distinct swap events (not one jump to the newest step)
    swap_at = sorted({requests // 3, (2 * requests) // 3})

    with tempfile.TemporaryDirectory(prefix="psp_serve_bench_") as snap_dir:
        pub = SnapshotPublisher(snap_dir, cfg, async_write=True)
        watcher = SnapshotWatcher(snap_dir, params_to_numpy(p0), cfg, dev)
        # one throwaway request end to end, so that the first launches
        # and the allocator's growth stay out of the measured window
        warm = ServingEngine(p0, cfg, scfg)
        warm.submit(Request(prompt=prompts[0]))
        warm.drain()

        arrival: Dict[int, float] = {}
        first_tok: Dict[int, float] = {}
        last_tok: Dict[int, float] = {}
        tok_gaps: List[float] = []
        req_lat: List[float] = []
        ft_lat: List[float] = []
        swap_stalls: List[float] = []
        versions: set = set()
        completed = 0
        total_tokens = 0
        next_i, steps, published = 0, 0, 0

        t0 = time.perf_counter()
        while completed < requests:
            now = time.perf_counter() - t0
            # open loop: admit every request whose scheduled arrival
            # passed, however far behind the server is
            while next_i < requests and next_i / rate_rps <= now:
                rid = eng.submit(Request(prompt=prompts[next_i]))
                arrival[rid] = next_i / rate_rps
                next_i += 1
            if (published < len(swap_at) and next_i >= swap_at[published]
                    and published == len(swap_stalls)):
                pub.publish(published + 1, init_model(
                    cfg, seed=published + 1, device=dev))
                published += 1
            if steps % poll_every == 0:
                ts = time.perf_counter()
                loaded = watcher.poll()
                if loaded is not None:
                    eng.set_params(*loaded)
                    swap_stalls.append(time.perf_counter() - ts)
            if not eng.has_pending():
                time.sleep(min(0.005, max(0.0, next_i / rate_rps - now)))
                continue
            res = eng.step()
            steps += 1
            now = time.perf_counter() - t0
            for rid, _tok in res.emitted:
                total_tokens += 1
                if rid in last_tok:
                    tok_gaps.append(now - last_tok[rid])
                else:
                    first_tok[rid] = now
                    ft_lat.append(now - arrival[rid])
                last_tok[rid] = now
            for c in res.completions:
                completed += 1
                versions.add(c.snapshot_version)
                req_lat.append(now - arrival[c.req_id])
        wall = time.perf_counter() - t0
        pub.close()

    return {
        "arch": cfg.name,
        "requests": requests,
        "rate_rps": rate_rps,
        "batch": scfg.batch,
        "max_new_tokens": scfg.max_new_tokens,
        "prompt_len": prompt_len,
        "wall_s": round(wall, 4),
        "total_tokens": total_tokens,
        "tokens_per_s": round(total_tokens / wall, 3),
        "latency_s": {
            "per_token": _lat(tok_gaps),
            "per_request": _lat(req_lat),
            "first_token": _lat(ft_lat),
        },
        "swaps": len(swap_stalls),
        "swap_stall_s": {"max": round(max(swap_stalls), 4)
                         if swap_stalls else 0.0,
                         "events": [round(s, 4) for s in swap_stalls]},
        "snapshots_skipped": watcher.skipped,
        "dropped": requests - completed,
        "versions_served": sorted(versions),
        "decode_steps": steps,
    }, [warm, eng]


def serve_load(arch: str = "qwen2-0.5b", requests: int = 32,
               rate_rps: float = 4.0, batch: int = 4, max_new: int = 16,
               prompt_len: int = 12, poll_every: int = 4,
               seed: int = 0, device=None) -> Dict:
    """One open-loop serving run of ``arch``'s reduced config with two
    mid-stream swaps → metrics dict (on ``device``; ``None``: the card).
    """
    cfg = make_reduced(get_config(arch))
    scfg = ServeConfig(batch=batch, max_len=256, max_new_tokens=max_new,
                       seed=seed)
    return open_loop(cfg, scfg, requests=requests, rate_rps=rate_rps,
                     prompt_len=prompt_len, poll_every=poll_every,
                     seed=seed, device=device)[0]


def print_result(res: Dict) -> None:
    """The rate, the three latency pairs and the swaps, as the
    reference's CLI prints them."""
    lat = res["latency_s"]
    print(f"{res['arch']}: {res['requests']} reqs @ {res['rate_rps']}/s  "
          f"{res['tokens_per_s']:.1f} tok/s  wall {res['wall_s']:.1f}s")
    print(f"  per-token  p50 {lat['per_token']['p50'] * 1e3:7.1f} ms   "
          f"p99 {lat['per_token']['p99'] * 1e3:7.1f} ms")
    print(f"  per-req    p50 {lat['per_request']['p50'] * 1e3:7.1f} ms   "
          f"p99 {lat['per_request']['p99'] * 1e3:7.1f} ms")
    print(f"  first-tok  p50 {lat['first_token']['p50'] * 1e3:7.1f} ms   "
          f"p99 {lat['first_token']['p99'] * 1e3:7.1f} ms")
    print(f"  swaps {res['swaps']} (max stall "
          f"{res['swap_stall_s']['max'] * 1e3:.1f} ms)  "
          f"versions {res['versions_served']}  dropped {res['dropped']}")


def main(argv=None) -> int:
    """CLI entry: run the open-loop serve benchmark, write the result;
    exit 1 unless there were at least 2 swaps and 0 drops."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run: proves the schema and both swaps; "
                         "writes only an explicit --out")
    a = ap.parse_args(argv)
    if a.smoke:
        res = serve_load(requests=9, rate_rps=16.0, batch=2, max_new=4,
                         device=a.device)
        if a.out != OUT_PATH:
            with open(a.out, "w") as f:
                json.dump(res, f, indent=1)
            print(f"wrote {a.out}")
    else:
        res = serve_load(requests=a.requests, rate_rps=a.rate,
                         batch=a.batch, max_new=a.max_new, device=a.device)
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {a.out}")
    print_result(res)
    if res["swaps"] < 2 or res["dropped"] != 0:
        print("FAIL: run invariants violated (need >=2 swaps, 0 drops)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
