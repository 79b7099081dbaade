"""Sweep-engine benchmark: the event engine against the grid engines.

The port's copy of ``benchmarks/sweep_bench.py``.  It runs
the same Fig-2-style scenario matrix (nine barrier policies — the five
static protocols and the four adaptive ones — × five straggler
fractions, matched seeds) through every engine of the port:

* ``event`` — a Python loop over the discrete-event
  :func:`~repro_torch.core.simulator.run_simulation` (the *before*),
  single shot;
* ``numpy`` — the host grid engine (``run_sweep(backend="numpy")``);
* ``torch`` — the tensor engine with the plain PyTorch tick
  (``PSP_TICK_IMPL=ref``) on the device;
* ``cuda`` — the tensor engine with the CUDA tick kernel
  (``PSP_TICK_IMPL=cuda``; only when the device is a GPU);
* ``torch_100k`` — a 100,000-node pBSP-vs-SSP pair (β 1, d 4, 1 s) on
  the default tick of the device (the kernel on a GPU): the paper's §6
  "internet scale" regime, which no event loop reaches.

It checks that the engines agree at the distribution level (each grid
row's largest relative deviation of mean progress from the event rows)
and records the wall times in the reference's schema (``jax`` → ``torch``,
``pallas`` → ``cuda``), with the reference's mesh fields (``n_devices``,
``mesh``, ``mesh_axes``) on the tensor rows.  ``--mesh RxN`` runs the
tensor rows on a ``(rows, nodes)`` mesh of ranks
(:func:`repro_torch.launch.mesh.spawn_host_world`): gloo ranks on the
CPU (``--device cpu``, where the reference forces host devices), NCCL
ranks one a card on GPUs, the mesh bounded by the visible cards; rank
0's times are recorded.  Without ``--mesh`` a row runs in this process.  Each grid row
carries a **compile** phase (its first call: kernel load and warm-up)
apart from its **run** phase (best of 3).  The JSON goes to
``results/BENCH_sweep_torch.json`` unless ``--out`` says otherwise; the
reference's ``BENCH_sweep.json`` is never written.

    PYTHONPATH=src python -m repro_torch.bench.sweep_bench [--full]
        [--device cpu] [--mesh RxN] [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core.barriers import make_barrier
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.core.sweep_plan import parse_mesh, resolve_mesh
from repro_torch.core.vector_sim import _device, run_sweep

__all__ = ["ADAPTIVE", "FIVE", "FRACS", "NINE", "OUT_PATH",
           "hundred_k_row", "main", "summary_line", "sweep_speedup"]

OUT_PATH = str(Path(__file__).resolve().parents[3] / "results"
               / "BENCH_sweep_torch.json")

FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")
ADAPTIVE = ("dssp", "ebsp", "apbsp", "apssp")
NINE = FIVE + ADAPTIVE
FRACS = (0.0, 0.05, 0.1, 0.2, 0.3)


def _configs(full: bool) -> List[SimConfig]:
    """The Fig-2 scenario matrix (paper scale under ``full``): nine
    barrier rows × five straggler fractions."""
    n, dur, dim = (1000, 40.0, 100) if full else (100, 20.0, 32)
    beta = max(1, n // 100)
    return [SimConfig(n_nodes=n, duration=dur, dim=dim, seed=3,
                      straggler_frac=frac,
                      barrier=make_barrier(name, staleness=4,
                                           sample_size=beta))
            for name in NINE for frac in FRACS]


def _100k_configs() -> List[SimConfig]:
    """The 100k-node pBSP-vs-SSP pair.  ``sample_size=1`` keeps the
    β-sample on the O(P) path (a P×P score matrix at P = 100,000 would
    be 40 GB), and the 1-second horizon bounds the grid at 50 ticks."""
    return [SimConfig(n_nodes=100_000, duration=1.0, dim=4, batch=2,
                      seed=3, straggler_frac=0.1,
                      barrier=make_barrier(name, staleness=4,
                                           sample_size=1))
            for name in ("pbsp", "ssp")]


@contextlib.contextmanager
def _impl(impl: Optional[str]):
    """``PSP_TICK_IMPL`` set to ``impl`` inside the block (``None``
    leaves it as it is), restored after."""
    before = os.environ.get("PSP_TICK_IMPL")
    if impl is not None:
        os.environ["PSP_TICK_IMPL"] = impl
    try:
        yield
    finally:
        if impl is not None:
            if before is None:
                os.environ.pop("PSP_TICK_IMPL", None)
            else:
                os.environ["PSP_TICK_IMPL"] = before


def _timed_grid(cfgs, backend: str, device=None, impl: Optional[str] = None,
                repeats: int = 3, mesh: Optional[Tuple[int, int]] = None):
    """(compile_s, run_s, results) for one grid engine.

    The first full-matrix call pays the kernel load and warm-up (the
    numpy backend's is ≈ 0): that call's time less the best run is the
    *compile* phase.  The *run* phase is the best of ``repeats`` calls;
    ``run_sweep`` returns host arrays, so each call ends synchronized.
    """
    kw = {} if mesh is None else {"mesh": mesh}
    with _impl(impl):
        t0 = time.perf_counter()
        run_sweep(cfgs, backend=backend, device=device, **kw)
        first = time.perf_counter() - t0
        best, res = float("inf"), None
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = run_sweep(cfgs, backend=backend, device=device, **kw)
            best = min(best, time.perf_counter() - t0)
    return max(first - best, 0.0), best, res


def _grid_rank(cfgs, device_type: str, impl: str, repeats: int,
               mesh: Tuple[int, int]):
    """One rank of a tensor row on a mesh: :func:`_timed_grid` on this
    rank's device."""
    import torch.distributed as dist
    device = ("cpu" if device_type == "cpu"
              else f"cuda:{dist.get_rank()}")
    return _timed_grid(cfgs, "torch", device, impl, repeats, mesh)


def _ranks(device, mesh: Optional[Tuple[int, int]]) -> int:
    """The ranks a tensor row runs on: the mesh's size (bounded by the
    visible cards on a GPU), or 1 (in this process) without a mesh."""
    import torch
    if mesh is None:
        return 1
    n = mesh[0] * mesh[1]
    if device.type == "cuda":
        n = min(n, torch.cuda.device_count())
    return n


def _tensor_row(cfgs, device, impl: str, repeats: int,
                mesh: Optional[Tuple[int, int]]):
    """(compile_s, run_s, results, mesh fields) of a tensor row: in this
    process, or on :func:`_ranks` spawned ranks (gloo on the CPU, NCCL on
    cards), rank 0's times."""
    from repro_torch.launch.mesh import spawn_host_world
    n = _ranks(device, mesh)
    fields = _mesh_fields(len(cfgs), cfgs[0].n_nodes, mesh, n)
    if mesh is None:
        return (*_timed_grid(cfgs, "torch", device, impl, repeats), fields)
    out = spawn_host_world(
        n, _grid_rank, cfgs, device.type, impl, repeats, mesh,
        backend="gloo" if device.type == "cpu" else "nccl", wall=3600.0)
    return (*out[0], fields)


def _mesh_fields(B: int, P: int, mesh: Optional[Tuple[int, int]],
                 available: int) -> Dict:
    """The reference's mesh fields of a tensor row: the placement the
    planner resolves for these shapes on ``available`` ranks."""
    rows, nodes = resolve_mesh(B, P, mesh=mesh, available=available)
    return {"n_devices": rows * nodes, "mesh": [rows, nodes],
            "mesh_axes": {"rows": rows, "nodes": nodes}}


def hundred_k_row(device=None) -> Dict:
    """Time the 100k-node pair on ``device`` (its default tick: the
    kernel on a GPU) → one bench row, best of 2.

    Throughput is ``node_steps_per_device_sec``: completed node steps
    across the pair, per second, on the one device (its mesh fields say
    ``(1, 1)``).
    """
    import torch

    from repro_torch.core.vector_sim_torch import tick_impl
    from repro_torch.kernels import ops
    cfgs = _100k_configs()
    device = torch.device(_device(device))
    compile_s, best, res = _timed_grid(cfgs, "torch", device, repeats=2)
    kernel = ops.use_kernel(tick_impl(), device)
    steps = int(sum(int(r.steps.sum()) for r in res))
    return {**_mesh_fields(len(cfgs), cfgs[0].n_nodes, None, 1),
        "seconds": best,
        "compile_seconds": compile_s,
        "tick_impl": "cuda" if kernel else "ref",
        "n_nodes": cfgs[0].n_nodes,
        "n_configs": len(cfgs),
        "barriers": [c.barrier.name for c in cfgs],
        "total_node_steps": steps,
        "node_steps_per_device_sec": steps / max(best, 1e-9),
        "mean_progress": {c.barrier.name: r.mean_progress
                          for c, r in zip(cfgs, res)},
    }


def sweep_speedup(full: bool = False, device=None,
                  out_path: Optional[str] = OUT_PATH,
                  repeats: int = 3,
                  mesh: Optional[Tuple[int, int]] = None) -> Dict:
    """Time the Fig-2 sweep on every engine and dump the JSON.

    ``device`` is the torch rows' device (``None``: the GPU, raising
    when none is visible); the ``cuda`` row runs only on a GPU.
    ``mesh`` runs the tensor rows on a ``(rows, nodes)`` mesh of
    spawned ranks (see the module docstring).  ``out_path`` redirects
    the dump (``None`` skips it).
    """
    import torch
    device = torch.device(_device(device))
    on_gpu = device.type == "cuda"
    cfgs = _configs(full)
    compile_t, timings, per_engine = {}, {}, {}
    compile_t["numpy"], timings["numpy"], per_engine["numpy"] = \
        _timed_grid(cfgs, "numpy", repeats=repeats)
    fields = {}
    compile_t["torch"], timings["torch"], per_engine["torch"], \
        fields["torch"] = _tensor_row(cfgs, device, "ref", repeats, mesh)
    if on_gpu:
        compile_t["cuda"], timings["cuda"], per_engine["cuda"], \
            fields["cuda"] = _tensor_row(cfgs, device, "cuda", repeats, mesh)
    t0 = time.perf_counter()
    ev = [run_simulation(c) for c in cfgs]
    timings["event"] = time.perf_counter() - t0

    def max_dev(results):
        rel = [v.mean_progress / max(e.mean_progress, 1e-9)
               for e, v in zip(ev, results)]
        return max(abs(r - 1.0) for r in rel)

    def row(name):
        return {"seconds": timings[name],
                "compile_seconds": compile_t[name],
                "speedup_vs_event":
                    timings["event"] / max(timings[name], 1e-9),
                "amortized_speedup_vs_event": timings["event"] / max(
                    timings[name] + compile_t[name], 1e-9),
                "max_progress_deviation": max_dev(per_engine[name])}

    engines = {"event": {"seconds": timings["event"]},
               "numpy": row("numpy"),
               "torch": {**row("torch"), **fields["torch"],
                         "tick_impl": "ref",
                         "throughput_vs_numpy":
                             timings["numpy"] / max(timings["torch"], 1e-9)}}
    if on_gpu:
        engines["cuda"] = {**row("cuda"), **fields["cuda"],
                           "tick_impl": "cuda",
                           "throughput_vs_torch_ref":
                               timings["torch"] / max(timings["cuda"],
                                                      1e-9)}
    engines["torch_100k"] = hundred_k_row(device)
    grid = [n for n in ("numpy", "torch", "cuda") if n in engines]
    res = {
        "sweep": "fig2_stragglers",
        "n_configs": len(cfgs),
        "n_nodes": cfgs[0].n_nodes,
        "duration_s": cfgs[0].duration,
        "device": (torch.cuda.get_device_name(device) if on_gpu
                   else str(device)),
        "engines": engines,
        "summary": {
            "best_speedup_vs_event": max(
                engines[n]["speedup_vs_event"] for n in grid),
            "max_progress_deviation": max(
                engines[n]["max_progress_deviation"] for n in grid),
        },
    }
    if out_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    return res


def summary_line(res: Dict) -> str:
    """One line of every row's seconds and the cross-engine summary."""
    e = res["engines"]
    grid = " ".join(
        f"{n}={e[n]['seconds']:.3f}s(+{e[n]['compile_seconds']:.3f})"
        for n in ("numpy", "torch", "cuda") if n in e)
    hk = e["torch_100k"]
    return (f"event={e['event']['seconds']:.3f}s {grid} "
            f"best_speedup={res['summary']['best_speedup_vs_event']:.2f}x "
            f"max_dev={res['summary']['max_progress_deviation']:.3f} "
            f"100k={hk['seconds']:.3f}s(+{hk['compile_seconds']:.3f}, "
            f"{hk['tick_impl']}, "
            f"{hk['node_steps_per_device_sec']:.0f} node-steps/s)")


def main(argv=None) -> None:
    """CLI entry: ``python -m repro_torch.bench.sweep_bench [--full]
    [--device DEV] [--out PATH]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's scale (1000 nodes, 40 s, d 100)")
    ap.add_argument("--device", default=None,
                    help="torch device of the grid rows (default: cuda)")
    ap.add_argument("--mesh", default=None, type=parse_mesh,
                    help="RxN rows x nodes mesh of ranks for the tensor "
                         "rows (gloo on the CPU, NCCL on cards)")
    ap.add_argument("--out", default=OUT_PATH,
                    help="JSON output path (default: "
                         "results/BENCH_sweep_torch.json)")
    a = ap.parse_args(argv)
    res = sweep_speedup(full=a.full, device=a.device, out_path=a.out,
                        mesh=a.mesh)
    print(summary_line(res))


if __name__ == "__main__":
    main()
