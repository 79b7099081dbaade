"""Roofline table from the port's dry-run records, and the sweep tick's
row: the port's copy of ``benchmarks/roofline_bench.py``.

:func:`table` / :func:`print_table` read
``results/dryrun_torch/*__<mesh>.json`` (:mod:`repro_torch.launch.dryrun`)
and give each (arch × shape) combination's three-term roofline and its
bottleneck.  They default to ``card``, the mesh whose records have a
roofline (the reference's meshes have none in the port).

:func:`sweep_tick_row` scores the sweep engine's hot path, the fused
tick inside the chunked sweep, against the same roofline: it runs the
sweep once under :class:`~repro_torch.roofline.dispatch_cost.DispatchCost`
(the tick's FLOPs, and its bytes by ``kernels.psp_tick.tick_bytes``, the
in-place bound, charged at the kernel boundary each tick), then times
the same sweep uncounted.  On the card it runs the CUDA tick, timed by
CUDA events, and ``useful_ratio`` is the roofline time over the measured
time; on the CPU (``device="cpu"``) it runs the plain tick, the card's
fields are None and the host's seconds stand beside them.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.launch.dryrun import OUT_DIR as RESULTS

__all__ = ["RESULTS", "load", "print_table", "sweep_tick_row", "table"]


def load(mesh: str = "card", results: Optional[str] = None) -> List[dict]:
    """The dry-run records of ``mesh`` in ``results`` (default
    :data:`RESULTS`), the PSP trainer's left out."""
    results = results or RESULTS
    rows = []
    for path in sorted(glob.glob(os.path.join(results, f"*__{mesh}.json"))):
        if "_psp__" in path:
            continue
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def table(mesh: str = "card", results: Optional[str] = None
          ) -> List[dict]:
    """One row per record: the roofline's terms, bottleneck and useful
    ratio, or the status and its reason."""
    out = []
    for r in load(mesh, results):
        if r.get("status") != "ok" or not r.get("roofline"):
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "status": ("no roofline" if r.get("status") == "ok"
                                   else r.get("status", "?")),
                        "reason": r.get("reason", r.get("error", ""))[:60]})
            continue
        rf = r["roofline"]
        out.append({
            "arch": r["arch"], "shape": r["shape"], "status": "ok",
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"],
            "bottleneck": rf["bottleneck"],
            "useful_ratio": rf["useful_ratio"],
            "args_gb": r["memory"]["argument_bytes"] / 1e9,
            "out_gb": r["memory"]["output_bytes"] / 1e9,
        })
    return out


def print_table(mesh: str = "card", results: Optional[str] = None
                ) -> Dict[str, int]:
    """Print :func:`table`; returns the count of combos per bottleneck."""
    counts: Dict[str, int] = {}
    print(f"{'arch':24s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s}"
          f" {'coll_s':>10s} {'bneck':>10s} {'useful':>7s} {'args_GB':>8s}")
    for r in table(mesh, results):
        if r["status"] != "ok":
            print(f"{r['arch']:24s} {r['shape']:12s} -- {r['status']}: "
                  f"{r.get('reason', '')}")
            continue
        counts[r["bottleneck"]] = counts.get(r["bottleneck"], 0) + 1
        print(f"{r['arch']:24s} {r['shape']:12s} {r['compute_s']:10.4f} "
              f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
              f"{r['bottleneck']:>10s} {r['useful_ratio']:7.3f} "
              f"{r['args_gb']:8.2f}")
    return counts


def sweep_tick_row(n_nodes: int = 128, dim: int = 32, rows: int = 8, *,
                   sample_size: int = 2, batch: int = 8,
                   device=None) -> dict:
    """Roofline row of the sweep tick on a 10 s straggler sweep (``pssp``,
    s 4, β ``sample_size``, 20 % stragglers, ``rows`` seeds of P
    ``n_nodes``, d ``dim``, m ``batch``; the reference's row at its
    defaults).

    The tick's FLOPs are float32 work, so its compute term is at the
    card's float32 rate.  ``device`` None means the card (raises without
    one).  The measured time is the best of three uncounted sweeps.
    """
    import torch

    from repro_torch.bench import resolve_device
    from repro_torch.core import SimConfig, make_barrier, run_sweep
    from repro_torch.roofline.analysis import HW, roofline_report
    from repro_torch.roofline.dispatch_cost import DispatchCost

    dev = resolve_device(device)
    card = dev.type == "cuda"
    cfgs = [SimConfig(n_nodes=n_nodes, duration=10.0, dim=dim,
                      batch=batch, seed=s, straggler_frac=0.2,
                      barrier=make_barrier("pssp", staleness=4,
                                           sample_size=sample_size))
            for s in range(rows)]
    with DispatchCost() as cost:        # counted once, never timed
        run_sweep(cfgs, device=dev)
    tick = cost.kernels["psp_tick"]
    ticks = int(tick["calls"])
    hw = HW()
    rep = roofline_report(
        {"flops": tick["flops"], "bytes accessed": tick["bytes"]},
        chips=1, model_flops_total=tick["flops"],
        hw=dataclasses.replace(hw, peak_flops=hw.f32_flops))
    best: Optional[float] = None
    for _ in range(3):
        if card:
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            run_sweep(cfgs, device=dev)
            t1.record()
            t1.synchronize()
            secs = t0.elapsed_time(t1) / 1e3
        else:
            t = time.perf_counter()
            run_sweep(cfgs, device=dev)
            secs = time.perf_counter() - t
        best = secs if best is None else min(best, secs)
    roofline_s = max(rep.compute_s, rep.memory_s, rep.collective_s)
    return {
        "arch": "sweep_tick", "status": "ok",
        "shape": f"B{rows}xP{n_nodes}xd{dim}xm{batch}xbeta{sample_size}"
                 f"x{ticks}t",
        "compute_s": rep.compute_s, "memory_s": rep.memory_s,
        "collective_s": rep.collective_s, "bottleneck": rep.bottleneck,
        "roofline_s": roofline_s,
        "ticks": ticks,
        "flops_per_tick": tick["flops"] / max(ticks, 1),
        "bytes_per_tick": tick["bytes"] / max(ticks, 1),
        "arithmetic_intensity": tick["flops"] / max(tick["bytes"], 1),
        "device": (torch.cuda.get_device_name(dev) if card else "cpu"),
        # the card's fields: None off the card
        "measured_s": best if card else None,
        "measured_tick_us": best / max(ticks, 1) * 1e6 if card else None,
        "useful_ratio": roofline_s / best if card else None,
        "host_s": None if card else best,
    }
