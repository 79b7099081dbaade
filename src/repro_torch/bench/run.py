"""Benchmark harness of the port — one entry per paper figure.

The port's copy of ``benchmarks/run.py``.  Prints ``name,us_per_call,
derived`` CSV (one line per benchmark) and dumps each benchmark's full
series to ``results/benchmarks_torch/<name>.json``.  Every figure sweep
runs through :func:`repro_torch.core.run_sweep` on the backend that
``--backend`` selects: ``torch`` (the fused tick; on the card unless
``--device cpu``) or ``numpy`` (the host grid engine).  The sweep
benchmark (:mod:`repro_torch.bench.sweep_bench`) times every engine
whatever ``--backend`` says, and the churn benchmark
(:mod:`repro_torch.bench.churn_bench`: ``elastic_churn`` and its Fig 6
reshape ``fig6_adaptive_churn``) runs the elastic trainer on the card,
or on ``--device``'s device, whatever the backend.

    PYTHONPATH=src python -m repro_torch.bench.run [--full]
        [--only fig1_progress] [--backend torch|numpy] [--device cpu]

``--full`` runs the paper's setting (1000 nodes, 40 s, β = 1 %); the
default is a reduced scale of the same structure.  An unknown
``--only`` name raises.  After the benchmarks (or alone with ``--only
roofline``; ``--skip-roofline`` leaves it out) the roofline step writes
``roofline.json``: the ``card`` rows of the dry run's records
(:mod:`repro_torch.bench.roofline_bench`; run
``python -m repro_torch.launch.dryrun --mesh card`` first) and the sweep
tick's row on ``--device``'s device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from repro_torch.bench import (churn_bench, fig45_bounds, figures,
                               roofline_bench, sweep_bench)

__all__ = ["BENCHES", "OUT_DIR", "main", "roofline"]

OUT_DIR = str(Path(__file__).resolve().parents[3] / "results"
              / "benchmarks_torch")


def _derived_fig1(res):
    return ("pbsp_vs_bsp_progress="
            f"{res['pbsp']['mean'] / max(res['bsp']['mean'], 1e-9):.2f}")


def _derived_fig1_err(res):
    best = min(res, key=lambda k: res[k]["final"])
    return f"lowest_error={best}:{res[best]['final']:.4f}"


def _derived_fig1_msg(res):
    return ("asp_vs_bsp_updates="
            f"{res['asp']['total'] / max(res['bsp']['total'], 1):.1f}x")


def _derived_fig1_bands(res):
    best = min(res, key=lambda k: res[k]["final_mean"])
    return (f"lowest_error={best}:{res[best]['final_mean']:.4f}"
            f"±{res[best]['final_std']:.4f}")


def _derived_fig2(res):
    worst = res["bsp"][-1]["progress_ratio"]
    rob = res["pbsp"][-1]["progress_ratio"]
    return f"at30pct: bsp={worst:.2f} pbsp={rob:.2f}"


def _derived_fig2c(res):
    return (f"at16x: bsp={res['bsp'][-1]['progress_ratio']:.2f} "
            f"pbsp={res['pbsp'][-1]['progress_ratio']:.2f}")


def _derived_fig3(res):
    return (f"largest: bsp={res['bsp'][-1]['progress_pct']:.0f}% "
            f"pssp={res['pssp'][-1]['progress_pct']:.0f}%")


def _derived_sweep(res):
    keys = sorted(res, key=lambda k: int(k.split("=")[1]))
    return (f"spread beta0={res[keys[0]]['spread']} "
            f"beta_max={res[keys[-1]]['spread']}")


#: (name, fn(full, backend, device) -> result, derive(result) -> str)
BENCHES = [
    ("fig1_progress", figures.fig1_progress, _derived_fig1),
    ("fig1_sample_sweep", figures.fig1_sample_sweep, _derived_sweep),
    ("fig1_error", figures.fig1_error, _derived_fig1_err),
    ("fig1_error_bands", figures.fig1_error_bands, _derived_fig1_bands),
    ("fig1_messages", figures.fig1_messages, _derived_fig1_msg),
    ("fig2_stragglers", figures.fig2_stragglers, _derived_fig2),
    ("fig2_slowness", figures.fig2_slowness, _derived_fig2c),
    ("fig3_scalability", figures.fig3_scalability, _derived_fig3),
    ("fig4_mean_bound", fig45_bounds.fig4_mean_bound,
     lambda res: fig45_bounds.derived_summary()),
    ("fig5_variance_bound",
     lambda full=False, backend="torch", device=None:
         fig45_bounds.fig5_variance_bound(),
     lambda res: fig45_bounds.derived_summary()),
    # out_path=None: the harness writes the result with the others
    ("sweep_engine",
     lambda full=False, backend="torch", device=None:
         sweep_bench.sweep_speedup(full=full, device=device, out_path=None),
     lambda res: f"speedup={res['summary']['best_speedup_vs_event']:.1f}x "
                 f"max_dev={res['summary']['max_progress_deviation']:.3f}"),
    # the elastic trainer under Poisson churn: convergence against
    # virtual wall-clock with a dynamic worker set (on the device; the
    # backend is ignored)
    ("elastic_churn", churn_bench.elastic_churn,
     lambda res: "err@T " + " ".join(
         f"{k}={res[k]['final_error']:.3f}" for k in ("bsp", "pssp", "asp"))),
    # the adaptive-vs-static reshape of the same runs (elastic_churn's
    # result is cached, so the 18 trainer runs are not repeated)
    ("fig6_adaptive_churn", figures.fig6_adaptive_churn,
     lambda res: "dominant " + (",".join(
         name for name, s in res["scoreboard"]["stragglers"].items()
         if s["dominates"]) or "none") + " (stragglers)"),
]


def main(argv=None) -> None:
    """CLI entry: run the selected benchmarks, print the CSV."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper scale (1000 nodes, 40 s)")
    ap.add_argument("--only", default=None,
                    help="one benchmark name (see BENCHES)")
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                    help="grid engine of the figure sweeps")
    ap.add_argument("--device", default=None,
                    help="torch device of the torch backend "
                         "(default: cuda)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where each benchmark's JSON goes")
    ap.add_argument("--skip-roofline", action="store_true",
                    help="leave out the roofline step")
    a = ap.parse_args(argv)
    names = [name for name, _, _ in BENCHES] + ["roofline"]
    if a.only is not None and a.only not in names:
        raise SystemExit(f"unknown benchmark {a.only!r}; choose from "
                         + ", ".join(names))
    if a.backend == "numpy" and a.device is not None:
        raise SystemExit("--device applies to the torch backend only")
    os.makedirs(a.out_dir, exist_ok=True)
    print("name,us_per_call,derived")
    for name, fn, derive in BENCHES:
        if a.only and name != a.only:
            continue
        t0 = time.perf_counter()
        res = fn(full=a.full, backend=a.backend, device=a.device)
        us = (time.perf_counter() - t0) * 1e6
        with open(os.path.join(a.out_dir, name + ".json"), "w") as f:
            json.dump(res, f)
        print(f"{name},{us:.0f},{derive(res)}", flush=True)
    if not a.skip_roofline and a.only in (None, "roofline"):
        roofline(a.out_dir, a.device)


def roofline(out_dir: str, device=None) -> list:
    """The roofline step: the dry run's ``card`` rows and the sweep
    tick's row, written to ``roofline.json``; prints the CSV line."""
    t0 = time.perf_counter()
    rows = roofline_bench.table("card")
    if not rows:
        print("note: no dry-run records (run repro_torch.launch.dryrun "
              "--mesh card); the roofline table holds the sweep-tick row "
              "only")
    rows.append(roofline_bench.sweep_tick_row(device=device))
    with open(os.path.join(out_dir, "roofline.json"), "w") as f:
        json.dump(rows, f, indent=1)
    counts = {}
    for r in rows:
        if r["status"] == "ok":
            counts[r["bottleneck"]] = counts.get(r["bottleneck"], 0) + 1
    us = (time.perf_counter() - t0) * 1e6
    print(f"roofline,{us:.0f},combos={sum(counts.values())} "
          f"bottlenecks={counts}", flush=True)
    return rows


if __name__ == "__main__":
    main()
