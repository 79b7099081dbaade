"""Elastic-trainer churn benchmark: convergence against virtual wall-clock.

The port's copy of ``benchmarks/churn_bench.py``.  The elastic PSP
trainer (:mod:`repro_torch.core.spmd_psp` with
``PSPConfig(churn=...)``) runs the linear task (d 32) for every barrier
policy, and the normalized model error is recorded against **virtual
wall-clock**.  Two scenario rows per policy:

* **churn** (top-level keys, one per barrier): Poisson leave/join with a
  25 % straggler tail, the five static protocols and the four adaptive
  policies (``dssp`` / ``ebsp`` / ``apbsp`` / ``apssp``);
* **stragglers** (the ``"stragglers"`` key): static membership with a
  heavy 35 % straggler tail; ``"adaptive_vs_static"`` scores each
  adaptive policy against its static parent at equal virtual time (the
  error read at the earlier of the two final times), so ``dominates``
  means a strictly lower error for the same virtual wall-clock.

Every run is on one device: the card by default, the CPU with
``--device cpu``.  The error is read to the host only every 10th tick
and at the last, as the reference reads it.  The result goes to
``results/benchmarks_torch/elastic_churn.json``.

    PYTHONPATH=src python -m repro_torch.bench.churn_bench [--full|--smoke]
        [--device cpu]

Also the ``elastic_churn`` entry of :mod:`repro_torch.bench.run`;
:func:`repro_torch.bench.figures.fig6_adaptive_churn` reshapes this
result into the adaptive-vs-static curve series.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.bench import resolve_device
from repro_torch.core.spmd_psp import ChurnConfig, PSPConfig, elastic_drive

__all__ = ["ADAPTIVE", "D", "FIVE", "NINE", "OUT_PATH", "PARENT",
           "elastic_churn", "main", "print_summary"]

OUT_PATH = str(Path(__file__).resolve().parents[3] / "results"
               / "benchmarks_torch" / "elastic_churn.json")

FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")
ADAPTIVE = ("dssp", "ebsp", "apbsp", "apssp")
#: adaptive policy → the static protocol it reduces to when pinned
PARENT = {"dssp": "ssp", "ebsp": "bsp", "apbsp": "pbsp", "apssp": "pssp"}
NINE = FIVE + ADAPTIVE
D = 32


def _run_one(barrier: str, ticks: int, workers: int,
             churn: Optional[ChurnConfig], straggler_frac: float = 0.25, *,
             device=None, **cfg_kw) -> Dict:
    """One elastic run on ``device``: (virtual time, error) trace +
    summary scalars."""
    cfg = PSPConfig(barrier=barrier, n_workers=workers, sample_size=2,
                    staleness=3, straggler_frac=straggler_frac, churn=churn,
                    **cfg_kw)
    w_true, it = elastic_drive(cfg, D, ticks, device=resolve_device(device))
    norm_true = torch.linalg.norm(w_true)
    times, errors, alive = [], [], []
    for i, (st, m) in enumerate(it):
        if i % 10 == 0 or i == ticks - 1:
            err = float(torch.linalg.norm(st.server_params["w"] - w_true)
                        / norm_true)
            times.append(float(st.now))
            errors.append(err)
            alive.append(int(m["alive"]))
    return {
        "virtual_time": times,
        "error": errors,
        "alive": alive,
        "final_error": errors[-1],
        "final_virtual_time": times[-1],
        "mean_alive": float(np.mean(alive)),
        "total_pushes": int(st.total_pushes),
        "leaves": int(st.leave_cursor),
        "joins": int(st.join_cursor),
    }


def _err_at(run: Dict, t: float) -> float:
    """Error interpolated at virtual time ``t`` (curves are monotone in t)."""
    return float(np.interp(t, run["virtual_time"], run["error"]))


def _adaptive_vs_static(runs: Dict[str, Dict]) -> Dict[str, Dict]:
    """Score each adaptive policy against its static parent.

    Comparison at *equal virtual wall-clock*: both error curves are read
    at the earlier of the two final times, so a policy can't "win" by
    simply running longer.
    """
    out = {}
    for name, parent in PARENT.items():
        a, p = runs[name], runs[parent]
        t = min(a["final_virtual_time"], p["final_virtual_time"])
        err_a, err_p = _err_at(a, t), _err_at(p, t)
        out[name] = {
            "parent": parent,
            "virtual_time": t,
            "error": err_a,
            "parent_error": err_p,
            "error_ratio": err_a / max(err_p, 1e-12),
            "dominates": bool(err_a < err_p),
        }
    return out


def _sweep(ticks: int, workers: int, device=None) -> Dict:
    """Both scenarios × all nine policies at the given scale."""
    churn = ChurnConfig(leave_rate=1.5, join_rate=1.5, horizon=60.0, seed=7)
    res: Dict = {name: _run_one(name, ticks, workers, churn, device=device)
                 for name in NINE}
    # max_advance=8: Elastic-BSP's slack budget sized to the straggler
    # slowdown (at the default 4 the EMA slack can't cover a 4× tail).
    # Only ebsp reads the knob.  The gap-driven policies (dssp, apbsp,
    # apssp) equal their parents here by construction: under constant
    # straggling the progress gap settles at the threshold, so their
    # adaptivity shows in the churn scenario instead.
    stragglers = {name: _run_one(name, ticks, workers, churn=None,
                                 straggler_frac=0.35, max_advance=8,
                                 device=device)
                  for name in NINE}
    res["stragglers"] = stragglers
    res["adaptive_vs_static"] = {
        "churn": _adaptive_vs_static({k: res[k] for k in NINE}),
        "stragglers": _adaptive_vs_static(stragglers),
    }
    return res


@functools.lru_cache(maxsize=2)
def elastic_churn(full: bool = False, backend: Optional[str] = None,
                  device=None) -> Dict:
    """Convergence-vs-virtual-wall-clock, static + adaptive barrier rows.

    Cached per arguments: :mod:`repro_torch.bench.run` reads this result
    twice (the ``elastic_churn`` entry and the ``fig6_adaptive_churn``
    reshape), and the 18 trainer runs are the expensive part.  Callers
    must not mutate the returned dict.

    ``backend`` is accepted for the harness's uniformity and ignored, as
    the reference ignores it: the trainer runs on ``device`` (``None``:
    the card).  ``full`` scales ticks and workers up (900 × 16, else
    300 × 8).
    """
    ticks, workers = (900, 16) if full else (300, 8)
    return _sweep(ticks, workers, device)


def print_summary(res: Dict) -> None:
    """The per-scenario table and the adaptive-vs-static scoreboard."""
    for scenario, runs in (("churn", {k: res[k] for k in NINE}),
                           ("stragglers", res["stragglers"])):
        print(f"-- {scenario} --")
        print(f"{'barrier':8s} {'err@T':>8s} {'virt_T':>7s} {'pushes':>7s} "
              f"{'alive':>6s} {'churn':>7s}")
        for name in NINE:
            r = runs[name]
            print(f"{name:8s} {r['final_error']:8.4f} "
                  f"{r['final_virtual_time']:7.2f} {r['total_pushes']:7d} "
                  f"{r['mean_alive']:6.1f} "
                  f"{r['leaves']:3d}-/{r['joins']}+")
    print("-- adaptive vs static parent (equal virtual time) --")
    for scenario in ("churn", "stragglers"):
        for name, s in res["adaptive_vs_static"][scenario].items():
            mark = "<" if s["dominates"] else ">="
            print(f"{scenario:11s} {name:6s} err {s['error']:.4f} {mark} "
                  f"{s['parent']} {s['parent_error']:.4f} "
                  f"(ratio {s['error_ratio']:.2f})")


def main(argv=None) -> None:
    """CLI entry: ``python -m repro_torch.bench.churn_bench
    [--full|--smoke] [--device cpu]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid (60 ticks, 6 workers): schema and "
                         "runnability only, no artifact")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    res = (_sweep(60, 6, a.device) if a.smoke
           else elastic_churn(full=a.full, device=a.device))
    if not a.smoke:     # the smoke grid must not clobber the artifact
        os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
        with open(OUT_PATH, "w") as f:
            json.dump(res, f, indent=1)
    print_summary(res)


if __name__ == "__main__":
    main()
