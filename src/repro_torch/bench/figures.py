"""Sweep-engine reproductions of the paper's figures (Figs 1–3), and
Fig 6's reshape of the elastic trainer's churn benchmark.

The port's copy of ``benchmarks/figures.py``.  Each function returns a
dict of series suitable for CSV/JSON dumping; :mod:`repro_torch.bench.run`
orchestrates them and derives a one-line summary of each.  The default
scale is small (200 nodes, d 100, 20 s); ``full=True`` is the paper's
setting (1000 nodes, d 1000, 40 s, β = 1 % of the system size).

Every figure is a *sweep* — barrier × scenario parameter — so each is
one :func:`repro_torch.core.run_sweep` call that advances every scenario
of the figure at once.  Each function takes ``backend`` (``"torch"``, the
default: the fused tick, on the card unless ``device`` says otherwise;
or ``"numpy"``: the host grid engine, bit for bit the reference's) and
``device`` (the torch backend's only).

:func:`fig1_error_bands` adds mean ± std bands over seeds.  The torch
backend draws one noise block per batch and shares it across the
batch's rows, which would correlate the seeds and understate their
spread, so on that backend the bands run one :func:`run_sweep` call per
seed: each batch's generator is seeded from its own rows' seeds, and no
two seeds share a batch.  The numpy backend decorrelates rows by
consuming its stream in finisher order, and runs all seeds in one call,
as the reference does.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np

from repro_torch.bench import churn_bench
from repro_torch.configs.psp_linear import PSPLinearConfig
from repro_torch.core.barriers import make_barrier
from repro_torch.core.simulator import SimConfig
from repro_torch.core.vector_sim import run_sweep

__all__ = ["FIVE", "fig1_error", "fig1_error_bands", "fig1_messages",
           "fig1_progress", "fig1_sample_sweep", "fig2_slowness",
           "fig2_stragglers", "fig3_scalability", "fig6_adaptive_churn"]

FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")


def _scale(full: bool) -> PSPLinearConfig:
    if full:
        return PSPLinearConfig()
    return PSPLinearConfig(n_nodes=200, dim=100, duration=20.0)


def _bar(name: str, c: PSPLinearConfig):
    return make_barrier(name, staleness=c.ssp_staleness,
                        sample_size=c.sample_size)


def _cfg(name: str, c: PSPLinearConfig, **kw) -> SimConfig:
    kw.setdefault("seed", c.seed)
    return SimConfig(n_nodes=c.n_nodes, duration=c.duration, dim=c.dim,
                     barrier=_bar(name, c), **kw)


@functools.lru_cache(maxsize=4)
def _fig1_sweep(full: bool, backend: str = "torch", device=None):
    """Figs 1a/1d/1e share the same five runs — sweep once per scale."""
    c = _scale(full)
    return c, run_sweep([_cfg(name, c) for name in FIVE], backend=backend,
                        device=device)


def fig1_progress(full: bool = False, backend: str = "torch",
                  device=None) -> Dict:
    """Fig 1a/1b: final step distribution of the five strategies."""
    c, results = _fig1_sweep(full, backend, device)
    out = {}
    for name, r in zip(FIVE, results):
        out[name] = {"mean": float(r.mean_progress),
                     "min": int(r.steps.min()), "max": int(r.steps.max()),
                     "cdf_steps": np.sort(r.steps).tolist()[:: max(1,
                         c.n_nodes // 50)]}
    return out


def fig1_sample_sweep(full: bool = False, backend: str = "torch",
                      device=None) -> Dict:
    """Fig 1c: pBSP parameterised by sample size 0 → 64."""
    c = _scale(full)
    betas = (0, 1, 2, 4, 16, 64)
    cfgs = [SimConfig(n_nodes=c.n_nodes, duration=c.duration, dim=c.dim,
                      barrier=(make_barrier("asp") if beta == 0 else
                               make_barrier("pbsp", sample_size=beta)),
                      seed=c.seed)
            for beta in betas]
    out = {}
    for beta, r in zip(betas, run_sweep(cfgs, backend=backend,
                                        device=device)):
        out[f"beta={beta}"] = {"mean": float(r.mean_progress),
                               "spread": int(r.steps.max() - r.steps.min())}
    return out


def fig1_error(full: bool = False, backend: str = "torch",
               device=None) -> Dict:
    """Fig 1d: normalized L2 model error over time."""
    _, results = _fig1_sweep(full, backend, device)
    out = {}
    for name, r in zip(FIVE, results):
        out[name] = {"times": r.times.tolist(),
                     "errors": r.errors.tolist(),
                     "final": float(r.final_error)}
    return out


def fig1_messages(full: bool = False, backend: str = "torch",
                  device=None) -> Dict:
    """Fig 1e: cumulative updates received by the server."""
    _, results = _fig1_sweep(full, backend, device)
    out = {}
    for name, r in zip(FIVE, results):
        out[name] = {"times": r.times.tolist(),
                     "updates": r.server_updates.tolist(),
                     "total": int(r.total_updates)}
    return out


def fig1_error_bands(full: bool = False, seeds: Sequence[int] = (0, 1, 2, 3),
                     backend: str = "torch", device=None) -> Dict:
    """Fig 1d with mean ± std bands over seeds.

    Per barrier the band is ``mean ± std`` of the error trace across
    seeds (``lo``/``hi`` clipped at 0 — errors are norms).  On the torch
    backend each seed is its own :func:`run_sweep` call (its own batch,
    its own generator), so no seed shares another's dynamics draws; the
    numpy backend runs every barrier × seed row in one call.
    """
    c = _scale(full)
    if backend == "numpy":
        cfgs = [_cfg(name, c, seed=s) for name in FIVE for s in seeds]
        results = run_sweep(cfgs, backend=backend, device=device)
    else:
        per_seed = [run_sweep([_cfg(name, c, seed=s) for name in FIVE],
                              backend=backend, device=device)
                    for s in seeds]
        results = [per_seed[j][i] for i in range(len(FIVE))
                   for j in range(len(seeds))]
    out = {}
    for i, name in enumerate(FIVE):
        rs = results[i * len(seeds):(i + 1) * len(seeds)]
        errs = np.stack([r.errors for r in rs])          # [S, M]
        mean, std = errs.mean(axis=0), errs.std(axis=0)
        out[name] = {"times": rs[0].times.tolist(),
                     "mean": mean.tolist(),
                     "std": std.tolist(),
                     "lo": np.maximum(mean - std, 0.0).tolist(),
                     "hi": (mean + std).tolist(),
                     "final_mean": float(mean[-1]),
                     "final_std": float(std[-1])}
    return out


def fig2_stragglers(full: bool = False, backend: str = "torch",
                    device=None) -> Dict:
    """Fig 2a/2b: straggler-fraction sweep 0 → 30% (4× slow)."""
    c = _scale(full)
    fracs = (0.0, 0.05, 0.1, 0.2, 0.3)
    results = run_sweep([_cfg(name, c, straggler_frac=frac)
                         for name in FIVE for frac in fracs],
                        backend=backend, device=device)
    out = {}
    for i, name in enumerate(FIVE):
        rows, base = [], None
        for frac, r in zip(fracs, results[i * len(fracs):]):
            if base is None:
                base = (r.mean_progress, r.final_error)
            rows.append({"frac": frac,
                         "progress_ratio": float(r.mean_progress / base[0]),
                         "error_increase": float(r.final_error - base[1])})
        out[name] = rows
    return out


def fig2_slowness(full: bool = False, backend: str = "torch",
                  device=None) -> Dict:
    """Fig 2c: 5% stragglers, slowness 1× → 16×."""
    c = _scale(full)
    slows = (1.0, 2.0, 4.0, 8.0, 16.0)
    results = run_sweep([_cfg(name, c, straggler_frac=0.05,
                              straggler_slowdown=slow)
                         for name in FIVE for slow in slows],
                        backend=backend, device=device)
    out = {}
    for i, name in enumerate(FIVE):
        rows, base = [], None
        for slow, r in zip(slows, results[i * len(slows):]):
            if base is None:
                base = r.mean_progress
            rows.append({"slowness": slow,
                         "progress_ratio": float(r.mean_progress / base)})
        out[name] = rows
    return out


def fig3_scalability(full: bool = False, backend: str = "torch",
                     device=None) -> Dict:
    """Fig 3: 5% stragglers, system size 100 → 1000 (fixed 10-node sample).

    Sizes form distinct structural groups; ``run_sweep`` batches each
    size (the torch backend: each power-of-two bucket of sizes) across
    all five barriers automatically.
    """
    sizes = (100, 250, 500, 1000) if full else (50, 100, 200)
    duration = 40.0 if full else 20.0
    results = run_sweep([SimConfig(
        n_nodes=n, duration=duration, dim=100,
        barrier=make_barrier(name, staleness=4, sample_size=10),
        straggler_frac=0.05, seed=0)
        for name in FIVE for n in sizes], backend=backend, device=device)
    out = {}
    for i, name in enumerate(FIVE):
        rows, base = [], None
        for n, r in zip(sizes, results[i * len(sizes):]):
            if base is None:
                base = r.mean_progress
            rows.append({"n": n, "progress_pct": float(
                100.0 * r.mean_progress / base)})
        out[name] = rows
    return out


def fig6_adaptive_churn(full: bool = False, backend: str = "torch",
                        device=None) -> Dict:
    """Adaptive-vs-static convergence curves (virtual wall-clock x-axis).

    For each adaptive barrier policy (DSSP / Elastic-BSP / annealed pBSP
    / annealed pSSP) and its static parent, the normalized-error-vs-
    virtual-time trace of the elastic trainer under the two
    :mod:`repro_torch.bench.churn_bench` scenarios (Poisson churn, heavy
    stragglers).  Series are keyed ``{scenario}/{policy}`` with a
    ``pair`` field linking each adaptive curve to its parent; the
    ``adaptive_vs_static`` scoreboard (error at equal virtual time)
    rides along under ``"scoreboard"``.  Read from the cached
    :func:`~repro_torch.bench.churn_bench.elastic_churn` result;
    ``backend`` is ignored, as there.
    """
    res = churn_bench.elastic_churn(full=full, backend=backend,
                                    device=device)
    out: Dict = {"scoreboard": res["adaptive_vs_static"]}
    scenarios = {"churn": {k: res[k] for k in churn_bench.NINE},
                 "stragglers": res["stragglers"]}
    for scenario, runs in scenarios.items():
        for name, parent in churn_bench.PARENT.items():
            for member, role in ((name, "adaptive"), (parent, "static")):
                r = runs[member]
                out[f"{scenario}/{member}"] = {
                    "role": role,
                    "pair": f"{name} vs {parent}",
                    "virtual_time": r["virtual_time"],
                    "error": r["error"],
                    "final_error": r["final_error"],
                }
    return out
