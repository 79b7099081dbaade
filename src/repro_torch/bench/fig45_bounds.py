"""Figs 4 & 5: bounds on the mean/variance of the PSP lag distribution.

The port's copy of ``benchmarks/fig45_bounds.py``.  Sweeps a = F(r)^β
over (0, 1) for sample counts β ∈ {1, 5, 100} with r = 4, T = 10000 —
the paper's plot axes.  Fig 4 also overlays an *empirical* mean lag per
β, measured by one batched pSSP sweep through
:func:`repro_torch.core.run_sweep` (on the card by default), tying the
theory curves to the simulated system.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.barriers import make_barrier
from repro_torch.core.bounds import mean_lag_bound, variance_lag_bound
from repro_torch.core.simulator import SimConfig
from repro_torch.core.vector_sim import run_sweep

__all__ = ["BETAS", "R", "T", "derived_summary", "empirical_mean_lags",
           "fig4_mean_bound", "fig5_variance_bound"]

BETAS = (1, 5, 100)
R, T = 4, 10_000


def empirical_mean_lags(full: bool = False, backend: str = "torch",
                        device=None) -> Dict[int, float]:
    """Simulated mean lag for each β (one batched pSSP sweep)."""
    n, dur = (1000, 40.0) if full else (200, 10.0)
    cfgs = [SimConfig(n_nodes=n, duration=dur, dim=32, seed=0,
                      barrier=make_barrier("pssp", staleness=R,
                                           sample_size=beta))
            for beta in BETAS]
    out = {}
    for beta, r in zip(BETAS, run_sweep(cfgs, backend=backend,
                                        device=device)):
        out[beta] = float((r.steps.max() - r.steps).mean())
    return out


def fig4_mean_bound(full: bool = False, backend: str = "torch",
                    device=None) -> Dict:
    """x-axis is a = F(r)^β (the paper's Fig-4 axis; the discontinuities
    it discusses live at a=0 and a=1); per curve F(r) = a^{1/β}."""
    grid = np.linspace(0.02, 0.98, 49)
    lags = empirical_mean_lags(full, backend, device)
    out = {}
    for beta in BETAS:
        out[f"beta={beta}"] = {
            "a": grid.tolist(),
            "bound": [float(mean_lag_bound(a ** (1.0 / beta), beta, R, T))
                      for a in grid],
            "empirical_mean_lag": lags[beta]}
    return out


def fig5_variance_bound() -> Dict:
    """Fig 5: the variance-of-lag bound over the same a grid per β."""
    grid = np.linspace(0.02, 0.98, 49)
    out = {}
    for beta in BETAS:
        out[f"beta={beta}"] = {
            "a": grid.tolist(),
            "bound": [float(variance_lag_bound(a ** (1.0 / beta), beta, R,
                                               T)) for a in grid]}
    return out


def derived_summary() -> str:
    """The paper's headline: small β reaches near-optimal bounds (at
    equal a, larger β means heavier underlying lag yet a comparable
    bound)."""
    a = 0.5
    b1 = mean_lag_bound(a ** (1.0 / 1), 1, R, T)
    b5 = mean_lag_bound(a ** (1.0 / 5), 5, R, T)
    b100 = mean_lag_bound(a ** (1.0 / 100), 100, R, T)
    return (f"mean_bound@a=0.5 beta1={b1:.2f} beta5={b5:.2f} "
            f"beta100={b100:.2f}")
