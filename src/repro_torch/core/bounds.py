"""Theoretical analysis of PSP (paper §6–§7), in executable form: the
port's copy of :mod:`repro.core.bounds`.

* :func:`psp_lag_pmf` — Theorem 2: the lag distribution a PSP barrier
  induces,
    p(s) = α·f(s)                 for s ≤ r
    p(s) = α·(F(r)^β)^{s−r}       for s > r
  with the normalising constant α from Eq. 14–18 (geometric-series closed
  form when F(r)^β < 1, linear form when F(r)^β = 1).
* :func:`mean_lag_bound` — Eq. 54: bound on (1/T)·Σ E(γ_t)
* :func:`variance_lag_bound` — Eq. 55: bound on (1/T)·Σ E(γ_t²)
* :func:`regret_tail_bound` — the one-sided Bernstein tail (Theorem 1/3):
    P( R[X]/T − (σL² + 2F²/σ)/√T − q ≥ δ ) ≤ exp( −Tδ² / (c + bδ/3) )
  with q, c either the ASP constants (4PσLμ, 16P²σ²L²φ) or the PSP bounds
  above, so ASP and PSP bounds compare directly (§7.2).
* :func:`empirical_lag_distribution` — the lag histogram of a run, to
  hold the theory against the simulators.

Everything is plain numpy; :mod:`repro_torch.bench.fig45_bounds` plots
Figures 4 and 5 from it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = [
    "psp_alpha",
    "psp_lag_pmf",
    "mean_lag_bound",
    "variance_lag_bound",
    "regret_tail_bound",
    "asp_regret_constants",
    "psp_regret_constants",
    "empirical_lag_distribution",
]


def _check(a: float) -> None:
    if not (0.0 <= a <= 1.0):
        raise ValueError(f"a = F(r)^beta must be in [0,1], got {a}")


def psp_alpha(F_r: float, beta: int, T: int, r: int) -> float:
    """Normalising constant α (paper Eq. 41–42).

        α = (1−a) / ( F(r)(1−a) + a − a^{T−r+1} ),   a = F(r)^β,  a < 1
        α ≤ 1/(T−r)                                   when a = 1
    """
    a = F_r ** beta
    _check(a)
    if a >= 1.0 - 1e-12:
        return 1.0 / max(T - r, 1)
    denom = F_r * (1.0 - a) + a - a ** (T - r + 1)
    if denom <= 0:
        raise ValueError("degenerate distribution: no probability mass")
    return (1.0 - a) / denom


def psp_lag_pmf(f: np.ndarray, beta: int, r: int, T: int) -> np.ndarray:
    """Theorem 2: PSP-shaped lag pmf over s = 0..T.

    Args:
      f: pmf of the *underlying* lag distribution over s = 0..T (what workers
         would do with no barrier, i.e. under ASP).
      beta: sample size β.
      r: staleness r (r=0 ⇒ pBSP semantics).
      T: support upper end.

    Returns p: pmf over s = 0..T (sums to 1).
    """
    f = np.asarray(f, dtype=np.float64)
    if f.shape[0] < T + 1:
        f = np.pad(f, (0, T + 1 - f.shape[0]))
    F_r = float(np.sum(f[: r + 1]))
    a = F_r ** beta
    _check(a)
    s = np.arange(T + 1)
    p = np.where(s <= r, f[: T + 1], 0.0).astype(np.float64)
    tail = s > r
    if a > 0:
        p[tail] = a ** (s[tail] - r)
    else:
        p[tail] = 0.0
    z = p.sum()
    if z <= 0:
        raise ValueError("no probability mass (a=0 and empty head)")
    return p / z


def mean_lag_bound(F_r: float, beta: int, r: int, T: int) -> float:
    """Eq. 54: bound on the average of the means of the lags.

        (1/T)·Σ E(γ_t) ≤ α · ( r(r+1)/2 + a(r+2)/(1−a)² ),  a = F(r)^β < 1

    For a = 1 the paper shows the bound is O(T) (no convergence); we return
    that explicit O(T) expression (Eq. 49) so the discontinuity is visible in
    the Fig-4 reproduction.
    """
    a = F_r ** beta
    _check(a)
    if a >= 1.0 - 1e-12:
        # Eq. 49: (1/(T−r)) ( r(r+1)/2 + T² + T + Tr + r )
        return (r * (r + 1) / 2 + T**2 + T + T * r + r) / max(T - r, 1)
    alpha = psp_alpha(F_r, beta, T, r)
    return alpha * (r * (r + 1) / 2.0 + a * (r + 2) / (1.0 - a) ** 2)


def variance_lag_bound(F_r: float, beta: int, r: int, T: int) -> float:
    """Eq. 55: bound on the average of the variances of the lags.

        (1/T)·Σ E(γ_t²) < α · ( r(r+1)(2r+1)/6 + a(r²+4)/(1−a)³ )
    """
    a = F_r ** beta
    _check(a)
    if a >= 1.0 - 1e-12:
        # a=1 case of the squared arithmetico-geometric bound: O(T²)
        return (r * (r + 1) * (2 * r + 1) / 6
                + (T + 1) * (r + 1) ** 2 / 2
                + (T + 1) * (2 * T + 1) / 6
                + T * (T + 1) ** 2 / 12) / max(T - r, 1)
    alpha = psp_alpha(F_r, beta, T, r)
    return alpha * (r * (r + 1) * (2 * r + 1) / 6.0
                    + a * (r**2 + 4) / (1.0 - a) ** 3)


# --------------------------------------------------------------------------- #
# Regret tail bounds (Theorems 1 & 3)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RegretConstants:
    """(q, c, b) of P( R/T − (σL²+2F²/σ)/√T − q ≥ δ ) ≤ exp(−Tδ²/(c+bδ/3))."""

    q: float
    c: float
    b: float


def asp_regret_constants(P: int, sigma: float, L: float, mu: float,
                         phi: float, T: int) -> RegretConstants:
    """Theorem 1 (ASP): q = 4PσLμ, c = 16P²σ²L²φ, b ≤ 4PTσL."""
    return RegretConstants(q=4 * P * sigma * L * mu,
                           c=16 * P**2 * sigma**2 * L**2 * phi,
                           b=4 * P * T * sigma * L)


def psp_regret_constants(P: int, sigma: float, L: float, F_r: float,
                         beta: int, r: int, T: int) -> RegretConstants:
    """Theorem 3 (PSP): q via Eq. 23 (= 4PσL × Eq. 54's bracket), c via Eq. 24."""
    mean_b = mean_lag_bound(F_r, beta, r, T)
    var_b = variance_lag_bound(F_r, beta, r, T)
    return RegretConstants(q=4 * P * sigma * L * mean_b,
                           c=16 * P**2 * sigma**2 * L**2 * var_b,
                           b=4 * P * T * sigma * L)


def regret_tail_bound(consts: RegretConstants, T: int, delta: float) -> float:
    """exp(−Tδ² / (c + bδ/3)) — the Bernstein tail probability."""
    return float(np.exp(-T * delta**2 / (consts.c + consts.b * delta / 3.0)))


# --------------------------------------------------------------------------- #
# Empirical cross-check against the simulator
# --------------------------------------------------------------------------- #
def empirical_lag_distribution(steps: np.ndarray, T: Optional[int] = None
                               ) -> np.ndarray:
    """Histogram of lags (max-step minus each worker's step), normalised."""
    steps = np.asarray(steps)
    lags = steps.max() - steps
    T = int(T if T is not None else lags.max())
    pmf = np.bincount(lags, minlength=T + 1)[: T + 1].astype(np.float64)
    return pmf / pmf.sum()
