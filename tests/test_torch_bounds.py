"""The port's Theorem 1–3 bounds against the reference's, exactly.

Every function of ``repro_torch.core.bounds`` over a grid of a = F(r)^β,
β, r and T gives the reference's value (floats compared with ``==``),
including the a = 1 divergence (the O(T) and O(T²) forms), a = 0, and
the ``ValueError`` for a outside [0, 1] and for a degenerate pmf.
"""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import bounds as jb  # noqa: E402
from repro_torch.core import bounds as tb  # noqa: E402

A = (0.0, 1e-6, 0.02, 0.25, 0.5, 0.75, 0.98, 1.0 - 1e-13, 1.0)
BETAS = (1, 2, 5, 100)
RS = (0, 1, 4)
TS = (5, 100, 10_000)
GRID = list(itertools.product(A, BETAS, RS, TS))


def _same(fn, *args):
    """Both packages' ``fn(*args)``: equal values, or the same error."""
    try:
        want = getattr(jb, fn)(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            getattr(tb, fn)(*args)
        return None
    got = getattr(tb, fn)(*args)
    assert got == want, (fn, args, got, want)
    return got


@pytest.mark.parametrize("fn", ["mean_lag_bound", "variance_lag_bound"])
def test_lag_bounds_equal_reference(fn):
    for a, beta, r, T in GRID:
        F_r = a ** (1.0 / beta)
        _same(fn, F_r, beta, r, T)


def test_alpha_equals_reference():
    for a, beta, r, T in GRID:
        _same("psp_alpha", a ** (1.0 / beta), beta, T, r)


def test_a_equal_one_diverges_as_reference():
    """At a = 1 the mean bound is the O(T) Eq. 49 and the variance bound
    O(T²); both grow with T."""
    m = [tb.mean_lag_bound(1.0, 3, 4, T) for T in (100, 1000, 10_000)]
    v = [tb.variance_lag_bound(1.0, 3, 4, T) for T in (100, 1000, 10_000)]
    assert m[0] < m[1] < m[2] and v[0] < v[1] < v[2]
    assert m == [jb.mean_lag_bound(1.0, 3, 4, T) for T in (100, 1000,
                                                          10_000)]


@pytest.mark.parametrize("bad", [-0.1, 1.5, 2.0])
def test_out_of_range_raises(bad):
    for mod in (jb, tb):
        for fn in (mod.psp_alpha, mod.mean_lag_bound, mod.variance_lag_bound):
            with pytest.raises(ValueError, match=r"must be in \[0,1\]"):
                fn(bad, 1, 2, 10) if fn is not mod.psp_alpha \
                    else fn(bad, 1, 10, 2)


@pytest.mark.parametrize("beta,r,T", [(1, 0, 10), (5, 2, 12), (100, 4, 30),
                                      (2, 3, 3)])
def test_lag_pmf_equals_reference(beta, r, T):
    rng = np.random.default_rng(beta * 100 + r)
    for n in (T + 1, T // 2 + 1, T + 5):   # padded, truncated, longer
        f = rng.random(n)
        f /= f.sum()
        np.testing.assert_array_equal(tb.psp_lag_pmf(f, beta, r, T),
                                      jb.psp_lag_pmf(f, beta, r, T))
    point = np.zeros(T + 1)
    point[0] = 1.0                       # F(r) = 1: a = 1
    np.testing.assert_array_equal(tb.psp_lag_pmf(point, beta, r, T),
                                  jb.psp_lag_pmf(point, beta, r, T))


def test_lag_pmf_errors_as_reference():
    f = np.zeros(6)
    f[5] = 1.0                           # F(r) = 0 and an empty head
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="no probability mass"):
            mod.psp_lag_pmf(f, 2, 1, 5)
        with pytest.raises(ValueError, match=r"must be in \[0,1\]"):
            mod.psp_lag_pmf(np.full(6, 0.5), 1, 2, 5)


def test_regret_constants_and_tail_equal_reference():
    for P, sigma, L, F_r, beta, r, T in itertools.product(
            (10, 1000), (0.1, 1.0), (0.5, 2.0), (0.3, 0.9, 1.0), (1, 10),
            (0, 4), (100, 10_000)):
        a = jb.psp_regret_constants(P, sigma, L, F_r, beta, r, T)
        b = tb.psp_regret_constants(P, sigma, L, F_r, beta, r, T)
        assert (b.q, b.c, b.b) == (a.q, a.c, a.b)
        for delta in (0.01, 1.0, 50.0):
            assert tb.regret_tail_bound(b, T, delta) == \
                jb.regret_tail_bound(a, T, delta)
        a = jb.asp_regret_constants(P, sigma, L, 0.3, 0.7, T)
        b = tb.asp_regret_constants(P, sigma, L, 0.3, 0.7, T)
        assert (b.q, b.c, b.b) == (a.q, a.c, a.b)
    with pytest.raises(Exception):
        b.q = 1.0                        # frozen, as the reference's


@pytest.mark.parametrize("T", [None, 3, 20])
def test_empirical_lag_distribution_equals_reference(T):
    steps = np.random.default_rng(1).integers(0, 12, 50)
    np.testing.assert_array_equal(tb.empirical_lag_distribution(steps, T),
                                  jb.empirical_lag_distribution(steps, T))


def test_exports_match_reference():
    assert sorted(tb.__all__) == sorted(jb.__all__)
