"""The port's sampling primitives and barrier-model functions against the
reference's (:mod:`repro.core.sampling`, :mod:`repro.core.barrier_kernel`)
on the same numpy inputs.  All of them are integer or elementwise f32
arithmetic, so they must agree exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import barrier_kernel as jbk  # noqa: E402
from repro.core import sampling as jsm  # noqa: E402
from repro_torch.core import barrier_kernel as tbk  # noqa: E402
from repro_torch.core import sampling as tsm  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scores(rng, shape, ties):
    """Uniform scores; with ``ties`` quantised so many of them collide."""
    s = rng.random(shape).astype(np.float32)
    return (np.floor(s * 4) / 4).astype(np.float32) if ties else s


@pytest.mark.parametrize("n,beta,ties", [(8, 3, False), (8, 3, True),
                                         (12, 12, True), (5, 1, False)])
def test_sample_peer_indices(n, beta, ties):
    rng = np.random.default_rng(n * 10 + beta)
    sc = _scores(rng, (n, n), ties)
    u = rng.random(n).astype(np.float32)
    j_take, j_valid = jsm.sample_peer_indices_jax(None, n, beta, scores=sc,
                                                  u=u)
    t_take, t_valid = tsm.sample_peer_indices(n, beta, scores=_t(sc),
                                              u=_t(u))
    j_take, j_valid = np.asarray(j_take), np.asarray(j_valid)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    np.testing.assert_array_equal(np.where(j_valid, t_take.numpy(), -1),
                                  np.where(j_valid, j_take, -1))


@pytest.mark.parametrize("ties", (False, True))
def test_sample_alive_peer_indices(ties):
    rng = np.random.default_rng(7)
    B, n, beta = 4, 10, 4
    alive = rng.random((B, n)) < 0.6
    sc = _scores(rng, (B, n, n), ties)
    j_take, j_valid = jsm.sample_alive_peer_indices_jax(None, alive, beta,
                                                        scores=sc)
    t_take, t_valid = tsm.sample_alive_peer_indices(_t(alive), beta,
                                                    scores=_t(sc))
    j_take, j_valid = np.asarray(j_take), np.asarray(j_valid)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    np.testing.assert_array_equal(np.where(j_valid, t_take.numpy(), -1),
                                  np.where(j_valid, j_take, -1))


@pytest.fixture
def row_state():
    rng = np.random.default_rng(3)
    B, P = 4, 9
    return {
        "steps": rng.integers(0, 8, (B, P)).astype(np.int32),
        "alive": rng.random((B, P)) < 0.7,
        "stal": rng.integers(0, 3, (B, P)).astype(np.int32),
        "beta": rng.integers(0, 4, (B, 1)).astype(np.int32),
        "u": rng.random((B, P)).astype(np.float32),
        "base": (0.05 + rng.random((B, P))).astype(np.float32),
        "scores": rng.random((B, P, P)).astype(np.float32),
        "shared": rng.random((P, P)).astype(np.float32),
        "u1": rng.random(P).astype(np.float32),
        "ema": (rng.random((B, P)) * 0.3).astype(np.float32),
        "range": (rng.random((B, 1)) * 4).astype(np.float32),
        "valid": rng.random((B, P)) < 0.9,
    }


def test_step_duration_and_full_view(row_state):
    s = row_state
    np.testing.assert_array_equal(
        tbk.step_duration(_t(s["u"]), _t(s["base"])).numpy(),
        np.asarray(jbk.step_duration(s["u"], s["base"])))
    for alive in (None, s["alive"]):
        got = tbk.full_view_allowed(_t(s["steps"]), _t(s["stal"]),
                                    None if alive is None else _t(alive))
        want = jbk.full_view_allowed(s["steps"], s["stal"], alive)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ("masked", "shared", "u1"))
def test_sampled_allowed(row_state, mode):
    s = row_state
    k = 1 if mode == "u1" else 3
    kw_j = {"scores": s["scores"], "alive": s["alive"]} if mode == "masked" \
        else ({"scores": s["shared"]} if mode == "shared" else {"u": s["u1"]})
    kw_t = {k_: (_t(v) if isinstance(v, np.ndarray) else v)
            for k_, v in kw_j.items()}
    ok_j, n_j = jbk.sampled_allowed(s["steps"], s["stal"], k,
                                    beta=s["beta"], **kw_j)
    ok_t, n_t = tbk.sampled_allowed(_t(s["steps"]), _t(s["stal"]), k,
                                    beta=_t(s["beta"]), **kw_t)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert n_t.dtype == torch.int32


def test_churn_selection_and_policy_observables(row_state):
    s = row_state
    alive, valid = s["alive"] & s["valid"], s["valid"]
    np.testing.assert_array_equal(
        tbk.churn_victim(_t(s["u"]), _t(alive)).numpy(),
        np.asarray(jbk.churn_victim(s["u"], alive)))
    for vs in (None, valid):
        np.testing.assert_array_equal(
            tbk.churn_joiner(_t(s["u"]), _t(alive),
                             None if vs is None else _t(vs)).numpy(),
            np.asarray(jbk.churn_joiner(s["u"], alive, vs)))
    dead = np.zeros_like(alive)
    dead[0] = alive[0]                       # rows 1.. have no alive node
    for a in (None, alive, dead):
        np.testing.assert_array_equal(
            tbk.progress_gap(_t(s["steps"]),
                             None if a is None else _t(a)).numpy(),
            np.asarray(jbk.progress_gap(s["steps"], a)))
        np.testing.assert_array_equal(
            tbk.elastic_slack(_t(s["ema"]), _t(s["range"]),
                              None if a is None else _t(a)).numpy(),
            np.asarray(jbk.elastic_slack(s["ema"], s["range"], a)))


def test_ties_follow_lower_index():
    """Equal scores select the lower index first, as ``lax.top_k`` does."""
    sc = torch.zeros((4, 4))
    take, valid = tsm.sample_peer_indices(4, 2, scores=sc)
    assert take.tolist() == [[1, 2], [0, 2], [0, 1], [0, 1]]
    assert valid.all()
