"""The port's PSP trainer (``repro_torch.core.spmd_psp``), its barrier
policies and ``sample_steps`` against the reference
(``repro.core.spmd_psp``, ``repro.core.barrier_kernel``,
``repro.core.sampling``).

The reference runs eagerly, under ``jax.disable_jit()`` (jitted XLA
contracts ``now + base·(1 + (u − ½))`` into a fused multiply-add, one
ulp away from any unfused evaluation).  Every draw it makes from its own
key splits (``key, k_bar, k_dur[, k_churn] = split(key, 3|4)``; the
churn's ``split(k_churn)``; the init's ``split(key, 3)`` and straggler
permutation) is made here with JAX and replayed into the port through
:class:`~repro_torch.core.spmd_psp.ReplayNoise`, with the reference's
minibatches and ground truth.  The control plane (step, busy_until,
pushed, now, alive, cursors, tick, total_pushes, the slow flags and the
policy state) must then be equal bit for bit after every tick; the
linear model ``w`` agrees within rtol 1e-5, atol 1e-6 (the masked sum
and the gradient are summed in another order than XLA's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro.core.sampling import sample_steps_jax  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.core.sampling import sample_steps  # noqa: E402

BARRIERS = ("bsp", "ssp", "asp", "pbsp", "pssp", "dssp", "ebsp", "apbsp",
            "apssp")
W, DIM, BATCH, TICKS = 6, 8, 4, 12
CHURN = dict(leave_rate=30.0, join_rate=30.0, horizon=2.0, seed=5)
W_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype or np.float32))


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _init_record(w):
    """The reference's init draws (psp_init under PRNGKey(1)) as a port
    record: the permutation as scores whose stable argsort is it."""
    k_slow, k_dur, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    perm = np.asarray(jax.random.permutation(k_slow, jnp.arange(w)))
    scores = np.empty(w, np.float32)
    scores[perm] = np.arange(w)
    return {"perm": torch.from_numpy(scores),
            "dur": _u(k_dur, (w,))}


def _tick_record(cfg, key):
    """The draws the reference makes from state key ``key`` in one tick."""
    w = cfg.n_workers
    if cfg.has_churn:
        _, k_bar, k_dur, k_churn = jax.random.split(key, 4)
        k_leave, k_join = jax.random.split(k_churn)
        rec = {"leave": _u(k_leave, (w,)), "join": _u(k_join, (w,))}
    else:
        _, k_bar, k_dur = jax.random.split(key, 3)
        rec = {}
    rec["dur"] = _u(k_dur, (w,))
    kind = cfg.noise_kind()
    if kind == "scores":
        rec["scores"] = _u(k_bar, (w, w))
    elif kind == "u":
        rec["u"] = _u(k_bar, (w,))
    return rec


def _configs(kw):
    churn = kw.pop("churn", None)
    return (jsp.PSPConfig(**kw, churn=churn and jsp.ChurnConfig(**churn)),
            sp.PSPConfig(**kw, churn=churn and sp.ChurnConfig(**churn)))


CONTROL = ("step", "busy_until", "pushed", "now", "alive", "leave_cursor",
           "join_cursor", "tick", "total_pushes", "slow")


def _check_state(js, ts, t):
    for f in CONTROL:
        np.testing.assert_array_equal(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
            err_msg=f"{f} after tick {t}")
    assert set(ts.policy) == set(js.policy)
    for k, v in js.policy.items():
        np.testing.assert_array_equal(ts.policy[k].numpy(), np.asarray(v),
                                      err_msg=f"policy[{k}] tick {t}")
    np.testing.assert_allclose(ts.server_params["w"].numpy(),
                               np.asarray(js.server_params["w"]), **W_TOL)
    np.testing.assert_allclose(ts.views["w"].numpy(),
                               np.asarray(js.views["w"]), **W_TOL)


def _run_both(kw, events=None, ticks=TICKS):
    """Drive both trainers tick for tick on the same draws; compare."""
    jcfg, tcfg = _configs(dict(kw))
    events = events or {}
    with jax.disable_jit():
        w_true, grad_fn, opt_update = jsp.linear_psp_task(DIM)
        js = jsp.linear_psp_state(jcfg, DIM)
        kb = jax.random.PRNGKey(2)
        recs, xs = [], []
        for t in range(ticks):
            if t in events:
                js = jsp.apply_external_churn(jcfg, js, leave=events[t][0],
                                              join=events[t][1])
            kb, k1 = jax.random.split(kb)
            x = jax.random.normal(k1, (jcfg.n_workers, BATCH, DIM))
            recs.append(_tick_record(tcfg, js.key))
            xs.append(_t(x))
            js, jm = jsp.psp_train_step(jcfg, grad_fn, opt_update, js,
                                        (x, x @ w_true))
            recs[-1]["_state"], recs[-1]["_loss"] = js, jm["loss"]
    noise = sp.ReplayNoise(_init_record(tcfg.n_workers),
                           [{k: v for k, v in r.items() if k[0] != "_"}
                            for r in recs])
    _, it = sp.elastic_drive(tcfg, DIM, ticks, noise=noise, xs=xs,
                             w_true=_t(w_true), events=events)
    for t, (ts, tm) in enumerate(it):
        _check_state(recs[t]["_state"], ts, t)
        np.testing.assert_allclose(float(tm["loss"]), float(recs[t]["_loss"]),
                                   rtol=1e-5)
    return ts


@pytest.mark.parametrize("churn", [False, True], ids=["fixed", "churn"])
@pytest.mark.parametrize("barrier", BARRIERS)
def test_trainer_matches_reference(barrier, churn):
    kw = dict(barrier=barrier, n_workers=W, sample_size=2, staleness=1,
              straggler_frac=0.34, max_advance=2, staleness_lo=0)
    if churn:
        kw["churn"] = CHURN
    ts = _run_both(kw)
    assert int(ts.total_pushes) > 0


@pytest.mark.parametrize("contribution,churn", [
    ("sum", False), ("mean-alive", True), ("mean-alive", False)])
def test_contribution_modes_match_reference(contribution, churn):
    kw = dict(barrier="pssp", n_workers=W, sample_size=2, staleness=1,
              straggler_frac=0.34, contribution=contribution)
    if churn:
        kw["churn"] = CHURN
    _run_both(kw)


def test_beta_one_uniform_path_matches_reference():
    """β = 1 without churn takes the one-uniform-per-worker path."""
    cfg = sp.PSPConfig(barrier="pbsp", n_workers=W, sample_size=1)
    assert cfg.noise_kind() == "u"
    _run_both(dict(barrier="pbsp", n_workers=W, sample_size=1, staleness=0,
                   straggler_frac=0.34))


def test_churn_fires_leaves_and_joins():
    """The churn replay above is not vacuous: workers leave and rejoin."""
    ts = _run_both(dict(barrier="pssp", n_workers=W, sample_size=2,
                        staleness=1, churn=CHURN), ticks=20)
    assert int(ts.leave_cursor) > 0 and int(ts.join_cursor) > 0


def test_external_churn_matches_reference():
    """apply_external_churn / external_drive: a two-worker kill, a no-op
    leave of a dead worker, rejoins."""
    events = {2: ((1, 4), ()), 4: ((1,), (4,)), 7: ((), (1, 2))}
    ts = _run_both(dict(barrier="ssp", n_workers=W, staleness=1,
                        straggler_frac=0.34), events=events)
    assert ts.alive.all()
    _, it = sp.external_drive(sp.PSPConfig(barrier="ssp", n_workers=W),
                              DIM, 3, {1: ((0,), ())})
    states = [s for s, _ in it]
    assert not bool(states[-1].alive[0])


def test_state_tree_round_trip():
    cfg = sp.PSPConfig(barrier="dssp", n_workers=4)
    st = sp.linear_psp_state(cfg, DIM, sp.GeneratorNoise(0))
    back = sp.state_from_tree(sp.state_to_tree(st))
    assert back._fields == st._fields and "thr" in back.policy


@pytest.mark.parametrize("beta", [0, 1, 3, 9])
@pytest.mark.parametrize("batched", [False, True])
def test_sample_steps_matches_reference(beta, batched):
    n = 7
    key = jax.random.PRNGKey(beta + 10 * batched)
    rng = np.random.default_rng(beta)
    steps = rng.integers(0, 20, size=(3, n) if batched else (n,)).astype(
        np.int32)
    want, wvalid = sample_steps_jax(key, jnp.asarray(steps), beta)
    noise = {}
    if 0 < min(beta, n):
        noise = ({"u": _u(key, (n,))} if beta == 1
                 else {"scores": _u(key, (n, n))})
    got, valid = sample_steps(torch.from_numpy(steps), beta, **noise)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    v = valid.numpy()
    np.testing.assert_array_equal(got.numpy()[v], np.asarray(want)[v])


@pytest.mark.parametrize("barrier", ["bsp", "ssp", "asp", "pbsp", "pssp"])
@pytest.mark.parametrize("beta", [1, 3])
def test_barrier_allowed_matches_reference(barrier, beta):
    """``_barrier_allowed`` (the static predicate through
    ``BarrierKernel``) on the reference's own draw, with and without an
    alive mask."""
    key = jax.random.PRNGKey(beta)
    steps = np.array([3, 0, 5, 2, 4, 4, 1], np.int32)
    alive = np.array([1, 1, 0, 1, 1, 0, 1], bool)
    kw = dict(barrier=barrier, n_workers=7, staleness=1, sample_size=beta)
    jcfg, tcfg = jsp.PSPConfig(**kw), sp.PSPConfig(**kw)
    for mask in (None, alive):
        want = jsp._barrier_allowed(jcfg, key, jnp.asarray(steps),
                                    None if mask is None else
                                    jnp.asarray(mask))
        kind = tcfg.barrier_kernel.noise_kind(7, mask is not None)
        noise = {} if kind is None else {
            kind: _u(key, (7, 7) if kind == "scores" else (7,))}
        got = sp._barrier_allowed(
            tcfg, torch.from_numpy(steps),
            None if mask is None else torch.from_numpy(mask), **noise)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("barrier", BARRIERS)
def test_policy_state_matches_reference(barrier):
    """``make_policy``: ``stateful`` as the reference's, and ``init``'s
    state (keys, dtypes, values) equal to the reference's, non-empty
    exactly when the policy is stateful."""
    from repro.core import barrier_kernel as jbk
    from repro_torch.core import barrier_kernel as tbk
    kw = dict(staleness=3, beta=3, staleness_lo=1, beta_lo=1)
    jpol, tpol = jbk.make_policy(barrier, **kw), tbk.make_policy(barrier, **kw)
    assert tpol.stateful == jpol.stateful
    want, got = jpol.init(W), tpol.init(W)
    assert bool(got) == tpol.stateful
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert got[k].numpy().dtype == np.asarray(v).dtype
