"""The port's event engine, overlay, host samplers and engines against
the reference's, bit for bit on the same seeds.

* ``run_simulation``: every ``SimResult`` field equal over the five
  static barriers, the four adaptive ones, distributed sampling through
  the Chord overlay, and churn (leaves and joins re-arming on
  exponential gaps), centralised and distributed.
* ``ChordOverlay``, ``FullMembershipOverlay``, ``CentralSampler`` and
  ``OverlaySampler``: the same ids, samples, hop costs and population
  estimates over a seeded sequence of joins, leaves and samples.
* The three engines: the reference's ``tests/test_engines.py`` cases on
  the port, their results equal to the reference's, and
  ``Engine.run_sweep`` on the plain tick (``device="cpu"``) and on the
  numpy backend (equal to the reference's numpy sweep).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import barriers as jbar  # noqa: E402
from repro.core import engines as jeng  # noqa: E402
from repro.core import overlay as jov  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch.core import barriers as tbar  # noqa: E402
from repro_torch.core import engines as teng  # noqa: E402
from repro_torch.core import overlay as tov  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402

KNOBS = dict(staleness=3, sample_size=3, staleness_lo=1, sample_size_lo=1,
             max_advance=3)

CASES = [
    ("bsp", dict(n_nodes=24)),
    ("ssp", dict(n_nodes=24, straggler_frac=0.2)),
    ("asp", dict(n_nodes=24)),
    ("pbsp", dict(n_nodes=24, straggler_frac=0.2)),
    ("pssp", dict(n_nodes=32)),
    ("dssp", dict(n_nodes=24, straggler_frac=0.2)),
    ("ebsp", dict(n_nodes=24, straggler_frac=0.2)),
    ("apbsp", dict(n_nodes=24)),
    ("apssp", dict(n_nodes=16)),
    ("pbsp", dict(n_nodes=24, distributed_sampling=True)),
    ("apssp", dict(n_nodes=16, distributed_sampling=True)),
    ("pssp", dict(n_nodes=24, churn_leave_rate=2.0, churn_join_rate=1.5)),
    ("bsp", dict(n_nodes=16, churn_leave_rate=3.0, churn_join_rate=1.0)),
    ("ebsp", dict(n_nodes=16, churn_leave_rate=2.0, churn_join_rate=2.0)),
    ("pbsp", dict(n_nodes=24, distributed_sampling=True,
                  churn_leave_rate=2.0, churn_join_rate=2.0)),
    ("asp", dict(n_nodes=16, churn_leave_rate=1.0)),
]


def _cfg(sim, bar, name, seed=7, duration=3.0, **kw):
    return sim.SimConfig(barrier=bar.make_barrier(name, **KNOBS), dim=8,
                         duration=duration, seed=seed, **kw)


def _assert_same(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert type(x) is type(y), (what, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, (what, f.name)
        np.testing.assert_array_equal(y, x, err_msg=f"{what}: {f.name}")


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_run_simulation_equals_reference(name, kw):
    ref = jsim.run_simulation(_cfg(jsim, jbar, name, **kw))
    port = tsim.run_simulation(_cfg(tsim, tbar, name, **kw))
    _assert_same(ref, port, f"{name} {kw}")
    assert port.total_updates > 0
    if kw.get("distributed_sampling"):
        assert port.control_messages > 0


def test_simulator_state_equals_reference():
    """Beyond the result: the per-node views, the waiters, the adaptive
    state and the overlay's ring agree at the horizon."""
    kw = dict(n_nodes=20, distributed_sampling=True, churn_leave_rate=2.0,
              churn_join_rate=2.0)
    a = jsim.Simulator(_cfg(jsim, jbar, "apbsp", **kw))
    b = tsim.Simulator(_cfg(tsim, tbar, "apbsp", **kw))
    a.run(), b.run()
    np.testing.assert_array_equal(np.stack(b.pulled_w), np.stack(a.pulled_w))
    assert b._waiting == a._waiting
    assert (b._pol_beta, b._pol_thr) == (a._pol_beta, a._pol_thr)
    assert b.node_ids == a.node_ids and b.overlay._ids == a.overlay._ids
    assert b.now == a.now and b.control_messages == a.control_messages


def test_lag_pmf_equals_reference():
    a = jsim.run_simulation(_cfg(jsim, jbar, "pssp", n_nodes=24))
    b = tsim.run_simulation(_cfg(tsim, tbar, "pssp", n_nodes=24))
    np.testing.assert_array_equal(b.lag_pmf(), a.lag_pmf())


def _overlay_script(mod, seed):
    """A seeded sequence of joins, leaves, samples and estimates."""
    ov = mod.ChordOverlay(seed=seed)
    ids = [ov.join(i) for i in range(40)]
    log = [list(ids)]
    rng = np.random.default_rng(seed + 99)
    for step in range(30):
        op = step % 5
        if op == 0 and len(ov) > 5:
            victim = ids.pop(int(rng.integers(len(ids))))
            ov.leave(victim)
            log.append(("leave", victim))
        elif op == 1:
            nid = ov.join(100 + step)
            ids.append(nid)
            log.append(("join", nid))
        elif op == 2:
            log.append(("sample", ov.sample(int(rng.integers(1, 9)),
                                            exclude=int(rng.integers(40)))))
        elif op == 3:
            log.append(("est", ov.estimate_population(
                probes=int(rng.integers(1, 16)))))
        else:
            p = int(rng.integers(0, mod.ID_SPACE, dtype=np.uint64))
            node = ov.successor(p)
            log.append(("succ", node.node_id, node.payload,
                        ov.lookup_hops(p), ov.sample_cost_hops(3)))
    log.append(("big", ov.sample(len(ov) + 5, exclude=None), len(ov)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_chord_overlay_equals_reference(seed):
    assert _overlay_script(tov, seed) == _overlay_script(jov, seed)


def test_chord_overlay_edges_match_reference():
    for mod in (jov, tov):
        ov = mod.ChordOverlay(seed=3)
        assert ov.sample(4) == [] and ov.estimate_population() == 0.0
        with pytest.raises(LookupError):
            ov.successor(0)
    assert (tov.ID_BITS, tov.ID_SPACE) == (jov.ID_BITS, jov.ID_SPACE)


@pytest.mark.parametrize("exclude", [None, 3])
def test_full_membership_overlay_equals_reference(exclude):
    a, b = (mod.FullMembershipOverlay(population=30, seed=4)
            for mod in (jov, tov))
    for beta in (0, 1, 5, 29, 40):
        assert b.sample(beta, exclude=exclude) == \
            a.sample(beta, exclude=exclude)
        assert b.sample_cost_hops(beta) == a.sample_cost_hops(beta)
    assert len(b) == len(a) == 30
    assert b.estimate_population() == a.estimate_population() == 30.0


def _sample_fields(s):
    return (s.steps.tolist(), s.worker_ids.tolist(), s.cost_hops,
            s.steps.dtype, s.worker_ids.dtype)


@pytest.mark.parametrize("n", [6, 50, 400])
def test_central_sampler_equals_reference(n):
    """Both draw paths (rejection for β·4 < n, else ``choice``), the full
    view, β = 0 and self-exclusion."""
    a, b = jsamp.CentralSampler(seed=9), tsamp.CentralSampler(seed=9)
    steps = np.random.default_rng(n).integers(0, 50, n)
    for beta in (None, 0, 1, 2, 3, 10, 99, n + 3):
        for exclude in (None, 0, n - 1):
            assert _sample_fields(b.sample(steps, beta, exclude)) == \
                _sample_fields(a.sample(steps, beta, exclude)), (beta,
                                                                 exclude)


@pytest.mark.parametrize("kind", ["chord", "full"])
def test_overlay_sampler_equals_reference(kind):
    def build(ov_mod, samp_mod):
        ov = (ov_mod.ChordOverlay(seed=2) if kind == "chord"
              else ov_mod.FullMembershipOverlay(population=25, seed=2))
        if kind == "chord":
            for i in range(25):
                ov.join(i)
        return samp_mod.OverlaySampler(ov)

    a, b = build(jov, jsamp), build(tov, tsamp)
    steps = np.arange(25) * 3
    for beta in (None, 1, 4, 24, 30):
        for exclude in (None, 5):
            assert _sample_fields(b.sample(steps, beta, exclude)) == \
                _sample_fields(a.sample(steps, beta, exclude))
    assert b.estimate_population() == a.estimate_population()


# ---- the three engines (the reference's tests/test_engines.py cases) ---- #
def test_ps_engine_hosts_everything():
    for b in ("bsp", "ssp", "asp", "pbsp", "pssp"):
        r = teng.ParameterServerEngine(b).run(n_nodes=32, duration=4.0,
                                              dim=8)
        assert r.mean_progress > 0
        ref = jeng.ParameterServerEngine(b).run(n_nodes=32, duration=4.0,
                                                dim=8)
        _assert_same(ref, r, b)


def test_p2p_rejects_global_state_barriers():
    for b in ("bsp", "ssp"):
        with pytest.raises(ValueError):
            teng.P2PEngine(b)
    with pytest.raises(ValueError):
        teng.P2PEngine("pbsp").run(barrier="bsp", n_nodes=4, duration=1.0)


def test_p2p_runs_probabilistic():
    r = teng.P2PEngine("pbsp").run(n_nodes=32, duration=4.0, dim=8)
    assert r.mean_progress > 0
    assert r.control_messages > 0    # overlay sampling cost
    _assert_same(jeng.P2PEngine("pbsp").run(n_nodes=32, duration=4.0,
                                            dim=8), r, "p2p")


def test_mapreduce_is_bsp():
    eng = teng.MapReduceEngine()
    assert eng.barrier.name == "bsp"
    r = eng.run(n_nodes=16, duration=4.0, dim=8)
    assert int(r.steps.max() - r.steps.min()) <= 1


def test_combination_table():
    assert "p2p" in teng.valid_combinations("pssp")
    assert "p2p" not in teng.valid_combinations("bsp")
    for b in ("bsp", "ssp", "asp", "pbsp", "PSSP"):
        assert teng.valid_combinations(b) == jeng.valid_combinations(b)
    assert teng.MapReduceEngine().schedule(0, 5).tolist() == list(range(5))
    with pytest.raises(NotImplementedError):
        teng.ParameterServerEngine("asp").pull()


SWEEP = [dict(straggler_frac=f, seed=s) for f in (0.0, 0.2) for s in (1, 2)]


def test_engine_run_sweep_numpy_equals_reference():
    common = dict(n_nodes=16, duration=2.0, dim=8)
    a = jeng.P2PEngine("pssp").run_sweep(SWEEP, backend="numpy", **common)
    b = teng.P2PEngine("pssp").run_sweep(SWEEP, backend="numpy", **common)
    for x, y in zip(a, b):
        _assert_same(x, y, "numpy sweep")
    assert all(r.control_messages > 0 for r in b)


def test_engine_run_sweep_on_the_plain_tick():
    """``device="cpu"``: the plain tick, in sweep order, at the
    distribution of the event engine (mean progress within 0.2·p + 1)."""
    eng = teng.ParameterServerEngine("pbsp")
    common = dict(n_nodes=16, duration=2.0, dim=8)
    res = eng.run_sweep(SWEEP, device="cpu", **common)
    for kw, r in zip(SWEEP, res):
        ev = eng.run(**common, **kw)
        assert r.steps.shape == (16,) and np.isfinite(r.errors).all()
        assert abs(r.mean_progress - ev.mean_progress) \
            <= 0.2 * ev.mean_progress + 1.0
    with pytest.raises(ValueError, match="no device"):
        eng.run_sweep(SWEEP, backend="numpy", device="cpu", **common)
