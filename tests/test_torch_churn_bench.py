"""The port's churn benchmark and Fig 6 (``repro_torch.bench.churn_bench``,
``repro_torch.bench.figures.fig6_adaptive_churn``) against the
reference's (``benchmarks.churn_bench``, ``benchmarks.figures``).

* ``_err_at``, ``_adaptive_vs_static`` and Fig 6's reshape give exactly
  the reference's output on the same input dict;
* ``_sweep`` at a tiny scale (TICKS ticks, W workers, both scenarios,
  all nine policies) equals the reference's ``_sweep``: the reference
  runs eagerly under ``jax.disable_jit()``, the draws it makes from its
  state key before each tick and its minibatches are replayed into the
  port through ``ReplayNoise`` (as ``test_torch_spmd_psp.py`` does),
  run by run.  The control-plane fields (``virtual_time``, ``alive``,
  ``total_pushes``, ``leaves``, ``joins``, …) must be exact, the errors
  within rtol 1e-5 (the port sums the gradient in another order);
* the harness lists both new entries, and ``--smoke`` on the CPU prints
  the reference's tables.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from benchmarks import churn_bench as jcb  # noqa: E402
from benchmarks import figures as jfig  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro_torch.bench import churn_bench as tcb  # noqa: E402
from repro_torch.bench import figures as tfig  # noqa: E402
from repro_torch.bench import run as trun  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402

TICKS, W = 12, 6
ERR_TOL = dict(rtol=1e-5)
EXACT = ("virtual_time", "alive", "final_virtual_time", "mean_alive",
         "total_pushes", "leaves", "joins")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _init_record(w):
    """The reference's init draws (psp_init under PRNGKey(1)) as a port
    record: the permutation as scores whose stable argsort is it."""
    k_slow, k_dur, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    perm = np.asarray(jax.random.permutation(k_slow, jnp.arange(w)))
    scores = np.empty(w, np.float32)
    scores[perm] = np.arange(w)
    return {"perm": torch.from_numpy(scores), "dur": _u(k_dur, (w,))}


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


def _runs(seed):
    """Nine policies' fake runs: monotone virtual times, errors, alive."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in jcb.NINE:
        n = int(rng.integers(3, 8))
        vt = np.cumsum(rng.uniform(0.1, 1.0, n)).tolist()
        err = rng.uniform(0.0, 1.0, n).tolist()
        out[name] = {"virtual_time": vt, "error": err,
                     "alive": rng.integers(1, 9, n).tolist(),
                     "final_error": err[-1], "final_virtual_time": vt[-1],
                     "mean_alive": float(rng.uniform(1, 8)),
                     "total_pushes": int(rng.integers(0, 100)),
                     "leaves": int(rng.integers(0, 5)),
                     "joins": int(rng.integers(0, 5))}
    return out


def test_constants_match_reference():
    assert (tcb.FIVE, tcb.ADAPTIVE, tcb.PARENT, tcb.NINE, tcb.D) == (
        jcb.FIVE, jcb.ADAPTIVE, jcb.PARENT, jcb.NINE, jcb.D)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_err_at_and_scoreboard_equal_reference(seed):
    runs = _runs(seed)
    for r in runs.values():
        for t in (-1.0, 0.0, r["virtual_time"][1], 0.5 * sum(
                r["virtual_time"][:2]), r["final_virtual_time"], 1e3):
            assert tcb._err_at(r, t) == jcb._err_at(r, t)
    assert tcb._adaptive_vs_static(runs) == jcb._adaptive_vs_static(runs)


def test_fig6_reshape_equals_reference(monkeypatch):
    res = _runs(3)
    res["stragglers"] = _runs(4)
    res["adaptive_vs_static"] = {
        "churn": jcb._adaptive_vs_static({k: res[k] for k in jcb.NINE}),
        "stragglers": jcb._adaptive_vs_static(res["stragglers"])}
    monkeypatch.setattr(jcb, "elastic_churn", lambda **kw: res)
    monkeypatch.setattr(tcb, "elastic_churn", lambda **kw: res)
    want = jfig.fig6_adaptive_churn()
    got = tfig.fig6_adaptive_churn()
    assert got == want
    assert len(got) == 1 + 2 * 2 * len(tcb.PARENT)


@pytest.fixture(scope="module")
def both_sweeps():
    """The reference's ``_sweep(TICKS, W)`` and the port's on its draws."""
    recorded = []
    real_j = jcb.elastic_drive

    def recording_drive(cfg, dim, ticks, **kw):
        w_true, it = real_j(cfg, dim, ticks, **kw)
        tcfg = sp.PSPConfig(**{f: getattr(cfg, f) for f in (
            "barrier", "n_workers", "sample_size", "staleness",
            "straggler_frac", "max_advance")}, churn=cfg.churn and
            sp.ChurnConfig(**cfg.churn.__dict__))
        key = jsp.linear_psp_state(cfg, dim, 1).key
        kb, recs, xs = jax.random.PRNGKey(2), [], []
        run = {"init": _init_record(cfg.n_workers), "recs": recs,
               "xs": xs, "w_true": _t(w_true)}
        recorded.append(run)

        def ticks_():
            nonlocal key, kb
            for st, m in it:
                recs.append(_tick_record(tcfg, key))
                kb_, k1 = jax.random.split(kb)
                kb = kb_
                xs.append(_t(jax.random.normal(k1, (cfg.n_workers, 16,
                                                    dim))))
                key = st.key
                yield st, m
        return w_true, ticks_()

    jcb.elastic_drive = recording_drive
    try:
        with jax.disable_jit():
            want = jcb._sweep(TICKS, W)
    finally:
        jcb.elastic_drive = real_j

    replay = iter(recorded)
    real_t = tcb.elastic_drive

    def replay_drive(cfg, dim, ticks, **kw):
        run = next(replay)
        return real_t(cfg, dim, ticks, noise=sp.ReplayNoise(
            run["init"], run["recs"]), xs=run["xs"], w_true=run["w_true"],
            **kw)

    tcb.elastic_drive = replay_drive
    try:
        got = tcb._sweep(TICKS, W, device="cpu")
    finally:
        tcb.elastic_drive = real_t
    assert next(replay, None) is None and len(recorded) == 18
    return want, got


def _check_run(got, want, what):
    assert set(got) == set(want), what
    for k in EXACT:
        assert got[k] == want[k], f"{what}: {k}"
    np.testing.assert_allclose(got["error"], want["error"], **ERR_TOL,
                               err_msg=what)
    np.testing.assert_allclose(got["final_error"], want["final_error"],
                               **ERR_TOL, err_msg=what)


@pytest.mark.parametrize("scenario", ["churn", "stragglers"])
def test_sweep_equals_reference(both_sweeps, scenario):
    want, got = both_sweeps
    assert set(got) == set(want)
    pick = (lambda r: {k: r[k] for k in jcb.NINE}) if scenario == "churn" \
        else (lambda r: r["stragglers"])
    for name in jcb.NINE:
        _check_run(pick(got)[name], pick(want)[name], f"{scenario}/{name}")
        assert len(pick(got)[name]["error"]) == 3     # ticks 0, 10, 11
    for name, s in want["adaptive_vs_static"][scenario].items():
        g = got["adaptive_vs_static"][scenario][name]
        assert set(g) == set(s)
        assert (g["parent"], g["virtual_time"], g["dominates"]) == (
            s["parent"], s["virtual_time"], s["dominates"])
        for k in ("error", "parent_error", "error_ratio"):
            np.testing.assert_allclose(g[k], s[k], **ERR_TOL)


def test_harness_lists_churn_entries():
    names = [n for n, _, _ in trun.BENCHES]
    assert names[-2:] == ["elastic_churn", "fig6_adaptive_churn"]


def test_smoke_prints_reference_tables(monkeypatch):
    """``--smoke`` on the CPU prints the reference's table layout for the
    same smoke grid."""
    monkeypatch.setattr(tcb, "_sweep", lambda ticks, workers, device=None:
                        _fake_sweep())
    monkeypatch.setattr(jcb, "_sweep", lambda ticks, workers: _fake_sweep())
    outs = []
    for main, argv in ((jcb.main, ["--smoke"]),
                       (tcb.main, ["--smoke", "--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and "adaptive vs static" in outs[1]


def _fake_sweep():
    res = _runs(5)
    res["stragglers"] = _runs(6)
    res["adaptive_vs_static"] = {
        "churn": jcb._adaptive_vs_static({k: res[k] for k in jcb.NINE}),
        "stragglers": jcb._adaptive_vs_static(res["stragglers"])}
    return res


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcb._run_one("bsp", 2, 3, None)
