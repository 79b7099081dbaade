"""The port's sweep engine against the reference's.

* Static state (per-seed draws, initial clocks, churn schedules, policy
  tags) and the stride/chunk plan equal the reference's exactly.
* A small Fig-2-style sweep on the CPU agrees with the reference's jax
  backend at the distribution level (the two draw their dynamics noise
  from different generators): mean progress within 0.2·p + 1.0, the
  bound the reference holds its own two backends to, and final error
  within a factor of two.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import barriers as jbar  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import sweep_plan as jplan  # noqa: E402
from repro.core import vector_sim as jvs  # noqa: E402
from repro_torch.core import barriers as tbar  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep_plan as tplan  # noqa: E402
from repro_torch.core import vector_sim as tvs  # noqa: E402
from repro_torch.core import vector_sim_torch  # noqa: E402

FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")


def _configs(sim, bar, specs):
    """Build the same config list in either package."""
    return [sim.SimConfig(barrier=bar.make_barrier(
        name, staleness=4, sample_size=2, staleness_lo=1,
        sample_size_lo=1, max_advance=3), **kw) for name, kw in specs]


MIXED = [("pssp", dict(n_nodes=12, dim=6, duration=3.0, seed=1,
                       churn_leave_rate=1.0, churn_join_rate=1.0)),
         ("bsp", dict(n_nodes=9, dim=6, duration=2.0, seed=2,
                      straggler_frac=0.2)),
         ("dssp", dict(n_nodes=16, dim=6, duration=3.0, seed=3)),
         ("ebsp", dict(n_nodes=16, dim=6, duration=3.0, seed=4)),
         ("apssp", dict(n_nodes=16, dim=6, duration=3.0, seed=5,
                        distributed_sampling=True)),
         ("asp", dict(n_nodes=16, dim=6, duration=3.0, seed=6))]

STATIC = ("n_true", "valid_slot", "w_true", "compute_time", "lr",
          "noise_std", "staleness", "beta", "is_asp", "distributed",
          "is_dssp", "is_ebsp", "is_anneal", "pol_lo", "beta_lo",
          "ebsp_range", "ebsp_alpha", "full_view", "sampled", "beta_cap",
          "pol_thr", "pol_ema", "pol_beta", "w_true_norm", "event_time",
          "ready", "alive", "computing", "blocked", "hops_per_peer",
          "ticks", "m_times", "leave_counts", "join_counts", "row_duration")


def test_static_state_equals_reference():
    ref = jvs.VectorSimulator(_configs(jsim, jbar, MIXED), backend="jax")
    port = tvs.VectorSimulator(_configs(tsim, tbar, MIXED))
    assert (port.B, port.P, port.d, port.batch, port.dt, port.adaptive,
            port.has_churn) == (ref.B, ref.P, ref.d, ref.batch, ref.dt,
                                ref.adaptive, ref.has_churn)
    for k in STATIC:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)


def test_grouping_keys_equal_reference():
    for (ja, ta) in zip(_configs(jsim, jbar, MIXED),
                        _configs(tsim, tbar, MIXED)):
        assert tvs._merge_key(ta) == jvs._merge_key(ja)
        assert tvs._group_key(ta) == jvs._group_key(ja)


@pytest.mark.parametrize("env", [{}, {"PSP_TRACE_STRIDE": "3"},
                                 {"PSP_SWEEP_CHUNK": "3"}])
@pytest.mark.parametrize("shape", [
    dict(n_ticks=200, B=25, P=1000, batch=8, d=1000, k_max=10,
         masked=False, has_churn=False),
    dict(n_ticks=150, B=3, P=12, batch=8, d=6, k_max=2, masked=True,
         has_churn=True),
    dict(n_ticks=101, B=40, P=64, batch=4, d=16, k_max=1, masked=False,
         has_churn=False),
])
def test_plan_equals_reference(monkeypatch, env, shape):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    shape = dict(shape)
    n_ticks = shape.pop("n_ticks")
    midx = np.arange(24, n_ticks, 25)
    a = jplan.plan_sweep(n_ticks, midx, **shape, n_devices=1)
    b = tplan.plan_sweep(n_ticks, midx, **shape)
    for k in ("stride", "n_rec", "n_rec_live", "chunks", "b_pad",
              "node_pad", "mesh", "p_loc", "n_ticks"):
        assert getattr(b, k) == getattr(a, k), k


def test_run_sweep_agrees_with_reference_distribution():
    specs = [(name, dict(n_nodes=40, dim=16, duration=4.0, seed=3,
                         straggler_frac=frac))
             for name in FIVE for frac in (0.0, 0.2)]
    port = tvs.run_sweep(_configs(tsim, tbar, specs), device="cpu")
    ref = jvs.run_sweep(_configs(jsim, jbar, specs), backend="jax")
    for (name, kw), a, b in zip(specs, port, ref):
        assert abs(a.mean_progress - b.mean_progress) \
            <= 0.2 * b.mean_progress + 1.0, (name, kw)
        assert np.isfinite(a.errors).all()
        assert 0.5 * b.final_error <= a.final_error <= 2.0 * b.final_error
        np.testing.assert_array_equal(a.times, b.times)
        assert a.steps.shape == b.steps.shape
        assert a.control_messages == b.control_messages == 0


def test_ragged_merged_sweep_matches_reference_layout():
    """Ragged P, churn and two durations merge into one batch: results
    come back in input order, each cut at its own horizon."""
    port = tvs.run_sweep(_configs(tsim, tbar, MIXED), device="cpu")
    ref = jvs.run_sweep(_configs(jsim, jbar, MIXED), backend="jax")
    for (name, kw), a, b in zip(MIXED, port, ref):
        np.testing.assert_array_equal(a.times, b.times)
        assert a.steps.shape == (kw["n_nodes"],)
        assert a.errors[0] == 1.0 and a.server_updates[0] == 0
        assert a.server_updates[-1] == a.total_updates
        assert abs(a.mean_progress - b.mean_progress) \
            <= 0.2 * b.mean_progress + 1.0, name
        if kw.get("distributed_sampling"):
            assert a.control_messages > 0


def test_run_sweep_is_deterministic():
    cfgs = _configs(tsim, tbar, MIXED[:2])
    a = tvs.run_sweep(cfgs, device="cpu")
    b = tvs.run_sweep(cfgs, device="cpu")
    for x, y in zip(a, b):
        assert x.errors.tobytes() == y.errors.tobytes()
        assert x.steps.tobytes() == y.steps.tobytes()


def test_injected_noise_drives_the_sweep():
    """``run_batch(noise=...)`` consumes the given draws: the same noise
    twice gives the same sweep, and the default generator is one such
    source."""
    cfgs = _configs(tsim, tbar, [("pssp", dict(n_nodes=10, dim=4,
                                               duration=1.0, seed=0))])

    def run(noise):
        sim = tvs.VectorSimulator(cfgs)
        return vector_sim_torch.run_batch(sim, device="cpu", noise=noise)[0]

    sim = tvs.VectorSimulator(cfgs)
    plan, _, _, _, _, _, seed = vector_sim_torch._prepare(sim, "cpu")
    make = lambda: vector_sim_torch.GeneratorNoise(
        seed, torch.device("cpu"), stride=plan.stride, Bp=plan.b_pad,
        P=sim.P, m=sim.batch, d=sim.d, k_max=2, masked=False,
        has_churn=False)
    a, b, c = run(make()), run(make()), run(None)
    for x in (b, c):
        assert x.steps.tolist() == a.steps.tolist()
        assert x.errors.tobytes() == a.errors.tobytes()
    assert vector_sim_torch.ticks_to_run(sim) == plan.n_rec_live * plan.stride


def test_env_overrides_are_typed(monkeypatch):
    """``PSP_TICK_IMPL`` with an unknown value raises instead of running
    the plain version; unregistered names and non-integers raise too."""
    from repro_torch.core import env
    cfg = tsim.SimConfig(n_nodes=4, dim=2, duration=0.1)
    monkeypatch.setenv("PSP_TICK_IMPL", "pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        tvs.run_sweep([cfg], device="cpu")
    monkeypatch.setenv("PSP_SWEEP_CHUNK", "two")
    with pytest.raises(ValueError, match="PSP_SWEEP_CHUNK"):
        env.get_int("PSP_SWEEP_CHUNK")
    with pytest.raises(KeyError, match="not a registered"):
        env.get_str("PSP_COMPILE_CACHE")
    monkeypatch.setenv("PSP_TICK_IMPL", "")
    assert env.get_str("PSP_TICK_IMPL") == "auto"


def test_run_sweep_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsim.SimConfig(n_nodes=4, dim=2, duration=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvs.run_sweep([cfg])


def test_port_imports_neither_jax_nor_reference():
    """The port and its chip smoke script import torch, numpy and the
    standard library only."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    for f in files:
        assert not bad.search(f.read_text()), f


def test_port_apis_are_documented():
    """The doc-coverage gate passes on the port's package."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "tools/check_docstrings.py",
                           "src/repro_torch"], cwd=root,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- the numpy backend: bit for bit the reference's ---------------------- #
STRICT = {
    "static": [(n, dict(n_nodes=12, dim=6, duration=3.0, seed=s,
                        straggler_frac=0.25))
               for n in FIVE for s in (1, 2)],
    "adaptive": [(n, dict(n_nodes=16, dim=6, duration=3.0, seed=3))
                 for n in ("dssp", "ebsp", "apbsp", "apssp", "pssp")],
    "churn": [(n, dict(n_nodes=12, dim=6, duration=3.0, seed=s,
                       churn_leave_rate=1.5, churn_join_rate=1.0))
              for n, s in (("pssp", 1), ("bsp", 2), ("ebsp", 3),
                           ("asp", 4), ("apssp", 5))],
    "distributed": [(n, dict(n_nodes=16, dim=6, duration=3.0, seed=s,
                             distributed_sampling=True))
                    for n, s in (("pbsp", 1), ("pssp", 2), ("apbsp", 3))],
    "dense-sample": [("pssp", dict(n_nodes=6, dim=4, duration=2.0, seed=s))
                     for s in range(3)],
    "mixed-groups": MIXED,
}


@pytest.mark.parametrize("group", sorted(STRICT))
def test_numpy_backend_equals_reference(group):
    """``run_sweep(backend="numpy")`` gives the reference's numpy results
    field by field, dtypes included; ``MIXED`` splits into strict groups
    on both sides."""
    specs = STRICT[group]
    ref = jvs.run_sweep(_configs(jsim, jbar, specs), backend="numpy")
    port = tvs.run_sweep(_configs(tsim, tbar, specs), backend="numpy")
    for (name, _), a, b in zip(specs, ref, port):
        for f in ("steps", "times", "errors", "server_updates",
                  "control_messages", "total_updates", "mean_progress",
                  "final_error"):
            x, y = getattr(a, f), getattr(b, f)
            assert type(x) is type(y) and np.asarray(x).dtype == \
                np.asarray(y).dtype, (group, name, f)
            np.testing.assert_array_equal(y, x, err_msg=f"{group} {name} {f}")


def test_numpy_batch_state_equals_reference():
    """One strict churn batch run by ``VectorSimulator.run``: the final
    dynamic state (views, clocks, policy state) equals the reference's."""
    specs = STRICT["churn"]
    ref = jvs.VectorSimulator(_configs(jsim, jbar, specs), backend="numpy")
    port = tvs.VectorSimulator(_configs(tsim, tbar, specs),
                               backend="numpy")
    ref.run(), port.run()
    for k in ("w", "pulled", "steps", "alive", "computing", "event_time",
              "ready", "blocked", "total_updates", "control_messages",
              "pol_thr", "pol_ema", "pol_beta"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)
    assert port.rng.random() == ref.rng.random()   # the stream's position


def test_numpy_backend_rejects_ragged_batches_and_devices():
    """A heterogeneous numpy batch raises, as the reference's does; the
    numpy backend takes no device; an unknown backend raises."""
    with pytest.raises(ValueError, match="heterogeneous"):
        jvs.VectorSimulator(_configs(jsim, jbar, MIXED), backend="numpy")
    with pytest.raises(ValueError, match="heterogeneous"):
        tvs.VectorSimulator(_configs(tsim, tbar, MIXED), backend="numpy")
    cfgs = _configs(tsim, tbar, STRICT["static"][:1])
    with pytest.raises(ValueError, match="takes no device"):
        tvs.run_sweep(cfgs, backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="takes no device"):
        tvs.VectorSimulator(cfgs, backend="numpy").run(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tvs.run_sweep(cfgs, backend="jax")
    with pytest.raises(ValueError, match="unknown backend"):
        tvs.VectorSimulator(cfgs, backend="jax")
    assert tvs.BACKENDS == ("torch", "numpy")


def test_torch_backend_run_method_matches_run_sweep():
    """``VectorSimulator(...).run(device="cpu")`` is the torch path that
    ``run_sweep`` takes for one merged group."""
    cfgs = _configs(tsim, tbar, MIXED[:2])
    a = tvs.VectorSimulator(cfgs).run(device="cpu")
    b = tvs.run_sweep(cfgs, device="cpu")
    for x, y in zip(a, b):
        assert x.steps.tolist() == y.steps.tolist()
        assert x.errors.tobytes() == y.errors.tobytes()


def test_env_flag_and_table_follow_reference(monkeypatch):
    """``flag`` (set-and-nonempty is true) and ``markdown_table`` read
    like the reference's accessors, over either package's registry."""
    from repro.core import env as jenv
    from repro_torch.core import env as tenv
    shared = {k: v for k, v in jenv.REGISTRY.items()}
    monkeypatch.setattr(tenv, "REGISTRY", {
        k: tenv.EnvVar(v.name, v.kind, v.default, v.help)
        for k, v in shared.items()})
    assert tenv.markdown_table() == jenv.markdown_table()
    for value, want in (("1", True), ("0", True), ("", False)):
        monkeypatch.setenv("PSP_REGEN_GOLDEN", value)
        assert tenv.flag("PSP_REGEN_GOLDEN") is want \
            is jenv.flag("PSP_REGEN_GOLDEN")
    monkeypatch.delenv("PSP_REGEN_GOLDEN")
    assert tenv.flag("PSP_REGEN_GOLDEN") is False
    with pytest.raises(KeyError, match="not a registered"):
        tenv.flag("PSP_NOPE")
    monkeypatch.undo()
    rows = tenv.markdown_table().splitlines()
    assert rows[:2] == ["| variable | type | default | meaning |",
                        "|---|---|---|---|"]
    assert len(rows) == 2 + len(tenv.REGISTRY)
    assert all(f"`{name}`" in row
               for name, row in zip(tenv.REGISTRY, rows[2:]))
    assert "\\|" in rows[2]         # PSP_TICK_IMPL's pipes are escaped
