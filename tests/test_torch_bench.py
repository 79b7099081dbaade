"""The port's figure, bound and sweep benchmarks against the reference's.

At a monkeypatched tiny scale (the figures' ``_scale``, and the sizes
Fig 3 and Fig 4's empirical lags fix, shrunk through the modules'
``SimConfig``):

* on the numpy backend every figure equals ``benchmarks.figures`` on the
  reference's numpy backend exactly (the engines are bit for bit alike);
* on the torch backend (the plain tick, ``device="cpu"``) every figure
  has the reference's keys and series lengths;
* ``fig5_variance_bound`` and ``fig4_mean_bound``'s ``"bound"`` series
  equal the reference's exactly;
* the torch backend's Fig 1 bands come from one ``run_sweep`` call per
  seed, so no two seeds share a batch's noise;
* ``sweep_bench`` on the CPU writes the reference's schema (jax → torch)
  to the path it is given and never touches ``BENCH_sweep.json``;
* the CSV harness and the quickstart print what the reference's print.
"""
import dataclasses
import hashlib
import io
import json
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from benchmarks import fig45_bounds as jfig45  # noqa: E402
from benchmarks import figures as jfig  # noqa: E402
from repro.configs.psp_linear import PSPLinearConfig as JLinear  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch.bench import fig45_bounds as tfig45  # noqa: E402
from repro_torch.bench import figures as tfig  # noqa: E402
from repro_torch.bench import run as trun  # noqa: E402
from repro_torch.bench import sweep_bench as tbench  # noqa: E402
from repro_torch.configs.psp_linear import PSPLinearConfig as TLinear  # noqa: E402,E501
from repro_torch.core import simulator as tsim  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIGS = ("fig1_progress", "fig1_sample_sweep", "fig1_error",
        "fig1_messages", "fig1_error_bands", "fig2_stragglers",
        "fig2_slowness", "fig3_scalability")


def _shrink(SimConfig):
    """A ``SimConfig`` that cuts what the figures fix themselves (Fig 3's
    sizes and horizon, Fig 4's empirical run) to a tiny scale."""
    def make(**kw):
        kw["n_nodes"] = max(8, kw.get("n_nodes", 100) // 10)
        kw["duration"] = min(kw.get("duration", 40.0), 2.0)
        kw["dim"] = min(kw.get("dim", 100), 8)
        return SimConfig(**kw)
    return make


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' figure modules at the same tiny scale."""
    for mod, lin, sim in ((jfig, JLinear, jsim), (tfig, TLinear, tsim)):
        monkeypatch.setattr(mod, "_scale", lambda full, lin=lin: lin(
            n_nodes=24, dim=8, duration=2.0))
        monkeypatch.setattr(mod, "SimConfig", _shrink(sim.SimConfig))
        mod._fig1_sweep.cache_clear()
    for mod, sim in ((jfig45, jsim), (tfig45, tsim)):
        monkeypatch.setattr(mod, "SimConfig", _shrink(sim.SimConfig))
    yield
    jfig._fig1_sweep.cache_clear()
    tfig._fig1_sweep.cache_clear()


def _shape(x):
    """Keys and series lengths of a figure's output, values dropped."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return ("list", len(x), _shape(x[0]) if x and isinstance(
            x[0], (dict, list)) else None)
    return type(x).__name__


@pytest.mark.parametrize("fig", FIGS)
def test_numpy_figures_equal_reference(tiny, fig):
    ref = getattr(jfig, fig)(backend="numpy")
    port = getattr(tfig, fig)(backend="numpy")
    assert port == ref


@pytest.mark.parametrize("fig", FIGS)
def test_torch_figures_have_reference_shape(tiny, fig):
    ref = getattr(jfig, fig)(backend="numpy")
    port = getattr(tfig, fig)(device="cpu")
    assert _shape(port) == _shape(ref)


def test_bounds_figures_equal_reference(tiny):
    assert tfig45.fig5_variance_bound() == jfig45.fig5_variance_bound()
    assert tfig45.derived_summary() == jfig45.derived_summary()
    assert tfig45.fig4_mean_bound(backend="numpy") == \
        jfig45.fig4_mean_bound(backend="numpy")
    ref = jfig45.fig4_mean_bound(backend="numpy")
    port = tfig45.fig4_mean_bound(device="cpu")
    for key, row in ref.items():
        assert port[key]["bound"] == row["bound"]
        assert port[key]["a"] == row["a"]
        assert np.isfinite(port[key]["empirical_mean_lag"])


def test_torch_bands_run_one_batch_per_seed(tiny, monkeypatch):
    calls = []
    real = tfig.run_sweep

    def spy(cfgs, **kw):
        calls.append(([c.seed for c in cfgs], kw))
        return real(cfgs, **kw)

    monkeypatch.setattr(tfig, "run_sweep", spy)
    seeds = (0, 1, 2)
    bands = tfig.fig1_error_bands(seeds=seeds, device="cpu")
    assert [sorted(set(s)) for s, _ in calls] == [[s] for s in seeds]
    assert all(len(s) == len(tfig.FIVE) for s, _ in calls)
    # each band is the seeds' mean and std of those runs
    runs = [real([tfig._cfg(n, tfig._scale(False), seed=s)
                  for n in tfig.FIVE], device="cpu") for s in seeds]
    for i, name in enumerate(tfig.FIVE):
        errs = np.stack([runs[j][i].errors for j in range(len(seeds))])
        assert bands[name]["mean"] == errs.mean(axis=0).tolist()
        assert bands[name]["std"] == errs.std(axis=0).tolist()
    calls.clear()
    tfig.fig1_error_bands(seeds=seeds, backend="numpy")
    assert len(calls) == 1 and len(calls[0][0]) == len(seeds) * 5


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_sweep_bench_schema_on_cpu(tmp_path, monkeypatch):
    from repro_torch.core.barriers import make_barrier
    monkeypatch.setattr(tbench, "_configs", lambda full: [
        tsim.SimConfig(n_nodes=12, duration=1.0, dim=4, seed=3,
                       straggler_frac=f,
                       barrier=make_barrier(n, staleness=4, sample_size=1))
        for n in tbench.NINE for f in (0.0, 0.3)])
    monkeypatch.setattr(tbench, "_100k_configs", lambda: [
        tsim.SimConfig(n_nodes=500, duration=0.2, dim=4, batch=2, seed=3,
                       straggler_frac=0.1,
                       barrier=make_barrier(n, staleness=4, sample_size=1))
        for n in ("pbsp", "ssp")])
    committed = ROOT / "BENCH_sweep.json"
    before = _digest(committed)
    out = tmp_path / "bench.json"
    res = tbench.sweep_speedup(device="cpu", out_path=str(out), repeats=1)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert _digest(committed) == before
    ref = json.loads(committed.read_text())
    assert set(res) >= {"sweep", "n_configs", "n_nodes", "duration_s",
                        "engines", "summary"}
    assert set(res["summary"]) == set(ref["summary"])
    assert set(res["engines"]) == {"event", "numpy", "torch", "torch_100k"}
    grid = {"seconds", "compile_seconds", "speedup_vs_event",
            "amortized_speedup_vs_event", "max_progress_deviation"}
    assert set(res["engines"]["numpy"]) == set(ref["engines"]["numpy"])
    # the reference's mesh fields, on one device without --mesh
    mesh = {"n_devices", "mesh", "mesh_axes"}
    assert set(res["engines"]["torch"]) == set(ref["engines"]["jax"]) | \
        {"tick_impl"} == grid | mesh | {"tick_impl", "throughput_vs_numpy"}
    assert set(res["engines"]["torch_100k"]) == \
        set(ref["engines"]["jax_100k"]) | {"tick_impl"}
    for name in ("torch", "torch_100k"):
        assert {k: res["engines"][name][k] for k in mesh} == \
            {"n_devices": 1, "mesh": [1, 1],
             "mesh_axes": {"rows": 1, "nodes": 1}}
    assert res["engines"]["torch"]["tick_impl"] == "ref"
    assert res["engines"]["torch_100k"]["tick_impl"] == "ref"
    assert res["n_configs"] == 18 and res["device"] == "cpu"
    for name in ("numpy", "torch"):
        assert 0 <= res["engines"][name]["max_progress_deviation"] < 0.5
    assert "event=" in tbench.summary_line(res)
    assert str(pathlib.Path(tbench.OUT_PATH).relative_to(ROOT)) == \
        "results/BENCH_sweep_torch.json"


def test_run_harness_prints_csv(tmp_path, tiny, capsys):
    trun.main(["--only", "fig1_progress", "--backend", "numpy",
               "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    name, us, derived = lines[1].split(",", 2)
    assert name == "fig1_progress" and float(us) > 0
    ref = jfig.fig1_progress(backend="numpy")
    assert derived == trun._derived_fig1(ref)
    assert json.loads((tmp_path / "fig1_progress.json").read_text()) == ref
    with pytest.raises(SystemExit, match="unknown benchmark"):
        trun.main(["--only", "nope", "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="torch backend only"):
        trun.main(["--backend", "numpy", "--device", "cpu",
                   "--out-dir", str(tmp_path)])
    # the reference harness's entries, less the roofline rows
    assert [n for n, _, _ in trun.BENCHES] == [
        "fig1_progress", "fig1_sample_sweep", "fig1_error",
        "fig1_error_bands", "fig1_messages", "fig2_stragglers",
        "fig2_slowness", "fig3_scalability", "fig4_mean_bound",
        "fig5_variance_bound", "sweep_engine", "elastic_churn",
        "fig6_adaptive_churn"]


def test_quickstart_prints_what_the_reference_prints(monkeypatch):
    import examples.quickstart as jq
    from repro_torch.examples import quickstart as tq
    for mod, sim in ((jq, jsim), (tq, tsim)):
        monkeypatch.setattr(mod, "SimConfig", lambda sim=sim, **kw:
                            dataclasses.replace(sim.SimConfig(**kw),
                                                n_nodes=30, duration=3.0,
                                                dim=8))
    outs = []
    for mod in (jq, tq):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert "pssp" in outs[1] and "Theorem-2" in outs[1]
