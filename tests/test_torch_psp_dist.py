"""The PSP trainer's worker reduction over a mesh of ranks
(``repro_torch.core.spmd_psp`` with ``mesh=``) on gloo worlds of two and
four ranks on the CPU.

The W = 4 workers split over a ``(data n, model 1)`` mesh's worker axis
(``psp_workers``), each rank holding its W/n workers' views; five ticks
on replayed noise records (:class:`~repro_torch.core.spmd_psp.ReplayNoise`,
drawn once by a seeded generator), with and without churn, of

* the linear task (plain SGD), and
* the reduced qwen2-0.5b at two layers, d_model 64 (AdamW on a warm-up
  cosine, clipped gradients, 2 × 16 tokens a worker).

Every rank's state equals the one-process run's bit for bit: the server
parameters, the optimizer's moments, the control plane (steps, clocks,
membership, cursors, policy) and the metrics; its views are its slice of
the one-process views.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dist  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.launch.mesh import spawn_host_world  # noqa: E402

W, TICKS, RANKS = 4, 5, (2, 4)
QWEN2 = reduced(get_config("qwen2-0.5b"), d_model=64)
CHURN = sp.ChurnConfig(leave_rate=6.0, join_rate=6.0, horizon=5.0, seed=3)
BASE = dict(n_workers=W, sample_size=2, staleness=1, straggler_frac=0.25)
RUNS = {
    "linear": ("linear", dict(BASE, barrier="pssp")),
    "linear_churn": ("linear", dict(BASE, barrier="pbsp", churn=CHURN)),
    "qwen2": (QWEN2, dict(BASE, barrier="pssp")),
    "qwen2_churn": (QWEN2, dict(BASE, barrier="ssp", churn=CHURN)),
}


def _np(rec):
    return {k: v.numpy() for k, v in rec.items()}


def _jobs():
    """Each run's (task, config, noise records, per-tick batches,
    ticks)."""
    jobs = {}
    for i, (name, (task, kw)) in enumerate(RUNS.items()):
        cfg = sp.PSPConfig(**kw)
        gen = sp.GeneratorNoise(10 + i)
        records = (_np(gen.init_record(cfg)),
                   [_np(gen.tick_record(cfg)) for _ in range(TICKS)])
        rng = np.random.default_rng(20 + i)
        if task == "linear":
            xs = rng.normal(size=(TICKS, W, 16, 8)).astype(np.float32)
            w_true = rng.normal(size=8).astype(np.float32)
            batches = [(x, x @ w_true) for x in xs]
        else:
            batches = rng.integers(0, task.vocab_size, (TICKS, W, 2, 16)
                                   ).astype(np.int32)
        jobs[name] = (task, kw, records, batches, TICKS)
    return jobs


@pytest.fixture(scope="module")
def runs():
    """The one-process runs and each world's."""
    jobs = _jobs()
    one = {name: _torch_dist.run_psp(*job) for name, job in jobs.items()}
    worlds = {n: spawn_host_world(n, _torch_dist.psp_world, jobs,
                                  wall=240.0) for n in RANKS}
    return one, worlds


def _equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


def _views(views, mine):
    if isinstance(views, dict):
        return {k: _views(v, mine) for k, v in views.items()}
    if isinstance(views, list):
        return [_views(v, mine) for v in views]
    return views[mine]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", sorted(RUNS))
def test_world_equals_one_process(runs, name, n):
    """Every rank's state and metrics equal the one-process run's bit
    for bit; each rank holds its W/n workers' views."""
    one, worlds = runs
    st1, m1 = one[name]
    for r, rank in enumerate(worlds[n]):
        st, m, mine, calls = rank[name]
        assert mine == slice(r * W // n, (r + 1) * W // n)
        _equal({k: v for k, v in st.items() if k != "views"},
               {k: v for k, v in st1.items() if k != "views"},
               f"{name} n={n} rank {r}")
        _equal(st["views"], _views(st1["views"], mine),
               f"{name} n={n} rank {r} views")
        _equal(m, m1, f"{name} n={n} rank {r} metrics")
        # the losses and every gradient leaf are gathered each tick
        assert calls.get("all_gather", 0) >= 2 * TICKS, calls


def test_runs_push_and_churn(runs):
    """The runs are not vacuous: workers push, and the churn runs'
    membership changes."""
    one, _ = runs
    for name, (st, _) in one.items():
        assert int(st["total_pushes"]) > 0, name
        if name.endswith("churn"):
            assert int(st["leave_cursor"]) + int(st["join_cursor"]) > 0
