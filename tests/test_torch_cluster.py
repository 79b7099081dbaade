"""The port's chaos tier: fault plans (mirroring
``tests/test_cluster_faults.py::TestFaultPlan``, and equal to the
reference's plan for every builder, event for event), the coordinator's
tick on externally computed gradients, and the multi-process cluster on
the CPU.

The load-bearing claim is the reference's: a multi-process cluster run —
fault plan, kills, rejoins and all — reproduces the in-process trainer
exactly once its recorded membership events are replayed through
:func:`repro_torch.core.spmd_psp.external_drive`: ``final_params`` bit
for bit.  The port does not need the reference's solo-grad ≡ vmap-row
identity for it (its trainer computes each worker's gradient in a loop).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.core.faults import (BUILDERS, FaultEvent,  # noqa: E402
                                     FaultPlan, make_plan, plan_from_env)
from repro_torch.tree import tree_leaves  # noqa: E402

SPECS = ["none", "kill-one", "kill-one:seed=7", "kill-one:worker=1,at=4",
         "stall-one:seed=2,d=2.5", "standard", "standard:seed=3,k=4",
         "rack:g=2,seed=1", "rack:g=3,seed=4", "torn-storm",
         "torn-storm:k=3,at=2,corrupt=1"]


class TestFaultPlan:
    def test_builders_produce_valid_plans(self):
        for name in BUILDERS:
            plan = make_plan(name, n_workers=4, ticks=30)
            assert plan.name == name
            for ev in plan.events:
                assert 0 <= ev.tick < 30
                if ev.worker is not None:
                    assert 0 <= ev.worker < 4

    def test_seed_determinism(self):
        a = make_plan("kill-one:seed=7", n_workers=6, ticks=40)
        b = make_plan("kill-one:seed=7", n_workers=6, ticks=40)
        c = make_plan("kill-one:seed=8", n_workers=6, ticks=40)
        assert a.events == b.events
        assert a.events != c.events or a.seed != c.seed

    def test_json_roundtrip(self, tmp_path):
        plan = make_plan("standard:seed=3", n_workers=5, ticks=24)
        path = str(tmp_path / "plan.json")
        plan.save(path)
        back = FaultPlan.from_json(open(path).read())
        assert back == plan
        assert make_plan(path, n_workers=5, ticks=24).events == plan.events

    def test_publish_fault_covers_count_window(self):
        plan = make_plan("torn-storm:k=3,at=2", n_workers=1, ticks=10)
        kinds = [getattr(plan.publish_fault(i), "kind", None)
                 for i in range(7)]
        assert kinds[2:5] == ["torn_snapshot"] * 3
        assert kinds[0] is None and kinds[5] is None

    def test_rack_never_kills_everyone(self):
        for seed in range(5):
            plan = make_plan(f"rack:g=2,seed={seed}", n_workers=4, ticks=20)
            killed = {e.worker for e in plan.events if e.kind == "kill"}
            assert 0 < len(killed) < 4

    def test_bad_specs_raise(self):
        with pytest.raises(ValueError, match="unknown fault plan"):
            make_plan("no-such-plan", n_workers=2, ticks=10)
        with pytest.raises(ValueError):
            make_plan("kill-one:worker", n_workers=2, ticks=10)
        with pytest.raises(ValueError):
            FaultEvent("not-a-kind", 0)

    def test_plan_from_env(self, monkeypatch):
        monkeypatch.delenv("PSP_FAULT_PLAN", raising=False)
        assert plan_from_env(n_workers=2, ticks=10).name == "none"
        monkeypatch.setenv("PSP_FAULT_PLAN", "kill-one:worker=1,at=4")
        assert plan_from_env(n_workers=2, ticks=10).kills_at(4) == [1]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n_workers,ticks", [(3, 20), (6, 40)])
def test_plan_equals_reference(spec, n_workers, ticks, tmp_path):
    """The same spec compiles to the reference's plan, event for event,
    and the two packages read each other's plan JSON."""
    faults = pytest.importorskip("repro.core.faults")
    want = faults.make_plan(spec, n_workers=n_workers, ticks=ticks)
    got = make_plan(spec, n_workers=n_workers, ticks=ticks)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert [dataclasses.asdict(e) for e in got.events] == \
        [dataclasses.asdict(e) for e in want.events]
    path = str(tmp_path / "plan.json")
    want.save(path)
    assert make_plan(path, n_workers=n_workers, ticks=ticks) == got


def _cfg(**kw):
    base = dict(barrier="pbsp", n_workers=4, staleness=3, sample_size=2,
                straggler_frac=0.25)
    base.update(kw)
    return sp.PSPConfig(**base)


def test_apply_tick_with_pushed_grads_matches_fused_step():
    """The coordinator's path: pushers' gradients computed outside the
    tick (zeros elsewhere) give every state leaf of the in-process
    trainer, bit for bit, over 40 ticks."""
    dim, B = 16, 8
    cfg = _cfg()
    w_true, grad_fn, opt_update = sp.linear_psp_task(dim, lr=0.1, seed=0)
    na, nb = sp.GeneratorNoise(1), sp.GeneratorNoise(1)
    fused = sp.make_psp_step_fn(cfg, grad_fn, opt_update, na)
    sa = sp.linear_psp_state(cfg, dim, na)
    sb = sp.linear_psp_state(cfg, dim, nb)
    gen = torch.Generator().manual_seed(2)
    for _ in range(40):
        x = torch.randn((cfg.n_workers, B, dim), generator=gen)
        batch = (x, x @ w_true)
        push = ((sb.busy_until <= sb.now) & ~sb.pushed & sb.alive).numpy()
        losses = torch.zeros(cfg.n_workers)
        grads = {"w": torch.zeros(cfg.n_workers, dim)}
        rows = torch.zeros(cfg.n_workers, dim)
        for w in np.flatnonzero(push):
            rows[w] = sb.views["w"][w]
            loss, g = grad_fn({"w": rows[w]}, (x[w], batch[1][w]))
            losses[w], grads["w"][w] = loss, g["w"]
        sa, _ = fused(sa, batch)
        sb, _ = sp.psp_apply_tick(cfg, opt_update, sb,
                                  lambda _: (losses, grads),
                                  nb.tick_record(cfg))
        for f in sp.PSPState._fields:
            for la, lb in zip(tree_leaves(getattr(sa, f)),
                              tree_leaves(getattr(sb, f))):
                assert torch.equal(la, lb), f


def test_heartbeat_beats_from_two_threads(tmp_path):
    """A worker's main thread and its beat thread write the same sidecar
    through one temporary name; neither may lose its rename."""
    import threading
    from repro_torch.launch.cluster import _Heartbeat, _read_json
    hb = _Heartbeat(str(tmp_path / "worker_0.json"), 0, 0, 0.25)
    errors = []

    def hammer():
        for _ in range(2000):
            try:
                hb.beat()
            except OSError as e:
                errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert _read_json(str(tmp_path / "worker_0.json"))["worker"] == 0


# --------------------------------------------------------------------------- #
# the real thing: subprocess cluster runs on the CPU
# --------------------------------------------------------------------------- #
def _replay(cfg, dim, ticks, result, batch):
    """Feed a cluster run's recorded events back through external_drive."""
    events = {}
    for t, kind, w in result["events"]:
        lv, jn = events.setdefault(t, ([], []))
        (lv if kind == "leave" else jn).append(w)
    events = {t: (tuple(l), tuple(j)) for t, (l, j) in events.items()}
    _, it = sp.external_drive(cfg, dim, ticks, events, batch=batch)
    for state, _m in it:
        pass
    return state


class TestClusterIntegration:
    DIM, BATCH = 16, 4

    @pytest.fixture(autouse=True)
    def _one_thread_workers(self, monkeypatch):
        # the worker subprocesses' products are tiny: threads only contend
        monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def test_nofault_run_matches_single_process(self, tmp_path):
        from repro_torch.launch.cluster import run_cluster
        cfg = _cfg(n_workers=3)
        res = run_cluster(cfg, self.DIM, 12, str(tmp_path),
                          batch=self.BATCH, tick_timeout=120.0,
                          device="cpu")
        assert res["events"] == [] and res["completed"]
        ref = _replay(cfg, self.DIM, 12, res, self.BATCH)
        assert np.array_equal(ref.server_params["w"].numpy(),
                              res["final_params"]["w"])
        assert int(ref.total_pushes) == res["total_pushes"]
        on_disk = json.load(open(os.path.join(str(tmp_path),
                                              "result.json")))
        assert on_disk["total_pushes"] == res["total_pushes"]

    def test_kill_one_rejoins_and_replays_bit_exact(self, tmp_path):
        from repro_torch.launch.cluster import run_cluster
        cfg = _cfg(n_workers=3, straggler_frac=0.0)
        ticks = 24
        plan = make_plan("kill-one:worker=1,at=4", n_workers=3, ticks=ticks)
        res = run_cluster(cfg, self.DIM, ticks, str(tmp_path),
                          batch=self.BATCH, plan=plan, tick_timeout=120.0,
                          tick_min_wall=0.5, device="cpu")
        kinds = [(kind, w) for _t, kind, w in res["events"]]
        assert ("leave", 1) in kinds and ("join", 1) in kinds
        assert res["epochs"] == {"0": 0, "1": 1, "2": 0}
        rec = res["recovery"]["1"]
        assert rec["latency_s"] > 0
        assert rec["t_kill"] < rec["t_rejoin"] < rec["t_push"]
        ref = _replay(cfg, self.DIM, ticks, res, self.BATCH)
        assert np.array_equal(ref.server_params["w"].numpy(),
                              res["final_params"]["w"])
        assert int(ref.total_pushes) == res["total_pushes"]
        assert ref.alive.tolist() == res["alive"]

    def test_cli_runs_a_cluster(self, tmp_path):
        """``python -m repro_torch.launch.cluster --device cpu`` runs a
        no-fault cluster and prints its record."""
        import subprocess
        import sys
        env = {**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(__file__), "..", "src")}
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
             "cpu", "--workers", "2", "--ticks", "4", "--dim", "8",
             "--plan", "none", "--dir", str(tmp_path)],
            capture_output=True, text=True, env=env, timeout=180)
        assert run.returncode == 0, run.stderr[-2000:]
        res = json.loads(run.stdout)
        assert res["completed"] and res["events"] == []
        assert res["epochs"] == {"0": 0, "1": 0} and res["plan"] == "none"

    def test_cluster_rejects_internal_churn_config(self, tmp_path):
        from repro_torch.launch.cluster import run_cluster
        cfg = _cfg(churn=sp.ChurnConfig(leave_rate=0.1, join_rate=0.1))
        with pytest.raises(ValueError, match="churn"):
            run_cluster(cfg, 8, 4, str(tmp_path), device="cpu")
