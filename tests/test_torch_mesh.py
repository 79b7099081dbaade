"""The port's sweep planner on a mesh, and its meshes and collectives over
a process group.

* the planner (``repro_torch.core.sweep_plan``): the reference's
  ``TestMesh``, ``TestParseMesh``, ``TestMesh2D`` and
  ``test_row_padding_is_even`` cases at ``available`` 1–8 (no processes
  needed), and every field of ``SweepPlan`` against the reference's
  ``plan_sweep`` run in one subprocess on 8 forced host devices with
  ``jax.devices`` cut to each count;
* the mesh over a (data 2, model 2) gloo world of four ranks
  (``spawn_host_world``): ``psum``/``pmin``/``pmax``/``all_gather``/
  ``axis_index`` over one and two dimensions, booleans, ``None`` as the
  identity, the call counts; ``sweep_mesh`` (cached, and a sub-mesh
  leaving ranks out); ``AxisRules.sharding``'s placements,
  ``place_params`` and ``constrain``;
* ``spawn_host_world`` stops every rank and raises when one fails or the
  wall limit passes;
* ``sweep_bench --mesh 2x1`` on the CPU: its tensor row on two gloo
  ranks, with the reference's mesh fields.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dist  # noqa: E402
from repro_torch.core import sweep_plan  # noqa: E402
from repro_torch.core.sweep_plan import parse_mesh, plan_sweep  # noqa: E402
from repro_torch.kernels.psp_tick import DATA_PLANE_BLOCK  # noqa: E402
from repro_torch.launch.mesh import spawn_host_world  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_mesh(monkeypatch):
    """The planner cases pass their meshes explicitly: an ambient
    ``PSP_SWEEP_MESH`` / ``PSP_SWEEP_DEVICES`` must not leak in."""
    monkeypatch.delenv("PSP_SWEEP_MESH", raising=False)
    monkeypatch.delenv("PSP_SWEEP_DEVICES", raising=False)


def _measure_idx(n_ticks, every):
    return np.arange(every - 1, n_ticks, every)


def _plan(B=8, P=16, available=8, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("d", 8)
    kw.setdefault("k_max", 1)
    kw.setdefault("masked", False)
    kw.setdefault("has_churn", False)
    return plan_sweep(100, _measure_idx(100, 25), B, P, available=available,
                      **kw)


#: planner cases held to the reference field by field: (B, P, kwargs)
PARITY = [
    (3, 16, {"n_devices": 64}), (8, 16, {}), (8, 16, {"mesh": (4, 2)}),
    (1, 100, {"mesh": (1, 8)}), (5, 12, {"mesh": (2, 4)}),
    (7, 16, {"mesh": (4, 2)}), (3, 24, {"mesh": (1, 8)}),
    (9, 10, {"mesh": (8, 1)}), (2, 16, {"mesh": (8, 4)}),
    (5, 12, {"n_devices": 2}), (7, 12, {"n_devices": 4}),
    (1, 12, {"n_devices": 8}), (8, 16, {"mesh": (2, 1)}),
    (6, 20, {"mesh": (3, 3), "k_max": 3, "masked": True,
             "has_churn": True}),
]


@pytest.fixture(scope="module")
def reference_plans():
    """The reference's plans of :data:`PARITY` at every device count
    1–8, from one subprocess."""
    cases = []
    for avail in range(1, 9):
        for B, P, kw in PARITY:
            kw = dict(kw)
            fixed = dict(batch=4, d=8, k_max=kw.pop("k_max", 1),
                         masked=kw.pop("masked", False),
                         has_churn=kw.pop("has_churn", False), **kw)
            cases.append(((100, _measure_idx(100, 25), B, P), fixed, avail))
    ref = _torch_dist.Reference(8, {"plans": ("plan", cases)})
    return cases, ref.result()["plans"]


def test_plans_match_reference(reference_plans):
    """Every field of every plan at available 1–8 equals the
    reference's on that many devices."""
    cases, want = reference_plans
    assert len(want) == 8 * len(PARITY)
    for (args, kw, avail), ref in zip(cases, want):
        got = dataclasses.asdict(plan_sweep(*args, available=avail, **kw))
        ref = {k: tuple(v) if isinstance(v, list) else v
               for k, v in ref.items()}
        assert got == ref, (args[2:], kw, avail)


class TestMesh:
    @pytest.mark.parametrize("available", range(1, 9))
    def test_clamped_to_rows_and_available_devices(self, available):
        plan = plan_sweep(100, _measure_idx(100, 25), 3, 16,
                          batch=4, d=8, k_max=1, masked=False,
                          has_churn=False, n_devices=64,
                          available=available)
        assert plan.n_devices <= min(3, available)
        assert plan.b_pad % plan.n_devices == 0
        assert plan.node_pad % plan.n_devices == 0
        assert plan.b_pad >= 3
        assert plan.node_pad >= 16

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("PSP_SWEEP_DEVICES", "1")
        plan = plan_sweep(100, _measure_idx(100, 25), 8, 16,
                          batch=4, d=8, k_max=1, masked=False,
                          has_churn=False, available=8)
        assert plan.n_devices == 1
        # rows pad to the data-plane block width per device
        assert plan.b_pad == DATA_PLANE_BLOCK

    def test_devices_default_to_the_group(self):
        """Without a process group there is one device: the mesh is
        (1, 1) whatever is asked for."""
        assert sweep_plan.available_devices() == 1
        plan = plan_sweep(100, _measure_idx(100, 25), 8, 16, batch=4, d=8,
                          k_max=1, masked=False, has_churn=False,
                          mesh=(4, 2))
        assert plan.mesh == (1, 1) and plan.n_devices == 1


class TestParseMesh:
    @pytest.mark.parametrize("spec,want", [
        ("4x2", (4, 2)), ("1x1", (1, 1)), ("8X1", (8, 1)),
        (" 2x4 ", (2, 4)), ("16x16", (16, 16)),
    ])
    def test_accepts_rxn(self, spec, want):
        assert parse_mesh(spec) == want

    @pytest.mark.parametrize("spec", [
        "4x", "x2", "4", "axb", "4x2x1", "-4x2", "0x2", "4x0",
        "4*2", "", "4 x 2",
    ])
    def test_rejects_malformed(self, spec):
        with pytest.raises(ValueError):
            parse_mesh(spec)


class TestMesh2D:
    def test_explicit_mesh_factorizes_devices(self):
        plan = _plan(mesh=(4, 2))
        assert plan.mesh == (4, 2)
        assert plan.n_devices == 8
        assert plan.rows == 4 and plan.nodes == 2

    def test_node_axis_must_divide_p_exactly(self):
        # P = 100: a nodes=8 request degrades to the largest divisor ≤ 8
        plan = _plan(B=1, P=100, mesh=(1, 8))
        assert plan.nodes == 5
        assert plan.p_loc * plan.nodes == 100

    def test_padding_invariants(self):
        for mesh, B, P in [((2, 4), 5, 12), ((4, 2), 7, 16),
                           ((1, 8), 3, 24), ((8, 1), 9, 10)]:
            plan = _plan(B=B, P=P, mesh=mesh)
            rows, nodes = plan.mesh
            assert P % nodes == 0
            assert plan.p_loc == P // nodes
            # row blocks: block-width padded, equal per rows-axis shard
            assert plan.b_pad % (rows * DATA_PLANE_BLOCK) == 0
            assert plan.b_pad >= B
            # node-keyed draw slots: per node column, padded to the rows
            # axis
            col = plan.node_pad // nodes
            assert col == -(-plan.p_loc // rows) * rows
            assert plan.node_pad >= P

    @pytest.mark.parametrize("available", range(2, 9))
    def test_degenerate_mesh_equals_1d_plan(self, available):
        ndev = min(4, available)
        one_d = _plan(n_devices=ndev, available=available)
        two_d = _plan(mesh=(ndev, 1), available=available)
        assert two_d.mesh == (ndev, 1)
        assert (two_d.stride, two_d.chunks, two_d.b_pad, two_d.node_pad,
                two_d.n_devices) == \
               (one_d.stride, one_d.chunks, one_d.b_pad, one_d.node_pad,
                one_d.n_devices)

    def test_env_override_and_precedence(self, monkeypatch):
        monkeypatch.setenv("PSP_SWEEP_MESH", "2x4")
        plan = _plan()
        assert plan.mesh == (2, 4)
        # an explicit mesh beats the env override
        plan = _plan(mesh=(8, 1))
        assert plan.mesh == (8, 1)
        # malformed env specs fail loudly, not silently
        monkeypatch.setenv("PSP_SWEEP_MESH", "8by1")
        with pytest.raises(ValueError):
            _plan()

    def test_rows_clamp_to_batch_then_nodes_fit_remaining(self):
        # B=2 clamps rows 8→2; nodes budget is available // rows = 4
        plan = _plan(B=2, P=16, mesh=(8, 4))
        assert plan.rows == 2
        assert plan.nodes == 4
        assert plan.n_devices <= 8

    def test_stride_does_not_depend_on_the_mesh(self):
        """The noise budget counts the block every rank draws (the
        one-rank row padding), so every mesh gets one-rank's stride: here
        (P 200, masked) a budget over the 2-row padding's 32 rows would
        cap the stride at 5, the one-rank block allows 25."""
        kw = dict(k_max=3, masked=True, has_churn=True)
        one = _plan(B=3, P=200, mesh=(1, 1), **kw)
        assert one.stride == 25
        for m in ((2, 1), (3, 1), (2, 4)):
            plan = _plan(B=3, P=200, mesh=m, **kw)
            assert plan.rows > 1 and plan.stride == one.stride, m


@pytest.mark.parametrize("B,ndev", [(5, 2), (7, 4), (1, 8)])
@pytest.mark.parametrize("available", range(1, 9))
def test_row_padding_is_even(B, ndev, available):
    plan = plan_sweep(100, _measure_idx(100, 25), B, 12,
                      batch=4, d=8, k_max=1, masked=False,
                      has_churn=False, n_devices=ndev, available=available)
    eff = min(ndev, B, available)
    assert plan.n_devices == eff
    # per-device block: ceil(B/eff) rows, rounded up to the block width
    b_rows = -(-B // eff)
    b_loc = -(-b_rows // DATA_PLANE_BLOCK) * DATA_PLANE_BLOCK
    assert plan.b_pad == b_loc * eff
    assert plan.b_pad % (eff * DATA_PLANE_BLOCK) == 0


# --------------------------------------------------------------------------- #
# the mesh over a process group
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world4():
    """:func:`_torch_dist.mesh_world` on four gloo ranks."""
    return spawn_host_world(4, _torch_dist.mesh_world, wall=120.0)


def test_host_mesh_and_collectives(world4):
    """Ranks lie rows-major on (data 2, model 2); the collectives reduce
    and gather along one dimension or both (row-major order), exactly,
    and return new tensors; ``None`` is the identity."""
    x = {r: np.array([r, 10 * r + 1], np.int32) for r in range(4)}
    for out in world4:
        r = out["rank"]
        d, m = divmod(r, 2)
        assert out["axis_names"] == ("data", "model")
        assert out["shape"] == {"data": 2, "model": 2} and out["size"] == 4
        assert out["index"] == (d, m, r) and out["sizes"] == (2, 4)
        row = [2 * d, 2 * d + 1]
        np.testing.assert_array_equal(out["psum_model"], x[row[0]] + x[row[1]])
        np.testing.assert_array_equal(out["psum_both"], sum(x.values()))
        np.testing.assert_array_equal(out["pmin_data"],
                                      np.minimum(x[m], x[m + 2]))
        np.testing.assert_array_equal(out["pmax_both"], [3.0, 31.0])
        np.testing.assert_array_equal(out["gather_model"],
                                      np.stack([x[row[0]], x[row[1]]]))
        np.testing.assert_array_equal(out["gather_both"],
                                      np.concatenate([x[i][None]
                                                      for i in range(4)], 1))
        assert out["gather_bool"].dtype == bool
        np.testing.assert_array_equal(out["gather_bool"],
                                      [True, True, False, True])
        np.testing.assert_array_equal(out["pmax_bool"], [m == 0, True])
        np.testing.assert_array_equal(out["unchanged"], x[r])
        assert out["none"] == (True, True, 0, 1)
        # one all_reduce per dimension reduced; one all_gather per
        # dimension gathered
        assert out["calls"] == {"all_reduce": 7, "all_gather": 4}


def test_sweep_mesh(world4):
    """``sweep_mesh`` is a (rows, nodes) ``DeviceMesh``, rows-major,
    cached; a smaller mesh leaves the later ranks without a
    coordinate."""
    for out in world4:
        r = out["rank"]
        assert out["sweep"] == (("rows", "nodes"), (2, 2), (r // 2, r % 2),
                                True)
        assert out["sub_coordinate"] == ((0, r) if r < 2 else None)


def test_rules_place_and_constrain(world4):
    """``AxisRules.sharding`` gives one placement per mesh dimension;
    ``place_params`` distributes by the defs' logical axes;
    ``constrain`` redistributes a ``DTensor`` and leaves plain tensors,
    and everything without rules, as they are."""
    whole = np.arange(32.0).reshape(4, 8)
    for out in world4:
        d, m = divmod(out["rank"], 2)
        assert out["spec"] == (("data",), ("model",))
        assert out["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        np.testing.assert_array_equal(out["local_w"],
                                      whole[2 * d:2 * d + 2,
                                            4 * m:4 * m + 4])
        np.testing.assert_array_equal(out["local_b"], np.ones(8))
        np.testing.assert_array_equal(out["whole_w"], whole)
        local, placements = out["constrained"]
        np.testing.assert_array_equal(local, whole[2 * d:2 * d + 2])
        assert placements == ["Shard(dim=0)", "Replicate()"]
        assert out["plain_kept"] and out["no_rules"] and out["is_dtensor"]
        assert out["thin_placements"] == ["Replicate()", "Shard(dim=1)"]


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn_host_world(1, _torch_dist.fail_world, wall=60.0)


def test_spawn_stops_at_its_wall_limit():
    with pytest.raises(TimeoutError, match="passed 3.0 s"):
        spawn_host_world(2, _torch_dist.hang_world, wall=3.0)


def test_sweep_bench_on_a_mesh(tmp_path, monkeypatch):
    """``sweep_bench --device cpu --mesh 2x1``: the tensor row runs on two
    spawned gloo ranks, records the mesh it ran on, and its results are
    the one-process row's (the same deviation from the event engine)."""
    from repro_torch.bench import sweep_bench
    from repro_torch.core import SimConfig, make_barrier
    monkeypatch.setattr(sweep_bench, "_configs", lambda full: [
        SimConfig(n_nodes=12, duration=1.0, dim=4, seed=3, straggler_frac=f,
                  barrier=make_barrier(n, staleness=4, sample_size=1))
        for n in ("bsp", "pssp") for f in (0.0, 0.3)])
    monkeypatch.setattr(sweep_bench, "_100k_configs", lambda: [
        SimConfig(n_nodes=50, duration=0.2, dim=4, batch=2, seed=3,
                  barrier=make_barrier("ssp", staleness=4))])
    one = sweep_bench.sweep_speedup(device="cpu", out_path=None, repeats=1)
    sweep_bench.main(["--device", "cpu", "--mesh", "2x1", "--out",
                      str(tmp_path / "bench.json")])
    res = json.loads((tmp_path / "bench.json").read_text())
    row = res["engines"]["torch"]
    assert (row["n_devices"], row["mesh"], row["mesh_axes"]) == \
        (2, [2, 1], {"rows": 2, "nodes": 1})
    assert row["max_progress_deviation"] == \
        one["engines"]["torch"]["max_progress_deviation"]
    assert one["engines"]["torch"]["mesh"] == [1, 1]
