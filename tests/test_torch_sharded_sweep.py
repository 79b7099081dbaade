"""The node-sharded tick and the sharded sweep over a gloo world of four
ranks on the CPU.

* the tick: the nine ``CASES`` of ``test_torch_psp_tick``, five chained
  ticks each at P 8, through
  :func:`repro_torch.kernels.psp_tick.psp_tick_sharded` on the
  ``(rows, nodes)`` meshes (1, 2), (1, 4) and (2, 2).  Each rank's block
  of every output equals the unsharded port's
  :func:`~repro_torch.kernels.psp_tick.psp_tick_ref` bit for bit, and
  the reference's ``psp_tick_sharded`` under ``shard_map`` on
  ``sweep_mesh(1, 4)`` (one subprocess on four forced host devices, run
  eagerly): the control plane exactly, the data plane within
  ``test_torch_psp_tick.DATA_TOL`` (XLA's dot sums in another order).
* the sweep: the reference's ``TestShardedSweeps`` scenario through
  ``run_sweep(..., mesh=)`` on meshes (1, 1), (2, 1), (1, 2) and (2, 2):
  steps, errors, server updates, total updates and control messages
  bit-identical to one process without a group, on every rank; three
  rows on a two-row mesh (padded rows); and the kernel path's gather →
  full tick → slice plumbing, with the CUDA tick swapped for a plain
  version that writes in place as the kernel does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dist  # noqa: E402
from repro_torch.convert import (tick_inputs_to_torch, to_numpy,  # noqa: E402
                                 to_torch)
from repro_torch.core import SimConfig, make_barrier  # noqa: E402
from repro_torch.core.vector_sim import run_sweep  # noqa: E402
from repro_torch.kernels.psp_tick import (NODE_STATE_KEYS,  # noqa: E402
                                          psp_tick_ref)
from repro_torch.launch.mesh import spawn_host_world  # noqa: E402

from test_kernels import _tick_problem  # noqa: E402
from test_torch_psp_tick import (CASES, DATA_TOL, EXACT,  # noqa: E402
                                 _rand_for_tick)

TICK_MESHES = ((1, 2), (1, 4), (2, 2))
SWEEP_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))


def _scenario(name, frac, churn, seed):
    """The reference test's ``_scenario``, as a port config."""
    return SimConfig(n_nodes=24, duration=5.0, dim=8, batch=4, seed=seed,
                     straggler_frac=frac,
                     churn_leave_rate=0.8 if churn else 0.0,
                     churn_join_rate=0.8 if churn else 0.0,
                     barrier=make_barrier(name, staleness=3, sample_size=2))


CFGS = [_scenario("pssp", 0.2, False, s) for s in range(4)] + \
    [_scenario("bsp", 0.1, True, 9)]


def _problems():
    """Each case's (state, five ticks' noise, params, leave_n, join_n,
    kw), in numpy."""
    out = {}
    for case in CASES:
        churn, ragged, k_max, adaptive = case
        state, rand, params, ln, jn, masked = _tick_problem(
            0, 3, 8, churn, ragged, k_max, adaptive=adaptive)
        kw = dict(k_max=k_max, has_churn=churn, masked=masked,
                  adaptive=adaptive)
        out[case] = (state, [_rand_for_tick(rand, i) for i in range(5)],
                     params, ln, jn, kw)
    return out


def _sweep_runs():
    runs = [(f"mesh{m}", CFGS, m) for m in SWEEP_MESHES]
    runs.append(("pad", CFGS[:3], (2, 1)))
    runs += [(f"gathered{m}", CFGS, m) for m in ((1, 2), (2, 2))]
    return runs


@pytest.fixture(scope="module")
def world():
    """The tick and the sweep on four gloo ranks, and the reference's
    sharded tick on four forced host devices, side by side."""
    problems = _problems()
    ref = _torch_dist.Reference(4, {"tick": ("tick", problems)})
    ranks = spawn_host_world(
        4, _torch_dist.jobs_world,
        [("tick_world", (problems, TICK_MESHES)),
         ("sweep_world", (_sweep_runs(), ("gathered(1, 2)",
                                          "gathered(2, 2)")))],
        wall=240.0)
    return problems, ranks, ref.result()["tick"]


def _unsharded(problems):
    """The port's unsharded plain tick on each problem: per case, five
    ticks' (state, out) in numpy."""
    out = {}
    for case, (state, rands, params, ln, jn, kw) in problems.items():
        s, _, p = tick_inputs_to_torch(state, {}, params)
        ticks = []
        for i, rand in enumerate(rands):
            _, r, _ = tick_inputs_to_torch({}, rand, {})
            s, o = psp_tick_ref(s, r, p, float(np.float32(0.4 * (i + 1))),
                                to_torch(ln), to_torch(jn), **kw)
            ticks.append((to_numpy(s), to_numpy(o)))
        out[case] = ticks
    return out


def _block(k, v, rows, nodes):
    """The (rows, nodes) block of a full-width state or output entry."""
    v = np.asarray(v)
    if v.ndim == 0:
        return v
    if v.ndim == 1 or k == "w":
        return v[rows]
    return v[rows, nodes]


def _check(got, want, exact_all, what):
    for k, v in want.items():
        if exact_all or k in EXACT:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], v, **DATA_TOL,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh", TICK_MESHES)
@pytest.mark.parametrize("case", CASES)
def test_sharded_tick_equals_unsharded(world, case, mesh):
    """Every rank's block of every field after each of five ticks equals
    the unsharded plain tick's, bit for bit."""
    problems, ranks, _ = world
    want = _unsharded({case: problems[case]})[case]
    seen = 0
    for rank in ranks:
        tick = rank[0].get((mesh, case))
        if tick is None:
            continue
        seen += 1
        rows, nodes, ticks = tick
        for i, ((s, o), (ws, wo)) in enumerate(zip(ticks, want)):
            _check(s, {k: _block(k, v, rows, nodes) for k, v in ws.items()},
                   True, f"{mesh} tick {i} state")
            _check(o, {k: _block(k, v, rows, nodes) for k, v in wo.items()},
                   True, f"{mesh} tick {i} out")
    assert seen == mesh[0] * mesh[1]


@pytest.mark.parametrize("case", CASES)
def test_sharded_tick_matches_reference(world, case):
    """On (1, 4) each rank's block equals the reference's
    ``psp_tick_sharded`` under ``shard_map`` on four devices: control
    plane exact, data plane within ``DATA_TOL``."""
    _, ranks, ref = world
    for rank in ranks:
        rows, nodes, ticks = rank[0][((1, 4), case)]
        for i, ((s, o), (ws, wo)) in enumerate(zip(ticks, ref[case])):
            _check(s, {k: _block(k, v, rows, nodes) for k, v in ws.items()},
                   False, f"tick {i} state")
            _check(o, {k: _block(k, v, rows, nodes) for k, v in wo.items()},
                   False, f"tick {i} out")


def _fields(results):
    return [{"steps": r.steps, "errors": r.errors,
             "server_updates": r.server_updates,
             "total_updates": r.total_updates,
             "control_messages": r.control_messages} for r in results]


@pytest.fixture(scope="module")
def single():
    """The scenario on one process without a group."""
    return {"all": _fields(run_sweep(CFGS, device="cpu")),
            "pad": _fields(run_sweep(CFGS[:3], device="cpu"))}


def _same(a, b, what):
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(np.asarray(y[k]), np.asarray(x[k]),
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh", SWEEP_MESHES)
def test_sweep_bit_identical_across_meshes(world, single, mesh):
    """Every rank returns the one-process results bit for bit, and the
    plan took the mesh asked for."""
    _, ranks, _ = world
    for r, rank in enumerate(ranks):
        fields, calls, plan_mesh, _ = rank[1][f"mesh{mesh}"]
        assert plan_mesh == mesh
        _same(single["all"], fields, f"{mesh} rank {r}")
        if mesh[1] > 1 and r < mesh[0] * mesh[1]:
            # the node-sharded tick reduces across the nodes axis
            assert calls.get("all_reduce", 0) > 0, calls


def test_odd_row_count_pads_evenly(world, single):
    """Three rows on a two-row mesh pad with inert rows: the real rows'
    results are those of one process."""
    _, ranks, _ = world
    for r, rank in enumerate(ranks):
        fields, _, plan_mesh, _ = rank[1]["pad"]
        assert plan_mesh == (2, 1)
        _same(single["pad"], fields, f"rank {r}")


@pytest.mark.parametrize("mesh", ((1, 2), (2, 2)))
def test_gathered_kernel_path(world, single, mesh):
    """The kernel path under node sharding (gather → full-width tick →
    slice, ``w``/``pulled`` written in place) gives the one-process
    results; the tick it calls sees the full P, and a tick gathers only
    the node state (the seven node entries of a static barrier's state):
    its noise comes at full width."""
    _, ranks, _ = world
    n_node_state = len(NODE_STATE_KEYS) - 1       # no adaptive pol_ema
    for r, rank in enumerate(ranks):
        fields, _, _, launches = rank[1][f"gathered{mesh}"]
        _same(single["all"], fields, f"{mesh} rank {r}")
        if r < mesh[0] * mesh[1]:
            assert launches and all(s[1] == 24 for s, _ in launches), \
                launches
            per_tick = min(b - a for (_, a), (_, b) in zip(launches,
                                                           launches[1:]))
            assert per_tick == n_node_state, per_tick
