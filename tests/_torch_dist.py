"""Rank functions of the port's process-group tests.

Each runs on every rank of a group that
:func:`repro_torch.launch.mesh.spawn_host_world` starts (gloo on the
CPU), builds what it needs from picklable arguments (numpy arrays,
configs) and returns numpy results; the test process holds them against
the unsharded port and the reference.  This module imports torch and the
port only: the spawned ranks never import jax.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.parallel import collectives


def _np(tree):
    """A tree of tensors as numpy arrays (bf16 as float32)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


# --------------------------------------------------------------------------- #
# the mesh, the collectives and the placements
# --------------------------------------------------------------------------- #
def mesh_world():
    """The collectives on a (2, 2) host mesh, the sweep mesh, the rules'
    placements, ``constrain`` and ``place_params``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import ParamDef, place_params
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import (constrain, make_rules,
                                               sweep_mesh, use_rules)
    rank = dist.get_rank()
    mesh = make_host_mesh(2, 2)
    out = {"rank": rank, "axis_names": mesh.axis_names, "shape": mesh.shape,
           "size": mesh.size}
    data = collectives.mesh_axis(mesh, "data")
    model = collectives.mesh_axis(mesh, "model")
    both = collectives.mesh_axis(mesh, ("data", "model"))
    collectives.reset_call_counts()
    x = torch.tensor([rank, 10 * rank + 1], dtype=torch.int32)
    out["index"] = (collectives.axis_index(data),
                    collectives.axis_index(model),
                    collectives.axis_index(both))
    out["sizes"] = (collectives.axis_size(data), collectives.axis_size(both))
    out["psum_model"] = collectives.psum(x, model).numpy()
    out["psum_both"] = collectives.psum(x, both).numpy()
    out["pmin_data"] = collectives.pmin(x, data).numpy()
    out["pmax_both"] = collectives.pmax(x.float(), both).numpy()
    out["gather_model"] = collectives.all_gather(x[None], model, 0).numpy()
    out["gather_both"] = collectives.all_gather(x[None], both, 1).numpy()
    flag = torch.tensor([rank % 2 == 0, True])
    out["gather_bool"] = collectives.all_gather(flag, model, 0).numpy()
    out["pmax_bool"] = collectives.pmax(flag, data).numpy()
    out["unchanged"] = x.numpy()
    out["none"] = (collectives.psum(x, None) is x,
                   collectives.all_gather(x, None) is x,
                   collectives.axis_index(None), collectives.axis_size(None))
    out["calls"] = collectives.call_counts()
    sw = sweep_mesh(2, 2)
    out["sweep"] = (tuple(sw.mesh_dim_names), tuple(sw.mesh.shape),
                    tuple(sw.get_coordinate()), sweep_mesh(2, 2) is sw)
    sub = sweep_mesh(1, 2).get_coordinate()
    out["sub_coordinate"] = None if sub is None else tuple(sub)
    # placements, constrain and place_params over the (data, model) mesh
    cfg = type("Cfg", (), {"n_heads": 4})()
    rules = make_rules(cfg, None, mesh)
    out["spec"] = rules.spec(("batch", "heads"), (4, 8))
    out["placements"] = [repr(p) for p in rules.sharding(("batch", "heads"),
                                                         (4, 8))]
    defs = {"w": ParamDef((4, 8), ("d_model_w", "heads_w")),
            "b": [ParamDef((8,), (None,))]}
    full = {"w": torch.arange(32.0).reshape(4, 8), "b": [torch.ones(8)]}
    placed = place_params(full, rules, defs)
    out["local_w"] = placed["w"].to_local().numpy()
    out["local_b"] = placed["b"][0].to_local().numpy()
    out["whole_w"] = placed["w"].full_tensor().numpy()
    with use_rules(rules):
        moved = constrain(placed["w"], ("d_model_w", None))
        out["constrained"] = (moved.to_local().numpy(),
                              [repr(p) for p in moved.placements])
        plain = torch.ones(3)
        out["plain_kept"] = constrain(plain, ("batch",)) is plain
    out["no_rules"] = constrain(placed["w"], ("batch", None)) is placed["w"]
    # a mesh axis of one rank splits nothing: it is replicated
    thin = make_rules(cfg, None, make_host_mesh(1, 4))
    out["thin_placements"] = [repr(p) for p in thin.sharding(
        ("batch", "heads"), (4, 8))]
    out["is_dtensor"] = isinstance(placed["w"], DTensor)
    return out


def jobs_world(jobs):
    """Several rank functions of this module in one world: ``jobs`` is a
    list of (function name, args); returns their results in order."""
    return [globals()[name](*args) for name, args in jobs]


def fail_world():
    """A rank that raises."""
    raise ValueError("this rank fails on purpose")


def hang_world():
    """A rank that never returns."""
    while True:
        time.sleep(1.0)


# --------------------------------------------------------------------------- #
# the node-sharded tick
# --------------------------------------------------------------------------- #
def _block(a, rows, nodes, row_dim, node_dim):
    if row_dim is not None:
        a = a[(slice(None),) * row_dim + (rows,)]
    if node_dim is not None:
        a = a[(slice(None),) * node_dim + (nodes,)]
    return np.ascontiguousarray(a)


#: rand / state / params entries: (row dim, node dim)
_RAND_DIMS = {"dur": (0, 1), "leave": (0, 1), "join": (0, 1), "X": (None, 0),
              "mb": (None, 0), "u1": (None, 0)}
_NODE = ("steps", "alive", "computing", "event_time", "ready", "blocked",
         "pulled", "pol_ema", "compute_time", "valid_slot")


def _tick_block(tree, rows, nodes):
    out = {}
    for k, v in tree.items():
        if np.ndim(v) == 0:
            out[k] = v
        elif k == "scores":
            out[k] = (_block(v, rows, nodes, 0, 1) if v.ndim == 3
                      else _block(v, rows, nodes, None, 0))
        elif k in _RAND_DIMS:
            out[k] = _block(v, rows, nodes, *_RAND_DIMS[k])
        else:
            out[k] = _block(v, rows, nodes, 0, 1 if k in _NODE else None)
    return out


def tick_world(problems, meshes):
    """Five chained ticks of each problem on each mesh: this rank's block
    of every output, with its row and node ranges.

    ``problems`` maps a case to (state, rands (one a tick), params,
    leave_n, join_n, kw) in numpy; rows split over the mesh's ``rows``
    as evenly as they go, nodes exactly.
    """
    import torch.distributed as dist
    from repro_torch.convert import tick_inputs_to_torch, to_numpy, to_torch
    from repro_torch.kernels.psp_tick import psp_tick_sharded
    from repro_torch.parallel.sharding import sweep_mesh
    out = {}
    for mesh in meshes:
        if mesh[0] * mesh[1] > dist.get_world_size():
            continue
        dm = sweep_mesh(*mesh)
        coord = dm.get_coordinate()
        if coord is None:
            continue
        node_axis = collectives.mesh_axis(dm, "nodes")
        for case, (state, rands, params, ln, jn, kw) in problems.items():
            B, P = state["steps"].shape
            bounds = np.linspace(0, B, mesh[0] + 1).round().astype(int)
            rows = slice(bounds[coord[0]], bounds[coord[0] + 1])
            pl = P // mesh[1]
            nodes = slice(coord[1] * pl, (coord[1] + 1) * pl)
            s, _, p = tick_inputs_to_torch(_tick_block(state, rows, nodes),
                                           {}, _tick_block(params, rows,
                                                           nodes))
            ticks = []
            for i, rand in enumerate(rands):
                _, r, _ = tick_inputs_to_torch({}, _tick_block(
                    rand, rows, nodes), {})
                s, o = psp_tick_sharded(
                    s, r, p, float(np.float32(0.4 * (i + 1))),
                    to_torch(ln[rows]), to_torch(jn[rows]),
                    node_axis=node_axis, **kw)
                ticks.append((to_numpy(s), to_numpy(o)))
            out[(mesh, case)] = (rows, nodes, ticks)
    return out


# --------------------------------------------------------------------------- #
# the sharded sweep
# --------------------------------------------------------------------------- #
def _fields(results):
    return [{"steps": r.steps, "errors": r.errors,
             "server_updates": r.server_updates,
             "total_updates": r.total_updates,
             "control_messages": r.control_messages} for r in results]


def sweep_world(runs, emulate_kernel=()):
    """``run_sweep`` of each (name, configs, mesh) in ``runs`` on the CPU:
    {name: (results' fields, collective calls, plan mesh)}.  Runs named
    in ``emulate_kernel`` take the kernel path with the CUDA tick swapped
    for a counting plain version that writes ``w``/``pulled`` in place,
    as the kernel does (the gathered path's plumbing, on the CPU); each
    of its launches records the shape of ``steps`` it was given and the
    all_gathers made so far."""
    from repro_torch.core import vector_sim_torch
    from repro_torch.core.vector_sim import VectorSimulator, run_sweep
    from repro_torch.kernels import ops, psp_tick
    out = {}
    for name, cfgs, mesh in runs:
        launches = []
        saved = (ops.psp_tick_cuda, ops.use_kernel,
                 vector_sim_torch.stage_params)
        if name in emulate_kernel:
            def fake(state, rand, params, *a, **kw):
                launches.append((tuple(state["steps"].shape),
                                 collectives.call_counts().get(
                                     "all_gather", 0)))
                new, o = psp_tick.psp_tick_ref(state, rand, params, *a, **kw)
                state["w"].copy_(new["w"])
                state["pulled"].copy_(new["pulled"])
                new.update(w=state["w"], pulled=state["pulled"])
                return new, o
            ops.psp_tick_cuda = fake
            ops.use_kernel = lambda impl, device: impl != "ref"
            vector_sim_torch.stage_params = lambda p, adaptive: p
        collectives.reset_call_counts()
        try:
            res = run_sweep(cfgs, device="cpu", mesh=mesh)
        finally:
            (ops.psp_tick_cuda, ops.use_kernel,
             vector_sim_torch.stage_params) = saved
        plan = vector_sim_torch._plan(VectorSimulator(cfgs), mesh)
        out[name] = (_fields(res), collectives.call_counts(), plan.mesh,
                     launches)
    return out


# --------------------------------------------------------------------------- #
# expert-parallel MoE
# --------------------------------------------------------------------------- #
def moe_world(cfg, cases, model_tree, tokens, replay):
    """Expert-parallel MoE on a (data 1, model n) mesh.

    ``cases`` maps a name to (x, p): each gives ``moe_apply``'s y and aux
    and this rank's (token, choice) kept mask and routed experts.
    ``model_tree`` (numpy) is a whole model run by ``prefill`` on
    ``tokens`` under the mesh's rules with this rank's experts only,
    replaying the experts ``replay`` (one-device routing, per call).
    """
    import torch.distributed as dist
    from repro_torch.convert import expert_slice
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model, prefill
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_rules, use_rules
    n = dist.get_world_size()
    mesh = make_host_mesh(1, n)
    rules = make_rules(cfg, None, mesh)
    rank = collectives.axis_index(collectives.mesh_axis(mesh, "model"))
    e_loc = cfg.n_experts // n
    out = {"rank": rank}
    for name, (x, p) in cases.items():
        xt = torch.from_numpy(x)
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        mine = expert_slice(pt, cfg, rules)
        y, aux = moe.moe_apply(mine, xt, cfg, mesh=mesh)
        y_full, aux_full = moe.moe_apply(pt, xt, cfg, mesh=mesh)
        flat = xt.reshape(-1, xt.shape[-1])
        _, top_i, _ = moe.route(flat, pt["router"], cfg)
        _, _, ok = moe.dispatch(flat, top_i, moe.capacity(flat.shape[0], cfg),
                                cfg.n_experts, rank * e_loc, e_loc)
        out[name] = {"experts": {k: mine[k].numpy() for k in
                                 ("w_gate", "w_up", "w_down")},
                     "y": y.numpy(), "aux": float(aux),
                     "y_full_leaves": y_full.numpy(),
                     "aux_full_leaves": float(aux_full),
                     "ok": ok.numpy(), "top_i": top_i.numpy()}
    # gradients through the expert-parallel sum: this rank's experts'
    # gradients are its slice of the one-device gradients
    x, p = cases["drops"]
    pt = {k: v.detach().requires_grad_(True) for k, v in expert_slice(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg, rules).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(pt, xt, cfg, mesh=mesh)
    (y.square().sum() + aux).backward()
    out["grads"] = {k: v.grad.numpy() for k, v in pt.items()}
    out["grad_x"] = xt.grad.numpy()
    tree = expert_slice(_tensors(model_tree), cfg, rules)
    model = Model(cfg, tree)
    with use_rules(rules):
        with moe.routing([torch.from_numpy(r) for r in replay]) as seen:
            logits, _ = prefill(model, torch.from_numpy(tokens))
    out["logits"] = logits.numpy()
    out["seen"] = [s.numpy() for s in seen]
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


# --------------------------------------------------------------------------- #
# the distributed PSP trainer
# --------------------------------------------------------------------------- #
CONTROL_FIELDS = ("step", "busy_until", "pushed", "now", "slow", "tick",
                  "total_pushes", "alive", "leave_cursor", "join_cursor")


def psp_state(st):
    """A PSP state's fields that the tests compare, in numpy."""
    out = {f: _np(getattr(st, f)) for f in CONTROL_FIELDS}
    out.update(server=_np(st.server_params), opt=_np(st.opt_state),
               views=_np(st.views), policy=_np(st.policy))
    return out


def run_psp(task, psp_kw, records, batches, ticks, mesh=None):
    """``ticks`` PSP ticks of ``task`` (``linear`` or a reduced model
    config) on replayed noise ``records`` = (init, [tick, …]) and the
    per-tick worker batches: (final state fields, metrics per tick)."""
    from repro_torch.core import spmd_psp as sp
    from repro_torch.launch.steps import make_psp_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adamw, warmup_cosine
    cfg = sp.PSPConfig(**psp_kw)
    noise = sp.ReplayNoise(_tensors(records[0]),
                           [_tensors(r) for r in records[1]])
    if task == "linear":
        _, grad_fn, opt_update = sp.linear_psp_task(8, seed=0)
        st = sp.linear_psp_state(cfg, 8, noise, mesh=mesh)
        step = sp.make_psp_step_fn(cfg, grad_fn, opt_update, noise, mesh)
        feed = lambda b: tuple(torch.from_numpy(a) for a in b)  # noqa: E731
    else:
        opt = adamw(warmup_cosine(3e-3, 2, 10))
        st = sp.psp_init(cfg, init_model(task, seed=0).tree(), opt.init,
                         noise, mesh=mesh)
        step = make_psp_train_step(task, cfg, opt, noise, mesh=mesh)
        feed = torch.from_numpy
    metrics = []
    for t in range(ticks):
        st, m = step(st, feed(batches[t]))
        metrics.append(_np(m))
    return psp_state(st), metrics


def psp_world(runs):
    """:func:`run_psp` of each named run on a (data n, model 1) mesh:
    {name: (state fields (this rank's views), metrics, worker slice)}."""
    import torch.distributed as dist
    from repro_torch.core.spmd_psp import PSPConfig, local_workers
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(dist.get_world_size(), 1)
    out = {}
    for name, (task, psp_kw, records, batches, ticks) in runs.items():
        collectives.reset_call_counts()
        st, m = run_psp(task, psp_kw, records, batches, ticks, mesh)
        out[name] = (st, m, local_workers(PSPConfig(**psp_kw), mesh),
                     collectives.call_counts())
    return out


# --------------------------------------------------------------------------- #
# the reference on forced host devices
# --------------------------------------------------------------------------- #
class Reference:
    """``tests/_jax_mesh_ref.py`` on ``n`` forced host devices, started
    at once in a subprocess of its own (so that the test process, whose
    jax has one device, is untouched) while the caller spawns its
    ranks; :meth:`result` waits for its answer within ``wall``
    seconds."""

    def __init__(self, n: int, jobs: dict, wall: float = 240.0):
        here = os.path.dirname(os.path.abspath(__file__))
        self.dir = tempfile.mkdtemp(prefix="psp_jax_ref_")
        req = os.path.join(self.dir, "request.pkl")
        self.ans = os.path.join(self.dir, "answer.pkl")
        with open(req, "wb") as f:
            pickle.dump(jobs, f)
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(here), "src")
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "_jax_mesh_ref.py"), str(n),
             req, self.ans], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.deadline = time.monotonic() + wall

    def result(self) -> dict:
        """The answer; raises if the subprocess failed or ran out of
        time (and then stops it)."""
        try:
            log, _ = self.proc.communicate(
                timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        if self.proc.returncode:
            raise RuntimeError(f"the reference failed:\n{log[-4000:]}")
        with open(self.ans, "rb") as f:
            return pickle.load(f)
