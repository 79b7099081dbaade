"""The reference on a mesh of forced host devices, for the port's tests.

Run as a script (never imported into a test process): it sets
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` before jax is
imported, so the reference sees N CPU devices, as its own sharded tests
do under the flag.  It also caps XLA's CPU code at SSE4.2
(``--xla_cpu_max_isa=SSE4_2``): without FMA instructions jitted code
cannot contract ``t0 + base·(1 + (u − ½))`` into one fused multiply-add,
so the jitted tick rounds every operation as the eager reference (and
the port) do, at a fraction of the eager tick's time (about 12 s a tick
under ``shard_map``).  It reads a pickled request and writes a pickled
answer:

    python tests/_jax_mesh_ref.py N REQUEST.pkl ANSWER.pkl

A request is a dict of jobs, each of one kind:

* ``("plan", cases)`` — ``repro.core.sweep_plan.plan_sweep`` of each
  (args, kwargs, available) with ``jax.devices`` cut to ``available``:
  the plan's fields;
* ``("tick", problems)`` — five chained ticks of
  ``repro.kernels.psp_tick.psp_tick_sharded`` under a jitted
  ``shard_map`` on ``sweep_mesh(1, N)``, per problem: the whole state
  and outputs after each tick;
* ``("moe", cases)`` — ``repro.models.moe.moe_apply(p, x, cfg,
  mesh=make_host_mesh(1, n))`` per (name, n), jitted inside that mesh
  (``jax.set_mesh``: its axes are explicit, and eagerly its ``shard_map``
  body cannot index): y, aux, and each model shard's kept (token,
  choice) pairs by the reference's dispatch lines.
"""
import os
import pickle
import sys

N = int(sys.argv[1])
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           f" --xla_force_host_platform_device_count={N}"
                           " --xla_cpu_max_isa=SSE4_2")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def plan(cases):
    from repro.core import sweep_plan
    every = jax.devices()
    out = []
    for args, kwargs, avail in cases:
        jax.devices = lambda *a, _d=every[:avail]: _d
        try:
            p = sweep_plan.plan_sweep(*args, **kwargs)
        finally:
            jax.devices = lambda *a, _d=every: _d
        out.append(dataclasses.asdict(p))
    return out


_NODE = ("steps", "alive", "computing", "event_time", "ready", "blocked",
         "pulled", "pol_ema", "compute_time", "valid_slot", "dur", "leave",
         "join")


def _spec(k, v):
    if np.ndim(v) == 0:
        return P()
    if k in ("X", "mb", "u1") or (k == "scores" and np.ndim(v) == 2):
        return P(*(("nodes",) + (None,) * (np.ndim(v) - 1)))
    if k in _NODE or k == "scores":
        return P(*((None, "nodes") + (None,) * (np.ndim(v) - 2)))
    return P()


def tick(problems):
    from repro.kernels.psp_tick import psp_tick_sharded
    from repro.parallel.sharding import sweep_mesh
    mesh = sweep_mesh(1, N)
    out = {}
    for case, (state, rands, params, ln, jn, kw) in problems.items():
        s = {k: jnp.asarray(v) for k, v in state.items()}
        p = {k: jnp.asarray(v) for k, v in params.items()}
        ticks = []
        for i, rand in enumerate(rands):
            r = {k: jnp.asarray(v) for k, v in rand.items()}
            t = jnp.float32(0.4 * (i + 1))

            def body(s, r, p, t, ln, jn):
                return psp_tick_sharded(s, r, p, t, ln, jn,
                                        node_axis="nodes", **kw)

            s_spec = {k: _spec(k, v) for k, v in s.items()}
            out_spec = (s_spec, {"fin": P(None, "nodes"),
                                 "start": P(None, "nodes"),
                                 "n_fin": P(), "ctrl": P()})
            f = shard_map(body, mesh=mesh, in_specs=(
                s_spec, {k: _spec(k, v) for k, v in r.items()},
                {k: _spec(k, v) for k, v in p.items()}, P(), P(), P()),
                out_specs=out_spec, check_rep=False)
            s, o = jax.jit(f)(s, r, p, t, jnp.asarray(ln), jnp.asarray(jn))
            ticks.append((jax.tree.map(np.asarray, s),
                          jax.tree.map(np.asarray, o)))
        out[case] = ticks
    return out


def _kept(x, router, cfg, n):
    """Each model shard's kept (token, choice) pairs: the reference's
    ``_moe_core`` dispatch lines, at its shard's first expert."""
    from repro.models.moe import _capacity
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.n_experts_per_token
    logits = (x @ router.astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    cap = _capacity(T, cfg)
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    group_start = jnp.searchsorted(se, jnp.arange(E))
    pos = jnp.arange(T * k) - group_start[se]
    shards = []
    for r in range(n):
        e_loc = E // n
        loc = se - r * e_loc
        ok = (loc >= 0) & (loc < e_loc) & (pos < cap)
        back = np.zeros(T * k, bool)
        back[np.asarray(order)] = np.asarray(ok)
        shards.append(back.reshape(T, k))
    return np.asarray(top_i), shards


def moe(cases):
    from repro.configs import get_config, reduced
    from repro.launch.mesh import make_host_mesh
    from repro.models.moe import moe_apply
    out = {}
    for (name, n), (arch, changes, x, p) in cases.items():
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        mesh = make_host_mesh(1, n)
        with jax.set_mesh(mesh):
            y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg, mesh=mesh))(
                pj, jnp.asarray(x))
        top_i, kept = _kept(jnp.asarray(x.reshape(-1, x.shape[-1])),
                            pj["router"], cfg, n)
        out[(name, n)] = {"y": np.asarray(y), "aux": float(aux),
                          "top_i": top_i, "kept": kept}
    return out


def main():
    with open(sys.argv[2], "rb") as f:
        jobs = pickle.load(f)
    kinds = {"plan": plan, "tick": tick, "moe": moe}
    answer = {name: kinds[kind](arg) for name, (kind, arg) in jobs.items()}
    with open(sys.argv[3], "wb") as f:
        pickle.dump(answer, f)


if __name__ == "__main__":
    main()
