"""The port's optimizers and schedules (``repro_torch.optim``) against
the reference's (``repro.optim``) on random trees.

Trees of float32 parameters and gradients are drawn with numpy and fed
to both; several chained updates (moments carried) must agree within
rtol / atol 1e-6 (float32 elementwise arithmetic; ``pow`` and ``sqrt``
may round differently in the last bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}


def _tree(rng, scale=1.0):
    def one(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"a": one(SHAPES["a"]),
            "b": {"c": one(SHAPES["b"]["c"]), "d": one(SHAPES["b"]["d"])}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(torch.from_numpy, tree) if isinstance(tree, dict) \
        else torch.from_numpy(tree)


def _close(got, want, what):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what,
                                   **TOL)


def _schedules(mod):
    return {"const": 3e-3, "constant": mod.constant(0.01),
            "cosine": mod.cosine(0.05, 7),
            "warmup_cosine": mod.warmup_cosine(3e-3, 2, 7)}


@pytest.mark.parametrize("sched", ["const", "constant", "cosine",
                                   "warmup_cosine"])
@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {"beta": 0.8}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1, "b2": 0.99})])
def test_optimizer_matches_reference(name, kw, sched):
    rng = np.random.default_rng(len(name) + len(kw))
    params = _tree(rng)
    jo = getattr(jopt, name)(_schedules(jopt)[sched], **kw)
    to = getattr(topt, name)(_schedules(topt)[sched], **kw)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        g = _tree(rng, scale=0.1 * (i + 1))
        ju, js = jo.update(_j(g), js, jp)
        tu, ts = to.update(_t(g), ts, tp)
        _close(tu, ju, f"{name} updates, step {i}")
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _close(tp, jp, f"{name} params, step {i}")
    assert int(ts["step"]) == int(js["step"]) == 5
    for k in ("mu", "nu"):
        if k in js:
            _close(ts[k], js[k], f"{name} {k}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_global_norm_match_reference(max_norm):
    g = _tree(np.random.default_rng(3))
    np.testing.assert_allclose(float(topt.global_norm(_t(g))),
                               float(jopt.global_norm(_j(g))), **TOL)
    _close(topt.clip_by_norm(_t(g), max_norm),
           jopt.clip_by_norm(_j(g), max_norm), "clip_by_norm")


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(sched):
    jf, tf = _schedules(jopt)[sched], _schedules(topt)[sched]
    for s in range(10):
        np.testing.assert_allclose(
            float(tf(torch.tensor(s, dtype=torch.int32))),
            float(jf(jnp.asarray(s, jnp.int32))), **TOL)
