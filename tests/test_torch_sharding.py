"""The port's logical-axis rules (``repro_torch.parallel.sharding``) and
abstract meshes (``repro_torch.launch.mesh``) against the reference's.

For every registered config × input shape × mesh, every parameter,
cache and batch leaf gets the same spec and per-device shape as the
reference's ``make_rules`` on a ``jax.sharding.AbstractMesh`` with
``NamedSharding.shard_shape`` (no device behind either mesh).  The
reference stacks the layers of each pattern position along a leading
``layers`` axis (replicated); the port keeps one tree per layer, so a
port leaf of layer ``l`` is held to slice ``l // len(pattern)`` of the
reference's stacked leaf.  The cases of ``tests/test_sharding.py`` run
here as cases of one parametrised test.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.synthetic import make_batch_specs as jbatch  # noqa: E402
from repro.models import cache_defs as jcache_defs  # noqa: E402
from repro.models import model_defs as jmodel_defs  # noqa: E402
from repro.models.params import ParamDef as JParamDef  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.data.synthetic import make_batch_specs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import cache_defs, model_defs  # noqa: E402
from repro_torch.models.params import (ParamDef, abstract_params,  # noqa: E402
                                       spec_tree)
from repro_torch.parallel import sharding as tsh  # noqa: E402

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "small": {"data": 2, "model": 4},
    "small_pod": {"pod": 2, "data": 2, "model": 2},
    "none": None,
}

#: the cache subtree the reference nests a block's cache under
CACHE_KEY = {"attn": "attn", "local": "attn", "moe": "attn", "ssd": "ssd",
             "rglru": "rglru"}


def meshes(name):
    """(the port's abstract mesh, the reference's AbstractMesh) or
    (None, None)."""
    shape = MESHES[name]
    if shape is None:
        return None, None
    return (tmesh.AbstractMesh(tuple(shape), tuple(shape.values())),
            AbstractMesh(tuple(shape.values()), tuple(shape)))


def norm_spec(spec, ndim):
    """A jax PartitionSpec as the port's tuple form, padded to ``ndim``."""
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def ref_leaves(defs, rules, jm, prefix=()):
    """{path: (shape, spec, shard shape)} of the reference's ParamDef
    tree under ``rules`` on the AbstractMesh ``jm`` (None: no mesh)."""
    out = {}
    for path, d in jax.tree_util.tree_leaves_with_path(
            defs, is_leaf=lambda x: isinstance(x, JParamDef)):
        key = prefix + tuple(getattr(p, "key", getattr(p, "idx", None))
                             for p in path)
        spec = norm_spec(rules.spec(d.axes, d.shape), len(d.shape))
        shard = (tuple(NamedSharding(jm, rules.spec(d.axes, d.shape))
                       .shard_shape(d.shape)) if jm is not None
                 else tuple(d.shape))
        out[tuple(str(k) for k in key)] = (tuple(d.shape), spec, shard)
    return out


def port_paths(tree, prefix=()):
    """(path, leaf) of the port's tree (dicts and lists)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from port_paths(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from port_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def to_ref_path(cfg, path, cache=False):
    """The reference's path of a port leaf, and whether it is stacked:
    ``layers/l/...`` → ``groups/j/...`` (slice l // len(pattern)) or
    ``tail/j/...``; a cache block's leaves under its kind's key."""
    if path[0] != "layers":
        return path, False
    l = int(path[1])
    n_pat = len(cfg.layer_pattern)
    rest = path[2:]
    if cache:
        rest = (CACHE_KEY[cfg.layer_kinds()[l]],) + rest
    if l < cfg.n_groups * n_pat:
        return ("groups", str(l % n_pat)) + rest, True
    return ("tail", str(l - cfg.n_groups * n_pat)) + rest, False


def check_tree(cfg, port_tree, ref, cache=False):
    """Every port leaf (an Abstract record) equals its reference leaf in
    shape, spec and shard shape (stacked: behind the replicated layers
    axis); every reference leaf is reached, a stacked one n_groups
    times."""
    seen = {}
    for path, a in port_paths(port_tree):
        rpath, stacked = to_ref_path(cfg, path, cache)
        assert rpath in ref, (path, rpath)
        shape, spec, shard = ref[rpath]
        if stacked:
            assert (shape[0], spec[0], shard[0]) == (
                cfg.n_groups, None, cfg.n_groups), rpath
            shape, spec, shard = shape[1:], spec[1:], shard[1:]
        assert (a.shape, tuple(a.spec), tuple(a.shard)) == (
            shape, spec, shard), (path, a, ref[rpath])
        seen[rpath] = seen.get(rpath, 0) + 1
    for rpath in ref:
        n = cfg.n_groups if rpath[0] == "groups" else 1
        assert seen.get(rpath) == n, (rpath, seen.get(rpath))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_match_reference(arch, shape_name, mesh):
    """Parameter, cache and batch specs and shard shapes equal the
    reference's for this config, input shape and mesh."""
    cfg, jcfg = get_config(arch), jget(arch)
    shape, jshape = INPUT_SHAPES[shape_name], JSHAPES[shape_name]
    tm, jm = meshes(mesh)
    rules = tsh.make_rules(cfg, shape, tm)
    jrules = jsh.make_rules(jcfg, jshape, jm)
    assert rules.table == jrules.table

    params = abstract_params(model_defs(cfg), rules=rules)
    check_tree(cfg, params, ref_leaves(jmodel_defs(jcfg), jrules, jm))
    assert dict(port_paths(spec_tree(model_defs(cfg), rules))) == {
        p: a.spec for p, a in port_paths(params)}
    B, S = shape.global_batch, shape.seq_len
    check_tree(cfg, abstract_params(cache_defs(cfg, B, S), rules=rules),
               ref_leaves(jcache_defs(jcfg, B, S), jrules, jm), cache=True)
    for kind in ("train", "decode"):
        got = make_batch_specs(cfg, shape, rules, kind=kind)
        want = jbatch(jcfg, jshape, jrules if jm is not None else None,
                      kind=kind)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].shape == tuple(s.shape)
            assert str(got[k].dtype).split(".")[-1] == str(s.dtype)
            if jm is not None:
                assert tuple(got[k].shard) == tuple(
                    s.sharding.shard_shape(s.shape)), k


class FakeMesh:
    """Duck-typed mesh: ``.shape`` mapping + ``.axis_names``, as
    ``tests/test_sharding.py``'s."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


SINGLE = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}

#: tests/test_sharding.py's cases: (arch, shape, mesh, logical axes,
#: dims, expected spec in the port's form)
RULE_CASES = {
    "weight_mlp": ("gemma2-27b", "train_4k", SINGLE,
                   ("d_model_w", "d_ff_w"), (4608, 36864),
                   (("data",), ("model",))),
    "weight_embed": ("gemma2-27b", "train_4k", SINGLE,
                     ("vocab_w", "d_model_w"), (256000, 4608),
                     (("model",), ("data",))),
    "kv2_replicated": ("qwen2-0.5b", "train_4k", SINGLE,
                       ("d_model_w", "kv_heads_w", None), (896, 2, 64),
                       (("data",), None, None)),
    "heads14_replicated": ("qwen2-0.5b", "train_4k", SINGLE,
                           ("d_model_w", "heads_w", None), (896, 14, 64),
                           (("data",), None, None)),
    "padded_heads_shard": ("qwen2-0.5b", "train_4k", SINGLE,
                           ("attn_batch", "qseq", "heads", None),
                           (256, 4096, 16, 64),
                           (("data",), None, ("model",), None)),
    "axis_used_once": ("gemma2-27b", "train_4k", SINGLE,
                       ("batch", "d_model_w"), (256, 4608),
                       (("data",), None)),
    "decode_cache": ("qwen3-moe-30b-a3b", "decode_32k", SINGLE,
                     ("cache_batch", "cache_seq", "kv_heads", None),
                     (128, 32768, 4, 128),
                     (("data",), ("model",), None, None)),
    "long_cache_spread": ("mamba2-780m", "long_500k", SINGLE,
                          ("cache_batch", "cache_seq", "kv_heads", None),
                          (1, 524288, 1, 64),
                          (None, ("data", "model"), None, None)),
    "multi_pod_batch": ("gemma2-27b", "train_4k", POD,
                        ("batch", "seq", None), (256, 4096, 4608),
                        (("pod", "data"), None, None)),
}


@pytest.mark.parametrize("case", list(RULE_CASES) + ["no_mesh_is_noop"])
def test_sharding_cases(case):
    """``tests/test_sharding.py``'s cases on the port's rules (a fake
    mesh with no devices), each also equal to the reference's spec."""
    if case == "no_mesh_is_noop":
        r = tsh.AxisRules({"batch": ("data",)}, None)
        assert r.spec(("batch",), (8,)) == (None,)
        assert tsh.spec_for(("batch",), (8,)) == ()
        with tsh.use_rules(r):
            assert tsh.current_rules() is r
            assert tsh.spec_for(("batch",), (8,)) == (None,)
        assert tsh.current_rules() is None
        return
    arch, shape, mesh, axes, dims, want = RULE_CASES[case]
    r = tsh.make_rules(get_config(arch), INPUT_SHAPES[shape],
                       FakeMesh(mesh))
    assert r.spec(axes, dims) == want
    jr = jsh.make_rules(jget(arch), JSHAPES[shape], FakeMesh(mesh))
    assert norm_spec(jr.spec(axes, dims), len(dims)) == want


def test_vocabulary_and_meshes():
    """The shared axis names, ``psp_worker_axes`` and the production
    meshes equal the reference's; ``card`` is no mesh."""
    assert (tsh.SWEEP_ROWS_AXIS, tsh.SWEEP_NODES_AXIS,
            tsh.PSP_WORKER_AXES) == (jsh.SWEEP_ROWS_AXIS,
                                     jsh.SWEEP_NODES_AXIS,
                                     jsh.PSP_WORKER_AXES)
    for multi in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        assert m.sizes == shape and m.size == int(np.prod(shape))
        jm = AbstractMesh(shape, m.axis_names)
        assert tsh.psp_worker_axes(m) == jsh.psp_worker_axes(jm)
    assert tmesh.make_mesh("single") == tmesh.make_production_mesh()
    assert tmesh.make_mesh("card") is None
    assert tsh.psp_worker_axes(None) == ()
    with pytest.raises(ValueError):
        tmesh.make_mesh("pod")
    with pytest.raises(ValueError):
        tsh.shard_shape((("data",),), (3,), tmesh.make_production_mesh())
    d = ParamDef((8, 4), ("batch", None))
    rules = tsh.make_rules(get_config("qwen2-0.5b"), INPUT_SHAPES["train_4k"],
                           tmesh.AbstractMesh(("data",), (4,)))
    assert abstract_params({"x": d}, rules=rules)["x"].shard == (2, 4)
