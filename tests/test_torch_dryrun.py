"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs
against the reference's.

* For every registered config × input shape, on the reference's
  single-pod mesh, its two-pod mesh and one device: the leaves of
  ``dryrun_inputs`` (parameters, AdamW state and batch, or parameters,
  cache and batch) equal ``repro.launch.steps.dryrun_inputs``' in
  structure, shapes, dtypes and per-device bytes (the reference's
  ``NamedSharding.shard_shape`` on a ``jax.sharding.AbstractMesh``);
  the donated arguments are the reference's.
* ``tree_size_bytes``, ``model_flops`` (recurrentgemma-2b's
  ``param_count`` under-count included) and ``should_skip`` over all 40
  combos equal the reference's.
* ``run_combo`` / ``run_psp_combo`` on ``card`` at a reduced config
  write coherent records, which the roofline bench's ``table`` and
  ``print_table`` read.

``repro.launch.dryrun`` itself is never imported: at import it forces
512 host devices through ``XLA_FLAGS``, which would leak into every
later test file of the same process.
"""
import dataclasses
import json
import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import LONG_CONTEXT_ARCHS as JLONG  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model_defs as jmodel_defs  # noqa: E402
from repro.models.params import tree_size_bytes as jtree_size  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.roofline.analysis import model_flops as jmodel_flops  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro_torch.bench import roofline_bench  # noqa: E402
from repro_torch.configs import (ARCHS, INPUT_SHAPES, get_config,  # noqa: E402
                                 reduced)
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model_defs  # noqa: E402
from repro_torch.models.params import (per_device_bytes,  # noqa: E402
                                       tree_size_bytes)
from repro_torch.parallel.sharding import make_rules  # noqa: E402
from repro_torch.roofline import model_flops  # noqa: E402

from test_torch_sharding import port_paths, to_ref_path  # noqa: E402

COMBOS = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES]
#: the reference's meshes as AbstractMesh, by the port's mesh kind
JMESH = {"single": ((16, 16), ("data", "model")),
         "multi": ((2, 16, 16), ("pod", "data", "model")), "card": None}


def ref_leaves(tree):
    """{path: (shape, dtype name, per-device bytes)} of the reference's
    ShapeDtypeStruct tree."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(str(getattr(p, "key", getattr(p, "idx", None)))
                    for p in path)
        shard = (s.sharding.shard_shape(s.shape) if s.sharding is not None
                 else s.shape)
        out[key] = (tuple(s.shape), str(s.dtype),
                    math.prod(shard) * s.dtype.itemsize)
    return out


def port_ref_path(cfg, path):
    """The reference's path of a port input leaf (arg index first)."""
    if "layers" not in path:
        return path, False
    i = path.index("layers")
    rpath, stacked = to_ref_path(cfg, path[i:],
                                 cache=path[:2] == ("1", "layers"))
    return path[:i] + rpath, stacked


@pytest.mark.parametrize("mesh", list(JMESH))
@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_inputs_match_reference(arch, shape_name, mesh):
    """dryrun_inputs' leaves: structure, shapes, dtypes, per-device
    bytes and donation equal the reference's."""
    cfg, jcfg = get_config(arch), jget(arch)
    shape, jshape = INPUT_SHAPES[shape_name], JSHAPES[shape_name]
    jm = AbstractMesh(*JMESH[mesh]) if JMESH[mesh] else None
    rules = make_rules(cfg, shape, make_mesh(mesh))
    jrules = jsh.make_rules(jcfg, jshape, jm)
    args, step, donate = steps.dryrun_inputs(cfg, shape, rules)
    with jsh.use_rules(jrules):
        jargs, _, jdonate = jsteps.dryrun_inputs(jcfg, jshape, jrules)
    assert donate == jdonate
    assert len(args) == len(jargs)
    ref = ref_leaves(jargs)
    seen = {}
    for path, a in port_paths(list(args)):
        rpath, stacked = port_ref_path(cfg, path)
        assert rpath in ref, (path, rpath)
        rshape, rdtype, rbytes = ref[rpath]
        n = cfg.n_groups if stacked else 1
        if stacked:
            assert rshape[0] == n
            rshape = rshape[1:]
        assert a.shape == rshape, path
        assert str(a.dtype).split(".")[-1] == rdtype, path
        assert a.shard_bytes * n == rbytes, (path, a, rbytes)
        seen[rpath] = seen.get(rpath, 0) + 1
    assert seen == {p: (cfg.n_groups if "groups" in p else 1) for p in ref}
    assert per_device_bytes(args) == sum(b for _, _, b in ref.values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sizes_and_model_flops(arch):
    """tree_size_bytes and model_flops equal the reference's (its
    param_count, which under-counts an rglru layer, included)."""
    cfg, jcfg = get_config(arch), jget(arch)
    for b in (1, 2, 4):
        assert tree_size_bytes(model_defs(cfg), b) == jtree_size(
            jmodel_defs(jcfg), b)
    for name in INPUT_SHAPES:
        assert model_flops(cfg, INPUT_SHAPES[name]) == jmodel_flops(
            jcfg, JSHAPES[name])
    if arch == "recurrentgemma-2b":
        assert cfg.param_count(active_only=True) == 1_596_912_640
        assert tree_size_bytes(model_defs(cfg), 1) == 2_682_237_440


def test_should_skip_over_all_combos():
    """The 6 long_500k combos of pure full-attention archs are skipped,
    as the reference's ``should_skip`` (restated here: its module
    cannot be imported) skips them."""
    skipped = [(a, s) for a, s in COMBOS if dryrun.should_skip(a, s)]
    want = [(a, s) for a, s in COMBOS
            if s == "long_500k" and a not in JLONG]
    assert skipped == want and len(skipped) == 6 and len(COMBOS) == 40


def small(arch):
    """A reduced config under the registered name (d_model 128)."""
    return reduced(get_config(arch), d_model=128)


@pytest.fixture
def reduced_archs(monkeypatch):
    """The dry run's configs, reduced (d_model 128), by name."""
    cfgs = {a: small(a) for a in ARCHS}
    monkeypatch.setattr(dryrun, "get_config", lambda a: cfgs[a])
    return cfgs


def test_run_combo_card_records(tmp_path, reduced_archs):
    """run_combo on card at a reduced config: a coherent record with a
    roofline; single writes specs and no roofline; the skip record; the
    roofline bench's table reads them."""
    out = str(tmp_path)
    for arch, shape in (("qwen2-0.5b", "prefill_32k"),
                        ("mamba2-780m", "decode_32k")):
        rec = dryrun.run_combo(arch, shape, "card", out, verbose=False)
        assert rec["status"] == "ok", rec.get("error")
        rf = rec["roofline"]
        assert rf["bottleneck"] in ("compute", "memory", "collective")
        assert rec["cost"]["flops"] > 0 and rf["collective_s"] == 0.0
        assert 0 < rf["useful_ratio"] <= 1.5
        assert (rec["cost"]["bytes_accessed"]
                <= rec["cost"]["bytes_accessed_naive"])
        assert rec["memory"]["temp_bytes"] is None
        assert rec["memory"]["argument_bytes"] > 0
        assert json.load(open(tmp_path / f"{arch}__{shape}__card.json")
                         ) == rec
    k = rec["kernels"]
    assert k["rmsnorm"]["calls"] == 2 * small("mamba2-780m").n_layers + 1
    rec = dryrun.run_combo("qwen2-0.5b", "train_4k", "single", out,
                           verbose=False)
    assert rec["roofline"] is None and rec["reason"]
    assert rec["specs"]["0/embed"]["spec"] == [["model"], ["data"]]
    rec = dryrun.run_combo("qwen2-0.5b", "long_500k", "card", out,
                           verbose=False)
    assert rec["status"] == "skipped"
    rows = roofline_bench.table("card", out)
    assert [r["status"] for r in rows] == ["ok", "skipped", "ok"]
    counts = roofline_bench.print_table("card", out)
    assert sum(counts.values()) == 2


def test_bench_roofline_step(tmp_path, monkeypatch, reduced_archs):
    """bench.run's roofline step (``--only roofline``): the dry run's
    card rows and the sweep tick's row in roofline.json."""
    from repro_torch.bench import run as trun
    out = tmp_path / "dry"
    dryrun.run_combo("qwen2-0.5b", "prefill_32k", "card", str(out),
                     verbose=False)
    monkeypatch.setattr(roofline_bench, "RESULTS", str(out))
    tick = roofline_bench.sweep_tick_row
    monkeypatch.setattr(roofline_bench, "sweep_tick_row",
                        lambda device: tick(n_nodes=8, dim=2, rows=1,
                                            device=device))
    trun.main(["--only", "roofline", "--device", "cpu", "--out-dir",
               str(tmp_path)])
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert [r["arch"] for r in rows] == ["qwen2-0.5b", "sweep_tick"]
    assert rows[1]["useful_ratio"] is None


def test_run_psp_combo_card(tmp_path, reduced_archs):
    """One PSP tick (W 2) counted on card at a reduced config: the
    workers' gradients charge the flash and RMSNorm backward formulas W
    times; single records its per-device bytes only."""
    reduced_archs["qwen2-0.5b"] = dataclasses.replace(
        reduced_archs["qwen2-0.5b"], n_layers=1)
    rec = dryrun.run_psp_combo("qwen2-0.5b", "card", str(tmp_path),
                               workers=2, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["workers"] == 2 and rec["roofline"]["bottleneck"]
    assert rec["kernels"]["flash_attention_bwd"]["calls"] == 2
    assert rec["kernels"]["rmsnorm_bwd"]["calls"] == 2 * 3
    rec = dryrun.run_psp_combo("qwen2-0.5b", "single", str(tmp_path),
                               verbose=False)
    assert rec["workers"] == 16 and rec["roofline"] is None
    assert rec["specs"]["0/views/embed"]["spec"][0] == ["data"]
    assert dryrun.main(["--psp", "--mesh", "single", "--out",
                        str(tmp_path)]) == 0
