"""Dry run: every (arch × input shape × mesh) combination's inputs, their
per-device bytes under the sharding rules, and on one card the step's
work against the H100's roofline, without allocating anything.

The port's counterpart of :mod:`repro.launch.dryrun`, which lowers and
compiles each combination for the TPU production mesh.  Here:

* ``single`` / ``multi`` (the reference's (data 16, model 16) and (pod
  2, data 16, model 16) meshes, :mod:`repro_torch.launch.mesh`): the
  step's inputs as records, each leaf's spec and per-device shape under
  :func:`~repro_torch.parallel.sharding.make_rules`, and the per-device
  argument bytes.  ``roofline`` is null, with a ``reason``: the port does
  not partition a step (GSPMD's partitioning has no counterpart yet), and
  a global count divided by the chips would not be a per-device one.
* ``card`` (one H100, no mesh): the whole step run once on ``meta``
  tensors with ``impl="ref"`` under
  :class:`~repro_torch.roofline.dispatch_cost.DispatchCost` (the kernels
  charged by formula at their boundary), the three-term roofline against
  :class:`~repro_torch.roofline.analysis.HW`, ``model_flops`` and
  ``useful_ratio``, argument and output bytes and whether they fit the
  card's HBM.  ``temp_bytes`` is null: meta tensors show no temporaries
  (``chip_smoke.py`` phase 20 measures a real step's peak).  With
  ``cfg.remat`` the recomputed blocks are counted, as the reference's
  HLO count counts them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen2-0.5b --shape train_4k --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh single,multi,card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --psp --mesh card

Each combo writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(the reference's record layout and key names where the field exists);
an existing file is kept unless ``--force``.  The dry run needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs import (ARCHS, INPUT_SHAPES, LONG_CONTEXT_ARCHS,
                                 get_config)
from repro_torch.launch.mesh import MESH_KINDS, make_mesh
from repro_torch.launch.steps import (abstract_opt_state, dryrun_inputs,
                                      make_psp_train_step, meta_inputs)
from repro_torch.models import model_defs
from repro_torch.models.params import (Abstract, ParamDef, abstract,
                                       abstract_params, map_defs,
                                       per_device_bytes, to_meta,
                                       tree_size_bytes)
from repro_torch.parallel.sharding import (make_rules, psp_worker_axes,
                                           use_rules)
from repro_torch.roofline.analysis import HW, model_flops, roofline_report
from repro_torch.roofline.dispatch_cost import DispatchCost

__all__ = ["OUT_DIR", "PSP_WORKERS", "count_step", "main", "run_combo",
           "run_psp_combo", "should_skip", "tensor_bytes"]

OUT_DIR = str(Path(__file__).resolve().parents[3] / "results"
              / "dryrun_torch")

#: PSP workers by mesh kind: the reference's one per (pod × data) row on
#: its meshes; on one card the W that ``chip_smoke.py`` phase 8 trains
PSP_WORKERS = {"single": 16, "multi": 32, "card": 4}

_NO_PARTITION = ("the port does not count a step at its per-device shard "
                 "shapes with each collective charged (ROADMAP item 15c), "
                 "so there is no per-device count; a global count "
                 "divided by the chips would not be one")


def should_skip(arch: str, shape_name: str) -> bool:
    """Whether the combo is skipped: long_500k on a pure full-attention
    arch, as the reference skips it."""
    return shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a tree of records, dict keys and list indices
    joined by ``/``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _specs(tree: Any) -> Dict[str, dict]:
    """Each record's spec and per-device shape, by path."""
    return {path: {"spec": [list(a) if a else None for a in leaf.spec],
                   "shard": list(leaf.shard)}
            for path, leaf in _leaves(tree) if isinstance(leaf, Abstract)}


def tensor_bytes(tree: Any) -> int:
    """Bytes of the tensors in ``tree`` (a step's outputs)."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def count_step(step, args: tuple) -> Tuple[DispatchCost, Any, float]:
    """Run ``step(*args)`` once under a :class:`DispatchCost`; returns
    (the counter, the step's outputs, host seconds)."""
    t0 = time.perf_counter()
    with DispatchCost() as cost:
        out = step(*args)
    return cost, out, time.perf_counter() - t0


def _card_fields(cost: DispatchCost, out: Any, args_bytes: int,
                 mf: float) -> dict:
    """The ``card`` record's cost, memory and roofline fields."""
    rep = roofline_report({"flops": cost.flops,
                           "bytes accessed": cost.bytes_min},
                          chips=1, model_flops_total=mf)
    out_bytes = tensor_bytes(out)
    return {
        "cost": {"flops": cost.flops, "bytes_accessed": cost.bytes_min,
                 "bytes_accessed_naive": cost.bytes},
        "collectives": {"total": 0.0},
        "kernels": {k: dict(v) for k, v in sorted(cost.kernels.items())},
        "memory": {"argument_bytes": args_bytes,
                   "output_bytes": out_bytes, "temp_bytes": None,
                   "fits_hbm": args_bytes + out_bytes <= HW().hbm_bytes},
        "roofline": {"compute_s": rep.compute_s,
                     "memory_s": rep.memory_s,
                     "collective_s": rep.collective_s,
                     "bottleneck": rep.bottleneck,
                     "useful_ratio": rep.useful_ratio},
        "model_flops": mf,
    }


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_combo(arch: str, shape_name: str, mesh_kind: str,
              out_dir: str = OUT_DIR, force: bool = False,
              verbose: bool = True) -> dict:
    """One combo's record (written to ``out_dir``, read back if it is
    there and not ``force``)."""
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        return _read(path)
    if should_skip(arch, shape_name):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped",
               "reason": "pure full-attention arch: long_500k requires "
                         "sub-quadratic attention"}
        _write(path, rec)
        return rec

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_mesh(mesh_kind)
    rules = make_rules(cfg, shape, mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": 1 if mesh is None else mesh.size, "status": "error"}
    t0 = time.perf_counter()
    try:
        with use_rules(rules):
            args, step, donate = dryrun_inputs(cfg, shape, rules,
                                               impl="ref")
        args_bytes = per_device_bytes(args)
        mf = model_flops(cfg, shape)
        rec.update({
            "status": "ok",
            "donate_argnums": list(donate),
            "remat": cfg.remat,
            "param_count": cfg.param_count(active_only=True),
            "param_count_tree": tree_size_bytes(model_defs(cfg), 1),
            "model_flops": mf,
        })
        if mesh is None:
            cost, out, secs = count_step(step, meta_inputs(args, shape))
            rec.update(_card_fields(cost, out, args_bytes, mf))
            rec["count_s"] = secs
        else:
            rec.update({"memory": {"argument_bytes": args_bytes},
                        "specs": _specs(args), "roofline": None,
                        "reason": _NO_PARTITION})
        rec["wall_s"] = time.perf_counter() - t0
        if verbose:
            line = (f"[ok] {tag}: args/dev {args_bytes / 1e9:.3f} GB")
            if mesh is None:
                rf = rec["roofline"]
                line += (f" flops {rec['cost']['flops']:.3e} bytes "
                         f"{rec['cost']['bytes_accessed']:.3e} "
                         f"{rf['bottleneck']} "
                         f"{max(rf['compute_s'], rf['memory_s']):.4g} s")
            print(line, flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[FAIL] {tag}: {rec['error'].splitlines()[0][:200]}",
                  flush=True)
    _write(path, rec)
    return rec


def _psp_noise(W: int, kind: Optional[str]):
    """Noise records of one tick on ``meta`` (the counted tick's
    durations, and the barrier's scores or uniforms)."""
    from repro_torch.core.spmd_psp import ReplayNoise
    meta = lambda *shape: torch.empty(shape, device="meta")
    tick = {"dur": meta(W)}
    if kind == "scores":
        tick["scores"] = meta(W, W)
    elif kind == "u":
        tick["u"] = meta(W)
    return ReplayNoise({"perm": meta(W), "dur": meta(W)}, [tick])


def run_psp_combo(arch: str, mesh_kind: str, out_dir: str = OUT_DIR,
                  workers: int = 0, force: bool = False,
                  verbose: bool = True) -> dict:
    """The PSP train step (W stacked views, AdamW moments, the per-worker
    batch; ``pssp``, β 2, s 3, stragglers 0.25, as the reference's) at
    train_4k: per-device bytes and specs on the meshes, one tick counted
    on ``card``."""
    from repro_torch.core.spmd_psp import PSPConfig, psp_init
    from repro_torch.optim import adamw

    tag = f"{arch}__train_4k_psp__{mesh_kind}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        return _read(path)
    cfg = get_config(arch)
    shape = INPUT_SHAPES["train_4k"]
    mesh = make_mesh(mesh_kind)
    rules = make_rules(cfg, shape, mesh)
    rules.table["psp_workers"] = psp_worker_axes(mesh)
    W = workers or PSP_WORKERS[mesh_kind]
    rec = {"arch": arch, "shape": "train_4k_psp", "mesh": mesh_kind,
           "chips": 1 if mesh is None else mesh.size, "workers": W,
           "status": "error"}
    t0 = time.perf_counter()
    try:
        f32 = torch.float32
        defs = model_defs(cfg)
        stacked = map_defs(lambda d: ParamDef(
            (W,) + d.shape, ("psp_workers",) + d.axes, init=d.init,
            scale=d.scale, dtype=d.dtype), defs)
        rep = lambda shp, dt: abstract(shp, dt, (None,) * len(shp), rules)
        gb = shape.global_batch
        state = {
            "server_params": abstract_params(defs, f32, rules),
            "opt_state": abstract_opt_state("adamw", defs, rules),
            "views": abstract_params(stacked, f32, rules),
            "control": {k: rep((W,), dt) for k, dt in (
                ("step", torch.int32), ("busy_until", f32),
                ("pushed", torch.bool), ("slow", torch.bool),
                ("alive", torch.bool))},
        }
        batch = {"tokens": abstract((W, gb // W, shape.seq_len),
                                    torch.int32,
                                    ("psp_workers", None, None), rules)}
        args_bytes = per_device_bytes((state, batch))
        mf = 6.0 * cfg.param_count(active_only=True) * shape.tokens
        rec.update({"status": "ok", "remat": cfg.remat, "model_flops": mf})
        if mesh is None:
            pcfg = PSPConfig(barrier="pssp", n_workers=W, sample_size=2,
                             staleness=3, straggler_frac=0.25)
            noise = _psp_noise(W, pcfg.noise_kind())
            opt = adamw(1e-4)
            st = psp_init(pcfg, to_meta(state["server_params"]), opt.init,
                          noise)
            step = make_psp_train_step(cfg, pcfg, opt, noise, impl="ref")
            cost, out, secs = count_step(step, (st, to_meta(batch)))
            rec.update(_card_fields(cost, out, args_bytes, mf))
            rec["count_s"] = secs
        else:
            rec.update({"memory": {"argument_bytes": args_bytes},
                        "specs": _specs((state, batch)), "roofline": None,
                        "reason": _NO_PARTITION})
        rec["wall_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[ok] {tag}: W {W}, args/dev {args_bytes / 1e9:.3f} GB",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[FAIL] {tag}: {rec['error'].splitlines()[0][:200]}",
                  flush=True)
    _write(path, rec)
    return rec


def main(argv=None) -> int:
    """CLI entry: run the selected combos; 1 if any failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=",".join(MESH_KINDS),
                    help="comma-separated mesh kinds: "
                         + ", ".join(MESH_KINDS))
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--psp", action="store_true",
                    help="count the PSP train step (the paper's technique) "
                         "instead of the plain steps")
    ap.add_argument("--workers", type=int, default=0,
                    help="PSP workers (default: 16 single, 32 multi, "
                         "4 card)")
    a = ap.parse_args(argv)
    meshes = a.mesh.split(",")
    for m in meshes:
        make_mesh(m)                      # an unknown kind raises here
    t0 = time.perf_counter()
    failures = 0
    if a.psp:
        archs = ["qwen2-0.5b"] if a.arch == "all" else a.arch.split(",")
        for arch in archs:
            for mesh in meshes:
                rec = run_psp_combo(arch, mesh, a.out, a.workers, a.force)
                failures += rec["status"] == "error"
    else:
        archs = list(ARCHS) if a.arch == "all" else a.arch.split(",")
        shapes = (list(INPUT_SHAPES) if a.shape == "all"
                  else a.shape.split(","))
        for arch in archs:
            for shape in shapes:
                for mesh in meshes:
                    rec = run_combo(arch, shape, mesh, a.out, a.force)
                    failures += rec["status"] == "error"
    print(f"done in {time.perf_counter() - t0:.1f} s on the host; "
          f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
