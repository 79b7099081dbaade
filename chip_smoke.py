#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. Print the card's name and power limit; build every CUDA kernel of the
   port from ``src/repro_torch/kernels/csrc`` and print the build seconds.
2. Hold the fused tick kernel against its plain PyTorch version on the
   card: the nine static branch cases (5 chained ticks each, at two
   sizes) and the paper shape (B = 32, P = 1000, d = 1000, m = 8,
   β = 10).  The control plane must match exactly; ``w``, ``pulled`` and
   ``pol_ema`` within rtol 1e-5, atol 1e-6·max(1, max|plain|) (the
   kernel sums the gradient in another order).  Time both at the paper
   shape.
3. The main path: the paper-scale Fig 2 straggler sweep (5 barriers × 5
   straggler fractions, P = 1000, d = 1000, β = 10, s = 4, 40 s, 2000
   ticks) through ``repro_torch.core.run_sweep`` on the card, with the
   kernel's launch count reset just before and read just after: it must
   equal the ticks run.  Then the same sweep once more under
   ``torch.profiler``: the device time of every kernel it ran, against
   the unprofiled run's wall time, gives the device's busy share.
4. The same configs with a 5 s horizon under ``PSP_TICK_IMPL=cuda`` and
   ``ref`` (same generator seed): steps, total updates and control
   messages equal, error traces within rtol 1e-4, atol 1e-6.

Then one JSON line with each kernel's launches, error and times, the
``nvidia-smi`` line, and the result line.  Exits non-zero without a
result when no CUDA device is visible or the port's sources are missing.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12

EXACT = ("steps", "alive", "computing", "event_time", "ready", "blocked",
         "pend_leave", "pend_join", "pol_thr", "pol_beta", "fin", "start",
         "n_fin", "ctrl")
CASES = [  # (churn, ragged, k_max, adaptive): the tick's static branches
    (False, False, 0, False), (False, False, 1, False),
    (False, False, 3, False), (True, False, 2, False),
    (False, True, 2, False), (True, True, 2, False),
    (False, False, 0, True), (False, False, 3, True), (True, True, 2, True),
]
TICK_KERNELS = ("control_kernel", "resid_kernel", "update_kernel")
FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")
FRACS = (0.0, 0.05, 0.1, 0.2, 0.3)


def smi() -> str:
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def tick_problem(np, seed, B, P, churn, ragged, k_max, d, m,
                 adaptive=False, fully_alive=False):
    """Random mid-flight tick state, params and noise (numpy).

    Row 0 gets a short horizon so chained ticks cross the row-freeze
    gate; ``adaptive`` mixes DSSP / Elastic-BSP / β-annealing rows in.
    """
    rng = np.random.default_rng(seed)
    n_true = np.full(B, P)
    if ragged:
        n_true = rng.integers(max(3, P // 2), P + 1, size=B)
        n_true[rng.integers(B)] = P
    valid = np.arange(P) < n_true[:, None]
    alive = valid if fully_alive else valid & (rng.random((B, P)) < 0.85)
    alive[:, 0] = valid[:, 0]
    kind = rng.integers(0, 3, size=B)
    f32, i32 = np.float32, np.int32
    state = {
        "steps": rng.integers(0, 6, (B, P)).astype(i32), "alive": alive,
        "computing": rng.random((B, P)) < 0.5,
        "event_time": (rng.random((B, P)) * 2).astype(f32),
        "ready": (rng.random((B, P)) * 2).astype(f32),
        "blocked": rng.random((B, P)) < 0.3,
        "pend_leave": rng.integers(0, 2, B).astype(i32),
        "pend_join": rng.integers(0, 2, B).astype(i32),
        "w": (rng.normal(size=(B, d)) / math.sqrt(d)).astype(f32),
        "pulled": (rng.normal(size=(B, P, d)) / math.sqrt(d)).astype(f32),
    }
    horizon = np.full(B, 10.0, f32)
    horizon[0] = 0.5
    params = {
        "staleness": rng.integers(0, 4, B).astype(i32),
        "beta_clip": np.clip(k_max, 0, n_true - 1).astype(i32),
        "is_asp": kind == 0, "full_view": kind == 1, "sampled": kind == 2,
        "dist_hops": rng.integers(0, 5, B).astype(i32),
        "compute_time": (0.05 + rng.random((B, P)) * 0.1).astype(f32),
        "valid_slot": valid,
        "w_true": (rng.normal(size=(B, d)) / math.sqrt(d)).astype(f32),
        "lr": np.full(B, 0.5 / P, f32),
        "noise_std": (rng.random(B) * 0.2).astype(f32),
        "horizon": horizon, "eps": 1e-4, "poll": float(f32(0.02)),
    }
    masked = churn or ragged
    shapes = {"dur": (B, P), "X": (P, m, d), "mb": (P, m)}
    if k_max == 1 and not masked:
        shapes["u1"] = (P,)
    elif k_max > 0:
        shapes["scores"] = (B, P, P) if masked else (P, P)
    if churn:
        shapes["leave"] = shapes["join"] = (B, P)
    leave_n = (rng.integers(0, 2, B) * churn).astype(i32)
    join_n = (rng.integers(0, 2, B) * churn).astype(i32)
    if adaptive:
        akind = rng.integers(0, 4, size=B)
        is_dssp, is_ebsp = akind == 1, akind == 2
        is_ann = (akind == 3) & (k_max > 0)
        adapt = is_dssp | is_ebsp | is_ann
        params.update(is_dssp=is_dssp, is_ebsp=is_ebsp, is_anneal=is_ann)
        params["full_view"] = np.where(adapt, is_dssp | is_ebsp,
                                       params["full_view"])
        params["sampled"] = np.where(adapt, is_ann, params["sampled"])
        params["is_asp"] = np.where(adapt, False, params["is_asp"])
        params["pol_lo"] = rng.integers(0, params["staleness"] + 1).astype(i32)
        params["beta_lo"] = rng.integers(
            0, params["beta_clip"] + 1).astype(i32)
        params["ebsp_range"] = (rng.random(B) * 4).astype(f32)
        params["ebsp_alpha"] = np.full(B, 0.5, f32)
        state["pol_thr"] = rng.integers(
            0, params["staleness"] + 1).astype(i32)
        state["pol_ema"] = (rng.random((B, P)) * 0.3).astype(f32)
        state["pol_beta"] = np.where(is_ann, params["beta_lo"],
                                     max(k_max, 0)).astype(i32)
    return state, shapes, params, leave_n, join_n, masked


def draw(np, shapes, seed):
    """One tick's noise for ``shapes`` (normal X/mb, uniform otherwise)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) if k in ("X", "mb")
                else rng.random(s)).astype(np.float32)
            for k, s in shapes.items()}


def compare(np, ref, ker, what):
    """Largest data-plane error; raises on any disagreement."""
    worst = 0.0
    for k, r in ref.items():
        a, b = r.detach().cpu().numpy(), ker[k].detach().cpu().numpy()
        if k in EXACT:
            if not np.array_equal(a, b):
                n = int((a != b).sum())
                raise AssertionError(f"{what}: {k} differs in {n} places")
        else:
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            scale = max(1.0, float(np.abs(a64).max(initial=0.0)))
            if not np.allclose(b64, a64, rtol=1e-5, atol=1e-6 * scale):
                raise AssertionError(
                    f"{what}: {k} max |diff| {np.abs(a64 - b64).max()}")
            worst = max(worst, float(np.abs(a64 - b64).max(initial=0.0)))
    return worst


def time_calls(torch, fn, n):
    """Milliseconds per call of ``fn`` over ``n`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def profile_device(torch, fn, n=1):
    """Device milliseconds per call of ``fn`` in each kernel or copy it
    runs (torch.profiler), by name; {} if the profiler sees none.  Only
    device events count: a host op's entry repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            out[ev.key] = out.get(ev.key, 0.0) + us / 1e3 / n
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import tick_inputs_to_torch, to_torch
    from repro_torch.core import SimConfig, make_barrier, run_sweep
    from repro_torch.core.vector_sim import VectorSimulator
    from repro_torch.core.vector_sim_torch import ticks_to_run
    from repro_torch.kernels import _build, psp_tick as pt

    dev = torch.device("cuda", 0)
    card = smi()
    print(f"[1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all(verbose=True)
    print(f"[1] built {sorted(secs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 2. kernel against the plain version ---------------------------- #
    def run_case(case, B, P, d, m, n_ticks=5, fully_alive=False, seed=0):
        churn, ragged, k_max, adaptive = case
        st, shapes, prm, ln, jn, masked = tick_problem(
            np, seed, B, P, churn, ragged, k_max, d, m, adaptive,
            fully_alive)
        kw = dict(k_max=k_max, has_churn=churn, masked=masked,
                  adaptive=adaptive)
        s_r, _, p = tick_inputs_to_torch(st, {}, prm, dev)
        s_k = dict(s_r)
        ln, jn = to_torch(ln, dev), to_torch(jn, dev)
        worst = 0.0
        for i in range(n_ticks):
            _, r, _ = tick_inputs_to_torch({}, draw(np, shapes, 100 + i), {},
                                           dev)
            t = float(np.float32(0.4 * (i + 1)))
            s_r, o_r = pt.psp_tick_ref(s_r, r, p, t, ln, jn, **kw)
            s_k, o_k = pt.psp_tick_cuda(s_k, r, p, t, ln, jn, **kw)
            torch.cuda.synchronize()
            worst = max(worst, compare(np, s_r, s_k, f"{case} tick {i}"),
                        compare(np, o_r, o_k, f"{case} tick {i} out"))
        return worst, (st, shapes, prm, ln, jn, kw)

    for size in ((3, 8, 5, 4), (5, 300, 40, 8)):
        for case in CASES:
            run_case(case, *size)
        print(f"[2] kernel == plain on all 9 branch cases at (B, P, d, m) = "
              f"{size}, 5 chained ticks", flush=True)
    B, P, d, m, beta = 32, 1000, 1000, 8, 10
    err, (st, shapes, prm, ln, jn, kw) = run_case(
        (False, False, beta, False), B, P, d, m, fully_alive=True)
    print(f"[2] kernel == plain at the paper shape (B, P, d, m, beta) = "
          f"{(B, P, d, m, beta)}, 5 chained ticks; data-plane max |err| "
          f"{err:.3g}", flush=True)

    s, _, p = tick_inputs_to_torch(st, {}, prm, dev)
    _, r, _ = tick_inputs_to_torch({}, draw(np, shapes, 7), {}, dev)
    tick = dict(state=s, rand=r, params=p, t=0.8, leave_n=ln, join_n=jn)
    ker = lambda: pt.psp_tick_cuda(**tick, **kw)
    ref = lambda: pt.psp_tick_ref(**tick, **kw)
    ms_call = time_calls(torch, ker, 50)
    ms_plain = time_calls(torch, ref, 20)
    split = {name: ms for key, ms in profile_device(torch, ker, 20).items()
             for name in TICK_KERNELS if name in key}
    ms_dev = sum(split.values()) if split else None
    _, o = ker()
    fin, start = o["fin"].bool(), o["start"].bool()
    n_fin = int(fin.sum())
    n_cand_sm = int(((~s["computing"]) & p["sampled"][:, None]).sum())
    # f32 elements this tick's data needs read: a starter that did not
    # push never reads its old view (its new one is the server model),
    # and no row reads the minibatch of a node that no row pushes
    pushed = int(fin.any(0).sum())
    need = {"pulled": int((fin | ~start).sum()) * d, "X": pushed * m * d,
            "mb": pushed * m}
    in_bytes = sum(4 * need[k] if k in need else v.numel() * v.element_size()
                   for group in (s, r, p) for k, v in group.items()
                   if isinstance(v, torch.Tensor)) + 2 * 4 * B
    out_bytes = sum(v.numel() * v.element_size()
                    for v in (*ker()[0].values(), *o.values()))
    flops = 4 * n_fin * m * d + 2 * 2 * n_cand_sm * P
    bound = 1e3 * max((in_bytes + out_bytes) / HBM_BPS, flops / F32_FLOPS)
    ms_kernel = ms_dev if ms_dev is not None else ms_call
    print(f"[2] paper-shape tick: kernel {ms_kernel:.4f} ms "
          f"({'profiler device time' if ms_dev else 'CUDA events'}; "
          f"{ms_call:.4f} ms per wrapper call with events), plain "
          f"{ms_plain:.4f} ms, bound {bound:.4f} ms "
          f"({(in_bytes + out_bytes) / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)"
          f" [{card}]", flush=True)
    print("[2] per launch: " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in split.items()),
          flush=True)

    # ---- 3. the main path: paper-scale Fig 2 sweep ---------------------- #
    def fig2(duration):
        return [SimConfig(n_nodes=P, dim=d, duration=duration, seed=0,
                          straggler_frac=f,
                          barrier=make_barrier(n, staleness=4,
                                               sample_size=beta))
                for n in FIVE for f in FRACS]

    cfgs = fig2(40.0)
    expect = ticks_to_run(VectorSimulator(cfgs))
    os.environ.pop("PSP_TICK_IMPL", None)
    torch.cuda.synchronize()
    pt.reset_launch_count()
    t0 = time.perf_counter()
    results = run_sweep(cfgs)
    wall = time.perf_counter() - t0
    launches = pt.launch_count()
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != ticks {expect}")
    for res in results:
        if not (np.isfinite(res.errors).all() and math.isfinite(
                res.mean_progress) and res.steps.shape == (P,)):
            raise AssertionError("non-finite or misshapen sweep result")
    node_steps = sum(res.total_updates for res in results)
    print(f"[3] Fig 2 sweep (25 rows, P={P}, d={d}, beta={beta}, s=4, 40 s):"
          f" {launches} ticks through the kernel in {wall:.3f} s = "
          f"{1e3 * wall / launches:.4f} ms/tick, {launches / wall:.1f} "
          f"ticks/s, {node_steps / wall:.4g} node-steps/s [{card}]",
          flush=True)
    busy = profile_device(torch, lambda: run_sweep(cfgs))
    if busy:
        tick_ms = sum(ms for key, ms in busy.items()
                      if any(name in key for name in TICK_KERNELS))
        busy_ms = sum(busy.values())
        print(f"[3] traced rerun: device busy {busy_ms:.3f} ms = "
              f"{busy_ms / launches:.4f} ms/tick (tick kernels "
              f"{tick_ms / launches:.4f} ms/tick), busy share "
              f"{busy_ms / (1e3 * wall):.4f} of the unprofiled wall, idle "
              f"share {1 - busy_ms / (1e3 * wall):.4f} [{card}]", flush=True)
        for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[3]   {ms / launches:.4f} ms/tick  {key[:90]}",
                  flush=True)
    else:
        print("[3] traced rerun: the profiler saw no device time; the "
              "busy share is not measured", flush=True)
    ratios = {}
    for i, name in enumerate(FIVE):
        row = results[i * len(FRACS):(i + 1) * len(FRACS)]
        ratios[name] = [res.mean_progress / row[0].mean_progress
                        for res in row]
        print(f"[3]   {name:5s} progress ratio "
              + " ".join(f"{f:.2f}:{x:.3f}" for f, x in
                         zip(FRACS, ratios[name]))
              + f"  final error {row[0].final_error:.4f}", flush=True)
    if not ratios["asp"][-1] > ratios["bsp"][-1]:
        raise AssertionError("ASP should keep more progress than BSP "
                             "under 30% stragglers")

    # ---- 4. cuda against ref, whole sweep ------------------------------- #
    short = fig2(5.0)
    runs = {}
    for impl in ("cuda", "ref"):
        os.environ["PSP_TICK_IMPL"] = impl
        t0 = time.perf_counter()
        runs[impl] = run_sweep(short)
        print(f"[4] 5 s sweep under {impl}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    os.environ.pop("PSP_TICK_IMPL", None)
    for a, b in zip(runs["cuda"], runs["ref"]):
        if not (np.array_equal(a.steps, b.steps)
                and a.total_updates == b.total_updates
                and a.control_messages == b.control_messages
                and np.array_equal(a.server_updates, b.server_updates)):
            raise AssertionError("cuda and ref sweeps differ in the "
                                 "integer traces")
        np.testing.assert_allclose(a.errors, b.errors, rtol=1e-4, atol=1e-6)
    print("[4] cuda == ref: steps, updates and control messages equal, "
          "errors within rtol 1e-4", flush=True)

    print(json.dumps({"kernels": [{
        "name": "psp_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/psp_tick.cu",
        "replaces": "src/repro/kernels/psp_tick.py:862",
        "launches": launches, "max_abs_err": err, "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound, "bound_by":
            "bytes" if (in_bytes + out_bytes) / HBM_BPS >= flops / F32_FLOPS
            else "operations",
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
