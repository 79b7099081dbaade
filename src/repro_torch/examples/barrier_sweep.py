"""Barrier-control sweep on a real model: the paper's Fig-1 trade-off,
measured on a transformer (not the linear-model simulator).

The port's copy of ``examples/barrier_sweep.py``.  Stage 1 ranks all
barriers cheaply with the sweep engine
(:func:`repro_torch.core.run_sweep`: every barrier × seed scenario
advances at once on the linear task; on the ``torch`` backend each tick
is the port's CUDA tick kernel on the card); stage 2 confirms the
trade-off on a live transformer: for each barrier it trains the same
reduced qwen2 (2 layers, d 128, vocabulary 256) with 25 % injected
stragglers under PSP and reports the loss reached against virtual
wall-clock.  On the card by default (raises without a GPU), on the CPU
with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.barrier_sweep [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.bench import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.barriers import make_barrier
from repro_torch.core.simulator import SimConfig
from repro_torch.core.spmd_psp import GeneratorNoise, PSPConfig, psp_init
from repro_torch.core.vector_sim import run_sweep
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_psp_train_step
from repro_torch.models import init_model, loss_fn
from repro_torch.optim import adamw

W, TICKS = 4, 120
BARRIERS = ("bsp", "ssp", "asp", "pbsp", "pssp")


def simulator_presweep(backend="torch", device=None):
    """One batched run over barriers × seeds on the linear task.

    Runs on the torch backend by default: the whole barrier × seed
    matrix advances on ``device`` (``None``: the card, through the tick
    kernel); ``backend="numpy"`` is the host grid engine."""
    seeds = (0, 1, 2)
    cfgs = [SimConfig(n_nodes=64, duration=10.0, dim=32, seed=s,
                      straggler_frac=0.25,
                      barrier=make_barrier(n, staleness=3, sample_size=2))
            for n in BARRIERS for s in seeds]
    results = run_sweep(cfgs, backend=backend,
                        device=device if backend == "torch" else None)
    print(f"{'barrier':8s} {'steps/node':>10s} {'spread':>7s} {'err':>8s}"
          f"   (simulator, {len(cfgs)} scenarios batched, "
          f"{backend} backend)")
    for i, name in enumerate(BARRIERS):
        rs = results[i * len(seeds):(i + 1) * len(seeds)]
        mean = sum(r.mean_progress for r in rs) / len(rs)
        spread = max(int(r.steps.max() - r.steps.min()) for r in rs)
        err = max(r.final_error for r in rs)
        print(f"{name:8s} {mean:10.1f} {spread:7d} {err:8.4f}")
    print()


def main(argv=None):
    """Stage 1 on the sweep engine, then stage 2 on the transformer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    simulator_presweep(device=dev)
    cfg = reduced(get_config("qwen2-0.5b"))
    cfg = dataclasses.replace(cfg, vocab_size=256, n_layers=2, d_model=128,
                              remat=False)
    data = iter(SyntheticLM(cfg.vocab_size, 64, W * 4, seed=0, device=dev))
    batches = [next(data)["tokens"].reshape(W, 4, 64) for _ in range(16)]
    opt = adamw(2e-3)

    print(f"{'barrier':8s} {'loss':>8s} {'vtime':>7s} {'steps':>7s} "
          f"{'spread':>7s} {'steps/s':>8s}")
    for name in BARRIERS:
        pcfg = PSPConfig(barrier=name, n_workers=W, sample_size=2,
                         staleness=3, straggler_frac=0.25)
        noise = GeneratorNoise(1, dev)
        st = psp_init(pcfg, init_model(cfg, seed=0, device=dev).tree(),
                      opt.init, noise)
        # one worker's loss and gradients clipped to global norm 1.0
        step = make_psp_train_step(cfg, pcfg, opt, noise, clip_norm=1.0)
        for t in range(TICKS):
            st, m = step(st, batches[t % len(batches)])
        with torch.no_grad():
            loss, _ = loss_fn(st.server_params, {"tokens": batches[0][0]},
                              cfg)
        vt, ms = float(m["virtual_time"]), float(m["mean_step"])
        print(f"{name:8s} {float(loss):8.4f} {vt:7.2f} {ms:7.1f} "
              f"{int(m['step_spread']):7d} {ms / vt:8.2f}")
    print("\n→ probabilistic barriers keep near-ASP step throughput while")
    print("  bounding dispersion — the paper's trade-off, on a live model.")


if __name__ == "__main__":
    main()
