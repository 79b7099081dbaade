"""Training launcher: the port's counterpart of :mod:`repro.launch.train`.

Two modes, with the reference's flags and defaults:

* ``--barrier none`` — plain synchronous training;
* ``--barrier {bsp,ssp,asp,pbsp,pssp}`` — PSP training
  (:mod:`repro_torch.core.spmd_psp`): W worker views, seeded
  virtual-clock heterogeneity, masked server aggregation.

On the CPU, at the reduced width::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --barrier pbsp

On the card (the default ``--device cuda``; raises without a GPU), the
attention and RMSNorm forward and backward run as the port's CUDA
kernels.  Weights come from the port's seeded initialisation
(``--seed``), tokens from :class:`~repro_torch.data.SyntheticLM` (whose
``vocab²`` host table limits it to small vocabularies, as in the
reference, which trains ``--reduced``), the PSP noise from a
``torch.Generator`` seeded ``--seed + 1``.  ``--ckpt-dir`` /
``--resume`` wait for the checkpoint module (ROADMAP queue 1, item 12)
and ``--publish-dir`` for the snapshot bus (item 13): they raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.core.spmd_psp import GeneratorNoise, PSPConfig, psp_init
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_psp_train_step, make_train_step
from repro_torch.models import init_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.tree import tree_leaves

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--barrier", default="none",
                    choices=["none", "bsp", "ssp", "asp", "pbsp", "pssp"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--sample-size", type=int, default=2)
    ap.add_argument("--staleness", type=int, default=3)
    ap.add_argument("--straggler-frac", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--save-interval", type=float, default=0.0)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--throttle", type=float, default=0.0,
                    help="sleep per step")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--publish-dir", default=None)
    ap.add_argument("--publish-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """Train as the flags say (see the module docstring); returns 0."""
    a = parse_args(argv)
    if a.ckpt_dir or a.resume:
        raise NotImplementedError("--ckpt-dir / --resume: the checkpoint "
                                  "module is ROADMAP queue 1, item 12")
    if a.publish_dir:
        raise NotImplementedError("--publish-dir: the snapshot bus is "
                                  "ROADMAP queue 1, item 13")
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu "
                           "to train on the CPU")
    cfg = get_config(a.arch)
    if a.reduced:
        cfg = make_reduced(cfg, n_layers=a.n_layers, d_model=a.d_model)
        cfg = dataclasses.replace(cfg, vocab_size=a.vocab)
    opt = adamw(warmup_cosine(a.lr, a.steps // 10 + 1, a.steps))
    params = init_model(cfg, seed=a.seed, device=dev).tree()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params:,} barrier={a.barrier} "
          f"device={dev}")
    t0 = time.time()
    if a.barrier == "none":
        data = iter(SyntheticLM(cfg.vocab_size, a.seq, a.batch, seed=a.seed,
                                device=dev))
        state = opt.init(params)
        step_fn = make_train_step(cfg, opt)
        for t in range(a.steps):
            params, state, loss, _ = step_fn(params, state, next(data))
            if t % a.log_every == 0 or t == a.steps - 1:
                print(f"step {t:5d} loss {float(loss):.4f} "
                      f"({time.time() - t0:.1f}s)")
            if a.throttle:
                time.sleep(a.throttle)
    else:
        W = a.workers
        data = iter(SyntheticLM(cfg.vocab_size, a.seq, W * a.batch,
                                seed=a.seed, device=dev))
        pcfg = PSPConfig(barrier=a.barrier, n_workers=W,
                         sample_size=a.sample_size, staleness=a.staleness,
                         straggler_frac=a.straggler_frac)
        noise = GeneratorNoise(a.seed + 1, dev)
        st = psp_init(pcfg, params, opt.init, noise)
        step_fn = make_psp_train_step(cfg, pcfg, opt, noise)
        for t in range(a.steps):
            toks = next(data)["tokens"].reshape(W, a.batch, a.seq)
            st, m = step_fn(st, toks)
            if t % a.log_every == 0 or t == a.steps - 1:
                print(f"tick {t:5d} loss {float(m['loss']):.4f} "
                      f"vtime {float(m['virtual_time']):.2f}s "
                      f"mean_step {float(m['mean_step']):.1f} "
                      f"spread {int(m['step_spread'])} "
                      f"({time.time() - t0:.1f}s)")
            if a.throttle:
                time.sleep(a.throttle)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
