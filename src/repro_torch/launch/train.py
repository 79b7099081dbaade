"""Training launcher: the port's counterpart of :mod:`repro.launch.train`.

Two modes, with the reference's flags and defaults:

* ``--barrier none`` — plain synchronous training;
* ``--barrier {bsp,ssp,asp,pbsp,pssp}`` — PSP training
  (:mod:`repro_torch.core.spmd_psp`): W worker views, seeded
  virtual-clock heterogeneity, masked server aggregation.

Fault tolerance: with ``--ckpt-dir`` the run cuts *full-state*
checkpoints through the async
:class:`~repro_torch.checkpoint.CheckpointManager` every
``--save-every`` steps and/or ``--save-interval`` seconds, plus one at
the final step; ``--keep`` of them are retained.  PSP mode saves the
whole :class:`~repro_torch.core.spmd_psp.PSPState` (server params,
optimizer state, views, the control plane, the policy state) and the
state of its noise generator (``noise_state``); plain mode saves
``{params, opt_state}``.  Model trees are written in the reference's
layout, so either package resumes the other's checkpoints (a reference
checkpoint has no ``noise_state``: the noise is then re-seeded from
``--seed + 1``, and the log says so).  ``--resume`` restores the newest
checkpoint and replays the consumed data stream to its step, so a run
killed and resumed with the same flags ends bit for bit where the
uninterrupted run ends.

Live serving: ``--publish-dir`` publishes *serving snapshots* (params
only: ``server_params`` in PSP mode) every ``--publish-every`` steps
over the snapshot bus (:mod:`repro_torch.serving.snapshot_bus`), plus
one at the final step; ``python -m repro_torch.launch.serve
--watch-dir`` hot-swaps them under traffic.

On the CPU, at the reduced width::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --barrier pbsp --ckpt-dir /tmp/ck --save-every 25 \\
        --publish-dir /tmp/snaps
    # ... killed mid-run, then the same command with --resume

On the card (the default ``--device cuda``; raises without a GPU), the
attention (qwen2-0.5b, qwen1.5-4b, h2o-danube-1.8b's sliding window,
gemma2-27b, recurrentgemma-2b's local layers at head dim 256, the MoE
decoders qwen3-moe-30b-a3b and dbrx-132b), SSD scan (mamba2, ``--arch
mamba2-780m``) or RG-LRU scan (``--arch recurrentgemma-2b``) and the
RMSNorm forward and backward run as the port's CUDA kernels; a
``--reduced`` model's head dim must be one the flash kernel takes (64,
80, 128, 256: dbrx-132b's 6 reduced heads need ``--d-model 384``).  The
loss adds the MoE router's load-balance term.  Weights come from the
port's seeded initialisation (``--seed``), tokens from
:class:`~repro_torch.data.SyntheticLM` (whose ``vocab²`` host table
limits it to small vocabularies, as in the
reference, which trains ``--reduced``: at full width qwen2's and
qwen1.5's 151,936-token vocabularies would need a 92 GB table, gemma2's
256,000 262 GB, internvl2-2b's 92,553 34 GB), the PSP noise from a
``torch.Generator`` seeded ``--seed + 1``.  The batches hold tokens
only, as the reference's trainer feeds them: a modality model
(internvl2-2b, musicgen-large) trains without frontend rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, CheckpointPolicy,
                                    archive_keys, host_snapshot,
                                    latest_step, restore_checkpoint)
from repro_torch.configs import ARCHS, get_config, reduced as make_reduced
from repro_torch.convert import (from_reference_layout, state_from_reference,
                                 state_to_reference, to_reference_layout)
from repro_torch.core.spmd_psp import (GeneratorNoise, PSPConfig, psp_init,
                                       state_from_tree, state_to_tree)
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_psp_train_step, make_train_step
from repro_torch.models import init_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.serving.snapshot_bus import SnapshotPublisher
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["main", "parse_args", "psp_archive", "restore_psp"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="one of " + ", ".join(sorted(ARCHS)) + "; "
                         "without --reduced SyntheticLM's vocab² host "
                         "table rules out the 92,553-, 151,936- and "
                         "256,000-token vocabularies (internvl2, qwen2, "
                         "qwen1.5, gemma2)")
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
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint every N steps (0: final step only)")
    ap.add_argument("--save-interval", type=float, default=0.0,
                    help="checkpoint every T wall-clock seconds (0: off)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoints retained by GC (older are deleted)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --ckpt-dir "
                         "(no-op when none exists) and continue")
    ap.add_argument("--throttle", type=float, default=0.0,
                    help="sleep per step; paces the run so kill-and-resume "
                         "tests get a deterministic mid-run kill window")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--publish-dir", default=None,
                    help="publish serving snapshots (params only) here "
                         "for a live server to hot-swap")
    ap.add_argument("--publish-every", type=int, default=25,
                    help="snapshot-publication step cadence")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def psp_archive(st, noise: GeneratorNoise, cfg) -> dict:
    """The PSP state as a checkpoint tree: a host copy of every field in
    the reference's layout, plus the noise generator's state."""
    tree = state_to_reference(host_snapshot(state_to_tree(st)), cfg)
    return {**tree, "noise_state": noise.gen.get_state().numpy()}


def _to_device(tree, dev):
    """A host tree's arrays as contiguous tensors on ``dev``."""
    return tree_map(lambda a: torch.from_numpy(
        a if a.flags.c_contiguous else np.ascontiguousarray(a)).to(dev), tree)


def _make_manager(a) -> Optional[CheckpointManager]:
    """The run's async checkpointer (None when ``--ckpt-dir`` is unset)."""
    if not a.ckpt_dir:
        return None
    return CheckpointManager(
        a.ckpt_dir,
        CheckpointPolicy(every_steps=a.save_every or None,
                         every_seconds=a.save_interval or None),
        keep=a.keep)


def restore_psp(ckpt_dir: str, st, noise: GeneratorNoise, cfg, reseed: int):
    """Restore the newest PSP checkpoint in ``ckpt_dir`` into the
    structure and device of the state ``st`` (e.g. a freshly initialised
    one), and the noise generator's state into ``noise``.

    A checkpoint without ``noise_state`` (one of the reference's)
    re-seeds ``noise`` from ``reseed`` instead, and says so.  Returns
    ``(state, step)``.
    """
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    template = psp_archive(st, noise, cfg)
    has_noise = "noise_state" in archive_keys(ckpt_dir, step)
    if not has_noise:
        del template["noise_state"]
    tree, step = restore_checkpoint(ckpt_dir, template, step)
    if has_noise:
        noise.gen.set_state(torch.from_numpy(tree.pop("noise_state")))
    else:
        noise.gen.manual_seed(reseed)
        print(f"checkpoint step {step} holds no noise_state: the PSP noise "
              f"is re-seeded from {reseed}")
    tree = _to_device(state_from_reference(tree, cfg), st.step.device)
    return state_from_tree(tree), step


def main(argv: Optional[List[str]] = None) -> int:
    """Train as the flags say (see the module docstring); returns 0."""
    a = parse_args(argv)
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

    mgr = _make_manager(a)
    # --resume means "continue if a checkpoint exists": legal on a first
    # launch, so crash-loop supervisors can pass it unconditionally
    resuming = bool(a.resume and a.ckpt_dir
                    and latest_step(a.ckpt_dir) is not None)
    pub = (SnapshotPublisher(a.publish_dir, cfg, every_steps=a.publish_every)
           if a.publish_dir else None)
    meta = {"arch": cfg.name, "barrier": a.barrier}
    t0 = time.time()
    if a.barrier == "none":
        data = iter(SyntheticLM(cfg.vocab_size, a.seq, a.batch, seed=a.seed,
                                device=dev))
        state = opt.init(params)

        def archive():
            return to_reference_layout(host_snapshot(
                {"params": params, "opt_state": state}), cfg)

        start = 0
        if resuming:
            tree, start = restore_checkpoint(a.ckpt_dir, archive())
            tree = _to_device(from_reference_layout(tree, cfg), dev)
            params, state = tree["params"], tree["opt_state"]
            print(f"resumed step {start} from {a.ckpt_dir}")
        for _ in range(start):       # replay the consumed data stream
            next(data)
        step_fn = make_train_step(cfg, opt)
        for t in range(start, a.steps):
            params, state, loss, _ = step_fn(params, state, next(data))
            if t % a.log_every == 0 or t == a.steps - 1:
                print(f"step {t:5d} loss {float(loss):.4f} "
                      f"({time.time() - t0:.1f}s)")
            if mgr and mgr.should_save(t + 1):
                mgr.save(t + 1, archive(), {**meta, "data_step": t + 1})
            if pub:
                pub.maybe_publish(t + 1, params, meta)
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
        archive = lambda: psp_archive(st, noise, cfg)
        start = 0
        if resuming:
            st, start = restore_psp(a.ckpt_dir, st, noise, cfg, a.seed + 1)
            print(f"resumed step {start} from {a.ckpt_dir}")
        for _ in range(start):       # replay the consumed data stream
            next(data)
        step_fn = make_psp_train_step(cfg, pcfg, opt, noise)
        for t in range(start, a.steps):
            toks = next(data)["tokens"].reshape(W, a.batch, a.seq)
            st, m = step_fn(st, toks)
            if t % a.log_every == 0 or t == a.steps - 1:
                print(f"tick {t:5d} loss {float(m['loss']):.4f} "
                      f"vtime {float(m['virtual_time']):.2f}s "
                      f"mean_step {float(m['mean_step']):.1f} "
                      f"spread {int(m['step_spread'])} "
                      f"({time.time() - t0:.1f}s)")
            if mgr and mgr.should_save(t + 1):
                mgr.save(t + 1, archive(), {**meta, "data_step": t + 1})
            if pub:
                pub.maybe_publish(t + 1, st.server_params, meta)
            if a.throttle:
                time.sleep(a.throttle)
        params = st.server_params
    if mgr:
        if a.steps > start:
            mgr.save(a.steps, archive(), {**meta, "data_step": a.steps},
                     block=True)
        mgr.close()
        print(f"checkpoint: step {mgr.latest_step()} in {a.ckpt_dir}")
    if pub:
        if a.steps > start:
            pub.publish(a.steps, params, meta, block=True)
        pub.close()
        print(f"published {pub.published} snapshots to {a.publish_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
