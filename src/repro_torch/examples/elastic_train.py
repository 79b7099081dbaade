"""Elastic PSP training demo: workers leave and join mid-run.

The port's copy of ``examples/elastic_train.py``.  Runs the PSP trainer
with an elastic worker set (``PSPConfig(churn=ChurnConfig(...))``):
Poisson leave/join events shrink and regrow the worker population while
training proceeds, departed workers contribute zero gradient to the
server sum, and joiners restart from a fresh pull of the server model at
the current max alive step.  Churn is data (pre-sampled schedules and an
alive mask), not control flow.  On the card by default (raises without
a GPU), on the CPU with ``--device cpu``.

With ``--ckpt-dir`` the demo can be killed and resumed: the async
:class:`~repro_torch.checkpoint.CheckpointManager` cuts full-``PSPState``
checkpoints (and the noise generator's state) every ``--save-every``
ticks, and ``--resume`` restores the newest one, fast-forwards the
minibatch stream and continues the identical trajectory.

    PYTHONPATH=src python -m repro_torch.examples.elastic_train
    PYTHONPATH=src python -m repro_torch.examples.elastic_train \\
        --barrier bsp --ticks 400
    PYTHONPATH=src python -m repro_torch.examples.elastic_train \\
        --barrier ebsp --max-advance 8 --contribution mean-alive
    PYTHONPATH=src python -m repro_torch.examples.elastic_train \\
        --ckpt-dir /tmp/elastic --save-every 50   # SIGKILL, add --resume
"""
import argparse

import torch

from repro_torch.bench import resolve_device
from repro_torch.checkpoint import (CheckpointManager, CheckpointPolicy,
                                    latest_step)
from repro_torch.core.spmd_psp import (ChurnConfig, GeneratorNoise,
                                       PSPConfig, elastic_drive,
                                       linear_psp_state)
from repro_torch.launch.train import psp_archive, restore_psp
from repro_torch.serving.snapshot_bus import SnapshotPublisher

D = 32
#: the noise seed of elastic_drive's default source
NOISE_SEED = 1


def main(argv=None):
    """Train the linear task under churn, printing the population live."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--barrier", default="pssp",
                    choices=("bsp", "ssp", "asp", "pbsp", "pssp",
                             "dssp", "ebsp", "apbsp", "apssp"),
                    help="static protocol or adaptive policy "
                         "(dssp / ebsp / annealed p(b|s)sp)")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--leave-rate", type=float, default=1.5)
    ap.add_argument("--join-rate", type=float, default=1.5)
    ap.add_argument("--staleness-lo", type=int, default=0,
                    help="dssp: lower end of the dynamic staleness range")
    ap.add_argument("--max-advance", type=int, default=4,
                    help="ebsp: slack budget for EMA-fast workers")
    ap.add_argument("--contribution", default="mean",
                    choices=("mean", "mean-alive", "sum"),
                    help="gradient scaling; mean-alive tracks the EMA "
                         "of the live population in the policy state")
    ap.add_argument("--ckpt-dir", default=None,
                    help="cut async full-state checkpoints here")
    ap.add_argument("--save-every", type=int, default=25,
                    help="ticks between checkpoints (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint and continue "
                         "(no-op when --ckpt-dir holds none)")
    ap.add_argument("--publish-dir", default=None,
                    help="publish server_params snapshots here every "
                         "--publish-every ticks (trainer→server bus)")
    ap.add_argument("--publish-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    cfg = PSPConfig(barrier=a.barrier, n_workers=a.workers, sample_size=2,
                    staleness=3, straggler_frac=0.25,
                    staleness_lo=a.staleness_lo, max_advance=a.max_advance,
                    contribution=a.contribution,
                    churn=ChurnConfig(leave_rate=a.leave_rate,
                                      join_rate=a.join_rate,
                                      horizon=60.0, seed=7))
    noise = GeneratorNoise(NOISE_SEED, dev)
    state, start = None, 0
    if a.resume and a.ckpt_dir and latest_step(a.ckpt_dir) is not None:
        state, start = restore_psp(
            a.ckpt_dir, linear_psp_state(cfg, D, noise, dev), noise, None,
            reseed=NOISE_SEED)
        print(f"resumed tick {start} from {a.ckpt_dir}")
    if start >= a.ticks:
        print(f"nothing to do: checkpoint already at tick {start} "
              f">= --ticks {a.ticks}")
        return
    mgr = None
    if a.ckpt_dir:
        mgr = CheckpointManager(a.ckpt_dir,
                                CheckpointPolicy(every_steps=a.save_every))
    pub = None
    if a.publish_dir:
        pub = SnapshotPublisher(a.publish_dir, every_steps=a.publish_every)
    w_true, it = elastic_drive(cfg, D, a.ticks, noise=noise, device=dev,
                               state=state, start_tick=start)
    norm_true = torch.linalg.norm(w_true)
    print(f"{a.barrier} with churn {a.leave_rate}-/s {a.join_rate}+/s "
          f"on {a.workers} workers")
    print(f"{'tick':>5s} {'virt_t':>7s} {'alive':>5s} {'members':>10s} "
          f"{'mean_step':>9s} {'err':>8s}")
    for i, (st, m) in enumerate(it, start=start):
        if i % 25 == 0 or i == a.ticks - 1:
            err = float(torch.linalg.norm(st.server_params["w"] - w_true)
                        / norm_true)
            members = "".join("#" if b else "."
                              for b in st.alive.cpu().tolist())
            print(f"{i:5d} {float(st.now):7.2f} {int(m['alive']):5d} "
                  f"{members:>10s} {float(m['mean_step']):9.1f} {err:8.4f}")
        if mgr and mgr.should_save(i + 1):
            mgr.save(i + 1, psp_archive(st, noise, None),
                     {"barrier": a.barrier, "ticks": i + 1})
        if pub:
            pub.maybe_publish(i + 1, st.server_params,
                              {"barrier": a.barrier})
    if pub:
        pub.publish(a.ticks, st.server_params, {"barrier": a.barrier},
                    block=True)
        pub.close()
        print(f"published {pub.published} snapshots to {a.publish_dir}")
    if mgr:
        mgr.save(a.ticks, psp_archive(st, noise, None),
                 {"barrier": a.barrier, "ticks": a.ticks}, block=True)
        mgr.close()
        print(f"checkpoint: tick {mgr.latest_step()} in {a.ckpt_dir}")
    print(f"\n{int(st.leave_cursor)} leave events, "
          f"{int(st.join_cursor)} join events consumed; "
          f"{int(st.total_pushes)} server updates")


if __name__ == "__main__":
    main()
