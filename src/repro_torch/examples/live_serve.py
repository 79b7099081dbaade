"""Live-traffic demo: a PSP trainer feeding a hot-swapping server.

The port's copy of ``examples/live_serve.py``.  Two processes, one
snapshot bus, no coordination:

* a **trainer subprocess** (``repro_torch.launch.train --barrier pbsp
  --publish-dir``) trains a reduced transformer and publishes versioned
  serving snapshots on its step cadence;
* an **in-process server**
  (:class:`~repro_torch.serving.InferenceServer` over the
  request-lifecycle :class:`~repro_torch.serving.ServingEngine`) watches
  the directory, serves synthetic traffic the whole time, and hot-swaps
  to each new snapshot as it lands; in-flight requests always finish on
  the snapshot they started with.

Both run on the card by default (raises without a GPU), on the CPU with
``--device cpu``.  The demo prints completions with the snapshot version
each was decoded on and exits non-zero unless the trainer exited 0,
nothing was dropped and the traffic spanned at least two versions with
at least two swaps.  ``--smoke`` shrinks everything.

    PYTHONPATH=src python -m repro_torch.examples.live_serve [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.live_serve --smoke
"""
import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.bench import resolve_device
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.convert import params_to_numpy
from repro_torch.models import init_model
from repro_torch.serving import (InferenceServer, Request, ServeConfig,
                                 ServingEngine, SnapshotWatcher)

SRC = Path(__file__).resolve().parents[2]


def main(argv=None):
    """Serve while the trainer child publishes; 0 when the run held."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=40,
                    help="trainer steps")
    ap.add_argument("--publish-every", type=int, default=10)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--throttle", type=float, default=0.2,
                    help="trainer pacing so traffic overlaps training")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu, "
                         "for the trainer and the server")
    ap.add_argument("--smoke", action="store_true",
                    help="a small run (fewer steps and requests)")
    a = ap.parse_args(argv)
    if a.smoke:
        a.steps, a.publish_every, a.requests = 9, 3, 10
        a.max_new, a.throttle = 6, 0.3
    dev = resolve_device(a.device)

    # the same reduced config the trainer subprocess builds (its flag
    # defaults: --d-model 256 --n-layers 2 --vocab 512)
    cfg = dataclasses.replace(
        make_reduced(get_config(a.arch), n_layers=2, d_model=256),
        vocab_size=512)
    params = init_model(cfg, seed=0, device=dev)

    snap_dir = tempfile.mkdtemp(prefix="psp_snaps_")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    trainer = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", a.arch,
         "--reduced", "--barrier", "pbsp", "--steps", str(a.steps),
         "--batch", "4", "--seq", "32", "--workers", "4",
         "--throttle", str(a.throttle),
         "--publish-dir", snap_dir, "--publish-every", str(a.publish_every),
         "--device", dev.type],
        env=env)

    eng = ServingEngine(params, cfg, ServeConfig(
        batch=a.batch, max_len=256, max_new_tokens=a.max_new), version=0)
    watcher = SnapshotWatcher(snap_dir, params_to_numpy(params), cfg, dev)
    rng = np.random.default_rng(0)
    deadline = time.monotonic() + a.timeout
    comps = []
    try:
        with InferenceServer(eng, watcher=watcher, poll_every=2) as srv:
            def req():
                return srv.submit(Request(prompt=rng.integers(
                    0, cfg.vocab_size, size=a.prompt_len).astype(np.int32)))

            # steady traffic while the trainer runs (these requests land
            # on v0 and whatever snapshots get published mid-stream)...
            futs = []
            while trainer.poll() is None and time.monotonic() < deadline:
                if len(futs) < a.requests - a.batch:
                    futs.append(req())
                time.sleep(a.throttle / 2)
            # ...then wait for the trainer's final snapshot to swap in so
            # the tail of the traffic provably spans a second version
            final = latest_step(snap_dir)
            while (final is not None and watcher.loaded_step != final
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            while len(futs) < a.requests:
                futs.append(req())
            comps = [f.result(timeout=a.timeout) for f in futs]
    finally:
        if trainer.poll() is None:
            trainer.kill()
        trainer.wait()
        shutil.rmtree(snap_dir, ignore_errors=True)

    st = srv.stats
    versions = sorted({c.snapshot_version for c in comps})
    print(f"\n{len(comps)} completions, {st.swaps} hot-swaps, "
          f"versions seen in traffic: {versions}")
    for c in comps[:6]:
        print(f"  req{c.req_id}: v{c.snapshot_version} "
              f"{c.tokens[:8].tolist()}... ({c.finish_reason})")
    if trainer.returncode != 0:
        print(f"FAIL: trainer exited {trainer.returncode}")
        return 1
    if len(comps) != a.requests:
        print(f"FAIL: {a.requests - len(comps)} requests dropped")
        return 1
    if st.swaps < 2 or len(versions) < 2:
        print("FAIL: traffic did not span two snapshot versions "
              f"(swaps={st.swaps}, versions={versions})")
        return 1
    stall = max(st.swap_stalls) if st.swap_stalls else 0.0
    print(f"OK: zero drops; max swap stall {stall * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
