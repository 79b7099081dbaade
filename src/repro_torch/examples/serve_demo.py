"""Batched serving demo: prefill + cached decode across architectures.

The port's copy of ``examples/serve_demo.py``.  Serves three very
different families through the same engine — full attention (qwen2),
sliding-window (danube's ring cache) and attention-free SSM (mamba2's
constant-size state) — each at its reduced width, with seeded random
weights.  On the card (the default) the attention, RMSNorm and SSD scan
run as the port's CUDA kernels; without a GPU it raises unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.bench import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_model
from repro_torch.serving import ServeConfig, ServingEngine

ARCHS = ("qwen2-0.5b", "h2o-danube-1.8b", "mamba2-780m")


def main(argv=None):
    """Serve eight prompts of each family and print the rates."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        params = init_model(cfg, seed=0, device=dev)
        eng = ServingEngine(params, cfg,
                            ServeConfig(batch=4, max_new_tokens=16))
        prompts = [rng.integers(0, cfg.vocab_size, size=24).astype(np.int32)
                   for _ in range(8)]
        t0 = time.time()
        outs = eng.generate(prompts)
        dt = time.time() - t0
        total = sum(map(len, outs))
        print(f"{arch:18s} [{cfg.family:6s}] {len(prompts)} reqs, "
              f"{total} tokens in {dt:5.1f}s ({total/dt:5.1f} tok/s)  "
              f"first: {outs[0][:8].tolist()}")


if __name__ == "__main__":
    main()
