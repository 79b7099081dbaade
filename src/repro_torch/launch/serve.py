"""Serving launcher: one-shot batched generation on random weights, or a
live hot-swapping server.

On the card (the default ``--device cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \\
        --batch 4 --prompt-len 512 --max-len 1024 --max-new 64

On the CPU, at the reduced width::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

``--arch`` picks any registered architecture: the default qwen2-0.5b,
qwen1.5-4b (untied unembedding), h2o-danube-1.8b (sliding-window
``local`` layers and their ring caches; ``--max-len`` at least its
window of 4096), gemma2-27b (alternating local and global layers,
softcaps, post-norms, fused QKV; 108.9 GB of f32 parameters at full
depth, so on one card only reduced or cut, e.g. ``--n-layers 8``),
recurrentgemma-2b (RG-LRU blocks and local attention at head dim 256,
the RG-LRU scan kernel; ``--max-len`` at least its window of 2048),
mamba2-780m (the Mamba-2 stack, SSD-scan kernel), or the MoE decoders
qwen3-moe-30b-a3b (128 experts, top 8; 30.5B parameters, so on one card
cut, e.g. ``--n-layers 12``) and dbrx-132b (16 experts, top 4; e.g.
``--n-layers 2``), or the modality models internvl2-2b (a vision stub's
256 frontend rows before each prompt, 16 / 8 heads of 128) and
musicgen-large (an audio stub's 64 rows, sinusoidal positions, the GELU
MLP, fused QKV at 32 / 32 heads of 64), both whole on one card.
``--reduced`` runs any of them at the CPU-smoke width (window 64;
``--d-model``, 256 by default; 16 frontend rows).

Weights come from the port's seeded initialisation (``--seed``), as the
reference serves ``init_model`` weights.  Prompts are drawn from numpy
with the same seed.  The command line submits no frontend rows, as the
reference's launcher does, so the engine zero-fills a modality model's;
:func:`one_shot` takes each request's own rows from a caller.  Requests
go through :class:`~repro_torch.serving.ServingEngine` in batch-sized
waves, as ``ServingEngine.generate`` submits them, with every engine
step timed on the host clock: the first step of a wave prefills it and
emits its first tokens (time to first token), the others decode.
Without a visible GPU and without ``--device cpu`` it raises.

Live mode watches a snapshot directory that a trainer publishes into
(``python -m repro_torch.launch.train --publish-dir``) and hot-swaps the
model under traffic::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --watch-dir /tmp/snaps --requests 32

Requests then flow through the
:class:`~repro_torch.serving.InferenceServer` admission queue, every
completion reports the snapshot version it was decoded on, and in-flight
requests are never disturbed by a swap.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced as make_reduced
from repro_torch.convert import params_to_numpy
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import Model, init_model
from repro_torch.serving import (InferenceServer, Request, ServeConfig,
                                 ServingEngine, SnapshotWatcher)

__all__ = ["ServeRun", "main", "one_shot", "parse_args"]


@dataclasses.dataclass
class ServeRun:
    """What a one-shot run served and how fast (host clock, seconds)."""

    cfg: object
    model: Model
    engine: ServingEngine
    prompts: List[np.ndarray]
    outputs: List[np.ndarray]
    ttft_s: List[float]        # per wave: submit → first tokens emitted
    prefill_tokens: int
    decode_tokens: int
    decode_s: float            # steps after each wave's first
    wall_s: float
    embeds: Optional[List[np.ndarray]] = None   # each request's rows

    def stats(self) -> Dict[str, float]:
        """Time to first token, prefill and decode rates, wall."""
        ttft = sum(self.ttft_s)
        return {"requests": len(self.prompts),
                "new_tokens": sum(len(o) for o in self.outputs),
                "ttft_ms_mean": 1e3 * ttft / len(self.ttft_s),
                "prefill_tok_s": self.prefill_tokens / ttft,
                "decode_tok_s": (self.decode_tokens / self.decode_s
                                 if self.decode_s else float("nan")),
                "wall_s": self.wall_s}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The launcher's flags (the reference's, plus ``--device`` and
    ``--impl``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="one of " + ", ".join(sorted(ARCHS)))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256,
                    help="the width of --reduced (its head dim is "
                         "d_model // heads: dbrx-132b's 6 heads need 384 "
                         "for the card's kernels' hd 64)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="serve only the first N layers (a depth cut at "
                         "the arch's width, a multiple of its layer "
                         "pattern), e.g. gemma2-27b on one card")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512,
                    help="per-group cache capacity")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None,
                    help="top-k sampling cutoff (with --temperature > 0)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop decoding a request at this token id")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="kernels (cuda), plain versions (ref), or by "
                         "device (auto)")
    ap.add_argument("--watch-dir", default=None,
                    help="serve live: hot-swap snapshots published here")
    ap.add_argument("--poll-every", type=int, default=8,
                    help="live mode: poll --watch-dir every N decode ticks")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="live mode: per-request completion timeout (s)")
    return ap.parse_args(argv)


def _setup(a):
    """(cfg, seeded model on ``--device``, ServeConfig) of the flags."""
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu "
                           "to serve on the CPU")
    cfg = get_config(a.arch)
    if a.reduced:
        cfg = make_reduced(cfg, d_model=a.d_model)
    if a.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=a.n_layers)
    model = init_model(cfg, seed=a.seed, device=dev)
    scfg = ServeConfig(batch=a.batch, max_len=a.max_len,
                       max_new_tokens=a.max_new, temperature=a.temperature,
                       top_k=a.top_k, eos_id=a.eos_id, seed=a.seed)
    return cfg, model, scfg


def _serve_live(a) -> int:
    """Live mode: serve ``--requests`` random prompts through an
    :class:`~repro_torch.serving.InferenceServer` that hot-swaps the
    snapshots published in ``--watch-dir`` (starting from the newest one
    there, else the seeded model as version 0), and print the rates."""
    cfg, model, scfg = _setup(a)
    watcher = SnapshotWatcher(a.watch_dir, params_to_numpy(model), cfg,
                              model.embed.device)
    loaded = watcher.poll()
    version = 0
    if loaded is not None:
        model, version = loaded
        print(f"loaded snapshot v{version} from {a.watch_dir}")
    eng = ServingEngine(model, cfg, scfg, version=version, impl=a.impl)
    rng = np.random.default_rng(a.seed)
    t0 = time.perf_counter()
    with InferenceServer(eng, watcher=watcher,
                         poll_every=a.poll_every) as srv:
        futs = [srv.submit(Request(prompt=rng.integers(
            0, cfg.vocab_size, size=a.prompt_len).astype(np.int32)))
            for _ in range(a.requests)]
        comps = [f.result(timeout=a.timeout) for f in futs]
    dt = time.perf_counter() - t0
    total_new = sum(len(c.tokens) for c in comps)
    versions = sorted({c.snapshot_version for c in comps})
    print(f"arch={cfg.name} requests={a.requests} new_tokens={total_new} "
          f"wall={dt:.2f}s ({total_new / dt:.1f} tok/s) "
          f"swaps={srv.stats.swaps} versions={versions}")
    return 0


def one_shot(argv: Optional[List[str]] = None,
             embeds: Optional[List[np.ndarray]] = None) -> ServeRun:
    """Parse ``argv``, build the model and serve the requests once, each
    carrying its row of ``embeds`` (a modality model's ``(F, d_model)``
    frontend rows a request; zeros when None).  The prefill rate counts
    the positions prefilled: each prompt's tokens and its F rows."""
    a = parse_args(argv)
    cfg, model, scfg = _setup(a)
    if embeds is not None and len(embeds) != a.requests:
        raise ValueError(f"{a.requests} requests got {len(embeds)} "
                         "embeddings")
    dev = model.embed.device
    eng = ServingEngine(model, cfg, scfg, impl=a.impl)
    rng = np.random.default_rng(a.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=a.prompt_len)
               .astype(np.int32) for _ in range(a.requests)]

    results: Dict[int, np.ndarray] = {}
    ids: List[int] = []
    ttft, decode_s, decode_tokens = [], 0.0, 0
    t_start = time.perf_counter()
    for start in range(0, len(prompts), a.batch):
        t0 = time.perf_counter()
        ids += [eng.submit(Request(
            prompt=p, embed=None if embeds is None else embeds[start + i]))
            for i, p in enumerate(prompts[start:start + a.batch])]
        first = True
        while eng.has_pending():
            t1 = time.perf_counter()
            res = eng.step()      # ends in a copy of the tokens to the host
            t2 = time.perf_counter()
            if first:
                ttft.append(t2 - t0)
                first = False
            else:
                decode_s += t2 - t1
                decode_tokens += len(res.emitted)
            for c in res.completions:
                results[c.req_id] = c.tokens
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    return ServeRun(cfg=cfg, model=model, engine=eng, prompts=prompts,
                    outputs=[results[i] for i in ids], ttft_s=ttft,
                    prefill_tokens=a.requests * (a.prompt_len
                                                 + cfg.frontend_tokens),
                    decode_tokens=decode_tokens, decode_s=decode_s,
                    wall_s=wall, embeds=embeds)


def main(argv: Optional[List[str]] = None) -> int:
    """Serve once, or live with ``--watch-dir``, and print the rates."""
    a = parse_args(argv)
    if a.watch_dir:
        return _serve_live(a)
    run = one_shot(argv)
    st = run.stats()
    print(f"arch={run.cfg.name} device={run.engine.device} "
          + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in st.items()))
    for i, o in enumerate(run.outputs[:4]):
        print(f"  req{i}: {o[:12].tolist()}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
