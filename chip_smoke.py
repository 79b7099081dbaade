#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. Print the card's name and power limit; build every CUDA kernel of the
   port from ``src/repro_torch/kernels/csrc`` and print the build seconds.
2. Hold the fused tick kernel against its plain PyTorch version on the
   card: the nine static branch cases (5 chained ticks each, at three
   sizes) and the paper shape (B = 32, P = 1000, d = 1000, m = 8,
   β = 10), each tick run twice (``w`` and ``pulled`` updated in place,
   every other input left unwritten, the two runs bit for bit alike),
   and a tick in which every alive node finishes and starts at once (its
   residual must read the old view).  The control plane must match
   exactly; ``w``, ``pulled`` and ``pol_ema`` within rtol 1e-5, atol
   1e-6·max(1, max|plain|) (the kernel sums the gradient in another
   order).  Time the kernel and the plain version at the paper shape,
   with the split over the five launches and the host time per wrapper
   call, beside the in-place bound and that of a tick returning new
   views (``kernels.psp_tick.tick_bytes``).
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
5. Hold the RMSNorm, flash-attention and SSD-scan kernels against their
   plain versions on the card: RMSNorm over rows {1, 7, 2048, 4099} × D
   {64, 100, 896, 1536, 3072} × its two forms (``round_scale``; D 100 in
   bfloat16 takes the kernel's scalar path), and the scalar path once
   more on a row that is not 16-byte aligned; flash over {causal,
   + window 256, + softcap 50} × GQA {1, 7} × S {1, 37, 512, 1000} × hd
   {64, 128} (bfloat16 on the tensor cores, float32 on the CUDA cores);
   both in float32 (rtol 1e-5, atol 1e-6·max(1, max|plain|)) and
   bfloat16 (rtol / atol 2e-2).  Count the tensor-core instructions
   (``HGMMA``, ``HMMA``) in the built flash and SSD libraries' SASS
   (``cuobjdump -sass``): the bfloat16 flash kernel and both bfloat16
   SSD kernels must have some.  A bfloat16 flash call whose strides TMA
   cannot take must raise.  SSD over S {64, 128, 512} × groups {1, 2} of
   4 heads × N {64, 128} at hd 64, then ``SSD_EXTRA`` (the serving
   prefill, 32 chunks, a head tile that does not divide the group, hd 16
   with N and Q not multiples of 16), each × decay {slow: dt·A ∈ [−0.1,
   0]; model-like: dt = softplus(N(0, 0.8²)), A = −1}, in float32 (rtol
   1e-4, atol 1e-5·max(1, max|plain|), y and the final state) and
   bfloat16 (y rtol / atol 2e-2, the final state as in float32); S 1000
   must raise.  Time each at its serving shapes against its plain
   version and a library call (``rms_norm``,
   ``scaled_dot_product_attention``; none computes the SSD scan), flash
   and SSD also at a 4096-token prefill, beside its bound (the SSD with
   the split over its two launches and its time at each number of heads
   per output block); RMSNorm also beside a device copy of the same
   bytes.  Each is timed twice, in mirrored order, with the SM clock read
   before and after.
6. The qwen2-0.5b serving path: ``repro_torch.launch.serve`` serves it at
   full width with seeded random weights, bfloat16 (8 requests, batch
   4, prompt 512, max_len 1024, 64 new tokens, greedy), every kernel's
   launch count reset just before and read just after: flash must run
   24 times per prefill call, RMSNorm 49 times per prefill call and
   decode step, SSD never.  Prints time to first token, prefill and
   decode tokens/s; then a traced rerun of one wave with 16 new tokens,
   against the same wave unprofiled, gives the device's busy share;
   then the served tokens are teacher-forced through the model under
   ``impl="cuda"`` (its argmax must reproduce every served token) and
   ``impl="ref"``: per-step logits within 2e-2 of max |logit|, or within
   the plain path's own bf16 rounding error (its logits in bf16 against
   float32 compute) where that is larger; and on the same weights in
   float32 compute within 1e-4 at prefill and 5e-3 in decode.
7. The mamba2-780m serving path, as phase 6 with the same traffic: SSD
   must run 48 times per prefill call, RMSNorm 97 times per prefill call
   and decode step, flash never; the same teacher-forced checks.
8. PSP training of qwen2-0.5b at full width (494,032,768 f32 params,
   bf16 compute), built from the library calls ``repro_torch.launch.train``
   makes (``init_model``, ``adamw(warmup_cosine(3e-3, 3, 24))``,
   ``psp_init``, ``make_psp_train_step``): W 4, ``pbsp``, β 2, s 3,
   stragglers 0.25, 2 sequences of 512 tokens per worker per tick (drawn
   from a pool of 8 fixed random ones), 24 ticks.  Tick 0's per-worker
   losses and clipped gradients under the kernels against ``impl="ref"``
   on the same inputs: ‖Δg‖/‖g‖ within 2e-2 or the plain path's own
   spread between bf16 and float32 compute, whichever is larger (the
   loss likewise), and in float32 compute (the f32 kernels) ‖Δg‖/‖g‖
   within 1e-3 and the loss within 1e-5 relative; the control plane after tick 0 (step, pushed, alive,
   total_pushes, busy_until, now) bit for bit the plain trainer's; the
   launches exactly 2·24·W per tick for the flash forward (remat
   recomputes it), 24·W for its backward, 97·W for the RMSNorm forward
   and 49·W for its backward; the mean loss over the last 4 pushing ticks
   below that over the first 4.  Prints the wall per tick and training
   tokens/s over ticks 2..24 (their summed wall over their count, all
   their tokens over that wall; the median beside), the busy share of one traced tick with its ten largest
   device items and the device time of the two backward wrappers'
   kernels, peak device memory, and the wall and device time of a
   worker's loss and gradients (with and without remat), its forward
   and the AdamW update; then runs
   ``python -m repro_torch.launch.train --reduced --barrier pbsp --steps
   5`` on the card.

Phase 5 also holds the two backward kernels (flash attention's and
RMSNorm's) against their plain versions: flash over FLASH_MODES × G {1,
7} × S {1, 37, 64, 512, 1000} × hd {64, 128} × {float32, bfloat16} on
the plain forward's o and lse (float32 rtol 1e-4, atol 1e-5·max(1,
max|plain|); bfloat16 2e-2·max|plain|, but at S 1, where dq and dk are
exactly 0 and both versions return rounding noise, dq and dk at the
float32 tolerance), with the forward kernel's lse against the plain
one and its o unchanged by writing lse; the bfloat16 backward's two
tensor-core kernels must show ``HGMMA`` in their SASS, and a q off a
16-byte boundary must raise; RMSNorm over rows {7, 1024, 4099} × D {64, 100, 896,
3072, 12288} and an unaligned row (dx in bfloat16 within one bf16 ulp,
dw at the float32 tolerance); two runs of each bit for bit alike.  It
times them at the training shapes (flash backward B 2, S 512,
14 / 2 heads, hd 64, bf16 causal; RMSNorm backward (1024, 896) bf16)
against their plain versions and the backward of
``scaled_dot_product_attention`` / ``F.rms_norm`` through autograd, and
the flash forward with and without its lse output at the serving
prefill.

Then one JSON line with each kernel's launches (summed over the main
paths: the sweep, both serving runs and the training run), error and
times, the ``nvidia-smi`` line, and the result line.  Exits non-zero without a
result when no CUDA device is visible or the port's sources are missing.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor f32 FLOP/s
#: and dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
#: H100 L2 cache bytes: timed inputs rotate over more than twice this
L2_BYTES = 50 * 2 ** 20

EXACT = ("steps", "alive", "computing", "event_time", "ready", "blocked",
         "pend_leave", "pend_join", "pol_thr", "pol_beta", "fin", "start",
         "n_fin", "ctrl")
CASES = [  # (churn, ragged, k_max, adaptive): the tick's static branches
    (False, False, 0, False), (False, False, 1, False),
    (False, False, 3, False), (True, False, 2, False),
    (False, True, 2, False), (True, True, 2, False),
    (False, False, 0, True), (False, False, 3, True), (True, True, 2, True),
]
TICK_KERNELS = ("prologue_kernel", "decide_kernel", "resid_kernel",
                "grad_kernel", "finish_kernel")
#: phase 2's small (B, P, d, m) sizes (the paper shape follows); the
#: third takes the kernel's m <= 16 build and its views in three column
#: chunks, over two rounds of rows per node where every node finishes
TICK_SIZES = ((3, 8, 5, 4), (5, 300, 40, 8), (12, 70, 1100, 12))
FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")
FRACS = (0.0, 0.05, 0.1, 0.2, 0.3)

# phase 5's case grid (also run by tests/test_torch_cuda.py)
DTYPES = ("float32", "bfloat16")
RMS_ROWS = (1, 7, 2048, 4099)
RMS_DIMS = (64, 100, 896, 1536, 3072)  # 100: not a multiple of 8
ROUND_SCALE = (False, True)
FLASH_MODES = (("causal", {}), ("window256", {"window": 256}),
               ("softcap50", {"softcap": 50.0}))
FLASH_GQA = (1, 7)
FLASH_SEQ = (1, 37, 512, 1000)
FLASH_HEAD_DIMS = (64, 128)
#: phase 5's timed shapes: RMSNorm rows at d_model 896 (4 prompts of 512,
#: then a decode step of 4), flash (B, S) at 14 heads / 2 KV heads / hd 64
#: (the serving prefill, then a long one); the first of each goes into
#: the JSON line
RMS_TIMED_ROWS = (4 * 512, 4)
FLASH_TIMED = ((4, 512), (1, 4096))
SSD_SEQ = (64, 128, 512)
SSD_RAGGED = 1000          # not a multiple of the 128-step chunk: raises
SSD_GROUPS = (1, 2)        # of SSD_HEADS heads
SSD_HEADS = 4
SSD_STATES = (64, 128)
SSD_DECAYS = ("slow", "model")
#: SSD shapes beyond the product grid, each in both decays and dtypes:
#: (B, S, nh, ng, hd, N, chunk)
SSD_EXTRA = (
    (4, 512, 48, 1, 64, 128, 128),  # mamba2-780m's serving prefill
    (1, 4096, 8, 2, 64, 128, 128),  # 32 chunks
    (2, 512, 20, 1, 64, 128, 128),  # 20 heads: a last head tile of 2
    (2, 240, 6, 2, 16, 36, 48),     # hd 16; N and Q not multiples of 16
)
#: SSD's tolerance in float32: rtol, and atol as a share of max |plain|
SSD_F32 = (1e-4, 1e-5)
#: SSD's timed (B, S) at mamba2-780m's 48 heads, hd 64, N 128, one group
#: (the serving prefill, then a long one); the first goes into the line
SSD_TIMED = ((4, 512), (1, 4096))
SSD_KERNELS = ("scan_kernel", "out_kernel")
#: phase 5's backward grids: flash over FLASH_MODES × FLASH_GQA × these S
#: (1: a lone row; 64: exactly one tile; 37 and 1000 are not multiples of
#: the 64-row tile) × FLASH_HEAD_DIMS × DTYPES (at S 1 dq and dk are
#: exactly 0: see check_flash_bwd); RMSNorm over rows × D × DTYPES (D 64, 896, 3072
#: and 12288 take each vector count the launcher picks, 12288 the largest
#: D the wrapper takes; 100 the scalar path), then an unaligned row
FLASH_BWD_SEQ = (1, 37, 64, 512, 1000)
RMS_BWD_ROWS = (7, 1024, 4099)
RMS_BWD_DIMS = (64, 100, 896, 3072, 12288)
#: the bf16 backward's tensor-core kernels, whose SASS must show HGMMA
FLASH_BWD_TC = ("bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel")
#: the two backward wrappers' kernels, by name, as phase 8's traced tick
#: sums them
FLASH_BWD_KERNELS = ("bwd_delta_kernel", "bwd_dkdv", "bwd_dq",
                     "bwd_reduce_kernel")
RMS_BWD_KERNELS = ("bwd_rows_kernel", "bwd_cols_kernel")
#: the backward kernels' float32 tolerance: rtol, and atol as a share of
#: max(1, max |plain|)
BWD_F32 = (1e-4, 1e-5)
#: the training shapes the backward kernels are timed at: flash (B, S) at
#: 14 heads / 2 KV heads / hd 64, bf16 causal; RMSNorm (rows, D) bf16
FLASH_BWD_TIMED = (2, 512)
RMS_BWD_TIMED = (1024, 896)
#: phase 8: PSP training of full-width qwen2-0.5b (W workers, B sequences
#: of S tokens each per tick, drawn from a pool of POOL fixed sequences)
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_TICKS = 24
TRAIN_W, TRAIN_B, TRAIN_S, TRAIN_POOL = 4, 2, 512, 8
TRAIN_ARGV = ["--reduced", "--barrier", "pbsp", "--steps", "5"]
#: phases 6 and 7: qwen2-0.5b's and mamba2-780m's serving runs
TRAFFIC = ["--requests", "8", "--batch", "4", "--prompt-len", "512",
           "--max-len", "1024", "--max-new", "64", "--seed", "0"]
SERVE_ARGV = ["--arch", "qwen2-0.5b", *TRAFFIC]
#: new tokens of the one wave whose device busy share is traced
TRACE_NEW = 16
MAMBA_ARGV = ["--arch", "mamba2-780m", *TRAFFIC]


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


def identical(torch, a, b, what):
    """Raise unless the tensors of ``a`` and ``b`` are equal bit for bit."""
    for k, v in a.items():
        if not torch.equal(v, b[k]):
            raise AssertionError(f"{what}: {k} differs")


def check_tick_case(np, torch, pt, dev, case, B, P, d, m, n_ticks=5,
                    fully_alive=False, seed=0):
    """Hold the CUDA tick to its plain version over ``n_ticks`` chained
    ticks of one static branch case.

    Each tick the kernel runs twice on the same inputs, first on its
    chain's state with the plain params dict, then on a clone of that
    state with the staged :class:`TickParams`.  The first run must
    return its input's ``w`` and ``pulled`` (updated in place) and leave
    every other input unwritten; the two runs must agree bit for bit.
    Control plane exact against the plain version; data plane within
    :func:`compare`'s tolerance.  Returns (max data-plane error, the
    problem's (state, noise shapes, params, leave_n, join_n, static
    kwargs)).
    """
    from repro_torch.convert import tick_inputs_to_torch, to_torch
    churn, ragged, k_max, adaptive = case
    st, shapes, prm, ln, jn, masked = tick_problem(
        np, seed, B, P, churn, ragged, k_max, d, m, adaptive, fully_alive)
    kw = dict(k_max=k_max, has_churn=churn, masked=masked,
              adaptive=adaptive)
    s_r, _, p = tick_inputs_to_torch(st, {}, prm, dev)
    staged = pt.stage_params(p, adaptive=adaptive)
    s_k = {k: v.clone() for k, v in s_r.items()}     # the kernel's chain
    ln_t, jn_t = to_torch(ln, dev), to_torch(jn, dev)
    worst = 0.0
    for i in range(n_ticks):
        _, r, _ = tick_inputs_to_torch({}, draw(np, shapes, 100 + i), {},
                                       dev)
        t = float(np.float32(0.4 * (i + 1)))
        what = f"{case} at {(B, P, d, m)} tick {i}"
        s_2 = {k: v.clone() for k, v in s_k.items()}
        before = {k: v.clone() for k, v in (*s_k.items(), *r.items(),
                                            ("ln", ln_t), ("jn", jn_t))
                  if k not in ("w", "pulled")}
        ptrs = (s_k["w"].data_ptr(), s_k["pulled"].data_ptr())
        n_k, o_k = pt.psp_tick_cuda(s_k, r, p, t, ln_t, jn_t, **kw)
        n_2, o_2 = pt.psp_tick_cuda(s_2, r, staged, t, ln_t, jn_t, **kw)
        s_r, o_r = pt.psp_tick_ref(s_r, r, p, t, ln_t, jn_t, **kw)
        torch.cuda.synchronize()
        if (n_k["w"].data_ptr(), n_k["pulled"].data_ptr()) != ptrs:
            raise AssertionError(f"{what}: w and pulled were not updated "
                                 "in place")
        identical(torch, before, {**s_k, **r, "ln": ln_t, "jn": jn_t},
                  f"{what}: input written")
        identical(torch, n_k, n_2, f"{what}: second run, state")
        identical(torch, o_k, o_2, f"{what}: second run, out")
        worst = max(worst, compare(np, s_r, n_k, what),
                    compare(np, o_r, o_k, f"{what} out"))
        s_k = n_k
    return worst, (st, shapes, prm, ln_t, jn_t, kw)


def check_finish_start(np, torch, pt, dev, B, P, d, m, seed=3):
    """One tick in which every alive node finishes and starts
    (every row ASP, every node computing and due): each residual must
    read its node's old view before the pull overwrites it, so ``w`` is
    held to the plain version.  Returns the count of such nodes."""
    from repro_torch.convert import tick_inputs_to_torch, to_torch
    st, shapes, prm, ln, jn, masked = tick_problem(
        np, seed, B, P, False, False, 0, d, m)
    st["computing"][:] = True
    st["event_time"][:] = 0.0
    prm["horizon"][:] = 10.0
    prm.update(is_asp=np.ones(B, bool), full_view=np.zeros(B, bool),
               sampled=np.zeros(B, bool))
    kw = dict(k_max=0, has_churn=False, masked=masked)
    s, r, p = tick_inputs_to_torch(st, draw(np, shapes, 11), prm, dev)
    s_d = {k: v.clone() for k, v in s.items()}
    ln, jn = to_torch(ln, dev), to_torch(jn, dev)
    s_k, o_k = pt.psp_tick_cuda(s_d, r, p, 0.4, ln, jn, **kw)
    s_r, o_r = pt.psp_tick_ref(s, r, p, 0.4, ln, jn, **kw)
    torch.cuda.synchronize()
    both = int((o_k["fin"] & o_k["start"]).sum())
    if both != int(s["alive"].sum()) or both == 0:
        raise AssertionError(f"finish-and-start: {both} nodes of "
                             f"{int(s['alive'].sum())} alive")
    compare(np, s_r, s_k, f"finish-and-start at {(B, P, d, m)}")
    compare(np, o_r, o_k, f"finish-and-start at {(B, P, d, m)} out")
    return both


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


def rms_cases():
    """Phase 5's RMSNorm grid: (rows, D, dtype, round_scale)."""
    return itertools.product(RMS_ROWS, RMS_DIMS, DTYPES, ROUND_SCALE)


def flash_cases():
    """Phase 5's flash grid: ((mode, kwargs), GQA ratio, S, hd, dtype)."""
    return itertools.product(FLASH_MODES, FLASH_GQA, FLASH_SEQ,
                             FLASH_HEAD_DIMS, DTYPES)


def ssd_cases():
    """Phase 5's SSD grid: (B, S, nh, ng, hd, N, chunk, decay, dtype); the
    product of S × groups × N × decay × dtype at B 2, 4 heads, hd 64,
    then ``SSD_EXTRA`` × decay × dtype."""
    grid = [((2, S, SSD_HEADS, ng, 64, N, 128), d, dt)
            for S, ng, N, d, dt in itertools.product(
                SSD_SEQ, SSD_GROUPS, SSD_STATES, SSD_DECAYS, DTYPES)]
    grid += list(itertools.product(SSD_EXTRA, SSD_DECAYS, DTYPES))
    return [(*shape, d, dt) for shape, d, dt in grid]


def rms_inputs(np, torch, rows, D, dtype, dev, seed=0):
    """x (rows, D) in ``dtype`` and a float32 gain w (D,), from numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, D)) * 3).astype(np.float32)
    w = (1 + 0.5 * rng.normal(size=D)).astype(np.float32)
    return (torch.from_numpy(x).to(dev, getattr(torch, dtype)),
            torch.from_numpy(w).to(dev))


def flash_inputs(np, torch, B, S, H, KV, hd, dtype, dev, seed=0):
    """q (B, S, H, hd) and k, v (B, S, KV, hd) in ``dtype``, from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(
        np.float32)).to(dev, getattr(torch, dtype)) for n in (H, KV, KV))


def ssd_inputs(np, torch, B, S, nh, ng, hd, N, decay, dtype, dev, seed=0):
    """x (B, S, nh, hd), dt (B, S, nh), A (nh,), Bm, Cm (B, S, ng, N) from
    numpy: x, Bm, Cm in ``dtype``, dt and A float32.  ``decay`` "slow":
    dt ∈ [0, 0.1], A ∈ [−1, −0.5] (dt·A ∈ [−0.1, 0]: the state carries
    across chunks); "model": dt = softplus(N(0, 0.8²)), A = −1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd))
    if decay == "slow":
        dt = rng.uniform(0.0, 0.1, size=(B, S, nh))
        A = -rng.uniform(0.5, 1.0, size=nh)
    else:
        dt = np.logaddexp(rng.normal(0.0, 0.8, size=(B, S, nh)), 0.0)
        A = -np.ones(nh)
    Bm, Cm = (rng.normal(size=(B, S, ng, N)) for _ in range(2))
    td = getattr(torch, dtype)
    t = lambda a, d: torch.from_numpy(a.astype(np.float32)).to(dev, d)
    return (t(x, td), t(dt, torch.float32), t(A, torch.float32), t(Bm, td),
            t(Cm, td))


def check_close(np, got, want, dtype, what, f32=(1e-5, 1e-6)):
    """Max |got - want|; raises beyond the stated tolerance (float32:
    rtol ``f32[0]``, atol ``f32[1]``·max(1, max|want|), by default 1e-5
    and 1e-6; bfloat16: 2e-2 both)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    a = want.float().cpu().numpy().astype(np.float64)
    b = got.float().cpu().numpy().astype(np.float64)
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    rtol, atol = ((f32[0], f32[1] * scale) if dtype == "float32"
                  else (2e-2, 2e-2))
    err = float(np.abs(a - b).max(initial=0.0))
    if not np.allclose(b, a, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| {err}")
    return err


def tensor_core_sass(lib):
    """Counts of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) instructions in
    each kernel of the shared library ``lib`` (``cuobjdump -sass``)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += len(re.findall(rf"\b{op}\.", line))
    return counts


def unaligned(torch, x):
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


def rotating(tensors):
    """A function returning, call after call, the next of enough clones of
    ``tensors`` that cycling through them streams more than twice the L2
    cache (at most 64 clones), so a timed call reads its inputs from
    device memory as a cold caller would; and the number of clones."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = min(64, max(2, 2 * L2_BYTES // max(nbytes, 1) + 1))
    sets = [tuple(t.clone() for t in tensors) for _ in range(n)]
    it = itertools.cycle(sets)
    return lambda: next(it), n


def device_ms(torch, fn, n):
    """Device milliseconds per call of ``fn`` (all the kernels it runs,
    torch.profiler, asked twice: it has come back empty once in a run),
    or CUDA-event milliseconds per call if the profiler sees no device
    time; and which of the two it is."""
    busy = profile_device(torch, fn, n) or profile_device(torch, fn, n)
    if busy:
        return sum(busy.values()), "device"
    return time_calls(torch, fn, n), "events"


def sm_clock() -> str:
    """The card's SM clock, as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def timed_rounds(torch, fns):
    """Device milliseconds per call of each entry of ``fns`` (name →
    (fn, calls)), by :func:`device_ms`, in two rounds of mirrored order
    (A B C, then C B A), so that a drift of the card's clocks falls on
    every entry alike, after one untimed call of each (the first window
    of a cold card reads high while its clock ramps up).  Returns (name →
    (mean ms, (round 1, round 2), how), the SM clock before → after)."""
    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    before = sm_clock()
    got = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, calls = fns[name]
            got[name].append(device_ms(torch, fn, calls))
    return ({name: (sum(r[0] for r in runs) / 2, tuple(r[0] for r in runs),
                    runs[0][1]) for name, runs in got.items()},
            f"{before} → {sm_clock()}")


def rounds_text(ms) -> str:
    """``name mean ms (round 1 / round 2, how)`` for each timed entry."""
    return ", ".join(f"{k} {v[0]:.4f} ms ({v[1][0]:.4f} / {v[1][1]:.4f}, "
                     f"{v[2]})" for k, v in ms.items())


def phase5(np, torch, dev, card):
    """The RMSNorm and flash kernels against their plain versions over the
    case grid, then timed at the serving shapes.  Returns the two
    kernels' JSON entries without ``launches``."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref
    err_rms = 0.0
    for i, (rows, D, dt, rs) in enumerate(rms_cases()):
        x, w = rms_inputs(np, torch, rows, D, dt, dev, seed=i)
        err_rms = max(err_rms, check_close(
            np, rmsnorm_cuda(x, w, round_scale=rs),
            rmsnorm_ref(x, w, round_scale=rs), dt,
            f"rmsnorm rows={rows} D={D} {dt} round_scale={rs}"))
    for dt, rs in itertools.product(DTYPES, ROUND_SCALE):
        x, w = rms_inputs(np, torch, 7, 896, dt, dev, seed=99)
        xu = unaligned(torch, x)
        err_rms = max(err_rms, check_close(
            np, rmsnorm_cuda(xu, w, round_scale=rs),
            rmsnorm_ref(x, w, round_scale=rs), dt,
            f"rmsnorm unaligned {dt} round_scale={rs}"))
    print(f"[5] rmsnorm kernel == plain on {i + 1} cases and 4 unaligned "
          f"ones; max |err| {err_rms:.3g}", flush=True)
    err_fl = {dt: 0.0 for dt in DTYPES}
    for i, ((mode, kw), G, S, hd, dt) in enumerate(flash_cases()):
        q, k, v = flash_inputs(np, torch, 2, S, 2 * G, 2, hd, dt, dev, i)
        err_fl[dt] = max(err_fl[dt], check_close(
            np, flash_attention_cuda(q, k, v, causal=True, **kw),
            attention_ref(q, k, v, causal=True, **kw), dt,
            f"flash {mode} G={G} S={S} hd={hd} {dt}"))
    print(f"[5] flash kernel == plain on {i + 1} cases (bf16 on the tensor "
          "cores); max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err_fl.items()),
          flush=True)
    sass = tensor_core_sass(_build._target("flash_attention"))
    tc = {op: sum(c[op] for fn, c in sass.items() if "flash_tc_kernel" in fn)
          for op in ("HGMMA", "HMMA")}
    print("[5] flash library SASS: " + "; ".join(
        f"{fn[:60]}… HGMMA {c['HGMMA']}, HMMA {c['HMMA']}"
        for fn, c in sorted(sass.items())), flush=True)
    if not (tc["HGMMA"] or tc["HMMA"]):
        raise AssertionError("the bf16 flash kernel has no tensor-core "
                             f"instruction in its SASS: {tc}")
    q, k, v = flash_inputs(np, torch, 1, 64, 14, 2, 64, "bfloat16", dev)
    bad = torch.zeros(1, 64, 14 * 64 + 4, dtype=torch.bfloat16, device=dev)
    bad = bad[..., :14 * 64].unflatten(-1, (14, 64))  # seq stride 900
    bad.copy_(q)
    try:
        flash_attention_cuda(bad, k, v)
    except ValueError as e:
        print(f"[5] flash bf16 with seq stride 900 raises: {e}", flush=True)
    else:
        raise AssertionError("flash_attention_cuda took a bf16 q whose "
                             "strides TMA cannot describe")

    rms = []
    for rows in RMS_TIMED_ROWS:
        x, w = rms_inputs(np, torch, rows, 896, "bfloat16", dev, seed=1)
        w16 = w.to(torch.bfloat16)
        nxt, n_sets = rotating((x,))
        y = torch.empty_like(x)
        ms, clocks = timed_rounds(torch, {
            "kernel": (lambda: rmsnorm_cuda(nxt()[0], w, round_scale=True),
                       50),
            "plain": (lambda: rmsnorm_ref(nxt()[0], w, round_scale=True), 50),
            "library": (lambda: F.rms_norm(nxt()[0], (896,), w16, 1e-6), 50),
            "copy of x": (lambda: y.copy_(nxt()[0]), 50)})
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
        bound = 1e3 * nbytes / HBM_BPS
        print(f"[5] rmsnorm ({rows}, 896) bf16 (the model's form): "
              + rounds_text(ms) + f"; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.3f} MB); inputs rotated over {n_sets} "
              f"copies; SM clock {clocks} [{card}]", flush=True)
        rms.append((ms, bound))
    flash = []
    for B, S in FLASH_TIMED:
        q, k, v = flash_inputs(np, torch, B, S, 14, 2, 64, "bfloat16", dev)
        nxt, n_sets = rotating((q, k, v))
        sdpa = lambda q, k, v, **kw: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, **kw)
        try:
            sdpa(q, k, v, enable_gqa=True)
            lib = lambda: sdpa(*nxt(), enable_gqa=True)
        except TypeError:          # a torch without enable_gqa
            lib = lambda: sdpa(*(t.repeat_interleave(7, dim=2) if i else t
                                 for i, t in enumerate(nxt())))
        ms, clocks = timed_rounds(torch, {
            "kernel": (lambda: flash_attention_cuda(*nxt()), 20),
            "kernel + lse": (lambda: flash_attention_cuda(
                *nxt(), return_lse=True), 20),
            "plain": (lambda: attention_ref(*nxt()), 5),
            "library": (lib, 20)})
        flops = 2 * B * 14 * S * S * 64
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        t_ops, t_bytes = 1e3 * flops / BF16_TC_FLOPS, 1e3 * nbytes / HBM_BPS
        print(f"[5] flash B={B} S={S} H=14 KV=2 hd=64 bf16 causal: "
              + rounds_text(ms)
              + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} "
              f"GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
              f"{flops / ms['kernel'][0] / 1e9:.2f} TFLOP/s, library at "
              f"{flops / ms['library'][0] / 1e9:.2f}; inputs rotated over "
              f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
        flash.append((ms, t_ops, t_bytes))

    (ms, bound), (fms, t_ops, t_bytes) = rms[0], flash[0]
    return [{"name": "rmsnorm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "replaces": "src/repro/kernels/rmsnorm.py:26",
             "max_abs_err": err_rms, "ms": ms["kernel"][0],
             "plain_ms": ms["plain"][0], "bound_ms": bound,
             "bound_by": "bytes", "library_ms": ms["library"][0]},
            {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:92",
             "max_abs_err": max(err_fl.values()), "ms": fms["kernel"][0],
             "plain_ms": fms["plain"][0], "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": fms["library"][0]}]


def ssd_flops(B, S, nh, ng, hd, N, Q=128):
    """FLOPs the chunked dual form needs: per (batch, group, chunk) C·Bᵀ
    (2Q²N, shared by the group's heads); per (batch, head, chunk)
    scores·(x·dt) (2Q²hd), C·Hᵀ and the state update (2QN·hd each)."""
    Q = min(Q, S)
    return B * (S // Q) * (ng * 2 * Q * Q * N
                           + nh * (2 * Q * Q * hd + 4 * Q * N * hd))


def phase5_ssd(np, torch, dev, card):
    """The SSD kernels against their plain version over the case grid,
    the bfloat16 library's tensor-core instructions, then timed at
    mamba2-780m's serving shapes.  Returns its JSON entry without
    ``launches``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import scan_rows, ssd_cuda, ssd_ref
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = 0.0
    for i, (B, S, nh, ng, hd, N, chunk, decay, dt) in enumerate(ssd_cases()):
        args = ssd_inputs(np, torch, B, S, nh, ng, hd, N, decay, dt, dev,
                          seed=i)
        (y, h), (y_r, h_r) = ssd_cuda(*args, chunk), ssd_ref(*args, chunk)
        what = (f"ssd B={B} S={S} nh={nh} ng={ng} hd={hd} N={N} "
                f"chunk={chunk} {decay} {dt}")
        err = max(err, check_close(np, y, y_r, dt, what + " y", SSD_F32),
                  check_close(np, h, h_r, "float32", what + " h", SSD_F32))
    args = ssd_inputs(np, torch, 1, SSD_RAGGED, SSD_HEADS, 1, 64, 128,
                      "slow", "float32", dev)
    for fn in (ssd_cuda, ssd_ref):
        try:
            fn(*args)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took S={SSD_RAGGED}, which is "
                             "not a multiple of its 128-step chunk")
    print(f"[5] ssd kernel == plain on {i + 1} cases (y and final state; "
          f"bf16 on the tensor cores); max |err| {err:.3g}; S={SSD_RAGGED} raises in both",
          flush=True)
    sass = tensor_core_sass(_build._target("ssd_scan"))
    print("[5] ssd library SASS: " + "; ".join(
        f"{fn[:60]}… HGMMA {c['HGMMA']}, HMMA {c['HMMA']}"
        for fn, c in sorted(sass.items())), flush=True)
    for name in SSD_KERNELS:
        tc = [c["HGMMA"] + c["HMMA"] for fn, c in sass.items() if name in fn]
        if not tc or not all(tc):
            raise AssertionError(f"the bf16 ssd {name} has no tensor-core "
                                 f"instruction in its SASS: {sass}")

    timed = []
    for B, S in SSD_TIMED:
        nh, ng, hd, N = 48, 1, 64, 128
        x, dt, A, Bm, Cm = ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model",
                                      "bfloat16", dev)
        nxt, n_sets = rotating((x, dt, A, Bm, Cm))
        ms, clocks = timed_rounds(torch, {
            "kernel": (lambda: ssd_cuda(*nxt()), 20),
            "plain": (lambda: ssd_ref(*nxt()), 3)})
        split = {n: v for key, v in profile_device(
            torch, lambda: ssd_cuda(*nxt()), 20).items()
            for n in SSD_KERNELS if n in key}
        flops = ssd_flops(B, S, nh, ng, hd, N)
        nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
                  + A.numel() * 4 + 2 * Bm.numel() * Bm.element_size()
                  + B * nh * hd * N * 4)
        t_ops, t_bytes = 1e3 * flops / BF16_TC_FLOPS, 1e3 * nbytes / HBM_BPS
        print(f"[5] ssd B={B} S={S} nh={nh} hd={hd} N={N} ng={ng} bf16 "
              f"({scan_rows(B, nh, hd, sms)} state rows per scan block): "
              + rounds_text(ms)
              + "; per launch " + ", ".join(f"{n} {v:.4f} ms"
                                            for n, v in split.items())
              + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} "
              f"GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
              f"{flops / ms['kernel'][0] / 1e9:.2f} TFLOP/s; no library "
              f"call computes the scan; inputs rotated over {n_sets} copies;"
              f" SM clock {clocks} [{card}]", flush=True)
        timed.append((ms, t_ops, t_bytes))
    ms, t_ops, t_bytes = timed[0]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:72",
            "max_abs_err": err, "ms": ms["kernel"][0],
            "plain_ms": ms["plain"][0], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def flash_bwd_cases():
    """Phase 5's flash backward grid: ((mode, kwargs), GQA ratio, S, hd,
    dtype)."""
    return itertools.product(FLASH_MODES, FLASH_GQA, FLASH_BWD_SEQ,
                             FLASH_HEAD_DIMS, DTYPES)


def flash_bwd_sass(lib):
    """``HGMMA`` counts of the bf16 backward's tensor-core kernels
    (``FLASH_BWD_TC``) in the flash library ``lib``, summed over their
    instantiations; raises if either has none."""
    sass = tensor_core_sass(lib)
    counts = {name: sum(c["HGMMA"] for fn, c in sass.items() if name in fn)
              for name in FLASH_BWD_TC}
    if not all(counts.values()):
        raise AssertionError("a bf16 flash backward kernel has no HGMMA in "
                             f"its SASS: {counts}")
    return counts


def rms_bwd_cases():
    """Phase 5's RMSNorm backward grid: (rows, D, dtype)."""
    return itertools.product(RMS_BWD_ROWS, RMS_BWD_DIMS, DTYPES)


def bf16_ulp(np, a):
    """The spacing of bfloat16 values at magnitude ``a``."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def check_bwd(np, got, want, dtype, what):
    """Max |got - want| of a backward output; raises beyond float32 rtol
    ``BWD_F32[0]``, atol ``BWD_F32[1]``·max(1, max|want|), or in bfloat16
    beyond 2e-2·max|want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    a = want.float().cpu().numpy().astype(np.float64)
    b = got.float().cpu().numpy().astype(np.float64)
    top = float(np.abs(a).max(initial=0.0))
    rtol, atol = ((BWD_F32[0], BWD_F32[1] * max(1.0, top))
                  if dtype == "float32" else (0.0, 2e-2 * top))
    err = float(np.abs(a - b).max(initial=0.0))
    if not np.allclose(b, a, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| {err} (max |plain| {top})")
    return err


def check_flash_bwd(np, torch, case, dev, seed):
    """One flash backward case: the kernel against ``attention_bwd_ref``
    on the same q, k, v, do and the plain forward's o and lse, two
    kernel runs bit for bit alike; and the forward kernel's lse against
    the plain one (float32 rtol 1e-5; bfloat16, whose softmax runs on
    exp2.approx, 1e-3) with its o bit for bit the o of a call without
    lse.  Returns the max |err| of dq, dk, dv."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_ref, flash_attention_bwd_cuda,
        flash_attention_cuda)
    (mode, kw), G, S, hd, dt = case
    q, k, v = flash_inputs(np, torch, 2, S, 2 * G, 2, hd, dt, dev, seed)
    do = flash_inputs(np, torch, 2, S, 2 * G, 2, hd, dt, dev,
                      seed + 1000)[0]
    what = f"flash bwd {mode} G={G} S={S} hd={hd} {dt}"
    o, lse = attention_ref(q, k, v, causal=True, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ")
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=True, **kw)
    # At S 1 each query sees one key: p = 1 and dp = Δ, so dq and dk are
    # exactly 0 (float64 says so) and both versions return float32
    # rounding noise, summed in different orders.  A bound relative to
    # max |plain| cannot hold between two noises, so there dq and dk are
    # held at the float32 tolerance, whose atol has an absolute floor;
    # dv (= do) keeps the bfloat16 one.
    err = max(check_bwd(np, g, w, "float32" if S == 1 and n != "dv" else dt,
                        f"{what} {n}")
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    ko, klse = flash_attention_cuda(q, k, v, causal=True, return_lse=True,
                                    **kw)
    if not torch.equal(ko, flash_attention_cuda(q, k, v, causal=True, **kw)):
        raise AssertionError(f"{what}: o with lse differs from o without")
    tol = 1e-5 if dt == "float32" else 1e-3
    lerr = float((klse - lse).abs().max())
    if not lerr <= tol * max(1.0, float(lse.abs().max())):
        raise AssertionError(f"{what}: forward lse off by {lerr}")
    return err


def check_rms_bwd(np, torch, rows, D, dt, dev, seed, shift=False):
    """One RMSNorm backward case: the kernel against ``rmsnorm_bwd_ref``
    on the same x, w, g and the plain forward's m (``shift``: x and g one
    element past a 16-byte boundary), two runs bit for bit alike.
    float32: dx and dw at ``BWD_F32``; bfloat16: dx within one bf16 ulp
    of the larger of |dx| and its rounded term |cast(coeff)·x| (the
    kernel sums the row's inner product in another order, which can
    round ``cast(coeff)`` the other way), dw at ``BWD_F32`` (the same m:
    the rows' ``cast(g·m)`` are equal).  Returns max |err| of dx, dw."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_ref, rmsnorm_ref)
    x, w = rms_inputs(np, torch, rows, D, dt, dev, seed=seed)
    g, _ = rms_inputs(np, torch, rows, D, dt, dev, seed=seed + 1000)
    if shift:
        x, g = unaligned(torch, x), unaligned(torch, g)
    what = f"rmsnorm bwd rows={rows} D={D} {dt}" + (" unaligned" * shift)
    _, m = rmsnorm_ref(x, w, round_scale=True, return_m=True)
    dx, dw = rmsnorm_bwd_cuda(x, w, g, m)
    dx2, dw2 = rmsnorm_bwd_cuda(x, w, g, m)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"{what}: two runs differ")
    rdx, rdw = rmsnorm_bwd_ref(x, w, g, m)
    err_w = check_bwd(np, dw, rdw, "float32", f"{what} dw")
    if dt == "float32":
        return max(check_bwd(np, dx, rdx, dt, f"{what} dx"), err_w)
    a = rdx.float().cpu().numpy()
    b = dx.float().cpu().numpy()
    xf, gf = x.float(), g.float()
    coeff = (m[:, None] ** 3 / D) * (gf * w).to(x.dtype).float().mul(
        xf).sum(-1, keepdim=True)
    term = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                      (coeff * xf).abs().cpu().numpy())
    err = float(np.abs(a - b).max())
    if not (np.abs(a - b) <= bf16_ulp(np, term)).all():
        raise AssertionError(f"{what} dx: beyond one bf16 ulp, max |diff| "
                             f"{err}")
    return max(err, err_w)


def phase5_bwd(np, torch, dev, card):
    """The two backward kernels against their plain versions over their
    case grids, then timed at the training shapes.  Returns their JSON
    entries without ``launches``."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_ref, flash_attention_bwd_cuda)
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_ref, rmsnorm_ref)
    err_fl = {dt: 0.0 for dt in DTYPES}
    for i, case in enumerate(flash_bwd_cases()):
        err_fl[case[-1]] = max(err_fl[case[-1]],
                               check_flash_bwd(np, torch, case, dev, i))
    print(f"[5] flash backward kernel == plain on {i + 1} cases, two runs "
          "bit for bit alike, forward lse == plain; max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err_fl.items()),
          flush=True)
    counts = flash_bwd_sass(_build._target("flash_attention"))
    print("[5] flash backward SASS: " + ", ".join(
        f"{name} HGMMA {n}" for name, n in counts.items()), flush=True)
    q, k, v = flash_inputs(np, torch, 1, 64, 14, 2, 64, "bfloat16", dev)
    o, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    try:
        flash_attention_bwd_cuda(unaligned(torch, q), k, v, o, lse, q)
    except ValueError as e:
        print(f"[5] flash backward with q off a 16-byte boundary raises: {e}",
              flush=True)
    else:
        raise AssertionError("flash backward took a q off a 16-byte "
                             "boundary")
    err_rms = {dt: 0.0 for dt in DTYPES}
    cases = [(*c, False) for c in rms_bwd_cases()]
    cases += [(7, 896, dt, True) for dt in DTYPES]
    for i, (rows, D, dt, shift) in enumerate(cases):
        err_rms[dt] = max(err_rms[dt], check_rms_bwd(
            np, torch, rows, D, dt, dev, seed=i, shift=shift))
    print(f"[5] rmsnorm backward kernel == plain on {len(cases)} cases "
          "(2 unaligned), two runs bit for bit alike; max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err_rms.items()),
          flush=True)

    B, S = FLASH_BWD_TIMED
    q, k, v = flash_inputs(np, torch, B, S, 14, 2, 64, "bfloat16", dev)
    do = flash_inputs(np, torch, B, S, 14, 2, 64, "bfloat16", dev, 1)[0]
    o, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    nxt, n_sets = rotating((q, k, v, o, lse, do))
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
    except TypeError:              # a torch without enable_gqa
        leaves = [t if i == 0 else t.repeat_interleave(7, dim=1)
                  .detach().requires_grad_(True)
                  for i, t in enumerate(leaves)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    dout = do.transpose(1, 2)
    ms, clocks = timed_rounds(torch, {
        "kernel": (lambda: flash_attention_bwd_cuda(*nxt()), 20),
        "plain": (lambda: attention_bwd_ref(*nxt()), 5),
        "library": (lambda: torch.autograd.grad(out, leaves, dout,
                                                retain_graph=True), 20)})
    flops = 5 * B * 14 * S * S * 64          # 5 causal products of S·S·hd
    nbytes = (sum(t.numel() * t.element_size() for t in (q, k, v, o, lse,
                                                          do))
              + sum(t.numel() * t.element_size() for t in (q, k, v)))
    t_ops, t_bytes = 1e3 * flops / BF16_TC_FLOPS, 1e3 * nbytes / HBM_BPS
    print(f"[5] flash backward B={B} S={S} H=14 KV=2 hd=64 bf16 causal "
          f"(the training shape; {24 * TRAIN_W} calls per tick): "
          + rounds_text(ms)
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} GFLOP "
          f"at the bf16 tensor-core rate, {nbytes / 1e6:.2f} MB); kernel at "
          f"{flops / ms['kernel'][0] / 1e9:.2f} TFLOP/s, library (SDPA "
          f"backward through autograd) at "
          f"{flops / ms['library'][0] / 1e9:.2f}; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    fl = {"name": "flash_attention_bwd", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
          "replaces": "src/repro/models/flash.py:240",
          "max_abs_err": max(err_fl.values()), "ms": ms["kernel"][0],
          "plain_ms": ms["plain"][0], "bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "library_ms": ms["library"][0]}

    rows, D = RMS_BWD_TIMED
    x, w = rms_inputs(np, torch, rows, D, "bfloat16", dev, seed=1)
    g, _ = rms_inputs(np, torch, rows, D, "bfloat16", dev, seed=2)
    _, m = rmsnorm_ref(x, w, round_scale=True, return_m=True)
    nxt, n_sets = rotating((x, w, g, m))
    xl = x.detach().requires_grad_(True)
    wl = w.to(torch.bfloat16).requires_grad_(True)
    y = F.rms_norm(xl, (D,), wl, 1e-6)
    ms, clocks = timed_rounds(torch, {
        "kernel": (lambda: rmsnorm_bwd_cuda(*nxt()), 50),
        "plain": (lambda: rmsnorm_bwd_ref(*nxt()), 50),
        "library": (lambda: torch.autograd.grad(y, (xl, wl), g,
                                                retain_graph=True), 50)})
    nbytes = (3 * x.numel() * x.element_size() + m.numel() * 4
              + 2 * D * 4)
    bound = 1e3 * nbytes / HBM_BPS
    print(f"[5] rmsnorm backward ({rows}, {D}) bf16 (the training shape; "
          f"{49 * TRAIN_W} calls per tick): " + rounds_text(ms)
          + f"; bound {bound:.4f} ms ({nbytes / 1e6:.3f} MB); library: "
          f"F.rms_norm's backward through autograd; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    rn = {"name": "rmsnorm_bwd", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
          "replaces": "src/repro/models/layers.py:58",
          "max_abs_err": max(err_rms.values()), "ms": ms["kernel"][0],
          "plain_ms": ms["plain"][0], "bound_ms": bound, "bound_by": "bytes",
          "library_ms": ms["library"][0]}
    return [fl, rn]


def teacher_force(np, torch, model, toks, prompt_len, max_len, impl):
    """Per-step logits (steps, B, V) of ``toks`` (B, prompt + new) fed
    through prefill and decode steps, as the engine feeds a group."""
    from repro_torch.models import decode_step, prefill
    dev = model.embed.device
    t = torch.from_numpy(np.ascontiguousarray(toks)).to(dev)
    logits, cache = prefill(model, t[:, :prompt_len].to(torch.int32),
                            max_len=max_len, impl=impl)
    steps = [logits]
    for j in range(prompt_len, toks.shape[1] - 1):
        logits, cache = decode_step(model, cache, t[:, j:j + 1], impl=impl)
        steps.append(logits)
    return torch.stack(steps)


def serve_phase(np, torch, dev, card, argv, tag):
    """A serving path on the card, printed as phase ``tag``: serve
    ``argv`` through ``repro_torch.launch.serve`` with every model
    kernel's launch count reset just before and read just after, trace a
    rerun, and teacher-force the served tokens.  Returns the launch counts
    by kernel name."""
    from repro_torch.kernels import (flash_attention as fa, rmsnorm as rn,
                                     ssd_scan as ss)
    from repro_torch.launch import serve
    from repro_torch.models import Model, init_model
    t_phase = time.perf_counter()
    a = serve.parse_args(argv)
    kernels = {"flash_attention": fa, "rmsnorm": rn, "ssd_scan": ss}
    torch.cuda.synchronize()
    for m in kernels.values():
        m.reset_launch_count()
    run = serve.one_shot(argv)
    got = {name: m.launch_count() for name, m in kernels.items()}
    eng, cfg = run.engine, run.cfg
    # per prefill call: one flash launch per attn layer, one SSD launch
    # per ssd layer; per forward: two RMSNorms per layer and the final one
    forwards = eng.prefill_calls + eng.decode_steps
    per = {"flash_attention": (cfg.layer_kinds().count("attn"),
                               eng.prefill_calls),
           "rmsnorm": (2 * cfg.n_layers + 1, forwards),
           "ssd_scan": (cfg.layer_kinds().count("ssd"), eng.prefill_calls)}
    want = {name: n * k for name, (n, k) in per.items()}
    if got != want:
        raise AssertionError(f"launches {got}, want {want}")
    for o in run.outputs:
        if not (len(o) == a.max_new and (o >= 0).all()
                and (o < cfg.vocab_size).all()):
            raise AssertionError(f"malformed completion {o}")
    st = run.stats()
    print(f"[{tag}] served {cfg.name} ({cfg.n_layers} layers, d="
          f"{cfg.d_model}, "
          f"{sum(p.numel() for p in run.model.parameters()) / 1e6:.1f}M "
          f"params, {cfg.dtype}): {st['requests']} requests, "
          f"{st['new_tokens']} new tokens, {eng.prefill_calls} prefill calls"
          f", {eng.decode_steps} decode steps; launches "
          + ", ".join(f"{name} {got[name]} = {n} × {k}"
                      for name, (n, k) in per.items())
          + f" [{card}]", flush=True)
    print(f"[{tag}] time to first token {st['ttft_ms_mean']:.3f} ms (mean of "
          f"{len(run.ttft_s)} waves: {[round(1e3 * t, 3) for t in run.ttft_s]}"
          f"), prefill {st['prefill_tok_s']:.1f} tok/s, decode "
          f"{st['decode_tok_s']:.1f} tok/s ({run.decode_tokens} tokens in "
          f"{run.decode_s:.4f} s), wall {st['wall_s']:.4f} s [{card}]",
          flush=True)

    # the busy share of one wave of TRACE_NEW tokens (a prefill and its
    # decode steps): tracing the whole run costs minutes of profiler time
    # at mamba2's ≈ 3600 launches per forward
    wave = [*argv, "--requests", str(a.batch), "--max-new", str(TRACE_NEW)]
    wall_ms = 1e3 * serve.one_shot(wave).wall_s
    init = profile_device(torch, lambda: init_model(cfg, seed=0, device=dev))
    traced = profile_device(torch, lambda: serve.one_shot(wave))
    if traced:
        busy = sum(traced.values()) - sum(init.values())
        print(f"[{tag}] traced rerun of one wave ({a.batch} requests, "
              f"{TRACE_NEW} new tokens): "
              f"device busy {busy:.3f} ms of the same wave's unprofiled "
              f"{wall_ms:.3f} ms serving wall (weight init's "
              f"{sum(init.values()):.3f} ms taken out): busy share "
              f"{busy / wall_ms:.4f}, idle share {1 - busy / wall_ms:.4f}; "
              f"{time.perf_counter() - t_phase:.1f} s into the phase "
              f"[{card}]", flush=True)
        for key, ms in sorted(traced.items(), key=lambda kv: -kv[1])[:10]:
            print(f"[{tag}]   {ms:9.3f} ms  {key[:90]}", flush=True)
    else:
        print(f"[{tag}] traced rerun: the profiler saw no device time; the "
              "busy share is not measured", flush=True)

    # teacher-forced checks, per wave: the kernel path must reproduce the
    # served tokens; the plain path (impl="ref") is held to it in the
    # served bf16 compute and, on the same weights, in float32 compute
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), run.model.tree())
    rel = lambda a, b: ((a - b).abs().amax((1, 2))
                        / a.abs().amax((1, 2))).cpu().numpy()
    bf16, floor, f32 = [], [], []
    agree = 0
    for w in range(0, len(run.prompts), a.batch):
        toks = np.stack([np.concatenate([run.prompts[i], run.outputs[i]])
                         for i in range(w, min(w + a.batch,
                                               len(run.prompts)))])
        tf = lambda m, impl: teacher_force(np, torch, m, toks, a.prompt_len,
                                           a.max_len, impl)
        ker, ref = tf(run.model, "cuda"), tf(run.model, "ref")
        served = torch.from_numpy(toks[:, a.prompt_len:].T.copy()).to(dev)
        if not torch.equal(ker.argmax(-1), served):
            raise AssertionError("teacher-forced kernel logits do not "
                                 "reproduce the served tokens")
        agree += served.numel()
        ref32 = tf(m32, "ref")
        bf16.append(rel(ker, ref))
        floor.append(rel(ref32, ref))
        f32.append(rel(tf(m32, "cuda"), ref32))
    bf16, floor, f32 = (np.stack(x) for x in (bf16, floor, f32))
    # float32: the bounds of tests/test_torch_transformer.py (prefill 1e-4;
    # decode 5e-3, as the bf16 caches can round a last-bit change apart)
    if not (f32[:, 0].max() <= 1e-4 and f32[:, 1:].max() <= 5e-3):
        raise AssertionError(f"float32 compute: impl=ref logits differ by "
                             f"{f32[:, 0].max()} at prefill, "
                             f"{f32[:, 1:].max()} in decode")
    # bfloat16: 2e-2 of max |logit|, or the plain path's own bf16 rounding
    # error (bf16 against float32 compute) where that is larger
    bound = max(2e-2, float(floor.max()))
    if not bf16.max() <= bound:
        raise AssertionError(f"bf16 compute: impl=ref logits differ by "
                             f"{bf16.max()} of max |logit| > {bound}")
    print(f"[{tag}] teacher-forced: kernel logits reproduce all {agree} "
          "served "
          f"tokens; impl=ref per-step logits, as a share of max |logit|: "
          f"bf16 max {bf16.max():.4g} (median {np.median(bf16):.4g}, "
          f"prefill max {bf16[:, 0].max():.4g}; bound {bound:.4g}: 2e-2 or "
          f"the plain path's bf16 rounding error, max {floor.max():.4g}, "
          f"median {np.median(floor):.4g}); float32 compute prefill "
          f"{f32[:, 0].max():.3g} (bound 1e-4), decode "
          f"{f32[:, 1:].max():.3g} (bound 5e-3); "
          f"{time.perf_counter() - t_phase:.1f} s into the phase", flush=True)
    return got


def train_batches(torch, dev, vocab, ticks, seed=0):
    """Per tick, each worker's ``TRAIN_B`` sequences, drawn (seeded) from
    a pool of ``TRAIN_POOL`` fixed random sequences of ``TRAIN_S`` tokens,
    so that a model can learn them: a list of int32 (W, B, S)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool = torch.randint(0, vocab, (TRAIN_POOL, TRAIN_S), generator=gen,
                         device=dev, dtype=torch.int32)
    idx = torch.randint(0, TRAIN_POOL, (ticks, TRAIN_W, TRAIN_B),
                        generator=gen, device=dev)
    return [pool[idx[t]] for t in range(ticks)]


#: the control plane compared between the kernel and plain trainers
CONTROL = ("step", "pushed", "alive", "total_pushes", "busy_until", "now")


def tree_rel(torch, got, want):
    """‖got − want‖ / ‖want‖ over all leaves of two trees (float64)."""
    from repro_torch.tree import tree_leaves
    num = den = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        num += float((a.double() - b.double()).square().sum())
        den += float(b.double().square().sum())
    return math.sqrt(num / den)


def phase8(np, torch, dev, card):
    """PSP training of full-width qwen2-0.5b on the card, built from the
    library calls that ``repro_torch.launch.train`` makes; see the module
    docstring.  Returns the model kernels' launch counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.core.spmd_psp import (GeneratorNoise, PSPConfig,
                                           psp_init)
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    from repro_torch.launch.steps import make_grad_fn, make_psp_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(TRAIN_ARCH)
    ticks, W = TRAIN_TICKS, TRAIN_W
    opt = adamw(warmup_cosine(3e-3, ticks // 10 + 1, ticks))
    params = init_model(cfg, seed=0, device=dev).tree()
    n_params = sum(p.numel() for p in tree_leaves(params))
    pcfg = PSPConfig(barrier="pbsp", n_workers=W, sample_size=2,
                     staleness=3, straggler_frac=0.25)
    batches = train_batches(torch, dev, cfg.vocab_size, ticks + 1)

    def trainer(impl):
        noise = GeneratorNoise(1, dev)
        return (psp_init(pcfg, params, opt.init, noise),
                make_psp_train_step(cfg, pcfg, opt, noise, impl=impl))

    # (a) the first tick's per-worker losses and (clipped) gradients: the
    # kernels against the plain path in bf16 compute, beside the plain
    # path's own spread between float32 and bf16 compute; and the kernels
    # against the plain path in float32 compute (the f32 kernels), where
    # rounding is not amplified past a tight bound
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fns = {"cuda": make_grad_fn(cfg, 1.0, "cuda"),
           "ref": make_grad_fn(cfg, 1.0, "ref"),
           "ref32": make_grad_fn(cfg32, 1.0, "ref"),
           "cuda32": make_grad_fn(cfg32, 1.0, "cuda")}
    errs = []
    for i in range(W):
        got = {k: fn(params, batches[0][i]) for k, fn in fns.items()}
        (lk, gk), (lr, gr), (l32, g32), (lk32, gk32) = (got[k] for k in fns)
        errs.append((abs(float(lk) - float(lr)), abs(float(l32) - float(lr)),
                     tree_rel(torch, gk, gr), tree_rel(torch, gr, g32),
                     abs(float(lk32) - float(l32)) / abs(float(l32)),
                     tree_rel(torch, gk32, g32)))
        del got, gk, gr, g32, gk32
    errs = np.array(errs)
    bound = max(2e-2, float(errs[:, 3].max()))
    print(f"[8] tick 0, per worker (W={W}): |loss kernels − plain| "
          f"{errs[:, 0].max():.4g} (plain bf16 − f32: {errs[:, 1].max():.4g});"
          f" ‖g kernels − g plain‖/‖g plain‖ {errs[:, 2].max():.4g} against "
          f"the plain path's ‖g bf16 − g f32‖/‖g f32‖ "
          f"{errs[:, 3].max():.4g} (bound {bound:.4g}: 2e-2 or that "
          f"spread); in float32 compute, loss {errs[:, 4].max():.3g} "
          f"relative (bound 1e-5), ‖Δg‖/‖g‖ {errs[:, 5].max():.3g} (bound "
          "1e-3)", flush=True)
    if not (errs[:, 2].max() <= bound
            and errs[:, 0].max() <= max(2e-2, errs[:, 1].max())
            and errs[:, 4].max() <= 1e-5 and errs[:, 5].max() <= 1e-3):
        raise AssertionError(f"kernel and plain tick 0 differ: {errs}")

    # (b) one tick on the plain path: its control plane
    st, step = trainer("ref")
    st, _ = step(st, batches[0])
    ctrl_ref = {f: getattr(st, f).clone() for f in CONTROL}
    del st, step

    # (c) the main path: TICK ticks through the kernels
    torch.cuda.synchronize()
    for m in (fa, rn):
        m.reset_launch_count()
    st, step = trainer("auto")
    walls, losses, pushes = [], [], []
    for t in range(ticks):
        t0 = time.perf_counter()
        st, met = step(st, batches[t])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(met["loss"])
        pushes.append(met["pushes"])
        if t == 0:
            ctrl = {f: getattr(st, f).clone() for f in CONTROL}
    got = {"flash_attention": fa.launch_count(),
           "flash_attention_bwd": fa.bwd_launch_count(),
           "rmsnorm": rn.launch_count(), "rmsnorm_bwd": rn.bwd_launch_count(),
           "ssd_scan": 0}
    L = cfg.n_layers
    per = {"flash_attention": 2 * L, "flash_attention_bwd": L,
           "rmsnorm": 2 * 2 * L + 1, "rmsnorm_bwd": 2 * L + 1, "ssd_scan": 0}
    want = {k: n * W * ticks for k, n in per.items()}
    if got != want:
        raise AssertionError(f"training launches {got}, want {want}")
    for f in CONTROL:
        if not torch.equal(ctrl[f], ctrl_ref[f]):
            raise AssertionError(f"control plane {f} differs after tick 0:"
                                 f" {ctrl[f]} vs {ctrl_ref[f]}")
    losses = [float(x) for x in losses]
    pushes = [int(x) for x in pushes]
    pushed = [lo for lo, p in zip(losses, pushes) if p > 0]
    first, last = np.mean(pushed[:4]), np.mean(pushed[-4:])
    if not (len(pushed) >= 8 and all(map(math.isfinite, losses))
            and last < first):
        raise AssertionError(f"the loss did not fall: {losses}, pushes "
                             f"{pushes}")
    steady = walls[1:]
    wall = sum(steady) / len(steady)
    tokens = W * TRAIN_B * TRAIN_S
    print(f"[8] PSP training of {cfg.name} at full width ({L} layers, d="
          f"{cfg.d_model}, {n_params:,} params f32, {cfg.dtype} compute): "
          f"W={W} pbsp beta=2 s=3 stragglers 0.25, {TRAIN_B}×{TRAIN_S} "
          f"tokens per worker per tick, {ticks} ticks; launches "
          + ", ".join(f"{k} {got[k]} = {per[k]} × {W} × {ticks}"
                      for k in per if per[k]) + f" [{card}]", flush=True)
    print(f"[8] loss per tick {[round(x, 4) for x in losses]}; pushes "
          f"{pushes}; mean over the first 4 pushing ticks {first:.4f}, "
          f"over the last 4 {last:.4f}; control plane after tick 0 == the "
          "plain path's", flush=True)
    median = 1e3 * float(np.median(steady))
    print(f"[8] wall per tick {1e3 * wall:.2f} ms (ticks 2..{ticks}: their"
          f" summed wall over their count; median {median:.2f} ms, first "
          f"tick {1e3 * walls[0]:.2f} ms), training "
          f"{tokens / wall:.1f} tokens/s (their {tokens * len(steady)} "
          f"tokens over their summed wall); peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} "
          f"GB [{card}]", flush=True)

    # (d) the device busy share of one traced tick, against an unprofiled
    # tick's wall
    box = {"st": st}

    def one_tick():
        box["st"], _ = step(box["st"], batches[ticks])
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    one_tick()
    tick_ms = 1e3 * (time.perf_counter() - t0)
    traced = profile_device(torch, one_tick)
    if traced:
        busy = sum(traced.values())
        print(f"[8] traced tick: device busy {busy:.3f} ms of an unprofiled "
              f"tick's {tick_ms:.3f} ms wall: busy share "
              f"{busy / tick_ms:.4f}, idle share {1 - busy / tick_ms:.4f} "
              f"[{card}]", flush=True)
        for key, ms in sorted(traced.items(), key=lambda kv: -kv[1])[:10]:
            print(f"[8]   {ms:9.3f} ms  {key[:90]}", flush=True)
        for what, names in (("flash", FLASH_BWD_KERNELS),
                            ("rmsnorm", RMS_BWD_KERNELS)):
            ms = sum(v for key, v in traced.items()
                     if any(n in key for n in names))
            print(f"[8] traced tick: the {what} backward's kernels "
                  f"{ms:.3f} ms, {ms / busy:.4f} of the device time",
                  flush=True)
    else:
        print("[8] traced tick: the profiler saw no device time; the busy "
              "share is not measured", flush=True)
    del box, st, step

    # (e) where a tick's host time goes: one worker's loss and clipped
    # gradients as trained (remat on), the same without remat, its
    # forward alone, and the AdamW update, each on the host clock ending
    # in a synchronize, beside the device time torch.profiler sees
    from repro_torch.models import loss_fn
    tok = batches[0][0]
    grads = make_grad_fn(cfg, 1.0, "cuda")(params, tok)[1]
    ostate = opt.init(params)

    def forward():
        with torch.no_grad():
            loss_fn(params, {"tokens": tok}, cfg, impl="cuda")

    parts = {"worker loss+grad (remat)":
             lambda: make_grad_fn(cfg, 1.0, "cuda")(params, tok),
             "worker loss+grad (no remat)":
             lambda: make_grad_fn(dataclasses.replace(cfg, remat=False),
                                  1.0, "cuda")(params, tok),
             "worker forward": forward,
             "AdamW update": lambda: opt.update(grads, ostate, params)}
    split = []
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0)
        dev_ms = sum(profile_device(torch, fn).values())
        split.append(f"{name} {host:.2f} ms wall / {dev_ms:.2f} ms device")
    print("[8] one worker's pieces: " + "; ".join(split) + f" [{card}]",
          flush=True)
    del grads, ostate

    # (f) the launcher itself, reduced, on the card
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *TRAIN_ARGV], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    if run.returncode != 0 or "tick" not in run.stdout:
        raise AssertionError(f"launch.train {TRAIN_ARGV} failed "
                             f"({run.returncode}): {run.stderr[-2000:]}")
    print(f"[8] python -m repro_torch.launch.train {' '.join(TRAIN_ARGV)}: "
          f"{run.stdout.strip().splitlines()[-1]}; "
          f"{time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)
    return got


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
    from repro_torch.convert import tick_inputs_to_torch
    from repro_torch.core import SimConfig, make_barrier, run_sweep
    from repro_torch.core.vector_sim import VectorSimulator
    from repro_torch.core.vector_sim_torch import ticks_to_run
    from repro_torch.kernels import _build, psp_tick as pt

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"[1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all(verbose=True)
    print(f"[1] built {sorted(secs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 2. kernel against the plain version ---------------------------- #
    for size in TICK_SIZES:
        for case in CASES:
            check_tick_case(np, torch, pt, dev, case, *size)
        fs = check_finish_start(np, torch, pt, dev, *size)
        print(f"[2] kernel == plain on all 9 branch cases at (B, P, d, m) = "
              f"{size}, 5 chained ticks, w and pulled updated in place, "
              f"other inputs unwritten, two runs bit for bit alike; {fs} "
              "nodes finishing and starting in one tick", flush=True)
    B, P, d, m, beta = 32, 1000, 1000, 8, 10
    err, (st, shapes, prm, ln, jn, kw) = check_tick_case(
        np, torch, pt, dev, (False, False, beta, False), B, P, d, m,
        fully_alive=True)
    fs = check_finish_start(np, torch, pt, dev, B, P, d, m)
    print(f"[2] kernel == plain at the paper shape (B, P, d, m, beta) = "
          f"{(B, P, d, m, beta)}, 5 chained ticks, in place, two runs bit "
          f"for bit alike; data-plane max |err| {err:.3g}; {fs} nodes "
          "finishing and starting in one tick", flush=True)

    s, _, p = tick_inputs_to_torch(st, {}, prm, dev)
    staged = pt.stage_params(p, adaptive=False)
    _, r, _ = tick_inputs_to_torch({}, draw(np, shapes, 7), {}, dev)
    s_k = {k: v.clone() for k, v in s.items()}    # w, pulled: in place
    tick = dict(rand=r, t=0.8, leave_n=ln, join_n=jn, **kw)
    kernel = lambda: pt.psp_tick_cuda(s_k, params=staged, **tick)
    ref = lambda: pt.psp_tick_ref(s, params=p, **tick)
    ms_call = time_calls(torch, kernel, 50)
    ms_plain = time_calls(torch, ref, 20)
    split = {n: ms for key, ms in profile_device(torch, kernel, 20).items()
             for n in TICK_KERNELS if n in key}
    ms_dev = sum(split.values()) or None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kernel()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    _, o = kernel()
    n_fin, n_start = int(o["fin"].sum()), int(o["start"].sum())
    n_cand_sm = int(((~s["computing"]) & p["sampled"][:, None]).sum())
    nbytes = {c: sum(pt.tick_bytes(s, r, p, o["fin"], o["start"],
                                   in_place=c)) for c in (True, False)}
    flops = 4 * n_fin * m * d + 2 * 2 * n_cand_sm * P
    bound = 1e3 * max(nbytes[True] / HBM_BPS, flops / F32_FLOPS)
    bound_fresh = 1e3 * max(nbytes[False] / HBM_BPS, flops / F32_FLOPS)
    ms_kernel = ms_dev if ms_dev is not None else ms_call
    print(f"[2] paper-shape tick, in place: kernels {ms_kernel:.4f} ms "
          f"({'profiler device time' if ms_dev else 'CUDA events'}; "
          f"{ms_call:.4f} ms per wrapper call with events), plain "
          f"{ms_plain:.4f} ms; bound {bound:.4f} ms "
          f"({nbytes[True] / 1e6:.1f} MB: {n_fin} of {B * P} slots finish, "
          f"{n_start} start; {flops / 1e9:.3f} GFLOP); the fresh-output "
          f"contract's bound {bound_fresh:.4f} ms "
          f"({nbytes[False] / 1e6:.1f} MB) [{card}]", flush=True)
    print("[2] per launch: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())
          + f"; host {host_us:.1f} us per wrapper call", flush=True)

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
        print("[3]   tick kernels per tick: " + ", ".join(
            f"{n} {sum(ms for k, ms in busy.items() if n in k) / launches:.4f}"
            " ms" for n in TICK_KERNELS), flush=True)
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

    # ---- 5. RMSNorm, flash attention and SSD against their plain versions #
    print(f"[5] starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    entries = (phase5(np, torch, dev, card)
               + [phase5_ssd(np, torch, dev, card)]
               + phase5_bwd(np, torch, dev, card))

    # ---- 6. and 7. the serving paths: qwen2-0.5b, then mamba2-780m ----- #
    paths = []
    for tag, argv in ((6, SERVE_ARGV), (7, MAMBA_ARGV)):
        print(f"[{tag}] starts at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        paths.append(serve_phase(np, torch, dev, card, argv, tag))

    # ---- 8. PSP training of qwen2-0.5b --------------------------------- #
    print(f"[8] starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    paths.append(phase8(np, torch, dev, card))
    print(f"[8] ends at {time.perf_counter() - t_start:.1f} s", flush=True)
    for e in entries:
        e["launches"] = sum(n.get(e["name"], 0) for n in paths)

    print(json.dumps({"kernels": [{
        "name": "psp_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/psp_tick.cu",
        "replaces": "src/repro/kernels/psp_tick.py:862",
        "launches": launches, "max_abs_err": err, "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound, "bound_by":
            "bytes" if nbytes[True] / HBM_BPS >= flops / F32_FLOPS
            else "operations",
        "library_ms": None}, *entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
