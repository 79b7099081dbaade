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
   views (``kernels.psp_tick.tick_bytes``).  Then rows too long for the
   kernel's shared-memory staging (``TICK_LONG``: B 2, P 60,000, d 8,
   m 2; the decisions read the row from global memory, the pull lists
   its starters in tiles) on four branch cases (``LONG_CASES``, 3
   chained ticks) and a tick in which every node finishes and starts.
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
   + window 256, + softcap 50, + both} × GQA {1, 7} × S {1, 37, 512,
   1000} × hd {64, 80, 128} (bfloat16 on the tensor cores, hd 80 in the
   hd-128 tiling; float32 on the CUDA cores), and the same modes and S at
   hd 256 × GQA {1, 10} (recurrentgemma-2b's MQA; two consumer
   warpgroups), and at hd 128 × GQA {8, 6} (qwen3-moe-30b-a3b's 32 / 4
   heads, dbrx-132b's 48 / 8);
   both in float32 (rtol 1e-5, atol 1e-6·max(1, max|plain|)) and
   bfloat16 (rtol / atol 2e-2).  Count the tensor-core instructions
   (``HGMMA``, ``HMMA``) in the built flash and SSD libraries' SASS
   (``cuobjdump -sass``): the bfloat16 flash kernel's instantiation for
   each hd (256 too) must have ``HGMMA``, both bfloat16 SSD kernels some.  A
   bfloat16 flash call whose strides TMA cannot take must raise.  SSD
   over S {64, 128, 512} × groups {1, 2} of
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
   full width, its depth cut to ``SERVE_LAYERS`` = 12 of 24 (whole before
   phase 18 came), with seeded random weights, bfloat16 (8 requests,
   batch 4, prompt 512, max_len 1024, 64 new tokens, greedy), every
   kernel's launch count reset just before and read just after: flash
   must run 12 times per prefill call, RMSNorm 25 times per prefill
   call and decode step, SSD never.  Prints time to first token, prefill and
   decode tokens/s; then a traced rerun of one wave with 16 new tokens,
   against the same wave unprofiled, gives the device's busy share;
   then the served tokens are teacher-forced through the model under
   ``impl="cuda"`` (its argmax must reproduce every served token) and
   ``impl="ref"``: per-step logits within 2e-2 of max |logit|, or within
   the plain path's own bf16 rounding error (its logits in bf16 against
   float32 compute) where that is larger; and on the same weights in
   float32 compute within 1e-4 at prefill and 5e-3 in decode.
7. The mamba2-780m serving path, as phase 6 with the same traffic, at
   full width with its depth cut to ``MAMBA_SERVE_LAYERS`` = 6 of 48
   layers (24 before phase 17 came, 12 before phase 18; cut so that the
   script keeps inside its time limit with them): SSD must run once per
   layer per prefill call, RMSNorm 2·L + 1 times per prefill call and
   decode step, flash never; the same teacher-forced checks.
8. PSP training of qwen2-0.5b at full width, its depth cut to
   ``TRAIN_LAYERS`` = 6 of 24 layers (12 before phase 17 came;
   225,609,856 f32 params, bf16 compute; phase 9 trains as many), built
   from the library calls ``repro_torch.launch.train``
   makes (``init_model``, ``adamw(warmup_cosine(3e-3, 2, 16))``,
   ``psp_init``, ``make_psp_train_step``): W 4, ``pbsp``, β 2, s 3,
   stragglers 0.25, 2 sequences of 512 tokens per worker per tick (drawn
   from a pool of 8 fixed random ones), 16 ticks (24 before phase 17).
   Tick 0's per-worker
   losses and clipped gradients under the kernels against ``impl="ref"``
   on the same inputs: ‖Δg‖/‖g‖ within 2e-2 or the plain path's own
   spread between bf16 and float32 compute, whichever is larger (the
   loss likewise), and in float32 compute (the f32 kernels) ‖Δg‖/‖g‖
   within 1e-3 and the loss within 1e-5 relative; the control plane after tick 0 (step, pushed, alive,
   total_pushes, busy_until, now) bit for bit the plain trainer's; the
   launches exactly 2·L·W per tick for the flash forward (remat
   recomputes it, L the layers), L·W for its backward, (4L + 1)·W for the
   RMSNorm forward and (2L + 1)·W for its backward; the mean loss over the
   last 4 pushing ticks
   below that over the first 4.  Prints the wall per tick and training
   tokens/s over ticks 2..24 (their summed wall over their count, all
   their tokens over that wall; the median beside), the busy share of one traced tick with its ten largest
   device items and the device time of the two backward wrappers'
   kernels, peak device memory, and the wall and device time of a
   worker's loss and gradients (with and without remat), its forward
   and the AdamW update.  Its reduced launcher runs
   (``LAUNCHER_RUNS``: ``repro_torch.launch.train --barrier pbsp`` with
   ``--ckpt-dir`` and ``--publish-dir``, then the same with
   ``--resume`` and ``repro_torch.launch.serve --watch-dir`` on its
   snapshots) run in phase 19's lanes.
9. The trainer → bus → live server loop at full width, qwen2-0.5b's
   depth cut to ``LOOP_LAYERS`` = 12 of 24 (whole before phase 18
   came).  A fresh child interpreter (``chip_smoke.py --loop-trainer
   DIR``) trains it as phase 8 does for 6 ticks (8 before phase 18) and
   publishes its f32 server params through ``SnapshotPublisher``
   (version 0 first, then every 2 ticks, keep 2; the last one
   blocking); meanwhile an ``InferenceServer`` over a bf16
   ``ServingEngine`` (batch 4, max_len 1024, polling its
   ``SnapshotWatcher`` every 4 steps) serves waves of 4 greedy requests
   of 512 random tokens and 64 new ones: at least 16, and more (up to
   48) until they span two versions with a swap landing while requests
   are in flight.  Every version is read from disk as it appears; the
   server's loaded leaves must equal it bit for bit, and each completion
   is teacher-forced on the version it reports (its decode group's
   blocks admitted at their recorded clocks): every served token
   reproduced.  Launches exact: the server's flash and RMSNorm forwards,
   the trainer's four kernels as phase 8 counts them.  Prints the
   trainer's wall per tick with publishing on, a snapshot's bytes and
   the seconds per publication, the swaps, ``swap_stall``, time to first
   token and decode tokens/s.
10. Kill-and-resume at full width, depth cut to 2 layers: 6 straight
    PSP ticks against 3 ticks, a blocking ``CheckpointManager`` save,
    every device tensor dropped, ``launch.train.restore_psp`` into a
    fresh template and 3 more ticks; every leaf of the final state
    (params, AdamW moments, views, control plane) and the noise
    generator's state equal bit for bit.  Prints the bytes and the save
    and restore seconds.
11. The multi-process cluster (``launch.cluster.run_cluster``) on the
    card runs in phase 19 (c), the chaos suite's faulted run, with this
    phase's checks: exactly the victim respawned (epoch 1) and rejoined,
    and the recorded events replayed through ``external_drive`` on the
    card giving its final params bit for bit (before phase 19 came: its
    own run of the ``kill-one`` plan, 30 ticks at d = 1000, a 0.75 s
    floor).
12. PSP training of mamba2-780m at full width, its depth cut to
    ``MAMBA_TRAIN_LAYERS`` = 6 of 48 layers (12 before phase 17 came;
    165,096,288 f32 params, bf16 compute, remat on), as phase 8 trains
    qwen2-0.5b: the same PSP settings, token pool and 16 ticks, the same
    checks (tick 0
    against the plain path; also leaf by leaf, each leaf's max |Δg| over
    its max |g|: in bf16 compute within the largest such deviation that
    bf16 rounding gives a leaf of the plain path against float32
    compute, or 2e-2; in float32 compute within 1e-3; the control plane;
    the loss falling) and the same report, with the SSD backward's share
    of the traced tick's device time.  Launches exact per tick: the SSD
    forward 2·L·W (remat recomputes it), its backward L·W, RMSNorm
    (4L + 1)·W and its backward (2L + 1)·W.
    ``repro_torch.launch.train --arch mamba2-780m --reduced --barrier
    pbsp`` runs on the card at the end of phase 18.

13. The rest of the paper (``repro_torch.bench``) on the card.  (a)
    Every figure of the harness (``bench.run.BENCHES`` but the sweep
    benchmark: Figs 1a–1e, 1c's β sweep, the Fig 1 bands (one
    ``run_sweep`` per seed), 2a–2c, 3, 4 with its empirical lags, 5) at
    the paper's scale (P 1000, d 1000, β 10, 40 s; Fig 3 P 100–1000),
    each with its derived line; the kernel's launches must equal the
    ticks the figures' sweeps run.  It prints the paper's Fig 1 and
    Fig 2 orderings at that scale (``paper_orderings``; a finding, not
    a check).  (b) Figs 1–2 at the reduced scale (55 rows, P 200, d 100,
    20 s) on the card and on the numpy backend: mean progress within
    0.2·p + 1 and final error within a factor of two, row by row.  (c)
    ``bench.sweep_bench`` at its default scale with its horizon cut to
    ``SWEEP_BENCH_DURATION`` = 2.5 s (5 before phase 21 came, 20 before
    phase 19) (the Fig 2
    matrix of nine barriers × five fractions, P 100, d 32, through the
    event
    engine, numpy, the plain tick and the kernel, and the 100,000-node
    pair), every row printed and written to
    ``results/BENCH_sweep_torch.json``.  (d) The 100k pair under
    ``PSP_TICK_IMPL=cuda`` and ``ref``: integer traces equal, errors
    within rtol 1e-4.  (e) One kernel tick at the 100k shape (B 2, P
    100,000, d 4, m 2, β 1) held to the plain version over 3 chained
    ticks and timed beside its bound, as phase 2 times the paper shape.

14. The sliding-window and local/global decoders (``LOCAL_SERVE``), each
    served as phase 6 serves qwen2-0.5b, with the same checks (exact
    launches: flash once per attention layer, ``attn`` or ``local``, per
    prefill call; RMSNorm two per layer, four with gemma2's post-norms,
    and the final one per forward; every served token teacher-forced;
    the plain path's logits within phase 6's bounds) and, for models with
    ``local`` layers, the ring check (``ring_check``: every local layer's
    ring after a prefill holds position p at slot p % w, bit for bit):
    qwen1.5-4b at full width cut to 4 of its 40 layers (MHA of 20 heads
    with QKV bias at hd 128, untied unembedding) on phase 6's traffic;
    h2o-danube-1.8b at full width cut to 4 of its 24 layers (window
    4096, hd 80, 32 / 8 heads) at max_len 8192 on 4 requests of 6144
    random tokens + 64 new (the prefill rolls the ring, decode wraps it),
    then 4 of 1024 + 64 (a ring padded with zeros); gemma2-27b at full
    width cut to 2 layers (one local / global pair; fused QKV, both
    softcaps, post-norms, the gemma norm, GeGLU, ``embed_scale``) on
    danube's first wave.  (qwen1.5-4b and danube were served whole and
    gemma2 at 8 layers before phase 16 came, qwen1.5-4b and danube at
    12 layers before phase 17, 6 and gemma2 4 before phase 18: cut so
    that the script keeps inside its time limit with them.)  Then
    h2o-danube-1.8b at full width cut to 2 layers (8 before phase 15
    came, 4 before phase 18, cut so that the script keeps inside its
    time limit with the later phases) trained under PSP as phase 8
    trains qwen2 (W 4, ``pbsp``, β 2, s 3, stragglers 0.25) for 8 ticks
    on AdamW with
    ``warmup_cosine(3e-3, 3, 8)``, 2 sequences of 6144 tokens per worker
    per tick (past the window: the flash backward runs the band), with
    phase 8's checks (the loss falling over the first and last two
    pushing ticks).

15. recurrentgemma-2b (``RGEMMA_SERVE``) served as phase 14 serves
    danube, at full width with its depth cut to ``RGEMMA_SERVE_LAYERS`` =
    5 of 26 (whole before phase 17 came, 14 before phase 18; one (R, R,
    A) group and the (R, R) tail; 1,048,686,080 params; d 2560, 10 query
    heads on one KV head of 256, window 2048, GeGLU, the gemma norm) at
    max_len 8192 on 4 requests of 4096 random tokens + 64 new (the
    prefill rolls the ring twice, decode wraps it), then 4 of 1024 + 64
    (a zero-padded ring); launches exact: flash 1 per prefill call and
    never in decode, the RG-LRU scan 4 per prefill call and per decode
    step, RMSNorm 11 per forward, SSD never; every served token
    teacher-forced, the plain path within phase 6's bounds, the ring
    check on its local layer.

16. recurrentgemma-2b at full width cut to 5 layers (one (R, R, A)
    group and the (R, R) tail: 1,048,686,080 params) trained under PSP
    as phase 14 trains danube (W 4, ``pbsp``, β 2, s 3, stragglers 0.25,
    8 ticks, AdamW on ``warmup_cosine(3e-3, 3, 8)``), 2 sequences of
    2560 tokens per worker per tick (4096 before phase 18 came; past the
    window of 2048: the flash backward runs the band at hd 256, and the
    RG-LRU backward 40 tiles of the sequence), with phase 8's checks and
    tick 0 also leaf by leaf as phase 12 holds mamba2; launches exact, a
    worker a tick: flash 2 and its backward 1, the RG-LRU scan 8 and its
    backward 4, RMSNorm 21 and its backward 11; ``launch.train --arch
    recurrentgemma-2b --reduced`` runs on the card at the end of phase
    18.

17. The MoE decoders (``MOE_SERVE``), each served as phase 6 serves
    qwen2-0.5b on its traffic at the config's capacity factor 1.25:
    qwen3-moe-30b-a3b at full width cut to 3 of its 48 layers (12
    before phase 18 came; 128 experts, top 8, 32 / 4 heads of 128;
    2,491,693,056 params) and
    dbrx-132b at full width cut to 1 of its 40 (2 before phase 18; 16
    experts, top 4, 48 / 8 heads of 128; 4,492,216,320 params).
    Launches exact (flash once per layer per prefill call, RMSNorm
    2·L + 1 per forward); the first MoE
    layer's device time split into route, dispatch, experts and combine
    at the prefill's and a decode step's token counts
    (``moe_split``); every served token reproduced by the kernel path
    at the served factor; then phase 6's checks (``teacher_checks``) at
    the capacity factor E / k (16, 4), under which no token can drop
    (checked from the routes), as the reference's decode-consistency
    test runs at a factor without drops (8.0 at its reduced 4 experts,
    top 2), each comparison on one routing
    (``repro_torch.models.moe.routing``: the plain path on the kernel
    path's experts, the plain path's bf16 rounding error on the float32
    path's), and a whole-sequence pass on its incremental run's experts
    within 2e-2 of prefill + decode in float32 compute, or of the plain
    path's own such spread where larger; a traced wave.  Then
    qwen3-moe-30b-a3b at full width cut to 1 layer (1,245,452,288
    params) trained under PSP as phase 16 trains recurrentgemma, but at
    W 2, β 1 (W 4 would not fit), 8 ticks of 2 × 512 tokens a worker,
    tick 0 also leaf by leaf and on one routing as above, with the top-k
    sets either side would have picked differently counted.  The four
    reduced launchers, ``launch.train`` and ``launch.serve`` of both
    (dbrx-132b at ``--d-model 384``: its reduced 6 heads at the default
    256 are of hd 42, which the flash kernel does not take), run at the
    end of phase 18.

18. The frontend models (``FRONTEND_SERVE``), each served whole, at
    full width and full depth, on phase 6's traffic, every request
    carrying its own seeded N(0, 1) frontend rows through
    ``ServingEngine.submit(Request(embed=…))`` (``launch.serve.one_shot``
    with ``embeds``), rows that differ between the waves: internvl2-2b
    (24 layers, 16 / 8 heads of 128, untied 92,553-token unembedding,
    256 rows a request: a prefill of 256 + 512 positions;
    1,889,146,880 params) and musicgen-large (48 layers, 32 / 32 heads
    of 64 in one fused ``wqkv``, sinusoidal positions, the GELU MLP, 64
    rows; 2,424,506,368 params).  Launches exact (flash once per layer
    per prefill call, RMSNorm 2·L + 1 per forward); each wave after the
    first served again alone with its rows through a fresh engine's
    ``generate``, its tokens those of the run (the reference's
    ``test_per_wave_embeds``); phase 6's checks (``teacher_checks``) on
    the same rows, each prefill's clock F + 512; a traced wave.  Then
    internvl2-2b's ``loss_fn`` with frontend rows at full width cut to 2
    layers (B 2, 256 rows + 512 tokens; ``frontend_loss``): one forward
    and backward under the kernels against ``impl="ref"``, the loss and
    the gradients (the tree and each leaf) within 2e-2 or the plain
    path's own bf16 − float32 spread, in float32 compute within 1e-5
    and 1e-3; then musicgen-large at full width cut to 8 of its 48
    layers trained under PSP as phase 16 trains recurrentgemma (W 4,
    ``pbsp``, β 2, s 3, stragglers 0.25, 8 ticks of 2 × 512 tokens a
    worker, tokens only as both trainers feed them), tick 0 also leaf by
    leaf.  The reduced launchers of phases 12, 16, 17 and this one
    (``REDUCED_LAUNCHERS``, ``launch.train`` and ``launch.serve`` of both
    frontend models among them: the serving launcher submits no rows,
    the engine zero-fills them) run in phase 19's lanes.
19. The reference's remaining entry points (``repro_torch.bench``'s
    churn, serve and chaos benchmarks, ``repro_torch.examples``).  (d)
    starts first: child interpreters in lanes run side by side
    (``phase19_lanes``; a lane's runs one after another), each of the
    five examples through ``chip_smoke.py --example`` (its ``main``,
    its kernels' launch counts written at its exit): ``serve_demo``,
    ``train_e2e --steps 60``, ``barrier_sweep`` (stage 2 at 60 ticks a
    barrier), ``live_serve --smoke``, ``elastic_train`` to a checkpoint
    at tick 150, then ``--resume`` to 300; with phase 8's launcher runs
    and the reduced launchers.  Each must exit 0 with its output holding
    what it must; together the examples must launch flash, its
    backward, RMSNorm, its backward, the SSD scan and the tick.  Beside
    them (a): ``bench.churn_bench.elastic_churn`` at its default scale
    (9 policies × churn / stragglers, 300 ticks, W 8, d 32), then
    ``fig6_adaptive_churn`` from its cache: the schema, finite errors,
    leaves and joins in every churn run, each run's final error below
    its first; then ``CHURN_REPLAY``'s runs, one record of a seeded
    ``GeneratorNoise``'s draws and of the minibatches replayed through
    ``ReplayNoise`` on the card and on the CPU: the control plane after
    every tick bit for bit, the error trace within rtol 1e-5, atol
    1e-6; the scoreboard printed (a finding, not a check).  Then, alone:
    (b) the serve benchmark's body (``bench.serve_bench.open_loop``) at
    qwen2-0.5b's full width cut to ``SERVE_LAYERS`` (bf16) on the
    reference's default load (32 requests at 4 a second, batch 4, prompt
    12, 16 new, polling every 4 steps) with two full-width snapshots
    published mid-stream: at least 2 swaps, 2 versions served, none
    dropped, launches exact (flash once per layer per prefill call,
    RMSNorm 2·L + 1 per forward, the warm-up's included); tokens/s, the
    three latency pairs and each swap's stall printed.  (c) The chaos
    benchmark's two segments at ``chaos_suite(smoke=True)``'s shapes on
    the card, the cluster's tick floor raised to ``CHAOS_TICK_MIN_WALL``
    (a respawned worker took 10.9–14.4 s from the kill to its first
    push on an NVIDIA H100 80GB HBM3 at 700 W, past the smoke shape's
    6.4 s after the kill): the reference's exit invariants and phase
    11's checks.
20. The roofline on the card (``phase20``).  (a) For each of
    ``ROOF_COMBOS`` (qwen2-0.5b's prefill_32k and train_4k,
    recurrentgemma-2b's prefill_32k, mamba2-780m's decode_32k; full
    width and depth, the global batch cut to fit one card): the dry
    run's count of the step at the cut shape
    (``repro_torch.launch.dryrun.count_step`` on ``meta``, never timed),
    then the same step (``launch.steps.dryrun_inputs``, seeded random
    weights, ``impl="cuda"``) run on the card: once to warm up, then
    ``reps`` times by CUDA events with the launch counts and the peak
    memory reset just before.  Printed: the roofline's terms, the best
    and mean step times, the share max(compute, memory) / best, the peak
    device memory against the predicted argument and output bytes, and
    the launches against reps × the count's calls.  The share must be at
    most ``ROOF_SHARE_MAX`` (1.05: above it the count left work out),
    the peak at least the argument bytes, the launches equal.  (b)
    ``bench.roofline_bench.sweep_tick_row`` on the card at the
    reference's default shape and at the paper's (B 32, P 1000, d 1000,
    m 8, β 10): the tick's roofline time over the measured sweep at most
    1.05.
21. The device mesh over ``torch.distributed`` (``phase21``).  (a) A
    one-rank NCCL group in this process (``file://`` rendezvous): phase
    4's 5 s configs through ``run_sweep(..., mesh=(1, 1))``, every
    collective called (the server models gathered over ``rows`` each
    supertick, the traces at the end): steps, errors, server updates,
    total updates and control messages bit for bit phase 4's ``cuda``
    run, the tick's launches equal to the ticks.  (b) ``DIST_RANKS``
    gloo ranks sharing the card, spawned children
    (``repro_torch.launch.mesh.spawn_host_world``): which calls gloo
    takes on CUDA tensors (it must take every call the collectives
    make); the same sweep on the meshes (1, 2) (node-sharded: the
    gathered CUDA tick) and (2, 1), each rank's traces bit for bit
    (a)'s and its tick launches equal to the ticks; qwen2-0.5b at full
    width cut to 2 layers trained under PSP with one worker a rank (W 2,
    ``pbsp``, β 1, 3 ticks of 2 × 512 tokens), its state, views and
    metrics bit for bit those of the same run on one rank in the same
    child; qwen3-moe-30b-a3b at full width cut to 1 layer, its experts
    split over ``model`` 2 (64 a rank, placed by the rules through
    ``convert.expert_slice``), a bf16 prefill of 2 × 256 tokens
    replaying the one-device run's recorded routing: the MoE layer's y
    within ``DIST_MOE_Y_TOL`` (2⁻⁶) of max |y| and the logits within
    ``DIST_MOE_TOL`` (5e-2) of max |logit| of the one-device path's, the
    ranks' kept (token, choice) pairs disjoint and together the
    one-device path's; then with the sum over ``model`` left out (a
    planted fault), where y must fail its bound.  Printed: each part's seconds, the world and
    backend, each rank's collective calls and launches.

Phase 5 also holds the three backward kernels (flash attention's,
RMSNorm's and the SSD scan's) against their plain versions: flash over
FLASH_MODES × G {1, 7} × S {1, 37, 64, 512, 1000} × hd {64, 80, 128} ×
{float32, bfloat16}, and at hd 256 over FLASH_MODES × G {1, 10} × those
S and window 2048 at S 2200, on
the plain forward's o and lse (float32 rtol 1e-4, atol 1e-5·max(1,
max|plain|); bfloat16 2e-2·max|plain|, but at S 1, where dq and dk are
exactly 0 and both versions return rounding noise, dq and dk at the
float32 tolerance), with the forward kernel's lse against the plain
one and its o unchanged by writing lse; the bfloat16 backward's two
tensor-core kernels must show ``HGMMA`` in their SASS at every hd, and a
q off a 16-byte boundary must raise; RMSNorm over rows {7, 1024, 4099} ×
D {64, 100, 896, 3072, 12288}, an unaligned row and three bfloat16
draws on the card at (4099, 12288) (dx in bfloat16 within one bf16 ulp,
or, row by row, bit for bit the plain formula at one of the two bf16
neighbours of the row's coefficient summed in float64: the kernel sums
the row in another order and can round its coefficient the other way;
dw at the float32 tolerance); the SSD backward over the forward's SSD
grid (64 cases; the kernel on the kernel forward's cum and states, the
plain version on the plain forward's; the final state's cotangent random
or none; float32 dx, dB, dC at rtol 1e-4, atol 1e-5·max(1, max|plain|),
bf16 ones within 2e-2·max|plain|, ddt and dA at rtol 1e-4, atol
1e-4·max(1, max|plain|)); two runs of each bit for bit alike.  It
times them at the training shapes (SSD backward B 2, S 512, 48 heads of
64, N 128, bf16, with the split over its three launches and the bound
from ``ssd_scan.bwd_bytes`` / ``bwd_flops``; flash backward B 2, S 512,
14 / 2 heads, hd 64, bf16 causal; RMSNorm backward (1024, 896) bf16)
against their plain versions and the backward of
``scaled_dot_product_attention`` / ``F.rms_norm`` through autograd, and
the flash forward with and without its lse output at the serving
prefill; then the flash forward and backward at h2o-danube-1.8b's
shapes (``phase5_danube``: hd 80, 32 / 8 heads, window 4096; the
forward at B 4, S 6144, the backward at B 2, S 6144) against their plain
versions and SDPA with the band as a boolean mask, beside the bound of
the band's FLOPs.  Last, recurrentgemma-2b's kernels (``phase5_rgemma``):
the RG-LRU scan against its plain version over S {1, 37, 65, 512,
4096, 8192} × W {100, 200, 256, 2560} × B {1, 4} × {h0 given, none} ×
{gate fused, none} × {float32, bfloat16} (y float32 rtol 1e-5, atol
1e-5·max(1, max|plain|), bfloat16 2e-2; h_last at the float32
tolerance), timed at its prefill
(B 4, S 4096, W 2560, bf16, gate fused) beside its bound
(``rglru_scan.scan_bytes``); the flash forward at its prefill (B 4, S
4096, 10 / 1 heads of 256, window 2048) as at danube's; and ``ptxas``'s
registers and spills of the hd-256 forward and scan kernels (none may
spill; no "Potential Performance Loss" at hd 256).  Then its training
kernels (``phase5_rgemma_bwd``): the RG-LRU backward against its plain
version over the forward's grid on the forward kernel's entering states
(themselves against the plain ones), h_last's cotangent given on every
other case, and at the edge (B 2, S 300, W 256, r_pre −30 at every 7th
step and channel, where sqrt's gradient is infinite: the non-finite
entries at the same places): float32 at rtol 1e-5, atol 1e-5·max(1,
max|plain|), bfloat16 within 2e-2·max|plain|, dΛ within 1e-4 of max
|plain dΛ|, two calls bit for bit alike; timed at the training shape
(B 2, S 4096, W 2560, bf16, gated) beside its bound
(``rglru_scan.scan_bwd_bytes``); the hd-256 flash backward (in the
flash grid above at GQA 1 and 10, and at its window of 2048 at S 2200)
timed at the training shape (B 2, S 4096, 10 / 1 heads, window 2048)
as at danube's; and ``ptxas``'s registers and spills of the RG-LRU
backward's two kernels (its persistent tile kernel, both paths, and
dΛ's sum) and the hd-256 flash backward's (none may spill).
Last, the MoE decoders' kernels at their own shapes (``phase5_moe``,
``MOE_SHAPES``): the flash forward at each one's prefill (B 4, S 512;
qwen3-moe-30b-a3b's 32 / 4 heads of 128, dbrx-132b's 48 / 8) and its
backward at the training shape (B 2, S 512), bf16, held to their plain
versions and timed beside SDPA (GQA) and its backward; the RMSNorm
forward at the prefill's 2048 rows and its backward at the training
shape's 1024, at each one's width (2048, 6144), held to their plain
versions.  Then the frontend models' (``phase5_frontends``,
``FRONTEND_SHAPES``): the flash forward at each one's serving prefill
(B 4; internvl2-2b's 16 / 8 heads of 128 at S 768, musicgen-large's 32
/ 32 of 64 at S 576) and at musicgen's training shape (B 2, S 512) its
backward, held to their plain versions and timed beside SDPA and its
backward; the RMSNorm forward at each prefill's rows and its backward at
musicgen's training shape's 1024, at width 2048, held to their plain
versions and timed beside ``F.rms_norm`` and its backward.

Then one JSON line with each kernel's launches (summed over the main
paths: the sweep, the serving runs, the training runs, the loop's
server and trainer, the resumed runs, phase 13's figures, bench and
100k pair, phase 14's four serving runs and training run, phase 15's
two serving runs, phase 16's training run, phase 17's and phase 18's
two serving runs and training run each, phase 19's serving runs and
examples, phase 20's steps and sweeps, and phase 21's sweeps, training
and prefill on every rank), error and times, the
``nvidia-smi`` line, and the result line.  Exits non-zero without a
result when no CUDA device is visible or the port's sources are
missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
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
#: phase 2's long rows (B, P, d, m): past the kernel's shared-memory
#: staging (the decisions' 5 P bytes above ~46,000 nodes, the pull's 4 P
#: byte starter list above ~58,000), on the branch cases whose noise is
#: O(P) (a P x P score block would be 14 GB)
TICK_LONG = (2, 60_000, 8, 2)
LONG_CASES = ((False, False, 0, False), (False, False, 1, False),
              (True, True, 0, False), (False, False, 0, True))
FIVE = ("bsp", "ssp", "asp", "pbsp", "pssp")
FRACS = (0.0, 0.05, 0.1, 0.2, 0.3)

# phase 5's case grid (also run by tests/test_torch_cuda.py)
DTYPES = ("float32", "bfloat16")
RMS_ROWS = (1, 7, 2048, 4099)
RMS_DIMS = (64, 100, 896, 1536, 3072)  # 100: not a multiple of 8
ROUND_SCALE = (False, True)
FLASH_MODES = (("causal", {}), ("window256", {"window": 256}),
               ("softcap50", {"softcap": 50.0}),
               ("window256_softcap50", {"window": 256, "softcap": 50.0}))
FLASH_GQA = (1, 7)
FLASH_SEQ = (1, 37, 512, 1000)
#: 80: h2o-danube-1.8b's, in the hd-128 tiling
FLASH_HEAD_DIMS = (64, 80, 128)
#: both directions also at recurrentgemma-2b's hd 256, over FLASH_MODES ×
#: these GQA ratios (10: its MQA) × FLASH_SEQ (FLASH_BWD_SEQ backward) ×
#: DTYPES, and backward its band (FLASH_WIDE_BAND: window 2048 at
#: FLASH_WIDE_BAND_S, past it)
FLASH_WIDE_HD, FLASH_WIDE_GQA = 256, (1, 10)
FLASH_FWD_HEAD_DIMS = FLASH_HEAD_DIMS + (FLASH_WIDE_HD,)
FLASH_WIDE_BAND, FLASH_WIDE_BAND_S = ("window2048", {"window": 2048}), 2200
#: both directions also at the MoE decoders' grouped heads at hd 128, over
#: FLASH_MODES × these ratios (qwen3-moe-30b-a3b's 32 / 4, dbrx-132b's
#: 48 / 8) × FLASH_SEQ (FLASH_BWD_SEQ backward) × DTYPES; then the pair
#: held to its plain version and timed at each decoder's heads and the
#: RMSNorm pair held at its width (MOE_SHAPES: name, H, KV, hd, d_model),
#: at the serving prefill and training shapes (B, S)
FLASH_MOE_HD, FLASH_MOE_GQA = 128, (8, 6)
MOE_SHAPES = (("qwen3-moe-30b-a3b", 32, 4, 128, 2048),
              ("dbrx-132b", 48, 8, 128, 6144))
MOE_PREFILL, MOE_TRAIN = (4, 512), (2, 512)
#: the flash and RMSNorm pairs timed at the frontend models' shapes
#: (phase5_frontends): (name, H, KV, hd, d_model, the serving prefill (B,
#: F + 512), the training shape (B, S) or None: internvl2-2b is not
#: trained on the card)
FRONTEND_SHAPES = (
    ("internvl2-2b", 16, 8, 128, 2048, (4, 256 + 512), None),
    ("musicgen-large", 32, 32, 64, 2048, (4, 64 + 512), (2, 512)))
#: phase 5's RG-LRU scan grid: S × W × B × {h0 given, none} × {gate
#: fused, none} × DTYPES (4096 and 2560: recurrentgemma-2b's prefill and
#: width, 8192 its max_len; 1 the decode kernel; 37 inside one of the
#: prefill kernel's 64-step segments, 65 one step into a second, 512
#: eight; W 100 rows not of 16-byte vectors in bfloat16 (the kernel's
#: masked path) and a partial 32-channel tile in float32, 200 a partial
#: 64-channel tile by bulk copies in bfloat16); float32 tolerance rtol,
#: and atol as a share of max(1, max |plain|) (the kernel composes the
#: steps in another order than the plain version's doubling); bfloat16 y
#: within 2e-2
RGLRU_SEQ = (1, 37, 65, 512, 4096, 8192)
RGLRU_WIDTHS = (100, 200, 256, 2560)
RGLRU_BATCH = (1, 4)
RGLRU_F32 = (1e-5, 1e-5)
#: the scan and the flash forward timed at recurrentgemma-2b's prefill:
#: the scan at (B, S, W), bf16, gate fused; flash at (B, S), 10 / 1
#: heads of 256, window 2048
RGLRU_TIMED = (4, 4096, 2560)
RGEMMA_PREFILL, RGEMMA_HEADS, RGEMMA_WINDOW = (4, 4096), (10, 1, 256), 2048
#: phase 5's RG-LRU backward: the forward's grid (rglru_cases) on the
#: forward kernel's entering states, h_last's cotangent given on every
#: other case, then the edge (RGLRU_EDGE (B, S, W), both dtypes, gated,
#: h0: r_pre = RGLRU_EDGE_R at every RGLRU_EDGE_EVERY-th step and
#: channel, where exp(2·log a) rounds to 1 and sqrt's gradient is
#: infinite); dΛ (a sum over B·S terms in another order) within
#: RGLRU_LAM_RTOL of max |plain dΛ|; timed at the training shape
#: RGLRU_BWD_TIMED (B, S, W), bf16, gated, the flash backward at
#: RGEMMA_TRAIN (B, S)
RGLRU_EDGE, RGLRU_EDGE_R, RGLRU_EDGE_EVERY = (2, 300, 256), -30.0, 7
RGLRU_LAM_RTOL = 1e-4
RGLRU_BWD_TIMED = (2, 4096, 2560)
RGEMMA_TRAIN = (2, 4096)
#: the RG-LRU backward's kernels, by name, as the traced tick sums them
#: (the persistent tile kernel, then dΛ's sum)
RGLRU_BWD_KERNELS = ("rglru_bwd_kernel", "rglru_bwd_lam_kernel")
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
#: the SSD forward's training shape at mamba2-780m's 48 heads, hd 64,
#: N 128, one group, bf16, with cum and the entering states out: (B, S)
SSD_TRAIN_TIMED = (2, 512)
#: the bf16 SSD backward's three kernels, by name (its split per launch,
#: and phase 12's traced tick sums them); the first two run its products
#: and must show tensor-core instructions in their SASS, the third adds
#: the head tiles' partial sums
SSD_BWD_KERNELS = ("bwd_gscan_kernel", "bwd_chunk_kernel", "bwd_sum_kernel")
SSD_BWD_TC = SSD_BWD_KERNELS[:2]
#: the SSD backward's training shape at mamba2-780m's 48 heads, hd 64,
#: N 128, one group, bf16: (B, S)
SSD_BWD_TIMED = (2, 512)
#: the SSD backward's tolerances: rtol, and atol as a share of max(1,
#: max |plain|), of dx, dB, dC in float32, and of the float32 ddt and dA
#: in both dtypes (dA sums B·S terms that cancel, and the bf16 route's
#: states carry 16 bits, hi + lo); bf16 dx, dB, dC within 2e-2·max|plain|
SSD_BWD_F32 = (1e-4, 1e-5)
SSD_BWD_DT = (1e-4, 1e-4)
#: phase 5's backward grids: flash over FLASH_MODES × FLASH_GQA × these S
#: (1: a lone row; 64: exactly one tile; 37 and 1000 are not multiples of
#: the 64-row tile) × FLASH_HEAD_DIMS × DTYPES (at S 1 dq and dk are
#: exactly 0: see check_flash_bwd); RMSNorm over rows × D × DTYPES (D 64, 896, 3072
#: and 12288 take each vector count the launcher picks, 12288 the largest
#: D the wrapper takes; 100 the scalar path), then an unaligned row
FLASH_BWD_SEQ = (1, 37, 64, 512, 1000)
RMS_BWD_ROWS = (7, 1024, 4099)
RMS_BWD_DIMS = (64, 100, 896, 3072, 12288)
#: and bf16 rows × D drawn on the card, RMS_BWD_CARD_DRAWS draws
RMS_BWD_CARD, RMS_BWD_CARD_DRAWS = (4099, 12288), 3
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
#: the flash pair timed at h2o-danube-1.8b's shapes (32 / 8 heads, hd
#: 80, window 4096, bf16): the forward at the serving prefill (B, S), the
#: backward at the training shape
DANUBE_HEADS, DANUBE_WINDOW = (32, 8, 80), 4096
DANUBE_PREFILL, DANUBE_TRAIN = (4, 6144), (2, 6144)
#: phase 8: PSP training of full-width qwen2-0.5b (W workers, B sequences
#: of S tokens each per tick, drawn from a pool of POOL fixed sequences);
#: phase 12 trains MAMBA_TRAIN_ARCH the same way; both at full width with
#: the depth cut to TRAIN_LAYERS and MAMBA_TRAIN_LAYERS (of 24 and 48),
#: so that the script, phase 17 included, keeps inside its time limit
#: (phase 9 trains qwen2-0.5b at LOOP_LAYERS); 12 layers and 24 ticks
#: before phase 17 came
TRAIN_ARCH = "qwen2-0.5b"
MAMBA_TRAIN_ARCH = "mamba2-780m"
TRAIN_LAYERS, MAMBA_TRAIN_LAYERS = 6, 6
TRAIN_TICKS = 16
TRAIN_W, TRAIN_B, TRAIN_S, TRAIN_POOL = 4, 2, 512, 8
#: phase 8's reduced launcher runs on the card (run in phase 19, side by
#: side with the examples), each (module of repro_torch.launch, argv,
#: what its output must hold): train with checkpoints and snapshots, then
#: resume it and serve its snapshots live side by side
LAUNCHER_RUNS = (
    ("train", ["--reduced", "--barrier", "pbsp", "--steps", "4",
               "--ckpt-dir", "{ck}", "--save-every", "2",
               "--publish-dir", "{snaps}", "--publish-every", "2"],
     ("tick", "checkpoint: step 4", "published 3 snapshots")),
    ("train", ["--reduced", "--barrier", "pbsp", "--steps", "6",
               "--ckpt-dir", "{ck}", "--resume"],
     ("resumed step 4", "checkpoint: step 6")),
    ("serve", ["--reduced", "--watch-dir", "{snaps}", "--requests", "4"],
     ("loaded snapshot v4", "versions=[4]")),
)
#: phase 12's reduced launcher run on the card (after the arch; run with
#: the other phases' at the end of phase 18, REDUCED_LAUNCHERS)
MAMBA_LAUNCHER = ["--reduced", "--barrier", "pbsp", "--steps", "4"]
#: phases 6 and 7: qwen2-0.5b's and mamba2-780m's serving runs
TRAFFIC = ["--requests", "8", "--batch", "4", "--prompt-len", "512",
           "--max-len", "1024", "--max-new", "64", "--seed", "0"]
#: phase 6 serves qwen2-0.5b at full width, its depth cut to SERVE_LAYERS
#: of 24 (whole before phase 18 came: cut so that the script keeps inside
#: its time limit with it)
SERVE_LAYERS = 12
SERVE_ARGV = ["--arch", "qwen2-0.5b", "--n-layers", str(SERVE_LAYERS),
              *TRAFFIC]
#: new tokens of the one wave whose device busy share is traced
TRACE_NEW = 16
#: phase 7 serves mamba2-780m at full width, its depth cut to
#: MAMBA_SERVE_LAYERS of 48 (24 before phase 17 came, 12 before phase 18)
MAMBA_SERVE_LAYERS = 6
MAMBA_ARGV = ["--arch", "mamba2-780m", "--n-layers", str(MAMBA_SERVE_LAYERS),
              *TRAFFIC]
#: phase 9: the trainer → bus → live server loop at full width; the
#: trainer (phase 8's PSP config and token pool) runs in a child
#: interpreter started with LOOP_CHILD and publishes every
#: LOOP_PUBLISH_EVERY ticks, keeping LOOP_KEEP snapshots
LOOP_CHILD = "--loop-trainer"
#: the loop's qwen2-0.5b at full width, its depth cut to LOOP_LAYERS of 24
#: (whole before phase 18 came: cut so that the script keeps inside its
#: time limit with it; at 6 layers the server answered its most requests
#: before the trainer published a second version)
LOOP_LAYERS = 12
#: and LOOP_TICKS ticks (8 before phase 18)
LOOP_TICKS, LOOP_PUBLISH_EVERY, LOOP_KEEP = 6, 2, 2
LOOP_BATCH, LOOP_PROMPT, LOOP_NEW, LOOP_MAX_LEN = 4, 512, 64, 1024
LOOP_POLL_EVERY = 4
#: requests served at least, and at most while waiting for the traffic to
#: span two versions with a swap in flight (waves of LOOP_BATCH)
LOOP_REQUESTS, LOOP_MAX_REQUESTS = 16, 48
#: phase 10: kill-and-resume at full width, depth cut to RESUME_LAYERS;
#: RESUME_TICKS straight against half, save, restore, half
RESUME_LAYERS, RESUME_TICKS = 2, 6
#: phase 14: the sliding-window and local/global decoders served at full
#: width (batch 4, greedy, seeded random weights, bf16), their depths cut:
#: qwen1.5-4b on phase 6's traffic; h2o-danube-1.8b (window 4096) on one wave of
#: prompts past the window (its prefill rolls the ring, its decode wraps
#: it), then one shorter than it, at max_len 8192; gemma2-27b cut to
#: GEMMA_LAYERS layers (one local / global pair; 4 before phase 18) on
#: danube's first wave
WINDOW_TRAFFIC = ["--requests", "4", "--batch", "4", "--max-len", "8192",
                  "--max-new", "64", "--seed", "0"]
GEMMA_LAYERS = 2
#: qwen1.5-4b's and h2o-danube-1.8b's depths cut to QWEN15_LAYERS of 40
#: and DANUBE_LAYERS of 24 (12 each before phase 17 came, 6 before phase
#: 18), and
#: gemma2-27b's from 8 to 4 (so that the script keeps inside its time
#: limit with phases 16 and 17)
QWEN15_LAYERS, DANUBE_LAYERS = 4, 4
LOCAL_SERVE = (
    ["--arch", "qwen1.5-4b", "--n-layers", str(QWEN15_LAYERS), *TRAFFIC],
    ["--arch", "h2o-danube-1.8b", "--n-layers", str(DANUBE_LAYERS),
     *WINDOW_TRAFFIC, "--prompt-len", "6144"],
    ["--arch", "h2o-danube-1.8b", "--n-layers", str(DANUBE_LAYERS),
     *WINDOW_TRAFFIC, "--prompt-len", "1024"],
    ["--arch", "gemma2-27b", "--n-layers", str(GEMMA_LAYERS),
     *WINDOW_TRAFFIC, "--prompt-len", "6144"],
)
#: then h2o-danube-1.8b trained under PSP as phase 8 trains qwen2, at full
#: width with its depth cut to LOCAL_TRAIN_LAYERS: LOCAL_TRAIN_TICKS ticks
#: of sequences of LOCAL_TRAIN_S tokens (past the window), AdamW on
#: warmup_cosine(3e-3, LOCAL_TRAIN_WARMUP, LOCAL_TRAIN_TICKS), the loss
#: falling over the first and last LOCAL_TRAIN_FALL pushing ticks
LOCAL_TRAIN_ARCH, LOCAL_TRAIN_LAYERS = "h2o-danube-1.8b", 2
LOCAL_TRAIN_TICKS, LOCAL_TRAIN_S, LOCAL_TRAIN_WARMUP = 8, 6144, 3
LOCAL_TRAIN_FALL = 2
#: phase 15: recurrentgemma-2b served at full width, its depth cut to
#: RGEMMA_SERVE_LAYERS of 26 (one (R, R, A) group and the (R, R) tail;
#: whole before phase 17 came, 14 before phase 18: cut so that the
#: script keeps inside its time limit with them; batch 4, greedy, seeded
#: random weights, bf16) at
#: max_len 8192 on one wave of prompts past its window of 2048 (the
#: prefill rolls the ring twice, decode wraps it), then one shorter than
#: it (a ring padded with zeros)
RGEMMA_SERVE_LAYERS = 5
RGEMMA_SERVE = tuple(
    ["--arch", "recurrentgemma-2b", "--n-layers", str(RGEMMA_SERVE_LAYERS),
     *WINDOW_TRAFFIC, "--prompt-len", str(n)] for n in (4096, 1024))
#: phase 16: recurrentgemma-2b trained under PSP as phase 14 trains
#: danube, at full width with its depth cut to RGEMMA_TRAIN_LAYERS (one
#: (R, R, A) group and the (R, R) tail: 1,048,686,080 params),
#: RGEMMA_TRAIN_TICKS ticks of TRAIN_B sequences of RGEMMA_TRAIN_S tokens
#: a worker (past the window of 2048), AdamW on warmup_cosine(3e-3,
#: RGEMMA_TRAIN_WARMUP, RGEMMA_TRAIN_TICKS), the loss falling over the
#: first and last RGEMMA_TRAIN_FALL pushing ticks
RGEMMA_TRAIN_ARCH, RGEMMA_TRAIN_LAYERS = "recurrentgemma-2b", 5
RGEMMA_TRAIN_TICKS, RGEMMA_TRAIN_S, RGEMMA_TRAIN_WARMUP = 8, 2560, 3
RGEMMA_TRAIN_FALL = 2
#: then the reduced launcher on the card, as phase 12 runs mamba2's
#: (REDUCED_LAUNCHERS)
RGEMMA_LAUNCHER = ["--arch", RGEMMA_TRAIN_ARCH, "--reduced", "--barrier",
                   "pbsp", "--steps", "4"]
#: phase 17: the MoE decoders served at full width on phase 6's traffic
#: (batch 4, greedy, seeded random weights, bf16, the config's capacity
#: factor 1.25), their depths cut: qwen3-moe-30b-a3b to QWEN3_MOE_LAYERS
#: of 48 (623,120,384 f32 params a layer; 12 before phase 18 came, cut so
#: that the script keeps inside its time limit with it), dbrx-132b to
#: DBRX_LAYERS of 40 (2 before phase 18)
#: (3,259,084,800 a layer; three would not fit the card beside their
#: casts); their teacher-forced comparisons at the capacity factor E / k
#: (16 and 4), under which an expert's capacity is at least a call's
#: tokens, so that none can be dropped (random weights route skewed: at
#: 8.0 an expert of qwen3-moe's took 1051 of a 2048-token prefill, past
#: its capacity of 1024)
QWEN3_MOE_LAYERS, DBRX_LAYERS = 3, 1
MOE_SERVE = (
    ["--arch", "qwen3-moe-30b-a3b", "--n-layers", str(QWEN3_MOE_LAYERS),
     *TRAFFIC],
    ["--arch", "dbrx-132b", "--n-layers", str(DBRX_LAYERS), *TRAFFIC],
)
#: then qwen3-moe-30b-a3b trained under PSP at full width with its depth
#: cut to MOE_TRAIN_LAYERS (1,245,452,288 f32 params): MOE_TRAIN_W
#: workers, β MOE_TRAIN_BETA (the other phases' W 4 peaks at about 19×
#: the parameter bytes, past the card's 80 GB), MOE_TRAIN_TICKS ticks of
#: TRAIN_B sequences of TRAIN_S tokens a worker, AdamW on
#: warmup_cosine(3e-3, MOE_TRAIN_WARMUP, MOE_TRAIN_TICKS), the loss
#: falling over the first and last MOE_TRAIN_FALL pushing ticks
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "qwen3-moe-30b-a3b", 1
MOE_TRAIN_W, MOE_TRAIN_BETA = 2, 1
MOE_TRAIN_TICKS, MOE_TRAIN_WARMUP, MOE_TRAIN_FALL = 8, 3, 2
#: then the reduced launchers on the card (REDUCED_LAUNCHERS): (module of
#: repro_torch.launch, argv, what its output must hold); dbrx-132b's
#: reduced 6 heads take d_model 384 (hd 64: the default 256 gives hd 42,
#: which the flash kernel does not take)
MOE_LAUNCHERS = (
    ("train", ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--barrier",
               "pbsp", "--steps", "4"], ("tick",)),
    ("train", ["--arch", "dbrx-132b", "--reduced", "--d-model", "384",
               "--barrier", "pbsp", "--steps", "4"], ("tick",)),
    ("serve", ["--arch", "qwen3-moe-30b-a3b", "--reduced"],
     ("device=cuda",)),
    ("serve", ["--arch", "dbrx-132b", "--reduced", "--d-model", "384"],
     ("device=cuda",)),
)
#: phase 18: the frontend models served at full width and depth on phase
#: 6's traffic (batch 4, greedy, seeded random weights, bf16), each
#: request with its own frontend rows, seeded N(0, 1) (FRONTEND_SEED):
#: internvl2-2b (256 rows a request) and musicgen-large (64)
FRONTEND_SERVE = (["--arch", "internvl2-2b", *TRAFFIC],
                  ["--arch", "musicgen-large", *TRAFFIC])
FRONTEND_SEED = 18
#: then internvl2-2b's loss_fn with frontend rows at full width, its
#: depth cut to FRONTEND_LOSS_LAYERS, on (B, T) tokens after the rows
FRONTEND_LOSS_ARCH, FRONTEND_LOSS_LAYERS = "internvl2-2b", 2
FRONTEND_LOSS_BT = (2, 512)
#: then musicgen-large trained under PSP as phase 16 trains
#: recurrentgemma, at full width with its depth cut to
#: FRONTEND_TRAIN_LAYERS of 48 (411,076,608 f32 params): W 4, β 2,
#: FRONTEND_TRAIN_TICKS ticks of TRAIN_B sequences of TRAIN_S tokens a
#: worker (tokens only, as both packages' trainers feed them), AdamW on
#: warmup_cosine(3e-3, FRONTEND_TRAIN_WARMUP, FRONTEND_TRAIN_TICKS), the
#: loss falling over the first and last FRONTEND_TRAIN_FALL pushing ticks
FRONTEND_TRAIN_ARCH, FRONTEND_TRAIN_LAYERS = "musicgen-large", 8
FRONTEND_TRAIN_TICKS, FRONTEND_TRAIN_WARMUP, FRONTEND_TRAIN_FALL = 8, 3, 2
#: then the reduced launchers on the card (the serving launcher submits
#: no rows: the engine zero-fills them)
FRONTEND_LAUNCHERS = tuple(
    (module, ["--arch", arch, "--reduced", *extra], expect)
    for arch in ("internvl2-2b", "musicgen-large")
    for module, extra, expect in (
        ("train", ["--barrier", "pbsp", "--steps", "4"], ("tick",)),
        ("serve", [], ("device=cuda",))))
#: the reduced launchers of phases 12, 16, 17 and 18, run side by side at
#: the end of phase 18 (each a child interpreter: run one after another
#: they had taken about a minute): (phase tag, module, argv, what its
#: output must hold)
REDUCED_LAUNCHERS = (
    (12, "train", ["--arch", MAMBA_TRAIN_ARCH, *MAMBA_LAUNCHER], ("tick",)),
    (16, "train", RGEMMA_LAUNCHER, ("tick",)),
    *((17, *run) for run in MOE_LAUNCHERS),
    *((18, *run) for run in FRONTEND_LAUNCHERS))
#: phase 19: the reference's remaining entry points on the card.  (a) the
#: churn benchmark at its default scale, then its card held to the CPU on
#: CHURN_REPLAY's runs ((scenario, barrier), ...) under the same recorded
#: draws and minibatches
CHURN_REPLAY = (("churn", "apssp"), ("stragglers", "ebsp"))
#: (b) the serve benchmark's open-loop load (the reference's default:
#: requests, arrivals a second, batch, new tokens, prompt, poll every)
#: on qwen2-0.5b at full width, its depth cut to SERVE_LAYERS as phase 6's
SERVE_BENCH = dict(requests=32, rate_rps=4.0, batch=4, max_new=16,
                   prompt_len=12, poll_every=4)
#: (c) the chaos suite at its smoke shape, its cluster segment's tick
#: floor raised from 0.4 s to CHAOS_TICK_MIN_WALL: on an NVIDIA H100 80GB
#: HBM3 (700 W) host a respawned worker took 10.9–14.4 s from the kill to
#: its first push, past the 6.4 s the smoke shape leaves (16 ticks of
#: 0.4 s after the kill at tick 8); 16 ticks of 1.5 s leave room for a
#: host 1.6 times slower
CHAOS_TICK_MIN_WALL = 1.5
#: (d) the five examples, each a child interpreter started with
#: EXAMPLE_CHILD (``chip_smoke.py --example MODULE COUNTS_JSON CUTS_JSON
#: ARGS``: the module's constants in CUTS_JSON set, then its ``main(ARGS)``,
#: its kernels' launch counts written at its exit), in lanes run side by
#: side with phase 8's launcher runs (LAUNCHER_RUNS) and the reduced
#: launchers (REDUCED_LAUNCHERS), beside (a); each (phase tag, module,
#: argv, what its output must hold).  Their tick counts cut: train_e2e to
#: E2E_STEPS of 200 steps, barrier_sweep's stage 2 to SWEEP_TICKS of 120
#: ticks a barrier, elastic_train to ELASTIC_TICKS[0] of 300 with a
#: checkpoint, then resumed to ELASTIC_TICKS[1]
EXAMPLE_CHILD = "--example"
E2E_STEPS, SWEEP_TICKS, ELASTIC_TICKS = 60, 60, (150, 300)
EXAMPLE_CUTS = {"examples.barrier_sweep": {"TICKS": SWEEP_TICKS}}
EXAMPLES = {
    "serve_demo": (19, "examples.serve_demo", [], ("mamba2-780m",)),
    "train_e2e": (19, "examples.train_e2e", ["--steps", str(E2E_STEPS)],
                  (f"tick {E2E_STEPS - 1:5d}",)),
    "barrier_sweep": (19, "examples.barrier_sweep", [],
                      ("near-ASP step throughput",)),
    "live_serve": (19, "examples.live_serve", ["--smoke"],
                   ("OK: zero drops",)),
    "elastic_train": (19, "examples.elastic_train",
                      ["--ticks", str(ELASTIC_TICKS[0]),
                       "--ckpt-dir", "{elastic}"],
                      (f"checkpoint: tick {ELASTIC_TICKS[0]}",)),
    "elastic_resume": (19, "examples.elastic_train",
                       ["--ticks", str(ELASTIC_TICKS[1]),
                        "--ckpt-dir", "{elastic}", "--resume"],
                       (f"resumed tick {ELASTIC_TICKS[0]}",
                        f"checkpoint: tick {ELASTIC_TICKS[1]}")),
}
#: phase 13's sweep bench at its default scale, its horizon cut from 20 s
#: to SWEEP_BENCH_DURATION, to make room for phases 19 (5 s) and 21
SWEEP_BENCH_DURATION = 2.5

#: phase 20's steps: (arch, input shape, global batch cut to, timed
#: reps), each at full width and depth
ROOF_COMBOS = (("qwen2-0.5b", "prefill_32k", 2, 3),
               ("recurrentgemma-2b", "prefill_32k", 1, 3),
               ("mamba2-780m", "decode_32k", 128, 10),
               ("qwen2-0.5b", "train_4k", 2, 3))
#: a share of the roofline above this means the count left work out
ROOF_SHARE_MAX = 1.05
#: phase 20 (b)'s sweep-tick rows: the reference's default shape and
#: the paper's (B 32, P 1000, d 1000, m 8, β 10)
ROOF_TICK_ROWS = ({}, {"n_nodes": 1000, "dim": 1000, "rows": 32,
                       "sample_size": 10, "batch": 8})


#: phase 21: the device mesh over torch.distributed.  (a) phase 4's 5 s
#: sweep on the (1, 1) mesh of a one-rank NCCL group; (b) DIST_RANKS gloo
#: ranks sharing the card (spawned children): the sweep on each of
#: DIST_MESHES, DIST_TRAIN_ARCH at full width cut to DIST_TRAIN_LAYERS
#: layers trained with DIST_TRAIN_W workers (one a rank) for
#: DIST_TRAIN_TICKS ticks, and DIST_MOE_ARCH at full width cut to
#: DIST_MOE_LAYERS layer with its experts split over model DIST_RANKS, a
#: prefill of DIST_MOE_PROMPT (B, S) held to the one-device path on its
#: recorded routing: the MoE layers' y within DIST_MOE_Y_TOL of max |y|
#: (two bf16 ulps at the top of y's range: the ranks' bf16 shares are
#: summed in another order) and the logits within DIST_MOE_TOL of max
#: |logit| (bf16: above the floor of about 2e-2 that one ulp of the
#: logits makes), and y's bound shown to fail with the sum over model
#: left out; every child within DIST_WALL seconds
DIST_RANKS = 2
DIST_MESHES = ((1, 2), (2, 1))
DIST_TRAIN_ARCH, DIST_TRAIN_LAYERS = "qwen2-0.5b", 2
DIST_TRAIN_W, DIST_TRAIN_TICKS = 2, 3
DIST_MOE_ARCH, DIST_MOE_LAYERS, DIST_MOE_PROMPT = "qwen3-moe-30b-a3b", 1, \
    (2, 256)
DIST_MOE_TOL, DIST_MOE_Y_TOL = 5e-2, 2 ** -6
DIST_WALL = 600.0
#: the sweep fields that phase 21 holds bit for bit across meshes
SWEEP_FIELDS = ("steps", "errors", "server_updates", "total_updates",
                "control_messages")


def roof():
    """:mod:`repro_torch.roofline`: the card's data-sheet figures
    (``HW``), ``times_ms`` and the kernels' work formulas
    (``kernel_cost``), the one definition the dry run reads too."""
    from repro_torch import roofline
    from repro_torch.roofline import kernel_cost  # noqa: F401
    return roofline


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
    """Raise unless the tensors of ``a`` and ``b`` are equal bit for bit
    (equal values, or, where NaNs are, equal bits)."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for k, v in a.items():
        w = b[k]
        if torch.equal(v, w):
            continue
        if not (v.is_floating_point() and v.dtype == w.dtype
                and v.shape == w.shape and torch.equal(
                    v.contiguous().view(ints[v.element_size()]),
                    w.contiguous().view(ints[v.element_size()]))):
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


def time_tick(np, torch, pt, dev, st, shapes, prm, ln, jn, kw):
    """Time one in-place kernel tick and its plain version on a tick
    problem, beside the bound of the bytes and operations that tick's
    data needs (``psp_tick.tick_bytes``).  Returns a dict: ``ms`` (the
    profiler's device time of the five launches, or CUDA events),
    ``call_ms``, ``plain_ms``, ``split`` (ms per launch), ``host_us``
    per wrapper call, ``bound_ms``, ``fresh_bound_ms``, ``bytes``
    {in_place: bytes}, ``flops``, ``n_fin``, ``n_start``."""
    from repro_torch.convert import tick_inputs_to_torch
    s, _, p = tick_inputs_to_torch(st, {}, prm, dev)
    staged = pt.stage_params(p, adaptive=kw.get("adaptive", False))
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
    B, P = s["steps"].shape
    m, d = r["X"].shape[1], r["X"].shape[2]
    n_fin, n_start = int(o["fin"].sum()), int(o["start"].sum())
    n_cand_sm = int(((~s["computing"]) & p["sampled"][:, None]).sum())
    nbytes = {c: sum(pt.tick_bytes(s, r, p, o["fin"], o["start"],
                                   in_place=c)) for c in (True, False)}
    flops = roof().kernel_cost.tick_flops(n_fin, n_cand_sm, m, d, P,
                                          k_max=kw["k_max"],
                                          masked=kw["masked"])
    bound = {c: max(roof().times_ms(flops, nbytes[c], f32=True))
             for c in (True, False)}
    return {"ms": ms_dev if ms_dev is not None else ms_call,
            "device_time": ms_dev is not None, "call_ms": ms_call,
            "plain_ms": ms_plain, "split": split, "host_us": host_us,
            "bound_ms": bound[True], "fresh_bound_ms": bound[False],
            "bytes": nbytes, "flops": flops, "n_fin": n_fin,
            "n_start": n_start}


def print_tick_time(tag, tt, slots, card):
    """Print :func:`time_tick`'s result as phase 2 reports it."""
    print(f"{tag}, in place: kernels {tt['ms']:.4f} ms "
          f"({'profiler device time' if tt['device_time'] else 'CUDA events'}"
          f"; {tt['call_ms']:.4f} ms per wrapper call with events), plain "
          f"{tt['plain_ms']:.4f} ms; bound {tt['bound_ms']:.4f} ms "
          f"({tt['bytes'][True] / 1e6:.1f} MB: {tt['n_fin']} of {slots} "
          f"slots finish, {tt['n_start']} start; {tt['flops'] / 1e9:.3f} "
          f"GFLOP); the fresh-output contract's bound "
          f"{tt['fresh_bound_ms']:.4f} ms ({tt['bytes'][False] / 1e6:.1f} "
          f"MB) [{card}]", flush=True)
    print(f"{tag.split()[0]} per launch: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in tt["split"].items())
          + f"; host {tt['host_us']:.1f} us per wrapper call", flush=True)


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
    """Phase 5's flash forward grid: ((mode, kwargs), GQA ratio, S, hd,
    dtype), hd FLASH_HEAD_DIMS at GQA FLASH_GQA, hd 256 at
    FLASH_WIDE_GQA, then hd 128 at FLASH_MOE_GQA."""
    return itertools.chain(
        itertools.product(FLASH_MODES, FLASH_GQA, FLASH_SEQ,
                          FLASH_HEAD_DIMS, DTYPES),
        itertools.product(FLASH_MODES, FLASH_WIDE_GQA, FLASH_SEQ,
                          (FLASH_WIDE_HD,), DTYPES),
        itertools.product(FLASH_MODES, FLASH_MOE_GQA, FLASH_SEQ,
                          (FLASH_MOE_HD,), DTYPES))


def rglru_cases():
    """Phase 5's RG-LRU scan grid: (B, S, W, h0 given, gate fused,
    dtype)."""
    return itertools.product(RGLRU_BATCH, RGLRU_SEQ, RGLRU_WIDTHS,
                             (False, True), (True, False), DTYPES)


def ssd_cases():
    """Phase 5's SSD grid: (B, S, nh, ng, hd, N, chunk, decay, dtype); the
    product of S × groups × N × decay × dtype at B 2, 4 heads, hd 64,
    then ``SSD_EXTRA`` × decay × dtype."""
    grid = [((2, S, SSD_HEADS, ng, 64, N, 128), d, dt)
            for S, ng, N, d, dt in itertools.product(
                SSD_SEQ, SSD_GROUPS, SSD_STATES, SSD_DECAYS, DTYPES)]
    grid += list(itertools.product(SSD_EXTRA, SSD_DECAYS, DTYPES))
    return [(*shape, d, dt) for shape, d, dt in grid]


def _normal(torch, dev, seed):
    """N(0, 1) float32 tensors of a shape, drawn on ``dev`` one after
    another from a ``torch.Generator`` seeded with ``seed`` (numpy on the
    host took a tenth of a second a flash case, most of phase 5's
    grids)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return lambda *shape: torch.randn(shape, generator=gen, device=dev)


def rms_inputs(np, torch, rows, D, dtype, dev, seed=0, on_card=False):
    """x (rows, D) ~ 3·N(0, 1) in ``dtype`` and a float32 gain w (D,) ~ 1
    + 0.5·N(0, 1), from numpy, or with ``on_card`` drawn on ``dev``
    (:func:`_normal`)."""
    if on_card:
        normal = _normal(torch, dev, seed)
        x = normal(rows, D) * 3
        return x.to(getattr(torch, dtype)), 1 + 0.5 * normal(D)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, D)) * 3).astype(np.float32)
    w = (1 + 0.5 * rng.normal(size=D)).astype(np.float32)
    return (torch.from_numpy(x).to(dev, getattr(torch, dtype)),
            torch.from_numpy(w).to(dev))


def flash_inputs(np, torch, B, S, H, KV, hd, dtype, dev, seed=0,
                 q_only=False):
    """q (B, S, H, hd) and k, v (B, S, KV, hd) ~ N(0, 1) in ``dtype``,
    drawn on ``dev`` (:func:`_normal`); with ``q_only`` the q alone (the
    same values: q is drawn first)."""
    normal = _normal(torch, dev, seed)
    return tuple(normal(B, S, n, hd).to(getattr(torch, dtype))
                 for n in ((H,) if q_only else (H, KV, KV)))


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


def _f64(torch, x):
    """x in float64 on its own device (compared there, not on the host)."""
    return x.to(torch.float64)


def _max_abs(torch, x) -> float:
    """max |x| (0 for an empty x)."""
    return float(x.abs().max()) if x.numel() else 0.0


def check_close(np, got, want, dtype, what, f32=(1e-5, 1e-6)):
    """Max |got - want|; raises beyond the stated tolerance (float32:
    rtol ``f32[0]``, atol ``f32[1]``·max(1, max|want|), by default 1e-5
    and 1e-6; bfloat16: 2e-2 both).  Compared in float64 on the tensors'
    device (``torch.allclose``: |got − want| <= atol + rtol·|want|, NaN
    never close)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    a, b = _f64(torch, want), _f64(torch, got)
    scale = max(1.0, _max_abs(torch, a))
    rtol, atol = ((f32[0], f32[1] * scale) if dtype == "float32"
                  else (2e-2, 2e-2))
    err = _max_abs(torch, a - b)
    if not torch.allclose(b, a, rtol=rtol, atol=atol):
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


def event_rounds(torch, fns, queued=False):
    """:func:`timed_rounds` by CUDA events (:func:`time_calls`) instead of
    the profiler: for calls of milliseconds, where the profiler was seen
    to drop some of a run's kernel records (PERF.md §7); with ``queued``
    by :func:`queued_ms`, for short calls whose host side may outlast
    the kernel."""
    timer = queued_ms if queued else time_calls
    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    before = sm_clock()
    got = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, calls = fns[name]
            got[name].append(timer(torch, fn, calls))
    how = "queued events" if queued else "events"
    return ({name: (sum(r) / 2, tuple(r), how)
             for name, r in got.items()}, f"{before} → {sm_clock()}")


def queued_ms(torch, fn, n):
    """Milliseconds per call of ``fn`` over ``n`` calls by CUDA events, the
    calls queued behind a device sleep (``torch.cuda._sleep``) twice as
    long as their enqueue took once, so that the events time the device
    even where the host issues calls slower than the card runs them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    cycles = int(2 * (time.perf_counter() - t0) * 2.0e9)  # at most 2 GHz
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(cycles)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


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
    print(f"[5] flash kernel == plain on {i + 1} cases (hd "
          f"{FLASH_HEAD_DIMS} at GQA {FLASH_GQA}, hd {FLASH_WIDE_HD} at GQA "
          f"{FLASH_WIDE_GQA}, hd {FLASH_MOE_HD} at GQA {FLASH_MOE_GQA}; "
          "bf16 on the tensor cores); max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err_fl.items()),
          flush=True)
    sass = tensor_core_sass(_build._target("flash_attention"))
    print("[5] flash library SASS: " + "; ".join(
        f"{fn[:60]}… HGMMA {c['HGMMA']}, HMMA {c['HMMA']}"
        for fn, c in sorted(sass.items())), flush=True)
    tc = hgmma_by_hd(sass, ("flash_tc_kernel",), FLASH_FWD_HEAD_DIMS)
    print("[5] the bf16 flash forward's HGMMA by head dim: " + ", ".join(
        f"{k} {n}" for k, n in tc.items()), flush=True)
    if not all(tc.values()):
        raise AssertionError("a bf16 flash forward instantiation has no "
                             f"HGMMA in its SASS: {tc}")
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
        nbytes = roof().kernel_cost.rmsnorm_bytes(rows, 896, x.element_size(),
                                                  w.element_size())
        bound = roof().times_ms(0, nbytes)[1]
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
        kc = roof().kernel_cost
        flops = kc.attention_flops(B, S, 14, 64)
        nbytes = kc.attention_bytes(B, S, 14, 2, 64, q.element_size())
        t_ops, t_bytes = roof().times_ms(flops, nbytes)
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
    for name in SSD_KERNELS + SSD_BWD_TC:
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
        kc = roof().kernel_cost
        flops = kc.ssd_flops(B, S, nh, ng, hd, N)
        nbytes = kc.ssd_bytes(B, S, nh, ng, hd, N, x.element_size())
        t_ops, t_bytes = roof().times_ms(flops, nbytes)
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

    # the training forward: cum and the entering states out as well
    B, S = SSD_TRAIN_TIMED
    nh, ng, hd, N = 48, 1, 64, 128
    args = ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model", "bfloat16",
                      dev)
    nxt, n_sets = rotating(args)
    train = lambda: ssd_cuda(*nxt(), return_states=True)
    ms_t, clocks = timed_rounds(torch, {
        "kernel": (train, 20),
        "plain": (lambda: ssd_ref(*nxt(), return_states=True), 3)})
    split = {n: v for key, v in profile_device(torch, train, 20).items()
             for n in SSD_KERNELS if n in key}
    kc = roof().kernel_cost
    flops = kc.ssd_flops(B, S, nh, ng, hd, N)
    nbytes = kc.ssd_bytes(B, S, nh, ng, hd, N, args[0].element_size(),
                          states=True)
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    print(f"[5] ssd training forward B={B} S={S} nh={nh} hd={hd} N={N} "
          f"ng={ng} bf16, cum and states out: " + rounds_text(ms_t)
          + "; per launch " + ", ".join(f"{n} {v:.4f} ms"
                                        for n, v in split.items())
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} GFLOP,"
          f" {nbytes / 1e6:.2f} MB); inputs rotated over {n_sets} copies; "
          f"SM clock {clocks} [{card}]", flush=True)
    ms, t_ops, t_bytes = timed[0]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:72",
            "max_abs_err": err, "ms": ms["kernel"][0],
            "plain_ms": ms["plain"][0], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def ssd_bwd_cases():
    """Phase 5's SSD backward grid: the forward's (:func:`ssd_cases`)."""
    return ssd_cases()


def check_ssd_bwd(np, torch, case, dev, seed):
    """One SSD backward case: ``ssd_bwd_cuda`` on the kernel forward's cum
    and states against ``ssd_bwd_ref`` on the plain forward's, on the same
    inputs and cotangents (dy in x's dtype; the final state's cotangent
    random at an even ``seed``, None at an odd one, as in training), two
    kernel runs bit for bit alike.  Tolerances: ``SSD_BWD_F32`` (dx, dB,
    dC in float32), 2e-2·max|plain| (them in bfloat16), ``SSD_BWD_DT``
    (ddt, dA).  Returns the max |err| over the five."""
    from repro_torch.kernels.ssd_scan import (ssd_bwd_cuda, ssd_bwd_ref,
                                              ssd_cuda, ssd_ref)
    B, S, nh, ng, hd, N, chunk, decay, dt = case
    args = ssd_inputs(np, torch, B, S, nh, ng, hd, N, decay, dt, dev, seed)
    dy = ssd_inputs(np, torch, B, S, nh, ng, hd, N, decay, dt, dev,
                    seed + 1000)[0]
    dh = None
    if seed % 2 == 0:
        rng = np.random.default_rng(seed + 2000)
        dh = torch.from_numpy(rng.normal(size=(B, nh, hd, N)).astype(
            np.float32)).to(dev)
    what = (f"ssd bwd B={B} S={S} nh={nh} ng={ng} hd={hd} N={N} "
            f"chunk={chunk} {decay} {dt} dh="
            + ("none" if dh is None else "random"))
    _, _, cum, st = ssd_cuda(*args, chunk, return_states=True)
    got = ssd_bwd_cuda(*args, dy, cum, st, dh, chunk)
    again = ssd_bwd_cuda(*args, dy, cum, st, dh, chunk)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ")
    _, _, cum_r, st_r = ssd_ref(*args, chunk, return_states=True)
    want = ssd_bwd_ref(*args, dy, cum_r, st_r, dh, chunk)
    return ssd_bwd_close(np, got, want, dt, what)


def ssd_bwd_close(np, got, want, dt, what):
    """Max |err| of the backward's five outputs ``got`` against the plain
    version's ``want``; raises beyond the tolerances of
    :func:`check_ssd_bwd`, or on a value that is not finite."""
    err = 0.0
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {name}: {g.dtype}{tuple(g.shape)}"
                                 f" != {w.dtype}{tuple(w.shape)}")
        a = w.float().cpu().numpy().astype(np.float64)
        b = g.float().cpu().numpy().astype(np.float64)
        top = float(np.abs(a).max(initial=0.0))
        if name in ("ddt", "dA"):
            rtol, atol = SSD_BWD_DT[0], SSD_BWD_DT[1] * max(1.0, top)
        elif dt == "float32":
            rtol, atol = SSD_BWD_F32[0], SSD_BWD_F32[1] * max(1.0, top)
        else:
            rtol, atol = 0.0, 2e-2 * top
        e = float(np.abs(a - b).max(initial=0.0))
        if not (np.isfinite(b).all() and np.allclose(b, a, rtol=rtol,
                                                     atol=atol)):
            raise AssertionError(f"{what} {name}: max |diff| {e} (max "
                                 f"|plain| {top})")
        err = max(err, e)
    return err


def phase5_ssd_bwd(np, torch, dev, card):
    """The SSD backward kernels against their plain version over the
    forward's case grid, then timed at mamba2-780m's training shape.
    Returns its JSON entry without ``launches``."""
    from repro_torch.kernels.ssd_scan import (ssd_bwd_cuda, ssd_bwd_ref,
                                              ssd_cuda, ssd_ref)
    err = {dt: 0.0 for dt in DTYPES}
    for i, case in enumerate(ssd_bwd_cases()):
        err[case[-1]] = max(err[case[-1]],
                            check_ssd_bwd(np, torch, case, dev, i))
    print(f"[5] ssd backward kernel == plain on {i + 1} cases (dx, ddt, dA,"
          " dB, dC; the final state's cotangent random or none), two runs "
          "bit for bit alike; max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err.items()), flush=True)

    B, S = SSD_BWD_TIMED
    nh, ng, hd, N = 48, 1, 64, 128
    args = ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model", "bfloat16",
                      dev)
    dy = ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model", "bfloat16",
                    dev, 1)[0]
    _, _, cum, st = ssd_cuda(*args, return_states=True)
    _, _, cum_r, st_r = ssd_ref(*args, return_states=True)
    nxt, n_sets = rotating((*args, dy, cum, st))
    nxt_r, _ = rotating((*args, dy, cum_r, st_r))
    ms, clocks = timed_rounds(torch, {
        "kernel": (lambda: ssd_bwd_cuda(*nxt()), 20),
        "plain": (lambda: ssd_bwd_ref(*nxt_r()), 3)})
    split = {n: v for key, v in profile_device(
        torch, lambda: ssd_bwd_cuda(*nxt()), 20).items()
        for n in SSD_BWD_KERNELS if n in key}
    kc = roof().kernel_cost
    flops = kc.ssd_bwd_flops(B, S, nh, ng, hd, N)
    nbytes = kc.ssd_bwd_bytes(B, S, nh, ng, hd, N, 2, split=True)
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    calls = train_launches(train_config(MAMBA_TRAIN_ARCH,
                                        MAMBA_TRAIN_LAYERS))["ssd_scan_bwd"]
    print(f"[5] ssd backward B={B} S={S} nh={nh} hd={hd} N={N} ng={ng} bf16 "
          f"(the training shape; {calls * TRAIN_W} calls per tick): "
          + rounds_text(ms)
          + "; per launch " + ", ".join(f"{n} {v:.4f} ms"
                                        for n, v in split.items())
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} GFLOP "
          f"at the bf16 tensor-core rate, "
          f"{roof().times_ms(flops, 0, f32=True)[0]:.4f} ms at"
          f" the f32 rate; {nbytes / 1e6:.2f} MB; ssd_scan.bwd_bytes / "
          f"bwd_flops); kernel at {flops / ms['kernel'][0] / 1e9:.2f} "
          f"TFLOP/s; no library call computes it; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/models/ssm.py:100",
            "max_abs_err": max(err.values()), "ms": ms["kernel"][0],
            "plain_ms": ms["plain"][0], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def flash_bwd_cases():
    """Phase 5's flash backward grid: ((mode, kwargs), GQA ratio, S, hd,
    dtype)."""
    return itertools.chain(
        itertools.product(FLASH_MODES, FLASH_GQA, FLASH_BWD_SEQ,
                          FLASH_HEAD_DIMS, DTYPES),
        itertools.product(FLASH_MODES, FLASH_WIDE_GQA, FLASH_BWD_SEQ,
                          (FLASH_WIDE_HD,), DTYPES),
        itertools.product((FLASH_WIDE_BAND,), FLASH_WIDE_GQA,
                          (FLASH_WIDE_BAND_S,), (FLASH_WIDE_HD,), DTYPES),
        itertools.product(FLASH_MODES, FLASH_MOE_GQA, FLASH_BWD_SEQ,
                          (FLASH_MOE_HD,), DTYPES))


def hgmma_by_hd(sass, names, hds=FLASH_HEAD_DIMS):
    """``HGMMA`` counts of the kernels ``names`` in :func:`tensor_core_sass`
    counts, per instantiation for each head dim of ``hds`` (the first
    template argument, ``ILi<hd>E`` in the mangled name), keyed
    ``name<hd>``; 0 where an instantiation is missing."""
    out = {}
    for name in names:
        for hd in hds:
            out[f"{name}<{hd}>"] = sum(
                c["HGMMA"] for fn, c in sass.items()
                if name in fn and re.search(rf"{name}ILi{hd}E", fn))
    return out


def flash_bwd_sass(lib):
    """``HGMMA`` counts of the bf16 backward's tensor-core kernels
    (``FLASH_BWD_TC``) in the flash library ``lib``, per head dim
    (:func:`hgmma_by_hd`, 256 included); raises if an instantiation has
    none."""
    counts = hgmma_by_hd(tensor_core_sass(lib), FLASH_BWD_TC,
                         FLASH_FWD_HEAD_DIMS)
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
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    a, b = _f64(torch, want), _f64(torch, got)
    top = _max_abs(torch, a)
    rtol, atol = ((BWD_F32[0], BWD_F32[1] * max(1.0, top))
                  if dtype == "float32" else (0.0, 2e-2 * top))
    err = _max_abs(torch, a - b)
    if not torch.allclose(b, a, rtol=rtol, atol=atol):
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
                      seed + 1000, q_only=True)[0]
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


def check_rms_bwd(np, torch, rows, D, dt, dev, seed, shift=False,
                  on_card=False):
    """One RMSNorm backward case: the kernel against ``rmsnorm_bwd_ref``
    on the same x, w, g (:func:`rms_inputs`) and the plain forward's m
    (``shift``: x and g one element past a 16-byte boundary), two runs
    bit for bit alike.  float32: dx and dw at ``BWD_F32``.  bfloat16: dw
    at ``BWD_F32`` (the same m: the rows' ``cast(g·m)`` are equal); dx
    within one bf16 ulp of the larger of |dx| and its rounded term
    |cast(coeff)·x|, or else, row by row, bit for bit the plain formula
    at one of the two bf16 neighbours of the row's exact coefficient
    (:func:`rms_coeff_witness`): the kernel sums the row's inner product
    in another order, which can round ``cast(coeff)`` the other way, and
    one ulp of a coefficient at the foot of its binade moves a product
    at the top of its own by two.  Returns (max |err| of dx and dw, the
    rows decided by the witness)."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_ref, rmsnorm_ref)
    x, w = rms_inputs(np, torch, rows, D, dt, dev, seed, on_card)
    g, _ = rms_inputs(np, torch, rows, D, dt, dev, seed + 1000, on_card)
    if shift:
        x, g = unaligned(torch, x), unaligned(torch, g)
    what = (f"rmsnorm bwd rows={rows} D={D} {dt}" + (" unaligned" * shift)
            + (" drawn on the card" * on_card))
    _, m = rmsnorm_ref(x, w, round_scale=True, return_m=True)
    dx, dw = rmsnorm_bwd_cuda(x, w, g, m)
    dx2, dw2 = rmsnorm_bwd_cuda(x, w, g, m)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"{what}: two runs differ")
    rdx, rdw = rmsnorm_bwd_ref(x, w, g, m)
    err_w = check_bwd(np, dw, rdw, "float32", f"{what} dw")
    if dt == "float32":
        return max(check_bwd(np, dx, rdx, dt, f"{what} dx"), err_w), 0
    a = rdx.float().cpu().numpy()
    b = dx.float().cpu().numpy()
    xf, gf = x.float(), g.float()
    coeff = (m[:, None] ** 3 / D) * (gf * w).to(x.dtype).float().mul(
        xf).sum(-1, keepdim=True)
    term = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                      (coeff * xf).abs().cpu().numpy())
    err = float(np.abs(a - b).max())
    over = np.nonzero((np.abs(a - b) > bf16_ulp(np, term)).any(-1))[0]
    if len(over):
        r = torch.from_numpy(over).to(dev)
        if not rms_coeff_witness(torch, x[r], w, g[r], m[r], dx[r]):
            raise AssertionError(f"{what} dx: beyond one bf16 ulp on rows "
                                 f"{over[:8].tolist()}, max |diff| {err}, "
                                 "and not the plain formula at a bf16 "
                                 "neighbour of the exact coefficient")
    return max(err, err_w), len(over)


def rms_coeff_witness(torch, x, w, g, m, dx):
    """Whether each row of the kernel's bf16 ``dx`` is, bit for bit,
    ``rmsnorm_bwd_ref``'s formula ``cast(m·g·w) − cast(c)·x`` at c one of
    the two bfloat16 neighbours of the row's coefficient m³/D · Σ
    cast(g·w)·x, its sum taken in float64 (m³/D in float32, as both
    versions form it)."""
    D = x.shape[-1]
    gs = g.float() * w.float()
    mmm = (m[:, None] * m[:, None] * m[:, None] / D).double()
    exact = mmm * (gs.to(x.dtype).double() * x.double()).sum(
        -1, keepdim=True)
    lo = (exact.float().view(torch.int32) & -65536).view(torch.float32)
    hi = (lo.view(torch.int32) + 65536).view(torch.float32)
    first = (m[:, None] * gs).to(x.dtype)
    at = [first - c.to(x.dtype) * x for c in (lo, hi)]
    return bool(((dx == at[0]).all(-1) | (dx == at[1]).all(-1)).all())


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
    cases = [(*c, False, False) for c in rms_bwd_cases()]
    cases += [(7, 896, dt, True, False) for dt in DTYPES]
    # drawn on the card: a draw at this shape had rows whose coefficient
    # the two versions round apart, with dx two ulps apart
    cases += [(*RMS_BWD_CARD, "bfloat16", False, True)] * RMS_BWD_CARD_DRAWS
    apart = 0
    for i, (rows, D, dt, shift, on_card) in enumerate(cases):
        err, n = check_rms_bwd(np, torch, rows, D, dt, dev, seed=i,
                               shift=shift, on_card=on_card)
        err_rms[dt] = max(err_rms[dt], err)
        apart += n
    print(f"[5] rmsnorm backward kernel == plain on {len(cases)} cases "
          f"(2 unaligned; {RMS_BWD_CARD_DRAWS} drawn on the card at "
          f"{RMS_BWD_CARD}), two runs bit for bit alike; max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err_rms.items())
          + f"; bf16 rows beyond one ulp, each the plain formula at a bf16 "
          f"neighbour of its float64 coefficient: {apart}", flush=True)

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
    kc = roof().kernel_cost
    flops = kc.attention_flops(B, S, 14, 64, backward=True)
    nbytes = kc.attention_bytes(B, S, 14, 2, 64, q.element_size(),
                                backward=True)
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    print(f"[5] flash backward B={B} S={S} H=14 KV=2 hd=64 bf16 causal "
          f"(the training shape; "
          f"{train_launches(train_config())['flash_attention_bwd'] * TRAIN_W}"
          " calls per tick): "
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
    nbytes = roof().kernel_cost.rmsnorm_bytes(rows, D, x.element_size(),
                                              backward=True)
    bound = roof().times_ms(0, nbytes)[1]
    print(f"[5] rmsnorm backward ({rows}, {D}) bf16 (the training shape; "
          f"{train_launches(train_config())['rmsnorm_bwd'] * TRAIN_W} calls "
          "per tick): " + rounds_text(ms)
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


def band_forward(np, torch, dev, card, what, B, S, H, KV, hd, w):
    """The bf16 flash forward at (B, S, H / KV heads of hd, causal,
    window w): held to its plain version there (``check_close``'s bf16
    tolerance) and timed against it and SDPA with K/V repeated to the
    query heads and the band as a boolean mask, by CUDA events in
    mirrored rounds (:func:`event_rounds`), beside the bound: the band's
    FLOPs at the bf16 tensor-core rate against the bytes (inputs once,
    the output once).  Prints the line; returns (ms by entry, bound ms,
    bound_by, max |err|)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    q, k, v = flash_inputs(np, torch, B, S, H, KV, hd, "bfloat16", dev)
    pos = torch.arange(S, device=dev)
    band = ((pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < w))
    rep = lambda t: t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    kc = roof().kernel_cost
    pairs = kc.band_pairs(S, w)
    err = check_close(np, flash_attention_cuda(q, k, v, window=w),
                      attention_ref(q, k, v, window=w), "bfloat16",
                      f"flash at {what}'s prefill shape")
    nxt, n_sets = rotating((q, k, v))
    lib_in = (q.transpose(1, 2), rep(k), rep(v))
    ms, clocks = event_rounds(torch, {
        "kernel": (lambda: flash_attention_cuda(*nxt(), window=w), 5),
        "plain": (lambda: attention_ref(*nxt(), window=w), 2),
        "library": (lambda: F.scaled_dot_product_attention(
            *lib_in, attn_mask=band), 5)})
    flops = kc.attention_flops(B, S, H, hd, window=w)  # S·Kᵀ and P·V
    nbytes = kc.attention_bytes(B, S, H, KV, hd, q.element_size())
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    print(f"[5] flash forward at {what}'s shape B={B} S={S} H={H} KV={KV} "
          f"hd={hd} bf16 causal window {w} (kernel == plain there, max "
          f"|err| {err:.3g}): " + rounds_text(ms)
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} "
          f"GFLOP over the band's {pairs} (query, key) pairs at the bf16 "
          f"tensor-core rate, {nbytes / 1e6:.2f} MB at {t_bytes:.4f} ms); "
          f"kernel at {flops / ms['kernel'][0] / 1e9:.2f} TFLOP/s, library "
          f"(SDPA, K/V repeated, the band as a boolean mask) at "
          f"{flops / ms['library'][0] / 1e9:.2f}; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    del nxt, lib_in, band
    gc.collect()
    torch.cuda.empty_cache()
    return (ms, max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", err)


def band_backward(np, torch, dev, card, what, B, S, H, KV, hd, w):
    """The bf16 flash backward at (B, S, H / KV heads of hd, causal,
    window w): held to its plain version there (``check_bwd``'s bf16
    tolerance) and timed against it and SDPA's backward through autograd
    (K/V repeated to the query heads, the band as a boolean mask) by
    CUDA events in mirrored rounds (:func:`event_rounds`), beside the
    bound of the band's five products.  Prints the line; returns (ms by
    entry, bound ms, bound_by, max |err|)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_ref, flash_attention_bwd_cuda)
    G = H // KV
    q, k, v = flash_inputs(np, torch, B, S, H, KV, hd, "bfloat16", dev)
    pos = torch.arange(S, device=dev)
    band = ((pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < w))
    rep = lambda t: t.repeat_interleave(G, dim=2).transpose(1, 2)
    kc = roof().kernel_cost
    pairs = kc.band_pairs(S, w)
    do = flash_inputs(np, torch, B, S, H, KV, hd, "bfloat16", dev, 1)[0]
    o, lse = attention_ref(q, k, v, window=w, return_lse=True)
    err = max(check_bwd(np, g, r, "bfloat16",
                        f"flash bwd at {what}'s training shape {n}")
              for n, g, r in zip(
                  "dq dk dv".split(),
                  flash_attention_bwd_cuda(q, k, v, o, lse, do, window=w),
                  attention_bwd_ref(q, k, v, o, lse, do, window=w)))
    nxt, n_sets = rotating((q, k, v, o, lse, do))
    leaves = [q.transpose(1, 2).detach().requires_grad_(True),
              rep(k).detach().requires_grad_(True),
              rep(v).detach().requires_grad_(True)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=band)
    dout = do.transpose(1, 2)
    ms, clocks = event_rounds(torch, {
        "kernel": (lambda: flash_attention_bwd_cuda(*nxt(), window=w), 5),
        "plain": (lambda: attention_bwd_ref(*nxt(), window=w), 2),
        "library": (lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True), 5)})
    flops = kc.attention_flops(B, S, H, hd, window=w, backward=True)
    nbytes = kc.attention_bytes(B, S, H, KV, hd, q.element_size(),
                                backward=True)
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    print(f"[5] flash backward at {what}'s training shape B={B} S={S} "
          f"H={H} KV={KV} hd={hd} bf16 causal window {w} (kernel == plain "
          f"there, max |err| {err:.3g}): " + rounds_text(ms)
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} "
          f"GFLOP over the band's {pairs} (query, key) pairs at the bf16 "
          f"tensor-core rate, {nbytes / 1e6:.2f} MB at {t_bytes:.4f} ms); "
          f"kernel at {flops / ms['kernel'][0] / 1e9:.2f} TFLOP/s, library "
          f"(SDPA, K/V repeated, the band as a boolean mask) at "
          f"{flops / ms['library'][0] / 1e9:.2f}; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    del nxt, leaves, lib_out
    gc.collect()
    torch.cuda.empty_cache()
    return (ms, max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", err)


def phase5_danube(np, torch, dev, card):
    """The flash forward and backward at h2o-danube-1.8b's shapes (hd 80,
    window 4096): the forward at the serving prefill
    (:func:`band_forward`), the backward at the training shape, held to
    its plain version there (``check_bwd``'s bf16 tolerance) and timed
    as :func:`band_forward` times the forward (its SDPA through
    autograd), beside the bound of the band's five products
    (:func:`band_backward`).  Returns (forward ms, backward ms) of the
    kernel."""
    H, KV, hd = DANUBE_HEADS
    w = DANUBE_WINDOW
    fwd = band_forward(np, torch, dev, card, "h2o-danube-1.8b",
                       *DANUBE_PREFILL, H, KV, hd, w)[0]["kernel"][0]
    ms = band_backward(np, torch, dev, card, "h2o-danube-1.8b",
                       *DANUBE_TRAIN, H, KV, hd, w)[0]
    return fwd, ms["kernel"][0]


def phase5_moe(np, torch, dev, card):
    """The flash pair at each MoE decoder's grouped heads (MOE_SHAPES:
    qwen3-moe-30b-a3b's 32 query heads on 4 KV heads of 128, dbrx-132b's
    48 on 8, causal) and bf16: the forward at the serving prefill
    MOE_PREFILL against its plain version and SDPA (GQA), the backward
    at the training shape MOE_TRAIN against its plain version and SDPA's
    backward through autograd, each held to its plain version there and
    timed by the profiler in mirrored rounds (:func:`timed_rounds`)
    beside its bound; and the RMSNorm pair at the decoder's width, the
    forward at the prefill's B·S rows (the model's ``round_scale``
    form), the backward at the training shape's (:func:`check_rms_bwd`),
    against their plain versions."""
    for name, H, KV, hd, D in MOE_SHAPES:
        model_flash(np, torch, dev, card, name, H, KV, hd, MOE_PREFILL,
                    MOE_TRAIN)
        moe_rmsnorm(np, torch, dev, name, D)
    gc.collect()
    torch.cuda.empty_cache()


def moe_rmsnorm(np, torch, dev, name, D):
    """:func:`phase5_moe`'s RMSNorm checks at width D."""
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref
    rows = MOE_PREFILL[0] * MOE_PREFILL[1]
    x, w = rms_inputs(np, torch, rows, D, "bfloat16", dev, seed=5)
    err = check_close(np, rmsnorm_cuda(x, w, round_scale=True),
                      rmsnorm_ref(x, w, round_scale=True), "bfloat16",
                      f"rmsnorm at {name}'s prefill")
    bwd_rows = MOE_TRAIN[0] * MOE_TRAIN[1]
    err_b = check_rms_bwd(np, torch, bwd_rows, D, "bfloat16", dev,
                          seed=6)[0]
    print(f"[5] rmsnorm at {name}'s width {D}, bf16: the forward at "
          f"({rows}, {D}) == plain, max |err| {err:.3g}; the backward at "
          f"({bwd_rows}, {D}) == plain, max |err| {err_b:.3g}", flush=True)

def phase5_frontends(np, torch, dev, card):
    """The flash and RMSNorm kernels at the frontend models' shapes
    (FRONTEND_SHAPES): the flash forward at each one's serving prefill
    (F rows + 512 tokens: internvl2-2b's 16 / 8 heads of 128 at S 768,
    musicgen-large's 32 / 32 of 64 at S 576), against its plain version
    and SDPA, and at musicgen's training shape (B 2, S 512: its trainer
    feeds tokens only) the backward, against its plain version and SDPA's
    backward (:func:`model_flash`); the RMSNorm forward at the prefill's
    rows and the backward at the training shape's, at width 2048, held to
    their plain versions and timed beside ``F.rms_norm`` and its backward
    (:func:`rmsnorm_pair`)."""
    for name, H, KV, hd, D, prefill, train in FRONTEND_SHAPES:
        model_flash(np, torch, dev, card, name, H, KV, hd, prefill, train)
        rmsnorm_pair(np, torch, dev, card, name, D, prefill[0] * prefill[1],
                     None if train is None else train[0] * train[1])
    gc.collect()
    torch.cuda.empty_cache()


def rmsnorm_pair(np, torch, dev, card, name, D, rows, bwd_rows):
    """The bf16 RMSNorm forward (the model's ``round_scale`` form) at
    (rows, D) and, where ``bwd_rows`` is given, its backward at
    (bwd_rows, D) (:func:`check_rms_bwd`), each held to its plain version
    and timed against it and ``F.rms_norm`` (its backward through
    autograd) beside the bytes' bound, by the profiler in mirrored
    rounds (:func:`timed_rounds`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_ref, rmsnorm_cuda,
                                             rmsnorm_ref)
    x, w = rms_inputs(np, torch, rows, D, "bfloat16", dev, seed=7,
                      on_card=True)
    err = check_close(np, rmsnorm_cuda(x, w, round_scale=True),
                      rmsnorm_ref(x, w, round_scale=True), "bfloat16",
                      f"rmsnorm at {name}'s prefill")
    nxt, n_sets = rotating((x,))
    w16 = w.to(torch.bfloat16)
    ms, clocks = timed_rounds(torch, {
        "kernel": (lambda: rmsnorm_cuda(nxt()[0], w, round_scale=True), 50),
        "plain": (lambda: rmsnorm_ref(nxt()[0], w, round_scale=True), 50),
        "library": (lambda: F.rms_norm(nxt()[0], (D,), w16, 1e-6), 50)})
    kc = roof().kernel_cost
    nbytes = kc.rmsnorm_bytes(rows, D, x.element_size(), w.element_size())
    print(f"[5] rmsnorm at {name}'s prefill ({rows}, {D}) bf16 (kernel == "
          f"plain, max |err| {err:.3g}): " + rounds_text(ms)
          + f"; bound {roof().times_ms(0, nbytes)[1]:.4f} ms "
          f"({nbytes / 1e6:.3f} "
          f"MB; bytes); library F.rms_norm; inputs rotated over {n_sets} "
          f"copies; SM clock {clocks} [{card}]", flush=True)
    if bwd_rows is None:
        return
    err = check_rms_bwd(np, torch, bwd_rows, D, "bfloat16", dev, seed=8,
                        on_card=True)[0]
    x, w = rms_inputs(np, torch, bwd_rows, D, "bfloat16", dev, seed=9,
                      on_card=True)
    g, _ = rms_inputs(np, torch, bwd_rows, D, "bfloat16", dev, seed=10,
                      on_card=True)
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
    nbytes = kc.rmsnorm_bytes(bwd_rows, D, x.element_size(), backward=True)
    print(f"[5] rmsnorm backward at {name}'s training shape ({bwd_rows}, "
          f"{D}) bf16 (kernel == plain, max |err| {err:.3g}): "
          + rounds_text(ms)
          + f"; bound {roof().times_ms(0, nbytes)[1]:.4f} ms "
          f"({nbytes / 1e6:.3f} MB; bytes); library F.rms_norm's backward "
          f"through autograd; inputs rotated over {n_sets} copies; SM clock "
          f"{clocks} [{card}]", flush=True)


def model_flash(np, torch, dev, card, name, H, KV, hd, prefill, train):
    """The bf16 causal flash pair at ``name``'s heads (H query heads on
    KV of hd): the forward at the serving prefill ``prefill`` (B, S), the
    backward at the training shape ``train`` (B, S; None: not timed),
    each held to its plain version there and timed against it and SDPA
    (GQA) or SDPA's backward through autograd, by the profiler in
    mirrored rounds (:func:`timed_rounds`), beside its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_ref, flash_attention_bwd_cuda,
        flash_attention_cuda)
    G = H // KV
    sdpa_in = lambda t, i: (t if i == 0 else t.repeat_interleave(G, dim=2)
                            ).transpose(1, 2)
    B, S = prefill
    q, k, v = flash_inputs(np, torch, B, S, H, KV, hd, "bfloat16", dev)
    err = check_close(np, flash_attention_cuda(q, k, v),
                      attention_ref(q, k, v), "bfloat16",
                      f"flash at {name}'s prefill shape")
    nxt, n_sets = rotating((q, k, v))
    try:
        F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (
            q, k, v)), is_causal=True, enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in nxt()), is_causal=True,
            enable_gqa=True)
    except TypeError:              # a torch without enable_gqa
        lib = lambda: F.scaled_dot_product_attention(
            *(sdpa_in(t, i) for i, t in enumerate(nxt())), is_causal=True)
    ms, clocks = timed_rounds(torch, {
        "kernel": (lambda: flash_attention_cuda(*nxt()), 20),
        "plain": (lambda: attention_ref(*nxt()), 5),
        "library": (lib, 20)})
    kc = roof().kernel_cost
    flops = kc.attention_flops(B, S, H, hd)        # two causal products
    nbytes = kc.attention_bytes(B, S, H, KV, hd, q.element_size())
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    print(f"[5] flash forward at {name}'s prefill B={B} S={S} "
          f"H={H} KV={KV} hd={hd} bf16 causal (kernel == plain there, max "
          f"|err| {err:.3g}): " + rounds_text(ms)
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} GFLOP"
          f" at the bf16 tensor-core rate, {nbytes / 1e6:.2f} MB at "
          f"{t_bytes:.4f} ms); kernel at {flops / ms['kernel'][0] / 1e9:.2f}"
          f" TFLOP/s, library (SDPA, GQA) at "
          f"{flops / ms['library'][0] / 1e9:.2f}; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    if train is None:
        return

    B, S = train
    q, k, v = flash_inputs(np, torch, B, S, H, KV, hd, "bfloat16", dev)
    do = flash_inputs(np, torch, B, S, H, KV, hd, "bfloat16", dev, 1)[0]
    o, lse = attention_ref(q, k, v, return_lse=True)
    err = max(check_bwd(np, g, r, "bfloat16",
                        f"flash bwd at {name}'s training shape {n}")
              for n, g, r in zip(
                  "dq dk dv".split(),
                  flash_attention_bwd_cuda(q, k, v, o, lse, do),
                  attention_bwd_ref(q, k, v, o, lse, do)))
    nxt, n_sets = rotating((q, k, v, o, lse, do))
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
    except TypeError:              # a torch without enable_gqa
        leaves = [sdpa_in(t, i).detach().requires_grad_(True)
                  for i, t in enumerate((q, k, v))]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    dout = do.transpose(1, 2)
    ms, clocks = timed_rounds(torch, {
        "kernel": (lambda: flash_attention_bwd_cuda(*nxt()), 20),
        "plain": (lambda: attention_bwd_ref(*nxt()), 5),
        "library": (lambda: torch.autograd.grad(out, leaves, dout,
                                                retain_graph=True), 20)})
    flops = kc.attention_flops(B, S, H, hd, backward=True)  # five products
    nbytes = kc.attention_bytes(B, S, H, KV, hd, q.element_size(),
                                backward=True)
    t_ops, t_bytes = roof().times_ms(flops, nbytes)
    print(f"[5] flash backward at {name}'s training shape B={B} "
          f"S={S} H={H} KV={KV} hd={hd} bf16 causal (kernel == plain there,"
          f" max |err| {err:.3g}): " + rounds_text(ms)
          + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.3f} GFLOP"
          f" at the bf16 tensor-core rate, {nbytes / 1e6:.2f} MB at "
          f"{t_bytes:.4f} ms); kernel at {flops / ms['kernel'][0] / 1e9:.2f}"
          f" TFLOP/s, library (SDPA's backward through autograd) at "
          f"{flops / ms['library'][0] / 1e9:.2f}; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    del nxt, leaves, out


def ptxas_report(log, pattern):
    """From a verbose build's compiler output: (registers, spill store
    bytes, spill load bytes) of each kernel whose mangled name matches
    ``pattern``, and the "Potential Performance Loss" lines naming one."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", line)
        if m:
            fn = m.group(1) if re.search(pattern, m.group(1)) else None
            if fn is not None:
                out.setdefault(fn, [0, 0, 0])
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn][0] = int(m.group(1))
    loss = [line.strip() for line in log.splitlines()
            if "Potential Performance Loss" in line
            and re.search(pattern, line)]
    return {k: tuple(v) for k, v in out.items()}, loss


def rglru_inputs(torch, B, S, W, dtype, dev, seed=0):
    """x, r_pre, i_pre, gate (B, S, W) in ``dtype``, Λ (W,) and h0 (B, W)
    float32, drawn on ``dev`` from a ``torch.Generator`` seeded with
    ``seed`` (a 4096-token prefill's inputs drawn by numpy on the host
    cost seconds a case): x, gate, h0 ~ N(0, 1), the gate pre-activations
    ~ N(0, 2²), Λ ~ U(−4, 4) (decays from a ≈ 0.87 to ≈ e⁻³²)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    td = getattr(torch, dtype)
    normal = lambda *shape, scale=1.0: (scale * torch.randn(
        shape, generator=gen, device=dev)).to(td)
    x = normal(B, S, W)
    rp, ip = normal(B, S, W, scale=2.0), normal(B, S, W, scale=2.0)
    gate = normal(B, S, W)
    lam = 8.0 * torch.rand(W, generator=gen, device=dev) - 4.0
    h0 = torch.randn(B, W, generator=gen, device=dev)
    return x, rp, ip, gate, lam, h0


def phase5_rgemma(np, torch, dev, card):
    """recurrentgemma-2b's kernels: the RG-LRU scan against its plain
    version over :func:`rglru_cases` (y at ``check_close``'s tolerances,
    RGLRU_F32 in float32; h_last at RGLRU_F32 in both dtypes), then timed
    at its prefill (RGLRU_TIMED, bf16, gate fused) against the plain
    version and its bound (``rglru_scan.scan_bytes`` at 3.35 TB/s; no
    library call computes it), both by queued events
    (:func:`event_rounds`), and a
    decode step's launch; the flash forward at its prefill
    (:func:`band_forward`); and ``ptxas``'s registers and spills of the
    hd-256 forward kernels and the scan, which must not spill, nor draw
    a "Potential Performance Loss" at hd 256.  Returns the scan's JSON
    entry without ``launches``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import (rglru_scan_cuda,
                                                rglru_scan_ref)
    err = {dt: 0.0 for dt in DTYPES}
    for i, (B, S, W, with_h0, gated, dt) in enumerate(rglru_cases()):
        x, rp, ip, g, lam, h0 = rglru_inputs(torch, B, S, W, dt, dev, i)
        args = (x, rp, ip, lam, h0 if with_h0 else None,
                g if gated else None)
        what = f"rglru B={B} S={S} W={W} h0={with_h0} gate={gated} {dt}"
        (y, hl), (yr, hr) = rglru_scan_cuda(*args), rglru_scan_ref(*args)
        err[dt] = max(err[dt], check_close(np, y, yr, dt, what, RGLRU_F32),
                      check_close(np, hl, hr, "float32", what + " h_last",
                                  RGLRU_F32))
        y2, hl2 = rglru_scan_cuda(*args)
        identical(torch, {"y": y, "h_last": hl}, {"y": y2, "h_last": hl2},
                  what + ", a second call")
    print(f"[5] rglru scan kernel == plain on {i + 1} cases, two calls bit "
          "for bit alike; max |err| "
          + ", ".join(f"{dt} {e:.3g}" for dt, e in err.items()), flush=True)

    B, S, W = RGLRU_TIMED
    x, rp, ip, g, lam, _ = rglru_inputs(torch, B, S, W, "bfloat16", dev)
    nxt, n_sets = rotating((x, rp, ip, g))
    call = lambda fn: (lambda t: fn(t[0], t[1], t[2], lam, None, t[3]))(
        nxt())
    ms, clocks = event_rounds(torch, {
        "kernel": (lambda: call(rglru_scan_cuda), 20),
        "plain": (lambda: call(rglru_scan_ref), 3)}, queued=True)
    nbytes = roof().kernel_cost.rglru_bytes(B, S, W, 2, gated=True)
    bound = roof().times_ms(0, nbytes)[1]
    print(f"[5] rglru scan at recurrentgemma-2b's prefill B={B} S={S} W={W} "
          f"bf16, gate fused: " + rounds_text(ms) + f"; bound {bound:.4f} ms "
          f"({nbytes / 1e6:.2f} MB; bytes); kernel at "
          f"{nbytes / ms['kernel'][0] / 1e6:.1f} GB/s; inputs rotated over "
          f"{n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    step = [t[:, :1].contiguous() for t in (x, rp, ip, g)]
    h0 = torch.zeros(B, W, dtype=torch.float32, device=dev)
    step_ms = queued_ms(torch, lambda: rglru_scan_cuda(
        step[0], step[1], step[2], lam, h0, step[3]), 200)
    print(f"[5] rglru scan at a decode step B={B} S=1 W={W} bf16 (one warp "
          f"a block): {step_ms:.5f} ms by queued events [{card}]", flush=True)
    del nxt, step
    gc.collect()
    torch.cuda.empty_cache()
    band_forward(np, torch, dev, card, "recurrentgemma-2b", *RGEMMA_PREFILL,
                 *RGEMMA_HEADS, RGEMMA_WINDOW)

    regs, loss = ptxas_report(_build.LOGS.get("flash_attention", ""),
                              rf"flash_(tc|fwd)_kernelILi{FLASH_WIDE_HD}E")
    more, loss_rg = ptxas_report(_build.LOGS.get("rglru_scan", ""),
                                 r"rglru_(prefill|decode)_kernel")
    regs.update(more)
    if not all(any(k in fn for fn in more)
               for k in ("rglru_prefill_kernel", "rglru_decode_kernel")):
        raise AssertionError("the rglru scan's prefill and decode kernels "
                             f"are missing from the build log: {more}")
    print("[5] ptxas, hd-256 flash forward and rglru scan kernels "
          "(registers, spill store / load bytes): " + "; ".join(
              f"{fn[:60]}… {r} regs, spills {st} / {ld}"
              for fn, (r, st, ld) in sorted(regs.items())), flush=True)
    for line in loss + loss_rg:
        print(f"[5]   {line}", flush=True)
    if len(regs) < 6 or any(st or ld for _, st, ld in regs.values()):
        raise AssertionError(f"hd-256 flash / rglru kernels missing from "
                             f"the build log or spilling: {regs}")
    if loss:
        raise AssertionError("ptxas serializes the hd-256 flash forward's "
                             f"wgmmas: {loss}")
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/models/rglru.py:109",
            "max_abs_err": max(err.values()), "ms": ms["kernel"][0],
            "plain_ms": ms["plain"][0], "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def rglru_bwd_cases():
    """Phase 5's RG-LRU backward grid: the forward's (:func:`rglru_cases`),
    then the edge cases (``edge`` True): (B, S, W, h0, gate, dtype,
    edge)."""
    B, S, W = RGLRU_EDGE
    return itertools.chain(
        (case + (False,) for case in rglru_cases()),
        ((B, S, W, True, True, dt, True) for dt in DTYPES))


def rglru_bwd_close(np, torch, got, want, dt, what):
    """Max |got − want| of one RG-LRU backward output: float32 at
    ``RGLRU_F32`` (:func:`check_close`), bfloat16 within 2e-2·max|want|
    (:func:`check_bwd`); non-finite entries (the edge's) must sit at the
    same places with the same values, and are left out of the rest."""
    bad = ~torch.isfinite(want)
    if not torch.equal(bad, ~torch.isfinite(got)) or not torch.equal(
            torch.isnan(want), torch.isnan(got)) or not torch.equal(
            want[torch.isinf(want)], got[torch.isinf(got)]):
        raise AssertionError(f"{what}: non-finite entries differ")
    if bad.any():
        got = torch.where(bad, torch.zeros_like(got), got)
        want = torch.where(bad, torch.zeros_like(want), want)
    if dt == "float32":
        return check_close(np, got, want, "float32", what, RGLRU_F32)
    return check_bwd(np, got, want, "bfloat16", what)


def check_rglru_bwd(np, torch, case, dev, seed):
    """One RG-LRU backward case (:func:`rglru_bwd_cases`): the forward
    kernel's entering states against the plain forward's, then
    ``rglru_scan_bwd_cuda`` on them against ``rglru_scan_bwd_ref`` on the
    same inputs (dy drawn, h_last's cotangent on odd ``seed``): dx,
    dr_pre, di_pre, dgate at :func:`rglru_bwd_close`, dh0 at
    ``RGLRU_F32``, dΛ within ``RGLRU_LAM_RTOL``·max |plain dΛ|; two calls
    bit for bit alike.  Returns the max |err| of the compute-dtype
    outputs and dΛ's."""
    from repro_torch.kernels.rglru_scan import (
        rglru_scan_bwd_cuda, rglru_scan_bwd_ref, rglru_scan_cuda,
        rglru_scan_ref)
    B, S, W, with_h0, gated, dt, edge = case
    x, rp, ip, g, lam, h0 = rglru_inputs(torch, B, S, W, dt, dev, seed)
    if edge:
        rp[:, ::RGLRU_EDGE_EVERY, ::RGLRU_EDGE_EVERY] = RGLRU_EDGE_R
    h0, g = (h0 if with_h0 else None), (g if gated else None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1000)
    dy = torch.randn(B, S, W, generator=gen, device=dev).to(x.dtype)
    dh = (torch.randn(B, W, generator=gen, device=dev) if seed % 2
          else None)
    what = (f"rglru bwd B={B} S={S} W={W} h0={with_h0} gate={gated} {dt}"
            f" dh={dh is not None}" + " edge" * edge)
    args = (x, rp, ip, lam)
    st = rglru_scan_cuda(*args, h0, g, return_states=True)[2]
    check_close(np, st, rglru_scan_ref(*args, h0, g, return_states=True)[2],
                "float32", what + " states", RGLRU_F32)
    got = rglru_scan_bwd_cuda(*args, dy, st, h0, g, dh)
    again = rglru_scan_bwd_cuda(*args, dy, st, h0, g, dh)
    names = ("dx", "dr_pre", "di_pre", "dlam", "dh0", "dgate")
    identical(torch, {n: t for n, t in zip(names, got) if t is not None},
              {n: t for n, t in zip(names, again) if t is not None},
              what + ", a second call")
    want = rglru_scan_bwd_ref(*args, dy, h0, g, dh)
    err = 0.0
    for n, a, b in zip(names, got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{what} {n}: {a is None} vs {b is None}")
        if a is None or n == "dlam":
            continue
        err = max(err, rglru_bwd_close(np, torch, a, b,
                                       "float32" if n == "dh0" else dt,
                                       f"{what} {n}"))
    dl, dw = got[3], want[3]
    ok = torch.isfinite(dw)
    if not (torch.equal(ok, torch.isfinite(dl))
            and torch.equal(torch.isnan(dl), torch.isnan(dw))):
        raise AssertionError(f"{what} dlam: non-finite entries differ")
    top = _max_abs(torch, dw[ok]) if ok.any() else 0.0
    lerr = _max_abs(torch, (dl - dw)[ok]) if ok.any() else 0.0
    if not lerr <= RGLRU_LAM_RTOL * top:
        raise AssertionError(f"{what} dlam: max |diff| {lerr} (max |plain| "
                             f"{top})")
    return err, lerr / max(top, 1e-30)


def phase5_rgemma_bwd(np, torch, dev, card):
    """recurrentgemma-2b's training kernels: the RG-LRU backward against
    its plain version over :func:`rglru_bwd_cases` (:func:`check_rglru_bwd`)
    and timed at the training shape (RGLRU_BWD_TIMED, bf16, gated, h_last
    unused) against the plain version and its bound
    (``rglru_scan.scan_bwd_bytes`` at 3.35 TB/s; no library call computes
    it), both by queued events; the flash backward at hd 256 at the
    training shape (:func:`band_backward`); and ``ptxas``'s registers and
    spills of the RG-LRU backward's kernels and of the hd-256 flash
    backward's, which must not spill.  Returns the RG-LRU backward's
    JSON entry without ``launches``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import (
        rglru_scan_bwd_cuda, rglru_scan_bwd_ref, rglru_scan_cuda)
    err = {dt: 0.0 for dt in DTYPES}
    lam_rel = 0.0
    for i, case in enumerate(rglru_bwd_cases()):
        e, le = check_rglru_bwd(np, torch, case, dev, i)
        err[case[5]] = max(err[case[5]], e)
        lam_rel = max(lam_rel, le)
    print(f"[5] rglru backward kernel == plain on {i + 1} cases (the edge "
          f"r_pre = {RGLRU_EDGE_R} included), on the forward kernel's "
          "entering states (== plain), two calls bit for bit alike; max "
          "|err| " + ", ".join(f"{dt} {e:.3g}" for dt, e in err.items())
          + f"; dΛ within {lam_rel:.3g} of max |plain dΛ| (bound "
          f"{RGLRU_LAM_RTOL})", flush=True)

    B, S, W = RGLRU_BWD_TIMED
    x, rp, ip, g, lam, _ = rglru_inputs(torch, B, S, W, "bfloat16", dev)
    dy = rglru_inputs(torch, B, S, W, "bfloat16", dev, 1)[0]
    st = rglru_scan_cuda(x, rp, ip, lam, None, g, return_states=True)[2]
    nxt, n_sets = rotating((x, rp, ip, g, dy, st))
    ms, clocks = event_rounds(torch, {
        "kernel": (lambda: (lambda t: rglru_scan_bwd_cuda(
            t[0], t[1], t[2], lam, t[4], t[5], None, t[3]))(nxt()), 20),
        "plain": (lambda: (lambda t: rglru_scan_bwd_ref(
            t[0], t[1], t[2], lam, t[4], None, t[3]))(nxt()), 3)},
        queued=True)
    split = {n: v for key, v in profile_device(
        torch, lambda: (lambda t: rglru_scan_bwd_cuda(
            t[0], t[1], t[2], lam, t[4], t[5], None, t[3]))(nxt()),
        20).items() for n in RGLRU_BWD_KERNELS if n in key}
    nbytes = roof().kernel_cost.rglru_bwd_bytes(B, S, W, 2, gated=True)
    bound = roof().times_ms(0, nbytes)[1]
    print(f"[5] rglru backward at recurrentgemma-2b's training shape B={B} "
          f"S={S} W={W} bf16, gated, h_last unused: " + rounds_text(ms)
          + "; per launch (profiler) " + ", ".join(
              f"{n} {v:.4f} ms" for n, v in split.items())
          + f"; bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB; bytes); kernel "
          f"at {nbytes / ms['kernel'][0] / 1e6:.1f} GB/s; inputs rotated "
          f"over {n_sets} copies; SM clock {clocks} [{card}]", flush=True)
    del nxt, st
    gc.collect()
    torch.cuda.empty_cache()
    band_backward(np, torch, dev, card, "recurrentgemma-2b", *RGEMMA_TRAIN,
                  *RGEMMA_HEADS, RGEMMA_WINDOW)

    regs, _ = ptxas_report(_build.LOGS.get("rglru_scan", ""),
                           r"rglru_bwd_(\w+_)?kernel")
    wide, loss = ptxas_report(_build.LOGS.get("flash_attention", ""),
                              rf"bwd_\w+kernelILi{FLASH_WIDE_HD}E")
    if not all(any(n in fn for fn in regs) for n in RGLRU_BWD_KERNELS):
        raise AssertionError("the rglru backward's kernels are missing from "
                             f"the build log: {regs}")
    regs.update(wide)
    print("[5] ptxas, rglru backward and hd-256 flash backward kernels "
          "(registers, spill store / load bytes): " + "; ".join(
              f"{fn[:60]}… {r} regs, spills {st} / {ld}"
              for fn, (r, st, ld) in sorted(regs.items())), flush=True)
    for line in loss:
        print(f"[5]   {line}", flush=True)
    if len(wide) < 4 or any(st or ld for _, st, ld in regs.values()):
        raise AssertionError(f"rglru / hd-256 flash backward kernels missing "
                             f"from the build log or spilling: {regs}")
    return {"name": "rglru_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/models/rglru.py:109",
            "max_abs_err": max(err.values()), "ms": ms["kernel"][0],
            "plain_ms": ms["plain"][0], "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def teacher_force(np, torch, model, toks, prompt_len, max_len, impl,
                  embeds=None):
    """Per-step logits (steps, B, V) of ``toks`` (B, prompt + new) fed
    through prefill and decode steps, as the engine feeds a group: a
    modality model's prefill after the frontend rows ``embeds`` (B, F, D;
    bf16, as the engine rounds them), whose clock must then be F +
    prompt."""
    from repro_torch.models import decode_step, prefill
    dev = model.embed.device
    t = torch.from_numpy(np.ascontiguousarray(toks)).to(dev)
    logits, cache = prefill(model, t[:, :prompt_len].to(torch.int32),
                            embeds=embeds, max_len=max_len, impl=impl)
    F = 0 if embeds is None else embeds.shape[1]
    if cache["length"] != F + prompt_len:
        raise AssertionError(f"prefill clock {cache['length']} != "
                             f"{F} frontend rows + {prompt_len} tokens")
    steps = [logits]
    for j in range(prompt_len, toks.shape[1] - 1):
        logits, cache = decode_step(model, cache, t[:, j:j + 1], impl=impl)
        steps.append(logits)
    return torch.stack(steps)


def ring_check(np, torch, run, a, tag):
    """The ring of every ``local`` layer after a prefill of the first
    wave's prompts on the kernels: slot p % w holds position p's key and
    value for the last w positions, bit for bit the layer's own
    projection of its input, which the check forms by running the blocks
    below it as the prefill runs them; a prompt shorter than w leaves the
    slots past it zero."""
    from repro_torch.models import prefill
    from repro_torch.models.attention import _project
    from repro_torch.models.layers import (apply_rope, embed_tokens,
                                           rmsnorm, rope_angles)
    model, cfg = run.model, run.cfg
    dev = model.embed.device
    toks = torch.from_numpy(np.stack(run.prompts[:a.batch])).to(dev)
    B, S = toks.shape
    w = cfg.sliding_window
    pos = torch.arange(max(0, S - w), S, device=dev)
    local = [i for i, kind in enumerate(cfg.layer_kinds()) if kind == "local"]
    with torch.no_grad():
        _, cache = prefill(model, toks, max_len=a.max_len)
        x = embed_tokens(model.embed, toks, cfg)
        rot = rope_angles(torch.arange(S, device=dev), cfg.head_dim,
                          cfg.rope_theta)
        for i, blk in enumerate(model.blocks[:local[-1] + 1]):
            if i in local:
                h = rmsnorm(x, blk.ln1, cfg.norm_eps, cfg.gemma_norm)
                _, k, v = _project(blk.weights(x.dtype)["attn"], h, cfg)
                k = apply_rope(k, *rot)
                for name, t in (("k", k), ("v", v)):
                    ring = cache["layers"][i][name]
                    if ring.shape[1] != w:
                        raise AssertionError(f"layer {i}: ring of {w} slots "
                                             f"wanted, {ring.shape[1]} held")
                    if not torch.equal(ring[:, pos % w],
                                       t[:, pos].to(ring.dtype)):
                        raise AssertionError(f"layer {i} ring {name}: slot "
                                             f"p % {w} does not hold p")
                    if S < w and ring[:, S:].any():
                        raise AssertionError(f"layer {i} ring {name}: slots "
                                             "past the prompt are not zero")
            x, _ = blk(x, rot=rot, length=0, cache=None, mode="prefill",
                       max_len=a.max_len, impl="auto")
    print(f"[{tag}] ring check: the {w}-slot rings of all {len(local)} local "
          f"layers after a prefill of {B} × {S} tokens hold positions "
          f"{int(pos[0])}..{S - 1} at slot p % {w}, bit for bit each layer's "
          "projection of its input"
          + (f"; slots {S}..{w - 1} zero" if S < w else
             f" ({S % w} slots rolled)"), flush=True)
    del cache


def routed(np, torch, model, toks, prompt_len, max_len, impl,
           replay=None, embeds=None):
    """:func:`teacher_force` inside ``repro_torch.models.moe.routing``:
    (its logits, the experts each MoE layer picked, call by call; empty
    for a model without experts).  With ``replay`` (such a record of the
    same tokens) the layers take those experts instead."""
    from repro_torch.models import moe
    with moe.routing(replay) as rec:
        out = teacher_force(np, torch, model, toks, prompt_len, max_len,
                            impl, embeds)
    return out, rec


def sets_apart(a, b):
    """Two routing records of the same calls compared as sets of experts,
    token by token: (the top-k sets that differ, the sets compared)."""
    d = [(x.sort(-1).values != y.sort(-1).values).any(-1)
         for x, y in zip(a, b)]
    return sum(int(t.sum()) for t in d), sum(t.numel() for t in d)


def by_layer(torch, rec, n_moe, batch):
    """An incremental run's routing record (a prefill's n_moe calls, then
    each decode step's, layer by layer) as a whole-sequence pass makes
    its calls: one a layer over every (row, position), row-major."""
    return [torch.cat([c.view(batch, -1, c.shape[-1])
                       for c in rec[i::n_moe]], 1).flatten(0, 1)
            for i in range(n_moe)]


def stepwise(torch, model, toks, prompt_len):
    """Incremental decoding of ``toks`` (B, T) token by token, each a
    decode step (impl "cuda") from an empty cache whose keys and values
    are float32: (the logits (T − prompt_len + 1, B, V) of positions
    prompt_len − 1 on, the routing record).  The serving cache is bf16;
    a float32 model's whole-sequence pass is held to this one."""
    from repro_torch.models import decode_step, init_cache, moe
    B, T = toks.shape
    cache = init_cache(model.cfg, B, T, device=toks.device)
    cache["layers"] = [{k: v.float() for k, v in layer.items()}
                       for layer in cache["layers"]]
    steps = []
    with moe.routing() as rec:
        for j in range(T):
            logits, cache = decode_step(model, cache, toks[:, j:j + 1],
                                        impl="cuda")
            if j >= prompt_len - 1:
                steps.append(logits)
    return torch.stack(steps), rec


def teacher_checks(np, torch, run, a, tag, t_phase):
    """Teacher-forced checks of a served run, per wave.  The kernel path
    must reproduce the served tokens.  The plain path (impl="ref") is
    held to it in the served bf16 compute within 2e-2 of max |logit|, or
    the plain path's own bf16 rounding error (against float32 compute)
    where larger, and on the same weights in float32 compute within 1e-4
    at prefill and 5e-3 in decode (the bounds of
    tests/test_torch_transformer.py; the bf16 caches can round a
    last-bit change apart).

    A MoE model is compared at the capacity factor E / k, under which an
    expert's capacity is at least a call's tokens, so that none drops
    (checked from the routes), as the reference's decode-consistency
    test runs at a factor without drops: drops depend on a call's token
    count, which a whole-sequence pass and incremental decode do not
    share.  Each comparison runs on one routing
    (``repro_torch.models.moe.routing``): the plain path takes the
    experts the kernel path picked, and the plain path's bf16 rounding
    error is taken on the float32 path's experts, since a top-k set that
    rounding flips sends a token to other experts, a difference that no
    tolerance on the logits describes; the sets each side would have
    flipped are counted.  There, on the first wave, a whole-sequence pass
    on the kernels in float32 compute is also held within 2e-2 of an
    incremental one (:func:`stepwise`: every token a decode step, on a
    float32 cache, since the served bf16 cache rounds the keys and values
    that the whole pass keeps in float32), on the incremental pass's
    experts.

    A modality model's waves are forced after their requests' own
    frontend rows (``run.embeds``, rounded to bf16 as the engine rounds
    them), and each prefill's clock is checked to be F + prompt."""
    from repro_torch.models import Model, forward, moe
    from repro_torch.models.transformer import _head
    cfg, dev, P = run.cfg, run.model.embed.device, a.prompt_len
    spans = [range(w, min(w + a.batch, len(run.prompts)))
             for w in range(0, len(run.prompts), a.batch)]
    waves = [np.stack([np.concatenate([run.prompts[i], run.outputs[i]])
                       for i in span]) for span in spans]
    rows = [None if run.embeds is None else torch.from_numpy(np.stack(
        [run.embeds[i] for i in span])).to(dev, torch.bfloat16)
        for span in spans]
    served = lambda toks: torch.from_numpy(toks[:, P:].T.copy()).to(dev)
    reproduced = lambda ker, toks: torch.equal(ker.argmax(-1), served(toks))
    model, tree, agree = run.model, run.model.tree(), 0
    if cfg.is_moe:
        for toks in waves:                 # at the served factor first
            ker = teacher_force(np, torch, model, toks, P, a.max_len,
                                "cuda")
            if not reproduced(ker, toks):
                raise AssertionError("teacher-forced kernel logits do not "
                                     "reproduce the served tokens")
            agree += toks[:, P:].size
        del ker
        for m in model.modules():            # the served model's casts
            if hasattr(m, "_memo"):
                m._memo = (None, None)
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, moe_capacity_factor=(
            cfg.n_experts / cfg.n_experts_per_token))
        model = Model(cfg, tree)
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), tree)
    n_moe = cfg.layer_kinds().count("moe")
    rel = lambda a, b: ((a - b).abs().amax((1, 2))
                        / a.abs().amax((1, 2))).cpu().numpy()
    bf16, floor, f32, whole, most = [], [], [], [], 0
    sets = {k: [0, 0] for k in ("bf16", "f32", "floor", "whole")}
    for toks, emb in zip(waves, rows):
        tf = lambda m, impl, replay=None: routed(
            np, torch, m, toks, P, a.max_len, impl, replay, emb)
        ker, rk = tf(model, "cuda")
        if not n_moe:
            if not reproduced(ker, toks):
                raise AssertionError("teacher-forced kernel logits do not "
                                     "reproduce the served tokens")
            agree += toks[:, P:].size
        ref, own = tf(model, "ref", rk)
        ref32, r32 = tf(m32, "ref")
        counts = [("bf16", rk, own)]
        if n_moe:               # the plain bf16 path on float32's experts
            ref_f, own_f = tf(model, "ref", r32)
            counts.append(("floor", r32, own_f))
        else:
            ref_f = ref
        k32, rk32 = tf(m32, "cuda")
        if n_moe:
            ref32k, own32 = tf(m32, "ref", rk32)
            counts.append(("f32", rk32, own32))
        else:
            ref32k = ref32
        bf16.append(rel(ker, ref))
        floor.append(rel(ref32, ref_f))
        f32.append(rel(k32, ref32k))
        if n_moe and not len(whole):
            B, t = toks.shape[0], torch.from_numpy(toks[:, :-1]).to(dev)
            with torch.no_grad():
                inc, rs = stepwise(torch, m32, t, P)
                rs = by_layer(torch, rs, n_moe, B)
                with moe.routing(rs) as own_w:
                    h, _ = forward(m32, t, impl="cuda")
                full = _head(h[:, P - 1:], m32).transpose(0, 1)
            counts.append(("whole", rs, own_w))
            whole.append(rel(full, inc))
            del h, full, inc
        for rec in (rk, r32, rk32):
            for top_i in rec:
                load = int(torch.bincount(top_i.reshape(-1),
                                          minlength=cfg.n_experts).max())
                most = max(most, load)
                if load > moe.capacity(top_i.shape[0], cfg):
                    raise AssertionError(f"a token dropped at factor "
                                         f"{cfg.moe_capacity_factor:g}: "
                                         f"load {load}")
        for key, x, y in counts:
            n, n_all = sets_apart(x, y)
            sets[key][0] += n
            sets[key][1] += n_all
        del ker, ref, ref_f, ref32, k32, ref32k
    bf16, floor, f32 = (np.stack(x) for x in (bf16, floor, f32))
    if not (f32[:, 0].max() <= 1e-4 and f32[:, 1:].max() <= 5e-3):
        raise AssertionError(f"float32 compute: impl=ref logits differ by "
                             f"{f32[:, 0].max()} at prefill, "
                             f"{f32[:, 1:].max()} in decode")
    bound = max(2e-2, float(floor.max()))
    if not bf16.max() <= bound:
        raise AssertionError(f"bf16 compute: impl=ref logits differ by "
                             f"{bf16.max()} of max |logit| > {bound}")
    text = ""
    if n_moe:
        whole = np.stack(whole)
        if not whole.max() <= 2e-2:
            raise AssertionError(f"float32 compute: the whole-sequence pass "
                                 f"differs from the incremental one by "
                                 f"{whole.max()} of max |logit| > 2e-2")
        text = (f"; at the capacity factor {cfg.moe_capacity_factor:g}, "
                f"under which no token drops (the most tokens an expert "
                f"took in one call {most}; the served runs keep "
                f"{run.cfg.moe_capacity_factor:g}), each comparison on one "
                f"routing: on the first wave in float32 compute, the whole-"
                f"sequence pass against decode steps from an empty float32 "
                f"cache {whole.max():.3g} (median {np.median(whole):.3g}; "
                f"bound 2e-2); top-k sets the other side would "
                f"have picked differently: plain − kernel "
                f"{sets['bf16'][0]} of {sets['bf16'][1]} in bf16, "
                f"{sets['f32'][0]} of {sets['f32'][1]} in float32; plain "
                f"bf16 − float32 {sets['floor'][0]} of {sets['floor'][1]};"
                f" whole − incremental {sets['whole'][0]} of "
                f"{sets['whole'][1]}")
    if run.embeds is not None:
        text += (f"; every wave forced after its requests' own "
                 f"{cfg.frontend_tokens} frontend rows, each prefill's "
                 f"clock {cfg.frontend_tokens} + {P}")
    print(f"[{tag}] teacher-forced: kernel logits reproduce all {agree} "
          "served "
          f"tokens; impl=ref per-step logits, as a share of max |logit|: "
          f"bf16 max {bf16.max():.4g} (median {np.median(bf16):.4g}, "
          f"prefill max {bf16[:, 0].max():.4g}; bound {bound:.4g}: 2e-2 or "
          f"the plain path's bf16 rounding error, max {floor.max():.4g}, "
          f"median {np.median(floor):.4g}); float32 compute prefill "
          f"{f32[:, 0].max():.3g} (bound 1e-4), decode "
          f"{f32[:, 1:].max():.3g} (bound 5e-3){text}; "
          f"{time.perf_counter() - t_phase:.1f} s into the phase", flush=True)
    del model, m32


def moe_split(np, torch, model, cfg, a, tag, card):
    """The device time of the first MoE layer's four stages
    (``repro_torch.models.moe``: route (the router product, softmax, top
    k), dispatch, experts, combine) and of the whole ``moe_apply``, on
    its served bf16 weights and unit-normal inputs, at the served
    prefill's token count and a decode step's, by queued CUDA events
    (:func:`queued_ms`), beside the experts' bound (their weights read
    once, or their products at the bf16 tensor-core rate)."""
    from repro_torch.models import moe
    dev = model.embed.device
    w = model.blocks[0].weights(torch.bfloat16)["moe"]
    E, D, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for what, T in (("prefill", a.batch * a.prompt_len),
                    ("decode step", a.batch)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x = torch.randn(T, D, generator=gen, device=dev).to(torch.bfloat16)
        cap = moe.capacity(T, cfg)
        with torch.no_grad():
            top_p, top_i, _ = moe.route(x, w["router"], cfg)
            h, slot, ok = moe.dispatch(x, top_i, cap, E)
            o = moe.experts(h, w["w_gate"], w["w_up"], w["w_down"])
            stages = {
                "route": lambda: moe.route(x, w["router"], cfg),
                "dispatch": lambda: moe.dispatch(x, top_i, cap, E),
                "experts": lambda: moe.experts(h, w["w_gate"], w["w_up"],
                                               w["w_down"]),
                "combine": lambda: moe.combine(o, top_p, top_i, slot, ok),
                "moe_apply": lambda: moe.moe_apply(w, x[None], cfg)}
            ms = {k: queued_ms(torch, fn, 10) for k, fn in stages.items()}
        parts = sum(v for k, v in ms.items() if k != "moe_apply")
        flops = 6 * E * cap * D * f
        nbytes = 3 * E * D * f * 2
        bound = max(roof().times_ms(flops, nbytes))
        print(f"[{tag}] {cfg.name} MoE layer 0 at the {what} (T {T}, "
              f"capacity {cap} of {E} experts, top {cfg.n_experts_per_token}"
              f", bf16), device ms by queued events: "
              + ", ".join(f"{k} {v:.4f} ({v / parts:.3f})" for k, v in
                          ms.items() if k != "moe_apply")
              + f"; the four {parts:.4f}, moe_apply {ms['moe_apply']:.4f}; "
              f"the experts' bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e9:.3f} GB of expert weights) [{card}]",
              flush=True)
        del x, top_p, top_i, h, slot, ok, o


def waves_alone(np, run, a, tag):
    """Each wave after the first of a modality model's run served again
    alone, on the same model, through a fresh engine's blocking
    ``generate`` with its requests' own frontend rows: its tokens must
    be those the run served it after the waves before (the port's twin
    of the reference's ``test_per_wave_embeds``); the rows differ from
    every earlier wave's."""
    from repro_torch.serving import ServingEngine
    n, eng = len(run.prompts), run.engine
    for w in range(a.batch, n, a.batch):
        span = range(w, min(w + a.batch, n))
        if any(np.array_equal(run.embeds[i], run.embeds[j])
               for i in span for j in range(w)):
            raise AssertionError(f"wave at request {w}: frontend rows "
                                 "repeat an earlier wave's")
        alone = ServingEngine(run.model, run.cfg, eng.scfg,
                              impl=eng.impl).generate(
            [run.prompts[i] for i in span], [run.embeds[i] for i in span])
        for i, o in zip(span, alone):
            if not np.array_equal(o, run.outputs[i]):
                raise AssertionError(f"request {i} served alone with its "
                                     "rows differs from its wave's tokens")
    print(f"[{tag}] each later wave served alone with its own frontend rows"
          f" (distinct from every earlier wave's): its tokens equal the "
          f"run's", flush=True)


def serve_phase(np, torch, dev, card, argv, tag, embeds=None):
    """A serving path on the card, printed as phase ``tag``: serve
    ``argv`` through ``repro_torch.launch.serve`` (each request with its
    row of ``embeds``, a modality model's frontend rows, where given)
    with every model kernel's launch count reset just before and read
    just after, check the ring of a model with ``local`` layers
    (:func:`ring_check`), serve each later wave of a modality model
    alone (:func:`waves_alone`), teacher-force the served tokens, and
    trace a rerun.  Returns the launch counts by kernel name."""
    from repro_torch.kernels import (flash_attention as fa, rglru_scan as rg,
                                     rmsnorm as rn, ssd_scan as ss)
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    from repro_torch.models.transformer import _ATTN
    t_phase = time.perf_counter()
    a = serve.parse_args(argv)
    kernels = {"flash_attention": fa, "rmsnorm": rn, "ssd_scan": ss,
               "rglru_scan": rg}
    torch.cuda.synchronize()
    for m in kernels.values():
        m.reset_launch_count()
    run = serve.one_shot(argv, embeds)
    got = {name: m.launch_count() for name, m in kernels.items()}
    eng, cfg = run.engine, run.cfg
    # per prefill call: one flash launch per attention layer (attn,
    # local or moe), one SSD launch per ssd layer; per forward (prefill
    # or decode step): two RMSNorms per layer (four with post-norms) and
    # the final one, one RG-LRU scan per rglru layer
    forwards = eng.prefill_calls + eng.decode_steps
    kinds = cfg.layer_kinds()
    per = {"flash_attention": (sum(k in _ATTN for k in kinds),
                               eng.prefill_calls),
           "rmsnorm": ((4 if cfg.post_norms else 2) * cfg.n_layers + 1,
                       forwards),
           "ssd_scan": (kinds.count("ssd"), eng.prefill_calls),
           "rglru_scan": (kinds.count("rglru"), forwards)}
    want = {name: n * k for name, (n, k) in per.items()}
    if got != want:
        raise AssertionError(f"launches {got}, want {want}")
    for o in run.outputs:
        if not (len(o) == a.max_new and (o >= 0).all()
                and (o < cfg.vocab_size).all()):
            raise AssertionError(f"malformed completion {o}")
    st = run.stats()
    if "local" in kinds:
        ring_check(np, torch, run, a, tag)
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

    if cfg.is_moe:
        moe_split(np, torch, run.model, cfg, a, tag, card)
    if embeds is not None:
        waves_alone(np, run, a, tag)
    teacher_checks(np, torch, run, a, tag, t_phase)
    # the trace builds its own model: free this one first (gemma2's two
    # would not fit the card beside a prefill)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # the busy share of one wave of TRACE_NEW tokens (a prefill and its
    # decode steps): tracing the whole run costs minutes of profiler time
    # at mamba2's ≈ 3600 launches per forward
    wave = [*argv, "--requests", str(a.batch), "--max-new", str(TRACE_NEW)]
    rows = None if embeds is None else embeds[:a.batch]
    wall_ms = 1e3 * serve.one_shot(wave, rows).wall_s
    init = profile_device(torch, lambda: init_model(cfg, seed=0, device=dev))
    traced = profile_device(torch, lambda: serve.one_shot(wave, rows))
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
        scan = sum(ms for key, ms in traced.items()
                   if re.search(r"\brglru_(prefill|decode)_kernel<", key))
        if scan:
            print(f"[{tag}]   the RG-LRU scan's kernels: {scan:.3f} ms, "
                  f"{scan / busy:.4f} of the wave's device time", flush=True)
    else:
        print(f"[{tag}] traced rerun: the profiler saw no device time; the "
              "busy share is not measured", flush=True)

    return got


def train_batches(torch, dev, vocab, ticks, seed=0, seq=TRAIN_S,
                  workers=TRAIN_W):
    """Per tick, each of ``workers`` workers' ``TRAIN_B`` sequences, drawn
    (seeded) from a pool of ``TRAIN_POOL`` fixed random sequences of
    ``seq`` tokens, so that a model can learn them: a list of int32 (W,
    B, seq)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool = torch.randint(0, vocab, (TRAIN_POOL, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    idx = torch.randint(0, TRAIN_POOL, (ticks, workers, TRAIN_B),
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


def leaf_rel(torch, got, want):
    """Per leaf of two trees, max |got − want| / max |want| (float64)."""
    from repro_torch.tree import tree_leaves
    return [float((a.double() - b.double()).abs().max())
            / max(float(b.double().abs().max()), 1e-30)
            for a, b in zip(tree_leaves(got), tree_leaves(want))]


def train_phase(np, torch, dev, card, arch, tag, *, layers=None,
                ticks=TRAIN_TICKS, seq=TRAIN_S, warmup=None, fall=4,
                workers=TRAIN_W, beta=2, leafwise=False):
    """PSP training of ``arch`` at full width on the card (its first
    ``layers`` layers when given), built from the library calls that
    ``repro_torch.launch.train`` makes (``workers`` workers, β ``beta``):
    tick 0 against the plain path, ``ticks`` ticks of ``seq``-token
    sequences through the kernels (AdamW on ``warmup_cosine(3e-3, warmup,
    ticks)``), one traced tick; the mean loss of the last ``fall``
    pushing ticks must be below that of the first ``fall``; see the
    module docstring (phases 8, 12, 14, 16, 17 and 18).  Tick 0 is held
    leaf by leaf too for ``ssd``, ``rglru`` and ``moe`` stacks, and with
    ``leafwise``.  A MoE model's tick 0
    compares on one routing, as :func:`teacher_checks` does: the plain
    path on the kernel path's experts, its bf16 − float32 spread on the
    float32 path's; the top-k sets either side would have picked
    differently are counted.  Returns (the model
    kernels' launch counts of the run, cfg, params, optimizer, batches,
    the phase's start)."""
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import init_model, moe
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = train_config(arch, layers)
    W = workers
    warmup = ticks // 10 + 1 if warmup is None else warmup
    opt = psp_optimizer(ticks, warmup)
    params = init_model(cfg, seed=0, device=dev).tree()
    n_params = sum(p.numel() for p in tree_leaves(params))
    batches = train_batches(torch, dev, cfg.vocab_size, ticks + 1, seq=seq,
                            workers=W)
    trainer = lambda impl: psp_trainer(cfg, params, opt, dev, impl,
                                       workers=W, beta=beta)[:2]
    leafwise = leafwise or bool({"ssd", "rglru", "moe"}
                                & set(cfg.layer_kinds()))

    # (a) the first tick's per-worker losses and (clipped) gradients: the
    # kernels against the plain path in bf16 compute, beside the plain
    # path's own spread between float32 and bf16 compute; and the kernels
    # against the plain path in float32 compute (the f32 kernels), where
    # rounding is not amplified past a tight bound.  Attention stacks are
    # held over the whole tree (‖Δg‖/‖g‖), mamba2 and recurrentgemma also
    # leaf by leaf (max |Δg| over each leaf's max |g|: the small leaves,
    # such as Λ's, are lost in the whole tree's norm)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fns = {"cuda": make_grad_fn(cfg, 1.0, "cuda"),
           "ref": make_grad_fn(cfg, 1.0, "ref"),
           "ref32": make_grad_fn(cfg32, 1.0, "ref"),
           "cuda32": make_grad_fn(cfg32, 1.0, "cuda")}
    errs, leaf, sets = [], [], []
    for i in range(W):
        def grads(name, replay=None):
            with moe.routing(replay) as rec:
                loss, g = fns[name](params, batches[0][i])
            return float(loss), g, rec
        lk, gk, rk = grads("cuda")
        l32, g32, r32 = grads("ref32")
        lr, gr, own = grads("ref", rk)
        n_sets = [sets_apart(rk, own)]
        if cfg.is_moe:         # the plain bf16 path on float32's experts
            lf, gf, own = grads("ref", r32)
            n_sets.append(sets_apart(r32, own))
        else:
            lf, gf = lr, gr
        e = [abs(lk - lr), abs(l32 - lf), tree_rel(torch, gk, gr),
             tree_rel(torch, gf, g32)]
        if leafwise:
            leaf.append([leaf_rel(torch, gk, gr), leaf_rel(torch, gf, g32)])
        del gk, gr, gf
        lk32, gk32, rk32 = grads("cuda32")
        n_sets.append(sets_apart(rk32, r32))
        if n_sets[-1][0]:      # the plain float32 path on the kernels'
            l32, g32, _ = grads("ref32", rk32)
        e += [abs(lk32 - l32) / abs(l32), tree_rel(torch, gk32, g32)]
        errs.append(e)
        if leafwise:
            leaf[-1].append(leaf_rel(torch, gk32, g32))
        sets.append(n_sets)
        del g32, gk32
    errs = np.array(errs)
    if cfg.is_moe:
        print(f"[{tag}] tick 0 on one routing (the plain path on the "
              "kernel path's experts; its bf16 − f32 spread on float32's): "
              "top-k sets picked differently, per worker (the forward's and "
              "remat's calls): plain − kernel in bf16 "
              + ", ".join(f"{s[0][0]} of {s[0][1]}" for s in sets)
              + "; plain bf16 − f32 " + ", ".join(f"{s[1][0]} of {s[1][1]}"
                                                   for s in sets)
              + "; kernel − plain in float32 "
              + ", ".join(f"{s[2][0]} of {s[2][1]}" for s in sets),
              flush=True)
    bound = max(2e-2, float(errs[:, 3].max()))
    print(f"[{tag}] tick 0, per worker (W={W}): |loss kernels − plain| "
          f"{errs[:, 0].max():.4g} (plain bf16 − f32: {errs[:, 1].max():.4g});"
          f" ‖g kernels − g plain‖/‖g plain‖ {errs[:, 2].max():.4g} against "
          f"the plain path's ‖g bf16 − g f32‖/‖g f32‖ "
          f"{errs[:, 3].max():.4g} (bound {bound:.4g}: 2e-2 or that "
          f"spread); in float32 compute, loss {errs[:, 4].max():.3g} "
          f"relative (bound 1e-5), ‖Δg‖/‖g‖ {errs[:, 5].max():.3g} (bound "
          "1e-3)", flush=True)
    ok = (errs[:, 0].max() <= max(2e-2, errs[:, 1].max())
          and errs[:, 4].max() <= 1e-5 and errs[:, 2].max() <= bound
          and errs[:, 5].max() <= 1e-3)
    if leafwise:
        # leaf by leaf, relative to each leaf's max |g|: in bf16 compute
        # the kernels within the largest deviation that bf16 rounding
        # itself gives a leaf of the plain path (against float32 compute),
        # or 2e-2; in float32 compute within 1e-3
        leaf = np.array(leaf)                     # (W, 3, leaves)
        lbound = max(2e-2, float(leaf[:, 1].max()))
        top = leaf[:, 0].max(0)
        print(f"[{tag}] tick 0 leaf by leaf (max |Δg| / max |g|, "
              f"{leaf.shape[2]} leaves): kernels − plain up to "
              f"{top.max():.4g} (leaf {int(np.argmax(top))}; median over "
              f"leaves {float(np.median(top)):.4g}), the plain path's bf16 − "
              f"f32 up to {leaf[:, 1].max():.4g} (the bound); in float32 "
              f"compute up to {leaf[:, 2].max():.3g} (bound 1e-3)",
              flush=True)
        ok = ok and top.max() <= lbound and leaf[:, 2].max() <= 1e-3
    if not ok:
        raise AssertionError(f"kernel and plain tick 0 differ: {errs}")

    # (b) one tick on the plain path: its control plane (the caching
    # allocator's free blocks released first, each stage's shapes differ)
    gc.collect()
    torch.cuda.empty_cache()
    st, step = trainer("ref")
    st, _ = step(st, batches[0])
    ctrl_ref = {f: getattr(st, f).clone() for f in CONTROL}
    del st, step

    # (c) the main path: TICK ticks through the kernels
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts(torch)
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
    got = launch_counts()
    L = cfg.n_layers
    per = train_launches(cfg)
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
    first, last = np.mean(pushed[:fall]), np.mean(pushed[-fall:])
    if not (len(pushed) >= 2 * fall and all(map(math.isfinite, losses))
            and last < first):
        raise AssertionError(f"the loss did not fall: {losses}, pushes "
                             f"{pushes}")
    steady = walls[1:]
    wall = sum(steady) / len(steady)
    tokens = W * TRAIN_B * seq
    print(f"[{tag}] PSP training of {cfg.name} at full width ({L} layers, d="
          f"{cfg.d_model}, {n_params:,} params f32, {cfg.dtype} compute): "
          f"W={W} pbsp beta={beta} s=3 stragglers 0.25, {TRAIN_B}×{seq} "
          f"tokens per worker per tick, {ticks} ticks, AdamW on "
          f"warmup_cosine(3e-3, {warmup}, {ticks}); launches "
          + ", ".join(f"{k} {got[k]} = {per[k]} × {W} × {ticks}"
                      for k in per if per[k]) + f" [{card}]", flush=True)
    print(f"[{tag}] loss per tick {[round(x, 4) for x in losses]}; pushes "
          f"{pushes}; mean over the first {fall} pushing ticks {first:.4f}, "
          f"over the last {fall} {last:.4f}; control plane after tick 0 == "
          "the plain path's", flush=True)
    median = 1e3 * float(np.median(steady))
    print(f"[{tag}] wall per tick {1e3 * wall:.2f} ms (ticks 2..{ticks}: "
          f"their summed wall over their count; median {median:.2f} ms, "
          f"first tick {1e3 * walls[0]:.2f} ms), training "
          f"{tokens / wall:.1f} tokens/s (their {tokens * len(steady)} "
          f"tokens over their summed wall); peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} "
          f"GB [{card}]", flush=True)

    # (d) the device busy share of one traced tick, against an unprofiled
    # tick's wall
    box = {"st": st}
    del st  # the box holds the one state: two would not fit beside a tick

    def one_tick():
        box["st"], _ = step(box["st"], batches[ticks])
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    one_tick()
    tick_ms = 1e3 * (time.perf_counter() - t0)
    traced = profile_device(torch, one_tick)
    if traced:
        busy = sum(traced.values())
        print(f"[{tag}] traced tick: device busy {busy:.3f} ms of an "
              f"unprofiled tick's {tick_ms:.3f} ms wall: busy share "
              f"{busy / tick_ms:.4f}, idle share {1 - busy / tick_ms:.4f} "
              f"[{card}]", flush=True)
        for key, ms in sorted(traced.items(), key=lambda kv: -kv[1])[:10]:
            print(f"[{tag}]   {ms:9.3f} ms  {key[:90]}", flush=True)
        for what, names in (("flash", FLASH_BWD_KERNELS),
                            ("rmsnorm", RMS_BWD_KERNELS),
                            ("ssd", SSD_BWD_KERNELS),
                            ("rglru", RGLRU_BWD_KERNELS)):
            ms = sum(v for key, v in traced.items()
                     if any(n in key for n in names))
            if ms:
                print(f"[{tag}] traced tick: the {what} backward's kernels "
                      f"{ms:.3f} ms, {ms / busy:.4f} of the device time",
                      flush=True)
    else:
        print(f"[{tag}] traced tick: the profiler saw no device time; the "
              "busy share is not measured", flush=True)
    del box, step
    return got, cfg, params, opt, batches, t_phase


def phase12(np, torch, dev, card):
    """PSP training of full-width mamba2-780m on the card (phase 8's
    settings and token pool; see the module docstring).  Returns the
    model kernels' launch counts of the run."""
    return train_phase(np, torch, dev, card, MAMBA_TRAIN_ARCH, 12,
                       layers=MAMBA_TRAIN_LAYERS)[0]


def phase8(np, torch, dev, card):
    """PSP training of full-width qwen2-0.5b on the card, built from the
    library calls that ``repro_torch.launch.train`` makes, then where a
    worker's time goes and the reduced launchers; see the module
    docstring.  Returns the model kernels' launch counts of the run."""
    from repro_torch.launch.steps import make_grad_fn
    got, cfg, params, opt, batches, _ = train_phase(
        np, torch, dev, card, TRAIN_ARCH, 8, layers=TRAIN_LAYERS)

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

    return got


def train_config(arch=TRAIN_ARCH, layers=TRAIN_LAYERS):
    """``arch``'s config at full width, its depth cut to ``layers`` when
    given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def psp_optimizer(ticks, warmup=None):
    """The launcher's optimizer for a run of ``ticks`` ticks (its warm-up,
    ``ticks // 10 + 1``, unless ``warmup`` is given)."""
    from repro_torch.optim import adamw, warmup_cosine
    warmup = ticks // 10 + 1 if warmup is None else warmup
    return adamw(warmup_cosine(3e-3, warmup, ticks))


def psp_trainer(cfg, params, opt, dev, impl="auto", workers=TRAIN_W,
                beta=2):
    """The launcher's PSP trainer (W ``workers``, ``pbsp``, β ``beta``, s
    3, stragglers 0.25, noise seeded 1) on the parameter tree ``params``,
    built from the library calls ``repro_torch.launch.train`` makes:
    (state, step function, noise source)."""
    from repro_torch.core.spmd_psp import GeneratorNoise, PSPConfig, psp_init
    from repro_torch.launch.steps import make_psp_train_step
    pcfg = PSPConfig(barrier="pbsp", n_workers=workers, sample_size=beta,
                     staleness=3, straggler_frac=0.25)
    noise = GeneratorNoise(1, dev)
    return (psp_init(pcfg, params, opt.init, noise),
            make_psp_train_step(cfg, pcfg, opt, noise, impl=impl), noise)


def psp_run(torch, dev, cfg, ticks):
    """:func:`psp_trainer` on fresh seed-0 weights of ``cfg``, for a run
    of ``ticks`` ticks."""
    from repro_torch.models import init_model
    return psp_trainer(cfg, init_model(cfg, seed=0, device=dev).tree(),
                       psp_optimizer(ticks), dev)


def train_launches(cfg):
    """The model kernels' launches per worker and PSP tick of ``cfg``, any
    mix of block kinds: remat runs each block's forward twice (once
    without autograd, once recording in the backward) and its backward
    once: its attention, SSD scan or RG-LRU scan, and its norms
    (``ln1``/``ln2`` and the post-norms, or an ``ssd`` block's ``ln``
    and gated ``norm``); then the final norm once each way."""
    from repro_torch.models.transformer import _ATTN
    kinds = cfg.layer_kinds()
    count = lambda *ks: sum(k in ks for k in kinds)
    attn, ssd, rg = count(*_ATTN), count("ssd"), count("rglru")
    norms = (4 if cfg.post_norms else 2) * cfg.n_layers
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
            "ssd_scan": 2 * ssd, "ssd_scan_bwd": ssd,
            "rglru_scan": 2 * rg, "rglru_scan_bwd": rg}


def train_total(cfg, ticks):
    """:func:`train_launches` over TRAIN_W workers and ``ticks`` ticks."""
    return {k: n * TRAIN_W * ticks for k, n in train_launches(cfg).items()}


def launch_counts():
    """The model kernels' launch counts since their last reset."""
    from repro_torch.kernels import (flash_attention as fa, rglru_scan as rg,
                                     rmsnorm as rn, ssd_scan as ss)
    return {"flash_attention": fa.launch_count(),
            "flash_attention_bwd": fa.bwd_launch_count(),
            "rmsnorm": rn.launch_count(), "rmsnorm_bwd": rn.bwd_launch_count(),
            "ssd_scan": ss.launch_count(),
            "ssd_scan_bwd": ss.bwd_launch_count(),
            "rglru_scan": rg.launch_count(),
            "rglru_scan_bwd": rg.bwd_launch_count()}


def reset_launch_counts(torch):
    """Set the model kernels' launch counts to 0 (after a synchronize)."""
    from repro_torch.kernels import (flash_attention as fa, rglru_scan as rg,
                                     rmsnorm as rn, ssd_scan as ss)
    torch.cuda.synchronize()
    for m in (fa, rn, ss, rg):
        m.reset_launch_count()


def loop_trainer(torch, dev, out_dir) -> int:
    """Phase 9's trainer, run in a child interpreter (``python3
    chip_smoke.py --loop-trainer DIR``): phase 8's PSP run of full-width
    qwen2-0.5b (its first LOOP_LAYERS layers) for LOOP_TICKS ticks,
    publishing its server params to ``DIR`` as version 0 before the first
    tick, every LOOP_PUBLISH_EVERY ticks asynchronously and after the
    last tick blocking.  Prints
    ``published <version>`` as each publication is handed over, then one
    JSON line: the kernels' launches, the wall per tick (publishing
    included), the trainer thread's seconds per async publication and
    per blocking one, a snapshot's bytes and the peak device memory."""
    from repro_torch.serving import SnapshotPublisher
    cfg = train_config(TRAIN_ARCH, LOOP_LAYERS)
    st, step, _ = psp_run(torch, dev, cfg, LOOP_TICKS)
    batches = train_batches(torch, dev, cfg.vocab_size, LOOP_TICKS)
    pub = SnapshotPublisher(out_dir, cfg, every_steps=LOOP_PUBLISH_EVERY,
                            keep=LOOP_KEEP)
    blocking, sync, walls = [], [], []
    t0 = time.perf_counter()
    pub.publish(0, st.server_params, block=True)
    blocking.append(time.perf_counter() - t0)
    print("published 0", flush=True)
    reset_launch_counts(torch)
    for t in range(LOOP_TICKS):
        t0 = time.perf_counter()
        st, _ = step(st, batches[t])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        last = t + 1 == LOOP_TICKS
        if last:
            pub.publish(t + 1, st.server_params, block=True)
        published = last or pub.maybe_publish(t + 1, st.server_params)
        if published:
            (blocking if last else sync).append(time.perf_counter() - t1)
        walls.append(time.perf_counter() - t0)
        if published:
            print(f"published {t + 1}", flush=True)
    counts = launch_counts()
    pub.close()
    nbytes = os.path.getsize(os.path.join(out_dir,
                                          f"step_{LOOP_TICKS:08d}.npz"))
    print(json.dumps({"launches": counts, "walls": walls, "sync_s": sync,
                      "blocking_s": blocking, "bytes": nbytes,
                      "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}),
          flush=True)
    return 0


def replay_group(np, torch, model, cfg, scfg, blocks, served):
    """Teacher-force one decode group of phase 9's traffic on ``model``:
    its blocks of requests admitted at their recorded clocks by the
    engine's own admission (the same prefill shapes, left padding and
    slots as served), then decode steps of the whole group, where every
    live slot's argmax must be the token it served.  Returns the tokens
    checked."""
    from repro_torch.models import decode_step
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(model, cfg, scfg)
    g = eng._new_group()
    todo, live, checked = list(blocks), {}, 0
    while todo or live:
        if todo and (g.length is None or g.length == todo[0][0]):
            clock, reqs = todo.pop(0)
            slots = g.free()[:len(reqs)]
            eng._admit_block(g, [Request(prompt=p, req_id=rid,
                                         max_new_tokens=len(served[rid]))
                                 for rid, p in reqs])
            if g.length != clock:
                raise AssertionError(f"replayed clock {g.length} != {clock}")
            live.update({s: [rid, 0] for s, (rid, _) in zip(slots, reqs)})
        tok = torch.argmax(g.logits, dim=-1)
        got = tok.cpu().numpy()
        for s, (rid, j) in list(live.items()):
            if got[s] != served[rid][j]:
                raise AssertionError(f"request {rid}: teacher-forced token "
                                     f"{j} is {got[s]}, served "
                                     f"{served[rid][j]}")
            checked += 1
            live[s][1] += 1
            if live[s][1] == len(served[rid]):
                del live[s]
                g.slots[s] = None
        if not live:
            if todo:
                raise AssertionError("a block joined a finished group")
            break
        g.logits, g.cache = decode_step(g.params, g.cache, tok[:, None],
                                        impl=eng.impl)
        g.length += 1
    return checked


def phase9(np, torch, dev, card):
    """The trainer → bus → live server loop at full width; see the module
    docstring.  Returns the model kernels' launch counts of the loop (the
    server's and the trainer child's)."""
    import queue
    import threading
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.convert import (from_reference_layout, params_from_jax,
                                     params_to_numpy)
    from repro_torch.models import init_model
    from repro_torch.serving import (InferenceServer, Request, ServeConfig,
                                     ServingEngine, SnapshotWatcher)
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = train_config(TRAIN_ARCH, LOOP_LAYERS)
    out = ROOT / "build" / "phase9"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    template = params_to_numpy(init_model(cfg, seed=0, device=dev))
    torch.cuda.empty_cache()
    lines: "queue.Queue[str]" = queue.Queue()
    with open(out / "trainer.err", "w") as err:
        child = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), LOOP_CHILD,
             str(out)], stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=ROOT)
    reader = threading.Thread(target=lambda: [lines.put(x) for x in
                                              child.stdout], daemon=True)
    reader.start()

    def child_failed():
        if child.poll() not in (None, 0):
            raise AssertionError(f"the trainer child failed ({child.returncode}"
                                 f"): {(out / 'trainer.err').read_text()[-3000:]}")

    copies = {}               # version → its snapshot as read from disk

    def copy_new():
        for v in sorted(int(m.group(1)) for fn in os.listdir(out)
                        if (m := re.match(r"step_(\d+)\.npz$", fn))):
            if v not in copies and (out / f"step_{v:08d}.npz.json").exists():
                try:
                    copies[v], _ = restore_checkpoint(str(out), template, v)
                except (OSError, ValueError, KeyError):
                    pass      # removed under us: no server can load it now

    deadline = time.monotonic() + 600
    while latest_step(str(out)) is None:
        child_failed()
        if time.monotonic() > deadline:
            raise AssertionError("the trainer published no version 0")
        time.sleep(0.05)
    t_v0 = time.perf_counter() - t_phase
    watcher = SnapshotWatcher(str(out), template, cfg=cfg, device=dev)
    model0, v0 = watcher.poll()
    scfg = ServeConfig(batch=LOOP_BATCH, max_len=LOOP_MAX_LEN,
                       max_new_tokens=LOOP_NEW)
    eng = ServingEngine(model0, cfg, scfg, version=v0)
    # observe the engine: every swap (in flight or idle) with the model
    # it loaded, and every admitted block with its group and clock
    swaps = [(v0, False, model0)]
    set_params, admit_block = eng.set_params, eng._admit_block
    serial = itertools.count()
    blocks = []

    def spy_set(params, version=None):
        swaps.append((version, eng.has_pending(), params))
        return set_params(params, version)

    def spy_admit(g, reqs):
        admit_block(g, reqs)
        if not hasattr(g, "serial"):
            g.serial = next(serial)
        blocks.append((g.serial, g.version, g.length,
                       [(r.req_id, r.prompt) for r in reqs]))

    eng.set_params, eng._admit_block = spy_set, spy_admit
    rng = np.random.default_rng(0)
    futs, wave = [], []
    reset_launch_counts(torch)
    t_serve = time.perf_counter()
    srv = InferenceServer(eng, watcher=watcher, poll_every=LOOP_POLL_EVERY)
    try:
        while True:
            copy_new()
            child_failed()
            if wave and not all(f.done() for f in wave):
                time.sleep(0.02)
                continue
            versions = {f.result().snapshot_version for f in futs}
            inflight = any(s[1] for s in swaps[1:])
            if len(futs) >= LOOP_REQUESTS and len(versions) >= 2 \
                    and inflight or len(futs) >= LOOP_MAX_REQUESTS:
                break
            wave = [srv.submit(Request(prompt=rng.integers(
                0, cfg.vocab_size, LOOP_PROMPT).astype(np.int32)))
                for _ in range(LOOP_BATCH)]
            futs += wave
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    served_counts = launch_counts()
    comps = [f.result() for f in futs]
    child.wait(timeout=900)
    child_failed()
    reader.join(timeout=60)
    copy_new()
    got = []
    while not lines.empty():
        got.append(lines.get())
    trainer = json.loads(next(x for x in reversed(got) if x.startswith("{")))
    published = [int(x.split()[1]) for x in got if x.startswith("published")]

    # what the phase checks: versions, a swap in flight, exact launches
    versions = sorted({c.snapshot_version for c in comps})
    n_inflight = sum(s[1] for s in swaps[1:])
    if len(versions) < 2 or n_inflight < 1:
        raise AssertionError(f"the traffic spans versions {versions} with "
                             f"{n_inflight} swaps in flight")
    forwards = eng.prefill_calls + eng.decode_steps
    want = {"flash_attention": cfg.n_layers * eng.prefill_calls,
            "flash_attention_bwd": 0, "rmsnorm": (2 * cfg.n_layers + 1)
            * forwards, "rmsnorm_bwd": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
            "rglru_scan": 0, "rglru_scan_bwd": 0}
    if served_counts != want:
        raise AssertionError(f"server launches {served_counts}, want {want}")
    if trainer["launches"] != train_total(cfg, LOOP_TICKS):
        raise AssertionError(f"trainer launches {trainer['launches']}, want "
                             f"{train_total(cfg, LOOP_TICKS)}")
    counts = {k: served_counts[k] + trainer["launches"][k]
              for k in served_counts}
    if not all(counts[k] > 0 for k in counts
               if k not in ("ssd_scan", "ssd_scan_bwd", "rglru_scan",
                            "rglru_scan_bwd")):
        raise AssertionError(f"a kernel of the loop never ran: {counts}")

    # the server's loaded leaves against the published arrays, bit for bit
    for v, _, model in swaps:
        if v not in copies:
            raise AssertionError(f"version {v} was never read from disk")
        for a, b in zip(tree_leaves(model.tree()), tree_leaves(
                from_reference_layout(copies[v], cfg))):
            if not torch.equal(a, torch.from_numpy(
                    np.ascontiguousarray(b)).to(dev)):
                raise AssertionError(f"served version {v} differs from its "
                                     "published snapshot")
    swapped = [(v, inflight) for v, inflight, _ in swaps]
    stats = srv.stats
    del swaps, model0, model, eng, srv, watcher, spy_set, spy_admit, \
        set_params, admit_block
    gc.collect()
    torch.cuda.empty_cache()

    # each completion reproduced on the version it reports, from disk
    served = {c.req_id: c.tokens for c in comps}
    groups = {}
    for serial_, v, clock, reqs in blocks:
        groups.setdefault((v, serial_), []).append((clock, reqs))
    checked = 0
    for v in versions:
        model = params_from_jax(copies[v], cfg, dev)
        for (gv, _), bl in sorted(groups.items(), key=lambda kv: kv[0]):
            if gv == v:
                checked += replay_group(np, torch, model, cfg, scfg, bl,
                                        served)
        del model
        torch.cuda.empty_cache()
    n_tokens = sum(len(t) for t in served.values())
    if checked != n_tokens:
        raise AssertionError(f"replayed {checked} of {n_tokens} tokens")

    walls = 1e3 * np.array(trainer["walls"][1:])
    stalls = np.array(stats.swap_stalls)
    ttft = 1e3 * np.array(stats.first_token_lat)
    times = np.array(stats.token_times)
    n_dec = len(times) - len(ttft)
    print(f"[9] trainer (a child interpreter on the same card): "
          f"{LOOP_TICKS} PSP ticks of {cfg.name} at full width, "
          f"{cfg.n_layers} layers (phase 8's settings, W={TRAIN_W}), "
          f"versions {published} published (every "
          f"{LOOP_PUBLISH_EVERY} ticks, keep {LOOP_KEEP}); version 0 on "
          f"disk {t_v0:.1f} s into the phase; wall per tick with "
          f"publishing on {walls.mean():.2f} ms (ticks 2..{LOOP_TICKS}: "
          f"their summed wall over their count; median "
          f"{np.median(walls):.2f} ms); a snapshot {trainer['bytes']:,} "
          f"bytes, the trainer's thread {np.mean(trainer['sync_s']):.3f} s "
          f"per asynchronous publication (device → host copy, layout, "
          f"enqueue; {[round(x, 3) for x in trainer['sync_s']]}) and "
          f"{[round(x, 3) for x in trainer['blocking_s']]} s per blocking one "
          f"(the write included); peak device memory "
          f"{trainer['peak_gb']:.3f} GB [{card}]", flush=True)
    print(f"[9] server ({cfg.dtype}, batch {LOOP_BATCH}, max_len "
          f"{LOOP_MAX_LEN}, poll every {LOOP_POLL_EVERY} steps): "
          f"{len(comps)} greedy requests of {LOOP_PROMPT} tokens + "
          f"{LOOP_NEW} new in waves of {LOOP_BATCH} over {serve_s:.2f} s, "
          f"completed on versions {versions}; swaps (version, in flight) "
          f"{swapped[1:]}: swap_stall max {stalls.max():.3f} s, median "
          f"{np.median(stalls):.3f} s; time to first token mean "
          f"{ttft.mean():.1f} ms, median {np.median(ttft):.1f} ms; decode "
          f"{n_dec / (times.max() - times.min()):.1f} tokens/s ({n_dec} "
          f"tokens after each request's first, over the span of the token "
          f"stamps) [{card}]", flush=True)
    print(f"[9] launches: the server {served_counts}, the trainer "
          f"{trainer['launches']} (= {train_launches(cfg)} × {TRAIN_W} × "
          f"{LOOP_TICKS} ticks); the server's leaves equal the published "
          f"arrays bit for bit for versions {[v for v, _ in swapped]}; "
          f"teacher-forced on the versions they report, read from disk: "
          f"all {checked} served tokens reproduced; "
          f"{time.perf_counter() - t_phase:.1f} s into the phase", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return counts


def phase10(np, torch, dev, card):
    """Kill-and-resume at full width (depth RESUME_LAYERS): RESUME_TICKS
    straight PSP ticks against half of them, a blocking checkpoint, every
    device tensor dropped, a restore into a fresh template and the other
    half; every leaf of the final state and the noise generator's state
    must be equal bit for bit.  Returns the kernels' launch counts."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import _flatten as flat
    from repro_torch.configs import get_config
    from repro_torch.launch.train import psp_archive, restore_psp
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    half = RESUME_TICKS // 2
    batches = train_batches(torch, dev, cfg.vocab_size, RESUME_TICKS)
    ck = ROOT / "build" / "phase10"
    shutil.rmtree(ck, ignore_errors=True)
    reset_launch_counts(torch)
    st, step, noise = psp_run(torch, dev, cfg, RESUME_TICKS)
    n_params = sum(p.numel() for p in tree_leaves(st.server_params))
    for t in range(RESUME_TICKS):
        st, _ = step(st, batches[t])
    want = flat(psp_archive(st, noise, cfg))
    del st, step, noise

    st, step, noise = psp_run(torch, dev, cfg, RESUME_TICKS)
    for t in range(half):
        st, _ = step(st, batches[t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CheckpointManager(str(ck), keep=1) as mgr:
        mgr.save(half, psp_archive(st, noise, cfg), {"data_step": half},
                 block=True)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(ck / f"step_{half:08d}.npz")
    del st, step, noise
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    st, step, noise = psp_run(torch, dev, cfg, RESUME_TICKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, at = restore_psp(str(ck), st, noise, cfg, reseed=1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for t in range(at, RESUME_TICKS):
        st, _ = step(st, batches[t])
    got = flat(psp_archive(st, noise, cfg))
    counts = launch_counts()
    del st, step, noise
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ck, ignore_errors=True)
    if counts != train_total(cfg, 2 * RESUME_TICKS):
        raise AssertionError(f"launches {counts}, want "
                             f"{train_total(cfg, 2 * RESUME_TICKS)}")
    if set(got) != set(want):
        raise AssertionError(f"leaves {sorted(set(got) ^ set(want))} differ")
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    if bad:
        raise AssertionError("the resumed run differs from the straight one "
                             "in " + ", ".join(
                                 f"{k} (max |Δ| {np.abs(got[k].astype(np.float64) - want[k]).max():.3g})"
                                 for k in bad[:12]))
    print(f"[10] kill-and-resume of {cfg.name} at full width, {cfg.n_layers} "
          f"layers ({n_params:,} params, W={TRAIN_W}): {RESUME_TICKS} "
          f"straight ticks == {half} + checkpoint + restore + "
          f"{RESUME_TICKS - half}, every one of {len(want)} leaves bit for "
          f"bit (params, AdamW moments, views, control plane, noise "
          f"state); launches {counts}; checkpoint {nbytes:,} bytes, save "
          f"(host copy + blocking write) {save_s:.2f} s, restore (template, "
          f"read, to the card) {restore_s:.2f} s; {left:,} bytes of device "
          f"memory left allocated between save and restore; "
          f"{time.perf_counter() - t_phase:.1f} s into the phase [{card}]",
          flush=True)
    return counts


def counted_sweeps(torch, modules, counts):
    """Wrap ``run_sweep`` in each of ``modules`` so that every call adds
    the ticks it will launch through the tick kernel to
    ``counts["expect"]`` (a torch-backend call whose implementation is
    the kernel: ``ticks_to_run`` of each of its ``_merge_key`` groups),
    then runs unchanged.  Returns a function that restores them."""
    from repro_torch.core import vector_sim as vs
    from repro_torch.core.vector_sim_torch import tick_impl, ticks_to_run
    from repro_torch.kernels import ops
    real = vs.run_sweep

    def run_sweep(configs, **kw):
        dev = kw.get("device")
        if kw.get("backend", "torch") == "torch" and ops.use_kernel(
                tick_impl(), torch.device(dev if dev is not None
                                          else "cuda")):
            groups = {}
            for c in configs:
                groups.setdefault(vs._merge_key(c), []).append(c)
            counts["expect"] += sum(ticks_to_run(vs.VectorSimulator(g))
                                    for g in groups.values())
        return real(configs, **kw)

    saved = [(m, m.run_sweep) for m in modules]
    for m, _ in saved:
        m.run_sweep = run_sweep
    return lambda: [setattr(m, "run_sweep", f) for m, f in saved]


def paper_orderings(res):
    """The paper's Fig 1 / Fig 2 orderings on this run's figures, each
    (claim, holds): what ``tests/test_simulator.py`` asserts of the event
    engine at P 100, here at the figures' own scale."""
    prog, msgs, err = (res["fig1_progress"], res["fig1_messages"],
                       res["fig1_error"])
    mean = {k: v["mean"] for k, v in prog.items()}
    spread = {k: v["max"] - v["min"] for k, v in prog.items()}
    upd = {k: v["total"] for k, v in msgs.items()}
    r30 = {k: v[-1]["progress_ratio"]
           for k, v in res["fig2_stragglers"].items()}
    return [
        ("progress bsp < ssp < asp",
         mean["bsp"] < mean["ssp"] < mean["asp"]),
        ("progress pbsp > bsp", mean["pbsp"] > mean["bsp"]),
        ("progress pssp > ssp", mean["pssp"] > mean["ssp"]),
        ("spread bsp <= 1", spread["bsp"] <= 1),
        ("spread ssp <= 5", spread["ssp"] <= 5),
        ("spread asp > pssp >= pbsp",
         spread["asp"] > spread["pssp"] >= spread["pbsp"]),
        ("updates asp > pbsp > bsp", upd["asp"] > upd["pbsp"] > upd["bsp"]),
        ("every final error < 0.1",
         all(v["final"] < 0.1 for v in err.values())),
        ("at 30 % stragglers pbsp's progress ratio > bsp's",
         r30["pbsp"] > r30["bsp"]),
        ("at 30 % stragglers pbsp's progress ratio > 2 x bsp's",
         r30["pbsp"] > 2 * r30["bsp"]),
    ], mean, spread, upd, r30


def busy_line(torch, what, fn, wall_s, pt, n0, card):
    """Run ``fn`` once under ``torch.profiler`` and print its device time
    per tick and busy share against an unprofiled run's wall
    ``wall_s`` (the tick launches of the traced run counted from
    ``n0``)."""
    busy = profile_device(torch, fn)
    ticks = pt.launch_count() - n0
    if not busy or not ticks:
        print(f"[13] {what}: the profiler saw no device time; the busy "
              "share is not measured", flush=True)
        return
    busy_ms = sum(busy.values())
    tick_ms = sum(ms for key, ms in busy.items()
                  if any(n in key for n in TICK_KERNELS))
    print(f"[13] {what}: {ticks} ticks, device busy {busy_ms:.3f} ms = "
          f"{busy_ms / ticks:.4f} ms/tick (tick kernels "
          f"{tick_ms / ticks:.4f}), wall {1e3 * wall_s / ticks:.4f} "
          f"ms/tick unprofiled, busy share {busy_ms / (1e3 * wall_s):.4f} "
          f"[{card}]", flush=True)
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:5]:
        print(f"[13]   {ms / ticks:.4f} ms/tick  {key[:90]}", flush=True)


def phase13(np, torch, dev, card):
    """The rest of the paper on the port: the figures at full scale on
    the tick kernel (launches equal to the ticks run), the paper's
    orderings at that scale, Figs 1-2 at the reduced scale on the card
    against the numpy backend, the sweep benchmark with its 100,000-node
    pair, and that pair's integer traces under the kernel against the
    plain version.  Returns (kernel launches, the 100k tick's timing)."""
    from repro_torch.bench import fig45_bounds, figures, run as bench_run
    from repro_torch.bench import sweep_bench
    from repro_torch.kernels import psp_tick as pt
    os.environ.pop("PSP_TICK_IMPL", None)
    counts = {"expect": 0}
    restore = counted_sweeps(torch, (figures, fig45_bounds, sweep_bench),
                             counts)
    bench_configs = sweep_bench._configs
    sweep_bench._configs = lambda full: [
        dataclasses.replace(c, duration=SWEEP_BENCH_DURATION)
        for c in bench_configs(full)]
    try:
        # (a) the figures at the paper's scale, through the harness's
        # own entries, on the card
        figures._fig1_sweep.cache_clear()
        torch.cuda.synchronize()
        pt.reset_launch_count()
        res, walls, t_all = {}, {}, time.perf_counter()
        for name, fn, derive in bench_run.BENCHES:
            if name in ("sweep_engine", "elastic_churn",
                        "fig6_adaptive_churn"):
                continue        # the churn entries run in phase 19
            t0 = time.perf_counter()
            res[name] = fn(full=True, backend="torch", device=dev)
            walls[name] = time.perf_counter() - t0
            print(f"[13] {name} (full): {walls[name]:.3f} s; "
                  f"{derive(res[name])}", flush=True)
        wall = time.perf_counter() - t_all
        got = pt.launch_count()
        if got != counts["expect"] or got == 0:
            raise AssertionError(f"figures: kernel launches {got} != "
                                 f"ticks {counts['expect']}")
        for name, series in res["fig1_error"].items():
            if not (np.isfinite(series["errors"]).all()
                    and len(series["errors"]) == len(series["times"]) > 1
                    and np.allclose(np.diff(series["times"]), 0.5)):
                raise AssertionError(f"fig1_error {name}: misshapen or "
                                     "non-finite")
        for beta, row in res["fig4_mean_bound"].items():
            if not (np.isfinite(row["bound"]).all()
                    and math.isfinite(row["empirical_mean_lag"])):
                raise AssertionError(f"fig4 {beta}: non-finite")
        print(f"[13] Figs 1-5 at full scale: {got} ticks through the kernel "
              f"in {wall:.3f} s = {1e3 * wall / got:.4f} ms/tick [{card}]",
              flush=True)
        n0 = pt.launch_count()
        busy_line(torch, "fig1_sample_sweep (full), traced rerun",
                  lambda: figures.fig1_sample_sweep(full=True, device=dev),
                  walls["fig1_sample_sweep"], pt, n0, card)
        claims, mean, spread, upd, r30 = paper_orderings(res)
        print(f"[13] Fig 1 at P {figures._scale(True).n_nodes}: mean "
              f"progress {mean}, spread "
              f"{spread}, updates {upd}; at 30 % stragglers progress "
              f"ratio {r30}", flush=True)
        for claim, holds in claims:
            print(f"[13]   {'holds' if holds else 'DOES NOT HOLD'}: "
                  f"{claim}", flush=True)

        # (b) Figs 1-2 at the reduced scale: the card against numpy
        c = figures._scale(False)
        cfgs = ([figures._cfg(n, c) for n in figures.FIVE]
                + [figures._cfg(n, c, straggler_frac=f)
                   for n in figures.FIVE for f in FRACS]
                + [figures._cfg(n, c, straggler_frac=0.05,
                                straggler_slowdown=sl)
                   for n in figures.FIVE for sl in (1.0, 2.0, 4.0, 8.0, 16.0)])
        t0 = time.perf_counter()
        on_card = figures.run_sweep(cfgs, device=dev)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_host = figures.run_sweep(cfgs, backend="numpy")
        t_host = time.perf_counter() - t0
        worst_p = worst_e = 0.0
        for cfg, a, b in zip(cfgs, on_card, on_host):
            what = (f"{cfg.barrier.name} frac {cfg.straggler_frac} slow "
                    f"{cfg.straggler_slowdown}")
            if abs(a.mean_progress - b.mean_progress) \
                    > 0.2 * b.mean_progress + 1.0:
                raise AssertionError(f"card vs numpy, {what}: mean progress "
                                     f"{a.mean_progress} vs {b.mean_progress}")
            if not 0.5 * b.final_error <= a.final_error <= 2 * b.final_error:
                raise AssertionError(f"card vs numpy, {what}: final error "
                                     f"{a.final_error} vs {b.final_error}")
            worst_p = max(worst_p, abs(a.mean_progress / b.mean_progress - 1))
            worst_e = max(worst_e, abs(math.log(a.final_error
                                                / b.final_error)))
        print(f"[13] Figs 1-2 reduced ({len(cfgs)} rows, P {c.n_nodes}, d "
              f"{c.dim}, {c.duration:.0f} s): card {t_card:.3f} s, numpy "
              f"{t_host:.3f} s; mean progress within 0.2 p + 1 (largest "
              f"relative gap {worst_p:.4f}), final error within 2x (largest "
              f"ratio {math.exp(worst_e):.4f}) [{card}]", flush=True)

        # (c) the sweep benchmark at its default scale, with the 100k pair
        t0 = time.perf_counter()
        bench = sweep_bench.sweep_speedup(device=dev)
        print(f"[13] sweep bench ({bench['n_configs']} configs, P "
              f"{bench['n_nodes']}, {bench['duration_s']:g} s) in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{sweep_bench.summary_line(bench)} [{card}]", flush=True)
        for name, row in bench["engines"].items():
            print(f"[13]   {name}: " + json.dumps(row), flush=True)
        os.environ["PSP_TICK_IMPL"] = "cuda"
        n0 = pt.launch_count()
        busy_line(torch, "bench matrix on the kernel, traced rerun",
                  lambda: sweep_bench.run_sweep(sweep_bench._configs(False),
                                                device=dev),
                  bench["engines"]["cuda"]["seconds"], pt, n0, card)
        os.environ.pop("PSP_TICK_IMPL", None)

        # (d) the 100k pair under the kernel and the plain version
        big = sweep_bench._100k_configs()
        runs = {}
        for impl in ("cuda", "ref"):
            os.environ["PSP_TICK_IMPL"] = impl
            runs[impl] = sweep_bench.run_sweep(big, device=dev)
        os.environ.pop("PSP_TICK_IMPL", None)
        for a, b in zip(runs["cuda"], runs["ref"]):
            if not (np.array_equal(a.steps, b.steps)
                    and a.total_updates == b.total_updates
                    and a.control_messages == b.control_messages
                    and np.array_equal(a.server_updates, b.server_updates)):
                raise AssertionError("100k: cuda and ref sweeps differ in "
                                     "the integer traces")
            np.testing.assert_allclose(a.errors, b.errors, rtol=1e-4,
                                       atol=1e-6)
        print("[13] 100k pair: cuda == ref (steps, updates, control "
              "messages equal; errors within rtol 1e-4)", flush=True)
        got = pt.launch_count()
        if got != counts["expect"]:
            raise AssertionError(f"phase 13: kernel launches {got} != "
                                 f"ticks {counts['expect']}")
    finally:
        restore()
        sweep_bench._configs = bench_configs
        os.environ.pop("PSP_TICK_IMPL", None)

    # (e) one kernel tick at the 100k shape, timed beside its bound
    B, P, d, m = 2, 100_000, 4, 2
    err, (st, shapes, prm, ln, jn, kw) = check_tick_case(
        np, torch, pt, dev, (False, False, 1, False), B, P, d, m, n_ticks=3,
        fully_alive=True)
    tt = time_tick(np, torch, pt, dev, st, shapes, prm, ln, jn, kw)
    print_tick_time(f"[13] tick at (B, P, d, m, beta) = {(B, P, d, m, 1)}",
                    tt, B * P, card)
    return got, tt


def phase14(np, torch, dev, card):
    """The sliding-window and local/global decoders on the card: serve
    each of LOCAL_SERVE (:func:`serve_phase`, with the ring check), then
    train h2o-danube-1.8b under PSP (:func:`train_phase`).  Returns the
    model kernels' launch counts of each run."""
    paths = []
    for argv in LOCAL_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        paths.append(serve_phase(np, torch, dev, card, argv, 14))
    gc.collect()
    torch.cuda.empty_cache()
    got, *_ = train_phase(np, torch, dev, card, LOCAL_TRAIN_ARCH, 14,
                          layers=LOCAL_TRAIN_LAYERS, ticks=LOCAL_TRAIN_TICKS,
                          seq=LOCAL_TRAIN_S, warmup=LOCAL_TRAIN_WARMUP,
                          fall=LOCAL_TRAIN_FALL)
    paths.append(got)
    return paths


def phase15(np, torch, dev, card):
    """recurrentgemma-2b served on the card at full width, its depth cut
    to RGEMMA_SERVE_LAYERS (RGEMMA_SERVE, :func:`serve_phase` with the
    ring check on its local layers).  Returns the model kernels' launch
    counts of each run."""
    paths = []
    for argv in RGEMMA_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        paths.append(serve_phase(np, torch, dev, card, argv, 15))
    return paths


def phase16(np, torch, dev, card):
    """recurrentgemma-2b trained under PSP on the card at full width, its
    depth cut to RGEMMA_TRAIN_LAYERS (:func:`train_phase`: tick 0 against
    the plain path over the whole tree and leaf by leaf, the control
    plane, exact launches, the loss falling).  Its ticks peak within ~5
    GB of the card's memory, so the caching allocator runs with
    expandable segments for the phase: blocks freed by one stage's
    shapes would otherwise be split too finely for the next stage's
    largest tensors.  Returns the model kernels' launch counts of the
    run."""
    allocator = torch.cuda.memory._set_allocator_settings
    gc.collect()
    torch.cuda.empty_cache()
    allocator("expandable_segments:True")
    try:
        return train_phase(
            np, torch, dev, card, RGEMMA_TRAIN_ARCH, 16,
            layers=RGEMMA_TRAIN_LAYERS, ticks=RGEMMA_TRAIN_TICKS,
            seq=RGEMMA_TRAIN_S, warmup=RGEMMA_TRAIN_WARMUP,
            fall=RGEMMA_TRAIN_FALL)[0]
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        allocator("expandable_segments:False")


def phase17(np, torch, dev, card):
    """The MoE decoders on the card: serve each of MOE_SERVE
    (:func:`serve_phase`: exact launches, the MoE layer's split, the
    teacher-forced checks of :func:`teacher_checks`, a traced wave),
    and train qwen3-moe-30b-a3b under PSP (:func:`train_phase`, with
    expandable segments as phase 16).  Returns the model kernels' launch
    counts of each run."""
    paths = []
    for argv in MOE_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        paths.append(serve_phase(np, torch, dev, card, argv, 17))
    allocator = torch.cuda.memory._set_allocator_settings
    gc.collect()
    torch.cuda.empty_cache()
    allocator("expandable_segments:True")
    try:
        paths.append(train_phase(
            np, torch, dev, card, MOE_TRAIN_ARCH, 17,
            layers=MOE_TRAIN_LAYERS, ticks=MOE_TRAIN_TICKS,
            warmup=MOE_TRAIN_WARMUP, fall=MOE_TRAIN_FALL,
            workers=MOE_TRAIN_W, beta=MOE_TRAIN_BETA)[0])
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        allocator("expandable_segments:False")
    return paths


def child_run(tag, module, argv, expect, counts_path, t_phase):
    """One reduced launcher or example (see :func:`lanes_side_by_side`)
    in a child interpreter on the card; returns (its printed line, its
    launch counts or None, a failure message or None)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    if module.startswith("examples."):
        counts_path.unlink(missing_ok=True)
        name = f"repro_torch.{module}"
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), EXAMPLE_CHILD,
               name, str(counts_path),
               json.dumps(EXAMPLE_CUTS.get(module, {})), *argv]
    else:
        counts_path = None
        name = f"repro_torch.launch.{module}"
        cmd = [sys.executable, "-m", name, *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if (proc.returncode != 0 or not all(e in out for e in expect)
            or (counts_path is not None and not counts_path.is_file())):
        return None, None, (f"{name} {argv} ({proc.returncode}): "
                            f"{out[-1500:]}{err[-2000:]}")
    got = (json.loads(counts_path.read_text())
           if counts_path is not None else None)
    line = (f"[{tag}] python -m {name} {' '.join(argv)}: "
            f"{out.strip().splitlines()[-1]}"
            + (f"; launches {got}" if got is not None else "")
            + f"; {time.perf_counter() - t0:.1f} s, ended "
            f"{time.perf_counter() - t_phase:.1f} s into the phase")
    return line, got, None


def lanes_side_by_side(lanes, t_phase):
    """Reduced launchers and examples on the card, each in a child
    interpreter: ``lanes`` is a list of lanes, each a list of runs
    ((phase tag, module of repro_torch.launch or ``examples.<name>``,
    argv, what its output must hold), ...) started one after another;
    the lanes run side by side, one thread each.  An example runs
    through ``chip_smoke.py`` EXAMPLE_CHILD, which writes its kernels'
    launch counts at its exit.  Each child runs torch at one CPU thread:
    their work is on the card, and their default pools of every core
    each would oversubscribe the host.  Returns a function that waits
    for every lane, prints each run's line, fails unless each exited 0
    with its output holding what it must (a lane stops at its first
    failure), and returns the examples' launch counts summed by
    kernel name."""
    import threading
    where = ROOT / "build" / "example_counts"
    where.mkdir(parents=True, exist_ok=True)
    results = [[] for _ in lanes]

    def lane(i):
        for j, run in enumerate(lanes[i]):
            res = child_run(*run, where / f"{i}_{j}.json", t_phase)
            results[i].append(res)
            if res[2] is not None:
                return

    threads = [threading.Thread(target=lane, args=(i,))
               for i in range(len(lanes))]
    for t in threads:
        t.start()

    def wait():
        for t in threads:
            t.join()
        shutil.rmtree(where, ignore_errors=True)
        failed, total = [], {}
        for line, got, fail in itertools.chain(*results):
            if fail is not None:
                failed.append(fail)
                continue
            print(line, flush=True)
            for name, n in (got or {}).items():
                total[name] = total.get(name, 0) + n
        if failed:
            raise AssertionError("; ".join(failed))
        return total
    return wait


def example_child(torch, module, out, cuts, argv) -> int:
    """An example run in a child interpreter (``python3 chip_smoke.py
    --example MODULE COUNTS_JSON CUTS_JSON ARGS``): ``MODULE``'s
    constants named in ``CUTS_JSON`` set (a tick count cut), then its
    ``main(ARGS)``; then the launch counts of every kernel of the port
    since the interpreter started (the model kernels and the tick) are
    written to ``COUNTS_JSON``.  Returns the example's exit code."""
    import importlib
    from repro_torch.kernels import psp_tick as pt
    mod = importlib.import_module(module)
    for name, value in json.loads(cuts).items():
        setattr(mod, name, value)
    sys.argv = [module, *argv]
    code = mod.main(argv) or 0
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps({**launch_counts(),
                                     "psp_tick": pt.launch_count()}))
    return code


def frontend_rows(np, cfg, n, seed=FRONTEND_SEED):
    """Each of ``n`` requests' own frontend rows (F, d_model), seeded
    N(0, 1) from numpy, float32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.frontend_tokens, cfg.d_model),
                                dtype=np.float32) for _ in range(n)]


def frontend_loss(np, torch, dev, card):
    """internvl2-2b's ``loss_fn`` with frontend rows at full width, its
    depth cut to FRONTEND_LOSS_LAYERS: one forward and backward of B
    sequences of F rows + T tokens (FRONTEND_LOSS_BT; seeded on the
    card) under the kernels against ``impl="ref"``, in bf16 compute and
    in float32, held as :func:`train_phase` holds tick 0 leaf by leaf:
    the loss within 2e-2 or the plain path's own bf16 − float32 spread,
    the gradients over the tree and each leaf within 2e-2 or that
    spread; in float32 compute the loss within 1e-5 relative, the
    gradients within 1e-3.  The kernels' launches are those of one
    worker's training step (:func:`train_launches`)."""
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import init_model
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = train_config(FRONTEND_LOSS_ARCH, FRONTEND_LOSS_LAYERS)
    params = init_model(cfg, seed=0, device=dev).tree()
    n_params = sum(p.numel() for p in tree_leaves(params))
    B, T = FRONTEND_LOSS_BT
    gen = torch.Generator(device=dev)
    gen.manual_seed(FRONTEND_SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "embeds": torch.randn(B, cfg.frontend_tokens, cfg.d_model,
                                   generator=gen, device=dev)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    grads = lambda c, impl: make_grad_fn(c, None, impl)(params, batch)
    reset_launch_counts(torch)
    lk, gk = grads(cfg, "cuda")
    got = launch_counts()
    want = train_launches(cfg)
    if got != want:
        raise AssertionError(f"loss check launches {got}, want {want}")
    lr, gr = grads(cfg, "ref")
    l32, g32 = grads(cfg32, "ref")
    lk32, gk32 = grads(cfg32, "cuda")
    lk, lr, l32, lk32 = (float(x) for x in (lk, lr, l32, lk32))
    e_loss, s_loss = abs(lk - lr), abs(lr - l32)
    e_tree, s_tree = tree_rel(torch, gk, gr), tree_rel(torch, gr, g32)
    e_leaf, s_leaf = leaf_rel(torch, gk, gr), leaf_rel(torch, gr, g32)
    e32_loss, e32_tree = abs(lk32 - l32) / abs(l32), tree_rel(torch, gk32,
                                                             g32)
    e32_leaf = max(leaf_rel(torch, gk32, g32))
    bounds = [max(2e-2, x) for x in (s_loss, s_tree, max(s_leaf))]
    print(f"[18] {cfg.name} loss_fn with {cfg.frontend_tokens} frontend rows"
          f" at full width ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{n_params:,} params f32), B={B}, {cfg.frontend_tokens} + {T} "
          f"positions, bf16: loss kernels {lk:.6f}, plain {lr:.6f}, plain "
          f"f32 {l32:.6f}; |loss kernels − plain| {e_loss:.4g} (bound "
          f"{bounds[0]:.4g}: 2e-2 or plain bf16 − f32 {s_loss:.4g}); "
          f"‖Δg‖/‖g‖ {e_tree:.4g} (bound {bounds[1]:.4g}; the plain path's "
          f"{s_tree:.4g}); leaf by leaf ({len(e_leaf)} leaves) up to "
          f"{max(e_leaf):.4g} (bound {bounds[2]:.4g}; the plain path's up "
          f"to {max(s_leaf):.4g}); float32 compute: loss {e32_loss:.3g} "
          f"relative (bound 1e-5), ‖Δg‖/‖g‖ {e32_tree:.3g}, leaf by leaf "
          f"up to {e32_leaf:.3g} (bound 1e-3); launches "
          + ", ".join(f"{k} {n}" for k, n in got.items() if n)
          + f"; {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if not (e_loss <= bounds[0] and e_tree <= bounds[1]
            and max(e_leaf) <= bounds[2] and e32_loss <= 1e-5
            and e32_tree <= 1e-3 and e32_leaf <= 1e-3):
        raise AssertionError(f"{cfg.name} loss with frontend rows: kernels "
                             "and plain path differ beyond the bounds")
    del params, gk, gr, g32, gk32


def phase18(np, torch, dev, card):
    """The frontend models on the card: serve each of FRONTEND_SERVE at
    full width and depth, every request with its own seeded frontend rows
    (:func:`serve_phase`: exact launches, each later wave served alone,
    the teacher-forced checks on the same rows, a traced wave); hold
    internvl2-2b's ``loss_fn`` with frontend rows to the plain path
    (:func:`frontend_loss`); train musicgen-large under PSP
    (:func:`train_phase`, tick 0 leaf by leaf); then the reduced
    launchers of phases 12, 16, 17 and 18 (REDUCED_LAUNCHERS) side by
    side.  Returns the model kernels' launch counts of each run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    paths = []
    for argv in FRONTEND_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        a = serve.parse_args(argv)
        rows = frontend_rows(np, get_config(a.arch), a.requests)
        paths.append(serve_phase(np, torch, dev, card, argv, 18, rows))
    gc.collect()
    torch.cuda.empty_cache()
    frontend_loss(np, torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    got, *_ = train_phase(
        np, torch, dev, card, FRONTEND_TRAIN_ARCH, 18,
        layers=FRONTEND_TRAIN_LAYERS, ticks=FRONTEND_TRAIN_TICKS,
        warmup=FRONTEND_TRAIN_WARMUP, fall=FRONTEND_TRAIN_FALL,
        leafwise=True)
    paths.append(got)
    return paths


def churn_checks(np, res, ticks):
    """The churn result's schema (the nine policies of each scenario, the
    scoreboard of each), every error finite, leaves and joins in every
    churn run, each run's final error below its first."""
    from repro_torch.bench import churn_bench as cb
    keys = {"virtual_time", "error", "alive", "final_error",
            "final_virtual_time", "mean_alive", "total_pushes", "leaves",
            "joins"}
    points = len(range(0, ticks, 10)) + ((ticks - 1) % 10 != 0)
    if set(res) != set(cb.NINE) | {"stragglers", "adaptive_vs_static"}:
        raise AssertionError(f"churn result keys {sorted(res)}")
    scenarios = {"churn": {k: res[k] for k in cb.NINE},
                 "stragglers": res["stragglers"]}
    for scenario, runs in scenarios.items():
        if set(runs) != set(cb.NINE) or set(
                res["adaptive_vs_static"][scenario]) != set(cb.PARENT):
            raise AssertionError(f"{scenario}: policies {sorted(runs)}")
        for name, r in runs.items():
            trace = [len(r[k]) for k in ("virtual_time", "error", "alive")]
            if set(r) != keys or trace != [points] * 3:
                raise AssertionError(f"{scenario}/{name}: keys {sorted(r)}, "
                                     f"trace lengths {trace}")
            if not np.isfinite(r["error"]).all():
                raise AssertionError(f"{scenario}/{name}: non-finite error")
            if not r["final_error"] < r["error"][0]:
                raise AssertionError(f"{scenario}/{name}: final error "
                                     f"{r['final_error']} >= first "
                                     f"{r['error'][0]}")
            if scenario == "churn" and not (r["leaves"] > 0
                                            and r["joins"] > 0):
                raise AssertionError(f"churn/{name}: {r['leaves']} leaves, "
                                     f"{r['joins']} joins")


def churn_replay(np, torch, dev, scenario, name, ticks=300, workers=8):
    """One churn-benchmark run held between the card and the CPU: the
    draws of a seeded ``GeneratorNoise`` and the minibatches recorded once
    on the host, replayed through ``ReplayNoise`` into ``elastic_drive``
    on both devices with ``_run_one``'s config; the control plane after
    every tick (steps, alive, cursors, pushes, now) equal bit for bit,
    the error trace at the benchmark's reads (every 10th tick and the
    last) within rtol 1e-5, atol 1e-6 (the script's float32 rule; the
    first read is 1.0).  Returns the largest absolute error gap."""
    from repro_torch.bench import churn_bench as cb
    from repro_torch.core.spmd_psp import (ChurnConfig, GeneratorNoise,
                                           PSPConfig, ReplayNoise,
                                           elastic_drive, linear_psp_task)
    churn = (ChurnConfig(leave_rate=1.5, join_rate=1.5, horizon=60.0,
                         seed=7) if scenario == "churn" else None)
    kw = ({"straggler_frac": 0.25} if churn else
          {"straggler_frac": 0.35, "max_advance": 8})
    cfg = PSPConfig(barrier=name, n_workers=workers, sample_size=2,
                    staleness=3, churn=churn, **kw)
    src = GeneratorNoise(1, "cpu")
    init = src.init_record(cfg)
    recs = [src.tick_record(cfg) for _ in range(ticks)]
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn((workers, 16, cb.D), generator=gen)
          for _ in range(ticks)]
    w_true = linear_psp_task(cb.D)[0]
    fields = ("step", "alive", "leave_cursor", "join_cursor",
              "total_pushes", "now")
    reads = [t for t in range(ticks) if t % 10 == 0 or t == ticks - 1]
    planes, errors = {}, {}
    for d in ("cpu", dev):
        move = lambda r: {k: v.to(d) for k, v in r.items()}
        wt = w_true.to(d)
        _, it = elastic_drive(cfg, cb.D, ticks, device=d,
                              noise=ReplayNoise(move(init), map(move, recs)),
                              xs=[x.to(d) for x in xs], w_true=wt)
        plane, err = [], []
        for t, (st, _) in enumerate(it):
            plane.append([getattr(st, f).clone() for f in fields])
            if t in reads:
                err.append(torch.linalg.norm(st.server_params["w"] - wt)
                           / torch.linalg.norm(wt))
        planes[str(d)] = [torch.stack([p[i] for p in plane]).cpu().numpy()
                          for i in range(len(fields))]
        errors[str(d)] = torch.stack(err).cpu().numpy()
    for f, x, y in zip(fields, planes["cpu"], planes[str(dev)]):
        if not np.array_equal(x, y):
            t = int(np.argwhere((x != y).reshape(ticks, -1).any(1))[0, 0])
            raise AssertionError(f"{scenario}/{name} tick {t}: {f} card "
                                 f"{y[t]} != CPU {x[t]}")
    host, card = errors["cpu"], errors[str(dev)]
    np.testing.assert_allclose(card, host, rtol=1e-5, atol=1e-6)
    return float(np.max(np.abs(card - host)))


def phase19_churn(np, torch, dev, card):
    """(a) The churn benchmark (``bench.churn_bench.elastic_churn``) at
    its default scale on the card, Fig 6's reshape from its cached
    result, :func:`churn_checks`, :func:`churn_replay` on CHURN_REPLAY,
    and the reference's scoreboard printed."""
    from repro_torch.bench import churn_bench as cb, figures
    t0 = time.perf_counter()
    cb.elastic_churn.cache_clear()
    res = cb.elastic_churn(full=False, backend="torch", device=dev)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    fig = figures.fig6_adaptive_churn(full=False, backend="torch",
                                      device=dev)
    fig_s = time.perf_counter() - t1
    if cb.elastic_churn.cache_info().hits != 1:
        raise AssertionError("fig6_adaptive_churn did not read the cached "
                             "churn result")
    churn_checks(np, res, 300)
    series = sorted(k for k in fig if k != "scoreboard")
    want = sorted(f"{s}/{m}" for s in ("churn", "stragglers")
                  for pair in cb.PARENT.items() for m in pair)
    if series != want or fig["scoreboard"] is not res["adaptive_vs_static"]:
        raise AssertionError(f"fig6 series {series}")
    print(f"[19] churn benchmark on the card: 18 runs of 300 ticks, W 8, "
          f"d {cb.D} (9 policies × churn / stragglers) in {wall:.3f} s = "
          f"{1e3 * wall / (18 * 300):.4f} ms a tick; Fig 6 reshape from "
          f"the cache in {fig_s:.4f} s ({len(series)} series); schema, "
          "finite errors, leaves and joins in every churn run, every "
          f"final error below its first [{card}]", flush=True)
    gaps = []
    for scenario, name in CHURN_REPLAY:
        gaps.append(churn_replay(np, torch, dev, scenario, name))
    print(f"[19] card == CPU under replayed draws and minibatches on "
          f"{list(CHURN_REPLAY)}: the control plane after each of 300 "
          "ticks bit for bit; the error traces within rtol 1e-5, atol "
          f"1e-6 (largest gap {max(gaps):.3g})", flush=True)
    print("[19] the scoreboard (a finding, not a check):", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cb.print_summary(res)
    for line in buf.getvalue().splitlines():
        print(f"[19]   {line}", flush=True)


def phase19_serve(np, torch, dev, card):
    """(b) The serve benchmark's body (``bench.serve_bench.open_loop``)
    at qwen2-0.5b's full width, its depth cut to SERVE_LAYERS, on the
    reference's default load (SERVE_BENCH) with two full-width snapshots
    published mid-stream: at least 2 swaps spanning at least 2 versions,
    0 drops, launches exact.  Returns the launch counts."""
    from repro_torch.bench import serve_bench as sb
    from repro_torch.serving import ServeConfig
    b = SERVE_BENCH
    cfg = train_config(TRAIN_ARCH, SERVE_LAYERS)
    scfg = ServeConfig(batch=b["batch"], max_len=256,
                       max_new_tokens=b["max_new"], seed=0)
    t0 = time.perf_counter()
    reset_launch_counts(torch)
    res, engines = sb.open_loop(cfg, scfg, requests=b["requests"],
                                rate_rps=b["rate_rps"],
                                prompt_len=b["prompt_len"],
                                poll_every=b["poll_every"], seed=0,
                                device=dev)
    torch.cuda.synchronize()
    got = launch_counts()
    prefills = sum(e.prefill_calls for e in engines)
    forwards = prefills + sum(e.decode_steps for e in engines)
    want = {**{k: 0 for k in got},
            "flash_attention": cfg.n_layers * prefills,
            "rmsnorm": (2 * cfg.n_layers + 1) * forwards}
    if got != want:
        raise AssertionError(f"serve bench launches {got}, want {want}")
    if not (res["swaps"] >= 2 and len(res["versions_served"]) >= 2
            and res["dropped"] == 0):
        raise AssertionError(f"serve bench: {res['swaps']} swaps, versions "
                             f"{res['versions_served']}, {res['dropped']} "
                             "dropped")
    lat = res["latency_s"]
    print(f"[19] serve bench at full width: {cfg.name}, {cfg.n_layers} "
          f"layers, {cfg.dtype}, {res['requests']} requests at "
          f"{res['rate_rps']}/s, batch {res['batch']}, prompt "
          f"{res['prompt_len']}, {res['max_new_tokens']} new, poll every "
          f"{b['poll_every']} steps: {res['tokens_per_s']} tokens/s "
          f"({res['total_tokens']} in {res['wall_s']} s); per token p50 "
          f"{1e3 * lat['per_token']['p50']:.3f} / p99 "
          f"{1e3 * lat['per_token']['p99']:.3f} ms, per request "
          f"{1e3 * lat['per_request']['p50']:.3f} / "
          f"{1e3 * lat['per_request']['p99']:.3f} ms, first token "
          f"{1e3 * lat['first_token']['p50']:.3f} / "
          f"{1e3 * lat['first_token']['p99']:.3f} ms; swaps "
          f"{res['swaps']}, swap_stall_s {res['swap_stall_s']['events']}, "
          f"versions {res['versions_served']}, dropped {res['dropped']}, "
          f"snapshots skipped {res['snapshots_skipped']}; launches "
          f"flash {got['flash_attention']} = {cfg.n_layers} × {prefills}, "
          f"RMSNorm {got['rmsnorm']} = {2 * cfg.n_layers + 1} × "
          f"{forwards}; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return got


def phase19_chaos(np, torch, dev, card):
    """(c) ``bench.chaos_bench``'s two segments at ``chaos_suite
    (smoke=True)``'s shapes on the card, the cluster's tick floor raised
    to CHAOS_TICK_MIN_WALL, held to the reference's exit invariants; its
    faulted cluster run takes phase 11's place with phase 11's checks:
    exactly the victim respawned and rejoined, and the recorded events
    replayed through ``external_drive`` on the card give its final
    params bit for bit.  Returns the serving segment's launch counts."""
    from repro_torch.bench import chaos_bench as chb
    from repro_torch.core.spmd_psp import external_drive
    t0 = time.perf_counter()
    real, calls = chb.run_cluster, []

    def recorded(cfg, dim, ticks, workdir, **kw):
        res = real(cfg, dim, ticks, workdir, **kw)
        calls.append((cfg, dim, ticks, kw, dict(res)))
        return res

    chb.run_cluster = recorded
    reset_launch_counts(torch)
    try:        # chaos_suite(smoke=True), the cluster's tick floor raised
        res = {"smoke": True,
               "cluster": chb.cluster_chaos(
                   workers=3, ticks=24, tick_min_wall=CHAOS_TICK_MIN_WALL,
                   device=dev),
               "serving": chb.serving_chaos(requests=10, rate_rps=8.0,
                                            device=dev)}
    finally:
        chb.run_cluster = real
    torch.cuda.synchronize()
    got = launch_counts()
    if not chb.invariants_hold(res):
        raise AssertionError(f"chaos invariants violated: {res}")
    if not (got["flash_attention"] > 0 and got["rmsnorm"] > 0):
        raise AssertionError(f"chaos serving launched {got}")
    cfg, dim, ticks, kw, faulted = calls[-1]
    plan = kw["plan"]
    (kill,) = [e for e in plan.events if e.kind == "kill"]
    victim = kill.worker
    epochs = {int(w): e for w, e in faulted["epochs"].items()}
    kinds = [(kind, w) for _t, kind, w in faulted["events"]]
    if not (epochs == {w: int(w == victim) for w in range(cfg.n_workers)}
            and ("leave", victim) in kinds and ("join", victim) in kinds):
        raise AssertionError(f"chaos cluster: epochs {epochs}, events "
                             f"{faulted['events']} (victim {victim})")
    events = {}
    for t, kind, w in faulted["events"]:
        lv, jn = events.setdefault(t, ([], []))
        (lv if kind == "leave" else jn).append(w)
    _, it = external_drive(cfg, dim, ticks,
                           {t: (tuple(lv), tuple(jn))
                            for t, (lv, jn) in events.items()},
                           batch=kw["batch"], device=dev)
    for ref, _ in it:
        pass
    if not (np.array_equal(ref.server_params["w"].cpu().numpy(),
                           faulted["final_params"]["w"])
            and int(ref.total_pushes) == faulted["total_pushes"]
            and ref.alive.cpu().numpy().tolist() == faulted["alive"]):
        raise AssertionError("replaying the chaos cluster's events does not "
                             "reproduce its final params bit for bit")
    c, s = res["cluster"], res["serving"]
    print(f"[19] chaos suite (smoke) on the card: cluster {c['workers']} "
          f"workers × {c['ticks']} ticks (floor {CHAOS_TICK_MIN_WALL} s), "
          f"d {c['dim']}, plan {c['plan']} "
          f"(worker {victim} SIGKILLed at tick {kill.tick}): "
          f"events {c['faulted']['events']}, epochs "
          f"{c['faulted']['epochs']}, recovery latency "
          f"{c['recovery_latency_s']} s, goodput "
          f"{c['faulted']['goodput_pushes_per_s']} pushes/s against "
          f"{c['nofault']['goodput_pushes_per_s']} without faults (ratio "
          f"{c['goodput_ratio']}), live restarts {c['live_restarts']}; "
          "replayed through external_drive on the card: final params bit "
          f"for bit; serving {s['completed']}/{s['requests']} done, "
          f"dropped {s['dropped']}, swaps {s['swaps']}, worker restarts "
          f"{s['worker_restarts']} (readmitted {s['readmitted']}), publish "
          f"faults {s['publish_faults']}, {s['tokens_per_s']} tokens/s; "
          f"launches flash {got['flash_attention']}, RMSNorm "
          f"{got['rmsnorm']}; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return got


def phase19_lanes(dirs):
    """(d)'s lanes: phase 8's launcher runs in order; elastic_train to its
    checkpoint, then resumed; each other example; the reduced launchers
    behind the shorter ones (about even lanes)."""
    fill = lambda run: (*run[:2], [x.format(**dirs) for x in run[2]],
                        run[3])
    e, r = {k: fill(v) for k, v in EXAMPLES.items()}, REDUCED_LAUNCHERS
    return [[fill((8, *run)) for run in LAUNCHER_RUNS],
            [e["elastic_train"], e["elastic_resume"], r[0]],
            [e["serve_demo"], r[1], r[4]],
            [e["train_e2e"], r[2]],
            [e["barrier_sweep"]],
            [e["live_serve"], r[3]],
            [r[5], r[6], r[7]],
            [r[8], r[9]]]


def phase19(np, torch, dev, card):
    """The reference's remaining entry points on the card: (d) the five
    examples and the reduced launchers as child interpreters in lanes
    side by side, started first and run beside (a) the churn benchmark
    and Fig 6; then (b) the serve benchmark at full width and (c) the
    chaos suite (in phase 11's place), each alone.  Returns (the
    kernels' launch counts of each run, the tick's launches in the
    examples)."""
    t_phase = time.perf_counter()
    where = ROOT / "build" / "launchers"
    shutil.rmtree(where, ignore_errors=True)
    dirs = {"ck": str(where / "ck"), "snaps": str(where / "snaps"),
            "elastic": str(where / "elastic")}
    wait = lanes_side_by_side(phase19_lanes(dirs), t_phase)
    try:
        phase19_churn(np, torch, dev, card)
        print(f"[19] (a) ends {time.perf_counter() - t_phase:.1f} s into "
              "the phase, beside (d)", flush=True)
    finally:
        got = wait()
        shutil.rmtree(where, ignore_errors=True)
    ticks = got.pop("psp_tick", 0)
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd", "ssd_scan"):
        if not got.get(name):
            raise AssertionError(f"the examples launched no {name}: {got}")
    if not ticks:
        raise AssertionError("barrier_sweep's stage 1 launched no tick")
    print(f"[19] (d) ends {time.perf_counter() - t_phase:.1f} s into the "
          f"phase; the examples' launches (summed over their child "
          f"interpreters): {got}, psp_tick {ticks}", flush=True)
    paths = [got]
    for part in (phase19_serve, phase19_chaos):
        gc.collect()
        torch.cuda.empty_cache()
        paths.append(part(np, torch, dev, card))
        print(f"[19] {part.__name__} ends "
              f"{time.perf_counter() - t_phase:.1f} s into the phase",
              flush=True)
    return paths, ticks


def roof_inputs(torch, dev, cfg, shape, args, seed=20):
    """Real inputs on ``dev`` for :func:`dryrun_inputs`' records at
    ``shape``: seeded random parameters (the reference's init law),
    AdamW's zero state, uniform random tokens; a zero cache holding
    ``seq_len − 1`` tokens."""
    from repro_torch.models import init_cache, model_defs
    from repro_torch.models.params import init_params, torch_dtype
    from repro_torch.optim import adamw
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(model_defs(cfg), generator=gen, device=dev,
                         dtype=torch_dtype(cfg.param_dtype))
    batch = {k: (torch.randint(0, cfg.vocab_size, a.shape, generator=gen,
                               device=dev, dtype=a.dtype)
                 if k == "tokens" else
                 torch.randn(a.shape, generator=gen, device=dev).to(a.dtype))
             for k, a in args[-1].items()}
    if shape.kind == "train":
        return params, adamw(1e-4).init(params), batch
    if shape.kind == "prefill":
        return params, batch
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, dev)
    cache["length"] = shape.seq_len - 1
    return params, cache, batch


def phase20(np, torch, dev, card):
    """The roofline on the card (see the module docstring, 20).  Returns
    (the model kernels' launches, the tick's launches)."""
    from repro_torch.bench.roofline_bench import sweep_tick_row
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import psp_tick as pt
    from repro_torch.launch.dryrun import tensor_bytes, count_step
    from repro_torch.launch.steps import dryrun_inputs, meta_inputs
    from repro_torch.models.params import per_device_bytes
    from repro_torch.roofline import model_flops, roofline_report
    paths = []
    for arch, shape_name, batch, reps in ROOF_COMBOS:
        cfg = get_config(arch)
        full = INPUT_SHAPES[shape_name]
        shape = dataclasses.replace(full, global_batch=batch)
        args, step_ref, _ = dryrun_inputs(cfg, shape, None, impl="ref")
        cost, out, count_s = count_step(step_ref, meta_inputs(args, shape))
        rep = roofline_report({"flops": cost.flops,
                               "bytes accessed": cost.bytes_min},
                              model_flops_total=model_flops(cfg, shape))
        arg_bytes, out_bytes = per_device_bytes(args), tensor_bytes(out)
        _, step, _ = dryrun_inputs(cfg, shape, None, impl="cuda")
        real = roof_inputs(torch, dev, cfg, shape, args)
        step(*real)                                   # warm-up
        del out
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts(torch)
        times = []
        for _ in range(reps):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            res = step(*real)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
            del res
        peak = torch.cuda.max_memory_allocated(dev)
        counts = launch_counts()
        paths.append(counts)
        best = min(times)
        share = max(rep.compute_s, rep.memory_s) / best
        want = {k: reps * int(v["calls"]) for k, v in cost.kernels.items()}
        got = {k: n for k, n in counts.items() if n}
        print(f"[20] {arch} {shape_name} at B {batch} of {full.global_batch}"
              f" (S {shape.seq_len}, {cfg.n_layers} layers, full width; "
              f"counted on meta in {count_s:.1f} s on the host): flops "
              f"{cost.flops:.4e}, bytes {cost.bytes_min:.4e} (naive "
              f"{cost.bytes:.4e}); compute {1e3 * rep.compute_s:.4f} ms, "
              f"memory {1e3 * rep.memory_s:.4f} ms, {rep.bottleneck}-bound;"
              f" measured best {1e3 * best:.4f} ms, mean "
              f"{1e3 * sum(times) / reps:.4f} ms over {reps} (CUDA events);"
              f" share {share:.4f}; useful ratio {rep.useful_ratio:.4f}; "
              f"peak {peak / 1e9:.3f} GB against arguments "
              f"{arg_bytes / 1e9:.3f} GB + outputs {out_bytes / 1e9:.3f} GB;"
              f" launches {got} against {reps} x the count's calls "
              f"{ {k: int(v['calls']) for k, v in cost.kernels.items()} } "
              f"[{card}]", flush=True)
        if share > ROOF_SHARE_MAX:
            raise AssertionError(f"{arch} {shape_name}: the step ran at "
                                 f"{share:.4f} of its roofline: the count "
                                 "left work out")
        if peak < arg_bytes:
            raise AssertionError(f"{arch} {shape_name}: peak {peak} below "
                                 f"the argument bytes {arg_bytes}")
        if got != want:
            raise AssertionError(f"{arch} {shape_name}: launches {got} "
                                 f"against the count's {want}")
        del real
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    pt.reset_launch_count()
    for kw in ROOF_TICK_ROWS:
        row = sweep_tick_row(device=dev, **kw)
        print(f"[20] sweep tick {row['shape']}: flops/tick "
              f"{row['flops_per_tick']:.4e}, bytes/tick "
              f"{row['bytes_per_tick']:.4e}; roofline "
              f"{1e3 * row['roofline_s']:.4f} ms ({row['bottleneck']}) "
              f"against a measured sweep of {1e3 * row['measured_s']:.4f} ms"
              f" ({row['measured_tick_us']:.3f} us a tick, CUDA events): "
              f"share {row['useful_ratio']:.4f} [{card}]", flush=True)
        if row["useful_ratio"] > ROOF_SHARE_MAX:
            raise AssertionError(f"sweep tick {row['shape']}: share "
                                 f"{row['useful_ratio']:.4f}")
    return paths, pt.launch_count()


def sweep_fields(np, results):
    """The :data:`SWEEP_FIELDS` of each sweep result, in numpy."""
    return [{f: np.asarray(getattr(r, f)) for f in SWEEP_FIELDS}
            for r in results]


def same_fields(np, got, want, what):
    """Raise unless two runs' :func:`sweep_fields` are bit for bit
    alike."""
    for i, (a, b) in enumerate(zip(got, want)):
        for f in SWEEP_FIELDS:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"{what}: row {i}'s {f} differs")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows against {len(want)}")


def gloo_cuda_calls(torch):
    """Which raw ``torch.distributed`` calls the collectives use gloo
    takes on CUDA tensors: {call: None, or the error it raised}."""
    import torch.distributed as dist
    x = torch.arange(4, device="cuda", dtype=torch.int32)
    calls = {f"all_reduce {op}": (lambda op=op: dist.all_reduce(
        x.clone(), op=getattr(dist.ReduceOp, op))) for op in
        ("SUM", "MIN", "MAX")}
    calls["all_reduce SUM uint8"] = lambda: dist.all_reduce(
        x.to(torch.uint8))
    calls["all_gather"] = lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(dist.get_world_size())], x)
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = None
        except Exception as e:      # noqa: BLE001 (the finding itself)
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    return out


def dist_train(np, torch, dev, mesh):
    """Phase 21 (b)'s training: DIST_TRAIN_ARCH over ``mesh`` (its
    ``data`` axis carrying the workers), then the same on one rank
    (``mesh`` None) in this process; every field of the state and the
    metrics bit for bit alike.  Returns (seconds, launches, summary)."""
    from repro_torch.core.spmd_psp import (GeneratorNoise, PSPConfig,
                                           local_workers, psp_init)
    from repro_torch.launch.steps import make_psp_train_step
    from repro_torch.models import init_model
    from repro_torch.tree import tree_leaves
    cfg = train_config(DIST_TRAIN_ARCH, DIST_TRAIN_LAYERS)
    pcfg = PSPConfig(barrier="pbsp", n_workers=DIST_TRAIN_W, sample_size=1,
                     staleness=3, straggler_frac=0.5)
    batches = train_batches(torch, dev, cfg.vocab_size, DIST_TRAIN_TICKS,
                            workers=DIST_TRAIN_W)

    def run(m):
        opt = psp_optimizer(DIST_TRAIN_TICKS)
        noise = GeneratorNoise(1, dev)
        st = psp_init(pcfg, init_model(cfg, seed=0, device=dev).tree(),
                      opt.init, noise, mesh=m)
        step = make_psp_train_step(cfg, pcfg, opt, noise, mesh=m)
        metrics = []
        for b in batches:
            st, met = step(st, b)
            metrics.append(met)
        torch.cuda.synchronize()
        return st, metrics

    reset_launch_counts(torch)
    t0 = time.perf_counter()
    st, met = run(mesh)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    one, met1 = run(None)
    mine = local_workers(pcfg, mesh)
    for f in st._fields:
        got, want = getattr(st, f), getattr(one, f)
        if f == "views":
            want = [v[mine] for v in tree_leaves(want)]
            got = tree_leaves(got)
        else:
            got, want = tree_leaves(got), tree_leaves(want)
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"trainer over the mesh: {f} differs from "
                                 "one rank's")
    for a, b in zip(met, met1):
        if any(not torch.equal(a[k], b[k]) for k in b):
            raise AssertionError("trainer over the mesh: metrics differ")
    return secs, counts, (f"workers {mine.start}..{mine.stop - 1}, "
                          f"{int(st.total_pushes)} pushes, loss "
                          f"{float(met[-1]['loss']):.4f}")


class moe_outputs:
    """Records each ``moe_apply`` call's y while it is entered: the MoE
    layers' own outputs, which phase 21 (b) compares."""

    def __init__(self, moe):
        self.moe, self.ys = moe, []

    def __enter__(self):
        self.inner = self.moe.moe_apply

        def record(*a, **kw):
            y, aux = self.inner(*a, **kw)
            self.ys.append(y.float())
            return y, aux
        self.moe.moe_apply = record
        return self.ys

    def __exit__(self, *exc):
        self.moe.moe_apply = self.inner


def rel_err(torch, got, want) -> float:
    """max |got − want| / max |want|."""
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def dist_moe(np, torch, dev, mesh, rank):
    """Phase 21 (b)'s MoE prefill: DIST_MOE_ARCH on one device with its
    routing recorded, then with this rank's experts only over ``mesh``
    (placed by the rules: ``convert.expert_slice``) on that routing; the
    MoE layers' y within DIST_MOE_Y_TOL and the logits within
    DIST_MOE_TOL of their max, the ranks' kept (token, choice) pairs
    disjoint and together the one-device path's.  Then once more with
    the sum over ``model`` left out (a planted fault): y must fail its
    bound there.  Returns (seconds, launches, the logits' and y's
    errors, the fault's y and logits errors, dropped pairs of each
    layer)."""
    from repro_torch.convert import expert_slice
    from repro_torch.models import Model, init_model, moe, prefill
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import make_rules, use_rules
    cfg = train_config(DIST_MOE_ARCH, DIST_MOE_LAYERS)
    model = init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, DIST_MOE_PROMPT,
                           generator=gen, device=dev)
    with torch.no_grad(), moe.routing() as seen, moe_outputs(moe) as y1:
        want, _ = prefill(model, tokens)
    n = mesh.shape["model"]
    rules = make_rules(cfg, None, mesh)
    ep = Model(cfg, expert_slice(model.tree(), cfg, rules))

    def run_ep():
        with torch.no_grad(), use_rules(rules), \
                moe.routing(seen) as seen_ep, moe_outputs(moe) as ys:
            got, _ = prefill(ep, tokens)
        return got, ys, seen_ep

    reset_launch_counts(torch)
    t0 = time.perf_counter()
    got, ys, seen_ep = run_ep()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    err = rel_err(torch, got, want)
    y_err = max(rel_err(torch, a, b) for a, b in zip(ys, y1))
    if not torch.isfinite(got).all() or err > DIST_MOE_TOL \
            or y_err > DIST_MOE_Y_TOL or len(ys) != len(y1):
        raise AssertionError(f"expert-parallel logits off by {err:.4g} of "
                             f"max |logit| (bound {DIST_MOE_TOL}), y by "
                             f"{y_err:.4g} of max |y| (bound "
                             f"{DIST_MOE_Y_TOL})")
    # the planted fault: each rank keeps its own experts' share of y
    moe._SumOver.apply = lambda t, axis: t
    try:
        bad, bad_ys, _ = run_ep()
    finally:
        del moe._SumOver.apply      # back to torch.autograd.Function's
    fault = (max(rel_err(torch, a, b) for a, b in zip(bad_ys, y1)),
             rel_err(torch, bad, want))
    if fault[0] <= DIST_MOE_Y_TOL:
        raise AssertionError(f"y's bound {DIST_MOE_Y_TOL} misses a missing "
                             f"sum over model (y off by {fault[0]:.4g})")
    model_axis = collectives.mesh_axis(mesh, "model")
    e_loc = cfg.n_experts // n
    dropped = []
    for top_i in seen:
        T = top_i.shape[0]
        dummy = torch.zeros((T, 1), device=dev)
        cap = moe.capacity(T, cfg)
        ok1 = moe.dispatch(dummy, top_i, cap, cfg.n_experts)[2]
        mine = moe.dispatch(dummy, top_i, cap, cfg.n_experts,
                            rank * e_loc, e_loc)[2]
        every = collectives.all_gather(mine[None], model_axis, 0)
        if not (torch.equal(every.any(0), ok1)
                and int(every.sum(0).max()) <= 1):
            raise AssertionError("the ranks' kept tokens are not the "
                                 "one-device path's")
        dropped.append(int((~ok1).sum()))
    if len(seen_ep) != len(seen):
        raise AssertionError("the expert-parallel prefill routed "
                             f"{len(seen_ep)} times, not {len(seen)}")
    return secs, counts, (err, y_err), fault, dropped


def dist_rank(short, meshes):
    """One rank of phase 21 (b), a spawned child sharing the card: which
    calls gloo takes on CUDA tensors, the sweep of ``short`` on each of
    ``meshes``, the training and the MoE prefill.  Returns its findings
    and launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import run_sweep
    from repro_torch.kernels import psp_tick as pt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend(),
           "world": dist.get_world_size(), "gloo_cuda": gloo_cuda_calls(torch),
           "sweeps": {}}
    os.environ.pop("PSP_TICK_IMPL", None)
    for mesh in meshes:
        collectives.reset_call_counts()
        torch.cuda.synchronize()
        pt.reset_launch_count()
        t0 = time.perf_counter()
        res = run_sweep(short, device=dev, mesh=mesh)
        out["sweeps"][mesh] = (sweep_fields(np, res), pt.launch_count(),
                               collectives.call_counts(),
                               time.perf_counter() - t0)
    collectives.reset_call_counts()
    out["train"] = dist_train(np, torch, dev, make_host_mesh(
        DIST_RANKS, 1, device_type="cuda"))
    out["train_calls"] = collectives.call_counts()
    collectives.reset_call_counts()
    out["moe"] = dist_moe(np, torch, dev, make_host_mesh(
        1, DIST_RANKS, device_type="cuda"), rank)
    out["moe_calls"] = collectives.call_counts()
    return out


def phase21(np, torch, dev, card, short, cuda_runs):
    """The device mesh over torch.distributed (see the module docstring,
    21).  Returns (the model kernels' launches of each run, the tick's
    launches)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import run_sweep
    from repro_torch.core.vector_sim import VectorSimulator
    from repro_torch.core.vector_sim_torch import ticks_to_run
    from repro_torch.kernels import psp_tick as pt
    from repro_torch.launch.mesh import spawn_host_world
    from repro_torch.parallel import collectives
    want = sweep_fields(np, cuda_runs)
    ticks = ticks_to_run(VectorSimulator(short), (1, 1))

    # (a) one rank over NCCL: the collectives run on the card
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="psp_nccl_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=120))
    try:
        os.environ.pop("PSP_TICK_IMPL", None)
        collectives.reset_call_counts()
        torch.cuda.synchronize()
        pt.reset_launch_count()
        res = run_sweep(short, mesh=(1, 1))
        launches = pt.launch_count()
        calls, backend = collectives.call_counts(), dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    same_fields(np, sweep_fields(np, res), want,
                "the (1, 1) mesh over NCCL against phase 4's cuda run")
    if launches != ticks:
        raise AssertionError(f"(1, 1) mesh: {launches} tick launches for "
                             f"{ticks} ticks")
    if backend != "nccl" or not calls:
        raise AssertionError(f"(1, 1) mesh: backend {backend}, calls "
                             f"{calls}")
    print(f"[21] (a) world 1, backend {backend}: phase 4's 5 s sweep on the "
          f"(1, 1) mesh, {launches} tick launches for {ticks} ticks, "
          f"collective calls {calls}; steps, errors, server updates, total "
          f"updates and control messages bit for bit phase 4's cuda run; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # (b) two gloo ranks sharing the card, as spawned children
    t0 = time.perf_counter()
    ranks = spawn_host_world(DIST_RANKS, dist_rank, short, DIST_MESHES,
                             backend="gloo", wall=DIST_WALL)
    paths = []
    refused = {k: v for k, v in ranks[0]["gloo_cuda"].items() if v}
    print(f"[21] (b) world {ranks[0]['world']}, backend "
          f"{ranks[0]['backend']}, one card: gloo takes CUDA tensors for "
          f"{sorted(set(ranks[0]['gloo_cuda']) - set(refused))}, refuses "
          f"{refused or 'none'}", flush=True)
    if refused:
        raise AssertionError("gloo refuses CUDA tensors for a call the "
                             "collectives make unstaged")
    for mesh in DIST_MESHES:
        for out in ranks:
            fields, n, calls, secs = out["sweeps"][mesh]
            same_fields(np, fields, want, f"mesh {mesh} rank {out['rank']}")
            if n != ticks:
                raise AssertionError(f"mesh {mesh} rank {out['rank']}: {n} "
                                     f"tick launches for {ticks} ticks")
            launches += n
            print(f"[21] (b) rank {out['rank']}: the sweep on {mesh} "
                  f"{'(the gathered CUDA tick) ' if mesh[1] > 1 else ''}"
                  f"bit for bit (a), {n} tick launches, collective calls "
                  f"{calls}, {secs:.2f} s [{card}]", flush=True)
    for out in ranks:
        secs, counts, summary = out["train"]
        paths.append(counts)
        print(f"[21] (b) rank {out['rank']}: {DIST_TRAIN_ARCH} at "
              f"{DIST_TRAIN_LAYERS} layers, W {DIST_TRAIN_W}, "
              f"{DIST_TRAIN_TICKS} ticks ({summary}) bit for bit one rank's "
              f"in {secs:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }, collective calls "
              f"{out['train_calls']} [{card}]", flush=True)
        secs, counts, (err, y_err), fault, dropped = out["moe"]
        paths.append(counts)
        print(f"[21] (b) rank {out['rank']}: {DIST_MOE_ARCH} at "
              f"{DIST_MOE_LAYERS} layer, experts over model {DIST_RANKS}, "
              f"prefill {DIST_MOE_PROMPT} in {secs:.2f} s: the MoE layers' "
              f"y within {y_err:.4g} of max |y| (bound {DIST_MOE_Y_TOL}), "
              f"logits within {err:.4g} of max |logit| (bound "
              f"{DIST_MOE_TOL}) of the one-device path, the same kept "
              f"tokens ({dropped} pairs dropped by layer); without the sum "
              f"over model (planted) y off by {fault[0]:.4g}, logits by "
              f"{fault[1]:.4g}; launches "
              f"{ {k: v for k, v in counts.items() if v} }, collective calls "
              f"{out['moe_calls']} [{card}]", flush=True)
    print(f"[21] (b) took {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, launches


def main() -> int:
    """Run every phase (see the module docstring); 0 when all passed."""
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
    if sys.argv[1:2] == [LOOP_CHILD]:
        return loop_trainer(torch, torch.device("cuda", 0), sys.argv[2])
    if sys.argv[1:2] == [EXAMPLE_CHILD]:
        return example_child(torch, *sys.argv[2:5], sys.argv[5:])
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

    tt = time_tick(np, torch, pt, dev, st, shapes, prm, ln, jn, kw)
    ms_kernel, ms_plain, bound = tt["ms"], tt["plain_ms"], tt["bound_ms"]
    t_ops, t_bytes = roof().times_ms(tt["flops"], tt["bytes"][True],
                                     f32=True)
    print_tick_time("[2] paper-shape tick", tt, B * P, card)
    for case in LONG_CASES:
        check_tick_case(np, torch, pt, dev, case, *TICK_LONG, n_ticks=3)
    fs = check_finish_start(np, torch, pt, dev, *TICK_LONG)
    print(f"[2] kernel == plain at (B, P, d, m) = {TICK_LONG} on "
          f"{len(LONG_CASES)} branch cases, 3 chained ticks (the row read "
          f"from global memory, the starters listed in tiles); {fs} nodes "
          "finishing and starting in one tick", flush=True)

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
    entries = []
    for part in (phase5, phase5_ssd, phase5_ssd_bwd, phase5_bwd,
                 phase5_danube, phase5_rgemma, phase5_rgemma_bwd,
                 phase5_moe, phase5_frontends):
        t0 = time.perf_counter()
        out = part(np, torch, dev, card)
        if isinstance(out, dict):
            entries.append(out)
        elif isinstance(out, list):
            entries += out
        print(f"[5] {part.__name__} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    # ---- 6. and 7. the serving paths: qwen2-0.5b, then mamba2-780m ----- #
    paths = []
    for tag, argv in ((6, SERVE_ARGV), (7, MAMBA_ARGV)):
        print(f"[{tag}] starts at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        paths.append(serve_phase(np, torch, dev, card, argv, tag))

    # ---- 8. PSP training of qwen2-0.5b --------------------------------- #
    print(f"[8] starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    paths.append(phase8(np, torch, dev, card))

    # ---- 9., 10. and 12. the trainer → server loop, resume, mamba2 PSP
    # training (11., the cluster, runs in phase 19's chaos suite)
    for tag, phase in ((9, phase9), (10, phase10), (12, phase12)):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] starts at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        counts = phase(np, torch, dev, card)
        if counts is not None:
            paths.append(counts)
    print(f"[13] starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    fig_launches, _ = phase13(np, torch, dev, card)
    launches += fig_launches
    print(f"[13] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 14. the sliding-window and local/global decoders ------------- #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[14] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    paths += phase14(np, torch, dev, card)
    print(f"[14] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 15. recurrentgemma-2b: RG-LRU and local attention ------------- #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[15] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    paths += phase15(np, torch, dev, card)
    print(f"[15] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 16. recurrentgemma-2b trained under PSP ----------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[16] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    paths.append(phase16(np, torch, dev, card))
    print(f"[16] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 17. the MoE decoders: qwen3-moe-30b-a3b and dbrx-132b --------- #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[17] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    paths += phase17(np, torch, dev, card)
    print(f"[17] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 18. the frontend models: internvl2-2b and musicgen-large ------ #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[18] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    paths += phase18(np, torch, dev, card)
    print(f"[18] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 19. the reference's remaining entry points ------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[19] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    more, example_ticks = phase19(np, torch, dev, card)
    paths += more
    launches += example_ticks
    print(f"[19] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 20. the roofline on the card -------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[20] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    more, roof_ticks = phase20(np, torch, dev, card)
    paths += more
    launches += roof_ticks
    print(f"[20] ends at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 21. the device mesh over torch.distributed ------------------ #
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[21] starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    more, dist_ticks = phase21(np, torch, dev, card, short, runs["cuda"])
    paths += more
    launches += dist_ticks
    print(f"[21] ends at {time.perf_counter() - t_start:.1f} s", flush=True)
    for e in entries:
        e["launches"] = sum(n.get(e["name"], 0) for n in paths)

    print(json.dumps({"kernels": [{
        "name": "psp_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/psp_tick.cu",
        "replaces": "src/repro/kernels/psp_tick.py:862",
        "launches": launches, "max_abs_err": err, "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound, "bound_by":
            "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None}, *entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
