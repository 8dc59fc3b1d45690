#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card's name and power limit; build the kernels from
   ``src/repro_torch/.../csrc`` with nvcc (sm_90a), one nvcc per source,
   started together: the flash-attention forward (K1) and backward (K2
   dQ, K3 dK/dV), the SSD chunk scan (K4) and the percentile stretch (K5);
   beside them three more with ``-Xptxas -v``, for the registers and
   spills of K4's tensor-core entry (``tc::ssd_scan_wgmma``, which must not
   spill) and of K1's, K2's and K3's at hd 64, 80 and 128 (the hd-80 ones
   must not spill);
2. hold K1 against its plain PyTorch version on the card, in bf16 and f32,
   at the prefill shapes of granite-3-2b, glm4-9b (GQA 16 at hd 128),
   codeqwen1.5-7b (MHA at hd 128) and qwen3-moe-30b-a3b (GQA 8 at hd 128,
   a window of 8192 that binds nowhere at 2048), at hubert-xlarge's
   training shape (non-causal, 16 heads of 80), at hd 80 a causal GQA
   shape and a ragged one, at a non-causal hd-64 shape (the tensor cores'
   non-causal branch), at ragged, windowed and MHA hd=128 shapes, and at
   fsdp_sp's blocks (``SP_SHAPES``: 1024 queries against 2048 keys at
   q_offset 1024, hd 64 and 80, causal and windowed, and the first
   block's at q_offset 0, against SDPA with the same boolean mask) (one
   JSON line per shape: K1's route, tensor cores for bf16 at hd 64, 80 and
   128, CUDA cores otherwise, checked by its route counter; on the tensor
   cores two launches bitwise equal; errors, kernel / plain / library ms,
   the wrapper's host ms per call, TFLOP/s, the least time the card could
   take and the kernel's share of it);
3. hold K2 and K3 against the plain backward, in bf16 and f32, at
   stablelm-1.6b's training shape, granite-3-2b's GQA shape, hubert's and
   the non-causal hd-64 shape, ragged, windowed and MHA hd=128 shapes, and
   at hd 80 a causal GQA shape and a ragged one, and at ``SP_SHAPES``,
   the same way (their
   route by K1's table: the tensor cores for bf16 at hd 64, 80 and 128,
   checked by their route counters; two launches bitwise equal; each
   kernel's share of its bound and the wrapper's host ms per call); then
   (3b) the whole differentiable op (K1 -> K2 + K3) against autograd of
   plain attention, at granite's heads and at hubert's (non-causal hd 80
   in bf16: K1, K2 and K3 on the tensor cores);
4. train full-width stablelm-1.6b (24 layers, bf16, random weights from a
   seed) through ``TrainLoop``: AdamW, warmup-cosine, remat, the Markov
   token stream at batch 8 x seq 2048; K1 must launch 2 x 24 times a
   step and K2 and K3 24, every launch on the tensor cores; losses,
   steps/s, tokens/s, model FLOP utilisation and peak memory;
   ``torch.profiler`` over one step; then one (4, 2048) step's loss and
   gradients through the kernels and through plain attention, both bf16,
   each against plain attention in f32;
5. serve full-width granite-3-2b (40 layers, bf16, random weights from a
   seed) through ``ServeEngine``: 16 greedy requests, prompts of 16-1500
   tokens, 32 new tokens each, 8 slots; K1 must launch 40 x prefill calls,
   every launch on the tensor cores;
   one prefill batch through the kernel and through plain attention, each
   held against an f32 prefill; ``torch.profiler`` over one prefill and 8
   decode steps;
5c. the same for glm4-9b (40 layers, 32 q / 2 kv heads of 128) and
   codeqwen1.5-7b (32 layers, 32 heads of 128), whose logit gate runs at 4
   rows (``GATE_ROWS``);
5d. serve full-width granite-3-2b through ``ServeScheduler`` on the real
   clock: 32 requests of a Poisson trace at 2 requests/s, a 5 s TTFT SLO
   and a KV pool of 384 blocks of 16, so that requests are evicted and
   re-prefilled; every request completes or is shed, every block returns,
   K1 launches 40 x prefill calls on the tensor cores; tokens/s, goodput,
   TTFT / TPOT / queue-wait percentiles; ``torch.profiler`` over 8 of the
   scheduler's decode ticks;
5e. token identity: (a) 16 of those prompts arriving at once through the
   scheduler and through the engine at full width give the same greedy
   tokens (and, not gated, how phase 5d's evicted requests compare with
   the same prompts served unevicted); (b)
   the reduced granite in f32 on the card resumes evicted requests token
   for token;
5g. (after phase 6's CLI) ``LegacyServeEngine``, the reference's plain
   engine (one prefill a request at its own length, the whole logits
   sampled on the host, the state copied every step) on the full-width
   granite of phase 5 (bf16): the first 4 of phase 5's requests, 16 new
   tokens each, 4 slots: K1 40 x 4 launches, all on the tensor cores;
   beside it ``ServeEngine`` on the same requests: both walls and the
   share of tokens alike (printed); then the reduced granite in f32: the
   legacy engine's greedy tokens equal ``ServeEngine``'s on
   ``tests/test_serve.py``'s case;
6. run ``serve_main("granite-3-2b")`` (the reduced serve CLI) on the card,
   then (6b) its continuous mode for granite-3-2b and mamba2-2.7b;
5f. serve full-width qwen3-moe-30b-a3b (48 layers, 128 experts top-8,
   bf16, random weights from a seed) through ``ServeEngine`` with phase
   5's traffic: the parameters equal ``param_count()``, K1 launches 48 x
   prefill calls, every launch on the tensor cores; ``torch.profiler``
   over one prefill and 8 decode steps; the MoE layer's time by stage
   (routing, dispatch, the experts' matmuls, combine) at the prefill's
   and a decode step's tokens; then the logit gate on a 4-layer depth cut
   of the same widths (``GATE_LAYERS``: the full depth's f32 yardstick
   would take 122 GB), after the full model is freed, with its routing
   witness (the share of tokens whose experts differ from f32's, and the
   error left when the f32 prefill takes the kernel path's experts);
7. run ``train_main("stablelm-1.6b")`` (the reduced train CLI) with
   checkpoints, preempt it, resume it, and hold it bitwise against an
   uninterrupted run, in PyTorch's deterministic mode: in f32 (7, the
   CUDA-core route of K1-K3) and in ``precision="bf16"`` (7b: q/k/v in
   bf16 at hd 64, so every K1, K2 and K3 launch must take the tensor
   cores);
8. hold K4 against the plain chunked scan: y and the final state, in bf16
   and f32 at mamba2-2.7b's serving prefill shape (Bs 8, S 2048, 80 heads
   of 64, g 1, N 128, Q 256), and in bf16 at a ragged S 1000, jamba's
   widths (128 heads of 128, g 8), the one-period jamba's prefill (Bs 8,
   S 2048, 64 heads of 128, g 8) and its ragged S 1000, Q 64 at S 4096,
   and phase 28's mamba2 prefill (Bs 2, S 32 768); each shape's route
   (tensor cores for bf16, CUDA cores for f32, checked by the route
   counters) and two launches bitwise equal; each shape's kernel ms, the
   least time the card could take and TFLOP/s; ptxas's registers and
   spills of the tensor-core entry (a second nvcc, ``-Xptxas -v``, in
   phase 1);
9. serve full-width mamba2-2.7b (64 layers, bf16, random weights from a
   seed) through ``ServeEngine`` with phase 5's traffic; K4 must launch
   64 x prefill calls, every launch on the tensor cores; the prefill batch
   through K4 and through the plain scan, each against an f32 prefill;
   ``torch.profiler`` over one prefill and 8 decode steps; then
   ``serve_main("mamba2-2.7b")`` and its K4 routes;
9c. the hybrid: jamba-1.5-large-398b cut to one period
   (``jamba_one_period``: 8 layers, 7 SSD and 1 attention, MoE on 4;
   d_model 4096) through ``ServeEngine`` with phase 5's traffic: K1
   launches 1 and K4 7 x prefill calls, all on the tensor cores; the
   prefill through the kernels and through the plain versions against
   f32, with the routing witness of 5f; then
   ``serve_main("jamba-1.5-large-398b")`` (reduced, f32, the
   CUDA-core routes);
9d. train full-width mamba2-2.7b through ``TrainLoop`` (AdamW,
   warmup-cosine, remat) at batch 8 x seq 2048, a warm-up and 3 measured
   steps: K4 launches twice per layer and step (the forward and remat's
   recompute; its backward is the plain scan), all on the tensor cores;
   ``torch.profiler`` over one step; what one layer's plain backward
   adds to the memory; one (4, 2048) step's loss and gradients through
   K4 and through the plain scan against f32;
10. hold K5 against the plain stretch, bit for bit, on reflectance-like
    data made on the card: a 10980 x 10980 Sentinel-2 tile of 4 and of 13
    bands, more than 2**31 elements (checked in row chunks), the vision
    slice's scene and composite, a ragged R and one band, and bf16 input;
    at the 4-band tile also the time of the percentile helper (its sort);
11. the burned-area study: ``build_dataset`` normalizes four 2048 x 2048
    scenes through K5 (4 launches) and chips them at the paper's recipe;
    the scenes are held against numpy's ``percentile_stretch`` and the
    plain stretch on the card; U-Net at width 16 trains 4 epochs (Adam,
    batch 16), then U-Net++, DeepLabV3 and DeepLabV3+ one epoch each
    (LAMB); losses, steps/s, chips/s, peak memory, val metrics;
    ``torch.profiler`` over one U-Net step; each model's and ChangeFormer's
    forward on the card against the same weights on the CPU; (11b) the
    burned-area grid (``vision_grid.run_grid``) on the same split,
    U-Net at width 16, batch 16, 2 epochs a job: the example's six jobs
    through ``Orchestrator.run_local`` on ``cuda``, each ``Succeeded``
    with F1 and IoU in [0, 1]; each job's F1, IoU and wall, the best
    config, the simulated makespan;
12. the deforestation study: ``build_pairs`` makes six 256 x 256 NIR-R-G
    composite pairs through K5 (12 launches), held against numpy's
    ``nir_rg``; ChangeFormer trains 60 full-batch AdamW steps on four and
    is scored on two;
13. the reduced vision CLI (``repro_torch.launch.vision.main``) on the
    card; (13b) ``python -m repro_torch.launch.vision_grid`` (a
    subprocess, run beside phase 20, read here) at the example's size:
    six jobs ``Succeeded`` on ``cuda``, K5 4 launches.
14. (run between phases 23 and 10) the run API's front door in this
    process:
    ``repro_torch.launch.__main__.main(["run", "train", "--full", ...])``
    trains full-width stablelm-1.6b (bf16, 8 x 2048, 4 steps): a
    ``succeeded`` report, 4 finite losses, K1-K3 launched as
    ``train_launches`` predicts, all on the tensor cores; steps/s, the
    loop's step time, the report's ``wall_s`` and the peak memory;
15. ``python -m repro_torch.launch run serve`` as real subprocesses:
    granite-3-2b (the same counts as a direct ``serve_main`` call, K1
    launched) and mamba2-2.7b (K4 launched); ``run bogus`` exits 2;
16. ``run train`` on the reduced stablelm (bf16, deterministic mode)
    preempted (a ``failed`` report), then ``--resume``: losses and final
    checkpoint bitwise equal to an uninterrupted ``train_main`` call's;
17. a two-learning-rate grid of the reduced stablelm through
    ``Orchestrator.submit_runs(attach_payload=True)`` and ``run_local``:
    each job preempted once, resumed from step 2 under the retry env,
    results on the PVC and in S3 with the checkpoints, every K1-K3 launch
    on the tensor cores;
18. ``run simulate --campaign all``: 234 jobs, 234 manifests, 4040.0
    wall-hours; ``autobatch`` for stablelm-1.6b at seq 2048 against the
    card's own ``MemoryBudget`` (not gated);
19. the campaign executor at full width: ``python -m repro_torch.launch
    campaign run`` as a subprocess (``--workers 2`` over a one-node
    inventory, ``NODE``: the card) runs phase 14's ``run train`` of
    stablelm-1.6b and phase 15's ``run serve`` of granite-3-2b and
    mamba2-2.7b, each job a ``run <kind>`` subprocess on the card: every
    job succeeds at its first attempt with ``device`` cuda, granite's K1
    and mamba2's K4 launches equal phase 15's, ``campaign status --json``
    exits 0 and replays consistent, and the log never holds two GPU jobs
    on the node at once; the makespan, each job's wall time and queue
    wait, the GPU-busy share and the train job's step time beside phase
    14's;
20. ``Orchestrator.run_cluster`` in this process: two reduced stablelm
    jobs (bf16) under ``ChaosSpec(after_checkpoints=1)`` (SIGKILL) on the
    one-node inventory: each succeeds at its second attempt, the first
    ``preempted``; the retry resumes from the last step the killed attempt
    published; its losses equal an uninterrupted ``train_main`` run's
    within ``CAMPAIGN_LOSS_RTOL`` (the children run outside deterministic
    mode); the log replays consistent; whether the final checkpoints are
    bitwise equal (not gated);
21. ``campaign run`` (four reduced stablelm jobs, ``--workers 1``, the
    one-node inventory) as a subprocess, SIGKILLed once its log holds a
    success and a running attempt, then restarted with
    ``--resume-campaign``: every job succeeds, no job that had succeeded
    starts again, each attempt alive at the kill is adopted or re-queued
    once, and the log replays consistent;
22. (run after phase 9d) train full-width hubert-xlarge (48 layers,
    non-causal, 16 heads of 80, bf16; 945 256 960 parameters) through
    ``TrainLoop`` on its seeded frame batches at 8 x 2048, a warm-up and
    3 measured steps: K1 2 x 48 launches a step, K2 and K3 48 each, all
    on the tensor cores (``kernel.route`` at hd 80); step time, MFU
    over the (q, k) pairs the non-causal mask admits, peak memory, one
    step under ``torch.profiler``; the gradient gate of 4c on the
    trained weights' first 8 layers; then ``run train --arch
    hubert-xlarge --full`` (2 steps) in this process: ``succeeded`` on
    cuda, K1-K3 as ``train_launches`` predicts, on the same routes;
23. llava-next-mistral-7b at full width (32 layers, 32 q / 8 kv heads of
    128, bf16; 7 241 732 096 parameters): (a) one prefill of
    ``make_batch(cfg, 8, 2048)``, 512 patch embeddings ahead of 1536
    tokens: K1 32 launches on the tensor cores, finite logits and KV
    caches, its ms and profile, then the prefill gate judged on the decode
    state on the first 8 layers (rows of 512 patches and 1-1536 tokens);
    (b) with nothing else resident, training at full width and depth
    (1 x 2048, bf16 weights, gradients and AdamW moments, remat), a
    warm-up and 2 measured steps, every K1-K3 launch on the tensor cores;
24. (run after phase 21) ``dist_train_main(world_size=1)`` on the
    reduced stablelm (bf16, deterministic mode, checkpoints): no process
    group, no collective, losses and final checkpoint equal to
    ``train_main``'s bit for bit;
25. ``run train --full --world_size 2`` (stablelm-1.6b, bf16, global 8 x
    2048, 3 steps) as a subprocess: ``run_gang_local`` starts two ranks,
    both on ``cuda:0`` with gloo (they share the card); each rank's K1-K3
    launches are ``train_launches``'s, all on the tensor cores; every rank
    agrees on the final parameters; the losses within ``GANG_LOSS_RTOL``
    of a world-1 ``run train`` with the same arguments; the step time, each rank's peak memory, the all-reduce's
    seconds a step against the step and the bytes reduced beside
    ``grad_bytes``.  With a card per rank the gang takes nccl, and with
    four cards (25b) a world-4 gang runs too;
26. ``Orchestrator.run_cluster``: a world-2 gang of the reduced stablelm
    (bf16) on one node whose two GPU slots are both the card, under
    ``ChaosSpec(after_checkpoints=1)``: a rank is SIGKILLed, the gang
    succeeds at its second attempt, resumed from the last published
    step, its losses within ``GANG_LOSS_RTOL`` of an uninterrupted
    world-1 run; the log replays consistent; whether its final checkpoint
    equals the world-1 run's bit for bit (not gated: the sums differ);
27. (started before phase 1 and after it, read after phase 28) ``python -m
    repro_torch.launch run dryrun --arch all --shape SHAPE --mesh both
    --layout fsdp_tp`` for ``train_4k`` and ``decode_32k``, two
    subprocesses on the host, under no timed phase: every arch's train
    and decode step built and run on the meta device (the
    kernels' meta formulas; the card's host has no JAX, so this also
    proves the import graph), once for one card and once as the last
    rank of each production mesh (16x16 and 2x16x16, llama4-maverick's
    40 query heads on a model axis of 16 included), every cell ``ok``;
    one line per arch with the traced / analytic FLOPs, the bytes by
    kind, the traced peak, ``fits_one_card``, ``max_batch_one_card`` and
    its peak, and one per arch and mesh with the rank's peak,
    ``fits_one_card`` and collective bytes by mechanism, gated: its
    parameters, gradients, optimizer state and decode state the rules'
    per-device bytes (``sharded_bytes``) to the byte (a decode rank's
    ``fsdp_tp`` cache slots of every kv head, SSM heads and conv
    channels), a finite positive traced / analytic FLOPs, and on
    2x16x16 a train rank's ``pod_gradsync`` the count from the shapes
    to the byte; then one cell (granite-3-2b x
    prefill_32k) in this process, which must leave
    ``torch.cuda.memory_allocated()`` as it was;
28. K1 at granite-3-2b x prefill_32k's one-card shape (B 2, S 32 768,
    its window of 8192) against the plain forward on every row of two kv
    groups' heads, and K2 and K3 at stablelm-1.6b x train_4k's (B 16, S
    4 096) against the plain backward on every batch row, with their
    times beside SDPA's; then ``run perfprobe`` in this process for
    stablelm-1.6b x train_4k,
    granite-3-2b x prefill_32k, mamba2-2.7b x prefill_32k and granite-3-2b
    x decode_32k, each at the dry run's one-card batch and the shape's
    whole sequence: ``succeeded`` on cuda; K1 2 x 24 launches a training
    step and K2 and K3 24, K1 40 a granite prefill, K4 64 a mamba2
    prefill, none in decode, all on the tensor cores; peak memory under
    the one-card budget the dry run cut the batch to (80 GB less
    ``MemoryBudget``'s reserve); the measured step, on the host's clock
    and as the profiled device-busy time, not below the analytic lower
    bound; a finite loss or logits; the step's profile (K1-K4's device ms);
29. ``run perfprobe --layout fsdp_tp --world_size 2`` on full-width
    stablelm-1.6b (bf16, global 8 x 2048, a warm-up and a measured step)
    as a subprocess: two ranks on ``cuda:0`` (gloo, the tensor
    collectives), each holding half of every sharded parameter and
    moment; beside it the ``dp`` gang of the same weights, batch and
    steps (``RANK_JOBS``).  The losses within ``GANG_LOSS_RTOL`` of the
    dp gang's; each rank's peak at least 5 GB under phase 25's; each
    rank's collective bytes by mechanism beside the analytic model's for
    {data: 2, model: 1}; K1-K3 as a training step predicts, on the
    tensor cores;
30. full-width mamba2-2.7b under ``fsdp_sp``, its depth cut to 4 of 64
    layers (global 4 x 2048): K4 8 launches a rank in the measured step,
    on the tensor cores; the ranks' losses equal.  Phase 29's dp gang and
    this one are ``RANK_JOBS``, run by one gang of this script's own
    ranks (``--sharded-rank``), each job through ``steps.build_train``
    on a data grid;
31. ``ssd_seq_parallel`` at mamba2's widths, 8 x 2048 in 4 segments: one
    K4 launch for all segments, its scan of the folded segments against
    the plain scan under K4's tolerance, and the whole against the plain
    scan of the whole sequence (y with one bf16 rounding of each addend
    allowed beside it); its time beside one K4 scan's and the plain's;
32. ``fsdp_tp`` on the grid ``{model: 2}``: four more ``RANK_JOBS`` of
    the same gang at full width, depth cut, each rank computing half the
    heads, MLP columns, SSD heads, experts and (where the rules split it)
    vocabulary: stablelm-1.6b training (4 layers, 4 x 2048; K1 8, K2 4,
    K3 4 a rank at 16 q heads) against world 1 (first loss and
    ``grad_norm``, second loss within ``GANG_LOSS_RTOL``); granite-3-2b
    (4 layers, prefill 4 x 2048 and 8 decode steps; its logits), mamba2
    (4 layers, 2 x 2048 + 8; K4 at 40 heads a rank; its prefill's logits
    and decode state) and qwen3-moe (2 layers, 64 experts a rank; its
    prefill's decode state) no more than twice as far from an f32 run as
    world 1's bf16 run, their decode state the rules' block (each rank's
    half of the cache slots of every kv head, half the SSM heads and
    conv channels: its bytes the rules' per-device bytes after the
    prefill and after the last step), the prefill resharding the state
    to it (``state_reshard``), a decode step gathering the token's q, k
    and v (``qkv_allgather``) and ``[x, B, C]`` row (``xbc_allgather``),
    the softmax over the slots combined (``softmax_combine``) and the
    post-conv row gathered (``conv_allgather``); every rank's
    ``tp_allreduce`` and decode-state bytes the port's count from the
    shapes (``tp_allreduce_bytes``, ``tp_state_bytes``), beside the
    analytic model's, which has no term for the decode state's;
33. ``fsdp_sp`` on the grid ``{model: 2}``: four more ``RANK_JOBS`` of
    the same gang at full width, depth cut, each rank on its half of the
    sequence (K1-K3 its 1024 queries against the 2048 gathered keys at
    q_offset 0 and 1024, K4 its segment, the segment states exchanged
    and the conv halo): stablelm-1.6b training (4 layers, 4 x 2048; K1
    8, K2 4, K3 4 a rank a step) against world 1 at four seeds (first
    loss, first ``grad_norm`` and second loss within ``TRAIN_RTOL``, the
    ranks' losses and norms equal), and once with the model all-reduce
    of the leaves replicated over model dropped, which must fail that
    gate; granite-3-2b's prefill and 8 decode steps on the ranks' halves
    of the cache, a softmax distributed over them (4 layers, 4 x 2048:
    its prefill's logits, the decode steps' logits and the assembled K/V
    cache no more than twice as far from an f32 run as world 1's, the
    cache no farther from world 1's than world 1's is from f32); mamba2
    (4 layers, 2 x 2048, its decays slowed so that a block's incoming
    state counts: training as stablelm's, K4 one launch a layer a pass,
    then a prefill and 8 decode steps on the rank's SSM heads and conv
    channels, judged as granite's); qwen3-moe (2 layers, 4 x 2048, 64
    experts a rank, each rank's block one dispatch group and the buffer
    exchanged by all-to-all: training as stablelm's against world 1
    under the mesh's ctx, whose groups are the same, then a prefill and
    8 decode steps judged on the state); every rank's bytes by
    sequence-parallel mechanism the port's count from the shapes
    (``sp_bytes``, the decode steps' and the all-to-all's included), to
    the byte, its peak memory under world 1's and its host step time
    beside world 1's.

34. the ``pod`` axis on ``{pod: 2, data: 1, model: 2}``: a second gang
    of this script's ranks (``--pod-rank``, four processes on the card,
    gloo; ``POD_JOBS``), two replicas of ``{model: 2}``, each on half the
    global batch: (a) stablelm-1.6b ``fsdp_tp`` training (4 layers, 4 x
    2048; K1 8, K2 4, K3 4 a rank a step on the tensor cores) against
    world 1 (first loss, ``grad_norm`` and second loss within
    ``GANG_LOSS_RTOL``, the ranks' losses equal), the two pods'
    parameter blocks bit for bit equal after each step, every rank's
    ``tp_allreduce`` and ``pod_gradsync`` the counts from the shapes, to
    the byte, beside the analytic model's; (b) granite-3-2b ``fsdp_sp``,
    a prefill of 4 x 2048 and 8 decode steps, each rank on its rows and
    its half of the sequence and the cache, judged as phase 33's serve
    jobs; each rank's peak and host times beside world 1's.

The subprocesses of phases 29-34 (the ``--sharded-rank`` gang, then
phase 29's probe gang; the ``--pod-rank`` gang) and phase 21 run beside
phase 20, whose reduced jobs leave the card nearly idle; each phase's
checks run in its place.

Phases 2 and 3 time each kernel and SDPA as the median of five windows
and print the least and most beside it.

The line before the last lists each ported kernel with its launches on
its main path (K1-K3 training, and K1 on each serving path, qwen3-moe's
and the hybrid's included; K4 mamba2 serving, with the hybrid's and
mamba2 training's beside it; K5 the two vision studies; K1-K3's launches
in phases 14, 16 and 17 as ``launches_run_api``, the subprocesses'
K1 and K4 launches of phase 15 as ``launches_run_api_cli`` and of phase
19's campaign children as ``launches_campaign``, K1-K3's in phases 22
and 23 as ``launches_train_hubert``, ``launches_run_api_hubert``,
``launches_prefill_llava`` and ``launches_train_llava``, each rank's
of phase 25's gang as ``launches_train_gang``, each rank's of phase 29's
(K1-K3) or phase 30's (K4) measured step as ``launches_sharded_gang``,
each rank's of phase 32's jobs by job as ``launches_tp_gang``, of
phase 33's by job and part as ``launches_sp_gang`` and of phase 34's as
``launches_pod_gang``,
phase 31's K4 launch as ``launches_seq_parallel``, and phase 28's by cell as
``launches_perfprobe``, with each cell's profiled ms as
``perfprobe_profiled``), K1-K4's route
(``core_route``) and its numbers at the training shape (K2, K3),
granite's prefill shape (K1, with glm4's, codeqwen's and qwen3's beside
it; K1-K3 with hubert's, the non-causal hd-64 shape's, the two hd-80
edge shapes' and ``SP_SHAPES``'), mamba2's prefill shape (K4) or the 4-band Sentinel-2 tile
(K5, its launches in phase 13b as ``launches_vision_grid``; K1's in
phase 5g as ``launches_legacy``); the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

T_START = time.perf_counter()     # each emitted line's t_s counts from here
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CSRC = "src/repro_torch/kernels/flash_attention/csrc/"
TPU_KERNELS = "src/repro/kernels/flash_attention/kernel.py"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": (CSRC + "flash_fwd.cu", TPU_KERNELS + ":57"),
    "flash_attention_bwd_dq": (CSRC + "flash_bwd.cu", TPU_KERNELS + ":148"),
    "flash_attention_bwd_dkv": (CSRC + "flash_bwd.cu", TPU_KERNELS + ":179"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:24"),
    "percentile_norm": (
        "src/repro_torch/kernels/percentile_norm/csrc/percentile_norm.cu",
        "src/repro/kernels/percentile_norm/kernel.py:22"),
}

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# fsdp_sp's blocks on {model: 2} (phase 33): the second half's queries
# at q_offset 1024 against the 2048 gathered keys, hd 64 (stablelm's
# heads) and hd 80, causal and windowed, in phases 2 and 3 (both dtypes)
SP_SHAPES = [
    ("sp_offset_hd64", 4, 1024, 2048, 32, 32, 64, True, None, 1024),
    # the first block's (rank 0's) queries against the same keys: the
    # causal imbalance between the two ranks' K1-K3
    ("sp_first_block_hd64", 4, 1024, 2048, 32, 32, 64, True, None, 0),
    ("sp_offset_hd64_window", 4, 1024, 2048, 32, 8, 64, True, 512, 1024),
    ("sp_offset_hd80", 4, 1024, 2048, 16, 16, 80, True, None, 1024),
    ("sp_offset_hd80_window", 4, 1024, 2048, 16, 4, 80, True, 700, 1024),
]
# name, B, Sq, Sk, H, Kh, hd, causal, window[, q_offset]
SHAPES = [
    ("granite_prefill", 8, 2048, 2048, 32, 8, 64, True, None),
    ("ragged_s1000", 2, 1000, 1000, 32, 8, 64, True, None),
    ("window_512", 2, 2048, 2048, 32, 8, 64, True, 512),
    ("mha_hd128", 2, 1024, 1024, 16, 16, 128, True, None),
    ("glm4_prefill", 8, 2048, 2048, 32, 2, 128, True, None),
    ("codeqwen_prefill", 8, 2048, 2048, 32, 32, 128, True, None),
    ("qwen3_prefill", 8, 2048, 2048, 32, 4, 128, True, 8192),
    # hubert-xlarge's training shape: non-causal, 16 heads of 80 (two
    # 64-column boxes a row, the second 16 columns of data); hd 80 at its
    # edges, the causal diagonal with GQA 4 and ragged tiles past S 1000;
    # and the tensor-core route's non-causal branch at hd 64
    ("hubert_train", 8, 2048, 2048, 16, 16, 80, False, None),
    ("hd80_gqa_causal", 2, 2048, 2048, 16, 4, 80, True, None),
    ("hd80_ragged_s1000", 2, 1000, 1000, 16, 16, 80, False, None),
    ("noncausal_hd64", 2, 2048, 2048, 16, 16, 64, False, None),
] + SP_SHAPES
# kernel vs plain in the working dtype: f32 differs only by summation
# order; bf16 adds the output's rounding to bf16 (~4e-3 relative)
TOL = {"float32": {"o": 2e-5, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-4}}
# name, B, Sq, Sk, H, Kh, hd, causal, window[, q_offset]
BWD_SHAPES = [
    ("stablelm_train", 8, 2048, 2048, 32, 32, 64, True, None),
    ("granite_gqa", 8, 2048, 2048, 32, 8, 64, True, None),
    ("ragged_s1000", 2, 1000, 1000, 32, 8, 64, True, None),
    ("window_512", 2, 2048, 2048, 32, 8, 64, True, 512),
    ("mha_hd128", 2, 1024, 1024, 16, 16, 128, True, None),
    ("hubert_train", 8, 2048, 2048, 16, 16, 80, False, None),
    ("noncausal_hd64", 2, 2048, 2048, 16, 16, 64, False, None),
    # hd 80's tensor-core kernels at their edges: the diagonal skip and dK
    # / dV summed over a GQA group of 4, and ragged tiles past S 1000
    ("hd80_gqa_causal", 2, 2048, 2048, 16, 4, 80, True, None),
    ("hd80_ragged_s1000", 2, 1000, 1000, 16, 16, 80, False, None),
] + SP_SHAPES
# K2/K3 against the plain backward: both compute in f32 from the same
# inputs and return f32, so only the order of the f32 sums differs
BWD_TOL = 2e-4
# the whole op against autograd of plain attention: in bf16 the forward
# rounds P to bf16 before P V and the gradients are rounded to bf16
FN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TRAIN_STEPS, TRAIN_B, TRAIN_S = 8, 8, 2048
# mamba2-2.7b's measured training steps (phase 9d), after one warm-up
MAMBA_TRAIN_STEPS = 3
# name, Bs, S, nh, hp, g, N, Q, dtypes
SSD_SHAPES = [
    ("mamba2_prefill", 8, 2048, 80, 64, 1, 128, 256,
     ("bfloat16", "float32")),
    ("ragged_s1000", 2, 1000, 80, 64, 1, 128, 256, ("bfloat16",)),
    ("jamba_widths", 1, 1024, 128, 128, 8, 128, 256, ("bfloat16",)),
    # the one-period jamba's prefill (phase 9c): its batch and its 64 heads
    ("jamba_cut_prefill", 8, 2048, 64, 128, 8, 128, 256, ("bfloat16",)),
    ("jamba_cut_ragged_s1000", 2, 1000, 64, 128, 8, 128, 256,
     ("bfloat16",)),
    ("chunk64_s4096", 1, 4096, 80, 64, 1, 128, 64, ("bfloat16",)),
    # phase 28's mamba2-2.7b x prefill_32k cell: the probe's one-card cut
    ("mamba2_prefill_32k", 2, 32768, 80, 64, 1, 128, 256, ("bfloat16",)),
]
# K4 against the plain chunked scan, (atol, rtol).  Both compute in f32
# from the same inputs and differ by summation order, an error that scales
# with the size of the partial sums: atol is 3e-5 of the plain version's
# largest |value| (f32's 6e-8 over the ~400 terms of a row: 256 intra,
# 128 inter), rtol 1e-4.  A bf16 y is also rounded to bf16 (one ulp =
# 2**-8 relative): 2e-2 as for K1.  h_final is f32 in both.
SSD_TOL = {"float32": {"y": ("scaled", 3e-5, 1e-4),
                       "h": ("scaled", 3e-5, 1e-4)},
           "bfloat16": {"y": ("fixed", 2e-2, 2e-2),
                        "h": ("scaled", 3e-5, 1e-4)}}
S2_TILE = 10980 * 10980   # pixels of one Sentinel-2 L2A tile at 10 m
# name, R, C, dtype
PN_SHAPES = [
    ("s2_tile_4band", S2_TILE, 4, "float32"),
    ("s2_tile_13band", S2_TILE, 13, "float32"),
    ("over_2p31", 2 ** 29 + 1, 4, "float32"),
    ("ba_scene", 2048 * 2048, 4, "float32"),
    ("defo_composite", 256 * 256, 3, "float32"),
    ("ragged_r1000", 1000, 13, "float32"),
    ("one_band", 1000, 1, "float32"),
    ("s2_tile_4band_bf16", S2_TILE, 4, "bfloat16"),
]
# K5 against the plain stretch: the same f32 operations in the same order,
# so equal bit for bit; one f32 ulp at 1.0 is the most allowed
PN_TOL = 1.2e-7
# rows of the >2**31-element case compared (and timed plainly) at a time
PN_CHUNK = 2 ** 26
# the vision slice at full width (paper recipe: 256 chips, overlap 0.25,
# both classes at least 10%): parameters of each model at width 16 (the
# JAX package's counts) and the chips four 2048 x 2048 scenes give
SEG_PARAMS = {"unet": 487314, "unetpp": 558866, "deeplabv3": 474194,
              "deeplabv3plus": 557794, "changeformer": 324258}
BA_CHIPS = {"train": 87, "val": 19, "test": 0}
# a model's forward on the card against the CPU on the same weights, f32
# with TF32 off in both: summation order only
FWD_TOL = 1e-4


def _ssd_close(torch, got, want, tol):
    """assert_close under one SSD_TOL entry; returns the atol used."""
    kind, a, r = tol
    atol = a * want.abs().max().item() if kind == "scaled" else a
    torch.testing.assert_close(got, want, atol=atol, rtol=r)
    return atol


def emit(**rec):
    print(json.dumps({**rec, "t_s": time.perf_counter() - T_START}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_median(torch, fn, reps: int, repeats: int = 5):
    """The median over ``repeats`` of :func:`cuda_ms` (each the mean of
    ``reps`` calls), and the least and most of them: one window of a few
    launches can read several times high (K3 once read 4.7x its re-timed
    value)."""
    times = sorted(cuda_ms(torch, fn, reps) for _ in range(repeats))
    return times[len(times) // 2], [times[0], times[-1]]


def valid_pairs(sq: int, sk: int, causal: bool, window,
                q_offset: int = 0) -> int:
    """Number of (q, k) pairs the mask admits — the work this input needs
    (query row i at position q_offset + i)."""
    q = q_offset + np.arange(sq)
    hi = np.minimum(sk - 1, q) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def reached_keys(sq: int, sk: int, causal: bool, window,
                 q_offset: int = 0) -> int:
    """Number of keys at least one query's mask admits — the K/V rows the
    work must read (a block's causal queries reach no key past their
    last position, a window none before its first query's reach)."""
    q = q_offset + np.arange(sq)
    hi = np.minimum(sk - 1, q) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    live = hi >= lo
    seen = np.zeros(sk + 1, np.int64)
    np.add.at(seen, lo[live], 1)
    np.add.at(seen, hi[live] + 1, -1)
    return int((np.cumsum(seen)[:sk] > 0).sum())


def sdpa_bool_mask(ref, Sq: int, Sk: int, causal: bool, window,
                   q_offset: int = 0):
    """SDPA's boolean mask for K1-K3's (the plain version's
    ``attention_mask``): None where SDPA's own causal flag (top-left
    aligned) or no mask says the same, the window binding nowhere and no
    offset."""
    if (window is None or window >= Sk) and not q_offset:
        return None
    return ref.attention_mask(Sq, Sk, causal=causal, window=window,
                              device="cuda", q_offset=q_offset)


def least_ms(flops: float, nbytes: float, dtype: str):
    """The larger of operations over the dtype's peak and bytes over HBM
    bandwidth, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound(B, Sq, Sk, H, Kh, hd, causal, window, dtype: str, esize: int,
          q_offset: int = 0):
    """Least time (ms) for the forward: operations (QK^T and PV, 2 flops
    per multiply-add each) over the dtype's peak, or bytes (q read once,
    k and v once over the keys the mask reaches, o and the f32 LSE
    written once) over HBM bandwidth."""
    flops = 4 * hd * valid_pairs(Sq, Sk, causal, window, q_offset) * B * H
    Sr = reached_keys(Sq, Sk, causal, window, q_offset)
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sr * Kh * hd) * esize \
        + 4 * B * H * Sq
    return (*least_ms(flops, nbytes, dtype), flops)


def bwd_bounds(B, Sq, Sk, H, Kh, hd, causal, window, dtype: str,
               esize: int, q_offset: int = 0) -> dict:
    """Least times (ms) of the backward kernels.  Operations per admitted
    (q, k) pair: K2 6*hd (S = QK^T, dP = dO V^T, dS K), K3 8*hd (S, dP,
    P^T dO, dS^T Q), a fused single pass 10*hd (S and dP once).  Bytes:
    q and dO read once, k and v once over the keys the mask reaches, the
    f32 LSE and D read once, the f32 outputs (dK and dV over every key)
    written once."""
    pairs = valid_pairs(Sq, Sk, causal, window, q_offset) * B * H
    Sr = reached_keys(Sq, Sk, causal, window, q_offset)
    reads = (2 * B * Sq * H * hd + 2 * B * Sr * Kh * hd) * esize \
        + 2 * 4 * B * H * Sq
    dq_bytes, dkv_bytes = 4 * B * Sq * H * hd, 2 * 4 * B * Sk * Kh * hd
    out = {}
    for name, per_pair, nbytes in (
            ("dq", 6, reads + dq_bytes), ("dkv", 8, reads + dkv_bytes),
            ("fused", 10, reads + dq_bytes + dkv_bytes)):
        ms, by = least_ms(per_pair * hd * pairs, nbytes, dtype)
        out[name] = {"ms": ms, "by": by, "flops": per_pair * hd * pairs}
    return out


def ssd_bound(Bs, S, nh, hp, g, N, Q, dtype: str, esize: int):
    """Least time (ms) of the SSD scan.  Operations per (batch, chunk of Qc
    rows): 2 Qc(Qc+1)/2 N per group for C B^T, and per head 2 Qc(Qc+1)/2 hp
    (intra), 2 Qc N hp (inter) and 2 Qc N hp (state update); the peak is the
    inputs' dtype's.  Bytes: x, dt, A, B and C read once, y and the f32
    h_final written once."""
    chunks = [min(Q, S - c0) for c0 in range(0, S, Q)]
    flops = Bs * sum(g * qc * (qc + 1) * N
                     + nh * (qc * (qc + 1) * hp + 4 * qc * N * hp)
                     for qc in chunks)
    nbytes = (2 * Bs * S * nh * hp * esize + 4 * Bs * S * nh + 4 * nh
              + 2 * Bs * S * g * N * esize + 4 * Bs * nh * hp * N)
    return (*least_ms(flops, nbytes, dtype), flops, nbytes)


def ssd_vs_plain(torch, ssd, ssd_chunked_ref):
    """Phase 8: K4 against the plain chunked scan.  x, B and C are strided
    views of one buffer, as the mixer hands them over.  Each shape runs on
    its route (bf16 on the tensor cores, f32 on the CUDA cores), checked by
    the route counters, and two launches must be bitwise equal.  Returns
    the serving-shape bf16 record."""
    kernel = ssd.ssd_scan_kernel
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, Bs, S, nh, hp, g, N, Q, dtypes in SSD_SHAPES:
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            buf = torch.randn((Bs, S, nh * hp + 2 * g * N), generator=gen,
                              device="cuda").to(dtype)
            x = buf[..., :nh * hp].reshape(Bs, S, nh, hp)
            B = buf[..., nh * hp:nh * hp + g * N].reshape(Bs, S, g, N)
            C = buf[..., nh * hp + g * N:].reshape(Bs, S, g, N)
            dt = torch.nn.functional.softplus(torch.randn(
                (Bs, S, nh), generator=gen, device="cuda"))
            A = -torch.exp(0.3 * torch.randn(nh, generator=gen,
                                             device="cuda"))
            route = ssd.route(dtype, hp, N)
            want = ("tensor_core" if dtype_name == "bfloat16"
                    else "cuda_core")
            before = dict(kernel.launches_by_route)
            y, h = kernel(x, dt, A, B, C, chunk=Q)
            y2, h2 = kernel(x, dt, A, B, C, chunk=Q)
            torch.cuda.synchronize()
            took = {k: v - before[k]
                    for k, v in kernel.launches_by_route.items()}
            if route != want or took != {r: 2 * (r == want)
                                         for r in ssd.ROUTES}:
                raise AssertionError(f"K4 {name} {dtype_name}: route "
                                     f"{route}, launches {took}; want "
                                     f"{want}")
            bitwise = bool(torch.equal(y, y2) and torch.equal(h, h2))
            if not bitwise:
                raise AssertionError(f"K4 {name} {dtype_name}: two launches "
                                     f"differ")
            del y2, h2
            yr, hr = ssd_chunked_ref(x, dt, A, B, C, Q)
            err_y = (y.float() - yr.float()).abs().max().item()
            err_h = (h - hr).abs().max().item()
            tol = SSD_TOL[dtype_name]
            atol_y = _ssd_close(torch, y.float(), yr.float(), tol["y"])
            atol_h = _ssd_close(torch, h, hr, tol["h"])
            max_y, max_h = (yr.float().abs().max().item(),
                            hr.abs().max().item())
            del yr, hr
            torch.cuda.empty_cache()
            kernel_ms = cuda_ms(torch, lambda: kernel(
                x, dt, A, B, C, chunk=Q), reps=10)
            plain_ms = cuda_ms(torch, lambda: ssd_chunked_ref(
                x, dt, A, B, C, Q), reps=2)
            bound_ms, bound_by, flops, nbytes = ssd_bound(
                Bs, S, nh, hp, g, N, Q, dtype_name, x.element_size())
            rec = dict(phase="ssd_kernel_vs_plain", shape=name,
                       dims=[Bs, S, nh, hp, g, N, Q], dtype=dtype_name,
                       route=route, bitwise_repeat=bitwise,
                       max_abs_err_y=err_y, max_abs_err_h=err_h, tol=tol,
                       atol_y=atol_y, atol_h=atol_h, max_abs_y=max_y,
                       max_abs_h=max_h,
                       kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       flops=flops, bytes=nbytes,
                       kernel_tflops=flops / kernel_ms / 1e9)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del buf, x, B, C, dt, A, y, h
            torch.cuda.empty_cache()
    return records[("mamba2_prefill", "bfloat16")]


def ptxas_start(source: Path, out_dir: str):
    """Start nvcc on ``source`` with ``-Xptxas -v`` (the library build
    discards the compiler's output); :func:`ptxas_report` reads it."""
    from repro_torch.kernels.common import NVCC_FLAGS, _nvcc
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, Path(source).stem + ".so"), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(proc, entry: str) -> list:
    """Registers and spills ptxas reported for each entry whose name holds
    ``entry``."""
    log = proc.communicate(timeout=600)[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log}")
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and entry in ln:
            rest = lines[i + 1:i + 5]
            out.append({"entry": ln.split("'")[1],
                        "spill": next((r.strip() for r in rest
                                       if "spill" in r), None),
                        "used": next((r.split(":", 1)[1].strip()
                                      for r in rest if "Used" in r), None)})
    return out


def spills(rec: dict) -> bool:
    """Whether a :func:`ptxas_report` entry spills registers (its spill
    line reads "N bytes stack frame, N bytes spill stores, N bytes spill
    loads")."""
    found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      rec["spill"] or "")
    return found is None or found.groups() != ("0", "0")


def ssd_ptxas(report: list) -> list:
    """K4's tensor-core entry from :func:`ptxas_report`: one
    ``tc::ssd_scan_wgmma`` (a 64-column slab of any head dim), which must
    not spill."""
    if len(report) != 1:
        raise AssertionError(f"K4's tensor-core entries: {report}")
    if spills(report[0]):
        raise AssertionError(f"K4's tensor-core entry spills: {report}")
    return report


# the flash kernels' tensor-core entries (tc::<entry><HD>) by kernel
FLASH_WGMMA = {"flash_fwd_wgmma": "K1", "flash_bwd_dq_wgmma": "K2",
               "flash_bwd_dkv_wgmma": "K3"}


def flash_ptxas(report: list, kernels) -> list:
    """The tensor-core entries of ``kernels`` (of ``FLASH_WGMMA``'s names)
    by head dim, from :func:`ptxas_report`: one at each of hd 64, 80 and
    128 (K1: two, the constant and the run-time query offset's, ``Lb0``
    and ``Lb1`` in the mangled name), and the hd-80 ones must not
    spill."""
    out = []
    for rec in report:
        entry = next(e for e in FLASH_WGMMA if e + "ILi" in rec["entry"])
        hd = int(rec["entry"].split(entry + "ILi")[1].split("E")[0])
        out.append({"kernel": FLASH_WGMMA[entry], "hd": hd, **rec})
        if "Lb1E" in rec["entry"]:
            out[-1]["q_offset"] = "run-time"
    copies = {"K1": 2, "K2": 1, "K3": 1}
    if sorted((r["kernel"], r["hd"]) for r in out) != [
            (k, hd) for k in kernels for hd in (64, 80, 128)
            for _ in range(copies[k])]:
        raise AssertionError(f"the {kernels} tensor-core entries: {out}")
    bad = [r for r in out if r["hd"] == 80 and spills(r)]
    if bad:
        raise AssertionError(f"the hd-80 tensor-core entries spill: {bad}")
    return out


def kernel_vs_plain(torch, F, fa, ref):
    """Phase 2.  On the tensor cores two launches must be bitwise equal.
    Returns the records by (shape, dtype)."""
    fa_kernel = fa.flash_attention_fwd_kernel
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, B, Sq, Sk, H, Kh, hd, causal, window, *off in SHAPES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
            q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, Kh, hd), rnd(B, Sk, Kh, hd)
            off = off[0] if off else 0
            mask = dict(causal=causal, window=window, q_offset=off)
            route = fa.route(dtype, hd)
            n0 = fa_kernel.launches_by_route[route]
            out, lse = fa_kernel(q, k, v, **mask)
            torch.cuda.synchronize()
            if fa_kernel.launches_by_route[route] != n0 + 1:
                raise AssertionError(f"{name} {dtype_name}: K1 did not take "
                                     f"the {route} route")
            bitwise = None
            if route == "tensor_core":
                out2, lse2 = fa_kernel(q, k, v, **mask)
                bitwise = bool(torch.equal(out, out2)
                               and torch.equal(lse, lse2))
                del out2, lse2
                if not bitwise:
                    raise AssertionError(f"{name} {dtype_name}: two K1 "
                                         f"launches differ")
            ref_out, ref_lse = ref.attention_ref(q, k, v, **mask)
            err_o = (out.float() - ref_out.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            tol = TOL[dtype_name]
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=tol["o"], rtol=tol["o"])
            torch.testing.assert_close(lse, ref_lse, atol=tol["lse"],
                                       rtol=tol["lse"])
            del ref_out, ref_lse

            kernel_ms, kernel_spread = cuda_ms_median(
                torch, lambda: fa_kernel(q, k, v, **mask), reps=10)
            # the wrapper's host time per call (checks, outputs, tensor
            # maps, launch): back-to-back calls cannot beat it
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fa_kernel(q, k, v, **mask)
            host_ms = (time.perf_counter() - t0) * 100
            torch.cuda.synchronize()
            plain_ms = cuda_ms(torch, lambda: ref.attention_ref(q, k, v,
                                                                **mask),
                               reps=2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # the window binding nowhere and no offset: SDPA's causal flag,
            # else the same boolean mask
            sdpa_mask = sdpa_bool_mask(ref, Sq, Sk, **mask)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=sdpa_mask,
                is_causal=causal and sdpa_mask is None, enable_gqa=True)
            library_ms, library_spread = cuda_ms_median(torch, lib, reps=10)
            bound_ms, bound_by, flops = bound(B, Sq, Sk, H, Kh, hd, causal,
                                              window, dtype_name,
                                              q.element_size(), off)
            rec = dict(phase="kernel_vs_plain", shape=name,
                       dims=[B, Sq, Sk, H, Kh, hd], causal=causal,
                       window=window, q_offset=off, dtype=dtype_name,
                       route=route,
                       bitwise_repeat=bitwise,
                       max_abs_err_o=err_o, max_abs_err_lse=err_l,
                       tol=tol, kernel_ms=kernel_ms,
                       kernel_ms_min_max=kernel_spread, host_ms=host_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_ms_min_max=library_spread,
                       bound_ms=bound_ms, bound_by=bound_by,
                       kernel_tflops=flops / kernel_ms / 1e9,
                       share_of_bound=bound_ms / kernel_ms)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del q, k, v, out, lse
            torch.cuda.empty_cache()
    return records


def bwd_vs_plain(torch, F, fa, ref):
    """Phase 3: K2 and K3 against the plain backward.  Each shape runs on
    its route by K1's table (the tensor cores for bf16 at hd 64, 80 and
    128, else the CUDA cores), checked by the route counters, and
    two launches must be bitwise equal.  Returns the records by (shape,
    dtype)."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, B, Sq, Sk, H, Kh, hd, causal, window, *off in BWD_SHAPES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
            q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, Kh, hd), rnd(B, Sk, Kh, hd)
            do = rnd(B, Sq, H, hd)
            off = off[0] if off else 0
            mask = dict(causal=causal, window=window, q_offset=off)
            out, lse = fa.flash_attention_fwd_kernel(q, k, v, **mask)
            delta = ref.row_delta(out, do)
            route = fa.route(dtype, hd)
            want_route = ("tensor_core" if dtype_name == "bfloat16"
                          and hd in (64, 80, 128) else "cuda_core")
            kernels = (fa.flash_attention_bwd_dq_kernel,
                       fa.flash_attention_bwd_dkv_kernel)
            n0 = [dict(fn.launches_by_route) for fn in kernels]
            got = fa.flash_attention_bwd_kernel(q, k, v, do, lse, delta,
                                                **mask)
            again = fa.flash_attention_bwd_kernel(q, k, v, do, lse, delta,
                                                  **mask)
            torch.cuda.synchronize()
            took = [{r: fn.launches_by_route[r] - n[r] for r in n}
                    for fn, n in zip(kernels, n0)]
            if route != want_route or took != [
                    {r: 2 * (r == want_route) for r in fa.ROUTES}] * 2:
                raise AssertionError(f"{name} {dtype_name}: K2/K3 route "
                                     f"{route}, launches {took}; want "
                                     f"{want_route}")
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            if not bitwise:
                raise AssertionError(f"{name} {dtype_name}: two K2/K3 "
                                     f"launches differ")
            del again
            want = ref.attention_bwd_ref(q, k, v, out, lse, do, **mask)
            errs = {}
            for what, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[what] = (g - w).abs().max().item()
                torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)
            del got, want
            torch.cuda.empty_cache()

            dq_ms, dq_spread = cuda_ms_median(
                torch, lambda: fa.flash_attention_bwd_dq_kernel(
                    q, k, v, do, lse, delta, **mask), reps=5)
            dkv_ms, dkv_spread = cuda_ms_median(
                torch, lambda: fa.flash_attention_bwd_dkv_kernel(
                    q, k, v, do, lse, delta, **mask), reps=5)
            # each wrapper's host time per call (checks, outputs, tensor
            # maps, launch): back-to-back calls cannot beat it
            host_ms = {}
            for what, fn in zip(("dq", "dkv"), kernels):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn(q, k, v, do, lse, delta, **mask)
                host_ms[what] = (time.perf_counter() - t0) * 100
                torch.cuda.synchronize()
            plain_ms = cuda_ms(torch, lambda: ref.attention_bwd_ref(
                q, k, v, out, lse, do, **mask), reps=1)
            torch.cuda.empty_cache()
            # the library yardstick: the backward of SDPA through autograd
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            sdpa_mask = sdpa_bool_mask(ref, Sq, Sk, **mask)
            lo = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask,
                is_causal=causal and sdpa_mask is None, enable_gqa=True)
            dot = do.transpose(1, 2)
            library_ms, library_spread = cuda_ms_median(
                torch, lambda: torch.autograd.grad(
                    lo, (qt, kt, vt), dot, retain_graph=True), reps=5)
            del lo, qt, kt, vt
            b = bwd_bounds(B, Sq, Sk, H, Kh, hd, causal, window, dtype_name,
                           q.element_size(), off)
            rec = dict(phase="bwd_kernel_vs_plain", shape=name,
                       dims=[B, Sq, Sk, H, Kh, hd], causal=causal,
                       window=window, q_offset=off, dtype=dtype_name,
                       route=route,
                       bitwise_repeat=bitwise, max_abs_err=errs, tol=BWD_TOL,
                       dq_kernel_ms=dq_ms, dkv_kernel_ms=dkv_ms,
                       dq_ms_min_max=dq_spread, dkv_ms_min_max=dkv_spread,
                       host_ms=host_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_ms_min_max=library_spread,
                       dq_bound_ms=b["dq"]["ms"], dq_bound_by=b["dq"]["by"],
                       dkv_bound_ms=b["dkv"]["ms"],
                       dkv_bound_by=b["dkv"]["by"],
                       fused_bound_ms=b["fused"]["ms"],
                       dq_share_of_bound=b["dq"]["ms"] / dq_ms,
                       dkv_share_of_bound=b["dkv"]["ms"] / dkv_ms,
                       dq_tflops=b["dq"]["flops"] / dq_ms / 1e9,
                       dkv_tflops=b["dkv"]["flops"] / dkv_ms / 1e9)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del q, k, v, do, out, lse, delta
            torch.cuda.empty_cache()
    return records


# phase 3b: B, S, H, Kh, hd, causal, dtypes
FN_CASES = [
    (2, 1024, 32, 8, 64, True, ("float32", "bfloat16")),   # granite's heads
    # hubert's: K1, K2 and K3 on the tensor cores at hd 80
    (2, 1024, 16, 16, 80, False, ("bfloat16",)),
]


def function_vs_plain(torch, fa, flash_attention, naive_attention):
    """Phase 3b: the differentiable op (K1 -> K2 + K3) against autograd of
    plain attention, each call on its kernels' routes (checked by the
    route counters), at ``FN_CASES``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    kernels = (fa.flash_attention_fwd_kernel,
               fa.flash_attention_bwd_dq_kernel,
               fa.flash_attention_bwd_dkv_kernel)
    for B, S, H, Kh, hd, causal, dtypes in FN_CASES:
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
            q, k, v = (x.requires_grad_(True) for x in
                       (rnd(B, S, H, hd), rnd(B, S, Kh, hd),
                        rnd(B, S, Kh, hd)))
            do = rnd(B, S, H, hd)
            routes = [fa.route(dtype, hd)] * 3
            n0 = [dict(fn.launches_by_route) for fn in kernels]
            got = torch.autograd.grad(
                flash_attention(q, k, v, causal=causal), (q, k, v), do)
            torch.cuda.synchronize()
            took = [{r: fn.launches_by_route[r] - n[r] for r in n}
                    for fn, n in zip(kernels, n0)]
            if took != [{r: int(r == want) for r in fa.ROUTES}
                        for want in routes]:
                raise AssertionError(f"3b hd {hd} {dtype_name}: K1-K3 "
                                     f"launches {took}, want one each on "
                                     f"{routes}")
            want = torch.autograd.grad(
                naive_attention(q, k, v, causal=causal, window=None),
                (q, k, v), do)
            tol = FN_TOL[dtype_name]
            errs = {}
            for what, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[what] = (g.float() - w.float()).abs().max().item()
                torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                           rtol=tol)
            emit(phase="function_vs_plain_autograd",
                 dims=[B, S, S, H, Kh, hd], causal=causal, dtype=dtype_name,
                 routes=dict(zip(("K1", "K2", "K3"), routes)),
                 max_abs_err=errs, tol=tol)


class _Counts:
    """The launch counters of the kernels, zeroed and read around one
    path."""

    def __init__(self, fa, ssd, pn):
        self.fns = {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
                    "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
                    "flash_attention_bwd_dkv":
                        fa.flash_attention_bwd_dkv_kernel,
                    "ssd_scan": ssd.ssd_scan_kernel,
                    "percentile_norm": pn.percentile_norm_kernel}

    FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    ROUTED = FLASH + ("ssd_scan",)

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0
        for name in self.ROUTED:
            routes = self.fns[name].launches_by_route
            for key in routes:
                routes[key] = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}

    def routes(self, names=ROUTED) -> dict:
        """Launches by route since the last zero(), of K1 to K4 or of
        ``names``."""
        return {name: dict(self.fns[name].launches_by_route)
                for name in names}


def _param_count(tree) -> int:
    sizes = []
    _map(tree, lambda t: sizes.append(t.numel()))
    return sum(sizes)


def train_launches(cfg, steps: int) -> dict:
    """Launches ``steps`` training steps make: remat runs each layer's
    forward twice (the forward pass, then the recompute in the backward),
    so K1 and K4 launch twice per layer of their kind and step; K2 and K3
    once per attention layer; K4's backward is the plain scan (the
    reference's ``_ssd_bwd``), which launches nothing."""
    kinds = cfg.layer_kinds()
    na, ns = kinds.count("attn"), kinds.count("ssm")
    return {"flash_attention_fwd": 2 * na * steps,
            "flash_attention_bwd_dq": na * steps,
            "flash_attention_bwd_dkv": na * steps,
            "ssd_scan": 2 * ns * steps, "percentile_norm": 0}


def train_data(m, cfg, batch: int, seq: int):
    """The training stream ``train_main`` gives the config's family: the
    Markov token stream for the text families, the seeded patch / frame
    batches for the vlm and audio families."""
    if cfg.family in ("vlm", "audio"):
        return m["SeekableSyntheticBatches"](cfg, batch, seq, 0,
                                             device="cuda")
    return m["LMDictBatches"](cfg.vocab, batch, seq, 0, "cuda")


def flash_routes(torch, fa, head_dim: int) -> dict:
    """The route of K1, K2 and K3 (one table) for bf16 q/k/v of
    ``head_dim``, by counter name."""
    return dict.fromkeys(_Counts.FLASH, fa.route(torch.bfloat16, head_dim))


def train_full_width(torch, m, counts, arch: str = "stablelm-1.6b",
                     steps: int = TRAIN_STEPS, batch: int = TRAIN_B,
                     seq: int = TRAIN_S):
    """Phases 4 (stablelm-1.6b), 9d (mamba2-2.7b), 22 (hubert-xlarge) and
    23b (llava-next-mistral-7b): the full-width arch through TrainLoop on
    its family's data stream (:func:`train_data`).  K1 must take the
    route ``kernel.route`` gives the config's head dim in bf16, and K2 and
    K3 with it (the tensor cores at hd 64, 80 and 128), K4 the tensor
    cores.  Returns the launches on the path, the state and the
    data stream."""
    cfg = m["get_config"](arch)
    opt = m["get_optimizer"](cfg.optimizer)
    t0 = time.perf_counter()
    state = m["init_train_state"](
        torch.Generator(device="cuda").manual_seed(0), cfg, opt,
        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(state.params)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")
    total = 1 + steps
    step_fn = m["make_train_step"](
        cfg, opt, lr_schedule=m["warmup_cosine"](3e-4, total,
                                                 warmup_steps=2),
        remat=True)
    data = train_data(m, cfg, batch, seq)

    # one warm-up step (cuBLAS handles, allocator pools) outside the count
    warm = m["TrainLoop"](step_fn, state, data, log_every=0)
    warm.run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = m["TrainLoop"](step_fn, warm.state, data, log_every=1)
    counts.zero()
    t0 = time.perf_counter()
    res = loop.run(total)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    routes = counts.routes()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = train_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (remat runs "
                             f"each layer's forward twice a step)")
    route_of = flash_routes(torch, m["fa"], cfg.head_dim)
    want_routes = {name: {r: n * (r == route_of.get(name, "tensor_core"))
                          for r in ("tensor_core", "cuda_core")}
                   for name, n in want.items() if name in counts.ROUTED}
    if routes != want_routes:
        raise AssertionError(f"K1-K4 routes {routes}, want {want_routes}: "
                             f"K1-K3 on {route_of} at hd {cfg.head_dim}, K4 "
                             f"on the tensor cores")
    losses = loop.losses
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    tokens = batch * seq
    # model FLOPs: 6 N T for the weights the matmuls read (all but the
    # embedding table, which is gathered, or for audio not read at all;
    # a tied head reads it again), plus attention fwd + bwd at 12 hd per
    # (q, k) pair the mask admits (causal or not, windowed or not) and
    # head; the SSD scan is not counted
    n_mm = cfg.param_count() - cfg.vocab * cfg.d_model * (
        not cfg.tie_embeddings)
    attn = 12 * cfg.head_dim * cfg.n_heads * cfg.layer_kinds().count(
        "attn") * batch * valid_pairs(seq, seq, cfg.causal,
                                      cfg.sliding_window)
    flops = 6 * n_mm * tokens + attn
    step_s = wall / steps
    emit(phase="train_full_width", arch=cfg.name, params=n_params,
         init_s=init_s, batch=[batch, seq], steps=steps,
         losses=losses, wall_s=wall, step_s=step_s,
         steps_per_s=1 / step_s, tokens_per_s=tokens / step_s,
         model_flops_per_step=flops,
         mfu_vs_989_tflops=flops / step_s / PEAK_FLOPS["bfloat16"],
         mfu_formula="(6*N_mm*B*S + 12*hd*H*L_attn*B*pairs) / step_s"
                     " / 989e12, pairs = the (q, k) pairs the mask admits "
                     "(S(S+1)/2 causal, S^2 not), N_mm = N - vocab*d "
                     "(untied head) or N (tied); SSD scan not counted",
         peak_mem_gb=peak_gb, launches=launches, routes=routes,
         pure_step_s=res["pure_step_s"])

    # phase 4b: one step under the profiler
    one = data.next_batch()
    torch.cuda.synchronize()
    profiled = {}

    def one_step():
        profiled["state"] = step_fn(loop.state, one)[0]
    device_profile(torch, one_step, arch=cfg.name, what="train_step",
                   steps=1)
    return launches, profiled["state"], data


def train_grads_vs_f32(torch, m, params, data, arch: str = "stablelm-1.6b",
                       cfg=None):
    """Phases 4c (stablelm-1.6b), 9d' (mamba2-2.7b) and 22' (a depth cut
    of hubert-xlarge, ``cfg``): one (4, 2048) step's loss and gradients
    through the kernels (bf16) and through their plain versions (bf16),
    each against the plain path in f32 on the same weights.  The leaves
    ``unused_leaves`` marks (an SSD layer's norm2 where no FFN follows,
    the audio family's embedding table) get a zero gradient; every other
    leaf must reach the loss."""
    cfg = cfg or m["get_config"](arch)
    fields = [PREFILL_KERNELS[k][1] for k in prefill_launches(cfg)]
    full = data.next_batch()
    batch = {k: v[:4] for k, v in full.items()}
    tree_leaves, tree_unflatten = m["tree_leaves"], m["tree_unflatten"]
    unused = m["unused_leaves"](params, cfg)

    def value_and_grad(p, c):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        loss = m["train_loss"](tree_unflatten(p, leaves), c, batch)
        used = iter(torch.autograd.grad(
            loss, [t for t, u in zip(leaves, unused) if not u]))
        return loss.item(), [torch.zeros_like(t) if u else next(used)
                             for t, u in zip(leaves, unused)]

    p32 = m["cast_floating"](params, torch.float32)
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              **dict.fromkeys(fields, "torch"))
    t0 = time.perf_counter()
    l32, g32 = value_and_grad(p32, c32)
    f32_s = time.perf_counter() - t0
    del p32
    den = sum(float(g.double().square().sum()) for g in g32)
    out = {}
    for backend in ("cuda", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = value_and_grad(params, dataclasses.replace(
            cfg, **dict.fromkeys(fields, backend)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        num = sum(float((a.float() - b).double().square().sum())
                  for a, b in zip(g, g32))
        out[backend] = {"loss": loss, "loss_abs_err": abs(loss - l32),
                        "grad_rel_err": (num / den) ** 0.5, "step_s": secs}
        del g
        torch.cuda.empty_cache()
    del g32
    torch.cuda.empty_cache()
    emit(phase="train_grads_vs_f32", arch=cfg.name, layers=cfg.n_layers,
         batch=[4, TRAIN_S],
         loss_f32=l32,
         f32_step_s=f32_s, cuda_bf16=out["cuda"], torch_bf16=out["torch"])
    # a bf16 rounding of the loss (2**-9 of it) bounds the loss check
    # from below, so two tiny errors do not decide it
    c, t = out["cuda"], out["torch"]
    if (c["grad_rel_err"] > 2 * t["grad_rel_err"]
            or c["loss_abs_err"] > 2 * t["loss_abs_err"] + abs(l32) / 512):
        raise AssertionError(f"the kernel path strays from f32: {out}")


def ssd_bwd_memory(torch, m, cfg) -> dict:
    """Phase 9d'': what one SSD layer's backward adds to the memory in use
    at the training shape: K4's ``autograd.Function`` recomputes the
    forward through the plain chunked scan under autograd and
    differentiates it (the reference's ``_ssd_bwd``), so the plain scan's
    intermediates live through the backward of each layer in turn."""
    sc = cfg.ssm
    Bs, S = TRAIN_B, TRAIN_S
    nh, hp, g, N = sc.n_heads(cfg.d_model), sc.head_dim, sc.n_groups, \
        sc.d_state
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
            torch.bfloat16).requires_grad_(True)
    x, B, C = rnd(Bs, S, nh, hp), rnd(Bs, S, g, N), rnd(Bs, S, g, N)
    dt = torch.nn.functional.softplus(torch.randn(
        (Bs, S, nh), generator=gen, device="cuda")).requires_grad_(True)
    A = (-torch.exp(0.3 * torch.randn(nh, generator=gen, device="cuda"))
         ).requires_grad_(True)
    y, h = m["ssd_scan"](x, dt, A, B, C, chunk=sc.chunk, return_state=True,
                         backend="cuda")
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.autograd.backward((y, h), (dy, dh))
    torch.cuda.synchronize()
    out = dict(shape=[Bs, S, nh, hp, g, N, sc.chunk],
               backward_s=time.perf_counter() - t0,
               added_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    del x, B, C, dt, A, y, h, dy, dh
    torch.cuda.empty_cache()
    return out


def train_mamba2(torch, m, counts) -> int:
    """Phase 9d: full-width mamba2-2.7b trains through TrainLoop (AdamW,
    warmup-cosine, remat) at (8, 2048): K4 launches twice per layer and
    step, every launch on the tensor cores; what the plain backward's
    recompute adds to the memory; then one (4, 2048) step's loss and
    gradients through K4 and through the plain scan against f32.  Returns
    K4's launches."""
    arch = "mamba2-2.7b"
    launches, state, data = train_full_width(torch, m, counts, arch,
                                             steps=MAMBA_TRAIN_STEPS)
    params = state.params
    del state                                    # the optimizer's moments
    torch.cuda.empty_cache()
    emit(phase="ssd_backward_memory", arch=arch,
         **ssd_bwd_memory(torch, m, m["get_config"](arch)))
    train_grads_vs_f32(torch, m, params, data, arch)
    del params, data
    torch.cuda.empty_cache()
    return launches["ssd_scan"]


def train_cli_resume(torch, m, counts, precision: str = "f32"):
    """Phases 7 (f32) and 7b (bf16): the reduced train CLI, preempted and
    resumed, bitwise against an uninterrupted run, in deterministic mode.
    The reduced stablelm has hd 64 and f32 master weights: in f32 K1-K3
    take the CUDA-core route, in bf16 (q/k/v in bf16) the tensor cores,
    and every launch must."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(steps=12, log_every=0, device="cuda",
                      precision=precision)
            base = m["train_main"]("stablelm-1.6b", checkpoint_dir=os.path.join(
                tmp, "oracle"), checkpoint_async=False, **kw)
            ck = os.path.join(tmp, "ck")
            counts.zero()
            try:
                m["train_main"]("stablelm-1.6b", checkpoint_dir=ck,
                                checkpoint_every=2, preempt_at_step=3, **kw)
            except m["Preemption"]:
                pass
            else:
                raise AssertionError("preempt_at_step=3 did not preempt")
            res = m["train_main"]("stablelm-1.6b", checkpoint_dir=ck,
                                  checkpoint_every=2, resume=True, **kw)
            launches = counts.read()
            routes = counts.routes(counts.FLASH)
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            got, gstep = load(ls(ck)[-1][1])
            want, wstep = load(ls(os.path.join(tmp, "oracle"))[-1][1])
            same = (set(got) == set(want) and gstep == wstep == 12 and all(
                np.array_equal(got[k], want[k]) for k in want))
            if (res["resumed_from_step"] != 2
                    or res["losses"] != base["losses"][2:] or not same):
                raise AssertionError(
                    f"{precision}: resume is not bitwise: resumed from "
                    f"{res['resumed_from_step']}, losses {res['losses']} vs "
                    f"{base['losses'][2:]}, final arrays equal: {same}")
    finally:
        torch.use_deterministic_algorithms(False)
    route = "tensor_core" if precision == "bf16" else "cuda_core"
    if any(r[route] != launches[name] or launches[name] == 0
           for name, r in routes.items()):
        raise AssertionError(f"{precision}: K1-K3 routes {routes} (launches "
                             f"{launches}): every launch must take {route}")
    emit(phase="train_main_reduced_resume", precision=precision,
         arch=res["arch"], resumed_from_step=res["resumed_from_step"],
         final_loss=res["final_loss"], losses_equal=True,
         final_checkpoint_bitwise=True, launches=launches, routes=routes,
         steps_per_s=res["steps_per_s"])


def prefill_batch(torch, prompts, S):
    """Right-padded (len(prompts), S) token batch and its lengths, on the
    card."""
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    return ({"tokens": torch.from_numpy(toks).cuda()},
            torch.from_numpy(lens).cuda())


def jamba_one_period(get_config):
    """jamba-1.5-large-398b cut to one period of 8 layers (7 SSD, 1
    attention at slot 4, MoE on the odd ones) and to d_model 4096 with 32
    q / 4 kv heads of 128 and 16 experts top-2 of ff 6144 (d_ff 6144):
    ~6.47 B parameters, ~13 GB in bf16.  The SSD shape (64 heads of 128,
    g 8, N 128, chunk 256, expand 2 over the cut d_model) and the vocab
    (65 536) are the full config's."""
    full = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        full, name=full.name + "-1period", n_layers=8, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=6144,
        moe=dataclasses.replace(full.moe, expert_d_ff=6144))


# prefill kernel -> (the engine's stat for it, the config field that picks
# it or its plain version, the mixer kind whose layers launch it)
PREFILL_KERNELS = {
    "flash_attention_fwd": ("flash_attention_launches", "attention_backend",
                            "attn"),
    "ssd_scan": ("ssd_scan_launches", "mixer_backend", "ssm")}
# rows of the prefill logit gate, where 8 do not fit beside the f32
# yardstick: codeqwen's f32 weights (32.8 GB) beside its bf16 ones (16.4)
# and the f32 prefill's KV caches (MHA: 17.2 GB at 8 rows, twice that
# while the layers' caches are stacked) would pass the card's 80 GB
GATE_ROWS = {"codeqwen1.5-7b": 4}
# layers of the logit gate's depth cut, where the f32 yardstick of the full
# depth does not fit: qwen3-moe's f32 weights are 122 GB.  The cut keeps
# every width and runs after the full model is freed.
GATE_LAYERS = {"qwen3-moe-30b-a3b": 4}


def prefill_launches(cfg) -> dict:
    """Launches one prefill call makes of each prefill kernel: one per
    layer of the kernel's mixer kind."""
    kinds = cfg.layer_kinds()
    return {k: kinds.count(kind) for k, (_, _, kind) in PREFILL_KERNELS.items()
            if kind in kinds}


def _check_prefill_launches(cfg, launches: dict, routes: dict,
                            prefill_calls: int, route: str, what: str,
                            stats=None):
    """Each prefill kernel launched (its layers) x prefill calls times,
    every launch on ``route``, no other kernel launched, and the engine's
    stats (``stats``) agreeing."""
    want = {k: n * prefill_calls for k, n in prefill_launches(cfg).items()}
    got = {k: v for k, v in launches.items() if v}
    bad = (got != want or prefill_calls == 0
           or any(routes[k] != {r: n * (r == route)
                                for r in ("tensor_core", "cuda_core")}
                  for k, n in want.items())
           or (stats is not None and any(
               stats[PREFILL_KERNELS[k][0]] != n for k, n in want.items())))
    if bad:
        raise AssertionError(f"{what}: launches {launches} (want {want} on "
                             f"{route} over {prefill_calls} prefill calls), "
                             f"routes {routes}")
    return want


def serve_prompts(cfg) -> list:
    """The 16 prompts of 16-1500 tokens the full-width serve phases take."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=int(n))
            for n in rng.integers(16, 1501, size=16)]


def serve_full_width(torch, m, counts, cfg):
    """Phases 5, 5c, 5f, 9 and 9c: a full-width config through the engine.
    Returns the prefill kernels' launches over the engine's run, the
    params and the prompts."""
    ServeEngine, Request = m["ServeEngine"], m["Request"]
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")

    prompts = serve_prompts(cfg)

    # warm-up: cuBLAS handles and allocator pools, outside the timed run
    warm = ServeEngine(cfg, params, slots=8, cache_len=2048, device="cuda")
    warm.submit(Request(rid=-1, prompt=prompts[0][:16], max_tokens=2))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    engine = ServeEngine(cfg, params, slots=8, cache_len=2048,
                         device="cuda")
    reqs = [Request(rid=i, prompt=p, max_tokens=32)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    counts.zero()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    routes = counts.routes()

    s = engine.stats()
    del engine, done                     # the decode state, before the gate
    torch.cuda.empty_cache()
    if s["completed"] != 16 or any(len(r.generated) != 32 for r in reqs):
        raise AssertionError(f"not every request completed with 32 tokens: "
                             f"{[len(r.generated) for r in reqs]}")
    want = _check_prefill_launches(cfg, launches, routes, s["prefill_calls"],
                                   "tensor_core", cfg.name, stats=s)
    tokens = sum(len(r.generated) for r in reqs)
    emit(phase="serve_full_width", arch=cfg.name, params=n_params,
         init_s=init_s, mem_in_use_before_gb=mem_before / 1e9,
         requests=s["completed"], tokens=tokens, wall_s=wall,
         tokens_per_s=tokens / wall,
         prompt_tokens=int(sum(len(p) for p in prompts)),
         prefill_calls=s["prefill_calls"], decode_steps=s["decode_steps"],
         launches=launches, routes={k: routes[k] for k in want},
         ttft_p50_s=s["ttft_p50_s"], ttft_p99_s=s["ttft_p99_s"],
         tpot_p50_s=s["tpot_p50_s"], tpot_p99_s=s["tpot_p99_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return want, params, prompts


def _rel(x, y) -> float:
    return ((x - y).norm() / y.norm()).item()


def _state_rel(state, ref) -> float:
    """The relative error of a decode state (every KV cache, SSM and conv
    state, taken as one vector) against ``ref``'s, a tensor at a time."""
    num = sum((state[k].float() - ref[k].float()).square().sum().item()
              for k in ref)
    den = sum(ref[k].float().square().sum().item() for k in ref)
    return (num / den) ** 0.5


class _PickHook:
    """Patches ``moe._local_top_k`` for one run: records each MoE layer's
    (T, K) expert ids in layer order, or with ``replay`` (such a list)
    picks those experts, with the gates this run's router gives them."""

    def __init__(self, MOE, replay=None):
        self.MOE, self.replay, self.picks = MOE, replay, []

    def __enter__(self):
        self.orig = self.MOE._local_top_k

        def top_k(x, k):
            if self.replay is None:
                v, i = self.orig(x, k)
            else:
                i = self.replay[len(self.picks)]
                v = x.gather(-1, i)
            self.picks.append(i)
            return v, i
        self.MOE._local_top_k = top_k
        return self

    def __exit__(self, *exc):
        self.MOE._local_top_k = self.orig


def routing_witness(torch, m, cfg, prefill, p32, c32, batch, lens_d,
                    picks: dict, logits, state, ref, ref_st):
    """Phases 5f'' and 9c'': how much of the bf16 kernel path's distance
    from f32 the MoE's routing makes.  Per MoE layer, the share of real
    tokens whose top-k experts (as a set) differ between the kernel path
    and f32; then the f32 prefill once more with the kernel path's experts
    (the gates its own router gives them), and the kernel path's logits
    and state against that and against f32's own routing."""
    with _PickHook(m["moe"], replay=picks["cuda"]):
        same, same_st = prefill(p32, c32, batch, 2048, lengths=lens_d)
    S = batch["tokens"].shape[1]
    real = (torch.arange(S, device="cuda")[None, :]
            < lens_d[:, None]).reshape(-1)
    flips = [(((a.sort(-1).values != b.sort(-1).values).any(-1) & real)
              .sum() / real.sum()).item()
             for a, b in zip(picks["cuda"], picks["f32"])]
    rec = dict(phase="moe_routing_witness", arch=cfg.name,
               layers=cfg.n_layers, moe_layers=len(flips),
               token_flip_share_by_moe_layer=flips,
               rel_err_cuda_bf16_vs_f32=_rel(logits, ref),
               rel_err_cuda_bf16_vs_f32_same_experts=_rel(logits, same),
               rel_err_f32_same_experts_vs_f32=_rel(same, ref),
               state_rel_err_cuda_bf16_vs_f32=_state_rel(state, ref_st),
               state_rel_err_cuda_bf16_vs_f32_same_experts=_state_rel(
                   state, same_st))
    emit(**rec)
    return rec


def prefill_gate(torch, m, cfg, params, batch, lens_d,
                 judge_state: bool = False):
    """One (rows, 2048) prefill ``batch`` (right-padded to ``lens_d``)
    through the kernels and through their plain versions, both in bf16,
    each held against the plain path in f32 on the same weights.  The kernel path may be no more than twice as far
    from f32 as the plain bf16 path (K1 rounds P to bf16 before P V, as
    the TPU kernel).  Without MoE that is judged on the last-token logits.
    With MoE it is judged on the decode state the prefill writes (every
    layer's KV cache and SSM state at every real position): a bf16
    rounding flips a near-tied top-k choice now and then, in either path,
    and over a few last tokens such flips decide the logits' error by
    chance, where over every position of every layer they average out.
    The logits' errors are reported either way, and with MoE the
    routing witness (:func:`routing_witness`).  ``judge_state`` judges a
    config without MoE on its decode state as well (the vlm's)."""
    prefill = m["prefill"]
    fields = [PREFILL_KERNELS[k][1] for k in prefill_launches(cfg)]
    judged = "state" if cfg.moe is not None or judge_state else "logits"
    B, S = lens_d.shape[0], 2048
    torch.cuda.reset_peak_memory_stats()
    logits, states, times, picks = {}, {}, {}, {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, **dict.fromkeys(fields, backend))
        run = lambda: prefill(params, c, batch, 2048,  # noqa: E731
                              lengths=lens_d)
        times[backend] = cuda_ms(torch, run, reps=2)
        with _PickHook(m["moe"]) as hook:
            out, st = run()
        picks[backend] = hook.picks
        logits[backend] = out.float()
        if judged == "state":
            states[backend] = st
        del out, st
        torch.cuda.empty_cache()
    p32 = _map(params, lambda t: t.float())
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              **dict.fromkeys(fields, "torch"))
    with _PickHook(m["moe"]) as hook:
        ref, ref_st = prefill(p32, c32, batch, 2048, lengths=lens_d)
    picks["f32"] = hook.picks
    if cfg.moe is not None:
        routing_witness(torch, m, cfg, prefill, p32, c32, batch, lens_d,
                        picks, logits["cuda"], states["cuda"], ref, ref_st)
    del p32, picks
    st_rel = {b: _state_rel(st, ref_st) for b, st in states.items()}
    del ref_st, states
    torch.cuda.empty_cache()

    a, b = logits["cuda"], logits["torch"]
    rel_cuda, rel_torch = _rel(a, ref), _rel(b, ref)
    max_abs = (a - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    arg_ref = top2.indices[:, 0]
    # a differing argmax is a fault only where the f32 top-2 margin
    # exceeds twice the kernel path's largest logit error
    faults = ((a.argmax(-1) != arg_ref) & (margin > 2 * max_abs)).sum().item()
    emit(phase="prefill_cuda_vs_torch", arch=cfg.name, layers=cfg.n_layers,
         batch=[B, S], kernels=sorted(prefill_launches(cfg)),
         prefill_ms_cuda=times["cuda"], prefill_ms_torch=times["torch"],
         rel_err_cuda_bf16_vs_f32=rel_cuda,
         rel_err_torch_bf16_vs_f32=rel_torch,
         rel_err_cuda_vs_torch=_rel(a, b), max_abs_err_cuda_vs_f32=max_abs,
         state_rel_err_cuda_bf16_vs_f32=st_rel.get("cuda"),
         state_rel_err_torch_bf16_vs_f32=st_rel.get("torch"),
         argmax_agree_cuda_f32=int((a.argmax(-1) == arg_ref).sum().item()),
         argmax_agree_torch_f32=int((b.argmax(-1) == arg_ref).sum().item()),
         rows=B, argmax_faults=faults, judged_on=judged,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    ours, plain = ((st_rel["cuda"], st_rel["torch"]) if judged == "state"
                   else (rel_cuda, rel_torch))
    if ours > 2 * plain or faults:
        raise AssertionError(f"{cfg.name}: prefill through the kernels "
                             f"strays from f32 ({judged}): rel {ours} vs "
                             f"plain {plain}, faults {faults}")


def moe_breakdown(torch, m, cfg, params, prompts):
    """Phase 5f': where an MoE layer's time goes, by stage (routing, the
    dispatch scatter, the experts' batched matmuls, the combine gather),
    timed with CUDA events on the first MoE layer's weights at the
    prefill's (8, 2048) tokens and at a decode step's 8, against the bytes
    bound of reading every expert's weights (what a capacity-based step
    does)."""
    MOE = m["moe"]
    layer = next(l for l in params["layers"] if "moe" in l)
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    batch, lens_d = prefill_batch(torch, prompts[:8], 2048)
    # the prompts' embeddings at unit RMS, the scale the router sees
    e = params["embed"]["w"][batch["tokens"].long()].float()
    x = (e * torch.rsqrt(e.square().mean(-1, keepdim=True) + 1e-6)).to(
        layer["moe"]["up"].dtype)
    del e
    mask = (torch.arange(2048, device="cuda")[None, :] < lens_d[:, None])
    wbytes = sum(layer["moe"][k].numel() * layer["moe"][k].element_size()
                 for k in ("up", "gate", "down"))
    out = {}
    for what, xs, tm in (("prefill", x, mask), ("decode", x[:, :1], None)):
        T = xs.shape[0] * xs.shape[1]
        cap = MOE.capacity_of(T, mc)
        xt = xs.reshape(T, -1)
        with torch.no_grad():
            r = MOE.route(layer["moe"], xt, mc, cap, tm)
            buf = MOE.dispatch(xt, r, E, K, cap)
            ob = MOE.expert_ffn(layer["moe"], buf, cfg.act)
            stages = {
                "route": lambda: MOE.route(layer["moe"], xt, mc, cap, tm),
                "dispatch": lambda: MOE.dispatch(xt, r, E, K, cap),
                "experts": lambda: MOE.expert_ffn(layer["moe"], buf,
                                                  cfg.act),
                "combine": lambda: MOE.combine(ob, r, tm is not None),
                "moe_apply": lambda: MOE.moe_apply(layer["moe"], xs, mc,
                                                   cfg.act, token_mask=tm)}
            ms = {k: cuda_ms(torch, f, reps=5) for k, f in stages.items()}
        kept = int((r["keep"] & (r["e"] < E)).sum().item())
        routed = int((r["e"] < E).sum().item())
        out[what] = dict(tokens=T, capacity=cap, routed=routed, kept=kept,
                         stage_ms=ms,
                         experts_bytes_bound_ms=wbytes / PEAK_BYTES * 1e3)
        del r, buf, ob
    emit(phase="moe_breakdown", arch=cfg.name, experts=E, top_k=K,
         expert_weight_gb_per_layer=wbytes / 1e9,
         expert_weight_gb_all_layers=wbytes * sum(cfg.moe_layer_mask()) / 1e9,
         **out)
    torch.cuda.empty_cache()


def serve_path(torch, m, counts, arch: str, cfg=None,
               cli: bool = True) -> dict:
    """Phases 5-6 (granite), 5c (glm4, codeqwen; ``cli=False``), 5f
    (qwen3-moe), 9 (mamba2) and 9c (the one-period jamba, ``cfg``): the
    config at full width through the engine, its profile (and an MoE
    config's stage breakdown), the prefill logit gate, then the reduced
    serve CLI on the card, every launch on the CUDA-core route (f32).
    Returns the prefill kernels' launches over the full-width engine
    run."""
    cfg = cfg or m["get_config"](arch)
    launches, params, prompts = serve_full_width(torch, m, counts, cfg)
    profile_steps(torch, cfg, params, prompts, m["prefill"],
                  m["decode_step"])
    if cfg.moe is not None:
        moe_breakdown(torch, m, cfg, params, prompts)
    if arch in GATE_LAYERS:
        del params
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=GATE_LAYERS[arch])
        params = m["init_params"](
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    prefill_gate(torch, m, cfg, params, *prefill_batch(
        torch, prompts[:GATE_ROWS.get(arch, 8)], 2048))
    del params
    torch.cuda.empty_cache()
    if not cli:
        return launches

    counts.zero()
    out = m["serve_main"](arch)
    rcfg = m["get_reduced"](arch)
    _check_prefill_launches(rcfg, counts.read(), counts.routes(),
                            out["prefill_calls"], "cuda_core",
                            "serve_main " + arch, stats=out)
    if out["requests"] != 16:
        raise AssertionError(f"serve_main: {out}")
    emit(phase="serve_main_reduced", launches=counts.read(),
         routes={k: counts.routes()[k] for k in prefill_launches(rcfg)},
         **out)
    return launches


# phase 5g: the legacy engine on the first LEGACY_REQUESTS of phase 5's
# prompts, LEGACY_TOKENS new tokens each, a slot a request
LEGACY_REQUESTS, LEGACY_TOKENS = 4, 16


def _drain(torch, engine, requests) -> float:
    """Submit ``requests``, run ``engine`` to the end; the wall seconds."""
    for r in requests:
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def legacy_full_width(torch, m, counts, arch: str) -> int:
    """Phase 5g (a): ``LegacyServeEngine`` on phase 5's full-width config,
    weights and prompts (bf16): one prefill a request at its own length,
    K1 launched once a layer a request, all on the tensor cores (gated);
    beside it ``ServeEngine`` on the same requests and slots: both walls
    and tokens/s, and the share of tokens the two engines give alike
    (printed: bf16 prefills of other shapes may flip a near tie).
    Returns K1's launches."""
    cfg = m["get_config"](arch)
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    prompts = serve_prompts(cfg)
    reqs = {name: [m["Request"](rid=i, prompt=p, max_tokens=LEGACY_TOKENS)
                   for i, p in enumerate(prompts[:LEGACY_REQUESTS])]
            for name in ("legacy", "engine")}
    kw = dict(slots=LEGACY_REQUESTS, cache_len=2048, device="cuda")
    counts.zero()
    legacy_s = _drain(torch, m["LegacyServeEngine"](cfg, params, **kw),
                      reqs["legacy"])
    launches, routes = counts.read(), counts.routes()
    engine_s = _drain(torch, m["ServeEngine"](cfg, params, **kw),
                      reqs["engine"])
    del params
    torch.cuda.empty_cache()
    want = cfg.layer_kinds().count("attn") * LEGACY_REQUESTS
    others = {k: v for k, v in launches.items()
              if k != "flash_attention_fwd" and v}
    if (launches["flash_attention_fwd"] != want or others
            or routes["flash_attention_fwd"] != {"tensor_core": want,
                                                  "cuda_core": 0}):
        raise AssertionError(f"legacy engine: launches {launches}, routes "
                             f"{routes}, want K1 {want} on the tensor cores")
    got = [r.generated for r in reqs["legacy"]]
    ref = [r.generated for r in reqs["engine"]]
    if any(len(g) != LEGACY_TOKENS for g in got + ref):
        raise AssertionError(f"legacy engine: tokens {got} / {ref}")
    alike = sum(a == b for x, y in zip(got, ref) for a, b in zip(x, y))
    tokens = LEGACY_REQUESTS * LEGACY_TOKENS
    emit(phase="legacy_engine_full_width", arch=cfg.name,
         requests=LEGACY_REQUESTS, new_tokens=LEGACY_TOKENS,
         prompt_tokens=[len(p) for p in prompts[:LEGACY_REQUESTS]],
         launches=launches, routes=routes["flash_attention_fwd"],
         legacy_wall_s=legacy_s, legacy_tokens_per_s=tokens / legacy_s,
         engine_wall_s=engine_s, engine_tokens_per_s=tokens / engine_s,
         tokens_alike=alike, tokens=tokens, share_alike=alike / tokens)
    return launches["flash_attention_fwd"]


def legacy_reduced(torch, m, counts, arch: str) -> None:
    """Phase 5g (b): the reduced config in f32 on the card, the reference's
    equivalence case (``tests/test_serve.py``: 7 requests of 4-11 tokens,
    3 slots, a cache of 64, 8 new tokens): ``LegacyServeEngine``'s
    greedy tokens equal ``ServeEngine``'s, every one (gated)."""
    cfg = m["get_reduced"](arch)
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12)))
               for _ in range(7)]
    out, walls, k1 = {}, {}, {}
    for name in ("LegacyServeEngine", "ServeEngine"):
        reqs = [m["Request"](rid=i, prompt=p, max_tokens=8)
                for i, p in enumerate(prompts)]
        counts.zero()
        walls[name] = _drain(torch, m[name](cfg, params, slots=3,
                                            cache_len=64, device="cuda"),
                             reqs)
        out[name] = [list(r.generated) for r in reqs]
        k1[name] = counts.read()["flash_attention_fwd"]
    emit(phase="legacy_engine_reduced", arch=cfg.name, requests=7,
         tokens=out["LegacyServeEngine"], wall_s=walls, k1_launches=k1,
         equal=out["LegacyServeEngine"] == out["ServeEngine"])
    if out["LegacyServeEngine"] != out["ServeEngine"]:
        raise AssertionError(f"legacy engine, reduced f32: {out}")


# phase 5d: granite at full width under live traffic (a Poisson trace at
# about the closed batch's completion rate, 16 x 32 tokens in ~8 s) with a
# KV pool of 384 blocks of 16 (37.5% of the 1024 that cover 8 slots of
# 2048), so that evictions happen, and a 5 s TTFT SLO
LIVE = dict(n=32, rate=2.0, plen=(16, 1500), max_tokens=32, slots=8,
            cache_len=2048, pools=(384, 256), block=16, slo_ms=5000.0)
# phase 5e (a) serves the first 16 of those 32 prompts at once, two waves
# of the 8 slots, to keep the script's time down
AT_ONCE = 16


def _live_trace(m, vocab: int, rate: float):
    return m["poisson_trace"](vocab, LIVE["n"], rate, seed=0,
                              plen_range=LIVE["plen"],
                              max_tokens=LIVE["max_tokens"])


def _submit_now(sched, trace):
    """Submit a trace on the scheduler's real clock, starting now."""
    t0 = sched.clock.now()
    sched.submit_trace([(t0 + t, r) for t, r in trace])
    return t0


def serve_continuous_full_width(torch, m, counts):
    """Phase 5d: full-width granite-3-2b (bf16) through ``ServeScheduler``
    on the real clock: an open-loop Poisson trace, SLO shedding and an
    oversubscribed paged-KV pool.  Returns the K1 launches, the params and
    the requests, and each request's eviction count."""
    cfg = m["get_config"]("granite-3-2b")
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    L = LIVE
    for pool in L["pools"]:
        trace = _live_trace(m, cfg.vocab, L["rate"])
        sched = m["ServeScheduler"](
            cfg, params, slots=L["slots"], cache_len=L["cache_len"],
            max_kv_blocks=pool, kv_block_size=L["block"],
            slo_deadline_ms=L["slo_ms"], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.zero()
        t0 = _submit_now(sched, trace)
        sched.run()
        torch.cuda.synchronize()
        wall = sched.clock.now() - t0
        launches, routes = counts.read(), counts.routes()
        s = sched.stats()
        if s["evictions"]:
            break
        emit(phase="serve_continuous_no_eviction", pool_blocks=pool,
             peak_blocks=s["kv"]["peak_blocks_in_use"],
             why="the trace never held more blocks than the pool; "
                 "tightening it")
    reqs = [r for _, r in trace]
    _check_prefill_launches(cfg, launches, routes, s["prefill_calls"],
                            "tensor_core", "serve_continuous_full_width")
    kv = s["kv"]
    short = [r.rid for r in sched.completed
             if len(r.generated) != L["max_tokens"]
             and len(r.prompt) + len(r.generated) < L["cache_len"] - 1]
    if (s["completed"] + s["shed"] != L["n"] or kv["used_blocks"]
            or kv["peak_blocks_in_use"] > kv["total_blocks"]
            or not s["evictions"] or short):
        raise AssertionError(f"serve_continuous_full_width: {s}; short "
                             f"requests {short}")
    tokens = sum(len(r.generated) for r in sched.completed)
    slo_tokens = sum(len(r.generated) for r in sched.completed
                     if r.met_deadline())
    emit(phase="serve_continuous_full_width", arch=cfg.name,
         trace="poisson", requests=L["n"], rate_qps=L["rate"],
         slots=L["slots"], cache_len=L["cache_len"],
         kv_pool=[kv["total_blocks"], kv["block_size"]],
         slo_deadline_ms=L["slo_ms"], completed=s["completed"],
         shed=s["shed"], slo_met=s["slo_met"], evictions=s["evictions"],
         failed_grows=kv["failed_grows"],
         peak_blocks_in_use=kv["peak_blocks_in_use"], tokens=tokens,
         wall_s=wall, tokens_per_s=tokens / wall,
         goodput_req_s=s["slo_met"] / wall, goodput_tok_s=slo_tokens / wall,
         prompt_tokens=int(sum(len(r.prompt) for r in reqs)),
         prefill_calls=s["prefill_calls"], decode_steps=s["decode_steps"],
         launches=launches, routes=routes["flash_attention_fwd"],
         **{k: s[k] for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                              "tpot_p99_s", "queue_wait_p50_s",
                              "queue_wait_p99_s")},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    n = launches["flash_attention_fwd"]
    del sched
    torch.cuda.empty_cache()

    # phase 5d': the scheduler's decode ticks (admission, KV growth, the
    # decode step) with 8 requests running, under the profiler
    prof = m["ServeScheduler"](cfg, params, slots=L["slots"],
                               cache_len=L["cache_len"], device="cuda")
    for r in reqs[:L["slots"]]:
        prof.submit(m["Request"](rid=r.rid, prompt=r.prompt,
                                 max_tokens=L["max_tokens"]))
    prof.step()

    def ticks():
        for _ in range(8):
            prof.step()
    device_profile(torch, ticks, arch=cfg.name, what="scheduler_decode",
                   steps=8)
    del prof
    torch.cuda.empty_cache()
    return n, params, reqs


def scheduler_token_identity(torch, m, counts, params, live_reqs):
    """Phase 5e.  (a) Full-width granite in bf16: the first ``AT_ONCE`` of
    the live trace's prompts arriving at once through the scheduler
    (default pool) and through the plain engine give the same greedy
    tokens and the same prefill batches.  Then, not gated, phase 5d's
    evicted requests against the same prompts served unevicted by the
    engine: re-prefilling prompt + generated through K1 rounds differently
    in bf16 from the incremental decode, so a near tie may flip an argmax.
    (b) The reduced granite in f32 on the card: an oversubscribed pool (8
    blocks of 8, 3 slots of 64) evicts, and the tokens equal an
    unconstrained run's."""
    cfg = m["get_config"]("granite-3-2b")
    L = LIVE
    trace = _live_trace(m, cfg.vocab, 1e6)
    if any(not np.array_equal(r.prompt, w.prompt)
           for (_, r), w in zip(trace, live_reqs)):
        raise AssertionError("the trace's prompts depend on its rate")
    trace = trace[:AT_ONCE]
    sched = m["ServeScheduler"](cfg, params, slots=L["slots"],
                                cache_len=L["cache_len"], device="cuda")
    engine = m["ServeEngine"](cfg, params, slots=L["slots"],
                              cache_len=L["cache_len"], device="cuda")
    for _, r in trace:
        engine.submit(m["Request"](rid=r.rid, prompt=r.prompt,
                                   max_tokens=r.max_tokens))
    counts.zero()
    t0 = _submit_now(sched, trace)
    sched.clock.sleep_until(t0 + trace[-1][0])    # all have arrived
    sched.run()
    engine.run()
    launches, routes = counts.read(), counts.routes()
    calls = sched.stats["prefill_calls"] + engine.stats["prefill_calls"]
    _check_prefill_launches(cfg, launches, routes, calls, "tensor_core",
                            "token identity (a)")
    got = {r.rid: r.generated for r in sched.completed}
    want = {r.rid: r.generated for r in engine.completed}
    if (got != want or len(got) != AT_ONCE
            or sched.stats["prefill_calls"] != engine.stats["prefill_calls"]
            or sched.stats["evictions"]):
        differ = sum(got.get(k) != v for k, v in want.items())
        raise AssertionError(
            f"token identity (a): {differ} of {len(want)} requests differ; "
            f"{len(got)} completed; prefill calls "
            f"{sched.stats['prefill_calls']} vs "
            f"{engine.stats['prefill_calls']}")
    emit(phase="scheduler_token_identity_full_width", arch=cfg.name,
         dtype="bfloat16", requests=len(got), tokens_equal=True,
         prefill_calls=sched.stats["prefill_calls"], launches=launches)
    del sched, engine

    evicted = [r for r in live_reqs if r.evictions and r.status == "done"]
    engine = m["ServeEngine"](cfg, params, slots=L["slots"],
                              cache_len=L["cache_len"], device="cuda")
    for r in evicted:
        engine.submit(m["Request"](rid=r.rid, prompt=r.prompt,
                                   max_tokens=r.max_tokens))
    engine.run()
    want = {r.rid: r.generated for r in engine.completed}
    first = {r.rid: next((i for i, (a, b) in enumerate(
        zip(r.generated, want[r.rid])) if a != b), None) for r in evicted}
    emit(phase="scheduler_eviction_divergence_bf16", arch=cfg.name,
         evicted=len(evicted),
         evictions={r.rid: r.evictions for r in evicted},
         first_diverging_token={k: v for k, v in first.items()
                                if v is not None})
    del engine
    torch.cuda.empty_cache()

    rcfg = m["get_reduced"]("granite-3-2b")
    rparams = m["init_params"](
        rcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, rcfg.vocab, size=int(rng.integers(4, 12)))
               for _ in range(6)]
    runs = []
    for pool in ({}, dict(max_kv_blocks=8, kv_block_size=8)):
        sched = m["ServeScheduler"](rcfg, rparams, slots=3, cache_len=64,
                                    device="cuda", **pool)
        for i, p in enumerate(prompts):
            sched.submit(m["Request"](rid=i, prompt=p, max_tokens=20))
        counts.zero()
        sched.run()
        _check_prefill_launches(rcfg, counts.read(), counts.routes(),
                                sched.stats["prefill_calls"], "cuda_core",
                                "token identity (b)")
        runs.append(sched)
    free, tight = runs
    got = {r.rid: r.generated for r in tight.completed}
    if (got != {r.rid: r.generated for r in free.completed} or len(got) != 6
            or not tight.stats["evictions"] or tight.kv.used_blocks):
        raise AssertionError(f"token identity (b): evictions "
                             f"{tight.stats['evictions']}, tokens {got}")
    emit(phase="scheduler_eviction_resume_reduced_f32", arch=rcfg.name,
         requests=6, evictions=tight.stats["evictions"],
         failed_grows=tight.kv.stats["failed_grows"],
         prefill_calls=[free.stats["prefill_calls"],
                        tight.stats["prefill_calls"]], tokens_equal=True)


def serve_main_continuous(torch, m, counts):
    """Phase 6b: the reduced serve CLI in continuous mode on the card, for
    granite-3-2b (K1) and mamba2-2.7b (K4); both reduced configs are f32,
    so every launch takes the CUDA-core route."""
    for arch in ("granite-3-2b", "mamba2-2.7b"):
        counts.zero()
        out = m["serve_main"](arch, arrival_rate=50.0, max_kv_blocks=16,
                              kv_block_size=8, device="cuda")
        launches, routes = counts.read(), counts.routes()
        if out["completed"] + out["shed"] != 16 or out["kv"]["used_blocks"]:
            raise AssertionError(f"serve_main continuous {arch}: {out}")
        _check_prefill_launches(m["get_reduced"](arch), launches, routes,
                                out["prefill_calls"], "cuda_core",
                                "serve_main continuous " + arch, stats=out)
        emit(phase="serve_main_continuous_reduced", launches=launches,
             routes=routes, **out)


def device_profile(torch, run, **labels):
    """``torch.profiler`` over ``run()`` through the port's
    :func:`repro_torch.analysis.profile.device_profile`: device time by
    kernel, the device's busy share of the wall time.  Emits one JSON
    line; returns busy ms."""
    from repro_torch.analysis.profile import device_profile as profile_of
    rec = profile_of(run)
    emit(phase="profile", **labels, wall_ms=rec["wall_ms"],
         device_busy_ms=rec["device_busy_ms"], idle_share=rec["idle_share"],
         peak_mem_gb=rec["peak_mem_gb"], top=rec["top"])
    if not rec["device_busy_ms"]:
        raise AssertionError(f"the profiler saw no device time: {labels}")
    return rec["device_busy_ms"]


def profile_steps(torch, cfg, params, prompts, prefill, decode_step):
    """Phases 5b and 9b: device time by operation over one (8, 2048)
    prefill and 8 decode steps, and the device's busy share of the wall
    time."""
    B, S = 8, 2048
    batch, lens_d = prefill_batch(torch, prompts[:B], S)
    device_profile(torch, lambda: prefill(params, cfg, batch, 2048,
                                          lengths=lens_d),
                   arch=cfg.name, what="prefill", steps=1)
    logits, state = prefill(params, cfg, batch, 2048, lengths=lens_d)
    tok = logits.argmax(-1).to(torch.int32)[:, None]

    def decode():
        nonlocal tok, state
        pos = lens_d.clone()
        for _ in range(8):
            logits, state = decode_step(params, cfg, state, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = pos + 1
    device_profile(torch, decode, arch=cfg.name, what="decode", steps=8)
    del state
    torch.cuda.empty_cache()


def pn_bound(R: int, C: int, esize: int):
    """Least time (ms) of the stretch: bytes (x read once, the f32 output
    written once, lo and hi read once) over HBM bandwidth, or operations
    (subtract, multiply, two comparisons per element) over the f32 peak."""
    nbytes = R * C * (esize + 4) + 2 * 4 * C
    return (*least_ms(4 * R * C, nbytes, "float32"), nbytes)


def k5_vs_plain(torch, pn, pn_ref):
    """Phase 10: K5 against the plain stretch on reflectance-like data
    (0-4000) made on the card.  Returns the 4-band tile's f32 record."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    kernel = pn.percentile_norm_kernel
    for name, R, C, dtype_name in PN_SHAPES:
        x = torch.empty((R, C), device="cuda")
        for part in x.view(-1).split(2 ** 28):
            part.uniform_(0.0, 4000.0, generator=gen)
        x = x.to(getattr(torch, dtype_name))
        extra = {}
        if name == "s2_tile_4band":
            # the bounds come from the percentile helper, whose sort (not
            # the stretch) is most of the public op's time
            pct = pn_ref.percentiles(x, (1.0, 99.0))
            extra["percentile_helper_ms"] = cuda_ms(
                torch, lambda: pn_ref.percentiles(x, (1.0, 99.0)), reps=2)
            lo, hi = pct[0:1], pct[1:2]
        else:
            lo = torch.empty((1, C), device="cuda").uniform_(
                0.0, 400.0, generator=gen)
            hi = lo + torch.empty((1, C), device="cuda").uniform_(
                2000.0, 3600.0, generator=gen)
        out = kernel(x, lo, hi)
        torch.cuda.synchronize()
        err = 0.0
        for s0 in range(0, R, PN_CHUNK):
            want = pn_ref.stretch_ref(x[s0:s0 + PN_CHUNK], lo, hi)
            got = out[s0:s0 + PN_CHUNK]
            err = max(err, (got - want).abs().max().item())
            torch.testing.assert_close(got, want, atol=PN_TOL, rtol=0)
            del want, got
        del out
        torch.cuda.empty_cache()
        big = R * C > 2 ** 30
        kernel_ms = cuda_ms(torch, lambda: kernel(x, lo, hi),
                            reps=5 if big else 20)
        plain_ms = cuda_ms(torch, lambda: pn_ref.stretch_ref(x, lo, hi),
                           reps=2 if big else 5)
        torch.cuda.empty_cache()
        bound_ms, bound_by, nbytes = pn_bound(R, C, x.element_size())
        rec = dict(phase="k5_vs_plain", shape=name, dims=[R, C],
                   dtype=dtype_name, max_abs_err=err, tol=PN_TOL,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   kernel_gbps=nbytes / kernel_ms / 1e6,
                   share_of_bound=bound_ms / kernel_ms, **extra)
        emit(**rec)
        records[name] = rec
        del x, lo, hi
        torch.cuda.empty_cache()
    return records["s2_tile_4band"]


def _k5_only(launches: dict, n: int, what: str):
    others = {k: v for k, v in launches.items()
              if k != "percentile_norm" and v}
    if launches["percentile_norm"] != n or others:
        raise AssertionError(f"{what}: launches {launches}, want "
                             f"percentile_norm {n} and nothing else")


def _seg_record(torch, res, width, batch, optimizer, lr):
    steady = (res["steps"] - 1) / (res["train_s"] - res["first_step_s"])
    losses = res["losses"]
    if not np.all(np.isfinite(losses)) or res["params"] != SEG_PARAMS[
            res["model"]]:
        raise AssertionError(f"{res['model']}: losses {losses}, params "
                             f"{res['params']}")
    return dict(model=res["model"], params=res["params"], width=width,
                batch=batch, optimizer=optimizer, lr=lr, steps=res["steps"],
                losses=losses, train_s=res["train_s"],
                first_step_s=res["first_step_s"],
                steps_per_s=res["steps"] / res["train_s"],
                steady_steps_per_s=steady,
                chips_per_s=res["chips_seen"] / res["train_s"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                val={k: res[k] for k in ("precision", "recall", "f1", "iou",
                                         "accuracy")})


def burned_area(torch, m, counts) -> int:
    """Phase 11: the burned-area study at full width.  Returns K5's
    launches on it."""
    kept = []
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    split = m["build_dataset"](4, 2048, 256, "cuda", min_frac=0.10,
                               on_scene=lambda s, n: kept.append((s, n)))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    _k5_only(counts.read(), 4, "build_dataset")
    chips = {k: len(v) for k, v in split.items()}
    if chips != BA_CHIPS:
        raise AssertionError(f"chips {chips}, want {BA_CHIPS}")
    emit(phase="burned_area_data", scenes=4, size=2048, chip=256,
         chips=chips, seconds=data_s)

    res = m["train_segmentation"]("unet", split, lr=1e-3, optimizer="adam",
                                  epochs=4, batch=16, width=16,
                                  device="cuda", seed=0)
    emit(phase="burned_area_train", epochs=4,
         **_seg_record(torch, res, 16, 16, "adam", 1e-3))
    for name in ("unetpp", "deeplabv3", "deeplabv3plus"):
        torch.cuda.reset_peak_memory_stats()
        res = m["train_segmentation"](name, split, lr=1e-2,
                                      optimizer="lamb", epochs=1, batch=16,
                                      width=16, device="cuda", seed=0)
        emit(phase="burned_area_train", epochs=1,
             **_seg_record(torch, res, 16, 16, "lamb", 1e-2))
    launches = counts.read()
    _k5_only(launches, 4, "the burned-area path")
    vision_grid_run(torch, m, counts, split)

    # the scenes the path normalized, against numpy and the plain stretch
    errs = []
    for scene, norm in kept:
        want = m["percentile_stretch"](scene.raster)
        plain = m["percentile_normalize"](
            torch.from_numpy(scene.raster).cuda(), backend="torch")
        errs.append({"scene": scene.scene_id,
                     "vs_numpy": float(np.abs(norm.cpu().numpy()
                                              - want).max()),
                     "vs_plain": (norm - plain).abs().max().item()})
    emit(phase="burned_area_scenes", max_abs_err=errs, tol_numpy=1e-5,
         tol_plain=PN_TOL)
    if any(e["vs_numpy"] > 1e-5 or e["vs_plain"] > PN_TOL for e in errs):
        raise AssertionError(f"normalized scenes stray: {errs}")
    del kept
    torch.cuda.empty_cache()

    # one U-Net step under the profiler
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m["seg_init"]("unet", gen, width=16, device="cuda")
    for t in m["tree_leaves"](params):
        t.requires_grad_(True)
    opt = m["get_optimizer"]("adam")
    state = opt.init(params)
    x, mk = next(iter(m["prefetch"](m["ChipLoader"](split["train"], 16),
                                    device="cuda")))

    def step(i=0):
        m["train_step"](lambda p: m["seg_loss"]("unet", p, x, mk), params,
                        opt, state, i, 1e-3)
    step()
    device_profile(torch, step, model="unet", what="train_step", batch=16,
                   chip=256, steps=1)
    return launches["percentile_norm"]


# phase 11b: the burned-area grid on phase 11's split, its U-Net
# at phase 11's width and batch, this many epochs a job
GRID_EPOCHS = 2


def vision_grid_run(torch, m, counts, split) -> None:
    """Phase 11b: ``vision_grid.run_grid`` on phase 11's split (U-Net of
    width 16, batch 16, ``GRID_EPOCHS``): the six jobs of the example's
    grid through ``Orchestrator.run_local`` on ``cuda``, every one
    ``Succeeded`` with F1 and IoU in [0, 1] (gated); each job's F1, IoU
    and wall time, the best config and the simulated makespan.  The
    chips are normalized already: no kernel launches."""
    counts.zero()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        got = m["run_grid"](split, device="cuda", width=16, batch=16,
                            epochs=GRID_EPOCHS, workdir=td)
    wall = time.perf_counter() - t0
    _k5_only(counts.read(), 0, "the grid on phase 11's split")
    jobs = {n: {k: r[k] for k in ("f1", "iou", "wall_s", "train_s", "steps",
                                  "final_loss")}
            for n, r in got["results"].items() if r is not None}
    emit(phase="vision_grid", epochs=GRID_EPOCHS, width=16, batch=16,
         states=got["states"], jobs=jobs, best=got["best"],
         ranking=got["ranking"], makespan_h=got["makespan_h"],
         speedup_vs_serial=got["speedup_vs_serial"],
         summary=got["summary"], wall_s=wall)
    if (set(got["states"].values()) != {"Succeeded"} or len(jobs) != 6
            or not all(0.0 <= j["f1"] <= 1.0 and 0.0 <= j["iou"] <= 1.0
                       for j in jobs.values())):
        raise AssertionError(f"vision grid: {got['states']} {jobs}")


def vision_grid_cli() -> dict:
    """Phase 13b's subprocess (run beside phase 20, whose reduced jobs
    leave the card nearly idle): ``python -m
    repro_torch.launch.vision_grid`` on the card at the example's size;
    its exit code, output and wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.vision_grid"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=600)
    return {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr,
            "wall_s": time.perf_counter() - t0}


def vision_grid_cli_check(got: dict) -> int:
    """Phase 13b: the grid CLI exited 0 on ``cuda``, its six jobs
    ``Succeeded``, and its four scenes launched K5 four times (the
    subprocess's own count).  Returns K5's launches."""
    if got["rc"] != 0:
        raise AssertionError(f"vision_grid CLI: exit {got['rc']}: "
                             f"{got['err'][-3000:]}")
    out = json.loads(got["out"])
    launches = out["percentile_norm_launches"]
    emit(phase="vision_grid_cli", device=out["device"], chips=out["chips"],
         states=out["states"], best=out["best"],
         f1={n: r["f1"] for n, r in out["results"].items()},
         makespan_h=out["makespan_h"],
         speedup_vs_serial=out["speedup_vs_serial"],
         launches_vision_grid=launches, wall_s=got["wall_s"])
    if (not out["device"].startswith("cuda") or launches != 4
            or set(out["states"].values()) != {"Succeeded"}
            or len(out["states"]) != 6):
        raise AssertionError(f"vision_grid CLI: {out}")
    return launches


def forward_vs_cpu(torch, m):
    """Phase 11b: each vision model's forward on the card (cuDNN, TF32 off)
    against the same weights on the CPU, at batch 2 x 64 x 64."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((2, 64, 64, 3), device="cuda", generator=gen)
    y = torch.rand((2, 64, 64, 3), device="cuda", generator=gen)
    errs = {}
    with torch.no_grad():
        for name in SEG_PARAMS:
            if name == "changeformer":
                p = m["changeformer_init"](gen, in_ch=3, device="cuda")
                run = m["changeformer_apply"]
                ins = (x, y)
            else:
                p = m["seg_init"](name, gen, width=16, device="cuda")
                run = functools.partial(m["seg_apply"], name)
                ins = (x,)
            got = run(p, *ins)
            want = run(_map(p, lambda t: t.cpu()), *(t.cpu() for t in ins))
            errs[name] = (got.cpu() - want).abs().max().item()
            torch.testing.assert_close(got.cpu(), want, atol=FWD_TOL,
                                       rtol=FWD_TOL)
    emit(phase="vision_forward_vs_cpu", batch=[2, 64, 64],
         max_abs_err=errs, tol=FWD_TOL)


def deforestation(torch, m, counts) -> int:
    """Phase 12: the deforestation study at the paper's 256 chip.  Returns
    K5's launches on it."""
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    pairs = m["build_pairs"](6, 256, "cuda")
    torch.cuda.synchronize()
    _k5_only(counts.read(), 12, "build_pairs")
    res = m["train_changeformer"](pairs, lr=1e-3, steps=60, device="cuda",
                                  seed=0)
    launches = counts.read()
    _k5_only(launches, 12, "the deforestation path")
    errs = []
    for i, (a3, b3, mk) in enumerate(pairs):
        a, b, want_m = m["synth_change_pair"](f"defo-{i}", 256, 256,
                                              bands=4, seed=i)
        errs.append(max(float(np.abs(t.cpu().numpy()
                                     - m["nir_rg"](r)).max())
                        for t, r in ((a3, a), (b3, b))))
        if not np.array_equal(mk.cpu().numpy(), want_m):
            raise AssertionError(f"pair {i}: the change mask differs")
    losses = res["losses"]
    emit(phase="deforestation_train", model="changeformer",
         params=res["params"], pairs=[4, 2], size=256, steps=res["steps"],
         losses=losses, train_s=res["train_s"],
         steps_per_s=res["steps"] / res["train_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         composite_max_abs_err_vs_numpy=errs,
         test={k: res[k] for k in ("precision", "recall", "f1", "iou",
                                   "accuracy")})
    if (max(errs) > 1e-5 or not np.all(np.isfinite(losses))
            or res["params"] != SEG_PARAMS["changeformer"]):
        raise AssertionError(f"deforestation: composite errors {errs}, "
                             f"losses {losses}, params {res['params']}")
    del pairs
    torch.cuda.empty_cache()
    return launches["percentile_norm"]


def vision_cli(torch, m, counts):
    """Phase 13: the reduced vision CLI on the card."""
    counts.zero()
    out = m["vision_main"](["--device", "cuda"])
    launches = counts.read()
    want = 4 + 2 * 6
    _k5_only(launches, want, "vision main")
    if out["percentile_norm_launches"] != want or not np.isfinite(
            out["changeformer"]["final_loss"]):
        raise AssertionError(f"vision main: {out}")
    emit(phase="vision_main_reduced", launches=launches, chips=out["chips"],
         unet=out["models"][0], changeformer=out["changeformer"])


# the run API phases (14-18): full-width training through ``run train``,
# then the reduced configs
RUN_TRAIN_ARGV = ["run", "train", "--arch", "stablelm-1.6b", "--full",
                  "--batch", "8", "--seq", "2048", "--precision", "bf16",
                  "--steps", "4", "--log_every", "0"]
# the machine as a campaign inventory: one node, one card
NODE = {"name": "h100", "gpus": 1, "gpu_memory_gb": 80, "cpus": 8,
        "memory_gb": 96, "count": 1}
# phase 20: a retry's bf16 losses against an uninterrupted run's; the
# children run outside deterministic mode, so cuBLAS may sum differently
CAMPAIGN_LOSS_RTOL = 2e-2
# the reduced stablelm of phases 20 and 21 (bf16: K1-K3 on the tensor
# cores), with cadence checkpoints for the resumes
CAMPAIGN_REDUCED = {"steps": 6, "log_every": 0, "precision": "bf16",
                    "checkpoint_every": 2}


def _report_of(text: str) -> dict:
    """The RunReport JSON that ``run`` prints last (an indented object
    whose first line is ``{``)."""
    start = text.rfind("\n{\n")
    return json.loads(text[start + 1:] if start >= 0 else text)


def launch_run(m, argv) -> tuple:
    """``python -m repro_torch.launch`` in this process (so the launch
    counters see it): its exit code and the report it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = m["launch_main"](list(argv))
    return rc, _report_of(buf.getvalue())


def _check_report(rc, report, what: str):
    if rc != 0 or report["status"] != "succeeded":
        raise AssertionError(f"{what}: exit {rc}, status {report['status']}"
                             f", error {report.get('error')}: "
                             f"{report['metrics'].get('traceback', '')}")


def _all_tensor_core(routes: dict, launches: dict, what: str):
    if any(r["cuda_core"] or r["tensor_core"] != launches[name]
           or launches[name] == 0 for name, r in routes.items()):
        raise AssertionError(f"{what}: K1-K3 routes {routes} (launches "
                             f"{launches}): every launch must take the "
                             f"tensor cores")


# phase 22: hubert-xlarge's measured training steps after one warm-up, the
# layers of its gradient gate's depth cut (the trained weights' first
# layers), and its run through the run API
HUBERT_TRAIN_STEPS = 3
HUBERT_GATE_LAYERS = 8
RUN_TRAIN_HUBERT_ARGV = ["run", "train", "--arch", "hubert-xlarge", "--full",
                         "--batch", "8", "--seq", "2048", "--precision",
                         "bf16", "--steps", "2", "--log_every", "0"]
# phase 23: llava-next-mistral-7b's prefill batch (8 x 2048: 512 patches
# and 1536 tokens), its gate's depth cut, and its training batch and steps
# (1 x 2048: 7.24 B parameters with bf16 grads and AdamW moments take
# ~58 GB)
LLAVA_PREFILL_B = 8
LLAVA_GATE_LAYERS = 8
LLAVA_TRAIN_B, LLAVA_TRAIN_STEPS = 1, 2


def train_hubert(torch, m, counts) -> dict:
    """Phase 22: full-width hubert-xlarge (48 layers, non-causal, 16 heads
    of 80, bf16) trains through TrainLoop on its seeded frame batches at
    8 x 2048: K1 2 x 48 launches a step, K2 and K3 48 each, all on the
    tensor cores (hd 80 is in the table); then the gradient gate on the
    trained weights' first ``HUBERT_GATE_LAYERS`` layers, through the same
    kernels; then ``run train --arch hubert-xlarge --full`` in process (2
    steps): ``succeeded`` on cuda with the same routes.  Returns the
    launches of the two runs."""
    arch = "hubert-xlarge"
    cfg = m["get_config"](arch)
    routes = flash_routes(torch, m["fa"], cfg.head_dim)
    if set(routes.values()) != {"tensor_core"}:
        raise AssertionError(f"hubert's routes at hd {cfg.head_dim}: "
                             f"{routes}, want the tensor cores")
    launches, state, data = train_full_width(torch, m, counts, arch,
                                             steps=HUBERT_TRAIN_STEPS)
    params = state.params
    del state                                    # the optimizer's moments
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=HUBERT_GATE_LAYERS)
    train_grads_vs_f32(torch, m, dict(params, layers=params["layers"][
        :HUBERT_GATE_LAYERS]), data, arch, cfg=cut)
    del params, data
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    rc, report = launch_run(m, RUN_TRAIN_HUBERT_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    api, routes = counts.read(), counts.routes(counts.FLASH)
    _check_report(rc, report, "run train --arch hubert-xlarge --full")
    met = report["metrics"]
    losses = met["losses"]
    want = train_launches(cfg, 2)
    if (met["device"] != "cuda" or met["params"] != cfg.param_count()
            or len(losses) != 2 or not np.all(np.isfinite(losses))
            or api != want):
        raise AssertionError(f"run train hubert-xlarge: {met}, launches "
                             f"{api} (want {want})")
    _all_tensor_core(routes, api, "run train --arch hubert-xlarge --full")
    emit(phase="run_api_train_hubert", argv=RUN_TRAIN_HUBERT_ARGV,
         arch=met["arch"], params=met["params"], device=met["device"],
         losses=losses, loop_step_s=met["pure_step_s"] / met["steps_run"],
         report_wall_s=report["wall_s"], call_wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=api, routes=routes)
    torch.cuda.empty_cache()
    return {"train": launches, "run_api": api}


def llava_path(torch, m, counts) -> dict:
    """Phase 23: llava-next-mistral-7b at full width (32 layers, 32 q / 8
    kv heads of 128, bf16).  (a) One prefill of ``make_batch(cfg, 8,
    2048)``, 512 patch embeddings ahead of 1536 tokens: K1 32 launches on
    the tensor cores, finite logits and caches, its ms and profile; the
    gate (:func:`prefill_gate`, judged on the decode state) on the first
    ``LLAVA_GATE_LAYERS`` layers, rows of 512 patches and 1..1536 tokens.
    (b) With nothing else resident, training at full width and depth
    (1 x 2048, bf16 params and AdamW moments, remat), a warm-up and 2
    steps, every K1-K3 launch on the tensor cores.  Returns the
    launches."""
    arch = "llava-next-mistral-7b"
    cfg = m["get_config"](arch)
    prefill = m["prefill"]
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = _param_count(params)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")
    batch = m["make_batch"](cfg, LLAVA_PREFILL_B, 2048, 0, device="cuda")
    P, T = batch["patches"].shape[1], batch["tokens"].shape[1]
    if (P, T) != (512, 1536):
        raise AssertionError(f"{P} patches and {T} tokens")
    run = lambda: prefill(params, cfg, batch, 2048)  # noqa: E731
    run()                                 # warm-up: cuBLAS handles, pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    logits, state = run()
    torch.cuda.synchronize()
    launches, routes = counts.read(), counts.routes()
    _check_prefill_launches(cfg, launches, routes, 1, "tensor_core",
                            cfg.name + " prefill")
    kv = (cfg.n_layers, LLAVA_PREFILL_B, 2048, cfg.n_kv_heads, cfg.head_dim)
    if (tuple(logits.shape) != (LLAVA_PREFILL_B, cfg.vocab)
            or not torch.isfinite(logits).all()
            or any(tuple(state[k].shape) != kv
                   or not torch.isfinite(state[k]).all() for k in "kv")):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, "
                             f"state {({k: tuple(v.shape) for k, v in state.items()})}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del logits, state
    prefill_ms = cuda_ms(torch, run, reps=3)
    busy = device_profile(torch, run, arch=cfg.name, what="prefill",
                          steps=1)
    emit(phase="vlm_prefill_full_width", arch=cfg.name, params=n_params,
         batch=[LLAVA_PREFILL_B, 2048], patches=P, tokens=T,
         prefill_ms=prefill_ms, device_busy_ms=busy, peak_mem_gb=peak,
         launches=launches, routes={"flash_attention_fwd":
                                    routes["flash_attention_fwd"]})
    rng = np.random.default_rng(1)
    lens = torch.from_numpy(
        (P + rng.integers(1, T + 1, size=LLAVA_PREFILL_B)).astype(np.int32))
    lens[0] = 2048
    cut = dataclasses.replace(cfg, n_layers=LLAVA_GATE_LAYERS)
    prefill_gate(torch, m, cut, dict(params, layers=params["layers"][
        :LLAVA_GATE_LAYERS]), batch, lens.cuda(), judge_state=True)
    del params, batch, run
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated() != resident:
        raise AssertionError(f"{torch.cuda.memory_allocated()} bytes in use "
                             f"before llava's training, {resident} before "
                             f"its prefill")
    train, state, data = train_full_width(
        torch, m, counts, arch, steps=LLAVA_TRAIN_STEPS, batch=LLAVA_TRAIN_B)
    del state, data
    torch.cuda.empty_cache()
    return {"prefill": launches["flash_attention_fwd"], "train": train,
            "resident_gb": resident / 1e9}


def run_api_train_full_width(torch, m, counts) -> dict:
    """Phase 14: ``run train --full`` (stablelm-1.6b, bf16, 8 x 2048, 4
    steps) through the run API's front door, in this process: a
    ``succeeded`` report, 4 finite losses, K1-K3 launched as
    ``train_launches`` predicts, all on the tensor cores.  Returns the
    launches and the report's numbers for the records."""
    cfg = m["get_config"]("stablelm-1.6b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    rc, report = launch_run(m, RUN_TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = counts.read(), counts.routes(counts.FLASH)
    _check_report(rc, report, "run train --full")
    met = report["metrics"]
    losses = met["losses"]
    if len(losses) != 4 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"run train --full: losses {losses}")
    want = train_launches(cfg, 4)
    if launches != want:
        raise AssertionError(f"run train --full: launches {launches} != "
                             f"{want}")
    _all_tensor_core(routes, launches, "run train --full")
    rec = dict(arch=met["arch"], params=met["params"], device=met["device"],
               losses=losses, steps_per_s=met["steps_per_s"],
               loop_step_s=met["pure_step_s"] / met["steps_run"],
               loop_wall_s=met["wall_s"],
               report_wall_s=report["wall_s"], call_wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, routes=routes,
               phase4_step_s_pr20=0.9001)
    emit(phase="run_api_train_full_width", argv=RUN_TRAIN_ARGV, **rec)
    torch.cuda.empty_cache()
    return rec


def _cli(args, timeout: int = 600):
    """``python -m repro_torch.launch *args`` in a process group of its
    own, which is killed whole when the call returns or times out: no
    process it started (a gang's ranks) outlives it into the next
    phase."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    argv = [sys.executable, "-m", "repro_torch.launch", *args]
    with tempfile.TemporaryDirectory() as cwd:
        proc = subprocess.Popen(argv, env=env, cwd=cwd, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=timeout)
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def run_api_cli_subprocess(m) -> dict:
    """Phase 15: ``python -m repro_torch.launch run serve`` as a real
    subprocess on the card: granite (K1) with the same counts as a direct
    ``serve_main`` call, mamba2 (K4), and ``run bogus`` exiting 2.
    Returns the subprocesses' K1 and K4 launches."""
    out = {}
    direct = m["serve_main"]("granite-3-2b", requests=8)
    for arch, stat in (("granite-3-2b", "flash_attention_launches"),
                       ("mamba2-2.7b", "ssd_scan_launches")):
        t0 = time.perf_counter()
        proc = _cli(["run", "serve", "--arch", arch, "--requests", "8"])
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"run serve --arch {arch}: exit "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}"
                                 f"{proc.stdout[-3000:]}")
        report = _report_of(proc.stdout)
        met = report["metrics"]
        if report["status"] != "succeeded" or not met[stat] > 0:
            raise AssertionError(f"run serve --arch {arch}: {report}")
        if arch == "granite-3-2b":
            keys = ("requests", "tokens", "decode_steps", "prefill_calls",
                    "flash_attention_launches")
            if any(met[k] != direct[k] for k in keys):
                raise AssertionError(
                    f"run serve (subprocess) {[met[k] for k in keys]} != "
                    f"serve_main {[direct[k] for k in keys]} for {keys}")
        out[arch] = met[stat]
        emit(phase="run_api_cli_subprocess", arch=arch, device=met["device"],
             exit_code=proc.returncode, status=report["status"],
             process_wall_s=wall, report_wall_s=report["wall_s"],
             tokens=met["tokens"], tokens_per_s=met["tokens_per_s"],
             **{stat: met[stat]})
    proc = _cli(["run", "bogus"], timeout=120)
    if proc.returncode != 2:
        raise AssertionError(f"run bogus: exit {proc.returncode}, want 2")
    emit(phase="run_api_cli_subprocess", argv=["run", "bogus"],
         exit_code=proc.returncode, stderr=proc.stderr.strip())
    return out


def run_api_train_resume_bitwise(torch, m, counts) -> dict:
    """Phase 16: reduced stablelm (bf16, the tensor-core route) in
    deterministic mode through ``run train``: preempted before step 3 (a
    ``failed`` report), then ``--resume``; its losses and final checkpoint
    equal an uninterrupted ``train_main`` call's, bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            oracle = os.path.join(tmp, "oracle")
            base = m["train_main"]("stablelm-1.6b", steps=12, log_every=0,
                                   precision="bf16", device="cuda",
                                   checkpoint_dir=oracle,
                                   checkpoint_async=False)
            ck = os.path.join(tmp, "ck")
            argv = ["run", "train", "--steps", "12", "--log_every", "0",
                    "--precision", "bf16", "--checkpoint_dir", ck,
                    "--checkpoint_every", "2"]
            counts.zero()
            rc, pre = launch_run(m, argv + ["--preempt_at_step", "3"])
            if rc != 1 or pre["status"] != "failed" or not str(
                    pre["error"]).startswith("Preemption"):
                raise AssertionError(f"preempted run train: exit {rc}, "
                                     f"{pre['status']}, {pre['error']}")
            rc, res = launch_run(m, argv + ["--resume"])
            launches, routes = counts.read(), counts.routes(counts.FLASH)
            _check_report(rc, res, "run train --resume")
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            got, gstep = load(ls(ck)[-1][1])
            want, wstep = load(ls(oracle)[-1][1])
            same = (set(got) == set(want) and gstep == wstep == 12 and all(
                np.array_equal(got[k], want[k]) for k in want))
            met = res["metrics"]
            if (met["resumed_from_step"] != 2
                    or met["losses"] != base["losses"][2:] or not same):
                raise AssertionError(
                    f"run train --resume is not bitwise: resumed from "
                    f"{met['resumed_from_step']}, losses {met['losses']} vs "
                    f"{base['losses'][2:]}, final arrays equal: {same}")
    finally:
        torch.use_deterministic_algorithms(False)
    _all_tensor_core(routes, launches, "run train --resume")
    emit(phase="run_api_train_resume_bitwise", precision="bf16",
         preempted_error=pre["error"], resumed_from_step=2,
         losses_equal=True, final_checkpoint_bitwise=True,
         launches=launches, routes=routes)
    return launches


def campaign_local(torch, m, counts) -> dict:
    """Phase 17: a two-learning-rate grid of reduced stablelm (bf16)
    through ``Orchestrator.submit_runs(attach_payload=True)`` and
    ``run_local`` on the card: each job's first attempt is preempted
    before step 3, the retry resumes from step 2 under the retry env, and
    the results land on the PVC and in S3 with the checkpoints."""
    with tempfile.TemporaryDirectory() as tmp:
        grid = m["ExperimentGrid"]("lm", {"lr": [3e-4, 1e-3]})
        runs = [r.replace(overrides={
            **r.overrides, "steps": 6, "log_every": 0, "precision": "bf16",
            "checkpoint_every": 2, "preempt_at_step": 3,
            "s3_root": os.path.join(tmp, "s3"),
            "checkpoint_dir": os.path.join(tmp, "ck", r.run_name)})
            for r in grid.to_runs(kind="train", arch="stablelm-1.6b")]
        pvc = m["PersistentVolume"](tmp)
        s3 = m["S3Store"](tmp)
        orch = m["Orchestrator"](pvc, s3)
        orch.submit_runs(runs, attach_payload=True)
        counts.zero()
        t0 = time.perf_counter()
        recs = orch.run_local()
        wall = time.perf_counter() - t0
        launches, routes = counts.read(), counts.routes(counts.FLASH)
        jobs = {}
        for run in runs:
            rec = recs[run.run_name]
            res = json.loads(pvc.read_bytes(f"results/{run.run_name}.json"))
            hist = res["attempt_history"]
            met = (res["result"] or {}).get("metrics", {})
            ok = (rec.state.value == "Succeeded" and rec.attempts == 2
                  and [h["outcome"] for h in hist] == ["failed", "succeeded"]
                  and "Preemption" in hist[0]["error"]
                  and hist[1].get("resumed_from_step") == 2
                  and met.get("s3_objects", 0) > 0
                  and met.get("device") == "cuda"
                  and s3.exists(f"results/{run.run_name}.json"))
            if not ok:
                raise AssertionError(f"campaign_local {run.run_name}: "
                                     f"{rec.state}, {rec.attempts} attempts, "
                                     f"history {hist}, error {rec.error}")
            jobs[run.run_name] = dict(
                attempts=rec.attempts,
                attempt_history=[{k: h[k] for k in h if k != "wall_s"}
                                 for h in hist],
                s3_objects=met["s3_objects"], losses=met["losses"])
        summary = json.loads(pvc.read_bytes(
            "results/_local_run_summary.json"))
    _all_tensor_core(routes, launches, "campaign_local")
    emit(phase="campaign_local", jobs=jobs, wall_s=wall, launches=launches,
         routes=routes, local_run_summary=summary)
    return launches


def run_api_simulate(torch, m, peak_gb: float):
    """Phase 18: ``run simulate --campaign all``: the paper's 234 jobs,
    234 manifests and 4040.0 wall-hours; then, not gated, ``autobatch``
    for stablelm-1.6b at seq 2048 against the card's own budget."""
    with tempfile.TemporaryDirectory() as tmp:
        rc, report = launch_run(m, ["run", "simulate", "--campaign", "all",
                                    "--workdir", tmp])
    _check_report(rc, report, "run simulate")
    met = report["metrics"]
    if (met["jobs"], met["manifests"], met["total_wall_hours"]) != (
            234, 234, 4040.0):
        raise AssertionError(f"run simulate --campaign all: {met}")
    cfg = m["get_config"]("stablelm-1.6b")
    budget = m["MemoryBudget"].of_device("cuda")
    emit(phase="run_api_simulate", **met, wall_s=report["wall_s"],
         autobatch_stablelm_seq2048=m["autobatch"](cfg, 2048, budget=budget),
         budget_device_gb=budget.device_gb,
         budget_reserve_frac=budget.reserve_frac,
         measured_peak_gb_at_batch8=peak_gb)


def _write_campaign(tmp: str, jobs: list) -> tuple:
    """A jobs file of RunSpec dicts and a one-node ``nodes.json``."""
    jobs_file = os.path.join(tmp, "jobs.json")
    nodes_file = os.path.join(tmp, "nodes.json")
    with open(jobs_file, "w") as fh:
        json.dump(jobs, fh)
    with open(nodes_file, "w") as fh:
        json.dump({"nodes": [NODE]}, fh)
    return jobs_file, nodes_file


def _read_events(workdir: str) -> list:
    path = Path(workdir) / "repro-data" / "campaign" / "events.jsonl"
    out = []
    if path.exists():
        for line in path.read_text(errors="replace").splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                pass                  # a torn line mid-append
    return out


def _max_gpu_jobs(events: list) -> int:
    """The most GPU jobs the log ever holds on one node at once."""
    live, most = {}, 0
    for e in events:
        key = (e.get("job"), e.get("attempt"))
        if e["event"] in ("admitted", "adopted"):
            if e["resources"]["gpus"] > 0:
                live[key] = e["node"]
        elif e["event"] in ("exited", "orphan_requeued"):
            live.pop(key, None)
        for node in set(live.values()):
            most = max(most, sum(n == node for n in live.values()))
    return most


def _summary_of(stdout: str) -> dict:
    return json.loads(stdout[stdout.index("{"):])


def campaign_cluster_full_width(torch, m, api_train, api_cli) -> dict:
    """Phase 19: ``campaign run`` as a subprocess runs full-width
    stablelm-1.6b training and granite-3-2b and mamba2-2.7b serving, each
    job a ``run <kind>`` subprocess on the card.  Returns the children's
    K1 (granite) and K4 (mamba2) launches."""
    jobs = [
        {"kind": "train", "arch": "stablelm-1.6b", "seed": 0,
         "name": "train-stablelm",
         "overrides": {"full": True, "batch": 8, "seq": 2048,
                       "precision": "bf16", "steps": 4, "log_every": 0}},
        {"kind": "serve", "arch": "granite-3-2b", "seed": 0,
         "name": "serve-granite", "overrides": {"requests": 8}},
        {"kind": "serve", "arch": "mamba2-2.7b", "seed": 0,
         "name": "serve-mamba2", "overrides": {"requests": 8}}]
    stat = {"serve-granite": ("flash_attention_launches", "granite-3-2b"),
            "serve-mamba2": ("ssd_scan_launches", "mamba2-2.7b")}
    torch.cuda.empty_cache()
    parent_reserved_gb = torch.cuda.memory_reserved() / 1e9
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs_file, nodes_file = _write_campaign(tmp, jobs)
        workdir = os.path.join(tmp, "campaign")
        proc = _cli(["campaign", "run", "--jobs", jobs_file, "--workdir",
                     workdir, "--workers", "2", "--nodes-file", nodes_file],
                    timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"campaign run: exit {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}"
                                 f"{proc.stdout[-3000:]}")
        summary = _summary_of(proc.stdout)
        events = _read_events(workdir)
        results = {j["name"]: json.loads(
            (Path(workdir) / "repro-data" / "results"
             / f"{j['name']}.json").read_text()) for j in jobs}
        status = _cli(["campaign", "status", workdir, "--json"], timeout=120)
    launches, out = {}, {}
    for name, res in results.items():
        report = res["result"] or {}
        met = report.get("metrics", {})
        if (res["state"] != "Succeeded" or res["attempts"] != 1
                or report.get("status") != "succeeded"
                or met.get("device") != "cuda"):
            raise AssertionError(f"campaign job {name}: {res['state']}, "
                                 f"{res['attempts']} attempts, device "
                                 f"{met.get('device')}, error "
                                 f"{res['error']}")
        if name in stat:
            key, arch = stat[name]
            launches[name] = met[key]
            if met[key] != api_cli[arch]:
                raise AssertionError(f"campaign job {name}: {key} "
                                     f"{met[key]} != phase 15's "
                                     f"{api_cli[arch]}")
    train = results["train-stablelm"]["result"]["metrics"]
    if len(train["losses"]) != 4 or not np.all(np.isfinite(train["losses"])):
        raise AssertionError(f"campaign train job: losses {train['losses']}")
    if status.returncode != 0:
        raise AssertionError(f"campaign status: exit {status.returncode}: "
                             f"{status.stderr[-2000:]}")
    state = json.loads(status.stdout)
    if not state["consistent"] or state["violations"]:
        raise AssertionError(f"campaign status: {state['violations']}")
    most = _max_gpu_jobs(events)
    if most != 1:
        raise AssertionError(f"campaign log holds {most} GPU jobs on the "
                             f"node at once")
    job_walls = {e["job"]: e["wall_s"] for e in events
                 if e["event"] == "exited"}
    waits = {e["job"]: e["queue_wait_s"] for e in events
             if e["event"] == "admitted"}
    util = summary["utilization"]["cluster"]
    emit(phase="campaign_cluster_full_width", exit_code=proc.returncode,
         states=summary["states"], makespan_s=summary["makespan_s"],
         job_wall_s=job_walls, queue_wait_s=waits,
         scheduler_overhead_s=summary["makespan_s"] - sum(job_walls.values()),
         busy_gpu_util=util["busy_gpu_util"],
         goodput_gpu_util=util["goodput_gpu_util"],
         max_gpu_jobs_on_node=most, consistent=state["consistent"],
         train_step_s=train["pure_step_s"] / train["steps_run"],
         phase14_step_s=api_train["loop_step_s"],
         train_report_wall_s=results["train-stablelm"]["result"]["wall_s"],
         launches=launches, parent_reserved_gb=parent_reserved_gb,
         phase_wall_s=time.perf_counter() - t0, process_wall_s=wall)
    return {"flash_attention_fwd": launches["serve-granite"],
            "ssd_scan": launches["serve-mamba2"]}


class _LastStepAtExit:
    """Popen-shaped wrapper that notes the newest published checkpoint
    step when the executor first sees its process dead: a SIGKILLed
    attempt publishes nothing after that."""

    def __init__(self, proc, ckpt_dir, latest_step, seen):
        self.proc, self.pid = proc, proc.pid
        self.ckpt_dir, self.latest_step, self.seen = (ckpt_dir, latest_step,
                                                      seen)

    def poll(self):
        rc = self.proc.poll()
        if rc is not None and self.pid not in self.seen:
            self.seen[self.pid] = self.latest_step(self.ckpt_dir)
        return rc

    def send_signal(self, sig):
        self.proc.send_signal(sig)


def campaign_chaos_resume(torch, m) -> dict:
    """Phase 20: ``Orchestrator.run_cluster`` here, two reduced stablelm
    jobs (bf16) each SIGKILLed once it has published a checkpoint, on the
    one-node inventory."""
    ex = m["executor"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = [m["RunSpec"](kind="train", arch="stablelm-1.6b", seed=s,
                             name=f"chaos{s}", overrides={
                                 **CAMPAIGN_REDUCED, "checkpoint_dir":
                                 os.path.join(tmp, f"ck{s}")})
                for s in (0, 1)]
        pvc = m["PersistentVolume"](os.path.join(tmp, "campaign"))
        orch = m["Orchestrator"](pvc)
        orch.submit_runs(runs)
        last_step = {}             # pid -> newest published step at exit

        def spawn(job, attempt, argv, env, stdout, stderr):
            return _LastStepAtExit(
                ex._default_spawn(job, attempt, argv, env, stdout, stderr),
                job.env.get("CHECKPOINT_DIR"), ex._latest_checkpoint_step,
                last_step)

        # each step stalls 0.25 s on the host clock (the math is
        # untouched): a reduced step takes milliseconds on the card, and
        # the kill must land while the attempt is still training
        recs = orch.run_cluster(
            workers=2, spawn=spawn, attempt_timeout_s=600,
            worker_env={"REPRO_STEP_DELAY_S": "0.25"},
            chaos=ex.ChaosSpec(kill_jobs=("chaos0", "chaos1"),
                               after_checkpoints=1),
            inventory=m["node_specs_from_json"]({"nodes": [NODE]}))
        events = [json.loads(ln) for ln in pvc.read_bytes(
            ex.EVENTS_REL).decode().splitlines()]
        state = ex.replay_events(events)
        jobs = {}
        for s, run in enumerate(runs):
            name = run.run_name
            rec = recs[name]
            res = json.loads(pvc.read_bytes(f"results/{name}.json"))
            hist = res["attempt_history"]
            started = [e for e in events
                       if e["event"] == "started" and e["job"] == name]
            killed = last_step.get(started[0]["pid"])
            met = rec.result["metrics"]
            resumed = met["resumed_from_step"]
            if (rec.state.value != "Succeeded" or rec.attempts != 2
                    or [h["outcome"] for h in hist]
                    != ["preempted", "succeeded"]
                    or met["device"] != "cuda" or not killed
                    or resumed != killed):
                raise AssertionError(
                    f"campaign chaos {name}: {rec.state}, {rec.attempts} "
                    f"attempts, history {hist}, resumed from {resumed}, "
                    f"last published {killed}")
            ref_dir = os.path.join(tmp, f"ref{s}")
            base = m["train_main"](
                "stablelm-1.6b", seed=s, device="cuda",
                checkpoint_dir=ref_dir, checkpoint_async=False,
                **{k: v for k, v in CAMPAIGN_REDUCED.items()})
            want = base["losses"][resumed:]
            got = met["losses"]
            rel = max((abs(g - w) / abs(w) for g, w in zip(got, want)),
                      default=0.0)
            if (not got or len(got) != len(want)
                    or rel > CAMPAIGN_LOSS_RTOL):
                raise AssertionError(f"campaign chaos {name}: losses {got} "
                                     f"vs {want} (rel {rel})")
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            a, a_step = load(ls(os.path.join(tmp, f"ck{s}"))[-1][1])
            b, b_step = load(ls(ref_dir)[-1][1])
            jobs[name] = dict(
                attempts=rec.attempts, killed_after_step=killed,
                resumed_from_step=resumed, losses=got,
                losses_max_rel_err=rel, losses_equal=got == want,
                final_checkpoint_bitwise=(
                    set(a) == set(b) and a_step == b_step
                    and all(np.array_equal(a[k], b[k]) for k in b)),
                attempt_wall_s=[h["wall_s"] for h in hist])
    if not state["ended"] or not state["consistent"]:
        raise AssertionError(f"campaign chaos log: {state['violations']}")
    emit(phase="campaign_chaos_resume", jobs=jobs,
         loss_rtol=CAMPAIGN_LOSS_RTOL, consistent=state["consistent"],
         makespan_s=orch.last_campaign_summary["makespan_s"],
         wall_goodput=orch.last_campaign_summary["wall_goodput"],
         phase_wall_s=time.perf_counter() - t0)


def campaign_scheduler_sigkill_resume(m) -> None:
    """Phase 21: ``campaign run`` SIGKILLed mid-campaign and restarted
    with ``--resume-campaign``; nothing that had finished runs again."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [{"kind": "train", "arch": "stablelm-1.6b", "seed": s,
                 "name": f"run{s}", "overrides": {
                     **CAMPAIGN_REDUCED,
                     "checkpoint_dir": os.path.join(tmp, f"ck{s}")}}
                for s in range(4)]
        jobs_file, nodes_file = _write_campaign(tmp, jobs)
        workdir = os.path.join(tmp, "campaign")
        argv = [sys.executable, "-m", "repro_torch.launch", "campaign",
                "run", "--jobs", jobs_file, "--workdir", workdir,
                "--workers", "1", "--nodes-file", nodes_file]
        env = dict(os.environ, PYTHONPATH=str(SRC))
        with open(os.path.join(tmp, "sched.err"), "wb") as err:
            proc = subprocess.Popen(argv, env=env, cwd=tmp,
                                    stdout=subprocess.DEVNULL, stderr=err)
            try:
                deadline = time.time() + 300
                while True:
                    state = m["replay_events"](_read_events(workdir))
                    done = {n for n, st in state["jobs"].items()
                            if st["state"] == "Succeeded"}
                    live = sorted((n, int(a)) for n, st
                                  in state["jobs"].items()
                                  for a in st["live"])
                    if done and live:
                        break
                    if proc.poll() is not None or time.time() > deadline:
                        raise AssertionError(
                            f"campaign run ended or stalled before the "
                            f"kill: exit {proc.poll()}")
                    time.sleep(0.2)
                proc.kill()                # SIGKILL the scheduler
                proc.wait()
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        t_kill = time.perf_counter() - t0
        res = subprocess.run(argv + ["--resume-campaign"], env=env, cwd=tmp,
                             capture_output=True, text=True, timeout=900)
        events = _read_events(workdir)
    if res.returncode != 0:
        raise AssertionError(f"campaign run --resume-campaign: exit "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    summary = _summary_of(res.stdout)
    resume_at = max(i for i, e in enumerate(events)
                    if e["event"] == "campaign_resume")
    rerun = sorted({e["job"] for e in events[resume_at:]
                    if e["event"] == "started" and e["job"] in done})
    recovered = sorted((e["job"], e["attempt"], e["event"]) for e in events
                       if e["event"] in ("adopted", "orphan_requeued"))
    state = m["replay_events"](events)
    if (summary["states"] != {"Succeeded": 4} or rerun
            or [r[:2] for r in recovered] != live
            or not state["ended"] or not state["consistent"]
            or state["resumes"] != 1):
        raise AssertionError(
            f"campaign resume: states {summary['states']}, re-run {rerun}, "
            f"live at the kill {live}, recovered {recovered}, consistent "
            f"{state['consistent']} {state['violations']}")
    emit(phase="campaign_scheduler_sigkill_resume",
         done_before_kill=sorted(done), live_at_kill=live,
         recovered=recovered, states=summary["states"],
         resumed_done=summary["resumed_done"],
         orphans_adopted=summary["orphans_adopted"],
         orphans_requeued=summary["orphans_requeued"],
         consistent=state["consistent"], kill_at_s=t_kill,
         phase_wall_s=time.perf_counter() - t0)


# phases 24-26: data-parallel training.  The full-width world-2 gang of
# phase 25 (both ranks on the one card, gloo) against world 1 with the same
# arguments (the learning-rate schedule depends on --steps)
GANG_STEPS = 3
GANG_ARGV = ["run", "train", "--arch", "stablelm-1.6b", "--full",
             "--batch", "8", "--seq", "2048", "--steps", str(GANG_STEPS),
             "--precision", "bf16", "--log_every", "0"]
# phases 25 and 26: a gang's bf16 losses against world 1's.  Sound gangs
# measured 9.7e-7 (25) and 1.06e-5 (26) on the H100; a reduction that
# halved the summed loss and gradients would be off by ~0.5
GANG_LOSS_RTOL = 1e-3
# phase 26: the inventory gives the gang's two ranks a place on the card:
# one node whose two GPU slots are both this card
GANG_NODE = {**NODE, "gpus": 2}


def dist_world1_bitwise(torch, m) -> None:
    """Phase 24: ``dist_train_main(world_size=1)`` (no process group, no
    collective) on the reduced stablelm in deterministic mode (bf16, the
    tensor-core route), with checkpoints: its losses and final checkpoint
    equal ``train_main``'s bit for bit."""
    kw = dict(steps=6, log_every=0, precision="bf16", device="cuda",
              checkpoint_every=2, checkpoint_async=False)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            plain = m["train_main"]("stablelm-1.6b",
                                    checkpoint_dir=os.path.join(
                                        tmp, "plain"), **kw)
            dist = m["dist_train_main"]("stablelm-1.6b", world_size=1,
                                        checkpoint_dir=os.path.join(
                                            tmp, "dist"), **kw)
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            got, gstep = load(ls(os.path.join(tmp, "dist"))[-1][1])
            want, wstep = load(ls(os.path.join(tmp, "plain"))[-1][1])
            same = (set(got) == set(want) and gstep == wstep == 6 and all(
                np.array_equal(got[k], want[k]) for k in want))
    finally:
        torch.use_deterministic_algorithms(False)
    d = dist["dist"]
    if (dist["losses"] != plain["losses"] or not same
            or d["allreduce_bytes_per_step"] != 0 or d["allreduce_calls"]
            or d["backend"] is not None):
        raise AssertionError(f"dist_train_main at world 1 is not "
                             f"train_main: losses {dist['losses']} vs "
                             f"{plain['losses']}, final arrays equal: "
                             f"{same}, dist {d}")
    emit(phase="dist_world1_bitwise", precision="bf16",
         losses=dist["losses"], losses_equal=True,
         final_checkpoint_bitwise=True, dist=d)


def _gang_rank_launches(cfg, ranks: list, steps: int, what: str) -> list:
    """Each rank's K1-K3 launches from its report: as ``train_launches``
    predicts (the counts do not depend on the batch), all on the tensor
    cores.  Returns them per rank."""
    want = train_launches(cfg, steps)
    out = []
    for d in ranks:
        got = d["kernel_launches"]
        if any(got[name]["cuda_core"] or got[name]["tensor_core"]
               != want[name] for name in _Counts.FLASH):
            raise AssertionError(f"{what}: rank {d['rank']} launches {got}, "
                                 f"want {want} on the tensor cores")
        out.append({name: got[name]["tensor_core"] for name in _Counts.FLASH})
    return out


def _max_rel(got, want) -> float:
    return max((abs(g - w) / abs(w) for g, w in zip(got, want)),
               default=0.0)


def dist_gang_full_width(torch, m, counts) -> list:
    """Phase 25: ``run train --full --world_size 2`` (stablelm-1.6b, bf16,
    global batch 8 x 2048) as a subprocess, through ``run_gang_local``:
    two rank processes on ``cuda:0``, gloo (the ranks share the card), each
    running K1-K3 on the tensor cores; its losses against world 1's with
    the same arguments, run in this process first.  With a card per rank
    the ranks take nccl instead, and with four cards 25b runs a world-4
    gang too.  Returns each rank's K1-K3 launches of the world-2 gang."""
    torch.cuda.empty_cache()
    counts.zero()
    t0 = time.perf_counter()
    rc, one = launch_run(m, GANG_ARGV)
    _check_report(rc, one, "run train --full (world 1)")
    one = dict(one["metrics"], call_wall_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    launches = _gang(torch, m, one, 2)
    if torch.cuda.device_count() >= 4:
        _gang(torch, m, one, 4)
    return launches


def _gang(torch, m, one: dict, world: int) -> list:
    """One full-width gang of ``world`` ranks: rank r on ``cuda:{r %
    cards}``, gloo when ranks share a card and nccl when each has its own;
    K1-K3 as ``train_launches`` predicts on the tensor cores; the losses
    within ``GANG_LOSS_RTOL`` of world 1's.  The step time is the mean
    of the steps after the first (a fresh process's first full-width step
    also loads what it runs); the first beside it."""
    cfg = m["get_config"]("stablelm-1.6b")
    cards = torch.cuda.device_count()
    devices = [f"cuda:{r % cards}" for r in range(world)]
    backend = "nccl" if cards >= world else "gloo"
    argv = GANG_ARGV + ["--world_size", str(world)]
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    t0 = time.perf_counter()
    proc = _cli(argv, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"run train --world_size {world}: exit "
                             f"{proc.returncode}: {proc.stderr[-3000:]}"
                             f"{proc.stdout[-3000:]}")
    report = _report_of(proc.stdout)
    met = report["metrics"]
    ranks = met["gang"]["ranks"]
    if (report["status"] != "succeeded"
            or [d["rank"] for d in ranks] != list(range(world))
            or [d["device"] for d in ranks] != devices
            or any(d["backend"] != backend or d["world_size"] != world
                   or d["local_batch"] != 8 // world for d in ranks)):
        raise AssertionError(f"run train --world_size {world}: "
                             f"{report['status']}, ranks {ranks}")
    launches = _gang_rank_launches(cfg, ranks, GANG_STEPS,
                                   f"run train --world_size {world}")
    rel = _max_rel(met["losses"], one["losses"])
    if (len(met["losses"]) != GANG_STEPS
            or not np.all(np.isfinite(met["losses"]))
            or rel > GANG_LOSS_RTOL):
        raise AssertionError(f"world-{world} losses {met['losses']} vs "
                             f"world 1 {one['losses']} (rel {rel})")
    steady = [float(np.mean(d["step_s"][1:])) for d in ranks]
    ar = [d["allreduce_s_per_step"] for d in ranks]
    emit(phase="dist_gang_full_width", argv=argv, status=report["status"],
         backend=backend, devices=devices, losses=met["losses"],
         world1_losses=one["losses"], losses_max_rel_err=rel,
         loss_rtol=GANG_LOSS_RTOL, step_s=max(steady),
         first_step_s=max(d["step_s"][0] for d in ranks),
         rank_step_s=[d["step_s"] for d in ranks],
         world1_step_s=one["pure_step_s"] / one["steps_run"],
         allreduce_s_per_step=ar,
         allreduce_share_of_step=[a / max(steady) for a in ar],
         allgather_s=[d["allgather_s"] for d in ranks],
         reduced_bytes_per_step=[d["reduced_bytes_per_step"] for d in ranks],
         grad_bytes=ranks[0]["grad_bytes"],
         allreduce_bytes_per_step=ranks[0]["allreduce_bytes_per_step"],
         allreduce_calls=[d["allreduce_calls"] for d in ranks],
         agree_calls=[d["agree_calls"] for d in ranks],
         peak_mem_gb=[d["peak_mem_gb"] for d in ranks],
         launches=launches, report_wall_s=report["wall_s"],
         process_wall_s=wall, world1_call_wall_s=one["call_wall_s"],
         parent_reserved_gb=reserved_gb)
    return launches, [d["peak_mem_gb"] for d in ranks]


def dist_gang_chaos(torch, m) -> None:
    """Phase 26: ``Orchestrator.run_cluster`` in this process, a world-2
    gang of the reduced stablelm (bf16) on ``GANG_NODE`` under
    ``ChaosSpec(after_checkpoints=1)``: one rank SIGKILLed once a
    checkpoint is published, the gang requeued whole and resumed."""
    ex = m["executor"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        run = m["RunSpec"](kind="train", arch="stablelm-1.6b", seed=0,
                           name="gang", overrides={
                               **CAMPAIGN_REDUCED, "world_size": 2,
                               "checkpoint_dir": ck})
        pvc = m["PersistentVolume"](os.path.join(tmp, "campaign"))
        orch = m["Orchestrator"](pvc)
        orch.submit_runs([run])
        last_step = {}             # pid -> newest published step at exit

        def spawn(job, attempt, argv, env, stdout, stderr):
            return _LastStepAtExit(
                ex._default_spawn(job, attempt, argv, env, stdout, stderr),
                job.env.get("CHECKPOINT_DIR"), ex._latest_checkpoint_step,
                last_step)

        recs = orch.run_cluster(
            workers=2, spawn=spawn, attempt_timeout_s=600,
            worker_env={"REPRO_STEP_DELAY_S": "0.25"},
            chaos=ex.ChaosSpec(kill_jobs=("gang",), after_checkpoints=1),
            inventory=m["node_specs_from_json"]({"nodes": [GANG_NODE]}))
        events = [json.loads(ln) for ln in pvc.read_bytes(
            ex.EVENTS_REL).decode().splitlines()]
        state = ex.replay_events(events)
        rec = recs["gang"]
        res = json.loads(pvc.read_bytes("results/gang.json"))
        hist = res["attempt_history"]
        kills = [e for e in events if e["event"] == "chaos_kill"]
        started = [e for e in events
                   if e["event"] == "started" and e["job"] == "gang"]
        # rank 0 publishes: the newest step when the killed attempt's
        # rank 0 was seen dead
        killed = last_step.get(started[0]["ranks"][0]["pid"])
        met = rec.result["metrics"]
        resumed = met["resumed_from_step"]
        if (rec.state.value != "Succeeded" or rec.attempts != 2
                or [h["outcome"] for h in hist]
                != ["preempted", "succeeded"]
                or not kills or any("rank" not in e for e in kills)
                or not met["device"].startswith("cuda")
                or met["dist"]["world_size"] != 2 or not killed
                or resumed != killed):
            raise AssertionError(
                f"gang chaos: {rec.state}, {rec.attempts} attempts, history "
                f"{hist}, kills {kills}, resumed from {resumed}, last "
                f"published {killed}, device {met.get('device')}")
        ref_dir = os.path.join(tmp, "ref")
        base = m["train_main"]("stablelm-1.6b", device="cuda",
                               checkpoint_dir=ref_dir, checkpoint_async=False,
                               **CAMPAIGN_REDUCED)
        want, got = base["losses"][resumed:], met["losses"]
        rel = _max_rel(got, want)
        if not got or len(got) != len(want) or rel > GANG_LOSS_RTOL:
            raise AssertionError(f"gang chaos: losses {got} vs world 1 "
                                 f"{want} (rel {rel})")
        load, ls = m["load_checkpoint"], m["list_checkpoints"]
        a, a_step = load(ls(ck)[-1][1])
        b, b_step = load(ls(ref_dir)[-1][1])
        bitwise = (set(a) == set(b) and a_step == b_step
                   and all(np.array_equal(a[k], b[k]) for k in b))
    if not state["ended"] or not state["consistent"]:
        raise AssertionError(f"gang chaos log: {state['violations']}")
    emit(phase="dist_gang_chaos", inventory=GANG_NODE,
         placement="one node, two GPU slots, both this card (cuda:0)",
         attempts=rec.attempts, killed_ranks=[e["rank"] for e in kills],
         killed_after_step=killed, resumed_from_step=resumed, losses=got,
         world1_losses=want, losses_max_rel_err=rel,
         loss_rtol=GANG_LOSS_RTOL,
         final_checkpoint_bitwise_vs_world1=bitwise,
         backend=met["dist"]["backend"], device=met["dist"]["device"],
         consistent=state["consistent"],
         attempt_wall_s=[h["wall_s"] for h in hist],
         phase_wall_s=time.perf_counter() - t0)


# phase 27: the dry run's sweeps over every arch at these shapes, each on
# the meta device in a subprocess of its own (the card's host has no JAX:
# this also proves the import graph), and one cell in this process; the
# decode cells hold fsdp_tp's decode state to the rules' blocks
DRYRUN_SHAPES = ("train_4k", "decode_32k")
# phase 27's sweep: both production meshes under the reference's default
# layout, one rank of each traced on meta beside the one-card trace; it
# runs on the host from before phase 1 and is read after phase 28, with
# this long to finish from there
DRYRUN_MESH, DRYRUN_LAYOUT = "both", "fsdp_tp"
DRYRUN_TIMEOUT = 900
DRYRUN_CELL = ("granite-3-2b", "prefill_32k")
# phase 28: the probe's cells, each run on the card through `run
# perfprobe` in this process at the dry run's one-card batch
PROBE_CELLS = (("stablelm-1.6b", "train_4k"),
               ("granite-3-2b", "prefill_32k"),
               ("mamba2-2.7b", "prefill_32k"),
               ("granite-3-2b", "decode_32k"))
# the probe's steps: a warm-up, the measured step, the profiled step
PROBE_STEPS = 3


# phase 28's attention shapes, which no other phase runs: K1 at
# granite-3-2b x prefill_32k's one-card cut (B 2, S 32 768, granite's
# window of 8192 binding) and K1-K3 at stablelm-1.6b x train_4k's (B 16,
# S 4 096; its window of 8192 does not bind); name, B, S, H, Kh, hd,
# window
LONG_FWD = ("granite_prefill_32k", 2, 32768, 32, 8, 64, 8192)
LONG_BWD = ("stablelm_train_4k", 16, 4096, 32, 32, 64, None)
# K1's rows are held against the plain forward in chunks of this many, on
# the heads of the first and the last kv group (the whole (S, S) scores of
# every head would take 275 GB)
LONG_ROWS = 2048


def _rows_ref(torch, q, k, v, r0: int, window):
    """The plain forward (``ref.attention_ref``'s arithmetic: f32 scores of
    the pre-scaled query, P rounded to V's dtype before P V) for query rows
    ``r0 ..`` of one head, causal (and windowed) from absolute positions.
    q: (R, hd); k, v: (Sk, hd).  Returns ``(out in q's dtype, lse)``."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = (q.float() * scale) @ k.float().T
    qp = torch.arange(r0, r0 + q.shape[0], device=q.device)[:, None]
    kp = torch.arange(k.shape[0], device=q.device)[None, :]
    ok = (kp <= qp) & ((kp > qp - window) if window else True)
    s = torch.where(ok, s, torch.full((), -1e30, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p.to(v.dtype).float() @ v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[:, 0]


def long_sequence_vs_plain(torch, F, fa, ref) -> dict:
    """Phase 28's kernel shapes against their plain versions, in bf16 on
    the tensor cores: K1 at (2, 32 768) causal with a window of 8192, all
    rows of the first and the last kv group's heads in chunks; K2 and K3
    at (16, 4 096) causal,
    every batch row against the plain backward.  Each kernel's time (the
    median of five windows), SDPA's and the bound.  Returns the records by
    kernel name."""
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    recs = {}
    name, B, S, H, Kh, hd, window = LONG_FWD
    q, k, v = rnd(B, S, H, hd), rnd(B, S, Kh, hd), rnd(B, S, Kh, hd)
    kern = fa.flash_attention_fwd_kernel
    before = dict(kern.launches_by_route)
    out, lse = kern(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    if kern.launches_by_route["tensor_core"] != before["tensor_core"] + 1:
        raise AssertionError(f"K1 {name}: not on the tensor cores")
    lse = lse.reshape(B, H, S)
    err_o = err_l = 0.0
    rep = H // Kh
    for b in range(B):
        for h in list(range(rep)) + list(range(H - rep, H)):
            for r0 in range(0, S, LONG_ROWS):
                o_r, l_r = _rows_ref(torch, q[b, r0:r0 + LONG_ROWS, h],
                                     k[b, :, h // rep], v[b, :, h // rep], r0,
                                     window)
                got_o = out[b, r0:r0 + LONG_ROWS, h].float()
                torch.testing.assert_close(got_o, o_r.float(),
                                           atol=TOL["bfloat16"]["o"],
                                           rtol=TOL["bfloat16"]["o"])
                torch.testing.assert_close(lse[b, h, r0:r0 + LONG_ROWS], l_r,
                                           atol=TOL["bfloat16"]["lse"],
                                           rtol=TOL["bfloat16"]["lse"])
                err_o = max(err_o, (got_o - o_r.float()).abs().max().item())
                err_l = max(err_l, (lse[b, h, r0:r0 + LONG_ROWS]
                                    - l_r).abs().max().item())
    del out, lse
    ms, spread = cuda_ms_median(
        torch, lambda: kern(q, k, v, causal=True, window=window), reps=3)
    # SDPA under the window's (S, S) mask: the memory-efficient kernel
    # (the math one would form 275 GB of scores), which takes no GQA, so
    # K and V are repeated to every query head
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(rep, dim=2).transpose(1, 2)
              for x in (k, v))
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_ms, lib_spread = cuda_ms_median(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), reps=3)
    del mask
    bound_ms, bound_by, flops = bound(B, S, S, H, Kh, hd, True, window,
                                      "bfloat16", 2)
    recs["flash_attention_fwd"] = dict(
        shape=name, dims=[B, S, S, H, Kh, hd], window=window, ms=ms,
        ms_min_max=spread, library_ms=lib_ms, library_ms_min_max=lib_spread,
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        max_abs_err_o=err_o, max_abs_err_lse=err_l,
        checked="all rows of heads " + ", ".join(
            map(str, list(range(rep)) + list(range(H - rep, H)))),
        plain_ms=None)
    emit(phase="long_sequence_vs_plain", kernel="flash_attention_fwd",
         **recs["flash_attention_fwd"])
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    name, B, S, H, Kh, hd, window = LONG_BWD
    q, k, v, do = (rnd(B, S, H, hd), rnd(B, S, Kh, hd), rnd(B, S, Kh, hd),
                   rnd(B, S, H, hd))
    out, lse = fa.flash_attention_fwd_kernel(q, k, v, causal=True,
                                                window=None)
    delta = ref.row_delta(out, do)
    kernels = (fa.flash_attention_bwd_dq_kernel,
               fa.flash_attention_bwd_dkv_kernel)
    before = [dict(fn.launches_by_route) for fn in kernels]
    dq, dk, dv = fa.flash_attention_bwd_kernel(q, k, v, do, lse, delta,
                                               causal=True, window=None)
    torch.cuda.synchronize()
    if any(fn.launches_by_route["tensor_core"] != n["tensor_core"] + 1
           for fn, n in zip(kernels, before)):
        raise AssertionError(f"K2/K3 {name}: not on the tensor cores")
    errs = dict.fromkeys(("dq", "dk", "dv"), 0.0)
    lse_b = lse.reshape(B, H, S)
    for b in range(B):
        want = ref.attention_bwd_ref(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], out[b:b + 1],
            lse_b[b].reshape(H, S), do[b:b + 1], causal=True)
        for what, g, w in zip(errs, (dq[b:b + 1], dk[b:b + 1],
                                     dv[b:b + 1]), want):
            torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)
            errs[what] = max(errs[what], (g - w).abs().max().item())
        del want
    del dq, dk, dv
    torch.cuda.empty_cache()
    bounds = bwd_bounds(B, S, S, H, Kh, hd, True, None, "bfloat16", 2)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    lib_ms, lib_spread = cuda_ms_median(torch, lambda: torch.autograd.grad(
        lo, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), reps=3)
    for kname, what, fn in (("flash_attention_bwd_dq", "dq", kernels[0]),
                            ("flash_attention_bwd_dkv", "dkv", kernels[1])):
        ms, spread = cuda_ms_median(torch, lambda: fn(
            q, k, v, do, lse, delta, causal=True, window=None), reps=3)
        recs[kname] = dict(
            shape=name, dims=[B, S, S, H, Kh, hd], ms=ms, ms_min_max=spread,
            library_ms=lib_ms, library_ms_min_max=lib_spread,
            bound_ms=bounds[what]["ms"], bound_by=bounds[what]["by"],
            share_of_bound=bounds[what]["ms"] / ms,
            max_abs_err=(errs["dq"] if what == "dq"
                         else max(errs["dk"], errs["dv"])),
            checked="every batch row", plain_ms=None)
        emit(phase="long_sequence_vs_plain", kernel=kname, **recs[kname])
    del q, k, v, do, out, lse, delta, lo, qt, kt, vt
    torch.cuda.empty_cache()
    return recs


def _kill_group(proc) -> None:
    """SIGKILL ``proc``'s process group (it runs in a session of its own)
    and reap it; a group already gone is fine."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def dryrun_start(shapes) -> list:
    """Start phase 27's sweeps, ``python -m repro_torch.launch run dryrun
    --arch all --shape SHAPE --mesh both --layout fsdp_tp`` for each of
    ``shapes``, each in a process group of its own, writing its records
    to a temporary directory.  They need no card, so they run on the
    host beside the timed phases; the groups are killed when this script
    exits, whatever the exit.  Returns ``[(proc, t0)]``."""
    started = []
    for shape in shapes:
        out_dir = tempfile.mkdtemp()
        argv = [sys.executable, "-m", "repro_torch.launch", "run", "dryrun",
                "--arch", "all", "--shape", shape, "--mesh", DRYRUN_MESH,
                "--layout", DRYRUN_LAYOUT, "--out", out_dir]
        proc = subprocess.Popen(argv,
                                env=dict(os.environ, PYTHONPATH=str(SRC)),
                                cwd=out_dir, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        atexit.register(_kill_group, proc)
        atexit.register(shutil.rmtree, out_dir, True)
        started.append((proc, time.perf_counter()))
    return started


def dryrun_finish(torch, m, sweeps: list) -> dict:
    """Phase 27: each sweep's report (every cell ``ok``, or a structural
    skip: one a mesh for every arch, llama4-maverick's 40 query heads on
    a model axis of 16 included), one line per arch (traced / analytic
    FLOPs, bytes by kind, the one-card fit) and per arch and mesh (the
    rank of the production mesh traced on meta: its peak and whether it
    fits one card, its collective bytes), with the rank's gates: its
    parameters, gradients, optimizer state and decode state the rules'
    per-device bytes (``sharded_bytes``) to the byte (a decode cell's
    ``fsdp_tp`` cache slots of every kv head, SSM heads and conv
    channels), a finite positive traced / analytic FLOPs, and on 2x16x16
    a train cell's ``pod_gradsync`` the count from the shapes to the
    byte; then one cell in this process, which must leave the card's
    allocated memory as it was.  Returns the train sweep's report."""
    reports = [_dryrun_read(m, proc, t0) for proc, t0 in sweeps]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cell = m["dryrun_run_one"](*DRYRUN_CELL, False, "fsdp_tp", None)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if cell["status"] != "ok" or after != before:
        raise AssertionError(f"dryrun {DRYRUN_CELL} in process: "
                             f"{cell['status']} {cell.get('error')}, card "
                             f"memory {before} -> {after}")
    for (proc, _), (report, wall) in zip(sweeps, reports):
        emit(phase="dryrun_sweep", argv=proc.args[2:],
             cells=len(report["metrics"]["results"]),
             ok=report["metrics"]["ok"],
             skipped=report["metrics"]["skipped"],
             sweep_s=report["wall_s"], started_to_read_s=wall,
             in_process_cell=list(DRYRUN_CELL),
             in_process_s=time.perf_counter() - t1,
             in_process_traced_flops=cell["traced_flops"],
             card_memory_allocated=[before, after])
    return reports[0][0]


def _dryrun_read(m, proc, t0: float) -> tuple:
    """One sweep of phase 27, read and gated: ``(report, seconds from its
    start)``."""
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        _kill_group(proc)
    wall = time.perf_counter() - t0
    report = _report_of(out)
    results = report["metrics"]["results"]
    skips = m["STRUCTURAL_SKIPS"]
    bad = [r for r in results if r["status"] != "ok"
           and (r["arch"], r["shape"]) not in skips]
    if proc.returncode != 0 or report["status"] != "succeeded" or bad \
            or len(results) != 2 * len(m["list_archs"]()):
        raise AssertionError(f"run dryrun: exit {proc.returncode}, "
                             f"{report['status']}, cells {bad}: "
                             f"{err[-2000:]}")
    for r in results:
        if r["status"] == "skipped":
            continue
        if r["mesh"] == "16x16":
            emit(phase="dryrun", arch=r["arch"], shape=r["shape"],
                 status=r["status"], traced=r["traced"],
                 traced_flops=r["traced_flops"],
                 traced_over_analytic=r["traced_over_analytic"],
                 bytes_gb={k: v / 1e9 for k, v in (r["bytes"] or {}).items()},
                 peak_gb=r["peak_bytes"] / 1e9,
                 fits_one_card=r["fits_one_card"],
                 max_batch_one_card=r["max_batch_one_card"],
                 peak_gb_one_card=(r["peak_bytes_one_card"] or 0) / 1e9)
        rank = r["rank"]
        coll = rank["collective_bytes"]
        fails = [k for k, v in rank["resident_minus_sharded"].items() if v]
        ratio = rank["traced_over_analytic"]
        if not (np.isfinite(ratio) and ratio > 0):
            fails.append("traced_over_analytic")
        if r["mesh"] == "2x16x16" and rank["bytes"]["grads"] and (
                coll.get("pod_gradsync", 0.0)
                != rank["shape_counts"].get("pod_gradsync")
                or not coll.get("pod_gradsync")):
            fails.append("pod_gradsync")
        emit(phase="dryrun_rank", arch=r["arch"], shape=r["shape"],
             mesh=r["mesh"], layout=r["layout"], grid=rank["grid"],
             rank=rank["rank"], peak_gb=rank["peak_bytes"] / 1e9,
             fits_one_card=rank["fits_one_card"],
             traced_over_analytic=ratio,
             bytes_gb={k: v / 1e9 for k, v in rank["bytes"].items()},
             collective_gb={k: v / 1e9 for k, v in coll.items()},
             analytic_collective_gb={
                 k: v / 1e9 for k, v in
                 rank["analytic_collective_bytes"].items()},
             shape_counts=rank["shape_counts"],
             resident_minus_sharded=rank["resident_minus_sharded"],
             trace_s=rank["trace_s"])
        if fails:
            raise AssertionError(f"dryrun {r['arch']} x {r['shape']} x "
                                 f"{r['mesh']}: the rank fails {fails}: "
                                 f"{rank}")
    return report, wall


def probe_launches(cfg, kind: str) -> dict:
    """K1-K5's launches in one step of a probe cell: a train step's
    (``train_launches``), a prefill's (``prefill_launches``), none in a
    decode step."""
    one = dict.fromkeys(_Counts.ROUTED + ("percentile_norm",), 0)
    if kind == "train":
        one.update(train_launches(cfg, 1))
    elif kind == "prefill":
        one.update(prefill_launches(cfg))
    return one


def perfprobe_cells(torch, m, counts) -> dict:
    """Phase 28: ``run perfprobe`` in this process for each of
    ``PROBE_CELLS`` on the card.  Each report ``succeeded`` on cuda; the
    kernels launched as a step of the cell predicts (three steps: warm-up,
    measured, profiled), every launch on the tensor cores, and the
    record's measured step the same; the peak memory under the budget the
    dry run cut the batch to; the measured step, on the host's clock and
    as the profiled device-busy time (``bound_share`` at most 1), not
    below the analytic lower bound (one faster than the bound means a
    count is wrong); a finite loss or logits.  Returns the launches and
    the profiled kernel times by cell."""
    out = {}
    for arch, shape in PROBE_CELLS:
        torch.cuda.empty_cache()
        argv = ["run", "perfprobe", "--arch", arch, "--shape", shape]
        counts.zero()
        t0 = time.perf_counter()
        rc, report = launch_run(m, argv)
        wall = time.perf_counter() - t0
        launches, routes = counts.read(), counts.routes()
        _check_report(rc, report, " ".join(argv))
        rec = report["metrics"]
        step = probe_launches(m["get_config"](arch), rec["kind"])
        want = {k: PROBE_STEPS * n for k, n in step.items()}
        want_routes = {k: {"tensor_core": want[k], "cuda_core": 0}
                       for k in counts.ROUTED}
        measured = {k: sum(r.values()) for k, r in rec["launches"].items()}
        lower = rec["analytic"]["step_time_lower_bound_s"]
        peak = max(rec["peak_mem_gb"], rec["profile"]["peak_mem_gb"]) * 1e9
        budget = rec["one_card"]["budget_bytes"]
        share = rec["profile_terms"]["bound_share"]
        if (rec["device"] != "cuda" or launches != want
                or routes != want_routes
                or measured != {k: step[k] for k in counts.ROUTED}
                or peak > budget or rec["step_s"] < lower or share > 1
                or not rec["finite"]):
            raise AssertionError(
                f"{' '.join(argv)}: device {rec['device']}, launches "
                f"{launches} (want {want}), routes {routes}, measured step "
                f"{measured}, peak {peak} of {budget}, step {rec['step_s']} "
                f"s and device busy share {share} of the bound {lower} s, "
                f"finite {rec['finite']}")
        prof = rec["profile"]
        emit(phase="perfprobe", arch=arch, shape=shape, cut=rec["cut"],
             batch=rec["batch"], seq=rec["seq"], traced=rec["traced"],
             step_s=rec["step_s"], lower_bound_s=lower,
             dominant=rec["analytic"]["dominant"],
             device_busy_ms=prof["device_busy_ms"],
             idle_share=prof["idle_share"],
             bound_share=share,
             kernel_ms=prof["kernel_ms"], top=prof["top"],
             peak_mem_gb=rec["peak_mem_gb"],
             profiled_peak_mem_gb=prof["peak_mem_gb"],
             estimate_peak_gb=rec["one_card"]["estimate_peak_bytes"] / 1e9,
             traced_peak_gb=rec["one_card"]["traced_peak_bytes"] / 1e9,
             budget_gb=budget / 1e9,
             one_card=rec["one_card"], launches=launches,
             loss=rec.get("loss"), allreduce_bytes=rec["allreduce_bytes"],
             report_wall_s=report["wall_s"], call_wall_s=wall)
        out[f"{arch} x {shape}"] = {"launches": launches,
                                    "kernel_ms": prof["kernel_ms"]}
    return out


# phases 29-31: the parameter-sharded layouts on the data axis.  Phase 29
# runs full-width stablelm-1.6b under fsdp_tp as a world-2 perfprobe gang
# on the one card, beside a dp gang of the same weights, batch and steps;
# phase 30 full-width mamba2-2.7b under fsdp_sp, its depth cut; phase 31
# the sequence-parallel scan through K4
SHARDED_ARGV = ["run", "perfprobe", "--arch", "stablelm-1.6b", "--shape",
                "train_4k", "--layout", "fsdp_tp", "--world_size", "2",
                "--batch", "8", "--seq", "2048"]
# the steps a gang runs: warm-up, measured (a rank's trace is not the
# shared card's, so no profiled step)
SHARDED_STEPS = 2
# FSDP drops half of the resident parameters, gradients and moments
# (13.16 GB at world 1 in bf16) from each of two ranks
SHARDED_PEAK_SAVING_GB = 5.0
# phase 29's dp gang, phase 30's and phase 32's, run one after the other
# by the same two processes of this script (RANK_FLAG): the first two
# through steps.build_train on a data grid; "layers" cuts the depth
# (mamba2's to 4 of 64: the gang is gloo-bound, and its time grows with
# the gathered layers).  Phase 32's ("model": 2) run fsdp_tp on the grid
# {model: 2} at full width, depth and batch cut: a train job (a warm-up
# and a measured step) and serve jobs (a prefill of batch x seq and
# "decode" steps fed seeded tokens), each held against world 1 of the
# same cut, weights and batch in rank 0's process, and a serve job
# against an f32 run too.  Phase 33's ("layout": "fsdp_sp", "model": 2)
# run fsdp_sp on {model: 2}, each rank on its half of the sequence: a train
# job (a warm-up and a measured step), a serve job ("prefill": a prefill
# of batch x seq, its whole logits and the decode state assembled from
# the ranks' blocks, then "decode" steps on the ranks' blocks of the
# state), or both ("train" and "prefill"), each held against world 1 of
# the same cut in rank 0's process, a serve job against an f32 run too.
# "seq_groups": world 1 runs under the mesh's fsdp_sp ctx, whose seq
# groups are the gang's MoE dispatch groups (the capacity counted over
# each block's tokens).  "readings": the train job's gang and world 1 also run seeds 1
# .. readings-1 (build_train's weights and batch); "fault": the gang runs
# seed 0 again with the model all-reduce of the leaves replicated over
# model dropped (``_dropped_model_reduce``), which the gate must fail
RANK_JOBS = {
    "stablelm_dp": {"arch": "stablelm-1.6b", "layers": None, "batch": 8,
                    "seq": 2048, "layout": "dp"},
    "mamba2_fsdp_sp": {"arch": "mamba2-2.7b", "layers": 4, "batch": 4,
                       "seq": 2048, "layout": "fsdp_sp"},
    "stablelm_tp": {"arch": "stablelm-1.6b", "layers": 4, "batch": 4,
                    "seq": 2048, "layout": "fsdp_tp", "model": 2},
    "granite_tp": {"arch": "granite-3-2b", "layers": 4, "batch": 4,
                   "seq": 2048, "layout": "fsdp_tp", "model": 2,
                   "decode": 8, "judged_on": ("logits",)},
    "mamba2_tp": {"arch": "mamba2-2.7b", "layers": 4, "batch": 2,
                  "seq": 2048, "layout": "fsdp_tp", "model": 2,
                  "decode": 8, "judged_on": ("prefill_logits", "state")},
    "qwen3_moe_tp": {"arch": "qwen3-moe-30b-a3b", "layers": 2, "batch": 4,
                     "seq": 2048, "layout": "fsdp_tp", "model": 2,
                     "decode": 8, "judged_on": ("state",)},
    "stablelm_sp": {"arch": "stablelm-1.6b", "layers": 4, "batch": 4,
                    "seq": 2048, "layout": "fsdp_sp", "model": 2,
                    "readings": 4, "fault": True},
    "granite_sp": {"arch": "granite-3-2b", "layers": 4, "batch": 4,
                   "seq": 2048, "layout": "fsdp_sp", "model": 2,
                   "prefill": True, "decode": 8,
                   "judged_on": ("prefill_logits", "state",
                                 "decode_logits")},
    "mamba2_sp": {"arch": "mamba2-2.7b", "layers": 4, "batch": 2,
                  "seq": 2048, "layout": "fsdp_sp", "model": 2,
                  "train": True, "prefill": True, "decode": 8,
                  "slow_decay": True,
                  "judged_on": ("prefill_logits", "state", "decode_logits")},
    "qwen3_moe_sp": {"arch": "qwen3-moe-30b-a3b", "layers": 2, "batch": 4,
                     "seq": 2048, "layout": "fsdp_sp", "model": 2,
                     "train": True, "prefill": True, "decode": 8,
                     "seq_groups": True, "judged_on": ("state",)},
}
MODEL_JOBS = tuple(k for k, j in RANK_JOBS.items() if j.get("model", 1) > 1)
# phase 34: the pod axis, run by a second gang of this script's ranks
# (POD_FLAG), four processes on {pod: 2, data: 1, model: 2}, all on the
# card with gloo: the pods are replicas (parameters replicated, the batch
# split over (pod, data), every gradient summed over the pods once:
# pod_gradsync).  Each job is a RANK_JOBS-style job at full width, depth
# cut; "pod_hash": each rank hashes its parameter blocks after each step,
# and the two pods' hashes must be equal
POD_WORLD = 4
POD_JOBS = {
    "stablelm_pod_tp": {"arch": "stablelm-1.6b", "layers": 4, "batch": 4,
                        "seq": 2048, "layout": "fsdp_tp", "model": 2,
                        "pod": 2, "pod_hash": True},
    "granite_pod_sp": {"arch": "granite-3-2b", "layers": 4, "batch": 4,
                       "seq": 2048, "layout": "fsdp_sp", "model": 2,
                       "pod": 2, "prefill": True, "decode": 8,
                       "judged_on": ("prefill_logits", "state",
                                     "decode_logits")},
}
POD_FLAG = "--pod-rank"
# a model-axis train job's gate: its first loss, first grad_norm and
# second loss against world 1's.  fsdp_tp: GANG_LOSS_RTOL for all three.
# fsdp_sp: a bf16 gradient summed from two blocks' bf16 partials is ~1%
# off world 1's, elementwise at random, which lifts the norm by ~(1%)^2
# / 2; stablelm's four seeds on the H100 read at most 1.46e-5 (first
# loss), 1.15e-4 (grad_norm) and 6.7e-5 (second loss), and the planted
# fault moved the norm 3.2e-3 and 1.0e-2 on the two ranks
TRAIN_RTOL = {
    "fsdp_tp": {"first": GANG_LOSS_RTOL, "grad_norm": GANG_LOSS_RTOL,
                "second": GANG_LOSS_RTOL},
    "fsdp_sp": {"first": 1e-4, "grad_norm": 3e-4, "second": 3e-4},
}
# "slow_decay": the SSD layers' A = -exp(A_log) of -1e-3 .. -1e-2 (the
# init's -1 .. -16 forgets a state within a few tokens, so the other
# rank's segment would add nothing to a block), in the gang and world 1
SLOW_A = (1e-3, 1e-2)
RANK_FLAG = "--sharded-rank"
# B, S, heads, head dim, groups, N, chunk, segments: mamba2-2.7b's widths
SEQ_PARALLEL = (8, 2048, 80, 64, 1, 128, 256, 4)
# one bf16 rounding of an addend: 2**-8 of its magnitude (twice bf16's
# unit roundoff, as each addend may be off by a rounding already)
BF16_ROUNDING = 2.0 ** -8


def _job_config(get_config, job: dict):
    cfg = get_config(job["arch"])
    return (cfg if job["layers"] is None
            else dataclasses.replace(cfg, n_layers=job["layers"]))


def _job_parts(job: dict) -> tuple:
    """``(trains, serves)`` of a ``RANK_JOBS`` job: one with ``decode``
    steps or a ``prefill`` serves, and trains where it says ``train`` or
    does not serve."""
    serves = "decode" in job or bool(job.get("prefill"))
    return not serves or bool(job.get("train")), serves


def _slow_decay(torch, params) -> None:
    """Set every SSD layer's ``A_log`` from ``SLOW_A``, in place (the
    leaf is replicated: each rank holds it whole)."""
    with torch.no_grad():
        for layer in params["layers"]:
            if "ssm" in layer:
                a = layer["ssm"]["A_log"]
                a.copy_(torch.log(torch.linspace(*SLOW_A, a.shape[0],
                                                 device=a.device)))


@contextlib.contextmanager
def _dropped_model_reduce(grid):
    """A planted fault, for the gate to fail: the step's all-reduce of
    the leaves replicated over ``model`` (``FSDP.reduce``; under
    ``fsdp_sp`` each holds one block's partial gradient) skipped."""
    dist, data = grid.dist, grid.group("data")
    real = dist.allreduce_

    def allreduce_(tensors, mechanism="grad_reducescatter", group=None):
        if mechanism == "replicated_allreduce" and group is not data:
            return tensors
        return real(tensors, mechanism=mechanism, group=group)

    dist.allreduce_ = allreduce_
    try:
        yield
    finally:
        del dist.allreduce_


def _port_of_rank() -> dict:
    """What a rank of the gang drives, by name (imported in the rank's
    process, from ``src/`` beside this script)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.analysis.analytic import (collective_bytes_per_chip,
                                               mesh_dims)
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.distributed import init_distributed
    from repro_torch.launch.perfprobe import KERNELS as PROBED
    from repro_torch.launch.steps import build_train, shard_ctx_for
    from repro_torch.models import init_params
    from repro_torch.models.model import (decode_step, init_decode_state,
                                          prefill)
    from repro_torch.sharding import rules, use_ctx
    from repro_torch.sharding.fsdp import FSDP
    from repro_torch.sharding.grid import model_grid
    from repro_torch.sharding.sp import sp_bytes
    from repro_torch.sharding.tp import tp_allreduce_bytes, tp_state_bytes
    from repro_torch.tree import tree_leaves
    return dict(collective_bytes_per_chip=collective_bytes_per_chip,
                mesh_dims=mesh_dims, get_config=get_config,
                make_batch=make_batch, init_distributed=init_distributed,
                PROBED=PROBED, build_train=build_train,
                shard_ctx_for=shard_ctx_for, use_ctx=use_ctx,
                init_params=init_params, decode_step=decode_step,
                init_decode_state=init_decode_state, rules=rules,
                prefill=prefill, FSDP=FSDP, model_grid=model_grid,
                tp_allreduce_bytes=tp_allreduce_bytes,
                tp_state_bytes=tp_state_bytes, sp_bytes=sp_bytes,
                tree_leaves=tree_leaves)


def _world1_ctx(P, job: dict, grid):
    """The ctx world 1 of a model-axis job runs under: the mesh's
    ``fsdp_sp`` ctx where the job says ``seq_groups``, else none."""
    if not job.get("seq_groups"):
        return contextlib.nullcontext()
    return P["use_ctx"](P["shard_ctx_for"](
        {"data": grid.extent("data"), "model": grid.extent("model")},
        job["layout"]))


def _routes(P) -> dict:
    return {k: dict(fn.launches_by_route) for k, fn in P["PROBED"].items()}


def _since(now: dict, then: dict) -> dict:
    return {k: {r: n - then[k][r] for r, n in now[k].items()} for k in now}


def _shape_bytes(torch, P, cfg, job: dict, grid, kind: str, batch: int,
                 seq: int, decode: int = 0) -> dict:
    """The port's count from the shapes of a model-axis job's bytes by
    mechanism: ``tp_allreduce`` under fsdp_tp (and a serve job's decode
    state mechanisms, ``tp_state_bytes``), every sequence-parallel
    mechanism under fsdp_sp, of a step, or of a prefill and ``decode``
    steps on a cache of ``seq + decode`` slots."""
    M = grid.extent("model")
    esize = getattr(torch, cfg.param_dtype).itemsize
    if job["layout"] == "fsdp_sp":
        got = P["sp_bytes"](cfg, batch, seq, kind, M, esize)
        if kind != "train":
            step = P["sp_bytes"](cfg, batch, seq + decode, "decode", M,
                                 esize)
            got = {k: v + decode * step[k] for k, v in got.items()}
        return got
    if kind == "train":
        return {"tp_allreduce": P["tp_allreduce_bytes"](
            cfg, batch, seq, "train", M, esize)}
    got = {"tp_allreduce": sum(
        k * P["tp_allreduce_bytes"](cfg, batch, s, part, M, esize)
        for k, s, part in ((1, seq, "prefill"), (decode, 1, "decode")))}
    pre, step = (P["tp_state_bytes"](cfg, batch, seq + decode, part, M,
                                     esize) for part in ("prefill", "decode"))
    got.update({k: pre[k] + decode * step[k] for k in pre})
    return got


def _nbytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def _params_hash(torch, P, tree) -> str:
    """A sha256 of every parameter block's bytes, leaf by leaf: equal on
    two ranks that hold bit-for-bit equal blocks."""
    import hashlib
    h = hashlib.sha256()
    for t in P["tree_leaves"](tree):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _job_mesh(grid) -> dict:
    """A job's grid as the record states it (the pod axis where it has
    one)."""
    mesh = {"data": grid.extent("data"), "model": grid.extent("model")}
    return ({"pod": grid.extent("pod"), **mesh} if grid.extent("pod") > 1
            else mesh)


def _rank_train_job(torch, P, cfg, job: dict, grid) -> dict:
    """A train job on one rank: a warm-up and a measured step through
    ``steps.build_train`` on ``grid``; on a model axis, rank 0 then runs
    world 1 of the same cut, weights and batch (two steps, the peak of
    the second), and the job's ``readings`` and ``fault`` runs follow.
    On a pod axis the rank's rows are its block over (pod, data), the
    record holds the count from the shapes of ``pod_gradsync`` and, where
    the job says ``pod_hash``, its parameter blocks' hash after each
    step."""
    ctx, dev = grid.dist, grid.device
    B, S = job["batch"], job["seq"]
    mesh = _job_mesh(grid)
    rows = B // grid.group("batch").size

    def two_steps(layout, g, seed=0):
        fn, (state, batch) = P["build_train"](cfg, B, S, device=dev,
                                              layout=layout, grid=g,
                                              seed=seed)
        if job.get("slow_decay"):
            _slow_decay(torch, state.params)
        hashes = []
        state, met = fn(state, batch)
        losses, norms = [float(met["loss"])], [float(met["grad_norm"])]
        if job.get("pod_hash") and g is not None:
            hashes.append(_params_hash(torch, P, state.params))
        if g is not None and g.world_size > 1:
            torch.distributed.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        launched, sent = _routes(P), dict(ctx.collective_bytes)
        t0 = time.perf_counter()
        state, met = fn(state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        torch.cuda.synchronize(dev)
        rec = {"losses": losses, "grad_norms": norms,
               "step_s": time.perf_counter() - t0,
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "collective_bytes": {k: v - sent.get(k, 0.0) for k, v in
                                    ctx.collective_bytes.items()},
               "kernel_launches": _since(_routes(P), launched)}
        if hashes:
            rec["params_hash"] = hashes + [_params_hash(torch, P,
                                                        state.params)]
        fsdp = getattr(fn, "fsdp", None)
        if g is not None and fsdp is not None and g.extent("pod") > 1:
            rec["pod_gradsync_shape"] = fsdp.pod_gradsync_bytes(
                state.params)
        del fn, state, batch, met
        torch.cuda.empty_cache()
        return rec

    def scalars(r):
        return {k: r[k] for k in ("losses", "grad_norms")}

    rec = {"rank": grid.rank, "backend": ctx.backend, "device": str(dev),
           "grid": mesh, **two_steps(job["layout"], grid),
           "analytic_collective_bytes": P["collective_bytes_per_chip"](
               cfg, B, S, "train", P["mesh_dims"](mesh), job["layout"])}
    if mesh["model"] > 1:
        rec["shape_bytes"] = _shape_bytes(torch, P, cfg, job, grid, "train",
                                          rows, S)
        if "pod_gradsync_shape" in rec:
            rec["shape_bytes"]["pod_gradsync"] = rec["pod_gradsync_shape"]
        if grid.rank == 0:
            with _world1_ctx(P, job, grid):
                one = two_steps("dp", None)
            rec["world1"] = {k: one[k] for k in ("losses", "grad_norms",
                                                 "step_s", "peak_mem_gb")}
        rec["readings"] = []
        for seed in range(1, job.get("readings", 1)):
            got = {"seed": seed,
                   **scalars(two_steps(job["layout"], grid, seed))}
            if grid.rank == 0:
                with _world1_ctx(P, job, grid):
                    got["world1"] = scalars(two_steps("dp", None, seed))
            rec["readings"].append(got)
        if job.get("fault"):
            with _dropped_model_reduce(grid):
                rec["fault"] = scalars(two_steps(job["layout"], grid))
    return rec


def _rank_serve_job(torch, P, cfg, job: dict, grid) -> dict:
    """A serve job on one rank of the model axis under the job's layout:
    the full weights from seed 0 (the SSD decays slowed where the job
    says) kept as the rank's blocks (``FSDP.shard_tree``), a prefill of
    ``make_batch``'s tokens and ``decode`` steps fed seeded tokens (on
    the ranks' blocks of the state, the cache ``seq + decode`` slots),
    the whole logits of each and the decode state after the prefill
    assembled from the ranks' blocks.  Rank 0 then runs world 1 of the
    same cut, weights, batch and tokens in bf16 through the kernels, and
    in f32 through the plain versions (both under the mesh's ctx where
    the job says ``seq_groups``), and returns the relative distances of
    the gang's and of world 1's logits (all, the prefill's, the decode
    steps') and state from the f32 run's, and of the gang's from world
    1's (``_rel``, ``_state_rel``; the state also leaf by leaf)."""
    import dataclasses as dc
    dev, ctx = grid.device, grid.dist
    B, S, n = job["batch"], job["seq"], job.get("decode", 0)
    # the rank's rows: its block over (pod, data); world 1 runs them all
    index, count = grid.batch_block(B)
    mine = slice(index * B // count, (index + 1) * B // count)

    def weights():
        params = P["init_params"](
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if job.get("slow_decay"):
            _slow_decay(torch, params)
        return params

    batch = P["make_batch"](cfg, B, S, 0, device=dev)
    toks = torch.randint(cfg.vocab, (n, B, 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(32))

    def serve(p, c, fsdp):
        """(logits of the prefill and each step, the prefill's decode
        state whole, the rank's block shapes of it, prefill s, decode s
        a step) on the host clock, a gang's from a barrier; a gang's of
        the rank's rows."""
        rows = slice(None) if fsdp is None else mine
        if fsdp is not None:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        logits, state = P["prefill"](p, c, {k: v[rows] for k, v in
                                            batch.items()}, S + n,
                                     fsdp=fsdp)
        torch.cuda.synchronize(dev)
        prefill_s = time.perf_counter() - t0
        shapes = {k: list(v.shape) for k, v in state.items()}
        held = [_nbytes(state)]
        st = (state if fsdp is None
              else (fsdp.sp or fsdp.tp).full_decode_state(state, c, S + n))
        st = {k: v.clone() for k, v in st.items()}
        outs = [logits.float()]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(n):
            tok = toks[i][rows]
            pos = torch.full((tok.shape[0],), S + i, dtype=torch.int32,
                             device=dev)
            logits, state = P["decode_step"](p, c, state, tok, pos,
                                             fsdp=fsdp, cache_len=S + n)
            outs.append(logits.float())
        torch.cuda.synchronize(dev)
        held.append(_nbytes(state))
        return (torch.stack(outs), st, shapes, prefill_s,
                (time.perf_counter() - t0) / n if n else None, held)

    params = weights()
    fsdp = P["FSDP"](grid, params, job["layout"], cfg)
    shards = fsdp.shard_tree(params)
    del params                 # the rank keeps its blocks only
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    launched, sent = _routes(P), dict(ctx.collective_bytes)
    logits, st, shapes, prefill_s, decode_s, held = serve(shards, cfg, fsdp)
    mesh = _job_mesh(grid)
    # the rules' per-device bytes of the whole batch's decode state
    whole = P["init_decode_state"](cfg, B, S + n, device="meta")
    rules = P["rules"]
    rec = {"rank": grid.rank, "backend": ctx.backend, "device": str(dev),
           "grid": mesh, "rows": [mine.start, mine.stop],
           "prefill_s": prefill_s, "decode_s_per_step": decode_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "kernel_launches": _since(_routes(P), launched),
           "collective_bytes": {k: v - sent.get(k, 0.0) for k, v in
                                ctx.collective_bytes.items()},
           "state_shapes": shapes,
           "state_bytes": {"prefill": held[0], "decode": held[1]},
           "rules_state_bytes": rules.per_device_bytes(
               whole, rules.decode_state_shardings(whole, mesh,
                                                   job["layout"]), mesh),
           "shape_bytes": _shape_bytes(torch, P, cfg, job, grid, "prefill",
                                       mine.stop - mine.start, S, n),
           # the analytic model has no term for the decode state's
           # mechanisms (state_reshard, qkv_allgather, softmax_combine,
           # xbc_allgather, conv_allgather): printed beside the count
           "analytic_collective_bytes": {
               part: P["collective_bytes_per_chip"](
                   cfg, B, seq, part, P["mesh_dims"](mesh), job["layout"])
               for part, seq in (("prefill", S), ("decode", S + n))}}
    del shards, fsdp
    torch.cuda.empty_cache()
    if grid.rank == 0:
        torch.cuda.reset_peak_memory_stats(dev)
        params = weights()
        c32 = dc.replace(cfg, param_dtype="float32",
                         attention_backend="torch", mixer_backend="torch")
        with _world1_ctx(P, job, grid):
            one, one_st, _, one_prefill_s, one_decode_s, _ = serve(
                params, cfg, None)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            ref, ref_st, _, _, _, _ = serve(
                _map(params, lambda t: t.float()), c32, None)
        # the gang's rank holds its rows: world 1 is judged on the same
        one, ref = one[:, mine], ref[:, mine]
        one_st = {k: v[:, mine] for k, v in one_st.items()}
        ref_st = {k: v[:, mine] for k, v in ref_st.items()}

        def rels(x, st):
            out = {"logits": _rel(x, ref), "prefill_logits": _rel(x[0],
                                                                  ref[0]),
                   "state": _state_rel(st, ref_st)}
            if n:
                out["decode_logits"] = _rel(x[1:], ref[1:])
            return out

        rec["world1"] = {
            "peak_mem_gb": peak, "prefill_s": one_prefill_s,
            "decode_s_per_step": one_decode_s,
            "rel_err_vs_f32": rels(one, one_st),
            "gang_rel_err_vs_f32": rels(logits, st),
            "gang_rel_err_vs_world1": {
                "logits": _rel(logits, one), "state": _state_rel(st, one_st),
                **({"decode_logits": _rel(logits[1:], one[1:])} if n
                   else {}),
                **{k: _state_rel({k: st[k]}, {k: one_st[k]})
                   for k in one_st}},
            "argmax_agree_gang_world1": int((logits.argmax(-1)
                                             == one.argmax(-1)).sum().item()),
            "finite": bool(torch.isfinite(logits).all().item())}
        del params, one_st, ref_st
        torch.cuda.empty_cache()
    return rec


def sharded_rank(rank: int, coordinator: str, world: int = 2,
                 jobs: dict = RANK_JOBS) -> int:
    """One rank of a gang of this script's ranks (run with ``RANK_FLAG
    RANK COORDINATOR``: ``RANK_JOBS`` by two ranks; with ``POD_FLAG``:
    ``POD_JOBS`` by ``POD_WORLD``), every rank on ``cuda:0`` with gloo:
    each job on its grid (a data grid, ``{model: 2}``, or ``{pod: 2,
    data: 1, model: 2}``), its memory freed before the next.  Prints, as
    its last line, each job's record: the losses (train) or the serve
    times, the collective bytes by mechanism, K1-K4's launches by route,
    step time and peak memory, and on a model axis the port's count from
    the shapes (``tp_allreduce`` under fsdp_tp, every sequence-parallel
    mechanism under fsdp_sp, ``pod_gradsync`` on a pod axis) and, in rank
    0's, world 1's numbers."""
    import torch
    P = _port_of_rank()
    ctx = P["init_distributed"](world, rank, coordinator)
    out = {}
    try:
        for name, job in jobs.items():
            cfg = _job_config(P["get_config"], job)
            grid = P["model_grid"](ctx, job.get("model", 1),
                                   job.get("pod", 1))
            trains, serves = _job_parts(job)
            rec = (_rank_train_job(torch, P, cfg, job, grid) if trains
                   else {})
            if serves:
                got = _rank_serve_job(torch, P, cfg, job, grid)
                rec = dict(rec, serve=got) if trains else got
            out[name] = rec
    finally:
        ctx.close()
    print(json.dumps(out), flush=True)
    return 0


def rank_jobs_gang(torch, timeout: int = 600, flag: str = RANK_FLAG,
                   world: int = 2, jobs: dict = RANK_JOBS) -> dict:
    """A gang of this script's ranks: ``world`` processes with ``flag``
    (``RANK_JOBS`` by two; ``POD_FLAG``: ``POD_JOBS`` by ``POD_WORLD``),
    each in a process group of its own, killed whole when the gang ends;
    their output in files.  Returns each job's rank records (all on
    ``cuda:0`` with gloo, a finite loss at each step) and the gang's wall
    seconds under ``"wall_s"``."""
    from repro_torch.distributed.gang import free_port
    torch.cuda.empty_cache()
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for r in range(world):
                with open(os.path.join(tmp, f"{r}.out"), "w") as out, \
                        open(os.path.join(tmp, f"{r}.err"), "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         flag, str(r), coordinator], env=env, cwd=tmp,
                        stdout=out, stderr=err, start_new_session=True))
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.1)
        finally:
            for p in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        logs = [(Path(tmp, f"{r}.out").read_text(),
                 Path(tmp, f"{r}.err").read_text()) for r in range(world)]
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise AssertionError(f"{flag} gang: exit codes {rcs}: " + "".join(
            f"rank {r}: {err[-3000:]}{out[-2000:]}"
            for r, (out, err) in enumerate(logs)))
    ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in logs]
    got = {name: [rk[name] for rk in ranks] for name in jobs}
    for name, recs in got.items():
        _check_gang_ranks(recs, recs[0].get("losses"), f"{flag} {name}")
    return dict(got, wall_s=time.perf_counter() - t0)


def pod_gang(torch) -> dict:
    """Phase 34's subprocesses: the gang of ``POD_JOBS``, ``POD_WORLD``
    ranks of this script with ``POD_FLAG`` (beside phase 20)."""
    return rank_jobs_gang(torch, flag=POD_FLAG, world=POD_WORLD,
                          jobs=POD_JOBS)


def _check_gang_ranks(ranks: list, losses, what: str) -> None:
    """Every rank on ``cuda:0`` with gloo, in rank order, a finite loss
    at every step (``losses`` None: a serve job, which has none)."""
    if ([d["rank"] for d in ranks] != list(range(len(ranks)))
            or any(d["device"] != "cuda:0" or d["backend"] != "gloo"
                   for d in ranks)
            or (losses is not None and (len(losses) != SHARDED_STEPS
                                        or not np.all(np.isfinite(losses))))):
        raise AssertionError(f"{what}: losses {losses}, ranks {ranks}")


class _Background:
    """``fn(*args)`` in a thread, started at once; :meth:`result` joins
    it and returns its value or raises its exception."""

    def __init__(self, fn, *args):
        self.out = {}

        def run():
            try:
                self.out["value"] = fn(*args)
            except BaseException as e:      # re-raised by result()
                self.out["error"] = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["value"]


def sharded_gangs(torch) -> tuple:
    """The subprocesses of phases 29-32, one after the other: the gang of
    ``RANK_JOBS`` (:func:`rank_jobs_gang`), then phase 29's probe gang
    (``SHARDED_ARGV``).  Returns the rank gang's jobs and ``(the probe's
    CompletedProcess, its wall s)``."""
    jobs = rank_jobs_gang(torch)
    t0 = time.perf_counter()
    proc = _cli(SHARDED_ARGV, timeout=600)
    return jobs, (proc, time.perf_counter() - t0)


def sharded_gang_full_width(torch, m, dp_gang_peaks: list, dp: list,
                            probe: tuple) -> list:
    """Phase 29: ``run perfprobe --layout fsdp_tp --world_size 2`` on
    full-width stablelm-1.6b (bf16, global 8 x 2048, a warm-up and a
    measured step) as a subprocess: each rank keeps its half of every
    sharded parameter and moment, gathers each layer inside its
    checkpointed forward (and again in the recompute) and gets its
    gradients reduce-scattered.  ``dp`` is the ranks' records of
    ``RANK_JOBS["stablelm_dp"]``, the dp gang of the same weights, batch
    and steps.  The two losses within ``GANG_LOSS_RTOL`` of the dp gang's;
    each rank's peak at least ``SHARDED_PEAK_SAVING_GB`` under phase 25's
    dp gang at the same batch; each rank's collective bytes of the
    measured step by mechanism beside ``collective_bytes_per_chip`` for
    {data: 2, model: 1} (the gathers between half and all of it: the
    embedding and the head are gathered once, the layers twice; the
    reduce-scatter within 1% below it: the norms are all-reduced
    instead); K1-K3 as a training step predicts, on the tensor cores, in
    both gangs.  ``probe`` is the probe gang's run (:func:`sharded_gangs`,
    beside phase 20).  Returns each rank's K1-K3 launches in the measured
    step."""
    cfg = m["get_config"]("stablelm-1.6b")
    what = " ".join(SHARDED_ARGV)
    proc, wall = probe
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}{proc.stdout[-3000:]}")
    report = _report_of(proc.stdout)
    fs = report["metrics"]
    ranks = fs["gang"]["ranks"]
    if report["status"] != "succeeded":
        raise AssertionError(f"{what}: {report['status']}")
    _check_gang_ranks(ranks, fs["losses"], what)
    _gang_rank_launches(cfg, dp, 1, "the dp gang of phase 29")
    rel = _max_rel(fs["losses"], dp[0]["losses"])
    peaks = [d["peak_mem_gb"] for d in ranks]
    analytic = fs["analytic_collective_bytes"]
    measured = [d["collective_bytes"] for d in ranks]
    launches = _gang_rank_launches(cfg, ranks, 1, what)
    if (rel > GANG_LOSS_RTOL
            or any(p > q - SHARDED_PEAK_SAVING_GB
                   for p, q in zip(peaks, dp_gang_peaks))
            or any(not 0.5 * analytic["fsdp_allgather"]
                   < b["fsdp_allgather"] <= analytic["fsdp_allgather"]
                   or not 0.99 * analytic["grad_reducescatter"]
                   < b["grad_reducescatter"]
                   <= analytic["grad_reducescatter"] for b in measured)):
        raise AssertionError(
            f"fsdp_tp gang: losses {fs['losses']} vs dp "
            f"{dp[0]['losses']} (rel {rel}); peaks {peaks} GB vs phase "
            f"25's {dp_gang_peaks}; bytes {measured} vs analytic {analytic}")
    emit(phase="sharded_gang_full_width", card=card_line(),
         argv=SHARDED_ARGV, cut=fs["cut"], losses=fs["losses"],
         dp_losses=dp[0]["losses"], losses_max_rel_err=rel,
         loss_rtol=GANG_LOSS_RTOL, peak_mem_gb=peaks,
         dp_peak_mem_gb=[d["peak_mem_gb"] for d in dp],
         phase25_dp_peak_mem_gb=dp_gang_peaks,
         collective_bytes=measured,
         dp_collective_bytes=[d["collective_bytes"] for d in dp],
         analytic_collective_bytes=analytic,
         dp_analytic_collective_bytes=dp[0]["analytic_collective_bytes"],
         step_s=[d["step_s"] for d in ranks],
         dp_step_s=[d["step_s"] for d in dp],
         launches=launches, process_wall_s=wall)
    return launches


def sharded_mamba2(torch, m, ranks: list, gang_wall_s: float) -> list:
    """Phase 30: ``RANK_JOBS["mamba2_fsdp_sp"]``, full-width mamba2-2.7b
    under ``fsdp_sp`` (bf16, global 4 x 2048, its depth cut to 4 of 64
    layers) as a world-2 gang sharing the card: each rank's K4 launches
    as a training step predicts, on the tensor cores; the ranks' losses
    equal; its collective bytes beside the analytic model's.  Returns
    each rank's K4 launches in the measured step."""
    job = RANK_JOBS["mamba2_fsdp_sp"]
    want = train_launches(_job_config(m["get_config"], job), 1)["ssd_scan"]
    got = [d["kernel_launches"]["ssd_scan"] for d in ranks]
    losses = [d["losses"] for d in ranks]
    if (any(g != {"tensor_core": want, "cuda_core": 0} for g in got)
            or losses[1] != losses[0]):
        raise AssertionError(f"fsdp_sp mamba2: K4 launches {got}, want "
                             f"{want} on the tensor cores; losses {losses}")
    emit(phase="sharded_mamba2", card=card_line(), job=job,
         losses=losses[0], peak_mem_gb=[d["peak_mem_gb"] for d in ranks],
         collective_bytes=[d["collective_bytes"] for d in ranks],
         analytic_collective_bytes=ranks[0]["analytic_collective_bytes"],
         step_s=[d["step_s"] for d in ranks],
         launches=[g["tensor_core"] for g in got],
         rank_gang_wall_s=gang_wall_s)
    return [g["tensor_core"] for g in got]


def _gang_launches(cfg, job: dict, ranks: list, what: str) -> dict:
    """Each rank's K1-K4 launches in a model-axis job: its measured train
    step's as ``train_launches`` predicts for one step, its serving's as
    ``prefill_launches`` predicts for one prefill (a decode step launches
    none), all on the tensor cores.  Returns the launched kernels' counts
    per rank, by part."""
    trains, serves = _job_parts(job)
    parts = {}
    if trains:
        parts["train"] = (train_launches(cfg, 1),
                          [d["kernel_launches"] for d in ranks])
    if serves:
        parts["serve"] = (prefill_launches(cfg), [
            (d["serve"] if trains else d)["kernel_launches"] for d in ranks])
    out = {}
    for part, (want, got) in parts.items():
        want = {k: v for k, v in want.items() if v}
        for name in _Counts.ROUTED:
            each = [g[name] for g in got]
            if any(g != {"tensor_core": want.get(name, 0), "cuda_core": 0}
                   for g in each):
                raise AssertionError(
                    f"{what} {part}: {name} launches {each}, want "
                    f"{want.get(name, 0)} on the tensor cores")
            if name in want:
                out.setdefault(name, {})[part] = [g["tensor_core"]
                                                  for g in each]
    return out


def _shape_bytes_differ(rec: dict) -> list:
    """The mechanisms whose bytes in a rank's record differ from the
    port's count from the shapes (``shape_bytes``), to the byte."""
    got = rec["collective_bytes"]
    return [k for k, v in rec["shape_bytes"].items()
            if got.get(k, 0.0) != v]


def _train_gate(layout: str, ranks: list) -> dict:
    """A model-axis train job's first loss, first ``grad_norm`` and
    second loss against world 1's (``TRAIN_RTOL``) at seed 0 and at each
    of the job's ``readings``, and the ranks' agreement: on every loss,
    and under fsdp_sp on every ``grad_norm`` too (each rank counts the
    leaves replicated over model from its own copy, which the model
    all-reduce makes one).  Each entry's ``fails`` lists what it fails;
    the ``fault`` run's must not be empty."""
    lim = TRAIN_RTOL[layout]
    keys = ("losses", "grad_norms") if layout == "fsdp_sp" else ("losses",)

    def judge(mine, other, one):
        rel = {"first": _max_rel([mine["losses"][0]], [one["losses"][0]]),
               "grad_norm": _max_rel([mine["grad_norms"][0]],
                                     [one["grad_norms"][0]]),
               "second": _max_rel([mine["losses"][1]], [one["losses"][1]])}
        fails = [k for k, v in rel.items() if v > lim[k]]
        if any(mine[k] != other[k] for k in keys):
            fails.append("ranks")
        return {"rel_err_vs_world1": rel, "fails": fails}

    a, b = ranks
    out = {"seeds": [{"seed": 0, **judge(a, b, a["world1"])}] + [
        {"seed": r["seed"], "losses": r["losses"],
         "grad_norms": r["grad_norms"], "world1": r["world1"],
         **judge(r, s, r["world1"])}
        for r, s in zip(a["readings"], b["readings"])]}
    if "fault" in a:
        out["fault"] = {"grad_norms": [a["fault"]["grad_norms"],
                                       b["fault"]["grad_norms"]],
                        **judge(a["fault"], b["fault"], a["world1"])}
    return out


def model_axis_gangs(torch, m, jobs: dict) -> dict:
    """Phases 32 and 33: ``fsdp_tp`` and ``fsdp_sp`` on the grid
    ``{model: 2}``, run by the ``RANK_FLAG`` gang (both ranks on
    ``cuda:0``, gloo; ``MODEL_JOBS``).  Under fsdp_tp each rank computes
    its half of the heads, MLP columns, SSM heads, experts and
    vocabulary; under fsdp_sp its half of the sequence: K1-K3 run its
    1024 queries against the 2048 gathered keys at q_offset 0 and 1024,
    K4 its segment from a zero state (mamba2's decays slowed,
    ``SLOW_A``, so that the exchanged state counts).  Gates: a train
    job's readings within ``TRAIN_RTOL`` of world 1's and its ranks
    agreeing, and its planted ``fault`` failing that
    (:func:`_train_gate`); a serve job's logits or decode state (its
    ``judged_on``) no more than twice as far from the f32 run's as world
    1's bf16 run (the repo's prefill gate rule: a partial sum adds a bf16
    rounding before its reduction), under fsdp_sp the assembled K/V
    cache no farther from world 1's than world 1's state is from f32;
    every rank's bytes by mechanism the port's count from the shapes
    (``tp_allreduce_bytes``, ``sp_bytes``), to the byte; under fsdp_sp
    each rank's peak memory under world 1's; K1-K4 launched
    as one step or one prefill predicts, on the tensor cores.  Reports
    each rank's bytes by mechanism (a train job's beside the analytic
    model's for ``{data: 1, model: 2}``), peak memory and host times
    beside world 1's.  Returns the launches by layout and job, per rank
    and part."""
    launches = {"fsdp_tp": {}, "fsdp_sp": {}}
    for name in MODEL_JOBS:
        job, ranks = RANK_JOBS[name], jobs[name]
        layout = job["layout"]
        cfg = _job_config(m["get_config"], job)
        what = f"{name} ({cfg.name}, {job['layers']} layers, {layout})"
        got = launches[layout][name] = _gang_launches(cfg, job, ranks, what)
        rec, bad = {"job": job, "launches": got}, []
        trains, serves = _job_parts(job)
        if trains:
            a, one = ranks[0], ranks[0]["world1"]
            gate = _train_gate(layout, ranks)
            rec.update(losses=a["losses"], grad_norms=a["grad_norms"],
                       world1_losses=one["losses"],
                       world1_grad_norms=one["grad_norms"],
                       step_s=[d["step_s"] for d in ranks],
                       world1_step_s=one["step_s"],
                       peak_mem_gb=[d["peak_mem_gb"] for d in ranks],
                       world1_peak_mem_gb=one["peak_mem_gb"],
                       collective_bytes=[d["collective_bytes"]
                                         for d in ranks],
                       shape_bytes=a["shape_bytes"],
                       analytic_collective_bytes=a[
                           "analytic_collective_bytes"], **gate)
            bad += [f"seed {r['seed']}: {r['fails']}" for r in gate["seeds"]
                    if r["fails"]]
            if "fault" in gate and not gate["fault"]["fails"]:
                bad.append("the planted fault passed the gate")
            bad += [f"train bytes {k}" for d in ranks
                    for k in _shape_bytes_differ(d)]
            if layout == "fsdp_sp" and any(
                    d["peak_mem_gb"] >= one["peak_mem_gb"] for d in ranks):
                bad.append("a rank's train peak not under world 1's")
        if serves:
            pre = [d["serve"] if trains else d for d in ranks]
            one = pre[0]["world1"]
            gang, w1 = one["gang_rel_err_vs_f32"], one["rel_err_vs_f32"]
            rec["serve"] = {
                "prefill_s": [d["prefill_s"] for d in pre],
                "decode_s_per_step": [d["decode_s_per_step"] for d in pre],
                "peak_mem_gb": [d["peak_mem_gb"] for d in pre],
                "collective_bytes": [d["collective_bytes"] for d in pre],
                "shape_bytes": pre[0]["shape_bytes"],
                "analytic_collective_bytes": pre[0][
                    "analytic_collective_bytes"],
                "state_shapes": [d["state_shapes"] for d in pre],
                "state_bytes": [d["state_bytes"] for d in pre],
                "rules_state_bytes": pre[0]["rules_state_bytes"],
                "world1": one}
            bad += [k for k in job["judged_on"] if gang[k] > 2 * w1[k]]
            # each rank holds exactly the rules' block of the state
            bad += [f"rank {d['rank']} state bytes {d['state_bytes']}"
                    for d in pre if set(d["state_bytes"].values())
                    != {d["rules_state_bytes"]}]
            bad += [] if one["finite"] else ["finite"]
            if layout == "fsdp_sp":
                # the K/V cache no farther from world 1's than world 1's
                # state is from the f32 run's: equal within bf16
                kv = [one["gang_rel_err_vs_world1"][k] for k in ("k", "v")
                      if k in one["gang_rel_err_vs_world1"]]
                if any(e > w1["state"] for e in kv):
                    bad.append("kv cache vs world 1")
            bad += [f"serve bytes {k}" for d in pre
                    for k in _shape_bytes_differ(d)]
            if layout == "fsdp_sp" and any(
                    d["peak_mem_gb"] >= one["peak_mem_gb"] for d in pre):
                bad.append("a rank's serve peak not under world 1's")
        emit(phase={"fsdp_tp": "tp_gang", "fsdp_sp": "sp_gang"}[layout],
             name=name, card=card_line(), **rec)
        if bad:
            raise AssertionError(f"{what}: {bad}: {rec}")
    return launches


def pod_axis_gang(torch, m, jobs: dict) -> dict:
    """Phase 34: the pod axis, ``POD_JOBS`` run by the ``POD_FLAG`` gang
    (``POD_WORLD`` ranks on ``cuda:0``, gloo) on ``{pod: 2, data: 1,
    model: 2}``: each pod a replica of the other, its rows half the global
    batch.  (a) stablelm-1.6b ``fsdp_tp`` training (4 layers, 4 x 2048,
    two rows a pod): every rank's first loss, first ``grad_norm`` and
    second loss within ``GANG_LOSS_RTOL`` of world 1 (rank 0), the ranks'
    losses equal, the two pods' parameter blocks bit for bit equal after
    each step (ranks ``r`` and ``r + 2``), every rank's bytes by
    mechanism the counts from the shapes (``tp_allreduce`` and
    ``pod_gradsync``) to the byte, beside the analytic model's; (b)
    granite-3-2b ``fsdp_sp``, a prefill of 4 x 2048 and 8 decode steps,
    each rank on its rows and its half of the sequence and the cache,
    judged as phase 33 judges its serve jobs (rank 0's rows no more than
    twice as far from an f32 run as world 1's bf16 run).  K1-K4 as one
    step or one prefill predicts, on the tensor cores.  Reports each
    rank's peak and host times beside world 1's.  Returns the launches by
    job, per rank and part."""
    launches = {}
    for name, job in POD_JOBS.items():
        ranks = jobs[name]
        cfg = _job_config(m["get_config"], job)
        what = (f"{name} ({cfg.name}, {job['layers']} layers, "
                f"{job['layout']}, pod 2 x model 2)")
        got = launches[name] = _gang_launches(cfg, job, ranks, what)
        rec, bad = {"job": job, "launches": got,
                    "grid": ranks[0]["grid"]}, []
        trains, serves = _job_parts(job)
        if trains:
            one = ranks[0]["world1"]
            rel = {"first": _max_rel([d["losses"][0] for d in ranks],
                                     [one["losses"][0]] * len(ranks)),
                   "grad_norm": _max_rel(
                       [d["grad_norms"][0] for d in ranks],
                       [one["grad_norms"][0]] * len(ranks)),
                   "second": _max_rel([d["losses"][1] for d in ranks],
                                      [one["losses"][1]] * len(ranks))}
            bad += [k for k, v in rel.items() if v > GANG_LOSS_RTOL]
            if any(d["losses"] != ranks[0]["losses"] for d in ranks):
                bad.append("ranks' losses")
            half = len(ranks) // 2
            pods_equal = [ranks[r]["params_hash"] == ranks[r + half][
                "params_hash"] for r in range(half)]
            if not all(pods_equal):
                bad.append("pods' parameters")
            bad += [f"train bytes {k}" for d in ranks
                    for k in _shape_bytes_differ(d)]
            rec.update(losses=ranks[0]["losses"],
                       grad_norms=ranks[0]["grad_norms"],
                       world1_losses=one["losses"],
                       world1_grad_norms=one["grad_norms"],
                       rel_err_vs_world1=rel, pods_equal=pods_equal,
                       step_s=[d["step_s"] for d in ranks],
                       world1_step_s=one["step_s"],
                       peak_mem_gb=[d["peak_mem_gb"] for d in ranks],
                       world1_peak_mem_gb=one["peak_mem_gb"],
                       collective_bytes=[d["collective_bytes"]
                                         for d in ranks],
                       shape_bytes=ranks[0]["shape_bytes"],
                       analytic_collective_bytes=ranks[0][
                           "analytic_collective_bytes"])
        if serves:
            pre = [d["serve"] if trains else d for d in ranks]
            one = pre[0]["world1"]
            gang, w1 = one["gang_rel_err_vs_f32"], one["rel_err_vs_f32"]
            rec["serve"] = {
                "rows": [d["rows"] for d in pre],
                "prefill_s": [d["prefill_s"] for d in pre],
                "decode_s_per_step": [d["decode_s_per_step"] for d in pre],
                "peak_mem_gb": [d["peak_mem_gb"] for d in pre],
                "collective_bytes": [d["collective_bytes"] for d in pre],
                "shape_bytes": pre[0]["shape_bytes"],
                "state_shapes": [d["state_shapes"] for d in pre],
                "world1": one}
            bad += [k for k in job["judged_on"] if gang[k] > 2 * w1[k]]
            bad += [] if one["finite"] else ["finite"]
            bad += [f"serve bytes {k}" for d in pre
                    for k in _shape_bytes_differ(d)]
        emit(phase="pod_gang", name=name, card=card_line(), **rec)
        if bad:
            raise AssertionError(f"{what}: {bad}: {rec}")
    return launches


def seq_parallel_vs_plain(torch, m, counts) -> int:
    """Phase 31: ``ssd_seq_parallel`` at mamba2-2.7b's widths (80 heads of
    64, N 128, chunk 256), 8 x 2048 in 4 segments (bf16 x, B and C as
    strided views, as the mixer hands them over): its segments folded into
    one K4 launch on the tensor cores, the combine and the correction in
    plain tensor code.  Held, first, K4's scan of the folded segments
    against the plain chunked scan of the same inputs under K4's bf16
    tolerance; then the whole against the plain scan of the whole
    sequence: h under K4's tolerance, y within it plus one bf16 rounding
    (``BF16_ROUNDING``) of each addend of ``y_loc + y_corr`` (the
    reference adds them in the input dtype, so where the segment's local
    output and the incoming state's correction cancel, the rounding of
    each stays).  Returns the launches."""
    Bs, S, nh, hp, g, N, Q, n_seg = SEQ_PARALLEL
    gen = torch.Generator(device="cuda").manual_seed(31)
    buf = torch.randn((Bs, S, nh * hp + 2 * g * N), generator=gen,
                      device="cuda").to(torch.bfloat16)
    x = buf[..., :nh * hp].reshape(Bs, S, nh, hp)
    B = buf[..., nh * hp:nh * hp + g * N].reshape(Bs, S, g, N)
    C = buf[..., nh * hp + g * N:].reshape(Bs, S, g, N)
    dt = torch.nn.functional.softplus(torch.randn((Bs, S, nh), generator=gen,
                                                  device="cuda"))
    A = -torch.exp(0.3 * torch.randn(nh, generator=gen, device="cuda"))
    cfg = m["SSMConfig"](d_state=N, head_dim=hp, n_groups=g, chunk=Q)
    seq_parallel = m["ssm"].ssd_seq_parallel
    counts.zero()
    y, h = seq_parallel(x, dt, A, B, C, cfg, n_seg)
    torch.cuda.synchronize()
    routes = counts.routes(("ssd_scan",))["ssd_scan"]
    if routes != {"tensor_core": 1, "cuda_core": 0}:
        raise AssertionError(f"ssd_seq_parallel: K4 launches {routes}, want "
                             f"one on the tensor cores")
    tol = SSD_TOL["bfloat16"]

    def fold(t):
        return t.reshape((Bs * n_seg, S // n_seg) + tuple(t.shape[2:]))

    folded = (fold(x), fold(dt), A, fold(B), fold(C))
    y_loc, h_seg = m["ssd_scan"](*folded, chunk=Q, return_state=True)
    yr, hr = m["ssd_chunked_ref"](*folded, Q)
    _ssd_close(torch, y_loc.float(), yr.float(), tol["y"])
    _ssd_close(torch, h_seg, hr, tol["h"])
    seg_err = (y_loc.float() - yr.float()).abs().max().item()
    del yr, hr, h_seg
    yr, hr = m["ssd_chunked_ref"](x, dt, A, B, C, Q)
    atol_h = _ssd_close(torch, h, hr, tol["h"])
    y_loc = y_loc.reshape(y.shape).float()
    _, a, r = tol["y"]
    err = (y.float() - yr.float()).abs()
    allowed = (a + r * yr.float().abs() + BF16_ROUNDING
               * (y_loc.abs() + (y.float() - y_loc).abs()))
    worst = (err / allowed).max().item()
    err_y, err_h = err.max().item(), (h - hr).abs().max().item()
    beyond_k4 = int((err > a + r * yr.float().abs()).sum().item())
    del yr, hr, y_loc, err, allowed
    torch.cuda.empty_cache()
    if worst > 1:
        raise AssertionError(f"ssd_seq_parallel: y off the plain scan by "
                             f"{worst} of its allowance (max abs {err_y})")
    ms = cuda_ms(torch, lambda: seq_parallel(x, dt, A, B, C, cfg, n_seg),
                 reps=5)
    one_ms = cuda_ms(torch, lambda: m["ssd_scan"](
        x, dt, A, B, C, chunk=Q, return_state=True), reps=5)
    plain_ms = cuda_ms(torch, lambda: m["ssd_chunked_ref"](
        x, dt, A, B, C, Q), reps=2)
    emit(phase="seq_parallel_vs_plain", card=card_line(),
         dims=list(SEQ_PARALLEL), routes=routes,
         segments_max_abs_err_y=seg_err, max_abs_err_y=err_y,
         max_abs_err_h=err_h, tol=tol, atol_h=atol_h,
         bf16_rounding=BF16_ROUNDING, worst_share_of_allowance=worst,
         elements_beyond_k4_tol=beyond_k4, ms=ms, one_scan_ms=one_ms,
         plain_ms=plain_ms)
    del buf, x, B, C, dt, A, y, h
    torch.cuda.empty_cache()
    return routes["tensor_core"]

def _by_job(launches: dict, kernel: str) -> dict:
    """A kernel's per-rank launches in each phase-32 or phase-33 job
    that runs it."""
    return {job: got[kernel] for job, got in launches.items()
            if kernel in got}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def load_port() -> dict:
    """Import the port from ``src/`` beside this script: the entry points
    and modules the phases drive, by name."""
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.checkpoint import list_checkpoints, load_checkpoint
    from repro_torch.api import RunSpec
    from repro_torch.core import (ExperimentGrid, Orchestrator,
                                  PersistentVolume, S3Store,
                                  node_specs_from_json, replay_events)
    from repro_torch.core import executor
    from repro_torch.core.autobatch import MemoryBudget, autobatch
    from repro_torch.configs import get_config, get_reduced, list_archs
    from repro_torch.kernels.common import build_libraries
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.data import SeekableSyntheticBatches, make_batch
    from repro_torch.data.loader import ChipLoader, prefetch
    from repro_torch.data.normalize import nir_rg, percentile_stretch
    from repro_torch.distributed import dist_train_main
    from repro_torch.data.rasters import synth_change_pair
    from repro_torch.kernels.percentile_norm import kernel as pn
    from repro_torch.kernels.percentile_norm import percentile_normalize
    from repro_torch.kernels.percentile_norm import ref as pn_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.launch import vision
    from repro_torch.launch.dryrun import STRUCTURAL_SKIPS
    from repro_torch.launch.dryrun import run_one as dryrun_run_one
    from repro_torch.launch.__main__ import main as launch_main
    from repro_torch.launch.serve import serve_main
    from repro_torch.launch.train import _LMDictBatches, train_main
    from repro_torch.models.changeformer import (changeformer_apply,
                                                 changeformer_init)
    from repro_torch.models.segmentation import seg_apply, seg_init, seg_loss
    from repro_torch.models import init_params
    from repro_torch.models import moe
    from repro_torch.models import ssm
    from repro_torch.configs.base import SSMConfig
    from repro_torch.models.layers import naive_attention
    from repro_torch.models.model import (cast_floating, decode_step,
                                          prefill, train_loss, unused_leaves)
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.launch.vision_grid import run_grid
    from repro_torch.serve import (LegacyServeEngine, Request, ServeEngine,
                                   ServeScheduler, poisson_trace)
    from repro_torch.train import (Preemption, TrainLoop, init_train_state,
                                   make_train_step)
    from repro_torch.tree import tree_leaves, tree_unflatten
    m = dict(get_config=get_config, get_optimizer=get_optimizer,
             init_train_state=init_train_state,
             make_train_step=make_train_step, warmup_cosine=warmup_cosine,
             LMDictBatches=_LMDictBatches, TrainLoop=TrainLoop,
             train_loss=train_loss, unused_leaves=unused_leaves,
             cast_floating=cast_floating, tree_leaves=tree_leaves,
             tree_unflatten=tree_unflatten,
             train_main=train_main, dist_train_main=dist_train_main,
             Preemption=Preemption,
             load_checkpoint=load_checkpoint,
             list_checkpoints=list_checkpoints, init_params=init_params,
             ServeEngine=ServeEngine, Request=Request, prefill=prefill,
             LegacyServeEngine=LegacyServeEngine, run_grid=run_grid,
             ServeScheduler=ServeScheduler, poisson_trace=poisson_trace,
             decode_step=decode_step, serve_main=serve_main,
             get_reduced=get_reduced, build_dataset=vision.build_dataset,
             train_segmentation=vision.train_segmentation,
             build_pairs=vision.build_pairs,
             train_changeformer=vision.train_changeformer,
             train_step=vision.train_step, vision_main=vision.main,
             percentile_stretch=percentile_stretch, nir_rg=nir_rg,
             percentile_normalize=percentile_normalize,
             synth_change_pair=synth_change_pair, seg_init=seg_init,
             seg_apply=seg_apply, seg_loss=seg_loss,
             changeformer_init=changeformer_init,
             changeformer_apply=changeformer_apply, ChipLoader=ChipLoader,
             prefetch=prefetch, moe=moe, ssm=ssm, SSMConfig=SSMConfig,
             ssd_scan=ssd_scan,
             launch_main=launch_main, ExperimentGrid=ExperimentGrid,
             Orchestrator=Orchestrator, PersistentVolume=PersistentVolume,
             S3Store=S3Store, MemoryBudget=MemoryBudget, autobatch=autobatch,
             RunSpec=RunSpec, executor=executor,
             node_specs_from_json=node_specs_from_json,
             replay_events=replay_events, make_batch=make_batch,
             SeekableSyntheticBatches=SeekableSyntheticBatches,
             fa=fa, ref=ref, ssd=ssd, pn=pn,
             pn_ref=pn_ref, F=F, flash_attention=flash_attention,
             naive_attention=naive_attention,
             ssd_chunked_ref=ssd_chunked_ref,
             build_libraries=build_libraries,
             STRUCTURAL_SKIPS=STRUCTURAL_SKIPS, dryrun_run_one=dryrun_run_one,
             list_archs=list_archs)
    return m


def main() -> int:
    # cuBLAS reads this when it starts: with it (and deterministic mode in
    # phase 7) a resumed run repeats an uninterrupted one bitwise
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    m = load_port()
    fa, ref, ssd, pn, pn_ref, F = (m[k] for k in ("fa", "ref", "ssd", "pn",
                                                  "pn_ref", "F"))

    # f32 products in the plain versions stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    # phase 27's sweeps need no card: the train sweep runs on the host
    # beside the build, where no phase is timed, the shorter decode sweep
    # from after the build (not beside the nvcc processes); both are read
    # after phase 28
    sweep = dryrun_start(DRYRUN_SHAPES[:1])
    # phase 1: one nvcc per source, all started together, and three more
    # for K4's, K1's and K2/K3's ptxas reports
    t0 = time.perf_counter()
    ptxas_dir = tempfile.mkdtemp()
    ptxas = ptxas_start(ssd.SOURCE, ptxas_dir)
    ptxas_fwd = ptxas_start(fa.SOURCE, ptxas_dir)
    ptxas_bwd = ptxas_start(fa.BWD_SOURCE, ptxas_dir)
    m["build_libraries"]([fa.SOURCE, fa.BWD_SOURCE, ssd.SOURCE,
                          pn.SOURCE])
    fa.library()
    fa.bwd_library()
    ssd.library()
    pn.library()
    emit(phase="build", sources=sorted({v[0] for v in KERNELS.values()}),
         seconds=time.perf_counter() - t0)
    emit(phase="ptxas", source=KERNELS["ssd_scan"][0],
         tensor_core=ssd_ptxas(ptxas_report(ptxas, "ssd_scan_wgmma")))
    emit(phase="ptxas", source=KERNELS["flash_attention_fwd"][0],
         tensor_core=flash_ptxas(ptxas_report(ptxas_fwd, "_wgmma"), ("K1",)))
    emit(phase="ptxas", source=KERNELS["flash_attention_bwd_dq"][0],
         tensor_core=flash_ptxas(ptxas_report(ptxas_bwd, "_wgmma"),
                                 ("K2", "K3")))
    shutil.rmtree(ptxas_dir)
    sweep += dryrun_start(DRYRUN_SHAPES[1:])

    k1_recs = kernel_vs_plain(torch, F, fa, ref)
    kb_recs = bwd_vs_plain(torch, F, fa, ref)
    kb = kb_recs[("stablelm_train", "bfloat16")]
    function_vs_plain(torch, fa, m["flash_attention"], m["naive_attention"])

    # the training path
    counts = _Counts(fa, ssd, pn)
    train_launches, state, data = train_full_width(torch, m, counts)
    train_grads_vs_f32(torch, m, state.params, data)
    del state, data
    torch.cuda.empty_cache()

    # the dense serving path, then the other two dense decoders at full
    # width, then live traffic through the scheduler
    serve_launches = serve_path(torch, m, counts, "granite-3-2b")
    # the legacy engine on granite: full width, then the reduced f32 case
    legacy_launches = legacy_full_width(torch, m, counts, "granite-3-2b")
    legacy_reduced(torch, m, counts, "granite-3-2b")
    wide_launches = {arch: serve_path(torch, m, counts, arch, cli=False)
                     for arch in ("glm4-9b", "codeqwen1.5-7b")}
    live_launches, params, live_reqs = serve_continuous_full_width(
        torch, m, counts)
    scheduler_token_identity(torch, m, counts, params, live_reqs)
    del params
    torch.cuda.empty_cache()
    serve_main_continuous(torch, m, counts)

    # the MoE serving path (this slice's main path): full-width qwen3-moe
    moe_launches = serve_path(torch, m, counts, "qwen3-moe-30b-a3b",
                              cli=False)

    train_cli_resume(torch, m, counts)
    train_cli_resume(torch, m, counts, precision="bf16")

    # the SSM serving path
    k4 = ssd_vs_plain(torch, ssd, m["ssd_chunked_ref"])
    ssd_launches = serve_path(torch, m, counts, "mamba2-2.7b")
    # the hybrid (this slice's main path): K1, K4 and the MoE in one
    # prefill, then the reduced jamba's CLI
    hybrid_launches = serve_path(torch, m, counts, "jamba-1.5-large-398b",
                                 cfg=jamba_one_period(m["get_config"]))
    # mamba2 training on the card
    ssd_train_launches = train_mamba2(torch, m, counts)
    # the audio and vlm families: hubert trains through K1-K3's
    # non-causal hd-80 path, llava prefills patches and trains, all on the
    # tensor cores
    hubert = train_hubert(torch, m, counts)
    llava = llava_path(torch, m, counts)

    # the run API and the local campaign layer
    api_train = run_api_train_full_width(torch, m, counts)
    api_cli = run_api_cli_subprocess(m)
    api_resume = run_api_train_resume_bitwise(torch, m, counts)
    api_campaign = campaign_local(torch, m, counts)
    run_api_simulate(torch, m, api_train["peak_mem_gb"])
    launches_run_api = {name: api_train["launches"][name] + api_resume[name]
                        + api_campaign[name] for name in counts.FLASH}

    # the campaign executor: jobs as `run <kind>` subprocesses on the card
    campaign = campaign_cluster_full_width(torch, m, api_train, api_cli)
    # phases 20 and 21 run reduced jobs that leave the card nearly idle:
    # phase 21's campaign subprocess and the gangs of phases 29-32 (their
    # subprocesses; the checks stay in place below) run beside phase 20
    torch.cuda.empty_cache()
    beside = [_Background(campaign_scheduler_sigkill_resume, m),
              _Background(sharded_gangs, torch), _Background(pod_gang, torch),
              _Background(vision_grid_cli)]
    try:
        campaign_chaos_resume(torch, m)
    finally:
        for job in beside:
            job.thread.join()
    beside[0].result()
    rank_jobs, probe_gang = beside[1].result()
    pod_jobs = beside[2].result()
    grid_cli = beside[3].result()

    # data-parallel training: world 1 is the single process, a full-width
    # world-2 gang shares the card, and a gang under the executor's chaos
    dist_world1_bitwise(torch, m)
    gang_launches, gang_peaks = dist_gang_full_width(torch, m, counts)
    dist_gang_chaos(torch, m)

    # the analysis kinds: the probe runs its cells on the card
    long_recs = long_sequence_vs_plain(torch, F, fa, ref)
    probes = perfprobe_cells(torch, m, counts)
    torch.cuda.empty_cache()
    # phase 27's sweep has run on the host since before the build
    dryrun_finish(torch, m, sweep)

    # the parameter-sharded layouts on the data axis: world-2 gangs that
    # share the card, then the sequence-parallel scan through K4
    sharded_launches = sharded_gang_full_width(torch, m, gang_peaks,
                                               rank_jobs["stablelm_dp"],
                                               probe_gang)
    sharded_k4 = sharded_mamba2(torch, m, rank_jobs["mamba2_fsdp_sp"],
                                rank_jobs["wall_s"])
    seq_parallel_k4 = seq_parallel_vs_plain(torch, m, counts)
    # the model axis: fsdp_tp's jobs of the same gang, then fsdp_sp's
    axis_launches = model_axis_gangs(torch, m, rank_jobs)
    tp_launches, sp_launches = (axis_launches["fsdp_tp"],
                                axis_launches["fsdp_sp"])
    # the pod axis: two replicas of {model: 2}, the batch over the pods
    pod_launches = pod_axis_gang(torch, m, pod_jobs)

    # the vision paths: both studies normalize every scene through K5
    k5 = k5_vs_plain(torch, pn, pn_ref)
    pn_launches = burned_area(torch, m, counts)
    forward_vs_cpu(torch, m)
    pn_launches += deforestation(torch, m, counts)
    vision_cli(torch, m, counts)
    grid_launches = vision_grid_cli_check(grid_cli)

    emit(phase="done", seconds=time.perf_counter() - t_start)
    k2 = dict(ms=kb["dq_kernel_ms"], bound_ms=kb["dq_bound_ms"],
              bound_by=kb["dq_bound_by"], max_abs_err=kb["max_abs_err"]["dq"],
              core_route=kb["route"])
    k3 = dict(ms=kb["dkv_kernel_ms"], bound_ms=kb["dkv_bound_ms"],
              bound_by=kb["dkv_bound_by"],
              max_abs_err=max(kb["max_abs_err"]["dk"],
                              kb["max_abs_err"]["dv"]),
              core_route=kb["route"])
    # hubert's training shape (non-causal, hd 80) and the tensor cores'
    # non-causal branch at hd 64, beside the main shapes; K1-K3 also at
    # the hd-80 edge shapes
    new_shapes = ("hubert_train", "noncausal_hd64", "hd80_gqa_causal",
                  "hd80_ragged_s1000")
    for name, rec in (("flash_attention_bwd_dq", k2),
                      ("flash_attention_bwd_dkv", k3)):
        what = "dq" if name.endswith("dq") else "dkv"
        rec["shapes"] = {s: {
            "ms": kb_recs[(s, "bfloat16")][f"{what}_kernel_ms"],
            "bound_ms": kb_recs[(s, "bfloat16")][f"{what}_bound_ms"],
            "bound_by": kb_recs[(s, "bfloat16")][f"{what}_bound_by"],
            "plain_ms": kb_recs[(s, "bfloat16")]["plain_ms"],
            "library_ms": kb_recs[(s, "bfloat16")]["library_ms"],
            "core_route": kb_recs[(s, "bfloat16")]["route"]}
            for s in new_shapes}
        rec["launches_train_hubert"] = hubert["train"][name]
        rec["launches_train_llava"] = llava["train"][name]
        rec["launches_run_api_hubert"] = hubert["run_api"][name]
        rec["launches_train_gang"] = [r[name] for r in gang_launches]
        rec["launches_sharded_gang"] = [r[name] for r in sharded_launches]
        rec["launches_tp_gang"] = _by_job(tp_launches, name)
        rec["launches_sp_gang"] = _by_job(sp_launches, name)
        rec["launches_pod_gang"] = _by_job(pod_launches, name)
        rec["shapes"].update({s[0]: {
            "ms": kb_recs[(s[0], "bfloat16")][f"{what}_kernel_ms"],
            "bound_ms": kb_recs[(s[0], "bfloat16")][f"{what}_bound_ms"],
            "bound_by": kb_recs[(s[0], "bfloat16")][f"{what}_bound_by"],
            "plain_ms": kb_recs[(s[0], "bfloat16")]["plain_ms"],
            "library_ms": kb_recs[(s[0], "bfloat16")]["library_ms"],
            "q_offset": s[9],
            "core_route": kb_recs[(s[0], "bfloat16")]["route"]}
            for s in SP_SHAPES})
    k1 = k1_recs[("granite_prefill", "bfloat16")]
    k1 = dict(ms=k1["kernel_ms"], bound_ms=k1["bound_ms"],
              bound_by=k1["bound_by"], max_abs_err=k1["max_abs_err_o"],
              plain_ms=k1["plain_ms"], library_ms=k1["library_ms"],
              core_route=k1["route"],
              launches_serve=serve_launches["flash_attention_fwd"],
              launches_legacy=legacy_launches,
              launches_serve_wide={a: n["flash_attention_fwd"]
                                   for a, n in wide_launches.items()},
              launches_serve_continuous=live_launches,
              launches_serve_moe=moe_launches["flash_attention_fwd"],
              launches_serve_hybrid=hybrid_launches["flash_attention_fwd"],
              launches_run_api_cli=api_cli["granite-3-2b"],
              launches_campaign=campaign["flash_attention_fwd"],
              launches_train_hubert=hubert["train"]["flash_attention_fwd"],
              launches_run_api_hubert=hubert["run_api"][
                  "flash_attention_fwd"],
              launches_prefill_llava=llava["prefill"],
              launches_train_llava=llava["train"]["flash_attention_fwd"],
              launches_train_gang=[r["flash_attention_fwd"]
                                   for r in gang_launches],
              launches_sharded_gang=[r["flash_attention_fwd"]
                                     for r in sharded_launches],
              launches_tp_gang=_by_job(tp_launches, "flash_attention_fwd"),
              launches_sp_gang=_by_job(sp_launches, "flash_attention_fwd"),
              launches_pod_gang=_by_job(pod_launches,
                                        "flash_attention_fwd"),
              shapes={name: {k: k1_recs[(name, "bfloat16")][k] for k in (
                  "kernel_ms", "bound_ms", "bound_by", "plain_ms",
                  "library_ms", "max_abs_err_o", "route", "q_offset")}
                  for name in ("glm4_prefill", "codeqwen_prefill",
                               "qwen3_prefill") + new_shapes
                  + tuple(s[0] for s in SP_SHAPES)})
    rows = []
    for name, rec in (("flash_attention_fwd", k1),
                      ("flash_attention_bwd_dq", k2),
                      ("flash_attention_bwd_dkv", k3)):
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": train_launches[name],
                     "launches_run_api": launches_run_api[name],
                     "plain_ms": kb["plain_ms"],
                     "library_ms": kb["library_ms"], **rec})
    source, replaces = KERNELS["ssd_scan"]
    # no single PyTorch call computes the SSD scan: library_ms is null
    rows.append({"name": "ssd_scan", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": ssd_launches["ssd_scan"],
                 "launches_serve_hybrid": hybrid_launches["ssd_scan"],
                 "launches_train": ssd_train_launches,
                 "launches_run_api_cli": api_cli["mamba2-2.7b"],
                 "launches_campaign": campaign["ssd_scan"],
                 "launches_sharded_gang": sharded_k4,
                 "launches_tp_gang": _by_job(tp_launches, "ssd_scan"),
                 "launches_sp_gang": _by_job(sp_launches, "ssd_scan"),
                 "launches_pod_gang": _by_job(pod_launches, "ssd_scan"),
                 "launches_seq_parallel": seq_parallel_k4,
                 "max_abs_err": max(k4["max_abs_err_y"], k4["max_abs_err_h"]),
                 "ms": k4["kernel_ms"], "plain_ms": k4["plain_ms"],
                 "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
                 "library_ms": None, "core_route": k4["route"]})
    source, replaces = KERNELS["percentile_norm"]
    # no single PyTorch call computes the stretch: library_ms is null
    rows.append({"name": "percentile_norm", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": pn_launches,
                 "launches_vision_grid": grid_launches,
                 "max_abs_err": k5["max_abs_err"],
                 "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"],
                 "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
                 "library_ms": None})
    # phase 28's launches by cell (its three steps), and each kernel's
    # device ms and calls in the cell's profiled step
    for row in rows:
        if row["name"] in _Counts.ROUTED:
            row["launches_perfprobe"] = {
                cell: p["launches"][row["name"]] for cell, p in probes.items()}
            row["perfprobe_profiled"] = {
                cell: p["kernel_ms"][row["name"]] for cell, p in probes.items()
                if p["kernel_ms"][row["name"]]["calls"]}
            if row["name"] in long_recs:
                row["long_sequence"] = long_recs[row["name"]]
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [RANK_FLAG]:
        sys.exit(sharded_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == [POD_FLAG]:
        sys.exit(sharded_rank(int(sys.argv[2]), sys.argv[3], POD_WORLD,
                              POD_JOBS))
    sys.exit(main())
