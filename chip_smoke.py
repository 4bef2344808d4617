#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases (each fails the run if its check fails):

1. build       - build the seven CUDA kernels from ``src/repro_torch/
                 kernels/csrc`` (one nvcc per source, all started together);
2. parity      - each kernel against its plain PyTorch version on the
                 card: rms_norm (at both models' widths, D = 2048 and
                 4096, and Granite's (2048, 1536)) and flash_attention
                 at the serving path's shapes (f32, bf16; flash_attention
                 also at the (data, model) path's (2, 1024, 16, 64) and
                 the MoE path's (2, 1024, 12, 64)) and their gradients
                 (at those training shapes too; the
                 kernel path's
                 autograd, for rms_norm its backward kernel, against
                 autograd through the plain version);
                 chunked_reduce (f32, bf16; n_src 2, 4, 16; the training
                 path's segment length and a ragged one, the (pod, data),
                 (data, model), grouped, MoE and pipeline paths' shapes);
                 all_gather_matmul at
                 the training paths' shapes (f32; at (data, model) x
                 (2048, 2 x 1024) @ N = 256, 1024, 4096, on the MoE path
                 (2048, 2 x 768) @ N = 768, 256); ssm_scan (y and
                 the
                 final state) at the JAX test shapes, Falcon's prefill and
                 decode shapes, a ragged L from a random state, L
                 across ring-stage boundaries, L = 4096, and bf16, and
                 at N = 64 (Zamba2's prefill and decode, a ragged L, L =
                 4096); its backward kernel (every input's grad, with a
                 cotangent on the final state) against autograd through
                 the plain version at Falcon's training shape (1, 1024,
                 8192, 16), Zamba2's (1, 1024, 4096, 64), L = 4096 and
                 from h0, and its head mode (``ssm_scan_heads``: dt, A
                 and D per head of 64, ddt, dA and dD per head) at
                 Zamba2's shape, L = 4096 and from h0, each repeated
                 bitwise; at a rank's shapes of 7h, the head mode at (2,
                 1024, 32 x 64, 64), the forward at (2, 1024, 2048, 64)
                 and the per-channel backward at Falcon-Mamba's tp-2
                 (2, 1024, 4096, 16); rms_norm's gradients at
                 (1024, 4096) too;
                 reduce_scatter_rmsnorm and reduce_scatter_adamw (f32 and
                 bf16, weight decay 0 and 0.1) at the JAX test shapes, the
                 training path's shapes and a ragged T / L; the two
                 tensor-core kernels (all_gather_matmul, flash_attention)
                 run twice on the same inputs and must repeat bitwise;
                 the non-text models' shapes: flash_attention non-causal
                 at whisper-tiny's encoder (4, 1500, 6, 64) and cross
                 attention (4, 1024 x 1500, 6, 64), causal at
                 Phi-3-vision's (1, 1600, 32, 96) (the D = 96 build, f32
                 and bf16) and a ragged D = 96 case, their gradients at a
                 rank's shapes and their repeats; rms_norm (forward and
                 gradients) at (1500, 384) and (1600, 3072);
                 all_gather_matmul at whisper's (T, 4 x 96) @ N = 384,
                 1536 (T = 1024 and 1500) and Phi-3's (1600, 4 x 768) @
                 N = 3072, 8192; chunked_reduce at both models' row and
                 grad-sync buckets (``frontend_reduce_shapes``; f32 also
                 bitwise against the plain version);
3. timing      - each kernel, its plain version and one PyTorch library
                 call on the same inputs (device time from CUDA events, L2
                 flushed before every call; for the two reduce_scatter
                 kernels, which no single call computes, the two-call
                 composition), beside the kernel's roofline bound, at the
                 main paths' shapes (all_gather_matmul at all four of the
                 flat training path's and the three of the (data, model)
                 path's, flash_attention and chunked_reduce at that
                 path's too); the two tensor-core kernels also beside
                 ``bound_tc_ms``, their bound on the 3xTF32 instruction
                 path (three tf32 products per f32 product at 495
                 TFLOP/s); ssm_scan at prefill and decode with the
                 launch ``ssm_geometry`` chose; rms_norm's forward at
                 both models' prefill and decode shapes and its backward
                 at the training path's, each with the launch
                 ``rms_geometry`` chose and ``copy_ms``, a copy of the
                 same bytes under the same timer (the backward's: read
                 x and dy, write dx), the backward's library call the
                 autograd backward of ``F.rms_norm``; chunked_reduce and
                 ``torch.sum`` in turns, five times each, each beside
                 ``copy_ms``, a copy of the same bytes; ssm_scan also at
                 Zamba2's prefill and decode (N = 64, beside
                 ``bound_ssd_ms``, the bound with one exp a head, as the
                 Mamba-2 function needs), the training forward writing
                 its checkpoints and the backward kernel at Falcon's and
                 Zamba2's training shapes per channel and at Zamba2's
                 and L = 4096 per head, each beside ``copy_ms``;
3b. kernel API - ``repro_torch.kernels.ops.reduce_scatter_rmsnorm`` and
                 ``reduce_scatter_adamw`` at the training path's shapes
                 (the path that carries them in the JAX package too);
4. reference   - the smoke-size models on the card against the same models
                 on the CPU: Llama (prefill at L = 1100, through the flash
                 kernel), Falcon-Mamba and Zamba2 (prefill at L = 300,
                 through the ssm_scan kernel), whisper-smoke and
                 phi3-vision-smoke (L = 1100 behind their stub input;
                 whisper's cross-attention ``ck`` / ``cv`` among the
                 compared leaves), each with three per-slot decode steps;
5. serve       - Llama-3.2-1B at full width (f32, seeded random params):
                 a fixed batch of 4 x 1024-token prompts with a roomy HBM
                 budget, the same with a budget 4 blocks short and eviction
                 to the pool (greedy tokens must match), then a Poisson
                 trace of 8 requests with half the prompts sharing a pooled
                 prefix; then Falcon-Mamba-7B at full width (64 Mamba-1
                 rows, d_model 4096, f32): the same fixed batch roomy and
                 4 blocks short (whole-image eviction of the token-free SSM
                 state), and a Poisson trace of 8 requests (prefix sharing
                 turns itself off: the state has no token axis); then
                 Zamba2-1.2B at full width (32 Mamba-2 rows, the shared
                 attention block 6 times, f32) the same way (its hybrid
                 cache mixes KV leaves with token-free SSM leaves: whole
                 slot images, no prefix sharing); then whisper-tiny and
                 Phi-3-vision-4.2B at full width (f32; the fixed batch
                 with its stub input, Phi-3's ``max_seq`` 1624 holding
                 its 576 patches), roomy and 4 blocks short, no trace
                 (the launcher's trace carries no frontend input);
                 Llama's roomy run is observed (``ObsSession``, files
                 ``serve_llama.*`` in ``OUT_DIR``): its ``repro_serve_*``
                 gauges and ``.prom`` equal ``ServeEngine.counters`` and
                 state, one ``serve_step`` span a step of the engine;
                 whisper's published 448-position decoder context is
                 replaced by RoPE in the repo's config, and its 1024-
                 token prompts are what bring cross attention to the
                 flash kernel;
6. collectives - (one spawn of the ranks for both tables) every flat
                 collective on 4 ranks sharing the card, ring
                 (gloo; to 16 MB) and cxl (the pinned shared host pool),
                 at 1, 16 and 256 MB per rank: each rank's result against
                 a numpy oracle (bitwise), and the median time; then
                 every primitive that takes a tuple axis over ("pod",
                 "data") = (2, 2) with the topology ``pod:cxl,data:ici``
                 (every level group with its own gloo group and pool),
                 beside the same primitive over the flat axis of all 4
                 ranks, at 1 and 16 MB per rank, under cxl, auto (plans
                 tuned in the run) and ring: each result bitwise against
                 the oracle and the tuple's against the flat one's, the
                 median time and the wire bytes by level;
7. train       - FSDP training on 4 ranks sharing the card: the smoke
                 model on the card against the same run on the CPU (losses
                 over 3 steps), then Llama-3.2-1B at full width and depth
                 through the launcher's flags, ``--backend cxl
                 --fuse-kernels``, ``--backend cxl``, ``--backend ring`` and
                 ``--backend auto --plan`` on a plan that
                 ``repro_torch.launch.tune --nranks 4 --sizes-mib 1 4 16 64
                 256`` writes into ``OUT_DIR`` (``--mesh 4x1
                 --batch 4 --seq 1024``, cxl+fused 3 steps, the others 2
                 (the earlier paths' depth is cut to keep the time limit;
                 ring is gloo-bound), the same
                 seeded params and batches; the runs of one path are the
                 variants of one spawn of the ranks, in turn): the four
                 step-0 losses agree, every
                 run's loss falls, every collective call of the auto run
                 took its plan cell, every rank launched the rms_norm
                 backward kernel in every step, and one extra step of the
                 first run is profiled (the two tensor-core kernels' and
                 rms_norm's device time by kernel name); then the same
                 model with ``--multi-pod --topology pod:cxl,data:ici``
                 (the data axis ("pod", "data") = (2, 2)) under cxl
                 +fused, cxl and auto (2 steps each) on a plan that
                 ``launch.tune --topology pod:cxl,data:ici --nranks 2``
                 writes: step-0
                 losses within 1e-4 of the flat cxl+fused run's, every
                 loss falls, every rank launches chunked_reduce, rms_norm,
                 its backward and flash_attention (and all_gather_matmul
                 under --fuse-kernels) every step, cxl moves pool bytes
                 on both levels and auto none on the ici level, and every
                 auto call took the cell of its own level (ring on ici);
7c. train (data, model) - tensor parallelism over ``--mesh 2x2`` with
                 ``--topology data:cxl,model:cxl``: the smoke model on
                 the card against the CPU (losses of 3 steps, rtol 2e-4),
                 then Llama-3.2-1B at full width and depth under cxl
                 +fused (3 steps, no profiled step since PR 30), cxl (2
                 steps) and auto (3 steps, the re-tuned run's reference)
                 on a plan that
                 ``launch.tune --topology data:cxl,model:cxl --nranks 2``
                 writes: step-0 losses within 1e-4 of the flat cxl+fused
                 run's, every loss falls, cxl moves pool bytes at both
                 levels, every rank launches the kernels of 7b every
                 step, and every auto call took its level's plan cell;
                 in the same spawn, after them, ``tp_auto_retune``: auto
                 on the same plan with ``--online-retune
                 --retune-interval 1 --timing-source profiler
                 --metrics-out --trace-out --plan-out`` (3 steps, the
                 files in ``OUT_DIR``: ``retune_tp.*``): step-0 loss
                 bitwise tp_auto's, steps 1 and 2 within 1e-4 of
                 tp_auto's (step 2 ran the step-1 refresh's cells), the
                 loss falls;
                 every call at the cell of its own epoch's plan (the
                 plan published after steps 0 and 1), every rank at the
                 same epoch and the same plan (hash) at every refresh;
                 one sample a call on every rank every step; the metrics
                 stream's 3 step and 2 retune events, its gauges = rank
                 0's ledger snapshot per kind and (level, fabric), the
                 ``.prom`` parsing; the trace's 3 steps of each rank, a
                 collective event a sample; ``launch.report`` of both;
                 ``--plan-out`` loading with every cell the calls took,
                 measured where its choice ran; ``tune --measurements``
                 of the run's samples folding 7c's plan to the same
                 measured cells; rms_norm, its backward and
                 flash_attention (chunked_reduce under cxl reduce
                 choices) on every rank every step; the calibration
                 table, ``calibration_drift``, the regret, the swaps
                 and the step times against tp_auto's printed;
                 and, last in the same spawn, ``decode_tp``: Llama-3.2-1B
                 decoded at full width over (data, model) = (2, 2) under
                 cxl through the dry-run's ``decode_32k`` step
                 (``launch.dryrun.build_step`` with real tensors: f32
                 params from the seed, TP-resident, an f32 cache), a
                 global batch of 4, a 1028-token prompt (the prefill
                 reaches flash_attention and pads to max_seq 2064, 1032
                 positions a model rank), 8 decode steps writing
                 positions 1028-1035 across model rank 0's segment into
                 rank 1's: every step's logits within rtol 2e-4, atol
                 2e-4 of the port's tp = 1 prefill and decode of the
                 same data rank's batch on the card (teacher-forced with
                 its tokens), exactly flash_attention 16, rms_norm 297
                 and chunked_reduce 553 (all at N = 2) launches on every
                 rank, and rank 0's ledger of every decode step equal to
                 the meta-device dry-run record of the same step;
7d. train grouped - a grouped (ragged) data axis, ``--topology
                 pod:cxl,data:cxl:3+1`` (the 4 ranks as a node of three
                 beside a lone node on one flat data axis): the smoke
                 model on the card against the CPU (rtol 2e-4), then
                 Llama-3.2-1B at full width and depth under cxl+fused
                 and cxl (2 steps each) and auto (7k's run, below) on
                 a plan that ``launch.tune
                 --topology pod:cxl,data:cxl:3+1 --nranks 4`` writes, and
                 ``--topology pod:cxl,node:cxl:3+1 --placement auto`` under
                 cxl (2 steps): step-0 losses within 1e-4 of the flat
                 cxl+fused run's, every loss falls, pool bytes move in
                 the groups' pools (``data``) and the sub-roots' (``pod``),
                 no flat-on-ragged fallback event, every rank launches the
                 kernels of 7b every step and under cxl chunked_reduce at
                 N = its group's size (3) and, on a sub-root, at N = the
                 group count (2), every auto call took its level's cell,
                 and the placement run moves the plain run's bytes;
7k. train resilient - 7d's auto run with ``--resilience --fault-plan
                 rank_death@1:rank=1 --pool-ckpt-interval 2 --steps 6``
                 (rank 1 is in the group of three), in 7d's spawn: every
                 rank snapshots its shards and AdamW state into its
                 partition of a pinned shared pool store at steps 0, 2,
                 4; the death is confirmed at step 3 (the reference's
                 rule: the last beat 0 + timeout 1 + patience 2) on all 4
                 ranks with one plan hash, re-planned to ``survivors on
                 data: -[1] -> 2+1``, and every rank rolls back to the
                 newest step every rank committed (0: rank 1's step-2
                 write failed) and replays the data from there: steps 4
                 and 5 are steps 1 and 2 again, their losses equal the
                 first runs' within 1e-4; step 0's loss within 1e-4 of
                 the flat cxl+fused run's; every auto call at 7d's plan
                 cell before the recovery and at the recovery plan's cell
                 served at the running mesh's levels after it, no
                 fallback event; 7d's kernels on every rank every step,
                 chunked_reduce at N = 3 / 2 wherever the step's choices
                 put a reduction on cxl at that level; snapshot bytes and
                 seconds a rank, restore seconds, steps lost, step times
                 and pool bytes recorded;
7l. survivor reconfiguration - ``launch.survivor`` on the card: 4 ranks
                 under cxl over ``pod:cxl,data:cxl:2+2`` run the
                 reference's step on an (84, 4) parameter, rank 3 dies at
                 step 2 and is confirmed on every rank, the data level is
                 re-planned to 2+1, and a spawn of the 3 survivors
                 restores from the same pool store and runs 3 steps under
                 auto on the recovery plan, equal to a flat 3-rank cxl
                 run from the same state (rtol 1e-4, atol 1e-6); ledger
                 bytes at data/cxl and pod/cxl, pod's fewer; the audit at
                 (data, 2) and (pod, 2); chunked_reduce on every
                 survivor (its two spawns run beside the build and
                 phase 2, parity,
                 and are joined after it);
7e. train MoE  - Granite-3.0-MoE (32 ``e`` rows, d_model 1536, 40 experts
                 top-8) at full width and depth over ``--mesh 2x2
                 --topology data:cxl,model:cxl --prefetch 0``, experts
                 parallel over model (each row's dispatch and combine an
                 AllToAll through the model level's pool), FSDP over data:
                 the smoke MoE card vs CPU (rtol 2e-4), then cxl+fused
                 (writing ``train --ckpt``; not profiled, the time
                 limit), cxl and auto (2 steps each since PR 30, 7c's
                 plan):
                 step-0 losses within 1e-4 of each other, every loss
                 falls, both levels' pools move bytes,
                 the kernels of 7b on every rank every step, every auto
                 call (all_to_all included) at its level's cell, rank 0's
                 all_to_all bytes as reckoned, every (token, slot) pair
                 routed once a forward (the pairs dropped by capacity
                 logged per step), and the checkpoint restored into the
                 GLOBAL shapes at tp = 2 equal to the run's params
                 bitwise, then deleted; the flat cxl+fused run of 7 writes
                 a checkpoint too, and ``serve --ckpt`` of it must give the
                 greedy tokens of an engine built from that run's params;
7f. serve MoE  - ``serve --arch granite-moe-3b`` at full width (tp = 1, f32):
                 the fixed batch of 4 x 1024-token prompts, 16 new tokens,
                 then prefill and decode-step times.
7g. train hybrid - falcon-mamba-smoke and zamba2-smoke training on the
                 card against the CPU (losses of 3 steps, rtol 2e-4), then
                 Zamba2-1.2B at full width and depth over ``--mesh 4x1``
                 under cxl+fused (profiled), cxl and auto on phase 7's
                 plan: step-0 losses within 1e-4, every loss falls, every
                 rank launches the ssm_scan kernel and its backward,
                 rms_norm's backward and flash_attention every step
                 (all_gather_matmul under --fuse-kernels, on the shared
                 block's products), ``shared_a`` gathered once a shared
                 group (6, the reference's sites), every auto call at its
                 plan cell (cxl and auto 2 steps);
7h. train hybrid (data, model) - Zamba2-1.2B at full width and depth
                 over ``--mesh 2x2 --topology data:cxl,model:cxl``
                 (Mamba channels and heads, the shared block's heads and
                 FFN columns, the vocabulary sharded over model; each
                 Mamba-2 row's gated norm one model-level AllReduce more)
                 under cxl+fused, cxl and auto (7c's plan), 2 steps
                 each: the checks of 7g, pool bytes at both
                 levels, every auto call at its level's cell, and the
                 step-0 losses within 1e-4 of each other and of 7g's
                 (the model is the same function at tp 2);
7i. train non-text - whisper-tiny and Phi-3-vision-4.2B at full width and
                 depth over ``--mesh 4x1`` in the flat path's spawn:
                 whisper under cxl+fused (profiled, 3 steps), cxl and
                 auto (2 steps; phase 7's plan), Phi-3 at ``--prefetch
                 0`` under cxl+fused and cxl, 2 steps each (no auto and
                 no profiled step: about 10 s a step, the time limit):
                 step-0 losses within 1e-4, every loss falls, every rank
                 launches flash_attention exactly as often as the path
                 calls it every step (whisper 20 a rank-step: 4 encoder
                 rows, 4 self and 4 cross attentions, the decoder's 8
                 again in the remat replay; Phi-3 2 a row kept: 16),
                 rms_norm and its
                 backward (all_gather_matmul under --fuse-kernels),
                 every auto call at its plan cell; peak memory a rank.
7j. train pipeline - llama3.2-smoke over ``--mesh 4x1 --pp-stages 2
                 --microbatches 2 --topology stage:cxl,data:cxl`` on the
                 card against the CPU (losses of 3 steps at 128 tokens,
                 rtol 2e-4),
                 then Llama-3.2-1B at full width and depth over the same
                 (stage, data) = (2, 2) under cxl (3 steps,
                 writing ``train --ckpt``) and auto (2 steps, on ``tune
                 --topology stage:cxl,data:cxl --nranks 2``'s plan), in
                 7c's spawn (the same rank groups): step-0 losses within
                 1e-4 of the flat cxl+fused run's (the same params and
                 global batch), every loss falls, every rank launches
                 exactly the flash_attention, rms_norm and rms_norm
                 backward kernels its stage's rows call every step
                 (``pp_rank_launches``: 32, 64 and 32 on stage 0, 32, 66 and
                 34 on the last), chunked_reduce on every rank under cxl,
                 ``p2p`` ledger bytes at the stage level only, both
                 levels' pools moving bytes under cxl, every auto call
                 (p2p included) at its level's cell, bubble fraction 1/3
                 every step, peak memory a rank, and the checkpoint (the
                 stage slabs concatenated) restored into the GLOBAL
                 shapes equal to the run's params bitwise, then deleted.
8. examples    - the seven examples of ``repro_torch.examples`` that run
                 on the card, through their ``main`` (or, to share a
                 spawn, the spec or rank function their ``main`` runs):
                 8a ``train_lm --steps 30`` at one rank, full width
                 (124.6M params, batch 8 x 256), before phase 7: the
                 logged loss at step 29 below step 0's, exactly
                 ``train_lm_launches`` a step (12 rows under remat:
                 rms_norm 49, its backward 25, no flash at 256 tokens),
                 the checkpoint restored bitwise, the mean step; 8b
                 ``train_lm --backend cxl --tp 2 --dp 2 --steps 4`` from
                 8a's initial params, a spec of 7c's spawn: step-0 loss
                 within 1e-4 of 8a's, the loss falls, chunked_reduce at
                 N = 2 on every rank every step, its GLOBAL checkpoint
                 restored bitwise and into a one-rank ``train()``
                 whose loss is that of the returned params' (rtol
                 1e-4); 8c
                 quickstart's part 3 (4 ranks AllReduce under cxl
                 through the pool of all four) after the flat spawn's
                 runs, the spawn that maps that pool: the numpy sum at
                 rtol 1e-4, chunked_reduce at N = 4 on every rank; 8d
                 ``serve_lm`` at full width, Llama-3.2-1B (batch 4,
                 prompt 16, 16 new) and Falcon-Mamba-7B ``--window
                 64``: tokens (4, 16) inside the vocabulary, tok/s,
                 rms_norm (and ssm_scan) launched; 8e
                 ``autotune_workflow``'s auto step on the card and the
                 CPU from the same params: loss at rtol 2e-4, audit
                 (primitive, bytes, nranks, backend) equal.

Depth cuts that pay for phase 8 (every count a cut run checks is
reckoned from the rows it keeps): Phi-3-vision's and Granite-3.0-MoE's
training runs (7i, 7e) keep 8 of their 32 rows; the Llama runs whose
steps ride gloo - the flat ring run, (pod, data)'s auto and 7c's
``tp_auto_retune`` with ``tp_auto``, the run it is held to - keep 4 of
16, and their step-0 losses are held to ``cut_cxl``, a cxl run of the
same cut model in the flat spawn.  (pod, data)'s runs (7b) ride 7c's
spawn (the same rank groups), and 7l starts beside the build, once
chunked_reduce, the one kernel its ranks launch, is built.

Phase 7 starts with every path's smoke check at once: the eleven smoke
models' training runs (the SSM models' at ``4x1`` and at ``2x2``, the
non-text models' at ``4x1`` and whisper-smoke's at ``2x2``, the only
card check of the encoder's and cross attention's model-level
AllReduces) on
the card and the same runs on the CPU, the models of one mesh and
topology in one spawn of the ranks a side (``train.run_many``: a rank's
start-up on the card is most of a check), every spawn side by side; the
SSM smoke models' take sequences of 128 tokens (the CPU's plain scan is
a loop over L), and so does whisper-smoke's at ``2x2``.  For the same
reason the full-width runs of one spawn's rank groups share a spawn of
the ranks (``train.run_many``: each run its own mesh, topology and
aliases): 7's flat Llama runs with 7g's Zamba2 runs and 7i's
whisper-tiny and Phi-3-vision runs (and 8c after them), 7c's Llama
runs with 7b's (pod, data) runs, 7e's Granite, 7h's Zamba2, 7j's
pipeline runs ((stage, data) and (pod, data) have (data, model)'s
groups) and 8b's train_lm run (and decode_tp after them), 7d's grouped
runs with its ``--placement auto`` run and 7k's.  The ranks of phase 7
allocate in expandable segments (``PYTORCH_CUDA_ALLOC_CONF``), and 7j's
pipeline runs, 16 GiB a rank, come first in their spawn.

The kernels' launch counters are zeroed before each serving run and
before each training step (in the rank processes), and read after it
(the kernels line's ``launches_by_path`` counts the flat training runs
as ``train``, 7b's as ``train_hier``, 7c's as ``train_tp``, 7d's as
``train_ragged``, 7e's as ``train_moe``, 7f's as ``serve_moe``, 7g's as
``train_hybrid``, 7h's as ``train_hybrid_tp``, 7i's as ``train_audio``
and ``train_vlm``, 7j's as ``train_pp``, 7k's with 7d's, 7l's
chunked_reduce as ``train_survivor``, Zamba2's serving as ``serve_hybrid`` and the
non-text models' as ``serve_audio`` and ``serve_vlm``, phase 8's as
``example_train_lm``, ``example_train_lm_tp``, ``example_quickstart``,
``example_serve_lm``, ``example_serve_lm_ssm`` and
``example_autotune``; ssm_scan's
backward kernel under ``backward_launches_by_path``):
the training path's four kernels and rms_norm's backward kernel must
have run on it, rms_norm and
flash_attention on the serving path too, rms_norm and ssm_scan on the
SSM serving path, all three on the hybrid one, ssm_scan's backward on
the hybrid training paths, and the two reduce_scatter kernels on the
kernel API path (their counters are zeroed before it and read after).
The last three lines of standard output are the kernels' JSON line,
the card's name and power limit, and the result line.  The full
record, with the wall seconds of every phase (``phase_walls_s``), goes
to ``chip_smoke.json`` in ``OUT_DIR``.
"""
from __future__ import annotations

import datetime
import functools
import gc
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"       # the record and the tuned plan
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BW = 3.35e12                                   # H100 SXM, bytes/s
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}   # FLOP/s
TF32_PEAK = 495e12     # tensor cores, FLOP/s; 3xTF32 issues 3 per product
# the kernels that run f32 products on the tensor cores in 3xTF32: their
# second bound counts that instruction path, and the names by which the
# training step's profile reports them
TC_KERNELS = {"all_gather_matmul": "agm_tf32x3_kernel",
              "flash_attention": "flash_fwd_kernel"}
# rms_norm's kernels by the names the training step's profile gives them
RMS_KERNELS = {"rms_norm": "rmsnorm_fwd_kernel",
               "rms_norm_vjp": "rmsnorm_bwd_kernel",
               "rms_norm_vjp_colsum": "rmsnorm_colsum_kernel"}
# ssm_scan's kernels by the names the training step's profile gives them:
# the forward, the backward's scan and its fixed-order sums (per head the
# row and column sums, per channel the partial sums)
SSM_KERNELS = {"ssm_scan": "ssm_scan_kernel",
               "ssm_scan_vjp": "ssm_scan_bwd_kernel",
               "ssm_scan_vjp_rows": "bwd_rows_kernel",
               "ssm_scan_vjp_colsum": "col_sum_kernel",
               "ssm_scan_vjp_partials": "sum_partials_kernel"}
EXP_RATE = 16 * 132 * 1.98e9    # SFU exps/s: 16 per clock per SM, 132 SMs
# (rtol, atol).  chunked_reduce: the kernel and torch sum the sources in
# other orders, n_src - 1 roundings of partial sums up to about 16
# (f32), one ulp of the output (bf16).  Gradients: the kernels' backward
# against autograd through the plain version, in other summation orders.
TOL = {"rms_norm": {torch.float32: (1e-5, 1e-5),
                    torch.bfloat16: (1e-2, 1e-2)},
       "flash_attention": {torch.float32: (1e-4, 2e-5),
                           torch.bfloat16: (2e-2, 2e-2)},
       "chunked_reduce": {torch.float32: (1e-6, 2e-5),
                          torch.bfloat16: (8e-3, 8e-3)},
       # as tests/test_kernels.py holds the Pallas kernel; bf16: y rounds
       # to bf16 after the f32 sum, the sum's order differs
       "ssm_scan": {torch.float32: (1e-4, 1e-4),
                    torch.bfloat16: (1e-2, 1e-2)},
       # N = 64 at L = 4096: y sums 64 lanes of a state rounded 4096
       # times in f32; the plain version and the kernel each drift from
       # an f64 evaluation by about the (1e-4, 1e-4) band, each within
       # (2e-4, 2e-4) (tests/test_torch_mamba2.py::
       # test_long_scan_f32_error_at_n64), so against each other 4e-4
       "ssm_scan_long": (4e-4, 4e-4),
       "grad": {torch.float32: (1e-4, 1e-4)},
       # ssm_scan's backward against autograd through the plain loop:
       # (rtol, atol as a fraction of the grad's largest entry); the
       # kernel sums over L, N and the channels in other orders
       "ssm_scan_grad": (1e-4, 1e-5),
       # the JAX test's bf16 band; f32 widened from its rtol 1e-6, atol
       # 1e-7: the kernel and torch sum the D squares in other orders (a
       # random walk of about sqrt(D) roundings of 2^-24 relative, 1e-6 at
       # D = 2048), and the result is their rsqrt times values up to ~5
       "reduce_scatter_rmsnorm": {torch.float32: (1e-5, 1e-6),
                                  torch.bfloat16: (2e-2, 1e-2)},
       # the JAX test's tolerances: every step is one IEEE-rounded op on
       # both sides, only the shard sum may associate differently; a bf16
       # param (p' only) takes the bf16 band
       "reduce_scatter_adamw": {torch.float32: (1e-6, 1e-7),
                                torch.bfloat16: (2e-2, 1e-2)}}
PROMPT, NEW, SLOTS, BT = 1024, 16, 4, 16
DP, TRAIN_BATCH, TRAIN_STEPS = 4, 4, 3
# the (pod, data) path: the pool spans the pods, GPU links sit inside one
HIER_TOPOLOGY = "pod:cxl,data:ici"
# the kernels every rank must launch every step of a (pod, data) or a
# (data, model) run
HIER_KERNELS = ("chunked_reduce", "rms_norm", "rms_norm_vjp",
                "flash_attention")
# the tensor-parallel path: (data, model) = (2, 2), both levels on the
# pool (the reference's default puts model on ici, which on one host is
# gloo's stand-in)
TP_MESH, TP_TOPOLOGY = "2x2", "data:cxl,model:cxl"
TP_DP = TP_TP = 2
# the pipeline path (phase 7j): --mesh 4x1 --pp-stages 2 is (stage, data)
# = (2, 2), each data rank's 2 sequences in 2 microbatches; both levels
# on the pool
PP_STAGES, PP_MICROBATCHES = 2, 2
PP_TOPOLOGY = "stage:cxl,data:cxl"
PP_FLAGS = ["--mesh", f"{DP}x1", "--pp-stages", str(PP_STAGES),
            "--microbatches", str(PP_MICROBATCHES), "--topology",
            PP_TOPOLOGY]
TP_TOKENS = TRAIN_BATCH // TP_DP * PROMPT      # one rank's tokens, T
# all_gather_matmul on the (data, model) path (--fuse-kernels): x (T,
# n*Ks) @ (n, Ks, N), n = 2 data shards of Ks = 1024 rows, N this model
# rank's columns of wq, wk/wv and wg/wu; Zamba2's shared block at tp 2
# (phase 7h) gives the first and the last (its 32 kv heads: wk / wv at N
# = 1024 too)
AGM_TP_SHAPES = ((TP_TOKENS, 2, 1024, 1024), (TP_TOKENS, 2, 1024, 256),
                 (TP_TOKENS, 2, 1024, 4096))
# flash_attention there (and in 7h's shared block): 2 sequences of one
# rank, its 16 of the 32 heads
FA_TP_SHAPE = (TRAIN_BATCH // TP_DP, PROMPT, 32 // TP_TP, 64)
# the MoE path: Granite-3.0-MoE at full width over (data, model) = (2, 2),
# both levels on the pool, experts parallel over model.  --prefetch 0:
# with the double-buffered gather every row's gathered params (201.6 MB a
# rank) live until its backward, 6.4 GB a rank on top of 13.5 GB of
# params, grads and moments - more than a quarter of the card
MOE_ARCH = "granite-moe-3b"
MOE_D, MOE_HEADS, MOE_KV = 1536, 24, 8
MOE_PREFETCH = "0"
# all_gather_matmul there (--fuse-kernels): x (T, 2 x 768) @ (2, 768, N),
# this model rank's columns of wq (N = 768) and wk/wv (256); the MoE's
# expert stacks are 3-D and gather concatenated, as in the JAX package
AGM_MOE_SHAPES = ((TP_TOKENS, 2, 768, 768), (TP_TOKENS, 2, 768, 256))
# flash_attention there: a rank's 2 sequences, its 12 of the 24 q heads
# (its 4 kv heads repeated 3:1)
FA_MOE_SHAPE = (TRAIN_BATCH // TP_DP, PROMPT, MOE_HEADS // TP_TP, 64)
RMS_MOE = (TP_TOKENS, MOE_D)
# the checkpoints the training phase writes and deletes (inside the
# checkout, git-ignored)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# the grouped (ragged) path: the 4 data ranks as a node of three beside a
# lone node, one flat data axis; and the physical topology whose
# placement (--placement auto) gives it
RAGGED_TOPOLOGY = "pod:cxl,data:cxl:3+1"
RAGGED_PLACEMENT_TOPOLOGY = "pod:cxl,node:cxl:3+1"
RAGGED_GROUPS = (3, 1)
# 7k: the grouped path's auto run under a fault, through the launcher's
# flags: rank 1 (in the group of three) dies at step 1; the reference's
# rule confirms it at step 1 + timeout 1 + patience 2 - 1 = 3, re-plans
# data to 2+1 and rolls every rank back to the newest step all four
# committed (0: rank 1's step-2 snapshot fails)
RESIL_FAULT = "rank_death@1:rank=1"
RESIL_STEPS, RESIL_INTERVAL, RESIL_CONFIRM = 6, 2, 3
RESIL_REASON = "survivors on data: -[1] -> 2+1"
# the earlier paths' runs but the profiled first, and the gloo-bound ones,
# take 2 steps (step 0 and one to show the loss fall)
SHORT_STEPS = 2
# depth cuts of earlier paths (the time limit): Phi-3-vision's training
# runs (7i) and Granite-3.0-MoE's (7e) keep the first 8 of their 32 rows
# at full width; every count they check is reckoned from the rows kept
VLM_TRAIN_ROWS = MOE_TRAIN_ROWS = 8
# the Llama runs with gloo-bound steps keep 4 of the 16 rows: the flat
# ring run, (pod, data)'s auto (its ici level rides gloo) and 7c's
# re-tuned auto (its step 2 sends the big cells to gloo) with tp_auto,
# the run it is held to; ``cut_cxl``, a cxl run of the same cut model in
# the flat spawn, is what their step-0 losses are held to
GLOO_ROWS = 4
CUT_RUNS = ("ring", "cut_cxl")
CUT_TP_RUNS = ("tp_auto", "tp_auto_retune")
# phase 8, the examples (``repro_torch.examples``): 8a train_lm at one
# rank, 8b at (data, model) = (2, 2) under cxl in 7c's spawn, 8c
# quickstart's part 3 in the flat spawn (the spawn that maps a pool of
# all four ranks), 8d serve_lm, 8e autotune_workflow's auto step
TRAIN_LM_STEPS, TRAIN_LM_TP_STEPS = 30, 4
# train_lm's row norms at d_model 768: 8a's batch of 8 x 256 tokens, and
# a rank's 4 x 256 of it at data 2 in 8b
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_D = 8, 256, 768
RMS_TRAIN_LM = (TRAIN_LM_BATCH * TRAIN_LM_SEQ, TRAIN_LM_D)
RMS_TRAIN_LM_TP = (TRAIN_LM_BATCH // TP_DP * TRAIN_LM_SEQ, TRAIN_LM_D)
TRAIN_LM_DIR = CKPT_DIR / "train_lm"
SERVE_LM_RUNS = {"serve_lm": ["--arch", "llama3.2-1b"],
                 "serve_lm_ssm": ["--arch", "falcon-mamba-7b", "--window",
                                  "64"]}


def cut_config(arch: str, rows: int):
    """``arch``'s full-width config cut to its first ``rows`` rows (its
    widths, vocabulary and frontend unchanged)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, name=f"{cfg.name}[{rows} of {cfg.n_layers} rows]",
        n_layers=rows, layer_pattern=cfg.layer_pattern[:rows])
# the flat collectives table runs ring (gloo) up to this size a rank
RING_MAX_MB = 16
# the tuple collectives table's sizes a rank (256 MB, under auto about a
# second a call, is left to ``launch.collectives --multi-pod``)
TUPLE_SIZES_MB = (1, 16)
TUNE_SIZES_MIB = ("1", "4", "16", "64", "256")
# reduce_scatter_rmsnorm (n_src, T, D): the JAX test shapes, one rank's
# 1024 tokens at d_model 2048, a ragged T
RS_RMSNORM_SHAPES = ((2, 128, 64), (4, 256, 32), (3, 37, 48), (8, 1, 16),
                     (DP, PROMPT, 2048), (DP, 1000, 2048))
RS_RMSNORM_MAIN = (DP, PROMPT, 2048)
# reduce_scatter_adamw (n_src, L, weight decay): the JAX test shapes; the
# path's (DP, one rank's segment of a row's grads) and a ragged L follow
RS_ADAMW_SHAPES = ((2, 2048, 0.0), (4, 3 * 2048, 0.1), (3, 1000, 0.0),
                   (6, 7, 0.01))
ADAMW_HYPER = (3e-3, 1.0 - 0.9 ** 3, 1.0 - 0.95 ** 3)    # lr, bc1, bc2
# all_gather_matmul on the training path (--fuse-kernels): x (T, n*Ks) @
# (n, Ks, N) for wq, wk/wv and wg/wu of Llama-3.2-1B, T = 1024 tokens of
# one rank.  wo and wd are FSDP-sharded on their dim 1 (dim 0 carries the
# model axis), so they gather concatenated; wd's shape is checked too.
AGM_SHAPES = ((1024, 4, 512, 2048), (1024, 4, 512, 512),
              (1024, 4, 512, 8192), (1024, 4, 2048, 2048))
AGM_MAIN = (1024, 4, 512, 8192)
RAGGED = 1000003


def hier_reduce_shapes(rs_len: int) -> tuple:
    """chunked_reduce on the (pod, data) = (2, DP/2) path: the pod level
    reduce-scatters a row's grads over 2 (2 rs_len a rank), the data
    level the pod's half over 2 (rs_len)."""
    return ((2, 2 * rs_len), (2, rs_len))


def ragged_reduce_shapes(rs_len: int) -> tuple:
    """chunked_reduce on the grouped (3, 1) path: a row's grad bucket
    (DP rs_len, the whole row a rank) summed within the group of three
    and then across the two group sub-roots; a gathered row sums across
    the sub-roots at the same length."""
    return ((RAGGED_GROUPS[0], DP * rs_len), (len(RAGGED_GROUPS),
                                              DP * rs_len))


def tp_reduce_shapes(rs_len: int) -> tuple:
    """chunked_reduce on the (data, model) = (2, 2) path: a model-level
    activation AllReduce of (T, 2048) f32 (two-phase: each rank reduces
    2 sources of half of it), and the data level's reduce-scatter of a
    row's grads (this model rank's half of the row over 2 data ranks:
    rs_len a rank, as at DP 4)."""
    return ((2, TP_TOKENS * 2048 // 2), (2, rs_len))


def moe_reduce_shapes() -> tuple:
    """chunked_reduce on the MoE path: the model level's activation
    AllReduce of (T, 1536) f32 (half of it a rank, two sources), and the
    data level's reduce-scatter of one model rank's half of a row's FSDP
    bucket (its attention columns, the router and its 20 experts) over 2
    data ranks."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, sharding
    cfg = get_config(MOE_ARCH)
    sharding.set_mesh_sizes({"data": TP_DP, "model": TP_TP})
    abstract = model.abstract_params(cfg, tp=TP_TP)
    specs = sharding.param_specs(abstract, cfg, dp_axis="data")
    bucket = sum(x[0].numel() // (TP_TP if "model" in s else 1)
                 for (_, x), (_, s) in zip(
                     tree.leaves_with_paths(abstract["g0"]),
                     tree.leaves_with_paths(specs["g0"])) if "data" in s)
    return ((2, TP_TOKENS * MOE_D // 2), (2, bucket // TP_DP))


def hybrid_reduce_shapes() -> tuple:
    """chunked_reduce on the hybrid path (FSDP over DP ranks at tp = 1):
    the reduce-scatters of a Mamba-2 row's bucket, of ``shared_a``'s,
    and of ``shared_a``'s two buckets under ``--fuse-kernels`` (the
    matmul weights sharded on dim 0, then wo and wd), each DP sources of
    one rank's segment."""
    from repro_torch.configs import get_config
    from repro_torch.core import overlap, tree
    from repro_torch.models import model, sharding
    cfg = get_config(HYBRID_ARCH)
    sharding.set_mesh_sizes({"data": DP})
    abstract = model.abstract_params(cfg)
    specs = sharding.param_specs(abstract, cfg, dp_axis="data")

    def sharded(key, row):
        return [(path[-1], s.index("data") - int(row),
                 (x[0] if row else x).numel())
                for (path, x), (_, s) in zip(
                    tree.leaves_with_paths(abstract[key]),
                    tree.leaves_with_paths(specs[key])) if "data" in s]
    shared = sharded("shared_a", False)
    fused = sum(n for name, dim, n in shared
                if name in overlap.FUSABLE_PARAMS and dim == 0)
    lengths = (sum(n for *_, n in sharded("g0", True)),
               sum(n for *_, n in shared), fused,
               sum(n for *_, n in shared) - fused)
    return tuple((DP, n // DP) for n in lengths)


def hybrid_tp_reduce_shapes() -> tuple:
    """chunked_reduce on the hybrid path at (data, model) = (2, 2), all
    at N = 2: the model level's AllReduces (two-phase: each rank reduces
    2 sources of half) of a row's output (T, 2048) f32 and of the gated
    norm's sum of squares (T, 1) f32, and the data level's
    reduce-scatters of this model rank's share of a Mamba-2 row's FSDP
    bucket, of ``shared_a``'s, and of ``shared_a``'s two buckets under
    ``--fuse-kernels`` (the matmul weights sharded on dim 0, then wo and
    wd), each over 2 data ranks."""
    from repro_torch.configs import get_config
    from repro_torch.core import overlap, tree
    from repro_torch.models import model, sharding
    cfg = get_config(HYBRID_ARCH)
    sharding.set_mesh_sizes({"data": TP_DP, "model": TP_TP})
    abstract = model.abstract_params(cfg, tp=TP_TP)
    specs = sharding.param_specs(abstract, cfg, dp_axis="data")

    def sharded(key, row):
        return [(path[-1], s.index("data") - int(row),
                 (x[0] if row else x).numel() // (TP_TP if "model" in s
                                                  else 1))
                for (path, x), (_, s) in zip(
                    tree.leaves_with_paths(abstract[key]),
                    tree.leaves_with_paths(specs[key])) if "data" in s]
    shared = sharded("shared_a", False)
    fused = sum(n for name, dim, n in shared
                if name in overlap.FUSABLE_PARAMS and dim == 0)
    lengths = (sum(n for *_, n in sharded("g0", True)),
               sum(n for *_, n in shared), fused,
               sum(n for *_, n in shared) - fused)
    return ((2, TP_TOKENS * cfg.d_model // 2), (2, TP_TOKENS // 2)) + \
        tuple((TP_DP, n // TP_DP) for n in lengths)


def pp_reduce_shapes() -> tuple:
    """chunked_reduce on the pipeline path, all at N = 2: the stage
    level's sums of the embedding's and the final norm's grads and of
    the loss's two scalars, the data level's mean of each grad leaf (a
    stage's slab of each ``g0`` leaf) and of the loss; under cxl each a
    two-phase AllReduce (each rank reduces 2 sources of half the leaf,
    padded to even), under auto the plan's faithful cells (2 sources of
    the whole leaf)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model
    sizes = {x.numel() // (PP_STAGES if path[0].startswith("g") else 1)
             for path, x in tree.leaves_with_paths(model.abstract_params(
                 get_config("llama3.2-1b")))} | {1}
    return tuple(dict.fromkeys([(2, -(-n // 2)) for n in sorted(sizes)]
                               + [(2, n) for n in sorted(sizes)]))


def pp_rank_launches(stage: int) -> dict:
    """The kernels a pipeline rank of Llama-3.2-1B launches a step: each
    of its stage's rows runs each microbatch once forward and once in
    the remat replay (flash_attention once a pass, rms_norm twice) and
    once backward (rms_norm's backward twice); the last stage adds the
    final norm of each microbatch (outside the checkpointed rows) and
    its backward."""
    from repro_torch.configs import get_config
    rows = len(get_config("llama3.2-1b").layer_pattern) // PP_STAGES
    passes = rows * PP_MICROBATCHES
    last = PP_MICROBATCHES if stage == PP_STAGES - 1 else 0
    return {"flash_attention": 2 * passes, "rms_norm": 4 * passes + last,
            "rms_norm_vjp": 2 * passes + last}


def frontend_reduce_shapes(arch: str) -> tuple:
    """chunked_reduce on a non-text model's flat path (FSDP over DP
    ranks, cxl): the reduce-scatters of a decoder row's FSDP bucket, and
    of its two buckets under ``--fuse-kernels`` (the matmul weights
    sharded on dim 0, then the rest), each DP sources of one rank's
    segment; then the grad sync's AllReduces (two-phase: DP sources of a
    DP-th) of the dp-replicated leaves, bucketed as the trainer buckets
    them (whisper's encoder and ``enc_proj``, Phi-3's ``front_proj``,
    the norms)."""
    from repro_torch.configs import get_config
    from repro_torch.core import overlap, tree
    from repro_torch.models import model, sharding
    cfg = get_config(arch)
    sharding.set_mesh_sizes({"data": DP})
    abstract = model.abstract_params(cfg)
    specs = sharding.param_specs(abstract, cfg, dp_axis="data")
    row = [(path[-1], s.index("data") - 1, x[0].numel())
           for (path, x), (_, s) in zip(
               tree.leaves_with_paths(abstract["g0"]),
               tree.leaves_with_paths(specs["g0"])) if "data" in s]
    fused = sum(n for name, dim, n in row
                if name in overlap.FUSABLE_PARAMS and dim == 0)
    total = sum(n for *_, n in row)
    synced = [(i, tuple(x.shape), x.dtype, ("data",)) for i, ((_, x), (
        _, s)) in enumerate(zip(tree.leaves_with_paths(abstract),
                                tree.leaves_with_paths(specs)))
        if "data" not in s]
    lengths = [total, fused, total - fused] + [
        b.elems for b in overlap.assign_buckets(
            synced, overlap.DEFAULT_BUCKET_BYTES)]
    return tuple((DP, -(-n // DP)) for n in lengths)


SSM_ARCH = "falcon-mamba-7b"
# (B, L, D, N, from a random state): the JAX test shapes, Falcon's prefill
# (1 x 1024) and decode (4 slots) shapes, a ragged L from a random state;
# L one under and over a 64-step ring stage and two stages + 1; L = 4096
SSM_SHAPES = ((2, 256, 256, 16, False), (1, 128, 512, 8, False),
              (2, 64, 128, 4, False), (1, PROMPT, 8192, 16, False),
              (2, 300, 8192, 16, True), (SLOTS, 1, 8192, 16, True),
              (1, 63, 8192, 16, True), (1, 65, 8192, 16, False),
              (1, 129, 8192, 16, True), (1, 4096, 8192, 16, False))
SSM_BF16 = (2, 300, 8192, 16, True)
# the hybrid path: Zamba2-1.2B (32 Mamba-2 rows at d_inner 4096, N = 64,
# one shared attention block applied 6 times)
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_D, HYBRID_N, HYBRID_HEADS = 4096, 64, 64   # d_inner, d_state, nh
HYBRID_HEADDIM = HYBRID_D // HYBRID_HEADS
# the hybrid path at tp 2 (phase 7h): Zamba2-1.2B over (data, model) =
# (2, 2), both levels on the pool.  A rank's scan: its 2 rows of 1024
# tokens, its 32 of the 64 heads (b, l, heads, headdim, N); the
# per-channel backward at Falcon-Mamba-7B's tp-2 width (its 4096 of 8192
# channels: b, l, d, N), reached by the kernel phases and the smoke
# model only (the 7B model does not fit four ranks in f32)
SSM_TP_HEADS = (TRAIN_BATCH // TP_DP, PROMPT, HYBRID_HEADS // TP_TP,
                HYBRID_HEADDIM, HYBRID_N)
SSM_TP_CHANNEL = (TRAIN_BATCH // TP_DP, PROMPT, 8192 // TP_TP, 16)
# ssm_scan at N = 64: Zamba2's prefill and training shape (1 x 1024, a
# rank's rows), a decode step (4 slots, from the cached state), a ragged
# L from a state, L = 4096, and a rank's scan at tp 2
SSM64_SHAPES = ((1, PROMPT, HYBRID_D, HYBRID_N, False),
                (SLOTS, 1, HYBRID_D, HYBRID_N, True),
                (2, 300, HYBRID_D, HYBRID_N, True),
                (1, 4096, HYBRID_D, HYBRID_N, False),
                (SSM_TP_HEADS[0], PROMPT, HYBRID_D // TP_TP, HYBRID_N,
                 False))
# the backward kernel against autograd through the plain version:
# Falcon-Mamba's training shape, Zamba2's, L = 4096 (at 1024 channels:
# the plain version's autograd keeps every step's state), from h0 with
# a cotangent on h_last, and Falcon-Mamba's at tp 2
SSM_BWD_SHAPES = ((1, PROMPT, 8192, 16, False),
                  (1, PROMPT, HYBRID_D, HYBRID_N, False),
                  (1, 4096, 1024, HYBRID_N, False),
                  (2, 300, HYBRID_D, HYBRID_N, True),
                  SSM_TP_CHANNEL + (False,))
# the same through the per-head entry (ssm_scan_heads, the backward
# kernel's head mode) at Zamba2's heads of 64: (b, l, heads, headdim, N,
# h0); the last a rank's at tp 2
SSM_HEAD_BWD_SHAPES = (
    (1, PROMPT, HYBRID_HEADS, HYBRID_HEADDIM, HYBRID_N, False),
    (1, 4096, 1024 // HYBRID_HEADDIM, HYBRID_HEADDIM, HYBRID_N, False),
    (2, 300, HYBRID_HEADS, HYBRID_HEADDIM, HYBRID_N, True),
    SSM_TP_HEADS + (False,))
# the SSM smoke models' training, card vs CPU, at sequences of 128: the
# CPU's plain scan is a Python loop over L, four ranks sharing the
# machine's 8 cores (about 4 min a run at 1024)
SSM_SMOKE_SEQ = 128
# the kernels every rank must launch every step of the hybrid path
HYBRID_KERNELS = ("rms_norm", "rms_norm_vjp", "flash_attention",
                  "ssm_scan", "ssm_scan_vjp")
# the kernels of the Llama training paths (the counters' other names are
# the SSM kernels')
LLAMA_TRAIN_KERNELS = ("rms_norm", "rms_norm_vjp", "flash_attention",
                       "chunked_reduce", "all_gather_matmul")
# the non-text models: whisper-tiny (4 encoder + 4 decoder rows, d_model
# 384, 6 heads of 64, an audio stub of 1500 frames; cross attention in
# every decoder row) and Phi-3-vision-4.2B (32 rows, d_model 3072, 32
# heads of 96, 576 patch embeddings ahead of the tokens)
AUDIO_ARCH, VLM_ARCH = "whisper-tiny", "phi-3-vision-4.2b"
AUDIO_FRAMES, VLM_PREFIX = 1500, 576
VLM_TOKENS = VLM_PREFIX + PROMPT
# Phi-3-vision trains at --prefetch 0: 3.8B f32 params, grads and AdamW
# moments take 14.2 GiB a rank; prefetch 1 would keep every row's
# gathered params (453 MB) until its backward
VLM_PREFETCH = "0"
# flash_attention there (b, lq, lk, heads, head_dim, causal): whisper's
# encoder (non-causal, 1500 = 23 x 64 + 28: ragged last q and kv tiles)
# and cross attention (lq != lk) on the fixed batch of SLOTS prompts,
# Phi-3-vision's 576 + 1024 tokens at head_dim 96 (causal), a ragged
# D = 96 case
FA_FRONTEND = {
    "audio_encoder": (SLOTS, AUDIO_FRAMES, AUDIO_FRAMES, 6, 64, False),
    "audio_cross": (SLOTS, PROMPT, AUDIO_FRAMES, 6, 64, False),
    "vlm_d96": (1, VLM_TOKENS, VLM_TOKENS, 32, 96, True),
    "d96_ragged": (2, 77, 141, 3, 96, True)}
# their gradients at a training rank's shapes (one sequence a rank)
FA_FRONTEND_GRAD = ((1, PROMPT, AUDIO_FRAMES, 6, 64, False),
                    (1, AUDIO_FRAMES, AUDIO_FRAMES, 6, 64, False),
                    (1, VLM_TOKENS, VLM_TOKENS, 32, 96, True))
RMS_AUDIO = (AUDIO_FRAMES, 384)      # whisper's encoder rows
RMS_VLM = (VLM_TOKENS, 3072)         # Phi-3-vision's rows
# all_gather_matmul under --fuse-kernels at --mesh 4x1: x (T, 4 x Ks) @
# (4, Ks, N); whisper's wq / wk / wv (N = 384; T = 1500 for cross
# attention's wk / wv on the encoder's output) and wg / wu (1536),
# Phi-3-vision's wq / wk / wv (3072) and wg / wu (8192) at T = 1600
AGM_AUDIO_SHAPES = ((PROMPT, DP, 96, 384), (AUDIO_FRAMES, DP, 96, 384),
                    (PROMPT, DP, 96, 1536))
AGM_VLM_SHAPES = ((VLM_TOKENS, DP, 768, 3072), (VLM_TOKENS, DP, 768, 8192))
# rms_norm (T, D): Llama's prefill and decode, Falcon-Mamba's; the
# training path's backward (one rank's 1024 tokens at d_model 2048);
# train_lm's at one rank and a rank of (data, model)
RMS_SHAPES = ((PROMPT, 2048), (SLOTS, 2048), (PROMPT, 4096), (SLOTS, 4096),
              RMS_MOE, (TP_TOKENS, 2048), RMS_AUDIO, RMS_VLM, RMS_TRAIN_LM,
              RMS_TRAIN_LM_TP)
RMS_BWD = (PROMPT, 2048)
RMS_TP = (TP_TOKENS, 2048)       # a rank's row norms at (data, model)
RMS_HYBRID = (PROMPT, HYBRID_D)      # Zamba2's gated norm over d_inner
# the kernels each serving path must launch
SERVE_KERNELS = {"serve": ("rms_norm", "flash_attention"),
                 "serve_ssm": ("rms_norm", "ssm_scan"),
                 "serve_moe": ("rms_norm", "flash_attention"),
                 "serve_hybrid": ("rms_norm", "flash_attention",
                                  "ssm_scan"),
                 "serve_audio": ("rms_norm", "flash_attention"),
                 "serve_vlm": ("rms_norm", "flash_attention")}


def gemm_tol(k: int) -> tuple:
    """Two f32 matrix products over a contraction of K unit-normal
    products, summed in other orders (the kernel keeps one running sum
    per output; cuBLAS may split K): the partial sums grow like sqrt(K),
    so the rounding's random walk has a spread of about K * 2^-24, and
    the largest of some 10^7 outputs reaches several times that."""
    return 1e-4, 8 * k * 2.0 ** -24


KERNELS = {   # name -> (source, the Pallas TPU kernel it replaces)
    "rms_norm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:36"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "chunked_reduce": ("src/repro_torch/kernels/csrc/chunked_reduce.cu",
                       "src/repro/kernels/chunked_reduce.py:40"),
    "all_gather_matmul": ("src/repro_torch/kernels/csrc/"
                          "all_gather_matmul.cu",
                          "src/repro/kernels/fused_collectives.py:192"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:72"),
    "reduce_scatter_adamw": ("src/repro_torch/kernels/csrc/"
                             "reduce_scatter_adamw.cu",
                             "src/repro/kernels/fused_collectives.py:130"),
    "reduce_scatter_rmsnorm": ("src/repro_torch/kernels/csrc/"
                               "reduce_scatter_rmsnorm.cu",
                               "src/repro/kernels/fused_collectives.py:69"),
}
# the kernels the kernel API phase drives (no model path calls them)
API_KERNELS = ("reduce_scatter_rmsnorm", "reduce_scatter_adamw")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def close(got, want, rtol, atol) -> tuple:
    """(max abs error, within tolerance) in the style of assert_close."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.all(err <= atol + rtol * want.abs())
              and torch.all(torch.isfinite(got)))
    return float(err.max()), ok


class Timer:
    """Mean device time of ``fn()`` over ``iters`` calls.  Before each
    call a 256 MiB write evicts the 50 MB L2 (inputs arrive cold), then
    the device spins for about a millisecond while the host enqueues
    ``fn``, so the events bracket device work only, not Python's launch
    overhead."""

    SLEEP_CYCLES = 2_000_000

    def __init__(self):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32,
                                     device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def device_profile(fn) -> dict:
    """Device kernel time by name for one call of ``fn`` under
    ``torch.profiler``, the device kernels it launched, and the device's
    busy share of the wall time (the profiler's own host overhead is
    inside that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    busy = sum(t for _, t in kern)
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return {"wall_us": wall_us, "device_busy_us": busy,
            "kernel_launches": launches,
            "busy_share": busy / wall_us if wall_us else None,
            "top": [{"kernel": k[:80], "us": t} for k, t in kern[:8]]}


def repeat_parity(randn, fa, fc) -> list:
    """The two tensor-core kernels run twice on the same inputs at the
    main paths' shapes: the results must be bitwise equal."""
    out = []
    for t, n, ks, nout in AGM_SHAPES:
        x, w = randn(t, n * ks), randn(n, ks, nout)
        a, b = fc.all_gather_matmul(x, w), fc.all_gather_matmul(x, w)
        out.append({"kernel": "all_gather_matmul", "check": "repeat",
                    "shape": [t, n, ks, nout], "dtype": str(torch.float32),
                    "max_abs_err": float((a - b).abs().max()),
                    "ok": bool(torch.equal(a, b))})
    fa_shapes = [(1, PROMPT, PROMPT, 32, 64, True)] + [
        FA_FRONTEND[k] for k in ("audio_cross", "vlm_d96")]
    for dtype in (torch.float32, torch.bfloat16):
        for b_, lq, lk, h, d, causal in fa_shapes:
            q = randn(b_, lq, h, d, dtype=dtype)
            k, v = (randn(b_, lk, h, d, dtype=dtype) for _ in range(2))
            a = fa._launch(q, k, v, causal, None, 0, lk, True)
            b = fa._launch(q, k, v, causal, None, 0, lk, True)
            out.append({"kernel": "flash_attention", "check": "repeat",
                        "shape": [b_, lq, lk, h, d], "causal": causal,
                        "dtype": str(dtype),
                        "max_abs_err": max(float((x - y).float().abs()
                                                 .max())
                                           for x, y in zip(a, b)),
                        "ok": all(torch.equal(x, y) for x, y in zip(a, b))})
    return out


def grad_parity(randn, rn, fa, fc) -> list:
    """Gradients through each differentiable kernel path against
    autograd through the plain version, on the same inputs and the same
    upstream gradient: rms_norm's forward and backward kernels,
    flash_attention's forward kernel and recompute VJP, fused_dense's
    kernel and plain matmul transposes."""
    out = []

    def compare(name, shape, fns, inputs, g,
                tol=TOL["grad"][torch.float32]):
        res = []
        for fn in fns:
            xs = [t.clone().requires_grad_() for t in inputs]
            (fn(*xs) * g).sum().backward()
            res.append([t.grad for t in xs])
        errs = [close(a, b, *tol) for a, b in zip(*res)]
        out.append({"kernel": name, "check": "grad", "shape": shape,
                    "dtype": str(torch.float32), "tolerance": tol,
                    "max_abs_err": max(e for e, _ in errs),
                    "ok": all(ok for _, ok in errs)})

    for t, d in (RMS_BWD, RMS_MOE, RMS_HYBRID, RMS_AUDIO, RMS_VLM,
                 RMS_TRAIN_LM, RMS_TRAIN_LM_TP):
        before = rn.rms_norm_vjp.launches
        compare("rms_norm", [t, d], (rn.rms_norm, rn.rms_norm_plain),
                [randn(t, d), randn(d)], randn(t, d))
        if rn.rms_norm_vjp.launches != before + 1:
            fail("rms_norm's gradient did not come from its backward "
                 "kernel")
    for shape in ((1, PROMPT, 32, 64), FA_MOE_SHAPE):
        qkv = [randn(*shape) for _ in range(3)]
        compare("flash_attention", list(shape),
                (lambda q, k, v: fa.flash_attention_train(q, k, v, True),
                 lambda q, k, v: fa.flash_attention_plain(q, k, v, True)),
                qkv, randn(*shape))
    # the non-text models' shapes: cross attention (lq != lk), whisper's
    # encoder, Phi-3-vision's head_dim 96
    for b, lq, lk, h, d, causal in FA_FRONTEND_GRAD:
        compare("flash_attention", [b, lq, lk, h, d],
                (lambda q, k, v, c=causal: fa.flash_attention_train(
                    q, k, v, c),
                 lambda q, k, v, c=causal: fa.flash_attention_plain(
                     q, k, v, c)),
                [randn(b, lq, h, d), randn(b, lk, h, d), randn(b, lk, h, d)],
                randn(b, lq, h, d))
    t, n, ks, nout = AGM_MAIN
    # dx contracts over N, dw over T: both through torch.matmul, batched
    # over the shards on one side and whole on the other
    compare("all_gather_matmul", list(AGM_MAIN),
            (fc.fused_dense, lambda x, w: x @ w.reshape(n * ks, nout)),
            [randn(t, n * ks), randn(n, ks, nout)], randn(t, nout),
            gemm_tol(max(t, n * ks, nout)))
    return out


def _train_args(extra: list, mesh: str = f"{DP}x1",
                steps: int = TRAIN_STEPS, arch: str = "llama3.2-1b",
                seq: int = PROMPT) -> list:
    """The drive command's flags.  The full-width runs take --lr 3e-5:
    3 steps give the launcher's schedule no warm-up, and AdamW's first
    steps move every weight by about lr; on these random weights the
    loss along that path bottoms out before 1e-4 of travel, so at lr
    3e-4 and 1e-4 the second update overshoots (losses 12.12, 11.40,
    14.21 and 12.12, 10.57, 13.14 under all three backends alike)."""
    return ["--arch", arch, "--mesh", mesh, "--steps",
            str(steps), "--batch", str(TRAIN_BATCH), "--seq",
            str(seq)] + extra


def _summarise_profile(per_rank: list) -> dict:
    """Device time by kernel summed over the ranks, with the copies
    split host-to-device and device-to-host and the cuBLAS GEMMs (by
    name) apart.  The ranks' contexts time-slice the card, so a kernel's
    recorded span can include time the card spent on another rank:
    these sums say where each rank's device time goes, not how busy the
    card was (``SmiSampler`` says that)."""
    top: dict = {}
    for p in per_rank:
        for k in p["top"]:
            top[k["kernel"]] = top.get(k["kernel"], 0.0) + k["us"]
    # the tensor-core kernels, rms_norm's and ssm_scan's by name, whether
    # or not they make the top
    named = {name: sum(us for p in per_rank
                       for k, us in p["by_kernel"].items() if fn in k)
             for name, fn in {**TC_KERNELS, **RMS_KERNELS,
                              **SSM_KERNELS}.items()}
    def by_name(pick) -> float:
        return sum(us for p in per_rank for k, us in p["by_kernel"].items()
                   if pick(k))

    gemms: dict = {}
    for p in per_rank:
        for k, us in p["by_kernel"].items():
            if "gemm" in k.lower():
                gemms[k[:80]] = gemms.get(k[:80], 0.0) + us
    return {"wall_us": max(p["wall_us"] for p in per_rank),
            "kernel_us_sum": sum(p["kernel_us"] for p in per_rank),
            "copy_us_sum": sum(p["copy_us"] for p in per_rank),
            "htod_us_sum": by_name(lambda k: "HtoD" in k),
            "dtoh_us_sum": by_name(lambda k: "DtoH" in k),
            "gemm_us_sum": sum(gemms.values()),
            "top_gemms": [{"kernel": k, "us": v} for k, v in sorted(
                gemms.items(), key=lambda kv: -kv[1])[:4]],
            "named_kernels_us_sum": named,
            "top": [{"kernel": k, "us": v} for k, v in
                    sorted(top.items(), key=lambda kv: -kv[1])[:12]]}


class SmiSampler:
    """``nvidia-smi``'s utilization.gpu (the share of each sample period
    in which a kernel of any process ran on the card), power and SM
    clock, sampled every 100 ms while the ``with`` block lasts."""

    QUERY = "timestamp,utilization.gpu,power.draw,clocks.sm"

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.rows = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                t = datetime.datetime.strptime(
                    parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.rows.append((t, *(float(p) for p in parts[1:4])))
            except (ValueError, IndexError):   # a malformed sample line
                continue
        return False

    def between(self, t0: float, t1: float) -> dict:
        rows = [r for r in self.rows if t0 <= r[0] <= t1]
        if not rows:
            return {"samples": 0}
        mean = np.mean(np.asarray(rows)[:, 1:], axis=0)
        return {"samples": len(rows), "utilization_gpu_mean": mean[0],
                "power_w_mean": mean[1], "sm_clock_mhz_mean": mean[2]}


def ssm_inputs(randn, b, l, d, n, with_h0, dtype=torch.float32):
    """x, dt, A, B, C, D of the selective scan as tests/test_kernels.py
    draws them, and a random starting state or None."""
    x = randn(b, l, d, dtype=dtype)
    dt = (randn(b, l, d).abs() * 0.1).to(dtype)
    a = -randn(d, n).abs()
    bs, cs = randn(b, l, n, dtype=dtype), randn(b, l, n, dtype=dtype)
    return (x, dt, a, bs, cs, randn(d)), (randn(b, d, n) if with_h0
                                          else None)


def ssm_cost(b, l, d, n, with_h0, itemsize: int = 4) -> dict:
    """What the scan must move and compute: x and dt read, y written
    (itemsize each), A, D, B and C read, h0 read if given, h_last
    written (f32); one exp and 6 flops per (b, t, d, n) element
    (dt*A, decay*h, +, drive*B, h*C, the sum over n)."""
    nbytes = 3 * b * l * d * itemsize + 2 * b * l * n * itemsize \
        + (d * n + d) * 4 + (1 + int(with_h0)) * b * d * n * 4
    return {"bytes": nbytes, "flops": 6 * b * l * d * n,
            "exps": b * l * d * n}


def ssm_parity(randn, ss) -> list:
    """ssm_scan's y and final state against the plain version."""
    out = []
    shapes = [(sh, torch.float32) for sh in SSM_SHAPES + SSM64_SHAPES] + \
        [(SSM_BF16, torch.bfloat16)]
    for (b, l, d, n, with_h0), dtype in shapes:
        args, h0 = ssm_inputs(randn, b, l, d, n, with_h0, dtype)
        y, h = ss.ssm_scan(*args, h0=h0, return_state=True)
        want_y, want_h = ss.ssm_scan_plain(*args, h0=h0, return_state=True)
        tol = TOL["ssm_scan_long"] if n == HYBRID_N and l > PROMPT \
            else TOL["ssm_scan"][dtype]
        errs = [close(y, want_y, *tol),
                close(h, want_h, *TOL["ssm_scan"][torch.float32])]
        out.append({"kernel": "ssm_scan", "shape": [b, l, d, n],
                    "h0": with_h0, "dtype": str(dtype), "tolerance": tol,
                    "max_abs_err": max(e for e, _ in errs),
                    "max_abs_err_h_last": errs[1][0],
                    "ok": all(ok for _, ok in errs)})
    return out


def _scan_grads(fn, args, h0, dy, dh) -> list:
    """Every input's grad of (y * dy).sum() + (h_last * dh).sum() through
    ``fn`` (ssm_scan or its plain version)."""
    leaves = [t.clone().requires_grad_() for t in
              list(args) + ([h0] if h0 is not None else [])]
    y, h = fn(*leaves[:6], h0=leaves[6] if h0 is not None else None,
              return_state=True)
    ((y.float() * dy).sum() + (h * dh).sum()).backward()
    return [t.grad for t in leaves]


def ssm_grad_parity(randn, ss) -> list:
    """Every input's grad through the scan kernels (the forward writing
    its checkpoints, one launch of the backward) against autograd through
    the plain version, with a cotangent on the final state, per channel
    (``ssm_scan``) and per head (``ssm_scan_heads``, the backward's head
    mode: ddt, dA and dD per head); a repeat must be bitwise equal and
    each backward one count of ``ssm_scan_vjp``."""
    out = []
    rtol, frac = TOL["ssm_scan_grad"]
    cases = [(b, l, d, n, with_h0, None)
             for b, l, d, n, with_h0 in SSM_BWD_SHAPES] + \
        [(b, l, nh * hd, n, with_h0, hd)
         for b, l, nh, hd, n, with_h0 in SSM_HEAD_BWD_SHAPES]
    for b, l, d, n, with_h0, hd in cases:
        args, h0 = ssm_inputs(randn, b, l, d, n, with_h0)
        if hd is not None:      # dt, A and D per head
            nh = d // hd
            args = (args[0], randn(b, l, nh).abs() * 0.1, -randn(nh).abs(),
                    args[3], args[4], randn(nh))
            fns = (functools.partial(ss.ssm_scan_heads_plain, headdim=hd),
                   functools.partial(ss.ssm_scan_heads, headdim=hd))
        else:
            fns = (ss.ssm_scan_plain, ss.ssm_scan)
        dy, dh = randn(b, l, d), randn(b, d, n)
        want = _scan_grads(fns[0], args, h0, dy, dh)
        before = ss.ssm_scan_vjp.launches
        got = _scan_grads(fns[1], args, h0, dy, dh)
        again = _scan_grads(fns[1], args, h0, dy, dh)
        torch.cuda.synchronize()
        errs = [close(g, w, rtol, frac * float(w.abs().max()))
                for g, w in zip(got, want)]
        repeat = all(torch.equal(g, g2) for g, g2 in zip(got, again))
        out.append({"kernel": "ssm_scan", "check": "grad",
                    "mode": "per channel" if hd is None else
                    f"per head of {hd}",
                    "shape": [b, l, d, n], "h0": with_h0,
                    "dtype": str(torch.float32),
                    "tolerance": [rtol, f"{frac} x max |grad|"],
                    "max_abs_err": max(e for e, _ in errs),
                    "max_abs_err_by_input": dict(zip(
                        ("x", "dt", "A", "B", "C", "D", "h0"),
                        (e for e, _ in errs))),
                    "repeat_bitwise": repeat,
                    "backward_launches": ss.ssm_scan_vjp.launches - before,
                    "ok": all(ok for _, ok in errs) and repeat and
                    ss.ssm_scan_vjp.launches == before + 2})
        del args, h0, dy, dh, want, got, again
        torch.cuda.empty_cache()
    return out


def ssm_bwd_cost(b, l, d, n, with_h0, n_ckpt: int,
                 headdim: int = None) -> dict:
    """What the scan's VJP must move and compute, f32: x, dt and dy read,
    dx and ddt written; B, C read, dB, dC written; A, D read, dA, dD
    written; the forward's ``n_ckpt`` checkpoints a sequence read;
    h0, dh_last read and dh0 written when there is h0.  Per channel (no
    ``headdim``): one exp and 15 flops per (b, t, d, n) (the state's
    recompute, the cotangent's step and the five products it feeds).  Per
    head of ``headdim`` channels: dt, ddt, A, D, dA and dD per head, one
    exp a (b, t, head) and 12 flops an element (the recompute's 2, the
    walk's 6 and the sums they feed)."""
    ck = b * n_ckpt * d * n
    state = 3 * b * d * n if with_h0 else 0
    if headdim is None:
        nbytes = (5 * b * l * d + 4 * b * l * n + 2 * (d * n + d) + ck
                  + state) * 4
        return {"bytes": nbytes, "flops": 15 * b * l * d * n,
                "exps": b * l * d * n}
    nh = d // headdim
    nbytes = (3 * b * l * d + 2 * b * l * nh + 4 * b * l * n + 4 * nh + ck
              + state) * 4
    return {"bytes": nbytes, "flops": 12 * b * l * d * n,
            "exps": b * l * nh}


def ssm_timing(timer, randn, ss, sms: int) -> dict:
    """The scan as each path calls it: Falcon-Mamba's prefill and decode
    (N = 16, the row of earlier PRs), Zamba2's prefill and decode (N =
    64), the training forward writing checkpoints and the backward
    kernel at Falcon's and Zamba2's training shapes per channel, and per
    head at Zamba2's and L = 4096 (the path's mode); at tp 2 (phase 7h)
    a rank's per-head forward and backward and Falcon's per-channel
    backward.  At N = 64 the
    kernel forms exp(dt A) for every (channel, lane) where Mamba-2's
    function needs one a head: ``bound_ssd_ms`` is the bound with those
    exps."""
    out = {}
    for key, (b, l, d, n, with_h0) in (
            ("prefill", (1, PROMPT, 8192, 16, False)),
            ("decode", (SLOTS, 1, 8192, 16, True)),
            ("n64_prefill", (1, PROMPT, HYBRID_D, HYBRID_N, False)),
            ("n64_decode", (SLOTS, 1, HYBRID_D, HYBRID_N, True))):
        args, h0 = ssm_inputs(randn, b, l, d, n, with_h0)
        out[key] = {
            "ms": timer(lambda: ss.ssm_scan(*args, h0=h0,
                                            return_state=True)),
            "plain_ms": timer(lambda: ss.ssm_scan_plain(
                *args, h0=h0, return_state=True), iters=5),
            "library_ms": None, **ssm_cost(b, l, d, n, with_h0),
            "shape": [b, l, d, n],
            "geometry": ss.ssm_geometry(b, l, d, n, sms)}
    for key, (b, l, d, n) in (("train_forward", (1, PROMPT, 8192, 16)),
                              ("n64_train_forward",
                               (1, PROMPT, HYBRID_D, HYBRID_N))):
        args, _ = ssm_inputs(randn, b, l, d, n, False)
        geo = ss.ssm_geometry(b, l, d, n, sms)
        cost = ssm_cost(b, l, d, n, False)
        # the checkpoints
        cost["bytes"] += b * ss.checkpoint_count(l) * d * n * 4
        out[key] = {"ms": timer(lambda: ss._launch(
            *args, None, True, geo, checkpoints=True)),
            "plain_ms": None, "library_ms": None, **cost,
            "shape": [b, l, d, n], "geometry": geo}
    # the forward through the per-head entry (ssm_scan_heads: dt, A and
    # D repeated over a head's channels, then the kernel) at a rank's
    # shape at tp 2, beside the per-head plain version
    b, l, nh, hd, n = SSM_TP_HEADS
    args, _ = ssm_inputs(randn, b, l, nh * hd, n, False)
    args = (args[0], randn(b, l, nh).abs() * 0.1, -randn(nh).abs(),
            args[3], args[4], randn(nh))
    out["tp_heads_forward"] = {
        "ms": timer(lambda: ss.ssm_scan_heads(*args, hd,
                                              return_state=True)),
        "plain_ms": timer(lambda: ss.ssm_scan_heads_plain(
            *args, hd, return_state=True), iters=5),
        "library_ms": None, **ssm_cost(b, l, nh * hd, n, False),
        "shape": [b, l, nh * hd, n], "headdim": hd,
        "geometry": ss.ssm_geometry(b, l, nh * hd, n, sms)}
    # the backward per channel at Falcon's and Zamba2's training shapes
    # and Falcon's at tp 2, per head (Zamba2's heads of 64) at Zamba2's,
    # L = 4096 and a rank's at tp 2; each beside a copy of the bytes its
    # function must move
    for key, (b, l, d, n), hd in (
            ("backward", (1, PROMPT, 8192, 16), None),
            ("n64_backward", (1, PROMPT, HYBRID_D, HYBRID_N), None),
            ("n64_heads_backward", (1, PROMPT, HYBRID_D, HYBRID_N),
             HYBRID_HEADDIM),
            ("n64_heads_backward_l4096", (1, 4096, 1024, HYBRID_N),
             HYBRID_HEADDIM),
            ("tp_backward", SSM_TP_CHANNEL, None),
            ("tp_heads_backward", (SSM_TP_HEADS[0], PROMPT,
                                   HYBRID_D // TP_TP, HYBRID_N),
             HYBRID_HEADDIM)):
        args, _ = ssm_inputs(randn, b, l, d, n, False)
        fwd = args
        if hd is not None:
            nh = d // hd
            args = (args[0], randn(b, l, nh).abs() * 0.1, -randn(nh).abs(),
                    args[3], args[4], randn(nh))
            dt_ch, a_ch, d_ch = ss._expand_heads(args[1], args[2], args[5],
                                                 hd, n)
            fwd = (args[0], dt_ch, a_ch, args[3], args[4], d_ch)
        _, _, hc = ss._launch(*fwd, None, True, ss.ssm_geometry(
            b, l, d, n, sms), checkpoints=True)
        del fwd
        dy = randn(b, l, d)
        cost = ssm_bwd_cost(b, l, d, n, False, ss.checkpoint_count(l), hd)
        src = torch.empty(cost["bytes"] // 8, device="cuda")
        dst = torch.empty_like(src)
        before = ss.ssm_scan_vjp.launches
        if hd is None:
            run = functools.partial(ss.ssm_scan_vjp, *args, hc, dy)
            plain = functools.partial(ss.ssm_scan_backward_plain, *args, dy)
        else:
            run = functools.partial(ss.ssm_scan_heads_vjp, *args, hc, dy, hd)
            plain = functools.partial(ss.ssm_scan_heads_backward_plain,
                                      *args, dy, hd)
        # the plain loop at L = 4096 takes about a second a call: once
        out[key] = {
            "ms": timer(run),
            "plain_ms": timer(plain, iters=1 if l > PROMPT else 2,
                              warmup=0 if l > PROMPT else 1),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": None, **cost, "shape": [b, l, d, n],
            "headdim": hd,
            "geometry": ss.ssm_bwd_geometry(b, l, d, n, hd, sms)}
        ss.ssm_scan_vjp.launches = before     # timing counts no path
        del hc, dy, src, dst, run, plain
    del args
    for key in ("n64_prefill", "n64_decode", "n64_train_forward",
                "n64_backward", "tp_heads_forward"):
        rec = out[key]
        b, l, d = rec["shape"][:3]
        ssd = dict(rec, exps=b * l * d // HYBRID_HEADDIM)
        rec["bound_ssd_ms"] = max(ssd["bytes"] / HBM_BW,
                                  ssd["flops"] / PEAK[torch.float32],
                                  ssd["exps"] / EXP_RATE) * 1e3
    torch.cuda.empty_cache()
    return out


def adamw_inputs(randn, rand, n, length, g_dtype=torch.float32,
                 p_dtype=torch.float32) -> tuple:
    """Grad partials, param and moments as tests/test_fused_kernels.py
    draws them."""
    return (randn(n, length, dtype=g_dtype), randn(length, dtype=p_dtype),
            randn(length) * 0.1, rand(length) * 0.01)


def rs_cost(name: str, shape: tuple, g_bytes: int = 4,
            p_bytes: int = 4) -> dict:
    """What each reduce_scatter kernel must move and compute: every input
    read once, every output written once; flops per element: the n_src - 1
    adds of the sum, then 4 for the norm (square, add, two multiplies) or
    15 for AdamW (moments 6, bias corrections 2, sqrt, add, divide,
    decay 2, step 2)."""
    if name == "reduce_scatter_rmsnorm":
        n, rows, d = shape
        return {"bytes": (n + 1) * rows * d * g_bytes + 4 * d,
                "flops": (n - 1 + 4) * rows * d}
    n, length = shape
    return {"bytes": (n * g_bytes + 2 * p_bytes + 16) * length,
            "flops": (n - 1 + 15) * length}


def rs_parity(randn, rand, fc, rs_len: int) -> list:
    """Both reduce_scatter kernels against their plain versions."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, rows, d in RS_RMSNORM_SHAPES:
            x, s = randn(n, rows, d, dtype=dtype), randn(d)
            tol = TOL["reduce_scatter_rmsnorm"][dtype]
            err, ok = close(fc.reduce_scatter_rmsnorm(x, s),
                            fc.reduce_scatter_rmsnorm_plain(x, s), *tol)
            out.append({"kernel": "reduce_scatter_rmsnorm",
                        "shape": [n, rows, d], "dtype": str(dtype),
                        "tolerance": tol, "max_abs_err": err, "ok": ok})
    cases = [(n, length, wd, torch.float32, torch.float32)
             for n, length, wd in RS_ADAMW_SHAPES]
    for dtypes in ((torch.float32, torch.float32),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.bfloat16)):
        for length in (rs_len, RAGGED):
            for wd in (0.0, 0.1):
                cases.append((DP, length, wd, *dtypes))
    for n, length, wd, g_dtype, p_dtype in cases:
        args = adamw_inputs(randn, rand, n, length, g_dtype, p_dtype)
        got = fc.reduce_scatter_adamw(*args, *ADAMW_HYPER, weight_decay=wd)
        want = fc.reduce_scatter_adamw_plain(*args, *ADAMW_HYPER,
                                             weight_decay=wd)
        f32 = TOL["reduce_scatter_adamw"][torch.float32]
        errs = [close(a, b, *(TOL["reduce_scatter_adamw"][p_dtype]
                              if i == 0 else f32))
                for i, (a, b) in enumerate(zip(got, want))]
        out.append({"kernel": "reduce_scatter_adamw", "shape": [n, length],
                    "weight_decay": wd, "dtype": str(p_dtype),
                    "grad_dtype": str(g_dtype),
                    "tolerance": TOL["reduce_scatter_adamw"][p_dtype],
                    "max_abs_err": max(e for e, _ in errs),
                    "ok": all(ok for _, ok in errs)})
        del args, got, want
    return out


def rs_timing(timer, randn, rand, fc, rs_len: int) -> dict:
    """Both reduce_scatter kernels at the training path's shapes (f32),
    their plain versions, and the two-call PyTorch composition that
    computes the same function (no single call does): ``F.rms_norm`` of
    ``x.sum(0)``, and ``x.sum(0)`` then ``torch._fused_adamw_`` on one
    tensor (its decoupled weight decay rounds otherwise, the work is the
    same; it updates in place, so it runs on copies)."""
    out = {}
    n, rows, d = RS_RMSNORM_MAIN
    x, s = randn(n, rows, d), randn(d)
    out["reduce_scatter_rmsnorm"] = {
        "ms": timer(lambda: fc.reduce_scatter_rmsnorm(x, s)),
        "plain_ms": timer(lambda: fc.reduce_scatter_rmsnorm_plain(x, s)),
        "library_ms": timer(lambda: torch.nn.functional.rms_norm(
            x.sum(0), (d,), weight=s, eps=1e-5)),
        "library": "F.rms_norm(x.sum(0))",
        **rs_cost("reduce_scatter_rmsnorm", RS_RMSNORM_MAIN),
        "shape": list(RS_RMSNORM_MAIN)}
    del x
    g, p, m, v = adamw_inputs(randn, rand, DP, rs_len)
    pc, mc, vc = p.clone(), m.clone(), v.clone()
    step = torch.tensor(3.0, device=g.device)
    lr = ADAMW_HYPER[0]

    def library():
        gs = g.sum(0)
        torch._fused_adamw_([pc], [gs], [mc], [vc], [], [step], lr=lr,
                            beta1=0.9, beta2=0.95, weight_decay=0.1,
                            eps=1e-8, amsgrad=False, maximize=False)

    out["reduce_scatter_adamw"] = {
        "ms": timer(lambda: fc.reduce_scatter_adamw(
            g, p, m, v, *ADAMW_HYPER, weight_decay=0.1)),
        "plain_ms": timer(lambda: fc.reduce_scatter_adamw_plain(
            g, p, m, v, *ADAMW_HYPER, weight_decay=0.1)),
        "library_ms": timer(library),
        "library": "x.sum(0) + torch._fused_adamw_",
        **rs_cost("reduce_scatter_adamw", (DP, rs_len)),
        "shape": [DP, rs_len]}
    pb = p.to(torch.bfloat16)
    out["reduce_scatter_adamw"]["bf16_param"] = {
        "ms": timer(lambda: fc.reduce_scatter_adamw(
            g, pb, m, v, *ADAMW_HYPER, weight_decay=0.1)),
        **rs_cost("reduce_scatter_adamw", (DP, rs_len), p_bytes=2)}
    return out


def rms_timing(timer, randn, rn, sms: int) -> dict:
    """rms_norm (f32) at :data:`RMS_SHAPES` and its backward at
    :data:`RMS_BWD` (``backward``), :data:`RMS_MOE` (``backward_moe``),
    :data:`RMS_HYBRID` (``backward_hybrid``), :data:`RMS_TP`
    (``backward_tp``, a rank's row norms at (data, model)) and
    :data:`RMS_TRAIN_LM` (``backward_train_lm``, train_lm at one rank):
    the kernels, the plain versions, the library call
    and ``copy_ms``, the same bytes moved under the same timer
    (``y.copy_(x)``; for the backward ``torch.add(x, dy, out=dx)``: read
    x and dy, write dx), which no bytes-bound kernel beats.  The two
    autograd backwards (the port's, whose kernels ``rms_norm_vjp``
    launches, and ``F.rms_norm``'s) run on a graph built once, through
    ``torch.autograd.grad`` with ``retain_graph=True``, so only the
    backward is timed; the profiler counts each one's device kernels."""
    out: dict = {"forward": {}}
    for t, d in RMS_SHAPES:
        x, s = randn(t, d), randn(d)
        y = torch.empty_like(x)
        out["forward"][f"{t}x{d}"] = {
            "ms": timer(lambda: rn.rms_norm(x, s)),
            "plain_ms": timer(lambda: rn.rms_norm_plain(x, s)),
            "library_ms": timer(lambda: torch.nn.functional.rms_norm(
                x, (d,), weight=s, eps=1e-5)),
            "copy_ms": timer(lambda: y.copy_(x)),
            "bytes": 2 * t * d * 4 + 4 * d, "flops": 4 * t * d,
            "shape": [t, d], "geometry": rn.rms_geometry(t, d, 4, sms)}
    out["backward"] = rms_backward_timing(timer, randn, rn, sms, *RMS_BWD)
    out["backward_moe"] = rms_backward_timing(timer, randn, rn, sms,
                                              *RMS_MOE)
    out["backward_hybrid"] = rms_backward_timing(timer, randn, rn, sms,
                                                 *RMS_HYBRID)
    out["backward_tp"] = rms_backward_timing(timer, randn, rn, sms, *RMS_TP)
    out["backward_audio"] = rms_backward_timing(timer, randn, rn, sms,
                                                *RMS_AUDIO)
    out["backward_vlm"] = rms_backward_timing(timer, randn, rn, sms,
                                              *RMS_VLM)
    out["backward_train_lm"] = rms_backward_timing(timer, randn, rn, sms,
                                                   *RMS_TRAIN_LM)
    return out


def rms_backward_timing(timer, randn, rn, sms: int, t: int, d: int) -> dict:
    """rms_norm's backward at (t, d): see :func:`rms_timing`."""
    x, s = randn(t, d).requires_grad_(), randn(d).requires_grad_()
    xd, sd, dy = x.detach(), s.detach(), randn(t, d)
    dx = torch.empty_like(dy)
    ys = (rn.rms_norm(x, s),
          torch.nn.functional.rms_norm(x, (d,), weight=s, eps=1e-5))
    port, library = (
        lambda y=y: torch.autograd.grad(y, (x, s), dy, retain_graph=True)
        for y in ys)
    return {
        "ms": timer(port),
        "plain_ms": timer(lambda: rn.rms_norm_backward(xd, sd, 1e-5, dy)),
        "library_ms": timer(library),
        "library": "autograd backward of F.rms_norm",
        "copy_ms": timer(lambda: torch.add(xd, dy, out=dx)),
        "kernels": device_profile(port)["kernel_launches"],
        "library_kernels": device_profile(library)["kernel_launches"],
        "plain_kernels": device_profile(
            lambda: rn.rms_norm_backward(xd, sd, 1e-5, dy))[
                "kernel_launches"],
        # read x and dy, write dx; scale read, dscale written.  Flops per
        # element: g*s, x*x, g*s*x, x*c, the difference, r*, g*x, *r and
        # the dscale sum
        "bytes": 3 * t * d * 4 + 8 * d, "flops": 9 * t * d,
        "shape": [t, d],
        "geometry": rn.rms_geometry(t, d, 4, sms, backward=True)}


def flash_timing(timer, randn, fa, b: int, lq: int, lk: int, h: int,
                 d: int, causal: bool) -> dict:
    """flash_attention (f32) at (b, lq, lk, h, d): the kernel, the plain
    version and ``scaled_dot_product_attention`` on the same inputs in
    its (B, H, L, D) layout (the transposes made before timing); bytes:
    q, k, v read and o written once; flops: 4 d a (query, key) pair the
    mask lets through."""
    q = randn(b, lq, h, d)
    k, v = (randn(b, lk, h, d) for _ in range(2))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = int(fa.attention_mask(lq, lk, causal, None, 0, lk)
                .expand(lq, lk).sum()) * b * h
    return {"ms": timer(lambda: fa.flash_attention(q, k, v, causal)),
            "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v,
                                                               causal)),
            "library_ms": timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal)),
            "bytes": 4 * (2 * q.numel() + 2 * k.numel()),
            "flops": 4 * d * pairs, "shape": [b, lq, lk, h, d],
            "causal": causal}


def reduce_timing(timer, randn, cr, n_src: int, length: int) -> dict:
    """chunked_reduce on (n_src, length) - one rank's segment of a row's
    FSDP grad bucket on the flat path (DP, rs_len), or a level's on the
    (pod, data) path (``hier_reduce_shapes``) - and ``torch.sum(x, 0)``
    on the same input, timed in turns (kernel, sum, sum, kernel, ...),
    five times each: ``ms`` and ``library_ms`` are the medians,
    ``spread_ms`` each side's max - min; ``copy_ms`` is ``y.copy_(x)``
    moving the same bytes (read (n_src + 1) L / 2 floats, write as many)
    under the same timer."""
    xr = randn(n_src, length)
    half = (n_src + 1) * length // 2
    xc, yc = torch.empty(half, device="cuda"), torch.empty(half,
                                                           device="cuda")
    turns: dict = {"kernel": [], "sum": []}
    fns = {"kernel": lambda: cr.chunked_reduce(xr),
           "sum": lambda: torch.sum(xr, 0)}
    for i in range(5):
        for side in ("kernel", "sum") if i % 2 == 0 else ("sum", "kernel"):
            turns[side].append(timer(fns[side]))
    return {"ms": float(np.median(turns["kernel"])),
            "plain_ms": timer(lambda: cr.chunked_reduce_plain(xr)),
            "library_ms": float(np.median(turns["sum"])),
            "turns_ms": turns,
            "spread_ms": {k: max(v) - min(v) for k, v in turns.items()},
            "copy_ms": timer(lambda: yc.copy_(xc)),
            "bytes": (n_src + 1) * length * 4, "flops": n_src * length,
            "shape": [n_src, length]}


def kernel_api_phase(randn, rand, rs_len: int) -> dict:
    """The path that carries the two reduce_scatter kernels, in the JAX
    package too: its public kernel API, at the training path's shapes,
    counters zeroed before and read after; results must be finite and
    equal the plain versions within ``TOL``."""
    from repro_torch.kernels import fused_collectives as fc
    from repro_torch.kernels import ops
    n, rows, d = RS_RMSNORM_MAIN
    x, s = randn(n, rows, d), randn(d)
    adamw = adamw_inputs(randn, rand, DP, rs_len)
    counters = {k: getattr(fc, k) for k in API_KERNELS}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    y = ops.reduce_scatter_rmsnorm(x, s)
    new = ops.reduce_scatter_adamw(*adamw, *ADAMW_HYPER, weight_decay=0.1)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    errs = [close(y, fc.reduce_scatter_rmsnorm_plain(x, s),
                  *TOL["reduce_scatter_rmsnorm"][torch.float32])]
    errs += [close(a, b, *TOL["reduce_scatter_adamw"][torch.float32])
             for a, b in zip(new, fc.reduce_scatter_adamw_plain(
                 *adamw, *ADAMW_HYPER, weight_decay=0.1))]
    ok = all(ok for _, ok in errs) and tuple(y.shape) == (rows, d) and \
        all(tuple(t.shape) == (rs_len,) for t in new)
    return {"launches": launches, "max_abs_err": max(e for e, _ in errs),
            "ok": ok}


def card_vs_cpu(arch: str, length: int, dev) -> tuple:
    """The smoke-size model of ``arch`` on the card against the CPU with
    the same params: prefill at ``length`` (behind the frontend's stub
    input, as the serve launcher draws it), then three per-slot decode
    steps; logits and the first group's cache leaves (with an encoder
    its cross-attention ``ck`` / ``cv`` too) at rtol 2e-4, atol 2e-5
    (cuBLAS and the CPU BLAS sum in other orders).  Returns (max abs
    error, within tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_batch
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    cfg = get_config(arch, smoke=True)
    cpu_params = model.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    params = {"cpu": cpu_params,
              "gpu": model.params_from_numpy(
                  model.params_to_numpy(cpu_params), dev)}
    batch = stub_batch(cfg, 1, length, np.random.default_rng(0))
    start = model.prefix_tokens(cfg) + length
    outs = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        logits, caches = model.prefill(
            params[name], {k: torch.as_tensor(v, device=d)
                           for k, v in batch.items()}, cfg,
            UNSHARDED, start + 4, cache_dtype=torch.float32)
        steps = [logits]
        pos = torch.tensor([start], device=d)
        for i in range(3):
            lg, caches = model.decode_step(
                params[name], caches, torch.tensor([[7 + i]], device=d),
                pos, cfg, UNSHARDED)
            steps.append(lg)
            pos = pos + 1
        outs[name] = [t.cpu() for t in steps] + \
            [caches[0][k].cpu() for k in sorted(caches[0])]
    errs = [close(a, b, 2e-4, 2e-5) for a, b in zip(outs["gpu"],
                                                    outs["cpu"])]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def serve_phase(arch: str, path: str, dev, launches: dict,
                obs_base: str = None) -> dict:
    """Serve ``arch`` at full width on the card (f32, params from seed 0):
    a fixed batch of SLOTS x PROMPT prompts (with a stub frontend's
    input, ``launch.serve.stub_batch``; a vision prefix sizes
    ``max_seq`` with it) with a roomy HBM budget, the same 4 blocks
    short with eviction to the pool (greedy tokens must match, evictions
    and restores must happen), a Poisson trace of 8 requests through
    the launcher's flags (half the prompts share a pooled prefix: hits
    where the cache has a token axis, none where it has not; not for a
    model whose requests carry a frontend's input, which the launcher's
    trace refuses), then step times, a profiled prefill and 5 profiled
    decode steps, and the peak memory.  Kernel launches per run go to
    ``launches[path]``.  With ``obs_base`` the roomy run is observed
    (``ObsSession``: ``<obs_base>.jsonl`` and ``.trace.json``): its
    ``repro_serve_*`` gauges must equal the engine's counters, and the
    trace must hold one ``serve_step`` span a step of the engine."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    from repro_torch.serving import ServeConfig, ServeEngine, kvcache
    cfg = get_config(arch)
    counters = {"rms_norm": rn.rms_norm,
                "flash_attention": fa.flash_attention,
                "ssm_scan": ss.ssm_scan}
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0), dev, torch.float32)
    batch = serve.stub_batch(cfg, SLOTS, PROMPT, np.random.default_rng(0))
    prefix = model.prefix_tokens(cfg)
    max_seq = prefix + PROMPT + NEW + 8
    blocks_needed = SLOTS * -(-(prefix + PROMPT + NEW) // BT)
    # room in the pool for two evicted slot images (Phi-3-vision's is
    # 1.3 GB at 1616 tokens)
    pool_bytes = max(1 << 30, 2 * kvcache.CacheLayout(
        cfg, UNSHARDED, SLOTS, max_seq, torch.float32).bytes_for(max_seq))
    runs = launches.setdefault(path, {})

    def run(label, fn):
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[label] = {k: f.launches for k, f in counters.items()}
        log(f"[{path}] {label}: {wall:.2f}s  launches {runs[label]}")
        return out, wall

    def fixed(obs=None, **kw):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_seq=max_seq, decode_slots=SLOTS, kv_block_tokens=BT,
            pool_budget_bytes=pool_bytes, **kw), device=dev, obs=obs)
        if obs is not None:
            step, eng.steps = eng.step, 0

            def counted():
                eng.steps += 1
                return step()
            eng.step = counted
        return eng, eng.generate(batch, NEW)

    sess = None
    if obs_base is not None:
        from repro_torch.obs import ObsSession
        sess = ObsSession(metrics_out=obs_base + ".jsonl",
                          trace_out=obs_base + ".trace.json", log=log)
    (roomy, roomy_toks), roomy_s = run("fixed_roomy",
                                       lambda: fixed(obs=sess))
    obs_rec = None
    if sess is not None:
        obs_rec = check_serve_obs(sess, roomy, obs_base)
    (tight, tight_toks), tight_s = run(
        "fixed_pool_eviction",
        lambda: fixed(kv_placement="pool",
                      hbm_budget_blocks=blocks_needed - 4))
    c = tight.counters
    rec = {"model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "max_seq": max_seq,
           "cache_image_bytes": tight.layout.bytes_for(prefix + PROMPT
                                                       + NEW),
           "fixed_roomy": {"wall_s": roomy_s,
                           "tok_per_s": SLOTS * NEW / roomy_s,
                           **roomy.counters, "obs": obs_rec},
           "fixed_pool_eviction": {"wall_s": tight_s,
                                   "tok_per_s": SLOTS * NEW / tight_s,
                                   "hbm_budget_blocks": blocks_needed - 4,
                                   **c}}
    log(f"[{path}] roomy tokens[0] {roomy_toks[0].tolist()}")
    if roomy_toks.shape != (SLOTS, NEW) or roomy_toks.max() >= \
            cfg.vocab_size or roomy_toks.min() < 0:
        fail(f"{path}: bad token block {roomy_toks.shape}")
    if not (c["evictions"] > 0 and c["restores"] > 0):
        fail(f"{path}: pool run did not evict and restore: {c}")
    if not np.array_equal(roomy_toks, tight_toks):
        fail(f"{path}: pool-eviction run's greedy tokens differ from the "
             f"roomy run")
    sharable = roomy.layout.block_sharable
    rec["block_sharable"] = sharable
    del tight
    trace = {}
    eng = roomy
    del roomy
    if not model.frontend_inputs(cfg):
        # (the launcher's trace builds text requests: a model that takes
        # a frontend's input is served by the fixed batch alone)
        del eng
        args = serve.build_parser().parse_args([
            "--arch", arch, "--trace", "poisson", "--requests", "8",
            "--prompt-reuse", "0.5", "--prompt-len", str(PROMPT),
            "--new-tokens", str(NEW), "--decode-slots", str(SLOTS),
            "--kv-block-tokens", str(BT), "--pool-budget-mib", "1024"])
        eng = ServeEngine(cfg, params, ServeConfig(
            max_seq=max_seq, decode_slots=SLOTS, kv_block_tokens=BT,
            pool_budget_bytes=args.pool_budget_mib << 20,
            prefix_sharing=True), device=dev)
        trace, _ = run("trace_poisson",
                       lambda: serve.run_trace(eng, cfg, args))
        if trace["requests"] != 8 or (trace["prefix_hits"] > 0) != sharable:
            fail(f"{path}: trace lost requests, or pooled prefix hits "
                 f"{trace['prefix_hits']} where the cache is "
                 f"{'' if sharable else 'not '}block-sharable: {trace}")

    # step times at full width (after the counted runs)
    one = {k: torch.as_tensor(v[:1], device=dev) for k, v in batch.items()}

    def prefill():
        model.prefill(params, one, cfg, UNSHARDED, max_seq,
                      cache_dtype=torch.float32)

    pos = torch.full((SLOTS,), prefix + PROMPT, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)

    def decode():
        model.decode_step(params, eng.caches, tok, pos, cfg, UNSHARDED)

    def wall_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    pre, dec = wall_ms(prefill, 3), wall_ms(decode, 10)
    trace["profile_prefill"] = device_profile(prefill)
    trace["profile_decode_5_steps"] = device_profile(
        lambda: [decode() for _ in range(5)])
    for key in ("profile_prefill", "profile_decode_5_steps"):
        log(f"[profile] {path} {key} {json.dumps(trace[key])}")
    trace["prefill_ms"] = float(np.median(pre))
    trace["decode_step_ms"] = float(np.median(dec))
    rec["trace_poisson"] = trace
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if "requests" in trace:
        log(f"[{path}] trace: {trace['req_per_s']:.3f} req/s  "
            f"{trace['tok_per_s']:.1f} tok/s  p50 "
            f"{trace['latency_p50_s']:.3f}s  p99 "
            f"{trace['latency_p99_s']:.3f}s  prefix hits "
            f"{trace['prefix_hits']}")
    log(f"[{path}] prefill(1x{prefix}+{PROMPT}) {trace['prefill_ms']:.1f} "
        f"ms (busy {trace['profile_prefill']['busy_share']:.3f})  decode "
        f"step ({SLOTS} slots) {trace['decode_step_ms']:.2f} ms (busy "
        f"{trace['profile_decode_5_steps']['busy_share']:.3f})  fixed "
        f"{rec['fixed_roomy']['tok_per_s']:.1f} tok/s  peak memory "
        f"{rec['peak_memory_gib']:.2f} GiB")
    del params, eng
    torch.cuda.empty_cache()
    return rec


def check_serve_obs(sess, eng, base: str) -> dict:
    """Finalize the observed serving run's session and hold its files to
    the engine: every ``repro_serve_*`` counter gauge equals
    ``ServeEngine.counters``, the gauges of the engine's state equal it,
    the ``.prom`` rendering parses to the same values, and the trace
    holds one ``serve_step`` span a ``step`` of the engine."""
    sess.finalize(extra={"counters": eng.counters})
    _, metrics = metric_events(base + ".jsonl")
    want = {f"repro_serve_{k}_total": eng.counters[k] for k in (
        "finished", "evictions", "restores", "replays", "prefix_hits",
        "prefix_publishes")}
    want.update({"repro_serve_inflight": eng.sched.inflight,
                 "repro_serve_hbm_blocks_used": eng.blocks.used_blocks,
                 "repro_serve_pool_blocks_used":
                     eng.pool.alloc.used_blocks,
                 "repro_serve_pool_hits_total": eng.pool.hits})
    got = {name: metrics.get((name, ())) for name in want}
    if got != want:
        fail(f"serve metrics {got} != the engine's {want}")
    prom = parse_prom(pathlib.Path(base).with_suffix(".prom").read_text())
    if {k: prom.get((k, "")) for k in want} != want:
        fail("serve .prom disagrees with the engine's counters")
    doc = json.loads(pathlib.Path(base + ".trace.json").read_text())
    spans = sum(e.get("name") == "serve_step" for e in doc["traceEvents"])
    if spans != eng.steps or not spans:
        fail(f"serve trace: {spans} serve_step spans, {eng.steps} steps")
    log(f"[serve] metrics {json.dumps(got)}; {spans} serve_step spans for "
        f"{eng.steps} engine steps")
    return {"gauges": got, "serve_step_spans": spans, "steps": eng.steps}


def check_auto_choices(run: dict, plan, topology=None,
                       plans: dict = None) -> dict:
    """Every collective call of the auto run (rank 0's audit, each step)
    took the knobs of its plan cell: no call fell back to the ring
    baseline for want of a cell.  With a ``topology`` every call
    resolved at its own level, against that level's cells, and a level
    without a pool (``ici``) took ring.  With ``plans`` (registry epoch ->
    the plan published at it: an online re-tuned run) each step's calls
    are held to the plan of the epoch its record carries, every rank's
    calls resolved at that epoch.  Returns and prints the per-primitive
    decisions of step 0."""
    knobs = ("backend", "slicing_factor", "allreduce_mode", "overlap",
             "fused")
    for i, step in enumerate(run["steps"]):
        if plans is not None:
            epoch = step["obs_per_rank"][0]["plan_epoch"]
            if any(o["audit_epochs"] != [epoch]
                   for o in step["obs_per_rank"]):
                fail(f"auto run step {i}: calls resolved at epochs "
                     f"{[o['audit_epochs'] for o in step['obs_per_rank']]}"
                     f", the step ran under {epoch}")
            plan = plans[epoch]
        if not step["choices_rank0"]:
            fail(f"auto run step {i} resolved no collective")
        for c in step["choices_rank0"]:
            level = None
            if topology is not None:
                lv = topology.level_for(c["level"] or "")
                if lv is None or c["fabric"] != lv.fabric:
                    fail(f"auto run step {i}: {c} resolved at no level")
                level = topology.level_key(lv.axis)
            cell = plan.lookup(c["primitive"], c["msg_bytes"], c["nranks"],
                               level=level)
            want = {k: getattr(cell, k) for k in knobs} if cell else None
            if want and topology is not None and \
                    want["backend"] not in lv.backends():
                want["backend"] = "ring"     # no pool schedule off the pool
            if want is None or any(c[k] != want[k] for k in knobs):
                fail(f"auto run step {i}: {c} is not its plan cell {cell}")
    by_prim: dict = {}
    for c in run["steps"][0]["choices_rank0"]:
        by_prim.setdefault(c["primitive"], []).append(
            {k: c[k] for k in ("msg_bytes", *knobs, "level", "calls")})
    for prim, cells in sorted(by_prim.items()):
        log(f"[train] auto {prim}: {json.dumps(cells)}")
    return by_prim


def _after_all(ctx, calls: tuple) -> list:
    """Every ``(fn, args)`` of ``calls`` on this rank, in turn: what
    :func:`full_width_runs` hands ``train.run_many`` as its one
    ``after``."""
    return [fn(ctx, *args) for fn, args in calls]


def full_width_runs(runs: dict, common: list, mesh: str = f"{DP}x1",
                    profile: bool = True, short: tuple = (),
                    arch: str = "llama3.2-1b", archs: dict = None,
                    ckpt: dict = None, unprofiled: tuple = (),
                    after: tuple = (), configs: dict = None,
                    extra: dict = None):
    """``arch`` (Llama-3.2-1B) at full width and depth through the
    launcher's flags: each of ``runs`` (label -> its flags, after
    ``common``; a later flag overrides ``common``'s) is one variant of a
    single spawn of the ranks, so the ranks start once; the labels in
    ``archs`` (label -> arch) train that model instead, in the same spawn
    (``train.run_many``: one spec a model and mesh, the specs in turn,
    all on the same rank groups).  The labels in ``short`` take
    ``SHORT_STEPS`` steps.  Each spec's first variant is profiled for one
    more step (not one whose label is in ``unprofiled``), and with
    ``ckpt`` (its label -> directory) writes its checkpoint there
    (``train --ckpt``: its record holds ``ckpt``, ``assemble_s``,
    ``save_s`` and ``global_params``); ``nvidia-smi`` is sampled over
    all.  The labels in ``configs`` (label -> ``ModelConfig``) train that
    config in place of their arch's (a depth cut, :func:`cut_config`);
    ``extra`` (label -> ``train.RunSpec``) adds runs given as specs (an
    example's), after the others.  With ``after`` = ((fn, args), ...)
    every rank then runs each ``fn(ctx, *args)`` in turn in the same
    spawn (``train.run_many``), and the return is (the runs, a list with
    each fn's results in rank order)."""
    import dataclasses

    from repro_torch.launch import train
    archs, ckpt = archs or {}, ckpt or {}
    configs, extra = configs or {}, extra or {}
    per = {label: train.spec_from_args(train.build_parser().parse_args(
        _train_args(common + runs[label] + ["--lr", "3e-5"], mesh,
                    SHORT_STEPS if label in short else TRAIN_STEPS,
                    archs.get(label, arch))))
        for label in runs}
    for label, cfg in configs.items():
        per[label] = dataclasses.replace(per[label], config=cfg)
    per.update(extra)
    groups: list = []          # (the spec but its variants, its labels)
    for label, sp in per.items():
        key = dataclasses.replace(sp, variants=(), steps=0)
        for k, labels in groups:
            if k == key:
                labels.append(label)
                break
        else:
            groups.append((key, [label]))
    specs = [dataclasses.replace(
        per[labels[0]], variants=tuple(per[x].variants[0] for x in labels),
        steps=max(per[x].steps for x in labels),
        profile=profile and labels[0] not in unprofiled,
        ckpt=ckpt.get(labels[0], per[labels[0]].ckpt))
        for _, labels in groups]
    # the ranks share the card with this process: free what an earlier
    # phase's objects (an engine's reference cycles) still hold first
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    with SmiSampler() as smi:
        merged = train.run_many(specs, (_after_all, (tuple(after),))
                                if after else None)
    wall = time.perf_counter() - t0
    after_out = [[r[k] for r in merged.pop()] for k in range(len(after))] \
        if after else None
    log(f"[train] {' + '.join(per)}: {wall:.1f}s in one spawn of the "
        f"ranks ({held:.2f} GiB of the card held by this process)")
    got = {label: run for (_, labels), spec_runs in zip(groups, merged)
           for label, run in zip(labels, spec_runs)}
    out = {}
    for label in per:
        got[label]["group_wall_s"] = wall
        out[label] = _report_run(label, got[label], smi)
    return out if not after else (out, after_out)


def _report_run(label: str, run: dict, smi) -> dict:
    """Log a full-width run's steps and check that every rank took the
    rms_norm backward kernel every step."""
    steady = run["steps"][1:]      # step 0 carries the warm-up
    run["smi_steady"] = smi.between(steady[0]["t_start"],
                                    steady[-1]["t_end"])
    log(f"[train] {label} nvidia-smi over steps 1-{len(steady)}: "
        f"{json.dumps(run['smi_steady'])}")
    if run.get("profile"):
        run["profile"] = _summarise_profile(run["profile"])
        log(f"[train] {label} profile {json.dumps(run['profile'])}")
    for i, s in enumerate(run["steps"]):
        log(f"[train] {label} step {i} loss {s['loss']:.6f} "
            f"{s['step_s']:.3f}s pool {s['pool_bytes']} B launches "
            f"{json.dumps(s['launches'])}")
        if len(s["pool_by_level"]) > 1 or s["level_wire_bytes_rank0"]:
            log(f"[train] {label} step {i} pool by level "
                f"{json.dumps(s['pool_by_level'])} ledger by level (rank "
                f"0) {json.dumps(s['level_wire_bytes_rank0'])}")
        if s["launches_min_rank"]["rms_norm_vjp"] <= 0:
            fail(f"{label} step {i}: a rank took no rms_norm backward "
                 f"kernel: {s['launches_min_rank']}")
    log(f"[train] {label}: peak memory per rank "
        f"{run.get('peak_memory_gib')} GiB")
    return run


def check_losses(runs: dict, first: float, of: str = "cxl_fused") -> None:
    """Every run's step-0 loss within 1e-4 of ``first`` (run ``of``'s,
    by default the flat cxl_fused run's), every loss finite, and every
    run's loss falls."""
    for label, run in runs.items():
        ls = [s["loss"] for s in run["steps"]]
        if not all(np.isfinite(ls)):
            fail(f"{label}: a loss is not finite: {ls}")
        if abs(ls[0] - first) > 1e-4 * abs(first):
            fail(f"step-0 losses disagree: {label} {ls[0]} vs "
                 f"{of} {first}")
        if not ls[-1] < ls[0]:
            fail(f"{label}: the loss did not fall: {ls}")


def smoke_spec(tmp: str, key: str, mesh: str, tp: int = 1,
               extra: tuple = (), arch: str = "llama3.2-1b",
               seq: int = PROMPT, fuse: bool = True):
    """The smoke model's training run of one card-vs-CPU check (cxl, with
    fused kernels unless ``fuse`` is off, sequences of ``seq`` tokens)
    through the launcher's flags, from numpy params (seed 0, at ``tp``)
    written under ``tmp``."""
    import dataclasses
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model

    path = os.path.join(tmp, f"{key}.npz")
    train.save_params_npz(model.init_params(
        get_config(arch, smoke=True), torch.Generator().manual_seed(0),
        "cpu", tp=tp), path)
    spec = train.spec_from_args(train.build_parser().parse_args(
        _train_args(["--smoke", "--backend", "cxl",
                     *(["--fuse-kernels"] if fuse else []), *extra], mesh,
                    arch=arch, seq=seq)))
    return dataclasses.replace(spec, params_path=path)


def smoke_checks() -> dict:
    """Phase 7's smoke card-vs-CPU checks, one a training path (flat,
    (data, model), grouped, MoE, Falcon-Mamba's and Zamba2's SSM rows,
    both at (data, model) too, the pipeline over (stage, data)): each
    smoke model's training on the card against the same run on the CPU
    (the same numpy params), the losses of 3 steps within rtol 2e-4.  The
    checks of one spawn's rank groups run in one spawn of the ranks on
    each side (``train.run_many``: a rank's start-up is most of a
    check), every spawn side by side."""
    import dataclasses
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import train
    flat = f"{DP}x1"
    checks = {
        "smoke_card_vs_cpu": dict(mesh=flat),
        "tp_smoke_card_vs_cpu": dict(mesh=TP_MESH, tp=TP_TP,
                                     extra=("--topology", TP_TOPOLOGY)),
        "ragged_smoke_card_vs_cpu": dict(
            mesh=flat, extra=("--topology", RAGGED_TOPOLOGY)),
        "moe_smoke_card_vs_cpu": dict(
            mesh=TP_MESH, tp=TP_TP, arch=MOE_ARCH,
            extra=("--topology", TP_TOPOLOGY, "--prefetch", MOE_PREFETCH)),
        "ssm_smoke_card_vs_cpu": dict(mesh=flat, arch=SSM_ARCH,
                                      seq=SSM_SMOKE_SEQ),
        "hybrid_smoke_card_vs_cpu": dict(mesh=flat, arch=HYBRID_ARCH,
                                         seq=SSM_SMOKE_SEQ),
        "ssm_tp_smoke_card_vs_cpu": dict(
            mesh=TP_MESH, tp=TP_TP, arch=SSM_ARCH, seq=SSM_SMOKE_SEQ,
            extra=("--topology", TP_TOPOLOGY)),
        "hybrid_tp_smoke_card_vs_cpu": dict(
            mesh=TP_MESH, tp=TP_TP, arch=HYBRID_ARCH, seq=SSM_SMOKE_SEQ,
            extra=("--topology", TP_TOPOLOGY)),
        "audio_smoke_card_vs_cpu": dict(mesh=flat, arch=AUDIO_ARCH),
        "vlm_smoke_card_vs_cpu": dict(mesh=flat, arch=VLM_ARCH),
        # the only card check of the encoder's and the cross attention's
        # model-level AllReduces (their count does not grow with the
        # sequence: 128 tokens keep the CPU side short)
        "audio_tp_smoke_card_vs_cpu": dict(
            mesh=TP_MESH, tp=TP_TP, arch=AUDIO_ARCH, seq=SSM_SMOKE_SEQ,
            extra=("--topology", TP_TOPOLOGY)),
        # the pipeline (its flags past --mesh): nothing to fuse (no FSDP
        # gather); 128 tokens keep the CPU side of the (data, model)
        # spawn it rides short
        "pp_smoke_card_vs_cpu": dict(mesh=flat, extra=tuple(PP_FLAGS[2:]),
                                     fuse=False, seq=SSM_SMOKE_SEQ)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        specs = {key: smoke_spec(tmp, key, **kw)
                 for key, kw in checks.items()}
        groups: dict = {}
        for key, sp in specs.items():
            groups.setdefault(train._spawn_groups(sp), []).append(key)
        def timed(specs):
            t = time.perf_counter()
            return train.run_many(specs), time.perf_counter() - t

        with ThreadPoolExecutor(2 * len(groups)) as pool:
            futures = {(keys[0], device): pool.submit(
                timed, [dataclasses.replace(specs[k], device=device)
                        for k in keys])
                for keys in groups.values() for device in ("cuda", "cpu")}
            losses = {}
            for keys in groups.values():
                for device in ("cuda", "cpu"):
                    got, wall = futures[keys[0], device].result()
                    log(f"[train] smoke spawn {' + '.join(keys)} on "
                        f"{device}: {wall:.1f}s")
                    for k, runs in zip(keys, got):
                        losses.setdefault(k, {})[device] = [
                            s["loss"] for s in runs[0]["steps"]]
    out = {}
    for key, kw in checks.items():
        got = losses[key]
        err = float(np.max(np.abs(np.subtract(got["cuda"], got["cpu"]))
                           / np.abs(got["cpu"])))
        arch, mesh = kw.get("arch", "llama3.2-1b"), kw["mesh"]
        log(f"[train] smoke {arch} on {mesh}, 3 steps, card vs CPU losses "
            f"{got} (max rel err {err:.2e}, rtol 2e-4)")
        if not err <= 2e-4:
            fail(f"smoke {arch} training on {mesh} on the card differs "
                 f"from the CPU: {got}")
        out[key] = {"losses": got, "max_rel_err": err}
    log(f"[train] {len(checks)} smoke checks in {len(groups)} spawns a "
        f"side, side by side: {time.perf_counter() - t0:.1f}s")
    return out


def check_path_runs(runs: dict, need_levels: set, label_auto: str,
                    auto_skip: str = None) -> None:
    """Every step of every run: the kernels of ``HIER_KERNELS`` (and
    all_gather_matmul under --fuse-kernels) on every rank, and pool bytes
    retrieved at each level of ``need_levels`` (under auto: none at
    ``auto_skip``, a level without a pool)."""
    for label, run in runs.items():
        fused = run["fuse_kernels"]
        need = HIER_KERNELS + (("all_gather_matmul",) if fused else ())
        for i, s in enumerate(run["steps"]):
            moved = {a for a, c in s["pool_by_level"].items()
                     if c["retrieved"] > 0}
            if label == label_auto:
                bad = auto_skip is not None and auto_skip in moved
            else:
                bad = moved != need_levels
            if bad:
                fail(f"{label} step {i}: pool bytes by level "
                     f"{s['pool_by_level']}")
            idle = [k for k in need if s["launches_min_rank"][k] <= 0]
            if idle:
                fail(f"{label} step {i}: a rank launched no {idle}: "
                     f"{s['launches_min_rank']}")


def check_ragged_runs(runs: dict) -> None:
    """The grouped path's own gates, every step of every run: no
    flat-on-ragged fallback event; under cxl every rank launched
    chunked_reduce at N = its group's size (a group of more than one)
    and every sub-root at N = the group count (the sub-root exchange);
    the --placement run moved the pool bytes of the plain cxl run."""
    n_g = len(RAGGED_GROUPS)
    roots, sizes, start = [], [], 0
    for g in RAGGED_GROUPS:
        roots.append(start)
        sizes += [g] * g
        start += g
    for label, run in runs.items():
        for i, s in enumerate(run["steps"]):
            if s["fallbacks"]:
                fail(f"{label} step {i}: {s['fallbacks']} fallback events")
            if label == "resil_auto":
                continue
            for r, by_n in enumerate(s["chunked_reduce_by_n_per_rank"]):
                want = ({sizes[r]} if sizes[r] > 1 else set()) | \
                    ({n_g} if r in roots else set())
                got = {int(n) for n, k in by_n.items() if k > 0}
                if not want <= got:
                    fail(f"{label} step {i}: rank {r} launched "
                         f"chunked_reduce at N {by_n}, wants {sorted(want)}")
    plain, placed = runs["ragged_cxl"], runs["ragged_placed"]
    for a, b in zip(plain["steps"], placed["steps"]):
        if a["pool_by_level"] != b["pool_by_level"] or \
                a["level_wire_bytes_rank0"] != b["level_wire_bytes_rank0"]:
            fail(f"--placement auto moved other bytes than the plain "
                 f"grouped run: {b['pool_by_level']} vs "
                 f"{a['pool_by_level']}")


def check_hybrid_runs(runs: dict) -> None:
    """Every step of every hybrid run: the kernels of ``HYBRID_KERNELS``
    (and all_gather_matmul under --fuse-kernels: the shared block's
    products) on every rank; ``shared_a`` gathered once a shared group,
    the reference's gather sites under the double-buffered prefetch; the
    pool moves bytes under cxl."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    sites = sum(g.shared for g in blocks.scan_groups(get_config(
        HYBRID_ARCH)))
    for label, run in runs.items():
        need = HYBRID_KERNELS + (("all_gather_matmul",)
                                 if run["fuse_kernels"] else ())
        for i, s in enumerate(run["steps"]):
            idle = [k for k in need if s["launches_min_rank"][k] <= 0]
            if idle:
                fail(f"{label} step {i}: a rank launched no {idle}: "
                     f"{s['launches_min_rank']}")
            got = s["gathers_rank0"].get("shared_a", 0)
            if got != sites:
                fail(f"{label} step {i}: shared_a gathered {got} times, "
                     f"the reference's sites {sites}")
            if run["backend"] == "cxl" and s["pool_bytes"] <= 0:
                fail(f"{label} step {i}: no pool bytes under cxl")
        log(f"[train] {label}: gathers a step (rank 0) "
            f"{json.dumps(run['steps'][0]['gathers_rank0'])}")


def launcher_serve(argv: list) -> tuple:
    """An engine from the serve launcher's flags (``engine_from_args``,
    on the card) and its greedy tokens for a fixed batch of SLOTS x
    PROMPT prompts (seed 0), NEW new tokens: (cfg, engine, prompts,
    tokens, wall seconds of the generate call)."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv + [
        "--batch", str(SLOTS), "--prompt-len", str(PROMPT), "--new-tokens",
        str(NEW), "--decode-slots", str(SLOTS)])
    cfg, eng = serve.engine_from_args(args)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (SLOTS, PROMPT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate({"tokens": prompts}, NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if toks.shape != (SLOTS, NEW) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        fail(f"serve {argv}: bad token block {toks.shape}")
    return cfg, eng, prompts, toks, wall


def check_flat_ckpt(run: dict) -> dict:
    """``serve --arch llama3.2-1b --ckpt`` on the checkpoint the flat
    cxl+fused run wrote: its greedy tokens must equal those of an engine
    built from that run's captured GLOBAL params (the same ServeConfig);
    then the checkpoint is deleted."""
    import shutil

    from repro_torch.models import model
    from repro_torch.serving import ServeEngine
    params = run.pop("global_params")
    cfg, eng, prompts, toks, wall = launcher_serve(
        ["--arch", "llama3.2-1b", "--ckpt", str(CKPT_DIR / "llama")])
    scfg = eng.scfg
    del eng
    torch.cuda.empty_cache()
    ref = ServeEngine(cfg, model.params_from_numpy(params,
                                                   torch.device("cuda"),
                                                   cfg, 1),
                      scfg, device="cuda")
    want = ref.generate({"tokens": prompts}, NEW)
    del ref, params
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR / "llama")
    rec = {"ckpt": run["ckpt"], "assemble_s": run["assemble_s"],
           "save_s": run["save_s"], "serve_wall_s": wall, "tokens0": toks[0].tolist(),
           "tokens_equal": bool(np.array_equal(toks, want))}
    log(f"[train] flat cxl_fused checkpoint -> serve --ckpt: "
        f"{json.dumps(rec)}")
    if not rec["tokens_equal"]:
        fail("serve --ckpt of the flat run's checkpoint gives other greedy "
             "tokens than an engine built from the run's params")
    return rec


def check_ckpt_restores(run: dict, cfg, tp: int, name: str) -> dict:
    """A run's checkpoint (under ``CKPT_DIR / name``) restored through
    ``checkpoint.restore`` into ``abstract_params(cfg, tp)`` (the GLOBAL
    padded shapes) equals the run's captured params bitwise; then it is
    deleted."""
    import os
    import shutil

    from repro_torch.core import tree
    from repro_torch.models import model
    from repro_torch.training import checkpoint
    params = run.pop("global_params")
    nbytes = os.path.getsize(os.path.join(run["ckpt"], "arrays.npz"))
    t0 = time.perf_counter()
    step = int(pathlib.Path(run["ckpt"]).name.removeprefix("step_"))
    got = checkpoint.restore(str(CKPT_DIR / name), step, {
        "params": model.abstract_params(cfg, tp=tp)})["params"]
    restore_s = time.perf_counter() - t0
    bad = [p for p, x in tree.leaves_with_paths(got)
           if not np.array_equal(x.view(np.uint32),
                                 tree.get(params, p).view(np.uint32))]
    n = sum(x.size for x in tree.leaves(got))
    del got, params
    shutil.rmtree(CKPT_DIR / name)
    rec = {"ckpt": run["ckpt"], "bytes": nbytes, "params": n,
           "assemble_s": run["assemble_s"], "save_s": run["save_s"],
           "capture_s": run["capture_s"], "restore_s": restore_s,
           "bitwise": not bad}
    log(f"[train] {name} checkpoint {json.dumps(rec)}")
    if bad:
        fail(f"the {name} checkpoint restores other params: {bad[:4]}")
    return rec


def moe_a2a_bytes(cfg) -> float:
    """Wire bytes of one rank's all_to_all in a step of ``cfg`` (the
    ledger's convention, s (n - 1) / n): 6 calls a row (dispatch and
    combine in the forward, the remat replay and the backward's
    transposes) of the (E, C, d) f32 buffer, C = int(t k 1.25) // E at a
    model rank's t = 1024 tokens."""
    m = cfg.moe
    t = TP_TOKENS // TP_TP
    e = m.padded_experts(TP_TP)
    cap = max(1, int(t * m.top_k * m.capacity_factor) // e)
    return 6 * cfg.n_layers * e * cap * cfg.d_model * 4 * (TP_TP - 1) / TP_TP


def check_moe_runs(runs: dict, cfg) -> dict:
    """Every step of every MoE run of ``cfg``: the model level's
    all_to_all bytes on rank 0's ledger equal :func:`moe_a2a_bytes`, the
    model level's pool moves bytes, and every (token, slot) pair of the
    batch was routed once in the forward (rows x 4096 tokens x top-8);
    returns the pairs dropped by capacity per step."""
    want = moe_a2a_bytes(cfg)
    pairs = cfg.n_layers * TRAIN_BATCH * PROMPT * cfg.moe.top_k
    out = {}
    for label, run in runs.items():
        drops = []
        for i, st in enumerate(run["steps"]):
            got = st["level_wire_bytes_rank0"].get("model/cxl", {}).get(
                "all_to_all")
            if got != want:
                fail(f"{label} step {i}: all_to_all bytes {got}, reckoned "
                     f"{want}")
            if st["moe_assigned"] != pairs:
                fail(f"{label} step {i}: {st['moe_assigned']} pairs routed, "
                     f"not {pairs}")
            drops.append(st["moe_dropped"])
        out[label] = {"dropped": drops, "routed": pairs}
        log(f"[train] {label}: pairs dropped by capacity per step {drops} "
            f"of {pairs}")
    return out


def moe_serve(launches: dict) -> dict:
    """``serve --arch granite-moe-3b`` at full width, tp = 1: the fixed
    batch (kernel counters zeroed before, read after), the parameter
    count, then prefill ms (1 x PROMPT, median of 3) and decode-step ms
    (SLOTS slots, median of 10), a profiled prefill and decode, and the
    peak memory."""
    from repro_torch.core import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    counters = {"rms_norm": rn.rms_norm, "flash_attention": fa.flash_attention}
    for f in counters.values():
        f.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, eng, prompts, toks, wall = launcher_serve(["--arch", MOE_ARCH])
    torch.cuda.synchronize()
    launches["serve_moe"] = {"fixed": {k: f.launches
                                       for k, f in counters.items()}}
    n = sum(x.numel() for x in tree.leaves(eng.params))
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    if n - norms != cfg.param_count(1):
        fail(f"served {n} params, not {cfg.param_count(1)} + {norms}")
    one = torch.as_tensor(prompts[:1], device="cuda")
    max_seq = eng.scfg.max_seq

    def prefill():
        model.prefill(eng.params, {"tokens": one}, cfg, UNSHARDED, max_seq,
                      cache_dtype=torch.float32)

    pos = torch.full((SLOTS,), PROMPT, device="cuda")
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device="cuda")

    def decode():
        model.decode_step(eng.params, eng.caches, tok, pos, cfg, UNSHARDED)

    def wall_ms(fn, k):
        out = []
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    pre, dec = wall_ms(prefill, 3), wall_ms(decode, 10)
    rec = {"model": cfg.name, "params": n, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32",
           "fixed_wall_s": wall, "tok_per_s": SLOTS * NEW / wall,
           "tokens0": toks[0].tolist(),
           "prefill_ms": float(np.median(pre)),
           "decode_step_ms": float(np.median(dec)),
           "profile_prefill": device_profile(prefill),
           "profile_decode_5_steps": device_profile(
               lambda: [decode() for _ in range(5)]),
           "launches": launches["serve_moe"]["fixed"],
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[serve_moe] {json.dumps(rec)}")
    del eng
    torch.cuda.empty_cache()
    return rec


# 7g's runs, Zamba2-1.2B over the flat data axis (variants of the flat
# path's spawn of the ranks)
HYBRID_RUNS = ("hybrid_cxl_fused", "hybrid_cxl", "hybrid_auto")


def hybrid_train_phase(hybrid: dict, plan) -> dict:
    """Phase 7g's checks: Zamba2-1.2B (32 Mamba-2 rows through ssm_scan
    and its backward kernel, the shared attention block gathered once a
    shared group) at full width and depth over the flat data axis, FSDP
    through the pool, on phase 7's plan (``hybrid``: its runs, made in
    the flat path's spawn; the smoke SSM models' training on the card
    against the CPU is among ``smoke_checks``)."""
    out = {}
    check_hybrid_runs(hybrid)
    out["hybrid"] = hybrid
    out["hybrid_auto_choices"] = check_auto_choices(hybrid["hybrid_auto"],
                                                    plan)
    check_losses(hybrid, hybrid["hybrid_cxl_fused"]["steps"][0]["loss"])
    return out


def check_hybrid_tp_runs(runs: dict, first_4x1: float) -> None:
    """Phase 7h's own gates, on top of :func:`check_hybrid_runs`: every
    step of every run moves pool bytes at both levels; every step-0
    loss within 1e-4 of the ``4x1`` path's (``first_4x1``: the gated
    norm is the same function at tp 2); every rank's model-level
    AllReduces a step equal (rank 0's are logged)."""
    for label, run in runs.items():
        ls = [s["loss"] for s in run["steps"]]
        if abs(ls[0] - first_4x1) > 1e-4 * abs(first_4x1):
            fail(f"{label}: step-0 loss {ls[0]} is not the 4x1 path's "
                 f"{first_4x1}")
        for i, s in enumerate(run["steps"]):
            moved = {a for a, c in s["pool_by_level"].items()
                     if c["retrieved"] > 0}
            if run["backend"] != "ring" and moved != {"data", "model"}:
                fail(f"{label} step {i}: pool bytes by level "
                     f"{s['pool_by_level']}")
        calls = run["steps"][0]["level_counts_rank0"]
        log(f"[train] {label}: collective calls a step by level (rank 0) "
            f"{json.dumps(calls)}")


# 7i's runs, whisper-tiny and Phi-3-vision-4.2B over the flat data axis
# (variants of the flat path's spawn of the ranks)
AUDIO_RUNS = ("audio_cxl_fused", "audio_cxl", "audio_auto")
# Phi-3-vision takes about 10 s a step: its first run takes 2 steps too
# and no profiled step, and it leaves auto to whisper-tiny's run of the
# same path (the time limit)
VLM_RUNS = ("vlm_cxl_fused", "vlm_cxl")


def frontend_flash_launches(cfg) -> int:
    """flash_attention launches a rank-step of ``cfg`` (batch 1 a rank,
    --seq PROMPT): whisper's 4 encoder rows, 4 self and 4 cross
    attentions, and the decoder rows' 8 again in the remat replay;
    Phi-3-vision's rows (576 + 1024 tokens) and their replay.  The
    encoder has no remat."""
    per_row = 2 if cfg.encoder is not None else 1
    enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return enc + 2 * per_row * cfg.n_layers


def frontend_train_phase(runs: dict, cfg, plan) -> dict:
    """Phase 7i's checks of one model (``runs``: its cxl+fused and cxl
    runs and its auto run where it has one, made in the flat path's
    spawn): every step of every run,
    every rank launched flash_attention exactly
    :func:`frontend_flash_launches` times, rms_norm and its backward, and
    under --fuse-kernels all_gather_matmul; cxl moved pool bytes; every
    auto call took its plan cell; the step-0 losses within 1e-4 of each
    other and every loss falls."""
    want = frontend_flash_launches(cfg)
    for label, run in runs.items():
        need = ("rms_norm", "rms_norm_vjp") + (
            ("all_gather_matmul",) if run["fuse_kernels"] else ())
        for i, s in enumerate(run["steps"]):
            idle = [k for k in need if s["launches_min_rank"][k] <= 0]
            if idle:
                fail(f"{label} step {i}: a rank launched no {idle}: "
                     f"{s['launches_min_rank']}")
            fl = (s["launches_min_rank"]["flash_attention"],
                  s["launches"]["flash_attention"])
            if fl != (want, DP * want):
                fail(f"{label} step {i}: flash_attention launches (fewest "
                     f"a rank, all ranks) {fl}, want ({want}, "
                     f"{DP * want})")
            if run["backend"] == "cxl" and s["pool_bytes"] <= 0:
                fail(f"{label} step {i}: no pool bytes under cxl")
        log(f"[train] {label}: launches a step (all ranks) "
            f"{json.dumps(run['steps'][0]['launches'])}, gathers (rank 0) "
            f"{json.dumps(run['steps'][0]['gathers_rank0'])}")
    auto = [k for k in runs if k.endswith("_auto")]
    out = {"runs": runs, "auto_choices": check_auto_choices(
        runs[auto[0]], plan) if auto else None}
    first = runs[next(iter(runs))]["steps"][0]["loss"]
    check_losses(runs, first)
    return out


# 7e's runs, Granite-3.0-MoE over (data, model) (variants of 7c's spawn)
MOE_RUNS = ("moe_cxl_fused", "moe_cxl", "moe_auto")
PP_RUNS = ("pp_cxl", "pp_auto")
# 7b's runs, Llama over (pod, data) (variants of 7c's spawn)
HIER_RUNS = ("hier_cxl_fused", "hier_cxl", "hier_auto")


def check_resil_run(run: dict, plan, first: float) -> dict:
    """7k's gates (``resil_auto``): the death confirmed at
    ``RESIL_CONFIRM`` on every rank (the launcher already failed the run
    on any disagreement of verdicts or plan hashes), one re-plan to 2+1,
    every rank rolled back to the newest step every rank committed, the
    data with it (the replayed steps' losses equal their first runs' at
    rtol 1e-4), every auto call at its plan cell before the recovery
    (7d's plan) and at the recovery plan's cell of the survivor level
    after it, no fallback event, the store's snapshots committed by
    every live rank; returns what PERF.md records."""
    from repro_torch.core.topology import Topology, parse_topology
    from repro_torch.resilience import mesh_topology
    from repro_torch.tuner.plan import Plan
    steps = run["steps"]
    if len(steps) != RESIL_STEPS:
        fail(f"resil_auto ran {len(steps)} steps")
    rep = run["resilience"]
    if rep["replans"] != 1 or rep["dead_ranks"] != [1]:
        fail(f"resil_auto: {rep['replans']} re-plans, dead ranks "
             f"{rep['dead_ranks']}")
    verdicts = {i: s["resilience_per_rank"][0]["verdicts"]
                for i, s in enumerate(steps)
                if s["resilience_per_rank"][0]["verdicts"]}
    deaths = [(i, v) for i, vs in verdicts.items() for v in vs
              if v[0] == "rank_death"]
    if deaths != [(RESIL_CONFIRM, ["rank_death", 1, None, RESIL_CONFIRM])]:
        fail(f"resil_auto: rank deaths confirmed {deaths}")
    r0 = steps[RESIL_CONFIRM]["resilience_per_rank"]
    hashes = {r["recovery"]["plan_sha256"] for r in r0}
    rb = r0[0]["rollback"]
    if rb["reason"] != RESIL_REASON or len(hashes) != 1:
        fail(f"resil_auto: re-plan {rb['reason']}, plan hashes {hashes}")
    snap = rb["snapshot_step"]
    committed = rb["committed_by_rank"]
    common = set.intersection(*(set(c) for c in committed))
    if snap is None or snap != max(common) or \
            any(r["rollback"]["snapshot_step"] != snap for r in r0):
        fail(f"resil_auto: rolled back to {snap}, committed {committed}")
    data = [s["data_step"] for s in steps]
    if data != list(range(RESIL_CONFIRM + 1)) + list(
            range(snap + 1, snap + RESIL_STEPS - RESIL_CONFIRM)):
        fail(f"resil_auto: data steps {data}")
    replays = []
    for i in range(RESIL_CONFIRM + 1, RESIL_STEPS):
        j = data[i]
        a, b = steps[i]["loss"], steps[j]["loss"]
        replays.append({"step": i, "replays": j, "loss": a,
                        "first_run": b, "rel": abs(a - b) / abs(b)})
        if abs(a - b) > 1e-4 * abs(b):
            fail(f"resil_auto: step {i} replays step {j}: loss {a} vs {b}")
    if abs(steps[0]["loss"] - first) > 1e-4 * abs(first):
        fail(f"resil_auto: step-0 loss {steps[0]['loss']} vs {first}")
    running = parse_topology(RAGGED_TOPOLOGY)
    survivor = Topology.from_json(rb["topology"])
    mesh = mesh_topology(survivor, running)
    if mesh != running:
        fail(f"resil_auto: the running topology changed: {mesh}")
    check_auto_choices({"steps": steps[:RESIL_CONFIRM + 1]}, plan, running)
    # after it, each call at the recovery plan's own cell of the
    # survivor level of its axis (priced for 2+1, run on 3+1)
    after = check_auto_choices({"steps": steps[RESIL_CONFIRM + 1:]},
                               Plan.from_json(rb["plan"]), survivor)
    # chunked_reduce at N = the group's size within a group of more than
    # one and N = the group count on a sub-root, wherever the step's
    # choices (rank 0's: in the group of three and a sub-root) put a
    # reduction at that level on cxl
    n_g = len(RAGGED_GROUPS)
    roots, sizes, start = [], [], 0
    for g in RAGGED_GROUPS:
        roots.append(start)
        sizes += [g] * g
        start += g
    for i, s in enumerate(steps):
        cxl = {(c["level"], c["nranks"]) for c in s["choices_rank0"]
               if c["backend"] == "cxl"
               and c["primitive"] in ("reduce_scatter", "all_reduce")}
        for r, by_n in enumerate(s["chunked_reduce_by_n_per_rank"]):
            want = ({sizes[r]} if sizes[r] > 1
                    and ("data", sizes[r]) in cxl else set()) | \
                ({n_g} if r in roots and ("pod", n_g) in cxl else set())
            got = {int(n) for n, k in by_n.items() if k > 0}
            if not want <= got:
                fail(f"resil_auto step {i}: rank {r} launched chunked_reduce"
                     f" at N {by_n}, its cxl choices want {sorted(want)}")
    snaps = {i: [r.get("snapshot") for r in s["resilience_per_rank"]]
             for i, s in enumerate(steps)
             if i % RESIL_INTERVAL == 0}
    for i, per in snaps.items():
        # rank 1's writes fail from its death until it is replaced
        want = [not (r == 1 and 1 <= i <= RESIL_CONFIRM)
                for r in range(len(per))]
        if [x is not None for x in per] != want:
            fail(f"resil_auto step {i}: snapshots {per}")
    lost = rb["steps_lost"]
    out = {"confirm_step": RESIL_CONFIRM, "reason": rb["reason"],
           "plan_sha256": hashes.pop(), "committed_by_rank": committed,
           "snapshot_step": snap, "steps_lost": lost,
           "data_steps": data, "replays": replays,
           "snapshot_bytes_rank": {i: [x["bytes"] if x else None
                                       for x in per]
                                   for i, per in snaps.items()},
           "snapshot_s": {i: [x["seconds"] if x else None for x in per]
                          for i, per in snaps.items()},
           "restore_s": [r["rollback"]["restore_seconds"] for r in r0],
           "state_bytes_rank": rep["state_bytes"],
           "peak_memory_gib": run["peak_memory_gib"],
           "store_bytes_rank": rep["capacity_bytes"],
           "open_s_per_rank": [x["open_s"]
                               for x in run["resilience_per_rank"]],
           "close_s_per_rank": [x["close_s"]
                                for x in run["resilience_per_rank"]],
           "chunked_reduce_by_n": [s["chunked_reduce_by_n_per_rank"]
                                   for s in steps],
           "step_s": [s["step_s"] for s in steps],
           "pool_bytes": [s["pool_bytes"] for s in steps],
           "after_choices": after}
    log(f"[train] resil_auto: {json.dumps(out)}")
    return out


def survivor_phase() -> dict:
    """7l: ``launch.survivor`` on the card - 4 ranks under cxl over
    ``pod:cxl,data:cxl:2+2`` lose rank 3 (confirmed on every rank), the
    re-plan makes data 2+1, and 3 survivors in a new spawn restore from
    the pool store and run auto on the recovery plan, equal to a flat
    3-rank cxl run from the same state (rtol 1e-4, atol 1e-6); ledger
    bytes at data/cxl and pod/cxl, pod's fewer; the audit at (data, 2)
    and (pod, 2); chunked_reduce launched on every survivor."""
    from repro_torch.launch import survivor
    t0 = time.perf_counter()
    res = survivor.run("cuda")
    try:
        out = survivor.check(res)
    except AssertionError as e:
        fail(f"survivor reconfiguration: {e}")
    idle = [r for r, x in enumerate(res["second"]) if x["launches"] <= 0]
    if idle:
        fail(f"survivor reconfiguration: ranks {idle} launched no "
             f"chunked_reduce")
    out["launches"] = sum(x["launches"] for x in res["first"]) + \
        sum(x["launches"] for x in res["second"])
    out["wall_s"] = time.perf_counter() - t0
    log(f"[train] survivor reconfiguration: {json.dumps(out)}")
    return out


def check_pp_runs(runs: dict, first: float, plan) -> dict:
    """Phase 7j's checks of the pipeline runs: the step-0 loss within
    1e-4 of the flat cxl+fused run's (the same params and global batch)
    and every loss falling; every step's bubble fraction; every rank's
    flash_attention, rms_norm and rms_norm backward launches exactly its
    stage's (``pp_rank_launches``; rank r at stage r // (DP / PP_STAGES)),
    chunked_reduce on every rank under cxl; ``p2p`` ledger bytes at the
    stage level only and all-reduce bytes at data; both levels' pools
    moving bytes under cxl; every auto call, p2p included, at its
    level's cell, every p2p at the stage level.  Returns the auto run's
    decisions."""
    from repro_torch.core.topology import parse_topology
    from repro_torch.training.pipeline import bubble_fraction
    check_losses(runs, first)
    bub = bubble_fraction(PP_STAGES, PP_MICROBATCHES)
    data = DP // PP_STAGES
    for label, run in runs.items():
        for i, s in enumerate(run["steps"]):
            if s["bubble_fraction"] != bub:
                fail(f"{label} step {i}: bubble fraction "
                     f"{s['bubble_fraction']}, not {bub}")
            for r, got in enumerate(s["launches_per_rank"]):
                want = pp_rank_launches(r // data)
                if any(got[k] != n for k, n in want.items()):
                    fail(f"{label} step {i} rank {r}: launches {got}, the "
                         f"stage's rows call {want}")
                if label == "pp_cxl" and got["chunked_reduce"] <= 0:
                    fail(f"{label} step {i} rank {r}: no chunked_reduce")
            ledger = s["level_wire_bytes_rank0"]
            p2p = {lv for lv, c in ledger.items() if c.get("p2p")}
            if p2p != {"stage/cxl"} or \
                    not ledger.get("data/cxl", {}).get("all_reduce"):
                fail(f"{label} step {i}: ledger bytes by level {ledger}")
            moved = {a for a, c in s["pool_by_level"].items()
                     if c["retrieved"] > 0}
            if label == "pp_cxl" and moved != {"stage", "data"}:
                fail(f"{label} step {i}: pool bytes by level "
                     f"{s['pool_by_level']}")
        log(f"[train] {label}: bubble fraction {bub:.4f}, launches per "
            f"rank (step 0) {json.dumps(run['steps'][0]['launches_per_rank'])}")
    choices = check_auto_choices(runs["pp_auto"], plan,
                                 parse_topology(PP_TOPOLOGY))
    if not choices.get("p2p") or any(c["level"] != "stage"
                                     for c in choices["p2p"]):
        fail(f"pp_auto: the handoffs resolved {choices.get('p2p')}")
    return choices
# 7h's runs, Zamba2-1.2B over (data, model) (variants of 7c's spawn)
HYBRID_TP_RUNS = ("hybrid_tp_cxl_fused", "hybrid_tp_cxl", "hybrid_tp_auto")
# 7c's online re-tuned variant: its observability files (rank 0's)
RETUNE_BASE = "retune_tp"
RETUNE_KERNELS = ("rms_norm", "rms_norm_vjp", "flash_attention")


# decode_tp: the sequence-sharded decode of Llama-3.2-1B at full width
# over (data, model) = (2, 2) under cxl, in 7c's spawn: the dry-run's
# decode_32k step (launch.dryrun.build_step) at a global batch of 4 and a
# cache of 2064 positions (1032 a model rank), after a prefill of 1028
# (flash_attention; the prefill pads), then 8 decode steps that write
# positions 1028-1035, across model rank 0's segment into rank 1's
DECODE_TP_ARCH = "llama3.2-1b"
DECODE_TP_BATCH, DECODE_TP_PROMPT, DECODE_TP_MAX_SEQ = 4, 1028, 2064
DECODE_TP_STEPS = 8
DECODE_TP_TOL = (2e-4, 2e-4)      # rtol, atol of every step's logits
DECODE_TP_SEED = 0


def decode_tp_launches(n_layers: int) -> dict:
    """Every rank's exact launches over the prefill and the decode steps:
    flash_attention once a row of the prefill (L = 1028 >= 1024);
    rms_norm twice a row and once more (the final norm) a forward;
    chunked_reduce at N = 2 once a model-level AllReduce (cxl's two-phase
    AllReduce sums its partials once): the prefill's embedding and a
    row's attention and FFN outputs, a decode step's embedding and a
    row's three attention AllReduces (the weights' sum, the weighted
    values, the output projection) and its FFN's.  The global max
    (``tp_psum_max``) and the gathers reduce nothing."""
    steps = DECODE_TP_STEPS
    return {"flash_attention": n_layers,
            "rms_norm": (2 * n_layers + 1) * (1 + steps),
            "chunked_reduce": (1 + 2 * n_layers)
            + steps * (1 + 4 * n_layers)}


def _ledger_cells(snap: dict) -> dict:
    """The parts of a ledger that the dry-run's record must equal."""
    return {k: snap.get(k) for k in ("wire_bytes", "collective_calls",
                                     "level_wire_bytes", "level_counts")}


def decode_tp_rank(ctx, topology_spec: str) -> dict:
    """One rank of ``decode_tp`` (``train.run_many``'s ``after``): the
    port's tp = 1 prefill and greedy decode of this data rank's batch on
    the card, then the same through the dry-run's step at tp = 2,
    teacher-forced with the tp = 1 tokens, each step's logits held to
    tp = 1's; the kernels' launches of the tp = 2 run only; every decode
    step's ledger; each decode step's seconds at both tp."""
    from repro_torch.configs import get_config
    from repro_torch.core import ledger
    from repro_torch.core.topology import parse_topology, set_active_topology
    from repro_torch.kernels import chunked_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    t_start = time.perf_counter()
    dev = ctx.device
    topo = parse_topology(topology_spec)
    set_active_topology(topo)
    mesh = make_host_mesh((("data", TP_DP), ("model", TP_TP)), ctx,
                          topology=topo)
    f32 = torch.float32
    cfg = get_config(DECODE_TP_ARCH)
    b = DECODE_TP_BATCH // TP_DP
    gen = torch.Generator(dev).manual_seed(DECODE_TP_SEED + 1
                                           + mesh["data"].rank)
    prompt = torch.randint(0, cfg.vocab_size, (b, DECODE_TP_PROMPT),
                           generator=gen, device=dev)

    def timed(fn, *args):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    # tp = 1: the same GLOBAL params from the seed, the whole model
    params1 = model.init_params(cfg, torch.Generator(dev).manual_seed(
        DECODE_TP_SEED), dev, f32, tp=TP_TP)
    logits, cache1 = model.prefill(params1, {"tokens": prompt}, cfg,
                                   UNSHARDED, DECODE_TP_MAX_SEQ,
                                   cache_dtype=f32)
    want_prefill = logits[:, -1].float().cpu()
    toks, want, secs1 = [], [], []
    tok = logits[:, -1:].argmax(-1)
    for i in range(DECODE_TP_STEPS):
        toks.append(tok)
        pos = torch.tensor(DECODE_TP_PROMPT + i, device=dev)
        (logits, cache1), s = timed(model.decode_step, params1, cache1, tok,
                                    pos, cfg, UNSHARDED)
        secs1.append(s)
        want.append(logits.float().cpu())
        tok = logits.argmax(-1)
    del params1, cache1, logits
    torch.cuda.empty_cache()

    # tp = 2 through the dry-run's step, with real tensors
    fn, (params, cache, _, _), _ = dryrun.build_step(
        DECODE_TP_ARCH, "decode_32k", mesh, "cxl",
        seq_len=DECODE_TP_MAX_SEQ, global_batch=DECODE_TP_BATCH,
        device=dev, param_dtype=f32, cache_dtype=f32, seed=DECODE_TP_SEED)
    pc = fn.pc
    del cache
    torch.cuda.synchronize(dev)
    for f in (fa.flash_attention, rn.rms_norm, cr.chunked_reduce):
        f.launches = 0
    cr.chunked_reduce.launches_by_n = {}
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt}, cfg, pc,
                                  DECODE_TP_MAX_SEQ, cache_dtype=f32)
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    v_loc = logits.shape[-1]
    lo = pc.tp_index() * v_loc
    hi = min(lo + v_loc, cfg.vocab_size)
    errs = []
    rel = []

    def held(got, ref):
        d = (got - ref).abs()
        errs.append(float(d.max()))
        rel.append(float((d / (DECODE_TP_TOL[1]
                               + DECODE_TP_TOL[0] * ref.abs())).max()))

    held(logits[:, -1, :hi - lo].float().cpu(), want_prefill[:, lo:hi])
    secs2, snaps = [], []
    for i in range(DECODE_TP_STEPS):
        pos = torch.tensor(DECODE_TP_PROMPT + i, device=dev)
        ledger.reset()
        (logits, cache), s = timed(fn, params, cache, toks[i], pos)
        snaps.append(_ledger_cells(ledger.snapshot()))
        secs2.append(s)
        held(logits.float().cpu(), want[i])
    launches = {"flash_attention": fa.flash_attention.launches,
                "rms_norm": rn.rms_norm.launches,
                "chunked_reduce": cr.chunked_reduce.launches,
                "chunked_reduce_by_n": dict(
                    cr.chunked_reduce.launches_by_n)}
    finite = bool(torch.isfinite(logits).all())
    del params, cache, logits
    torch.cuda.empty_cache()
    set_active_topology(None)
    return {"rank": ctx.rank, "max_abs_err": max(errs),
            "max_tol_ratio": max(rel), "finite": finite,
            "launches": launches, "ledgers": snaps,
            "prefill_s": prefill_s, "decode_s_tp1": secs1,
            "decode_s_tp2": secs2,
            "cache_positions_a_rank": DECODE_TP_MAX_SEQ // TP_TP,
            "seconds": time.perf_counter() - t_start}


def decode_tp_record() -> dict:
    """The meta-device dry-run record of the same decode step: the same
    shapes, mesh, backend, topology and dtypes (f32 params and cache)."""
    from repro_torch.core.topology import parse_topology, set_active_topology
    from repro_torch.launch import dryrun
    set_active_topology(parse_topology(TP_TOPOLOGY))
    try:
        rec = dryrun.run_one(DECODE_TP_ARCH, "decode_32k", False, "cxl",
                             None, mesh_shape=TP_MESH,
                             seq_len=DECODE_TP_MAX_SEQ,
                             global_batch=DECODE_TP_BATCH,
                             param_dtype=torch.float32,
                             cache_dtype=torch.float32)
    finally:
        set_active_topology(None)
    if rec["status"] != "ok":
        fail(f"decode_tp: the dry-run record failed: {rec.get('error')}")
    return rec


def check_decode_tp(per_rank: list, rec: dict) -> dict:
    """decode_tp's checks: on every rank every step's logits within
    ``DECODE_TP_TOL`` of tp = 1 (and finite), the exact launches of
    :func:`decode_tp_launches` (chunked_reduce all at N = 2), and rank
    0's ledger of every decode step equal to the dry-run record's."""
    from repro_torch.configs import get_config
    want = decode_tp_launches(get_config(DECODE_TP_ARCH).n_layers)
    for r in per_rank:
        if not r["finite"] or r["max_tol_ratio"] > 1.0:
            fail(f"decode_tp: rank {r['rank']}'s logits off tp = 1 by "
                 f"{r['max_abs_err']:.3e} ({r['max_tol_ratio']:.3f} of "
                 f"the tolerance rtol {DECODE_TP_TOL[0]}, atol "
                 f"{DECODE_TP_TOL[1]})")
        got = {k: r["launches"][k] for k in want}
        if got != want or set(r["launches"]["chunked_reduce_by_n"]) != {2}:
            fail(f"decode_tp: rank {r['rank']} launched {r['launches']}, "
                 f"want {want} (chunked_reduce at N = 2 only)")
    meta = _ledger_cells(rec["ledger"])
    for i, snap in enumerate(per_rank[0]["ledgers"]):
        if snap != meta:
            fail(f"decode_tp: rank 0's ledger of decode step {i} "
                 f"{json.dumps(snap)} is not the dry-run record's "
                 f"{json.dumps(meta)}")
    med = lambda xs: float(np.median(xs))          # noqa: E731
    out = {"launches_a_rank": want,
           "max_abs_err": max(r["max_abs_err"] for r in per_rank),
           "max_tol_ratio": max(r["max_tol_ratio"] for r in per_rank),
           "decode_step_ms_tp1": [1e3 * med(r["decode_s_tp1"])
                                  for r in per_rank],
           "decode_step_ms_tp2": [1e3 * med(r["decode_s_tp2"])
                                  for r in per_rank],
           "prefill_s_tp2": [r["prefill_s"] for r in per_rank],
           "check_s": max(r["seconds"] for r in per_rank),
           "ledger": meta, "record_trace_s": rec["lower_s"],
           "record_memory": rec["memory"], "record_cost": rec["cost"]}
    log(f"[decode_tp] {DECODE_TP_ARCH} (data, model) = ({TP_DP}, {TP_TP}) "
        f"cxl: {DECODE_TP_STEPS} steps, logits within "
        f"{out['max_tol_ratio']:.3f} of the tolerance (max |d| "
        f"{out['max_abs_err']:.3e}); decode step ms tp1 "
        f"{out['decode_step_ms_tp1']} tp2 {out['decode_step_ms_tp2']}; "
        f"launches a rank {want}; rank 0's ledger = the dry-run record's; "
        f"{out['check_s']:.1f}s in the spawn")
    return out


def retune_flags(plan_path: str) -> list:
    """``tp_auto_retune``'s flags after 7c's: auto on 7c's plan, re-tuned
    at every step boundary from per-call samples, with every output."""
    base = str(OUT_DIR / RETUNE_BASE)
    return ["--backend", "auto", "--plan", plan_path, "--online-retune",
            "--retune-interval", "1", "--timing-source", "profiler",
            "--metrics-out", base + ".jsonl", "--trace-out",
            base + ".trace.json", "--plan-out", base + ".plan.json"]


# one sample line of the Prometheus text format: name{labels} value
PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{((?:[a-zA-Z_]'
                       r'[a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})? (\S+)$')


def parse_prom(text: str) -> dict:
    """Prometheus text exposition (0.0.4) -> {(name, labels): value};
    fails on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or \
                line.startswith("# TYPE "):
            continue
        m = PROM_LINE.match(line)
        if m is None:
            fail(f"unparsable Prometheus line {line!r}")
        v = m.group(4)
        out[(m.group(1), m.group(3) or "")] = float(
            "inf" if v == "+Inf" else v)
    return out


def metric_events(path: str) -> tuple:
    """A metrics stream's events and its final registry's samples,
    {(name, sorted labels): value}."""
    from repro_torch.launch import report
    events = report.load_events(path)
    metrics = {(e["name"], tuple(sorted(e["labels"].items()))): e["value"]
               for e in events if e["kind"] == "metric"}
    return events, metrics


def check_retune_run(run: dict, auto: dict, tp_plan, tp_plan_path: str,
                     topology) -> dict:
    """7c's ``tp_auto_retune``: the checks of its every output against
    ``auto`` (``tp_auto``, the same plan with no timing, in the same
    spawn).  Returns what it measured: the calibration table, the
    drift recommendations, the regret, the swaps and the step times."""
    import os
    import subprocess as sp

    from repro_torch import tuner
    from repro_torch.launch import tune
    from repro_torch.obs import calibration_drift
    t_check = time.perf_counter()
    steps, n = run["steps"], len(run["steps"])
    ls, la = [s["loss"] for s in steps], [s["loss"] for s in auto["steps"]]
    # losses: step 0 bitwise (the same cells; timing touches no number),
    # later steps within 1e-4 (refreshed cells sum in other orders)
    if len(la) < n:
        fail(f"tp_auto ran {len(la)} steps, tp_auto_retune {n}: a step "
             f"of the re-tuned run has no loss to be held to")
    if ls[0] != la[0]:
        fail(f"tp_auto_retune step-0 loss {ls[0]!r} != tp_auto's {la[0]!r}")
    for i in range(1, n):
        if abs(ls[i] - la[i]) > 1e-4 * abs(la[i]):
            fail(f"tp_auto_retune step {i} loss {ls[i]} vs tp_auto {la[i]}")
    if not ls[-1] < ls[0]:
        fail(f"tp_auto_retune: the loss did not fall: {ls}")
    # rank agreement: the same epoch a step, the same plan a refresh
    plans = {steps[0]["obs_per_rank"][0]["plan_epoch"]: tp_plan}
    for i, s in enumerate(steps):
        if len({o["plan_epoch"] for o in s["obs_per_rank"]}) != 1:
            fail(f"tp_auto_retune step {i}: the ranks ran under epochs "
                 f"{[o['plan_epoch'] for o in s['obs_per_rank']]}")
        rts = s["retune_per_rank"]
        if len({json.dumps(r, sort_keys=True) for r in rts}) != 1:
            fail(f"tp_auto_retune step {i}: the ranks refreshed apart: "
                 f"{rts}")
        rt = s["retune_rank0"]
        if (rt is None) != (i == n - 1):
            fail(f"tp_auto_retune step {i}: a refresh at every boundary "
                 f"between steps and none after the last, got {rt}")
        if rt is not None:
            plans[rt["epoch"]] = tuner.Plan.from_json(rt["plan"])
        # samples: one a call on every rank, from step 0 on
        for r, o in enumerate(s["obs_per_rank"]):
            if o["timing_samples"] != o["audit_calls"] or not o["audit_calls"]:
                fail(f"tp_auto_retune step {i} rank {r}: "
                     f"{o['timing_samples']} samples of {o['audit_calls']} "
                     f"calls")
    epochs = [s["obs_per_rank"][0]["plan_epoch"] for s in steps]
    if epochs != list(range(epochs[0], epochs[0] + n)):
        fail(f"tp_auto_retune: epochs a step {epochs}")
    # plan cells: every call at the cell of its own epoch's plan
    choices = check_auto_choices(run, tp_plan, topology, plans=plans)
    # kernels: every rank, every step; chunked_reduce where a step's
    # choices reduce through the pool
    for i, s in enumerate(steps):
        need = list(RETUNE_KERNELS)
        if any(c["backend"] == "cxl" and c["primitive"] in (
                "all_reduce", "reduce_scatter") for c in s["choices_rank0"]):
            need.append("chunked_reduce")
        idle = [k for k in need if s["launches_min_rank"][k] <= 0]
        if idle:
            fail(f"tp_auto_retune step {i}: a rank launched no {idle}")
    # metrics stream: a step event a step, a retune event a boundary,
    # from_ledger's gauges = rank 0's ledger snapshot
    base = OUT_DIR / RETUNE_BASE
    events, metrics = metric_events(str(base) + ".jsonl")
    kinds = [e["kind"] for e in events]
    if kinds.count("step") != n or kinds.count("retune") != n - 1:
        fail(f"tp_auto_retune metrics: {kinds.count('step')} step and "
             f"{kinds.count('retune')} retune events")
    led = run["obs"]["ledger"]
    for kind, b in led["wire_bytes"].items():
        if metrics.get(("repro_wire_bytes", (("kind", kind),))) != b:
            fail(f"tp_auto_retune metrics: wire bytes of {kind}")
    for lk, kk in led["level_wire_bytes"].items():
        level, _, fabric = lk.partition("/")
        for kind, b in kk.items():
            got = metrics.get(("repro_level_wire_bytes", (
                ("fabric", fabric), ("kind", kind), ("level", level))))
            if got != b:
                fail(f"tp_auto_retune metrics: {lk} {kind} {got} != {b}")
    if led["level_wire_bytes"] != steps[-1]["level_wire_bytes_rank0"] or \
            led["wire_bytes"] != steps[-1]["wire_bytes_rank0"]:
        fail("tp_auto_retune: the finalized ledger is not the last step's")
    prom = parse_prom((OUT_DIR / (RETUNE_BASE + ".prom")).read_text())
    if prom.get(("repro_steps_total", "")) != n:
        fail(f"tp_auto_retune .prom: steps {prom.get(('repro_steps_total', ''))}")
    # the trace: every rank's steps, a collective event a sample
    doc = json.loads((OUT_DIR / (RETUNE_BASE + ".trace.json")).read_text())
    meta = doc["metadata"]
    if meta["steps_retained_by_rank"] != [list(range(n))] * len(
            run["obs_per_rank"]):
        fail(f"tp_auto_retune trace: steps {meta['steps_retained_by_rank']}")
    for r in range(len(run["obs_per_rank"])):
        got = sum(e["pid"] == r for e in doc["traceEvents"]
                  if e.get("cat") == "collective")
        want = sum(s["obs_per_rank"][r]["timing_samples"] for s in steps)
        if got != want:
            fail(f"tp_auto_retune trace: rank {r} {got} collective events, "
                 f"{want} samples")
    # the report, through its CLI
    rep = sp.run([sys.executable, "-m", "repro_torch.launch.report",
                  str(base) + ".jsonl", "--trace", str(base) + ".trace.json"],
                 capture_output=True, text=True, timeout=120,
                 env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if rep.returncode != 0 or "retunes:" not in rep.stdout:
        fail(f"launch.report failed: {rep.stderr[-2000:]}")
    for line in rep.stdout.splitlines():
        log(f"[report] {line}")
    # the refined plan: loads (v4), every cell the calls took is there,
    # measured where the run executed its choice
    refined = tuner.load_plan(str(base) + ".plan.json")
    lkeys = {lv.axis: topology.level_key(lv.axis) for lv in topology.levels}
    ran: dict = {}        # cell -> the candidates the run executed there
    for s in steps:
        for c in s["choices_rank0"]:
            ran.setdefault((c["primitive"], tuner.size_bucket(
                c["msg_bytes"]), c["nranks"], lkeys[c["level"]]), set()).add(
                (c["backend"], c["slicing_factor"], c["allreduce_mode"]))
    measured = unexecuted = 0
    for key, cands in ran.items():
        ch = refined.entries.get(key)
        if ch is None:
            fail(f"tp_auto_retune plan-out: no cell {key}")
        if (ch.backend, ch.slicing_factor, ch.allreduce_mode) in cands:
            if ch.sample_count <= 0:
                fail(f"tp_auto_retune plan-out: {key} ran {ch} unmeasured")
            measured += 1
        else:
            unexecuted += 1
    if not measured:
        fail("tp_auto_retune plan-out: no measured cell")
    # tune --measurements folds the run's samples into 7c's plan to the
    # same measured cells
    folded = tune.main(["--topology", TP_TOPOLOGY, "--nranks", str(TP_TP),
                        "--sizes-mib", *TUNE_SIZES_MIB, "--quiet", "--out",
                        str(OUT_DIR / "plan_auto_tp_folded.json"),
                        "--measurements", str(base) + ".plan.timings.json"])

    def measured_cells(plan):
        return {k: (c.backend, c.slicing_factor, c.allreduce_mode,
                    c.measured_us, c.sample_count)
                for k, c in plan.entries.items() if c.sample_count > 0}
    if measured_cells(folded) != measured_cells(refined):
        fail("tune --measurements folds the run's samples to other cells "
             "than its --plan-out")
    ob = run["obs"]
    drift = calibration_drift(ob["calibration"])
    step_s = [s["step_s"] for s in steps]
    out = {"calibration": ob["calibration"], "drift": drift,
           "regret_s": ob["regret_s"], "swaps": ob["swaps"],
           "swapped": [s["retune_rank0"]["swapped"] for s in steps[:-1]],
           "epochs": epochs, "samples_a_rank_step": [
               s["obs_per_rank"][0]["timing_samples"] for s in steps],
           "losses": ls, "tp_auto_losses": la, "step_s": step_s,
           "tp_auto_step_s": [s["step_s"] for s in auto["steps"]],
           "plan_cells_measured": measured,
           "plan_cells_unexecuted_choice": unexecuted,
           "measured_cells_folded": len(measured_cells(folded)),
           "choices": choices,
           # what the variant costs the script: its set-up and steps in
           # 7c's spawn, and these checks (the report's subprocess and
           # the fold included)
           "init_s": run["init_s"], "steps_s": sum(step_s),
           "check_s": time.perf_counter() - t_check}
    for e in ob["calibration"]["scales"]:
        log(f"[retune] calibration {e['backend']} {e['level']} "
            f"{e['primitive']}: measured/oracle {e['scale']:.6g} over "
            f"{e['samples']:.0f} samples")
    for e in ob["calibration"]["levels"]:
        log(f"[retune] calibration {e['backend']} {e['level']} (all "
            f"primitives): {e['scale']:.6g} over {e['samples']:.0f} samples")
    for d in drift:
        log(f"[retune] calibration drift {json.dumps(d)}")
    log(f"[retune] measured regret {ob['regret_s']:.6g} s, choices changed "
        f"at boundaries {out['swapped']}, epochs {epochs}, samples a "
        f"rank-step {out['samples_a_rank_step']}")
    log(f"[retune] step s {[round(t, 4) for t in step_s]} vs tp_auto "
        f"{[round(t, 4) for t in out['tp_auto_step_s']]}; losses {ls} vs "
        f"{la}; plan-out {measured} measured cells taken, {unexecuted} "
        f"whose choice the run never executed; tune --measurements "
        f"{out['measured_cells_folded']} measured cells")
    log(f"[retune] the variant's cost: set-up {out['init_s']:.1f}s, steps "
        f"{out['steps_s']:.1f}s, checks {out['check_s']:.1f}s")
    return out


def hybrid_tp_train_phase(runs: dict, tp_plan, first_4x1: float) -> dict:
    """Phase 7h's checks: Zamba2-1.2B at full width and depth over
    ``--mesh 2x2 --topology data:cxl,model:cxl`` (Mamba channels and
    heads, the shared block's heads and FFN columns and the vocabulary
    sharded over model, FSDP over data, both levels on the pool) under
    cxl+fused, cxl and auto (7c's plan; 2 steps each), ``runs``, made
    in 7c's spawn: the checks of 7g, both levels'
    pools, every auto call at its level's cell, and the step-0 losses
    within 1e-4 of each other and of the ``4x1`` path's."""
    from repro_torch.core.topology import parse_topology
    check_hybrid_runs(runs)
    check_hybrid_tp_runs(runs, first_4x1)
    out = {"hybrid_tp": runs, "hybrid_tp_auto_choices": check_auto_choices(
        runs["hybrid_tp_auto"], tp_plan, parse_topology(TP_TOPOLOGY))}
    check_losses(runs, runs["hybrid_tp_cxl_fused"]["steps"][0]["loss"])
    return out


def _zero_counters() -> None:
    from repro_torch.kernels.chunked_reduce import chunked_reduce
    from repro_torch.launch.train import KERNEL_COUNTERS
    for f in KERNEL_COUNTERS.values():
        f.launches = 0
    chunked_reduce.launches_by_n = {}


def _read_counters() -> dict:
    from repro_torch.launch.train import KERNEL_COUNTERS
    return {k: f.launches for k, f in KERNEL_COUNTERS.items()}


def train_lm_launches(n_layers: int) -> dict:
    """Kernel launches of one train_lm step at one rank (remat, sequences
    of 256 tokens): rms_norm on each row's two norms, again in the remat
    replay, and on the final norm; its backward kernel once a norm;
    attention under ``FLASH_THRESHOLD`` (1024) takes the plain path, and
    one rank runs no collective."""
    return {"rms_norm": 4 * n_layers + 1, "rms_norm_vjp": 2 * n_layers + 1,
            "flash_attention": 0, "chunked_reduce": 0,
            "all_gather_matmul": 0, "ssm_scan": 0, "ssm_scan_vjp": 0}


def _restore_bitwise(ckpt_dir, step: int, cfg, params) -> list:
    """The paths where ``checkpoint.restore`` of ``ckpt_dir`` at
    ``step`` into ``cfg``'s GLOBAL shapes differs from ``params``
    (tensors or numpy) bitwise."""
    from repro_torch.core import tree
    from repro_torch.models import model
    from repro_torch.training import checkpoint
    got = checkpoint.restore(str(ckpt_dir), step, {
        "params": model.abstract_params(cfg)})["params"]
    bad = []
    for p, x in tree.leaves_with_paths(got):
        want = tree.get(params, p)
        if isinstance(want, torch.Tensor):
            want = want.detach().cpu().numpy()
        if not np.array_equal(x.view(np.uint32), want.view(np.uint32)):
            bad.append("/".join(p))
    return bad


def train_lm_phase() -> dict:
    """8a: ``python -m repro_torch.examples.train_lm --steps 30`` (the
    example's ``main``) at one rank on the card, full width (CFG_100M,
    batch 8 x 256 tokens): the logged loss at the last step below step
    0's, exactly :func:`train_lm_launches` a step, the checkpoint
    restored bitwise to the returned params, the mean seconds of a step
    after the first (the example's, from the clock at its logged steps:
    no sync of its own between them).
    First the params it starts from (seed 0 on the card, as ``train()``
    makes them) go to an .npz, 8b's start (``init_path``)."""
    import shutil

    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.models import model
    cfg = train_lm.CFG_100M
    dev = torch.device("cuda", torch.cuda.current_device())
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    TRAIN_LM_DIR.mkdir(parents=True)
    init_path = str(TRAIN_LM_DIR / "init.npz")
    train.save_params_npz(model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), init_path)
    _zero_counters()
    t0 = time.perf_counter()
    out = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--ckpt",
                         str(TRAIN_LM_DIR / "one")])
    wall = time.perf_counter() - t0
    got = _read_counters()
    want = {k: TRAIN_LM_STEPS * n
            for k, n in train_lm_launches(cfg.n_layers).items()}
    losses = out["losses"]
    bad = _restore_bitwise(TRAIN_LM_DIR / "one", TRAIN_LM_STEPS, cfg,
                           out["params"])
    rec = {"wall_s": wall, "losses_logged": {
        i: v for i, v in enumerate(losses) if v is not None},
        "mean_step_s": out["mean_step_s"],
        "launches": got, "launches_a_step": train_lm_launches(cfg.n_layers),
        "ckpt_bitwise": not bad, "params": cfg.param_count(),
        "init_path": init_path}
    log(f"[examples] train_lm 1 rank: {json.dumps(rec)}")
    if not losses[-1] < losses[0]:
        fail(f"train_lm: the loss did not fall: {rec['losses_logged']}")
    if got != want:
        fail(f"train_lm: launches {got}, want {want}")
    if bad:
        fail(f"train_lm: the checkpoint restores other params: {bad[:4]}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_lm_tp_spec(init_path: str):
    """8b's run: ``train_lm --backend cxl --tp 2 --dp 2 --steps 4`` from
    8a's initial params, as the example builds it (its
    ``sharded_spec``), for 7c's spawn (the same rank groups)."""
    from repro_torch.examples import train_lm
    args = train_lm.build_parser().parse_args([
        "--backend", "cxl", "--tp", str(TP_TP), "--dp", str(TP_DP),
        "--steps", str(TRAIN_LM_TP_STEPS), "--ckpt",
        str(TRAIN_LM_DIR / "tp")])
    return train_lm.sharded_spec(args, init_path)


def check_train_lm_tp(run: dict, one: dict, device: str = "cuda") -> dict:
    """8b's checks: step-0 loss within 1e-4 of 8a's (the same params and
    batch; the sharded step's sums in other orders), the loss falls,
    every rank launched chunked_reduce at N = 2 every step, and the
    GLOBAL checkpoint restores bitwise to the run's params and into a
    one-rank ``train_loop.train`` step on the card whose loss is, at
    rtol 1e-4, that of the same step from the params the ranks returned
    (not read from the file)."""
    import shutil

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.examples import train_lm
    from repro_torch.models import model
    from repro_torch.training import checkpoint
    from repro_torch.training.train_loop import train
    cfg = train_lm.CFG_100M
    ls = [s["loss"] for s in run["steps"]]
    first = one["losses_logged"][0]
    if abs(ls[0] - first) > 1e-4 * abs(first):
        fail(f"train_lm tp 2 x dp 2: step-0 loss {ls[0]}, one rank's "
             f"{first}")
    if not ls[-1] < ls[0]:
        fail(f"train_lm tp 2 x dp 2: the loss did not fall: {ls}")
    for i, s in enumerate(run["steps"]):
        for r, by_n in enumerate(s["chunked_reduce_by_n_per_rank"]):
            if by_n.get(2, 0) <= 0:
                fail(f"train_lm tp 2 x dp 2 step {i}: rank {r} launched "
                     f"chunked_reduce at N {by_n}, wants 2")
    params = run.pop("global_params")
    bad = _restore_bitwise(TRAIN_LM_DIR / "tp", TRAIN_LM_TP_STEPS, cfg,
                           params)
    if bad:
        fail(f"train_lm tp 2 x dp 2: the checkpoint restores other params: "
             f"{bad[:4]}")
    restored = checkpoint.restore(str(TRAIN_LM_DIR / "tp"),
                                  TRAIN_LM_TP_STEPS, {
                                      "params": params})["params"]
    tcfg = train_lm.train_config(train_lm.build_parser().parse_args([]))

    def one_rank_loss(tree) -> float:
        _, _, m = train(cfg, tcfg, iter(SyntheticTokens(cfg, batch=2,
                                                        seq=256)),
                        steps=1, params=model.params_from_numpy(
                            tree, device, cfg),
                        log_fn=lambda line: None, device=device)
        return float(m["loss"])
    resumed, returned = one_rank_loss(restored), one_rank_loss(params)
    del params, restored
    rec = {"losses": ls, "step_s": [s["step_s"] for s in run["steps"]],
           "chunked_reduce_by_n_per_rank": [
               s["chunked_reduce_by_n_per_rank"] for s in run["steps"]],
           "ckpt_bitwise": True, "resumed_one_rank_loss": resumed,
           "returned_one_rank_loss": returned,
           "spawn_s": run["spawn_s"], "save_s": run.get("save_s")}
    log(f"[examples] train_lm tp 2 x dp 2: {json.dumps(rec)}")
    if not (np.isfinite(resumed)
            and abs(resumed - returned) <= 1e-4 * abs(returned)):
        fail(f"train_lm: the tp-2 checkpoint trains to loss {resumed} at "
             f"one rank, the params the ranks returned to {returned}")
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    return rec


def check_quickstart(per_rank: list, y: np.ndarray) -> dict:
    """8c: quickstart's part 3 (its ``allreduce_rank`` on 4 ranks under
    cxl, run after the flat spawn's specs): every rank's result the
    numpy sum at rtol 1e-4 (the example's own check), and every rank
    launched chunked_reduce at N = 4."""
    from repro_torch.examples import quickstart
    quickstart.check_allreduce(per_rank, y)
    by_n = [r["chunked_reduce_by_n"] for r in per_rank]
    log(f"[examples] quickstart part 3 on {len(per_rank)} ranks: exact, "
        f"chunked_reduce by N a rank {by_n}")
    if any(b.get(DP, 0) <= 0 for b in by_n):
        fail(f"quickstart: a rank launched no chunked_reduce at N = {DP}: "
             f"{by_n}")
    return {"chunked_reduce_by_n_per_rank": by_n}


def examples_phase() -> dict:
    """8d and 8e: ``serve_lm`` at full width (Llama-3.2-1B with its
    defaults, then Falcon-Mamba-7B with ``--window 64``, each engine and
    its params freed before the next), checking the tokens' shape (4, 16)
    and range and that the kernels ran; ``autotune_workflow``'s body on
    the card at its smoke size and on the CPU from the same params (drawn
    once on the CPU, seed 0): the loss card vs CPU at rtol 2e-4 and the
    audited (primitive, bytes, nranks, backend) equal."""
    from repro_torch.configs import get_config
    from repro_torch.examples import autotune_workflow, serve_lm
    from repro_torch.models import model
    out: dict = {}
    need = {"serve_lm": ("rms_norm",), "serve_lm_ssm": ("rms_norm",
                                                         "ssm_scan")}
    for key, argv in SERVE_LM_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        _zero_counters()
        got = serve_lm.main(argv)
        launches = _read_counters()
        toks = got["tokens"]
        vocab = get_config(argv[1]).vocab_size
        rec = {"argv": argv, "shape": list(toks.shape),
               "seconds": got["seconds"], "tok_s": got["tok_s"],
               "launches": launches, "first": toks[0].tolist()}
        log(f"[examples] {key}: {json.dumps(rec)}")
        if toks.shape != (4, 16) or toks.min() < 0 or toks.max() >= vocab:
            fail(f"{key}: tokens of shape {toks.shape} in "
                 f"[{toks.min()}, {toks.max()}], vocabulary {vocab}")
        idle = [k for k in need[key] if launches[k] <= 0]
        if idle:
            fail(f"{key}: never launched {idle}")
        out[key] = rec
        del got
    gc.collect()
    torch.cuda.empty_cache()
    smoke = get_config(autotune_workflow.ARCH, smoke=True)
    cpu_dev = torch.device("cpu")
    cpu_params = model.init_params(smoke, torch.Generator().manual_seed(0),
                                   cpu_dev)
    card_params = model.params_from_numpy(
        model.params_to_numpy(cpu_params), "cuda", smoke)
    _zero_counters()
    card = autotune_workflow.run(card_params, torch.device("cuda"), log)
    launches = _read_counters()
    cpu = autotune_workflow.run(cpu_params, cpu_dev, log)

    def cells(audit):
        return [(a["primitive"], a["msg_bytes"], a["nranks"], a["backend"])
                for a in audit]
    rec = {"loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "auto_choices": cells(card["auto_choices"]),
           "launches": launches}
    log(f"[examples] autotune_workflow: {json.dumps(rec)}")
    if cells(card["auto_choices"]) != cells(cpu["auto_choices"]):
        fail(f"autotune_workflow: the card's audit "
             f"{cells(card['auto_choices'])} is not the CPU's "
             f"{cells(cpu['auto_choices'])}")
    if launches["rms_norm"] <= 0 or not (
            abs(card["loss"] - cpu["loss"]) <= 2e-4 * abs(cpu["loss"])):
        fail(f"autotune_workflow: launches {launches}, loss on the card "
             f"{card['loss']}, on the CPU {cpu['loss']} (rtol 2e-4)")
    out["autotune"] = rec
    return out


def train_phase(train_lm_init: str) -> dict:
    """Phase 7: FSDP training on DP ranks sharing the card; 7b over
    (pod, data), 7c over (data, model), 7d over a grouped data axis; and
    phase 8's runs that share a spawn: 8b (from ``train_lm_init``, 8a's
    initial params) in 7c's, 8c in the flat one."""
    from repro_torch.configs import get_config
    from repro_torch.core.topology import parse_topology
    from repro_torch.examples import quickstart

    # every path's smoke model: the card's training path against the
    # CPU's
    out: dict = smoke_checks()

    # the plans the auto runs resolve against: the flat one for its 4
    # ranks, the hierarchical one per level of its topology (2 ranks each)
    from repro_torch import tuner
    from repro_torch.launch import tune
    OUT_DIR.mkdir(exist_ok=True)
    plan_path = str(OUT_DIR / "plan_auto.json")
    tune.main(["--nranks", str(DP), "--sizes-mib", *TUNE_SIZES_MIB,
               "--quiet", "--out", plan_path])
    plan = tuner.load_plan(plan_path)
    hier_plan_path = str(OUT_DIR / "plan_auto_hier.json")
    tune.main(["--topology", HIER_TOPOLOGY, "--nranks", "2",
               "--sizes-mib", *TUNE_SIZES_MIB, "--quiet", "--out",
               hier_plan_path])
    hier_plan = tuner.load_plan(hier_plan_path)

    # full width and depth, through the launcher's flags; the runs but
    # the profiled first of each model take SHORT_STEPS (of the earlier
    # paths, to keep the time limit; the gloo-bound ring run for its own
    # sake).  7g's Zamba2 runs and 7i's whisper-tiny and Phi-3-vision
    # runs ride the same spawn of the ranks.
    vlm = ["--prefetch", VLM_PREFETCH]
    vlm_cfg = cut_config(VLM_ARCH, VLM_TRAIN_ROWS)
    llama_cut = cut_config("llama3.2-1b", GLOO_ROWS)
    qs_input = quickstart.part3_input(DP)
    runs, (qs_ranks,) = full_width_runs({
        "cxl_fused": ["--backend", "cxl", "--fuse-kernels"],
        "cxl": ["--backend", "cxl"],
        "ring": ["--backend", "ring"],
        "cut_cxl": ["--backend", "cxl"],
        "auto": ["--backend", "auto", "--plan", plan_path],
        "hybrid_cxl_fused": ["--backend", "cxl", "--fuse-kernels"],
        "hybrid_cxl": ["--backend", "cxl"],
        "hybrid_auto": ["--backend", "auto", "--plan", plan_path],
        "audio_cxl_fused": ["--backend", "cxl", "--fuse-kernels"],
        "audio_cxl": ["--backend", "cxl"],
        "audio_auto": ["--backend", "auto", "--plan", plan_path],
        "vlm_cxl_fused": ["--backend", "cxl", "--fuse-kernels", *vlm],
        "vlm_cxl": ["--backend", "cxl", *vlm]}, [],
        short=("cxl", *CUT_RUNS, "auto", "hybrid_cxl", "hybrid_auto",
               "audio_cxl", "audio_auto", "vlm_cxl_fused", "vlm_cxl"),
        archs={**dict.fromkeys(HYBRID_RUNS, HYBRID_ARCH),
               **dict.fromkeys(AUDIO_RUNS, AUDIO_ARCH),
               **dict.fromkeys(VLM_RUNS, VLM_ARCH)},
        ckpt={"cxl_fused": str(CKPT_DIR / "llama")},
        unprofiled=("vlm_cxl_fused", "ring"),
        configs={**dict.fromkeys(VLM_RUNS, vlm_cfg),
                 **dict.fromkeys(CUT_RUNS, llama_cut)},
        after=((quickstart.allreduce_rank, (qs_input,)),))
    # 8c. quickstart's part 3 on the flat spawn's ranks and world pool
    out["quickstart"] = check_quickstart(qs_ranks, qs_input)
    hybrid = {k: runs.pop(k) for k in HYBRID_RUNS}
    audio = {k: runs.pop(k) for k in AUDIO_RUNS}
    vlm = {k: runs.pop(k) for k in VLM_RUNS}
    # 7i. the non-text models, on phase 7's plan
    out["audio"] = frontend_train_phase(audio, get_config(AUDIO_ARCH), plan)
    out["vlm"] = frontend_train_phase(vlm, vlm_cfg, plan)
    out["flat_ckpt"] = check_flat_ckpt(runs["cxl_fused"])
    out["full_width"] = runs
    out["auto_choices"] = check_auto_choices(runs["auto"], plan)
    first = runs["cxl_fused"]["steps"][0]["loss"]
    check_losses({k: r for k, r in runs.items() if k not in CUT_RUNS},
                 first)
    # the ring run against cxl on the same cut model
    cut_first = runs["cut_cxl"]["steps"][0]["loss"]
    check_losses({k: runs[k] for k in CUT_RUNS}, cut_first, "cut_cxl")


    # 7c. tensor parallelism: (data, model) = (2, 2), both levels on the
    # pool; full width and depth
    tp_plan_path = str(OUT_DIR / "plan_auto_tp.json")
    tune.main(["--topology", TP_TOPOLOGY, "--nranks", str(TP_TP),
               "--sizes-mib", *TUNE_SIZES_MIB, "--quiet", "--out",
               tp_plan_path])
    tp_plan = tuner.load_plan(tp_plan_path)
    # 7j's plan: p2p cells at the stage level
    pp_plan_path = str(OUT_DIR / "plan_auto_pp.json")
    tune.main(["--topology", PP_TOPOLOGY, "--nranks", str(PP_STAGES),
               "--sizes-mib", *TUNE_SIZES_MIB, "--quiet", "--out",
               pp_plan_path])
    pp_plan = tuner.load_plan(pp_plan_path)
    # (7e's Granite-3.0-MoE runs and 7h's Zamba2 runs ride the same
    # spawn of the ranks: the same mesh and topology, on this plan; 7j's
    # pipeline runs and 7b's (pod, data) runs too: (stage, data) and
    # (pod, data) = (2, 2) have the same rank groups, each its own
    # topology and plan; 8b's train_lm run; and decode_tp after them)
    decode_rec = decode_tp_record()
    moe_cfg = cut_config(MOE_ARCH, MOE_TRAIN_ROWS)
    hier_flags = ["--mesh", f"{DP}x1", "--multi-pod", "--topology",
                  HIER_TOPOLOGY]
    tp, (decode_ranks,) = full_width_runs({
        # 7j first, while the ranks' memory is whole: the pipeline's 15.5-16
        # GiB a rank is the spawn's largest
        "pp_cxl": ["--backend", "cxl", *PP_FLAGS],
        "pp_auto": ["--backend", "auto", "--plan", pp_plan_path,
                    *PP_FLAGS],
        # 7b: the data axis (pod, data) = (2, DP/2), the pool spanning
        # pods and GPU links inside one; auto, whose ici level rides
        # gloo, takes SHORT_STEPS like the others
        "hier_cxl_fused": [*hier_flags, "--backend", "cxl",
                           "--fuse-kernels"],
        "hier_cxl": [*hier_flags, "--backend", "cxl"],
        "hier_auto": [*hier_flags, "--backend", "auto", "--plan",
                      hier_plan_path],  # the cut model, as ring's
        "tp_cxl_fused": ["--backend", "cxl", "--fuse-kernels"],
        "tp_cxl": ["--backend", "cxl"],
        "tp_auto": ["--backend", "auto", "--plan", tp_plan_path],
        "tp_auto_retune": retune_flags(tp_plan_path),
        "moe_cxl_fused": ["--backend", "cxl", "--fuse-kernels",
                          "--prefetch", MOE_PREFETCH],
        "moe_cxl": ["--backend", "cxl", "--prefetch", MOE_PREFETCH],
        "moe_auto": ["--backend", "auto", "--plan", tp_plan_path,
                     "--prefetch", MOE_PREFETCH],
        "hybrid_tp_cxl_fused": ["--backend", "cxl", "--fuse-kernels"],
        "hybrid_tp_cxl": ["--backend", "cxl"],
        "hybrid_tp_auto": ["--backend", "auto", "--plan", tp_plan_path]},
        ["--topology", TP_TOPOLOGY], mesh=TP_MESH,
        short=(*HIER_RUNS, "tp_cxl", "moe_cxl_fused", "moe_cxl",
               "moe_auto", "hybrid_tp_cxl", "hybrid_tp_auto",
               "hybrid_tp_cxl_fused", "pp_auto"),
        archs={**dict.fromkeys(MOE_RUNS, MOE_ARCH),
               **dict.fromkeys(HYBRID_TP_RUNS, HYBRID_ARCH)},
        configs={**dict.fromkeys(MOE_RUNS, moe_cfg),
                 **dict.fromkeys(("hier_auto", *CUT_TP_RUNS), llama_cut)},
        ckpt={"moe_cxl_fused": str(CKPT_DIR / "moe"),
              "pp_cxl": str(CKPT_DIR / "pp")},
        unprofiled=("hier_cxl_fused", "tp_cxl_fused", "tp_auto_retune",
                    "moe_cxl_fused", "hybrid_tp_cxl_fused", "pp_cxl",
                    "train_lm_tp"),
        after=((decode_tp_rank, (TP_TOPOLOGY,)),),
        extra={"train_lm_tp": train_lm_tp_spec(train_lm_init)})
    out["decode_tp"] = check_decode_tp(decode_ranks, decode_rec)
    # 8b. train_lm over (data, model) = (2, 2)
    out["train_lm_tp_run"] = tp.pop("train_lm_tp")
    # 7b. cxl moves bytes through both levels' pools; auto never through
    # the ici level's
    hier = {k: tp.pop(k) for k in HIER_RUNS}
    check_path_runs(hier, {"pod", "data"}, "hier_auto", auto_skip="data")
    out["hier"] = hier
    out["hier_auto_choices"] = check_auto_choices(
        hier["hier_auto"], hier_plan, parse_topology(HIER_TOPOLOGY))
    data_backends = {c["backend"] for s in hier["hier_auto"]["steps"]
                     for c in s["choices_rank0"] if c["level"] == "data"}
    if data_backends != {"ring"}:
        fail(f"hier_auto: the data (ici) level resolved {data_backends}")
    check_losses({k: r for k, r in hier.items() if k != "hier_auto"}, first)
    check_losses({"hier_auto": hier["hier_auto"]}, cut_first, "cut_cxl")
    moe = {k: tp.pop(k) for k in MOE_RUNS}
    hybrid_tp_runs = {k: tp.pop(k) for k in HYBRID_TP_RUNS}
    pp = {k: tp.pop(k) for k in PP_RUNS}
    retune = tp.pop("tp_auto_retune")
    check_path_runs(tp, {"data", "model"}, "tp_auto")
    out["tp"] = tp
    out["tp_auto_choices"] = check_auto_choices(
        tp["tp_auto"], tp_plan, parse_topology(TP_TOPOLOGY))
    # the online re-tuned variant (its own checks; its launches count
    # toward 7c's path)
    out["tp_auto_retune"] = check_retune_run(
        retune, tp["tp_auto"], tp_plan, tp_plan_path,
        parse_topology(TP_TOPOLOGY))
    tp["tp_auto_retune"] = retune
    check_losses({k: r for k, r in tp.items() if k not in CUT_TP_RUNS},
                 first)
    check_losses({k: tp[k] for k in CUT_TP_RUNS}, cut_first, "cut_cxl")

    # 7d. a grouped (ragged) data axis: the 4 ranks as a node of three
    # beside a lone node; full width and depth, and the same run chosen
    # by --placement auto
    ragged_plan_path = str(OUT_DIR / "plan_auto_ragged.json")
    tune.main(["--topology", RAGGED_TOPOLOGY, "--nranks", str(DP),
               "--sizes-mib", *TUNE_SIZES_MIB, "--quiet", "--out",
               ragged_plan_path])
    ragged_plan = tuner.load_plan(ragged_plan_path)
    # (the placement's run rides the same spawn: the placed mesh has the
    # grouped level's rank groups)
    # (7k: the auto run takes the fault plan, the pool snapshots and the
    # recovery loop; its steps before the fault make 7d's auto checks)
    ragged = full_width_runs({
        "ragged_cxl_fused": ["--backend", "cxl", "--fuse-kernels"],
        "ragged_cxl": ["--backend", "cxl"],
        "resil_auto": ["--backend", "auto", "--plan", ragged_plan_path,
                       "--resilience", "--fault-plan", RESIL_FAULT,
                       "--pool-ckpt-interval", str(RESIL_INTERVAL),
                       "--steps", str(RESIL_STEPS)],
        "ragged_placed": ["--backend", "cxl", "--topology",
                          RAGGED_PLACEMENT_TOPOLOGY, "--placement", "auto"]},
        ["--topology", RAGGED_TOPOLOGY],
        short=("ragged_cxl_fused", "ragged_cxl", "ragged_placed"),
        unprofiled=("ragged_cxl_fused", "ragged_placed", "resil_auto"))
    check_path_runs(ragged, {"pod", "data"}, "resil_auto")
    check_ragged_runs(ragged)
    out["ragged"] = ragged
    out["resil"] = check_resil_run(ragged["resil_auto"], ragged_plan, first)
    check_losses(ragged, first)

    # 7e. Mixture-of-Experts: Granite-3.0-MoE over (data, model) = (2, 2),
    # experts parallel over model through the pool's AllToAll, FSDP over
    # data; full width and depth (run in 7c's spawn, on its plan: the
    # same topology)
    out["moe_ckpt"] = check_ckpt_restores(moe["moe_cxl_fused"], moe_cfg,
                                          TP_TP, "moe")
    check_path_runs(moe, {"data", "model"}, "moe_auto")
    out["moe"] = moe
    out["moe_auto_choices"] = check_auto_choices(
        moe["moe_auto"], tp_plan, parse_topology(TP_TOPOLOGY))
    if "all_to_all" not in out["moe_auto_choices"]:
        fail("moe_auto resolved no all_to_all")
    out["moe_routing"] = check_moe_runs(moe, moe_cfg)
    check_losses(moe, moe["moe_cxl_fused"]["steps"][0]["loss"])

    # 7g. the hybrid path; 7h. the same model over (data, model), on
    # 7c's plan
    out.update(hybrid_train_phase(hybrid, plan))
    out.update(hybrid_tp_train_phase(
        hybrid_tp_runs, tp_plan,
        hybrid["hybrid_cxl_fused"]["steps"][0]["loss"]))
    hybrid_tp = out["hybrid_tp"]
    # 7j. the pipeline over (stage, data), in 7c's spawn
    out["pp_ckpt"] = check_ckpt_restores(pp["pp_cxl"],
                                         get_config("llama3.2-1b"), 1, "pp")
    out["pp_auto_choices"] = check_pp_runs(pp, first, pp_plan)
    out["pp"] = pp
    log("[train] step times (s): " + json.dumps(
        {k: [round(s["step_s"], 3) for s in r["steps"]]
         for k, r in {**runs, **hier, **tp, **ragged, **moe,
                      **hybrid, **hybrid_tp, **audio, **vlm,
                      **pp}.items()}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.kernels import build
    from repro_torch.kernels import chunked_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_collectives as fc
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import train
    from repro_torch.models import model, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record: dict = {"device": torch.cuda.get_device_name(0),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    log(f"device {record['device']}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    walls: dict = {}
    t_mark = [time.perf_counter()]

    def mark(phase: str) -> None:
        """Record the wall seconds of ``phase`` (since the last mark)."""
        now = time.perf_counter()
        walls[phase] = now - t_mark[0]
        t_mark[0] = now
        log(f"[wall] {phase} {walls[phase]:.1f}s")

    # 1. build ---------------------------------------------------------
    # chunked_reduce first: 7l, whose ranks launch only it, runs beside
    # the rest of the build and phase 2 (its two small spawns are mostly
    # rank start-up; phase 2 only checks values), and is joined after it
    from concurrent.futures import ThreadPoolExecutor
    record["build_s"] = build.build_all(("chunked_reduce",))
    side = ThreadPoolExecutor(1)
    survivor = side.submit(survivor_phase)
    record["build_s"] += build.build_all()
    log(f"[build] {build.KERNELS} in {record['build_s']:.1f}s")
    mark("build")

    # 2. parity --------------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    parity = []
    for dtype in (torch.float32, torch.bfloat16):
        for t, d in RMS_SHAPES:
            x, s = randn(t, d, dtype=dtype), randn(d)
            err, ok = close(rn.rms_norm(x, s), rn.rms_norm_plain(x, s),
                            *TOL["rms_norm"][dtype])
            parity.append({"kernel": "rms_norm", "shape": [t, d],
                           "dtype": str(dtype), "max_abs_err": err,
                           "ok": ok})
        for b, lq, lk, h, window, q_off in (
                (1, 1024, 1024, 32, None, 0), (1, 1000, 1000, 32, None, 0),
                (1, 1024, 1024, 32, 256, 0), (1, 512, 1024, 32, None, 512),
                (FA_TP_SHAPE[0], PROMPT, PROMPT, FA_TP_SHAPE[2], None,
                 0),
                (FA_MOE_SHAPE[0], PROMPT, PROMPT, FA_MOE_SHAPE[2], None,
                 0)):
            q = randn(b, lq, h, 64, dtype=dtype)
            k, v = (randn(b, lk, h, 64, dtype=dtype) for _ in range(2))
            err, ok = close(fa.flash_attention(q, k, v, True, window,
                                               q_off),
                            fa.flash_attention_plain(q, k, v, True, window,
                                                     q_off),
                            *TOL["flash_attention"][dtype])
            parity.append({"kernel": "flash_attention",
                           "shape": [b, lq, lk, h, 64], "window": window,
                           "q_offset": q_off, "dtype": str(dtype),
                           "max_abs_err": err, "ok": ok})
        # the non-text models' shapes: non-causal lq = lk = 1500 and
        # lq != lk, head_dim 96
        for key, (b, lq, lk, h, d, causal) in FA_FRONTEND.items():
            q = randn(b, lq, h, d, dtype=dtype)
            k, v = (randn(b, lk, h, d, dtype=dtype) for _ in range(2))
            err, ok = close(fa.flash_attention(q, k, v, causal),
                            fa.flash_attention_plain(q, k, v, causal),
                            *TOL["flash_attention"][dtype])
            parity.append({"kernel": "flash_attention", "path": key,
                           "shape": [b, lq, lk, h, d], "causal": causal,
                           "dtype": str(dtype), "max_abs_err": err,
                           "ok": ok})
        del q, k, v
    # the training slice: one rank's segment of a row's FSDP grad bucket
    cfg = get_config("llama3.2-1b")
    rs_len = sum(x[0].numel() for x in tree.leaves(
        model.abstract_params(cfg)["g0"])
        if x[0].numel() >= sharding.FSDP_MIN_SIZE) // DP
    hybrid_rs = hybrid_reduce_shapes()
    hybrid_tp_rs = hybrid_tp_reduce_shapes()
    pp_rs = pp_reduce_shapes()
    frontend_rs = {arch: frontend_reduce_shapes(arch)
                   for arch in (AUDIO_ARCH, VLM_ARCH)}
    for dtype in (torch.float32, torch.bfloat16):
        shapes = [(n, ln) for n in (2, 4, 16) for ln in (rs_len, RAGGED)]
        shapes += [s for s in hier_reduce_shapes(rs_len) + tp_reduce_shapes(
            rs_len) + ragged_reduce_shapes(rs_len) + hybrid_rs +
            hybrid_tp_rs + moe_reduce_shapes() + pp_rs + sum(
                frontend_rs.values(), ()) if s not in shapes]
        for n_src, length in shapes:
            x = randn(n_src, length, dtype=dtype)
            err, ok = close(cr.chunked_reduce(x),
                            cr.chunked_reduce_plain(x),
                            *TOL["chunked_reduce"][dtype])
            parity.append({"kernel": "chunked_reduce",
                           "shape": [n_src, length],
                           "dtype": str(dtype), "max_abs_err": err,
                           "tolerance": TOL["chunked_reduce"][dtype],
                           "ok": ok})
    # the non-text models' reduce shapes, f32: the kernel sums the
    # sources in the plain version's order, so the two agree bitwise
    for n_src, length in sum(frontend_rs.values(), ()):
        x = randn(n_src, length)
        y, want = cr.chunked_reduce(x), cr.chunked_reduce_plain(x)
        parity.append({"kernel": "chunked_reduce", "check": "bitwise",
                       "shape": [n_src, length],
                       "dtype": str(torch.float32),
                       "max_abs_err": float((y - want).abs().max()),
                       "ok": bool(torch.equal(y, want))})
    del y, want
    for t, n, ks, nout in AGM_SHAPES + AGM_TP_SHAPES + AGM_MOE_SHAPES + \
            AGM_AUDIO_SHAPES + AGM_VLM_SHAPES:
        x, w = randn(t, n * ks), randn(n, ks, nout)
        err, ok = close(fc.all_gather_matmul(x, w),
                        fc.all_gather_matmul_plain(x, w), *gemm_tol(n * ks))
        parity.append({"kernel": "all_gather_matmul",
                       "shape": [t, n, ks, nout], "dtype": str(torch.float32),
                       "max_abs_err": err, "tolerance": gemm_tol(n * ks),
                       "ok": ok})
    parity += repeat_parity(randn, fa, fc)
    parity += grad_parity(randn, rn, fa, fc)
    parity += ssm_parity(randn, ss)
    parity += ssm_grad_parity(randn, ss)
    parity += rs_parity(randn, rand, fc, rs_len)
    del x, w
    torch.cuda.synchronize()
    record["parity"] = parity
    for p in parity:
        log(f"[parity] {json.dumps(p)}")
    if not all(p["ok"] for p in parity):
        fail("a kernel disagrees with its plain version")
    mark("parity")
    # 7l. the 4 -> 3 survivor reconfiguration (its wall seconds beside
    # phase 2 in its record; the wait for it here in "survivor")
    record["survivor"] = survivor.result()
    side.shutdown()
    mark("survivor")

    # 3. timing (main path shapes, f32) ---------------------------------
    timer = Timer()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rms = rms_timing(timer, randn, rn, sms)
    main = f"{PROMPT}x2048"
    timing = {
        "rms_norm": dict(rms["forward"][main], shapes=rms["forward"],
                         backward=rms["backward"],
                         backward_moe=rms["backward_moe"],
                         backward_hybrid=rms["backward_hybrid"],
                         backward_tp=rms["backward_tp"],
                         backward_audio=rms["backward_audio"],
                         backward_vlm=rms["backward_vlm"],
                         backward_train_lm=rms["backward_train_lm"]),
        "flash_attention": flash_timing(timer, randn, fa, 1, PROMPT, PROMPT,
                                        32, 64, True),
    }
    timing["chunked_reduce"] = reduce_timing(timer, randn, cr, DP, rs_len)
    # the (pod, data) path's shapes: each level reduces 2 sources
    reduce_hier = {f"{n}x{length}": reduce_timing(timer, randn, cr, n,
                                                    length)
                   for n, length in hier_reduce_shapes(rs_len)}
    timing["chunked_reduce"]["hier"] = reduce_hier
    # the (data, model) path's: the model level's activation AllReduce
    reduce_tp = {f"{n}x{length}": reduce_timing(timer, randn, cr, n, length)
                 for n, length in tp_reduce_shapes(rs_len)
                 if f"{n}x{length}" not in reduce_hier}
    timing["chunked_reduce"]["tp"] = reduce_tp
    # the grouped path's: the group of three and the two sub-roots
    reduce_ragged = {f"{n}x{length}": reduce_timing(timer, randn, cr, n,
                                                      length)
                     for n, length in ragged_reduce_shapes(rs_len)}
    timing["chunked_reduce"]["ragged"] = reduce_ragged
    # flash_attention at the (data, model) path's shape (a rank's 2
    # sequences, 16 heads) and the MoE path's (12 heads)
    for key, (b, lq, h, hd) in (("tp", FA_TP_SHAPE), ("moe", FA_MOE_SHAPE)):
        timing["flash_attention"][key] = flash_timing(timer, randn, fa, b,
                                                      lq, lq, h, hd, True)
    # chunked_reduce at the MoE path's shapes
    reduce_moe = {f"{n}x{length}": reduce_timing(timer, randn, cr, n,
                                                   length)
                  for n, length in moe_reduce_shapes()}
    timing["chunked_reduce"]["moe"] = reduce_moe
    # and at the hybrid path's: a Mamba-2 row's bucket, shared_a's, and
    # shared_a's two buckets under --fuse-kernels
    reduce_hybrid = {f"{n}x{length}": reduce_timing(timer, randn, cr, n,
                                                      length)
                     for n, length in hybrid_rs}
    timing["chunked_reduce"]["hybrid"] = reduce_hybrid
    # and at the hybrid path's at (data, model): the row's and the gated
    # norm's model-level AllReduces, the data level's reduce-scatters
    reduce_hybrid_tp = {f"{n}x{length}": reduce_timing(timer, randn, cr, n,
                                                         length)
                        for n, length in hybrid_tp_rs
                        if f"{n}x{length}" not in reduce_tp}
    timing["chunked_reduce"]["hybrid_tp"] = reduce_hybrid_tp
    # and at the pipeline path's: every leaf's AllReduce at N = 2 (a
    # stage's slab of each row leaf, the embedding, the norms, scalars)
    timing["chunked_reduce"]["pp"] = {
        f"{n}x{length}": reduce_timing(timer, randn, cr, n, length)
        for n, length in pp_rs}
    # and at the non-text models' (their row buckets, fused and not, and
    # the grad sync's buckets of the dp-replicated leaves)
    reduce_frontend = {f"{n}x{length}": reduce_timing(timer, randn, cr, n,
                                                        length)
                       for shapes in frontend_rs.values()
                       for n, length in shapes}
    timing["chunked_reduce"]["frontend"] = reduce_frontend
    # flash_attention at the non-text models' shapes
    fa_frontend = {key: flash_timing(timer, randn, fa, *shape)
                   for key, shape in FA_FRONTEND.items()
                   if key != "d96_ragged"}
    timing["flash_attention"].update(fa_frontend)
    agm = {}
    for t, n, ks, nout in AGM_SHAPES + AGM_TP_SHAPES + AGM_MOE_SHAPES + \
            AGM_AUDIO_SHAPES + AGM_VLM_SHAPES:
        xa, wa = randn(t, n * ks), randn(n, ks, nout)
        agm[f"{t}x{n * ks}@{n}x{ks}x{nout}"] = {
            "ms": timer(lambda: fc.all_gather_matmul(xa, wa)),
            "plain_ms": timer(lambda: fc.all_gather_matmul_plain(xa, wa)),
            "library_ms": timer(lambda: torch.matmul(
                xa, wa.reshape(n * ks, nout))),
            "bytes": (t * n * ks + n * ks * nout + t * nout) * 4,
            "flops": 2 * t * n * ks * nout, "shape": [t, n, ks, nout]}
    t, n, ks, nout = AGM_MAIN
    timing["all_gather_matmul"] = dict(agm[f"{t}x{n * ks}@{n}x{ks}x{nout}"])
    # ssm_scan as the SSM paths call it: Falcon-Mamba's and Zamba2's
    # prefill (1 x PROMPT, from zero) and decode step (SLOTS x 1, from the
    # cached state), both writing the final state, the training forward
    # (with checkpoints) and the backward; no single PyTorch call
    # computes it
    scan = ssm_timing(timer, randn, ss, sms)
    timing["ssm_scan"] = dict(scan["prefill"], **{
        k: v for k, v in scan.items() if k != "prefill"})
    timing.update(rs_timing(timer, randn, rand, fc, rs_len))
    for rec in list(agm.values()) + list(timing.values()) + [
            *(v for k, v in scan.items() if k != "prefill"),
            timing["reduce_scatter_adamw"]["bf16_param"],
            *rms["forward"].values(), rms["backward"],
            rms["backward_moe"], rms["backward_hybrid"], rms["backward_tp"],
            rms["backward_audio"], rms["backward_vlm"],
            rms["backward_train_lm"], *reduce_frontend.values(), *fa_frontend.values(),
            *reduce_hier.values(),
            *reduce_tp.values(), *reduce_ragged.values(),
            *reduce_moe.values(), *reduce_hybrid.values(),
            *reduce_hybrid_tp.values(),
            timing["flash_attention"]["tp"],
            timing["flash_attention"]["moe"]]:
        byte_ms = rec["bytes"] / HBM_BW * 1e3
        op_ms = max(rec["flops"] / PEAK[torch.float32],
                    rec.get("exps", 0) / EXP_RATE) * 1e3
        rec["bound_ms"] = max(byte_ms, op_ms)
        rec["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    for rec in list(agm.values()) + list(fa_frontend.values()) + [
            timing["all_gather_matmul"], timing["flash_attention"],
            timing["flash_attention"]["tp"],
            timing["flash_attention"]["moe"]]:
        rec["bound_tc_ms"] = max(rec["bytes"] / HBM_BW,
                                 3 * rec["flops"] / TF32_PEAK) * 1e3
    record["all_gather_matmul_shapes"] = agm
    for key, rec in agm.items():
        log(f"[timing] all_gather_matmul {key} {json.dumps(rec)}")
    del xa, wa
    for name, t in timing.items():
        log(f"[timing] {name} {json.dumps(t)}")
    record["timing"] = timing
    mark("timing")

    # 3b. the kernel API: the path of the two reduce_scatter kernels -----
    record["kernel_api"] = kernel_api_phase(randn, rand, rs_len)
    log(f"[kernel_api] {json.dumps(record['kernel_api'])}")
    if not record["kernel_api"]["ok"]:
        fail("the kernel API's reduce_scatter kernels disagree with their "
             "plain versions")
    torch.cuda.empty_cache()
    mark("kernel_api")

    # 4. reference: smoke models on the card vs on the CPU ---------------
    record["reference"] = {}
    for arch, length in (("llama3.2-1b", 1100), (SSM_ARCH, 300),
                         (HYBRID_ARCH, 300), (AUDIO_ARCH, 1100),
                         (VLM_ARCH, 1100)):
        err, ok = card_vs_cpu(arch, length, dev)
        record["reference"][arch] = {"prefill_len": length,
                                     "max_abs_err": err}
        log(f"[reference] {arch} smoke prefill L={length} + 3 decode "
            f"steps, card vs CPU: max abs err {err:.3e} (rtol 2e-4, "
            f"atol 2e-5)")
        if not ok:
            fail(f"{arch} smoke model on the card differs from the CPU: "
                 f"max abs error {err}")
    mark("reference")

    # 5. full-width serve: Llama-3.2-1B, then Falcon-Mamba-7B -------------
    launches: dict = {}
    OUT_DIR.mkdir(exist_ok=True)
    record["serve"] = serve_phase("llama3.2-1b", "serve", dev, launches,
                                  obs_base=str(OUT_DIR / "serve_llama"))
    record["serve_ssm"] = serve_phase(SSM_ARCH, "serve_ssm", dev, launches)
    record["serve_hybrid"] = serve_phase(HYBRID_ARCH, "serve_hybrid", dev,
                                         launches)
    record["serve_audio"] = serve_phase(AUDIO_ARCH, "serve_audio", dev,
                                        launches)
    record["serve_vlm"] = serve_phase(VLM_ARCH, "serve_vlm", dev, launches)
    record["launches"] = launches
    mark("serve")

    # 6. collectives on one card: the flat table and the tuple
    # primitives over (pod, data) = (2, DP/2), beside the flat axis of all
    # DP ranks, from one spawn of the ranks ------------------------------
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import collectives
    t0 = time.perf_counter()
    rows, tuple_rows = collectives.bench_all(
        DP, (1, 16, 256), TUPLE_SIZES_MB, reps=3, device="cuda",
        ring_max_mb=RING_MAX_MB, topology=parse_topology(HIER_TOPOLOGY))
    for r in rows:
        log(f"[collectives] {json.dumps(r)}")
    record["collectives"] = rows
    for r in tuple_rows:
        log(f"[collectives tuple] {json.dumps(r)}")
    record["collectives_tuple"] = tuple_rows
    log(f"[collectives] {len(rows)} flat and {len(tuple_rows)} tuple cells "
        f"in {time.perf_counter() - t0:.1f}s, one spawn of the ranks")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"collectives disagree with the numpy oracle: {bad}")
    bad = [r for r in tuple_rows
           if not (r["ok"] and r.get("equal_flat", True))]
    if bad:
        fail(f"tuple collectives disagree with the oracle or the flat "
             f"axis: {bad}")
    mark("collectives")

    # 8a. the train_lm example at one rank (its initial params start 8b,
    # which rides phase 7's (data, model) spawn) ------------------------
    del timer
    torch.cuda.empty_cache()
    record["train_lm"] = train_lm_phase()
    mark("examples_train_lm")

    # 7. training ---------------------------------------------------------
    # the rank processes, spawned from here on, map their memory in
    # expandable segments: four ranks of 16 GiB (7j's) leave no room for
    # the fragments a fixed-segment allocator keeps
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    log(f"[train] this process holds {torch.cuda.memory_reserved() / 2**30:.2f}"
        f" GiB of the card before the ranks start")
    record["train"] = train_phase(record["train_lm"]["init_path"])
    # 8b. train_lm over (data, model) = (2, 2), against 8a
    tp_run = record["train"].pop("train_lm_tp_run")
    record["train_lm_tp"] = check_train_lm_tp(tp_run, record["train_lm"])
    train_lm_tp_launches = {
        n: sum(s["launches"][n] for s in tp_run["steps"])
        for n in ("rms_norm", "rms_norm_vjp", "chunked_reduce")}
    record["train_lm_tp"]["launches"] = train_lm_tp_launches
    record["train"]["audio_runs"] = record["train"]["audio"].pop("runs")
    record["train"]["vlm_runs"] = record["train"]["vlm"].pop("runs")
    (train_launches, hier_launches, tp_launches, ragged_launches,
     moe_launches, hybrid_launches, hybrid_tp_launches, audio_launches,
     vlm_launches, pp_launches) = (
        {n: sum(s["launches"][n] for run in record["train"][key].values()
                for s in run["steps"])
         for n in names}
        for key, names in (("full_width", LLAMA_TRAIN_KERNELS),
                           ("hier", LLAMA_TRAIN_KERNELS),
                           ("tp", LLAMA_TRAIN_KERNELS),
                           ("ragged", LLAMA_TRAIN_KERNELS),
                           ("moe", LLAMA_TRAIN_KERNELS),
                           ("hybrid", HYBRID_KERNELS + (
                               "chunked_reduce", "all_gather_matmul")),
                           ("hybrid_tp", HYBRID_KERNELS + (
                               "chunked_reduce", "all_gather_matmul")),
                           ("audio_runs", LLAMA_TRAIN_KERNELS),
                           ("vlm_runs", LLAMA_TRAIN_KERNELS),
                           ("pp", ("rms_norm", "rms_norm_vjp",
                                   "flash_attention", "chunked_reduce"))))
    record["train"]["launches"] = train_launches
    record["train"]["hier_launches"] = hier_launches
    record["train"]["tp_launches"] = tp_launches
    record["train"]["ragged_launches"] = ragged_launches
    record["train"]["moe_launches"] = moe_launches
    record["train"]["hybrid_launches"] = hybrid_launches
    record["train"]["hybrid_tp_launches"] = hybrid_tp_launches
    record["train"]["audio_launches"] = audio_launches
    record["train"]["vlm_launches"] = vlm_launches
    record["train"]["pp_launches"] = pp_launches
    mark("train")

    # 7f. serve Granite-3.0-MoE at full width through the launcher --------
    record["serve_moe"] = moe_serve(launches)
    mark("serve_moe")

    # 8d, 8e. the serve_lm and autotune_workflow examples ----------------
    record["examples"] = examples_phase()
    mark("examples")

    # 8. launch check ----------------------------------------------------
    serve_launches = {path: {n: sum(run[n] for run in launches[path]
                                    .values()) for n in names}
                      for path, names in SERVE_KERNELS.items()}
    for path, counts in serve_launches.items():
        for name, n in counts.items():
            if n <= 0:
                fail(f"the {path} path never launched the {name} kernel")
    for name, n in train_launches.items():
        if n <= 0:
            fail(f"the training path never launched the {name} kernel")
    for name, n in hier_launches.items():
        if n <= 0:
            fail(f"the (pod, data) training path never launched the "
                 f"{name} kernel")
    for name, n in tp_launches.items():
        if n <= 0:
            fail(f"the (data, model) training path never launched the "
                 f"{name} kernel")
    for name, n in ragged_launches.items():
        if n <= 0:
            fail(f"the grouped training path never launched the {name} "
                 f"kernel")
    for name, n in moe_launches.items():
        if n <= 0:
            fail(f"the MoE training path never launched the {name} kernel")
    for name, n in hybrid_launches.items():
        if n <= 0:
            fail(f"the hybrid training path never launched the {name} "
                 f"kernel")
    for name, n in hybrid_tp_launches.items():
        if n <= 0:
            fail(f"the hybrid (data, model) training path never launched "
                 f"the {name} kernel")
    for path, counts in (("whisper-tiny", audio_launches),
                         ("Phi-3-vision", vlm_launches),
                         ("pipeline", pp_launches)):
        for name, n in counts.items():
            if n <= 0:
                fail(f"the {path} training path never launched the {name} "
                     f"kernel")
    api_launches = record["kernel_api"]["launches"]
    for name in API_KERNELS:
        if api_launches[name] <= 0:
            fail(f"the kernel API path never launched the {name} kernel")
    # phase 8: the examples' paths, each counted around its own run
    example_launches = {
        "example_train_lm": record["train_lm"]["launches"],
        "example_train_lm_tp": train_lm_tp_launches,
        "example_quickstart": {"chunked_reduce": sum(
            b.get(DP, 0) for b in record["train"]["quickstart"][
                "chunked_reduce_by_n_per_rank"])},
        "example_serve_lm": record["examples"]["serve_lm"]["launches"],
        "example_serve_lm_ssm":
            record["examples"]["serve_lm_ssm"]["launches"],
        "example_autotune": record["examples"]["autotune"]["launches"]}
    for path, names in (("example_train_lm", ("rms_norm", "rms_norm_vjp")),
                        ("example_train_lm_tp", ("rms_norm", "rms_norm_vjp",
                                                 "chunked_reduce")),
                        ("example_quickstart", ("chunked_reduce",)),
                        ("example_serve_lm", ("rms_norm",)),
                        ("example_serve_lm_ssm", ("rms_norm", "ssm_scan")),
                        ("example_autotune", ("rms_norm",))):
        for name in names:
            if example_launches[path][name] <= 0:
                fail(f"the {path} path never launched the {name} kernel")

    # 9. output lines ----------------------------------------------------
    decode_tp = record["train"]["decode_tp"]
    kernels = []
    for name in KERNELS:
        t = timing[name]
        main = [p for p in parity if p["kernel"] == name
                and p["dtype"] == str(torch.float32) and "check" not in p]
        by_path = {path: counts[name]
                   for path, counts in serve_launches.items()
                   if name in counts}
        if name in train_launches:
            by_path["train"] = train_launches[name]
            by_path["train_hier"] = hier_launches[name]
            by_path["train_tp"] = tp_launches[name]
            by_path["train_ragged"] = ragged_launches[name]
            by_path["train_moe"] = moe_launches[name]
            by_path["train_audio"] = audio_launches[name]
            by_path["train_vlm"] = vlm_launches[name]
        if name in pp_launches:
            by_path["train_pp"] = pp_launches[name]
        if name == "chunked_reduce":
            by_path["train_survivor"] = record["survivor"]["launches"]
        if name in hybrid_launches:
            by_path["train_hybrid"] = hybrid_launches[name]
            by_path["train_hybrid_tp"] = hybrid_tp_launches[name]
        extra = {}
        if name == "rms_norm":
            extra = {"backward_launches_by_path": {
                "train": train_launches["rms_norm_vjp"],
                "train_hier": hier_launches["rms_norm_vjp"],
                "train_tp": tp_launches["rms_norm_vjp"],
                "train_ragged": ragged_launches["rms_norm_vjp"],
                "train_moe": moe_launches["rms_norm_vjp"],
                "train_hybrid": hybrid_launches["rms_norm_vjp"],
                "train_hybrid_tp": hybrid_tp_launches["rms_norm_vjp"],
                "train_audio": audio_launches["rms_norm_vjp"],
                "train_vlm": vlm_launches["rms_norm_vjp"],
                "train_pp": pp_launches["rms_norm_vjp"],
                "example_train_lm": example_launches["example_train_lm"][
                    "rms_norm_vjp"],
                "example_train_lm_tp": train_lm_tp_launches[
                    "rms_norm_vjp"]},
                # the non-text models' widths
                **{k: {f: t["shapes"][k][f] for f in (
                    "ms", "plain_ms", "library_ms", "copy_ms", "bound_ms",
                    "bound_by", "geometry")}
                   for k in (f"{RMS_AUDIO[0]}x{RMS_AUDIO[1]}",
                             f"{RMS_VLM[0]}x{RMS_VLM[1]}",
                             f"{RMS_TRAIN_LM[0]}x{RMS_TRAIN_LM[1]}",
                             f"{RMS_TRAIN_LM_TP[0]}x{RMS_TRAIN_LM_TP[1]}")},
                **{k: {f: t[k][f] for f in (
                    "ms", "plain_ms", "library_ms", "copy_ms", "bound_ms",
                    "bound_by", "geometry")}
                   for k in ("backward_audio", "backward_vlm",
                             "backward_train_lm")}}
        if name == "flash_attention":
            # the non-text models' shapes, each measured in this run
            extra = {k: {f: t[k][f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_tc_ms", "shape", "causal")} for k in fa_frontend}
        if name == "all_gather_matmul":
            extra = {"frontend_shapes": {
                f"{t_}x{n * ks}@{n}x{ks}x{nout}": {
                    f: agm[f"{t_}x{n * ks}@{n}x{ks}x{nout}"][f] for f in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "bound_tc_ms")}
                for t_, n, ks, nout in AGM_AUDIO_SHAPES + AGM_VLM_SHAPES}}
        if name == "ssm_scan":
            # the N = 64 forward and the backward kernel at the hybrid
            # path's shapes, each measured in this run beside its bound
            keys = ("ms", "plain_ms", "copy_ms", "bound_ms", "bound_by",
                    "bound_ssd_ms", "library_ms", "shape")
            extra = {"backward_launches_by_path": {
                "train_hybrid": hybrid_launches["ssm_scan_vjp"],
                "train_hybrid_tp": hybrid_tp_launches["ssm_scan_vjp"]},
                **{k: {f: t[k][f] for f in keys if f in t[k]}
                   for k in ("n64_prefill", "n64_decode",
                             "n64_train_forward", "backward",
                             "n64_backward", "n64_heads_backward",
                             "n64_heads_backward_l4096",
                             "tp_heads_forward", "tp_heads_backward",
                             "tp_backward")}}
        if name in api_launches:
            by_path["kernel_api"] = api_launches[name]
        for path, counts in example_launches.items():
            if counts.get(name, 0) > 0:
                by_path[path] = counts[name]
        if name in decode_tp["launches_a_rank"]:
            # every rank launched exactly these (check_decode_tp)
            by_path["serve_tp"] = TP_DP * TP_TP * \
                decode_tp["launches_a_rank"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(p["max_abs_err"] for p in main),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_tc_ms": t.get("bound_tc_ms"),
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": "float32", **extra})
    record["kernels"] = kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    record["nvidia_smi"] = smi
    record["phase_walls_s"] = walls
    log(f"[wall] phases {json.dumps(walls)}, total "
        f"{sum(walls.values()):.1f}s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
