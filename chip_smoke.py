#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: the card's name and power limit, and the five kernel
   sources and K5's L2 probe built at once with ``nvcc`` for ``sm_90a`` from the checkout, with
   the shared headers of ``kernels/csrc`` (``fused_lp/csrc/folded_lp.cu``:
   K1 the folded exact LP step, K2 ``P @ Y``, K3 the per-batch-recompute
   step; ``pairwise/csrc/pairwise.cu``: K4; the four on Hopper's tensor
   cores as 3xTF32, ``kernels/csrc/tf32x3.cuh``;
   ``grf/csrc/grf_feature.cu``: K5 the GRF walker-mean feature product;
   ``flash_attention/csrc/flash_attention_tf32x3.cu``: K6's float32 route,
   3xTF32 on the tensor cores; ``flash_attention/csrc/flash_attention_sm90.cu``:
   K6's bfloat16 route on the tensor cores; and ``tools/l2_gather_probe.cu``,
   K5's L2 yardstick, no kernel of the port), with their ``-Xptxas -v``
   lines;
2. K1 against its plain-torch version on the card at small shapes: one
   step, a 5-step scan, a ``row_base`` stripe, and resume-from-carry equal to
   the monolithic scan bit for bit; K5 likewise, and a K = 16 column's bits
   equal to a K = 2 call's;
2a. K1 on each divergence route (the ``kl`` and ``itakura_saito`` tiles,
   and the squared-Euclidean tile on points mapped by a 315-long Mahalanobis
   scale) against its plain version at small odd shapes and a ``row_base``
   stripe;
2b. the precision gate, which tells 3xTF32 from one TF32 product: on dense
   Gaussian points (numpy seed, d = 315) K4 at its timing shape, 2,048 x
   83,679, and K1 at N = 16,384 with K = 2 and K = 16 (logits spanning
   about 37 units across a row) against a float64 run of the same function
   (for K1 the plain recurrence in float64): the kernel's max and RMS errors
   must each be at most 2 x the plain float32 version's on the same inputs.
   The SecStr-like data of the main path has 0/1 features, so its distances
   are integers, exact in any order and in one TF32 product: the checks on it
   cannot see a precision loss; the same gate per divergence route on
   positive points (|N(0,1)| + 0.1, d = 315, N = 16,384, K = 2 and 16,
   logits spanning 37 units a row), then K1's time on every tile in turns;
3. the main path, at the scale of the paper's SecStr benchmark
   (``secstr_like(83_679, 315, seed=3)``, ``|B| = 4N``): ``fit`` on the card,
   VDT label propagation (one request and a batch of 8 with per-request
   alpha), and the exact backend through K1 for 10 iterations each;
4. checks after the main path: VDT results against the same calls on a CPU
   copy of the fitted model, the exact backend's first 2 iterations against
   the plain version on the card, and K1's time per launch beside its bound;
5. the GRF path at the same scale: the paper's k = 4 kNN graph
   (``core.baselines.build_knn_graph``) built on the card and walked by
   ``grf_label_propagate`` for 50 iterations with 64 and 400 walkers a point
   (5.36 M and 33.5 M walkers), one request and a batch of 8, every step
   through K5; held to the deterministic kNN walk, batched == solo and
   repeat == first bit for bit; then K5's time at those shapes, beside its
   plain version and ``embedding_bag`` in turns, and the rate at which it
   moves y's 32-byte sectors from L2 beside the L2's own rate for random
   sectors (``tools/l2_gather_probe.cu`` on arrays of y's sizes, the
   ``[L2 yardstick]`` line);
6. the VDT entry point ``label_propagate(backend="grf")`` at validation size
   (``secstr_like(4_096, 315)``, dense ``grf_graph`` bridge) against
   ``backend="exact"``;
6b. the label-propagation serving engine (``repro_torch.serving``) over the
   fitted SecStr model of phase 3: (a) 6 requests of widths 1-3 coalesced
   into one dispatch, equal to a direct batched ``label_propagate`` on the
   engine's padded stack (bit for bit through K1; for ``vdt`` bit for bit
   only if two direct calls on the card agree, as ``index_add_`` reduces with
   atomics) and within rtol=1e-4, atol=1e-5 of each request's solo call;
   (b) under ``edf`` with ``segment_iters=5``, an urgent request injected at
   the first segment boundary of a 50-iteration exact walk is served before
   the walk ends, and the walk equals the monolithic scan bit for bit; (c)
   the reference's ``benchmarks/serving.py`` ``uniform`` scenario at full
   scale (96 requests, widths 1-8, 50 iterations, vdt): requests/s against
   the serial loop of direct calls, occupancy, p50/p95 and the dispatches'
   device time (CUDA events) over wall time, at 1, 4 and 16 closed-loop
   clients; (d) 8 requests of width 8 through the exact engine, folded
   K = 64, ms per iteration beside K1's K = 16 time; (e) a grf group on the
   model of phase 6 runs at its largest walker budget and equals a direct
   call bit for bit; (f) the phase's K1 and K5 launches, every K1 on
   ``tf32x3``;
6c. ``[streaming]`` on the fitted model of phase 3: 4,096 points
   (``secstr_like`` seed 7) inserted into its 47,393 free leaf slots, then
   4,096 rows deleted, each timed by stage (mirror build, host patch,
   host->device freeze, ``optimize_q_from_g``) and held to ``recompute`` on
   the card (the reference harness's limits) and to the same mutation of a
   CPU copy (update and tree bit for bit, q-state and LP at rtol=1e-4,
   atol=1e-5); exact LP on the streamed epoch through K1 against plain; the
   epoch published into a running engine while its first dispatch is in
   flight (the queued answers equal an engine's that never saw it, bit for
   bit through K1, within tolerance on vdt); then ``refine`` by 1 % of the
   blocks, every block it refined a stale one;
6d. ``[sharded engine]``: ``ShardedPropagateEngine`` over the fitted model of
   phase 3 with D = 1, 2, 4 and 8 shards, all on ``cuda:0`` (the
   decomposition runs for real; it is not a speed-up), against
   ``PropagateEngine``: (a) 6 requests of widths 1-3, 10 exact iterations,
   bit for bit; (b) the same on ``vdt`` with 50 iterations, within
   rtol=1e-4, atol=1e-5 (``index_add_`` reduces with atomics); (c) under
   ``edf`` with ``segment_iters=5`` a 50-iteration exact walk, bit for bit
   the monolithic one; (d) the streamed epoch of phase 6c published into an
   8-shard engine with exact work of the old epoch queued: both epochs'
   answers bit for bit, the old shard buffers dropped; (e) every stripe
   launch's rows (``row_base`` = the stripe's offset) equal to the same rows
   of one whole-grid K1 launch, bit for bit; (f) D K1 launches an
   iteration, every one on ``tf32x3``; (g) ms per exact and per VDT
   iteration at each D beside the single engine's, and one split pass of
   the columns (a stripe launch runs one, so D an iteration);
7. the reference's remaining op entry points, each at its shape: K2
   (``fused_lp_matvec``, N = 83,679), K3 (``fused_lp_step_batched(
   reuse=False)``, B = 8, N = 16,384), K4 (``pairwise_sq_dists``, one kNN
   block 2,048 x 83,679), against their plain versions and timed, K4 beside
   ``torch.cdist`` (yardstick only); and one point (N = 1, every column
   masked) through K1, K2 and K3;
7b. ``[divergences]``: a ``kl`` fit at SecStr scale on x + 0.1 (|B| = 4N)
   with VDT LP and 50 exact iterations through K1's kl tile; ``itakura_saito``
   and the Mahalanobis scale fitted at N = 16,384 (``secstr_like`` seed 5,
   + 0.1) with 10 exact iterations each; then each route's first 2 exact
   iterations against the plain version, the kl model's VDT LP against a
   CPU copy, K1's time at each route's shape in turns with the
   squared-Euclidean tile on the same points, and K2 and K3 on each route
   at their [ops] shapes, once each, against plain;
8. K6 (flash attention) against its plain version at small shapes, both
   routes (float32: the 3xTF32 kernel, route ``sm90_tf32x3``; bfloat16: the
   bf16 kernel, ``sm90_bf16``), each launch counted on its route: head widths
   64, 128 and 256, GQA groups 1, 3 and 4, causal with and without a window,
   ragged S and bidirectional; two launches equal bit for bit;
9. the dense LM serving path at the full width of smollm-360m
   (``repro/configs/smollm_360m.py``: 32 layers, d_model 960, 15/5 heads of
   64, d_ff 2,560, vocab 49,152, bfloat16; seeded random weights): 4
   requests of 2,048 prompt tokens through ``prefill`` (K6's bfloat16
   route in every layer, no float32 launch), then 16 greedy
   ``decode_step``s;
   decode logits held to ``lm_forward`` on S + 1 tokens at position S
   (``0.15``, the reference's own tolerance); K6's share of the prefill's
   device time;
10. the same model in float32, one prefill through K6 (its 3xTF32 route in
   every layer) and one through K6's plain version, last-position logits at
   ``rtol=atol=2e-3``;
11. K6 timed at smollm's attention shape (B = 4, 15/5 heads, S = 2,048,
   D = 64, causal) and at gemma3-1b's local layer (4/1 heads, D = 256,
   window 1,024), each route at its type, beside its plain version, its
   bound and ``scaled_dot_product_attention`` as the library yardstick, in
   turns;
12. K6's precision gate, which tells its float32 route's 3xTF32 from one
   TF32 product: Gaussian q, k, v (numpy seed) at both timed shapes, the
   kernel's max and RMS errors against the plain recurrence in float64 at
   most 2 x the plain float32 version's;
13. ``[lm serve moe]``: deepseek-moe-16b (``repro/configs/deepseek_moe_16b.py``)
   at full width (d_model 2,048, 16/16 heads of 128, 64 routed experts of
   1,408 plus 2 shared, top-6, vocab 102,400), its depth cut from 28 layers
   to 16 (9.8 B parameters, 39.3 GB in float32), bfloat16 compute, seeded
   weights: 4 x 2,048-token prompts through ``prefill`` (K6's bfloat16 route
   in every layer, no other launch of K6), 16 greedy ``decode_step``s, the
   assignments each drops past its expert capacity; layer 0's MoE on 256
   tokens of the prefill's hidden states in float32 on the card against a
   CPU copy of its parameters (the same experts, ``2e-3``) and against the
   layer written expert by expert (``chip_smoke.py::moe_loop_plain``: no
   slot table, gather or scatter); decode at position S = 512 against
   ``lm_forward`` on S + 1 tokens with the capacity factor raised to E / k,
   so that nothing drops in either (a decode step routes its 4 tokens among
   themselves, capacity 1, the forward 2,052, so at the served capacity
   they drop different assignments by design), on the requests routed to
   the same experts in every layer (all 4 in float32 at ``2e-3``; bfloat16
   at ``0.15``); the profile by group with the MoE dispatch kernels apart;
   then K6 timed at deepseek's attention shape (B = 4, 16/16 heads,
   S = 2,048, D = 128, causal) as in phase 11;
14. ``[lm serve ssm]``, ``[lm serve hybrid]``, ``[lm serve vlm]``: mamba2-130m
   (``repro/configs/mamba2_130m.py``: 24 Mamba2 layers, d_model 768, SSM
   state 128, attention-free), zamba2-1.2b (``zamba2_1_2b.py``: 38 Mamba2
   layers, d_model 2,048, 64 SSM heads, one shared attention block of 32/32
   heads of 64 applied after every 6th layer, window 4,096) and
   internvl2-1b (``internvl2_1b.py``: 24 layers, 14/2 heads of 64, vocab
   151,655), each at full width and depth, bfloat16 compute, seeded weights,
   one after the other (each freed before the next loads): 4 x 2,048-token
   prompts (internvl2-1b after 256 seeded patch embeddings) through
   ``prefill``, K6 launched 0 / 6 / 24 times, all on ``sm90_bf16``; 16 greedy
   ``decode_step``s; the profile by group (an SSD group: the kernels within
   ``ssd_chunked``); then in float32 on the card at ``2e-3``: decode
   against ``lm_forward`` one position further (mamba2-130m and zamba2-1.2b
   after 255 tokens, one SSD chunk of 255 against the forward's one of 256,
   zamba2-1.2b with its window set to 255 so that its ring holds exactly one
   window: the reference's ring keeps min(S, window) slots and a shorter
   prompt loses token 0 at the first decode step; internvl2-1b after 256 +
   512 positions), the served prefill through K6 (``sm90_tf32x3`` at every
   attention point) against K6's plain version, and zamba2-1.2b's SSM layer
   0 on 512 tokens against a CPU copy;
15. K6 timed at zamba2-1.2b's attention (B = 4, 32/32 heads, S = 2,048,
   D = 64, causal; its window is longer than S) and internvl2-1b's (14/2
   heads, S = 2,304) as in phase 11.
16. ``[lm serve audio]``: whisper-medium (``repro/configs/whisper_medium.py``:
   24 encoder layers over 1,500 frames, 24 decoder layers, d_model 1,024,
   16/16 heads of 64, d_ff 4,096, vocab 51,865) at full width and depth,
   bfloat16 compute, seeded weights: 4 requests of 1,500 seeded frame
   embeddings (the stub frontend) and 432-token prompts through ``prefill``
   (K6's bf16 route 48 times: 24 bidirectional encoder layers over 1,500
   keys, not a multiple of its 64-key tile, and 24 causal decoder layers),
   16 greedy ``decode_step``s (432 + 16 = 448, whisper's text context), the
   profile by group; then in float32 on the card at ``2e-3``: the prefill
   through K6 (``sm90_tf32x3`` 48 times) against K6's plain version, decode
   at position S against ``decoder_forward`` on S + 1 tokens, and encoder
   layer 0 against a CPU copy; K6 timed at the encoder's shape (B = 4,
   16/16 heads, S = 1,500, D = 64, bidirectional) in both types as in phase
   11;
17. ``[K6 grad]``: K6 as an autograd Function (the kernel's forward, one
   counted launch; its backward float32 torch ops, no launch: the reference
   has no Pallas backward) against autograd through ``ref.py``'s dense
   float32 softmax at smollm's shape (S = 512), gemma3-1b local's (D = 256,
   window 1,024, S = 1,536) and the whisper encoder's (bidirectional,
   S = 1,500): dq, dk, dv at ``2e-4`` in float32 and ``1e-2`` in bfloat16
   (the gradients' own rounding), and the backward's time beside the
   forward's;
18. ``[train]``: smollm-360m at full width and depth, 4 ``make_train_step``
   steps of 4 x 2,048 tokens (bfloat16 compute, AdamW ``lr=1e-3,
   warmup_steps=1`` as ``tests/test_arch_smoke.py``; ``remat`` checkpoints
   each layer, so K6 runs twice a layer: 64 launches a step), each counted
   and timed, every loss and grad norm finite and the parameters changed,
   then one more under the profiler; two whisper-medium steps of 2 x
   (1,500 frames + 448 tokens) (96 launches each; the first cold), and one
   more profiled; K6's backward timed at both models' shapes; then smollm-360m in float32 at 2 x 256 tokens: the step on the
   card against the same step on a CPU copy, and 2 microbatches against
   the whole batch, loss, grad norm and updated parameters at ``2e-3``;
19. ``[train launcher]``: the training launcher (``launch/train.py``) at
   smollm-360m's full configuration and its own defaults (8 x 128 tokens,
   bfloat16 compute, remat: K6 64 launches a step, all ``sm90_bf16``), 8
   steps, a checkpoint every 4 (4.9 GB: parameters, ``mu``, ``nu`` in
   float32), under ``build/train_launcher`` (removed at the end): (a) an
   uninterrupted run in this process, each step timed; (b) the same
   command as a subprocess, SIGTERM after its step-2 line: it must print
   ``preemption requested``, checkpoint and exit 0; (c) the same command
   again: ``resumed from step k``, on to step 8; (d) its final checkpoint
   against (a)'s, bit for bit (if not, (a) again: two uninterrupted runs
   that agree put the fault on the resume; two that differ hold (d) at
   ``2e-3`` of each tensor's largest magnitude); (e) (a)'s checkpoint
   restored onto the CPU and onto the card, equal bit for bit, a
   synchronous and an async save timed; (f) one step's full-width gradients
   through ``compress_tree``: bf16 and int8 under replayed uniforms equal to
   a CPU copy bit for bit, int8 from the card's generator within one
   quantisation step, both timed; (g) the 32 layers as 4 stages of 8 on
   ``["cuda:0"] * 4`` (``distributed/pipeline.py``), 8 microbatches of 1 x
   512 tokens, K6 256 launches on ``sm90_bf16``, bit for bit the stages run
   one after another; (h) the launcher's SPMD path: the same flags under
   ``python -m torch.distributed.run --standalone --nproc-per-node 1``
   (loopback only; the rank is this script with ``--launcher-rank``, which
   runs ``launch/train.py``'s ``main`` with each step timed and K6 counted
   on the rank's own counters), one NCCL rank over a ``(1, 1)`` ``("data",
   "model")`` mesh, the state as DTensors: SIGTERM to the rank after its
   step-2 line, then restarted to step 8; every step K6 64 launches on
   ``sm90_bf16``; its step-8 checkpoint against (a)'s, bit for bit, else
   within ``2e-3`` of each tensor's largest magnitude, the differing leaves
   listed; (i) (h)'s step-4 checkpoint, written through the DTensor gather,
   resumed by the one-device launcher in this process to step 8, against
   (a)'s as (h)'s;
20. ``[dryrun]``: the dry-run tooling (``launch/dryrun.py``): (a) ``python -m
   repro_torch.launch.dryrun --all --force`` in a subprocess started before
   the LM phases (it needs no card, and runs beside them), every cell of
   10 architectures x 4 shapes on the single-pod mesh and the paper cell
   counted on ``meta`` tensors at full size (34 ok, 7 skipped, 0 errors);
   (b) meanwhile, each cell's count on meta at its card batch, and K6 held
   to its plain version (``[K6 timing]``) at the attention shapes of the
   cells that launch it, B = 1, S = 32,768 and B = 2, S = 4,096 (15/5
   heads, D = 64, causal); (c) once the grid has ended, so that no other
   work shares the host, on the card at a batch it holds, with seeded
   weights and inputs: smollm-360m ``prefill_32k`` at batch 1 (K6 32
   launches at S = 32,768), ``train_4k`` at batch 2 (remat, AdamW; K6 64), ``decode_32k``
   at batch 8 (one step against a cache of 32,768 + 16 slots), mamba2-130m
   ``long_500k`` at batch 1 (one token against its state), and the paper
   cell at full size (N = 2^18, C = 8, |B| = 4N: seeded block node ids and
   weights, not a fitted tree; held to a CPU copy at ``rtol=1e-4,
   atol=1e-5``): each step's work counted on the card (``count_work``)
   equal to its meta count at the same batch, flops and bytes; 5 warm steps
   timed with CUDA events (median), the one-card roofline
   (``launch/roofline.py``, H100 constants), measured / roofline, MFU, the
   device's busy share (device time of 5 profiled steps over 5 medians),
   peak memory.

21. ``[spmd]``: the LM as an SPMD program (``distributed/sharding.py``:
   parameters as DTensors under the reference's ``param_shardings``, inputs
   sharded by batch, ``shard_act`` at the reference's points, K6 through its
   DTensor sharding rule; the MoE dispatch and combine, the SSM conv, SSD
   and recurrence on shards through ``local_map``): (a) over a one-rank
   NCCL ``DeviceMesh`` ("data", "model"), each against the same call on
   plain tensors (f32 ``rtol=1e-5``, ``atol`` 1e-6 of the largest
   magnitude, at least 1, 1e-5 of it for the first moment; bf16 ``1e-2``;
   whether bit for bit is printed): smollm-360m at full width, a bfloat16
   prefill of 4 x 2,048 tokens (K6 32 launches on ``sm90_bf16``) and one
   float32 train step of 2 x 2,048 (remat; K6 64 on ``sm90_tf32x3``); then
   ``SPMD_FAMILIES`` at full width: deepseek-moe-16b at 16 of its 28 layers
   (experts over ``model``; K6 16 a prefill), mamba2-130m and zamba2-1.2b
   at full depth (K6 0 and 6), a bfloat16 prefill of 4 x 2,048 and
   ``SPMD_DECODE`` greedy decode steps (an SSM model's after a prefill of
   255 tokens, zamba2-1.2b's window set to 255), and a float32 train step
   of 2 x 2,048 for deepseek-moe-16b at 2 layers and mamba2-130m at full
   size; (b) the dry run's own sharded cells
   (``launch/dryrun.py::build_sharded_cell``: its parameter, batch and
   decode-cache placements, the cache write through ``local_map``) at
   reduced batches (``SPMD_FAKE_CELLS``: smollm-360m's ``train_4k``,
   ``prefill_32k`` and ``decode_32k``, deepseek-moe-16b's ``prefill_32k`` at
   4 layers, zamba2-1.2b's ``decode_32k`` and mamba2-130m's ``train_4k``) on
   a fake process group of 2 x 2 ranks, each counted per device
   (``count_sharded``) with CUDA shards and with meta shards: FLOPs, bytes
   and every collective record equal.  mixtral-8x7b (47 B parameters) is
   counted on meta only, by the dry run, and held on the CPU by the tests;
   (c) gemma3-1b's SMOKE float32 train step at B 16 x S 256 with heads of
   64 (``SPMD_SMOKE_STEP``: K6 by query heads, 4 over the model axis, the
   one kv head whole) on the fake 2 x 2 group, CUDA shards == meta shards,
   its collective bytes printed by kind.  The phase's wall time on its own
   line.

Each path runs with every launch counter set to 0 just before and read just
after; K1-K4 count their launches by route too, and every one of them must
be on ``tf32x3``, the tensor-core route (K1-K3 also by divergence tile); every float32 K6 launch must be on
``sm90_tf32x3``.  Prints the card (``nvidia-smi``),
one JSON line with the kernel table, and as its last line ``{"ok": true,
"device": {...}}``.  Tolerance:
``rtol=1e-4, atol=1e-5``, the reference package's own LP tolerance, for
K1-K4 (``5e-2`` for K4 on bfloat16, as the reference's test); ``rtol=1e-5,
atol=1e-6`` for K5, as the reference's ``test_feature_kernel_matches_ref``;
``2e-4`` (float32) for K6, as the reference's flash-attention tests (its
plain version repeats the kernel's tiles and recurrence, in float32).  K6's
bfloat16 route is held to its plain version, which repeats its recurrence
and rounds p to bfloat16 as it does, at ``rtol=atol=1e-2`` and, per block of
64 query rows of one (b, h), an error of at most ``1e-2`` of the block's
output in RMS: the two differ by roundings of single bfloat16 values (the
output's, or a p's on a short row; the largest reading is 3.9e-3, one
bfloat16 step of an output in [0.5, 1)), while a dropped key tile or a wrong
rescale moves a whole block.  SDPA is held to K6 at the reference's bfloat16 tolerance,
``5e-2``.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
N_SECSTR, D_SECSTR = 83_679, 315
VDT_ITERS, EXACT_ITERS, BATCH = 50, 10, 8
K5_RTOL, K5_ATOL = 1e-5, 1e-6
KNN_K = 4                       # |B| / N = 4: the paper's kNN equivalent
GRF_ITERS, GRF_SEED = 50, 0
N_VALIDATE, VDT_GRF_ITERS, VDT_GRF_WALKERS = 4_096, 20, 128
K3_BATCH, K3_N, K4_ROWS = 8, 16_384, 2_048
LM_ARCH, LM_BATCH, LM_PROMPT, LM_SEED = "smollm-360m", 4, 2_048, 0
LM_TOL, LM_F32_TOL = 0.15, 2e-3
K6_TOL = {"float32": 2e-4, "bfloat16": 5e-2}   # K6 vs the reference, SDPA
# K6's bfloat16 route vs its plain version: elementwise rtol=atol, and the
# RMS error of each 64-row block over the RMS of its output (both routes)
K6_BF16_PLAIN_TOL, K6_BLOCK_RMS = 1e-2, 1e-2
# the precision gate: kernel error vs float64 at most GATE_RATIO x the plain
# float32 version's, max and RMS; K1's 1 / (2 sigma^2) on Gaussian d = 315
GATE_SEED, GATE_N_K1, GATE_RATIO, GATE_INV_TSS = 15, 16_384, 2.0, 0.1
TC_ROUTE = "tf32x3"          # K1-K4's tensor-core route
K6_F32_ROUTE = "sm90_tf32x3"  # K6's float32 route: 3xTF32 on the tensor cores
K6_ROUTES = {"float32": K6_F32_ROUTE, "bfloat16": "sm90_bf16"}
K6_GATE_SEED = 16
# the divergences: kl at SecStr scale on x + 0.1 with 50 exact
# iterations; itakura_saito and a 315-long Mahalanobis scale (drawn from
# DIV_SCALE_SEED) at N = 16,384 with 10; gates on |N(0,1)| + 0.1 with logits
# spanning GATE_SPAN units a row, as GATE_INV_TSS gives the Gaussian gate
DIV_SHIFT, DIV_ITERS, DIV_SMALL_ITERS = 0.1, 50, 10
DIV_N, DIV_DATA_SEED, DIV_SCALE_SEED, GATE_SPAN = 16_384, 5, 18, 37.0
# streaming on the main path's model: 4,096 points in, 4,096 rows out
STREAM_K, STREAM_SEED, STREAM_LP_ITERS, STREAM_EXACT_ITERS = 4_096, 7, 8, 5
# the serving engine phase: checks at 10 iterations, a preempted 50-iteration
# walk, and the reference's `uniform` serving scenario (benchmarks/serving.py)
LP_ALPHAS, LP_CHECK_ITERS = (0.01, 0.05, 0.2), 10
PREEMPT_ITERS, PREEMPT_SEGMENT, PREEMPT_DEADLINE_MS = 50, 5, 1_000.0
TP_REQUESTS, TP_WIDTHS, TP_ITERS = 96, (1, 2, 3, 4, 6, 8), 50
TP_CLIENTS, TP_MAX_BATCH, TP_MAX_WAIT_MS = (1, 4, 16), 32, 25.0
# K6's timed shapes (name, B, Hq, Hkv, S, D, window, causal): smollm-360m's
# attention and gemma3-1b's local layer
K6_SHAPES = (("smollm-360m", 4, 15, 5, 2_048, 64, 0, True),
             ("gemma3-1b local", 4, 4, 1, 2_048, 256, 1_024, True))
# the sharded engine: D shards on cuda:0 over the fitted SecStr model
SHARD_COUNTS, SHARD_CHECK_ITERS, SHARD_TIME_ITERS = (1, 2, 4, 8), 10, 5
# the MoE serving phase: deepseek-moe-16b at full width, its depth cut from
# 28 layers to 16 (39.3 GB of float32 parameters), and K6 at its attention
MOE_ARCH, MOE_LAYERS, MOE_LAYER_TOKENS, MOE_LAYER_TOL = (
    "deepseek-moe-16b", 16, 256, 2e-3)
MOE_CHECK_PROMPT = 512   # the decode check's context (capacity >= T there)
K6_MOE_SHAPE = ("deepseek-moe-16b", 4, 16, 16, 2_048, 128, 0, True)
# kernel-name fragments of the MoE dispatch (argsort, searchsorted, the
# gathers and the index_add_ combine, top-k, bincount)
MOE_DISPATCH_KERNELS = ("sort", "search", "index", "scatter", "gather",
                        "topk", "bincount", "cub::")
# the SSM, hybrid and vlm phases: each model at full width and depth, the
# served traffic of [lm serve] (internvl2-1b's 256 patch embeddings first);
# float32 decode checks: prefill on 255 tokens (one chunk of 255 against
# the forward's one of 256; zamba2-1.2b's window set to 255, so that its ring
# holds exactly one window), internvl2-1b on 256 patches + 512 tokens; one
# SSM layer at zamba2-1.2b's width on 512 tokens, card against a CPU copy
LM_FAMILY_ARCHS = ("mamba2-130m", "zamba2-1.2b", "internvl2-1b")
SSM_CHECK_PROMPT, VLM_CHECK_PROMPT, SSM_LAYER_TOKENS = 255, 512, 512
K6_FAMILY_SHAPES = (("zamba2-1.2b", 4, 32, 32, 2_048, 64, 0, True),
                    ("internvl2-1b", 4, 14, 2, 2_304, 64, 0, True))
# the audio phase: whisper-medium at full width and depth, 4 requests of
# 1,500 seeded frame embeddings and 432-token prompts, 16 greedy decode
# steps (432 + 16 = 448, whisper's text context); K6 at its encoder's shape,
# bidirectional over 1,500 keys (not a multiple of the 64-key tile)
AUDIO_ARCH, AUDIO_PROMPT = "whisper-medium", 432
K6_AUDIO_SHAPE = ("whisper-medium encoder", 4, 16, 16, 1_500, 64, 0, False)
# [K6 stripes]: the [dryrun] prefill_32k cell's attention (smollm-360m, B = 1,
# 15 / 5 heads, S = 32,768, D = 64, causal) cut into K6_STRIPES query stripes
# of S / 16 rows, as a model axis of 16 runs it under attn_seq_shard, on
# both routes: the first, a middle and the last stripe against the plain
# version, the stripes concatenated against the whole launch bit for bit,
# each timed, and one stripe at K6_ODD_ROW_BASE (no multiple of the 64-row
# tile); the float32 route's gate on the last half of smollm's gate shape
K6_STRIPE_SHAPE = ("smollm-360m prefill_32k", 1, 15, 5, 32_768, 64, 0, True)
K6_STRIPES, K6_STRIPE_REPS, K6_ODD_ROW_BASE = 16, 5, 7 * 2_048 + 37
# [K6 grad]: K6's autograd route against autograd through ref.py's dense
# float32 softmax, at smollm's shape (S = 512), gemma3-1b local's (D = 256,
# window 1,024 at S = 1,536) and the whisper encoder's (bidirectional,
# S = 1,500); dq, dk, dv at 2e-4 in float32 and 1e-2 in bfloat16
K6_GRAD_CASES = (("smollm-360m", 2, 15, 5, 512, 64, 0, True),
                 ("gemma3-1b local", 1, 4, 1, 1_536, 256, 1_024, True),
                 ("whisper-medium encoder", 2, 16, 16, 1_500, 64, 0, False))
K6_GRAD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# [train]: AdamW as tests/test_arch_smoke.py sets it; smollm-360m at full
# width and depth, 4 steps of 4 x 2,048 tokens, bfloat16 compute;
# whisper-medium steps of 2 x (1,500 frames + 448 tokens), the first cold;
# float32 checks at 2 x 256 tokens (card vs a CPU copy; 2 microbatches vs
# the whole batch)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 2_048
AUDIO_TRAIN_STEPS, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ = 2, 2, 448
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 256
# [train launcher]: launch/train.py on smollm-360m's full configuration at
# its own defaults (8 x 128 tokens), 8 steps, a checkpoint every 4; the
# preempted run gets SIGTERM after its "step 2" line; checkpoints under
# build/ (git-ignored), removed when the phase ends.  The pipeline: its 32
# layers as 4 stages of 8 on ["cuda:0"] * 4, 8 microbatches of 1 x 512.
# (h): the same flags on one torchrun rank (this script, --launcher-rank)
LAUNCH_FLAGS = ["--arch", LM_ARCH, "--steps", "8", "--ckpt-every", "4",
                "--log-every", "1", "--device", "cuda"]
LAUNCH_STEPS, LAUNCH_TOKENS, LAUNCH_PREEMPT_AFTER = 8, 8 * 128, 2
LAUNCH_DIR = REPO / "build" / "train_launcher"
PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS = 4, 8, 512
# [dryrun]: launch/dryrun.py's grid on meta (10 architectures x 4 shapes on
# single_pod and the paper cell) in a subprocess, expected (ok, skipped,
# errors); meanwhile the cells' meta counts and K6 against its plain version
# at the cells' attention shapes; once the grid has ended, cells on the card
# at a batch it holds (arch, shape, batch, K6 launches a step, all
# sm90_bf16), then the paper cell at full size; each card count equal to its
# meta count, DRYRUN_REPS warm steps timed and DRYRUN_REPS profiled
DRYRUN_GRID = (34, 7, 0)
DRYRUN_CELLS = (("smollm-360m", "prefill_32k", 1, 32),
                ("smollm-360m", "train_4k", 2, 64),
                ("smollm-360m", "decode_32k", 8, 0),
                ("mamba2-130m", "long_500k", 1, 0))
DRYRUN_REPS, DRYRUN_VDT_SEED = 5, 23
# [spmd]: smollm-360m at full width as DTensors, (a) over a one-rank NCCL
# mesh (a FileStore in a temporary directory): a bfloat16 prefill of
# LM_BATCH x LM_PROMPT tokens and one float32 train step of SPMD_TRAIN
# (AdamW with SPMD_OPT: eps 1e-4 keeps g / (|g| + eps) smooth, as in
# tests/test_torch_spmd.py), each against the same call on plain tensors;
# (b) the dry run's sharded cells (shape, batch) counted per device on a
# fake group of 2 x 2 ranks, on the card and on meta, equal exactly
SPMD_TRAIN = (2, 2_048)
SPMD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
SPMD_F32_RTOL, SPMD_BF16_TOL = 1e-5, 1e-2
SPMD_FAKE_MESH = (2, 2)
# (c): gemma3-1b's SMOKE float32 train step at B 16 x S 256 on the fake
# group, with heads of 64 (K6's widths; SMOKE's are 16): 4 query heads
# over the model axis, its 1 kv head whole (K6 by query heads)
SPMD_SMOKE_STEP = ("gemma3-1b", 16, 256, 64)
# (b)'s cells: (arch, shape, batch, layers; None = all, the dry run's
# context switches beside its own): smollm-360m's three kinds, then one
# cell of each family sharded since (deepseek-moe-16b's depth cut to 4
# layers: its full-size float32 parameters would not fit beside their
# shards), the paper cell at full size (the row-sharded LP step),
# internvl2-1b's prefill and whisper-medium's train step and decode (its 24
# encoder layers over a data axis of 2: their attention weights
# layer-sharded, gathered by the encoder); every prefill_32k cell with
# seq_shard on, as the dry run sets it; last, smollm-360m's train step with
# attn_seq_shard (K6 as query stripes: 15 heads over a model axis of 2)
SPMD_FAKE_CELLS = (("smollm-360m", "train_4k", 2, None, {}),
                   ("smollm-360m", "prefill_32k", 2, None, {}),
                   ("smollm-360m", "decode_32k", 8, None, {}),
                   ("deepseek-moe-16b", "prefill_32k", 2, 4, {}),
                   ("zamba2-1.2b", "decode_32k", 8, None, {}),
                   ("mamba2-130m", "train_4k", 2, None, {}),
                   ("paper-vdt", "lp_1m", None, None, {}),
                   ("internvl2-1b", "prefill_32k", 2, None, {}),
                   ("whisper-medium", "train_4k", 2, None, {}),
                   ("whisper-medium", "decode_32k", 8, None, {}),
                   ("smollm-360m", "train_4k", 2, None,
                    {"attn_seq_shard": True}))
# (a) for the moe, ssm and hybrid families at full width, over the one-rank
# mesh: (arch, layers served (None = all), K6 launches a prefill, layers of
# the float32 train step (None: no train step)); a bfloat16 prefill of
# LM_BATCH x LM_PROMPT tokens and SPMD_DECODE greedy decode steps, each
# against plain tensors (an SSM model decodes after a prefill of
# SSM_CHECK_PROMPT tokens, zamba2-1.2b's window set to it, as [lm serve
# hybrid] does); deepseek-moe-16b serves 16 of its 28 layers (MOE_LAYERS,
# 39.3 GB of float32 parameters) and trains 2 (parameters, gradients and
# both moments ~25 GB)
SPMD_FAMILIES = (("deepseek-moe-16b", MOE_LAYERS, MOE_LAYERS, 2),
                 ("mamba2-130m", None, 0, 24),
                 ("zamba2-1.2b", None, 6, None))
SPMD_DECODE = 4
# (a) the vlm and audio families at full width and depth over the one-rank
# mesh: (arch, K6 launches a prefill, prompt tokens, train text tokens): the
# [lm serve vlm] / [lm serve audio] traffic (4 x (256 patch embeddings +
# 2,048 tokens); 4 x 432 tokens after 1,500 frames), SPMD_DECODE decode
# steps, one float32 train step of 2 x 2,048 text tokens after the patches
# and of 2 x (1,500 frames + 448 tokens), each against plain tensors
SPMD_ENCDEC = (("internvl2-1b", 24, LM_PROMPT, SPMD_TRAIN[1]),
               ("whisper-medium", 48, AUDIO_PROMPT, AUDIO_TRAIN_SEQ))
# (a) the paper's LP step at full size (the [dryrun] cell's seeded inputs,
# every input's rows over the one-rank mesh) against the plain step: float32
# carriers at the VDT tolerance (index_add_ adds with atomics on the card),
# bfloat16 carriers at test_torch_distributed.py's bfloat16 tolerance;
# SPMD_PAPER_REPS steps of each timed
SPMD_PAPER_BF16_TOL, SPMD_PAPER_REPS = 5e-2, 10


# subprocesses started in the background, stopped at exit if still running
STARTED: list = []


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def close(got, want, what: str, rtol: float = RTOL,
          atol: float = ATOL) -> tuple[float, float]:
    """Hold ``got`` to ``want`` at rtol/atol; returns (max abs, max rel) error."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"  {what}: max_abs_err={float(err.max()):.3e} max_rel_err={rel:.3e}"
          f" {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{what}: outside rtol={rtol}, atol={atol}")
    return float(err.max()), rel


def counters():
    """The launch counters of every kernel wrapper, by kernel."""
    from repro_torch.kernels.fused_lp import folded_step, matvec_step, \
        perbatch_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grf import grf_feature_matvec
    from repro_torch.kernels.pairwise import pairwise_sq_dists

    return {"K1": folded_step, "K2": matvec_step, "K3": perbatch_step,
            "K4": pairwise_sq_dists, "K5": grf_feature_matvec,
            "K6": flash_attention}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        for by in ("launches_by_route", "launches_by_tile"):
            for key in getattr(fn, by, {}):
                getattr(fn, by)[key] = 0


def read_counts() -> dict:
    """Launches by kernel, by route where a kernel has routes (``K1
    tf32x3``, ``K4 tf32x1_bf16``, ``K6 sm90_bf16``, ``K6 sm90_tf32x3``, ...)
    and by divergence tile for K1-K3 (``K1 tile kl``, ...)."""
    counts = {}
    for k, fn in counters().items():
        counts[k] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            counts[f"{k} {route}"] = n
        for tile, n in getattr(fn, "launches_by_tile", {}).items():
            counts[f"{k} tile {tile}"] = n
    return counts


def check_tc_route(counts: dict, kernels=("K1", "K2", "K3", "K4")) -> None:
    """Every launch of K1-K4 in ``counts`` went through the tensor-core route:
    its entry point reported three TF32 products a k step."""
    for k in kernels:
        check(counts[f"{k} {TC_ROUTE}"] == counts[k],
              f"{k}: {counts[k]} launches, {counts[f'{k} {TC_ROUTE}']} on "
              f"{TC_ROUTE}")


def tc_bound(m: int, n: int, d: int, k: int, nbytes: float) -> tuple:
    """K1-K4's least time in ms on the tensor-core route, what sets it, and
    the float32 CUDA-core bound of the same function: the cross term as
    three TF32 products (3 x 2 m n d) at the TF32 peak, plus p @ Y (2 m n k)
    at the float32 peak; or the bytes at the memory rate (H100 SXM,
    ``launch/roofline.py::HW``)."""
    from repro_torch.launch.roofline import HW

    t_ops = (3 * 2.0 * m * n * d / HW.PEAK_TF32_FLOPS
             + 2.0 * m * n * k / HW.PEAK_FP32_FLOPS)
    t_bytes = nbytes / HW.HBM_BW
    f32_ms = max(2.0 * m * n * (d + k) / HW.PEAK_FP32_FLOPS, t_bytes) * 1e3
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", f32_ms)


def k6_route_only(counts: dict, route: str, n: int) -> bool:
    """``counts`` put ``n`` K6 launches on ``route`` and none on another."""
    others = sum(v for k, v in counts.items()
                 if k.startswith("K6 ") and k != f"K6 {route}")
    return counts["K6"] == n and counts[f"K6 {route}"] == n and others == 0


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn()`` in ms: ``reps`` calls captured in one CUDA graph,
    replayed once as a warm-up and once timed, so no host launch cost is in
    it.  For calls shorter than their Python launch path."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention.ops import \
        sm90_library as lib_k6_sm90
    from repro_torch.kernels.flash_attention.ops import \
        tf32x3_library as lib_k6
    from repro_torch.kernels.fused_lp import kernel_library as lib_k123
    from repro_torch.kernels.grf.ops import kernel_library as lib_k5
    from repro_torch.kernels.pairwise.ops import kernel_library as lib_k4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    names = ("K1-K3", "K4", "K5", f"K6 {K6_F32_ROUTE}", "K6 sm90_bf16",
             "L2 yardstick")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda f: f(), (lib_k123, lib_k4, lib_k5,
                                               lib_k6, lib_k6_sm90,
                                               l2_probe_library)))
    print(f"[build] {time.perf_counter() - t0:.2f} s for all sources")
    for name, lib in zip(names, built):
        print(f"  {name} {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    " + line.strip())


def l2_probe_library():
    """Build (at first use) and load ``tools/l2_gather_probe.cu``."""
    import ctypes

    from repro_torch.kernels._build import load_library

    built = load_library(REPO / "tools" / "l2_gather_probe.cu")
    fn = built.lib.l2_gather_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def phase_kernel_small():
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain,
                                              fused_lp_scan_batched_ref,
                                              fused_lp_scan_folded,
                                              fused_lp_scan_folded_resume)

    print("[K1 vs plain, small shapes]")
    g = torch.Generator().manual_seed(0)
    for n, d, k, per_col in ((1_000, 315, 2, False), (4_099, 64, 16, True),
                             (257, 8, 300, True)):
        x = torch.randn(n, d, generator=g).cuda()
        y0 = torch.rand(n, k, generator=g).cuda()
        alpha = (torch.rand(k, generator=g) if per_col else 0.3)
        al = alpha_row(alpha, k, "cuda")
        sigma = d ** 0.5
        inv = 1.0 / (2.0 * sigma * sigma)
        close(folded_step(x, x, y0, y0, al, inv),
              folded_step_plain(x, x, y0, y0, al, inv),
              f"step  N={n} d={d} K={k}")
        want = y0
        for _ in range(5):
            want = folded_step_plain(x, x, want, y0, al, inv)
        scan = fused_lp_scan_folded(x, y0, sigma, al, 5)
        close(scan, want, f"scan5 N={n} d={d} K={k}")
        if n <= 1_000:  # the dense eq.-3 oracle, P materialized
            dense = fused_lp_scan_batched_ref(x, y0[None], sigma,
                                              al.reshape(1, 1, k), 5)[0]
            close(scan, dense,
                  f"scan5 vs dense oracle N={n} K={k}")
        resumed = fused_lp_scan_folded_resume(
            x, fused_lp_scan_folded(x, y0, sigma, al, 2), y0, sigma, al, 3)
        check(torch.equal(resumed, scan), "resume-from-carry != monolithic scan")
        print(f"  resume(2+3) == scan(5) bit for bit, N={n} K={k}")
    x = torch.randn(300, 16, generator=g).cuda()
    y = torch.rand(300, 5, generator=g).cuda()
    al = alpha_row(torch.rand(5, generator=g), 5, "cuda")
    rows, y0 = x[37:181].contiguous(), y[37:181].contiguous()
    close(folded_step(rows, x, y, y0, al, 0.05, row_base=37),
          folded_step_plain(rows, x, y, y0, al, 0.05, row_base=37),
          "step  row_base=37 M=144 N=300 K=5")


def phase_k5_small():
    import torch
    from repro_torch.kernels.grf import (grf_feature_matvec,
                                         grf_feature_matvec_ref,
                                         grf_feature_plain)

    print("[K5 vs plain, small shapes]")
    g = torch.Generator().manual_seed(1)
    for s, m, n, k in ((24, 16, 24, 2), (1_000, 64, 1_000, 16),
                       (4_099, 7, 3_000, 300), (300, 400, 500, 3)):
        pos = torch.randint(0, n, (s, m), generator=g,
                            dtype=torch.int32).cuda()
        load = torch.rand(s, m, generator=g).cuda()
        y = torch.randn(n, k, generator=g).cuda()
        got = grf_feature_matvec(pos, load, y)
        close(got, grf_feature_plain(pos, load, y), f"S={s} m={m} N={n} K={k}",
              K5_RTOL, K5_ATOL)
        close(got, grf_feature_matvec_ref(pos, load, y),
              f"S={s} m={m} N={n} K={k} vs gather oracle", K5_RTOL, K5_ATOL)
        if k == 16:
            two = grf_feature_matvec(pos, load, y[:, 3:5].contiguous())
            check(torch.equal(got[:, 3:5], two),
                  "K5: a K=16 column differs from the K=2 call's")
            print("  K=16 columns 3:5 == K=2 call bit for bit")


def gate_check(what: str, got, plain, ref) -> dict:
    """Measure ``got`` against the float64 ``ref`` beside the plain float32
    version ``plain``; ``ok`` when its max and RMS errors are each at most
    ``GATE_RATIO`` x the plain version's."""
    import torch

    def errors(t):
        check(t.shape == ref.shape and bool(torch.isfinite(t).all()),
              f"{what}: bad output")
        err = (t.double() - ref).abs()
        return float(err.max()), float(err.square().mean().sqrt())

    (k_max, k_rms), (p_max, p_rms) = errors(got), errors(plain)
    ok = k_max <= GATE_RATIO * p_max and k_rms <= GATE_RATIO * p_rms
    print(f"  {what}: kernel max {k_max:.4e} rms {k_rms:.4e}; plain f32 max "
          f"{p_max:.4e} rms {p_rms:.4e}; kernel / plain {k_max / p_max:.3f} "
          f"(max), {k_rms / p_rms:.3f} (rms) {'ok' if ok else 'FAIL'}")
    return dict(max=k_max, rms=k_rms, plain_max=p_max, plain_rms=p_rms, ok=ok)


def phase_gate() -> dict:
    """The precision gate: K4 and K1 against float64 on dense Gaussian points,
    where a dropped low product shows; the counts are not a path's."""
    import torch
    from repro_torch.kernels.fused_lp import folded_step, folded_step_plain
    from repro_torch.kernels.pairwise import (pairwise_sq_dists,
                                              pairwise_sq_dists_plain)

    print(f"[precision gate] Gaussian d={D_SECSTR}, seed {GATE_SEED}: kernel "
          f"vs float64 within {GATE_RATIO} x the plain float32 version's error")
    rng = np.random.RandomState(GATE_SEED)
    out = {}
    x = torch.as_tensor(rng.randn(K4_ROWS, D_SECSTR).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.randn(N_SECSTR, D_SECSTR).astype(np.float32),
                        device="cuda")
    xd, yd = x.double(), y.double()
    ref = ((xd * xd).sum(1)[:, None] + (yd * yd).sum(1)[None, :]
           - 2.0 * (xd @ yd.T)).clamp_min(0.0)
    out["K4"] = gate_check(f"K4 {K4_ROWS} x {N_SECSTR}", pairwise_sq_dists(x, y),
                           pairwise_sq_dists_plain(x, y), ref)
    del x, y, xd, yd, ref
    x = torch.as_tensor(rng.randn(GATE_N_K1, D_SECSTR).astype(np.float32),
                        device="cuda")
    xd = x.double()
    head = xd[:256]
    d2 = ((head * head).sum(1)[:, None] + (xd * xd).sum(1)[None, :]
          - 2.0 * (head @ xd.T)) * GATE_INV_TSS
    d2.fill_diagonal_(float("nan"))
    span = float((d2.nan_to_num(-1.0).amax(1) - d2.nan_to_num(1e30).amin(1))
                 .mean())
    print(f"  K1 logits at 1/(2 sigma^2) = {GATE_INV_TSS}: a row spans "
          f"{span:.1f} units on average (first 256 rows)")
    for k in (2, 16):
        y = torch.as_tensor(rng.rand(GATE_N_K1, k).astype(np.float32),
                            device="cuda")
        al = torch.as_tensor(rng.rand(k).astype(np.float32), device="cuda")
        ref = folded_step_plain(xd, xd, y.double(), y.double(), al.double(),
                                GATE_INV_TSS)
        out[f"K1 K={k}"] = gate_check(
            f"K1 N={GATE_N_K1} K={k}", folded_step(x, x, y, y, al,
                                                   GATE_INV_TSS),
            folded_step_plain(x, x, y, y, al, GATE_INV_TSS), ref)
    failed = [k for k, v in out.items() if not v["ok"]]
    check(not failed, f"precision gate failed for {failed}: error over "
                      f"{GATE_RATIO} x the plain float32 version's")
    out["K1 logit span"] = span
    return out


def phase_main(data):
    """The port's main path; returns what the later checks need."""
    import torch
    from repro_torch import VariationalDualTree, ccr, one_hot_labels
    from repro_torch.kernels.fused_lp import folded_step

    x, labels = data.x, data.labels
    n = x.shape[0]
    rng = np.random.RandomState(11)
    masks = [rng.rand(n) < 0.10 for _ in range(BATCH)]
    y0 = one_hot_labels(labels, masks[0], data.n_classes)
    y0s = torch.stack([one_hot_labels(labels, m, data.n_classes) for m in masks])
    alphas = torch.linspace(0.005, 0.05, BATCH)
    out = dict(masks=masks, y0=y0, y0s=y0s, alphas=alphas)

    print(f"[fit] secstr_like N={n} d={x.shape[1]} |B|=4N on the card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vdt = VariationalDualTree.fit(x, max_blocks=4 * n, refine_batch=512,
                                  sigma_iters=3)
    torch.cuda.synchronize()
    s = vdt.stats
    print(f"  total {time.perf_counter() - t0:.2f} s: build_tree {s.build_tree_s:.2f} s,"
          f" sigma+q {s.init_qopt_s:.2f} s ({s.sigma_iters} sigma iters),"
          f" refine {s.refine_s:.2f} s; n_blocks={vdt.n_blocks} sigma={s.sigma:.6f}"
          f" bound={s.bound:.6e}; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(vdt.device.type == "cuda", "fit did not run on the card")
    check(np.isfinite(s.bound) and vdt.n_blocks >= 4 * n, "fit: bad state")
    out["vdt"] = vdt

    print(f"[vdt LP] alpha=0.01, {VDT_ITERS} iterations, 10% labeled")
    for name, seed, alpha in (("single", y0, 0.01), ("batch8", y0s, alphas)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vdt.label_propagate(seed, alpha=alpha, n_iters=VDT_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(res).all()), f"vdt {name}: non-finite")
        check(tuple(res.shape) == tuple(seed.shape), f"vdt {name}: bad shape")
        out[f"vdt_{name}"] = res
        first = res if res.ndim == 2 else res[0]
        print(f"  {name}: {ms:.1f} ms per call, CCR on unlabeled rows "
              f"{ccr(first, labels, ~masks[0]):.4f}")

    print(f"[exact LP through K1] {EXACT_ITERS} iterations at N={n}")
    for name, seed, alpha in (("single", y0, 0.01), ("batch8", y0s, alphas)):
        before = folded_step.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vdt.label_propagate(seed, alpha=alpha, n_iters=EXACT_ITERS,
                                  backend="exact")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        runs = folded_step.launches - before
        check(runs == EXACT_ITERS, f"exact {name}: {runs} K1 launches for "
                                   f"{EXACT_ITERS} iterations")
        check(bool(torch.isfinite(res).all()), f"exact {name}: non-finite")
        out[f"exact_{name}"] = res
        flops = 2.0 * n * n * x.shape[1]
        agree = float((res.argmax(-1) == out[f"vdt_{name}"].argmax(-1))
                      .float().mean())
        first = res if res.ndim == 2 else res[0]
        print(f"  {name} (K={seed.shape[-1] * (BATCH if seed.ndim == 3 else 1)}):"
              f" {sec / EXACT_ITERS * 1e3:.1f} ms per iteration, K1 launches"
              f" {runs}, {flops / (sec / EXACT_ITERS) / 1e12:.2f} TFLOP/s of the"
              f" 2*N^2*d distance work, argmax agreement with vdt {agree:.4f},"
              f" CCR {ccr(first, labels, ~masks[0]):.4f}")
    return out


def phase_after(data, out) -> dict:
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain)

    vdt = out["vdt"]
    print("[vdt LP on the card vs a CPU copy of the fitted model]")
    cpu = vdt.to("cpu")
    close(out["vdt_single"], cpu.label_propagate(out["y0"].cpu(), alpha=0.01,
                                                 n_iters=VDT_ITERS), "single")
    close(out["vdt_batch8"], cpu.label_propagate(out["y0s"].cpu(),
                                                 alpha=out["alphas"],
                                                 n_iters=VDT_ITERS), "batch8")

    print("[exact LP: first 2 iterations, K1 vs plain on the card]")
    x = vdt.x_rows
    sigma = float(vdt.sigma)
    inv = float(1.0 / (2.0 * sigma * sigma))
    errs, shapes = [], {}
    for name, seed, alpha in (("single", out["y0"], 0.01),
                              ("batch8", out["y0s"], out["alphas"])):
        k_seed = seed if seed.ndim == 2 else seed.movedim(0, 1).reshape(
            seed.shape[1], -1).contiguous()
        al = alpha if seed.ndim == 2 else torch.as_tensor(alpha).repeat_interleave(
            seed.shape[-1])
        al = alpha_row(al, k_seed.shape[1], "cuda")
        got = vdt.label_propagate(seed, alpha=alpha, n_iters=2, backend="exact")
        got = got if got.ndim == 2 else got.movedim(0, 1).reshape(k_seed.shape)
        want = k_seed
        for _ in range(2):
            want = folded_step_plain(x, x, want, k_seed, al, inv)
        errs.append(close(got, want, f"{name} K={k_seed.shape[1]}")[0])
        shapes[name] = (k_seed, al)

    print("[K1 timing at the main path's shapes]")
    n, d = x.shape
    rows = []
    for name in ("single", "batch8"):
        k_seed, al = shapes[name]
        k = k_seed.shape[1]
        ms = cuda_ms(lambda: folded_step(x, x, k_seed, k_seed, al, inv), 3)
        ms2 = cuda_ms(lambda: folded_step(x, x, k_seed, k_seed, al, inv), 3)
        plain_ms = cuda_ms(lambda: folded_step_plain(x, x, k_seed, k_seed, al, inv), 1)
        # x, y, y0, alpha in; out
        bound_ms, by, f32_ms = tc_bound(n, n, d, k, 4.0 * (n * d + 3 * n * k + k))
        print(f"  K={k}: K1 {ms:.2f} / {ms2:.2f} ms per launch, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.2f} ms ({by}; 3xTF32 on "
              f"the tensor cores), {bound_ms / ms:.3f} of it; float32 CUDA-core"
              f" bound {f32_ms:.2f} ms, {f32_ms / ms:.3f} of it")
        rows.append(dict(k=k, ms=ms, ms2=ms2, plain_ms=plain_ms,
                         bound_ms=bound_ms, by=by))
    return dict(max_abs_err=max(errs), rows=rows)


def phase_knn(data, sigma: float):
    """The paper's k = 4 kNN graph of the SecStr-scale points, as a CSR graph."""
    import torch
    from repro_torch.core.baselines import build_knn_graph
    from repro_torch.core.grf import CSRGraph
    from repro_torch.core.label_prop import route_backend

    x = torch.as_tensor(data.x, device="cuda")
    n = x.shape[0]
    print(f"[knn graph] k={KNN_K} sigma={sigma:.6f} N={n}: "
          f"{-(-n // 2048)} blocks of 2048 x {n} distances")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn = build_knn_graph(x, KNN_K, sigma)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    check(bool(torch.isfinite(knn.weights).all()), "knn: non-finite weights")
    check(not bool((knn.indices == torch.arange(n, device="cuda")[:, None])
                   .any()), "knn: a self edge")
    t0 = time.perf_counter()
    graph = CSRGraph.from_csr(np.arange(n + 1) * KNN_K,
                              knn.indices.reshape(-1),
                              knn.weights.reshape(-1), device="cuda")
    t_csr = time.perf_counter() - t0
    routed = route_backend("auto", n=n, density=graph.density, rtol=0.05)
    print(f"  build_knn_graph {t_knn:.2f} s ({2.0 * n * n * x.shape[1] / 1e12:.2f}"
          f" TFLOP of f32 product), CSRGraph.from_csr {t_csr:.2f} s: "
          f"{graph.nnz} edges, density {graph.density:.3e}; auto routes to "
          f"{routed!r}")
    check(graph.nnz == KNN_K * n and graph.device.type == "cuda", "bad graph")
    check(routed == "grf", f"auto routed the kNN graph to {routed!r}")
    return knn, graph


def phase_grf(out, knn, graph) -> None:
    """GRF label propagation over the kNN graph at full N; K5 every step."""
    import torch
    from repro_torch.core.baselines import knn_matvec
    from repro_torch.core.grf import (DEFAULT_N_WALKERS, grf_label_propagate,
                                      walkers_for_rtol)
    from repro_torch.core.label_prop import label_propagate
    from repro_torch.kernels.grf import grf_feature_matvec

    n = graph.n
    y0, y0s, alphas = out["y0"], out["y0s"], out["alphas"]
    truth = {a: label_propagate(lambda y: knn_matvec(knn, y), y0, a,
                                GRF_ITERS) for a in (0.01, 0.5)}

    def run(seed_labels, alpha, m):
        before = grf_feature_matvec.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = grf_label_propagate(graph, seed_labels, alpha=alpha,
                                  n_iters=GRF_ITERS, n_walkers=m,
                                  seed=GRF_SEED)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs = grf_feature_matvec.launches - before
        check(runs == GRF_ITERS, f"grf: {runs} K5 launches for {GRF_ITERS} "
                                 f"iterations")
        check(tuple(res.shape) == tuple(seed_labels.shape)
              and bool(torch.isfinite(res).all()), "grf: bad output")
        return res, ms

    rms = {}
    for m in (DEFAULT_N_WALKERS, walkers_for_rtol(0.05)):
        print(f"[grf LP] kNN graph, {GRF_ITERS} iterations, n_walkers={m} "
              f"({n * m} walkers), 10% labeled")
        torch.cuda.reset_peak_memory_stats()
        single, ms = run(y0, 0.01, m)
        again, _ = run(y0, 0.01, m)
        check(torch.equal(single, again), "grf: a repeated call differs")
        batch, ms_b = run(y0s, alphas, m)
        for b in range(BATCH):
            solo, _ = run(y0s[b], float(alphas[b]), m)
            check(torch.equal(batch[b], solo),
                  f"grf: batched[{b}] differs from its solo call")
        half, ms_h = run(y0, 0.5, m)
        print(f"  single {ms:.1f} ms per call, batch8 {ms_b:.1f} ms, "
              f"alpha=0.5 {ms_h:.1f} ms; repeat == first and batched[b] == "
              f"solo b bit for bit; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for a, est in ((0.01, single), (0.5, half)):
            err = (est - truth[a]).double()
            r = float(err.pow(2).mean().sqrt())
            agree = float((est.argmax(-1) == truth[a].argmax(-1)).float()
                          .mean())
            print(f"  alpha={a}: vs the kNN eq.-15 walk rms_err={r:.3e} "
                  f"max_err={float(err.abs().max()):.3e} argmax agreement "
                  f"{agree:.4f}")
            rms[(m, a)] = r
    ratio = rms[(64, 0.5)] / rms[(400, 0.5)]
    print(f"  rms error ratio 64 / 400 walkers at alpha=0.5: {ratio:.3f} "
          f"(CLT: sqrt(400/64) = 2.5)")
    check(ratio >= 2.0, f"grf error did not shrink with walkers: {ratio:.3f}")


def l2_yardstick(n: int) -> list:
    """The rate at which the card moves random 32- and 64-byte rows of an
    L2-resident array, of y's sizes at K = 2 and 16, to the SMs
    (``tools/l2_gather_probe.cu``): through L2 alone (``cg``) and through L1
    and L2 as K5's loads go (``nc``); GB/s of 32-byte sectors, by case."""
    import torch
    from repro_torch.kernels._build import launch

    built = l2_probe_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 256
    sink = torch.empty(blocks * 256, device="cuda")
    rows = []
    for k, row_floats, l1 in ((2, 8, 0), (2, 8, 1), (16, 16, 0), (16, 16, 1),
                              (16, 8, 0)):
        y = torch.rand(n * k, device="cuda")       # y's bytes at this K
        n_rows = y.numel() // row_floats

        def probe():
            launch(built, "l2_gather_probe", y.device, y.data_ptr(), n_rows,
                   row_floats, l1, iters, sink.data_ptr(), blocks)

        ms = cuda_ms(probe, 20)
        sectors = blocks * 256.0 / (row_floats // 4) * iters \
            * row_floats * 4 / 32
        rate = sectors * 32 / ms / 1e6          # GB/s
        path = "nc" if l1 else "cg"
        print(f"[L2 yardstick] random {row_floats * 4}-byte rows of a "
              f"{y.numel() * 4 / 1e6:.2f} MB array (y at K={k}), ld.global."
              f"{path}: {ms:.4f} ms for {sectors / 1e6:.1f} M sectors, "
              f"{rate:.0f} GB/s, {sectors / ms / 1e6:.2f} G sectors/s")
        rows.append(dict(k=k, row_bytes=row_floats * 4, load=path,
                         array_mb=y.numel() * 4 / 1e6, ms=ms,
                         gb_per_s=rate))
    return rows


def phase_k5_timing(graph, out) -> dict:
    """K5 at the GRF path's shapes, against its plain version and a library
    call (in turns), with the L2 sector rate it reaches beside the L2's own
    rate for random sectors."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.matvec import fold_batch
    from repro_torch.kernels.grf import (default_draw, grf_feature_matvec,
                                         grf_feature_plain, walk_step)
    from repro_torch.kernels.grf.walkers import start_state
    from repro_torch.launch.roofline import bound

    print("[K5 at the GRF path's shapes: walkers after 3 steps]")
    n, rows = graph.n, []
    yard = l2_yardstick(n)
    for m in (64, 400):
        pos, load, alive = start_state(n, m, graph.device)
        draw = default_draw(7, n * m, graph.device)
        for t in range(1, 4):
            pos, load, alive = walk_step(graph.nbr, graph.prob, graph.deg, pos,
                                         load, alive, draw(t))
        pos, load = pos.view(n, m), load.view(n, m)
        for y in (out["y0"], fold_batch(out["y0s"]).contiguous()):
            k = y.shape[1]
            got = grf_feature_matvec(pos, load, y)
            err = close(got, grf_feature_plain(pos, load, y),
                        f"S={n} m={m} K={k}", K5_RTOL, K5_ATOL)[0]
            check(torch.equal(got, grf_feature_matvec(pos, load, y)),
                  f"K5 S={n} m={m} K={k}: two launches differ")
            call_ms = cuda_ms(lambda: grf_feature_matvec(pos, load, y), 20)

            def kernel():
                return graph_ms(lambda: grf_feature_matvec(pos, load, y), 20)

            def library():
                return graph_ms(lambda: F.embedding_bag(
                    pos, y, per_sample_weights=load, mode="sum"), 20)

            # kernel, library, kernel, library: compared only in one run
            ms, lib_ms, ms2, lib_ms2 = kernel(), library(), kernel(), library()
            plain_ms = graph_ms(lambda: grf_feature_plain(pos, load, y), 3)
            bound_ms, by = bound(2.0 * n * m * k,
                                 n * m * 8.0 + n * k * 4.0 + n * k * 4.0)
            # y's 32-byte sectors a walker's row spans, moved from L2
            l2_bytes = n * m * (-(-4 * k // 32)) * 32.0
            l2_rate = l2_bytes / ms / 1e6      # GB/s
            print(f"  m={m} K={k}: K5 {ms:.4f} / {ms2:.4f} ms on the device "
                  f"({call_ms:.4f} ms per call with its host launch path), "
                  f"plain {plain_ms:.3f} ms, embedding_bag {lib_ms:.4f} / "
                  f"{lib_ms2:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
                  f"{bound_ms / ms:.3f} of the bound; L2 sectors "
                  f"{l2_bytes / 1e9:.3f} GB, {l2_rate:.0f} GB/s")
            rows.append(dict(m=m, k=k, ms=ms, ms2=ms2, call_ms=call_ms,
                             plain_ms=plain_ms, lib_ms=lib_ms,
                             lib_ms2=lib_ms2, bound_ms=bound_ms, by=by,
                             err=err, l2_gb=l2_bytes / 1e9,
                             l2_gb_per_s=l2_rate))
    return dict(rows=rows, max_abs_err=max(r["err"] for r in rows),
                l2_yardstick=yard)


def phase_vdt_grf():
    """``label_propagate(backend="grf")`` through the VDT entry point; returns
    the model."""
    import torch
    from repro_torch import VariationalDualTree, one_hot_labels
    from repro_torch.data.synthetic import secstr_like

    data = secstr_like(N_VALIDATE, D_SECSTR, seed=3)
    n = N_VALIDATE
    vdt = VariationalDualTree.fit(data.x, max_blocks=4 * n, refine_batch=512,
                                  sigma_iters=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = vdt.grf_graph()
    print(f"[vdt grf] secstr_like N={n}: fit on the card, sigma="
          f"{float(vdt.sigma):.6f}; grf_graph (dense eq.-3 bridge) "
          f"{time.perf_counter() - t0:.2f} s, {graph.nnz} edges, max degree "
          f"{graph.max_deg}")
    check(vdt.grf_graph() is graph and graph.device.type == "cuda",
          "grf_graph is not cached on the card")
    mask = np.random.RandomState(5).rand(n) < 0.10
    y0 = one_hot_labels(data.labels, mask, data.n_classes)
    alpha = 0.5
    exact = vdt.label_propagate(y0, alpha=alpha, n_iters=VDT_GRF_ITERS,
                                backend="exact")
    ests = []
    for seed in range(4):
        c = read_counts()
        est = vdt.label_propagate(y0, alpha=alpha, n_iters=VDT_GRF_ITERS,
                                  backend="grf", n_walkers=VDT_GRF_WALKERS,
                                  seed=seed)
        runs = read_counts()["K5"] - c["K5"]
        check(runs == VDT_GRF_ITERS, f"vdt grf: {runs} K5 launches")
        check(tuple(est.shape) == tuple(y0.shape)
              and bool(torch.isfinite(est).all()), "vdt grf: bad output")
        ests.append(est)
        err = (est - exact).abs()
        agree = float((est.argmax(-1) == exact.argmax(-1)).float().mean())
        print(f"  seed {seed}: vs exact (K1) max_err={float(err.max()):.3e} "
              f"mean_err={float(err.mean()):.3e} argmax agreement {agree:.4f}")
    mean = torch.stack(ests).mean(0)
    print(f"  mean of 4 seeds: max_err={float((mean - exact).abs().max()):.3e}"
          f" mean_err={float((mean - exact).abs().mean()):.3e}")
    return vdt


def lp_engine_class():
    """``PropagateEngine`` that brackets every scan and resumed segment with
    CUDA events on the scheduler thread's stream (``device_ms``: their
    summed spans), and with ``keep=True`` keeps a copy of each monolithic
    scan's padded stack, alphas and output."""
    import torch
    from repro_torch.serving import PropagateEngine

    class Recorded(PropagateEngine):
        def __init__(self, *args, keep: bool = False, **kwargs):
            self.keep, self.scans, self.events = keep, [], []
            super().__init__(*args, **kwargs)

        def _timed(self, fn, *args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        def _scan(self, vdt, stack, alphas, n_iters, backend, *,
                  n_walkers=None):
            out = self._timed(super()._scan, vdt, stack, alphas, n_iters,
                              backend, n_walkers=n_walkers)
            if self.keep:
                self.scans.append((stack.clone(), np.array(alphas),
                                   out.clone(), int(n_iters), n_walkers))
            return out

        def _scan_resume(self, vdt, carry, y0, alphas, n_iters, backend):
            return self._timed(super()._scan_resume, vdt, carry, y0, alphas,
                               n_iters, backend)

        def device_ms(self) -> float:
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self.events)

    return Recorded


def lp_requests(n: int, count: int, widths, seed: int, n_iters: int,
                **extra) -> list:
    """Seeded requests: 10 % of the rows labeled in each column."""
    from repro_torch.serving import PropagateRequest

    rng = np.random.RandomState(seed)
    return [PropagateRequest(
        (rng.rand(n, int(rng.choice(widths))) > 0.9).astype(np.float32),
        alpha=float(rng.choice(LP_ALPHAS)), n_iters=n_iters, **extra)
        for _ in range(count)]


def engine_vs_direct(vdt, backend: str, bitwise: bool) -> float:
    """(a): 6 requests through the engine (one group) against a direct
    batched call on the engine's padded stack and against each request's
    solo call; returns the largest error against the solo calls."""
    import torch
    from repro_torch.kernels.fused_lp import folded_step
    from repro_torch.serving import DEFAULT_WIDTH_BUCKETS
    from repro_torch.serving._batching import bucket_width

    n = vdt.tree.n_points
    reqs = lp_requests(n, 6, (1, 2, 3), 21, LP_CHECK_ITERS)
    cb = bucket_width(max(r.y0.shape[1] for r in reqs), DEFAULT_WIDTH_BUCKETS)
    eng = lp_engine_class()(vdt, start=False, max_batch=8, backend=backend,
                            keep=True)
    futs = [eng.submit(r) for r in reqs]
    k1 = folded_step.launches
    eng.flush()
    k1 = folded_step.launches - k1
    check(len(eng.scans) == 1, f"{backend}: {len(eng.scans)} dispatches")
    stack, alphas, out, n_iters, _ = eng.scans[0]
    check(stack.device.type == "cuda" and tuple(stack.shape) == (8, n, cb),
          f"{backend}: stack {tuple(stack.shape)} on {stack.device}")
    if backend == "exact":
        check(k1 == LP_CHECK_ITERS, f"exact: {k1} K1 launches")
    direct = vdt.label_propagate(stack, alpha=alphas, n_iters=n_iters,
                                 batched=True, backend=backend)
    same = torch.equal(out, direct)
    what = "bit for bit" if bitwise else "within rtol=1e-4, atol=1e-5"
    print(f"  {backend}: one dispatch of {len(reqs)} requests, (8, {n}, {cb})"
          f" stack, K={8 * cb}; engine == direct call on the same stack: "
          f"{'bit for bit' if same else 'not bit for bit'} (held {what})")
    if bitwise:
        check(same, f"{backend}: engine differs from the direct call")
    else:
        close(out, direct, f"{backend} engine vs direct")
    worst = 0.0
    for k, (f, r) in enumerate(zip(futs, reqs)):
        got = f.result(timeout=0)
        check(isinstance(got, np.ndarray) and got.shape == r.y0.shape,
              f"{backend}: answer {k} is {type(got)} {np.shape(got)}")
        solo = vdt.label_propagate(torch.as_tensor(r.y0, device="cuda"),
                                   alpha=r.alpha, n_iters=r.n_iters,
                                   backend=backend)
        worst = max(worst, close(torch.as_tensor(got), solo,
                                 f"{backend} request {k} (C={r.y0.shape[1]},"
                                 f" alpha={r.alpha}) vs its solo call")[0])
    return worst


class _InjectingModel:
    """The fitted model, with an urgent request submitted to ``engine`` as
    the first resumed segment of a walk returns (a mid-flight arrival)."""

    def __init__(self, inner, request):
        self._inner, self._request = inner, request
        self.engine = self.urgent = None
        self.done = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def label_propagate_resume(self, *args, **kwargs):
        out = self._inner.label_propagate_resume(*args, **kwargs)
        if self.urgent is None:
            self.urgent = self.engine.submit(self._request)
            self.urgent.add_done_callback(
                lambda f: self.done.setdefault("urgent", time.perf_counter()))
        return out


def engine_preempt(vdt) -> dict:
    """(b): one 50-iteration exact request in segments of 5 under edf, an
    urgent one injected at the first segment boundary."""
    import torch
    from repro_torch.kernels.fused_lp import folded_step
    from repro_torch.serving import PropagateRequest

    n = vdt.tree.n_points
    (bulk_req,) = lp_requests(n, 1, (2,), 22, PREEMPT_ITERS,
                              deadline_ms=600_000.0)
    (urgent_req,) = lp_requests(n, 1, (1,), 23, LP_CHECK_ITERS // 2,
                                deadline_ms=PREEMPT_DEADLINE_MS)
    model = _InjectingModel(vdt, urgent_req)
    eng = lp_engine_class()(model, start=False, policy="edf",
                            segment_iters=PREEMPT_SEGMENT, backend="exact")
    model.engine = eng
    bulk = eng.submit(bulk_req)
    bulk.add_done_callback(
        lambda f: model.done.setdefault("bulk", time.perf_counter()))
    k1 = folded_step.launches
    t0 = time.perf_counter()
    eng.step()
    wall = time.perf_counter() - t0
    k1 = folded_step.launches - k1
    m = eng.metrics()
    urgent = model.urgent.result(timeout=0)
    print(f"  edf, segment_iters={PREEMPT_SEGMENT}: a {PREEMPT_ITERS}-"
          f"iteration exact request, an urgent one (deadline "
          f"{PREEMPT_DEADLINE_MS:.0f} ms, {urgent_req.n_iters} iterations) "
          f"injected after the first segment: preemptions {m.preemptions}, "
          f"preempt_iters {m.preempt_iters}, completed {m.completed}, "
          f"expired {m.expired}, deadline_missed {m.deadline_missed}; urgent "
          f"answered {1e3 * (model.done['urgent'] - t0):.0f} ms into the "
          f"dispatch, the walk {1e3 * (model.done['bulk'] - t0):.0f} ms "
          f"({wall:.2f} s wall); K1 launches {k1}")
    check(m.preemptions >= 1, "preempt: the walk never yielded")
    check(m.completed == 2 and m.expired == 0 and m.deadline_missed == 0,
          f"preempt: completed {m.completed}, expired {m.expired}, missed "
          f"{m.deadline_missed}")
    check(urgent.shape == urgent_req.y0.shape and np.isfinite(urgent).all(),
          "preempt: bad urgent answer")
    check(model.done["urgent"] < model.done["bulk"],
          "preempt: the urgent request waited for the walk")
    check(k1 == PREEMPT_ITERS + urgent_req.n_iters,
          f"preempt: {k1} K1 launches")
    stack = np.zeros((1, n, 2), np.float32)
    stack[0] = bulk_req.y0
    mono = vdt.label_propagate(torch.as_tensor(stack, device="cuda"),
                               alpha=np.array([bulk_req.alpha], np.float32),
                               n_iters=PREEMPT_ITERS, batched=True,
                               backend="exact")
    same = np.array_equal(bulk.result(timeout=0), mono[0].cpu().numpy())
    print(f"  the suspended walk == the monolithic exact scan: "
          f"{'bit for bit' if same else 'NOT bit for bit'}")
    check(same, "preempt: the segmented walk differs from the monolithic one")
    return dict(preemptions=m.preemptions, preempt_iters=m.preempt_iters,
                urgent_ms=1e3 * (model.done["urgent"] - t0))


def engine_throughput(vdt) -> dict:
    """(c): the reference benchmark's ``uniform`` scenario at full scale:
    the serial loop of direct calls, then 1, 4 and 16 closed-loop clients
    against a fresh warmed engine."""
    import threading

    import torch

    n = vdt.tree.n_points
    reqs = lp_requests(n, TP_REQUESTS, TP_WIDTHS, 24, TP_ITERS)
    for c in sorted(set(r.y0.shape[1] for r in reqs)):   # warm each shape
        vdt.label_propagate(torch.zeros((n, c), device="cuda"), alpha=0.01,
                            n_iters=TP_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        vdt.label_propagate(torch.as_tensor(r.y0, device="cuda"),
                            alpha=r.alpha, n_iters=r.n_iters).cpu()
    serial_s = time.perf_counter() - t0
    serial_rps = TP_REQUESTS / serial_s
    print(f"  serial loop of direct calls: {serial_s:.2f} s, "
          f"{serial_rps:.1f} requests/s")
    levels = []
    for k in TP_CLIENTS:
        with lp_engine_class()(vdt, max_batch=TP_MAX_BATCH,
                               max_wait_ms=TP_MAX_WAIT_MS,
                               max_queue=4 * TP_MAX_BATCH) as eng:
            warmed = eng.warmup(widths=TP_WIDTHS, n_iters=(TP_ITERS,))
            eng.device_ms()
            eng.events.clear()

            def client(cid):
                for r in reqs[cid::k]:
                    eng.submit(r).result(timeout=600)

            before = eng.metrics()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(k)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            m = eng.metrics()
            device_s = eng.device_ms() / 1e3
        dispatches = m.dispatches - before.dispatches
        row = dict(clients=k, wall_s=wall, rps=TP_REQUESTS / wall,
                   speedup=TP_REQUESTS / wall / serial_rps,
                   occupancy=(m.batched_requests - before.batched_requests)
                   / max(1, dispatches),
                   dispatches=dispatches, p50_ms=m.latency_p50_ms,
                   p95_ms=m.latency_p95_ms, device_share=device_s / wall,
                   warmed=warmed)
        check(m.completed - before.completed == TP_REQUESTS and m.failed == 0,
              f"throughput: {m.completed} completed, {m.failed} failed")
        print(f"  {k:2d} clients: {row['rps']:.1f} requests/s "
              f"({row['speedup']:.2f} x serial), occupancy "
              f"{row['occupancy']:.1f}, {dispatches} dispatches, p50 "
              f"{row['p50_ms']:.1f} ms, p95 {row['p95_ms']:.1f} ms, "
              f"device time (CUDA events around each dispatch) / wall "
              f"{row['device_share']:.3f}; warmup {warmed} shapes")
        levels.append(row)
    return dict(serial_s=serial_s, serial_rps=serial_rps, levels=levels)


def engine_wide_exact(vdt, k1_k16_ms: float) -> dict:
    """(d): 8 requests of width 8 (folded K = 64) through the exact engine,
    beside K1's K = 16 time from this run and a direct K1 launch at K = 64."""
    import torch
    from repro_torch.kernels.fused_lp import alpha_row, folded_step

    n = vdt.tree.n_points
    reqs = lp_requests(n, 8, (8,), 25, LP_CHECK_ITERS)
    eng = lp_engine_class()(vdt, start=False, max_batch=8, backend="exact")
    futs = [eng.submit(r) for r in reqs]
    k1 = folded_step.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.flush()
    wall = time.perf_counter() - t0
    k1 = folded_step.launches - k1
    ms = eng.device_ms() / LP_CHECK_ITERS
    check(k1 == LP_CHECK_ITERS and all(f.done() for f in futs),
          f"wide exact: {k1} K1 launches")
    x = vdt.x_rows
    y = torch.rand((n, 64), device="cuda")
    al = alpha_row(torch.full((64,), 0.05), 64, "cuda")
    inv = float(1.0 / (2.0 * float(vdt.sigma) ** 2))
    direct_ms = cuda_ms(lambda: folded_step(x, x, y, y, al, inv), 2)
    d = x.shape[1]
    bound_ms, by, _ = tc_bound(n, n, d, 64, 4.0 * (n * d + 3 * n * 64 + 64))
    print(f"  exact, 8 requests of width 8 (K=64), {LP_CHECK_ITERS} "
          f"iterations: {ms:.2f} ms per iteration on the device "
          f"({wall / LP_CHECK_ITERS * 1e3:.2f} ms wall), K1 launches {k1}; "
          f"a direct K1 launch at K=64 {direct_ms:.2f} ms, bound "
          f"{bound_ms:.2f} ms ({by}), {bound_ms / direct_ms:.3f} of it; K1 "
          f"at K=16 {k1_k16_ms:.2f} ms in this run: {ms / k1_k16_ms:.2f} x")
    return dict(ms_per_iter=ms, wall_ms_per_iter=wall / LP_CHECK_ITERS * 1e3,
                k1_k64_ms=direct_ms, k1_k64_bound_ms=bound_ms,
                k1_k16_ms=k1_k16_ms, ratio=ms / k1_k16_ms)


def engine_grf(vdt) -> dict:
    """(e): one grf group (an explicit budget, an rtol-sized one, the
    default) on the VDT -> GRF bridge model: the dispatch runs at the
    largest budget and equals a direct call bit for bit."""
    import torch
    from repro_torch.core.grf import walkers_for_rtol
    from repro_torch.kernels.grf import grf_feature_matvec

    n = vdt.tree.n_points
    reqs = (lp_requests(n, 1, (2,), 26, VDT_GRF_ITERS, n_walkers=96)
            + lp_requests(n, 1, (1,), 27, VDT_GRF_ITERS, rtol=0.1)
            + lp_requests(n, 1, (3,), 28, VDT_GRF_ITERS))
    eng = lp_engine_class()(vdt, start=False, backend="grf", n_walkers=64,
                            grf_seed=GRF_SEED, keep=True)
    futs = [eng.submit(r) for r in reqs]
    k5 = grf_feature_matvec.launches
    eng.flush()
    k5 = grf_feature_matvec.launches - k5
    budgets = [eng._walker_budget(r) for r in reqs]
    (stack, alphas, out, n_iters, used), = eng.scans
    want = max(96, walkers_for_rtol(0.1), 64)
    direct = vdt.label_propagate(stack, alpha=alphas, n_iters=n_iters,
                                 batched=True, backend="grf", n_walkers=used,
                                 seed=GRF_SEED)
    same = torch.equal(out, direct)
    print(f"  grf at N={n}: budgets {budgets}, the dispatch ran {used} "
          f"walkers a point (metrics: {eng.metrics().n_walkers}); K5 "
          f"launches {k5}; engine == direct call (n_walkers={used}, "
          f"seed={GRF_SEED}): {'bit for bit' if same else 'NOT bit for bit'}")
    check(used == max(budgets) == want, f"grf: ran {used} walkers")
    check(k5 == VDT_GRF_ITERS, f"grf: {k5} K5 launches")
    check(same, "grf: engine differs from the direct call")
    for k, (f, r) in enumerate(zip(futs, reqs)):
        got = f.result(timeout=0)
        check(np.array_equal(got, out[k, :, :r.y0.shape[1]].cpu().numpy()),
              f"grf: answer {k} is not its slot of the dispatch")
    return dict(n_walkers=used, budgets=budgets)


def phase_lp_engine(out, after, vdt_grf) -> dict:
    """The label-propagation serving engine on the card: (a) engine vs
    direct calls on both backends, (b) preemption, (c) throughput, (d) the
    exact dispatch at folded K > 16, (e) grf through the engine."""
    import torch

    vdt = out["vdt"]
    print(f"[lp engine] PropagateEngine over the fitted SecStr model "
          f"(N={vdt.tree.n_points}), on the card")
    stack = torch.as_tensor(np.stack([r.y0[:, :1] for r in lp_requests(
        vdt.tree.n_points, 4, (1,), 20, 1)]), device="cuda")
    first, second = (vdt.label_propagate(stack, alpha=0.05,
                                         n_iters=LP_CHECK_ITERS, batched=True)
                     for _ in range(2))
    vdt_bitwise = torch.equal(first, second)
    agree = "bit for bit" if vdt_bitwise else \
        "only within tolerance (index_add_ reduces with atomics)"
    print(f"  (a) two direct vdt calls on the card agree {agree}")
    err = {be: engine_vs_direct(vdt, be, be == "exact" or vdt_bitwise)
           for be in ("exact", "vdt")}
    print("  (b) preemption")
    pre = engine_preempt(vdt)
    print(f"  (c) throughput: {TP_REQUESTS} requests, widths {TP_WIDTHS}, "
          f"alphas {LP_ALPHAS}, {TP_ITERS} iterations, backend vdt, "
          f"max_batch={TP_MAX_BATCH}, max_wait_ms={TP_MAX_WAIT_MS:.0f}")
    tp = engine_throughput(vdt)
    print("  (d) the exact dispatch at folded K = 64")
    wide = engine_wide_exact(vdt, after["rows"][1]["ms"])
    print("  (e) grf through the engine")
    grf = engine_grf(vdt_grf)
    return dict(vdt_bitwise=vdt_bitwise, max_abs_err=err, preempt=pre,
                throughput=tp, wide_exact=wide, grf=grf)


def phase_ops(out) -> dict:
    """K2, K3, K4 through the reference's op entry points, counted, then checked."""
    import torch
    from repro_torch.kernels.fused_lp import (fused_lp_matvec,
                                              fused_lp_step_batched,
                                              matvec_plain,
                                              step_batched_perbatch_plain)
    from repro_torch.kernels.pairwise import (pairwise_sq_dists,
                                              pairwise_sq_dists_plain)

    vdt = out["vdt"]
    x, sigma = vdt.x_rows, float(vdt.sigma)
    inv = float(1.0 / (2.0 * sigma * sigma))
    n, d = x.shape
    y = out["y0"]
    xs = x[:K3_N].contiguous()
    ys = out["y0s"][:, :K3_N].contiguous()
    xb = x[:K4_ROWS].contiguous()
    print(f"[ops] K2 fused_lp_matvec N={n} C=2; K3 fused_lp_step_batched("
          f"reuse=False) B={K3_BATCH} N={K3_N}; K4 pairwise_sq_dists "
          f"{K4_ROWS} x {n}, d={d}")
    reset_counts()
    k2 = fused_lp_matvec(x, y, sigma)
    k3 = fused_lp_step_batched(xs, ys, ys, sigma, 0.01, reuse=False)
    k4 = pairwise_sq_dists(xb, x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  launches {counts}")
    for k in ("K2", "K3", "K4"):
        check(counts[k] == 1, f"{k} launched {counts[k]} times, expected 1")
    check_tc_route(counts, ("K2", "K3", "K4"))

    rows = {}
    err = close(k2, matvec_plain(x, y, inv), "K2 vs plain")[0]
    rows["K2"] = dict(
        err=err, ms=cuda_ms(lambda: fused_lp_matvec(x, y, sigma), 2),
        plain_ms=cuda_ms(lambda: matvec_plain(x, y, inv), 1),
        bound=tc_bound(n, n, d, 2, 4.0 * (n * d + 2 * n * 2)),
        shape=f"N={n} d={d} C=2")
    err = close(k3, step_batched_perbatch_plain(xs, ys, ys, 0.01, inv),
                "K3 vs plain")[0]
    rows["K3"] = dict(
        err=err, ms=cuda_ms(lambda: fused_lp_step_batched(
            xs, ys, ys, sigma, 0.01, reuse=False), 2),
        plain_ms=cuda_ms(lambda: step_batched_perbatch_plain(
            xs, ys, ys, 0.01, inv), 1),
        bound=tc_bound(K3_BATCH * K3_N, K3_N, d, 2,
                       4.0 * (K3_N * d + 3 * K3_BATCH * K3_N * 2)),
        shape=f"B={K3_BATCH} N={K3_N} d={d} C=2")
    err = close(k4, pairwise_sq_dists_plain(xb, x), "K4 vs plain (f32)")[0]
    close(pairwise_sq_dists(xb.bfloat16(), x.bfloat16()),
          pairwise_sq_dists_plain(xb.bfloat16(), x.bfloat16()),
          "K4 vs plain (bf16)", 5e-2, 5e-2)
    # the library yardstick: cdist returns the square root of K4's output
    dist = torch.cdist(xb, x, compute_mode="use_mm_for_euclid_dist")
    print(f"  torch.cdist(use_mm)^2 vs K4: max_abs_diff="
          f"{float((dist.square() - k4).abs().max()):.3e} (not a check)")
    del dist
    # kernel, cdist, kernel, cdist: the two are compared only in one run
    def k4_run():
        return pairwise_sq_dists(xb, x)

    def cdist():
        return torch.cdist(xb, x, compute_mode="use_mm_for_euclid_dist")

    ms, lib_ms, ms2, lib_ms2 = (cuda_ms(fn, 10) for fn in (k4_run, cdist,
                                                            k4_run, cdist))
    rows["K4"] = dict(
        err=err, ms=ms, ms2=ms2, lib_ms=lib_ms, lib_ms2=lib_ms2,
        plain_ms=cuda_ms(lambda: pairwise_sq_dists_plain(xb, x), 5),
        bound=tc_bound(K4_ROWS, n, d, 0,
                       4.0 * (K4_ROWS * d + n * d + K4_ROWS * n)),
        shape=f"M={K4_ROWS} N={n} d={d} f32")
    for k, r in rows.items():
        lib = (f", torch.cdist {r['lib_ms']:.4f} / {r['lib_ms2']:.4f} ms "
               f"(K4 / cdist {r['ms'] / r['lib_ms']:.3f})"
               if "lib_ms" in r else "")
        again = f" / {r['ms2']:.4f}" if "ms2" in r else ""
        b_ms, by, f32_ms = r["bound"]
        print(f"  {k} {r['shape']}: {r['ms']:.4f}{again} ms per launch, plain "
              f"{r['plain_ms']:.3f} ms{lib}, bound {b_ms:.4f} ms ({by}; 3xTF32"
              f" on the tensor cores), {b_ms / r['ms']:.3f} of it; float32 "
              f"CUDA-core bound {f32_ms:.4f} ms, {f32_ms / r['ms']:.3f} of it")
    return dict(rows=rows, counts=counts)


def phase_single_point() -> None:
    """N = 1: every column is masked; the reference divides by 256."""
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain, matvec_plain,
                                              matvec_step, perbatch_step,
                                              step_batched_perbatch_plain)

    print("[N = 1 through K1, K2, K3]")
    x = torch.tensor([[0.3, 0.5]], device="cuda")
    y = torch.tensor([[2.0, 3.0]], device="cuda")
    y0 = torch.tensor([[1.0, 5.0]], device="cuda")
    al = alpha_row(0.3, 2, "cuda")
    want = 0.3 * y / 256 + 0.7 * y0
    for name, got, plain in (
            ("K1", folded_step(x, x, y, y0, al, 0.5),
             folded_step_plain(x, x, y, y0, al, 0.5)),
            ("K2", matvec_step(x, y, 0.5), matvec_plain(x, y, 0.5)),
            ("K3", perbatch_step(x, y[None], y0[None], 0.3, 0.5)[0],
             step_batched_perbatch_plain(x, y[None], y0[None], 0.3, 0.5)[0])):
        close(got, plain, f"{name} vs plain")
        close(got, y / 256 if name == "K2" else want,
              f"{name} vs the reference's value")


def positive_gaussian(rng, n: int, d: int) -> np.ndarray:
    """|N(0, 1)| + 0.1: the reference streaming tests' positive points."""
    return (np.abs(rng.randn(n, d)) + 0.1).astype(np.float32)


def div_routes(d: int) -> list:
    """(label, divergence) of the three new K1 routes: ``kl``,
    ``itakura_saito`` and a Mahalanobis scale of length d drawn from
    ``DIV_SCALE_SEED`` (so its digest-named path runs)."""
    from repro_torch.core.divergence import mahalanobis

    scale = np.random.RandomState(DIV_SCALE_SEED).uniform(0.5, 2.0, d)
    return [("kl", "kl"), ("itakura_saito", "itakura_saito"),
            ("mahalanobis", mahalanobis(scale))]


def tile_inputs(spec, x):
    """``x`` (a card tensor) under the route's point pre-map, its tile and
    the tile's plain form (``None``: the squared-Euclidean tile)."""
    from repro_torch.kernels.fused_lp import tile_config

    tile, _, transform = tile_config(spec)
    if transform is not None:
        x = transform(x).contiguous()
    return x, tile, None if tile is None else tile.tile


def span_inv(xd, tile_fn) -> float:
    """1 / (2 sigma^2) that makes a row of logits span ``GATE_SPAN`` units on
    average (first 64 rows, float64), as ``GATE_INV_TSS`` does for the
    squared-Euclidean gate."""
    import torch

    head = xd[:64]
    if tile_fn is None:
        d2 = ((head * head).sum(1)[:, None] + (xd * xd).sum(1)[None, :]
              - 2.0 * (head @ xd.T))
    else:
        d2 = tile_fn(head, xd)
    idx = torch.arange(head.shape[0], device=xd.device)
    d2[idx, idx] = float("nan")
    span = float((d2.nan_to_num(-1.0).amax(1)
                  - d2.nan_to_num(1e30).amin(1)).mean())
    return GATE_SPAN / span


def phase_div_small() -> dict:
    """K1 on each divergence route against its plain version at small odd
    shapes (a ``row_base`` stripe among them); K2 and K3 are held per route
    at their [ops] shapes (``phase_div_ops``)."""
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain, kernel_tile)

    print("[divergences: K1 vs plain on each route, small shapes]")
    rng = np.random.RandomState(DIV_SCALE_SEED + 1)
    errs = {}
    for label, spec in div_routes(D_SECSTR):
        worst = 0.0
        for n, k, row_base in ((1_000, 2, 0), (4_099, 16, 0), (257, 33, 0),
                               (300, 5, 37)):
            x = torch.as_tensor(positive_gaussian(rng, n, D_SECSTR),
                                device="cuda")
            x, tile, fn = tile_inputs(spec, x)
            inv = span_inv(x.double(), fn)
            y = torch.as_tensor(rng.rand(n, k).astype(np.float32),
                                device="cuda")
            al = alpha_row(torch.as_tensor(rng.rand(k).astype(np.float32)),
                           k, "cuda")
            rows, y0 = x[row_base:].contiguous(), y[row_base:].contiguous()
            before = folded_step.launches_by_tile[kernel_tile(tile)]
            got = folded_step(rows, x, y, y0, al, inv, row_base, tile=tile)
            check(folded_step.launches_by_tile[kernel_tile(tile)]
                  == before + 1, f"{label}: K1 not counted on its tile")
            worst = max(worst, close(
                got, folded_step_plain(rows, x, y, y0, al, inv, row_base,
                                       tile_fn=fn),
                f"{label} K1 N={n} K={k} row_base={row_base}")[0])
        errs[label] = worst
    return errs


def phase_div_gate() -> dict:
    """The float64 gate per route, and K1's time on every tile in turns: on
    positive Gaussian points (d = 315) at N = 16,384, K = 2 and 16."""
    import torch
    from repro_torch.kernels.fused_lp import folded_step, folded_step_plain

    print(f"[divergence gate] |N(0,1)| + 0.1, d={D_SECSTR}, N={GATE_N_K1}: "
          f"K1 vs float64 within {GATE_RATIO} x the plain float32 version's"
          f" error; logits spanning {GATE_SPAN} units a row")
    rng = np.random.RandomState(GATE_SEED + 1)
    x0 = torch.as_tensor(positive_gaussian(rng, GATE_N_K1, D_SECSTR),
                         device="cuda")
    routes = [("sqeuclidean", None)] + div_routes(D_SECSTR)
    inputs, gate = {}, {}
    for label, spec in routes:
        x, tile, fn = tile_inputs(spec, x0)
        xd = x.double()
        inv = span_inv(xd, fn)
        inputs[label] = (x, tile, fn, inv)
        if spec is None:
            continue
        for k in (2, 16):
            y = torch.as_tensor(rng.rand(GATE_N_K1, k).astype(np.float32),
                                device="cuda")
            al = torch.as_tensor(rng.rand(k).astype(np.float32),
                                 device="cuda")
            ref = folded_step_plain(xd, xd, y.double(), y.double(),
                                    al.double(), inv, tile_fn=fn)
            gate[f"{label} K={k}"] = gate_check(
                f"K1 {label} N={GATE_N_K1} K={k}",
                folded_step(x, x, y, y, al, inv, tile=tile),
                folded_step_plain(x, x, y, y, al, inv, tile_fn=fn), ref)
    failed = [k for k, v in gate.items() if not v["ok"]]
    check(not failed, f"divergence gate failed for {failed}")

    print(f"[K1 timing per tile] N={GATE_N_K1} d={D_SECSTR}, in turns "
          f"(squared Euclidean first and last)")
    timing = {}
    n, d = GATE_N_K1, D_SECSTR
    for k in (2, 16):
        y = torch.as_tensor(rng.rand(n, k).astype(np.float32), device="cuda")
        al = torch.as_tensor(rng.rand(k).astype(np.float32), device="cuda")
        order = [r[0] for r in routes]
        ms = {label: [] for label in order}
        for label in order + order[::-1]:
            x, tile, _, inv = inputs[label]
            ms[label].append(cuda_ms(
                lambda: folded_step(x, x, y, y, al, inv, tile=tile), 5))
        for label in order:
            x, _, fn, inv = inputs[label]
            plain_ms = cuda_ms(lambda: folded_step_plain(
                x, x, y, y, al, inv, tile_fn=fn), 1)
            bound_ms, by, _ = tc_bound(n, n, d, k,
                                       4.0 * (n * d + 3 * n * k + k))
            rel = ms[label][0] / ms["sqeuclidean"][0]
            print(f"  K={k} {label}: K1 {ms[label][0]:.3f} / "
                  f"{ms[label][1]:.3f} ms, {rel:.3f} x squared Euclidean; "
                  f"plain {plain_ms:.2f} ms; bound {bound_ms:.3f} ms ({by}),"
                  f" {bound_ms / ms[label][0]:.3f} of it")
            timing[f"{label} K={k}"] = dict(
                ms=ms[label][0], ms2=ms[label][1], plain_ms=plain_ms,
                bound_ms=bound_ms, by=by, vs_sqeuclidean=rel)
    return dict(gate=gate, timing=timing)


def phase_divergences(data) -> dict:
    """[divergences], the routes' main path: a ``kl`` fit at SecStr scale on
    the positive orthant (x + 0.1, |B| = 4N) with 50 exact iterations
    through K1; ``itakura_saito`` and the Mahalanobis scale fitted at
    N = 16,384, d = 315, with 10 exact iterations each."""
    import torch
    from repro_torch import VariationalDualTree, one_hot_labels
    from repro_torch.core.divergence import resolve_divergence
    from repro_torch.data.synthetic import secstr_like
    from repro_torch.kernels.fused_lp import folded_step, kernel_tile, \
        tile_config

    small = secstr_like(DIV_N, D_SECSTR, seed=DIV_DATA_SEED)
    runs = {}
    for (label, spec), d_set, iters in zip(
            div_routes(D_SECSTR), (data, small, small),
            (DIV_ITERS, DIV_SMALL_ITERS, DIV_SMALL_ITERS)):
        x = d_set.x + DIV_SHIFT
        n = x.shape[0]
        print(f"[divergences: {label}] fit N={n} d={x.shape[1]} |B|=4N on "
              f"x + {DIV_SHIFT}, then {iters} exact iterations through K1")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vdt = VariationalDualTree.fit(x, max_blocks=4 * n, refine_batch=512,
                                      sigma_iters=3, divergence=spec)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        s = vdt.stats
        print(f"  fit {fit_s:.2f} s: build_tree {s.build_tree_s:.2f} s, "
              f"sigma+q {s.init_qopt_s:.2f} s ({s.sigma_iters} sigma iters),"
              f" refine {s.refine_s:.2f} s; divergence {vdt.divergence_name},"
              f" n_blocks={vdt.n_blocks} sigma={s.sigma:.6f} bound="
              f"{s.bound:.6e}; max_memory_allocated="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(vdt.device.type == "cuda" and np.isfinite(s.bound)
              and vdt.n_blocks >= 4 * n, f"{label}: bad fit")
        check(vdt.divergence_name == resolve_divergence(spec).name,
              f"{label}: fitted {vdt.divergence_name}")
        mask = np.random.RandomState(11).rand(n) < 0.10
        y0 = one_hot_labels(d_set.labels, mask, d_set.n_classes)
        res_vdt = vdt.label_propagate(y0, alpha=0.01, n_iters=VDT_ITERS)
        check(bool(torch.isfinite(res_vdt).all()), f"{label}: vdt non-finite")
        tile = kernel_tile(tile_config(spec)[0])
        before, before_tile = folded_step.launches, \
            folded_step.launches_by_tile[tile]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vdt.label_propagate(y0, alpha=0.01, n_iters=iters,
                                  backend="exact")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = folded_step.launches - before
        check(launches == iters and folded_step.launches_by_tile[tile]
              - before_tile == iters,
              f"{label}: {launches} K1 launches for {iters} iterations")
        check(bool(torch.isfinite(res).all()), f"{label}: exact non-finite")
        agree = float((res.argmax(-1) == res_vdt.argmax(-1)).float().mean())
        print(f"  exact: {sec / iters * 1e3:.1f} ms per iteration, K1 "
              f"launches {launches} on the {tile} tile, argmax agreement "
              f"with vdt {agree:.4f}")
        runs[label] = dict(vdt=vdt, y0=y0, res_vdt=res_vdt, spec=spec,
                           launches=launches, tile=tile, fit_s=fit_s,
                           refine_s=s.refine_s, exact_ms=sec / iters * 1e3,
                           n=n)
    return runs


def phase_div_after(runs) -> dict:
    """The routes' first 2 exact iterations against the plain version on the
    card, the kl model's VDT LP against a CPU copy, and K1's time at each
    route's path shape (K = 2)."""
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain)

    print("[divergences: first 2 exact iterations, K1 vs plain on the card; "
          "K1 timing at the path's shapes]")
    rows = {}
    for label, r in runs.items():
        vdt, y0 = r["vdt"], r["y0"]
        x, tile, fn = tile_inputs(r["spec"], vdt.x_rows)
        sigma = float(vdt.sigma)
        inv = float(1.0 / (2.0 * sigma * sigma))
        al = alpha_row(0.01, y0.shape[1], "cuda")
        got = vdt.label_propagate(y0, alpha=0.01, n_iters=2, backend="exact")
        want = y0
        for _ in range(2):
            want = folded_step_plain(x, x, want, y0, al, inv, tile_fn=fn)
        err = close(got, want, f"{label} N={r['n']} K={y0.shape[1]}")[0]
        n, d = x.shape
        k = y0.shape[1]
        plain_ms = cuda_ms(lambda: folded_step_plain(x, x, y0, y0, al, inv,
                                                     tile_fn=fn), 1)
        # in turns with the squared-Euclidean tile on the same points, once
        # with the rows as the columns (one split, as a scan launches it) and
        # once with the columns a copy (two splits, two operand arrays in
        # L2, as the kl and itakura_saito tiles always have)
        xc = x.clone()
        fns = {"tile": lambda: folded_step(x, x, y0, y0, al, inv, tile=tile),
               "sq": lambda: folded_step(x, x, y0, y0, al, inv),
               "sq_two_operands": lambda: folded_step(x, xc, y0, y0, al, inv)}
        turns = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            turns[name].append(cuda_ms(fns[name], 3))
        del xc
        ms, ms2 = turns["tile"]
        print(f"  {label} at N={n} K={k}, in turns (ms per launch): its tile "
              f"{ms:.2f} / {ms2:.2f}; squared-Euclidean tile on the same "
              f"points {turns['sq'][0]:.2f} / {turns['sq'][1]:.2f}, with the "
              f"columns a copy {turns['sq_two_operands'][0]:.2f} / "
              f"{turns['sq_two_operands'][1]:.2f}")
        bound_ms, by, f32_ms = tc_bound(n, n, d, k,
                                        4.0 * (n * d + 3 * n * k + k))
        print(f"  {label} K1 at N={n} K={k}: {ms:.2f} / {ms2:.2f} ms per "
              f"launch, plain {plain_ms:.2f} ms, bound {bound_ms:.2f} ms "
              f"({by}), {bound_ms / ms:.3f} of it; float32 CUDA-core bound "
              f"{f32_ms:.2f} ms")
        rows[label] = dict(err=err, ms=ms, ms2=ms2, plain_ms=plain_ms,
                           bound_ms=bound_ms, by=by, shape=f"N={n} d={d} "
                           f"K={k}", launches=r["launches"], tile=r["tile"],
                           sq_ms=turns["sq"],
                           sq_two_operands_ms=turns["sq_two_operands"],
                           fit_s=r["fit_s"], refine_s=r["refine_s"],
                           exact_ms_per_iter=r["exact_ms"],
                           divergence=vdt.divergence_name)
    kl = runs["kl"]
    cpu = kl["vdt"].to("cpu")
    close(kl["res_vdt"], cpu.label_propagate(kl["y0"].cpu(), alpha=0.01,
                                             n_iters=VDT_ITERS),
          "kl vdt LP on the card vs a CPU copy")
    return rows


def phase_div_ops(data) -> dict:
    """K2 and K3 on each divergence route through the reference's op entry
    points at their [ops] shapes (K2: N = 83,679, C = 2; K3: B = 8,
    N = 16,384, C = 2) on the SecStr points + 0.1: one launch each, counted,
    against the plain version on the same mapped points, timed."""
    import torch
    from repro_torch.kernels.fused_lp import (fused_lp_matvec,
                                              fused_lp_step_batched,
                                              kernel_tile, matvec_plain,
                                              step_batched_perbatch_plain)

    print(f"[divergences: K2 and K3 at the [ops] shapes] K2 N={N_SECSTR} "
          f"C=2, K3 B={K3_BATCH} N={K3_N} C=2, on x + {DIV_SHIFT}")
    x = torch.as_tensor(data.x + DIV_SHIFT, device="cuda")
    xs = x[:K3_N].contiguous()
    rng = np.random.RandomState(DIV_SCALE_SEED + 2)
    y = torch.as_tensor((rng.rand(N_SECSTR, 2) > 0.9).astype(np.float32),
                        device="cuda")
    ys = torch.as_tensor((rng.rand(K3_BATCH, K3_N, 2) > 0.9)
                         .astype(np.float32), device="cuda")
    n, d = x.shape
    rows = {}
    for label, spec in div_routes(D_SECSTR):
        xt, tile, fn = tile_inputs(spec, x)
        xst = xt[:K3_N].contiguous()
        inv = span_inv(xst.double(), fn)
        sigma = (0.5 / inv) ** 0.5
        reset_counts()
        k2 = fused_lp_matvec(x, y, sigma, divergence=spec)
        k3 = fused_lp_step_batched(xs, ys, ys, sigma, 0.01, reuse=False,
                                   divergence=spec)
        torch.cuda.synchronize()
        counts = read_counts()
        name = kernel_tile(tile)
        for k in ("K2", "K3"):
            check(counts[k] == 1 and counts[f"{k} tile {name}"] == 1,
                  f"{label}: {k} launched {counts[k]} times")
        check_tc_route(counts, ("K2", "K3"))
        cases = (
            ("K2", k2, f"N={n} d={d} C=2",
             lambda: fused_lp_matvec(x, y, sigma, divergence=spec),
             lambda: matvec_plain(xt, y, inv, tile_fn=fn),
             tc_bound(n, n, d, 2, 4.0 * (n * d + 2 * n * 2))),
            ("K3", k3, f"B={K3_BATCH} N={K3_N} d={d} C=2",
             lambda: fused_lp_step_batched(xs, ys, ys, sigma, 0.01,
                                           reuse=False, divergence=spec),
             lambda: step_batched_perbatch_plain(xst, ys, ys, 0.01, inv,
                                                 tile_fn=fn),
             tc_bound(K3_BATCH * K3_N, K3_N, d, 2,
                      4.0 * (K3_N * d + 3 * K3_BATCH * K3_N * 2))))
        rows[label] = {}
        for k, got, shape, kernel, plain, (b_ms, by, _) in cases:
            err = close(got, plain(), f"{label} {k} {shape} vs plain")[0]
            ms, plain_ms = cuda_ms(kernel, 2), cuda_ms(plain, 1)
            print(f"  {label} {k}: {ms:.3f} ms per launch, plain "
                  f"{plain_ms:.2f} ms, bound {b_ms:.3f} ms ({by}), "
                  f"{b_ms / ms:.3f} of it")
            rows[label][k] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, by=by, shape=shape,
                                  launches=counts[k], tile=name)
    return rows


def recompute_check(what: str, vdt) -> None:
    """A streamed epoch against ``recompute`` on the card, at the limits of
    the reference's harness (``tests/test_streaming.py``)."""
    import torch
    from repro_torch.core.streaming import recompute

    ora = recompute(vdt)
    w_scale = max(1.0, float(ora.tree.W.abs().max()))
    for name in ("W", "S1", "S2"):
        close(getattr(vdt.tree, name), getattr(ora.tree, name),
              f"{what} {name} vs recompute", 2e-4, 1e-3 * w_scale)
    check(np.array_equal(vdt.bp.active, ora.bp.active),
          f"{what}: active differs from recompute")
    lq, lq_ora = vdt.qstate.log_q, ora.qstate.log_q
    fin = torch.isfinite(lq_ora)
    check(torch.equal(torch.isfinite(lq), fin),
          f"{what}: log_q -inf pattern differs from recompute")
    close(lq[fin], lq_ora[fin], f"{what} log_q vs recompute", 1e-3, 5e-4)
    y0 = torch.as_tensor((np.random.RandomState(5).rand(
        vdt.tree.n_points, 2) > 0.8).astype(np.float32), device="cuda")
    close(vdt.label_propagate(y0, alpha=0.1, n_iters=STREAM_LP_ITERS),
          ora.label_propagate(y0, alpha=0.1, n_iters=STREAM_LP_ITERS),
          f"{what} vdt LP vs recompute", 0.0, 2e-3)


def cpu_copy_check(what: str, upd, cpu_upd) -> None:
    """The card's epoch against the same mutation of a CPU copy: the same
    update, the same host-built tree (bit for bit), q-state and LP within
    the LP tolerance."""
    import torch

    check(np.array_equal(upd.rows, cpu_upd.rows)
          and (upd.row_map is None) == (cpu_upd.row_map is None)
          and (upd.row_map is None
               or np.array_equal(upd.row_map, cpu_upd.row_map))
          and (upd.touched_blocks, upd.stale_blocks)
          == (cpu_upd.touched_blocks, cpu_upd.stale_blocks),
          f"{what}: the update differs from the CPU copy's")
    for name in ("x_leaf", "w_leaf", "slot_of", "leaf_of", "W", "S1", "S2"):
        check(torch.equal(getattr(upd.vdt.tree, name).cpu(),
                          getattr(cpu_upd.vdt.tree, name)),
              f"{what}: tree {name} differs from the CPU copy's")
    check(np.array_equal(upd.vdt.bp.active, cpu_upd.vdt.bp.active),
          f"{what}: active differs from the CPU copy's")
    lq, lq_cpu = upd.vdt.qstate.log_q.cpu(), cpu_upd.vdt.qstate.log_q
    fin = torch.isfinite(lq_cpu)
    check(torch.equal(torch.isfinite(lq), fin),
          f"{what}: log_q -inf pattern differs from the CPU copy's")
    close(lq[fin], lq_cpu[fin], f"{what} log_q vs the CPU copy")
    y0 = (np.random.RandomState(6).rand(upd.vdt.tree.n_points, 2)
          > 0.8).astype(np.float32)
    close(upd.vdt.label_propagate(y0, alpha=0.1, n_iters=STREAM_LP_ITERS),
          cpu_upd.vdt.label_propagate(y0, alpha=0.1,
                                      n_iters=STREAM_LP_ITERS),
          f"{what} vdt LP vs the CPU copy")
    print(f"  {what}: update, tree (bit for bit) and partition equal the CPU"
          f" copy's")


def stream_publish(vdt0, upd) -> dict:
    """A streamed epoch published into a running ``PropagateEngine`` while
    its first dispatch is in flight: the entries queued before the publish
    resolve as on an engine that never saw it (bit for bit through K1,
    within the LP tolerance on vdt), those after it as on an engine of the
    new epoch."""
    import threading

    import torch
    from repro_torch.serving import PropagateEngine

    class Signalling(PropagateEngine):
        def __init__(self, *args, **kwargs):
            self.started = threading.Event()
            super().__init__(*args, **kwargs)

        def _scan(self, *args, **kwargs):
            self.started.set()
            return super()._scan(*args, **kwargs)

    vdt1 = upd.vdt
    n0, n1 = vdt0.tree.n_points, vdt1.tree.n_points
    out = {}
    for backend, iters in (("exact", STREAM_EXACT_ITERS),
                           ("vdt", VDT_ITERS)):
        reqs_old = lp_requests(n0, 4, (2,), 31, iters)
        reqs_new = lp_requests(n1, 4, (2,), 32, iters)

        def control(vdt, reqs):
            eng = PropagateEngine(vdt, start=False, max_batch=2,
                                  backend=backend)
            futs = [eng.submit(q) for q in reqs]
            eng.flush()
            res = [f.result(timeout=0) for f in futs]
            eng.shutdown()
            return res

        want_old, want_new = control(vdt0, reqs_old), control(vdt1, reqs_new)
        eng = Signalling(vdt0, max_batch=2, max_wait_ms=1.0, backend=backend)
        futs_old = [eng.submit(q) for q in reqs_old]
        check(eng.started.wait(120), f"publish {backend}: no dispatch began")
        eid = eng.publish(vdt1, patched_points=upd.patched_points,
                          stale_blocks=upd.stale_blocks)
        live = eng.metrics().live_epochs
        futs_new = [eng.submit(q) for q in reqs_new]
        got_old = [f.result(timeout=300) for f in futs_old]
        got_new = [f.result(timeout=300) for f in futs_new]
        eng.shutdown()
        m = eng.metrics()
        check(eid == 1 and live == 2 and m.epochs_published == 1
              and m.epochs_retired == 1 and m.live_epochs == 1,
              f"publish {backend}: epoch {eid}, live {live} then "
              f"{m.live_epochs}, retired {m.epochs_retired}")
        check([g.shape[0] for g in got_old] == [n0] * 4
              and [g.shape[0] for g in got_new] == [n1] * 4,
              f"publish {backend}: an answer of the wrong epoch")
        same = all(np.array_equal(g, w) for g, w in zip(got_old + got_new,
                                                       want_old + want_new))
        if backend == "exact":
            check(same, "publish exact: old or new answers differ from the "
                        "control engines' bit for bit")
        for g, w in zip(got_old + got_new, want_old + want_new):
            close(torch.as_tensor(g), torch.as_tensor(w),
                  f"publish {backend} answer vs control")
        print(f"  publish mid-flight, {backend}: epoch {eid} published while"
              f" dispatch 1 ran (live epochs {live}), 4 old + 4 new answers"
              f" == control engines {'bit for bit' if same else 'within '}"
              f"{'' if same else 'rtol=1e-4, atol=1e-5'}; retired "
              f"{m.epochs_retired}, patched_points {m.patched_points}, "
              f"stale_blocks {m.stale_blocks}")
        out[backend] = dict(bitwise=same, live_epochs_at_publish=live)
    return out


def phase_streaming(out) -> dict:
    """[streaming] on the fitted SecStr model of the main path: insert 4,096
    points into its ghost headroom, delete 4,096 rows, each epoch held to
    ``recompute`` on the card and to a CPU copy; exact LP on the streamed
    epoch through K1 against plain; a publish into a running engine; then
    stale-first refinement by 1 % of the blocks."""
    import torch
    from repro_torch.data.synthetic import secstr_like
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain)

    vdt0 = out["vdt"]
    tree = vdt0.tree
    n0 = tree.n_points
    print(f"[streaming] the main path's model: N={n0}, L={tree.L}, "
          f"{tree.n_leaves} leaf slots, {tree.n_leaves - n0} free; insert "
          f"{STREAM_K} (secstr_like seed {STREAM_SEED}), delete {STREAM_K}")
    x_new = secstr_like(STREAM_K, D_SECSTR, seed=STREAM_SEED).x
    cpu0 = vdt0.to("cpu")
    timings = {}
    t0 = time.perf_counter()
    ins = vdt0.insert_points(x_new)
    wall = time.perf_counter() - t0
    timings["insert"] = dict(wall_s=wall, **ins.seconds)
    print(f"  insert {STREAM_K}: {wall:.3f} s wall: mirrors "
          f"{ins.seconds['mirrors']:.3f} s, host patch "
          f"{ins.seconds['patch']:.3f} s, freeze {ins.seconds['freeze']:.3f}"
          f" s, optimize_q_from_g {ins.seconds['qopt']:.3f} s; touched "
          f"{ins.touched_blocks} blocks, stale {ins.stale_blocks}, n_blocks "
          f"{ins.vdt.n_blocks}")
    check(ins.vdt.tree.n_points == n0 + STREAM_K
          and np.array_equal(ins.rows, n0 + np.arange(STREAM_K)),
          "insert: bad rows")
    check(ins.vdt.device.type == "cuda", "insert: the epoch left the card")
    recompute_check("insert", ins.vdt)
    cpu_ins = cpu0.insert_points(x_new)
    cpu_copy_check("insert", ins, cpu_ins)

    rows = np.sort(np.random.RandomState(STREAM_SEED).choice(
        n0 + STREAM_K, STREAM_K, replace=False))
    t0 = time.perf_counter()
    dele = ins.vdt.delete_points(rows)
    wall = time.perf_counter() - t0
    timings["delete"] = dict(wall_s=wall, **dele.seconds)
    print(f"  delete {STREAM_K}: {wall:.3f} s wall: mirrors "
          f"{dele.seconds['mirrors']:.3f} s, host patch "
          f"{dele.seconds['patch']:.3f} s, freeze "
          f"{dele.seconds['freeze']:.3f} s, optimize_q_from_g "
          f"{dele.seconds['qopt']:.3f} s; touched {dele.touched_blocks} "
          f"blocks, stale {dele.stale_blocks}, n_blocks {dele.vdt.n_blocks}")
    check(dele.vdt.tree.n_points == n0 and int((dele.row_map >= 0).sum())
          == n0, "delete: bad row map")
    recompute_check("delete", dele.vdt)
    cpu_copy_check("delete", dele, cpu_ins.vdt.delete_points(rows))
    del cpu0, cpu_ins

    vdt = dele.vdt
    x = vdt.x_rows
    sigma = float(vdt.sigma)
    inv = float(1.0 / (2.0 * sigma * sigma))
    y0 = torch.as_tensor((np.random.RandomState(8).rand(n0, 2) > 0.9)
                         .astype(np.float32), device="cuda")
    al = alpha_row(0.01, 2, "cuda")
    before = folded_step.launches
    got = vdt.label_propagate(y0, alpha=0.01, n_iters=2, backend="exact")
    check(folded_step.launches - before == 2, "streamed exact: K1 launches")
    want = y0
    for _ in range(2):
        want = folded_step_plain(x, x, want, y0, al, inv)
    err = close(got, want, "streamed epoch exact LP (2 iterations) K1 vs "
                           "plain")[0]

    publish = stream_publish(vdt0, dele)

    stream = vdt._stream
    check(stream is not None and stream.owner() is vdt,
          "the streamed epoch lost its mirrors")
    stale = stream.stale[:vdt.bp.n].copy()
    refined_before = vdt.bp.refined[:vdt.bp.n].copy()
    nb0, b0 = vdt.n_blocks, vdt.bound
    budget = int(nb0 * 1.01)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vdt.refine(max_blocks=budget, batch=512)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    picked = vdt.bp.refined[:refined_before.size] & ~refined_before
    frac = float(stale[picked].mean()) if picked.any() else 0.0
    print(f"  refine to {budget} blocks (+1 %): {refine_s:.2f} s, "
          f"{nb0} -> {vdt.n_blocks} blocks, {int(stale.sum())} stale before,"
          f" {int(picked.sum())} refined, {frac:.4f} of them stale; bound "
          f"{b0:.6e} -> {vdt.bound:.6e}")
    check(vdt.n_blocks >= budget and np.isfinite(vdt.bound)
          and vdt.bound >= b0 - 1e-6 * abs(b0), "refine: bad state")
    check(picked.any() and frac == 1.0,
          "refine: the budget went to blocks no mutation touched first")
    check(vdt._stream is None, "refine kept stale mirrors")
    return dict(epoch=vdt, timings=timings, exact_err=err, publish=publish,
                refine=dict(seconds=refine_s, blocks=[nb0, vdt.n_blocks],
                            stale=int(stale.sum()), refined=int(picked.sum()),
                            stale_fraction=frac),
                touched=[ins.touched_blocks, dele.touched_blocks],
                stale_blocks=[ins.stale_blocks, dele.stale_blocks])


def serve(eng, reqs) -> list:
    """Submit ``reqs`` to a manual engine, flush, shut it down; the answers."""
    futs = [eng.submit(r) for r in reqs]
    eng.flush()
    res = [f.result(timeout=0) for f in futs]
    eng.shutdown()
    return res


def add_counts(total: dict, counts: dict) -> None:
    """``total`` += ``counts``, key by key."""
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def counted_serve(eng, reqs, path: dict):
    """``serve`` with the counts set to 0 just before and read just after;
    returns the answers and that serve's counts, also added to ``path``."""
    reset_counts()
    got = serve(eng, reqs)
    counts = read_counts()
    add_counts(path, counts)
    return got, counts


def sharded_class():
    """``ShardedPropagateEngine`` that counts its resumed segments (its
    monolithic ``_scan`` is a resume from the seed: those do not count)."""
    from repro_torch.serving import ShardedPropagateEngine

    class Counted(ShardedPropagateEngine):
        segments = 0

        def _scan(self, *args, **kwargs):
            self.segments -= 1
            return super()._scan(*args, **kwargs)

        def _scan_resume(self, *args, **kwargs):
            self.segments += 1
            return super()._scan_resume(*args, **kwargs)

    return Counted


def live_stripes(n: int, d: int) -> int:
    """The exact backend's non-empty row stripes over ``d`` shards: the
    rows padded to 256 cut into ``d``, clipped at ``n``."""
    rps = (-(-n // 256) * 256) // d
    return sum(min(s * rps, n) < min((s + 1) * rps, n) for s in range(d))


def scan_ms(eng, vdt, backend: str, n_iters: int) -> float:
    """Wall ms per iteration of one engine dispatch of one width-2 request
    (folded K = 2), after a 1-iteration warm-up."""
    import torch

    stack = torch.as_tensor((np.random.RandomState(46).rand(
        1, vdt.tree.n_points, 2) > 0.9).astype(np.float32), device="cuda")
    alphas = np.array([0.01], np.float32)
    eng._scan(vdt, stack, alphas, 1, backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._scan(vdt, stack, alphas, n_iters, backend)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_iters


def phase_sharded(out, epoch) -> dict:
    """[sharded engine] on the fitted SecStr model: D = 1, 2, 4, 8 shards on
    one card against the single engine: (a) exact bit for bit, (b) vdt
    within tolerance, (c) a segmented edf walk bit for bit, (d) a streamed
    epoch published with work queued, (f) D K1 launches an iteration, all on
    tf32x3, (g) ms per iteration at each D."""
    import torch
    from repro_torch.kernels.fused_lp import folded_step
    from repro_torch.kernels.tf32x3 import split_scratch
    from repro_torch.serving import PropagateEngine, ShardedPropagateEngine

    vdt = out["vdt"]
    n = vdt.tree.n_points
    print(f"[sharded engine] ShardedPropagateEngine over the fitted SecStr "
          f"model (N={n}, L={vdt.tree.L}), D = {SHARD_COUNTS} shards, all on "
          "cuda:0 (the decomposition, not a speed-up)")
    path = {}   # the sharded engine's own serves, each counted alone

    reqs = {"exact": lp_requests(n, 6, (1, 2, 3), 41, SHARD_CHECK_ITERS,
                                 backend="exact"),
            "vdt": lp_requests(n, 6, (1, 2, 3), 42, VDT_ITERS)}
    want = {be: serve(PropagateEngine(vdt, start=False, max_batch=8,
                                      backend=be), r)
            for be, r in reqs.items()}
    (walk,) = lp_requests(n, 1, (2,), 43, PREEMPT_ITERS, backend="exact",
                          deadline_ms=600_000.0)
    want_walk = serve(PropagateEngine(vdt, start=False, backend="exact"),
                      [walk])[0]
    result = dict(vdt_max_abs_err={}, launches_per_iter={})
    for d in SHARD_COUNTS:
        devs = ["cuda:0"] * d
        got, c = counted_serve(ShardedPropagateEngine(
            vdt, devices=devs, start=False, max_batch=8, backend="exact"),
            reqs["exact"], path)
        launches, tc = c["K1"], c[f"K1 {TC_ROUTE}"]
        check(launches == live_stripes(n, d) * SHARD_CHECK_ITERS
              and tc == launches,
              f"D={d}: {launches} K1 launches ({tc} on {TC_ROUTE}) for "
              f"{SHARD_CHECK_ITERS} iterations")
        same = all(np.array_equal(g, w) for g, w in zip(got, want["exact"]))
        print(f"  (a, f) D={d} exact: 6 requests of widths 1-3 in one "
              f"dispatch (folded K=32), {SHARD_CHECK_ITERS} iterations: K1 "
              f"launches {launches} = {launches // SHARD_CHECK_ITERS} an "
              f"iteration, {tc} on {TC_ROUTE}; == PropagateEngine "
              f"{'bit for bit' if same else 'NOT bit for bit'}")
        check(same, f"D={d}: the sharded exact answers differ")
        result["launches_per_iter"][d] = launches / SHARD_CHECK_ITERS

        got, _ = counted_serve(ShardedPropagateEngine(
            vdt, devices=devs, start=False, max_batch=8), reqs["vdt"], path)
        same = all(np.array_equal(g, w) for g, w in zip(got, want["vdt"]))
        err = close(torch.as_tensor(np.concatenate(got, axis=1)),
                    torch.as_tensor(np.concatenate(want["vdt"], axis=1)),
                    f"(b) D={d} vdt, {VDT_ITERS} iterations, the 6 answers "
                    f"vs PropagateEngine's ({'bit for bit' if same else 'not bit for bit'})")[0]
        result["vdt_max_abs_err"][d] = err

        eng = sharded_class()(vdt, devices=devs, start=False, policy="edf",
                              segment_iters=PREEMPT_SEGMENT, backend="exact")
        got = counted_serve(eng, [walk], path)[0][0]
        same = np.array_equal(got, want_walk)
        print(f"  (c) D={d} edf, segment_iters={PREEMPT_SEGMENT}: a "
              f"{PREEMPT_ITERS}-iteration exact walk in {eng.segments} "
              f"segments == the single engine's monolithic walk "
              f"{'bit for bit' if same else 'NOT bit for bit'}")
        check(eng.segments == PREEMPT_ITERS // PREEMPT_SEGMENT and same,
              f"D={d}: the segmented sharded walk differs")

    result["publish"] = sharded_publish(vdt, epoch, path)
    result["counts"] = path
    print(f"  (g) ms per iteration, one request of width 2 (folded K=2):")
    x = vdt.x_rows
    split = cuda_ms(lambda: split_scratch(x), 5)
    times = {}
    for d in (0,) + SHARD_COUNTS:
        eng = (PropagateEngine(vdt, start=False) if d == 0 else
               ShardedPropagateEngine(vdt, devices=["cuda:0"] * d,
                                      start=False))
        times[d or "single"] = dict(
            exact=scan_ms(eng, vdt, "exact", SHARD_TIME_ITERS),
            vdt=scan_ms(eng, vdt, "vdt", VDT_ITERS))
        eng.shutdown()
        t = times[d or "single"]
        print(f"    {'single engine' if d == 0 else f'D={d}':>13}: exact "
              f"{t['exact']:.2f} ms, vdt {t['vdt']:.3f} ms")
    print(f"    one split pass of the {n} x {x.shape[1]} columns: "
          f"{split:.3f} ms (the striped exact step runs D of them an "
          f"iteration, the single engine one)")
    result.update(ms_per_iter=times, split_pass_ms=split)
    return result


def sharded_publish(vdt0, vdt1, path: dict) -> dict:
    """(d): the streamed epoch published into an 8-shard engine with work of
    the old epoch queued: the queued answers and the new epoch's equal the
    single engines' bit for bit through K1; the old shard buffers retire.
    The sharded engine's launches are added to ``path``."""
    from repro_torch.serving import PropagateEngine, ShardedPropagateEngine

    d = SHARD_COUNTS[-1]
    n0, n1 = vdt0.tree.n_points, vdt1.tree.n_points
    reqs_old = lp_requests(n0, 4, (2,), 44, STREAM_EXACT_ITERS,
                           backend="exact")
    reqs_new = lp_requests(n1, 4, (2,), 45, STREAM_EXACT_ITERS,
                           backend="exact")
    want = [serve(PropagateEngine(v, start=False, max_batch=2,
                                  backend="exact"), r)
            for v, r in ((vdt0, reqs_old), (vdt1, reqs_new))]
    eng = ShardedPropagateEngine(vdt0, devices=["cuda:0"] * d, start=False,
                                 max_batch=2, backend="exact")
    reset_counts()
    futs_old = [eng.submit(q) for q in reqs_old]
    eid = eng.publish(vdt1)
    futs_new = [eng.submit(q) for q in reqs_new]
    eng.flush()
    add_counts(path, read_counts())
    got = [[f.result(timeout=0) for f in fs] for fs in (futs_old, futs_new)]
    m = eng.metrics()
    eng.shutdown()
    same = [all(np.array_equal(g, w) for g, w in zip(gs, ws))
            for gs, ws in zip(got, want)]
    print(f"  (d) D={d}: the streamed epoch ({n1} points) published with 4 "
          f"exact requests of the old one queued: old answers "
          f"{'bit for bit' if same[0] else 'NOT bit for bit'}, new epoch "
          f"{'bit for bit' if same[1] else 'NOT bit for bit'} == "
          f"PropagateEngine; epochs retired {m.epochs_retired}, shard "
          f"buffers kept for the new epoch only: "
          f"{list(eng._buf_cache) == [id(vdt1)]}")
    check(all(same) and eid == 1 and m.epochs_retired == 1
          and list(eng._buf_cache) == [id(vdt1)],
          "sharded publish: answers or retirement differ")
    return dict(bitwise=all(same), epochs_retired=m.epochs_retired)


def phase_sharded_stripes(vdt) -> dict:
    """(e): every stripe launch's rows equal the same rows of one
    whole-grid K1 launch, bit for bit, at each D (comparison launches, not
    counted on the path)."""
    import torch
    from repro_torch.kernels.fused_lp import alpha_row, folded_step
    from repro_torch.kernels.fused_lp.fused_lp import ref_padded_columns

    x = vdt.x_rows
    n = x.shape[0]
    sigma = float(vdt.sigma)
    inv = float(1.0 / (2.0 * sigma * sigma))
    g = torch.Generator().manual_seed(47)
    y = torch.rand(n, 8, generator=g).cuda()
    y0 = torch.rand(n, 8, generator=g).cuda()
    al = alpha_row(torch.rand(8, generator=g), 8, "cuda")
    whole = folded_step(x, x, y, y0, al, inv)
    sizes = {}
    for d in SHARD_COUNTS[1:]:
        rps = ref_padded_columns(n) // d
        sizes[d] = []
        for s in range(d):
            lo, hi = min(s * rps, n), min((s + 1) * rps, n)
            if lo == hi:
                continue
            got = folded_step(x[lo:hi], x, y, y0[lo:hi].contiguous(), al,
                              inv, row_base=lo)
            check(torch.equal(got, whole[lo:hi]),
                  f"(e) D={d} stripe {s} (rows {lo}..{hi}) differs from the "
                  f"whole-grid launch")
            sizes[d].append(hi - lo)
        print(f"  (e) D={d}: stripe launches of {sizes[d]} rows, row_base = "
              "the stripe's offset, K=8: every row == the whole-grid K1 "
              "launch bit for bit")
    return sizes


def close_k6(got, want, what: str) -> tuple[float, float]:
    """Hold K6 to its plain version: elementwise (``2e-4`` for float32,
    ``K6_BF16_PLAIN_TOL`` for bfloat16), then each block of 64 query rows of
    one (b, h) to ``K6_BLOCK_RMS`` in RMS error over RMS output.  Returns the
    max abs error and the largest block ratio."""
    import torch

    tol = K6_TOL["float32"] if want.dtype == torch.float32 else \
        K6_BF16_PLAIN_TOL
    err = close(got, want, what, tol, tol)[0]
    b, h, s, d = want.shape
    pad = (0, 0, 0, -s % 64)   # zero rows past S leave both norms as they are
    blocks = [torch.nn.functional.pad(t.double().cpu(), pad)
              .reshape(b, h, -1, 64 * d) for t in (got - want, want)]
    ratio = float((blocks[0].norm(dim=-1)
                   / blocks[1].norm(dim=-1).clamp_min(1e-30)).max())
    print(f"    per 64-row block: max RMS error / RMS output = {ratio:.3e}")
    check(ratio <= K6_BLOCK_RMS, f"{what}: a 64-row block's RMS error is "
                                 f"{ratio:.3e} of its output, over "
                                 f"{K6_BLOCK_RMS}")
    return err, ratio


def phase_k6_small() -> dict:
    """K6 against its plain version at small shapes, both routes; returns the
    max error by route."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    print(f"[K6 vs plain, small shapes: float32 -> {K6_F32_ROUTE}, bfloat16 ->"
          " sm90_bf16]")
    g = torch.Generator().manual_seed(6)
    errs = {route: [] for route in K6_ROUTES.values()}
    ratios = {route: [] for route in K6_ROUTES.values()}
    for b, hq, hkv, s, d, causal, window in (
            (2, 3, 3, 64, 64, True, 0), (2, 3, 1, 65, 64, True, 16),
            (1, 15, 5, 130, 64, True, 0), (2, 4, 1, 97, 128, True, 0),
            (1, 8, 2, 200, 128, True, 16), (1, 4, 1, 129, 256, True, 16),
            (2, 4, 4, 70, 256, True, 0), (2, 3, 1, 65, 64, False, 0),
            (1, 4, 1, 100, 128, False, 16), (1, 4, 4, 33, 256, False, 0)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                       for h in (hq, hkv, hkv))
            route = K6_ROUTES[str(dtype).split(".")[1]]
            before = dict(flash_attention.launches_by_route)
            got = flash_attention(q, k, v, causal=causal, window=window)
            after = flash_attention.launches_by_route
            check(after.get(route, 0) == before.get(route, 0) + 1
                  and sum(after.values())
                  == sum(before.values()) + 1,
                  f"K6 {dtype}: launched {after} after {before}, expected one "
                  f"launch on {route}")
            err, ratio = close_k6(
                got, flash_attention_plain(q, k, v, causal, window),
                f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
                f"window={window} {str(dtype).split('.')[1]}")
            errs[route].append(err)
            ratios[route].append(ratio)
            check(torch.equal(got, flash_attention(q, k, v, causal=causal,
                                                   window=window)),
                  "K6: two launches differ")
    print("  every shape: a second launch == the first bit for bit; each "
          "launch on its route")
    return {route: (max(errs[route]), max(ratios[route])) for route in errs}


def lm_tokens(cfg, n: int) -> np.ndarray:
    return np.random.RandomState(LM_SEED + 1).randint(
        0, cfg.vocab_size, (LM_BATCH, n)).astype(np.int64)


def phase_lm_serve() -> dict:
    """smollm-360m at full width: prefill 4 x 2,048 tokens, 16 greedy decode
    steps; K6 in every layer of the prefill."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serving.decode import DECODE_SLACK, decode_step, prefill

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {n_params / 1e6:.1f} M params (f32) seeded on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    # a cold call first (module loading, cuBLAS handles), outside the count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens.flip(1), cfg)
    decode_step(params, logits.argmax(-1)[:, None], state, cfg)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    del logits, state
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = read_counts()
    check(k6_route_only(prefill_counts, "sm90_bf16", cfg.n_layers),
          f"prefill launched K6 {prefill_counts}, expected {cfg.n_layers} "
          "times on the bfloat16 route and never on another")
    check(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits.float()).all()), "prefill: bad logits")
    check(tuple(state.kv.k.shape) == (cfg.n_layers, LM_BATCH,
                                      LM_PROMPT + DECODE_SLACK,
                                      cfg.n_kv_heads, cfg.head_dim_),
          f"prefill: cache shape {tuple(state.kv.k.shape)}")
    tok = logits.argmax(-1)[:, None]
    generated, step_logits = [tok], []
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(DECODE_SLACK + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(DECODE_SLACK):
        logits, state = decode_step(params, tok, state, cfg)
        step_logits.append(logits)
        tok = logits.argmax(-1)[:, None]
        generated.append(tok)
        marks[i + 1].record()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_SLACK
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(bool(torch.isfinite(x.float()).all()) for x in step_logits),
          "decode: non-finite logits")
    check(int(state.kv.pos[0]) == LM_PROMPT + DECODE_SLACK, "decode: bad pos")
    print(f"  cold prefill + 1 decode step (not counted): {cold_ms:.1f} ms")
    print(f"  prefill {LM_BATCH} x {LM_PROMPT} tokens: {prefill_ms:.1f} ms "
          f"({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} tokens/s), K6 "
          f"launches {prefill_counts['K6']} (sm90_bf16 "
          f"{prefill_counts['K6 sm90_bf16']}, {K6_F32_ROUTE} "
          f"{prefill_counts[f'K6 {K6_F32_ROUTE}']})"
          f"; decode {DECODE_SLACK} greedy "
          f"steps: {decode_ms:.2f} ms per step ({LM_BATCH / decode_ms * 1e3:.0f}"
          f" tokens/s; steps between device events: min {min(step_ms):.2f}, "
          f"max {max(step_ms):.2f} ms); max_memory_allocated {peak:.2f} GiB;"
          f" launches {counts}")
    print(f"  request 0 generated {torch.cat(generated, 1)[0].tolist()}")
    # the reference's consistency check: decode at position S vs the forward
    full_tokens = torch.cat([tokens, generated[0]], dim=1)
    full, _ = lm_forward(params, full_tokens, cfg)
    close(step_logits[0], full[:, LM_PROMPT], "decode logits vs lm_forward at "
          f"position S={LM_PROMPT}", LM_TOL, LM_TOL)
    del full
    profile = phase_lm_profile(params, cfg, tokens, prefill_ms, decode_ms)
    return dict(params=params, counts=prefill_counts, prefill_ms=prefill_ms,
                decode_ms=decode_ms, peak_gib=peak, profile=profile)


class Marked:
    """Within ``with``: every call of ``module.<attr>`` runs inside a
    profiler range named ``name``, so that the kernels it launches can be
    told from the rest of a profile (the SSM layer's ``ssd_chunked``; K6's
    backward, ``ops.flash_attention_backward``)."""

    def __init__(self, module, attr: str, name: str):
        self.module, self.attr, self.name = module, attr, name

    def __enter__(self):
        import torch

        self._orig = orig = getattr(self.module, self.attr)

        def marked(*args, **kwargs):
            with torch.profiler.record_function(self.name):
                return orig(*args, **kwargs)

        setattr(self.module, self.attr, marked)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self._orig)


def range_kernel_us(prof, name: str) -> dict:
    """Device microseconds by kernel name of the kernels launched within the
    ranges called ``name`` of a profile."""
    out = {}

    def walk(event):
        for k in event.kernels:
            out[k.name] = out.get(k.name, 0.0) + k.duration
        for child in event.cpu_children:
            walk(child)

    for event in prof.events():
        if event.name == name:
            walk(event)
    return out


def kernel_groups(prof, moe: bool = False, ranges=()) -> tuple:
    """Device ms by group of a profile, and its six longest kernels.  K6's
    forward kernels are "K6", products "matmul", elementwise kernels
    "elementwise"; ``moe``: the MoE layer's dispatch kernels (sorts,
    searches, gathers, scatters, top-k) are "moe dispatch"; ``ranges``:
    (range name, group) pairs whose kernels (``Marked``) are a group of
    their own.  The ranges' own device-side entries are no kernels."""
    import torch

    inside = {group: range_kernel_us(prof, name) for name, group in ranges}
    skip = {name for name, _ in ranges}
    out, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in skip:
            continue
        name = e.key
        # K6's kernels: flash_attention_tf32x3_kernel and its
        # prepare_kv_kernel (float32), flash_attention_sm90_kernel
        kind = ("K6" if "flash_attention" in name
                or "prepare_kv" in name else
                "matmul" if any(w in name.lower() for w in (
                    "gemm", "gemv", "cutlass", "xmma", "nvjet"))
                else "moe dispatch" if moe and any(
                    w in name.lower() for w in MOE_DISPATCH_KERNELS)
                else "elementwise" if "elementwise" in name
                else "other")
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        rest = us
        for group, by_name in inside.items():
            part = min(by_name.get(name, 0.0), rest)
            out[group] = out.get(group, 0.0) + part / 1e3
            rest -= part
        out[kind] = out.get(kind, 0.0) + rest / 1e3
        kernels.append((us / 1e3, e.count, name))
    return out, sorted(kernels, reverse=True)[:6]


def print_groups(what: str, by: dict, top: list, wall_ms: float) -> None:
    total = sum(by.values())
    if total == 0.0:
        print(f"  [profile] {what}: the profiler saw no device time "
              "(busy share not measured)")
        return
    parts = ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    print(f"  [profile] {what}: device time {total:.2f} ms: {parts}; "
          f"busy share of the unprofiled {wall_ms:.2f} ms: "
          f"{min(total / wall_ms, 1.0):.3f}")
    for ms, count, kname in top:
        print(f"    {ms:8.3f} ms in {count:5d} launches  {kname[:90]}")


def phase_lm_profile(params, cfg, tokens, prefill_ms: float,
                     decode_ms: float, moe: bool = False,
                     **inputs) -> dict:
    """Device time by kernel of one prefill and one decode step (torch
    profiler), and the device's busy share of the unprofiled times; returns
    the device ms by group of each (``kernel_groups``; an SSM or hybrid
    model's SSD scan, the kernels within ``ssd_chunked``, is the group
    "SSD").  ``inputs``: a vlm's ``patches`` or an audio model's
    ``frames``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm
    from repro_torch.serving.decode import decode_step, prefill

    ssd = cfg.family in ("ssm", "hybrid")
    logits, state = prefill(params, tokens, cfg, **inputs)
    tok = logits.argmax(-1)[:, None]
    result = {}
    for name, fn, wall_ms in (
            ("prefill", lambda: prefill(params, tokens, cfg, **inputs),
             prefill_ms),
            ("decode step", lambda: decode_step(params, tok, state, cfg),
             decode_ms)):
        torch.cuda.synchronize()
        with Marked(ssm, "ssd_chunked", "ssd_chunked") if ssd else \
                contextlib.nullcontext(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by, top = kernel_groups(prof, moe, (("ssd_chunked", "SSD"),)
                                if ssd else ())
        result[name] = dict(by, total=sum(by.values()))
        print_groups(name, by, top, wall_ms)
    return result


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_lm_f32(params) -> tuple[float, dict]:
    """The same model in float32: one prefill through K6 (its 3xTF32 route,
    counted from 0), one through K6's plain version (swapped into the
    attention module for that call); returns the logits' max error and the
    K6 prefill's launch counts."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models import attention
    from repro_torch.serving.decode import prefill

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    print(f"[lm serve, f32] {cfg.name} in float32: prefill through K6 vs "
          "through its plain version")
    reset_counts()
    t0 = time.perf_counter()
    got, _ = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    k6_s = time.perf_counter() - t0
    counts = read_counts()
    before = flash_attention.launches
    check(k6_route_only(counts, K6_F32_ROUTE, cfg.n_layers),
          f"f32 prefill launched K6 {counts}, expected once per layer on "
          f"{K6_F32_ROUTE} and never on another route")
    attention.flash_attention = flash_attention_plain
    try:
        t0 = time.perf_counter()
        want, _ = prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        attention.flash_attention = flash_attention
    check(flash_attention.launches == before,
          "the plain prefill launched K6")
    print(f"  prefill through K6 {k6_s * 1e3:.1f} ms (launches {counts}), "
          f"through the plain version {plain_s * 1e3:.1f} ms")
    return close(got, want, "last-position logits, K6 vs plain", LM_F32_TOL,
                 LM_F32_TOL)[0], counts


def phase_k6_timing(cases=None) -> list:
    """K6 at the LM path's attention shapes, each route at its type (bfloat16:
    the bf16 tensor-core kernel; float32: the 3xTF32 one), against its plain
    version, its bound and ``scaled_dot_product_attention`` (yardstick only),
    kernel and SDPA in turns.  ``cases``: (shape, dtype) pairs, by default
    every shape of ``K6_SHAPES`` in both types."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import \
        attention_work
    from repro_torch.launch.roofline import HW, bound

    print("[K6 timing]")
    g = torch.Generator().manual_seed(7)
    rows = []
    for (name, b, hq, hkv, s, d, window, causal), dtype in cases or (
            (shape, dtype) for dtype in (torch.bfloat16, torch.float32)
            for shape in K6_SHAPES):
        tname = str(dtype).split(".")[1]
        route, tol = K6_ROUTES[tname], K6_TOL[tname]
        q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                   for h in (hq, hkv, hkv))
        before = flash_attention.launches_by_route.get(route, 0)
        got = flash_attention(q, k, v, causal=causal, window=window)
        check(flash_attention.launches_by_route.get(route, 0) == before + 1,
              f"K6 {tname} did not launch on {route}")
        err, ratio = close_k6(got, flash_attention_plain(q, k, v, causal,
                                                         window),
                              f"{name} {tname}: K6 ({route}) vs plain")
        check(torch.equal(got, flash_attention(q, k, v, causal=causal,
                                               window=window)),
              f"{name} {tname}: two launches differ")
        i = torch.arange(s, device="cuda")
        if window:
            keep = i[:, None] - i[None, :] < window
            mask = dict(attn_mask=keep & (i[None, :] <= i[:, None])
                        if causal else keep)
        else:
            mask = dict(is_causal=causal)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **mask)

        close(sdpa(), got, f"{name} {tname}: SDPA vs K6", tol, tol)
        # kernel, SDPA, kernel, SDPA: the two are compared only in one run
        def k6():
            return flash_attention(q, k, v, causal=causal, window=window)

        ms = cuda_ms(k6, 10)
        lib_ms = cuda_ms(sdpa, 10)
        ms2 = cuda_ms(k6, 10)
        lib_ms2 = cuda_ms(sdpa, 10)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal,
                                                         window), 3)
        flops, nbytes = attention_work(b, hq, hkv, s, d, window,
                                       q.element_size(), causal)
        # bfloat16: one product on the tensor cores; float32: three TF32
        # products on the tensor cores, with the CUDA cores' bound beside
        if dtype == torch.bfloat16:
            bound_ms, by = bound(flops, nbytes, HW.PEAK_FLOPS)
            f32_ms = None
            extra = ""
        else:
            bound_ms, by = bound(3.0 * flops, nbytes, HW.PEAK_TF32_FLOPS)
            f32_ms = bound(flops, nbytes, HW.PEAK_FP32_FLOPS)[0]
            extra = (f"; float32 CUDA-core bound {f32_ms:.4f} ms, "
                     f"{f32_ms / ms:.4f} of it")
        print(f"  {name} {tname} B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
              f"window={window} causal={causal}: K6 ({route}) {ms:.4f} / {ms2:.4f} ms per "
              f"launch ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} / {lib_ms2:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({by}), {bound_ms / ms:.4f} of the "
              f"bound{extra}, K6 / SDPA {ms / lib_ms:.3f}")
        rows.append(dict(name=name, route=route, shape=f"B={b} Hq={hq} "
                         f"Hkv={hkv} S={s} D={d} window={window} "
                         f"causal={causal} {tname}",
                         ms=ms, ms2=ms2, plain_ms=plain_ms, lib_ms=lib_ms,
                         lib_ms2=lib_ms2, bound_ms=bound_ms, by=by,
                         f32_bound_ms=f32_ms, err=err, block_rms=ratio))
    return rows


def moe_routing(params, x, cfg):
    """What ``moe_apply`` routes for input ``x``: the chosen experts
    ``(T, k)`` and each token's assignments dropped past the capacity."""
    import torch
    from repro_torch.models import moe

    t, k = x.shape[0] * x.shape[1], cfg.experts_per_token
    probs = torch.softmax(x.reshape(t, -1).to(torch.float32)
                          @ params["router"].to(torch.float32), dim=-1)
    top_i = torch.topk(probs, k)[1]
    capacity = int(cfg.capacity_factor * t * k / cfg.n_experts) + 1
    table, valid = moe._dispatch_indices(top_i, cfg.n_experts, capacity)
    kept = torch.bincount(table[valid] // k, minlength=t)
    return top_i, k - kept


class MoeRecorder:
    """Within ``with``: every MoE layer call of the port's models records
    its routing (``moe_routing``) in ``calls``, and the first call its
    input in ``first_input``."""

    def __enter__(self):
        from repro_torch.models import transformer

        self.calls, self.first_input = [], None
        self._orig = orig = transformer.moe_apply

        def recorded(params, x, cfg, dt):
            if self.first_input is None:
                self.first_input = x.detach().clone()
            self.calls.append(moe_routing(params, x, cfg))
            return orig(params, x, cfg, dt)

        transformer.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.moe_apply = self._orig

    def drops(self) -> int:
        return int(sum(int(d.sum()) for _, d in self.calls))


def moe_loop_plain(params, x, cfg):
    """The MoE layer written another way, in float32: expert by expert, each
    keeping the first ``capacity`` of its assignments in (token, choice)
    order, its FFN on those tokens added back with their routing weights;
    no slot table, gather buffer or scatter.  What the layer check holds
    ``moe_apply``'s dispatch, expert FFN and combine to."""
    import torch
    import torch.nn.functional as F

    t, d = x.shape[0] * x.shape[1], x.shape[-1]
    k, e = cfg.experts_per_token, cfg.n_experts
    xt = x.reshape(t, d).to(torch.float32)
    probs = torch.softmax(xt @ params["router"], dim=-1)
    top_p, top_i = torch.topk(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    capacity = int(cfg.capacity_factor * t * k / e) + 1
    y = torch.zeros_like(xt)
    for ex in range(e):
        flat = (top_i.reshape(-1) == ex).nonzero()[:, 0][:capacity]
        tok = flat // k
        h = F.silu(xt[tok] @ params["w_gate"][ex]) * (
            xt[tok] @ params["w_up"][ex])
        y[tok] += top_p.reshape(-1)[flat, None] * (h @ params["w_down"][ex])
    if cfg.n_shared_experts:
        sp = params["shared"]
        y += (F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]
    return y.reshape(x.shape)


def moe_decode_check(params, cfg, tokens, tol: float) -> dict:
    """Decode at position S against ``lm_forward`` on S + 1 tokens, with
    the capacity factor raised to E / k so that no assignment drops in
    either (capacity >= T, and a token picks an expert once): a decode step
    routes only the batch's B tokens among themselves, the forward
    B (S + 1), so at the served capacity the two drop different
    assignments by design.  Compared on the requests routed to the same
    experts in every layer."""
    import dataclasses

    import torch
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving.decode import decode_step, prefill

    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    s = tokens.shape[1]
    logits, state = prefill(params, tokens, cfg)
    tok = logits.argmax(-1)[:, None]
    with MoeRecorder() as dec:
        step, _ = decode_step(params, tok, state, cfg)
    with MoeRecorder() as fwd:
        full, _ = lm_forward(params, torch.cat([tokens, tok], dim=1), cfg)
    check(len(dec.calls) == len(fwd.calls) == cfg.n_layers
          and dec.drops() == fwd.drops() == 0,
          f"decode check: {dec.drops()} / {fwd.drops()} assignments dropped"
          " at capacity >= T")
    alike = [b for b in range(tokens.shape[0])
             if all(torch.equal(di[b], fi[b * (s + 1) + s])
                    for (di, _), (fi, _) in zip(dec.calls, fwd.calls))]
    err = None
    if alike:
        err = close(step[alike], full[alike, s],
                    f"decode logits vs lm_forward at position S={s}, "
                    f"requests {alike} routed alike in every layer "
                    f"({cfg.dtype}, capacity factor "
                    f"{cfg.capacity_factor:.3f}, nothing dropped)", tol,
                    tol)[0]
    else:
        print(f"  decode check ({cfg.dtype}): no request routed alike in "
              "every layer")
    del full
    return dict(alike=alike, max_abs_err=err)


def moe_layer_check(params, cfg, hidden) -> dict:
    """Layer 0's MoE on ``MOE_LAYER_TOKENS`` tokens of the prefill's hidden
    states in float32: on the card against a CPU copy of its parameters
    (the same experts, outputs within ``MOE_LAYER_TOL``), and against
    ``moe_loop_plain`` on the card."""
    import dataclasses

    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    card = layer_params(params["layers"], 0)["moe"]
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                if isinstance(v, dict) else v.cpu()) for k, v in card.items()}
    h = hidden[:1, :MOE_LAYER_TOKENS].to(torch.float32)
    top_card, drop_card = moe_routing(card, h, cfg32)
    top_host, _ = moe_routing(host, h.cpu(), cfg32)
    same = torch.equal(top_card.cpu(), top_host)
    y, aux = moe.moe_apply(card, h, cfg32, torch.float32)
    y_host, aux_host = moe.moe_apply(host, h.cpu(), cfg32, torch.float32)
    print(f"  layer 0's MoE on {h.shape[1]} prefill tokens, float32, card vs "
          f"a CPU copy: experts {'equal' if same else 'DIFFER'}, "
          f"{int(drop_card.sum())} assignments dropped, aux {float(aux):.6f}"
          f" / {float(aux_host):.6f}")
    check(same, "MoE layer: the card routes differently from the CPU copy")
    err = close(y, y_host, "MoE layer output, card vs CPU copy",
                MOE_LAYER_TOL, MOE_LAYER_TOL)[0]
    close(aux.reshape(1), aux_host.reshape(1), "MoE aux loss, card vs CPU "
          "copy", 1e-5, 1e-6)
    loop_err = close(y, moe_loop_plain(card, h, cfg32), "MoE layer output "
                     "vs the expert-by-expert loop, on the card",
                     MOE_LAYER_TOL, MOE_LAYER_TOL)[0]
    return dict(max_abs_err=err, loop_max_abs_err=loop_err,
                drops=int(drop_card.sum()))


def phase_lm_moe() -> dict:
    """[lm serve moe]: deepseek-moe-16b at full width, 16 of its 28 layers:
    prefill 4 x 2,048 tokens (K6's bfloat16 route in every layer), 16
    greedy decode steps, the layer and decode checks, the profile."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.decode import DECODE_SLACK, decode_step, prefill

    full_cfg = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full_cfg, n_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm serve moe] {cfg.name}: {cfg.n_layers} of its "
          f"{full_cfg.n_layers} layers (the one cut), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, "
          f"{cfg.n_experts} routed experts of {cfg.moe_d_ff} + "
          f"{cfg.n_shared_experts} shared, top-{cfg.experts_per_token}, "
          f"capacity factor {cfg.capacity_factor}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {n_params / 1e9:.3f} B params, "
          f"{4 * n_params / 1e9:.1f} GB in float32 (all {full_cfg.n_layers} "
          f"layers: {full_cfg.param_count() / 1e9:.2f} B), seeded on the "
          f"card in {init_s:.2f} s")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens.flip(1), cfg)
    decode_step(params, logits.argmax(-1)[:, None], state, cfg)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    del logits, state
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(k6_route_only(counts, "sm90_bf16", cfg.n_layers),
          f"moe prefill launched K6 {counts}, expected {cfg.n_layers} times "
          "on the bfloat16 route and never on another")
    check(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits.float()).all()),
          "moe prefill: bad logits")
    check(tuple(state.kv.k.shape) == (cfg.n_layers, LM_BATCH,
                                      LM_PROMPT + DECODE_SLACK,
                                      cfg.n_kv_heads, cfg.head_dim_),
          f"moe prefill: cache shape {tuple(state.kv.k.shape)}")
    state0 = state
    tok = logits.argmax(-1)[:, None]
    generated = [tok]
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(DECODE_SLACK + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(DECODE_SLACK):
        logits, state = decode_step(params, tok, state, cfg)
        tok = logits.argmax(-1)[:, None]
        generated.append(tok)
        marks[i + 1].record()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_SLACK
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(logits.float()).all())
          and int(state.kv.pos[0]) == LM_PROMPT + DECODE_SLACK,
          "moe decode: bad logits or position")
    del state
    # the same steps again, recorded: the assignments each drops
    with MoeRecorder() as rec:
        st = state0
        for tok in generated[:-1]:
            _, st = decode_step(params, tok, st, cfg)
    decode_drops = rec.drops()
    del st, rec
    with MoeRecorder() as rec:
        prefill(params, tokens, cfg)
    prefill_drops, hidden = rec.drops(), rec.first_input
    del rec
    print(f"  cold prefill + 1 decode step (not counted): {cold_ms:.1f} ms")
    print(f"  prefill {LM_BATCH} x {LM_PROMPT} tokens: {prefill_ms:.1f} ms "
          f"({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} tokens/s), K6 "
          f"launches {counts['K6']} (sm90_bf16 {counts['K6 sm90_bf16']}), "
          f"{prefill_drops} of {LM_BATCH * LM_PROMPT * cfg.n_layers * cfg.experts_per_token}"
          f" assignments dropped; decode {DECODE_SLACK} greedy steps: "
          f"{decode_ms:.2f} ms per step ({LM_BATCH / decode_ms * 1e3:.0f} "
          f"tokens/s; between device events min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f} ms), {decode_drops} of "
          f"{DECODE_SLACK * LM_BATCH * cfg.n_layers * cfg.experts_per_token}"
          f" assignments dropped (capacity "
          f"{int(cfg.capacity_factor * LM_BATCH * cfg.experts_per_token / cfg.n_experts) + 1}"
          f" a step); max_memory_allocated {peak:.2f} GiB")
    print(f"  request 0 generated {torch.cat(generated, 1)[0].tolist()}")
    layer = moe_layer_check(params, cfg, hidden)
    del hidden
    short = tokens[:, :MOE_CHECK_PROMPT]
    check32 = moe_decode_check(params, dataclasses.replace(
        cfg, dtype="float32"), short, LM_F32_TOL)
    check(len(check32["alike"]) == LM_BATCH, "moe decode check (float32): "
          f"requests {check32['alike']} of {LM_BATCH} routed alike")
    profile = phase_lm_profile(params, cfg, tokens, prefill_ms, decode_ms,
                               moe=True)
    del params
    torch.cuda.empty_cache()
    return dict(counts=counts, prefill_ms=prefill_ms, decode_ms=decode_ms,
                peak_gib=peak, init_s=init_s, n_params=n_params,
                prefill_drops=prefill_drops, decode_drops=decode_drops,
                layer_check=layer, decode_check_f32=check32,
                profile=profile)


def family_decode_check(params, cfg, tokens, patches) -> float:
    """Decode after a float32 prefill against ``lm_forward`` one position
    further: prefill on ``tokens[:, :-1]`` (after ``patches``), decode the
    last token, hold its logits to the forward's at that position at
    ``LM_F32_TOL``; returns the max abs error."""
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving.decode import decode_step, prefill

    s = tokens.shape[1] - 1
    p = 0 if patches is None else patches.shape[1]
    _, state = prefill(params, tokens[:, :s], cfg, patches=patches)
    step, _ = decode_step(params, tokens[:, s:], state, cfg)
    full, _ = lm_forward(params, tokens, cfg, patches=patches)
    err = close(step, full[:, p + s], f"float32 decode after {p} + {s} "
                f"positions vs lm_forward at position {p + s}"
                + (f" (window {cfg.sliding_window})"
                   if cfg.sliding_window else ""), LM_F32_TOL,
                LM_F32_TOL)[0]
    del full
    return err


def ssm_layer_check(params, cfg) -> float:
    """Layer 0's SSM block on ``SSM_LAYER_TOKENS`` seeded inputs (B = 1) in
    float32: output, final state and conv cache on the card against a CPU
    copy of its parameters at ``LM_F32_TOL``; returns the output's max abs
    error."""
    import torch
    from repro_torch.models.ssm import ssm_apply
    from repro_torch.models.transformer import layer_params

    card = layer_params(params["layers"], 0)["ssm"]
    host = {k: v.cpu() for k, v in card.items()}
    x = torch.as_tensor(np.random.RandomState(LM_SEED + 3).randn(
        1, SSM_LAYER_TOKENS, cfg.d_model).astype(np.float32))
    out, cache = ssm_apply(card, x.cuda(), cfg, torch.float32,
                           return_state=True)
    out_h, cache_h = ssm_apply(host, x, cfg, torch.float32,
                               return_state=True)
    err = close(out, out_h, f"SSM layer 0 at {cfg.name}'s width, B = 1, S = "
                f"{SSM_LAYER_TOKENS}, float32: card vs a CPU copy",
                LM_F32_TOL, LM_F32_TOL)[0]
    close(cache.state, cache_h.state, "  its final SSM state", LM_F32_TOL,
          LM_F32_TOL)
    close(cache.conv, cache_h.conv, "  its conv cache", LM_F32_TOL,
          LM_F32_TOL)
    return err


def k6_plain_prefill_check(params, cfg, tokens, **inputs) -> tuple:
    """One float32 prefill through K6 (counted from 0: its 3xTF32 route at
    every attention point, no other launch) and one through K6's plain
    version swapped into the attention module; returns the logits' max abs
    error and the K6 prefill's counts.  ``inputs``: a vlm's ``patches`` or
    an audio model's ``frames``."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models import attention
    from repro_torch.serving.decode import prefill

    reset_counts()
    got, _ = prefill(params, tokens, cfg, **inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    n = k6_points(cfg)
    check(k6_route_only(counts, K6_F32_ROUTE, n),
          f"{cfg.name} f32 prefill launched K6 {counts}, expected {n} times "
          f"on {K6_F32_ROUTE} and never on another route")
    before = flash_attention.launches
    attention.flash_attention = flash_attention_plain
    try:
        want, _ = prefill(params, tokens, cfg, **inputs)
    finally:
        attention.flash_attention = flash_attention
    check(flash_attention.launches == before, "the plain prefill launched K6")
    return close(got, want, f"{cfg.name} float32 prefill of {tokens.shape[0]}"
                 f" x {tokens.shape[1]} tokens, last-position logits, K6 vs "
                 "its plain version", LM_F32_TOL, LM_F32_TOL)[0], counts


def k6_points(cfg) -> int:
    """K6's launches in one prefill: one per attention layer, or per
    application of a hybrid's shared block; none in an SSM model; an audio
    model's encoder layers and decoder layers."""
    from repro_torch.models.transformer import attn_flags

    if cfg.family in ("ssm", "hybrid"):
        return sum(attn_flags(cfg))
    return cfg.n_layers + cfg.n_encoder_layers


def family_shape(cfg) -> str:
    shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
             f"{cfg.vocab_size}, {cfg.dtype}")
    if cfg.family in ("ssm", "hybrid"):
        shape += (f"; SSM d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
                  f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                  f"{cfg.ssm_chunk}")
    if cfg.family != "ssm":
        shape += (f"; attention {cfg.n_heads}/{cfg.n_kv_heads} heads of "
                  f"{cfg.head_dim_}, d_ff {cfg.d_ff}")
    if cfg.family == "hybrid":
        shape += (f", one shared block at {k6_points(cfg)} points (every "
                  f"{cfg.attn_every} layers), window {cfg.sliding_window}")
    if cfg.family == "vlm":
        shape += f"; {cfg.n_patches} patch embeddings first"
    return shape


def phase_lm_family(arch: str) -> dict:
    """[lm serve ssm / hybrid / vlm]: ``arch`` at full width and depth,
    bfloat16 compute, seeded weights: 4 x 2,048-token prompts (internvl2-1b:
    after 256 seeded patch embeddings) through ``prefill``, K6's bf16 route
    counted (0 launches for mamba2-130m, one per attention point
    otherwise), 16 greedy ``decode_step``s, the profile by group; then the
    float32 checks on the card."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.decode import DECODE_SLACK, decode_step, prefill

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm serve {cfg.family}] {cfg.name}: {family_shape(cfg)}; "
          f"{n_params / 1e6:.1f} M params ({4 * n_params / 1e9:.2f} GB in "
          f"float32), seeded on the card in {init_s:.2f} s; nothing cut")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    patches = None
    if cfg.n_patches:
        patches = torch.as_tensor(np.random.RandomState(LM_SEED + 2).randn(
            LM_BATCH, cfg.n_patches, cfg.d_model).astype(np.float32)
            * cfg.d_model ** -0.5, device="cuda")
    s = LM_PROMPT + cfg.n_patches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens.flip(1), cfg, patches=patches)
    decode_step(params, logits.argmax(-1)[:, None], state, cfg)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    del logits, state
    n_k6 = k6_points(cfg)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens, cfg, patches=patches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(k6_route_only(counts, "sm90_bf16", n_k6),
          f"{arch} prefill launched K6 {counts}, expected {n_k6} times on "
          "the bfloat16 route and never on another")
    check(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{arch} prefill: bad logits")
    if cfg.family in ("ssm", "hybrid"):
        check(tuple(state.ssm.state.shape) == (
            cfg.n_layers, LM_BATCH, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state) and state.ssm.state.dtype == torch.float32,
            f"{arch} prefill: SSM state {tuple(state.ssm.state.shape)}")
    if cfg.family == "hybrid":
        # the reference's ring keeps min(S, window) slots
        check(tuple(state.shared_kv.k.shape) == (
            n_k6, LM_BATCH, min(s, cfg.sliding_window), cfg.n_kv_heads,
            cfg.head_dim_) and state.shared_kv.ring,
            f"{arch} prefill: shared cache {tuple(state.shared_kv.k.shape)}")
    if cfg.family == "vlm":
        check(tuple(state.kv.k.shape) == (
            cfg.n_layers, LM_BATCH, s + DECODE_SLACK, cfg.n_kv_heads,
            cfg.head_dim_), f"{arch} prefill: cache {tuple(state.kv.k.shape)}")
    tok = logits.argmax(-1)[:, None]
    generated = [tok]
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(DECODE_SLACK + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(DECODE_SLACK):
        logits, state = decode_step(params, tok, state, cfg)
        tok = logits.argmax(-1)[:, None]
        generated.append(tok)
        marks[i + 1].record()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_SLACK
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(logits.float()).all()),
          f"{arch} decode: non-finite logits")
    del state
    print(f"  cold prefill + 1 decode step (not counted): {cold_ms:.1f} ms")
    print(f"  prefill {LM_BATCH} x {LM_PROMPT} tokens"
          + (f" after {cfg.n_patches} patches" if cfg.n_patches else "")
          + f": {prefill_ms:.1f} ms ("
          f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} tokens/s), K6 "
          f"launches {counts['K6']} (sm90_bf16 {counts['K6 sm90_bf16']}); "
          f"decode {DECODE_SLACK} greedy steps: {decode_ms:.2f} ms per step "
          f"({LM_BATCH / decode_ms * 1e3:.0f} tokens/s; between device "
          f"events min {min(step_ms):.2f}, max {max(step_ms):.2f} ms); "
          f"max_memory_allocated {peak:.2f} GiB")
    print(f"  request 0 generated {torch.cat(generated, 1)[0].tolist()}")
    profile = phase_lm_profile(params, cfg, tokens, prefill_ms, decode_ms,
                               patches=patches)
    # the float32 checks, on the same float32 parameters
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    checks = {}
    if cfg.family == "vlm":
        checks["decode_vs_forward"] = family_decode_check(
            params, cfg32, tokens[:, :VLM_CHECK_PROMPT + 1], patches)
    else:
        window = ({} if cfg.family == "ssm" else
                  dict(sliding_window=SSM_CHECK_PROMPT))
        checks["decode_vs_forward"] = family_decode_check(
            params, dataclasses.replace(cfg32, **window),
            tokens[:, :SSM_CHECK_PROMPT + 1], None)
    f32_counts = None
    if n_k6:
        checks["k6_vs_plain_prefill"], f32_counts = k6_plain_prefill_check(
            params, cfg32, tokens, patches=patches)
    if cfg.family == "hybrid":
        checks["ssm_layer_card_vs_cpu"] = ssm_layer_check(params, cfg32)
    del params
    torch.cuda.empty_cache()
    return dict(arch=arch, counts=counts, f32_counts=f32_counts,
                prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gib=peak,
                init_s=init_s, n_params=n_params, checks=checks,
                profile=profile)


def k6_timing_json(r: dict) -> dict:
    """One ``phase_k6_timing`` row for the kernel table."""
    return dict(shape=r["shape"], ms=r["ms"], ms2=r["ms2"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["by"], library_ms=r["lib_ms"],
                library_ms2=r["lib_ms2"], max_abs_err=r["err"],
                max_block_rms=r["block_rms"])


def phase_k6_gate() -> dict:
    """K6's float32 route against the plain recurrence in float64 on Gaussian
    q, k, v at both timed shapes, beside the plain float32 version: the gate
    that tells 3xTF32 from one TF32 product."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain float32 version needs float32 matrix products")
    print(f"[K6 precision gate] Gaussian q, k, v, seed {K6_GATE_SEED}: float32"
          f" kernel vs float64 within {GATE_RATIO} x the plain float32 "
          "version's error")
    rng = np.random.RandomState(K6_GATE_SEED)
    out = {}
    for name, b, hq, hkv, s, d, window, _ in K6_SHAPES:
        q, k, v = (torch.as_tensor(rng.randn(b, h, s, d).astype(np.float32),
                                   device="cuda") for h in (hq, hkv, hkv))
        ref = flash_attention_plain(q.double(), k.double(), v.double(), True,
                                    window)
        out[name] = gate_check(f"K6 f32 {name}", flash_attention(
            q, k, v, window=window), flash_attention_plain(q, k, v, True,
                                                           window), ref)
    failed = [k for k, v in out.items() if not v["ok"]]
    check(not failed, f"K6 precision gate failed for {failed}: error over "
                      f"{GATE_RATIO} x the plain float32 version's")
    return out


def phase_k6_stripes() -> dict:
    """[K6 stripes]: K6's query stripes (``row_base``) at
    ``K6_STRIPE_SHAPE`` on both routes, each launch counted on its route;
    the float32 route's gate at a nonzero ``row_base``."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import \
        attention_work
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.launch.roofline import HW, bound

    name, b, hq, hkv, s, d, window, causal = K6_STRIPE_SHAPE
    n = K6_STRIPES
    rows = s // n
    print(f"[K6 stripes] {name}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
          f"causal={causal}, {n} query stripes of {rows} rows (row_base = "
          f"i x {rows}), the whole launch beside them")
    g = torch.Generator().manual_seed(11)
    by_route = flash_attention.launches_by_route
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[1]
        route = K6_ROUTES[tname]
        q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                   for h in (hq, hkv, hkv))
        before, total = by_route.get(route, 0), flash_attention.launches
        whole = flash_attention(q, k, v, causal=causal, window=window)
        stripes = [q[:, :, i * rows:(i + 1) * rows].contiguous()
                   for i in range(n)]
        parts = [flash_attention_fwd(stripes[i], k, v, causal, window,
                                     i * rows) for i in range(n)]
        bitwise = bool(torch.equal(torch.cat(parts, dim=2), whole))
        print(f"  {tname} ({route}): the {n} stripes concatenated equal the "
              f"whole launch bit for bit: {bitwise}")
        check(bitwise, f"[K6 stripes] {tname}: the stripes differ from the "
                       "whole launch")
        errs = {}
        for i in (0, n // 2, n - 1):
            plain = flash_attention_plain(stripes[i], k, v, causal, window,
                                          row_base=i * rows)
            errs[f"stripe {i}"] = close_k6(
                parts[i], plain, f"{tname} stripe {i} (row_base {i * rows})"
                " vs plain")[0]
        odd = q[:, :, K6_ODD_ROW_BASE:K6_ODD_ROW_BASE + rows].contiguous()
        errs[f"row_base {K6_ODD_ROW_BASE}"] = close_k6(
            flash_attention_fwd(odd, k, v, causal, window, K6_ODD_ROW_BASE),
            flash_attention_plain(odd, k, v, causal, window,
                                  row_base=K6_ODD_ROW_BASE),
            f"{tname} stripe at row_base {K6_ODD_ROW_BASE} vs plain")[0]
        whole_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                   window=window),
                           K6_STRIPE_REPS)
        stripe_ms = [cuda_ms(lambda i=i: flash_attention_fwd(
            stripes[i], k, v, causal, window, i * rows), K6_STRIPE_REPS)
            for i in range(n)]
        whole_ms2 = cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                    window=window),
                            K6_STRIPE_REPS)
        last = n - 1
        plain_ms = cuda_ms(lambda: flash_attention_plain(
            stripes[last], k, v, causal, window, row_base=last * rows), 1)
        flops, nbytes = attention_work(b, hq, hkv, s, d, window,
                                       q.element_size(), causal,
                                       row_base=last * rows, sq=rows)
        bound_ms, by = (bound(flops, nbytes, HW.PEAK_FLOPS)
                        if dtype == torch.bfloat16 else
                        bound(3.0 * flops, nbytes, HW.PEAK_TF32_FLOPS))
        ratio = max(stripe_ms) / (whole_ms / n)
        launches = by_route.get(route, 0) - before
        check(launches == flash_attention.launches - total,
              f"[K6 stripes] {tname}: a launch off {route}")
        print(f"  {tname}: whole {whole_ms:.4f} / {whole_ms2:.4f} ms; "
              f"stripes {', '.join(f'{t:.4f}' for t in stripe_ms)} ms; "
              f"max stripe ms / (whole ms / {n}) = {ratio:.3f}; last stripe "
              f"{stripe_ms[-1]:.4f} ms against its bound {bound_ms:.4f} ms "
              f"({by}), plain {plain_ms:.2f} ms; {launches} launches, all "
              f"on {route}")
        out[tname] = dict(
            route=route, shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
            f"causal={causal} {tname}, {n} stripes of {rows} rows",
            whole_ms=whole_ms, whole_ms2=whole_ms2, stripe_ms=stripe_ms,
            max_stripe_over_mean=ratio, last_stripe_bound_ms=bound_ms,
            bound_by=by, last_stripe_plain_ms=plain_ms, bitwise=bitwise,
            max_abs_err=errs, launches=launches)
        del q, k, v, whole, stripes, parts, odd
        torch.cuda.empty_cache()
    # the float32 route's gate on a stripe: the last half of smollm's gate
    # shape, against the plain recurrence in float64 at its row_base
    gname, gb, ghq, ghkv, gs, gd, gwin, _ = K6_SHAPES[0]
    rng = np.random.RandomState(K6_GATE_SEED)
    q, k, v = (torch.as_tensor(rng.randn(gb, h, gs, gd).astype(np.float32),
                               device="cuda") for h in (ghq, ghkv, ghkv))
    r0 = gs // 2
    qs = q[:, :, r0:].contiguous()
    gate = gate_check(
        f"K6 f32 {gname} rows {r0}..{gs - 1} (row_base {r0})",
        flash_attention_fwd(qs, k, v, True, gwin, r0),
        flash_attention_plain(qs, k, v, True, gwin, row_base=r0),
        flash_attention_plain(qs.double(), k.double(), v.double(), True,
                              gwin, row_base=r0))
    check(gate["ok"], f"[K6 stripes] the float32 gate failed at row_base "
                      f"{r0}")
    out["gate_row_base"] = dict(row_base=r0, **gate)
    return out


def phase_k6_grad() -> dict:
    """[K6 grad]: K6 as an autograd Function on the card (the kernel's
    forward, one counted launch; the float32 torch backward, no launch)
    against autograd through ``ref.py``'s dense float32 softmax: the output
    at ``K6_TOL``, dq, dk and dv at ``K6_GRAD_TOL``, at each case of
    ``K6_GRAD_CASES`` in both types; and the backward's device time beside
    the forward's."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_backward

    print("[K6 grad] autograd through K6 (the kernel's forward, the float32 "
          "torch backward) vs autograd through ref.py's dense float32 "
          "softmax")
    g = torch.Generator().manual_seed(9)
    out = {}
    for name, b, hq, hkv, s, d, window, causal in K6_GRAD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[1]
            route, tol = K6_ROUTES[tname], K6_GRAD_TOL[tname]
            q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                       .requires_grad_() for h in (hq, hkv, hkv))
            dout = torch.randn(b, hq, s, d, generator=g).to("cuda", dtype)
            before = read_counts()
            o = flash_attention(q, k, v, causal=causal, window=window)
            grads = torch.autograd.grad(o, (q, k, v), dout)
            torch.cuda.synchronize()
            after = read_counts()
            check(after["K6"] == before["K6"] + 1
                  and after[f"K6 {route}"] == before[f"K6 {route}"] + 1,
                  f"K6 grad {name} {tname}: launches {before} -> {after}, "
                  f"expected one forward launch on {route}")
            ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
            o_ref = flash_attention_ref(*ref_in, causal=causal, window=window)
            want = torch.autograd.grad(o_ref, ref_in, dout.float())
            label = (f"{name} B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                     f"window={window} causal={causal} {tname}")
            errs = dict(out=close(o.detach(), o_ref.detach(),
                                  f"{label}: output", K6_TOL[tname],
                                  K6_TOL[tname])[0])
            for part, got_t, want_t in zip(("dq", "dk", "dv"), grads, want):
                errs[part] = close(got_t, want_t, f"{label}: {part}", tol,
                                   tol)[0]
            qd, kd, vd = (t.detach() for t in (q, k, v))
            fwd_ms = cuda_ms(lambda: flash_attention(
                qd, kd, vd, causal=causal, window=window), 5)
            bwd_ms = cuda_ms(lambda: flash_attention_backward(
                qd, kd, vd, dout, causal, window), 3)
            print(f"    forward (K6, {route}) {fwd_ms:.4f} ms, backward "
                  f"(float32 torch ops) {bwd_ms:.4f} ms")
            out[f"{name} {tname}"] = dict(errs, shape=label, fwd_ms=fwd_ms,
                                          bwd_ms=bwd_ms)
            del q, k, v, o, grads, o_ref, want, ref_in
    return out


def audio_frames(cfg, batch: int) -> np.ndarray:
    """Seeded stub frame embeddings (B, T_enc, D), the encoder's input."""
    return np.random.RandomState(LM_SEED + 2).randn(
        batch, cfg.encoder_frames, cfg.d_model).astype(np.float32)


def audio_decode_check(params, cfg, tokens, frames) -> float:
    """Float32 decode at position S after a prefill on S tokens against
    ``decoder_forward`` on S + 1 tokens over the encoder's output of the
    same frames, at ``LM_F32_TOL``; returns the max abs error."""
    from repro_torch.models.whisper import decoder_forward, encoder_forward
    from repro_torch.serving.decode import decode_step, prefill

    s = tokens.shape[1] - 1
    _, state = prefill(params, tokens[:, :s], cfg, frames=frames)
    step, _ = decode_step(params, tokens[:, s:], state, cfg)
    full = decoder_forward(params, tokens,
                           encoder_forward(params, frames, cfg), cfg)
    err = close(step, full[:, s], f"float32 decode after {s} tokens vs "
                f"decoder_forward at position {s}", LM_F32_TOL,
                LM_F32_TOL)[0]
    del full
    return err


def encoder_layer_check(params, cfg, frames) -> float:
    """Encoder layer 0 on one request's frames in float32: on the card (K6's
    ``sm90_tf32x3`` route) against a CPU copy of its parameters (K6's plain
    version) at ``LM_F32_TOL``; returns the max abs error."""
    import torch
    from repro_torch.models.transformer import layer_params
    from repro_torch.models.whisper import encoder_layer

    card = layer_params(params["enc_layers"], 0)
    host = tree_to(card, "cpu")
    x = frames[:1] + params["enc_pos"][None]
    pos = torch.arange(x.shape[1], device="cuda")[None]
    got = encoder_layer(card, x, cfg, pos)
    want = encoder_layer(host, x.cpu(), cfg, pos.cpu())
    return close(got, want, f"encoder layer 0 at {cfg.name}'s width, B = 1, "
                 f"T_enc = {x.shape[1]}, float32: card vs a CPU copy",
                 LM_F32_TOL, LM_F32_TOL)[0]


def phase_lm_audio() -> dict:
    """[lm serve audio]: whisper-medium at full width and depth, bfloat16
    compute, seeded weights: 4 requests of 1,500 seeded frame embeddings and
    432-token prompts through ``prefill`` (K6's bf16 route 48 times: 24
    bidirectional encoder layers at S = 1,500, 24 causal decoder layers), 16
    greedy ``decode_step``s, the profile by group; then the float32 checks
    on the card."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.whisper import init_encdec
    from repro_torch.serving.decode import DECODE_SLACK, decode_step, prefill

    cfg = get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_encdec(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm serve audio] {cfg.name}: encoder {cfg.n_encoder_layers} "
          f"layers over {cfg.encoder_frames} frames, decoder {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params / 1e6:.1f} M params "
          f"({4 * n_params / 1e9:.2f} GB in float32), seeded on the card in "
          f"{init_s:.2f} s; nothing cut")
    tokens = torch.as_tensor(lm_tokens(cfg, AUDIO_PROMPT), device="cuda")
    frames = torch.as_tensor(audio_frames(cfg, LM_BATCH), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens.flip(1), cfg, frames=frames.flip(1))
    decode_step(params, logits.argmax(-1)[:, None], state, cfg)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    del logits, state
    n_k6 = k6_points(cfg)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens, cfg, frames=frames)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(k6_route_only(counts, "sm90_bf16", n_k6),
          f"{cfg.name} prefill launched K6 {counts}, expected {n_k6} times "
          "on the bfloat16 route and never on another")
    check(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name} prefill: bad logits")
    kv_shape = (cfg.n_layers, LM_BATCH, AUDIO_PROMPT + DECODE_SLACK,
                cfg.n_kv_heads, cfg.head_dim_)
    cross_shape = (cfg.n_layers, LM_BATCH, cfg.encoder_frames,
                   cfg.n_kv_heads, cfg.head_dim_)
    check(tuple(state.kv.k.shape) == kv_shape
          and tuple(state.cross_k.shape) == cross_shape
          and tuple(state.cross_v.shape) == cross_shape,
          f"{cfg.name} prefill: cache {tuple(state.kv.k.shape)}, cross "
          f"{tuple(state.cross_k.shape)}")
    tok = logits.argmax(-1)[:, None]
    generated = [tok]
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(DECODE_SLACK + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(DECODE_SLACK):
        logits, state = decode_step(params, tok, state, cfg)
        tok = logits.argmax(-1)[:, None]
        generated.append(tok)
        marks[i + 1].record()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_SLACK
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name} decode: non-finite logits")
    check(int(state.kv.pos[0]) == AUDIO_PROMPT + DECODE_SLACK,
          f"{cfg.name} decode: position {int(state.kv.pos[0])}")
    del state
    print(f"  cold prefill + 1 decode step (not counted): {cold_ms:.1f} ms")
    print(f"  prefill {LM_BATCH} x ({cfg.encoder_frames} frames + "
          f"{AUDIO_PROMPT} tokens): {prefill_ms:.1f} ms, K6 launches "
          f"{counts['K6']} (sm90_bf16 {counts['K6 sm90_bf16']}); decode "
          f"{DECODE_SLACK} greedy steps: {decode_ms:.2f} ms per step "
          f"({LM_BATCH / decode_ms * 1e3:.0f} tokens/s; between device "
          f"events min {min(step_ms):.2f}, max {max(step_ms):.2f} ms); "
          f"max_memory_allocated {peak:.2f} GiB")
    print(f"  request 0 generated {torch.cat(generated, 1)[0].tolist()}")
    profile = phase_lm_profile(params, cfg, tokens, prefill_ms, decode_ms,
                               frames=frames)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    checks = {}
    checks["k6_vs_plain_prefill"], f32_counts = k6_plain_prefill_check(
        params, cfg32, tokens, frames=frames)
    checks["decode_vs_decoder_forward"] = audio_decode_check(
        params, cfg32, tokens, frames)
    checks["encoder_layer_card_vs_cpu"] = encoder_layer_check(
        params, cfg32, frames)
    del params
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, counts=counts, f32_counts=f32_counts,
                prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gib=peak,
                init_s=init_s, n_params=n_params, checks=checks,
                profile=profile)


def train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """Seeded tokens (B, seq + 1) on the card; an audio model's frames."""
    import torch

    rng = np.random.RandomState(seed)
    out = {"tokens": torch.as_tensor(rng.randint(
        0, cfg.vocab_size, (batch, seq + 1)), device="cuda")}
    if cfg.family == "audio":
        out["frames"] = torch.as_tensor(rng.randn(
            batch, cfg.encoder_frames, cfg.d_model).astype(np.float32),
            device="cuda")
    return out


def k6_backward_ms(cfg, batch: int, s: int, causal: bool = True) -> float:
    """Device ms of one K6 backward (``flash_attention_backward``) at a
    layer's attention shape in the compute dtype."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_backward

    g = torch.Generator().manual_seed(10)
    dt = getattr(torch, cfg.dtype)
    q, dout = (torch.randn(batch, cfg.n_heads, s, cfg.head_dim_,
                           generator=g).to("cuda", dt) for _ in range(2))
    k, v = (torch.randn(batch, cfg.n_kv_heads, s, cfg.head_dim_,
                        generator=g).to("cuda", dt) for _ in range(2))
    return cuda_ms(lambda: flash_attention_backward(q, k, v, dout, causal),
                   3)


def train_run(cfg, params, batch: dict, n_steps: int) -> dict:
    """``n_steps`` steps of ``make_train_step`` on the card, each counted
    (every count 0 just before, read just after) and timed: every loss and
    grad norm finite, the parameters changed, K6 launched at every attention
    point on its route, twice under ``cfg.remat`` (the backward's
    recompute); then one more step under the profiler, by group, K6's
    backward a group of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    opt_cfg = AdamWConfig(**TRAIN_OPT)
    step = make_train_step(cfg, opt_cfg)
    state = init_train_state(params, opt_cfg)
    route = K6_ROUTES[cfg.dtype]
    n_k6 = k6_points(cfg) * (2 if cfg.remat else 1)
    tokens = batch["tokens"].shape[0] * (batch["tokens"].shape[1] - 1)
    rows = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        changed = sum(not torch.equal(a, b) for a, b in
                      zip(_leaves(state.params), _leaves(new.params)))
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"{cfg.name} train step: loss {loss}, grad norm {gnorm}")
        check(changed > 0, f"{cfg.name} train step changed no parameter")
        check(k6_route_only(counts, route, n_k6),
              f"{cfg.name} train step launched K6 {counts}, expected "
              f"{n_k6} times on {route} and never on another")
        rows.append(dict(ms=ms, loss=loss, grad_norm=gnorm,
                         lr=float(metrics["lr"]), k6=counts["K6"],
                         changed=changed))
        print(f"  step {int(new.step)}: {ms:.1f} ms ({tokens / ms * 1e3:.0f} "
              f"tokens/s), loss {loss:.4f}, grad norm {gnorm:.4f}, K6 "
              f"launches {counts['K6']} ({route} {counts[f'K6 {route}']}), "
              f"{changed} of {len(list(_leaves(params)))} parameter tensors "
              "changed")
        state = new
    torch.cuda.synchronize()
    with Marked(ops, "flash_attention_backward", "k6_backward"), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    by, top = kernel_groups(prof, ranges=(("k6_backward", "K6 backward"),))
    print_groups("train step", by, top,
                 sum(r["ms"] for r in rows[1:]) / max(len(rows) - 1, 1))
    return dict(rows=rows, tokens=tokens,
                groups=dict(by, total=sum(by.values())))


def close_tree(got: dict, want: dict, what: str, tol: float,
               scaled: bool = False) -> float:
    """Every leaf of ``got`` within ``tol`` of ``want`` (``scaled``: of the
    leaf's largest magnitude); returns the largest max abs error."""
    import torch

    worst, worst_rel = 0.0, 0.0
    for a, b in zip(_leaves(got), _leaves(want)):
        a, b = a.double().cpu(), b.double().cpu()
        atol = tol * float(b.abs().max()) if scaled else tol
        err = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite")
        check(bool((err <= atol + tol * b.abs()).all()),
              f"{what}: a tensor {tuple(a.shape)} off by "
              f"{float(err.max()):.3e}, over rtol={tol}, atol={atol:.3e}")
        worst = max(worst, float(err.max()))
        worst_rel = max(worst_rel, float(err.max())
                        / max(float(b.abs().max()), 1e-30))
    print(f"  {what}: max_abs_err={worst:.3e} (largest over a tensor's max "
          f"magnitude {worst_rel:.3e}) ok")
    return worst


def train_checks() -> dict:
    """smollm-360m at full width in float32, 2 x 256 tokens: one step on
    the card (K6's ``sm90_tf32x3`` route) against the same step on a CPU copy
    (K6's plain version): loss, grad norm, every updated parameter at
    ``LM_F32_TOL`` and the first moment (the clipped gradient) within
    ``LM_F32_TOL`` of each tensor's largest value; and on the card a step
    of 2 microbatches against one step on the whole batch, likewise."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    params = init_lm(cfg, LM_SEED + 1, device="cuda")
    batch = train_batch(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, LM_SEED + 4)
    step = make_train_step(cfg, opt_cfg)
    print(f"[train, f32] {cfg.name} in float32, {TRAIN_CHECK_BATCH} x "
          f"{TRAIN_CHECK_SEQ} tokens: the card's step vs a CPU copy's; 2 "
          "microbatches vs the whole batch")
    reset_counts()
    card, m_card = step(init_train_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    counts = read_counts()
    n_k6 = k6_points(cfg) * (2 if cfg.remat else 1)
    check(k6_route_only(counts, K6_F32_ROUTE, n_k6),
          f"f32 train step launched K6 {counts}, expected {n_k6} times on "
          f"{K6_F32_ROUTE}")
    t0 = time.perf_counter()
    cpu, m_cpu = step(init_train_state(tree_to(params, "cpu"), opt_cfg),
                      tree_to(batch, "cpu"))
    cpu_s = time.perf_counter() - t0
    out = {}
    for name in ("loss", "grad_norm"):
        out[name] = close(m_card[name].reshape(1), m_cpu[name].reshape(1),
                          f"step on the card vs a CPU copy ({cpu_s:.1f} s): "
                          f"{name}", LM_F32_TOL, LM_F32_TOL)[0]
    out["params"] = close_tree(card.params, cpu.params, "  updated "
                               "parameters", LM_F32_TOL)
    out["mu"] = close_tree(card.opt.mu, cpu.opt.mu, "  first moment",
                           LM_F32_TOL, scaled=True)
    del cpu
    two, m_two = make_train_step(cfg, opt_cfg, n_microbatches=2)(
        init_train_state(params, opt_cfg), batch)
    for name in ("loss", "grad_norm"):
        out[f"micro_{name}"] = close(
            m_two[name].reshape(1), m_card[name].reshape(1),
            f"2 microbatches vs the whole batch: {name}", LM_F32_TOL,
            LM_F32_TOL)[0]
    out["micro_params"] = close_tree(two.params, card.params, "  updated "
                                     "parameters", LM_F32_TOL)
    out["micro_mu"] = close_tree(two.opt.mu, card.opt.mu, "  first moment",
                                 LM_F32_TOL, scaled=True)
    out["k6_launches"] = counts["K6"]
    del params, card, two
    torch.cuda.empty_cache()
    return out


def tree_to(tree: dict, device: str) -> dict:
    """A copy of a nested dict of tensors (parameters, a batch) on
    ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_train() -> dict:
    """[train]: smollm-360m at full width and depth, bfloat16 compute,
    seeded weights, ``TRAIN_STEPS`` steps of 4 x 2,048 tokens (K6's forward
    in every layer, and again in the backward's recompute), then one more
    under the profiler; ``AUDIO_TRAIN_STEPS`` whisper-medium steps of 2 x
    (1,500 frames + 448 tokens), the full-size backward through
    bidirectional attention at a ragged S, and one more profiled; K6's
    backward timed at both models' shapes; then the float32 checks
    (``train_checks``)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.whisper import init_encdec

    out = {}
    for arch, init, batch, seq, n_steps in (
            (LM_ARCH, init_lm, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS),
            (AUDIO_ARCH, init_encdec, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ,
             AUDIO_TRAIN_STEPS)):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init(cfg, LM_SEED, device="cuda")
        data = train_batch(cfg, batch, seq, LM_SEED + 3)
        print(f"[train] {cfg.name}: {n_steps} step(s) of {batch} x "
              + (f"({cfg.encoder_frames} frames + {seq} tokens)"
                 if cfg.family == "audio" else f"{seq} tokens")
              + f", {cfg.dtype} compute, remat {cfg.remat}, AdamW "
              f"{TRAIN_OPT}")
        run = train_run(cfg, params, data, n_steps)
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params, data
        torch.cuda.empty_cache()
        # K6's backward at this model's attention shapes, a layer's worth
        if cfg.family == "audio":
            bwd = (cfg.n_encoder_layers * k6_backward_ms(
                cfg, batch, cfg.encoder_frames, causal=False)
                + cfg.n_layers * k6_backward_ms(cfg, batch, seq))
        else:
            bwd = cfg.n_layers * k6_backward_ms(cfg, batch, seq)
        step_ms = min(r["ms"] for r in run["rows"])
        run.update(k6_backward_ms_per_step=bwd,
                   k6_backward_share=bwd / step_ms)
        print(f"  peak memory {run['peak_gib']:.2f} GiB; K6's backward at "
              f"these shapes, every layer: {bwd:.2f} ms a step "
              f"({bwd / step_ms:.3f} of the fastest step's {step_ms:.1f} ms)")
        out[arch] = run
    out["checks"] = train_checks()
    return out


def launcher_step_probe(rows: list):
    """A ``make_train_step`` that times each step of the launcher (the
    card synchronised before and after) and records K6's launches in it,
    read as differences of the counters (none is reset)."""
    import torch
    from repro_torch.training import train_step

    def make(*args, **kwargs):
        step = train_step.make_train_step(*args, **kwargs)

        def timed(state, batch):
            torch.cuda.synchronize()
            before = read_counts()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = read_counts()
            rows.append(dict(ms=ms, **{k: after[k] - before[k] for k in
                                       ("K6", "K6 sm90_bf16")}))
            return out
        return timed
    return make


def launcher_cmd(ckpt_dir: Path) -> list:
    return [sys.executable, "-u", "-m", "repro_torch.launch.train",
            *LAUNCH_FLAGS, "--ckpt-dir", str(ckpt_dir)]


def torchrun_cmd(ckpt_dir: Path) -> list:
    """(h): one rank under torchrun, this script's ``--launcher-rank``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", str(REPO / "chip_smoke.py"),
            "--launcher-rank", *LAUNCH_FLAGS, "--ckpt-dir", str(ckpt_dir)]


def launcher_rank(argv: list) -> int:
    """One rank of (h), started by torchrun: ``launch/train.py``'s ``main``
    on ``argv``, each step timed and its K6 launches counted on this
    process's own counters (every count 0 just before the run, read just
    after); rank 0 prints them as one ``[launcher rank]`` JSON line."""
    from repro_torch.launch import train as launcher

    rows = []
    launcher.make_train_step = launcher_step_probe(rows)
    reset_counts()
    rc = launcher.main(argv)
    counts = read_counts()
    if os.environ.get("RANK") == "0":
        print("[launcher rank] " + json.dumps(dict(rows=rows, counts=counts)),
              flush=True)
    return rc


def child_pids(parent: int, marker: str) -> list:
    """The processes whose parent is ``parent`` and whose command line
    holds ``marker``."""
    pids = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            ppid = int(stat.read_text().rsplit(")", 1)[1].split()[1])
            cmd = (stat.parent / "cmdline").read_bytes()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == parent and marker.encode() in cmd:
            pids.append(int(stat.parent.name))
    return sorted(pids)


def launcher_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def run_launcher(ckpt_dir: Path, preempt_after: int | None = None,
                 torchrun: bool = False):
    """The launcher as a subprocess from the checkout's root (it reuses the
    kernels ``phase_build`` built under ``build/repro_torch``), or with
    ``torchrun`` one rank of it under torchrun; with ``preempt_after``,
    SIGTERM once it prints that step's line, to the launcher (to the rank,
    not to torchrun).  Returns (exit code, its output, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        torchrun_cmd(ckpt_dir) if torchrun else launcher_cmd(ckpt_dir),
        cwd=REPO, env=launcher_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            print("    | " + line.rstrip())
            if preempt_after is not None and f"step {preempt_after:5d} " \
                    in line:
                ranks = child_pids(proc.pid, "--launcher-rank") \
                    if torchrun else [proc.pid]
                check(len(ranks) == 1, f"torchrun's ranks: {ranks}")
                os.kill(ranks[0], signal.SIGTERM)
                preempt_after = None
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(lines), time.perf_counter() - t0


def ckpt_arrays(step_dir: Path) -> list:
    n = json.loads((step_dir / "manifest.json").read_text())["n_leaves"]
    with np.load(step_dir / "arrays.npz") as data:
        return [data[str(i)] for i in range(n)]


def differing_leaves(a: list, b: list) -> list:
    """The indices of the leaves that differ in value or bits."""
    return [i for i, (x, y) in enumerate(zip(a, b))
            if x.dtype != y.dtype or x.shape != y.shape
            or x.tobytes() != y.tobytes()]


def launcher_verdict(got: list, want: list, what: str) -> str:
    """``got``'s leaves against ``want``'s: bit for bit, else each leaf
    that differs (listed) within the train-step tolerance, ``2e-3`` of its
    largest magnitude."""
    check(len(got) == len(want), f"{what}: {len(got)} leaves, not "
                                 f"{len(want)}")
    bad = differing_leaves(got, want)
    if not bad:
        return "bit for bit"
    for i in bad:
        check(got[i].dtype == want[i].dtype and
              got[i].shape == want[i].shape, f"{what}: leaf {i}'s type "
                                              "or shape differs")
        x, y = got[i].astype(np.float64), want[i]
        err = float(np.abs(x - y).max())
        tol = 2e-3 * float(np.abs(y).max())
        print(f"    {what} leaf {i} {y.shape}: max abs {err:.3e}")
        check(err <= tol, f"{what}: leaf {i} off by {err} > {tol}")
    return f"within 2e-3 of each tensor's max (leaves {bad})"


def launcher_rank_rows(out: str) -> list:
    """The rows of each ``[launcher rank]`` line in ``out``."""
    return [r for line in out.splitlines() if "[launcher rank] " in line
            for r in json.loads(line.split("[launcher rank] ", 1)[1])["rows"]]


def launcher_spmd(a_dir: Path, arrays_a: list, n_k6: int) -> dict:
    """(h) the launcher on one torchrun rank, preempted and restarted; (i)
    its step-4 checkpoint resumed in this process on one device; each final
    checkpoint against (a)'s."""
    from repro_torch.runtime import checkpoint as ckpt

    h_dir, i_dir = LAUNCH_DIR / "h", LAUNCH_DIR / "i"
    final, half = (f"step_{LAUNCH_STEPS:08d}",
                   f"step_{LAUNCH_STEPS // 2:08d}")
    rc, out1, wall1 = run_launcher(h_dir, LAUNCH_PREEMPT_AFTER,
                                   torchrun=True)
    check(rc == 0 and "preemption requested" in out1,
          f"launcher (h) exited {rc} without a clean preemption")
    stopped = ckpt.latest_step(h_dir)
    check(stopped is not None and stopped <= LAUNCH_STEPS // 2,
          f"launcher (h) left step {stopped}, not one up to "
          f"{LAUNCH_STEPS // 2} for (i) to resume")
    rc, out2, wall2 = run_launcher(h_dir, torchrun=True)
    check(rc == 0 and f"resumed from step {stopped}" in out2
          and f"step {LAUNCH_STEPS - 1:5d} " in out2,
          f"launcher (h) restarted exited {rc} or did not resume")
    runs = [launcher_rank_rows(out1), launcher_rank_rows(out2)]
    rows = runs[0] + runs[1]
    check(len(rows) == LAUNCH_STEPS, f"launcher (h) ran {len(rows)} steps")
    for r in rows:
        check(r["K6"] == n_k6 and r["K6 sm90_bf16"] == n_k6,
              f"launcher (h) step launched K6 {r}, expected {n_k6} on "
              "sm90_bf16")
    verdict_h = launcher_verdict(ckpt_arrays(h_dir / final), arrays_a,
                                 "(h)")
    for name in {f"step_{stopped:08d}", final} - {half}:
        shutil.rmtree(h_dir / name)
    i_dir.mkdir()
    os.rename(h_dir / half, i_dir / half)
    (i_dir / "LATEST").write_text(half)
    shutil.rmtree(h_dir)
    i = launcher_run_a(i_dir)
    check(f"resumed from step {LAUNCH_STEPS // 2}" in i["text"],
          "launcher (i) did not resume from (h)'s step-4 checkpoint")
    check(k6_route_only(i["counts"], "sm90_bf16",
                        n_k6 * (LAUNCH_STEPS - LAUNCH_STEPS // 2)),
          f"launcher (i) launched K6 {i['counts']}")
    verdict_i = launcher_verdict(ckpt_arrays(i_dir / final), arrays_a,
                                 "(i)")
    shutil.rmtree(i_dir)
    return dict(stopped=stopped, ms=[r["ms"] for r in rows],
                warm_ms=[r["ms"] for run in runs for r in run[1:]],
                k6=[r["K6 sm90_bf16"] for r in rows],
                wall_s=[wall1, wall2], resume=verdict_h,
                i_ms=[r["ms"] for r in i["rows"]], i_wall_s=i["wall_s"],
                i_resume=verdict_i)


def launcher_run_a(ckpt_dir: Path) -> dict:
    """(a): ``main`` in this process, each step timed and counted, every
    count 0 just before and read just after the run."""
    import contextlib
    import io

    import torch
    from repro_torch.launch import train as launcher

    rows = []
    real = launcher.make_train_step
    launcher.make_train_step = launcher_step_probe(rows)
    out = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launcher.main(LAUNCH_FLAGS + ["--ckpt-dir", str(ckpt_dir)])
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        launcher.make_train_step = real
    for line in out.getvalue().splitlines():
        print("    | " + line)
    check(rc == 0, f"launcher (a) exited {rc}")
    return dict(rows=rows, counts=counts, wall_s=wall, text=out.getvalue(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def launcher_io(a_dir: Path, work: Path, arrays_a: list) -> dict:
    """(e): A's final checkpoint restored onto the CPU and onto the card,
    equal bit for bit; a synchronous save of the card state and an async
    one (the blocking snapshot, then the background write) timed, the
    async file equal to A's bit for bit."""
    import torch
    from repro_torch._tree import flatten
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.training import AdamWConfig, init_train_state

    like = init_train_state(init_lm(get_config(LM_ARCH), 0, device="cuda"),
                            AdamWConfig())
    t0 = time.perf_counter()
    host, step = ckpt.restore(a_dir, like, device="cpu")
    cpu_s = time.perf_counter() - t0
    del like
    t0 = time.perf_counter()
    card, _ = ckpt.restore(a_dir, host, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    leaves_h, leaves_c = flatten(host)[0], flatten(card)[0]
    check(step == LAUNCH_STEPS and len(leaves_h) == len(arrays_a),
          f"restore: step {step}, {len(leaves_h)} leaves")
    bad = [i for i, (h, c) in enumerate(zip(leaves_h, leaves_c))
           if c.device.type != "cuda" or not torch.equal(h, c.cpu())]
    check(not bad, f"restore onto the card != onto the CPU at leaves {bad}")
    nbytes = sum(t.numel() * t.element_size() for t in leaves_h)
    del host
    t0 = time.perf_counter()
    ckpt.save(work / "sync", step, card)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_async(work / "async", step, card)
    block_s = time.perf_counter() - t0
    ckpt.wait_for_saves()
    write_s = time.perf_counter() - t0 - block_s
    bad = differing_leaves(ckpt_arrays(work / "async" / f"step_{step:08d}"),
                       arrays_a)
    check(not bad, f"async save of the restored state != A at leaves {bad}")
    shutil.rmtree(work / "sync")
    shutil.rmtree(work / "async")
    return dict(gb=nbytes / 1e9, restore_cpu_s=cpu_s, restore_card_s=card_s,
                save_s=sync_s, save_gb_per_s=nbytes / 1e9 / sync_s,
                async_block_s=block_s, async_write_s=write_s,
                card=card)


def launcher_profile(state, step_ms: float) -> dict:
    """One step of the launcher's shape (``make_train_step`` on the
    restored state, its ``TokenPipeline`` batch of step 8) under the
    profiler: device time by group, K6's backward a group of its own, the
    busy share of the launcher's median warm step, and the kernels
    launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.training import AdamWConfig, make_train_step

    cfg = get_config(LM_ARCH)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=LAUNCH_STEPS))
    batch = {"tokens": torch.as_tensor(TokenPipeline(
        cfg.vocab_size, 128, 8).batch(LAUNCH_STEPS), device="cuda")}
    step(state, batch)
    torch.cuda.synchronize()
    with Marked(ops, "flash_attention_backward", "k6_backward"), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    by, top = kernel_groups(prof, ranges=(("k6_backward", "K6 backward"),))
    print_groups("launcher step", by, top, step_ms)
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "k6_backward")
    print(f"    {n} kernel launches in the step")
    return dict(groups=dict(by, total=sum(by.values())), kernels=n)


def launcher_compression(state) -> dict:
    """(f): one step's full-width gradients (bfloat16 compute, remat) through
    ``compress_tree`` / ``decompress_tree`` on the card: bf16 equal to a CPU
    copy bit for bit; int8 under uniforms drawn once, equal to a CPU copy
    bit for bit; int8 from the card's generator within one quantisation
    step a tensor; both timed (CUDA events)."""
    import torch
    from repro_torch._tree import flatten, unflatten
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.compression import (compress_tree,
                                                     decompress_tree)
    from repro_torch.training.train_step import lm_loss

    cfg = get_config(LM_ARCH)
    leaves, treedef = flatten(state.params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    tokens = TokenPipeline(cfg.vocab_size, 128, 8).batch(LAUNCH_STEPS)
    with torch.enable_grad():
        loss, _ = lm_loss(unflatten(treedef, leaves), {"tokens": tokens}, cfg)
        grads = unflatten(treedef, [g.detach() for g in torch.autograd.grad(
            loss, leaves)])
    del leaves
    host = flatten(grads)[0]
    host = unflatten(treedef, [g.cpu() for g in host])
    out = dict(n_floats=sum(g.numel() for g in flatten(grads)[0]))

    c, _ = compress_tree(grads, "bf16")
    bad = [i for i, (a, b) in enumerate(zip(
        flatten(c)[0], flatten(compress_tree(host, "bf16")[0])[0]))
        if not torch.equal(a.cpu().view(torch.int16), b.view(torch.int16))]
    check(not bad, f"bf16 compression on the card != CPU at leaves {bad}")
    del c
    out["bf16_ms"] = cuda_ms(lambda: decompress_tree(
        compress_tree(grads, "bf16")[0], None, "bf16"), 5)
    c, _ = compress_tree(grads, "bf16")
    out["bf16_compress_ms"] = cuda_ms(lambda: compress_tree(grads, "bf16"),
                                      5)
    out["bf16_decompress_ms"] = cuda_ms(lambda: decompress_tree(
        c, None, "bf16"), 5)
    del c

    gen = torch.Generator("cuda").manual_seed(LM_SEED + 7)
    uniforms = unflatten(treedef, [torch.rand(g.shape, generator=gen,
                                              device="cuda")
                                   for g in flatten(grads)[0]])
    q, s = compress_tree(grads, "int8", uniforms=uniforms)
    qh, sh = compress_tree(host, "int8", uniforms=unflatten(
        treedef, [u.cpu() for u in flatten(uniforms)[0]]))
    del uniforms
    bad = [i for i, (a, b, x, y) in enumerate(zip(
        flatten(q)[0], flatten(qh)[0], flatten(s)[0], flatten(sh)[0]))
        if not (torch.equal(a.cpu(), b) and torch.equal(x.cpu(), y))]
    check(not bad, f"int8 under replayed uniforms on the card != CPU at "
                   f"leaves {bad}")
    del q, s, qh, sh, host
    q, s = compress_tree(grads, "int8", generator=gen)
    deq = decompress_tree(q, s, "int8")
    worst = max(float((d - g).abs().max()) / float(sc) for d, g, sc in zip(
        flatten(deq)[0], flatten(grads)[0], flatten(s)[0]))
    check(worst <= 1 + 1e-6, f"int8: an error of {worst} quantisation steps")
    del q, s, deq
    out.update(int8_worst_steps=worst, int8_ms=cuda_ms(
        lambda: decompress_tree(*compress_tree(grads, "int8", generator=gen),
                                "int8"), 5))
    print(f"  (f) compression of one step's gradients ({out['n_floats']:,} "
          f"floats): bf16 == a CPU copy bit for bit, {out['bf16_ms']:.3f} ms "
          f"compress + decompress ({out['bf16_compress_ms']:.3f} + "
          f"{out['bf16_decompress_ms']:.3f} ms apart); int8 under replayed uniforms == a CPU "
          f"copy bit for bit, with the card's generator within "
          f"{worst:.4f} of a step, {out['int8_ms']:.3f} ms")
    return out


def launcher_pipeline(params) -> dict:
    """(g): the 32 layers as PIPE_STAGES stages on ``["cuda:0"] * 4``, 8
    microbatches of 1 x 512 tokens, through K6: bit for bit the stages run
    one after another on each microbatch; K6 once a layer and microbatch,
    every launch on ``sm90_bf16``.  One card checks the schedule, not a
    speed-up."""
    import torch
    from repro_torch._tree import map_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer
    from repro_torch.models.layers import Dtypes

    cfg = get_config(LM_ARCH)
    per = cfg.n_layers // PIPE_STAGES
    windows, dt = transformer.layer_windows(cfg), Dtypes.compute(cfg)

    def stage_fn(sp, x, s):
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for i in range(per):
            x, _ = transformer._layer({}, transformer.layer_params(sp, i), x,
                                      positions, cfg, dt,
                                      windows[s * per + i], 0)
        return x

    stages = map_leaves(lambda p: p.reshape(PIPE_STAGES, per, *p.shape[1:]),
                        params["layers"])
    tokens = np.random.RandomState(LM_SEED + 8).randint(
        0, cfg.vocab_size, (PIPE_MICRO, PIPE_TOKENS))
    with torch.no_grad():
        x = transformer.embed_inputs(params, tokens, cfg)[:, None]
        mesh = make_local_mesh(data=PIPE_STAGES,
                               devices=["cuda:0"] * PIPE_STAGES)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = pipeline_forward(stage_fn, stages, x, mesh, axis="data")
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        n = PIPE_MICRO * cfg.n_layers
        check(k6_route_only(counts, "sm90_bf16", n),
              f"pipeline launched K6 {counts}, expected {n} on sm90_bf16")
        t0 = time.perf_counter()
        bad = []
        for m in range(PIPE_MICRO):
            h = x[m]
            for s in range(PIPE_STAGES):
                h = stage_fn(map_leaves(lambda p: p[s], stages), h, s)
            if not torch.equal(got[m], h):
                bad.append(m)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    check(not bad, f"pipeline != the stages in sequence at microbatches {bad}")
    check(bool(torch.isfinite(got.float()).all()), "pipeline: non-finite")
    print(f"  (g) pipeline: {PIPE_STAGES} stages of {per} layers on "
          f"['cuda:0'] * {PIPE_STAGES}, {PIPE_MICRO} microbatches of 1 x "
          f"{PIPE_TOKENS}: == the stages in sequence bit for bit; K6 "
          f"{counts['K6']} launches (sm90_bf16 {counts['K6 sm90_bf16']}); "
          f"{pipe_ms:.1f} ms, in sequence {seq_ms:.1f} ms (one card: the "
          "schedule, not a speed-up)")
    return dict(k6=counts["K6"], k6_bf16=counts["K6 sm90_bf16"],
                ms=pipe_ms, sequential_ms=seq_ms)


def dryrun_grid_start():
    """``python -m repro_torch.launch.dryrun --all --force`` (every cell
    counted on meta tensors, no card) as a subprocess, its start time as
    ``t0``; ``main`` kills it if the run ends before it has."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--force"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    proc.t0 = time.perf_counter()
    STARTED.append(proc)
    return proc


def dryrun_grid_finish(proc) -> dict:
    """Wait for the grid; its cells' statuses must be ``DRYRUN_GRID``."""
    out, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - proc.t0
    lines = out.splitlines()
    status = [ln.split("]")[0].strip("[ ") for ln in lines
              if ln.startswith("[")]
    got = tuple(status.count(k) for k in ("ok", "skipped", "error"))
    print(f"  (a) the grid on meta (python -m repro_torch.launch.dryrun "
          f"--all): {got[0]} ok, {got[1]} skipped, {got[2]} errors, "
          f"{wall:.1f} s wall; its last line: {lines[-1] if lines else ''}")
    check(proc.returncode == 0 and got == DRYRUN_GRID,
          f"dryrun grid: exit {proc.returncode}, (ok, skipped, errors) = "
          f"{got}, expected {DRYRUN_GRID}:\n" + "\n".join(
              [ln for ln in lines if ln.startswith("[error")]
              + lines[-20:]))
    # every ok cell counted per device as the sharded program
    unsharded = [ln for ln in lines if ln.startswith("[ok")
                 and " sharded=True " not in ln]
    check(not unsharded, "dryrun grid: ok cells not counted as the sharded "
          "program:\n" + "\n".join(unsharded))
    return dict(ok=got[0], skipped=got[1], errors=got[2], wall_s=wall)


def dryrun_measure(name: str, run, meta_work: tuple, model_flops: float,
                   tokens: int, k6: int) -> dict:
    """Drive ``run()`` once on the card with the launch counts at 0 (K6
    ``k6`` times, all ``sm90_bf16``), count its work on the card (equal to
    ``meta_work`` exactly), time ``DRYRUN_REPS`` warm runs with CUDA events,
    profile ``DRYRUN_REPS`` more (the busy share: their device time a step
    over the median); returns the readings and ``run``'s first output."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.dryrun import count_work
    from repro_torch.launch.roofline import HW, roofline_terms

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    check(k6_route_only(counts, "sm90_bf16", k6)
          and all(counts[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5")),
          f"{name}: launches {counts}, expected K6 {k6} on sm90_bf16 and "
          "no other kernel")
    card_work = count_work(run)
    check(card_work == tuple(meta_work),
          f"{name}: counted on the card (flops, bytes) = {card_work}, on "
          f"meta {tuple(meta_work)}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(DRYRUN_REPS):
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DRYRUN_REPS):
            run()
            torch.cuda.synchronize()
    by, _ = kernel_groups(prof)
    by = {k: v / DRYRUN_REPS for k, v in by.items()}
    device_ms = sum(by.values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    rl = roofline_terms({"flops": card_work[0],
                         "bytes accessed": card_work[1]}, {}, 1,
                        model_flops=model_flops, tokens_per_step=tokens)
    roof_ms = rl.step_time * 1e3
    mfu = model_flops / HW.PEAK_FLOPS / (ms / 1e3)
    busy = min(device_ms / ms, 1.0) if device_ms else None
    print(f"  {name}: {ms:.3f} ms median of {DRYRUN_REPS} warm steps "
          f"({', '.join(f'{t:.3f}' for t in times)}); one-card roofline "
          f"{roof_ms:.4f} ms ({rl.bottleneck}: {card_work[0]:.6e} flops, "
          f"{card_work[1]:.6e} bytes, card == meta), measured / roofline "
          f"{ms / roof_ms:.3f}, MFU {mfu:.6f}, device busy "
          + (f"{busy:.3f}" if busy is not None else "not measured")
          + f" ({device_ms:.3f} ms a step over {DRYRUN_REPS} profiled: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              by.items(), key=lambda kv: -kv[1]))
          + f"), peak {peak:.2f} GiB, K6 {counts['K6']} on sm90_bf16")
    return out, dict(ms=ms, times=times, roofline_ms=roof_ms,
                     bottleneck=rl.bottleneck, flops=card_work[0],
                     bytes=card_work[1], measured_over_roofline=ms / roof_ms,
                     mfu=mfu, busy=busy, device_ms=device_ms, groups=by,
                     peak_gib=peak, k6=counts["K6"])


def dryrun_lm_cell(arch: str, shape_name: str, batch: int, k6: int,
                   meta_work: tuple) -> dict:
    """One LM cell of the grid at ``batch`` on the card, against
    ``meta_work``, its meta count at the same batch."""
    import torch
    from repro_torch.launch import dryrun

    fn, args, _, cfg, shape, meta, _, _ = dryrun.build_cell(
        arch, shape_name, False, batch_override=batch, device="cuda")
    mult = 6 if shape.kind == "train" else 2
    tokens = meta["tokens_per_step"]
    out, r = dryrun_measure(f"{arch} {shape_name} batch {batch}",
                            lambda: fn(*args), meta_work,
                            mult * cfg.active_param_count() * tokens,
                            tokens, k6)
    if shape.kind == "train":
        loss = out[1]["loss"]
        check(bool(torch.isfinite(loss)), f"{arch} {shape_name}: loss {loss}")
    else:
        logits = out[0]
        check(tuple(logits.shape) == (batch, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"{arch} {shape_name}: logits {tuple(logits.shape)} not "
              "finite or misshapen")
    return dict(r, batch=batch, tokens=tokens)


def dryrun_vdt_cell(meta_work: tuple) -> dict:
    """The paper cell at full size (N = 2^18, C = 8, |B| = 4N) on the card:
    seeded ``a``, ``b`` over the tree's node ids and ``q`` in [0, 1) (not
    a fitted tree), against ``meta_work`` and a CPU copy (``index_add_``
    reduces with atomics on the card)."""
    from repro_torch.configs import paper_vdt
    from repro_torch.launch import dryrun

    meta = paper_vdt.input_specs()[1]
    fn = dryrun.vdt_step_fn()
    cpu = dryrun.vdt_seeded_inputs(DRYRUN_VDT_SEED)
    card = {k: v.cuda() for k, v in cpu.items()}
    out, r = dryrun_measure(
        "paper-vdt lp_1m (N = 2^18, seeded blocks, not a fitted tree)",
        lambda: fn(*card.values()), meta_work, dryrun.vdt_model_flops(),
        meta["tokens_per_step"], 0)
    err = close(out, fn(*cpu.values()), "  paper-vdt: card vs a CPU copy")[0]
    return dict(r, max_abs_err=err, n_points=paper_vdt.N_POINTS,
                n_classes=paper_vdt.N_CLASSES,
                blocks=paper_vdt.BLOCKS_PER_POINT * paper_vdt.N_POINTS)


def dryrun_meta_counts() -> dict:
    """Each ``DRYRUN_CELLS`` cell's and the paper cell's work counted on
    meta at its card batch (host only)."""
    from repro_torch.configs import paper_vdt
    from repro_torch.launch import dryrun

    counts = {}
    for arch, shape_name, batch, _ in DRYRUN_CELLS:
        fn, args, *_ = dryrun.build_cell(arch, shape_name, False,
                                         batch_override=batch)
        counts[f"{arch} {shape_name}"] = dryrun.count_work(fn, *args)
    counts["paper-vdt lp_1m"] = dryrun.count_work(
        dryrun.vdt_step_fn(), *paper_vdt.input_specs()[0].values())
    return counts


def dryrun_k6_shapes() -> list:
    """K6's attention shape in each ``DRYRUN_CELLS`` cell that launches it:
    ``phase_k6_timing`` cases, bfloat16."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES

    cases = []
    for arch, shape_name, batch, k6 in DRYRUN_CELLS:
        if k6:
            cfg = get_config(arch)
            cases.append(((f"{arch} {shape_name}", batch, cfg.n_heads,
                           cfg.n_kv_heads, SHAPES[shape_name].seq_len,
                           cfg.head_dim_, cfg.sliding_window or 0, True),
                          torch.bfloat16))
    return cases


def phase_dryrun(grid=None) -> dict:
    """[dryrun]: (a) the whole grid counted on meta in a subprocess (``grid``,
    started earlier so that it overlaps the phases before, else here); (b)
    meanwhile, the cells' meta counts and K6 against its plain version at
    the cells' attention shapes (launches of milliseconds each, timed on the
    device); (c) once the grid has ended, each ``DRYRUN_CELLS`` cell and the
    paper cell timed on the card with no other work on the host."""
    import torch

    print("[dryrun] (a) the grid on meta in a subprocess; (b) meanwhile the "
          "cells' meta counts and K6 at their shapes; (c) then the cells on "
          "the card at a batch it holds, each against its meta count")
    t0 = time.perf_counter()
    grid = dryrun_grid_start() if grid is None else grid
    try:
        meta_work = dryrun_meta_counts()
        k6 = phase_k6_timing(dryrun_k6_shapes())
        result = dict(grid=dryrun_grid_finish(grid))
    finally:
        if grid.poll() is None:
            grid.kill()
            grid.wait()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cells = {}
    for arch, shape_name, batch, n_k6 in DRYRUN_CELLS:
        cell = f"{arch} {shape_name}"
        cells[cell] = dryrun_lm_cell(arch, shape_name, batch, n_k6,
                                     meta_work[cell])
        torch.cuda.empty_cache()
    cells["paper-vdt lp_1m"] = dryrun_vdt_cell(meta_work["paper-vdt lp_1m"])
    result.update(cells=cells, k6={r["name"]: r for r in k6},
                  cells_wall_s=time.perf_counter() - t1,
                  wall_s=time.perf_counter() - t0)
    print(f"  [dryrun] phase wall {result['wall_s']:.1f} s (the cells "
          f"alone {result['cells_wall_s']:.1f} s)")
    return result


def spmd_full(t):
    from repro_torch._device import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def spmd_close(name: str, got, want, rtol: float, atol_frac: float) -> tuple:
    """``got`` (a DTensor, gathered) within ``rtol`` and ``atol_frac`` of
    ``want``'s largest magnitude (at least 1; a first moment's own);
    returns (max abs err, bit for bit)."""
    import torch

    got = spmd_full(got)
    diff = (got.double() - want.double()).abs()
    scale = float(want.abs().max())
    atol = rtol * scale if name.startswith("mu") else \
        atol_frac * max(1.0, scale)
    err = float(diff.max())
    check(bool(torch.isfinite(got.float()).all())
          and bool((diff <= atol + rtol * want.double().abs()).all()),
          f"[spmd] {name}: max abs err {err:.3e} outside rtol={rtol}, "
          f"atol={atol:.3e}")
    return err, bool(torch.equal(got, want))


def spmd_extras(cfg, batch: int, seed: int) -> dict:
    """A vlm's patch or an audio model's frame embeddings (B, P or T_enc,
    D), seeded, on the card; nothing for another family."""
    import torch

    if cfg.family not in ("vlm", "audio"):
        return {}
    name, n = (("frames", cfg.encoder_frames) if cfg.family == "audio"
               else ("patches", cfg.n_patches))
    return {name: torch.as_tensor(np.random.RandomState(seed).randn(
        batch, n, cfg.d_model).astype(np.float32), device="cuda")}


def k6_per_forward(cfg) -> int:
    """K6's launches in one forward over a prompt: each self-attention
    layer (whisper's encoder layers too; a hybrid's shared-block points)."""
    if cfg.family == "audio":
        return cfg.n_layers + cfg.n_encoder_layers
    if cfg.family == "hybrid":
        return sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    return 0 if cfg.family == "ssm" else cfg.n_layers


def spmd_prefill(ctx, cfg, params, tokens, k6: int, label: str,
                 extras=None):
    """A bfloat16 prefill of ``tokens`` (after a vlm's patches, or an audio
    model's frames through its encoder: ``extras``) with ``params`` as
    DTensors (sharded by ``shard_params``, the batch by ``shard_batch``)
    against the same call on plain tensors, K6's launches counted in the
    sharded call (all ``k6`` on ``sm90_bf16``).  Returns ``(result, plain
    state, sharded params, sharded state)``."""
    import torch
    from repro_torch.distributed.sharding import (shard_batch, shard_params,
                                                  use_ctx)
    from repro_torch.serving.decode import prefill

    out = {}
    extras = extras or {}
    want, state = prefill(params, tokens, cfg, **extras)
    sharded = shard_params(params, ctx, expert_parallel=cfg.expert_parallel)
    stokens = shard_batch(tokens, ctx)
    sextras = {k: shard_batch(v, ctx) for k, v in extras.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with use_ctx(ctx):
        got, sstate = prefill(sharded, stokens, cfg, **sextras)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    counts = read_counts()
    check(k6_route_only(counts, "sm90_bf16", k6),
          f"[spmd] {label} sharded prefill: launches {counts}, expected K6 "
          f"{k6} on sm90_bf16")
    out["prefill_k6"] = counts["K6"]
    out["prefill_err"], out["prefill_bitwise"] = spmd_close(
        f"{label} prefill logits", got, want, SPMD_BF16_TOL, SPMD_BF16_TOL)
    b, n = tokens.shape
    print(f"  (a) {label}, one-rank NCCL mesh, bf16 prefill {b} x {n}: "
          f"{out['prefill_s']:.2f} s host (first call), K6 {counts['K6']} "
          f"on sm90_bf16, logits vs plain tensors max abs err "
          f"{out['prefill_err']:.3e}, bit for bit {out['prefill_bitwise']}")
    return out, (want, state), sharded, (got, sstate)


def spmd_decode(ctx, cfg, params, sharded, plain, spmd, label: str) -> dict:
    """``SPMD_DECODE`` greedy decode steps (the plain run's tokens) from the
    prefill states ``plain`` and ``spmd`` (``(logits, state)`` each), the
    sharded steps' logits against the plain ones."""
    import torch
    from repro_torch.distributed.sharding import shard_batch, use_ctx
    from repro_torch.serving.decode import decode_step

    (want, state), (_, sstate) = plain, spmd
    errs, bitwise = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SPMD_DECODE):
        token = want.argmax(-1)[:, None]
        want, state = decode_step(params, token, state, cfg)
        with use_ctx(ctx):
            got, sstate = decode_step(sharded, shard_batch(token, ctx),
                                      sstate, cfg)
        err, same = spmd_close(f"{label} decode logits", got, want,
                               SPMD_BF16_TOL, SPMD_BF16_TOL)
        errs.append(err)
        bitwise.append(same)
    torch.cuda.synchronize()
    out = dict(decode_s=time.perf_counter() - t0, decode_err=max(errs),
               decode_bitwise=all(bitwise))
    print(f"  (a) {label}, {SPMD_DECODE} decode steps (plain and sharded, "
          f"{out['decode_s']:.2f} s host): logits max abs err "
          f"{out['decode_err']:.3e}, bit for bit {out['decode_bitwise']}")
    return out


def spmd_train(ctx, cfg, params, label: str, seq: int = 0) -> dict:
    """One float32 train step of ``SPMD_TRAIN[0]`` x ``seq`` tokens (0:
    ``SPMD_TRAIN[1]``; after
    a vlm's patches or an audio model's frames) (AdamW with ``SPMD_OPT``)
    with ``params`` as DTensors against the same step on plain tensors:
    loss, grad norm, every updated parameter and first moment at
    ``SPMD_F32_RTOL``; K6's launches in the sharded step, all on
    ``sm90_tf32x3`` (two a self-attention layer with remat).  The plain
    step's results wait on the host meanwhile, so that the card holds one
    step's state."""
    import dataclasses

    import torch
    from repro_torch.distributed.sharding import (shard_batch, shard_params,
                                                  use_ctx)
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    out = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    opt = AdamWConfig(**SPMD_OPT)
    step = make_train_step(cfg32, opt)
    b, seq = SPMD_TRAIN[0], seq or SPMD_TRAIN[1]
    batch = {"tokens": torch.as_tensor(np.random.RandomState(
        LM_SEED + 5).randint(0, cfg.vocab_size, (b, seq + 1)),
        device="cuda"), **spmd_extras(cfg, b, LM_SEED + 6)}
    new, pm = step(init_train_state(params, opt), batch)
    want = dict(loss=pm["loss"].cpu(), grad_norm=pm["grad_norm"].cpu(),
                **{f"param {k}": w.cpu() for k, (w, _) in
                   _spmd_pairs(new.params, new.params)},
                **{f"mu {k}": w.cpu() for k, (w, _) in
                   _spmd_pairs(new.opt.mu, new.opt.mu)})
    del new, pm
    torch.cuda.empty_cache()
    state = init_train_state(shard_params(
        params, ctx, expert_parallel=cfg.expert_parallel), opt)
    sbatch = {k: shard_batch(v, ctx) for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with use_ctx(ctx):
        new, m = step(state, sbatch)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    counts = read_counts()
    k6 = 2 * k6_per_forward(cfg)
    check(k6_route_only(counts, K6_F32_ROUTE, k6),
          f"[spmd] {label} sharded f32 train step: launches {counts}, "
          f"expected K6 {k6} on {K6_F32_ROUTE}")
    out["train_k6"] = counts["K6"]
    del state
    got = dict(loss=m["loss"], grad_norm=m["grad_norm"],
               **{f"param {k}": g for k, (g, _) in
                  _spmd_pairs(new.params, new.params)},
               **{f"mu {k}": g for k, (g, _) in
                  _spmd_pairs(new.opt.mu, new.opt.mu)})
    errs, bitwise = {}, {}
    for name, w in want.items():
        errs[name], bitwise[name] = spmd_close(
            f"{label} {name}", got[name], w.cuda(), SPMD_F32_RTOL, 1e-6)
    out["train_max_abs_err"] = max(errs.values())
    out["train_bitwise"] = sorted(k for k, v in bitwise.items() if v)
    out["train_not_bitwise"] = sorted(k for k, v in bitwise.items()
                                      if not v)
    print(f"  (a) {label}, one-rank NCCL mesh, f32 train step {b} x {seq}: "
          f"{out['train_s']:.2f} s host (first call), K6 {counts['K6']} "
          f"on {K6_F32_ROUTE}, loss {float(spmd_full(m['loss'])):.6f} vs "
          f"{float(want['loss']):.6f}, max abs err over loss, grad norm, "
          f"params and moments {out['train_max_abs_err']:.3e}; bit for "
          f"bit: {len(out['train_bitwise'])} of {len(bitwise)} "
          f"(not: {', '.join(out['train_not_bitwise'][:8])}"
          f"{' ...' if len(out['train_not_bitwise']) > 8 else ''})")
    del new, m, got
    torch.cuda.empty_cache()
    return out


def spmd_one_rank(ctx) -> dict:
    """(a): smollm-360m over the one-rank NCCL mesh of ``ctx``, prefill and
    train step against plain tensors, K6's launches counted in each
    sharded call; and a prefill with ``seq_shard`` and ``attn_seq_shard``
    on (the sequence gathered before each block, the residual scattered
    back)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm

    cfg = get_config(LM_ARCH)
    params = init_lm(cfg, LM_SEED, device="cuda")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    out, *_ = spmd_prefill(ctx, cfg, params, tokens, cfg.n_layers, LM_ARCH)
    seq, *_ = spmd_prefill(
        dataclasses.replace(ctx, seq_shard=True, attn_seq_shard=True), cfg,
        params, tokens, cfg.n_layers, f"{LM_ARCH} seq_shard attn_seq_shard")
    out["seq_shard"] = seq
    out.update(spmd_train(ctx, cfg, params, LM_ARCH))
    del params
    torch.cuda.empty_cache()
    return out


def spmd_family(ctx, arch: str, layers, k6: int, train_layers) -> dict:
    """(a) for one of ``SPMD_FAMILIES``: the bfloat16 prefill at full width
    (``layers`` of its depth), ``SPMD_DECODE`` decode steps, and a float32
    train step of ``train_layers``, each against plain tensors."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, LM_SEED, device="cuda")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    label = f"{arch} ({cfg.n_layers} of {full.n_layers} layers)"
    out, plain, sharded, spmd = spmd_prefill(ctx, cfg, params, tokens, k6,
                                             label)
    if cfg.family in ("ssm", "hybrid"):
        # decode after a prefill of SSM_CHECK_PROMPT tokens (one SSD chunk;
        # zamba2-1.2b's ring then holds exactly one window)
        del plain, spmd
        dcfg = dataclasses.replace(cfg, sliding_window=SSM_CHECK_PROMPT) \
            if cfg.family == "hybrid" else cfg
        n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers)) \
            if cfg.family == "hybrid" else 0
        _, plain, sharded, spmd = spmd_prefill(
            ctx, dcfg, params, tokens[:, :SSM_CHECK_PROMPT], n_attn,
            f"{label}, decode check")
        cfg = dcfg
    out.update(spmd_decode(ctx, cfg, params, sharded, plain, spmd, label))
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del plain, spmd, sharded
    if train_layers is not None:
        if train_layers != cfg.n_layers:
            del params
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, n_layers=train_layers)
            params = init_lm(cfg, LM_SEED, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        out.update(spmd_train(ctx, cfg, params,
                              f"{arch} ({cfg.n_layers} layers)"))
        out.update(train_layers=cfg.n_layers,
                   train_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  (a) {arch}: peak {out['serve_peak_gib']:.2f} GiB serving"
          + ("" if train_layers is None else
             f", {out['train_peak_gib']:.2f} GiB in the train step"))
    del params
    torch.cuda.empty_cache()
    return out


def spmd_encdec(ctx, arch: str, k6: int, prompt: int, train_seq: int
                ) -> dict:
    """(a) for one of ``SPMD_ENCDEC`` at full width and depth: the bfloat16
    prefill of ``LM_BATCH`` x ``prompt`` tokens after its patch or frame
    embeddings (K6 ``k6`` times), ``SPMD_DECODE`` decode steps and a
    float32 train step of ``train_seq`` text tokens, each against plain
    tensors."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.whisper import init_encdec

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init = init_encdec if cfg.family == "audio" else init_lm
    params = init(cfg, LM_SEED, device="cuda")
    tokens = torch.as_tensor(lm_tokens(cfg, prompt), device="cuda")
    out, plain, sharded, spmd = spmd_prefill(
        ctx, cfg, params, tokens, k6, arch,
        spmd_extras(cfg, LM_BATCH, LM_SEED + 2))
    out.update(spmd_decode(ctx, cfg, params, sharded, plain, spmd, arch))
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del plain, spmd, sharded
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out.update(spmd_train(ctx, cfg, params, arch, seq=train_seq))
    out.update(train_layers=cfg.n_layers,
               train_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  (a) {arch}: peak {out['serve_peak_gib']:.2f} GiB serving, "
          f"{out['train_peak_gib']:.2f} GiB in the train step")
    del params
    torch.cuda.empty_cache()
    return out


def spmd_paper(mesh) -> dict:
    """(a) the paper's LP step at full size with every input's rows over
    ``mesh`` (the one-rank NCCL mesh) against the plain step on the same
    seeded inputs (the [dryrun] cell's), with float32 and bfloat16
    carriers; each timed over ``SPMD_PAPER_REPS`` steps, sharded and
    plain in turns."""
    import torch
    from torch.distributed.tensor import Shard
    from repro_torch.configs import paper_vdt
    from repro_torch.core.distributed import lp_step_leaforder, shard_rows
    from repro_torch.launch import dryrun

    args = list(dryrun.vdt_seeded_inputs(DRYRUN_VDT_SEED,
                                         device="cuda").values())
    sargs = [shard_rows(t, mesh) for t in args]
    L = paper_vdt.input_specs()[1]["L"]
    out = {}
    for name, dt, rtol, atol in (
            ("f32", None, RTOL, ATOL),
            ("bf16", torch.bfloat16, SPMD_PAPER_BF16_TOL,
             SPMD_PAPER_BF16_TOL)):
        def step(a):
            return lp_step_leaforder(*a, paper_vdt.ALPHA, L,
                                     carrier_dtype=dt)

        want = step(args)
        t0 = time.perf_counter()
        got = step(sargs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check(tuple(got.placements) == (Shard(0),) * mesh.ndim,
              f"[spmd] paper step ({name}): placements {got.placements}")
        full = got.full_tensor()
        err = close(full, want, f"  (a) paper-vdt LP step, {name} carriers,"
                    " sharded vs plain", rtol, atol)[0]
        ms, plain_ms = [], []
        for _ in range(2):
            ms.append(cuda_ms(lambda: step(sargs), SPMD_PAPER_REPS))
            plain_ms.append(cuda_ms(lambda: step(args), SPMD_PAPER_REPS))
        out[name] = dict(max_abs_err=err, bitwise=bool(torch.equal(
            full, want)), first_call_s=first_s, ms=ms, plain_ms=plain_ms)
        print(f"  (a) paper-vdt LP step (N = 2^18, C = 8, |B| = 4N), "
              f"{name} carriers, one-rank NCCL mesh: bit for bit "
              f"{out[name]['bitwise']}, first sharded call {first_s:.3f} s "
              f"host; {SPMD_PAPER_REPS} steps in turns: sharded "
              f"{', '.join(f'{t:.3f}' for t in ms)} ms, plain "
              f"{', '.join(f'{t:.3f}' for t in plain_ms)} ms a step")
    return out


def _spmd_pairs(a: dict, b: dict, prefix: str = ""):
    for k in a:
        if isinstance(a[k], dict):
            yield from _spmd_pairs(a[k], b[k], f"{prefix}{k}/")
        else:
            yield prefix + k, (a[k], b[k])


def spmd_fake_count(arch: str, shape_name: str, batch: int, layers,
                    switches: dict, device: str):
    """(b): one cell of the dry run, as ``build_sharded_cell`` makes it
    (``layers`` of the architecture's depth, None = all; ``switches`` the
    ``ShardCtx`` switches ``perf_iter``'s variants set, ``dryrun.CTX_KW``;
    the paper cell its row-sharded LP step, seeded on the card), counted
    per device on a fake group of ``SPMD_FAKE_MESH`` ranks, its shards on
    ``device``; returns ``(work, host s, the cell's ShardCtx)``."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh

    mesh = device_mesh(SPMD_FAKE_MESH, ("data", "model"), "cuda")
    ctx = None
    if arch == "paper-vdt":
        fn = dryrun.vdt_step_fn()
        args = dryrun.vdt_sharded_inputs(mesh, device=device)
    else:
        cfg = None if layers is None else dataclasses.replace(
            get_config(arch), n_layers=layers)
        dryrun.CTX_KW.update(switches)
        try:
            fn, args, *_, ctx = dryrun.build_sharded_cell(
                arch, shape_name, False, cfg_override=cfg,
                batch_override=batch, device=device, mesh=mesh)
        finally:
            dryrun.CTX_KW.clear()
    t0 = time.perf_counter()
    work = dryrun.count_sharded(fn, *args)
    if device != "meta":
        torch.cuda.synchronize()
    return work, time.perf_counter() - t0, ctx


def spmd_smoke_step_count(device: str):
    """(c): ``SPMD_SMOKE_STEP``'s sharded train step (AdamW) counted per
    device on a fake group of ``SPMD_FAKE_MESH`` ranks, its shards on
    ``device`` (tokens seeded on the card); returns ``(work, host s)``."""
    import dataclasses

    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import (ShardCtx, placements,
                                                  shard_params, use_ctx)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    arch, b, s, hd = SPMD_SMOKE_STEP
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              head_dim=hd)
    mesh = device_mesh(SPMD_FAKE_MESH, ("data", "model"), "cuda")
    ctx = ShardCtx(mesh=mesh)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(shard_params(init_lm(cfg, 0, device=device),
                                          ctx), opt)
    if device == "meta":
        tokens = torch.empty((b, s + 1), dtype=torch.int64, device="meta")
    else:
        tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), device=device,
                               generator=torch.Generator(device)
                               .manual_seed(0))
    tokens = distribute_tensor(tokens, mesh, placements(("data", None), mesh),
                               src_data_rank=None)
    step = make_train_step(cfg, opt)

    def fn(state, tokens):
        with use_ctx(ctx):
            return step(state, {"tokens": tokens})

    t0 = time.perf_counter()
    work = dryrun.count_sharded(fn, state, tokens)
    if device != "meta":
        torch.cuda.synchronize()
    return work, time.perf_counter() - t0


def phase_spmd() -> dict:
    """[spmd]: (a) the one-rank NCCL mesh against plain tensors: the
    paper's LP step, smollm-360m, ``SPMD_FAMILIES`` and ``SPMD_ENCDEC``;
    (b) the dry run's sharded cells on a fake 2 x 2 group, card == meta;
    (c) ``SPMD_SMOKE_STEP`` on the fake group, card == meta, its
    collective bytes by kind."""
    import tempfile

    import torch
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import (device_mesh, fake_process_group,
                                         file_process_group)
    from repro_torch.launch.roofline import collective_bytes

    print(f"[spmd] the paper's LP step and the LMs as DTensors (torch "
          f"{torch.__version__}): (a) the LP step at full size, {LM_ARCH}, "
          f"{', '.join(a for a, *_ in SPMD_FAMILIES + SPMD_ENCDEC)} over a "
          "one-rank NCCL mesh against plain tensors; (b) the dry run's "
          "sharded cells counted per device on a fake group of "
          f"{SPMD_FAKE_MESH[0]} x {SPMD_FAKE_MESH[1]} ranks, CUDA shards == "
          "meta shards")
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp, file_process_group(
            "nccl", 0, 1, Path(tmp) / "store", device="cuda:0"):
        ctx = ShardCtx(mesh=device_mesh((1, 1), ("data", "model"), "cuda"))
        paper = spmd_paper(ctx.mesh)
        torch.cuda.empty_cache()
        out = spmd_one_rank(ctx)
        out["paper"] = paper
        out["families"] = {arch: spmd_family(ctx, arch, *rest)
                           for arch, *rest in SPMD_FAMILIES}
        out["families"].update({arch: spmd_encdec(ctx, arch, *rest)
                                for arch, *rest in SPMD_ENCDEC})
    cells = {}
    with fake_process_group(SPMD_FAKE_MESH[0] * SPMD_FAKE_MESH[1]):
        for arch, shape_name, batch, layers, switches in SPMD_FAKE_CELLS:
            reset_counts()
            card, card_s, ctx = spmd_fake_count(arch, shape_name, batch,
                                                layers, switches, "cuda")
            k6 = read_counts()
            torch.cuda.empty_cache()
            meta, meta_s, _ = spmd_fake_count(arch, shape_name, batch,
                                              layers, switches, "meta")
            coll = collective_bytes(card.collectives)
            cell = f"{arch} {shape_name}" + "".join(
                f" {k}" for k in sorted(switches))
            if ctx is not None:
                print(f"  (b) {cell}: seq_shard={ctx.seq_shard} "
                      f"attn_seq_shard={ctx.attn_seq_shard}; K6 launches on "
                      f"the card {k6['K6']} (" + ", ".join(
                          f"{k} {v}" for k, v in k6.items()
                          if k.startswith("K6 ")) + ")")
                check(ctx.seq_shard == (shape_name == "prefill_32k"),
                      f"[spmd] {cell}: seq_shard {ctx.seq_shard}")
                check(k6["K6"] == k6["K6 sm90_bf16"]
                      + k6[f"K6 {K6_F32_ROUTE}"]
                      and (k6["K6"] > 0 or not switches),
                      f"[spmd] {cell}: K6 launches {k6}")
            print(f"  (b) {cell} at "
                  + ("full size" if batch is None else f"batch {batch}")
                  + f"{'' if layers is None else f', {layers} layers'}, fake "
                  f"group {SPMD_FAKE_MESH}: per device on the card "
                  f"{card.flops:.6e} flops, {card.bytes:.6e} bytes, "
                  f"collectives {coll} ({card_s:.2f} s host); on meta "
                  f"{meta.flops:.6e} flops, {meta.bytes:.6e} bytes, "
                  f"{len(meta.collectives)} collectives ({meta_s:.2f} s host)")
            check((card.flops, card.bytes, card.collectives)
                  == (meta.flops, meta.bytes, meta.collectives),
                  f"[spmd] {cell}: the fake group's count on the card "
                  f"differs from meta: flops {card.flops} vs {meta.flops}, "
                  f"bytes {card.bytes} vs {meta.bytes}, collectives "
                  f"{coll} vs {collective_bytes(meta.collectives)}")
            # the paper step counts no products (FLOPs are products only)
            check((card.flops > 0 or arch == "paper-vdt") and card.bytes > 0
                  and coll["count"] > 0,
                  f"[spmd] {cell}: an empty count on the fake group")
            cells[cell] = dict(
                batch=batch, layers=layers, flops_per_device=card.flops,
                k6_flops_per_device=card.k6_flops,
                bytes_per_device=card.bytes, collectives=coll,
                card_count_s=card_s, meta_count_s=meta_s,
                **({} if ctx is None else dict(
                    seq_shard=ctx.seq_shard,
                    attn_seq_shard=ctx.attn_seq_shard, k6_launches=k6["K6"])))
            del card, meta
            torch.cuda.empty_cache()
        reset_counts()
        card, card_s = spmd_smoke_step_count("cuda")
        k6 = read_counts()
        meta, meta_s = spmd_smoke_step_count("meta")
        coll = collective_bytes(card.collectives)
        arch, b, s, hd = SPMD_SMOKE_STEP
        cell = f"{arch} SMOKE train {b}x{s} (heads of {hd})"
        print(f"  (c) {cell}, fake group {SPMD_FAKE_MESH}: collective bytes "
              "per device by kind on the card " + ", ".join(
                  f"{k} {v:,}" for k, v in coll.items())
              + f" ({card_s:.2f} s host); K6 launches {k6['K6']}; on meta "
              f"{collective_bytes(meta.collectives)['total']:,} bytes "
              f"({meta_s:.2f} s host)")
        check((card.flops, card.bytes, card.collectives)
              == (meta.flops, meta.bytes, meta.collectives),
              f"[spmd] {cell}: the fake group's count on the card differs "
              f"from meta: collectives {coll} vs "
              f"{collective_bytes(meta.collectives)}")
        check(k6["K6"] > 0 and coll["all-reduce"] > 0
              and coll["all-to-all"] == 0,
              f"[spmd] {cell}: K6 launches {k6['K6']}, collectives {coll}")
        cells[cell] = dict(batch=b, seq=s, collectives=coll,
                           flops_per_device=card.flops,
                           bytes_per_device=card.bytes, k6_launches=k6["K6"],
                           card_count_s=card_s, meta_count_s=meta_s)
        del card, meta
        torch.cuda.empty_cache()
    out.update(fake_mesh=list(SPMD_FAKE_MESH), fake_cells=cells)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[spmd] phase wall {out['wall_s']:.1f} s")
    return out


def phase_train_launcher() -> dict:
    """[train launcher]: ``launch/train.py`` at smollm-360m's full
    configuration, ``LAUNCH_FLAGS``: (a) uninterrupted, in this process;
    (b) the same command as a subprocess, SIGTERM after its step-2 line: it
    prints ``preemption requested``, checkpoints and exits 0; (c) the same
    command again, resumed to the end; (d) its final checkpoint against
    (a)'s, bit for bit (else a second (a), and if the two uninterrupted runs
    differ, the train-step tolerance); (h) one torchrun rank of the
    launcher's SPMD path, preempted and restarted, against (a); (i) (h)'s
    step-4 checkpoint resumed on one device against (a); (e) restores and
    saves timed; (f) gradient compression; (g) the pipeline."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import checkpoint as ckpt

    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    free = shutil.disk_usage(LAUNCH_DIR).free / 1e9
    print(f"[train launcher] {LM_ARCH} through launch/train.py "
          f"{' '.join(LAUNCH_FLAGS)}; {free:.1f} GB free under build/")
    try:
        a_dir, b_dir = LAUNCH_DIR / "a", LAUNCH_DIR / "b"
        final = f"step_{LAUNCH_STEPS:08d}"
        a = launcher_run_a(a_dir)
        steps = a["rows"]
        cfg = get_config(LM_ARCH)
        n_k6 = k6_points(cfg) * (2 if cfg.remat else 1)  # + the recompute
        for r in steps:
            check(r["K6"] == n_k6 and r["K6 sm90_bf16"] == n_k6,
                  f"launcher step launched K6 {r}, expected {n_k6} on "
                  "sm90_bf16")
        check(k6_route_only(a["counts"], "sm90_bf16", n_k6 * LAUNCH_STEPS),
              f"launcher (a) launched K6 {a['counts']}")
        warm = [r["ms"] for r in steps[1:]]
        print(f"  (a) uninterrupted, in process: {a['wall_s']:.2f} s; steps "
              + ", ".join(f"{r['ms']:.1f}" for r in steps) + " ms; warm "
              f"{min(warm):.1f}-{max(warm):.1f} ms a step "
              f"({LAUNCH_TOKENS / np.median(warm) * 1e3:.0f} tokens/s at the "
              f"median); K6 {n_k6} launches a step, all sm90_bf16; peak "
              f"{a['peak_gib']:.2f} GiB")
        torch.cuda.empty_cache()
        shutil.rmtree(a_dir / f"step_{LAUNCH_STEPS // 2:08d}")
        rc_b, out_b, wall_b = run_launcher(b_dir, LAUNCH_PREEMPT_AFTER)
        check(rc_b == 0 and "preemption requested" in out_b,
              f"launcher (b) exited {rc_b} without a clean preemption")
        stopped = ckpt.latest_step(b_dir)
        check(stopped is not None and stopped < LAUNCH_STEPS,
              f"launcher (b) left step {stopped}")
        print(f"  (b) preempted after step {LAUNCH_PREEMPT_AFTER}'s line: "
              f"exit 0, checkpoint at step {stopped}, {wall_b:.2f} s")
        rc_c, out_c, wall_c = run_launcher(b_dir)
        check(rc_c == 0 and f"resumed from step {stopped}" in out_c
              and f"step {LAUNCH_STEPS - 1:5d} " in out_c,
              f"launcher (c) exited {rc_c} or did not resume from {stopped}")
        print(f"  (c) restarted: resumed from step {stopped}, ran to step "
              f"{LAUNCH_STEPS}, {wall_c:.2f} s")
        arrays_a = ckpt_arrays(a_dir / final)
        bad = differing_leaves(ckpt_arrays(b_dir / final), arrays_a)
        verdict = "bit for bit"
        if bad:
            a2 = launcher_run_a(LAUNCH_DIR / "a2")
            twin = differing_leaves(ckpt_arrays(LAUNCH_DIR / "a2" / final),
                                arrays_a)
            check(bool(twin), f"two uninterrupted runs agree but the "
                              f"resumed one differs at leaves {bad}")
            print(f"  two uninterrupted runs differ at leaves {twin} "
                  f"({len(a2['rows'])} steps)")
            verdict = launcher_verdict(ckpt_arrays(b_dir / final), arrays_a,
                                       "(d)")
        print(f"  (d) resumed run's step-{LAUNCH_STEPS} checkpoint == the "
              f"uninterrupted run's: {verdict}")
        shutil.rmtree(b_dir)
        torch.cuda.empty_cache()
        spmd = launcher_spmd(a_dir, arrays_a, n_k6)
        print(f"  (h) one torchrun rank, the state as DTensors: preempted "
              f"after step {LAUNCH_PREEMPT_AFTER}'s line, checkpoint at step "
              f"{spmd['stopped']}, restarted to step {LAUNCH_STEPS} "
              f"({spmd['wall_s'][0]:.2f} + {spmd['wall_s'][1]:.2f} s); steps "
              + ", ".join(f"{ms:.1f}" for ms in spmd["ms"]) + " ms (median "
              f"warm {np.median(spmd['warm_ms']):.1f}, the first step of "
              f"each run cold, against (a)'s {np.median(warm):.1f}); K6 {n_k6} launches a step, all "
              f"sm90_bf16; step-{LAUNCH_STEPS} checkpoint against (a)'s: "
              f"{spmd['resume']}")
        print(f"  (i) (h)'s step-{LAUNCH_STEPS // 2} checkpoint resumed on "
              f"one device in process ({spmd['i_wall_s']:.2f} s; steps "
              + ", ".join(f"{ms:.1f}" for ms in spmd["i_ms"]) + " ms): "
              f"step-{LAUNCH_STEPS} checkpoint against (a)'s: "
              f"{spmd['i_resume']}")
        io = launcher_io(a_dir, LAUNCH_DIR, arrays_a)
        del arrays_a
        print(f"  (e) restore of {io['gb']:.2f} GB: onto the CPU "
              f"{io['restore_cpu_s']:.2f} s, onto the card "
              f"{io['restore_card_s']:.2f} s, equal bit for bit; synchronous "
              f"save {io['save_s']:.2f} s ({io['save_gb_per_s']:.2f} GB/s); "
              f"save_async blocks {io['async_block_s']:.2f} s, writes "
              f"{io['async_write_s']:.2f} s in the background")
        card = io.pop("card")
        prof = launcher_profile(card, float(np.median(warm)))
        comp = launcher_compression(card)
        params = card.params
        del card
        pipe = launcher_pipeline(params)
        del params
    finally:
        shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"  three launcher runs' wall times: (a) {a['wall_s']:.2f} s, (b) "
          f"{wall_b:.2f} s, (c) {wall_c:.2f} s")
    return dict(step_ms=[r["ms"] for r in steps], k6_per_step=n_k6,
                tokens_per_step=LAUNCH_TOKENS, peak_gib=a["peak_gib"],
                wall_s=dict(a=a["wall_s"], b=wall_b, c=wall_c),
                preempted_at=stopped, resume=verdict, spmd=spmd, io=io,
                profile=prof, compression=comp, pipeline=pipe)

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {REPO / 'src' / 'repro_torch'} is missing; run from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    if sys.argv[1:2] == ["--launcher-rank"]:   # one rank of (h)
        return launcher_rank(sys.argv[2:])
    from repro_torch.data.synthetic import secstr_like

    t_start = time.perf_counter()
    phase_build()
    phase_kernel_small()
    div_small_err = phase_div_small()
    phase_k5_small()
    gate = phase_gate()
    div_gate = phase_div_gate()
    data = secstr_like(N_SECSTR, D_SECSTR, seed=3)

    reset_counts()
    out = phase_main(data)
    main_counts = read_counts()
    check(main_counts["K1"] == 2 * EXACT_ITERS,
          f"main path launched K1 {main_counts['K1']} times, expected "
          f"{2 * EXACT_ITERS}")
    check_tc_route(main_counts, ("K1",))
    after = phase_after(data, out)

    knn, graph = phase_knn(data, float(out["vdt"].sigma))
    reset_counts()
    phase_grf(out, knn, graph)
    grf_counts = read_counts()
    check(grf_counts["K5"] > 0 and grf_counts["K5"] % GRF_ITERS == 0,
          f"grf path launched K5 {grf_counts['K5']} times")
    print(f"  grf path launches {grf_counts}")
    k5 = phase_k5_timing(graph, out)
    del knn, graph

    reset_counts()
    vdt_grf = phase_vdt_grf()
    vdt_counts = read_counts()
    print(f"  vdt grf path launches {vdt_counts}")
    check(vdt_counts["K1"] > 0 and vdt_counts["K5"] > 0,
          "vdt grf path: K1 or K5 not launched")
    check_tc_route(vdt_counts, ("K1",))

    reset_counts()
    engine = phase_lp_engine(out, after, vdt_grf)
    engine_counts = read_counts()
    print(f"  (f) lp engine launches: K1 {engine_counts['K1']} (on "
          f"{TC_ROUTE}: {engine_counts[f'K1 {TC_ROUTE}']}), K5 "
          f"{engine_counts['K5']}; all counts {engine_counts}")
    check(engine_counts["K1"] > 0 and engine_counts["K5"] > 0,
          "lp engine: K1 or K5 not launched")
    check_tc_route(engine_counts, ("K1",))
    print(f"[lp engine] summary {json.dumps(engine)}")
    del vdt_grf

    reset_counts()
    stream = phase_streaming(out)
    stream_counts = read_counts()
    print(f"  streaming path launches {stream_counts}")
    check(stream_counts["K1"] > 0, "streaming: K1 not launched")
    check_tc_route(stream_counts, ("K1",))
    epoch = stream.pop("epoch")
    print(f"[streaming] summary {json.dumps(stream)}")

    sharded = phase_sharded(out, epoch)
    sharded_counts = sharded.pop("counts")
    print(f"  sharded path launches (the sharded engine's serves only) "
          f"{sharded_counts}")
    check(sharded_counts["K1"] > 0, "sharded engine: K1 not launched")
    check_tc_route(sharded_counts, ("K1",))
    sharded["stripe_rows"] = phase_sharded_stripes(out["vdt"])
    print(f"[sharded engine] summary {json.dumps(sharded)}")
    del epoch
    ops = phase_ops(out)
    phase_single_point()
    del out

    reset_counts()
    divs = phase_divergences(data)
    div_counts = read_counts()
    print(f"  divergence path launches {div_counts}")
    for label, r in divs.items():
        check(div_counts[f"K1 tile {r['tile']}"] >= r["launches"] > 0,
              f"{label}: K1 launched {r['launches']} times on its tile")
    check(div_counts["K1"] == sum(r["launches"] for r in divs.values()),
          f"divergence path: {div_counts['K1']} K1 launches")
    check_tc_route(div_counts, ("K1",))
    div_after = phase_div_after(divs)
    div_ops = phase_div_ops(data)
    del divs, data

    k6_small_err = phase_k6_small()
    # the dry run's grid needs no card: it runs beside the LM phases
    grid = dryrun_grid_start()
    lm = phase_lm_serve()
    lm_counts = lm["counts"]
    lm_f32_err, f32_counts = phase_lm_f32(lm.pop("params"))
    k6 = phase_k6_timing()
    k6_gate = phase_k6_gate()
    k6_stripes = phase_k6_stripes()
    moe = phase_lm_moe()
    moe_counts = moe.pop("counts")
    print(f"[lm serve moe] summary {json.dumps(moe)}")
    k6_moe = phase_k6_timing([(K6_MOE_SHAPE, torch.bfloat16)])[0]
    families = {}
    for arch in LM_FAMILY_ARCHS:
        families[arch] = phase_lm_family(arch)
        print(f"[lm serve {arch}] summary " + json.dumps(
            {k: v for k, v in families[arch].items()
             if not k.endswith("counts")}))
    k6_families = {r["name"]: r for r in phase_k6_timing(
        [(shape, torch.bfloat16) for shape in K6_FAMILY_SHAPES])}
    audio = phase_lm_audio()
    print("[lm serve audio] summary " + json.dumps(
        {k: v for k, v in audio.items() if not k.endswith("counts")}))
    k6_audio = {r["route"]: r for r in phase_k6_timing(
        [(K6_AUDIO_SHAPE, torch.bfloat16), (K6_AUDIO_SHAPE, torch.float32)])}
    k6_grad = phase_k6_grad()
    train = phase_train()
    print(f"[train] summary {json.dumps(train)}")
    launcher = phase_train_launcher()
    print(f"[train launcher] summary {json.dumps(launcher)}")
    dry = phase_dryrun(grid)
    print(f"[dryrun] summary {json.dumps(dry)}")
    spmd = phase_spmd()
    print(f"[spmd] summary {json.dumps(spmd)}")
    train_k6 = {arch: dict(launches_per_step=[r["k6"] for r in t["rows"]],
                           ms_per_step=[r["ms"] for r in t["rows"]],
                           tokens_per_step=t["tokens"],
                           peak_gib=t["peak_gib"],
                           k6_backward_ms_per_step=t[
                               "k6_backward_ms_per_step"],
                           k6_backward_share=t["k6_backward_share"])
                for arch, t in train.items() if arch != "checks"}

    single, batch8 = after["rows"]
    tc = dict(tensor_core_route=TC_ROUTE,
              headers=["src/repro_torch/kernels/csrc/tf32x3.cuh",
                       "src/repro_torch/kernels/csrc/sm90.cuh"])
    kernels = [dict(
        name="K1 folded fused LP step", route="cuda",
        source="src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
        replaces="src/repro/kernels/fused_lp/batched.py:231",
        launches=main_counts["K1"], max_abs_err=after["max_abs_err"],
        ms=single["ms"], plain_ms=single["plain_ms"],
        bound_ms=single["bound_ms"], bound_by=single["by"], library_ms=None,
        shape=f"N={N_SECSTR} d={D_SECSTR} K={single['k']}",
        ms2=single["ms2"],
        launches_tf32x3=main_counts[f"K1 {TC_ROUTE}"],
        batch8=dict(k=batch8["k"], ms=batch8["ms"], ms2=batch8["ms2"],
                    plain_ms=batch8["plain_ms"], bound_ms=batch8["bound_ms"]),
        lp_engine=dict(launches=engine_counts["K1"],
                       launches_tf32x3=engine_counts[f"K1 {TC_ROUTE}"],
                       k64=engine["wide_exact"]),
        gate={k: v for k, v in gate.items() if k.startswith("K1")},
        streaming_launches=stream_counts["K1"],
        sharded=dict(launches=sharded_counts["K1"],
                     launches_tf32x3=sharded_counts[f"K1 {TC_ROUTE}"],
                     launches_per_iter=sharded["launches_per_iter"],
                     ms_per_iter=sharded["ms_per_iter"],
                     split_pass_ms=sharded["split_pass_ms"],
                     stripe_rows=sharded["stripe_rows"]),
        by_tile_n16384={k: v for k, v in div_gate["timing"].items()
                        if k.startswith("sqeuclidean")}, **tc)]
    # K1's divergence routes: the same kernel on the kl and
    # itakura_saito tiles, and on the squared-Euclidean tile after the
    # Mahalanobis pre-map; launches from the [divergences] path
    for label, r in div_after.items():
        kernels.append(dict(
            name=f"K1 folded fused LP step, {label} route", route="cuda",
            source="src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
            replaces="src/repro/kernels/fused_lp/batched.py:231",
            launches=r["launches"], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["by"],
            library_ms=None, shape=r["shape"], ms2=r["ms2"],
            divergence=r["divergence"], kernel_tile=r["tile"],
            sqeuclidean_tile_ms_in_turns=r["sq_ms"],
            sqeuclidean_two_operands_ms_in_turns=r["sq_two_operands_ms"],
            launches_tf32x3=r["launches"],  # the window was all on tf32x3
            fit_s=r["fit_s"], exact_ms_per_iter=r["exact_ms_per_iter"],
            small_shapes_max_abs_err=div_small_err[label],
            gate={k: v for k, v in div_gate["gate"].items()
                  if k.startswith(label)},
            by_tile_n16384={k: v for k, v in div_gate["timing"].items()
                            if k.startswith(label)}, **tc))
    for k, name, source, replaces in (
            ("K2", "K2 fused LP matvec",
             "src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
             "src/repro/kernels/fused_lp/fused_lp.py:168"),
            ("K3", "K3 per-batch-recompute LP step",
             "src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
             "src/repro/kernels/fused_lp/batched.py:138"),
            ("K4", "K4 pairwise squared distances",
             "src/repro_torch/kernels/pairwise/csrc/pairwise.cu",
             "src/repro/kernels/pairwise/pairwise.py:50")):
        r = ops["rows"][k]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=ops["counts"][k], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r.get("lib_ms"),
            shape=r["shape"],
            launches_tf32x3=ops["counts"][f"{k} {TC_ROUTE}"], **tc,
            **({} if k == "K4" else dict(divergence_routes={
                label: r[k] for label, r in div_ops.items()})),
            **(dict(ms2=r["ms2"], library_ms2=r["lib_ms2"], gate=gate["K4"])
               if k == "K4" else {})))
    r400 = next(r for r in k5["rows"] if r["m"] == 400 and r["k"] == 2)
    kernels.append(dict(
        name="K5 GRF walker-mean feature product", route="cuda",
        source="src/repro_torch/kernels/grf/csrc/grf_feature.cu",
        replaces="src/repro/kernels/grf/grf.py:72",
        launches=grf_counts["K5"], max_abs_err=k5["max_abs_err"],
        ms=r400["ms"], plain_ms=r400["plain_ms"], bound_ms=r400["bound_ms"],
        bound_by=r400["by"], library_ms=r400["lib_ms"],
        shape=f"S={N_SECSTR} m=400 K=2",
        call_ms=r400["call_ms"], ms2=r400["ms2"],
        lp_engine_launches=engine_counts["K5"],
        l2_gb_per_s=r400["l2_gb_per_s"],
        l2_yardstick=k5["l2_yardstick"],
        by_shape={f"m={r['m']} K={r['k']}": dict(
            ms=r["ms"], ms2=r["ms2"], call_ms=r["call_ms"],
            plain_ms=r["plain_ms"], library_ms=r["lib_ms"],
            library_ms2=r["lib_ms2"], bound_ms=r["bound_ms"],
            l2_gb=r["l2_gb"], l2_gb_per_s=r["l2_gb_per_s"])
            for r in k5["rows"]}))
    # K6: one entry per route, each timed at smollm-360m's shape in its type;
    # launches are the bf16 prefill's and the f32 twin's
    k6_dir = "src/repro_torch/kernels/flash_attention/csrc/"
    k6_sources = {"sm90_bf16": k6_dir + "flash_attention_sm90.cu",
                  K6_F32_ROUTE: k6_dir + "flash_attention_tf32x3.cu"}
    prefill_share = lm["profile"].get("prefill", {})
    for route, name, launches in (
            ("sm90_bf16", "K6 flash attention, bfloat16 (tensor cores)",
             lm_counts["K6 sm90_bf16"]),
            (K6_F32_ROUTE, "K6 flash attention, float32 (3xTF32 tensor "
             "cores)", f32_counts[f"K6 {K6_F32_ROUTE}"])):
        rows = [r for r in k6 if r["route"] == route]
        tname = next(t for t, r in K6_ROUTES.items() if r == route)
        kernels.append(dict(
            name=name, route="cuda", source=k6_sources[route],
            replaces="src/repro/kernels/flash_attention/flash_attention.py:98",
            launches=launches, max_abs_err=rows[0]["err"], ms=rows[0]["ms"],
            plain_ms=rows[0]["plain_ms"], bound_ms=rows[0]["bound_ms"],
            bound_by=rows[0]["by"], library_ms=rows[0]["lib_ms"],
            shape=rows[0]["shape"], k6_route=route, k6_sources=k6_sources,
            small_shapes_max_abs_err=k6_small_err[route][0],
            small_shapes_max_block_rms=k6_small_err[route][1],
            stripes=k6_stripes[tname],
            by_shape={r["name"]: dict(ms=r["ms"], ms2=r["ms2"],
                                      plain_ms=r["plain_ms"],
                                      library_ms=r["lib_ms"],
                                      library_ms2=r["lib_ms2"],
                                      bound_ms=r["bound_ms"],
                                      f32_bound_ms=r["f32_bound_ms"],
                                      max_abs_err=r["err"],
                                      max_block_rms=r["block_rms"],
                                      shape=r["shape"]) for r in rows},
            **(dict(prefill_ms=lm["prefill_ms"],
                    decode_ms_per_step=lm["decode_ms"],
                    prefill_device_ms=prefill_share.get("total"),
                    prefill_k6_device_ms=prefill_share.get("K6"),
                    deepseek_moe=dict(
                        launches=moe_counts["K6 sm90_bf16"],
                        shape=k6_moe["shape"], ms=k6_moe["ms"],
                        ms2=k6_moe["ms2"], plain_ms=k6_moe["plain_ms"],
                        bound_ms=k6_moe["bound_ms"], bound_by=k6_moe["by"],
                        library_ms=k6_moe["lib_ms"],
                        library_ms2=k6_moe["lib_ms2"],
                        max_abs_err=k6_moe["err"],
                        max_block_rms=k6_moe["block_rms"],
                        prefill_ms=moe["prefill_ms"],
                        decode_ms_per_step=moe["decode_ms"]),
                    lm_families={arch: dict(
                        launches=f["counts"]["K6 sm90_bf16"],
                        f32_launches=(f["f32_counts"] or {}).get(
                            f"K6 {K6_F32_ROUTE}", 0),
                        prefill_ms=f["prefill_ms"],
                        decode_ms_per_step=f["decode_ms"],
                        peak_gib=f["peak_gib"], checks=f["checks"],
                        **({} if arch not in k6_families else dict(
                            timing=k6_timing_json(k6_families[arch]))))
                        for arch, f in families.items()},
                    whisper_medium=dict(
                        launches=audio["counts"]["K6 sm90_bf16"],
                        prefill_ms=audio["prefill_ms"],
                        decode_ms_per_step=audio["decode_ms"],
                        peak_gib=audio["peak_gib"],
                        encoder_timing=k6_timing_json(k6_audio[route])),
                    train=train_k6,
                    train_launcher=dict(
                        launches_per_step=launcher["k6_per_step"],
                        ms_per_step=launcher["step_ms"],
                        tokens_per_step=launcher["tokens_per_step"],
                        peak_gib=launcher["peak_gib"],
                        pipeline_launches=launcher["pipeline"]["k6_bf16"],
                        spmd_launches_per_step=launcher["spmd"]["k6"],
                        spmd_ms_per_step=launcher["spmd"]["ms"]),
                    spmd=dict(prefill_launches=spmd["prefill_k6"],
                              prefill_max_abs_err=spmd["prefill_err"],
                              prefill_bitwise=spmd["prefill_bitwise"],
                              families={arch: dict(
                                  prefill_launches=f["prefill_k6"],
                                  prefill_max_abs_err=f["prefill_err"],
                                  prefill_bitwise=f["prefill_bitwise"],
                                  decode_max_abs_err=f["decode_err"],
                                  decode_bitwise=f["decode_bitwise"])
                                  for arch, f in spmd["families"].items()}),
                    dryrun={cell: dict(
                        launches=r["k6"], step_ms=r["ms"], batch=r["batch"],
                        **({} if cell not in dry["k6"] else dict(
                            timing=k6_timing_json(dry["k6"][cell]))))
                        for cell, r in dry["cells"].items()
                        if "batch" in r})
               if route == "sm90_bf16" else
               dict(lm_f32_logits_max_abs_err=lm_f32_err, gate=k6_gate,
                    gate_row_base=k6_stripes["gate_row_base"],
                    tensor_core_route=K6_F32_ROUTE,
                    headers=tc["headers"],
                    whisper_medium=dict(
                        launches=audio["f32_counts"][f"K6 {K6_F32_ROUTE}"],
                        checks=audio["checks"],
                        encoder_timing=k6_timing_json(k6_audio[route])),
                    train_f32_launches=train["checks"]["k6_launches"],
                    spmd=dict(train_launches=spmd["train_k6"],
                              train_max_abs_err=spmd["train_max_abs_err"],
                              families={arch: dict(
                                  train_layers=f["train_layers"],
                                  train_launches=f["train_k6"],
                                  train_max_abs_err=f["train_max_abs_err"])
                                  for arch, f in spmd["families"].items()
                                  if "train_k6" in f}))),
            grad={k: v for k, v in k6_grad.items() if k.endswith(tname)}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for proc in STARTED:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
