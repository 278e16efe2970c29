#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device  — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them.
2. build   — compiles every CUDA kernel of the port from ``src/repro_torch/csrc``
   with nvcc (one process per source, in parallel) into ``build/kernels/``.
3. kernels — holds each kernel against its plain PyTorch version on the
   card and times the kernel, the plain version and one PyTorch library
   call computing the same function where one exists (median over 30
   calls, CUDA events; 5 for the plain scan over 2048 steps); K1 also at
   the over-selected cohorts (13 and 16 rows, and xlstm's (13, P)), at the
   async runtime's kept deltas (5 rows, classification and xlstm), at the
   int8 grid round's model blocks of stablelm-3b ((2, 8,048,640), (2,
   1,105,920) and (2, 409,600), the rows of both pods), and
   with a NaN row at weight > 0 and at weight 0 (the plain version's
   result: NaN in every column); K2 also at the population phase's shapes
   ((1, 3906), (61, 3906) and (4096, 10^4), C = 10); K3 in bf16 at the
   serving prefill's shapes (4, S, 32, 80) stablelm, (4, S, 25 / 5 kv, 64)
   hymba with its 1024 window, (4, S, 40 / 8 kv, 128) qwen3 and (4, S, 128,
   192) deepseek-v3's MLA (q and k of 128 + 64 dims, the DMAX-256
   template) and (4, S, 48 / 8 kv, 128) dbrx-132b, S = 128 and 1280, with
   a D = 192 backward at (2, 256, 16, 192), gemma3-27b's (4, 1280, 32 /
   16 kv, 128) local (window 1024) and global,
   at the frame and patch prompts' (4, 128 / 1280, 32, 64) musicgen-large
   and (4, 384 / 1280, 14 / 2 kv, 64) internvl2-1b (a GQA group of 7),
   and at the training launcher's (8, 128, 32, 80) stablelm, (8, 128, 25 /
   5 kv, 64) hymba and (8, 128, 48 / 8 kv, 128) dbrx-132b (the first D =
   128 backward on a path), with ``scaled_dot_product_attention(enable_gqa=True)``
   as the library; K3 also at the scaleout grid's ranks: (4, 128, 25 / 5
   kv, 64) hymba replicated (bf16, fp32), (4, 128, 16, 64) musicgen-large
   and (4, 384, 7 / 1 kv, 64) internvl2-1b (fp32); K4 with its final-state
   output at hymba's prefill, (4, 128 / 1280, 1600, 16) fp32, and with its
   checkpoints at the launcher's (8, 128, 1600, 16) and at a grid rank's
   channel block (4, 128, 800, 16); at the serve grid's ranks, K3 at (2 /
   3, 128, 16, 80) stablelm and (2 / 3, 128, 25 / 5 kv, 64) hymba (window
   1024) in fp32 and bf16, and K4 with its final state at (2 / 3, 128, 800,
   16); at the long request's prefill on a grid rank, K3 in bf16 at (1,
   2048, 16, 80) stablelm (window 4096) and (1, 2048, 25 / 5 kv, 64) hymba
   (window 1024), and K4 with its final state at (1, 2048, 800, 16).
4. main paths, each driven through ``make_engine(...).rounds()`` with
   every kernel's launch count set to 0 just before and read just after:
   - the paper's experiment at full width (K = 100 clients, m = 10, MLP
     784-200-200-10, shards partition at target HD 0.9, FedLECC with
     J = 3, batch 64, lr 0.005) for 5 rounds;
   - the paper's comparison on the same data and settings: every
     classification preset for 150 rounds (one line each: setup, median
     round, final accuracy, rounds to 50 %, MB, K1 and K2 launches), the
     other strategies and the robust aggregators for 3 rounds, and the
     quickstart configuration against the reference's accuracy band; K1
     must launch once a round wherever the rule reduces the cohort and
     never where it sorts, K2 once at setup exactly where a strategy
     builds the Hellinger matrix.  It runs before the LM paths, whose last
     rounds run under the profiler, which slows later host work;
   - the paper's configuration (FedLECC, J = 3, 150 rounds) on each backend:
     (a) ``backend="host"``, (b) ``backend="compiled"`` (eager: the round's
     mask, cohort and K1 reduce on the card, read once a round), (c) (b) in
     fused chunks of 5 rounds (``fuse_rounds=5``: each chunk length captured
     once as a CUDA graph, then replayed) and (d) (c) with int8 uploads
     (``compress_bits=8``); one ``backends:`` line each with setup, median
     round (fused: replayed chunks' ms / rounds, the first chunk of each
     length, eager then captured, apart), accuracy, rounds to 50 %, MB and
     K1/K2 launches (K1 150 in each run, replays counted as replays x the
     launches captured a graph; K2 1).  (b) and (c) must select the same
     clients every round and end within 1e-5, as must lossonly and haccs
     over 30 rounds; random, poc and clusterrandom's fused ``rounds(30)`` in
     three calls must equal one call; (d) must bill fewer MB than (c) and
     stay within 5e-3 of it after 3 rounds; (b) with ``cohort_gather=False``
     (every client trains, K1 reduces (100, P)) must equal (b) over 3
     rounds.  (a) and (b) must select the same clients every round and end
     within 1e-5 (the draws are keyed by client, not by cohort).  Then
     ``torch.profiler`` over one host round and one replayed chunk (busy
     ms, idle share, top device operations).  ``memory_allocated`` is
     printed before the phase, after it and after ``gc.collect()``, and
     must come back within 16 MiB of its level before;
   - ``systems:`` the paper's configuration (150 rounds, host backend)
     under the grid of ``benchmarks/bench_systems.py``: ``mobile_mix``
     devices with ``markov`` availability, no deadline against a deadline
     at the profile's 60th percentile round time with over-selection 1.0,
     1.3 and 1.6, for fedlecc, random, poc and haccs: one line a run
     (simulated seconds, mean drops a round, median round, MB, K1 and K2
     launches), then per strategy the simulated seconds, MB and rounds to
     95 % of the lowest best accuracy; fedlecc at the deadline with 1.3 on
     the compiled backend and in fused chunks of 5 must keep the host's
     survivors, drops and bits;
   - ``faults:`` the same configuration, fedlecc, under the grid of
     ``benchmarks/bench_robustness.py``: ``sign_flip`` at 0, 5 and 20 %
     with no defense, the validation gate, and the gate with the trimmed
     mean (final and best accuracy, recovery against the fault-free run,
     faulty updates, the most quarantined, median round); rate 0 must give
     ``faults=None``'s bits, the compiled backend the host's survivors at
     20 %, and fused chunks of 5 run the gate inside a captured graph;
   - ``async:`` the same configuration under ``benchmarks/bench_systems.py
     --async``'s cells (``mobile_mix`` + ``markov``; lock-step without a
     deadline and at the 60th-percentile deadline with over-selection 1.3;
     FedBuff-style async with buffer 5 over twice the rounds and with
     buffer 10, 20 clients in flight, discount (1 + s)^-0.5) for fedlecc,
     random and fedcs on the host backend (final and best accuracy,
     simulated s and MB to 95 % of the lowest best accuracy, params
     version, staleness, median step, K1 once a step that applies an
     update); fedlecc's buffer-5 run on the compiled backend keeps the
     host's survivors, versions and staleness every step; ``dispatch=
     "sync"`` gives the lock-step engine's bits; buffer 5 under
     ``sign_flip`` at 20 % behind the validation gate;
   - ``checkpoint:`` ``benchmarks/bench_checkpoint.py``'s rows (40 rounds,
     a save every round, the last 3 kept, a JSONL tracker) on host,
     compiled and fused chunks of 2: bare and checkpointed s a round, save
     and restore s, MB; a kill at round 20 resumes to the uninterrupted
     run's bits, as does an engine that captured its graphs and restores an
     older file; then the buffer-5 async run killed mid-buffer on host and
     compiled resumes to the same bits;
   - ``population:`` ``benchmarks/bench_population.py``'s rows: its
     training rows (fedlecc J = 5, hidden (64,), m = 32, batch 16, 2 local
     epochs, lr 0.05, target HD 0.8, 30 rounds) at K = 10^3 (15 shards)
     and 10^4 (156 shards: K2's blocked build over every client is three
     4096-row strips), flat against population with 4 resident shards
     (accuracy, MB, median round, setup, resident clients, gather MB a
     round, the stack's MB, each run's peak device memory), the population
     run on the compiled backend at 10^3 keeping the host's selections
     within 1e-5; one shard against flat on the paper's configuration
     (fedlecc, random and lossonly on host and compiled, 150 rounds: the
     same selections and parameter bits); the selection-only rows at K =
     10^3 to 10^6 (store and hierarchy build, K2 launches, the round's
     selection ms; 3,906 shards clustered by k-medoids at 10^6; no shard
     materialized) and ``hellinger_blocked`` at K = 10^4, its pinned
     double-buffered copy against the pageable copy it replaced;
   - federated LM training on stablelm-3b at full width, cut from 32 to
     2 layers (P = 380,789,760), K = 100, m = 10, batch 8 of 64 tokens,
     3 rounds, with the flash-attention kernel forward (poll, local SGD,
     evaluation) and backward (local SGD);
   - federated LM training on hymba-1.5b at full width, cut from 32 to 6
     layers (P = 344,430,400), the same data recipe and settings, with the
     flash-attention kernel at hymba's shape and the selective-scan kernel,
     each forward (poll, local SGD, evaluation) and backward (local SGD);
   - federated LM training on xlstm-125m, the LM task's default model, at
     full width and depth (12 layers, P = 119,827,296), the same data
     recipe and settings: nine mLSTM and three sLSTM layers in plain
     PyTorch, K2 at setup and K1 once a round on (10, P); then the same
     under both axes (``mobile_mix`` at its 60th percentile deadline,
     over-selection 1.3 so K1 reduces (13, P); ``sign_flip`` and
     ``nan_update`` at 20 % behind the gate), with the gate's norm pass
     and clip timed alone at (13, P) under the profiler; one save and one
     restore of its lock-step engine are timed; then 4 steps of the
     buffer-5 async runtime (20 in flight, K1 on (5, P)), printing each
     step's staleness, version, in-flight rows and peak memory;
   - ``serve:`` the serving path in bf16 at full size: stablelm-3b,
     hymba-1.5b, xlstm-125m and qwen3-14b, and glm4-9b, gemma3-27b,
     dbrx-132b and deepseek-v3-671b at full width cut to 4, 6, 2 and 1
     layers (gemma3's sixth layer is its first global one; dbrx's MoE walks
     its 16 experts, deepseek's MLA prefill runs K3 at D = 192 and its MoE
     walks 256 experts and a shared one), each serving 8 requests (4 prompts of 128 tokens, 4 of
     1280) through ``BatchScheduler`` (max_batch 4, max_new 32): prefill
     ms a group, decode ms a step and tok/s beside the weight-read bound,
     peak memory, after one uncounted warm-up group; K3 must launch
     attention layers x groups times and K4 hymba layers x groups (forward
     only); decode(prefill(x[:-1]), x[-1]) must equal forward(x) at the
     last position within 2e-2 x (max |logit| + 1) on the same weights in
     fp32, and its bf16 drift is printed beside it; then musicgen-large
     (frame inputs) and internvl2-1b (256 image patches before the tokens)
     at full size in bf16 through ``repro_torch.launch.serve``'s entry
     point, 4 prompts of 128 and of 1280 frames, of 384 and of 1280
     positions, 32 new tokens each: prefill ms, decode ms a step beside
     the weight-read bound, peak memory, K3 once a layer a prefill, and
     the same prefill -> decode contract on a frame or patch prompt; then
     each family's reduced config (fp32, the two modal ones too) on the
     CPU and on the card from the same weights: the same greedy tokens,
     the prefill's logits and cache within 1e-4;
   - ``moe mesh:`` the MoE's capacity dispatch under a mesh of one
     (``make_host_mesh()``: a world of one, so its sums are the identity;
     the collectives run in ``tests/test_torch_mesh.py``'s world of four
     CPU processes under gloo): dbrx-132b (2 layers) and deepseek-v3-671b
     (1 layer) at full width in bf16, ``prefill`` of 4 prompts of 128 and
     of 1280 tokens and 31 ``decode_step`` calls each with ``mesh=``:
     prefill ms, decode ms a step against the weight-read bound, peak,
     beside the ``serve:`` phase's dense numbers, and the share of (token,
     slot) assignments dropped (at decode cap = 1 of 4 tokens, as in the
     reference); K3 once a layer a prefill; with capacity factor E / top_k
     (cap >= tokens) the capacity prefill's logits equal the dense
     prefill's within 2e-2 x (max |logit| + 1), and fp32
     decode(prefill(x[:-1]), x[-1]) equals forward(x) under the mesh
     within it; the reduced configs under the mesh on the CPU and on the
     card (the same greedy tokens, logits within 1e-4; 3 launcher steps
     within the agreement's tolerances); and the launcher's step under the
     mesh on dbrx-132b at full width, 1 layer, the vocabulary cut from
     100352 to 8192 (the full one would take the step's memory past 80 GB),
     batch 8 of 128, 3 AdamW steps (ms, losses, peak; K3 once a step each
     way);
   - ``train:`` the training launcher (``repro_torch.launch.train``'s
     ``make_train_step`` and optimizer: chunked CE, clip to norm 1, AdamW
     with fp32 moments) on stablelm-3b (32 layers), hymba-1.5b (32) and
     xlstm-125m (12) at full size in bf16, batch 8 of 128 tokens, 6 steps:
     the parameters, each step's ms beside the least a step could take
     (6 P tokens at the bf16 rate plus AdamW's bytes), tokens/s, peak
     memory and the losses (finite, not constant); K3 must launch 32
     times forward and 32 backward a step on stablelm and hymba, K4 as
     often on hymba; then xlstm's ``--ckpt`` after 3 steps and ``--resume``
     to 6 against 6 uninterrupted steps, within 1e-2 relative;
   - ``scaleout:`` the scaleout backend in a world of one process (every
     pod on this card, so the all-reduce and all-gather are the identity;
     the collectives run in ``scaleout grid:``): the
     paper's configuration (fedlecc
     J = 3) for 30 rounds on ``backend="scaleout"`` (K1 once a round over
     the (100, P) stack), host and compiled with ``cohort_gather=False``,
     the same selections every round and parameters within 1e-5; then
     ``make_federated_round`` on stablelm-3b at full size in bf16, one
     pod, 4 local SGD steps of 8 x 128 tokens, with compress_bits 0 and 8
     (ms a round, loss, peak memory; K1 once a leaf, K3 once a layer a
     step each way; int8 within half a quantization step of exact);
   - ``scaleout grid:`` first a probe of two processes on the card: NCCL
     (two ranks of one communicator on one device, which NCCL refuses;
     the finding is printed) and gloo with CUDA tensors (``all_reduce``
     sum and max, ``all_gather``, in fp32, bf16 and int8, checked).  Then
     the scale-out round on the (pod 2, data 2, model 2) grid in eight
     processes of this script on the one card, started with a file store
     under ``build/grid/``, with real collectives under gloo: stablelm-3b
     and hymba-1.5b at full width cut to 4 layers, each rank holding its
     blocks of every leaf under the baseline policy and training on its
     4-sequence share of its pod's 8 x 128 batch, tensor-parallel over
     ``model`` (K3 on stablelm's 16 heads and on hymba's 25 replicated,
     K4 on hymba's 800-channel block at (4, 128, 800, 16), forward and
     backward, K1 on its blocks), 4 local steps, in bf16 at compress_bits
     0 and 8 and in fp32 at 0; then internvl2-1b (8 x 384 a pod: 256
     patches and 128 tokens) and musicgen-large (8 x 128 frames), 4
     layers, in fp32 at 0.  Each rank prints its held bytes, its peak, its
     K1 / K3 / K4 launches (held to once a leaf, and 16 + 16 a round, the
     shapes held by the work formulas' product flops a launch) and its
     collectives; its blocks are held against the same round in a world of
     one process on the card (the whole layout, both pods in one
     process), cut to its block: fp32 within 1e-4 of max(1, |ref|), bf16's
     largest difference printed; xlstm-125m (4 layers, its 4 heads over
     model 2, no kernel but K1) likewise in fp32 at 0, one local step (its
     training at full width is chaotic from the second step on).  Then the serve grid
     in the same world: stablelm-3b, hymba-1.5b and xlstm-125m at full width
     cut to 4 layers, in fp32 and bf16, each rank's blocks served through
     ``BatchScheduler(mesh=)``: 8 requests of 128 tokens in one group (2
     rows a rank over the 4 data ranks) and 3 in another (every rank all
     3), 16 new tokens each (K3 on the rank's heads and K4 with its final
     state on its channels once a layer a group's prefill; decode on its
     blocks and cache block); every rank's tokens and each step's logits
     held against the same requests served whole in the world of one: fp32
     tokens equal and logits within 1e-4 of max(1, |ref|), bf16 logits
     within 3e-2 while a row's tokens agree (xlstm-125m's within 1e-1:
     ``SERVE_GRID_BF16_TOL``); the 3-row group's cache of 144 positions
     is split over the 4 data ranks, 36 a rank, the prompt across all
     four blocks, and its decode combines their partial softmaxes.  Then
     the long request in the same world: stablelm-3b as the reference's
     ``long_500k`` takes it (a window of 4096 on every layer) and
     hymba-1.5b, 4 layers at full width in bf16, one prompt of 2048
     tokens in a cache of 524,288 positions and 8 new tokens through
     ``prefill`` and ``decode_step(mesh=)``: each rank holds its quarter
     of the sequence (stablelm's k / v block 1/8 of its 21.47 GB cache,
     hymba's 1/4 of 2.68 GB, printed a rank), its bf16 logits within
     3e-2 of a world of one's, run alone after the world, and its tokens
     equal but where they part at a near tie of the world of one's two
     best logits; K3 and K4 forward once a layer in its prefill.  A rank
     that fails makes the phase raise;
   - ``dryrun:`` the dry run (``repro_torch.launch.dryrun``) against the
     card, at full width and depth in bf16: stablelm-3b train at 8 x 128
     (K3 both ways), and the prefill at 4 x 1280 of hymba-1.5b (K3, K4),
     qwen3-14b and gemma3-27b (62 layers).  For each, ``build_step`` is
     traced on ``meta`` tensors on a dry mesh of one (predicted product
     flops, and peak memory above the arguments), then its function runs
     on the card on ``init_params``' weights under ``dryrun.count_flops``:
     the tallied flops must equal the prediction exactly, the peak above
     the arguments (``max_memory_allocated`` over the call, less what was
     allocated when it began) must be within 10 % of it, the output
     finite, and each kernel's launches those the dry run tallied.  Then
     the grid round, each model and run of ``scaleout grid:``: rank 0 of
     the dry (2, 2, 2) mesh traced on ``meta`` at that phase's size (the
     rank's blocks and batch share, collectives tallied by kind) against
     rank 0 of the eight-process world on the card: the
     tallied flops equal, K1's, K3's and K4's launches the tally, the
     collective bytes by kind equal, the peak above the arguments within
     10 %; the serve grid's rank 0, a prefill of the 8-row group and a
     decode step each measured on the card against its trace on the dry
     (2, 2, 2) mesh: held bytes equal to the trace's and to its
     ``argument_size``, flops, collective bytes and launches equal, the
     peak within 10 % (the long request's prefill and first decode step
     too); and rank 0 of the 2 x 16 x 16
     mesh at full depth predicted at 16 sequences a pod, its
     ``argument_size`` equal to what it holds.  Then the
     ``--all --mesh single`` sweep (40 records) and the ``--federated``
     records on the 2 x 16 x 16 mesh (q0 and q8 of every arch but
     deepseek-v3-671b, one of whose dense-MoE traces outlasts this
     script's time limit: 18, in two children), each started in a child
     process that cannot see the card (nice 10) after phase 3, must have
     written their records, none failed, every record that
     ``dryrun.step_storage`` calls "sharded" (``train``, federated,
     ``prefill_32k``, ``decode_32k`` and ``long_500k`` of a family that
     ``shards_storage`` names) saying so and holding exactly its
     ``argument_size``; their wall times are printed;
   - ``analysis:`` the port's tracecheck (``repro_torch.analysis``): the
     lint over ``src/repro_torch`` must be clean and every contract of
     ``run_contracts`` on the card must pass, none skipped (masks, a
     replay in its graph's own buffers, one load a kernel library, one
     capture a chunk length, the host reads a round and a chunk); then the
     sync and capture budgets (``drive_twice``) at the paper's
     configuration over two ``rounds()`` calls of 15 rounds on compiled and
     in fused chunks of 5 (K1 in the graphs, K2 at setup); then fused LM
     chunks at full width: hymba-1.5b (6 layers) and stablelm-3b (2),
     each as the LM paths above on the compiled backend and then in fused
     chunks of 3 (every chunk one round at ``eval_every=1``: round 0
     eager, then captured with K1, K3 and K4 inside, rounds 1 and 2
     replays): the first chunk's eager and capture time, each replayed
     round, the graph pool against the peak, the launches recorded at
     capture times the replays against the LM paths' formulas, no
     synchronizing call in a replay, the same selections as the eager
     compiled run and params within 1e-5 of it.
5. agreement — a small configuration of each task and model (stablelm,
   hymba, xlstm, and glm4, qwen3 and gemma3 reduced), of every
   classification preset and of fused compiled chunks, run on the CPU
   (plain versions, eager chunks) and on the card (kernels, captured
   chunks) from the same draws must select the same clients and reach the
   same parameters; xlstm's training is chaotic (a relative change of
   1e-6 of the weights moves the test loss by 1e-2 to 4e-2 within two
   rounds: scripts/xlstm_sensitivity.py), so its card run starts each
   round, of one local step, from the CPU run's parameters; so does the
   xlstm micro run under both axes, which must also drop and flag the
   same clients; and an async micro run (host, compiled, host under
   faults), which must dispatch, aggregate and version the same way; and 3
   launcher steps of the reduced stablelm, hymba, xlstm, dbrx and deepseek
   (with its MTP head) configs, losses within 1e-4 relative and parameters
   within 2e-4.
6. kernel-only — each kernel's own device time a call, without the
   wrapper's host work, at each of its phase-3 shapes: K1, K2, the
   flash-attention kernels (forward, dQ and dK/dV) and the selective
   scan, and beside K1 and K2 the device time of the kernels that their
   library call launches (``torch.profiler``, median of 30 calls); last,
   so that no profiler session precedes a host-timed phase.  Each reading
   prints the launches the profiler recorded: every matched kernel must
   have recorded exactly its launches a call (the wrapper's counter) times
   the calls, or a whole multiple of the calls for a library call, else
   the window is profiled again and then the run fails; and no reading
   may lie below its bound, except an L2-resident one below the HBM byte
   bound.  It runs in a fresh process of this script (``--kernel-only``,
   on the libraries phase 2 built): late in the long process the
   profiler once lost a fixed share of every window's launches.

Then the card's name and power limit again, one JSON line lists the
kernels (K1's launches summed over every path above; K3's backward also
at the dbrx-132b step's shape, with that step's launches; K4 also at a
grid rank's channel block, with the grid's launches; K3 and K4 forward
also at the serve grid's shapes and at the long request's, with their
launches), and the last line
is ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that line; so does a machine with no CUDA device, and a directory
that holds this script without the repository's ``src/``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BF16_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
# fp32-accurate products on the tensor cores as 3xTF32: three TF32 products
# (495 TFLOP/s dense) for each fp32 one
PEAK_3XTF32_PER_S = 495e12 / 3
# exp and the other special functions: 16 a clock per SM (NVIDIA's Hopper
# SM description) x 132 SMs x the 1.98 GHz boost clock of the SXM part
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
TIMED_CALLS = 30
# the card's name and power limit (nvidia-smi), set by main(), printed beside
# the MoE phase's numbers
SMI = ""
PROFILE_ATTEMPTS = 10
L2_BYTES = 50 * 2**20        # H100 SXM L2: inputs this small stay resident between calls


def _median_ms(fn, calls: int = TIMED_CALLS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_ms(fn, names, calls: int = TIMED_CALLS, counter=None) -> tuple[float, int]:
    """Device time a call of the kernels whose names match ``names``, and the
    launches of them that the profiler recorded: for each such kernel the
    median of its launches in ``calls`` calls under ``torch.profiler``
    (after one warm-up call) times its launches a call, summed over the
    kernels.  The kernels alone, without the wrapper's host work (checks,
    allocations, the ctypes call) that the event-timed ``ms`` includes.

    ``counter`` is the wrapper that ``fn`` calls (its ``launches`` count):
    the warm-up call gives its launches a call, and every matched kernel
    must have recorded exactly ``calls`` times that many.  Without one (a
    library call) every matched kernel must have recorded a whole multiple
    of ``calls``.  The profiler loses launches at the start of a tracing
    session, so each session traces a first window of ``calls`` calls that
    it discards (a warm-up step of its schedule) and records the second.
    A window that still recorded another count is profiled again after a
    pause, up to ``PROFILE_ATTEMPTS`` times (sessions that record nothing
    at all come two in a row), and then the run fails: a reading is never
    scaled by the share of the launches that was recorded."""
    import torch

    before = None if counter is None else counter.launches
    fn()
    torch.cuda.synchronize()
    per_call = None if counter is None else counter.launches - before
    if per_call == 0:
        raise AssertionError(f"{names.pattern}: the wrapper launched nothing in a call")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
            for _ in range(2):  # the warm-up window, then the recorded one
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        per_kernel: dict[str, list[float]] = {}
        seen = set()
        for e in prof.events():
            # the schedule's step marker is a device-side annotation, not a kernel
            if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep"):
                seen.add(e.name[:80])
                if names.search(e.name):
                    per_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
        counts = {k: len(v) for k, v in per_kernel.items()}
        if per_call is not None:
            whole = bool(counts) and all(n == calls * per_call for n in counts.values())
        else:
            whole = bool(counts) and all(n % calls == 0 for n in counts.values())
        if whole:
            recorded = sum(counts.values())
            PROFILE_TRIES.append((names.pattern, attempt))
            return sum(statistics.median(v) * (len(v) // calls)
                       for v in per_kernel.values()) / 1e3, recorded
        want = (f"{calls} x {per_call} a kernel" if per_call is not None
                else f"a whole multiple of {calls} a kernel")
        print(f"kernel-only: attempt {attempt} of {PROFILE_ATTEMPTS} for {names.pattern} "
              f"recorded {sorted(counts.values())} launches of {len(counts)} kernels ({want} "
              f"expected; {len(seen)} device event names); profiling the window again",
              flush=True)
        time.sleep(0.5)
    raise AssertionError(f"the profiler did not record every launch of {names.pattern} in "
                         f"{PROFILE_ATTEMPTS} attempts: {counts}; device events: {sorted(seen)}")


BELOW_BOUND: list[str] = []  # phase 6's readings below their bound; the run fails after it
PROFILE_TRIES: list[tuple[str, int]] = []  # (kernel names, profiling attempts) a reading


def _not_below_bound(tag: str, kernel_ms: float, bound_ms: float,
                     n_bytes: float | None = None) -> None:
    """A kernel-only reading below the card's bound is a measurement fault
    (recorded in ``BELOW_BOUND``), except where the inputs (``n_bytes``) fit
    in the L2, which serves them faster than the HBM rate the byte bound
    assumes."""
    if kernel_ms >= bound_ms:
        return
    if n_bytes is not None and n_bytes <= L2_BYTES:
        print(f"kernel-only {tag}: {kernel_ms} ms below the HBM byte bound {bound_ms} ms; its "
              f"{n_bytes / 2**20:.1f} MiB of inputs stay in the L2 between calls", flush=True)
        return
    print(f"kernel-only {tag}: {kernel_ms} ms is BELOW its bound {bound_ms} ms", flush=True)
    BELOW_BOUND.append(f"{tag}: {kernel_ms} < {bound_ms}")


def _bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# K1's and K2's kernels by name; every kernel that a library call launches
FEDAVG_KERNEL = re.compile(r"fedavg_reduce_kernel")
# K3's forward, dQ and dK/dV kernels (a word boundary keeps scan_fwd_kernel out)
FLASH_FORWARD = re.compile(r"\bfwd_kernel\b")
FLASH_DQ = re.compile(r"\bdq_kernel\b")
FLASH_DKDV = re.compile(r"\bdkdv_kernel\b")
STRIP_KERNEL = re.compile(r"hellinger_strip_kernel")
ANY_KERNEL = re.compile("")


def _strip_inputs(shape, device):
    """K2's sqrt-histogram panels (B, C) and (K, C), from a seed."""
    import torch

    b, k, c = shape
    g = torch.Generator().manual_seed(b + k + c)

    def panel(n):
        h = torch.rand(n, c, generator=g) * (torch.rand(n, c, generator=g) > 0.3)
        h = h / torch.clamp(h.sum(1, keepdim=True), min=1e-12)
        return torch.sqrt(h).to(device)

    return panel(b), panel(k)


def _strip_library(rb, r):
    import torch

    return torch.sqrt(torch.clamp(1 - rb @ r.T, 0, 1))


def _check_hellinger(shape, device):
    """K2 at (B, K, C): kernel vs plain version, and times."""
    import torch

    from repro_torch.kernels.hellinger import hellinger_strip, hellinger_strip_ref

    b, k, c = shape
    rb, r = _strip_inputs(shape, device)
    got = hellinger_strip(rb, r)
    want = hellinger_strip_ref(rb, r)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 0.0  # the same operations in the same order: the same bits
    if not (got.shape == (b, k) and torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"hellinger_strip {shape}: max |HD - plain| = {err} > {tol}")
    bound_ms, bound_by = _bound(4 * (b * c + k * c + b * k), 2 * b * k * c + 4 * b * k)
    rec = {
        "shape": [b, k, c], "max_abs_err": err, "tolerance": tol,
        "ms": _median_ms(lambda: hellinger_strip(rb, r)),
        "plain_ms": _median_ms(lambda: hellinger_strip_ref(rb, r)),
        "library_ms": _median_ms(lambda: _strip_library(rb, r)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"kernel hellinger_strip {json.dumps(rec)}", flush=True)
    return rec


def _aggregate_inputs(shape, dtype, device):
    """K1's (M, N) cohort in ``dtype`` and its (M,) fp32 weights, from a
    seed, drawn on the card: (10, P) is 15 GB."""
    import torch

    m, n = shape
    g = torch.Generator(device=device).manual_seed(m + n)
    x = torch.randn(m, n, generator=g, device=device).to(dtype)
    w = torch.rand(m, generator=g, device=device)
    return x, w / w.sum()


def _check_aggregate(shape, dtype, device):
    """K1 at (M, N) in ``dtype``: kernel vs plain version, and times."""
    import torch

    from repro_torch.kernels.aggregate import masked_weighted_sum, masked_weighted_sum_ref
    from repro_torch.kernels.aggregate.ops import reduce_work

    m, n = shape
    x, w = _aggregate_inputs(shape, dtype, device)
    got = masked_weighted_sum(x, w)
    want = masked_weighted_sum_ref(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 0.0  # the same operations in the same order: the same bits
    if not (got.shape == (n,) and torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"masked_weighted_sum {shape} {dtype}: max |err| = {err} > {tol}")
    w_lib = w.to(dtype)
    work = reduce_work(m, n, x.element_size())
    bound_ms, bound_by = _bound(work.bytes, work.flops)
    rec = {
        "shape": [m, n], "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "tolerance": tol,
        "ms": _median_ms(lambda: masked_weighted_sum(x, w)),
        "plain_ms": _median_ms(lambda: masked_weighted_sum_ref(x, w)),
        "library_ms": _median_ms(lambda: w_lib @ x),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"kernel masked_weighted_sum {json.dumps(rec)}", flush=True)
    return rec


def _check_aggregate_nan(device):
    """K1 with a NaN row (an undefended ``nan_update``) at weight > 0 and at
    weight 0, at the systems phase's (13, 199,210): the kernel gives its
    plain version's result (NaN in every column: 0 · NaN = NaN)."""
    import torch

    from repro_torch.kernels.aggregate import masked_weighted_sum, masked_weighted_sum_ref

    x, w = _aggregate_inputs((13, 199_210), torch.float32, device)
    x[4] = float("nan")
    for weight in (0.1, 0.0):
        w[4] = weight
        got, want = masked_weighted_sum(x, w), masked_weighted_sum_ref(x, w)
        torch.cuda.synchronize()
        same = torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(want))
        print(f"kernel masked_weighted_sum with a NaN row at weight {weight}: the plain "
              f"version's result {same}, NaN columns {int(torch.isnan(got).sum())} of "
              f"{got.numel()}", flush=True)
        if not same:
            raise AssertionError(f"K1 with a NaN row at weight {weight} differs from plain")


def _flash_inputs(shape, dtype, device):
    """K3's q, k, v and an output gradient at (B, S, H, KV, D), from a seed."""
    import torch

    b, s, h, kv, d = shape
    g = torch.Generator().manual_seed(b * s + h * d + kv)
    q, k, v = (torch.randn(b, s, n, d, generator=g).to(dtype).to(device) for n in (h, kv, kv))
    return q, k, v, torch.randn(b, s, h, d, generator=g).to(dtype).to(device)


def _check_flash(shape, dtype, window, is_global, device):
    """K3 at (B, S, H, KV, D): forward (O, L) and backward (dq, dk, dv)
    against the plain version and its autograd on the card, and times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref,
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.flash_attention.ops import attention_work

    b, s, h, kv, d = shape
    q, k, v, do = _flash_inputs(shape, dtype, device)
    o, lse = flash_attention_forward(q, k, v, window, is_global)
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, window, is_global)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o_ref, lse_ref = attention_ref(*leaves, window, is_global)
    grads_ref = torch.autograd.grad(o_ref, leaves, do, retain_graph=True)
    torch.cuda.synchronize()

    # fp32: sums over D and S in another order than the plain version's
    # matrix products; bf16: one rounding of the output to bf16 (8 bits of
    # mantissa) on either side.  Both relative to max(1, max |plain|).
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    errs, limits = {}, {}
    for name, got, want in [("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, grads_ref[0]),
                            ("dk", dk, grads_ref[1]), ("dv", dv, grads_ref[2])]:
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {shape} {dtype} {name}: bad output "
                                 f"{tuple(got.shape)} {got.dtype}")
        errs[name] = (got.float() - want.float()).abs().max().item()
        limits[name] = tol * max(1.0, want.float().abs().max().item())
    tag = f"{list(shape)} {str(dtype).replace('torch.', '')} window={window} is_global={is_global}"
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"flash_attention {tag}: max |err| {errs} above {limits}")
    rec = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "window": window,
           "is_global": is_global, "errors": errs, "tolerance": tol,
           "forward": {"max_abs_err": max(errs["o"], errs["lse"])},
           "backward": {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"])}}
    pairs, fwd_bytes, bwd_bytes = attention_work(shape, window, is_global, q.element_size())
    # K3 multiplies fp32 inputs on the tensor cores as 3xTF32, so the least
    # time the card takes for fp32-accurate attention is set by that rate,
    # not by the 67 TFLOP/s of the CUDA cores
    peak = PEAK_3XTF32_PER_S if dtype == torch.float32 else PEAK_BF16_PER_S
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window > 0 and not is_global > 0:
        pos = torch.arange(s, device=device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        lib_kw = {"attn_mask": mask}
    else:
        lib_kw = {"is_causal": True}
    if kv != h:
        lib_kw["enable_gqa"] = True
    lib_leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, **lib_kw)
    do_t = do.transpose(1, 2)
    fwd_bound = _bound(fwd_bytes, 4 * d * pairs, peak)
    bwd_bound = _bound(bwd_bytes, 10 * d * pairs, peak)
    rec["forward"] |= {
        "ms": _median_ms(lambda: flash_attention_forward(q, k, v, window, is_global)),
        "plain_ms": _median_ms(lambda: attention_ref(q, k, v, window, is_global)),
        "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
    }
    rec["backward"] |= {
        "ms": _median_ms(lambda: flash_attention_backward(q, k, v, o, lse, do, window,
                                                          is_global)),
        "plain_ms": _median_ms(lambda: torch.autograd.grad(o_ref, leaves, do,
                                                           retain_graph=True)),
        "library_ms": _median_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do_t,
                                                             retain_graph=True)),
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
    }
    print(f"kernel flash_attention {json.dumps(rec)}", flush=True)
    return rec


def _scan_bound(n_bytes, elements, flops_per_element, exps_per_element):
    """K4's bound: bytes over HBM, against the larger of its fp32 operations
    over the CUDA cores and its exps over the special-function units."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = max(elements * flops_per_element / PEAK_FP32_PER_S,
                elements * exps_per_element / PEAK_SFU_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# K4's kernels by name: the forward scan; the reverse scan and the second
# pass that sums its partials
SCAN_FORWARD = re.compile(r"\bscan_fwd_kernel\b")
SCAN_BACKWARD = re.compile(r"\b(?:scan_bwd|reduce_bc|reduce_params)_kernel\b")


def _scan_inputs(shape, groups, dtype, device):
    """K4's inputs (x, dt, Bm, Cm, a_log, d_skip) and an output gradient at
    (B, S, D, N), from a seed (dt = |0.02 randn + 0.05|, a_log = log(1..N) +
    0.1 randn), with ``groups`` weight sets (0: shared)."""
    import torch

    b, s, d, n = shape
    g = torch.Generator().manual_seed(b * s + d + n + groups)
    x = (torch.randn(b, s, d, generator=g) * 0.5).to(dtype).to(device)
    dt = (torch.randn(b, s, d, generator=g) * 0.02 + 0.05).abs().to(dtype).to(device)
    bm, cm = (torch.randn(b, s, n, generator=g).to(dtype).to(device) for _ in range(2))
    wshape = (d, n) if groups == 0 else (groups, d, n)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(*wshape)
    a_log = (a_log + 0.1 * torch.randn(*wshape, generator=g)).to(device)
    d_skip = (1 + 0.1 * torch.randn(*wshape[:-1], generator=g)).to(device)
    dy = torch.randn(b, s, d, generator=g).to(dtype).to(device)
    return (x, dt, bm, cm, a_log, d_skip), dy


def _check_mamba(shape, groups, dtype, checkpoints, device, final_state=False):
    """K4 at (B, S, D, N) with ``groups`` weight sets (0: shared (D, N)
    weights): forward y, with and without checkpoints, and backward (all
    six gradients) against the plain version and its autograd on the card,
    and times; with ``final_state`` also the forward's state after the last
    step (the serving prefill's call: no checkpoints), timed so."""
    import torch

    from repro_torch.kernels.mamba_scan import (
        mamba_scan_backward,
        mamba_scan_forward,
        mamba_scan_ref,
    )
    from repro_torch.kernels.mamba_scan.ops import scan_work

    b, s, d, n = shape
    inputs, dy = _scan_inputs(shape, groups, dtype, device)
    x = inputs[0]
    y, ckpt = mamba_scan_forward(*inputs, checkpoints=True)
    y_no_ckpt = mamba_scan_forward(*inputs)   # as the poll and the evaluations call it
    y_fin, h_fin = mamba_scan_forward(*inputs, final_state=True)   # as a prefill calls it
    grads = mamba_scan_backward(*inputs, ckpt, dy)
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    y_ref = mamba_scan_ref(*leaves)
    _, h_ref = mamba_scan_ref(*inputs, final_state=True)
    grads_ref = torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()

    # fp32: the kernel sums over N, over channels (dbmat, dcmat) and over rows
    # and steps (da_log, dd_skip) in another order than the plain version, and
    # contracts multiply-adds; bf16: one rounding of y and of the four
    # sequence gradients to 8 bits of mantissa.  Relative to max(1, max |plain|).
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    errs, limits = {}, {}
    names = ("y", "y_no_ckpt", "y_final_state", "h_final", "dx", "ddt", "dbmat", "dcmat",
             "da_log", "dd_skip")
    for name, got, want in zip(names, (y, y_no_ckpt, y_fin, h_fin, *grads),
                               (y_ref, y_ref, y_ref, h_ref, *grads_ref)):
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"mamba_scan {shape} {dtype} {name}: bad output "
                                 f"{tuple(got.shape)} {got.dtype}")
        errs[name] = (got.float() - want.float()).abs().max().item()
        limits[name] = tol * max(1.0, want.float().abs().max().item())
    tag = f"{list(shape)} groups={groups} {str(dtype).replace('torch.', '')}"
    if any(errs[k] > limits[k] for k in errs):
        raise AssertionError(f"mamba_scan {tag}: max |err| {errs} above {limits}")
    fwd_bytes, bwd_bytes, elements = scan_work(shape, max(groups, 1), x.element_size(),
                                               final_state)
    # per (b, t, d, n): forward 1 exp and 5 flops (dt A, the state update and
    # the C contraction); backward at least 1 exp and 16 flops (the state
    # recurrence again, then the reverse one and its six gradient terms)
    fwd_bound = _scan_bound(fwd_bytes, elements, 5, 1)
    bwd_bound = _scan_bound(bwd_bytes, elements, 16, 1)
    plain_calls, plain_warmup = (5, 1) if s > 1024 else (TIMED_CALLS, 3)
    forward = lambda: mamba_scan_forward(*inputs, checkpoints=checkpoints,  # noqa: E731
                                         final_state=final_state)
    backward = lambda: mamba_scan_backward(*inputs, ckpt, dy)  # noqa: E731
    rec = {"shape": list(shape), "groups": groups, "dtype": str(dtype).replace("torch.", ""),
           "checkpoints": checkpoints, "final_state": final_state, "errors": errs,
           "tolerance": tol,
           "forward": {
               "max_abs_err": max(errs[k] for k in names[:4]),
               "ms": _median_ms(forward),
               "plain_ms": _median_ms(lambda: mamba_scan_ref(*inputs), plain_calls, plain_warmup),
               "library_ms": None, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
           "backward": {
               "max_abs_err": max(errs[k] for k in names[4:]),
               "ms": _median_ms(backward),
               "plain_ms": _median_ms(lambda: torch.autograd.grad(y_ref, leaves, dy,
                                                                  retain_graph=True),
                                      plain_calls, plain_warmup),
               "library_ms": None, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}}
    print(f"kernel mamba_scan {json.dumps(rec)}", flush=True)
    return rec


def _scan_kernel_ms(rec, device) -> None:
    """Adds ``kernel_ms`` to the forward and backward of a ``_check_mamba``
    record: the scan kernels' own device time a call, on the same inputs.
    Run after every timed path, so that no profiler session precedes a
    host-bound measurement."""
    import torch

    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward

    dtype = getattr(torch, rec["dtype"])
    inputs, dy = _scan_inputs(tuple(rec["shape"]), rec["groups"], dtype, device)
    _, ckpt = mamba_scan_forward(*inputs, checkpoints=True)
    rec["forward"]["kernel_ms"], fwd_n = _kernel_ms(
        lambda: mamba_scan_forward(*inputs, checkpoints=rec["checkpoints"],
                                   final_state=rec["final_state"]),
        SCAN_FORWARD, counter=mamba_scan_forward)
    rec["backward"]["kernel_ms"], bwd_n = _kernel_ms(
        lambda: mamba_scan_backward(*inputs, ckpt, dy), SCAN_BACKWARD,
        counter=mamba_scan_backward)
    tag = {k: rec[k] for k in ("shape", "groups", "dtype", "checkpoints", "final_state")}
    print(f"kernel mamba_scan kernel-only {json.dumps(tag)}: forward "
          f"{rec['forward']['kernel_ms']} ms ({fwd_n} launches recorded in {TIMED_CALLS} "
          f"calls), backward {rec['backward']['kernel_ms']} ms ({bwd_n} recorded)",
          flush=True)
    for direction in ("forward", "backward"):
        _not_below_bound(f"mamba_scan {direction} {tag}", rec[direction]["kernel_ms"],
                         rec[direction]["bound_ms"])


def _flash_kernel_ms(rec, device) -> None:
    """Adds ``kernel_ms`` to the forward and backward of a ``_check_flash``
    record (the backward's the sum of its dQ and dK/dV kernels, each also
    apart): K3's own device time a call, on the same inputs."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )

    dtype = getattr(torch, rec["dtype"])
    window, is_global = rec["window"], rec["is_global"]
    q, k, v, do = _flash_inputs(tuple(rec["shape"]), dtype, device)
    o, lse = flash_attention_forward(q, k, v, window, is_global)
    backward = lambda: flash_attention_backward(q, k, v, o, lse, do, window,  # noqa: E731
                                                is_global)
    rec["forward"]["kernel_ms"], fwd_n = _kernel_ms(
        lambda: flash_attention_forward(q, k, v, window, is_global), FLASH_FORWARD,
        counter=flash_attention_forward)
    rec["backward"]["dq_kernel_ms"], dq_n = _kernel_ms(backward, FLASH_DQ,
                                                       counter=flash_attention_backward)
    rec["backward"]["dkdv_kernel_ms"], dkdv_n = _kernel_ms(backward, FLASH_DKDV,
                                                           counter=flash_attention_backward)
    rec["backward"]["kernel_ms"] = (rec["backward"]["dq_kernel_ms"]
                                    + rec["backward"]["dkdv_kernel_ms"])
    tag = {key: rec[key] for key in ("shape", "dtype", "window", "is_global")}
    print(f"kernel flash_attention kernel-only {json.dumps(tag)}: forward (fwd_kernel) "
          f"{rec['forward']['kernel_ms']} ms of {rec['forward']['ms']} ({fwd_n} launches "
          f"recorded in {TIMED_CALLS} calls), backward {rec['backward']['kernel_ms']} ms of "
          f"{rec['backward']['ms']} (dq_kernel {rec['backward']['dq_kernel_ms']}, {dq_n} "
          f"recorded; dkdv_kernel {rec['backward']['dkdv_kernel_ms']}, {dkdv_n} recorded)",
          flush=True)
    for direction in ("forward", "backward"):
        _not_below_bound(f"flash_attention {direction} {tag}", rec[direction]["kernel_ms"],
                         rec[direction]["bound_ms"])


def _reduce_kernel_ms(rec, device) -> None:
    """Adds ``kernel_ms`` and ``library_kernel_ms`` to a ``_check_aggregate``
    record: K1's own device time a call, and that of the kernels that
    ``w @ x`` launches, on the same inputs."""
    import torch

    from repro_torch.kernels.aggregate import masked_weighted_sum

    x, w = _aggregate_inputs(tuple(rec["shape"]), getattr(torch, rec["dtype"]), device)
    w_lib = w.to(x.dtype)
    rec["kernel_ms"], rec["kernel_recorded"] = _kernel_ms(
        lambda: masked_weighted_sum(x, w), FEDAVG_KERNEL, counter=masked_weighted_sum)
    rec["library_kernel_ms"], rec["library_recorded"] = _kernel_ms(lambda: w_lib @ x,
                                                                   ANY_KERNEL)
    _print_kernel_only("masked_weighted_sum", {k: rec[k] for k in ("shape", "dtype")}, rec)
    _not_below_bound(f"masked_weighted_sum {rec['shape']} {rec['dtype']}", rec["kernel_ms"],
                     rec["bound_ms"], x.numel() * x.element_size() + 4 * (w.numel() + x.shape[1]))
    del x, w, w_lib
    torch.cuda.empty_cache()


def _strip_kernel_ms(rec, device) -> None:
    """Adds ``kernel_ms`` and ``library_kernel_ms`` to a ``_check_hellinger``
    record: K2's own device time a call, and that of the kernels that
    ``sqrt(clamp(1 - rb @ r.T, 0, 1))`` launches, on the same inputs."""
    from repro_torch.kernels.hellinger import hellinger_strip

    rb, r = _strip_inputs(tuple(rec["shape"]), device)
    rec["kernel_ms"], rec["kernel_recorded"] = _kernel_ms(
        lambda: hellinger_strip(rb, r), STRIP_KERNEL, counter=hellinger_strip)
    rec["library_kernel_ms"], rec["library_recorded"] = _kernel_ms(
        lambda: _strip_library(rb, r), ANY_KERNEL)
    _print_kernel_only("hellinger_strip", {"shape": rec["shape"]}, rec)
    b, k, c = rec["shape"]
    _not_below_bound(f"hellinger_strip {rec['shape']}", rec["kernel_ms"], rec["bound_ms"],
                     4 * (b * c + k * c + b * k))


def _print_kernel_only(name, tag, rec) -> None:
    """One phase-6 line: the kernel's and the library's device time a call,
    and the share of the wrapper's event-timed ``ms`` (phase 3) that is host
    work; negative where this phase's kernel time exceeds phase 3's ``ms``."""
    rec["host_share"] = 1 - rec["kernel_ms"] / rec["ms"]
    print(f"kernel {name} kernel-only {json.dumps(tag)}: kernel {rec['kernel_ms']} ms "
          f"({rec['kernel_recorded']} launches recorded in {TIMED_CALLS} calls), library "
          f"{rec['library_kernel_ms']} ms ({rec['library_recorded']} kernel launches "
          f"recorded), bound {rec['bound_ms']} ms, host share of the wrapper's {rec['ms']} ms "
          f"{rec['host_share']:.3f}", flush=True)


def _main_path(device):
    """The paper's experiment at full width, 5 rounds; returns the kernels'
    launch counts from this run alone."""
    import numpy as np
    import torch

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    t = time.perf_counter()
    train = make_classification(20_000, seed=0)
    test = make_classification(2_000, seed=1)
    print(f"main: data {time.perf_counter() - t:.3f} s  train {train.x.shape} test {test.x.shape}",
          flush=True)
    cfg = FLConfig(n_clients=100, m=10, rounds=5, strategy="fedlecc", strategy_kwargs={"J": 3},
                   partition="shards", target_hd=0.9, batch_size=64, lr=0.005, eval_every=1,
                   hidden=(200, 200), seed=0)

    hellinger_strip.launches = 0
    masked_weighted_sum.launches = 0
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=10, device=device)
    torch.cuda.synchronize()
    n_clusters = engine.strategy.n_clusters
    print(f"main: engine setup {time.perf_counter() - t:.3f} s  shards/client={engine.alpha:g}  "
          f"OPTICS clusters={n_clusters}  P={engine.n_params}  max_steps={engine.max_steps}",
          flush=True)
    results = []
    it = engine.rounds()
    while True:
        t = time.perf_counter()
        r = next(it, None)
        if r is None:
            break
        wall = time.perf_counter() - t
        results.append(r)
        print(f"main: round {r.round} selected={list(r.selected)} test_acc={r.test_acc:.4f} "
              f"test_loss={r.test_loss:.4f} train_loss={r.mean_selected_loss:.4f} "
              f"comm={r.comm_mb:.3f} MB wall={wall * 1e3:.2f} ms", flush=True)
    launches = {"hellinger_strip": hellinger_strip.launches,
                "masked_weighted_sum": masked_weighted_sum.launches}
    print(f"main: launches {json.dumps(launches)}", flush=True)

    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if len(results) != cfg.rounds:
        raise AssertionError(f"ran {len(results)} rounds, expected {cfg.rounds}")
    if engine.alpha != 1.0 or n_clusters != 10 or np.bincount(engine.strategy.labels).tolist() != [10] * 10:
        raise AssertionError("paper-scale shards partition should give 10 OPTICS clusters of 10 "
                             f"(got shards={engine.alpha}, clusters={n_clusters})")
    for r in results:
        sel = list(r.selected)
        if len(sel) != cfg.m or sorted(set(sel)) != sel or not 0 <= sel[0] <= sel[-1] < cfg.n_clients:
            raise AssertionError(f"round {r.round}: bad selection {sel}")
        if not (math.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0
                and math.isfinite(r.mean_selected_loss)):
            raise AssertionError(f"round {r.round}: bad metrics {r}")
    if not (engine.params.is_cuda and engine.params.shape == (199_210,)
            and torch.isfinite(engine.params).all()):
        raise AssertionError("final parameters are not a finite (199210,) CUDA tensor")
    return launches


# The paper's classification presets; the strategies that build the
# Hellinger matrix at setup (K2), and the aggregators that reduce the cohort
# with K1 (the rest sort it)
PRESETS = ("fedavg", "fedprox", "fednova", "feddyn", "haccs", "fedcls", "fedcor", "poc",
           "fedlecc", "fedlecc_adaptive")
HELLINGER_STRATEGIES = ("fedlecc", "fedlecc_adaptive", "haccs", "fedcor", "clusterrandom")
REDUCING_AGGREGATORS = ("fedavg", "fednova", "feddyn")
# The quickstart gate of tests/test_torch_quickstart.py: the mean accuracy
# of the last three evaluated rounds, averaged over seeds 0-2, within the
# reference's mean over seeds 0-24 (scripts/quickstart_band.py) +- 2
# standard errors of a three-seed mean
QUICKSTART_REF_MEAN, QUICKSTART_REF_SD, QUICKSTART_SEEDS = 0.4272, 0.0847, (0, 1, 2)


def _paper_run(device, tag, cfg, train, test):
    """One run of ``cfg`` through ``make_engine(...).rounds()``, K1 and K2
    counted from 0 over it; checks the launches, the selections and the
    metrics; returns its record."""
    import torch

    from repro_torch.engine import make_engine, rounds_to_accuracy
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    hellinger_strip.launches = masked_weighted_sum.launches = 0
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=10, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    results, walls = [], []
    it = engine.rounds()
    while True:
        t = time.perf_counter()
        r = next(it, None)
        if r is None:
            break
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        results.append(r)
    last = results[-1]
    rec = {"tag": tag, "strategy": cfg.strategy, "aggregator": cfg.aggregator,
           "client_mode": cfg.client_mode, "clusters": getattr(engine.strategy, "n_clusters", None),
           "rounds": len(results), "setup_s": setup_s,
           "median_round_ms": statistics.median(walls) * 1e3, "final_test_acc": last.test_acc,
           "rounds_to_50": rounds_to_accuracy(engine.history, 0.5), "comm_mb": last.comm_mb,
           "k1_launches": masked_weighted_sum.launches, "k2_launches": hellinger_strip.launches}
    print(f"comparison: {json.dumps(rec)}", flush=True)
    want_k1 = cfg.rounds if cfg.aggregator in REDUCING_AGGREGATORS else 0
    want_k2 = 1 if cfg.strategy in HELLINGER_STRATEGIES else 0  # K = 100: one strip
    if (rec["k1_launches"], rec["k2_launches"]) != (want_k1, want_k2):
        raise AssertionError(f"{tag}: K1/K2 launched {rec['k1_launches']}/{rec['k2_launches']} "
                             f"times; expected {want_k1}/{want_k2}")
    if len(results) != cfg.rounds:
        raise AssertionError(f"{tag}: ran {len(results)} rounds, expected {cfg.rounds}")
    for r in results:
        sel = list(r.selected)
        if len(sel) != cfg.m or sorted(set(sel)) != sel or not 0 <= sel[0] <= sel[-1] < cfg.n_clients:
            raise AssertionError(f"{tag} round {r.round}: bad selection {sel}")
        if not (math.isfinite(r.mean_selected_loss) and math.isfinite(r.comm_mb)):
            raise AssertionError(f"{tag} round {r.round}: bad metrics {r}")
        if r.evaluated and not (math.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0):
            raise AssertionError(f"{tag} round {r.round}: bad metrics {r}")
    if not (engine.params.is_cuda and torch.isfinite(engine.params).all()):
        raise AssertionError(f"{tag}: final parameters are not a finite CUDA tensor")
    if engine.h_clients is not None and not torch.isfinite(engine.h_clients).all():
        raise AssertionError(f"{tag}: FedDyn's client state is not finite")
    rec["evaluated"] = [(r.round, r.test_acc) for r in results if r.evaluated]
    del engine, it
    return rec


def _comparison(device):
    """The paper's comparison on the card at ``_main_path``'s data and
    settings: every classification preset for 150 rounds, the other
    strategies and the robust aggregators for 3, then the quickstart band."""
    import numpy as np

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, get_preset

    train = make_classification(20_000, seed=0)
    test = make_classification(2_000, seed=1)
    paper = dict(n_clients=100, m=10, partition="shards", target_hd=0.9, batch_size=64, lr=0.005,
                 hidden=(200, 200), seed=0)
    t = time.perf_counter()
    records = [_paper_run(device, name, get_preset(name).make_config(rounds=150, eval_every=5,
                                                                     **paper), train, test)
               for name in PRESETS]
    others = {"fedcs": {"strategy": "fedcs"}, "lossonly": {"strategy": "lossonly"},
              "clusterrandom": {"strategy": "clusterrandom", "strategy_kwargs": {"J": 3}},
              "fedlecc_auto": {"strategy": "fedlecc",
                               "strategy_kwargs": {"J": 3, "cluster": "auto"}},
              "trimmed_mean": {"strategy": "random", "aggregator": "trimmed_mean"},
              "coordinate_median": {"strategy": "random", "aggregator": "coordinate_median"}}
    for tag, kw in others.items():
        _paper_run(device, tag, FLConfig(rounds=3, eval_every=1, **paper, **kw), train, test)
    print(f"comparison: {len(records)} presets x 150 rounds and {len(others)} runs x 3 rounds "
          f"in {time.perf_counter() - t:.1f} s", flush=True)

    train = make_classification(10_000, seed=0)
    gates = []
    for seed in QUICKSTART_SEEDS:
        cfg = FLConfig(n_clients=40, m=6, rounds=30, strategy="fedlecc", strategy_kwargs={"J": 4},
                       target_hd=0.85, eval_every=5, seed=seed)
        rec = _paper_run(device, f"quickstart seed {seed}", cfg, train, test)
        gates.append(float(np.mean([acc for _, acc in rec["evaluated"][-3:]])))
    half = 2 * QUICKSTART_REF_SD / math.sqrt(len(QUICKSTART_SEEDS))
    band = (QUICKSTART_REF_MEAN - half, QUICKSTART_REF_MEAN + half)
    gate = float(np.mean(gates))
    print(f"quickstart: last-three mean accuracy by seed {gates}, mean {gate:.4f}, reference "
          f"band [{band[0]:.4f}, {band[1]:.4f}]", flush=True)
    if not band[0] <= gate <= band[1]:
        raise AssertionError(f"quickstart accuracy {gate} outside the reference band {band}")
    return records


# The paper's configuration on the backends: (a) the host backend, (b) the
# compiled backend, eager, (c) compiled, fused in chunks of 5 rounds (a CUDA
# graph a chunk length), (d) (c) with int8 uploads
BACKEND_RUNS = {"host": {}, "compiled": {"backend": "compiled"},
                "fused": {"backend": "compiled", "fuse_rounds": 5},
                "fused_int8": {"backend": "compiled", "fuse_rounds": 5, "compress_bits": 8}}
# the host-parity tolerance of tests/test_torch_engine.py, and the reference's
# bound for int8 uploads against exact ones (tests/test_backend_conformance.py)
PARITY_ATOL, INT8_ATOL = 1e-5, 5e-3


def _k1_launches(engine) -> int:
    """K1's launches in a run: the wrapper's eager launches, and those that
    the replays of a fused engine's CUDA graphs make."""
    from repro_torch.kernels.aggregate import masked_weighted_sum

    return masked_weighted_sum.launches + (
        engine.replayed_launches() if hasattr(engine, "replayed_launches") else 0)


def _timed_run(device, cfg, train, test):
    """``cfg`` to its last round through ``make_engine(...).rounds()``, K1 and
    K2 counted from 0 over it, each step timed (a fused chunk's rounds
    together); returns (engine, results, setup s, steps: (rounds, ms,
    whether a graph replayed them), the median round's ms: a replayed
    chunk's ms / its rounds when fused)."""
    import torch

    from repro_torch.engine import make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    hellinger_strip.launches = masked_weighted_sum.launches = masked_weighted_sum.captured = 0
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=10, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    fused = cfg.fuse_rounds > 0
    results, steps = [], []
    it = engine.rounds()
    while len(results) < cfg.rounds:
        length = engine._chunk_len(len(results), cfg.rounds) if fused else 1
        replay = fused and length in engine._graphs
        t = time.perf_counter()
        for _ in range(length):
            results.append(next(it))
        torch.cuda.synchronize()
        steps.append((length, (time.perf_counter() - t) * 1e3, replay))
    median_ms = statistics.median(ms / n for n, ms, replay in steps if replay or not fused)
    return engine, results, setup_s, steps, median_ms


def _backend_run(device, tag, cfg, train, test):
    """``cfg`` through ``_timed_run``; checks launches, replays, selections
    and learning; returns (record, engine, results)."""
    import torch

    from repro_torch.engine import rounds_to_accuracy
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    engine, results, setup_s, steps, median_ms = _timed_run(device, cfg, train, test)
    fused = cfg.fuse_rounds > 0
    last = results[-1]
    rec = {"tag": tag, "backend": cfg.backend, "fuse_rounds": cfg.fuse_rounds,
           "compress_bits": cfg.compress_bits, "rounds": len(results), "setup_s": setup_s,
           "median_round_ms": median_ms, "final_test_acc": last.test_acc,
           "rounds_to_50": rounds_to_accuracy(engine.history, 0.5), "comm_mb": last.comm_mb,
           "k1_launches": _k1_launches(engine), "k2_launches": hellinger_strip.launches}
    if fused:
        seen = set()
        rec["first_chunk_ms"] = {}  # the first chunk of each length: eager, then captured
        for n, ms, _ in steps:
            if n not in seen:
                seen.add(n)
                rec["first_chunk_ms"][n] = ms
        rec |= {"k1_eager": masked_weighted_sum.launches, "k1_replayed": engine.replayed_launches(),
                "graph_replays": engine.graph_replays, "graph_launches": engine.graph_launches,
                "median_chunk_ms": statistics.median(ms for _, ms, replay in steps if replay)}
    if cfg.compress_bits:
        rec["last_quant_error"] = engine.last_quant_error
    print(f"backends: {json.dumps(rec)}", flush=True)
    if (rec["k1_launches"], rec["k2_launches"]) != (cfg.rounds, 1):
        raise AssertionError(f"{tag}: K1/K2 launched {rec['k1_launches']}/{rec['k2_launches']} "
                             f"times; expected {cfg.rounds}/1")
    if fused:
        if not any(engine.graph_replays.values()):
            raise AssertionError(f"{tag}: no CUDA graph was replayed {engine.graph_replays}")
        if (masked_weighted_sum.captured != sum(engine.graph_launches.values())
                or any(k1 != n for n, k1 in engine.graph_launches.items())):
            raise AssertionError(f"{tag}: a captured chunk of L rounds should hold L K1 launches: "
                                 f"{engine.graph_launches}")
    for r in results:
        sel = list(r.selected)
        if len(sel) != cfg.m or sorted(set(sel)) != sel or not 0 <= sel[0] <= sel[-1] < cfg.n_clients:
            raise AssertionError(f"{tag} round {r.round}: bad selection {sel}")
        if not (math.isfinite(r.mean_selected_loss) and math.isfinite(r.comm_mb)):
            raise AssertionError(f"{tag} round {r.round}: bad metrics {r}")
    if not (engine.params.is_cuda and torch.isfinite(engine.params).all()
            and last.test_acc > 0.5):
        raise AssertionError(f"{tag}: final parameters not finite or no learning "
                             f"(accuracy {last.test_acc})")
    return rec, engine, results


# what two runs of the axes must agree on every round
AXES_FIELDS = ("round", "selected", "n_dropped", "sim_time", "n_faulty", "n_quarantined")


def _same_run(tag, a, b, atol, phase="backends", fields=("round", "selected")):
    """Two runs (engine, results) agree on ``fields`` (the selections, and
    with ``AXES_FIELDS`` the drops and fault counts) every round and end
    within ``atol`` of each other's parameters."""
    (ea, ra), (eb, rb) = a, b
    same = [tuple(getattr(r, f) for f in fields) for r in ra] == [
        tuple(getattr(r, f) for f in fields) for r in rb]
    diff = float((ea.params - eb.params).abs().max())
    print(f"{phase} {tag}: {len(ra)} rounds, same selections every round: {same}, "
          f"max |params diff| {diff:.3g} (tolerance {atol})", flush=True)
    if not same:
        raise AssertionError(f"{tag}: the runs selected different clients")
    if not diff <= atol:
        raise AssertionError(f"{tag}: parameters differ by {diff} > {atol}")


def _backends(device):
    """The paper's configuration for 150 rounds on the host backend, the
    compiled backend, its fused chunks and fused int8 uploads; then their
    agreements (host and compiled too), and a profile of a host round and of a replayed chunk.
    Returns K1's launches over the four runs."""
    import torch

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine

    train = make_classification(20_000, seed=0)
    test = make_classification(2_000, seed=1)
    paper = dict(n_clients=100, m=10, partition="shards", target_hd=0.9, batch_size=64, lr=0.005,
                 hidden=(200, 200), seed=0, strategy="fedlecc", strategy_kwargs={"J": 3},
                 rounds=150, eval_every=5)
    t = time.perf_counter()
    runs = {tag: _backend_run(device, tag, FLConfig(**paper, **kw), train, test)
            for tag, kw in BACKEND_RUNS.items()}
    _same_run("fedlecc host vs compiled", runs["host"][1:], runs["compiled"][1:], PARITY_ATOL)
    _same_run("fedlecc compiled vs fused", runs["compiled"][1:], runs["fused"][1:], PARITY_ATOL)
    k1 = sum(rec["k1_launches"] for rec, _, _ in runs.values())
    if not runs["fused_int8"][0]["comm_mb"] < runs["fused"][0]["comm_mb"]:
        raise AssertionError("int8 uploads did not bill fewer MB")
    del runs

    def run(n, cohort_gather=True, **kw):
        engine = make_engine(FLConfig(**(paper | kw)), train, test, n_classes=10, device=device,
                             cohort_gather=cohort_gather)
        return engine, list(engine.rounds(n))

    # the legacy path: all 100 clients train, K1 reduces (100, P) with zero
    # weights outside the mask
    _same_run("fedlecc compiled cohort_gather=False vs gathered",
              run(3, backend="compiled"), run(3, cohort_gather=False, backend="compiled"),
              PARITY_ATOL)

    for strategy in ("lossonly", "haccs"):
        _same_run(f"{strategy} compiled vs fused",
                  run(30, strategy=strategy, strategy_kwargs={}, backend="compiled"),
                  run(30, strategy=strategy, strategy_kwargs={}, backend="compiled",
                      fuse_rounds=5), PARITY_ATOL)
    for strategy, skw in (("random", {}), ("poc", {}), ("clusterrandom", {"J": 3})):
        kw = dict(strategy=strategy, strategy_kwargs=skw, backend="compiled", fuse_rounds=5)
        engine = make_engine(FLConfig(**(paper | kw)), train, test, n_classes=10, device=device)
        chunked = list(engine.rounds(7)) + list(engine.rounds(11)) + list(engine.rounds(12))
        _same_run(f"{strategy} fused rounds(30) in three calls vs one", run(30, **kw),
                  (engine, chunked), PARITY_ATOL)
    exact = run(3, backend="compiled", fuse_rounds=5)
    quant = run(3, backend="compiled", fuse_rounds=5, compress_bits=8)
    diff = float((exact[0].params - quant[0].params).abs().max())
    mb = (exact[1][-1].comm_mb, quant[1][-1].comm_mb)
    print(f"backends int8 vs exact fused uploads, 3 rounds: max |params diff| {diff:.3g} "
          f"(tolerance {INT8_ATOL}), {mb[1]:.3f} MB against {mb[0]:.3f}, mean quantization "
          f"error {quant[0].last_quant_error:.3g}", flush=True)
    if not (diff <= INT8_ATOL and mb[1] < mb[0]):
        raise AssertionError(f"int8 uploads: params differ by {diff} (> {INT8_ATOL}?) or "
                             f"{mb[1]} MB is not below {mb[0]}")
    print(f"backends: phase in {time.perf_counter() - t:.1f} s", flush=True)

    # device profiles of one host round and one replayed fused chunk, after
    # this phase's host-timed runs
    engine = make_engine(FLConfig(**(paper | {"rounds": 5})), train, test, n_classes=10,
                         device=device)
    it = engine.rounds()
    next(it), next(it)  # rounds 0 (evaluated) and 1; round 2 is not evaluated
    torch.cuda.synchronize()
    with _profiled(True) as prof:
        t = time.perf_counter()
        next(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    _print_profile(prof, wall, "backends host round", (), host_top=True)
    engine = make_engine(FLConfig(**(paper | {"rounds": 11, "backend": "compiled",
                                              "fuse_rounds": 5})),
                         train, test, n_classes=10, device=device)
    it = engine.rounds()
    for _ in range(6):  # round 0, then rounds 1-5: the chunk of 5 that is captured
        next(it)
    torch.cuda.synchronize()
    with _profiled(True) as prof:
        t = time.perf_counter()
        for _ in range(5):  # rounds 6-10: a replay
            next(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if engine.graph_replays.get(5) != 1:
        raise AssertionError(f"the profiled chunk was not a replay: {engine.graph_replays}")
    _print_profile(prof, wall, "backends fused chunk (5 rounds, replayed)", (), host_top=True)
    return k1



# The systems and fault axes at the paper's configuration: the grids of
# benchmarks/bench_systems.py (mobile_mix devices with markov availability,
# no deadline against a deadline at the 60th percentile of the profile's
# round times with over-selection 1.0 / 1.3 / 1.6) and
# benchmarks/bench_robustness.py (sign_flip at 0 / 5 / 20 % against no
# defense, the validation gate, and the gate with the trimmed mean)
AXES_STRATEGIES = ("fedlecc", "random", "poc", "haccs")
DEADLINE_PCT, OVER_SELECT = 60, (1.0, 1.3, 1.6)
FAULT_RATES = (0.0, 0.05, 0.2)
DEFENSES = {"none": {}, "validate": {"defense": "validate"},
            "validate+trimmed_mean": {"defense": "validate", "aggregator": "trimmed_mean"}}


def _mobile_mix(deadline_s, over_select):
    """The systems config of ``benchmarks/bench_systems.py``."""
    return dict(profile="mobile_mix", availability="markov",
                availability_kwargs={"p_drop": 0.1, "p_join": 0.5}, jitter_sigma=0.2,
                deadline_s=deadline_s, over_select=over_select)


def _paper_data():
    from repro_torch.data import make_classification

    return make_classification(20_000, seed=0), make_classification(2_000, seed=1)


PAPER = dict(n_clients=100, m=10, partition="shards", target_hd=0.9, batch_size=64, lr=0.005,
             hidden=(200, 200), seed=0, rounds=150, eval_every=5)


def _deadline(device, cfg, train, test, n_classes=10):
    """The ``DEADLINE_PCT`` percentile of the profile's jitter-free round
    times for ``cfg`` (a probe engine: the clock is fixed at construction)."""
    import numpy as np
    import torch

    from repro_torch.engine import FLConfig, make_engine

    probe = make_engine(FLConfig(**{**cfg, "rounds": 1}), train, test, n_classes=n_classes,
                        device=device)
    deadline = float(np.percentile(probe._systems.clock.base_times(), DEADLINE_PCT))
    del probe
    torch.cuda.empty_cache()
    return deadline


def _axis_run(device, phase, tag, cfg, train, test):
    """``cfg`` (with a systems or fault axis) through ``_timed_run``; checks
    the survivors, the drop accounting, K1's and K2's launches and finite
    parameters; returns (record, engine, results)."""
    import numpy as np
    import torch

    from repro_torch.kernels.hellinger import hellinger_strip

    engine, results, setup_s, _, median_ms = _timed_run(device, cfg, train, test)
    fused = cfg.fuse_rounds > 0
    evaluated = [r for r in results if r.evaluated]
    with_survivors = sum(1 for r in results if r.selected)
    rec = {"tag": tag, "strategy": cfg.strategy, "aggregator": cfg.aggregator,
           "backend": cfg.backend, "fuse_rounds": cfg.fuse_rounds, "m_eff": engine.m_eff,
           "rounds": len(results), "setup_s": setup_s, "median_round_ms": median_ms,
           "final_acc": evaluated[-1].test_acc, "best_acc": max(r.test_acc for r in evaluated),
           "total_sim_s": results[-1].sim_clock, "comm_mb": results[-1].comm_mb,
           "mean_dropped_per_round": float(np.mean([r.n_dropped for r in results])),
           "total_faulty": sum(r.n_faulty for r in results),
           "max_quarantined": max(r.n_quarantined for r in results),
           "rounds_with_survivors": with_survivors,
           "k1_launches": _k1_launches(engine), "k2_launches": hellinger_strip.launches}
    if fused:
        rec["graph_replays"] = engine.graph_replays
    rec["evaluated"] = [(r.round, r.test_acc, r.sim_clock, r.comm_mb) for r in evaluated]
    print(f"{phase}: {json.dumps({k: v for k, v in rec.items() if k != 'evaluated'})}",
          flush=True)
    want_k2 = 1 if cfg.strategy in HELLINGER_STRATEGIES else 0
    reduces = cfg.aggregator in REDUCING_AGGREGATORS
    if cfg.backend == "host":  # the survivors' rows; a flagged round is reduced again
        k1_ok = (with_survivors <= rec["k1_launches"] <= 2 * cfg.rounds if reduces
                 else rec["k1_launches"] == 0)
        if cfg.faults is None:
            k1_ok = rec["k1_launches"] == (with_survivors if reduces else 0)
    else:  # every round's cohort, dropped and flagged rows at weight zero
        k1_ok = rec["k1_launches"] == (cfg.rounds if reduces else 0)
    if not k1_ok or rec["k2_launches"] != want_k2:
        raise AssertionError(f"{tag}: K1/K2 launched {rec['k1_launches']}/{rec['k2_launches']} "
                             f"times ({with_survivors} rounds with survivors)")
    if fused and not any(engine.graph_replays.values()):
        raise AssertionError(f"{tag}: no CUDA graph was replayed {engine.graph_replays}")
    for r in results:
        sel = list(r.selected)
        if (sorted(set(sel)) != sel or len(sel) > engine.m_eff
                or (sel and not 0 <= sel[0] <= sel[-1] < cfg.n_clients)
                or len(sel) + r.n_dropped > engine.m_eff
                or (cfg.faults is None and len(sel) + r.n_dropped != engine.m_eff)):
            raise AssertionError(f"{tag} round {r.round}: bad survivors {sel} "
                                 f"(dropped {r.n_dropped}, m_eff {engine.m_eff})")
        if not math.isfinite(r.comm_mb) or not (r.sim_time >= 0 and r.n_faulty >= 0):
            raise AssertionError(f"{tag} round {r.round}: bad metrics {r}")
    if not (engine.params.is_cuda and torch.isfinite(engine.params).all()
            and all(0.0 <= acc <= 1.0 for _, acc, _, _ in rec["evaluated"])):
        raise AssertionError(f"{tag}: final parameters not finite or accuracy out of range")
    return rec, engine, results


def _time_to(rec, target):
    """(rounds, simulated s, MB) at the first evaluated round reaching
    ``target`` accuracy, or None."""
    for rnd, acc, clock, mb in rec["evaluated"]:
        if acc >= target:
            return {"rounds": rnd + 1, "sim_s": clock, "mb": mb}
    return None


def _systems_phase(device):
    """The systems grid on the host backend, 150 rounds a run, then fedlecc
    at the deadline with over-selection 1.3 on the compiled backend and in
    fused chunks of 5; returns K1's launches over the phase."""
    from repro_torch.engine import FLConfig

    train, test = _paper_data()
    t = time.perf_counter()
    deadline = _deadline(device, {**PAPER, "strategy": "random",
                                  "systems": _mobile_mix(None, 1.0)}, train, test)
    scenarios = {"no_deadline": _mobile_mix(None, 1.0)}
    scenarios |= {f"deadline_p{DEADLINE_PCT}_os{o}": _mobile_mix(deadline, o)
                  for o in OVER_SELECT}
    print(f"systems: deadline {deadline:.3f} simulated s (the profile's {DEADLINE_PCT}th "
          "percentile round time)", flush=True)
    k1, runs = 0, {}
    for strategy in AXES_STRATEGIES:
        kw = {"strategy_kwargs": {"J": 3}} if strategy == "fedlecc" else {}
        recs = {}
        for name, systems in scenarios.items():
            cfg = FLConfig(**PAPER, strategy=strategy, systems=systems, **kw)
            rec, engine, results = _axis_run(device, "systems", f"{strategy} {name}", cfg,
                                             train, test)
            k1 += rec["k1_launches"]
            recs[name] = rec
            if strategy == "fedlecc" and name == f"deadline_p{DEADLINE_PCT}_os1.3":
                runs["host"] = (engine, results)
            del engine, results
        target = 0.95 * min(rec["best_acc"] for rec in recs.values())
        summary = {name: _time_to(rec, target) for name, rec in recs.items()}
        print(f"systems {strategy} to {target:.4f} (95 % of the lowest best accuracy): "
              f"{json.dumps(summary)}", flush=True)
    cfg = FLConfig(**PAPER, strategy="fedlecc", strategy_kwargs={"J": 3},
                   systems=scenarios[f"deadline_p{DEADLINE_PCT}_os1.3"])
    for tag, kw in (("compiled", {"backend": "compiled"}),
                    ("fused", {"backend": "compiled", "fuse_rounds": 5})):
        rec, engine, results = _axis_run(device, "systems",
                                         f"fedlecc deadline_p{DEADLINE_PCT}_os1.3 {tag}",
                                         FLConfig(**{**cfg.to_dict(), **kw}), train, test)
        k1 += rec["k1_launches"]
        runs[tag] = (engine, results)
    _same_run("fedlecc host vs compiled", runs["host"], runs["compiled"], PARITY_ATOL,
              "systems", AXES_FIELDS)
    _same_run("fedlecc compiled vs fused", runs["compiled"], runs["fused"], PARITY_ATOL,
              "systems", AXES_FIELDS)
    runs["fused"][0].close()
    print(f"systems: phase in {time.perf_counter() - t:.1f} s", flush=True)
    return k1


def _faults_phase(device):
    """The robustness grid on the host backend, fedlecc, 150 rounds a run;
    rate 0 against ``faults=None``, host against compiled at 20 %, and fused
    chunks of 5 (the gate inside a captured graph) at 0 and 20 %; returns
    K1's launches over the phase."""
    import torch

    from repro_torch.engine import FLConfig

    train, test = _paper_data()
    base = dict(PAPER, strategy="fedlecc", strategy_kwargs={"J": 3})
    t = time.perf_counter()
    k1, recs, keep = 0, {}, {}
    for rate in FAULT_RATES:
        for name, kw in DEFENSES.items():
            kw = dict(kw)
            agg = kw.pop("aggregator", "fedavg")
            cfg = FLConfig(**base, aggregator=agg,
                           faults={"rate": rate, "models": ["sign_flip"], **kw})
            rec, engine, results = _axis_run(device, "faults", f"sign_flip {rate} {name}", cfg,
                                             train, test)
            k1 += rec["k1_launches"]
            recs[(rate, name)] = rec
            if (rate, name) in ((0.0, "none"), (0.2, "validate")):
                keep[(rate, name)] = (engine, results)
            del engine, results
    clean = recs[(0.0, "none")]["final_acc"]
    for (rate, name), rec in recs.items():
        print(f"faults: sign_flip {rate} {name}: final {rec['final_acc']:.4f} best "
              f"{rec['best_acc']:.4f} recovery {rec['final_acc'] / clean:.4f} total faulty "
              f"{rec['total_faulty']} max quarantined {rec['max_quarantined']} median round "
              f"{rec['median_round_ms']:.3f} ms", flush=True)
    rec, engine, results = _axis_run(device, "faults", "faults=None", FLConfig(**base), train,
                                     test)
    k1 += rec["k1_launches"]
    e0, r0 = keep[(0.0, "none")]
    same = (torch.equal(engine.params, e0.params)
            and [r.selected for r in results] == [r.selected for r in r0]
            and [r.comm_mb for r in results] == [r.comm_mb for r in r0])
    print(f"faults: rate 0 against faults=None, {len(results)} rounds, the same bits: {same}",
          flush=True)
    if not same:
        raise AssertionError("faults at rate 0 changed the run")
    del engine, results, e0, r0
    faulty = dict(base, faults={"rate": 0.2, "models": ["sign_flip"], "defense": "validate"})
    rec, engine, results = _axis_run(device, "faults", "sign_flip 0.2 validate compiled",
                                     FLConfig(**faulty, backend="compiled"), train, test)
    k1 += rec["k1_launches"]
    _same_run("sign_flip 0.2 validate host vs compiled", keep[(0.2, "validate")],
              (engine, results), PARITY_ATOL, "faults", AXES_FIELDS)
    del engine, results, keep
    for tag, cfg in (("fused rate 0", dict(base, faults={"rate": 0.0})),
                     ("fused sign_flip 0.2 validate", faulty)):
        rec, engine, results = _axis_run(device, "faults", tag,
                                         FLConfig(**cfg, backend="compiled", fuse_rounds=5),
                                         train, test)
        k1 += rec["k1_launches"]
        engine.close()
        del engine, results
    print(f"faults: phase in {time.perf_counter() - t:.1f} s", flush=True)
    return k1


# bench_systems.py --async at the paper's configuration: the strategies, the
# discount and the in-flight target of its async cells (2 m)
ASYNC_STRATEGIES = ("fedlecc", "random", "fedcs")
ASYNC_MODE = dict(staleness="polynomial", staleness_kwargs={"a": 0.5}, concurrency=20)
ASYNC_K5 = dict(ASYNC_MODE, buffer_k=5)


def _async_scenarios(deadline):
    """bench_systems.py --async's cells at m = 10, as (name, systems,
    async_mode, rounds): async steps pop 5 (or 10) arrivals, so async_k5
    runs twice the rounds."""
    rounds = PAPER["rounds"]
    return [("sync_no_deadline", _mobile_mix(None, 1.0), None, rounds),
            (f"sync_deadline_p{DEADLINE_PCT}_os1.3", _mobile_mix(deadline, 1.3), None, rounds),
            ("async_k5", _mobile_mix(None, 1.0), ASYNC_K5, 2 * rounds),
            ("async_k10", _mobile_mix(None, 1.0), dict(ASYNC_MODE, buffer_k=10), rounds)]


def _async_run(device, tag, cfg, train, test):
    """``cfg`` through ``make_engine(...).rounds()``, each step timed, K1 and
    K2 counted from 0; checks K1 (once a step that applies an update: the
    final params version under async; a round with survivors under the
    lock-step host loop), versions, the event clock and finite parameters;
    returns (record, engine, results)."""
    import numpy as np
    import torch

    from repro_torch.engine import make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    hellinger_strip.launches = masked_weighted_sum.launches = 0
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=10, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    results, walls = [], []
    for r in _timed(engine.rounds(), walls):
        results.append(r)
    evaluated = [r for r in results if r.evaluated]
    asynchronous = cfg.async_mode is not None and cfg.async_mode.dispatch == "async"
    updates = sum(1 for r in results if r.selected)
    rec = {"tag": tag, "strategy": cfg.strategy, "backend": cfg.backend,
           "async_mode": cfg.to_dict()["async_mode"], "faults": cfg.to_dict()["faults"],
           "rounds": len(results), "setup_s": setup_s,
           "median_step_ms": statistics.median(walls) * 1e3,
           "final_acc": evaluated[-1].test_acc, "best_acc": max(r.test_acc for r in evaluated),
           "total_sim_s": results[-1].sim_clock, "comm_mb": results[-1].comm_mb,
           "final_params_version": results[-1].params_version,
           "mean_staleness": float(np.mean([r.staleness for r in results])),
           "max_staleness": max(r.staleness for r in results),
           "steps_with_update": updates, "total_dropped": sum(r.n_dropped for r in results),
           "total_faulty": sum(r.n_faulty for r in results),
           "max_quarantined": max(r.n_quarantined for r in results),
           "k1_launches": masked_weighted_sum.launches, "k2_launches": hellinger_strip.launches}
    rec["evaluated"] = [(r.round, r.test_acc, r.sim_clock, r.comm_mb) for r in evaluated]
    print(f"async: {json.dumps({k: v for k, v in rec.items() if k != 'evaluated'})}",
          flush=True)
    want_k1 = results[-1].params_version if asynchronous else updates
    want_k2 = 1 if cfg.strategy in HELLINGER_STRATEGIES else 0
    if (rec["k1_launches"], rec["k2_launches"]) != (want_k1, want_k2):
        raise AssertionError(f"{tag}: K1/K2 launched {rec['k1_launches']}/{rec['k2_launches']} "
                             f"times; expected {want_k1}/{want_k2}")
    clock, version = 0.0, 0
    for r in results:
        sel = list(r.selected)
        bump = 1 if (sel or not asynchronous) else 0
        if (sorted(set(sel)) != sel or (sel and not 0 <= sel[0] <= sel[-1] < cfg.n_clients)
                or r.sim_clock < clock or r.params_version != version + bump
                or (asynchronous and len(sel) + r.n_dropped > cfg.async_mode.buffer_k)
                or not math.isfinite(r.comm_mb)):
            raise AssertionError(f"{tag} step {r.round}: bad step {r}")
        clock, version = r.sim_clock, r.params_version
    if asynchronous and not 0 < version <= len(results):
        raise AssertionError(f"{tag}: params version {version} after {len(results)} steps")
    if not (engine.params.is_cuda and torch.isfinite(engine.params).all()):
        raise AssertionError(f"{tag}: final parameters not a finite CUDA tensor")
    return rec, engine, results


def _timed(it, walls):
    """The items of ``it``, appending each one's wall seconds (the card
    synchronised) to ``walls``."""
    import torch

    while True:
        t = time.perf_counter()
        r = next(it, None)
        if r is None:
            return
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        yield r


ASYNC_FIELDS = ("round", "selected", "params_version", "staleness", "n_dropped", "sim_time",
                "n_faulty", "n_quarantined")


def _async_phase(device):
    """The ``--async`` sweep of bench_systems.py on the host backend, then
    fedlecc's async_k5 on the compiled backend against the host's,
    ``dispatch="sync"`` against the lock-step engine at the same bits, and
    async_k5 under sign_flip at 20 % behind the validation gate; returns
    K1's launches over the phase."""
    import torch

    from repro_torch.engine import FLConfig

    train, test = _paper_data()
    t = time.perf_counter()
    deadline = _deadline(device, {**PAPER, "strategy": "random",
                                  "systems": _mobile_mix(None, 1.0)}, train, test)
    scenarios = _async_scenarios(deadline)
    print(f"async: deadline {deadline:.3f} simulated s; cells {[s[0] for s in scenarios]}; "
          f"async discount (1 + s)^-0.5, concurrency {ASYNC_MODE['concurrency']}", flush=True)
    k1, keep = 0, {}
    for strategy in ASYNC_STRATEGIES:
        kw = {"strategy_kwargs": {"J": 3}} if strategy == "fedlecc" else {}
        recs = {}
        for name, systems, async_mode, rounds in scenarios:
            cfg = FLConfig(**{**PAPER, "rounds": rounds}, strategy=strategy, systems=systems,
                           async_mode=async_mode, **kw)
            rec, engine, results = _async_run(device, f"{strategy} {name}", cfg, train, test)
            k1 += rec["k1_launches"]
            recs[name] = rec
            if strategy == "fedlecc" and name in ("async_k5", scenarios[1][0]):
                keep[name] = (engine, results)
            del engine, results
        target = 0.95 * min(rec["best_acc"] for rec in recs.values())
        summary = {name: _time_to(rec, target) for name, rec in recs.items()}
        print(f"async {strategy} to {target:.4f} (95 % of the lowest best accuracy): "
              f"{json.dumps(summary)}", flush=True)
    fedlecc = dict(PAPER, strategy="fedlecc", strategy_kwargs={"J": 3})
    rec, engine, results = _async_run(
        device, "fedlecc async_k5 compiled",
        FLConfig(**{**fedlecc, "rounds": 2 * PAPER["rounds"]}, backend="compiled",
                 systems=_mobile_mix(None, 1.0), async_mode=ASYNC_K5), train, test)
    k1 += rec["k1_launches"]
    _same_run("fedlecc async_k5 host vs compiled", keep["async_k5"], (engine, results),
              PARITY_ATOL, "async", ASYNC_FIELDS)
    del engine, results, keep["async_k5"]
    rec, engine, results = _async_run(
        device, "fedlecc dispatch=sync", FLConfig(**fedlecc, systems=scenarios[1][1],
                                                  async_mode={"dispatch": "sync"}), train, test)
    k1 += rec["k1_launches"]
    lock, lock_results = keep.pop(scenarios[1][0])
    same = (torch.equal(engine.params, lock.params)
            and [(r.selected, r.comm_mb, r.sim_clock, r.n_dropped) for r in results]
            == [(r.selected, r.comm_mb, r.sim_clock, r.n_dropped) for r in lock_results])
    print(f"async: dispatch=\"sync\" against the lock-step engine, {len(results)} rounds, the "
          f"same bits: {same}", flush=True)
    if not same:
        raise AssertionError("dispatch='sync' differs from the lock-step engine")
    del engine, results, lock, lock_results
    rec, engine, results = _async_run(
        device, "fedlecc async_k5 sign_flip 0.2 validate",
        FLConfig(**{**fedlecc, "rounds": 2 * PAPER["rounds"]}, systems=_mobile_mix(None, 1.0),
                 async_mode=ASYNC_K5,
                 faults={"rate": 0.2, "models": ["sign_flip"], "defense": "validate"}),
        train, test)
    k1 += rec["k1_launches"]
    if rec["total_faulty"] == 0:
        raise AssertionError("async_k5 at sign_flip 20 %: no faulty upload arrived")
    del engine, results
    torch.cuda.empty_cache()
    print(f"async: phase in {time.perf_counter() - t:.1f} s", flush=True)
    return k1


CKPT_ROUNDS = 40


def _replayed(engine) -> int:
    """K1 launches made by a fused engine's graph replays (0 otherwise)."""
    return engine.replayed_launches() if hasattr(engine, "replayed_launches") else 0
CKPT_BACKENDS = {"host": {}, "compiled": {"backend": "compiled"},
                 "fused": {"backend": "compiled", "fuse_rounds": 2}}


def _checkpoint_phase(device):
    """benchmarks/bench_checkpoint.py's rows at the paper's configuration
    (fedlecc J = 3, 40 rounds, a save every round, the last 3 kept, a JSONL
    tracker) on host, compiled and fused chunks of 2: bare and checkpointed
    s a round, one save, one restore, the file's MB, and a kill at round 20
    resumed to the uninterrupted run's bits; a fused engine that captured its
    graphs restores an older checkpoint and reruns to the same bits; then an
    async_k5 run killed mid-buffer on host and on compiled, resumed to the
    same bits.  Files go under build/ and are removed; returns K1's
    launches over the phase."""
    import shutil

    import torch

    from repro_torch.checkpoint import Checkpointer, CheckpointPolicy, JsonlTracker, read_jsonl
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum

    train, test = _paper_data()
    work = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    masked_weighted_sum.launches = 0
    replayed = 0
    base = dict(PAPER, strategy="fedlecc", strategy_kwargs={"J": 3}, rounds=CKPT_ROUNDS,
                eval_every=2)
    policy = CheckpointPolicy(every_rounds=1, keep_last=3)
    half = CKPT_ROUNDS // 2

    def mk(cfg, **kw):
        return make_engine(cfg, train, test, n_classes=10, device=device, **kw)

    def run(engine, n=None):
        t = time.perf_counter()
        out = list(engine.rounds(n))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for name, kw in CKPT_BACKENDS.items():
        cfg = FLConfig(**base, **kw)
        ckdir = work / name
        bare = mk(cfg)
        _, bare_s = run(bare)
        replayed += _replayed(bare)
        del bare
        tracked = mk(cfg, checkpointer=Checkpointer(str(ckdir / "full"), policy),
                     tracker=JsonlTracker(str(ckdir / "full.jsonl")))
        full, ckpt_s = run(tracked)
        tracked.close_trackers()
        ckpt_mb = Path(tracked.checkpointer.latest()).stat().st_size / 1e6
        t = time.perf_counter()
        tracked.save(str(ckdir / "probe.ckpt"))
        save_s = time.perf_counter() - t
        # the kill: half the run, abandoned after its save
        killed = mk(cfg, checkpointer=Checkpointer(str(ckdir / "run"), policy),
                    tracker=JsonlTracker(str(ckdir / "run.jsonl")))
        it = killed.rounds()
        pre = [next(it) for _ in range(half)]
        it.close()
        killed.close_trackers()
        mid, older = str(ckdir / "mid.ckpt"), str(ckdir / "older.ckpt")
        shutil.copy(killed.checkpointer.latest(), mid)  # the next round is ``half``
        shutil.copy(ckdir / "run" / f"round_{half - 2:08d}.ckpt", older)
        t = time.perf_counter()
        resumed = mk(cfg, resume=str(ckdir / "run"),
                     checkpointer=Checkpointer(str(ckdir / "run"), policy),
                     tracker=JsonlTracker(str(ckdir / "run.jsonl")))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        t = time.perf_counter()
        resumed.restore(mid)  # the same state again: the restore alone, timed
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        post, _ = run(resumed)
        resumed.close_trackers()
        rows = read_jsonl(str(ckdir / "run.jsonl"))
        delta = float((resumed.params - tracked.params).abs().max())
        same = [r.selected for r in pre + post] == [r.selected for r in full]
        # an engine that ran ``half`` rounds (and, fused, captured its graphs)
        # restores an older checkpoint and runs on to the same bits
        killed.checkpointer = Checkpointer(str(ckdir / "again"), policy)
        killed.trackers = []
        killed.restore(older)
        again, _ = run(killed)
        again_same = (torch.equal(killed.params, tracked.params)
                      and [r.selected for r in again] == [r.selected for r in full[half - 2:]])
        replayed += sum(_replayed(e) for e in (tracked, resumed, killed))
        rec = {"backend": name, "rounds": CKPT_ROUNDS,
               "bare_s_per_round": bare_s / CKPT_ROUNDS,
               "ckpt_s_per_round": ckpt_s / CKPT_ROUNDS,
               "overhead_pct": 100.0 * (ckpt_s - bare_s) / bare_s, "save_s": save_s,
               "restore_s": restore_s, "resume_s (build + restore)": resume_s,
               "ckpt_mb": ckpt_mb, "resume_round": len(pre),
               "resume_params_max_abs_delta": delta, "resume_selections_identical": same,
               "jsonl_rows": len(rows), "restore_after_capture_identical": again_same}
        print(f"checkpoint: {json.dumps(rec)}", flush=True)
        if not (delta == 0.0 and same and again_same and len(rows) == CKPT_ROUNDS):
            raise AssertionError(f"checkpoint {name}: the resumed run is not the uninterrupted "
                                 f"one ({rec})")
        for e in (tracked, resumed, killed):
            if hasattr(e, "close"):
                e.close()
        del tracked, resumed, killed, it
    k1 = masked_weighted_sum.launches + replayed
    masked_weighted_sum.launches = 0
    fedlecc = dict(PAPER, strategy="fedlecc", strategy_kwargs={"J": 3}, rounds=20,
                   systems=_mobile_mix(None, 1.0), async_mode=ASYNC_K5)
    for backend in ("host", "compiled"):
        cfg = FLConfig(**fedlecc, backend=backend)
        ref = mk(cfg)
        ref_results = list(ref.rounds())
        killed = mk(cfg)
        it = killed.rounds()
        pre = [next(it) for _ in range(10)]
        it.close()
        path = str(work / f"async_{backend}.ckpt")
        t = time.perf_counter()
        killed.save(path)
        save_s = time.perf_counter() - t
        resumed = mk(cfg)
        t = time.perf_counter()
        resumed.restore(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        post = list(resumed.rounds())
        same = ([tuple(getattr(r, f) for f in ASYNC_FIELDS + ("sim_clock", "comm_mb"))
                 for r in pre + post]
                == [tuple(getattr(r, f) for f in ASYNC_FIELDS + ("sim_clock", "comm_mb"))
                    for r in ref_results])
        delta = float((resumed.params - ref.params).abs().max())
        rec = {"backend": backend, "async": "async_k5", "steps": 20, "killed_at": 10,
               "in_flight_at_kill": killed._n_inflight(), "groups_at_kill": len(killed._ledger),
               "save_s": save_s, "restore_s": restore_s,
               "ckpt_mb": Path(path).stat().st_size / 1e6, "steps_identical": same,
               "params_max_abs_delta": delta}
        print(f"checkpoint: {json.dumps(rec)}", flush=True)
        if not (killed._n_inflight() > 0 and same and delta == 0.0):
            raise AssertionError(f"checkpoint async {backend}: the resumed run is not the "
                                 f"uninterrupted one ({rec})")
        del ref, killed, resumed, it
    k1 += masked_weighted_sum.launches
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    print(f"checkpoint: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1


# benchmarks/bench_population.py's geometry: shards of 256 clients (the
# training rows: 64), 4 resident a round, J = 3 at the shard level, m = 32
POP_SHARD_SIZE, POP_RESIDENT, POP_J, POP_M = 256, 4, 3, 32
POP_TRAIN_ROUNDS, POP_SELECT_ROUNDS = 30, 40
POP_SELECT_KS = (1_000, 10_000, 100_000, 1_000_000)


def _pop_cfg(k, population, **kw):
    """bench_population.py's ``training_row`` config at K = ``k``."""
    from repro_torch.engine import FLConfig

    return FLConfig(n_clients=k, m=POP_M, rounds=POP_TRAIN_ROUNDS, seed=0, strategy="fedlecc",
                    strategy_kwargs={"J": 5}, hidden=(64,), eval_samples=16,
                    eval_every=max(POP_TRAIN_ROUNDS // 4, 1), target_hd=0.8, batch_size=16,
                    local_epochs=2, lr=0.05, population=population, **kw)


def _pop_training_run(device, tag, cfg, train, test):
    """``cfg`` through ``make_engine(...).rounds()`` from an emptied allocator
    with its peak reset, K1 and K2 counted from 0 over it and each round
    timed; counts the dispatched clients outside the round's resident
    shards (Algorithm 1 takes a top cluster's ``-inf`` members when it has
    fewer than ``ceil(m / J)`` resident ones, as the reference does); checks
    K1 once a round, K2 at setup and finite parameters; returns (record,
    engine, results)."""
    import torch

    from repro_torch.engine import make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hellinger_strip.launches = masked_weighted_sum.launches = 0
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=10, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    results, walls, outside = [], [], 0
    it = engine.rounds()
    for _ in range(cfg.rounds):
        t = time.perf_counter()
        results.append(next(it))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        if engine._pop_members is not None:
            outside += len(set(results[-1].selected) - set(engine._pop_members.tolist()))
    evaluated = [r for r in results if r.evaluated]
    rec = {"tag": tag, "backend": cfg.backend, "setup_s": setup_s,
           "median_round_ms": statistics.median(walls), "final_acc": evaluated[-1].test_acc,
           "best_acc": max(r.test_acc for r in evaluated), "comm_mb": results[-1].comm_mb,
           "k1_launches": _k1_launches(engine), "k2_launches": hellinger_strip.launches,
           "allocated_before_mib": base / 2**20,
           "max_allocated_mib": torch.cuda.max_memory_allocated() / 2**20}
    store = engine._store
    if store is not None:  # one client's packed rows: features, labels, mask
        rb = sum(a[:1].nbytes for a in (store._xs, store._ys, store._mask))
        resident = len(engine._pop_members)
        rec |= {"resident_clients": resident, "row_bytes": rb,
                "gather_mb_per_round": (resident + POP_M) * rb / 2**20,
                "flat_stack_mb": cfg.n_clients * rb / 2**20,
                "shard_clusters": engine._population.n_shard_clusters,
                "dispatched_outside_residents": outside}
    print(f"population: training K={cfg.n_clients} {json.dumps(rec)}", flush=True)
    if rec["k1_launches"] != cfg.rounds or rec["k2_launches"] < 1:
        raise AssertionError(f"{tag}: K1/K2 launched {rec['k1_launches']}/{rec['k2_launches']}")
    for r in results:
        sel = list(r.selected)
        if len(sel) != POP_M or sorted(set(sel)) != sel or not math.isfinite(r.comm_mb):
            raise AssertionError(f"{tag} round {r.round}: bad selection {sel}")
    if not (engine.params.is_cuda and torch.isfinite(engine.params).all()
            and all(0.0 <= r.test_acc <= 1.0 for r in evaluated)):
        raise AssertionError(f"{tag}: final parameters not finite or accuracy out of range")
    return rec, engine, results


def _pop_training(device, k):
    """bench_population.py's ``training_row`` at K = ``k``: flat against
    population (``k // 64`` shards, 4 resident), fedlecc J = 5, 30 rounds,
    each with its peak device memory; at K = 10^3 also the population run on
    the compiled backend, which must keep the host's selections and end
    within ``PARITY_ATOL``.  Returns (K1, K2) launches."""
    from repro_torch.data import make_classification

    n_shards = max(8, k // 64)
    t = time.perf_counter()
    train = make_classification(32 * k, n_features=64, n_classes=10, seed=0)
    test = make_classification(1_000, n_features=64, n_classes=10, seed=1)
    print(f"population: K={k} data {time.perf_counter() - t:.3f} s  train {train.x.shape}",
          flush=True)
    population = {"n_shards": n_shards, "shards_per_round": min(POP_RESIDENT, n_shards),
                  "j_shards": POP_J}
    k1 = k2 = 0
    recs, runs = {}, {}
    for tag, pop, kw in (("flat", None, {}), ("population", population, {}),
                         ("population compiled", population, {"backend": "compiled"})):
        if kw and k != 1_000:
            continue
        rec, engine, results = _pop_training_run(device, tag, _pop_cfg(k, pop, **kw), train,
                                                 test)
        recs[tag] = rec
        k1, k2 = k1 + rec["k1_launches"], k2 + rec["k2_launches"]
        if pop is None:
            flat_stack_mb = (engine.xs.nbytes + engine.ys.nbytes) / 2**20
        else:
            runs[tag] = (engine, results)
        del engine, results
    if "population compiled" in runs:
        _same_run(f"K={k} population host vs compiled", runs["population"],
                  runs["population compiled"], PARITY_ATOL, "population")
    summary = {"K": k, "n_shards": n_shards,
               "acc_gap": abs(recs["flat"]["final_acc"] - recs["population"]["final_acc"]),
               "flat_device_stack_mb": flat_stack_mb,
               "max_allocated_mib": {t: r["max_allocated_mib"] for t, r in recs.items()}}
    print(f"population: training K={k} summary {json.dumps(summary)}", flush=True)
    return k1, k2


def _pop_one_shard(device):
    """One shard against the flat engine on the paper's configuration (K =
    100, m = 10, 150 rounds): fedlecc, random and lossonly on host and
    compiled must select the same clients and reach the same parameter bits.
    Returns (K1, K2) launches."""
    import torch

    from repro_torch.engine import FLConfig
    from repro_torch.kernels.hellinger import hellinger_strip

    train, test = _paper_data()
    k1 = k2 = 0
    for strategy, skw in (("fedlecc", {"J": 3}), ("random", {}), ("lossonly", {})):
        for backend in ("host", "compiled"):
            runs = {}
            for tag, pop in (("flat", None), ("one shard", {"n_shards": 1})):
                cfg = FLConfig(**PAPER, strategy=strategy, strategy_kwargs=skw,
                               backend=backend, population=pop)
                engine, results, _, _, median_ms = _timed_run(device, cfg, train, test)
                k1 += _k1_launches(engine)
                k2 += hellinger_strip.launches
                runs[tag] = (engine, results, median_ms)
            (ea, ra, ma), (eb, rb, mb) = runs["flat"], runs["one shard"]
            same = [r.selected for r in ra] == [r.selected for r in rb]
            bits = torch.equal(ea.params, eb.params)
            print(f"population one shard vs flat {strategy} {backend}: {len(ra)} rounds, same "
                  f"selections every round: {same}, same parameter bits: {bits}, median round "
                  f"{ma:.3f} ms flat, {mb:.3f} ms one shard, final acc {ra[-1].test_acc}",
                  flush=True)
            if not (same and bits and [r.comm_mb for r in ra] == [r.comm_mb for r in rb]):
                raise AssertionError(f"one shard differs from flat: {strategy} {backend}")
            del runs, ea, eb
    return k1, k2


def _pop_selection_row(device, k):
    """bench_population.py's ``selection_row`` at K = ``k``: a
    ``ShardedStore`` of 256-client shards (summaries only), the hierarchy
    (OPTICS up to 2048 shards, k-medoids beyond: K2 on the card), then 40
    rounds of the selection loop with simulated member losses.  No shard
    may materialize.  Returns the record."""
    import numpy as np
    import torch

    from repro_torch.kernels.hellinger import hellinger_strip
    from repro_torch.population import (
        HierarchicalSelector,
        PopulationConfig,
        ShardedStore,
        SyntheticShardLoader,
    )

    n_shards = max(POP_RESIDENT, k // POP_SHARD_SIZE)
    n_feat, n_max = 64, 16
    t = time.perf_counter()
    store = ShardedStore(SyntheticShardLoader(seed=0, n_features=n_feat, n_classes=10,
                                              samples=(8, n_max)),
                         n_clients=k, n_shards=n_shards, device=device)
    t_store = time.perf_counter() - t
    cfg = PopulationConfig(n_shards=n_shards, shards_per_round=min(POP_RESIDENT, n_shards),
                           j_shards=POP_J)
    hellinger_strip.launches = 0
    t = time.perf_counter()
    sel = HierarchicalSelector(cfg, store, seed=0, needs_losses=True)
    torch.cuda.synchronize()
    t_selector = time.perf_counter() - t
    k2 = hellinger_strip.launches
    rng = np.random.default_rng(0)
    times, resident = [], 0
    for rnd in range(POP_SELECT_ROUNDS):
        t = time.perf_counter()
        _, members = sel.begin_round(rnd)
        member_losses = rng.random(len(members)).astype(np.float32)
        losses = np.full(k, -np.inf, np.float32)
        losses[members] = member_losses
        sel.observe(losses)
        cohort = sel.select_cohort(member_losses, m=POP_M)
        times.append((time.perf_counter() - t) * 1e3)
        resident = len(members)
        if len(cohort) != min(POP_M, resident):
            raise AssertionError(f"K={k} round {rnd}: cohort of {len(cohort)}")
    rb = n_max * (n_feat * 4 + 4 + 4)
    rec = {"K": k, "n_shards": n_shards, "resident_clients": resident,
           "cluster_algo": "optics" if n_shards <= 2048 else "kmedoids",
           "shard_clusters": sel.n_shard_clusters, "t_store_build_s": t_store,
           "t_selector_build_s": t_selector, "round_select_ms_mean": statistics.mean(times),
           "round_select_ms_median": statistics.median(times), "k2_launches": k2,
           "gather_mb_per_round": (resident + POP_M) * rb / 2**20,
           "flat_stack_mb": k * rb / 2**20, "dense_hd_matrix_mb": k * k * 4 / 2**20,
           "materialized_shards": len(store.materialized_shards()),
           "explored_shards": int(np.isfinite(sel.estimates).sum())}
    print(f"population: selection {json.dumps(rec)}", flush=True)
    if rec["materialized_shards"] != 0 or (n_shards > 1 and k2 == 0):
        raise AssertionError(f"K={k}: {rec['materialized_shards']} shards materialized, "
                             f"K2 launched {k2} times")
    return rec


def _pop_blocked_build(device, k=10_000, repeats=3):
    """``hellinger_blocked`` at K = ``k`` (three 4096-row strips): its wall
    time with the double-buffered pinned copy against the single pageable
    copy a strip it replaced (the same strips, copied straight into the
    host matrix), and the strips' kernel time alone (CUDA events); the two
    must give the same bits."""
    import numpy as np
    import torch

    from repro_torch.core.hellinger import _sqrt_rows, hellinger_blocked
    from repro_torch.kernels.hellinger import hellinger_strip

    h = np.random.default_rng(k).dirichlet(np.ones(10) * 0.5, size=k)
    block = 4096
    r = torch.from_numpy(_sqrt_rows(h)).to(device)
    strips = [(i0, min(i0 + block, k)) for i0 in range(0, k, block)]

    def pageable():
        out = np.empty((k, k), np.float32)
        host = torch.from_numpy(out)
        for i0, i1 in strips:
            host[i0:i1].copy_(hellinger_strip(r[i0:i1], r))
        np.fill_diagonal(out, 0.0)
        return out

    def wall(fn):
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), out

    pinned = lambda: hellinger_blocked(h, block=block, device=device)  # noqa: E731
    wall(pinned)  # the pinned buffers' first allocation
    before_ms, want = wall(pageable)
    after_ms, got = wall(pinned)
    before2_ms, _ = wall(pageable)
    after2_ms, _ = wall(pinned)
    kernel_ms = _median_ms(lambda: [hellinger_strip(r[i0:i1], r) for i0, i1 in strips],
                           calls=repeats, warmup=1)
    same = bool(np.array_equal(got, want))
    rec = {"K": k, "block": block, "strips": len(strips),
           "pageable_wall_ms": [before_ms, before2_ms], "pinned_wall_ms": [after_ms, after2_ms],
           "k2_ms": kernel_ms, "pageable_copy_ms": before_ms - kernel_ms,
           "pinned_copy_ms": after_ms - kernel_ms, "same_bits": same}
    print(f"population: blocked build {json.dumps(rec)}", flush=True)
    if not same:
        raise AssertionError("the pinned blocked build differs from the pageable one")


def _population_phase(device):
    """benchmarks/bench_population.py's rows through the port on the card:
    the training rows at K = 10^3 and 10^4 (flat against population, with
    host against compiled at 10^3), one shard against flat on the paper's
    configuration, the selection-only rows at K = 10^3 to 10^6 and the
    blocked build's copy at K = 10^4.  Returns K1's and K2's launches over
    the phase's engine runs and selector builds."""
    t = time.perf_counter()
    k1 = k2 = 0
    for k in (1_000, 10_000):
        a, b = _pop_training(device, k)
        k1, k2 = k1 + a, k2 + b
    a, b = _pop_one_shard(device)
    k1, k2 = k1 + a, k2 + b
    rows = [_pop_selection_row(device, k) for k in POP_SELECT_KS]
    k2 += sum(r["k2_launches"] for r in rows)
    if rows[-1]["cluster_algo"] != "kmedoids":
        raise AssertionError("K = 10^6 should cluster its shards with k-medoids")
    _pop_blocked_build(device)
    launches = {"hellinger_strip": k2, "masked_weighted_sum": k1}
    print(f"population: launches {json.dumps(launches)}; phase in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return launches


def _async_agreement(device):
    """An async micro configuration (12 clients, m = 4, buffer 3, 8 in
    flight, mobile_mix) on the CPU (plain versions) and on the card (K1),
    from the same draws: the same survivors, versions, staleness and drops
    every step, params within 1e-4; on host, compiled, and on host under
    sign_flip and nan_update at 30 % behind the gate."""
    import numpy as np

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine

    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    small = dict(n_clients=12, m=4, rounds=8, hidden=(16,), eval_samples=16, eval_every=2,
                 target_hd=0.8, seed=0, strategy_kwargs={"J": 3},
                 systems=dict(_mobile_mix(None, 1.0), jitter_sigma=0.1),
                 async_mode={"buffer_k": 3, "concurrency": 8, "staleness": "polynomial"})
    faults = {"rate": 0.3, "models": ["sign_flip", "nan_update"], "defense": "validate"}
    for tag, kw in (("host", {}), ("compiled", {"backend": "compiled"}),
                    ("host faults", {"faults": faults})):
        cfg = FLConfig(**small, **kw)
        on_card = make_engine(cfg, train, test, 10, device=device)
        on_cpu = make_engine(cfg, train, test, 10, device="cpu")
        res_card, res_cpu = list(on_card.rounds()), list(on_cpu.rounds())
        steps = [[tuple(getattr(r, f) for f in ASYNC_FIELDS) for r in res]
                 for res in (res_card, res_cpu)]
        diff = float(np.abs(on_card.params.cpu().numpy() - on_cpu.params.numpy()).max())
        print(f"async agreement {tag}: {len(res_card)} steps, {on_card._dispatches} dispatches "
              f"on the card and {on_cpu._dispatches} on the CPU, the same survivors, versions, "
              f"staleness and drops every step: {steps[0] == steps[1]}, versions "
              f"{[r.params_version for r in res_card]}, max |params diff| {diff:.3g} "
              f"(tolerance 1e-4)", flush=True)
        if steps[0] != steps[1] or on_card._dispatches != on_cpu._dispatches:
            raise AssertionError(f"async {tag}: card and CPU steps differ")
        if not diff <= 1e-4:
            raise AssertionError(f"async {tag}: card and CPU parameters differ by {diff} > 1e-4")


def _gate_kernel_ms(device, m, n_params):
    """The validation gate's time a call at (m, P) fp32: its kernels' device
    time under the profiler and the event-timed call, for the norm pass
    (``update_norms``) and the whole gate (``validate_updates``: norms,
    quantile, clip), with their byte bounds."""
    import torch

    from repro_torch.faults.defense import update_norms, validate_updates

    g = torch.Generator(device=device).manual_seed(m)
    fetched = torch.randn(n_params, generator=g, device=device)
    stacked = fetched + 0.01 * torch.randn(m, n_params, generator=g, device=device)
    valid = torch.ones(m, dtype=torch.bool, device=device)
    norms = lambda: update_norms(stacked, fetched)  # noqa: E731
    gate = lambda: validate_updates(stacked, fetched, valid, q=0.9, tol=3.0)  # noqa: E731
    (norms_ms, norms_n), (gate_ms, gate_n) = (_kernel_ms(norms, ANY_KERNEL, calls=10),
                                              _kernel_ms(gate, ANY_KERNEL, calls=10))
    norms_event_ms, gate_event_ms = _median_ms(norms, calls=10), _median_ms(gate, calls=10)
    del stacked, fetched
    torch.cuda.empty_cache()
    norm_bytes = 4 * (m + 1) * n_params           # the cohort and the fetched params, read
    rec = {"shape": [m, n_params], "norms_ms": norms_ms, "clip_ms": gate_ms - norms_ms,
           "gate_ms": gate_ms, "norms_event_ms": norms_event_ms, "gate_event_ms": gate_event_ms,
           "norms_recorded": norms_n, "gate_recorded": gate_n,
           "norms_bound_ms": _bound(norm_bytes, 3 * m * n_params)[0],
           "clip_bound_ms": _bound(4 * (2 * m + 1) * n_params, 3 * m * n_params)[0]}
    print(f"xlstm systems+faults gate: {json.dumps(rec)}", flush=True)
    return rec


def _agreement(device):
    """Small configurations, FedLECC (J = 3) and every classification preset:
    CPU (plain versions) vs card (kernels), same draws."""
    import numpy as np

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, get_preset, make_engine

    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    small = dict(n_clients=12, m=4, rounds=3, hidden=(16,), eval_samples=16, eval_every=1,
                 target_hd=0.8, seed=0)
    cfgs = {"fedlecc J=3": FLConfig(strategy_kwargs={"J": 3}, **small)}
    cfgs |= {name: get_preset(name).make_config(**small) for name in PRESETS}
    # fused chunks of 3: round 0, then rounds 1-3 eager and captured, 4-6 replayed, 7
    cfgs["fedlecc J=3 fused"] = FLConfig(strategy_kwargs={"J": 3}, backend="compiled",
                                         fuse_rounds=3, **(small | {"rounds": 8, "eval_every": 3}))
    for tag, cfg in cfgs.items():
        on_card = make_engine(cfg, train, test, 10, device=device)
        on_cpu = make_engine(cfg, train, test, 10, device="cpu")
        sel_card = [r.selected for r in on_card.rounds()]
        sel_cpu = [r.selected for r in on_cpu.rounds()]
        diff = float(np.abs(on_card.params.cpu().numpy() - on_cpu.params.numpy()).max())
        print(f"agreement {tag}: selected card={sel_card} cpu={sel_cpu} max |params diff|="
              f"{diff:.3g} (tolerance 1e-4)", flush=True)
        labels = [getattr(e.strategy, "labels", None) for e in (on_card, on_cpu)]
        if sel_card != sel_cpu or not np.array_equal(*labels):
            raise AssertionError(f"{tag}: card and CPU runs selected different clients")
        if not diff <= 1e-4:
            raise AssertionError(f"{tag}: card and CPU parameters differ by {diff} > 1e-4")


LM_MICRO = {"model": "stablelm-3b", "hist_bins": 16,
            "overrides": {"d_model": 32, "n_heads": 2, "n_kv_heads": 2, "head_dim": 16,
                          "d_ff": 64, "vocab": 32, "loss_chunk": 16, "attn_chunk": 16,
                          "remat": False}}
# hymba at micro width; its pattern "GL" makes layer 1 windowed at S = 16
HYMBA_MICRO = {"model": "hymba-1.5b", "hist_bins": 16,
               "overrides": {"d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                             "d_ff": 64, "vocab": 32, "loss_chunk": 16, "attn_chunk": 16,
                             "remat": False, "sliding_window": 8}}

# xlstm at micro width, 4 layers ("MMMS": three mLSTM and one sLSTM); over
# 128-token sequences the reduced config's chunk of 64 gives two chunks
XLSTM_MICRO = {"model": "xlstm-125m", "hist_bins": 16,
               "overrides": {"n_layers": 4, "d_model": 32, "vocab": 32, "loss_chunk": 16}}
# the systems and fault axes of the xlstm leg: mobile_mix devices, a deadline
# at the profile's 60th percentile round time, over-selection 1.3 (m_eff =
# 13); sign_flip and nan_update at 20 % behind the validation gate (not
# stale_replay: its cache would hold 100 x P fp32, 48 GB)
XLSTM_FAULTS = {"rate": 0.2, "models": ["sign_flip", "nan_update"], "defense": "validate"}
# the same axes at the agreement's micro size (8 clients, m = 3, m_eff = 4)
XLSTM_MICRO_AXES = {"systems": _mobile_mix(None, 1.3), "faults": {**XLSTM_FAULTS, "rate": 0.5}}


def _xlstm_async(device, cfg_kwargs, train, test, vocab):
    """async_k5 of the ``async:`` phase under mobile_mix, 4 steps, with no
    fault axis: each step pops 5 arrivals and dispatches cohorts of up to 10
    while 20 fit in flight.  Under the step-1 params, one client's first
    batch drives layer 0's mLSTM running max m to -407: exp(-m) overflows
    there, where the reference's gradient (and the port's before
    ``repro_torch.models.ssm._exp_floor``) is NaN and makes the params NaN
    (``scripts/mlstm_overflow.py`` reads both from that client's layer-0
    input).  The run's parameters must stay finite."""
    return {"systems": _mobile_mix(None, 1.0), "async_mode": ASYNC_K5, "rounds": 4}


def _xlstm_axes(device, cfg_kwargs, train, test, vocab):
    systems = _mobile_mix(None, 1.3)
    systems["deadline_s"] = _deadline(device, {**cfg_kwargs, "systems": systems}, train, test,
                                      n_classes=vocab)
    return {"systems": systems, "faults": XLSTM_FAULTS}


# the three dense configs, reduced (2 layers, d_model 256), over the 32-token
# vocabulary of the agreement's streams; gemma3's window bites at S = 16
DENSE_REDUCED = {
    "glm4": {"model": "glm4-9b", "hist_bins": 16, "overrides": {"vocab": 32}},
    "qwen3": {"model": "qwen3-14b", "hist_bins": 16, "overrides": {"vocab": 32}},
    "gemma3": {"model": "gemma3-27b", "hist_bins": 16,
               "overrides": {"vocab": 32, "sliding_window": 8}},
}


def _profiled(on: bool):
    """``torch.profiler`` over CPU and CUDA activity when ``on``."""
    import contextlib

    import torch

    if not on:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _print_profile(prof, wall_s: float, tag: str, families, host_top: bool = False) -> None:
    """Device time of one profiled round by kernel: the busy and idle shares
    of the round's wall time, each kernel family's share, the top kernels
    (and with ``host_top`` the top host operations by their own CPU time).
    Fails if a family's kernels launched but the profile holds none of them."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0:
        print(f"{tag} profile: the profiler recorded no device time", flush=True)
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    summary = {"wall_ms": wall_s * 1e3, "device_busy_ms": total_us / 1e3,
               "device_idle_share": max(0.0, 1 - total_us / 1e3 / (wall_s * 1e3))}
    for fwd, _, names in families:
        fam_us = sum(e.self_device_time_total for e in events if names.search(e.key))
        if fam_us <= 0:
            raise AssertionError(f"{tag} profile: no kernel matches {names.pattern}")
        fam = fwd.__name__.removesuffix("_forward")
        summary[f"{fam}_kernels_ms"] = fam_us / 1e3
        summary[f"{fam}_share_of_busy"] = fam_us / total_us
    summary["top"] = [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                       "calls": e.count} for e in top]
    if host_top:
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
        summary["host_top"] = [{"op": e.key[:60], "ms": e.self_cpu_time_total / 1e3,
                                "calls": e.count} for e in host]
    print(f"{tag} profile: {json.dumps(summary)}", flush=True)


def _lm_main_path(device, tag, model, n_layers, n_params, families, axes=None,
                  save_probe=False, keep=None):
    """Federated LM training on ``model`` at full width, cut to ``n_layers``,
    3 rounds (the last under the profiler); returns the kernels' launch
    counts from this run.  ``families`` holds one (forward wrapper, backward
    wrapper, profile-name regex) for each kernel that the model runs in
    every layer: each launches forward layers x rounds x (poll + steps + 2
    evaluations) times and backward layers x rounds x steps times.
    ``axes(device, cfg_kwargs, train, test, vocab)`` gives ``FLConfig`` fields
    of the run (the systems and fault axes, the async runtime and its step
    count, the compiled backend and its fused chunks).  A fused run counts
    a kernel's launches as its eager ones plus, for each chunk length, those
    recorded at the capture times the graph's replays (``_FusedProbe``).
    With ``save_probe`` one save and one restore of the engine are timed
    after the last round (files under build/, removed).  ``keep`` (a dict)
    receives the rounds' results and the final params (on the host)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    counters = [hellinger_strip, masked_weighted_sum] + [w for fam in families for w in fam[:2]]
    full = get_config(model)
    vocab, seq = full.vocab, 64
    t = time.perf_counter()
    train = make_token_stream(2400, seq, vocab, seed=0)
    test = make_token_stream(64, seq, vocab, seed=1)
    print(f"{tag}: data {time.perf_counter() - t:.3f} s  train {train.x.shape} "
          f"test {test.x.shape} vocab {vocab}", flush=True)
    cfg_kwargs = dict(task="lm", task_kwargs={"model": model, "reduced": False,
                                              "overrides": {"n_layers": n_layers},
                                              "hist_bins": 64},
                      n_clients=100, m=10, strategy="fedlecc", strategy_kwargs={"J": 3},
                      batch_size=8, eval_samples=4, eval_every=1, target_hd=0.9, rounds=3,
                      seed=0)
    if axes is not None:
        extra = axes(device, cfg_kwargs, train, test, vocab)
        cfg_kwargs |= extra
        print(f"{tag}: {', '.join(f'{k} {v}' for k, v in extra.items())}", flush=True)
    cfg = FLConfig(**cfg_kwargs)
    if full.block_type == "xlstm":
        width = (f"d_model {full.d_model}, {full.ssm.n_heads} heads of "
                 f"{full.d_model // full.ssm.n_heads}, pattern {full.layer_pattern} (mLSTM x 3, "
                 f"sLSTM), chunk {full.ssm.chunk}, no MLP, vocab {vocab}")
    else:
        mamba = (f", Mamba heads with N {full.ssm.d_state} and conv {full.ssm.conv_kernel}"
                 if full.block_type == "hymba" else "")
        width = (f"d_model {full.d_model}, {full.n_heads} query heads of "
                 f"{full.resolved_head_dim} on {full.n_kv_heads} kv heads, {full.mlp_activation} "
                 f"d_ff {full.d_ff}{mamba}, vocab {vocab}")
    window = (f"; at S = {seq} the {full.sliding_window}-token window never bites (the kernel "
              "phase runs it at S = 2048)" if full.sliding_window >= seq else "")
    cut = ("no cut: full depth" if n_layers == full.n_layers else
           f"cut: n_layers {full.n_layers} -> {n_layers}, which one card's memory forces for "
           f"the (10, P) cohort and its gradient")
    print(f"{tag}: {model} at full width ({width}); {cut}{window}", flush=True)

    for c in counters:
        c.launches = c.captured = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=vocab, device=device)
    torch.cuda.synchronize()
    probe = _FusedProbe(engine, counters) if cfg.fuse_rounds else None
    mc = engine.task.model_cfg
    print(f"{tag}: engine setup {time.perf_counter() - t:.3f} s  shards/client={engine.alpha:g}  "
          f"OPTICS clusters={engine.strategy.n_clusters}  P={engine.n_params}  "
          f"max_steps={engine.max_steps}  peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    results = []
    it = engine.rounds()
    for rnd in range(cfg.rounds):
        torch.cuda.reset_peak_memory_stats()
        last = rnd == cfg.rounds - 1
        with _profiled(last) as prof:
            t = time.perf_counter()
            r = next(it)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        results.append(r)
        extra = (f" dropped={r.n_dropped} faulty={r.n_faulty} quarantined={r.n_quarantined} "
                 f"sim_time={r.sim_time:.3f} s" if axes is not None else "")
        if cfg.async_mode is not None:
            extra += (f" staleness={r.staleness:.3f} version={r.params_version} "
                      f"in_flight={engine._n_inflight()} ledger_rows="
                      f"{sum(g.stacked.shape[0] for g in engine._ledger)}")
        print(f"{tag}: round {r.round} selected={list(r.selected)} test_loss={r.test_loss:.4f} "
              f"next_token_acc={r.test_acc:.4f} ppl={r.metrics['ppl']:.2f} "
              f"train_loss={r.mean_selected_loss:.4f} comm={r.comm_mb:.1f} MB{extra} "
              f"wall={wall:.3f} s{' (under the profiler)' if last else ''} "
              f"peak={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if last:
            _print_profile(prof, wall, tag, families)
    launches = {c.__name__: c.launches for c in counters}
    if probe is not None:
        launches = probe.report(tag, launches)
    print(f"{tag}: launches {json.dumps(launches)}", flush=True)

    want = (mc.n_layers * cfg.rounds * (1 + engine.max_steps + 2),  # poll, steps, eval x 2
            mc.n_layers * cfg.rounds * engine.max_steps)
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the {tag} path never launched: {launches}")
    if cfg.async_mode is not None and \
            launches["masked_weighted_sum"] != results[-1].params_version:
        raise AssertionError(f"{tag}: K1 launched {launches['masked_weighted_sum']} times for "
                             f"{results[-1].params_version} applied updates")
    for fwd, bwd, _ in families:
        got = (launches[fwd.__name__], launches[bwd.__name__])
        if got != want:
            raise AssertionError(f"{fwd.__name__}/{bwd.__name__} launches {got}; expected "
                                 f"forward {want[0]} (layers x rounds x (poll + steps + 2 "
                                 f"evaluations)) and backward {want[1]} (layers x rounds x steps)")
    if len(results) != cfg.rounds or engine.n_params != n_params or mc.n_layers != n_layers:
        raise AssertionError(f"ran {len(results)} rounds with P={engine.n_params}, "
                             f"{mc.n_layers} layers")
    for r in results:
        sel = list(r.selected)
        if (len(sel) > engine.m_eff or (axes is None and len(sel) != cfg.m)
                or sorted(set(sel)) != sel
                or (sel and not 0 <= sel[0] <= sel[-1] < cfg.n_clients)):
            raise AssertionError(f"round {r.round}: bad selection {sel}")
        ppl = r.metrics["ppl"]
        if not (math.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0 and math.isfinite(ppl)
                and ppl > 1.0 and (math.isfinite(r.mean_selected_loss) or not sel)):
            raise AssertionError(f"round {r.round}: bad metrics {r}")
        if not abs(math.log(ppl) - np.float32(r.test_loss)) < 1e-3:  # ppl = exp(mean NLL)
            raise AssertionError(f"round {r.round}: ppl {ppl} is not exp(test_loss {r.test_loss})")
    finite = bool(torch.isfinite(engine.params).all())
    if axes is not None:
        print(f"{tag}: every param finite after the last round: {finite}", flush=True)
    if not (engine.params.is_cuda and finite):
        raise AssertionError(f"final {tag} parameters are not a finite CUDA tensor")
    if save_probe:
        _save_probe(tag, engine)
    if keep is not None:
        keep |= {"results": results, "params": engine.params.cpu()}
    if cfg.async_mode is not None:
        rows = sum(g.stacked.shape[0] for g in engine._ledger)
        row_mb = 4 * engine.n_params / 1e6
        print(f"{tag}: the async ledger is not saved at this size: its checkpoint would hold "
              f"{rows} in-flight rows of {row_mb:.1f} MB, at least "
              f"{row_mb * (rows + 1) / 1e3:.1f} GB with the params", flush=True)
    if probe is not None:
        probe.close()
        engine.close()
    del engine, it
    torch.cuda.empty_cache()
    return launches


class _FusedProbe:
    """Instruments a fused engine's chunks: ``repro_torch.analysis.
    contracts.ChunkProbe`` (each replay's synchronizing calls, buffers and
    memory) and over it (instance attributes, removed by ``close``) the
    first chunk of each length timed eagerly (on the capture stream,
    synchronized) and as a capture (the rest of ``_capture``: recording and
    instantiating the graph), each counter's launches recorded at each
    capture, each replayed chunk timed, and the graphs' private memory
    pool and the peaks measured after each capture and replay."""

    def __init__(self, engine, counters):
        import torch

        from repro_torch.analysis.contracts import ChunkProbe

        self.engine, self.chunks = engine, ChunkProbe(engine)
        self.first, self.captured, self.pool = {}, {}, {}
        self.replay_ms = []
        # peaks since the round began (_lm_main_path resets them each round)
        self.peaks, self.peaks_allocated = [], []
        body, capture, run_chunk = engine._chunk_body, engine._capture, engine._run_chunk
        eager = []

        def note_peak():
            self.peaks.append(torch.cuda.max_memory_reserved())
            self.peaks_allocated.append(torch.cuda.max_memory_allocated())

        def timed_body(*args):
            t = time.perf_counter()
            out = body(*args)
            if not torch.cuda.is_current_stream_capturing():
                torch.cuda.synchronize()
                eager.append(time.perf_counter() - t)
            return out

        def probe_capture(rnd, length, *args):
            before = {c.__name__: c.captured for c in counters}
            eager.clear()
            t = time.perf_counter()
            out = capture(rnd, length, *args)
            torch.cuda.synchronize()
            total = time.perf_counter() - t
            self.first[length] = {"eager_s": eager[0], "capture_s": total - eager[0]}
            self.captured[length] = {c.__name__: c.captured - before[c.__name__]
                                     for c in counters}
            self.pool[length] = _graph_pool_bytes()
            note_peak()
            return out

        def probe_run_chunk(rnd, length):
            if length not in engine._graphs:
                return run_chunk(rnd, length)
            t = time.perf_counter()
            out = run_chunk(rnd, length)
            torch.cuda.synchronize()
            self.replay_ms.append((time.perf_counter() - t) * 1e3 / length)
            note_peak()
            return out

        engine._chunk_body, engine._capture, engine._run_chunk = (
            timed_body, probe_capture, probe_run_chunk)

    def report(self, tag, eager) -> dict:
        """Prints the chunks' numbers; returns the run's launches: ``eager``
        plus each length's captured launches times its replays.  Fails if a
        replay read the device, moved its graph's buffers or left more than
        its params copy allocated, or if nothing replayed."""
        replays = self.engine.graph_replays
        replayed = {name: sum(self.captured[n][name] * r for n, r in replays.items())
                    for name in eager}
        pool, peak = max(self.pool.values()), max(self.peaks)
        rec = {"first_chunk_s": self.first, "replayed_round_ms": self.replay_ms,
               "median_replayed_round_ms": statistics.median(self.replay_ms or [math.nan]),
               "replay_syncs": [r["syncs"] for r in self.chunks.replays],
               "replays_kept_buffers": all(r["same_buffers"] for r in self.chunks.replays),
               "captured_launches": self.captured, "graph_replays": replays,
               "eager_launches": eager, "replayed_launches": replayed,
               "graph_pool_gib": pool / 2**30, "peak_reserved_gib": peak / 2**30,
               "pool_share_of_peak": pool / peak,
               "peak_allocated_gib": max(self.peaks_allocated) / 2**30}
        print(f"{tag} chunks: {json.dumps(rec)}", flush=True)
        if self.chunks.breaches() or not self.replay_ms:
            raise AssertionError(f"{tag}: no replay, or replays that read the device, moved "
                                 f"their graph's buffers or kept more than their params "
                                 f"copy: {self.chunks.breaches()}")
        if replayed["masked_weighted_sum"] != self.engine.replayed_launches():
            raise AssertionError(f"{tag}: K1 replayed {replayed['masked_weighted_sum']}, the "
                                 f"engine counts {self.engine.replayed_launches()}")
        return {name: eager[name] + replayed[name] for name in eager}

    def close(self) -> None:
        del self.engine._chunk_body
        self.chunks.close()  # the wrappers of _capture and _run_chunk, over its own


def _graph_pool_bytes() -> int:
    """Bytes the caching allocator holds in CUDA graphs' private pools
    (segments outside the default pool (0, 0))."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _save_probe(tag, engine):
    """One timed save and one timed restore of ``engine`` (a file under
    build/, removed); the restored params must be the saved bits."""
    import torch

    path = ROOT / "build" / "chip_smoke_probe.ckpt"
    path.parent.mkdir(parents=True, exist_ok=True)
    before = engine.params.clone()
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.save(str(path))
    save_s = time.perf_counter() - t
    engine.params = torch.zeros_like(before)
    t = time.perf_counter()
    engine.restore(str(path))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    same = torch.equal(engine.params, before)
    mb = path.stat().st_size / 1e6
    path.unlink()
    print(f"{tag} checkpoint: save {save_s:.3f} s, restore {restore_s:.3f} s, {mb:.1f} MB "
          f"(P = {engine.n_params}), restored params the saved bits: {same}", flush=True)
    if not same:
        raise AssertionError(f"{tag}: a restore did not give back the saved params")


def _lm_agreement(device, tag, task_kwargs, seq=16, resync=False, max_steps=3, axes=None):
    """An LM micro configuration on the CPU (plain versions) and on the card
    (kernels) from the same draws, over ``seq``-token sequences.  With
    ``resync`` the card run starts each round from the CPU run's
    parameters, so each round is held to the CPU on the same inputs, and
    the perplexity within 1e-4 relative (for xlstm, whose training moves
    fp32 noise further: ``scripts/xlstm_sensitivity.py``; it also takes one
    local step a round, ``max_steps``, as within a round the second step
    grows the card's difference from the CPU to 3e-5–7e-5); otherwise
    within 1e-4.  ``axes`` adds the systems and fault axes' ``FLConfig``
    fields; the runs then also drop and flag the same clients."""
    import numpy as np

    from repro_torch.data import make_token_stream
    from repro_torch.engine import FLConfig, make_engine

    train = make_token_stream(48, seq, 32, seed=0)
    test = make_token_stream(16, seq, 32, seed=1)
    cfg = FLConfig(task="lm", task_kwargs=task_kwargs, n_clients=8, m=3, rounds=2,
                   strategy_kwargs={"J": 2}, batch_size=4, eval_samples=4, eval_every=1,
                   target_hd=0.8, max_steps_cap=max_steps, seed=0, **(axes or {}))
    on_card = make_engine(cfg, train, test, 32, device=device)
    on_cpu = make_engine(cfg, train, test, 32, device="cpu")
    it_card, it_cpu = on_card.rounds(), on_cpu.rounds()
    res_card, res_cpu, diff = [], [], 0.0
    for _ in range(cfg.rounds):
        if resync:
            on_card.params = on_cpu.params.to(device)
        res_card.append(next(it_card))
        res_cpu.append(next(it_cpu))
        diff = max(diff, float(np.abs(on_card.params.cpu().numpy()
                                      - on_cpu.params.numpy()).max()))
    fields = ("selected", "n_dropped", "n_faulty", "n_quarantined")
    sel_card = [tuple(getattr(r, f) for f in fields) if axes else r.selected for r in res_card]
    sel_cpu = [tuple(getattr(r, f) for f in fields) if axes else r.selected for r in res_cpu]
    ppl_diff = max(abs(a.metrics["ppl"] - b.metrics["ppl"])
                   / (b.metrics["ppl"] if resync else 1.0) for a, b in zip(res_card, res_cpu))
    print(f"{tag} agreement{' (each round from the CPU parameters)' if resync else ''}: "
          f"{on_cpu.task.model_cfg.name} {on_cpu.task.model_cfg.n_layers} layers, S = {seq}, "
          f"selected card={sel_card} cpu={sel_cpu} max |params diff|={diff:.3g} "
          f"max |ppl diff|{' / ppl' if resync else ''}={ppl_diff:.3g} (tolerance 1e-4)",
          flush=True)
    if sel_card != sel_cpu:
        raise AssertionError(f"{tag}: card and CPU runs selected different clients")
    if not (diff <= 1e-4 and ppl_diff <= 1e-4):
        raise AssertionError(f"{tag}: card and CPU differ by {diff} (params), {ppl_diff} (ppl) "
                             "> 1e-4")


# the training launcher at full size in bf16: each model with the kernels it
# runs in every layer, forward and backward
TRAIN_MODELS = {"stablelm-3b": ("flash_attention",),
                "hymba-1.5b": ("flash_attention", "mamba_scan"),
                "xlstm-125m": ()}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 6
# the least traffic of AdamW a parameter and step: the bf16 weight read and
# written (4 B), the bf16 gradient read (2), the fp32 m and v read and
# written (16)
ADAMW_BYTES_PER_PARAM = 22
# a resumed run against an uninterrupted one on the card: the same steps,
# but the embedding's backward may add its rows in another order
TRAIN_RESUME_TOL = 1e-2
# the reduced configs (fp32) on the card against the CPU over 3 launcher
# steps: the loss within 1e-4 relative (K3 as 3xTF32, sums in another
# order); the parameters within 2e-4, since AdamW moves an element by about
# the learning rate either way where its gradient is within rounding of
# zero (3e-5 + 6e-5 in steps 1 and 2 of the warmup; step 0's rate is 0)
TRAIN_REDUCED = ("stablelm-3b", "hymba-1.5b", "xlstm-125m", "dbrx-132b", "deepseek-v3-671b")
TRAIN_AGREE_LOSS_TOL, TRAIN_AGREE_PARAM_TOL = 1e-4, 2e-4


def _train_model(device, model, families):
    """The training launcher's step (``make_train_step`` with
    ``make_optimizer(3e-4, 6)``) on ``model`` at full size in its config's
    dtype (bf16), batch 8 of 128 tokens from ``make_token_stream``, 6 steps:
    prints the parameters, each step's ms beside the least time a step could
    take (6 P tokens at the bf16 rate plus AdamW's bytes at HBM rate), the
    first step's and the median of the other five, tokens/s, peak memory and
    every loss (finite and not constant), and holds K3's and K4's launches
    to layers x steps each way; then one more step (the first batch again)
    under ``torch.profiler``: the device's busy and idle shares, the
    kernels' shares, the top kernels and host operations.  Returns the
    launches of the 6 steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf

    counters = (flash_attention_forward, flash_attention_backward, mamba_scan_forward,
                mamba_scan_backward)
    cfg = get_config(model)
    tag = f"train {model}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    opt = train.make_optimizer(3e-4, TRAIN_STEPS)
    state = opt.init(params)
    step = train.make_train_step(cfg, opt)
    data = make_token_stream(TRAIN_STEPS * TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0)
    tokens = torch.from_numpy(data.x).to(device)
    labels = torch.from_numpy(data.y).to(device)
    for c in counters:
        c.launches = 0
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss, _ = step(params, state, {"tokens": tokens[sl], "labels": labels[sl]})
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: (cfg.n_layers * TRAIN_STEPS
                         if c.__name__.rsplit("_", 1)[0] in families else 0) for c in counters}
    n_tokens = TRAIN_BATCH * TRAIN_SEQ
    bound_ms = (6 * n_params * n_tokens / PEAK_BF16_PER_S
                + ADAMW_BYTES_PER_PARAM * n_params / PEAK_BYTES_PER_S) * 1e3
    rest = statistics.median(step_ms[1:])
    print(f"{tag}: {cfg.dtype}, {cfg.n_layers} layers, {n_params} params, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} steps: first step {step_ms[0]:.3f} ms, median of "
          f"the other {TRAIN_STEPS - 1} {rest:.3f} ms ({n_tokens / rest * 1e3:.1f} tokens/s; the "
          f"least a step could take {bound_ms:.3f} ms: 6 P tokens at {PEAK_BF16_PER_S:.3g} FLOP/s "
          f"+ {ADAMW_BYTES_PER_PARAM} B a parameter at {PEAK_BYTES_PER_S:.3g} B/s), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"{tag}: step ms {json.dumps([round(t, 3) for t in step_ms])}, losses "
          f"{json.dumps(losses)}", flush=True)
    print(f"{tag}: launches {json.dumps(launches)} (expected {json.dumps(want)})", flush=True)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    if not (all(math.isfinite(x) for x in losses) and len(set(losses)) > 1):
        raise AssertionError(f"{tag}: losses {losses} not finite or constant")
    kinds = {"flash_attention": (flash_attention_forward, flash_attention_backward,
                                 re.compile(r"\b(?:fwd|dq|dkdv)_kernel\b")),
             "mamba_scan": (mamba_scan_forward, mamba_scan_backward,
                            re.compile(f"{SCAN_FORWARD.pattern}|{SCAN_BACKWARD.pattern}"))}
    sl = slice(0, TRAIN_BATCH)
    with _profiled(True) as prof:
        t = time.perf_counter()
        params, state, loss, _ = step(params, state, {"tokens": tokens[sl], "labels": labels[sl]})
        float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    _print_profile(prof, wall, tag, [kinds[f] for f in families], host_top=True)
    del params, state
    return launches


def _train_resume(device):
    """``--resume``: xlstm-125m at full size for 3 of the launcher's 6 steps
    (its own pieces, on the 6-step run's data and schedule), saved with
    meta {"arch", "step": 3}, then ``main([... "--steps", "6", "--resume",
    file])`` against an uninterrupted ``main([... "--steps", "6",
    "--ckpt", file])``: the largest parameter and state difference,
    relative to max(1, max |uninterrupted|), within ``TRAIN_RESUME_TOL``.
    Files under build/, removed."""
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf

    work = ROOT / "build" / "chip_smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    args = ["--arch", "xlstm-125m", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1"]
    try:
        t = time.perf_counter()
        want = train.main(args + ["--ckpt", str(work / "full.ckpt")])
        full_s = time.perf_counter() - t
        cfg = get_config("xlstm-125m")
        params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
        opt = train.make_optimizer(3e-4, TRAIN_STEPS)
        state = opt.init(params)
        step = train.make_train_step(cfg, opt)
        data = make_token_stream(TRAIN_STEPS * TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0)
        for i in range(TRAIN_STEPS // 2):
            sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            batch = {"tokens": torch.from_numpy(data.x[sl]).to(device),
                     "labels": torch.from_numpy(data.y[sl]).to(device)}
            params, state, _, _ = step(params, state, batch)
        part = work / "part.ckpt"
        save_checkpoint(str(part), (params, state), meta={"arch": cfg.name,
                                                          "step": TRAIN_STEPS // 2})
        t = time.perf_counter()
        got = train.main(args + ["--resume", str(part)])
        resume_s = time.perf_counter() - t
    finally:
        for f in work.glob("*"):
            f.unlink()
        work.rmdir()
    diff = max((a.float() - b.float()).abs().max().item()
               / max(1.0, b.float().abs().max().item())
               for a, b in zip(_leaves(got), _leaves(want)))
    same = all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))
    print(f"train resume xlstm-125m: {TRAIN_STEPS // 2} steps, --ckpt, --resume to step "
          f"{TRAIN_STEPS} ({resume_s:.3f} s) against {TRAIN_STEPS} uninterrupted steps "
          f"({full_s:.3f} s): bit-identical {same}, max relative |diff| {diff:.3g} (tolerance "
          f"{TRAIN_RESUME_TOL})", flush=True)
    if not diff <= TRAIN_RESUME_TOL:
        raise AssertionError(f"train resume: resumed run differs by {diff}")


def _train_agreement(device, models=TRAIN_REDUCED, mesh=None, tag="train agreement"):
    """3 launcher steps of each reduced config (fp32; deepseek with its MTP
    head) on the CPU (plain versions) and on the card (kernels) from the
    same parameters and batches (2 x 64 tokens): each step's loss and the
    final parameters within ``TRAIN_AGREE_LOSS_TOL`` / ``TRAIN_AGREE_PARAM_TOL``.
    With ``mesh``, the MoE configs' capacity dispatch under it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf

    for model in models:
        cfg = get_config(model, reduced=True)
        if mesh is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="capacity"))
        data = make_token_stream(3 * 2, 64, cfg.vocab, seed=0)
        runs = []
        for dev in (torch.device("cpu"), device):
            params = _tree_to(tf.init_params(torch.Generator().manual_seed(0), cfg), dev)
            opt = train.make_optimizer(3e-4, 3)
            state = opt.init(params)
            step = train.make_train_step(cfg, opt, mesh=mesh)
            losses = []
            for i in range(3):
                batch = {"tokens": torch.from_numpy(data.x[2 * i:2 * i + 2]).to(dev),
                         "labels": torch.from_numpy(data.y[2 * i:2 * i + 2]).to(dev)}
                params, state, loss, _ = step(params, state, batch)
                losses.append(float(loss))
            runs.append((losses, [t.cpu() for t in _leaves(params)]))
        (cpu_l, cpu_p), (card_l, card_p) = runs
        loss_diff = max(abs(a - b) / b for a, b in zip(card_l, cpu_l))
        param_diff = max((a - b).abs().max().item() for a, b in zip(card_p, cpu_p))
        print(f"{tag} {cfg.name}: {cfg.n_layers} layers, mtp {cfg.mtp}, losses card "
              f"{json.dumps(card_l)} cpu {json.dumps(cpu_l)}, max relative |loss diff| "
              f"{loss_diff:.3g} (tolerance {TRAIN_AGREE_LOSS_TOL}), max |params diff| "
              f"{param_diff:.3g} (tolerance {TRAIN_AGREE_PARAM_TOL})", flush=True)
        if not (loss_diff <= TRAIN_AGREE_LOSS_TOL and param_diff <= TRAIN_AGREE_PARAM_TOL):
            raise AssertionError(f"{tag} {cfg.name}: loss {loss_diff}, params "
                                 f"{param_diff}")


def _train_phase(device):
    """The training launcher: each full-size model, then the checkpoint
    round trip.  Returns K3's and K4's launches over the models' runs."""
    t = time.perf_counter()
    total: dict[str, int] = {}
    for model, families in TRAIN_MODELS.items():
        for k, n in _train_model(device, model, families).items():
            total[k] = total.get(k, 0) + n
    _train_resume(device)
    print(f"train: launches {json.dumps(total)}; phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    return total


SERVE_FULL = ("stablelm-3b", "hymba-1.5b", "xlstm-125m", "qwen3-14b")
# at full width, cut in depth: gemma3's first global layer (pattern LLLLLG)
# is its sixth, so 6 layers bring its dual RoPE theta into decode; dbrx-132b
# (MoE, 16 experts) in 2 layers is 7.8 B parameters, deepseek-v3-671b (MLA,
# 256 experts and a shared one) in 1 layer 13.4 B
SERVE_CUT = {"glm4-9b": 4, "gemma3-27b": 6, "dbrx-132b": 2, "deepseek-v3-671b": 1}
SERVE_PROMPTS = (128, 1280)  # 4 requests each; 1280 is past the 1024-token windows
SERVE_BATCH, SERVE_NEW = 4, 32
SERVE_REDUCED_TOL = 1e-4     # card vs CPU at fp32 (K3 as 3xTF32, sums in another order)
# the scheduler's prefill ms and decode ms a step of each prompt length, and
# the peak, of each full-size model (``_serve_model``), for the MoE phase
SERVE_TIMES: dict[str, dict] = {}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _serve_model(device, model, n_layers=None):
    """``model`` at full width in its config's dtype (bf16), cut to
    ``n_layers`` if given, serving 8 requests (4 prompts of 128 tokens, 4
    of 1280, from ``dummy_batch``'s seed 0) through ``BatchScheduler``
    with ``max_batch`` 4 and ``max_new`` 32, after one uncounted group of
    4 x 16 tokens that takes the libraries' first-call costs; then decode(prefill(x[:-1]),
    x[-1]) against forward(x) at the last position.  Returns the kernels'
    launches from the scheduler's run alone, which must be attention
    layers x groups (K3) and hymba layers x groups (K4), forward only.
    The prefill -> decode contract is held, at the reference's 2e-2 x (max
    |logit| + 1), on the same weights in fp32 (the reference's own test is
    an fp32 one); the bf16 figure is printed beside it: bf16 rounding
    grows through the layers past that tolerance for hymba and xlstm, in
    the reference too (``scripts/bf16_decode_drift.py``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward
    from repro_torch.models import transformer as tf
    from repro_torch.serving import BatchScheduler

    counters = (flash_attention_forward, flash_attention_backward, mamba_scan_forward,
                mamba_scan_backward)
    cfg = get_config(model)
    cut = "full depth"
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        cut = f"n_layers {get_config(model).n_layers} -> {n_layers}"
    tag = f"serve {model}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rows = dummy_batch(cfg, 2 * SERVE_BATCH, max(SERVE_PROMPTS), seed=0)["tokens"].numpy()
    prompts = [row[:SERVE_PROMPTS[i // SERVE_BATCH]] for i, row in enumerate(rows)]
    warm = BatchScheduler(cfg, params, max_batch=SERVE_BATCH, max_new=2)
    for p in prompts[:SERVE_BATCH]:   # one short group first: the libraries' first calls
        warm.submit(p[:16])
    warm.run()
    sched = BatchScheduler(cfg, params, max_batch=SERVE_BATCH, max_new=SERVE_NEW)
    ids = [sched.submit(p) for p in prompts]
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    groups = len(sched.groups)
    attn_layers = 0 if cfg.block_type == "xlstm" else cfg.n_layers
    mamba_layers = cfg.n_layers if cfg.block_type == "hymba" else 0
    want = {"flash_attention_forward": attn_layers * groups, "flash_attention_backward": 0,
            "mamba_scan_forward": mamba_layers * groups, "mamba_scan_backward": 0}
    outs = [sched.result(i) for i in ids]
    ok = done == len(prompts) and all(o.shape == (SERVE_NEW,) and 0 <= o.min() and
                                      o.max() < cfg.vocab for o in outs)
    weight_bound_ms = param_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"{tag}: {cfg.dtype}, {cut}, {cfg.n_layers} layers, {n_params} params "
          f"({param_bytes / 1e9:.3f} GB), init {init_s:.3f} s; {len(prompts)} requests "
          f"({SERVE_BATCH} x {SERVE_PROMPTS[0]}, {SERVE_BATCH} x {SERVE_PROMPTS[1]} tokens), "
          f"max_batch {SERVE_BATCH}, max_new {SERVE_NEW}: {groups} groups in {wall:.3f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    SERVE_TIMES[model] = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    for g in sched.groups:
        step_ms = g["decode_s"] / max(g["decode_steps"], 1) * 1e3
        SERVE_TIMES[model][g["prompt_len"]] = (g["prefill_s"] * 1e3, step_ms)
        print(f"{tag}: group prompt {g['prompt_len']} x {g['rows']} rows: prefill "
              f"{g['prefill_s'] * 1e3:.3f} ms, decode {g['decode_steps']} steps "
              f"{step_ms:.3f} ms a step ({g['rows'] * g['decode_steps'] / g['decode_s']:.1f} "
              f"tok/s; the weight-read bound {weight_bound_ms:.3f} ms a step)", flush=True)
    print(f"{tag}: launches {json.dumps(launches)} (expected {json.dumps(want)})", flush=True)
    if launches != want or not ok:
        raise AssertionError(f"{tag}: launches {launches} (expected {want}), outputs ok {ok}")

    x = torch.from_numpy(np.stack(prompts[:SERVE_BATCH])).to(device)
    drift = _decode_vs_forward(cfg, params, x)
    del params, sched, warm
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = _decode_vs_forward(cfg32, tf.init_params(torch.Generator(device).manual_seed(0),
                                                     cfg32), x)
    print(f"{tag}: decode(prefill(x[:-1]), x[-1]) vs forward(x) at S = {x.shape[1]}, max |err| "
          f"/ (max |logit| + 1): float32 (the same weights before their bf16 rounding) "
          f"{exact[0]:.4g}, held to 2e-2; bfloat16 {drift[0]:.4g}, reported (bf16 rounding "
          f"amplified through the layers: scripts/bf16_decode_drift.py)", flush=True)
    if not (exact[1] and drift[1] and exact[0] <= 2e-2):
        raise AssertionError(f"{tag}: prefill -> decode differs from forward: fp32 {exact}, "
                             f"bf16 {drift}")
    return launches


def _decode_vs_forward(cfg, params, x, mesh=None):
    """(max |decode(prefill(x[:-1]), x[-1]) - forward(x)[-1]| / (max |logit|
    + 1), both finite) for prompts x (B, S) on the parameters' device,
    under ``mesh`` if given."""
    import torch

    from repro_torch.models import transformer as tf

    s = x.shape[1]
    with torch.no_grad():
        full = tf._logits(params, cfg, tf.forward(params, cfg, x, mesh=mesh)[:, -1]).float()
        _, cache = tf.prefill(params, cfg, {"tokens": x[:, :-1]}, s + 4, mesh=mesh)
        got = tf.decode_step(params, cfg, {"token": x[:, -1:]}, cache, s - 1,
                             mesh=mesh)[0].float()
    err = (got - full).abs().max().item() / (full.abs().max().item() + 1.0)
    return err, bool(torch.isfinite(got).all() and torch.isfinite(full).all())


def _serve_agreement(device, model):
    """The reduced config (fp32) on the CPU and on the card from the same
    parameters: ``BatchScheduler``'s greedy tokens equal, the prefill's
    logits and cache within ``SERVE_REDUCED_TOL`` relative."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import BatchScheduler

    cfg = get_config(model, reduced=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = _tree_to(params, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (16, 16, 128, 128)]
    outs = []
    for p in (params, on_card):
        sched = BatchScheduler(cfg, p, max_batch=2, max_new=8)
        ids = [sched.submit(t) for t in prompts]
        sched.run()
        outs.append([sched.result(i) for i in ids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    tokens = torch.from_numpy(np.stack(prompts[2:]).astype(np.int32))
    want, want_cache = tf.prefill(params, cfg, {"tokens": tokens}, 136)
    got, got_cache = tf.prefill(on_card, cfg, {"tokens": tokens.to(device)}, 136)
    err = max((g.cpu().float() - w.float()).abs().max().item()
              / max(1.0, w.float().abs().max().item())
              for g, w in zip([got] + _leaves(got_cache), [want] + _leaves(want_cache)))
    print(f"serve agreement {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, tokens card == cpu: "
          f"{same}, max relative |diff| of the prefill's logits and cache {err:.3g} "
          f"(tolerance {SERVE_REDUCED_TOL})", flush=True)
    if not (same and err <= SERVE_REDUCED_TOL):
        raise AssertionError(f"serve agreement {cfg.name}: tokens equal {same}, diff {err}")


# musicgen-large's frame prompts; internvl2-1b's count its 256 patches: 128
# or 1024 tokens after them
MODAL_PROMPTS = {"musicgen-large": (128, 1280), "internvl2-1b": (384, 1280)}


def _modal_argv(model, prompt_len, gen):
    return ["--arch", model, "--batch", str(SERVE_BATCH), "--prompt-len", str(prompt_len),
            "--gen", str(gen), "--seed", "0"]


def _serve_modal(device, model):
    """``model`` (frame or image-patch inputs) at full size in bf16 through
    ``repro_torch.launch.serve``'s entry point: 4 prompts of each length in
    ``MODAL_PROMPTS`` (``dummy_batch``'s frames or patches and tokens,
    seed 0), 32 new tokens each (a frames model feeding back the sampled
    code's embedding), after one uncounted short run; then
    decode(prefill(x[:-1]), x[-1]) against forward(x) at full size, held
    in fp32 and printed in bf16.  K3 must launch once a layer in each
    prefill and nowhere else; returns its forward launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    counters = (flash_attention_forward, flash_attention_backward, mamba_scan_forward,
                mamba_scan_backward)
    cfg = get_config(model)
    tag = f"serve {model}"
    serve.run(_modal_argv(model, cfg.n_patches + 16, 2))   # the libraries' first calls
    total = 0
    for prompt_len in MODAL_PROMPTS[model]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        gen, st = serve.run(_modal_argv(model, prompt_len, SERVE_NEW))
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        want = {"flash_attention_forward": cfg.n_layers, "flash_attention_backward": 0,
                "mamba_scan_forward": 0, "mamba_scan_backward": 0}
        step_ms = st["decode_s"] / st["decode_steps"] * 1e3
        bound_ms = st["param_bytes"] / PEAK_BYTES_PER_S * 1e3
        ok = tuple(gen.shape) == (SERVE_BATCH, SERVE_NEW) and 0 <= int(gen.min()) and \
            int(gen.max()) < cfg.vocab
        print(f"{tag}: {cfg.dtype}, full depth ({cfg.n_layers} layers), {st['n_params']} params "
              f"({st['param_bytes'] / 1e9:.3f} GB), input_mode {cfg.input_mode}; prompt "
              f"{SERVE_BATCH} x {prompt_len} positions"
              + (f" ({cfg.n_patches} patches + {prompt_len - cfg.n_patches} tokens)"
                 if cfg.input_mode == "vlm" else "")
              + f": prefill {st['prefill_s'] * 1e3:.3f} ms, decode {st['decode_steps']} steps "
              f"{step_ms:.3f} ms a step ({SERVE_BATCH * st['decode_steps'] / st['decode_s']:.1f} "
              f"tok/s; the weight-read bound {bound_ms:.3f} ms a step), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
              f"{json.dumps(launches)} (expected {json.dumps(want)})", flush=True)
        if launches != want or not ok:
            raise AssertionError(f"{tag}: launches {launches} (expected {want}), outputs ok {ok}")
        total += launches["flash_attention_forward"]

    seq = cfg.n_patches + SERVE_PROMPTS[0]
    gc.collect()
    torch.cuda.empty_cache()
    drift = _modal_decode_vs_forward(cfg, tf.init_params(
        torch.Generator(device).manual_seed(0), cfg), dummy_batch(cfg, SERVE_BATCH, seq), device)
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = _modal_decode_vs_forward(cfg32, tf.init_params(
        torch.Generator(device).manual_seed(0), cfg32), dummy_batch(cfg32, SERVE_BATCH, seq),
        device)
    print(f"{tag}: decode(prefill(x[:-1]), x[-1]) vs forward(x) at S = {seq}, max |err| / (max "
          f"|logit| + 1): float32 (the same weights before their bf16 rounding) {exact[0]:.4g}, "
          f"held to 2e-2; bfloat16 {drift[0]:.4g}, reported", flush=True)
    if not (exact[1] and drift[1] and exact[0] <= 2e-2):
        raise AssertionError(f"{tag}: prefill -> decode differs from forward: fp32 {exact}, "
                             f"bf16 {drift}")
    return total


def _modal_decode_vs_forward(cfg, params, batch, device):
    """``_decode_vs_forward`` for a frame or patch prompt ``batch``: the
    last frame (or the last token after the patches) decoded from the
    prefill of the others, against the full forward's last position."""
    import torch

    from repro_torch.models import transformer as tf

    batch = {k: v.to(device) for k, v in batch.items() if k != "labels"}
    if cfg.input_mode == "frames":
        head, last = {"frames": batch["frames"][:, :-1]}, {"frame": batch["frames"][:, -1:]}
    else:
        head = {"patches": batch["patches"], "tokens": batch["tokens"][:, :-1]}
        last = {"token": batch["tokens"][:, -1:]}
    with torch.no_grad():
        x, _ = tf.embed_inputs(params, cfg, batch)
        s = x.shape[1]
        full = tf._logits(params, cfg, tf.forward(params, cfg, x)[:, -1]).float()
        del x
        _, cache = tf.prefill(params, cfg, head, s + 4)
        got = tf.decode_step(params, cfg, last, cache, s - 1)[0].float()
    err = (got - full).abs().max().item() / (full.abs().max().item() + 1.0)
    return err, bool(torch.isfinite(got).all() and torch.isfinite(full).all())


def _serve_modal_agreement(device, model):
    """The reduced config (fp32) on the CPU and on the card from the same
    parameters and prompt (64 positions; internvl2's 8 patches first):
    the prefill's logits and cache within ``SERVE_REDUCED_TOL`` relative,
    and 8 greedy decode steps give the same tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.models import transformer as tf

    cfg = get_config(model, reduced=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: v for k, v in dummy_batch(cfg, 2, 64, seed=1).items() if k != "labels"}
    runs = []
    for dev in (torch.device("cpu"), device):
        p = _tree_to(params, dev)
        logits, cache = tf.prefill(p, cfg, _tree_to(batch, dev), 72)
        # copies: decode_step advances the cache in place (on the CPU too)
        first = [t.cpu().clone() for t in [logits, *_leaves(cache)]]
        toks = [logits.argmax(-1)]
        for pos in range(64, 72):
            tok = toks[-1][:, None]
            step = ({"frame": p["embed"][tok[:, 0]][:, None, :]} if cfg.input_mode == "frames"
                    else {"token": tok.to(torch.int32)})
            logits, cache = tf.decode_step(p, cfg, step, cache, pos)
            toks.append(logits.argmax(-1))
        runs.append((first, torch.stack(toks).cpu()))
    (want, want_toks), (got, got_toks) = runs
    err = max((g.float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
              for g, w in zip(got, want))
    same = torch.equal(got_toks, want_toks)
    print(f"serve agreement {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, {cfg.input_mode} "
          f"inputs, 8 decoded tokens card == cpu: {same}, max relative |diff| of the prefill's "
          f"logits and cache {err:.3g} (tolerance {SERVE_REDUCED_TOL})", flush=True)
    if not (same and err <= SERVE_REDUCED_TOL):
        raise AssertionError(f"serve agreement {cfg.name}: tokens equal {same}, diff {err}")


def _serve_phase(device):
    """The serving path: each full-size model, the frame and patch models
    through ``launch.serve``, then the reduced configs of every served
    family on the card and the CPU.  Returns K3's and K4's forward
    launches over the scheduler and launcher runs."""
    t = time.perf_counter()
    total = {"flash_attention_forward": 0, "mamba_scan_forward": 0}
    for model, n_layers in [*((m, None) for m in SERVE_FULL), *SERVE_CUT.items()]:
        launches = _serve_model(device, model, n_layers)
        for k in total:
            total[k] += launches[k]
    for model in MODAL_PROMPTS:
        total["flash_attention_forward"] += _serve_modal(device, model)
    for model in (*SERVE_FULL, *SERVE_CUT):
        _serve_agreement(device, model)
    for model in MODAL_PROMPTS:
        _serve_modal_agreement(device, model)
    print(f"serve: launches {json.dumps(total)}; phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    return total


# the MoE configs on the capacity path under a mesh of one (``make_host_mesh()``:
# a world of one, so the collectives are the identity), cut as ``SERVE_CUT``
MOE_MESH_MODELS = ("dbrx-132b", "deepseek-v3-671b")
# the launcher's step on dbrx-132b at full width, 1 layer: its 4.49 B parameters
# take 12 B each (bf16 weights and gradients, fp32 AdamW moments, 53.9 GB) and
# the step's clipped gradients, updates and the expert leaves' fp32 AdamW
# temporaries about 35 GB more, past the card's 80 GB; the vocabulary is cut
# from 100352 to 8192 (the embedding and head from 1.23 B parameters to 0.10 B)
MOE_TRAIN_VOCAB, MOE_TRAIN_STEPS = 8192, 3
DBRX_STEP_SHAPE = (8, 128, 48, 8, 128)   # K3 in its step: (B, S, H, KV, D)


def _drop_counts(counts):
    """A wrapper of ``moe.moe_capacity`` that adds each call's (token,
    slot) assignments to its local experts and the kept ones to
    ``counts`` [assigned, kept], from the same router and dispatch."""
    from repro_torch.models import moe as moe_mod

    plain = moe_mod.moe_capacity

    def counting(p, cfg, x2d, expert_offset=0, n_local_experts=None, include_shared=True,
                 grad_sync=None):
        e_loc = n_local_experts or cfg.moe.n_experts
        ids, w, _ = moe_mod._router(p, cfg, x2d)
        local = ids - expert_offset
        kept = moe_mod.dispatch(ids, w, moe_mod.capacity(cfg, x2d.shape[0]), expert_offset,
                                e_loc)[2]
        counts[0] += int(((local >= 0) & (local < e_loc)).sum())
        counts[1] += int(kept.sum())
        return plain(p, cfg, x2d, expert_offset, n_local_experts, include_shared, grad_sync)

    return plain, counting


def _moe_mesh_serve(device, model, mesh):
    """``model`` at full width in bf16, cut to ``SERVE_CUT``'s depth, on the
    capacity path: ``prefill`` of 4 prompts of 128 and of 1280 tokens and
    31 greedy ``decode_step`` calls each, under ``mesh``; the prefill ms,
    decode ms a step against the weight-read bound and peak beside the
    ``serve:`` phase's dense numbers; then the same calls again through a
    counting wrapper for the share of (token, slot) assignments dropped
    (prefill and decode apart).  Then the no-drop check (capacity factor E
    / top_k, so cap >= tokens): the capacity prefill's logits against the
    dense prefill's at 4 x 128 in bf16, and fp32 decode(prefill(x[:-1]),
    x[-1]) against forward(x) under the mesh, both within 2e-2 x (max
    |logit| + 1).  Returns K3's forward launches of the timed run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.kernels.flash_attention import flash_attention_forward
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config(model), n_layers=SERVE_CUT[model])
    mc = cfg.moe
    tag = model
    gc.collect()
    torch.cuda.empty_cache()
    params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    bound_ms = param_bytes / PEAK_BYTES_PER_S * 1e3
    rows = dummy_batch(cfg, 2 * SERVE_BATCH, max(SERVE_PROMPTS), seed=0)["tokens"]
    prompts = {n: rows[i * SERVE_BATCH:(i + 1) * SERVE_BATCH, :n].to(device)
               for i, n in enumerate(SERVE_PROMPTS)}

    def prefill(x):
        return tf.prefill(params, cfg, {"tokens": x}, x.shape[1] + SERVE_NEW, mesh=mesh)

    def decode(logits, cache, pos):
        """31 greedy steps from ``pos``: ms a step."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok = logits.argmax(-1, keepdim=True)
        for i in range(SERVE_NEW - 1):
            logits, cache = tf.decode_step(params, cfg, {"token": tok}, cache, pos + i,
                                           mesh=mesh)
            tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / (SERVE_NEW - 1) * 1e3

    def serve(x):
        return decode(*prefill(x), x.shape[1])

    serve(prompts[SERVE_PROMPTS[0]][:, :16])          # the libraries' first calls
    torch.cuda.reset_peak_memory_stats()
    flash_attention_forward.launches = 0
    times = {}
    for n, x in prompts.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(x)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        times[n] = (prefill_ms, serve(x))
    launches = flash_attention_forward.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = 2 * cfg.n_layers * len(SERVE_PROMPTS)    # the timed prefills and serve()'s
    dense = SERVE_TIMES[model]
    print(f"moe mesh: {SMI}; {tag}: bfloat16, n_layers {get_config(model).n_layers} -> "
          f"{cfg.n_layers}, {sum(t.numel() for t in _leaves(params))} params "
          f"({param_bytes / 1e9:.3f} GB), capacity dispatch under a mesh of "
          f"{mesh.shape} (E {mc.n_experts}, top-{mc.top_k}, capacity factor "
          f"{mc.capacity_factor}); peak {peak:.2f} GiB (dense, serve: phase "
          f"{dense['peak_gib']:.2f} GiB)", flush=True)
    for n, (prefill_ms, step_ms) in times.items():
        cap_p, cap_d = moe_mod.capacity(cfg, SERVE_BATCH * n), moe_mod.capacity(cfg, SERVE_BATCH)
        print(f"moe mesh: {SMI}; {tag}: prompt {n} x {SERVE_BATCH} rows: prefill "
              f"{prefill_ms:.3f} ms (cap {cap_p} rows an expert; dense, serve: phase "
              f"{dense[n][0]:.3f} ms), decode {SERVE_NEW - 1} steps {step_ms:.3f} ms a step "
              f"(cap {cap_d}; dense {dense[n][1]:.3f} ms; the weight-read bound "
              f"{bound_ms:.3f} ms a step)", flush=True)
    print(f"moe mesh: {tag}: K3 launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"{tag}: K3 launched {launches} times, expected {want}")

    plain, counting = _drop_counts(counts := [0, 0])
    moe_mod.moe_capacity = counting
    try:
        shares = {}
        for n, x in prompts.items():
            counts[:] = [0, 0]
            logits, cache = prefill(x)
            pre = counts[:]
            counts[:] = [0, 0]
            decode(logits, cache, n)
            shares[n] = ((pre[0] - pre[1]) / pre[0], (counts[0] - counts[1]) / counts[0])
    finally:
        moe_mod.moe_capacity = plain
    for n, (pre, dec) in shares.items():
        print(f"moe mesh: {tag}: prompt {n}: share of (token, slot) assignments dropped "
              f"{pre:.6f} in the prefill, {dec:.6f} over the decode steps (at decode cap = "
              f"{moe_mod.capacity(cfg, SERVE_BATCH)} of {SERVE_BATCH} tokens, as in the "
              f"reference)", flush=True)

    x = prompts[SERVE_PROMPTS[0]]
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=mc.n_experts / mc.top_k))
    with torch.no_grad():
        dense_logits = tf.prefill(params, cfg, {"tokens": x}, x.shape[1])[0].float()
        cap_logits = tf.prefill(params, nodrop, {"tokens": x}, x.shape[1], mesh=mesh)[0].float()
    err = (cap_logits - dense_logits).abs().max().item() / (dense_logits.abs().max().item() + 1)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    nodrop32 = dataclasses.replace(nodrop, dtype="float32")
    exact = _decode_vs_forward(nodrop32, tf.init_params(torch.Generator(device).manual_seed(0),
                                                        nodrop32), x, mesh)
    print(f"moe mesh: {tag}: no drop (capacity factor {nodrop.moe.capacity_factor:g}): the "
          f"capacity prefill's bf16 logits against the dense prefill's at {SERVE_BATCH} x "
          f"{x.shape[1]}, max |err| / (max |logit| + 1) {err:.4g}, held to 2e-2; fp32 "
          f"decode(prefill(x[:-1]), x[-1]) vs forward(x) under the mesh {exact[0]:.4g}, held "
          f"to 2e-2", flush=True)
    if not (bool(torch.isfinite(cap_logits).all()) and err <= 2e-2 and exact[1]
            and exact[0] <= 2e-2):
        raise AssertionError(f"{tag}: no-drop capacity {err}, fp32 contract {exact}")
    return launches


def _moe_mesh_agreement(device, mesh):
    """The reduced dbrx and deepseek (fp32, ``impl="capacity"``) under
    ``mesh`` on the CPU and on the card from the same weights: 2 prompts
    of 16 tokens, prefill and 8 greedy decode steps: the same tokens, the
    prefill's logits and cache and each step's logits within
    ``SERVE_REDUCED_TOL`` relative."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    for model in MOE_MESH_MODELS:
        cfg = get_config(model, reduced=True)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="capacity"))
        params = tf.init_params(torch.Generator().manual_seed(0), cfg)
        x = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
        runs = []
        for dev, p in ((torch.device("cpu"), params), (device, _tree_to(params, device))):
            logits, cache = tf.prefill(p, cfg, {"tokens": x.to(dev)}, 24, mesh=mesh)
            # copies: decode advances the cache in place, and .cpu() of a CPU
            # tensor is the tensor itself
            outs, toks = [logits.cpu()] + [t.cpu().clone() for t in _leaves(cache)], []
            tok = logits.argmax(-1, keepdim=True)
            for i in range(8):
                toks.append(tok.cpu())
                logits, cache = tf.decode_step(p, cfg, {"token": tok}, cache, 16 + i, mesh=mesh)
                outs.append(logits.cpu())
                tok = logits.argmax(-1, keepdim=True)
            runs.append((outs, torch.cat(toks, 1)))
        (cpu_o, cpu_t), (card_o, card_t) = runs
        same = torch.equal(cpu_t, card_t)
        err = max((a.float() - b.float()).abs().max().item() / max(1.0, b.float().abs().max().item())
                  for a, b in zip(card_o, cpu_o))
        print(f"moe mesh agreement {cfg.name}: capacity under {mesh.shape}, tokens card == cpu: "
              f"{same}, max relative |diff| of the logits and the prefill's cache {err:.3g} "
              f"(tolerance {SERVE_REDUCED_TOL})", flush=True)
        if not (same and err <= SERVE_REDUCED_TOL):
            raise AssertionError(f"moe mesh agreement {cfg.name}: tokens {same}, diff {err}")


def _moe_mesh_train(device, mesh):
    """The launcher's step (``make_train_step(..., mesh=)``, clip + AdamW
    with ``make_optimizer(3e-4, 3)``) on dbrx-132b at full width, 1 layer,
    the vocabulary cut to ``MOE_TRAIN_VOCAB``, bf16, batch 8 of 128 tokens,
    3 steps on the capacity path: each step's ms, the losses (finite, not
    constant), the peak; K3 once a step each way.  Returns K3's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.launch import train
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=1, vocab=MOE_TRAIN_VOCAB)
    tag = "train dbrx-132b"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    full_params = n_params + 2 * (full.vocab - cfg.vocab) * cfg.d_model
    opt = train.make_optimizer(3e-4, MOE_TRAIN_STEPS)
    state = opt.init(params)
    step = train.make_train_step(cfg, opt, mesh=mesh)
    data = make_token_stream(MOE_TRAIN_STEPS * TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0)
    tokens, labels = (torch.from_numpy(a).to(device) for a in (data.x, data.y))
    flash_attention_forward.launches = flash_attention_backward.launches = 0
    step_ms, losses = [], []
    for i in range(MOE_TRAIN_STEPS):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss, _ = step(params, state, {"tokens": tokens[sl], "labels": labels[sl]})
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"flash_attention_forward": flash_attention_forward.launches,
                "flash_attention_backward": flash_attention_backward.launches}
    want = {k: cfg.n_layers * MOE_TRAIN_STEPS for k in launches}
    print(f"moe mesh: {SMI}; {tag}: bfloat16, 1 layer, vocab {full.vocab} -> {cfg.vocab} "
          f"(at the full vocabulary {full_params} params need {12 * full_params / 1e9:.1f} GB "
          f"for weights, gradients and AdamW's moments before the step's temporaries), "
          f"{n_params} params, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens (cap "
          f"{moe_mod.capacity(cfg, TRAIN_BATCH * TRAIN_SEQ)} rows an expert), "
          f"{MOE_TRAIN_STEPS} steps under {mesh.shape}: step ms "
          f"{json.dumps([round(t, 3) for t in step_ms])}, losses {json.dumps(losses)}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K3 launches "
          f"{json.dumps(launches)} (expected {json.dumps(want)})", flush=True)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    if not (all(math.isfinite(x) for x in losses) and len(set(losses)) > 1):
        raise AssertionError(f"{tag}: losses {losses} not finite or constant")
    del params, state
    return launches


def _moe_mesh_phase(device):
    """The MoE's capacity path under a mesh of one: serving dbrx-132b and
    deepseek-v3-671b, the card against the CPU on their reduced configs
    (serving, and 3 launcher steps within the ``TRAIN_AGREE_*``
    tolerances), and the dbrx training run.  Returns K3's launches, and
    under "train_backward" its backward launches in the dbrx step."""
    from repro_torch.launch.mesh import make_host_mesh

    t = time.perf_counter()
    mesh = make_host_mesh()
    print(f"moe mesh: a mesh of one process on one card ({mesh.shape}): the capacity "
          f"dispatch's sums over the mesh are the identity here; tests/test_torch_mesh.py "
          f"runs the four branches in a world of four CPU processes under gloo", flush=True)
    total = {"flash_attention_forward": 0, "flash_attention_backward": 0}
    for model in MOE_MESH_MODELS:
        total["flash_attention_forward"] += _moe_mesh_serve(device, model, mesh)
    _moe_mesh_agreement(device, mesh)
    _train_agreement(device, MOE_MESH_MODELS, mesh=mesh, tag="moe mesh train agreement")
    train = _moe_mesh_train(device, mesh)
    for k, n in train.items():
        total[k] += n
    print(f"moe mesh: launches {json.dumps(total)}; phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    return total | {"train_backward": train["flash_attention_backward"]}


SCALEOUT_ROUNDS = 30
# the scaleout backend and the two rounds it must equal: host, and compiled
# with every client training (cohort_gather=False), as scaleout trains them
SCALEOUT_RUNS = {"scaleout": ({"backend": "scaleout"}, {}), "host": ({}, {}),
                 "compiled cohort_gather=False": ({"backend": "compiled"},
                                                  {"cohort_gather": False})}
ROUND_MODEL, ROUND_BATCH, ROUND_SEQ, ROUND_STEPS, ROUND_LR = "stablelm-3b", 8, 128, 4, 0.05


def _scaleout_engines(device):
    """The paper's configuration (K = 100, m = 10, fedlecc J = 3) for
    ``SCALEOUT_ROUNDS`` rounds on ``backend="scaleout"`` in a world of one
    (every pod in this process: K1 once a round over the (100, P) stack),
    on host and on compiled with ``cohort_gather=False``: one line each
    (setup, median round, accuracy, MB, K1 and K2 launches); the three
    must select the same clients every round and end within 1e-5.
    Returns K1's and K2's launches over the three runs."""
    import torch

    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    train, test = _paper_data()
    runs, k1, k2 = {}, 0, 0
    for tag, (kw, engine_kw) in SCALEOUT_RUNS.items():
        cfg = FLConfig(**(PAPER | {"rounds": SCALEOUT_ROUNDS, "strategy": "fedlecc",
                                   "strategy_kwargs": {"J": 3}} | kw))
        hellinger_strip.launches = masked_weighted_sum.launches = 0
        t = time.perf_counter()
        engine = make_engine(cfg, train, test, n_classes=10, device=device, **engine_kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        results, ms = [], []
        it = engine.rounds()
        for _ in range(cfg.rounds):
            t = time.perf_counter()
            results.append(next(it))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        rec = {"tag": tag, "backend": cfg.backend, "rounds": len(results), "setup_s": setup_s,
               "median_round_ms": statistics.median(ms), "final_test_acc": results[-1].test_acc,
               "comm_mb": results[-1].comm_mb, "k1_launches": masked_weighted_sum.launches,
               "k2_launches": hellinger_strip.launches}
        if tag == "scaleout":
            rec |= {"n_pods": engine.n_pods, "world": engine.mesh.world}
        print(f"scaleout: {json.dumps(rec)}", flush=True)
        if (rec["k1_launches"], rec["k2_launches"]) != (cfg.rounds, 1):
            raise AssertionError(f"scaleout {tag}: K1/K2 launched {rec['k1_launches']}/"
                                 f"{rec['k2_launches']} times; expected {cfg.rounds}/1")
        if not (engine.params.is_cuda and torch.isfinite(engine.params).all()):
            raise AssertionError(f"scaleout {tag}: final parameters not finite")
        k1, k2 = k1 + rec["k1_launches"], k2 + rec["k2_launches"]
        runs[tag] = (engine, results)
    for tag in ("host", "compiled cohort_gather=False"):
        _same_run(f"fedlecc scaleout vs {tag}", runs["scaleout"], runs[tag], PARITY_ATOL,
                  phase="scaleout")
    return k1, k2


def _scaleout_round(device):
    """``make_federated_round`` on ``ROUND_MODEL`` at full size in bf16,
    one pod (a world of one), ``ROUND_STEPS`` local SGD steps on a batch of
    ``ROUND_BATCH`` x ``ROUND_SEQ`` tokens, with compress_bits 0 and 8,
    two rounds each from the same start: ms a round, the loss, peak
    memory; K1 once a leaf a round, K3 once a layer a step forward and
    backward; the int8 round within half a quantization step a leaf (plus
    bf16 rounding) of the exact one.  Returns the launches."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.federated.scaleout import make_federated_round, stack_for_clients
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params

    counters = (masked_weighted_sum, flash_attention_forward, flash_attention_backward)
    cfg = get_config(ROUND_MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    start = stack_for_clients(params, 1)
    leaves = tree_leaves(params)
    batch = {k: v[None].to(device) for k, v in dummy_batch(cfg, ROUND_BATCH, ROUND_SEQ,
                                                           seed=0).items()}
    weights = torch.ones(1, device=device)
    mesh = make_host_mesh(pod=1)
    want = {"masked_weighted_sum": len(leaves),
            "flash_attention_forward": cfg.n_layers * ROUND_STEPS,
            "flash_attention_backward": cfg.n_layers * ROUND_STEPS}
    total = dict.fromkeys(want, 0)
    out = {}
    for bits in (0, 8):
        fn = make_federated_round(cfg, mesh, lr=ROUND_LR, local_steps=ROUND_STEPS,
                                  compress_bits=bits)
        ms = []
        for _ in range(2):
            out.pop(bits, None)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            t = time.perf_counter()
            new, losses = fn(start, batch, weights)
            loss = losses.tolist()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches = {c.__name__: c.launches for c in counters}
            for k in total:
                total[k] += launches[k]
            out[bits] = [t[0] for t in tree_leaves(new)]
            del new
            if launches != want or not all(math.isfinite(x) for x in loss):
                raise AssertionError(f"scaleout round compress_bits={bits}: launches {launches} "
                                     f"(expected {want}), losses {loss}")
        print(f"scaleout round: {ROUND_MODEL} {cfg.dtype} full size ({cfg.n_layers} layers, "
              f"{sum(t.numel() for t in leaves)} params, {len(leaves)} leaves), 1 pod, "
              f"{ROUND_STEPS} local steps of {ROUND_BATCH} x {ROUND_SEQ} tokens, lr {ROUND_LR}, "
              f"compress_bits {bits}: {ms[1]:.3f} ms a round (first {ms[0]:.3f} ms), loss "
              f"{loss[0]:.6g}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches a round {json.dumps(launches)}", flush=True)
    worst = 0.0
    for exact, q8, s0 in zip(out[0], out[8], leaves):
        exact, q8, s0 = exact.float(), q8.float(), s0.float()
        step = (exact - s0).abs().max().item() / 127
        limit = 0.5 * step + 2**-6 * exact.abs().max().item()
        err = (q8 - exact).abs().max().item()
        worst = max(worst, err / limit if limit else 0.0)
        if err > limit:
            raise AssertionError(f"scaleout round: int8 differs from exact by {err} > {limit}")
    print(f"scaleout round: compress_bits 8 vs 0, the largest |diff| / (half a quantization step "
          f"+ bf16 rounding) over the leaves {worst:.4g} (held to 1)", flush=True)
    return total


def _scaleout_phase(device):
    """The scaleout backend in a world of one on the card; returns the
    launches of K1, K2 and K3 (forward, backward) in it."""
    t = time.perf_counter()
    print("scaleout: a world of one process on one card: the engine's and the round's "
          "all-reduce and all-gather are the identity here; scaleout grid: runs them in a "
          "world of eight processes on this card under gloo", flush=True)
    k1, k2 = _scaleout_engines(device)
    launches = _scaleout_round(device)
    launches["masked_weighted_sum"] += k1
    launches["hellinger_strip"] = k2
    print(f"scaleout: launches {json.dumps(launches)}; phase in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return launches


GRID_DIR = ROOT / "build" / "grid"
GRID_PROBE_TIMEOUT = 120


def _grid_start(kind, world, *extra):
    """``world`` processes of this script (``--grid-child kind rank world
    dir ...``) on the one card, joined by a file store under ``GRID_DIR``,
    started and not waited for: (their directory, the processes)."""
    import os

    work = GRID_DIR / kind
    work.mkdir(parents=True, exist_ok=True)
    (work / "store").unlink(missing_ok=True)
    # expandable segments: eight allocators share the card, and internvl2-1b's
    # fp32 round (its 151,655-row table and head whole on every rank) leaves
    # ~1.8 GiB a process reserved but unallocated in fixed segments, which
    # made the eighth process's allocation fail
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--grid-child",
                               kind, str(r), str(world), str(work), *map(str, extra)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    for p in procs:
        atexit.register(lambda p=p: p.poll() is None and p.kill())  # a failed run too
    return work, procs


def _grid_wait(started, timeout):
    """Wait for ``_grid_start``'s processes: [(returncode or None where the
    time limit cut it, its output, the JSON object its last line holds or
    None)], one a rank, each rank's output also written to ``rank{r}.log``
    in their directory.  Every process is waited for or killed before this
    returns."""
    work, procs = started
    deadline = time.perf_counter() + timeout
    out = []
    try:
        for p in procs:
            try:
                log, _ = p.communicate(timeout=max(deadline - time.perf_counter(), 1))
                rc = p.returncode
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
                rc = None
            last = log.strip().splitlines()[-1:] if log.strip() else []
            try:
                res = json.loads(last[0]) if last else None
            except json.JSONDecodeError:
                res = None
            out.append((rc, log, res))
            (work / f"rank{len(out) - 1}.log").write_text(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _grid_probe_start():
    """Before the grid world, two worlds of two processes on the one card,
    started together: one under NCCL (a communicator of two ranks on one
    device, which NCCL should refuse), one under gloo with CUDA tensors
    (``all_reduce`` sum and max, ``all_gather`` and an uneven
    ``all_to_all_single`` in fp32, bf16, int8 and int64, each result
    checked).  ``_grid_probe_finish`` waits for them."""
    return (time.perf_counter(), _grid_start("nccl-probe", 2), _grid_start("gloo-probe", 2))


def _grid_probe_finish(probes):
    """Prints what each of ``_grid_probe_start``'s worlds found; raises if
    gloo's CUDA collectives fail, since the grid world runs on them."""
    t, nccl_started, gloo_started = probes
    nccl = _grid_wait(nccl_started, GRID_PROBE_TIMEOUT)
    found = []
    for rc, log, res in nccl:
        if rc is None:
            found.append("cut at the time limit (hung)")
        elif res is not None and res.get("ok"):
            found.append("all_reduce ran")
        else:
            err = (res or {}).get("error") or log.strip().splitlines()[-1:]
            found.append(f"refused (exit {rc}): {err}")
    print(f"scaleout grid: probe: NCCL, two ranks of one communicator on one card: "
          f"{json.dumps(found)}", flush=True)
    gloo = _grid_wait(gloo_started, GRID_PROBE_TIMEOUT)
    for r, (rc, log, res) in enumerate(gloo):
        print(f"scaleout grid: probe: gloo with CUDA tensors, rank {r}: exit {rc}, "
              f"{json.dumps(res)}", flush=True)
        if rc != 0 or not res or not res.get("ok"):
            raise AssertionError(f"scaleout grid: gloo's CUDA collectives failed on rank {r}: "
                                 f"{log[-3000:]}")
    print(f"scaleout grid: probe in {time.perf_counter() - t:.1f} s (beside the world of one)",
          flush=True)
    return found


def _probe_child(kind, rank, world, work) -> dict:
    """One rank of ``_grid_probe_start``'s worlds."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl" if kind == "nccl-probe" else "gloo",
                            init_method=f"file://{work}/store", world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    if kind == "nccl-probe":
        try:
            t = torch.full((4,), rank + 1.0, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            return {"ok": True, "sum": t.tolist()}
        except Exception as e:  # the refusal is the finding
            return {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}
    got = {}
    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.int64):
        name = str(dt).replace("torch.", "")
        t = torch.full((1000,), rank + 1, dtype=dt, device=dev)
        dist.all_reduce(t)
        parts = [torch.empty(1000, dtype=dt, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((1000,), rank, dtype=dt, device=dev))
        m = torch.full((1000,), float(rank), device=dev)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        # the MoE's all-to-all of expert rows, uneven: rank r sends r + k + 1
        # rows to rank k, each row its sender's number
        send = [rank + k + 1 for k in range(world)]
        recv = [k + rank + 1 for k in range(world)]
        y = torch.empty((sum(recv), 3), dtype=dt, device=dev)
        dist.all_to_all_single(y, torch.full((sum(send), 3), rank, dtype=dt, device=dev),
                               recv, send)
        ok = (t.float() == world * (world + 1) / 2).all().item() and all(
            (p.float() == i).all().item() for i, p in enumerate(parts)) and \
            (m == world - 1).all().item() and t.is_cuda and parts[0].is_cuda and y.is_cuda \
            and all((c.float() == k).all().item() for k, c in enumerate(y.split(recv)))
        got[name] = bool(ok)
    return {"ok": all(got.values()), **got}


def _grid_child_main() -> int:
    """``--grid-child kind rank world dir [...]``: a rank of the probe's
    worlds or of the grid world; its last line of output is a JSON
    object."""
    kind, rank, world, work, *extra = sys.argv[2:]
    rank, world = int(rank), int(world)
    sys.path.insert(0, str(ROOT / "src"))
    if kind in ("nccl-probe", "gloo-probe"):
        res = _probe_child(kind, rank, world, work)
    else:
        res = _grid_rank(rank, world, work, *extra)
    print(json.dumps(res), flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


# the grid world: (pod 2, data 2, model 2) in eight processes on the one
# card under gloo, each of GRID_MODELS at full width cut to GRID_LAYERS
# layers (the world's collectives cross host memory under gloo, so depth is
# what its time scales with; eight processes of 4 layers hold ~2 GiB each
# in bf16), GRID_STEPS local steps of ROUND_BATCH sequences a pod (two, not
# the scaleout phase's ROUND_STEPS: each step sums every block's gradient
# over data through host memory, and the script has a time limit), the
# pods' FedAvg weights GRID_W; the runs: (tag, dtype, compress_bits)
GRID_SHAPE, GRID_LAYERS, GRID_W = {"data": 2, "model": 2, "pod": 2}, 4, (0.25, 0.75)
GRID_STEPS = 2
# xlstm-125m's round takes one local step: its training at full width is
# chaotic from the second step on, in the reference too (a 1e-7 relative
# change of the start weights moves the reference's own SGD by 2.5e-6 after
# one step, 1.0e-2 after two and 0.29 after three; the port's round by
# 2.1e-6 and 4.8e-3), so that the grid's sums in another order cannot be
# held to GRID_FP32_TOL over two steps (3.0e-2 on an H100).  The second
# step's forward is where branches flip: the mLSTM normaliser max(|q.n|,
# exp(-m)) and the sign of q.n, and sLSTM's cummax, each switching the
# gradient from one branch to the other (fp32, 4 layers, on a CPU:
# scripts/xlstm_round_sensitivity.py --branches / --reference)
GRID_MODEL_STEPS = {"xlstm-125m": 1}
# a 1-step round's fp32 blocks are also held on the update itself: each
# leaf's largest |diff| from the world of one's within GRID_UPDATE_TOL of
# the largest |update| of that leaf in the world of one (new - start), a
# bound on each gradient relative to its own scale.  xlstm-125m reads 7.7e-4
# (its gate bias b_if, whose update is 3.1e-4) on an H100 80GB HBM3 at 700 W
# and 1.3e-4 on a CPU; dropping core_norm's backward sum over model reads
# 1.1 on a CPU (scripts/xlstm_bf16_serve_grid.py --rounds)
GRID_UPDATE_TOL = 2e-3


def _grid_steps(model) -> int:
    return GRID_MODEL_STEPS.get(model, GRID_STEPS)

GRID_RUNS = (("bf16 q0", "bfloat16", 0), ("bf16 q8", "bfloat16", 8), ("fp32 q0", "float32", 0))
# model: (sequence, its runs); internvl2-1b's 384 positions are its 256
# patches and 128 text tokens (128 would hold no text after the patches)
GRID_MODELS = {"stablelm-3b": (ROUND_SEQ, GRID_RUNS), "hymba-1.5b": (ROUND_SEQ, GRID_RUNS),
               "internvl2-1b": (384, GRID_RUNS[2:]), "musicgen-large": (ROUND_SEQ, GRID_RUNS[2:]),
               "xlstm-125m": (ROUND_SEQ, GRID_RUNS[2:])}
# the shapes a rank hands K3, (B, S, H, KV, D), and K4, (B, S, D, N): its
# 4-sequence data share; stablelm's, internvl2's and musicgen's heads split
# over model 2, hymba's 25 q heads do not (its attention replicated) and its
# 1600 Mamba channels do
GRID_K3 = {"stablelm-3b": (4, 128, 16, 16, 80), "hymba-1.5b": (4, 128, 25, 5, 64),
           "internvl2-1b": (4, 384, 7, 1, 64), "musicgen-large": (4, 128, 16, 16, 64)}
GRID_K4 = {"hymba-1.5b": (4, 128, 800, 16)}
GRID_TIMEOUT = 600
# each rank's fp32 blocks against the world of one, relative to max(1, max
# |world of one|): the same SGD from the same weights, its sums over model,
# data and pod in another order, K3 as 3xTF32
GRID_FP32_TOL = 1e-4
GRID_RESULTS: dict = {}
GRID_COUNTERS = ("masked_weighted_sum", "flash_attention_forward", "flash_attention_backward",
                 "mamba_scan_forward", "mamba_scan_backward")


def _grid_cfg(model, dtype):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(model), n_layers=GRID_LAYERS, dtype=dtype)


def _grid_rank(rank, world, work) -> dict:
    """One rank of the grid world: for each of ``GRID_MODELS`` and each of
    its runs, its blocks of ``_grid_cfg``'s weights (``param_blocks``), its
    ``data`` share of its pod's batch, the round once under
    ``dryrun.count_flops``: ms, loss, held bytes, the peak above the
    arguments, K1 / K3 / K4 launches, the tallies, and its blocks against
    the world of one's (``_grid_reference``'s file)."""
    import torch
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.federated.scaleout import make_federated_round, stack_for_clients
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params, param_blocks

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    pin_fp32_matmul()
    dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=world,
                            rank=rank)
    mesh = make_host_mesh(**GRID_SHAPE)
    pod, d = mesh.coords["pod"], mesh.coords["data"]
    counters = (masked_weighted_sum, flash_attention_forward, flash_attention_backward,
                mamba_scan_forward, mamba_scan_backward)
    out = {"coords": mesh.coords, "runs": {}}
    for model, (seq, runs) in GRID_MODELS.items():
        for tag, dtype, bits in runs:
            cfg = _grid_cfg(model, dtype)
            whole = init_params(torch.Generator(device).manual_seed(0), cfg)
            blocks = param_blocks(whole, cfg, mesh)
            spec = tree_flatten(whole)[1]
            del whole
            share = ROUND_BATCH // mesh.shape["data"]
            batch = {k: v[None, d * share:(d + 1) * share].to(device)
                     for k, v in dummy_batch(cfg, ROUND_BATCH, seq, seed=pod).items()}
            start = stack_for_clients(blocks, 1)
            held_update = model in GRID_MODEL_STEPS and dtype == "float32"
            before = [x.detach().clone() for x in tree_leaves(blocks)] if held_update else None
            weights = torch.tensor(GRID_W, device=device)
            fn = make_federated_round(cfg, mesh, lr=ROUND_LR, local_steps=_grid_steps(model),
                                      compress_bits=bits)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            free, _ = torch.cuda.mem_get_info()
            print(f"grid rank {rank}: {model} {tag}: the card has {free / 2**30:.2f} GiB free, "
                  f"this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB",
                  flush=True)
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for c in counters:
                c.launches = 0
            t = time.perf_counter()
            (new, losses), flops, tally = dryrun.count_flops(fn, start, batch, weights)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
            got = [x[0] for x in tree_leaves(new)]
            held = sum(x.numel() * x.element_size() for x in tree_leaves(blocks))
            del new, start, blocks, batch
            # the world of one's leaves, cut to this rank's blocks on the host
            # and compared on the card (eight processes share the host's cores)
            ref_path = Path(work).parent / f"reference_{model}_{bits}_{dtype}.pt"
            deadline = time.perf_counter() + GRID_TIMEOUT
            while not ref_path.exists():  # the world of one runs beside this world
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"no {ref_path.name} from the world of one")
                time.sleep(0.2)
            ref = torch.load(ref_path, mmap=True)
            want = [w.to(device) for w in
                    tree_leaves(param_blocks(tree_unflatten(ref, spec), cfg, mesh))]
            errs = [((g.float() - w.float()).abs().max().item(), w.float().abs().max().item())
                    for g, w in zip(got, want, strict=True)]
            diff = max(e for e, _ in errs)
            rel = max(e / max(1.0, m) for e, m in errs)
            rel_update = None
            if held_update:
                steps = [(w.float() - b.float()).abs().max().item()
                         for w, b in zip(want, before, strict=True)]
                rel_update = max(e / u if u > 0 else (0.0 if e == 0 else math.inf)
                                 for (e, _), u in zip(errs, steps))
                del before
            out["runs"][f"{model} {tag}"] = {
                "ms": ms, "loss": losses.tolist(), "held_bytes": held, "peak_bytes": peak,
                "flops": flops, "coll": dict(tally.collectives),
                "launches": {c.__name__: c.launches for c in counters},
                "tallied": {k: v["launches"] for k, v in tally.kernels.items()},
                "product_flops": {k: v["product_flops"] for k, v in tally.kernels.items()},
                "max_abs_diff": diff, "max_rel_diff": rel, "update_rel_diff": rel_update,
                "finite": bool(all(torch.isfinite(g).all() for g in got)
                               and torch.isfinite(losses).all()),
            }
            del got, ref, want
    out["serve"] = _serve_grid_rank(mesh, work, device, counters)
    return out


# the serve grid, in the grid world after its rounds: each of SERVE_GRID_MODELS
# at full width cut to GRID_LAYERS layers (dbrx-132b to SERVE_GRID_RUN_LAYERS),
# its blocks, built leaf by leaf, served through
# BatchScheduler(mesh=) in fp32 and bf16: SERVE_GRID_ROWS requests of
# SERVE_GRID_PROMPT tokens in one group (2 rows a rank over the 4 data
# ranks), then SERVE_GRID_ODD of them in a group of their own (rows the data
# axes do not divide: every rank holds all 3), SERVE_GRID_NEW new tokens each
SERVE_GRID_MODELS = ("stablelm-3b", "hymba-1.5b", "xlstm-125m", "dbrx-132b")
SERVE_GRID_DTYPES = ("float32", "bfloat16")
SERVE_GRID_ROWS, SERVE_GRID_ODD, SERVE_GRID_PROMPT, SERVE_GRID_NEW = 8, 3, 128, 16
# dbrx-132b on its blocks (its 16 experts over model, their FFN columns over
# data, its 48 / 8 kv heads and its vocab over model) at full width: in bf16
# at SERVE_CUT's 2 layers (whole 7.75e9 parameters, 15.5 GB; a rank's blocks
# 4.27 GiB), and in fp32 at 1 layer (whole 4.49e9, 18.0 GB; a rank's 5.8
# GB), whose fp32 at 2 layers would not fit the eight ranks' blocks and
# their exchanges.  Each call takes rule 1 (T <= 8192 and 8 | 16: 2 whole
# experts a rank, exchanged from the blocks by an all-to-all of 0.79 GB a
# layer a rank in bf16 through gloo in host memory), so its new tokens are
# cut to SERVE_GRID_MODEL_NEW (not its width).  Its world of one runs alone
# after the grid world (beside the eight processes' rounds it would crowd
# the card), under a mesh of one process, whose capacity dispatch is the
# grid's rule 1 with every expert on one rank (the reference's MoE under a
# mesh); the ranks save their tokens, logits and dispatch slots.  In bf16
# the router's top-k and the experts' capacity part from the world of
# one's at near ties among a prefill's 1024 tokens (an H100 run: every row
# of both groups at the first layer, the closest k-th / (k+1)-th router
# probabilities 8.4e-5 apart), after which the two compute other
# functions; so the world of one replays the grid's slots (``_Routing``)
# and each of its own that differs must lie at a near tie
SERVE_GRID_RUNS = tuple((m, dt) for m in SERVE_GRID_MODELS for dt in SERVE_GRID_DTYPES)
SERVE_GRID_ALONE = ("dbrx-132b",)
SERVE_GRID_RUN_LAYERS = {("dbrx-132b", "float32"): 1, ("dbrx-132b", "bfloat16"): 2}
SERVE_GRID_MODEL_NEW = {"dbrx-132b": 4}
# bf16 logits against the world of one's, relative to max(1, |ref|), while a
# row's tokens agree: 3e-2, and xlstm-125m's 1e-1.  xlstm-125m (4 layers,
# these requests) moves one bf16 rounding into its logits many times over:
# on an H100 its bf16 logits depart 0.18 from its fp32 ones, two worlds of
# one that differ only in the order in which w_down's product is summed
# differ by 0.018, and the grid, whose row blocks' partial outputs are
# rounded to bf16 before their sum over model, by 0.076; dropping
# core_norm's sum over model moves them by 0.9 (H100 80GB HBM3, 700 W,
# scripts/xlstm_bf16_serve_grid.py; the reference's own bf16 departs 0.15
# from its fp32 on a CPU, scripts/xlstm_reference_bf16.py)
SERVE_GRID_BF16_TOL = {"stablelm-3b": 3e-2, "hymba-1.5b": 3e-2, "xlstm-125m": 1e-1,
                       "dbrx-132b": 3e-2}
# the shapes a rank's serve prefill hands K3, (B, S, H, KV, D), and K4, (B, S,
# D, N), for each group (rows a rank): stablelm's 16 of 32 heads; hymba's 25 /
# 5 kv heads replicated (they split mid-head) and its 800 of 1600 channels;
# dbrx's 24 of 48 heads over 4 of 8 kv heads
SERVE_GRID_K3 = {model: {rows: (r, SERVE_GRID_PROMPT, *heads) for rows, r in
                         ((SERVE_GRID_ROWS, 2), (SERVE_GRID_ODD, SERVE_GRID_ODD))}
                 for model, heads in (("stablelm-3b", (16, 16, 80)),
                                      ("hymba-1.5b", (25, 5, 64)),
                                      ("dbrx-132b", (24, 4, 128)))}
# each model's window on its serve grid's K3 checks (hymba's local layers)
SERVE_GRID_WINDOW = {"stablelm-3b": 0, "hymba-1.5b": 1024, "dbrx-132b": 0}
SERVE_GRID_K4 = {"hymba-1.5b": {rows: (r, SERVE_GRID_PROMPT, 800, 16) for rows, r in
                                ((SERVE_GRID_ROWS, 2), (SERVE_GRID_ODD, SERVE_GRID_ODD))}}
# the long request, in the grid world after the serve grid: one prompt of
# SERVE_LONG_PROMPT tokens in a cache of SERVE_LONG_CACHE positions (the
# reference's long_500k: stablelm-3b as its long_context_variant takes it,
# a window of 4096 on every layer), SERVE_LONG_NEW new tokens, bf16 at full
# width cut to GRID_LAYERS layers, through prefill and decode_step; a batch
# of one, so each rank holds its quarter of the k / v sequence over the 4
# data ranks (and its kv heads over model where model divides them), the
# prompt in the first quarter, the other three empty at every step.  Its
# world of one runs alone after the grid world: its whole cache (21.47 GB
# for stablelm) and its decode's fp32 copy of a layer's k and v (10.7 GB)
# would crowd the eight processes
# each run (model, dtype): both models in bf16, and hymba-1.5b in fp32 too,
# whose tokens must equal the world of one's exactly (its fp32 k / v cache of
# 524,288 positions is 5.37 GB, a quarter of it a rank): a bf16 run may part
# from them only at a near tie, which fp32 tells apart from a fault of the
# split decode
SERVE_LONG_RUNS = (("stablelm-3b", "bfloat16"), ("hymba-1.5b", "bfloat16"),
                   ("hymba-1.5b", "float32"))
SERVE_LONG_PROMPT, SERVE_LONG_CACHE, SERVE_LONG_NEW = 2048, 524_288, 8
SERVE_LONG_TOL = 3e-2        # bf16 logits against the world of one's, of max(1, |ref|)
# the shapes a rank's long prefill hands K3 (B, S, H, KV, D) and its window,
# stablelm's 16 of 32 heads and hymba's 25 / 5 kv replicated, and K4 (B, S,
# D, N), hymba's 800 of 1600 channels (fp32 inputs, the final state)
SERVE_LONG_K3 = {"stablelm-3b": ((1, SERVE_LONG_PROMPT, 16, 16, 80), 4096),
                 "hymba-1.5b": ((1, SERVE_LONG_PROMPT, 25, 5, 64), 1024)}
SERVE_LONG_K4 = {"hymba-1.5b": (1, SERVE_LONG_PROMPT, 800, 16)}


def _serve_grid_cfg(model, dtype):
    """A serve grid model at full width, cut to its serve grid depth."""
    return dataclasses.replace(_grid_cfg(model, dtype),
                               n_layers=SERVE_GRID_RUN_LAYERS.get((model, dtype), GRID_LAYERS))


def _serve_new(model) -> int:
    return SERVE_GRID_MODEL_NEW.get(model, SERVE_GRID_NEW)


def _rank_blocks(cfg, mesh, device):
    """The rank's blocks of the weights drawn from seed 0 on the card, built
    leaf by leaf (``transformer.init_param_blocks``: exactly
    ``param_blocks(init_params(...))``, no whole tree held), the ranks
    taking turns so that no two hold a whole leaf's draw at once
    (dbrx-132b's expert leaves are 4.2 GB a layer in fp32 before their
    cast)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.transformer import init_param_blocks

    blocks = None
    for r in range(dist.get_world_size()):
        if r == mesh.rank:
            blocks = init_param_blocks(torch.Generator(device).manual_seed(0), cfg, mesh)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return blocks


def _serve_grid_prompts(cfg):
    """The serve grid's requests: SERVE_GRID_ROWS prompts of
    SERVE_GRID_PROMPT tokens drawn from seed 7, as numpy rows."""
    from repro_torch.configs.inputs import dummy_batch

    return list(dummy_batch(cfg, SERVE_GRID_ROWS, SERVE_GRID_PROMPT, seed=7)["tokens"].numpy())


def _serve_grid_run(cfg, params, mesh, counters=(), new=SERVE_GRID_NEW, replay=None):
    """Both groups served: {rows: {"tokens", "logits" (steps, rows, V) fp32
    on the host, "routing": the capacity dispatch's calls (``_Routing``),
    "launches": each of ``counters``' launches in that group}} and the
    seconds, through ``BatchScheduler`` (``mesh``: on the rank's blocks),
    each step's logits recorded where the scheduler takes its greedy
    tokens.  ``replay``: {rows: each dispatch call's slots} that the
    group's capacity dispatch takes in place of its own (``_Routing``)."""
    import torch

    from repro_torch.serving import BatchScheduler

    class Recording(BatchScheduler):
        def _greedy(self, logits):
            self.seen.append(logits.float().cpu())
            return super()._greedy(logits)

    prompts = _serve_grid_prompts(cfg)
    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for rows in (SERVE_GRID_ROWS, SERVE_GRID_ODD):
        sched = Recording(cfg, params, max_batch=rows, max_new=new, mesh=mesh)
        sched.seen = []
        ids = [sched.submit(p) for p in prompts[:rows]]
        before = {c.__name__: c.launches for c in counters}
        with _Routing((replay or {}).get(rows)) as routing:
            sched.run()
        out[rows] = {"tokens": [sched.result(i).tolist() for i in ids],
                     "logits": torch.stack(sched.seen), "routing": routing.calls,
                     "launches": {c.__name__: c.launches - before[c.__name__] for c in counters}}
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _serve_grid_measure(cfg, blocks, mesh, device, new=SERVE_GRID_NEW) -> dict:
    """One prefill of the SERVE_GRID_ROWS group on the rank's blocks (its
    rows, the cache of ``SERVE_GRID_PROMPT + new`` positions) and
    one decode step after it, each under ``dryrun.count_flops`` as the dry
    run traces them: held bytes (the step's arguments), flops, collective
    bytes, K3 / K4 launches and their tally, the peak above the arguments,
    and the call's wall ms and its all-to-all's (the MoE's exchange of
    expert blocks, each timed between two synchronizations)."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.kernels.flash_attention import flash_attention_forward
    from repro_torch.kernels.mamba_scan import mamba_scan_forward
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tf

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    lo, n = tf.batch_rows(mesh, SERVE_GRID_ROWS)
    rows = np.stack(_serve_grid_prompts(cfg))[lo:lo + n]
    batch = {"tokens": torch.from_numpy(rows).to(device)}
    max_len = SERVE_GRID_PROMPT + new
    out, state = {}, {}

    def prefill():
        return tf.prefill(blocks, cfg, batch, max_len, mesh=mesh, batch_size=SERVE_GRID_ROWS)

    def decode():
        return tf.decode_step(blocks, cfg, {"token": state["tok"]}, state["cache"],
                              SERVE_GRID_PROMPT, mesh=mesh, max_len=max_len)

    plain = Mesh.all_to_all

    def timed(self, *args, **kwargs):     # the MoE's exchange of expert blocks
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = plain(self, *args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return got

    Mesh.all_to_all = timed
    try:
        for kind, fn, held in (("prefill", prefill, lambda: nbytes(blocks) + nbytes(batch)),
                               ("decode", decode, lambda: nbytes(blocks) + nbytes(state["tok"])
                                + nbytes(state["cache"]) + 4)):   # + decode's int32 position
            spent = [0.0]
            t = time.perf_counter()
            (logits, cache), out[kind] = _measured(fn, held(), (flash_attention_forward,
                                                                mamba_scan_forward))
            out[kind] |= {"ms": (time.perf_counter() - t) * 1e3,
                          "all_to_all_ms": spent[0] * 1e3}
            state = {"tok": torch.argmax(logits, -1)[:, None].to(torch.int32), "cache": cache}
    finally:
        Mesh.all_to_all = plain
    return out


def _measured(fn, held, kernels):
    """``fn()`` once under ``dryrun.count_flops``, as the dry run traces a
    step: (its output, {the step's arguments ``held`` (bytes), flops,
    collective bytes, the peak above what was allocated when it began,
    each of ``kernels``' launches in the call, the tally's launches and
    product flops})."""
    import torch

    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    at = {c.__name__: c.launches for c in kernels}
    out, flops, tally = dryrun.count_flops(fn)
    torch.cuda.synchronize()
    return out, {"held_bytes": held, "flops": flops, "coll": dict(tally.collectives),
                 "peak_bytes": torch.cuda.max_memory_allocated() - base,
                 "launches": {c.__name__: c.launches - at[c.__name__] for c in kernels
                              if c.launches > at[c.__name__]},
                 "tallied": {k: v["launches"] for k, v in tally.kernels.items()},
                 "product_flops": {k: v["product_flops"] for k, v in tally.kernels.items()}}


class _Routing:
    """While on, records each call of the capacity dispatch
    (``moe.dispatch``): its slots (token, weight and validity a slot, on
    the host) and expert offset, for each expert whose assignments
    overflow its capacity the gap between the router weights of its last
    kept and first dropped assignment, and each token's gap between its
    k-th and (k+1)-th router probability where the router ran on the same
    tokens (``moe.route``; else None).  ``replay``: a list of slots a
    call, which each call returns in place of its own (after recording
    its own)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.calls, self._gap = [], None
        plain_route, plain = moe_mod.route, moe_mod.dispatch

        def routing(p, cfg, x2d):
            ids, w, probs = plain_route(p, cfg, x2d)
            top = probs.float().topk(min(cfg.moe.top_k + 1, probs.shape[-1]), dim=-1).values
            self._gap = (top[..., -2] - top[..., -1]).reshape(-1).cpu()
            return ids, w, probs

        def recording(ids, w, cap, expert_offset, e_loc):
            out = plain(ids, w, cap, expert_offset, e_loc)
            ids_c, w_c = ids.cpu(), w.float().cpu()
            gaps = {}
            for e in range(expert_offset, expert_offset + e_loc):
                ws = w_c[ids_c == e].sort(descending=True).values
                if ws.numel() > cap:
                    gaps[e] = float(ws[cap - 1] - ws[cap])
            topk = self._gap.tolist() if self._gap is not None and \
                self._gap.numel() == ids.shape[0] else None
            self.calls.append({"offset": expert_offset, "cap": cap,
                               "slots": tuple(t.cpu() for t in out), "gaps": gaps,
                               "topk": topk})
            if self.replay is None:
                return out
            return tuple(t.to(o.device) for t, o in zip(self.replay[len(self.calls) - 1], out))

        self._plain = plain_route, plain
        moe_mod.route, moe_mod.dispatch = routing, recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod

        moe_mod.route, moe_mod.dispatch = self._plain


def _routing_merged(ranks) -> list:
    """The grid's dispatch calls (``ranks``: each rank's ``_Routing`` calls of
    one group, each covering its own experts) as one call's slots each:
    the ranks' slots in the order of their experts."""
    import torch

    out = []
    for calls in zip(*ranks):
        parts = sorted(calls, key=lambda c: c["offset"])
        out.append(tuple(torch.cat([c["slots"][i] for c in parts]) for i in range(3)))
    return out


def _kept(slots, cap) -> dict:
    """{expert (from 0): its kept tokens, sorted} of one call's slots."""
    tok, _, valid = slots
    return {e: sorted(tok[e * cap:(e + 1) * cap][valid[e * cap:(e + 1) * cap]].tolist())
            for e in range(len(tok) // cap)}


def _routing_faults(own, grid, n_layers, prompt, room, inputs) -> list[str]:
    """The world of one's own capacity dispatch (``own``: its ``_Routing``
    calls, which replayed ``grid``, the grid's merged slots) against the
    grid's, call by call (``n_layers`` calls a forward: the prefill of
    ``prompt`` positions a row, then a decode step of one token a row),
    before step ``inputs`` (the first whose input tokens differ): each
    expert whose kept tokens differ must be explained by a near tie in the
    world of one: its last kept and first dropped router weights, or the
    k-th and (k+1)-th router probabilities of one of the tokens that moved,
    within ``room``.  Every difference is printed; returns the faults."""
    faults = []
    for c, (call, slots) in enumerate(zip(own, grid)):
        step = c // n_layers
        if step >= inputs:
            break
        mine, theirs = _kept(call["slots"], call["cap"]), _kept(slots, call["cap"])
        for e, toks in mine.items():
            if theirs.get(e) == toks:
                continue
            moved = set(toks) ^ set(theirs.get(e, []))
            rows = sorted({t // (prompt if step == 0 else 1) for t in moved})
            tie = min(call["topk"][t] for t in moved) if call["topk"] else None
            gap = call["gaps"].get(e)
            print(f"    routing: call {c} (step {step}, layer {c % n_layers}), expert {e}: the "
                  f"grid keeps other tokens in rows {rows}; in the world of one its last kept "
                  f"and first dropped weights lie {gap} apart, the closest k-th / (k+1)-th "
                  f"router probabilities of the moved tokens {tie} (room {room:.4g})",
                  flush=True)
            if not any(x is not None and x <= room for x in (gap, tie)):
                faults.append(f"call {c} expert {e}: kept tokens differ, weight gap {gap}, "
                              f"probability gap {tie}")
    return faults


def _serve_grid_against(run, want) -> dict:
    """One group's served tokens and logits (``_serve_grid_run``'s) against
    ``want``'s: a row's logits are compared at the steps where its tokens
    so far agree (the same inputs), relative to max(1, max |want|)."""
    import torch

    same = [[g[:i] == w[:i] for i in range(len(w))]
            for g, w in zip(run["tokens"], want["tokens"])]
    mask = torch.tensor(same).T[:, :, None]                      # (steps, rows, 1)
    diff = ((run["logits"] - want["logits"]).abs() * mask).max().item()
    scale = max(1.0, want["logits"].abs().max().item())
    return {"tokens_equal": run["tokens"] == want["tokens"], "compared": int(mask.sum()),
            "of": mask.numel(), "max_abs_diff": diff, "max_rel_diff": diff / scale,
            "finite": bool(torch.isfinite(run["logits"]).all())}


def _serve_grid_rank(mesh, work, device, counters) -> dict:
    """The serve grid on one rank of the grid world: for each of
    ``SERVE_GRID_RUNS``, the rank's blocks of ``_serve_grid_cfg``'s weights
    (``_rank_blocks``, leaf by leaf) served (``_serve_grid_run``: launches
    counted), then measured (``_serve_grid_measure``), and each step's
    logits and tokens against the world of one's (``_serve_grid_reference``'s
    file; a model of ``SERVE_GRID_ALONE`` saves its tokens and logits for
    the main process instead).  Then each of ``SERVE_LONG_RUNS``."""
    import torch
    from torch.utils._pytree import tree_leaves

    out = {}
    for model, dtype in SERVE_GRID_RUNS:
        cfg = _serve_grid_cfg(model, dtype)
        t = time.perf_counter()
        blocks = _rank_blocks(cfg, mesh, device)
        built = time.perf_counter() - t
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        got, seconds = _serve_grid_run(cfg, blocks, mesh, counters, _serve_new(model))
        launches = {c.__name__: c.launches for c in counters}
        measured = _serve_grid_measure(cfg, blocks, mesh, device, _serve_new(model))
        print(f"grid rank {mesh.rank}: serve {model} {dtype}: blocks built leaf by leaf in "
              f"{built:.2f} s (the ranks in turn), both groups in {seconds:.2f} s, measured in "
              f"{time.perf_counter() - t - seconds:.2f} s", flush=True)
        groups = None
        if model in SERVE_GRID_ALONE:     # its world of one runs after this world
            torch.save({rows: {k: run[k] for k in ("tokens", "logits", "routing")}
                        for rows, run in got.items()},
                       Path(work) / f"serve_{model}_{dtype}_rank{mesh.rank}.pt")
        else:
            ref_path = Path(work).parent / f"serve_reference_{model}_{dtype}.pt"
            deadline = time.perf_counter() + GRID_TIMEOUT
            while not ref_path.exists():  # the world of one runs beside this world
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"no {ref_path.name} from the world of one")
                time.sleep(0.2)
            ref = torch.load(ref_path)
            groups = {rows: _serve_grid_against(run, ref[rows]) for rows, run in got.items()}
            del ref
        out[f"{model} {dtype}"] = {
            "ms": seconds * 1e3, "build_s": built, "launches": launches, "groups": groups,
            "group_launches": {rows: run["launches"] for rows, run in got.items()},
            "blocks_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(blocks)),
            "measured": measured}
        del blocks, got
        gc.collect()
        torch.cuda.empty_cache()
    for model, dtype in SERVE_LONG_RUNS:
        cfg = _serve_long_cfg(model, dtype)
        blocks = _rank_blocks(cfg, mesh, device)
        run = _serve_long_run(cfg, blocks, mesh, device, counters)
        print(f"grid rank {mesh.rank}: serve long {model} {dtype}: {run['ms']:.1f} ms, its k / "
              f"v block {run['kv_bytes']} B", flush=True)
        torch.save({k: run.pop(k) for k in ("logits",)},
                   Path(work) / f"long_{model}_{dtype}_rank{mesh.rank}.pt")
        out[f"long {model} {dtype}"] = run
        del blocks, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _serve_long_cfg(model, dtype="bfloat16"):
    from repro_torch.configs.inputs import long_context_variant

    return long_context_variant(_grid_cfg(model, dtype))


def _serve_long_run(cfg, params, mesh, device, counters=()) -> dict:
    """The long request (``mesh``: on the rank's blocks; None: the world of
    one): ``prefill`` of one prompt of SERVE_LONG_PROMPT tokens (seed 7)
    into a cache of SERVE_LONG_CACHE positions, then SERVE_LONG_NEW - 1
    greedy ``decode_step``s.  The prefill and the first decode step run
    under ``dryrun.count_flops``, as the dry run traces them: held bytes
    (the step's arguments), flops, collective bytes, K3 / K4 launches and
    their tally, the peak above the arguments.  Returns those, the tokens,
    each step's logits (fp32, host), the k / v bytes the cache holds, each
    of ``counters``' launches, and the milliseconds."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.models import transformer as tf

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    batch = {"tokens": dummy_batch(cfg, 1, SERVE_LONG_PROMPT, seed=7)["tokens"].to(device)}
    state, logits_seen, tokens, measured = {}, [], [], {}
    before = {c.__name__: c.launches for c in counters}

    def prefill():
        return tf.prefill(params, cfg, batch, SERVE_LONG_CACHE, mesh=mesh, batch_size=1)

    def decode():
        return tf.decode_step(params, cfg, {"token": state["tok"]}, state["cache"],
                              state["pos"], mesh=mesh, max_len=SERVE_LONG_CACHE)

    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(SERVE_LONG_NEW):
        fn = prefill if i == 0 else decode
        if i < 2:      # + decode's int32 position
            held = nbytes(params) + (nbytes(batch) if i == 0 else
                                     nbytes(state["tok"]) + nbytes(state["cache"]) + 4)
            (logits, cache), measured["decode" if i else "prefill"] = _measured(fn, held,
                                                                                counters)
        else:
            logits, cache = fn()
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        logits_seen.append(logits.float().cpu())
        tokens.append(int(tok[0, 0]))
        state = {"tok": tok, "cache": cache, "pos": SERVE_LONG_PROMPT + i}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return {"ms": ms, "tokens": [tokens], "logits": torch.stack(logits_seen),
            "finite": bool(all(torch.isfinite(x).all() for x in logits_seen)),
            "kv_bytes": nbytes([state["cache"]["k"], state["cache"]["v"]]),
            "launches": {c.__name__: c.launches - before[c.__name__] for c in counters},
            "measured": measured}


def _serve_long_reference(device) -> dict:
    """The long request's world of one, each run's whole weights on the
    card without a mesh (``_serve_long_run``), run alone: {"model dtype":
    its run}."""
    import torch

    from repro_torch.models import transformer as tf

    out = {}
    for model, dtype in SERVE_LONG_RUNS:
        cfg = _serve_long_cfg(model, dtype)
        params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
        out[f"{model} {dtype}"] = _serve_long_run(cfg, params, None, device)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _near_tie(tag, tokens, want, scale, tol) -> str | None:
    """Where a bf16 run's ``tokens`` (one row) first part from the world of
    one's (``want``: its "tokens" and "logits" (steps, rows, V)), printed:
    None if they do not part or part at a step whose two best logits in the
    world of one lie within twice the logits' bound (a near tie that the
    bound lets either side break, after which the sequences differ), else
    what is wrong."""
    flip = next((i for i, (g, w) in enumerate(zip(tokens, want["tokens"][0])) if g != w), None)
    if flip is None:
        return None
    top = want["logits"][flip, 0].topk(2).values
    gap, room = float(top[0] - top[1]), 2 * tol * scale
    print(f"{tag}: the tokens part at step {flip}, where the world of one's two best logits "
          f"lie {gap:.4g} apart (a flip the logits' bound allows within {room:.4g})", flush=True)
    if gap > room:
        return (f"tokens {tokens} against {want['tokens'][0]}, parting at step {flip} where the "
                f"two best logits lie {gap} apart")
    return None


def _serve_long_check(ranks, ref) -> dict:
    """The long request on every rank (``_serve_grid_rank``'s) against the
    world of one (``_serve_long_reference``), for each of
    ``SERVE_LONG_RUNS``: in bf16 the logits within ``SERVE_LONG_TOL`` of
    max(1, |ref|) at every step while the tokens agree, and the tokens
    equal but where they part at a near tie (``_near_tie``); in fp32 the
    tokens equal and the logits within ``GRID_FP32_TOL`` at every step;
    each rank's k / v bytes the whole cache's over the 4 data ranks and,
    where ``model`` divides the kv heads, over model too; K3 and K4
    forward once a layer in the prefill, none in a decode step, at the
    shapes of ``SERVE_LONG_K3`` / ``SERVE_LONG_K4`` by their product flops.
    Rank 0's measurements go to ``GRID_RESULTS["long"]`` for ``dryrun:``.
    Returns the launches summed over the ranks by (kernel, "model dtype")."""
    import torch

    launched: dict = {}
    GRID_RESULTS["long"] = {}
    dp = GRID_SHAPE["pod"] * GRID_SHAPE["data"]
    for model, dtype in SERVE_LONG_RUNS:
        key = f"{model} {dtype}"
        cfg, want = _serve_long_cfg(model, dtype), ref[key]
        tol = SERVE_LONG_TOL if dtype == "bfloat16" else GRID_FP32_TOL
        split = dp * (GRID_SHAPE["model"] if cfg.n_kv_heads % GRID_SHAPE["model"] == 0 else 1)
        # the layout before the sequence split: only the kv heads over model
        before = want["kv_bytes"] // (split // dp) * len(ranks)
        print(f"serve long {key}: batch 1 of {SERVE_LONG_PROMPT} tokens, a cache of "
              f"{SERVE_LONG_CACHE} positions ({cfg.name}, window {cfg.sliding_window}), "
              f"{SERVE_LONG_NEW} new tokens, {cfg.n_layers} layers; the world of one "
              f"{want['ms']:.1f} ms, its k / v cache {want['kv_bytes']} B "
              f"({want['kv_bytes'] / 1e9:.2f} GB), tokens {want['tokens'][0]}; the "
              f"{len(ranks)} ranks would hold {before / 1e9:.2f} GB together with the kv heads "
              f"split over model alone; logits held to {tol}" + (
                  ", tokens exactly" if dtype == "float32" else ""), flush=True)
        k3, w3 = SERVE_LONG_K3[model]
        per_launch = {"flash_attention_forward": 4.0 * k3[0] * k3[2] * k3[1] ** 2 * k3[4]}
        launches = {"flash_attention_forward": cfg.n_layers}
        if model in SERVE_LONG_K4:
            per_launch["mamba_scan_forward"] = 2.0 * math.prod(SERVE_LONG_K4[model])
            launches["mamba_scan_forward"] = cfg.n_layers
        scale = max(1.0, want["logits"].abs().max().item())
        for r, (_, _, res) in enumerate(ranks):
            run = res["serve"][f"long {key}"]
            run["logits"] = torch.load(GRID_DIR / "round" /
                                       f"long_{model}_{dtype}_rank{r}.pt")["logits"]
            against = _serve_grid_against(run, want)
            pre = run["measured"]["prefill"]
            got_per_launch = {k: pre["product_flops"].get(k, 0.0) / max(pre["tallied"].get(k, 0), 1)
                              for k in per_launch}
            got_launches = {k: n for k, n in run["launches"].items() if n}
            for k, n in got_launches.items():
                launched[k, key] = launched.get((k, key), 0) + n
            print(f"serve long {key} rank {r} {json.dumps(res['coords'])}: k / v block "
                  f"{run['kv_bytes']} B ({run['kv_bytes'] / 1e9:.3f} GB, 1/"
                  f"{want['kv_bytes'] / run['kv_bytes']:g} of the whole), {run['ms']:.1f} ms "
                  f"(eight processes sharing the card), launches {json.dumps(got_launches)}, "
                  f"product flops a launch {json.dumps(got_per_launch)}, tokens "
                  f"{run['tokens'][0]}, against the world of one {json.dumps(against)}",
                  flush=True)
            bad = []
            if not (run["finite"] and against["finite"]):
                bad.append("logits not finite")
            if dtype == "float32":
                if not (against["tokens_equal"] and against["compared"] == against["of"]):
                    bad.append(f"fp32 tokens {run['tokens']} against {want['tokens']}")
            else:
                parted = _near_tie(f"serve long {key} rank {r}", run["tokens"][0], want,
                                   scale, tol)
                if parted:
                    bad.append(parted)
            if against["max_rel_diff"] > tol:
                bad.append(f"logits differ by {against['max_rel_diff']} > {tol}")
            if run["kv_bytes"] * split != want["kv_bytes"]:
                bad.append(f"k / v block {run['kv_bytes']} B, the whole's 1/{split} is "
                           f"{want['kv_bytes'] / split} B")
            if got_launches != launches:
                bad.append(f"launches {got_launches}, want {launches}")
            if got_per_launch != per_launch:
                bad.append(f"product flops a launch {got_per_launch}, want {per_launch} (K3 at "
                           f"{k3}, K4 at {SERVE_LONG_K4.get(model)})")
            if bad:
                raise AssertionError(f"serve long {key} rank {r}: {'; '.join(bad)}")
        GRID_RESULTS["long"][key] = ranks[0][2]["serve"][f"long {key}"]["measured"]
    return launched


def _serve_grid_reference(device, alone: bool = False, n_ranks: int = 0):
    """The serve grid's world of one: each run's whole weights served by
    ``BatchScheduler`` on the card, without a mesh, its tokens and logits
    written under ``GRID_DIR`` for the ranks (``alone``: the runs of
    ``SERVE_GRID_ALONE`` instead, after the grid world of ``n_ranks``
    ranks, under a mesh of one process, each group's capacity dispatch
    replaying the grid's merged slots (``_routing_merged``) while it
    records its own; their runs returned, each group's "grid_routing" the
    slots replayed).  Returns {"model dtype": ms} (``alone``: {"model
    dtype": (ms, run)})."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf

    out = {}
    for model, dtype in SERVE_GRID_RUNS:
        if (model in SERVE_GRID_ALONE) != alone:
            continue
        cfg = _serve_grid_cfg(model, dtype)
        replay = None
        if alone:          # the grid's slots, merged over its ranks' experts
            saved = [torch.load(GRID_DIR / "round" / f"serve_{model}_{dtype}_rank{r}.pt")
                     for r in range(n_ranks)]
            replay = {rows: _routing_merged([g[rows]["routing"] for g in saved])
                      for rows in saved[0]}
            del saved
        params = tf.init_params(torch.Generator(device).manual_seed(0), cfg)
        run, seconds = _serve_grid_run(cfg, params, make_host_mesh() if alone else None,
                                       new=_serve_new(model), replay=replay)
        if alone:
            for rows, group in run.items():
                group["grid_routing"] = replay[rows]
            out[f"{model} {dtype}"] = (seconds * 1e3, run)
        else:
            out[f"{model} {dtype}"] = seconds * 1e3
            path = GRID_DIR / f"serve_reference_{model}_{dtype}.pt"
            torch.save(run, path.with_suffix(".tmp"))
            path.with_suffix(".tmp").replace(path)  # a rank never reads half a file
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _grid_reference(device):
    """Each model's runs of ``GRID_MODELS`` in a world of one process on the
    card (the whole layout: ``make_host_mesh(pod=2)`` holds both pods and
    trains each on its whole batch, then K1 over both), its leaves written
    under ``GRID_DIR`` for the ranks to cut their blocks from.  Returns
    {"model tag": (ms, the losses)}."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.federated.scaleout import make_federated_round, stack_for_clients
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params

    GRID_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for model, (seq, runs) in GRID_MODELS.items():
        for tag, dtype, bits in runs:
            cfg = _grid_cfg(model, dtype)
            params = init_params(torch.Generator(device).manual_seed(0), cfg)
            # pod p's batch from seed p, as the world's ranks draw it
            pods = [dummy_batch(cfg, ROUND_BATCH, seq, seed=p) for p in range(GRID_SHAPE["pod"])]
            batch = {k: torch.stack([b[k] for b in pods]).to(device) for k in pods[0]}
            fn = make_federated_round(cfg, make_host_mesh(pod=GRID_SHAPE["pod"]), lr=ROUND_LR,
                                      local_steps=_grid_steps(model), compress_bits=bits)
            torch.cuda.synchronize()
            t = time.perf_counter()
            new, losses = fn(stack_for_clients(params, GRID_SHAPE["pod"]), batch,
                             torch.tensor(GRID_W, device=device))
            torch.cuda.synchronize()
            out[f"{model} {tag}"] = ((time.perf_counter() - t) * 1e3, losses.tolist())
            path = GRID_DIR / f"reference_{model}_{bits}_{dtype}.pt"
            torch.save([x[0].cpu() for x in tree_leaves(new)], path.with_suffix(".tmp"))
            path.with_suffix(".tmp").replace(path)  # a rank never reads half a file
            del params, batch, new, losses
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _grid_expected(model, n_leaves) -> tuple[dict, dict]:
    """A round's launches on each rank of the grid world for ``model`` (K1
    once a leaf, K3 and K4 once a layer and local step each way, K4 for
    hymba alone) and the product flops a launch of K3 and K4 forward at
    the model's ``GRID_K3`` / ``GRID_K4`` shape (the work formulas'):
    4 B H S^2 D and 2 B S D N."""
    per_layer = GRID_LAYERS * _grid_steps(model)
    scan = per_layer if model in GRID_K4 else 0
    attn = per_layer if model in GRID_K3 else 0     # xlstm-125m: no attention
    launches = {"masked_weighted_sum": n_leaves, "flash_attention_forward": attn,
                "flash_attention_backward": attn, "mamba_scan_forward": scan,
                "mamba_scan_backward": scan}
    per_launch = {}
    if model in GRID_K3:
        b, s, h, _, dh = GRID_K3[model]
        per_launch["flash_attention_forward"] = 4.0 * b * h * s * s * dh
    if model in GRID_K4:
        per_launch["mamba_scan_forward"] = 2.0 * math.prod(GRID_K4[model])
    return launches, per_launch


def _scaleout_grid_phase(device):
    """The scale-out round on the (pod 2, data 2, model 2) grid in eight
    processes on the one card, with real collectives under gloo (NCCL
    refuses several ranks on one device: ``_grid_probe_finish``): for each of
    ``GRID_MODELS`` each rank holds its blocks under the baseline policy and
    trains on its ``data`` share, tensor-parallel over ``model``, K3 on its
    heads (hymba's replicated), K4 on its block of hymba's Mamba channels
    and K1 on its blocks.  Each rank's held bytes, peak and launches are
    printed, and the K3 / K4 shapes are checked against their work
    formulas' product flops; its fp32 blocks must equal the world of
    one's (``_grid_reference``), cut to the rank's block, within
    ``GRID_FP32_TOL``; bf16's largest difference is reported.  Then, in the
    same world, the serve grid (``_serve_grid_check``) and the long request
    (``_serve_long_check``), their worlds of one for ``SERVE_GRID_ALONE``
    and the long request run alone after the world.  Returns the world's
    launches of K1, K3 and K4, summed over its ranks; rank 0's runs go to
    ``GRID_RESULTS`` for ``dryrun:``."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.models.transformer import abstract_params

    t = time.perf_counter()
    # the probes, the world and the world of one start together: a rank
    # waits for the world of one's file of a run only after its own round
    for old in GRID_DIR.glob("reference_*"):
        old.unlink()
    probes = _grid_probe_start()
    world = math.prod(GRID_SHAPE.values())
    started = _grid_start("round", world)
    ref = _grid_reference(device)
    serve_ref = _serve_grid_reference(device)
    print(f"scaleout grid: the world of one's runs in {time.perf_counter() - t:.1f} s (beside "
          f"the probes and the eight processes' start), its serve runs among them", flush=True)
    probe = _grid_probe_finish(probes)
    torch.cuda.empty_cache()
    ranks = _grid_wait(started, GRID_TIMEOUT)
    failed = [(r, rc, log) for r, (rc, log, res) in enumerate(ranks)
              if rc != 0 or not res or "runs" not in res]
    if failed:
        # a rank whose peer failed ends with "Connection closed by peer": the
        # others' ends say why
        first = [f for f in failed if "closed by peer" not in f[2][-400:]] or failed
        raise AssertionError("scaleout grid: ranks " + ", ".join(
            f"{r} (exit {rc})" for r, rc, _ in failed) + " failed; " + "\n".join(
            f"rank {r}: {log[-2500:]}" for r, _, log in first[:2]))
    t_long = time.perf_counter()
    long_ref = _serve_long_reference(device)
    print(f"scaleout grid: the long request's world of one in "
          f"{time.perf_counter() - t_long:.1f} s, alone after the world", flush=True)
    t_alone = time.perf_counter()
    for key, (ms, run) in _serve_grid_reference(device, alone=True,
                                                n_ranks=len(ranks)).items():
        serve_ref[key] = (ms, run)
    print(f"scaleout grid: the serve grid's world of one of {', '.join(SERVE_GRID_ALONE)} in "
          f"{time.perf_counter() - t_alone:.1f} s, alone after the world", flush=True)
    total = dict.fromkeys(GRID_COUNTERS, 0)
    for model, (seq, runs) in GRID_MODELS.items():
        n_leaves = len(tree_leaves(abstract_params(_grid_cfg(model, "bfloat16"))))
        want_launches, want_per_launch = _grid_expected(model, n_leaves)
        for tag, dtype, bits in runs:
            key = f"{model} {tag}"
            ms, losses = ref[key]
            print(f"scaleout grid: {key}: a world of one (the whole layout, both pods in one "
                  f"process) {ms:.1f} ms, losses {losses}", flush=True)
            worst = 0.0
            for r, (_, _, res) in enumerate(ranks):
                run = res["runs"][key]
                for k in total:
                    total[k] += run["launches"][k]
                per_launch = {k: run["product_flops"].get(k, 0.0) / max(
                    run["tallied"].get(k, 0), 1) for k in want_per_launch}
                print(f"scaleout grid: {key} rank {r} {json.dumps(res['coords'])}: held "
                      f"{run['held_bytes'] / 2**30:.4f} GiB, peak above the arguments "
                      f"{run['peak_bytes'] / 2**30:.4f} GiB, round {run['ms']:.1f} ms (eight "
                      f"processes sharing the card), losses {run['loss']}, launches "
                      f"{json.dumps(run['launches'])}, product flops a launch "
                      f"{json.dumps(per_launch)}, collectives {json.dumps(run['coll'])} B, "
                      f"against the world of one: max |diff| {run['max_abs_diff']:.4g}, "
                      f"relative to max(1, |ref|) {run['max_rel_diff']:.4g}"
                      + ("" if run["update_rel_diff"] is None else
                         f", relative to each leaf's update {run['update_rel_diff']:.4g}"),
                      flush=True)
                worst = max(worst, run["max_rel_diff"])
                bad = []
                if not run["finite"]:
                    bad.append("not finite")
                if run["launches"] != want_launches:
                    bad.append(f"launches {run['launches']}, want {want_launches}")
                if run["launches"] != {k: run["tallied"].get(k, 0) for k in run["launches"]}:
                    bad.append(f"launches {run['launches']} against the tally {run['tallied']}")
                if per_launch != want_per_launch:
                    bad.append(f"product flops a launch {per_launch}, want {want_per_launch} "
                               f"(K3 at {GRID_K3.get(model)}, K4 at {GRID_K4.get(model)})")
                if max(abs(a - b) for a, b in zip(run["loss"], losses)) > 1e-2 * max(
                        1.0, max(abs(x) for x in losses)):
                    bad.append(f"losses {run['loss']} against the world of one's {losses}")
                if dtype == "float32" and run["max_rel_diff"] > GRID_FP32_TOL:
                    bad.append(f"fp32 blocks differ by {run['max_rel_diff']} > {GRID_FP32_TOL}")
                if (run["update_rel_diff"] is not None
                        and not run["update_rel_diff"] <= GRID_UPDATE_TOL):
                    bad.append(f"fp32 blocks differ by {run['update_rel_diff']} of a leaf's "
                               f"update > {GRID_UPDATE_TOL}")
                if bad:
                    raise AssertionError(f"scaleout grid {key} rank {r}: {'; '.join(bad)}")
            held = f"held to {GRID_FP32_TOL}" if dtype == "float32" else "reported, not held"
            print(f"scaleout grid: {key}: the largest difference of a rank's blocks from the "
                  f"world of one's, relative to max(1, |ref|), {worst:.4g} ({held})", flush=True)
        GRID_RESULTS[model] = {tag: ranks[0][2]["runs"][f"{model} {tag}"]
                               for tag, _, _ in runs}
    print(f"scaleout grid: {', '.join(GRID_MODELS)} at full width, {GRID_LAYERS} layers, "
          f"{world} processes of {json.dumps(GRID_SHAPE)} on one card under gloo (NCCL: "
          f"{probe[0][:60]}...), {GRID_STEPS} local steps (xlstm-125m 1) of {ROUND_BATCH} "
          f"sequences a pod; "
          f"launches {json.dumps(total)}", flush=True)
    serve, by_shape = _serve_grid_check(ranks, serve_ref)
    long = _serve_long_check(ranks, long_ref)
    rounds = dict(total)
    for k, n in serve.items():
        total[k] += n
    for (k, _), n in long.items():
        total[k] += n
    print(f"scaleout grid: phase wall time {time.perf_counter() - t:.1f} s", flush=True)
    return total | {"rounds": rounds, "serve_by_shape": by_shape, "serve_long": long}


def _serve_grid_expected(model, dtype) -> tuple[dict, dict]:
    """A serve run's launches in each group on each rank of the grid world
    (K3 and K4 forward once a layer in the group's prefill, none a decode
    step) and the product flops a launch of K3 and K4 forward in the
    SERVE_GRID_ROWS group's prefill (the work formulas': 4 B H S^2 D and
    2 B S D N)."""
    launches = dict.fromkeys(GRID_COUNTERS, 0)
    per_launch = {}
    layers = SERVE_GRID_RUN_LAYERS.get((model, dtype), GRID_LAYERS)
    if model in SERVE_GRID_K3:
        launches["flash_attention_forward"] = layers
        b, s, h, _, dh = SERVE_GRID_K3[model][SERVE_GRID_ROWS]
        per_launch["flash_attention_forward"] = 4.0 * b * h * s * s * dh
    if model in SERVE_GRID_K4:
        launches["mamba_scan_forward"] = layers
        per_launch["mamba_scan_forward"] = 2.0 * math.prod(SERVE_GRID_K4[model][SERVE_GRID_ROWS])
    return launches, per_launch


def _serve_grid_check(ranks, serve_ref) -> dict:
    """The serve grid's results on every rank (``_serve_grid_rank``): in fp32
    every token of both groups equal to the world of one's and every
    step's logits within ``GRID_FP32_TOL`` of max(1, |ref|); in bf16 the
    logits within the model's ``SERVE_GRID_BF16_TOL`` while a row's tokens
    agree (its inputs the same), the tokens' agreement printed.  A model of
    ``SERVE_GRID_ALONE`` (its ranks' tokens, logits and dispatch slots read
    from their files) is held so against a world of one whose capacity
    dispatch replayed the grid's slots; every expert whose own slots there
    differ from the grid's, before the tokens part, must differ at a near
    tie (``_routing_faults``), and in bf16 the tokens may part only at a
    near tie (``_near_tie``).  The K3 / K4 launches and their shapes by the work
    formulas; each rank's held bytes printed.  Rank 0's measurements go to
    ``GRID_RESULTS["serve"]`` for ``dryrun:``.  Returns the serve runs'
    launches summed over the ranks, and K3's and K4's forward launches at
    each of their shapes: {(kernel, model, dtype, group rows): launches},
    summed over the ranks."""
    import torch

    total = dict.fromkeys(GRID_COUNTERS, 0)
    by_shape: dict = {}
    GRID_RESULTS["serve"] = {}
    for model, dtype in SERVE_GRID_RUNS:
        want_launches, want_per_launch = _serve_grid_expected(model, dtype)
        key = f"{model} {dtype}"
        tol = GRID_FP32_TOL if dtype == "float32" else SERVE_GRID_BF16_TOL[model]
        ref_ms, ref_run = serve_ref[key] if model in SERVE_GRID_ALONE else (serve_ref[key], None)
        cfg = _serve_grid_cfg(model, dtype)
        if ref_run is not None:   # the world of one's own dispatch against the grid's
            first = torch.load(GRID_DIR / "round" / f"serve_{model}_{dtype}_rank0.pt")
            for rows, want in ref_run.items():
                # the first step whose input tokens differ (tokens parted a step before)
                inputs = min((next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                                   len(w)) + 1
                              for g, w in zip(first[rows]["tokens"], want["tokens"])),
                             default=len(want["tokens"][0]))
                faults = _routing_faults(want["routing"], want["grid_routing"], cfg.n_layers,
                                         SERVE_GRID_PROMPT, 2 * tol, inputs)
                print(f"serve grid: {key} group {rows}: {len(want['routing'])} dispatch calls "
                      f"in the world of one, replaying the grid's slots, compared before step "
                      f"{inputs}: {len(faults)} differences that no near tie explains",
                      flush=True)
                if faults:
                    raise AssertionError(f"serve grid {key} group {rows}: {'; '.join(faults)}")
            del first
        print(f"serve grid: {key}: {cfg.n_layers} layers, {_serve_new(model)} new tokens; a "
              f"world of one (the whole weights, " + ("a mesh of one process, after the world"
                                                      if ref_run else "no mesh") +
              f") {ref_ms:.1f} ms for both groups; logits held to {tol:.4g}", flush=True)
        for r, (_, _, res) in enumerate(ranks):
            run = res["serve"][key]
            if ref_run is not None:     # the rank's saved tokens and logits
                saved = torch.load(GRID_DIR / "round" / f"serve_{model}_{dtype}_rank{r}.pt")
                run["groups"] = {rows: _serve_grid_against(saved[rows], ref_run[rows])
                                 for rows in ref_run}
            pre = run["measured"]["prefill"]
            per_launch = {k: pre["product_flops"].get(k, 0.0) / max(
                pre["tallied"].get(k, 0), 1) for k in want_per_launch}
            for k in total:
                total[k] += run["launches"][k]
            for rows, group in run["group_launches"].items():
                for k in ("flash_attention_forward", "mamba_scan_forward"):
                    if group[k]:      # rows: a JSON key from the rank's last line
                        at = (k, model, dtype, int(rows))
                        by_shape[at] = by_shape.get(at, 0) + group[k]
            print(f"serve grid: {key} rank {r} {json.dumps(res['coords'])}: blocks "
                  f"{run['blocks_bytes'] / 2**30:.4f} GiB held (built leaf by leaf in "
                  f"{run['build_s']:.2f} s), a prefill's arguments {pre['held_bytes']} B, a "
                  f"decode step's {run['measured']['decode']['held_bytes']} B; both groups in "
                  f"{run['ms']:.1f} ms (eight processes sharing the card); launches "
                  f"{json.dumps(run['launches'])}; product flops a launch "
                  f"{json.dumps(per_launch)}; collectives of a prefill "
                  f"{json.dumps(pre['coll'])} B and of a decode step "
                  f"{json.dumps(run['measured']['decode']['coll'])} B; a prefill "
                  f"{pre['ms']:.1f} ms (its all-to-all {pre['all_to_all_ms']:.1f} ms), a decode "
                  f"step {run['measured']['decode']['ms']:.1f} ms (its all-to-all "
                  f"{run['measured']['decode']['all_to_all_ms']:.1f} ms); against the world of one "
                  f"{json.dumps(run['groups'])}", flush=True)
            bad = []
            for rows, group in run["group_launches"].items():
                if group != want_launches:
                    bad.append(f"{rows} rows: launches {group}, want {want_launches}")
            if per_launch != want_per_launch:
                bad.append(f"product flops a launch {per_launch}, want {want_per_launch} "
                           f"(K3 at {SERVE_GRID_K3.get(model)}, K4 at "
                           f"{SERVE_GRID_K4.get(model)})")
            for rows, g in run["groups"].items():
                if not g["finite"]:
                    bad.append(f"{rows} rows: logits not finite")
                if g["max_rel_diff"] > tol:
                    bad.append(f"{rows} rows: logits differ by {g['max_rel_diff']} > {tol}")
                if dtype == "float32" and not (g["tokens_equal"] and g["compared"] == g["of"]):
                    bad.append(f"{rows} rows: fp32 tokens differ from the world of one's")
            if ref_run is not None and dtype != "float32":   # a bf16 parting: a near tie
                scale = max(1.0, max(w["logits"].abs().max().item() for w in ref_run.values()))
                for rows, want in ref_run.items():
                    for i, tokens in enumerate(saved[rows]["tokens"]):
                        one = {"tokens": [want["tokens"][i]],
                               "logits": want["logits"][:, i:i + 1]}
                        wrong = _near_tie(f"serve grid {key} rank {r} group {rows} row {i}",
                                          tokens, one, scale, tol)
                        if wrong:
                            bad.append(f"{rows} rows, row {i}: {wrong}")
            if bad:
                raise AssertionError(f"serve grid {key} rank {r}: {'; '.join(bad)}")
        GRID_RESULTS["serve"][key] = ranks[0][2]["serve"][key]["measured"]
    print(f"serve grid: {', '.join(f'{m} {dt}' for m, dt in SERVE_GRID_RUNS)} at full width, "
          f"{GRID_LAYERS} layers (dbrx-132b fp32 1, bf16 2), through "
          f"BatchScheduler(mesh=) on every rank's blocks: {SERVE_GRID_ROWS} requests of "
          f"{SERVE_GRID_PROMPT} tokens in one group and {SERVE_GRID_ODD} in another, "
          f"{SERVE_GRID_NEW} new tokens each (dbrx-132b "
          f"{SERVE_GRID_MODEL_NEW['dbrx-132b']}); fp32 tokens equal to the world of one's and "
          f"logits within {GRID_FP32_TOL}, bf16 logits within "
          f"{json.dumps(SERVE_GRID_BF16_TOL)}; launches {json.dumps(total)}", flush=True)
    return total, by_shape


# the dry run's steps held to real ones on the card: (model, kind, sequence,
# batch), each at full width and depth in its config's dtype (bf16)
DRYRUN_STEPS = (("stablelm-3b", "train", 128, 8), ("hymba-1.5b", "prefill", 1280, 4),
                ("qwen3-14b", "prefill", 1280, 4), ("gemma3-27b", "prefill", 1280, 4))
DRYRUN_PEAK_TOL = 0.10       # measured peak against the dry run's, relative
# the dry run's sweeps, each in a child process: (arguments, records).  The
# --federated records at 2 x 16 x 16 run in two children, the archs split
# so that each ends within the single-mesh sweep's time; deepseek-v3-671b's
# are left out here: its dense MoE walks 256 expert blocks a layer at
# 524,288 tokens a pod, and one record's trace outlasts this script's limit
FEDERATED_SWEEPS = (("xlstm-125m", "dbrx-132b", "internvl2-1b"),
                    ("gemma3-27b", "glm4-9b", "hymba-1.5b", "musicgen-large", "qwen3-14b",
                     "stablelm-3b"))
DRYRUN_SWEEPS = [(("--all", "--mesh", "single"), 40)] + [
    (("--federated", "--arch", ",".join(archs)), 2 * len(archs)) for archs in FEDERATED_SWEEPS]
DRYRUN_SWEEP_TIMEOUT = 900


def _sweep_path(i):
    return ROOT / "build" / f"dryrun_sweep{i}.jsonl"


def _start_dryrun_sweep():
    """``python -m repro_torch.launch.dryrun`` with each of ``DRYRUN_SWEEPS``'
    arguments, each in a child process that cannot see the card (the dry
    run needs none), at a lower priority, started early so that their host
    time overlaps the card's phases; ``_dryrun_phase`` waits for them.
    Returns [(process, start)], one a sweep."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    sweeps = []
    for i, (argv, _) in enumerate(DRYRUN_SWEEPS):
        out = _sweep_path(i)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.unlink(missing_ok=True)
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(10))
        atexit.register(lambda p=proc: p.poll() is None and p.kill())  # a failed run too
        sweeps.append((proc, time.perf_counter()))
    return sweeps


def _dryrun_step(device, model, kind, seq, batch):
    """The dry run's prediction for one step (``build_step`` traced on
    ``meta`` tensors on a dry mesh of one: product flops and the peak
    above the arguments), then ``build_step``'s function run on the card
    (a mesh of one) on ``init_params``' weights and ``dummy_batch``'s
    tokens under ``dryrun.count_flops``.  The tallied flops must equal the
    prediction exactly, and the peak (``max_memory_allocated`` over the
    call less what was allocated when it began, the arguments among it)
    must be within ``DRYRUN_PEAK_TOL`` of it.  Returns the kernels'
    launches in the call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_mesh, make_host_mesh
    from repro_torch.models.transformer import init_params

    counters = (flash_attention_forward, flash_attention_backward, mamba_scan_forward,
                mamba_scan_backward)
    cfg = get_config(model)
    tag = f"dryrun {model} {kind} {batch} x {seq}"
    shape = InputShape(f"{kind}_{batch}x{seq}", seq, batch, kind)
    fn, args, _, _ = dryrun.build_step(cfg, make_dry_mesh(), shape)
    pred = dryrun.trace(fn, args)
    print(f"{tag}: predicted {pred['flops']:.6e} flops, peak above the arguments "
          f"{pred['temp'] / 2**30:.3f} GiB (arguments {pred['args'] / 2**30:.3f} GiB), kernel "
          f"launches {json.dumps({k: v['launches'] for k, v in pred['kernel_work'].items()})}, "
          f"traced in {pred['t_trace_s']:.2f} s", flush=True)
    del args
    fn, _, _, _ = dryrun.build_step(cfg, make_host_mesh(), shape)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    data = {k: v.to(device) for k, v in dummy_batch(cfg, batch, seq, seed=0).items()}
    if kind == "prefill":
        data.pop("labels")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    out, flops, tally = dryrun.count_flops(fn, params, data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    launches = {c.__name__: c.launches for c in counters}
    if kind == "train":
        result = out[1]
        ok = result.shape == () and bool(torch.isfinite(result))
    else:
        result = out[0]
        ok = result.shape == (batch, cfg.vocab) and bool(torch.isfinite(result).all())
    rel = (peak - pred["temp"]) / pred["temp"]
    print(f"{tag}: on the card {flops:.6e} flops (tallied; the prediction's "
          f"{pred['flops']:.6e}, equal {flops == pred['flops']}), peak above the arguments "
          f"{peak / 2**30:.3f} GiB ({rel:+.4f} against the prediction; held to "
          f"{DRYRUN_PEAK_TOL}), step {ms:.1f} ms under the flop counter, weights drawn in "
          f"{init_s:.2f} s, launches {json.dumps(launches)}, tallied "
          f"{json.dumps({k: v['launches'] for k, v in tally.kernels.items()})}; output "
          f"{tuple(result.shape)} finite {ok}", flush=True)
    del out, result, params, data
    if flops != pred["flops"]:
        raise AssertionError(f"{tag}: {flops} flops on the card, {pred['flops']} predicted")
    if abs(rel) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"{tag}: peak {peak} B against the predicted {pred['temp']} B")
    if not ok:
        raise AssertionError(f"{tag}: the step's output is not finite or has the wrong shape")
    predicted = {k: v["launches"] for k, v in pred["kernel_work"].items()}
    if {k: v for k, v in launches.items() if v} != predicted or \
            {k: v["launches"] for k, v in tally.kernels.items()} != predicted:
        raise AssertionError(f"{tag}: launches {launches}, tallied {tally.kernels}, predicted "
                             f"{predicted}")
    return launches


DRY_GRID_OUT = ROOT / "build" / "dry_grid.json"


def _dry_grid_predictions() -> dict:
    """The grid round's rank 0, predicted: ``make_federated_round`` traced
    for rank 0 of the dry (pod 2, data 2, model 2) mesh at the grid phase's
    size (``dryrun.build_federated``: ``_grid_cfg(model)`` in each run's
    dtype of ``GRID_MODELS``, ``GRID_STEPS`` local steps of ``ROUND_BATCH``
    sequences a pod, the run's compress bits; the rank's blocks and batch
    share), {"model tag": flops, peak above the arguments, arguments,
    collective bytes, kernel launches, trace seconds}; and under
    "2 x 16 x 16" rank 0 of that mesh at full depth for ``ROUND_MODEL`` at
    bf16 q0, predicted at 16 sequences a pod (which 16 data ranks
    divide)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_mesh

    out = {}
    mesh = make_dry_mesh(GRID_SHAPE["data"], GRID_SHAPE["model"], pod=GRID_SHAPE["pod"])
    for model, (seq, runs) in GRID_MODELS.items():
        for tag, dtype, bits in runs:
            fn, args = dryrun.build_federated(_grid_cfg(model, dtype), mesh, _grid_steps(model),
                                              ROUND_BATCH, seq, bits, lr=ROUND_LR)
            pred = dryrun.trace(fn, args)
            del fn, args
            out[f"{model} {tag}"] = {
                **{k: pred[k] for k in ("flops", "temp", "args", "coll", "t_trace_s")},
                "launches": {k: v["launches"] for k, v in pred["kernel_work"].items()}}
    out["2 x 16 x 16"] = dryrun.run_federated(ROUND_MODEL, ROUND_STEPS, 16, ROUND_SEQ, 0)
    out["serve"] = _dry_serve_predictions(mesh)
    return out


def _dry_serve_predictions(mesh) -> dict:
    """The serve grid's rank 0, predicted on the dry (pod 2, data 2, model 2)
    ``mesh``: for each model and dtype, the ``SERVE_GRID_ROWS`` group's
    prefill (``dryrun.build_step``'s arguments: the rank's blocks and rows;
    traced with the scheduler's cache of ``SERVE_GRID_PROMPT +
    SERVE_GRID_NEW`` positions) and a decode step on that cache's block:
    flops, peak above the arguments, held arguments, ``argument_size``
    (the rank's share of the reference's layout), storage, collective
    bytes, kernel launches."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf

    out = {}
    for model, dtype in SERVE_GRID_RUNS:
        cfg = _serve_grid_cfg(model, dtype)
        max_len = SERVE_GRID_PROMPT + _serve_new(model)
        rec = {}
        for kind, seq in (("prefill", SERVE_GRID_PROMPT), ("decode", max_len)):
            shape = InputShape("serve", seq, SERVE_GRID_ROWS, kind)
            fn, args, _, _ = dryrun.build_step(cfg, mesh, shape)
            if kind == "prefill":
                def fn(p, b, cfg=cfg, max_len=max_len):
                    return tf.prefill(p, cfg, b, max_len, mesh=mesh,
                                      batch_size=SERVE_GRID_ROWS)
            pred = dryrun.trace(fn, args)
            rec[kind] = {
                **{k: pred[k] for k in ("flops", "temp", "coll", "t_trace_s")},
                "held": pred["args"] + pred["scalars"],
                "argument_size": dryrun.argument_size(cfg, mesh, shape),
                "storage": dryrun.step_storage(cfg, mesh, kind),
                "launches": {k: v["launches"] for k, v in pred["kernel_work"].items()}}
        out[f"{model} {dtype}"] = rec
    for model, dtype in SERVE_LONG_RUNS:
        cfg, rec = _serve_long_cfg(model, dtype), {}
        for kind, seq in (("prefill", SERVE_LONG_PROMPT), ("decode", SERVE_LONG_CACHE)):
            shape = InputShape("long", seq, 1, kind)
            fn, args, _, _ = dryrun.build_step(cfg, mesh, shape)
            if kind == "prefill":
                def fn(p, b, cfg=cfg):
                    return tf.prefill(p, cfg, b, SERVE_LONG_CACHE, mesh=mesh, batch_size=1)
            pred = dryrun.trace(fn, args)
            rec[kind] = {
                **{k: pred[k] for k in ("flops", "temp", "coll", "t_trace_s")},
                "held": pred["args"] + pred["scalars"],
                "argument_size": dryrun.argument_size(cfg, mesh, shape),
                "storage": dryrun.step_storage(cfg, mesh, kind),
                "launches": {k: v["launches"] for k, v in pred["kernel_work"].items()}}
        out[f"long {model} {dtype}"] = rec
    return out


def _start_dry_grid():
    """``_dry_grid_predictions`` in a child process of this script
    (``--dry-grid``) that cannot see the card, at a lower priority, started
    with the sweeps; its output to ``DRY_GRID_OUT``.  Returns (process,
    start)."""
    import os

    DRY_GRID_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRY_GRID_OUT.unlink(missing_ok=True)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dry-grid"],
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.nice(10))
    atexit.register(lambda: proc.poll() is None and proc.kill())  # a failed run too
    return proc, time.perf_counter()


def _dry_grid_child() -> int:
    """The ``--dry-grid`` process: ``_dry_grid_predictions`` written to
    ``DRY_GRID_OUT``."""
    sys.path.insert(0, str(ROOT / "src"))
    DRY_GRID_OUT.write_text(json.dumps(_dry_grid_predictions()))
    return 0


def _dry_grid_wait(started) -> dict:
    """``_start_dry_grid``'s predictions, once its process has ended; raises
    if it failed."""
    proc, t = started
    log, _ = proc.communicate(timeout=DRYRUN_SWEEP_TIMEOUT)
    if proc.returncode != 0 or not DRY_GRID_OUT.exists():
        raise AssertionError(f"dryrun: the grid predictions' process failed (exit "
                             f"{proc.returncode}); its output's end:\n{log[-3000:]}")
    print(f"dryrun: the grid rounds predicted in a child process, {time.perf_counter() - t:.1f} s "
          f"wall to this wait (started before the build, at nice 10)", flush=True)
    return json.loads(DRY_GRID_OUT.read_text())


def _dryrun_round(model, tag, preds):
    """The grid round's rank 0 (``preds``: ``_dry_grid_predictions``) held
    to rank 0 of the eight-process world on the card (``GRID_RESULTS``,
    from ``_scaleout_grid_phase``): the tallied flops equal, K1's, K3's and
    K4's launches and the card's tally equal to the prediction, the
    collective bytes by kind equal, the peak above the arguments within
    ``DRYRUN_PEAK_TOL``.  Then (once, for ``ROUND_MODEL`` at bf16 q0) the
    2 x 16 x 16 record's ``argument_size`` and ``argument_size_held``,
    which must be equal.  Launches nothing: the world's launches are the
    grid phase's."""
    seq, runs = GRID_MODELS[model]
    dtype, bits = next((dt, b) for t, dt, b in runs if t == tag)
    card = GRID_RESULTS[model][tag]
    pred = preds[f"{model} {tag}"]
    name = (f"dryrun grid round {model} {GRID_LAYERS} layers {_grid_steps(model)} x "
            f"{ROUND_BATCH} x {seq} {tag}")
    predicted = pred["launches"]
    launched = {k: n for k, n in card["launches"].items() if n}
    rel = (card["peak_bytes"] - pred["temp"]) / pred["temp"]
    print(f"{name}: rank 0 of {GRID_SHAPE}, predicted {pred['flops']:.6e} flops, peak above the "
          f"arguments {pred['temp'] / 2**30:.4f} GiB (arguments {pred['args'] / 2**30:.4f} "
          f"GiB), collectives {json.dumps(pred['coll'])} B, kernel launches "
          f"{json.dumps(predicted)}, traced in {pred['t_trace_s']:.2f} s; rank 0 of the world "
          f"on the card: {card['flops']:.6e} flops (equal {card['flops'] == pred['flops']}), "
          f"peak above the arguments {card['peak_bytes'] / 2**30:.4f} GiB ({rel:+.4f} against "
          f"the prediction; held to {DRYRUN_PEAK_TOL}), held {card['held_bytes'] / 2**30:.4f} "
          f"GiB, collectives {json.dumps(card['coll'])} B (equal "
          f"{card['coll'] == pred['coll']}), launches {json.dumps(launched)}, tallied "
          f"{json.dumps(card['tallied'])}", flush=True)
    if card["flops"] != pred["flops"]:
        raise AssertionError(f"{name}: {card['flops']} flops on the card, {pred['flops']} "
                             f"predicted")
    if card["coll"] != pred["coll"]:
        raise AssertionError(f"{name}: collectives {card['coll']} on the card, {pred['coll']} "
                             f"predicted")
    if launched != predicted or card["tallied"] != predicted:
        raise AssertionError(f"{name}: launches {launched}, tallied {card['tallied']}, "
                             f"predicted {predicted}")
    if abs(rel) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"{name}: peak {card['peak_bytes']} B against the predicted "
                             f"{pred['temp']} B")
    if bits or dtype != "bfloat16" or model != ROUND_MODEL:
        return {}
    rec = preds["2 x 16 x 16"]
    mem = rec["memory"]
    print(f"dryrun grid round {ROUND_MODEL} 2 x 16 x 16 rank 0, {rec['shape']}: storage "
          f"{rec['storage']}, argument_size {mem['argument_size']} B, argument_size_held "
          f"{mem['argument_size_held']} B, temp_size {mem['temp_size'] / 2**30:.3f} GiB, "
          f"{rec['flops']:.6e} flops, collectives {json.dumps(rec['collective_bytes'])} B, "
          f"traced in {rec['t_trace_s']} s", flush=True)
    if mem["argument_size"] != mem["argument_size_held"]:
        raise AssertionError(f"dryrun grid round 2 x 16 x 16: rank 0 holds "
                             f"{mem['argument_size_held']} B, its share is "
                             f"{mem['argument_size']} B")
    return {}


def _dryrun_serve(model, dtype, preds, long=False):
    """The serve grid's rank 0 (``GRID_RESULTS["serve"]``, one prefill and
    one decode step measured on the card) held to its dry trace
    (``_dry_serve_predictions``): held bytes equal to the trace's and to
    ``argument_size``, storage "sharded", flops, collective bytes and K3 /
    K4 launches (and their tally) equal, the peak above the arguments
    within ``DRYRUN_PEAK_TOL``; ``long``: the long request's
    (``GRID_RESULTS["long"]``).  Launches nothing."""
    key = f"long {model} {dtype}" if long else f"{model} {dtype}"
    for kind in ("prefill", "decode"):
        card = (GRID_RESULTS["long"][f"{model} {dtype}"] if long else
                GRID_RESULTS["serve"][key])[kind]
        pred = preds["serve"][key][kind]
        name = f"dryrun serve grid {key} {kind}"
        rel = (card["peak_bytes"] - pred["temp"]) / max(pred["temp"], 1)
        print(f"{name}: rank 0 of {GRID_SHAPE}, predicted (storage {pred['storage']}) "
              f"{pred['flops']:.6e} flops, peak above the arguments {pred['temp']} B, "
              f"arguments held {pred['held']} B of argument_size {pred['argument_size']} B, "
              f"collectives {json.dumps(pred['coll'])} B, launches "
              f"{json.dumps(pred['launches'])}, traced in {pred['t_trace_s']:.2f} s; on the "
              f"card: {card['flops']:.6e} flops, peak above the arguments {card['peak_bytes']} "
              f"B ({rel:+.4f}; held to {DRYRUN_PEAK_TOL}), held {card['held_bytes']} B, "
              f"collectives {json.dumps(card['coll'])} B, launches "
              f"{json.dumps(card['launches'])}, tallied {json.dumps(card['tallied'])}",
              flush=True)
        bad = []
        if pred["storage"] != "sharded":
            bad.append(f"storage {pred['storage']}")
        if not card["held_bytes"] == pred["held"] == pred["argument_size"]:
            bad.append(f"held {card['held_bytes']} B, traced {pred['held']} B, share "
                       f"{pred['argument_size']} B")
        if card["flops"] != pred["flops"]:
            bad.append(f"flops {card['flops']} against {pred['flops']}")
        if card["coll"] != pred["coll"]:
            bad.append(f"collectives {card['coll']} against {pred['coll']}")
        if not card["launches"] == card["tallied"] == pred["launches"]:
            bad.append(f"launches {card['launches']}, tallied {card['tallied']}, predicted "
                       f"{pred['launches']}")
        if abs(rel) > DRYRUN_PEAK_TOL:
            bad.append(f"peak {card['peak_bytes']} B against {pred['temp']} B")
        if bad:
            raise AssertionError(f"{name}: {'; '.join(bad)}")


def _storage_faults(recs) -> list[str]:
    """The records of a sweep whose ``storage`` disagrees with
    ``dryrun.step_storage`` (``shards_storage`` on a grid, for train,
    federated, prefill and decode records, ``long_500k``'s batch of one on
    its sequence blocks among them), or that say "sharded" and hold other
    bytes than their share (``argument_size``: no shape of the sweep
    decodes a batch larger than 1 that the data axes do not divide)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import step_storage
    from repro_torch.launch.mesh import make_production_mesh

    out = []
    for r in recs:
        mesh = make_production_mesh(multi_pod=r["mesh"] == "multi", dry=True)
        want = step_storage(get_config(r["arch"]), mesh, r["kind"], r.get("policy", "baseline"))
        mem = r["memory"]
        if r["storage"] != want or (want == "sharded"
                                    and mem["argument_size_held"] != mem["argument_size"]):
            out.append(f"{r['arch']} {r['shape']} {r['mesh']}: {r['storage']}, held "
                       f"{mem['argument_size_held']} of {mem['argument_size']} B")
    return out


def _dryrun_phase(device, sweeps, dry_grid):
    """The dry run (``repro_torch.launch.dryrun``) against the card: the
    serve grid's prefill and decode on rank 0 (``_dryrun_serve``), each of
    ``DRYRUN_STEPS`` predicted and run (``_dryrun_step``), then the grid
    round of each run of ``GRID_MODELS`` (``_dryrun_round``), on the
    predictions of ``_start_dry_grid``'s process ``dry_grid``; then the
    sweeps that ``_start_dryrun_sweep`` started: their wall times on this
    machine's host, every record OK, and every record "sharded" where
    ``dryrun.step_storage`` says so (train, federated, and prefill and
    decode where the data axes divide the batch) and then holding exactly
    its share (``_storage_faults``).  Returns the kernels' launches in the
    steps (the rounds and the serve grid's checks launch nothing)."""
    t = time.perf_counter()
    preds = _dry_grid_wait(dry_grid)
    total: dict[str, int] = {}
    for model, dtype in SERVE_GRID_RUNS:
        _dryrun_serve(model, dtype, preds)
    for model, dtype in SERVE_LONG_RUNS:
        _dryrun_serve(model, dtype, preds, long=True)
    for launches in [_dryrun_step(device, *step) for step in DRYRUN_STEPS] + [
            _dryrun_round(model, tag, preds) for model, (_, runs) in GRID_MODELS.items()
            for tag, _, _ in runs]:
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    wanted = {"flash_attention_forward", "flash_attention_backward", "mamba_scan_forward"}
    if not all(total.get(k, 0) > 0 for k in wanted):
        raise AssertionError(f"dryrun: a kernel of the path never launched: {total}")
    for i, ((argv, n_records), (proc, started)) in enumerate(zip(DRYRUN_SWEEPS, sweeps)):
        name = " ".join(argv)
        log, _ = proc.communicate(timeout=DRYRUN_SWEEP_TIMEOUT)
        wall = time.perf_counter() - started
        recs = [json.loads(line) for line in _sweep_path(i).read_text().splitlines()]
        failed = [f"{r['arch']} {r['shape']}: {r['error']}" for r in recs if "error" in r]
        traced = sum(r.get("t_trace_s", 0.0) for r in recs)
        meshes = sorted({(r.get("mesh"), r.get("n_devices")) for r in recs}, key=str)
        ended = _sweep_path(i).stat().st_mtime - T0_WALL  # its last record's write
        print(f"dryrun: the {name} sweep in a child process: {len(recs)} records on "
              f"{meshes} (mesh, devices), {len(failed)} failed, {wall:.1f} s wall to this "
              f"wait (started before the build, at nice 10), its last record written "
              f"{ended:.1f} s after the script's start, its traces' t_trace_s summing to "
              f"{traced:.1f} s", flush=True)
        if proc.returncode != 0 or failed or len(recs) != n_records:
            raise AssertionError(f"dryrun {name} sweep: exit {proc.returncode}, {len(recs)} "
                                 f"records, failed {failed}; its output's end:\n{log[-3000:]}")
        wrong = _storage_faults(recs)
        sharded = [f"{r['arch']} {r['shape']}" for r in recs if r["storage"] == "sharded"]
        print(f"dryrun: the {name} sweep's records: {len(sharded)} sharded ({', '.join(sharded)}), "
              f"each where step_storage says so and then holding its share exactly; faults "
              f"{wrong}", flush=True)
        if wrong:
            raise AssertionError(f"dryrun {name} sweep: storage faults {wrong}")
    print(f"dryrun: launches {json.dumps(total)}; phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    return total


# the analysis phase: the paper's configuration driven through two rounds()
# calls of 15 rounds, on the compiled backend and in fused chunks of 5 (the
# budgets of repro_torch.analysis.contracts.drive_twice)
ANALYSIS_RUNS = {"compiled": {"backend": "compiled"},
                 "fused 5": {"backend": "compiled", "fuse_rounds": 5}}
ANALYSIS_ROUNDS = (15, 15)
# fused LM chunks at full width: (tag, model, layers, P), each eager compiled
# and then in fused chunks of 3 (eval_every = 1 ends every chunk after one
# round: round 0 runs eagerly and is captured, rounds 1 and 2 replay it)
FUSED_LM = (("hymba", "hymba-1.5b", 6, 344_430_400),
            ("stablelm", "stablelm-3b", 2, 380_789_760))
FUSED_LM_RUNS = {"compiled": {"backend": "compiled"},
                 "fused 3": {"backend": "compiled", "fuse_rounds": 3}}
FUSED_LM_TOL = 1e-5  # fused against eager compiled params (the CPU test holds 1e-6)


def _analysis_phase(device, families):
    """``repro_torch.analysis`` on the card: the lint over ``src/repro_torch``
    (clean), ``run_contracts`` on the card (every contract passes, none
    skips), the sync and capture budgets at the paper's configuration on
    compiled and fused 5 (K1 in the graphs, K2 at setup), and fused LM
    chunks at full width (``FUSED_LM``: K1, K3 and K4 captured), each
    against its eager compiled run: the same selections, params within
    ``FUSED_LM_TOL``, no synchronizing call in a replay.  ``families`` maps
    each ``FUSED_LM`` tag to its kernel families.  Returns the kernels'
    launches."""
    from repro_torch.analysis import run_lint
    from repro_torch.analysis.contracts import drive_twice, run_contracts
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    t = time.perf_counter()
    lint = run_lint()
    for v in lint.violations:
        print(f"analysis lint: {v}", flush=True)
    print(f"analysis: lint over {lint.files_checked} files of src/repro_torch, "
          f"{len(lint.violations)} violations ({time.perf_counter() - t:.3f} s)", flush=True)
    if not lint.ok:
        raise AssertionError("analysis: the lint found violations")
    t = time.perf_counter()
    report = run_contracts(device)
    for r in report.results:
        print(f"analysis contract: {r}", flush=True)
    bad = [r.name for r in report.results if not report.passed(r)]
    print(f"analysis: {len(report.results)} contracts on {report.device}, "
          f"{sum(r.skipped for r in report.results)} skipped, {len(bad)} failed "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    if not report.ok:
        raise AssertionError(f"analysis: contracts failed or skipped on the card: {bad}")

    launches = {"masked_weighted_sum": 0, "hellinger_strip": 0}
    train, test = _paper_data()
    for tag, kw in ANALYSIS_RUNS.items():
        hellinger_strip.launches = masked_weighted_sum.launches = masked_weighted_sum.captured = 0
        cfg = FLConfig(**(PAPER | {"rounds": sum(ANALYSIS_ROUNDS), "strategy": "fedlecc",
                                   "strategy_kwargs": {"J": 3}} | kw))
        engine = make_engine(cfg, train, test, n_classes=10, device=device)
        t = time.perf_counter()
        out = drive_twice(engine, *ANALYSIS_ROUNDS)
        rec = {k: v for k, v in out.items() if k != "selected"} | {
            "wall_s": time.perf_counter() - t, "k1_launches": _k1_launches(engine),
            "k2_launches": hellinger_strip.launches}
        print(f"analysis paper {tag}: {json.dumps(rec)}", flush=True)
        if (rec["k1_launches"], rec["k2_launches"]) != (cfg.rounds, 1):
            raise AssertionError(f"analysis paper {tag}: K1/K2 launched {rec['k1_launches']}/"
                                 f"{rec['k2_launches']} times; expected {cfg.rounds}/1")
        launches["masked_weighted_sum"] += rec["k1_launches"]
        launches["hellinger_strip"] += rec["k2_launches"]
        if hasattr(engine, "close"):
            engine.close()
        del engine

    for name, model, n_layers, n_params in FUSED_LM:
        runs = {}
        for leg, kw in FUSED_LM_RUNS.items():
            runs[leg] = {}
            got = _lm_main_path(device, f"analysis {name} {leg}", model, n_layers, n_params,
                                families[name], axes=lambda *_, kw=kw: kw, keep=runs[leg])
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
        eager, fused = runs["compiled"], runs["fused 3"]
        same = [r.selected for r in eager["results"]] == [r.selected for r in fused["results"]]
        diff = float((eager["params"] - fused["params"]).abs().max())
        print(f"analysis {name}: fused 3 against eager compiled: the same selections every "
              f"round: {same}, max |params diff| {diff:.3g} (tolerance {FUSED_LM_TOL})",
              flush=True)
        if not (same and diff <= FUSED_LM_TOL):
            raise AssertionError(f"analysis {name}: fused chunks differ from eager compiled")
    print(f"analysis: launches {json.dumps(launches)}", flush=True)
    return launches


def _kernel_only(records) -> None:
    """Phase 6 on ``records`` ({"k1", "k2", "k3", "k4"}: phase 3's records
    of each kernel), each record updated in place."""
    import torch

    device = torch.device("cuda", 0)
    for rec in records["k1"]:
        _reduce_kernel_ms(rec, device)
    for rec in records["k2"]:
        _strip_kernel_ms(rec, device)
    for rec in records["k3"]:
        _flash_kernel_ms(rec, device)
    for rec in records["k4"]:
        _scan_kernel_ms(rec, device)


KERNEL_ONLY_IN, KERNEL_ONLY_OUT = ROOT / "build" / "kernel_only_in.json", \
    ROOT / "build" / "kernel_only_out.json"


def _kernel_only_phase(records) -> None:
    """Phase 6 in a fresh process of this script (``--kernel-only``), which
    loads the libraries phase 2 built: late in a long process, after the
    other phases' profiler sessions, one run's sessions recorded 22 of 30
    launches in every attempt, where a fresh process records all 30 at
    its first.  The records, the profiling attempts and the readings
    below their bound come back through a JSON file."""
    KERNEL_ONLY_IN.write_text(json.dumps(records))
    KERNEL_ONLY_OUT.unlink(missing_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kernel-only"],
                   check=True, timeout=900)
    out = json.loads(KERNEL_ONLY_OUT.read_text())
    for key, recs in records.items():
        recs[:] = out["records"][key]
    PROFILE_TRIES.extend(tuple(t) for t in out["tries"])
    BELOW_BOUND.extend(out["below"])


def _kernel_only_child() -> int:
    """The ``--kernel-only`` process: phase 6 on ``KERNEL_ONLY_IN``'s
    records, written to ``KERNEL_ONLY_OUT``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import pin_fp32_matmul

    torch.cuda.set_device(0)
    pin_fp32_matmul()
    records = json.loads(KERNEL_ONLY_IN.read_text())
    _kernel_only(records)
    KERNEL_ONLY_OUT.write_text(json.dumps({"records": records, "tries": PROFILE_TRIES,
                                           "below": BELOW_BOUND}))
    return 0


def _host_phases(device) -> dict:
    """The paper's classification phases, each on its own engines: the
    presets' comparison, the backends (and the device memory they leave),
    the systems, faults and async grids, checkpoint / resume and the
    population axis.  Returns each phase's launches of K1 (the population
    phase's of K1 and K2)."""
    import torch

    _comparison(device)
    _timeline("comparison")
    mib = lambda: torch.cuda.memory_allocated() / 2**20  # noqa: E731
    before = mib()
    print(f"memory: {before:.2f} MiB allocated before the backends phase", flush=True)
    out = {"backends": _backends(device)}
    _timeline("backends")
    after = mib()
    gc.collect()
    collected = mib()
    print(f"memory: {after:.2f} MiB allocated after the backends phase, {collected:.2f} MiB "
          f"after gc.collect() ({collected - before:+.2f} MiB against before; tolerance 16 MiB)",
          flush=True)
    if not collected - before <= 16:
        raise AssertionError(f"the backends phase left {collected - before:.2f} MiB allocated")
    for key, phase in (("systems", _systems_phase), ("faults", _faults_phase),
                       ("async", _async_phase), ("checkpoint", _checkpoint_phase),
                       ("population", _population_phase)):
        out[key] = phase(device)
        _timeline(f"{key} phase")
    return out


HOST_PHASES_OUT, HOST_PHASES_LOG = ROOT / "build" / "host_phases_out.json", \
    ROOT / "build" / "host_phases.log"
HOST_PHASES_TIMEOUT = 900


def _host_phases_start():
    """``_host_phases`` in a child process of this script (``--host-phases``)
    on the same card, its output to ``HOST_PHASES_LOG``; not waited for."""
    import os

    HOST_PHASES_OUT.parent.mkdir(parents=True, exist_ok=True)
    HOST_PHASES_OUT.unlink(missing_ok=True)
    log = HOST_PHASES_LOG.open("w")
    sys.stdout.flush()
    env = dict(os.environ, CHIP_SMOKE_T0_WALL=repr(T0_WALL))  # one timeline for both
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--host-phases"],
                            stdout=log, stderr=subprocess.STDOUT, text=True, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())  # a failed run too
    return proc, log


def _host_phases_finish(started) -> dict:
    """Waits for ``_host_phases_start``'s process, prints its output and
    returns its launches; raises if it failed."""
    proc, log = started
    try:
        rc = proc.wait(timeout=HOST_PHASES_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log.close()
    text = HOST_PHASES_LOG.read_text()
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    if rc != 0 or not HOST_PHASES_OUT.exists():
        raise AssertionError(f"the classification phases' process failed (exit {rc}); its "
                             f"output's end:\n{text[-3000:]}")
    return json.loads(HOST_PHASES_OUT.read_text())


def _host_phases_child() -> int:
    """The ``--host-phases`` process: ``_host_phases`` on the card, its
    launches written to ``HOST_PHASES_OUT``; its timeline counts from the
    parent's start."""
    import os

    import torch

    global T0
    T0 -= T0_WALL - float(os.environ.get("CHIP_SMOKE_T0_WALL", T0_WALL))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import pin_fp32_matmul

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    pin_fp32_matmul()
    HOST_PHASES_OUT.write_text(json.dumps(_host_phases(device)))
    return 0


T0, T0_WALL = time.perf_counter(), time.time()  # the script's start, for the timeline


def _timeline(label) -> None:
    """One line of the run's timeline: ``label`` ended this many seconds
    after the script started."""
    print(f"timeline: {label} ended {time.perf_counter() - T0:.1f} s after the start", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.kernels import build

    # 1. device
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    pin_fp32_matmul()
    global SMI
    smi = SMI = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"count {torch.cuda.device_count()}", flush=True)

    # the dry run's sweeps and the grid rounds' predictions need neither the
    # card nor the kernels: started first, their host time overlaps the
    # build and every later phase
    sweeps, dry_grid = _start_dryrun_sweep(), _start_dry_grid()

    # 2. build: one nvcc a source, all started together.  K3's source takes
    # longest, so K2, K1 and K4 are built, then held to their plain versions
    # while it compiles; K3's checks wait for it
    t = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    k3_built = pool.submit(build.build, ("flash_attention",))
    others = tuple(n for n in build.SOURCES if n != "flash_attention")
    libs = build.build(others)
    _timeline("build of " + ", ".join(others))
    print(f"build: {time.perf_counter() - t:.2f} s for {len(libs)} sources "
          f"({', '.join(sorted(libs))}) into {build.BUILD_DIR.relative_to(ROOT)}, "
          f"flash_attention compiling beside the checks below", flush=True)

    # 3. kernels against their plain versions
    k2 = [_check_hellinger(s, device) for s in [
        (100, 100, 10), (100, 100, 64), (4096, 16384, 10),
        # the population phase's: k-medoids over 3906 shard summaries (a
        # mean-histogram query, the 61-medoid panel) and a 4096-row strip
        # of the blocked build at K = 10^4
        (1, 3906, 10), (61, 3906, 10), (4096, 10_000, 10)]]
    k1 = [_check_aggregate(s, dt, device)
          for s, dt in [((10, 199_210), torch.float32), ((10, 380_789_760), torch.float32),
                        ((10, 344_430_400), torch.float32), ((10, 119_827_296), torch.float32),
                        ((64, 199_210), torch.bfloat16),
                        ((100, 199_210), torch.float32),   # cohort_gather=False: all K clients
                        # over-selection 1.3 / 1.6: the systems phase's cohorts, and
                        # xlstm's (13, P) one
                        ((13, 199_210), torch.float32), ((16, 199_210), torch.float32),
                        ((13, 119_827_296), torch.float32),
                        # the async runtime's kept deltas: buffer_k = 5 rows
                        ((5, 199_210), torch.float32), ((5, 119_827_296), torch.float32),
                        # the int8 grid round's model blocks of stablelm-3b on the 2 x 16
                        # x 16 mesh (dryrun:, traced): both pods' rows of the embedding's
                        # and head's, an FFN matrix's and an attention matrix's block
                        ((2, 8_048_640), torch.float32), ((2, 1_105_920), torch.float32),
                        ((2, 409_600), torch.float32),
                        # the scaleout grid's largest block, the embedding's and the
                        # head's at model 2: one pod's bf16 row of the exact round,
                        # both pods' int8 rows of the quantized one
                        ((1, 64_389_120), torch.bfloat16), ((2, 64_389_120), torch.float32)]]
    _check_aggregate_nan(device)
    _timeline("K2 and K1 checks")
    k4 = [_check_mamba(s, g, dt, ck, device, fin) for s, g, dt, ck, fin in [
        ((80, 64, 1600, 16), 10, torch.float32, True, False),   # hymba's local SGD: 10 clients
        ((400, 64, 1600, 16), 0, torch.float32, False, False),  # the poll: shared weights
        ((64, 64, 1600, 16), 0, torch.float32, False, False),   # the evaluations
        ((4, 2048, 1600, 16), 0, torch.float32, True, False),
        ((4, 2048, 1600, 16), 0, torch.bfloat16, True, False),
        ((3, 100, 130, 16), 0, torch.float32, True, False),     # ragged D and S
        # the serving prefill: fp32 inputs (a bf16 model discretises in fp32)
        # and the final state
        ((4, 128, 1600, 16), 0, torch.float32, False, True),
        ((4, 1280, 1600, 16), 0, torch.float32, False, True),
        # the training launcher on hymba: batch 8 of 128, checkpoints kept
        ((8, 128, 1600, 16), 0, torch.float32, True, False),
        # the scaleout grid's rank: its 800 of hymba's 1600 channels at model 2,
        # its 4-sequence data share, checkpoints kept (GRID_K4)
        (GRID_K4["hymba-1.5b"], 0, torch.float32, True, False),
        # the serve grid's prefill on a rank: the same channels, its 2 rows of
        # the 8-row group and all 3 of the 3-row one, with the final state
        # (fp32 inputs in either dtype)
        *((shape, 0, torch.float32, False, True)
          for shape in SERVE_GRID_K4["hymba-1.5b"].values()),
        # the long request's prefill on a grid rank: batch 1 of 2048 on the
        # same channels, with the final state (SERVE_LONG_K4)
        *((shape, 0, torch.float32, False, True) for shape in SERVE_LONG_K4.values()),
    ]]
    _timeline("K4 checks")
    libs |= k3_built.result()
    pool.shutdown()
    _timeline("build of flash_attention")
    print(f"build: flash_attention built {time.perf_counter() - t:.2f} s after the build began",
          flush=True)
    k3 = [_check_flash(s, dt, w, ig, device) for s, dt, w, ig in [
        ((80, 64, 32, 32, 80), torch.float32, 0, 1.0),     # local SGD: m x batch sequences
        ((80, 64, 32, 32, 80), torch.bfloat16, 0, 1.0),
        ((400, 64, 32, 32, 80), torch.float32, 0, 1.0),    # the poll: K x eval_samples
        ((4, 2048, 32, 32, 80), torch.float32, 0, 1.0),
        ((4, 2048, 32, 32, 80), torch.bfloat16, 0, 1.0),
        ((2, 1024, 8, 2, 128), torch.float32, 256, 0.0),   # GQA, sliding window
        ((80, 64, 25, 5, 64), torch.float32, 1024, 0.0),   # hymba's local SGD (GQA group 5)
        ((4, 2048, 25, 5, 64), torch.float32, 1024, 0.0),  # hymba's window where it bites
        # the serving prefill in bf16: stablelm, hymba (local layers), qwen3,
        # and deepseek-v3's MLA at D = 128 + 64 (the DMAX-256 template)
        *(((4, s, h, kv, d), torch.bfloat16, w, ig) for s in SERVE_PROMPTS
          for h, kv, d, w, ig in ((32, 32, 80, 0, 1.0), (25, 5, 64, 1024, 0.0),
                                  (40, 8, 128, 0, 1.0), (128, 128, 192, 0, 1.0))),
        ((2, 256, 16, 16, 192), torch.bfloat16, 0, 1.0),   # D = 192 backward
        # gemma3-27b's prefill at its full depth in the dryrun phase: local
        # layers (window 1024) and global ones (the window off by is_global)
        ((4, 1280, 32, 16, 128), torch.bfloat16, 1024, 0.0),
        ((4, 1280, 32, 16, 128), torch.bfloat16, 1024, 1.0),
        # dbrx-132b's prefill (GQA 48 / 8 kv, D = 128) on the capacity path, and
        # its launcher step, the first D = 128 backward on a path
        *(((4, s, 48, 8, 128), torch.bfloat16, 0, 1.0) for s in SERVE_PROMPTS),
        (DBRX_STEP_SHAPE, torch.bfloat16, 0, 1.0),
        # the frame and patch prompts in bf16: musicgen-large (MHA, D = 64)
        # and internvl2-1b (GQA group 7), at both of each model's lengths
        *(((4, s, h, kv, 64), torch.bfloat16, 0, 1.0) for model, (h, kv) in
          (("musicgen-large", (32, 32)), ("internvl2-1b", (14, 2)))
          for s in MODAL_PROMPTS[model]),
        # the training launcher in bf16: stablelm, hymba (local layers)
        ((8, 128, 32, 32, 80), torch.bfloat16, 0, 1.0),
        # the scaleout grid's rank at model 2, data 2: stablelm's 16 heads of
        # its 4-sequence share, in bf16 and fp32
        ((4, 128, 16, 16, 80), torch.bfloat16, 0, 1.0),
        ((4, 128, 16, 16, 80), torch.float32, 0, 1.0),
        ((8, 128, 25, 5, 64), torch.bfloat16, 1024, 0.0),
        # the grid's other models at model 2, a rank's 4-sequence share:
        # hymba's 25 / 5 kv heads replicated (local layers), in bf16 and fp32;
        # musicgen's 16 heads and internvl2's 7 / 1 kv of 384 positions in fp32
        ((4, 128, 25, 5, 64), torch.bfloat16, 1024, 0.0),
        ((4, 128, 25, 5, 64), torch.float32, 1024, 0.0),
        ((4, 128, 16, 16, 64), torch.float32, 0, 1.0),
        ((4, 384, 7, 1, 64), torch.float32, 0, 1.0),
        # the serve grid's prefill on a rank in each of its types: stablelm's
        # 16 heads, hymba's 25 / 5 kv replicated (local layers) and dbrx's 24 /
        # 4 kv (bf16), its 2 rows of the 8-row group and all 3 of the 3-row
        # one (SERVE_GRID_K3)
        *((shape, getattr(torch, dt), SERVE_GRID_WINDOW[model],
           0.0 if SERVE_GRID_WINDOW[model] else 1.0)
          for model, dt in SERVE_GRID_RUNS if model in SERVE_GRID_K3
          for shape in SERVE_GRID_K3[model].values()),
        # the long request's prefill on a grid rank, batch 1 of 2048, in each
        # run's type: stablelm+swa4k's 16 heads (its window of 4096 on every
        # layer) and hymba's 25 / 5 kv replicated (local layers) (SERVE_LONG_K3)
        *((SERVE_LONG_K3[model][0], getattr(torch, dtype), SERVE_LONG_K3[model][1], 0.0)
          for model, dtype in SERVE_LONG_RUNS),
    ]]
    _timeline("K3 checks")
    print("kernels: hellinger_strip, masked_weighted_sum, flash_attention and mamba_scan "
          "(forward and backward) passed at every shape above", flush=True)
    torch.cuda.empty_cache()

    # 4. main paths: the paper's classification experiment, then LM training
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward

    # K3's forward, dQ and dK/dV kernels; K4's scan kernels and the second
    # pass of its backward (a word boundary keeps scan_fwd_kernel out of K3)
    attention = (flash_attention_forward, flash_attention_backward,
                 re.compile(r"\b(?:fwd|dq|dkdv)_kernel\b"))
    scan = (mamba_scan_forward, mamba_scan_backward,
            re.compile(f"{SCAN_FORWARD.pattern}|{SCAN_BACKWARD.pattern}"))
    launches = _main_path(device)
    _timeline("main_path")
    # the paper's classification phases, host-bound (a round of ~16 ms on a
    # 199,210-parameter MLP), in a child process beside the LM phases below
    host = _host_phases_start()
    lm_launches = _lm_main_path(device, "lm", "stablelm-3b", 2, 380_789_760, (attention,))
    _timeline("lm_main_path lm")
    hymba_launches = _lm_main_path(device, "hymba", "hymba-1.5b", 6, 344_430_400,
                                   (attention, scan))
    _timeline("lm_main_path hymba")
    xlstm_launches = _lm_main_path(device, "xlstm", "xlstm-125m", 12, 119_827_296, (),
                                   save_probe=True)
    _timeline("lm_main_path xlstm")
    xlstm_axes_launches = _lm_main_path(device, "xlstm systems+faults", "xlstm-125m", 12,
                                        119_827_296, (), axes=_xlstm_axes)
    _timeline("lm_main_path xlstm systems+faults")
    _gate_kernel_ms(device, 13, 119_827_296)
    _timeline("gate_kernel_ms")
    xlstm_async_launches = _lm_main_path(device, "xlstm async", "xlstm-125m", 12, 119_827_296,
                                         (), axes=_xlstm_async)
    _timeline("lm_main_path xlstm async")
    serve_launches = _serve_phase(device)
    _timeline("serve_phase")
    moe_mesh_launches = _moe_mesh_phase(device)
    _timeline("moe_mesh_phase")
    train_launches = _train_phase(device)
    _timeline("train_phase")
    scaleout_launches = _scaleout_phase(device)
    _timeline("scaleout_phase")
    grid_launches = _scaleout_grid_phase(device)
    _timeline("scaleout_grid_phase")
    dryrun_launches = _dryrun_phase(device, sweeps, dry_grid)
    _timeline("dryrun_phase")
    analysis_launches = _analysis_phase(device, {"hymba": (attention, scan),
                                                 "stablelm": (attention,)})
    _timeline("analysis_phase")

    # 5. small-input agreement with the CPU path
    _agreement(device)
    _timeline("agreement")
    _lm_agreement(device, "lm", LM_MICRO)
    _timeline("lm_agreement lm")
    _lm_agreement(device, "hymba", HYMBA_MICRO)
    _timeline("lm_agreement hymba")
    _lm_agreement(device, "xlstm", XLSTM_MICRO, seq=128, resync=True, max_steps=1)
    _timeline("lm_agreement xlstm")
    _lm_agreement(device, "xlstm systems+faults", XLSTM_MICRO, seq=128, resync=True,
                  max_steps=1, axes=XLSTM_MICRO_AXES)
    _timeline("lm_agreement xlstm systems+faults")
    _async_agreement(device)
    _timeline("async_agreement")
    for tag, task_kwargs in DENSE_REDUCED.items():
        _lm_agreement(device, tag, task_kwargs)
    _timeline("lm agreement (dense reduced)")
    _train_agreement(device)
    _timeline("train_agreement")

    host = _host_phases_finish(host)
    _timeline("host phases joined")
    backend_k1, systems_k1, faults_k1, async_k1, checkpoint_k1, population = (
        host[k] for k in ("backends", "systems", "faults", "async", "checkpoint", "population"))

    # 6. the kernels' own device time, after every host-timed phase
    _kernel_only_phase({"k1": k1, "k2": k2, "k3": k3, "k4": k4})
    _timeline("kernel_only_phase")
    retried = [t for t in PROFILE_TRIES if t[1] > 1]
    print(f"kernel-only: {len(PROFILE_TRIES)} readings, {len(retried)} of them profiled more "
          f"than once; attempts a reading {json.dumps([n for _, n in PROFILE_TRIES])}; retried "
          f"{json.dumps(retried)}", flush=True)
    if BELOW_BOUND:
        raise AssertionError(f"kernel-only readings below their bound: {BELOW_BOUND}")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "hellinger_strip", "route": "cuda",
         "source": "src/repro_torch/csrc/hellinger_strip.cu",
         "replaces": "src/repro/kernels/hellinger/kernel.py:38",
         "launches": (launches["hellinger_strip"] + population["hellinger_strip"]
                      + scaleout_launches["hellinger_strip"]
                      + analysis_launches["hellinger_strip"]),
         "shape": k2[0]["shape"],
         **{k: k2[0][k] for k in keys + ("kernel_ms", "library_kernel_ms")}},
        {"name": "masked_weighted_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/fedavg_reduce.cu",
         "replaces": "src/repro/kernels/aggregate/kernel.py:29",
         "launches": (launches["masked_weighted_sum"] + backend_k1 + systems_k1 + faults_k1
                      + async_k1 + checkpoint_k1 + population["masked_weighted_sum"]
                      + xlstm_async_launches["masked_weighted_sum"]
                      + lm_launches["masked_weighted_sum"]
                      + xlstm_axes_launches["masked_weighted_sum"]
                      + hymba_launches["masked_weighted_sum"]
                      + xlstm_launches["masked_weighted_sum"]
                      + scaleout_launches["masked_weighted_sum"]
                      + grid_launches["masked_weighted_sum"]
                      + analysis_launches["masked_weighted_sum"]),
         "shape": k1[0]["shape"],
         **{k: k1[0][k] for k in keys + ("kernel_ms", "library_kernel_ms")}},
    ] + [
        {"name": f"flash_attention_{direction}", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
         "launches": lm_launches[f"flash_attention_{direction}"]
         + serve_launches.get(f"flash_attention_{direction}", 0)
         + moe_mesh_launches[f"flash_attention_{direction}"]
         + train_launches[f"flash_attention_{direction}"]
         + scaleout_launches[f"flash_attention_{direction}"]
         + dryrun_launches[f"flash_attention_{direction}"]
         + grid_launches[f"flash_attention_{direction}"]
         + analysis_launches[f"flash_attention_{direction}"], "shape": k3[0]["shape"],
         **{k: k3[0][direction][k] for k in keys + ("kernel_ms",)}}
        for direction in ("forward", "backward")
    ] + [
        # K3's backward at the dbrx step's shape, launched by that step alone
        {"name": "flash_attention_backward_d128", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
         "launches": moe_mesh_launches["train_backward"], "shape": rec["shape"],
         **{k: rec["backward"][k] for k in keys + ("kernel_ms",)}}
        for rec in k3 if tuple(rec["shape"]) == DBRX_STEP_SHAPE
    ] + [
        {"name": f"mamba_scan_{direction}", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:69",
         "launches": hymba_launches[f"mamba_scan_{direction}"]
         + serve_launches.get(f"mamba_scan_{direction}", 0)
         + train_launches[f"mamba_scan_{direction}"]
         + dryrun_launches[f"mamba_scan_{direction}"]
         + grid_launches[f"mamba_scan_{direction}"]
         + analysis_launches[f"mamba_scan_{direction}"], "shape": k4[0]["shape"],
         **{k: k4[0][direction][k] for k in keys + ("kernel_ms",)}}
        for direction in ("forward", "backward")
    ] + [
        # K4 on a grid rank's channel block, launched by the scaleout grid alone
        {"name": f"mamba_scan_{direction}_grid", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:69",
         "launches": grid_launches["rounds"][f"mamba_scan_{direction}"],
         "shape": rec["shape"],
         **{k: rec[direction][k] for k in keys + ("kernel_ms",)}}
        for rec in k4 if tuple(rec["shape"]) == GRID_K4["hymba-1.5b"]
        for direction in ("forward", "backward")
    ] + [
        # K3 and K4 forward in the serve grid's prefill, one entry a shape and
        # type a rank hands them, each with the serve grid's launches there
        # (hymba's first layer global, the others local: the same work at 128
        # positions; K4 takes fp32 inputs in either model type)
        {"name": f"{kernel}_serve_grid_{model}_{dtype}_b{shape[0]}", "route": "cuda",
         "source": source, "replaces": replaces,
         "launches": sum(grid_launches["serve_by_shape"].get((kernel, model, dt, rows), 0)
                         for dt in dtypes),
         "shape": rec["shape"], **{k: rec["forward"][k] for k in keys + ("kernel_ms",)
                                   if k in rec["forward"]}}
        for kernel, source, replaces, recs, shapes, window, dt_pairs in (
            ("flash_attention_forward", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:68", k3,
             {m: SERVE_GRID_K3[m] for m in SERVE_GRID_K3}, SERVE_GRID_WINDOW,
             [(dt, (dt,)) for dt in SERVE_GRID_DTYPES]),
            ("mamba_scan_forward", "src/repro_torch/csrc/mamba_scan.cu",
             "src/repro/kernels/mamba_scan/kernel.py:69", k4, SERVE_GRID_K4, None,
             [("float32", SERVE_GRID_DTYPES)]))
        for model, by_rows in shapes.items()
        for rows, shape in by_rows.items()
        for dtype, dtypes in dt_pairs
        for rec in recs if tuple(rec["shape"]) == shape and rec["dtype"] == dtype
        and (rec.get("final_state") if window is None else rec["window"] == window[model])
    ] + [
        # K3 and K4 forward in the long request's prefill on a grid rank, each
        # with the long request's launches (hymba's first layer global, the
        # others local), a run's K3 at its type (K4 takes fp32 inputs in
        # either type); the fp32 run's entries named for it
        {"name": f"{kernel}_serve_long_{model}" + ("" if dtype == "bfloat16" else f"_{dtype}"),
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": grid_launches["serve_long"].get((kernel, f"{model} {dtype}"), 0),
         "shape": rec["shape"], **{k: rec["forward"][k] for k in keys + ("kernel_ms",)
                                   if k in rec["forward"]}}
        for kernel, source, replaces, recs, shapes in (
            ("flash_attention_forward", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:68", k3,
             {m: shape for m, (shape, _) in SERVE_LONG_K3.items()}),
            ("mamba_scan_forward", "src/repro_torch/csrc/mamba_scan.cu",
             "src/repro/kernels/mamba_scan/kernel.py:69", k4, SERVE_LONG_K4))
        for model, dtype in SERVE_LONG_RUNS if model in shapes
        for rec in recs if tuple(rec["shape"]) == shapes[model]
        and (rec.get("final_state") if kernel == "mamba_scan_forward" else
             rec["dtype"] == dtype and rec["window"] == SERVE_LONG_K3[model][1])
    ]
    print(smi, flush=True)  # again, so that the end of the output names the card
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-child"]:
        sys.exit(_grid_child_main())
    if sys.argv[1:] == ["--host-phases"]:
        sys.exit(_host_phases_child())
    if sys.argv[1:] == ["--dry-grid"]:
        sys.exit(_dry_grid_child())
    sys.exit(_kernel_only_child() if sys.argv[1:] == ["--kernel-only"] else main())
