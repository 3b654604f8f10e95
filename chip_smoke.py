#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card:

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, all started together, into ``build/kernels/``), then runs
fifteen phases on one card, phases 1-4, 7, 9 (b) and 10 at the paper's
full GraphSAGE width (128 -> 256 -> 256 -> 172, fanouts 5/10/15), phases
5-6 at its full GAT width (128 -> 4 heads x 256 -> 4 heads x 256 -> 172,
one head at the last layer), phases 8 and 9 (c) at both, phase 13 at
the reference dry run's (128 -> 256 -> 16, fanouts 5/10) and phases 14
and 15, LM serving and training, at the transformer configs' published
widths.  A CPU worker (``CpuWorker``, one child process with
``CPU_WORKER_THREADS`` torch threads, started after the build) runs the
CPU halves of phases 4 (c) and 6 (c), and all of phases 9 (c), 14 (a)'s
float32 units and 15 (a), beside the card phases of this process; phase
15 (b) and (c) run their CPU halves in processes beside phase 14 (b) and
(c).  Each phase's seconds are printed as it ends and, before the
``kernels`` line, as one JSON line ``{"phase_seconds": {...}, "build_s",
"total_s", "host_cpus"}`` (the worker's jobs by their own seconds).

Depth cut to keep the script within two thirds of its time limit (seconds
on one H100 80GB HBM3 at 700 W, before -> after, in ``PERF.md`` §7), with
every check kept: phase 12 (a) runs on a ``P12_VERTICES`` = 180,000-vertex
graph (5 steps an epoch, not 11) with ``P12_HEC_SIZE`` = 131,072 HEC lines
(not 262,144), its fresh-process resume beside runs (2)-(4); phase 6 (c)'s
check HEC is 262,144 entries (not 524,288) and its CPU half and float64
witness run in the CPU worker, as do phase 4 (c)'s CPU half, phase 9
(c) and phase 14 (a)'s float32 units; phases 11 (b) and 12 (b) run right
after phase 6, so that the GAT runs at a 1M-entry HEC are done before
the worker's card runs begin.

  1. kernels vs plain versions: each kernel's wrapper against its plain
     PyTorch version on the same inputs — the serve layer at the three
     layer shapes of a real microbatch (64 slots), at the three offline
     pre-warm chunk shapes of the main path's graph (2048 dst rows with
     ``self_idx``, full neighbor lists) and at a ragged shape, the HEC
     probe + load on a half-full cache with hits, misses, negative vids
     and full sets — and the time of each, with its bound (the serve
     layer's with the form it took, its 3xTF32 and FFMA bounds and a
     float32 ``addmm`` yardstick of its products);
  2. exactness: sampled serving on a low-degree graph with fanouts >= its
     max degree (sampling is then exact) against offline embeddings
     computed by the plain versions on the card, cold and pre-warmed;
  3. the main path: the ``repro_torch.launch.gnn_serve`` flow with
     ``--preset graphsage-papers100m --slots 64`` (cold pass, offline
     pre-warm, warm pass), with every launch count set to 0 just before
     and read just after; every offline embedding the pre-warm computed
     is then held against the plain version, chunk by chunk on the same
     inputs;
  4. training, the second main path: (b) ``repro_torch.launch.train gnn``
     in ``aep`` mode, 4 ranks on the card, batch 1000, HEC 1M entries x 8
     ways per layer, nc 2000, one epoch on a 400,000-vertex synthetic
     graph (10 steps per rank) and ``evaluate``, with every launch count
     set to 0 just before and read just after; (a) the UPDATE and AGG
     kernels, forward and backward (C-F), against their plain versions at
     the layer shapes of that run's minibatches and at a ragged shape, and
     the HEC probe at the training lookup shapes on the run's own caches,
     timed with their bounds, C with its 3xTF32 and FFMA bounds and a
     float32 ``addmm`` yardstick, E with the form it took (rows and
     column slice a warp) and an ``embedding_bag`` yardstick, D's ``db``
     bit-equal over two calls, C bit-equal to its pinned outputs
     (``C_PINNED``) and E to its first design's (``E_PINNED``: layer 0,
     the offline width of 77 slots at D 256, and a ragged D = 6 on the
     scalar path); (c) the first two steps of (b), from
     the same state (the reference's initial weights) and minibatches,
     once more on the card and on the CPU through the plain versions,
     each drawing the reference's selection uniforms (the card's draw
     held bit-equal to the CPU's, and timed): loss, gradients (Adam's
     first moment), pushed tags and HEC tags held against each other;
  5. GAT serving, a third main path: the ``gnn_serve`` flow with ``--model
     gat --preset gat-papers100m --slots 64`` on phase 3's graph (cold
     pass, offline pre-warm through the GAT AGG kernel G with ``dst_idx``,
     warm pass), with every launch count set to 0 just before and read
     just after (G exactly 3 per microbatch and 3 per offline chunk
     column); every offline layer is then held against the plain version
     on the kernel's own input, and G and the HEC probe are timed at the
     path's shapes;
  6. GAT training, the fourth main path: (b) ``launch/train.py gnn --model
     gat`` with phase 4's graph and settings (lr 0.001, the paper's HEC of
     ``GAT_HEC_SIZE`` = 1M entries per layer), launch counts exact (per
     step G and H 3 per rank, per eval batch G 3 per rank), peak memory
     printed; (a) G and H against their plain versions at rank 0's
     three layer shapes and at ragged shapes (an all-masked row; G's
     column-split form at 45 rows and its chunked form at 400 slots),
     each G row printed with the form it took, and the HEC probe B bit
     for bit on (b)'s own 1M-entry caches at rank 0's three layers (the
     main path's HEC geometry, which (c) does not reach), timed with their
     bounds; (c) the first two steps on
     the card and on the CPU, as phase 4 (c), at batch
     ``GAT_CHECK_BATCH`` = 256 (a CPU step at batch 1000 takes over 60
     s) with a HEC of ``GAT_CHECK_HEC_SIZE`` = 262,144 entries (the
     CPU's copy), and every gradient tensor against a float64 witness of
     the first step, which alone holds layer 0's ``a_u`` and ``a_v``; the
     card's and the CPU's ReLU branches pinned to the exact ones in both
     (a few float32 pre-activations within rounding of zero take the
     other branch by chance, ``ExactReluBranches``); with a traced card
     step;
  7. device-drawn training, the fifth main path: (b) ``DistTrainer.
     train_epochs`` for two epochs and ``evaluate`` on phase 4's graph,
     data and settings with ``SamplerConfig(device_draw=True,
     policy="cv")`` (the launcher has no flag for it, as the reference's
     has none), so epoch 1 draws with weights from the live HEC tags;
     launch counts exact (the fanout draw I 3 per rank per step and per
     eval batch, C-F and B as in phase 4), and the host ``sample`` ms per
     step printed beside phase 4's host draw; (a) I against its plain
     version, bit for bit, at the three layer shapes of the path's first
     minibatch on rank 0's partition under all three policies and at
     ragged shapes (-1 rows, halos, ``allow=False``, ``deg == f`` and
     ``deg < f``, a multi-edge row, width < f, n off a multiple of 32),
     each timed with its bound and printed with its tile size, each layer
     shape also with only its take-all (and empty) rows allowed and with
     only its selection rows allowed; (c) the minibatches of (b)'s first two
     steps and of epoch 1's first, drawn again on the card and on the CPU
     through the plain draw: every ``stack_ranks`` array equal; and the
     host draw's share of a host-drawn ``sample_host`` of the first step;
  8. sharded serving, the sixth and seventh main paths: (b) the
     ``repro_torch.launch.gnn_serve_dist`` flow at its defaults (4 ranks
     on the card, slots 32, halo slots 256, cache 65,536 x 8 per layer
     and rank, degree pre-warm of a quarter, hot tier 2,048, dedup, round
     batch 4, 1,024 queries with half repeats) on phase 3's graph cut
     into 4 shards, ``--preset graphsage-papers100m`` and then
     ``--preset gat-papers100m``, with every launch count set to 0 just
     before and read just after: A or G R x L per round and L per offline
     chunk of each shard, B R x L per round and R per fast-path batch, J
     L - 1 per round; (a) the batched probe J against its plain version,
     bit for bit, on the run's own caches with each hidden layer's last
     request buffer (4 responders x 4 requesters x 1,024 slots, d 256 and
     1,024) and at a ragged shape (n 77, d 172, negative vids, a dead
     responder), B at the shard lookups' shapes and the forward kernel at
     rank 0's layer shapes of a round, each timed with its bound; (c) the
     flow's first two rounds, each from the state before it, once more
     on the CPU through the plain versions (answers within tolerance,
     every shard's cache tags and the hot-tier ages equal), and sharded
     serving of both models on phase 2's low-degree graph with the hidden
     layers warmed, against offline embeddings computed by the plain
     versions on the whole graph;
  9. the trainer's other modes, the eighth to tenth main paths: (b)
     ``launch/train.py gnn --mode sync`` and ``--mode drop`` with phase
     4's graph (built once for phases 4, 6, 7 and 9: ``ReuseGraphs``) and
     settings, one epoch and ``evaluate`` each, launch counts exact (per
     step C, D and E 3 per rank, F 2 per rank, no HEC probe; per eval
     batch C and E 3 per rank), then one ``aep`` epoch with the hot tier
     (``HOT_SIZE`` = 1,024 slots, ``HOT_BUDGET`` = 512 rows a rank and
     step) through ``DistTrainer.train_epochs`` and ``evaluate``, with
     phase 4's launch counts, no undersized-budget warning and hot hits;
     per run s/epoch, spans, accuracy, hit rates and peak memory; (c) the
     first two steps of ``sync``, ``drop`` and ``aep`` with the tier, both
     models, on a ``CHECK_VERTICES`` = 20,000-vertex graph at batch
     ``CHECK_BATCH`` = 64, on the CPU and on the card, each card step from
     the CPU's state before it (GAT's ReLU branches pinned): per step loss,
     gradient norm and gradient within 1e-4 relative (GAT's layer-0
     attention vectors at step 0 against a float64 witness, as phase 6
     (c)), every HEC tag, queued and hot tag, slot age, sync ``got`` mask
     and fetched row equal; and a free card run, its loss and gradient
     norm within ``FREE_RUN_TOL`` = 1e-3 of the CPU's at every step;
 10. the minibatch pipeline, the push on its side stream and the trace,
     the eleventh to fourteenth main paths: four epochs of
     ``launch/train.py gnn`` at phase 4's graph and settings with
     ``--trace-out``, ``--metrics-out`` and ``--prom-out`` (written under
     ``build/phase10/``), each with phase 4's launch counts: (a) the
     default (``MinibatchPipeline``: pinned batches, copies on a copy
     stream one batch ahead, the push on its side stream) against
     ``PipelineConfig(double_buffer=False)``: the same bits at every
     step (HEC tag and age digests, every metric), in the epoch's loss
     and in the parameters, and from the trace the share of the H2D copy time beside
     main-stream kernels and the ``stage`` ms per step; (b) the
     default against ``DistTrainer(overlap=False)`` (the push inline
     after the backward): the same checks, push-stream kernels (the
     uniforms' elementwise ones among them) running beside the main
     stream's, the measured overlap share beside ``obs.StepModel``'s, the
     ``step`` ms and device busy share of both; (c) ``train_epochs(
     pipeline=None)`` (the reference's per-row sampler) at phase 9 (c)'s
     size, on the CPU and on the card, each card step from the CPU's
     state held as phase 9 (c) holds it; (d) every run's trace passes
     ``validate_chrome_trace`` with ``sample``/``host_prep`` on a prefetch
     thread, ``stage``/``step`` on the main thread and device tracks for
     at least two streams, every JSONL line parses, the Prometheus file
     has ``phase_seconds`` of the four phases, the ``EpochBreakdown``
     table prints; (e) one epoch at ``P10_WORKERS`` = 4 prefetch workers,
     its ``sample`` ms and s/epoch beside (a)'s, the same bits as (a);
 11. reproducible training and the health and quality planes, the
     fifteenth to eighteenth main paths: (a) the first ``P11_STEPS`` = 4
     steps of phase 4's GraphSAGE training through ``DistTrainer.
     train_epochs``, three times from the same state: twice with both
     planes off, once with both on and an audit after the epoch (flight
     files under ``build/phase11/``); the three runs agree bit for bit in
     every step's metrics, the epoch's loss, the parameters, every HEC's
     tags, ages and values and the queued pushes, launch counts exact
     (the "on" run adds only the audit's offline pass, A L times a chunk
     of each shard); the rank series, the audit's per-layer error and its
     time printed; (b) the same for GAT at phase 6's settings (the audit
     through G); (c) phases 3 and 8's GraphSAGE serving launchers with
     ``--audit-interval 1`` and an SLO of 1 ns: every answer bit-equal to
     phases 3 and 8's (quality plane off), the single-rank cache warmed
     from the offline rows and the shards warmed from the sharded offline
     pass (the hot replicas too) audit to exactly 0.0, and the SLO burn's
     ``FLIGHT_slo_burn.json`` parses; (d) F and H on collision-heavy
     inputs at training widths (a source row 5,000 slots point at, one of
     ``CHUNK`` + 1, -1 pads, indices past N): three launches bit-equal,
     within tolerance of the plain versions in float64 (a 5,000-term
     float32 sum parts from the exact one by ~1e-4 in any order), F the
     plain version's bits on its rows of at most ``CHUNK`` slots;
 12. the resilience plane, the nineteenth to twenty-second main paths:
     (0) kernels C, A, E, G and H on NaN rows (E also on +-inf) at the
     paths' layer shapes (``P12_NAN_SHAPES``), valid and invalid sources
     and row 0 (which every pad reads) poisoned: NaN exactly where the
     plain versions have it, elsewhere within tolerance (C's dZ and E's
     counts bit for bit; H on a fanout whose every slot is included); (a)
     GraphSAGE at phase 4's widths and settings on a ``P12_VERTICES`` =
     180,000-vertex graph (5 steps an epoch), ``P12_EPOCHS`` = 3 epochs a
     run, the HEC cut to ``P12_HEC_SIZE`` = 131,072 lines x 8 ways per
     layer and rank (a whole-state archive of 1.4 GB, not 10.2):
     unarmed (checkpointed after epoch 1), armed with ``nan_guard`` and no
     fault (the same SHA-256 of the checkpoint leaves, metrics and
     launches), the chaos schedule ``P12_CHAOS`` twice (the same bits,
     steps skipped, four events, parameters finite, Adam's count short by
     the skips, ``FLIGHT_resilience.json``), ``kill_prefetch`` at (0, 1)
     (one retry, epoch 0's bits) and a fresh ``python`` process that
     restores the checkpoint and trains epoch 2 (the unarmed run's bits);
     the archive's bytes and the save and restore seconds printed; (b)
     GAT at phase 11 (b)'s four steps: armed and clean against unarmed
     bit for bit, a ``nan_step`` at ``P12_GAT_NAN`` skipped with finite
     parameters; (c) phase 8's sharded flow of both models with
     ``failover=True`` and every rank alive: phase 8's answers and
     launches; then on phase 8 (c)'s exactness graph rank 1 marked dead
     with a failing probe (its hub queries the offline rows bit for bit,
     its cold ones zeros, ``serve_degraded`` 1, J run with rank 1 masked
     and held bit for bit to its plain version), and a passing probe:
     rank 1's queries within tolerance of the offline rows, one dead and
     one recovered event; (0) also F and H on infinite and NaN gradients
     and activations at every kind of slot (kept, masked, pads, indices
     past N, a row with no kept slot) and C and A on infinite and
     near-FLT_MAX inputs (``kernels/nonfinite.py``): +-inf and NaN exactly
     where the plain versions have them;
 13. the dry run at the paper's largest scale, the eleventh to
     thirteenth main paths: (a) ``repro_torch.launch.gnn_dryrun``,
     GraphSAGE ``aep`` at ``P13_RANKS`` = 64 ranks stacked on the card
     and 30,000 vertices (the reference's dry-run config), launch counts
     zeroed before and read after: one push all_to_all of
     ``aep_bytes_per_step(64, 2, 1024, [128, 256])`` = 134,742,016 B a
     rank, the all-reduce the parameters and the step's scalar metrics,
     its flops, bytes, roofline, step time and peak memory printed, and
     the step's count (flops, bytes, collectives, products, launches) on
     the card equal to the CPU's at 2 ranks of each model; (b) ``--mode
     sync`` at 64 ranks (two all_to_alls of ``sync_bytes_per_step``) and
     GAT at ``P13_GAT_RANKS`` = 32 (at 64 its queues and push buffers
     need ~120 GB); (c) the four GNN examples (``examples/torch_*.py``),
     each in a process of its own on the card: exit 0 and their summary
     lines;
 14. LM serving, the port's plain-torch transformer path (it has no
     kernel of its own; the reference's LM stack has no Pallas kernel):
     (a) minitron-4b, h2o-danube-3-4b, mixtral-8x7b, phi3.5-moe,
     xlstm-1.3b, recurrentgemma-9b, qwen2-vl-7b (256 patch embeddings)
     and seamless-m4t-medium (512 frame embeddings) at their published
     widths, cut to one unit of their pattern (recurrentgemma: and the
     remainder's first layer; seamless: one encoder layer), float32,
     weights of the reference's shapes and scales from a
     ``torch.Generator`` on the card: prefill 2 x 32 tokens and 8 decode
     steps from the prefill caches on the card and on the CPU (fed the
     card's ids): logits and cache states within 1e-4 * max(1, |x|) (or
     4x the card's own spread under 1e-7 relative embedding noise, where
     that is larger: xLSTM), cache positions and greedy ids equal;
     command-r-plus-104b's unit (a 12.6 GB tied embedding) on the card
     alone, finite, its prefill within 1e-4 of the prompt replayed
     through decode; minitron-4b and mixtral-8x7b in bfloat16, one unit,
     the card against the CPU (which ``tests/test_torch_lm_bf16.py``
     holds to the reference's own bf16 run): 99% of the first attention's
     bf16 outputs bit for bit, the logits within 0.65 of the CPU's
     bf16-float32 rms distance, a control with bf16 scores past both;
     (b) ``P14_MAIN`` = minitron-4b at full width and
     depth in bfloat16 (5.10B params): prefill 4 x 2,048 and 64 decode
     steps through ``make_prefill_step`` / ``make_serve_step`` (the GNN
     kernels' counts 0 before and after), one traced decode step and
     prefill (device busy share, top kernels), the prefill's last logits
     against the prompt replayed through decode (a CUDA graph of the
     decode step), both held to a float32 run of the same weights: each
     within twice the other's max distance and within ``P14_LIMIT`` (the
     reference test's atol = rtol = 2e-2 is printed, and holds only at
     reduced depth; the bf16-scores control's distance is printed);
     then ``BatchScheduler``, 8 slots, 16 requests of 32-128 prompt
     tokens and 32 new ones, cache 512, 8 of them in a reused slot, every
     request's ids equal to its own decode alone (in rows of the same
     batch shape, so the products take the same kernels); prefill
     tokens/s, decode ms/step and tokens/s, the scheduler's steps and
     tokens/s and peak memory printed with the card; (c) ``P14_SWA`` =
     h2o-danube-3-4b at full depth in bfloat16: a 6,144-token prompt
     past the 4,096 window (the prefill's ring caches hold positions
     2,048-6,143, slot p % 4,096) and 16 decode steps, against the same
     tokens decoded through the cache from empty, both held to a float32
     run as (b);
 15. LM training (plain torch, no kernel: the GNN kernels' counts stay
     0): (a) minitron-4b (vocab 256,000) and mixtral-8x7b one unit deep
     at published widths (``p14_unit``, phase 14 (a)'s weights: the same
     ``torch.Generator`` seeds), float32, ``cfg.remat`` on as published,
     2 x 32 tokens: one ``make_train_step`` step (the chunked loss, Adam
     at lr ``P15_LR``) on the card against the CPU on the same weights
     (both in the CPU worker, beside phases 14 (b) and (c)): loss and
     gradient norm within 1e-4 * max(1, |x|), each gradient leaf within
     1e-4 relative in norm, the parameters after Adam within 1e-4 *
     max(1, |x|) of the CPU's Adam on the card's own gradients, and of
     the CPU's whole step within that plus ``lr * |u(g_card) -
     u(g_cpu)|`` (``u(g) = g / (|g| + eps)``, Adam's first update: an
     entry whose gradient is float32 noise, |g| near eps, moves by up to
     2 lr on either device; ``p15_adam_arith``, ``p15_step_check``);
     the card's step without remat from the same weights bit for bit
     with the remat step (else within 1e-6, printed); the
     step's peak memory printed; (b) ``examples/torch_train_lm.py`` at
     its defaults (200 steps, batch 8, seq 256) in a process of its own on
     the card: exit 0, the loss falls, tokens/s beside the card's name;
     its parameter count and step-0 line those of ``--steps 3 --device
     cpu`` beside it (:func:`same_report`; at 3 steps the CPU's run ends
     at the example's own "loss must decrease" assertion, as the
     reference example's does there); (c) ``python -m
     repro_torch.launch.train lm --arch minitron-4b`` and ``--arch
     mixtral-8x7b`` at the reference's defaults, with ``--trace-out``
     under ``build/phase15/``, on the card in this process (every GNN
     kernel's count 0 before and after, the trace valid) and with
     ``--device cpu`` in processes of their own: the step lines the same
     under :func:`same_report`.

The serve layer's ``ms`` in the ``kernels`` line is a launch-weighted mean
over the serving path's launches: the three online layer shapes stand for
the microbatch launches, the three offline chunk shapes for the pre-warm's
chunks.  The HEC probe's ``ms`` is launch-weighted over both paths: its
four serving probe shapes share the serving launches, its three training
lookup shapes the training launches, and likewise at GAT's widths in
phases 5 and 6 (and phase 9's hot-tier run at phase 4's); its
``launches`` is the sum, split in ``launches_by_path``.  C-F's are means
over their layer shapes, each layer standing for an equal share of the
training paths' launches (phase 4's and phase 9's three runs, split in
``launches_by_path``); G's
is launch-weighted over phase 5's online and offline shapes and phase 6's
layer shapes, H's a mean over phase 6's layer shapes, I's a mean over
phase 7's layer shapes under cv (its ``plain_ms`` is blocking: the plain
draw waits for the card to find its wide rows), J's launch-weighted over
phase 8's hidden-layer request buffers.  A's, B's and G's rows add phase
8's launches and shapes (``launches_by_path``); B-H's add phase 13's
dry-run launches: phase 13 holds B-F (GraphSAGE at 64 ranks) and B, G,
H (GAT) to their plain versions at the dry runs' own layer shapes
(rank 0's first minibatch), untimed.  Cold
and warm q/s, per-step spans and s/epoch are printed as indicative only:
each window lasts seconds or less on the host clock.

Tolerances: the serve layer, UPDATE, AGG and GAT AGG sum in another
float32 order than their plain versions, so they are held to |kernel -
plain| <= 1e-4 * max(1, |plain|); the AGG and GAT AGG gradients (F, H)
sum in a fixed order through the slot index, so three launches are held
bit-equal, and F to its plain version's bits (run on the CPU) on every
source row of at most ``CHUNK`` slots; the dropout's dropped positions, UPDATE's dZ, AGG's
counts, the HEC probe + load (B and the batched J) and the fanout draw are
held bit for bit.  Sharded serving on the card against the CPU (phase 8
(c)) is held to 1e-4 * max(1, |x|), as the single-rank serving phases.
The card-vs-CPU training step is held to 1e-4 relative (loss, gradient
norm, and Adam's first moment of each tensor in norm):
its sums run in other orders over up to 1,056,000 rows.  For GAT the card
is also held to a float64 witness of the first step, per tensor within
1e-4, and that replaces the CPU for layer 0's attention vectors: their
gradients cancel heavily (the softmax gradient is centred), and there the
CPU's float32 sat 9e-5 to 1.2e-4 from the witness at the numpy-seeded
weights, the card 6e-7 to 3e-6.  At the reference's initial weights a
few of the card's ~1e9 projection pre-activations land on the other side
of ReLU's kink than the exact ones and move layer 0's gradient 1.1e-4
from the witness; so for GAT both float32 runs take the exact ReLU
branches (the flips are counted and printed), and the check compares
arithmetic alone.  TF32 is off.

Prints free-form lines, then the card's name and power limit as
nvidia-smi gives them, a JSON ``kernels`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result; so does a machine without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's peaks (NVIDIA H100 SXM5 80GB HBM3 data sheet) and the
# kernels' work formulas live in the package, so that this table's
# bounds and the dry run's roofline agree
from repro_torch.launch.mesh import (HBM_BW as PEAK_BYTES_PER_S,  # noqa: E402
                                     PEAK_FP32_FLOPS, PEAK_TF32_FLOPS)
from repro_torch.utils import step_cost  # noqa: E402
TOL = 1e-4
SLOTS = 64
OFFLINE_CHUNK = 2048        # layerwise_embeddings' default chunk of dst rows
KERNEL_ROWS = {
    "serve_fused_layer": dict(
        route="cuda", source="src/repro_torch/csrc/serve_fused.cu",
        replaces="src/repro/kernels/serve_fused.py:59"),
    "hec_lookup": dict(
        route="cuda", source="src/repro_torch/csrc/hec_search.cu",
        replaces="src/repro/kernels/hec_search.py:105"),
    "update_fused_fwd": dict(
        route="cuda", source="src/repro_torch/csrc/update_fused.cu",
        replaces="src/repro/kernels/update_fused.py:59"),
    "update_fused_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/update_fused.cu",
        replaces="src/repro/kernels/update_fused.py:59 (its gradient)"),
    "sage_agg_fwd": dict(
        route="cuda", source="src/repro_torch/csrc/sage_agg.cu",
        replaces="src/repro/kernels/sage_agg.py:43"),
    "sage_agg_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/sage_agg.cu",
        replaces="src/repro/kernels/sage_agg.py:43 (its gradient)"),
    "gat_edge_fwd": dict(
        route="cuda", source="src/repro_torch/csrc/gat_edge.cu",
        replaces="src/repro/kernels/gat_edge.py:44"),
    "gat_edge_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/gat_edge.cu",
        replaces="src/repro/kernels/gat_edge.py:44 (its gradient)"),
    "sample_draw": dict(
        route="cuda", source="src/repro_torch/csrc/sample_draw.cu",
        replaces="src/repro/kernels/sample_draw.py:65"),
    "hec_probe": dict(
        route="cuda", source="src/repro_torch/csrc/hec_search.cu",
        replaces="src/repro/kernels/hec_search.py:54"),
}
KERNELS = ("serve_fused", "hec_search", "update_fused", "sage_agg",
           "gat_edge", "sample_draw")
# kernel C's output on pinned inputs (SHA-256 of its float32 bytes) as it
# was before its 3xTF32 helpers moved into csrc/tf32x3.cuh; the same
# digests pin tests/test_torch_cuda.py::test_update_fwd_bitmatches_pinned_output
C_PINNED = [
    ((17001, 256, 256, True, 0.1),
     "35930f6aed084ade7e76f20625e439c7346f73fbb7930c19ebf333002f8f0807"),
    ((1000, 256, 172, False, 0.0),
     "7266dfd4337d180bee09fc7814a2fe422cfee76751e6f36e861c8a325dd7715d"),
    ((1001, 100, 130, False, 0.3),
     "a93244ebe3a2f34929c9ac9dbcac155c3f551b94434c17412afdf9e06d50035c")]
# kernel E's mean and count on pinned inputs (SHA-256 of the float32 bytes
# of mean, then of cnt; inputs from pinned_agg_inputs) as its first design
# (one warp per dst row) gave them: layer 0 of the training path, the
# offline width (77 slots) at D 256, and a ragged D = 6 (the scalar path)
E_PINNED = [
    ((1_056_000, 176_000, 5, 128),
     "df3bca4fa4492d9f49d328fdb7ae6f8f1e5f3a72ec6ddac34e29faff92a08767"),
    ((100_000, 2048, 77, 256),
     "013b582a8d3ac5b0b19c72b7ae6157633075f9f87fed49a54d936abcea4bcfa4"),
    ((300, 37, 7, 6),
     "0d886f3041398c35957efb879347c7391cc98204923e53999ac6f0f7fb810d59")]
TRAIN_VERTICES = 400_000
TRAIN_ARGS = ["gnn", "--ranks", "4", "--degree", "10", "--classes", "172",
              "--feat-dim", "128", "--hidden", "256", "--layers", "3",
              "--fanouts", "5", "10", "15", "--batch", "1000", "--epochs",
              "1", "--hec-size", "1000000", "--hec-nc", "2000", "--device",
              "cuda"]
EVAL_BATCHES = 8            # DistTrainer.evaluate's default
CHECK_STEPS = 2             # steps of the card-vs-CPU checks, phases 4/6 (c)
# entries per layer and rank, phase 6: the paper's cs = 1M, as phase 4
# (evaluate copies no HEC)
GAT_HEC_SIZE = 1_000_000
# batch of phase 6 (c): at 1000 one CPU step of GAT takes over 60 s
GAT_CHECK_BATCH = 256
# and its HEC: the CPU's copy at the main path's 1M would take 35 GB of
# host memory (phase 6 (a) holds B on the 1M caches of (b) instead)
GAT_CHECK_HEC_SIZE = 262_144
# phase 6 (c): the leaves (layer 0's a_u and a_v, whose sums cancel
# heavily) where the CPU's float32 gradient sits 9e-5 to 1.2e-4 from a
# float64 witness, too far to hold the card to; the card is held to the
# witness at every leaf instead (PERF.md)
GAT_CPU_NOISY_LEAVES = (0, 1)


class SmokeFailure(RuntimeError):
    pass


PHASE_SECONDS = {}          # each phase's seconds, printed as one JSON line
CHILDREN = []               # processes that run beside the phases


def stop_children():
    """Kills what of :data:`CHILDREN` still runs (a failed phase leaves no
    process behind)."""
    for p in CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


@contextlib.contextmanager
def timed(name: str):
    """Times the block as phase ``name``: prints its seconds and keeps them
    for the ``phase_seconds`` line."""
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    print(f"{name}: done in {PHASE_SECONDS[name]:.1f}s")


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3):
    """``(device_ms, call_ms)`` of ``fn()``, means over ``iters`` runs timed
    with CUDA events.  ``device_ms`` queues the runs behind a device sleep
    longer than the host takes to enqueue them, so it is the card's time
    alone; ``call_ms`` is what a Python caller waits per call, enqueue
    (wrapper checks, ctypes, allocation) included.  The allocator's cache
    is emptied first: a cache fragmented by earlier work makes it free
    blocks inside the timed loop, and freeing waits for the device."""
    torch.cuda.empty_cache()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > host_ms:
            break
        cycles *= 4
    else:
        raise SmokeFailure("device sleep never outlasted the host enqueue")
    device_ms = ev[1].elapsed_time(ev[2]) / iters
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[2].record()
    torch.cuda.synchronize()
    return device_ms, ev[0].elapsed_time(ev[2]) / iters


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time for ``nbytes`` moved, ``flops`` on the CUDA cores in
    float32 and ``tf32_flops`` on the tensor cores in TF32 (the two units
    run side by side, so the slower of them), and which of bytes and
    operations sets it (``utils/step_cost.py:bound``)."""
    return step_cost.bound(step_cost.Work(nbytes, flops, tf32_flops))


def work_bound(work):
    """``bound`` of a kernel launch's work formula (``utils/step_cost.py``),
    and its bound on the CUDA cores alone where it takes the tensor cores
    (None otherwise)."""
    ms, by = step_cost.bound(work)
    ffma = None if work.ffma is None else \
        bound(work.nbytes, work.ffma)[0]
    return ms, by, ffma


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------
def serve_layer_case(torch, sf, ref, name, h, nbr, valid, p, relu,
                     self_idx=None, timed=True):
    """Kernel vs plain on one input; returns the plain output and a row."""
    wn, ws, b = p
    out = sf.serve_fused_layer(h, nbr, valid, wn, ws, b, relu=relu,
                               self_idx=self_idx)
    torch.cuda.synchronize()
    want = ref.serve_layer_ref(h, nbr, valid, wn, ws, b, relu=relu,
                               self_idx=self_idx)
    torch.cuda.synchronize()
    err = (out - want).abs()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    check(bool((err <= TOL * want.abs().clamp_min(1.0)).all()),
          f"{name}: max |kernel - plain| {float(err.max()):.3e} over "
          f"tolerance")
    M, f = nbr.shape
    N, D = h.shape
    K = wn.shape[1]
    row = {"shape": f"h {N}x{D}, nbr {M}x{f}, W {D}x{K}"
                    + (", self_idx" if self_idx is not None else ""),
           "route": sf.serve_form(M, K, D, torch.cuda.get_device_properties(
               h.device).multi_processor_count),
           "max_abs_err": float(err.max()) if err.numel() else 0.0}
    if timed:
        # what this input needs (step_cost.serve_layer_work): on the CUDA
        # cores in float32 (FFMA), or (the route taken) the products as
        # three TF32 products on the tensor cores
        row["bound_ms"], row["bound_by"], row["bound_ffma_ms"] = work_bound(
            step_cost.serve_layer_work(h, nbr, valid, wn, ws, b, relu=relu,
                                       self_idx=self_idx))
        self_rows = (torch.arange(M, device=h.device) if self_idx is None
                     else self_idx.long().clamp(0, N - 1))
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: sf.serve_fused_layer(
                h, nbr, valid, wn, ws, b, relu=relu, self_idx=self_idx))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.serve_layer_ref(
                h, nbr, valid, wn, ws, b, relu=relu, self_idx=self_idx))
        # the yardstick (never called by the port): one float32 addmm of
        # the products and the bias, on the neighbor means and self rows
        # gathered outside the timed window, no ReLU
        from repro_torch.models.gnn.common import (gather_neighbors,
                                                   masked_mean)
        agg = masked_mean(*gather_neighbors(h, nbr, valid))
        x = torch.cat([agg, h[self_rows]], 1)
        w = torch.cat([wn, ws], 0)
        ok, _ = close_to(torch.addmm(b, x, w), agg @ wn + h[self_rows] @ ws
                         + b)
        check(ok, f"{name}: addmm of the concatenations is not the serve "
                  f"layer's products")
        row["library_ms"], _ = time_ms(torch, lambda: torch.addmm(b, x, w))
        del agg, x, w
    return want, row


def print_serve_row(row):
    print(f"phase 1: serve_fused_layer {row['shape']} [{row['route']}]: "
          f"max|d|={row['max_abs_err']:.3e}; device ms kernel "
          f"{row['ms']:.4f}, plain {row['plain_ms']:.4f}, library "
          f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}), FFMA bound {row['bound_ffma_ms']:.4f}; per "
          f"call kernel {row['call_ms']:.4f}, plain "
          f"{row['plain_call_ms']:.4f}")


def plain_offline_layer(torch, ref, h, nbr_full, layer, relu):
    """One layer of the offline engine through the plain version: chunks of
    OFFLINE_CHUNK dst rows with ``self_idx`` = their vertex ids, as
    ``layerwise_embeddings`` launches the kernel."""
    S = nbr_full.shape[0]
    valid = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
    vids = torch.arange(S, dtype=torch.int32, device=h.device)
    return torch.cat([
        ref.serve_layer_ref(h, nbr_full[s:s + OFFLINE_CHUNK], valid,
                            layer.wn, layer.ws, layer.b, relu=relu,
                            self_idx=vids[s:s + OFFLINE_CHUNK])
        for s in range(0, S, OFFLINE_CHUNK)])


def hec_case(torch, hs, name, state, vids, timed=True):
    got = hs.hec_lookup(state.tags, state.values, vids)
    torch.cuda.synchronize()
    want = hs.hec_lookup_ref(state.tags, state.values, vids)
    torch.cuda.synchronize()
    for label, g, w in zip(("hit", "set", "way", "emb"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: {label} dtype/shape {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        check(bool(torch.equal(g, w)), f"{name}: {label} not bit-exact")
    hit, sets, way, _ = want
    n = vids.shape[0]
    nsets, ways, d = state.values.shape
    row = {"shape": f"vids {n}, tags {nsets}x{ways}, values d={d}",
           "max_abs_err": 0.0, "hits": int(hit.sum()),
           "negative_vids": int((vids < 0).sum())}
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.hec_lookup_work(state.tags, state.values, vids, want))
        row["ms"], row["call_ms"] = time_ms(torch, lambda: hs.hec_lookup(
            state.tags, state.values, vids))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: hs.hec_lookup_ref(state.tags, state.values, vids))
    return row


def fill_cache(torch, hec, set_index, cache_size, ways, d, device, rng,
               np):
    """A half-full cache plus a few full sets; returns (state, stored vids,
    vids of full sets)."""
    state = hec.hec_init(cache_size, ways, d, device)
    nsets = cache_size // ways
    cand = np.arange(2_000_000, dtype=np.int64)
    sets_of = set_index(torch.as_tensor(cand), nsets).numpy()
    full = np.concatenate([cand[sets_of == s][:ways + 3] for s in range(4)])
    stored = rng.choice(1_000_000, size=cache_size // 2, replace=False)
    stored = np.unique(np.concatenate([stored, full]))
    for s in range(0, len(stored), 4096):
        v = torch.as_tensor(stored[s:s + 4096], device=device)
        hec.hec_store(state, v, torch.randn(len(v), d, device=device))
    return state, stored, full


def phase1(torch, np, setup):
    from repro_torch.cache import hec
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels import ref
    from repro_torch.kernels import serve_fused as sf
    from repro_torch.pipeline.vectorized_sampler import \
        sample_blocks_vectorized
    from repro_torch.serve.gnn import full_neighbor_matrix

    dev = setup["device"]
    cfg, part, model = setup["cfg"], setup["part"], setup["model"]
    rng = np.random.default_rng(0)
    seeds = rng.choice(part.num_solid, size=SLOTS, replace=False)
    blocks = sample_blocks_vectorized(part, seeds, cfg.fanouts,
                                      np.random.default_rng([0, 0]), SLOTS)
    feats = torch.as_tensor(part.features, device=dev)
    nodes0 = torch.as_tensor(blocks.layer_nodes[0], device=dev)
    valid = torch.as_tensor(blocks.node_mask[0], device=dev)
    h = feats[nodes0.clamp(0, part.num_solid - 1)] * valid[:, None]
    rows_a = []
    L = model.num_layers
    for k, layer in enumerate(model.layers):
        nbr = torch.as_tensor(blocks.nbr_idx[k], dtype=torch.int32,
                              device=dev)
        h, row = serve_layer_case(
            torch, sf, ref, f"serve layer {k}", h, nbr, valid,
            (layer.wn, layer.ws, layer.b), relu=k < L - 1)
        valid = torch.as_tensor(blocks.node_mask[k + 1], device=dev)
        row["offline"] = False
        rows_a.append(row)
        print_serve_row(row)

    # the offline pre-warm's chunk shapes on the same graph: the first chunk
    # of each layer, with the layer's input computed by the plain version
    nbr_full = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                               device=dev)
    ones = torch.ones(part.num_solid, dtype=torch.bool, device=dev)
    chunk_ids = torch.arange(OFFLINE_CHUNK, dtype=torch.int32, device=dev)
    h = feats
    for k, layer in enumerate(model.layers):
        relu = k < L - 1
        _, row = serve_layer_case(
            torch, sf, ref, f"offline chunk layer {k}", h,
            nbr_full[:OFFLINE_CHUNK], ones, (layer.wn, layer.ws, layer.b),
            relu=relu, self_idx=chunk_ids)
        row["offline"] = True
        rows_a.append(row)
        print_serve_row(row)
        h = plain_offline_layer(torch, ref, h, nbr_full, layer, relu)

    # ragged shape: K and D off any tile, -1 pads, invalid sources, an
    # all-masked row, clamped self_idx (offline chunk form) and the prefix
    g = torch.Generator(device="cpu").manual_seed(1)
    N, M, f, D, K = 300, 37, 7, 100, 47
    hr = torch.randn(N, D, generator=g).to(dev)
    nbr = torch.randint(-1, N, (M, f), generator=g, dtype=torch.int32)
    nbr[3] = -1
    vr = torch.rand(N, generator=g) > 0.2
    p = [torch.randn(D, K, generator=g).to(dev) / 10,
         torch.randn(D, K, generator=g).to(dev) / 10,
         torch.randn(K, generator=g).to(dev)]
    self_idx = torch.randint(-5, N + 5, (M,), generator=g,
                             dtype=torch.int32)
    for relu in (True, False):
        serve_layer_case(torch, sf, ref, "ragged", hr, nbr.to(dev),
                         vr.to(dev), p, relu, timed=False)
        serve_layer_case(torch, sf, ref, "ragged self_idx", hr, nbr.to(dev),
                         vr.to(dev), p, relu, self_idx=self_idx.to(dev),
                         timed=False)
    print("phase 1: serve_fused_layer ragged shapes (37x7, D=100, K=47, "
          "self_idx) within tolerance")

    # HEC probe + load: the serve step's probe shapes on half-full caches
    from repro_torch.kernels.ref import set_index
    rows_b = []
    dims = [cfg.hidden_size] * (L - 1) + [cfg.num_classes]
    cache_size = setup["cache_size"]
    probe_layers = [(k, blocks.layer_nodes[k]) for k in range(1, L)] \
        + [(L, blocks.seeds), (L, None)]
    states = {}
    for k, nodes in probe_layers:
        d = dims[k - 1]
        if d not in states:
            states[d] = fill_cache(torch, hec, set_index, cache_size, 8, d,
                                   dev, rng, np)
        state, stored, full = states[d]
        n = len(nodes) if nodes is not None else SLOTS
        vids = rng.choice(stored, size=n).astype(np.int64)
        miss = rng.random(n) < 0.3
        vids[miss] = rng.integers(1_000_000, 2_000_000, int(miss.sum()))
        vids[rng.random(n) < 0.1] = -1
        vids[:4] = [-5, -2 ** 31, full[0], full[-1]]
        row = hec_case(torch, hs, f"hec probe l{k}", state,
                       torch.as_tensor(vids, dtype=torch.int32, device=dev))
        rows_b.append(row)
        print(f"phase 1: hec_lookup {row['shape']} ({row['hits']} hits, "
              f"{row['negative_vids']} negative): bit-exact; device ms "
              f"kernel {row['ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}); per call kernel "
              f"{row['call_ms']:.4f}, plain {row['plain_call_ms']:.4f}")
    return rows_a, rows_b


# ---------------------------------------------------------------------------
# phase 2: exact serving at full width against plain offline embeddings
# ---------------------------------------------------------------------------
def phase2(torch, np, device):
    from repro_torch.configs.gnn import GRAPHSAGE_PAPERS100M
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import ref
    from repro_torch.models.gnn.graphsage import GraphSAGE
    from repro_torch.serve.gnn import (GNNServeConfig, GNNServeScheduler,
                                       ServeCacheConfig, full_neighbor_matrix,
                                       layerwise_embeddings, warm_cache)

    g = synthetic_graph(num_vertices=3000, avg_degree=2, num_classes=172,
                        feat_dim=128, seed=3)
    part = partition_graph(g, 1, seed=0).parts[0]
    max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
    cfg = dataclasses.replace(GRAPHSAGE_PAPERS100M, fanouts=(max_deg,) * 3)
    model = GraphSAGE.from_config(cfg, seed=1, device=device)
    S = part.num_solid
    nbr = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                          device=device)
    valid = torch.ones(S, dtype=torch.bool, device=device)
    h = torch.as_tensor(part.features, device=device)
    plain = []
    for k, layer in enumerate(model.layers):
        h = ref.serve_layer_ref(h, nbr, valid, layer.wn, layer.ws, layer.b,
                                relu=k < model.num_layers - 1)
        plain.append(h)
    want = plain[-1].cpu().numpy()

    def close(a, b):
        return np.all(np.abs(a - b) <= TOL * np.maximum(1.0, np.abs(b)))

    rng = np.random.default_rng(2)
    vids = np.concatenate([np.arange(0, S, 5), rng.integers(0, S, 200)])
    scfg = GNNServeConfig(num_slots=16,
                          cache=ServeCacheConfig(cache_size=65536, ways=8))
    srv = GNNServeScheduler(cfg, model, part, scfg, device=device)
    out = srv.serve(vids)
    check(np.isfinite(out).all(), "phase 2: non-finite served answer")
    check(close(out, want[vids]), "phase 2: served answers differ from the "
          f"plain offline embeddings (max |d| "
          f"{np.abs(out - want[vids]).max():.3e})")
    m = srv.metrics()
    check(m["fast_path_hits"] + m["hits_l3"] > 0, "phase 2: no cache reuse")
    embs = layerwise_embeddings(cfg, model, part, chunk_size=512)
    for k, (e, p) in enumerate(zip(embs, plain)):
        check(close(e.cpu().numpy(), p.cpu().numpy()),
              f"phase 2: offline layer {k + 1} (kernel) differs from plain")
    warm = GNNServeScheduler(cfg, model, part, scfg, device=device)
    warm_cache(warm.cache, embs, np.arange(S))
    out_w = warm.serve(vids)
    check(warm.steps_run == 0, "phase 2: warmed server ran a microbatch")
    check(np.array_equal(out_w, embs[-1].cpu().numpy()[vids]),
          "phase 2: warm answers are not the offline rows")
    print(f"phase 2: {len(vids)} queries on a {S}-vertex graph (fanouts "
          f"{max_deg}x3, exact sampling) match plain offline embeddings; "
          f"{m['steps_run']} microbatches, {m['fast_path_hits']} fast-path "
          f"answers; warmed server answered all from the output cache")


# ---------------------------------------------------------------------------
# phase 3: the main path, through the launcher
# ---------------------------------------------------------------------------
def phase3(torch, np, args):
    from repro_torch.kernels import ref
    from repro_torch.launch import gnn_serve
    from repro_torch.serve.gnn import full_neighbor_matrix

    largs = gnn_serve.parse_args([
        "--preset", "graphsage-papers100m", "--slots", str(SLOTS),
        "--vertices", str(args.vertices), "--queries", str(args.queries),
        "--device", "cuda"])
    zero_launches()
    res = gnn_serve.run(largs)
    launches = read_launches()
    ANSWERS["single-rank"] = (answers(np, res["cold"]),
                             answers(np, res["warm"]))
    print(f"phase 3: launches on the main path: {launches}")
    for name in ("serve_fused_layer", "hec_lookup"):
        check(launches[name] > 0,
              f"phase 3: {name} was never launched on the main path")
    cold, warm = res["cold"], res["warm"]
    check(all(r.done and np.isfinite(r.result).all() for r in cold + warm),
          "phase 3: an answer is missing or non-finite")
    offline = res["embs"][-1].cpu().numpy()
    fast = [r for r in warm if r.served_by == "output_cache"]
    check(len(fast) > 0, "phase 3: the warm pass had no fast-path answer")
    check(all(np.array_equal(r.result, offline[r.vid]) for r in fast),
          "phase 3: a fast-path answer differs from its offline row")

    # the pre-warm's embeddings came from kernel launches: hold every layer
    # against the plain version on the same input (the kernel's h^l)
    part, model = res["part"], res["srv"].model
    dev = torch.device("cuda")
    nbr_full = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                               device=dev)
    h = torch.as_tensor(part.features, device=dev)
    offline_err = 0.0
    for k, (layer, e) in enumerate(zip(model.layers, res["embs"])):
        want = plain_offline_layer(torch, ref, h, nbr_full, layer,
                                   relu=k < model.num_layers - 1)
        torch.cuda.synchronize()
        err = (e - want).abs()
        check(e.shape == want.shape and bool(torch.isfinite(e).all()),
              f"phase 3: offline layer {k + 1} has shape {tuple(e.shape)} "
              f"or non-finite values")
        check(bool((err <= TOL * want.abs().clamp_min(1.0)).all()),
              f"phase 3: offline layer {k + 1}: max |kernel - plain| "
              f"{float(err.max()):.3e} over tolerance")
        offline_err = max(offline_err, float(err.max()))
        h = e
    chunks = -(-part.num_solid // OFFLINE_CHUNK)
    launches_offline = model.num_layers * chunks
    print(f"phase 3: offline embeddings of {part.num_solid} vertices, "
          f"{launches_offline} kernel launches ({chunks} chunks x "
          f"{model.num_layers} layers), match the plain version: max|d|="
          f"{offline_err:.3e}")
    print(f"phase 3: cold {res['cold_qps']:.1f} q/s "
          f"({res['cold_metrics']['steps_run']} microbatches), warm "
          f"{res['warm_qps']:.1f} q/s ({len(fast)}/{len(warm)} fast-path "
          f"answers equal to their offline rows); indicative only, each "
          f"pass lasts under a second of host clock")
    return launches, launches_offline, offline_err


# ---------------------------------------------------------------------------
# phase 4: training, through the launcher
# ---------------------------------------------------------------------------
def wrappers():
    """Every kernel wrapper, by the name of its row."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import sample_draw as sd
    from repro_torch.kernels import serve_fused as sf
    from repro_torch.kernels import slot_index as si
    from repro_torch.kernels import update_fused as uf
    return {"serve_fused_layer": sf.serve_fused_layer,
            "hec_lookup": hs.hec_lookup,
            "update_fused_fwd": uf.update_fused_fwd,
            "update_fused_bwd": uf.update_fused_bwd,
            "sage_agg_fwd": sa.sage_agg_fwd,
            "sage_agg_bwd": sa.sage_agg_bwd,
            "gat_edge_fwd": ge.gat_edge_fwd,
            "gat_edge_bwd": ge.gat_edge_bwd,
            "sample_draw": sd.sample_draw,
            "hec_probe": hs.hec_probe,
            "slot_index": si.slot_index}


def zero_launches():
    for w in wrappers().values():
        w.launches = 0


def read_launches():
    return {n: w.launches for n, w in wrappers().items()}


def train_main_path(torch, np, phase, argv, per_step, per_eval):
    """(b): the launcher's training run; every kernel's launches must be
    ``per_step`` per step plus ``per_eval`` per eval batch (per rank and
    layer counts are the caller's; absent = 0).  Returns its result and
    the launches it made."""
    from repro_torch import obs
    from repro_torch.launch import train
    obs.configure()
    zero_launches()
    res = train.run_gnn(train.parse_args(argv))
    launches = read_launches()
    check_training(np, phase, res, launches, per_step, per_eval)
    return res, launches


def check_training(np, phase, res, launches, per_step, per_eval):
    """The checks and printout of a training run (b): exact launches,
    finite losses and gradients, by mode pushes and HEC hits (``aep``),
    fetched halos (``sync``) or none (``drop``), the accuracy, and the
    host spans per step of each epoch."""
    print(f"{phase}: launches on the training path: {launches}")
    tr, cfg = res["trainer"], res["cfg"]
    R, L, log = tr.num_ranks, cfg.num_layers, tr.step_log
    steps = len(log)
    print(f"{phase}: {steps} steps per rank in {len(res['history'])} "
          f"epoch(s), {R} ranks, batch {cfg.batch_size}, mode {tr.mode}; "
          f"{EVAL_BATCHES} eval batches")
    for n in launches:
        want = steps * per_step.get(n, 0) + EVAL_BATCHES * per_eval.get(n, 0)
        check(launches[n] == want, f"{phase}: {n} launched {launches[n]} "
              f"times, expected {want}")
    for i, m in enumerate(log):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"{phase}: step {i}: loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
    aep = tr.mode == "aep"
    # outside aep only layer 0 counts halos, and nothing is pushed
    layers = L if aep else 1
    hits = [sum(m[f"hec_hits_l{l}"] for m in log) for l in range(layers)]
    check(all(("aep_push_rows" in m) == aep for m in log)
          and all(m["aep_push_rows"] > 0 for m in log if aep),
          f"{phase}: a step pushed no rows, or pushed outside aep")
    if tr.mode == "drop":
        check(hits == [0], f"{phase}: drop mode used a halo row")
    else:
        check(any(h > 0 for h in hits), f"{phase}: no halo row was served "
              f"(HEC hit or sync fetch) by the last step")
    check(0.0 <= res["test_acc"] <= 1.0, f"{phase}: evaluate failed")
    pushed = (f"pushed rows per step {[int(m['aep_push_rows']) for m in log]}"
              if aep else "no push")
    print(f"{phase}: losses {[round(m['loss'], 4) for m in log]}; seeds "
          f"per step {[int(m['examples']) for m in log]}; halo rows served "
          f"per layer {hits} of halos "
          f"{[sum(m[f'hec_halos_l{l}'] for m in log) for l in range(layers)]}"
          f"; {pushed}; test_acc {res['test_acc']:.4f}")
    per_epoch = steps // len(res["history"])
    for e, h in enumerate(res["history"]):
        print(f"{phase}: epoch {e} indicative host clock: "
              f"{h['t_wall']:.2f} s; per step ms: " + ", ".join(
                  f"{p} {1e3 * h[f't_{p}'] / per_epoch:.1f}"
                  for p in ("sample", "host_prep", "stage", "step"))
              + " (sample and host_prep run on the prefetch worker)")


def phase4_counts():
    """Phase 4's launches: per step C, D, E and B at every layer of every
    rank, F and its slot index build at layers >= 1, per eval batch C, E
    and B."""
    R, L = 4, 3
    per_step = {"hec_lookup": L * R, "update_fused_fwd": L * R,
                "update_fused_bwd": L * R, "sage_agg_fwd": L * R,
                "sage_agg_bwd": (L - 1) * R, "slot_index": (L - 1) * R}
    per_eval = {"hec_lookup": L * R, "update_fused_fwd": L * R,
                "sage_agg_fwd": L * R}
    return per_step, per_eval


def phase4_main_path(torch, np, vertices):
    """(b) of phase 4: GraphSAGE through the launcher."""
    return train_main_path(torch, np, "phase 4", TRAIN_ARGS + [
        "--vertices", str(vertices)], *phase4_counts())


def close_to(got, want):
    err = (got - want).abs()
    return bool((err <= TOL * want.abs().clamp_min(1.0)).all()), \
        float(err.max()) if err.numel() else 0.0


def pinned_agg_inputs(np, N, M, f, D):
    """Kernel E's pinned inputs (``E_PINNED``): normals, indices in [-1, N
    + 2) (past the last row they clamp to it), 85% of the rows valid, row
    0 all -1."""
    rng = np.random.default_rng(N + M + f + D)
    h = rng.normal(size=(N, D)).astype(np.float32)
    nbr = rng.integers(-1, N + 2, (M, f)).astype(np.int32)
    nbr[0] = -1
    return h, nbr, rng.random(N) > 0.15


def agg_digest(mean, cnt) -> str:
    import hashlib
    return hashlib.sha256(mean.cpu().numpy().tobytes()
                          + cnt.cpu().numpy().tobytes()).hexdigest()


def agg_route(torch, sa, h, nbr):
    """The form kernel E takes for these operands, as printed."""
    rows, slice_ = sa.agg_form(*nbr.shape, h.shape[1],
                               torch.cuda.get_device_properties(
                                   h.device).multi_processor_count)
    vec = h.shape[1] % 4 == 0 and h.data_ptr() % 16 == 0
    return (f"{rows} rows x {slice_} columns a warp, "
            f"{'float4' if vec else 'float'}")


def agg_case(torch, sa, ref, name, h, nbr, valid, timed=True):
    mean, cnt = sa.sage_agg_fwd(h, nbr, valid)
    torch.cuda.synchronize()
    want, want_cnt = ref.sage_agg_ref(h, nbr, valid)
    ok, err = close_to(mean, want)
    check(bool(torch.isfinite(mean).all()) and ok,
          f"{name}: AGG max |kernel - plain| {err:.3e} over tolerance")
    check(torch.equal(cnt, want_cnt), f"{name}: AGG counts differ")
    N, D = h.shape
    M, f = nbr.shape
    row = {"shape": f"h {N}x{D}, nbr {M}x{f}", "max_abs_err": err,
           "route": agg_route(torch, sa, h, nbr)}
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.agg_fwd_work(h, nbr, valid))
        idx = nbr.long()
        used = (idx >= 0) & valid[idx.clamp_min(0)]
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: sa.sage_agg_fwd(h, nbr, valid))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.sage_agg_ref(h, nbr, valid))
        bag, w = idx.clamp_min(0), used.float()
        lib = torch.nn.functional.embedding_bag(bag, h, mode="sum",
                                                per_sample_weights=w)
        ok, _ = close_to(lib / cnt.clamp_min(1.0)[:, None], want)
        check(ok, f"{name}: embedding_bag's masked sum is not AGG's")
        row["library_ms"], _ = time_ms(
            torch, lambda: torch.nn.functional.embedding_bag(
                bag, h, mode="sum", per_sample_weights=w))
    return mean, cnt, row


def agg_bwd_case(torch, sa, ref, name, g, nbr, valid, cnt, num_src,
                 timed=True):
    """Kernel F on one input: three launches through one slot index bit
    for bit, within tolerance of the plain version on the card (in
    float64 where a source row has more than ``CHUNK`` slots), and the
    plain version's bits (run on the CPU, where ``index_add_`` adds in
    slot order) on every source row of at most ``CHUNK`` slots.  Timed
    with the index built beforehand; the build is timed apart."""
    from repro_torch.kernels import slot_index as si
    ix = si.slot_index(nbr, valid, num_src)
    runs = [sa.sage_agg_bwd(g, nbr, valid, cnt, num_src, ix)
            for _ in range(3)]
    torch.cuda.synchronize()
    dh = runs[0]
    check(all(torch.equal(dh, r) for r in runs[1:]),
          f"{name}: F's launches differ in their bits")
    lens = (ix.offsets[1:] - ix.offsets[:-1]).cpu()
    # a row of thousands of slots sums in float32 to ~1e-4 in any order:
    # there the kernel is held to the plain version in float64
    wide = int(lens.max()) > si.CHUNK if num_src else False
    want = ref.sage_agg_bwd_ref(g.double(), nbr, valid, cnt.double(),
                                num_src) if wide \
        else ref.sage_agg_bwd_ref(g, nbr, valid, cnt, num_src)
    ok, err = close_to(dh, want)
    check(bool(torch.isfinite(dh).all()) and ok,
          f"{name}: AGG gradient max |kernel - plain"
          f"{' in float64' if wide else ''}| {err:.3e} over tolerance")
    del want
    cpu = ref.sage_agg_bwd_ref(g.cpu(), nbr.cpu(), valid.cpu(), cnt.cpu(),
                               num_src)
    short = lens <= si.CHUNK
    check(torch.equal(dh.cpu()[short], cpu[short]),
          f"{name}: F is not the plain version's bits on its rows of at "
          f"most {si.CHUNK} slots")
    del runs, cpu
    M, f = nbr.shape
    D = g.shape[1]
    row = {"shape": f"g {M}x{D}, nbr {M}x{f}, dh {num_src}x{D}",
           "max_abs_err": err, "repeats_bitwise": 3,
           "rows_bitwise_plain": int(short.sum()), "rows": num_src,
           "longest_row_slots": int(lens.max()) if num_src else 0}
    if wide:
        row["held_to"] = "the plain version in float64"
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.agg_bwd_work(g, nbr, valid, cnt, num_src, ix))
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: sa.sage_agg_bwd(g, nbr, valid, cnt, num_src, ix))
        row["index_ms"], row["index_call_ms"] = time_ms(
            torch, lambda: si.slot_index(nbr, valid, num_src))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.sage_agg_bwd_ref(g, nbr, valid, cnt, num_src))
        # one PyTorch call: index_add_ of the quotients in deterministic
        # mode (its sort-based path), the quotients made beforehand
        idx = nbr.long().clamp(0, max(num_src - 1, 0)).reshape(-1)
        keep = ((nbr >= 0) & (nbr < num_src)
                & valid[nbr.long().clamp(0, num_src - 1)]).reshape(-1)
        quot = ((g / cnt.clamp_min(1.0)[:, None])[:, None, :]
                .expand(M, f, D).reshape(-1, D) * keep[:, None].float())
        dst = torch.zeros((num_src, D), dtype=g.dtype, device=g.device)
        torch.use_deterministic_algorithms(True)
        try:
            lib = dst.clone().index_add_(0, idx, quot)
            ok, _ = close_to(lib, dh)
            check(ok, f"{name}: index_add_ of the quotients is not F")
            row["library_ms"], _ = time_ms(
                torch, lambda: dst.clone().index_add_(0, idx, quot))
        finally:
            torch.use_deterministic_algorithms(False)
        row["library_call"] = ("Tensor.index_add_ of the [M*f, D] quotients "
                               "under torch.use_deterministic_algorithms"
                               "(True), a clone of zeros included")
    return row


def update_case(torch, uf, ref, name, args, relu, dropout, seed, timed=True):
    from repro_torch.models.gnn.common import hash_uniform
    kw = dict(relu=relu, dropout=dropout, seed=seed)
    out = uf.update_fused_fwd(*args, **kw)
    torch.cuda.synchronize()
    want = ref.fused_update_ref(*args, **kw)
    ok, err = close_to(out, want)
    check(bool(torch.isfinite(out).all()) and ok,
          f"{name}: UPDATE max |kernel - plain| {err:.3e} over tolerance")
    N, C = args[0].shape
    K = args[2].shape[1]
    if dropout:
        dropped = hash_uniform(seed, torch.arange(N, device=out.device),
                               torch.arange(K, device=out.device)) < dropout
        differ = (out == 0) != (want == 0)
        check(bool((out[dropped] == 0).all()) and not bool(
            (differ & (dropped | (want.abs() > 1e-4))).any()),
            f"{name}: the dropout's zero pattern differs")
    route = uf.fwd_route(N, K, torch.cuda.get_device_properties(
        out.device).multi_processor_count)
    row = {"shape": f"N {N}, C {C}, K {K}, relu {relu}, dropout {dropout}",
           "route": route, "max_abs_err": err}
    if timed:
        # on the CUDA cores in float32 (FFMA), or (the route taken) as
        # three TF32 products on the tensor cores beside the epilogue
        row["bound_ms"], row["bound_by"], row["bound_ffma_ms"] = work_bound(
            step_cost.update_fwd_work(*args))
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: uf.update_fused_fwd(*args, **kw))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.fused_update_ref(*args, **kw))
        # the yardstick (never called by the port): one float32 addmm of
        # the products and the bias, no ReLU and no dropout, with the
        # concatenations made outside the timed window
        x = torch.cat([args[0], args[1]], 1)
        w = torch.cat([args[2], args[3]], 0)
        lib = torch.addmm(args[4], x, w)
        pre = args[0] @ args[2] + args[1] @ args[3] + args[4]
        ok, _ = close_to(lib, pre)
        check(ok, f"{name}: addmm of the concatenations is not UPDATE's "
                  f"products")
        row["library_ms"], _ = time_ms(
            torch, lambda: torch.addmm(args[4], x, w))
        del x, w, lib, pre
    return out, row


def update_bwd_case(torch, uf, ref, name, g, out, relu, dropout, seed,
                    timed=True):
    kw = dict(relu=relu, dropout=dropout, seed=seed)
    dz, db = uf.update_fused_bwd(g, out, **kw)
    _, db2 = uf.update_fused_bwd(g, out, **kw)
    torch.cuda.synchronize()
    dz_p, db_p = ref.fused_update_bwd_ref(g, out, **kw)
    ok, err = close_to(db, db_p)
    check(torch.equal(dz, dz_p), f"{name}: UPDATE dZ is not bit-exact")
    check(bool(torch.isfinite(db).all()) and ok,
          f"{name}: UPDATE db max |kernel - plain| {err:.3e} over tolerance")
    check(torch.equal(db.view(torch.int32), db2.view(torch.int32)),
          f"{name}: UPDATE db differs between two calls")
    N, K = g.shape
    stripes = uf.bwd_stripes(N, torch.cuda.get_device_properties(
        g.device).multi_processor_count)
    row = {"shape": f"N {N}, K {K}, relu {relu}, dropout {dropout}",
           "route": f"one launch, {stripes} stripes, db by the last block",
           "max_abs_err": err, "library_ms": None}
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.update_bwd_work(g, out, relu=relu))
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: uf.update_fused_bwd(g, out, **kw))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.fused_update_bwd_ref(g, out, **kw))
    return row


def print_row(kernel, row, phase="phase 4"):
    lib = row.get("library_ms")
    ffma = row.get("bound_ffma_ms")
    print(f"{phase}: {kernel} {row['shape']}"
          + (f" [{row['route']}]" if "route" in row else "")
          + f": max|d|={row['max_abs_err']:.3e}"
          f"; device ms kernel {row['ms']:.4f}, plain {row['plain_ms']:.4f}"
          + (f", library {lib:.4f}" if lib is not None else "")
          + f", bound {row['bound_ms']:.4f} ({row['bound_by']})"
          + (f", FFMA bound {ffma:.4f}" if ffma is not None else "")
          + (f", slot index build {row['index_ms']:.4f}"
             if "index_ms" in row else "")
          + f"; per call kernel {row['call_ms']:.4f}"
          + (f"; {row['repeats_bitwise']} launches bit-equal, longest "
             f"source row {row['longest_row_slots']} slots"
             if "repeats_bitwise" in row else "")
          + (f", {row['rows_bitwise_plain']} of {row['rows']} rows the "
             f"plain version's bits" if "rows_bitwise_plain" in row else ""))


def first_inputs(torch, res, r=0):
    """Rank ``r``'s inputs in the run's first minibatch, as the main path
    draws it: ``(mb, nodes, own, h)``, ``h`` its layer-0 rows."""
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import minibatch_to_device
    ps, cfg, data = res["ps"], res["cfg"], res["data"]
    plan = SamplingPlan(ps, cfg, 0)
    mb = minibatch_to_device(plan.sample_host(0, 0, plan.epoch_schedule(0)[0]),
                             torch.device("cuda"))
    num_solid = data["num_solid"][r]
    feats = data["features"][r]
    nodes = [n[r] for n in mb["layer_nodes"]]
    own = [m[r] & (n < num_solid) for n, m in zip(nodes, mb["node_mask"])]
    h = feats[nodes[0].clamp(0, feats.shape[0] - 1).long()] \
        * own[0][:, None].float()
    return mb, nodes, own, h


def show_row(kernel, row, phase):
    """A timed row in full; an untimed one (a check alone) in short."""
    if "ms" in row:
        print_row(kernel, row, phase)
    else:
        print(f"{phase}: {kernel} {row['shape']}"
              + (f" [{row['route']}]" if "route" in row else "")
              + f": max|d|={row['max_abs_err']:.3e}, within tolerance")


def lookup_case(torch, hs, res, nodes, k, name, phase, timed, r=0):
    """B at layer k's lookups of rank r's nodes on the run's cache."""
    data, state = res["data"], res["state"]
    vid_o = data["vid_o"][r]
    vids = torch.where(nodes[k] >= 0,
                       vid_o[nodes[k].clamp(0, vid_o.shape[0] - 1).long()],
                       -1)
    row = hec_case(torch, hs, name, state["hec"][k][r],
                   vids.to(torch.int32).contiguous(), timed)
    print(f"{phase}: hec_lookup {row['shape']} ({row['hits']} hits): "
          f"bit-exact" + (f"; device ms kernel {row['ms']:.4f}, plain "
                          f"{row['plain_ms']:.4f}, bound "
                          f"{row['bound_ms']:.5f} ({row['bound_by']})"
                          if timed else ""))
    return row


def sage_layer_cases(torch, res, phase, timed=True, gen=None):
    """C-F against their plain versions at the layer shapes of the run's
    first minibatch (rank 0), and B at its lookups on the run's caches;
    returns the rows by kernel.  ``gen`` draws the gradients."""
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import update_fused as uf
    cfg, state = res["cfg"], res["state"]
    dev = torch.device("cuda")
    mb, nodes, own, h = first_inputs(torch, res)
    r, L = 0, cfg.num_layers
    rows = {n: [] for n in ("update_fused_fwd", "update_fused_bwd",
                            "sage_agg_fwd", "sage_agg_bwd", "hec_lookup")}
    gen = gen or torch.Generator(device=dev).manual_seed(4)
    for k, layer in enumerate(state["model"].layers):
        nbr = mb["nbr_idx"][k][r]
        M = nbr.shape[0]
        last = k == L - 1
        mean, cnt, row = agg_case(torch, sa, ref, f"layer {k}", h, nbr,
                                  own[k], timed)
        rows["sage_agg_fwd"].append(row)
        show_row("sage_agg_fwd (E)", row, phase)
        g = torch.randn(mean.shape, generator=gen, device=dev)
        if k > 0:                      # layer 0's input needs no gradient
            row = agg_bwd_case(torch, sa, ref, f"layer {k}", g, nbr, own[k],
                               cnt, h.shape[0], timed)
            rows["sage_agg_bwd"].append(row)
            show_row("sage_agg_bwd (F)", row, phase)
        w = [layer.wn.detach(), layer.ws.detach(), layer.b.detach()]
        drop = 0.0 if last else cfg.dropout
        out, row = update_case(torch, uf, ref, f"layer {k}",
                               [mean, h[:M], *w], not last, drop, k + 1,
                               timed)
        rows["update_fused_fwd"].append(row)
        show_row("update_fused_fwd (C)", row, phase)
        g = torch.randn(out.shape, generator=gen, device=dev)
        row = update_bwd_case(torch, uf, ref, f"layer {k}", g, out,
                              not last, drop, k + 1, timed)
        rows["update_fused_bwd"].append(row)
        show_row("update_fused_bwd (D)", row, phase)
        rows["hec_lookup"].append(lookup_case(
            torch, hs, res, nodes, k, f"train lookup l{k}", phase, timed))
        h = out
    return rows


def phase4_kernels(torch, np, res):
    """(a): C-F against their plain versions at the layer shapes of the
    main path's first minibatch (rank 0), and B at its lookups on the
    run's caches; then ragged shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import update_fused as uf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = sage_layer_cases(torch, res, "phase 4", gen=gen)
    # ragged shapes: N, C, K, D off every tile, a D without float4 rows,
    # -1 pads, invalid sources, an all-masked row
    for (N, M, f, D) in ((300, 37, 7, 6), (1000, 257, 13, 100)):
        hr = torch.randn(N, D, generator=gen, device=dev)
        nbr = torch.randint(-1, N, (M, f), generator=gen, device=dev,
                            dtype=torch.int32)
        nbr[0] = -1
        vr = torch.rand(N, generator=gen, device=dev) > 0.2
        _, cnt, _ = agg_case(torch, sa, ref, "ragged", hr, nbr, vr,
                             timed=False)
        agg_bwd_case(torch, sa, ref, "ragged", torch.randn(
            M, D, generator=gen, device=dev), nbr, vr, cnt, N, timed=False)
    for (N, C, K) in ((257, 24, 47), (1000, 100, 130)):
        args = [torch.randn(N, C, generator=gen, device=dev),
                torch.randn(N, C, generator=gen, device=dev),
                torch.randn(C, K, generator=gen, device=dev) / 10,
                torch.randn(C, K, generator=gen, device=dev) / 10,
                torch.randn(K, generator=gen, device=dev)]
        for relu, drop in ((True, 0.5), (False, 0.3), (False, 0.0)):
            out, _ = update_case(torch, uf, ref, "ragged", args, relu, drop,
                                 2 ** 32 - 1, timed=False)
            update_bwd_case(torch, uf, ref, "ragged", torch.randn(
                N, K, generator=gen, device=dev), out, relu, drop,
                2 ** 32 - 1, timed=False)
    print("phase 4: ragged shapes (AGG 37x7 D=6, 257x13 D=100; UPDATE "
          "257x24->47, 1000x100->130) within tolerance")
    import hashlib
    for (N, C, K, relu, drop), digest in C_PINNED:
        prng = np.random.default_rng(N + C + K)
        t = lambda *s: torch.as_tensor(  # noqa: E731
            prng.normal(size=s).astype(np.float32), device=dev)
        args = [t(N, C), t(N, C), t(C, K) * 0.1, t(C, K) * 0.1, t(K) * 0.1]
        out = uf.update_fused_fwd(*args, relu=relu, dropout=drop, seed=12345)
        check(hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
              == digest, f"phase 4: UPDATE {N}x{C}->{K} differs from C's "
                         f"pinned output")
    print(f"phase 4: UPDATE (C) bit-equal to its pinned output at "
          f"{len(C_PINNED)} shapes")
    for shape, digest in E_PINNED:
        hn, nn, vn = pinned_agg_inputs(np, *shape)
        h, nbr = (torch.as_tensor(a, device=dev) for a in (hn, nn))
        mean, cnt = sa.sage_agg_fwd(h, nbr, torch.as_tensor(vn, device=dev))
        check(agg_digest(mean, cnt) == digest,
              f"phase 4: AGG (E) at (N, M, f, D) = {shape} differs from its "
              f"pinned output")
        print(f"phase 4: AGG (E) (N, M, f, D) = {shape} "
              f"[{agg_route(torch, sa, h, nbr)}]: bit-equal to its pinned "
              f"output")
        del h, nbr, mean, cnt
    return rows


def rel_norm(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def float64_first_moment(torch, ps, cfg, R, host, mode="aep"):
    """Adam's first moment after step 0 in float64 on the CPU, the
    witness of (c): the step's gradient (at step 0 the HEC and the hot
    tier are empty, so it is a function of the parameters, the minibatch,
    the dropout seed and, in ``sync`` mode, the fetched features alone)
    through the trainer's own forward in ``mode`` with a float64 model and
    features, example-weighted over the ranks, clipped to norm 1 and
    scaled by 1 - b1, as ``adam_update`` does."""
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    # an empty HEC misses at any size: a small one spares the host memory
    # (and the empty tier, like no tier, substitutes nothing)
    cfg = dataclasses.replace(cfg, hec=dataclasses.replace(
        cfg.hec, cache_size=64 * cfg.hec.ways, hot_size=0, hot_budget=0))
    tr = DistTrainer(cfg, R, mode=mode, device="cpu")
    st = tr.init_state(seed=0)
    model = st["model"].double()
    data = build_dist_data(ps, cfg, tr.device)
    data["features"] = data["features"].double()
    mb = minibatch_to_device(host, tr.device)
    params = model.parameter_list()
    grads, examples = [torch.zeros_like(q) for q in params], 0.0
    for r, x in enumerate(tr._inputs(data, mb)):   # one rank's graph at a time
        f = tr._rank_forward(model, st["hec"], st["hot"], data, mb, x, r, 0,
                             cfg.dropout)
        check(mode == "sync" or all(int(hit) == 0 for hit, _, _ in f.hits),
              "the float64 witness hit its empty HEC")
        n = float(f.n_valid)
        for g, d in zip(grads, torch.autograd.grad(f.loss, params)):
            g.add_(d * n)
        examples += n
    grads = [g / max(examples, 1.0) for g in grads]
    gnorm = float(sum(g.square().sum() for g in grads)) ** 0.5
    scale = min(1.0, 1.0 / (gnorm + 1e-9))
    return [0.1 * scale * g for g in grads]


class ExactReluBranches:
    """While active, every GAT projection takes the ReLU branch of its
    exact pre-activation: ``z = pre * (pre64 > 0)``, ``pre`` the float32
    ``addmm`` the layer computes and ``pre64`` the same product in
    float64 on the same device.  The gradient is discontinuous at ReLU's
    kink, and a pre-activation within float32 rounding of zero takes
    either branch by chance: at the reference's initial weights a few of
    the card's ~1e9 pre-activations of a step at batch 256 do, and they
    move layer 0's gradient by ~1e-4 against the float64 witness (which
    takes the exact branch) and the CPU (which takes it there by
    chance).  With the branches pinned, the card, the CPU and
    the witness differ only by float32 arithmetic.  ``flips`` counts the
    pre-activations whose float32 sign was not the exact one.

    "Exact" is relative to the layer's own input, which past layer 0 is
    the run's own float32; a smaller batch leaves that to chance again
    (phase 9 (c) at batch 64 moved the layer-0 attention gradients 1.8e-4
    from the witness on the card and the CPU alike).  So a run can
    record its branches (``record=True``: ``masks``, one per projection
    in call order), and ``replay=masks`` makes a run take another run's
    branches instead: then the runs differ by float32 arithmetic alone."""

    def __init__(self, torch, replay=None, record=False):
        from repro_torch.models.gnn import gat
        self.torch, self.cls, self.flips = torch, gat.GATLayer, 0
        self.replay, self.record, self.masks = replay, record, []

    def __enter__(self):
        torch, self.orig = self.torch, self.cls.project
        self.calls, self.masks = 0, []

        def project(layer, h):
            din, H, dh = layer.w.shape
            b, w = layer.b.reshape(-1), layer.w.reshape(din, H * dh)
            pre = torch.addmm(b, h, w)
            with torch.no_grad():
                if self.replay is None:
                    keep = torch.addmm(b.double(), h.double(),
                                       w.double()) > 0
                else:
                    keep = self.replay[self.calls].to(pre.device)
                self.calls += 1
                if self.record:
                    self.masks.append(keep.cpu())
                self.flips += int(((pre > 0) != keep).sum())
            z = pre * keep
            eye = torch.eye(H, dtype=z.dtype, device=z.device)[:, None, :]
            att = torch.cat([(eye * layer.a_u[:, :, None]).reshape(H * dh, H),
                             (eye * layer.a_v[:, :, None]).reshape(H * dh, H)],
                            1)
            e = z @ att
            return (z.view(-1, H, dh), e[:, :H].contiguous(),
                    e[:, H:].contiguous())
        self.cls.project = project
        return self

    def __exit__(self, *exc):
        self.cls.project = self.orig


def check_setup(phase):
    """The launcher argv of phase 4 (c) or 6 (c) and the config its check
    runs at (GAT: batch ``GAT_CHECK_BATCH``, HEC ``GAT_CHECK_HEC_SIZE``),
    with its ``noisy_leaves`` and whether ReLU branches are pinned."""
    argv = TRAIN_ARGS + ["--vertices", str(TRAIN_VERTICES)]
    if phase == "phase 4":
        return argv, launcher_config(argv), (), False
    argv = argv + ["--model", "gat", "--lr", "0.001", "--hec-size",
                   str(GAT_HEC_SIZE)]
    cfg = launcher_config(argv, batch_size=GAT_CHECK_BATCH)
    cfg = dataclasses.replace(cfg, hec=dataclasses.replace(
        cfg.hec, cache_size=GAT_CHECK_HEC_SIZE))
    return argv, cfg, GAT_CPU_NOISY_LEAVES, True


def first_steps(ps, cfg, steps=CHECK_STEPS):
    """The host minibatches of an epoch-0 run's first ``steps`` steps."""
    from repro_torch.pipeline.prefetcher import SamplingPlan
    plan = SamplingPlan(ps, cfg, 0)
    sched = plan.epoch_schedule(0)
    return [plan.sample_host(0, i, sched[i]) for i in range(steps)]


def check_run(torch, tr, ps, cfg, hosts, trace, exact_relu=False):
    """(c)'s run of ``tr`` from the launcher's initial state over
    ``hosts``: per step the metrics and seconds, Adam's first moment and
    the pushed tags after step 0, the HEC tags after the last; the last
    step traced with ``trace``; with ``exact_relu`` every GAT projection
    on its exact ReLU branch (``flips``: how many float32 signs were
    not)."""
    from repro_torch import obs
    from repro_torch.train.gnn_trainer import (build_dist_data,
                                               minibatch_to_device)
    pin = ExactReluBranches(torch) if exact_relu else None
    st = tr.init_state(seed=0)             # the launcher's --seed 0
    data = build_dist_data(ps, cfg, tr.device)
    out = {"logs": [], "secs": []}
    with pin if pin is not None else contextlib.nullcontext():
        for i, host in enumerate(hosts):
            mb = minibatch_to_device(host, tr.device)
            traced = trace and i == len(hosts) - 1
            # the device's share of one step: the union of its intervals
            with (obs.DeviceTrace(tr.device) if traced
                  else contextlib.nullcontext()) as dt:
                t0 = time.perf_counter()
                out["logs"].append(tr.train_step(st, data, mb, i))
                out["secs"].append(time.perf_counter() - t0)
            if traced:
                out["profile"] = dt.summary()
            if i == 0:                 # copies: the state moves on in place
                out["mu"] = [m.cpu().clone() for m in st["opt"].mu]
                out["pushed"] = [q["tags"][-1].cpu().clone()
                                 for q in st["inflight"]]
    out["tags"] = [[s.tags.cpu() for s in layer] for layer in st["hec"]]
    out["flips"] = pin.flips if pin is not None else 0
    del st, data
    if tr.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cpu_half(phase, path):
    """(c)'s CPU half of ``phase`` (phase 4 or 6), in the CPU worker: the
    launcher's graph, partition and config, the CPU's run over the same
    first minibatches, and (GAT) the float64 witness of step 0; saved to
    ``path``."""
    import torch

    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.launch import train
    from repro_torch.train.gnn_trainer import DistTrainer
    argv, cfg, noisy, exact_relu = check_setup(phase)
    args = train.parse_args(argv)
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=args.degree,
                        num_classes=args.classes, feat_dim=args.feat_dim,
                        seed=args.seed)
    ps = partition_graph(g, args.ranks, seed=args.seed)
    hosts = first_steps(ps, cfg)
    out = check_run(torch, DistTrainer(cfg, args.ranks, device="cpu"), ps,
                    cfg, hosts, trace=False, exact_relu=exact_relu)
    if noisy:
        t0 = time.perf_counter()
        out["witness"] = float64_first_moment(torch, ps, cfg, args.ranks,
                                              hosts[0])
        out["witness_s"] = time.perf_counter() - t0
    CpuWorker.save(torch, out, path)


def cpu_check(torch, np, phase, res, worker):
    """(c): the main path's first ``CHECK_STEPS`` steps from the same
    state, minibatches and uniforms, on the card here and on the CPU in
    the CPU worker (:class:`CpuWorker`; GAT at batch ``GAT_CHECK_BATCH``,
    as a CPU step at the main path's batch is too slow).  Gradients are
    compared after the first step (Adam's first moment), before Adam's
    per-entry normalization can move a float-noise gradient entry by a
    full step of either sign on each device: each parameter tensor within
    1e-4 relative but the ``noisy_leaves``; when there are any, every
    tensor of the card is also held within 1e-4 relative of a float64
    witness on the CPU (:func:`float64_first_moment`), beside which the
    CPU's float32 is printed.  The card's last step at the main path's
    batch is traced (once more on the card alone when the check ran at
    another batch).  Returns a function that waits for the CPU's half and
    makes the comparison."""
    from repro_torch.train.gnn_trainer import DistTrainer
    ps, R = res["ps"], res["trainer"].num_ranks
    _, cfg, noisy_leaves, exact_relu = check_setup(phase)
    steps = CHECK_STEPS
    hosts = first_steps(ps, cfg)
    # both trainers draw the reference's selection uniforms themselves:
    # the card's Threefry must give the CPU's bits
    card = DistTrainer(cfg, R, device="cuda")
    cpu = DistTrainer(cfg, R, device="cpu")
    shape = (R, hosts[0]["layer_nodes"][0].shape[1])
    for r in range(R):
        check(torch.equal(card.push_uniforms(0, r, shape).cpu(),
                          cpu.push_uniforms(0, r, shape)),
              f"{phase} (c): rank {r}'s push uniforms differ on the card")
    u_ms, u_call = time_ms(torch, lambda: card.push_uniforms(1, 0, shape),
                           iters=4, warmup=1)
    print(f"{phase} (c): push uniforms {shape} per rank, bit-equal on the "
          f"card and the CPU: device ms {u_ms:.4f}, per call {u_call:.4f} "
          f"(x {R} ranks per step)")
    at_main = cfg == res["cfg"]
    c = check_run(torch, card, ps, cfg, hosts, trace=at_main and
                  not exact_relu, exact_relu=exact_relu)
    traced_profile = c.get("profile")
    if traced_profile is None:     # the check ran at another batch or pinned
        traced_profile = check_run(
            torch, DistTrainer(res["cfg"], R, device="cuda"), ps,
            res["cfg"], first_steps(ps, res["cfg"]), trace=True)["profile"]
    if at_main:
        check(c["logs"][0]["loss"] == res["trainer"].step_log[0]["loss"],
              f"{phase} (c): the card's first step is not the main path's")
    h = res["history"][0]
    steps_b = len(res["trainer"].step_log)
    main_cfg = res["cfg"]

    def compare():
        p = worker.result(phase)
        if exact_relu:
            for dev, run in (("card", c), ("cpu", p)):
                print(f"{phase} (c): {dev}: {run['flips']} pre-activations "
                      f"took the other ReLU branch in float32; pinned to "
                      f"the exact branch for the comparison")
        for i in range(steps):
            for key in ("loss", "grad_norm"):
                a, b = c["logs"][i][key], p["logs"][i][key]
                check(abs(a - b) <= 1e-4 * abs(b), f"{phase} (c): step {i} "
                      f"{key}: card {a} vs CPU {b}")
        fmt = lambda xs: [float(f"{x:.3e}") for x in xs]  # noqa: E731
        rels = [rel_norm(a, b) for a, b in zip(c["mu"], p["mu"])]
        print(f"{phase} (c): gradient (Adam mu) relative difference per "
              f"parameter, leaf order: {fmt(rels)}; norms "
              f"{fmt(float(m.norm()) for m in p['mu'])}")
        held = max((r for i, r in enumerate(rels) if i not in noisy_leaves),
                   default=0.0)
        witness = ""
        if noisy_leaves:
            w = p["witness"]
            vs = {dev: [rel_norm(a.double(), b) for a, b in zip(run["mu"], w)]
                  for dev, run in (("card", c), ("cpu", p))}
            witness = (f"against the float64 witness ({p['witness_s']:.1f} "
                       f"s on the CPU), per parameter: card "
                       f"{fmt(vs['card'])}; CPU float32 {fmt(vs['cpu'])}")
            print(f"{phase} (c): {witness}")
            worst = max(vs["card"])
            check(worst <= 1e-4, f"{phase} (c): the card's gradient (Adam "
                  f"mu) is {worst:.3e} relative from the float64 witness")
        check(held <= 1e-4, f"{phase} (c): gradient (Adam mu) differs by "
              f"{held:.3e} relative" + (f"; {witness}" if witness else ""))
        check(all(torch.equal(a, b) for a, b in zip(c["pushed"],
                                                    p["pushed"])),
              f"{phase} (c): the pushed tags differ")
        check(all(torch.equal(a, b) for la, lb in zip(c["tags"], p["tags"])
                  for a, b in zip(la, lb)), f"{phase} (c): the HEC tags "
              f"differ")
        filled = sum(int((t >= 0).sum()) for layer in c["tags"]
                     for t in layer)
        check(steps < 2 or filled > 0, f"{phase} (c): no HEC line was "
              f"filled")
        print(f"{phase} (c): {steps} steps at batch {cfg.batch_size}, card "
              f"vs CPU: losses {[m['loss'] for m in c['logs']]} vs "
              f"{[m['loss'] for m in p['logs']]}; gradient rel. diff "
              f"{held:.2e}" + (f" but for leaves {list(noisy_leaves)}"
                               if noisy_leaves else "") + "; pushed "
              f"tags and {filled} HEC tags equal; CPU s/step (in the CPU "
              f"worker) {[round(s, 1) for s in p['secs']]}")
        dp = traced_profile
        busy_ms = dp["busy_us"] / 1e3
        print(f"{phase} (c): traced card step {steps - 1} at batch "
              f"{main_cfg.batch_size}: {dp['wall_us'] / 1e3:.1f} "
              f"ms wall, device busy {busy_ms:.2f} ms "
              f"({100 * dp['busy_share']:.1f}%, the union over "
              f"{len(dp['streams'])} streams); against the main path's "
              f"{1e3 * h['t_wall'] / steps_b:.1f} ms of epoch wall per "
              f"step, a busy share of "
              f"{100 * busy_ms * steps_b / (1e3 * h['t_wall']):.1f}"
              f"% (indicative)")
        for row in dp["top"]:
            print(f"{phase} (c):   {row['device_us'] / 1e3:8.3f} ms  "
                  f"{row['calls']:5d}x  {row['name'][:90]}")
        return dp
    return compare


CPU_WORKER_DIR = os.path.join(ROOT, "build", "cpu_worker")
CPU_WORKER_THREADS = 4      # torch threads of the CPU worker (of the host's)
CPU_WORKER_JOBS = ("phase 4", "phase 6", "phase 9 (c)", "phase 14 (a)",
                   "phase 15 (a)")


class CpuWorker:
    """One child process beside the card phases, started after the build:
    the CPU halves of phases 4 (c) and 6 (c) (each saved under
    ``CPU_WORKER_DIR`` for this process to compare with its card half),
    then all of phase 9 (c) (its CPU runs and the card runs that start from
    their states; its lines are printed here by :meth:`finish`), in that
    order, then phase 14 (a)'s float32 units and phase 15 (a) (both
    halves, their lines printed by :meth:`finish`), with
    ``CPU_WORKER_THREADS`` torch threads.  Phase 9 (c) waits for
    :meth:`go` (its card runs take ~10 GB, which phase 11 (b)'s and 12
    (b)'s GAT at a 1M-entry HEC, ~68 GB, leave no room for), phase 15 (a)
    for ``go("15")`` (~34 GB, past phase 13's 47 GB)."""

    def __init__(self):
        import shutil
        shutil.rmtree(CPU_WORKER_DIR, ignore_errors=True)
        os.makedirs(CPU_WORKER_DIR)
        self.log = os.path.join(CPU_WORKER_DIR, "worker.log")

    def start(self):
        self.t0 = time.perf_counter()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; "
                 "chip_smoke.cpu_worker_main()"], cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT)
        CHILDREN.append(self.proc)
        return self

    @staticmethod
    def path(job):
        return os.path.join(CPU_WORKER_DIR, job.replace(" ", "_")
                            .replace("(", "").replace(")", "") + ".pt")

    @staticmethod
    def save(torch, obj, path):
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)

    def go(self, gate="9"):
        """Lets the worker start phase 9 (c) (gate "9") or 15 (a) ("15")."""
        with open(os.path.join(CPU_WORKER_DIR, f"go{gate}"), "w"):
            pass

    def _tail(self):
        with open(self.log) as f:
            return f.read()[-3000:]

    def result(self, job):
        """Waits for ``job``'s file (failing if the worker died first)."""
        import torch
        path = self.path(job)
        t0 = time.perf_counter()
        while not os.path.exists(path):
            check(self.proc.poll() is None, f"the CPU worker exited "
                  f"{self.proc.returncode} before {job}:\n{self._tail()}")
            time.sleep(0.2)
        waited = time.perf_counter() - t0
        if waited > 1:
            print(f"{job}: waited {waited:.1f} s for the CPU worker")
        return torch.load(path, weights_only=False)

    def finish(self):
        """Waits for the worker, prints phase 9 (c)'s lines from its log
        and its seconds."""
        rc = self.proc.wait()
        check(rc == 0, f"the CPU worker exited {rc}:\n{self._tail()}")
        with open(self.log) as f:
            for line in f:
                if line.startswith(("phase 9 (c)", "phase 14 (a)",
                                    "phase 15 (a)")):
                    print(line.rstrip())
                elif line.startswith("cpu worker: "):
                    job, secs = line[12:].rsplit(" in ", 1)
                    PHASE_SECONDS[f"{job} (CPU worker)"] = float(
                        secs.split()[0])
                    print(line.rstrip())
        return time.perf_counter() - self.t0


def cpu_worker_main():
    """The CPU worker's process (see :class:`CpuWorker`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    torch.set_num_threads(CPU_WORKER_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gates = {"phase 9 (c)": "go9", "phase 15 (a)": "go15"}
    for job in CPU_WORKER_JOBS:
        while job in gates and not os.path.exists(
                os.path.join(CPU_WORKER_DIR, gates[job])):
            time.sleep(0.2)
        t0 = time.perf_counter()
        if job == "phase 9 (c)":
            _build.build(KERNELS)
            phase9_check(torch, np)
        elif job == "phase 14 (a)":
            with torch.no_grad():
                phase14_units(torch, np)
        elif job == "phase 15 (a)":
            phase15_units(torch, np)
        else:
            cpu_half(job, CpuWorker.path(job))
        print(f"cpu worker: {job} in {time.perf_counter() - t0:.1f} s",
              flush=True)


# ---------------------------------------------------------------------------
# phases 5 and 6: GAT
# ---------------------------------------------------------------------------
def gat_case(torch, ge, ref, name, z, e_u, e_v, nbr, valid, dst_idx=None,
             timed=True):
    """Kernel G vs plain on one input; returns the kernel's output and a
    row."""
    out = ge.gat_edge_fwd(z, e_u, e_v, nbr, valid, dst_idx)
    torch.cuda.synchronize()
    want = ref.gat_edge_ref(z, e_u, e_v, nbr, valid, dst_idx)
    ok, err = close_to(out, want)
    check(bool(torch.isfinite(out).all()) and ok,
          f"{name}: GAT AGG max |kernel - plain| {err:.3e} over tolerance")
    N, H, dh = z.shape
    M, f = nbr.shape
    route, cw = ge.fwd_plan(
        M, f, H, dh, dh % 4 == 0 and z.data_ptr() % 16 == 0,
        torch.cuda.get_device_properties(z.device).multi_processor_count)
    row = {"shape": f"z {N}x{H}x{dh}, nbr {M}x{f}"
                    + (", dst_idx" if dst_idx is not None else ""),
           "route": route + (f", {cw} vector columns per warp" if cw else ""),
           "max_abs_err": err, "library_ms": None}
    del want
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.gat_fwd_work(z, e_u, e_v, nbr, valid, dst_idx))
        row["ms"], row["call_ms"] = time_ms(torch, lambda: ge.gat_edge_fwd(
            z, e_u, e_v, nbr, valid, dst_idx))
        # the plain version launches tens of torch ops per call: fewer
        # calls, so that they fit in the queue behind the device sleep
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.gat_edge_ref(z, e_u, e_v, nbr, valid, dst_idx),
            iters=10)
    return out, row


def gat_bwd_case(torch, ge, ref, name, g, z, e_u, e_v, nbr, valid,
                 dst_idx=None, timed=True):
    """Kernel H on one input: three launches through one slot index bit
    for bit, within tolerance of the plain version (in float64 where a
    source row has more than ``CHUNK`` slots).  Timed with the index
    built beforehand; the build is timed apart."""
    from repro_torch.kernels import slot_index as si
    N, H, dh = z.shape
    ix = si.slot_index(nbr, valid, N)
    dix = ge.dst_index(dst_idx, e_v.shape[0]) if dst_idx is not None \
        else None
    runs = [ge.gat_edge_bwd(g, z, e_u, e_v, nbr, valid, dst_idx, ix, dix)
            for _ in range(3)]
    torch.cuda.synchronize()
    got = runs[0]
    check(all(torch.equal(a, b) for r in runs[1:] for a, b in zip(got, r)),
          f"{name}: H's launches differ in their bits")
    del runs
    lens = ix.offsets[1:] - ix.offsets[:-1]
    longest = int(lens.max()) if N else 0
    # a row of thousands of slots sums in float32 to ~1e-4 in any order
    # (the plain version's atomics included): there both are held to the
    # plain version in float64
    wide = longest > si.CHUNK
    want = ref.gat_edge_bwd_ref(
        *[t.double() for t in (g, z, e_u, e_v)], nbr, valid, dst_idx) \
        if wide else ref.gat_edge_bwd_ref(g, z, e_u, e_v, nbr, valid,
                                          dst_idx)
    errs = []
    for label, a, b in zip(("dz", "de_u", "de_v"), got, want):
        ok, err = close_to(a, b)
        check(bool(torch.isfinite(a).all()) and ok,
              f"{name}: GAT AGG gradient {label} max |kernel - plain"
              f"{' in float64' if wide else ''}| {err:.3e} over tolerance")
        errs.append(err)
    M, f = nbr.shape
    row = {"shape": f"g {M}x{H * dh}, nbr {M}x{f} -> dz {N}x{H}x{dh}"
                    + (", dst_idx" if dst_idx is not None else ""),
           "max_abs_err": max(errs), "library_ms": None,
           "repeats_bitwise": 3, "longest_row_slots": longest}
    if wide:
        row["held_to"] = "the plain version in float64"
    del got, want, a, b
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.gat_bwd_work(g, z, e_u, e_v, nbr, valid, dst_idx, ix))
        row["ms"], row["call_ms"] = time_ms(torch, lambda: ge.gat_edge_bwd(
            g, z, e_u, e_v, nbr, valid, dst_idx, ix, dix))
        row["index_ms"], row["index_call_ms"] = time_ms(
            torch, lambda: si.slot_index(nbr, valid, N))
        # about 80 torch ops per call: 3 calls fit in the launch queue
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.gat_edge_bwd_ref(g, z, e_u, e_v, nbr, valid,
                                                dst_idx), iters=3)
    return row


def peak_line(torch, phase):
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{phase}: peak device memory {peak / 2 ** 30:.2f} GiB of "
          f"{total / 2 ** 30:.2f} GiB ({100 * peak / total:.1f}%)")


def phase5(torch, np, args):
    """GAT serving through the launcher; returns the launches, G's rows
    (online and offline) and B's rows at the path's probe shapes."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels import ref
    from repro_torch.launch import gnn_serve
    from repro_torch.pipeline.vectorized_sampler import \
        sample_blocks_vectorized
    from repro_torch.serve.gnn import full_neighbor_matrix

    torch.cuda.reset_peak_memory_stats()
    largs = gnn_serve.parse_args([
        "--model", "gat", "--preset", "gat-papers100m", "--slots",
        str(SLOTS), "--vertices", str(args.vertices), "--queries",
        str(args.queries), "--device", "cuda"])
    zero_launches()
    res = gnn_serve.run(largs)
    launches = read_launches()
    print(f"phase 5: launches on the GAT serving path: {launches}")
    srv, part, cfg = res["srv"], res["part"], res["cfg"]
    model, L, S = srv.model, cfg.num_layers, part.num_solid
    # every microbatch (warm-up, cold and warm passes) runs G once per
    # layer; the pre-warm once per layer and chunk of dst rows
    microbatches = srv._mb_counter
    chunks = -(-S // OFFLINE_CHUNK)
    want = L * (microbatches + chunks)
    check(launches["gat_edge_fwd"] == want, f"phase 5: G launched "
          f"{launches['gat_edge_fwd']} times, expected {want} ({L} x "
          f"({microbatches} microbatches + {chunks} offline chunks))")
    check(launches["hec_lookup"] > 0, "phase 5: B was never launched")
    for n in ("serve_fused_layer", "update_fused_fwd", "update_fused_bwd",
              "sage_agg_fwd", "sage_agg_bwd", "gat_edge_bwd"):
        check(launches[n] == 0, f"phase 5: {n} launched on the GAT path")
    cold, warm = res["cold"], res["warm"]
    check(all(r.done and np.isfinite(r.result).all() for r in cold + warm),
          "phase 5: an answer is missing or non-finite")
    offline = res["embs"][-1].cpu().numpy()
    fast = [r for r in warm if r.served_by == "output_cache"]
    check(len(fast) > 0, "phase 5: the warm pass had no fast-path answer")
    check(all(np.array_equal(r.result, offline[r.vid]) for r in fast),
          "phase 5: a fast-path answer differs from its offline row")

    # every pre-warm layer against the plain version on its own input
    dev = torch.device("cuda")
    nbr_full = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                               device=dev)
    ones = torch.ones(S, dtype=torch.bool, device=dev)
    vids = torch.arange(S, dtype=torch.int32, device=dev)
    h = torch.as_tensor(part.features, device=dev)
    offline_err, rows_g = 0.0, []
    for k, (layer, e) in enumerate(zip(model.layers, res["embs"])):
        z, e_u, e_v = layer.project(h)
        want = ref.gat_edge_ref(z, e_u, e_v, nbr_full, ones, vids)
        torch.cuda.synchronize()
        ok, err = close_to(e, want)
        check(e.shape == want.shape and bool(torch.isfinite(e).all()) and ok,
              f"phase 5: offline layer {k + 1}: shape {tuple(e.shape)}, max "
              f"|kernel - plain| {err:.3e}")
        offline_err = max(offline_err, err)
        # the first chunk of the layer, timed
        _, row = gat_case(torch, ge, ref, f"offline chunk layer {k}", z, e_u,
                          e_v, nbr_full[:OFFLINE_CHUNK], ones,
                          vids[:OFFLINE_CHUNK])
        row["path"] = "offline"
        rows_g.append(row)
        print_row("gat_edge_fwd (G)", row, "phase 5")
        h = e
        del z, e_u, e_v, want
    print(f"phase 5: offline embeddings of {S} vertices, {L * chunks} G "
          f"launches ({chunks} chunks x {L} layers, neighbor lists "
          f"{nbr_full.shape[1]} wide), match the plain version: max|d|="
          f"{offline_err:.3e}")

    # a microbatch's shapes: G per layer, and B on the server's caches
    rng = np.random.default_rng(5)
    seeds = rng.choice(S, size=SLOTS, replace=False)
    blocks = sample_blocks_vectorized(part, seeds, cfg.fanouts,
                                      np.random.default_rng([5, 0]), SLOTS)
    feats = torch.as_tensor(part.features, device=dev)
    nodes0 = torch.as_tensor(blocks.layer_nodes[0], device=dev)
    valid = torch.as_tensor(blocks.node_mask[0], device=dev)
    h = feats[nodes0.clamp(0, S - 1)] * valid[:, None]
    for k, layer in enumerate(model.layers):
        nbr = torch.as_tensor(blocks.nbr_idx[k], dtype=torch.int32,
                              device=dev)
        z, e_u, e_v = layer.project(h)
        h, row = gat_case(torch, ge, ref, f"serve layer {k}", z, e_u, e_v,
                          nbr, valid)
        row["path"] = "online"
        rows_g.append(row)
        print_row("gat_edge_fwd (G)", row, "phase 5")
        valid = torch.as_tensor(blocks.node_mask[k + 1], device=dev)
    rows_b = []
    probes = [(k, blocks.layer_nodes[k]) for k in range(1, L)] \
        + [(L, blocks.seeds)]
    for k, nodes in probes:
        row = hec_case(torch, hs, f"GAT serve probe l{k}",
                       srv.cache.states[k - 1],
                       torch.as_tensor(nodes, dtype=torch.int32, device=dev))
        rows_b.append(row)
        print(f"phase 5: hec_lookup {row['shape']} ({row['hits']} hits): "
              f"bit-exact; device ms kernel {row['ms']:.4f}, plain "
              f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} "
              f"({row['bound_by']})")
    print(f"phase 5: cold {res['cold_qps']:.1f} q/s "
          f"({res['cold_metrics']['steps_run']} microbatches), warm "
          f"{res['warm_qps']:.1f} q/s ({len(fast)}/{len(warm)} fast-path "
          f"answers equal to their offline rows); indicative only")
    peak_line(torch, "phase 5")
    return launches, rows_g, rows_b, microbatches, chunks, offline_err


def phase6_main_path(torch, np, vertices):
    """(b) of phase 6: GAT; per step G, H and its slot index build at every
    layer of every rank and B at every layer, per eval batch G and B."""
    R, L = 4, 3                              # TRAIN_ARGS' ranks and layers
    per_step = {"hec_lookup": L * R, "gat_edge_fwd": L * R,
                "gat_edge_bwd": L * R, "slot_index": L * R}
    per_eval = {"hec_lookup": L * R, "gat_edge_fwd": L * R}
    torch.cuda.reset_peak_memory_stats()
    # argparse keeps the last of a repeated flag: these override TRAIN_ARGS
    argv = TRAIN_ARGS + ["--vertices", str(vertices), "--model", "gat",
                         "--lr", "0.001", "--hec-size", str(GAT_HEC_SIZE)]
    print(f"phase 6 (b): HEC of {GAT_HEC_SIZE} entries x 8 ways per layer "
          f"and rank")
    res, launches = train_main_path(torch, np, "phase 6", argv, per_step,
                                    per_eval)
    peak_line(torch, "phase 6 (b)")
    return res, launches


def gat_layer_cases(torch, res, phase, timed=True, gen=None):
    """G and H against their plain versions at the layer shapes of the
    run's first minibatch (rank 0), and B at its lookups on the run's
    caches; returns the rows by kernel.  ``gen`` draws the gradients."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    mb, nodes, own, h = first_inputs(torch, res)
    r = 0
    rows = {n: [] for n in ("gat_edge_fwd", "gat_edge_bwd", "hec_lookup")}
    gen = gen or torch.Generator(device=dev).manual_seed(6)
    for k, layer in enumerate(res["state"]["model"].layers):
        nbr = mb["nbr_idx"][k][r]
        z, e_u, e_v = layer.project(h)
        out, row = gat_case(torch, ge, ref, f"layer {k}", z, e_u, e_v, nbr,
                            own[k], timed=timed)
        rows["gat_edge_fwd"].append(row)
        show_row("gat_edge_fwd (G)", row, phase)
        g = torch.randn(out.shape, generator=gen, device=dev)
        row = gat_bwd_case(torch, ge, ref, f"layer {k}", g, z, e_u, e_v, nbr,
                           own[k], timed=timed)
        rows["gat_edge_bwd"].append(row)
        show_row("gat_edge_bwd (H)", row, phase)
        del z, e_u, e_v, g
        rows["hec_lookup"].append(lookup_case(
            torch, hs, res, nodes, k, f"GAT train lookup l{k}", phase, timed))
        h = out
    return rows


def phase6_kernels(torch, np, res):
    """(a): G and H against their plain versions at the layer shapes of
    the main path's first minibatch (rank 0) and at a ragged shape, and B
    at its lookups on the run's caches."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import ref
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = gat_layer_cases(torch, res, "phase 6", gen=gen)
    # ragged: dh off the float4 path and on it, f past one chunk of 32
    # slots, -1 pads, indices past N, invalid sources, an all-masked row,
    # clipped and repeated dst ids
    for (N, M, f, H, dh) in ((257, 61, 13, 3, 20), (300, 40, 45, 2, 6)):
        z = torch.randn(N, H, dh, generator=gen, device=dev)
        e_u = torch.randn(N, H, generator=gen, device=dev)
        e_v = torch.randn(N, H, generator=gen, device=dev)
        nbr = torch.randint(-1, N + 3, (M, f), generator=gen, device=dev,
                            dtype=torch.int32)
        nbr[0] = -1
        vr = torch.rand(N, generator=gen, device=dev) > 0.2
        dst = torch.randint(-2, N + 2, (M,), generator=gen, device=dev,
                            dtype=torch.int32)
        out, _ = gat_case(torch, ge, ref, "ragged", z, e_u, e_v, nbr, vr,
                          timed=False)
        check(float(out[0].abs().max()) == 0.0,
              "phase 6 (a): an all-masked row is not zero")
        gat_case(torch, ge, ref, "ragged dst_idx", z, e_u, e_v, nbr, vr,
                 dst, timed=False)
        gat_bwd_case(torch, ge, ref, "ragged", torch.randn(
            M, H * dh, generator=gen, device=dev), z, e_u, e_v, nbr, vr,
            timed=False)
    # G's other forms: a serving-sized M whose columns split across warps,
    # and rows too wide for the one-pass form's shared memory (chunked)
    for (N, M, f, H, dh) in ((700, 45, 15, 4, 256), (500, 30, 400, 4, 8)):
        z = torch.randn(N, H, dh, generator=gen, device=dev)
        e_u = torch.randn(N, H, generator=gen, device=dev)
        e_v = torch.randn(M, H, generator=gen, device=dev)
        nbr = torch.randint(-1, N + 3, (M, f), generator=gen, device=dev,
                            dtype=torch.int32)
        nbr[0] = -1
        vr = torch.rand(N, generator=gen, device=dev) > 0.2
        _, row = gat_case(torch, ge, ref, "ragged form", z, e_u, e_v, nbr, vr,
                          timed=False)
        print(f"phase 6 (a): G {row['shape']} [{row['route']}] within "
              f"tolerance (max|d|={row['max_abs_err']:.3e})")
    print("phase 6 (a): ragged shapes (257 x 13 slots, 3 x 20 heads; 300 x "
          "45 slots, 2 x 6 heads; all-masked rows, dst_idx) within "
          "tolerance")
    peak_line(torch, "phase 6 (a)")
    return rows


# ---------------------------------------------------------------------------
# phase 7: training with the fanout draw on the card (kernel I)
# ---------------------------------------------------------------------------
POLICIES = ("uniform", "labor", "cv")
DRAW_EPOCHS = 2             # phase 7 (b): epoch 1 draws with cv weights


def time_blocking_ms(torch, fn, iters: int = 3, warmup: int = 1):
    """ms per call of ``fn`` between CUDA events, for a function that
    waits for the device itself (the plain draw syncs to find the rows
    wider than f): device and host time together, which is what its
    caller waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters


def card_csr(torch, np, indptr, indices, weights, num_solid):
    dev = torch.device("cuda")
    return {"indptr": torch.as_tensor(indptr.astype(np.int32), device=dev),
            "indices": torch.as_tensor(indices.astype(np.int32), device=dev),
            "wtab": torch.as_tensor(weights.astype(np.float32), device=dev),
            "num_solid": num_solid,
            "width": max(int(np.diff(indptr[:num_solid + 1]).max())
                         if num_solid else 0, 1)}


def draw_case(torch, np, sd, ref, name, csr, cur, f, policy, seed,
              allow=None, timed=True, split=False):
    """Kernel I vs its plain version on one input, bit for bit; a row.
    ``split`` also times the kernel with only the take-all (and empty)
    rows allowed and with only the selection rows allowed."""
    dev = torch.device("cuda")
    cur_t = torch.as_tensor(np.asarray(cur).astype(np.int32), device=dev)
    allow_t = None if allow is None else torch.as_tensor(allow, device=dev)
    args = (csr["indptr"], csr["indices"], csr["wtab"], cur_t, seed, allow_t)
    kw = dict(f=f, num_solid=csr["num_solid"], width=csr["width"],
              policy=policy)
    got = sd.sample_draw(*args, **kw)
    torch.cuda.synchronize()
    want = ref.draw_neighbors(*args, **kw)
    check(got.shape == want.shape and torch.equal(got, want),
          f"{name} ({policy}): kernel I differs from the plain draw in "
          f"{int((got != want).sum())} of {want.numel()} entries")
    n = cur_t.shape[0]
    group = sd.draw_group(n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    row = {"shape": f"cur {n}, f {f}, {policy}", "policy": policy,
           "route": f"tiles of {group} rows", "max_abs_err": 0.0,
           "library_ms": None}
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.sample_draw_work(*args, **kw))
        ip = csr["indptr"].long()
        valid = (cur_t >= 0) & (cur_t < csr["num_solid"])
        if allow_t is not None:
            valid &= allow_t
        vc = torch.where(valid, cur_t.long(), 0)
        deg = torch.where(valid, ip[vc + 1] - ip[vc], 0)
        row["candidates"] = int(deg.sum())
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: sd.sample_draw(*args, **kw))
        row["plain_ms"] = time_blocking_ms(
            torch, lambda: ref.draw_neighbors(*args, **kw))
        if split:
            for half, a in (("take_all_ms", deg <= f), ("selection_ms",
                                                        deg > f)):
                row[half], _ = time_ms(torch, lambda: sd.sample_draw(
                    *args[:5], a.contiguous(), **kw))
    return row


def ragged_draw_csr(np, rng, S, H, max_deg):
    """S solids over S + H VID_p, degrees up to ``max_deg``: rows of 0, 1,
    3 and 4 neighbors and one listing a vertex five times (a multi-edge),
    each cut to ``max_deg``."""
    deg = rng.integers(0, max_deg + 1, S)
    deg[:5] = np.minimum([0, 1, 3, 4, 9], max_deg)
    rows = [rng.integers(0, S + H, d) for d in deg]
    if max_deg >= 9:
        rows[4] = np.array([7, S + 1, 7, 7, 12, 7, 3, 7, 30])
    return np.concatenate([[0], np.cumsum(deg)]), np.concatenate(rows)


def phase7_main_path(torch, np, res4):
    """(b): ``DistTrainer.train_epochs`` for two epochs and ``evaluate``
    with ``device_draw=True, policy="cv"`` on phase 4's graph, data and
    settings; per step C, D, E, B and I at every layer of every rank and F
    at layers >= 1, per eval batch C, E, B and I."""
    from repro_torch import obs
    from repro_torch.configs.gnn import SamplerConfig
    from repro_torch.train.gnn_trainer import DistTrainer
    ps, data, cfg4 = res4["ps"], res4["data"], res4["cfg"]
    cfg = dataclasses.replace(cfg4, pipeline=dataclasses.replace(
        cfg4.pipeline, sampler=SamplerConfig(policy="cv", device_draw=True)))
    R, L = 4, cfg.num_layers
    per_step = {"hec_lookup": L * R, "update_fused_fwd": L * R,
                "update_fused_bwd": L * R, "sage_agg_fwd": L * R,
                "sage_agg_bwd": (L - 1) * R, "slot_index": (L - 1) * R,
                "sample_draw": L * R}
    per_eval = {"hec_lookup": L * R, "update_fused_fwd": L * R,
                "sage_agg_fwd": L * R, "sample_draw": L * R}
    torch.cuda.reset_peak_memory_stats()
    obs.configure()
    zero_launches()
    tr = DistTrainer(cfg=cfg, num_ranks=R, device="cuda")
    # the residency each epoch's draw reads, kept for (a) and (c)
    residencies, cv_residency = [], tr._cv_residency
    tr._cv_residency = lambda p, st: residencies.append(
        cv_residency(p, st)) or residencies[-1]
    state = tr.init_state(seed=0)
    t0 = time.perf_counter()
    state, hist = tr.train_epochs(ps, data, state, DRAW_EPOCHS, log_every=1)
    secs = time.perf_counter() - t0
    acc = tr.evaluate(ps, data, state)
    launches = read_launches()
    reg = obs.get().registry
    res = {"trainer": tr, "cfg": cfg, "history": hist, "test_acc": acc,
           "state": state, "ps": ps, "residencies": residencies,
           "cv_residency": cv_residency}
    check_training(np, "phase 7", res, launches, per_step, per_eval)
    check([h["sampler_policy"] for h in hist] == ["cv"] * DRAW_EPOCHS,
          "phase 7: an epoch's history does not name the cv policy")
    resident = [int(sum(m.sum() for m in ms)) for ms in residencies]
    check(len(resident) == DRAW_EPOCHS and resident[0] == 0
          and resident[1] > 0, f"phase 7: resident vertices per epoch "
          f"{resident}: epoch 1 must draw with HEC residency")
    steps4 = len(res4["trainer"].step_log)
    per_epoch = len(tr.step_log) // DRAW_EPOCHS
    calls = reg.value("phase_calls", phase="kernel_sample_draw")
    draw_s = reg.value("phase_seconds", phase="kernel_sample_draw")
    print(f"phase 7 (b): resident vertices (all ranks) per epoch "
          f"{resident}; {secs:.2f} s for {DRAW_EPOCHS} epochs")
    print(f"phase 7 (b): sample ms per step, indicative: host draw (phase "
          f"4) {1e3 * res4['history'][0]['t_sample'] / steps4:.1f}; device "
          f"draw " + ", ".join(
              f"epoch {e} {1e3 * h['t_sample'] / per_epoch:.1f}"
              for e, h in enumerate(hist))
          + f"; the kernel_sample_draw span (upload, launch, copy back) "
          f"{calls:.0f} calls, {1e3 * draw_s / max(calls, 1):.3f} ms each")
    peak_line(torch, "phase 7 (b)")
    return res, launches


def phase7_kernels(torch, np, res):
    """(a): kernel I against its plain version at the three layer shapes
    of the main path's first minibatch on rank 0's partition under every
    policy (cv with the residency of (b)'s trained HEC), and at ragged
    shapes; each timed with its bound.  Returns the cv rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sample_draw as sd
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.pipeline.threefry import draw_seed
    ps, cfg = res["ps"], res["cfg"]
    part = ps.parts[0]
    mask = res["cv_residency"](ps, res["state"])[0]
    weights = 1.0 + cfg.pipeline.sampler.cv_boost * mask.astype(np.float32)
    csr = card_csr(torch, np, part.indptr, part.indices, weights,
                   part.num_solid)
    plan = SamplingPlan(ps, cfg, 0, device="cuda")
    plan.set_cv_residency(res["residencies"][0])
    host = plan.sample_host(0, 0, plan.epoch_schedule(0)[0])
    rows = []
    for policy in POLICIES:
        for k in range(cfg.num_layers - 1, -1, -1):
            cur = host["layer_nodes"][k + 1][0]
            row = draw_case(torch, np, sd, ref, f"layer {k}", csr, cur,
                            cfg.fanouts[k], policy, draw_seed(0, 0, 0, 0, k),
                            split=True)
            print(f"phase 7 (a): sample_draw (I) layer {k} {row['shape']} "
                  f"[{row['route']}] ({row['candidates']} candidates): "
                  f"bit-exact; device ms kernel {row['ms']:.4f} (take-all "
                  f"rows alone {row['take_all_ms']:.4f}, selection rows "
                  f"alone {row['selection_ms']:.4f}), plain "
                  f"{row['plain_ms']:.4f} (blocking), bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']}); per call "
                  f"kernel {row['call_ms']:.4f}")
            if policy == "cv":
                rows.append(row)
    # ragged: -1 rows, halos, allow=False, deg == f and deg < f, a
    # multi-edge row (labor keys tie), width < f, n off a multiple of 32
    rng = np.random.default_rng(7)
    for S, H, max_deg, n, f in ((40, 10, 70, 77, 3), (40, 10, 2, 77, 4),
                                (3000, 500, 300, 5001, 15)):
        indptr, indices = ragged_draw_csr(np, rng, S, H, max_deg)
        w = 1.0 + 4.0 * (rng.random(S + H) < 0.3)
        small = card_csr(torch, np, indptr, indices, w, S)
        cur = rng.integers(-1, S + H, n)
        cur[:6] = [-1, S, 0, 1, 2, 4]
        allow = rng.random(n) > 0.1
        for policy in POLICIES:
            for a in (allow, None):
                row = draw_case(torch, np, sd, ref, f"ragged {S}x{max_deg}",
                                small, cur, f, policy, 0xF00DCAFE, a)
                print(f"phase 7 (a): sample_draw (I) ragged S {S}, degree "
                      f"<= {max_deg}, {row['shape']} [{row['route']}], "
                      f"allow {a is not None}: bit-exact; device ms kernel "
                      f"{row['ms']:.4f}, bound {row['bound_ms']:.5f}")
    return rows


def phase7_check(torch, np, res):
    """(c): the minibatches of (b)'s first two steps (and epoch 1's first,
    with the residency (b) installed then), drawn once more on the card
    and on the CPU through the plain draw: every ``stack_ranks`` array
    equal.  First, the host draw's share of the host-drawn first step."""
    from repro_torch.configs.gnn import SamplerConfig
    from repro_torch.pipeline import vectorized_sampler as vs
    from repro_torch.pipeline.prefetcher import SamplingPlan
    ps, cfg = res["ps"], res["cfg"]
    # the host draw's share of a host-drawn step, for comparison: the
    # same first minibatch through the host sampler, its draw timed
    host_plan = SamplingPlan(ps, dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                          sampler=SamplerConfig())), 0)
    spent, host_draw = [0.0], vs._draw_neighbors

    def timed_draw(*a, **kw):
        t = time.perf_counter()
        out = host_draw(*a, **kw)
        spent[0] += time.perf_counter() - t
        return out
    vs._draw_neighbors = timed_draw
    try:
        t0 = time.perf_counter()
        host_plan.sample_host(0, 0, host_plan.epoch_schedule(0)[0])
        total = time.perf_counter() - t0
    finally:
        vs._draw_neighbors = host_draw
    print(f"phase 7 (c): host-drawn sample_host of epoch 0 step 0: "
          f"{1e3 * total:.1f} ms, of which the host draw (_draw_neighbors) "
          f"{1e3 * spent[0]:.1f} ms ({100 * spent[0] / total:.0f}%)")
    compared = 0
    for epoch, steps in ((0, (0, 1)), (1, (0,))):
        plans = [SamplingPlan(ps, cfg, 0, device=d) for d in ("cuda", "cpu")]
        for plan in plans:
            plan.set_cv_residency(res["residencies"][epoch])
        sched = plans[0].epoch_schedule(epoch)
        for step in steps:
            t0 = time.perf_counter()
            card = plans[0].sample_host(epoch, step, sched[step])
            t1 = time.perf_counter()
            cpu = plans[1].sample_host(epoch, step, sched[step])
            t2 = time.perf_counter()
            for k in card:
                for a, b in (zip(card[k], cpu[k]) if isinstance(card[k], list)
                             else [(card[k], cpu[k])]):
                    check(a.dtype == b.dtype and np.array_equal(a, b),
                          f"phase 7 (c): epoch {epoch} step {step}: {k} "
                          f"differs between the card and the CPU")
                    compared += 1
            print(f"phase 7 (c): epoch {epoch} step {step}: every "
                  f"stack_ranks array equal, card and CPU (sample_host "
                  f"{1e3 * (t1 - t0):.1f} ms on the card, "
                  f"{1e3 * (t2 - t1):.1f} ms through the plain draw on the "
                  f"CPU)")
    return compared


# ---------------------------------------------------------------------------
# phase 8: sharded serving, 4 ranks on the card; kernel J
# ---------------------------------------------------------------------------
DIST_RANKS = 4              # the sharded launcher's default
REPLAY_ROUNDS = 2           # rounds of (b) served again on the CPU in (c)


def record_last(owner, name, key):
    """Wrap ``owner.name`` so that the arguments of its last call per
    ``key(*args)`` are kept; returns (the dict, a function that unwraps)."""
    orig = getattr(owner, name)
    last = {}

    def rec(*a, **kw):
        last[key(*a, **kw)] = a
        return orig(*a, **kw)
    setattr(owner, name, rec)
    return last, lambda: setattr(owner, name, orig)


def snapshot(srv, values=True):
    """Device copies of every shard cache and hot replica, and the host
    mirrors and round counter that sampling reads."""
    snap = {"tags": [st.tags.clone() for st in srv.cache.states],
            "ages": [st.age.clone() for st in srv.hot.states]
            if srv.hot is not None else []}
    if values:
        snap.update(
            cache=[(st.age.clone(), st.values.clone())
                   for st in srv.cache.states],
            hot=[st.values.clone() for st in srv.hot.states]
            if srv.hot is not None else [],
            resident=[r.copy() for r in srv.cache.resident],
            valid=[v.copy() for v in srv.hot.valid]
            if srv.hot is not None else [],
            mb_counter=srv._mb_counter)
    return snap


def record_rounds(cls):
    """Keep the first ``REPLAY_ROUNDS`` rounds of the flow, each with the
    state before it (device copies), its groups, and the tags and ages
    after it."""
    orig = cls._run_round
    rec = []

    def wrapped(self, round_groups):
        take = len(rec) < REPLAY_ROUNDS
        before = snapshot(self) if take else None
        out = orig(self, round_groups)
        if take:
            rec.append({"groups": [list(g) for g in round_groups],
                        "before": before,
                        "after": snapshot(self, values=False)})
        return out
    cls._run_round = wrapped
    return rec, lambda: setattr(cls, "_run_round", orig)


def probe_case(torch, hs, name, state, vids, alive=None, timed=True):
    """Kernel J vs plain on one input, bit for bit; returns a row."""
    got = hs.hec_probe(state.tags, state.values, vids, alive)
    torch.cuda.synchronize()
    want = hs.hec_probe_ref(state.tags, state.values, vids, alive)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.equal(
        got.view(torch.int32), want.view(torch.int32))),
        f"{name}: hec_probe (J) not bit-exact against its plain version")
    R, B, n = vids.shape
    _, nsets, ways, d = state.values.shape
    row = {"shape": f"{R} responders x vids {B}x{n}, tags {nsets}x{ways}, "
                    f"d={d}" + (", a dead responder" if alive is not None
                                and not bool(alive.all()) else ""),
           "max_abs_err": 0.0, "hits": int((want[..., d] > 0.5).sum()),
           "negative_vids": int((vids < 0).sum()), "library_ms": None}
    del got, want
    if timed:
        row["bound_ms"], row["bound_by"], _ = work_bound(
            step_cost.hec_probe_work(state.tags, state.values, vids, alive))
        row["ms"], row["call_ms"] = time_ms(torch, lambda: hs.hec_probe(
            state.tags, state.values, vids, alive))
        # about 65 torch ops per call (R lookups, the packing, a stack):
        # 3 calls fit in the launch queue
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: hs.hec_probe_ref(state.tags, state.values, vids,
                                            alive), iters=3)
    return row


def phase8_main_path(torch, np, args, preset, phase):
    """(b): the sharded launcher's flow at its defaults on phase 3's graph
    cut into 4 shards; launch counts exact.  Returns the launcher's result,
    the launches, the rounds recorded for (c) and the last inputs of J and
    of the shard lookups."""
    import repro_torch.comm.engine as engine
    from repro_torch import obs
    from repro_torch.launch import gnn_serve_dist
    from repro_torch.serve.gnn.distributed import DistGNNServeScheduler
    torch.cuda.reset_peak_memory_stats()
    largs = gnn_serve_dist.parse_args([
        "--preset", preset, "--vertices", str(args.vertices), "--queries",
        str(args.queries), "--device", "cuda"])
    rec, unrec = record_rounds(DistGNNServeScheduler)
    probes, unprobe = record_last(engine, "hec_probe",
                                  lambda tags, *a: tags.data_ptr())
    lookups, unlook = record_last(
        DistGNNServeScheduler, "_lookup",
        lambda self, state, vids: (state.tags.data_ptr(), vids.shape[1]))
    zero_launches()
    try:
        res = gnn_serve_dist.run(largs)
        launches = read_launches()
    finally:
        unrec(), unprobe(), unlook()
    reg = obs.get().registry               # the launcher's own runtime
    spans = {ph: reg.value("phase_seconds", phase=ph) * 1e3
             for ph in ("serve_round", "serve_sample", "serve_step",
                        "serve_sync_host")}
    print(f"{phase}: launches on the sharded serving path: {launches}")
    srv, cfg, ps = res["srv"], res["cfg"], res["ps"]
    R, L = srv.num_ranks, cfg.num_layers
    passes = [res[f"{p}_metrics"] for p in ("warmup", "serve", "repeat")]
    rounds = sum(m["steps_run"] for m in passes)
    fast = sum(m["fast_path_rounds"] for m in passes)
    chunks = sum(-(-p.num_solid // OFFLINE_CHUNK) for p in ps.parts)
    fwd = "serve_fused_layer" if cfg.model == "graphsage" else "gat_edge_fwd"
    want = {n: 0 for n in launches}
    # per round: the forward R x L, the shard lookups R x (L - 1) and the
    # seeds' R, one J per hidden layer; R lookups per fast-path batch; the
    # pre-warm's offline pass once per layer and chunk of each shard
    want.update({fwd: R * L * rounds + L * chunks,
                 "hec_lookup": R * L * rounds + R * fast,
                 "hec_probe": (L - 1) * rounds})
    for n in launches:
        check(launches[n] == want[n], f"{phase}: {n} launched "
              f"{launches[n]} times, expected {want[n]} ({rounds} rounds, "
              f"{fast} fast-path batches, {chunks} offline chunks per "
              f"layer)")
    for p in ("serve", "repeat"):
        check(all(r.done and np.isfinite(r.result).all() for r in res[p]),
              f"{phase}: a {p} answer is missing or non-finite")
    m = res["serve_metrics"]
    check(m["steps_run"] > 0 and m["halo_requested"] > 0,
          f"{phase}: the serve pass fetched no halo row")
    check(len(rec) == REPLAY_ROUNDS,
          f"{phase}: the flow ran {len(rec)} rounds, fewer than the "
          f"{REPLAY_ROUNDS} that (c) replays")
    for p in ("serve", "repeat"):
        mp = res[f"{p}_metrics"]
        print(f"{phase}: {p} pass {res[f'{p}_qps']:.1f} q/s (indicative), "
              f"{mp['steps_run']} rounds of {srv.scfg.round_batch} fused "
              f"segments, {mp['fast_path_hits']} + "
              f"{mp.get('hot_fast_path_hits', 0)} fast-path answers (output "
              f"cache + hot tier); halo rows seen {mp['halo_seen']}, local "
              f"{mp['halo_local_hits']}, requested {mp['halo_requested']}, "
              f"fetched {mp['halo_fetched']}; hot hits {mp['hot_hits']}; "
              f"dedup merges {mp['dedup_merged']}; latency p50 "
              f"{mp['latency_p50_ms']:.1f} ms p99 {mp['latency_p99_ms']:.1f}"
              f" ms")
    print(f"{phase}: host clock per round, mean over the {rounds} rounds "
          f"(indicative): " + ", ".join(
              f"{ph.removeprefix('serve_')} {ms / rounds:.1f} ms"
              for ph, ms in spans.items()))
    reg_rounds = res["serve_metrics"]["steps_run"]
    print(f"{phase}: {R} shards of {[p.num_solid for p in ps.parts]} "
          f"vertices, edge cut {ps.edge_cut_frac:.2%}, hot set "
          f"{srv.hot.num_slots if srv.hot is not None else 0}; "
          f"{rounds} rounds in all ({reg_rounds} in the serve pass), "
          f"{fast} fast-path batches, pre-warm {res['prewarmed']} vertices "
          f"per layer")
    peak_line(torch, phase)
    return res, launches, rec, probes, lookups


def phase8_replay(torch, np, res, rec, phase):
    """(c): the first rounds of (b), each from the state before it, served
    again on the CPU through the plain versions: answers within
    tolerance, every shard's cache tags and the hot-tier ages after it
    equal."""
    from repro_torch.models.gnn import build_model
    from repro_torch.serve.gnn.distributed import DistGNNServeScheduler
    from repro_torch.serve.gnn.scheduler import GNNRequest
    srv, cfg = res["srv"], res["cfg"]
    t0 = time.perf_counter()
    cpu = DistGNNServeScheduler(cfg, build_model(cfg, seed=0, device="cpu"),
                                res["ps"], srv.scfg, device="cpu")
    worst, answers, fetched = 0.0, 0, 0
    for i, rnd in enumerate(rec):
        b = rnd.pop("before")
        for st, tags, (age, values) in zip(cpu.cache.states, b["tags"],
                                           b["cache"]):
            st.tags.copy_(tags.cpu()), st.age.copy_(age.cpu())
            st.values.copy_(values.cpu())
        for st, age, values in zip(cpu.hot.states if cpu.hot else [],
                                   b["ages"], b["hot"]):
            st.age.copy_(age.cpu()), st.values.copy_(values.cpu())
        cpu.cache.resident = [r.copy() for r in b["resident"]]
        if cpu.hot is not None:
            cpu.hot.valid = [v.copy() for v in b["valid"]]
        cpu._mb_counter = b["mb_counter"]
        del b
        fresh = [[(local, [GNNRequest(rid=q.rid, vid=q.vid) for q in reqs])
                  for local, reqs in g] for g in rnd["groups"]]
        cpu._run_round(fresh)
        fetched += int(np.sum(cpu.round_log[-1]["halo_fetched"]))
        for g, f in zip(rnd["groups"], fresh):
            for (_, reqs), (_, freqs) in zip(g, f):
                for q, fq in zip(reqs, freqs):
                    want = fq.result
                    err = np.abs(q.result - want)
                    check(bool(np.all(err <= TOL * np.maximum(
                        1.0, np.abs(want)))), f"{phase} (c): round {i}: vid "
                        f"{q.vid}: card and CPU answers differ by "
                        f"{err.max():.3e}")
                    worst = max(worst, float(err.max()))
                    answers += 1
        a = rnd["after"]
        for k, (st, tags) in enumerate(zip(cpu.cache.states, a["tags"])):
            check(bool(torch.equal(st.tags, tags.cpu())),
                  f"{phase} (c): round {i}: layer {k + 1} cache tags differ, "
                  f"card vs CPU")
        for k, (st, age) in enumerate(zip(cpu.hot.states if cpu.hot else [],
                                          a["ages"])):
            check(bool(torch.equal(st.age, age.cpu())),
                  f"{phase} (c): round {i}: layer {k + 1} hot-tier ages "
                  f"differ, card vs CPU")
    print(f"{phase} (c): the first {len(rec)} rounds of (b) ({answers} "
          f"answers, {fetched} halo rows fetched), each from the state "
          f"before it, again on the CPU through the plain versions: max "
          f"|card - CPU| {worst:.3e}; every shard's cache tags and the "
          f"hot-tier ages after each equal "
          f"({time.perf_counter() - t0:.1f} s)")
    return worst


def phase8_kernels(torch, np, res, probes, lookups, phase, card):
    """(a): J at the path's shapes (the last request buffer of each hidden
    layer, on the run's own caches) and B at the shard lookups' shapes,
    bit for bit, timed with their bounds; the forward kernel (A or G) at
    rank 0's layer shapes of one round.  Returns (J rows, B rows, forward
    rows)."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels import ref
    from repro_torch.kernels import serve_fused as sf
    srv, cfg = res["srv"], res["cfg"]
    L = cfg.num_layers
    rows_j, rows_b, rows_f = [], [], []
    for k, st in enumerate(srv.cache.states[:L - 1]):
        args = probes.get(st.tags.data_ptr())
        check(args is not None, f"{phase}: J never probed layer {k + 1}")
        row = probe_case(torch, hs, f"{phase} J layer {k + 1}", st, args[2])
        rows_j.append(row)
        print(f"{phase} (a): hec_probe (J) layer {k + 1} {row['shape']} "
              f"({row['hits']} hits): bit-exact; device ms kernel "
              f"{row['ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}) [{card}]")
    for (ptr, width), (_, state, vids) in sorted(lookups.items(),
                                                 key=lambda kv: kv[0][1]):
        live = [k for k, st in enumerate(srv.cache.states)
                if st.tags.data_ptr() == ptr]
        if not live or width == srv.scfg.num_slots:
            continue                    # the warm-up's caches; fast path
        row = hec_case(torch, hs, f"{phase} shard lookup l{live[0] + 1}",
                       state.rank(0), vids[0].to(torch.int32).contiguous())
        rows_b.append(row)
        print(f"{phase} (a): hec_lookup (B) rank 0 l{live[0] + 1} "
              f"{row['shape']} ({row['hits']} hits): bit-exact; device ms "
              f"kernel {row['ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}) [{card}]")
    # the forward's shapes: rank 0's part of one round of random queries
    ps = res["ps"]
    rng = np.random.default_rng(8)
    cap = srv.scfg.num_slots * srv.scfg.round_batch
    groups = [[(int(v), None) for v in rng.choice(p.num_solid, cap, False)]
              for p in ps.parts]
    mb = srv._sample(groups)
    data = srv.data
    nodes0 = mb["layer_nodes"][0][0].long()
    valid = mb["node_mask"][0][0]
    S0 = int(data["num_solid"][0])
    h = torch.where((nodes0 >= S0)[:, None],
                    data["halo_features"][0][(nodes0 - S0).clamp(
                        0, data["halo_features"].shape[1] - 1)],
                    data["features"][0][nodes0.clamp(
                        0, data["features"].shape[1] - 1)]) * valid[:, None]
    for k, layer in enumerate(srv.model.layers):
        nbr = mb["nbr_idx"][k][0]
        if cfg.model == "graphsage":
            h, row = serve_layer_case(torch, sf, ref, f"{phase} A layer {k}",
                                      h, nbr, valid,
                                      (layer.wn, layer.ws, layer.b),
                                      relu=k < L - 1)
            name = "serve_fused_layer (A)"
            row["offline"] = False
        else:
            z, e_u, e_v = layer.project(h)
            h, row = gat_case(torch, ge, ref, f"{phase} G layer {k}", z, e_u,
                              e_v, nbr, valid)
            name = "gat_edge_fwd (G)"
            row["path"] = "online"
            del z, e_u, e_v
        rows_f.append(row)
        print_row(name, row, phase + " (a)")
        valid = mb["node_mask"][k + 1][0]
    return rows_j, rows_b, rows_f


def phase8_ragged(torch, np, card):
    """(a): J at a ragged shape: n off 32, d off 4 (172), negative vids and
    a dead responder, on half-full caches with full sets."""
    from repro_torch.cache import hec
    from repro_torch.kernels import hec_search as hs
    from repro_torch.kernels.ref import set_index
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    parts = [fill_cache(torch, hec, set_index, 4096, 8, 172, dev, rng, np)
             for _ in range(DIST_RANKS)]
    state = hec.HECState(*(torch.stack([getattr(p[0], f) for p in parts])
                           for f in ("tags", "age", "values")))
    vids = np.concatenate([np.stack([rng.choice(p[1], 40) for p in parts]),
                           rng.integers(-3, 2_000_000, (DIST_RANKS, 268))], 1)
    vids[:, 40:43] = [-1, -2, -2 ** 31]
    vids = torch.as_tensor(vids.reshape(DIST_RANKS, 4, 77), dtype=torch.int32,
                           device=dev)
    alive = torch.tensor([True, True, False, True], device=dev)
    row = probe_case(torch, hs, "phase 8 J ragged", state, vids, alive)
    print(f"phase 8 (a): hec_probe (J) ragged {row['shape']} ({row['hits']} "
          f"ok rows, {row['negative_vids']} negative vids): bit-exact; "
          f"device ms kernel {row['ms']:.4f}, bound {row['bound_ms']:.5f} "
          f"[{card}]")
    return row


def phase8_exact(torch, np):
    """(c): sharded serving on phase 2's low-degree graph (every degree at
    most the fanout, so sampling is exact), 4 shards, hidden layers warmed
    from the sharded offline pass: every answer within tolerance of
    offline embeddings computed by the plain versions on the whole graph,
    for both models."""
    from repro_torch.configs.gnn import GAT_PAPERS100M, GRAPHSAGE_PAPERS100M
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import ref
    from repro_torch.models.gnn import build_model
    from repro_torch.serve.gnn import ServeCacheConfig, full_neighbor_matrix
    from repro_torch.serve.gnn.distributed import (DistGNNServeScheduler,
                                                   DistServeConfig,
                                                   layerwise_embeddings_dist)
    dev = torch.device("cuda")
    g = synthetic_graph(num_vertices=3000, avg_degree=2, num_classes=172,
                        feat_dim=128, seed=3)
    part = partition_graph(g, 1, seed=0).parts[0]
    ps = partition_graph(g, DIST_RANKS, seed=0)
    max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
    S = part.num_solid
    nbr = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                          device=dev)
    ones = torch.ones(S, dtype=torch.bool, device=dev)
    vids = np.concatenate([np.arange(0, S, 5),
                           np.random.default_rng(2).integers(0, S, 200)])
    for base in (GRAPHSAGE_PAPERS100M, GAT_PAPERS100M):
        cfg = dataclasses.replace(base, fanouts=(max_deg,) * 3)
        model = build_model(cfg, seed=1, device=dev)
        h = torch.as_tensor(part.features, device=dev)
        for k, layer in enumerate(model.layers):
            if cfg.model == "graphsage":
                h = ref.serve_layer_ref(h, nbr, ones, layer.wn, layer.ws,
                                        layer.b, relu=k < cfg.num_layers - 1)
            else:
                h = ref.gat_edge_ref(*layer.project(h), nbr, ones)
        want = h.cpu().numpy()
        srv = DistGNNServeScheduler(
            cfg, model, ps, DistServeConfig(
                num_slots=16, halo_slots=256, hot_size=64, dedup=True,
                round_batch=2, cache=ServeCacheConfig(cache_size=65536,
                                                      ways=8)), device=dev)
        embs = layerwise_embeddings_dist(cfg, model, ps, chunk_size=512)
        srv.cache.warm(embs, np.arange(S), layers=range(cfg.num_layers - 1))
        srv.hot.warm(embs)
        out = srv.serve(vids)
        err = np.abs(out - want[vids])
        check(bool(np.isfinite(out).all()) and bool(np.all(
            err <= TOL * np.maximum(1.0, np.abs(want[vids])))),
            f"phase 8 (c): {cfg.model}: sharded answers differ from the "
            f"plain offline embeddings by {err.max():.3e}")
        m = srv.metrics()
        check(m["steps_run"] > 0 and m["halo_fetched"] > 0,
              f"phase 8 (c): {cfg.model}: no compute round fetched a halo")
        print(f"phase 8 (c): {cfg.model} on a {S}-vertex graph in "
              f"{DIST_RANKS} shards (fanouts {max_deg}x3, exact sampling), "
              f"hidden layers warmed: {len(vids)} answers within tolerance "
              f"of the plain offline embeddings (max |d| {err.max():.3e}); "
              f"{m['steps_run']} rounds, {m['halo_fetched']} halo rows "
              f"fetched, {m['hot_hits']} from the hot tier")


# ---------------------------------------------------------------------------
# phase 9: the trainer's other modes (sync, drop, aep with the hot tier)
# ---------------------------------------------------------------------------
# phase 9's tier: 1,024 slots, refreshed at 512 rows a rank and step, so
# that budget x life span (2) covers every slot whatever rank owns it (at
# the reference dry-run's 256 the busiest rank's hot vertices outgrow it)
HOT_SIZE, HOT_BUDGET = 1024, 512
CHECK_VERTICES = 20_000     # phase 9 (c)'s graph
CHECK_BATCH = 64            # and batch: 6 CPU runs of two steps (at 64
#                             a GAT step's layer 0 has 67,584 rows)
CHECK_HEC_SIZE = 65_536     # and HEC entries per layer and rank
# phase 9 (c)'s free card run: loss and grad norm relative to the CPU's.
# From the CPU's state a card step sits within ~1e-6; run free, GraphSAGE
# with the tier read ~1e-4 at step 1 and GAT drop ~7e-4 (PERF.md)
FREE_RUN_TOL = 1e-3
# the parameter leaves per layer, in ``parameter_list``'s order
LEAF_NAMES = {"graphsage": ("b", "wn", "ws"),
              "gat": ("a_u", "a_v", "b", "w")}


class ReuseGraphs:
    """Between ``start`` and ``stop``, ``repro_torch.graph``'s
    ``synthetic_graph`` and ``partition_graph`` hand back what an earlier
    call with the same arguments built (both are pure functions of them),
    so the launcher runs of phases 4, 6 and 9 train on one graph and one
    partition, built once."""

    def __init__(self):
        import repro_torch.graph as graph
        self.graph, self.built = graph, {}

    def start(self):
        g = self.graph
        self.orig = g.synthetic_graph, g.partition_graph
        make, cut = self.orig

        def synthetic_graph(**kw):
            key = ("graph",) + tuple(sorted(kw.items()))
            if key not in self.built:
                self.built[key] = make(**kw)
            return self.built[key]

        def partition_graph(graph, num_parts, seed=0):
            key = ("parts", id(graph), num_parts, seed)
            if key not in self.built:
                self.built[key] = cut(graph, num_parts, seed=seed)
            return self.built[key]
        g.synthetic_graph, g.partition_graph = synthetic_graph, \
            partition_graph
        return self

    def stop(self):
        self.graph.synthetic_graph, self.graph.partition_graph = self.orig
        self.built.clear()


def mode_summary(phase, res, card):
    """s/epoch, the step and sample spans, test accuracy and hit rates of
    a training run (b), beside the card's name and power limit."""
    h, L = res["history"][0], res["cfg"].num_layers
    steps = len(res["trainer"].step_log) // len(res["history"])
    rates = " ".join(
        f"l{l} {h[f'{k}_hit_rate_l{l}']:.4f}" for k in ("hec", "hot")
        for l in range(L) if f"{k}_hit_rate_l{l}" in h)
    print(f"{phase}: {h['t_wall']:.2f} s/epoch (host clock, indicative), "
          f"per step ms step {1e3 * h['t_step'] / steps:.1f}, sample "
          f"{1e3 * h['t_sample'] / steps:.1f}; test_acc "
          f"{res['test_acc']:.4f}; hit rates (HEC, hot) {rates or 'none'} "
          f"[{card}]")


def phase9_main_path(torch, np, ps, card):
    """(b): ``launch/train.py gnn --mode sync`` and ``--mode drop`` on
    phase 4's graph and settings (per step C, D, E at every layer of every
    rank and F at layers >= 1, per eval batch C and E; no HEC probe), then
    one ``aep`` epoch with the hot tier through ``DistTrainer.
    train_epochs`` (``HOT_SIZE``, ``HOT_BUDGET``; phase 4's launches) and
    ``evaluate``.  Returns each run's launches."""
    import warnings

    from repro_torch import obs
    from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data
    R, L = 4, 3
    per_step = {"update_fused_fwd": L * R, "update_fused_bwd": L * R,
                "sage_agg_fwd": L * R, "sage_agg_bwd": (L - 1) * R,
                "slot_index": (L - 1) * R}
    per_eval = {"update_fused_fwd": L * R, "sage_agg_fwd": L * R}
    out = {}
    for mode in ("sync", "drop"):
        torch.cuda.reset_peak_memory_stats()
        phase = f"phase 9 (b) {mode}"
        res, out[mode] = train_main_path(
            torch, np, phase, TRAIN_ARGS + ["--vertices", str(TRAIN_VERTICES),
                                            "--mode", mode],
            per_step, per_eval)
        check(all(m["hec_occ_l0"] == 0 for m in res["trainer"].step_log),
              f"{phase}: a HEC was written outside aep")
        mode_summary(phase, res, card)
        peak_line(torch, phase)
        del res
        torch.cuda.empty_cache()

    phase = "phase 9 (b) aep + hot tier"
    cfg4 = launcher_config(TRAIN_ARGS)
    cfg = dataclasses.replace(cfg4, hec=dataclasses.replace(
        cfg4.hec, hot_size=HOT_SIZE, hot_budget=HOT_BUDGET))
    torch.cuda.reset_peak_memory_stats()
    obs.configure()
    data = build_dist_data(ps, cfg, "cuda")
    tr = DistTrainer(cfg=cfg, num_ranks=R, device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = tr.init_state(seed=0, dist_data=data)
    owned = int(data["hot_mine"].sum(1).max())
    check(not any("undersized" in str(w.message) for w in caught),
          f"{phase}: the hot budget is undersized: the busiest rank owns "
          f"{owned} of {HOT_SIZE} hot vertices")
    zero_launches()
    state, hist = tr.train_epochs(ps, data, state, 1, log_every=1)
    acc = tr.evaluate(ps, data, state)
    out["hot"] = read_launches()
    res = {"trainer": tr, "cfg": cfg, "history": hist, "test_acc": acc}
    per_step4 = dict(per_step, hec_lookup=L * R)
    per_eval4 = dict(per_eval, hec_lookup=L * R)
    check_training(np, phase, res, out["hot"], per_step4, per_eval4)
    hot_hits = [sum(m[f"hot_hits_l{l}"] for m in tr.step_log)
                for l in range(L)]
    check(any(h > 0 for h in hot_hits), f"{phase}: no hot-tier hit")
    print(f"{phase}: tier of {len(state['hot'][0].age[0])} slots, budget "
          f"{HOT_BUDGET} a rank and step (busiest owner holds {owned}, "
          f"budget x life span {HOT_BUDGET * cfg.hec.life_span}); hot hits "
          f"per layer {hot_hits}; hot rows pushed per step "
          f"{[int(m['hot_push_rows']) for m in tr.step_log]}")
    mode_summary(phase, res, card)
    peak_line(torch, phase)
    del res, state, data, tr
    torch.cuda.empty_cache()
    return out


def launcher_config(argv, **over):
    """The config ``launch/train.py`` builds from ``argv``, with
    ``over`` replaced."""
    from repro_torch.launch import train
    return dataclasses.replace(train.gnn_config(train.parse_args(argv)),
                               **over)


def state_to(torch, state, device):
    """A copy of a training state on ``device``."""
    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, copy=True)
        if isinstance(x, torch.nn.Module):
            return copy.deepcopy(x).to(device)
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v) for v in x]
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: to(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x
    return to(state)


def phase9_check(torch, np):
    """(c): the first two steps of ``sync``, ``drop`` and ``aep`` with the
    hot tier, both models at full width on a ``CHECK_VERTICES`` graph at
    batch ``CHECK_BATCH``, on the card and on the CPU (GAT's ReLU
    branches pinned: every run takes the float64 witness's at step 0,
    the card's runs the CPU's at step 1).  The CPU runs free; one card
    run takes each step from the CPU's state before it.  Per step of it:
    loss and gradient norm within 1e-4 relative, Adam's first moment
    within 1e-4 relative (at step 0 GAT's layer-0 attention vectors
    against a float64 witness instead, as phase 6 (c)), and the HEC
    tags, queued and hot tags, slot ages, sync ``got`` masks and fetched
    rows equal.  A second card run goes free, its loss and gradient norm
    within ``FREE_RUN_TOL`` of the CPU's at every step: Adam turns the
    float noise of step 0's near-zero gradients into parameter gaps, and
    with the tier kernel E's rounding grows at step 1 (PERF.md), but a
    kernel fault that builds up over free steps still fails here.  The
    three leaves where the free run's first moment sits furthest from
    the CPU's are printed."""
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    R = 4
    g = synthetic_graph(num_vertices=CHECK_VERTICES, avg_degree=10,
                        num_classes=172, feat_dim=128, seed=0)
    ps = partition_graph(g, R, seed=0)
    base = {"graphsage": TRAIN_ARGS, "gat": TRAIN_ARGS + ["--model", "gat",
                                                         "--lr", "0.001"]}

    def run(cfg, mode, d, hosts, starts=None, pins=None):
        """Every step from ``starts[i]`` (a state on the CPU) when given,
        else free, and under ``pins(i)`` (GAT's ReLU branches) when given;
        per step the metrics, Adam's first moment, the integer and
        data-movement tensors and the recorded branches."""
        tr = DistTrainer(cfg, R, mode=mode, device=d)
        fetched, fetch = [], tr.engine.sync_fetch
        tr.engine.sync_fetch = lambda *a: fetched.append(fetch(*a)) \
            or fetched[-1]
        data = build_dist_data(ps, cfg, d)
        st = tr.init_state(seed=0, dist_data=data)
        out = {"logs": [], "mu": [], "ints": [], "states": [], "masks": [],
               "fetched": 0, "hot": 0, "flips": 0}
        for i, host in enumerate(hosts):
            if starts is not None:
                st = state_to(torch, starts[i], d)
            elif d == "cpu":
                out["states"].append(state_to(torch, st, "cpu"))
            fetched.clear()
            pin = pins(i) if pins is not None else None
            with pin if pin is not None else contextlib.nullcontext():
                out["logs"].append(tr.train_step(
                    st, data, minibatch_to_device(host, d), i))
            if pin is not None:
                out["flips"] += pin.flips
                out["masks"].append(pin.masks)
            out["mu"].append([m.cpu().clone() for m in st["opt"].mu])
            if i == 0:                 # entries whose gradient is noise
                out["quiet"] = sum(int((v.sqrt() < 1e-6).sum())
                                   for v in st["opt"].nu)
            ints = [s.tags for layer in st["hec"] for s in layer]
            ints += [t.age for t in st["hot"]]
            ints += [q[k] for q in st["inflight"]
                     for k in ("tags", "hot_tags") if k in q]
            ints += [x for h0, got in fetched for x in (h0, got)]
            out["ints"].append([x.to("cpu", copy=True) for x in ints])
            out["fetched"] += sum(int(got.sum()) for _, got in fetched)
        out["hot"] = sum(int((t.age == 0).sum()) for t in st["hot"])
        return out

    def mu_gap(a, b, i, skip=()):
        return max(rel_norm(x, y) for k, (x, y) in
                   enumerate(zip(a["mu"][i], b["mu"][i])) if k not in skip)

    witnesses = {}
    for model in ("graphsage", "gat"):
        for mode in ("sync", "drop", "aep"):
            hot = dict(hot_size=HOT_SIZE, hot_budget=HOT_BUDGET) \
                if mode == "aep" else {}
            cfg = launcher_config(base[model], batch_size=CHECK_BATCH)
            cfg = dataclasses.replace(cfg, hec=dataclasses.replace(
                cfg.hec, cache_size=CHECK_HEC_SIZE, **hot))
            plan = SamplingPlan(ps, cfg, 0)
            sched = plan.epoch_schedule(0)
            hosts = [plan.sample_host(0, i, sched[i])
                     for i in range(CHECK_STEPS)]
            t0 = time.perf_counter()
            noisy = GAT_CPU_NOISY_LEAVES if model == "gat" else ()
            pins = {name: None for name in ("cpu", "free", "card")}
            if noisy:
                # at step 0 the HEC and the tier are empty: aep's first
                # gradient is drop's.  The witness records its branches;
                # at step 0 every run takes them, at step 1 the card's
                # runs take the CPU's
                kind = "sync" if mode == "sync" else "drop"
                if kind not in witnesses:
                    with ExactReluBranches(torch, record=True) as wpin:
                        witnesses[kind] = (float64_first_moment(
                            torch, ps, cfg, R, hosts[0], kind), wpin.masks)
                w_masks = witnesses[kind][1]
                pins["cpu"] = lambda i: ExactReluBranches(
                    torch, replay=w_masks if i == 0 else None, record=True)
                pins["free"] = lambda i: ExactReluBranches(torch)
                pins["card"] = lambda i: ExactReluBranches(
                    torch, replay=w_masks if i == 0
                    else runs["cpu"]["masks"][i])
            runs = {}
            for name, d, from_cpu in (("cpu", "cpu", False),
                                      ("free", "cuda", False),
                                      ("card", "cuda", True)):
                starts = runs["cpu"]["states"] if from_cpu else None
                runs[name] = run(cfg, mode, d, hosts, starts, pins[name])
            c, p, fr = runs["card"], runs["cpu"], runs["free"]
            tag = f"phase 9 (c) {model} {mode}"
            held = free = 0.0
            for i in range(CHECK_STEPS):
                for key in ("loss", "grad_norm"):
                    a, b = c["logs"][i][key], p["logs"][i][key]
                    check(abs(a - b) <= 1e-4 * abs(b), f"{tag}: step {i} "
                          f"{key}: card {a} vs CPU {b}")
                    a = fr["logs"][i][key]
                    check(abs(a - b) <= FREE_RUN_TOL * abs(b),
                          f"{tag}: step {i} {key}: the card's free run {a} "
                          f"vs CPU {b}")
                    free = max(free, abs(a - b) / abs(b))
                check(set(c["logs"][i]) == set(p["logs"][i]),
                      f"{tag}: step {i}: the metric keys differ")
                check(all(torch.equal(a, b) for a, b in zip(
                    c["ints"][i], p["ints"][i])),
                    f"{tag}: step {i}: HEC tags, queued or hot tags, "
                    f"slot ages, got masks or fetched rows differ "
                    f"between the card and the CPU")
                gap = mu_gap(c, p, i, noisy if i == 0 else ())
                check(gap <= 1e-4, f"{tag}: step {i}: gradient (Adam mu) "
                      f"differs by {gap:.3e} relative")
                held = max(held, gap)
            witness = ""
            if noisy:
                vs = [rel_norm(a.double(), b)
                      for a, b in zip(c["mu"][0], witnesses[kind][0])]
                check(max(vs) <= 1e-4, f"{tag}: the card's gradient is "
                      f"{max(vs):.3e} from the float64 witness")
                witness = f", card vs float64 witness {max(vs):.2e}"
            if mode == "sync":
                check(c["fetched"] > 0, f"{tag}: no halo was fetched")
            if mode == "aep":
                check(c["hot"] > 0, f"{tag}: no hot slot was refreshed")
            names = LEAF_NAMES[model]
            leaves = sorted(
                ((rel_norm(x, y), f"l{k // len(names)}."
                  f"{names[k % len(names)]}") for k, (x, y) in
                 enumerate(zip(fr["mu"][-1], p["mu"][-1]))), reverse=True)
            print(f"{tag}: {CHECK_STEPS} steps at batch {cfg.batch_size} on "
                  f"{CHECK_VERTICES} vertices, card (each step from the "
                  f"CPU's state) vs CPU: losses "
                  f"{[m['loss'] for m in c['logs']]} vs "
                  f"{[m['loss'] for m in p['logs']]}; gradient rel. diff "
                  f"{held:.2e}{witness}; {len(c['ints'][-1])} integer and "
                  f"data-movement tensors equal ({c['fetched']} fetched "
                  f"rows, {c['hot']} fresh hot slots); the card's free run: "
                  f"loss and grad norm within {free:.2e} of the CPU's "
                  f"({p['quiet']} of {sum(m.numel() for m in p['mu'][0])} "
                  f"entries with sqrt(nu) < 1e-6 after step 0), Adam mu "
                  f"furthest at leaves "
                  + ", ".join(f"{n} {v:.2e}" for v, n in leaves[:3])
                  + (f"; ReLU branches pinned (the witness's at step 0, "
                     f"then the CPU's), {c['flips']} float32 signs on the "
                     f"card differ from them" if noisy else "")
                  + f" ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 10: the minibatch pipeline, the push on its side stream, the trace
# ---------------------------------------------------------------------------
P10_DIR = os.path.join(ROOT, "build", "phase10")
P10_WORKERS = 4             # (e): prefetch workers (and depth)
# kernels only the backward launches (kernels D and F)
BWD_KERNELS = ("update_bwd_kernel", "sage_agg_bwd_kernel")


def is_bwd(event) -> bool:
    """A device event of kernel D or F (their names carry the template
    arguments and parameters)."""
    return any(k in event["name"] for k in BWD_KERNELS)


class StepRecorder:
    """Between ``start`` and ``stop`` every ``DistTrainer.train_step`` also
    records its metrics and, per HEC, a digest of its tags and of its ages
    (``bit_digest``), so two runs are compared step for step without a
    copy of 12 GB of HECs.  The digests stay on the card until ``stop``: a
    host read per step would wait inside the ``step`` span."""

    def __init__(self, torch):
        from repro_torch.train.gnn_trainer import DistTrainer
        self.torch, self.cls = torch, DistTrainer
        self.steps = []

    def start(self):
        orig = self.orig = self.cls.train_step
        torch = self.torch

        def train_step(tr, state, data, mb, seed):
            m = orig(tr, state, data, mb, seed)
            hecs = [s for layer in state["hec"] for s in layer]
            self.steps.append({"m": m,
                               "tags": [bit_digest(torch, s.tags)
                                        for s in hecs],
                               "ages": [bit_digest(torch, s.age)
                                        for s in hecs]})
            return m
        self.cls.train_step = train_step
        return self

    def stop(self):
        self.cls.train_step = self.orig
        for s in self.steps:
            for k in ("tags", "ages"):
                s[k] = [int(x) for x in s[k]]


def trace_streams(phase, trace):
    """The device events of a launcher trace and the roles of its streams:
    the main stream (the one of kernels D and F), the push's side stream
    (another stream with kernels in training), and the copy streams."""
    from repro_torch import obs
    dev = obs.device_events(trace)
    spans = [e for e in trace["traceEvents"]
             if e["ph"] == "X" and e.get("cat") == "phase"]
    steps = [e for e in spans if e["name"] == "step"]
    t0 = min(e["ts"] for e in spans if e["name"] == "stage")
    window = (t0, max(e["ts"] + e["dur"] for e in steps))
    train = [e for e in dev if window[0] <= e["ts"] <= window[1]]
    main = {e["stream"] for e in train if is_bwd(e)}
    check(len(main) == 1, f"{phase}: kernels D and F ran on streams "
          f"{sorted(main)}, not on one main stream")
    main = main.pop()
    push = {e["stream"] for e in train
            if e["stream"] != main and e["cat"] == "device_kernel"}
    copy = {e["stream"] for e in train if e["stream"] not in push | {main}
            and e["cat"] == "device_memcpy"
            and e["name"].startswith("Memcpy HtoD")}
    return {"events": train, "main": main, "push": push, "copy": copy,
            "streams": sorted({e["stream"] for e in dev})}


def overlap_share(obs, events, mine, theirs, cat):
    """``(overlapped µs, own µs)``: the device time of the ``cat`` events on
    streams ``mine`` that overlaps the main stream's kernels ``theirs``."""
    ev = [e for e in events if (e["stream"] in mine and e["cat"] == cat)
          or (e["stream"] == theirs and e["cat"] == "device_kernel")]
    own = sum(obs.busy_us([e for e in ev if e["stream"] == s])
              for s in mine)
    return sum(obs.stream_overlap_us(ev, s, [theirs]) for s in mine), own


def phase10_run(torch, np, key, name, card, pipeline=None, overlap=True):
    """One epoch and ``evaluate`` through ``launch/train.py gnn`` at phase
    4's settings with ``--trace-out``, ``--metrics-out`` and ``--prom-out``
    (``pipeline``: a ``PipelineConfig``; ``overlap``: the push's
    schedule): phase 4's launches exact, (d)'s artifacts checked, the
    breakdown printed.  Returns what (a), (b) and (e) compare."""
    from repro_torch import obs
    from repro_torch.launch import train
    phase = f"phase 10 {name}"
    d = os.path.join(P10_DIR, key)
    os.makedirs(d, exist_ok=True)
    files = {k: os.path.join(d, f) for k, f in (
        ("trace", "trace.json"), ("metrics", "metrics.jsonl"),
        ("prom", "metrics.prom"))}
    rec = StepRecorder(torch).start()
    zero_launches()
    try:
        res = train.run_gnn(train.parse_args(
            TRAIN_ARGS + ["--vertices", str(TRAIN_VERTICES), "--trace-out",
                          files["trace"], "--metrics-out", files["metrics"],
                          "--prom-out", files["prom"]]),
            pipeline=pipeline, overlap=overlap)
        launches = read_launches()
    finally:
        rec.stop()
    check_training(np, phase, res, launches, *phase4_counts())
    tr, h = res["trainer"], res["history"][0]
    check((tr.push_stream is not None) == overlap,
          f"{phase}: the push stream is {tr.push_stream}, overlap "
          f"{overlap}")
    # (d) the artifacts
    with open(files["trace"]) as f:
        trace = json.load(f)
    n_spans = obs.validate_chrome_trace(trace)
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    tids = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X" and e.get("cat") == "phase":
            tids.setdefault(e["name"], set()).add(names[e["tid"]])
    check(all(t.startswith("minibatch-prefetch") for p in ("sample",
                                                          "host_prep")
              for t in tids.get(p, ["none"]))
          and tids.get("stage") == tids.get("step") == {"MainThread"},
          f"{phase}: span threads {tids}")
    roles = trace_streams(phase, trace)
    check(len(roles["streams"]) >= 2, f"{phase}: device tracks for "
          f"{roles['streams']} streams")
    with open(files["metrics"]) as f:
        rows = [json.loads(line) for line in f]
    with open(files["prom"]) as f:
        prom = f.read()
    missing = [p for p in ("sample", "host_prep", "stage", "step")
               if f'phase_seconds{{phase="{p}"}}' not in prom]
    check(rows and not missing, f"{phase}: {len(rows)} JSONL lines, "
          f"Prometheus file without phase_seconds of {missing}")
    # the streams' shares
    steps = len(tr.step_log)
    c_ov, c_own = overlap_share(obs, roles["events"], roles["copy"],
                                roles["main"], "device_memcpy")
    out = {"launches": launches, "steps": rec.steps, "history": h,
           "params": [p.detach().clone()
                      for p in res["state"]["model"].parameter_list()],
           "copy_share": c_ov / c_own if c_own else 0.0,
           "stage_ms": 1e3 * h["t_stage"] / steps,
           "step_ms": 1e3 * h["t_step"] / steps,
           "sample_ms": 1e3 * h["t_sample"] / steps,
           "busy": res["device_trace"]["step"]["busy_share"]}
    main_k = [e for e in roles["events"] if e["stream"] == roles["main"]
              and e["cat"] == "device_kernel"]
    main_us = obs.busy_us(main_k)
    model = obs.StepModel()
    if overlap:
        check(len(roles["push"]) == 1, f"{phase}: push streams "
              f"{sorted(roles['push'])}")
        p_ov, p_own = overlap_share(obs, roles["events"], roles["push"],
                                    roles["main"], "device_kernel")
        push = roles["push"]
        pk = [e for e in roles["events"] if e["stream"] in push]
        bwd = [e for e in roles["events"] if is_bwd(e)]
        df_us = sum(obs.stream_overlap_us(pk + bwd, s, [roles["main"]])
                    for s in push)
        hidden = {}                    # push kernel name -> overlapped us
        for e in pk:
            hidden.setdefault(e["name"], []).append(e)
        hidden = {n: obs.stream_overlap_us(es + main_k, es[0]["stream"],
                                           [roles["main"]])
                  for n, es in hidden.items()}
        hidden = {n: v for n, v in hidden.items() if v > 0}
        top = sorted(hidden.items(), key=lambda kv: -kv[1])[:3]
        check(p_ov > 0 and any("elementwise" in n for n in hidden),
              f"{phase}: no push-stream kernel (the uniforms' elementwise "
              f"ones among them) ran while the main stream's did: "
              f"{p_ov:.1f} of {p_own:.1f} us")
        model = obs.StepModel(work_s=main_us / steps / 1e6,
                              push_s=p_own / steps / 1e6)
        out.update(push_share=p_ov / p_own, push_ms=p_own / steps / 1e3,
                   model_eff=model.overlap_efficiency())
        print(f"{phase}: push stream {sorted(push)[0]}: "
              f"{p_own / steps / 1e3:.3f} ms of device time per step, "
              f"{100 * p_ov / p_own:.1f}% of it while main-stream kernels "
              f"ran ({df_us / steps / 1e3:.3f} ms per step beside kernels D "
              f"and F); StepModel(main {main_us / steps / 1e3:.3f} ms, "
              f"push {p_own / steps / 1e3:.3f} ms per step) models "
              f"{100 * out['model_eff']:.1f}% hidden; most hidden: "
              + ", ".join(f"{n[:60]} {v / steps / 1e3:.3f} ms"
                          for n, v in top))
    print(f"{phase}: {n_spans} spans and device events in the trace, "
          f"streams {roles['streams']} (main {roles['main']}, push "
          f"{sorted(roles['push'])}, copies {sorted(roles['copy'])}); "
          f"{len(rows)} JSONL lines; H2D copies {c_own / steps / 1e3:.3f} "
          f"ms per step, {100 * out['copy_share']:.1f}% of it beside "
          f"main-stream kernels; stage {out['stage_ms']:.2f} ms, step "
          f"{out['step_ms']:.1f} ms, sample {out['sample_ms']:.1f} ms per "
          f"step; {h['t_wall']:.2f} s/epoch; device busy "
          f"{100 * out['busy']:.1f}% of the step spans; traced [{card}]")
    bd = obs.EpochBreakdown.from_history(res["history"], model)
    for line in bd.table().splitlines():
        print(f"{phase}: {line}")
    del res, tr
    torch.cuda.empty_cache()
    return out


def phase10_same(torch, phase, a, b):
    """Two runs on one minibatch stream give the same bits: per step the
    HEC tag and age digests and every metric (loss, accuracy, gradient
    norm, pushed rows and bytes, hits, occupancy), the epoch's loss and
    the final parameters.  Every sum on the step's path runs in a fixed
    order (F and H gather through the slot index, D's stripes in stripe
    order), so nothing is held to a tolerance.  Returns the number of
    steps compared."""
    check(len(a["steps"]) == len(b["steps"]) > 0, f"{phase}: "
          f"{len(a['steps'])} vs {len(b['steps'])} steps")
    for i, (x, y) in enumerate(zip(a["steps"], b["steps"])):
        check(x["tags"] == y["tags"] and x["ages"] == y["ages"],
              f"{phase}: step {i}: HEC tags or ages differ")
        diff = {k: (x["m"][k], y["m"].get(k)) for k in x["m"]
                if x["m"][k] != y["m"].get(k)}
        check(not diff and set(x["m"]) == set(y["m"]),
              f"{phase}: step {i}: metrics differ: {diff}")
    check(a["history"]["loss"] == b["history"]["loss"],
          f"{phase}: epoch losses {a['history']['loss']!r} vs "
          f"{b['history']['loss']!r}")
    leaves = [k for k, (p, q) in enumerate(zip(a["params"], b["params"]))
              if not torch.equal(p, q)]
    check(not leaves, f"{phase}: parameter leaves {leaves} differ "
          f"(worst {max(rel_norm(a['params'][k], b['params'][k]) for k in leaves) if leaves else 0:.3e})")
    return len(a["steps"])


def phase10_main_path(torch, np, card):
    """(a), (b), (d) and (e): four launcher epochs on phase 4's graph.
    Returns each run's launches, by name."""
    from repro_torch.configs.gnn import PipelineConfig
    runs = {"default": phase10_run(torch, np, "default", "(a, b) default",
                                   card),
            "sync_copy": phase10_run(
                torch, np, "sync_copy", "(a) double_buffer=False", card,
                pipeline=PipelineConfig(double_buffer=False)),
            "inline_push": phase10_run(torch, np, "inline_push",
                                       "(b) overlap=False", card,
                                       overlap=False),
            "workers": phase10_run(
                torch, np, "workers", f"(e) num_workers={P10_WORKERS}", card,
                pipeline=PipelineConfig(num_workers=P10_WORKERS,
                                        prefetch_depth=P10_WORKERS))}
    a, s, i, w = (runs[k] for k in ("default", "sync_copy", "inline_push",
                                    "workers"))
    n = phase10_same(torch, "phase 10 (a)", a, s)
    print(f"phase 10 (a): double-buffered vs in-order copies: the same "
          f"bits at all {n} steps (tags, ages, every metric), in the "
          f"epoch's loss and in the parameters; stage {a['stage_ms']:.2f} vs "
          f"{s['stage_ms']:.2f} ms per step, H2D copy time beside "
          f"main-stream kernels {100 * a['copy_share']:.1f}% vs "
          f"{100 * s['copy_share']:.1f}%; {a['history']['t_wall']:.2f} vs "
          f"{s['history']['t_wall']:.2f} s/epoch [{card}]")
    n = phase10_same(torch, "phase 10 (b)", a, i)
    print(f"phase 10 (b): push on its side stream vs inline after the "
          f"backward: the same bits at all {n} steps, in the epoch's loss "
          f"and in the parameters; measured overlap "
          f"{100 * a['push_share']:.1f}% of {a['push_ms']:.3f} ms per step "
          f"beside StepModel's {100 * a['model_eff']:.1f}%; step "
          f"{a['step_ms']:.1f} vs {i['step_ms']:.1f} ms, device busy "
          f"{100 * a['busy']:.1f}% vs {100 * i['busy']:.1f}% of the step "
          f"spans [{card}]")
    n = phase10_same(torch, "phase 10 (e)", a, w)
    print(f"phase 10 (e): {P10_WORKERS} prefetch workers vs 1: sample "
          f"{w['sample_ms']:.1f} vs {a['sample_ms']:.1f} ms per step (per "
          f"worker, in parallel), step {w['step_ms']:.1f} vs "
          f"{a['step_ms']:.1f} ms, {w['history']['t_wall']:.2f} vs "
          f"{a['history']['t_wall']:.2f} s/epoch; the same bits at all "
          f"{n} steps [{card}]")
    return {k: r["launches"] for k, r in runs.items()}


class _Enough(Exception):
    """Stops a ``train_epochs`` after the steps a check needs."""


def phase10_unstaged(torch, np):
    """(c): ``train_epochs(pipeline=None)`` (the reference's per-row
    sampler, one generator, each batch copied in step order) for
    ``CHECK_STEPS`` steps at phase 9 (c)'s size on the CPU and on the
    card; one more card run takes each step from the CPU's state before
    it: loss and gradient norm within 1e-4 relative, Adam's first moment
    within 1e-4, HEC tags and ages and queued tags equal.  The free card
    run draws the CPU's minibatches, its loss within ``FREE_RUN_TOL``."""
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    R = 4
    g = synthetic_graph(num_vertices=CHECK_VERTICES, avg_degree=10,
                        num_classes=172, feat_dim=128, seed=0)
    ps = partition_graph(g, R, seed=0)
    cfg = launcher_config(TRAIN_ARGS, batch_size=CHECK_BATCH)
    cfg = dataclasses.replace(cfg, hec=dataclasses.replace(
        cfg.hec, cache_size=CHECK_HEC_SIZE))

    def ints(st):
        return [x.to("cpu", copy=True) for x in
                [s.tags for layer in st["hec"] for s in layer]
                + [s.age for layer in st["hec"] for s in layer]
                + [q["tags"] for q in st["inflight"]]]

    def run(d, starts=None):
        tr = DistTrainer(cfg, R, device=d)
        data = build_dist_data(ps, cfg, d)
        out = {"logs": [], "mu": [], "ints": [], "states": [], "mbs": []}
        inner = tr.train_step

        def step(state, data_, mb, seed):
            if len(out["logs"]) == CHECK_STEPS:
                raise _Enough
            if d == "cpu":
                out["states"].append(state_to(torch, state, "cpu"))
            out["mbs"].append({k: [x.cpu() for x in v] if isinstance(
                v, list) else v.cpu() for k, v in mb.items()})
            out["logs"].append(inner(state, data_, mb, seed))
            out["mu"].append([m.cpu().clone() for m in state["opt"].mu])
            out["ints"].append(ints(state))
            return out["logs"][-1]
        if starts is None:
            tr.train_step = step
            try:
                tr.train_epochs(ps, data, tr.init_state(seed=0), 1,
                                pipeline=None)
            except _Enough:
                pass
        else:
            for i, st in enumerate(starts):
                st = state_to(torch, st, d)
                out["logs"].append(tr.train_step(
                    st, data, minibatch_to_device(runs["cpu"]["mbs"][i], d),
                    i))
                out["mu"].append([m.cpu().clone() for m in st["opt"].mu])
                out["ints"].append(ints(st))
        return out

    t0 = time.perf_counter()
    runs = {"cpu": run("cpu")}
    runs["free"] = run("cuda")
    runs["card"] = run("cuda", starts=runs["cpu"]["states"])
    c, p, fr = runs["card"], runs["cpu"], runs["free"]
    tag = "phase 10 (c)"
    check(len(p["logs"]) == len(c["logs"]) == len(fr["logs"]) == CHECK_STEPS,
          f"{tag}: {len(p['logs'])} steps")
    held = free = 0.0
    for i in range(CHECK_STEPS):
        check(all(torch.equal(x, y) for k in p["mbs"][i]
                  for x, y in (zip(p["mbs"][i][k], fr["mbs"][i][k])
                               if isinstance(p["mbs"][i][k], list)
                               else [(p["mbs"][i][k], fr["mbs"][i][k])])),
              f"{tag}: step {i}: the card's unstaged minibatch differs")
        for key in ("loss", "grad_norm"):
            a, b = c["logs"][i][key], p["logs"][i][key]
            check(abs(a - b) <= 1e-4 * abs(b), f"{tag}: step {i} {key}: "
                  f"card {a} vs CPU {b}")
            a = fr["logs"][i][key]
            check(abs(a - b) <= FREE_RUN_TOL * abs(b), f"{tag}: step {i} "
                  f"{key}: the card's free run {a} vs CPU {b}")
            free = max(free, abs(a - b) / abs(b))
        check(all(torch.equal(x, y) for x, y in zip(c["ints"][i],
                                                    p["ints"][i])),
              f"{tag}: step {i}: HEC tags, ages or queued tags differ")
        gap = max(rel_norm(x, y) for x, y in zip(c["mu"][i], p["mu"][i]))
        check(gap <= 1e-4, f"{tag}: step {i}: gradient (Adam mu) differs "
              f"by {gap:.3e} relative")
        held = max(held, gap)
    filled = sum(int((x >= 0).sum()) for x in c["ints"][-1][:3 * R])
    print(f"{tag}: train_epochs(pipeline=None), {CHECK_STEPS} steps at "
          f"batch {CHECK_BATCH} on {CHECK_VERTICES} vertices, card (each "
          f"step from the CPU's state) vs CPU: losses "
          f"{[m['loss'] for m in c['logs']]} vs "
          f"{[m['loss'] for m in p['logs']]}; gradient rel. diff "
          f"{held:.2e}; {filled} HEC tags, the ages and queued tags equal; "
          f"the card's free run on the same minibatches within {free:.2e} "
          f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 11: training that repeats bit for bit, and the two planes
# ---------------------------------------------------------------------------
P11_DIR = os.path.join(ROOT, "build", "phase11")
P11_STEPS = 4               # (a), (b): steps of each of the three runs
ANSWERS = {}                # phases 3 and 8's answers, for (c)


class FewSteps:
    """A minibatch source for ``train_epochs``: the first ``n`` batches of
    epoch 0 of the trainer's own sampler (``SamplingPlan``, base seed 0),
    each copied to the card when the loop asks for it."""

    def __init__(self, ps, cfg, n, device):
        import itertools

        from repro_torch.pipeline.prefetcher import SamplingPlan
        plan = SamplingPlan(ps, cfg, 0)
        self.hosts = list(itertools.islice(
            plan.batches(plan.epoch_schedule(0), 0), n))
        self.device = device

    def epoch_batches(self, ep):
        from repro_torch.pipeline.staging import minibatch_to_device
        for host in self.hosts:
            yield minibatch_to_device(host, self.device)


def bit_digest(torch, t, chunk=1 << 24):
    """An int64 weighted sum of a tensor's 32-bit words, chunk by chunk on
    the card: equal tensors give equal digests, and a change of any bit
    changes it."""
    flat = t.detach().reshape(-1)
    flat = flat.view(torch.int32) if flat.element_size() == 4 \
        else flat.long()
    w = bit_digest.w.get(flat.device)
    if w is None:
        g = torch.Generator().manual_seed(11)
        w = bit_digest.w[flat.device] = torch.randint(
            1, 2 ** 31 - 1, (chunk,), generator=g).to(flat.device)
    acc = torch.zeros((), dtype=torch.int64, device=flat.device)
    for k, i in enumerate(range(0, flat.numel(), chunk)):
        part = flat[i:i + chunk].long() + 2
        acc += (part * w[:part.numel()]).sum() * (k + 1)
    return acc


bit_digest.w = {}


def state_digests(torch, state):
    """Digests of everything a training run leaves: parameters, every
    HEC's tags, ages and values, the hot tier, the in-flight queues (the
    pushes)."""
    hecs = [s for layer in state["hec"] for s in layer]
    d = {"params": [bit_digest(torch, p)
                    for p in state["model"].parameter_list()],
         "tags": [bit_digest(torch, s.tags) for s in hecs],
         "ages": [bit_digest(torch, s.age) for s in hecs],
         "values": [bit_digest(torch, s.values) for s in hecs],
         "hot": [bit_digest(torch, getattr(t, f)) for t in state["hot"]
                 for f in ("age", "values")],
         "pushes": [bit_digest(torch, q[k]) for q in state["inflight"]
                    for k in sorted(q)]}
    return {k: [int(x) for x in v] for k, v in d.items()}


def phase11_train(torch, np, model, card):
    """(a) GraphSAGE at phase 4's settings, (b) GAT at phase 6's: the
    first ``P11_STEPS`` steps of epoch 0 trained three times from the same
    state, twice with both planes off and once with both on (and an audit
    after the epoch, its flight directory under ``build/phase11``).  All
    three runs give the same bits in every step's metrics, the epoch's
    loss, the parameters, every HEC's tags, ages and values and the
    queued pushes; the launches per step are phase 4's (6's) in every run,
    and the "on" run adds only the audit's offline pass.  Prints the rank
    series, the audit's per-layer error and its time.  Returns the "on"
    run's launches."""
    import tempfile

    from repro_torch import obs
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.launch import train
    from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data
    phase = f"phase 11 ({'a' if model == 'graphsage' else 'b'}) {model}"
    argv = TRAIN_ARGS + ["--vertices", str(TRAIN_VERTICES)]
    if model == "gat":
        argv += ["--model", "gat", "--lr", "0.001", "--hec-size",
                 str(GAT_HEC_SIZE)]
    args = train.parse_args(argv)
    cfg = train.gnn_config(args)
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=args.degree,
                        num_classes=args.classes, feat_dim=args.feat_dim,
                        seed=args.seed)
    ps = partition_graph(g, args.ranks, seed=args.seed)
    R, L = args.ranks, cfg.num_layers
    data = build_dist_data(ps, cfg, "cuda")
    src = FewSteps(ps, cfg, P11_STEPS, "cuda")
    os.makedirs(P11_DIR, exist_ok=True)
    if model == "graphsage":
        per_step, _ = phase4_counts()
        audit_kernel = "serve_fused_layer"
    else:
        per_step = {"hec_lookup": L * R, "gat_edge_fwd": L * R,
                    "gat_edge_bwd": L * R, "slot_index": L * R}
        audit_kernel = "gat_edge_fwd"
    runs = []
    for label in ("off", "off again", "on"):
        obs.configure()
        planes, audit_s = {}, []
        if label == "on":
            health = obs.HealthPlane(
                obs.HealthConfig(flight_dir=tempfile.mkdtemp(dir=P11_DIR)),
                num_ranks=R, expected_halo_rows=[p.num_halo
                                                 for p in ps.parts])
            planes = dict(health=health, quality=obs.QualityPlane(
                obs.QualityConfig(audit_interval=1), health=health))
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        tr = DistTrainer(cfg=cfg, num_ranks=R, device="cuda", **planes)
        if planes:
            audit = tr.audit

            def timed_audit(*a, _audit=audit, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rep = _audit(*a, **kw)
                torch.cuda.synchronize()
                audit_s.append(time.perf_counter() - t0)
                return rep
            tr.audit = timed_audit
        state = tr.init_state(seed=args.seed)
        t0 = time.perf_counter()
        state, hist = tr.train_epochs(ps, data, state, 1, pipeline=src)
        tr.join_push()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        run = {"label": label, "log": list(tr.step_log),
               "loss": hist[0]["loss"], "launches": launches,
               "digests": state_digests(torch, state), "secs": secs,
               "peak": torch.cuda.max_memory_allocated()}
        steps = len(tr.step_log)
        check(steps == P11_STEPS, f"{phase} {label}: {steps} steps")
        for n in launches:
            if planes and n == audit_kernel:      # held below
                continue
            want = steps * per_step.get(n, 0)
            check(launches[n] == want, f"{phase} {label}: {n} launched "
                  f"{launches[n]} times, expected {want}")
        if planes:
            q, h = planes["quality"], planes["health"]
            check(q.audits_run == 1 and len(audit_s) == 1,
                  f"{phase}: {q.audits_run} audits")
            rep = q.last_report
            reg = obs.get().registry
            series = {n: obs.rank_series(reg, n, R).tolist()
                      for n in ("rank_examples", "rank_sample_rows",
                                "rank_halo_rows", "rank_hec_hits",
                                "rank_push_rows", "rank_push_bytes")}
            check(series["rank_examples"] and sum(
                series["rank_examples"]) == sum(m["examples"]
                                                 for m in tr.step_log),
                  f"{phase}: the rank series do not sum the steps' examples")
            check(rep.mean_err is not None and np.isfinite(rep.mean_err)
                  and rep.per_layer[0]["err_max"] == 0.0,
                  f"{phase}: audit {rep.to_json()}")
            check(h.summary()["windows"] == 1, f"{phase}: health windows "
                  f"{h.summary()['windows']}")
            chunks = sum(-(-p.num_solid // OFFLINE_CHUNK) for p in ps.parts)
            extra = launches[audit_kernel] - steps * per_step.get(
                audit_kernel, 0)
            check(extra == L * chunks, f"{phase}: the audit launched "
                  f"{audit_kernel} {extra} times, expected {L * chunks}")
            run["audit"] = {"s": audit_s[0], "report": rep.to_json(),
                            "series": series, "extra_launches": extra}
        runs.append(run)
        del tr, state, hist
        torch.cuda.empty_cache()
    base = runs[0]
    for r in runs[1:]:
        check(r["log"] == base["log"] and r["loss"] == base["loss"],
              f"{phase}: run '{r['label']}' parts from run 'off' in a "
              f"step's metrics or the epoch's loss")
        diff = [k for k in base["digests"]
                if r["digests"][k] != base["digests"][k]]
        check(not diff, f"{phase}: run '{r['label']}' parts from run 'off' "
              f"in {diff}")
    on = runs[-1]["audit"]
    rep = on["report"]
    print(f"{phase}: three runs of {P11_STEPS} steps (planes off, off, on) "
          f"give the same bits: losses {[m['loss'] for m in base['log']]}, "
          f"{sum(len(v) for v in base['digests'].values())} digests of "
          f"parameters, HEC tags, ages and values, hot tier and pushes; "
          f"launches per run {runs[0]['launches']}")
    print(f"{phase}: rank series of the epoch: {on['series']}")
    print(f"{phase}: audit after the epoch in {on['s']:.3f} s (host clock, "
          f"{on['extra_launches']} launches of {audit_kernel}): mean "
          f"rel-L2 {rep['mean_err']:.6f}; per layer " + "; ".join(
              f"l{l}: n {v['n']}, mean {v.get('err_mean', 0.0):.6f}, p99 "
              f"{v.get('err_p99', 0.0):.6f}, max {v.get('err_max', 0.0):.6f}"
              for l, v in rep["layers"].items())
          + f"; peak memory {runs[-1]['peak'] / 2 ** 30:.2f} GiB [{card}]")
    return runs[-1]["launches"], on["s"]


def answers(np, reqs):
    """A pass's answers as one array, in request order."""
    return np.stack([r.result for r in reqs]) if reqs else None


def phase11_serve(torch, np, args, card):
    """(c) single-rank and sharded serving through their launchers
    (GraphSAGE) with ``--audit-interval 1`` and an SLO of 1 ns: every
    answer bit-equal to a run with the quality plane off (phase 3's for
    the single rank; for the shards, a run just before at round batch 1,
    so that a pass runs rounds enough for the burn's window of two); the
    single-rank cache warmed from the offline rows and the shards warmed
    from the sharded offline pass (the hot replicas too) audit to exactly
    0.0; the SLO burn fires and its ``FLIGHT_slo_burn.json`` parses.
    Returns the launches of the two runs with the planes and the fresh
    sharded audit's seconds."""
    import tempfile

    from repro_torch.launch import gnn_serve, gnn_serve_dist
    from repro_torch.serve.gnn.distributed import layerwise_embeddings_dist
    os.makedirs(P11_DIR, exist_ok=True)
    common = ["--preset", "graphsage-papers100m", "--device", "cuda",
              "--vertices", str(args.vertices), "--queries",
              str(args.queries)]
    planes = ["--audit-interval", "1", "--slo-p99-ms", "0.000001",
              "--flight-dir"]
    sharded = common + ["--round-batch", "1"]
    res = gnn_serve_dist.run(gnn_serve_dist.parse_args(sharded))
    ANSWERS["sharded, round batch 1"] = (answers(np, res["serve"]),
                                         answers(np, res["repeat"]))
    del res
    out = {}
    for name, launcher, argv in (
            ("single-rank", gnn_serve, common + ["--slots", str(SLOTS)]),
            ("sharded, round batch 1", gnn_serve_dist, sharded)):
        fd = tempfile.mkdtemp(dir=P11_DIR)
        phase = f"phase 11 (c) {name}"
        zero_launches()
        res = launcher.run(launcher.parse_args(argv + planes + [fd]))
        torch.cuda.synchronize()
        launches = read_launches()
        passes = ("cold", "warm") if name == "single-rank" \
            else ("serve", "repeat")
        for p, want in zip(passes, ANSWERS[name]):
            got = answers(np, res[p])
            check(got is not None and got.shape == want.shape and
                  np.array_equal(got.view(np.int32), want.view(np.int32)),
                  f"{phase}: the {p} pass's answers differ from the run "
                  f"with the quality plane off")
        srv = res["srv"]
        t_audit = None
        if name == "single-rank":
            fresh = res["audits"][-1]
            check(fresh.mean_err == 0.0 and all(
                v["n"] > 0 and v["err_max"] == 0.0
                for v in fresh.per_layer.values()),
                f"{phase}: the warmed cache audits to {fresh.to_json()}")
        else:
            cfg, ps = res["cfg"], res["ps"]
            srv.update_params(srv.model)
            ed = layerwise_embeddings_dist(cfg, srv.model, ps)
            srv.cache.warm(ed, np.arange(len(ps.owner)))
            if srv.hot is not None:
                srv.hot.warm(ed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh = srv.audit()
            torch.cuda.synchronize()
            t_audit = time.perf_counter() - t0
            check(fresh.mean_err == 0.0 and all(
                v["n"] > 0 and v["err_max"] == 0.0
                for v in fresh.per_layer.values())
                and (fresh.hot is None or fresh.hot["err_max"] == 0.0),
                f"{phase}: fresh shards audit to {fresh.to_json()}")
        with open(os.path.join(fd, "FLIGHT_slo_burn.json")) as f:
            dump = json.load(f)
        check(dump["detection"]["detector"] == "slo_burn"
              and dump["num_entries"] > 0,
              f"{phase}: FLIGHT_slo_burn.json holds {sorted(dump)}")
        print(f"{phase}: answers of both passes bit-equal to the run with "
              f"the quality plane off; audits after the passes "
              + ", ".join(f"{a.mean_err:.6f}" for a in res["audits"])
              + f"; fresh audit {fresh.mean_err} over "
              f"{sum(v['n'] for v in fresh.per_layer.values())} lines"
              + (f" and {fresh.hot['n']} hot replicas" if fresh.hot
                 else "")
              + (f" in {t_audit:.3f} s (host clock)" if t_audit else "")
              + f"; SLO burn fired after {dump['detection']['epoch'] + 1} "
              f"rounds, its flight file {dump['num_entries']} entries; "
              f"launches {launches} [{card}]")
        out[name] = {"launches": launches, "audit_s": t_audit}
        del res, srv
        torch.cuda.empty_cache()
    out["sharded"] = out.pop("sharded, round batch 1")
    return out


def phase11_kernels(torch, np):
    """(d) F and H on collision-heavy inputs at training widths: a hub
    source row that 5,000 slots point at, a second of CHUNK + 1, -1 pads
    and indices past N: three launches bit-equal, within tolerance of the
    plain versions in float64 (a 5,000-term float32 sum parts from the
    exact one by ~1e-4 in any order, the plain version's atomics
    included), F the plain version's bits on its short rows."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import slot_index as si
    rng = np.random.default_rng(11)

    def hub_nbr(N, M, f):
        nbr = rng.integers(-1, N + 3, (M, f)).astype(np.int32)
        flat = nbr.reshape(-1)
        pick = rng.choice(flat.size, 5000 + si.CHUNK + 1, replace=False)
        flat[pick[:5000]], flat[pick[5000:]] = 7, 8
        return torch.as_tensor(nbr, device="cuda")

    dev = torch.device("cuda")
    N, M, f, D = 176_000, 16_000, 10, 256
    nbr = hub_nbr(N, M, f)
    valid = torch.as_tensor(rng.random(N) > 0.15, device=dev)
    valid[[7, 8]] = True
    cnt = ((nbr >= 0) & valid[nbr.long().clamp(0, N - 1)]).sum(1).float()
    g = torch.randn(M, D, device=dev)
    row_f = agg_bwd_case(torch, sa, ref, "phase 11 (d) F", g, nbr, valid,
                         cnt, N, timed=False)
    rows_h = []
    for (N, M, f, H, dh), dst in (((20_000, 4_000, 5, 4, 256), False),
                                  ((20_000, 4_000, 5, 1, 172), True)):
        nbr = hub_nbr(N, M, f)
        valid = torch.as_tensor(rng.random(N) > 0.15, device=dev)
        valid[[7, 8]] = True
        z = torch.randn(N, H, dh, device=dev)
        e_u, e_v = torch.randn(N, H, device=dev), torch.randn(N, H,
                                                               device=dev)
        d = torch.as_tensor(rng.integers(-2, N + 2, M).astype(np.int32),
                            device=dev) if dst else None
        rows_h.append(gat_bwd_case(torch, ge, ref, "phase 11 (d) H",
                                   torch.randn(M, H * dh, device=dev), z,
                                   e_u, e_v, nbr, valid, d, timed=False))
    for label, r in [("F", row_f)] + [("H", r) for r in rows_h]:
        print(f"phase 11 (d): {label} {r['shape']}: longest source row "
              f"{r['longest_row_slots']} slots, {r['repeats_bitwise']} "
              f"launches bit-equal, max|d| vs "
              f"{r.get('held_to', 'the plain version')} "
              f"{r['max_abs_err']:.3e}"
              + (f", {r['rows_bitwise_plain']} of {r['rows']} rows the "
                 f"plain version's bits" if "rows" in r else ""))

# ---------------------------------------------------------------------------
# phase 12: the resilience plane
# ---------------------------------------------------------------------------
P12_DIR = os.path.join(ROOT, "build", "phase12")
P12_EPOCHS = 3              # (a): epochs of each run
# (a)'s cuts: a graph of 180,000 vertices at phase 4's degree, widths and
# batch (5 steps an epoch, not 11: the latest fault of P12_CHAOS is at
# epoch 1, step 3) and 131,072 HEC lines (x 8 ways) per layer and rank,
# not 1M, so an archive of the whole state holds 1.4 GB, not 10.2 GB
P12_VERTICES = 180_000
P12_HEC_SIZE = 131_072
P12_CHAOS = [{"kind": "nan_step", "epoch": 1, "step": 0, "rank": 1},
             {"kind": "corrupt_push", "epoch": 1, "step": 3, "rank": 1},
             {"kind": "drop_push", "epoch": 2, "step": 1, "rank": 0},
             {"kind": "delay_rank", "epoch": 2, "step": 0, "rank": 0,
              "seconds": 0.01}]
P12_GAT_NAN = {"kind": "nan_step", "epoch": 0, "step": 1, "rank": 2}
# (0)'s shapes: C (N, C, K) and E (N, M, f, D) at phase 4's layers 0-2
# (rank 0's first minibatch), A (N, M, f, D, K) at phase 3's, G and H
# (N, M, f, H, dh) at phase 6's layers 1 and 2 and a serving layer 0
P12_NAN_SHAPES = {
    "C": [(176_000, 128, 256), (16_000, 256, 256), (1000, 256, 172)],
    "E": [(1_056_000, 176_000, 5, 128), (176_000, 16_000, 10, 256),
          (16_000, 1000, 15, 256)],
    "A": [(67_584, 11_264, 5, 128, 256), (11_264, 2048, 10, 256, 256),
          (2048, 64, 15, 256, 172)],
    "G": [(67_584, 11_264, 5, 4, 256), (176_000, 16_000, 10, 4, 256),
          (16_000, 1000, 15, 1, 172)]}


def nan_close(torch, got, want):
    """NaN and +-inf exactly where ``want`` has them, finite elsewhere and
    within ``TOL``; returns (ok, max |d| over the finite ones, NaNs)."""
    fin = torch.isfinite(want)
    ok, err = close_to(got[fin], want[fin])
    inf = torch.isinf(want)
    return (ok and bool(torch.equal(torch.isnan(got), torch.isnan(want)))
            and bool(torch.equal(got[inf], want[inf]))
            and bool(torch.isfinite(got[fin]).all())), err, \
        int(torch.isnan(want).sum())


def phase12_nan(torch, np):
    """(0): kernels C, A, E, G and H on NaN rows at the main paths' layer
    shapes (rank 0's first minibatch of phases 4 and 6, phase 3's layer
    0): NaN exactly where the plain version has it, elsewhere within
    tolerance (E's counts and C's dZ bit for bit); E also on +-inf rows.
    Valid and invalid sources are poisoned, row 0 (which every pad reads)
    among them.  H on a fanout whose every slot is included, with NaN
    rows in z and e_u and a NaN row of g."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import serve_fused as sf
    from repro_torch.kernels import update_fused as uf
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def normal(*s, scale=1.0):
        return t((rng.normal(size=s) * scale).astype(np.float32))

    def inputs(N, M, f, D):
        nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
        nbr[1] = -1
        valid = rng.random(N) > 0.15
        bad = [0, int(np.flatnonzero(valid)[3]),
               int(np.flatnonzero(~valid)[2])]
        return t(nbr), t(valid), bad
    out = []
    for N, C, K in P12_NAN_SHAPES["C"]:
        agg, self_h = normal(N, C), normal(N, C)
        wn, ws, b = normal(C, K, scale=0.1), normal(C, K, scale=0.1), \
            normal(K, scale=0.1)
        agg[[0, 7, N - 1]] = float("nan")
        self_h[[3, 7]] = float("nan")
        agg[11, 5] = float("nan")
        for relu, p in ((True, 0.5), (True, 0.0), (False, 0.0)):
            got = uf.update_fused_fwd(agg, self_h, wn, ws, b, relu=relu,
                                      dropout=p, seed=9)
            want = ref.fused_update_ref(agg, self_h, wn, ws, b, relu=relu,
                                        dropout=p, seed=9)
            ok, err, n = nan_close(torch, got, want)
            check(ok and n > 0, f"phase 12 (0): C at {N}x{C}->{K} relu "
                  f"{relu} dropout {p}: NaN or values part from the plain "
                  f"version (max |d| {err:.3e})")
            if relu:
                g = normal(N, K)
                dz, _ = uf.update_fused_bwd(g, want, relu=True, dropout=p,
                                            seed=9)
                dz_p, _ = ref.fused_update_bwd_ref(g, want, relu=True,
                                                   dropout=p, seed=9)
                check(bool(torch.equal(dz, dz_p)), f"phase 12 (0): D at "
                      f"{N}x{K}: dZ not bit-equal on NaN rows")
        out.append(f"C {N}x{C}->{K} {n} NaN")
    for N, M, f, D in P12_NAN_SHAPES["E"]:
        nbr, valid, bad = inputs(N, M, f, D)
        h = normal(N, D)
        h[bad] = float("nan")
        vrows = torch.nonzero(valid).flatten()
        h[int(vrows[9]), 0] = float("inf")
        h[int(torch.nonzero(~valid).flatten()[5]), -1] = -float("inf")
        mean, cnt = sa.sage_agg_fwd(h, nbr, valid)
        mean_p, cnt_p = ref.sage_agg_ref(h, nbr, valid)
        ok, err, n = nan_close(torch, mean, mean_p)
        check(ok and n > 0 and bool(torch.equal(cnt, cnt_p)),
              f"phase 12 (0): E at {M}x{f}x{D}: NaN, inf or values part "
              f"from the plain version (max |d| {err:.3e})")
        out.append(f"E {M}x{f}x{D} {n} NaN")
    for N, M, f, D, K in P12_NAN_SHAPES["A"]:
        nbr, valid, bad = inputs(N, M, f, D)
        h = normal(N, D)
        h[bad] = float("nan")
        wn, ws, b = normal(D, K, scale=0.1), normal(D, K, scale=0.1), \
            normal(K, scale=0.1)
        for relu in (True, False):
            kw = dict(h_src=h, nbr_idx=nbr, src_valid=valid, wn=wn, ws=ws,
                      b=b, relu=relu)
            got = sf.serve_fused_layer(**kw)
            want = ref.serve_layer_ref(**kw)
            ok, err, n = nan_close(torch, got, want)
            check(ok and n > 0, f"phase 12 (0): A at {M}x{f}x{D}->{K} "
                  f"relu {relu}: NaN or values part from the plain version "
                  f"(max |d| {err:.3e})")
        out.append(f"A {M}x{f}x{D}->{K} {n} NaN")
    for N, M, f, H, dh in P12_NAN_SHAPES["G"]:
        nbr, valid, bad = inputs(N, M, f, H * dh)
        z = normal(N, H, dh)
        eu, ev = normal(N, H), normal(M, H)
        z[bad] = float("nan")
        eu[int(torch.nonzero(valid).flatten()[9])] = float("nan")
        ev[4, 0] = float("nan")
        kw = dict(z=z, e_u=eu, e_v=ev, nbr_idx=nbr, src_valid=valid)
        got = ge.gat_edge_fwd(**kw)
        want = ref.gat_edge_ref(**kw)
        ok, err, n = nan_close(torch, got, want)
        check(ok and n > 0, f"phase 12 (0): G at {M}x{f}x{H}x{dh}: NaN or "
              f"values part from the plain version (max |d| {err:.3e})")
        kw.update(nbr_idx=t(rng.integers(0, N, (M, f)).astype(np.int32)),
                  src_valid=torch.ones_like(valid))
        g = normal(M, H * dh)
        g[2] = float("nan")
        g[5, -1] = float("nan")
        got_h = ge.gat_edge_bwd(g, **kw)
        want_h = ref.gat_edge_bwd_ref(g, **kw)
        for name, a, w in zip(("dz", "de_u", "de_v"), got_h, want_h):
            ok, err, nh = nan_close(torch, a, w)
            check(ok and nh > 0, f"phase 12 (0): H at {M}x{f}x{H}x{dh}: "
                  f"{name}'s NaN or values part from the plain version "
                  f"(max |d| {err:.3e})")
        out.append(f"G/H {M}x{f}x{H}x{dh} {n} NaN")
        del z, got, want, got_h, want_h
    torch.cuda.empty_cache()
    out += phase12_nonfinite(torch)
    print("phase 12 (0): NaN where the plain versions have it: "
          + "; ".join(out))


# phase 12 (0), this slice's cases (kernels/nonfinite.py): F and H at the
# training layers (H every kind at layer 2 and a smaller layer, g at
# layer 1), C and A at P12_NAN_SHAPES
P12_NONFINITE = {
    "F": P12_NAN_SHAPES["E"][1:],
    "H": [((176_000, 16_000, 10, 4, 256), ("g",)),
          ((20_000, 4000, 5, 4, 256), ("g", "z", "eu")),
          ((16_000, 1000, 15, 1, 172), ("g", "z", "eu"))]}


def phase12_nonfinite(torch):
    """Kernels F and H on infinite and NaN gradients and activations at
    every kind of slot (kept, masked, pads, indices past N, a row with no
    kept slot), C and A on infinite and near-FLT_MAX inputs: +-inf and NaN
    exactly where the plain versions have them, elsewhere within
    tolerance.  Returns the summary's entries."""
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import nonfinite as nf
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import serve_fused as sf
    from repro_torch.kernels import update_fused as uf
    dev = torch.device("cuda")

    def case(c):
        return {k: torch.as_tensor(v, device=dev) for k, v in c.items()}
    out = []
    for N, M, f, D in P12_NONFINITE["F"]:
        c = case(nf.agg_case(N + D, N, M, f, D))
        args = (c["g"], c["nbr_idx"], c["src_valid"], c["cnt"], N)
        ok, err, n = nan_close(torch, sa.sage_agg_bwd(*args),
                               ref.sage_agg_bwd_ref(*args))
        check(ok and n > 0, f"phase 12 (0): F at {M}x{f}x{D} -> {N}: "
              f"non-finite values part from the plain version (max |d| "
              f"{err:.3e})")
        out.append(f"F {M}x{f}x{D} {n} NaN")
    for (N, M, f, H, dh), kinds in P12_NONFINITE["H"]:
        for kind in kinds:
            c = case(nf.gat_case(N + f, N, M, f, H, dh, kind))
            g = c.pop("g")
            got, want = ge.gat_edge_bwd(g, **c), ref.gat_edge_bwd_ref(g, **c)
            bad = 0
            for name, a, w in zip(("dz", "de_u", "de_v"), got, want):
                ok, err, n = nan_close(torch, a, w)
                check(ok, f"phase 12 (0): H at {M}x{f}x{H}x{dh} ({kind}): "
                      f"{name}'s non-finite values part from the plain "
                      f"version (max |d| {err:.3e})")
                bad += int((~torch.isfinite(w)).sum())
            check(bad > 0, f"phase 12 (0): H ({kind}) has nothing non-finite")
            out.append(f"H {M}x{f}x{H}x{dh} {kind} {bad} non-finite")
            del c, g, got, want
    torch.cuda.empty_cache()
    for N, C, K in P12_NAN_SHAPES["C"]:
        c = case(nf.update_case(N + K, N, C, K))
        for relu, p in ((True, 0.5), (False, 0.0)):
            kw = dict(relu=relu, dropout=p, seed=9)
            want = ref.fused_update_ref(**c, **kw)
            ok, err, _ = nan_close(torch, uf.update_fused_fwd(**c, **kw), want)
            check(ok and bool(torch.isinf(want).any() or relu),
                  f"phase 12 (0): C at {N}x{C}->{K} relu {relu}: inf or NaN "
                  f"part from the plain version (max |d| {err:.3e})")
        out.append(f"C {N}x{C}->{K} {int(torch.isinf(want).sum())} inf")
    for N, M, f, D, K in P12_NAN_SHAPES["A"]:
        c = case(nf.serve_case(N + K, N, M, f, D, K))
        for relu in (True, False):
            want = ref.serve_layer_ref(**c, relu=relu)
            ok, err, _ = nan_close(torch, sf.serve_fused_layer(**c, relu=relu),
                                   want)
            check(ok and bool((~torch.isfinite(want)).any()),
                  f"phase 12 (0): A at {M}x{f}x{D}->{K} relu {relu}: inf or "
                  f"NaN part from the plain version (max |d| {err:.3e})")
        out.append(f"A {M}x{f}x{D}->{K} {int(torch.isinf(want).sum())} inf")
    return out


def sha256_leaves(torch, state) -> str:
    """SHA-256 over the state's checkpoint leaves (the archive's order)."""
    import hashlib

    from repro_torch.train import checkpoint as ckpt
    h = hashlib.sha256()
    for leaf in ckpt.state_leaves(state):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        h.update(leaf.tobytes())
    return h.hexdigest()


def phase12_setup(model="graphsage"):
    """Phase 6's graph, partition, launcher config and data on the card
    for GAT; for GraphSAGE phase 4's settings on a ``P12_VERTICES`` graph
    with the HEC cut to ``P12_HEC_SIZE``."""
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.launch import train
    from repro_torch.train.gnn_trainer import build_dist_data
    if model == "gat":
        argv = TRAIN_ARGS + ["--vertices", str(TRAIN_VERTICES), "--model",
                             "gat", "--lr", "0.001", "--hec-size",
                             str(GAT_HEC_SIZE)]
    else:
        argv = TRAIN_ARGS + ["--vertices", str(P12_VERTICES), "--hec-size",
                             str(P12_HEC_SIZE)]
    args = train.parse_args(argv)
    cfg = train.gnn_config(args)
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=args.degree,
                        num_classes=args.classes, feat_dim=args.feat_dim,
                        seed=args.seed)
    ps = partition_graph(g, args.ranks, seed=args.seed)
    return args, cfg, ps, build_dist_data(ps, cfg, "cuda")


def phase12_resume(ckpt_dir: str, epoch: int) -> None:
    """(a) run 5's second half, in a fresh process: restore the newest
    checkpoint under ``ckpt_dir`` and train epoch ``epoch``; prints a
    RESULT line with the SHA-256 of the state's leaves."""
    import torch

    from repro_torch import resilience
    from repro_torch.kernels import _build
    from repro_torch.train.gnn_trainer import DistTrainer
    _build.build(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    args, cfg, ps, data = phase12_setup()
    plane = resilience.ResiliencePlane(resilience.ResilienceConfig(
        ckpt_dir=ckpt_dir, ckpt_every=P12_EPOCHS + 1))
    tr = DistTrainer(cfg=cfg, num_ranks=args.ranks, device="cuda",
                     resilience=plane)
    state = tr.init_state(seed=args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, saved = plane.ckpt.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state, _ = tr.train_epochs(ps, data, state, 1, start_epoch=saved + 1)
    tr.join_push()
    print("RESULT" + json.dumps({"saved": saved, "restore_s": restore_s,
                                 "sha": sha256_leaves(torch, state),
                                 "step": state["step"],
                                 "adam": state["opt"].step}))


def phase12_train(torch, np, card):
    """(a): GraphSAGE at phase 4's widths and settings on a
    ``P12_VERTICES`` graph (HEC cut to ``P12_HEC_SIZE`` lines per layer
    and rank), ``P12_EPOCHS`` epochs per run, compared by the SHA-256 of
    the checkpoint leaves: (1) unarmed
    (with a checkpoint after epoch 1: a plane that only checkpoints does
    not arm the step), (2) armed with ``nan_guard`` and no fault: (1)'s
    bits and launches, (3) the chaos schedule ``P12_CHAOS`` twice: equal,
    every fault fired, steps skipped, parameters finite, not (1)'s bits,
    ``FLIGHT_resilience.json`` written, (4) ``kill_prefetch`` at (0, 1),
    one epoch: one retry and (1)'s bits after epoch 0, (5) a fresh
    process, started when (1) ends and run beside (2)-(4), restores (1)'s
    checkpoint and trains epoch 2: (1)'s bits.
    Returns run (2)'s launches."""
    import shutil

    from repro_torch import obs, resilience
    from repro_torch.train.gnn_trainer import DistTrainer
    phase = "phase 12 (a)"
    args, cfg, ps, data = phase12_setup()
    R = args.ranks
    shutil.rmtree(P12_DIR, ignore_errors=True)
    os.makedirs(P12_DIR)
    ck_dir = os.path.join(P12_DIR, "ck")
    per_step, _ = phase4_counts()

    def run(label, plane, epochs=P12_EPOCHS):
        obs.configure()
        zero_launches()
        tr = DistTrainer(cfg=cfg, num_ranks=R, device="cuda",
                         resilience=plane)
        state = tr.init_state(seed=args.seed)
        every = label == "unarmed"          # (4) reads epoch 0's bits
        shas, hist, save_s = [], [], []
        if plane is not None and plane.ckpt is not None:
            save = plane.ckpt.save

            def timed_save(*a, _save=save):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = _save(*a)
                save_s.append(time.perf_counter() - t0)
                return path
            plane.ckpt.save = timed_save
        for ep in range(epochs):
            state, h = tr.train_epochs(ps, data, state, 1, start_epoch=ep)
            hist += h
            tr.join_push()
            if every:
                shas.append(sha256_leaves(torch, state))
        if not every:
            shas.append(sha256_leaves(torch, state))
        launches = read_launches()
        steps = len(tr.step_log)
        res = {"label": label, "shas": shas, "launches": launches,
               "steps": steps, "log": tr.step_log, "plane": plane,
               "step_ms": 1e3 * sum(h["t_step"] for h in hist) / steps,
               "finite": all(bool(torch.isfinite(p).all()) for p in
                             state["model"].parameter_list()),
               "adam": state["opt"].step, "save_s": save_s}
        skipped = sum(m.get("skipped", 0.0) for m in tr.step_log)
        for n, c in launches.items():
            want = steps * per_step.get(n, 0)
            check(c == want, f"{phase} {label}: {n} launched {c} times, "
                  f"expected {want} ({steps} steps, {skipped:.0f} skipped)")
        del tr, state
        torch.cuda.empty_cache()
        return res

    base = run("unarmed", resilience.ResiliencePlane(
        resilience.ResilienceConfig(ckpt_dir=ck_dir, ckpt_every=2,
                                    ckpt_keep=1)))
    check(not base["plane"].step_armed and base["adam"] == base["steps"],
          f"{phase}: the checkpointing plane armed the step")
    archive = os.path.join(ck_dir, "ckpt_ep00001.npz")
    check(sorted(os.listdir(ck_dir)) == ["LATEST", "ckpt_ep00001.npz"],
          f"{phase}: checkpoints {sorted(os.listdir(ck_dir))}")
    nbytes = os.path.getsize(archive)
    # (5) beside (2)-(4): a fresh process restores (1)'s checkpoint
    resume = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.phase12_resume(sys.argv[1], int(sys.argv[2]))",
         ck_dir, "2"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    CHILDREN.append(resume)
    armed = run("armed", resilience.ResiliencePlane(
        resilience.ResilienceConfig(nan_guard=True)))
    check(armed["shas"][-1] == base["shas"][-1],
          f"{phase}: armed with no fault parts from the unarmed run")
    check(all(m["skipped"] == 0.0 for m in armed["log"]) and [
        {k: v for k, v in m.items() if k != "skipped"}
        for m in armed["log"]] == base["log"],
          f"{phase}: armed with no fault parts in a step's metrics")
    extra = {n: armed["launches"][n] - base["launches"][n]
             for n in base["launches"]}
    chaos = []
    for k in range(2):
        d = os.path.join(P12_DIR, f"chaos{k}")
        os.makedirs(d)
        plane = resilience.ResiliencePlane(resilience.ResilienceConfig(
            nan_guard=True, flight_dir=d,
            schedule=resilience.FaultSchedule.from_dicts(P12_CHAOS)))
        chaos.append(run(f"chaos {k}", plane))
        chaos[-1]["flight"] = os.path.exists(
            os.path.join(d, "FLIGHT_resilience.json"))
    c0, c1 = chaos
    skips = [m["skipped"] for m in c0["log"]]
    check(c0["shas"] == c1["shas"] and skips == [
        m["skipped"] for m in c1["log"]],
          f"{phase}: the chaos run does not repeat bit for bit")
    check(c0["plane"].skipped_steps == c1["plane"].skipped_steps >= 1
          and len(c0["plane"].events) == 4 and c0["finite"]
          and c0["shas"][-1] != base["shas"][-1] and c0["flight"]
          and c0["adam"] == c0["steps"] - c0["plane"].skipped_steps,
          f"{phase}: chaos: skipped {c0['plane'].skipped_steps}, events "
          f"{len(c0['plane'].events)}, finite {c0['finite']}, flight "
          f"{c0['flight']}, Adam count {c0['adam']}")
    before = obs.get().registry.value("prefetch_retries")
    kill = run("kill_prefetch", resilience.ResiliencePlane(
        resilience.ResilienceConfig(schedule=resilience.FaultSchedule([
            resilience.FaultSpec("kill_prefetch", 0, 1)]))), epochs=1)
    retries = obs.get().registry.value("prefetch_retries") - before
    check(retries == 1 and kill["shas"][0] == base["shas"][0],
          f"{phase}: kill_prefetch: {retries} retries, bits "
          f"{'equal' if kill['shas'][0] == base['shas'][0] else 'differ'}")
    try:
        out, err = resume.communicate(timeout=600)
    finally:
        if resume.poll() is None:
            resume.kill()
            resume.wait()
    check(resume.returncode == 0, f"{phase}: the resuming process "
          f"failed:\n{err[-3000:]}")
    child = json.loads([x for x in out.splitlines()
                        if x.startswith("RESULT")][-1][len("RESULT"):])
    check(child["saved"] == 1 and child["sha"] == base["shas"][-1]
          and child["adam"] == base["adam"]
          and child["step"] == base["steps"],
          f"{phase}: the fresh process's run parts from the uninterrupted "
          f"one: {child}")
    shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"{phase}: GraphSAGE, 4 ranks, phase 4's settings on "
          f"{P12_VERTICES:,} vertices (phase 4: {TRAIN_VERTICES:,}), HEC "
          f"cut to {P12_HEC_SIZE:,} lines x 8 ways per layer and rank "
          f"(phase 4: 1M), {P12_EPOCHS} epochs of "
          f"{base['steps'] // P12_EPOCHS} steps per run")
    print(f"{phase}: (1) unarmed and (2) armed (nan_guard, no fault): the "
          f"same SHA-256 {base['shas'][-1][:16]} and metrics; step "
          f"{base['step_ms']:.1f} / {armed['step_ms']:.1f} ms (host clock, "
          f"indicative); the armed step's extra launches {extra} [{card}]")
    print(f"{phase}: (3) chaos {P12_CHAOS}, twice: SHA-256 "
          f"{c0['shas'][-1][:16]} both, skipped steps "
          f"{c0['plane'].skipped_steps} at "
          f"{[i for i, s in enumerate(skips) if s]}"
          f", {len(c0['plane'].events)} events, parameters finite, Adam "
          f"count {c0['adam']} of {c0['steps']} steps, "
          f"FLIGHT_resilience.json written; step {c0['step_ms']:.1f} ms")
    print(f"{phase}: (4) kill_prefetch at (0, 1): {retries:.0f} retry, "
          f"epoch 0's bits; (5) archive {nbytes:,} bytes, saved in "
          f"{base['save_s'][0]:.2f} s, restored in a fresh process (beside "
          f"(2)-(4)) in {child['restore_s']:.2f} s, epoch 2 trained there: "
          f"the uninterrupted run's SHA-256 [{card}]")
    return armed["launches"]


def phase12_gat(torch, np, card):
    """(b): GAT at phase 6's settings, phase 11 (b)'s first
    ``P11_STEPS`` steps: armed with ``nan_guard`` and no fault, every bit
    and launch of the unarmed run; a ``nan_step`` at ``P12_GAT_NAN``:
    that step skipped, every other step applied, parameters finite.
    Returns the armed run's launches."""
    from repro_torch import obs, resilience
    from repro_torch.train.gnn_trainer import DistTrainer
    phase = "phase 12 (b) gat"
    args, cfg, ps, data = phase12_setup("gat")
    src = FewSteps(ps, cfg, P11_STEPS, "cuda")
    runs = {}
    for label, plane in (
            ("unarmed", None),
            ("armed", resilience.ResiliencePlane(
                resilience.ResilienceConfig(nan_guard=True))),
            ("nan_step", resilience.ResiliencePlane(
                resilience.ResilienceConfig(
                    nan_guard=True, schedule=resilience.FaultSchedule
                    .from_dicts([P12_GAT_NAN]))))):
        obs.configure()
        zero_launches()
        tr = DistTrainer(cfg=cfg, num_ranks=args.ranks, device="cuda",
                         resilience=plane)
        state = tr.init_state(seed=args.seed)
        state, _ = tr.train_epochs(ps, data, state, 1, pipeline=src)
        tr.join_push()
        runs[label] = {"log": tr.step_log, "launches": read_launches(),
                       "digests": state_digests(torch, state),
                       "finite": all(bool(torch.isfinite(p).all()) for p in
                                     state["model"].parameter_list()),
                       "adam": state["opt"].step}
        del tr, state
        torch.cuda.empty_cache()
    u, a, n = runs["unarmed"], runs["armed"], runs["nan_step"]
    check(a["digests"] == u["digests"] and a["launches"] == u["launches"]
          and [{k: v for k, v in m.items() if k != "skipped"}
               for m in a["log"]] == u["log"],
          f"{phase}: armed with no fault parts from the unarmed run")
    skips = [m["skipped"] for m in n["log"]]
    check(skips == [float(i == P12_GAT_NAN["step"])
                    for i in range(P11_STEPS)] and n["finite"]
          and n["adam"] == P11_STEPS - 1
          and n["digests"]["params"] != u["digests"]["params"],
          f"{phase}: nan_step: skipped {skips}, finite {n['finite']}, "
          f"Adam count {n['adam']}")
    print(f"{phase}: armed and unarmed: the same bits and launches "
          f"({u['launches']}); nan_step at {P12_GAT_NAN}: skipped {skips}, "
          f"losses {[m['loss'] for m in n['log']]}, parameters finite "
          f"[{card}]")
    return a["launches"]


def phase12_serve(torch, np, args, card):
    """(c): sharded serving of both models.  Phase 8's launcher flow with
    ``failover=True``: every answer phase 8's bits, the same launches.
    Then, on phase 8 (c)'s exactness graph (every degree within the
    fanout, 4 shards, hidden layers and hot tier warmed from the sharded
    offline pass), rank 1 marked dead with a failing probe: its hub
    queries answer the offline rows bit for bit, its cold ones zeros,
    ``serve_degraded`` 1; a round of alive ranks' queries runs J with rank
    1 masked (held bit for bit to its plain version); a passing probe
    closes the breaker and fresh queries of rank 1's vertices are within
    tolerance of the offline rows; one dead and one recovered event.
    Returns the failover flows' launches by model."""
    import repro_torch.comm.engine as engine
    import repro_torch.serve.gnn.distributed as dist
    from repro_torch import obs
    from repro_torch.configs.gnn import GAT_PAPERS100M, GRAPHSAGE_PAPERS100M
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import hec_search as hs
    from repro_torch.launch import gnn_serve_dist
    from repro_torch.models.gnn import build_model
    from repro_torch.serve.gnn import ServeCacheConfig
    dev = torch.device("cuda")
    launches = {}
    orig = dist.DistServeConfig
    for preset in ("graphsage-papers100m", "gat-papers100m"):
        model = preset.split("-")[0]
        dist.DistServeConfig = lambda **kw: orig(failover=True, **kw)
        zero_launches()
        try:
            res = gnn_serve_dist.run(gnn_serve_dist.parse_args([
                "--preset", preset, "--vertices", str(args.vertices),
                "--queries", str(args.queries), "--device", "cuda"]))
            launches[model] = read_launches()
        finally:
            dist.DistServeConfig = orig
        check(res["srv"].breaker is not None,
              f"phase 12 (c) {model}: the flow ran without failover")
        want = ANSWERS[f"sharded_{model}"]
        for got, w in zip((answers(np, res["serve"]),
                           answers(np, res["repeat"])), want):
            check(np.array_equal(got.view(np.int32), w.view(np.int32)),
                  f"phase 12 (c) {model}: failover with every rank alive "
                  f"parts from phase 8's answers")
        check(launches[model] == ANSWERS[f"sharded_{model}_launches"],
              f"phase 12 (c) {model}: launches {launches[model]} differ "
              f"from phase 8's")
        del res
        torch.cuda.empty_cache()
    g = synthetic_graph(num_vertices=3000, avg_degree=2, num_classes=172,
                        feat_dim=128, seed=3)
    part = partition_graph(g, 1, seed=0).parts[0]
    ps = partition_graph(g, DIST_RANKS, seed=0)
    max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
    out = []
    for base in (GRAPHSAGE_PAPERS100M, GAT_PAPERS100M):
        cfg = dataclasses.replace(base, fanouts=(max_deg,) * 3)
        phase = f"phase 12 (c) {cfg.model}"
        model = build_model(cfg, seed=1, device=dev)
        embs = dist.layerwise_embeddings_dist(cfg, model, ps, chunk_size=512)
        offline = embs[-1].cpu().numpy()
        obs.configure()
        reg = obs.get().registry
        srv = dist.DistGNNServeScheduler(
            cfg, model, ps, orig(
                num_slots=16, halo_slots=256, hot_size=64, dedup=True,
                round_batch=2, failover=True,
                cache=ServeCacheConfig(cache_size=65536, ways=8)),
            device=dev)
        srv.cache.warm(embs, np.arange(part.num_solid),
                       layers=range(cfg.num_layers - 1))
        srv.hot.warm(embs)
        hot_vids = np.asarray(srv.hot.hot_vids)
        owner, _ = ps.route(hot_vids)
        dead_hot = hot_vids[owner == 1][:6]
        hot_set = set(int(v) for v in hot_vids)
        cold = [int(v) for v in ps.parts[1].solid_vids
                if int(v) not in hot_set]
        srv.probe_fn = lambda r: False
        srv.mark_dead(1)
        ans = srv.serve(np.concatenate([dead_hot, cold[:3]]))
        m = srv.metrics()
        check(len(dead_hot) == 6 and np.array_equal(
            ans[:6].view(np.int32), offline[dead_hot].view(np.int32))
              and bool(np.all(ans[6:] == 0.0))
              and (m["serve_degraded"], m["dead_ranks"]) == (1.0, [1])
              and m["degraded_answers"] >= 6 and m["degraded_dropped"] >= 3
              and reg.value("serve_degraded") == 1.0,
              f"{phase}: rank 1 dead: {m}")
        probes, unprobe = record_last(engine, "hec_probe",
                                      lambda tags, *a: tags.data_ptr())
        try:
            alive_v = np.asarray(ps.parts[0].solid_vids[:64])
            got_alive = srv.serve(alive_v)
        finally:
            unprobe()
        check(probes and srv.metrics()["steps_run"] > 0,
              f"{phase}: no round ran with rank 1 dead")
        for tags, values, vids, alive in probes.values():
            check(alive is not None and not bool(alive[1]),
                  f"{phase}: J ran without rank 1 masked")
            probe_case(torch, hs, f"{phase} J, rank 1 dead",
                       types.SimpleNamespace(tags=tags, values=values), vids,
                       alive, timed=False)
        srv.probe_fn = lambda r: True
        srv.serve(np.asarray(ps.parts[2].solid_vids[:4]))
        m = srv.metrics()
        post = np.asarray(cold[3:35])
        got = srv.serve(post)
        err = np.abs(got - offline[post])
        check((m["serve_degraded"], m["dead_ranks"]) == (0.0, [])
              and reg.value("serve_degraded") == 0.0 and bool(np.all(
                  err <= TOL * np.maximum(1.0, np.abs(offline[post]))))
              and [len(list(reg.events_of(f"serve_rank_{k}")))
                   for k in ("dead", "recovered")] == [1, 1],
              f"{phase}: recovery: {m}, max |d| {err.max():.3e}")
        out.append(f"{cfg.model}: 6 hub answers bit-equal from alive "
                   f"replicas, 3 zeros, {len(probes)} J launches with rank "
                   f"1 masked bit-equal, {len(alive_v)} alive-rank answers "
                   f"finite ({bool(np.isfinite(got_alive).all())}), "
                   f"{len(post)} answers after the re-probe within "
                   f"tolerance (max |d| {err.max():.3e})")
        del srv, embs
        torch.cuda.empty_cache()
    print(f"phase 12 (c): failover with every rank alive gives phase 8's "
          f"answers and launches, both models [{card}]")
    print("phase 12 (c): rank 1 dead on phase 8 (c)'s graph: "
          + "; ".join(out))
    return launches


# ---------------------------------------------------------------------------
# phase 13: the dry run at the paper's 64 ranks, and the GNN examples
# ---------------------------------------------------------------------------
P13_RANKS = 64
P13_VERTICES = 30_000
# GAT's per-rank queue and push buffers grow with dmax = 4 x 256: at 64
# ranks about 120 GB, more than the card holds; 32 ranks fit
P13_GAT_RANKS = 32
P13_EXAMPLES = ("quickstart", "distributed_gat", "serve_gnn",
                "serve_gnn_dist")


def phase13_dryrun(torch, phase, argv, kernels, cases=None):
    """One ``launch/gnn_dryrun.py`` run on the card, every launch count
    set to 0 just before and read just after; each of ``kernels`` must
    have been launched.  ``cases`` (``sage_layer_cases`` or
    ``gat_layer_cases``) then holds the kernels to their plain versions
    at the run's layer shapes (rank 0's first minibatch, on the run's
    caches), outside the count.  Returns (report, launches); the report
    keeps no state of the run."""
    from repro_torch.launch import gnn_dryrun
    torch.cuda.empty_cache()
    print(f"{phase}: python -m repro_torch.launch.gnn_dryrun "
          + " ".join(argv))
    zero_launches()
    rep = gnn_dryrun.run(argv + ["--device", "cuda"], keep=cases is not None)
    launches = read_launches()
    if cases is not None:
        cases(torch, rep, f"{phase}, the run's shapes", timed=False)
        for key in ("mu", "ps", "cfg", "data", "state", "trainer"):
            del rep[key]
        torch.cuda.empty_cache()
    for name in kernels:
        check(launches[name] > 0, f"{phase}: kernel {name} was not "
              f"launched")
    r = rep["cost"]
    ar = r["collectives"]["all-reduce"]["bytes"] - rep["param_bytes"]
    check(0 < ar <= 128, f"{phase}: the all-reduce moved {ar:.0f} B beside "
          f"the parameters' {rep['param_bytes']}, not the step's scalar "
          f"metrics")
    t = rep["terms"]
    print(f"{phase}: per rank flops {r['flops']:.6e}, bytes "
          f"{r['bytes_accessed']:.6e}, collective {r['collective_bytes']:.0f}"
          f" B; roofline compute {t['compute_s'] * 1e3:.4f} ms, memory "
          f"{t['memory_s'] * 1e3:.4f} ms, collective (HBM copy) "
          f"{t['collective_s'] * 1e3:.4f} ms, over NVLink "
          f"{rep['nvlink_s'] * 1e3:.4f} ms; step {rep['step_s'] * 1e3:.1f} "
          f"ms wall, {rep['device_step_ms']:.1f} ms device; first step "
          f"with the count {rep['first_step_s']:.1f} s; peak "
          f"{rep['peak_bytes'] / 2 ** 30:.2f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return rep, launches


def phase13_count_check():
    """The dry run's step on the card and on the CPU (plain versions
    counted by the kernels' formulas), 2 ranks at the dry run's config:
    the same count (flops, bytes, collectives, products, launches), and
    the same step within phase 9 (c)'s free-run tolerance: the counted
    step's loss and gradient norm (and GraphSAGE's second step's), and
    its gradient, Adam's first moment, per parameter tensor (but GAT's
    noise-level attention leaves, ``GAT_CPU_NOISY_LEAVES``, held through
    the norm)."""
    from repro_torch.launch import gnn_dryrun
    argv = ["--ranks", "2", "--vertices", "1500"]
    for model in ("graphsage", "gat"):
        reps = {d: gnn_dryrun.run(argv + ["--model", model, "--device", d],
                                  keep=True) for d in ("cpu", "cuda")}
        got = {d: r["cost"] for d, r in reps.items()}
        for key in ("flops", "bytes_accessed", "collectives", "products"):
            check(got["cpu"][key] == got["cuda"][key],
                  f"phase 13 (a) {model}: the step's {key} on the card "
                  f"{got['cuda'][key]} is not the CPU's {got['cpu'][key]}")
        check({k: v["launches"] for k, v in got["cpu"]["kernels"].items()}
              == {k: v["launches"] for k, v in got["cuda"]["kernels"].items()},
              f"phase 13 (a) {model}: kernel launches differ from the CPU's")
        steps = 2 if model == "graphsage" else 1
        for i in range(steps):
            for key in ("loss", "grad_norm"):
                a, b = (reps[d]["logs"][i][key] for d in ("cuda", "cpu"))
                check(abs(a - b) <= FREE_RUN_TOL * abs(b),
                      f"phase 13 (a) {model}: step {i} {key} on the card "
                      f"{a} vs the CPU's {b}")
        noisy = GAT_CPU_NOISY_LEAVES if model == "gat" else ()
        rels = [rel_norm(a, b) for a, b in zip(reps["cuda"]["mu"],
                                               reps["cpu"]["mu"])]
        held = max(r for i, r in enumerate(rels) if i not in noisy)
        check(held <= FREE_RUN_TOL, f"phase 13 (a) {model}: the gradient "
              f"(Adam mu) differs by {held:.3e} relative")
        print(f"phase 13 (a) {model} at 2 ranks, card vs CPU: losses "
              f"{[m['loss'] for m in reps['cuda']['logs'][:steps]]} vs "
              f"{[m['loss'] for m in reps['cpu']['logs'][:steps]]}; "
              f"gradient rel. diff per tensor "
              f"{[float(f'{r:.3e}') for r in rels]}"
              + (f" (leaves {list(noisy)} held through the norm)"
                 if noisy else ""))
        del reps
    print("phase 13 (a): the step's count (flops, bytes, collectives, "
          "products, launches) on the card is the CPU's, and its loss "
          "and gradient within the free-run tolerance, both models")


P13_HELD = ("quickstart", "serve_gnn", "serve_gnn_dist")
P13_NUMBER = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?"


def same_report(card: str, cpu: str) -> bool:
    """One printed line of an example on the card against the CPU's: the
    same words and integers (counts, classes), and each decimal within 2%
    or two units of its last printed digit (a free run's float32 drift;
    a wrong kernel moves a loss or an accuracy by more).  A line's own
    timing (from " (push ") is not compared."""
    import re
    card, cpu = (ln.split(" (push ")[0] for ln in (card, cpu))
    if re.sub(P13_NUMBER, "#", card) != re.sub(P13_NUMBER, "#", cpu):
        return False
    for x, y in zip(re.findall(P13_NUMBER, card),
                    re.findall(P13_NUMBER, cpu)):
        if "." not in y and "e" not in y:
            if x != y:
                return False
            continue
        unit = 10.0 ** -len(y.split(".")[1].split("e")[0])
        if abs(float(x) - float(y)) > max(0.02 * abs(float(y)), 2 * unit):
            return False
    return True


def phase13_examples():
    """(c): the four GNN examples, each in a process of its own on the
    card, and the three of them a CPU runs in seconds (``P13_HELD``) with
    ``--device cpu`` (the plain versions, whose lines the CPU tests hold
    to the reference's examples), all at once; each must exit 0, print
    its summary, and the card's lines must be the CPU's
    (:func:`same_report`)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = [(name, "cuda") for name in P13_EXAMPLES] \
        + [(name, "cpu") for name in P13_HELD]
    procs = {}
    try:
        for name, dev in runs:
            procs[name, dev] = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples",
                                              f"torch_{name}.py"),
                 "--device", dev],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        outs = {key: p.communicate(timeout=300)[0]
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    want = {"quickstart": ("test accuracy:", "AEP overlap:"),
            "distributed_gat": ("aep  : test_acc=", "sync : test_acc=",
                                "drop : test_acc=",
                                "comm_bytes/step=2105344",
                                "comm_bytes/step=139264"),
            "serve_gnn": ("identical results: True", "pre-warmed serve",
                          "cache invalidated"),
            "serve_gnn_dist": ("identical results: True",
                               "no stale answers")}
    for (name, dev), p in procs.items():
        check(p.returncode == 0, f"phase 13 (c): examples/torch_{name}.py "
              f"--device {dev} exited {p.returncode}:\n"
              f"{outs[name, dev][-2000:]}")
        for k in want[name]:
            check(k in outs[name, dev], f"phase 13 (c): torch_{name}.py "
                  f"--device {dev} printed no '{k}'")
    for name in P13_EXAMPLES:
        lines = outs[name, "cuda"].splitlines()
        if name in P13_HELD:
            cpu = outs[name, "cpu"].splitlines()
            check(len(lines) == len(cpu) and all(
                same_report(a, b) for a, b in zip(lines, cpu)),
                f"phase 13 (c): torch_{name}.py on the card printed\n"
                + "\n".join(lines) + "\nand on the CPU\n" + "\n".join(cpu))
        for ln in lines[-3:]:
            print(f"phase 13 (c) torch_{name}: {ln}")
    print(f"phase 13 (c): the card's lines of {', '.join(P13_HELD)} are "
          f"the CPU's (integers equal, each decimal within 2% or two units "
          f"of its last digit)")


def phase13(torch):
    """(a) the dry run, GraphSAGE ``aep`` at 64 ranks and 30,000 vertices:
    one push all_to_all of ``aep_bytes_per_step(64, 2, 1024, [128, 256])``
    = 134,742,016 B a rank, the all-reduce the parameters and the step's
    scalar metrics, B-F held to their plain versions at the run's layer
    shapes; at 2 ranks the count, loss and gradient equal to the CPU's;
    (b) ``sync`` at 64 ranks (two all_to_alls of ``sync_bytes_per_step``
    in all) and GAT at ``P13_GAT_RANKS``, B, G and H held at its shapes;
    (c) the four examples.  Returns the runs' launches by path."""
    from repro_torch.core.aep import aep_bytes_per_step, sync_bytes_per_step
    base = ["--ranks", str(P13_RANKS), "--vertices", str(P13_VERTICES)]
    sage = ("update_fused_fwd", "update_fused_bwd", "sage_agg_fwd",
            "sage_agg_bwd")
    launches = {}
    rep, launches["dryrun"] = phase13_dryrun(
        torch, "phase 13 (a) graphsage aep", base, sage + ("hec_lookup",),
        sage_layer_cases)
    a2a = rep["cost"]["collectives"]["all-to-all"]
    want = aep_bytes_per_step(P13_RANKS, 2, 1024, [128, 256])
    check(aep_bytes_per_step(64, 2, 1024, [128, 256]) == 134_742_016
          and a2a["count"] == 1 and a2a["bytes"] == want,
          f"phase 13 (a): the push was {a2a['count']} all_to_all(s) of "
          f"{a2a['bytes']:.0f} B a rank, not one of {want}")
    phase13_count_check()
    rep, launches["dryrun_sync"] = phase13_dryrun(
        torch, "phase 13 (b) graphsage sync", base + ["--mode", "sync"],
        sage)
    a2a = rep["cost"]["collectives"]["all-to-all"]
    want = sync_bytes_per_step(P13_RANKS, 1024, 128)
    check(a2a["count"] == 2 and a2a["bytes"] == want,
          f"phase 13 (b) sync: {a2a['count']} all_to_alls of "
          f"{a2a['bytes']:.0f} B, not 2 of {want} in all")
    rep, launches["gat_dryrun"] = phase13_dryrun(
        torch, f"phase 13 (b) gat aep at {P13_GAT_RANKS} ranks",
        ["--ranks", str(P13_GAT_RANKS), "--vertices", str(P13_VERTICES),
         "--model", "gat"], ("gat_edge_fwd", "gat_edge_bwd", "hec_lookup"),
        gat_layer_cases)
    a2a = rep["cost"]["collectives"]["all-to-all"]
    want = aep_bytes_per_step(P13_GAT_RANKS, 2, 1024, [128, 1024])
    check(a2a["count"] == 1 and a2a["bytes"] == want,
          f"phase 13 (b) gat: {a2a['count']} all_to_all(s) of "
          f"{a2a['bytes']:.0f} B, not one of {want}")
    torch.cuda.empty_cache()
    phase13_examples()
    return launches


# ---------------------------------------------------------------------------
# phase 14: LM serving
# ---------------------------------------------------------------------------
P14_UNIT_ARCHS = ("minitron-4b", "h2o-danube-3-4b", "mixtral-8x7b",
                  "phi3.5-moe-42b-a6.6b", "xlstm-1.3b", "recurrentgemma-9b",
                  "qwen2-vl-7b", "seamless-m4t-medium")
P14_WIDE = "command-r-plus-104b"    # (a): one unit, on the card only
P14_BATCH, P14_PROMPT, P14_STEPS = 2, 32, 8
P14_MAIN = "minitron-4b"            # (b): the examples' default
P14_MAIN_BATCH, P14_MAIN_PROMPT, P14_MAIN_DECODE = 4, 2048, 64
P14_SLOTS, P14_REQUESTS, P14_CACHE = 8, 16, 512
P14_REQ_PROMPT, P14_REQ_NEW = (32, 128), 32
P14_SWA = "h2o-danube-3-4b"         # (c): the ring cache at full depth
P14_SWA_PROMPT, P14_SWA_DECODE = 6144, 16
P14_SPREAD = 1e-7                   # embedding noise of the spread probe
P14_ATOL = P14_RTOL = 2e-2          # tests/test_arch_smoke.py:91-93
# max |logit - a float32 run's| of a bf16 path at full depth ((b), (c))
P14_LIMIT = 0.125
P14_BF16_ARCHS = ("minitron-4b", "mixtral-8x7b")   # (a) in bf16
P14_BF16_STEPS = 2
P14_ATTN_EQUAL = 0.99               # attention's bf16 outputs bit for bit
P14_BF16_TOL = 0.65                 # rms, of the bf16-float32 distance


def p14_unit(cfg):
    """One unit of ``cfg``'s pattern (recurrentgemma: and the remainder's
    first layer), one encoder layer, float32; the published widths."""
    rem = tuple(cfg.remainder[:1])
    return dataclasses.replace(
        cfg, name=cfg.name + "-unit", num_units=1, remainder=rem,
        num_layers=len(cfg.pattern) + len(rem),
        num_encoder_layers=min(cfg.num_encoder_layers, 1), dtype="float32")


def p14_params(torch, M, cfg, seed, dtype):
    """Weights of the reference's shapes and scales, drawn on the card
    from a ``torch.Generator`` (a host draw of billions of Threefry
    normals is too slow); nothing here is compared with the reference."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return M._build(seed, cfg, lambda key, shape: torch.randn(
        shape, generator=gen, device="cuda"), "cuda", dtype)


def p14_inputs(torch, np, cfg, batch, length, device, seed=14):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, length)), device=device)}
    if cfg.num_patch_tokens:
        out["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(batch, cfg.num_patch_tokens, cfg.d_model)).astype(
                np.float32), device=device)
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = torch.as_tensor(rng.normal(
            size=(batch, cfg.num_frame_tokens, cfg.d_model)).astype(
                np.float32), device=device)
    return out


def p14_prefill_decode(torch, M, L, cfg, params, batch, steps, feed=None):
    """Prefill, then ``steps`` decode steps from the prefill caches at the
    positions after the prompt (greedy, or the ids ``feed``): every logit
    and id, and the caches after each of the two."""
    logits, caches = L.make_prefill_step(cfg)(params, batch)
    first = M.tree_map(lambda a: a.clone(), caches)
    serve = L.make_serve_step(cfg)
    pos = batch["tokens"].shape[1] + (cfg.num_patch_tokens
                                      if "patch_embeds" in batch else 0)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out = {"prefill": logits, "decode": [], "ids": [tok],
           "prefill_cache": first}
    for i in range(steps):
        if feed is not None:
            tok = feed[i]
        nxt, lg, caches = serve(params, caches, tok.long(), pos + i)
        out["decode"].append(lg)
        out["ids"].append(nxt)
        tok = nxt
    out["cache"] = caches
    return out


def p14_err(torch, got, want) -> float:
    g, w = got.double().cpu(), want.double().cpu()
    return float(((g - w).abs() / w.abs().clamp_min(1.0)).max())


def p14_spread(torch, M, L, cfg, params, batch):
    """How far the card's own prefill logits and cache states move when
    the embedding is perturbed by ``P14_SPREAD`` relative noise (float32
    rounding's size): the floor below which no float32 run can be held
    to another."""
    logits, caches = L.make_prefill_step(cfg)(params, batch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    e = params["embed"]
    noisy = dict(params, embed=e * (1 + P14_SPREAD * torch.randn(
        e.shape, generator=gen, device="cuda")))
    nl, nc = L.make_prefill_step(cfg)(noisy, batch)
    del noisy
    return max([p14_err(torch, nl, logits)] + [
        p14_err(torch, x, y) for x, y in zip(M.tree_leaves(nc),
                                             M.tree_leaves(caches))
        if x.dtype.is_floating_point])


def phase14_units(torch, np):
    """(a) each family at its published widths, one unit deep, float32:
    the card against the port's CPU path from the same weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    worst = {}
    for i, arch in enumerate(P14_UNIT_ARCHS):
        t0 = time.perf_counter()
        cfg = p14_unit(get_arch(arch))
        params = p14_params(torch, M, cfg, 140 + i, torch.float32)
        batch = p14_inputs(torch, np, cfg, P14_BATCH, P14_PROMPT, "cuda")
        card = p14_prefill_decode(torch, M, L, cfg, params, batch, P14_STEPS)
        spread = p14_spread(torch, M, L, cfg, params, batch)
        tol = max(TOL, 4 * spread)
        cpu_params = M.tree_map(lambda a: a.cpu(), params)
        del params
        torch.cuda.empty_cache()
        cpu = p14_prefill_decode(
            torch, M, L, cfg, cpu_params,
            {k: v.cpu() for k, v in batch.items()}, P14_STEPS,
            feed=[t.cpu() for t in card["ids"]])
        del cpu_params
        errs = [p14_err(torch, card["prefill"], cpu["prefill"])] + [
            p14_err(torch, a, b) for a, b in zip(card["decode"],
                                                 cpu["decode"])]
        check(max(errs) <= tol and all(
            bool(torch.isfinite(x).all()) for x in card["decode"]),
            f"phase 14 (a) {arch}: card logits {max(errs):.3e} from the "
            f"CPU's (held to {tol:.3e})")
        ids_equal = all(torch.equal(a.cpu(), b.to(a.dtype)) for a, b in
                        zip(card["ids"], cpu["ids"]))
        check(ids_equal, f"phase 14 (a) {arch}: greedy ids differ")
        cache_err, n_pos = 0.0, 0
        for key in ("prefill_cache", "cache"):
            for a, b in zip(M.tree_leaves(card[key]), M.tree_leaves(cpu[key])):
                if a.dtype in (torch.int32, torch.int64):
                    check(torch.equal(a.cpu(), b),
                          f"phase 14 (a) {arch}: cache positions differ")
                    n_pos += 1
                else:
                    cache_err = max(cache_err, p14_err(torch, a, b))
        check(cache_err <= tol, f"phase 14 (a) {arch}: cache state "
              f"{cache_err:.3e} from the CPU's (held to {tol:.3e})")
        worst[arch] = max(errs)
        print(f"phase 14 (a) {arch}: {cfg.num_layers} layer(s) at d "
              f"{cfg.d_model}, {cfg.total_params() / 1e9:.2f}B params; "
              f"prefill {P14_BATCH}x{P14_PROMPT} + {P14_STEPS} decode steps: "
              f"logits within {max(errs):.2e} of the CPU's (held to "
              f"{tol:.1e}; own spread {spread:.1e}), cache states "
              f"{cache_err:.2e}, {n_pos} position leaves and the greedy ids "
              f"equal ({time.perf_counter() - t0:.1f}s)")
        del card, cpu
        torch.cuda.empty_cache()
    return worst


def p14_rms(got, want) -> float:
    """Root mean square of ``got - want`` over every tensor of the lists."""
    sq = sum(float((g.double().cpu() - w.double().cpu()).pow(2).sum())
             for g, w in zip(got, want))
    return (sq / sum(w.numel() for w in want)) ** 0.5


def p14_attention(torch, M, cfg, cpu_params, x):
    """The first block's attention on the CPU's bf16 rotated q, k and v of
    ``x``: a function of the device that returns its output there."""
    from repro_torch.models.transformer import blocks as TB
    from repro_torch.models.transformer.attention import dot_attention
    from repro_torch.models.transformer.rope import (rope_angles,
                                                     rope_cos_sin, rotate)
    from repro_torch.models.transformer.xlstm import rms_norm
    B, T = x.shape[:2]
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    bp = M.tree_map(lambda a: a[0], cpu_params["seg0"]["b0"])
    q, k, v = TB._qkv(bp, rms_norm(x, bp["ln1"], cfg.norm_eps), cfg)
    cos, sin = rope_cos_sin(rope_angles(pos, cfg.head_dim, cfg.rope_theta,
                                        cfg.mrope_sections), x.dtype)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    window = TB.block_window(cfg, cfg.pattern[0])
    return lambda dev: dot_attention(
        q.to(dev), k.to(dev), v.to(dev), pos.to(dev), pos.to(dev),
        causal=True, window=window, q_chunk=cfg.q_chunk).cpu()


def phase14_bf16_units(torch, np):
    """(a) in bfloat16: ``P14_BF16_ARCHS`` one unit deep at published
    widths, the card against the port's CPU path on the same weights
    (the CPU path ``tests/test_torch_lm_bf16.py`` holds to the
    reference's own bf16 run): the first block's attention on the CPU's
    bf16 q, k and v, ``P14_ATTN_EQUAL`` of its bf16 outputs bit for bit;
    the logits of prefill and ``P14_BF16_STEPS`` decode steps (the CPU
    fed the card's ids), their rms distance within ``P14_BF16_TOL`` of
    the CPU's bf16-vs-float32 one.  The card with its scores rounded to
    bf16 (the control) is shown past both.  (A whole block matches only
    ~69% bit for bit at these widths: a product whose sum differs by an
    ulp of float32 rounds another way, and the block's later roundings
    follow.)"""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    for i, arch in enumerate(P14_BF16_ARCHS):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(p14_unit(get_arch(arch)), dtype="bfloat16")
        params = p14_params(torch, M, cfg, 150 + i, torch.float32)
        batch = p14_inputs(torch, np, cfg, P14_BATCH, P14_PROMPT, "cuda")
        steps = P14_BF16_STEPS
        card = p14_prefill_decode(torch, M, L, cfg, params, batch, steps)
        feed = list(card["ids"])
        cpu_params = M.tree_map(lambda a: a.cpu(), params)
        attention = p14_attention(torch, M, cfg, cpu_params, M.embed_inputs(
            cpu_params, cfg, batch["tokens"].cpu(), None)[0])
        attn = attention("cuda")
        with p14_bf16_scores(torch) as hits:
            ctrl = p14_prefill_decode(torch, M, L, cfg, params, batch,
                                      steps, feed=feed)
            attn_c = attention("cuda")
        del params
        torch.cuda.empty_cache()
        host = {k: v.cpu() for k, v in batch.items()}
        feed = [t.cpu() for t in feed]
        cpu = p14_prefill_decode(torch, M, L, cfg, cpu_params, host, steps,
                                 feed=feed)
        f32 = p14_prefill_decode(torch, M, L, dataclasses.replace(
            cfg, dtype="float32"), cpu_params, host, steps, feed=feed)
        want = attention("cpu")
        del cpu_params, attention
        share, share_c = (float((a == want).float().mean())
                          for a in (attn, attn_c))
        logits = lambda r: [r["prefill"]] + r["decode"]  # noqa: E731
        dist = p14_rms(logits(cpu), logits(f32))
        r = p14_rms(logits(card), logits(cpu)) / dist
        r_c = p14_rms(logits(ctrl), logits(cpu)) / dist
        check(bool(hits) and share >= P14_ATTN_EQUAL > share_c and
              r <= P14_BF16_TOL < r_c and all(
                  bool(torch.isfinite(x).all()) for x in logits(card)),
              f"phase 14 (a) {arch} bf16: the attention's outputs "
              f"{share:.4f} equal to the CPU's (held to {P14_ATTN_EQUAL}), "
              f"the control's {share_c:.4f}; the logits {r:.4f} of the "
              f"CPU's bf16-float32 distance {dist:.3e} from the CPU (held "
              f"to {P14_BF16_TOL}), the control's {r_c:.4f} (each held "
              f"past the bound)")
        print(f"phase 14 (a) {arch} bf16: one unit, the first attention's "
              f"bf16 outputs {share:.4f} equal to the CPU's (held to "
              f"{P14_ATTN_EQUAL}; the bf16-scores control {share_c:.4f}); "
              f"prefill {P14_BATCH}x{P14_PROMPT} + {steps} decode steps: "
              f"the logits {r:.4f} of the CPU's bf16-float32 rms distance "
              f"({dist:.3e}) from the CPU's bf16 (held to {P14_BF16_TOL}; "
              f"the control {r_c:.4f}) ({time.perf_counter() - t0:.1f}s)")
        del card, ctrl, cpu, f32
        torch.cuda.empty_cache()


def phase14_wide(torch, np):
    """(a) command-r-plus-104b, one unit (its tied 256,000 x 12,288
    embedding is 12.6 GB in float32) on the card alone: finite, and
    prefill-then-decode equal to the prompt replayed through decode."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    t0 = time.perf_counter()
    cfg = p14_unit(get_arch(P14_WIDE))
    params = p14_params(torch, M, cfg, 149, torch.float32)
    batch = p14_inputs(torch, np, cfg, P14_BATCH, P14_PROMPT, "cuda")
    run = p14_prefill_decode(torch, M, L, cfg, params, batch, P14_STEPS)
    check(all(bool(torch.isfinite(x).all())
              for x in [run["prefill"]] + run["decode"]),
          f"phase 14 (a) {P14_WIDE}: non-finite logits")
    serve = L.make_serve_step(cfg)
    cache = M.init_cache(cfg, P14_BATCH, P14_PROMPT, device="cuda")
    for t in range(P14_PROMPT):
        _, lg, cache = serve(params, cache, batch["tokens"][:, t:t + 1], t)
    err = p14_err(torch, run["prefill"], lg)
    check(err <= TOL, f"phase 14 (a) {P14_WIDE}: prefill {err:.3e} from "
          f"the replay")
    print(f"phase 14 (a) {P14_WIDE}: one unit at d {cfg.d_model}, "
          f"{cfg.total_params() / 1e9:.2f}B params, on the card: finite; "
          f"prefill within {err:.2e} of the replay "
          f"({time.perf_counter() - t0:.1f}s)")
    del params, run, cache
    torch.cuda.empty_cache()


def p14_float32(torch, M, L, cfg, params, batch, steps, feed=None):
    """``p14_prefill_decode`` of the same weights widened to float32 (the
    products in float32, TF32 off): the witness of a bfloat16 run."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = M.tree_map(lambda a: a.float(), params)
    run = p14_prefill_decode(torch, M, L, cfg32, p32, batch, steps, feed)
    del p32
    torch.cuda.empty_cache()
    return run


def p14_witness(torch, got, want, witness):
    """The bfloat16 prefill's logits ``got`` and the replay's ``want``
    against a float32 ``witness``: (max |got - want|, max |got -
    witness|, max |want - witness|, whether the reference test's atol =
    rtol = 2e-2 holds between the two)."""
    g, w, x = got.float(), want.float(), witness.float()
    d = (g - w).abs()
    return (float(d.max()), float((g - x).abs().max()),
            float((w - x).abs().max()),
            bool((d <= P14_ATOL + P14_RTOL * w.abs()).all()))


@contextlib.contextmanager
def p14_bf16_scores(torch):
    """The control: attention scores rounded to bfloat16 (``dot_attention``'s
    q.k product), a fault (a) in bf16 must catch; (b) and (c) print how
    far it lands from their float32 runs.  Yields a list that counts the
    rounded products."""
    einsum, hits = torch.einsum, []

    def rounded(eq, *ops):
        out = einsum(eq, *ops)
        if eq == "btkgd,bskd->btkgs":
            hits.append(1)
            return out.bfloat16().float()
        return out
    torch.einsum = rounded
    try:
        yield hits
    finally:
        torch.einsum = einsum


def p14_held(what, e_p, e_r):
    """The prefill path's and the replay's max distances from the float32
    run (``e_p``, ``e_r``), each within twice the other's and within
    ``P14_LIMIT``."""
    check(max(e_p, e_r) <= 2 * min(e_p, e_r) and max(e_p, e_r) <= P14_LIMIT,
          f"{what}: from the float32 run the prefill path {e_p:.4e}, the "
          f"replay {e_r:.4e} (each held to twice the other and to "
          f"{P14_LIMIT})")


class P14Replay:
    """Single-token decode captured once in a CUDA graph and replayed with
    new tokens and positions (the cache updated in place): the long
    prompt replays of (b) and (c), which are checks, not the timed path.
    The cache must start empty (the warm-up writes at position 0, which
    the first step overwrites) and hold attention layers only."""

    def __init__(self, torch, M, cfg, params, cache, batch):
        self.torch = torch
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
        self.pos = torch.zeros((batch,), dtype=torch.long, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(2):
                M.decode_step(params, cfg, cache, self.tok, self.pos)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread-local: the host thread of phase 14 (a) and 15 (a) may run
        # CPU work while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"
                              ), torch.no_grad():
            self.logits, _ = M.decode_step(params, cfg, cache, self.tok,
                                           self.pos)

    def __call__(self, tok, pos):
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits


def p14_alone(torch, M, cfg, params, reqs, rows, cache_len):
    """Each request decoded greedily on its own, in waves of ``rows``
    independent rows at one position (no scheduler: no admission, no slot
    reuse; each request in another row than its slot), at the
    scheduler's batch shape so the card's products take the same
    kernels, through ``P14Replay``: {rid: ids}."""
    out = {}
    for w in range(0, len(reqs), rows):
        wave = reqs[w:w + rows][::-1]
        cache = M.init_cache(cfg, rows, cache_len, device="cuda")
        step = P14Replay(torch, M, cfg, params, cache, rows)
        gen = [[] for _ in wave]
        steps = max(len(r.prompt) + r.max_tokens - 1 for r in wave)
        tok = torch.zeros((rows, 1), dtype=torch.long)
        for s in range(steps):
            for i, r in enumerate(wave):
                seq = list(r.prompt) + gen[i]
                tok[i, 0] = seq[min(s, len(seq) - 1)]
            nxt = torch.argmax(step(tok.to("cuda"), s)[:, -1], -1).cpu()
            for i, r in enumerate(wave):
                if s >= len(r.prompt) - 1 and len(gen[i]) < r.max_tokens:
                    gen[i].append(int(nxt[i]))
        out.update({r.rid: g for r, g in zip(wave, gen)})
        del step, cache
    return out


def phase14_main(torch, np, card):
    """(b) minitron-4b at full width and depth in bfloat16: prefill 4 x
    2,048 and 64 decode steps through ``make_prefill_step`` /
    ``make_serve_step``, the prefill's last logits held to the prompt
    replayed through decode; then ``BatchScheduler`` (8 slots, 16
    requests, slots reused) held to each request decoded alone.  The LM
    path launches none of the GNN kernels (counts 0 before, 0 after)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.serve.scheduler import BatchScheduler, Request
    from repro_torch.train import lm_trainer as L
    cfg = get_arch(P14_MAIN)
    params = p14_params(torch, M, cfg, 14, torch.bfloat16)
    nparams = sum(t.numel() for t in M.tree_leaves(params))
    B, T = P14_MAIN_BATCH, P14_MAIN_PROMPT
    batch = p14_inputs(torch, np, cfg, B, T, "cuda")
    prefill, serve = L.make_prefill_step(cfg), L.make_serve_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    prefill(params, batch)                     # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = M.init_cache(cfg, B, T + P14_MAIN_DECODE, device="cuda")
    for si, seg in enumerate(caches):          # the prompt's KV, then room
        M.tree_map(lambda d, s: d[:, :, :s.shape[2]].copy_(s),
                   cache[si], seg)
    del caches
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    ids = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(P14_MAIN_DECODE - 1):
        tok, lg, cache = serve(params, cache, tok.long(), T + i)
        ids.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_launches()
    check(not any(launches.values()),
          f"phase 14 (b): the LM path launched GNN kernels: {launches}")
    ids = torch.cat(ids, 1)
    check(bool(torch.isfinite(lg).all()) and ids.shape == (
        B, P14_MAIN_DECODE) and bool(((ids >= 0) & (ids < cfg.vocab_size))
                                     .all()), "phase 14 (b): decode output")
    peak = torch.cuda.max_memory_allocated()
    # where a step's time goes: one traced decode step and one prefill
    from repro_torch import obs
    for name, fn in (("decode", lambda: serve(params, cache, tok.long(),
                                              T + P14_MAIN_DECODE - 1)),
                     ("prefill", lambda: prefill(params, batch))):
        with obs.DeviceTrace("cuda") as tr:
            fn()
        sm = tr.summary()
        top = ", ".join(f"{t['name'][:40]} {t['device_us'] / 1e3:.2f} ms"
                        for t in sm["top"][:3])
        print(f"phase 14 (b) traced {name}: wall {sm['wall_us'] / 1e3:.2f} "
              f"ms, device busy {sm['busy_us'] / 1e3:.2f} ms "
              f"({100 * sm['busy_share']:.1f}%), "
              f"{sum(st['kernels'] for st in sm['streams'].values())} "
              f"kernels; top: {top}")
    del cache
    print(f"phase 14 (b) {P14_MAIN}: {cfg.num_layers} layers, "
          f"{nparams / 1e9:.2f}B params in bfloat16; prefill {B}x{T}: "
          f"{prefill_s * 1e3:.1f} ms ({B * T / prefill_s:.0f} tokens/s); "
          f"decode {P14_MAIN_DECODE - 1} steps at batch {B}: "
          f"{decode_s * 1e3 / (P14_MAIN_DECODE - 1):.2f} ms/step "
          f"({B * (P14_MAIN_DECODE - 1) / decode_s:.1f} tokens/s); peak "
          f"{peak / 2 ** 30:.2f} GiB; GNN kernel launches 0 [{card}]")
    # the prefill's last logits against the prompt replayed through
    # decode, both against a float32 run of the same weights
    t0 = time.perf_counter()
    cache = M.init_cache(cfg, B, T, device="cuda")
    step = P14Replay(torch, M, cfg, params, cache, B)
    for t in range(T):
        lg = step(batch["tokens"][:, t:t + 1], t)
    lg = lg.clone()
    del step, cache
    witness = p14_float32(torch, M, L, cfg, params, batch, 0)["prefill"]
    with p14_bf16_scores(torch) as hits:
        control = prefill(params, batch)[0]
    d, e_p, e_r, allclose = p14_witness(torch, logits, lg, witness)
    e_c = float((control.float() - witness.float()).abs().max())
    rms = [float((x.float() - witness.float()).pow(2).mean().sqrt())
           for x in (logits, lg, control)]
    check(bool(hits), "phase 14 (b): the control rounded no scores")
    p14_held("phase 14 (b)", e_p, e_r)
    print(f"phase 14 (b): the prefill's last logits within {d:.4e} of the "
          f"{T}-step replay ({'within' if allclose else 'past'} the "
          f"reference test's atol = rtol = 2e-2); max |x - float32 run| "
          f"of the same weights: the prefill {e_p:.4e}, the replay "
          f"{e_r:.4e} (held to {P14_LIMIT}), the bf16-scores control "
          f"{e_c:.4e}; rms {rms[0]:.4e}, {rms[1]:.4e}, {rms[2]:.4e} "
          f"({time.perf_counter() - t0:.1f}s)")
    del control
    # the scheduler: 16 requests through 8 slots
    rng = np.random.default_rng(15)
    specs = [(i, rng.integers(0, cfg.vocab_size,
                              int(rng.integers(*P14_REQ_PROMPT))).tolist())
             for i in range(P14_REQUESTS)]
    reqs = [Request(rid=i, prompt=p, max_tokens=P14_REQ_NEW)
            for i, p in specs]
    sched = BatchScheduler(cfg, params, P14_SLOTS, P14_CACHE, device="cuda")
    reused = []
    admit = sched._admit

    def counted_admit():
        before = [r.rid if r else None for r in sched.slot_req]
        admit()
        reused.extend(r.rid for s, r in enumerate(sched.slot_req)
                      if r is not None and before[s] is None
                      and r.rid >= P14_SLOTS)
    sched._admit = counted_admit
    for r in reqs:
        sched.submit(r)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = sched.run()
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    check(not any(read_launches().values()),
          "phase 14 (b): the scheduler launched GNN kernels")
    tokens = sum(len(r.generated) for r in reqs)
    check(all(r.done and len(r.generated) == P14_REQ_NEW for r in reqs)
          and len(reused) >= 8, f"phase 14 (b): scheduler finished "
          f"{sum(r.done for r in reqs)} requests, {len(reused)} reused a slot")
    t0 = time.perf_counter()
    alone = p14_alone(torch, M, cfg, params, reqs, P14_SLOTS, P14_CACHE)
    same = sum(alone[r.rid] == r.generated for r in reqs)
    check(same == len(reqs), f"phase 14 (b): {len(reqs) - same} requests' "
          f"ids differ from their decode alone")
    print(f"phase 14 (b) scheduler: {P14_REQUESTS} requests (prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, {P14_REQ_NEW} new "
          f"each) through {P14_SLOTS} slots, cache {P14_CACHE}: {steps} "
          f"steps, {tokens} tokens in {sched_s:.2f}s ({tokens / sched_s:.1f} "
          f"tokens/s, {sched_s * 1e3 / steps:.2f} ms/step); {len(reused)} "
          f"requests reused a slot; every request's ids equal to its "
          f"decode alone ({time.perf_counter() - t0:.1f}s) [{card}]")
    del params, logits
    torch.cuda.empty_cache()


def phase14_swa(torch, np, card):
    """(c) h2o-danube-3-4b at full depth in bfloat16: a 6,144-token
    prompt past the 4,096 window (the ring caches keep the trailing
    window, rolled to slot p % 4096) and 16 decode steps, against the
    same tokens decoded through the cache from empty, both held to a
    float32 run of the same weights fed the same ids."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    t0 = time.perf_counter()
    cfg = get_arch(P14_SWA)
    W, T = cfg.sliding_window, P14_SWA_PROMPT
    params = p14_params(torch, M, cfg, 16, torch.bfloat16)
    batch = p14_inputs(torch, np, cfg, 1, T, "cuda")
    run = p14_prefill_decode(torch, M, L, cfg, params, batch, P14_SWA_DECODE)
    pos = run["prefill_cache"][0]["b0"]["kv"].pos
    check(pos.shape[-1] == W and bool((pos % W == torch.arange(
        W, device="cuda")).all()) and int(pos.min()) == T - W,
        "phase 14 (c): the prefill's ring cache is not the rolled window")
    cache = M.init_cache(cfg, 1, T + P14_SWA_DECODE, device="cuda")
    step = P14Replay(torch, M, cfg, params, cache, 1)
    for t in range(T):
        lg = step(batch["tokens"][:, t:t + 1], t)
    replay = [lg.clone()]
    for i in range(P14_SWA_DECODE):
        replay.append(step(run["ids"][i], T + i).clone())
    del step, cache
    wit = p14_float32(torch, M, L, cfg, params, batch, P14_SWA_DECODE,
                      feed=run["ids"])
    with p14_bf16_scores(torch) as hits:
        control = p14_prefill_decode(torch, M, L, cfg, params, batch,
                                     P14_SWA_DECODE, feed=run["ids"])
    res = [p14_witness(torch, g, r, w) for g, r, w in zip(
        [run["prefill"]] + run["decode"], replay,
        [wit["prefill"]] + wit["decode"])]
    d, e_p, e_r = (max(r[i] for r in res) for i in range(3))
    e_c = max(float((c.float() - w.float()).abs().max()) for c, w in zip(
        [control["prefill"]] + control["decode"],
        [wit["prefill"]] + wit["decode"]))
    check(bool(hits), "phase 14 (c): the control rounded no scores")
    p14_held("phase 14 (c)", e_p, e_r)
    print(f"phase 14 (c) {P14_SWA}: {cfg.num_layers} layers, window {W}, "
          f"bfloat16; prefill 1x{T} (the ring rolled) + {P14_SWA_DECODE} "
          f"decode steps: logits within {d:.4e} of the {T}-token replay "
          f"through the cache ({sum(r[3] for r in res)} of {len(res)} "
          f"within the reference test's atol = rtol = 2e-2); max |x - "
          f"float32 run|: the prefill path {e_p:.4e}, the replay "
          f"{e_r:.4e} (held to {P14_LIMIT}), the bf16-scores control "
          f"{e_c:.4e} ({time.perf_counter() - t0:.1f}s) [{card}]")
    del control
    del params, run, wit
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 15: LM training
# ---------------------------------------------------------------------------
P15_ARCHS = ("minitron-4b", "mixtral-8x7b")   # (a): phase 14 (a)'s weights
P15_LR = 3e-4                       # the reference launcher's
P15_DIR = os.path.join(ROOT, "build", "phase15")
P15_LAUNCH = ("minitron-4b", "mixtral-8x7b")  # (c), at the defaults
P15_EXAMPLE_CPU_STEPS = 3           # (b): the example on the CPU
P15_EXAMPLE_STOP = "AssertionError: loss must decrease"


def p15_step(torch, cfg, params, batch):
    """One train step of ``make_train_step`` (Adam at ``P15_LR``) in place
    on ``params``: (loss, grad_norm, the gradient leaves Adam was given)."""
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    from repro_torch.train import optimizer as O
    seen = {}
    real = O.adam_update

    def spy(grads, state, leaves, opt_cfg):
        seen["grads"] = list(grads)       # Adam reads them, never writes
        return real(grads, state, leaves, opt_cfg)
    O.adam_update = spy
    try:
        opt = O.adam_init(M.tree_leaves(params))
        _, _, m = L.make_train_step(cfg, O.AdamConfig(lr=P15_LR))(
            params, opt, batch)
    finally:
        O.adam_update = real
    return float(m["loss"]), float(m["grad_norm"]), seen["grads"]


def p15_errs(torch, got, want):
    """(max |got - want| / max(1, |want|) elementwise, |got - want| /
    |want| in norm) of two float32 tensors on the host."""
    d = (got - want).abs_()
    elem = float((d / want.abs().clamp_min(1.0)).max()) if d.numel() else 0.0
    norm = float(d.norm() / want.norm().clamp_min(1e-30))
    return elem, norm


def p15_adam_arith(torch, init, card_grads, card_params):
    """The CPU's ``adam_update`` from the initial weights ``init`` on the
    card's own gradients, leaf by leaf (no clip: each leaf's step is its
    own), against the card's parameters after its step: max ``|card -
    cpu| / max(1, |cpu|)``."""
    from repro_torch.train import optimizer as O
    cfg = O.AdamConfig(lr=P15_LR)
    err = 0.0
    for p0, g, pc in zip(init, card_grads, card_params):
        q = p0.clone()
        O.adam_update([g], O.adam_init([q]), [q], cfg)
        err = max(err, p15_errs(torch, pc, q)[0])
    return err


def p15_step_check(torch, card_grads, card_params, cpu_grads, cpu_params):
    """The card's whole step against the CPU's: max ``|card - cpu| /
    max(1, |cpu|)`` of the parameters, and how far ``|card - cpu|`` passes
    ``TOL * max(1, |cpu|) + lr * |u(g_card) - u(g_cpu)|``, ``u(g) = g /
    (|g| + eps)`` being Adam's first update: a gradient entry at float32
    noise (|g| near eps) moves its parameter by up to 2 lr on either
    device, and its two devices' gradients say by how much."""
    from repro_torch.train import optimizer as O
    cfg = O.AdamConfig(lr=P15_LR)
    p_err, excess = 0.0, float("-inf")
    for gc, pc, gp, pp in zip(card_grads, card_params, cpu_grads,
                              cpu_params):
        d = (pc - pp).abs_()
        p_err = max(p_err, float((d / pp.abs().clamp_min(1.0)).max()))
        u = (gc / (gc.abs() + cfg.eps) - gp / (gp.abs() + cfg.eps)).abs_()
        allow = pp.abs().clamp_min(1.0).mul_(TOL).add_(u.mul_(cfg.lr))
        excess = max(excess, float((d - allow).max()))
    return p_err, excess


def phase15_units(torch, np):
    """(a), in the CPU worker: minitron-4b and mixtral-8x7b one unit deep
    at published widths (``p14_unit``, phase 14 (a)'s weights: the same
    ``torch.Generator`` seeds), float32, ``cfg.remat`` on as published,
    2 x 32 tokens: one train step with remat on the card; from the same
    weights the step without remat on the card (bit for bit with the
    remat step, or within 1e-6, printed) and the step on the CPU (loss
    and gradient norm within 1e-4 * max(1, |x|), each gradient leaf
    within 1e-4 relative in norm); the card's parameters after Adam
    within 1e-4 * max(1, |x|) of the CPU's Adam on the card's own
    gradients (:func:`p15_adam_arith`), and of the CPU's step as
    :func:`p15_step_check` holds them; the remat step's peak memory."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    for arch in P15_ARCHS:
        t0 = time.perf_counter()
        cfg = p14_unit(get_arch(arch))
        check(cfg.remat, f"phase 15 (a) {arch}: the published config has "
              f"no remat")
        seed = 140 + P14_UNIT_ARCHS.index(arch)
        params = p14_params(torch, M, cfg, seed, torch.float32)
        host = M.tree_map(lambda a: a.to("cpu", copy=True), params)
        batch = p14_inputs(torch, np, cfg, P14_BATCH, P14_PROMPT, "cuda")
        batch["labels"] = torch.roll(batch["tokens"], -1, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        s0 = time.perf_counter()
        loss, gnorm, grads = p15_step(torch, cfg, params, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - s0
        peak = torch.cuda.max_memory_allocated()
        n = len(grads)
        # the card's gradients and new parameters go to the host
        card = [g.to("cpu") for g in grads] + [
            a.to("cpu") for a in M.tree_leaves(params)]
        del params, grads
        torch.cuda.empty_cache()
        # the card's step without remat from the same weights
        plain = M.tree_map(lambda a: a.to("cuda", copy=True), host)
        p_loss, p_gnorm, p_grads = p15_step(
            torch, dc.replace(cfg, remat=False), plain, batch)
        pairs = list(zip(card, p_grads + M.tree_leaves(plain)))
        same = (loss == p_loss and gnorm == p_gnorm
                and all(torch.equal(a.to("cuda"), b) for a, b in pairs))
        gap = 0.0 if same else max(p15_errs(torch, b.cpu(), a)[0]
                                   for a, b in pairs)
        del plain, p_grads, pairs
        torch.cuda.empty_cache()
        check(same or (abs(loss - p_loss) <= 1e-6 * max(1, abs(p_loss))
                       and gap <= 1e-6),
              f"phase 15 (a) {arch}: remat on and off part by {gap:.3e}")
        a_err = p15_adam_arith(torch, M.tree_leaves(host), card[:n],
                               card[n:])
        # the CPU's step from the same weights (in place on the host copy)
        c0 = time.perf_counter()
        c_loss, c_gnorm, c_grads = p15_step(
            torch, cfg, host, {k: v.cpu() for k, v in batch.items()})
        cpu_s = time.perf_counter() - c0
        for what, a, b in (("loss", loss, c_loss),
                           ("grad norm", gnorm, c_gnorm)):
            check(abs(a - b) <= TOL * max(1.0, abs(b)),
                  f"phase 15 (a) {arch}: {what} card {a} vs CPU {b}")
        g_err = max(p15_errs(torch, a, b)[1] for a, b in
                    zip(card[:n], c_grads))
        check(g_err <= TOL, f"phase 15 (a) {arch}: a gradient leaf is "
              f"{g_err:.3e} relative from the CPU's")
        p_err, excess = p15_step_check(torch, card[:n], card[n:], c_grads,
                                       M.tree_leaves(host))
        check(a_err <= TOL and excess <= 0.0, f"phase 15 (a) {arch}: the "
              f"parameters after Adam are {a_err:.3e} from the CPU's Adam "
              f"on the card's gradients and {p_err:.3e} from the CPU's "
              f"step ({excess:.3e} past 1e-4 * max(1, |x|) and the "
              f"gradients' own difference through Adam's normalisation)")
        print(f"phase 15 (a) {arch}: one unit ({cfg.num_layers} layer(s), d "
              f"{cfg.d_model}, vocab {cfg.vocab_size:,}), "
              f"{sum(a.numel() for a in card[n:]) / 1e9:.2f}B params, "
              f"float32, remat on, batch {P14_BATCH} x {P14_PROMPT}: card "
              f"vs CPU: loss {loss:.6f} vs {c_loss:.6f}, grad norm "
              f"{gnorm:.6f} vs {c_gnorm:.6f}; {n} gradient leaves within "
              f"{g_err:.2e} relative in norm; the parameters after Adam (lr "
              f"{P15_LR}) within {a_err:.2e} of the CPU's Adam on the "
              f"card's gradients and {p_err:.2e} of the CPU's step (held to "
              f"{TOL:.0e} * max(1, |x|) plus the gradients' own difference "
              f"through Adam's normalisation); the card's step without "
              f"remat " + ("bit for bit" if same else f"within {gap:.2e}")
              + f"; card step {step_s:.2f} s (host clock, the first), peak "
              f"{(peak - base) / 2 ** 30:.2f} GiB above the weights' "
              f"{base / 2 ** 30:.2f} GiB; CPU step {cpu_s:.1f} s "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        del card, host, c_grads


def p15_popen(args, device):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable] + args + ["--device", device],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    CHILDREN.append(proc)
    return proc


def phase15_start_cpu_runs():
    """(b) and (c)'s CPU runs, each a process of its own, started before
    the card's: the example at ``--steps 3`` and the launcher at the
    reference's defaults, both ``--device cpu``."""
    procs = {"example": p15_popen(
        [os.path.join(ROOT, "examples", "torch_train_lm.py"), "--steps",
         str(P15_EXAMPLE_CPU_STEPS)], "cpu")}
    for arch in P15_LAUNCH:
        procs[arch] = p15_popen(["-m", "repro_torch.launch.train", "lm",
                                 "--arch", arch], "cpu")
    return procs


def p15_wait(procs, timeout=600):
    try:
        return {k: p.communicate(timeout=timeout)[0] for k, p in
                procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def phase15_entry(torch, card, cpu_procs):
    """(b) ``examples/torch_train_lm.py`` at its defaults (200 steps, batch
    8, seq 256) in a process of its own on the card: exit 0, the loss
    falls, tokens/s beside the card's name; its lines at steps 0 (and the
    parameter count) those of the CPU's 3-step run under
    :func:`same_report`.  (c) ``launch/train.py lm --arch <a>`` at the
    reference's defaults on the card in this process, with ``--trace-out``
    under ``build/phase15/``, every GNN kernel's count 0 before and after,
    the trace valid, and its lines those of the CPU's run."""
    from repro_torch import obs
    from repro_torch.launch import train
    from repro_torch.models.transformer import model as M
    os.makedirs(P15_DIR, exist_ok=True)
    card_ex = p15_popen([os.path.join(ROOT, "examples",
                                      "torch_train_lm.py")], "cuda")
    lines = {}
    for arch in P15_LAUNCH:
        trace = os.path.join(P15_DIR, f"lm_{arch}.json")
        zero_launches()
        check(not any(read_launches().values()), "phase 15 (c): counts")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = train.run_lm(train.parse_args(
                ["lm", "--arch", arch, "--trace-out", trace]))
        launched = {k: v for k, v in read_launches().items() if v}
        check(not launched, f"phase 15 (c) {arch}: GNN kernels launched "
              f"{launched}")
        with open(trace) as f:
            spans = obs.validate_chrome_trace(json.load(f))
        lines[arch] = buf.getvalue().splitlines()
        busy = [ln for ln in lines[arch] if ln.startswith("device:")]
        print(f"phase 15 (c) {arch}: {len(lines[arch])} lines, last "
              f"{[ln for ln in lines[arch] if 'steps in' in ln]}, trace "
              f"valid ({spans} spans); {busy[:1]} [{card}]")
        check(all(bool(torch.isfinite(p).all()) for p in
                  M.tree_leaves(res["params"])),
              f"phase 15 (c) {arch}: parameters not finite")
    procs = {**cpu_procs, "card_example": card_ex}
    outs = p15_wait(procs)
    for key, p in procs.items():
        # at 3 steps the loss has not fallen yet: the CPU's example ends at
        # its own assertion, as the reference's example does there
        check(p.returncode == 0 or (key == "example" and outs[key].rstrip()
                                    .endswith(P15_EXAMPLE_STOP)),
              f"phase 15: {key} exited {p.returncode}:\n"
              f"{outs[key][-2000:]}")
    for arch in P15_LAUNCH:
        got = [ln for ln in lines[arch] if ln.startswith("step ")]
        want = [ln for ln in outs[arch].splitlines()
                if ln.startswith("step ")]
        check(len(got) == len(want) > 0 and all(
            same_report(a, b) for a, b in zip(got, want)),
            f"phase 15 (c) {arch}: the card printed\n" + "\n".join(got)
            + "\nand the CPU\n" + "\n".join(want))
    cut = lambda ln: ln.split(" (")[0]  # noqa: E731
    ex = outs["card_example"].splitlines()
    ex_cpu = outs["example"].splitlines()
    check(any(ln.startswith("loss ") for ln in ex) and "tok/s on " + (
        torch.cuda.get_device_name(0)) in "\n".join(ex),
        f"phase 15 (b): the example printed\n" + "\n".join(ex[-5:]))
    check(all(same_report(cut(a), cut(b)) for a, b in zip(ex[:2],
                                                          ex_cpu[:2])),
          f"phase 15 (b): the card's first lines\n" + "\n".join(ex[:2])
          + "\nare not the CPU's\n" + "\n".join(ex_cpu[:2]))
    for ln in ex[:2] + ex[-2:]:
        print(f"phase 15 (b) torch_train_lm: {ln}")
    print(f"phase 15 (b): the card's parameter count and step-0 line are "
          f"the CPU's ({P15_EXAMPLE_CPU_STEPS}-step run, exit "
          f"{procs['example'].returncode}: {ex_cpu[-1]!r}); "
          f"(c): the launcher's step lines on the card are the CPU's "
          f"(integers equal, each decimal within 2% or two units of its "
          f"last digit) [{card}]")


def summarize(name, rows, launches, weights, ms_over, max_abs_err=0.0):
    """One contract row: per-launch means over the timed shapes, shape i
    standing for ``weights[i]`` launches of the main paths."""
    w = sum(weights)
    for r, n in zip(rows, weights):
        r["launches_represented"] = n

    def mean(key):
        return sum(r[key] * n for r, n in zip(rows, weights)) / w
    worst = max(zip(rows, weights), key=lambda rn: rn[0]["bound_ms"] * rn[1])
    lib = [r.get("library_ms") for r in rows]
    extra = {"bound_ffma_ms": mean("bound_ffma_ms")} \
        if all("bound_ffma_ms" in r for r in rows) else {}
    return {"name": name, **KERNEL_ROWS[name], **extra,
            "launches": launches[name],
            "max_abs_err": max([max_abs_err] + [r["max_abs_err"]
                                                for r in rows]),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": worst[0]["bound_by"],
            "library_ms": None if None in lib else mean("library_ms"),
            "ms_over": ms_over,
            "shapes": rows}


def main(argv=None) -> int:
    start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args(argv)

    import atexit

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    atexit.register(stop_children)
    from repro_torch.kernels import _build
    from repro_torch.launch.gnn_serve import model_config
    from repro_torch.models.gnn.graphsage import GraphSAGE
    from repro_torch.graph import partition_graph, synthetic_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card} (every time below was taken on it); bounds on "
          f"the data sheet's HBM {PEAK_BYTES_PER_S:.3g} B/s, FP32 "
          f"{PEAK_FP32_FLOPS:.3g} and TF32 {PEAK_TF32_FLOPS:.3g} FLOP/s")

    t0 = time.perf_counter()
    _build.build(KERNELS)
    build_s = round(time.perf_counter() - t0, 1)
    print(f"build: {len(KERNELS)} sources in {build_s:.1f}s")
    # the CPU halves of 4 (c) and 6 (c), and 9 (c), beside the card phases
    worker = CpuWorker().start()
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    # phases 1-3 serve: no gradient is taken
    with torch.no_grad():
        cfg = model_config("graphsage-papers100m")
        g = synthetic_graph(num_vertices=args.vertices, avg_degree=8,
                            num_classes=cfg.num_classes,
                            feat_dim=cfg.feat_dim, seed=0)
        part = partition_graph(g, 1, seed=0).parts[0]
        setup = {"device": device, "cfg": cfg, "part": part,
                 "model": GraphSAGE.from_config(cfg, seed=0, device=device),
                 "cache_size": 65536}
        with timed("phase 1"):
            rows_a, rows_b = phase1(torch, np, setup)
        with timed("phase 2"):
            phase2(torch, np, device)
        with timed("phase 3"):
            launches, launches_offline, offline_err = phase3(torch, np, args)
        del setup, g, part

    # phases 4, 6, 7 and 9 train on one graph and partition, built once
    reuse = ReuseGraphs().start()
    with timed("phase 4 (b)"):
        res, launches4 = phase4_main_path(torch, np, TRAIN_VERTICES)
    with timed("phase 4 (a)"):
        with torch.no_grad():
            rows4 = phase4_kernels(torch, np, res)
    with timed("phase 4 (c)"):
        cpu_check(torch, np, "phase 4", res, worker)()
    # phase 7 trains on phase 4's graph and data: its HEC goes before GAT
    res4 = {k: res[k] for k in ("ps", "data", "cfg", "history", "trainer")}
    ps4 = res["ps"]
    del res
    torch.cuda.empty_cache()

    with timed("phase 5"), torch.no_grad():
        launches5, rows5_g, rows5_b, microbatches5, chunks5, offline_err5 = \
            phase5(torch, np, args)
    torch.cuda.empty_cache()

    with timed("phase 6 (b)"):
        res, launches6 = phase6_main_path(torch, np, TRAIN_VERTICES)
    with timed("phase 6 (a)"):
        with torch.no_grad():
            rows6 = phase6_kernels(torch, np, res)
    res["state"] = res["data"] = None      # room for the check's own state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed("phase 6 (c) card"):
        compare6 = cpu_check(torch, np, "phase 6", res, worker)
        peak_line(torch, "phase 6 (c)")
    del res
    torch.cuda.empty_cache()
    # GAT at phase 6's 1M-entry HEC (~68 GB) next, before the CPU worker
    # takes the card for phase 9 (c)
    launches11, audit_s11 = {}, {}
    with timed("phase 11 (b)"):
        launches11["gat"], audit_s11["gat"] = phase11_train(
            torch, np, "gat", card)
    with timed("phase 12 (b)"):
        launches12b = phase12_gat(torch, np, card)
    worker.go()

    with timed("phase 7 (b)"):
        res7, launches7 = phase7_main_path(torch, np, res4)
    with timed("phase 7 (a)"):
        with torch.no_grad():
            rows7 = phase7_kernels(torch, np, res7)
    with timed("phase 7 (c)"):
        compared = phase7_check(torch, np, res7)
        print(f"phase 7 (c): {compared} arrays equal")
    del res7, res4
    torch.cuda.empty_cache()

    p8 = {}
    with torch.no_grad():
        for preset in ("graphsage-papers100m", "gat-papers100m"):
            model = preset.split("-")[0]
            tag = f"phase 8 (b) {model}"
            with timed(tag):
                res8, launches8, rec8, probes8, lookups8 = phase8_main_path(
                    torch, np, args, preset, tag)
                ANSWERS[f"sharded_{model}"] = (answers(np, res8["serve"]),
                                               answers(np, res8["repeat"]))
                ANSWERS[f"sharded_{model}_launches"] = launches8
            with timed(f"phase 8 (a) {model}"):
                rows_j, rows_b8, rows_f = phase8_kernels(
                    torch, np, res8, probes8, lookups8, f"phase 8 {model}",
                    card)
            with timed(f"phase 8 (c) {model}"):
                replay_err = phase8_replay(torch, np, res8, rec8,
                                           f"phase 8 {model}")
            cfg8, ps8 = res8["cfg"], res8["ps"]
            rounds8 = sum(res8[f"{p}_metrics"]["steps_run"]
                          for p in ("warmup", "serve", "repeat"))
            p8[model] = {
                "launches": launches8, "rows_j": rows_j, "rows_b": rows_b8,
                "rows_f": rows_f, "replay_err": replay_err,
                "rounds": rounds8,
                "online": len(ps8.parts) * cfg8.num_layers * rounds8,
                "chunks": sum(-(-p.num_solid // OFFLINE_CHUNK)
                              for p in ps8.parts)}
            del res8, rec8, probes8, lookups8
            torch.cuda.empty_cache()
        with timed("phase 8 (a, c) ragged and exactness"):
            ragged_j = phase8_ragged(torch, np, card)
            phase8_exact(torch, np)

    with timed("phase 9 (b)"):
        launches9 = phase9_main_path(torch, np, ps4, card)
    with timed("phase 10 (a, b, d, e)"):
        launches10 = phase10_main_path(torch, np, card)
    with timed("phase 11 (a)"):
        launches11["graphsage"], audit_s11["graphsage"] = phase11_train(
            torch, np, "graphsage", card)
    with timed("phase 12 (a)"):
        launches12a = phase12_train(torch, np, card)
    reuse.stop()
    del ps4
    with timed("phase 10 (c)"):
        phase10_unstaged(torch, np)
    with timed("phase 11 (c)"):
        with torch.no_grad():
            serve11 = phase11_serve(torch, np, args, card)
    with timed("phase 11 (d)"):
        phase11_kernels(torch, np)
    with timed("phase 12 (c)"):
        with torch.no_grad():
            launches12c = phase12_serve(torch, np, args, card)
    with timed("phase 12 (0)"):
        with torch.no_grad():
            phase12_nan(torch, np)
    with timed("phase 6 (c) compare"):
        compare6()
    with timed("phase 13"):
        launches13 = phase13(torch)
    worker.go("15")             # phase 13's 47 GB are free again

    # phase 14 (a)'s float32 units and phase 15 (a) run in the CPU worker
    # (both halves); (b) and (c) of phase 15 run their CPU halves in
    # processes beside phase 14 (b) and (c)
    procs15 = phase15_start_cpu_runs()
    with timed("phase 14 (a) bf16 and wide"), torch.no_grad():
        phase14_bf16_units(torch, np)
        phase14_wide(torch, np)
    with timed("phase 14 (b)"), torch.no_grad():
        phase14_main(torch, np, card)
    with timed("phase 14 (c)"), torch.no_grad():
        phase14_swa(torch, np, card)
    with timed("phase 15 (b, c)"):
        phase15_entry(torch, card, procs15)
    with timed("CPU worker wait"):
        worker_s = worker.finish()
        print(f"the CPU worker ({', '.join(CPU_WORKER_JOBS)}): "
              f"{worker_s:.1f} s beside the card phases")

    online = [r for r in rows_a if not r["offline"]]
    offline = [r for r in rows_a if r["offline"]]
    launches_online = launches["serve_fused_layer"] - launches_offline
    check(launches_online > 0 and launches_online % len(online) == 0,
          f"phase 3: {launches_online} online serve-layer launches is not "
          f"a whole number of microbatches")
    sage8, gat8 = p8["graphsage"], p8["gat"]
    b_paths = {"serve": launches["hec_lookup"],
               "train": launches4["hec_lookup"],
               "train_hot": launches9["hot"]["hec_lookup"],
               **{f"train_pipeline_{k}": ls["hec_lookup"]
                  for k, ls in launches10.items()},
               "gat_serve": launches5["hec_lookup"],
               "gat_train": launches6["hec_lookup"],
               "sharded_serve": sage8["launches"]["hec_lookup"],
               "gat_sharded_serve": gat8["launches"]["hec_lookup"],
               "train_planes": launches11["graphsage"]["hec_lookup"],
               "gat_train_planes": launches11["gat"]["hec_lookup"],
               "serve_planes": serve11["single-rank"]["launches"][
                   "hec_lookup"],
               "sharded_serve_planes": serve11["sharded"]["launches"][
                   "hec_lookup"],
               "train_resilience": launches12a["hec_lookup"],
               "gat_train_resilience": launches12b["hec_lookup"],
               "sharded_serve_failover": launches12c["graphsage"][
                   "hec_lookup"],
               "gat_sharded_serve_failover": launches12c["gat"][
                   "hec_lookup"],
               "dryrun": launches13["dryrun"]["hec_lookup"],
               "gat_dryrun": launches13["gat_dryrun"]["hec_lookup"]}
    b_rows = [(rows4["hec_lookup"], "train_resilience"),
              (rows6["hec_lookup"], "gat_train_resilience"),
              (sage8["rows_b"], "sharded_serve_failover"),
              (gat8["rows_b"], "gat_sharded_serve_failover"),
              (rows_b, "serve"), (rows4["hec_lookup"], "train"),
              (rows4["hec_lookup"], "train_planes"),
              (rows6["hec_lookup"], "gat_train_planes"),
              (rows_b, "serve_planes"),
              (sage8["rows_b"], "sharded_serve_planes"),
              (rows4["hec_lookup"], "train_hot"),
              *[(rows4["hec_lookup"], f"train_pipeline_{k}")
                for k in launches10],
              (rows5_b, "gat_serve"), (rows6["hec_lookup"], "gat_train"),
              (sage8["rows_b"], "sharded_serve"),
              (gat8["rows_b"], "gat_sharded_serve")]
    layer_mean = ("mean over the training path's layer shapes (rank 0's "
                  "first minibatch), each layer standing for an equal "
                  "share of the launches")
    a_sharded = sage8["launches"]["serve_fused_layer"]
    a_failover = launches12c["graphsage"]["serve_fused_layer"]
    # phase 11's runs: the training audit's offline pass, and the serving
    # runs with the quality plane (their shapes are phases 3 and 8's)
    a_planes = {"train_audit": launches11["graphsage"]["serve_fused_layer"],
                "serve_planes": serve11["single-rank"]["launches"][
                    "serve_fused_layer"],
                "sharded_serve_planes": serve11["sharded"]["launches"][
                    "serve_fused_layer"]}
    rows = [
        summarize("serve_fused_layer", online + offline + sage8["rows_f"],
                  {"serve_fused_layer": launches["serve_fused_layer"]
                   + a_sharded + a_failover + sum(a_planes.values())},
                  [launches_online // len(online)] * len(online)
                  + [(launches_offline + (a_sharded - sage8["online"]))
                     / len(offline)] * len(offline)
                  + [sage8["online"] / len(sage8["rows_f"])]
                  * len(sage8["rows_f"]),
                  "launch-weighted mean over the serving paths: each online "
                  "layer shape stands for its microbatch launches, each "
                  "offline shape (first chunk) for its layer's pre-warm "
                  "chunks, single-rank and sharded, each sharded layer shape "
                  "(rank 0 of one round) for its rounds' launches",
                  max_abs_err=offline_err),
        summarize("hec_lookup", [r for rs, _ in b_rows for r in rs],
                  {"hec_lookup": sum(b_paths.values())},
                  [b_paths[p] / len(rs) for rs, p in b_rows for _ in rs],
                  "launch-weighted mean over the paths: each path's probe "
                  "or lookup shapes share its launches (phase 9's hot-tier "
                  "training and phase 10's runs those of phase 4)")]
    rows[0]["launches_by_path"] = {
        "serve": launches["serve_fused_layer"], "sharded_serve": a_sharded,
        "sharded_serve_failover": a_failover, **a_planes}
    rows[0]["bound_route"] = ("3xTF32 on the tensor cores (bound_ms), beside "
                              "FFMA on the CUDA cores (bound_ffma_ms)")
    rows[0]["library_call"] = ("torch.addmm(b, cat([mean, self], 1), cat([Wn, "
                               "Ws], 0)), float32, TF32 off, the gather "
                               "outside: the products and the bias only")
    rows[1]["launches_by_path"] = b_paths
    train_paths = {"train": launches4, "train_sync": launches9["sync"],
                   "train_drop": launches9["drop"],
                   "train_hot": launches9["hot"],
                   "train_planes": launches11["graphsage"],
                   "train_resilience": launches12a,
                   "dryrun": launches13["dryrun"],
                   "dryrun_sync": launches13["dryrun_sync"],
                   **{f"train_pipeline_{k}": ls
                      for k, ls in launches10.items()}}
    for name in ("update_fused_fwd", "update_fused_bwd", "sage_agg_fwd",
                 "sage_agg_bwd"):
        rows.append(summarize(
            name, rows4[name],
            {name: sum(ls[name] for ls in train_paths.values())},
            [1] * len(rows4[name]), layer_mean + " (phase 9's three "
            "training runs and phase 10's four take the same shapes)"))
        rows[-1]["launches_by_path"] = {p: ls[name]
                                        for p, ls in train_paths.items()}
    f_row = next(r for r in rows if r["name"] == "sage_agg_bwd")
    f_row["index_builds"] = sum(ls["slot_index"]
                                for ls in train_paths.values())
    f_row["index_ms"] = sum(r["index_ms"] for r in rows4["sage_agg_bwd"]) \
        / len(rows4["sage_agg_bwd"])
    f_row["launch_scheme"] = ("two CUDA launches per call, counted as one: "
                              "F through the slot index its forward built "
                              "(index_builds, index_ms: torch.sort and "
                              "searchsorted), then its follow-up (a "
                              "programmatic dependent: g's read, the NaN "
                              "of 0 * g at masked slots)")
    d_row = next(r for r in rows if r["name"] == "update_fused_bwd")
    d_row["launch_scheme"] = ("one CUDA launch per call: the last block to "
                              "finish sums the stripes' column sums")
    c_row = next(r for r in rows if r["name"] == "update_fused_fwd")
    c_row["bound_route"] = ("3xTF32 on the tensor cores (bound_ms), beside "
                            "FFMA on the CUDA cores (bound_ffma_ms)")
    c_row["library_call"] = ("torch.addmm(b, cat([agg, self], 1), cat([Wn, "
                             "Ws], 0)), float32, TF32 off: the products and "
                             "the bias only")
    g_online = [r for r in rows5_g if r["path"] == "online"]
    g_offline = [r for r in rows5_g if r["path"] == "offline"]
    g_train = launches6["gat_edge_fwd"]
    g_sharded = gat8["launches"]["gat_edge_fwd"]
    g_failover = launches12c["gat"]["gat_edge_fwd"]
    rows.append(summarize(
        "gat_edge_fwd", g_online + g_offline + rows6["gat_edge_fwd"]
        + gat8["rows_f"],
        {"gat_edge_fwd": launches5["gat_edge_fwd"] + g_train + g_sharded
         + g_failover + launches11["gat"]["gat_edge_fwd"]
         + launches12b["gat_edge_fwd"]
         + launches13["gat_dryrun"]["gat_edge_fwd"]},
        [microbatches5] * len(g_online)
        + [chunks5 + gat8["chunks"]] * len(g_offline)
        + [g_train / len(rows6["gat_edge_fwd"])] * len(rows6["gat_edge_fwd"])
        + [gat8["online"] / len(gat8["rows_f"])] * len(gat8["rows_f"]),
        "launch-weighted mean over the GAT paths: each serving layer shape "
        "stands for its microbatch launches, each offline shape (first "
        "chunk) for its layer's pre-warm chunks, single-rank and sharded, "
        "each training layer shape for a third of the training launches, "
        "each sharded layer shape (rank 0 of one round) for its rounds' "
        "launches", max_abs_err=offline_err5))
    rows[-1]["launches_by_path"] = {"gat_train_planes": launches11["gat"][
                                        "gat_edge_fwd"],
                                    "gat_serve": launches5["gat_edge_fwd"],
                                    "gat_train": g_train,
                                    "gat_sharded_serve": g_sharded,
                                    "gat_sharded_serve_failover": g_failover,
                                    "gat_train_resilience": launches12b[
                                        "gat_edge_fwd"],
                                    "gat_dryrun": launches13["gat_dryrun"][
                                        "gat_edge_fwd"]}
    h_paths = {"gat_train": launches6, "gat_train_planes": launches11["gat"],
               "gat_train_resilience": launches12b,
               "gat_dryrun": launches13["gat_dryrun"]}
    rows.append(summarize("gat_edge_bwd", rows6["gat_edge_bwd"],
                          {"gat_edge_bwd": sum(ls["gat_edge_bwd"]
                                               for ls in h_paths.values())},
                          [1] * len(rows6["gat_edge_bwd"]), layer_mean))
    rows[-1]["launches_by_path"] = {p: ls["gat_edge_bwd"]
                                    for p, ls in h_paths.items()}
    rows[-1]["index_builds"] = sum(ls["slot_index"]
                                   for ls in h_paths.values())
    rows[-1]["index_ms"] = sum(r["index_ms"] for r in rows6["gat_edge_bwd"]) \
        / len(rows6["gat_edge_bwd"])
    rows[-1]["launch_scheme"] = ("three CUDA launches per call, counted as "
                                 "one: H1 per dst row, H2 per source row "
                                 "through the slot index its forward "
                                 "built, and H2's follow-up (a "
                                 "programmatic dependent: the NaN of 0 * g "
                                 "at masked slots when H1 flagged g)")
    rows.append(summarize("sample_draw", rows7, launches7,
                          [1] * len(rows7), layer_mean + ", under cv"))
    j_paths = {"sharded_serve": sage8["launches"]["hec_probe"],
               "gat_sharded_serve": gat8["launches"]["hec_probe"],
               "sharded_serve_planes": serve11["sharded"]["launches"][
                   "hec_probe"],
               "sharded_serve_failover": launches12c["graphsage"][
                   "hec_probe"],
               "gat_sharded_serve_failover": launches12c["gat"][
                   "hec_probe"]}
    rows.append(summarize(
        "hec_probe", sage8["rows_j"] + gat8["rows_j"] + [ragged_j],
        {"hec_probe": sum(j_paths.values())},
        [j_paths["sharded_serve"] / len(sage8["rows_j"])]
        * len(sage8["rows_j"])
        + [j_paths["gat_sharded_serve"] / len(gat8["rows_j"])]
        * len(gat8["rows_j"]) + [0],
        "launch-weighted mean over the sharded serving paths: each hidden "
        "layer's last request buffer of the run stands for its layer's "
        "launches (the ragged shape is checked, not weighted)"))
    rows[-1]["launches_by_path"] = j_paths
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms per launch (device, "
              f"{r['ms_over']}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['launches']} "
              f"launches on the main paths")
    print(json.dumps({"phase_seconds": PHASE_SECONDS, "build_s": build_s,
                      "total_s": round(time.perf_counter() - start, 1),
                      "host_cpus": os.cpu_count()}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
