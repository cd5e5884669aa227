#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmtraj_torch) on one NVIDIA GPU.

Runs config-4 K=20 rollout inference at full width (hidden = embed = 64,
4 heads, M = 5, N_max = 64, obs 8, pred 12) on the bench shapes of the JAX
package (B = 25 windows, inputs from numpy with seed 0, random weights from
seed 0), and the dense-crowd path of ``mmtraj_torch.benchmarks.rollout_bench``
(N_max = 128 and 256, B = 12, both encoder families), through the port's own
entry points ``Forecaster.rollout_k`` and ``rollout_bench``:

1. versions, and the card's name and power limit from nvidia-smi;
2. build every CUDA kernel of ``mmtraj_torch/csrc`` (one nvcc each,
   all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with device times of both (CUDA-graph replays
   timed by CUDA events), ``fused_gat`` also at the decoder step's
   (B*K, N) = (500, 64) and on the dense crowd's encoder state (12, 128)
   (a thread block cluster of 4 and of 8 blocks a graph), and
   ``fused_decode`` also at the dense crowd's (B*K, N) = (240, 128); each
   kernel's occupancy (blocks an SM, registers, spill bytes, shared bytes a
   block, and for ``fused_gat`` the cluster's blocks and how many clusters
   the card holds at once);
4. route A (whole-layer GAT kernel in the encoder, the fused rollout kernel
   in the decoder) end to end, with its launch counts, against the plain
   route on the same random stream;
5. route B (the attend kernel in every GAT call) the same way;
6. dense crowd: ``attend`` and the lane-packed ``attend(packed=True)``
   against the plain chain at (B*K, N) = (500, 64), with an odd B and an
   all-masked row; the packed kernel's gradient against autograd of the
   plain chain, and ``PACKED_LANES`` lanes of it under ``torch.func.vmap``
   in one launch, equal to a launch a lane to the bit; ``rollout_k`` at N_max = 128 (and 256), B = 12, K = 20
   under ``attend_kernel="auto"`` for both encoder families, with exact
   ``attend`` launch counts, against the plain route on the same stream;
   ``attend`` on the inputs those runs gave it; the dense-crowd benchmark
   (``mmtraj_torch.benchmarks.rollout_bench``) end to end, "auto" and
   "xla", and a short ``op_sweep``;
7. one JSON line with every kernel's launches (summed over the main-path
   runs, each counted from 0; ``attend_packed``, which no ``rollout_k``
   reaches, from its own path, the op sweep), error, times, occupancy and
   two bounds: ``bound_ms`` prices every FLOP at the f32 rate outside the
   tensor cores, ``tc_bound_ms`` the matrix products at three TF32 passes
   on the tensor cores (the 3xTF32 split that every kernel runs);
8. (run before 7's line) the evaluator on the in-repo data
   ``data/synthetic3000``, held-out scene ``univ`` (2,981 windows, at most
   57 agents, N_max = 64), norm stats from the other four scenes: a route-A
   checkpoint written by ``save_npz`` scored by ``mmtraj_torch.cli eval``,
   whose line must equal ``evaluate()``'s; route A against the plain route
   on the whole scene (min-ADE/FDE within 1e-2 m, NLL within 1e-5
   relative), with windows/s; exact launches a batch for route A,
   ``rollout="modes"`` and "auto" at N_max = 128; batch-size and bucket
   invariance and every pooled protocol on the first 300 windows;
   ``autotune_eval_batch``'s sweep, and the host cost of the per-window
   draws and of the final ``fsum``;
9. (run before 7's line) the port's bench: for routes plain, A and B, the
   exact launches of one eager ``rollout_k`` call, the call replayed from a
   CUDA graph against the eager call on one pre-drawn stream (within 1e-6 m
   on valid agents), and two replays of a graph that draws its stream
   inside giving different rollouts; then ``python -m
   mmtraj_torch.benchmarks.bench`` run once in-process, its one JSON line
   parsed and printed on a line of its own;
10. (run before 7's line) training at config 4's full width and batch
   (B = 16, N_max = 64): ``fused_gat`` and ``attend`` as autograd Functions
   against their plain versions, forward and every input's gradient, at
   (16, 64, 64) and (128, 64, 64); three steps of each loss (nll, variety
   with n = 8, hybrid) under ``use_pallas`` against the plain route from the
   same parameters and draws (loss within 1e-5 relative at every step;
   parameters within ``PARAM_TOL``), with exact ``fused_gat`` launches a
   step, and one nll step under the ``attend`` pin with its launches;
   ``fit`` on ``data/synthetic3000`` (univ held out) under ``use_pallas`` with
   EMA: ``FIT_STEPS`` steps uninterrupted, and the same run cut at a
   checkpoint halfway and resumed, which must end bit-identical, with the
   loss descending and the final eval finite; ``train_bench`` steps/s of
   the plain route and ``use_pallas``, for nll and variety;
11. (run before 7's line) the rest of single-device training at the same
   width and batch: ``CHUNK_STEPS`` steps in chunks of ``CHUNK_M``, each
   step a replay of a CUDA graph (``make_multi_train_step``), against as
   many per-step eager steps from the same parameters, batches and draws,
   for nll and variety, plain and ``use_pallas`` (losses within 1e-5
   relative, parameters within ``PARAM_TOL``, exact ``fused_gat`` launches
   at capture); ``fit`` in chunks of ``CHUNK_M`` cut and resumed
   (bit-identical), with the loss descending; ``train_bench`` in chunks
   (the same step per step is phase 10's ``use_pallas`` row), and the
   graphed step's profile; the attention encoder's training, ``use_pallas``
   against plain; the remat policies' gradients against "full", their peak
   memory and steps/s at
   ``REMAT_BATCHES``; the LSTM with the social GAT, ``use_pallas`` against
   plain, three steps and a rollout.  The wrappers count Python calls, so a
   chunk counts its warm-up steps and its capture, and its replays nothing;
12. (run before 7's line) ``dtype="bfloat16"`` at the same width: routes
   plain, A and B under bf16 with exact launches (the float32 routes'),
   each kernel route's encoder and decoder steps against the plain route's
   from the plain route's state, step by step (hidden state within
   ``BF16_STEP_RTOL`` of its largest on all but 1% of rows: a bf16 rounding
   flip carried through later steps forks a rollout, so whole rollouts of
   two implementations agree only in distribution), route A's rollout
   against the plain float32 decoder from route A's own bf16 encoder state
   (within 1e-3 m, 1%), best-of-K ADE/FDE of route B against plain within
   ``BF16_ADE_TOL``, bf16 away from float32, a CUDA graph of bf16 route A
   against eager, and graphed route A's device time in bf16 and float32 in
   turns; training under bf16 (three steps of nll and variety,
   ``use_pallas`` against plain: the first step's loss within 1e-5, later
   ones within ``BF16_LATER_LOSS_RTOL``; one graphed chunk against eager steps,
   ``train_bench`` bf16 and float32); a route-A checkpoint saved
   as ``.pt``, converted to ``.npz`` by ``python -m mmtraj_torch.cli
   convert``, both scored by ``cli eval`` with identical lines, and ``cli
   eval --dtype bfloat16`` of route A and plain checkpoints on the first
   ``EVAL_SUB`` windows of univ, within ``EVAL_ADE_TOL``;
13. (run before 7's line) export and serving: ``export_predictor`` of route
   A, route B and plain at B = 25 and of route A at ``SERVE_B`` = 64, each
   loaded artifact's graph holding its ``mmtraj.*`` custom ops (route A 8
   ``fused_gat`` + 1 ``fused_decode``, route B 20 ``attend``), its launches
   a call exact, and its output on one stream within ``GRAPH_TOL`` of the
   live ``rollout_k``; routes A and B held to plain under ``ROLLOUT_TOL``
   and ``MAX_DIVERGED``; ``load_predictor``'s same seed reproducing and
   another differing; a (3, 40) request through ``PredictServer`` equal to
   the manual padding's slice; ``python -m mmtraj_torch.cli export`` of a
   route-A checkpoint, then ``cli serve --aggregate 8`` as a subprocess
   over 12 lines of which one is malformed and gets its error line; and
   ``serve_bench``'s JSON line (route A, B = 25), printed on a line of its
   own.

14. (run before 7's line) scale-out at config 4's full width:
   ``fused_gat_lanes`` (the GAT kernel over 5 lanes of weights in one launch)
   against its plain version at (5, 16, 64, 64), each lane equal to a single
   ``fused_gat`` launch on its graphs and weights to the bit; a population
   of 5 seeds (B = 16 each, ``use_pallas``, chunks of ``CHUNK_M`` replayed
   from a CUDA graph) with exact launches a population step (20
   ``fused_gat``, each a lane-batched ``fused_gat_lanes``), each lane's
   losses over 20 steps against a sequential graphed run of its seed,
   seed-steps/s of both and the peak memory, and ``fit_population`` end to
   end on the in-repo data;
   config 5 (B = 256, ``use_pallas``) data-parallel over NCCL at world
   size 1: graphed chunks and ``fit`` equal to the bit to the runs without
   a mesh, ``evaluate(mesh=)`` equal to ``evaluate()``; ``fit(stream=True)``
   equal to the resident ``fit``, and ``stream_bench`` at a reduced size.
15. (run before 7's line) the leave-one-out protocol and its tools at
   config 4's full width, through ``python -m mmtraj_torch.cli``:
   ``generate-data --seed 0 --n-frames 3000`` byte-equal to
   ``data/synthetic3000`` and ``baseline --scene all`` for cv and zv (child
   processes beside the card's work); ``train --scene all --use-pallas
   --seeds 0 1 --vmap-seeds`` on a small synthetic tree (``LOO_FRAMES``
   frames a scene, ``LOO_STEPS`` steps a fold in chunks of ``LOO_M``) with
   exact launches and the mean±std table; ``eval-loo`` plain and
   ``--ensemble`` with exact launches, one fold's metrics equal to ``cli
   eval`` of its checkpoint to the bit; one eager fold under ``--profile``
   whose trace holds exactly as many ``gat_kernel`` events as ``fused_gat``
   launches were counted, ``profile-stats`` on it, and the same fold under
   ``--debug-nans`` in eager chunks equal to it to the bit; the occupancy
   bench (routes plain and A at N = 16, 32, 64) and its evaluate wall on
   ``mixed`` (bucketed ADE within 1e-5 m of padded, exact launches); and
   ``mmtraj_torch.entry.entry()``'s loss.
16. (run before 7's line) the importers, the native parser, ``visualize``
   and the build directory: the native annotation parser built with g++
   into the build directory and ``native_available()``; the five scenes of
   ``data/synthetic3000`` parsed natively and by numpy, ``np.array_equal``,
   with rows/s of both; ``IMPORT_SCENE`` written as an 8-column obsmat and
   as a ``.vsp`` at ``VSP_SCALE`` m a pixel, through ``cli import-obsmat``
   and ``cli import-vsp`` (rows equal to the original's); ``evaluate()`` on
   route A of the imported obsmat scene, read through the registry, within
   ``IMPORT_ADE_TOL`` of the original file, with exact launches;
   ``cli.visualize_rollouts`` on route A and plain from one stream (the
   1e-3 m / 1% rule, exact launches; no PNG: matplotlib is not needed on
   the card's machine); ``cli cache`` on the live build directory, and
   ``--trim-gb`` and ``--clear`` on a copy of it.
17. (run before 7's line) the JAX package's native checkpoint, an Orbax
   directory, with no JAX, orbax or tensorstore on the machine: the committed
   ``tests/fixtures/torch_orbax_c4`` (written by the JAX package's
   ``save_orbax``: zarr arrays in an OCDBT store, zstd chunks) loaded by
   ``checkpoint.load`` equal to its twin ``torch_orbax_c4_twin.npz`` to the
   bit; route A ``rollout_k`` (B = 25, N = 64, K = 20, one stream) from the
   model loaded from each, equal to the bit with exact launches; the port's
   ``save`` to a suffix-less path read back equal; ``cli convert`` from the
   directory to ``.npz`` and from ``.npz`` to a directory, equal; a copy
   with one byte of its top-level node flipped raising ``CheckpointError``;
   the load's seconds (median of ``ORBAX_ROUNDS``) and the zstd decoder's
   output rate on the fixture's chunks.
18. (run before 7's line) config 3, the model of RESULTS.md's quality
   recipe (one GAT head of 64, N_max = 32, the recipe's 2 m radius), at full
   width: each kernel at config 3's shapes against its plain version
   (``attend`` and ``fused_decode`` at B·K = 1,280 rollout graphs,
   ``fused_gat`` at the training, variety-rollout and evaluate batches,
   ``fused_gat_lanes`` at 5 lanes of the training and variety batches),
   with device times, bounds and occupancy; route A and the route-B pin
   against plain ``rollout_k`` at config 3's evaluate batch (B = 64, K =
   20) on one stream, with exact launches; ``C3_TRAIN_STEPS`` recipe steps
   (variety n = 8, rotate and flip, dropout, AdamW with weight decay, the
   cosine schedule, the EMA) under ``use_pallas`` against plain, with exact
   launches; a graphed population of 5 lanes in chunks of ``C3_POP_M``,
   its launches exact and each lane's step 1 against its seed's sequential
   step, and the ms of a replayed population step; and
   ``tools/torch_yardstick.py`` end to end at ``C3_SMOKE_STEPS`` steps on
   ``C3_SMOKE_FRAMES`` frames a scene (a smoke of the yardstick, not the
   yardstick: its rows are those of a model trained for 200 steps), with
   route A and plain agreeing within ``EVAL_ADE_TOL``.
19. (run before 7's line) the port's ``experiments/`` scripts: each kernel
   at the shapes they reach against its plain version (``fused_gat`` at
   hidden 128 with 4 heads of 32 and at one head of 64, N = 64, B = 16 and
   25; ``fused_gat_lanes`` over 3 lanes of each, each lane equal to a single
   launch to the bit; the ``fused_gat`` and ``attend`` autograd Functions,
   forward and gradients, at the training batch and the variety rollout's;
   ``attend`` at HD = 128, N = 64 and 128; ``fused_decode`` at the two new
   ``DECODER_CASES``), with device times, bounds and occupancy; then on a
   ``X_FRAMES``-frame synthetic tree ``experiments/torch_social_ablation.py
   --arm C1`` and ``experiments/torch_dense_sweep.py --cell A``, each with
   ``--fast --steps X_STEPS`` and two seeds as one population, and their
   reports with ``--route both`` (route A within ``EVAL_ADE_TOL`` of plain on
   every row), every run with exact launches.
20. (run before 7's line) the weight gradient of the float32 dense
   products (``csrc/wgrad.cu``, ``ops/dense_grad.py``) at the shapes of
   the training paths that take it (``WGRAD_CASES``: config 3's population
   of 5 lanes, the experiments' hidden 128 and LSTM populations, and one
   lane at a lane's shapes), against the float64 product (within
   ``WGRAD_TOL`` of its largest entry) and to the bit from call to call,
   with device times of the kernel, the plain version (a product a lane)
   and cuBLAS's one call for all lanes (``bmm``, ``mm`` for one lane) as
   ``library_ms``, its bound, split and occupancy.  Every launch check of
   phases 4-19 counts ``weight_grad_lanes`` too: a population step
   ``WGRAD_STEP``, a sequential step none; the kernels line's
   ``weight_grad_lanes`` row counts the main path's populations.
21. (run before 7's line) the GAT's backward (``csrc/gat_grad.cu``,
   ``fused_gat.fused_gat_grad``, ``_FusedGat``'s backward) at
   ``kernel_inputs.GRAD_CASES`` (config4-attn3's frame graphs and decoder
   graphs, config 3's population rollout folded into its graphs, N = 256,
   one head of 128) against the float64 VJP of ``attend_math`` (each output within
   ``GRAD_TOL`` of its largest entry, no more than ``GRAD_VS_PLAIN`` times
   further from it than the float32 VJP) and to the bit from call to call,
   with device times of the kernels and of the plain VJP, its bound and
   occupancy.  Every launch check of phases 4-19 counts ``fused_gat_grad``
   too: ``GRAD_STEP`` a ``use_pallas`` step of the rnn encoder, one a
   ``_FusedGat`` backward; the kernels line's ``fused_gat_grad`` row counts
   the training paths' calls.
22. (run before 7's line) the layer norm's kernels (``csrc/layer_norm.cu``,
   ``ops/fused_layer_norm.py``) at ``kernel_inputs.LN_CASES`` (a
   config4-attn3 block's 65,536 tokens, its readout's strided 8,192 rows,
   hidden 128, a ragged row count) against the float64 chain as phase 21
   holds the GAT's backward, and to the bit from call to call, with device
   times of each kernel, of the plain chain's forward and of its backward by
   autograd, of ``torch.nn.functional.layer_norm``'s (``library_ms``), the
   bounds and occupancy, and each of y, dx, dscale and dbias's error for
   the kernels, the plain chain and the library.  Phase 11's attention-encoder steps
   under ``use_pallas`` count both: 6 L + 1 forward calls and 3 L + 1
   backward calls a remat-"full" step of L blocks.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and exits nonzero; without a CUDA device the script
exits 1 before doing anything.  Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from perfcells.costs import attend_cost, decode_cost, gat_cost, lanes_cost

B, N, TO, TP, K = 25, 64, 8, 12, 20
CB, CNS, CITERS = 12, (128, 256), 10  # dense crowd: windows, agent counts, benchmark iters
ATTN_B = 128  # the attention encoder's training batch (config4-attn3): B·T = 1024 frame graphs
SWEEP_NS, SWEEP_B, SWEEP_ITERS = (64, 128, 256), 512, 20  # the short op sweep
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
HBM_RATE = 3.35e12  # H100 SXM device-memory bytes/s (data sheet)
KERNEL_TOL = 1e-4  # attend and GAT: atol = rtol
PACKED_LANES = 3  # lanes of the packed attend under vmap, one launch
ROLLOUT_TOL = 1e-3  # meters, on valid agents
MAX_DIVERGED = 0.01  # share of (window, sample) rollouts allowed past ROLLOUT_TOL
EVAL_DATA = Path(__file__).resolve().parent / "data" / "synthetic3000"
EVAL_SUB = 300  # windows of the invariance and protocol checks
SERVE_B = 64  # phase 13: the second artifact's batch (the first's is B)
# Phase 9: windows of the bench's two numpy denominators (its defaults: 64 and 6),
# and calls a timing trial (its default: a second's worth).
BENCH_HOST_BATCH, BENCH_REF_ITERS, BENCH_ITERS = 16, 2, 20
# Phases 10 and 12: the fewest steps train_bench times (its default 30); its
# min_seconds sets the length.
TRAIN_BENCH_ITERS = 3
EVAL_ADE_TOL = 1e-2  # meters, route A against plain on the whole scene
EVAL_NLL_RTOL = 1e-5
EVAL_INVARIANCE_RTOL = 1e-5
GRAPH_TOL = 1e-6  # meters: rollout_k replayed from a CUDA graph against eager, one stream
TRAIN_STEPS, VARIETY_N, FIT_STEPS = 3, 8, 60
CHUNK_M, CHUNK_STEPS = 10, 20  # phase 11: steps a dispatch, steps against eager
REMAT_BATCHES = (16,)
REMAT_GRAD_RTOL = 1e-5  # a policy's step-1 gradients against "full", of each leaf's largest
TRAIN_LOSS_RTOL = 1e-5
# Phase 11's attention encoder after its first update: Adam moves the elements
# whose gradients are within rounding of 0 by up to lr either way (PARAM_TOL's
# reason), and its layer norms carry that into the loss (9.8e-6 on an H100).
ATTN_LATER_LOSS_RTOL = 1e-4
# Parameters after TRAIN_STEPS steps, use_pallas against plain.  Adam moves an
# element by about lr * sign(g) while its moments are young, so an element
# whose gradient is within rounding of 0 may move the other way: every
# element within 2 lr a step, and 99% of them within PARAM_TOL.
PARAM_TOL = 1e-4
# Phase 14: a population lane against its sequential run.  The lane runs
# other kernels (batched products of S lanes, no remat), so the two round
# differently, and on random-walk windows Adam amplifies that about tenfold a
# step from step 4 (an element whose gradient is within rounding of 0 moves
# by up to lr either way: PARAM_TOL's reason): 0.11 apart at step 18 of one
# seed on an H100.  So the 20-step runs are held at step 1, where they start
# from one state, and a further step of each lane from the lane's own state
# is held to its sequential step (loss TRAIN_LOSS_RTOL, PARAM_TOL's rule).
POP_SEEDS, POP_STEPS = (0, 1, 2, 3, 4), 20
C5_STEPS, C5_FIT_STEPS = 20, 20  # config 5: graphed steps, fit steps
STREAM_STEPS = 10
STREAM_BENCH_WINDOWS, STREAM_BENCH_B, STREAM_BENCH_STEPS = 2000, 256, 10
# Phase 15: the leave-one-out tree's synthetic frames a scene, steps a fold, chunk
# and seeds; the profiled fold's held-out scene and steps; the occupancy bench.
LOO_FRAMES, LOO_STEPS, LOO_M, LOO_SEEDS = 120, 20, 10, (0, 1)
PROFILE_SCENE, PROFILE_STEPS = "eth", 2
OCC_ITERS, OCC_WALL_WINDOWS = 20, 300
# Phase 16: the scene imported as obsmat and evaluated, its eval batch; the .vsp
# scale (a power of two, so pixels times it give back the meters exactly); the
# parser timing rounds; visualize's windows.
IMPORT_SCENE, IMPORT_EVAL_B, VSP_SCALE, PARSE_ROUNDS, VIZ_WINDOWS = "hotel", 64, 1 / 64, 3, 6
# phase 17: the JAX package's Orbax checkpoint (config 4, step 1234); its twin is *_twin.npz
ORBAX_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_orbax_c4"
ORBAX_ROUNDS = 5  # loads and zstd passes timed; the median is reported
IMPORT_ADE_TOL = 1e-6  # meters: the imported scene against the original file
# Phase 18: config 3's evaluate batch (vmem_friendly_batch(20, 32)); recipe steps held
# use_pallas against plain; the population's chunk; the yardstick smoke's steps and frames.
C3_B, C3_TRAIN_STEPS, C3_POP_M = 64, 3, 10
C3_SMOKE_STEPS, C3_SMOKE_FRAMES = 200, 120
# Phase 19: the experiments' training scripts at a smoke size (frames a scene, steps, seeds), their
# agent capacity, and the (hidden, heads) they take the kernels to.
X_FRAMES, X_STEPS, X_SEEDS, X_N = 120, 4, (0, 1), 64
X_WIDTHS = ((128, 4), (64, 1))
# Phase 12 (bf16): a kernel route's step against the plain route's from the
# same state, of the new hidden state's largest |value|; best-of-K ADE/FDE of
# two bf16 routes, meters.
BF16_STEP_RTOL = 1e-5
BF16_ADE_TOL = 1e-3
# Phase 12's bf16 training after the first update: the two routes' parameters
# then differ as PARAM_TOL allows, and bf16 rollouts (the variety objective)
# fork on a rounding flip, so later losses are those of two nearby models
# (1.9e-4 apart at step 3 of variety on an H100).
BF16_LATER_LOSS_RTOL = 1e-3
# Phase 20: (label, lanes, rows a lane, din, dout) of the weight gradients the
# training paths take to csrc/wgrad.cu: config 3's population (5 lanes, the
# variety rollout's 8 x 32 x 32 rows and the encoder's 32 x 32), the
# experiments' hidden-128 population (3 lanes, 8 x 16 x 64 and 16 x 64 rows)
# and LSTM (64 x 256), and one lane at a lane's shapes (a sequential step keeps
# cuBLAS's mm, as fast there).  The error is of the float64 product's largest
# entry: float32 sums of up to 8,192 products.
WGRAD_CASES = (("config3 gru", 5, 8192, 64, 192), ("config3 gat", 5, 8192, 64, 64),
               ("config3 head", 5, 8192, 64, 30), ("config3 embed", 5, 8192, 2, 64),
               ("config3 encoder gru", 5, 1024, 64, 192), ("config3 encoder gat", 5, 1024, 64, 64),
               ("hidden 128 gru", 3, 8192, 128, 384), ("hidden 128 gat", 3, 8192, 128, 128),
               ("hidden 128 encoder gru", 3, 1024, 128, 384), ("lstm", 5, 8192, 64, 256),
               ("one lane gru", 1, 8192, 64, 192), ("one lane encoder gru", 1, 1024, 64, 192))
WGRAD_TOL = 1e-5
# ``weight_grad_lanes`` launches a population step makes (csrc/wgrad.cu: one a
# float32 dense product of the lanes that records a gradient; a sequential
# step makes none): the GRU's TO encoder steps (embed, wx, wh, the GAT's wv and
# wo), bridge_h, the decoder's TP heads and the other five products of its
# first TP - 1 steps (the last step's update feeds no loss).
WGRAD_STEP = 5 * TO + 1 + TP + 5 * (TP - 1)
# ``fused_gat_grad`` calls a ``use_pallas`` training step makes (one a
# ``_FusedGat`` backward; remat's recomputation runs the forward alone): the
# rnn encoder's TO GATs and the decoder's first TP - 1 (the last step's GAT
# feeds no loss); the attention encoder's L layers take the encoder's place.
GRAD_STEP = TO + TP - 1
# Phase 21 (the GAT backward at kernel_inputs.GRAD_CASES): each output within
# GRAD_TOL of its largest entry of the float64 VJP, and no more than
# GRAD_VS_PLAIN times further from it than the float32 VJP (the gradients of a
# float32 chain, whatever the kernel sums in), an error under float32's
# epsilon counted as that epsilon.
GRAD_TOL = 1e-5
GRAD_VS_PLAIN = 4.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(torch, fn, reps: int = 11, inner: int = 5) -> float:
    """Device time of one call: the median over ``reps`` replays of a CUDA
    graph of ``inner`` back-to-back calls, from CUDA events, after two warm-up
    calls on a side stream.  The graph replays the kernels without the host's
    cost of each call (for a wrapper 20-40 us, more than a small kernel
    takes), which would otherwise leave the card idle inside the timing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """The least time the card could take: the larger of bytes over the memory
    rate and f32 operations over the f32 peak.  -> (ms, "bytes"|"operations")."""
    t_bytes, t_ops = nbytes / HBM_RATE, flops / F32_PEAK
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(flops: float, nbytes: float, products: float) -> float:
    """``bound`` with the matrix products on the tensor cores in 3xTF32: the
    product FLOPs at three TF32 passes over the TF32 peak plus the other FLOPs
    over the f32 peak, or bytes over the memory rate if that is larger.  -> ms."""
    t_ops = 3 * products / TF32_PEAK + (flops - products) / F32_PEAK
    return max(nbytes / HBM_RATE, t_ops) * 1e3


def faithful(torch, got, plain, wide) -> float:
    """The largest error of the tensors ``got`` against the float64 ``wide``,
    each over its largest entry; raises unless each is within GRAD_TOL and no
    more than GRAD_VS_PLAIN times the float32 ``plain``'s error (an error
    under float32's epsilon counted as that epsilon)."""
    eps = float(np.finfo(np.float32).eps)
    errs = []
    for g, p_, w in zip(got, plain, wide):
        scale = w.abs().max().item()
        err = (g.double() - w).abs().max().item() / scale
        plain_err = (p_.double() - w).abs().max().item() / scale
        check(err <= GRAD_TOL and err <= GRAD_VS_PLAIN * max(plain_err, eps),
              f"error {err} of the float64 result's largest entry (float32 plain {plain_err})")
        errs.append(err)
    return max(errs)


def grad_cost(b, n, hd, h):
    """The GAT backward's attend chain: v, d_agg, the two score vectors and
    the tile read once, agg, dv and the two score gradients written once;
    per graph the products agg = alpha v, dalpha = d_agg v^T and dv =
    alpha^T d_agg (2 N^2 HD each) and about 16 H N^2 for the chain and its
    gradient.  -> (flops, bytes, product flops)."""
    products = b * 3 * 2 * n * n * hd
    flops = products + b * 16 * h * n * n
    nbytes = 4 * (4 * b * n * hd + 4 * b * n * h + b * n * n)
    return flops, nbytes, products


_LINE_NUMS = re.compile(r"([\w@.]+)=([-\d.]+)m?")


def evaluator_phase(torch, dev, card, cfg, plain_cfg, route_a, state, counted, zero) -> None:
    """Phase 8: the evaluator on the held-out scene, through its entry points
    ``mmtraj_torch.cli.main`` and ``evaluate``.  ``counted(fn)`` runs ``fn``
    with every launch count set to 0 and returns (its result, the counts),
    which it also adds to the kernels line."""
    from mmtraj_torch import cli as torch_cli
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.registry import load_split
    from mmtraj_torch.data.transforms import compute_norm_stats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.params import save_npz

    t0 = time.perf_counter()
    train_w, test_w = load_split(str(EVAL_DATA), "univ", TO, TP)
    stats = compute_norm_stats(train_w, TO)
    ds = WindowDataset(test_w, N)
    check(ds.n_dropped == 0, f"evaluator: {ds.n_dropped} agents over N_max = {N}")
    log(f"evaluator data: univ held out, {len(ds)} windows, {int(ds.mask.sum())} agents, at most "
        f"{int(ds.mask.sum(1).max())} a window; {len(train_w)} training windows for the stats "
        f"(mean {stats.mean.tolist()}, std {stats.std.tolist()}); "
        f"{time.perf_counter() - t0:.2f} s to load")
    model_a = Forecaster(route_a, TO, TP, device=dev, state=state)
    model_p = Forecaster(plain_cfg, TO, TP, device=dev, state=state)
    default_b = ev.vmem_friendly_batch(K, N, bytes_per_elem=4)
    n_batches = math.ceil(len(ds) / default_b)
    per_batch_a = {**zero, "fused_gat": TO + TP, "fused_decode": 1}
    metric_keys = ("min_ade", "min_fde", "miss_rate_2m", "collision_rate", "nll")
    summary = {"card": card, "windows": len(ds), "default_batch": default_b}

    # 1. The CLI on a route-A checkpoint, against evaluate() with its arguments.
    tmp = Path(tempfile.mkdtemp(prefix="tmp_eval_", dir=Path(__file__).resolve().parent))
    try:
        ckpt = str(tmp / "route_a.npz")
        save_npz(ckpt, state, stats, cfg.replace(
            model=route_a, data=dataclasses.replace(cfg.data, data_dir=str(EVAL_DATA))))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            (code, counts) = counted(lambda: torch_cli.main(["eval", "--ckpt", ckpt, "--k", str(K),
                                                         "--device", str(dev)]))
        cli_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    line = out.getvalue().strip().splitlines()[-1]
    log(f"cli eval ({cli_s:.2f} s): {line}")
    want = {k: n_batches * v for k, v in per_batch_a.items()}
    check(code == 0 and counts == want, f"cli eval: exit {code}, launches {counts}, want {want}")
    nums = dict(_LINE_NUMS.findall(line))

    # 2. Route A and the plain route on the whole scene.
    runs = {"A": [], "plain": []}
    for name in ("A", "plain"):
        model = model_a if name == "A" else model_p
        t0 = time.perf_counter()
        m, counts = counted(lambda: ev.evaluate(model, stats, ds, K))
        secs = time.perf_counter() - t0
        want = ({k: n_batches * v for k, v in per_batch_a.items()} if name == "A" else zero)
        check(counts == want, f"evaluate {name}: launches {counts}, want {want}")
        check(all(math.isfinite(m[k]) for k in metric_keys), f"evaluate {name}: {m}")
        runs[name].append((m, secs))
        log(f"evaluate route {name} on univ (B={default_b}): {len(ds) / secs:.1f} windows/s, "
            f"{len(ds) * K / secs:.1f} window-rollouts/s ({secs:.2f} s); "
            + ", ".join(f"{k} {m[k]:.6f}" for k in metric_keys) + f"; {card}")
    m_a, m_p = runs["A"][0][0], runs["plain"][0][0]
    shown = {"ADE": f"{m_a['min_ade']:.4f}", "FDE": f"{m_a['min_fde']:.4f}",
             "MR@2m": f"{m_a['miss_rate_2m']:.3f}", "coll@0.2m": f"{m_a['collision_rate']:.3f}",
             "windows": str(m_a["n_windows"]), "agents": str(m_a["n_agents"])}
    check(all(nums.get(k) == v for k, v in shown.items()),
          f"cli line {line!r} disagrees with evaluate() {shown}")
    d_ade, d_fde = abs(m_a["min_ade"] - m_p["min_ade"]), abs(m_a["min_fde"] - m_p["min_fde"])
    d_nll = abs(m_a["nll"] - m_p["nll"]) / abs(m_p["nll"])
    check(d_ade <= EVAL_ADE_TOL and d_fde <= EVAL_ADE_TOL and d_nll <= EVAL_NLL_RTOL,
          f"route A vs plain: |d ade| {d_ade}, |d fde| {d_fde}, nll rel {d_nll}")
    log(f"route A vs plain: |d min_ade| {d_ade:.3e} m, |d min_fde| {d_fde:.3e} m (tol "
        f"{EVAL_ADE_TOL}), nll rel {d_nll:.3e} (tol {EVAL_NLL_RTOL})")
    summary.update(
        route_a_vs_plain={"d_min_ade": d_ade, "d_min_fde": d_fde, "nll_rel": d_nll},
        windows_per_s={k: [len(ds) / s for _, s in v] for k, v in runs.items()},
        window_rollouts_per_s={k: [len(ds) * K / s for _, s in v] for k, v in runs.items()},
        metrics={"A": {k: m_a[k] for k in metric_keys}, "plain": {k: m_p[k] for k in metric_keys}})

    # 3. Exact launches a batch: the mode rollout (route A) and "auto" at N_max = 128.
    one = WindowDataset(test_w[:default_b], N)
    _, counts = counted(lambda: ev.evaluate(model_a, stats, one, K, default_b,
                                                   rollout="modes"))
    want = {**zero, "fused_gat": TO + 2 * TP}
    check(counts == want, f"evaluate modes: launches {counts}, want {want}")
    auto = Forecaster(dataclasses.replace(plain_cfg, attend_kernel="auto"), TO, TP, device=dev,
                      state=state)
    m_auto, counts = counted(lambda: ev.evaluate(
        auto, stats, WindowDataset(test_w[:default_b], 128), K, default_b))
    want = {**zero, "attend": TO + TP}
    check(counts == want, f"evaluate auto N_max=128: launches {counts}, want {want}")
    check(all(math.isfinite(m_auto[k]) for k in metric_keys), f"evaluate auto: {m_auto}")
    summary["launches_a_batch"] = {"A": per_batch_a, "A_modes": {**zero, "fused_gat": TO + 2 * TP},
                                   "auto_n128": want}
    log(f"launches a batch: route A {per_batch_a}; modes {{'fused_gat': {TO + 2 * TP}}}; "
        f"auto at N_max=128 {want}")

    # 4. Invariance on the card, on the first EVAL_SUB windows.
    sub = WindowDataset(test_w[:EVAL_SUB], N)
    base = ev.evaluate(model_a, stats, sub, K, batch_size=25)
    rel = {}
    for label, kw in (("batch 32 (last batch padded)", dict(batch_size=32)),
                      ("buckets (16, 32, 64)", dict(batch_size=25, buckets=(16, 32, 64)))):
        m = ev.evaluate(model_a, stats, sub, K, **kw)
        rel[label] = max(abs(m[k] - base[k]) / max(abs(base[k]), 1e-12) for k in metric_keys)
        check(rel[label] <= EVAL_INVARIANCE_RTOL and m["n_agents"] == base["n_agents"],
              f"invariance, {label}: largest relative difference {rel[label]}")
    summary["invariance_rel"] = rel
    log(f"invariance on {len(sub)} windows against batch 25: {json.dumps(rel)} "
        f"(tol {EVAL_INVARIANCE_RTOL})")

    # 5. Every pooled protocol once, with its exact launches.
    second = Forecaster(route_a, TO, TP, device=dev, generator=torch.Generator().manual_seed(1))
    sub_batches = math.ceil(len(sub) / 25)
    protocols = (
        ("oversample 2", model_a, dict(oversample=2), per_batch_a),
        ("oversample 2, per_window", model_a, dict(oversample=2, reduction="per_window"),
         per_batch_a),
        ("tta 2", model_a, dict(tta=2), {**zero, "fused_gat": 2 * TO + TP, "fused_decode": 2}),
        ("ensemble of 2", [model_a, second], {},
         {**zero, "fused_gat": 2 * (TO + TP), "fused_decode": 2}),
    )
    for label, model, kw, per_batch in protocols:
        m, counts = counted(lambda: ev.evaluate(model, stats, sub, K, batch_size=25, **kw))
        want = {k: sub_batches * v for k, v in per_batch.items()}
        check(counts == want, f"{label}: launches {counts}, want {want}")
        check(all(math.isfinite(m[k]) for k in metric_keys) and m["n_windows"] == len(sub)
              and m["n_agents"] == base["n_agents"], f"{label}: {m}")
        log(f"protocol {label}: " + ", ".join(f"{k} {m[k]:.6f}" for k in metric_keys)
            + f"; launches {counts}")

    # 6. The card's batch sweep, and the host cost of the draws and the fsum.
    log(f"autotune_eval_batch (route A, N={N}, K={K}; vmem_friendly_batch's TPU-sized "
        f"default {default_b}); {card}:")
    best = ev.autotune_eval_batch(model_a, stats, N, K)
    t0 = time.perf_counter()
    m_best = ev.evaluate(model_a, stats, ds, K, batch_size=best)
    secs = time.perf_counter() - t0
    log(f"evaluate route A on univ at the picked B={best}: {len(ds) / secs:.1f} windows/s, "
        f"{len(ds) * K / secs:.1f} window-rollouts/s; min_ade {m_best['min_ade']:.6f} "
        f"(B={default_b}: {m_a['min_ade']:.6f}); {card}")
    summary.update(autotune_best=best, best_windows_per_s=len(ds) / secs)
    draws = {}
    for b in sorted({default_b, best}):
        win = range(b)

        def draw():
            ev.window_stream(model_a, (0, 0, 0), win, K, N)
            torch.cuda.synchronize()

        draw()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            draw()
            times.append(time.perf_counter() - t0)
        draws[b] = statistics.median(times) * 1e3
    sums = [torch.rand((7, default_b), device=dev) for _ in range(n_batches)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev._metrics(sums, "per_agent", K, len(ds), 0)
    fsum_ms = (time.perf_counter() - t0) * 1e3
    summary.update(draw_ms_a_batch=draws, fsum_ms=fsum_ms)
    log(f"host cost: per-window draws {json.dumps(draws)} ms a batch (median of 20, by batch); "
        f"copy and fsum of {n_batches} batches' sums {fsum_ms:.2f} ms; {card}")
    log("evaluator " + json.dumps(summary))


def bench_phase(torch, dev, card, state, stats, xy_obs, mask, routes, counted, zero) -> None:
    """Phase 9: the port's bench, ``mmtraj_torch.benchmarks.bench``."""
    from mmtraj_torch.benchmarks import bench
    from mmtraj_torch.models.forecaster import Forecaster

    stream = None
    for name, (model_cfg, expect) in routes.items():
        model = Forecaster(model_cfg, TO, TP, device=dev, state=state)
        if stream is None:
            stream = model._rollout_stream(K * B, N, torch.Generator(device=dev).manual_seed(3))
        _, counts = counted(lambda: model.rollout_k(xy_obs, mask, stats, K))
        check(counts == {**zero, **expect}, f"bench route {name}: launches {counts}, want {expect}")
        err = bench.graph_vs_eager(model, xy_obs, mask, stats, K, stream)
        check(err <= GRAPH_TOL, f"bench route {name}: graph vs eager {err} m")
        graph, out = bench.capture(lambda: model.rollout_k(xy_obs, mask, stats, K), dev)
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        check(not torch.equal(first, out), f"bench route {name}: a replay drew the same stream")
        del graph
        log(f"bench route {name}: launches an eager call {counts}; graph vs eager on one stream "
            f"{err:.3e} m (tol {GRAPH_TOL}); two replays draw different streams")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = bench.main(["--host-batch", str(BENCH_HOST_BATCH), "--ref-iters",
                           str(BENCH_REF_ITERS), "--iters", str(BENCH_ITERS)])
    lines = out.getvalue().strip().splitlines()
    check(code == 0 and len(lines) == 1, f"bench printed {len(lines)} lines: {lines}")
    rec = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "vs_vectorized_host", "route", "device",
            "tflops_per_sec", "mfu_pct", "mfu_peak"}
    check(keys <= set(rec) and rec["value"] > 0 and rec["device"] == card,
          f"bench line: {rec}")
    log(f"bench ({time.perf_counter() - t0:.1f} s):")
    log(lines[0])


def training_phase(torch, dev, card, cfg, counted, zero) -> None:
    """Phase 10: training at config 4's full width."""
    from mmtraj_torch import train as tr
    from mmtraj_torch.benchmarks import train_bench
    from mmtraj_torch.data.registry import load_scene_windows
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.ops import fused_attend, fused_gat
    from mmtraj_torch.params import init_params
    from mmtraj_torch.utils.logging import MetricsLogger

    TB = cfg.train.batch_size
    H = cfg.model.num_heads
    state = init_params(cfg.model, torch.Generator().manual_seed(0))
    gw = {k: state[f"dec.gat.{k}"].to(dev) for k in ("wv", "a_src", "a_dst", "wo", "bo")}

    # a. The kernels as autograd Functions: forward and every input's gradient.
    rng = np.random.default_rng(4)
    for b in (TB, TB * 8):
        h = torch.tensor(rng.normal(size=(b, N, 64)), dtype=torch.float32, device=dev)
        att = torch.tensor(rng.random((b, N, N)) < 0.3, dtype=torch.float32, device=dev)
        att[:, -1] = 0.0
        up = torch.tensor(rng.normal(size=(b, N, 64)), dtype=torch.float32, device=dev)
        for name in ("fused_gat", "attend"):
            if name == "fused_gat":
                leaves = [h] + [gw[k] for k in ("wv", "a_src", "a_dst", "wo", "bo")]
                leaves = [x.clone().requires_grad_() for x in leaves]

                def run(fn, xs):
                    return fn(xs[0], att, *xs[1:], H)

                kernel, plain = fused_gat.fused_gat, fused_gat.gat_math
            else:
                v = h @ gw["wv"]
                leaves = [x.contiguous().clone().requires_grad_() for x in (
                    v, v @ fused_gat._block_diag(gw["a_src"]),
                    v @ fused_gat._block_diag(gw["a_dst"]))]

                def run(fn, xs):
                    return fn(*xs, att, H)

                kernel, plain = fused_attend.attend, fused_attend.attend_math
            with torch.enable_grad():
                out_k, out_p = run(kernel, leaves), run(plain, leaves)
                g_k = torch.autograd.grad(out_k, leaves, up)
                g_p = torch.autograd.grad(out_p, leaves, up)
                wide = [x.detach().double().requires_grad_() for x in leaves]
                g_w = torch.autograd.grad(run(plain, wide), wide, up.double())
            torch.cuda.synchronize()
            err = (out_k - out_p).abs().max().item()
            check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
                  f"{name} Function at B={b}: forward err {err}")
            if name == "fused_gat":  # the backward kernel: held to float64 (GRAD_TOL)
                g_err = faithful(torch, g_k, g_p, g_w)
            else:
                g_err = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
                            for a, c in zip(g_k, g_p))
                check(all(torch.allclose(a, c, atol=KERNEL_TOL, rtol=KERNEL_TOL)
                          for a, c in zip(g_k, g_p)),
                      f"{name} Function at B={b}: gradients {g_err}")
            log(f"{name} autograd Function ({b}, {N}, 64): forward max abs err {err:.3e}, "
                f"gradients of {len(leaves)} inputs within {g_err:.3e} of their largest "
                f"(tol {GRAD_TOL if name == 'fused_gat' else KERNEL_TOL})")

    # b. Three steps of each loss, use_pallas against plain, same parameters and draws.
    xy, mask = train_bench.fake_batch(TB, N, TO + TP, dev)
    stats = NormStats(np.zeros(2, np.float32), np.ones(2, np.float32))
    lr = cfg.train.lr
    per_step = {"nll": 2 * (TO + TP), "variety": 2 * (TO + TP), "hybrid": 4 * (TO + TP)}
    grad_calls = {"nll": GRAD_STEP, "variety": GRAD_STEP, "hybrid": 2 * GRAD_STEP}

    def train_run(model_cfg, loss_mode, kernel=None):
        model = Forecaster(model_cfg, TO, TP, device=dev, state=state)
        step = tr.make_train_step(model, tr.make_optimizer(cfg, model), stats,
                                  loss_mode=loss_mode, variety_n=VARIETY_N)
        losses, grads = [], None
        for s in range(TRAIN_STEPS):
            if kernel is None:
                loss = step(xy, mask, s)
            else:
                loss, counts = counted(lambda: step(xy, mask, s))
                want = {**zero, kernel: per_step[loss_mode]}
                if kernel == "fused_gat":
                    want["fused_gat_grad"] = grad_calls[loss_mode]
                check(counts == want, f"train {loss_mode} step {s}: launches {counts}, want {want}")
            losses.append(float(loss))
            if s == 0:
                grads = [p.grad.clone() for p in model.parameters()]
        return losses, grads, torch.cat([p.detach().flatten() for p in model.parameters()])

    with torch.enable_grad():
        for loss_mode in ("nll", "variety", "hybrid"):
            t0 = time.perf_counter()
            lp, gp, pp = train_run(cfg.model, loss_mode)
            t_plain = time.perf_counter() - t0
            t0 = time.perf_counter()
            lk, gk, pk = train_run(dataclasses.replace(cfg.model, use_pallas=True), loss_mode,
                                   "fused_gat")
            t_kernel = time.perf_counter() - t0
            rel = [abs(a - c) / abs(c) for a, c in zip(lk, lp)]
            check(max(rel) <= TRAIN_LOSS_RTOL, f"train {loss_mode}: losses {lk} vs {lp}")
            dp = (pk - pp).abs()
            share = (dp > PARAM_TOL).float().mean().item()
            check(dp.max().item() <= 2 * lr * TRAIN_STEPS and share <= 0.01,
                  f"train {loss_mode}: parameters max |d| {dp.max().item()}, share past "
                  f"{PARAM_TOL} {share}")
            g_rel = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
                        for a, c in zip(gk, gp))
            log(f"train {loss_mode} (B={TB}, N={N}, {TRAIN_STEPS} steps): use_pallas losses "
                f"{[f'{x:.7f}' for x in lk]}, plain {[f'{x:.7f}' for x in lp]} (largest rel "
                f"{max(rel):.2e}, tol {TRAIN_LOSS_RTOL}); step-1 gradients within {g_rel:.2e} of "
                f"each leaf's largest; parameters max |d| {dp.max().item():.3e}, median "
                f"{dp.median().item():.3e}, share past {PARAM_TOL}: {share:.2e}; fused_gat "
                f"{per_step[loss_mode]} launches a step; wall {t_kernel:.2f} s vs plain "
                f"{t_plain:.2f} s")
        lk, _, _ = train_run(dataclasses.replace(cfg.model, attend_kernel="pallas"), "nll",
                             "attend")
        lp, _, _ = train_run(cfg.model, "nll")
        rel = abs(lk[0] - lp[0]) / abs(lp[0])
        check(rel <= TRAIN_LOSS_RTOL, f"train nll, attend pin: loss {lk[0]} vs {lp[0]}")
        log(f"train nll under attend_kernel='pallas': attend {per_step['nll']} launches a step; "
            f"step-1 loss rel {rel:.2e}")

        # c. fit on the in-repo data, with EMA, a checkpoint, a resume and the final eval.
        fit_cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, use_pallas=True),
            data=dataclasses.replace(cfg.data, data_dir=str(EVAL_DATA)),
            train=dataclasses.replace(cfg.train, steps=FIT_STEPS, eval_every=0, log_every=10,
                                      ckpt_every=FIT_STEPS // 2, ema_decay=0.99, k_samples=K))
        n_test = len(load_scene_windows(str(EVAL_DATA), "univ", TO, TP))
        want_fit = {**zero, "fused_gat": FIT_STEPS * per_step["nll"]
                    + math.ceil(n_test / TB) * (TO + 2 * TP), "fused_gat_grad": FIT_STEPS * GRAD_STEP}
        tmp = Path(tempfile.mkdtemp(prefix="tmp_fit_", dir=Path(__file__).resolve().parent))
        try:
            def fit(c, resume=False):
                return tr.fit(c, logger=MetricsLogger(c.train.out_dir, quiet=True), resume=resume,
                              device=dev)

            whole_cfg = fit_cfg.replace(train=dataclasses.replace(fit_cfg.train,
                                                                  out_dir=str(tmp / "a")))
            t0 = time.perf_counter()
            whole, counts = counted(lambda: fit(whole_cfg))
            fit_s = time.perf_counter() - t0
            check(counts == want_fit, f"fit: launches {counts}, want {want_fit}")
            cut = fit_cfg.replace(train=dataclasses.replace(fit_cfg.train, steps=FIT_STEPS // 2,
                                                            out_dir=str(tmp / "b")))
            fit(cut)
            resumed = fit(cut.replace(train=dataclasses.replace(cut.train, steps=FIT_STEPS)),
                          resume=True)
        finally:
            shutil.rmtree(tmp)
    same = all(torch.equal(whole.state[k], resumed.state[k]) for k in whole.state)
    check(same and whole.eval_metrics == resumed.eval_metrics,
          "fit: the resumed run differs from the uninterrupted one")
    losses = [lv for _, lv in whole.history]
    check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"fit: the loss did not descend {losses}")
    m = whole.eval_metrics
    check(all(math.isfinite(m[k]) for k in ("min_ade", "min_fde", "nll")), f"fit eval: {m}")
    log(f"fit on data/synthetic3000 (univ held out, use_pallas, EMA 0.99, B={TB}, "
        f"{FIT_STEPS} steps, {fit_s:.1f} s with the final eval; {card}): loss "
        f"{[round(x, 4) for x in losses]}; resumed from step {FIT_STEPS // 2}: bit-identical "
        f"parameters and metrics; final eval (EMA) min_ade {m['min_ade']:.6f} min_fde "
        f"{m['min_fde']:.6f} nll {m['nll']:.6f}; launches {counts}")

    # d. train_bench, the plain route and use_pallas.
    rows = {}
    with torch.enable_grad():
        for loss_mode in ("nll", "variety"):
            for use_pallas in (False, True):
                r = train_bench.bench_train_step(TB, min_seconds=1.0, use_pallas=use_pallas,
                                                 loss_mode=loss_mode, variety_n=VARIETY_N,
                                                 device=dev, flops=not rows.get(loss_mode),
                                                 iters=TRAIN_BENCH_ITERS)
                rows.setdefault(loss_mode, []).append(r)
                log("train_bench " + train_bench._fmt(r))
    summary = {mode: {"plain_steps_per_s": [r.steps_per_sec for r in rs if r.route == "plain"],
                      "pallas_steps_per_s": [r.steps_per_sec for r in rs if r.route == "pallas"],
                      "flops_per_step": rs[0].flops_per_step, "mfu_plain": rs[0].mfu}
               for mode, rs in rows.items()}
    log("training " + json.dumps({"card": card, "train_bench": summary}))


def graphed_training_phase(torch, dev, card, cfg, counted, zero) -> None:
    """Phase 11: the rest of single-device training at config 4's full width:
    chunks of steps replayed from a CUDA graph against per-step eager
    training, ``fit`` in chunks, ``train_bench`` at M = 1 and M = 10, the
    attention encoder's training, the remat policies and the LSTM.

    Launch counts: the wrappers count Python calls, so a chunk's warm-up
    steps and its capture count and its replays do not; ``counted`` adds
    what they count to the kernels line, and each replay repeats the
    capture's launches (``multi.capture_launches``)."""
    from mmtraj_torch import train as tr
    from mmtraj_torch.benchmarks import train_bench
    from mmtraj_torch.data.registry import load_scene_windows
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.params import init_params
    from mmtraj_torch.utils.logging import MetricsLogger

    TB, M = cfg.train.batch_size, CHUNK_M
    lr = cfg.train.lr
    state = init_params(cfg.model, torch.Generator().manual_seed(0))
    stats = NormStats(torch.zeros(2, device=dev), torch.ones(2, device=dev))
    per_step = 2 * (TO + TP)  # fused_gat a step under use_pallas, nll or variety
    summary = {"card": card}

    def compare(label, losses, ref_losses, params, ref_params, later_rtol=TRAIN_LOSS_RTOL):
        """Step 1's loss within TRAIN_LOSS_RTOL, later steps' within
        ``later_rtol``, parameters per PARAM_TOL's rule."""
        rels = [abs(a - c) / abs(c) for a, c in zip(losses, ref_losses)]
        check(rels[0] <= TRAIN_LOSS_RTOL and max(rels) <= later_rtol,
              f"{label}: losses {losses} vs {ref_losses}")
        rel = max(rels)
        dp = (params - ref_params).abs()
        share = (dp > PARAM_TOL).float().mean().item()
        check(dp.max().item() <= 2 * lr * len(losses) and share <= 0.01,
              f"{label}: parameters max |d| {dp.max().item()}, share past {PARAM_TOL} {share}")
        return rel, dp.max().item()

    def flat(model):
        return torch.cat([p.detach().flatten() for p in model.parameters()])

    # a. CHUNK_STEPS steps in chunks of M replayed from a graph, against
    # per-step eager steps from the same parameters, batches and draws.
    xy_all, mask_all = train_bench.fake_batch(4 * TB, N, TO + TP, dev, seed=5)
    rng = np.random.default_rng(6)
    idx = np.stack([rng.permutation(4 * TB)[:TB] for _ in range(CHUNK_STEPS)])
    kw = dict(loss_mode="nll", variety_n=VARIETY_N, augment_rotate=True, augment_flip=True,
              seed=3)
    chunk_rows = {}
    with torch.enable_grad():
        for loss_mode in ("nll", "variety"):
            for use_pallas in (False, True):
                mc = dataclasses.replace(cfg.model, use_pallas=use_pallas)
                c = cfg.replace(model=mc)
                want = {**zero, "fused_gat": per_step if use_pallas else 0,
                        "fused_gat_grad": GRAD_STEP if use_pallas else 0}

                def models():
                    m = Forecaster(mc, TO, TP, device=dev, state=state)
                    return m, Forecaster(mc, TO, TP, device=dev, state=state)

                me, ee = models()
                step = tr.make_train_step(me, tr.make_optimizer(c, me), stats, ee, 0.99,
                                          **{**kw, "loss_mode": loss_mode})
                t0 = time.perf_counter()
                eager, counts = counted(lambda: [float(step(
                    xy_all[torch.as_tensor(i, device=dev)], mask_all[torch.as_tensor(i, device=dev)],
                    s)) for s, i in enumerate(idx)])
                eager_s = (time.perf_counter() - t0) / CHUNK_STEPS
                check(counts == {k: CHUNK_STEPS * v for k, v in want.items()},
                      f"eager {loss_mode}: launches {counts}")
                mg, eg = models()
                multi = tr.make_multi_train_step(mg, tr.make_optimizer(c, mg), stats, eg, 0.99,
                                                 **{**kw, "loss_mode": loss_mode})
                graphed, chunk_s = [], []
                for k in range(CHUNK_STEPS // M):
                    t0 = time.perf_counter()
                    losses, counts = counted(lambda: multi(xy_all, mask_all, idx[k * M:(k + 1) * M],
                                                           range(k * M, (k + 1) * M)))
                    chunk_s.append(time.perf_counter() - t0)
                    graphed += losses.tolist()
                    # warm-up and capture on the first chunk, replays only after
                    n = tr.CAPTURE_WARMUP + 1 if k == 0 else 0
                    check(counts == {key: n * v for key, v in want.items()},
                          f"graphed {loss_mode} chunk {k}: launches {counts}, want {n} x {want}")
                check(multi.capture_launches == want,
                      f"graphed {loss_mode}: capture launches {multi.capture_launches}, want {want}")
                label = f"graphed vs eager {loss_mode} {'use_pallas' if use_pallas else 'plain'}"
                rel, dmax = compare(label, graphed, eager, flat(mg), flat(me))
                d_ema = (flat(eg) - flat(ee)).abs().max().item()
                chunk_rows[label] = {"loss_rel": rel, "param_max_abs": dmax, "ema_max_abs": d_ema,
                                     "eager_ms_a_step": eager_s * 1e3,
                                     "first_chunk_s": chunk_s[0],
                                     "graphed_ms_a_step": chunk_s[-1] / M * 1e3}
                log(f"{label} (B={TB}, N={N}, {CHUNK_STEPS} steps, M={M}, augment, EMA 0.99): "
                    f"losses within {rel:.2e} relative (tol {TRAIN_LOSS_RTOL}); parameters max "
                    f"|d| {dmax:.3e}, EMA {d_ema:.3e}; capture launches {multi.capture_launches}; "
                    f"eager {eager_s * 1e3:.2f} ms a step, first chunk (warm-up, capture, "
                    f"replays) {chunk_s[0]:.2f} s, then {chunk_s[-1] / M * 1e3:.2f} ms a step")
    summary["chunks"] = chunk_rows

    # b. fit in chunks of M on the in-repo data, cut at a checkpoint and resumed.
    fit_cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, use_pallas=True),
        data=dataclasses.replace(cfg.data, data_dir=str(EVAL_DATA)),
        train=dataclasses.replace(cfg.train, steps=FIT_STEPS, eval_every=0, log_every=10,
                                  ckpt_every=FIT_STEPS // 2, ema_decay=0.99, k_samples=K,
                                  steps_per_dispatch=M))
    n_test = len(load_scene_windows(str(EVAL_DATA), "univ", TO, TP))
    want_fit = {**zero, "fused_gat": (tr.CAPTURE_WARMUP + 1) * per_step
                + math.ceil(n_test / TB) * (TO + 2 * TP),
                "fused_gat_grad": (tr.CAPTURE_WARMUP + 1) * GRAD_STEP}
    tmp = Path(tempfile.mkdtemp(prefix="tmp_fit_", dir=Path(__file__).resolve().parent))
    try:
        def fit(c, resume=False):
            return tr.fit(c, logger=MetricsLogger(c.train.out_dir, quiet=True), resume=resume,
                          device=dev)

        with torch.enable_grad():
            t0 = time.perf_counter()
            whole, counts = counted(lambda: fit(fit_cfg.replace(train=dataclasses.replace(
                fit_cfg.train, out_dir=str(tmp / "a")))))
            fit_s = time.perf_counter() - t0
            check(counts == want_fit, f"fit in chunks: launches {counts}, want {want_fit}")
            cut = fit_cfg.replace(train=dataclasses.replace(fit_cfg.train, steps=FIT_STEPS // 2,
                                                            out_dir=str(tmp / "b")))
            fit(cut)
            resumed = fit(cut.replace(train=dataclasses.replace(cut.train, steps=FIT_STEPS)),
                          resume=True)
    finally:
        shutil.rmtree(tmp)
    same = all(torch.equal(whole.state[k], resumed.state[k]) for k in whole.state)
    logged = dict(whole.history)  # the resumed run also logs its first step
    check(same and whole.eval_metrics == resumed.eval_metrics and
          all(logged[s] == lv for s, lv in resumed.history if s in logged),
          "fit in chunks: the resumed run differs from the uninterrupted one")
    losses = [lv for _, lv in whole.history]
    check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"fit in chunks: no descent {losses}")
    m = whole.eval_metrics
    check(all(math.isfinite(m[k]) for k in ("min_ade", "min_fde", "nll")), f"fit eval: {m}")
    log(f"fit in chunks of {M} (univ held out, use_pallas, EMA 0.99, B={TB}, {FIT_STEPS} steps, "
        f"{fit_s:.1f} s with the final eval; {card}): loss {[round(x, 4) for x in losses]}; "
        f"resumed from step {FIT_STEPS // 2}: bit-identical parameters and metrics; final eval "
        f"(EMA) min_ade {m['min_ade']:.6f} min_fde {m['min_fde']:.6f} nll {m['nll']:.6f}; "
        f"launches {counts} (capture, warm-up and eval)")
    summary["fit_s"] = fit_s

    # c. train_bench in chunks of M (the same step per step, M = 1, is phase 10's
    # use_pallas row); the graphed step's profile.
    rows = {}
    with torch.enable_grad():
        for loss_mode in ("nll", "variety"):
            r = train_bench.bench_train_step(TB, min_seconds=1.0, use_pallas=True,
                                             loss_mode=loss_mode, variety_n=VARIETY_N,
                                             device=dev, flops=False, steps_per_dispatch=M)
            rows[f"{loss_mode} M={M}"] = r.steps_per_sec
            log("train_bench " + train_bench._fmt(r))
        prof = train_bench.profile_train_step(TB, use_pallas=True, device=dev, steps=M,
                                              steps_per_dispatch=M)
    log("train_bench --profile --steps-per-dispatch " + json.dumps(prof))
    check(prof["device_busy_share"] is None or prof["device_busy_share"] > 0,
          f"graphed profile: {prof}")
    summary["train_bench_steps_per_s"] = rows
    summary["graphed_profile"] = {k: prof[k] for k in (
        "step_ms", "host_enqueue_ms", "device_kernels_per_step", "device_busy_share")}

    # d. The attention encoder's training: use_pallas against plain, 3 steps.
    xy, mask = train_bench.fake_batch(TB, N, TO + TP, dev)
    attn = dataclasses.replace(cfg.model, encoder="attn")
    attn_state = init_params(attn, torch.Generator().manual_seed(0))

    def steps(model_cfg, st, loss_mode="nll", kernel_calls=None, grad_calls=None,
              norm_calls=(0, 0)):
        model = Forecaster(model_cfg, TO, TP, device=dev, state=st)
        step = tr.make_train_step(model, tr.make_optimizer(cfg.replace(model=model_cfg), model),
                                  stats, loss_mode=loss_mode, variety_n=VARIETY_N)
        losses, grads = [], None
        for s in range(TRAIN_STEPS):
            loss, counts = counted(lambda: step(xy, mask, s))
            want = {**zero, "fused_gat": kernel_calls or 0, "fused_gat_grad": grad_calls or 0,
                    "fused_layer_norm": norm_calls[0], "fused_layer_norm_grad": norm_calls[1]}
            check(counts == want, f"{model_cfg.encoder}/{model_cfg.cell} step {s}: launches "
                                  f"{counts}, want {want}")
            losses.append(float(loss))
            if s == 0:
                grads = [p.grad.clone() for p in model.parameters()]
        return losses, grads, flat(model), model

    with torch.enable_grad():
        for loss_mode in ("nll", "variety"):
            lp, _, pp, _ = steps(attn, attn_state, loss_mode)
            calls = 2 * (attn.attn_layers + TP)
            # The layer norms (3 a block and the readout's): the blocks' again in the
            # recomputation, one backward call each.
            norms = 3 * attn.attn_layers
            lk, _, pk, _ = steps(dataclasses.replace(attn, use_pallas=True), attn_state, loss_mode,
                                 calls, attn.attn_layers + TP - 1, (2 * norms + 1, norms + 1))
            rel, dmax = compare(f"attn {loss_mode}", lk, lp, pk, pp, ATTN_LATER_LOSS_RTOL)
            log(f"attn encoder training {loss_mode} (B={TB}, N={N}, {TRAIN_STEPS} steps): "
                f"use_pallas vs plain losses {lk} vs {lp}, within {rel:.2e} relative; "
                f"parameters max |d| {dmax:.3e}; "
                f"fused_layer_norm {2 * norms + 1} and fused_layer_norm_grad {norms + 1} a "
                f"step; fused_gat {calls} launches a step ({attn.attn_layers} layers at "
                f"{TB * TO} graphs, {TP} decoder steps, each again in the recomputation)")

    # e. The remat policies: gradients against "full", peak memory and rate.
    policies = {"off": (False, {}), "full": (True, {}), "dots": (True, {"remat_policy": "dots"}),
                "dots_no_batch": (True, {"remat_policy": "dots_no_batch"})}
    grads = {}
    with torch.enable_grad():
        for name, (remat, extra) in policies.items():
            mc = dataclasses.replace(cfg.model, use_pallas=True, remat=remat, **extra)
            _, grads[name], _, _ = steps(mc, state, "nll", per_step if remat else TO + TP,
                                         GRAD_STEP)
        for name in ("off", "dots", "dots_no_batch"):
            g_rel = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
                        for a, c in zip(grads[name], grads["full"]))
            check(g_rel <= REMAT_GRAD_RTOL, f"remat {name}: gradients {g_rel} from full's")
            log(f"remat {name} vs full: step-1 gradients within {g_rel:.2e} of each leaf's "
                f"largest (tol {REMAT_GRAD_RTOL})")
        remat_rows = {}
        for b in REMAT_BATCHES:
            for name, (remat, extra) in policies.items():
                r = train_bench.bench_train_step(b, remat=remat, min_seconds=1.0, use_pallas=True,
                                                 device=dev, flops=False, steps_per_dispatch=M,
                                                 model_kw=extra)
                remat_rows[f"B={b} {name}"] = {"steps_per_s": r.steps_per_sec,
                                               "peak_mib": r.peak_mem_bytes / 2**20}
                log("train_bench " + train_bench._fmt(r))
    summary["remat"] = remat_rows

    # f. The LSTM with the social GAT: use_pallas against plain, 3 steps and a rollout.
    lstm = dataclasses.replace(cfg.model, cell="lstm")
    lstm_state = init_params(lstm, torch.Generator().manual_seed(0))
    with torch.enable_grad():
        lp, _, pp, _ = steps(lstm, lstm_state)
        lk, _, pk, model = steps(dataclasses.replace(lstm, use_pallas=True), lstm_state, "nll",
                                 per_step, GRAD_STEP)
    rel, dmax = compare("lstm nll", lk, lp, pk, pp)
    plain = Forecaster(lstm, TO, TP, device=dev, state=model.state_dict())
    roll, counts = counted(lambda: model.rollout_k(xy[:, :, :TO], mask, stats, K,
                                                   generator=torch.Generator(device=dev).manual_seed(1)))
    want = {**zero, "fused_gat": TO + TP}
    check(counts == want, f"lstm rollout_k: launches {counts}, want {want}")
    ref = plain.rollout_k(xy[:, :, :TO], mask, stats, K,
                          generator=torch.Generator(device=dev).manual_seed(1))
    check(bool(torch.isfinite(roll).all()) and roll.shape == (K, TB, N, TP, 2),
          f"lstm rollout_k: shape {tuple(roll.shape)} or not finite")
    per = torch.where(mask[None, :, :, None, None], (roll - ref).abs(), 0.0).flatten(2).amax(2)
    n_bad = int((per > ROLLOUT_TOL).sum())
    check(n_bad <= MAX_DIVERGED * K * TB, f"lstm rollout_k: {n_bad} rollouts past {ROLLOUT_TOL}")
    log(f"lstm + social GAT (B={TB}, N={N}): {TRAIN_STEPS} nll steps use_pallas vs plain losses "
        f"within {rel:.2e}, parameters max |d| {dmax:.3e}, fused_gat {per_step} launches a step; "
        f"rollout_k K={K} vs plain max abs err {per[per <= ROLLOUT_TOL].max().item():.3e} m, "
        f"{n_bad} of {K * TB} past {ROLLOUT_TOL} m, fused_gat {TO + TP} launches")

    # g. fused_gat's device time at the training shapes: the encoder's B graphs,
    # and B * obs (the attention encoder) = B * VARIETY_N (the variety rollout).
    from mmtraj_torch.ops import fused_gat

    rng = np.random.default_rng(7)
    gw = [state[f"dec.gat.{k}"].to(dev) for k in ("wv", "a_src", "a_dst", "wo", "bo")]
    gat_ms = {}
    for b in (TB, TB * TO):
        h = torch.tensor(rng.normal(size=(b, N, cfg.model.hidden_dim)), dtype=torch.float32,
                         device=dev)
        att = torch.tensor(rng.random((b, N, N)) < 0.3, dtype=torch.float32, device=dev)
        args = (h, att, *gw, cfg.model.num_heads)
        gat_ms[f"({b}, {N}, {cfg.model.hidden_dim})"] = {
            "ms": time_ms(torch, lambda: fused_gat.fused_gat(*args)),
            "plain_ms": time_ms(torch, lambda: fused_gat.gat_math(*args))}
    log(f"fused_gat device time at the training shapes ({card}): {gat_ms}")
    summary["fused_gat_ms"] = gat_ms
    log("graphed training " + json.dumps(summary))


def synced_steps(torch, ref, other, xy_obs, mask, stats, stream):
    """The encoder's TO steps and the decoder's TP sampled steps of ``other``
    against ``ref``'s, each from ``ref``'s state (its carry, and its sampled
    offsets on ``stream``), so that no difference carries from one step to
    the next -> per step (rows of the new hidden state past BF16_STEP_RTOL
    of its largest |value|, rows, largest error of the other rows)."""
    from mmtraj_torch.data.transforms import denormalize, normalize, to_relative
    from mmtraj_torch.models import forecaster as fc
    from mmtraj_torch.models import gmm
    from mmtraj_torch.models.cells import Carry, init_carry

    def rows(got, want):
        err = (got - want).abs().flatten(0, -2).amax(-1) / want.abs().max().clamp_min(1e-30)
        past = err > BF16_STEP_RTOL
        return int(past.sum()), err.numel(), (err[~past].max().item() if (~past).any() else 0.0)

    p = ref.params()
    dt = fc._compute_dtype(ref.cfg)
    pe, pd = fc._round_coder(p["enc"], dt), fc._round_coder(p["dec"], dt)
    B, Nm = mask.shape
    out = []
    carry = init_carry((B, Nm), ref.cfg.hidden_dim, xy_obs.device)
    dxy_n = normalize(to_relative(xy_obs), stats)
    for t in range(TO):
        args = (carry, dxy_n[:, :, t], xy_obs[:, :, t], mask)
        nxt = fc._step(pe, ref.cfg, *args)
        out.append(rows(fc._step(pe, other.cfg, *args).h, nxt.h))
        carry = nxt
    carry = ref._bridge(p, carry.h, carry.c)

    def tile(a):
        return a.repeat((K,) + (1,) * (a.ndim - 1))

    carry, xy, mask_k = Carry(tile(carry.h), tile(carry.c)), tile(xy_obs[:, :, -1]), tile(mask)
    for t in range(TP):
        dxy = gmm.sample_from(ref._head(p, carry.h), stream[0][:, t], stream[1][:, t])
        xy = xy + denormalize(dxy, stats)
        nxt = fc._step(pd, ref.cfg, carry, dxy, xy, mask_k)
        out.append(rows(fc._step(pd, other.cfg, carry, dxy, xy, mask_k).h, nxt.h))
        carry = nxt
    return out


def bf16_phase(torch, dev, card, cfg, plain_cfg, route_a, route_b, state, stats, xy_obs, mask,
               gt, counted, zero) -> None:
    """Phase 12: ``dtype="bfloat16"`` through inference, training and the
    checkpoint formats, at config 4's full width."""
    from mmtraj_torch import checkpoint
    from mmtraj_torch import cli as torch_cli
    from mmtraj_torch import train as tr
    from mmtraj_torch.benchmarks import bench, train_bench
    from mmtraj_torch.data import registry
    from mmtraj_torch.data.registry import load_split
    from mmtraj_torch.data.transforms import NormStats, compute_norm_stats
    from mmtraj_torch.metrics import best_of_k
    from mmtraj_torch.models.forecaster import Forecaster

    summary = {"card": card}

    def bf16(mc):
        return dataclasses.replace(mc, dtype="bfloat16")

    # a. Inference: launches, steps from the plain route's state, rollouts.
    models = {name: Forecaster(mc, TO, TP, device=dev, state=state) for name, mc in (
        ("plain", bf16(plain_cfg)), ("A", bf16(route_a)), ("B", bf16(route_b)),
        ("plain f32", plain_cfg), ("A f32", route_a), ("B f32", route_b))}
    stream = models["plain"]._rollout_stream(K * B, N, torch.Generator(device=dev).manual_seed(5))
    rolls, counts = {}, {}
    for name, model in models.items():
        rolls[name], counts[name] = counted(
            lambda: model.rollout_k(xy_obs, mask, stats, K, stream=stream))
        check(rolls[name].shape == (K, B, N, TP, 2) and bool(torch.isfinite(rolls[name]).all()),
              f"bf16 {name}: shape {tuple(rolls[name].shape)} or not finite")
    want = {"plain": zero, "A": {**zero, "fused_gat": TO, "fused_decode": 1},
            "B": {**zero, "attend": TO + TP}}
    for name, w in want.items():
        check(counts[name] == w and counts[f"{name} f32"] == w,
              f"bf16 {name}: launches {counts[name]}, float32 {counts[name + ' f32']}, want {w}")
    steps = {name: synced_steps(torch, models["plain"], models[name], xy_obs, mask, stats, stream)
             for name in ("A", "B")}
    for name, per in steps.items():
        for t, (past, n_rows, others) in enumerate(per):
            check(past <= MAX_DIVERGED * n_rows and others <= BF16_STEP_RTOL,
                  f"bf16 {name} step {t}: {past} of {n_rows} rows past {BF16_STEP_RTOL}, "
                  f"others {others}")
    # route A's decoder is float32: against the plain float32 decoder from
    # route A's own bf16 encoder state.
    carry_a = models["A"].encode(xy_obs, mask, stats)
    split = models["plain f32"].rollout_k(xy_obs, mask, stats, K, carry=carry_a, stream=stream)
    d = torch.where(mask[None, :, :, None, None], (rolls["A"] - split).abs(), 0.0)
    per = d.flatten(2).amax(2)
    n_bad = int((per > ROLLOUT_TOL).sum())
    check(n_bad <= MAX_DIVERGED * K * B,
          f"bf16 A vs the float32 decoder from its encoder: {n_bad} of {K * B} past {ROLLOUT_TOL}")
    metrics = {name: [float(x) for x in best_of_k(r, gt, mask)] for name, r in rolls.items()}
    d_b = max(abs(a - c) for a, c in zip(metrics["B"], metrics["plain"]))
    check(d_b <= BF16_ADE_TOL, f"bf16 B vs plain best-of-K {metrics['B']} vs {metrics['plain']}")
    moved = torch.where(mask[None, :, :, None, None], (rolls["plain"] - rolls["plain f32"]).abs(),
                        0.0).max().item()
    check(moved > 1e-4, f"bf16 plain is only {moved} m from float32 plain")
    g_err = bench.graph_vs_eager(models["A"], xy_obs, mask, stats, K, stream)
    check(g_err <= GRAPH_TOL, f"bf16 A: graph vs eager {g_err} m")
    graphs = {name: bench.capture(lambda m=models[name]: m.rollout_k(xy_obs, mask, stats, K), dev)[0]
              for name in ("A", "A f32")}
    times = {name: [] for name in graphs}
    for r in range(20):
        for name in (("A", "A f32") if r % 2 == 0 else ("A f32", "A")):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    del graphs
    graph_ms = {name: statistics.median(v) for name, v in times.items()}
    eager_ms = {name: [] for name in ("A", "A f32")}
    for name in ("A", "A f32", "A f32", "A"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            models[name].rollout_k(xy_obs, mask, stats, K)
        torch.cuda.synchronize()
        eager_ms[name].append((time.perf_counter() - t0) * 1e2)
    summary["inference"] = {
        "launches": {k: counts[k] for k in want}, "metrics_ade_fde": metrics,
        "steps_rows_past": {k: [x[0] for x in v] for k, v in steps.items()},
        "steps_others_max": {k: max(x[2] for x in v) for k, v in steps.items()},
        "a_vs_f32_decoder_past": n_bad,
        "a_vs_f32_decoder_max_m": per[per <= ROLLOUT_TOL].max().item(),
        "bf16_vs_f32_plain_max_m": moved, "graph_vs_eager_m": g_err, "graphed_a_ms": graph_ms,
        "eager_a_ms": eager_ms}
    log(f"bf16 inference (B={B}, N={N}, K={K}): launches {summary['inference']['launches']} "
        f"(the float32 routes'); steps from the plain route's state, rows past "
        f"{BF16_STEP_RTOL}: {summary['inference']['steps_rows_past']} of {B * N} (encoder) and "
        f"{K * B * N} (decoder), others within {summary['inference']['steps_others_max']}; "
        f"route A vs the float32 decoder from its bf16 encoder: {n_bad} of {K * B} past "
        f"{ROLLOUT_TOL} m; best-of-{K} ADE/FDE {json.dumps(metrics)}; bf16 vs float32 plain "
        f"{moved:.3e} m; graph vs eager {g_err:.3e} m; graphed route A {graph_ms['A']:.4f} ms "
        f"bf16, {graph_ms['A f32']:.4f} ms float32 (medians of 20 replays in turns); eager "
        f"route A ms a call (10 calls, in turns) {json.dumps(eager_ms)}; {card}")

    # b. Training under bf16: use_pallas against plain, a graphed chunk, rates.
    TB, lr = cfg.train.batch_size, cfg.train.lr
    per_step = 2 * (TO + TP)
    xy, tmask = train_bench.fake_batch(TB, N, TO + TP, dev)
    tstats = NormStats(torch.zeros(2, device=dev), torch.ones(2, device=dev))
    train_rows = {}

    def flat(model):
        return torch.cat([p.detach().flatten() for p in model.parameters()])

    with torch.enable_grad():
        for loss_mode in ("nll", "variety"):
            runs = {}
            for use_pallas in (False, True):
                mc = bf16(dataclasses.replace(cfg.model, use_pallas=use_pallas))
                model = Forecaster(mc, TO, TP, device=dev, state=state)
                step = tr.make_train_step(model, tr.make_optimizer(cfg.replace(model=mc), model),
                                          tstats, loss_mode=loss_mode, variety_n=VARIETY_N)
                losses = []
                for s in range(TRAIN_STEPS):
                    loss, c = counted(lambda: step(xy, tmask, s))
                    w = {**zero, "fused_gat": per_step if use_pallas else 0,
                         "fused_gat_grad": GRAD_STEP if use_pallas else 0}
                    check(c == w, f"bf16 train {loss_mode} step {s}: launches {c}, want {w}")
                    losses.append(float(loss))
                runs[use_pallas] = (losses, flat(model))
            rel = [abs(a - c) / abs(c) for a, c in zip(runs[True][0], runs[False][0])]
            dp = (runs[True][1] - runs[False][1]).abs()
            share = (dp > PARAM_TOL).float().mean().item()
            check(rel[0] <= TRAIN_LOSS_RTOL and max(rel) <= BF16_LATER_LOSS_RTOL,
                  f"bf16 train {loss_mode}: losses {runs[True][0]} vs {runs[False][0]}")
            check(dp.max().item() <= 2 * lr * TRAIN_STEPS and share <= 0.01,
                  f"bf16 train {loss_mode}: parameters max |d| {dp.max().item()}, share {share}")
            train_rows[loss_mode] = {"losses": runs[True][0], "loss_rel": rel,
                                     "param_max_abs": dp.max().item(), "param_share": share}
            log(f"bf16 train {loss_mode} (B={TB}, {TRAIN_STEPS} steps): use_pallas losses "
                f"{runs[True][0]} vs plain {runs[False][0]} (rel {[f'{x:.2e}' for x in rel]}, "
                f"tol {TRAIN_LOSS_RTOL} at step 1, {BF16_LATER_LOSS_RTOL} after); parameters max "
                f"|d| {dp.max().item():.3e}, share past "
                f"{PARAM_TOL} {share:.2e}; fused_gat {per_step} launches a step")
        # one graphed chunk of CHUNK_M steps against as many eager steps
        mc = bf16(dataclasses.replace(cfg.model, use_pallas=True))
        xy_all, mask_all = train_bench.fake_batch(4 * TB, N, TO + TP, dev, seed=5)
        idx = np.stack([np.random.default_rng(6).permutation(4 * TB)[:TB] for _ in range(CHUNK_M)])
        me = Forecaster(mc, TO, TP, device=dev, state=state)
        step = tr.make_train_step(me, tr.make_optimizer(cfg.replace(model=mc), me), tstats)
        eager = [float(step(xy_all[torch.as_tensor(i, device=dev)],
                            mask_all[torch.as_tensor(i, device=dev)], s))
                 for s, i in enumerate(idx)]
        mg = Forecaster(mc, TO, TP, device=dev, state=state)
        multi = tr.make_multi_train_step(mg, tr.make_optimizer(cfg.replace(model=mc), mg), tstats)
        graphed, c = counted(lambda: multi(xy_all, mask_all, idx, range(CHUNK_M)).tolist())
        w = {**zero, "fused_gat": (tr.CAPTURE_WARMUP + 1) * per_step,
             "fused_gat_grad": (tr.CAPTURE_WARMUP + 1) * GRAD_STEP}
        check(c == w, f"bf16 graphed chunk: launches {c}, want {w}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(graphed, eager))
        dp = (flat(mg) - flat(me)).abs()
        check(rel <= TRAIN_LOSS_RTOL and dp.max().item() <= 2 * lr * CHUNK_M
              and (dp > PARAM_TOL).float().mean().item() <= 0.01,
              f"bf16 graphed chunk vs eager: losses {graphed} vs {eager}, params {dp.max().item()}")
        train_rows["graphed_chunk"] = {"loss_rel": rel, "param_max_abs": dp.max().item()}
        log(f"bf16 graphed chunk of {CHUNK_M} (use_pallas, nll) vs eager steps: losses within "
            f"{rel:.2e} relative, parameters max |d| {dp.max().item():.3e}")
        rates = {}
        for m_ in (1, CHUNK_M):
            for dtype in ("bfloat16", "float32"):
                r = train_bench.bench_train_step(TB, min_seconds=1.0, use_pallas=True, device=dev,
                                                 flops=False, steps_per_dispatch=m_,
                                                 model_kw={"dtype": dtype},
                                                 iters=TRAIN_BENCH_ITERS)
                rates.setdefault(f"{dtype} M={m_}", []).append(r.steps_per_sec)
                log("train_bench " + train_bench._fmt(r))
        train_rows["train_bench_steps_per_s"] = rates
    summary["training"] = train_rows

    # c. Checkpoints: .pt written, converted to .npz by the CLI, both evaluated.
    train_w, _ = load_split(str(EVAL_DATA), "univ", TO, TP)
    estats = compute_norm_stats(train_w, TO)
    eval_cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=str(EVAL_DATA)))
    tmp = Path(tempfile.mkdtemp(prefix="tmp_ckpt_", dir=Path(__file__).resolve().parent))
    real_load = registry.load_scene_windows
    try:
        pt, npz, plain_pt = (str(tmp / n) for n in ("route_a.pt", "route_a.npz", "plain.pt"))
        checkpoint.save(pt, state, estats, eval_cfg.replace(model=route_a), step=3)
        checkpoint.save(plain_pt, state, estats, eval_cfg.replace(model=plain_cfg), step=3)
        t0 = time.perf_counter()
        conv = subprocess.run([sys.executable, "-m", "mmtraj_torch.cli", "convert", "--src", pt,
                               "--dst", npz], cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=300)
        check(conv.returncode == 0, f"cli convert: {conv.returncode} {conv.stderr[-2000:]}")
        convert_s = time.perf_counter() - t0

        def cli_eval(path, *flags):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code, c = counted(lambda: torch_cli.main(["eval", "--ckpt", path, "--k", str(K),
                                                          "--device", str(dev), *flags]))
            check(code == 0, f"cli eval {path} {flags}: exit {code}")
            return out.getvalue().strip().splitlines()[-1], c

        line_pt, c_pt = cli_eval(pt)
        line_npz, c_npz = cli_eval(npz)
        check(line_pt == line_npz and c_pt == c_npz and c_pt["fused_decode"] > 0
              and c_pt["fused_gat"] == (TO + TP) * c_pt["fused_decode"],
              f"cli eval .pt vs .npz: {line_pt!r} vs {line_npz!r}, launches {c_pt} vs {c_npz}")
        registry.load_scene_windows = lambda *a, **kw: real_load(*a, **kw)[:EVAL_SUB]
        line_a, c_a = cli_eval(pt, "--dtype", "bfloat16")
        line_p, c_p = cli_eval(plain_pt, "--dtype", "bfloat16")
    finally:
        registry.load_scene_windows = real_load
        shutil.rmtree(tmp)
    check(c_p == zero and c_a["fused_decode"] > 0
          and c_a["fused_gat"] == (TO + TP) * c_a["fused_decode"],
          f"cli eval --dtype bfloat16 launches: route A {c_a}, plain {c_p}")
    nums_a, nums_p = dict(_LINE_NUMS.findall(line_a)), dict(_LINE_NUMS.findall(line_p))
    d_ade = abs(float(nums_a["ADE"]) - float(nums_p["ADE"]))
    d_fde = abs(float(nums_a["FDE"]) - float(nums_p["FDE"]))
    check(d_ade <= EVAL_ADE_TOL and d_fde <= EVAL_ADE_TOL,
          f"cli eval --dtype bfloat16: route A {line_a!r} vs plain {line_p!r}")
    summary["checkpoints"] = {"convert_s": convert_s, "eval_line": line_pt,
                              "bf16_eval_lines": {"A": line_a, "plain": line_p},
                              "bf16_d_ade_fde_m": [d_ade, d_fde]}
    log(f"checkpoints: .pt -> .npz by cli convert ({convert_s:.1f} s); cli eval of both: {line_pt}; "
        f"launches {c_pt}; cli eval --dtype bfloat16 on the first {EVAL_SUB} windows: route A "
        f"{line_a} (launches {c_a}), plain {line_p}; |d ADE| {d_ade:.2e} m, |d FDE| {d_fde:.2e} m "
        f"(tol {EVAL_ADE_TOL})")
    log("bf16 " + json.dumps(summary))


def serving_phase(torch, dev, card, cfg, routes, state, stats, xy_obs, mask, counted,
                  zero) -> None:
    """Phase 13: export and serving at config 4's full width, through the
    entry points ``export_predictor``, ``load_predictor``, ``PredictServer``,
    ``python -m mmtraj_torch.cli export``/``serve`` and ``serve_bench``.
    ``routes``: name -> (model config, launches of one ``rollout_k`` call)."""
    from mmtraj_torch.benchmarks import serve_bench
    from mmtraj_torch.benchmarks.bench import bench_inputs
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.export import (draw_stream, export_predictor, kernel_nodes, load_exported,
                                     load_predictor)
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.params import save_npz
    from mmtraj_torch.serve import PredictServer

    M = cfg.model.num_mixtures
    root = Path(__file__).resolve().parent
    rng = np.random.default_rng(2)
    sizes = [int(n) for n in rng.integers(5, 60, size=11)]
    lines = [json.dumps({"xy": xy_obs[j % B, :n].tolist(), "seed": 4,
                         "encoding": "b64-npy" if j % 2 else "json"})
             for j, n in enumerate(sizes)]
    lines.insert(5, "{not json")

    def cli_round_trip(tmp):
        """``python -m mmtraj_torch.cli export`` of a route-A checkpoint, then
        ``cli serve --aggregate 8`` over ``lines``, each a fresh process ->
        (export seconds, serve seconds, serve's run)."""
        ckpt = str(tmp / "route_a.npz")
        save_npz(ckpt, state, NormStats(*(t.cpu().numpy() for t in stats)),
                 cfg.replace(model=routes["A"][0]))
        art = str(tmp / "cli.pt2")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "mmtraj_torch.cli", "export", "--ckpt", ckpt,
                              "--out", art, "--batch", "8", "--k", str(K), "--device", dev.type],
                             capture_output=True, text=True, timeout=300, cwd=root)
        check(run.returncode == 0, f"cli export failed:\n{run.stdout}\n{run.stderr}")
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "mmtraj_torch.cli", "serve", "--artifact", art,
                              "--aggregate", "8", "--window-ms", "50"],
                             input="\n".join(lines) + "\n", capture_output=True, text=True,
                             timeout=300, cwd=root)
        return t_export, time.perf_counter() - t0, run

    nodes = {"A": {"mmtraj.fused_gat.default": TO, "mmtraj.fused_decode.default": 1},
             "B": {"mmtraj.attend.default": TO + TP}, "plain": {}}
    inputs = {B: (xy_obs, mask),
              SERVE_B: bench_inputs(np.random.default_rng(1), SERVE_B, N, TO, dev)}
    tmp = Path(tempfile.mkdtemp(prefix="tmp_serve_", dir=root))
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # The CLI's two processes run beside the in-process exports below.
            cli_job = pool.submit(cli_round_trip, tmp)

            # Each artifact against the live rollout_k on one stream, with its launches.
            outs = {}
            for name, batch in (("A", B), ("B", B), ("plain", B), ("A", SERVE_B)):
                model_cfg, per_call = routes[name]
                model = Forecaster(model_cfg, TO, TP, device=dev, state=state)
                path = str(tmp / f"{name}{batch}.pt2")
                t0 = time.perf_counter()
                export_predictor(path, model, None, stats, k=K, batch=batch, n_agents=N)
                t_export = time.perf_counter() - t0
                t0 = time.perf_counter()
                program, meta = load_exported(path)
                call = program.module()
                t_load = time.perf_counter() - t0
                check(kernel_nodes(program) == nodes[name],
                      f"artifact {name}{batch}: graph nodes {kernel_nodes(program)}")
                check(torch.device(meta["device"]).type == dev.type,
                      f"artifact {name}{batch}: device {meta['device']}")
                xy_b, m_b = inputs[batch]
                gumbel, normal = draw_stream(K * batch, TP, N, M, 5, dev)
                out, counts = counted(lambda: call(xy_b, m_b, gumbel, normal))
                check(counts == {**zero, **per_call},
                      f"artifact {name}{batch}: launches {counts}, expected {per_call}")
                live = model.rollout_k(xy_b, m_b, stats, K, stream=(gumbel, normal))
                check(out.shape == (K, batch, N, TP, 2) and bool(torch.isfinite(out).all()),
                      f"artifact {name}{batch}: shape {tuple(out.shape)} or not finite")
                err = torch.where(m_b[None, :, :, None, None], (out - live).abs(),
                                  0.0).max().item()
                check(err <= GRAPH_TOL, f"artifact {name}{batch} vs live rollout_k: {err} m")
                outs[name, batch] = out
                log(f"artifact {name} B={batch}: export {t_export:.2f} s, load {t_load:.2f} s, "
                    f"{os.path.getsize(path) / 1e6:.3f} MB; graph {kernel_nodes(program)}; "
                    f"launches a call {counts}; max abs err vs live rollout_k {err:.3e} m")
            for name in ("A", "B"):
                d = torch.where(mask[None, :, :, None, None],
                                (outs[name, B] - outs["plain", B]).abs(), 0.0)
                per = d.flatten(2).amax(2)
                n_bad = int((per > ROLLOUT_TOL).sum())
                check(n_bad <= MAX_DIVERGED * K * B,
                      f"artifact {name}: {n_bad} of {K * B} rollouts past {ROLLOUT_TOL} m of plain")
                log(f"artifact {name} vs plain artifact: {n_bad} of {K * B} rollouts past "
                    f"{ROLLOUT_TOL} m, max abs err {per[per <= ROLLOUT_TOL].max().item():.3e} m")

            # The seed: the same reproduces, another differs.
            a_path = str(tmp / f"A{B}.pt2")
            predict = load_predictor(a_path)
            (a, b, c), counts = counted(lambda: [predict(xy_obs, mask, s) for s in (3, 3, 4)])
            check(counts == {**zero, "fused_gat": 3 * TO, "fused_decode": 3},
                  f"load_predictor: launches {counts}")
            check(torch.equal(a, b), "load_predictor: the same seed did not reproduce")
            check(not torch.allclose(a[:, mask], c[:, mask]),
                  "load_predictor: seeds 3 and 4 agree")

            # A (3, 40) request through the server equals the manual padding's slice.
            server = PredictServer(a_path)
            xy_np, m_np = xy_obs.cpu().numpy()[:3, :40], mask.cpu().numpy()[:3, :40]
            got, counts = counted(lambda: server.predict(xy_np, m_np, seed=11))
            check(counts == {**zero, "fused_gat": TO, "fused_decode": 1},
                  f"PredictServer: launches {counts}")
            xy_p = np.zeros((B, N, TO, 2), np.float32)
            xy_p[:3, :40] = xy_np
            m_p = np.zeros((B, N), bool)
            m_p[:3, :40] = m_np
            want = predict(xy_p, m_p, 11).cpu().numpy()[:, :3, :40]
            check(got.shape == (K, 3, 40, TP, 2) and np.array_equal(got, want),
                  f"PredictServer (3, 40): {got.shape}, max diff {np.abs(got - want).max()}")

            # The CLI: one error line for the malformed request, the rest answered.
            t_export, t_serve, run = cli_job.result()
        check(run.returncode == 0, f"cli serve failed:\n{run.stderr}")
        answers = [json.loads(x) for x in run.stdout.strip().splitlines()]
        check(len(answers) == 12 and "JSONDecodeError" in answers[5].get("error", ""),
              f"cli serve: {len(answers)} answers, line 6 {str(answers[5])[:200]}")
        for ans, n in zip(answers[:5] + answers[6:], sizes):
            shape = tuple(ans.get("shape") or np.asarray(ans.get("pred")).shape)
            check(shape == (K, n, TP, 2), f"cli serve: answer shape {shape} for {n} agents")
        check("served 11 request(s)" in run.stderr, f"cli serve stderr: {run.stderr[-500:]}")
        log(f"cli export {t_export:.2f} s, cli serve of 12 lines (one malformed) {t_serve:.2f} s "
            f"(each a fresh process, beside the exports above): " + " | ".join(
                x for x in run.stderr.splitlines() if x.startswith("serving")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # serve_bench: cold start, latency and sustained rate of route A at B = 25.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_bench.main(["--batches", str(B), "--k", str(K), "--iters", "10", "--scan-iters",
                          "20", "--route", "A", "--device", dev.type])
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(row["card"] == card and len(row["batches"]) == 1, f"serve_bench line {row}")
    print(json.dumps(row), flush=True)


def scale_out_phase(torch, dev, card, cfg, counted, zero, results) -> None:
    """Phase 14: scale-out at config 4's full width.  The lane-batched
    ``fused_gat_lanes`` against its plain version; a population of
    ``POP_SEEDS`` seeds (B = 16 each, ``use_pallas``, graphed chunks of
    ``CHUNK_M``) against a sequential graphed run of each seed, with exact
    launches a population step, seed-steps/s of both and the peak memory,
    and ``fit_population`` end to end; config 5 (B = 256) data-parallel
    over NCCL at world size 1, graphed and through ``fit``, equal to the bit
    to the same runs without a mesh, with ``evaluate(mesh=)`` equal to
    ``evaluate()``; the streamed ``fit`` against the resident one, and
    ``stream_bench`` at a reduced size."""
    import torch.distributed as dist

    from mmtraj_torch import population as popm
    from mmtraj_torch import train as tr
    from mmtraj_torch.benchmarks import stream_bench, train_bench
    from mmtraj_torch.config import config5
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.ops import _build, fused_gat
    from mmtraj_torch.parallel import make_mesh
    from mmtraj_torch.params import init_params
    from mmtraj_torch.utils.logging import MetricsLogger

    TB, M, S, H = cfg.train.batch_size, CHUNK_M, len(POP_SEEDS), cfg.model.num_heads
    stats = NormStats(torch.zeros(2, device=dev), torch.ones(2, device=dev))
    states = [init_params(cfg.model, torch.Generator().manual_seed(s)) for s in POP_SEEDS]
    summary = {"card": card}

    # a. fused_gat_lanes at (S, B, N, D) against gat_math lane by lane.
    rng = np.random.default_rng(14)
    h = torch.tensor(rng.normal(size=(S, TB, N, 64)), dtype=torch.float32, device=dev)
    att = torch.tensor(rng.random((S, TB, N, N)) < 0.3, dtype=torch.float32, device=dev)
    att[:, :, -1] = 0.0
    ws = [torch.stack([st[f"enc.gat.{k}"] for st in states]).to(dev)
          for k in ("wv", "a_src", "a_dst", "wo", "bo")]
    args = (h, att, *ws, H)

    def plain_lanes():
        return torch.stack([fused_gat.gat_math(*(t[i] for t in args[:-1]), H) for i in range(S)])

    out_k, out_p = fused_gat.fused_gat_lanes(*args), plain_lanes()
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
          f"fused_gat_lanes vs plain: max abs err {err}")
    # Lane i runs a single launch's code on lane i's graphs and weights
    # (gat.cu's Dims::lane offsets only the weight pointers): equal to the bit.
    for i in range(S):
        one = fused_gat.fused_gat(*(t[i] for t in args[:-1]), H)
        check(torch.equal(out_k[i], one), f"fused_gat_lanes lane {i} vs a single fused_gat "
                                          f"launch: max |d| {(out_k[i] - one).abs().max().item()}")
    log(f"fused_gat_lanes: each of the {S} lanes equals a single fused_gat launch on its graphs "
        f"and weights to the bit")
    hd, dout = ws[0].shape[-1], ws[3].shape[-1]
    results["fused_gat_lanes"] = dict(
        occupancy=_build.occupancy("gat", N, 64, H, hd, dout), max_abs_err=err,
        ms=time_ms(torch, lambda: fused_gat.fused_gat_lanes(*args)),
        plain_ms=time_ms(torch, plain_lanes), cost=lanes_cost(S, TB, N, 64, hd, H, dout))
    r = results["fused_gat_lanes"]
    log(f"fused_gat_lanes {(S, TB, N, 64)} H={H}: max abs err {err:.3e} (tol {KERNEL_TOL}); "
        f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{bound(*r['cost'][:2])[0]:.6f} ms, tc bound {tc_bound(*r['cost']):.6f} ms")

    # b. The population against sequential graphed runs, step by step.
    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas=True))
    xy_all, mask_all = train_bench.fake_batch(8 * TB, N, TO + TP, dev, seed=7)
    idx = np.stack([np.stack([np.random.default_rng([s, k]).permutation(8 * TB)[:TB]
                              for s in POP_SEEDS]) for k in range(POP_STEPS)])  # (steps, S, B)
    per_pop_step = {**zero, "fused_gat": TO + TP, "fused_gat_lanes": TO + TP,
                    "weight_grad_lanes": WGRAD_STEP, "fused_gat_grad": GRAD_STEP}
    with torch.enable_grad():
        params = popm.stack_lanes(states, dev)
        model = popm.lane_model(pcfg, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        popt = tr.Optimizer(params, pcfg, lanes=True)
        pop = popm.make_population_step(model, params, popt, stats, POP_SEEDS, loss_mode="nll")
        pop_losses, pop_s = [], []
        for k in range(POP_STEPS // M):
            t0 = time.perf_counter()
            losses, counts = counted(lambda: pop(xy_all, mask_all, idx[k * M:(k + 1) * M],
                                                 range(k * M, (k + 1) * M)))
            pop_s.append(time.perf_counter() - t0)
            pop_losses.append(losses.cpu().numpy())
            n = tr.CAPTURE_WARMUP + 1 if k == 0 else 0
            check(counts == {key: n * v for key, v in per_pop_step.items()},
                  f"population chunk {k}: launches {counts}, want {n} x {per_pop_step}")
        pop_peak = torch.cuda.max_memory_allocated() - base_mem
        pop_losses = np.concatenate(pop_losses)  # (steps, S)
        seq_s, worst, lane_rows = [], 0.0, {}
        for i, seed in enumerate(POP_SEEDS):
            m_ = Forecaster(pcfg.model, TO, TP, device=dev, state=states[i])
            multi = tr.make_multi_train_step(m_, tr.make_optimizer(pcfg, m_), stats, seed=seed)
            seq = []
            for k in range(POP_STEPS // M):
                t0 = time.perf_counter()
                losses, _ = counted(lambda: multi(xy_all, mask_all, idx[k * M:(k + 1) * M, i],
                                                  range(k * M, (k + 1) * M)))
                seq.append(losses.cpu().numpy())
                seq_s.append(time.perf_counter() - t0)
            seq = np.concatenate(seq)
            rel = np.abs(pop_losses[:, i] - seq) / np.abs(seq)
            check(rel[0] <= TRAIN_LOSS_RTOL and np.isfinite(pop_losses[:, i]).all(),
                  f"population lane {seed} vs its sequential run: rel {rel.tolist()}")
            past = np.nonzero(rel > TRAIN_LOSS_RTOL)[0]
            lane_rows[seed] = {"loss_rel_step1": float(rel[0]), "loss_rel_max": float(rel.max()),
                               "first_step_past_1e-5": int(past[0]) + 1 if len(past) else None}
            worst = max(worst, float(rel.max()))

        # One more step of every lane (eager), each from the lane's own state,
        # against one sequential step from that state on the same batch.
        idx_next = np.stack([np.random.default_rng([s, POP_STEPS]).permutation(8 * TB)[:TB]
                             for s in POP_SEEDS])[None]  # (1, S, B)
        snap = {k_: v.detach().clone() for k_, v in params.items()}
        leaves = [popt.state_leaves(i) for i in range(S)]
        synced, counts = counted(lambda: pop(xy_all, mask_all, idx_next, [POP_STEPS]))
        check(counts == per_pop_step, f"population eager step: launches {counts}")
        synced = synced.cpu().numpy()[0]
        for i, seed in enumerate(POP_SEEDS):
            m_ = Forecaster(pcfg.model, TO, TP, device=dev,
                            state={k_: v[i] for k_, v in snap.items()})
            o_ = tr.make_optimizer(pcfg, m_)
            o_.load_state_leaves(leaves[i])
            rows = torch.as_tensor(idx_next[0, i], device=dev)
            want = float(tr.make_train_step(m_, o_, stats, seed=seed)(
                xy_all[rows], mask_all[rows], POP_STEPS))
            rel = abs(float(synced[i]) - want) / abs(want)
            dp = (torch.cat([params[k_][i].detach().flatten() for k_ in sorted(params)])
                  - torch.cat([dict(m_.named_parameters())[k_].detach().flatten()
                               for k_ in sorted(params)])).abs()
            share = (dp > PARAM_TOL).float().mean().item()
            check(rel <= TRAIN_LOSS_RTOL and dp.max().item() <= 2 * pcfg.train.lr
                  and share <= 0.01, f"population lane {seed}, step {POP_STEPS + 1} from its own "
                  f"state: loss rel {rel}, parameters max |d| {dp.max().item()}, share {share}")
            lane_rows[seed].update({"synced_loss_rel": rel, "synced_param_max_abs": dp.max().item(),
                                    "synced_param_share_past_1e-4": share})
    pop_ms = pop_s[-1] / M * 1e3
    seq_ms = statistics.median(seq_s[1::POP_STEPS // M]) / M * 1e3  # each run's replay chunk
    summary["population"] = {
        "seeds": S, "batch": TB, "steps_per_dispatch": M, "fused_gat_a_step": TO + TP,
        "loss_max_rel_vs_sequential": worst, "population_ms_a_step": pop_ms,
        "sequential_ms_a_step": seq_ms, "seed_steps_per_s": S / pop_ms * 1e3,
        "sequential_seed_steps_per_s": 1e3 / seq_ms, "peak_mib": pop_peak / 2**20,
        "first_chunk_s": pop_s[0], "lanes": lane_rows}
    log(f"population S={S} B={TB} use_pallas M={M}: fused_gat {TO + TP} launches a step (one "
        f"lane-batched launch a GAT call); {POP_STEPS} steps a lane against its sequential "
        f"graphed run: step 1 within {TRAIN_LOSS_RTOL} relative, then apart by up to "
        f"{worst:.2e} (Adam's amplification); step {POP_STEPS + 1} from each lane's own state "
        f"against its sequential step: {json.dumps(lane_rows)}; "
        f"{pop_ms:.2f} ms a population step ({S / pop_ms * 1e3:.1f} seed-steps/s) against "
        f"{seq_ms:.2f} ms a sequential step ({1e3 / seq_ms:.1f}); peak "
        f"{pop_peak / 2**20:.1f} MiB above the start; first chunk {pop_s[0]:.2f} s")

    # c. fit_population end to end (on the in-repo data, univ held out), route
    # A: the lanes train through fused_gat_lanes, each seed's final evaluate
    # runs fused_gat and fused_decode.
    route_a = dataclasses.replace(pcfg.model, use_fused_decoder=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp_pop_", dir=Path(__file__).resolve().parent))
    try:
        fcfg = pcfg.replace(
            model=route_a, data=dataclasses.replace(pcfg.data, data_dir=str(EVAL_DATA)),
            train=dataclasses.replace(pcfg.train, steps=POP_STEPS, steps_per_dispatch=M,
                                      eval_every=0, log_every=M, k_samples=K,
                                      out_dir=str(tmp)))
        t0 = time.perf_counter()
        with torch.enable_grad():
            res, counts = counted(lambda: popm.fit_population(
                fcfg, POP_SEEDS, device=dev, logger=MetricsLogger(None, quiet=True)))
        fit_pop_s = time.perf_counter() - t0
        check(len(res) == S and all((tmp / f"s{s}" / "checkpoint.npz").exists()
                                    for s in POP_SEEDS), "fit_population: a seed's checkpoint")
        for r_ in res:
            m = r_.eval_metrics
            check(all(math.isfinite(m[k]) for k in ("min_ade", "min_fde", "nll")),
                  f"fit_population eval: {m}")
            check(np.mean([v for _, v in r_.history]) > 0, "fit_population history")
    finally:
        shutil.rmtree(tmp)
    summary["fit_population_s"] = fit_pop_s
    log(f"fit_population S={S} route A on data/synthetic3000 ({POP_STEPS} steps, M={M}, "
        f"final eval K={K} a seed): {fit_pop_s:.1f} s; launches {counts}; min_ade a seed "
        f"{[round(r_.eval_metrics['min_ade'], 4) for r_ in res]}")

    # d. Config 5: data-parallel over NCCL at world size 1, equal to the bit.
    c5 = config5()
    c5 = c5.replace(model=dataclasses.replace(c5.model, use_pallas=True, use_fused_decoder=True))
    B5 = c5.train.batch_size
    mesh = make_mesh(device=dev)
    try:
        xy5, mask5 = train_bench.fake_batch(2 * B5, N, TO + TP, dev, seed=8)
        idx5 = np.stack([np.random.default_rng(k).permutation(2 * B5)[:B5]
                         for k in range(C5_STEPS)])
        runs, ms5 = {}, {}
        with torch.enable_grad():
            for label, mesh_ in (("data_parallel", mesh), ("single", None)):
                m5 = Forecaster(c5.model, TO, TP, device=dev, state=states[0])
                multi = tr.make_multi_train_step(m5, tr.make_optimizer(c5, m5), stats,
                                                 seed=0, mesh=mesh_)
                losses, times = [], []
                for k in range(C5_STEPS // M):
                    t0 = time.perf_counter()
                    out, _ = counted(lambda: multi(xy5, mask5, idx5[k * M:(k + 1) * M],
                                                   range(k * M, (k + 1) * M)))
                    losses.append(out.cpu().numpy())
                    times.append(time.perf_counter() - t0)
                runs[label] = (np.concatenate(losses),
                               torch.cat([p.detach().flatten() for p in m5.parameters()]))
                ms5[label] = times[-1] / M * 1e3
        same = (np.array_equal(runs["data_parallel"][0], runs["single"][0])
                and torch.equal(runs["data_parallel"][1], runs["single"][1]))
        check(same, "config 5: the data-parallel graphed run differs from the single-process one")
        # fit with --data-parallel (its evaluate runs on the mesh) against fit without.
        fit5 = c5.replace(data=dataclasses.replace(c5.data, data_dir=str(EVAL_DATA)),
                          train=dataclasses.replace(c5.train, steps=C5_FIT_STEPS,
                                                    steps_per_dispatch=M, eval_every=0,
                                                    log_every=1, k_samples=K, out_dir=""))
        with torch.enable_grad():
            dp_fit, counts5 = counted(lambda: tr.fit(fit5, device=dev, mesh=mesh,
                                                     logger=MetricsLogger(None, quiet=True)))
            single_fit, _ = counted(lambda: tr.fit(
                fit5.replace(train=dataclasses.replace(fit5.train, data_parallel=False)),
                device=dev, logger=MetricsLogger(None, quiet=True)))
        check(dp_fit.history == single_fit.history
              and all(torch.equal(dp_fit.state[k], single_fit.state[k]) for k in dp_fit.state),
              "config 5: fit --data-parallel differs from fit")
        check(dp_fit.eval_metrics == single_fit.eval_metrics,
              f"config 5: evaluate(mesh=) {dp_fit.eval_metrics} != evaluate() "
              f"{single_fit.eval_metrics}")
    finally:
        dist.destroy_process_group()
    summary["config5"] = {"batch": B5, "world_size": 1, "graphed_ms_a_step": ms5,
                          "bit_identical": True, "fit_launches": counts5}
    log(f"config 5 (B={B5}, route A, M={M}) --data-parallel over NCCL at world size 1: "
        f"{C5_STEPS} graphed steps equal to the single-process run to the bit; "
        f"{ms5['data_parallel']:.2f} ms a step (single {ms5['single']:.2f}); fit "
        f"{C5_FIT_STEPS} steps --data-parallel equal to fit to the bit, evaluate(mesh=) equal "
        f"to evaluate(): min_ade {dp_fit.eval_metrics['min_ade']:.6f}")

    # e. The streamed fit against the resident one, and stream_bench.
    scfg = cfg.replace(model=route_a, data=dataclasses.replace(cfg.data, data_dir=str(EVAL_DATA)),
                       train=dataclasses.replace(cfg.train, steps=STREAM_STEPS, eval_every=0,
                                                 log_every=1, k_samples=K, out_dir=""))
    with torch.enable_grad():
        t0 = time.perf_counter()
        resident = tr.fit(scfg, device=dev, logger=MetricsLogger(None, quiet=True))
        t_res = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = tr.fit(scfg.replace(train=dataclasses.replace(scfg.train, stream=True)),
                          device=dev, logger=MetricsLogger(None, quiet=True))
        t_str = time.perf_counter() - t0
        check(streamed.history == resident.history
              and all(torch.equal(streamed.state[k], resident.state[k]) for k in resident.state)
              and streamed.eval_metrics == resident.eval_metrics,
              "fit(stream=True) differs from the resident fit")
        sb = stream_bench.bench_ingest(STREAM_BENCH_WINDOWS, STREAM_BENCH_B, STREAM_BENCH_STEPS,
                                       N, "float32", warmup=2, device=dev)
    check(sb["resident_steps_per_sec"] > 0 and sb["stream_steps_per_sec"] > 0, f"{sb}")
    summary["stream"] = {"fit_steps": STREAM_STEPS, "resident_fit_s": t_res,
                         "stream_fit_s": t_str, "stream_bench": sb}
    log(f"fit(stream=True) equals the resident fit to the bit over {STREAM_STEPS} steps and "
        f"its eval ({t_str:.1f} s against {t_res:.1f} s with the final eval); stream_bench "
        f"({STREAM_BENCH_WINDOWS} windows, B={STREAM_BENCH_B}): resident "
        f"{sb['resident_steps_per_sec']:.3f}, stream {sb['stream_steps_per_sec']:.3f} steps/s")
    log("scale-out " + json.dumps(summary))


_ROW = re.compile(r"seed=(\d+) scene=(\w+): ADE=([-\d.]+) FDE=([-\d.]+)")
_LOG = re.compile(r"\[step +\d+ t= *([\d.]+)s\] (.*)")


def fold_times(out: str) -> list:
    """A ``train --scene all`` run's MetricsLogger lines -> per fold (set-up
    s, training s, final evaluations s): the set-up line's ``setup_s``, then
    the logger's clock (from the end of set-up) at the final checkpoint and
    at the last evaluation."""
    folds = []
    for t, rest in _LOG.findall(out):
        if "event=setup" in rest:
            folds.append([float(re.search(r"setup_s=([\d.]+)", rest).group(1)), None, None])
        elif "event=checkpoint" in rest:
            folds[-1][1] = float(t)
        elif "eval_min_ade" in rest:
            folds[-1][2] = round(float(t) - folds[-1][1], 3)
    return folds


def protocol_phase(torch, dev, card, counted, zero) -> None:
    """Phase 15: the leave-one-out protocol and its tools at config 4's full
    width, through ``python -m mmtraj_torch.cli`` (in-process unless named):
    ``generate-data`` of ``data/synthetic3000`` (a child process; byte-equal
    files) and ``baseline --scene all`` for cv and zv (child processes);
    ``train --scene all --use-pallas --seeds 0 1 --vmap-seeds`` on a small
    synthetic tree with exact launches and the mean±std table; ``eval-loo``
    plain and ``--ensemble`` with exact launches, one fold's row equal to
    ``cli eval`` of its checkpoint to the bit; one eager fold under
    ``--profile``, its trace's ``gat_kernel`` occurrences equal to the
    launch counter, ``profile-stats``, and the same fold under
    ``--debug-nans`` (chunks of 2, run eagerly) equal to the bit; the
    occupancy bench (routes plain and A) and its evaluate wall on
    ``mixed`` with exact launches; ``mmtraj_torch.entry.entry()``."""
    from mmtraj_torch import cli as torch_cli
    from mmtraj_torch import entry
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch import train as tr
    from mmtraj_torch.benchmarks import occupancy_bench as occ
    from mmtraj_torch.config import SCENES
    from mmtraj_torch.data.registry import load_scene_windows
    from mmtraj_torch.params import load_npz
    from mmtraj_torch.utils import profiling

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="tmp_protocol_", dir=root))
    summary = {"card": card}
    seeds = [str(x) for x in LOO_SEEDS]
    per_batch = TO + 2 * TP  # fused_gat a batch: encoder, teacher-forced NLL, rollout steps

    def cli(argv):
        """``cli.main(argv)`` with its launches -> (stdout, stderr, counts)."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code, counts = counted(lambda: torch_cli.main(argv))
        check(code == 0, f"cli {argv[0]}: exit {code}\n{err.getvalue()[-2000:]}")
        return out.getvalue(), err.getvalue(), counts

    on_card = ["--device", dev.type]
    jobs = {}
    try:
        # a. The synthetic dataset and the baselines, in child processes
        # beside the card's work.
        gen_dir = tmp / "synthetic3000"
        jobs.update({name: subprocess.Popen([sys.executable, "-m", "mmtraj_torch.cli", *argv],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                       cwd=root)
                for name, argv in (
                    ("generate-data", ["generate-data", "--data-dir", str(gen_dir), "--seed", "0",
                                       "--n-frames", "3000"]),
                    ("baseline cv", ["baseline", "--data-dir", str(EVAL_DATA), "--scene", "all",
                                     "--baseline", "cv"]),
                    ("baseline zv", ["baseline", "--data-dir", str(EVAL_DATA), "--scene", "all",
                                     "--baseline", "zv"]))})

        # b. train --scene all, a population of two seeds a fold.
        data = str(tmp / "data")
        t0 = time.perf_counter()
        out, _, _ = cli(["generate-data", "--data-dir", data, "--n-frames", str(LOO_FRAMES)])
        n_test = {sc: len(load_scene_windows(data, sc, TO, TP)) for sc in SCENES}
        loo = str(tmp / "loo")
        with torch.enable_grad():
            out, _, counts = cli(["train", "--config", "4", "--use-pallas", "--scene", "all",
                                  "--seeds", *seeds, "--vmap-seeds", "--steps", str(LOO_STEPS),
                                  "--steps-per-dispatch", str(LOO_M), "--data-dir", data,
                                  "--out-dir", loo] + on_card)
        loo_s = time.perf_counter() - t0
        capture = (tr.CAPTURE_WARMUP + 1) * (TO + TP)
        want = {**zero, "fused_gat_lanes": len(SCENES) * capture,
                "fused_gat": len(SCENES) * capture + sum(
                    len(LOO_SEEDS) * math.ceil(n / 16) * per_batch for n in n_test.values()),
                "weight_grad_lanes": len(SCENES) * (tr.CAPTURE_WARMUP + 1) * WGRAD_STEP,
                "fused_gat_grad": len(SCENES) * (tr.CAPTURE_WARMUP + 1) * GRAD_STEP}
        check(counts == want, f"train --scene all: launches {counts}, want {want}")
        table = out[out.index("\nleave-one-out (config 4"):].strip().splitlines()
        rows = [r for r in table if r.split()[0] in SCENES + ("AVG",)]
        check(len(rows) == len(SCENES) + 1 and all(
            math.isfinite(float(x)) for r in rows for x in re.findall(r"[-\d.]+(?=±)", r)),
              f"train --scene all table: {table}")
        check(all((Path(loo) / f"s{sd}" / sc / "checkpoint.npz").exists()
                  for sd in LOO_SEEDS for sc in SCENES), "train --scene all: a fold's checkpoint")
        folds = fold_times(out)
        check(len(folds) == len(SCENES) and all(None not in f for f in folds),
              f"train --scene all: fold times {folds}")
        log(f"train --scene all --use-pallas --seeds {' '.join(seeds)} --vmap-seeds "
            f"({LOO_STEPS} steps a fold, M={LOO_M}; {LOO_FRAMES}-frame synthetic scenes, test "
            f"windows {n_test}): {loo_s:.1f} s ({loo_s / len(SCENES):.1f} s a fold; set-up, "
            f"training, final evaluations a fold {folds} s); launches {counts}; {card}")
        for line in table:
            log("  " + line)
        summary["train_loo"] = {"seconds": loo_s, "fold_s": loo_s / len(SCENES),
                                "setup_train_eval_s": folds, "launches": counts,
                                "test_windows": n_test}

        # c. eval-loo, plain and --ensemble; a fold's row against cli eval.
        seen = []
        real_evaluate = ev.evaluate

        def spy(*a, **kw):
            m = real_evaluate(*a, **kw)
            seen.append(m)
            return m

        ev.evaluate = spy
        try:
            t0 = time.perf_counter()
            out, _, counts = cli(["eval-loo", "--loo-dir", loo] + on_card)
            plain_s = time.perf_counter() - t0
            want = {**zero, "fused_gat": sum(len(LOO_SEEDS) * math.ceil(n / 12) * per_batch
                                             for n in n_test.values())}
            check(counts == want, f"eval-loo: launches {counts}, want {want}")
            first = seen[0]
            check(len(seen) == len(SCENES) * len(LOO_SEEDS) and all(
                math.isfinite(m[k]) for m in seen for k in ("min_ade", "min_fde")),
                  f"eval-loo: {len(seen)} folds")
            rows = _ROW.findall(out)
            check(len(rows) == len(seen) and rows[0][:2] == (seeds[0], SCENES[0]),
                  f"eval-loo rows {rows}")
            log(f"eval-loo ({plain_s:.1f} s; launches {counts}):")
            for line in out.strip().splitlines():
                log("  " + line)
            seen.clear()
            ckpt = str(Path(loo) / f"s{seeds[0]}" / SCENES[0] / "checkpoint.npz")
            line, _, _ = cli(["eval", "--ckpt", ckpt] + on_card)
            check(seen == [first], f"eval-loo's {SCENES[0]} row {first} != cli eval's {seen}")
            log(f"cli eval of s{seeds[0]}/{SCENES[0]}: {line.strip()}; its metrics equal "
                f"eval-loo's row to the bit")
            t0 = time.perf_counter()
            out, _, counts = cli(["eval-loo", "--loo-dir", loo, "--ensemble"] + on_card)
            ens_s = time.perf_counter() - t0
            want = {**zero, "fused_gat": sum(math.ceil(n / 6) * len(LOO_SEEDS) * per_batch
                                             for n in n_test.values())}
            check(counts == want, f"eval-loo --ensemble: launches {counts}, want {want}")
            check(out.count("ensemble[2] scene=") == len(SCENES), f"eval-loo --ensemble: {out}")
            log(f"eval-loo --ensemble ({ens_s:.1f} s; launches {counts}):")
            for line in out.strip().splitlines()[-len(SCENES) - 3:]:
                log("  " + line)
        finally:
            ev.evaluate = real_evaluate
        summary["eval_loo_s"] = {"plain": plain_s, "ensemble": ens_s}

        # d. One eager fold under --profile and under --debug-nans.
        fold = ["train", "--config", "4", "--use-pallas", "--scene", PROFILE_SCENE, "--steps",
                str(PROFILE_STEPS), "--data-dir", data] + on_card
        prof_dir = tmp / "profiled"
        with torch.enable_grad():
            t0 = time.perf_counter()
            out, _, counts = cli(fold + ["--out-dir", str(prof_dir), "--profile"])
            prof_s = time.perf_counter() - t0
        want = {**zero, "fused_gat": PROFILE_STEPS * 2 * (TO + TP)
                + math.ceil(n_test[PROFILE_SCENE] / 16) * per_batch,
                "fused_gat_grad": PROFILE_STEPS * GRAD_STEP}
        check(counts == want, f"profiled fold: launches {counts}, want {want}")
        by_cat, top = profiling.summarize_trace(str(prof_dir / "profile"), top=10**9)
        in_trace = sum(occ_ for _, cat, name, occ_ in top if "gat_kernel" in name)
        trace = next((prof_dir / "profile").glob("*.pt.trace.json"))
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in json.load(open(trace))["traceEvents"]
                 if e.get("ph") == "X" and "ts" in e]
        span_us = max(b for _, b in spans) - min(a for a, _ in spans)
        busy = sum(by_cat.values()) / span_us
        check(in_trace == counts["fused_gat"],
              f"trace: {in_trace} gat_kernel events, {counts['fused_gat']} launches counted")
        stats_out, _, _ = cli(["profile-stats", "--trace-dir", str(prof_dir / "profile"),
                               "--top", "8"])
        check(stats_out.startswith("device time by category"), f"profile-stats: {stats_out}")
        log(f"profiled fold ({PROFILE_SCENE} held out, {PROFILE_STEPS} eager steps and the final "
            f"eval, {prof_s:.1f} s; the trace spans {span_us / 1e6:.3f} s, device busy "
            f"{busy:.3f}; {os.path.getsize(trace) / 1e6:.1f} MB): the trace's gat_kernel events "
            f"{in_trace} = fused_gat launches counted; cli profile-stats:")
        for line in stats_out.strip().splitlines():
            log("  " + line)
        nan_dir = tmp / "debug_nans"
        try:
            with torch.enable_grad():
                t0 = time.perf_counter()
                _, err, _ = cli(fold + ["--out-dir", str(nan_dir), "--debug-nans",
                                        "--steps-per-dispatch", "2"])
                nan_s = time.perf_counter() - t0
        finally:
            profiling.disable_nan_debugging()
        check("debug-nans: each step of a chunk runs eagerly" in err,
              f"--debug-nans with chunks: stderr {err[-500:]}")
        a = load_npz(str(prof_dir / "checkpoint.npz")).state
        b = load_npz(str(nan_dir / "checkpoint.npz")).state
        losses = [[r["loss"] for r in map(json.loads, open(d / "metrics.jsonl")) if "loss" in r]
                  for d in (prof_dir, nan_dir)]
        check(all(torch.equal(a[k], b[k]) for k in a) and losses[0] == losses[1],
              "--debug-nans: the fold differs from the profiled one")
        log(f"--debug-nans fold (chunks of 2 run eagerly, {nan_s:.1f} s): parameters and losses "
            f"equal to the profiled fold's to the bit")
        summary["profile"] = {"fold_s": prof_s, "debug_nans_s": nan_s, "device_us": by_cat,
                              "trace_span_us": span_us, "device_busy": busy,
                              "gat_kernel_events": in_trace}

        # e. The occupancy bench, routes plain and A, and its evaluate wall.
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code, counts = counted(lambda: occ.main(["--iters", str(OCC_ITERS)]))
        occ_s = time.perf_counter() - t0
        per_capture = 4  # bench.capture: 3 warm-up calls and the capture
        want = {**zero, "fused_gat": len(occ.BUCKETS) * per_capture * TO,
                "fused_decode": len(occ.BUCKETS) * per_capture}
        check(code == 0 and counts == want, f"occupancy bench: launches {counts}, want {want}")
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(res["card"] == card and set(occ.BENCH_ROUTES) <= set(res), f"occupancy: {res}")
        speedups = {r: {w: res[r]["workloads"][w]["speedup"] for w in occ.WORKLOADS}
                    for r in occ.BENCH_ROUTES}
        log(f"occupancy bench ({occ_s:.1f} s; iters {OCC_ITERS}; launches {counts}) bucketed/"
            f"padded speed-up {json.dumps(speedups)}:")
        print(json.dumps(res), flush=True)
        model_a, _ = occ.make_model("A", dev)
        windows, wcounts = occ.wall_windows("mixed", OCC_WALL_WINDOWS, np.random.default_rng(2))
        bks = np.searchsorted(occ.BUCKETS, wcounts, side="left")
        batches = sum(math.ceil(int((bks == i).sum()) / occ.bucket_batch(model_a, K, nb))
                      for i, nb in enumerate(occ.BUCKETS))
        batches += math.ceil(OCC_WALL_WINDOWS / occ.bucket_batch(model_a, K, N))  # padded
        t0 = time.perf_counter()
        wall, counts = counted(lambda: occ.run_evaluate_wall(K, OCC_WALL_WINDOWS, "A", dev,
                                                             workloads=("mixed",)))
        wall_s = time.perf_counter() - t0
        want = {**zero, "fused_gat": 2 * batches * (TO + TP), "fused_decode": 2 * batches}
        check(counts == want, f"evaluate wall: launches {counts}, want {want}")
        m = wall["mixed"]
        check(m["ade_delta"] < occ.ADE_GATE, f"evaluate wall: {m}")
        log(f"evaluate wall, route A, {OCC_WALL_WINDOWS} mixed windows ({wall_s:.1f} s): padded "
            f"{m['padded']['windows_per_sec']:.1f}, bucketed {m['bucketed']['windows_per_sec']:.1f}"
            f" windows/s (x{m['speedup']:.3f}); |d ADE| {m['ade_delta']:.3e} m (gate "
            f"{occ.ADE_GATE}); launches {counts} ({batches} batches, each twice); {card}")
        summary["occupancy"] = {"seconds": occ_s, "speedup": speedups, "wall_mixed_A": m}

        # f. The entry contract's entry().
        fn, example = entry.entry()
        loss, counts = counted(lambda: fn(*example))
        check(bool(torch.isfinite(loss)) and counts == {**zero, "fused_gat": TO + TP},
              f"entry(): loss {loss}, launches {counts}")
        log(f"entry(): config 4 nll loss {float(loss):.6f} at B=8, N=16 on {example[1].device}, "
            f"fused_gat {counts['fused_gat']} launches")

        # a, continued: the child processes.
        for name, job in jobs.items():
            out, err = job.communicate(timeout=300)
            check(job.returncode == 0, f"cli {name}: exit {job.returncode}\n{err[-2000:]}")
            if name == "generate-data":
                same = [f.name for f in sorted(EVAL_DATA.glob("*.txt"))
                        if (gen_dir / f.name).read_bytes() == f.read_bytes()]
                check(len(same) == len(SCENES), f"generate-data: only {same} equal "
                                                f"data/synthetic3000")
                log(f"cli generate-data --seed 0 --n-frames 3000: {out.strip()}; all "
                    f"{len(same)} files byte-equal to data/synthetic3000")
            else:
                nums = [float(x) for x in re.findall(r"=([-\d.]+)m", out)]
                check(len(nums) == 2 * (len(SCENES) + 1) and all(map(math.isfinite, nums)),
                      f"cli {name}: {out}")
                log(f"cli {name} --scene all on data/synthetic3000:")
                for line in out.strip().splitlines():
                    log("  " + line)
    finally:
        for job in jobs.values():
            if job.poll() is None:
                job.kill()
                job.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log("protocol " + json.dumps(summary))


def importers_phase(torch, dev, card, cfg, plain_cfg, route_a, state, counted, zero) -> None:
    """Phase 16: the importers, the native parser, ``visualize``'s rollouts
    and the build directory, through the port's entry points
    (``mmtraj_torch.cli.main`` in-process, ``evaluate``,
    ``cli.visualize_rollouts``)."""
    from mmtraj_torch import cli as torch_cli
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch.data import native
    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.parser import read_annotation_file
    from mmtraj_torch.data.registry import load_scene_windows
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.native import build as native_build
    from mmtraj_torch.params import Checkpoint
    from mmtraj_torch.utils import build_cache

    summary = {"card": card}
    # 1. The parser: built into the build directory, loaded, equal to numpy's.
    t0 = time.perf_counter()
    lib = Path(native_build.build())
    live = Path(build_cache.resolve_cache_dir())
    check(lib.parent == live and lib.exists(), f"native parser at {lib}, build dir {live}")
    check(native.native_available(), "native parser unavailable (g++ -O3 -shared -fPIC)")
    summary["parser_build_s"] = time.perf_counter() - t0
    files = sorted(EVAL_DATA.glob("*.txt"))
    check(len(files) == 5, f"data/synthetic3000 holds {len(files)} scenes")
    secs = {"native": [], "numpy": []}
    for _ in range(PARSE_ROUNDS):  # in turns
        for name, read in (("native", native.read_annotation_file_native),
                           ("numpy", read_annotation_file)):
            t0 = time.perf_counter()
            rows = [read(str(f)) for f in files]
            secs[name].append(time.perf_counter() - t0)
            if name == "native":
                got = rows
        for f, a, b in zip(files, got, rows):
            check(np.array_equal(a, b), f"native parse of {f.name} differs from numpy's")
    n_rows = sum(len(r) for r in rows)
    rate = {k: n_rows / min(v) for k, v in secs.items()}
    summary.update(parse_rows=n_rows, parse_rows_per_s=rate,
                   parse_s={k: v for k, v in secs.items()})
    log(f"parsers on the host, {n_rows} rows of 5 scenes, best of {PARSE_ROUNDS} in turns: "
        f"native {rate['native']:.0f} rows/s, numpy {rate['numpy']:.0f} rows/s "
        f"({rate['native'] / rate['numpy']:.2f}x); all 5 scenes np.array_equal; {card}")

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="tmp_import_", dir=root))
    env_before = os.environ.get(build_cache.ENV_DIR)
    try:
        # 2. The scene written as raw obsmat and .vsp, imported through the CLI.
        rows = read_annotation_file(str(EVAL_DATA / f"{IMPORT_SCENE}.txt"))
        zeros = np.zeros((len(rows), 1))
        raw = np.hstack([rows[:, :3], zeros, rows[:, 3:4], zeros, zeros, zeros])
        np.savetxt(tmp / "obsmat.txt", raw)  # %.18e: every value round-trips
        peds = np.unique(rows[:, 1])
        lines = [f"{len(peds)} - the number of splines"]
        for pid in peds:
            track = rows[rows[:, 1] == pid]
            lines.append(f"{len(track)} - the number of control points")
            lines += [f"{x / VSP_SCALE:.6f} {y / VSP_SCALE:.6f} {int(fr)} 0.0"
                      for fr, _, x, y in track]
        (tmp / "scene.vsp").write_text("\n".join(lines) + "\n")
        imported = {}
        for name, args in (("obsmat", ["import-obsmat", "--src", str(tmp / "obsmat.txt")]),
                           ("vsp", ["import-vsp", "--src", str(tmp / "scene.vsp"),
                                    "--scale", repr(VSP_SCALE)])):
            (tmp / name).mkdir()
            dst = tmp / name / f"{IMPORT_SCENE}.txt"
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code = torch_cli.main([*args, "--dst", str(dst)])
            check(code == 0 and out.getvalue() == f"wrote {len(rows)} rows: {args[2]} -> {dst}\n",
                  f"cli {args[0]}: exit {code}, {out.getvalue()!r}")
            imported[name] = native.read_annotation_file_native(str(dst))
        check(np.array_equal(imported["obsmat"], rows), "imported obsmat rows differ")
        index = np.searchsorted(peds, rows[:, 1]).astype(np.float64)  # .vsp numbers peds 0..P-1
        check(np.array_equal(imported["vsp"], np.column_stack([rows[:, 0], index, rows[:, 2:]])),
              "imported .vsp rows differ from the original's with its pedestrians numbered")
        log(f"cli import-obsmat and import-vsp (scale {VSP_SCALE} m/px) of {IMPORT_SCENE}: "
            f"{len(rows)} rows each, equal to the original's")

        # 3. evaluate() on route A of the imported obsmat scene against the original.
        model_a = Forecaster(route_a, TO, TP, device=dev, state=state)
        stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
        metrics = {}
        for name, data_dir in (("original", EVAL_DATA), ("obsmat", tmp / "obsmat")):
            ds = WindowDataset(load_scene_windows(str(data_dir), IMPORT_SCENE, TO, TP), N)
            t0 = time.perf_counter()
            m, counts = counted(lambda: ev.evaluate(model_a, stats, ds, K, IMPORT_EVAL_B))
            batches = math.ceil(len(ds) / IMPORT_EVAL_B)
            want = {**zero, "fused_gat": batches * (TO + TP), "fused_decode": batches}
            check(counts == want, f"evaluate {name}: launches {counts}, want {want}")
            check(math.isfinite(m["min_ade"]) and math.isfinite(m["min_fde"]), f"{name}: {m}")
            metrics[name] = m
            log(f"evaluate route A on {name} {IMPORT_SCENE} ({len(ds)} windows, B = "
                f"{IMPORT_EVAL_B}, {time.perf_counter() - t0:.2f} s): ADE {m['min_ade']:.6f} m, "
                f"FDE {m['min_fde']:.6f} m; launches {counts}")
        d = {k: abs(metrics["obsmat"][k] - metrics["original"][k]) for k in ("min_ade", "min_fde")}
        check(max(d.values()) <= IMPORT_ADE_TOL, f"imported scene vs original: {d}")
        summary["import_eval_abs_diff"] = d

        # 4. visualize's rollouts, route A against plain from one stream.
        ck = Checkpoint(state, stats, cfg.replace(
            data=dataclasses.replace(cfg.data, data_dir=str(EVAL_DATA))), 0)
        plain = Forecaster(plain_cfg, TO, TP, device=dev, state=state)
        stream = plain._rollout_stream(K * VIZ_WINDOWS, N,
                                       torch.Generator(device=dev).manual_seed(5))
        rolls = {}
        for name, model_cfg, expect in (("A", route_a, {"fused_gat": TO, "fused_decode": 1}),
                                        ("plain", plain_cfg, {})):
            (xy, mask, roll), counts = counted(lambda: torch_cli.visualize_rollouts(
                ck, ck.config.replace(model=model_cfg), VIZ_WINDOWS, 0, dev, stream=stream))
            check(counts == {**zero, **expect}, f"visualize {name}: launches {counts}")
            check(roll.shape == (K, VIZ_WINDOWS, N, TP, 2) and np.isfinite(roll).all(),
                  f"visualize {name}: {roll.shape}, finite {np.isfinite(roll).all()}")
            rolls[name] = (xy, roll)
        check(np.array_equal(rolls["A"][0], rolls["plain"][0]), "visualize picked other windows")
        per = np.where(mask[None, :, :, None, None], np.abs(rolls["A"][1] - rolls["plain"][1]),
                       0.0).reshape(K, VIZ_WINDOWS, -1).max(2)
        n_bad = int((per > ROLLOUT_TOL).sum())
        check(n_bad <= MAX_DIVERGED * per.size,
              f"visualize route A: {n_bad} of {per.size} rollouts past {ROLLOUT_TOL} m of plain")
        log(f"visualize rollouts ({VIZ_WINDOWS} windows of univ, K={K}): route A launches "
            f"{TO} fused_gat + 1 fused_decode, max abs err vs plain "
            f"{per[per <= ROLLOUT_TOL].max():.3e} m, {n_bad} of {per.size} past {ROLLOUT_TOL} m")

        # 5. cli cache on the live build directory; --trim-gb and --clear on a copy.
        def cache(*flags):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                check(torch_cli.main(["cache", *flags]) == 0, f"cli cache {flags}")
            text = out.getvalue()
            return text, int(re.search(r"^entries: (\d+)$", text, re.M).group(1))

        current = build_cache.current_libraries()
        text, entries = cache()
        names = {p.name for p in live.iterdir()}
        check(f"cache dir: {live}" in text and entries >= len(current) and current <= names,
              f"cli cache on {live}: {text!r}; current libraries {sorted(current)}")
        copy = tmp / "build_copy"
        shutil.copytree(live, copy)
        stale = copy / "libgat-0000000000000000.so"  # an earlier tree's library
        stale.write_bytes(b"\0" * 4096)
        os.utime(stale, (0, 0))
        os.environ[build_cache.ENV_DIR] = str(copy)
        trimmed, left = cache("--trim-gb", "0")
        check({p.name for p in copy.iterdir()} == current and left == len(current),
              f"cli cache --trim-gb 0 on a copy: {trimmed!r}")
        cleared, left = cache("--clear")
        check(left == 0 and not any(copy.iterdir()), f"cli cache --clear on a copy: {cleared!r}")
        check({p.name for p in live.iterdir()} == names, "the live build directory changed")
        summary["cache"] = {"live_entries": entries, "trim": trimmed.splitlines()[0],
                            "clear": cleared.splitlines()[0]}
        log(f"cli cache: {live}: {entries} entries; on a copy --trim-gb 0 "
            f"({trimmed.splitlines()[0]}) left the {len(current)} current libraries, "
            f"--clear ({cleared.splitlines()[0]}) left none")
    finally:
        if env_before is None:
            os.environ.pop(build_cache.ENV_DIR, None)
        else:
            os.environ[build_cache.ENV_DIR] = env_before
        shutil.rmtree(tmp, ignore_errors=True)
    log("importers " + json.dumps(summary))


def orbax_phase(torch, dev, card, route_a_of, xy_obs, mask, counted, zero) -> None:
    """Phase 17: the JAX package's Orbax directory through the port's
    ``checkpoint.load``/``save`` and ``cli convert``, with no JAX, orbax or
    tensorstore imported."""
    from mmtraj_torch import checkpoint
    from mmtraj_torch import cli as torch_cli
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.orbax_io import zstd
    from mmtraj_torch.orbax_io.ocdbt import OcdbtReader

    def same(a, b, label):
        check(sorted(a.state) == sorted(b.state), f"{label}: keys differ")
        for k in a.state:
            check(torch.equal(a.state[k].cpu(), b.state[k].cpu()), f"{label}: {k} differs")
        for x, y in ((a.stats.mean, b.stats.mean), (a.stats.std, b.stats.std)):
            check(np.array_equal(np.asarray(x), np.asarray(y)), f"{label}: stats differ")
        check(a.config == b.config and a.step == b.step,
              f"{label}: config or step differ ({a.step} vs {b.step})")

    # 1. the load, timed, against the twin
    secs = []
    for _ in range(ORBAX_ROUNDS):
        t0 = time.perf_counter()
        ck = checkpoint.load(str(ORBAX_FIXTURE))
        secs.append(time.perf_counter() - t0)
    foreign = [m for m in ("jax", "jaxlib", "orbax", "tensorstore", "zstandard") if m in sys.modules]
    check(not foreign, f"the Orbax load imported {foreign}")
    twin = checkpoint.load(str(ORBAX_FIXTURE.with_name(ORBAX_FIXTURE.name + "_twin.npz")))
    same(ck, twin, "Orbax fixture vs its .npz twin")
    check(ck.step == 1234 and sum(v.numel() for v in ck.state.values()) == 72798,
          f"fixture: step {ck.step}, {sum(v.numel() for v in ck.state.values())} parameters")

    # 2. route A from the model of each, one stream, exact launches
    route_a = route_a_of(ck.config.model)
    stats = NormStats(torch.as_tensor(ck.stats.mean, device=dev),
                      torch.as_tensor(ck.stats.std, device=dev))
    models = {name: Forecaster(route_a, TO, TP, device=dev, state=c.state)
              for name, c in (("orbax", ck), ("npz", twin))}
    stream = models["npz"]._rollout_stream(K * B, N, torch.Generator(device=dev).manual_seed(17))
    rolls = {}
    for name, model in models.items():
        roll, counts = counted(lambda: model.rollout_k(xy_obs, mask, stats, K, stream=stream))
        want = {**zero, "fused_gat": TO, "fused_decode": 1}
        check(counts == want, f"route A from the {name} checkpoint: launches {counts}, want {want}")
        check(roll.shape == (K, B, N, TP, 2) and bool(torch.isfinite(roll).all()),
              f"route A from the {name} checkpoint: {tuple(roll.shape)}, not finite")
        rolls[name] = roll
    check(torch.equal(rolls["orbax"], rolls["npz"]), "route A rollouts from Orbax and .npz differ")

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="tmp_orbax_", dir=root))
    try:
        # 3. the port's own directory, read back
        saved = tmp / "port_ckpt"
        checkpoint.save(str(saved), ck.state, ck.stats, ck.config, ck.step)
        check(saved.is_dir(), f"save to a suffix-less path wrote no directory at {saved}")
        same(checkpoint.load(str(saved)), ck, "the port's Orbax directory")

        # 4. cli convert, Orbax -> .npz -> Orbax
        for src, dst in ((ORBAX_FIXTURE, tmp / "c.npz"), (tmp / "c.npz", tmp / "c_dir")):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code = torch_cli.main(["convert", "--src", str(src), "--dst", str(dst)])
            check(code == 0 and out.getvalue() == f"converted {src} -> {dst} (step=1234)\n",
                  f"cli convert {src} -> {dst}: exit {code}, {out.getvalue()!r}")
            same(checkpoint.load(str(dst)), ck, f"cli convert to {dst.name}")

        # 5. one flipped byte in the top-level node
        bad = tmp / "flipped"
        shutil.copytree(ORBAX_FIXTURE, bad)
        (node,) = (bad / "d").iterdir()
        data = bytearray(node.read_bytes())
        data[len(data) // 2] ^= 0x40
        node.write_bytes(bytes(data))
        raised = None
        try:
            checkpoint.load(str(bad))
        except checkpoint.CheckpointError as e:
            raised = e
        check(raised is not None and "CRC-32C checksum mismatch" in str(raised.__cause__),
              f"a flipped node byte: {raised!r}, cause {getattr(raised, '__cause__', None)!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6. the zstd decoder's output rate on the fixture's chunks
    store = OcdbtReader(str(ORBAX_FIXTURE))
    frames = [store.read(k) for k in store.keys() if not k.endswith(b".zarray")]
    rates, nbytes = [], 0
    for _ in range(ORBAX_ROUNDS):
        t0 = time.perf_counter()
        nbytes = sum(len(zstd.decompress(f)) for f in frames)
        rates.append(nbytes / (time.perf_counter() - t0) / 1e6)
    load_s, rate = statistics.median(secs), statistics.median(rates)
    log(f"orbax: load of the config-4 fixture {load_s:.4f} s (median of {ORBAX_ROUNDS}: "
        f"{', '.join(f'{x:.4f}' for x in secs)}); zstd {rate:.2f} MB/s of output ({len(frames)} "
        f"chunks, {nbytes} bytes, median of {ORBAX_ROUNDS}); equal to the .npz twin; route A "
        f"rollouts equal to the bit, {TO} fused_gat + 1 fused_decode each; save, cli convert "
        f"both ways and a flipped node byte checked; {card}")


def config3_phase(torch, dev, card, counted, zero) -> None:
    """Phase 18: config 3 at full width, with the recipe's radius, dropout and
    training flags (see the module's docstring)."""
    from mmtraj_torch import population as popm
    from mmtraj_torch import train as tr
    from mmtraj_torch.config import config3
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.graph.adjacency import proximity_adjacency
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.ops import _build, fused_attend, fused_decoder, fused_gat
    from mmtraj_torch.params import init_params

    base = config3()
    # The recipe (RESULTS.md:14-20, 55-72), its warm-up cut to one step so that
    # the steps held below move at about the peak rate.
    cfg = base.replace(
        model=dataclasses.replace(base.model, adjacency_radius=2.0, dropout=0.1),
        train=dataclasses.replace(base.train, loss="variety", variety_n=VARIETY_N,
                                  augment_rotate=True, augment_flip=True, weight_decay=1e-4,
                                  ema_decay=0.995, lr_schedule="cosine", steps=32000,
                                  warmup_steps=1))
    t = cfg.train
    n, H, TB, R = cfg.data.n_max, cfg.model.num_heads, t.batch_size, cfg.model.adjacency_radius
    plain_cfg = dataclasses.replace(cfg.model, use_pallas=False, attend_kernel="xla",
                                    use_fused_decoder=False)
    pallas_cfg = dataclasses.replace(plain_cfg, use_pallas=True)
    plain = Forecaster(plain_cfg, TO, TP, device=dev, generator=torch.Generator().manual_seed(3))
    p = plain.params()
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    rng = np.random.default_rng(18)
    # zara1-like windows: up to 32 agents, about 40% of them present, within a
    # few meters of each other, so a 2 m radius keeps some edges and drops others.
    steps = rng.normal(size=(C3_B, n, TO + TP, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(C3_B, n, 1, 2)).astype(np.float32) * 2
    xy = torch.tensor(xy, dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random((C3_B, n)) < 0.4, device=dev)
    mask[:, 0] = True
    xy_obs = xy[:, :, :TO].contiguous()
    t_phase = time.perf_counter()

    def self_loops(adj, m):
        eye = torch.eye(adj.shape[-1], dtype=torch.bool, device=dev)
        return (adj | (eye & m[:, None, :] & m[:, :, None])).float().contiguous()

    def tile(a):
        return a.repeat((K,) + (1,) * (a.ndim - 1)).contiguous()

    # a. each kernel at config 3's shapes against its plain version.
    carry = plain.encode(xy_obs, mask, stats)
    hk, mk, xyk = tile(carry.h), tile(mask), tile(xy_obs[:, :, -1])
    att_k = self_loops(proximity_adjacency(xyk, mk, R), mk)
    att_e = self_loops(proximity_adjacency(xy_obs[:, :, -1], mask, R), mask)

    def report(name, shape, err, fn_k, fn_p, cost, occ, plain_reps=11):
        ms, plain_ms = time_ms(torch, fn_k), time_ms(torch, fn_p, reps=plain_reps,
                                                     inner=1 if plain_reps < 11 else 5)
        bound_ms, bound_by = bound(*cost[:2])
        log(f"config3 {name} {shape} H={H}: max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), tc bound "
            f"{tc_bound(*cost):.6f} ms; {json.dumps(occ)}; {card}")

    def held(name, out_k, out_p):
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
              f"config3 {name}: max abs err {err}")
        return err

    g = p["dec"]["gat"]
    v = (hk @ g["wv"]).contiguous()
    s_src = (v @ fused_gat._block_diag(g["a_src"])).contiguous()
    s_dst = (v @ fused_gat._block_diag(g["a_dst"])).contiguous()
    a_args = (v, s_src, s_dst, att_k, H)
    err = held("attend", fused_attend.attend(*a_args), fused_attend.attend_math(*a_args))
    report("attend", tuple(v.shape), err, lambda: fused_attend.attend(*a_args),
           lambda: fused_attend.attend_math(*a_args), attend_cost(C3_B * K, n, v.shape[-1], H),
           _build.occupancy("attend", n, H, v.shape[-1]))

    ge = p["enc"]["gat"]
    enc_w = tuple(ge[k] for k in ("wv", "a_src", "a_dst", "wo", "bo"))
    dec_w = tuple(g[k] for k in ("wv", "a_src", "a_dst", "wo", "bo"))
    for label, args in (("training batch", (carry.h[:TB].contiguous(), att_e[:TB], *enc_w, H)),
                        ("variety rollout", (hk[:VARIETY_N * TB], att_k[:VARIETY_N * TB],
                                             *dec_w, H)),
                        ("evaluate batch", (carry.h.contiguous(), att_e, *enc_w, H))):
        err = held(f"fused_gat ({label})", fused_gat.fused_gat(*args), fused_gat.gat_math(*args))
        b_, d_ = args[0].shape[0], args[0].shape[-1]
        hd_, dout = args[2].shape[1], args[5].shape[1]
        report(f"fused_gat ({label})", (b_, n, d_), err, lambda: fused_gat.fused_gat(*args),
               lambda: fused_gat.gat_math(*args), gat_cost(b_, n, d_, hd_, H, dout),
               _build.occupancy("gat", n, d_, H, hd_, dout))

    S = len(POP_SEEDS)
    states = [init_params(cfg.model, torch.Generator().manual_seed(s)) for s in POP_SEEDS]
    lane_w = [torch.stack([st[f"enc.gat.{k}"] for st in states]).to(dev)
              for k in ("wv", "a_src", "a_dst", "wo", "bo")]
    for b_ in (TB, VARIETY_N * TB):
        h_l = hk[:S * b_].reshape(S, b_, n, -1)
        args = (h_l, att_k[:S * b_].reshape(S, b_, n, n), *lane_w, H)

        def lanes_plain(args=args):
            return torch.stack([fused_gat.gat_math(*(x[i] for x in args[:-1]), H)
                                for i in range(S)])

        err = held(f"fused_gat_lanes ({S}, {b_})", fused_gat.fused_gat_lanes(*args),
                   lanes_plain())
        report("fused_gat_lanes", (S, b_, n, 64), err,
               lambda args=args: fused_gat.fused_gat_lanes(*args), lanes_plain,
               lanes_cost(S, b_, n, 64, lane_w[0].shape[-1], H, lane_w[3].shape[-1]),
               _build.occupancy("gat", n, 64, H, lane_w[0].shape[-1], lane_w[3].shape[-1]))

    M = cfg.model.num_mixtures
    hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], M)
    dec_kw = dict(num_heads=H, num_mixtures=M, radius=R, sigma_min=cfg.model.sigma_min,
                  rho_max=cfg.model.rho_max, stats_mean=stats.mean, stats_std=stats.std)
    gumbel, normal = plain._rollout_stream(C3_B * K, n, torch.Generator(device=dev).manual_seed(2))
    d_args = (hk, xyk, mk, gumbel, normal, p["dec"], hw, hb)
    out_k = fused_decoder.fused_decode(*d_args, **dec_kw)
    out_p = fused_decoder.reference_decode(*d_args, **dec_kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "config3 fused_decode: output is not finite")
    per_graph = torch.where(mk[:, None, :, None], (out_k - out_p).abs(), 0.0).flatten(1).amax(1)
    diverged = int((per_graph > ROLLOUT_TOL).sum())
    check(diverged <= MAX_DIVERGED * C3_B * K,
          f"config3 fused_decode: {diverged} of {C3_B * K} rollouts past {ROLLOUT_TOL} m")
    n_weights = sum(x.numel() for x in (*(y for d in p["dec"].values() if isinstance(d, dict)
                                          for y in d.values()), hw, hb))
    hid, emb = cfg.model.hidden_dim, cfg.model.embed_dim
    log(f"config3 fused_decode: {diverged} of {C3_B * K} rollouts past {ROLLOUT_TOL} m")
    report("fused_decode", (C3_B * K, TP, n), per_graph[per_graph <= ROLLOUT_TOL].max().item(),
           lambda: fused_decoder.fused_decode(*d_args, **dec_kw),
           lambda: fused_decoder.reference_decode(*d_args, **dec_kw),
           decode_cost(C3_B * K, TP, n, hid, emb, g["wv"].shape[1], H, M, n_weights),
           _build.occupancy("decoder", n, hid, emb, H, g["wv"].shape[1], M), plain_reps=3)
    log(f"config3 kernels: {time.perf_counter() - t_phase:.1f} s")

    # b. route A and the route-B pin against plain rollout_k at B = 64, K = 20.
    stream = plain._rollout_stream(K * C3_B, n, torch.Generator(device=dev).manual_seed(4))
    ref = plain.rollout_k(xy_obs, mask, stats, K, stream=stream)
    for name, mc, expect in (
            ("A", dataclasses.replace(plain_cfg, use_pallas=True, use_fused_decoder=True),
             {"fused_gat": TO, "fused_decode": 1}),
            ("B", dataclasses.replace(plain_cfg, attend_kernel="pallas"), {"attend": TO + TP})):
        model = Forecaster(mc, TO, TP, device=dev, state=plain.state_dict())
        roll, counts = counted(lambda: model.rollout_k(xy_obs, mask, stats, K, stream=stream))
        check(counts == {**zero, **expect}, f"config3 route {name}: launches {counts}")
        check(roll.shape == (K, C3_B, n, TP, 2) and bool(torch.isfinite(roll).all()),
              f"config3 route {name}: shape {tuple(roll.shape)} or not finite")
        per = torch.where(mask[None, :, :, None, None], (roll - ref).abs(), 0.0).flatten(2).amax(2)
        n_bad = int((per > ROLLOUT_TOL).sum())
        check(n_bad <= MAX_DIVERGED * K * C3_B,
              f"config3 route {name}: {n_bad} of {K * C3_B} rollouts past {ROLLOUT_TOL} m")
        log(f"config3 route {name} (B={C3_B}, N={n}, K={K}, radius {R}): launches {counts}; "
            f"max abs err vs plain {per[per <= ROLLOUT_TOL].max().item():.3e} m, {n_bad} of "
            f"{K * C3_B} rollouts past {ROLLOUT_TOL} m")

    # c. recipe steps, use_pallas against plain, from one state and the same draws.
    state0 = states[0]
    xb, mb = xy[:TB], mask[:TB]
    per_step = {**zero, "fused_gat": 2 * (TO + TP),  # 8 + 12 forward, again under remat
                "fused_gat_grad": GRAD_STEP}

    def recipe_run(mc, expect):
        model = Forecaster(mc, TO, TP, device=dev, state=state0)
        ema = Forecaster(mc, TO, TP, device=dev, state=state0)
        step = tr.make_train_step(model, tr.make_optimizer(cfg, model), stats, ema, t.ema_decay,
                                  t.augment_rotate, t.augment_flip, 0, t.loss, t.variety_n)
        losses = []
        for s_ in range(C3_TRAIN_STEPS):
            loss, counts = counted(lambda: step(xb, mb, s_))
            check(counts == expect, f"config3 recipe step {s_}: launches {counts}, want {expect}")
            losses.append(float(loss))
        flat = [torch.cat([q.detach().flatten() for q in m_.parameters()]) for m_ in (model, ema)]
        return losses, flat

    with torch.enable_grad():
        lp, fp = recipe_run(plain_cfg, zero)
        lk, fk = recipe_run(pallas_cfg, per_step)
    rel = [abs(a - c) / abs(c) for a, c in zip(lk, lp)]
    check(max(rel) <= TRAIN_LOSS_RTOL, f"config3 recipe: losses {lk} vs {lp}")
    for what, a, c in (("parameters", fk[0], fp[0]), ("EMA", fk[1], fp[1])):
        dp = (a - c).abs()
        share = (dp > PARAM_TOL).float().mean().item()
        check(dp.max().item() <= 2 * t.lr * C3_TRAIN_STEPS and share <= 0.01,
              f"config3 recipe {what}: max |d| {dp.max().item()}, share past {PARAM_TOL} {share}")
    log(f"config3 recipe (B={TB}, N={n}, variety n={t.variety_n}, {C3_TRAIN_STEPS} steps): "
        f"use_pallas losses {[f'{x:.7f}' for x in lk]}, plain {[f'{x:.7f}' for x in lp]} "
        f"(largest rel {max(rel):.2e}); parameters max |d| {(fk[0] - fp[0]).abs().max().item():.3e}"
        f"; fused_gat {per_step['fused_gat']} launches a step")

    # d. a graphed population of 5 lanes against each seed's sequential step.
    pcfg = cfg.replace(model=pallas_cfg)
    idx = np.stack([np.stack([np.random.default_rng([s, k]).permutation(C3_B)[:TB]
                              for s in POP_SEEDS]) for k in range(2 * C3_POP_M)])
    per_pop = {**zero, "fused_gat": TO + TP, "fused_gat_lanes": TO + TP,
               "weight_grad_lanes": WGRAD_STEP, "fused_gat_grad": GRAD_STEP}
    with torch.enable_grad():
        params = popm.stack_lanes(states, dev)
        ema = {k_: x.detach().clone() for k_, x in params.items()}
        popt = tr.Optimizer(params, pcfg, lanes=True)
        pop = popm.make_population_step(popm.lane_model(pcfg, dev), params, popt, stats,
                                        POP_SEEDS, ema, t.ema_decay, t.augment_rotate,
                                        t.augment_flip, t.loss, t.variety_n)
        first, counts = counted(lambda: pop(xy, mask, idx[:C3_POP_M], range(C3_POP_M)))
        want = {k_: (tr.CAPTURE_WARMUP + 1) * c for k_, c in per_pop.items()}
        check(counts == want, f"config3 population: launches {counts} (want {want})")
        t0 = time.perf_counter()
        _, counts = counted(lambda: pop(xy, mask, idx[C3_POP_M:], range(C3_POP_M, 2 * C3_POP_M)))
        pop_ms = 1e3 * (time.perf_counter() - t0) / C3_POP_M
        check(counts == zero, f"config3 population replays: launches {counts}")
        first = first.cpu().numpy()
        rels = []
        for i, seed in enumerate(POP_SEEDS):
            m_ = Forecaster(pcfg.model, TO, TP, device=dev, state=states[i])
            e_ = Forecaster(pcfg.model, TO, TP, device=dev, state=states[i])
            step = tr.make_train_step(m_, tr.make_optimizer(pcfg, m_), stats, e_, t.ema_decay,
                                      t.augment_rotate, t.augment_flip, seed, t.loss, t.variety_n)
            sel = torch.from_numpy(idx[0, i]).to(dev)
            seq = float(step(xy[sel], mask[sel], 0))
            rels.append(abs(first[0, i] - seq) / abs(seq))
        check(max(rels) <= TRAIN_LOSS_RTOL and np.isfinite(first).all(),
              f"config3 population step 1 vs sequential steps: rel {rels}")
    log(f"config3 population ({S} lanes x B={TB}, variety n={t.variety_n}, graphed M={C3_POP_M})"
        f": step-1 loss rel to each seed's sequential step {max(rels):.2e} (tol "
        f"{TRAIN_LOSS_RTOL}); {per_pop['fused_gat_lanes']} fused_gat_lanes and "
        f"{per_pop['weight_grad_lanes']} weight_grad_lanes a step; a replayed step "
        f"{pop_ms:.2f} ms; {card}")

    # e. the yardstick, shortened to a smoke.
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tools"))
    import torch_yardstick

    tmp = Path(tempfile.mkdtemp(prefix="tmp_yardstick_", dir=root))
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            res, counts = counted(lambda: torch_yardstick.run(
                str(tmp), steps=C3_SMOKE_STEPS, n_frames=C3_SMOKE_FRAMES, device="cuda",
                log=log))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = res["rows"]
    finite = all(np.isfinite(rows[r][p_][m][0]) for r in rows for p_ in ("iid", "os6", "ens5")
                 for m in ("ade", "fde"))
    check(finite and res["routes_agree"] and max(res["route_gap_m"].values()) <= EVAL_ADE_TOL,
          f"config3 yardstick smoke: finite {finite}, route gaps {res['route_gap_m']}")
    check(all(counts[k_] > 0 for k_ in ("fused_gat", "fused_gat_lanes", "fused_decode",
                                        "weight_grad_lanes", "fused_gat_grad")),
          f"config3 yardstick smoke: launches {counts}")
    log(f"config3 yardstick smoke ({C3_SMOKE_STEPS} steps, {C3_SMOKE_FRAMES} frames a scene, "
        f"{len(res['seeds'])} seeds; not the yardstick): training {res['train_seconds']:.1f} s, "
        f"{res['step_ms']} ms a population step; route A i.i.d. "
        f"{rows['A']['iid']['ade'][0]:.4f}/{rows['A']['iid']['fde'][0]:.4f} m, plain "
        f"{rows['plain']['iid']['ade'][0]:.4f}/{rows['plain']['iid']['fde'][0]:.4f} m, largest "
        f"route gap {max(res['route_gap_m'].values()):.2e} m; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")


def experiments_phase(torch, dev, card, counted, zero) -> None:
    """Phase 19: the port's ``experiments/`` scripts and reports on the card,
    and the kernels at the shapes they reach (see the module's docstring)."""
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch import train as tr
    from mmtraj_torch.cli import main as cli_main
    from mmtraj_torch.data.registry import load_scene_windows
    from mmtraj_torch.ops import _build, fused_attend, fused_decoder, fused_gat

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tools"))
    sys.path.insert(0, str(root / "experiments"))
    import kernel_inputs
    import torch_dense_sweep
    import torch_dense_sweep_report
    import torch_social_ablation
    import torch_social_ablation_report

    t_phase = time.perf_counter()
    rng = np.random.default_rng(19)

    def held(name, out_k, out_p):
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
              f"experiments {name}: max abs err {err}")
        return err

    def report(name, shape, err, fn_k, fn_p, cost, occ, plain_reps=11):
        ms = time_ms(torch, fn_k)
        plain_ms = time_ms(torch, fn_p, reps=plain_reps, inner=1 if plain_reps < 11 else 5)
        bound_ms, bound_by = bound(*cost[:2])
        log(f"experiments {name} {shape}: max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), tc bound "
            f"{tc_bound(*cost):.6f} ms; {json.dumps(occ)}; {card}")

    def gat_args(b, d, heads, lead=()):
        t = kernel_inputs.tensor
        return (t(rng, *lead, b, X_N, d), torch.stack([kernel_inputs.attend_tile(rng, b, X_N)
                                                       for _ in range(max(1, math.prod(lead)))]
                                                      ).reshape(*lead, b, X_N, X_N),
                t(rng, *lead, d, d, scale=0.3), t(rng, *lead, heads, d // heads, scale=0.3),
                t(rng, *lead, heads, d // heads, scale=0.3), t(rng, *lead, d, d, scale=0.3),
                t(rng, *lead, d, scale=0.1))

    # a. the kernels at the experiments' shapes against their plain versions:
    # dense-sweep cell A (hidden 128, 4 heads of 32) and social arm C (one
    # head of 64), config 4's N = 64.
    for d, heads in X_WIDTHS:
        for b in (16, 25):  # the training batch, the evaluate batch
            args = gat_args(b, d, heads)
            err = held(f"fused_gat ({b}, {X_N}, {d}) H={heads}", fused_gat.fused_gat(*args, heads),
                       fused_gat.gat_math(*args, heads))
            check(torch.equal(fused_gat.fused_gat(*args, heads)[:, -1], args[6].expand(b, d)),
                  "experiments fused_gat: a row without edges is not bo")
            report(f"fused_gat H={heads}", (b, X_N, d), err,
                   lambda args=args, heads=heads: fused_gat.fused_gat(*args, heads),
                   lambda args=args, heads=heads: fused_gat.gat_math(*args, heads),
                   gat_cost(b, X_N, d, d, heads, d), _build.occupancy("gat", X_N, d, heads, d, d))
        lanes = gat_args(16, d, heads, (len(X_SEEDS) + 1,))
        s = lanes[0].shape[0]

        def lanes_plain(lanes=lanes, heads=heads, s=s):
            return torch.stack([fused_gat.gat_math(*(x[i] for x in lanes), heads)
                                for i in range(s)])

        got = fused_gat.fused_gat_lanes(*lanes, heads)
        err = held(f"fused_gat_lanes ({s}, 16, {X_N}, {d}) H={heads}", got, lanes_plain())
        for i in range(s):
            check(torch.equal(got[i], fused_gat.fused_gat(*(x[i] for x in lanes), heads)),
                  f"experiments fused_gat_lanes: lane {i} differs from a single launch")
        report(f"fused_gat_lanes H={heads}", (s, 16, X_N, d), err,
               lambda lanes=lanes, heads=heads: fused_gat.fused_gat_lanes(*lanes, heads),
               lanes_plain, lanes_cost(s, 16, X_N, d, d, heads, d),
               _build.occupancy("gat", X_N, d, heads, d, d))
        # The autograd Functions use_pallas training runs: forward and every
        # input's gradient, at the training batch and the variety rollout's.
        for b in (16, 16 * VARIETY_N):
            h, att, wv, a_src, a_dst, wo, bo = gat_args(b, d, heads)
            up = kernel_inputs.tensor(rng, b, X_N, d)
            v = h @ wv
            for name, kernel, plain, inputs, run in (
                    ("fused_gat", fused_gat.fused_gat, fused_gat.gat_math,
                     [h, wv, a_src, a_dst, wo, bo],
                     lambda fn, xs: fn(xs[0], att, *xs[1:], heads)),
                    ("attend", fused_attend.attend, fused_attend.attend_math,
                     [v, v @ fused_gat._block_diag(a_src), v @ fused_gat._block_diag(a_dst)],
                     lambda fn, xs: fn(*xs, att, heads))):
                leaves = [x.contiguous().clone().requires_grad_() for x in inputs]
                with torch.enable_grad():
                    out_k, out_p = run(kernel, leaves), run(plain, leaves)
                    g_k = torch.autograd.grad(out_k, leaves, up)
                    g_p = torch.autograd.grad(out_p, leaves, up)
                    wide = [x.detach().double().requires_grad_() for x in leaves]
                    g_w = torch.autograd.grad(run(plain, wide), wide, up.double())
                err = held(f"{name} Function ({b}, {X_N}, {d}) H={heads}", out_k, out_p)
                if name == "fused_gat":  # the backward kernel: held to float64 (GRAD_TOL)
                    g_err = faithful(torch, g_k, g_p, g_w)
                else:
                    g_err = max(held(f"{name} Function gradient ({b}, {X_N}, {d})", a, c)
                                for a, c in zip(g_k, g_p))
                log(f"experiments {name} autograd Function ({b}, {X_N}, {d}) H={heads}: forward "
                    f"{err:.3e}, gradients of {len(leaves)} inputs {g_err:.3e} (tol "
                    f"{GRAD_TOL if name == 'fused_gat' else KERNEL_TOL})")
    for n in (64, 128):  # attend at hidden 128, 4 heads: the rollout's B·K graphs
        bk = 500 if n == 64 else 240
        t = kernel_inputs.tensor
        a_args = (t(rng, bk, n, 128), t(rng, bk, n, 4, scale=2), t(rng, bk, n, 4, scale=2),
                  kernel_inputs.attend_tile(rng, bk, n), 4)
        err = held(f"attend ({bk}, {n}, 128)", fused_attend.attend(*a_args),
                   fused_attend.attend_math(*a_args))
        report("attend H=4", (bk, n, 128), err, lambda a_args=a_args: fused_attend.attend(*a_args),
               lambda a_args=a_args: fused_attend.attend_math(*a_args),
               attend_cost(bk, n, 128, 4), _build.occupancy("attend", n, 4, 128))
    for case in kernel_inputs.DECODER_CASES[-2:]:
        n, hid, emb, hd, m, heads = case
        args, kw = kernel_inputs.decoder_case(fused_decoder, *case, bk=B * K, device=dev)
        # The stats on the card, as a caller holds them: a host copy cannot be graphed.
        kw.update({k: torch.as_tensor(kw[k], device=dev) for k in ("stats_mean", "stats_std")})
        out_k = fused_decoder.fused_decode(*args, **kw)
        out_p = fused_decoder.reference_decode(*args, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"experiments fused_decode {case}: not finite")
        worst, past = kernel_inputs.rollout_errors(out_k, out_p, args[2], ROLLOUT_TOL)
        check(past <= MAX_DIVERGED * B * K,
              f"experiments fused_decode {case}: {past} of {B * K} rollouts past {ROLLOUT_TOL} m")
        per_graph = torch.where(args[2][:, None, :, None], (out_k - out_p).abs(), 0.0).flatten(1)
        per_graph = per_graph.amax(1)
        n_weights = sum(x.numel() for x in (*(y for dd in args[5].values() for y in dd.values()),
                                            args[6], args[7]))
        log(f"experiments fused_decode {case}: {past} of {B * K} rollouts past {ROLLOUT_TOL} m")
        report(f"fused_decode hidden={hid} H={heads}", (B * K, TP, n),
               per_graph[per_graph <= ROLLOUT_TOL].max().item(),
               lambda args=args, kw=kw: fused_decoder.fused_decode(*args, **kw),
               lambda args=args, kw=kw: fused_decoder.reference_decode(*args, **kw),
               decode_cost(B * K, TP, n, hid, emb, hd, heads, m, n_weights),
               _build.occupancy("decoder", n, hid, emb, heads, hd, m), plain_reps=3)
    log(f"experiments kernels: {time.perf_counter() - t_phase:.1f} s")

    # b. the training scripts: social arm C1 (config 4, one head) and dense cell A
    # (hidden 128) under --fast, two seeds as one population.
    tmp = Path(tempfile.mkdtemp(prefix="tmp_experiments_", dir=root))
    try:
        data, runs = str(tmp / "data" / "synthetic"), str(tmp / "runs")
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli_main(["generate-data", "--data-dir", data, "--seed", "0", "--n-frames",
                            str(X_FRAMES)]) == 0, "experiments: generate-data")
        n_test = len(load_scene_windows(data, "univ", TO, TP))
        on_card = ["--device", dev.type]
        smoke = ["--fast", "--steps", str(X_STEPS), "--seeds", *map(str, X_SEEDS), "--runs", runs,
                 "--data-dir", data] + on_card
        S = len(X_SEEDS)
        capture = (tr.CAPTURE_WARMUP + 1) * (TO + TP)  # a chunk counts its warm-up and capture
        per_eval = S * math.ceil(n_test / 16) * (TO + 2 * TP)  # each seed's final evaluation
        want = {**zero, "fused_gat_lanes": capture, "fused_gat": capture + per_eval,
                "weight_grad_lanes": (tr.CAPTURE_WARMUP + 1) * WGRAD_STEP,
                "fused_gat_grad": (tr.CAPTURE_WARMUP + 1) * GRAD_STEP}
        for name, script, argv in (("social arm C1", torch_social_ablation, ["--arm", "C1"]),
                                   ("dense cell A", torch_dense_sweep, ["--cell", "A"])):
            t0 = time.perf_counter()
            out = io.StringIO()
            with torch.enable_grad(), contextlib.redirect_stdout(out):
                code, counts = counted(lambda: script.main(argv + smoke))
            check(code == 0 and counts == want,
                  f"experiments {name}: exit {code}, launches {counts}, want {want}")
            finals = [ln for ln in out.getvalue().splitlines() if ln.startswith("final (seed")]
            check(len(finals) == S, f"experiments {name}: {finals}")
            log(f"experiments {name} ({X_STEPS} steps, seeds {list(X_SEEDS)}, --fast, "
                f"{X_FRAMES}-frame tree): {time.perf_counter() - t0:.1f} s; launches {counts}; "
                + "; ".join(finals))

        # c. their reports on both routes: route A within EVAL_ADE_TOL of plain.
        def batches(oversample):
            return math.ceil(n_test / ev.vmem_friendly_batch(20 * oversample, X_N,
                                                              bytes_per_elem=4))

        for name, mod, argv, protocols in (
                ("social ablation report", torch_social_ablation_report, [], (1,)),
                ("dense sweep report", torch_dense_sweep_report, [], (1, 6))):
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code, counts = counted(lambda: mod.main(
                    argv + ["--runs", runs, "--data-dir", data, "--route", "both", "--seeds",
                            *map(str, X_SEEDS)] + on_card))
            n_b = S * sum(batches(o) for o in protocols)
            want = {**zero, "fused_gat": (TO + TP) * n_b, "fused_decode": n_b}
            check(code == 0 and counts == want,
                  f"experiments {name}: exit {code}, launches {counts}, want {want}")
            tables = json.loads(out.getvalue().strip().splitlines()[-1])
            a, p = tables["A"], tables["plain"]
            if "iid" in a:  # the dense report: one table a protocol
                a = {f"{k} {t}": r for k, rows in a.items() for t, r in rows.items()}
                p = {f"{k} {t}": r for k, rows in p.items() for t, r in rows.items()}
            present = [t for t, r in a.items() if r is not None]
            gaps = [abs(a[t][m][0] - p[t][m][0]) for t in present for m in ("min_ade", "min_fde")]
            check(present and all(a[t]["route"] == "A" for t in present)
                  and max(gaps) <= EVAL_ADE_TOL,
                  f"experiments {name}: rows {present}, route gaps {gaps}")
            for t in present:
                log(f"experiments {name} {t}: route A ADE/FDE {a[t]['min_ade'][0]:.4f}/"
                    f"{a[t]['min_fde'][0]:.4f} m, plain {p[t]['min_ade'][0]:.4f}/"
                    f"{p[t]['min_fde'][0]:.4f} m")
            log(f"experiments {name} (--route both): {time.perf_counter() - t0:.1f} s; launches "
                f"{counts}; largest route gap {max(gaps):.2e} m (tol {EVAL_ADE_TOL})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def wgrad_phase(torch, dev, card) -> dict:
    """Phase 20: ``weight_grad_lanes`` (one lane among them) at each of
    ``WGRAD_CASES`` against the float64 product and against itself, with
    device times of the kernel, the plain version and cuBLAS's batched
    product (``library_ms``), its bound, split and occupancy; -> the
    kernels line's row, at config 3's largest product."""
    from mmtraj_torch.ops import _build, dense_grad

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for label, S, R, din, dout in WGRAD_CASES:
        gen = torch.Generator(device=dev).manual_seed(R + din * dout)
        x = torch.randn((S, R, din), generator=gen, device=dev)
        g = torch.randn((S, R, dout), generator=gen, device=dev)
        def kernel(x=x, g=g):
            return dense_grad.weight_grad_lanes(x, g)

        if S == 1:
            def library(x=x, g=g):
                return torch.mm(x[0].T, g[0])[None]
        else:
            def library(x=x, g=g):
                return torch.bmm(x.transpose(1, 2), g)

        def plain(x=x, g=g):
            return torch.stack([dense_grad.weight_grad_math(x[s], g[s]) for s in range(S)])

        out, again = kernel(), kernel()
        want = x.double().transpose(1, 2) @ g.double()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (out.double() - want).abs().max().item() / scale
        lib_err = (library().double() - want).abs().max().item() / scale
        check(err <= WGRAD_TOL and torch.equal(out, again),
              f"wgrad {label} {(S, R, din, dout)}: error {err} of the largest entry, "
              f"repeats to the bit {torch.equal(out, again)}")
        tm, tn, splits, rows_a_split = dense_grad.plan(S, R, din, dout, sms)
        flops, nbytes = 2.0 * S * R * din * dout, 4.0 * S * (R * (din + dout) + din * dout)
        bound_ms, bound_by = bound(flops, nbytes)
        r = dict(max_abs_err=err, library_err=lib_err, ms=time_ms(torch, kernel),
                 plain_ms=time_ms(torch, plain), library_ms=time_ms(torch, library),
                 cost=(flops, nbytes, flops), bound_ms=bound_ms, bound_by=bound_by,
                 tile=(tm, tn), splits=splits, blocks=math.ceil(din / tm) * math.ceil(dout / tn)
                 * S * splits, occupancy=_build.occupancy("wgrad", tm, tn))
        rows[label] = r
        log(f"wgrad {label} (S={S}, R={R}, {din} x {dout}): error {err:.3e} of the largest "
            f"entry (cuBLAS float32 {lib_err:.3e}), same to the bit; kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}); tile {tm} x {tn}, {splits} splits of "
            f"{rows_a_split} rows, {r['blocks']} blocks; {json.dumps(r['occupancy'])}; {card}")
    slower = [k for k, r in rows.items() if r["ms"] > r["library_ms"]]
    log(f"wgrad: slower than cuBLAS at {slower or 'no shape'}")
    return rows["config3 gru"]


def gat_grad_phase(torch, dev, card) -> dict:
    """Phase 21: ``fused_gat_grad`` at each of ``kernel_inputs.GRAD_CASES``
    against the float64 VJP of ``attend_math`` and the float32 one
    (``attend_grad_math``) and against itself, with device times of the
    kernels and of the plain VJP, its bound and occupancy; -> the kernels
    line's row, at config4-attn3's frame graphs."""
    from mmtraj_torch.ops import _build, fused_gat

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import kernel_inputs

    rows = {}
    for b, n, hd, heads in kernel_inputs.GRAD_CASES:
        rng = np.random.default_rng(b + n + hd)
        args = kernel_inputs.gat_grad_case(rng, b, n, hd, heads, dev)
        before = fused_gat.fused_gat_grad.launches
        out, again = fused_gat.fused_gat_grad(*args), fused_gat.fused_gat_grad(*args)
        want = fused_gat.attend_grad_math(*(a.double() for a in args[:5]), heads)
        plain = fused_gat.attend_grad_math(*args)
        torch.cuda.synchronize()
        errs = [faithful(torch, [o], [p_], [w]) for o, p_, w in zip(out, plain, want)]
        plain_errs = [(p_.double() - w).abs().max().item() / w.abs().max().item()
                      for p_, w in zip(plain, want)]
        same = all(torch.equal(a, c) for a, c in zip(out, again))
        check(fused_gat.fused_gat_grad.launches == before + 2 and same,
              f"fused_gat_grad {(b, n, hd)} H={heads}: repeats to the bit {same}")
        cost = grad_cost(b, n, hd, heads)
        bound_ms, bound_by = bound(*cost[:2])
        r = dict(max_abs_err=max(errs), plain_err=max(plain_errs),
                 ms=time_ms(torch, lambda args=args: fused_gat.fused_gat_grad(*args)),
                 plain_ms=time_ms(torch, lambda args=args: fused_gat.attend_grad_math(*args),
                                  reps=5, inner=2),
                 cost=cost, occupancy=_build.occupancy("gat_grad", n, heads, hd))
        rows[(b, n, hd, heads)] = r
        log(f"fused_gat_grad ({b}, {n}, {hd}) H={heads}: errors of agg, dv, ds_src, ds_dst "
            f"{[f'{e:.2e}' for e in errs]} of the float64 VJP's largest entries (float32 VJP "
            f"{[f'{e:.2e}' for e in plain_errs]}), same to the bit; kernels {r['ms']:.4f} ms, "
            f"plain VJP {r['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), tc bound "
            f"{tc_bound(*cost):.5f} ms; {json.dumps(r['occupancy'])}; {card}")
    return rows[kernel_inputs.GRAD_CASES[0]]


def layer_norm_cost(rows, h, backward):
    """The layer norm's kernels: the forward reads x and writes y (8 FLOPs an
    element), the backward reads x and dy and writes dx (12) and sums dscale
    and dbias through its float64 scratch; each reads scale (and bias) and
    the rows' mu and rstd.  -> (flops, bytes, product flops)."""
    from mmtraj_torch.ops import fused_layer_norm

    if not backward:
        return 8.0 * rows * h, 4.0 * (2 * rows * h + 2 * rows + 2 * h), 0.0
    blocks = fused_layer_norm.plan(rows)[0]
    return (12.0 * rows * h, 4.0 * (3 * rows * h + 2 * rows + 3 * h) + 16.0 * blocks * 2 * h,
            0.0)


def layer_norm_phase(torch, dev, card) -> dict:
    """Phase 22: ``fused_layer_norm``'s forward and backward kernels
    (``csrc/layer_norm.cu``) at each of ``kernel_inputs.LN_CASES`` against the
    float64 chain (y and every gradient within ``GRAD_TOL`` of its largest
    entry, no more than ``GRAD_VS_PLAIN`` times further from it than the
    float32 plain chain with autograd) and against themselves, with device
    times of each kernel beside the plain chain's forward and its forward and
    backward by autograd and those of ``torch.nn.functional.layer_norm``
    (``library_ms``; its backward: forward and backward less forward), their
    bounds and occupancy, and the errors of each output; -> the kernels
    line's rows, at a config4-attn3 block's tokens."""
    from mmtraj_torch.models.layers import layer_norm
    from mmtraj_torch.ops import _build, fused_layer_norm as fln

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import kernel_inputs

    def with_grads(fn, x, scale, bias, dy):
        leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
        y = fn(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, dy))

    def plain(x, scale, bias):
        return layer_norm({"scale": scale, "bias": bias}, x)

    def library(x, scale, bias):
        return torch.nn.functional.layer_norm(x, x.shape[-1:], scale, bias, fln.EPS)

    def errors(got, want):
        return ", ".join(f"{(g.double() - w).abs().max().item() / w.abs().max().item():.2e}"
                         for g, w in zip(got, want))

    rows = {}
    with torch.enable_grad():
        for label, lead, h in kernel_inputs.LN_CASES:
            rng = np.random.default_rng(h + len(lead))
            x, scale, bias, dy = kernel_inputs.layer_norm_case(rng, lead, h, dev)
            before = (fln.fused_layer_norm.launches, fln.fused_layer_norm_grad.launches)
            got = with_grads(fln.fused_layer_norm, x, scale, bias, dy)
            again = with_grads(fln.fused_layer_norm, x, scale, bias, dy)
            want = with_grads(lambda *a: fln.layer_norm_math(*a)[0],
                              *(t.double() for t in (x, scale, bias, dy)))
            ref = with_grads(plain, x, scale, bias, dy)
            lib = with_grads(library, x, scale, bias, dy)
            torch.cuda.synchronize()
            counts = (fln.fused_layer_norm.launches - before[0],
                      fln.fused_layer_norm_grad.launches - before[1])
            err = faithful(torch, got, ref, want)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            check(counts == (2, 2) and same,
                  f"fused_layer_norm {label}: launches {counts}, repeats to the bit {same}")
            n_rows = x.numel() // h
            _, mu, rstd = fln.layer_norm_math(x, scale, bias)
            leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
            with torch.no_grad():
                fwd_ms = time_ms(torch, lambda: fln.fused_layer_norm(x, scale, bias))
                bwd_ms = time_ms(torch, lambda: fln.fused_layer_norm_grad(x, scale, mu, rstd, dy))
                plain_ms = time_ms(torch, lambda: plain(x, scale, bias))
                lib_ms = time_ms(torch, lambda: library(x, scale, bias))
            plain_both_ms = time_ms(torch, lambda: torch.autograd.grad(plain(*leaves), leaves, dy))
            lib_both_ms = time_ms(torch, lambda: torch.autograd.grad(library(*leaves), leaves, dy))
            for name, backward, ms, p_ms, l_ms in (
                    ("fused_layer_norm", False, fwd_ms, plain_ms, lib_ms),
                    ("fused_layer_norm_grad", True, bwd_ms, plain_both_ms - plain_ms,
                     lib_both_ms - lib_ms)):
                cost = layer_norm_cost(n_rows, h, backward)
                rows[(name, label)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=p_ms, library_ms=l_ms, cost=cost,
                    occupancy=_build.occupancy("layer_norm", h, int(backward)))
            bf, bb = (bound(*layer_norm_cost(n_rows, h, b)[:2])[0] for b in (False, True))
            strided = "" if x.is_contiguous() else " strided"
            log(f"fused_layer_norm {label} ({n_rows}, {h}){strided}: errors of y, dx, dscale, "
                f"dbias within {err:.2e} of the float64 chain's largest entries, same to the "
                f"bit; forward {fwd_ms:.4f} ms (plain {plain_ms:.4f}, bound {bf:.5f}), backward "
                f"{bwd_ms:.4f} ms (plain forward and backward {plain_both_ms:.4f}, bound "
                f"{bb:.5f}); library forward {lib_ms:.4f} ms, forward and backward "
                f"{lib_both_ms:.4f}; errors of y, dx, dscale, dbias: kernels {errors(got, want)}, "
                f"plain {errors(ref, want)}, library {errors(lib, want)}; forward "
                f"{json.dumps(rows[('fused_layer_norm', label)]['occupancy'])}, backward "
                f"{json.dumps(rows[('fused_layer_norm_grad', label)]['occupancy'])}; {card}")
    first = kernel_inputs.LN_CASES[0][0]
    return {name: rows[(name, first)] for name in ("fused_layer_norm", "fused_layer_norm_grad")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from mmtraj_torch.benchmarks.bench import card_line
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.graph.adjacency import proximity_adjacency
    from mmtraj_torch.metrics import best_of_k
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.ops import _build, fused_attend, fused_decoder, fused_gat, launch_counters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)  # inference records no graph; phase 10 turns it on
    dev = torch.device("cuda")

    # -- 1. versions and the card ---------------------------------------------
    card = card_line()
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    log(card)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall; per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for name in _build.KERNELS:
        for line in (_build.library_path(name).parent / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- inputs, as bench.py makes them ------------------------------------------
    cfg = config4()
    plain_cfg = dataclasses.replace(cfg.model, use_pallas=False, attend_kernel="xla",
                                    use_fused_decoder=False)
    route_a = dataclasses.replace(plain_cfg, use_pallas=True, use_fused_decoder=True)
    route_b = dataclasses.replace(plain_cfg, attend_kernel="pallas")
    plain = Forecaster(plain_cfg, TO, TP, device=dev, generator=torch.Generator().manual_seed(0))
    state = plain.state_dict()
    # On the device once, as a serving loop holds them: numpy stats would be
    # copied from host memory, which waits for the stream, on every call.
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(B, N, TO + TP, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)).astype(np.float32) * 5
    xy_obs = torch.tensor(xy[:, :, :TO], dtype=torch.float32, device=dev)
    gt = torch.tensor(xy[:, :, TO:], dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random((B, N)) < 0.75, device=dev)
    log(f"shapes: B={B} N={N} obs={TO} pred={TP} K={K}; valid agents {int(mask.sum())}")

    # -- 3. each kernel against its plain version, at the main path's shapes -----
    p = plain.params()
    carry = plain.encode(xy_obs, mask, stats)
    H = cfg.model.num_heads
    results = {}

    def with_self_loops(adj, m):
        eye = torch.eye(adj.shape[-1], dtype=torch.bool, device=dev)
        return (adj | (eye & m[:, None, :] & m[:, :, None])).float().contiguous()

    def tile(a):
        return a.repeat((K,) + (1,) * (a.ndim - 1)).contiguous()

    # attend at (B*K, N, HD): decoder GAT inputs from the encoder's state.
    g = p["dec"]["gat"]
    hk, mk, xyk = tile(carry.h), tile(mask), tile(xy_obs[:, :, -1])
    v = (hk @ g["wv"]).contiguous()
    s_src = (v @ fused_gat._block_diag(g["a_src"])).contiguous()
    s_dst = (v @ fused_gat._block_diag(g["a_dst"])).contiguous()
    att = with_self_loops(proximity_adjacency(xyk, mk, cfg.model.adjacency_radius), mk)
    attend_args = (v, s_src, s_dst, att)
    out_k = fused_attend.attend(v, s_src, s_dst, att, H)
    out_p = fused_attend.attend_math(v, s_src, s_dst, att, H)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
          f"attend kernel vs plain: max abs err {err}")
    results["attend"] = dict(
        occupancy=_build.occupancy("attend", N, H, v.shape[-1]),
        max_abs_err=err,
        ms=time_ms(torch, lambda: fused_attend.attend(v, s_src, s_dst, att, H)),
        plain_ms=time_ms(torch, lambda: fused_attend.attend_math(v, s_src, s_dst, att, H)),
        cost=attend_cost(B * K, N, v.shape[-1], H))
    log(f"attend {tuple(v.shape)} H={H}: max abs err {err:.3e} (tol {KERNEL_TOL}); "
        f"kernel {results['attend']['ms']:.4f} ms, plain {results['attend']['plain_ms']:.4f} ms; "
        f"edges {int(att.sum())} of {att.numel()}")

    def check_gat(label, args):
        b, n, d = args[0].shape
        hd, dout = args[2].shape[1], args[5].shape[1]
        out_k, out_p = fused_gat.fused_gat(*args), fused_gat.gat_math(*args)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
              f"fused_gat kernel vs plain ({label}): max abs err {err}")
        r = dict(occupancy=_build.occupancy("gat", n, d, H, hd, dout), max_abs_err=err,
                 ms=time_ms(torch, lambda: fused_gat.fused_gat(*args)),
                 plain_ms=time_ms(torch, lambda: fused_gat.gat_math(*args)),
                 cost=gat_cost(b, n, d, hd, H, dout))
        bound_ms, bound_by = bound(*r["cost"][:2])
        log(f"fused_gat {(b, n, d)} H={H} ({label}): max abs err {err:.3e} (tol {KERNEL_TOL}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}), tc bound {tc_bound(*r['cost']):.6f} ms; edges {int(args[1].sum())} "
            f"of {args[1].numel()}; {json.dumps(r['occupancy'])}")
        return r

    # fused_gat at (B, N, D): the encoder GAT on the last observed frame, and
    # the decoder's GAT on the attend inputs' (B*K, N) graphs.
    g = p["enc"]["gat"]
    att = with_self_loops(proximity_adjacency(xy_obs[:, :, -1], mask,
                                              cfg.model.adjacency_radius), mask)
    gat_weights = (g["wv"], g["a_src"], g["a_dst"], g["wo"], g["bo"], H)
    results["fused_gat"] = check_gat("encoder, last observed frame",
                                     (carry.h.contiguous(), att, *gat_weights))
    gd = p["dec"]["gat"]
    check_gat("decoder step", (hk, attend_args[3], gd["wv"], gd["a_src"], gd["a_dst"], gd["wo"],
                               gd["bo"], H))

    # fused_decode at B*K rollout graphs, on a stream drawn on the card.
    M = cfg.model.num_mixtures
    hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], M)
    dec_kw = dict(num_heads=H, num_mixtures=M, radius=cfg.model.adjacency_radius,
                  sigma_min=cfg.model.sigma_min, rho_max=cfg.model.rho_max,
                  stats_mean=stats.mean, stats_std=stats.std)
    n_weights = sum(t.numel() for t in (*(x for d in p["dec"].values() if isinstance(d, dict)
                                            for x in d.values()), hw, hb))
    HD = g["wv"].shape[1]

    def check_decode(h_, xy_, m_):
        bk, n = m_.shape
        gumbel, normal = plain._rollout_stream(bk, n, torch.Generator(device=dev).manual_seed(2))
        args = (h_, xy_, m_, gumbel, normal, p["dec"], hw, hb)
        out_k = fused_decoder.fused_decode(*args, **dec_kw)
        out_p = fused_decoder.reference_decode(*args, **dec_kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"fused_decode N={n}: output is not finite")
        diff = torch.where(m_[:, None, :, None], (out_k - out_p).abs(), 0.0)
        per_graph = diff.flatten(1).amax(1)
        diverged = int((per_graph > ROLLOUT_TOL).sum())
        err = per_graph[per_graph <= ROLLOUT_TOL].max().item()
        check(diverged <= MAX_DIVERGED * bk,
              f"fused_decode N={n}: {diverged} of {bk} rollouts past {ROLLOUT_TOL} m")
        r = dict(max_abs_err=err,
                 ms=time_ms(torch, lambda: fused_decoder.fused_decode(*args, **dec_kw), inner=2),
                 plain_ms=time_ms(torch, lambda: fused_decoder.reference_decode(*args, **dec_kw),
                                  reps=5, inner=1),
                 cost=decode_cost(bk, TP, n, cfg.model.hidden_dim, cfg.model.embed_dim, HD, H, M,
                                  n_weights),
                 occupancy=_build.occupancy("decoder", n, cfg.model.hidden_dim,
                                            cfg.model.embed_dim, H, HD, M))
        log(f"fused_decode (Bk={bk}, T={TP}, N={n}): max abs err {err:.3e} m on valid agents "
            f"of the rollouts within tol {ROLLOUT_TOL}; {diverged} of {bk} rollouts past it; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{bound(*r['cost'][:2])[0]:.4f} ms, tc bound {tc_bound(*r['cost']):.4f} ms; "
            f"{json.dumps(r['occupancy'])}")
        return r

    results["fused_decode"] = check_decode(hk, xyk, mk)
    # and at the dense crowd's (B*K, N) = (240, 128), inputs as rollout_bench makes them.
    from mmtraj_torch.benchmarks import rollout_bench

    xy_c, mask_c = rollout_bench.crowd_inputs(CB, CNS[0], TO, dev)
    carry_c = plain.encode(xy_c, mask_c, stats)
    check_decode(tile(carry_c.h), tile(xy_c[:, :, -1]), tile(mask_c))
    att_c = with_self_loops(proximity_adjacency(xy_c[:, :, -1], mask_c,
                                                cfg.model.adjacency_radius), mask_c)
    check_gat("dense crowd's encoder state", (carry_c.h.contiguous(), att_c, *gat_weights))
    # and at the attention encoder's training shapes (config4-attn3): every observed frame of
    # a batch of 128 windows of 64 agents one graph, (B·T, N, H) = (1024, 64, 64), 4 heads of 16.
    xy_t, mask_t = rollout_bench.crowd_inputs(ATTN_B, N, TO, dev)
    xy_f = xy_t.transpose(1, 2).reshape(ATTN_B * TO, N, 2)
    mask_f = mask_t[:, None, :].expand(ATTN_B, TO, N).reshape(ATTN_B * TO, N)
    att_f = with_self_loops(proximity_adjacency(xy_f, mask_f, cfg.model.adjacency_radius), mask_f)
    x_f = torch.randn((ATTN_B * TO, N, cfg.model.hidden_dim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    check_gat("attention encoder's frame graphs", (x_f, att_f, *gat_weights))

    # -- 4./5. the routes end to end, through Forecaster.rollout_k -----------------
    counters = launch_counters()
    launches = dict.fromkeys(counters, 0)  # summed over the main-path runs

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    def run_route(name, model_cfg, expect):
        model = Forecaster(model_cfg, TO, TP, device=dev, state=state)
        expect = {**dict.fromkeys(counters, 0), **expect}
        reset_counts()
        roll = model.rollout_k(xy_obs, mask, stats, K,
                               generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == expect, f"route {name}: launches {counts}, expected {expect}")
        for k, c in counts.items():
            launches[k] += c
        ref = plain.rollout_k(xy_obs, mask, stats, K,
                              generator=torch.Generator(device=dev).manual_seed(1))
        check(roll.shape == (K, B, N, TP, 2), f"route {name}: shape {tuple(roll.shape)}")
        check(bool(torch.isfinite(roll).all()), f"route {name}: output is not finite")
        d = torch.where(mask[None, :, :, None, None], (roll - ref).abs(), 0.0)
        per = d.flatten(2).amax(2)  # (K, B)
        n_bad = int((per > ROLLOUT_TOL).sum())
        check(n_bad <= MAX_DIVERGED * K * B,
              f"route {name}: {n_bad} of {K * B} rollouts past {ROLLOUT_TOL} m of the plain route")
        ade, fde = best_of_k(roll, gt, mask)
        ade_p, fde_p = best_of_k(ref, gt, mask)
        check(bool(torch.isfinite(ade) & torch.isfinite(fde)), f"route {name}: best_of_k not finite")
        iters = 10
        model.rollout_k(xy_obs, mask, stats, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model.rollout_k(xy_obs, mask, stats, K)
        torch.cuda.synchronize()
        rate = B * K * iters / (time.perf_counter() - t0)
        log(f"route {name}: launches {counts}; max abs err vs plain "
            f"{per[per <= ROLLOUT_TOL].max().item():.3e} m, {n_bad} of {K * B} rollouts past "
            f"{ROLLOUT_TOL} m; best-of-{K} ADE/FDE {ade.item():.4f}/{fde.item():.4f} m "
            f"(plain {ade_p.item():.4f}/{fde_p.item():.4f}); {rate:.1f} window-rollouts/s")
        return rate

    rate_a = run_route("A", route_a, {"fused_gat": TO, "fused_decode": 1})
    rate_b = run_route("B", route_b, {"attend": TO + TP})
    rate_p = run_route("plain", plain_cfg, {})
    log(f"window-rollouts/s (K={K}, B={B}, N={N}): route A {rate_a:.1f}, route B {rate_b:.1f}, "
        f"plain {rate_p:.1f}")

    # -- 6. dense crowd -----------------------------------------------------------
    # attend and the lane-packed kernel against the plain chain at the main
    # path's (B*K, N, HD), then on an odd B with an all-masked row (graph 0,
    # agent 5 loses every edge, its self-loop included).
    def packed(*a):
        return fused_attend.attend(*a, 8, True)

    def check_attend(label, fn, args):
        out_k, out_p = fn(*args, H), fused_attend.attend_math(*args, H)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
              f"{label}: max abs err {err}")
        return out_k, err

    masked = attend_args[3].clone()
    masked[0, 5] = 0.0
    odd_args = tuple(a[:B * K - 1] for a in attend_args[:3]) + (masked[:B * K - 1],)
    for name, fn in (("attend", fused_attend.attend), ("attend_packed", packed)):
        _, err = check_attend(f"{name} {tuple(v.shape)}", fn, attend_args)
        out_k, err_odd = check_attend(f"{name} odd B={B * K - 1}", fn, odd_args)
        check(not out_k[0, 5].any(), f"{name}: the all-masked row is not zero")
        log(f"{name} {tuple(v.shape)} H={H}: max abs err {err:.3e}, odd B={B * K - 1} with an "
            f"all-masked row {err_odd:.3e} (tol {KERNEL_TOL})")
    # The packed kernel's gradient (JAX's custom_vjp: the VJP of the plain
    # math on the saved inputs) against autograd of attend_math; then S lanes
    # under vmap, folded by the op's vmap rule into one launch, against S
    # launches, to the bit.
    leaves = [a.detach().clone().requires_grad_() for a in attend_args[:3]]
    up = torch.randn(v.shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    n0 = fused_attend.attend_packed.launches
    with torch.enable_grad():
        g_k = torch.autograd.grad(packed(*leaves, attend_args[3], H), leaves, up)
        n_grad = fused_attend.attend_packed.launches - n0
        g_p = torch.autograd.grad(fused_attend.attend_math(*leaves, attend_args[3], H), leaves,
                                  up)
    torch.cuda.synchronize()
    grad_err = max((a - b).abs().max().item() for a, b in zip(g_k, g_p))
    check(n_grad == 1 and all(torch.allclose(a, b, atol=KERNEL_TOL, rtol=KERNEL_TOL)
                              for a, b in zip(g_k, g_p)),
          f"attend_packed gradient: {n_grad} launches, max abs err {grad_err}")
    lanes = [torch.stack([a.roll(i, 0) for i in range(PACKED_LANES)]) for a in attend_args[:3]]
    n0 = fused_attend.attend_packed.launches
    folded = torch.func.vmap(lambda a, b, c: packed(a, b, c, attend_args[3], H))(*lanes)
    n_vmap = fused_attend.attend_packed.launches - n0
    apart = torch.stack([packed(*(x[i] for x in lanes), attend_args[3], H)
                         for i in range(PACKED_LANES)])
    torch.cuda.synchronize()
    check(n_vmap == 1 and torch.equal(folded, apart),
          f"attend_packed under vmap: {n_vmap} launches for {PACKED_LANES} lanes, max abs "
          f"diff to one launch a lane {(folded - apart).abs().max().item()}")
    log(f"attend_packed {tuple(v.shape)} H={H}: gradient (v, s_src, s_dst) max abs err "
        f"{grad_err:.3e} vs autograd of the plain math (tol {KERNEL_TOL}), one launch; vmap of "
        f"{PACKED_LANES} lanes in {n_vmap} launch, equal to {PACKED_LANES} launches to the bit")
    results["attend_packed"] = dict(
        occupancy=_build.occupancy("attend_packed", N, H, v.shape[-1]),
        max_abs_err=max(err, err_odd),
        ms=time_ms(torch, lambda: packed(*attend_args, H)),
        plain_ms=time_ms(torch, lambda: fused_attend.attend_math(*attend_args, H)),
        cost=attend_cost(B * K, N, v.shape[-1], H))
    log(f"attend_packed {tuple(v.shape)}: kernel {results['attend_packed']['ms']:.4f} ms, "
        f"plain {results['attend_packed']['plain_ms']:.4f} ms")

    # rollout_k at the dense-crowd shapes under "auto", inputs as the
    # benchmark makes them; the first input of each shape that the attend
    # wrapper hands its kernel is kept for the checks below.
    captured = {}
    real_launch = fused_attend._launch

    def recording_launch(name, v_, s_src_, s_dst_, att_, heads):
        if name == "attend":
            captured.setdefault(tuple(v_.shape), (v_, s_src_, s_dst_, att_))
        return real_launch(name, v_, s_src_, s_dst_, att_, heads)

    def dense_route(encoder, n_max, expect_attend):
        xla_cfg = dataclasses.replace(cfg.model, encoder=encoder, attend_kernel="xla")
        ref_model = Forecaster(xla_cfg, TO, TP, device=dev,
                               generator=torch.Generator().manual_seed(0))
        model = Forecaster(dataclasses.replace(xla_cfg, attend_kernel="auto"), TO, TP,
                           device=dev, state=ref_model.state_dict())
        xy_c, mask_c = rollout_bench.crowd_inputs(CB, n_max, TO, dev)
        expect = {**dict.fromkeys(counters, 0), "attend": expect_attend}
        fused_attend._launch = recording_launch
        try:
            reset_counts()
            roll = model.rollout_k(xy_c, mask_c, stats, K,
                                   generator=torch.Generator(device=dev).manual_seed(1))
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            fused_attend._launch = real_launch
        check(counts == expect, f"dense {encoder} N={n_max}: launches {counts}, expected {expect}")
        for k, c in counts.items():
            launches[k] += c
        ref = ref_model.rollout_k(xy_c, mask_c, stats, K,
                                  generator=torch.Generator(device=dev).manual_seed(1))
        check(roll.shape == (K, CB, n_max, TP, 2), f"dense {encoder}: shape {tuple(roll.shape)}")
        check(bool(torch.isfinite(roll).all()), f"dense {encoder}: output is not finite")
        d = torch.where(mask_c[None, :, :, None, None], (roll - ref).abs(), 0.0)
        per = d.flatten(2).amax(2)
        n_bad = int((per > ROLLOUT_TOL).sum())
        check(n_bad <= MAX_DIVERGED * K * CB,
              f"dense {encoder} N={n_max}: {n_bad} of {K * CB} rollouts past {ROLLOUT_TOL} m")
        log(f"dense {encoder} N={n_max} B={CB} K={K} auto: launches {counts}; max abs err vs "
            f"xla {per[per <= ROLLOUT_TOL].max().item():.3e} m, {n_bad} of {K * CB} rollouts "
            f"past {ROLLOUT_TOL} m; valid agents {int(mask_c.sum())}")

    dense_route("rnn", CNS[0], TO + TP)
    dense_route("attn", CNS[0], cfg.model.attn_layers + TP)
    for n_max in CNS[1:]:
        dense_route("rnn", n_max, TO + TP)
    shapes = {(CB * TO, CNS[0], HD)} | {(b, n, HD) for n in CNS for b in (CB, CB * K)}
    check(set(captured) == shapes, f"dense-crowd attend shapes {sorted(captured)}")

    # attend on the inputs the dense-crowd runs gave it.
    for shape in sorted(captured):
        args = captured[shape]
        _, err = check_attend(f"attend {shape}", fused_attend.attend, args)
        ms = time_ms(torch, lambda: fused_attend.attend(*args, H))
        plain_ms = time_ms(torch, lambda: fused_attend.attend_math(*args, H))
        cost = attend_cost(*shape, H)
        bound_ms, bound_by = bound(*cost[:2])
        log(f"attend {shape} H={H} (dense crowd): max abs err {err:.3e} (tol {KERNEL_TOL}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"tc bound {tc_bound(*cost):.5f} ms; edges {int(args[3].sum())} of "
            f"{args[3].numel()}; {json.dumps(_build.occupancy('attend', shape[1], H, shape[2]))}")

    # The benchmark end to end, "xla" then "auto", with exact counts:
    # bench_rollout makes 4 * iters rollout_k calls (a warm-up run, 3 trials).
    dense_rates = {}
    for encoder, per_call in (("rnn", TO + TP), ("attn", cfg.model.attn_layers + TP)):
        for kernel in ("xla", "auto"):
            reset_counts()
            rate = rollout_bench.bench_rollout(CNS[0], kernel, CB, K, CITERS, encoder=encoder,
                                               device=dev)
            want = per_call * 4 * CITERS if kernel == "auto" else 0
            check(read_counts() == {**dict.fromkeys(counters, 0), "attend": want},
                  f"bench_rollout {encoder} {kernel}: launches {read_counts()}, attend {want}")
            check(rate > 0, f"bench_rollout {encoder} {kernel}: rate {rate}")
            dense_rates.setdefault(f"{encoder}/{kernel}", []).append(rate)
    log(f"dense-crowd window-rollouts/s (N={CNS[0]}, B={CB}, K={K}; xla, then auto): "
        f"{json.dumps(dense_rates)}")

    # A short op sweep: one B, each N; the packed kernel where 2N <= 128.
    reset_counts()
    sweep = rollout_bench.op_sweep(num_heads=H, dh=HD // H, iters=SWEEP_ITERS, device=dev,
                                   ns=SWEEP_NS, bs=(SWEEP_B,))
    sweep_counts = read_counts()
    per_shape = 1 + 3 * SWEEP_ITERS  # op_sweep's warm-up call and 3 timed runs
    want = {**dict.fromkeys(counters, 0), "attend": len(SWEEP_NS) * per_shape,
            "attend_packed": sum(2 * n <= 128 for n in SWEEP_NS) * per_shape}
    check(sweep_counts == want, f"op_sweep launches {sweep_counts}, expected {want}")
    launches["attend_packed"] += sweep_counts["attend_packed"]  # its only caller
    for row in sweep:
        log("op_sweep " + json.dumps(row))

    # -- 8. the evaluator ----------------------------------------------------------
    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        for k, c in counts.items():
            launches[k] += c
        return out, counts

    evaluator_phase(torch, dev, card, cfg, plain_cfg, route_a, state, counted,
                    dict.fromkeys(counters, 0))

    # -- 9. the bench ------------------------------------------------------------------
    bench_routes = {"plain": (plain_cfg, {}), "A": (route_a, {"fused_gat": TO, "fused_decode": 1}),
                    "B": (route_b, {"attend": TO + TP})}
    bench_phase(torch, dev, card, state, stats, xy_obs, mask, bench_routes, counted,
                dict.fromkeys(counters, 0))

    # -- 10. training --------------------------------------------------------------------
    training_phase(torch, dev, card, cfg, counted, dict.fromkeys(counters, 0))

    log(f"phases 1-10: {time.perf_counter() - t_start:.1f} s")

    # -- 11. graphed training, the attention encoder, remat policies, the LSTM -----------
    t0 = time.perf_counter()
    graphed_training_phase(torch, dev, card, cfg, counted, dict.fromkeys(counters, 0))
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # -- 12. bf16 and the checkpoint formats -------------------------------------------------
    t0 = time.perf_counter()
    bf16_phase(torch, dev, card, cfg, plain_cfg, route_a, route_b, state, stats, xy_obs, mask, gt,
               counted, dict.fromkeys(counters, 0))
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # -- 13. export and serving ------------------------------------------------------------
    t0 = time.perf_counter()
    serving_phase(torch, dev, card, cfg, bench_routes, state, stats, xy_obs, mask, counted,
                  dict.fromkeys(counters, 0))
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # -- 14. scale-out: the population, config 5's data parallelism, streaming ---------
    t0 = time.perf_counter()
    scale_out_phase(torch, dev, card, cfg, counted, dict.fromkeys(counters, 0), results)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    log(f"phases 1-14: {time.perf_counter() - t_start:.1f} s")

    # -- 15. the leave-one-out protocol and its tools -------------------------------------
    t0 = time.perf_counter()
    protocol_phase(torch, dev, card, counted, dict.fromkeys(counters, 0))
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")

    # -- 16. the importers, the native parser, visualize, the build directory -------------
    t0 = time.perf_counter()
    importers_phase(torch, dev, card, cfg, plain_cfg, route_a, state, counted,
                    dict.fromkeys(counters, 0))
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # -- 17. the JAX package's Orbax directory -----------------------------------------------
    t0 = time.perf_counter()
    orbax_phase(torch, dev, card,
                lambda m: dataclasses.replace(m, use_pallas=True, use_fused_decoder=True,
                                              attend_kernel="xla"),
                xy_obs, mask, counted, dict.fromkeys(counters, 0))
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # -- 18. config 3, the quality recipe's model ----------------------------------------------
    t0 = time.perf_counter()
    config3_phase(torch, dev, card, counted, dict.fromkeys(counters, 0))
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # -- 19. the experiments' scripts and reports, the kernels at their shapes ------------------
    t0 = time.perf_counter()
    experiments_phase(torch, dev, card, counted, dict.fromkeys(counters, 0))
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # -- 20. the weight gradient of the dense products ------------------------------------------
    t0 = time.perf_counter()
    results["weight_grad_lanes"] = wgrad_phase(torch, dev, card)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # -- 21. the GAT's backward ------------------------------------------------------------------
    t0 = time.perf_counter()
    results["fused_gat_grad"] = gat_grad_phase(torch, dev, card)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")

    # -- 22. the layer norm ------------------------------------------------------------------
    t0 = time.perf_counter()
    results.update(layer_norm_phase(torch, dev, card))
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")

    # -- 7. the kernels line ----------------------------------------------------
    sources = {
        "attend": ("mmtraj_torch/csrc/attend.cu", "mmtraj/ops/fused_attend.py:212"),
        "attend_packed": ("mmtraj_torch/csrc/attend_packed.cu", "mmtraj/ops/fused_attend.py:229"),
        "fused_gat": ("mmtraj_torch/csrc/gat.cu", "mmtraj/ops/fused_gat.py:150"),
        "fused_gat_lanes": ("mmtraj_torch/csrc/gat.cu", "mmtraj/ops/fused_gat.py:150"),
        "fused_decode": ("mmtraj_torch/csrc/decoder.cu", "mmtraj/ops/fused_decoder.py:208"),
        "weight_grad_lanes": ("mmtraj_torch/csrc/wgrad.cu", None),  # XLA's product in JAX
        "fused_gat_grad": ("mmtraj_torch/csrc/gat_grad.cu", None),  # JAX's VJP of the plain math
        "fused_layer_norm": ("mmtraj_torch/csrc/layer_norm.cu", None),  # XLA's fusion in JAX
        "fused_layer_norm_grad": ("mmtraj_torch/csrc/layer_norm.cu", None),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        bound_ms, bound_by = bound(*r["cost"][:2])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "tc_bound_ms": tc_bound(*r["cost"]),
                        "library_ms": r.get("library_ms"), **r["occupancy"]})
    missing = [k["name"] for k in kernels if not k["launches"]]
    check(not missing, f"kernels never launched on their path: {missing}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
