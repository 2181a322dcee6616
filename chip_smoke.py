#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) on any error:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``exploring_meta_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all started together, and print what
   ``ptxas`` reports;
3. serving (slice 1): at each of the four CNN4-Omniglot block shapes (B =
   64 requests, 25 support images each), in float32 and bfloat16, launch
   every fused-block kernel, hold it against its plain PyTorch twin, and
   time kernel, twin and a PyTorch library yardstick with CUDA events
   (for ``cnn4_block_bwd_params``, whose five outputs no one PyTorch call
   computes, the grouped ``conv2d_weight`` of its dw part only); hold
   every kernel against its twin at the query forward (N = 15), at B = 1,
   N = 1, and at N = 128 and N = 400 (block 1), and ``bwd_params`` twice
   with bitwise equal results; time the forward at N = 15 too; then load
   full-width
   ``omniglot_spec(ways=5)`` params from ``.npz`` and serve 64
   synthetic-Omniglot requests through ``VisionServer.batch`` with the
   launch counters zeroed just before and read just after, check
   that every kernel ran, that the batch agrees with per-request
   ``__call__`` and with the CPU path, and that the support set is
   labelled above chance; time and profile it;
4. the GAE / discount sweeps (slice 2; a segmented affine scan over
   time): at ``[20, 100, 20]``, ``[64, 50, 10]`` (a served policy
   batch), ``[40, 150, 20]``, ``[100, 400]`` and ``[100]`` (timed), and at
   T = 1, T = 129 (one past a slab) and T = 1000
   (checked only), with dones mid-column, all zero and all one, hold each
   kernel against its twin and a float64 CPU reference, forward and
   backward, and each twice at ``[20, 100, 20]`` with bitwise equal
   results; time kernel (device microseconds a launch) and twin;
5. MAML-TRPO meta-training (slice 2): 3 full-width iterations of
   ``RLTrainer`` on Particles2D in a temporary run dir, with the launch
   counters zeroed just before; check that both sweeps ran in every
   iteration, that the metrics are finite, that the run-dir artifacts
   exist and load, and that the final meta-test is finite; then one
   outer step on identical replays on the card and on the CPU path, which
   must agree; then profile one iteration;
6. vision meta-training (slice 6): one full-width second-order
   meta-gradient (4 tasks, f32, inner_lr 0.05) through the fused kernels,
   held against a float64 reference on the kernels' ReLU masks and, more
   loosely, the direct path (cuDNN) and the CPU path, bf16's loss
   against f32's, with the launch counters showing that the kernels ran
   under ``create_graph=True``; 3 iterations of ``VisionTrainer`` at
   ``bench.py``'s ``maml_omni`` configuration (bf16, meta-batch 32) in a
   temporary run dir, with the counters zeroed just before and checked per
   iteration, finite metrics, the saved model and checkpoint loading back
   and a finite meta-test; tasks/s of the meta-step in f32 and bf16,
   fused and direct, timed in turns (CUDA-graph replays of
   ``make_train_scan``, as ``bench.py`` times one XLA program); one
   eager meta-step profiled (idle share,
   launches, device time of the CNN4 kernels, of the plain double backward
   and of the rest);
7. meta-RL policy serving (slice 7), at ``bench.py``'s ``serve_rl``:
   a full-width ``DiagNormalPolicy`` (100, 100) with random weights, 64
   Particles2D support trajectories of 10 episodes x 50 steps collected on
   the card; for each of vpg, ppo and trpo, ``PolicyServer.adapt_batched``
   with the sweep counters zeroed just before and checked just after
   (each sweep once per inner step), the adapted params held against the
   CPU path on the same stack (on the card's baseline fits, with the
   discounted returns each fit was given held against the CPU's) and
   against per-request ``adapt``, and ``act_batched`` against per-task
   ``act``; an ANIL policy once, its body unchanged; the batch timed
   (requests/s, wall) and profiled;
8. Adam meta-RL training (slice 7): 4 full-width ``RLTrainer`` iterations
   of maml_ppo and of anil_vpg (the ``RLScriptConfig`` defaults) in
   temporary run dirs, with the counters zeroed just before; check the
   sweeps ran once per support batch and once for the query in every
   iteration, finite metrics, run dirs that load and a finite meta-test;
   s per iteration (iterations 2-3), and the fourth profiled (idle share,
   launches, the sweeps' device time); one ``make_replay_meta_loss("ppo")``
   value and meta-gradient on identical replays on the card and on the
   CPU, with every PPO ratio recorded;
9. fused meta-iterations (slice 8, ``--fuse 10``) as CUDA-graph replays:
   for MAML-TRPO at ``bench.py``'s ``trpo_particles``, maml_ppo and
   ``maml_omni`` (bf16, meta-batch 32), 20 iterations through the trainer
   (two chunks, the first with the eager warm-up) with the counters zeroed
   just before: one capture and 19 replays, each kernel of the path
   launched by the warm-up and recorded in the graph; the final params
   against the same run at ``fuse 1`` (Adam within 1e-5 of max|params|,
   TRPO within 2e-2 of the step), and ``fuse 1`` against itself; then,
   on the same objects built outside the trainer, one replay against one
   eager iteration from the same generator state, s per iteration of the
   graph and eager in turns, and a chunk of replays and one eager
   iteration profiled (host launches per iteration, idle share, the
   kernels inside the replays); phase 5 also profiles the TRPO line
   search, stopping early and host-free;
10. the analysis tier (slice 9): a full-width vision run dir
    (``VisionTrainer``, ``omniglot_spec(5)``, 2 iterations, a checkpoint
    each) through ``eval_vision.run`` and a MAML-TRPO run dir through
    ``eval_rl.run(run_cl=True, run_rc=True)``, each with the counters
    zeroed just before (every CNN4 kernel under eval_vision, both sweeps
    under eval_rl) and each section timed (ckpt sweep, meta-test, CL, RC,
    through-time); every artifact exists and parses with JAX's keys and
    finite numbers, the vision CCA values in [0, 1]; RC again with vpg
    and ppo; one CL matrix from one pool held card vs CPU (adapted params,
    logits, tie flips counted; ANIL once) and profiled (idle share); CKA
    and CCA of the RC activations against float64 on the CPU;
11. the non-meta baselines and bf16 meta-RL (slice 10): the CNN4 kernels
    at B = 1, N = 10 (TPU-kernel rows 1-2, the vision baseline's Adam
    step) against their twins in f32 and bf16 at the four block shapes,
    each timed (CUDA events, profiler device time, twin, library); the
    PPO, TRPO and random baselines, 2 iterations each at the
    ``RLScriptConfig`` defaults, and the vision baseline, 2 iterations at
    the script's defaults on Omniglot's real shape, each with the
    counters zeroed just before: each sweep once a task (the random
    policy the discount sweep alone), the CNN4 kernels 4 / 4 / 3 an Adam
    step, plus the meta-tests' launches, exactly; finite metrics, a
    finite test reward or accuracy, run dirs that load; one PPO, one
    TRPO and one vision update card vs CPU (on the card's baseline fit);
    maml_trpo ``--bf16 --fuse 10`` through the trainer (one capture, 19
    replays), s per replayed iteration bf16 against f32 in turns, one
    eager maml_ppo ``--bf16`` iteration, and the bf16 density on the
    card against the CPU path (equal but at bf16 ties) and f32;
12. the run utilities and the offline tools (slice 11): whether
    gymnasium, mujoco and Pillow import here; ``--resume`` bit for bit,
    each with the counters zeroed just before each run: maml_omni
    ``--fuse 5`` (10 iterations against a resume from ``model_4``: one
    capture and 4 replays, the CNN4 kernels launched and recorded),
    maml_trpo ``--fuse 10`` at ``trpo_particles`` (20 against a resume
    from ``model_9``: 1 capture, 9 replays, both sweeps) and maml_ppo
    eager (3 against a resume from ``model_1``): rows, final params and
    final meta-test equal exactly; maml_omni ``--fuse 5 --async_ckpt``,
    every checkpoint equal to the synchronous run's, and the ms a
    checkpoint holds the training thread; maml_ppo with ``--ckpt_backend
    orbax`` (DCP) resumed from its ``model_checkpoints/``, equal exactly;
    a reference-layout Omniglot CNN4 ``state_dict`` through
    ``import_reference_run`` into ``VisionServer``, one request (B = 1)
    and a batch on the kernels against the CPU path; 3 eager maml_omni
    iterations plain, with ``--profile`` (JAX's phases and schema) and,
    last, with ``--trace`` (a Chrome trace naming ``cnn4_block_fwd``),
    s an iteration each;
13. seed sweeps (slice 12), through ``sweep.main`` with the counters
    zeroed just before each: the serial sweep of maml_trpo (the
    ``RLScriptConfig`` defaults) and maml_vision (``maml_omni``), 2 seeds
    x 2 iterations, each seed's rows and final params bit for bit a
    standalone trainer run's, each kernel launched as often as the
    standalone runs together; the summary JSON with JAX's keys and a
    finite ``band_final_mean`` (one printed line where matplotlib is
    missing); ``--vmap_seeds`` at ``--fuse 3`` for 3 iterations: MAML-TRPO
    at ``bench.py``'s ``multiseed_trpo`` (S = 4) and at the defaults (S =
    2), maml_ppo (S = 2, Adam 0.01) and ``maml_omni`` (S = 4: the CNN4
    kernels at B = 128), each one capture for all seeds, a seeded
    iteration recording each kernel as often as one seed's; each seed's
    first row against its solo run's (RL 1e-5 relative, bf16 vision 1e-2),
    one seeded iteration from the initial states against the solo ones
    (TRPO the same line-search outcome and 0.3 of the step; vision in f32:
    rows 1e-5, meta-gradients 1e-2 of max|grad|, Adam's sign flips 1e-3
    of the params at most), PPO's whole run within 1e-4 of max|params|,
    the other runs' end against their solo runs reported;
    seed-iterations/s (tasks/s) of one program against the solo scans one
    after another, in turns, and the idle share of a profiled seeded
    chunk; the three CNN4 kernels at B = 128 against their twins (f32,
    bf16) and timed;
14. host envs (slice 13): build ``native/vecenv.cpp`` with ``g++``
    (timed); ``NativeVecEnv("particles2d")`` against the device
    Particles2D on the card for 100 steps (obs within 1e-6, ``done``
    equal); with ``tests/fake_metaworld.py`` installed as ``metaworld``
    (the card's machine has no metaworld, gymnasium or mujoco), the
    process pinned to 2 CPUs (the pools then run 2 threads), at the
    ``RLScriptConfig`` defaults on ML10 (meta-tests cut to 2 tasks) and
    with the counters zeroed just before each: maml_trpo for 2 iterations
    collected per task, maml_ppo ``--task_batch`` for 2 iterations (Adam
    0.01), ``meta_test`` with ``each3`` and ``eval_rl --each3 --task_batch
    --cl --rc`` on the run dir, both sweeps launched in every iteration
    and on every path, the per-task JSON keyed by ML10's eval names, the
    bar plots written or one line each; one ``--host_policy cpu``
    iteration (no round trip to the card, the rollouts shipped there, the
    sweeps on the card); card against CPU: ``HostVecEnv.collect`` under
    one action table bit for bit, and on the replays of the trainers'
    last outer steps a TRPO inner step (1e-5 of max|params|), the TRPO
    outer step (the same line-search outcome, 2e-2 of the step), the PPO
    meta-gradient and one Adam step on it (1e-5 of lr); AntDirection-v1
    where gymnasium and mujoco import, else one line; every vec env that
    steps on the native pool; s per iteration per task (the trainer's)
    against one task-batched iteration, round trips and shipments per
    iteration, a profiled iteration's idle share, the pool's env steps/s
    at 400 slots on all CPUs and on 2, against the Python loop;
15. print one ``{"kernels": [...]}`` line, the card line again, and last
    ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``. The script imports neither
JAX nor the JAX package. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

SEED = 0
WAYS, SHOTS, QUERIES, BATCH = 5, 5, 15, 64
INNER_LR, ADAPT_STEPS = 0.5, 1
# (H, Ci) of the four CNN4-Omniglot blocks at hidden 64
BLOCKS = [(28, 1), (14, 64), (7, 64), (4, 64)]
HIDDEN = 64
# Shapes beyond the served support batch at which every CNN4 kernel is
# held against its twin, as (tasks, images per task, block index): the
# served query forward (N = 15; M = 735 at block 2 leaves a ragged last
# tile of 31 rows), the smallest call, the most images per task the tests
# ask for, and 400 images, past the 295 that bwd_params took when it kept
# a task's channel in shared memory.
EXTRA_SHAPES = ([(BATCH, QUERIES, k) for k in range(4)]
                + [(1, 1, k) for k in range(4)] + [(BATCH, 128, 0)]
                + [(BATCH, 400, 0)])
# H100 SXM data-sheet peaks: HBM bytes/s and f32 FLOP/s outside the
# tensor cores (the kernels do f32 FMAs on the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerance per dtype: |kernel - twin| <= atol * max|twin| + rtol * |twin|.
# f32: the two differ only in summation order. bf16: both compute in f32
# from the same bf16 inputs, but outputs are rounded to bf16 (8 bits of
# mantissa), so a last-bit f32 difference can move an output by one bf16
# ulp, 2^-7 relative.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# The conv-bias gradient db = sum(dy) is zero in exact arithmetic (BN
# removes dy's mean); both sides hold rounding noise, bounded relative to
# sum(|dy|) per (request, channel).
DB_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# GAE / discount sweeps, timed: the main path's [B, T, E]; a served
# policy batch's (64 requests x horizon 50 x 10 episodes, SERVE_RL_*); the
# JAX reference's own maml_trpo scale (40 tasks x 20 episodes x horizon
# 150, exploring_meta_tpu/utils/config.py:170-171); the [T, lanes] form; a
# single column. Checked only: T = 1, one step past a 128-step slab (one
# lane and 20 lanes of 4 tasks) and a long T.
SWEEP_SHAPES = [(20, 100, 20), (64, 50, 10), (40, 150, 20), (100, 400),
                (100,)]
SWEEP_CHECK_SHAPES = [(1,), (129,), (4, 129, 5), (1000,)]
GAMMA, TAU = 0.99, 1.0
# A sweep output is a discounted sum of up to T float32 terms, each rounded
# once (2^-24 relative). Their weights sum to at most 1 / (1 - gamma) = 100
# whatever T, so T = 1000 rounds like T = 100: |kernel - reference| <=
# 1e-5 * max|reference|.
SWEEP_TOL = 1e-5
# the sweep kernels' names in csrc/gae.cu, as the profiler reports them:
# one launch a call, of the instance for 4 or 8 steps a thread
KERNEL_NAMES = {"gae_sweep": "scan_kernel<true,",
                "discount_sweep": "scan_kernel<false,"}
TRPO_ITERATIONS = 3
# Vision meta-training (slice 6), bench.py's maml_omni: 5-way 5-shot,
# meta-batch 32, one inner step at inner_lr 0.5, Adam 3e-3, bf16 compute
# (cast_compute), synthetic Omniglot at its real shape (1623 classes x 20).
META_BATCH, VISION_ITERATIONS = 32, 3
# CNN4 kernel calls of one second-order meta-step: the support and query
# forwards (4 + 4); the inner backward (4 bwd_params + 3 bwd_input, block 1
# needs no dx); the outer pass, the query blocks' backward and the support
# blocks' backward (4 + 3 each). A meta-eval adapts first order: 8 / 4 / 3.
META_STEP_CALLS = {"cnn4_block_fwd": 8, "cnn4_block_bwd_params": 12,
                   "cnn4_block_bwd_input": 9}
META_EVAL_CALLS = {"cnn4_block_fwd": 8, "cnn4_block_bwd_params": 4,
                   "cnn4_block_bwd_input": 3}
# The second-order check: 4 tasks at full width, f32, inner_lr 0.05 (at
# 0.5 the f32 meta-gradient through batch-stat BN is ill-conditioned).
# At full width (1.25M block-1 activations a pass) a few ReLU inputs lie
# within f32 rounding of the kink, and two f32 paths (kernels, cuDNN, the
# CPU) may put one on opposite sides: that moves every leaf of the
# meta-gradient at once, by up to a few 1e-3 of its max|grad|
# ("direct_vs_reference_f64" in the output), more than the JAX test's
# tolerance and the size of the second-order term itself at this
# inner_lr. So the kernels' meta-gradient is held, per leaf at |got -
# want| <= 3e-4 |want| + 3e-5 max|want| (the JAX test's tolerances,
# tests/test_pallas_cnn4.py), against a float64 plain reference that
# takes the kernels' own ReLU masks (reference_meta_grad); against the
# direct path (cuDNN) and the CPU path, which make their own masks, within
# 1e-2 max|want|; the masks of the card and the CPU are compared. The
# conv-bias gradient is zero in exact arithmetic (BN removes the bias), so
# it is held by magnitude, within 1e-4 of the largest |gradient| of the
# block's BN bias, a sum over the same positions. The bf16 loss lies
# within 2e-2 of f32's; a bf16 meta-gradient lies far (tens of per cent,
# relative L2, "bf16_rel_l2") from the f32 one on either path, so the
# kernels' is held against cuDNN's bf16 one: no farther from f32 than
# 1.5x cuDNN's distance.
SO_TASKS, SO_LR = 4, 0.05
SO_TOL, SO_DB_TOL, SO_FLIP_TOL = (3e-4, 3e-5), 1e-4, 1e-2
BF16_LOSS_TOL, BF16_GRAD_RATIO = 2e-2, 1.5
# tasks/s as bench.py measures it: 32 x steps / wall time of make_train_scan
# over TIMED_STEPS steps (ended by a sync), after WARM_STEPS; best of
# WINDOWS windows, the configurations timed in turns. Since slice 8 the
# timed steps are CUDA-graph replays, as bench.py's are one XLA program.
TIMED_STEPS, WARM_STEPS, WINDOWS = 10, 2, 3
# profiler ranges: the kernel wrappers' and the plain double backward's
RANGES = ("cnn4_block_fwd", "cnn4_block_bwd_params", "cnn4_block_bwd_input",
          "cnn4_block_double_backward", "trpo_line_search")
# the kernels of csrc/cnn4_block.cu (the profiler prefixes their
# namespace and suffixes their template arguments)
CNN4_KERNEL_NAMES = ("fwd_conv_stats_kernel", "fwd_combine_kernel",
                     "fwd_norm_kernel", "bwd_input_kernel",
                     "bwd_tile_sums_kernel", "bwd_combine_kernel",
                     "bwd_dw_kernel", "bwd_dw_reduce_kernel")
# Meta-RL serving (slice 7), bench.py's serve_rl (bench.py:625-683): 64
# requests, each a support batch of 10 episodes x 50 steps on Particles2D,
# one first-order inner step at inner_lr 0.05; the batch timed as the mean
# of 5 calls after a warm one, ended by a sync.
SERVE_RL_REQUESTS, SERVE_RL_EPISODES, SERVE_RL_HORIZON = 64, 10, 50
SERVE_RL_CFG = dict(inner_lr=0.05, adapt_steps=1,
                    adapt_batch_size=SERVE_RL_EPISODES,
                    max_path_length=SERVE_RL_HORIZON)
# Card vs CPU, both on the card's linear-baseline fits (with_baseline_fits):
# the fit is a float32 ridge solve of condition ~1e5 on Particles2D's
# features, so each device's own fit of the same data may differ by ~1e-3
# of itself, and that moves the PPO meta-gradient by ~1e-3 of max|grad|;
# the error on each device's own fits is reported, not held. The
# discounted returns each fit is given (the discount sweep's output, which
# reaches nothing else) are held against the CPU twin's within SWEEP_TOL.
# Adapted params, card vs CPU and batch vs one request: within 1e-5 of
# max|params| over the tree, the CPU tests' bound against JAX
# (tests/test_torch_policy_serve.py).
ADAPT_TOL = 1e-5
# Adam trainer runs: ADAM_ITERATIONS timed iterations, then one more under
# the profiler
ADAM_ITERATIONS = 3
# The PPO replay meta-gradient, card vs CPU on the card's fits, per leaf
# within 1e-5 of max|grad|: the two f32 paths differ only in summation
# order (read: 5.1e-7 at full width). A sample whose ratio lies within
# CLIP_MARGIN of a clip bound (1 -/+ 0.3) in the second or third inner
# epoch may fall on either side in the two paths and move the gradient by
# ~1e-4 of max|grad|; only then is it held within REPLAY_FLIP_TOL. The
# loss within 1e-5 of the query's mean |ratio x advantage|, the size of
# its terms: they cancel to ~0 (ratio 1 against zero-mean normalized
# advantages), so the loss cannot see an error in the advantages; the
# gradient and the returns can.
REPLAY_GRAD_TOL, REPLAY_FLIP_TOL, CLIP_MARGIN = 1e-5, 1e-3, 1e-3
REPLAY_LOSS_TOL = 1e-5
# Fused meta-iterations (slice 8): --fuse FUSE, FUSED_ITERATIONS iterations
# through each trainer (two chunks, the first with the eager warm-up).
# Graph vs eager (the same seed at fuse 1), and one replay vs one eager
# iteration from the same state: the Adam paths within 1e-5 of
# max|params|; TRPO within ROADMAP Queue 3's 2e-2 of the step, since f32
# CG on a Fisher damped by 1e-5 amplifies last-bit differences. Both run
# the same kernels on the same numbers, so far less is expected.
# FUSED_EAGER eager iterations a timing turn.
FUSE, FUSED_ITERATIONS, FUSED_EAGER = 10, 20, 3
FUSED_ADAM_TOL, FUSED_TRPO_TOL = 1e-5, 2e-2
# The analysis tier (slice 9): eval_vision and eval_rl on run dirs that the
# phase trains first (2 iterations, a checkpoint each) at full width. The
# CL and RC params are the JAX defaults (vision: CL 10 tasks, RC 5 tasks
# at layer 4; RL: 10 eval tasks, CL 5 tasks, RC 5 tasks at layers 2, 4,
# -1); the one depth cut is ANALYSIS_EVAL_BATCHES meta-test batches
# (JAX's default: 20).
ANALYSIS_EVAL_BATCHES = 2
ANALYSIS_CL = {"adapt_steps": 1, "inner_lr": 0.1, "n_tasks": 10}
ANALYSIS_REP = {"adapt_steps": 1, "inner_lr": 0.1, "n_tasks": 5,
                "layers": [4]}
# One CL matrix from one pool, card vs CPU: adapted params within ADAPT_TOL
# of max|params| over the tree, logits within CL_LOGIT_TOL of max|logits|
# (float32 both, summation order only). An accuracy entry may differ only
# by queries whose top two CPU logits lie within 2 x CL_LOGIT_TOL of
# max|logits| (tie flips, counted and printed).
CL_LOGIT_TOL = 1e-4
# Linear and kernel CKA and the CCA mean of the RC activations, card
# (float32) vs CPU (float64, the same activations): CKA within PROBE_TOL.
# The CCA mean is held within PROBE_TOL where the float64 covariance of
# the stacked activations has full rank (the vision reps). The RL reps
# of 2-D Particles2D states span a few dimensions of 100 (rank 2 of 200
# at layer 2 on the CPU), so their CCA, JAX's too, is float32 rounding
# amplified by the pseudo-inverse: its error is printed with the rank,
# not held.
PROBE_TOL = 1e-4

# Non-meta baselines and bf16 meta-RL (slice 10). The RL baselines run
# BASELINE_ITERATIONS iterations at the RLScriptConfig defaults (20 tasks
# x 20 episodes x horizon 100, MLP (100, 100)); each task's rollout runs
# both sweeps once through its advantages (the random policy: discount
# once, for its fit); the meta-test adapts 10 fresh tasks at once, PPO
# with 2 + 2 sweeps (support and query advantages), TRPO with 3 + 3 (its
# fit, its inner loss, its query loss). The vision baseline runs at the
# script's defaults (Adam 1e-3; meta-batch 32, so int(320 / 32) = 10 Adam
# steps an iteration, 5-way 1-shot, N = 10 images a step, the CNN4
# kernels at B = 1: 4 / 4 / 3 calls a step, block 1 takes no dx), on
# synthetic Omniglot at its real shape; its meta-test is one
# make_meta_eval at B = 32 (META_EVAL_CALLS).
BASELINE_ITERATIONS = 2
BASELINE_META_TEST = {"ppo": {"gae_sweep": 2, "discount_sweep": 2},
                      "trpo": {"gae_sweep": 3, "discount_sweep": 3}}
BASELINE_STEP_CALLS = {"cnn4_block_fwd": 4, "cnn4_block_bwd_params": 4,
                       "cnn4_block_bwd_input": 3}
# Card vs CPU of one baseline update, on the card's baseline fit. Adam
# scales each element's step by its own gradient history, so summation
# order alone moves three PPO epochs at Adam 0.1 by up to 6.2e-5 of
# max|params| (the CPU against itself at 1 and 8 threads, full width, six
# trajectories): held within BASELINE_PPO_TOL with a non-capturable Adam
# on the card, as on the CPU. The path's own Adam is capturable on the
# card: its step count lives on the device and its bias correction is
# taken in float32, where the CPU's is taken in double, which Adam's
# normalization amplifies to up to 5.7e-3 of max|params| (the CPU with
# that arithmetic written out against torch's, the same six): held within
# ADAM_F32_TOL. The first epoch's gradient, before any Adam step, is held
# within REPLAY_GRAD_TOL of max|grad|. The single-task TRPO step's
# float32 CG (damping 1e-5)
# moves by ~0.10 of the step between the CPU's own two summation orders,
# and float32 against float64 alike: the accepted candidate is held
# exactly and the params within BASELINE_TRPO_TOL of the step. The vision
# scan (10 Adam steps at 1e-3): the first step's gradient within
# REPLAY_GRAD_TOL of max|grad|; after the scan every element but the conv
# biases within VISION_TOL of max|params| but a share VISION_FLIP_SHARE at
# most, and each of those within one Adam step a step: Adam's first step
# is the sign of each element's gradient, so an element whose gradient is
# rounding noise may step either way on two conv implementations (the
# CPU's fused and direct paths, four batches: 0 or 1 of 112,005 elements
# past 1e-4 of max|params|, at most 0.42 lr apart). The conv biases are
# all such elements: batch-stat BN removes them.
BASELINE_PPO_TOL, ADAM_F32_TOL = 5e-4, 1e-2
BASELINE_TRPO_TOL, VISION_TOL, VISION_FLIP_SHARE = 0.3, 1e-4, 1e-3
# bf16 density, card vs the CPU path: each layer rounds a float32 dot to
# bf16, and two summation orders may round a dot that lies within float32
# rounding of a bf16 rounding boundary (a tie) to neighbouring values; the
# states that differ by more than BF16_DENSITY_TOL of max|loc| must each
# have such a tie, be at most BF16_TIE_SHARE of the states, and differ by
# at most four bf16 steps of max|loc|.
BF16_STATES, BF16_DENSITY_TOL, BF16_TIE_SHARE = 2000, 1e-6, 0.01
BF16_STEPS = 4 * 2.0 ** -8
# the single-task CNN4 kernels (TPU-kernel rows 1-2) at the vision
# baseline's N = 2 x ways x shots = 10 images; GRAPH_CALLS calls captured
# back to back in one CUDA graph, replayed GRAPH_REPLAYS times
SINGLE_N, GRAPH_CALLS, GRAPH_REPLAYS = 10, 20, 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, warm: int = 3, iters: int = 20) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def conv_macs(b: int, n: int, h: int, ci: int, co: int) -> int:
    """Multiply-adds of the stride-2 3x3 conv over in-range taps only."""
    ho = (h - 1) // 2 + 1
    rows = sum(1 for i in range(ho) for d in range(3) if 0 <= 2 * i + d - 1 < h)
    return b * n * rows * rows * ci * co


def bound(kernel: str, b: int, n: int, h: int, ci: int, co: int,
          item: int) -> tuple[float, float]:
    """(ms if bytes bound, ms if operations bound) for one launch: every
    input read once, every output written once; conv at 2 FLOP per
    multiply-add plus the per-element BN work."""
    ho = (h - 1) // 2 + 1
    xin, w, out, pc = b * n * h * h * ci, b * 9 * ci * co, b * n * ho * ho * co, b * co
    macs = conv_macs(b, n, h, ci, co)
    if kernel == "cnn4_block_fwd":
        nbytes = item * (xin + w + 3 * pc + out)
        flops = 2 * macs + 10 * out
    elif kernel == "cnn4_block_bwd_params":
        # reads x, w, b, scale, bias, g; writes dy (f32), dw, db, dscale, dbias
        nbytes = item * (xin + w + 3 * pc + out) + 4 * out + item * (w + 3 * pc)
        flops = 4 * macs + 20 * out
    else:
        # reads dy (f32) and w; writes dx
        nbytes = 4 * out + item * (w + xin)
        flops = 2 * macs
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32


def block_inputs(torch, tc, gen, b, n, h, ci, dt):
    """Random block inputs at one shape: x, w, b, scale, bias and a
    cotangent g, zero where the ReLU input lies within 1e-3 of its kink:
    there the kernel's and the twin's f32 rounding may disagree on the
    mask, which is a tie, not an error."""
    dev, co = torch.device("cuda"), HIDDEN
    ho = (h - 1) // 2 + 1

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = rnd(b, n, h, h, ci).to(dt)
    w = rnd(b, 3, 3, ci, co, scale=(2.0 / (9 * ci)) ** 0.5).to(dt)
    bb = rnd(b, co, scale=0.1).to(dt)
    sc = (torch.rand(b, co, generator=gen, device=dev) * 0.9 + 0.1).to(dt)
    be = rnd(b, co, scale=0.1).to(dt)
    xh, _, s_, be_ = tc.bn_stats_plain(x, w, bb, sc, be)
    g = (rnd(b, n, ho, ho, co) * ((xh * s_ + be_).abs() > 1e-3)).to(dt)
    return x, w, bb, sc, be, g


def held(torch, got, want, dname: str, what: str, db=None) -> float:
    """|got - want| <= TOL (or DB_TOL * db, for the conv-bias gradient)
    everywhere -> the largest |got - want|."""
    rtol, atol = TOL[dname]
    got, want = got.float(), want.float()
    d = (got - want).abs()
    if db is not None:
        lim = DB_TOL[dname] * db
    else:
        lim = atol * want.abs().max() + rtol * want.abs()
    check(bool(torch.isfinite(got).all()), f"{what}: finite kernel output")
    check(bool((d <= lim).all()), f"{dname} {what}: max |err| {float(d.max())}")
    return float(d.max())


def kernel_phase(tc, F, torch) -> dict:
    """Phase 3: every kernel vs its twin at every block shape and dtype."""
    res = {name: {"max_abs_err": {}, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                  "bound_ms": 0.0, "shapes": []}
           for name in tc.KERNELS}
    res["cnn4_block_bwd_params"].update(library_ms=None, dw_library_ms=0.0)
    res["cnn4_block_fwd"].update(ms_n15=0.0, library_ms_n15=0.0,
                                 bound_ms_n15=0.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, N, co = BATCH, WAYS * SHOTS, HIDDEN

    def note(name, dname, e):
        prev = res[name]["max_abs_err"].get(dname, 0.0)
        res[name]["max_abs_err"][dname] = max(prev, e)

    def held_bwd_params(x, w, b, sc, be, g, dname, what):
        """bwd_params against its twin, and twice bitwise equal -> its
        outputs."""
        got = tc.block_bwd_params(x, w, b, sc, be, g)
        want = tc.block_bwd_params_plain(x, w, b, sc, be, g)
        dy_abs = want[0].abs().sum(dim=(1, 2, 3))
        note("cnn4_block_bwd_params", dname, max(
            held(torch, got[i], want[i], dname, f"{what} output {i}",
                 db=dy_abs + 1e-30 if i == 2 else None)
            for i in range(5)))
        again = tc.block_bwd_params(x, w, b, sc, be, g)
        check(all(torch.equal(p, q) for p, q in zip(got, again)),
              f"{dname} {what}: bwd_params bitwise equal in two calls")
        return got

    def grouped(x, w, b, sc, be, dy=None):
        """The yardsticks' operands: tasks as conv groups, NCHW."""
        bt, n, h, _, ci = x.shape
        out = {"xg": x.permute(1, 0, 4, 2, 3).reshape(n, bt * ci, h, h)
                      .contiguous(),
               "wg": w.permute(0, 4, 3, 1, 2).reshape(bt * co, ci, 3, 3)
                      .contiguous(),
               "bf": b.reshape(-1), "sf": sc.reshape(-1),
               "bef": be.reshape(-1)}
        if dy is not None:
            ho = dy.shape[2]
            out["dyg"] = dy.permute(1, 0, 4, 2, 3).reshape(
                n, bt * co, ho, ho).contiguous()
        return out

    def fwd_library(x, w, b, sc, be):
        o = grouped(x, w, b, sc, be)
        return lambda: torch.relu(F.batch_norm(
            F.conv2d(o["xg"], o["wg"], o["bf"], stride=2, padding=1,
                     groups=x.shape[0]),
            None, None, o["sf"], o["bef"], training=True, eps=tc.EPS))

    def timed(name, b, n, blk, kern, plain, lib, on_path):
        h, ci = BLOCKS[blk]
        shape = {"block": blk + 1, "x": [b, n, h, h, ci],
                 "on_path": on_path, "ms": time_ms(kern),
                 "plain_ms": time_ms(plain),
                 "library_ms": time_ms(lib) if lib else None}
        bms, oms = bound(name, b, n, h, ci, co, 4)
        shape.update(bytes_ms=bms, ops_ms=oms, bound_ms=max(bms, oms),
                     tflops=oms * PEAK_F32 / 1e12 / shape["ms"])
        res[name]["shapes"].append(shape)
        return shape

    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for blk, (h, ci) in enumerate(BLOCKS):
            x, w, b, sc, be, g = block_inputs(torch, tc, gen, B, N, h, ci, dt)
            what = f"block {blk + 1} N {N}"
            note("cnn4_block_fwd", dname, held(
                torch, tc.block_fwd(x, w, b, sc, be),
                tc.block_fwd_plain(x, w, b, sc, be), dname, what))
            dy = held_bwd_params(x, w, b, sc, be, g, dname, what)[0]
            note("cnn4_block_bwd_input", dname, held(
                torch, tc.block_bwd_input(dy, w, h, h),
                tc.block_bwd_input_plain(dy, w, h, h), dname, what))
            torch.cuda.synchronize()

            # Timing at float32, the served dtype: kernel, twin, yardstick.
            if dt != torch.float32:
                continue
            o = grouped(x, w, b, sc, be, dy)
            runs = {
                "cnn4_block_fwd": (
                    lambda: tc.block_fwd(x, w, b, sc, be),
                    lambda: tc.block_fwd_plain(x, w, b, sc, be),
                    fwd_library(x, w, b, sc, be)),
                "cnn4_block_bwd_params": (
                    lambda: tc.block_bwd_params(x, w, b, sc, be, g),
                    lambda: tc.block_bwd_params_plain(x, w, b, sc, be, g),
                    None),
                "cnn4_block_bwd_input": (
                    lambda: tc.block_bwd_input(dy, w, h, h),
                    lambda: tc.block_bwd_input_plain(dy, w, h, h),
                    lambda: torch.nn.grad.conv2d_input(
                        o["xg"].shape, o["wg"], o["dyg"], stride=2,
                        padding=1, groups=B)),
            }
            for name, (kern, plain, lib) in runs.items():
                on_path = not (name == "cnn4_block_bwd_input" and blk == 0)
                shape = timed(name, B, N, blk, kern, plain, lib, on_path)
                if name == "cnn4_block_bwd_params":
                    # the yardstick of its dw part alone
                    shape["dw_library_ms"] = time_ms(
                        lambda: torch.nn.grad.conv2d_weight(
                            o["xg"], o["wg"].shape, o["dyg"], stride=2,
                            padding=1, groups=B))
                    res[name]["dw_library_ms"] += shape["dw_library_ms"]
                if on_path:
                    r = res[name]
                    r["ms"] += shape["ms"]
                    r["plain_ms"] += shape["plain_ms"]
                    if lib:
                        r["library_ms"] += shape["library_ms"]
                    r["bytes_ms"] += shape["bytes_ms"]
                    r["ops_ms"] += shape["ops_ms"]
                    r["bound_ms"] += shape["bound_ms"]

        # every kernel at the other shapes its tiling must handle
        for b_, n_, blk in EXTRA_SHAPES:
            h, ci = BLOCKS[blk]
            x, w, b, sc, be, g = block_inputs(torch, tc, gen, b_, n_, h, ci,
                                              dt)
            ho = (h - 1) // 2 + 1
            dy = torch.randn(b_, n_, ho, ho, co, generator=gen,
                             device="cuda")
            what = f"block {blk + 1} B {b_} N {n_}"
            note("cnn4_block_fwd", dname, held(
                torch, tc.block_fwd(x, w, b, sc, be),
                tc.block_fwd_plain(x, w, b, sc, be), dname, what))
            held_bwd_params(x, w, b, sc, be, g, dname, what)
            note("cnn4_block_bwd_input", dname, held(
                torch, tc.block_bwd_input(dy, w, h, h),
                tc.block_bwd_input_plain(dy, w, h, h), dname, what))
            torch.cuda.synchronize()
            if dt == torch.float32 and (b_, n_) == (BATCH, QUERIES):
                shape = timed("cnn4_block_fwd", b_, n_, blk,
                              lambda: tc.block_fwd(x, w, b, sc, be),
                              lambda: tc.block_fwd_plain(x, w, b, sc, be),
                              fwd_library(x, w, b, sc, be), True)
                r = res["cnn4_block_fwd"]
                r["ms_n15"] += shape["ms"]
                r["library_ms_n15"] += shape["library_ms"]
                r["bound_ms_n15"] += shape["bound_ms"]
    for name, r in res.items():
        for sh in r["shapes"]:
            print(f"  {name} block {sh['block']} x {sh['x']}: ms {sh['ms']} "
                  f"({sh['tflops']} TFLOP/s) bound_ms {sh['bound_ms']} "
                  f"library_ms {sh['library_ms']} plain_ms {sh['plain_ms']}"
                  + (f" dw_library_ms {sh['dw_library_ms']}"
                     if "dw_library_ms" in sh else ""), flush=True)
    return res


def make_requests(torch, td, ts, device):
    """64 requests from the synthetic Omniglot test split: support 5-way
    5-shot (25), queries 3 per class (15)."""
    _, _, test = td.load_omniglot(seed=SEED, synthetic=True, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    data, labels = ts.sample_task_batch(gen, test, WAYS, SHOTS, BATCH)
    (sx, sy), (qx, qy) = ts.split_support_query(data, labels, SHOTS, WAYS)
    sel = (torch.arange(WAYS, device=device)[:, None] * SHOTS
           + torch.arange(QUERIES // WAYS, device=device)).reshape(-1)
    return sx, sy, qx[:, sel], qy[:, sel]


def agree(a, b, atol: float, what: str) -> None:
    """Probabilities within ``atol``; labels equal where the top-2 margin
    of the reference exceeds 1e-3."""
    (pa, qa), (pb, qb) = a, b
    check(float((qa.float().cpu() - qb.float().cpu()).abs().max()) <= atol,
          f"{what}: probabilities differ by more than {atol}")
    top2 = qb.float().cpu().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    check(bool((pa.cpu()[clear] == pb.cpu()[clear]).all()),
          f"{what}: predictions differ")


def device_profile(torch, fn, launches: bool = False) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` -> (microseconds the card
    was busy with kernels, the top kernels as (name, us, count)[, the
    number of kernels launched]). Device kernels only: a CPU op that
    launched a kernel reports its time too, and a profiler range (RANGES)
    its span on the device, so summing every event would count them
    twice."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and e.key not in RANGES),
                    key=lambda e: -e.self_device_time_total)
    out = (sum(e.self_device_time_total for e in events),
           [(e.key[:60], e.self_device_time_total, e.count)
            for e in events[:12]])
    return out + (sum(e.count for e in events),) if launches else out


def kernel_device_ms(torch, fn, name: str, calls: int = 50) -> float:
    """Device time of one launch of the kernel whose name holds ``name``:
    the profiler's (CUPTI) kernel time over ``calls`` calls of ``fn``,
    averaged over the launches it recorded. For a kernel of a few
    microseconds, CUDA events around back-to-back calls time the host's
    dispatch instead, so this is the kernel's own time. CUPTI may drop a
    record now and then (one of 50 has been seen missing on an H100), so
    the check asks for nine in ten of the launches, not every one. A
    session has also been seen to record none, or 32 of 50, so a session
    that records fewer than nine in ten is taken again, at most five
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and name in e.key]
        count = sum(e.count for e in events)
        if count >= 0.9 * calls:
            break
        print(f"profiler saw {count} of {calls} launches of {name}; "
              f"timing again", flush=True)
    check(0.9 * calls <= count <= calls,
          f"profiler saw {count} of {calls} launches of {name}")
    return sum(e.self_device_time_total for e in events) / count / 1e3


def build_all(build) -> tuple[float, dict]:
    """Build every csrc source at once, one nvcc each -> (seconds,
    {source: ptxas lines})."""
    from concurrent.futures import ThreadPoolExecutor
    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    ptxas = {}
    for src in sources:
        with open(build.library_path(src) + ".log") as f:
            ptxas[src] = [ln.strip() for ln in f
                          if "Used" in ln or "spill" in ln
                          or "entry function" in ln]
    return seconds, ptxas


def serve_phase(torch, np, tc, gpu) -> dict:
    """Phase 3's serving half: the main path of slice 1."""
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.serve import VisionServer
    from exploring_meta_tpu_torch.tasks import datasets as td
    from exploring_meta_tpu_torch.tasks import sampler as ts
    from exploring_meta_tpu_torch.utils.experiment import flatten_params

    spec = omniglot_spec(ways=WAYS)
    params = init_cnn4(torch.Generator().manual_seed(SEED), spec, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        np.savez(path, **flatten_params(params))
        kw = dict(inner_lr=INNER_LR, adapt_steps=ADAPT_STEPS)
        server = VisionServer.from_checkpoint(path, spec, device="cuda", **kw)
        cpu_server = VisionServer.from_checkpoint(path, spec, device="cpu",
                                                  **kw)
    sx, sy, qx, qy = make_requests(torch, td, ts, torch.device("cuda"))
    check(tuple(sx.shape) == (BATCH, WAYS * SHOTS, 28, 28, 1)
          and tuple(qx.shape) == (BATCH, QUERIES, 28, 28, 1),
          "request shapes")

    # the main path: one served batch, launch counters zeroed just before
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    preds, probs = server.batch(sx, sy, qx)
    torch.cuda.synchronize()
    launches = tc.launch_counts()
    print(f"launches in one served batch: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} ran on the served path")
    check(tuple(probs.shape) == (BATCH, QUERIES, WAYS)
          and bool(torch.isfinite(probs).all()), "finite probs [B, Q, ways]")
    check(float((probs.sum(-1) - 1).abs().max()) < 1e-5, "probs sum to 1")

    for i in range(4):
        agree(server(sx[i], sy[i], qx[i]), (preds[i], probs[i]), 1e-4,
              f"__call__ vs batch, request {i}")
    ref = cpu_server.batch(sx[:2].cpu(), sy[:2].cpu(), qx[:2].cpu())
    agree((preds[:2], probs[:2]), ref, 1e-3, "card vs CPU plain path")

    spreds, _ = server.batch(sx, sy, sx)
    support_acc = float((spreds == sy).float().mean())
    query_acc = float((preds == qy).float().mean())
    print(f"support accuracy {support_acc} query accuracy {query_acc} "
          f"(chance {1 / WAYS})", flush=True)
    check(support_acc > 2.0 / WAYS, "support set labelled above chance")

    serve_s = {}
    for dname, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        srv = server if dt is None else VisionServer(
            spec, server.params, compute_dtype=dt, device="cuda", **kw)
        p, q = srv.batch(sx, sy, qx)
        check(bool(torch.isfinite(q).all()), f"{dname} serving is finite")
        torch.cuda.synchronize()
        reps, t0 = 5, time.perf_counter()
        for _ in range(reps):
            p, q = srv.batch(sx, sy, qx)
        torch.cuda.synchronize()
        serve_s[dname] = (time.perf_counter() - t0) / reps
        print(f"serve {dname}: {BATCH / serve_s[dname]} requests/s, "
              f"{1e3 * serve_s[dname]} ms per batch of {BATCH} [{gpu}]",
              flush=True)

    device_us, top = device_profile(torch, lambda: server.batch(sx, sy, qx))
    print(f"profile of one served batch: kernels busy {device_us} us of "
          f"{1e6 * serve_s['float32']} us wall [{gpu}]")
    for key, us, count in top:
        print(f"  {us:12.1f} us  x{count:4d}  {key}")

    return {"launches": launches, "serve_s": serve_s,
            "support_acc": support_acc, "query_acc": query_acc,
            "profile_top": top, "profile_device_us": device_us}


def sweep_inputs(torch, gen, shape, dones: str):
    r = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if dones == "mid":
        d = (torch.rand(shape, generator=gen, device="cuda") < 0.1).float()
    else:
        d = torch.full(shape, float(dones == "ones"), device="cuda")
    return r, d, v


def sweep_phase(torch, gc, gpu) -> dict:
    """Phase 4: each sweep kernel vs its twin and a float64 CPU reference,
    forward and backward, at every shape and kind of dones, and twice with
    bitwise equal results at the main shape; timed at each timed shape with
    dones mid-column."""
    plain = {"gae_sweep": gc.gae_plain, "discount_sweep": gc.discount_plain}
    res = {name: {"max_abs_err": 0.0, "max_abs_err_f64": 0.0,
                  "max_grad_err": 0.0, "shapes": []} for name in gc.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for shape in SWEEP_SHAPES + SWEEP_CHECK_SHAPES:
        for dones in ("mid", "zeros", "ones"):
            r, d, v = sweep_inputs(torch, gen, shape, dones)
            g = torch.randn(shape, generator=gen, device="cuda")
            for name, kern in gc.KERNELS.items():
                args = ((GAMMA, TAU, r, d, v) if name == "gae_sweep"
                        else (GAMMA, r, d))
                got, want = kern(*args), plain[name](*args)
                ref = plain[name](*(a.cpu().double() if torch.is_tensor(a)
                                    else a for a in args))
                lim = SWEEP_TOL * float(ref.abs().max())
                e_twin = float((got - want).abs().max())
                e_ref = float((got.cpu().double() - ref).abs().max())
                check(bool(torch.isfinite(got).all()), f"{name} finite")
                check(e_twin <= lim and e_ref <= lim,
                      f"{name} {shape} dones {dones}: |err| twin {e_twin}, "
                      f"f64 {e_ref}, limit {lim}")
                if shape == SWEEP_SHAPES[0]:
                    check(torch.equal(got, kern(*args)),
                          f"{name} {shape} dones {dones}: bitwise equal in "
                          f"two calls")

                def grads(fn):
                    ins = [a.detach().clone().requires_grad_()
                           if torch.is_tensor(a) else a for a in args]
                    return torch.autograd.grad(
                        fn(*ins), [a for a in ins if torch.is_tensor(a)], g)

                before = dict(gc.launch_counts())
                gk, gp = grads(kern), grads(plain[name])
                check(gc.launch_counts()[name] == before[name] + 1,
                      f"{name}: the backward check went through the kernel")
                e_grad = max(float((a - b).abs().max())
                             for a, b in zip(gk, gp))
                glim = SWEEP_TOL * max(float(b.abs().max()) for b in gp)
                check(e_grad <= glim, f"{name} {shape} dones {dones}: "
                                      f"grad |err| {e_grad} > {glim}")
                r_ = res[name]
                r_["max_abs_err"] = max(r_["max_abs_err"], e_twin)
                r_["max_abs_err_f64"] = max(r_["max_abs_err_f64"], e_ref)
                r_["max_grad_err"] = max(r_["max_grad_err"], e_grad)
                if dones != "mid" or shape not in SWEEP_SHAPES:
                    continue
                n = r.numel()
                arrays, flops = (4, 7) if name == "gae_sweep" else (3, 3)
                bytes_ms = 1e3 * 4 * arrays * n / PEAK_BYTES
                ops_ms = 1e3 * flops * n / PEAK_F32
                # ms: the kernel's device time; call_ms and plain_ms: one
                # call of the wrapper and of the twin as the stream sees
                # it (CUDA events), host dispatch included
                r_["shapes"].append({
                    "shape": list(shape),
                    "ms": kernel_device_ms(torch, lambda: kern(*args),
                                           KERNEL_NAMES[name]),
                    "call_ms": time_ms(lambda: kern(*args), warm=10,
                                       iters=200),
                    "plain_ms": time_ms(lambda: plain[name](*args)),
                    "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                    "bound_ms": max(bytes_ms, ops_ms)})
    for name, r_ in res.items():
        # the kernel's numbers are those of the main path's shape
        main = r_["shapes"][0]
        r_.update({k: main[k] for k in ("ms", "call_ms", "plain_ms",
                                        "bytes_ms", "ops_ms", "bound_ms")},
                  library_ms=None)
        print(f"kernel {name}: max_abs_err {r_['max_abs_err']} (f64 "
              f"{r_['max_abs_err_f64']}, grad {r_['max_grad_err']}) [{gpu}]",
              flush=True)
        for s in r_["shapes"]:
            print(f"  {name} {s['shape']}: {1e3 * s['ms']} us a launch "
                  f"(device), bound {1e3 * s['bound_ms']} us, call_ms "
                  f"{s['call_ms']} plain_ms {s['plain_ms']} [{gpu}]",
                  flush=True)
    return res


def trpo_configs():
    """The full-width MAML-TRPO configuration: the trainer's defaults."""
    from exploring_meta_tpu_torch.trainers.rl import rl_config, trpo_config
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    cfg = RLScriptConfig(num_iterations=TRPO_ITERATIONS)
    return cfg, rl_config(cfg), trpo_config(cfg)


def trpo_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 5: the main path of slice 2, ``RLTrainer.run()``."""
    import math
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.experiment import load_params

    cfg, _, _ = trpo_configs()
    per_iter = []

    class CountingTrainer(RLTrainer):
        """Records each iteration's wall time and sweep launches."""

        def _make_trpo_iteration(self, *args):
            step = super()._make_trpo_iteration(*args)

            def counted(params, state, gen):
                torch.cuda.synchronize()
                before, t0 = gc.launch_counts(), time.perf_counter()
                out = step(params, state, gen)
                torch.cuda.synchronize()
                after = gc.launch_counts()
                per_iter.append({"s": time.perf_counter() - t0,
                                 **{k: after[k] - before[k] for k in after}})
                return out
            return counted

    trainer = CountingTrainer(cfg, algo="trpo", path=tmp + "/")
    torch.cuda.synchronize()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    final = trainer.run()
    torch.cuda.synchronize()
    launches = gc.launch_counts()
    print(f"launches in {TRPO_ITERATIONS} meta-iterations: {launches}; per "
          f"iteration: {per_iter}", flush=True)
    check(len(per_iter) == TRPO_ITERATIONS, "every iteration ran")
    for i, it in enumerate(per_iter):
        for name in gc.KERNELS:
            check(it[name] > 0, f"{name} ran in iteration {i}")

    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    for key in ("adapt_reward", "meta_loss", "ls_accepted"):
        vals = metrics.get(key, [])
        check(len(vals) == TRPO_ITERATIONS
              and all(v is not None and math.isfinite(v) for v in vals),
              f"metrics.json {key}: {vals}")
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    check(math.isfinite(final["mean_reward"])
          and logger["final_eval"]["mean_reward"] == final["mean_reward"],
          "final_eval.mean_reward is finite and logged")
    template = DiagNormalPolicy(2, 2).init(torch.Generator().manual_seed(0),
                                           device="cpu")
    params = load_params(os.path.join(run, "model.npz"), template)
    ckpt = load_params(os.path.join(run, "model_checkpoints", "model_0.npz"),
                       template)
    for tree in (params, ckpt):
        check(all(bool(torch.isfinite(t).all()) for t in
                  (tree["sigma"], *(v for layer in tree["mean"]
                                    for v in layer.values()))),
              "saved params are finite")
    s_iter = sum(it["s"] for it in per_iter[1:]) / (len(per_iter) - 1)
    print(f"MAML-TRPO Particles2D, full width: {s_iter} s per meta-iteration "
          f"(mean of iterations 2-{TRPO_ITERATIONS}), metrics {metrics}, "
          f"final_eval mean_reward {final['mean_reward']} [{gpu}]",
          flush=True)
    return {"launches": launches, "per_iteration": per_iter,
            "s_per_iteration": s_iter, "metrics": metrics,
            "final_eval": final, "params": params}


def outer_step_phase(torch, params, gpu) -> dict:
    """Phase 5, second part: one outer step on identical replays on the
    card and on the CPU path."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import make_trpo_collect
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.rl.trpo_meta import (
        meta_optimize_trpo, meta_surrogate_loss,
    )
    from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg, rl_cfg, trpo_cfg = trpo_configs()
    env, policy = Particles2D(), DiagNormalPolicy(2, 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    params = tree_map(lambda t: t.cuda(), params)
    tasks = env.sample_tasks(gen, cfg.meta_batch_size)
    old, _, replays, _ = make_trpo_collect(policy, roll, rl_cfg)(
        params, tasks, gen)
    out, cpu_new = {}, None
    for dev in ("cpu", "cuda"):
        p, o = (tree_map(lambda t: t.to(dev), x) for x in (params, old))
        rep = replays.map(lambda t: t.to(dev))
        t0 = time.perf_counter()
        new, info = meta_optimize_trpo(policy, p, o, rep, rl_cfg, trpo_cfg,
                                       cfg.adapt_steps)
        seconds = time.perf_counter() - t0
        if dev == "cpu":
            cpu_new = new
        # the surrogate and KL at one point, the CPU step's params
        with torch.no_grad():
            loss, kl = meta_surrogate_loss(
                policy, tree_map(lambda t: t.to(dev), cpu_new), o, rep,
                rl_cfg, cfg.adapt_steps)
        out[dev] = {"new": torch.cat([t.reshape(-1).cpu()
                                      for t in tree_leaves(new)]),
                    "old_loss": float(info["old_loss"]),
                    "loss": float(loss), "kl": float(kl),
                    "accepted": info["accepted"], "s": seconds}
    a, b = out["cuda"], out["cpu"]
    step = float((b["new"] - torch.cat([t.reshape(-1).cpu()
                                        for t in tree_leaves(params)])).norm())
    e_params = float((a["new"] - b["new"]).norm())
    # at the old params the surrogate is 0 up to rounding (ratio 1 against
    # zero-mean normalized advantages), so it is held by size; loss and KL
    # at the stepped params are held relatively
    for key in ("old_loss",):
        check(max(abs(a[key]), abs(b[key])) <= 1e-6,
              f"outer step {key} is 0 up to rounding: {a[key]}, {b[key]}")
    for key in ("loss", "kl"):
        check(abs(a[key] - b[key]) <= 1e-4 * abs(b[key]),
              f"outer step {key}: card {a[key]} vs CPU {b[key]}")
    check(a["accepted"] == b["accepted"], "line search accepts alike")
    # float32 CG on a Fisher damped by 1e-5 amplifies last-bit differences
    # of the two paths: the JAX package's own jitted and eager runs of one
    # step differ by 8e-3 of the step (tests/test_torch_rl_trpo.py)
    check(e_params <= 2e-2 * step,
          f"outer step params: |card - CPU| {e_params} vs step {step}")
    summary = {k: {kk: vv for kk, vv in v.items() if kk != "new"}
               for k, v in out.items()}
    summary.update(step_norm=step, param_err_l2=e_params)
    print(f"outer step, card vs CPU: {summary} [{gpu}]", flush=True)
    return summary


def trpo_profile(torch, gpu) -> dict:
    """Phase 5, last part: where one full-width meta-iteration's time goes.
    Its two phases, collection and the outer step, are timed on the host
    clock (synchronized, no profiler), then run once more under the
    profiler for their kernel-busy time and kernel launches."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import make_trpo_collect
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.rl.trpo_meta import make_trpo_meta_step

    cfg, rl_cfg, trpo_cfg = trpo_configs()
    env, policy = Particles2D(), DiagNormalPolicy(2, 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params = policy.init(gen)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    collect = make_trpo_collect(policy, roll, rl_cfg)
    meta_step = make_trpo_meta_step(policy, rl_cfg, trpo_cfg,
                                    cfg.adapt_steps)
    tasks = env.sample_tasks(gen, cfg.meta_batch_size)
    old, _, replays, _ = collect(params, tasks, gen)
    phases = {"collect": lambda: collect(params, tasks, gen),
              "meta_step": lambda: meta_step(params, old, replays)}
    out = {}
    for name, fn in phases.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy_us, top, launches = device_profile(torch, fn, launches=True)
        wall_us = 1e6 * sum(walls) / len(walls)
        out[name] = {"wall_us": wall_us, "busy_us": busy_us,
                     "kernel_launches": launches, "top": top}
        print(f"{name}: {wall_us} us wall, kernels busy {busy_us} us "
              f"({100 * busy_us / wall_us:.1f} %), {launches} kernel "
              f"launches [{gpu}]")
        for key, us, count in top:
            print(f"  {us:12.1f} us  x{count:5d}  {key}")
    # the line search's device time (its range's span on the device
    # timeline) at the fused configuration's TRPO settings: stopping at
    # the first accepted candidate, and host-free (every candidate)
    from exploring_meta_tpu_torch.trainers.rl import trpo_config
    fused_trpo = trpo_config(fused_configs()["maml_trpo"][2])
    for name, host_free in (("line_search_early_exit", False),
                            ("line_search_host_free", True)):
        step = make_trpo_meta_step(policy, rl_cfg, fused_trpo,
                                   cfg.adapt_steps, host_free=host_free)
        step(params, old, replays)
        torch.cuda.synchronize()
        prof = range_profile(torch, lambda: step(params, old, replays))
        out[name] = {"device_us": prof["ranges_us"]["trpo_line_search"],
                     "meta_step_busy_us": prof["busy_union_us"],
                     "meta_step_kernel_launches": prof["kernel_launches"],
                     "profiled_wall_us": prof["profiled_wall_us"]}
        print(f"{name} (outer_lr {fused_trpo.outer_lr}, "
              f"{fused_trpo.ls_max_steps} steps): line search "
              f"{out[name]['device_us']} us on the device of a meta-step "
              f"busy {prof['busy_union_us']} us, {prof['kernel_launches']} "
              f"kernel launches [{gpu}]", flush=True)
    return out


def vision_config(**kw):
    """bench.py's maml_omni configuration as the port's VisionConfig."""
    from exploring_meta_tpu_torch.utils.config import VisionConfig
    return VisionConfig(**{**dict(
        ways=WAYS, shots=SHOTS, meta_batch_size=META_BATCH, inner_lr=0.5,
        outer_lr=3e-3, bf16=True, conv_impl="fused", synthetic=True,
        synth_classes=1623, synth_per_class=20, seed=SEED), **kw})


def held_meta_grads(torch, got: dict, want: dict, what: str,
                    loose: bool = False) -> float:
    """Each leaf within SO_TOL (``loose``: within SO_FLIP_TOL max|want|);
    conv biases by magnitude -> the largest |got - want| / max|want|."""
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if key.endswith("conv/b"):
            scale = float(want[key[:-len("conv/b")] + "bn/bias"].abs().max())
            check(float(g.abs().max()) <= SO_DB_TOL * scale
                  and float(w.abs().max()) <= SO_DB_TOL * scale,
                  f"{what} {key}: |grad| {float(g.abs().max())}, "
                  f"{float(w.abs().max())} vs BN-bias scale {scale}")
            continue
        top = float(w.abs().max())
        d = (g - w).abs()
        lim = (SO_FLIP_TOL * top if loose
               else SO_TOL[0] * w.abs() + SO_TOL[1] * top)
        check(bool(torch.isfinite(g).all()) and bool((d <= lim).all()),
              f"{what} {key}: max |err| {float(d.max())} of max {top}")
        worst = max(worst, float(d.max()) / top)
    return worst


def rel_l2(torch, grads: dict, ref: dict) -> float:
    """Distance of a meta-gradient from ``ref`` over every leaf but the
    conv biases, relative to |ref|."""
    keys = [k for k in ref if not k.endswith("conv/b")]
    d = torch.cat([(grads[k] - ref[k]).reshape(-1) for k in keys])
    return float(d.norm() / torch.cat([ref[k].reshape(-1) for k in keys])
                 .norm())


def reference_meta_grad(torch, base: dict, data, labels, masks: list,
                        lr: float) -> tuple:
    """The MAML meta-gradient of one inner SGD step, written out in float64
    with plain ops: per task (tasks as conv groups) conv 3x3 stride 2 pad 1
    + bias -> batch-stat BN -> ReLU, four times, the spatial mean and the
    linear head; cross-entropy; even examples adapt, odd ones score. Each
    ReLU keeps the entries where the next of ``masks`` (``[B, N, Ho, Wo,
    C]`` bools, in call order: support blocks 1-4, then query blocks 1-4)
    is set. -> (mean query loss, {leaf path: grad}) for ``base``'s shared
    params."""
    import torch.nn.functional as F
    from exploring_meta_tpu_torch.utils.tree import (
        tree_items, tree_leaves, tree_map, tree_unflatten,
    )
    dt, dev = torch.float64, data.device
    B = data.shape[0]
    params = tree_map(lambda t: t.to(dev, dt).requires_grad_(), base)
    shared = tree_leaves(params)
    it = iter(masks)

    def logits(p, x):
        a = x.to(dt).permute(1, 0, 4, 2, 3)            # [N, B, C, H, W]
        for blk in p["base"]:
            n, w = a.shape[0], blk["conv"]["w"]        # w [B, 3, 3, Ci, Co]
            y = F.conv2d(a.reshape(n, -1, *a.shape[3:]),
                         w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3),
                         stride=2, padding=1, groups=B)
            y = y.reshape(n, B, -1, *y.shape[2:])
            y = y + blk["conv"]["b"][None, :, :, None, None]
            mu = y.mean(dim=(0, 3, 4), keepdim=True)
            var = (y - mu).square().mean(dim=(0, 3, 4), keepdim=True)
            z = ((y - mu) / torch.sqrt(var + 1e-5)
                 * blk["bn"]["scale"][None, :, :, None, None]
                 + blk["bn"]["bias"][None, :, :, None, None])
            a = z * next(it).permute(1, 0, 4, 2, 3).to(dt)
        feats = a.mean(dim=(3, 4)).permute(1, 0, 2)    # [B, N, C]
        return feats @ p["head"]["w"] + p["head"]["b"][:, None, :]

    def loss(p, x, y):                                 # [B] task losses
        return F.cross_entropy(logits(p, x).transpose(1, 2), y,
                               reduction="none").mean(dim=1)

    p = tree_map(lambda t: t.unsqueeze(0).expand((B,) + tuple(t.shape)),
                 params)
    leaves = tree_leaves(p)
    g = torch.autograd.grad(loss(p, data[:, ::2], labels[:, ::2]).sum(),
                            leaves, create_graph=True)
    fast = tree_unflatten(p, [t - lr * d for t, d in zip(leaves, g)])
    q = loss(fast, data[:, 1::2], labels[:, 1::2]).mean()
    grads = torch.autograd.grad(q, shared)
    return float(q.detach()), {k: v.cpu() for k, v in tree_items(
        tree_unflatten(params, grads))}


def recorded_masks(tc, fn) -> tuple:
    """Run ``fn`` with the ReLU mask (output > 0) of every ``FusedBlock``
    call recorded, in call order -> (fn's result, masks)."""
    masks, apply = [], tc.FusedBlock.apply

    def recording(*args):
        out = apply(*args)
        masks.append(out.detach() > 0)
        return out

    tc.FusedBlock.apply = recording
    try:
        return fn(), masks
    finally:
        del tc.FusedBlock.apply     # the inherited Function.apply again


def vision_second_order(torch, tc, gpu) -> dict:
    """Phase 6, first part: one full-width meta-gradient (4 tasks, 5-way
    5-shot, one inner step) through the fused kernels under second order,
    in f32 against a float64 reference on the kernels' ReLU masks, the
    direct path on the card and the CPU path; bf16 against f32; the launch
    counters show the kernels ran."""
    from exploring_meta_tpu_torch.adapt.maml import cast_compute
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.models.layers import set_conv_impl
    from exploring_meta_tpu_torch.tasks import datasets as td
    from exploring_meta_tpu_torch.tasks import sampler as ts
    from exploring_meta_tpu_torch.utils.tree import (
        tree_items, tree_leaves, tree_map, tree_unflatten,
    )

    spec = omniglot_spec(WAYS)
    base = init_cnn4(torch.Generator().manual_seed(SEED), spec, device="cpu")
    train, _, _ = td.load_omniglot(seed=SEED, synthetic=True, device="cuda")
    data, labels = ts.sample_task_batch(
        torch.Generator(device="cuda").manual_seed(SEED + 5), train, WAYS,
        SHOTS, SO_TASKS)

    def meta_grad(impl, dev, dtype=None):
        set_conv_impl(impl)
        params = tree_map(lambda t: t.to(dev).requires_grad_(), base)
        fa = make_vision_fast_adapt(spec, SO_LR, 1, SHOTS, WAYS)
        if dtype is not None:
            fa = cast_compute(fa, dtype)
        torch.cuda.synchronize()
        tc.reset_launch_counts()
        (loss, grads), masks = recorded_masks(tc, lambda: (lambda l: (
            l, torch.autograd.grad(l, tree_leaves(params))))(
                fa(params, data.to(dev), labels.to(dev)).loss.mean()))
        torch.cuda.synchronize()
        counts = tc.launch_counts()
        grads = {k: g.double().cpu()
                 for k, g in tree_items(tree_unflatten(params, grads))}
        return float(loss.detach()), grads, counts, masks

    try:
        runs = {"fused": meta_grad("fused", "cuda"),
                "direct": meta_grad("direct", "cuda"),
                "cpu": meta_grad("fused", "cpu"),
                "fused_bf16": meta_grad("fused", "cuda", torch.bfloat16),
                "direct_bf16": meta_grad("direct", "cuda", torch.bfloat16)}
    finally:
        set_conv_impl("fused")
    counts = {k: r[2] for k, r in runs.items()}
    print(f"second-order meta-gradient launches: {counts}", flush=True)
    for name in ("fused", "fused_bf16"):
        check(counts[name] == META_STEP_CALLS,
              f"{name}: the kernels ran under create_graph=True "
              f"{counts[name]} == {META_STEP_CALLS}")
    for name in ("direct", "cpu", "direct_bf16"):
        check(not any(counts[name].values()), f"{name}: no kernel launch")
    loss, grads, _, masks = runs["fused"]
    check(len(masks) == 8, f"8 fused block calls, got {len(masks)}")
    ref_loss, ref = reference_meta_grad(torch, base, data, labels, masks,
                                        SO_LR)
    flips = sum(int((a.cpu() != b).sum())
                for a, b in zip(masks, runs["cpu"][3]))
    out = {"loss": {"reference_f64": ref_loss,
                    **{k: r[0] for k, r in runs.items()}},
           "launches": counts, "relu_flips_card_vs_cpu": flips,
           "max_rel_err": {
               "vs_reference_f64": held_meta_grads(
                   torch, grads, ref, "fused vs float64 reference"),
               "direct_vs_reference_f64": held_meta_grads(
                   torch, runs["direct"][1], ref, "direct vs float64",
                   loose=True),
               "vs_direct": held_meta_grads(
                   torch, grads, runs["direct"][1], "fused vs direct",
                   loose=True),
               "vs_cpu": held_meta_grads(
                   torch, grads, runs["cpu"][1], "card vs CPU", loose=True)},
           "bf16_rel_l2": {name: rel_l2(torch, runs[name][1], grads)
                           for name in ("fused_bf16", "direct_bf16")}}
    for name in ("direct", "cpu"):
        check(abs(runs[name][0] - loss) <= 1e-5 * abs(loss),
              f"{name} loss {runs[name][0]} vs fused {loss}")
    check(abs(ref_loss - loss) <= 1e-5 * abs(loss),
          f"float64 reference loss {ref_loss} vs fused {loss}")
    check(abs(runs["fused_bf16"][0] - loss) <= BF16_LOSS_TOL * abs(loss),
          f"fused bf16 loss {runs['fused_bf16'][0]} vs f32 {loss}")
    b = out["bf16_rel_l2"]
    check(b["fused_bf16"] <= BF16_GRAD_RATIO * b["direct_bf16"],
          f"bf16 meta-gradient from f32: fused {b['fused_bf16']}, cuDNN "
          f"{b['direct_bf16']}")
    print(f"second order, full width, {SO_TASKS} tasks: {out} [{gpu}]",
          flush=True)
    return out


def vision_trainer_phase(torch, tc, gpu, tmp) -> dict:
    """Phase 6, second part: the main path of slice 6,
    ``VisionTrainer.run()`` at maml_omni for VISION_ITERATIONS iterations,
    with the launch counters zeroed just before; per-iteration counts from
    the counters at each logged row."""
    import math
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils.experiment import load_params
    from exploring_meta_tpu_torch.utils.tree import tree_leaves

    marks = []

    class CountingTrainer(VisionTrainer):
        """Marks the counters and the clock at each logged row."""

        def log_metrics(self, metrics):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), tc.launch_counts()))
            super().log_metrics(metrics)

    trainer = CountingTrainer(vision_config(num_iterations=VISION_ITERATIONS),
                              path=tmp + "/")
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    marks.append((time.perf_counter(), tc.launch_counts()))
    test_acc = trainer.run()
    torch.cuda.synchronize()
    launches = tc.launch_counts()
    steps = [{"s": t1 - t0, **{k: c1[k] - c0[k] for k in c1}}
             for (t0, c0), (t1, c1) in zip(marks, marks[1:])]
    print(f"vision trainer launches: {launches}; per logged row: {steps}",
          flush=True)
    check(len(steps) == VISION_ITERATIONS + 1, "every iteration ran")
    per_iter = {k: META_STEP_CALLS[k] + META_EVAL_CALLS[k]
                for k in META_STEP_CALLS}
    for i, st in enumerate(steps[:-1]):
        check({k: st[k] for k in per_iter} == per_iter,
              f"iteration {i}: kernel calls {st} == {per_iter}")
    check({k: steps[-1][k] for k in per_iter} == META_EVAL_CALLS,
          f"final meta-test: kernel calls {steps[-1]}")

    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    for key in ("train_loss", "train_acc", "valid_loss", "valid_acc"):
        vals = metrics.get(key, [])
        check(len(vals) == VISION_ITERATIONS
              and all(v is not None and math.isfinite(v) for v in vals),
              f"metrics.json {key}: {vals}")
    check(math.isfinite(test_acc) and metrics["test_acc"] == [test_acc],
          "test_acc is finite and logged")
    template = init_cnn4(torch.Generator().manual_seed(0),
                         omniglot_spec(WAYS), device="cpu")
    for name in ("model.npz", os.path.join("model_checkpoints",
                                           "model_0.npz")):
        tree = load_params(os.path.join(run, name), template)
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)),
              f"{name} loads into the template and is finite")
    s_iter = sum(st["s"] for st in steps[1:-1]) / (len(steps) - 2)
    print(f"MAML-CNN4 Omniglot 5w5s, meta-batch {META_BATCH}, bf16: {s_iter} "
          f"s per iteration (valid eval + meta-step; iterations 2-"
          f"{VISION_ITERATIONS}), metrics {metrics} [{gpu}]", flush=True)
    return {"launches": launches, "per_row": steps, "s_per_iteration": s_iter,
            "metrics": metrics, "test_acc": test_acc}


def is_kernel(torch, e) -> bool:
    """A device event of the profiler that is work, not the span of a
    profiler range (RANGES, or one PyTorch records itself)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in RANGES)


def union_us(kernels) -> float:
    """µs of the device timeline that the kernels cover: cuDNN runs some
    f32 kernels concurrently, so their durations may overlap."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def range_profile(torch, fn) -> dict:
    """Run ``fn`` once under the profiler -> kernel-busy µs (summed, and
    the timeline they cover), kernel launches, the top kernels, the
    device µs of each of RANGES (the timeline covered by the kernels
    inside the range's span on the device: the launches are ordered, so
    the span holds its own kernels only; the kernels launched through
    ctypes are not tied to the CPU-side range), and, as a check of that
    attribution, the device µs of the kernels of ``csrc/cnn4_block.cu``
    by name; the device µs of the sweep kernels by name; and the host µs
    spent inside profiled ops (their self CPU time summed: aten ops and
    CUDA runtime calls; the rest of the wall is Python between them) with
    the top ops by it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [e for e in events if e.device_type == cuda and e.name in RANGES]
    kernels = [e for e in events if is_kernel(torch, e)]
    in_span = {name: [] for name in RANGES}
    for k in kernels:
        for a in spans:
            if a.time_range.start <= k.time_range.start < a.time_range.end:
                in_span[a.name].append(k)
                break
    host = sorted(((a.key[:60], a.self_cpu_time_total, a.count)
                   for a in prof.key_averages()
                   if a.self_cpu_time_total > 0), key=lambda t: -t[1])
    top = {}
    for k in kernels:
        us, n = top.get(k.name, (0.0, 0))
        top[k.name] = (us + k.time_range.elapsed_us(), n + 1)
    return {"busy_us": sum(k.time_range.elapsed_us() for k in kernels),
            "busy_union_us": union_us(kernels),
            "profiled_wall_us": 1e6 * wall, "kernel_launches": len(kernels),
            "ranges_us": {n: union_us(ks) for n, ks in in_span.items()},
            "cnn4_kernels_us": sum(us for name, (us, _) in top.items()
                                   if any(k in name
                                          for k in CNN4_KERNEL_NAMES)),
            "sweep_kernels_us": sum(us for name, (us, _) in top.items()
                                    if any(k in name
                                           for k in KERNEL_NAMES.values())),
            "top": sorted(((name[:60], us, n) for name, (us, n)
                           in top.items()), key=lambda t: -t[1])[:12],
            "host_op_us": sum(us for _, us, _ in host),
            "host_top": host[:8]}


def vision_timing(torch, gpu) -> dict:
    """Phase 6, last part: tasks/s of maml_omni's meta-step in f32 and
    bf16, on the fused kernels and on the direct path (cuDNN), timed in
    turns; then one meta-step of each fused configuration profiled."""
    from exploring_meta_tpu_torch.adapt.maml import (
        adam, cast_compute, make_meta_step, make_train_scan,
    )
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.models.layers import set_conv_impl
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    from exploring_meta_tpu_torch.utils.tree import tree_map

    cfg = vision_config()
    spec = omniglot_spec(WAYS)
    train, _, _ = get_dataset("omni", seed=SEED, synthetic=True,
                              synth_classes=cfg.synth_classes,
                              synth_per_class=cfg.synth_per_class,
                              device="cuda")

    def sample(gen):
        return sample_task_batch(gen, train, WAYS, SHOTS, META_BATCH)

    def fast_adapt(dname):
        fa = make_vision_fast_adapt(spec, cfg.inner_lr, cfg.adapt_steps,
                                    SHOTS, WAYS)
        return fa if dname == "float32" else cast_compute(fa)

    configs = [(impl, dname) for dname in ("float32", "bfloat16")
               for impl in ("fused", "direct")]
    state, out = {}, {}
    try:
        for impl, dname in configs:
            set_conv_impl(impl)
            params = tree_map(lambda t: t.requires_grad_(), init_cnn4(
                torch.Generator(device="cuda").manual_seed(SEED), spec,
                device="cuda"))
            opt = adam(params, cfg.outer_lr)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
            timed = make_train_scan(fast_adapt(dname), sample, TIMED_STEPS)
            # the eager warm-up, the capture and a replay
            params, opt, m = timed(params, opt, gen, WARM_STEPS)
            check(bool(torch.isfinite(m["loss"]).all()), f"{impl} {dname} "
                                                          "warm-up finite")
            state[impl, dname] = (params, opt, gen, timed)
            out[f"{impl}_{dname}"] = {"tasks_per_s": []}
        for _ in range(WINDOWS):
            for impl, dname in configs:
                set_conv_impl(impl)
                params, opt, gen, timed = state[impl, dname]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = timed(params, opt, gen)
                last = float(m["loss"][-1])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check(bool(torch.isfinite(m["loss"]).all()),
                      f"{impl} {dname}: finite losses, last {last}")
                state[impl, dname] = (params, opt, gen, timed)
                out[f"{impl}_{dname}"]["tasks_per_s"].append(
                    META_BATCH * TIMED_STEPS / dt)
        for key, r in out.items():
            r["best_tasks_per_s"] = max(r["tasks_per_s"])
            r["ms_per_step"] = 1e3 * META_BATCH / r["best_tasks_per_s"]
            print(f"maml_omni {key}: {r['best_tasks_per_s']} tasks/s (best "
                  f"of {r['tasks_per_s']}), {r['ms_per_step']} ms per "
                  f"meta-step [{gpu}]", flush=True)

        # one meta-step of each fused configuration: wall (mean of 3,
        # synced), then once under the profiler
        batch = sample(torch.Generator(device="cuda").manual_seed(SEED + 7))
        set_conv_impl("fused")
        for dname in ("float32", "bfloat16"):
            params, opt, _, _ = state["fused", dname]
            step = make_meta_step(fast_adapt(dname))
            step(params, opt, *batch)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(params, opt, *batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = range_profile(torch, lambda: step(params, opt, *batch))
            prof["wall_us"] = 1e6 * sum(walls) / len(walls)
            # idle: the device time the kernels cover (profiled) against
            # an unprofiled step's wall; the profiler slows the host
            prof["idle_share"] = 1 - prof["busy_union_us"] / prof["wall_us"]
            prof["rest_us"] = (prof["busy_union_us"]
                               - sum(prof["ranges_us"].values()))
            out[f"profile_fused_{dname}"] = prof
            print(f"meta-step profile, fused {dname}: {prof['wall_us']} us "
                  f"wall, profiled {prof['profiled_wall_us']} us wall with "
                  f"kernels busy {prof['busy_us']} us (union "
                  f"{prof['busy_union_us']} us, idle "
                  f"{100 * prof['idle_share']:.1f} %), "
                  f"{prof['kernel_launches']} kernel launches; device us by "
                  f"range {prof['ranges_us']}, rest {prof['rest_us']}; the "
                  f"CNN4 kernels by name {prof['cnn4_kernels_us']} us "
                  f"[{gpu}]", flush=True)
            for key, us, count in prof["top"]:
                print(f"  {us:12.1f} us  x{count:5d}  {key}")
    finally:
        set_conv_impl("fused")
    return out


def tree_err(torch, got, want, what: str) -> float:
    """The largest ``|got - want|`` over every leaf of the tree, relative
    to the max of ``|want|`` over the tree (a zero-initialized bias holds
    only its step); fails unless ``got`` is finite and of ``want``'s
    shapes."""
    from exploring_meta_tpu_torch.utils.tree import tree_items
    want = {k: w.detach().cpu().double() for k, w in tree_items(want)}
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for key, g in tree_items(got):
        g = g.detach().cpu().double()
        check(tuple(g.shape) == tuple(want[key].shape)
              and bool(torch.isfinite(g).all()), f"{what} {key}: finite, "
                                                 f"shape {tuple(g.shape)}")
        worst = max(worst, float((g - want[key]).abs().max()) / top)
    return worst


def tree_close(torch, got, want, tol: float, what: str) -> float:
    """:func:`tree_err` within ``tol`` -> that error."""
    worst = tree_err(torch, got, want, what)
    check(worst <= tol, f"{what}: max |err| {worst} of max|params|, limit "
                        f"{tol}")
    return worst


def with_baseline_fits(fn, fits=None) -> tuple:
    """Run ``fn`` with every linear-baseline fit of ``rl/adapt_rl.py``
    recorded in call order, each as (weights, the discounted returns
    fitted) -> (fn's result, the fits). Given ``fits`` (another run's,
    from any device), ``fn`` takes their weights instead, in order, so
    that two runs differ only in the arithmetic around the fit: a float32
    ridge solve of condition ~1e5 on Particles2D's features, whose result
    two devices agree on only to ~1e-3 (ADAPT_TOL). The returns, the
    discount sweep's output, are then held against the given run's within
    SWEEP_TOL of their max: taking the fit removes only the solve from the
    comparison, not the sweep."""
    from exploring_meta_tpu_torch.rl import adapt_rl
    fit, got = adapt_rl.fit_linear_value, []
    given = None if fits is None else iter(fits)

    def recording(states, timesteps, returns, *args, **kwargs):
        if given is None:
            w = fit(states, timesteps, returns, *args, **kwargs)
        else:
            w, want = (t.to(states.device) for t in next(given))
            err = float((returns - want).abs().max())
            lim = SWEEP_TOL * float(want.abs().max())
            check(err <= lim, f"discounted returns vs the given run's: "
                              f"|err| {err}, limit {lim}")
        got.append((w, returns))
        return w

    adapt_rl.fit_linear_value = recording
    try:
        res = fn()
    finally:
        adapt_rl.fit_linear_value = fit
    check(fits is None or len(got) == len(fits),
          f"the replayed run took {len(got)} of {len(fits or ())} fits")
    return res, got


def fits_err(a: list, b: list, part: int = 0) -> float:
    """The largest disagreement of two runs' fits (``part`` 0: the
    weights; 1: the returns fitted), each relative to the max of its
    ``b`` fit."""
    return max(float((x[part].cpu().double() - y[part].cpu().double())
                     .abs().max() / y[part].abs().max())
               for x, y in zip(a, b))


def profiled(torch, fn, wall_s: float) -> dict:
    """One call of ``fn`` under the profiler (range_profile) with the idle
    share against an unprofiled wall time."""
    prof = range_profile(torch, fn)
    prof["wall_us"] = 1e6 * wall_s
    prof["idle_share"] = 1 - prof["busy_union_us"] / prof["wall_us"]
    return prof


def print_host(prof: dict) -> None:
    """Print a profile's top kernels, then its host time inside ops and
    the top ops by self CPU time."""
    for key, us, count in prof["top"]:
        print(f"  {us:12.1f} us  x{count:5d}  {key}")
    print(f"  host: {prof['host_op_us']} us inside ops of "
          f"{prof['profiled_wall_us']} us profiled wall")
    for key, us, count in prof["host_top"]:
        print(f"  {us:12.1f} us  x{count:5d}  {key} (host)")


def policy_serve_phase(torch, gc, gpu) -> dict:
    """Phase 7: the main path of slice 7, ``PolicyServer.adapt_batched``,
    for each adaptation algorithm, and once for an ANIL policy."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import (
        DiagNormalPolicy, DiagNormalPolicyANIL,
    )
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.serve import PolicyServer
    from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

    env, n = Particles2D(), SERVE_RL_REQUESTS
    cfg = RLConfig(**SERVE_RL_CFG)
    policy = DiagNormalPolicy(env.obs_size, env.action_size)
    params = policy.init(torch.Generator().manual_seed(SEED), device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    roll = make_rollout(env, policy.sample, SERVE_RL_EPISODES,
                        SERVE_RL_HORIZON)
    stack = roll(tree_map(lambda t: t.cuda(), params),
                 env.sample_tasks(gen, n), gen)
    check(tuple(stack.reward.shape) == (n, SERVE_RL_HORIZON,
                                        SERVE_RL_EPISODES),
          f"support stack {tuple(stack.reward.shape)}")
    cpu_stack = stack.map(lambda t: t.cpu())
    obs = stack.state[:, 0]                       # [n, E, obs]
    out = {"launches": {k: 0 for k in gc.KERNELS}}

    def serve(name, pol, p, c, algo):
        """One served batch on the card with the counters zeroed just
        before; held against the CPU path on the card's baseline fits
        -> (server, adapted, record, the card's fits)."""
        server = PolicyServer(pol, p, c, algo=algo)
        torch.cuda.synchronize()
        gc.reset_launch_counts()
        adapted, fits = with_baseline_fits(
            lambda: server.adapt_batched(stack))
        torch.cuda.synchronize()
        launches = gc.launch_counts()
        print(f"{name}: launches in one served batch {launches}", flush=True)
        check(launches == {k: c.adapt_steps for k in gc.KERNELS},
              f"{name}: each sweep once per inner step, {launches}")
        for k, v in launches.items():
            out["launches"][k] += v
        cpu = PolicyServer(pol, p, c, algo=algo, device="cpu")
        want, replayed = with_baseline_fits(
            lambda: cpu.adapt_batched(cpu_stack), fits)
        own, cpu_fits = with_baseline_fits(
            lambda: cpu.adapt_batched(cpu_stack))
        return server, adapted, {
            "launches": launches,
            "vs_cpu": tree_close(torch, adapted, want, ADAPT_TOL,
                                 f"{name} card vs CPU"),
            "returns_err": fits_err(fits, replayed, 1),
            "vs_cpu_own_fits": tree_err(torch, adapted, own,
                                        f"{name} card vs CPU, own fits"),
            "fits_err": fits_err(fits, cpu_fits)}, fits

    for algo in ("vpg", "ppo", "trpo"):
        server, adapted, r, fits = serve(algo, policy, params, cfg, algo)
        r["vs_request"] = max(tree_close(
            torch, with_baseline_fits(
                lambda: server.adapt(stack.map(lambda t: t[i])),
                [(w[i:i + 1], r[i:i + 1]) for w, r in fits])[0],
            tree_map(lambda t: t[i], adapted), ADAPT_TOL,
            f"{algo} request {i} vs batch") for i in range(4))
        check(all(bool((x[0] != y).any()) for x, y in zip(
            tree_leaves(adapted), tree_leaves(server.params))),
              f"{algo}: the inner step moved every leaf")
        acts = server.act_batched(adapted, obs)
        per = torch.stack([server.act(tree_map(lambda t: t[i], adapted),
                                      obs[i]) for i in range(4)])
        r["act_err"] = float((acts[:4] - per).abs().max())
        check(tuple(acts.shape) == (n, SERVE_RL_EPISODES, env.action_size)
              and r["act_err"] <= 1e-5 * float(per.abs().max()),
              f"{algo}: act_batched vs act, |err| {r['act_err']}")
        check(tuple(server.sample_batched(adapted, gen, obs).shape)
              == tuple(acts.shape), f"{algo}: sample_batched shape")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            server.adapt_batched(stack)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5
        prof = profiled(torch, lambda: server.adapt_batched(stack), wall)
        r.update(batch_wall_s=wall, requests_per_s=n / wall, profile=prof)
        out[algo] = r
        print(f"serve_rl {algo}: {n / wall} adaptation requests/s, "
              f"{1e3 * wall} ms per batch of {n}; card vs CPU "
              f"{r['vs_cpu']}, returns {r['returns_err']} "
              f"({r['vs_cpu_own_fits']} on each device's own "
              f"baseline fits, which differ by {r['fits_err']}), batch vs "
              f"request {r['vs_request']} of max|params|; profiled: kernels busy {prof['busy_union_us']} "
              f"us of {prof['wall_us']} us (idle "
              f"{100 * prof['idle_share']:.1f} %), {prof['kernel_launches']}"
              f" kernel launches, sweeps {prof['sweep_kernels_us']} us "
              f"[{gpu}]", flush=True)
        print_host(prof)

    anil = DiagNormalPolicyANIL(env.obs_size, env.action_size)
    aparams = anil.init(torch.Generator().manual_seed(SEED + 1), device="cpu")
    server, adapted, r, _ = serve("anil vpg", anil, aparams,
                               cfg._replace(anil=True), "vpg")
    for layer, base in zip(adapted["body"], server.params["body"]):
        for key in base:
            check(torch.equal(layer[key], base[key].expand_as(layer[key])),
                  f"anil: body {key} unchanged")
    check(bool((adapted["head"]["w"][0] != server.params["head"]["w"]).any()),
          "anil: the head moved")
    out["anil_vpg"] = r
    print(f"serve_rl anil vpg: body unchanged, card vs CPU {r['vs_cpu']} "
          f"({r['vs_cpu_own_fits']} on own fits) "
          f"[{gpu}]", flush=True)
    return out


def adam_rl_phase(torch, gc, gpu, tmp) -> dict:
    """Phase 8: the Adam main paths of slice 7, ``RLTrainer.run()`` for
    maml_ppo and anil_vpg at the trainer's defaults: ADAM_ITERATIONS
    timed iterations each, then one more under the profiler."""
    import math
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer, build_policy
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.experiment import load_params
    from exploring_meta_tpu_torch.utils.tree import tree_leaves

    out = {"launches": {k: 0 for k in gc.KERNELS}}
    for algo, anil in (("ppo", False), ("vpg", True)):
        name = f"{'anil' if anil else 'maml'}_{algo}"
        per_iter, prof = [], {}

        class CountingTrainer(RLTrainer):
            """Records each iteration's wall time and sweep launches, and
            profiles the last iteration against the mean wall of the timed
            ones after the first."""

            def _make_adam_iteration(self, *args):
                step = super()._make_adam_iteration(*args)

                def counted(params, opt, gen):
                    res = []
                    torch.cuda.synchronize()
                    before, t0 = gc.launch_counts(), time.perf_counter()
                    if len(per_iter) < ADAM_ITERATIONS:
                        res.append(step(params, opt, gen))
                        torch.cuda.synchronize()
                    else:
                        wall = sum(it["s"] for it in per_iter[1:]) / (
                            len(per_iter) - 1)
                        prof.update(profiled(torch, lambda: res.append(
                            step(params, opt, gen)), wall))
                    after = gc.launch_counts()
                    per_iter.append({"s": time.perf_counter() - t0, **{
                        k: after[k] - before[k] for k in after}})
                    return res[0]
                return counted

        cfg = RLScriptConfig(num_iterations=ADAM_ITERATIONS + 1)
        trainer = CountingTrainer(cfg, algo=algo, anil=anil, path=tmp + "/")
        torch.cuda.synchronize()
        gc.reset_launch_counts()
        final = trainer.run()
        torch.cuda.synchronize()
        launches = gc.launch_counts()
        print(f"{name}: launches in {cfg.num_iterations} meta-iterations "
              f"and the meta-test {launches}; per iteration {per_iter}",
              flush=True)
        for k, v in launches.items():
            out["launches"][k] += v
        check(len(per_iter) == cfg.num_iterations and prof,
              f"{name}: every iteration, the last profiled")
        for i, it in enumerate(per_iter):
            for k in gc.KERNELS:
                check(it[k] == cfg.adapt_steps + 1, f"{name} iteration {i}: "
                      f"{k} once per support batch and once for the query, "
                      f"{it[k]}")
        run = trainer.model_path
        with open(os.path.join(run, "metrics.json")) as f:
            metrics = json.load(f)
        for key in ("meta_loss", "adapt_reward", "adapt_success"):
            vals = metrics.get(key, [])
            check(len(vals) == cfg.num_iterations
                  and all(v is not None and math.isfinite(v) for v in vals),
                  f"{name} metrics.json {key}: {vals}")
        check(math.isfinite(final["mean_reward"])
              and metrics["eval_reward"] == [final["mean_reward"]],
              f"{name}: the meta-test is finite and logged")
        template = build_policy(Particles2D(), anil, cfg.fc_neurons,
                                cfg.activation).init(
            torch.Generator().manual_seed(0), device="cpu")
        for file in ("model.npz", os.path.join("model_checkpoints",
                                               "model_0.npz")):
            tree = load_params(os.path.join(run, file), template)
            check(all(bool(torch.isfinite(t).all())
                      for t in tree_leaves(tree)),
                  f"{name}: {file} loads into the template and is finite")
        s_iter = sum(it["s"] for it in per_iter[1:ADAM_ITERATIONS]) / (
            ADAM_ITERATIONS - 1)
        prof["rest_us"] = prof["busy_union_us"] - prof["sweep_kernels_us"]
        out[name] = {"launches": launches, "per_iteration": per_iter,
                     "s_per_iteration": s_iter, "metrics": metrics,
                     "final_eval": final, "profile": prof}
        print(f"{name} Particles2D, full width: {s_iter} s per "
              f"meta-iteration (mean of iterations 2-{ADAM_ITERATIONS}), "
              f"metrics {metrics} [{gpu}]", flush=True)
        print(f"{name} iteration profile: {prof['wall_us']} us wall; "
              f"profiled {prof['profiled_wall_us']} us with kernels busy "
              f"{prof['busy_union_us']} us (idle "
              f"{100 * prof['idle_share']:.1f} %), "
              f"{prof['kernel_launches']} kernel launches; sweeps "
              f"{prof['sweep_kernels_us']} us, the rest {prof['rest_us']} us "
              f"[{gpu}]", flush=True)
        print_host(prof)
    return out


def replay_meta_grad(torch, meta_loss, params, replays, dev: str,
                     fits=None) -> tuple:
    """``meta_loss(params, replays)`` and its gradient on ``dev``, on the
    given baseline fits if any (:func:`with_baseline_fits`) -> (loss,
    {leaf: gradient in float64 on the CPU}, the fits)."""
    from exploring_meta_tpu_torch.utils.tree import tree_items, tree_map
    p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
    loss, fits = with_baseline_fits(
        lambda: meta_loss(p, replays.map(lambda t: t.to(dev))), fits)
    keys, leaves = zip(*tree_items(p))
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            {k: g.double().cpu() for k, g in zip(keys, grads)}, fits)


def grads_err(torch, got: dict, want: dict, what: str) -> float:
    """The largest ``|got - want|`` of any leaf relative to that leaf's
    max ``|want|``; fails unless ``got`` is finite."""
    worst = 0.0
    for key, w in want.items():
        check(bool(torch.isfinite(got[key]).all()), f"{what} {key}: finite")
        worst = max(worst, float((got[key] - w).abs().max()
                                 / w.abs().max()))
    return worst


def ppo_replay_card_vs_cpu(torch, meta_loss, params, replays,
                           clip: float) -> dict:
    """A PPO replay meta-loss and meta-gradient on the card, held against
    the CPU on the card's baseline fits and reported against the CPU on
    its own. Every ratio of the card's run is recorded: the gradient is
    held within REPLAY_GRAD_TOL unless one lies within CLIP_MARGIN of a
    clip bound (then REPLAY_FLIP_TOL); the loss within REPLAY_LOSS_TOL of
    the query's (the last call's) mean |ratio x advantage|."""
    from exploring_meta_tpu_torch.rl import adapt_rl
    ratios, scales, plain = [], [], adapt_rl.ppo_policy_loss

    def recording(new, old, adv, clip, valid):
        ratio, keep = torch.exp(new - old).detach(), valid > 0
        ratios.append(ratio[keep])
        scales.append(float((ratio * adv)[keep].abs().mean()))
        return plain(new, old, adv, clip=clip, valid=valid)

    adapt_rl.ppo_policy_loss = recording
    try:
        loss, grads, fits = replay_meta_grad(torch, meta_loss, params,
                                             replays, "cuda")
    finally:
        adapt_rl.ppo_policy_loss = plain
    r = torch.cat(ratios)
    nearest = float((r[:, None] - r.new_tensor([1 - clip, 1 + clip]))
                    .abs().min())
    cpu_loss, cpu_grads, replayed = replay_meta_grad(
        torch, meta_loss, params, replays, "cpu", fits)
    own_loss, own_grads, own_fits = replay_meta_grad(torch, meta_loss,
                                                     params, replays, "cpu")
    loss_err = abs(loss - cpu_loss)
    check(loss_err <= REPLAY_LOSS_TOL * scales[-1],
          f"replay meta-loss card {loss} vs CPU {cpu_loss}, terms of mean "
          f"size {scales[-1]}")
    worst = grads_err(torch, grads, cpu_grads, "replay meta-gradient")
    tol = REPLAY_GRAD_TOL if nearest > CLIP_MARGIN else REPLAY_FLIP_TOL
    check(worst <= tol, f"replay meta-gradient: |card - CPU| {worst} of "
                        f"max|grad|, limit {tol} (nearest ratio to a clip "
                        f"bound {nearest})")
    return {"loss": {"cuda": loss, "cpu": cpu_loss, "cpu_own_fits": own_loss},
            "loss_abs_err": loss_err, "loss_terms_mean": scales[-1],
            "grad_max_rel_err": worst, "grad_tol": tol,
            "returns_err": fits_err(fits, replayed, 1),
            "grad_max_rel_err_own_fits": grads_err(
                torch, grads, own_grads, "replay meta-gradient, own fits"),
            "fits_err": fits_err(fits, own_fits),
            "ratio_range": [float(r.min()), float(r.max())],
            "nearest_ratio_to_clip": nearest}


def replay_grad_phase(torch, gpu) -> dict:
    """Phase 8, second part: one ``make_replay_meta_loss("ppo")`` value and
    meta-gradient (20 tasks x 20 episodes x 100 steps, 3 inner epochs) on
    identical replays, card vs CPU (:func:`ppo_replay_card_vs_cpu`)."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.replay_meta import (
        collect_replays, make_replay_meta_loss,
    )
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.trainers.rl import rl_config
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.tree import tree_map

    cfg = RLScriptConfig()
    rl_cfg = rl_config(cfg)
    env, policy = Particles2D(), DiagNormalPolicy(2, 2)
    params = policy.init(torch.Generator().manual_seed(SEED + 9),
                         device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    roll = make_rollout(env, policy.sample, cfg.adapt_batch_size,
                        cfg.max_path_length)
    replays, _ = collect_replays(
        "ppo", policy, tree_map(lambda t: t.cuda(), params), roll,
        env.sample_tasks(gen, cfg.meta_batch_size), gen, rl_cfg)
    res = ppo_replay_card_vs_cpu(torch,
                                 make_replay_meta_loss("ppo", policy, rl_cfg),
                                 params, replays, rl_cfg.ppo_clip_ratio)
    print(f"PPO replay meta-gradient, card vs CPU: {res} [{gpu}]", flush=True)
    return res



def fused_configs() -> dict:
    """The fused configurations at full width -> {name: (trainer kind,
    its keyword arguments, config)}: MAML-TRPO at ``bench.py``'s
    ``trpo_particles`` (outer_lr 1.0, ``bench.py:475-493``), maml_ppo at
    the ``RLScriptConfig`` defaults with Adam 0.01, and ``maml_omni``
    (:func:`vision_config`) through ``VisionTrainer``."""
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    return {"maml_trpo": ("rl", {"algo": "trpo"},
                          RLScriptConfig(outer_lr=1.0, seed=SEED)),
            "maml_ppo": ("rl", {"algo": "ppo"},
                         RLScriptConfig(outer_lr=0.01, seed=SEED)),
            "maml_vision": ("vision", {}, vision_config())}


def fused_trainer_run(torch, gc, tc, kind: str, kw: dict, cfg, fuse: int,
                      tmp: str) -> dict:
    """One trainer run of FUSED_ITERATIONS iterations at ``fuse``, with
    every counter zeroed just before -> its counters, wall time, metrics
    and final params."""
    import dataclasses
    import math
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    import numpy as np
    from exploring_meta_tpu_torch.utils import graphs

    cfg = dataclasses.replace(cfg, fuse=fuse,
                              num_iterations=FUSED_ITERATIONS)
    trainer = (RLTrainer(cfg, path=tmp + "/", **kw) if kind == "rl"
               else VisionTrainer(cfg, path=tmp + "/", **kw))
    torch.cuda.synchronize()
    graphs.reset_counts()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    loss = "meta_loss" if kind == "rl" else "train_loss"
    check(len(metrics[loss]) == FUSED_ITERATIONS
          and all(v is not None and math.isfinite(v)
                  for vals in metrics.values() for v in vals),
          f"fuse {fuse}: {FUSED_ITERATIONS} finite rows, {metrics}")
    with np.load(os.path.join(run, "model.npz")) as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    return {"counts": dict(graphs.COUNTS),
            "launches": {**gc.launch_counts(), **tc.launch_counts()},
            "captured": {**gc.captured_counts(), **tc.captured_counts()},
            "wall_s": wall, "metrics": metrics, "params": params}


def fused_setup(torch, kind: str, kw: dict, cfg):
    """The objects a trainer's fused loop runs on, built as the trainer
    builds them -> (train function, params, optimizer or None, generator);
    ``train`` is bound to them at its first call."""
    import dataclasses
    from exploring_meta_tpu_torch.utils.tree import tree_map
    cfg = dataclasses.replace(cfg, fuse=FUSE)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 10)
    if kind == "rl":
        from exploring_meta_tpu_torch.adapt.maml import adam
        from exploring_meta_tpu_torch.envs.factory import make_env
        from exploring_meta_tpu_torch.rl.rollout import make_rollout
        from exploring_meta_tpu_torch.rl.train_scan import (
            make_adam_train_scan, make_trpo_train_scan,
        )
        from exploring_meta_tpu_torch.trainers.rl import (
            build_policy, rl_config, trpo_config,
        )
        env, _ = make_env(cfg.env)
        policy = build_policy(env, False, cfg.fc_neurons, cfg.activation)
        if cfg.bf16:
            policy = policy._replace(compute_dtype="bf16")
        params = policy.init(gen)
        roll = make_rollout(env, policy.sample, cfg.adapt_batch_size,
                            cfg.max_path_length)
        if kw["algo"] == "trpo":
            return (make_trpo_train_scan(env, policy, roll, rl_config(cfg),
                                         trpo_config(cfg),
                                         cfg.meta_batch_size, FUSE),
                    params, None, gen)
        params = tree_map(torch.Tensor.requires_grad_, params)
        return (make_adam_train_scan(env, policy, roll, rl_config(cfg),
                                     kw["algo"], cfg.meta_batch_size, FUSE),
                params, adam(params, cfg.outer_lr), gen)
    from exploring_meta_tpu_torch.adapt.maml import (
        adam, cast_compute, make_train_scan,
    )
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    train_ds, valid_ds, _ = get_dataset(
        "omni", seed=cfg.seed, synthetic=True,
        synth_classes=cfg.synth_classes, synth_per_class=cfg.synth_per_class,
        device="cuda")
    spec = omniglot_spec(cfg.ways)
    params = tree_map(lambda t: t.requires_grad_(),
                      init_cnn4(gen, spec, device="cuda"))
    fa = cast_compute(make_vision_fast_adapt(spec, cfg.inner_lr,
                                             cfg.adapt_steps, cfg.shots,
                                             cfg.ways))

    def sampler(ds):
        return lambda g: sample_task_batch(g, ds, cfg.ways, cfg.shots,
                                           cfg.meta_batch_size)

    return (make_train_scan(fa, sampler(train_ds), FUSE,
                            eval_sample_fn=sampler(valid_ds)),
            params, adam(params, cfg.outer_lr), gen)


def state_tensors(params, opt) -> list:
    """The tensors an iteration updates in place: the params' leaves and
    the optimizer's state."""
    from exploring_meta_tpu_torch.utils.tree import tree_leaves
    out = list(tree_leaves(params))
    if opt is not None:
        for st in opt.state.values():
            out += [v for v in st.values() if hasattr(v, "copy_")]
    return out


def replay_vs_eager(torch, loop, params, opt, gen) -> tuple:
    """One replay against one eager iteration started from the same params,
    optimizer state and generator state -> (the largest |difference| of
    the params relative to max|params| over the tree, the L2 difference
    relative to the eager iteration's step)."""
    from exploring_meta_tpu_torch.utils.tree import tree_leaves
    tensors = state_tensors(params, opt)
    with torch.no_grad():
        saved = [t.detach().clone() for t in tensors]
    loop.row.zero_()                # the metrics row a replay writes
    rng, row = gen.get_state(), loop.row.clone()
    loop.graph.replay()
    torch.cuda.synchronize()
    replayed = [t.detach().clone() for t in tree_leaves(params)]
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)
    gen.set_state(rng)
    loop.row.copy_(row)
    loop.step()
    torch.cuda.synchronize()
    eager = [t.detach() for t in tree_leaves(params)]
    top = max(float(e.abs().max()) for e in eager)
    l2 = lambda xs, ys: sum(float((x - y).norm()) ** 2
                            for x, y in zip(xs, ys)) ** 0.5
    return (max(float((a - b).abs().max()) for a, b in zip(replayed, eager))
            / top, l2(replayed, eager) / l2(eager, saved))


# CUDA runtime calls by which the host starts device work
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def launch_profile(torch, fn, iterations: int, names: tuple) -> dict:
    """``fn`` (``iterations`` iterations) once under the profiler -> the
    device kernels (count, the timeline they cover), the host's CUDA
    runtime calls that start device work (LAUNCH_CALLS, each counted), and
    the launches of the kernels whose names hold one of ``names``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if is_kernel(torch, e)]
    calls, top = {}, {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                and e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    for k in kernels:
        us, n = top.get(k.name, (0.0, 0))
        top[k.name] = (us + k.time_range.elapsed_us(), n + 1)
    return {"profiled_wall_us": 1e6 * wall, "iterations": iterations,
            "top_per_iteration": sorted(
                ((name[:60], us / iterations, n / iterations)
                 for name, (us, n) in top.items()), key=lambda t: -t[1])[:10],
            "kernel_launches": len(kernels),
            "busy_union_us": union_us(kernels),
            "host_launch_calls": calls,
            "host_launches_per_iteration": sum(calls.values()) / iterations,
            "named_kernels": {n: sum(1 for k in kernels if n in k.name)
                              for n in names}}


def fused_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 9: the main path of slice 8, fused meta-iterations (``--fuse
    10``) as CUDA-graph replays, in three full-width configurations
    (:func:`fused_configs`), each through its trainer for FUSED_ITERATIONS
    iterations (two chunks, the first with the eager warm-up) with the
    counters zeroed just before: one capture and FUSED_ITERATIONS - 1
    replays, the path's kernels launched by the warm-up and recorded in
    the graph; the same run at ``fuse 1`` (twice) against it; then, on the
    same objects built outside the trainer, one replay against one eager
    iteration from the same state, s per iteration of graph and eager in
    turns, and a chunk of replays and one eager iteration profiled."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.trainers.fused import fetch
    from exploring_meta_tpu_torch.trainers.rl import build_policy
    from exploring_meta_tpu_torch.utils.tree import tree_items
    out = {}
    for name, (kind, kw, cfg) in fused_configs().items():
        path_kernels = (gc.KERNELS if kind == "rl" else tc.KERNELS)
        names = (tuple(KERNEL_NAMES.values()) if kind == "rl"
                 else CNN4_KERNEL_NAMES)
        runs = {f: fused_trainer_run(torch, gc, tc, kind, kw, cfg, f,
                                     os.path.join(tmp, f"{name}_{i}"))
                for i, f in enumerate((FUSE, 1))}
        again = fused_trainer_run(torch, gc, tc, kind, kw, cfg, 1,
                                  os.path.join(tmp, f"{name}_again"))
        g, e = runs[FUSE], runs[1]
        check(g["counts"] == {"captures": 1,
                              "replays": FUSED_ITERATIONS - 1},
              f"{name}: one capture and {FUSED_ITERATIONS - 1} replays, "
              f"{g['counts']}")
        check(e["counts"] == {"captures": 0, "replays": 0},
              f"{name} at fuse 1: no graph, {e['counts']}")
        for k in path_kernels:
            check(g["launches"][k] > 0 and g["captured"][k] > 0,
                  f"{name}: {k} launched by the warm-up and recorded in the "
                  f"graph, {g['launches']}, {g['captured']}")
        replayed = {k: g["counts"]["replays"] * g["captured"][k]
                    for k in path_kernels}
        eager_err = tree_err(torch, g["params"], e["params"],
                             f"{name} graph vs eager")
        spread = tree_err(torch, again["params"], e["params"],
                          f"{name} eager vs eager")
        if kw.get("algo") == "trpo":
            # ROADMAP Queue 3: f32 CG on a Fisher damped by 1e-5 holds an
            # outer step to 2e-2 of itself; the step here is the whole
            # run's move from the initial params, in L2
            init = dict(tree_items(build_policy(
                Particles2D(), False, cfg.fc_neurons, cfg.activation).init(
                    torch.Generator(device="cuda").manual_seed(cfg.seed))))
            l2 = lambda a, b: sum(float((a[k].cpu() - b[k].cpu()).norm())
                                  ** 2 for k in b) ** 0.5
            err = l2(g["params"], e["params"]) / l2(e["params"], init)
            tol_desc = "2e-2 of the step"
            check(err <= FUSED_TRPO_TOL, f"{name}: graph vs eager {err} of "
                                         f"the step, limit {FUSED_TRPO_TOL}")
        else:
            tol_desc = "1e-5 of max|params|"
            err = eager_err
            check(err <= FUSED_ADAM_TOL, f"{name}: graph vs eager {err} of "
                                         f"max|params|, limit "
                                         f"{FUSED_ADAM_TOL}")
        print(f"{name} fused x{FUSE}, {FUSED_ITERATIONS} iterations: "
              f"{g['counts']}; kernel launches eager {g['launches']}, "
              f"recorded a replay {g['captured']}, replayed {replayed}; "
              f"graph vs eager {err} ({tol_desc}; max |err| {eager_err} of "
              f"max|params|), eager vs eager {spread}; trainer wall graph "
              f"{g['wall_s']} s, eager {e['wall_s']} s [{gpu}]", flush=True)

        train, params, opt, gen = fused_setup(torch, kind, kw, cfg)
        args = (params, gen) if opt is None else (params, opt, gen)
        fetch(train(*args)[-1])                 # warm-up, capture, replays
        loop = train.fused.bound()
        one, one_step = replay_vs_eager(torch, loop, params, opt, gen)
        check(one_step <= FUSED_TRPO_TOL if opt is None
              else one <= FUSED_ADAM_TOL,
              f"{name}: one replay vs one eager iteration {one} of "
              f"max|params|, {one_step} of the step")
        graph_s, eager_s = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetch(train(*args)[-1])
            graph_s.append((time.perf_counter() - t0) / FUSE)
            loop.row.zero_()
            t0 = time.perf_counter()
            for _ in range(FUSED_EAGER):
                loop.step()
            torch.cuda.synchronize()
            eager_s.append((time.perf_counter() - t0) / FUSED_EAGER)
        gprof = launch_profile(torch, lambda: fetch(train(*args)[-1]), FUSE,
                               names)
        loop.row.zero_()
        eprof = launch_profile(torch, loop.step, 1, names)
        for prof, wall in ((gprof, FUSE * min(graph_s)),
                           (eprof, min(eager_s))):
            prof["wall_us"] = 1e6 * wall
            prof["idle_share"] = 1 - prof["busy_union_us"] / prof["wall_us"]
        # a kernel of each wrapper of the path ran inside the replays
        for n in (names if kind == "rl" else (
                "fwd_conv_stats_kernel", "bwd_dw_kernel", "bwd_input_kernel")):
            check(gprof["named_kernels"][n] > 0,
                  f"{name}: {n} ran inside the replays, "
                  f"{gprof['named_kernels']}")
        out[name] = {
            "counts": g["counts"], "launches": g["launches"],
            "captured": g["captured"], "replayed": replayed,
            "graph_vs_eager": err, "graph_vs_eager_max_rel": eager_err,
            "eager_vs_eager": spread, "one_replay_vs_eager": one,
            "one_replay_vs_eager_of_step": one_step,
            "trainer_wall_s": {"graph": g["wall_s"], "eager": e["wall_s"]},
            "s_per_iteration": {"graph": graph_s, "eager": eager_s},
            "profile": {"graph": gprof, "eager": eprof},
            "metrics": {"graph": g["metrics"], "eager": e["metrics"]}}
        print(f"{name}: one replay vs one eager iteration {one} of "
              f"max|params| ({one_step} of its step); s per iteration "
              f"graph {graph_s}, eager {eager_s}; host launches per "
              f"iteration graph "
              f"{gprof['host_launches_per_iteration']} "
              f"{gprof['host_launch_calls']}, eager "
              f"{eprof['host_launches_per_iteration']}; idle graph "
              f"{100 * gprof['idle_share']:.1f} %, eager "
              f"{100 * eprof['idle_share']:.1f} %; kernels a replayed "
              f"iteration {gprof['kernel_launches'] / FUSE}, busy "
              f"{gprof['busy_union_us'] / FUSE} us; in the replays "
              f"{gprof['named_kernels']} [{gpu}]", flush=True)
        for key, us, count in gprof["top_per_iteration"]:
            print(f"  {us:12.1f} us  x{count:7.1f}  {key} (a replay)")
        del train, params, opt, gen, loop
    return out

@contextlib.contextmanager
def timed_sections(torch, module, sections: dict, counts):
    """Within the block, each function ``module.<name>`` of ``sections``
    ({name: label}) is timed by host clock between two syncs, with the
    kernel launches (``counts()``) it made -> {label: {"s", "calls",
    "launches"}}, filled as the calls run. The module's functions are
    restored on exit."""
    out, saved = {}, {name: getattr(module, name) for name in sections}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec = out.setdefault(sections[name],
                                 {"s": 0.0, "calls": 0, "launches": {}})
            rec["s"] += time.perf_counter() - t0
            rec["calls"] += 1
            for k, n in counts().items():
                rec["launches"][k] = rec["launches"].get(k, 0) + n - before[k]
            return res
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def recorded_reps(rc):
    """Within the block, every pair of activations that the RC probes
    compare (``analysis/rc.py:_similarities``) is recorded as (initial,
    adapted) -> the list."""
    sims, got = rc._similarities, []

    def recording(init_rep, adapted_rep, compare):
        got.append((init_rep, adapted_rep))
        return sims(init_rep, adapted_rep, compare)

    rc._similarities = recording
    try:
        yield got
    finally:
        rc._similarities = sims


def json_numbers(x) -> list:
    """Every number in a parsed JSON value."""
    if isinstance(x, dict):
        return [v for y in x.values() for v in json_numbers(y)]
    if isinstance(x, list):
        return [v for y in x for v in json_numbers(y)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) \
        else []


def check_artifacts(run: str, keys: dict, what: str) -> dict:
    """Every artifact ``keys`` names ({relative path: the JSON's top-level
    keys, ``...`` for any, or None for a text matrix}) exists and parses,
    with those keys and finite numbers -> {path: parsed}."""
    import math
    import numpy as np
    out = {}
    for rel, want in keys.items():
        path = os.path.join(run, rel)
        check(os.path.exists(path), f"{what}: {rel} written")
        if want is None:
            out[rel] = np.loadtxt(path, ndmin=2)
            nums = out[rel].ravel().tolist()
        else:
            with open(path) as f:
                out[rel] = json.load(f)
            if want is not ...:
                check(set(out[rel]) == set(want),
                      f"{what}: {rel} keys {sorted(out[rel])}, want "
                      f"{sorted(want)}")
            nums = json_numbers(out[rel])
        check(all(math.isfinite(v) for v in nums),
              f"{what}: {rel} finite, {out[rel]}")
    return out


def cl_card_vs_cpu(torch, params, spec, pool, anil: bool = False) -> dict:
    """One vision CL matrix (``analysis/cl.py:cl_matrix``, setting 1) from
    one pool, sampled once, on the card and on the CPU: the adapted params
    within ADAPT_TOL, the logits within CL_LOGIT_TOL, and each accuracy
    entry equal but for tie flips -> the errors and the flips."""
    import numpy as np
    from exploring_meta_tpu_torch.analysis.cl import cl_matrix
    from exploring_meta_tpu_torch.models import cnn4
    from exploring_meta_tpu_torch.utils.tree import tree_map
    data, labels = pool
    kw = {}
    if anil:
        kw = dict(features_fn=lambda p, x: cnn4.cnn4_features(p, spec, x),
                  head_apply=cnn4.cnn4_head_apply)
    res = {}
    for dev in ("cuda", "cpu"):
        res[dev] = cl_matrix(
            lambda p, x: cnn4.cnn4_apply(p, spec, x),
            tree_map(lambda t: t.detach().to(dev), params), data.to(dev),
            labels.to(dev), spec.ways, 1, ANALYSIS_CL["inner_lr"],
            ANALYSIS_CL["adapt_steps"], **kw)
    card, cpu = res["cuda"], res["cpu"]
    what = f"CL matrix{' (ANIL)' if anil else ''} card vs CPU"
    adapted = max(tree_err(torch, a, b, what)
                  for a, b in zip(card.adapted, cpu.adapted))
    check(adapted <= ADAPT_TOL, f"{what}: adapted params {adapted} of "
                                f"max|params|, limit {ADAPT_TOL}")
    lc, lp = card.logits.cpu().double(), cpu.logits.double()
    scale = float(lp.abs().max())
    logits = float((lc - lp).abs().max()) / scale
    check(logits <= CL_LOGIT_TOL, f"{what}: logits {logits} of max|logits|,"
                                  f" limit {CL_LOGIT_TOL}")
    top2 = lp.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / scale
    flipped = lc.argmax(-1) != lp.argmax(-1)
    check(bool((margin[flipped] <= 2 * CL_LOGIT_TOL).all()),
          f"{what}: a prediction differs where the top two logits are "
          f"{margin[flipped].tolist()} of max|logits| apart")
    n_eval = lp.shape[-2]
    moved = np.rint(np.abs(card.acc - cpu.acc) * n_eval)
    check(bool((moved <= flipped.sum(-1).numpy()).all()),
          f"{what}: accuracy entries differ beyond the tie flips, "
          f"{card.acc.tolist()} vs {cpu.acc.tolist()}")
    return {"adapted_err": adapted, "logit_err": logits,
            "tie_flips": int(flipped.sum()), "entries_moved": int(moved.sum()),
            "acc_card": card.acc.tolist(), "acc_cpu": cpu.acc.tolist()}


def probes_card_vs_f64(torch, reps: list) -> dict:
    """Linear and kernel CKA and the CCA mean of each recorded pair of RC
    activations on the card (float32) against float64 on the CPU (the
    same activations; the CCA covariance from ``np.cov``) -> the largest
    errors, and the rank of each stacked covariance. CKA within PROBE_TOL;
    the CCA mean within PROBE_TOL where that covariance has full rank."""
    import numpy as np
    from exploring_meta_tpu_torch.analysis.rc import _rows
    from exploring_meta_tpu_torch.ops.cca import (
        cca_from_cov, get_cca_similarity,
    )
    from exploring_meta_tpu_torch.ops.cka import get_kernel_CKA, get_linear_CKA
    check(len(reps) > 0, "the RC probes compared activations")
    errs = {"cka_linear": 0.0, "cka_kernel": 0.0, "cca_full_rank": 0.0,
            "cca_rank_deficient": 0.0}
    ranks = []
    for init_rep, adapted_rep in reps:
        a, b = _rows(adapted_rep), _rows(init_rep)
        a64, b64 = a.double().cpu(), b.double().cpu()
        for name, fn in (("cka_linear", get_linear_CKA),
                         ("cka_kernel", get_kernel_CKA)):
            err = abs(float(fn(a, b)) - float(fn(a64, b64)))
            check(err <= PROBE_TOL, f"{name} card vs float64: {err}, limit "
                                    f"{PROBE_TOL}")
            errs[name] = max(errs[name], err)
        if a.shape[0] == a.shape[1]:
            a, b, a64, b64 = a[:-1], b[:-1], a64[:-1], b64[:-1]
        if a.shape[0] >= a.shape[1]:
            a, b, a64, b64 = a.T, b.T, a64.T, b64.T
        cov = np.cov(torch.cat([a64, b64]).numpy())
        rank = int(np.linalg.matrix_rank(cov))
        ranks.append((rank, cov.shape[0]))
        err = abs(get_cca_similarity(a, b, epsilon=1e-10)[1]
                  - cca_from_cov(cov, a.shape[0], epsilon=1e-10)[1])
        full = rank == cov.shape[0]
        check(not full or err <= PROBE_TOL,
              f"CCA mean card vs float64 at full rank: {err}, limit "
              f"{PROBE_TOL}")
        key = "cca_full_rank" if full else "cca_rank_deficient"
        errs[key] = max(errs[key], err)
    return {"max_err": errs, "pairs": len(reps),
            "full_rank_pairs": sum(r == n for r, n in ranks),
            "ranks": sorted(set(ranks))}


def analysis_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 10: the main path of slice 9, the analysis tier. A full-width
    vision run dir (``VisionTrainer``, ``omniglot_spec(5)``, 2 iterations,
    a checkpoint each) goes through ``eval_vision.run`` and a MAML-TRPO
    run dir (``RLTrainer``, the ``RLScriptConfig`` defaults) through
    ``eval_rl.run(run_cl=True, run_rc=True)``, each with the launch
    counters zeroed just before and every section timed; every artifact
    is checked; RC runs again with vpg and ppo; one CL matrix (MAML, and
    ANIL once) is held card vs CPU on one pool and profiled; the RC
    activations' CKA and CCA are held against float64 on the CPU."""
    import numpy as np
    from exploring_meta_tpu_torch.analysis import cl as acl
    from exploring_meta_tpu_torch.analysis import eval_rl as er
    from exploring_meta_tpu_torch.analysis import eval_vision as ev
    from exploring_meta_tpu_torch.analysis import rc as arc
    from exploring_meta_tpu_torch.envs.factory import make_env
    from exploring_meta_tpu_torch.models import cnn4
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    from exploring_meta_tpu_torch.trainers.rl import (
        RLTrainer, build_policy, rl_config,
    )
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, VisionConfig,
    )
    from exploring_meta_tpu_torch.utils.experiment import load_params

    def counts():
        return {**gc.launch_counts(), **tc.launch_counts()}

    def zeroed():
        torch.cuda.synchronize()
        gc.reset_launch_counts()
        tc.reset_launch_counts()

    start = time.perf_counter()
    out = {"cuts": {"n_eval_batches": ANALYSIS_EVAL_BATCHES,
                    "cl_params": ANALYSIS_CL, "rep_params": ANALYSIS_REP,
                    "rl": "eval_rl defaults: 10 eval tasks, CL 5 tasks, RC "
                          "5 tasks at layers [2, 4, -1]"}}
    print(f"analysis: depth cut to n_eval_batches {ANALYSIS_EVAL_BATCHES} "
          f"(JAX default 20); CL {ANALYSIS_CL}, RC {ANALYSIS_REP} (JAX "
          f"defaults) [{gpu}]", flush=True)

    # vision: train, then eval_vision with the counters zeroed just before
    trainer = VisionTrainer(VisionConfig(num_iterations=2, save_every=1,
                                         synthetic=True, seed=SEED),
                            path=os.path.join(tmp, "vision") + "/")
    trainer.run()
    run = trainer.model_path
    zeroed()
    with timed_sections(torch, ev, {
            "checkpoint_sweep": "ckpt sweep",
            "meta_test_accuracy": "meta-test", "run_cl_exp": "CL",
            "run_rep_exp": "RC",
            "measure_change_through_time": "through-time"},
            counts) as secs, recorded_reps(arc) as vision_reps:
        t0 = time.perf_counter()
        res = ev.run(run, n_eval_batches=ANALYSIS_EVAL_BATCHES,
                     cl_params=ANALYSIS_CL, rep_params=ANALYSIS_REP,
                     synthetic=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    for k in tc.KERNELS:
        check(launches[k] > 0, f"eval_vision: {k} launched, {launches}")
    arts = check_artifacts(run, {
        "ckpnt_results.json": {"0", "1"},
        "eval_results.json": {"test_acc", "ckpnt_results", "cl_res",
                              "rep_res", "cca_through_time"},
        "cl_exp/acc_matrix.out": None,
        "cl_exp/cl_res.json": {"av_acc", "fwt", "rem", "bwt_plus"},
        "cl_exp/cl_params.json": set(ANALYSIS_CL),
        "rep_exp/cca_results.json": {"4"},
        "cca_through_time.json": ...}, "eval_vision")
    n = ANALYSIS_CL["n_tasks"]
    check(arts["cl_exp/acc_matrix.out"].shape == (n, n),
          f"eval_vision: a {n} x {n} CL matrix")
    ccas = arts["rep_exp/cca_results.json"]["4"] + arts[
        "cca_through_time.json"]
    check(len(arts["rep_exp/cca_results.json"]["4"])
          == ANALYSIS_REP["n_tasks"] and len(arts["cca_through_time.json"])
          == 1 and all(0.0 <= v <= 1.0 for v in ccas),
          f"eval_vision: CCA values in [0, 1], {ccas}")
    out["eval_vision"] = {"wall_s": wall, "sections": secs,
                          "launches": launches, "test_acc": res["test_acc"],
                          "cl_res": res["cl_res"], "cca": ccas}
    print(f"eval_vision: {wall} s, launches {launches}, test_acc "
          f"{res['test_acc']}, CL {res['cl_res']}, CCA {ccas} [{gpu}]",
          flush=True)
    for label, rec in secs.items():
        print(f"  {label}: {rec['s']} s ({rec['calls']} calls), launches "
              f"{rec['launches']} [{gpu}]", flush=True)

    # one CL matrix from one pool, card vs CPU, then profiled on the card
    spec = cnn4.omniglot_spec(WAYS)
    template = cnn4.init_cnn4(torch.Generator(device="cuda").manual_seed(0),
                              spec, device="cuda")
    params = load_params(os.path.join(run, "model.npz"), template)
    _, _, test_ds = get_dataset("omni", seed=SEED, synthetic=True,
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    pool = sample_task_batch(gen, test_ds, WAYS, 1, ANALYSIS_CL["n_tasks"])
    zeroed()
    versus = cl_card_vs_cpu(torch, params, spec, pool)
    anil_spec = cnn4.anil_omniglot_spec(WAYS)
    anil = cl_card_vs_cpu(torch, cnn4.init_cnn4(gen, anil_spec,
                                                device="cuda"),
                          anil_spec, pool, anil=True)

    def one_matrix():
        return acl.cl_matrix(lambda p, x: cnn4.cnn4_apply(p, spec, x),
                             params, *pool, WAYS, 1,
                             ANALYSIS_CL["inner_lr"],
                             ANALYSIS_CL["adapt_steps"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_matrix()
    torch.cuda.synchronize()
    prof = profiled(torch, one_matrix, time.perf_counter() - t0)
    out["cl_card_vs_cpu"] = {"maml": versus, "anil": anil, "profile": prof}
    print(f"CL matrix card vs CPU, one pool of {n} tasks: adapted params "
          f"{versus['adapted_err']} of max|params| (limit {ADAPT_TOL}), "
          f"logits {versus['logit_err']} of max|logits| (limit "
          f"{CL_LOGIT_TOL}), tie flips {versus['tie_flips']} (entries moved "
          f"{versus['entries_moved']}); ANIL: {anil['adapted_err']}, "
          f"{anil['logit_err']}, flips {anil['tie_flips']}; one matrix "
          f"{prof['wall_us']} us wall, kernels busy {prof['busy_union_us']} "
          f"us, idle {100 * prof['idle_share']:.1f} %, "
          f"{prof['kernel_launches']} kernels [{gpu}]", flush=True)

    # RL: train MAML-TRPO, then eval_rl with CL and RC
    rcfg = RLScriptConfig(num_iterations=2, save_every=1, seed=SEED)
    trainer = RLTrainer(rcfg, algo="trpo",
                        path=os.path.join(tmp, "rl") + "/")
    trainer.run()
    run = trainer.model_path
    zeroed()
    with timed_sections(torch, er, {
            "evaluate": "meta-test", "run_cl_rl_exp": "CL",
            "run_rep_rl_exp": "RC",
            "measure_change_through_time": "through-time"},
            counts) as rsecs, recorded_reps(arc) as rl_reps:
        t0 = time.perf_counter()
        res = er.run(run, run_cl=True, run_rc=True)
        torch.cuda.synchronize()
        rwall = time.perf_counter() - t0
    rlaunches = counts()
    for k in gc.KERNELS:
        check(rlaunches[k] > 0, f"eval_rl: {k} launched, {rlaunches}")
    rarts = check_artifacts(run, {
        "eval_results.json": {"eval", "cl_res_rew", "cl_res_suc", "rep_res",
                              "cca_through_time"},
        "cl_exp/cl_rew_matrix.out": None, "cl_exp/cl_suc_matrix.out": None,
        "cl_exp/cl_res_rew.json": {"av_acc", "fwt", "rem", "bwt_plus"},
        "cl_exp/cl_res_suc.json": {"av_acc", "fwt", "rem", "bwt_plus"},
        "cl_exp/cl_params.json": ...,
        "rep_exp/cca_rl_results.json": {"2", "4", "-1"},
        "rep_exp/rep_params.json": ..., "rep_exp/rep_extra.json": {
            "across_steps", "av_layer_changes_mean", "av_layer_changes_std",
            "performance"},
        "cca_through_time.json": ...}, "eval_rl")
    check(rarts["cl_exp/cl_rew_matrix.out"].shape == (5, 5)
          and len(res["eval"]["tasks_rewards"]) == rcfg.n_eval_tasks,
          "eval_rl: a 5 x 5 CL matrix and 10 eval tasks")
    out["eval_rl"] = {"wall_s": rwall, "sections": rsecs,
                      "launches": rlaunches, "eval": res["eval"],
                      "cca": rarts["rep_exp/cca_rl_results.json"],
                      "cca_through_time": rarts["cca_through_time.json"]}
    print(f"eval_rl: {rwall} s, launches {rlaunches}, mean reward "
          f"{res['eval']['mean_reward']}, CCA by layer "
          f"{rarts['rep_exp/cca_rl_results.json']}, through time "
          f"{rarts['cca_through_time.json']} [{gpu}]", flush=True)
    for label, rec in rsecs.items():
        print(f"  {label}: {rec['s']} s ({rec['calls']} calls), launches "
              f"{rec['launches']} [{gpu}]", flush=True)

    # RC once more with vpg and with ppo: each branch of single_adapt_step
    env, _ = make_env(rcfg.env)
    policy = build_policy(env, False)
    params = load_params(os.path.join(run, "model.npz"), policy.init(
        torch.Generator(device="cuda").manual_seed(0)))
    roll = make_rollout(env, policy.sample, rcfg.adapt_batch_size,
                        rcfg.max_path_length)
    out["rc_algos"] = {}
    for algo in ("vpg", "ppo"):
        zeroed()
        t0 = time.perf_counter()
        rc = arc.run_rep_rl_exp(os.path.join(tmp, f"rc_{algo}"), policy,
                                params, env, roll, rl_config(rcfg),
                                torch.Generator(device="cuda").manual_seed(
                                    SEED), algo=algo)
        torch.cuda.synchronize()
        got = counts()
        check(all(got[k] > 0 for k in gc.KERNELS)
              and all(np.isfinite(v) for vals in rc["cca"].values()
                      for v in vals),
              f"RC {algo}: the sweeps ran, finite CCA, {got}, {rc['cca']}")
        out["rc_algos"][algo] = {"s": time.perf_counter() - t0,
                                 "launches": got, "cca": rc["cca"]}
        print(f"RC {algo}: {out['rc_algos'][algo]['s']} s, launches {got}, "
              f"CCA {rc['cca']} [{gpu}]", flush=True)

    # CKA / CCA of the RC activations, card vs float64 on the CPU: every
    # vision pair; the RL pairs of the first task, one a layer (float64 on
    # the CPU takes ~1 s a pair of 2,000 states)
    t0 = time.perf_counter()
    out["probes"] = {"vision": probes_card_vs_f64(torch, vision_reps),
                     "rl": probes_card_vs_f64(torch, rl_reps[:3])}
    for name, p in out["probes"].items():
        print(f"probes {name}, card f32 vs CPU f64 over {p['pairs']} pairs "
              f"({p['full_rank_pairs']} with a full-rank stacked "
              f"covariance; (rank, size) {p['ranks']}): max |err| "
              f"{p['max_err']} (CKA and full-rank CCA held at {PROBE_TOL}) "
              f"[{gpu}]", flush=True)
    out["probes"]["s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - start
    print(f"analysis phase: {out['phase_s']} s, of which the float64 probes "
          f"{out['probes']['s']} s [{gpu}]", flush=True)
    return out

def graph_ms_per_call(torch, fn, calls: int = GRAPH_CALLS,
                      replays: int = GRAPH_REPLAYS) -> float:
    """ms of one call of ``fn`` run back to back: ``calls`` calls captured
    in one CUDA graph, its replays timed by CUDA events. A call of a few
    microseconds launched from Python one at a time is timed by the host's
    dispatch (``time_ms``); a replay launches the same kernels with no
    host between them, so this is their device time and the gaps between
    kernels on the device. (The profiler's per-kernel records are not
    used: after the earlier phases' sessions CUPTI has been seen to
    deliver a session's records into the next one.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def single_task_kernels(tc, F, torch, gpu) -> dict:
    """Phase 11, rows 1-2 of the TPU-kernel table: the single-task forms
    (B = 1) at the vision baseline's N = SINGLE_N images, at each of the
    four block shapes. Each kernel against its twin in f32 and bf16; in
    f32 its bound, its CUDA-event time, its time back to back in a CUDA
    graph (the device's), its twin's time and phase 3's library
    yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    co, out = HIDDEN, {name: [] for name in tc.KERNELS}
    err = {name: {} for name in tc.KERNELS}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for blk, (h, ci) in enumerate(BLOCKS):
            x, w, b, sc, be, g = block_inputs(torch, tc, gen, 1, SINGLE_N, h,
                                              ci, dt)
            what = f"block {blk + 1} B 1 N {SINGLE_N}"
            got = tc.block_bwd_params(x, w, b, sc, be, g)
            want = tc.block_bwd_params_plain(x, w, b, sc, be, g)
            dy_abs = want[0].abs().sum(dim=(1, 2, 3))
            errs = {
                "cnn4_block_fwd": held(torch, tc.block_fwd(x, w, b, sc, be),
                                       tc.block_fwd_plain(x, w, b, sc, be),
                                       dname, what),
                "cnn4_block_bwd_params": max(
                    held(torch, got[i], want[i], dname, f"{what} output {i}",
                         db=dy_abs + 1e-30 if i == 2 else None)
                    for i in range(5)),
                "cnn4_block_bwd_input": held(
                    torch, tc.block_bwd_input(got[0], w, h, h),
                    tc.block_bwd_input_plain(got[0], w, h, h), dname, what)}
            for name, e in errs.items():
                err[name][dname] = max(err[name].get(dname, 0.0), e)
            if dt != torch.float32:
                continue
            dy = got[0]
            xg = x[0].permute(0, 3, 1, 2).contiguous()
            wg = w[0].permute(3, 2, 0, 1).contiguous()
            dyg = dy[0].permute(0, 3, 1, 2).contiguous()
            runs = {
                "cnn4_block_fwd": (
                    lambda: tc.block_fwd(x, w, b, sc, be),
                    lambda: tc.block_fwd_plain(x, w, b, sc, be),
                    lambda: torch.relu(F.batch_norm(
                        F.conv2d(xg, wg, b[0], stride=2, padding=1), None,
                        None, sc[0], be[0], training=True, eps=tc.EPS))),
                "cnn4_block_bwd_params": (
                    lambda: tc.block_bwd_params(x, w, b, sc, be, g),
                    lambda: tc.block_bwd_params_plain(x, w, b, sc, be, g),
                    None),
                "cnn4_block_bwd_input": (
                    lambda: tc.block_bwd_input(dy, w, h, h),
                    lambda: tc.block_bwd_input_plain(dy, w, h, h),
                    lambda: torch.nn.grad.conv2d_input(
                        xg.shape, wg, dyg, stride=2, padding=1)),
            }
            for name, (kern, plain, lib) in runs.items():
                bms, oms = bound(name, 1, SINGLE_N, h, ci, co, 4)
                row = {"block": blk + 1, "x": [1, SINGLE_N, h, h, ci],
                       "on_path": not (name == "cnn4_block_bwd_input"
                                       and blk == 0),
                       "ms": time_ms(kern),
                       "graph_ms": graph_ms_per_call(torch, kern),
                       "plain_ms": time_ms(plain),
                       "library_ms": time_ms(lib) if lib else None,
                       "bytes_ms": bms, "ops_ms": oms,
                       "bound_ms": max(bms, oms)}
                if name == "cnn4_block_bwd_params":
                    row["dw_library_ms"] = time_ms(
                        lambda: torch.nn.grad.conv2d_weight(
                            xg, wg.shape, dyg, stride=2, padding=1))
                out[name].append(row)
    res = {}
    for name, rows in out.items():
        path = [r for r in rows if r["on_path"]]
        res[name] = {"max_abs_err": err[name], "shapes": rows, **{
            k: (None if any(r[k] is None for r in path)
                else sum(r[k] for r in path))
            for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                      "bytes_ms", "ops_ms", "bound_ms")}}
        for r in rows:
            print(f"  {name} B 1 block {r['block']} x {r['x']}: ms "
                  f"{r['ms']} graph_ms {r['graph_ms']} bound_ms "
                  f"{r['bound_ms']} plain_ms {r['plain_ms']} library_ms "
                  f"{r['library_ms']}" + (f" dw_library_ms "
                                          f"{r['dw_library_ms']}"
                                          if "dw_library_ms" in r else ""),
                  flush=True)
        r = res[name]
        print(f"single-task {name} (row {1 if name == 'cnn4_block_fwd' else 2}"
              f", B 1, N {SINGLE_N}, the blocks on the path summed): ms "
              f"{r['ms']} graph_ms {r['graph_ms']} bound_ms "
              f"{r['bound_ms']} plain_ms {r['plain_ms']} library_ms "
              f"{r['library_ms']} max_abs_err {r['max_abs_err']} [{gpu}]",
              flush=True)
    return res


def counted_train(torch, gc, tc, cls):
    """A subclass of the RL baseline ``cls`` whose training loop records
    its wall time and kernel launches, apart from the meta-test's."""
    class Counted(cls):
        def _train(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = super()._train(*args)
            torch.cuda.synchronize()
            self.train_s = time.perf_counter() - t0
            self.train_launches = {**gc.launch_counts(),
                                   **tc.launch_counts()}
            return last
    Counted.__name__ = cls.__name__
    return Counted


def rl_baseline_runs(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 11, the RL baselines' main paths: BASELINE_ITERATIONS
    iterations of each at the RLScriptConfig defaults, with every counter
    zeroed just before."""
    import math
    import numpy as np
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.trainers import baselines
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.experiment import load_params

    template = DiagNormalPolicy(2, 2).init(torch.Generator().manual_seed(0),
                                           device="cpu")
    out = {}
    for name, cls, test in (("ppo", baselines.PPOBaseline, "ppo"),
                            ("trpo", baselines.TRPOBaseline, "trpo"),
                            ("random", baselines.RandomPolicyBaseline,
                             "ppo")):
        cfg = RLScriptConfig(num_iterations=BASELINE_ITERATIONS, seed=SEED)
        trainer = counted_train(torch, gc, tc, cls)(
            cfg, path=os.path.join(tmp, name) + "/")
        torch.cuda.synchronize()
        gc.reset_launch_counts()
        tc.reset_launch_counts()
        t0 = time.perf_counter()
        final = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**gc.launch_counts(), **tc.launch_counts()}
        tasks = BASELINE_ITERATIONS * cfg.meta_batch_size
        train = {"gae_sweep": 0 if name == "random" else tasks,
                 "discount_sweep": tasks}
        check({k: trainer.train_launches[k] for k in train} == train
              and all(trainer.train_launches[k] == 0 for k in tc.KERNELS),
              f"{name} baseline: each sweep once a task an iteration, "
              f"{trainer.train_launches}, want {train}")
        want = {k: train[k] + BASELINE_META_TEST[test][k] for k in train}
        check({k: launches[k] for k in want} == want,
              f"{name} baseline with its meta-test: {launches}, want {want}")
        run = trainer.model_path
        with open(os.path.join(run, "metrics.json")) as f:
            metrics = json.load(f)
        keys = {"average_return"} | ({"loss"} if name == "ppo" else set())
        for key in keys:
            check(len(metrics[key]) == BASELINE_ITERATIONS
                  and all(v is not None and math.isfinite(v)
                          for v in metrics[key]),
                  f"{name} baseline metrics.json {key}: {metrics}")
        with open(os.path.join(run, "logger.json")) as f:
            logger = json.load(f)
        check(math.isfinite(final["mean_reward"])
              and logger["test_reward"] == final["mean_reward"]
              and (name == "trpo") == ("test_reward" not in metrics),
              f"{name} baseline: test_reward finite and logged")
        for rel in ("model.npz", "model_checkpoints/model_1.npz"):
            p = load_params(os.path.join(run, rel), template)
            check(all(bool(torch.isfinite(t).all()) for t in
                      (p["sigma"], *(v for layer in p["mean"]
                                     for v in layer.values()))),
                  f"{name} baseline {rel} loads, finite")
        if name == "random":
            for rel in ("baseline.npz", "model_checkpoints/baseline_1.npz"):
                with np.load(os.path.join(run, rel)) as z:
                    check(list(z.files) == ["weight"]
                          and z["weight"].shape == (8, 1)
                          and bool(np.isfinite(z["weight"]).all()),
                          f"random baseline {rel}")
        out[name] = {"launches": launches,
                     "train_launches": trainer.train_launches,
                     "s_per_iteration": trainer.train_s / BASELINE_ITERATIONS,
                     "wall_s": wall, "metrics": metrics,
                     "test_reward": final["mean_reward"]}
        print(f"{name} baseline, full width, {BASELINE_ITERATIONS} "
              f"iterations: {out[name]['s_per_iteration']} s an iteration "
              f"(training loop), run with meta-test {wall} s; launches "
              f"{launches} (training {trainer.train_launches}); metrics "
              f"{metrics}; test_reward {final['mean_reward']} [{gpu}]",
              flush=True)
    return out


def vision_baseline_run(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 11, the vision baseline's main path: BASELINE_ITERATIONS
    iterations at the script's defaults on synthetic Omniglot at its real
    shape, with every counter zeroed just before."""
    import math
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.trainers.baselines import VisionBaseline
    from exploring_meta_tpu_torch.utils.config import VisionConfig
    from exploring_meta_tpu_torch.utils.experiment import load_params

    cfg = VisionConfig(outer_lr=0.001, num_iterations=BASELINE_ITERATIONS,
                       synthetic=True, synth_classes=1623, synth_per_class=20,
                       seed=SEED)
    steps = max(1, int(320 / cfg.meta_batch_size))
    trainer = VisionBaseline(cfg, path=os.path.join(tmp, "vision") + "/")
    torch.cuda.synchronize()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    test_acc = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**gc.launch_counts(), **tc.launch_counts()}
    want = {k: BASELINE_ITERATIONS * steps * n + META_EVAL_CALLS[k]
            for k, n in BASELINE_STEP_CALLS.items()}
    check({k: launches[k] for k in want} == want,
          f"vision baseline: {launches}, want {want} ({steps} Adam steps "
          f"an iteration at B = 1, then a meta-eval)")
    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    check(len(metrics["train_loss"]) == BASELINE_ITERATIONS
          and all(v is not None and math.isfinite(v)
                  for vals in metrics.values() for v in vals),
          f"vision baseline metrics.json: {metrics}")
    check(0.0 <= test_acc <= 1.0, f"vision baseline test_acc {test_acc}")
    template = init_cnn4(torch.Generator().manual_seed(0), omniglot_spec(5),
                         device="cpu")
    for rel in ("model.npz", "model_checkpoints/model_0.npz"):
        p = load_params(os.path.join(run, rel), template)
        check(all(bool(torch.isfinite(v).all())
                  for v in (p["head"]["w"], p["base"][0]["conv"]["w"])),
              f"vision baseline {rel} loads, finite")
    print(f"vision baseline, Omniglot 5-way 1-shot, {steps} Adam steps an "
          f"iteration: {wall} s for {BASELINE_ITERATIONS} iterations and "
          f"the meta-test; launches {launches}; metrics {metrics}; test_acc "
          f"{test_acc} [{gpu}]", flush=True)
    return {"launches": launches, "wall_s": wall, "metrics": metrics,
            "test_acc": test_acc, "steps_an_iteration": steps}


def baseline_card_vs_cpu(torch, gpu) -> dict:
    """Phase 11: one PPO task update (3 Adam epochs) and one TRPO update on
    one trajectory collected on the card, each again on the CPU path on
    the card's baseline fit; one vision scan of Adam steps on one drawn
    batch on both."""
    from exploring_meta_tpu_torch.adapt.maml import adam
    from exploring_meta_tpu_torch.models.cnn4 import (
        cnn4_apply, init_cnn4, omniglot_spec,
    )
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    from exploring_meta_tpu_torch.ops.losses import (
        cross_entropy, ppo_policy_loss,
    )
    from exploring_meta_tpu_torch.rl.adapt_rl import normalized_advantages
    from exploring_meta_tpu_torch.trainers import baselines as tb
    from exploring_meta_tpu_torch.trainers.rl import rl_config, trpo_config
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.tree import (
        tree_items, tree_leaves, tree_map, tree_unflatten,
    )

    cfg = RLScriptConfig(seed=SEED)
    rl_cfg, trpo_cfg = rl_config(cfg), trpo_config(cfg)
    env, _, policy, roll = tb._setup_rl_baseline(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    params = policy.init(gen)
    traj = roll(params, tb._task_at(env.sample_tasks(gen, 1), 0), gen)

    def on(dev, fits, update):
        tr = traj.map(lambda t: t.to(dev))
        return with_baseline_fits(lambda: update(dev, tr), fits)

    def ppo(dev, tr, capturable=True):
        p = tree_map(lambda t: t.to(dev).clone().requires_grad_(), params)
        opt = adam(p, cfg.outer_lr)
        if not capturable:
            opt = torch.optim.Adam(opt.param_groups[0]["params"],
                                   lr=cfg.outer_lr, eps=1e-8)
        states, actions = tr.flat(tr.state), tr.flat(tr.action)
        with torch.enable_grad():
            first = ppo_policy_loss(
                policy.log_prob(p, states, actions),
                policy.log_prob(p, states, actions).detach(),
                normalized_advantages(tr, rl_cfg), clip=rl_cfg.ppo_clip_ratio,
                valid=tr.flat(tr.valid).unsqueeze(-1)).sum()
            grads = torch.autograd.grad(first, tree_leaves(p))
        loss, _ = tb.ppo_update(policy, p, opt, tr, rl_cfg)
        return p, float(loss), tree_unflatten(p, grads)

    def trpo(dev, tr):
        new, _, info = tb.trpo_update(
            policy, tree_map(lambda t: t.to(dev), params), tr, rl_cfg,
            trpo_cfg)
        return new, info["index"]

    out = {}
    (card, card_loss, card_g), fits = on("cuda", None, ppo)
    (cpu, cpu_loss, cpu_g), _ = on("cpu", fits, ppo)
    (plain, _, _), _ = on("cuda", fits, lambda dev, tr: ppo(dev, tr, False))
    out["ppo_grad_err"] = tree_close(torch, card_g, cpu_g, REPLAY_GRAD_TOL,
                                     "PPO first-epoch gradient card vs CPU")
    out["ppo_params_err"] = tree_close(
        torch, plain, cpu, BASELINE_PPO_TOL,
        "PPO task update, non-capturable Adam on the card, vs CPU")
    out["ppo_capturable_err"] = tree_close(
        torch, card, cpu, ADAM_F32_TOL,
        "PPO task update, the path's capturable Adam, card vs CPU")
    out["ppo_loss"] = {"card": card_loss, "cpu": cpu_loss}
    (card, card_i), fits = on("cuda", None, trpo)
    (cpu, cpu_i), _ = on("cpu", fits, trpo)
    check(card_i == cpu_i >= 0, f"TRPO update: candidate {card_i} accepted "
                                f"on the card, {cpu_i} on the CPU")
    flat = lambda tree: torch.cat([t.detach().cpu().double().reshape(-1)
                                   for _, t in tree_items(tree)])
    step = float((flat(cpu) - flat(params)).norm())
    out["trpo_index"] = card_i
    out["trpo_err_of_step"] = float((flat(card) - flat(cpu)).norm()) / step
    check(out["trpo_err_of_step"] <= BASELINE_TRPO_TOL,
          f"TRPO update card vs CPU: {out['trpo_err_of_step']} of the step, "
          f"limit {BASELINE_TRPO_TOL}")

    spec = omniglot_spec(WAYS)
    train, _, _ = get_dataset("omni", seed=SEED, synthetic=True,
                              synth_classes=1623, synth_per_class=20,
                              device="cuda")
    data, labels = sample_task_batch(gen, train, WAYS, 1,
                                     int(320 / META_BATCH))
    base = init_cnn4(gen, spec, device="cuda")
    lr, res = 0.001, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev).clone().requires_grad_(), base)
        x, y = data.to(dev), labels.to(dev)
        with torch.enable_grad():
            grads = torch.autograd.grad(cross_entropy(
                cnn4_apply(p, spec, x[0]), y[0]), tree_leaves(p))
        loss, _ = tb.make_supervised_steps(spec)(p, adam(p, lr), x, y)
        res[dev] = (dict(tree_items(p)), float(loss),
                    tree_unflatten(p, grads))
    out["vision_grad_err"] = tree_close(
        torch, res["cuda"][2], res["cpu"][2], REPLAY_GRAD_TOL,
        "vision first-step gradient card vs CPU")
    keep = [k for k in res["cpu"][0] if not k.endswith("conv/b")]
    top = max(float(v.detach().abs().max()) for v in res["cpu"][0].values())
    diff = torch.cat([(res["cuda"][0][k].detach().cpu() - res["cpu"][0][k]
                       .detach()).abs().reshape(-1) for k in keep])
    out["vision_params_err"] = float(diff.max()) / top
    out["vision_elements_past_tol"] = int((diff > VISION_TOL * top).sum())
    steps = data.shape[0]
    check(out["vision_elements_past_tol"] <= VISION_FLIP_SHARE * diff.numel()
          and float(diff.max()) <= steps * lr,
          f"vision scan card vs CPU (conv biases aside): "
          f"{out['vision_elements_past_tol']} of {diff.numel()} elements "
          f"past {VISION_TOL} of max|params|, the largest "
          f"{float(diff.max())}, limit {steps} steps of lr {lr}")
    out["vision_conv_b_err"] = tree_err(
        torch, {k: res["cuda"][0][k] for k in res["cpu"][0]}, res["cpu"][0],
        "vision scan card vs CPU, all leaves")
    out["vision_loss"] = {"card": res["cuda"][1], "cpu": res["cpu"][1]}
    check(abs(res["cuda"][1] - res["cpu"][1]) <= 1e-4 * abs(res["cpu"][1]),
          f"vision scan loss card vs CPU: {out['vision_loss']}")
    print(f"baselines card vs CPU (on the card's fits): PPO first-epoch "
          f"gradient {out['ppo_grad_err']} of max|grad|, update "
          f"{out['ppo_params_err']} of max|params| (non-capturable Adam on "
          f"the card), {out['ppo_capturable_err']} (capturable; losses "
          f"{out['ppo_loss']});"
          f" TRPO candidate {card_i} both, params {out['trpo_err_of_step']} "
          f"of the step; vision first-step gradient "
          f"{out['vision_grad_err']} of max|grad|, scan "
          f"{out['vision_params_err']} of max|params| "
          f"({out['vision_elements_past_tol']} elements past {VISION_TOL}; "
          f"all leaves {out['vision_conv_b_err']}), losses "
          f"{out['vision_loss']} [{gpu}]", flush=True)
    return out


def bf16_tie_rows(torch, layers, acts, states):
    """``[N]`` bool on the CPU: the states whose bf16 forward through
    ``layers`` (``[{"w", "b"}]``; ``acts[i]`` "relu", "tanh" or None after
    layer i) has a tie, where two summation orders may round to
    neighbouring bf16 values: a bf16 rounding boundary within K u sum|x w|
    of an exact float64 dot of K bf16 products (the most any float32
    summation order can be off), or within 2 ulp of an exact tanh (a
    float32 tanh's error)."""
    u = 2.0 ** -24

    def near_boundary(exact, window):
        ulp = torch.exp2(torch.floor(torch.log2(
            exact.abs().clamp(min=2.0 ** -126))) - 7)
        frac = exact / ulp - torch.floor(exact / ulp)
        return ((frac - 0.5).abs() * ulp <= window).any(dim=-1)

    bf16 = lambda t: t.detach().cpu().float().bfloat16().double()
    x = bf16(states)
    tie = torch.zeros(x.shape[0], dtype=torch.bool)
    for p, act in zip(layers, acts):
        w, b = bf16(p["w"]), bf16(p["b"])
        dot = x @ w
        tie |= near_boundary(dot, w.shape[0] * u * (x.abs() @ w.abs()))
        x = bf16(dot.float().bfloat16().double() + b)
        if act == "relu":
            x = x.clamp(min=0)
        elif act == "tanh":
            t = torch.tanh(x)
            tie |= near_boundary(t, 4 * u * t.abs())
            x = bf16(t)
    return tie


def bf16_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 11, bf16 meta-RL: maml_trpo ``--bf16 --fuse 10`` through the
    trainer (one capture, FUSED_ITERATIONS - 1 replays), s per replayed
    iteration bf16 against f32 in turns, one eager maml_ppo ``--bf16``
    iteration, and the bf16 density on the card against the CPU path and
    against f32."""
    import dataclasses
    import math
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.trainers.fused import fetch
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.tree import tree_map

    out = {}
    cfg = RLScriptConfig(outer_lr=1.0, seed=SEED, bf16=True)
    g = fused_trainer_run(torch, gc, tc, "rl", {"algo": "trpo"}, cfg, FUSE,
                          os.path.join(tmp, "bf16_trpo"))
    check(g["counts"] == {"captures": 1, "replays": FUSED_ITERATIONS - 1},
          f"bf16 maml_trpo: one capture and {FUSED_ITERATIONS - 1} "
          f"replays, {g['counts']}")
    for k in gc.KERNELS:
        check(g["launches"][k] > 0 and g["captured"][k] > 0,
              f"bf16 maml_trpo: {k} launched by the warm-up and recorded in "
              f"the graph, {g['launches']}, {g['captured']}")
    out["fused_trpo"] = {k: g[k] for k in ("counts", "launches", "captured",
                                           "wall_s", "metrics")}
    print(f"bf16 maml_trpo --fuse {FUSE}, {FUSED_ITERATIONS} iterations: "
          f"{g['counts']}; launches {g['launches']}, recorded a replay "
          f"{g['captured']}; trainer wall {g['wall_s']} s; meta_loss "
          f"{g['metrics']['meta_loss']} [{gpu}]", flush=True)

    loops = {}
    for name, flag in (("f32", False), ("bf16", True)):
        train, params, _, gen = fused_setup(
            torch, "rl", {"algo": "trpo"}, dataclasses.replace(cfg, bf16=flag))
        fetch(train(params, gen)[-1])             # warm-up, capture, replays
        loops[name] = (train, params, gen)
    s_iter = {name: [] for name in loops}
    for _ in range(2):
        for name, (train, params, gen) in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetch(train(params, gen)[-1])
            s_iter[name].append((time.perf_counter() - t0) / FUSE)
    out["s_per_replayed_iteration"] = s_iter
    print(f"maml_trpo replayed iteration, in turns: f32 {s_iter['f32']} s, "
          f"bf16 {s_iter['bf16']} s [{gpu}]", flush=True)
    del loops

    trainer = RLTrainer(RLScriptConfig(num_iterations=1, bf16=True,
                                       seed=SEED), algo="ppo",
                        path=os.path.join(tmp, "bf16_ppo") + "/")
    torch.cuda.synchronize()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    final = trainer.run()
    torch.cuda.synchronize()
    launches = {**gc.launch_counts(), **tc.launch_counts()}
    with open(os.path.join(trainer.model_path, "metrics.json")) as f:
        metrics = json.load(f)
    check(all(launches[k] > 0 for k in gc.KERNELS),
          f"bf16 maml_ppo: both sweeps ran, {launches}")
    check(all(v is not None and math.isfinite(v)
              for vals in metrics.values() for v in vals)
          and math.isfinite(final["mean_reward"]),
          f"bf16 maml_ppo: finite metrics, {metrics}")
    out["eager_ppo"] = {"launches": launches, "metrics": metrics,
                        "wall_s": time.perf_counter() - t0}
    print(f"bf16 maml_ppo, one eager iteration and the meta-test: launches "
          f"{launches}, metrics {metrics} [{gpu}]", flush=True)

    pol = DiagNormalPolicy(2, 2, compute_dtype="bf16")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    params = tree_map(lambda t: t + 0.1 * torch.randn(
        t.shape, generator=gen, device="cuda"), pol.init(gen))
    states = torch.rand(BF16_STATES, 2, generator=gen, device="cuda") - 0.5
    card = pol.density(params, states)[0]
    cpu = pol.density(tree_map(lambda t: t.cpu(), params), states.cpu())[0]
    f32 = pol._replace(compute_dtype="f32").density(params, states)[0]
    check(card.dtype == torch.float32, "bf16 loc is float32")
    top = float(cpu.abs().max())
    err = (card.cpu() - cpu).abs().max(dim=-1).values / top
    differ = err > BF16_DENSITY_TOL
    tie = bf16_tie_rows(torch, params["mean"], ["relu", "relu", None],
                        states)
    check(bool(tie[differ].all()) and float(differ.float().mean())
          <= BF16_TIE_SHARE and float(err.max()) <= BF16_STEPS,
          f"bf16 density card vs CPU: {int(differ.sum())} states differ "
          f"(max {float(err.max())} of max|loc|), "
          f"{int((differ & ~tie).sum())} of them without a tie")
    gap = float((f32 - card).abs().max() / f32.abs().max())
    check(1e-4 < gap < 3e-2, f"bf16 vs f32 density: {gap} of max|loc|")
    out["density"] = {"card_vs_cpu_max": float(err.max()),
                      "states_differing": int(differ.sum()),
                      "tie_states": int(tie.sum()), "bf16_vs_f32": gap}
    print(f"bf16 density, {BF16_STATES} states: card vs CPU max "
          f"{float(err.max())} of max|loc| ({int(differ.sum())} states "
          f"differ, {int(tie.sum())} have a tie); bf16 vs f32 {gap} of "
          f"max|loc| [{gpu}]", flush=True)
    return out


def slice10_phase(tc, gc, F, torch, gpu, tmp) -> dict:
    """Phase 11: the non-meta baselines and bf16 meta-RL (slice 10)."""
    start = time.perf_counter()
    out = {"single_task_kernels": single_task_kernels(tc, F, torch, gpu),
           "rl_baselines": rl_baseline_runs(torch, gc, tc, gpu, tmp),
           "vision_baseline": vision_baseline_run(torch, gc, tc, gpu, tmp),
           "card_vs_cpu": baseline_card_vs_cpu(torch, gpu),
           "bf16": bf16_phase(torch, gc, tc, gpu, tmp)}
    out["phase_s"] = time.perf_counter() - start
    print(f"baselines and bf16 phase: {out['phase_s']} s [{gpu}]",
          flush=True)
    return out


# Phase 12 (slice 11), the run utilities. Resume, bit for bit: maml_omni
# (vision_config) --fuse RESUME_FUSE, RESUME_TOTAL iterations with a
# checkpoint every RESUME_FUSE, against a resume from model_<RESUME_FUSE -
# 1>; maml_trpo at trpo_particles --fuse FUSE, FUSED_ITERATIONS against
# FUSE + a resume from model_<FUSE - 1>; maml_ppo eager (Adam 0.01)
# PPO_TOTAL iterations against a resume from model_1. The rows, the final
# params and the final meta-test must be equal exactly (PR 8: graph and
# eager are bit for bit equal on these paths). PROFILE_ITERATIONS eager
# maml_omni iterations without and with --profile, then with --trace.
RESUME_FUSE, RESUME_TOTAL, PPO_TOTAL, PROFILE_ITERATIONS = 5, 10, 3, 3
PHASE_NAMES = ("sample", "valid_eval", "meta_step")


def checkpoint_timed(cls):
    """``cls`` whose ``save_model_checkpoint`` records, in ``ckpt_ms``, the
    ms each call holds the training thread."""
    class Timed(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.ckpt_ms, self.rows_t = [], []

        def save_model_checkpoint(self, *args, **kw):
            t0 = time.perf_counter()
            super().save_model_checkpoint(*args, **kw)
            self.ckpt_ms.append(1e3 * (time.perf_counter() - t0))

        def log_metrics(self, metrics):
            self.rows_t.append(time.perf_counter())
            super().log_metrics(metrics)

    return Timed


def counted_run(torch, gc, tc, kind: str, kw: dict, cfg, path: str) -> dict:
    """One trainer run with every counter zeroed just before -> the
    trainer, its final meta-test, metrics.json, model.npz, the counters,
    the wall time and the ms each checkpoint held the training thread."""
    import numpy as np
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils import graphs

    cls = checkpoint_timed(RLTrainer if kind == "rl" else VisionTrainer)
    trainer = cls(cfg, path=path + "/", **kw)
    torch.cuda.synchronize()
    graphs.reset_counts()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    final = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(trainer.model_path, "metrics.json")) as f:
        metrics = json.load(f)
    with np.load(os.path.join(trainer.model_path, "model.npz")) as z:
        params = {k: z[k] for k in z.files}
    return {"trainer": trainer, "final": final, "metrics": metrics,
            "params": params, "counts": dict(graphs.COUNTS),
            "launches": {**gc.launch_counts(), **tc.launch_counts()},
            "captured": {**gc.captured_counts(), **tc.captured_counts()},
            "wall_s": wall, "ckpt_ms": trainer.ckpt_ms,
            "rows_t": trainer.rows_t}


def run_gap(full: dict, res: dict, total: int, done: int) -> dict:
    """How far the resumed run lies from the uninterrupted one: rows that
    differ, the largest |difference| of the final params, whether the final
    meta-test differs; the resumed run must have ``total - done - 1``
    training rows."""
    import numpy as np
    rows = 0
    for key, vals in res["metrics"].items():
        want = full["metrics"][key]
        if len(want) == total:
            check(len(vals) == total - done - 1,
                  f"{key}: {len(vals)} resumed rows, {total - done - 1} "
                  "expected")
        rows += sum(a != b for a, b in zip(vals, want[len(want) - len(vals):]))
    check(res["params"].keys() == full["params"].keys(), "the same params")
    err = max(float(np.abs(res["params"][k].astype(np.float64)
                           - full["params"][k]).max())
              for k in full["params"])
    return {"rows_differing": int(rows), "params_max_abs": err,
            "final_differs": res["final"] != full["final"]}


def resume_case(torch, gc, tc, name: str, kind: str, kw: dict, cfg,
                total: int, done: int, tmp: str, gpu: str) -> dict:
    """An uninterrupted run of ``total`` iterations and a resume from its
    ``model_<done>.npz``, which must agree exactly. If they do not, a
    second uninterrupted run shows the run-to-run spread before the check
    fails."""
    import dataclasses
    cfg = dataclasses.replace(cfg, num_iterations=total)
    full = counted_run(torch, gc, tc, kind, kw, cfg,
                       os.path.join(tmp, f"{name}_full"))
    ckpt = os.path.join(full["trainer"].model_path, "model_checkpoints",
                        f"model_{done}.npz")
    res = counted_run(torch, gc, tc, kind, kw,
                      dataclasses.replace(cfg, resume=ckpt),
                      os.path.join(tmp, f"{name}_resumed"))
    gap = run_gap(full, res, total, done)
    print(f"{name}: resumed from model_{done} ({total - done - 1} of "
          f"{total} iterations): {gap}; counts {res['counts']}, launches "
          f"{res['launches']}, recorded in a replay {res['captured']}; "
          f"wall {full['wall_s']} / {res['wall_s']} s [{gpu}]", flush=True)
    if gap != {"rows_differing": 0, "params_max_abs": 0.0,
               "final_differs": False}:
        again = counted_run(torch, gc, tc, kind, kw, cfg,
                            os.path.join(tmp, f"{name}_again"))
        spread = run_gap(full, again, total, -1)
        print(f"{name}: two uninterrupted runs: {spread}", flush=True)
        check(False, f"{name}: resumed run differs from the uninterrupted "
                     f"one, {gap} (run to run: {spread})")
    return {"full": full, "resumed": res, "gap": gap}


def reference_omniglot_cnn(torch):
    """An Omniglot CNN4 built with ``torch.nn`` to the reference's module
    nesting and state_dict keys (``base.<i>.conv``, ``base.<i>.normalize``,
    ``linear``), as ``tests/test_import_reference.py`` builds it."""
    nn = torch.nn

    class Block(nn.Module):
        def __init__(self, ci, co):
            super().__init__()
            self.conv = nn.Conv2d(ci, co, 3, stride=2, padding=1)
            nn.init.xavier_uniform_(self.conv.weight)
            nn.init.zeros_(self.conv.bias)
            self.normalize = nn.BatchNorm2d(co, affine=True)
            nn.init.uniform_(self.normalize.weight)

        def forward(self, x):
            return torch.relu(self.normalize(self.conv(x)))

    class OmniglotCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.base = nn.Sequential(Block(1, HIDDEN), *(
                Block(HIDDEN, HIDDEN) for _ in range(3)))
            self.linear = nn.Linear(HIDDEN, WAYS)
            with torch.no_grad():
                self.linear.weight.normal_()
                self.linear.bias.zero_()

        def forward(self, x):
            return self.linear(self.base(x).mean(dim=[2, 3]))

    return OmniglotCNN()


def imported_model_phase(torch, tc, gpu, tmp) -> dict:
    """A reference-layout Omniglot CNN4 (seeded) through
    ``import_reference_run`` into ``VisionServer.from_checkpoint``: one
    request (the kernels at B = 1) and one batch of BATCH on the card,
    each against the CPU path on the same params within phase 3's 1e-3."""
    from exploring_meta_tpu_torch.models.cnn4 import omniglot_spec
    from exploring_meta_tpu_torch.serve import VisionServer
    from exploring_meta_tpu_torch.tasks import datasets as td
    from exploring_meta_tpu_torch.tasks import sampler as ts
    from exploring_meta_tpu_torch.utils.import_torch import (
        import_reference_run,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = reference_omniglot_cnn(torch)
    src = os.path.join(tmp, "reference_run")
    os.makedirs(os.path.join(src, "model_checkpoints"))
    torch.save(model.state_dict(), os.path.join(src, "model.pt"))
    with open(os.path.join(src, "logger.json"), "w") as f:
        json.dump({"config": {"algo": "maml_5w5s", "dataset": "omni",
                              "ways": WAYS, "shots": SHOTS, "seed": SEED}},
                  f)
    dst = import_reference_run(src, os.path.join(tmp, "imported"))
    path, spec = os.path.join(dst, "model.npz"), omniglot_spec(WAYS)
    kw = dict(inner_lr=INNER_LR, adapt_steps=ADAPT_STEPS)
    server = VisionServer.from_checkpoint(path, spec, device="cuda", **kw)
    cpu = VisionServer.from_checkpoint(path, spec, device="cpu", **kw)
    sx, sy, qx, _ = make_requests(torch, td, ts, torch.device("cuda"))
    out = {}
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    one = server(sx[0], sy[0], qx[0])
    torch.cuda.synchronize()
    out["launches_request"] = tc.launch_counts()
    tc.reset_launch_counts()
    batch = server.batch(sx, sy, qx)
    torch.cuda.synchronize()
    out["launches_batch"] = tc.launch_counts()
    for what in ("launches_request", "launches_batch"):
        check(all(n > 0 for n in out[what].values()),
              f"imported model: every CNN4 kernel ran, {what} {out[what]}")
    agree(one, cpu(sx[0].cpu(), sy[0].cpu(), qx[0].cpu()), 1e-3,
          "imported model, one request: card vs CPU")
    ref = cpu.batch(sx[:4].cpu(), sy[:4].cpu(), qx[:4].cpu())
    agree((batch[0][:4], batch[1][:4]), ref, 1e-3,
          "imported model, a batch: card vs CPU")
    out["max_abs_prob_err"] = max(
        float((one[1].cpu() - cpu(sx[0].cpu(), sy[0].cpu(),
                                  qx[0].cpu())[1]).abs().max()),
        float((batch[1][:4].cpu() - ref[1]).abs().max()))
    print(f"imported reference CNN4 served: one request launches "
          f"{out['launches_request']}, a batch of {BATCH} "
          f"{out['launches_batch']}; card vs CPU max |prob| "
          f"{out['max_abs_prob_err']} [{gpu}]", flush=True)
    out["launches"] = {k: out["launches_request"][k]
                       + out["launches_batch"][k]
                       for k in out["launches_batch"]}
    return out


def s_per_row(run: dict) -> float:
    """Mean s between consecutive training rows after the first (each row
    is logged after its metrics reached the host)."""
    t = run["rows_t"][:-1]                        # the meta-test's row apart
    return (t[-1] - t[0]) / (len(t) - 1)


def profile_phase(torch, gc, tc, gpu, tmp) -> dict:
    """PROFILE_ITERATIONS eager maml_omni iterations plain, with
    ``--profile`` (JAX's phases and ``phase_times.json`` schema) and, last,
    with ``--trace`` (a Chrome trace that names ``cnn4_block_fwd``)."""
    import dataclasses
    cfg = vision_config(num_iterations=PROFILE_ITERATIONS)
    runs = {name: counted_run(torch, gc, tc, "vision", {},
                              dataclasses.replace(cfg, **kw),
                              os.path.join(tmp, f"omni_{name}"))
            for name, kw in (("plain", {}), ("profile", {"profile": True}))}
    with open(os.path.join(runs["profile"]["trainer"].model_path,
                           "phase_times.json")) as f:
        phases = json.load(f)
    check(set(phases) == set(PHASE_NAMES)
          and all(set(v) == {"total_s", "mean_ms", "count"}
                  and v["count"] == PROFILE_ITERATIONS
                  for v in phases.values()),
          f"phase_times.json has JAX's phases and schema: {phases}")
    trace_dir = os.path.join(tmp, "trace")
    runs["trace"] = counted_run(torch, gc, tc, "vision", {},
                                dataclasses.replace(cfg, trace=trace_dir),
                                os.path.join(tmp, "omni_trace"))
    files = os.listdir(trace_dir)
    check(len(files) == 1, f"one trace file: {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        text = f.read()
    names = {k: text.count(k) for k in ("cnn4_block_fwd",
                                        "fwd_conv_stats_kernel")}
    check(names["cnn4_block_fwd"] > 0,
          f"the trace names cnn4_block_fwd: {names}")
    s_iter = {name: s_per_row(r) for name, r in runs.items()}
    print(f"maml_omni eager, s an iteration (iterations 2-"
          f"{PROFILE_ITERATIONS}): {s_iter}; phases {phases}; trace "
          f"{len(text)} bytes, names {names} [{gpu}]", flush=True)
    return {"s_per_iteration": s_iter, "phases": phases,
            "trace_bytes": len(text), "trace_names": names,
            "launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in runs["plain"]["launches"]}}


def run_utilities_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 12: the run utilities and the offline tools (slice 11)."""
    import dataclasses
    import importlib
    import numpy as np
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig

    start = time.perf_counter()
    out = {"modules": {}}
    for mod in ("gymnasium", "mujoco", "PIL"):
        try:
            m = importlib.import_module(mod)
            out["modules"][mod] = getattr(m, "__version__", "imported")
        except Exception as e:          # absent or broken: say which
            out["modules"][mod] = f"no ({type(e).__name__}: {e})"
    print(f"optional modules on this machine: {out['modules']}", flush=True)

    omni = vision_config(fuse=RESUME_FUSE, save_every=RESUME_FUSE)
    trpo = RLScriptConfig(outer_lr=1.0, seed=SEED, fuse=FUSE,
                          save_every=FUSE)
    ppo = RLScriptConfig(outer_lr=0.01, seed=SEED, save_every=1)
    cases = {
        "maml_omni": resume_case(torch, gc, tc, "maml_omni fuse 5",
                                 "vision", {}, omni, RESUME_TOTAL,
                                 RESUME_FUSE - 1, tmp, gpu),
        "maml_trpo": resume_case(torch, gc, tc, "maml_trpo fuse 10", "rl",
                                 {"algo": "trpo"}, trpo, FUSED_ITERATIONS,
                                 FUSE - 1, tmp, gpu),
        "maml_ppo": resume_case(torch, gc, tc, "maml_ppo eager", "rl",
                                {"algo": "ppo"}, ppo, PPO_TOTAL, 1, tmp,
                                gpu)}
    for name, n_iter in (("maml_omni", RESUME_TOTAL - RESUME_FUSE),
                         ("maml_trpo", FUSED_ITERATIONS - FUSE)):
        res = cases[name]["resumed"]
        check(res["counts"] == {"captures": 1, "replays": n_iter - 1},
              f"{name} resumed: one capture, {n_iter - 1} replays, "
              f"{res['counts']}")
        kernels = tc.KERNELS if name == "maml_omni" else gc.KERNELS
        for k in kernels:
            check(res["launches"][k] > 0 and res["captured"][k] > 0,
                  f"{name} resumed: {k} launched and recorded in the graph,"
                  f" {res['launches']}, {res['captured']}")
    res = cases["maml_ppo"]["resumed"]
    check(all(res["launches"][k] > 0 for k in gc.KERNELS),
          f"maml_ppo resumed: both sweeps ran, {res['launches']}")

    # async equals sync under replays: maml_omni --fuse 5 --async_ckpt
    sync = cases["maml_omni"]["full"]
    asyn = counted_run(torch, gc, tc, "vision", {},
                       dataclasses.replace(omni, num_iterations=RESUME_TOTAL,
                                           async_ckpt=True),
                       os.path.join(tmp, "omni_async"))
    for it in range(RESUME_FUSE - 1, RESUME_TOTAL, RESUME_FUSE):
        files = [os.path.join(r["trainer"].model_path, "model_checkpoints",
                              f"model_{it}.npz") for r in (sync, asyn)]
        with np.load(files[0]) as a, np.load(files[1]) as b:
            check(a.files == b.files and all(np.array_equal(a[k], b[k])
                                             for k in a.files),
                  f"async model_{it}.npz equals the synchronous one")
    print(f"maml_omni --fuse {RESUME_FUSE} checkpoints: ms holding the "
          f"training thread, sync {sync['ckpt_ms']}, async "
          f"{asyn['ckpt_ms']}; async files equal sync [{gpu}]", flush=True)

    # DCP (--ckpt_backend orbax) on maml_ppo: save, resume from the dir
    dcp = dataclasses.replace(ppo, ckpt_backend="orbax")
    saved = counted_run(torch, gc, tc, "rl", {"algo": "ppo"},
                        dataclasses.replace(dcp, num_iterations=2),
                        os.path.join(tmp, "ppo_dcp"))
    ckdir = os.path.join(saved["trainer"].model_path, "model_checkpoints")
    check(sorted(os.listdir(ckdir)) == ["0", "1"],
          f"DCP steps: {os.listdir(ckdir)}")
    res = counted_run(torch, gc, tc, "rl", {"algo": "ppo"},
                      dataclasses.replace(dcp, num_iterations=PPO_TOTAL,
                                          resume=ckdir),
                      os.path.join(tmp, "ppo_dcp_resumed"))
    gap = run_gap(cases["maml_ppo"]["full"], res, PPO_TOTAL, 1)
    check(gap == {"rows_differing": 0, "params_max_abs": 0.0,
                  "final_differs": False},
          f"maml_ppo resumed through DCP equals the uninterrupted run, {gap}")
    print(f"maml_ppo DCP: resumed from {ckdir} (latest step 1): {gap}; ms "
          f"holding the training thread a DCP save {saved['ckpt_ms']}, an "
          f"npz save (sync) {cases['maml_ppo']['full']['ckpt_ms']} [{gpu}]",
          flush=True)
    dcp_runs = {"saved": saved, "resumed": res}

    imported = imported_model_phase(torch, tc, gpu, tmp)
    profile = profile_phase(torch, gc, tc, gpu, tmp)

    runs = [r for c in cases.values() for r in (c["full"], c["resumed"])]
    runs += [asyn, *dcp_runs.values()]
    launches = {k: sum(r["launches"][k] for r in runs)
                + imported["launches"].get(k, 0)
                + profile["launches"].get(k, 0)
                for k in runs[0]["launches"]}
    keep = ("final", "metrics", "counts", "launches", "captured", "wall_s",
            "ckpt_ms")
    out.update({
        "resume": {n: {"gap": c["gap"],
                       **{w: {k: c[w][k] for k in keep}
                          for w in ("full", "resumed")}}
                   for n, c in cases.items()},
        "ckpt_ms": {"omni_fuse_npz_sync": sync["ckpt_ms"],
                    "omni_fuse_npz_async": asyn["ckpt_ms"],
                    "ppo_eager_npz_sync": cases["maml_ppo"]["full"][
                        "ckpt_ms"],
                    "ppo_eager_dcp": saved["ckpt_ms"]},
        "dcp": {"gap": gap, "resumed_counts": res["counts"]},
        "imported": imported, "profile": profile, "launches": launches})
    out["phase_s"] = time.perf_counter() - start
    print(f"run utilities phase: {out['phase_s']} s [{gpu}]", flush=True)
    return out


# Seed sweeps (slice 12). The serial sweep: SWEEP_SEEDS x SWEEP_ITERATIONS
# of maml_trpo (RLScriptConfig defaults) and maml_vision (maml_omni,
# Omniglot's real shape) through sweep.main, each seed held bit for bit
# against a standalone trainer run of it. The one-program sweeps
# (--vmap_seeds, MULTISEED_ITERATIONS iterations at --fuse MULTISEED_FUSE:
# one chunk, the eager warm-up, one capture, two replays): MAML-TRPO at
# bench.py's multiseed_trpo (S = 4 seeds 0-3, meta-batch 10, 10 episodes
# x horizon 50, bench.py:747-806) and at the RLScriptConfig defaults (S =
# 2: 20 tasks x 20 episodes x horizon 100), maml_ppo at the defaults with
# Adam 0.01 (S = 2) and maml_omni (S = 4: the CNN4 kernels at B = 128).
# Seed i of a one-program sweep draws its solo run's numbers, but the
# batched arithmetic at S x B tasks (cuBLAS's batched GEMMs, the reductions)
# rounds otherwise than at B, and runs of a few iterations amplify a
# last-bit difference without bound: TRPO's f32 CG (damping 1e-5) moves a
# step by up to 0.10 of itself with the summation order (ROADMAP Queue 3),
# the next rollouts follow the moved policy, and bf16 vision gradients
# whose sign is rounding give Adam steps of +-lr. So each seed is held
# where its state is its solo run's, and the runs' end is reported:
# - the first row (iteration 0, before any update) of each seed's run
#   against its solo run's: RL within MULTISEED_ROW_TOL relative, vision
#   (bf16 losses and accuracies) within MULTISEED_VISION_TOL (the
#   second-order standing finding);
# - one seeded iteration from the seeds' initial states against each solo
#   iteration: TRPO the same line-search outcome and params within
#   BASELINE_TRPO_TOL of the step (measured up to 0.03), PPO the whole
#   3-iteration run within MULTISEED_ADAM_TOL of max|params|; vision in
#   f32 (the bf16 rounding apart): rows within MULTISEED_ROW_TOL, each
#   seed's meta-gradient within SO_FLIP_TOL of max|grad| (a ReLU input at
#   the kink, Queue 3), the params past VISION_TOL of max|params| a share
#   VISION_FLIP_SHARE at most (Adam's first step is the gradient's sign),
#   the conv biases aside (BN removes them: their gradient is rounding).
# Throughput in turns, MULTISEED_TURNS each: one chunk of the seeded scan
# against S chunks of the solo scans, one after another (bench.py's
# baseline: the serial per-seed loop over the same fused scan); the idle
# share of a profiled seeded chunk against the unprofiled chunk's wall.
SWEEP_SEEDS, SWEEP_ITERATIONS = (0, 1), 2
MULTISEED_TRPO = dict(meta_batch_size=10, adapt_batch_size=10,
                      max_path_length=50)
MULTISEED_ITERATIONS = MULTISEED_FUSE = 3
MULTISEED_ADAM_TOL, MULTISEED_VISION_TOL, MULTISEED_ROW_TOL = 1e-4, 1e-2, 1e-5
MULTISEED_TURNS = 2
# the sweep summary's keys (scripts/sweep.py:main)
SUMMARY_KEYS = {"algo", "metric", "seeds", "runs", "mean", "std",
                "vmapped", "config", "band_metric", "band_final_mean"}


def sweep_flags(cfg) -> list:
    """A trainer config as the sweep command's flags: each flag of the
    trainer's parser whose value differs from the script default."""
    import argparse
    from exploring_meta_tpu_torch.utils.config import (
        VisionConfig, rl_argparser, vision_argparser,
    )
    vision = isinstance(cfg, VisionConfig)
    default = type(cfg)()
    parser = (vision_argparser if vision else rl_argparser)(default, "")
    flags = []
    for action in parser._actions:
        v = getattr(cfg, action.dest, None)
        if action.dest == "help" or v == getattr(default, action.dest):
            continue
        opt = action.option_strings[0]
        if isinstance(action, (argparse._StoreTrueAction,
                               argparse._StoreFalseAction)):
            flags.append(opt)
        else:
            flags += [opt, str(v)]
    return flags


def run_sweep(torch, gc, tc, argv: list, tmp: str) -> dict:
    """``sweep.main(argv)`` from ``tmp`` (the trainers' run dirs and the
    summary land there), every counter zeroed just before -> the summary,
    the counters, the wall time and the printed lines."""
    import io
    from exploring_meta_tpu_torch import sweep
    from exploring_meta_tpu_torch.utils import graphs

    os.makedirs(tmp, exist_ok=True)
    out = io.StringIO()
    torch.cuda.synchronize()
    graphs.reset_counts()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(tmp), contextlib.redirect_stdout(out):
        summary = sweep.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "sweeps", f"{summary['algo']}_" + "-".join(
            str(s) for s in summary["seeds"]) + ".json")) as f:
        check(json.load(f) == json.loads(json.dumps(summary)),
              "the summary json holds the returned summary")
    for run in summary["runs"]:
        run["run_dir"] = os.path.join(tmp, run["run_dir"])
    return {"summary": summary, "counts": dict(graphs.COUNTS),
            "launches": {**gc.launch_counts(), **tc.launch_counts()},
            "captured": {**gc.captured_counts(), **tc.captured_counts()},
            "wall_s": wall, "lines": out.getvalue().splitlines()}


def check_summary(res: dict, what: str) -> None:
    """JAX's keys, a finite band mean, and the band figure written, or,
    where matplotlib is missing, one printed line that says so."""
    import importlib.util
    import math
    s = res["summary"]
    check(set(s) == SUMMARY_KEYS, f"{what}: the summary's keys {sorted(s)}")
    check(s["band_final_mean"] is not None
          and math.isfinite(s["band_final_mean"]),
          f"{what}: a finite band_final_mean, {s['band_final_mean']}")
    skipped = [ln for ln in res["lines"]
               if "matplotlib is not installed" in ln]
    if importlib.util.find_spec("matplotlib") is None:
        check(len(skipped) == 1, f"{what}: one line says the figure was "
                                 f"skipped, {skipped}")
    else:
        check(not skipped, f"{what}: matplotlib present, {skipped}")
    res["figure_skipped"] = skipped


def read_run(run_dir: str) -> tuple:
    import numpy as np
    with open(os.path.join(run_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with np.load(os.path.join(run_dir, "model.npz")) as z:
        params = {k: z[k] for k in z.files}
    return metrics, params


def serial_sweep_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 13, the serial sweeps: maml_trpo and maml_vision through
    ``sweep.main`` with every counter zeroed just before, each seed's rows,
    final params and final metric against a standalone trainer run of that
    seed, bit for bit; the sweep launched each kernel S times a standalone
    run's count."""
    import dataclasses
    import numpy as np
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig

    out = {}
    seeds = ",".join(str(s) for s in SWEEP_SEEDS)
    cases = {"maml_trpo": ("rl", {"algo": "trpo"}, RLScriptConfig(
                 num_iterations=SWEEP_ITERATIONS), "eval_reward"),
             "maml_vision": ("vision", {}, vision_config(
                 num_iterations=SWEEP_ITERATIONS), "test_acc")}
    for algo, (kind, kw, cfg, final_key) in cases.items():
        res = run_sweep(torch, gc, tc, [algo, "--seeds", seeds]
                        + sweep_flags(cfg), os.path.join(tmp, algo))
        check_summary(res, f"serial {algo}")
        check(res["counts"] == {"captures": 0, "replays": 0},
              f"serial {algo}: eager, {res['counts']}")
        solo_launches = {}
        for run in res["summary"]["runs"]:
            solo = counted_run(torch, gc, tc, kind, kw, dataclasses.replace(
                cfg, seed=run["seed"]), os.path.join(tmp, f"{algo}_solo"))
            (gm, gp), (wm, wp) = read_run(run["run_dir"]), (
                solo["metrics"], solo["params"])
            check(gm == wm, f"serial {algo} seed {run['seed']}: the rows of "
                            f"its standalone run")
            check(gp.keys() == wp.keys() and all(
                np.array_equal(gp[k], wp[k]) for k in gp),
                  f"serial {algo} seed {run['seed']}: the final params of "
                  f"its standalone run")
            for k, n in solo["launches"].items():
                solo_launches[k] = solo_launches.get(k, 0) + n
        check(res["launches"] == solo_launches,
              f"serial {algo}: each kernel as often as the standalone runs "
              f"together, {res['launches']} vs {solo_launches}")
        s = res["summary"]
        out[algo] = {"launches": res["launches"], "wall_s": res["wall_s"],
                     "finals": [r[final_key] for r in s["runs"]],
                     "band_final_mean": s["band_final_mean"],
                     "figure_skipped": res["figure_skipped"]}
        print(f"serial sweep {algo}, seeds {seeds} x {SWEEP_ITERATIONS} "
              f"iterations: every seed equal to its standalone run bit for "
              f"bit; {final_key} {out[algo]['finals']}, band "
              f"{s['band_metric']} final mean {s['band_final_mean']}; "
              f"launches {res['launches']} (the standalone runs' sum); "
              f"wall {res['wall_s']} s; figure: "
              f"{res['figure_skipped'] or 'written'} [{gpu}]", flush=True)
    return out


def multiseed_rl_scans(torch, cfg, algo: str, S: int, n_steps: int):
    """The seeded train scan of S seeds and the S solo scans, ``n_steps``
    iterations a chunk, built as the sweep and the trainer build them, at
    the seeds' initial states -> (seeded train, its state, the gens;
    [(solo train, its state, its gen)])."""
    from exploring_meta_tpu_torch.adapt.maml import adam
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.parallel.multiseed import stack_seed_states
    from exploring_meta_tpu_torch.rl import train_scan as ts
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.trainers.rl import (
        build_policy, rl_config, trpo_config,
    )
    from exploring_meta_tpu_torch.utils.tree import tree_map
    env = Particles2D()
    policy = build_policy(env, False, cfg.fc_neurons, cfg.activation)
    roll = make_rollout(env, policy.sample, cfg.adapt_batch_size,
                        cfg.max_path_length)
    F, mb, rc = n_steps, cfg.meta_batch_size, rl_config(cfg)
    lr = None if algo == "trpo" else cfg.outer_lr
    params, opt, gens = stack_seed_states(policy.init, range(S), "cuda",
                                          outer_lr=lr)
    if algo == "trpo":
        seeded = ts.make_seeded_trpo_train_scan(env, policy, roll, rc,
                                                trpo_config(cfg), mb, F, S)
        state = (params,)
    else:
        seeded = ts.make_seeded_adam_train_scan(env, policy, roll, rc, algo,
                                                mb, F, S)
        state = (params, opt)
    solos = []
    for s in range(S):
        gen = torch.Generator(device="cuda").manual_seed(s)
        p = policy.init(gen)
        if algo == "trpo":
            solos.append((ts.make_trpo_train_scan(
                env, policy, roll, rc, trpo_config(cfg), mb, F), (p,), gen))
        else:
            p = tree_map(torch.Tensor.requires_grad_, p)
            solos.append((ts.make_adam_train_scan(
                env, policy, roll, rc, algo, mb, F), (p, adam(p, lr)), gen))
    return seeded, state, gens, solos


def in_turns(torch, seeded, solos, work: int) -> dict:
    """Units of work a second (``work`` a chunk of the seeded scan, as
    many over the S solo chunks), one-program against serial, in
    MULTISEED_TURNS turns; every scan warmed up (captured) first."""
    from exploring_meta_tpu_torch.trainers.fused import fetch

    def one():
        train, state, gens = seeded
        fetch(train(*state, gens)[-1])

    def serial():
        for train, state, gen in solos:
            fetch(train(*state, gen)[-1])

    one()
    serial()
    rates = {"one_program": [], "serial": []}
    for _ in range(MULTISEED_TURNS):
        for name, fn in (("one_program", one), ("serial", serial)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates[name].append(work / (time.perf_counter() - t0))
    rates["speedup"] = max(rates["one_program"]) / max(rates["serial"])
    rates["one_program_chunk_s"] = work / max(rates["one_program"])
    return rates


def seeded_profile(torch, seeded, names: tuple, wall_s: float) -> dict:
    """One chunk of the seeded scan under the profiler: the kernels, and
    the idle share, 1 - their device timeline over ``wall_s``, the
    unprofiled chunk's wall (as phase 9 takes it)."""
    from exploring_meta_tpu_torch.trainers.fused import fetch
    train, state, gens = seeded
    prof = launch_profile(torch, lambda: fetch(train(*state, gens)[-1]),
                          MULTISEED_FUSE, names)
    prof["wall_us"] = 1e6 * wall_s
    prof["idle_share"] = 1 - prof["busy_union_us"] / prof["wall_us"]
    return prof


def rl_one_iteration(torch, cfg, algo: str, S: int) -> list:
    """One seeded iteration from the seeds' initial states against each
    seed's solo iteration -> per seed (L2 distance of the params over the
    solo step, the same line-search outcome)."""
    from exploring_meta_tpu_torch.trainers.fused import fetch
    from exploring_meta_tpu_torch.utils.tree import tree_leaves
    seeded, state, gens, solos = multiseed_rl_scans(torch, cfg, algo, S, 1)
    init = [[t.detach().clone() for t in tree_leaves(st[0])]
            for _, st, _ in solos]
    ms = fetch(seeded(*state, gens)[-1])
    out = []
    for i, (train, st, gen) in enumerate(solos):
        m1 = fetch(train(*st, gen)[-1])
        got = [t[i].detach() for t in tree_leaves(state[0])]
        want = [t.detach() for t in tree_leaves(st[0])]
        l2 = lambda a, b: sum(float((x - y).norm()) ** 2
                              for x, y in zip(a, b)) ** 0.5
        same = (algo != "trpo"
                or float(ms["ls_accepted"][0][i]) == float(
                    m1["ls_accepted"][0]))
        out.append((l2(got, want) / l2(want, init[i]), same))
    return out


def multiseed_rl_case(torch, gc, tc, gpu, tmp, name: str, algo: str,
                      cfg, S: int) -> dict:
    """One one-program RL sweep through ``sweep.main --vmap_seeds`` with the
    counters zeroed just before, against each seed's solo trainer run at
    the same --fuse; one seeded iteration from the initial states against
    the solo ones; then its scans timed in turns and profiled."""
    import dataclasses
    import math
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.trainers.rl import build_policy
    from exploring_meta_tpu_torch.utils.tree import tree_items

    seeds = ",".join(str(s) for s in range(S))
    res = run_sweep(torch, gc, tc, [f"maml_{algo}", "--seeds", seeds,
                                    "--vmap_seeds"] + sweep_flags(cfg),
                    os.path.join(tmp, name))
    check_summary(res, name)
    check(res["counts"] == {"captures": 1,
                            "replays": MULTISEED_ITERATIONS - 1},
          f"{name}: one capture for all seeds, {res['counts']}")
    ends, solo0 = [], None
    for run in res["summary"]["runs"]:
        s = run["seed"]
        solo = counted_run(torch, gc, tc, "rl", {"algo": algo},
                           dataclasses.replace(cfg, seed=s),
                           os.path.join(tmp, f"{name}_solo"))
        solo0 = solo0 or solo
        metrics, params = read_run(run["run_dir"])
        check(len(metrics["meta_loss"]) == MULTISEED_ITERATIONS and all(
            math.isfinite(v) for k, vals in metrics.items() for v in vals),
              f"{name} seed {s}: {MULTISEED_ITERATIONS} finite rows")
        # the first row: the rollouts of the initial params
        for k in ("adapt_reward", "adapt_success"):
            a, b = metrics[k][0], solo["metrics"][k][0]
            check(abs(a - b) <= MULTISEED_ROW_TOL * max(abs(b), 1.0),
                  f"{name} seed {s}: first {k} {a} vs its solo run's {b}")
        got = {k: torch.from_numpy(v) for k, v in params.items()}
        want = {k: torch.from_numpy(v) for k, v in solo["params"].items()}
        if algo == "trpo":
            init = {k: v.cpu() for k, v in tree_items(build_policy(
                Particles2D(), False, cfg.fc_neurons, cfg.activation).init(
                    torch.Generator(device="cuda").manual_seed(s)))}
            l2 = lambda a, b: sum(float((a[k] - b[k]).norm()) ** 2
                                  for k in b) ** 0.5
            ends.append(l2(got, want) / l2(want, init))
        else:
            ends.append(tree_close(torch, got, want, MULTISEED_ADAM_TOL,
                                   f"{name} seed {s} vs its solo run"))
    one = []
    if algo == "trpo":
        one = rl_one_iteration(torch, cfg, algo, S)
        for s, (err, same) in enumerate(one):
            check(same and err <= BASELINE_TRPO_TOL,
                  f"{name} seed {s}: one seeded iteration {err} of the "
                  f"step from its solo one (the same line-search outcome: "
                  f"{same}), limit {BASELINE_TRPO_TOL}")
    # per seeded iteration each kernel as a solo iteration: the warm-up's
    # launches and the graph's; the meta-tests, one a seed, apart
    per_iteration = solo0["captured"]
    meta_test = {k: solo0["launches"][k] - per_iteration[k]
                 for k in per_iteration}
    for k in gc.KERNELS:
        check(res["captured"][k] == per_iteration[k] > 0
              and res["launches"][k] == per_iteration[k] + S * meta_test[k],
              f"{name}: {k} recorded {res['captured'][k]} (one seed's "
              f"iteration {per_iteration[k]}), launched {res['launches'][k]}"
              f" (the warm-up and {S} meta-tests of {meta_test[k]})")

    seeded_train, state, gens, solos = multiseed_rl_scans(
        torch, cfg, algo, S, MULTISEED_FUSE)
    rates = in_turns(torch, (seeded_train, state, gens), solos,
                     S * MULTISEED_FUSE)
    prof = seeded_profile(torch, (seeded_train, state, gens),
                          tuple(KERNEL_NAMES.values()),
                          rates["one_program_chunk_s"])
    for n in KERNEL_NAMES.values():
        check(prof["named_kernels"][n] > 0,
              f"{name}: {n} ran inside the seeded replays")
    unit = "of the step" if algo == "trpo" else "of max|params|"
    print(f"{name} (--vmap_seeds, S = {S}, {MULTISEED_ITERATIONS} iterations "
          f"at --fuse {MULTISEED_FUSE}): {res['counts']}; per seeded "
          f"iteration {per_iteration} recorded, one seed's; launched "
          f"{res['launches']} with {S} meta-tests; first rows as the solo "
          f"runs'; one iteration from the initial states "
          f"{[e for e, _ in one] or 'not run'} {unit}; after "
          f"{MULTISEED_ITERATIONS} iterations each seed vs its solo run "
          f"{ends} {unit}; seed-iterations/s one program "
          f"{rates['one_program']}, serial replays {rates['serial']} "
          f"({rates['speedup']}x); idle {100 * prof['idle_share']:.1f} % of "
          f"a seeded chunk ({prof['busy_union_us']} us busy of "
          f"{prof['wall_us']}), kernels a seeded iteration "
          f"{prof['kernel_launches'] / MULTISEED_FUSE}; sweep wall "
          f"{res['wall_s']} s [{gpu}]", flush=True)
    del seeded_train, state, gens, solos
    return {"counts": res["counts"], "launches": res["launches"],
            "captured": res["captured"], "per_iteration": per_iteration,
            "one_iteration_vs_solo": [e for e, _ in one],
            "end_vs_solo": ends, "seed_iterations_per_s": rates,
            "profile": prof, "wall_s": res["wall_s"],
            "finals": [r["eval_reward"] for r in res["summary"]["runs"]]}


def seeded_cnn4_kernels(tc, F, torch, gpu, b: int) -> dict:
    """The three CNN4 kernels at the one-program vision sweep's B = S x 32
    tasks, N = 25 (a support or query set of 5-way 5-shot), held against
    their twins at each block shape in f32 and bf16 (TOL, DB_TOL) and
    timed in f32 (CUDA events): kernel, twin, library."""
    n, co = WAYS * SHOTS, HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0} for k in tc.KERNELS}
    out["cnn4_block_bwd_params"]["library_ms"] = None
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for blk, (h, ci) in enumerate(BLOCKS):
            x, w, bb, sc, be, g = block_inputs(torch, tc, gen, b, n, h, ci, dt)
            what = f"B {b} block {blk + 1}"
            r = out["cnn4_block_fwd"]
            r["max_abs_err"] = max(r["max_abs_err"], held(
                torch, tc.block_fwd(x, w, bb, sc, be),
                tc.block_fwd_plain(x, w, bb, sc, be), dname, what))
            got = tc.block_bwd_params(x, w, bb, sc, be, g)
            want = tc.block_bwd_params_plain(x, w, bb, sc, be, g)
            dy_abs = want[0].abs().sum(dim=(1, 2, 3))
            r = out["cnn4_block_bwd_params"]
            r["max_abs_err"] = max(r["max_abs_err"], *(
                held(torch, got[i], want[i], dname, f"{what} output {i}",
                     db=dy_abs + 1e-30 if i == 2 else None)
                for i in range(5)))
            dy = got[0]
            r = out["cnn4_block_bwd_input"]
            r["max_abs_err"] = max(r["max_abs_err"], held(
                torch, tc.block_bwd_input(dy, w, h, h),
                tc.block_bwd_input_plain(dy, w, h, h), dname, what))
            if dt != torch.float32:
                continue
            xg = x.permute(1, 0, 4, 2, 3).reshape(n, b * ci, h, h).contiguous()
            wg = w.permute(0, 4, 3, 1, 2).reshape(b * co, ci, 3, 3).contiguous()
            ho = (h - 1) // 2 + 1
            dyg = dy.permute(1, 0, 4, 2, 3).reshape(n, b * co, ho,
                                                    ho).contiguous()
            runs = {
                "cnn4_block_fwd": (
                    lambda: tc.block_fwd(x, w, bb, sc, be),
                    lambda: tc.block_fwd_plain(x, w, bb, sc, be),
                    lambda: torch.relu(F.batch_norm(
                        F.conv2d(xg, wg, bb.reshape(-1), stride=2, padding=1,
                                 groups=b), None, None, sc.reshape(-1),
                        be.reshape(-1), training=True, eps=tc.EPS))),
                "cnn4_block_bwd_params": (
                    lambda: tc.block_bwd_params(x, w, bb, sc, be, g),
                    lambda: tc.block_bwd_params_plain(x, w, bb, sc, be, g),
                    None),
                "cnn4_block_bwd_input": (
                    lambda: tc.block_bwd_input(dy, w, h, h),
                    lambda: tc.block_bwd_input_plain(dy, w, h, h),
                    lambda: torch.nn.grad.conv2d_input(
                        xg.shape, wg, dyg, stride=2, padding=1, groups=b)),
            }
            for name, (kern, plain, lib) in runs.items():
                if name == "cnn4_block_bwd_input" and blk == 0:
                    continue            # block 1 takes no dx on the path
                r = out[name]
                r["ms"] += time_ms(kern)
                r["plain_ms"] += time_ms(plain)
                if lib:
                    r["library_ms"] += time_ms(lib)
                r["bound_ms"] += max(bound(name, b, n, h, ci, co, 4))
            torch.cuda.synchronize()
    for name, r in out.items():
        print(f"  {name} at B = {b}, N = {n}, the path's blocks: ms {r['ms']} "
              f"plain_ms {r['plain_ms']} library_ms {r['library_ms']} "
              f"bound_ms {r['bound_ms']} max_abs_err {r['max_abs_err']} "
              f"[{gpu}]", flush=True)
    return out


def vision_one_iteration(torch, spec, cfg, sampler, S: int) -> list:
    """One f32 seeded meta-iteration (valid pass and meta-step) from the
    seeds' initial states against each seed's solo one -> per seed (the
    largest relative row difference, the meta-gradient's largest |error|
    over max|grad|, the params past VISION_TOL of max|params|, their
    count), the conv biases aside."""
    from exploring_meta_tpu_torch.adapt.maml import adam, make_train_scan
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4
    from exploring_meta_tpu_torch.parallel.multiseed import stack_seed_states
    from exploring_meta_tpu_torch.trainers.fused import fetch
    from exploring_meta_tpu_torch.utils.tree import tree_items, tree_map

    def scan(seeds):
        return make_train_scan(
            make_vision_fast_adapt(spec, cfg.inner_lr, cfg.adapt_steps,
                                   cfg.shots, cfg.ways, seeds=seeds),
            sampler("train"), 1, eval_sample_fn=sampler("valid"),
            seeds=seeds)

    params, opt, gens = stack_seed_states(
        lambda g: init_cnn4(g, spec, device="cuda"), range(S), "cuda",
        outer_lr=cfg.outer_lr)
    ms = fetch(scan(S)(params, opt, gens)[-1])
    out = []
    for s in range(S):
        gen = torch.Generator(device="cuda").manual_seed(s)
        p = tree_map(torch.Tensor.requires_grad_,
                     init_cnn4(gen, spec, device="cuda"))
        m1 = fetch(scan(None)(p, adam(p, cfg.outer_lr), gen)[-1])
        rows = max(abs(float(ms[k][0][s]) - float(m1[k][0]))
                   / max(abs(float(m1[k][0])), 1.0) for k in m1)
        keep = [k for k, _ in tree_items(p) if not k.endswith("conv/b")]
        got, want = dict(tree_items(params)), dict(tree_items(p))
        gmax = max(float(want[k].grad.abs().max()) for k in keep)
        grad = max(float((got[k].grad[s] - want[k].grad).abs().max())
                   for k in keep) / gmax
        top = max(float(want[k].detach().abs().max()) for k in keep)
        diff = torch.cat([(got[k][s] - want[k]).detach().abs().reshape(-1)
                          for k in keep])
        out.append((rows, grad, int((diff > VISION_TOL * top).sum()),
                    diff.numel()))
    return out


def multiseed_vision_case(torch, tc, F, gc, gpu, tmp, S: int) -> dict:
    """The one-program maml_omni sweep (S seeds, B = S x 32 tasks) through
    ``sweep.main --vmap_seeds`` with the counters zeroed just before; each
    seed's first row against its solo scan's on the sweep's dataset, one
    f32 seeded iteration against the solo ones; the CNN4 kernels at B = S x
    32 against their twins; tasks/s in turns and the idle share."""
    import math
    from exploring_meta_tpu_torch.adapt.maml import (
        adam, cast_compute, make_train_scan,
    )
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.parallel.multiseed import stack_seed_states
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    from exploring_meta_tpu_torch.trainers.fused import fetch
    from exploring_meta_tpu_torch.utils.tree import tree_map

    cfg = vision_config(num_iterations=MULTISEED_ITERATIONS,
                        fuse=MULTISEED_FUSE)
    name = "multiseed_omniglot"
    res = run_sweep(torch, gc, tc, ["maml_vision", "--seeds", ",".join(
        str(s) for s in range(S)), "--vmap_seeds"] + sweep_flags(cfg),
                    os.path.join(tmp, name))
    check_summary(res, name)
    check(res["counts"] == {"captures": 1,
                            "replays": MULTISEED_ITERATIONS - 1},
          f"{name}: one capture for all seeds, {res['counts']}")
    # one seed's iteration: the valid pass and the meta-step; the
    # meta-test once, for all seeds at once (a solo run's: once)
    per_iteration = {k: META_STEP_CALLS[k] + META_EVAL_CALLS[k]
                     for k in tc.KERNELS}
    for k in tc.KERNELS:
        check(res["captured"][k] == per_iteration[k]
              and res["launches"][k] == per_iteration[k]
              + META_EVAL_CALLS[k],
              f"{name}: {k} recorded {res['captured'][k]}, launched "
              f"{res['launches'][k]}: one seed's iteration "
              f"{per_iteration[k]} and one meta-test")

    # the sweep's dataset, sampled again with its seed
    datasets = dict(zip(("train", "valid"), get_dataset(
        "omni", seed=cfg.seed, synthetic=True,
        synth_classes=cfg.synth_classes, synth_per_class=cfg.synth_per_class,
        device="cuda")[:2]))
    spec = omniglot_spec(cfg.ways)

    def sampler(split):
        return lambda g: sample_task_batch(g, datasets[split], cfg.ways,
                                           cfg.shots, cfg.meta_batch_size)

    def scan(seeds):
        fa = cast_compute(make_vision_fast_adapt(
            spec, cfg.inner_lr, cfg.adapt_steps, cfg.shots, cfg.ways,
            seeds=seeds))
        return make_train_scan(fa, sampler("train"), MULTISEED_FUSE,
                               eval_sample_fn=sampler("valid"), seeds=seeds)

    solos, first, later = [], 0.0, 0.0
    names = {"loss": "train_loss", "metric": "train_acc",
             "valid_loss": "valid_loss", "valid_metric": "valid_acc"}
    for run in res["summary"]["runs"]:
        s = run["seed"]
        gen = torch.Generator(device="cuda").manual_seed(s)
        p = tree_map(torch.Tensor.requires_grad_,
                     init_cnn4(gen, spec, device="cuda"))
        solo = (scan(None), (p, adam(p, cfg.outer_lr)), gen)
        rows = fetch(solo[0](*solo[1], gen)[-1])
        solos.append(solo)
        metrics, _ = read_run(run["run_dir"])
        for k, key in names.items():
            got = metrics[key]
            check(len(got) == MULTISEED_ITERATIONS
                  and all(math.isfinite(v) for v in got),
                  f"{name} seed {s}: finite {key}")
            err = abs(got[0] - float(rows[k][0]))
            check(err <= MULTISEED_VISION_TOL,
                  f"{name} seed {s}: first {key} {got[0]} vs its solo "
                  f"scan's {float(rows[k][0])}")
            first = max(first, err)
            later = max(later, max(abs(a - float(b)) for a, b in
                                   zip(got[1:], rows[k][1:])))
    one = vision_one_iteration(torch, spec, cfg, sampler, S)
    for s, (rows, grad, flips, n) in enumerate(one):
        check(rows <= MULTISEED_ROW_TOL and grad <= SO_FLIP_TOL
              and flips <= VISION_FLIP_SHARE * n,
              f"{name} f32 seed {s}: one seeded iteration against its solo "
              f"one: rows {rows} (limit {MULTISEED_ROW_TOL}), meta-gradient "
              f"{grad} of max|grad| (limit {SO_FLIP_TOL}), {flips} of {n} "
              f"params past {VISION_TOL} of max|params| (limit "
              f"{VISION_FLIP_SHARE})")
    kernels = seeded_cnn4_kernels(tc, F, torch, gpu, S * cfg.meta_batch_size)
    params, opt, gens = stack_seed_states(
        lambda g: init_cnn4(g, spec, device="cuda"), range(S), "cuda",
        outer_lr=cfg.outer_lr)
    seeded = (scan(S), (params, opt), gens)
    rates = in_turns(torch, seeded, solos,
                     S * MULTISEED_FUSE * cfg.meta_batch_size)
    prof = seeded_profile(torch, seeded, CNN4_KERNEL_NAMES,
                          rates["one_program_chunk_s"])
    for n in ("fwd_conv_stats_kernel", "bwd_dw_kernel", "bwd_input_kernel"):
        check(prof["named_kernels"][n] > 0,
              f"{name}: {n} ran inside the seeded replays")
    print(f"{name} (--vmap_seeds, S = {S}, meta-batch {cfg.meta_batch_size}"
          f", bf16: the CNN4 kernels at B = {S * cfg.meta_batch_size}; "
          f"{MULTISEED_ITERATIONS} iterations at --fuse {MULTISEED_FUSE}): "
          f"{res['counts']}; recorded {res['captured']}, launched "
          f"{res['launches']}; first rows vs the solo scans' max |err| "
          f"{first}, later rows {later}; one f32 iteration from the initial "
          f"states (rows, meta-gradient, params past {VISION_TOL}, of) "
          f"{one}; tasks/s one program {rates['one_program']}, serial "
          f"replays {rates['serial']} ({rates['speedup']}x); idle "
          f"{100 * prof['idle_share']:.1f} % of a seeded chunk "
          f"({prof['busy_union_us']} us busy of {prof['wall_us']}); sweep "
          f"wall {res['wall_s']} s [{gpu}]", flush=True)
    del seeded, solos, params, opt, gens
    return {"counts": res["counts"], "launches": res["launches"],
            "captured": res["captured"], "first_rows_vs_solo": first,
            "later_rows_vs_solo": later, "one_iteration_f32": one,
            "tasks_per_s": rates, "profile": prof, "kernels": kernels,
            "wall_s": res["wall_s"],
            "finals": [r["test_acc"] for r in res["summary"]["runs"]]}


def seed_sweep_phase(tc, gc, F, torch, gpu, tmp) -> dict:
    """Phase 13: seed sweeps (slice 12), serial and one-program."""
    import dataclasses
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig

    start = time.perf_counter()
    out = {"serial": serial_sweep_phase(torch, gc, tc, gpu, tmp)}
    cases = {
        "multiseed_trpo": ("trpo", RLScriptConfig(**MULTISEED_TRPO), 4),
        "multiseed_trpo_defaults": ("trpo", RLScriptConfig(), 2),
        "multiseed_ppo": ("ppo", RLScriptConfig(outer_lr=0.01), 2)}
    for name, (algo, cfg, S) in cases.items():
        cfg = dataclasses.replace(cfg, num_iterations=MULTISEED_ITERATIONS,
                                  fuse=MULTISEED_FUSE)
        out[name] = multiseed_rl_case(torch, gc, tc, gpu, tmp, name, algo,
                                      cfg, S)
    out["multiseed_omniglot"] = multiseed_vision_case(torch, tc, F, gc, gpu,
                                                      tmp, 4)
    launches: dict = {}
    for paths in (*(r["launches"] for r in out["serial"].values()),
                  *(out[k]["launches"] for k in cases),
                  out["multiseed_omniglot"]["launches"]):
        for k, n in paths.items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - start
    print(f"phase 13 (seed sweeps): {out['wall_s']:.2f} s [{gpu}]",
          flush=True)
    return out


# Phase 14 (slice 13): host envs. Meta-World runs on the repo's point-mass
# stand-in (tests/fake_metaworld.py, JAX's own ML10 test fixture): the
# card's machine has neither metaworld nor gymnasium and mujoco.
HOST_ITERATIONS = 2
# the phase's host paths run with the process pinned to HOST_CPUS CPUs
# (os.sched_setaffinity), so that every pool counts that many workers: the
# stand-in env holds the GIL through its step, and 8 pool threads step it
# several times slower than 2 (PERF.md); the pool is also measured
# unpinned
HOST_CPUS = 2
# the trainers' final meta-tests, cut from the default 10 tasks (depth)
HOST_EVAL_TASKS = 2
NATIVE_STEPS, NATIVE_TOL = 100, 1e-6
POOL_SLOTS, POOL_STEPS = 400, 20
ADAM_STEP_TOL = 1e-5    # of lr: one Adam step on the same gradients
DEVICES = (("card", "cuda"), ("cpu", "cpu"))


@contextlib.contextmanager
def pinned_cpus(n: int):
    """The process (its calling thread, and the threads it starts) on the
    first ``n`` CPUs of its affinity mask, restored on exit."""
    mask = os.sched_getaffinity(0)
    os.sched_setaffinity(0, sorted(mask)[:n])
    try:
        yield
    finally:
        os.sched_setaffinity(0, mask)


def installed_fake_metaworld(repo: str):
    """``tests/fake_metaworld.py`` as the ``metaworld`` package, as JAX's
    ``fake_metaworld`` fixture installs it -> a function that removes it."""
    sys.path.insert(0, os.path.join(repo, "tests"))
    import fake_metaworld
    had = sys.modules.get("metaworld")
    sys.modules["metaworld"] = fake_metaworld

    def remove():
        sys.path.remove(os.path.join(repo, "tests"))
        if had is None:
            del sys.modules["metaworld"]
        else:
            sys.modules["metaworld"] = had
    return remove


def native_particles_vs_device(torch, np, binding) -> dict:
    """``NativeVecEnv("particles2d")`` against the port's device Particles2D
    on the card, 20 goals one episode each, the same actions (uniform in
    +-0.15: the clip at 0.1 acts) for NATIVE_STEPS steps."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    env, E = Particles2D(), 20
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    tasks = env.sample_tasks(gen, E)
    actions = 0.3 * torch.rand((NATIVE_STEPS, E, 1, 2), generator=gen,
                               device="cuda") - 0.15
    state, _ = env.reset(tasks, 1)
    nat = binding.NativeVecEnv("particles2d", n_envs=E)
    nat.reset(tasks.double().cpu().numpy())
    worst, dones = 0.0, 0
    for t in range(NATIVE_STEPS):
        state, obs, _, done, _ = env.step(state, actions[t], tasks)
        nobs, _, ndone, _ = nat.step(actions[t, :, 0].double().cpu().numpy())
        worst = max(worst, float(np.abs(obs[:, 0].double().cpu().numpy()
                                        - nobs).max()))
        check(np.array_equal(done[:, 0].cpu().numpy(), ndone > 0.5),
              f"native particles2d done equals the device env's, step {t}")
        dones = int((ndone > 0.5).sum())
    check(worst <= NATIVE_TOL, f"native particles2d obs vs the device env: "
                               f"{worst}, limit {NATIVE_TOL}")
    return {"obs_max_abs_err": worst, "done_at_end": dones}


class HostCounted:
    """Per-iteration wall time, sweep launches and collection counts of a
    trainer's host iteration (``make`` the name of its factory method)."""

    def __init__(self, torch, gc, host):
        self.torch, self.gc, self.host, self.rows = torch, gc, host, []

    def wrap(self, step):
        def counted(*args):
            self.torch.cuda.synchronize()
            before = {**self.gc.launch_counts(), **self.host.COUNTS}
            t0 = time.perf_counter()
            out = step(*args)
            self.torch.cuda.synchronize()
            after = {**self.gc.launch_counts(), **self.host.COUNTS}
            self.rows.append({"s": time.perf_counter() - t0,
                              **{k: after[k] - before[k] for k in after}})
            return out
        return counted

    def trainer(self, base, make: str):
        wrap = self.wrap

        class Trainer(base):
            pass
        setattr(Trainer, make, lambda tr, *a: wrap(getattr(base, make)(
            tr, *a)))
        return Trainer


def counted_call(torch, gc, host, fn) -> tuple:
    """``fn()`` with the sweep and collection counters zeroed just before
    -> (its result, the launches, the collection counts, seconds)."""
    torch.cuda.synchronize()
    gc.reset_launch_counts()
    host.reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, gc.launch_counts(), dict(host.COUNTS),
            time.perf_counter() - t0)


@contextlib.contextmanager
def recording_outer_steps(recorded: dict):
    """Keep the inputs of the trainers' last outer step: ``recorded
    ["trpo"] = (params, old params, replays)`` of a TRPO meta-step and
    ``recorded["ppo"] = (params, replays)`` of a replay meta-loss (params
    copied before the step moves them)."""
    from exploring_meta_tpu_torch.trainers import rl as trl
    from exploring_meta_tpu_torch.utils.tree import tree_map
    trpo, loss = trl.make_trpo_meta_step, trl.make_replay_meta_loss
    copy = lambda p: tree_map(lambda t: t.detach().clone(), p)

    def make_trpo(*args, **kwargs):
        step = trpo(*args, **kwargs)

        def recorded_step(params, old, replays):
            recorded["trpo"] = (copy(params), old, replays)
            return step(params, old, replays)
        return recorded_step

    def make_loss(*args, **kwargs):
        meta_loss = loss(*args, **kwargs)

        def recorded_loss(params, replays):
            recorded["ppo"] = (copy(params), replays)
            return meta_loss(params, replays)
        return recorded_loss

    trl.make_trpo_meta_step, trl.make_replay_meta_loss = make_trpo, make_loss
    try:
        yield recorded
    finally:
        trl.make_trpo_meta_step, trl.make_replay_meta_loss = trpo, loss


def host_trainer_run(torch, gc, host, tmp, algo: str, make: str,
                     **change) -> dict:
    """One RLTrainer run on ML10, HOST_ITERATIONS iterations at the
    RLScriptConfig defaults, with ``change`` -> its run dir, launches (all,
    per iteration, the meta-test's), collection counts and seconds."""
    import math
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    counter = HostCounted(torch, gc, host)
    cfg = RLScriptConfig(**{"env": "ML10", "num_iterations": HOST_ITERATIONS,
                            **change})
    trainer = counter.trainer(RLTrainer, make)(cfg, algo=algo,
                                               path=tmp + "/")
    final, launches, counts, s = counted_call(torch, gc, host, trainer.run)
    with open(os.path.join(trainer.model_path, "metrics.json")) as f:
        metrics = json.load(f)
    check(len(counter.rows) == cfg.num_iterations
          and all(all(math.isfinite(v) for v in vals)
                  for vals in metrics.values()),
          f"{algo} {change}: {cfg.num_iterations} finite rows: {metrics}")
    check(math.isfinite(final["mean_reward"]), f"{algo}: finite meta-test")
    for i, row in enumerate(counter.rows):
        for name in gc.KERNELS:
            check(row[name] > 0, f"{algo} {change}: {name} in iteration {i}")
    return {"run": trainer.model_path, "launches": launches,
            "per_iteration": counter.rows, "s": s, "counts": counts,
            "meta_test": final["mean_reward"],
            "meta_test_launches": {k: launches[k] - sum(
                r[k] for r in counter.rows) for k in launches}}


def host_eval_paths(torch, np, gc, host, ppo_run: str, trpo_run: str,
                    gpu) -> dict:
    """``meta_test`` with ``each3`` (per task) on the maml_trpo run's
    params, and ``eval_rl.run(each3, task_batch, cl, rc)`` on the
    maml_ppo run dir: both sweeps launched on each; the per-task JSON keyed
    by ML10's eval names; the bar plots written, or one printed line each
    where matplotlib is missing."""
    import io
    import math
    from exploring_meta_tpu_torch.analysis import eval_rl
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.evaluate import (
        ML10_EVAL_TASK_NAMES, meta_test,
    )
    from exploring_meta_tpu_torch.trainers.rl import rl_config
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.experiment import load_params

    out = {}
    policy = DiagNormalPolicy(9, 4)
    params = load_params(os.path.join(trpo_run, "model.npz"), policy.init(
        torch.Generator(device="cuda").manual_seed(0)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    cfg = RLScriptConfig(env="ML10")
    res, launches, counts, s = counted_call(
        torch, gc, host, lambda: meta_test(
            "trpo", "ML10", policy, params, rl_config(cfg), cfg.n_eval_tasks,
            gen, each3=True))
    names = set(ML10_EVAL_TASK_NAMES.values())
    check(set(res["rewards_per_task"]) == names
          and len(res["tasks_rewards"]) == 15
          and all(math.isfinite(r) for r in res["tasks_rewards"]),
          f"meta_test each3: 3 trials of each ML10 eval task: {res}")
    out["meta_test_each3"] = {"launches": launches, "counts": counts, "s": s,
                              "mean_reward": res["mean_reward"]}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, launches, counts, s = counted_call(
            torch, gc, host, lambda: eval_rl.run(
                ppo_run, run_cl=True, run_rc=True, each3=True,
                task_batch=True))
    printed = buf.getvalue()
    print(printed, end="")
    stem = os.path.join(ppo_run, "maml_ppo_test_42")
    with open(stem + ".json") as f:
        per_task = json.load(f)
    check(set(per_task) == names and per_task == res["eval"][
        "rewards_per_task"], f"eval_rl per-task JSON keyed by ML10's eval "
                             f"names: {per_task}")
    missing = printed.count("matplotlib is not installed")
    plots = {"bar_plot_ml10": os.path.exists(stem + ".png")}
    check(plots["bar_plot_ml10"] or printed.count(
        "bar_plot_ml10: matplotlib is not installed") == 1,
        "the ML10 bar plot is written, or one line says why not")
    for part in ("cl_exp/adapt_progress.json", "cl_exp/cl_res_rew.json",
                 "rep_exp/cca_rl_results.json", "eval_results.json"):
        check(os.path.exists(os.path.join(ppo_run, part)), f"eval_rl {part}")
    for name in gc.KERNELS:
        check(out["meta_test_each3"]["launches"][name] > 0
              and launches[name] > 0, f"{name} ran in meta_test and eval_rl")
    out["eval_rl"] = {"launches": launches, "counts": counts, "s": s,
                      "mean_reward": res["eval"]["mean_reward"],
                      "cl_res_rew": res["cl_res_rew"],
                      "matplotlib_missing_lines": missing, "plots": plots}
    print(f"host eval paths: {out} [{gpu}]", flush=True)
    return out


def host_card_vs_cpu(torch, np, host, gpu, recorded: dict) -> dict:
    """Card against CPU: ``HostVecEnv.collect`` under a fixed action table
    on either device, bit for bit; then, on the card's own replays that
    the trainer runs recorded (``recorded``: maml_trpo's last outer step,
    per task at full width; maml_ppo's last ``--task_batch`` meta-loss),
    one first-order TRPO inner step (within ADAPT_TOL of max|params|), one
    TRPO outer step (the same line-search outcome, within 2e-2 of the
    step), a PPO replay meta-gradient (:func:`ppo_replay_card_vs_cpu`) and
    one Adam step on the card's gradient (within ADAM_STEP_TOL of lr); the
    CPU runs on the card's baseline fits."""
    from exploring_meta_tpu_torch.adapt.maml import adam, per_task
    from exploring_meta_tpu_torch.envs.factory import make_env
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import trpo_update
    from exploring_meta_tpu_torch.rl.replay_meta import make_replay_meta_loss
    from exploring_meta_tpu_torch.rl.trpo_meta import meta_optimize_trpo
    from exploring_meta_tpu_torch.trainers.rl import rl_config, trpo_config
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    from exploring_meta_tpu_torch.utils.tree import (
        tree_items, tree_leaves, tree_map,
    )

    cfg = RLScriptConfig(env="ML10")
    rl_cfg, trpo_cfg = rl_config(cfg), trpo_config(cfg)
    T, E = cfg.max_path_length, cfg.adapt_batch_size
    out = {}
    table = np.random.default_rng(SEED + 16).uniform(
        -1.5, 1.5, (T, E, 4)).astype(np.float32)
    trajs = {}
    for key, dev in DEVICES:
        vec, _ = make_env("ML10", workers=E, seed=cfg.seed,
                          max_path_length=T, n_threads=HOST_CPUS)
        vec.set_task(vec.sample_tasks(None, 1)[0])
        steps = iter(range(T))
        trajs[key] = vec.collect(lambda g, o: table[next(steps)], None, T,
                                 device=dev)
    check(trajs["card"].reward.device.type == "cuda"
          and all(torch.equal(a.cpu(), b) for a, b in zip(trajs["card"],
                                                         trajs["cpu"])),
          "HostVecEnv.collect: card and CPU trajectories bit for bit")

    policy = DiagNormalPolicy(9, 4)
    params, old, replays = recorded["trpo"]
    params = tree_map(lambda t: t.cpu(), params)
    support = replays.map(lambda x: x[:, 0])
    inner = {}
    fits = None
    for key, dev in DEVICES:
        p = per_task(tree_map(lambda t: t.to(dev), params),
                     cfg.meta_batch_size)
        inner[key], fits = with_baseline_fits(
            lambda: trpo_update(policy, p, support.map(lambda x: x.to(dev)),
                                rl_cfg, first_order=True), fits)
    out["inner_step_err"] = tree_close(torch, inner["card"], inner["cpu"],
                                       ADAPT_TOL, "host TRPO inner step")
    steps_out, fits = {}, None
    for key, dev in DEVICES:
        to = lambda x: tree_map(lambda t: t.to(dev), x)
        (new, info), fits = with_baseline_fits(
            lambda: meta_optimize_trpo(
                policy, to(params), to(old), replays.map(lambda x: x.to(dev)),
                rl_cfg, trpo_cfg, cfg.adapt_steps), fits)
        steps_out[key] = (torch.cat([t.reshape(-1).cpu()
                                     for t in tree_leaves(new)]),
                          bool(info["accepted"]), int(info["index"]))
    flat0 = torch.cat([t.reshape(-1) for t in tree_leaves(params)])
    step = float((steps_out["cpu"][0] - flat0).norm())
    err = float((steps_out["card"][0] - steps_out["cpu"][0]).norm())
    check(steps_out["card"][1:] == steps_out["cpu"][1:],
          f"host TRPO outer step: the same line-search outcome "
          f"{steps_out['card'][1:]} vs {steps_out['cpu'][1:]}")
    check(err <= 2e-2 * step, f"host TRPO outer step: |card - CPU| {err} "
                              f"vs step {step}")
    out["trpo_step"] = {"param_err_l2": err, "step_norm": step,
                        "accepted_index": steps_out["cpu"][2]}

    ppo_params, ppo_replays = recorded["ppo"]
    ppo_params = tree_map(lambda t: t.cpu(), ppo_params)
    meta_loss = make_replay_meta_loss("ppo", policy, rl_cfg)
    out["ppo_meta_grad"] = ppo_replay_card_vs_cpu(
        torch, meta_loss, ppo_params, ppo_replays, rl_cfg.ppo_clip_ratio)
    _, grads, _ = replay_meta_grad(torch, meta_loss, ppo_params, ppo_replays,
                                   "cuda")
    lr, stepped = 0.01, {}
    for key, dev in DEVICES:
        p = tree_map(lambda t: t.detach().to(dev, copy=True)
                     .requires_grad_(), ppo_params)
        opt = adam(p, lr)
        for leaf_key, leaf in tree_items(p):
            leaf.grad = grads[leaf_key].float().to(dev)
        opt.step()
        stepped[key] = [t.detach().cpu().double() for t in tree_leaves(p)]
    out["adam_step_err_lr"] = max(
        float((a - b).abs().max()) for a, b in zip(stepped["card"],
                                                   stepped["cpu"])) / lr
    check(out["adam_step_err_lr"] <= ADAM_STEP_TOL,
          f"one Adam step on the card's meta-gradient, card vs CPU: "
          f"{out['adam_step_err_lr']} of lr")
    print(f"host envs, card vs CPU: {out} [{gpu}]", flush=True)
    return out


def host_timing(torch, np, gc, host, binding, tmp, gpu,
                per_task: list) -> dict:
    """s per maml_trpo iteration on ML10 at the defaults with
    ``--task_batch``, against the maml_trpo trainer's per-task iterations
    of the same call (``per_task``), with the policy round trips and
    shipments of each, and one more batched iteration profiled (idle
    share), pinned to HOST_CPUS CPUs; the pool's
    env steps/s at POOL_SLOTS slots (fake ML10) on all the process's CPUs
    and on HOST_CPUS, against the Python loop, and native Particles2D's."""
    from exploring_meta_tpu_torch.envs.factory import make_env
    from exploring_meta_tpu_torch.trainers.rl import (
        RLTrainer, build_policy, rl_config,
    )
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig

    cfg = RLScriptConfig(env="ML10")
    rl_cfg = rl_config(cfg)
    trainer = RLTrainer(cfg, algo="trpo", path=tmp + "/")
    with pinned_cpus(HOST_CPUS):
        big, _ = make_env("ML10", workers=cfg.meta_batch_size
                          * cfg.adapt_batch_size, seed=cfg.seed,
                          max_path_length=cfg.max_path_length)
        policy = build_policy(big, False)
        params = policy.init(torch.Generator(device="cuda").manual_seed(SEED))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        iterations = {
            "task_batch": trainer._make_host_batched_iteration(
                big, policy, host.make_grouped_host_rollout(
                    big, policy, cfg.max_path_length, cfg.meta_batch_size,
                    cfg.adapt_batch_size), rl_cfg)}
        counter = HostCounted(torch, gc, host)
        counter.wrap(iterations["task_batch"])(params, None, gen)
        turns = ([{"path": "per_task", **r} for r in per_task]
                 + [{"path": "task_batch", **counter.rows[-1]}])
        s = {name: [t["s"] for t in turns if t["path"] == name]
             for name in ("per_task", "task_batch")}
        prof = profiled(torch, lambda: iterations["task_batch"](
            params, None, gen), min(s["task_batch"]))
    pool = {}
    acts = np.zeros((POOL_SLOTS, 4))
    for cpus in (len(os.sched_getaffinity(0)), HOST_CPUS):
        with pinned_cpus(cpus):
            vec, _ = make_env("ML10", workers=POOL_SLOTS, seed=cfg.seed,
                              max_path_length=cfg.max_path_length)
            vec.set_task(vec.sample_tasks(None, 1)[0])
            t0 = time.perf_counter()
            for _ in range(POOL_STEPS):
                vec._pool.step(acts)
            pool[f"metaworld_native_{cpus}_cpus"] = (
                POOL_SLOTS * POOL_STEPS / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    for _ in range(POOL_STEPS):
        for i, e in enumerate(vec.envs):
            e.step(acts[i])
    pool["metaworld_python_loop"] = (POOL_SLOTS * POOL_STEPS
                                     / (time.perf_counter() - t0))
    nat = binding.NativeVecEnv("particles2d", n_envs=POOL_SLOTS)
    nat.reset(np.zeros(2))
    t0 = time.perf_counter()
    for _ in range(10 * POOL_STEPS):
        nat.step(np.zeros((POOL_SLOTS, 2)))
    pool["particles2d_native"] = (POOL_SLOTS * 10 * POOL_STEPS
                                  / (time.perf_counter() - t0))
    out = {"turns": turns, "s_per_iteration": s,
           "idle_share": prof["idle_share"],
           "profile": {k: prof[k] for k in ("busy_union_us", "wall_us",
                                            "kernel_launches",
                                            "sweep_kernels_us", "top")},
           "pool_env_steps_per_s": pool}
    print(f"host timing: s per maml_trpo ML10 iteration, per task "
          f"{s['per_task']} vs task-batched {s['task_batch']}; round trips "
          f"per iteration {[t['round_trips'] for t in turns]}, shipments "
          f"{[t['shipments'] for t in turns]}; profiled task-batched "
          f"iteration idle {prof['idle_share']}; env steps/s at "
          f"{POOL_SLOTS} slots {pool} [{gpu}]", flush=True)
    return out


def host_env_phase(torch, np, gc, gpu, tmp) -> dict:
    """Phase 14: host envs (slice 13)."""
    from exploring_meta_tpu_torch.envs import host
    from exploring_meta_tpu_torch.native import binding

    start = time.perf_counter()
    t0 = time.perf_counter()
    check(binding.load_vecenv_library() is not None,
          "native/vecenv.cpp builds with g++")
    out = {"build_s": time.perf_counter() - t0}
    print(f"vecenv.cpp (g++): {out['build_s']:.2f} s -> "
          f"{binding.library_path()}", flush=True)
    # every vec env that collects; a 1-slot env that only samples tasks
    # (meta_test under task_batch, as in JAX) takes the loop and never steps
    stepped, collect = {}, host.HostVecEnv.collect

    def recording(self, *args, **kwargs):
        stepped[id(self)] = self.backend
        return collect(self, *args, **kwargs)

    host.HostVecEnv.collect = recording
    remove = installed_fake_metaworld(os.path.dirname(
        os.path.abspath(__file__)))
    try:
        out["native_particles2d"] = native_particles_vs_device(torch, np,
                                                               binding)
        with pinned_cpus(HOST_CPUS):
            with recording_outer_steps({}) as recorded:
                out["maml_trpo"] = host_trainer_run(
                    torch, gc, host, tmp, "trpo",
                    "_make_host_trpo_iteration",
                    n_eval_tasks=HOST_EVAL_TASKS)
                out["maml_ppo_task_batch"] = host_trainer_run(
                    torch, gc, host, tmp, "ppo",
                    "_make_host_batched_iteration", task_batch=True,
                    outer_lr=0.01, n_eval_tasks=HOST_EVAL_TASKS)
            out.update(host_eval_paths(torch, np, gc, host,
                                       out["maml_ppo_task_batch"]["run"],
                                       out["maml_trpo"]["run"], gpu))
            cpu_run = host_trainer_run(
                torch, gc, host, tmp, "ppo", "_make_host_batched_iteration",
                task_batch=True, outer_lr=0.01, host_policy="cpu",
                num_iterations=1, n_eval_tasks=1)
        host.set_host_policy_device("device")
        out["card_vs_cpu"] = host_card_vs_cpu(torch, np, host, gpu,
                                              recorded)
        check(cpu_run["counts"]["steps"] > 0
              and cpu_run["counts"]["round_trips"] == 0
              and cpu_run["counts"]["shipments"] > 0,
              f"--host_policy cpu: every forward on the CPU, the rollouts "
              f"shipped to the card: {cpu_run['counts']}")
        out["host_policy_cpu"] = cpu_run
        out["timing"] = host_timing(torch, np, gc, host, binding, tmp, gpu,
                                    out["maml_trpo"]["per_iteration"])
    finally:
        host.HostVecEnv.collect = collect
        host.set_host_policy_device("device")
        remove()
    try:
        import gymnasium  # noqa: F401
        import mujoco  # noqa: F401
    except ImportError as e:
        print(f"AntDirection-v1 not run: the image lacks gymnasium or "
              f"mujoco ({e})", flush=True)
        out["ant"] = None
    else:
        out["ant"] = host_trainer_run(
            torch, gc, host, tmp, "trpo", "_make_host_trpo_iteration",
            env="AntDirection-v1", num_iterations=1, n_eval_tasks=2)
    check(stepped and set(stepped.values()) == {"native"},
          f"every vec env of the phase steps on the native pool: "
          f"{sorted(set(stepped.values()))}")
    out["vec_envs_stepped"] = len(stepped)
    launches: dict = {}
    for paths in (out["maml_trpo"]["launches"],
                  out["maml_ppo_task_batch"]["launches"],
                  out["meta_test_each3"]["launches"],
                  out["eval_rl"]["launches"], cpu_run["launches"],
                  *([out["ant"]["launches"]] if out["ant"] else [])):
        for k, n in paths.items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - start
    print(f"phase 14 (host envs): {out['wall_s']:.2f} s, launches "
          f"{launches} [{gpu}]", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np
    import torch.nn.functional as F
    from exploring_meta_tpu_torch.cuda import build, cnn4_cuda as tc
    from exploring_meta_tpu_torch.cuda import gae_cuda as gc
    from exploring_meta_tpu_torch.models.layers import (
        get_conv_impl, set_precision,
    )

    set_precision("highest")
    check(get_conv_impl() == "fused", "the served path runs the fused kernels")
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    build_s, ptxas = build_all(build)
    print(f"build: {build_s:.1f} s for {sorted(ptxas)}", flush=True)
    for src, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {src}: {ln}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln)
            check(not spill or spill.groups() == ("0", "0"),
                  f"no register spills in {src}: {ln}")

    res = kernel_phase(tc, F, torch)
    for name, r in res.items():
        print(f"kernel {name}: max_abs_err {r['max_abs_err']} ms {r['ms']} "
              f"plain_ms {r['plain_ms']} library_ms {r['library_ms']} "
              f"bound_ms {r['bound_ms']}" + "".join(
                  f" {k} {r[k]}" for k in ("ms_n15", "library_ms_n15",
                                           "bound_ms_n15", "dw_library_ms")
                  if k in r)
              + f" [{gpu}]", flush=True)
    served = serve_phase(torch, np, tc, gpu)
    sweeps = sweep_phase(torch, gc, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        trpo = trpo_phase(torch, gc, tc, gpu, tmp)
        outer = outer_step_phase(torch, trpo.pop("params"), gpu)
    prof = trpo_profile(torch, gpu)
    second_order = vision_second_order(torch, tc, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        vision = vision_trainer_phase(torch, tc, gpu, tmp)
    vision_times = vision_timing(torch, gpu)
    policy_serve = policy_serve_phase(torch, gc, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        adam_rl = adam_rl_phase(torch, gc, gpu, tmp)
    replay_grad = replay_grad_phase(torch, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        fused = fused_phase(torch, gc, tc, gpu, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        analysis = analysis_phase(torch, gc, tc, gpu, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        slice10 = slice10_phase(tc, gc, F, torch, gpu, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        slice11 = run_utilities_phase(torch, gc, tc, gpu, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        slice12 = seed_sweep_phase(tc, gc, F, torch, gpu, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        slice13 = host_env_phase(torch, np, gc, gpu, tmp)

    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "build_s": build_s, "ptxas": ptxas,
                   "kernels": {**res, **sweeps}, "serve": served,
                   "trpo": trpo, "outer_step": outer, "trpo_profile": prof,
                   "vision_second_order": second_order,
                   "vision_trainer": vision, "vision_timing": vision_times,
                   "policy_serve": policy_serve, "adam_rl": adam_rl,
                   "replay_meta_grad": replay_grad, "fused": fused,
                   "analysis": analysis, "slice10": slice10,
                   "slice11": slice11, "slice12": slice12,
                   "slice13": slice13}, f, indent=1, default=str)

    replaces = {
        "cnn4_block_fwd": "exploring_meta_tpu/pallas/cnn4_pallas.py:295",
        "cnn4_block_bwd_params": "exploring_meta_tpu/pallas/cnn4_pallas.py:310",
        "cnn4_block_bwd_input": "exploring_meta_tpu/pallas/cnn4_pallas.py:310",
        "gae_sweep": "exploring_meta_tpu/pallas/gae_pallas.py:62",
        "discount_sweep": "exploring_meta_tpu/pallas/gae_pallas.py:62",
    }
    launches = {**served["launches"], **trpo["launches"]}
    # the CNN4 kernels run on two main paths, one served batch and the
    # vision trainer's run; the sweeps on four, the MAML-TRPO trainer's
    # run, the served policy batches and the two Adam trainers' runs; and
    # each on the fused trainers' runs (the eager warm-up and meta-test:
    # a replay runs the kernels recorded in its graph, no wrapper); the
    # analysis tier's: eval_vision the CNN4 kernels, eval_rl and the vpg /
    # ppo RC runs the sweeps; the baselines' (the RL ones the sweeps, the
    # vision one the CNN4 kernels at B = 1 and its meta-eval's) and the
    # bf16 runs' (the fused maml_trpo's warm-up and meta-test, the eager
    # maml_ppo's); the run utilities' (the resumed and uninterrupted
    # runs, the imported model's request and batch, the profiled runs);
    # and the seed sweeps' (the serial sweeps' trainers, the one-program
    # sweeps' warm-up iterations and meta-tests); and the host envs' (the
    # per-task and task-batched trainers, meta_test each3, eval_rl, the
    # --host_policy cpu run, Ant where the image has it)
    for paths in (vision["launches"], policy_serve["launches"],
                  adam_rl["launches"],
                  *(r["launches"] for r in fused.values()),
                  analysis["eval_vision"]["launches"],
                  analysis["eval_rl"]["launches"],
                  *(r["launches"] for r in analysis["rc_algos"].values()),
                  *(r["launches"]
                    for r in slice10["rl_baselines"].values()),
                  slice10["vision_baseline"]["launches"],
                  slice10["bf16"]["fused_trpo"]["launches"],
                  slice10["bf16"]["eager_ppo"]["launches"],
                  slice11["launches"], slice12["launches"],
                  slice13["launches"]):
        for name, n in paths.items():
            launches[name] += n
    kernels = []
    for name, r in {**res, **sweeps}.items():
        source = "gae.cu" if name in sweeps else "cnn4_block.cu"
        err = r["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"exploring_meta_tpu_torch/csrc/{source}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(err.values()) if isinstance(err, dict) else err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
