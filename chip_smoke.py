#!/usr/bin/env python3
"""Drives the PyTorch port's main paths on one CUDA GPU and checks them.

    python3 chip_smoke.py

Run from the repository root, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. It builds every kernel from ``csrc/`` and holds each
against its plain PyTorch version: K1 (spatial softmax; a channel-group
kernel for channel-contiguous maps, a warp-per-channel kernel for other
layouts) and K2-K4 (flash attention forward, dq, dk+dv; bfloat16 on the
tensor cores, float32 on the CUDA cores). Then it drives every slice:

- slice 1 serves the pose_env regression model (BASELINE config #1 at its
  published width: 64x64 RGB, convs 3->32->48->64, a 16x16x64 map,
  spatial softmax to 128, then 64, then 2) from a native export directory
  through ``ExportedModelPredictor`` and ``evaluate_policy``, and holds
  the GPU's outputs against the same weights served on the CPU;
- slice 2 trains a SNAIL stack at the flash path's widths (8 episodes of
  2048 steps, 64 features; attention with key size 64, a TCBlock of 11
  dense blocks of 32 filters, attention, a dense head) for 20 Adam steps
  with the flash core, and holds its loss stream against the same 20
  steps with the dense core;
- slice 5 trains the pose_env model at that width through ``Trainer``
  (2000 collected episodes, 1500 Adam 1e-3 steps at batch 64, bf16, its
  ImagePreprocessor and ``prefetch_to_device``), exports it with
  ``NativeExportGenerator``, serves it through ``ExportedModelPredictor``
  and requires a reach success rate of at least 0.80 within 0.05 over 200
  held-out episodes, the JAX package's own bar; then it holds 3 float32
  steps on the GPU against the CPU and drives ``train_eval_model`` to an
  export that loads.
- slice 6 runs that training as the JAX package's users do, at seed 0:
  2000 episodes written as jpeg TFRecords, 1500 steps through the
  CLI (``bin/run_t2r_trainer.py``) and ``pose_env_train.cfg`` into a
  ``model_dir``, in two calls of 750 steps (the second resumes from the
  checkpoint), then ``model_dir/export/latest`` served to the same reach
  bar, and records served through ``predict_examples``; since slice 7
  with ``iterations_per_loop=50``, as the JAX check trains, so each
  call's stacks after the first are CUDA graph replays of 50 steps.
- slice 7 trains pose_env's step and the QT-Opt critic's at its published
  size (472x472 float images, bf16, batch 32, Adam 1e-4, EMA kept) as
  one ``Trainer.train_steps`` CUDA graph against the same steps eagerly
  (bit for bit, cuDNN deterministic), holds ``impl="fast"`` against
  "parity" and the float32 eval forward against the CPU's, times the CEM
  control step at the serving defaults (64/6/3), holds one
  ``train_step_accum`` of 4 microbatches on the card against the CPU,
  and runs the port's ``check_qtopt`` at the JAX package's full scale:
  8000 logged grasps written as jpeg records, 2500 Adam 1e-3 steps at
  batch 64 through ``train_eval_model(iterations_per_loop=50)`` into a
  ``model_dir``, the native export served through ``CEMPolicy``
  (128/10/4) over 200 held-out scenes; grasp success must reach 0.72 and
  beat random grasps.
- slice 8 trains the QT-Opt critic on Bellman targets through the
  learner's host path (sample the prioritized ring, label with fleet CEM
  against the lagged target net, train, TD errors, priority write-back):
  the JAX smoke's off-policy bar (TinyQ, eval TD error against the retry
  env's Q* down 30%) at seed 0, the JAX learner bench's host path,
  the production learner at full width (the 64x64 uint8 GroupNorm critic,
  batch 32, CEM 64/6/3, a 4-shard ring of 50,000 filled past 2,000 by
  collector threads) for 200 steps with each stage's host and device
  time and the card's idle share, and one label at 472x472.
- slice 9 closes the loop as ``run_qtopt_replay`` runs it: collector
  threads acting through ``CEMFleetPolicy`` (one CUDA graph per bucket)
  while the learner trains with the health sentinel and hot-reloads the
  policy: the JAX smoke's bar at seed 0, the production loop at
  full width (the 64x64 critic, 4 collectors of 8 envs, a ring of
  50,000), and the fleet policy at the published 472x472 at rungs 1, 4
  and 16, its graph against its eager control bit for bit, captured once
  across three reloads.
- slice 10 makes that loop preemptible and batches its acting:
  ``qtopt_resume`` holds the learner's crash-resume parity bit for bit
  (TinyQ, and the production 64x64 critic at batch 32), resumes
  ``run_qtopt_replay --smoke`` from its checkpoint at step 150 to 300,
  times a checkpoint's save and restore at the production ring and traces
  a ``--profile`` window; ``qtopt_vector`` runs the loop with one
  ``VectorActor`` stepping every env through one bucket: the smoke's bar
  at seed 1, the production loop's learner beside the actor and
  alone, and the vector-against-threaded actor bench.
- slice 11 runs the learner device-resident (``qtopt_device``): the ring
  and its sum tree on the card, and the megastep, K sample -> label ->
  train -> reprioritize iterations a dispatch as CUDA graphs, held against
  its eager iterations bit for bit (TinyQ, and the 64x64 critic at K=50
  with CEM 64/6/3); ``run_qtopt_replay --smoke --device-resident`` to the
  JAX bar at seed 0 with the learner bench; the production loop
  beside one vector actor and alone; and fused resume parity.
- slice 12 runs the fused Anakin loop (``qtopt_anakin``): the device grasp
  env and its rasterizer against the numpy oracle bit for bit, the
  period's CUDA graph (``train_every`` control steps of act -> env step ->
  extend and one learn) against eager periods bit for bit (TinyQ, and the
  64x64 critic with CEM 64/6/3) across a dispatch that crosses min_fill,
  ``run_qtopt_replay --smoke --anakin`` to the JAX bar at seed 0
  with the Anakin bench, the production ``--anakin`` run at full width,
  and its fused resume.
- slice 13 runs the bf16 and int8 scoring tiers (``qtopt_precision``):
  the fleet policy's graphs at each tier against eager bit for bit over
  hot reloads, the precision bench's bf16 agreement and the int8 bench's
  agreement and served bytes, the megastep and the Anakin loop at bf16
  against eager, ``run_qtopt_replay --smoke --anakin --precision bf16``
  beside f32 at seed 0, and each tier's fleet replays at 472x472,
  megastep device time and production ``--anakin`` rates beside f32.
- slice 14 runs the obs spine and one serving replica: ``obs_loop`` runs
  ``run_qtopt_replay --smoke`` with a ``--profile`` window on the host path
  and device-resident under a started watchdog (the loop's spans as
  ``record_function`` ranges in the trace, its stage counts, heartbeats, no
  stall, registry gauges equal to the JSONL records); ``serve_fleet`` runs
  ``bench_serving --fleet --smoke`` at 16 clients (one capture a rung, the
  amortization beside the JAX bar), then ``FleetServer`` over
  ``CheckpointPredictor`` restored from a ``model_dir`` at 472x472: 16
  client threads, a held flush of 16 bit for bit against the policy called
  directly, and a hot reload mid-serve that captures nothing.
- slice 15 runs the routed fleet (``serve_router``): ``bench_fleet --ci
  --devices 2`` on the card (three SLO classes under open-loop Poisson
  load, the overload burst shedding the lowest class first, one promote
  and one injected-regression rollback, one capture a bucket a replica),
  the bf16 and int8 tier rollouts (the breach rolled back, then the tier
  promoted, tier-suffixed ledger rows once each), and ``FleetRouter``
  over two replicas of the 472x472 critic from a ``model_dir``: held
  requests bit for bit against one policy with separate graph pools, 16
  closed-loop clients (images/s, p50/p99, flushes a replica, each
  replica's memory), a profiled window's kernel overlap, a params
  rollout of a second checkpoint step promoted and a jittered candidate
  rolled back, with no capture.
- slice 16 runs MAML through K1 and the training harness: ``maml_graph``
  holds check_maml's model (the pose_env MAML regressor at 64x64,
  GroupNorm, float32, 8 tasks of 4 + 4 scenes, 3 inner steps) as a
  ``train_steps`` CUDA graph against eager meta-steps bit for bit at
  second order (``autograd.grad(create_graph=True)`` inside the capture),
  first order and with learned inner rates, and the MAML-wrapped mock with
  dropout from generators registered with the graph; ``maml_check`` runs
  the port's ``check_maml`` at the fast scale (800 meta-steps, 64 fresh
  tasks) to the JAX bars (0.75 at half the object radius, a margin of
  0.5 over the unadapted model) with K1's launches counted a meta-step
  and an eval; ``maml_serve`` restores a MAML export on the card and
  serves requests with condition data (adapt, then predict) equal to
  ``inference_network_fn``'s; ``maml_harness`` trains
  ``pose_env_maml_train.cfg`` through ``run_t2r_trainer`` with an async
  export hook and a best exporter, then ``--mode continuous_eval`` over
  its checkpoints, and restores the best export on the card.
- slice 17 runs the research zoo and the program format: ``zoo_grasp2vec``
  trains BASELINE #2 at its published width (ResNet-50 towers, width 64,
  224x224, embedding 512, batch 64, bf16, BatchNorm, Adam 1e-4) as a
  ``train_steps`` CUDA graph against eager steps bit for bit, holds
  ``remat=True`` against ``False`` bit for bit with each one's step ms and
  peak memory, and runs ``check_grasp2vec`` at the full scale to the JAX
  bar (0.62; the fast scale's 0.38 is a TPU calibration neither package
  reaches off the TPU); ``zoo_vrgripper`` does the graph check for
  BASELINE #5 (``VRGripperEnvModel``: FiLM ResNet-18 width 32, 100x100,
  an MDN of 5, batch 64), the TEC model and meta-BC (the last in a process
  of its own), trains ``vrgripper_train.cfg`` through the CLI on records
  ``episode_to_transitions`` writes into a ``model_dir`` whose export
  serves, and runs ``check_vrgripper`` at the full scale to its bar
  (0.80); ``export_program`` exports pose_env and the VRGripper MDN model
  as ``serving_fn.pt2`` and serves them with no model object against the
  eager model at batch 1 and 8, K1 launching once a pose_env request
  through the program's custom op.

- slice 18 runs the parallel tier's training half with two gloo ranks
  co-located on the card (``parallel/launch.py``; NCCL refuses two ranks
  on one device): ``parallel_attention`` holds Ulysses attention over
  {"seq": 2} (each rank's local core K2 forward, K3 and K4 backward on
  (8, 2048, 1, 64) bf16 of a global (8, 2048, 2, 64), causal) against one
  process's ``ops.flash_attention`` on the global input, with each rank's
  kernel launches counted, ring attention against the dense reference,
  and SNAIL's ``AttentionBlock(seq_mesh=)`` at slice 2's width for 3 Adam
  steps against the unsharded block; ``parallel_train`` trains the
  472x472 critic at batch 32 (float32, TF32 off, the EMA kept) through
  ``train_eval_model`` in four modes, data parallel, ZeRO-1 and FSDP on
  {"data": 2} and tensor parallel by the model's partition rules on
  {"data": 1, "model": 2}, 3 steps each, every mode held against one
  rank's run on the global batch (losses, the first step's gradients and
  Adam updates, the running statistics), with each mode's ms a step, a
  rank's peak memory, its parameter blocks and the collectives' bytes.
  Their step times measure the structure, not multi-card scaling: both
  ranks share one card.
- slice 19 runs the executable ledger through the QT-Opt loops: in
  ``qtopt_device`` and ``qtopt_anakin`` the production runs' (the 64x64
  flagship critic at full width) ``obs.attribution`` is held to the JAX
  smokes' require and forbid sets, every row dispatched, the learner-side
  shares (the whole Anakin path) at most 1.0 of the window and an
  estimated MFU for the fused program; the 64x64 megastep and Anakin
  graph checks report each dispatch's FLOPs over its device time and run
  the same graphed dispatches with the ledger off and on, alternating in
  blocks (the ledger's median at most 5% slower); ``qtopt_precision``
  holds the bf16 and int8 tier ledgers exactly once a bucket a tier; and
  ``obs_loop`` holds the host path's attribution (``train_step``,
  ``bellman_targets``, ``td_error``, ``health_summary``).
- slice 20 runs the QT-Opt replay loop over a mesh of two gloo ranks on
  the card (``qtopt_mesh``) at the production width (the 64x64 flagship
  in float32 with TF32 off, CEM 64/6/3, batch 32 as 16 a rank, a fleet of
  32 as 16 a rank): a collect-only Anakin dispatch at dp=2 equal to one
  rank's bit for bit (the ring and the fleet, gathered), three trained
  Anakin dispatches and three megastep dispatches with ZeRO-1 within the
  JAX mesh loop's bound (rtol 1e-4, atol 1e-6) of one rank's, the Anakin
  loop at tp=2 with the flagship's parameters split by its rules, and
  ``run_qtopt_replay --anakin --mesh 2`` at the production config under
  ``torch.distributed.run``; it reports the collectives' bytes of a
  dispatch and the ring's bytes a rank. Two ranks on one card measure
  structure, not scaling.

Slice 6's record run and slice 7's capability check wait on the host's
record parser with the card idle, so each runs in a child process of
this script (``--background``) beside slice 16's and 17's phases, whose
checks hold no time; meta-BC's graph check runs in a child as well, and
so does slice 20's mesh phase, which holds parity and no time. The
``phase_seconds`` line gives the run's seconds by phase and each child's.

Each path runs with the launch counts set to 0 just before it and checks
them just after. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Weights and data are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the float32 rate
# outside the tensor cores and the dense bf16 tensor-core rate.
_HBM_BYTES_PER_S = 3.35e12
_F32_FLOPS = 67e12
_BF16_FLOPS = 989e12
# Spatial softmax per input element: scale, running max, exp, and three
# multiply-adds (s, sx, sy).
_SPATIAL_SOFTMAX_OPS_PER_ELEMENT = 10

F32_ATOL = 1e-5  # kernel vs plain version, as tests/test_ops.py
BF16_ATOL = 2e-2
# GPU-served vs CPU-served pose outputs (table units, magnitude <~0.5):
# float32 with TF32 off differs only in summation order; bfloat16 rounds
# activations at different points in cuDNN and oneDNN convolutions.
SERVE_F32_ATOL = 1e-4
SERVE_BF16_ATOL = 5e-3
EPISODES = 16
BATCH = 64

# Slice 2: the SNAIL stack at the widths of the JAX package's flash path
# (head dim 64 and T = 2048 as tests/test_tpu.py's on-chip flash tests).
SNAIL_BATCH, SNAIL_SEQ, SNAIL_FEATURES = 8, 2048, 64
SNAIL_FILTERS, SNAIL_KEY = 32, 64
TRAIN_STEPS = 20
# Flash kernels vs their plain versions, as |got - want| <= atol + rtol
# |want|. float32 (TF32 off): the same sums in another order, over up to
# 2048 terms. lse is float32 in both dtypes.
FLASH_F32_TOL = dict(atol=1e-4, rtol=1e-4)
FLASH_LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# bfloat16: |got - want| <= 1e-5 + 2^-5 rms(row) + 2^-7 |want|, a row
# being the D outputs of one (b, t, h) and rms(row) the plain version's
# root mean square over it. The three terms:
# - 2^-7 |want|: both sides sum in float32 and round once to bf16, so
#   they may sit one ulp (at most 2^-7 of the value) apart.
# - 2^-5 rms(row): the tensor-core kernels (K2-K4) round each term of P,
#   and of dS, to bf16 before the product that follows, where the plain
#   versions keep float32. Each term of out = sum P v / l, dv = sum P^T
#   dout, dq = sum dS k * scale and dk = sum dS^T q * scale moves by up
#   to 2^-8 of itself, with no common sign, so an output moves by about
#   2^-8 / sqrt(3) of the root sum of its terms' squares: for random
#   inputs, 2^-8.8 of its row's
#   rms. The largest of a million such errors lies near 5.5 of those,
#   2^-6.3 of the rms; 2^-5 leaves a factor 2.5. The limit follows each
#   row's own scale, so a kernel that drops one of 32 key tiles, or is
#   10% off on the late causal rows (|out| ~ 0.01), exceeds it.
# - 1e-5: float32 sums in another order where an output cancels to
#   about 1e-7 (dk at T = 1 is 0).
# tests/test_torch_flash_attention.py rounds at the kernels' points on
# the CPU and holds the result to the same limit.
FLASH_BF16_ROW_SHARE = 2 ** -5
FLASH_BF16_RTOL = 2 ** -7
FLASH_BF16_FLOOR = 1e-5
# Slice 18: two gloo ranks on the card. Ulysses at K2's table shape (a
# global (8, 2048, 2, 64) bf16, causal: (8, 2048, 1, 64) a rank), held
# within flash_limit of one process's flash_attention; ring attention
# within the same limit of the dense reference; the SNAIL ring block at
# slice 2's width in float32 (TF32 off) against the unsharded block; the
# training modes at the flagship's width and batch, float32 (TF32 off),
# held against one rank's run with slice 5's limits (see GRAD_NOISE_SHARE).
PARALLEL_RANKS = 2
PARALLEL_ATTENTION_SHAPE = (8, 2048, 2, 64)
PARALLEL_SNAIL_STEPS = 3
PARALLEL_TRAIN_STEPS = 3
# A mode's first gradients against the one-rank run's, as a share of each
# tensor's largest. At 472x472 the float32 sums of cuDNN's convolutions
# and batch norm over a batch of 32 and over two of 16 part by up to
# 0.0039 of a tensor's largest (pre_conv2's kernel, the same in every
# data-parallel mode; in float64 they agree to float32 rounding); on the
# CPU at 64x64 the modes agree within 5e-6. A lost reduction or a
# gradient off by the rank count moves it by ~1.
PARALLEL_GRAD_SHARE = 1e-2
# Slice 20: the replay loop over two gloo ranks on the card at the
# production width (64x64 flagship in float32, TF32 off; CEM 64/6/3; batch
# 32 as 16 a rank; a fleet of 32 as 16 a rank). The parity runs hold a
# ring of MESH_CAPACITY (the CLI run the production 50,000) and one
# period of MESH_INNER control steps a dispatch; learns are held to the
# JAX mesh loop's bound (tests/test_anakin.py's TestShardedAnakinParity).
MESH_RANKS = 2
MESH_CAPACITY = 1024
MESH_BANK_SCENES = 256
MESH_INNER = 8
MESH_MIN_FILL = 32
MESH_DISPATCHES = 3
MESH_MEGASTEP_INNER = 4
MESH_CLI_STEPS = 25
MESH_LOSS_RTOL, MESH_LOSS_ATOL = 1e-4, 1e-6
MESH_LOSS_KEYS = ("loss", "td_error", "q_next", "staleness")
# and the global gradient norm at the same bound: Adam's update is blind
# to a gradient's scale, so a gradient summed over the ranks rather than
# averaged would leave the losses within it.
MESH_HELD_KEYS = MESH_LOSS_KEYS + ("health/grad_norm",)


def flash_limit(torch, want):
  """The largest |got - want| each element of a flash output may show."""
  w = want.float()
  if want.dtype == torch.float32:
    return FLASH_F32_TOL["atol"] + FLASH_F32_TOL["rtol"] * w.abs()
  rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
  return (FLASH_BF16_FLOOR + FLASH_BF16_ROW_SHARE * rms
          + FLASH_BF16_RTOL * w.abs())
# Slice 5: the JAX package's full-scale pose_env capability check
# (tensor2robot_tpu/bin/run_capability_checks.py: 2000 episodes, 1500
# steps of Adam 1e-3 at batch 64, 200 held-out reaches from seed 1234, at
# least 0.80 of them within 0.05).
POSE_EPISODES, POSE_STEPS, POSE_LR = 2000, 1500, 1e-3
REACH_EPISODES, REACH_SEED, REACH_THRESHOLD, REACH_BAR = 200, 1234, 0.05, 0.80
# Slice 6: the same run from jpeg records through the CLI and model_dir,
# in two calls (the second resumes), at seed 0 (seeds 0 and 1 before slice
# 14's phases joined, to keep the script inside its time limit).
RECORD_SEEDS = (0,)
RECORD_HALF = 750
RECORD_CFG = os.path.join("tensor2robot_tpu_torch", "research", "pose_env",
                          "configs", "pose_env_train.cfg")
SERVED_RECORDS = 64
PROFILED_STEPS = 10
# GPU vs CPU training at float32 with TF32 off, 3 steps in lockstep: each
# GPU step starts from the CPU's state (parameters, Adam moments, running
# statistics), so each step's arithmetic is compared on equal inputs. The
# loss and the running statistics must agree within 1e-4. Parameters are
# not compared with each other: Adam's first step is lr g / (|g| + eps),
# a step of lr however small g is, so an element whose gradient lies
# within the two sides' float32 difference of 0 may step the other way
# (2 lr apart), and the conv biases that feed BatchNorm (an exact gradient
# of 0) do so at random. Instead each tensor's gradients must agree
# within GRAD_NOISE_SHARE of its largest (the BN-fed biases' are pure
# noise and are not held), and each side's update must be Adam's rule on
# its own gradient, computed in float64, within ADAM_ATOL.
TRAIN_F32_STEPS = 3
TRAIN_F32_RTOL = 1e-4
TRAIN_F32_ATOL = 1e-4
GRAD_NOISE_SHARE = 1e-3
ADAM_ATOL = 1e-6
BN_FED_BIASES = ("tower.conv0.bias", "tower.conv1.bias", "tower.conv2.bias")

# Flash-core vs dense-core loss streams: the dense core rounds its logits
# and its softmax weights to bfloat16 (the flash kernels keep float32), so
# each step's loss may differ by bf16 noise averaged over 16384 outputs.
LOSS_RTOL = 1e-2

# Slice 7: the QT-Opt critic. The JAX check_qtopt's full scale, uncut
# (tensor2robot_tpu/bin/run_capability_checks.py: 8000 logged grasps at
# 128x128, 2500 Adam 1e-3 steps at batch 64 with iterations_per_loop=50,
# CEM 128/10/4 over 200 held-out scenes; bar 0.72 and above random). The
# flagship critic at its published defaults (472x472 float images, bf16,
# batch norm, conv stem, parity impl, batch 32, Adam 1e-4) for the graph
# and the serving checks, with the EMA kept so the graph must carry it.
FLAGSHIP_STEPS = 20
FLAGSHIP_SCENES = 128
FLAGSHIP_WARM_STEPS = 2
# CEM at the flagship's serving defaults (cem.CEMPolicy's).
CEM_SERVING = dict(num_samples=64, num_elites=6, iterations=3)
CEM_CALLS = 20
# impl="fast" against impl="parity", and the GPU's eval forward against
# the CPU's, both at float32 with TF32 off: the same sums in another
# order over up to 472x472 pixels; logits are O(1).
FLAGSHIP_F32_ATOL = 1e-4
# pose_env under iterations_per_loop: one 50-step stack as one graph
# against 50 eager steps, as the JAX check trains (K = 50).
GRAPH_STEPS = 50
QTOPT_SCENES = 200  # check_qtopt's held-out scenes
# Gradient accumulation: m microbatches of 16, float32 (TF32 off), the
# card against the CPU: the pose_train_f32 bars.
ACCUM_MICRO, ACCUM_BATCH = 4, 16
# Slice 8: the QT-Opt learner on Bellman targets. (a) The JAX smoke's
# off-policy bar (replay/smoke.py: eval TD error against the retry env's
# Q* down 30%) at seed 0 (0 and 1 until slice 17's phases joined); (c)
# the production learner of
# run_qtopt_replay's non-smoke config (tensor2robot_tpu/bin/
# run_qtopt_replay.py: 64x64 uint8 images, GroupNorm, Adam 1e-4, batch 32,
# CEM 64/6/3, gamma 0.8, a 4-shard prioritized ring of 50,000 filled past
# 2,000 by 4 collectors of 8 envs); (d) one label at the published
# 472x472.
LEARNER_SEEDS = (0,)
LEARNER_BAR = 0.30
LEARNER_WARM_STEPS = 10
LEARNER_STEPS = 200
LEARNER_PROFILED_STEPS = 20
LABEL_472_REPEATS = 3
# TinyQ's factored label against its tiled one on the same draws: float32
# (no TF32 in matmuls), the same products summed in other shapes.
LABEL_FACTORED_ATOL = 1e-5
# Slice 9: the closed QT-Opt loop. (a) run_qtopt_replay --smoke (TinyQ,
# the JAX smoke's bar); (b) the production loop of the JAX
# CLI's non-smoke config (collectors acting through CEMFleetPolicy's
# bucket-8 graph while the learner trains) for 10 steps (20 until slice
# 17's phases joined; the collector
# threads' env stepping holds the interpreter, and the eager learner runs
# at ~1.3 steps/s beside them on an H100, against ~27 alone:
# scripts/profile_qtopt_loop.py); (c) CEMFleetPolicy at the published
# 472x472 at LOOP_FLEET_RUNGS, its
# graph against its eager control bit for bit (cuDNN deterministic), and
# at 64x64 float32 against the CPU.
LOOP_SEEDS = (0,)
# The host-path and vector-actor smokes (~47 s each at 300 steps) run one
# seed each since slice 14's phases joined (both at seeds 0 and 1 before),
# and the fused paths' smokes (device-resident, Anakin, the tiers' fused
# loop) one seed since slice 15's joined, to keep the script inside its
# time limit.
HOST_SMOKE_SEEDS = (0,)
VECTOR_SMOKE_SEEDS = (1,)
LOOP_BAR = 0.30
LOOP_SMOKE_STEPS = 300
# 20 steps (200 before slice 10's phases joined, 100 before slice 11's, 50
# before slice 14's, to keep the script inside its time limit): no hot
# reload; the vector production loop of slice 10 covers one.
LOOP_PRODUCTION_STEPS = 10
FLEET_RUNGS = (1, 2, 4, 8, 16)
# The closed loop's fleet policy timed at 472x472 on three of its rungs
# (every rung until slice 18's phases joined; the serving phases keep all
# five).
LOOP_FLEET_RUNGS = (1, 4, 16)
FLEET_RELOADS = 3
FLEET_CALLS = 7
# The fleet step on the card against the CPU, float32 with TF32 off: the
# same sums in another order; logits and actions are O(1).
FLEET_F32_ATOL = 1e-4


def emit(phase: str, **fields) -> None:
  print(json.dumps({"phase": phase, **fields}), flush=True)


class PhaseClock:
  """Seconds by phase of the whole run (host clock, one lap a phase)."""

  def __init__(self):
    self.start = self.last = time.perf_counter()
    self.seconds = {}

  def lap(self, name: str) -> None:
    now = time.perf_counter()
    self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
    self.last = now

  def total(self) -> float:
    return time.perf_counter() - self.start


def nvidia_smi() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60,
  ).stdout.strip().splitlines()[0]


def device_ms(torch, fn, inner: int = 50, reps: int = 7) -> float:
  """Median device time of one `fn` call: `inner` calls captured in a CUDA
  graph, replayed `reps` times between CUDA events (no host overhead)."""
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream):  # warm the allocator off the capture
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(stream)
  from tensor2robot_tpu_torch.ops import graph_launches
  graph = torch.cuda.CUDAGraph()
  # Its tally is never replayed: the timing replays count no launches.
  with graph_launches.capture(graph, stream):
    for _ in range(inner):
      fn()
  torch.cuda.current_stream().wait_stream(stream)
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / inner)
  return float(np.median(times))


def stream_ms(torch, fn, inner: int = 20, reps: int = 7) -> float:
  """Median time of one `fn` call among `inner` issued back to back
  between CUDA events, without a graph: the larger of the kernel's time
  and the host's work to issue it."""
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / inner)
  return float(np.median(times))


def host_ms(torch, fn, reps: int = 32) -> float:
  """Median wall time of one synchronised `fn` call."""
  for _ in range(3):
    fn()
  times = []
  for _ in range(reps):
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  return float(np.median(times))


def nchw_view(x):
  """The (B, H, W, C) view of an NCHW tensor: what the conv tower hands
  the spatial softmax."""
  return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def spatial_softmax_map(torch, x, layout: str):
  """A (B, H, W, C) map with x's values in the named memory layout:
  "nhwc" contiguous, "nchw" the NCHW view, "slice_even" / "slice_odd"
  the channels of a wider map from channel 8 / 1 (pixel stride C + 9, an
  8- or 1-element base offset)."""
  if layout == "nchw":
    return nchw_view(x)
  if layout.startswith("slice"):
    b, h, w, c = x.shape
    offset = 8 if layout == "slice_even" else 1
    wide = torch.zeros((b, h, w, c + 9), dtype=x.dtype, device=x.device)
    wide[..., offset:offset + c] = x
    return wide[..., offset:offset + c]
  return x


def check_spatial_softmax(torch, ss, dev, seed: int) -> list:
  """Holds each kernel against its plain version on every listed case,
  and checks that the layout took the kernel it should: the channel-group
  kernel for channel-contiguous maps, the warp kernel for the NCHW view."""
  rng = np.random.default_rng(seed)
  cases = []
  for shape in [(1, 16, 16, 64), (64, 16, 16, 64), (2, 8, 8, 16),
                (1, 7, 5, 3), (3, 1, 9, 130), (4, 128, 128, 32)]:
    for dtype in (torch.float32, torch.bfloat16):
      for layout in ("nhwc", "nchw"):
        cases.append((shape, dtype, layout, 1.0))
  cases.append(((2, 6, 6, 4), torch.float32, "nhwc", 0.5))
  cases.append(((64, 16, 16, 64), torch.bfloat16, "nchw", 0.5))
  cases.append(((64, 16, 16, 64), torch.bfloat16, "nhwc", 0.5))
  for dtype in (torch.float32, torch.bfloat16):
    for layout in ("slice_even", "slice_odd"):
      cases.append(((3, 16, 16, 64), dtype, layout, 1.0))
      cases.append(((2, 9, 11, 65), dtype, layout, 1.0))
  cases.append(((2, 9, 11, 65), torch.bfloat16, "nhwc", 1.0))
  results = []
  for shape, dtype, layout, temperature in cases:
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = spatial_softmax_map(torch, x.to(dev, dtype), layout)
    kernel = "warp" if layout == "nchw" else "channels"
    before = dict(ss.spatial_softmax.launches_by_kernel)
    got = ss.spatial_softmax(x, temperature)
    torch.cuda.synchronize()
    moved = {name: count - before[name]
             for name, count in ss.spatial_softmax.launches_by_kernel.items()}
    if moved != {"warp": 0, "channels": 0, kernel: 1}:
      raise AssertionError(f"spatial_softmax {shape} {layout} launched "
                           f"{moved}; want the {kernel} kernel once")
    want = ss.spatial_softmax_reference(x, temperature)
    if got.dtype != dtype or got.shape != (shape[0], 2 * shape[3]):
      raise AssertionError(f"spatial_softmax {shape}: got {got.dtype} "
                           f"{tuple(got.shape)}")
    err = float((got.float() - want.float()).abs().max())
    atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
    results.append({"shape": list(shape), "dtype": str(dtype)[6:],
                    "layout": layout, "kernel": kernel,
                    "temperature": temperature, "max_abs_err": err,
                    "atol": atol})
    if not err <= atol:
      raise AssertionError(f"spatial_softmax disagrees: {results[-1]}")

  # The plain version's rules for -inf and NaN, through both kernels:
  # channel 0 is -inf on half its rows (they take no weight), channel 1
  # is -inf everywhere and channel 2 holds one NaN (both give NaN).
  for layout, kernel in (("nhwc", "channels"), ("nchw", "warp")):
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 5)).astype(
        np.float32)).to(dev)
    x[:, :4, :, 0] = -np.inf
    x[:, :, :, 1] = -np.inf
    x[1, 3, 5, 2] = np.nan
    x = spatial_softmax_map(torch, x, layout)
    if ss._kernel_for(x.shape, x.stride()) != kernel:
      raise AssertionError(f"spatial_softmax {layout} would not take the "
                           f"{kernel} kernel")
    torch.testing.assert_close(
        ss.spatial_softmax(x), ss.spatial_softmax_reference(x), rtol=0,
        atol=F32_ATOL, equal_nan=True)
    results.append({"case": "inf_and_nan", "layout": layout,
                    "kernel": kernel})

  # A sharp peak at (row 2, col 5) of an 8x8 map (tests/test_ops.py).
  peak = torch.full((1, 8, 8, 1), -10.0, device=dev)
  peak[0, 2, 5, 0] = 10.0
  out = ss.spatial_softmax(peak).cpu().numpy()[0]
  grid = np.linspace(-1, 1, 8)
  if abs(out[0] - grid[5]) >= 1e-3 or abs(out[1] - grid[2]) >= 1e-3:
    raise AssertionError(f"spatial_softmax peak at {out}, want "
                         f"({grid[5]}, {grid[2]})")
  results.append({"case": "peak", "out": out.tolist()})

  # First-order gradients: the kernel's backward is analytic (it never
  # runs the plain version) and must match differentiating the plain
  # version, on both kernels' layouts.
  for shape in [(2, 6, 6, 4), (64, 16, 16, 64)]:
    for layout in ("nhwc", "nchw"):
      base = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
      xk = base.to(dev).requires_grad_()
      xr = base.to(dev).requires_grad_()
      with CountPlainSpatialSoftmax(ss) as plain:
        torch.sum(ss.spatial_softmax(
            spatial_softmax_map(torch, xk, layout)) ** 2).backward()
      torch.sum(ss.spatial_softmax_reference(xr) ** 2).backward()
      err = float((xk.grad - xr.grad).abs().max())
      results.append({"case": "grad", "shape": list(shape), "layout": layout,
                      "max_abs_err": err, "atol": F32_ATOL,
                      "plain_calls": plain.cuda_calls})
      if not (err <= F32_ATOL and plain.cuda_calls == 0):
        raise AssertionError(f"spatial_softmax gradient disagrees: "
                             f"{results[-1]}")
  return results


def time_spatial_softmax(torch, ss, feature_map) -> list:
  """Kernel vs plain version on the feature map the conv tower gives it
  (its memory layout included), at batch 1 and 64, bf16 and f32.
  ``earlier_ms`` times the warp-per-(b, c) kernel, which served this map
  before the channel-group kernel, on the same map."""
  rows = []
  for batch in (1, BATCH):
    for dtype in (torch.bfloat16, torch.float32):
      x = feature_map[:batch].to(dtype)  # keeps the tower's strides
      got = ss.spatial_softmax(x)
      want = ss.spatial_softmax_reference(x)
      elements = x.numel()
      bytes_moved = (elements + batch * 2 * x.shape[3]) * x.element_size()
      bytes_ms = bytes_moved / _HBM_BYTES_PER_S * 1e3
      ops_ms = elements * _SPATIAL_SOFTMAX_OPS_PER_ELEMENT / _F32_FLOPS * 1e3
      rows.append({
          "shape": list(x.shape), "strides": list(x.stride()),
          "dtype": str(dtype)[6:],
          "kernel": ss._kernel_for(x.shape, x.stride()),
          "max_abs_err": float((got.float() - want.float()).abs().max()),
          "ms": device_ms(torch, lambda: ss.spatial_softmax(x)),
          "earlier_ms": device_ms(torch, lambda: ss._launch(x, 1.0, "warp")),
          "plain_ms": device_ms(
              torch, lambda: ss.spatial_softmax_reference(x)),
          "call_ms": host_ms(torch, lambda: ss.spatial_softmax(x)),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      })
  return rows


def attention_inputs(torch, dev, shape, dtype, layout, seed: int):
  """q, k, v (0.5 x normal, as tests/test_ops.py) and dout (normal).

  layout "strided": (B, T, 1, D) views into one (B, T, 4D) tensor, so the
  time stride is 4D and no input is contiguous. "dout_offset": dout is a
  column slice 16 bytes into wider rows, as a concat's gradient hands it
  over. "dout_stride0": dout has every stride 0, as ``out.sum()`` gives
  it (all ones)."""
  b, t, h, d = shape
  rng = np.random.default_rng(seed)
  if layout == "strided":
    wide = rng.standard_normal((b, t, 4 * d)).astype(np.float32)
    wide[..., :3 * d] *= 0.5
    wide = torch.from_numpy(wide).to(dev, dtype)
    return [wide[:, :, None, i * d:(i + 1) * d] for i in range(4)]
  arrays = [rng.standard_normal(shape).astype(np.float32) * s
            for s in (0.5, 0.5, 0.5, 1.0)]
  tensors = [torch.from_numpy(a).to(dev, dtype) for a in arrays]
  if layout == "dout_offset":
    offset = 16 // tensors[3].element_size()
    wide = torch.zeros((b, t, h, d + 2 * offset), dtype=dtype, device=dev)
    wide[..., offset:offset + d] = tensors[3]
    tensors[3] = wide[..., offset:offset + d]
  elif layout == "dout_stride0":
    tensors[3] = torch.ones((), dtype=dtype, device=dev).expand(shape)
  return tensors


def kernels_of(torch, dtype) -> dict:
  """The launch counts one forward + dq + dkv moves: bfloat16 runs K2-K4
  on the tensor cores, float32 on the CUDA cores."""
  if dtype == torch.bfloat16:
    return {"forward": 0, "dq": 0, "dkv": 0, "forward_tc": 1, "dq_tc": 1,
            "dkv_tc": 1}
  return {"forward": 1, "dq": 1, "dkv": 1, "forward_tc": 0, "dq_tc": 0,
          "dkv_tc": 0}


def flash_errors(torch, fa, q, k, v, dout, causal: bool) -> dict:
  """Each kernel against its plain version on the same inputs, through the
  kernels that own the dtype; raises past `flash_limit` (lse:
  FLASH_LSE_TOL) or if other kernels ran. Returns max |got - want| by
  output, and in "limit_share" the largest |got - want| / limit by output."""
  scale = 1.0 / np.sqrt(q.shape[-1])
  before = dict(fa.flash_attention.launches)
  out, lse = fa.flash_forward(q, k, v, causal, scale)
  delta = fa.flash_delta(out, dout)
  dq = fa.flash_dq(q, k, v, dout, lse, delta, causal, scale)
  dk, dv = fa.flash_dkv(q, k, v, dout, lse, delta, causal, scale)
  torch.cuda.synchronize()
  moved = {name: count - before[name]
           for name, count in fa.flash_attention.launches.items()}
  if moved != kernels_of(torch, q.dtype):
    raise AssertionError(f"flash kernels launched {moved} for {q.dtype}; "
                         f"want {kernels_of(torch, q.dtype)}")
  want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, scale)
  want_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, causal, scale)
  want_dk, want_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta,
                                            causal, scale)
  errors, shares = {}, {}
  for name, got, want in (("out", out, want_out), ("lse", lse, want_lse),
                          ("dq", dq, want_dq), ("dk", dk, want_dk),
                          ("dv", dv, want_dv)):
    if got.dtype != want.dtype or got.shape != want.shape:
      raise AssertionError(f"flash {name}: got {got.dtype} "
                           f"{tuple(got.shape)}, want {want.dtype} "
                           f"{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    if name == "lse":
      bound = FLASH_LSE_TOL["atol"] + FLASH_LSE_TOL["rtol"] * want.abs()
    else:
      bound = flash_limit(torch, want)
    errors[name] = float(diff.max())
    shares[name] = float((diff / bound).max())
    if not shares[name] <= 1.0:
      raise AssertionError(
          f"flash {name} disagrees with its plain version: max err "
          f"{errors[name]}, {shares[name]} times its limit at worst; shape "
          f"{tuple(q.shape)}, {q.dtype}, causal {causal}")
  return {**errors, "limit_share": shares}


def check_flash_attention(torch, fa, dev, seed: int) -> list:
  """Holds K2, K3 and K4 against their plain versions on every listed
  case, in float32 (TF32 off, the CUDA-core kernels) and bfloat16 (the
  tensor cores); then the autograd function against autograd of the plain
  reference, and its first-order rule. The last entry is the largest
  bf16 limit_share of each output over all cases."""
  path = (SNAIL_BATCH, SNAIL_SEQ, 1, SNAIL_KEY)
  cases = [(path, "contiguous"), (path, "strided"), (path, "dout_offset"),
           ((2, 2048, 4, 64), "contiguous"), ((2, 300, 1, 32), "strided"),
           ((2, 130, 2, 64), "dout_stride0"), ((2, 40, 2, 128), "dout_offset")]
  cases += [((2, t, 2, 64), "contiguous") for t in (1, 40, 128, 256, 1030)]
  cases += [((2, 256, 2, d), "contiguous") for d in (8, 16, 128)]
  results = []
  for shape, layout in cases:
    for dtype in (torch.float32, torch.bfloat16):
      for causal in (False, True):
        q, k, v, dout = attention_inputs(torch, dev, shape, dtype, layout,
                                         seed)
        errors = flash_errors(torch, fa, q, k, v, dout, causal)
        results.append({"shape": list(shape), "dtype": str(dtype)[6:],
                        "causal": causal, "layout": layout, **errors})

  # Autograd: K2 forward, K3 + K4 backward against torch's autograd
  # through the dense reference, float32.
  for shape in (path, (2, 1030, 2, 128)):
    q, k, v, dout = attention_inputs(torch, dev, shape, torch.float32,
                                     "contiguous", seed + 1)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    before = dict(fa.flash_attention.launches)
    got = torch.autograd.grad(fa.flash_attention(*leaves, causal=True),
                              leaves, dout)
    want = torch.autograd.grad(
        fa.flash_attention_reference(*leaves, causal=True), leaves, dout)
    moved = {name: count - before[name]
             for name, count in fa.flash_attention.launches.items()}
    if moved != kernels_of(torch, torch.float32):
      raise AssertionError("flash_attention's gradient did not launch K2, "
                           f"K3 and K4 once each: {moved}")
    errors = [float((a - b).abs().max()) for a, b in zip(got, want)]
    results.append({"case": "autograd", "shape": list(shape),
                    "max_abs_err": errors, "tol": FLASH_F32_TOL})
    for a, b in zip(got, want):
      if not torch.allclose(a, b, **FLASH_F32_TOL):
        raise AssertionError(f"flash_attention gradient disagrees: "
                             f"{results[-1]}")

  # First order only, like the JAX custom_vjp.
  q = torch.ones(1, 16, 1, 8, device=dev, requires_grad=True)
  (grad,) = torch.autograd.grad(fa.flash_attention(q, q, q).sum(), q,
                                create_graph=True)
  try:
    grad.sum().backward()
  except RuntimeError:
    results.append({"case": "second_order", "raises": True})
  else:
    raise AssertionError("a second-order gradient through flash_attention "
                         "did not raise")
  bf16 = [r["limit_share"] for r in results if r.get("dtype") == "bfloat16"]
  results.append({"case": "bf16_max_limit_share", **{
      name: max(shares[name] for shares in bf16) for name in bf16[0]}})
  return results


def time_flash_attention(torch, fa, dev, seed: int) -> dict:
  """K2, K3 and K4 at the path's shape (bf16, causal) beside their plain
  versions, their bounds, and PyTorch's SDPA as a yardstick. Each
  ``earlier_ms`` times the CUDA-core kernel that the tensor-core one
  replaced on the path, on the same bfloat16 inputs; ``stream_ms`` times
  back-to-back wrapper calls without a CUDA graph, so the host's work per
  call shows where it exceeds the kernel's."""
  b, t, h, d = SNAIL_BATCH, SNAIL_SEQ, 1, SNAIL_KEY
  q, k, v, dout = attention_inputs(torch, dev, (b, t, h, d), torch.bfloat16,
                                   "contiguous", seed)
  scale = 1.0 / np.sqrt(d)
  errors = flash_errors(torch, fa, q, k, v, dout, True)
  out, lse = fa.flash_forward(q, k, v, True, scale)
  delta = fa.flash_delta(out, dout)
  args = (q, k, v, dout, lse, delta, True, scale)

  # The causal triangle's (query, key) pairs; each product is 2 D FLOPs
  # a pair. Bytes: every input read once, every output written once.
  pairs = b * h * t * (t + 1) // 2
  tensor_bytes = b * t * h * d * q.element_size()
  row_bytes = b * h * t * 4

  def bound(products, tensors, rows):
    ops_ms = products * 2 * d * pairs / _BF16_FLOPS * 1e3
    bytes_ms = (tensors * tensor_bytes + rows * row_bytes) / (
        _HBM_BYTES_PER_S) * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": products * 2 * d * pairs}

  # SDPA takes (B, H, T, D); its backward is timed as forward + backward
  # less the forward (the two run in one captured graph).
  qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
  sdpa = torch.nn.functional.scaled_dot_product_attention
  leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
  sdpa_ms = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True),
                      inner=20)
  sdpa_both_ms = device_ms(torch, lambda: torch.autograd.grad(
      sdpa(*leaves, is_causal=True), leaves, dt), inner=20)
  # The CUDA-core kernels, launched directly: the wrappers route bf16 to
  # the tensor cores, so this is the only use of their bf16 forward and
  # dk/dv.
  earlier_out, earlier_lse = torch.empty_like(q), torch.empty_like(lse)
  earlier_dq_out = torch.empty_like(q)
  earlier_dk, earlier_dv = torch.empty_like(k), torch.empty_like(v)

  def earlier_forward():
    fa._launch("t2r_flash_forward", "forward", q, k, v, True, scale,
               o=earlier_out, lse=earlier_lse)

  def earlier_dq():
    fa._launch("t2r_flash_dq", "dq", q, k, v, True, scale, dout=dout,
               dq=earlier_dq_out, lse=lse, delta=delta)

  def earlier_dkv():
    fa._launch("t2r_flash_dkv", "dkv", q, k, v, True, scale, dout=dout,
               dk=earlier_dk, dv=earlier_dv, lse=lse, delta=delta)

  def forward():
    fa.flash_forward(q, k, v, True, scale)

  def dq():
    fa.flash_dq(*args)

  def dkv():
    fa.flash_dkv(*args)

  rows = {
      "forward": {
          "kernel": "flash_forward_tc_kernel",
          "ms": device_ms(torch, forward, inner=20),
          "stream_ms": stream_ms(torch, forward),
          "earlier_ms": device_ms(torch, earlier_forward, inner=20),
          "plain_ms": device_ms(torch, lambda: fa.flash_forward_reference(
              q, k, v, True, scale), inner=20),
          "library_ms": sdpa_ms,
          "max_abs_err": max(errors["out"], errors["lse"]),
          **bound(2, 4, 1)},
      "dq": {
          "kernel": "flash_dq_tc_kernel",
          "ms": device_ms(torch, dq, inner=20),
          "stream_ms": stream_ms(torch, dq),
          "earlier_ms": device_ms(torch, earlier_dq, inner=20),
          "plain_ms": device_ms(
              torch, lambda: fa.flash_dq_reference(*args), inner=20),
          "library_ms": sdpa_both_ms - sdpa_ms,
          "max_abs_err": errors["dq"],
          **bound(3, 5, 2)},
      "dkv": {
          "kernel": "flash_dkv_tc_kernel",
          "ms": device_ms(torch, dkv, inner=20),
          "stream_ms": stream_ms(torch, dkv),
          "earlier_ms": device_ms(torch, earlier_dkv, inner=20),
          "plain_ms": device_ms(
              torch, lambda: fa.flash_dkv_reference(*args), inner=20),
          "library_ms": sdpa_both_ms - sdpa_ms,
          "max_abs_err": max(errors["dk"], errors["dv"]),
          **bound(4, 6, 2)},
  }
  for row in rows.values():
    row.update(shape=[b, t, h, d], dtype="bfloat16", causal=True)
  rows["sdpa_forward_backward_ms"] = sdpa_both_ms
  return rows


def snail_stack(torch, dtype, use_flash: bool):
  """SNAIL's block pattern at the path's widths: 64 -> attention -> 128 ->
  TCBlock (11 dense blocks of 32) -> 480 -> attention -> 544 -> dense 1.
  Submodule names are flax's auto names, as the bridge expects."""
  import collections
  from tensor2robot_tpu_torch.layers import snail
  from tensor2robot_tpu_torch.layers.vision_layers import Dense
  first = snail.AttentionBlock(SNAIL_FEATURES, SNAIL_KEY, SNAIL_KEY, dtype,
                               use_flash)
  temporal = snail.TCBlock(first.out_features, SNAIL_SEQ, SNAIL_FILTERS,
                           dtype)
  second = snail.AttentionBlock(temporal.out_features, SNAIL_KEY, SNAIL_KEY,
                                dtype, use_flash)
  # flax's Dense(1) on bf16 activations and f32 parameters computes in f32.
  head = Dense(second.out_features, 1, torch.float32)
  return torch.nn.Sequential(collections.OrderedDict([
      ("AttentionBlock_0", first), ("TCBlock_0", temporal),
      ("AttentionBlock_1", second), ("Dense_0", head)]))


def train_snail(torch, stack, x, target, steps: int):
  """`steps` Adam steps (create_adam_optimizer's defaults: lr 1e-4) on the
  mean squared error. Returns the loss before each step and the step
  times in ms (host clock around a synchronised step)."""
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  optimizer = create_adam_optimizer()(stack.parameters())
  losses, step_ms = [], []
  for _ in range(steps):
    torch.cuda.synchronize()
    start = time.perf_counter()
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((stack(x) - target) ** 2)
    loss.backward()
    optimizer.step()
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - start) * 1e3)
    losses.append(float(loss.detach()))
  return losses, step_ms


def final_loss(torch, stack, x, target) -> float:
  with torch.no_grad():
    out = stack(x)
  if out.shape != target.shape or not bool(torch.isfinite(out).all()):
    raise AssertionError(f"SNAIL stack output {tuple(out.shape)} is not "
                         "finite or has the wrong shape")
  return float(torch.mean((out - target) ** 2))


def run_snail_slice(torch, fa, dev, seed: int) -> dict:
  """Slice 2's main path: 20 Adam steps of the stack with the flash core
  (K2 twice a step forward, K3 and K4 twice a step backward; K2 and K4 on
  the tensor cores, in bfloat16), then the same 20 steps from the same
  weights with the dense core."""
  from tensor2robot_tpu_torch.models.abstract_model import flax_default_init_
  flash = snail_stack(torch, torch.bfloat16, use_flash=True)
  flax_default_init_(flash, torch.Generator().manual_seed(seed))
  dense = snail_stack(torch, torch.bfloat16, use_flash=False)
  dense.load_state_dict(flash.state_dict())
  flash.to(dev)
  dense.to(dev)
  rng = np.random.default_rng(seed + 2)
  x = torch.from_numpy(rng.standard_normal(
      (SNAIL_BATCH, SNAIL_SEQ, SNAIL_FEATURES)).astype(np.float32)).to(dev)
  target = torch.from_numpy(rng.standard_normal(
      (SNAIL_BATCH, SNAIL_SEQ, 1)).astype(np.float32)).to(dev)

  for name in fa.flash_attention.launches:
    fa.flash_attention.launches[name] = 0
  torch.cuda.reset_peak_memory_stats()
  flash_losses, flash_ms = train_snail(torch, flash, x, target, TRAIN_STEPS)
  launches = dict(fa.flash_attention.launches)
  flash_peak = torch.cuda.max_memory_allocated()
  want = {name: 2 * TRAIN_STEPS * count
          for name, count in kernels_of(torch, torch.bfloat16).items()}
  if launches != want:
    raise AssertionError(f"flash kernels launched {launches} times in "
                         f"{TRAIN_STEPS} steps; want {want}")
  flash_losses.append(final_loss(torch, flash, x, target))

  torch.cuda.reset_peak_memory_stats()
  dense_losses, dense_ms = train_snail(torch, dense, x, target, TRAIN_STEPS)
  dense_peak = torch.cuda.max_memory_allocated()
  dense_losses.append(final_loss(torch, dense, x, target))

  if not all(np.isfinite(flash_losses)) or not (
      flash_losses[-1] < flash_losses[0]):
    raise AssertionError(f"the loss did not fall: {flash_losses}")
  rel = [abs(a - b) / abs(b) for a, b in zip(flash_losses, dense_losses)]
  if not max(rel) <= LOSS_RTOL:
    raise AssertionError(f"flash and dense loss streams differ by "
                         f"{max(rel)} relative: {flash_losses} vs "
                         f"{dense_losses}")
  return {
      "shape": [SNAIL_BATCH, SNAIL_SEQ, SNAIL_FEATURES], "steps": TRAIN_STEPS,
      "compute_dtype": "bfloat16",
      "parameters": sum(p.numel() for p in flash.parameters()),
      "launches": launches, "losses_flash": flash_losses,
      "losses_dense": dense_losses, "max_rel_loss_diff": max(rel),
      "loss_rtol": LOSS_RTOL,
      "step_ms_flash": float(np.median(flash_ms[1:])),
      "step_ms_dense": float(np.median(dense_ms[1:])),
      "first_step_ms_flash": flash_ms[0], "first_step_ms_dense": dense_ms[0],
      "peak_mib_flash": flash_peak / 2 ** 20,
      "peak_mib_dense": dense_peak / 2 ** 20,
  }


def write_export(torch, model, root: str, seed: int) -> str:
  """Random weights, with random BN statistics and biases (init's zeros
  and ones would hide a swapped mapping), written as a native export:
  <root>/<version>/variables.npz plus its JSON spec asset. Returns the
  weights as a state_dict on the CPU."""
  from tensor2robot_tpu_torch import bridge
  from tensor2robot_tpu_torch.export import export_utils, variables_io
  rng = np.random.default_rng(seed)
  variables = model.init_variables(torch.Generator().manual_seed(seed),
                                   device="cpu")
  for key, value in variables.items():
    if key.endswith("running_var"):
      fresh = rng.uniform(0.5, 2.0, tuple(value.shape))
    elif value.dim() == 1:  # biases, norm scales, running means
      fresh = value.numpy() + 0.2 * rng.standard_normal(tuple(value.shape))
    else:
      continue
    value.copy_(torch.from_numpy(fresh.astype(np.float32)))
  export_dir = os.path.join(root, "1")
  os.makedirs(export_dir)
  variables_io.save_variables(
      os.path.join(export_dir, export_utils.VARIABLES_NPZ),
      bridge.state_dict_to_variables(variables))
  image = {"shape": [64, 64, 3], "dtype": "float32", "name": "image",
           "is_optional": False, "is_sequence": False, "data_format": None,
           "dataset_key": "", "varlen_default_value": None}
  with open(os.path.join(export_dir, export_utils.SPEC_ASSET_NAME), "w") as f:
    json.dump({"feature_spec": {"version": 1, "specs": {"image": image}},
               "label_spec": None, "extra": {"feature_keys": ["image"]},
               "global_step": 0}, f)
  return variables


def env_batch(seed: int) -> np.ndarray:
  from tensor2robot_tpu_torch.research.pose_env.pose_env import PoseEnv
  env = PoseEnv(seed=seed)
  return np.stack([env.reset()["image"] for _ in range(BATCH)]).astype(
      np.float32) / 255.0


def reset_spatial_softmax_counts(ss) -> None:
  ss.spatial_softmax.launches = 0
  for name in ss.spatial_softmax.launches_by_kernel:
    ss.spatial_softmax.launches_by_kernel[name] = 0


class CountPlainSpatialSoftmax:
  """While installed, counts the calls of K1's plain version on CUDA
  tensors (the module's global, which the autograd function looks up)."""

  def __init__(self, ss):
    self._ss = ss
    self._plain = ss.spatial_softmax_reference
    self.cuda_calls = 0

  def __enter__(self):
    def counted(features, temperature=1.0):
      self.cuda_calls += features.is_cuda
      return self._plain(features, temperature)
    self._ss.spatial_softmax_reference = counted
    return self

  def __exit__(self, *exc):
    self._ss.spatial_softmax_reference = self._plain
    return False


def trace_summary(trace_path: str, steps: int, wall_ms: float,
                  match: str = r"spatial_softmax\w*") -> dict:
  """Device time, kernel launches and idle share per step of a chrome
  trace of `steps` steps over `wall_ms`, and the device time of the
  kernels whose names match `match`, by kernel."""
  import collections
  import re
  with open(trace_path) as f:
    events = json.load(f)["traceEvents"]
  device_us, launches = 0.0, 0
  by_kernel, matched = collections.Counter(), collections.Counter()
  for event in events:
    category = event.get("cat", "")
    if category in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in event:
      name = event.get("name", "?")
      device_us += float(event["dur"])
      by_kernel[name[:80]] += float(event["dur"])
      found = re.search(match, name)
      if found:
        matched[found.group(0)] += float(event["dur"])
    launches += category == "kernel"
  device_ms = device_us / 1e3
  return {
      "device_ms_per_step": device_ms / steps,
      "matched_ms_per_step": {name: us / 1e3 / steps
                              for name, us in matched.items()},
      "kernels_per_step": launches / steps,
      "device_idle_share": (1.0 - device_ms / wall_ms) if device_us else None,
      "top_device_ms_per_step": {
          name: us / 1e3 / steps for name, us in by_kernel.most_common(8)},
  }


def pose_batches(preprocessor, images, poses, steps: int, rng):
  """The JAX check_vrgripper's sampler: `steps` batches of BATCH episodes
  drawn without replacement from `rng`, through the model's preprocessor
  in TRAIN mode on the host."""
  from tensor2robot_tpu_torch import modes
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  for _ in range(steps):
    idx = rng.choice(len(images), BATCH, replace=False)
    yield preprocessor.preprocess(
        ts.TensorSpecStruct({"image": images[idx]}),
        ts.TensorSpecStruct({"target_pose": poses[idx]}), modes.TRAIN)


def profile_steps(torch, trainer, state, batches, out_dir: str,
                  name: str):
  """A torch.profiler trace of one train step per batch (after three
  unprofiled ones); returns the state and the trace's summary."""
  for features, labels in batches[:3]:
    state, _ = trainer.train_step(state, features, labels)
  steps = len(batches) - 3
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for features, labels in batches[3:]:
      state, _ = trainer.train_step(state, features, labels)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
  path = os.path.join(out_dir, f"{name}.json")
  prof.export_chrome_trace(path)
  return state, {"profiled_step_ms": wall_ms / steps,
                 **trace_summary(path, steps, wall_ms)}


def training_feature_map(torch, model, state, features):
  """The conv tower's TRAIN-mode output on `features`, in the layout the
  train step hands K1 (on copies of the running statistics)."""
  variables = state.variables()
  tower = {key.split(".", 1)[1]: value.detach().clone()
           for key, value in variables.items() if key.startswith("tower.")}
  with torch.no_grad():
    return torch.func.functional_call(
        model.module.tower, tower, (features["image"],), {"train": True})


def run_pose_training(torch, ss, dev, seed: int, root: str) -> dict:
  """Slice 5's main path: BASELINE config #1 trained through ``Trainer``
  (K1 forward once a step, its gradient analytic), exported, restored and
  driven through ``evaluate_policy`` on the GPU; the reach bar must hold.
  Then 10 profiled steps."""
  from tensor2robot_tpu_torch.data.prefetch import prefetch_to_device
  from tensor2robot_tpu_torch.export import export_utils
  from tensor2robot_tpu_torch.export.native_export_generator import (
      NativeExportGenerator,
  )
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.pose_env import (
      PoseEnvRegressionModel,
      evaluate_policy,
  )
  from tensor2robot_tpu_torch.research.pose_env.pose_env import (
      collect_episodes,
  )
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  start = time.perf_counter()
  model = PoseEnvRegressionModel(optimizer_fn=create_adam_optimizer(POSE_LR))
  images, poses = collect_episodes(POSE_EPISODES, seed=0)
  collect_s = time.perf_counter() - start
  trainer = Trainer(model, seed=seed)
  state = trainer.create_train_state()
  if trainer.device.type != dev.type:
    raise AssertionError(f"the trainer runs on {trainer.device}")
  batches = prefetch_to_device(
      pose_batches(model.preprocessor, images, poses, POSE_STEPS,
                   np.random.default_rng(1)), device=dev)
  reset_spatial_softmax_counts(ss)
  losses, step_ms = [], []
  train_start = time.perf_counter()
  with CountPlainSpatialSoftmax(ss) as plain:
    for step, (features, labels) in enumerate(batches):
      if step == 100:
        torch.cuda.reset_peak_memory_stats()
      torch.cuda.synchronize()
      begin = time.perf_counter()
      state, metrics = trainer.train_step(state, features, labels)
      torch.cuda.synchronize()
      step_ms.append((time.perf_counter() - begin) * 1e3)
      losses.append(float(metrics["loss"]))
  train_s = time.perf_counter() - train_start
  peak = torch.cuda.max_memory_allocated()
  launches = ss.spatial_softmax.launches
  by_kernel = dict(ss.spatial_softmax.launches_by_kernel)
  if state.step != POSE_STEPS or launches != POSE_STEPS:
    raise AssertionError(f"{state.step} steps launched K1 {by_kernel}; want "
                         f"{POSE_STEPS} steps and one forward launch each")
  if plain.cuda_calls:
    raise AssertionError(f"training called K1's plain version on the GPU "
                         f"{plain.cuda_calls} times")
  if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
    raise AssertionError(f"the loss did not fall: {losses[:3]} ... "
                         f"{losses[-3:]}")
  feature_map = training_feature_map(torch, model, state, features)
  map_kernel = ss._kernel_for(feature_map.shape, feature_map.stride())
  if by_kernel[map_kernel] != POSE_STEPS:
    raise AssertionError(f"training launched {by_kernel}; its map "
                         f"{tuple(feature_map.stride())} takes {map_kernel}")

  generator = NativeExportGenerator(os.path.join(root, "pose_exports"))
  generator.set_specification_from_model(model)
  export_dir = export_utils.export_and_gc(
      generator, export_utils.fetch_variables_to_host(
          state.variables(use_ema=True)), keep=1, global_step=state.step)
  predictor = ExportedModelPredictor(model, generator.export_root)
  if not (predictor.restore() and predictor.device.type == dev.type
          and predictor.model_version == int(os.path.basename(export_dir))):
    raise AssertionError(f"the predictor did not load {export_dir} on {dev}")
  reset_spatial_softmax_counts(ss)
  reach_start = time.perf_counter()
  reach = evaluate_policy(predictor, num_episodes=REACH_EPISODES,
                          seed=REACH_SEED, success_threshold=REACH_THRESHOLD,
                          extra_thresholds=(0.10,))
  reach_s = time.perf_counter() - reach_start
  served = dict(ss.spatial_softmax.launches_by_kernel)
  if ss.spatial_softmax.launches != REACH_EPISODES:
    raise AssertionError(f"{REACH_EPISODES} requests launched K1 {served}")

  extra = [next(pose_batches(model.preprocessor, images, poses, 1,
                             np.random.default_rng(2 + i)))
           for i in range(PROFILED_STEPS + 3)]
  extra = list(prefetch_to_device(iter(extra), device=dev))
  state, profile = profile_steps(torch, trainer, state, extra, root,
                                 "pose_training")
  result = {
      "episodes": POSE_EPISODES, "steps": POSE_STEPS, "batch": BATCH,
      "learning_rate": POSE_LR, "compute_dtype": "bfloat16",
      "parameters": sum(p.numel() for p in state.params.values()),
      "first_loss": losses[0], "last_loss": losses[-1],
      "step_ms_median_100_1499": float(np.median(step_ms[100:])),
      "first_step_ms": step_ms[0],
      "device_ms_per_step": profile["device_ms_per_step"],
      "kernels_per_step": profile["kernels_per_step"],
      "device_idle_share_profiled": profile["device_idle_share"],
      "device_idle_share_of_step": 1.0 - profile["device_ms_per_step"] / (
          float(np.median(step_ms[100:]))),
      "k1_ms_per_step": profile["matched_ms_per_step"],
      "top_device_ms_per_step": profile["top_device_ms_per_step"],
      "peak_mib_steps_100_1499": peak / 2 ** 20,
      "k1_launches_training": by_kernel, "k1_launches_served": served,
      "k1_plain_calls_on_gpu": plain.cuda_calls,
      "training_map_strides": list(feature_map.stride()),
      "training_map_kernel": map_kernel,
      "success_rate": reach["success_rate"],
      "success_rate_at_0.1": reach["success_rate_at_0.1"],
      "mean_reward": reach["mean_reward"], "reach_bar": REACH_BAR,
      "collect_s": collect_s, "train_s": train_s, "reach_s": reach_s,
      "seconds": time.perf_counter() - start,
  }
  emit("pose_train", **result)
  if not reach["success_rate"] >= REACH_BAR:
    raise AssertionError(f"reach success {reach['success_rate']} within "
                         f"{REACH_THRESHOLD} is under {REACH_BAR}")
  return {**result, "feature_map": feature_map, "images": images,
          "poses": poses}


def copy_train_state(torch, src, dst):
  """`dst` with `src`'s step, parameters, Adam moments and statistics, on
  `dst`'s device."""
  import dataclasses
  device = next(iter(dst.params.values())).device
  with torch.no_grad():
    for key, param in dst.params.items():
      param.copy_(src.params[key])
  dst.opt_state.load_state_dict(src.opt_state.state_dict())
  return dataclasses.replace(dst, step=src.step, model_state={
      key: value.to(device, copy=True)
      for key, value in src.model_state.items()})


def adam_reference(torch, old, grad, moments, step: int, lr: float):
  """The parameter after Adam's step (optax's and torch's rule, b1 0.9, b2
  0.999, eps 1e-8 outside the root) in float64, from the moments before
  it (None before the first step)."""
  g = grad.double()
  m_prev, v_prev = ((0.0, 0.0) if moments is None else
                    (moments["exp_avg"].double(),
                     moments["exp_avg_sq"].double()))
  m = 0.9 * m_prev + 0.1 * g
  v = 0.999 * v_prev + 0.001 * g * g
  return old.double() - lr * (m / (1 - 0.9 ** step)) / (
      (v / (1 - 0.999 ** step)).sqrt() + 1e-8)


def pose_train_f32(torch, dev, seed: int, images, poses) -> dict:
  """TRAIN_F32_STEPS float32 steps (TF32 off) from one init on the GPU and
  on the CPU, in lockstep on the same batches: losses, running
  statistics, gradients and Adam's updates (see GRAD_NOISE_SHARE)."""
  import copy
  import dataclasses
  from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  model = PoseEnvRegressionModel(compute_dtype=torch.float32,
                                 optimizer_fn=create_adam_optimizer(POSE_LR))
  batches = list(pose_batches(model.preprocessor, images, poses,
                              TRAIN_F32_STEPS, np.random.default_rng(3)))
  tf32 = (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  trainers = [Trainer(model, seed=seed, device=device)
              for device in (dev, torch.device("cpu"))]
  gpu, cpu = (trainer.create_train_state() for trainer in trainers)
  report = {"steps": TRAIN_F32_STEPS, "tf32": False, "losses_gpu": [],
            "losses_cpu": [], "max_rel_loss_diff": 0.0,
            "loss_rtol": TRAIN_F32_RTOL, "stats_max_abs_err": 0.0,
            "atol": TRAIN_F32_ATOL, "grad_err_share": {},
            "grad_noise_share": GRAD_NOISE_SHARE, "adam_max_abs_err": 0.0,
            "adam_atol": ADAM_ATOL, "param_max_abs_diff": 0.0}
  for batch in batches:
    # The GPU side starts from the CPU's state (moments copied, not shared).
    with torch.no_grad():
      for key, param in gpu.params.items():
        param.copy_(cpu.params[key])
    gpu.opt_state.load_state_dict(copy.deepcopy(cpu.opt_state.state_dict()))
    gpu = dataclasses.replace(gpu, step=cpu.step, model_state={
        key: value.to(dev, copy=True)
        for key, value in cpu.model_state.items()})
    before = {key: param.detach().clone() for key, param in
              cpu.params.items()}
    moments = {key: copy.deepcopy(cpu.opt_state.state.get(param))
               for key, param in cpu.params.items()}
    runs = []
    for trainer, state in zip(trainers, (gpu, cpu)):
      features, labels = (ts.TensorSpecStruct(
          (k, torch.from_numpy(v).to(trainer.device)) for k, v in tree.items())
                          for tree in batch)
      state, metrics = trainer.train_step(state, features, labels)
      runs.append((state, float(metrics["loss"])))
    (gpu, gpu_loss), (cpu, cpu_loss) = runs
    report["losses_gpu"].append(gpu_loss)
    report["losses_cpu"].append(cpu_loss)
    report["max_rel_loss_diff"] = max(report["max_rel_loss_diff"],
                                      abs(gpu_loss - cpu_loss) / cpu_loss)
    for key, value in cpu.model_state.items():
      report["stats_max_abs_err"] = max(report["stats_max_abs_err"], float(
          (gpu.model_state[key].cpu() - value).abs().max()))
    for key, param in cpu.params.items():
      gpu_param = gpu.params[key].detach().cpu()
      gpu_grad = gpu.params[key].grad.cpu()
      if key not in BN_FED_BIASES:
        share = float((gpu_grad - param.grad).abs().max()
                      / param.grad.abs().max())
        report["grad_err_share"][key] = max(
            share, report["grad_err_share"].get(key, 0.0))
      for new, grad in ((gpu_param, gpu_grad), (param.detach(), param.grad)):
        want = adam_reference(torch, before[key], grad, moments[key],
                              cpu.step, POSE_LR)
        report["adam_max_abs_err"] = max(report["adam_max_abs_err"], float(
            (new.double() - want).abs().max()))
      report["param_max_abs_diff"] = max(report["param_max_abs_diff"], float(
          (gpu_param - param.detach()).abs().max()))
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
      tf32)
  if not (report["max_rel_loss_diff"] <= TRAIN_F32_RTOL
          and report["stats_max_abs_err"] <= TRAIN_F32_ATOL
          and max(report["grad_err_share"].values()) <= GRAD_NOISE_SHARE
          and report["adam_max_abs_err"] <= ADAM_ATOL):
    raise AssertionError(f"GPU and CPU training disagree: {report}")
  return report


def run_train_eval(torch, dev, seed: int, root: str) -> dict:
  """The normal entry point end to end on the GPU: train_eval_model over
  a DefaultRandomInputGenerator with the pose model's specs, 20 steps,
  2 eval batches, a final export that the predictor loads."""
  from tensor2robot_tpu_torch.data.default_input_generator import (
      DefaultRandomInputGenerator,
  )
  from tensor2robot_tpu_torch.export.native_export_generator import (
      NativeExportGenerator,
  )
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
  from tensor2robot_tpu_torch.train.train_eval import train_eval_model
  start = time.perf_counter()
  model = PoseEnvRegressionModel()
  generator = NativeExportGenerator(os.path.join(root, "train_eval_exports"))
  result = train_eval_model(
      model,
      input_generator_train=DefaultRandomInputGenerator(batch_size=BATCH,
                                                        seed=seed),
      input_generator_eval=DefaultRandomInputGenerator(batch_size=BATCH,
                                                       seed=seed + 1),
      max_train_steps=20, eval_steps=2, log_every_steps=10,
      export_generator=generator)
  if result.state.step != 20 or not result.export_dir or not os.path.isdir(
      result.export_dir):
    raise AssertionError(f"train_eval_model: step {result.state.step}, "
                         f"export {result.export_dir}")
  predictor = ExportedModelPredictor(model, generator.export_root)
  if not predictor.restore() or predictor.device.type != dev.type:
    raise AssertionError("the predictor did not load the train_eval export")
  images = env_batch(seed + 4)
  served = predictor.predict({"image": images})["inference_output"]
  with torch.inference_mode():
    direct = model.predict_fn(
        result.state.variables(),
        {"image": torch.from_numpy(images).to(predictor.device)})[
            "inference_output"].float().cpu().numpy()
  err = float(np.abs(served - direct).max())
  if not (np.isfinite(served).all() and err <= SERVE_F32_ATOL):
    raise AssertionError(f"the export serves {err} away from the trained "
                         "state")
  return {"steps": result.state.step, "train_metrics": result.train_metrics,
          "eval_metrics": result.eval_metrics,
          "export": sorted(os.listdir(result.export_dir)),
          "served_vs_trained_max_abs_err": err,
          "seconds": time.perf_counter() - start}


class LoopStats(logging.Handler):
  """Collects the train loop's timing records and its resume messages."""

  def __init__(self):
    super().__init__()
    self.loop_stats, self.messages = [], []

  def emit(self, record):
    if hasattr(record, "loop_stats"):
      self.loop_stats.append(record.loop_stats)
    self.messages.append(record.getMessage())


def crc_rates() -> dict:
  """MB/s of the host library's CRC and the plain Python loop on 1 MB,
  and the seconds the library took to build (outside the timing)."""
  from tensor2robot_tpu_torch.data import tfrecord
  data = np.random.default_rng(0).integers(0, 256, 1 << 20,
                                           np.uint8).tobytes()
  start = time.perf_counter()
  tfrecord.masked_crc32c(b"")  # builds and loads the library
  build_s = time.perf_counter() - start
  start = time.perf_counter()
  want = tfrecord.masked_crc32c_reference(data)
  python_s = time.perf_counter() - start
  reps, start = 100, time.perf_counter()
  for _ in range(reps):
    got = tfrecord.masked_crc32c(data)
  library_s = (time.perf_counter() - start) / reps
  if got != want:
    raise AssertionError(f"the CRC library gives {got}, Python {want}")
  return {"crc_library_mb_per_s": 1.0 / library_s,
          "crc_python_mb_per_s": 1.0 / python_s,
          "crc_library_build_s": build_s}


def parse_rate(path: str, threads: int = 4) -> float:
  """Records a second of the record generator alone (read, CRC, parse,
  `threads` parser threads), one pass at batch BATCH."""
  from tensor2robot_tpu_torch import modes
  from tensor2robot_tpu_torch.data.default_input_generator import (
      DefaultRecordInputGenerator,
  )
  from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
  generator = DefaultRecordInputGenerator(path, batch_size=BATCH,
                                          num_pipeline_threads=threads)
  preprocessor = PoseEnvRegressionModel().preprocessor
  generator.set_specification(
      preprocessor.get_in_feature_specification(modes.TRAIN),
      preprocessor.get_in_label_specification(modes.TRAIN))
  start = time.perf_counter()
  batches = sum(1 for _ in generator.create_dataset_fn(modes.EVAL)())
  return batches * BATCH / (time.perf_counter() - start)


def run_pose_records(torch, ss, gl, dev, seed: int, root: str) -> dict:
  """Slice 6's main path at one seed: BASELINE config #1 as its users run
  it. Write 2000 episodes as jpeg TFRecords with the port, train through
  the port's CLI and config (two calls into one model_dir, the second
  resuming at RECORD_HALF on the GPU) with iterations_per_loop=50, as the
  JAX check trains (so from slice 7 each call's 50-step stacks after the
  first are CUDA graph replays), serve model_dir/export/latest to the
  reach bar, and serve records through predict_examples."""
  from tensor2robot_tpu_torch import config, modes
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.data.parser import ExampleParser
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.pose_env import (
      PoseEnvRegressionModel,
      evaluate_policy,
  )
  from tensor2robot_tpu_torch.research.pose_env.pose_env import (
      write_tfrecords,
  )
  start = time.perf_counter()
  records = os.path.join(root, f"train-{seed}.tfrecord")
  write_tfrecords(records, POSE_EPISODES, seed=seed)
  write_s = time.perf_counter() - start
  result = {"seed": seed, "episodes": POSE_EPISODES, "write_s": write_s}
  if seed == RECORD_SEEDS[0]:
    import hashlib
    digest = hashlib.sha256()
    for _, record in zip(range(16), tfrecord.read_tfrecords(records)):
      digest.update(record)
    result["sha256_first_16_records"] = digest.hexdigest()
    result["parser_records_per_s_4_threads"] = parse_rate(records)

  model_dir = os.path.join(root, f"run-{seed}")
  handler = LoopStats()
  loop_logger = logging.getLogger("tensor2robot_tpu_torch.train.train_eval")
  loop_logger.addHandler(handler)
  level = loop_logger.level
  loop_logger.setLevel(logging.INFO)
  reset_spatial_softmax_counts(ss)
  train_start = time.perf_counter()
  try:
    with CountPlainSpatialSoftmax(ss) as plain, CountReplays(gl) as replays:
      for steps in (RECORD_HALF, POSE_STEPS):
        config.clear_config()
        run_t2r_trainer.main([
            "--config", os.path.join(_ROOT, RECORD_CFG),
            "--import_module",
            "tensor2robot_tpu_torch.research.pose_env.pose_env_models",
            "--binding",
            f'DefaultRecordInputGenerator.file_patterns = "{records}"',
            "--binding", f"DefaultRecordInputGenerator.seed = {seed + 1}",
            "--binding", f"train_eval_model.seed = {seed}",
            "--binding", f"train_eval_model.max_train_steps = {steps}",
            "--binding",
            f"train_eval_model.iterations_per_loop = {GRAPH_STEPS}",
            "--model_dir", model_dir, "--device", dev.type])
  finally:
    loop_logger.removeHandler(handler)
    loop_logger.setLevel(level)
    config.clear_config()
  train_s = time.perf_counter() - train_start
  launches = dict(ss.spatial_softmax.launches_by_kernel)
  if ss.spatial_softmax.launches != POSE_STEPS:
    raise AssertionError(f"{POSE_STEPS} steps launched K1 {launches}")
  if plain.cuda_calls:
    raise AssertionError(f"training called K1's plain version on the GPU "
                         f"{plain.cuda_calls} times")
  first, second = handler.loop_stats
  taken = tuple(stats["steps"] * stats["steps_per_dispatch"]
                for stats in (first, second))
  if taken != (RECORD_HALF, POSE_STEPS - RECORD_HALF):
    raise AssertionError(f"the calls took {taken} steps")
  # Each call's first stack runs eagerly (the warm-up), the rest replay.
  want_replays = POSE_STEPS // GRAPH_STEPS - 2
  if replays.replays != want_replays:
    raise AssertionError(f"{replays.replays} graph replays; want "
                         f"{want_replays}")
  if f"Resumed from step {RECORD_HALF}" not in handler.messages:
    raise AssertionError(f"the second call did not resume at {RECORD_HALF}")
  saved = sorted(int(name) for name in os.listdir(
      os.path.join(model_dir, "checkpoints")))
  if saved != [500, RECORD_HALF, 1000, POSE_STEPS]:
    raise AssertionError(f"checkpoint steps {saved}")
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    logged = sorted(json.loads(line)["step"] for line in f)
  if logged != sorted(list(range(100, POSE_STEPS + 1, 100)) + [RECORD_HALF]):
    raise AssertionError(f"metrics.jsonl has steps {logged}")
  if not os.path.isfile(os.path.join(model_dir, "operative_config.txt")):
    raise AssertionError("no operative_config.txt")

  model = PoseEnvRegressionModel()
  predictor = ExportedModelPredictor(
      model, os.path.join(model_dir, "export", "latest"), device=dev)
  if not predictor.restore() or predictor.device.type != dev.type:
    raise AssertionError("the predictor did not load the run's export")
  reset_spatial_softmax_counts(ss)
  reach = evaluate_policy(predictor, num_episodes=REACH_EPISODES,
                          seed=REACH_SEED, success_threshold=REACH_THRESHOLD,
                          extra_thresholds=(0.10,))
  # Records of another seed, served as a robot's log through
  # predict_examples, against predict on the parser's own arrays.
  served_path = os.path.join(root, f"served-{seed}.tfrecord")
  write_tfrecords(served_path, SERVED_RECORDS, seed=100 + seed)
  served = list(tfrecord.read_tfrecords(served_path))
  got = predictor.predict_examples(served)["inference_output"]
  preprocessor = model.preprocessor
  features, _ = ExampleParser(preprocessor.get_in_feature_specification(
      modes.PREDICT)).parse_batch(served)
  features, _ = preprocessor.preprocess(features, None, modes.PREDICT)
  want = predictor.predict(features)["inference_output"]
  if ss.spatial_softmax.launches != REACH_EPISODES + 2:
    raise AssertionError(f"serving launched K1 "
                         f"{ss.spatial_softmax.launches_by_kernel}")
  if not (got.shape == (SERVED_RECORDS, 2) and np.isfinite(got).all()
          and np.array_equal(got, want)):
    raise AssertionError("predict_examples disagrees with predict")
  result.update({
      "steps": POSE_STEPS, "resumed_at": RECORD_HALF, "checkpoints": saved,
      "k1_launches_training": launches,
      "k1_launches_served": dict(ss.spatial_softmax.launches_by_kernel),
      "k1_plain_calls_on_gpu": plain.cuda_calls,
      "step_ms_median": float(np.median([first["step_ms_median"],
                                         second["step_ms_median"]]))
                        / GRAPH_STEPS,
      "dispatch_ms_median": float(np.median([first["step_ms_median"],
                                             second["step_ms_median"]])),
      "steps_per_dispatch": GRAPH_STEPS, "graph_replays": replays.replays,
      "k1_launches_from_replays": replays.launches,
      "loop_stats": [first, second],
      "input_wait_ms_median": float(np.median(
          [first["input_wait_ms_median"], second["input_wait_ms_median"]]))
                              / GRAPH_STEPS,
      "input_wait_share": (first["input_wait_share"]
                           + second["input_wait_share"]) / 2,
      "success_rate": reach["success_rate"],
      "success_rate_at_0.1": reach["success_rate_at_0.1"],
      "reach_bar": REACH_BAR, "predict_examples_equal": True,
      "train_s": train_s, "seconds": time.perf_counter() - start,
  })
  emit("pose_records", **result)
  if not reach["success_rate"] >= REACH_BAR:
    raise AssertionError(f"seed {seed}: reach success "
                         f"{reach['success_rate']} within {REACH_THRESHOLD} "
                         f"is under {REACH_BAR}")
  return result


class CountReplays:
  """While installed, counts CUDA graph replays and the kernel launches
  they add, by kernel (the trainer adds them through
  ``graph_launches.replayed``)."""

  def __init__(self, graph_launches):
    self._module = graph_launches
    self._replayed = graph_launches.replayed
    self.replays = 0
    self.launches = {}

  def __enter__(self):
    def counted(tally, times=1):
      self.replays += times
      for (_, kernel), n in tally.items():
        self.launches[kernel] = self.launches.get(kernel, 0) + n * times
      self._replayed(tally, times)
    self._module.replayed = counted
    return self

  def __exit__(self, *exc):
    self._module.replayed = self._replayed
    return False


def state_diff(torch, a, b) -> dict:
  """The largest |a - b| of two train states on one device, by part:
  parameters, optimizer moments (and step counts), EMA, statistics."""
  def largest(pairs):
    return max((float((x.detach().float() - y.detach().float()).abs().max())
                for x, y in pairs), default=0.0)
  moments = []
  for name, param in a.params.items():
    mine, theirs = a.opt_state.state[param], b.opt_state.state[b.params[name]]
    moments += [(mine[key], theirs[key]) for key in mine
                if torch.is_tensor(mine[key])]
  return {
      "params": largest((a.params[k], b.params[k]) for k in a.params),
      "moments": largest(moments),
      "ema": largest((a.ema_params[k], b.ema_params[k])
                     for k in (a.ema_params or {})),
      "statistics": largest((a.model_state[k], b.model_state[k])
                            for k in a.model_state),
  }


def stacked(torch, batches, dev):
  """(features, labels) numpy batches -> K-stacked tensors on `dev`."""
  from tensor2robot_tpu_torch.utils.tree import tree_map
  return tree_map(lambda *leaves: torch.from_numpy(np.stack(leaves)).to(dev),
                  *batches)


def graph_vs_eager(torch, ss, gl, model, dev, seed: int, warm, stack,
                   out_dir: str, name: str, profiled: bool = True) -> dict:
  """One K-stack trained as one ``train_steps`` CUDA graph and as K eager
  ``train_step`` calls from the same state (after the same warm-up
  steps, which the graphed trainer runs eagerly on its side stream): the
  two states and the last step's metrics must agree bit for bit (cuDNN
  deterministic). Then times both: host clock per step, device time per
  step (CUDA events around a replay; with `profiled`, the profiler over
  10 eager steps), kernels per step, idle share, peak memory, and the
  profiler's view of one replay; and counts K1's launches through the
  replays."""
  from tensor2robot_tpu_torch.train.trainer import Trainer, _index
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  graphed, eager = (Trainer(model, seed=seed, device=dev) for _ in range(2))
  g_state, e_state = graphed.create_train_state(), eager.create_train_state()
  steps = next(iter(stack[0].values())).shape[0]
  g_state, _ = graphed.train_steps(g_state, *warm)
  for i in range(next(iter(warm[0].values())).shape[0]):
    e_state, _ = eager.train_step(e_state, *_index(warm, i))
  torch.cuda.synchronize()
  before = ss.spatial_softmax.launches
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  replays = CountReplays(gl)
  with replays:
    g_state, g_metrics = graphed.train_steps(g_state, *stack)
    torch.cuda.synchronize()
  capture_ms = (time.perf_counter() - start) * 1e3
  graph_launches_k1 = ss.spatial_softmax.launches - before
  first_replay = dict(replays.launches)
  peak = torch.cuda.max_memory_allocated()
  e_ms = []
  for i in range(steps):
    torch.cuda.synchronize()
    begin = time.perf_counter()
    e_state, e_metrics = eager.train_step(e_state, *_index(stack, i))
    torch.cuda.synchronize()
    e_ms.append((time.perf_counter() - begin) * 1e3)
  eager_launches_k1 = (ss.spatial_softmax.launches - before
                       - graph_launches_k1)
  diff = state_diff(torch, g_state, e_state)
  diff["metrics"] = max(abs(float(g_metrics[k]) - float(e_metrics[k]))
                        for k in e_metrics)
  torch.backends.cudnn.deterministic = deterministic
  # Timing: replays of the same stack, then 10 eager steps profiled.
  g_ms, device_ms_step = [], []
  with replays:
    for _ in range(3):
      torch.cuda.synchronize()
      begin = time.perf_counter()
      start_event = torch.cuda.Event(enable_timing=True)
      end_event = torch.cuda.Event(enable_timing=True)
      start_event.record()
      g_state, _ = graphed.train_steps(g_state, *stack)
      end_event.record()
      torch.cuda.synchronize()
      g_ms.append((time.perf_counter() - begin) * 1e3 / steps)
      device_ms_step.append(start_event.elapsed_time(end_event) / steps)
  host_graph = float(np.median(g_ms))
  device_graph = float(np.median(device_ms_step))
  result = {
      "steps": steps, "warm_steps": next(iter(warm[0].values())).shape[0],
      "max_abs_diff": diff, "bitwise_equal": not any(diff.values()),
      "cudnn_deterministic": True,
      "graph_replays": replays.replays,
      "k1_launches_graphed": graph_launches_k1,
      "k1_launches_first_replay": first_replay,
      "k1_launches_from_replays": replays.launches,
      "k1_launches_eager": eager_launches_k1,
      "capture_and_first_replay_ms": capture_ms,
      "eager_step_ms_median": float(np.median(e_ms)),
      "graphed_step_ms_median": host_graph,
      "graphed_device_ms_per_step": device_graph,
      "graphed_device_idle_share": 1.0 - device_graph / host_graph,
      "peak_mib_graphed": peak / 2 ** 20,
      "loss": float(e_metrics["loss"]),
  }
  if not result["bitwise_equal"]:
    raise AssertionError(f"{name}: {steps} graphed steps differ from "
                         f"{steps} eager ones: {diff}")
  if not profiled:
    return result
  # One replay under the profiler: the graph's kernels, as the trace
  # shows them (no host gaps inside a replay).
  with replays, torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    begin = time.perf_counter()
    g_state, _ = graphed.train_steps(g_state, *stack)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - begin) * 1e3
  trace = os.path.join(out_dir, f"{name}_graphed.json")
  prof.export_chrome_trace(trace)
  graphed_profile = trace_summary(trace, steps, wall_ms)
  batches = [_index(stack, i) for i in range(PROFILED_STEPS + 3)]
  e_state, profile = profile_steps(torch, eager, e_state, batches, out_dir,
                                   f"{name}_eager")
  result.update({
      "graphed_profiled": {key: graphed_profile[key] for key in (
          "device_ms_per_step", "kernels_per_step", "device_idle_share")},
      "eager_device_ms_per_step": profile["device_ms_per_step"],
      "eager_kernels_per_step": profile["kernels_per_step"],
      "eager_device_idle_share_of_step": 1.0 - profile[
          "device_ms_per_step"] / float(np.median(e_ms)),
      "top_device_ms_per_step": profile["top_device_ms_per_step"],
  })
  return result


def pose_graph(torch, ss, gl, dev, seed: int, images, poses,
               root: str) -> dict:
  """pose_env's train step, bf16 at batch 64, as one 50-step graph
  against 50 eager steps: K1 runs 50 times a replay."""
  from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  model = PoseEnvRegressionModel(optimizer_fn=create_adam_optimizer(POSE_LR),
                                 use_avg_model_params=True)
  rng = np.random.default_rng(seed + 7)
  reset_spatial_softmax_counts(ss)
  warm = stacked(torch, list(pose_batches(
      model.preprocessor, images, poses, FLAGSHIP_WARM_STEPS, rng)), dev)
  stack = stacked(torch, list(pose_batches(
      model.preprocessor, images, poses, GRAPH_STEPS, rng)), dev)
  result = graph_vs_eager(torch, ss, gl, model, dev, seed, warm, stack,
                          root, "pose_graph")
  result["k1_launches_phase"] = dict(ss.spatial_softmax.launches_by_kernel)
  if (result["k1_launches_graphed"] != GRAPH_STEPS
      or result["k1_launches_first_replay"] != {"channels": GRAPH_STEPS}
      or result["k1_launches_eager"] != GRAPH_STEPS):
    raise AssertionError(f"K1 launches through the graph: {result}")
  return result


def flagship_batches(torch, dev, seed: int, steps: int, rng):
  """`steps` flagship batches (32 scenes at 472x472 as float images in
  [0, 1], uniform actions, their success labels) stacked on `dev`."""
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      IMAGE_SIZE,
      QTOptGraspingModel,
  )
  batch = QTOptGraspingModel.benchmark_batch_size
  images, targets = sg.sample_scenes(FLAGSHIP_SCENES, IMAGE_SIZE, seed)
  scenes = torch.from_numpy(images).to(dev)
  picks = [rng.choice(FLAGSHIP_SCENES, batch, replace=False)
           for _ in range(steps)]
  actions = rng.uniform(-1, 1, (steps, batch, 4)).astype(np.float32)
  labels = np.stack([sg.grasp_success(targets[p], a)
                     for p, a in zip(picks, actions)]).astype(np.float32)
  index = torch.from_numpy(np.stack(picks)).to(dev)
  return ({"image": scenes[index].float() / 255.0,
           "action": torch.from_numpy(actions).to(dev)},
          {"target_q": torch.from_numpy(labels).to(dev)})


def run_qtopt_flagship(torch, ss, gl, dev, seed: int, root: str) -> dict:
  """The flagship critic at its published size: (a) a 20-step
  ``train_steps`` graph against 20 eager steps, bit for bit; (b) impl
  "fast" against "parity" on the same variables in eval mode; (c) the
  float32 eval forward on the GPU against the CPU at batch 2; (d) the
  CEM control step at the serving defaults, timed."""
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.research.qtopt.cem import CEMPolicy
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      IMAGE_SIZE,
      QTOptGraspingModel,
  )
  start = time.perf_counter()
  model = QTOptGraspingModel(use_avg_model_params=True)
  rng = np.random.default_rng(seed + 11)
  warm = flagship_batches(torch, dev, seed, FLAGSHIP_WARM_STEPS, rng)
  stack = flagship_batches(torch, dev, seed, FLAGSHIP_STEPS, rng)
  result = graph_vs_eager(torch, ss, gl, model, dev, seed, warm, stack,
                          root, "qtopt_flagship")
  result["parameters"] = sum(p.numel() for p in model.module.parameters())
  del warm, stack

  # (b), (c): float32, TF32 off, random weights with random statistics.
  tf32 = (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  parity, fast = (QTOptGraspingModel(impl=impl, compute_dtype=torch.float32)
                  for impl in ("parity", "fast"))
  variables = parity.init_variables(torch.Generator().manual_seed(seed),
                                    device="cpu")
  stats_rng = np.random.default_rng(seed)
  for key, value in variables.items():
    if key.endswith("running_var"):
      value.copy_(torch.from_numpy(stats_rng.uniform(
          0.5, 2.0, tuple(value.shape)).astype(np.float32)))
    elif key.endswith("running_mean") or key.endswith("bias"):
      value.add_(torch.from_numpy(0.2 * stats_rng.standard_normal(
          tuple(value.shape)).astype(np.float32)))
  images, _ = sg.sample_scenes(2, IMAGE_SIZE, seed + 1)
  features = {"image": images.astype(np.float32) / 255.0,
              "action": stats_rng.uniform(-1, 1, (2, 4)).astype(np.float32)}

  def q(model, device):
    on = {k: v.to(device) for k, v in variables.items()}
    out = model.predict_fn(on, {k: torch.from_numpy(v).to(device)
                                for k, v in features.items()})
    return out["q_predicted"].float().cpu().numpy()

  q_parity_gpu = q(parity, dev)
  result["fast_vs_parity_max_abs_err"] = float(np.abs(
      q(fast, dev) - q_parity_gpu).max())
  q_parity_cpu = q(parity, "cpu")
  result["gpu_vs_cpu_f32_max_abs_err"] = float(np.abs(
      q_parity_gpu - q_parity_cpu).max())
  result["f32_atol"] = FLAGSHIP_F32_ATOL
  result["q_f32"] = q_parity_cpu.tolist()
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
      tf32)
  if not (np.isfinite(q_parity_gpu).all()
          and result["fast_vs_parity_max_abs_err"] <= FLAGSHIP_F32_ATOL
          and result["gpu_vs_cpu_f32_max_abs_err"] <= FLAGSHIP_F32_ATOL):
    raise AssertionError(f"flagship eval forward: {result}")

  # (d): the control step at the serving defaults, bf16, random weights:
  # a CUDA graph replay against the same step run eagerly, on the same
  # noise, then timed (host clock, synchronised by the action's copy).
  predictor = ExportedModelPredictor(model, os.path.join(root, "unused"),
                                     device=dev)
  predictor.init_randomly()
  policy = CEMPolicy(predictor, action_size=4, seed=seed, **CEM_SERVING)
  scene = images[0].astype(np.float32) / 255.0
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  noise = torch.randn((CEM_SERVING["iterations"],
                       CEM_SERVING["num_samples"], 4),
                      generator=torch.Generator(dev).manual_seed(seed),
                      device=dev)
  graphed_action = policy(scene, noise=noise)
  fn, variables = predictor.device_fn()

  def eager_step():
    with torch.inference_mode():
      return policy._control(fn, variables, torch.from_numpy(scene),
                             noise).cpu().numpy()

  eager_action = eager_step()
  torch.backends.cudnn.deterministic = deterministic
  if not np.array_equal(graphed_action, eager_action):
    raise AssertionError(f"the graphed CEM step gives {graphed_action}, "
                         f"the eager one {eager_action}")
  control_ms, actions = [], []
  for _ in range(CEM_CALLS + 3):
    begin = time.perf_counter()
    actions.append(policy(scene))
    control_ms.append((time.perf_counter() - begin) * 1e3)
  actions = np.stack(actions)
  if not (actions.shape == (CEM_CALLS + 3, 4) and np.isfinite(actions).all()
          and np.abs(actions).max() <= 1.0):
    raise AssertionError(f"CEM actions {actions}")
  result.update({
      "cem": CEM_SERVING, "cem_graph_equals_eager": True,
      "cem_step_ms_median": float(np.median(control_ms[3:])),
      "cem_eager_step_ms_median": host_ms(torch, eager_step, reps=CEM_CALLS),
      "seconds": time.perf_counter() - start})
  return result


def run_qtopt_capability(torch, gl, dev, root: str) -> dict:
  """The port's check_qtopt at the JAX package's full scale: records,
  2500 steps through train_eval_model (iterations_per_loop=50: the first
  stack eager, 49 graph replays), the native export served through
  CEMPolicy on the device (a graph replay a control step), 200 held-out
  scenes; the bar must hold."""
  from tensor2robot_tpu_torch.bin import run_capability_checks as checks
  start = time.perf_counter()
  scale = checks._SCALES["qtopt"]["full"]
  with CountReplays(gl) as replays:
    result = checks.check_qtopt("full", root, dev.type)
  bar = checks._EXPECT[("qtopt", "full")]
  result.update({"scale": scale, "bar": bar,
                 "graph_replays": replays.replays,
                 "step_ms_median_per_step": result["step_ms_median"]
                 / checks.ITERATIONS_PER_LOOP,
                 "seconds": time.perf_counter() - start})
  emit("qtopt_capability", **result)
  # Training replays each stack after the first (eager) one; serving
  # replays one control step a scene.
  want = scale["steps"] // checks.ITERATIONS_PER_LOOP - 1 + QTOPT_SCENES
  if replays.replays != want:
    raise AssertionError(f"{replays.replays} graph replays; want {want}")
  if not (result["success_rate"] >= bar
          and result["success_rate"] > result["random_success_rate"]):
    raise AssertionError(f"grasp success {result['success_rate']} against "
                         f"the bar {bar} and random "
                         f"{result['random_success_rate']}")
  return result


def accum_gpu_vs_cpu(torch, ss, dev, seed: int, images, poses) -> dict:
  """One ``train_step_accum`` over ACCUM_MICRO microbatches of
  ACCUM_BATCH at float32 (TF32 off) on the card and on the CPU from one
  init: metrics and statistics within the pose_train_f32 bars, the
  averaged gradients within GRAD_NOISE_SHARE of each tensor's largest,
  each side's update Adam's rule on its own gradient."""
  from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  model = PoseEnvRegressionModel(compute_dtype=torch.float32,
                                 optimizer_fn=create_adam_optimizer(POSE_LR))
  batches = list(pose_batches(model.preprocessor, images, poses,
                              ACCUM_MICRO, np.random.default_rng(seed + 5)))
  batches = [tuple({k: v[:ACCUM_BATCH] for k, v in tree.items()}
                   for tree in batch) for batch in batches]
  tf32 = (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  runs = []
  reset_spatial_softmax_counts(ss)
  for device in (dev, torch.device("cpu")):
    trainer = Trainer(model, seed=seed, device=device)
    state = trainer.create_train_state()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, metrics = trainer.train_step_accum(state, *stacked(
        torch, batches, device))
    runs.append((state, {k: float(v) for k, v in metrics.items()}, before))
  k1_launches = ss.spatial_softmax.launches
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
      tf32)
  (gpu, gpu_metrics, _), (cpu, cpu_metrics, before) = runs
  report = {"microbatches": ACCUM_MICRO, "microbatch": ACCUM_BATCH,
            "metrics_gpu": gpu_metrics, "metrics_cpu": cpu_metrics,
            "k1_launches": k1_launches,
            "max_rel_metric_diff": max(
                abs(gpu_metrics[k] - cpu_metrics[k]) / abs(cpu_metrics[k])
                for k in cpu_metrics),
            "stats_max_abs_err": max(
                float((gpu.model_state[k].cpu() - v).abs().max())
                for k, v in cpu.model_state.items()),
            "grad_err_share": {}, "adam_max_abs_err": 0.0,
            "loss_rtol": TRAIN_F32_RTOL, "atol": TRAIN_F32_ATOL,
            "grad_noise_share": GRAD_NOISE_SHARE, "adam_atol": ADAM_ATOL}
  for key, param in cpu.params.items():
    gpu_grad = gpu.params[key].grad.cpu()
    if key not in BN_FED_BIASES:
      report["grad_err_share"][key] = float(
          (gpu_grad - param.grad).abs().max() / param.grad.abs().max())
    for new, grad in ((gpu.params[key].detach().cpu(), gpu_grad),
                      (param.detach(), param.grad)):
      want = adam_reference(torch, before[key], grad, None, 1, POSE_LR)
      report["adam_max_abs_err"] = max(report["adam_max_abs_err"], float(
          (new.double() - want).abs().max()))
  if not (k1_launches == ACCUM_MICRO
          and report["max_rel_metric_diff"] <= TRAIN_F32_RTOL
          and report["stats_max_abs_err"] <= TRAIN_F32_ATOL
          and max(report["grad_err_share"].values()) <= GRAD_NOISE_SHARE
          and report["adam_max_abs_err"] <= ADAM_ATOL):
    raise AssertionError(f"GPU and CPU accumulation disagree: {report}")
  return report


def production_learner_config(seed: int):
  """run_qtopt_replay's non-smoke ReplayLoopConfig (the JAX CLI's
  build_config), on the port's host path."""
  from tensor2robot_tpu_torch.replay.loop import ReplayLoopConfig
  return ReplayLoopConfig(
      image_size=64, batch_size=32, capacity=50_000, min_fill=2_000,
      num_buffer_shards=4, num_collectors=4, envs_per_collector=8,
      queue_capacity=10_000, cem_num_samples=64, cem_num_elites=6,
      cem_iterations=3, refresh_every=200, eval_every=500,
      eval_batches=8, log_every=50, learning_rate=1e-4, seed=seed,
      megastep_inner=50, ingest_chunk=256, anakin_inner=200,
      anakin_bank_scenes=4096)


def fill_with_collectors(config):
  """The config's 4-shard prioritized ring, filled past min_fill by
  num_collectors CollectorWorker threads with seeded uniform logged
  policies (plus each worker's epsilon and scripted mix); the main thread
  drains the queue into the ring. Returns (buffer, workers, seconds)."""
  from tensor2robot_tpu_torch.replay import ingest, learner_bench, loop
  from tensor2robot_tpu_torch.replay.ring_buffer import ShardedReplayBuffer
  c = config
  buffer = ShardedReplayBuffer(
      loop.transition_spec(c.image_size, c.action_size), c.capacity,
      c.batch_size, num_shards=c.num_buffer_shards, seed=c.seed,
      prioritized=c.prioritized)
  queue = ingest.TransitionQueue(c.queue_capacity)
  feeder = ingest.ReplayFeeder(queue, buffer, c.min_fill)
  workers = [
      loop.CollectorWorker(
          learner_bench.uniform_policy(c.action_size, c.seed + 7 + i),
          queue, c.image_size, num_envs=c.envs_per_collector,
          max_attempts=c.max_attempts, seed=c.seed + i,
          grasp_radius=c.grasp_radius,
          exploration_epsilon=c.exploration_epsilon,
          scripted_fraction=c.scripted_fraction)
      for i in range(c.num_collectors)]
  start = time.perf_counter()
  for worker in workers:
    worker.start()
  try:
    while not feeder.ready():
      if time.perf_counter() - start > c.min_fill_timeout_s:
        raise AssertionError(f"the ring holds {buffer.size} after "
                             f"{c.min_fill_timeout_s} s")
      feeder.drain()
      time.sleep(0.005)
  finally:
    for worker in workers:
      worker.request_stop()
    for worker in workers:
      worker.stop()
  feeder.drain()
  return buffer, workers, time.perf_counter() - start


def time_tinyq_labels(torch, dev, seed: int) -> dict:
  """TinyQ's Bellman label at the learner bench's shape (batch 32, CEM
  16/4/2) through the tiled score and the factored one (each next image
  encoded once, the codes scored); the same draws, the two within
  LABEL_FACTORED_ATOL. Host clock around synchronised labels."""
  from tensor2robot_tpu_torch.replay import bellman
  from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
  model = TinyQCriticModel()
  variables = model.init_variables(torch.Generator().manual_seed(seed),
                                   device=dev)
  rng = np.random.default_rng(seed)
  batch = [torch.from_numpy(a).to(dev) for a in (
      rng.integers(0, 256, (32, 16, 16, 3), np.uint8),
      (rng.random(32) < 0.3).astype(np.float32),
      (rng.random(32) < 0.3).astype(np.float32))]
  noise = torch.randn((32, 2, 16, 4), device=dev,
                      generator=torch.Generator(dev).manual_seed(seed))
  out = {}
  for name, factored in (("tiled", False), ("factored", True)):
    fn = bellman.make_bellman_targets_fn(model, 4, 0.8, 16, 4, 2, True,
                                         factored=factored)
    with torch.inference_mode():
      out[name] = fn(variables, *batch, noise)[0]
      out[f"{name}_ms"] = host_ms(torch, lambda: fn(variables, *batch,
                                                    noise))
  err = float((out["tiled"] - out["factored"]).abs().max())
  if not err <= LABEL_FACTORED_ATOL:
    raise AssertionError(f"TinyQ factored vs tiled labels: {err}")
  return {"tiled_ms": out["tiled_ms"], "factored_ms": out["factored_ms"],
          "max_abs_diff": err, "atol": LABEL_FACTORED_ATOL}


def run_qtopt_learner(torch, dev, seed: int, out_dir: str, smi: str) -> dict:
  """Slice 8: the QT-Opt learner's host path on the card, parts (a)-(d)
  (see the constants above). Raises when a bar or a check fails."""
  from tensor2robot_tpu_torch.replay import bellman, learner_bench
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      IMAGE_SIZE,
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils import optimizers
  result = {"card": smi}

  # (a) The off-policy bar: TinyQ, logged episodes, a frozen ring.
  bars = {}
  for s in LEARNER_SEEDS:
    run = learner_bench.off_policy_td_reduction(seed=s, device=dev)
    bars[s] = run
    emit("qtopt_learner_offpolicy", card=smi, **run)
  result["offpolicy"] = {s: {"initial_eval_td": r["initial_eval"][
      "eval_td_error"], "final_eval_td": r["final_eval"]["eval_td_error"],
                             "reduction": r["eval_td_reduction"]}
                         for s, r in bars.items()}
  if not all(r["eval_td_reduction"] >= LEARNER_BAR for r in bars.values()):
    raise AssertionError(f"eval TD reductions {result['offpolicy']} under "
                         f"the bar {LEARNER_BAR}")

  # (b) The JAX bench's host path at its defaults.
  bench = learner_bench.measure_learner_throughput(device=dev)
  emit("qtopt_learner_bench", card=smi, **bench)
  result["bench_host_path"] = bench["host_path"]
  result["tinyq_label"] = time_tinyq_labels(torch, dev, seed)
  emit("qtopt_learner_tinyq_label", card=smi, **result["tinyq_label"])

  # (c) The production learner at full width.
  config = production_learner_config(seed)
  buffer, workers, fill_s = fill_with_collectors(config)
  model = QTOptGraspingModel(
      image_size=config.image_size, uint8_images=True, norm="group",
      optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
  trainer = Trainer(model, seed=seed, device=dev)
  state = trainer.create_train_state()
  updater = bellman.BellmanUpdater(
      model, state.variables(use_ema=True), action_size=config.action_size,
      gamma=config.gamma, num_samples=config.cem_num_samples,
      num_elites=config.cem_num_elites, iterations=config.cem_iterations,
      seed=seed + 13, polyak_tau=config.polyak_tau, device=dev)
  for _ in range(LEARNER_WARM_STEPS):
    state = learner_bench.host_learner_step(trainer, updater, buffer,
                                            state).state
  clock = learner_bench.StageClock(dev)
  losses = []
  torch.cuda.synchronize()
  start = time.perf_counter()
  for step in range(1, LEARNER_STEPS + 1):
    state, metrics, td = learner_bench.host_learner_step(
        trainer, updater, buffer, state, clock)[:3]
    losses.append(metrics["loss"])
    if step % config.refresh_every == 0:
      updater.refresh(state.variables(use_ema=True), step)
  torch.cuda.synchronize()
  wall = time.perf_counter() - start
  stages = clock.summary()
  losses = torch.stack(losses).cpu().numpy()
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LEARNER_PROFILED_STEPS):
      state = learner_bench.host_learner_step(trainer, updater, buffer,
                                              state).state
    torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
  trace = os.path.join(out_dir, "qtopt_learner.json")
  prof.export_chrome_trace(trace)
  # GroupNorm's statistics, the largest kernel family in the trace.
  profile = trace_summary(trace, LEARNER_PROFILED_STEPS, profiled_ms,
                          match=r"RowwiseMomentsCUDAKernel")
  production = {
      "config": "run_qtopt_replay non-smoke (64x64 uint8, GroupNorm, Adam "
                "1e-4, batch 32, CEM 64/6/3, gamma 0.8, 4-shard ring "
                "50000)",
      "fill_seconds": fill_s, "ring_size": buffer.size,
      "episodes": sum(w.episodes for w in workers),
      "successes": sum(w.successes for w in workers),
      "steps": LEARNER_STEPS, "steps_per_s": LEARNER_STEPS / wall,
      "step_ms": wall * 1e3 / LEARNER_STEPS, "stages": stages,
      "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
      "refreshes": updater.refresh_count,
      "compile_counts": dict(updater.compile_counts),
      "profiled_step_ms": profiled_ms / LEARNER_PROFILED_STEPS,
      **{k: v for k, v in profile.items() if k != "device_idle_share"},
      # The profiler stretches its window's steps: the idle share of the
      # unprofiled step is the one the learner runs at.
      "device_idle_share_of_step": 1.0 - profile["device_ms_per_step"] / (
          wall * 1e3 / LEARNER_STEPS),
      "device_idle_share_profiled": profile["device_idle_share"],
      "priority_entropy": buffer.priority_entropy(),
  }
  emit("qtopt_learner_production", card=smi, **production)
  if not (np.isfinite(losses).all() and np.isfinite(td).all()
          and buffer.size >= config.min_fill
          and updater.compile_counts == {"bellman_targets": 1,
                                         "td_error": 1}
          and updater.refresh_count == LEARNER_STEPS // config.refresh_every):
    raise AssertionError(f"production learner: {production}")
  result["production"] = {k: production[k] for k in (
      "steps_per_s", "step_ms", "stages", "device_idle_share_of_step",
      "device_idle_share_profiled", "device_ms_per_step")}

  # (d) One Bellman label at the published size.
  model = QTOptGraspingModel(uint8_images=True, norm="group")
  variables = model.init_variables(torch.Generator().manual_seed(seed),
                                   device=dev)
  updater = bellman.BellmanUpdater(
      model, variables, action_size=config.action_size, gamma=config.gamma,
      num_samples=config.cem_num_samples, num_elites=config.cem_num_elites,
      iterations=config.cem_iterations, seed=seed + 13, device=dev)
  rng = np.random.default_rng(seed)
  batch = {
      "next_image": rng.integers(0, 256, (config.batch_size, IMAGE_SIZE,
                                          IMAGE_SIZE, 3), np.uint8),
      "reward": (rng.random(config.batch_size) < 0.3).astype(np.float32),
      "done": (rng.random(config.batch_size) < 0.3).astype(np.float32)}
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  times = []
  for _ in range(1 + LABEL_472_REPEATS):
    t0 = time.perf_counter()
    targets, q_next = updater.compute_targets(batch)
    times.append((time.perf_counter() - t0) * 1e3)
  label = {
      "image_size": IMAGE_SIZE, "batch": config.batch_size,
      "cem": [config.cem_num_samples, config.cem_num_elites,
              config.cem_iterations],
      "images_per_cem_iteration": config.batch_size
                                  * config.cem_num_samples,
      "chunking": f"none: all {config.batch_size} states in one pass",
      "first_label_ms": times[0],
      "label_ms_median": float(np.median(times[1:])), "label_ms": times[1:],
      "max_memory_allocated_mib": torch.cuda.max_memory_allocated() / 2**20,
  }
  emit("qtopt_learner_label_472", card=smi, **label)
  if not (np.isfinite(targets).all() and np.isfinite(q_next).all()
          and (targets >= 0).all() and (targets <= 1).all()):
    raise AssertionError(f"472x472 label: targets {targets}")
  result["label_472"] = label
  return result


def run_qtopt_loop(torch, gl, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 9: the closed QT-Opt loop on the card, parts (a)-(c) (see the
  constants above). Raises when a bar or a check fails."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay.loop import (
      ReplayTrainLoop,
      _HotReloadPredictor,
  )
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      IMAGE_SIZE,
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.serving import CEMFleetPolicy
  result = {"card": smi}

  # (a) The JAX smoke through the port's CLI entry.
  smoke = {}
  for s in HOST_SMOKE_SEEDS:
    start = time.perf_counter()
    run = run_qtopt_replay.run(LOOP_SMOKE_STEPS, smoke=True,
                               logdir=os.path.join(root, f"smoke_{s}"),
                               seed=s, device=dev)
    line = {
        "seed": s, "steps": run["steps"],
        "initial_eval_td": run["initial_eval"]["eval_td_error"],
        "final_eval_td": run["final_eval"]["eval_td_error"],
        "eval_td_reduction": run["eval_td_reduction"], "bar": LOOP_BAR,
        "compile_counts": run["compile_counts"],
        "episodes": run["episodes_collected"],
        "env_steps": run["env_steps_collected"],
        "param_refreshes": run["param_refreshes"],
        "breach_count": run["health"]["breach_count"],
        "seconds": time.perf_counter() - start}
    emit("qtopt_loop_smoke", card=smi, **line)
    smoke[s] = line
    if not (run["eval_td_reduction"] >= LOOP_BAR
            and set(run["compile_counts"].values()) == {1}
            and run["health"]["breach_count"] == 0):
      raise AssertionError(f"closed-loop smoke at seed {s}: {line}")
  result["smoke"] = smoke

  # (b) The production loop at full width.
  config = run_qtopt_replay.build_config(False, seed)
  timed = drive_loop(ReplayTrainLoop(config, os.path.join(root, "production"),
                                     device=dev), LOOP_PRODUCTION_STEPS, gl)
  run = timed.pop("run")
  production = {
      "config": "run_qtopt_replay non-smoke (64x64 uint8 GroupNorm critic, "
                "batch 32, CEM 64/6/3, 4-shard ring 50000, min_fill 2000, "
                "4 collectors x 8 envs)",
      "steps": run["steps"], **timed,
      "env_steps": run["env_steps_collected"],
      "episodes": run["episodes_collected"],
      "collector_success_rate": run["collector_success_rate"],
      "param_refreshes": run["param_refreshes"],
      "compile_counts": run["compile_counts"],
      "eval_td_first": run["eval_history"][0]["eval_td_error"],
      "eval_td_last": run["eval_history"][-1]["eval_td_error"],
      "eval_history": run["eval_history"], "health": {
          k: run["health"][k] for k in ("observations", "breach_count",
                                        "breaches_per_rule",
                                        "last_summary")},
      "queue": run["queue"], "buffer": run["buffer"]}
  emit("qtopt_loop_production", card=smi, **production)
  if not (run["compile_counts"].get("cem_bucket_8") == 1
          and set(run["compile_counts"].values()) == {1}
          and run["param_refreshes"] == (LOOP_PRODUCTION_STEPS
                                         // config.refresh_every)
          and production["policy_graph_replays"] > 0
          and run["health"]["breach_count"] == 0
          and np.isfinite(production["eval_td_last"])):
    raise AssertionError(f"production loop: {production}")
  result["production"] = {k: production[k] for k in (
      "learner_steps_per_s", "env_steps_per_s", "fill_s", "eval_td_first",
      "eval_td_last", "policy_graph_replays")}
  del run

  # (c) CEMFleetPolicy at the published size, every rung, graph against
  # eager bit for bit, captured once across the reloads.
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  model = QTOptGraspingModel(uint8_images=True, norm="group")

  def variables(s):
    return model.init_variables(torch.Generator().manual_seed(s), device=dev)

  predictor = _HotReloadPredictor(model, variables(seed))
  policy = CEMFleetPolicy(predictor, action_size=4, seed=seed,
                          **CEM_SERVING)
  scenes, _ = sg.sample_scenes(max(LOOP_FLEET_RUNGS), IMAGE_SIZE, seed + 5)

  def graph_vs_eager(bucket):
    images = list(scenes[:bucket])
    seeds = np.arange(bucket, dtype=np.uint32)
    graphed, scores = policy(images, seeds, return_scores=True)
    fn, _ = predictor.device_fn()
    with torch.inference_mode():
      eager, eager_scores = policy._control(
          fn, torch.from_numpy(np.stack(images)).to(dev),
          torch.from_numpy(policy.noise_for(seeds)).to(dev))
    if not (np.array_equal(graphed, eager.cpu().numpy())
            and np.array_equal(scores, eager_scores.cpu().numpy())
            and np.isfinite(graphed).all()
            and np.abs(graphed).max() <= 1.0):
      raise AssertionError(f"bucket {bucket}: the graph gives {graphed}, "
                           f"the eager control {eager.cpu().numpy()}")
    return graphed

  rungs = []
  for bucket in LOOP_FLEET_RUNGS:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2**20
    begin = time.perf_counter()
    graph_vs_eager(bucket)
    first_s = time.perf_counter() - begin
    images = list(scenes[:bucket])
    calls = []
    for _ in range(FLEET_CALLS):
      begin = time.perf_counter()
      policy(images)
      calls.append((time.perf_counter() - begin) * 1e3)
    key = (bucket, scenes.shape[1:], scenes.dtype)
    rungs.append({
        "bucket": bucket, "images_per_cem_iteration":
            bucket * CEM_SERVING["num_samples"],
        "graph_equals_eager": True, "first_call_s": first_s,
        "request_ms_median": float(np.median(calls)),
        "replay_device_ms": stream_ms(
            torch, lambda: policy._buckets[key].graph.replay(), inner=3),
        # The earlier rungs' graphs stay allocated: held_mib before this
        # rung's first call, the peak of its capture and eager check.
        "held_mib": held_mib,
        "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20})
    emit("qtopt_loop_fleet", card=smi, **rungs[-1])
  before = graph_vs_eager(LOOP_FLEET_RUNGS[1])
  for reload in range(1, FLEET_RELOADS + 1):
    predictor.set_variables(variables(seed + reload))
    for bucket in LOOP_FLEET_RUNGS:
      graph_vs_eager(bucket)
  if np.array_equal(graph_vs_eager(LOOP_FLEET_RUNGS[1]), before):
    raise AssertionError("the reloaded variables did not change an action")
  fleet = {"cem": CEM_SERVING, "image_size": IMAGE_SIZE,
           "compile_counts": dict(policy.compile_counts),
           "model_version": predictor.model_version, "rungs": rungs}
  if policy.compile_counts != {b: 1 for b in LOOP_FLEET_RUNGS}:
    raise AssertionError(f"fleet captures across reloads: {fleet}")
  torch.backends.cudnn.deterministic = deterministic
  del policy, predictor
  torch.cuda.empty_cache()

  # The fleet step on the card against the CPU, float32 at 64x64.
  tf32 = (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  model32 = QTOptGraspingModel(image_size=64, uint8_images=True,
                               norm="group", compute_dtype=torch.float32)
  state = model32.init_variables(torch.Generator().manual_seed(seed),
                                 device="cpu")
  images = list(sg.sample_scenes(2, 64, seed + 6)[0])
  out = {}
  for name, device in (("gpu", dev), ("cpu", "cpu")):
    on = {k: v.to(device) for k, v in state.items()}
    out[name] = CEMFleetPolicy(_HotReloadPredictor(model32, on),
                               action_size=4, seed=seed, **CEM_SERVING)(
                                   images, [3, 9], return_scores=True)
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
      tf32)
  fleet["gpu_vs_cpu_f32"] = {
      "bucket": 2, "image_size": 64, "atol": FLEET_F32_ATOL,
      "actions_max_abs_err": float(np.abs(out["gpu"][0]
                                          - out["cpu"][0]).max()),
      "scores_max_abs_err": float(np.abs(out["gpu"][1]
                                         - out["cpu"][1]).max())}
  emit("qtopt_loop_fleet_summary", card=smi, **fleet)
  if not (fleet["gpu_vs_cpu_f32"]["actions_max_abs_err"] <= FLEET_F32_ATOL
          and fleet["gpu_vs_cpu_f32"]["scores_max_abs_err"]
          <= FLEET_F32_ATOL):
    raise AssertionError(f"fleet step, card vs CPU: {fleet}")
  result["fleet"] = {"compile_counts": fleet["compile_counts"],
                     "gpu_vs_cpu_f32": fleet["gpu_vs_cpu_f32"],
                     "request_ms_median": {r["bucket"]: r[
                         "request_ms_median"] for r in rungs}}
  return result


# Slice 10. (a) The learner's crash-resume parity (serving/fault_bench.py):
# train k1 steps, checkpoint, restore into fresh objects and train k2 more
# against k1 + k2 straight through, with cuDNN deterministic; the TD
# streams and the ring must be bit-equal (the JAX bar, a TD delta of 0).
# (b) run_qtopt_replay --smoke saving at step 150, then resumed to 300.
# (c) One checkpoint at the production ring (50,000 rows of two 64x64
# uint8 images): its save and restore seconds and bytes. (d) A --profile
# window, whose trace must hold CUDA kernel events.
RESUME_PARITY = (("tinyq", 6, 6, False), ("flagship_64", 20, 20, True))
RESUME_SMOKE_HALF = 150
RESUME_PRODUCTION_STEPS = 10
PROFILE_WINDOW = "5,8"
PROFILE_STEPS = 12
# Slice 10's vector actor: the smoke with --vector-actors at one seed (the
# 0.30 bar, one acting bucket), the production loop with one VectorActor
# over the 32 envs, and the learner alone in the same call (the actor
# stopped once the ring passes min_fill). ROADMAP's bar, reported and not
# gated: the loop's learner within 2x of the learner alone.
VECTOR_PRODUCTION_STEPS = 200  # refresh_every: one hot reload
VECTOR_ALONE_STEPS = 100  # the learner alone (200 until slice 18)
STARVATION_BAR = 2.0


def drive_loop(replay, steps: int, gl, alone: bool = False) -> dict:
  """Runs `replay` for `steps` and times it: the fill, and the learner's
  rate from the end of the fill to the end of the run. With `alone` the
  collectors (or actors) stop as soon as the ring passes min_fill."""
  marks = {}
  wait_for_min_fill = replay._wait_for_min_fill

  def timed_fill():
    marks["fill_start"] = time.perf_counter()
    wait_for_min_fill()
    if alone:
      for collector in replay._collectors:
        collector.request_stop()
      for collector in replay._collectors:
        collector.join(30.0)
    marks["learn_start"] = time.perf_counter()

  replay._wait_for_min_fill = timed_fill
  start = time.perf_counter()
  with CountReplays(gl) as replays:
    run = replay.run(steps)
  end = time.perf_counter()
  return {"run": run, "wall_s": end - start,
          "fill_s": marks["learn_start"] - marks["fill_start"],
          "learner_steps_per_s": run["steps"] / (end - marks["learn_start"]),
          "env_steps_per_s": run["env_steps_collected"] / (end - start),
          "policy_graph_replays": replays.replays}


def directory_bytes(path: str) -> int:
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files)


def run_qtopt_resume(torch, gl, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 10's resume phase, parts (a)-(d) above. Raises when a bar or a
  check fails."""
  import contextlib
  import io

  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  from tensor2robot_tpu_torch.serving.fault_bench import (
      _measure_resume_parity,
  )
  from tensor2robot_tpu_torch.train import checkpoints
  result = {"card": smi}

  # (a) Bit parity across a crash, on the card.
  for name, k1, k2, flagship in RESUME_PARITY:
    start = time.perf_counter()
    parity = _measure_resume_parity(k1, k2, seed, device=dev,
                                    flagship=flagship)
    parity.update(model=name, seconds=time.perf_counter() - start)
    emit("qtopt_resume_parity", card=smi, **parity)
    if not (parity["parity_ok"]
            and parity["max_post_resume_td_delta"] == 0.0):
      raise AssertionError(f"resume parity, {name}: {parity}")
    result[f"parity_{name}"] = parity["parity_ok"]

  # (b) The smoke loop saved at 150 and resumed to 300.
  logdir = os.path.join(root, "smoke_resume")
  first = run_qtopt_replay.run(RESUME_SMOKE_HALF, smoke=True, logdir=logdir,
                               seed=seed, device=dev,
                               checkpoint_every=RESUME_SMOKE_HALF)
  start = time.perf_counter()
  resumed = run_qtopt_replay.run(2 * RESUME_SMOKE_HALF, smoke=True,
                                 logdir=logdir, seed=seed, device=dev,
                                 checkpoint_every=RESUME_SMOKE_HALF,
                                 resume=True)
  first_steps = [e["step"] for e in first["eval_history"]]
  steps = [e["step"] for e in resumed["eval_history"]]
  line = {"first_eval_steps": first_steps, "resumed_eval_steps": steps,
          "initial_eval_td": resumed["initial_eval"]["eval_td_error"],
          "final_eval_td": resumed["final_eval"]["eval_td_error"],
          "eval_td_reduction": resumed["eval_td_reduction"], "bar": LOOP_BAR,
          "compile_counts": resumed["compile_counts"],
          "resumed_seconds": time.perf_counter() - start}
  emit("qtopt_resume_smoke", card=smi, **line)
  if not (steps[:len(first_steps)] == first_steps
          and steps[-1] == 2 * RESUME_SMOKE_HALF
          and resumed["initial_eval"] == first["initial_eval"]
          and resumed["eval_td_reduction"] >= LOOP_BAR
          and set(resumed["compile_counts"].values()) == {1}):
    raise AssertionError(f"smoke resume: {line}")
  result["smoke_reduction"] = resumed["eval_td_reduction"]

  # (c) A checkpoint at the production ring: saved at step 10 of the
  # production loop (its actor fills the ring fastest), restored by a fresh
  # loop that goes on to step 20.
  config = run_qtopt_replay.build_config(
      False, seed, vector_actors=True,
      checkpoint_every=RESUME_PRODUCTION_STEPS)
  logdir = os.path.join(root, "production_resume")
  clocks = {}

  def timed(replay, name):
    method = getattr(replay, name)

    def wrapper(*args, **kwargs):
      begin = time.perf_counter()
      out = method(*args, **kwargs)
      clocks[name] = time.perf_counter() - begin
      return out

    setattr(replay, name, wrapper)
    return replay

  first = timed(ReplayTrainLoop(config, logdir, device=dev),
                "_save_checkpoint").run(RESUME_PRODUCTION_STEPS)
  ckpt_root = os.path.join(logdir, "checkpoints")
  step_dir = os.path.join(ckpt_root, str(RESUME_PRODUCTION_STEPS))
  sidecar = checkpoints.sidecar_dir(ckpt_root, RESUME_PRODUCTION_STEPS)
  resumed = timed(ReplayTrainLoop(
      dataclasses.replace(config, resume=True), logdir, device=dev),
      "_restore_checkpoint").run(2 * RESUME_PRODUCTION_STEPS)
  production = {
      "config": "run_qtopt_replay non-smoke, vector actor, checkpoint_every "
                f"{RESUME_PRODUCTION_STEPS}",
      "capacity": config.capacity, "save_s": clocks["_save_checkpoint"],
      "restore_s": clocks["_restore_checkpoint"],
      "state_bytes": directory_bytes(step_dir),
      "sidecar_bytes": directory_bytes(sidecar),
      "buffer_npz_bytes": os.path.getsize(
          os.path.join(sidecar, "buffer.npz")),
      "ring_size_at_save": first["buffer"]["replay/size"],
      "eval_steps": [e["step"] for e in resumed["eval_history"]],
      "compile_counts": resumed["compile_counts"]}
  emit("qtopt_resume_production", card=smi, **production)
  if not (production["eval_steps"] == [0, RESUME_PRODUCTION_STEPS,
                                       2 * RESUME_PRODUCTION_STEPS]
          and resumed["initial_eval"] == first["initial_eval"]
          and set(resumed["compile_counts"].values()) == {1}):
    raise AssertionError(f"production resume: {production}")
  result["production"] = {k: production[k] for k in (
      "save_s", "restore_s", "sidecar_bytes")}

  # (d) A --profile window through the CLI.
  logdir = os.path.join(root, "profiled")
  with contextlib.redirect_stdout(io.StringIO()) as out:
    run_qtopt_replay.main(["--smoke", "--steps", str(PROFILE_STEPS),
                           "--profile", PROFILE_WINDOW, "--logdir", logdir])
  run = json.loads(out.getvalue().strip().splitlines()[-1])
  traces = [os.path.join(logdir, "profile", f)
            for f in sorted(os.listdir(os.path.join(logdir, "profile")))]
  with open(traces[0]) as f:
    events = json.load(f)["traceEvents"]
  kernels = sum(1 for e in events if e.get("cat") == "kernel")
  profiled = {"window": PROFILE_WINDOW, "steps": run["steps"],
              "traces": len(traces), "trace_bytes": os.path.getsize(
                  traces[0]), "cuda_kernel_events": kernels,
              "events": len(events)}
  emit("qtopt_resume_profile", card=smi, **profiled)
  if not (len(traces) == 1 and kernels > 0):
    raise AssertionError(f"profile window: {profiled}")
  result["profile_cuda_kernel_events"] = kernels
  return result


def run_qtopt_vector(torch, gl, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 10's vector-actor phase (see the constants above). Raises when
  a bar or a check fails; the starvation ratio is reported, not gated."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  result = {"card": smi}

  smoke = {}
  for s in VECTOR_SMOKE_SEEDS:
    start = time.perf_counter()
    run = run_qtopt_replay.run(LOOP_SMOKE_STEPS, smoke=True,
                               logdir=os.path.join(root, f"smoke_{s}"),
                               seed=s, device=dev, vector_actors=True,
                               actor_bench=s == VECTOR_SMOKE_SEEDS[0])
    buckets = [k for k in run["compile_counts"] if k.startswith("cem_bucket")]
    line = {"seed": s, "steps": run["steps"],
            "initial_eval_td": run["initial_eval"]["eval_td_error"],
            "final_eval_td": run["final_eval"]["eval_td_error"],
            "eval_td_reduction": run["eval_td_reduction"], "bar": LOOP_BAR,
            "compile_counts": run["compile_counts"],
            "episodes": run["episodes_collected"],
            "env_steps": run["env_steps_collected"],
            "param_refreshes": run["param_refreshes"],
            "vector_actors": run["vector_actors"],
            "breach_count": run["health"]["breach_count"],
            "seconds": time.perf_counter() - start}
    emit("qtopt_vector_smoke", card=smi, **line)
    smoke[s] = line
    if not (run["eval_td_reduction"] >= LOOP_BAR and run["vector_actors"]
            and buckets == ["cem_bucket_4"]
            and set(run["compile_counts"].values()) == {1}):
      raise AssertionError(f"vector smoke at seed {s}: {line}")
    if "actor_throughput" in run:
      bench = run["actor_throughput"]
      emit("qtopt_vector_actor_bench", card=smi, **bench)
      if not set(bench["compile_counts"].values()) == {1}:
        raise AssertionError(f"actor bench builds: {bench}")
      result["actor_bench_speedup"] = bench["speedup"]
  result["smoke"] = {s: line["eval_td_reduction"] for s, line in smoke.items()}

  config = run_qtopt_replay.build_config(False, seed, vector_actors=True)
  runs = {}
  for name, alone in (("vector", False), ("alone", True)):
    timed = drive_loop(ReplayTrainLoop(config, os.path.join(root, name),
                                       device=dev),
                       VECTOR_ALONE_STEPS if alone else
                       VECTOR_PRODUCTION_STEPS, gl, alone=alone)
    run = timed.pop("run")
    runs[name] = {
        **timed, "steps": run["steps"],
        "env_steps": run["env_steps_collected"],
        "episodes": run["episodes_collected"],
        "param_refreshes": run["param_refreshes"],
        "compile_counts": run["compile_counts"],
        "eval_td_first": run["eval_history"][0]["eval_td_error"],
        "eval_td_last": run["eval_history"][-1]["eval_td_error"],
        "breach_count": run["health"]["breach_count"]}
    emit(f"qtopt_vector_production_{name}", card=smi, **runs[name])
    if not (run["compile_counts"].get("cem_bucket_32") == 1
            and set(run["compile_counts"].values()) == {1}
            and run["vector_actors"]
            and np.isfinite(runs[name]["eval_td_last"])):
      raise AssertionError(f"vector production loop ({name}): {runs[name]}")
  if runs["vector"]["param_refreshes"] < 1:
    raise AssertionError("the vector production loop made no hot reload")
  # The acting bucket's device time: one replay of the production policy's
  # graph (the loop's critic, its CEM, the fleet's bucket), and the share
  # of the vector loop's wall its replays held the card.
  from tensor2robot_tpu_torch.replay.loop import _HotReloadPredictor
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.serving import BucketLadder, CEMFleetPolicy
  model = ReplayTrainLoop._default_model(types.SimpleNamespace(config=config))
  bucket = config.num_collectors * config.envs_per_collector
  policy = CEMFleetPolicy(
      _HotReloadPredictor(model, model.init_variables(
          torch.Generator().manual_seed(seed), device=dev)),
      action_size=config.action_size, num_samples=config.cem_num_samples,
      num_elites=config.cem_num_elites, iterations=config.cem_iterations,
      seed=seed, ladder=BucketLadder((bucket,)))
  scenes = sg.sample_scenes(bucket, config.image_size, seed + 5)[0]
  policy(list(scenes))
  replay_ms = stream_ms(torch, lambda: policy._buckets[
      (bucket, scenes.shape[1:], scenes.dtype)].graph.replay(), inner=3)
  acting = {"bucket": bucket, "replay_device_ms": replay_ms,
            "device_share_of_vector_run": runs["vector"][
                "policy_graph_replays"] * replay_ms / 1e3
            / runs["vector"]["wall_s"]}
  emit("qtopt_vector_acting", card=smi, **acting)
  del policy
  ratio = (runs["alone"]["learner_steps_per_s"]
           / runs["vector"]["learner_steps_per_s"])
  result["production"] = {
      "learner_steps_per_s": runs["vector"]["learner_steps_per_s"],
      "learner_alone_steps_per_s": runs["alone"]["learner_steps_per_s"],
      "alone_over_vector": ratio, "bar": STARVATION_BAR,
      "within_bar": ratio <= STARVATION_BAR,
      "env_steps_per_s": runs["vector"]["env_steps_per_s"],
      "fill_s": runs["vector"]["fill_s"],
      "policy_graph_replays": runs["vector"]["policy_graph_replays"],
      "acting_replay_device_ms": replay_ms,
      "acting_device_share": acting["device_share_of_vector_run"]}
  return result


# Slice 11: the device-resident learner. (a) The megastep's CUDA graphs
# against its eager iterations, bit for bit with cuDNN deterministic:
# parameters, Adam's state, the ring, the tree and the metrics over 3
# dispatches. TinyQ at K=4 and the production 64x64 critic at K=50, CEM
# 64/6/3, each one graph of the K iterations, with the capture's seconds
# and memory and a dispatch's device time. (b) run_qtopt_replay
# --smoke --device-resident at LOOP_SEEDS: the 0.30 bar, `megastep` and
# `device_extend` built once, no `train_step`; seed 0 carries the learner
# bench. (c) The production device-resident loop (the JAX CLI's non-smoke
# config: 64x64, batch 32, ring 50,000, K 50, ingest chunk 256) beside one
# vector actor over 32 envs and alone: 400 steps, so 4 graphed dispatches
# follow the warm-up, the capture, the profiled dispatch and the one that
# waits for the trace's export; steps/s over the whole window (from the
# fill's end) and over those steady dispatches, the one-time cost of the
# eager first dispatch and the capture, the profiler's idle share of one
# dispatch, peak memory. (d) Fused resume
# parity, TinyQ and the flagship. The bars are reported, not gated: the
# card idle under 0.2 of a dispatch alone, the bench's megastep
# host_blocked_fraction median <= 0.05, its speedup max >= 2.0 and median
# >= 1.5 (the JAX bench's).
DEVICE_TINY_K = 4
DEVICE_FLAGSHIP_K = 50
DEVICE_RING = 1024
DEVICE_PRODUCTION_STEPS = 300
DEVICE_PROFILE_WINDOW = (100, 101)  # the dispatch that ends at step 150
DEVICE_IDLE_BAR = 0.2
DEVICE_BLOCKED_BAR = 0.05
DEVICE_SPEEDUP_BARS = {"max": 2.0, "median": 1.5}


# The executable ledger (slice 19): each loop's attribution is held to the
# JAX smokes' require/forbid sets, every row dispatched, the learner-side
# shares (the whole Anakin path) at most 1.0 of the window, and an MFU for
# the fused programs. Its cost: LEDGER_COST_BLOCKS rounds of
# LEDGER_COST_DISPATCHES graphed dispatches with the ledger off and on
# (the order flipped each round); the ledger's median dispatch may be at
# most LEDGER_COST_BAR of the median without it (host clocks on a shared
# host, hence the loose bar).
LEDGER_COST_BLOCKS = 4
LEDGER_COST_DISPATCHES = 1
LEDGER_COST_BAR = 1.05


def ledger_row(torch, book, name: str, device_ms: float) -> dict:
  """`name`'s ledger row, and its FLOPs over a graphed dispatch's device
  time against the card's bf16 peak (``obs.ledger.CHIP_PEAKS``)."""
  from tensor2robot_tpu_torch.obs import ledger as ledger_lib
  (row,) = [r for r in book.attribution()["executables"]
            if r["name"] == name]
  peak = ledger_lib.peak_flops_for(torch.cuda.get_device_name(0))
  flops = row["flops_per_dispatch"]
  return {"ledger_row": row, "flops_per_dispatch": flops,
          "device_mfu": (flops / (device_ms / 1e3) / peak
                         if flops and peak else None)}


def ledger_cost(step, state, use_ledger) -> dict:
  """The same graphed dispatches (`step(state)` -> (state, metrics), each
  ending in its readback) with the ledger off and on, alternating in
  blocks; `use_ledger(on)` switches it. Host seconds a dispatch."""
  seconds = {"off": [], "on": []}
  for block in range(LEDGER_COST_BLOCKS):
    for mode in (("off", "on") if block % 2 == 0 else ("on", "off")):
      use_ledger(mode == "on")
      for _ in range(LEDGER_COST_DISPATCHES):
        start = time.perf_counter()
        state, _ = step(state)
        seconds[mode].append(time.perf_counter() - start)
  use_ledger(True)
  out = {mode: {"median_s": float(np.median(values)),
                "spread_s": float(np.max(values) - np.min(values)),
                "dispatches": len(values)}
         for mode, values in seconds.items()}
  out["ratio"] = out["on"]["median_s"] / out["off"]["median_s"]
  out["bar"] = LEDGER_COST_BAR
  if out["ratio"] > LEDGER_COST_BAR:
    raise AssertionError(f"the ledger slows a dispatch: {out}")
  return out


def check_attribution(attribution: dict, require, forbid, mfu_row: str,
                      whole: bool = False) -> dict:
  """A loop result's ``obs.attribution`` held to the checks above; returns
  each row's dispatches, seconds, share, FLOPs and MFU."""
  from tensor2robot_tpu_torch.obs.ledger import check_compile_ledger
  rows = attribution["executables"]
  check_compile_ledger({r["name"]: r["compiles"] for r in rows},
                       require=require, forbid=forbid)
  held = [r for r in rows if whole or not r["name"].startswith("cem_bucket_")]
  share = sum(r["device_time_share"] for r in held)
  timed = [r for r in rows if r["name"] == mfu_row]
  if (any(r["dispatches"] < 1 for r in rows) or share > 1.0
      or not timed or timed[0]["estimated_mfu"] is None):
    raise AssertionError(f"the loop's ledger: {attribution}")
  return {"wall_seconds": attribution["wall_seconds"],
          "held_share": share, "whole": whole,
          "attributed_share": attribution["attributed_share"],
          "rows": {r["name"]: {key: r[key] for key in (
              "dispatches", "seconds_total", "device_time_share",
              "flops_per_dispatch", "estimated_mfu")} for r in rows}}


def megastep_learner(torch, dev, flagship: bool, inner_steps: int,
                     graphs: bool, seed: int = 0, precision: str = "f32",
                     ledger=None):
  """(state, ring, learner): a MegastepLearner with the health keys over a
  prioritized ring of DEVICE_RING synthetic transitions at batch 32;
  TinyQ at 16x16 (the smoke's CEM 16/4/2) or the production loop's 64x64
  critic (CEM 64/6/3); its labels scored at `precision`, its builds and
  dispatches in `ledger`."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay import learner_bench
  from tensor2robot_tpu_torch.replay.device_buffer import (
      DeviceReplayBuffer,
      MegastepLearner,
  )
  from tensor2robot_tpu_torch.replay.loop import (
      ReplayTrainLoop,
      transition_spec,
  )
  from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils import optimizers
  config = run_qtopt_replay.build_config(not flagship, seed)
  model = (ReplayTrainLoop._default_model(types.SimpleNamespace(
      config=config)) if flagship else TinyQCriticModel(
          optimizer_fn=optimizers.create_adam_optimizer(
              config.learning_rate)))
  trainer = Trainer(model, seed=seed, device=dev)
  state = trainer.create_train_state()
  ring = DeviceReplayBuffer(
      transition_spec(config.image_size, config.action_size), DEVICE_RING,
      config.batch_size, seed=seed, prioritized=True, ingest_chunk=256,
      device=dev)
  ring.extend(learner_bench._synthetic_transitions(
      DEVICE_RING, config.image_size, config.action_size, seed + 17))
  learner = MegastepLearner(
      model, trainer, ring, action_size=config.action_size,
      gamma=config.gamma, num_samples=config.cem_num_samples,
      num_elites=config.cem_num_elites, iterations=config.cem_iterations,
      inner_steps=inner_steps, seed=seed + 13, health=True, graphs=graphs,
      precision=precision, ledger=ledger)
  learner.refresh(state.variables(use_ema=True), step=0)
  return state, ring, learner


def dispatch_device_ms(torch, learner, state, reps: int = 3) -> float:
  """Median device time of one dispatch's K iterations: CUDA events around
  the replays (the draws staged before the first event)."""
  times = []
  for _ in range(reps):
    learner._stage_draws(learner._outer % 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    learner._dispatch(state)
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def megastep_graph_vs_eager(torch, dev, flagship: bool, inner_steps: int,
                            seed: int, precision: str = "f32",
                            cost: bool = False) -> dict:
  """Three dispatches of a graphed learner (the first eager, the second
  captures) against three of an eager one, compared after each; then the
  capture's seconds and memory and a graphed dispatch's device time. The
  graphed learner keeps an executable ledger (its first dispatch counts
  the FLOPs, so the bit-for-bit check also holds the counting harmless);
  with `cost` the ledger's cost is measured after (``ledger_cost``)."""
  from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger
  book = ExecutableLedger()
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    graphed = list(megastep_learner(torch, dev, flagship, inner_steps, True,
                                    seed, precision, ledger=book))
    eager = list(megastep_learner(torch, dev, flagship, inner_steps, False,
                                  seed, precision))
    walls = {"graphed": [], "eager": []}
    metrics_equal, capture_bytes = True, None
    for dispatch in range(3):
      out = {}
      for name, run in (("graphed", graphed), ("eager", eager)):
        torch.cuda.synchronize()
        if name == "graphed" and dispatch == 1:
          before = torch.cuda.memory_allocated()
          torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        run[0], out[name] = run[2].step(run[0])
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - start)
        if name == "graphed" and dispatch == 1:
          capture_bytes = {
              "peak_over_before": torch.cuda.max_memory_allocated() - before,
              "held_after": torch.cuda.memory_allocated() - before}
      metrics_equal &= out["graphed"] == out["eager"]
    diff = state_diff(torch, graphed[0], eager[0])
    ring_g, ring_e = graphed[1].state.arrays(), eager[1].state.arrays()
    ring_equal = all(np.array_equal(value, ring_e[key])
                     for key, value in ring_g.items())
    builds = dict(graphed[2].compile_counts)
  finally:
    torch.backends.cudnn.deterministic = deterministic
  device_ms = dispatch_device_ms(torch, graphed[2], graphed[0])
  eager_ms = dispatch_device_ms(torch, eager[2], eager[0], reps=1)
  row = ledger_row(torch, book, "megastep", device_ms)
  if cost:
    row["ledger_cost"] = ledger_cost(
        graphed[2].step, graphed[0],
        lambda on: setattr(graphed[2], "_ledger", book if on else None))
  return {
      "model": "flagship_64x64" if flagship else "tinyq_16x16",
      "precision": precision, "inner_steps": inner_steps, **row,
      "bit_equal": bool(metrics_equal and ring_equal
                        and not any(diff.values())),
      "metrics_equal": bool(metrics_equal), "ring_equal": bool(ring_equal),
      "state_max_abs_diff": diff, "compile_counts": builds,
      "dispatch_wall_s_graphed": walls["graphed"],
      "dispatch_wall_s_eager": walls["eager"],
      "capture_s": walls["graphed"][1] - walls["graphed"][2],
      "capture_bytes": capture_bytes,
      "dispatch_device_ms": device_ms,
      "device_ms_per_step": device_ms / inner_steps,
      "eager_dispatch_event_ms": eager_ms,
  }


def trace_idle(path: str) -> dict:
  """The card's busy time (the union of its kernel, copy and set events)
  against the window of a chrome trace, from its first event to its
  last."""
  with open(path) as f:
    events = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
  spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events]
  device = sorted(span for span, e in zip(spans, events)
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
  busy, end = 0.0, None
  for start, stop in device:
    if end is None or start > end:
      busy += stop - start
      end = stop
    elif stop > end:
      busy += stop - end
      end = stop
  window = max(stop for _, stop in spans) - min(start for start, _ in spans)
  return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
          "idle_share": 1.0 - busy / window if window else None,
          "kernels": sum(1 for e in events if e.get("cat") == "kernel")}


def run_device_production(torch, gl, dev, seed: int, root: str, alone: bool
                          ) -> dict:
  """The production device-resident loop with one vector actor (stopped
  after the fill with `alone`), timed by dispatch and profiled over one."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  config = run_qtopt_replay.build_config(
      False, seed, device_resident=True, vector_actors=True,
      profile_window=DEVICE_PROFILE_WINDOW)
  logdir = os.path.join(root, "alone" if alone else "vector")
  replay = ReplayTrainLoop(config, logdir, device=dev)
  starts, ends = [], []
  make = replay._megastep_learner

  def instrumented():
    learner = make()
    step = learner.step

    def timed_step(state):
      starts.append(time.perf_counter())
      out = step(state)
      ends.append(time.perf_counter())
      return out

    learner.step = timed_step
    return learner

  replay._megastep_learner = instrumented
  gc.collect()  # the previous run's ring
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  timed = drive_loop(replay, DEVICE_PRODUCTION_STEPS, gl, alone=alone)
  run = timed.pop("run")
  k = config.megastep_inner
  traced = -(-DEVICE_PROFILE_WINDOW[1] // k)  # the profiled dispatch
  # From the end of the dispatch after it (the trace's export delays that
  # one) to the last.
  steady = ends[traced:]
  traces = sorted(os.listdir(os.path.join(logdir, "profile")))
  idle = trace_idle(os.path.join(logdir, "profile", traces[0]))
  # `learner_steps_per_s` (drive_loop's) is the whole window, from the end
  # of the fill to the end of the run: the one-time cost below, the evals
  # and the profiled dispatch included. `steady_steps_per_s` is the
  # graphed dispatches after the profiled one only.
  return {
      **timed, "steps": run["steps"], "inner_steps": k,
      "dispatch_s": [b - a for a, b in zip(ends, ends[1:])],
      "first_dispatch_s": ends[0] - starts[0],
      "capture_dispatch_s": ends[1] - starts[1],
      "steady_steps_per_s": k * (len(steady) - 1) / (steady[-1] - steady[0]),
      "steady_dispatches": len(steady) - 1,
      "profiled_dispatch": idle, "traces": len(traces),
      "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
      "ring_size": run["buffer"]["replay/size"],
      "env_steps": run["env_steps_collected"],
      "episodes": run["episodes_collected"],
      "param_refreshes": run["param_refreshes"],
      "compile_counts": run["compile_counts"],
      "eval_td_first": run["eval_history"][0]["eval_td_error"],
      "eval_td_last": run["eval_history"][-1]["eval_td_error"],
      "breach_count": run["health"]["breach_count"],
      "device_resident": run["device_resident"],
      "attribution": run["obs"]["attribution"]}


def run_qtopt_device(torch, gl, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 11's phase, parts (a)-(d) above. Raises when a check or the
  smoke's bar fails; the speed bars are reported either way."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay import learner_bench
  result = {"card": smi}

  # (a) Graphs against eager iterations.
  result["graphs"] = []
  for flagship, k in ((False, DEVICE_TINY_K), (True, DEVICE_FLAGSHIP_K)):
    line = megastep_graph_vs_eager(torch, dev, flagship, k, seed,
                                   cost=flagship)
    emit("qtopt_device_graph", card=smi, **line)
    if not (line["bit_equal"]
            and line["compile_counts"] == {"megastep": 1}
            and line["ledger_row"]["compiles"] == 1
            and line["flops_per_dispatch"]):
      raise AssertionError(f"megastep graph vs eager: {line}")
    result["graphs"].append({key: line[key] for key in (
        "model", "inner_steps", "capture_s", "dispatch_device_ms",
        "device_ms_per_step", "flops_per_dispatch", "device_mfu")
        + (("ledger_cost",) if flagship else ())})

  # (b) The smoke through the CLI's run, and (c) the learner bench.
  result["smoke"] = {}
  for s in LOOP_SEEDS:
    start = time.perf_counter()
    run = run_qtopt_replay.run(
        LOOP_SMOKE_STEPS, smoke=True, logdir=os.path.join(root, f"smoke_{s}"),
        seed=s, device=dev, device_resident=True,
        learner_bench=s == LOOP_SEEDS[0])
    ledger = run["compile_counts"]
    line = {"seed": s, "steps": run["steps"],
            "initial_eval_td": run["initial_eval"]["eval_td_error"],
            "final_eval_td": run["final_eval"]["eval_td_error"],
            "eval_td_reduction": run["eval_td_reduction"], "bar": LOOP_BAR,
            "compile_counts": ledger, "episodes": run["episodes_collected"],
            "param_refreshes": run["param_refreshes"],
            "breach_count": run["health"]["breach_count"],
            "seconds": time.perf_counter() - start}
    emit("qtopt_device_smoke", card=smi, **line)
    if not (run["eval_td_reduction"] >= LOOP_BAR and run["device_resident"]
            and ledger.get("megastep") == ledger.get("device_extend") == 1
            and "train_step" not in ledger
            and set(ledger.values()) == {1}):
      raise AssertionError(f"device-resident smoke at seed {s}: {line}")
    result["smoke"][s] = run["eval_td_reduction"]
    if "learner_throughput" in run:
      bench = run["learner_throughput"]
      bars = {
          "speedup_max": bench["speedup"]["max"]
          >= DEVICE_SPEEDUP_BARS["max"],
          "speedup_median": bench["speedup"]["median"]
          >= DEVICE_SPEEDUP_BARS["median"],
          "host_blocked_median": bench["device_megastep"][
              "host_blocked_fraction"]["median"] <= DEVICE_BLOCKED_BAR}
      emit("qtopt_device_learner_bench", card=smi, bars_met=bars, **bench)
      result["bench"] = {"speedup": bench["speedup"], "bars_met": bars}

  # (c) The production loop beside one vector actor, and alone.
  production = {}
  for name, alone in (("vector", False), ("alone", True)):
    line = run_device_production(torch, gl, dev, seed, root, alone)
    emit(f"qtopt_device_production_{name}", card=smi, **line)
    ledger = line["compile_counts"]
    if not (ledger.get("megastep") == 1 and ledger.get("cem_bucket_32") == 1
            and set(ledger.values()) == {1} and line["traces"] == 1
            and line["device_resident"]
            and np.isfinite(line["eval_td_last"])):
      raise AssertionError(f"device-resident production ({name}): {line}")
    # The JAX smoke's sets (tests/test_device_replay.py).
    line["attribution_checked"] = check_attribution(
        line["attribution"], require=("megastep", "device_extend",
                                      "cem_bucket_*"),
        forbid=("train_step",), mfu_row="megastep")
    emit(f"qtopt_device_attribution_{name}", card=smi,
         **line["attribution_checked"])
    production[name] = line
  idle = production["alone"]["profiled_dispatch"]["idle_share"]
  rates = {f"{key}_{name}": line[key] for name, line in production.items()
           for key in ("steady_steps_per_s", "learner_steps_per_s",
                       "first_dispatch_s", "capture_dispatch_s")}
  result["production"] = {
      **rates,
      "steady_alone_over_vector": rates["steady_steps_per_s_alone"]
      / rates["steady_steps_per_s_vector"],
      "window_alone_over_vector": rates["learner_steps_per_s_alone"]
      / rates["learner_steps_per_s_vector"],
      "env_steps_per_s_vector": production["vector"]["env_steps_per_s"],
      "idle_share_vector": production["vector"]["profiled_dispatch"][
          "idle_share"],
      "idle_share_alone": idle,
      "idle_bar": DEVICE_IDLE_BAR, "idle_bar_met": idle < DEVICE_IDLE_BAR,
      "peak_memory_gb": {name: line["peak_memory_gb"]
                         for name, line in production.items()},
      "attribution": {name: line["attribution_checked"]
                      for name, line in production.items()}}

  # (d) Fused resume parity.
  for flagship in (False, True):
    start = time.perf_counter()
    parity = learner_bench.fused_resume_parity(2, 2, seed, device=dev,
                                               flagship=flagship)
    parity["seconds"] = time.perf_counter() - start
    emit("qtopt_device_resume_parity", card=smi, **parity)
    if not parity["parity_ok"]:
      raise AssertionError(f"fused resume parity: {parity}")
    result[f"resume_parity_{parity['model']}"] = parity["parity_ok"]
  return result


ANAKIN_ENVS = 32
ANAKIN_ENV_STEPS = 20
ANAKIN_RASTER_SCENES = 512
# (model, inner steps, train_every, min_fill): dispatch 1 crosses min_fill
# (eager), dispatch 2 captures, dispatch 3 replays.
ANAKIN_GRAPH_CASES = (("tinyq", 16, 4, 320), ("flagship", 16, 8, 384))
ANAKIN_GRAPH_RING = 1024
ANAKIN_PRODUCTION_STEPS = 100  # dispatches of 18, then 25 optimizer steps
ANAKIN_PROFILE_WINDOW = (43, 44)  # the third dispatch
ANAKIN_BLOCKED_BAR = 0.05
ANAKIN_SPEEDUP_BAR = 5.0


def knife_edges(size: int, count: int, seed: int) -> np.ndarray:
  """The `count` of 2M random float32 targets whose disc edge (radius 0.1
  at `size`) passes closest to a pixel centre, the centres in float32 as
  NumPy 2's ``pose_to_pixel`` computes them: where float32 distance
  arithmetic flips pixels."""
  from tensor2robot_tpu_torch.research.qtopt import device_grasping as dg
  targets = np.random.default_rng(seed).uniform(
      -0.8, 0.8, (2_000_000, 2)).astype(np.float32)
  px = ((targets[:, 0] + np.float32(1)) / np.float32(2)
        * np.float32(size - 1)).astype(np.float64)
  py = ((np.float32(1) - (targets[:, 1] + np.float32(1)) / np.float32(2))
        * np.float32(size - 1)).astype(np.float64)
  gap = np.full(len(targets), np.inf)
  for ox in range(-4, 5):
    for oy in range(-4, 5):
      d2 = (np.floor(px) + ox - px) ** 2 + (np.floor(py) + oy - py) ** 2
      gap = np.minimum(gap, np.abs(d2 - dg._r2(0.1, size)))
  return targets[np.argsort(gap)[:count]]


def oracle_scenes(targets, size: int) -> np.ndarray:
  """``draw_disc``'s images of `targets` over the loop's fixed scene."""
  from tensor2robot_tpu_torch.research.pose_env import pose_env
  from tensor2robot_tpu_torch.research.qtopt import device_grasping as dg
  images = np.stack([dg._base_image(size) for _ in targets])
  for image, target in zip(images, targets):
    pose_env.draw_disc(image, tuple(target), radius=0.1,
                       color=pose_env.TARGET_COLOR)
  return images


def anakin_env_on_card(torch, dev, seed: int) -> dict:
  """The production fleet's env on the card against the numpy oracle: the
  rasterizer over a bank's targets against the bank's oracle images, the
  procedural mode's images against the oracle's draw_disc, both again on
  knife-edge targets and grasps (where float32 or fused arithmetic
  flips them), and 20 lockstep steps of 32 envs at 64x64 (images,
  targets, rewards, dones, truncations, the counts), bit for bit."""
  from tensor2robot_tpu_torch.research.qtopt import device_grasping as dg
  from tensor2robot_tpu_torch.research.qtopt.synthetic_grasping import (
      VectorGraspEnv,
      grasp_success,
  )
  bank = dg.make_scene_bank(ANAKIN_RASTER_SCENES, image_size=64,
                            base_seed=seed, device=dev)
  env = dg.DeviceGraspEnv(ANAKIN_ENVS, image_size=64, max_attempts=3,
                          radius=0.4, bank=bank, device=dev)
  rendered = env.render_scenes(bank.targets).cpu().numpy()
  raster_equal = bool(np.array_equal(rendered, bank.images.cpu().numpy()))
  draws = dg.procedural_draws(seed, 0, ANAKIN_ENVS)
  procedural_equal = bool(np.array_equal(
      env.render_scenes(draws).cpu().numpy(), oracle_scenes(draws, 64)))
  edges = knife_edges(64, 64, seed)
  knife_raster_equal = bool(np.array_equal(
      env.render_scenes(edges).cpu().numpy(), oracle_scenes(edges, 64)))
  # Grasps at the radius's edge: the success test's float32 arithmetic.
  rng = np.random.default_rng(seed)
  count = 20_000
  targets = rng.uniform(-0.8, 0.8, (count, 2)).astype(np.float32)
  angle = rng.uniform(0, 2 * np.pi, count)
  actions = np.zeros((count, 4), np.float32)
  actions[:, 0] = targets[:, 0] + 0.4 * np.cos(angle)
  actions[:, 1] = targets[:, 1] + 0.4 * np.sin(angle)
  edge_env = dg.DeviceGraspEnv(count, image_size=12, radius=0.4, device=dev)
  _, (rewards, _, _) = edge_env.step_fn()(
      edge_env.init_state(targets), torch.from_numpy(actions).to(dev),
      dg.procedural_draws(seed, 1, count))
  knife_success_equal = bool(np.array_equal(
      rewards.cpu().numpy(), grasp_success(targets, actions, 0.4)))
  state, step = env.init_state(), env.step_fn()
  venv = VectorGraspEnv(ANAKIN_ENVS, image_size=64, max_attempts=3,
                        radius=0.4)
  counter = iter(dg.scene_seed_stream(seed, 10 ** 4))
  venv.reset([int(next(counter)) for _ in range(ANAKIN_ENVS)])
  rng = np.random.default_rng(seed + 100)
  steps_equal, resets = True, 0
  for _ in range(ANAKIN_ENV_STEPS):
    steps_equal &= (np.array_equal(state.images.cpu().numpy(), venv.images)
                    and np.array_equal(state.targets.cpu().numpy(),
                                       venv.targets))
    actions = rng.uniform(-1, 1, (ANAKIN_ENVS, 4)).astype(np.float32)
    # Half the fleet grasps at its object: successes as well as misses.
    actions[::2, :2] = venv.targets[::2]
    want = venv.step(actions, seed_fn=lambda: int(next(counter)))
    _, got = step(state, torch.from_numpy(actions).to(dev))
    steps_equal &= all(np.array_equal(g.cpu().numpy(), w)
                       for g, w in zip(got, want))
    resets += int(want[1].sum() + want[2].sum())
  steps_equal &= (int(state.episodes) == venv.episodes
                  and int(state.successes) == venv.successes)
  return {"rasterizer_bit_equal": raster_equal,
          "raster_scenes": ANAKIN_RASTER_SCENES,
          "procedural_bit_equal": procedural_equal,
          "knife_edge_raster_bit_equal": knife_raster_equal,
          "knife_edge_success_bit_equal": knife_success_equal,
          "steps_bit_equal": bool(steps_equal), "steps": ANAKIN_ENV_STEPS,
          "envs": ANAKIN_ENVS, "resets": resets,
          "episodes": venv.episodes, "successes": venv.successes}


def anakin_loop(torch, dev, flagship: bool, inner: int, train_every: int,
                min_fill: int, graphs: bool, seed: int,
                precision: str = "f32", ledger=None):
  """(state, ring, loop): an AnakinLoop of 32 envs over a bank of 256
  scenes and a prioritized ring of ANAKIN_GRAPH_RING, the health keys on;
  TinyQ at 16x16 (CEM 16/4/2) or the production loop's 64x64 critic (CEM
  64/6/3); acting and labels scored at `precision`."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay.anakin import AnakinLoop
  from tensor2robot_tpu_torch.replay.device_buffer import DeviceReplayBuffer
  from tensor2robot_tpu_torch.replay.loop import (
      ReplayTrainLoop,
      transition_spec,
  )
  from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
  from tensor2robot_tpu_torch.research.qtopt import device_grasping as dg
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils import optimizers
  c = run_qtopt_replay.build_config(not flagship, seed, anakin=True)
  model = (ReplayTrainLoop._default_model(types.SimpleNamespace(config=c))
           if flagship else TinyQCriticModel(
               optimizer_fn=optimizers.create_adam_optimizer(
                   c.learning_rate)))
  trainer = Trainer(model, seed=seed, device=dev)
  state = trainer.create_train_state()
  ring = DeviceReplayBuffer(transition_spec(c.image_size, c.action_size),
                            ANAKIN_GRAPH_RING, c.batch_size, seed=seed,
                            prioritized=True, ingest_chunk=ANAKIN_ENVS,
                            device=dev)
  env = dg.DeviceGraspEnv(
      ANAKIN_ENVS, image_size=c.image_size, max_attempts=c.max_attempts,
      radius=c.grasp_radius, device=dev,
      bank=dg.make_scene_bank(256, image_size=c.image_size, base_seed=seed,
                              device=dev))
  loop = AnakinLoop(
      model, trainer, ring, env, action_size=c.action_size, gamma=c.gamma,
      num_samples=c.cem_num_samples, num_elites=c.cem_num_elites,
      iterations=c.cem_iterations, inner_steps=inner,
      train_every=train_every, min_fill=min_fill,
      exploration_epsilon=c.exploration_epsilon,
      scripted_fraction=c.scripted_fraction, seed=seed + 13, health=True,
      graphs=graphs, precision=precision, ledger=ledger)
  loop.refresh(state.variables(use_ema=True), step=0)
  return state, ring, loop


def anakin_graph_vs_eager(torch, dev, case, seed: int,
                          precision: str = "f32", cost: bool = False) -> dict:
  """Three dispatches of a graphed loop (the first eager across min_fill,
  the second captures the period, the third replays it; a refresh after
  the second) against three eager ones, with cuDNN deterministic; then the
  capture's seconds and memory and a period's device time. The graphed
  loop keeps an executable ledger (the eager dispatch's learning period
  counts the FLOPs); with `cost` the ledger's cost is measured after."""
  from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger
  name, inner, train_every, min_fill = case
  flagship = name == "flagship"
  book = ExecutableLedger()
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    runs = {graphs: list(anakin_loop(torch, dev, flagship, inner,
                                     train_every, min_fill, graphs, seed,
                                     precision,
                                     ledger=book if graphs else None))
            for graphs in (True, False)}
    walls = {True: [], False: []}
    metrics_equal, capture_bytes, trained = True, None, []
    for dispatch in range(3):
      out = {}
      for graphs, run in runs.items():
        torch.cuda.synchronize()
        if graphs and dispatch == 1:
          before = torch.cuda.memory_allocated()
          torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        run[0], out[graphs] = run[2].step(run[0])
        torch.cuda.synchronize()
        walls[graphs].append(time.perf_counter() - start)
        if graphs and dispatch == 1:
          capture_bytes = {
              "peak_over_before": torch.cuda.max_memory_allocated() - before,
              "held_after": torch.cuda.memory_allocated() - before}
        if dispatch == 1:
          run[2].refresh(run[0].variables(use_ema=True), run[0].step)
      metrics_equal &= out[True] == out[False]
      trained.append(out[True]["trained_steps"])
    (gstate, gring, gloop), (estate, ering, eloop) = runs[True], runs[False]
    diff = state_diff(torch, gstate, estate)
    carried_equal = all(
        np.array_equal(value, theirs[key])
        for ours, theirs in ((gring.state.arrays(), ering.state.arrays()),
                             (gloop.env_state.arrays(),
                              eloop.env_state.arrays()))
        for key, value in ours.items())
    builds = (dict(gloop.compile_counts), dict(eloop.compile_counts))
  finally:
    torch.backends.cudnn.deterministic = deterministic
  # A graphed dispatch's device time, CUDA events around its replays.
  times = []
  for _ in range(3):
    gloop._stage_draws(gloop._outer % 2, None)
    start_event = torch.cuda.Event(enable_timing=True)
    end_event = torch.cuda.Event(enable_timing=True)
    start_event.record()
    gloop._dispatch(gstate, [True] * gloop.periods)
    end_event.record()
    end_event.synchronize()
    times.append(start_event.elapsed_time(end_event))
  dispatch_ms = float(np.median(times))
  row = ledger_row(torch, book, "anakin_step", dispatch_ms)
  if cost:
    row["ledger_cost"] = ledger_cost(
        gloop.step, gstate, lambda on: setattr(gloop, "_ledger",
                                               book if on else None))
  return {
      "model": "flagship_64x64" if flagship else "tinyq_16x16",
      "precision": precision, "dtype": gloop.dtype, **row,
      "envs": ANAKIN_ENVS, "inner_steps": inner, "train_every": train_every,
      "min_fill": min_fill, "trained_steps": trained,
      "bit_equal": bool(metrics_equal and carried_equal
                        and not any(diff.values())),
      "metrics_equal": bool(metrics_equal),
      "env_and_ring_equal": bool(carried_equal),
      "state_max_abs_diff": diff, "compile_counts": builds[0],
      "compile_counts_eager": builds[1],
      "dispatch_wall_s_graphed": walls[True],
      "dispatch_wall_s_eager": walls[False],
      "capture_s": walls[True][1] - walls[True][2],
      "capture_bytes": capture_bytes,
      "dispatch_device_ms": dispatch_ms,
      "device_ms_per_control_step": dispatch_ms / inner,
  }


def trace_top_kernels(path: str, count: int = 8) -> list:
  """The `count` kernels of a chrome trace that took the most device time,
  by name (cut to 80 characters), with their calls and share of it."""
  with open(path) as f:
    events = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "kernel"]
  totals = {}
  for e in events:
    name = e.get("name", "?")[:80]
    ms, calls = totals.get(name, (0.0, 0))
    totals[name] = (ms + float(e.get("dur", 0.0)) / 1e3, calls + 1)
  whole = sum(ms for ms, _ in totals.values()) or 1.0
  return [{"kernel": name, "ms": ms, "calls": calls, "share": ms / whole}
          for name, (ms, calls) in sorted(totals.items(),
                                          key=lambda kv: -kv[1][0])[:count]]


def run_anakin_production(torch, dev, seed: int, root: str,
                          precision: str = "f32",
                          steps: int = ANAKIN_PRODUCTION_STEPS,
                          profile: bool = True) -> dict:
  """``run_qtopt_replay --anakin`` at full width (the flagship 64x64
  critic, 32 envs, anakin_inner 200, train_every 8, a bank of 4,096
  scenes, CEM 64/6/3, a ring of 50,000, min_fill 2,000) at `precision`
  for `steps` optimizer steps, timed by dispatch and, with `profile`,
  profiled over the third."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  config = run_qtopt_replay.build_config(
      False, seed, anakin=True, precision=precision,
      profile_window=ANAKIN_PROFILE_WINDOW if profile else None)
  logdir = os.path.join(root, f"anakin_production_{precision}")
  replay = ReplayTrainLoop(config, logdir, device=dev)
  starts, ends, trained, made = [], [], [], {}
  make = replay._anakin_loop

  def instrumented():
    start = time.perf_counter()
    loop = make()
    made["loop_build_s"] = time.perf_counter() - start
    step = loop.step

    def timed_step(state, draws=None):
      starts.append(time.perf_counter())
      out = step(state, draws)
      ends.append(time.perf_counter())
      trained.append(out[1]["trained_steps"])
      return out

    loop.step = timed_step
    made["loop"] = loop
    return loop

  replay._anakin_loop = instrumented
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  run = replay.run(steps)
  wall = time.perf_counter() - start
  loop = made["loop"]
  per_dispatch = config.anakin_inner * ANAKIN_ENVS
  # The profiled dispatch is the one whose steps reach the window's end;
  # the one after it pays the trace's export before it starts, so the
  # steady window runs from that one's end to the last. Unprofiled, it
  # runs from the capture's dispatch's end.
  after = (next(i for i in range(len(trained))
                if sum(trained[:i + 1]) >= ANAKIN_PROFILE_WINDOW[1]) + 1
           if profile else 1)
  steady = ends[after:]
  window = ends[-1] - starts[0]
  profiled = {}
  if profile:
    traces = sorted(os.listdir(os.path.join(logdir, "profile")))
    trace = os.path.join(logdir, "profile", traces[0])
    profiled = {"profiled_dispatch": trace_idle(trace),
                "traces": len(traces),
                "top_kernels": trace_top_kernels(trace)}
  return {
      "precision": precision, "dtype": loop.dtype,
      "steps": run["steps"], "dispatches": len(ends),
      "trained_by_dispatch": trained, "inner_steps": config.anakin_inner,
      "train_every": config.anakin_train_every, "envs": ANAKIN_ENVS,
      "bank_scenes": config.anakin_bank_scenes,
      "capacity": config.capacity, "min_fill": config.min_fill,
      "wall_s": wall, "loop_build_s": made["loop_build_s"],
      "env_steps_per_s": len(ends) * per_dispatch / window,
      "train_steps_per_s": sum(trained) / window,
      "steady_env_steps_per_s": (len(steady) - 1) * per_dispatch
      / (steady[-1] - steady[0]),
      "steady_train_steps_per_s": sum(trained[after + 1:])
      / (steady[-1] - steady[0]),
      "steady_dispatches": len(steady) - 1,
      "dispatch_s": [b - a for a, b in zip(starts, ends)],
      "first_dispatch_s": ends[0] - starts[0],
      "capture_dispatch_s": ends[1] - starts[1],
      "capture_s": (ends[1] - starts[1]) - (ends[-1] - starts[-1]),
      "exec_s": loop.exec_seconds, **profiled,
      "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
      "ring_size": run["buffer"]["replay/size"],
      "env_steps": run["env_steps_collected"],
      "episodes": run["episodes_collected"],
      "success_rate": run["collector_success_rate"],
      "param_refreshes": run["param_refreshes"],
      "compile_counts": run["compile_counts"],
      "queue_enqueued": run["queue"]["enqueued"],
      "eval_td_first": run["eval_history"][0]["eval_td_error"],
      "eval_td_last": run["eval_history"][-1]["eval_td_error"],
      "breach_count": run["health"]["breach_count"],
      "attribution": run["obs"]["attribution"]}


def run_qtopt_anakin(torch, gl, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 12's phase: (a) the env and the rasterizer on the card against
  the oracle; (b) the period's graph against eager periods, TinyQ and the
  64x64 critic; (c) ``--smoke --anakin`` at LOOP_SEEDS with the
  Anakin bench; (d) the production ``--anakin`` run; (e) fused resume.
  Raises when a check or the smoke's bar fails; the bench's bars are
  reported either way."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay import anakin_bench
  result = {"card": smi}

  # (a) The env and the rasterizer.
  line = anakin_env_on_card(torch, dev, seed)
  emit("qtopt_anakin_env", card=smi, **line)
  if not (line["rasterizer_bit_equal"] and line["procedural_bit_equal"]
          and line["knife_edge_raster_bit_equal"]
          and line["knife_edge_success_bit_equal"]
          and line["steps_bit_equal"] and line["resets"] >= 3):
    raise AssertionError(f"the device env against the oracle: {line}")
  result["env_bit_equal"] = True

  # (b) Graphs against eager periods.
  result["graphs"] = []
  for case in ANAKIN_GRAPH_CASES:
    flagship = case[0] == "flagship"
    line = anakin_graph_vs_eager(torch, dev, case, seed, cost=flagship)
    emit("qtopt_anakin_graph", card=smi, **line)
    if not (line["bit_equal"] and line["trained_steps"][0] > 0
            and line["compile_counts"] == line["compile_counts_eager"]
            == {"anakin_step": 1}
            and line["ledger_row"]["compiles"] == 1
            and line["flops_per_dispatch"]):
      raise AssertionError(f"Anakin graph vs eager: {line}")
    result["graphs"].append({key: line[key] for key in (
        "model", "capture_s", "dispatch_device_ms",
        "device_ms_per_control_step", "flops_per_dispatch", "device_mfu")
        + (("ledger_cost",) if flagship else ())})

  # (c) The smoke through the CLI's run, with the bench at the first seed.
  result["smoke"] = {}
  with CountReplays(gl) as replays:
    for s in LOOP_SEEDS:
      start = time.perf_counter()
      run = run_qtopt_replay.run(
          LOOP_SMOKE_STEPS, smoke=True,
          logdir=os.path.join(root, f"anakin_smoke_{s}"), seed=s,
          device=dev, anakin=True, anakin_bench=s == LOOP_SEEDS[0])
      ledger = run["compile_counts"]
      line = {"seed": s, "steps": run["steps"],
              "initial_eval_td": run["initial_eval"]["eval_td_error"],
              "final_eval_td": run["final_eval"]["eval_td_error"],
              "eval_td_reduction": run["eval_td_reduction"],
              "bar": LOOP_BAR, "compile_counts": ledger,
              "episodes": run["episodes_collected"],
              "env_steps": run["env_steps_collected"],
              "queue_enqueued": run["queue"]["enqueued"],
              "param_refreshes": run["param_refreshes"],
              "breach_count": run["health"]["breach_count"],
              "seconds": time.perf_counter() - start}
      emit("qtopt_anakin_smoke", card=smi, **line)
      if not (run["eval_td_reduction"] >= LOOP_BAR and run["anakin"]
              and ledger == {"anakin_step": 1, "bellman_td_error": 1}
              and run["queue"]["enqueued"] == 0
              and run["episodes_collected"] > 50):
        raise AssertionError(f"Anakin smoke at seed {s}: {line}")
      result["smoke"][s] = run["eval_td_reduction"]
      if "anakin_throughput" in run:
        bench = run["anakin_throughput"]
        bars = {
            "host_blocked_median": bench["anakin"]["host_blocked_fraction"][
                "median"] <= ANAKIN_BLOCKED_BAR,
            "speedup_median": bench["speedup"]["median"]
            >= ANAKIN_SPEEDUP_BAR}
        emit("qtopt_anakin_bench", card=smi, bars_met=bars, **bench)
        if bench["compile_counts"] != {"vector_cem_bucket_32": 1,
                                       "megastep": 1, "anakin_step": 1}:
          raise AssertionError(f"Anakin bench builds: {bench}")
        result["bench"] = {"speedup": bench["speedup"],
                           "host_blocked": bench["anakin"][
                               "host_blocked_fraction"],
                           "bars_met": bars}
  result["smoke_graph_replays"] = replays.replays

  # (d) The production run.
  line = run_anakin_production(torch, dev, seed, root)
  emit("qtopt_anakin_production", card=smi, **line)
  if not (line["steps"] >= 100 and line["compile_counts"] == {
      "anakin_step": 1, "bellman_td_error": 1} and line["traces"] == 1
          and line["queue_enqueued"] == 0 and line["breach_count"] == 0
          and np.isfinite(line["eval_td_last"])):
    raise AssertionError(f"Anakin production: {line}")
  # The JAX smoke's sets (tests/test_anakin.py); one thread, so the whole
  # window.
  attribution = check_attribution(
      line["attribution"], require=("anakin_step",),
      forbid=("megastep", "train_step", "device_extend"),
      mfu_row="anakin_step", whole=True)
  if any(name.startswith("cem_bucket_") for name in attribution["rows"]):
    raise AssertionError(f"Anakin production's ledger: {attribution}")
  emit("qtopt_anakin_attribution", card=smi, **attribution)
  result["production"] = {key: line[key] for key in (
      "steps", "env_steps_per_s", "train_steps_per_s",
      "steady_env_steps_per_s", "steady_train_steps_per_s",
      "first_dispatch_s", "capture_s", "peak_memory_gb")}
  result["production"]["attribution"] = attribution
  result["production"]["idle_share"] = line["profiled_dispatch"][
      "idle_share"]

  # (e) Fused resume.
  start = time.perf_counter()
  parity = anakin_bench.anakin_resume_parity(2, 2, seed, device=dev)
  parity["seconds"] = time.perf_counter() - start
  emit("qtopt_anakin_resume_parity", card=smi, **parity)
  if not parity["parity_ok"]:
    raise AssertionError(f"Anakin fused resume parity: {parity}")
  result["resume_parity"] = True
  return result


# Slice 13: the bf16 and int8 scoring tiers. (a) CEMFleetPolicy at each tier
# over TinyQ 16x16 (the smoke's CEM 16/4/2), every rung's graph against its
# eager control bit for bit (cuDNN deterministic), one capture a rung over
# 3 hot reloads; (b) the precision bench's agreement phase (bf16 >= 0.95)
# and the int8 bench's (>= 0.99) at q_tol 0.05 on a trained TinyQ; (c) the
# megastep and the Anakin loop at bf16, graphs against eager bit for bit;
# (d) run_qtopt_replay --smoke --anakin at f32 and bf16 at LOOP_SEEDS,
# the bf16 reduction >= 0.30 and its converged-phase mean within 0.05 of
# f32's; (e) the flagship's int8 served bytes >= 3x smaller; (f) each
# tier's 472x472 fleet replays by rung, the megastep's device ms a step at
# 64x64 (K = 50) and the production --anakin run's steady rates.
PRECISION_TIERS = ("bf16", "int8")
PRECISION_CEM = dict(num_samples=16, num_elites=4, iterations=2)
PRECISION_PRODUCTION_STEPS = 60  # dispatches of 18, then 25 steps
PRECISION_FLEET_RUNGS = (1, 16)  # each tier's 472x472 timings


def tier_policy_graphs(torch, dev, seed: int, tier: str) -> dict:
  """(a): the TinyQ fleet policy's graphs at `tier` against its eager
  control at every rung, before and after FLEET_RELOADS hot reloads."""
  from tensor2robot_tpu_torch.replay.loop import _HotReloadPredictor
  from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.serving import CEMFleetPolicy
  model = TinyQCriticModel()

  def variables(s):
    return model.init_variables(torch.Generator().manual_seed(s), device=dev)

  predictor = _HotReloadPredictor(model, variables(seed))
  policy = CEMFleetPolicy(predictor, action_size=4, seed=seed,
                          precision=tier, **PRECISION_CEM)
  scenes, _ = sg.sample_scenes(max(FLEET_RUNGS), 16, seed + 5)

  def graph_vs_eager(bucket):
    images = list(scenes[:bucket])
    seeds = np.arange(bucket, dtype=np.uint32)
    graphed, scores = policy(images, seeds, return_scores=True)
    fn, _ = predictor.device_fn()
    with torch.inference_mode():
      eager, eager_scores = policy._control(
          fn, torch.from_numpy(np.stack(images)).to(dev),
          torch.from_numpy(policy.noise_for(seeds)).to(dev))
    if not (np.array_equal(graphed, eager.cpu().numpy())
            and np.array_equal(scores, eager_scores.cpu().numpy())
            and scores.dtype == np.float32 and np.isfinite(graphed).all()
            and np.abs(graphed).max() <= 1.0):
      raise AssertionError(f"{tier} bucket {bucket}: the graph gives "
                           f"{graphed}, the eager control "
                           f"{eager.cpu().numpy()}")
    return graphed

  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    for bucket in FLEET_RUNGS:
      graph_vs_eager(bucket)
    before = graph_vs_eager(2)
    for reload in range(1, FLEET_RELOADS + 1):
      predictor.set_variables(variables(seed + reload))
      for bucket in FLEET_RUNGS:
        graph_vs_eager(bucket)
  finally:
    torch.backends.cudnn.deterministic = deterministic
  int8 = sorted({str(v["int8_q"].dtype) for v in policy._served.values()
                 if isinstance(v, dict)})
  line = {"tier": tier, "model": "tinyq_16x16", "cem": PRECISION_CEM,
          "rungs": list(FLEET_RUNGS), "reloads": FLEET_RELOADS,
          "graph_equals_eager": True,
          "reload_changed_actions": not np.array_equal(graph_vs_eager(2),
                                                       before),
          "compile_counts": dict(policy.compile_counts),
          "served_int8_dtypes": int8,
          "model_version": predictor.model_version}
  if not (line["reload_changed_actions"]
          and policy.compile_counts == {b: 1 for b in FLEET_RUNGS}
          and (int8 == ["torch.int8"]) == (tier == "int8")):
    raise AssertionError(f"the {tier} fleet policy: {line}")
  return line


def tier_fleet_timings(torch, dev, seed: int, tier: str, smi: str) -> list:
  """(f): the 472x472 uint8 GroupNorm critic's fleet policy at `tier`,
  CEM 64/6/3, at PRECISION_FLEET_RUNGS (every rung until slice 17's phases
  joined, rungs 1, 4 and 16 until slice 18's): graph against eager bit
  for bit, request ms,
  replay device ms, peak memory."""
  from tensor2robot_tpu_torch.replay.loop import _HotReloadPredictor
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      IMAGE_SIZE,
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.serving import CEMFleetPolicy
  model = QTOptGraspingModel(uint8_images=True, norm="group")
  predictor = _HotReloadPredictor(model, model.init_variables(
      torch.Generator().manual_seed(seed), device=dev))
  policy = CEMFleetPolicy(predictor, action_size=4, seed=seed,
                          precision=tier, **CEM_SERVING)
  scenes, _ = sg.sample_scenes(max(FLEET_RUNGS), IMAGE_SIZE, seed + 5)
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  rungs = []
  try:
    for bucket in PRECISION_FLEET_RUNGS:
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      held_mib = torch.cuda.memory_allocated() / 2**20
      images = list(scenes[:bucket])
      seeds = np.arange(bucket, dtype=np.uint32)
      begin = time.perf_counter()
      graphed = policy(images, seeds)
      first_s = time.perf_counter() - begin
      fn, _ = predictor.device_fn()
      with torch.inference_mode():
        eager, _ = policy._control(
            fn, torch.from_numpy(np.stack(images)).to(dev),
            torch.from_numpy(policy.noise_for(seeds)).to(dev))
      if not np.array_equal(graphed, eager.cpu().numpy()):
        raise AssertionError(f"{tier} at 472x472, bucket {bucket}: graph "
                             f"{graphed} against eager {eager.cpu().numpy()}")
      calls = []
      for _ in range(3):
        begin = time.perf_counter()
        policy(images)
        calls.append((time.perf_counter() - begin) * 1e3)
      key = (bucket, scenes.shape[1:], scenes.dtype)
      rungs.append({
          "tier": tier, "bucket": bucket,
          "images_per_cem_iteration": bucket * CEM_SERVING["num_samples"],
          "graph_equals_eager": True, "first_call_s": first_s,
          "request_ms_median": float(np.median(calls)),
          "replay_device_ms": stream_ms(
              torch, lambda: policy._buckets[key].graph.replay(), inner=3,
              reps=3),
          "held_mib": held_mib,
          "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20})
      emit("qtopt_precision_fleet", card=smi, **rungs[-1])
  finally:
    torch.backends.cudnn.deterministic = deterministic
  if policy.compile_counts != {b: 1 for b in PRECISION_FLEET_RUNGS}:
    raise AssertionError(f"{tier} fleet captures: {policy.compile_counts}")
  del policy, predictor
  gc.collect()
  torch.cuda.empty_cache()
  return rungs


def tier_megastep_ms(torch, dev, seed: int, tier: str) -> dict:
  """(f): the production megastep (64x64 critic, K = 50, CEM 64/6/3) at
  `tier`: two dispatches (eager, then the capture), then a graphed
  dispatch's device time."""
  state, _, learner = megastep_learner(torch, dev, True, DEVICE_FLAGSHIP_K,
                                       True, seed, tier)
  for _ in range(2):
    state, metrics = learner.step(state)
  ms = dispatch_device_ms(torch, learner, state)
  out = {"tier": tier, "inner_steps": DEVICE_FLAGSHIP_K,
         "dispatch_device_ms": ms,
         "device_ms_per_step": ms / DEVICE_FLAGSHIP_K,
         "compile_counts": dict(learner.compile_counts),
         "td_error": metrics["td_error"]}
  del state, learner
  gc.collect()
  torch.cuda.empty_cache()
  if not (out["compile_counts"] == {"megastep": 1}
          and np.isfinite(out["td_error"])):
    raise AssertionError(f"the {tier} megastep: {out}")
  return out


def run_qtopt_precision(torch, dev, seed: int, root: str, smi: str,
                        f32_production: dict) -> dict:
  """Slice 13's phase, parts (a)-(f) (see the constants above). Raises
  when a check or a bar fails. `f32_production` is the f32 production
  --anakin run of this call (``qtopt_anakin``), which (f) sits beside."""
  from tensor2robot_tpu_torch.replay import precision_bench, tpquant_bench
  result = {"card": smi}

  # (a) The fleet policy's graphs at each tier.
  result["policy"] = {}
  for tier in PRECISION_TIERS:
    line = tier_policy_graphs(torch, dev, seed, tier)
    emit("qtopt_precision_policy", card=smi, **line)
    result["policy"][tier] = line["compile_counts"]

  # (c) The megastep and the Anakin loop at bf16, graphs against eager.
  line = megastep_graph_vs_eager(torch, dev, False, DEVICE_TINY_K, seed,
                                 "bf16")
  emit("qtopt_precision_megastep_graph", card=smi, **line)
  if not (line["bit_equal"] and line["compile_counts"] == {"megastep": 1}):
    raise AssertionError(f"bf16 megastep graph vs eager: {line}")
  result["graphs"] = [{key: line[key] for key in (
      "model", "precision", "device_ms_per_step")}]
  for case in ANAKIN_GRAPH_CASES:
    line = anakin_graph_vs_eager(torch, dev, case, seed, "bf16")
    emit("qtopt_precision_anakin_graph", card=smi, **line)
    if not (line["bit_equal"] and line["trained_steps"][0] > 0
            and line["dtype"] == "bfloat16"
            and line["compile_counts"] == line["compile_counts_eager"]
            == {"anakin_step": 1}):
      raise AssertionError(f"bf16 Anakin graph vs eager: {line}")
    result["graphs"].append({key: line[key] for key in (
        "model", "precision", "device_ms_per_control_step")})

  # (b) and (e) The benches, each raising on its bars.
  start = time.perf_counter()
  bench = precision_bench.measure_precision(fused_loop=False, seed=seed,
                                            device=dev)
  bench["seconds"] = time.perf_counter() - start
  emit("qtopt_precision_agreement", card=smi, **bench)
  start = time.perf_counter()
  quant = tpquant_bench.measure_tpquant(seed=seed, device=dev)
  quant["seconds"] = time.perf_counter() - start
  emit("qtopt_precision_int8", card=smi, **quant)
  # The tier ledgers: every bucket built once at f32 and at each tier
  # (the benches raise on this bar too; held here by name).
  from tensor2robot_tpu_torch.obs.ledger import check_compile_ledger
  result["tier_ledger"] = {}
  for tier, run, buckets in (("bf16", bench, precision_bench.R14_BUCKETS),
                             ("int8", quant, tpquant_bench.R17_BUCKETS)):
    book = run["tier_ledger"]
    check_compile_ledger(
        book["compile_counts"],
        require=[f"cem_bucket_{b}{suffix}" for b in buckets
                 for suffix in ("", f"_{tier}")])
    if not (book["per_tier_exactly_once"]
            and set(book["tier_shares"]) == {"f32", tier}):
      raise AssertionError(f"the {tier} tier ledger: {book}")
    result["tier_ledger"][tier] = book
  emit("qtopt_precision_tier_ledger", card=smi, **result["tier_ledger"])
  result["bf16_agreement"] = bench["agreement"]["overall_rate"]
  result["int8_agreement"] = quant["int8_agreement"]["overall_rate"]
  result["int8_bytes_reduction"] = quant["int8_bytes_reduction"]

  # (d) The Anakin smoke at f32 and bf16, at each of LOOP_SEEDS.
  result["fused_loop"] = {}
  for s in LOOP_SEEDS:
    start = time.perf_counter()
    fused = precision_bench._measure_fused_loop(LOOP_SMOKE_STEPS, s,
                                                device=dev)
    fused["seconds"] = time.perf_counter() - start
    emit("qtopt_precision_fused_loop", card=smi, seed=s, **fused)
    bf16 = fused["bf16"]
    if not (bf16["eval_td_reduction_final_point"] >= LOOP_BAR
            and fused["td_delta"] <= precision_bench.R14_TD_DELTA_BAR
            and bf16["precision"] == "bf16"
            and all(fused[t]["ledger_all_one"]
                    and fused[t]["anakin_step_compiles"] == 1
                    for t in ("f32", "bf16"))):
      raise AssertionError(f"the bf16 Anakin smoke at seed {s}: {fused}")
    result["fused_loop"][s] = {
        tier: {key: fused[tier][key] for key in (
            "eval_td_reduction_final_point",
            "eval_td_reduction_converged")} for tier in ("f32", "bf16")}
    result["fused_loop"][s]["td_delta"] = fused["td_delta"]

  # (f) Timings beside f32, in this call.
  fleet = {}
  for tier in ("f32",) + PRECISION_TIERS:
    fleet[tier] = tier_fleet_timings(torch, dev, seed, tier, smi)
  result["fleet_replay_device_ms"] = {
      tier: {r["bucket"]: r["replay_device_ms"] for r in rungs}
      for tier, rungs in fleet.items()}
  result["fleet_peak_memory_mib"] = {
      tier: {r["bucket"]: r["peak_memory_mib"] for r in rungs}
      for tier, rungs in fleet.items()}
  megastep = {}
  for tier in ("f32",) + PRECISION_TIERS:
    megastep[tier] = tier_megastep_ms(torch, dev, seed, tier)
    emit("qtopt_precision_megastep", card=smi, **megastep[tier])
  result["megastep_device_ms_per_step"] = {
      tier: line["device_ms_per_step"] for tier, line in megastep.items()}
  production = {"f32": f32_production}
  for tier in PRECISION_TIERS:
    line = run_anakin_production(torch, dev, seed, root, precision=tier,
                                 steps=PRECISION_PRODUCTION_STEPS,
                                 profile=False)
    emit("qtopt_precision_anakin_production", card=smi, **line)
    if not (line["steps"] >= PRECISION_PRODUCTION_STEPS
            and line["compile_counts"] == {"anakin_step": 1,
                                           "bellman_td_error": 1}
            and line["queue_enqueued"] == 0 and line["breach_count"] == 0
            and np.isfinite(line["eval_td_last"])):
      raise AssertionError(f"{tier} Anakin production: {line}")
    production[tier] = {key: line[key] for key in (
        "steady_env_steps_per_s", "steady_train_steps_per_s",
        "env_steps_per_s", "train_steps_per_s", "first_dispatch_s",
        "capture_s", "peak_memory_gb")}
  result["anakin_production"] = production
  return result


# Slice 14. (a) obs_loop: run_qtopt_replay --smoke with a --profile
# window, on the host path, then device-resident, under a started watchdog:
# the trace holds the loop's spans as record_function ranges, the result's
# trace_stage_counts covers the loop's stages, the learner, feeder and
# collector heartbeats beat and no stall fires, and the registry's gauges
# equal the JSONL records; the spans' share of the window and their cost
# are reported. (b) serve_fleet: bench_serving --fleet --smoke at 16
# clients, then FleetServer over CEMFleetPolicy over CheckpointPredictor
# restored from a model_dir at 472x472 (CEM 64/6/3): 16 client threads, a
# held flush of 16 bit for bit against the policy called directly, a hot
# reload mid-serve that captures nothing.
OBS_PATHS = (("host", 40, (20, 25)), ("device-resident", 200, (100, 150)))
OBS_SPANS = {"host": ("act/cem_policy", "extend/drain", "learn/train_step"),
             "device-resident": ("act/cem_policy", "extend/drain",
                                 "learn/megastep")}
OBS_STAGES = ("act", "extend", "learn", "replay")
SPAN_COST_CALLS = 20_000
SERVE_SMOKE_ARGS = ("--fleet", "--smoke", "--clients", "16", "--frames",
                    "80", "--repeats", "3")
SERVE_JAX_AMORTIZATION_BAR = 3.0  # tests/test_serving.py, reported only
SERVE_CLIENTS = 16
SERVE_FRAMES = 4
SERVE_SINGLE_FRAMES = 30
SERVE_IMAGE_SIZE = 472  # the flagship's published size


def span_cost_us(trace_lib, profiling, root: str) -> dict:
  """Host microseconds of one empty span, outside a profiler window and
  inside one (where it also opens a record_function range)."""
  out = {}
  for inside in (False, True):
    # A host-activity window: what a span adds there is host work (the
    # record_function range), and no device work runs to trace.
    if inside and not profiling.start_trace(os.path.join(root, "cost"),
                                            device="cpu"):
      raise AssertionError("a profiler window was already open")
    try:
      start = time.perf_counter()
      for _ in range(SPAN_COST_CALLS):
        with trace_lib.span("obs/cost"):
          pass
      out["inside_window" if inside else "outside_window"] = (
          (time.perf_counter() - start) / SPAN_COST_CALLS * 1e6)
    finally:
      if inside:
        profiling.stop_trace()
  trace_lib.get_tracer().clear()
  return out


def window_spans(path: str, names) -> dict:
  """The trace's record_function ranges of `names`: per name the count and
  host ms, per thread the share of the window its top-level loop spans
  cover, and the window's length."""
  with open(path) as f:
    events = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
  window_us = (max(float(e["ts"]) + float(e.get("dur", 0.0))
                   for e in events)
               - min(float(e["ts"]) for e in events))
  ranges = [e for e in events if e.get("cat") == "user_annotation"
            and "/" in e.get("name", "")]
  by_name, by_thread = {}, {}
  for e in ranges:
    entry = by_name.setdefault(e["name"], {"count": 0, "host_ms": 0.0})
    entry["count"] += 1
    entry["host_ms"] += float(e["dur"]) / 1e3
    if e["name"] in names:
      by_thread[e["tid"]] = by_thread.get(e["tid"], 0.0) + float(e["dur"])
  return {"window_ms": window_us / 1e3, "ranges": by_name,
          "thread_share": sorted((us / window_us for us in
                                  by_thread.values()), reverse=True),
          "missing": sorted(set(names) - set(by_name))}


def run_obs_loop(torch, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 14 (a): the obs spine through run_qtopt_replay on the card."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.obs import flight_recorder
  from tensor2robot_tpu_torch.obs import registry as registry_lib
  from tensor2robot_tpu_torch.obs import trace as trace_lib
  from tensor2robot_tpu_torch.obs.watchdog import Watchdog
  from tensor2robot_tpu_torch.utils import profiling

  class SeenWatchdog(Watchdog):
    """Keeps every heartbeat registered with it."""

    def __init__(self, **kwargs):
      super().__init__(**kwargs)
      self.seen = []

    def register(self, name, deadline_s=None):
      heartbeat = super().register(name, deadline_s)
      self.seen.append(heartbeat)
      return heartbeat

  result = {"card": smi,
            "span_cost_us": span_cost_us(trace_lib, profiling, root)}
  for path, steps, window in OBS_PATHS:
    logdir = os.path.join(root, path)
    dumps = os.path.join(root, f"{path}_dumps")
    dog = SeenWatchdog(poll_s=0.5, default_deadline_s=60.0,
                       recorder=flight_recorder.FlightRecorder(
                           dump_dir=dumps),
                       registry=registry_lib.MetricRegistry())
    trace_lib.get_tracer().clear()
    start = time.perf_counter()
    with dog:
      run = run_qtopt_replay.run(
          steps, smoke=True, logdir=logdir, seed=seed, device=dev,
          watchdog=dog, learner_bench=False, profile_window=window,
          device_resident=path == "device-resident")
    seconds = time.perf_counter() - start
    (trace_path,) = [os.path.join(logdir, "profile", f)
                     for f in os.listdir(os.path.join(logdir, "profile"))]
    spans = window_spans(trace_path, OBS_SPANS[path])
    beats = {}
    for heartbeat in dog.seen:
      name = heartbeat.name.split("#")[0]
      beats[name] = beats.get(name, 0) + heartbeat.beats
    last = {}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
      for line in f:
        record = json.loads(line)
        for key in ("step", "wall_time", "host", "pid"):
          record.pop(key)
        last.update(record)
    gauges = registry_lib.get_registry().snapshot(names=last)
    in_window = sum(entry["count"] for entry in spans["ranges"].values())
    line = {
        "path": path, "steps": run["steps"], "profile_window": window,
        "seconds": seconds,
        "eval_td_reduction": run["eval_td_reduction"],
        "trace_stage_counts": run["obs"]["trace_stage_counts"],
        "heartbeat_beats": beats, "watchdog_events": dog.events,
        "stall_dumps": (sorted(os.listdir(dumps))
                        if os.path.isdir(dumps) else []),
        "registry_gauges_equal_jsonl": gauges == last,
        "gauges_checked": len(last), **spans,
        "spans_in_window": in_window,
        "span_cost_share_of_window": (
            in_window * result["span_cost_us"]["inside_window"] / 1e3
            / spans["window_ms"]),
        "compile_counts": run["compile_counts"],
        # The JAX host loop's programs (tests/test_obs.py), and the health
        # reductions where the monitor runs; the fused path's as in
        # qtopt_device.
        "attribution": check_attribution(
            run["obs"]["attribution"],
            require=(("train_step", "bellman_targets", "td_error",
                      "health_summary") if path == "host"
                     else ("megastep", "device_extend", "cem_bucket_*")),
            forbid=() if path == "host" else ("train_step",),
            mfu_row="train_step" if path == "host" else "megastep")}
    emit("obs_loop_path", card=smi, **line)
    learner_beats = (run["steps"] if path == "host"
                     else run["steps"] // run["megastep_inner"])
    if not (not spans["missing"]
            and set(OBS_STAGES) <= set(run["obs"]["trace_stage_counts"])
            and beats.get("replay/learner") == learner_beats
            and beats.get("replay/feeder", 0) > 0
            and beats.get("act/collector", 0) > 0
            and dog.events == [] and not line["stall_dumps"]
            and dog.snapshot()["components"] == {}
            and line["registry_gauges_equal_jsonl"]
            and set(run["compile_counts"].values()) == {1}):
      raise AssertionError(f"obs_loop {path}: {line}")
    result[path] = {k: line[k] for k in (
        "seconds", "trace_stage_counts", "heartbeat_beats", "window_ms",
        "thread_share", "spans_in_window", "span_cost_share_of_window")}
  return result


def run_serve_fleet(torch, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 14 (b): one serving replica on the card."""
  import contextlib
  import io
  import threading

  from tensor2robot_tpu_torch.bin import bench_serving
  from tensor2robot_tpu_torch.obs.registry import MetricRegistry
  from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
      CheckpointPredictor,
  )
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.research.qtopt.cem import CEMPolicy
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.serving import CEMFleetPolicy, FleetServer
  from tensor2robot_tpu_torch.serving.stats import ServingStats
  from tensor2robot_tpu_torch.train.checkpoints import CheckpointManager
  from tensor2robot_tpu_torch.train.trainer import Trainer
  result = {"card": smi}

  # (a) The serving layer alone: bench_serving --fleet --smoke.
  start = time.perf_counter()
  with contextlib.redirect_stdout(io.StringIO()) as out:
    bench_serving.main(list(SERVE_SMOKE_ARGS))
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  (point,) = line["fleet_sweep"]
  smoke = {"seconds": time.perf_counter() - start,
           "device_kind": line["device_kind"],
           "compile_counts": line["compile_counts"],
           "single_client_closed_loop_hz": line[
               "single_client_closed_loop_hz"],
           "single_client_trials_hz": line["single_client_trials_hz"],
           **point, "amortization": line["amortization_at_max_clients"],
           "jax_amortization_bar": SERVE_JAX_AMORTIZATION_BAR}
  emit("serve_fleet_smoke", card=smi, **smoke)
  if not (line["compile_counts"] == {str(b): 1 for b in FLEET_RUNGS}
          and point["latency_p99_ms"] >= point["latency_p50_ms"] > 0
          and 0 < point["batch_occupancy"] <= 1
          and line["device_kind"] == torch.cuda.get_device_name(0)):
    raise AssertionError(f"serve_fleet smoke: {smoke}")
  result["smoke"] = {k: smoke[k] for k in (
      "amortization", "aggregate_images_per_sec",
      "single_client_closed_loop_hz", "latency_p50_ms", "latency_p99_ms",
      "batch_occupancy")}

  # (b) The flagship served from a model_dir at 472x472.
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  model = QTOptGraspingModel(image_size=SERVE_IMAGE_SIZE, uint8_images=True)
  model_dir = os.path.join(root, "model_dir")
  state = Trainer(model, seed=seed, device=dev).create_train_state()
  CheckpointManager(os.path.join(model_dir, "checkpoints")).save(1, state)
  del state
  predictor = CheckpointPredictor(model, model_dir, device=dev)
  if not (predictor.restore() and predictor.model_version == 1):
    raise AssertionError("CheckpointPredictor did not restore step 1")
  policy = CEMFleetPolicy(predictor, action_size=4, seed=seed,
                          **CEM_SERVING)
  scenes, _ = sg.sample_scenes(SERVE_CLIENTS, SERVE_IMAGE_SIZE, seed + 7)
  images = list(scenes)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  policy.warm(lambda i: images[i % len(images)])
  warm_s = time.perf_counter() - start
  warm_peak_mib = torch.cuda.max_memory_allocated() / 2**20
  ledger = dict(policy.compile_counts)

  single = CEMPolicy(predictor, action_size=4, seed=seed, **CEM_SERVING)
  single(images[0])
  torch.cuda.synchronize()
  start = time.perf_counter()
  for i in range(SERVE_SINGLE_FRAMES):
    single(images[i % len(images)])
  single_hz = SERVE_SINGLE_FRAMES / (time.perf_counter() - start)
  del single

  registry = MetricRegistry()
  server = FleetServer(policy, deadline_ms=5.0,
                       stats=ServingStats(registry=registry))
  answers = [[] for _ in range(SERVE_CLIENTS)]
  errors = []
  reloaded = threading.Event()

  def client(i):
    try:
      for _ in range(SERVE_FRAMES):
        answers[i].append(server.act(images[i], timeout=300))
    except Exception as e:  # noqa: BLE001 — raised below
      errors.append(e)

  fresh = model.init_variables(torch.Generator().manual_seed(seed + 1),
                               device=dev)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with server:
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    start = time.perf_counter()
    for thread in threads:
      thread.start()
    # The hot reload mid-serve, once the first frames are answered.
    while (not errors and sum(len(a) for a in answers) < SERVE_CLIENTS
           and time.perf_counter() - start < 300):
      time.sleep(0.001)
    predictor.set_variables(fresh, version=2)
    reloaded.set()
    for thread in threads:
      thread.join()
    elapsed = time.perf_counter() - start
    # The rungs' graphs keep their pools: reserved holds them, allocated
    # only what lives across replays.
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    reserved_mib = torch.cuda.max_memory_reserved() / 2**20
    served_snap = server.snapshot()
    # One held flush of 16, against the policy called with its seeds.
    first_seed = int(policy.assign_seeds(1)[0]) + 1
    with server.batcher.hold_flushes():
      futures = [server.submit(image) for image in images]
    held = np.stack([f.result(timeout=300) for f in futures])
  direct = policy(images, np.arange(first_seed, first_seed + SERVE_CLIENTS,
                                    dtype=np.uint32))
  torch.backends.cudnn.deterministic = deterministic
  actions = np.stack([a for per in answers for a in per])
  requests_sent = SERVE_CLIENTS * SERVE_FRAMES + SERVE_CLIENTS
  full = {
      "model": f"QTOptGraspingModel(uint8_images=True), "
               f"{SERVE_IMAGE_SIZE}x{SERVE_IMAGE_SIZE}, random weights saved "
               "as model_dir step 1",
      "cem": CEM_SERVING, "clients": SERVE_CLIENTS,
      "frames_per_client": SERVE_FRAMES, "warm_s": warm_s,
      "compile_counts": dict(policy.compile_counts),
      "images_per_s": SERVE_CLIENTS * SERVE_FRAMES / elapsed,
      "single_robot_hz": single_hz,
      "amortization": SERVE_CLIENTS * SERVE_FRAMES / elapsed / single_hz,
      "latency_p50_ms": served_snap["latency_p50_ms"],
      "latency_p99_ms": served_snap["latency_p99_ms"],
      "batch_occupancy": served_snap["batch_occupancy"],
      "flushes": served_snap["flushes"],
      "mean_batch_size": served_snap["mean_batch_size"],
      "warm_peak_memory_mib": warm_peak_mib,
      "serving_peak_allocated_mib": peak_mib,
      "serving_peak_reserved_mib": reserved_mib,
      "held_flush_equals_policy": bool(np.array_equal(held, direct)),
      "model_version": predictor.model_version,
      "serving_requests_counter": registry.counter(
          "serving/requests").value,
      "requests_sent": requests_sent}
  emit("serve_fleet_flagship", card=smi, **full)
  if not (not errors and all(len(a) == SERVE_FRAMES for a in answers)
          and np.isfinite(actions).all() and np.abs(actions).max() <= 1.0
          and full["held_flush_equals_policy"]
          and policy.compile_counts == ledger
          == {b: 1 for b in FLEET_RUNGS}
          and predictor.model_version == 2 and reloaded.is_set()
          and full["serving_requests_counter"] == requests_sent
          and served_snap["latency_p99_ms"]
          >= served_snap["latency_p50_ms"] > 0):
    raise AssertionError(f"serve_fleet flagship: {full} {errors[:1]}")
  result["flagship"] = {k: full[k] for k in (
      "images_per_s", "single_robot_hz", "amortization", "latency_p50_ms",
      "latency_p99_ms", "batch_occupancy", "warm_peak_memory_mib",
      "serving_peak_reserved_mib")}
  del policy, predictor, server
  torch.cuda.empty_cache()
  return result


ROUTER_REPLICAS = 2  # replicas on the one card
ROUTER_COMPARE = 16  # held requests routed, then replayed by one policy
ROUTER_PROFILED_FRAMES = 2
ROUTER_CONFIG = dict(mirror_fraction=1.0, canary_fraction=0.5,
                     min_shadow_samples=8, min_canary_samples=4)
ROUTER_JITTER = 5.0  # the jittered candidate: weights + 5.0 * N(0, 1)
ROUTER_CYCLE_S = 300.0  # bounds a stuck rollout cycle only
ROUTER_HEALTHY_THEN_REGRESSED = ["shadow_start", "canary_start", "promote",
                                 "shadow_start", "auto_rollback"]
ROUTER_TIER_EVENTS = ["shadow_start", "auto_rollback", "shadow_start",
                      "canary_start", "promote"]


def kernel_overlap(path: str) -> dict:
  """Device time of a chrome trace's kernels summed over every stream,
  against the union of their intervals (the card busy with at least one
  kernel): a ratio above 1 means kernels of different streams ran at the
  same time."""
  with open(path) as f:
    kernels = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
  spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in kernels)
  busy, end = 0.0, None
  for start, stop in spans:
    if end is None or start > end:
      busy += stop - start
      end = stop
    elif stop > end:
      busy += stop - end
      end = stop
  summed = sum(stop - start for start, stop in spans)
  streams = {}
  for e in kernels:
    stream = str(e.get("args", {}).get("stream", e.get("tid")))
    streams[stream] = streams.get(stream, 0.0) + float(e.get("dur", 0.0))
  window = (spans[-1][1] - spans[0][0]) if spans else 0.0
  return {"kernels": len(kernels), "kernel_ms_summed": summed / 1e3,
          "device_busy_ms": busy / 1e3, "kernel_window_ms": window / 1e3,
          "overlap_factor": summed / busy if busy else None,
          "streams_ms": {k: v / 1e3 for k, v in sorted(streams.items())}}


def drive_clients(act, images, clients: int, frames=None, until=None,
                  bound_s: float = ROUTER_CYCLE_S) -> dict:
  """`clients` closed-loop threads calling act(image): `frames` each, or
  until `until()` holds (checked after every answer); the wall seconds,
  the answers and the errors."""
  answers = [[] for _ in range(clients)]
  errors = []
  stop_at = time.perf_counter() + bound_s

  def client(i):
    try:
      while time.perf_counter() < stop_at:
        if frames is not None and len(answers[i]) >= frames:
          return
        if until is not None and until():
          return
        answers[i].append(act(images[i % len(images)]))
    except Exception as e:  # noqa: BLE001 — raised by the caller
      errors.append(e)

  threads = [threading.Thread(target=client, args=(i,))
             for i in range(clients)]
  start = time.perf_counter()
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join()
  return {"seconds": time.perf_counter() - start, "answers": answers,
          "errors": errors}


def run_serve_router(torch, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 15: the routed fleet, several replicas on the one card."""
  import contextlib

  from tensor2robot_tpu_torch.obs.ledger import check_compile_ledger
  from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
      CheckpointPredictor,
  )
  from tensor2robot_tpu_torch.replay import precision_bench, tpquant_bench
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.serving import CEMFleetPolicy, fleet_bench
  from tensor2robot_tpu_torch.serving.rollout import (
      RolloutConfig,
      RolloutController,
  )
  from tensor2robot_tpu_torch.serving.router import FleetRouter
  from tensor2robot_tpu_torch.serving.stats import ServingStats
  from tensor2robot_tpu_torch.train.checkpoints import CheckpointManager
  from tensor2robot_tpu_torch.train.trainer import Trainer
  result = {"card": smi}
  kind = torch.cuda.get_device_name(0)

  # (a) The TinyQ fleet at the JAX CI scale: bench_fleet --ci --devices 2.
  start = time.perf_counter()
  fleet = fleet_bench.measure_fleet(**fleet_bench.CI_SCALE,
                                    n_devices=ROUTER_REPLICAS, seed=seed,
                                    device=dev)
  point = fleet["sweep"][-1]
  tiny = {"seconds": time.perf_counter() - start,
          "device_kind": fleet["device_kind"],
          "virtual_mesh": fleet["virtual_mesh"],
          "devices": fleet["devices"],
          "warmup_compile_s": fleet["warmup_compile_s"],
          "compile_ledger": fleet["compile_ledger"],
          "ledger_ok": fleet["ledger_ok"],
          "per_class": point["per_class"],
          "achieved_total_hz": point["achieved_total_hz"],
          "offered_total_hz": point["offered_total_hz"],
          "all_budgets_met": point["all_budgets_met"],
          "batch_occupancy": point["batch_occupancy"],
          "overload_burst": fleet["overload_burst"],
          "promotion_timeline": fleet["promotion_timeline"],
          "served_model_version": fleet["rollout"]["served_model_version"],
          "fleet_p99_headroom": fleet["fleet_p99_headroom"]}
  emit("serve_router_fleet", card=smi, **tiny)
  burst = fleet["overload_burst"]["per_class"]
  if not (fleet["ledger_ok"] and fleet["device_kind"] == kind
          and not fleet["virtual_mesh"]
          and len(check_compile_ledger(fleet["compile_ledger"]))
          == ROUTER_REPLICAS * 3
          and len(point["per_class"]) == 3
          and all(e["latency_p99_ms"] >= e["latency_p50_ms"] > 0
                  for e in point["per_class"].values())
          and fleet["overload_burst"]["shed_total"] > 0
          and fleet["overload_burst"]["priority_ordering_ok"]
          and burst["batch"]["shed_rate"] >= burst["interactive"]["shed_rate"]
          and [e["event"] for e in fleet["promotion_timeline"]]
          == ROUTER_HEALTHY_THEN_REGRESSED
          and fleet["rollout"]["served_model_version"] == 1):
    raise AssertionError(f"serve_router fleet: {tiny}")
  result["tinyq"] = {k: tiny[k] for k in (
      "achieved_total_hz", "batch_occupancy", "warmup_compile_s")}
  result["tinyq"]["p99_ms"] = {k: v["latency_p99_ms"]
                               for k, v in point["per_class"].items()}
  result["tinyq"]["burst_shed_rate"] = {k: v["shed_rate"]
                                        for k, v in burst.items()}

  # The tier rollouts: bf16 and int8 through the promotion gate.
  result["tiers"] = {}
  for tier, measure in (("bf16", precision_bench._measure_rollout),
                        ("int8", tpquant_bench._measure_rollout_int8)):
    start = time.perf_counter()
    tier_run = measure(device=dev, seed=seed)
    tier_run["seconds"] = time.perf_counter() - start
    emit("serve_router_tier", card=smi, tier=tier, **tier_run)
    suffixed = [f"cem_bucket_{b}_{tier}@{dev}#{i}" for b in (1, 2, 4)
                for i in range(ROUTER_REPLICAS)]
    if not (tier_run["events"] == ROUTER_TIER_EVENTS
            and tier_run["breach_rolled_back"] and tier_run["cycle_ok"]
            and tier_run["precision_served"] == tier
            and tier_run["post_promote_action_ok"]
            and len(check_compile_ledger(tier_run["compile_ledger"],
                                         require=suffixed))
            == ROUTER_REPLICAS * 2 * 3):
      raise AssertionError(f"serve_router {tier} rollout: {tier_run}")
    result["tiers"][tier] = {k: tier_run[k] for k in (
        "events", "precision_served", "requests", "seconds")}

  # (b) The 472x472 critic from a model_dir behind two replicas.
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  model = QTOptGraspingModel(image_size=SERVE_IMAGE_SIZE, uint8_images=True)
  model_dir = os.path.join(root, "model_dir")
  manager = CheckpointManager(os.path.join(model_dir, "checkpoints"))
  state = Trainer(model, seed=seed, device=dev).create_train_state()
  manager.save(1, state)
  predictor = CheckpointPredictor(model, model_dir, device=dev)
  if not (predictor.restore() and predictor.model_version == 1):
    raise AssertionError("CheckpointPredictor did not restore step 1")
  scenes, _ = sg.sample_scenes(SERVE_CLIENTS, SERVE_IMAGE_SIZE, seed + 7)
  images = list(scenes)
  router = FleetRouter(predictor, devices=[dev] * ROUTER_REPLICAS,
                       action_size=4, seed=seed, deadline_ms=5.0,
                       **CEM_SERVING)
  memory = {}
  start = time.perf_counter()
  for replica in router.replicas:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    replica.warmup(lambda i: images[i % len(images)])
    torch.cuda.synchronize()
    memory[replica.label] = {
        "warm_peak_allocated_mib": torch.cuda.max_memory_allocated() / 2**20,
        "reserved_mib": (torch.cuda.memory_reserved() - reserved) / 2**20}
  warm_s = time.perf_counter() - start
  ledger_before = dict(router.ledger.compile_counts)
  check_compile_ledger(router.compile_ledger())
  flushes = {replica.label: [] for replica in router.replicas}
  for replica in router.replicas:
    def recorded(items, _label=replica.label, _flush=replica._flush):
      out = _flush(items)
      flushes[_label].append([int(item[1]) for item in items])
      return out
    replica.batcher._batch_fn = recorded

  with router:
    # Held requests with pinned seeds: each replica's flush is replayed
    # below by one policy with separate pools, at the same rung.
    seeds = [100_000 + i for i in range(ROUTER_COMPARE)]
    with contextlib.ExitStack() as stack:
      for replica in router.replicas:
        stack.enter_context(replica.batcher.hold_flushes())
      futures = [router.submit(images[i % len(images)], seed=s)
                 for i, s in enumerate(seeds)]
    routed = {s: f.result(timeout=300) for s, f in zip(seeds, futures)}
    compare_groups = [group for per in flushes.values() for group in per]
    for per in flushes.values():
      per.clear()

    # Closed-loop clients: 16 x 4 frames.
    stats = ServingStats()
    router.use_stats(stats)
    dispatched = {row["name"]: row["seconds_total"]
                  for row in router.ledger.attribution()["executables"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_clients(lambda image: router.act(image, timeout=300),
                        images, SERVE_CLIENTS, frames=SERVE_FRAMES)
    served = stats.snapshot()
    serving_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    serving_reserved_mib = torch.cuda.memory_reserved() / 2**20
    replica_flushes = {label: len(per) for label, per in flushes.items()}
    replica_images = {label: sum(len(g) for g in per)
                      for label, per in flushes.items()}
    dispatch_s = {row["name"]: row["seconds_total"] - dispatched[row["name"]]
                  for row in router.ledger.attribution()["executables"]
                  if row["seconds_total"] > dispatched[row["name"]]}

    # One profiled window: do the two replicas' replays overlap?
    trace_path = os.path.join(root, "router_trace.json")
    profiled_start = time.perf_counter()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
      profiled = drive_clients(lambda image: router.act(image, timeout=300),
                               images, SERVE_CLIENTS,
                               frames=ROUTER_PROFILED_FRAMES)
      torch.cuda.synchronize()
    profiled_wall_ms = (time.perf_counter() - profiled_start) * 1e3
    prof.export_chrome_trace(trace_path)
    overlap = kernel_overlap(trace_path)
    overlap["profiled_wall_ms"] = profiled_wall_ms

    # The params rollout: a second checkpoint step (the same weights),
    # then a jittered candidate, under 16 closed-loop clients.
    manager.save(2, state)
    reader = CheckpointPredictor(model, model_dir, device=dev)
    if not (reader.restore() and reader.model_version == 2):
      raise AssertionError("the second step did not restore")
    healthy = reader.device_fn()[1]
    generator = torch.Generator(device=dev).manual_seed(seed + 11)
    jittered = {k: (v + ROUTER_JITTER * torch.randn(
        v.shape, generator=generator, device=dev, dtype=v.dtype)
                    if v.is_floating_point() and v.dim() >= 2 else v)
                for k, v in healthy.items()}
    controller = RolloutController(
        router, predictor,
        RolloutConfig(seed=seed, **ROUTER_CONFIG))
    cycles = []
    with controller:
      for version, candidate in ((2, healthy), (3, jittered)):
        if not controller.offer_candidate(version, candidate):
          raise AssertionError("rollout busy")
        cycle = drive_clients(
            lambda image: controller.act(image, timeout=300), images,
            SERVE_CLIENTS, until=lambda: controller.state == "serving")
        cycles.append({"seconds": cycle["seconds"],
                       "requests": sum(len(a) for a in cycle["answers"]),
                       "errors": [repr(e) for e in cycle["errors"][:2]]})
    timeline = controller.timeline()
    health = router.health_snapshot()
  del state, reader, healthy, jittered, controller
  ledger_after = dict(router.ledger.compile_counts)

  # One policy, separate graph pools: the memory before, and the held
  # flushes replayed at their rungs against the routed answers.
  router_reserved_mib = torch.cuda.memory_reserved() / 2**20
  del router
  gc.collect()  # the batchers and replicas hold each other
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  single = CEMFleetPolicy(predictor, action_size=4, seed=seed,
                          **CEM_SERVING)
  single.share_graph_pool = False
  torch.cuda.reset_peak_memory_stats()
  reserved = torch.cuda.memory_reserved()
  single.warm(lambda i: images[i % len(images)])
  torch.cuda.synchronize()
  separate = {
      "warm_peak_allocated_mib": torch.cuda.max_memory_allocated() / 2**20,
      "reserved_mib": (torch.cuda.memory_reserved() - reserved) / 2**20}
  by_seed = {s: images[i % len(images)] for i, s in enumerate(seeds)}
  mismatched = 0
  for group in compare_groups:
    want = single([by_seed[s] for s in group],
                  np.asarray(group, np.uint32))
    mismatched += sum(not np.array_equal(routed[s], w)
                      for s, w in zip(group, want))
  del single
  torch.cuda.empty_cache()
  torch.backends.cudnn.deterministic = deterministic

  actions = np.stack([a for per in run["answers"] for a in per])
  full = {
      "model": f"QTOptGraspingModel(uint8_images=True), "
               f"{SERVE_IMAGE_SIZE}x{SERVE_IMAGE_SIZE}, random weights saved "
               "as model_dir steps 1 and 2",
      "cem": CEM_SERVING, "replicas": ROUTER_REPLICAS,
      "clients": SERVE_CLIENTS, "frames_per_client": SERVE_FRAMES,
      "warm_s": warm_s, "compile_ledger": ledger_before,
      "images_per_s": SERVE_CLIENTS * SERVE_FRAMES / run["seconds"],
      "latency_p50_ms": served["latency_p50_ms"],
      "latency_p99_ms": served["latency_p99_ms"],
      "batch_occupancy": served["batch_occupancy"],
      "mean_batch_size": served["mean_batch_size"],
      "flushes": served["flushes"], "replica_flushes": replica_flushes,
      "replica_images": replica_images,
      "dispatch_seconds": dispatch_s,
      "dispatch_seconds_over_wall": sum(dispatch_s.values())
                                    / run["seconds"],
      "overlap": overlap,
      "replica_memory": memory,
      "separate_pools_memory": separate,
      "serving_peak_allocated_mib": serving_peak_mib,
      "serving_reserved_mib": serving_reserved_mib,
      "router_reserved_mib": router_reserved_mib,
      "compare_groups": [len(g) for g in compare_groups],
      "routed_equals_single": mismatched == 0,
      "timeline": timeline, "cycles": cycles,
      "model_version": predictor.model_version,
      "captures_in_rollouts": sum(ledger_after.values())
                              - sum(ledger_before.values()),
      "health": health["health"],
  }
  emit("serve_router_flagship", card=smi, **full)
  if not (not run["errors"] and not profiled["errors"]
          and all(len(a) == SERVE_FRAMES for a in run["answers"])
          and np.isfinite(actions).all() and np.abs(actions).max() <= 1.0
          and all(n > 0 for n in replica_flushes.values())
          and len(compare_groups) == ROUTER_REPLICAS
          and full["routed_equals_single"]
          and ledger_before == ledger_after
          and len(check_compile_ledger(ledger_before))
          == ROUTER_REPLICAS * len(FLEET_RUNGS)
          and [e["event"] for e in timeline] == ROUTER_HEALTHY_THEN_REGRESSED
          and timeline[-1]["stage"] == "shadow"
          and predictor.model_version == 2
          and not any(c["errors"] for c in cycles)
          and served["latency_p99_ms"] >= served["latency_p50_ms"] > 0):
    raise AssertionError(f"serve_router flagship: {full} "
                         f"{(run['errors'] + profiled['errors'])[:1]}")
  result["flagship"] = {k: full[k] for k in (
      "images_per_s", "latency_p50_ms", "latency_p99_ms", "batch_occupancy",
      "replica_flushes", "replica_memory", "separate_pools_memory")}
  result["flagship"]["overlap_factor"] = overlap["overlap_factor"]
  del predictor
  torch.cuda.empty_cache()
  return result


MAML_TASKS = 8  # check_maml's meta-batch
MAML_INNER_STEPS = 3
MAML_K1_PER_META_STEP = MAML_TASKS * (MAML_INNER_STEPS + 1)
MAML_EVAL_TASKS = 64
# A graphed stack and its warm-up (4 and 2 until slice 17's phases joined).
MAML_GRAPH_STEPS = 2
MAML_WARM_STEPS = 1
MAML_TIMED_STEPS = 5
MAML_GRAPH_CASES = ("second_order", "first_order", "learned_rates",
                    "mock_dropout")
MAML_HARNESS_STEPS = 20
MAML_HARNESS_SAVE = 10
MAML_REQUEST_TASKS = (1, 8)


def maml_model(variant: str = "second_order"):
  """check_maml's model (the pose_env MAML regressor at 64x64, GroupNorm,
  float32), or the MAML-wrapped mock with dropout and BatchNorm."""
  from tensor2robot_tpu_torch.meta_learning import MAMLModel
  from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (
      pose_env_maml_model,
  )
  from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  if variant == "mock_dropout":
    return MAMLModel(MockT2RModel(use_batch_norm=True), num_inner_steps=2,
                     num_condition_samples=4, num_inference_samples=4)
  return pose_env_maml_model(
      num_inner_steps=MAML_INNER_STEPS, inner_lr=0.05,
      num_condition_samples=4, num_inference_samples=4, image_size=64,
      optimizer_fn=create_adam_optimizer(1e-3),
      first_order=variant == "first_order",
      learn_inner_lr=variant == "learned_rates")


def maml_batches(torch, variant: str, seeds, dev):
  """(K-stacked meta features, None) for the seeds: check_maml's
  two-object tasks, or spec-conformant random ones for the mock."""
  from tensor2robot_tpu_torch.research.pose_env import meta_reaching as mr
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  if variant == "mock_dropout":
    spec = maml_model(variant).get_feature_specification("train")
    metas = [ts.make_random_batch(spec, MAML_TASKS,
                                  rng=np.random.default_rng(seed))
             for seed in seeds]
  else:
    metas = [mr.sample_meta_batch(MAML_TASKS, 4, 4, seed=seed,
                                  condition_label_noise=0.22)[0]
             for seed in seeds]
  return (ts.TensorSpecStruct(
      (key, torch.from_numpy(np.stack([m[key] for m in metas])).to(dev))
      for key in metas[0]), None)


def time_maml_map(torch, ss, dev, seed: int) -> dict:
  """K1 against its plain version on the map check_maml's tower hands it:
  one task's 4 condition scenes at 64x64, float32, in the tower's
  layout."""
  from tensor2robot_tpu_torch.research.pose_env import meta_reaching as mr
  model = maml_model()
  variables = model.init_variables(torch.Generator().manual_seed(seed),
                                   device=dev)
  meta, _ = mr.sample_meta_batch(1, 4, 4, seed=seed)
  images = torch.from_numpy(meta["condition/features/image"][0]).to(dev)
  tower = {key.split(".", 1)[1]: value for key, value in variables.items()
           if key.startswith("tower.")}
  with torch.no_grad():
    x = torch.func.functional_call(model.module.tower, tower, (images,))
  got, want = ss.spatial_softmax(x), ss.spatial_softmax_reference(x)
  bytes_ms = ((x.numel() + x.shape[0] * 2 * x.shape[3]) * x.element_size()
              / _HBM_BYTES_PER_S * 1e3)
  ops_ms = x.numel() * _SPATIAL_SOFTMAX_OPS_PER_ELEMENT / _F32_FLOPS * 1e3
  return {"shape": list(x.shape), "strides": list(x.stride()),
          "dtype": str(x.dtype)[6:],
          "kernel": ss._kernel_for(x.shape, x.stride()),
          "max_abs_err": float((got - want).abs().max()),
          "ms": device_ms(torch, lambda: ss.spatial_softmax(x)),
          "plain_ms": device_ms(torch,
                                lambda: ss.spatial_softmax_reference(x)),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def run_maml_check(torch, ss, gl, dev, seed: int, root: str, smi: str,
                   step_times: dict) -> dict:
  """Slice 16's path 1: the port's check_maml at the fast scale (800
  meta-steps of 8 two-object tasks, 3 inner steps, as CUDA graph replays
  of MAML_ITERATIONS_PER_LOOP meta-steps; 64 fresh tasks scored adapted
  and unadapted): the JAX bars must hold, and K1 must launch 8 x (3 + 1)
  times a meta-step and 4 (adapted) or 1 (unadapted) times a task in
  eval. `step_times`: the same meta-step's eager and graphed times from
  ``run_maml_graph``'s second-order case; then K1 on its map."""
  from tensor2robot_tpu_torch.bin import run_capability_checks as checks
  start = time.perf_counter()
  reset_spatial_softmax_counts(ss)
  with CountReplays(gl) as replays:
    result = checks.check_maml("fast", root, dev.type)
  launches = dict(ss.spatial_softmax.launches_by_kernel)
  steps = checks._SCALES["maml"]["fast"]["steps"]
  bar = checks._EXPECT[("maml", "fast")]
  result.update({
      "scale": checks._SCALES["maml"]["fast"], "bar": bar,
      "margin_bar": 0.5, "margin": result["success_rate_at_object_radius"]
      - result["unadapted_success_rate"],
      "k1_launches": launches, "graph_replays": replays.replays,
      "k1_launches_from_replays": replays.launches,
      "k1_launches_per_meta_step": result["k1_launches_train"] / steps,
      "k1_launches_per_eval_task_adapted":
          result["k1_launches_eval_adapted"] / MAML_EVAL_TASKS,
      "k1_launches_per_eval_task_unadapted":
          result["k1_launches_eval_unadapted"] / MAML_EVAL_TASKS,
      "check_seconds": time.perf_counter() - start})
  result.update({
      "eager_meta_step_ms_median": step_times["eager_step_ms_median"],
      "graphed_meta_step_ms_median": step_times["graphed_step_ms_median"],
      "graphed_device_ms_per_meta_step":
          step_times["graphed_device_ms_per_step"]})
  result["k1_timing"] = time_maml_map(torch, ss, dev, seed)
  result["seconds"] = time.perf_counter() - start
  emit("maml_check", card=smi, **result)
  want = {"train": steps * MAML_K1_PER_META_STEP,
          "eval_adapted": MAML_EVAL_TASKS * (MAML_INNER_STEPS + 1),
          "eval_unadapted": MAML_EVAL_TASKS}
  got = {key: result[f"k1_launches_{key}"] for key in want}
  if got != want or sum(launches.values()) != sum(want.values()):
    raise AssertionError(f"maml_check K1 launches {got} {launches}; "
                         f"want {want}")
  if not (result["success_rate_at_half_radius"] >= bar
          and result["adapted_vs_unadapted_margin_ok"]
          and result["margin"] >= 0.5):
    raise AssertionError(f"maml_check missed the JAX bars: {result}")
  return result


def run_maml_graph(torch, ss, gl, dev, seed: int, root: str,
                   smi: str) -> dict:
  """MAML's meta-steps as one train_steps CUDA graph against the same
  steps eagerly, bit for bit with cuDNN deterministic: check_maml's model
  at second order (the outer gradient through autograd.grad(create_graph)
  inside the capture), first order and with learned inner rates, then the
  MAML-wrapped mock with dropout (its masks from the generators the graph
  registers). K1 launches 32 times a pose_env meta-step through the
  replay; its plain version runs only in the second-order backward (24
  times an eager meta-step), never in the forward."""
  result = {}
  for variant in MAML_GRAPH_CASES:
    start = time.perf_counter()
    model = maml_model(variant)
    warm = maml_batches(torch, variant,
                        range(seed, seed + MAML_WARM_STEPS), dev)
    stack = maml_batches(torch, variant, range(
        seed + MAML_WARM_STEPS,
        seed + MAML_WARM_STEPS + MAML_GRAPH_STEPS), dev)
    reset_spatial_softmax_counts(ss)
    with CountPlainSpatialSoftmax(ss) as plain:
      case = graph_vs_eager(torch, ss, gl, model, dev, seed, warm, stack,
                            root, f"maml_graph_{variant}", profiled=False)
    case["plain_cuda_calls"] = plain.cuda_calls
    case["k1_launches_phase"] = dict(ss.spatial_softmax.launches_by_kernel)
    case["seconds"] = time.perf_counter() - start
    emit("maml_graph_case", card=smi, variant=variant, **case)
    per_step = 0 if variant == "mock_dropout" else MAML_K1_PER_META_STEP
    # The plain version runs in the second-order backward of each eager or
    # captured meta-step's inner steps: both trainers' warm-ups, the
    # capture and the eager stack.
    python_steps = 2 * MAML_WARM_STEPS + 2 * MAML_GRAPH_STEPS
    plain_want = (MAML_TASKS * MAML_INNER_STEPS * python_steps
                  if variant in ("second_order", "learned_rates") else 0)
    if (case["k1_launches_graphed"] != MAML_GRAPH_STEPS * per_step
        or case["k1_launches_eager"] != MAML_GRAPH_STEPS * per_step
        or case["plain_cuda_calls"] != plain_want):
      raise AssertionError(f"maml_graph {variant}: K1 launches or plain "
                           f"calls (want {plain_want}) {case}")
    result[variant] = {key: case[key] for key in (
        "bitwise_equal", "eager_step_ms_median", "graphed_step_ms_median",
        "graphed_device_ms_per_step", "capture_and_first_replay_ms",
        "k1_launches_graphed", "k1_launches_phase", "plain_cuda_calls",
        "seconds")}
  return result


def maml_request(tasks: int, seed: int) -> dict:
  from tensor2robot_tpu_torch.research.pose_env import meta_reaching as mr
  meta, _ = mr.sample_meta_batch(tasks, 4, 4, seed=seed,
                                 condition_label_noise=0.22)
  return dict(meta.items())


def run_maml_serve(torch, ss, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 16's path 3: check_maml's model exported by
  NativeExportGenerator and restored by ExportedModelPredictor on cuda;
  a request carries condition data and adapts before the forward. Its
  outputs equal inference_network_fn's on the same variables (cuDNN
  deterministic), new condition labels change them, and requests of 1
  and 8 tasks are timed."""
  from tensor2robot_tpu_torch import modes
  from tensor2robot_tpu_torch.export import export_utils
  from tensor2robot_tpu_torch.export.native_export_generator import (
      NativeExportGenerator,
  )
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  start = time.perf_counter()
  model = maml_model()
  variables = model.init_variables(torch.Generator().manual_seed(seed),
                                   device="cpu")
  generator = NativeExportGenerator(export_root=os.path.join(root, "maml"))
  generator.set_specification_from_model(model)
  export_utils.export_and_gc(generator, variables, keep=1)
  predictor = ExportedModelPredictor(model, generator.export_root)
  if not predictor.restore() or predictor.device.type != "cuda":
    raise AssertionError("the MAML export did not restore on cuda")
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  request = maml_request(1, seed + 21)
  reset_spatial_softmax_counts(ss)
  served = predictor.predict(request)
  launches = dict(ss.spatial_softmax.launches_by_kernel)
  fn, served_vars = predictor.device_fn()
  with torch.no_grad():
    direct, _ = model.inference_network_fn(
        served_vars, ts.TensorSpecStruct(
            (k, torch.from_numpy(v).to(dev)) for k, v in request.items()),
        modes.PREDICT)
  direct_err = float(np.abs(served["inference_output"] - direct[
      "inference_output"].float().cpu().numpy()).max())
  moved = dict(request)
  moved["condition/labels/target_pose"] = -request[
      "condition/labels/target_pose"]
  moved_delta = float(np.abs(predictor.predict(moved)["inference_output"]
                             - served["inference_output"]).max())
  torch.backends.cudnn.deterministic = deterministic
  timings = {}
  for tasks in MAML_REQUEST_TASKS:
    batch = maml_request(tasks, seed + 22)
    timings[f"request_ms_{tasks}_tasks"] = host_ms(
        torch, lambda: predictor.predict(batch), reps=16)
  result = {"request_tasks": 1, "k1_launches_request": launches,
            "k1_launches_phase": dict(
                ss.spatial_softmax.launches_by_kernel),
            "served_vs_inference_network_fn_max_abs": direct_err,
            "moved_condition_labels_max_delta": moved_delta,
            "outputs_shape": list(served["inference_output"].shape),
            "condition_loss": served["condition_loss"].tolist(),
            **timings, "seconds": time.perf_counter() - start}
  emit("maml_serve", card=smi, **result)
  if not (sum(launches.values()) == MAML_INNER_STEPS + 1
          and direct_err == 0.0 and moved_delta > 1e-4
          and np.isfinite(served["inference_output"]).all()
          and result["outputs_shape"] == [1, 4, 2]):
    raise AssertionError(f"maml_serve: {result}")
  return result


def _best_exporter_only(model):
  from tensor2robot_tpu_torch.export.exporters import BestExporter
  from tensor2robot_tpu_torch.export.native_export_generator import (
      NativeExportGenerator,
  )
  del model
  return [BestExporter(NativeExportGenerator(), metric_key="loss")]


def run_maml_harness(torch, ss, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 16's path 2: pose_env_maml_train.cfg through run_t2r_trainer on
  cuda (20 meta-steps, checkpoints every 10) with an AsyncExportHook
  publishing each checkpoint under export/latest while training runs and
  a BestExporter after each eval under export/best; then --mode
  continuous_eval over the same model_dir evaluates each checkpoint once
  and stops, and the best export restores on cuda."""
  from tensor2robot_tpu_torch import config
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.export import export_utils
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (
      pose_env_maml_model,
  )
  start = time.perf_counter()
  cfg = os.path.join("tensor2robot_tpu_torch", "research", "pose_env",
                     "configs", "pose_env_maml_train.cfg")
  model_dir = os.path.join(root, "maml_run")
  common = ["--config", os.path.join(_ROOT, cfg), "--import_module",
            "tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models",
            "--model_dir", model_dir]
  config.clear_config()
  config.configurable(_best_exporter_only, name="chip_smoke_best_exporter")
  reset_spatial_softmax_counts(ss)
  train_start = time.perf_counter()
  rc = run_t2r_trainer.main(common + [
      "--binding", f"train_eval_model.max_train_steps = {MAML_HARNESS_STEPS}",
      "--binding",
      f"train_eval_model.save_checkpoints_steps = {MAML_HARNESS_SAVE}",
      "--binding", "train_eval_model.log_every_steps = 5",
      "--binding", "train_eval_model.hook_builders = "
                   "[@AsyncExportHookBuilder()]",
      "--binding", "AsyncExportHookBuilder.export_generator = "
                   "@NativeExportGenerator()",
      "--binding", "train_eval_model.input_generator_eval = "
                   "@DefaultRandomInputGenerator()",
      "--binding", "train_eval_model.eval_steps = 2",
      "--binding",
      f"train_eval_model.eval_interval_steps = {MAML_HARNESS_SAVE}",
      "--binding", "train_eval_model.create_exporters_fn = "
                   "@chip_smoke_best_exporter"])
  train_s = time.perf_counter() - train_start
  train_launches = dict(ss.spatial_softmax.launches_by_kernel)
  latest = export_utils.list_export_versions(
      os.path.join(model_dir, "export", "latest"))
  best = export_utils.list_export_versions(
      os.path.join(model_dir, "export", "best"))
  checkpoints = sorted(int(d) for d in os.listdir(
      os.path.join(model_dir, "checkpoints")) if d.isdigit())
  config.clear_config()
  eval_start = time.perf_counter()
  eval_rc = run_t2r_trainer.main(common + [
      "--mode", "continuous_eval",
      "--binding", "continuous_eval_model.model = @pose_env_maml_model()",
      "--binding", "continuous_eval_model.input_generator_eval = "
                   "@DefaultRandomInputGenerator()",
      "--binding", "continuous_eval_model.eval_steps = 2",
      "--binding", "continuous_eval_model.poll_interval_s = 0.2",
      "--binding", "continuous_eval_model.timeout_s = 5.0",
      "--binding", f"continuous_eval_model.stop_after_step = "
                   f"{MAML_HARNESS_STEPS}"])
  eval_s = time.perf_counter() - eval_start
  config.clear_config()
  with open(os.path.join(model_dir, "eval", "metrics.jsonl")) as f:
    evaluated = [json.loads(line) for line in f]
  model = pose_env_maml_model()
  predictor = ExportedModelPredictor(
      model, os.path.join(model_dir, "export", "best"))
  restored = predictor.restore() and predictor.device.type == "cuda"
  out = predictor.predict(maml_request(2, seed + 23))
  result = {"k1_launches_phase": dict(ss.spatial_softmax.launches_by_kernel),
"train_rc": rc, "continuous_eval_rc": eval_rc,
            "checkpoints": checkpoints, "async_exports": latest,
            "best_exports": best,
            "continuous_eval_steps": [r["step"] for r in evaluated],
            "continuous_eval_loss": [r.get("eval/loss") for r in evaluated],
            "best_restored_on_cuda": bool(restored),
            "best_export_version": predictor.model_version,
            "k1_launches_train_and_eval": train_launches,
            "train_s": train_s, "continuous_eval_s": eval_s,
            "seconds": time.perf_counter() - start}
  emit("maml_harness", card=smi, **result)
  if not (rc == 0 and eval_rc == 0
          and checkpoints == [MAML_HARNESS_SAVE, MAML_HARNESS_STEPS]
          and len(latest) == 2 and best
          and result["continuous_eval_steps"] == checkpoints
          and result["best_restored_on_cuda"]
          and np.isfinite(out["inference_output"]).all()):
    raise AssertionError(f"maml_harness: {result}")
  return result


def run_maml(torch, ss, gl, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 16's main paths, each with the launch counts set to 0 just
  before it."""
  graph = run_maml_graph(torch, ss, gl, dev, seed, root, smi)
  return {
      "graph": graph,
      "check": run_maml_check(torch, ss, gl, dev, seed, root, smi,
                              graph["second_order"]),
      "serve": run_maml_serve(torch, ss, dev, seed, root, smi),
      "harness": run_maml_harness(torch, ss, dev, seed, root, smi),
  }


# Slice 17: the research zoo and the program format.
ZOO_BATCH = 64  # BASELINE #2's and #5's batch
G2V_IMAGE = 224  # grasp2vec_train.cfg's published width: ResNet-50/64
ZOO_WARM_STEPS = 1
ZOO_GRAPH_STEPS = 3
ZOO_TIMED_STEPS = 4
TEC_BATCH = 16  # vrgripper_tec_train.cfg's batch, 2 + 2 samples a task
VR_MAML_TASKS = 2
VR_CLI_EPISODES, VR_CLI_STEPS_PER_EPISODE = 40, 10
VR_CLI_STEPS, VR_CLI_SAVE = 200, 100
EXPORT_BATCHES = (1, 8)
# A program against the eager model on the card: the same kernels on the
# same inputs, at the served dtype (bf16); held to the GPU-vs-CPU bf16
# serving bound, the exact difference reported.
PROGRAM_ATOL = SERVE_BF16_ATOL


def zoo_k1_launches(ss) -> int:
  """K1 runs on no zoo training path: its launches since the last reset
  must stay 0 there."""
  return ss.spatial_softmax.launches


def triplet_stacks(torch, dev, seed: int, steps_list, image: int):
  """(K-stacked grasp2vec features, None) per K: synthetic triplets at
  `image`, ZOO_BATCH a step drawn without replacement."""
  from tensor2robot_tpu_torch.research.grasp2vec import (
      synthetic_scenes as scenes,
  )
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  pool = 2 * ZOO_BATCH
  data = scenes.sample_triplets(pool, image_size=image, seed=seed)
  rng = np.random.default_rng(seed)
  out = []
  for steps in steps_list:
    batches = [scenes.as_model_batch(
        data, rng.choice(pool, ZOO_BATCH, replace=False))
               for _ in range(steps)]
    out.append((ts.TensorSpecStruct(
        (key, torch.from_numpy(np.stack([b[key] for b in batches])).to(dev))
        for key in batches[0]), None))
  return out


def spec_stacks(torch, model, dev, seed: int, batch: int, steps_list):
  """(K-stacked features, labels or None) per K, drawn from the model's
  TRAIN specs: images uniform in [0, 1], the rest standard normal."""
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  rng = np.random.default_rng(seed)

  def draw(spec, steps):
    return ts.TensorSpecStruct(
        (key, torch.from_numpy(
            rng.random((steps, batch) + s.shape, np.float32)
            if "image" in key else
            rng.normal(size=(steps, batch) + s.shape).astype(np.float32)
        ).to(dev)) for key, s in ts.flatten_spec_structure(spec).items())

  out = []
  for steps in steps_list:
    labels = draw(model.get_label_specification("train"), steps)
    out.append((draw(model.get_feature_specification("train"), steps),
                labels if len(labels) else None))
  return out


def zoo_graph(torch, ss, gl, model, dev, seed: int, stacks, root: str,
              name: str, smi: str) -> dict:
  """graph_vs_eager on the zoo model, K1's launches read (0 expected)."""
  start = time.perf_counter()
  reset_spatial_softmax_counts(ss)
  case = graph_vs_eager(torch, ss, gl, model, dev, seed, stacks[0],
                        stacks[1], root, name, profiled=False)
  case["k1_launches_phase"] = zoo_k1_launches(ss)
  case["seconds"] = time.perf_counter() - start
  emit(f"{name}_graph", card=smi, **case)
  if case["k1_launches_phase"]:
    raise AssertionError(f"{name}: K1 launched on a path without it")
  return {key: case[key] for key in (
      "bitwise_equal", "eager_step_ms_median", "graphed_step_ms_median",
      "graphed_device_ms_per_step", "peak_mib_graphed", "loss", "seconds")}


def remat_vs_plain(torch, dev, seed: int, smi: str) -> dict:
  """Grasp2Vec at its published width with remat=True against False:
  the first step bit for bit (cuDNN deterministic), then each one's step
  ms and the peak memory of a step beyond the state's own."""
  from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
      Grasp2VecModel,
  )
  from tensor2robot_tpu_torch.train.trainer import Trainer, _index
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  (features, _), = triplet_stacks(torch, dev, seed + 5,
                                  [1 + ZOO_TIMED_STEPS], G2V_IMAGE)
  result, after_first = {}, {}
  for remat in (False, True):
    model = Grasp2VecModel(remat=remat,
                           optimizer_fn=create_adam_optimizer(1e-4))
    trainer = Trainer(model, seed=seed, device=dev)
    state = trainer.create_train_state()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = trainer.train_step(state, _index(features, 0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    after_first[remat] = (
        {k: v.detach().clone() for k, v in state.params.items()},
        {k: v.clone() for k, v in state.model_state.items()},
        float(metrics["loss"]))
    times = []
    for i in range(1, 1 + ZOO_TIMED_STEPS):
      torch.cuda.synchronize()
      begin = time.perf_counter()
      state, _ = trainer.train_step(state, _index(features, i))
      torch.cuda.synchronize()
      times.append((time.perf_counter() - begin) * 1e3)
    result[f"remat_{str(remat).lower()}"] = {
        "step_ms_median": float(np.median(times)),
        "step_ms": times,
        "peak_mib_step": peak / 2 ** 20,
        "peak_mib_above_state": (peak - resident) / 2 ** 20}
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
  torch.backends.cudnn.deterministic = deterministic
  (p0, s0, l0), (p1, s1, l1) = after_first[False], after_first[True]
  diff = {
      "params": max(float((p0[k].float() - p1[k].float()).abs().max())
                    for k in p0),
      "statistics": max(float((s0[k] - s1[k]).abs().max()) for k in s0),
      "loss": abs(l0 - l1)}
  result.update({"max_abs_diff": diff,
                 "bitwise_equal": not any(diff.values())})
  emit("zoo_grasp2vec_remat", card=smi, **result)
  if not result["bitwise_equal"]:
    raise AssertionError(f"zoo_grasp2vec: remat differs from no remat: "
                         f"{diff}")
  return result


def run_zoo_check(torch, ss, dev, name: str, scale: str, root: str,
                  smi: str) -> dict:
  """The port's check_<name> at `scale`: the JAX knobs and bar, which
  fails the run when missed."""
  from tensor2robot_tpu_torch.bin import run_capability_checks as checks
  start = time.perf_counter()
  reset_spatial_softmax_counts(ss)
  result = checks._CHECKS[name](scale, root, dev.type)
  bar = checks._EXPECT[(name, scale)]
  result.update({"scale": scale, "knobs": checks._SCALES[name][scale],
                 "bar": bar,
                 "k1_launches_phase": zoo_k1_launches(ss),
                 "seconds": time.perf_counter() - start})
  emit(f"zoo_{name}_check", card=smi, **result)
  if not result["success_rate"] >= bar:
    raise AssertionError(f"check_{name} missed the JAX bar {bar}: {result}")
  return result


def run_zoo_grasp2vec(torch, ss, gl, dev, seed: int, root: str,
                      smi: str) -> dict:
  """Slice 17's grasp2vec paths: BASELINE #2 at its published width
  (ResNet-50, width 64, 224x224, embedding 512, batch 64, bf16, BatchNorm,
  Adam 1e-4) as a train_steps CUDA graph against eager steps bit for bit,
  remat against no remat, and check_grasp2vec at the full scale."""
  from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
      Grasp2VecModel,
  )
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  start = time.perf_counter()
  model = Grasp2VecModel(optimizer_fn=create_adam_optimizer(1e-4))
  stacks = triplet_stacks(torch, dev, seed,
                          [ZOO_WARM_STEPS, ZOO_GRAPH_STEPS], G2V_IMAGE)
  graph = zoo_graph(torch, ss, gl, model, dev, seed, stacks, root,
                    "zoo_grasp2vec", smi)
  del stacks
  gc.collect()
  torch.cuda.empty_cache()
  remat = remat_vs_plain(torch, dev, seed, smi)
  # The full scale: the fast scale's bar (0.38) was calibrated on a TPU
  # v5e, and neither package reaches it off the TPU (ROADMAP.md Facts).
  check = run_zoo_check(torch, ss, dev, "grasp2vec", "full", root, smi)
  return {"graph": graph, "remat": remat, "check": check,
          "seconds": time.perf_counter() - start}


def vrgripper_records(path: str, seed: int) -> int:
  """BASELINE #5's demonstrations as episode_to_transitions writes them:
  pose_env scenes at 100x100 in episodes of VR_CLI_STEPS_PER_EPISODE,
  14-d gripper poses, 7-d actions (the reach target, then zeros)."""
  from tensor2robot_tpu_torch.research.pose_env import pose_env
  from tensor2robot_tpu_torch.research.vrgripper import (
      episode_to_transitions,
  )
  from tensor2robot_tpu_torch.research.vrgripper import (
      vrgripper_env_models as vr,
  )
  n = VR_CLI_EPISODES * VR_CLI_STEPS_PER_EPISODE
  images, targets = pose_env.collect_episodes(n, seed=seed,
                                              image_size=vr.IMAGE_SIZE)
  rng = np.random.default_rng(seed)
  poses = rng.normal(size=(n, vr.GRIPPER_POSE_SIZE)).astype(np.float32)
  actions = np.concatenate([targets, np.zeros((n, 5), np.float32)], -1)
  episodes = [{key: value[i::VR_CLI_EPISODES] for key, value in
               (("images", images), ("gripper_poses", poses),
                ("actions", actions))} for i in range(VR_CLI_EPISODES)]
  episode_to_transitions.write_episodes(path, episodes)
  return n


def run_vrgripper_cli(torch, ss, dev, seed: int, root: str,
                      smi: str) -> dict:
  """vrgripper_train.cfg through run_t2r_trainer on cuda, on records
  episode_to_transitions writes: VR_CLI_STEPS steps into a model_dir with
  checkpoints and an export whose program serves with no model."""
  from tensor2robot_tpu_torch import config
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.export import export_utils
  from tensor2robot_tpu_torch.export import native_export_generator as native
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  start = time.perf_counter()
  records = os.path.join(root, "vrgripper.tfrecord")
  transitions = vrgripper_records(records, seed)
  write_s = time.perf_counter() - start
  model_dir = os.path.join(root, "vrgripper_run")
  cfg = os.path.join(_ROOT, "tensor2robot_tpu_torch", "research",
                     "vrgripper", "configs", "vrgripper_train.cfg")
  config.clear_config()
  reset_spatial_softmax_counts(ss)
  train_start = time.perf_counter()
  rc = run_t2r_trainer.main([
      "--config", cfg, "--import_module",
      "tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models",
      "--binding", f'DefaultRecordInputGenerator.file_patterns = "{records}"',
      "--binding", f"train_eval_model.max_train_steps = {VR_CLI_STEPS}",
      "--binding",
      f"train_eval_model.save_checkpoints_steps = {VR_CLI_SAVE}",
      "--binding", "train_eval_model.log_every_steps = 50",
      "--model_dir", model_dir])
  train_s = time.perf_counter() - train_start
  config.clear_config()
  checkpoints = sorted(int(d) for d in os.listdir(
      os.path.join(model_dir, "checkpoints")) if d.isdigit())
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    logged = [json.loads(line) for line in f]
  losses = [r["loss"] for r in logged if "loss" in r]
  export_root = os.path.join(model_dir, "export", "latest")
  versions = export_utils.list_export_versions(export_root)
  served = ExportedModelPredictor(export_root=export_root)
  restored = served.restore() and served.device.type == "cuda"
  export_dir = os.path.join(export_root, str(versions[-1]))
  out = served.predict(export_features("vrgripper_mdn", 4, seed))
  result = {
      "train_rc": rc, "transitions": transitions, "write_s": write_s,
      "train_s": train_s, "checkpoints": checkpoints,
      "loss_first_last": [losses[0], losses[-1]] if losses else None,
      "export_versions": len(versions),
      "export_files": sorted(os.listdir(export_dir)),
      "program_restored_on_cuda": bool(restored),
      "served_shape": list(out["inference_output"].shape),
      "k1_launches_phase": zoo_k1_launches(ss),
      "seconds": time.perf_counter() - start}
  emit("zoo_vrgripper_cli", card=smi, **result)
  if not (rc == 0 and checkpoints == [VR_CLI_SAVE, VR_CLI_STEPS]
          and versions and native.SERVING_FN_NAME in result["export_files"]
          and restored and result["served_shape"] == [4, 7]
          and np.isfinite(out["inference_output"]).all()
          and not result["k1_launches_phase"]):
    raise AssertionError(f"zoo_vrgripper_cli: {result}")
  return result


def run_meta_bc_graph(torch, ss, gl, dev, seed: int, root: str,
                      smi: str) -> dict:
  """meta-BC (vrgripper_maml_model: float32, GroupNorm, 4+4 samples, one
  inner step, VR_MAML_TASKS tasks) as a train_steps CUDA graph against
  eager meta-steps."""
  from tensor2robot_tpu_torch.research.vrgripper import (
      vrgripper_env_models as vr,
  )
  model = vr.vrgripper_maml_model()
  stacks = spec_stacks(torch, model, dev, seed, VR_MAML_TASKS,
                       [ZOO_WARM_STEPS, ZOO_GRAPH_STEPS])
  return zoo_graph(torch, ss, gl, model, dev, seed, stacks, root,
                   "zoo_vrgripper_meta_bc", smi)


class Background:
  """One of this script's phases in a child process of its own
  (``--background NAME``), started at construction and waited for by
  ``result``, whose value is the child's stdout's last line.

  The record-fed phases (slice 6's ``pose_records``, slice 7's
  ``qtopt_capability``) wait on the host's record parser 93-96% of their
  time with the card idle, so they run beside ``maml`` and ``zoo``, whose
  checks hold bars and bit equality but no time. meta-BC's graph check
  runs in a fresh process for another reason (``run_background``). Every child started is stopped before the script exits."""

  started: list = []

  def __init__(self, name: str, seed: int):
    self.name = name
    self.start = time.perf_counter()
    self.out = tempfile.TemporaryFile(mode="w+")
    self.err = tempfile.TemporaryFile(mode="w+")
    self.proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--background", name,
         "--seed", str(seed)], stdout=self.out, stderr=self.err, text=True)
    Background.started.append(self)

  def result(self, timeout_s: float = 900.0) -> dict:
    try:
      rc = self.proc.wait(timeout=timeout_s)
    finally:
      self.stop()
    self.seconds = time.perf_counter() - self.start
    self.out.seek(0)
    self.err.seek(0)
    out, err = self.out.read(), self.err.read()
    print(out, end="", flush=True)
    if rc:
      raise AssertionError(f"background phase {self.name} failed (rc "
                           f"{rc}):\n{out[-4000:]}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])

  def stop(self) -> None:
    if self.proc.poll() is None:
      self.proc.kill()
      self.proc.wait()


def run_background(name: str, torch, ss, gl, dev, seed: int, root: str,
                   smi: str) -> dict:
  """What ``--background NAME`` runs."""
  if name == "pose_records":
    return {"records": [run_pose_records(torch, ss, gl, dev, record_seed,
                                         root)
                        for record_seed in RECORD_SEEDS]}
  if name == "qtopt_capability":
    return run_qtopt_capability(torch, gl, dev, root)
  if name == "meta_bc_graph":
    # In a process where other models trained first (in this script the
    # MDN and TEC graph cases), meta-BC's eager meta-steps are not
    # reproducible: two single steps from the same variables part by 1e-9
    # in the first layers' gradients, which the second-order meta-step
    # amplifies to 5.6e-4 in the parameters after 5 steps; with cuDNN off,
    # with ``CUBLAS_WORKSPACE_CONFIG`` set and under
    # ``torch.use_deterministic_algorithms(True)`` alike, no op flagged.
    # In a fresh process every run agrees bit for bit (``ROADMAP.md``
    # Queue 3). So the graph is held against eager steps there.
    return run_meta_bc_graph(torch, ss, gl, dev, seed, root, smi)
  if name == "qtopt_mesh":
    return run_qtopt_mesh(torch, dev, seed, root, smi)
  raise ValueError(f"no background phase {name!r}")


def run_zoo_vrgripper(torch, ss, gl, dev, seed: int, root: str,
                      smi: str, meta_bc: Background) -> dict:
  """Slice 17's VRGripper paths: BASELINE #5 at its published width
  (VRGripperEnvModel: FiLM ResNet-18 width 32, 100x100, MDN of 5, action
  7, pose 14, batch 64, bf16) as a CUDA graph against eager steps bit for
  bit, the TEC model (batch 16, 2 + 2 samples) and meta-BC
  (vrgripper_maml_model, 4 tasks) the same way (`meta_bc`, started in a
  process of its own), vrgripper_train.cfg through the CLI, and
  check_vrgripper at the full scale."""
  from tensor2robot_tpu_torch.research.vrgripper import (
      vrgripper_env_models as vr,
  )
  from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_tec_models import (
      VRGripperEnvTecModel,
  )
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  start = time.perf_counter()
  cases = {}
  for name, model, batch in (
      ("zoo_vrgripper_mdn", vr.VRGripperEnvModel(
          optimizer_fn=create_adam_optimizer(1e-4)), ZOO_BATCH),
      ("zoo_vrgripper_tec", VRGripperEnvTecModel(
          optimizer_fn=create_adam_optimizer(1e-4)), TEC_BATCH)):
    stacks = spec_stacks(torch, model, dev, seed, batch,
                         [ZOO_WARM_STEPS, ZOO_GRAPH_STEPS])
    cases[name] = zoo_graph(torch, ss, gl, model, dev, seed, stacks, root,
                            name, smi)
    del stacks
    gc.collect()
    torch.cuda.empty_cache()
  cases["zoo_vrgripper_meta_bc"] = meta_bc.result()
  cli = run_vrgripper_cli(torch, ss, dev, seed, root, smi)
  # The full scale, as for grasp2vec (ROADMAP.md Facts).
  check = run_zoo_check(torch, ss, dev, "vrgripper", "full", root, smi)
  return {"graphs": cases, "cli": cli, "check": check,
          "seconds": time.perf_counter() - start}


def export_features(name: str, batch: int, seed: int) -> dict:
  """A request: pose_env scenes, or VRGripper images and gripper poses at
  the published width."""
  from tensor2robot_tpu_torch.research.vrgripper import (
      vrgripper_env_models as vr,
  )
  rng = np.random.default_rng(seed)
  if name == "pose_env":
    return {"image": env_batch(seed)[:batch]}
  return {"image": rng.random((batch, vr.IMAGE_SIZE, vr.IMAGE_SIZE, 3),
                              np.float32),
          "gripper_pose": rng.normal(
              size=(batch, vr.GRIPPER_POSE_SIZE)).astype(np.float32)}


def run_export_program(torch, ss, dev, seed: int, root: str,
                       smi: str) -> dict:
  """Slice 17's program format: pose_env (BASELINE #1, K1 on its path)
  and the VRGripper MDN model (#5), at their published widths and bf16,
  exported as serving_fn.pt2 on this machine and served by
  ExportedModelPredictor(export_root=...) with no model: outputs against
  the eager model's at batch 1 and 8 through one program, K1's launches
  through the program (one a pose_env request), the t2r_assets.pb read
  back to the JSON asset's specs, trace seconds and request ms beside
  the eager path's."""
  from tensor2robot_tpu_torch.export import export_utils
  from tensor2robot_tpu_torch.export.native_export_generator import (
      NativeExportGenerator,
  )
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.proto import proto_utils
  from tensor2robot_tpu_torch.research.pose_env import (
      PoseEnvRegressionModel,
  )
  from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
      VRGripperEnvModel,
  )
  result = {}
  for name, model, k1_per_request in (
      ("pose_env", PoseEnvRegressionModel(), 1),
      ("vrgripper_mdn", VRGripperEnvModel(), 0)):
    start = time.perf_counter()
    variables = model.init_variables(torch.Generator().manual_seed(seed),
                                     device="cpu")
    generator = NativeExportGenerator(export_root=os.path.join(root, name))
    generator.set_specification_from_model(model)
    export_dir = generator.export(variables, global_step=1)
    program = ExportedModelPredictor(export_root=generator.export_root)
    eager = ExportedModelPredictor(model, generator.export_root)
    if not (program.restore() and eager.restore()
            and program.device.type == "cuda"):
      raise AssertionError(f"export_program {name}: not restored on cuda")
    with open(os.path.join(export_dir,
                           export_utils.SPEC_ASSET_PB_NAME), "rb") as f:
      pb_specs, _, pb_extra = proto_utils.parse_t2r_assets(
          proto_utils.T2RAssets.parse(f.read()))
    json_specs, _, json_extra = export_utils.read_spec_assets(export_dir)
    pb_read_back = (dict(pb_specs) == dict(json_specs)
                    and pb_extra == json_extra)
    reset_spatial_softmax_counts(ss)
    outputs = {b: program.predict(export_features(name, b, seed + b))
               for b in EXPORT_BATCHES}
    launches = dict(ss.spatial_softmax.launches_by_kernel)
    errors = {}
    for b in EXPORT_BATCHES:
      want = eager.predict(export_features(name, b, seed + b))
      errors[b] = max(float(np.abs(outputs[b][k] - want[k]).max())
                      for k in want)
    timings = {}
    for b in EXPORT_BATCHES:
      features = export_features(name, b, seed + b)
      timings[f"program_request_ms_batch{b}"] = host_ms(
          torch, lambda: program.predict(features), reps=16)
      timings[f"eager_request_ms_batch{b}"] = host_ms(
          torch, lambda: eager.predict(features), reps=16)
    result[name] = {
        "trace_s": generator.last_trace_s,
        "program_bytes": os.path.getsize(
            os.path.join(export_dir, "serving_fn.pt2")),
        "format": json_extra["format"],
        "max_abs_vs_eager": {str(b): e for b, e in errors.items()},
        "atol": PROGRAM_ATOL,
        "output_shapes": {str(b): {k: list(v.shape) for k, v in o.items()}
                          for b, o in outputs.items()},
        "k1_launches_program": launches,
        "k1_launches_expected": k1_per_request * len(EXPORT_BATCHES),
        "pb_read_back": pb_read_back,
        **timings, "seconds": time.perf_counter() - start}
    emit("export_program", card=smi, model=name, **result[name])
    finite = all(np.isfinite(v).all() for o in outputs.values()
                 for v in o.values())
    if not (pb_read_back and finite
            and json_extra["format"] == "torch_export_pt2"
            and max(errors.values()) <= PROGRAM_ATOL
            and sum(launches.values()) == k1_per_request * len(
                EXPORT_BATCHES)):
      raise AssertionError(f"export_program {name}: {result[name]}")
  if not result["pose_env"]["k1_launches_expected"] > 0:
    raise AssertionError("export_program: K1 never ran in the program")
  return result


# --- slice 18's rank bodies ----------------------------------------------
# Module-level functions for parallel/launch.py, which spawns each rank
# (the child imports this file without running main). attention_rank runs
# in two ranks on the card; the training bodies there too, and in CPU
# ranks at small sizes in tests/test_torch_parallel_train.py. Every rank
# draws its inputs from the seed, so each holds the same global tensors,
# as a JAX caller's replicated arrays.

# The four modes of the training check: mesh axes and train_eval_model's
# arguments.
PARALLEL_MODES = {
    "dp": dict(axes={"data": 2}),
    "zero1": dict(axes={"data": 2}, shard_optimizer_state=True),
    "fsdp": dict(axes={"data": 2}, fsdp=True),
    "tp": dict(axes={"data": 1, "model": 2}, partition_rules=True),
}


def _rank_device(torch, name: str):
  return torch.device("cuda", 0) if name == "cuda" else torch.device("cpu")


def _tf32_off(torch) -> None:
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False


def _held(torch, name: str, got, want) -> dict:
  """|got - want| against flash_limit; raises past it."""
  diff = (got.float() - want.float()).abs()
  share = float((diff / flash_limit(torch, want)).max())
  if not share <= 1.0:
    raise AssertionError(f"{name}: max err {float(diff.max())}, {share} "
                         "times its limit at worst")
  return {"max_abs_err": float(diff.max()), "limit_share": share}


def _forward_backward(torch, fn, inputs, dout, device):
  """(output, gradients, ms): fn's forward and backward from leaf copies
  of `inputs`, timed on the host clock around synchronised work."""
  leaves = [x.detach().clone().requires_grad_() for x in inputs]
  torch.cuda.synchronize(device)
  start = time.perf_counter()
  out = fn(*leaves)
  out.backward(dout)
  torch.cuda.synchronize(device)
  ms = (time.perf_counter() - start) * 1e3
  return out.detach(), [x.grad for x in leaves], ms


def _collective_counts(collectives) -> dict:
  return {"calls": dict(collectives.calls),
          "payload_bytes": dict(collectives.payload_bytes),
          "staged_bytes": dict(collectives.staged_bytes)}


def attention_rank(rank: int, seed: int) -> dict:
  """Ulysses, ring and the SNAIL ring block on a {"seq": ranks} mesh on
  the card: Ulysses with the flash kernels as its local core (K2 forward,
  K3 and K4 backward) against one process's ``ops.flash_attention`` on the
  global input, this rank's kernel launches counted; ring attention
  against the dense reference; SNAIL's ``AttentionBlock(seq_mesh=)``
  trained PARALLEL_SNAIL_STEPS Adam steps against the unsharded block
  from the same weights."""
  import torch

  from tensor2robot_tpu_torch.layers import snail
  from tensor2robot_tpu_torch.layers.vision_layers import Dense
  from tensor2robot_tpu_torch.models.abstract_model import flax_default_init_
  from tensor2robot_tpu_torch.parallel import collectives, distributed
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  from tensor2robot_tpu_torch.parallel.ring_attention import (
      dense_attention_reference,
      ring_attention,
  )
  from tensor2robot_tpu_torch.parallel.ulysses_attention import (
      ulysses_attention,
  )
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")
  device = _rank_device(torch, "cuda")
  _tf32_off(torch)
  mesh = mesh_lib.create_mesh({"seq": distributed.process_count()})
  rng = np.random.default_rng(seed)
  shape = PARALLEL_ATTENTION_SHAPE
  q, k, v = (torch.from_numpy(0.5 * rng.standard_normal(shape).astype(
      np.float32)).to(device, torch.bfloat16) for _ in range(3))
  dout = torch.from_numpy(rng.standard_normal(shape).astype(
      np.float32)).to(device, torch.bfloat16)
  result = {"rank": rank, "shape": list(shape), "dtype": "bfloat16",
            "local_shape": [shape[0], shape[1], shape[2] // mesh.size,
                            shape[3]]}

  def ulysses(*x):
    return ulysses_attention(*x, mesh, causal=True, attn_impl="pallas")

  # One process's flash attention on the global input, then Ulysses with
  # the flash kernels locally (a warm call first); this rank's launches
  # counted for the timed call.
  want_out, want_grads, result["flash_ms"] = _forward_backward(
      torch, lambda *x: fa.flash_attention(*x, causal=True), (q, k, v),
      dout, device)
  _forward_backward(torch, ulysses, (q, k, v), dout, device)
  for name in fa.flash_attention.launches:
    fa.flash_attention.launches[name] = 0
  collectives.reset_counts()
  out, grads, result["ulysses_ms"] = _forward_backward(
      torch, ulysses, (q, k, v), dout, device)
  result["ulysses_launches"] = dict(fa.flash_attention.launches)
  result["ulysses"] = {
      name: _held(torch, f"ulysses {name}", got, want)
      for name, got, want in zip(("out", "dq", "dk", "dv"),
                                 [out] + grads, [want_out] + want_grads)}
  result["ulysses_collectives"] = _collective_counts(collectives)

  # Ring attention against the dense reference.
  want_out, want_grads, result["dense_ms"] = _forward_backward(
      torch, lambda *x: dense_attention_reference(*x, causal=True),
      (q, k, v), dout, device)
  collectives.reset_counts()
  out, grads, result["ring_ms"] = _forward_backward(
      torch, lambda *x: ring_attention(*x, mesh, causal=True), (q, k, v),
      dout, device)
  result["ring"] = {
      name: _held(torch, f"ring {name}", got, want)
      for name, got, want in zip(("out", "dq", "dk", "dv"),
                                 [out] + grads, [want_out] + want_grads)}
  result["ring_collectives"] = _collective_counts(collectives)

  # SNAIL's attention block with seq_mesh against the unsharded block.
  torch.manual_seed(seed)
  blocks, heads = [], []
  for seq_mesh in (mesh, None):
    blocks.append(snail.AttentionBlock(SNAIL_FEATURES, SNAIL_FEATURES,
                                       SNAIL_FEATURES, torch.float32,
                                       seq_mesh=seq_mesh))
    heads.append(Dense(blocks[-1].out_features, 1, torch.float32))
  flax_default_init_(blocks[0], torch.Generator().manual_seed(seed))
  flax_default_init_(heads[0], torch.Generator().manual_seed(seed))
  blocks[1].load_state_dict(blocks[0].state_dict())
  heads[1].load_state_dict(heads[0].state_dict())
  x = torch.from_numpy(rng.standard_normal(
      (SNAIL_BATCH, SNAIL_SEQ, SNAIL_FEATURES)).astype(np.float32)).to(device)
  target = torch.from_numpy(rng.standard_normal(
      (SNAIL_BATCH, SNAIL_SEQ, 1)).astype(np.float32)).to(device)
  losses, step_ms = [], []
  for block, head in zip(blocks, heads):
    block.to(device)
    head.to(device)
    optimizer = create_adam_optimizer()(list(block.parameters())
                                        + list(head.parameters()))
    stream, times = [], []
    for _ in range(PARALLEL_SNAIL_STEPS):
      torch.cuda.synchronize(device)
      start = time.perf_counter()
      optimizer.zero_grad(set_to_none=True)
      loss = torch.mean((head(block(x)) - target) ** 2)
      loss.backward()
      optimizer.step()
      torch.cuda.synchronize(device)
      times.append((time.perf_counter() - start) * 1e3)
      stream.append(float(loss.detach()))
    losses.append(stream)
    step_ms.append(float(np.median(times[1:] or times)))
  rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
  if not rel <= TRAIN_F32_RTOL:
    raise AssertionError(f"SNAIL ring block vs unsharded: losses {losses}")
  result["snail"] = {"shape": [SNAIL_BATCH, SNAIL_SEQ, SNAIL_FEATURES],
                     "steps": PARALLEL_SNAIL_STEPS, "losses_ring": losses[0],
                     "losses_dense": losses[1], "max_rel_loss_diff": rel,
                     "loss_rtol": TRAIN_F32_RTOL,
                     "step_ms_ring": step_ms[0], "step_ms_dense": step_ms[1]}
  result["backend"] = collectives.describe()
  return result


def _host_copies(variables) -> dict:
  """numpy copies (a CPU tensor's numpy view would follow its in-place
  updates)."""
  return {key: value.detach().float().cpu().numpy().copy()
          for key, value in variables.items()}


def _recorder(keep: bool):
  """A hook builder whose one hook records each step's loss, and the first
  step's update of every variable and its reduced gradients, whole (kept
  when `keep`: on rank 0)."""
  from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder

  class Recorder(Hook, HookBuilder):

    def __init__(self):
      self.losses, self.before, self.update, self.grads = [], None, None, None

    def create_hooks(self, trainer, model_dir: str):
      return [self]

    def begin(self, trainer, state, model_dir: str) -> None:
      self.trainer = trainer
      self.before = _host_copies(state.full_variables())

    def after_step(self, state, metrics: dict) -> None:
      self.losses.append(float(metrics["loss"]))
      if state.step == 1:
        after = _host_copies(state.full_variables())
        grads = ({key: p.grad for key, p in state.params.items()
                  if p.grad is not None} if state.layout is None
                 else state.layout.full_gradients(state))
        if keep:
          self.update = {key: after[key] - self.before[key] for key in after}
          self.grads = _host_copies(grads)
        self.before = None

  return Recorder()


def parallel_flagship_model(cfg: dict):
  """The QT-Opt critic of the training check: its published widths at
  ``cfg["image_size"]``, float32 (TF32 off; ``cfg["dtype"]`` may say
  float64), batch norm, the EMA kept; warm-started from
  ``cfg["init_from_checkpoint"]`` when given (an npz of either package)."""
  import torch

  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  dtype = getattr(torch, cfg.get("dtype", "float32"))
  return QTOptGraspingModel(
      image_size=cfg["image_size"], compute_dtype=dtype,
      param_dtype=dtype, use_avg_model_params=True,
      init_from_checkpoint=cfg.get("init_from_checkpoint"))


def _train_mode(cfg: dict, mode, keep: bool) -> dict:
  """``train_eval_model`` over a mesh in `mode` (None: one rank on the
  global batch), recording the loss of each step, the first step's update
  of every variable, the step time, the rank's peak memory, its parameter
  blocks' shapes, the shapes of the Adam moments its optimizer holds and
  the collectives' bytes."""
  import torch

  from tensor2robot_tpu_torch.data.default_input_generator import (
      DefaultRandomInputGenerator,
  )
  from tensor2robot_tpu_torch.parallel import collectives, tp_rules
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  from tensor2robot_tpu_torch.train import mesh_layout
  from tensor2robot_tpu_torch.train.train_eval import train_eval_model
  device = _rank_device(torch, cfg["device"])
  _tf32_off(torch)
  model = parallel_flagship_model(cfg)
  kwargs = {}
  if mode is not None:
    spec = PARALLEL_MODES[mode]
    mesh = mesh_lib.create_mesh(spec["axes"])
    kwargs = {"mesh": mesh,
              "shard_optimizer_state": spec.get("shard_optimizer_state",
                                                False),
              "fsdp": spec.get("fsdp", False)}
    if spec.get("partition_rules"):
      kwargs["param_specs"] = tp_rules.partition_specs_for_model(model, mesh)
  recorder = _recorder(keep)
  collectives.reset_counts()
  held = 0
  if device.type == "cuda":
    torch.cuda.synchronize(device)  # the context exists before the reset
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
  # One directory for every rank (the primary writes, all read).
  model_dir = os.path.join(cfg["model_dir"], mode or "one_rank")
  start = time.perf_counter()
  result = train_eval_model(
      model, DefaultRandomInputGenerator(batch_size=cfg["batch"],
                                         seed=cfg["seed"]),
      max_train_steps=cfg["steps"], model_dir=model_dir,
      log_every_steps=1, device=device, seed=cfg["seed"],
      handle_preemption=False, hook_builders=[recorder], **kwargs)
  seconds = time.perf_counter() - start
  payload = torch.load(os.path.join(model_dir, "checkpoints",
                                    str(cfg["steps"]), "state.pt"),
                       map_location="cpu", weights_only=True)
  state = result.state
  # The first Adam moment of each parameter, as the optimizer holds it.
  owner = {id(tensor): key for key, tensor in
           (state.opt_params or state.params).items()}
  moments = {owner[id(p)]: list(state.opt_state.state[p]["exp_avg"].shape)
             for group in state.opt_state.param_groups
             for p in group["params"]}
  out = {
      "mode": mode or "one_rank", "steps": cfg["steps"],
      "losses": recorder.losses,
      "step_ms_median": result.loop_stats.get("step_ms_median"),
      "seconds": seconds,
      # Above what the process held before the run (the one-rank run
      # shares its process with whatever ran before it).
      "peak_mib": ((torch.cuda.max_memory_allocated(device) - held)
                   / 2 ** 20 if device.type == "cuda" else None),
      "local_shapes": {key: list(value.shape)
                       for key, value in state.params.items()},
      "opt_local_shapes": moments,
      "moment_elements_local": sum(int(np.prod(shape))
                                   for shape in moments.values()),
      "checkpoint_mesh": payload.get("mesh"),
      "checkpoint_params_whole": {key: list(value.shape)
                                  for key, value in payload["params"].items()},
      "collectives": _collective_counts(collectives),
      "graphed": recorder.trainer.graphs_steps,
  }
  if mode is not None:
    out["layout"] = mesh_layout.describe(state.layout)
    out["backend"] = collectives.describe()
  if keep:
    out["update"] = recorder.update
    out["grads"] = recorder.grads
    out["batch_stats"] = _host_copies(state.model_state)
  return out


def train_reference(cfg: dict) -> dict:
  """The training check's run on this one process, on the global batch."""
  return _train_mode(cfg, None, keep=True)


def train_rank(rank: int, cfg: dict) -> dict:
  """Every mode of `cfg["modes"]` in turn on this rank."""
  return {mode: _train_mode(cfg, mode, keep=rank == 0)
          for mode in cfg["modes"]}


def bn_fed_biases(model) -> set:
  """The conv biases of the critic that feed BatchNorm: their exact
  gradient is 0, so Adam steps them on float noise."""
  names = [name for name, _ in model.module.named_parameters()]
  return {name for name in names if name.endswith(".bias")
          and (name.startswith("stem.") or name.startswith("pre_conv")
               or name.startswith("post_conv"))}


def compare_training(reference: dict, got: dict, model, tolerances: dict
                     ) -> dict:
  """A mode's run against the one-rank run: each step's loss within
  `loss_rtol`, the final running statistics within `stats_atol`, the
  first step's gradient of every tensor within `grad_share` of the
  tensor's largest (Adam's update is blind to a gradient's scale), and
  its first update within `adam_atol` wherever the one-rank gradient
  exceeds `grad_noise_share` of that largest (elsewhere a gradient within
  float noise of 0 may step either way); the BN-fed biases, whose
  gradient is noise, are not held. Raises past a limit."""
  losses = np.array(got["losses"])
  want = np.array(reference["losses"])
  report = {
      "max_rel_loss_diff": float(np.max(np.abs(losses - want)
                                        / np.abs(want))),
      "stats_max_abs_err": max(
          float(np.abs(got["batch_stats"][k] - v).max())
          for k, v in reference["batch_stats"].items()),
      "update_max_abs_err": 0.0, "update_held_share": 0.0,
  }
  skip = bn_fed_biases(model)
  held = total = 0
  report["grad_err_share"] = 0.0
  for key, grad in reference["grads"].items():
    if key in skip:
      continue
    largest = np.abs(grad).max()
    share = float(np.abs(got["grads"][key] - grad).max() / largest)
    if share >= report["grad_err_share"]:
      report["grad_err_share"], report["grad_err_worst"] = share, key
    mask = np.abs(grad) > tolerances["grad_noise_share"] * largest
    diff = np.abs(got["update"][key] - reference["update"][key])[mask]
    if diff.size:
      report["update_max_abs_err"] = max(report["update_max_abs_err"],
                                         float(diff.max()))
    held += int(mask.sum())
    total += mask.size
  report["update_held_share"] = held / max(total, 1)
  if not (report["max_rel_loss_diff"] <= tolerances["loss_rtol"]
          and report["stats_max_abs_err"] <= tolerances["stats_atol"]
          and report["grad_err_share"] <= tolerances["grad_share"]
          and report["update_max_abs_err"] <= tolerances["adam_atol"]):
    raise AssertionError(f"{got['mode']} disagrees with the one-rank run: "
                         f"{report}")
  return report


def run_parallel_attention(torch, seed: int, smi: str) -> dict:
  """Slice 18's sequence-parallel path in 2 ranks on the card (see the
  docstring); each rank's K2-K4 launches through Ulysses must be one
  forward, one dq and one dkv on the tensor cores."""
  from tensor2robot_tpu_torch.parallel import launch
  start = time.perf_counter()
  ranks = launch.launch(attention_rank, PARALLEL_RANKS, (seed,),
                        device="cuda", timeout_s=300)
  want = kernels_of(torch, torch.bfloat16)
  for rank in ranks:
    if rank["ulysses_launches"] != want:
      raise AssertionError(f"rank {rank['rank']} launched "
                           f"{rank['ulysses_launches']} through Ulysses; "
                           f"want {want}")
  return {"ranks": PARALLEL_RANKS, "nvidia_smi": smi,
          "seconds": time.perf_counter() - start, "per_rank": ranks}


def run_parallel_train(torch, seed: int, root: str, smi: str) -> dict:
  """Slice 18's training path: the four modes in 2 ranks on the card, each
  against one rank's run on the global batch (``train_rank``)."""
  from tensor2robot_tpu_torch.parallel import launch
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      IMAGE_SIZE,
      QTOptGraspingModel,
  )
  start = time.perf_counter()
  cfg = dict(device="cuda", image_size=IMAGE_SIZE,
             batch=QTOptGraspingModel.benchmark_batch_size, seed=seed,
             steps=PARALLEL_TRAIN_STEPS, modes=list(PARALLEL_MODES),
             model_dir=os.path.join(root, "parallel_train"))
  tf32 = (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32)
  reference = train_reference(cfg)
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
      tf32)
  ranks = launch.launch(train_rank, PARALLEL_RANKS, (cfg,),
                        device="cuda", timeout_s=600)
  model = parallel_flagship_model(cfg)
  tolerances = dict(loss_rtol=TRAIN_F32_RTOL, stats_atol=TRAIN_F32_ATOL,
                    adam_atol=ADAM_ATOL, grad_share=PARALLEL_GRAD_SHARE,
                    grad_noise_share=GRAD_NOISE_SHARE)
  whole = {key: list(p.shape) for key, p in model.module.named_parameters()}
  modes = {}
  for mode in PARALLEL_MODES:
    got = ranks[0][mode]
    report = compare_training(reference, got, model, tolerances)
    layout = got["layout"]
    sharded = sorted(key for key, shape in got["local_shapes"].items()
                     if shape != whole[key])
    if mode == "tp" and got["local_shapes"]["stem.weight"] != [32, 3, 6, 6]:
      raise AssertionError(f"tp: stem.weight is {got['local_shapes']}")
    if mode == "fsdp" and not sharded:
      raise AssertionError("fsdp: no parameter is sharded")
    # The Adam moments the optimizer holds: as many elements as the
    # layout's table gives this rank, in blocks under every mode but DP.
    blocks = sorted(key for key, shape in got["opt_local_shapes"].items()
                    if shape != whole[key])
    if (got["moment_elements_local"] != layout["optimizer_elements_local"]
        or bool(blocks) == (mode == "dp")):
      raise AssertionError(f"{mode}: the optimizer holds "
                           f"{got['moment_elements_local']} moment elements "
                           f"in blocks of {blocks}; the layout gives "
                           f"{layout['optimizer_elements_local']}")
    if got["graphed"] or got["checkpoint_mesh"] != layout["mesh"]:
      raise AssertionError(f"{mode}: graphed {got['graphed']}, checkpoint "
                           f"stamp {got['checkpoint_mesh']}")
    modes[mode] = {
        **report, "losses": got["losses"],
        "step_ms_median_by_rank": [r[mode]["step_ms_median"] for r in ranks],
        "peak_mib_by_rank": [r[mode]["peak_mib"] for r in ranks],
        "seconds_by_rank": [r[mode]["seconds"] for r in ranks],
        "sharded_params": sharded, "layout": layout,
        "moment_elements_local": got["moment_elements_local"],
        "sharded_moments": blocks,
        "collectives_by_rank": [r[mode]["collectives"] for r in ranks],
        "backend": got["backend"], "graphed": got["graphed"],
        "checkpoint_mesh": got["checkpoint_mesh"]}
  return {"ranks": PARALLEL_RANKS, "nvidia_smi": smi,
          "image_size": cfg["image_size"], "batch": cfg["batch"],
          "steps": cfg["steps"], "compute_dtype": "float32", "tf32": False,
          "tolerances": tolerances,
          "one_rank": {"losses": reference["losses"],
                       "step_ms_median": reference["step_ms_median"],
                       "peak_mib": reference["peak_mib"]},
          "modes": modes, "seconds": time.perf_counter() - start}


# --- slice 20: the QT-Opt replay loop over a mesh of ranks --------------------


def mesh_config(seed: int):
  """The production loop's config (``run_qtopt_replay``'s full scale: the
  64x64 flagship, CEM 64/6/3, batch 32, a fleet of 32 envs)."""
  from tensor2robot_tpu_torch.bin.run_qtopt_replay import build_config
  return build_config(False, seed)


def mesh_flagship(config):
  """The loop's flagship critic at the config's width, float32 (the
  parity runs hold TF32 off)."""
  import torch

  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.utils import optimizers
  return QTOptGraspingModel(
      image_size=config.image_size, action_size=config.action_size,
      uint8_images=True, norm="group", compute_dtype=torch.float32,
      optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))


def mesh_anakin(dev, seed: int, mesh, zero1: bool, min_fill: int,
                tp: bool = False):
  """The Anakin loop at the production width over `mesh` (None: one
  rank, eager), on a ring of MESH_CAPACITY."""
  from tensor2robot_tpu_torch.parallel import tp_rules
  from tensor2robot_tpu_torch.replay.anakin import AnakinLoop
  from tensor2robot_tpu_torch.replay.device_buffer import DeviceReplayBuffer
  from tensor2robot_tpu_torch.replay.loop import transition_spec
  from tensor2robot_tpu_torch.research.qtopt.device_grasping import (
      DeviceGraspEnv,
      make_scene_bank,
  )
  from tensor2robot_tpu_torch.train.trainer import Trainer
  config = mesh_config(seed)
  model = mesh_flagship(config)
  specs = (tp_rules.partition_specs_for_model(model, mesh, axis="model")
           if tp else None)
  trainer = Trainer(model, seed=seed, device=dev, mesh=mesh,
                    param_specs=specs, shard_optimizer_state=zero1)
  state = trainer.create_train_state()
  fleet = config.num_collectors * config.envs_per_collector
  ring = DeviceReplayBuffer(
      transition_spec(config.image_size, config.action_size), MESH_CAPACITY,
      config.batch_size, seed=seed, prioritized=True, ingest_chunk=fleet,
      mesh=trainer.mesh, device=dev)
  env = DeviceGraspEnv(
      fleet, image_size=config.image_size, max_attempts=config.max_attempts,
      radius=config.grasp_radius,
      bank=make_scene_bank(MESH_BANK_SCENES, image_size=config.image_size,
                           base_seed=seed, device=dev), device=dev)
  loop = AnakinLoop(
      model, trainer, ring, env, action_size=config.action_size,
      gamma=config.gamma, num_samples=config.cem_num_samples,
      num_elites=config.cem_num_elites, iterations=config.cem_iterations,
      inner_steps=MESH_INNER, train_every=MESH_INNER, min_fill=min_fill,
      exploration_epsilon=config.exploration_epsilon,
      scripted_fraction=config.scripted_fraction, seed=seed + 13,
      health=True, graphs=False)
  loop.refresh(state.full_variables(use_ema=True), 0)
  return state, loop, ring


def mesh_streams(dev, seed: int, dp=None, tp=None) -> dict:
  """The mesh phase's runs on one rank (`dp` None) or over the given
  meshes: a collect-only Anakin dispatch (its ring and fleet whole), three
  trained Anakin dispatches and three megastep dispatches with ZeRO-1
  over `dp` (the collectives' bytes of the last Anakin one), and two
  trained dispatches over `tp`."""
  from tensor2robot_tpu_torch.parallel import collectives
  from tensor2robot_tpu_torch.replay.loop import param_sharding_summary
  out = {}
  state, loop, ring = mesh_anakin(dev, seed, dp, zero1=dp is not None,
                                  min_fill=10 ** 9)
  state, metrics = loop.step(state)
  if metrics["trained_steps"]:
    raise AssertionError("the collect-only dispatch learned")
  arrays = loop.checkpoint_arrays()
  out["pretrain"] = {"env": arrays["env"], "ring": arrays["buffer"],
                     "ring_bytes_local": sum(
                         t.numel() * t.element_size()
                         for t in (*ring.state.storage.values(),
                                   ring.state.written_at))}
  del state, loop, ring
  state, loop, _ = mesh_anakin(dev, seed, dp, zero1=dp is not None,
                               min_fill=MESH_MIN_FILL)
  trained = []
  for i in range(MESH_DISPATCHES):
    if i == MESH_DISPATCHES - 1:
      collectives.reset_counts()
    start = time.perf_counter()
    state, metrics = loop.step(state)  # its metrics' readback waits
    trained.append({**metrics, "seconds": time.perf_counter() - start})
  out["trained"] = trained
  out["collectives_last_dispatch"] = _collective_counts(collectives)
  out["compile_counts"] = dict(loop.compile_counts)
  out["mesh_shape"] = loop.mesh_shape
  del state, loop
  out["megastep"] = mesh_megastep(dev, seed, dp)
  if tp is not None:
    state, loop, _ = mesh_anakin(dev, seed, tp, zero1=False,
                                 min_fill=MESH_MIN_FILL, tp=True)
    metrics = []
    for _ in range(2):
      state, got = loop.step(state)
      metrics.append(got)
    out["tp2"] = {"metrics": metrics, "mesh_shape": loop.mesh_shape,
                  "param_sharding": param_sharding_summary(state),
                  "compile_counts": dict(loop.compile_counts)}
  return out


def mesh_megastep(dev, seed: int, mesh) -> list:
  """Three megastep dispatches at the production width over a ring every
  rank fills with the same seeded rows (ZeRO-1 over a mesh)."""
  from tensor2robot_tpu_torch.replay.device_buffer import (
      DeviceReplayBuffer,
      MegastepLearner,
  )
  from tensor2robot_tpu_torch.replay.loop import transition_spec
  from tensor2robot_tpu_torch.train.trainer import Trainer
  config = mesh_config(seed)
  model = mesh_flagship(config)
  trainer = Trainer(model, seed=seed, device=dev, mesh=mesh,
                    shard_optimizer_state=mesh is not None)
  state = trainer.create_train_state()
  ring = DeviceReplayBuffer(
      transition_spec(config.image_size, config.action_size), MESH_CAPACITY,
      config.batch_size, seed=seed, prioritized=True, ingest_chunk=64,
      mesh=trainer.mesh, device=dev)
  rng = np.random.default_rng(seed + 17)
  size, rows = config.image_size, 4 * 64
  ring.extend({
      "image": rng.integers(0, 256, (rows, size, size, 3), dtype=np.uint8),
      "action": rng.uniform(-1, 1, (rows, 4)).astype(np.float32),
      "reward": (rng.random(rows) < 0.3).astype(np.float32),
      "done": (rng.random(rows) < 0.3).astype(np.float32),
      "next_image": rng.integers(0, 256, (rows, size, size, 3),
                                 dtype=np.uint8)})
  learner = MegastepLearner(
      model, trainer, ring, action_size=config.action_size,
      gamma=config.gamma, num_samples=config.cem_num_samples,
      num_elites=config.cem_num_elites, iterations=config.cem_iterations,
      inner_steps=MESH_MEGASTEP_INNER, seed=seed + 13, health=True,
      graphs=False)
  learner.refresh(state.full_variables(use_ema=True), step=0)
  metrics = []
  for _ in range(MESH_DISPATCHES):
    state, got = learner.step(state)
    metrics.append(got)
  return metrics


def mesh_rank(rank: int, seed: int) -> dict:
  """A rank of the mesh phase: {"data": 2} and {"data": 1, "model": 2}
  over the two ranks, float32 with TF32 off and cuDNN deterministic."""
  import torch

  from tensor2robot_tpu_torch.parallel import create_mesh
  _tf32_off(torch)
  torch.backends.cudnn.deterministic = True
  dev = torch.device("cuda", 0)
  out = mesh_streams(dev, seed, dp=create_mesh({"data": MESH_RANKS}),
                     tp=create_mesh({"data": 1, "model": MESH_RANKS}))
  out["rank"] = rank
  return out


def _relative_diffs(got: list, want: list) -> dict:
  """Each held key's largest |got - want| / (atol + rtol |want|) over the
  dispatches (at most 1 within the bound)."""
  return {key: max(abs(g[key] - w[key])
                   / (MESH_LOSS_ATOL + MESH_LOSS_RTOL * abs(w[key]))
                   for g, w in zip(got, want))
          for key in MESH_HELD_KEYS}


def run_mesh_cli(seed: int, root: str) -> dict:
  """``run_qtopt_replay --anakin --mesh 2`` at the production config under
  ``torch.distributed.run``: two ranks on the card, the primary's one
  JSON line."""
  import socket
  with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
  start = time.perf_counter()
  # A session of its own, so that a run past its time takes its ranks
  # down with it.
  proc = subprocess.Popen(
      [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
       str(MESH_RANKS), "--master-port", str(port), "-m",
       "tensor2robot_tpu_torch.bin.run_qtopt_replay", "--anakin", "--mesh",
       str(MESH_RANKS), "--steps", str(MESH_CLI_STEPS), "--seed", str(seed),
       "--no-anakin-bench", "--logdir", os.path.join(root, "mesh_cli")],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_ROOT,
      env={**os.environ, "PYTHONPATH": _ROOT}, start_new_session=True)
  try:
    stdout, stderr = proc.communicate(timeout=600)
  finally:
    if proc.poll() is None:
      os.killpg(proc.pid, signal.SIGKILL)
      proc.wait()
  seconds = time.perf_counter() - start
  lines = [line for line in stdout.splitlines() if line.startswith("{")]
  if proc.returncode or len(lines) != 1:
    raise AssertionError(f"run_qtopt_replay --mesh {MESH_RANKS} rc "
                         f"{proc.returncode}, {len(lines)} JSON lines:\n"
                         f"{stdout[-3000:]}\n{stderr[-3000:]}")
  result = json.loads(lines[0])
  if (result["mesh_shape"] != {"data": MESH_RANKS, "model": 1}
      or result["zero1"] is not True or result["steps"] < MESH_CLI_STEPS
      or set(result["compile_counts"].values()) != {1}
      or not np.isfinite(result["final_eval"]["eval_td_error"])):
    raise AssertionError(f"the mesh CLI's line: {lines[0][:3000]}")
  return {"seconds": seconds, "steps": result["steps"],
          "mesh_shape": result["mesh_shape"], "zero1": result["zero1"],
          "param_sharding": result["param_sharding"],
          "compile_counts": result["compile_counts"],
          "final_eval": result["final_eval"],
          "buffer": result["buffer"]}


def run_qtopt_mesh(torch, dev, seed: int, root: str, smi: str) -> dict:
  """Slice 20's main path: the replay loop over two gloo ranks on the card
  (see the docstring), each run against one rank's."""
  import hashlib

  from tensor2robot_tpu_torch.parallel import launch
  from tensor2robot_tpu_torch.replay.loop import transition_spec
  start = time.perf_counter()
  tf32 = (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.deterministic)
  _tf32_off(torch)
  torch.backends.cudnn.deterministic = True
  one = mesh_streams(dev, seed)
  (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.deterministic) = tf32
  one_seconds = time.perf_counter() - start
  ranks = launch.launch(mesh_rank, MESH_RANKS, (seed,), device="cuda",
                        timeout_s=600)
  mesh_seconds = time.perf_counter() - start - one_seconds
  report = {"ranks": MESH_RANKS, "nvidia_smi": smi, "tf32": False,
            "compute_dtype": "float32", "capacity": MESH_CAPACITY,
            "tolerances": {"rtol": MESH_LOSS_RTOL, "atol": MESH_LOSS_ATOL}}
  # Before any learn: the ring and the fleet, whole, bit for bit.
  unequal = []
  for rank in ranks:
    for part in ("env", "ring"):
      for key, want in one["pretrain"][part].items():
        if not np.array_equal(rank["pretrain"][part][key], want):
          unequal.append(f"rank {rank['rank']} {part}/{key}")
  if unequal:
    raise AssertionError(f"the collect-only stream at dp={MESH_RANKS} "
                         f"differs from one rank's: {unequal}")
  report["pretrain"] = {
      "bitwise_equal": True,
      "episodes": int(one["pretrain"]["env"]["episodes"]),
      "ring_sha256": hashlib.sha256(
          one["pretrain"]["ring"]["storage/image"].tobytes()).hexdigest(),
      "ring_bytes_one_rank": one["pretrain"]["ring_bytes_local"],
      "ring_bytes_by_rank": [r["pretrain"]["ring_bytes_local"]
                             for r in ranks]}
  # Learns: within the float32 bound of one rank's.
  for name in ("trained", "megastep"):
    want = one[name]
    diffs = [_relative_diffs(rank[name], want) for rank in ranks]
    worst = max(max(d.values()) for d in diffs)
    if not worst <= 1.0 or any(
        g.get("trained_steps") != w.get("trained_steps")
        for rank in ranks for g, w in zip(rank[name], want)):
      raise AssertionError(f"{name} at dp={MESH_RANKS}: {diffs} of the "
                           f"bound; {[r[name] for r in ranks]} against "
                           f"{want}")
    if not all(m["health/grad_norm"] > 0 for m in want):
      raise AssertionError(f"{name}: one rank's gradient norms {want}")
    report[name] = {
        "bound_share_by_rank": diffs,
        "metrics_one_rank": [{k: m[k] for k in MESH_HELD_KEYS}
                             for m in want],
        "metrics_rank0": [{k: m[k] for k in MESH_HELD_KEYS}
                          for m in ranks[0][name]]}
  report["trained"]["dispatch_s_one_rank"] = [
      m["seconds"] for m in one["trained"]]
  report["trained"]["dispatch_s_by_rank"] = [
      [m["seconds"] for m in rank["trained"]] for rank in ranks]
  report["collectives_last_dispatch_by_rank"] = [
      rank["collectives_last_dispatch"] for rank in ranks]
  # Tensor parallelism: the flagship's partition rules split the critic.
  tp2 = ranks[0]["tp2"]
  sharding = tp2["param_sharding"]
  if (tp2["mesh_shape"] != {"data": 1, "model": MESH_RANKS}
      or not sharding["model_sharded_leaves"]
      or not sharding["param_bytes_per_replica"]
      < sharding["param_bytes_total"]
      or tp2["compile_counts"] != {"anakin_step": 1}
      or not all(np.isfinite(m[k]) for m in tp2["metrics"]
                 for k in MESH_LOSS_KEYS)
      or not all(m["trained_steps"] for m in tp2["metrics"])):
    raise AssertionError(f"tp={MESH_RANKS}: {tp2}")
  report["tp2"] = {
      **tp2,
      # Reported, not held: column-parallel convolutions compute each
      # block of channels on its own.
      "bound_share_vs_one_rank": _relative_diffs(
          tp2["metrics"], one["trained"][:2])}
  spec = transition_spec(64, 4)
  row = sum(int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
            for s in spec.values()) + 8  # and written_at's int64
  capacity = mesh_config(seed).capacity
  report["ring_bytes_per_transition"] = row
  report["production_ring"] = {
      "capacity": capacity, "bytes_whole": row * capacity,
      "bytes_per_rank": row * capacity // MESH_RANKS}
  report["cli"] = run_mesh_cli(seed, root)
  report["seconds"] = {"one_rank": one_seconds, "mesh_ranks": mesh_seconds,
                       "cli": report["cli"]["seconds"],
                       "total": time.perf_counter() - start}
  return report


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--background", default=None,
                      choices=("pose_records", "qtopt_capability",
                               "meta_bc_graph", "qtopt_mesh"),
                      help="run only this phase and print its result last "
                      "(the child process a Background starts)")
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available; nothing was run.",
          file=sys.stderr)
    return 2
  sys.path.insert(0, _ROOT)
  from tensor2robot_tpu_torch.ops import _build
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.pose_env import (
      PoseEnvRegressionModel,
      evaluate_policy,
  )
  ss = importlib.import_module("tensor2robot_tpu_torch.ops.spatial_softmax")
  gl = importlib.import_module("tensor2robot_tpu_torch.ops.graph_launches")
  dev = torch.device("cuda")
  smi = nvidia_smi()
  if args.background:
    with tempfile.TemporaryDirectory() as tmp:
      result = run_background(args.background, torch, ss, gl, dev,
                              args.seed, tmp, smi)
    print(json.dumps(result), flush=True)
    return 0
  emit("device", name=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), nvidia_smi=smi,
       torch=torch.__version__, cuda=torch.version.cuda)

  clock = PhaseClock()
  start = time.perf_counter()
  _build.build_all()
  emit("build", seconds=time.perf_counter() - start,
       libraries=list(_build.KERNEL_SOURCES),
       ptxas={k: [line for line in v.splitlines()
                  if "ptxas info" in line or "warning" in line]
              for k, v in _build.build_logs.items()})
  clock.lap("build")

  emit("kernel_checks", spatial_softmax=check_spatial_softmax(
      torch, ss, dev, args.seed))
  fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")
  torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32
  emit("kernel_checks", flash_attention=check_flash_attention(
      torch, fa, dev, args.seed))
  clock.lap("kernel_checks")

  # The main path: serve a native export on the GPU, through the entry
  # points a robot calls, at the default bfloat16 compute dtype.
  images = env_batch(args.seed + 1)
  with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "exports")
    model = PoseEnvRegressionModel()
    state = write_export(torch, model, root, args.seed)
    predictor = ExportedModelPredictor(model, root)
    if not predictor.restore() or predictor.device.type != "cuda":
      raise AssertionError("the predictor did not load the export on cuda")
    reset_spatial_softmax_counts(ss)
    start = time.perf_counter()
    result = evaluate_policy(predictor, num_episodes=EPISODES,
                             seed=args.seed)
    served = predictor.predict({"image": images})["inference_output"]
    seconds = time.perf_counter() - start
    launches = ss.spatial_softmax.launches
    by_kernel = dict(ss.spatial_softmax.launches_by_kernel)
    if launches != EPISODES + 1 or by_kernel != {"warp": 0,
                                                 "channels": launches}:
      raise AssertionError(f"spatial_softmax launched {by_kernel} for "
                           f"{EPISODES + 1} predicts; want the channel "
                           "kernel once each")
    if served.shape != (BATCH, 2) or not np.isfinite(served).all():
      raise AssertionError(f"served outputs {served.shape} not finite")
    on_cpu = ExportedModelPredictor(model, root, device="cpu")
    on_cpu.restore()
    bf16_err = float(np.abs(
        served - on_cpu.predict({"image": images})["inference_output"]).max())
    if not bf16_err <= SERVE_BF16_ATOL:
      raise AssertionError(f"bf16 GPU vs CPU serving: {bf16_err}")
    request_ms = host_ms(torch, lambda: predictor.predict(
        {"image": images[:1]}))
    batch_ms = host_ms(torch, lambda: predictor.predict({"image": images}))
    emit("slice", compute_dtype="bfloat16", requests=EPISODES + 1,
         images=EPISODES + BATCH, seconds=seconds, eval=result,
         spatial_softmax_launches=by_kernel, max_abs_err_vs_cpu=bf16_err,
         atol=SERVE_BF16_ATOL, request_ms_batch1=request_ms,
         request_ms_batch64=batch_ms)

    # float32 with TF32 off (cuDNN convolutions default to TF32): the
    # algorithm, held tight against the CPU.
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = PoseEnvRegressionModel(compute_dtype=torch.float32)
    gpu32, cpu32 = (ExportedModelPredictor(model32, root, device=d)
                    for d in ("cuda", "cpu"))
    gpu32.restore()
    cpu32.restore()
    out32 = gpu32.predict({"image": images})["inference_output"]
    f32_err = float(np.abs(
        out32 - cpu32.predict({"image": images})["inference_output"]).max())
    if not (np.isfinite(out32).all() and f32_err <= SERVE_F32_ATOL):
      raise AssertionError(f"f32 GPU vs CPU serving: {f32_err}")
    emit("slice_f32", tf32=False, max_abs_err_vs_cpu=f32_err,
         atol=SERVE_F32_ATOL)

    # The batch's feature map, as the served tower hands it to K1.
    tower = {k.split(".", 1)[1]: v.to(dev) for k, v in state.items()
             if k.startswith("tower.")}
    with torch.inference_mode():
      feature_map = torch.func.functional_call(
          model.module.tower, tower, (torch.from_numpy(images).to(dev),))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        tf32)
  clock.lap("serve_slice")

  # Slice 5's main path: train pose_env through K1 to the reach bar.
  with tempfile.TemporaryDirectory() as tmp:
    pose = run_pose_training(torch, ss, dev, args.seed, tmp)
    emit("pose_train_f32", **pose_train_f32(torch, dev, args.seed,
                                            pose["images"], pose["poses"]))
    emit("pose_train_eval", **run_train_eval(torch, dev, args.seed, tmp))
  clock.lap("pose_train")

  # Slice 2's main path: train the SNAIL stack through K2, K3 and K4.
  snail = run_snail_slice(torch, fa, dev, args.seed)
  emit("snail_slice", **snail)
  clock.lap("snail_slice")

  # Slice 7's main paths: pose_env's step and the flagship critic's as
  # CUDA graphs against eager steps, gradient accumulation on the card
  # against the CPU (its QT-Opt capability check at full scale runs
  # below, beside maml and the zoo).
  with tempfile.TemporaryDirectory() as tmp:
    graphed_pose = pose_graph(torch, ss, gl, dev, args.seed, pose["images"],
                              pose["poses"], tmp)
    emit("pose_graph", **graphed_pose)
    accum = accum_gpu_vs_cpu(torch, ss, dev, args.seed, pose["images"],
                             pose["poses"])
    emit("grad_accum", **accum)
    emit("qtopt_flagship", **run_qtopt_flagship(torch, ss, gl, dev,
                                                args.seed, tmp))
  clock.lap("pose_graph_accum_qtopt_flagship")

  # Slice 8's main path: the QT-Opt learner on Bellman targets (the
  # learner's host path; no TPU kernel runs on it).
  with tempfile.TemporaryDirectory() as tmp:
    emit("qtopt_learner", **run_qtopt_learner(torch, dev, args.seed, tmp,
                                              smi))
  clock.lap("qtopt_learner")

  # Slice 9's main path: the closed QT-Opt loop (collectors acting through
  # the fleet policy's CUDA graphs while the learner trains); no TPU
  # kernel runs on it.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    loop_result = run_qtopt_loop(torch, gl, dev, args.seed, tmp, smi)
    emit("qtopt_loop", seconds=time.perf_counter() - start, **loop_result)
  clock.lap("qtopt_loop")

  # Slice 10's main paths: the loop's checkpoints, resume and profiler
  # window, and its vector actor; no TPU kernel runs on them.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    resume_result = run_qtopt_resume(torch, gl, dev, args.seed, tmp, smi)
    emit("qtopt_resume", seconds=time.perf_counter() - start,
         **resume_result)
  clock.lap("qtopt_resume")
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    vector_result = run_qtopt_vector(torch, gl, dev, args.seed, tmp, smi)
    emit("qtopt_vector", seconds=time.perf_counter() - start,
         **vector_result)
  clock.lap("qtopt_vector")

  # Slice 11's main paths: the device-resident ring and the megastep learner
  # (CUDA graphs of K learn iterations); no TPU kernel runs on them.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    device_result = run_qtopt_device(torch, gl, dev, args.seed, tmp, smi)
    emit("qtopt_device", seconds=time.perf_counter() - start,
         **device_result)
  clock.lap("qtopt_device")

  # Slice 12's main paths: the fused Anakin loop (the env, acting, the
  # extend and the learner on the card); no TPU kernel runs on them.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    anakin_result = run_qtopt_anakin(torch, gl, dev, args.seed, tmp, smi)
    emit("qtopt_anakin", seconds=time.perf_counter() - start,
         **anakin_result)
  clock.lap("qtopt_anakin")

  # Slice 13's main paths: the bf16 and int8 scoring tiers through the
  # fleet policy, the benches, the megastep and the Anakin loop; no TPU
  # kernel runs on them.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    precision_result = run_qtopt_precision(
        torch, dev, args.seed, tmp, smi, anakin_result["production"])
    emit("qtopt_precision", seconds=time.perf_counter() - start,
         **precision_result)
  clock.lap("qtopt_precision")

  # Slice 14's main paths: the obs spine through the replay loop, and one
  # serving replica; no TPU kernel runs on them.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    obs_result = run_obs_loop(torch, dev, args.seed, tmp, smi)
    emit("obs_loop", seconds=time.perf_counter() - start, **obs_result)
  clock.lap("obs_loop")
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    serve_result = run_serve_fleet(torch, dev, args.seed, tmp, smi)
    emit("serve_fleet", seconds=time.perf_counter() - start,
         **serve_result)
  clock.lap("serve_fleet")

  # Slice 15's main paths: the routed fleet, two replicas on the one card
  # behind the router, the rollout controller and the tier rollouts; no
  # TPU kernel runs on them.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    router_result = run_serve_router(torch, dev, args.seed, tmp, smi)
    emit("serve_router", seconds=time.perf_counter() - start,
         **router_result)
  clock.lap("serve_router")

  # Slice 6's main path (the pose_env run from jpeg records through the
  # CLI, model_dir and a resume) and slice 7's QT-Opt capability check at
  # full scale, each in a process of its own beside maml and the zoo: they
  # wait on the host's record parser with the card idle.
  records = [crc_rates()]
  background = {name: Background(name, args.seed)
                for name in ("qtopt_capability", "pose_records",
                             "qtopt_mesh")}
  clock.lap("crc_and_background_start")

  # Slice 16's main paths: MAML through K1's forward and its second-order
  # outer gradient (the check, the graphs, meta-serving), and the training
  # harness it runs through.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    maml = run_maml(torch, ss, gl, dev, args.seed, tmp, smi)
    maml_launches = {
        "maml_check": maml["check"]["k1_launches"],
        **{f"maml_graph_{variant}": case["k1_launches_phase"]
           for variant, case in maml["graph"].items()},
        "maml_serve": maml["serve"]["k1_launches_phase"],
        "maml_harness": maml["harness"]["k1_launches_phase"]}
    emit("maml", seconds=time.perf_counter() - start,
         success_rate_at_half_radius=maml["check"][
             "success_rate_at_half_radius"],
         margin=maml["check"]["margin"],
         graphs_bitwise_equal={k: v["bitwise_equal"]
                               for k, v in maml["graph"].items()},
         k1_launches=maml_launches)
  clock.lap("maml")

  # Slice 17's main paths: the research zoo at its published widths
  # (grasp2vec's ResNet-50, VRGripper's FiLM ResNet, TEC and meta-BC as
  # CUDA graphs, remat, the CLI, the capability checks; no TPU kernel runs
  # on them) and the program format, whose pose_env program holds K1 as
  # its custom op.
  with tempfile.TemporaryDirectory() as tmp:
    start = time.perf_counter()
    meta_bc = Background("meta_bc_graph", args.seed)
    zoo_g2v = run_zoo_grasp2vec(torch, ss, gl, dev, args.seed, tmp, smi)
    zoo_vr = run_zoo_vrgripper(torch, ss, gl, dev, args.seed, tmp, smi,
                               meta_bc)
    programs = run_export_program(torch, ss, dev, args.seed, tmp, smi)
    program_launches = programs["pose_env"]["k1_launches_program"]
    emit("zoo", seconds=time.perf_counter() - start,
         grasp2vec_retrieval=zoo_g2v["check"]["success_rate"],
         vrgripper_success=zoo_vr["check"]["success_rate"],
         graphs_bitwise_equal={
             "zoo_grasp2vec": zoo_g2v["graph"]["bitwise_equal"],
             **{k: v["bitwise_equal"] for k, v in zoo_vr["graphs"].items()}},
         remat_bitwise_equal=zoo_g2v["remat"]["bitwise_equal"],
         phase_s={"zoo_grasp2vec": zoo_g2v["seconds"],
                  "zoo_vrgripper": zoo_vr["seconds"],
                  "export_program": sum(p["seconds"]
                                        for p in programs.values())},
         k1_launches_export_program=program_launches)
  clock.lap("zoo")

  capability = background["qtopt_capability"].result()
  records += background["pose_records"].result()["records"]
  # Slice 20's main path: the replay loop over a mesh of two gloo ranks
  # (a child beside maml and the zoo: it holds parity, no time).
  mesh_result = background["qtopt_mesh"].result()
  emit("qtopt_mesh", **mesh_result)
  emit("pose_records_summary", **records[0],
       success_rates={r["seed"]: r["success_rate"] for r in records[1:]},
       success_rates_at_0_1={r["seed"]: r["success_rate_at_0.1"]
                             for r in records[1:]},
       step_ms_median={r["seed"]: r["step_ms_median"] for r in records[1:]},
       input_wait_ms_median={r["seed"]: r["input_wait_ms_median"]
                             for r in records[1:]},
       input_wait_share={r["seed"]: r["input_wait_share"]
                         for r in records[1:]},
       write_s={r["seed"]: r["write_s"] for r in records[1:]},
       phase_s={r["seed"]: r["seconds"] for r in records[1:]},
       parser_records_per_s_4_threads=records[1][
           "parser_records_per_s_4_threads"],
       sha256_first_16_records_seed_0=records[1]["sha256_first_16_records"])
  clock.lap("background_wait")
  # Each child's seconds from its start to its join, beside its phase's
  # own.
  background_seconds = {
      "qtopt_capability": {
          "start_to_join_s": background["qtopt_capability"].seconds,
          "phase_s": capability["seconds"]},
      "pose_records": {
          "start_to_join_s": background["pose_records"].seconds,
          "phase_s": sum(r["seconds"] for r in records[1:])},
      "qtopt_mesh": {
          "start_to_join_s": background["qtopt_mesh"].seconds,
          "phase_s": mesh_result["seconds"]["total"]}}

  # Slice 18's main paths: the parallel tier's training half, two gloo
  # ranks on the one card: Ulysses through K2-K4 a rank, ring attention,
  # the SNAIL ring block, and the critic's four training modes.
  parallel_attention = run_parallel_attention(torch, args.seed, smi)
  emit("parallel_attention", **parallel_attention)
  clock.lap("parallel_attention")
  with tempfile.TemporaryDirectory() as tmp:
    emit("parallel_train", **run_parallel_train(torch, args.seed, tmp, smi))
  clock.lap("parallel_train")

  timing = time_spatial_softmax(torch, ss, feature_map)
  emit("kernel_timing", spatial_softmax=timing)
  # K1 on the map the train step hands it, where its layout differs.
  training_map = pose["feature_map"]
  training_timing = None
  if pose["training_map_kernel"] != timing[0]["kernel"]:
    training_timing = next(
        row for row in time_spatial_softmax(torch, ss, training_map)
        if row["shape"][0] == BATCH and row["dtype"] == "bfloat16")
    emit("kernel_timing", spatial_softmax_training_map=training_timing)
  flash_timing = time_flash_attention(torch, fa, dev, args.seed + 3)
  emit("kernel_timing", flash_attention=flash_timing)
  clock.lap("kernel_timing")
  emit("phase_seconds", seconds=clock.seconds, total=clock.total(),
       background=background_seconds, nvidia_smi=smi)
  # The batch predict's call: batch 64 in the default bfloat16 (and the
  # batch-1 request's time beside it).
  main_row, batch1_row = (
      next(row for row in timing
           if row["shape"][0] == batch and row["dtype"] == "bfloat16")
      for batch in (BATCH, 1))
  print(json.dumps({"kernels": [{
      "name": "spatial_softmax",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/spatial_softmax.cu",
      "replaces": "tensor2robot_tpu/ops/spatial_softmax.py:50",
      "launches": (launches + POSE_STEPS + REACH_EPISODES + len(
          RECORD_SEEDS) * (POSE_STEPS + REACH_EPISODES + 2)
                   + sum(graphed_pose["k1_launches_phase"].values())
                   + accum["k1_launches"]
                   + sum(sum(v.values()) for v in maml_launches.values())
                   + sum(program_launches.values())),
      "launches_by_path": {
          "serve_slice": by_kernel, "pose_train": pose["k1_launches_training"],
          "pose_reach": pose["k1_launches_served"],
          **{f"pose_records_{r['seed']}_{part}": r[f"k1_launches_{part}"]
             for r in records[1:] for part in ("training", "served")},
          "pose_graph": graphed_pose["k1_launches_phase"],
          "grad_accum": {"channels": accum["k1_launches"]},
          **maml_launches, "export_program": program_launches},
      "export_program_request_ms": {
          key: programs["pose_env"][key] for key in programs["pose_env"]
          if key.endswith("_ms_batch1") or key.endswith("_ms_batch8")},
      "maml_k1_launches_per_meta_step": maml["check"][
          "k1_launches_per_meta_step"],
      "maml_k1_launches_per_eval": {
          "adapted": maml["check"]["k1_launches_eval_adapted"],
          "unadapted": maml["check"]["k1_launches_eval_unadapted"]},
      "maml_map": maml["check"]["k1_timing"],
      "launches_from_graph_replays": {
          **{f"pose_records_{r['seed']}": r["k1_launches_from_replays"]
             for r in records[1:]},
          "pose_graph": graphed_pose["k1_launches_from_replays"],
          "maml_check": maml["check"]["k1_launches_from_replays"]},
      "kernel": main_row["kernel"],
      "max_abs_err": main_row["max_abs_err"],
      "ms": main_row["ms"],
      "earlier_ms": main_row["earlier_ms"],
      "batch1_ms": batch1_row["ms"],
      "plain_ms": main_row["plain_ms"],
      "bound_ms": main_row["bound_ms"],
      "bound_by": main_row["bound_by"],
      "library_ms": None,  # no single PyTorch call computes it
      "shape": main_row["shape"],
      "strides": main_row["strides"],
      "dtype": main_row["dtype"],
      "training_map": training_timing,
  }] + [{
      "name": f"flash_attention_{name}",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/flash_attention.cu",
      "replaces": f"tensor2robot_tpu/ops/flash_attention.py:{line}",
      "launches": snail["launches"][counter] + sum(
          rank["ulysses_launches"][counter]
          for rank in parallel_attention["per_rank"]),
      "launches_by_path": {
          "snail_slice": snail["launches"][counter],
          **{f"parallel_attention_rank_{rank['rank']}":
             rank["ulysses_launches"][counter]
             for rank in parallel_attention["per_rank"]}},
      **flash_timing[name],
      # SDPA's backward computes dq, dk and dv in one call: the pair
      # dq + dkv compares with it.
      **({"library_covers": "dq, dk and dv (K3 + K4)"}
         if name != "forward" else {}),
  } for name, counter, line in (("forward", "forward_tc", 69),
                                ("dq", "dq_tc", 181),
                                ("dkv", "dkv_tc", 216))]}),
        flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  finally:
    for child in Background.started:
      child.stop()
