#!/usr/bin/env python3
"""Where a pose_env training step spends its time on one CUDA GPU.

    python3 scripts/profile_pose_training.py [--out DIR] [--steps N]

Builds the step that ``chip_smoke.py`` trains (BASELINE config #1 at its
published width, bfloat16, batch 64 of collected episodes through the
model's preprocessor, Adam 1e-3, ``Trainer.train_step``) and prints one
JSON line with:

- the median wall time of a step and of its stages on the host clock
  (forward with the loss, backward, Adam), each ending in
  ``torch.cuda.synchronize()``;
- from a ``torch.profiler`` trace of ``--steps`` steps: the device time per
  step (kernels, copies and memsets), the kernel launches per step, the
  device time of K1 (the port's ``spatial_softmax*`` kernels) by kernel and
  its share of the step's device time, the device's idle share of the
  unprofiled step time, and the kernels with the most device time.

The chrome trace goes to ``--out``. Run from the repository root.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                    "profiles"))
  parser.add_argument("--steps", type=int, default=10)
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("profile_pose_training: CUDA is not available.", file=sys.stderr)
    return 2
  import chip_smoke
  from tensor2robot_tpu_torch.data.prefetch import prefetch_to_device
  from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
  from tensor2robot_tpu_torch.research.pose_env.pose_env import (
      collect_episodes,
  )
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  os.makedirs(args.out, exist_ok=True)
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True, timeout=60).stdout.strip()
  model = PoseEnvRegressionModel(
      optimizer_fn=create_adam_optimizer(chip_smoke.POSE_LR))
  images, poses = collect_episodes(4 * chip_smoke.BATCH, seed=args.seed)
  batches = list(prefetch_to_device(chip_smoke.pose_batches(
      model.preprocessor, images, poses, 8, np.random.default_rng(1))))
  trainer = Trainer(model, seed=args.seed)
  state = trainer.create_train_state()

  def step(i):
    nonlocal state
    state, _ = trainer.train_step(state, *batches[i % len(batches)])

  for i in range(5):
    step(i)
  torch.cuda.synchronize()
  times = []
  for i in range(20):
    start = time.perf_counter()
    step(i)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)

  stages = collections.defaultdict(list)
  optimizer = state.opt_state
  for i in range(10):
    features, labels = batches[i % len(batches)]
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss, (_, new_state) = model.model_train_fn(state.variables(), features,
                                                labels)
    torch.cuda.synchronize()
    middle = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    end = time.perf_counter()
    optimizer.step()
    torch.cuda.synchronize()
    state.model_state.update(new_state)
    stages["forward_ms"].append((middle - start) * 1e3)
    stages["backward_ms"].append((end - middle) * 1e3)
    stages["optimizer_ms"].append((time.perf_counter() - end) * 1e3)

  profile_batches = [batches[i % len(batches)] for i in range(args.steps + 3)]
  state, summary = chip_smoke.profile_steps(
      torch, trainer, state, profile_batches, args.out, "pose_training")
  step_ms = float(np.median(times))
  k1_ms = sum(summary["matched_ms_per_step"].values())
  print(json.dumps({
      "card": card, "batch": chip_smoke.BATCH, "compute_dtype": "bfloat16",
      "step_ms": step_ms,
      **{name: float(np.median(values)) for name, values in stages.items()},
      "device_ms_per_step": summary["device_ms_per_step"],
      "kernels_per_step": summary["kernels_per_step"],
      "k1_ms_per_step": summary["matched_ms_per_step"],
      "k1_share_of_device_time": k1_ms / summary["device_ms_per_step"],
      "profiled_step_ms": summary["profiled_step_ms"],
      "device_idle_share_profiled": summary["device_idle_share"],
      "device_idle_share_of_step": 1.0 - summary["device_ms_per_step"] / (
          step_ms),
      "top_device_ms_per_step": summary["top_device_ms_per_step"],
  }), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
