#!/usr/bin/env python3
"""Where a SNAIL training step spends its time on one CUDA GPU.

    python3 scripts/profile_snail_training.py [--out DIR] [--steps N]

Builds the SNAIL stack that ``chip_smoke.py`` trains (8 x 2048 x 64 in,
attention, an 11-block TCBlock, attention, a dense head; bfloat16 compute,
Adam 1e-4) and, for the flash core (K2-K4) and the dense core, prints one
JSON line with:

- the median wall time of a step and of its stages on the host clock
  (forward, backward, optimizer), each ending in ``torch.cuda.synchronize()``;
- from a ``torch.profiler`` trace of ``--steps`` steps: the device time per
  step (kernels, copies and memsets), the device's idle share of the
  profiled wall time (the profiler slows the host, so this share is high)
  and of the unprofiled step time, the kernel launches per step, the
  device time of the attention kernels (the port's ``flash_*`` kernels), in
  all and by kernel, and the kernels with the most device time.

The chrome traces go to ``--out``. Run from the repository root.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_summary(trace_path: str, steps: int, wall_ms: float) -> dict:
  with open(trace_path) as f:
    events = json.load(f)["traceEvents"]
  device_us = 0.0
  launches = 0
  by_kernel = collections.Counter()
  flash = collections.Counter()
  for event in events:
    category = event.get("cat", "")
    if category in _DEVICE_CATEGORIES and "dur" in event:
      name = event.get("name", "?")
      device_us += float(event["dur"])
      by_kernel[name[:80]] += float(event["dur"])
      kernel = re.search(r"flash_\w+", name)
      if kernel:
        flash[kernel.group(0)] += float(event["dur"])
    if category == "kernel":
      launches += 1
  device_ms = device_us / 1e3
  return {
      "device_ms_per_step": device_ms / steps,
      "flash_kernel_ms_per_step": sum(flash.values()) / 1e3 / steps,
      "flash_ms_per_step_by_kernel": {
          name: us / 1e3 / steps for name, us in flash.items()},
      "kernels_per_step": launches / steps,
      "device_idle_share": (1.0 - device_ms / wall_ms) if device_us else None,
      "top_device_ms_per_step": {
          name: us / 1e3 / steps for name, us in by_kernel.most_common(8)},
  }


def _stage_ms(torch, stack, optimizer, x, target, reps: int) -> dict:
  """Host-clock medians of a step's forward, backward and optimizer."""
  times = collections.defaultdict(list)
  for _ in range(reps):
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss = torch.mean((stack(x) - target) ** 2)
    torch.cuda.synchronize()
    middle = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    end = time.perf_counter()
    optimizer.step()
    torch.cuda.synchronize()
    times["forward_ms"].append((middle - start) * 1e3)
    times["backward_ms"].append((end - middle) * 1e3)
    times["optimizer_ms"].append((time.perf_counter() - end) * 1e3)
  return {name: float(np.median(values)) for name, values in times.items()}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                    "profiles"))
  parser.add_argument("--steps", type=int, default=10)
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("profile_snail_training: CUDA is not available.", file=sys.stderr)
    return 2
  import chip_smoke
  from tensor2robot_tpu_torch.models.abstract_model import flax_default_init_
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer
  os.makedirs(args.out, exist_ok=True)
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True, timeout=60).stdout.strip()
  dev = torch.device("cuda")
  rng = np.random.default_rng(args.seed + 2)
  x = torch.from_numpy(rng.standard_normal(
      (chip_smoke.SNAIL_BATCH, chip_smoke.SNAIL_SEQ,
       chip_smoke.SNAIL_FEATURES)).astype(np.float32)).to(dev)
  target = torch.from_numpy(rng.standard_normal(
      (chip_smoke.SNAIL_BATCH, chip_smoke.SNAIL_SEQ, 1)).astype(
          np.float32)).to(dev)
  for core, use_flash in (("flash", True), ("dense", False)):
    stack = chip_smoke.snail_stack(torch, torch.bfloat16, use_flash)
    flax_default_init_(stack, torch.Generator().manual_seed(args.seed))
    stack.to(dev)
    optimizer = create_adam_optimizer()(stack.parameters())

    def step():
      optimizer.zero_grad(set_to_none=True)
      torch.mean((stack(x) - target) ** 2).backward()
      optimizer.step()

    for _ in range(3):
      step()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
      start = time.perf_counter()
      step()
      torch.cuda.synchronize()
      times.append((time.perf_counter() - start) * 1e3)
    stages = _stage_ms(torch, stack, optimizer, x, target, 10)
    trace_path = os.path.join(args.out, f"snail_training_{core}.json")
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      torch.cuda.synchronize()
      start = time.perf_counter()
      for _ in range(args.steps):
        step()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - start) * 1e3
    prof.export_chrome_trace(trace_path)
    summary = _trace_summary(trace_path, args.steps, wall_ms)
    step_ms = float(np.median(times))
    print(json.dumps({
        "core": core, "card": card, "step_ms": step_ms,
        "profiled_step_ms": wall_ms / args.steps, **stages, **summary,
        "device_idle_share_of_step": 1.0 - summary["device_ms_per_step"] / (
            step_ms)}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
