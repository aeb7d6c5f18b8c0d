#!/usr/bin/env python3
"""Where a pose_env serving request spends its time on one CUDA GPU.

    python3 scripts/profile_pose_serving.py [--out DIR] [--requests N]

Serves random weights for the pose_env regression model through the
PyTorch port's ``ExportedModelPredictor`` (as ``chip_smoke.py`` does) and,
for batch 1 and batch 64, prints one JSON line with:

- the median wall time of a request, and of its stages on the host clock
  (feature validation, host->device copy, the forward pass, the
  device->host read), each ending in ``torch.cuda.synchronize()``;
- from a ``torch.profiler`` trace of ``--requests`` requests: the device
  time per request (kernels, copies and memsets), the device's idle share
  of the wall time, the kernel launches per request, and the kernels
  with the most device time.

The chrome traces go to ``--out``. Run from the repository root.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _stages(torch, host_ms, predictor, model, variables, images) -> dict:
  """Host-clock stage times of predict(), replayed step by step."""
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  spec = predictor.get_feature_specification()
  features = {"image": images}
  device_inputs = ts.TensorSpecStruct(
      {"image": torch.from_numpy(images).to(predictor.device)})
  outputs = model.predict_fn(variables, device_inputs)
  return {
      "validate_ms": host_ms(
          torch, lambda: ts.validate_and_flatten(spec, features), 50),
      "to_device_ms": host_ms(
          torch, lambda: torch.from_numpy(images).to(predictor.device), 50),
      "forward_ms": host_ms(
          torch, lambda: model.predict_fn(variables, device_inputs), 50),
      "to_host_ms": host_ms(
          torch, lambda: outputs["inference_output"].cpu().numpy(), 50),
  }


def _trace_summary(trace_path: str, requests: int, wall_ms: float) -> dict:
  with open(trace_path) as f:
    events = json.load(f)["traceEvents"]
  device_us = 0.0
  launches = 0
  by_kernel = collections.Counter()
  for event in events:
    category = event.get("cat", "")
    if category in _DEVICE_CATEGORIES and "dur" in event:
      device_us += float(event["dur"])
      by_kernel[event.get("name", "?")[:80]] += float(event["dur"])
    if category == "kernel":
      launches += 1
  device_ms = device_us / 1e3
  return {
      "device_ms_per_request": device_ms / requests,
      "kernels_per_request": launches / requests,
      "device_idle_share": (1.0 - device_ms / wall_ms) if device_us else None,
      "top_device_us_per_request": {
          name: us / requests for name, us in by_kernel.most_common(8)},
  }


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                    "profiles"))
  parser.add_argument("--requests", type=int, default=20)
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("profile_pose_serving: CUDA is not available.", file=sys.stderr)
    return 2
  from chip_smoke import env_batch, host_ms, write_export
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.pose_env import (
      PoseEnvRegressionModel,
  )
  os.makedirs(args.out, exist_ok=True)
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True, timeout=60).stdout.strip()
  images = env_batch(args.seed + 1)
  with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "exports")
    model = PoseEnvRegressionModel()
    state = write_export(torch, model, root, args.seed)
    predictor = ExportedModelPredictor(model, root)
    predictor.restore()
    variables = {k: v.to(predictor.device) for k, v in state.items()}
    for batch in (1, images.shape[0]):
      batch_images = images[:batch]
      request = lambda: predictor.predict({"image": batch_images})
      for _ in range(10):
        request()
      request_ms = host_ms(torch, request, 50)
      stages = _stages(torch, host_ms, predictor, model, variables,
                       batch_images)
      trace_path = os.path.join(args.out, f"pose_serving_b{batch}.json")
      with torch.profiler.profile(activities=[
          torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(args.requests):
          request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
      prof.export_chrome_trace(trace_path)
      print(json.dumps({
          "batch": batch, "card": card, "request_ms": request_ms,
          "profiled_request_ms": wall_ms / args.requests, **stages,
          **_trace_summary(trace_path, args.requests, wall_ms)}),
          flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
