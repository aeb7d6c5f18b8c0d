#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one CUDA GPU and checks it.

    python3 chip_smoke.py

Run from the repository root, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. It builds every kernel of the path from ``csrc/``,
holds each against its plain PyTorch version, then serves the pose_env
regression model (BASELINE config #1 at its published width: 64x64 RGB,
convs 3->32->48->64, a 16x16x64 map, spatial softmax to 128, then 64,
then 2) from a native export directory through ``ExportedModelPredictor``
and ``evaluate_policy``, and holds the GPU's outputs against the same
weights served on the CPU. Each phase prints one JSON line; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero. Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the float32 rate
# outside the tensor cores, which this kernel's arithmetic runs on.
_HBM_BYTES_PER_S = 3.35e12
_F32_FLOPS = 67e12
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


def emit(phase: str, **fields) -> None:
  print(json.dumps({"phase": phase, **fields}), flush=True)


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
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(inner):
      fn()
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


def check_spatial_softmax(torch, ss, dev, seed: int) -> list:
  """Holds the kernel against its plain version on every listed case."""
  rng = np.random.default_rng(seed)
  cases = []
  for shape in [(1, 16, 16, 64), (64, 16, 16, 64), (2, 8, 8, 16),
                (1, 7, 5, 3), (3, 1, 9, 130), (4, 128, 128, 32)]:
    for dtype in (torch.float32, torch.bfloat16):
      for layout in ("nhwc", "nchw"):
        cases.append((shape, dtype, layout, 1.0))
  cases.append(((2, 6, 6, 4), torch.float32, "nhwc", 0.5))
  cases.append(((64, 16, 16, 64), torch.bfloat16, "nchw", 0.5))
  results = []
  for shape, dtype, layout, temperature in cases:
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(dev, dtype)
    if layout == "nchw":
      x = nchw_view(x)
    got = ss.spatial_softmax(x, temperature)
    torch.cuda.synchronize()
    want = ss.spatial_softmax_reference(x, temperature)
    if got.dtype != dtype or got.shape != (shape[0], 2 * shape[3]):
      raise AssertionError(f"spatial_softmax {shape}: got {got.dtype} "
                           f"{tuple(got.shape)}")
    err = float((got.float() - want.float()).abs().max())
    atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
    results.append({"shape": list(shape), "dtype": str(dtype)[6:],
                    "layout": layout, "temperature": temperature,
                    "max_abs_err": err, "atol": atol})
    if not err <= atol:
      raise AssertionError(f"spatial_softmax disagrees: {results[-1]}")

  # A sharp peak at (row 2, col 5) of an 8x8 map (tests/test_ops.py).
  peak = torch.full((1, 8, 8, 1), -10.0, device=dev)
  peak[0, 2, 5, 0] = 10.0
  out = ss.spatial_softmax(peak).cpu().numpy()[0]
  grid = np.linspace(-1, 1, 8)
  if abs(out[0] - grid[5]) >= 1e-3 or abs(out[1] - grid[2]) >= 1e-3:
    raise AssertionError(f"spatial_softmax peak at {out}, want "
                         f"({grid[5]}, {grid[2]})")
  results.append({"case": "peak", "out": out.tolist()})

  # First-order gradients: the kernel's backward differentiates the plain
  # version, and must match differentiating the plain version directly.
  for shape in [(2, 6, 6, 4), (64, 16, 16, 64)]:
    base = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xk = base.to(dev).requires_grad_()
    xr = base.to(dev).requires_grad_()
    torch.sum(ss.spatial_softmax(xk) ** 2).backward()
    torch.sum(ss.spatial_softmax_reference(xr) ** 2).backward()
    err = float((xk.grad - xr.grad).abs().max())
    results.append({"case": "grad", "shape": list(shape),
                    "max_abs_err": err, "atol": F32_ATOL})
    if not err <= F32_ATOL:
      raise AssertionError(f"spatial_softmax gradient disagrees: "
                           f"{results[-1]}")
  return results


def time_spatial_softmax(torch, ss, feature_map) -> list:
  """Kernel vs plain version on the feature map the conv tower gives it
  (its memory layout included), at batch 1 and 64, bf16 and f32."""
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
          "max_abs_err": float((got.float() - want.float()).abs().max()),
          "ms": device_ms(torch, lambda: ss.spatial_softmax(x)),
          "plain_ms": device_ms(
              torch, lambda: ss.spatial_softmax_reference(x)),
          "call_ms": host_ms(torch, lambda: ss.spatial_softmax(x)),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      })
  return rows


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


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--seed", type=int, default=0)
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
  dev = torch.device("cuda")
  smi = nvidia_smi()
  emit("device", name=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), nvidia_smi=smi,
       torch=torch.__version__, cuda=torch.version.cuda)

  start = time.perf_counter()
  _build.build_all()
  emit("build", seconds=time.perf_counter() - start,
       libraries=list(_build.KERNEL_SOURCES),
       ptxas={k: [line for line in v.splitlines() if "ptxas info" in line]
              for k, v in _build.build_logs.items()})

  emit("kernel_checks", spatial_softmax=check_spatial_softmax(
      torch, ss, dev, args.seed))

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
    ss.spatial_softmax.launches = 0
    start = time.perf_counter()
    result = evaluate_policy(predictor, num_episodes=EPISODES,
                             seed=args.seed)
    served = predictor.predict({"image": images})["inference_output"]
    seconds = time.perf_counter() - start
    launches = ss.spatial_softmax.launches
    if launches != EPISODES + 1:
      raise AssertionError(f"spatial_softmax launched {launches} times for "
                           f"{EPISODES + 1} predicts")
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
         spatial_softmax_launches=launches, max_abs_err_vs_cpu=bf16_err,
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

  timing = time_spatial_softmax(torch, ss, feature_map)
  emit("kernel_timing", spatial_softmax=timing)
  # The batch predict's call: batch 64 in the default bfloat16.
  main_row = next(row for row in timing
                  if row["shape"][0] == BATCH and row["dtype"] == "bfloat16")
  print(json.dumps({"kernels": [{
      "name": "spatial_softmax",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/spatial_softmax.cu",
      "replaces": "tensor2robot_tpu/ops/spatial_softmax.py:50",
      "launches": launches,
      "max_abs_err": main_row["max_abs_err"],
      "ms": main_row["ms"],
      "plain_ms": main_row["plain_ms"],
      "bound_ms": main_row["bound_ms"],
      "bound_by": main_row["bound_by"],
      "library_ms": None,  # no single PyTorch call computes it
      "shape": main_row["shape"],
      "strides": main_row["strides"],
      "dtype": main_row["dtype"],
  }]}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
