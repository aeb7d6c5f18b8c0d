#!/usr/bin/env python3
"""Drives the PyTorch port's main paths on one CUDA GPU and checks them.

    python3 chip_smoke.py

Run from the repository root, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. It builds every kernel from ``csrc/`` and holds each
against its plain PyTorch version: K1 (spatial softmax) and K2-K4 (flash
attention forward, dq, dk+dv). Then it drives both slices:

- slice 1 serves the pose_env regression model (BASELINE config #1 at its
  published width: 64x64 RGB, convs 3->32->48->64, a 16x16x64 map,
  spatial softmax to 128, then 64, then 2) from a native export directory
  through ``ExportedModelPredictor`` and ``evaluate_policy``, and holds
  the GPU's outputs against the same weights served on the CPU;
- slice 2 trains a SNAIL stack at the flash path's widths (8 episodes of
  2048 steps, 64 features; attention with key size 64, a TCBlock of 11
  dense blocks of 32 filters, attention, a dense head) for 20 Adam steps
  with the flash core, and holds its loss stream against the same 20
  steps with the dense core.

Each path runs with the launch counts set to 0 just before it and checks
them just after. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Weights and data are random, drawn from ``--seed``.
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
# 2048 terms. bfloat16 outputs: both sides sum in float32 and round once,
# so they may sit one bf16 ulp (2^-8 of the value) apart. lse is float32
# in both dtypes.
FLASH_F32_TOL = dict(atol=1e-4, rtol=1e-4)
FLASH_BF16_TOL = dict(atol=1e-2, rtol=2 ** -7)
FLASH_LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# Flash-core vs dense-core loss streams: the dense core rounds its logits
# and its softmax weights to bfloat16 (the flash kernels keep float32), so
# each step's loss may differ by bf16 noise averaged over 16384 outputs.
LOSS_RTOL = 1e-2


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


def attention_inputs(torch, dev, shape, dtype, layout, seed: int):
  """q, k, v (0.5 x normal, as tests/test_ops.py) and dout (normal).

  layout "strided": (B, T, 1, D) views into one (B, T, 4D) tensor, so the
  time stride is 4D and no input is contiguous."""
  b, t, h, d = shape
  rng = np.random.default_rng(seed)
  if layout == "strided":
    wide = rng.standard_normal((b, t, 4 * d)).astype(np.float32)
    wide[..., :3 * d] *= 0.5
    wide = torch.from_numpy(wide).to(dev, dtype)
    return [wide[:, :, None, i * d:(i + 1) * d] for i in range(4)]
  arrays = [rng.standard_normal(shape).astype(np.float32) * s
            for s in (0.5, 0.5, 0.5, 1.0)]
  return [torch.from_numpy(a).to(dev, dtype) for a in arrays]


def flash_errors(torch, fa, q, k, v, dout, causal: bool, tol) -> dict:
  """Each kernel against its plain version on the same inputs; raises past
  the tolerance. Returns max |got - want| by output."""
  scale = 1.0 / np.sqrt(q.shape[-1])
  out, lse = fa.flash_forward(q, k, v, causal, scale)
  delta = fa.flash_delta(out, dout)
  dq = fa.flash_dq(q, k, v, dout, lse, delta, causal, scale)
  dk, dv = fa.flash_dkv(q, k, v, dout, lse, delta, causal, scale)
  torch.cuda.synchronize()
  want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, scale)
  want_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, causal, scale)
  want_dk, want_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta,
                                            causal, scale)
  errors = {}
  for name, got, want, limits in (
      ("out", out, want_out, tol), ("lse", lse, want_lse, FLASH_LSE_TOL),
      ("dq", dq, want_dq, tol), ("dk", dk, want_dk, tol),
      ("dv", dv, want_dv, tol)):
    if got.dtype != want.dtype or got.shape != want.shape:
      raise AssertionError(f"flash {name}: got {got.dtype} "
                           f"{tuple(got.shape)}, want {want.dtype} "
                           f"{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    bound = limits["atol"] + limits["rtol"] * want.float().abs()
    errors[name] = float(diff.max())
    if not bool((diff <= bound).all()):
      raise AssertionError(
          f"flash {name} disagrees with its plain version: max err "
          f"{errors[name]}, shape {tuple(q.shape)}, {q.dtype}, causal "
          f"{causal}, tolerance {limits}")
  return errors


def check_flash_attention(torch, fa, dev, seed: int) -> list:
  """Holds K2, K3 and K4 against their plain versions on every listed
  case, in float32 (TF32 off) and bfloat16; then the autograd function
  against autograd of the plain reference, and its first-order rule."""
  path = (SNAIL_BATCH, SNAIL_SEQ, 1, SNAIL_KEY)
  cases = [(path, "contiguous"), (path, "strided"),
           ((2, 2048, 4, 64), "contiguous"), ((2, 300, 1, 32), "strided")]
  cases += [((2, t, 2, 64), "contiguous") for t in (1, 40, 128, 256, 1030)]
  cases += [((2, 256, 2, d), "contiguous") for d in (8, 16, 128)]
  results = []
  for shape, layout in cases:
    for dtype, tol in ((torch.float32, FLASH_F32_TOL),
                       (torch.bfloat16, FLASH_BF16_TOL)):
      for causal in (False, True):
        q, k, v, dout = attention_inputs(torch, dev, shape, dtype, layout,
                                         seed)
        errors = flash_errors(torch, fa, q, k, v, dout, causal, tol)
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
    if fa.flash_attention.launches != {n: c + 1 for n, c in before.items()}:
      raise AssertionError("flash_attention's gradient did not launch K2, "
                           "K3 and K4 once each")
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
  return results


def time_flash_attention(torch, fa, dev, seed: int) -> dict:
  """K2, K3 and K4 at the path's shape (bf16, causal) beside their plain
  versions, their bounds, and PyTorch's SDPA as a yardstick."""
  b, t, h, d = SNAIL_BATCH, SNAIL_SEQ, 1, SNAIL_KEY
  q, k, v, dout = attention_inputs(torch, dev, (b, t, h, d), torch.bfloat16,
                                   "contiguous", seed)
  scale = 1.0 / np.sqrt(d)
  errors = flash_errors(torch, fa, q, k, v, dout, True, FLASH_BF16_TOL)
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
  rows = {
      "forward": {
          "ms": device_ms(torch, lambda: fa.flash_forward(q, k, v, True,
                                                          scale), inner=20),
          "plain_ms": device_ms(torch, lambda: fa.flash_forward_reference(
              q, k, v, True, scale), inner=20),
          "library_ms": sdpa_ms,
          "max_abs_err": max(errors["out"], errors["lse"]),
          **bound(2, 4, 1)},
      "dq": {
          "ms": device_ms(torch, lambda: fa.flash_dq(*args), inner=20),
          "plain_ms": device_ms(
              torch, lambda: fa.flash_dq_reference(*args), inner=20),
          "library_ms": sdpa_both_ms - sdpa_ms,
          "max_abs_err": errors["dq"],
          **bound(3, 5, 2)},
      "dkv": {
          "ms": device_ms(torch, lambda: fa.flash_dkv(*args), inner=20),
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
  (K2 twice a step forward, K3 and K4 twice a step backward), then the
  same 20 steps from the same weights with the dense core."""
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
  want = 2 * TRAIN_STEPS
  if launches != {"forward": want, "dq": want, "dkv": want}:
    raise AssertionError(f"flash kernels launched {launches} times in "
                         f"{TRAIN_STEPS} steps; want {want} each")
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
  fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")
  torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32
  emit("kernel_checks", flash_attention=check_flash_attention(
      torch, fa, dev, args.seed))

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

  # Slice 2's main path: train the SNAIL stack through K2, K3 and K4.
  snail = run_snail_slice(torch, fa, dev, args.seed)
  emit("snail_slice", **snail)

  timing = time_spatial_softmax(torch, ss, feature_map)
  emit("kernel_timing", spatial_softmax=timing)
  flash_timing = time_flash_attention(torch, fa, dev, args.seed + 3)
  emit("kernel_timing", flash_attention=flash_timing)
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
  }] + [{
      "name": f"flash_attention_{name}",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/flash_attention.cu",
      "replaces": f"tensor2robot_tpu/ops/flash_attention.py:{line}",
      "launches": snail["launches"][name],
      **flash_timing[name],
      # SDPA's backward computes dq, dk and dv in one call: the pair
      # dq + dkv compares with it.
      **({"library_covers": "dq, dk and dv (K3 + K4)"}
         if name != "forward" else {}),
  } for name, line in (("forward", 69), ("dq", 181), ("dkv", 216))]}),
        flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
