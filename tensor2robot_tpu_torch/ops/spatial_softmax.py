"""Fused spatial-softmax expectation: CUDA kernel + its plain PyTorch version.

Counterpart of ``tensor2robot_tpu/ops/spatial_softmax.py``: the keypoint
pooling between a conv tower and a pose head. For each channel of a
(B, H, W, C) map, a softmax over the H×W grid followed by the expected
(x, y) coordinates on ``linspace(-1, 1)``; output (B, 2C), all x then all y.

``spatial_softmax`` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches one of two hand-written kernels
(``csrc/spatial_softmax.cu``) or raises. ``_kernel_for`` picks the kernel
by the map's strides: ``"channels"`` (a cluster of up to 8 blocks per
group of 64 channels) for a map whose channels are contiguous, as the
served tower's NHWC output, and ``"warp"`` (a warp per (b, c)) for
every other layout, as the NCHW view. Gradients differentiate the plain
version, as the JAX ``custom_jvp`` does: the kernels keep no attention
weights for the chain rule, and the JAX package has no backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tensor2robot_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 1 << 30  # H*W bound of the kernels' 32-bit grid index
_MAX_BLOCKS = (1 << 31) - 1  # the launch grid's bound
_WARPS_PER_BLOCK = 8  # the warp kernel's (b, c) rows a block
_CHANNEL_GROUP = 64  # the channel kernel's channels a block
_CHANNEL_SPLIT = 8  # the most blocks (a cluster) it splits a group over
_ENTRIES = {"warp": "t2r_spatial_softmax",
            "channels": "t2r_spatial_softmax_channels"}


def spatial_softmax_reference(features: torch.Tensor,
                              temperature: float = 1.0) -> torch.Tensor:
  """Plain PyTorch version: the same math through an (B, C, H·W) softmax."""
  b, h, w, c = features.shape
  logits = features.float().permute(0, 3, 1, 2).reshape(b, c, h * w)
  attention = torch.softmax(logits / temperature, dim=-1).reshape(b, c, h, w)
  xs = torch.linspace(-1.0, 1.0, w, device=features.device)
  ys = torch.linspace(-1.0, 1.0, h, device=features.device)
  expected_x = torch.sum(attention * xs, dim=(2, 3))
  expected_y = torch.sum(attention * ys[:, None], dim=(2, 3))
  return torch.cat([expected_x, expected_y], dim=-1).to(features.dtype)


def _kernel_for(shape, strides) -> str:
  """The kernel for a (B, H, W, C) map of these element strides.

  ``"channels"`` when the channels are contiguous (stride 1, C > 1): a
  warp then reads one pixel's channels in one coalesced access. Else
  ``"warp"``, whose lanes read a row's pixels, coalesced where stride_w
  is 1 (the NCHW view). Both are hand kernels; neither is a fallback.
  """
  return "channels" if strides[3] == 1 and shape[3] > 1 else "warp"


def _blocks(kernel: str, b: int, c: int) -> int:
  if kernel == "channels":
    return b * -(-c // _CHANNEL_GROUP) * _CHANNEL_SPLIT
  return -(-b * c // _WARPS_PER_BLOCK)


def _launch(features: torch.Tensor, temperature: float,
            kernel: Optional[str] = None) -> torch.Tensor:
  """Runs one kernel on the current stream, by default the one
  ``_kernel_for`` picks; raises if it fails."""
  kernel = kernel or _kernel_for(features.shape, features.stride())
  b, h, w, c = features.shape
  if h * w == 0 or h * w > _MAX_GRID or _blocks(kernel, b, c) > _MAX_BLOCKS:
    raise ValueError(
        f"spatial_softmax's {kernel} kernel takes 0 < H*W <= {_MAX_GRID} "
        f"and at most {_MAX_BLOCKS} blocks; got shape "
        f"{tuple(features.shape)}.")
  fn = getattr(_build.load_library("spatial_softmax"), _ENTRIES[kernel])
  if fn.argtypes is None:
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_int64] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
  out = torch.empty((b, 2 * c), dtype=features.dtype, device=features.device)
  with torch.cuda.device(features.device):
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = fn(features.data_ptr(), out.data_ptr(),
             _DTYPE_CODES[features.dtype], b, h, w, c, *features.stride(),
             1.0 / temperature, stream)
  if err != 0:
    raise RuntimeError(
        f"spatial_softmax {kernel} kernel launch failed with CUDA error "
        f"{err}.")
  spatial_softmax.launches += 1
  spatial_softmax.launches_by_kernel[kernel] += 1
  return out


class _SpatialSoftmaxFn(torch.autograd.Function):
  """Kernel forward; backward differentiates the plain version."""

  @staticmethod
  def forward(ctx, features, temperature):
    ctx.save_for_backward(features)
    ctx.temperature = temperature
    return _launch(features, temperature)

  @staticmethod
  def backward(ctx, grad_out):
    (features,) = ctx.saved_tensors
    # Grad mode is on here only under create_graph=True; the plain version
    # is then recorded against `features`, so higher orders derive from it.
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
      out = spatial_softmax_reference(features, ctx.temperature)
    (grad,) = torch.autograd.grad(out, features, grad_out,
                                  create_graph=create_graph)
    return grad, None


def spatial_softmax(features: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
  """Expected (x, y) image coordinates per channel ("feature points").

  Args:
    features: (B, H, W, C) activations, float32 or bfloat16, any strides.
    temperature: softmax temperature.

  Returns:
    (B, 2*C) in the input dtype: per-channel expected coordinates in
    [-1, 1], x block then y block. Sums are taken in float32.
  """
  if features.dim() != 4:
    raise ValueError(
        f"spatial_softmax takes (B, H, W, C); got shape "
        f"{tuple(features.shape)}.")
  if features.dtype not in _DTYPE_CODES:
    raise TypeError(
        f"spatial_softmax takes float32 or bfloat16; got {features.dtype}.")
  if features.device.type == "cpu":
    return spatial_softmax_reference(features, temperature)
  if features.device.type != "cuda":
    raise ValueError(
        f"spatial_softmax runs on 'cuda' or 'cpu'; got {features.device}.")
  temperature = float(temperature)
  if features.requires_grad and torch.is_grad_enabled():
    return _SpatialSoftmaxFn.apply(features, temperature)
  return _launch(features, temperature)


# Kernel launches, in all and by kernel; the plain version counts none.
spatial_softmax.launches = 0
spatial_softmax.launches_by_kernel = {"warp": 0, "channels": 0}
