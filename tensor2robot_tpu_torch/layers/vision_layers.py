"""Vision layers: conv towers + spatial softmax for robot cameras.

Counterpart of ``tensor2robot_tpu/layers/vision_layers.py``. The public
layout stays the JAX package's: images and feature maps are (B, H, W, C).
Inside, convolutions run on the (B, C, H, W) view of the same memory, so
no layout copy is made either way.

Numerics follow flax: parameters stay in float32; ``Conv`` and ``Dense``
cast their input, kernel and bias to the compute dtype; normalisation
computes in float32 (float64 for a float64 input, as flax promotes), with
the parameters and statistics promoted where a scoring tier hands them
over in bfloat16, and returns the compute dtype; convolutions pad as
XLA's "SAME" does, with the odd pixel at the high end.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.ops.spatial_softmax import (
    spatial_softmax as fused_spatial_softmax,
)

# flax's defaults: BatchNorm epsilon 1e-5 and momentum 0.99 (the running
# averages keep 0.99 of themselves: torch's momentum=0.01); GroupNorm
# epsilon 1e-6, where torch's GroupNorm default is 1e-5.
_BATCH_NORM_EPSILON = 1e-5
_BATCH_NORM_MOMENTUM = 0.99
_GROUP_NORM_EPSILON = 1e-6


def same_padding(size: Sequence[int], kernel: int,
                 stride: int) -> Tuple[int, int, int, int]:
  """XLA "SAME" padding of an (H, W) input, in ``F.pad`` order.

  The total pad is split with ``lo = total // 2``, so a stride-2 3x3 conv on
  an even size pads (0, 1): torch's symmetric ``padding=1`` would shift
  every output by one pixel.
  """
  pads = []
  for n in reversed(tuple(size)):  # F.pad lists the last dim first
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    pads += [total // 2, total - total // 2]
  return tuple(pads)


class Conv(nn.Conv2d):
  """flax ``nn.Conv`` with "SAME" padding, on (B, C, H, W) activations."""

  def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
               stride: int = 1, dtype: torch.dtype = torch.bfloat16,
               bias: bool = True):
    super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                     padding=0, bias=bias)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.compute_dtype
    x = F.pad(x.to(dtype),
              same_padding(x.shape[-2:], self.kernel_size[0], self.stride[0]))
    bias = None if self.bias is None else self.bias.to(dtype)
    return F.conv2d(x, self.weight.to(dtype), bias, self.stride)


class Dense(nn.Linear):
  """flax ``nn.Dense``: input, kernel and bias cast to the compute dtype."""

  def __init__(self, in_features: int, out_features: int,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__(in_features, out_features)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.compute_dtype
    return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


_STATE = threading.local()


def _norm_dtype(x: torch.Tensor) -> torch.dtype:
  """Normalisation's dtype: at least float32."""
  return torch.promote_types(x.dtype, torch.float32)


@contextlib.contextmanager
def synced_statistics(average: Callable[[torch.Tensor], torch.Tensor]):
  """Within this context (on this thread), training-mode ``BatchNorm``
  takes the moments of the global batch: `average` maps a rank's moments
  to the mean over the data axis's ranks, differentiably
  (``parallel.collectives.mean``), as XLA reduces them over a sharded
  batch. The trainer enters it under a data mesh of more than one rank."""
  previous = getattr(_STATE, "average", None)
  _STATE.average = average
  try:
    yield
  finally:
    _STATE.average = previous


@contextlib.contextmanager
def frozen_statistics():
  """Within this context (on this thread), training-mode ``BatchNorm``
  normalises with the batch's statistics but leaves its running averages
  unmoved."""
  previous = getattr(_STATE, "frozen", False)
  _STATE.frozen = True
  try:
    yield
  finally:
    _STATE.frozen = previous


class BatchNorm(nn.Module):
  """flax ``nn.BatchNorm`` on (B, C, H, W) or (B, C), statistics in float32.

  Evaluation normalises with the running averages. Training normalises
  with the batch's mean and biased variance over every axis but C, and
  moves the running averages in place to 0.99 old + 0.01 batch, the
  variance the biased one, as flax does (torch's own update keeps 0.9 and
  the unbiased variance). The model hands training copies of its running
  averages, so the caller's variables never change. Inside
  ``frozen_statistics()`` training leaves them as they are: a
  rematerialized block's forward runs again in the backward pass, and
  flax moves the averages once.
  """

  def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))
    self.register_buffer("running_mean", torch.zeros(channels))
    self.register_buffer("running_var", torch.ones(channels))
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    x = x.to(_norm_dtype(x))
    average = getattr(_STATE, "average", None)
    if train and average is not None:
      return self._synced(x, average)
    if train:
      if x.device.type == "cpu":
        # PyTorch's CPU batch norm sums a channels-last input's statistics
        # one pixel after another in float32: 50x the error of its
        # contiguous path, enough to move this model's gradients by a
        # tenth of their largest (tests/test_torch_train.py).
        x = x.contiguous()
      if not getattr(_STATE, "frozen", False):
        with torch.no_grad():
          var, mean = torch.var_mean(
              x, dim=(0,) + tuple(range(2, x.dim())), correction=0)
          for running, batch in ((self.running_mean, mean),
                                 (self.running_var, var)):
            running.mul_(_BATCH_NORM_MOMENTUM).add_(
                batch, alpha=1.0 - _BATCH_NORM_MOMENTUM)
    # Parameters and statistics a scoring tier hands over in bfloat16
    # normalise in float32 too (a no-op on float32 tensors).
    return F.batch_norm(
        x, None if train else self.running_mean.to(x.dtype),
        None if train else self.running_var.to(x.dtype),
        self.weight.to(x.dtype), self.bias.to(x.dtype), training=train,
        eps=_BATCH_NORM_EPSILON,
    ).to(self.compute_dtype)

  def _synced(self, x: torch.Tensor, average) -> torch.Tensor:
    """Training over a sharded batch: the mean, then the biased variance
    about it, each averaged over the ranks (every rank holds the same
    number of rows), so every rank normalises with the global batch's
    moments and moves its running averages alike."""
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = average(x.mean(dim=dims))
    centered = x - mean.view(shape)
    var = average(centered.square().mean(dim=dims))
    if not getattr(_STATE, "frozen", False):
      with torch.no_grad():
        for running, batch in ((self.running_mean, mean),
                               (self.running_var, var)):
          running.mul_(_BATCH_NORM_MOMENTUM).add_(
              batch, alpha=1.0 - _BATCH_NORM_MOMENTUM)
    scale = torch.rsqrt(var + _BATCH_NORM_EPSILON) * self.weight.to(x.dtype)
    return (centered * scale.view(shape)
            + self.bias.to(x.dtype).view(shape)).to(self.compute_dtype)


class GroupNormAuto(nn.Module):
  """GroupNorm with num_groups = gcd(32, channels).

  The child's name mirrors flax's auto-named ``GroupNorm_0``, so the
  weight bridge maps both trees path for path.
  """

  def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.GroupNorm_0 = nn.GroupNorm(
        math.gcd(32, channels), channels, eps=_GROUP_NORM_EPSILON)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    norm = self.GroupNorm_0
    x = x.to(_norm_dtype(x))
    return F.group_norm(x, norm.num_groups, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps).to(self.compute_dtype)


def make_norm(kind: str, dtype: torch.dtype) -> Callable[[int], nn.Module]:
  """Returns channels -> norm layer for `kind` in {'batch', 'group', 'none'}.

  'batch' is the reference's choice; 'group' is batch-independent; 'none'
  disables normalisation.
  """
  if kind == "batch":
    return lambda channels: BatchNorm(channels, dtype)
  if kind == "group":
    return lambda channels: GroupNormAuto(channels, dtype)
  if kind == "none":
    return lambda channels: nn.Identity()
  raise ValueError(
      f"Unknown norm kind {kind!r}; have 'batch', 'group', 'none'.")


def normalize_image(image: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """Camera image -> model-ready [0, 1] activations in `dtype`.

  Accepts already-scaled float images or raw uint8 ones.
  """
  if not image.is_floating_point():
    return image.to(dtype) * (1.0 / 255.0)
  return image.to(dtype)


def spatial_softmax(features: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
  """(B, H, W, C) -> (B, 2C) expected coordinates, x then y (ops kernel)."""
  return fused_spatial_softmax(features, temperature)


class ImagesToFeatures(nn.Module):
  """Conv tower: camera image -> spatial feature map.

  A VGG-ish stack of 3x3 convs with stride-2 downsamples, norm and relu.
  Images and the returned map are (B, H, W, C); the map is a view of the
  last conv's (B, C, H, W) output.
  """

  def __init__(self, in_channels: int = 3,
               filters: Sequence[int] = (32, 64, 64, 128),
               strides: Sequence[int] = (2, 2, 2, 1), norm: str = "batch",
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    if len(filters) != len(strides):
      raise ValueError(
          f"filters ({len(filters)}) and strides ({len(strides)}) must have "
          "equal length.")
    self.norm = norm
    self.compute_dtype = dtype
    self.num_layers = len(filters)
    make = make_norm(norm, dtype)
    for i, (width, stride) in enumerate(zip(filters, strides)):
      self.add_module(f"conv{i}", Conv(in_channels, width, 3, stride, dtype))
      self.add_module(f"bn{i}", make(width))
      in_channels = width

  def forward(self, images: torch.Tensor, train: bool = False):
    x = normalize_image(images, self.compute_dtype).permute(0, 3, 1, 2)
    for i in range(self.num_layers):
      x = getattr(self, f"conv{i}")(x)
      norm = getattr(self, f"bn{i}")
      x = norm(x, train) if isinstance(norm, BatchNorm) else norm(x)
      x = torch.relu(x)
    return x.permute(0, 2, 3, 1)


class ImageFeaturesToPose(nn.Module):
  """Spatial-softmax keypoints -> MLP -> pose vector (head in float32)."""

  def __init__(self, in_channels: int, pose_dim: int = 2,
               hidden_sizes: Sequence[int] = (64, 64),
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.num_hidden = len(hidden_sizes)
    width_in = 2 * in_channels
    for i, width in enumerate(hidden_sizes):
      self.add_module(f"fc{i}", Dense(width_in, width, dtype))
      width_in = width
    # Head in float32: small, and keeps regression targets full-precision.
    self.pose = Dense(width_in, pose_dim, torch.float32)

  def forward(self, feature_map: torch.Tensor, train: bool = False):
    del train  # no train/eval asymmetry in the head
    x = spatial_softmax(feature_map)
    for i in range(self.num_hidden):
      x = torch.relu(getattr(self, f"fc{i}")(x))
    return self.pose(x)
