"""QT-Opt grasping Q-function: the legacy grasping net.

Counterpart of ``tensor2robot_tpu/research/qtopt/t2r_models.py``: a conv
tower over the camera image; the action (and an optional state vector)
embedded by two dense layers and added to the tower's map mid-way; three
stride-2 convs; a global mean; a dense layer and a float32 Q head giving
the logit of grasp success. Every option of the JAX model is here, with
its parameter names, so the weight bridge maps one tree onto the other:

- ``norm``: "batch" (flax BatchNorm: momentum 0.99, eps 1e-5) or "group"
  (GroupNorm of 8 groups, flax's eps 1e-6), named ``stem_bn``,
  ``pre_bn{i}``, ``post_bn{i}``;
- ``stem``: "conv" (64 6x6 filters at stride 4, SAME) or
  "space_to_depth" (``ops/stem_conv.folded_s2d_stem`` over the folded
  ``stem_s2d_kernel`` (8, 2, 4C, 64) and ``stem_s2d_bias``);
- ``impl``: "parity" (max pool, strided convs) or "fast" (the same
  function through ``ops/pool.max_pool_reshape`` and
  ``ops/strided_conv.FoldedStridedConv3x3``, the same parameters).

Activations run in ``compute_dtype`` (bfloat16 by default) on the
(B, C, H, W) view of the NHWC image; SAME padding puts the odd pixel at the
high end, as XLA does (``vision_layers.same_padding``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.layers.vision_layers import (
    BatchNorm,
    Conv,
    Dense,
    normalize_image,
)
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.ops import stem_conv
from tensor2robot_tpu_torch.ops.pool import max_pool_reshape
from tensor2robot_tpu_torch.ops.strided_conv import FoldedStridedConv3x3
from tensor2robot_tpu_torch.preprocessors.image_preprocessors import (
    ImagePreprocessor,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

IMAGE_SIZE = 472
ACTION_SIZE = 4  # cartesian displacement (3) + gripper command (1)
WIDTH = 64
_GROUPS = 8  # t2r_models.py's nn.GroupNorm(num_groups=8)
_GROUP_NORM_EPSILON = 1e-6  # flax's default


class _GroupNorm(nn.GroupNorm):
  """flax ``nn.GroupNorm(num_groups=8)``: float32 statistics, the compute
  dtype out."""

  def __init__(self, channels: int, dtype: torch.dtype):
    super().__init__(_GROUPS, channels, eps=_GROUP_NORM_EPSILON)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    del train  # no batch statistics
    return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                        self.bias.float(), self.eps).to(self.compute_dtype)


class _GraspingQModule(nn.Module):
  """The legacy grasping net as one module."""

  def __init__(self, action_size: int = ACTION_SIZE, state_size: int = 0,
               compute_dtype: torch.dtype = torch.bfloat16,
               norm_kind: str = "batch", stem_kind: str = "conv",
               impl: str = "parity"):
    super().__init__()
    if norm_kind == "batch":
      norm = lambda: BatchNorm(WIDTH, compute_dtype)
    elif norm_kind == "group":
      norm = lambda: _GroupNorm(WIDTH, compute_dtype)
    else:
      raise ValueError(f"Unknown norm_kind {norm_kind!r}")
    self.action_size = action_size
    self.compute_dtype = compute_dtype
    self.stem_kind = stem_kind
    self.impl = impl
    if stem_kind == "conv":
      self.stem = Conv(3, WIDTH, 6, 4, compute_dtype)
    elif stem_kind == "space_to_depth":
      self.stem_s2d_kernel = nn.Parameter(
          stem_conv.init_folded_stem_weights(3, WIDTH))
      self.stem_s2d_bias = nn.Parameter(torch.zeros(WIDTH))
    else:
      raise ValueError(f"Unknown stem_kind {stem_kind!r}")
    self.stem_bn = norm()
    for i in range(3):
      self.add_module(f"pre_conv{i}", Conv(WIDTH, WIDTH, 3, 1, compute_dtype))
      self.add_module(f"pre_bn{i}", norm())
    self.action_fc1 = Dense(action_size + state_size, WIDTH, compute_dtype)
    self.action_fc2 = Dense(WIDTH, WIDTH, compute_dtype)
    for i in range(3):
      conv = (FoldedStridedConv3x3(WIDTH, WIDTH, compute_dtype)
              if impl == "fast" else Conv(WIDTH, WIDTH, 3, 2, compute_dtype))
      self.add_module(f"post_conv{i}", conv)
      self.add_module(f"post_bn{i}", norm())
    self.fc1 = Dense(WIDTH, WIDTH, compute_dtype)
    self.q_head = Dense(WIDTH, 1, torch.float32)

  def flax_init_(self, generator: Optional[torch.Generator]) -> None:
    """Draws the folded stem kernel as the JAX op's initialiser does."""
    if self.stem_kind == "space_to_depth":
      with torch.no_grad():
        self.stem_s2d_kernel.copy_(stem_conv.init_folded_stem_weights(
            3, WIDTH, generator))

  def forward(self, features, mode: str):
    train = mode == modes.TRAIN
    dtype = self.compute_dtype
    image = normalize_image(features["image"], dtype)  # (B, H, W, C)
    # Stem: 472 -> 118 -> 59.
    if self.stem_kind == "conv":
      x = self.stem(image.permute(0, 3, 1, 2))
    else:
      x = (stem_conv.folded_s2d_stem(image, self.stem_s2d_kernel.to(dtype))
           + self.stem_s2d_bias.to(dtype)).permute(0, 3, 1, 2)
    x = torch.relu(self.stem_bn(x, train))
    if self.impl == "fast" and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
      x = max_pool_reshape(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    else:
      x = F.max_pool2d(x, 2, 2)
    for i in range(3):
      x = getattr(self, f"pre_conv{i}")(x)
      x = torch.relu(getattr(self, f"pre_bn{i}")(x, train))

    # Action (and optional state vector) merge.
    action = features["action"].to(dtype)
    if action.shape[-1] != self.action_size:
      raise ValueError(f"Expected action dim {self.action_size}, got "
                       f"{action.shape[-1]}.")
    merge = [action]
    if "state" in features:
      merge.append(features["state"].to(dtype))
    embedding = torch.relu(self.action_fc1(torch.cat(merge, dim=-1)))
    embedding = self.action_fc2(embedding)
    x = torch.relu(x + embedding[:, :, None, None])

    # Post-merge tower: 59 -> 30 -> 15 -> 8 (SAME, stride 2).
    for i in range(3):
      x = getattr(self, f"post_conv{i}")(x)
      x = torch.relu(getattr(self, f"post_bn{i}")(x, train))
    x = x.mean(dim=(2, 3))  # global pool -> (B, 64)
    x = torch.relu(self.fc1(x))
    q_logit = self.q_head(x)[:, 0]  # float32 head
    return ts.TensorSpecStruct({"q_predicted": q_logit})


@configurable
class QTOptGraspingModel(CriticModel):
  """(image, action) -> grasp-success Q, cross-entropy vs Bellman target."""

  # The flagship's benchmark batch (the JAX bench.py's per-chip batch).
  benchmark_batch_size = 32

  def __init__(self, image_size: int = IMAGE_SIZE,
               in_image_size: Optional[int] = None,
               action_size: int = ACTION_SIZE,
               state_size: int = 0,
               distort: bool = False,
               uint8_images: bool = False,
               norm: str = "batch",
               stem: str = "conv",
               wire_format: str = "jpeg",
               impl: str = "parity",
               **kwargs):
    """Args (the JAX model's):
      image_size: the model's input size; in_image_size the records'
        (cropped to image_size), by default the same.
      state_size: > 0 adds a proprioceptive ``state`` vector feature.
      distort: photometric distortion in TRAIN mode.
      uint8_images: the image stays uint8 up to the device (the cast and
        the 1/255 run there); the serving signature takes uint8.
      norm: "batch" or "group"; stem: "conv" or "space_to_depth"; impl:
        "parity" or "fast" (see the module docstring).
      wire_format: how records carry the image, "jpeg" or "raw".
      **kwargs: CriticModel's and AbstractT2RModel's.
    """
    super().__init__(**kwargs)
    if wire_format not in ("jpeg", "raw"):
      raise ValueError(f"wire_format must be 'jpeg' or 'raw', got "
                       f"{wire_format!r}")
    if impl not in ("parity", "fast"):
      raise ValueError(f"impl must be 'parity' or 'fast', got {impl!r}")
    self._image_size = image_size
    self._in_image_size = in_image_size or image_size
    self._action_size = action_size
    self._state_size = state_size
    self._distort = distort
    self._image_dtype = np.uint8 if uint8_images else np.float32
    self._norm = norm
    self._stem = stem
    self._wire_format = wire_format
    self._impl = impl

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    spec = ts.TensorSpecStruct({
        "image": ts.ExtendedTensorSpec(
            (self._image_size, self._image_size, 3), self._image_dtype,
            name="image"),
        "action": ts.ExtendedTensorSpec(
            (self._action_size,), np.float32, name="action"),
    })
    if self._state_size:
      spec["state"] = ts.ExtendedTensorSpec(
          (self._state_size,), np.float32, name="state")
    return spec

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct({
        self.target_key: ts.ExtendedTensorSpec(
            (), np.float32, name=self.target_key),
    })

  def create_preprocessor(self) -> ImagePreprocessor:
    return ImagePreprocessor(
        feature_spec=self.get_feature_specification(modes.TRAIN),
        label_spec=self.get_label_specification(modes.TRAIN),
        image_key="image",
        in_image_shape=(self._in_image_size, self._in_image_size, 3),
        data_format=None if self._wire_format == "raw" else "jpeg",
        distort=self._distort,
    )

  def build_module(self) -> nn.Module:
    return _GraspingQModule(
        action_size=self._action_size, state_size=self._state_size,
        compute_dtype=self.compute_dtype, norm_kind=self._norm,
        stem_kind=self._stem, impl=self._impl)

  def partition_rules(self, axis: str = "model"):
    """Regex partition rules -> PartitionSpecs for tensor parallelism (the
    JAX model's table, over the same flax names).

    The tower is column-parallel on its 64 channels: every conv and dense
    kernel splits its output features over `axis`, and the per-channel
    vectors riding those outputs (biases, norm scale and bias) split the
    same way. The float32 ``q_head`` (64 -> 1) stays replicated. First hit
    wins (``parallel.tp_rules.match_partition_rules``); the catch-all keeps
    anything else replicated.
    """
    from tensor2robot_tpu_torch.parallel.mesh import PartitionSpec as P
    return (
        (r"(stem|pre_conv\d|post_conv\d)/kernel", P(None, None, None, axis)),
        (r"stem_s2d_kernel", P(None, None, None, axis)),
        (r"(action_fc\d|fc1)/kernel", P(None, axis)),
        (r"(stem|pre_conv\d|post_conv\d|action_fc\d|fc1)/bias", P(axis)),
        (r"stem_s2d_bias", P(axis)),
        (r"(stem_bn|pre_bn\d|post_bn\d)/(scale|bias)", P(axis)),
        (r".*", P()),
    )
