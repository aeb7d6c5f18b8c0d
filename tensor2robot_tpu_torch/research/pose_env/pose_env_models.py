"""Pose-env models: tiny conv regression from camera image to 2D pose.

Counterpart of ``tensor2robot_tpu/research/pose_env/pose_env_models.py``:
conv tower (32, 48, 64 filters, strides 2, 2, 1) -> spatial softmax ->
FC 64 -> 2D pose, MSE to the target pose. At the published 64x64 input
the tower ends in a 16x16x64 map, the spatial softmax gives 128 values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.layers.vision_layers import (
    ImageFeaturesToPose,
    ImagesToFeatures,
)
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.preprocessors.image_preprocessors import (
    ImagePreprocessor,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import IMAGE_SIZE
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


class _PoseEnvModule(nn.Module):
  """Conv tower -> spatial softmax -> pose head."""

  def __init__(self, pose_dim: int = 2, norm: str = "batch",
               compute_dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.tower = ImagesToFeatures(
        in_channels=3, filters=(32, 48, 64), strides=(2, 2, 1), norm=norm,
        dtype=compute_dtype)
    self.head = ImageFeaturesToPose(
        in_channels=64, pose_dim=pose_dim, hidden_sizes=(64,),
        dtype=compute_dtype)

  def forward(self, features, mode: str):
    train = mode == modes.TRAIN
    feature_map = self.tower(features["image"], train=train)
    pose = self.head(feature_map, train=train)
    return ts.TensorSpecStruct({"inference_output": pose})


@configurable
class PoseEnvRegressionModel(RegressionModel):
  """Image -> 2D target pose (MSE)."""

  def __init__(self, image_size: int = IMAGE_SIZE,
               in_image_size: Optional[int] = None, distort: bool = False,
               norm: str = "batch", **kwargs):
    """Args:
      image_size: the model's input size.
      in_image_size: the collected images' size (crops to image_size);
        defaults to image_size.
      distort: photometric distortion in TRAIN mode.
      norm: 'batch' (reference parity) or 'group' (batch-independent).
      **kwargs: AbstractT2RModel's (optimizer_fn, compute_dtype, ...).
    """
    super().__init__(label_key="target_pose", **kwargs)
    self._image_size = image_size
    self._in_image_size = in_image_size or image_size
    self._distort = distort
    self._norm = norm

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct({
        "image": ts.ExtendedTensorSpec(
            (self._image_size, self._image_size, 3), np.float32,
            name="image"),
    })

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct({
        "target_pose": ts.ExtendedTensorSpec((2,), np.float32,
                                             name="target_pose"),
    })

  def create_preprocessor(self) -> ImagePreprocessor:
    """uint8 images at the collection size in, model-ready float out
    (TRAIN: random crop and, with `distort`, photometric jitter)."""
    return ImagePreprocessor(
        feature_spec=self.get_feature_specification(modes.TRAIN),
        label_spec=self.get_label_specification(modes.TRAIN),
        image_key="image",
        in_image_shape=(self._in_image_size, self._in_image_size, 3),
        data_format="jpeg",
        distort=self._distort,
    )

  def build_module(self) -> nn.Module:
    return _PoseEnvModule(norm=self._norm, compute_dtype=self.compute_dtype)

  def loss_fn(self, outputs, features, labels) -> Tuple[torch.Tensor, dict]:
    predictions = outputs["inference_output"]
    target = labels["target_pose"]
    loss = torch.mean(torch.square(predictions - target))
    metrics = {
        "mse": loss,
        "mean_pose_error": torch.mean(
            torch.linalg.norm(predictions - target, dim=-1)),
    }
    return loss, metrics
