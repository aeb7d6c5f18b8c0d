"""VRGripper behavior-cloning models.

Counterpart of ``tensor2robot_tpu/research/vrgripper/vrgripper_env_models.py``
(BASELINE config #5): a FiLM-conditioned ResNet-18 over camera images,
conditioned on proprioception; a regression (MSE) or MDN action head;
the meta-BC variant on ``MAMLModel``.

The JAX models declare a float32 image and no preprocessor, so their
record pipeline cannot parse the jpeg images ``episode_to_transitions``
writes (``ROADMAP.md`` Facts). The port's read them as pose_env's model
does: an ``ImagePreprocessor`` takes the jpeg-encoded uint8 image of a
record to the model's float32 [0, 1] image, with no crop and no
distortion. The model's specs, and so the served signature, are the JAX
ones.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.layers.resnet import ResNet
from tensor2robot_tpu_torch.layers.vision_layers import Dense
from tensor2robot_tpu_torch.models.abstract_model import Metrics
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.preprocessors.image_preprocessors import (
    ImagePreprocessor,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

IMAGE_SIZE = 100  # the reference's VRGripper camera crops are ~100px
ACTION_SIZE = 7   # cartesian twist (6) + gripper (1)
GRIPPER_POSE_SIZE = 14
CONTEXT_SIZE = 32  # the proprioception context that FiLM reads
HIDDEN_SIZE = 128


class _VRGripperModule(nn.Module):
  """FiLM ResNet-18 (width 32) conditioned on proprioception -> action
  head."""

  def __init__(self, gripper_pose_size: int, action_size: int = ACTION_SIZE,
               num_mixture_components: int = 0, film: bool = True,
               norm: str = "batch",
               compute_dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.action_size = action_size
    self.num_mixture_components = num_mixture_components
    self.film = film
    self.compute_dtype = compute_dtype
    self.context_fc = Dense(gripper_pose_size, CONTEXT_SIZE, compute_dtype)
    self.tower = ResNet(depth=18, width=32, film=film, norm=norm,
                        dtype=compute_dtype, context_size=CONTEXT_SIZE)
    self.fc1 = Dense(self.tower.features + gripper_pose_size, HIDDEN_SIZE,
                     torch.float32)
    if num_mixture_components:
      self.mdn = mdn.mixture_projection(HIDDEN_SIZE, num_mixture_components,
                                        action_size)
    else:
      self.action = Dense(HIDDEN_SIZE, action_size, torch.float32)

  def forward(self, features, mode: str):
    train = mode == modes.TRAIN
    pose = features["gripper_pose"]
    context = torch.relu(self.context_fc(pose.to(self.compute_dtype)))
    image_features = self.tower(features["image"],
                                context=context if self.film else None,
                                train=train)
    x = torch.cat([image_features.float(), pose.float()], dim=-1)
    x = torch.relu(self.fc1(x))
    if self.num_mixture_components:
      params = mdn.predict_mixture_params(
          x, self.num_mixture_components, self.action_size, self.mdn)
      return ts.TensorSpecStruct({
          "mdn_log_alphas": params.log_alphas,
          "mdn_mus": params.mus,
          "mdn_log_sigmas": params.log_sigmas,
          "inference_output": mdn.gaussian_mixture_approximate_mode(
              params),
      })
    return ts.TensorSpecStruct({"inference_output": self.action(x)})


def _vrgripper_specs(image_size: int, gripper_pose_size: int,
                     action_size: int):
  features = ts.TensorSpecStruct({
      "image": ts.ExtendedTensorSpec(
          (image_size, image_size, 3), np.float32, name="image"),
      "gripper_pose": ts.ExtendedTensorSpec(
          (gripper_pose_size,), np.float32, name="gripper_pose"),
  })
  labels = ts.TensorSpecStruct({
      "action": ts.ExtendedTensorSpec((action_size,), np.float32,
                                      name="action"),
  })
  return features, labels


@configurable
class VRGripperRegressionModel(RegressionModel):
  """Deterministic BC: (image, proprio) -> action, MSE."""

  def __init__(self, image_size: int = IMAGE_SIZE,
               action_size: int = ACTION_SIZE,
               gripper_pose_size: int = GRIPPER_POSE_SIZE,
               film: bool = True, norm: str = "batch", **kwargs):
    """norm: 'batch' (the reference) or 'group' (batch-independent;
    required under MAMLModel, whose inner loop never collects BatchNorm
    statistics)."""
    super().__init__(label_key="action", **kwargs)
    self._image_size = image_size
    self._action_size = action_size
    self._gripper_pose_size = gripper_pose_size
    self._film = film
    self._norm = norm

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return _vrgripper_specs(self._image_size, self._gripper_pose_size,
                            self._action_size)[0]

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return _vrgripper_specs(self._image_size, self._gripper_pose_size,
                            self._action_size)[1]

  def create_preprocessor(self) -> ImagePreprocessor:
    """jpeg-encoded uint8 images in (as records hold them), the model's
    float32 [0, 1] image out; no crop, no distortion."""
    return ImagePreprocessor(
        feature_spec=self.get_feature_specification(modes.TRAIN),
        label_spec=self.get_label_specification(modes.TRAIN),
        image_key="image", data_format="jpeg", distort=False)

  def _num_mixture_components(self) -> int:
    return 0

  def build_module(self) -> nn.Module:
    return _VRGripperModule(
        gripper_pose_size=self._gripper_pose_size,
        action_size=self._action_size,
        num_mixture_components=self._num_mixture_components(),
        film=self._film, norm=self._norm, compute_dtype=self.compute_dtype)


@configurable
class VRGripperEnvModel(VRGripperRegressionModel):
  """Multimodal BC: an MDN action head trained by NLL; PREDICT serves the
  mixture's approximate mode."""

  def __init__(self, num_mixture_components: int = 5, **kwargs):
    super().__init__(**kwargs)
    self._mixture_components = num_mixture_components

  def _num_mixture_components(self) -> int:
    return self._mixture_components

  def loss_fn(self, outputs, features, labels
              ) -> Tuple[torch.Tensor, Metrics]:
    if labels is None:
      raise ValueError("VRGripperEnvModel.loss_fn requires labels")
    params = mdn.MixtureParams(
        log_alphas=outputs["mdn_log_alphas"], mus=outputs["mdn_mus"],
        log_sigmas=outputs["mdn_log_sigmas"])
    target = labels["action"].float()
    nll = mdn.negative_log_likelihood(params, target)
    mode_error = torch.mean(torch.linalg.norm(
        outputs["inference_output"] - target, dim=-1))
    return nll, {"nll": nll, "mode_action_error": mode_error}


def vrgripper_maml_model(num_inner_steps: int = 1, inner_lr: float = 0.01,
                         num_condition_samples: int = 4,
                         num_inference_samples: int = 4, **base_kwargs):
  """Meta-BC: MAML over the regression model. The base computes in
  float32 (MAML's inner gradients are unstable in bfloat16) with
  GroupNorm (the inner loop never collects BatchNorm statistics), unless
  `base_kwargs` say otherwise; as in JAX, `base_kwargs` (``optimizer_fn``
  among them) go to the base."""
  from tensor2robot_tpu_torch.meta_learning import MAMLModel
  base_kwargs.setdefault("compute_dtype", torch.float32)
  base_kwargs.setdefault("norm", "group")
  return MAMLModel(
      VRGripperRegressionModel(**base_kwargs),
      num_inner_steps=num_inner_steps, inner_lr=inner_lr,
      num_condition_samples=num_condition_samples,
      num_inference_samples=num_inference_samples)
