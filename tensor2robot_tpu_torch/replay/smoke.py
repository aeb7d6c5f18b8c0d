"""TinyQCriticModel: the CPU-scale critic of the replay tier's smoke lane.

Counterpart of ``tensor2robot_tpu/replay/smoke.py`` (the model half; the
smoke loop comes with the replay tier). The same (image, action) ->
``q_predicted`` contract as the flagship critic, sized to converge in a
few hundred CPU steps: flatten -> position code, an action embedding, a
joint MLP head. Its layers keep the flax module's names, so the weight
bridge maps one onto the other, and ``encode`` / ``q_from_code`` split it
for ``CriticModel.factored_cem_fns``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

SMOKE_IMAGE_SIZE = 16
SMOKE_ACTION_SIZE = 4


class _Dense(nn.Linear):
  """flax ``nn.Dense`` with no forced dtype: input and parameters promote
  to a common dtype, as flax promotes them."""

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(x.dtype, self.weight.dtype)
    return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class _TinyQModule(nn.Module):
  """Flatten image -> position code; action embedding; joint MLP -> q."""

  def __init__(self, image_size: int = SMOKE_IMAGE_SIZE,
               action_size: int = SMOKE_ACTION_SIZE):
    super().__init__()
    self.img_fc1 = _Dense(image_size * image_size * 3, 64)
    self.img_code = _Dense(64, 32)
    self.act_fc1 = _Dense(action_size, 32)
    self.joint_fc1 = _Dense(64, 64)
    self.joint_fc2 = _Dense(64, 32)
    self.q_head = _Dense(32, 1)

  def encode(self, features) -> torch.Tensor:
    """(B, S, S, 3) image -> (B, 32) position code. A uint8 image takes
    its first layer's dtype (flax promotes uint8 with the parameters'
    float type: float32, or bfloat16 under a scoring tier); a floating
    one keeps its dtype."""
    image = features["image"]
    if not image.is_floating_point():
      image = image.to(self.img_fc1.weight.dtype)
    image = image / torch.tensor(255.0, dtype=image.dtype)
    x = image.reshape(image.shape[0], -1)
    return self.img_code(torch.relu(self.img_fc1(x)))

  def q_from_code(self, features) -> ts.TensorSpecStruct:
    """{"image": (B, 32) code, "action": (B, A)} -> q logit."""
    action = features["action"]
    if not action.is_floating_point():
      action = action.float()
    action = torch.relu(self.act_fc1(action))
    code = features["image"]
    if action.dtype != code.dtype:
      action = action.to(code.dtype)
    h = torch.cat([code, action], dim=-1)
    h = torch.relu(self.joint_fc1(h))
    h = torch.relu(self.joint_fc2(h))
    return ts.TensorSpecStruct({"q_predicted": self.q_head(h)[:, 0]})

  def forward(self, features, mode: str):
    del mode  # no train/eval asymmetry (no dropout, no batch statistics)
    return self.q_from_code({"image": self.encode(features),
                             "action": features["action"]})


class TinyQCriticModel(CriticModel):
  """(uint8 image, action) -> grasp Q at ms scale, on the flagship's uint8
  wire, so the replay tier's transitions have one schema."""

  def __init__(self, image_size: int = SMOKE_IMAGE_SIZE,
               action_size: int = SMOKE_ACTION_SIZE, **kwargs):
    kwargs.setdefault("compute_dtype", torch.float32)
    super().__init__(**kwargs)
    self._image_size = image_size
    self._action_size = action_size

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct({
        "image": ts.ExtendedTensorSpec(
            (self._image_size, self._image_size, 3), np.uint8,
            name="image"),
        "action": ts.ExtendedTensorSpec(
            (self._action_size,), np.float32, name="action"),
    })

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct({
        self.target_key: ts.ExtendedTensorSpec(
            (), np.float32, name=self.target_key),
    })

  def build_module(self) -> nn.Module:
    return _TinyQModule(self._image_size, self._action_size)
