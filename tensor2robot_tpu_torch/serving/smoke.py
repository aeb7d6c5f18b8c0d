"""TinyQPredictor: a millisecond-scale Q-function for serving smokes.

Counterpart of ``tensor2robot_tpu/serving/smoke.py``. The serving smoke
(``bin/bench_serving --fleet --smoke``) and the serving tests need a
predictor whose compute is negligible, so what they measure is the serving
layer: dispatch amortization, deadline flushing, bucket padding. Its
Q-function has a known optimum for each image, ``q = -||action -
tanh(image @ w)||^2``, so a test sees that each request got the answer for
its own image. ``w`` comes from the same ``np.random.default_rng(seed)``
draws as the JAX predictor's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
    checked_swap,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


class TinyQPredictor(AbstractPredictor):
  """(image, action) -> q_predicted with an analytically known argmax, on
  `device` (the GPU unless 'cpu' is asked for)."""

  def __init__(self, image_size: int = 8, action_size: int = 4,
               seed: int = 0, device: Device = None):
    self.image_size = image_size
    self.action_size = action_size
    self._device = resolve_device(device)
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(
        (image_size * image_size * 3, action_size)).astype(np.float32)
    self._variables = {"w": torch.from_numpy(0.05 * w).to(self._device)}
    self._version = 0

  @staticmethod
  def _fn(variables, features):
    image = features["image"].float()
    flat = image.reshape(image.shape[0], -1)
    # A scoring tier's bf16 weight meets the float32 image at float32, as
    # JAX promotes the pair.
    target = torch.tanh(flat @ variables["w"].float())
    action = features["action"].float()
    return {"q_predicted": -((action - target) ** 2).sum(-1)}

  def best_action(self, image: np.ndarray) -> np.ndarray:
    """The analytic optimum CEM should find for `image`."""
    flat = np.asarray(image, np.float32).reshape(1, -1)
    return np.tanh(flat @ self._variables["w"].cpu().numpy())[0]

  def make_candidate_variables(self, scale: float = 1.0,
                               jitter: float = 0.0,
                               seed: int = 1) -> Dict[str, np.ndarray]:
    """A rollout candidate: ``scale=1, jitter=0`` serves the same Q; a
    large ``jitter`` (fresh random weights mixed in) is a regression whose
    argmax actions score far below the serving optimum."""
    w = self._variables["w"].cpu().numpy()
    if jitter:
      rng = np.random.default_rng(seed)
      w = w + jitter * rng.standard_normal(w.shape).astype(np.float32)
    return {"w": scale * w}

  def set_variables(self, variables, version=None,
                    cast: bool = False) -> None:
    """See AbstractPredictor.set_variables (``checked_swap``)."""
    self._variables = checked_swap(self._variables, variables, cast)
    self._version = self._next_swap_version(version)

  def make_image(self, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random(
        (self.image_size, self.image_size, 3)).astype(np.float32)

  # -- AbstractPredictor contract -----------------------------------------

  def restore(self, timeout_s: float = 0.0,
              raise_on_timeout: bool = False) -> bool:
    return True

  def init_randomly(self) -> None:
    pass

  def predict(
      self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    inputs = {key: torch.from_numpy(np.ascontiguousarray(value)).to(
        self._device) for key, value in dict(features).items()}
    with torch.inference_mode():
      outputs = self._fn(self._variables, inputs)
    return {k: v.cpu().numpy() for k, v in outputs.items()}

  def device_fn(self):
    return self._fn, self._variables

  def get_feature_specification(self) -> ts.TensorSpecStruct:
    return ts.TensorSpecStruct({
        "image": ts.ExtendedTensorSpec(
            (self.image_size, self.image_size, 3), np.float32,
            name="image"),
        "action": ts.ExtendedTensorSpec(
            (self.action_size,), np.float32, name="action"),
    })

  @property
  def model_version(self) -> int:
    return self._version
