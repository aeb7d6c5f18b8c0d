"""AbstractPredictor: the robot-facing inference contract.

Counterpart of ``tensor2robot_tpu/predictors/abstract_predictor.py``:
predict / restore / init_randomly / model_version /
get_feature_specification / device_fn / close, with restore-with-timeout
semantics.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

import numpy as np

from tensor2robot_tpu_torch.export import export_utils
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.utils import backoff


class AbstractPredictor(abc.ABC):
  """Loads a trained artifact and serves predict() on the robot."""

  @abc.abstractmethod
  def restore(self, timeout_s: float = 0.0,
              raise_on_timeout: bool = False) -> bool:
    """Loads (or hot-reloads) the newest available model.

    Blocks up to timeout_s waiting for a first model to appear, polling
    with jittered exponential backoff. Returns True when a model is
    loaded. With ``raise_on_timeout``, a timeout that leaves no model
    loaded raises ``utils.backoff.PollTimeout`` naming the awaited path.
    """

  @abc.abstractmethod
  def predict(
      self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Runs inference on a batched numpy feature dict."""

  @abc.abstractmethod
  def get_feature_specification(self) -> ts.TensorSpecStruct:
    """The (flat) feature spec predict() expects."""

  @property
  @abc.abstractmethod
  def model_version(self) -> int:
    """Monotonic version of the loaded model; -1 before restore."""

  def init_randomly(self) -> None:
    """Initializes with random weights (bring-up). Optional: default raises."""
    raise NotImplementedError(
        f"{type(self).__name__} does not support init_randomly.")

  def device_fn(self):
    """The device-resident serving entry: (fn, variables).

    ``fn(variables, features)`` runs the PREDICT forward on tensors that
    are already on the predictor's device and returns its outputs there,
    with no host copy, so a caller such as the QT-Opt CEM policy keeps a
    whole control step on the device. Optional: predictors without one
    raise, and callers fall back to ``predict``.
    """
    raise NotImplementedError(
        f"{type(self).__name__} has no device-resident serving path.")

  def close(self) -> None:
    """Releases resources."""

  def assert_is_loaded(self) -> None:
    if self.model_version < 0:
      raise ValueError("Predictor has no model loaded; call restore().")

  def _validate_features(
      self, features: Dict[str, np.ndarray]) -> ts.TensorSpecStruct:
    """Validates a batched feature dict against the spec (batch dim free)."""
    spec = self.get_feature_specification()
    flat = ts.TensorSpecStruct(
        (k, np.asarray(v)) for k, v in dict(features).items())
    return ts.validate_and_flatten(spec, flat, batched=True)

  def _poll_newer_version(self, export_root: str,
                          timeout_s: float) -> Optional[int]:
    """Waits for an export version newer than model_version; None if the
    timeout expires first."""

    def newest():
      versions = export_utils.list_export_versions(export_root)
      candidate = versions[-1] if versions else None
      if candidate is not None and candidate > self.model_version:
        return candidate
      return None

    return backoff.poll_with_backoff(
        newest, timeout_s, initial_s=0.1, max_s=2.0,
        description=f"an export under {export_root}")

  def _timeout_unloaded(self, description: str, timeout_s: float,
                        raise_on_timeout: bool) -> bool:
    """Shared restore() timeout exit: True when a model is already serving,
    a PollTimeout naming `description` when raise_on_timeout and nothing
    was ever loaded, else False."""
    if self.model_version >= 0:
      return True
    if raise_on_timeout:
      raise backoff.PollTimeout(description, timeout_s, 0)
    return False
