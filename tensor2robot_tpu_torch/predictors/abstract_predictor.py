"""AbstractPredictor: the robot-facing inference contract.

Counterpart of ``tensor2robot_tpu/predictors/abstract_predictor.py``:
predict / predict_batched / restore / init_randomly / model_version /
get_feature_specification / set_variables / device_fn / close, with
restore-with-timeout semantics.

``set_variables`` is the hot swap a rollout promotes through. Its guard,
``checked_swap``, is shared by every predictor that swaps tensors: the
candidate must have the live variables' keys and shapes, and a dtype
drift is rejected unless the caller passes ``cast=True``, the seam for
variables already cast on disk, which casts a floating candidate onto
the live dtypes. Compiled consumers (a fleet policy's CUDA graphs) read
the served tensors' dtypes, so the served dtypes never change.
"""

from __future__ import annotations

import abc
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.export import export_utils
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.utils import backoff


def checked_swap(live: Mapping[str, torch.Tensor],
                 candidate: Mapping, cast: bool = False
                 ) -> Dict[str, torch.Tensor]:
  """`candidate` as tensors on the live variables' devices and dtypes, or
  ValueError: for other keys or shapes, and for a dtype drift unless
  `cast` (floating onto floating only: casting an integer leaf would
  truncate or wrap its values)."""
  if set(candidate) != set(live):
    raise ValueError(
        f"hot-swap keys differ: {sorted(set(candidate) ^ set(live))} (a "
        "candidate must have the served variables' keys)")
  out = {}
  for key, old in live.items():
    new = torch.as_tensor(candidate[key])
    if tuple(new.shape) != tuple(old.shape):
      raise ValueError(
          f"hot-swap shape mismatch for {key!r}: {tuple(old.shape)} -> "
          f"{tuple(new.shape)} (a reshaped candidate would rebuild every "
          "bucket's graph; promote via a new export instead).")
    if new.dtype != old.dtype:
      floating = new.is_floating_point() and old.is_floating_point()
      if not (cast and floating):
        raise ValueError(
            f"hot-swap dtype mismatch for {key!r}: {old.dtype} -> "
            f"{new.dtype} (the fleet's graphs read the served dtypes"
            + ("; pass cast=True for an intentional precision cast onto "
               "the served dtypes" if floating else
               "; a non-floating mismatch is structural drift the cast "
               "seam refuses") + ").")
    out[key] = new.detach().to(device=old.device, dtype=old.dtype,
                               copy=True)
  return out


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

  def predict_batched(
      self, features: Dict[str, np.ndarray],
      ladder=None) -> Dict[str, np.ndarray]:
    """predict() with the batch padded to a bounded size ladder: a
    ``serving.BucketLadder`` rung when given, else the next power of two,
    by repeating the last row (``bucketing.pad_to``); the outputs are
    sliced back. Inconsistent leading dims raise ValueError."""
    from tensor2robot_tpu_torch.serving.bucketing import pad_to
    sizes = {np.asarray(v).shape[0] for v in dict(features).values()}
    if len(sizes) != 1:
      raise ValueError(f"inconsistent leading batch dims: {sizes}")
    n = sizes.pop()
    bucket = ladder.bucket_for(n) if ladder is not None else (
        1 << max(0, (n - 1).bit_length()))
    if bucket == n:
      return self.predict(features)
    padded = {k: pad_to(np.asarray(v), bucket)
              for k, v in dict(features).items()}
    return {k: v[:n] for k, v in self.predict(padded).items()}

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

  def set_variables(self, variables, version: Optional[int] = None,
                    cast: bool = False) -> None:
    """Hot-swaps the served variables (the same keys, shapes and dtypes;
    ``checked_swap``). `version` is the candidate's step in
    ``model_version``'s namespace, so a later restore() poll cannot take
    an older checkpoint for news; None bumps the version by one
    (``_next_swap_version`` keeps it monotonic). `cast=True` casts a
    floating dtype drift onto the served dtypes. Optional: predictors
    whose parameters live in an opaque artifact raise."""
    raise NotImplementedError(
        f"{type(self).__name__} does not support in-place variable "
        "hot-swap; publish a new export and call restore().")

  def _next_swap_version(self, version: Optional[int]) -> int:
    """The monotonic model_version of a set_variables swap."""
    bumped = self.model_version + 1
    return bumped if version is None else max(bumped, int(version))

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
