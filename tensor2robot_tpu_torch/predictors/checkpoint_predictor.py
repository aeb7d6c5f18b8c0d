"""CheckpointPredictor: rebuild the model in-process, restore a checkpoint.

Counterpart of ``tensor2robot_tpu/predictors/checkpoint_predictor.py``: no
export needed. The predictor owns the model's Python code, restores the
newest checkpoint of a training run and serves ``predict`` and
``device_fn``. It reads the port's own layout
(``<model_dir>/checkpoints/<step>/state.pt``, ``train/checkpoints.py``),
not orbax, and refuses an orbax directory by name as warm start does. A
run that trained with ``use_avg_model_params`` serves its EMA parameters
(with the batch statistics), as the JAX predictor does.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, modes, resolve_device
from tensor2robot_tpu_torch.export import export_utils
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
    checked_swap,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
    _to_numpy,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.train import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch.utils import backoff


class CheckpointPredictor(AbstractPredictor):
  """Serves a T2R model directly from its run's checkpoints."""

  def __init__(self, model: AbstractT2RModel,
               checkpoint_dir: Optional[str] = None,
               device: Device = None):
    """Args:
      model: the model whose network the checkpoint's variables fill.
      checkpoint_dir: the run's ``model_dir`` or its ``checkpoints``
        directory; None allows only init_randomly.
      device: where to serve; the GPU unless 'cpu' is asked for.
    """
    self._model = model
    self._checkpoint_dir = checkpoint_dir
    self._device = resolve_device(device)
    self._feature_spec = ts.flatten_spec_structure(
        model.get_feature_specification(modes.PREDICT))
    self._variables: Optional[Dict[str, torch.Tensor]] = None
    self._version = -1

  @property
  def device(self) -> torch.device:
    return self._device

  def _steps_dir(self) -> str:
    path = os.path.abspath(self._checkpoint_dir)
    run_checkpoints = os.path.join(path, "checkpoints")
    return run_checkpoints if os.path.isdir(run_checkpoints) else path

  def restore(self, timeout_s: float = 0.0,
              raise_on_timeout: bool = False) -> bool:
    """Loads the newest step newer than ``model_version``, polling up to
    `timeout_s` with jittered backoff (the run may not have saved yet)."""
    if self._checkpoint_dir is None:
      raise ValueError("No checkpoint_dir given; use init_randomly().")
    description = f"a checkpoint under {os.path.abspath(self._checkpoint_dir)}"

    def newer():
      directory = self._steps_dir()
      if not os.path.isdir(directory):
        return None  # the trainer has not made the run directory yet
      steps = checkpoints_lib.CheckpointManager(directory).all_steps()
      if not steps:
        if checkpoints_lib._is_orbax_dir(directory):
          raise ValueError(
              f"{directory} is an orbax checkpoint of the JAX package; "
              "orbax needs JAX, which the port does not import. Serve an "
              "export of that run instead (ExportedModelPredictor).")
        return None
      return steps[-1] if steps[-1] > self._version else None

    step = backoff.poll_with_backoff(newer, timeout_s, initial_s=0.1,
                                     max_s=2.0, description=description)
    if step is None:
      return self._timeout_unloaded(description, timeout_s,
                                    raise_on_timeout)
    payload = torch.load(
        os.path.join(self._steps_dir(), str(step),
                     checkpoints_lib.STATE_FILE),
        map_location="cpu", weights_only=True)
    params = (payload["ema_params"] if payload.get("ema_params") is not None
              else payload["params"])
    self._variables = {key: value.to(self._device) for key, value in
                       {**params, **payload["batch_stats"]}.items()}
    self._version = int(step)
    return True

  def init_randomly(self, generator: Optional[torch.Generator] = None
                    ) -> None:
    """Serves fresh variables drawn from `generator` (default: seed 0)
    as version 0."""
    generator = (torch.Generator().manual_seed(0) if generator is None
                 else generator)
    self._variables = self._model.init_variables(generator,
                                                 device=self._device)
    self._version = 0

  def set_variables(self, variables, version: Optional[int] = None,
                    cast: bool = False) -> None:
    """See AbstractPredictor.set_variables: the served keys, shapes and
    dtypes (``checked_swap``); pass the candidate's step as `version` so
    a later restore() poll cannot take an older checkpoint for news."""
    self.assert_is_loaded()
    self._variables = checked_swap(self._variables, variables, cast)
    self._version = self._next_swap_version(version)

  def predict(
      self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    self.assert_is_loaded()
    flat = self._validate_features(features)
    inputs = ts.TensorSpecStruct(
        (key, torch.from_numpy(np.ascontiguousarray(value)).to(self._device))
        for key, value in flat.items())
    outputs = self._model.predict_fn(self._variables, inputs)
    return {k: _to_numpy(v) for k, v in
            export_utils.normalize_serving_outputs(outputs).items()}

  def device_fn(self):
    """(fn, variables): the model's PREDICT forward on tensors already on
    this predictor's device, and the served variables."""
    self.assert_is_loaded()
    return self._model.predict_fn, self._variables

  def get_feature_specification(self) -> ts.TensorSpecStruct:
    return self._feature_spec

  @property
  def model_version(self) -> int:
    return self._version

  def close(self) -> None:
    self._variables = None
    self._version = -1  # assert_is_loaded fails cleanly after close()
