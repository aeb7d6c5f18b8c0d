"""ExportedModelPredictor: serve a native export directory on the GPU.

Counterpart of ``tensor2robot_tpu/predictors/exported_model_predictor.py``:
poll an export root for the newest version, block-with-timeout until the
first export exists, predict on numpy dicts, hot-reload newer versions,
and hot-swap variables in place (``set_variables``).

Two ways to serve a version:

- ``ExportedModelPredictor(export_root=...)``, with no model, serves the
  version's program, ``serving_fn.pt2`` (``torch.export``), as the JAX
  predictor of this name serves its StableHLO: no model code, the feature
  spec read from the spec assets, the variables from ``variables.npz``
  mapped onto the program's inputs. The program is moved to the serving
  device. A program that holds a hand kernel holds it as a custom op
  (``ops/dispatch.py``), which must be registered before the program
  loads: import ``tensor2robot_tpu_torch.ops`` first (this module does).
- ``ExportedModelPredictor(model, export_root)`` rebuilds the network from
  the model's Python code, as the JAX ``CheckpointPredictor`` does, and
  serves ``variables.npz`` through the weight bridge; a version without a
  program (MAML's) is served so. When the export carries its spec asset,
  its feature keys, shapes and dtypes must match the model's PREDICT
  feature spec.

``predict_examples`` serves serialized tf.Example records, the format the
data-collection fleet logs. With a model it parses them with the model's
preprocessor's PREDICT in-spec (for pose_env, a jpeg-encoded uint8 image),
runs the preprocessor on the host, then ``predict``. Serving a program, it
parses with the export's model-ready spec, as the JAX native predictor
does; where a preprocessor changes the features (pose_env's jpeg records)
only the model's way can parse the records.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

import tensor2robot_tpu_torch.ops  # noqa: F401 (registers the custom ops)
from tensor2robot_tpu_torch import Device, bridge, modes, resolve_device
from tensor2robot_tpu_torch.export import export_utils, variables_io
from tensor2robot_tpu_torch.export import native_export_generator as native
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
    checked_swap,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


def _to_numpy(tensor: torch.Tensor) -> np.ndarray:
  if tensor.dtype == torch.bfloat16:  # numpy has no bfloat16
    tensor = tensor.float()
  return tensor.detach().cpu().numpy()


class ExportedModelPredictor(AbstractPredictor):
  """Polls export_root and serves the newest export: its program, or,
  given a model, its variables through the model's network."""

  def __init__(self, model: Optional[AbstractT2RModel] = None,
               export_root: Optional[str] = None, device: Device = None):
    """Args:
      model: None serves each version's ``serving_fn.pt2``; else the model
        whose network the export's variables fill.
      export_root: directory of numeric version subdirectories.
      device: where to serve; the GPU unless 'cpu' is asked for.
    """
    if export_root is None:
      raise ValueError("ExportedModelPredictor needs an export_root.")
    self._model = model
    self._export_root = export_root
    self._device = resolve_device(device)
    self._feature_spec = (None if model is None else ts.flatten_spec_structure(
        model.get_feature_specification(modes.PREDICT)))
    self._program = None  # the served program's module, without a model
    self._feature_keys = None
    self._variables = None
    self._version = -1
    self._example_parser = None

  @property
  def device(self) -> torch.device:
    return self._device

  # --- loading -------------------------------------------------------------

  def restore(self, timeout_s: float = 0.0,
              raise_on_timeout: bool = False) -> bool:
    newest = self._poll_newer_version(self._export_root, timeout_s)
    if newest is None:
      return self._timeout_unloaded(
          f"a native export under {self._export_root}", timeout_s,
          raise_on_timeout)
    export_dir = os.path.join(self._export_root, str(newest))
    tree = variables_io.load_variables(
        os.path.join(export_dir, export_utils.VARIABLES_NPZ))
    if self._model is None:
      state = self._load_program(export_dir, tree)
    else:
      if os.path.exists(os.path.join(export_dir,
                                     export_utils.SPEC_ASSET_NAME)):
        self._check_spec_assets(export_dir)
      state = bridge.variables_to_state_dict(tree, self._model.module)
    self._variables = {k: v.to(self._device) for k, v in state.items()}
    self._version = newest
    return True

  def _load_program(self, export_dir: str, tree) -> Dict[str, torch.Tensor]:
    """Loads the version's program onto the serving device; returns its
    variables, `tree` mapped onto the program's inputs."""
    from torch.export.passes import move_to_device_pass
    feature_spec, _, extra = export_utils.read_spec_assets(export_dir)
    if extra.get("format") != native.PROGRAM_FORMAT:
      raise ValueError(
          f"Export {export_dir} holds no serving program (format "
          f"{extra.get('format')!r}); pass its model to serve its "
          "variables.")
    program = torch.export.load(
        os.path.join(export_dir, native.SERVING_FN_NAME))
    if self._device.type != "cpu":
      program = move_to_device_pass(program, self._device)
    state = bridge.variables_to_tensors(
        tree, {key: (shape, getattr(torch, dtype))
               for key, shape, dtype in extra["variables"]}, export_dir)
    self._program = program.module()
    self._feature_spec = feature_spec
    self._feature_keys = list(extra["feature_keys"])
    self._example_parser = None  # rebuilt for the new spec
    return state

  def _check_spec_assets(self, export_dir: str) -> None:
    exported, _, extra = export_utils.read_spec_assets(export_dir)
    keys = list(extra.get("feature_keys", exported.keys()))
    if sorted(keys) != sorted(self._feature_spec.keys()):
      raise ValueError(
          f"Export {export_dir} takes features {keys}; the model takes "
          f"{list(self._feature_spec.keys())}.")
    for key in keys:
      want, got = self._feature_spec[key], exported[key]
      if (want.shape, want.dtype) != (got.shape, got.dtype):
        raise ValueError(
            f"Export {export_dir} declares feature {key!r} as {got!r}; the "
            f"model takes {want!r}.")

  def init_randomly(self) -> None:
    """Serves freshly initialised weights (seed 0) as version 0; needs
    the model."""
    if self._model is None:
      raise NotImplementedError(
          "init_randomly draws the model's variables: pass the model.")
    self._variables = self._model.init_variables(
        torch.Generator().manual_seed(0), device=self._device)
    self._version = 0

  def set_variables(self, variables, version=None, cast: bool = False
                    ) -> None:
    """Hot-swaps the served variables (``checked_swap``); `version` is
    the candidate's export version."""
    self.assert_is_loaded()
    self._variables = checked_swap(self._variables, variables, cast)
    self._version = self._next_swap_version(version)

  # --- serving -------------------------------------------------------------

  def predict(
      self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    self.assert_is_loaded()
    flat = self._validate_features(features)
    inputs = ts.TensorSpecStruct(
        (key, torch.from_numpy(np.ascontiguousarray(value)).to(self._device))
        for key, value in flat.items())
    fn, variables = self.device_fn()
    return {k: _to_numpy(v) for k, v in
            export_utils.normalize_serving_outputs(
                fn(variables, inputs)).items()}

  def predict_examples(self, serialized) -> Dict[str, np.ndarray]:
    """Serves a batch of serialized tf.Example records (no TensorFlow):
    with a model, parse with the preprocessor's PREDICT in-spec,
    preprocess, predict; serving a program, parse with its feature spec
    and predict."""
    from tensor2robot_tpu_torch.data.parser import ExampleParser
    self.assert_is_loaded()
    if self._model is None:
      if self._example_parser is None:
        self._example_parser = ExampleParser(self._feature_spec)
      features, _ = self._example_parser.parse_batch(list(serialized))
      return self.predict(features)
    preprocessor = self._model.preprocessor
    if self._example_parser is None:
      self._example_parser = ExampleParser(
          preprocessor.get_in_feature_specification(modes.PREDICT))
    features, _ = self._example_parser.parse_batch(list(serialized))
    features, _ = preprocessor.preprocess(features, None, modes.PREDICT)
    return self.predict(features)

  def device_fn(self):
    """(fn, variables): ``fn(variables, features)`` is the PREDICT forward
    (the program's, or the model's) on tensors already on this
    predictor's device; the variables are the served ones, on that
    device."""
    self.assert_is_loaded()
    if self._model is not None:
      return self._model.predict_fn, self._variables
    program, keys = self._program, self._feature_keys

    def serve(variables, features):
      with torch.no_grad():
        return program(variables, *[features[key] for key in keys])

    return serve, self._variables

  def get_feature_specification(self) -> ts.TensorSpecStruct:
    if self._model is None:
      self.assert_is_loaded()
    return self._feature_spec

  @property
  def model_version(self) -> int:
    return self._version

  def close(self) -> None:
    self._variables = None
    self._program = None
    self._example_parser = None
    self._version = -1  # assert_is_loaded fails cleanly after close()
