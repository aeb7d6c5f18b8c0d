"""Abstract preprocessor protocol: spec-in/spec-out, mode-aware, host-side.

Counterpart of ``tensor2robot_tpu/preprocessors/abstract_preprocessor.py``.
The in-specs describe what the input pipeline must produce; the out-specs
describe what the model consumes. The input generators glue the two:
produce per in-spec -> preprocess -> validate per out-spec -> device.
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


class AbstractPreprocessor(abc.ABC):
  """Transforms host batches into model-ready batches, per mode."""

  @abc.abstractmethod
  def get_in_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    """What the input pipeline must produce for this preprocessor."""

  @abc.abstractmethod
  def get_in_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    """Label specs the input pipeline must produce."""

  @abc.abstractmethod
  def get_out_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    """What this preprocessor hands to the model."""

  @abc.abstractmethod
  def get_out_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    """Label specs handed to the model."""

  @abc.abstractmethod
  def _preprocess_fn(
      self,
      features: ts.TensorSpecStruct,
      labels: Optional[ts.TensorSpecStruct],
      mode: str,
  ) -> Tuple[ts.TensorSpecStruct, Optional[ts.TensorSpecStruct]]:
    """The transformation itself (batched numpy in, batched numpy out)."""

  def preprocess(
      self,
      features: ts.TensorSpecStruct,
      labels: Optional[ts.TensorSpecStruct],
      mode: str,
  ) -> Tuple[ts.TensorSpecStruct, Optional[ts.TensorSpecStruct]]:
    """Validated preprocess: checks inputs and outputs against the specs."""
    modes.validate_mode(mode)
    features = ts.validate_and_flatten(
        self.get_in_feature_specification(mode), features)
    if labels is not None and len(labels):
      labels = ts.validate_and_flatten(
          self.get_in_label_specification(mode), labels)
    out_features, out_labels = self._preprocess_fn(features, labels, mode)
    out_features = ts.validate_and_flatten(
        self.get_out_feature_specification(mode), out_features)
    if out_labels is not None and len(out_labels):
      out_labels = ts.validate_and_flatten(
          self.get_out_label_specification(mode), out_labels)
    return out_features, out_labels


class NoOpPreprocessor(AbstractPreprocessor):
  """Identity preprocessor: in-specs == out-specs == the given specs."""

  def __init__(
      self,
      feature_spec: ts.SpecStructure,
      label_spec: Optional[ts.SpecStructure] = None,
  ):
    ts.assert_valid_spec_structure(feature_spec)
    self._feature_spec = ts.flatten_spec_structure(feature_spec)
    if label_spec is not None:
      ts.assert_valid_spec_structure(label_spec)
      self._label_spec = ts.flatten_spec_structure(label_spec)
    else:
      self._label_spec = ts.TensorSpecStruct()

  def get_in_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._feature_spec

  def get_in_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._label_spec

  def get_out_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._feature_spec

  def get_out_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._label_spec

  def _preprocess_fn(self, features, labels, mode):
    return features, labels


class ModelNoOpPreprocessor(AbstractPreprocessor):
  """Identity preprocessor resolving specs from a model *per mode*.

  The default for models without an explicit preprocessor: unlike
  NoOpPreprocessor's static specs, this respects mode-dependent spec
  declarations. `model` is any object with get_feature_specification(mode)
  / get_label_specification(mode).
  """

  def __init__(self, model):
    self._model = model

  def get_in_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    return ts.flatten_spec_structure(
        self._model.get_feature_specification(mode))

  def get_in_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    return ts.flatten_spec_structure(
        self._model.get_label_specification(mode))

  def get_out_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self.get_in_feature_specification(mode)

  def get_out_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self.get_in_label_specification(mode)

  def _preprocess_fn(self, features, labels, mode):
    return features, labels
