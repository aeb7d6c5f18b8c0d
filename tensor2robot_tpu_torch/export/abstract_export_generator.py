"""AbstractExportGenerator: spec-driven serving artifacts.

Counterpart of ``tensor2robot_tpu/export/abstract_export_generator.py``:
capture the serving signature (the model's PREDICT feature specs as its
preprocessor hands them over, labels stripped) and write one versioned
artifact per export, with its spec assets.
"""

from __future__ import annotations

import abc
from typing import Optional

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.models.abstract_model import Variables
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


class AbstractExportGenerator(abc.ABC):
  """Builds versioned serving artifacts for a model."""

  def __init__(self, export_root: Optional[str] = None):
    self._export_root = export_root
    self._model = None
    self._feature_spec: Optional[ts.TensorSpecStruct] = None

  @property
  def export_root(self) -> str:
    if self._export_root is None:
      raise ValueError("export_root not set.")
    return self._export_root

  @export_root.setter
  def export_root(self, value: str) -> None:
    self._export_root = value

  def set_specification_from_model(self, model) -> None:
    """Captures the serving signature: the model-ready (preprocessor-out)
    PREDICT feature specs, labels stripped."""
    self._model = model
    self._feature_spec = ts.flatten_spec_structure(
        model.preprocessor.get_out_feature_specification(modes.PREDICT))

  @property
  def feature_spec(self) -> ts.TensorSpecStruct:
    if self._feature_spec is None:
      raise ValueError(
          "Export generator has no specs; call "
          "set_specification_from_model first.")
    return self._feature_spec

  @abc.abstractmethod
  def export(self, variables: Variables, global_step: int = 0) -> str:
    """Writes one new version under export_root; returns its final dir.

    Args:
      variables: the model's variables as a state_dict on the host, as
        ``export_utils.fetch_variables_to_host`` gives them (the EMA
        parameters when use_avg_model_params: TrainState.variables(
        use_ema=True)).
      global_step: the train step the variables were taken at, recorded
        in the spec assets (0 = unknown).
    """
