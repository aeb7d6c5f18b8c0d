"""RegressionModel — MSE task head base class.

Counterpart of ``tensor2robot_tpu/models/regression_model.py``. Subclasses
declare specs + build_module; the module's outputs must contain
``inference_output``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    Metrics,
)


class RegressionModel(AbstractT2RModel):
  """MSE regression against a single label tensor.

  Args:
    label_key: flat key of the regression target in the label spec.
    output_key: key of the prediction in the module outputs.
  """

  def __init__(self, label_key: str = "target",
               output_key: str = "inference_output", **kwargs):
    super().__init__(**kwargs)
    self.label_key = label_key
    self.output_key = output_key

  def loss_fn(self, outputs, features,
              labels: Optional[dict]) -> Tuple[torch.Tensor, Metrics]:
    if labels is None:
      raise ValueError("RegressionModel.loss_fn requires labels")
    predictions = outputs[self.output_key]
    targets = labels[self.label_key].to(predictions.dtype)
    error = (predictions - targets).float()
    mse = torch.mean(torch.square(error))
    mae = torch.mean(torch.abs(error))
    return mse, {"mse": mse, "mae": mae}
