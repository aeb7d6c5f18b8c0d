"""Mock full-stack components: a tiny real model over synthetic specs.

Counterpart of ``tensor2robot_tpu/utils/mocks.py``: ``MockT2RModel`` trains
in milliseconds and runs the whole stack (specs, data, module, loss,
optimizer, export, predictor) with no data files. Its module has dropout
at 0.1 and an optional BatchNorm, so it exercises the generator threading
and the batch statistics. The children keep flax's auto names
(``Dense_0``, ``BatchNorm_0``, ``Dense_1``), so the weight bridge maps the
JAX mock's variables path for path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.layers.dropout import dropout
from tensor2robot_tpu_torch.layers.vision_layers import BatchNorm, Dense
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

DROPOUT_RATE = 0.1


class MockModule(nn.Module):
  """Tiny MLP: x (3,) -> Dense -> [BatchNorm] -> relu -> dropout -> (1,)."""

  def __init__(self, hidden_size: int = 16, use_batch_norm: bool = False,
               compute_dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.compute_dtype = compute_dtype
    self.Dense_0 = Dense(3, hidden_size, compute_dtype)
    if use_batch_norm:
      self.BatchNorm_0 = BatchNorm(hidden_size, compute_dtype)
    self.Dense_1 = Dense(hidden_size, 1, torch.float32)

  def forward(self, features, mode: str,
              generator: Optional[torch.Generator] = None):
    train = mode == modes.TRAIN
    x = self.Dense_0(features["x"].to(self.compute_dtype))
    if hasattr(self, "BatchNorm_0"):
      x = self.BatchNorm_0(x, train)
    x = dropout(torch.relu(x), DROPOUT_RATE, train, generator)
    return ts.TensorSpecStruct({"inference_output": self.Dense_1(x)})


class MockT2RModel(RegressionModel):
  """The reference's MockT2RModel: x (3,) -> target (1,), MSE."""

  def __init__(self, hidden_size: int = 16, use_batch_norm: bool = False,
               **kwargs):
    super().__init__(**kwargs)
    self.hidden_size = hidden_size
    self.use_batch_norm = use_batch_norm

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct(
        {"x": ts.ExtendedTensorSpec((3,), np.float32, name="x")})

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct(
        {"target": ts.ExtendedTensorSpec((1,), np.float32, name="target")})

  def build_module(self) -> nn.Module:
    return MockModule(hidden_size=self.hidden_size,
                      use_batch_norm=self.use_batch_norm,
                      compute_dtype=self.compute_dtype)
