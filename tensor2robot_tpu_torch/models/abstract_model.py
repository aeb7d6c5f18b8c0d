"""AbstractT2RModel — the portable model abstraction: the serving subset.

Counterpart of ``tensor2robot_tpu/models/abstract_model.py``. A model
declares its specs, builds its network as an ``nn.Module``, and defines
its loss. As in the JAX package, variables live apart from the network:
they are a state_dict (parameters and running statistics) that
``inference_network_fn`` applies with ``torch.func.functional_call``, so a
predictor can swap them without touching the module. The module runs in
``compute_dtype`` (bfloat16 by default) with parameters in ``param_dtype``.

The optimizer and the train step arrive with the training slice.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import Device, modes, resolve_device
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

Variables = Dict[str, torch.Tensor]  # a state_dict
Metrics = Dict[str, torch.Tensor]

# flax's lecun_normal: a normal truncated at two standard deviations, whose
# stddev is divided by this factor so the variance stays 1 / fan_in.
_TRUNCATED_NORMAL_STDDEV_FACTOR = 0.87962566103423978


def flax_default_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None) -> None:
  """Re-initialises `module` in place as flax's defaults would.

  Conv and Dense kernels draw from lecun_normal, their biases are zero;
  norm layers keep their constructors' ones and zeros.
  """
  with torch.no_grad():
    for layer in module.modules():
      if isinstance(layer, (nn.Conv1d, nn.Conv2d, nn.Linear)):
        fan_in = layer.weight[0].numel()  # in_channels x kernel size
        std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STDDEV_FACTOR
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if layer.bias is not None:
          layer.bias.zero_()


class AbstractT2RModel(abc.ABC):
  """Spec-declaring, loss-defining model base."""

  def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
               param_dtype: torch.dtype = torch.float32):
    """Args:
      compute_dtype: activation dtype inside the network.
      param_dtype: master parameter dtype.
    """
    self.compute_dtype = compute_dtype
    self.param_dtype = param_dtype
    self._module: Optional[nn.Module] = None

  # --- specs --------------------------------------------------------------

  @abc.abstractmethod
  def get_feature_specification(self, mode: str) -> ts.SpecStructure:
    """Model-consumed feature specs for `mode`."""

  def get_label_specification(self, mode: str) -> ts.SpecStructure:
    """Model-consumed label specs for `mode` (default: none)."""
    del mode
    return ts.TensorSpecStruct()

  # --- network ------------------------------------------------------------

  @abc.abstractmethod
  def build_module(self) -> nn.Module:
    """Builds the network; ``forward(features, mode)`` -> outputs."""

  @property
  def module(self) -> nn.Module:
    """The network, built once on the CPU: a template that
    ``inference_network_fn`` fills with the variables it is given."""
    if self._module is None:
      self._module = self.build_module().to(self.param_dtype)
    return self._module

  def init_variables(self, generator: Optional[torch.Generator] = None,
                     device: Device = None) -> Variables:
    """Fresh variables drawn from `generator`, placed on `device`."""
    module = self.build_module().to(self.param_dtype)
    flax_default_init_(module, generator)
    device = resolve_device(device)
    return {k: v.detach().to(device) for k, v in module.state_dict().items()}

  def inference_network_fn(self, variables: Variables, features: Any,
                           mode: str) -> Tuple[Any, Dict[str, Any]]:
    """Functional forward pass: (outputs, new_model_state).

    new_model_state is empty: the modes served here update no statistics.
    """
    outputs = torch.func.functional_call(
        self.module, variables, (features, modes.validate_mode(mode)),
        strict=True)
    return outputs, {}

  # --- loss ---------------------------------------------------------------

  @abc.abstractmethod
  def loss_fn(self, outputs: Any, features: Any,
              labels: Optional[Any]) -> Tuple[torch.Tensor, Metrics]:
    """Scalar training loss + metrics."""

  # --- serving ------------------------------------------------------------

  def predict_fn(self, variables: Variables, features: Any) -> Any:
    """Pure inference entry used by predictors (PREDICT mode)."""
    with torch.inference_mode():
      outputs, _ = self.inference_network_fn(variables, features,
                                             modes.PREDICT)
    return outputs
