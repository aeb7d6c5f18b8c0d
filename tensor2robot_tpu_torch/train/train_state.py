"""TrainState: everything a training run carries from step to step.

Counterpart of ``tensor2robot_tpu/train/train_state.py``: the step, the
master parameters, the mutable model state (batch statistics), the
optimizer and, when ``use_avg_model_params``, the EMA parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]  # state_dict keys -> tensors


@dataclasses.dataclass
class TrainState:
  """All training state. The parameters and the optimizer update in place,
  so a state handed to ``Trainer.train_step`` is spent: go on with the one
  it returns, as with the JAX step, which donates its state."""

  step: int
  params: Tensors                        # leaf tensors, param_dtype
  model_state: Tensors                   # buffers (batch_stats)
  opt_state: torch.optim.Optimizer       # holds the Adam moments
  ema_params: Optional[Tensors] = None   # EMA copy; None unless enabled
  # Over a mesh (``train/mesh_layout.py``): the layout, and under ZeRO-1
  # the optimizer's blocks of the parameters (the tensors it steps).
  opt_params: Optional[Tensors] = None
  layout: Optional[Any] = None

  @property
  def eval_params(self) -> Tensors:
    """The parameters eval and export use: the EMA copy when kept."""
    return self.ema_params if self.ema_params is not None else self.params

  def variables(self, use_ema: bool = False) -> Tensors:
    """The model's variables (a state_dict) for ``inference_network_fn``.
    Over a mesh, this rank's blocks: ``full_variables`` gathers them."""
    params = self.eval_params if use_ema else self.params
    return {**params, **self.model_state}

  def full_variables(self, use_ema: bool = False) -> Tensors:
    """The variables whole, on every rank (a collective over a mesh)."""
    if self.layout is None:
      return self.variables(use_ema)
    params = self.eval_params if use_ema else self.params
    return {**{key: self.layout.gather(value.detach(),
                                       self.layout.specs[key])
               for key, value in params.items()}, **self.model_state}
