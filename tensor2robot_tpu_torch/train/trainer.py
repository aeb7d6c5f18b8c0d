"""Trainer: the train, eval and predict steps for one model on one device.

Counterpart of ``tensor2robot_tpu/train/trainer.py`` for a single device:
one step is the model's TRAIN-mode forward pass, its loss, the backward
pass, the optimizer's step, the new batch statistics and the EMA update
(``optax.incremental_update``'s rule). The JAX trainer's mesh, parameter
shardings, ZeRO, AOT executables, health reductions, scanned multi-steps
and gradient accumulation are not part of this one: they come with the
parallel tier (``ROADMAP.md``, the flagship list's item 15) and the train
step's extras (its item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from tensor2robot_tpu_torch import Device, bridge, resolve_device
from tensor2robot_tpu_torch.train.train_state import TrainState

Metrics = Dict[str, torch.Tensor]


class Trainer:
  """Owns the device and the steps for one model."""

  def __init__(self, model, seed: int = 0, device: Device = None):
    """Args:
      model: an ``AbstractT2RModel``.
      seed: seeds the ``torch.Generator`` that draws fresh variables.
      device: where to train; the GPU unless 'cpu' is asked for.
    """
    self.model = model
    self.seed = seed
    self.device = resolve_device(device)

  # --- state ---------------------------------------------------------------

  def create_train_state(
      self, variables: Optional[Mapping[str, Any]] = None) -> TrainState:
    """A fresh TrainState on the trainer's device.

    Args:
      variables: None draws flax's initialisers from
        ``torch.Generator().manual_seed(seed)``. Else the variables to start
        from: a flax tree (``{"params": ..., "batch_stats": ...}``, as the
        JAX ``TrainState.variables()`` gives it), which the weight bridge
        maps, or the model's own state_dict. They are copied.
    """
    module = self.model.module
    if variables is None:
      state_dict = self.model.init_variables(
          torch.Generator().manual_seed(self.seed), device=self.device)
    elif "params" in variables:
      state_dict = bridge.variables_to_state_dict(variables, module)
    else:
      state_dict = dict(variables)
      expected = set(module.state_dict())
      if set(state_dict) != expected:
        raise KeyError(
            f"variables have keys {sorted(state_dict)}; the model has "
            f"{sorted(expected)}.")
    names = [name for name, _ in module.named_parameters()]
    params = {
        name: state_dict[name].detach().to(self.device, copy=True)
        .requires_grad_() for name in names}
    model_state = {
        key: value.detach().to(self.device, copy=True)
        for key, value in state_dict.items() if key not in params}
    ema = ({name: p.detach().clone() for name, p in params.items()}
           if self.model.use_avg_model_params else None)
    state = TrainState(
        step=0, params=params, model_state=model_state,
        opt_state=self.model.create_optimizer(list(params.values())),
        ema_params=ema)
    if self.model.init_from_checkpoint:
      state = self._warm_start(state, self.model.init_from_checkpoint)
    return state

  def _warm_start(self, state: TrainState, checkpoint_path: str
                  ) -> TrainState:
    """Loads the parameters that match by (mapped) flax path and shape
    from `checkpoint_path` into `state`, in place; the EMA re-seeds from
    them (at decay ~0.9999 an EMA left on the random init would poison
    eval and export for tens of thousands of steps)."""
    from tensor2robot_tpu_torch.train import checkpoints
    restored = checkpoints.restore_params(checkpoint_path)
    merged = checkpoints.merge_params(
        bridge.state_dict_to_variables(state.params)["params"], restored,
        assignment_map=self.model.init_from_checkpoint_assignment_map)
    params = bridge.params_to_state_dict(merged, self.model.module)
    with torch.no_grad():
      for name, tensor in state.params.items():
        tensor.copy_(params[name])
        if state.ema_params is not None:
          state.ema_params[name].copy_(params[name])
    return state

  # --- steps ---------------------------------------------------------------

  def train_step(self, state: TrainState, features, labels=None
                 ) -> Tuple[TrainState, Metrics]:
    """One optimizer step. Spends `state`: go on with the one returned."""
    optimizer = state.opt_state
    optimizer.zero_grad(set_to_none=True)
    loss, (metrics, new_model_state) = self.model.model_train_fn(
        state.variables(), features, labels)
    loss.backward()
    optimizer.step()
    ema = state.ema_params
    if ema is not None:
      rate = 1.0 - self.model.avg_model_params_decay
      with torch.no_grad():
        ema = {name: rate * p + (1.0 - rate) * ema[name]
               for name, p in state.params.items()}
    return dataclasses.replace(
        state, step=state.step + 1,
        model_state={**state.model_state, **new_model_state},
        ema_params=ema), {k: v.detach() for k, v in metrics.items()}

  def eval_step(self, state: TrainState, features, labels=None) -> Metrics:
    """Eval metrics of one batch (EMA parameters when kept)."""
    with torch.no_grad():
      return self.model.model_eval_fn(state.variables(use_ema=True),
                                      features, labels)

  def predict_fn(self, state: TrainState) -> Callable[[Any], Any]:
    """PREDICT-mode closure over a snapshot of the current (EMA) variables:
    later steps update the state's tensors in place, not the snapshot."""
    variables = {key: value.detach().clone()
                 for key, value in state.variables(use_ema=True).items()}
    model = self.model

    def predict(features):
      return model.predict_fn(variables, features)

    return predict
