"""AbstractT2RModel — the portable model abstraction.

Counterpart of ``tensor2robot_tpu/models/abstract_model.py``. A model
declares its specs and its preprocessor, builds its network as an
``nn.Module``, defines its loss and provides its optimizer. As in the JAX
package, variables live apart from the network: they are a state_dict
(parameters and running statistics) that ``inference_network_fn`` applies
with ``torch.func.functional_call``, so a predictor or a trainer can swap
them without touching the module. The module runs in ``compute_dtype``
(bfloat16 by default) with parameters in ``param_dtype``. EMA
(``use_avg_model_params``) and warm start (``init_from_checkpoint``) are
declared here and run by the trainer.

The module's buffers are its mutable state, flax's ``batch_stats``
collection: a TRAIN-mode pass updates copies of them and returns the
copies as the new model state.

A module whose ``forward`` takes a ``generator`` keyword draws random
numbers in TRAIN mode (dropout): ``model_train_fn`` and
``inference_network_fn`` pass it the ``torch.Generator`` they are given,
the counterpart of flax's ``rngs={"dropout": ...}``. The trainer makes one
a step from its seed and the step (``train/trainer.py``).

A functional call swaps the module's tensors while it runs, so a module
is never shared between threads (the replay loop's collectors act while
its learner trains): each thread fills a template of its own
(``thread_module``).
"""

from __future__ import annotations

import abc
import inspect
import math
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import Device, modes, resolve_device
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
    ModelNoOpPreprocessor,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.utils import optimizers

Variables = Dict[str, torch.Tensor]  # a state_dict
Metrics = Dict[str, torch.Tensor]

# flax's lecun_normal: a normal truncated at two standard deviations, whose
# stddev is divided by this factor so the variance stays 1 / fan_in.
_TRUNCATED_NORMAL_STDDEV_FACTOR = 0.87962566103423978


def flax_default_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None) -> None:
  """Re-initialises `module` in place as flax's defaults would.

  Conv and Dense kernels draw from lecun_normal, their biases are zero;
  norm layers keep their constructors' ones and zeros. A module with
  parameters of its own kind draws them in its ``flax_init_(generator)``.
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
      if hasattr(layer, "flax_init_"):
        layer.flax_init_(generator)


class AbstractT2RModel(abc.ABC):
  """Spec-declaring, loss-defining, optimizer-providing model base."""

  # Whether torch.export can trace the PREDICT forward into the serving
  # program (export/native_export_generator.py).
  exports_program = True

  def __init__(self, optimizer_fn: Optional[optimizers.OptimizerFn] = None,
               use_avg_model_params: bool = False,
               avg_model_params_decay: float = 0.9999,
               compute_dtype: torch.dtype = torch.bfloat16,
               param_dtype: torch.dtype = torch.float32,
               init_from_checkpoint: Optional[str] = None,
               init_from_checkpoint_assignment_map: Optional[
                   Dict[str, str]] = None):
    """Args:
      optimizer_fn: parameters -> ``torch.optim.Optimizer``, as the
        factories of ``utils/optimizers.py`` return; None gives
        ``create_optimizer``'s default, Adam 1e-4.
      use_avg_model_params: keep an EMA copy of the parameters, which eval
        and export use.
      avg_model_params_decay: EMA decay.
      compute_dtype: activation dtype inside the network.
      param_dtype: master parameter dtype.
      init_from_checkpoint: where to warm-start the parameters from before
        step 0: a port run or step directory, or a variables.npz (either
        package's export); see ``train/checkpoints.py::restore_params``.
      init_from_checkpoint_assignment_map: optional {source_prefix:
        target_prefix} renames over flax param paths, in
        tf.train.init_from_checkpoint's direction (checkpoint name on the
        left, current-model name on the right).
    """
    self._optimizer_fn = optimizer_fn
    self.use_avg_model_params = use_avg_model_params
    self.avg_model_params_decay = avg_model_params_decay
    self.compute_dtype = compute_dtype
    self.param_dtype = param_dtype
    self.init_from_checkpoint = init_from_checkpoint
    self.init_from_checkpoint_assignment_map = (
        init_from_checkpoint_assignment_map)
    self._module: Optional[nn.Module] = None
    self._thread_modules = threading.local()
    self._preprocessor: Optional[AbstractPreprocessor] = None
    self._takes_generator: Optional[bool] = None

  # --- specs --------------------------------------------------------------

  @abc.abstractmethod
  def get_feature_specification(self, mode: str) -> ts.SpecStructure:
    """Model-consumed feature specs for `mode`."""

  def get_label_specification(self, mode: str) -> ts.SpecStructure:
    """Model-consumed label specs for `mode` (default: none)."""
    del mode
    return ts.TensorSpecStruct()

  @property
  def preprocessor(self) -> AbstractPreprocessor:
    """The preprocessor pairing this model with the input pipeline."""
    if self._preprocessor is None:
      self._preprocessor = self.create_preprocessor()
    return self._preprocessor

  def create_preprocessor(self) -> AbstractPreprocessor:
    """Default: identity, resolving the model's own specs per mode."""
    return ModelNoOpPreprocessor(self)

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
      self._thread_modules.module = self._module
    return self._module

  def thread_module(self) -> nn.Module:
    """This thread's template for functional calls: ``module`` on the
    thread that built it, a template of its own on every other thread."""
    module = getattr(self._thread_modules, "module", None)
    if module is None:
      if self._module is None:
        return self.module
      module = self._thread_modules.module = self.build_module().to(
          self.param_dtype)
    return module

  def init_variables(self, generator: Optional[torch.Generator] = None,
                     device: Device = None) -> Variables:
    """Fresh variables drawn from `generator`, placed on `device`."""
    module = self.build_module().to(self.param_dtype)
    flax_default_init_(module, generator)
    device = resolve_device(device)
    return {k: v.detach().to(device) for k, v in module.state_dict().items()}

  def takes_generator(self) -> bool:
    """Whether the network draws random numbers: its ``forward`` takes a
    ``generator`` keyword."""
    if self._takes_generator is None:
      self._takes_generator = "generator" in inspect.signature(
          self.thread_module().forward).parameters
    return self._takes_generator

  def forward_kwargs(self, generator: Optional[torch.Generator]) -> dict:
    """The keywords a functional call passes the module's ``forward``."""
    return ({"generator": generator}
            if generator is not None and self.takes_generator() else {})

  def inference_network_fn(self, variables: Variables, features: Any,
                           mode: str,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[Any, Variables]:
    """Functional forward pass: (outputs, new_model_state).

    In TRAIN mode new_model_state holds the module's buffers (the batch
    statistics) as the pass left them, updated in copies: `variables` is
    never changed. In the other modes it is empty. `generator` feeds the
    module's random draws (``takes_generator``).
    """
    mode = modes.validate_mode(mode)
    state = {}
    if mode == modes.TRAIN:
      keys = [name for name, _ in self.thread_module().named_buffers()]
      if keys and "batch_stats" not in self.mutable_collections():
        raise ValueError(
            f"{type(self).__name__} updates batch_stats in TRAIN mode, but "
            "mutable_collections() does not list it.")
      state = {key: variables[key].clone() for key in keys}
    outputs = torch.func.functional_call(
        self.thread_module(), {**variables, **state}, (features, mode),
        self.forward_kwargs(generator), strict=True)
    return outputs, state

  def mutable_collections(self) -> Tuple[str, ...]:
    """Non-param variable collections updated during training."""
    return ("batch_stats",)

  # --- loss ---------------------------------------------------------------

  @abc.abstractmethod
  def loss_fn(self, outputs: Any, features: Any,
              labels: Optional[Any]) -> Tuple[torch.Tensor, Metrics]:
    """Scalar training loss + metrics."""

  def model_train_fn(self, variables: Variables, features: Any,
                     labels: Optional[Any],
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Tuple[Metrics, Variables]]:
    """loss + (metrics, updated model state); the trainer differentiates
    the loss with respect to the parameters. `generator` feeds dropout."""
    outputs, new_state = self.inference_network_fn(
        variables, features, modes.TRAIN, generator=generator)
    loss, metrics = self.loss_fn(outputs, features, labels)
    metrics = dict(metrics)
    metrics.setdefault("loss", loss)
    return loss, (metrics, new_state)

  def model_eval_fn(self, variables: Variables, features: Any,
                    labels: Optional[Any]) -> Metrics:
    """Eval metrics (EVAL mode: running statistics). The trainer passes
    the EMA parameters when use_avg_model_params is set."""
    outputs, _ = self.inference_network_fn(variables, features, modes.EVAL)
    loss, metrics = self.loss_fn(outputs, features, labels)
    metrics = dict(metrics)
    metrics.setdefault("loss", loss)
    return metrics

  def model_image_summaries_fn(self, variables: Variables,
                               features: Any) -> Optional[Dict[str, Any]]:
    """Optional eval image summaries, {tag: (H, W[, C]) uint8 or [0, 1]
    float image}, rendered from the last eval batch with the (EMA) eval
    variables and written by ``MetricWriter.write_images``. None: no
    images."""
    del variables, features
    return None

  # --- optimizer ----------------------------------------------------------

  def create_optimizer(
      self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The optimizer over `params`: optimizer_fn's, else Adam 1e-4."""
    if self._optimizer_fn is not None:
      return self._optimizer_fn(params)
    return optimizers.create_adam_optimizer(1e-4)(params)

  # --- serving ------------------------------------------------------------

  def predict_fn(self, variables: Variables, features: Any) -> Any:
    """Pure inference entry used by predictors (PREDICT mode)."""
    with torch.inference_mode():
      outputs, _ = self.inference_network_fn(variables, features,
                                             modes.PREDICT)
    return outputs
