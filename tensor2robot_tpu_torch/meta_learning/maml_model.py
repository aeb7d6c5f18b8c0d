"""MAMLModel: model-agnostic meta-learning as a model transformer.

Counterpart of ``tensor2robot_tpu/meta_learning/maml_model.py``. Each task
of a meta-batch adapts a copy of the base model's parameters by
``num_inner_steps`` gradient steps on its condition (support) samples, then
predicts its inference (query) samples with the adapted parameters. The
outer loss is the base loss on the queries; training differentiates it
through the inner steps (second order) unless ``first_order`` detaches the
inner gradients.

Input layout (flat keys; the batch axis is the task):
    condition/features/*  (T, N_c, ...)   support inputs
    condition/labels/*    (T, N_c, ...)   support targets
    inference/features/*  (T, N_q, ...)   query inputs
    inference/labels/*    (T, N_q, ...)   query targets
as ``meta_data.meta_batch_from_arrays`` builds it.

How it maps onto PyTorch:
  - JAX vmaps one task's computation over the task axis. Here the tasks
    run in a loop, so every task keeps its own batch statistics (a
    BatchNorm base normalises each support set by itself) and the spatial
    softmax's ``autograd.Function`` needs no vmap rule. Inside a CUDA
    graph the loop costs no host time.
  - The inner gradients are ``torch.autograd.grad`` of the support loss
    with ``create_graph=True`` when the caller differentiates the outputs
    (grad mode on, parameters that require grad) at second order;
    otherwise they are detached.
  - Adaptation needs gradients in every mode: EVAL and PREDICT adapt under
    ``enable_grad`` on detached copies of the parameters. ``predict_fn``
    runs under ``no_grad``, not ``inference_mode``, whose tensors cannot
    enter autograd.
  - The inner loop never adapts state: in TRAIN mode the base writes its
    batch statistics into copies that are thrown away, and the model state
    returned is empty, so the variables' running statistics never change.
    A BatchNorm base therefore serves with its initial statistics, as in
    the JAX package; the bundled factories default to GroupNorm.
  - ``learn_inner_lr`` adds one learned scalar rate per base parameter,
    the state_dict key ``inner_lrs.<base key>`` (the flax tree's
    ``params/inner_lrs/...``; ``bridge`` maps both directions).
  - Dropout draws from the generator it is handed, task after task and
    step after step, so the masks differ across tasks and inner steps.
  - PREDICT adapts too: a meta-serving request carries condition data.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.bridge import INNER_RATES
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    Metrics,
    Variables,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.utils.tree import tree_leaves, tree_map

def _subtree(struct, prefix: str) -> ts.TensorSpecStruct:
  flat = ts.flatten_spec_structure(struct)
  out = ts.TensorSpecStruct()
  for key, value in flat.items():
    if key.startswith(prefix + "/"):
      out[key[len(prefix) + 1:]] = value
  return out


class InnerRates(nn.Module):
  """One learned inner-loop rate per base parameter: a 0-d parameter at
  the base parameter's own path, so its key is ``inner_lrs.<base key>``."""

  def __init__(self, names, value: float):
    super().__init__()
    self.value = float(value)
    for name in names:
      *path, leaf = name.split(".")
      node = self
      for part in path:
        if part not in node._modules:
          node.add_module(part, nn.Module())
        node = node._modules[part]
      node.register_parameter(leaf, nn.Parameter(torch.tensor(self.value)))

  def flax_init_(self, generator: Optional[torch.Generator]) -> None:
    del generator
    with torch.no_grad():
      for rate in self.parameters():
        rate.fill_(self.value)


def _leaf(tensor: torch.Tensor) -> torch.Tensor:
  """A detached copy of `tensor` that autograd can differentiate."""
  tensor = tensor.detach()
  if tensor.is_inference():
    tensor = tensor.clone()
  return tensor.requires_grad_()


@configurable
class MAMLModel(AbstractT2RModel):
  """Wraps an AbstractT2RModel with a MAML inner and outer loop."""

  # The tasks run in a Python loop, which a torch.export trace unrolls
  # for its example's task count: no program with a dynamic batch.
  exports_program = False

  def __init__(
      self,
      base_model: AbstractT2RModel,
      num_inner_steps: int = 1,
      inner_lr: float = 0.01,
      learn_inner_lr: bool = False,
      first_order: bool = False,
      num_condition_samples: int = 4,
      num_inference_samples: int = 4,
      **kwargs,
  ):
    """Args:
      base_model: the task model being meta-learned.
      num_inner_steps: unrolled adaptation steps.
      inner_lr: the inner-loop step size (the learned rates' start).
      learn_inner_lr: meta-learn one step size per base parameter.
      first_order: detach the inner gradients (FOMAML).
      num_condition_samples / num_inference_samples: the per-task split
        sizes the feature specs declare.
      **kwargs: AbstractT2RModel's; compute_dtype defaults to the base's.
    """
    kwargs.setdefault("compute_dtype", base_model.compute_dtype)
    super().__init__(**kwargs)
    self.base_model = base_model
    self.num_inner_steps = num_inner_steps
    self.inner_lr = inner_lr
    self.learn_inner_lr = learn_inner_lr
    self.first_order = first_order
    self.num_condition_samples = num_condition_samples
    self.num_inference_samples = num_inference_samples

  # --- specs ---------------------------------------------------------------

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    preprocessor = self.base_model.preprocessor
    base_f = ts.flatten_spec_structure(
        preprocessor.get_out_feature_specification(mode))
    base_l = ts.flatten_spec_structure(
        preprocessor.get_out_label_specification(mode))
    out = ts.TensorSpecStruct()
    for name, count in (("condition", self.num_condition_samples),
                        ("inference", self.num_inference_samples)):
      for key, spec in base_f.items():
        out[f"{name}/features/{key}"] = ts.ExtendedTensorSpec.from_spec(
            spec, shape=(count,) + spec.shape)
      for key, spec in base_l.items():
        out[f"{name}/labels/{key}"] = ts.ExtendedTensorSpec.from_spec(
            spec, shape=(count,) + spec.shape)
    return out

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct()  # the query labels travel in the features

  # --- variables -----------------------------------------------------------

  def build_module(self) -> nn.Module:
    """The base's network; with ``learn_inner_lr`` it also holds the
    rates as its child ``inner_lrs`` (its forward never reads them)."""
    module = self.base_model.build_module()
    if self.learn_inner_lr:
      names = [name for name, _ in module.named_parameters()]
      module.add_module(INNER_RATES, InnerRates(names, self.inner_lr))
    return module

  def mutable_collections(self) -> Tuple[str, ...]:
    return ()  # the inner loop is stateless; batch statistics are read-only

  # --- the MAML computation ------------------------------------------------

  def inference_network_fn(
      self, variables: Variables, features: Any, mode: str,
      generator: Optional[torch.Generator] = None) -> Tuple[Any, Variables]:
    mode = modes.validate_mode(mode)
    module = self.thread_module()
    base = self.base_model
    rate_keys = {key for key in variables
                 if key.startswith(INNER_RATES + ".")}
    names = [name for name, _ in module.named_parameters()
             if name not in rate_keys]
    params = {name: variables[name] for name in names}
    fixed = {key: value for key, value in variables.items()
             if key not in params}
    if mode == modes.TRAIN:  # batch statistics land in discarded copies
      fixed = {key: (value if key in rate_keys else value.clone())
               for key, value in fixed.items()}
    rates = ({name: variables[f"{INNER_RATES}.{name}"] for name in names}
             if self.learn_inner_lr else None)
    kwargs = self.forward_kwargs(generator)

    def apply(p, f):
      return torch.func.functional_call(module, {**p, **fixed}, (f, mode),
                                        kwargs, strict=True)

    cond_f = _subtree(features, "condition/features")
    cond_l = _subtree(features, "condition/labels")
    query_f = _subtree(features, "inference/features")
    num_tasks = next(tree_leaves(cond_f)).shape[0]
    # The caller differentiates the outputs (the train step) when grad mode
    # is on and the parameters require grad: only then do the adapted
    # parameters keep their history.
    outer = torch.is_grad_enabled() and any(
        v.requires_grad for v in params.values())
    create_graph = outer and not self.first_order
    queries: List[Any] = []
    losses = []
    with torch.enable_grad():
      for task in range(num_tasks):
        cf, cl, qf = (tree_map(lambda x: x[task], tree)  # noqa: B023
                      for tree in (cond_f, cond_l, query_f))
        p = params if outer else {n: _leaf(v) for n, v in params.items()}
        final_loss = torch.zeros((), device=next(iter(params.values())).device)
        for _ in range(self.num_inner_steps):
          loss, _ = base.loss_fn(apply(p, cf), cf, cl)
          grads = torch.autograd.grad(
              loss, list(p.values()), create_graph=create_graph,
              allow_unused=True, materialize_grads=True)
          with torch.set_grad_enabled(outer):
            p = {n: v - (rates[n] if rates else self.inner_lr) * g
                 for (n, v), g in zip(p.items(), grads)}
          if not outer:
            p = {n: v.requires_grad_() for n, v in p.items()}
          final_loss = loss
        with torch.set_grad_enabled(outer):
          queries.append(apply(p, qf))
        losses.append(final_loss if outer else final_loss.detach())
    outputs = ts.TensorSpecStruct(
        (key, torch.stack([q[key] for q in queries]))
        for key in queries[0].keys())
    outputs["condition_loss"] = torch.stack(losses)
    return outputs, {}

  def loss_fn(self, outputs, features, labels) -> Tuple[torch.Tensor,
                                                        Metrics]:
    del labels
    base_outputs = ts.TensorSpecStruct(
        (k, v) for k, v in outputs.items() if k != "condition_loss")
    loss, metrics = self.base_model.loss_fn(
        base_outputs, _subtree(features, "inference/features"),
        _subtree(features, "inference/labels"))
    metrics = dict(metrics)
    metrics["outer_loss"] = loss
    metrics["inner_loss_final"] = torch.mean(outputs["condition_loss"])
    return loss, metrics

  def predict_fn(self, variables: Variables, features: Any) -> Any:
    """Adapt-then-forward in PREDICT mode, under ``no_grad`` (the inner
    steps enable grad for themselves)."""
    if torch.is_inference_mode_enabled():
      raise RuntimeError(
          "MAMLModel adapts with autograd; call predict_fn outside "
          "torch.inference_mode().")
    with torch.no_grad():
      outputs, _ = self.inference_network_fn(variables, features,
                                             modes.PREDICT)
    return outputs
