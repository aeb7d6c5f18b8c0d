"""Optimizer factories.

Counterpart of ``tensor2robot_tpu/utils/optimizers.py``, where each factory
returns a zero-argument callable that builds an optax transformation. Here
each returns a constructor: ``params -> torch.optim.Optimizer``, with the
same names, defaults and update rules as the optax one:

- Adam adds eps after the square root of the bias-corrected second moment,
  as ``optax.adam`` (and ``torch.optim.Adam``) do;
- RMSprop adds eps inside the square root, as ``optax.rmsprop`` does by
  default (``torch.optim.RMSprop`` adds it outside), so it has its own class;
- Adam over CUDA parameters is built ``capturable=True``: its step count
  lives on the device, so ``Trainer.train_steps`` can capture its update
  in a CUDA graph (momentum SGD and RMSprop create their state at their
  first step and need no flag);
- a piecewise-constant schedule ``[(boundary, scale), ...]`` multiplies the
  rate by every scale whose boundary the update count has reached, as
  ``optax.piecewise_constant_schedule``. It is a ``LambdaLR`` that advances
  after each ``step()`` by itself, as an optax schedule lives inside its
  transformation; it hangs on the optimizer as ``lr_schedule``, so that a
  checkpoint saves its counter.

The factories are ``@configurable``: a config file binds their arguments,
and ``@create_adam_optimizer()`` calls the factory at injection time, as
in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from tensor2robot_tpu_torch.config import configurable

OptimizerFn = Callable[[Iterable], torch.optim.Optimizer]
BoundariesAndScales = Optional[Sequence[Tuple[int, float]]]


def _with_schedule(optimizer: torch.optim.Optimizer,
                   boundaries_and_scales: BoundariesAndScales):
  if not boundaries_and_scales:
    return optimizer
  if any(scale < 0 for _, scale in boundaries_and_scales):
    raise ValueError(
        f"schedule scales must be non-negative; got {boundaries_and_scales}.")
  steps = sorted(boundaries_and_scales)

  def factor(count: int) -> float:
    value = 1.0
    for boundary, scale in steps:
      if count >= boundary:
        value *= scale
    return value

  scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
  optimizer.register_step_post_hook(lambda *_: scheduler.step())
  optimizer.lr_schedule = scheduler
  return optimizer


class RMSprop(torch.optim.Optimizer):
  """optax.rmsprop: nu = decay nu + (1 - decay) g^2; the update is
  lr g / sqrt(nu + eps), then an optional momentum trace."""

  def __init__(self, params, lr: float, decay: float, eps: float,
               momentum: float):
    super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                  momentum=momentum))

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    for group in self.param_groups:
      for p in group["params"]:
        if p.grad is None:
          continue
        state = self.state[p]
        if not state:
          state["nu"] = torch.zeros_like(p)
          state["trace"] = torch.zeros_like(p)
        nu = state["nu"]
        nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                         value=1 - group["decay"])
        update = p.grad * torch.rsqrt(nu + group["eps"]) * group["lr"]
        trace = state["trace"]
        trace.mul_(group["momentum"]).add_(update)
        p.sub_(trace)
    return loss


@configurable
def create_adam_optimizer(
    learning_rate: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    boundaries_and_scales: BoundariesAndScales = None,
) -> OptimizerFn:
  """Adam (the reference's default optimizer family)."""

  def build(params):
    params = list(params)
    return _with_schedule(
        torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                         capturable=any(p.is_cuda for p in params)),
        boundaries_and_scales)

  return build


def load_state(optimizer: torch.optim.Optimizer, state_dict) -> None:
  """``optimizer.load_state_dict`` that keeps the ``capturable`` flag the
  optimizer was built with (``load_state_dict`` takes the saving one's):
  a CUDA run's checkpoint resumes on the CPU, and a CPU run's on the GPU
  stays graphable. Adam's step counts move to where the flag puts them.
  State tensors the optimizer already holds (a CUDA graph may have
  captured them) take the loaded values in place and stay the same
  tensors."""
  built = [group.get("capturable") for group in optimizer.param_groups]
  held = {param: dict(state) for param, state in optimizer.state.items()}
  optimizer.load_state_dict(state_dict)
  for group, capturable in zip(optimizer.param_groups, built):
    if capturable is None:
      continue
    group["capturable"] = capturable
    for param in group["params"]:
      state = optimizer.state.get(param, {})
      if "step" in state:
        state["step"] = state["step"].to(
            param.device if capturable else "cpu", torch.float32)
  with torch.no_grad():
    for param, old in held.items():
      state = optimizer.state.get(param, {})
      for key, tensor in old.items():
        loaded = state.get(key)
        if (isinstance(tensor, torch.Tensor)
            and isinstance(loaded, torch.Tensor)
            and loaded.shape == tensor.shape):
          tensor.copy_(loaded)
          state[key] = tensor


@configurable
def create_momentum_optimizer(
    learning_rate: float = 1e-2,
    momentum: float = 0.9,
    nesterov: bool = False,
    boundaries_and_scales: BoundariesAndScales = None,
) -> OptimizerFn:
  return lambda params: _with_schedule(
      torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                      nesterov=nesterov),
      boundaries_and_scales)


@configurable
def create_sgd_optimizer(
    learning_rate: float = 1e-2,
    boundaries_and_scales: BoundariesAndScales = None,
) -> OptimizerFn:
  return lambda params: _with_schedule(
      torch.optim.SGD(params, lr=learning_rate), boundaries_and_scales)


@configurable
def create_rmsprop_optimizer(
    learning_rate: float = 1e-3,
    decay: float = 0.9,
    momentum: float = 0.0,
    eps: float = 1e-10,
    boundaries_and_scales: BoundariesAndScales = None,
) -> OptimizerFn:
  return lambda params: _with_schedule(
      RMSprop(params, lr=learning_rate, decay=decay, eps=eps,
              momentum=momentum),
      boundaries_and_scales)
