"""Schedules: values as functions of the global step.

Counterpart of ``tensor2robot_tpu/utils/global_step_functions.py``, whose
schedules are jit-traceable jnp functions. Here each is a plain function
``step -> float`` for the host: a learning-rate or loss-weight schedule
runs on the host between steps, so ``Trainer.train_steps``' CUDA graph
refuses an optimizer that carries one (``trainer.check_graphable``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from tensor2robot_tpu_torch.config import configurable

Schedule = Callable[[int], float]


@configurable
def piecewise_linear(boundaries: Sequence[int],
                     values: Sequence[float]) -> Schedule:
  """Linear interpolation through (boundary, value) control points:
  values[0] before the first boundary, values[-1] after the last."""
  if len(boundaries) != len(values):
    raise ValueError(
        f"Need one value per boundary; got {len(boundaries)} boundaries "
        f"and {len(values)} values.")
  if len(boundaries) < 1:
    raise ValueError("Need at least one (boundary, value) control point.")
  if list(boundaries) != sorted(boundaries):
    raise ValueError(f"Boundaries must be ascending: {boundaries}")
  bounds = np.asarray(boundaries, np.float32)
  vals = np.asarray(values, np.float32)

  def schedule(step) -> float:
    return float(np.interp(np.float32(step), bounds, vals).astype(
        np.float32))

  return schedule


@configurable
def piecewise_constant(boundaries: Sequence[int],
                       values: Sequence[float]) -> Schedule:
  """values[i] while step < boundaries[i], else values[-1]; needs
  len(values) == len(boundaries) + 1."""
  if len(values) != len(boundaries) + 1:
    raise ValueError(
        f"Need len(values) == len(boundaries) + 1; got {len(values)} "
        f"values for {len(boundaries)} boundaries.")
  if list(boundaries) != sorted(boundaries):
    raise ValueError(f"Boundaries must be ascending: {boundaries}")
  bounds = np.asarray(boundaries, np.float32)
  vals = np.asarray(values, np.float32)

  def schedule(step) -> float:
    return float(vals[int(np.sum(np.float32(step) >= bounds))])

  return schedule


@configurable
def exponential_decay(initial_value: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False
                      ) -> Schedule:
  """initial_value * decay_rate ** (step / decay_steps), the exponent
  floored when `staircase`."""
  def schedule(step) -> float:
    exponent = np.float32(step) / np.float32(decay_steps)
    if staircase:
      exponent = np.floor(exponent)
    return float(np.float32(initial_value)
                 * np.float32(decay_rate) ** np.float32(exponent))

  return schedule
