"""Hook and HookBuilder.

Counterpart of ``tensor2robot_tpu/hooks/hook_builder.py``. A hook sees the
train loop at its sync points: ``begin`` before the first step,
``after_step`` where the loop logs its metrics (host floats), and
``after_checkpoint`` after each checkpoint save, then ``end`` after the
last step and the final checkpoint.
"""

from __future__ import annotations

import abc
from typing import List


class Hook:
  """Train-loop observer; every method is an optional override."""

  def begin(self, trainer, state, model_dir: str) -> None:
    """Called once before the first step."""

  def after_step(self, state, metrics: dict) -> None:
    """Called at the metric sync points (not every step)."""

  def after_checkpoint(self, step: int, state) -> None:
    """Called after the checkpoint of `step` is saved."""

  def end(self, state) -> None:
    """Called once after the last step and the final checkpoint."""


class HookBuilder(abc.ABC):
  """Makes a run's hooks; config files inject builders."""

  @abc.abstractmethod
  def create_hooks(self, trainer, model_dir: str) -> List[Hook]:
    """The hooks of this run."""
