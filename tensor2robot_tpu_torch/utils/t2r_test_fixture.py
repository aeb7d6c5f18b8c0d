"""T2RModelFixture: runs the real train loop in-process for tests.

Counterpart of ``tensor2robot_tpu/utils/t2r_test_fixture.py``: a model and
random spec-conformant input generators drive ``train_eval_model`` a few
real steps (train, eval, checkpoint, export) with no data files.
"""

from __future__ import annotations

import math
from typing import Optional

from tensor2robot_tpu_torch import Device
from tensor2robot_tpu_torch.data.default_input_generator import (
    DefaultRandomInputGenerator,
)
from tensor2robot_tpu_torch.train.train_eval import (
    TrainEvalResult,
    train_eval_model,
)


class T2RModelFixture:
  """Drives train_eval_model on synthetic data."""

  def __init__(self, seed: int = 0, device: Device = None):
    """`device`: where to train; the GPU unless 'cpu' is asked for."""
    self._seed = seed
    self._device = device

  def random_train(
      self,
      model,
      max_train_steps: int = 3,
      batch_size: int = 8,
      eval_steps: int = 2,
      model_dir: Optional[str] = None,
      export_generator=None,
      **kwargs,
  ) -> TrainEvalResult:
    """Trains `model` a few steps on random spec-conformant batches and
    checks that it took them with no NaN in its metrics."""
    kwargs.setdefault("device", self._device)
    result = train_eval_model(
        model,
        input_generator_train=DefaultRandomInputGenerator(
            batch_size=batch_size, seed=self._seed),
        input_generator_eval=DefaultRandomInputGenerator(
            batch_size=batch_size, seed=self._seed + 1),
        max_train_steps=max_train_steps,
        eval_steps=eval_steps,
        model_dir=model_dir,
        export_generator=export_generator,
        seed=self._seed,
        log_every_steps=1,
        **kwargs,
    )
    assert result.state.step == max_train_steps
    assert not any(math.isnan(v) for v in result.train_metrics.values()), (
        f"NaN in train metrics: {result.train_metrics}")
    return result
