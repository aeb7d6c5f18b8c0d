"""The random input generator of the mock stack.

Counterpart of ``DefaultRandomInputGenerator`` in
``tensor2robot_tpu/data/default_input_generator.py``: the same seed gives
the same batches, bit for bit. The record-backed generators come with the
record pipeline (``ROADMAP.md`` Queue 1 item 2).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Batch,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


class DefaultRandomInputGenerator(AbstractInputGenerator):
  """Spec-conformant random batches: lets the real train loop run a few
  steps with no data files."""

  def __init__(self, seed: int = 0, **kwargs):
    super().__init__(**kwargs)
    self._seed = seed

  def _create_iterator(self, mode: str) -> Iterator[Batch]:
    # Different hosts draw different streams.
    rng = np.random.default_rng(self._seed + 7919 * self._shard_index)
    while True:
      features = ts.make_random_batch(
          self.feature_spec, self._batch_size, rng=rng,
          include_optional=False)
      labels = ts.make_random_batch(
          self.label_spec, self._batch_size, rng=rng,
          include_optional=False)
      yield features, labels
