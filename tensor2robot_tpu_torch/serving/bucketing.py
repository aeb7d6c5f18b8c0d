"""Batch-size bucketing: a fixed ladder of batch shapes.

Counterpart of ``tensor2robot_tpu/serving/bucketing.py``, the same code:
serving pads every pending batch up to the next rung of a small ladder
(default 1/2/4/8/16), so the number of compiled programs (the port's CUDA
graphs) is bounded by ``len(ladder)`` for the life of the server, and an
odd-sized flush never builds a new one.
"""

from __future__ import annotations

import bisect
from typing import Sequence, Tuple

import numpy as np

DEFAULT_LADDER: Tuple[int, ...] = (1, 2, 4, 8, 16)


def pad_to(batch: np.ndarray, size: int) -> np.ndarray:
  """Pads (n, ...) to (size, ...) on axis 0 by repeating the last row.

  The ONE padding strategy every bucketed path shares (the fleet
  policy's device batches and AbstractPredictor.predict_batched):
  repeating a real row keeps padded rows numerically benign through
  normalization layers — no synthetic zeros — and callers slice the
  padded results off anyway.
  """
  n = batch.shape[0]
  if size == n:
    return batch
  if size < n:
    raise ValueError(f"cannot pad {n} rows down to {size}")
  pad = np.repeat(batch[-1:], size - n, axis=0)
  return np.concatenate([batch, pad], axis=0)


class BucketLadder:
  """Maps a pending-batch size onto the fixed ladder of compiled sizes."""

  def __init__(self, sizes: Sequence[int] = DEFAULT_LADDER):
    sizes = tuple(sorted(set(int(s) for s in sizes)))
    if not sizes or sizes[0] < 1:
      raise ValueError(f"ladder must be non-empty positive ints, got {sizes}")
    self.sizes = sizes

  @property
  def max_batch(self) -> int:
    return self.sizes[-1]

  def bucket_for(self, n: int) -> int:
    """Smallest ladder size >= n (the executable that serves n requests)."""
    if n < 1 or n > self.max_batch:
      raise ValueError(
          f"batch size {n} outside ladder (1..{self.max_batch})")
    return self.sizes[bisect.bisect_left(self.sizes, n)]

  def pad_batch(self, batch: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pads (n, ...) up to its bucket on axis 0; returns (padded, bucket).

    See pad_to for the shared padding strategy.
    """
    bucket = self.bucket_for(batch.shape[0])
    return pad_to(batch, bucket), bucket
