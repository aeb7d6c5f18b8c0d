"""Sum tree: O(log n) proportional sampling for prioritized replay.

Counterpart of ``tensor2robot_tpu/replay/sum_tree.py``, kept as a copy
(numpy only, float64) because the JAX package's ``replay/__init__`` pulls
in JAX; on the same inputs it gives the same bits. The tree is the
complete-binary-heap layout over a power-of-two leaf array: node i's value
is the sum of its children 2i and 2i+1, the root (index 1) is the total
mass, and sampling descends from the root spending a uniform draw against
left-subtree mass. It stays on the host: priorities change every train
step from host-visible TD errors, and the ring's storage is host numpy.
"""

from __future__ import annotations

import numpy as np


class SumTree:
  """Positive weights over `capacity` slots with proportional sampling."""

  def __init__(self, capacity: int):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.capacity = capacity
    self._depth = max(1, int(np.ceil(np.log2(capacity))))
    self._n = 1 << self._depth  # leaf count, power of two
    # tree[1] = root; leaves live at [n, 2n). Slots >= capacity keep
    # weight 0 forever, so they are unreachable by sampling.
    self._tree = np.zeros(2 * self._n, np.float64)

  @property
  def total(self) -> float:
    """Total mass (the root)."""
    return float(self._tree[1])

  def get(self, indices) -> np.ndarray:
    """Leaf weights at `indices`."""
    indices = np.asarray(indices, np.int64)
    self._check(indices)
    return self._tree[self._n + indices].copy()

  def leaves(self, size: int) -> np.ndarray:
    """The first `size` leaf weights (the buffer's filled prefix)."""
    return self._tree[self._n:self._n + size].copy()

  def set(self, indices, values) -> None:
    """Sets leaf weights, refreshing ancestor sums level by level.

    Duplicate indices keep the LAST value (np.ndarray fancy-store
    semantics), matching "this slot was overwritten" replay semantics.
    """
    indices = np.asarray(indices, np.int64).reshape(-1)
    values = np.broadcast_to(
        np.asarray(values, np.float64).reshape(-1), indices.shape)
    self._check(indices)
    if np.any(values < 0) or not np.all(np.isfinite(values)):
      raise ValueError("priorities must be finite and >= 0")
    pos = self._n + indices
    self._tree[pos] = values
    # Recompute each touched parent from BOTH children instead of
    # propagating deltas: immune to float drift accumulating over
    # millions of updates (the renormalization property the tests pin).
    for _ in range(self._depth):
      pos = np.unique(pos >> 1)
      self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]

  def sample(self, uniforms) -> np.ndarray:
    """Proportional sample: uniforms in [0, 1) -> leaf indices.

    Vectorized root-to-leaf descent (one numpy pass per level). The
    caller supplies the uniforms so sampling shares the buffer's single
    seeded generator (determinism contract).
    """
    total = self.total
    if total <= 0:
      raise ValueError("cannot sample from an empty/zero-mass tree")
    mass = np.asarray(uniforms, np.float64) * total
    pos = np.ones(mass.shape, np.int64)
    for _ in range(self._depth):
      left = 2 * pos
      left_mass = self._tree[left]
      go_right = mass >= left_mass
      mass = np.where(go_right, mass - left_mass, mass)
      pos = np.where(go_right, left + 1, left)
    indices = pos - self._n
    # Float-edge guard: mass == subtree total can step one leaf past
    # the populated range; clamp back onto real slots. The clamped (or
    # any zero-mass) leaf may still be unwritten — callers tracking a
    # fill level must remap zero-weight picks (ReplayBuffer.sample
    # does), since the tree itself has no notion of "filled".
    return np.minimum(indices, self.capacity - 1)

  def _check(self, indices: np.ndarray) -> None:
    if indices.size and (indices.min() < 0
                         or indices.max() >= self.capacity):
      raise IndexError(
          f"indices out of range [0, {self.capacity}): "
          f"[{indices.min()}, {indices.max()}]")
