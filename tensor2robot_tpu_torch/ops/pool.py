"""Reshape formulation of non-overlapping max pooling.

Counterpart of ``tensor2robot_tpu/ops/pool.py``: a window x window max pool
at stride window over NHWC, written as a reshape and a max over the split
axes (on the TPU its backward then needs no SelectAndScatter). The forward
is exactly ``max_pool(x, (w, w), strides=(w, w))``; the backward differs
only on exact ties within a window, where the max's gradient is split
among the tied elements. Plain torch, not a hand kernel.
"""

from __future__ import annotations

import torch


def max_pool_reshape(x: torch.Tensor, window: int = 2) -> torch.Tensor:
  """Non-overlapping `window` x `window` max pool of (B, H, W, C); H and W
  must be divisible by `window`."""
  b, h, w, c = x.shape
  if h % window or w % window:
    raise ValueError(
        f"max_pool_reshape needs H, W divisible by {window}, got "
        f"{(h, w)}; crop first (VALID-pool semantics drop the edge).")
  x = x.reshape(b, h // window, window, w // window, window, c)
  return x.amax(dim=(2, 4))
