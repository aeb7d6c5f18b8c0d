"""Dropout drawn from an explicit ``torch.Generator``.

Counterpart of flax's ``nn.Dropout``: in TRAIN mode an element is kept
with probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; in
every other mode it passes through. Flax draws its mask from the
``"dropout"`` rng a step hands the module; here the module's ``forward``
takes the generator the trainer makes for the step
(``train/trainer.py``), so a mask is a function of the seed and the step,
and a CUDA graph replays fresh masks from a generator registered with it.
``torch.nn.functional.dropout`` takes no generator, so the mask is drawn
with ``torch.rand``.

threefry and Philox differ, so masks never equal JAX's: parity with the
JAX package is taken at rate 0 or outside TRAIN mode.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_STATE = threading.local()


@contextlib.contextmanager
def batch_shard(parts: int, index: int):
  """Within this context (on this thread), dropout draws the mask of the
  whole batch, `parts` times the rows it is given, and keeps block `index`
  of it: a rank of a data mesh drops what the one-rank run on the global
  batch drops. The batch is the leading dim."""
  previous = getattr(_STATE, "shard", None)
  _STATE.shard = (parts, index)
  try:
    yield
  finally:
    _STATE.shard = previous


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
  """`x` with dropout at `rate` when `train`, else `x` itself."""
  if not train or rate == 0.0:
    return x
  if generator is None:
    raise ValueError(
        "dropout in TRAIN mode needs a torch.Generator: pass generator= to "
        "model_train_fn (the trainer makes one a step).")
  if rate == 1.0:
    return torch.zeros_like(x)
  keep_prob = 1.0 - rate
  parts, index = getattr(_STATE, "shard", None) or (1, 0)
  rows = x.shape[0]
  draw = torch.rand((rows * parts,) + tuple(x.shape[1:]),
                    generator=generator, device=x.device)
  keep = draw[index * rows:(index + 1) * rows] < keep_prob
  return torch.where(keep, x / keep_prob, torch.zeros_like(x))
