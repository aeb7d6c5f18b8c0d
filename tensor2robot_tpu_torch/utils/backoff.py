"""Jittered exponential backoff for export polling loops.

Counterpart of ``tensor2robot_tpu/utils/backoff.py``: a predictor's
``restore(timeout_s)`` polls its export root with intervals that grow
``initial_s * factor^k`` up to ``max_s``, each scaled by a uniform draw in
``[1 - jitter, 1 + jitter]`` so co-started robots decorrelate, with the
last sleep clamped to the deadline.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import numpy as np


class PollTimeout(TimeoutError):
  """A poll loop exhausted its budget; names the awaited target."""

  def __init__(self, description: str, waited_s: float, attempts: int):
    self.description = description
    self.waited_s = waited_s
    self.attempts = attempts
    polls = f" ({attempts} polls)" if attempts > 0 else ""
    super().__init__(
        f"timed out after {waited_s:.2f}s{polls} waiting "
        f"for {description}")


def backoff_intervals(initial_s: float = 0.05, max_s: float = 2.0,
                      factor: float = 2.0, jitter: float = 0.25,
                      seed: Optional[int] = None) -> Iterator[float]:
  """Infinite stream of jittered exponential sleep intervals."""
  if initial_s <= 0:
    raise ValueError(f"initial_s must be > 0, got {initial_s}")
  if factor < 1.0:
    raise ValueError(f"factor must be >= 1, got {factor}")
  if not 0.0 <= jitter < 1.0:
    raise ValueError(f"jitter must be in [0, 1), got {jitter}")
  rng = np.random.default_rng(seed)
  interval = float(initial_s)
  while True:
    scale = 1.0 + jitter * (2.0 * float(rng.random()) - 1.0)
    yield min(interval, max_s) * scale
    interval = min(interval * factor, max_s)


def poll_with_backoff(predicate: Callable[[], object],
                      timeout_s: float,
                      initial_s: float = 0.05,
                      max_s: float = 2.0,
                      factor: float = 2.0,
                      jitter: float = 0.25,
                      seed: Optional[int] = None,
                      description: Optional[str] = None,
                      raise_on_timeout: bool = False):
  """Polls ``predicate()`` with jittered exponential backoff.

  Returns the predicate's first truthy value. On timeout, returns the last
  (falsy) value, or raises a ``PollTimeout`` naming ``description`` when
  ``raise_on_timeout``. The predicate runs at least once (timeout_s=0 is a
  non-blocking probe), and the final sleep never passes the deadline.
  """
  deadline = time.monotonic() + max(0.0, timeout_s)
  intervals = backoff_intervals(initial_s, max_s, factor, jitter, seed)
  attempts = 0
  started = time.monotonic()
  while True:
    value = predicate()
    attempts += 1
    if value:
      return value
    remaining = deadline - time.monotonic()
    if remaining <= 0:
      if raise_on_timeout:
        raise PollTimeout(description or "<unnamed condition>",
                          time.monotonic() - started, attempts)
      return value
    time.sleep(min(next(intervals), remaining))
