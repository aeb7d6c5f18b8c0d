"""Kernel launch counts through CUDA graphs.

Each kernel wrapper adds one to its count where it launches its kernel. A
launch recorded while a stream captures a CUDA graph launches nothing
then: the kernel runs each time the graph replays, with no Python. So
while the current stream captures, a wrapper adds its launch to the
capture's tally instead (``count``), and the code that replays the graph
adds that tally once a replay (``replayed``). A capture that no
``recording()`` watches, as a timing loop's, counts nothing, and neither
do its replays.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Counter, Iterator, List, Tuple

import torch

# add(kernel, n) adds n launches of `kernel` to a wrapper's counts.
AddFn = Callable[[str, int], None]
Tally = Counter[Tuple[AddFn, str]]

_recordings: List[Tally] = []  # the captures being recorded, innermost last


@contextlib.contextmanager
def recording() -> Iterator[Tally]:
  """The tally of the kernel launches captured while the block runs."""
  tally: Tally = collections.Counter()
  _recordings.append(tally)
  try:
    yield tally
  finally:
    _recordings.remove(tally)


def count(add: AddFn, kernel: str) -> None:
  """One launch of `kernel`: counted now, or, while the current stream
  captures a graph, tallied for that graph's replays."""
  if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
    if _recordings:
      _recordings[-1][(add, kernel)] += 1
    return
  add(kernel, 1)


def replayed(tally: Tally, times: int = 1) -> None:
  """Counts the launches of `times` replays of a graph with `tally`."""
  for (add, kernel), n in tally.items():
    add(kernel, n * times)
