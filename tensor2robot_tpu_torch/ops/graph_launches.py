"""Kernel launch counts through CUDA graphs.

Each kernel wrapper adds one to its count where it launches its kernel. A
launch recorded while a stream captures a CUDA graph launches nothing
then: the kernel runs each time the graph replays, with no Python. So
while the current stream captures, a wrapper adds its launch to the
capture's tally instead (``count``), and the code that replays the graph
adds that tally once a replay (``replayed``). A capture that no
``recording()`` watches, as a timing loop's, counts nothing, and neither
do its replays.

``capture`` is how the port captures a graph: recorded, in the
thread-local capture mode (other threads keep launching on their own
streams), with the cyclic garbage collector run before and paused until
the capture ends. An unreachable graph of an earlier capture that sits in
a reference cycle is destroyed whenever the collector runs, and
destroying a graph while a stream captures invalidates that capture.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
from typing import Callable, Counter, Iterator, List, Tuple

import torch

# add(kernel, n) adds n launches of `kernel` to a wrapper's counts.
AddFn = Callable[[str, int], None]
Tally = Counter[Tuple[AddFn, str]]

_recordings: List[Tally] = []  # the captures being recorded, innermost last
# The collector is process-wide: captures open on any thread share one
# pause, and the last to close restores it.
_pause_lock = threading.Lock()
_captures_open = 0
_collector_was_enabled = True


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


@contextlib.contextmanager
def _collector_paused() -> Iterator[None]:
  global _captures_open, _collector_was_enabled
  with _pause_lock:
    if not _captures_open:
      gc.collect()
      _collector_was_enabled = gc.isenabled()
      gc.disable()
    _captures_open += 1
  try:
    yield
  finally:
    with _pause_lock:
      _captures_open -= 1
      if not _captures_open and _collector_was_enabled:
        gc.enable()


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph",
            stream: "torch.cuda.Stream", pool=None) -> Iterator[Tally]:
  """Captures the block's work on `stream` into `graph`; yields the tally
  of its kernel launches (see the module's docstring). `pool` (a
  ``torch.cuda.graph_pool_handle()``) shares one memory pool among graphs
  that never replay at the same time."""
  with _collector_paused(), recording() as tally:
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
      yield tally
