"""Host-to-device prefetch: the next batches copy while the device computes.

Counterpart of ``tensor2robot_tpu/data/prefetch.py``. On a CUDA device each
host batch is staged in pinned memory and copied with ``non_blocking=True``
on a side stream, with `depth` batches in flight; the stream that takes a
batch waits on that batch's copy event before anything uses it. On the CPU
a batch becomes tensors and nothing is in flight.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.utils.tree import tree_map


class PrefetchExhausted(Exception):
  """The host iterator ended and every in-flight batch has been yielded.

  Raised instead of a bare StopIteration when the consumer passed
  ``exhaust_error=True``.
  """

  def __init__(self, name: str, batches: int):
    super().__init__(
        f"prefetch stream {name!r} exhausted after {batches} batches")
    self.name = name
    self.batches = batches


def prefetch_to_device(
    iterator: Iterator[Any],
    device: Device = None,
    depth: int = 2,
    name: str = "prefetch",
    exhaust_error: bool = False,
) -> Iterator[Any]:
  """Yields host batches as tensors on `device`, `depth` copies in flight.

  Args:
    iterator: host iterator of batches: nested structures of numpy arrays,
      e.g. the (features, labels) pairs input generators yield.
    device: where the batches go; the GPU unless 'cpu' is asked for.
    depth: batches copied ahead of the consumer. 2 = double buffering.
    name: the stream's name in `PrefetchExhausted`.
    exhaust_error: raise `PrefetchExhausted` after the last batch instead
      of ending with StopIteration.
  """
  if depth < 1:
    raise ValueError(f"depth must be >= 1, got {depth}")
  device = resolve_device(device)
  copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                 else None)

  def push(batch: Any):
    host = tree_map(lambda a: torch.from_numpy(np.array(a)), batch)
    if copy_stream is None:
      return host, None
    host = tree_map(lambda t: t.pin_memory(), host)
    with torch.cuda.stream(copy_stream):
      moved = tree_map(lambda t: t.to(device, non_blocking=True), host)
      done = torch.cuda.Event()
      done.record(copy_stream)
    # The pinned tensors stay referenced until the copy has been waited on.
    return moved, (done, host)

  def pop(entry) -> Any:
    moved, pending = entry
    if pending is not None:
      compute = torch.cuda.current_stream(device)
      compute.wait_event(pending[0])
      # The copy stream allocated these; tell the allocator the compute
      # stream uses them, so it reuses none before that use is done.
      tree_map(lambda t: t.record_stream(compute), moved)
    return moved

  buffer: collections.deque = collections.deque()
  yielded = 0
  for batch in iterator:
    buffer.append(push(batch))
    if len(buffer) >= depth:
      yielded += 1
      yield pop(buffer.popleft())
  while buffer:
    yielded += 1
    yield pop(buffer.popleft())
  if exhaust_error:
    raise PrefetchExhausted(name, yielded)
