"""Default input generators: random (mock stack) and TFRecord-backed.

Counterpart of ``tensor2robot_tpu/data/default_input_generator.py``: the
same seed gives the same batches, bit for bit. The record generators read
TFRecord files on a reader thread (shuffling with the JAX package's
``default_rng`` draws), parse on a thread pool and hand out ordered,
bounded batches. They parse in Python: the port has no native parser
(``data/parser.py``), so ``native_mode="auto"`` and ``"python"`` mean the
same, and ``"native"`` raises.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import queue
import sys
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Batch,
)
from tensor2robot_tpu_torch.data.parser import ExampleParser
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

TRAIN = modes.TRAIN
_NATIVE_MODES = ("auto", "python")


def _native_mode_stats(native_mode: str) -> Dict:
  """`pipeline_stats` of a record pipeline: which parser runs. Raises on
  any mode but the Python parser's."""
  if native_mode == "native":
    raise ValueError(
        "native_mode='native': the port has no native parser; use 'auto' "
        "or 'python' (both parse in Python).")
  if native_mode not in _NATIVE_MODES:
    raise ValueError(
        f"native_mode must be one of {_NATIVE_MODES}, got {native_mode!r}")
  return {"native_calibration": {
      "decision": "python", "reason": f"native_mode={native_mode!r}: the "
                                      "port parses in Python"}}


def _pipelined_parse(
    record_stream: Iterator[bytes],
    parser: ExampleParser,
    batch_size: int,
    num_threads: int,
    prefetch_batches: int,
) -> Iterator[Batch]:
  """Reader thread + parse pool → ordered, bounded stream of parsed batches.

  Shutdown contract: abandoning the returned iterator (close/GC) stops the
  reader thread and parse pool promptly: every blocking put uses a timeout
  loop against the stop event, so no thread can leak blocked on a full
  queue.
  """
  stop = threading.Event()
  sentinel = object()
  # Bounded queue of *futures* preserves batch order while the pool parses
  # up to num_threads batches concurrently.
  futures: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_batches))
  pool = concurrent.futures.ThreadPoolExecutor(
      max_workers=max(1, num_threads), thread_name_prefix="t2r-parse")

  def put_checked(item) -> bool:
    while not stop.is_set():
      try:
        futures.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def reader() -> None:
    try:
      while not stop.is_set():
        records = list(itertools.islice(record_stream, batch_size))
        if len(records) < batch_size:
          # drop_remainder semantics: static shapes only.
          break
        if not put_checked(pool.submit(parser.parse_batch, records)):
          return
    except Exception as e:  # reader-side errors surface to the consumer
      put_checked(e)
      return
    put_checked(sentinel)

  thread = threading.Thread(target=reader, daemon=True, name="t2r-reader")
  thread.start()

  # Bound at definition time: during late interpreter shutdown, module
  # globals (`sys` included) may already be cleared when the finalizer
  # below runs, and the guard itself must not throw.
  is_finalizing = sys.is_finalizing

  def iterator() -> Iterator[Batch]:
    try:
      while True:
        item = futures.get()
        if item is sentinel:
          return
        if isinstance(item, Exception):
          raise item
        yield item.result()  # re-raises parse errors with traceback
    finally:
      stop.set()
      # When an ABANDONED iterator is finalized at interpreter exit, do
      # NOT touch the queue or the pool: finalization kills daemon
      # threads at their next GIL acquisition, so the reader can die
      # holding the futures-queue mutex or (inside pool.submit) the
      # executor's _shutdown_lock — and get_nowait()/pool.shutdown()
      # here would futex-wait on a poisoned lock forever, wedging the
      # exiting process (main thread stuck in
      # ThreadPoolExecutor.shutdown). The threads cannot outlive the
      # process; stop.set() is enough.
      if not is_finalizing():
        # Unblock a reader stuck between put attempts and let the pool
        # die promptly on ordinary mid-run abandonment. Both drains are
        # best-effort (except Exception: a racing reader may refill the
        # queue between get_nowait calls).
        try:
          while True:
            futures.get_nowait()
        except Exception:
          pass
        try:
          pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
          pass

  return iterator()


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


class DefaultRecordInputGenerator(AbstractInputGenerator):
  """TFRecord-backed batches: read → parse → decode → batch, host-side.

  The pipeline runs on host Python threads with a bounded batch queue.
  Files are sharded round-robin across hosts before shuffling (the
  per-host input_fn contract).

  Args:
    file_patterns: comma-separated glob patterns of TFRecord files.
    shuffle_buffer_size: record-level shuffle window (train mode only).
    num_pipeline_threads: background parse/decode threads.
    prefetch_batches: bounded queue depth between parser and consumer.
    native_mode: "auto" (the default) or "python": both parse in Python,
      as `pipeline_stats` records; "native" raises.
  """

  def __init__(
      self,
      file_patterns: str,
      shuffle_buffer_size: int = 1024,
      num_pipeline_threads: int = 4,
      prefetch_batches: int = 4,
      seed: int = 0,
      native_mode: str = "auto",
      **kwargs,
  ):
    super().__init__(**kwargs)
    _native_mode_stats(native_mode)
    self._file_patterns = file_patterns
    self._shuffle_buffer_size = shuffle_buffer_size
    self._num_pipeline_threads = max(1, num_pipeline_threads)
    self._prefetch_batches = max(1, prefetch_batches)
    self._seed = seed
    self._native_mode = native_mode
    # Stats of the most recently created pipeline (which parser runs).
    self.pipeline_stats: Dict = {}

  def _shard_files(self) -> List[str]:
    files = tfrecord.list_files(self._file_patterns)
    shard = files[self._shard_index::self._num_shards]
    if not shard:
      raise ValueError(
          f"Host shard {self._shard_index}/{self._num_shards} got no files "
          f"out of {len(files)}; need at least one file per host.")
    return shard

  def _record_stream(self, mode: str) -> Iterator[bytes]:
    """Infinite (train) or single-pass (eval) stream of raw records."""
    files = self._shard_files()
    rng = np.random.default_rng(self._seed + 7919 * self._shard_index)
    epoch = itertools.count()
    for _ in (epoch if mode == TRAIN else range(1)):
      order = list(files)
      if mode == TRAIN:
        rng.shuffle(order)
      if mode == TRAIN and self._shuffle_buffer_size > 1:
        buffer: List[bytes] = []
        for path in order:
          for record in tfrecord.read_tfrecords(path):
            buffer.append(record)
            if len(buffer) >= self._shuffle_buffer_size:
              idx = rng.integers(len(buffer))
              buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
              yield buffer.pop()
        rng.shuffle(buffer)
        yield from buffer
      else:
        for path in order:
          yield from tfrecord.read_tfrecords(path)

  def _create_iterator(self, mode: str) -> Iterator[Batch]:
    parser = ExampleParser(self.feature_spec, self.label_spec)
    self.pipeline_stats = _native_mode_stats(self._native_mode)
    return _pipelined_parse(
        record_stream=self._record_stream(mode),
        parser=parser,
        batch_size=self._batch_size,
        num_threads=self._num_pipeline_threads,
        prefetch_batches=self._prefetch_batches,
    )


class FractionalRecordInputGenerator(DefaultRecordInputGenerator):
  """Trains on the first `file_fraction` of the (sorted) file list.

  For data-efficiency ablations.
  """

  def __init__(self, file_patterns: str, file_fraction: float = 1.0,
               **kwargs):
    if not 0.0 < file_fraction <= 1.0:
      raise ValueError(f"file_fraction must be in (0, 1], got {file_fraction}")
    super().__init__(file_patterns, **kwargs)
    self._file_fraction = file_fraction

  def _shard_files(self) -> List[str]:
    files = tfrecord.list_files(self._file_patterns)
    keep = max(1, int(round(self._file_fraction * len(files))))
    files = files[:keep]
    shard = files[self._shard_index::self._num_shards]
    if not shard:
      raise ValueError(
          f"Host shard {self._shard_index}/{self._num_shards} got no files "
          f"after fraction {self._file_fraction} of {len(files)}.")
    return shard


class WeightedRecordInputGenerator(AbstractInputGenerator):
  """Samples each batch element from one of several datasets by weight.

  Multi-dataset mixing (e.g. real robot data + sim data at a tuned ratio).
  """

  def __init__(
      self,
      file_patterns: Sequence[str],
      weights: Optional[Sequence[float]] = None,
      seed: int = 0,
      native_mode: str = "auto",
      **kwargs,
  ):
    super().__init__(**kwargs)
    _native_mode_stats(native_mode)
    self._native_mode = native_mode
    self.pipeline_stats: Dict = {}
    if weights is None:
      weights = [1.0] * len(file_patterns)
    if len(weights) != len(file_patterns):
      raise ValueError(
          f"{len(file_patterns)} datasets but {len(weights)} weights")
    total = float(sum(weights))
    if total <= 0:
      raise ValueError("weights must sum to a positive value")
    self._probs = [w / total for w in weights]
    self._seed = seed
    self._sources = [
        DefaultRecordInputGenerator(
            fp, seed=seed + i, batch_size=self._batch_size,
            shard_index=self._shard_index, num_shards=self._num_shards)
        for i, fp in enumerate(file_patterns)
    ]

  def set_specification(self, feature_spec, label_spec=None) -> None:
    super().set_specification(feature_spec, label_spec)
    for source in self._sources:
      source.set_specification(feature_spec, label_spec)

  def _create_iterator(self, mode: str) -> Iterator[Batch]:
    rng = np.random.default_rng(self._seed + 7919 * self._shard_index)
    # Per-element mixing: draw each record's source by weight, so every
    # batch is a weight-proportioned mixture (batch statistics match the
    # target ratio, unlike per-batch source picking).
    streams = [s._record_stream(mode) for s in self._sources]

    def mixed_records() -> Iterator[bytes]:
      live = list(range(len(streams)))
      while live:
        probs = np.array([self._probs[i] for i in live])
        choice = live[int(rng.choice(len(live), p=probs / probs.sum()))]
        try:
          yield next(streams[choice])
        except StopIteration:
          live.remove(choice)

    parser = ExampleParser(self.feature_spec, self.label_spec)
    self.pipeline_stats = _native_mode_stats(self._native_mode)
    return _pipelined_parse(
        record_stream=mixed_records(),
        parser=parser,
        batch_size=self._batch_size,
        num_threads=self._sources[0]._num_pipeline_threads,
        prefetch_batches=self._sources[0]._prefetch_batches,
    )
