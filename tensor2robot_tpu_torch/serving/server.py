"""FleetServer: micro-batcher + bucketed fleet policy + observability.

Counterpart of ``tensor2robot_tpu/serving/server.py``, the single replica:
N clients call ``submit(image)`` (or the blocking ``act``) from their own
threads; the dispatcher flushes their frames into one ``CEMFleetPolicy``
call a batch, padded to the bucket ladder (one CUDA graph a rung on the
GPU), and every request's latency lands in the stats histograms.

The policy runs on the batcher's dispatcher thread. On the GPU, build
every rung before clients start (``CEMFleetPolicy.warm``), as
``bin/bench_serving`` does: a capture then never races another thread's
launches, and a flush only replays.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Optional

import numpy as np

from tensor2robot_tpu_torch.obs import context as context_lib
from tensor2robot_tpu_torch.serving.batcher import MicroBatcher
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.serving.stats import ServingStats


class FleetServer:
  """Serves one CEMFleetPolicy to many concurrent clients."""

  def __init__(self, policy: CEMFleetPolicy,
               max_batch: Optional[int] = None,
               deadline_ms: float = 5.0,
               stats: Optional[ServingStats] = None,
               metric_writer=None):
    """Args:
      policy: the batched control step (owns the bucket ladder).
      max_batch: flush threshold; defaults to the ladder's top rung and
        must not exceed it.
      deadline_ms: the longest the oldest queued frame waits before a
        partial flush (the lone robot's budget).
      stats: shared ServingStats (one is made if not given).
      metric_writer: optional ``utils.metric_writer.MetricWriter`` that
        ``write_metrics(step)`` routes snapshots through.
    """
    max_batch = policy.ladder.max_batch if max_batch is None else max_batch
    if max_batch > policy.ladder.max_batch:
      raise ValueError(
          f"max_batch {max_batch} exceeds ladder top rung "
          f"{policy.ladder.max_batch}")
    self._policy = policy
    self.stats = stats or ServingStats()
    self._metric_writer = metric_writer
    self._metric_step = 0
    self._batcher = MicroBatcher(
        self._flush, max_batch=max_batch, deadline_ms=deadline_ms,
        stats=self.stats, bucket_for=policy.ladder.bucket_for)

  # -- lifecycle -----------------------------------------------------------

  def start(self) -> "FleetServer":
    self._batcher.start()
    return self

  def stop(self) -> None:
    self._batcher.stop()

  def __enter__(self) -> "FleetServer":
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.stop()

  # -- client API ----------------------------------------------------------

  def submit(self, image, slo=None) -> Future:
    """Enqueues one camera frame; resolves to its (action_size,) action.
    The request's seed comes from ``policy.assign_seeds`` here, and a
    correlation id is minted here (the ingress); `slo` overrides the
    default deadline class."""
    seed = int(self._policy.assign_seeds(1)[0])
    return self._batcher.submit((np.asarray(image), seed), slo=slo,
                                request_id=context_lib.new_request_id())

  def act(self, image, timeout: Optional[float] = None,
          slo=None) -> np.ndarray:
    """Blocking control step: the closed-loop client call."""
    return self.submit(image, slo=slo).result(timeout)

  @property
  def batcher(self) -> MicroBatcher:
    """The micro-batcher (``hold_flushes`` for deterministic bursts)."""
    return self._batcher

  # -- internals / observability ------------------------------------------

  def _flush(self, items):
    images = [item[0] for item in items]
    seeds = np.asarray([item[1] for item in items], np.uint32)
    actions = self._policy(images, seeds)
    return list(actions)

  def snapshot(self) -> dict:
    """Stats snapshot + the built-programs ledger."""
    out = self.stats.snapshot()
    out["executable_buckets"] = list(self._policy.executable_buckets)
    out["compile_counts"] = dict(self._policy.compile_counts)
    return out

  def write_metrics(self, step: Optional[int] = None) -> None:
    if self._metric_writer is None:
      return
    if step is None:
      step = self._metric_step
      self._metric_step += 1
    self.stats.write_to(self._metric_writer, step)
