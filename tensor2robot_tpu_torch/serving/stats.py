"""Serving observability: latency histograms and batching counters.

Counterpart of ``tensor2robot_tpu/serving/stats.py``, the same code: per
request latency p50/p99, queue depth at flush, batch occupancy (real
requests over the bucket slots they occupied) and padding waste, each
also kept per SLO class (latency and sheds split by reason). Every record
also flows into the metric registry under ``serving/...`` names, so the
registry holds process-lifetime totals however many windowed
``ServingStats`` come and go. Percentiles are the registry's nearest rank.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional

from tensor2robot_tpu_torch.obs import registry as registry_lib
from tensor2robot_tpu_torch.obs.registry import _nearest_rank


class LatencyHistogram:
  """Bounded reservoir of latency samples with percentile readout."""

  def __init__(self, max_samples: int = 16384):
    self._samples: collections.deque = collections.deque(maxlen=max_samples)
    self._lock = threading.Lock()

  def record(self, latency_ms: float) -> None:
    with self._lock:
      self._samples.append(float(latency_ms))

  def percentile(self, pct: float) -> Optional[float]:
    with self._lock:
      if not self._samples:
        return None
      ordered = sorted(self._samples)
    return _nearest_rank(ordered, pct)

  def summary(self, digits: int = 3) -> Dict[str, float]:
    with self._lock:
      samples = list(self._samples)
    if not samples:
      return {"count": 0}
    ordered = sorted(samples)

    def at(pct):
      return round(_nearest_rank(ordered, pct), digits)

    return {
        "count": len(samples),
        "p50_ms": at(50),
        "p90_ms": at(90),
        "p99_ms": at(99),
        "max_ms": round(ordered[-1], digits),
        "mean_ms": round(sum(samples) / len(samples), digits),
    }


class QSketch:
  """Streaming quantile sketch of one replica's served Q-values: a bounded
  reservoir for the statistics, which describe what the replica serves
  now, and an exact lifetime ``count``."""

  __slots__ = ("_samples", "_count", "_lock")

  def __init__(self, max_samples: int = 4096):
    self._samples: collections.deque = collections.deque(
        maxlen=max_samples)
    self._count = 0
    self._lock = threading.Lock()

  def record_many(self, values) -> None:
    with self._lock:
      for value in values:
        self._samples.append(float(value))
        self._count += 1

  def summary(self, digits: int = 6) -> Dict[str, float]:
    """{count, p50, p90, mean, min, max}; all but ``count`` over the
    retained reservoir."""
    with self._lock:
      samples = list(self._samples)
      count = self._count
    if not samples:
      return {"count": 0, "p50": None}
    ordered = sorted(samples)
    return {
        "count": count,
        "p50": round(_nearest_rank(ordered, 50), digits),
        "p90": round(_nearest_rank(ordered, 90), digits),
        "mean": round(sum(samples) / len(samples), digits),
        "min": round(ordered[0], digits),
        "max": round(ordered[-1], digits),
    }


class _ClassStats:
  """Per-SLO-class counters (guarded by the owning ServingStats lock)."""

  __slots__ = ("requests", "shed_expired", "shed_capacity", "shed_fault",
               "latency")

  def __init__(self):
    self.requests = 0
    self.shed_expired = 0
    self.shed_capacity = 0
    self.shed_fault = 0
    self.latency = LatencyHistogram()


class ServingStats:
  """Thread-safe counters for the micro-batching serving path.

  An instance is a windowed view (a bench makes a fresh one for each
  sweep point); every record also goes to ``registry`` (default: the
  process registry; tests pass their own ``MetricRegistry()``).
  """

  def __init__(self,
               registry: Optional[registry_lib.MetricRegistry] = None):
    self._lock = threading.Lock()
    self._registry = registry or registry_lib.get_registry()
    self.latency = LatencyHistogram()
    self._requests = 0
    self._logical_requests = 0
    self._flushes = 0
    self._occupied_slots = 0   # real requests summed over flushes
    self._padded_slots = 0     # bucket sizes summed over flushes
    self._deadline_flushes = 0  # flushed by a deadline, not a full batch
    self._queue_depth_sum = 0   # queue depth left behind at flush time
    self._per_class: Dict[str, _ClassStats] = {}
    self._q_sketches: Dict[str, QSketch] = {}

  def _class(self, class_name: Optional[str]) -> Optional[_ClassStats]:
    """The class's bucket, made at first use; the caller holds the lock."""
    if class_name is None:
      return None
    stats = self._per_class.get(class_name)
    if stats is None:
      stats = self._per_class[class_name] = _ClassStats()
    return stats

  def record_request(self, class_name: Optional[str] = None) -> None:
    with self._lock:
      self._requests += 1
      cls = self._class(class_name)
      if cls is not None:
        cls.requests += 1
    self._registry.counter("serving/requests").inc()
    # Class-less traffic counts under "default", the key record_shed
    # uses, so per-class shed rates always have a denominator.
    self._registry.counter(
        f"serving/class/{class_name or 'default'}/requests").inc()

  def record_logical_request(self) -> None:
    """One logical request at a router's front door: counted once a
    submit, however many dispatch attempts (``record_request``) its
    retries take."""
    with self._lock:
      self._logical_requests += 1
    self._registry.counter("serving/logical_requests").inc()

  def record_shed(self, class_name: Optional[str], reason: str) -> None:
    """One shed request ("expired", "capacity" or "fault"), counted on
    top of its record_request: a shed request was offered load too."""
    with self._lock:
      cls = self._class(class_name or "default")
      if reason == "expired":
        cls.shed_expired += 1
      elif reason == "capacity":
        cls.shed_capacity += 1
      elif reason == "fault":
        cls.shed_fault += 1
      else:
        raise ValueError(f"unknown shed reason {reason!r}")
    self._registry.counter(f"serving/shed_{reason}").inc()
    self._registry.counter(
        f"serving/class/{class_name or 'default'}/shed_{reason}").inc()

  def record_q_values(self, replica: str, values) -> None:
    """Served Q-scores of one replica dispatch: its sketch and the
    registry histogram ``serving/replica/<replica>/q_value``."""
    with self._lock:
      sketch = self._q_sketches.get(replica)
      if sketch is None:
        sketch = self._q_sketches[replica] = QSketch()
    sketch.record_many(values)
    hist = self._registry.histogram(
        f"serving/replica/{replica}/q_value")
    for value in values:
      hist.record(float(value))

  def q_sketch_summaries(self) -> Dict[str, Dict[str, float]]:
    """{replica: sketch summary}."""
    with self._lock:
      sketches = dict(self._q_sketches)
    return {replica: sketch.summary()
            for replica, sketch in sorted(sketches.items())}

  def record_flush(self, batch_size: int, bucket: int,
                   queue_depth_after: int, deadline_expired: bool) -> None:
    with self._lock:
      self._flushes += 1
      self._occupied_slots += int(batch_size)
      self._padded_slots += int(bucket)
      self._queue_depth_sum += int(queue_depth_after)
      if deadline_expired:
        self._deadline_flushes += 1

  def record_latency_ms(self, latency_ms: float,
                        class_name: Optional[str] = None) -> None:
    self.latency.record(latency_ms)
    self._registry.histogram("serving/latency_ms").record(latency_ms)
    if class_name is not None:
      with self._lock:
        hist = self._class(class_name).latency
      hist.record(latency_ms)
      self._registry.histogram(
          f"serving/class/{class_name}/latency_ms").record(latency_ms)

  def snapshot(self) -> Dict[str, float]:
    """Counters, derived ratios and latency percentiles, with a
    ``per_class`` dict keyed by SLO class (empty without class-tagged
    traffic) and ``q_sketches`` when any were recorded."""
    with self._lock:
      flushes = self._flushes
      out = {
          "requests": self._requests,
          "logical_requests": self._logical_requests,
          "flushes": flushes,
          "deadline_flushes": self._deadline_flushes,
          "batch_occupancy": round(
              self._occupied_slots / self._padded_slots, 4)
          if self._padded_slots else None,
          "padding_waste": round(
              1.0 - self._occupied_slots / self._padded_slots, 4)
          if self._padded_slots else None,
          "mean_batch_size": round(self._occupied_slots / flushes, 3)
          if flushes else None,
          "mean_queue_depth_after_flush": round(
              self._queue_depth_sum / flushes, 3) if flushes else None,
      }
      # Built under the lock, so the classes' sheds sum to shed_total in
      # one snapshot (lock order ServingStats -> LatencyHistogram only).
      per_class = {name: self._class_snapshot(cls)
                   for name, cls in sorted(self._per_class.items())}
      shed_total = sum(entry["shed"] for entry in per_class.values())
    out["shed_total"] = shed_total
    for key, value in self.latency.summary().items():
      out["latency_" + key if not key.startswith("count") else
          "latency_samples"] = value
    out["per_class"] = per_class
    q_sketches = self.q_sketch_summaries()
    if q_sketches:
      out["q_sketches"] = q_sketches
    return out

  @staticmethod
  def _class_snapshot(cls: _ClassStats) -> Dict[str, float]:
    shed = cls.shed_expired + cls.shed_capacity + cls.shed_fault
    entry = {
        "requests": cls.requests,
        "shed": shed,
        "shed_expired": cls.shed_expired,
        "shed_capacity": cls.shed_capacity,
        "shed_fault": cls.shed_fault,
        "shed_rate": round(shed / cls.requests, 4) if cls.requests else 0.0,
    }
    for key, value in cls.latency.summary().items():
      entry["latency_" + key if not key.startswith("count") else
            "latency_samples"] = value
    return entry

  def write_to(self, metric_writer, step: int,
               prefix: str = "serving/") -> None:
    """The snapshot's numeric fields through a MetricWriter, per-class
    fields as ``{prefix}class/{name}/{field}``, in one write_scalars."""
    snap = self.snapshot()
    scalars = {prefix + k: v for k, v in snap.items()
               if isinstance(v, (int, float)) and v is not None}
    for name, entry in snap.get("per_class", {}).items():
      scalars.update({
          f"{prefix}class/{name}/{k}": v for k, v in entry.items()
          if isinstance(v, (int, float)) and v is not None})
    metric_writer.write_scalars(step, scalars)
