"""Process-wide typed metric registry: counters, gauges, histograms.

Counterpart of ``tensor2robot_tpu/obs/registry.py``, the same code. Every
subsystem counts through one namespace; the port's
``utils.metric_writer.MetricWriter`` (JSONL and TensorBoard) stays the
dashboard, and ``flush_to`` is the one bridge into it.

Types are enforced: ``counter("x")`` after ``gauge("x")`` raises. A
histogram is a bounded reservoir (the newest ``max_samples``) with
nearest-rank percentiles (``_nearest_rank``), the convention
``serving.stats`` shares.
"""

from __future__ import annotations

import collections
import json
import math
import os
import socket
import threading
from typing import Dict, Iterable, Mapping, Optional

# Schema tag of on-disk registry snapshots (one a process; the JAX
# package's fleet aggregator reads them).
SNAPSHOT_SCHEMA = "t2r-registry-1"


def _nearest_rank(ordered, pct: float) -> float:
  rank = min(len(ordered) - 1,
             max(0, math.ceil(pct / 100.0 * len(ordered)) - 1))
  return ordered[rank]


class Counter:
  """Monotonic process-lifetime count."""

  __slots__ = ("name", "_value", "_lock")

  def __init__(self, name: str):
    self.name = name
    self._value = 0
    self._lock = threading.Lock()

  def inc(self, n: int = 1) -> int:
    with self._lock:
      self._value += n
      return self._value

  @property
  def value(self) -> int:
    with self._lock:
      return self._value


class Gauge:
  """Last-write-wins scalar."""

  __slots__ = ("name", "_value", "_lock")

  def __init__(self, name: str):
    self.name = name
    self._value: Optional[float] = None
    self._lock = threading.Lock()

  def set(self, value: float) -> None:
    with self._lock:
      self._value = float(value)

  @property
  def value(self) -> Optional[float]:
    with self._lock:
      return self._value


class Histogram:
  """Bounded reservoir (newest max_samples) with percentile snapshots."""

  __slots__ = ("name", "_samples", "_count", "_lock")

  def __init__(self, name: str, max_samples: int = 16384):
    self.name = name
    self._samples: collections.deque = collections.deque(maxlen=max_samples)
    self._count = 0
    self._lock = threading.Lock()

  def record(self, value: float) -> None:
    with self._lock:
      self._samples.append(float(value))
      self._count += 1

  def samples(self) -> list:
    """The retained reservoir: what a cross-process merge unions before
    one nearest-rank pass."""
    with self._lock:
      return list(self._samples)

  @property
  def count(self) -> int:
    """Samples ever recorded (the reservoir may have dropped the oldest)."""
    with self._lock:
      return self._count

  def snapshot(self, digits: int = 4) -> Dict[str, float]:
    with self._lock:
      samples = list(self._samples)
      count = self._count
    if not samples:
      return {"count": 0}
    ordered = sorted(samples)
    return {
        "count": count,
        "p50": round(_nearest_rank(ordered, 50), digits),
        "p90": round(_nearest_rank(ordered, 90), digits),
        "p99": round(_nearest_rank(ordered, 99), digits),
        "max": round(ordered[-1], digits),
        "mean": round(sum(samples) / len(samples), digits),
    }


class MetricRegistry:
  """Typed name -> metric map with one MetricWriter bridge."""

  def __init__(self):
    self._metrics: Dict[str, object] = {}
    self._lock = threading.Lock()

  def _get(self, name: str, kind):
    with self._lock:
      metric = self._metrics.get(name)
      if metric is None:
        metric = self._metrics[name] = kind(name)
      elif not isinstance(metric, kind):
        raise TypeError(
            f"metric {name!r} is a {type(metric).__name__}, not a "
            f"{kind.__name__} — one name, one type")
      return metric

  def counter(self, name: str) -> Counter:
    return self._get(name, Counter)

  def gauge(self, name: str) -> Gauge:
    return self._get(name, Gauge)

  def histogram(self, name: str) -> Histogram:
    return self._get(name, Histogram)

  def set_gauges(self, scalars: Mapping[str, float]) -> None:
    """Sets one gauge a key (a loop's metric block); None values skip."""
    for name, value in scalars.items():
      if value is None:
        continue
      self.gauge(name).set(value)

  def names(self) -> Iterable[str]:
    with self._lock:
      return sorted(self._metrics)

  def snapshot(self, names: Optional[Iterable[str]] = None
               ) -> Dict[str, float]:
    """Flat scalars: counters and gauges by name, histograms as
    ``name/p50`` ... ``name/count``. ``names`` restricts the view before
    any reservoir is sorted."""
    with self._lock:
      metrics = dict(self._metrics)
    if names is not None:
      wanted = set(names)
      metrics = {name: metric for name, metric in metrics.items()
                 if name in wanted}
    out: Dict[str, float] = {}
    for name, metric in sorted(metrics.items()):
      if isinstance(metric, Histogram):
        for key, value in metric.snapshot().items():
          out[f"{name}/{key}"] = value
      else:
        value = metric.value
        if value is not None:
          out[name] = value
    return out

  def export_snapshot(self, path: str,
                      host: Optional[str] = None) -> str:
    """Writes this process's registry for a fleet merge (tmp then rename):
    counter and gauge values and each histogram's raw reservoir, stamped
    with host (``host`` overrides the hostname) and pid."""
    with self._lock:
      metrics = dict(self._metrics)
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    histograms: Dict[str, dict] = {}
    for name, metric in sorted(metrics.items()):
      if isinstance(metric, Counter):
        counters[name] = metric.value
      elif isinstance(metric, Gauge):
        if metric.value is not None:
          gauges[name] = metric.value
      elif isinstance(metric, Histogram):
        histograms[name] = {"count": metric.count,
                            "samples": metric.samples()}
    payload = {
        "schema": SNAPSHOT_SCHEMA,
        "host": host or socket.gethostname(),
        "pid": os.getpid(),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(payload, f)
    os.replace(tmp, path)
    return path

  def flush_to(self, metric_writer, step: int,
               names: Optional[Iterable[str]] = None,
               prefix: str = "") -> None:
    """The bridge: one ``write_scalars`` call a flush. ``names`` restricts
    it to those metrics (a loop passes the block it just set, so its JSONL
    records keep their schema); None flushes everything."""
    snap = self.snapshot(names=names)
    scalars = {prefix + key: value for key, value in snap.items()
               if isinstance(value, (int, float))}
    if scalars:
      metric_writer.write_scalars(step, scalars)


_DEFAULT: Optional[MetricRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricRegistry:
  """The process-wide registry every wired component emits through."""
  global _DEFAULT
  with _DEFAULT_LOCK:
    if _DEFAULT is None:
      _DEFAULT = MetricRegistry()
    return _DEFAULT
