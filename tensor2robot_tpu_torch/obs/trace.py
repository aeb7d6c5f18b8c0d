"""Host-side structured spans for the whole production loop.

Counterpart of ``tensor2robot_tpu/obs/trace.py``. ``span("learn/megastep",
**attrs)`` is a thread-safe, nestable context manager; completed spans land
in a bounded ring, exportable as one Chrome-trace JSON a run
(``Tracer.export_chrome_trace``). Span names are ``stage/detail``; the
stage (``act``, ``extend``, ``learn``, ``serve``, ``replay``) is what
``stage_counts()`` aggregates.

While a guarded profiler window is open (``utils.profiling``), a span also
enters ``torch.profiler.record_function(name)``, where the JAX span enters
``jax.profiler.TraceAnnotation``, so host spans line up against the
card's kernels in the same trace. Outside a window a span costs two
``perf_counter`` reads and one deque append. A span never synchronizes
the device: it measures the host's time, the enqueue under CUDA's
asynchronous launches, as the JAX span does under async dispatch.

Listeners (``add_listener``) receive every completed span record; the
flight recorder subscribes. Spans completed while ``obs.context`` has ids
bound carry them, and the export links every request id seen on two or
more spans into one Perfetto flow.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from tensor2robot_tpu_torch.obs import context as context_lib

_log = logging.getLogger(__name__)


class Tracer:
  """Bounded ring of completed spans + per-thread nesting state."""

  def __init__(self, max_spans: int = 65536):
    self._epoch = time.perf_counter()
    self._spans: collections.deque = collections.deque(maxlen=max_spans)
    self._total = 0
    self._lock = threading.Lock()
    self._local = threading.local()
    self._listeners: List[Callable[[dict], None]] = []
    # Toggled by utils.profiling's guarded window: spans pay for
    # record_function only while a trace can see them.
    self.annotate_devices = False

  # -- recording -----------------------------------------------------------

  def _stack(self) -> list:
    stack = getattr(self._local, "stack", None)
    if stack is None:
      stack = self._local.stack = []
    return stack

  @contextlib.contextmanager
  def span(self, name: str, **attrs):
    """One nestable span; attrs must be JSON-serializable scalars."""
    stack = self._stack()
    parent = stack[-1] if stack else None
    depth = len(stack)
    stack.append(name)
    annotation = None
    if self.annotate_devices:
      import torch
      annotation = torch.profiler.record_function(name)
      annotation.__enter__()
    start = time.perf_counter()
    try:
      yield
    finally:
      duration = time.perf_counter() - start
      if annotation is not None:
        annotation.__exit__(None, None, None)
      stack.pop()
      record = {
          "name": name,
          "ts_s": round(start - self._epoch, 6),
          "dur_s": round(duration, 6),
          "tid": threading.get_ident(),
          "depth": depth,
      }
      if parent is not None:
        record["parent"] = parent
      context_attrs = context_lib.context_attrs()
      if context_attrs:
        record.update(context_attrs)
      if attrs:  # explicit attrs win over inherited context attrs
        record.update(attrs)
      with self._lock:
        self._spans.append(record)
        self._total += 1
      for listener in list(self._listeners):
        try:
          listener(record)
        except Exception:  # diagnostics must never crash the path
          _log.warning("span listener %r failed", listener,
                       exc_info=True)

  def add_listener(self, listener: Callable[[dict], None]) -> None:
    """Registers a completed-span callback (e.g. the flight recorder)."""
    with self._lock:
      if listener not in self._listeners:
        self._listeners.append(listener)

  def remove_listener(self, listener: Callable[[dict], None]) -> None:
    """Unsubscribes a listener; an unknown one is a no-op."""
    with self._lock:
      if listener in self._listeners:
        self._listeners.remove(listener)

  # -- readout -------------------------------------------------------------

  def spans(self) -> List[dict]:
    with self._lock:
      return list(self._spans)

  @property
  def total_spans(self) -> int:
    """Spans ever recorded (the ring may have dropped the oldest)."""
    with self._lock:
      return self._total

  def stage_counts(self) -> Dict[str, int]:
    """{first path segment of span name: count} over the retained ring."""
    counts: Dict[str, int] = {}
    for record in self.spans():
      stage = record["name"].split("/", 1)[0]
      counts[stage] = counts.get(stage, 0) + 1
    return counts

  def clear(self) -> None:
    with self._lock:
      self._spans.clear()
      self._total = 0

  def export_chrome_trace(self, path: str,
                          label: Optional[str] = None) -> str:
    """Writes the retained spans as Chrome-trace JSON (tmp then rename).

    Complete events ("ph": "X") in microseconds from this tracer's epoch,
    one row a thread; every request id carried by two or more spans also
    becomes one flow ("s"/"t"/"f" events sharing an id). ``label``
    overrides the ``host:pid`` process name. The process metadata carries
    ``epoch_wall_s``, the epoch on the wall clock, for a fleet merge.
    """
    retained = self.spans()
    pid = os.getpid()
    epoch_wall_s = time.time() - (time.perf_counter() - self._epoch)
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": label or f"{socket.gethostname()}:{pid}",
                 "epoch_wall_s": round(epoch_wall_s, 6)},
    }]
    by_request: Dict[str, list] = {}
    for record in retained:
      args = {key: value for key, value in record.items()
              if key not in ("name", "ts_s", "dur_s", "tid")}
      events.append({
          "name": record["name"],
          "ph": "X",
          "ts": round(record["ts_s"] * 1e6, 3),
          "dur": round(record["dur_s"] * 1e6, 3),
          "pid": pid,
          "tid": record["tid"],
          "args": args,
      })
      for request_id in context_lib.span_request_ids(record):
        by_request.setdefault(request_id, []).append(record)
    events.extend(request_flow_events(by_request, pid))
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(payload, f)
    os.replace(tmp, path)
    return path


def request_flow_events(by_request: Dict[str, list], pid: int,
                        flow_ids: Optional[Dict[str, int]] = None) -> list:
  """Perfetto flow events linking each request's spans in time order.

  ``by_request`` maps a request id to its span records; an id with fewer
  than two spans emits nothing. ``flow_ids`` keeps flow ids stable across
  several traces merged into one; a record's own ``pid`` overrides
  ``pid``.
  """
  flow_ids = {} if flow_ids is None else flow_ids
  events = []
  for request_id, records in sorted(by_request.items()):
    if len(records) < 2:
      continue
    flow_id = flow_ids.setdefault(request_id, len(flow_ids) + 1)
    ordered = sorted(records, key=lambda r: r["ts_s"])
    for index, record in enumerate(ordered):
      if index == 0:
        phase = "s"
      elif index == len(ordered) - 1:
        phase = "f"
      else:
        phase = "t"
      event = {
          "name": f"request {request_id}",
          "cat": "request",
          "ph": phase,
          "id": flow_id,
          # Inside the slice, not at its edge, so Perfetto binds the
          # arrow's end to the enclosing span.
          "ts": round((record["ts_s"] + record["dur_s"] / 2) * 1e6, 3),
          "pid": record.get("pid", pid),
          "tid": record["tid"],
      }
      if phase == "f":
        event["bp"] = "e"
      events.append(event)
  return events


_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def get_tracer() -> Tracer:
  """The process-wide tracer every wired component records into."""
  global _DEFAULT
  with _DEFAULT_LOCK:
    if _DEFAULT is None:
      _DEFAULT = Tracer()
    return _DEFAULT


def span(name: str, **attrs):
  """``with obs.trace.span("learn/megastep", k=10): ...``"""
  return get_tracer().span(name, **attrs)


def set_device_annotations(enabled: bool) -> None:
  """Turns record_function ranges on or off for the process tracer (the
  guarded profiler window in ``utils.profiling`` owns this flag)."""
  get_tracer().annotate_devices = bool(enabled)
