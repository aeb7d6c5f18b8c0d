"""Flight recorder: the last N spans and events, dumped on failure.

Counterpart of ``tensor2robot_tpu/obs/flight_recorder.py``, the same code
and dump schema, so either package's readers take either's dumps. A
bounded ring keeps recent events (completed spans through a tracer
listener, and ``record`` calls from the serving and replay layers); a
``trigger`` (an SLO breach, a watchdog stall, a loop thread's exception,
a health breach) records itself and dumps the ring atomically to
``<dump_dir>/flightrec-*.json``. Dumps are rate-limited
(``min_dump_interval_s``): a burst of triggers writes one post-mortem,
and every trigger still lands in the ring. Without a ``dump_dir`` the
recorder keeps the ring and writes nothing.

Dump schema::

    {"schema": "t2r-flightrec-1", "host": ..., "pid": ...,
     "reason": ..., "dumped_at": <unix s>, "events_total": N,
     "trigger": {<the triggering event's fields>},   # when triggered
     "request_id": ...,   # when the trigger named one
     "events": [{"t_s": ..., "wall_time": ..., "kind":
                 "span"|"event"|"trigger", "name": ..., ...}, ...]}
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import socket
import threading
import time
from collections import deque
from typing import Optional

_log = logging.getLogger(__name__)

SCHEMA = "t2r-flightrec-1"

# One dump sequence a process, across every recorder: two triggers in one
# millisecond, or two recorders sharing a directory, write two files.
_DUMP_SEQ = itertools.count()
_SEQ_LOCK = threading.Lock()


def _scalar(value):
  """A JSON scalar as it is, anything else as its repr."""
  return value if isinstance(
      value, (int, float, str, bool, type(None))) else repr(value)


class FlightRecorder:
  """Bounded event ring with rate-limited atomic post-mortem dumps."""

  def __init__(self, capacity: int = 4096,
               dump_dir: Optional[str] = None,
               min_dump_interval_s: float = 5.0):
    self._events: deque = deque(maxlen=capacity)
    self._lock = threading.Lock()
    self._epoch = time.perf_counter()
    self.dump_dir = dump_dir
    self.min_dump_interval_s = min_dump_interval_s
    self._last_dump_at = -float("inf")
    self.events_total = 0
    self.dumps_written = 0
    self.dumps_suppressed = 0
    self.last_dump_path: Optional[str] = None

  def configure(self, dump_dir: Optional[str] = None,
                min_dump_interval_s: Optional[float] = None) -> None:
    """Late wiring for the process recorder: components record from
    construction, and dumps start once an owner names a directory.
    Repointing a configured recorder at another directory warns (last
    configured wins); two loops in one process each own a recorder
    instead."""
    if dump_dir is not None:
      if self.dump_dir is not None and self.dump_dir != dump_dir:
        _log.warning(
            "flight recorder dump_dir repointed %r -> %r "
            "(last-configured-wins on a shared recorder; use "
            "per-component FlightRecorder instances to keep dumps "
            "apart)", self.dump_dir, dump_dir)
      self.dump_dir = dump_dir
    if min_dump_interval_s is not None:
      self.min_dump_interval_s = min_dump_interval_s

  # -- recording -----------------------------------------------------------

  def record(self, kind: str, name: str, **fields) -> None:
    event = {
        "t_s": round(time.perf_counter() - self._epoch, 6),
        "wall_time": time.time(),
        "kind": kind,
        "name": name,
    }
    for key, value in fields.items():
      event[key] = _scalar(value)
    with self._lock:
      self._events.append(event)
      self.events_total += 1

  def record_span(self, span: dict) -> None:
    """The tracer listener: a completed span joins the ring, its attrs
    sanitized as record()'s are."""
    event = {key: _scalar(value) for key, value in span.items()}
    event["kind"] = "span"
    event["wall_time"] = time.time()
    with self._lock:
      self._events.append(event)
      self.events_total += 1

  def attach(self, tracer) -> None:
    tracer.add_listener(self.record_span)

  def detach(self, tracer) -> None:
    """Unsubscribes from the tracer (idempotent): a loop's recorder
    detaches after its run, or every later span pays its call."""
    tracer.remove_listener(self.record_span)

  def events(self) -> list:
    with self._lock:
      return list(self._events)

  # -- dumping -------------------------------------------------------------

  def dump(self, reason: str, dump_dir: Optional[str] = None,
           context: Optional[dict] = None) -> Optional[str]:
    """Writes the ring atomically (tmp then rename); returns the path, or
    None without a dump directory. ``context`` (the trigger's fields)
    lands top-level as ``trigger``, its ``request_id`` beside it."""
    directory = dump_dir or self.dump_dir
    if directory is None:
      return None
    os.makedirs(directory, exist_ok=True)
    with self._lock:
      events = list(self._events)
      events_total = self.events_total
    slug = re.sub(r"[^A-Za-z0-9_-]+", "_", reason)[:48] or "unknown"
    with _SEQ_LOCK:
      seq = next(_DUMP_SEQ)
    path = os.path.join(
        directory,
        f"flightrec-{int(time.time() * 1e3)}-{seq:04d}-{slug}.json")
    payload = {
        "schema": SCHEMA,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "reason": reason,
        "dumped_at": time.time(),
        "events_total": events_total,
        "events": events,
    }
    if context:
      payload["trigger"] = {key: _scalar(value)
                            for key, value in context.items()}
      if "request_id" in context:
        payload["request_id"] = payload["trigger"]["request_id"]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      # default=repr: a post-mortem writer must not crash on a value that
      # slipped past sanitizing.
      json.dump(payload, f, default=repr)
    os.replace(tmp, path)
    with self._lock:
      self.dumps_written += 1
      self.last_dump_path = path
    return path

  def trigger(self, reason: str, **fields) -> Optional[str]:
    """Records the trigger event, then dumps (rate-limited). Returns the
    dump path, or None when the rate limit suppressed it or no directory
    is set; the event is in the ring either way."""
    self.record("trigger", reason, **fields)
    now = time.perf_counter()
    with self._lock:
      if now - self._last_dump_at < self.min_dump_interval_s:
        self.dumps_suppressed += 1
        return None
      self._last_dump_at = now
    return self.dump(reason, context=fields)


_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
  """The process-wide recorder, subscribed to the process tracer at first
  access so recent spans are part of every post-mortem."""
  global _DEFAULT
  with _DEFAULT_LOCK:
    if _DEFAULT is None:
      _DEFAULT = FlightRecorder()
      from tensor2robot_tpu_torch.obs import trace
      _DEFAULT.attach(trace.get_tracer())
    return _DEFAULT
