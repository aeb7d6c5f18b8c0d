"""Stall and straggler watchdog for the loop's long-lived threads.

Counterpart of ``tensor2robot_tpu/obs/watchdog.py``, the same code. A
learner blocked on a dead feeder still looks alive from outside, and a
slow host drags a fleet's rate down without any process failing:

- **Heartbeats**: each loop thread (the replay loop's learner and feeder,
  collectors and actors, the batcher's dispatcher) registers a named
  heartbeat and calls ``beat()`` on real progress. A thread that waits on
  purpose (an idle dispatcher) calls ``idle()``: idleness is not a stall.
- **Stalls**: the monitor thread flags a component whose progress has not
  advanced within its deadline, and escalates, each hop isolated so a
  diagnostic never crashes the observed path: registry counters
  (``watchdog/stalls``, ``watchdog/stall/<component>``), a rate-limited
  ``watchdog_stall`` flight-recorder dump, then ``on_stall``. A component
  that beats again records ``watchdog_recovered`` and re-arms.
- **Stragglers**: ``find_stragglers`` flags fleet members below
  ``fraction`` of the median step rate.

Deadlines are wall-clock; ``scaled_deadline`` widens them on small hosts.
The monitor thread runs only once an owner calls ``start()``, and stops
with ``stop()``.
"""

from __future__ import annotations

import logging
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional

from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import registry as registry_lib

_log = logging.getLogger(__name__)

# The fields of a watchdog_stall trigger.
STALL_FIELDS = ("component", "stalled_for_s", "deadline_s", "beats")


def scaled_deadline(deadline_s: float, min_cores: int = 4,
                    factor: float = 4.0) -> float:
  """`deadline_s`, times `factor` on hosts below `min_cores` cores, so
  scheduling noise on a small host cannot pass for a stall."""
  if (os.cpu_count() or 1) < min_cores:
    return deadline_s * factor
  return deadline_s


class Heartbeat:
  """One component's liveness record (name + monotonic progress)."""

  __slots__ = ("name", "deadline_s", "_beats", "_last_beat", "_idle",
               "registered_at")

  def __init__(self, name: str, deadline_s: float):
    self.name = name
    self.deadline_s = deadline_s
    self._beats = 0
    now = time.monotonic()
    self._last_beat = now
    self.registered_at = now
    # Born idle: the first beat or busy() arms stall detection.
    self._idle = True

  def beat(self, n: int = 1) -> None:
    """Progress happened. Single attribute stores, no lock on the hot
    path."""
    self._beats += n
    self._last_beat = time.monotonic()
    self._idle = False

  def idle(self) -> None:
    """About to wait for work on purpose: not a stall."""
    self._idle = True

  def busy(self) -> None:
    """Work is pending but has made no progress yet: arms detection
    without a beat. Coming out of idle restarts the clock, so the deadline
    runs from when the work arrived."""
    if self._idle:
      self._last_beat = time.monotonic()
      self._idle = False

  @property
  def beats(self) -> int:
    return self._beats

  @property
  def is_idle(self) -> bool:
    return self._idle

  def age_s(self, now: Optional[float] = None) -> float:
    """Seconds since the last beat (or since registration)."""
    return (time.monotonic() if now is None else now) - self._last_beat


class Watchdog:
  """Monitors registered heartbeats; escalates stalls, never crashes.

  Args:
    poll_s: the monitor thread's check cadence.
    default_deadline_s: a component's deadline when register() names none.
    recorder: flight recorder for ``watchdog_stall`` dumps (default: the
      process recorder).
    registry: metric registry for the stall counters (default: the
      process registry).
    on_stall: optional callback with the stall event; its exceptions are
      logged and swallowed.
  """

  def __init__(self, poll_s: float = 0.5,
               default_deadline_s: float = 30.0,
               recorder: Optional[flight_lib.FlightRecorder] = None,
               registry: Optional[registry_lib.MetricRegistry] = None,
               on_stall: Optional[Callable[[dict], None]] = None):
    self.poll_s = poll_s
    self.default_deadline_s = default_deadline_s
    self._recorder = recorder
    self._registry = registry
    self._on_stall = on_stall
    self._lock = threading.Lock()
    self._heartbeats: Dict[str, Heartbeat] = {}
    self._stalled: Dict[str, bool] = {}
    self.events: List[dict] = []  # stall/recovery history (bounded)
    self._max_events = 256
    self._thread: Optional[threading.Thread] = None
    self._stop = threading.Event()

  # -- registration --------------------------------------------------------

  def register(self, name: str,
               deadline_s: Optional[float] = None) -> Heartbeat:
    """Registers a component; a taken name gets a ``#<n>`` suffix, so two
    loops in one process never share one heartbeat."""
    deadline = (self.default_deadline_s if deadline_s is None
                else float(deadline_s))
    with self._lock:
      unique = name
      n = 2
      while unique in self._heartbeats:
        unique = f"{name}#{n}"
        n += 1
      heartbeat = Heartbeat(unique, deadline)
      self._heartbeats[unique] = heartbeat
      self._stalled[unique] = False
    return heartbeat

  def unregister(self, heartbeat: Heartbeat) -> None:
    """Removes a component; an unknown one is a no-op."""
    with self._lock:
      current = self._heartbeats.get(heartbeat.name)
      if current is heartbeat:
        del self._heartbeats[heartbeat.name]
        self._stalled.pop(heartbeat.name, None)

  # -- monitoring ----------------------------------------------------------

  def check_once(self, now: Optional[float] = None) -> List[dict]:
    """One monitor pass; returns the new stall events it raised. Tests
    drive it with an injected ``now``."""
    now = time.monotonic() if now is None else now
    new_events: List[dict] = []
    with self._lock:
      snapshot = list(self._heartbeats.values())
    for heartbeat in snapshot:
      # is_idle before the age: busy() and beat() store the time first
      # and the flag second, so a busy read pairs with a fresh time.
      if heartbeat.is_idle:
        stalled_now = False
      else:
        stalled_now = heartbeat.age_s(now) > heartbeat.deadline_s
      age = heartbeat.age_s(now)
      with self._lock:
        if self._heartbeats.get(heartbeat.name) is not heartbeat:
          # Unregistered since the snapshot: never escalate it.
          continue
        was_stalled = self._stalled.get(heartbeat.name, False)
        if stalled_now == was_stalled:
          continue
        self._stalled[heartbeat.name] = stalled_now
        event = {
            "event": "watchdog_stall" if stalled_now
                     else "watchdog_recovered",
            "component": heartbeat.name,
            "stalled_for_s": round(age, 3),
            "deadline_s": heartbeat.deadline_s,
            "beats": heartbeat.beats,
            "t_monotonic": round(now, 3),
        }
        self.events.append(event)
        if len(self.events) > self._max_events:
          del self.events[:len(self.events) - self._max_events]
      if stalled_now:
        new_events.append(event)
        self._escalate(event)
      else:
        self._record_recovery(event)
    return new_events

  def _escalate(self, event: dict) -> None:
    """counter -> rate-limited dump -> callback; each hop isolated."""
    try:
      registry = self._registry or registry_lib.get_registry()
      registry.counter("watchdog/stalls").inc()
      registry.counter(
          f"watchdog/stall/{event['component']}").inc()
    except Exception:
      _log.warning("watchdog registry escalation failed", exc_info=True)
    try:
      recorder = self._recorder or flight_lib.get_recorder()
      recorder.trigger(
          "watchdog_stall",
          component=event["component"],
          stalled_for_s=event["stalled_for_s"],
          deadline_s=event["deadline_s"],
          beats=event["beats"])
    except Exception:
      _log.warning("watchdog recorder escalation failed", exc_info=True)
    if self._on_stall is not None:
      try:
        self._on_stall(event)
      except Exception:  # a diagnostic never crashes the path
        _log.warning("watchdog on_stall callback failed", exc_info=True)

  def _record_recovery(self, event: dict) -> None:
    try:
      recorder = self._recorder or flight_lib.get_recorder()
      recorder.record("event", "watchdog_recovered",
                      component=event["component"],
                      beats=event["beats"])
    except Exception:
      _log.warning("watchdog recovery record failed", exc_info=True)

  def _run(self) -> None:
    while not self._stop.wait(self.poll_s):
      try:
        self.check_once()
      except Exception:  # the monitor outlives any check failure
        _log.warning("watchdog check failed", exc_info=True)

  def start(self) -> "Watchdog":
    with self._lock:
      if self._thread is not None:
        return self
      self._stop.clear()
      self._thread = threading.Thread(
          target=self._run, name="obs-watchdog", daemon=True)
    self._thread.start()
    return self

  def stop(self) -> None:
    with self._lock:
      thread, self._thread = self._thread, None
    if thread is not None:
      self._stop.set()
      thread.join(10.0)

  def __enter__(self) -> "Watchdog":
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.stop()

  # -- readout -------------------------------------------------------------

  @property
  def stall_count(self) -> int:
    with self._lock:
      return sum(1 for event in self.events
                 if event["event"] == "watchdog_stall")

  def snapshot(self) -> dict:
    """The component table and the event history."""
    now = time.monotonic()
    with self._lock:
      components = {
          name: {
              "beats": heartbeat.beats,
              "age_s": round(heartbeat.age_s(now), 3),
              "deadline_s": heartbeat.deadline_s,
              "idle": heartbeat.is_idle,
              "stalled": self._stalled.get(name, False),
          }
          for name, heartbeat in sorted(self._heartbeats.items())}
      events = [dict(event) for event in self.events]
    return {
        "components": components,
        "stalls": sum(1 for event in events
                      if event["event"] == "watchdog_stall"),
        "events": events,
    }


def find_stragglers(rates: Mapping[str, float],
                    fraction: float = 0.5) -> dict:
  """Flags fleet members whose rate falls below ``fraction`` x median.

  ``rates`` maps a member (``host:pid``) to its step rate; a fleet of one
  has no median. None and zero rates compare like any other (a stopped
  host is the worst straggler).
  """
  cleaned = {name: float(rate or 0.0) for name, rate in rates.items()}
  if len(cleaned) < 2:
    return {"fleet_median": None, "threshold": None, "stragglers": []}
  median = statistics.median(cleaned.values())
  threshold = fraction * median
  stragglers = [
      {"name": name, "rate": round(rate, 4),
       "fleet_median": round(median, 4)}
      for name, rate in sorted(cleaned.items())
      if rate < threshold]
  return {
      "fleet_median": round(median, 4),
      "threshold": round(threshold, 4),
      "stragglers": stragglers,
  }


_DEFAULT: Optional[Watchdog] = None
_DEFAULT_LOCK = threading.Lock()


def get_watchdog() -> Watchdog:
  """The process-wide watchdog components register into by default. Not
  started: registration and beats are cheap stores, and the monitor runs
  only once an owner calls ``start()``."""
  global _DEFAULT
  with _DEFAULT_LOCK:
    if _DEFAULT is None:
      _DEFAULT = Watchdog()
    return _DEFAULT
