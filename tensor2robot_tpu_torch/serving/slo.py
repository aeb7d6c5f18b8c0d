"""Priority / SLO classes for fleet serving.

Counterpart of ``tensor2robot_tpu/serving/slo.py``, the same code. Every
request carries a class, a deadline budget and a priority, and the
micro-batcher spends capacity by class:

- admission is earliest-deadline-first (EDF): the pending request whose
  deadline expires soonest flushes first;
- shedding is lowest-priority-first: when offered load exceeds the queue
  bound, the lowest-priority pending request is the victim (the latest
  deadline breaks ties), and each shed is counted by class in
  ``ServingStats``;
- a request whose deadline is already past at enqueue is shed at once,
  never dispatched.

``HealthConfig`` and ``CircuitBreaker`` are the routed fleet's replica
self-healing knobs and state machine; the single replica (``FleetServer``)
uses neither.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOClass:
  """One service class: a latency budget and a shed priority.

  Attributes:
    name: stable class key (stats, artifacts, metric-writer scalars).
    priority: higher is more important; shedding removes the LOWEST
      priority pending request first.
    deadline_ms: the request's latency budget from enqueue: the
      batcher's flush trigger and the class's p99 bar. Zero flushes at
      once; negative means already expired at enqueue (shed on arrival).
  """

  name: str
  priority: int
  deadline_ms: float


# The default three-tier ladder. The budgets are host-scale numbers; the
# structure (interactive above batch in priority, below it in budget) is
# the contract.
INTERACTIVE = SLOClass("interactive", priority=2, deadline_ms=30.0)
STANDARD = SLOClass("standard", priority=1, deadline_ms=100.0)
BATCH = SLOClass("batch", priority=0, deadline_ms=500.0)
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (INTERACTIVE, STANDARD, BATCH)


class RequestShed(RuntimeError):
  """Raised into a request's Future when the batcher sheds it.

  Carries the class name and the reason: "expired" (the deadline had
  passed at enqueue), "capacity" (the queue bound was exceeded and this
  request was the lowest-priority victim), or "fault" (a replica dispatch
  failed and the remaining slack could not cover a retry). An accounted
  overload signal, not a server fault: retry later or degrade.
  """

  def __init__(self, class_name: str, reason: str,
               detail: Optional[str] = None):
    self.class_name = class_name
    self.reason = reason
    message = f"request shed ({reason}) for class {class_name!r}"
    if detail:
      message += f": {detail}"
    super().__init__(message)


class RouterNotStarted(RuntimeError):
  """Raised by a fleet router's ``submit`` when it was never started:
  warming a router builds its programs but starts no batcher threads."""

  def __init__(self):
    super().__init__(
        "FleetRouter was never started: warmup() only compiles the "
        "ladder executables, it does not start the batcher dispatch "
        "threads. Call start() (or use the router as a context "
        "manager) before submit().")


class DispatcherDead(RuntimeError):
  """Resolved into every pending Future when a MicroBatcher's dispatcher
  thread dies unrecoverably (its restart budget spent, or a death during
  shutdown): a typed terminal error, so no client blocks in ``result()``
  forever."""

  def __init__(self, detail: str = ""):
    message = "batcher dispatcher thread died unrecoverably"
    if detail:
      message += f": {detail}"
    super().__init__(message)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
  """Knobs for a routed fleet's replica self-healing.

  Attributes:
    failure_threshold: consecutive dispatch failures that open a
      replica's circuit breaker (one success resets the count).
    quarantine_s: how long an open breaker holds the replica out before
      one half-open probe (a live request) may reach it.
    retry_cost_ms: the estimate of one re-dispatch; a failed request is
      retried elsewhere only if its remaining slack covers it, else shed
      as ``RequestShed(class, "fault")``.
    max_retries: re-dispatch budget a request.
    restart_budget: a MicroBatcher's dispatcher restarts before it goes
      down with ``DispatcherDead``.
    q_drift_z, q_drift_min_samples, q_drift_min_scale: the fleet Q-drift
      guard (a replica whose served-Q sketch sits more than q_drift_z
      robust deviations from the rest of the fleet is divergent).
  """

  failure_threshold: int = 3
  quarantine_s: float = 2.0
  retry_cost_ms: float = 50.0
  max_retries: int = 2
  restart_budget: int = 3
  q_drift_z: float = 8.0
  q_drift_min_samples: int = 16
  q_drift_min_scale: float = 1e-4


class CircuitBreaker:
  """Per-replica consecutive-failure breaker: closed -> open (quarantine)
  -> half-open (one probe) -> closed. Every transition takes an injectable
  ``now`` (the monotonic clock by default). Not thread-safe by itself: its
  owner serializes the calls."""

  def __init__(self, failure_threshold: int = 3,
               quarantine_s: float = 2.0):
    if failure_threshold < 1:
      raise ValueError(
          f"failure_threshold must be >= 1, got {failure_threshold}")
    if quarantine_s < 0:
      raise ValueError(f"quarantine_s must be >= 0, got {quarantine_s}")
    self.failure_threshold = failure_threshold
    self.quarantine_s = quarantine_s
    self.state = "closed"
    self.consecutive_failures = 0
    self.opened_at: Optional[float] = None
    self.events: List[dict] = []  # transition history (bounded)
    self._probe_in_flight = False

  def _transition(self, state: str, now: float, **fields) -> None:
    self.state = state
    self.events.append({"state": state, "t": now, **fields})
    if len(self.events) > 256:  # a flapping replica must not grow it
      del self.events[:len(self.events) - 256]

  def record_success(self, now: Optional[float] = None,
                     from_degraded: bool = False) -> None:
    """A dispatch on this replica succeeded. A half-open probe's success
    closes the breaker; while open, only a request routed here in the
    fleet's degraded mode (`from_degraded`) closes it, since any other
    success is a stale completion queued before the breaker tripped."""
    now = time.monotonic() if now is None else now
    self.consecutive_failures = 0
    if self.state == "half_open":
      self._probe_in_flight = False
      self.opened_at = None
      self._transition("closed", now, reason="probe_succeeded")
    elif self.state == "open" and from_degraded:
      self.opened_at = None
      self._transition("closed", now, reason="degraded_success")

  def record_failure(self, now: Optional[float] = None) -> None:
    """A dispatch on this replica failed (not a shed)."""
    now = time.monotonic() if now is None else now
    self.consecutive_failures += 1
    if self.state == "half_open":
      self._probe_in_flight = False
      self.opened_at = now
      self._transition("open", now, reason="probe_failed")
    elif (self.state == "closed"
          and self.consecutive_failures >= self.failure_threshold):
      self.opened_at = now
      self._transition("open", now, reason="threshold",
                       failures=self.consecutive_failures)

  def allows(self, now: Optional[float] = None) -> bool:
    """True when the replica may take ordinary traffic (closed), or when
    the quarantine has elapsed and this call claims the one half-open
    probe; False while a probe is in flight."""
    now = time.monotonic() if now is None else now
    if self.state == "closed":
      return True
    if self.state == "open":
      if (self.opened_at is not None
          and now - self.opened_at >= self.quarantine_s):
        self._probe_in_flight = True
        self._transition("half_open", now, reason="quarantine_elapsed")
        return True
      return False
    if not self._probe_in_flight:
      self._probe_in_flight = True
      return True
    return False

  def release_probe(self) -> None:
    """The probe gave no verdict (shed before it reached the device):
    frees the slot for a later probe."""
    if self.state == "half_open":
      self._probe_in_flight = False
