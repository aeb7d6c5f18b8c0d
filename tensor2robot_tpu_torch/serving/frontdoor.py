"""Router of routers: the pod's one serving front door.

Counterpart of ``tensor2robot_tpu/serving/frontdoor.py``. One
``FleetRouter`` balances the replicas of one host; pod traffic needs a
second tier that balances ingress across per-host routers the same way.
This module is that tier, and it changes no contract beneath it:

- **Deadline and correlation id stamped once, at pod ingress.** The front
  door mints the request id and turns the class budget into an absolute
  ``deadline_at``, then forwards both through ``FleetRouter.submit``; the
  router does not stamp again, so a host hop cannot extend a budget.
- **Least-loaded host, rotating tie-break.** A host's load is its
  router's total pending depth over every replica.
- **Its own trace lane.** A private ``Tracer`` records one
  ``serve/frontdoor`` span a submit with the request id; ``export_trace``
  writes it as its own Chrome trace.
- **Cross-host quarantine from the fleet drift rollup.**
  ``apply_drift_rollup`` reads a rollup's ``q_drift.divergent`` entries
  (``host:pid/replica`` keys) and takes the named hosts out of the
  ingress set, by name; only ``reinstate_host`` brings one back, since
  the front door sends no probe traffic of its own. The aggregator that
  writes the rollup waits for ``ROADMAP.md``'s flagship item 15c.

Reconciliation: every submit adds one to exactly one host router's
``logical_requests``, so the hosts' counters sum 1:1 to the front door's
own count (``snapshot()["reconciled"]``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.obs import context as context_lib
from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.serving.slo import SLOClass


class FrontDoor:
  """Balances pod ingress onto named per-host ``FleetRouter``s.

  Args:
    hosts: ordered ``{host_name: FleetRouter}``. Host names are the
      pod's operator-facing vocabulary — quarantine events, timeline
      entries, and snapshots all speak them.
    flight_recorder: post-mortem sink for quarantine triggers
      (default: the process recorder).
    tracer: the ingress-lane tracer (default: a PRIVATE ``Tracer`` —
      deliberately not the process one; see module docstring).
  """

  def __init__(self, hosts: Mapping[str, object],
               flight_recorder=None,
               tracer: Optional[trace_lib.Tracer] = None):
    self.hosts: Dict[str, object] = dict(hosts)
    if not self.hosts:
      raise ValueError("FrontDoor needs at least one host router.")
    self._names = list(self.hosts)
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self.tracer = tracer if tracer is not None else trace_lib.Tracer()
    self._lock = threading.Lock()
    self._rr = itertools.count()  # least-loaded tie-break rotation
    self._quarantined: Dict[str, str] = {}  # host -> reason
    self._degraded = False
    self.submitted = 0
    self.per_class: Dict[str, int] = {}
    self.per_host: Dict[str, int] = {name: 0 for name in self._names}
    self._timeline: List[dict] = []
    self._max_timeline = 1024
    self._started_at = time.perf_counter()

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> "FrontDoor":
    for router in self.hosts.values():
      router.start()
    return self

  def stop(self) -> None:
    for router in self.hosts.values():
      router.stop()

  def __enter__(self) -> "FrontDoor":
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.stop()

  def warmup(self, make_image) -> None:
    for router in self.hosts.values():
      router.warmup(make_image)

  # -- routing ---------------------------------------------------------------

  def _event(self, event: str, **fields) -> None:
    """Caller holds the lock."""
    entry = {"event": event,
             "t_s": round(time.perf_counter() - self._started_at, 3)}
    entry.update(fields)
    self._timeline.append(entry)
    if len(self._timeline) > self._max_timeline:
      del self._timeline[:len(self._timeline) - self._max_timeline]

  def _host_pending(self, name: str) -> int:
    router = self.hosts[name]
    return sum(replica.batcher.pending()
               for replica in router.replicas)

  def _choose_host(self) -> str:
    with self._lock:
      candidates = [name for name in self._names
                    if name not in self._quarantined]
      if not candidates:
        # Degraded pod: every host quarantined. Keep serving — route
        # over the quarantined hosts and let each host's SLO machinery
        # shed lowest-priority-first, mirroring the router's own
        # all-replicas-quarantined behavior (better a suspect answer
        # for batch traffic than a dead pod for interactive).
        if not self._degraded:
          self._degraded = True
          self._event("degraded_enter")
        candidates = list(self._names)
      elif self._degraded:
        self._degraded = False
        self._event("degraded_exit")
    n = len(self._names)
    offset = next(self._rr)
    index_of = {name: i for i, name in enumerate(self._names)}
    return min(
        ((self._host_pending(name), (index_of[name] - offset) % n, name)
         for name in candidates),
        key=lambda entry: entry[:2])[2]

  def submit(self, image, slo: Optional[SLOClass] = None,
             seed: Optional[int] = None) -> Future:
    """One frame through the pod: stamp at ingress, forward to the
    least-loaded available host. The returned future is the chosen
    host router's — results, typed ``RequestShed``s, and retry
    semantics are exactly that router's (the front door adds no
    failure modes of its own to the request path)."""
    deadline_at = (time.perf_counter() + slo.deadline_ms / 1e3
                   if slo is not None else None)
    request_id = context_lib.new_request_id()
    class_name = slo.name if slo is not None else "default"
    host = self._choose_host()
    with self._lock:
      self.submitted += 1
      self.per_class[class_name] = self.per_class.get(class_name, 0) + 1
      self.per_host[host] += 1
    with self.tracer.span("serve/frontdoor", host=host,
                          slo_class=class_name, request_id=request_id):
      return self.hosts[host].submit(
          image, slo=slo, seed=seed, deadline_at=deadline_at,
          request_id=request_id)

  def act(self, image, slo: Optional[SLOClass] = None,
          timeout: Optional[float] = None) -> np.ndarray:
    """Blocking control step through the pod front door."""
    return self.submit(image, slo=slo).result(timeout)

  # -- cross-host quarantine -------------------------------------------------

  def quarantine_host(self, name: str, reason: str = "manual",
                      replica: Optional[str] = None) -> None:
    """Pulls ``name`` out of the ingress candidate set (idempotent).
    In-flight requests on the host finish; no NEW ingress lands there
    until ``reinstate_host``."""
    if name not in self.hosts:
      raise KeyError(
          f"unknown host {name!r}; front door hosts: {self._names}")
    with self._lock:
      already = name in self._quarantined
      self._quarantined[name] = reason
      if not already:
        fields = {"host": name, "reason": reason}
        if replica is not None:
          fields["replica"] = replica
        self._event("host_quarantined", **fields)
    if not already:
      try:
        self._recorder.trigger(
            "host_quarantined", host=name, reason=reason,
            replica=replica)
      except Exception:  # noqa: BLE001 — diagnostics never fail routing
        pass

  def reinstate_host(self, name: str) -> None:
    if name not in self.hosts:
      raise KeyError(
          f"unknown host {name!r}; front door hosts: {self._names}")
    with self._lock:
      if name in self._quarantined:
        del self._quarantined[name]
        self._event("host_reinstated", host=name)

  def apply_drift_rollup(self, health: dict,
                         process_to_host: Mapping[str, str]) -> list:
    """Quarantines hosts the FLEET Q-drift rollup names divergent.

    ``health`` is a fleet rollup's ``health`` dict (the shape of the JAX
    aggregator's ``aggregate_logdir(...)['health']``): its
    ``q_drift.divergent`` entries are ``host:pid/replica`` keys from the
    cross-host drift check.
    ``process_to_host`` maps each ``host:pid`` merge key back to this
    front door's host name (the pod wiring knows which registry
    snapshot each host wrote). Returns the ``host:replica`` names
    quarantined by this pass; unmapped divergent entries are ignored
    — a rollup can cover processes this front door does not route to.
    """
    quarantined = []
    for key in health.get("q_drift", {}).get("divergent", []):
      process_key, _, replica = key.partition("/")
      host = process_to_host.get(process_key)
      if host is None:
        continue
      self.quarantine_host(host, reason="q_drift", replica=replica)
      quarantined.append(f"{host}:{replica}")
    return quarantined

  # -- observability ---------------------------------------------------------

  def export_trace(self, path: str,
                   label: Optional[str] = None) -> str:
    """The ingress lane, as its own trace file for the fleet merge."""
    return self.tracer.export_chrome_trace(
        path, label=label or f"frontdoor:{os.getpid()}")

  def snapshot(self) -> dict:
    with self._lock:
      snap = {
          "hosts": {
              name: {
                  "submitted": self.per_host[name],
                  "quarantined": name in self._quarantined,
                  **({"quarantine_reason": self._quarantined[name]}
                     if name in self._quarantined else {}),
              }
              for name in self._names
          },
          "submitted": self.submitted,
          "per_class": dict(self.per_class),
          "degraded": self._degraded,
          "timeline": [dict(entry) for entry in self._timeline],
      }
    for name in self._names:
      snap["hosts"][name]["pending"] = self._host_pending(name)
      snap["hosts"][name]["logical_requests"] = (
          self.hosts[name].stats.snapshot()["logical_requests"])
    # The 1:1 reconciliation readout: sums the
    # per-host router-side logical_requests against this tier's own
    # submit count. Only exact when each router's stats sink receives
    # ONLY front-door traffic (the pod wiring).
    snap["hosts_logical_requests_total"] = sum(
        entry["logical_requests"] for entry in snap["hosts"].values())
    snap["reconciled"] = (
        snap["hosts_logical_requests_total"] == snap["submitted"])
    return snap
