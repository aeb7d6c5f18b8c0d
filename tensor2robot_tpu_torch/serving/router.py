"""Least-loaded router: the bucket ladder replicated over several replicas.

Counterpart of ``tensor2robot_tpu/serving/router.py``. One
``FleetServer`` keeps one replica busy for up to ``max_batch`` clients;
fleet traffic goes through a host-side router over several replicas. Each
replica is a ``CEMFleetPolicy`` pinned to a device (one CUDA graph a
bucket a replica, the ledger the fleet bench checks) behind its own
SLO-aware ``MicroBatcher``, and the router sends each request to the
replica with the shortest queue (pending + in flight), not round-robin,
so one slow flush does not back up the fleet.

**Several replicas on one card.** ``devices`` may repeat a device: the
port runs two replicas on one H100. So a replica is named by a stable
label, its device and its index (``cuda:0#1``), in every key a device
named in the JAX package: the compile ledger, the health snapshot, the
Q-drift guard, the Q sketches and the policy cache. Each replica's policy
replays on its own CUDA stream, so two replicas' graphs may overlap on
the card.

**Captures beside live traffic.** A graph is captured before other
threads launch work on the card. Building a scoring tier's ladder while
the fleet serves (``warm_policy``: a precision candidate, a promote)
therefore holds every policy's lock for the capture: the replicas'
dispatchers wait, their queues fill and shed by the SLO rules, and no
replay runs beside a capture.

Per-request determinism survives routing: seeds are assigned at the
router's ingress from one counter, and a request's action depends on
(image, seed, variables) only, so the single-replica ``FleetServer``
remains the semantics oracle of the whole fleet. A hot reload reaches
every replica through the predictor: each flush reads
``predictor.device_fn()``, and a new version is copied into each policy's
own variables at its next flush, with no capture.

Refused by name: ``fault_plan=`` (fault injection, ``ROADMAP.md``'s
flagship item 15c), ``tp_group`` > 1 with ``param_specs``
(tensor-parallel replica groups, item 15b) and ``episode_recorder=`` (the
data flywheel, item 15d).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import resolve_device
from tensor2robot_tpu_torch.obs import context as context_lib
from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import health as health_lib
from tensor2robot_tpu_torch.obs import ledger as ledger_lib
from tensor2robot_tpu_torch.obs import registry as registry_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.serving import slo as slo_lib
from tensor2robot_tpu_torch.serving.batcher import MicroBatcher
from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.serving.slo import (
    HealthConfig,
    RequestShed,
    SLOClass,
)
from tensor2robot_tpu_torch.serving.stats import ServingStats


class PolicyReplica:
  """One replica of the fleet: a pinned policy and its own batcher."""

  def __init__(self, policy: CEMFleetPolicy, max_batch: int,
               deadline_ms: float, stats: ServingStats,
               max_queue: Optional[int], dispatch_margin_ms: float,
               flight_recorder=None, restart_budget: int = 3):
    self.policy = policy
    self.device = policy.device
    self.label = policy.label
    self.stats = stats
    self.batcher = MicroBatcher(
        self._flush, max_batch=max_batch, deadline_ms=deadline_ms,
        stats=stats, bucket_for=policy.ladder.bucket_for,
        max_queue=max_queue, dispatch_margin_ms=dispatch_margin_ms,
        flight_recorder=flight_recorder, site=f"batcher@{self.label}",
        restart_budget=restart_budget)

  def use_policy(self, policy: CEMFleetPolicy) -> None:
    """Hot-swaps this replica's policy (a tier promotion): in-flight
    flushes finish on the old policy's graphs, the next flush replays the
    new one's. The policy must carry this replica's label: a policy of
    another replica would serve from another placement."""
    if policy.label != self.label:
      raise ValueError(
          f"policy of replica {policy.label} cannot serve replica "
          f"{self.label}")
    self.policy = policy

  def _flush(self, items):
    images = [item[0] for item in items]
    seeds = np.asarray([item[1] for item in items], np.uint32)
    # The replica hop of the request timeline: inside the batcher's
    # serve/flush span, with the batch's bound request ids.
    with trace_lib.span("serve/dispatch", batch=len(items),
                        device=self.label):
      actions, scores = self.policy(images, seeds, return_scores=True)
      if scores is not None:
        # The served-Q sketch of the drift guard; diagnostics never fail
        # a flush.
        try:
          self.stats.record_q_values(self.label, scores)
        except Exception:  # noqa: BLE001
          pass
      return list(actions)

  def warmup(self, make_image) -> None:
    """Builds the full ladder on this replica before traffic."""
    self.policy.warm(make_image)


class FleetRouter:
  """Routes fleet traffic to policy replicas, least-loaded.

  Args:
    predictor: the shared predictor (one set of live variables; each
      replica's policy copies them to its device). Must provide
      ``device_fn()``.
    devices: one device a replica; a device may repeat (several replicas
      on one card). None: every visible CUDA device, raising without one.
    max_batch: per-replica flush threshold (default the ladder's top).
    deadline_ms: the default class's budget for class-less submits.
    max_queue: per-replica admission bound; load beyond it sheds the
      lowest priority first (``serving/slo.py``). None: unbounded.
    stats: ServingStats shared by every replica (one is made if not
      given).
    ledger: the executable ledger every replica's policy registers into
      (one is made if not given): one row a bucket a replica a tier.
    precision: the fleet's scoring tier (``cem.SCORING_PRECISIONS``);
      ``set_precision`` hot-swaps the whole fleet to another, and
      ``make_policy`` builds a replica's policy at any tier.
    health: replica self-healing (``serving/slo.HealthConfig``): a
      consecutive-failure circuit breaker a replica takes a throwing
      replica out of the candidates; after ``quarantine_s`` one live
      request probes it; a failed dispatch retries elsewhere while the
      request's slack covers ``retry_cost_ms``, else resolves
      ``RequestShed(class, "fault")``; with every replica quarantined the
      router degrades to least-loaded over all of them.
    fault_plan, tp_group, param_specs, episode_recorder: refused (see the
      module docstring).
    cem / ladder kwargs: forwarded to each replica's CEMFleetPolicy.
  """

  def __init__(self, predictor, devices: Optional[Sequence] = None,
               action_size: int = 4, num_samples: int = 64,
               num_elites: int = 6, iterations: int = 3, seed: int = 0,
               ladder_sizes: Optional[Sequence[int]] = None,
               max_batch: Optional[int] = None, deadline_ms: float = 5.0,
               max_queue: Optional[int] = None,
               dispatch_margin_ms: float = 0.0,
               stats: Optional[ServingStats] = None,
               metric_writer=None,
               ledger: Optional[ledger_lib.ExecutableLedger] = None,
               flight_recorder=None,
               precision: str = "f32",
               health: Optional[HealthConfig] = None,
               fault_plan=None,
               tp_group: int = 1,
               param_specs=None,
               episode_recorder=None):
    if fault_plan is not None:
      raise NotImplementedError(
          "FleetRouter(fault_plan=) injects faults through obs/faults.py, "
          "which waits for ROADMAP.md's flagship item 15c (the obs tier).")
    if int(tp_group) != 1 or param_specs is not None:
      raise NotImplementedError(
          "FleetRouter(tp_group=, param_specs=) serves tensor-parallel "
          "replica groups, which wait for ROADMAP.md's flagship item 15b "
          "(the parallel tier).")
    if episode_recorder is not None:
      raise NotImplementedError(
          "FleetRouter(episode_recorder=) captures served traffic for the "
          "data flywheel, which waits for ROADMAP.md's flagship item 15d.")
    if devices is None:
      resolve_device(None)  # raises without CUDA
      devices = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    devices = [resolve_device(device) for device in devices]
    if not devices:
      raise ValueError("FleetRouter needs at least one device.")
    self.stats = stats or ServingStats()
    self._metric_writer = metric_writer
    self._metric_step = 0
    self._predictor = predictor
    self.precision = cem.validate_precision(precision)
    self._seed_lock = threading.Lock()
    self._next_seed = 0
    self._rr = itertools.count()  # least-loaded tie-break rotation
    # Kept so make_policy can build a replica's policy at another tier
    # with the same CEM knobs and seed: the paired shadow comparison is
    # sharp only because (image, seed) -> action matches across tiers up
    # to the numerics under test.
    self._policy_kwargs = dict(
        action_size=action_size, num_samples=num_samples,
        num_elites=num_elites, iterations=iterations, seed=seed)
    self._ladder_sizes = (tuple(ladder_sizes)
                          if ladder_sizes is not None else None)
    self.ledger = (ledger if ledger is not None
                   else ledger_lib.ExecutableLedger())
    self._recorder = flight_recorder or flight_lib.get_recorder()
    # label -> device, in replica order.
    self._devices = {f"{device}#{i}": device
                     for i, device in enumerate(devices)}
    # One policy a (replica label, tier) for the router's lifetime: a
    # re-offered tier reuses its built graphs, so the per-tier
    # exactly-once ledger holds across any number of rollout cycles.
    self._policy_cache = {}
    self._policy_cache_lock = threading.Lock()
    self.health = health or HealthConfig()
    self._health_lock = threading.Lock()
    self._health_events: List[dict] = []
    self._max_health_events = 1024
    self._degraded = False
    self._divergent_replicas = set()
    self._started_at = time.perf_counter()
    # warmup() builds but starts no batcher, so a submit before start()
    # raises RouterNotStarted instead of shedding as a replica fault.
    self._started = False
    self.replicas: List[PolicyReplica] = []
    self._breakers = []
    for label in self._devices:
      policy = self.make_policy(label)
      ladder = policy.ladder
      replica_max_batch = (ladder.max_batch if max_batch is None
                           else max_batch)
      if replica_max_batch > ladder.max_batch:
        raise ValueError(
            f"max_batch {replica_max_batch} exceeds ladder top rung "
            f"{ladder.max_batch}")
      self.replicas.append(PolicyReplica(
          policy, replica_max_batch, deadline_ms, self.stats, max_queue,
          dispatch_margin_ms, flight_recorder=self._recorder,
          restart_budget=self.health.restart_budget))
      self._breakers.append(slo_lib.CircuitBreaker(
          self.health.failure_threshold, self.health.quarantine_s))

  def make_policy(self, label: str, precision: Optional[str] = None
                  ) -> CEMFleetPolicy:
    """The CEMFleetPolicy of replica `label` at `precision` (default the
    fleet's tier), sharing the fleet's predictor, ledger, CEM knobs and
    seed, so a candidate tier's graphs land in the same ledger under
    tier-suffixed keys and its per-request draws match the live tier's.
    Memoised a (replica, tier): a repeat call returns the same policy
    and its built graphs."""
    if precision is None:
      precision = self.precision
    key = (label, precision)
    with self._policy_cache_lock:
      policy = self._policy_cache.get(key)
      if policy is None:
        ladder = (BucketLadder(self._ladder_sizes)
                  if self._ladder_sizes is not None else BucketLadder())
        policy = CEMFleetPolicy(
            self._predictor, ladder=ladder, device=self._devices[label],
            ledger=self.ledger, precision=precision, label=label,
            **self._policy_kwargs)
        self._policy_cache[key] = policy
      return policy

  @contextlib.contextmanager
  def quiesced(self):
    """Holds every policy's lock (in one order): no replica, shadow or
    canary replays while the block runs, so a capture inside it races no
    other thread's work on the card."""
    with self._policy_cache_lock:
      policies = [policy for _, policy in sorted(
          self._policy_cache.items(), key=lambda item: item[0])]
    with contextlib.ExitStack() as stack:
      for policy in policies:
        stack.enter_context(policy.lock)
      yield

  def warm_policy(self, label: str, precision: Optional[str] = None
                  ) -> CEMFleetPolicy:
    """make_policy plus the full-ladder build on zeros at the predictor's
    image spec (answers discarded), with the fleet quiesced: the one
    build-and-warm recipe that a promote and a tier candidate share."""
    policy = self.make_policy(label, precision)
    spec = self._predictor.get_feature_specification()["image"]
    zero = np.zeros(tuple(spec.shape), spec.dtype)
    with self.quiesced():
      policy.warm(lambda i: zero)
    return policy

  def set_precision(self, precision: str) -> None:
    """Hot-swaps every replica to the `precision` tier: each replica's
    tier policy is built and warmed first (one replica after another, the
    fleet quiesced for each ladder), then the replicas swap; in-flight
    flushes finish on the old tier. A same-tier call is a no-op."""
    cem.validate_precision(precision)
    if precision == self.precision:
      return
    swaps = [(replica, self.warm_policy(replica.label, precision))
             for replica in self.replicas]
    for replica, policy in swaps:
      replica.use_policy(policy)
    self.precision = precision

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> "FleetRouter":
    self._started = True
    for replica in self.replicas:
      replica.batcher.start()
    return self

  def stop(self) -> None:
    for replica in self.replicas:
      replica.batcher.stop()

  def __enter__(self) -> "FleetRouter":
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.stop()

  def warmup(self, make_image) -> None:
    """Builds every bucket on every replica before traffic (the ledger
    then shows that the measured run built nothing)."""
    for replica in self.replicas:
      replica.warmup(make_image)

  def use_stats(self, stats: ServingStats) -> None:
    """Swaps the shared stats sink (between phases, while idle), without
    rebuilding a replica."""
    self.stats = stats
    for replica in self.replicas:
      replica.stats = stats
      replica.batcher.use_stats(stats)

  # -- client API ------------------------------------------------------------

  def assign_seed(self) -> int:
    with self._seed_lock:
      seed = self._next_seed
      self._next_seed += 1
    return seed

  def submit(self, image, slo: Optional[SLOClass] = None,
             seed: Optional[int] = None,
             deadline_at: Optional[float] = None,
             request_id: Optional[str] = None) -> Future:
    """Enqueues one frame on the least-loaded available replica.

    The absolute deadline is stamped here, at ingress, so a replica's
    queue cannot extend a class budget; the correlation id is minted here
    unless given (a rollout mirror inherits its parent's). The returned
    future is the router's: a replica failure feeds that replica's
    breaker and is retried elsewhere while the slack covers it, else the
    future resolves ``RequestShed(class, "fault")``; a client sees a
    result, a typed shed or its own timeout, never a replica's raw
    exception. ``stats.record_logical_request`` counts one a submit.
    """
    if not self._started:
      raise slo_lib.RouterNotStarted()
    if slo is not None and deadline_at is None:
      deadline_at = time.perf_counter() + slo.deadline_ms / 1e3
    seed = self.assign_seed() if seed is None else int(seed)
    request_id = request_id or context_lib.new_request_id()
    self.stats.record_logical_request()
    outer: Future = Future()
    self._dispatch(outer, np.asarray(image), seed, slo, deadline_at,
                   request_id, excluded=frozenset(), retries=0)
    return outer

  # -- self-healing dispatch -------------------------------------------------

  def _health_event(self, event: str, replica: Optional[int],
                    **fields) -> None:
    """Appends one entry to the health timeline (the caller holds the
    health lock)."""
    entry = {
        "event": event,
        "t_s": round(time.perf_counter() - self._started_at, 3),
    }
    if replica is not None:
      entry["replica"] = self.replicas[replica].label
    entry.update(fields)
    self._health_events.append(entry)
    if len(self._health_events) > self._max_health_events:
      del self._health_events[
          :len(self._health_events) - self._max_health_events]

  def _update_degraded_locked(self) -> None:
    degraded = all(b.state != "closed" for b in self._breakers)
    if degraded and not self._degraded:
      self._degraded = True
      self._health_event("degraded_enter", None)
    elif not degraded and self._degraded:
      self._degraded = False
      self._health_event("degraded_exit", None)

  def _record_result(self, index: int, ok: bool,
                     error: Optional[str] = None) -> None:
    """Feeds one dispatch outcome to the replica's breaker; timeline
    events and a flight-recorder trigger on its transitions."""
    with self._health_lock:
      breaker = self._breakers[index]
      before = breaker.state
      if ok:
        # Only a success of traffic routed to an open replica in the
        # degraded mode reinstates it without a probe; a stale completion
        # queued before the quarantine must not.
        breaker.record_success(from_degraded=self._degraded)
      else:
        breaker.record_failure()
      after = breaker.state
      if before != "open" and after == "open":
        self._health_event(
            "requarantine" if before == "half_open" else "quarantine",
            index, failures=breaker.consecutive_failures,
            **({} if error is None else {"error": error}))
      elif before in ("open", "half_open") and after == "closed":
        self._health_event("reinstate", index)
      self._update_degraded_locked()
      quarantined = (before != "open" and after == "open")
      degraded = self._degraded
    if quarantined:
      try:
        self._recorder.trigger(
            "replica_quarantined", replica=self.replicas[index].label,
            degraded=degraded)
      except Exception:  # noqa: BLE001 — diagnostics never fail routing
        pass

  def _choose_replica(self, excluded: frozenset) -> tuple:
    """(index, is_probe): a due half-open probe first, else least-loaded
    over the closed replicas, else (all quarantined) degraded least-loaded
    over everyone not excluded."""
    n = len(self.replicas)
    with self._health_lock:
      now = time.monotonic()
      for i in range(n):
        if i in excluded:
          continue
        breaker = self._breakers[i]
        if breaker.state != "closed" and breaker.allows(now):
          self._health_event("probe", i)
          return i, True
      candidates = [i for i in range(n)
                    if i not in excluded
                    and self._breakers[i].state == "closed"]
      if not candidates:
        self._update_degraded_locked()
        candidates = [i for i in range(n) if i not in excluded]
    # The rotating tie-break: a bare min() sends every tie to replica 0.
    offset = next(self._rr)
    index = min(
        ((self.replicas[i].batcher.pending(), (i - offset) % n, i)
         for i in candidates),
        key=lambda entry: entry[:2])[2]
    return index, False

  def _dispatch(self, outer: Future, image, seed: int,
                slo: Optional[SLOClass], deadline_at: Optional[float],
                request_id: str, excluded: frozenset,
                retries: int) -> None:
    index, is_probe = self._choose_replica(excluded)
    replica = self.replicas[index]
    with context_lib.bind(request_id=request_id):
      try:
        inner = replica.batcher.submit(
            (image, seed), slo=slo, deadline_at=deadline_at,
            request_id=request_id)
      except Exception as e:  # noqa: BLE001 — a stopped or dead batcher
        self._record_result(index, ok=False,
                            error=f"{type(e).__name__}: {e}")
        self._retry_or_shed(outer, image, seed, slo, deadline_at,
                            request_id, excluded | {index}, retries, e)
        return
    inner.add_done_callback(
        lambda f: self._on_dispatched(
            f, outer, index, is_probe, image, seed, slo, deadline_at,
            request_id, excluded, retries))

  def _on_dispatched(self, inner: Future, outer: Future, index: int,
                     is_probe: bool, image, seed, slo, deadline_at,
                     request_id, excluded: frozenset,
                     retries: int) -> None:
    try:
      result = inner.result()
    except RequestShed as e:
      # A shed is not a replica fault; a shed probe frees its slot.
      if is_probe:
        with self._health_lock:
          self._breakers[index].release_probe()
      self._resolve_outer(outer, error=e)
      return
    except Exception as e:  # noqa: BLE001 — a replica fault
      self._record_result(index, ok=False,
                          error=f"{type(e).__name__}: {e}")
      self._retry_or_shed(outer, image, seed, slo, deadline_at,
                          request_id, excluded | {index}, retries, e)
      return
    self._record_result(index, ok=True)
    self._resolve_outer(outer, result=result)

  def _retry_or_shed(self, outer: Future, image, seed, slo, deadline_at,
                     request_id, excluded: frozenset, retries: int,
                     error: Exception) -> None:
    """Re-routes while the remaining slack covers one more dispatch and
    budget and replicas remain; else resolves the client with a typed
    ``RequestShed(class, "fault")``."""
    n = len(self.replicas)
    remaining_ms = (None if deadline_at is None
                    else (deadline_at - time.perf_counter()) * 1e3)
    slack_ok = (remaining_ms is None
                or remaining_ms >= self.health.retry_cost_ms)
    can_retry = (retries < self.health.max_retries and slack_ok
                 and len(excluded) < n)
    if can_retry:
      try:
        registry_lib.get_registry().counter("serving/retries").inc()
      except Exception:  # noqa: BLE001
        pass
      with self._health_lock:
        self._health_event("retry", None, request_id=request_id,
                           attempt=retries + 1)
      self._dispatch(outer, image, seed, slo, deadline_at, request_id,
                     excluded, retries + 1)
      return
    class_name = slo.name if slo is not None else "default"
    slack = None if remaining_ms is None else round(remaining_ms, 1)
    reason_detail = (f"{type(error).__name__}: {error} "
                     f"(retries={retries}, slack_ms={slack})")
    self.stats.record_shed(class_name, "fault")
    try:
      self._recorder.trigger("slo_breach", slo_class=class_name,
                             shed_reason="fault", request_id=request_id)
    except Exception:  # noqa: BLE001
      pass
    self._resolve_outer(
        outer, error=RequestShed(class_name, "fault", detail=reason_detail))

  @staticmethod
  def _resolve_outer(outer: Future, result=None, error=None) -> None:
    if outer.done():
      return  # the client cancelled; the answer has no audience
    if not outer.set_running_or_notify_cancel():
      return
    try:
      if error is not None:
        outer.set_exception(error)
      else:
        outer.set_result(result)
    except Exception:  # noqa: BLE001
      pass

  def check_q_drift(self) -> dict:
    """The fleet Q-drift guard: each replica's served-Q sketch against
    the rest of the fleet (``obs/health.q_drift_report`` at the
    HealthConfig thresholds). A replica turning divergent fires the
    ``replica_divergent`` trigger, bumps ``health/replica_divergent`` and
    lands a timeline event; one recovering lands ``replica_converged``."""
    report = health_lib.q_drift_report(
        self.stats.q_sketch_summaries(),
        z_threshold=self.health.q_drift_z,
        min_samples=self.health.q_drift_min_samples,
        min_scale=self.health.q_drift_min_scale)
    divergent = set(report["divergent"])
    index_of = {replica.label: i for i, replica in enumerate(self.replicas)}
    with self._health_lock:
      newly = sorted(divergent - self._divergent_replicas)
      recovered = sorted(self._divergent_replicas - divergent)
      self._divergent_replicas = divergent
      for name in newly:
        self._health_event("replica_divergent", index_of.get(name),
                           delta=report["replicas"][name].get("delta"))
      for name in recovered:
        self._health_event("replica_converged", index_of.get(name))
    for name in newly:
      try:
        registry_lib.get_registry().counter(
            "health/replica_divergent").inc()
      except Exception:  # noqa: BLE001
        pass
      try:
        self._recorder.trigger(
            "replica_divergent", replica=name,
            delta=report["replicas"][name].get("delta"),
            fleet_median=report.get("fleet_median"))
      except Exception:  # noqa: BLE001
        pass
    return report

  def health_snapshot(self) -> dict:
    """Breaker states a replica, the transition timeline and the Q-drift
    verdict; ``health`` is "ok" only with no breaker open and no replica
    divergent."""
    q_drift = self.check_q_drift()
    with self._health_lock:
      snapshot = {
          "replicas": {
              replica.label: {
                  "state": breaker.state,
                  "consecutive_failures": breaker.consecutive_failures,
                  "dispatcher_restarts":
                      replica.batcher.dispatcher_restarts,
                  "dispatcher_dead": replica.batcher.dispatcher_dead,
              }
              for replica, breaker in zip(self.replicas, self._breakers)
          },
          "degraded": self._degraded,
          "q_drift": q_drift,
          "timeline": [dict(entry) for entry in self._health_events],
      }
    all_closed = all(entry["state"] == "closed"
                     for entry in snapshot["replicas"].values())
    snapshot["health"] = (
        "ok" if all_closed and q_drift["verdict"] != "divergent"
        else "degraded")
    return snapshot

  def act(self, image, slo: Optional[SLOClass] = None,
          timeout: Optional[float] = None) -> np.ndarray:
    """Blocking control step through the routed fleet."""
    return self.submit(image, slo=slo).result(timeout)

  # -- observability ---------------------------------------------------------

  def compile_ledger(self) -> dict:
    """{replica label: {bucket: builds}} of the current tier's policies;
    every inner value 1. Across a ``set_precision`` the shared ``ledger``
    is the record of every tier."""
    return {replica.label: dict(replica.policy.compile_counts)
            for replica in self.replicas}

  def snapshot(self) -> dict:
    """The stats, the ledger, the queue depths and the health."""
    out = self.stats.snapshot()
    out["replicas"] = len(self.replicas)
    out["precision"] = self.precision
    out["compile_ledger"] = self.compile_ledger()
    out["replica_pending"] = [replica.batcher.pending()
                              for replica in self.replicas]
    out["health"] = self.health_snapshot()
    return out

  def write_metrics(self, step: Optional[int] = None) -> None:
    if self._metric_writer is None:
      return
    if step is None:
      step = self._metric_step
      self._metric_step += 1
    self.stats.write_to(self._metric_writer, step)
