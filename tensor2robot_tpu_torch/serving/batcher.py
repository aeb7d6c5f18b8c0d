"""Deadline-driven, SLO-aware micro-batcher for multi-client inference.

Counterpart of ``tensor2robot_tpu/serving/batcher.py``, the same code.
Concurrent clients enqueue one item each (``submit`` returns a Future); a
single dispatcher thread flushes pending requests into ``batch_fn`` when
``max_batch`` are pending or the pending request with the EARLIEST
deadline has spent its budget, so a lone robot never waits past its
class's deadline and a busy fleet ships full batches.

Order is earliest-deadline-first (``serving/slo.py``); with one class
every deadline is enqueue time plus a constant, so EDF is FIFO. With a
``max_queue`` bound, an arrival into a full queue evicts the
lowest-priority pending request (the latest deadline breaks ties; the
arrival itself when it is the lowest) with ``RequestShed``; a request
whose deadline is already past at enqueue is shed at once. Every shed is
counted by class and triggers an ``slo_breach`` flight-recorder dump.

The obs spine: ``serve/enqueue`` spans carry each request's correlation
id, ``serve/flush`` spans the batch's joined ids (the dispatcher binds
them itself: contextvars do not cross threads), and the dispatcher beats a
``serve/batcher`` heartbeat (busy while work is pending, idle on an empty
queue). A dispatcher killed by a non-``Exception`` restarts up to
``restart_budget`` times; past it every pending Future resolves
``DispatcherDead`` and new submits raise.

``fault_plan=`` (the fault-injection seam) waits for ``ROADMAP.md``'s
flagship item 15c and raises when given.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

from tensor2robot_tpu_torch.obs import context as context_lib
from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import registry as registry_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.obs import watchdog as watchdog_lib
from tensor2robot_tpu_torch.serving.slo import (
    DispatcherDead,
    RequestShed,
    SLOClass,
)
from tensor2robot_tpu_torch.serving.stats import ServingStats


class _Request:
  __slots__ = ("item", "future", "enqueued_at", "deadline", "flush_at",
               "slo", "shed", "request_id")

  def __init__(self, item: Any, slo: SLOClass,
               deadline_at: Optional[float], margin_s: float,
               request_id: Optional[str] = None):
    self.item = item
    self.future: Future = Future()
    # The caller's id, else the bound one, else a fresh one: direct
    # clients get timelines too.
    self.request_id = (request_id or context_lib.current_request_id()
                       or context_lib.new_request_id())
    self.enqueued_at = time.perf_counter()
    # `deadline` is the client's budget (the expiry and shed basis);
    # `flush_at` is when a partial batch must ship for the answer to land
    # inside it: the deadline less the dispatch margin.
    self.deadline = (self.enqueued_at + slo.deadline_ms / 1e3
                     if deadline_at is None else deadline_at)
    self.flush_at = max(self.enqueued_at, self.deadline - margin_s)
    self.slo = slo
    self.shed = False  # lazy heap deletion marker


class MicroBatcher:
  """Batches concurrent ``submit`` calls into ``batch_fn`` flushes.

  Args:
    batch_fn: takes the pending items (EDF order) and returns one result
      an item, in order. Runs on the dispatcher thread; an exception fails
      that flush's requests, never the batcher.
    max_batch: flush at once when this many requests are pending.
    deadline_ms: the budget of the default class (a class-less submit).
    stats: optional ServingStats for flush, occupancy, latency and shed
      counters; `bucket_for` maps a flush size to the slots it occupies
      (e.g. ``BucketLadder.bucket_for``; identity when absent).
    max_queue: the pending-queue bound (None: unbounded).
    dispatch_margin_ms: the flush's own cost, budgeted: a partial batch
      ships this long before its head's deadline (0 flushes at it).
    flight_recorder: receives every shed as an ``slo_breach`` trigger and
      the dispatcher's failures (default: the process recorder).
    watchdog: takes the dispatcher's ``serve/batcher`` heartbeat
      (default: the process watchdog).
    fault_plan: waits for ``ROADMAP.md``'s flagship item 15c; refused.
    site: this batcher's name in its dispatcher-death triggers.
    restart_budget: dispatcher restarts before the batcher goes down.
  """

  def __init__(self, batch_fn: Callable[[Sequence[Any]], Sequence[Any]],
               max_batch: int = 16, deadline_ms: float = 5.0,
               stats: Optional[ServingStats] = None,
               bucket_for: Optional[Callable[[int], int]] = None,
               max_queue: Optional[int] = None,
               dispatch_margin_ms: float = 0.0,
               flight_recorder: Optional[flight_lib.FlightRecorder] = None,
               watchdog: Optional[watchdog_lib.Watchdog] = None,
               fault_plan=None,
               site: str = "batcher",
               restart_budget: int = 3):
    if fault_plan is not None:
      raise NotImplementedError(
          "MicroBatcher(fault_plan=) injects faults through obs/faults.py, "
          "which waits for ROADMAP.md's flagship item 15c (the obs tier).")
    if max_batch < 1:
      raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if deadline_ms < 0:
      raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
    if max_queue is not None and max_queue < 1:
      raise ValueError(f"max_queue must be >= 1, got {max_queue}")
    if dispatch_margin_ms < 0:
      raise ValueError(
          f"dispatch_margin_ms must be >= 0, got {dispatch_margin_ms}")
    if restart_budget < 0:
      raise ValueError(
          f"restart_budget must be >= 0, got {restart_budget}")
    self._batch_fn = batch_fn
    self._max_batch = max_batch
    self._margin_s = dispatch_margin_ms / 1e3
    self._default_slo = SLOClass("default", 0, deadline_ms)
    self._stats = stats
    self._bucket_for = bucket_for or (lambda n: n)
    self._max_queue = max_queue
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self._watchdog = watchdog or watchdog_lib.get_watchdog()
    self._heartbeat: Optional[watchdog_lib.Heartbeat] = None
    # Min-heap of (flush_at, seq, request); shed entries stay with
    # request.shed set and are skipped on pop; _live counts the rest.
    self._heap: list = []
    self._live = 0
    self._in_flight = 0
    self._seq = itertools.count()
    self._cond = threading.Condition()
    self._running = False
    self._thread: Optional[threading.Thread] = None
    self._release = threading.Event()  # hold_flushes gate; normally set
    self._release.set()
    self._site = site
    self._restart_budget = restart_budget
    self.dispatcher_restarts = 0
    self.dispatcher_dead = False
    # The dispatcher loop's passes (a busy-spinning dispatcher shows as
    # growth while idle).
    self._dispatch_iterations = 0

  # -- lifecycle -----------------------------------------------------------

  def start(self) -> "MicroBatcher":
    with self._cond:
      if self._running:
        return self
      if self.dispatcher_dead:
        raise DispatcherDead("cannot restart a batcher that exhausted "
                             "its dispatcher restart budget")
      self._running = True
    self._heartbeat = self._watchdog.register("serve/batcher")
    self._spawn_dispatcher()
    return self

  def _spawn_dispatcher(self) -> None:
    self._thread = threading.Thread(
        target=self._dispatcher_main, name="micro-batcher", daemon=True)
    self._thread.start()

  def stop(self) -> None:
    """Stops accepting work, drains what is queued, joins the thread (and
    any thread a racing restart spawned), unregisters the heartbeat."""
    with self._cond:
      self._running = False
      self._cond.notify_all()
    while True:
      thread = self._thread
      if thread is None or thread is threading.current_thread():
        break
      thread.join()
      if self._thread is thread:
        self._thread = None
        break
    if self._heartbeat is not None:
      self._watchdog.unregister(self._heartbeat)
      self._heartbeat = None

  def __enter__(self) -> "MicroBatcher":
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.stop()

  # -- client side ---------------------------------------------------------

  @property
  def max_batch(self) -> int:
    return self._max_batch

  @property
  def max_queue(self) -> Optional[int]:
    return self._max_queue

  def use_stats(self, stats: Optional[ServingStats]) -> None:
    """Swaps the stats sink (between measurement phases, while idle)."""
    self._stats = stats

  def pending(self) -> int:
    """Pending + in-flight requests: a router's load signal."""
    with self._cond:
      return self._live + self._in_flight

  def _raise_not_running_locked(self) -> None:
    """A stopped batcher raises RuntimeError (the caller's bug); a dead
    one raises the typed DispatcherDead."""
    if self.dispatcher_dead:
      raise DispatcherDead("restart budget exhausted; batcher is down")
    raise RuntimeError("MicroBatcher is not running; call start().")

  @contextlib.contextmanager
  def hold_flushes(self):
    """Blocks dispatch (not admission) until exit: requests queue and
    shed by the EDF and priority rules, but none is popped for a flush
    while held, so the shed composition is a function of the arrivals
    and the queue bound alone."""
    self._release.clear()
    try:
      yield self
    finally:
      self._release.set()
      with self._cond:
        self._cond.notify_all()

  def submit(self, item: Any, slo: Optional[SLOClass] = None,
             deadline_at: Optional[float] = None,
             request_id: Optional[str] = None) -> Future:
    """Enqueues one item; the Future resolves to its batch_fn result.

    Args:
      item: opaque payload handed to batch_fn.
      slo: the request's class; None is the default class (the
        constructor's deadline_ms, priority 0).
      deadline_at: an absolute deadline (``time.perf_counter()`` basis)
        set upstream; overrides the class budget. One already past sheds
        the request at once.
      request_id: a correlation id minted upstream; None takes the bound
        id or mints one.
    """
    slo = slo or self._default_slo
    request = _Request(item, slo, deadline_at, self._margin_s,
                       request_id=request_id)
    # The request timeline's first hop: admission (and an eviction), with
    # the id the exported flow links to the flush that ships it.
    with trace_lib.span("serve/enqueue", request_id=request.request_id,
                        slo=slo.name):
      # Expired at enqueue: shed at once, never enqueued. A stopped
      # batcher still raises first.
      if request.deadline < request.enqueued_at:
        with self._cond:
          if not self._running:
            self._raise_not_running_locked()
        if self._stats is not None:
          self._stats.record_request(slo.name)
        self._shed(request, "expired")
        return request.future
      with self._cond:
        if not self._running:
          self._raise_not_running_locked()
        victim = None
        if self._max_queue is not None and self._live >= self._max_queue:
          victim = self._pick_victim_locked(request)
        if victim is not request:
          head_flush_at = self._head_flush_at_locked()
          heapq.heappush(self._heap,
                         (request.flush_at, next(self._seq), request))
          self._live += 1
          # Wake the dispatcher only when its state changes: the first
          # pending item, a new earliest deadline, or a full batch.
          if (head_flush_at is None or request.flush_at < head_flush_at
              or self._live >= self._max_batch):
            self._cond.notify()
      if self._stats is not None:
        self._stats.record_request(slo.name)
      if victim is not None:
        self._shed(victim, "capacity")
      return request.future

  def _pick_victim_locked(self, incoming: _Request) -> Optional[_Request]:
    """The lowest-priority pending request (the latest deadline breaks
    ties), the incoming one included."""
    victim = incoming
    for _, _, request in self._heap:
      if request.shed:
        continue
      if (request.slo.priority, -request.deadline) < (
          victim.slo.priority, -victim.deadline):
        victim = request
    if victim is not incoming:
      victim.shed = True
      self._live -= 1
    return victim

  def _head_flush_at_locked(self) -> Optional[float]:
    """The earliest live flush time; purges shed entries off the top."""
    while self._heap and self._heap[0][2].shed:
      heapq.heappop(self._heap)
    return self._heap[0][0] if self._heap else None

  def _shed(self, request: _Request, reason: str) -> None:
    if self._stats is not None:
      self._stats.record_shed(request.slo.name, reason)
    # Resolve the future first: the diagnostics below must never leave a
    # shed client blocked.
    if request.future.set_running_or_notify_cancel():
      request.future.set_exception(RequestShed(request.slo.name, reason))
    # Every shed is an SLO breach: a rate-limited dump, best-effort.
    try:
      self._recorder.trigger("slo_breach", slo_class=request.slo.name,
                             shed_reason=reason,
                             request_id=request.request_id)
    except Exception:  # noqa: BLE001 — a shed never becomes a storage error
      pass

  # -- dispatcher ----------------------------------------------------------

  def _dispatcher_main(self) -> None:
    """Thread entry: the loop, and the death handler for anything that
    escapes it."""
    try:
      self._dispatch_loop()
    except BaseException as e:  # noqa: BLE001 — the death handler
      self._on_dispatcher_death(e)

  def _on_dispatcher_death(self, exc: BaseException) -> None:
    detail = f"{type(exc).__name__}: {exc}"
    with self._cond:
      restart = (self._running
                 and self.dispatcher_restarts < self._restart_budget)
      if restart:
        self.dispatcher_restarts += 1
      else:
        self.dispatcher_dead = True
        self._running = False
    self._recorder.trigger(
        "batcher_dispatcher_death", site=self._site, error=detail,
        restarts=self.dispatcher_restarts,
        restart_budget=self._restart_budget, recovered=restart)
    try:
      registry_lib.get_registry().counter(
          "serving/dispatcher_restarts" if restart
          else "serving/dispatcher_deaths").inc()
    except Exception:  # noqa: BLE001 — diagnostics never block recovery
      pass
    if restart:
      # The queue survives; only the in-flight batch already failed.
      self._spawn_dispatcher()
      return
    # Down: every pending future resolves, and the heartbeat stays
    # registered and busy, so a running watchdog escalates the outage.
    self._fail_all_pending(DispatcherDead(detail))
    heartbeat = self._heartbeat
    if heartbeat is not None:
      heartbeat.busy()

  @staticmethod
  def _resolve_failed(future: Future, exc: Exception) -> None:
    """Fails a future in any state; one already resolved or cancelled is
    left alone."""
    try:
      future.set_exception(exc)
    except Exception:  # noqa: BLE001
      pass

  def _fail_all_pending(self, exc: Exception) -> None:
    with self._cond:
      pending = [request for _, _, request in self._heap
                 if not request.shed]
      self._heap.clear()
      self._live = 0
    for request in pending:
      self._resolve_failed(request.future, exc)

  def _dispatch_loop(self) -> None:
    while True:
      batch, deadline_expired = self._next_batch()
      if batch is None:
        return
      try:
        self._flush(batch, deadline_expired)
      except Exception as e:  # e.g. a raising bucket_for or stats hook:
        # the dispatcher outlives any flush failure.
        self._recorder.trigger("batcher_dispatcher_exception",
                               error=f"{type(e).__name__}: {e}")
        for request in batch:
          if not request.future.done():
            try:
              request.future.set_exception(e)
            except Exception:  # noqa: BLE001
              pass
      except BaseException as e:  # dying: this batch still resolves typed
        detail = f"{type(e).__name__}: {e}"
        for request in batch:
          self._resolve_failed(request.future, DispatcherDead(detail))
        raise
      finally:
        with self._cond:
          self._in_flight -= len(batch)

  def _next_batch(self):
    """Blocks until a flush is due; returns (requests, deadline_expired),
    or (None, _) at shutdown with an empty queue (stop() drains first).
    Each pass returns a batch, waits a strictly positive time, or waits
    untimed on an empty queue: a zero-slack deadline never spins."""
    heartbeat = self._heartbeat
    with self._cond:
      while True:
        self._dispatch_iterations += 1
        # Pending work arms the stall clock; an empty queue is idle.
        if heartbeat is not None:
          if self._live > 0:
            heartbeat.busy()
          else:
            heartbeat.idle()
        if not self._release.is_set() and self._running:
          # Held: nothing is popped. stop() overrides the hold, so a
          # drain always completes.
          self._cond.wait(timeout=0.05)
          continue
        head = self._head_flush_at_locked()
        if head is not None:
          now = time.perf_counter()
          if (self._live >= self._max_batch or now >= head
              or not self._running):
            n = min(self._live, self._max_batch)
            batch = []
            while len(batch) < n:
              _, _, request = heapq.heappop(self._heap)
              if not request.shed:
                batch.append(request)
            self._live -= n
            self._in_flight += n
            expired = now >= head and n < self._max_batch
            if heartbeat is not None:
              heartbeat.beat()
            return batch, expired
          self._cond.wait(timeout=head - now)
        elif not self._running:
          return None, False
        else:
          self._cond.wait()

  def _flush(self, batch, deadline_expired: bool) -> None:
    # RUNNING first: a request its client cancelled drops out, and the
    # rest can no longer be cancelled, so set_result below cannot raise.
    batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
    if not batch:
      return
    # The dispatcher is not the enqueuers' thread, so it binds the
    # batch's ids itself: serve/flush, and every span batch_fn opens,
    # carry them as one comma-joined `request_ids` attr.
    batch_ids = context_lib.join_ids(r.request_id for r in batch)
    with context_lib.bind(request_ids=batch_ids):
      with trace_lib.span("serve/flush", batch=len(batch)):
        try:
          results = self._batch_fn([r.item for r in batch])
        except Exception as e:  # fail the flush's requests, not the loop
          self._recorder.record("event", "flush_failed",
                                error=f"{type(e).__name__}: {e}",
                                batch=len(batch))
          for request in batch:
            request.future.set_exception(e)
          return
    done = time.perf_counter()
    for request, result in zip(batch, results):
      request.future.set_result(result)
      if self._stats is not None:
        self._stats.record_latency_ms(
            (done - request.enqueued_at) * 1e3, request.slo.name)
    if self._stats is not None:
      with self._cond:
        depth_after = self._live
      self._stats.record_flush(
          len(batch), self._bucket_for(len(batch)), depth_after,
          deadline_expired)
