"""Live checkpoint rollout: shadow -> canary -> promote, with rollback.

Counterpart of ``tensor2robot_tpu/serving/rollout.py``. Cutting a fleet
over to unvalidated variables is how a bad checkpoint becomes a
fleet-wide outage, so the ``RolloutController`` walks each candidate
through:

1. **shadow**: the candidate is scored beside the serving variables on
   one replica, and a fraction of live traffic is *mirrored* to it
   (clients still get the serving answer). Mirrored pairs are compared:
   action distance, latency, and the Q delta under the serving variables
   (the serving Q-function is the oracle, so "the candidate's actions
   score at least as well as ours" is a bar independent of the
   checkpoint).
2. **canary**: bars passed, a small fraction of live traffic is *served
   by* the candidate under the same accounting.
3. **promote**: the predictor's variables are hot-swapped
   (``set_variables``), which every replica copies into its own at its
   next flush: no capture.

A candidate failing a bar at either stage is rolled back: discarded with
an event in the timeline, the serving variables untouched.

The shadow replica scores a variables candidate through a live
replica's graphs (``CEMFleetPolicy``'s ``variables=`` override), so a
candidate adds nothing to the ledger. A precision candidate
(``offer_precision_candidate``) scores through that replica's policy at
the candidate tier, built and warmed with the fleet quiesced
(``FleetRouter.warm_policy``) before any traffic reaches it.

Refused by name: ``ExportWatcher(fault_plan=)``, the export-corruption
seam of ``obs/faults.py``, which waits for ``ROADMAP.md``'s flagship item
15.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np

from tensor2robot_tpu_torch.export import export_utils, variables_io
from tensor2robot_tpu_torch.obs import context as context_lib
from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import watchdog as watchdog_lib
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.serving.batcher import MicroBatcher
from tensor2robot_tpu_torch.serving.router import FleetRouter
from tensor2robot_tpu_torch.serving.slo import SLOClass

_log = logging.getLogger(__name__)


class ExportWatcher:
  """Finds and validates new candidate variables in an export root.

  Pull: ``poll()`` lists the root's versioned directories
  (``export_utils.list_export_versions``, the layout ``export_and_gc``
  publishes) and loads the newest unseen version's variables npz. Push:
  ``notify(export_dir, step)`` takes a trainer's export callback, so a
  co-resident trainer skips the poll latency. Either way the controller
  receives ``(version, variables)``.

  Every candidate is checked before it can enter a rollout: the
  directory exists, carries no mid-publish tmp marker, has its variables
  npz, and the npz parses (a truncated write fails the zip's checks at
  the load). A rejected directory fires an ``export_rejected``
  flight-recorder trigger naming it and the failure, is never swapped
  in, and is tried again at later polls (a directory mid-publish
  completes; a corrupt one keeps losing to the next good version).
  ``fault_plan=`` is refused (see the module docstring).
  """

  def __init__(self, export_root: str,
               load_fn: Optional[Callable[[str], dict]] = None,
               validate_fn: Optional[Callable[[str], None]] = None,
               fault_plan=None,
               flight_recorder=None):
    if fault_plan is not None:
      raise NotImplementedError(
          "ExportWatcher(fault_plan=) damages exports through "
          "obs/faults.py, which waits for ROADMAP.md's flagship item 15c "
          "(the obs tier).")
    self._export_root = export_root
    self._load_fn = load_fn or self._load_native
    # Structural validation applies to the layout loaded here; a custom
    # load_fn brings its own (or relies on the load raising).
    self._validate_fn = validate_fn or (
        self._validate_native if load_fn is None else None)
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self._seen = -1
    self._pushed: "queue.Queue" = queue.Queue()
    self.rejections: List[dict] = []

  @staticmethod
  def _load_native(export_dir: str) -> dict:
    return variables_io.load_variables(
        os.path.join(export_dir, export_utils.VARIABLES_NPZ))

  @staticmethod
  def _validate_native(export_dir: str) -> None:
    """Raises ValueError naming the defect when `export_dir` is not a
    complete native export: a missing directory, a mid-publish tmp
    marker, or no variables npz. The npz's own bytes are checked by the
    load, one call later."""
    if not os.path.isdir(export_dir):
      raise ValueError(f"export dir {export_dir} does not exist")
    entries = os.listdir(export_dir)
    tmp = [e for e in entries if "tmp" in e.lower()]
    if tmp:
      raise ValueError(
          f"export dir {export_dir} carries mid-publish tmp "
          f"markers: {tmp}")
    npz_path = os.path.join(export_dir, export_utils.VARIABLES_NPZ)
    if not os.path.isfile(npz_path):
      raise ValueError(f"export dir {export_dir} has no "
                       f"{export_utils.VARIABLES_NPZ}")

  def notify(self, export_dir: str, step: int) -> None:
    """The push entry (an export hook's ``on_export`` signature)."""
    self._pushed.put((int(step), export_dir))

  def _reject(self, version: int, export_dir: str, reason: str) -> None:
    entry = {"version": version, "export_dir": export_dir,
             "reason": reason}
    self.rejections.append(entry)
    _log.warning("export %s rejected: %s (will retry on later polls)",
                 export_dir, reason)
    try:
      # `detail`, not `reason`: the recorder's positional `reason` is the
      # trigger's name.
      self._recorder.trigger("export_rejected", version=version,
                             export_dir=export_dir, detail=reason)
    except Exception:  # noqa: BLE001 — diagnostics never stop the watcher
      pass

  def poll(self):
    """(version, variables) of the newest unseen valid export, else None.
    Pushed notifications win over the directory listing; a rejected
    candidate is recorded and tried again at the next poll."""
    candidate = None
    while True:  # drain the pushes, keep the newest
      try:
        step, export_dir = self._pushed.get_nowait()
      except queue.Empty:
        break
      if candidate is None or step > candidate[0]:
        candidate = (step, export_dir)
    if candidate is None:
      versions = export_utils.list_export_versions(self._export_root)
      newest = versions[-1] if versions else None
      if newest is not None and newest > self._seen:
        candidate = (newest,
                     os.path.join(self._export_root, str(newest)))
    if candidate is None or candidate[0] <= self._seen:
      return None
    version, export_dir = candidate
    if self._validate_fn is not None:
      try:
        self._validate_fn(export_dir)
      except Exception as e:  # noqa: BLE001 — any defect rejects
        self._reject(version, export_dir, f"{type(e).__name__}: {e}")
        return None
    try:
      variables = self._load_fn(export_dir)
    except Exception as e:  # noqa: BLE001 — any defect rejects
      self._reject(version, export_dir,
                   f"load failed: {type(e).__name__}: {e}")
      return None
    self._seen = version
    return version, variables


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
  """Canary bars and traffic fractions for the rollout state machine.

  The q bar is relative: mean(Q_serving(image, candidate_action) -
  Q_serving(image, live_action)) must stay above -max_q_regression.
  Equal-or-better candidates pass at any traffic mix; a regressed
  checkpoint (whose argmax actions score poorly under the serving
  oracle) fails in shadow before a single client saw it.
  """

  mirror_fraction: float = 0.25   # of live traffic mirrored in shadow
  canary_fraction: float = 0.10   # of live traffic SERVED by the canary
  min_shadow_samples: int = 24    # compared pairs before the shadow bar
  min_canary_samples: int = 12    # scored canary answers before promote
  max_q_regression: float = 0.05  # mean q-delta floor (serving-Q units)
  max_latency_ratio: float = 5.0  # shadow/live median latency ceiling
  seed: int = 0                   # mirror/canary sampling stream


class _PairSlot:
  """Collects the (live, shadow) action pair for one mirrored request."""

  __slots__ = ("image", "stage", "live", "shadow", "live_ms", "shadow_ms",
               "lock")

  def __init__(self, image, stage: int):
    self.image = image
    self.stage = stage
    self.live = self.shadow = None
    self.live_ms = self.shadow_ms = None
    self.lock = threading.Lock()


class RolloutController:
  """Shadow/canary checkpoint rollout over a FleetRouter.

  The client front door during a rollout: ``submit`` / ``act`` route
  through the live fleet exactly like the router's, plus the mirroring
  or canary routing the current phase calls for. `offer_candidate`
  starts an evaluation (the watcher's finds are offered automatically
  when `watcher` is given and `start()` has been called).

  Args:
    router: the live fleet.
    predictor: the SHARED predictor serving the fleet; promotion calls
      its ``set_variables`` (hot-swap, no capture).
    config: bars and fractions.
    q_fn: ``(images list, actions list) -> (n,) scores`` under the
      CURRENT serving params; defaults to predictor.predict's
      ``q_predicted`` head. Evaluated on the controller's worker
      thread, never on a replica dispatcher.
    watcher: optional ExportWatcher polled by the worker thread.
  """

  def __init__(self, router: FleetRouter, predictor,
               config: Optional[RolloutConfig] = None,
               q_fn: Optional[Callable] = None,
               watcher: Optional[ExportWatcher] = None,
               poll_s: float = 0.2,
               flight_recorder=None, watchdog=None):
    self._router = router
    self._predictor = predictor
    self._config = config or RolloutConfig()
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self._watchdog = watchdog or watchdog_lib.get_watchdog()
    self._q_fn = q_fn or self._default_q_fn
    self._watcher = watcher
    self._poll_s = poll_s
    self._rng = np.random.default_rng(self._config.seed)
    self._rng_lock = threading.Lock()
    self._lock = threading.Lock()
    self._state = "serving"
    # Bumped at every phase change: a mirrored pair counts only in the
    # phase it was submitted in, so pairs still in flight when a cycle
    # ends never land in the next candidate's phase.
    self._stage = 0
    self._candidate_version = None
    self._candidate_variables = None
    # A precision candidate: when set, the shadow flushes replay through
    # this policy (the shadow replica's policy at the candidate tier)
    # instead of the live policy's graphs, and promote flips the fleet's
    # tier (router.set_precision) rather than the predictor's variables.
    self._candidate_policy = None
    self._candidate_precision = None
    self._shadow_batcher: Optional[MicroBatcher] = None
    self._work: "queue.Queue" = queue.Queue()
    self._worker: Optional[threading.Thread] = None
    self._running = False
    # Set by stop() and never cleared by it: the tier-offer warm window
    # consults it so a stop() landing mid-warm stands the offer down
    # instead of starting a shadow batcher nothing will ever stop.
    self._stopped = False
    self._started_at = time.perf_counter()
    self.events: List[dict] = []
    self._reset_accumulators()

  # -- lifecycle -----------------------------------------------------------

  def start(self) -> "RolloutController":
    with self._lock:
      if self._running:
        return self
      self._running = True
      self._stopped = False
    self._worker = threading.Thread(
        target=self._run, name="rollout-controller", daemon=True)
    self._worker.start()
    return self

  def stop(self) -> None:
    with self._lock:
      self._stopped = True
      if not self._running:
        return
      self._running = False
    self._work.put(None)
    if self._worker is not None:
      self._worker.join()
      self._worker = None
    self._teardown_shadow()

  def __enter__(self) -> "RolloutController":
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.stop()

  # -- client API ----------------------------------------------------------

  def submit(self, image, slo: Optional[SLOClass] = None,
             request_id: Optional[str] = None) -> Future:
    """Routes one frame; mirrors or canaries it per the current phase.

    Both phases compare PAIRED on the same (image, seed): shadow pairs
    a live-served answer with a candidate mirror; canary pairs a
    candidate-SERVED answer (returned to the client) with a live
    mirror. Pairing is what makes the q-delta bar sharp — an
    equal-weights candidate scores delta exactly 0 instead of
    image-sampling noise.

    Exactly ONE ``router.submit`` happens per call in every phase
    (canary serves through the shadow batcher and mirrors through the
    router), so the router's logical-request counter counts client
    requests 1:1 whatever the rollout phase.
    """
    state, stage = self._state, self._stage  # racy read is fine: a
    # request misrouted by one transition is one more or fewer sample,
    # and its pair counts only while its phase lasts.
    seed = self._router.assign_seed()
    # ONE correlation id for the request AND any mirror/canary twin it
    # spawns: the mirror is the same logical request served twice, so
    # its spans join the parent's timeline. A caller-supplied id threads
    # through unchanged.
    request_id = request_id or context_lib.new_request_id()
    if state == "canary" and self._draw() < self._config.canary_fraction:
      future = self._shadow_submit(image, seed, slo=slo,
                                   request_id=request_id)
      if future is not None:
        # Canary-served requests are REAL client traffic: account them
        # in the fleet's per-class stats (request + completion latency)
        # so the artifact's p99 doesn't silently exclude exactly the
        # traffic a rollout perturbs. (The shadow queue is unbounded —
        # canary traffic cannot shed; the canary fraction is small and
        # the phase brief by construction.) The live MIRROR below is
        # scoring-only duplicate work, so it rides the default class:
        # never preempting real traffic, never inflating the client
        # class's request counts.
        if slo is not None:
          self._router.stats.record_request(slo.name)
          t0 = time.perf_counter()

          def _account(f, _name=slo.name, _t0=t0):
            if not f.cancelled() and f.exception() is None:
              self._router.stats.record_latency_ms(
                  (time.perf_counter() - _t0) * 1e3, _name)

          future.add_done_callback(_account)
        # The mirror's class: BELOW every real priority (sheds first,
        # never evicts client traffic) with the client's own budget as
        # its deadline — a class-less mirror would ride the 5ms default
        # class, whose flush_at collapses to "now" under the fleet's
        # dispatch margin and EDF-overtakes real traffic mid-rollout.
        mirror_slo = SLOClass(
            "rollout_mirror", priority=-1,
            deadline_ms=slo.deadline_ms if slo is not None else 100.0)
        live_mirror = self._router.submit(image, slo=mirror_slo,
                                          seed=seed,
                                          request_id=request_id)
        self._pair(image, live_mirror, future, stage)
        return future
      # Shadow torn down between the state read and the submit (a
      # rollback raced us): fall through to the live path.
    future = self._router.submit(image, slo=slo, seed=seed,
                                 request_id=request_id)
    if state == "shadow" and self._draw() < self._config.mirror_fraction:
      shadow_future = self._shadow_submit(image, seed,
                                          request_id=request_id)
      if shadow_future is not None:
        self._pair(image, future, shadow_future, stage)
    return future

  def act(self, image, slo: Optional[SLOClass] = None,
          timeout: Optional[float] = None) -> np.ndarray:
    return self.submit(image, slo=slo).result(timeout)

  def offer_candidate(self, version, variables) -> bool:
    """Starts evaluating a candidate; False if one is already in
    flight (the watcher re-offers on a later poll)."""
    with self._lock:
      if self._state != "serving" or self._stopped:
        # A stopped controller must never start a shadow batcher: its
        # worker is dead, so nothing would ever decide the stage and
        # the dispatcher thread would leak (same seam the precision
        # offer guards).
        return False
      self._enter_locked("shadow")
      self._candidate_version = version
      self._candidate_variables = variables
      self._reset_accumulators()
      self._start_shadow_batcher_locked()
    self._record("shadow_start", version=version)
    return True

  def offer_precision_candidate(self, precision: str,
                                version=None,
                                variables=None) -> bool:
    """Starts evaluating a PRECISION-TIER candidate: the
    same serving params scored through graphs captured at
    `precision` ("bf16") instead of the fleet's live tier — the first
    live-traffic promotion gate for a numerics change, and the pattern
    every future precision or kernel tier reuses.

    The identical shadow→canary→promote machinery runs: mirrored pairs
    share (image, seed) with the live answer, so the q-delta bar under
    the serving-params oracle measures EXACTLY the numerics difference
    (a tier that changes nothing reads near 0.0); promote calls
    ``router.set_precision`` — every replica hot-swaps to the tier,
    zero params touched — and auto-rollback at either stage leaves the
    fleet on its live tier untouched.

    `variables` (optional) scores the candidate tier over an explicit
    params tree instead of the predictor's live tree — the
    injected-breach seam: a corrupted tree through the candidate tier
    models a broken numerics change, and the q-delta bar must
    auto-roll it back.
    `version` defaults to the predictor's current model_version (a
    tier change ships no new params). False when a rollout is already
    in flight, same as offer_candidate.
    """
    cem.validate_precision(precision)
    if precision == self._router.precision and variables is None:
      raise ValueError(
          f"candidate tier {precision!r} is already the fleet's "
          "serving tier; nothing to prove")
    # RESERVE the cycle under the lock before paying the warmup: the
    # "warming" state rejects concurrent offers (both entry points
    # check for "serving"), so the seconds of bucket captures below
    # can never run on the shadow replica's device while ANOTHER
    # candidate's shadow phase is measuring latency pairs there.
    # submit() routes "warming" like "serving" (no mirroring yet).
    with self._lock:
      if self._state != "serving" or self._stopped:
        return False
      self._enter_locked("warming")
    try:
      # Build + WARM the tier policy before any live traffic mirrors
      # to it (outside the lock: bucket captures cost seconds). A
      # params candidate shares the live replica's warmed graphs,
      # so its shadow latency is comparable from the first pair; a
      # tier candidate has its OWN graphs, and without this
      # warmup the capture stalls land inside the mirrored latencies
      # and flunk the latency-ratio bar on a perfectly healthy tier.
      # router.warm_policy is the SAME build-and-warm recipe the
      # promote path runs per replica (answers discarded; memoized
      # policies make a re-offer's warmup a no-op walk).
      policy = self._router.warm_policy(
          self._router.replicas[-1].label, precision)
    except BaseException:
      with self._lock:
        if self._state == "warming":
          self._enter_locked("serving")  # release the reservation
      raise
    with self._lock:
      if self._state != "warming" or self._stopped:
        # stop() raced the warm window: starting a shadow batcher on a
        # stopped controller would leak its dispatcher thread and wedge
        # the state machine — release the reservation and stand down.
        if self._state == "warming":
          self._enter_locked("serving")
        return False
      self._enter_locked("shadow")
      self._candidate_version = (version if version is not None
                                 else self._predictor.model_version)
      self._candidate_variables = variables
      self._candidate_precision = precision
      self._candidate_policy = policy
      self._reset_accumulators()
      self._start_shadow_batcher_locked()
    self._record("shadow_start", version=self._candidate_version,
                 precision=precision)
    return True

  def _start_shadow_batcher_locked(self) -> None:
    replica = self._router.replicas[-1]
    self._shadow_batcher = MicroBatcher(
        lambda items, _replica=replica: self._shadow_flush(
            _replica, items),
        max_batch=replica.batcher.max_batch,
        deadline_ms=5.0).start()

  # -- status / artifact ---------------------------------------------------

  @property
  def state(self) -> str:
    return self._state

  def timeline(self) -> List[dict]:
    with self._lock:
      return [dict(event) for event in self.events]

  # -- internals -----------------------------------------------------------

  def _default_q_fn(self, images, actions):
    outputs = self._predictor.predict({
        "image": np.stack([np.asarray(i) for i in images]),
        "action": np.stack([np.asarray(a) for a in actions])})
    return np.asarray(outputs["q_predicted"])

  def _draw(self) -> float:
    with self._rng_lock:
      return float(self._rng.random())

  def _reset_accumulators(self) -> None:
    self._pairs_done = 0
    self._agreement = []
    self._q_live = []
    self._q_shadow = []
    self._lat_live_ms = []
    self._lat_shadow_ms = []

  def _shadow_submit(self, image, seed, slo: Optional[SLOClass] = None,
                     request_id: Optional[str] = None) -> Optional[Future]:
    batcher = self._shadow_batcher
    if batcher is None:
      return None
    try:
      return batcher.submit((np.asarray(image), int(seed)), slo=slo,
                            request_id=request_id)
    except RuntimeError:  # stopped between the check and the submit
      return None

  def _shadow_flush(self, replica, items):
    images = [item[0] for item in items]
    seeds = np.asarray([item[1] for item in items], np.uint32)
    policy = self._candidate_policy
    variables = self._candidate_variables
    if policy is not None:
      # Precision-tier candidate: dispatch through the tier-rebuilt
      # policy on this replica's device (its own graphs, tier-
      # suffixed ledger keys). `variables` rides along only on the
      # injected-breach path; the normal tier candidate scores the
      # predictor's LIVE params — the tier IS the change under test.
      if variables is None:
        return list(policy(images, seeds))
      return list(policy(images, seeds, variables=variables))
    if variables is None:
      # Torn down with requests still queued (a promote/rollback raced
      # a canary submit; stop() drains through here). Serve them with
      # the LIVE params instead of failing the clients: after a
      # promote the live params ARE the candidate, and after a
      # rollback the live answer is the correct one. Mirror-phase
      # pairs that land here just compare live-vs-live (q delta 0) —
      # at most one flush's worth, and the stage already ended.
      return list(replica.policy(images, seeds))
    return list(replica.policy(images, seeds, variables=variables))

  def _pair(self, image, live_future: Future, shadow_future: Future,
            stage: int) -> None:
    slot = _PairSlot(image, stage)
    t0 = time.perf_counter()

    def finish(which, future):
      try:
        action = future.result()
      except Exception:
        return  # shed/failed leg: drop the pair
      ms = (time.perf_counter() - t0) * 1e3
      with slot.lock:
        setattr(slot, which, np.asarray(action))
        setattr(slot, which + "_ms", ms)
        complete = slot.live is not None and slot.shadow is not None
      if complete:
        self._work.put(("pair", slot))

    live_future.add_done_callback(lambda f: finish("live", f))
    shadow_future.add_done_callback(lambda f: finish("shadow", f))

  def _run(self) -> None:
    # Liveness heartbeat: the worker wakes at least every
    # poll_s by construction, so a healthy controller beats steadily
    # and a wedged one (a q_fn stuck in device limbo) goes quiet and
    # trips the watchdog.
    heartbeat = self._watchdog.register("serve/rollout")
    try:
      while True:
        try:
          item = self._work.get(timeout=self._poll_s)
        except queue.Empty:
          item = "tick"
        heartbeat.beat()
        if item is None:
          return
        try:
          if item == "tick":
            self._tick()
          else:
            _, payload = item
            self._consume_pair(payload)
        except Exception as e:
          self._recorder.trigger("rollout_worker_exception",
                                 error=f"{type(e).__name__}: {e}")
          _log.exception("rollout worker step failed; continuing")
    finally:
      self._watchdog.unregister(heartbeat)

  def _tick(self) -> None:
    if self._watcher is None or self._state != "serving":
      return
    found = self._watcher.poll()
    if found is not None:
      self.offer_candidate(*found)

  def _consume_pair(self, slot: _PairSlot) -> None:
    state = self._state
    if state not in ("shadow", "canary") or slot.stage != self._stage:
      return  # a pair of an earlier phase or cycle
    # q under the SERVING params (the oracle): candidate actions must
    # score at least as well as the live answers for the same frames.
    scores = self._q_fn([slot.image, slot.image],
                        [slot.live, slot.shadow])
    with self._lock:
      if self._state != state or slot.stage != self._stage:
        return  # a transition raced this pair; its stage is over
      self._pairs_done += 1
      self._agreement.append(
          float(np.linalg.norm(slot.live - slot.shadow)))
      self._q_live.append(float(scores[0]))
      self._q_shadow.append(float(scores[1]))
      self._lat_live_ms.append(slot.live_ms)
      self._lat_shadow_ms.append(slot.shadow_ms)
      threshold = (self._config.min_shadow_samples if state == "shadow"
                   else self._config.min_canary_samples)
      decide = self._pairs_done >= threshold
    if decide:
      if state == "shadow":
        self._decide_shadow()
      else:
        self._decide_canary()

  @staticmethod
  def _median(values):
    return float(np.median(values)) if values else None

  def _shadow_metrics(self) -> dict:
    q_delta = (float(np.mean(self._q_shadow) - np.mean(self._q_live))
               if self._q_live else None)
    live_ms = self._median(self._lat_live_ms)
    shadow_ms = self._median(self._lat_shadow_ms)
    return {
        "pairs": self._pairs_done,
        "action_agreement_l2_mean": round(
            float(np.mean(self._agreement)), 5) if self._agreement
        else None,
        "q_delta_mean": round(q_delta, 5) if q_delta is not None
        else None,
        "latency_live_p50_ms": round(live_ms, 3) if live_ms else None,
        "latency_shadow_p50_ms": round(shadow_ms, 3) if shadow_ms
        else None,
    }

  def _decide_shadow(self) -> None:
    with self._lock:
      if self._state != "shadow":
        return
      metrics = self._shadow_metrics()
      # Bar on the RAW mean, not the display-rounded metrics field —
      # the canary stage compares raw, and the two stages must enforce
      # the same bar.
      raw_q_delta = (float(np.mean(self._q_shadow) -
                           np.mean(self._q_live))
                     if self._q_live else None)
      q_ok = (raw_q_delta is not None and
              raw_q_delta >= -self._config.max_q_regression)
      live_ms = self._median(self._lat_live_ms)
      shadow_ms = self._median(self._lat_shadow_ms)
      latency_ok = (not live_ms or not shadow_ms or
                    shadow_ms / max(live_ms, 1e-9)
                    <= self._config.max_latency_ratio)
      version = self._candidate_version
      precision = self._candidate_precision
    tier = {} if precision is None else {"precision": precision}
    # Event BEFORE the state flip: callers poll `state` to learn a
    # cycle finished, so the timeline must already carry its terminal
    # event when `state` reads "serving" (the flip is the publication
    # point; recording after it is a read-your-writes race).
    if q_ok and latency_ok:
      self._record("canary_start", version=version, **tier, **metrics)
      with self._lock:
        if self._state != "shadow":
          return
        self._enter_locked("canary")
        self._reset_accumulators()  # canary pairs judged on their own
    else:
      self._record("auto_rollback", version=version, stage="shadow",
                   q_bar_passed=q_ok, latency_bar_passed=latency_ok,
                   **tier, **metrics)
      with self._lock:
        stale_batcher = self._rollback_locked()
      if stale_batcher is not None:
        stale_batcher.stop()

  def _decide_canary(self) -> None:
    with self._lock:
      if self._state != "canary":
        return
      q_delta = float(np.mean(self._q_shadow) - np.mean(self._q_live))
      metrics = dict(self._shadow_metrics(),
                     canary_pairs=self._pairs_done)
      version = self._candidate_version
      precision = self._candidate_precision
      promote = q_delta >= -self._config.max_q_regression
      variables = self._candidate_variables if promote else None
    tier = {} if precision is None else {"precision": precision}
    if promote:
      # set_variables / set_precision outside the lock: both touch
      # device state and must not block submit()'s state reads. A
      # params candidate hot-swaps the predictor's tree (atomic GIL
      # pointer swap, replicas pick it up at their next flush — zero
      # captures; the candidate's version rides along so restore()'s
      # newest-wins check can't later overwrite the promotion with an
      # older on-disk checkpoint). A PRECISION candidate flips the
      # whole fleet's scoring tier instead — every replica swaps to a
      # tier-rebuilt policy; params untouched unless the candidate
      # carried an explicit tree (then both install, params first so
      # the tier's first flush already serves them).
      if variables is not None:
        self._predictor.set_variables(variables, version=version)
      if precision is not None:
        self._router.set_precision(precision)
      self._record("promote", version=version, **tier, **metrics)
    else:
      self._record("auto_rollback", version=version, stage="canary",
                   **tier, **metrics)
    # Terminal event recorded; NOW publish the state flip (see
    # _decide_shadow) and tear the shadow down outside the lock.
    with self._lock:
      stale_batcher = self._rollback_locked()
    if stale_batcher is not None:
      stale_batcher.stop()

  def _enter_locked(self, state: str) -> None:
    """Caller holds the lock: a phase change."""
    self._state = state
    self._stage += 1

  def _rollback_locked(self) -> Optional[MicroBatcher]:
    """Caller holds the lock: discard the candidate (serving params
    untouched) and hand back the shadow batcher — the CALLER stops it
    after releasing the lock (stop joins the shadow dispatcher thread,
    whose in-flight flush may be blocked recording into our state)."""
    self._enter_locked("serving")
    self._candidate_version = None
    self._candidate_variables = None
    # The tier policy's graphs stay registered (built exactly
    # once, tier-suffixed keys) — dropping the policy object is enough;
    # a re-offered tier candidate builds a fresh policy whose ledger
    # rows would expose any rebuild.
    self._candidate_policy = None
    self._candidate_precision = None
    batcher, self._shadow_batcher = self._shadow_batcher, None
    return batcher

  def _teardown_shadow(self) -> None:
    with self._lock:
      batcher, self._shadow_batcher = self._shadow_batcher, None
    if batcher is not None:
      batcher.stop()

  def _record(self, event: str, **fields) -> None:
    entry = {"event": event,
             "t_s": round(time.perf_counter() - self._started_at, 3)}
    entry.update(fields)
    with self._lock:
      self.events.append(entry)
    # Rollout events join the flight-recorder ring; an auto-rollback is
    # a post-mortem trigger — the dump carries the shadow/canary spans
    # and metrics that led to the decision.
    if event == "auto_rollback":
      self._recorder.trigger(
          "rollout_auto_rollback",
          version=fields.get("version"), stage=fields.get("stage"))
    else:
      self._recorder.record("event", f"rollout_{event}",
                            version=fields.get("version"))
    _log.info("rollout %s: %s", event, fields)
