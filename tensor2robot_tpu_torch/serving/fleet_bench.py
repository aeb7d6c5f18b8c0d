"""Fleet-serving bench: offered-load sweep and rollout, the FLEET_r11 keys.

Counterpart of ``tensor2robot_tpu/serving/fleet_bench.py``. Drives the
whole routed fleet (SLO-aware micro-batchers, the least-loaded router
over several replicas, the shadow/canary rollout controller) under
open-loop Poisson arrivals across three service classes, and returns one
dict with the JAX artifact's keys:

- each class's p50/p99 latency against its budget at every offered-load
  point;
- each class's sheds in a deliberate overload burst (the lowest priority
  class sheds first);
- the promotion timeline: one shadow -> canary -> promote of a healthy
  candidate and one injected-regression auto-rollback, under live load;
- the compile ledger: one graph a bucket a replica, across warm-up, the
  sweep, the burst and both rollout cycles.

Open-loop arrivals, not closed-loop clients: a closed-loop client slows
down when the server does and hides overload. Each class's arrivals are
one merged Poisson process at clients x hz, so many logical clients cost
one pacer thread a class.

``--devices N`` runs N replicas on the one device (``--device``, the
card unless "cpu" is asked for): the port has no virtual mesh. On the
CPU (``virtual_mesh`` true, the JAX key's caveat) the replicas share the
host's cores, and the rates say nothing about a card; what a CPU run
shows is the structure (the ledger, the sheds' order, the rollout
cycle). The rollout cycles end when the controller returns to serving
(bounded by ``rollout_cycle_s``), not after a fixed wait.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.serving.slo import RequestShed, SLOClass
from tensor2robot_tpu_torch.serving.stats import ServingStats

# The JAX protocol's class ladder: the budgets are host-scale; the
# structure (interactive above batch in priority, below it in budget) is
# the contract a deployment retunes.
R11_CLASSES: Tuple[Tuple[SLOClass, int, float], ...] = (
    # (class, clients, hz_per_client)
    (SLOClass("interactive", priority=2, deadline_ms=150.0), 32, 1.0),
    (SLOClass("standard", priority=1, deadline_ms=400.0), 64, 1.0),
    (SLOClass("batch", priority=0, deadline_ms=1500.0), 32, 1.0),
)
R01_CLIENTS = 16  # the single replica's 16 clients, the JAX key's base


def _percentile_ok(p99: Optional[float], budget_ms: float) -> bool:
  return p99 is not None and p99 <= budget_ms


class _ClassCounters:
  """Completion accounting one snapshot can't give us (achieved rate)."""

  def __init__(self):
    self.lock = threading.Lock()
    self.submitted = 0
    self.completed = 0
    self.shed = 0
    self.failed = 0

  def done_callback(self, future):
    with self.lock:
      try:
        future.result()
        self.completed += 1
      except RequestShed:
        self.shed += 1
      except Exception:
        self.failed += 1


def _run_open_loop_point(submit, classes, images, multiplier: float,
                         duration_s: float, seed: int,
                         stop: Optional[threading.Event] = None) -> Dict:
  """One offered-load point: per-class Poisson pacers for duration_s,
  or until `stop` is set.

  `submit(image, slo)` is the front door (the rollout controller's when
  a rollout phase should ride this point's traffic, else the router's).
  Returns the point's completion counters; latency/shed percentiles are
  read from the ServingStats the caller installed for this point.
  """
  counters = {spec[0].name: _ClassCounters() for spec in classes}
  futures: List = []
  futures_lock = threading.Lock()
  stop_at = time.perf_counter() + duration_s

  def pacer(spec_index: int, spec):
    slo_class, clients, hz = spec
    rate = clients * hz * multiplier
    if rate <= 0:
      return
    rng = np.random.default_rng(seed + 1000 * spec_index)
    counter = counters[slo_class.name]
    frames = images[slo_class.name]
    i = 0
    next_t = time.perf_counter()
    while True:
      next_t += rng.exponential(1.0 / rate)
      if next_t >= stop_at or (stop is not None and stop.is_set()):
        return
      delay = next_t - time.perf_counter()
      if delay > 0:
        time.sleep(delay)
      future = submit(frames[i % len(frames)], slo_class)
      i += 1
      with counter.lock:
        counter.submitted += 1
      future.add_done_callback(counter.done_callback)
      with futures_lock:
        futures.append(future)

  threads = [threading.Thread(target=pacer, args=(i, spec), daemon=True)
             for i, spec in enumerate(classes)]
  start = time.perf_counter()
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join()
  pace_elapsed = time.perf_counter() - start
  # Drain stragglers so the point's percentiles include its own tail;
  # the tail belongs to the pacing window's offered load, so the rate
  # denominator is the window, not window + drain.
  deadline = time.monotonic() + 30.0
  with futures_lock:
    pending = list(futures)
  for future in pending:
    try:
      future.result(timeout=max(0.0, deadline - time.monotonic()))
    except Exception:
      pass
  drain_s = time.perf_counter() - start - pace_elapsed
  total_submitted = sum(c.submitted for c in counters.values())
  total_completed = sum(c.completed for c in counters.values())
  return {
      "elapsed_s": round(pace_elapsed, 3),
      "drain_s": round(drain_s, 3),
      "submitted": total_submitted,
      "completed": total_completed,
      "achieved_hz": round(total_completed / pace_elapsed, 1),
      "counters": counters,
  }


def _point_report(point: Dict, classes, stats_snapshot: Dict,
                  multiplier: float) -> Dict:
  offered_hz = sum(clients * hz for _, clients, hz in classes) * multiplier
  per_class = {}
  all_met = True
  for slo_class, clients, hz in classes:
    snap = stats_snapshot.get("per_class", {}).get(slo_class.name, {})
    counter = point["counters"][slo_class.name]
    p99 = snap.get("latency_p99_ms")
    met = _percentile_ok(p99, slo_class.deadline_ms)
    all_met = all_met and met
    per_class[slo_class.name] = {
        "budget_ms": slo_class.deadline_ms,
        "priority": slo_class.priority,
        "clients": clients,
        "offered_hz": round(clients * hz * multiplier, 2),
        "submitted": counter.submitted,
        "completed": counter.completed,
        "shed": snap.get("shed", 0),
        "shed_expired": snap.get("shed_expired", 0),
        "shed_capacity": snap.get("shed_capacity", 0),
        "shed_rate": snap.get("shed_rate", 0.0),
        "latency_p50_ms": snap.get("latency_p50_ms"),
        "latency_p99_ms": p99,
        "met_budget": met,
    }
  return {
      "load_multiplier": multiplier,
      "offered_total_hz": round(offered_hz, 1),
      "achieved_total_hz": point["achieved_hz"],
      "elapsed_s": point["elapsed_s"],
      "drain_s": point["drain_s"],
      "submitted": point["submitted"],
      "completed": point["completed"],
      "per_class": per_class,
      "all_budgets_met": all_met,
      "batch_occupancy": stats_snapshot.get("batch_occupancy"),
      "flushes": stats_snapshot.get("flushes"),
  }


def _overload_burst(router, classes, images,
                    burst: Optional[int] = None) -> Dict:
  """Deliberate overload: a burst of 2x the fleet's total queue slots,
  interleaved across classes in client proportion, offered with
  flushes HELD (MicroBatcher.hold_flushes) — so admission and shedding
  decisions are a pure function of the arrival sequence and the queue
  bound, not of this host's drain speed. The per-class counters then
  measure the graceful-degradation claim deterministically: shedding
  consumes the LOWEST priority class first and the highest class rides
  through untouched (the structure/ledger tier of the repo's
  timing-bar convention — no timing in the assertion at all)."""
  import contextlib

  stats = ServingStats()
  router.use_stats(stats)
  if burst is None:
    slots = sum(r.batcher.max_queue or 0 for r in router.replicas)
    burst = max(2 * slots, 64)
  counters = {spec[0].name: _ClassCounters() for spec in classes}
  weights = np.array([clients for _, clients, _ in classes], np.float64)
  schedule = np.repeat(np.arange(len(classes)),
                       np.maximum(1, (weights / weights.sum()
                                      * burst).astype(int)))
  rng = np.random.default_rng(0)
  rng.shuffle(schedule)
  futures = []
  with contextlib.ExitStack() as stack:
    for replica in router.replicas:
      stack.enter_context(replica.batcher.hold_flushes())
    for i, class_index in enumerate(schedule):
      slo_class = classes[class_index][0]
      frames = images[slo_class.name]
      counter = counters[slo_class.name]
      future = router.submit(frames[i % len(frames)], slo=slo_class)
      counter.submitted += 1
      future.add_done_callback(counter.done_callback)
      futures.append(future)
  deadline = time.monotonic() + 60.0
  for future in futures:
    try:
      future.result(timeout=max(0.0, deadline - time.monotonic()))
    except Exception:
      pass
  snap = stats.snapshot()
  per_class = {}
  for slo_class, clients, _ in classes:
    class_snap = snap.get("per_class", {}).get(slo_class.name, {})
    per_class[slo_class.name] = {
        "priority": slo_class.priority,
        "submitted": counters[slo_class.name].submitted,
        "completed": counters[slo_class.name].completed,
        "shed": class_snap.get("shed", 0),
        "shed_rate": class_snap.get("shed_rate", 0.0),
    }
  # Graceful degradation, measured: shed rate must be monotone
  # non-increasing in priority.
  by_priority = sorted(per_class.values(), key=lambda e: e["priority"])
  ordering_ok = all(
      by_priority[i]["shed_rate"] >= by_priority[i + 1]["shed_rate"]
      - 1e-9
      for i in range(len(by_priority) - 1))
  return {
      "burst": int(len(schedule)),
      "shed_total": snap.get("shed_total", 0),
      "per_class": per_class,
      "priority_ordering_ok": bool(ordering_ok),
  }


def _rollout_cycles(router, controller, predictor, classes, images,
                    cycle_bound_s: float, seed: int) -> Dict:
  """Runs the two acceptance rollout cycles under live load: a healthy
  candidate through shadow→canary→promote, then an
  injected-regression candidate through shadow→auto_rollback. Each
  cycle's load stops when the controller is back to serving."""
  router.use_stats(ServingStats())  # rollout traffic off the sweep books

  def drive_until_serving(bound_s: float):
    stop_at = time.monotonic() + bound_s
    stop = threading.Event()
    point_thread = threading.Thread(
        target=_run_open_loop_point,
        args=(controller.submit, classes, images, 1.0, bound_s, seed,
              stop),
        daemon=True)
    point_thread.start()
    while controller.state != "serving" and time.monotonic() < stop_at:
      time.sleep(0.01)
    stop.set()
    point_thread.join()

  healthy = predictor.make_candidate_variables()
  controller.offer_candidate(predictor.model_version + 1, healthy)
  drive_until_serving(cycle_bound_s)
  regressed = predictor.make_candidate_variables(jitter=5.0, seed=seed + 7)
  controller.offer_candidate(predictor.model_version + 1, regressed)
  drive_until_serving(cycle_bound_s)
  timeline = controller.timeline()
  events = [entry["event"] for entry in timeline]
  return {
      "timeline": timeline,
      "promotions": events.count("promote"),
      "auto_rollbacks": events.count("auto_rollback"),
      "cycle_ok": ("promote" in events and "auto_rollback" in events),
      "served_model_version": predictor.model_version,
  }


def measure_fleet(
    n_devices: int = 2,
    ladder_sizes: Sequence[int] = (1, 2, 4, 8, 16),
    classes: Sequence[Tuple[SLOClass, int, float]] = R11_CLASSES,
    load_multipliers: Sequence[float] = (0.5, 1.0),
    duration_s: float = 4.0,
    overload_burst: Optional[int] = None,
    max_queue: int = 64,
    dispatch_margin_ms: float = 40.0,
    rollout: bool = True,
    rollout_cycle_s: float = 6.0,
    rollout_mirror: float = 0.5,
    rollout_canary: float = 0.25,
    rollout_min_shadow: int = 24,
    rollout_min_canary: int = 12,
    cem_num_samples: int = 32,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """Runs the fleet protocol with `n_devices` replicas on `device`;
  returns the FLEET_r11 artifact's dict."""
  from tensor2robot_tpu_torch.serving.rollout import (
      RolloutConfig,
      RolloutController,
  )
  from tensor2robot_tpu_torch.serving.router import FleetRouter
  from tensor2robot_tpu_torch.serving.smoke import TinyQPredictor

  device = resolve_device(device)
  device_kind = (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
  devices = [device] * n_devices

  predictor = TinyQPredictor(seed=seed, device=device)
  router = FleetRouter(
      predictor, devices=devices, num_samples=cem_num_samples,
      num_elites=cem_num_elites, iterations=cem_iterations,
      ladder_sizes=ladder_sizes, max_queue=max_queue,
      dispatch_margin_ms=dispatch_margin_ms, seed=seed)

  # Per-class, per-client frame pools: distinct images, so each request
  # is real work, deterministic per seed.
  images = {}
  for class_index, (slo_class, clients, _) in enumerate(classes):
    images[slo_class.name] = [
        predictor.make_image(seed + 10_000 * (class_index + 1) + c)
        for c in range(clients)]

  compile_start = time.perf_counter()
  router.warmup(predictor.make_image)
  warmup_s = time.perf_counter() - compile_start

  clients_total = sum(clients for _, clients, _ in classes)
  sweep = []
  rollout_block = None
  with router:
    controller = RolloutController(
        router, predictor,
        RolloutConfig(mirror_fraction=rollout_mirror,
                      canary_fraction=rollout_canary,
                      min_shadow_samples=rollout_min_shadow,
                      min_canary_samples=rollout_min_canary,
                      seed=seed))
    with controller:
      for multiplier in load_multipliers:
        stats = ServingStats()
        router.use_stats(stats)
        point = _run_open_loop_point(
            lambda image, slo: router.submit(image, slo=slo),
            classes, images, multiplier, duration_s, seed)
        sweep.append(_point_report(point, classes, stats.snapshot(),
                                   multiplier))
      burst_block = _overload_burst(router, classes, images,
                                    overload_burst)
      if rollout:
        rollout_block = _rollout_cycles(
            router, controller, predictor, classes, images,
            rollout_cycle_s, seed)

  ledger = router.compile_ledger()
  ledger_ok = (
      len(ledger) == len(devices) and
      all(sorted(per_replica) == sorted(int(s) for s in ladder_sizes)
          and all(count == 1 for count in per_replica.values())
          for per_replica in ledger.values()))

  acceptance = sweep[-1] if sweep else None
  headroom = None
  if acceptance is not None:
    margins = [
        (entry["budget_ms"] - entry["latency_p99_ms"])
        / entry["budget_ms"]
        for entry in acceptance["per_class"].values()
        if entry["latency_p99_ms"] is not None]
    headroom = round(min(margins), 4) if margins else None
  sustained = 0
  for point in sweep:
    if point["all_budgets_met"]:
      sustained = max(sustained,
                      round(clients_total * point["load_multiplier"]))

  return {
      "round": 11,
      "metric": "fleet serving: SLO classes + least-loaded router + "
                "live rollout",
      "device_kind": device_kind,
      "virtual_mesh": device.type == "cpu",
      "devices": len(devices),
      "bucket_ladder": [int(s) for s in ladder_sizes],
      "warmup_compile_s": round(warmup_s, 2),
      "cem": {"num_samples": cem_num_samples,
              "num_elites": cem_num_elites,
              "iterations": cem_iterations},
      "r01_clients": R01_CLIENTS,
      "clients_total": clients_total,
      "clients_vs_r01": round(clients_total / R01_CLIENTS, 2),
      "max_queue_per_replica": max_queue,
      "classes": [{
          "name": slo_class.name,
          "priority": slo_class.priority,
          "budget_ms": slo_class.deadline_ms,
          "clients": clients,
          "hz_per_client": hz,
      } for slo_class, clients, hz in classes],
      "sweep": sweep,
      "overload_burst": burst_block,
      "rollout": rollout_block,
      "promotion_timeline": (rollout_block or {}).get("timeline", []),
      "compile_ledger": ledger,
      "ledger_ok": bool(ledger_ok),
      "fleet_clients_sustained": sustained,
      "fleet_p99_headroom": headroom,
      "note": (
          "Open-loop Poisson offered load across three SLO classes "
          "through the least-loaded router over `devices` replicas on "
          "one device (several replicas on one card, each on its own "
          "CUDA stream). virtual_mesh=true marks a CPU run: the replicas "
          "share the host's cores, and only the structure (ledger, shed "
          "ordering, the rollout cycle) is a claim there. "
          "fleet_p99_headroom = min over classes of (budget - p99)/budget "
          "at the top sweep point; fleet_clients_sustained = clients x "
          "largest multiplier with every class inside its budget. "
          "warmup_compile_s is the ladder's CUDA-graph captures."),
  }


CI_SCALE = dict(
    ladder_sizes=(1, 2, 4),
    classes=tuple((slo_class, max(2, clients // 8), hz)
                  for slo_class, clients, hz in R11_CLASSES),
    load_multipliers=(1.0,),
    duration_s=1.5,
    max_queue=12,
    rollout_cycle_s=5.0,
    rollout_mirror=1.0,
    rollout_canary=0.5,
    rollout_min_shadow=6,
    rollout_min_canary=3)


def main(argv=None) -> None:
  """CLI: one JSON line. ``--ci`` is the reduced lane (the JAX CI
  scale: 2 replicas, ladder 1-4, short windows); without it the full
  protocol (128 clients) runs."""
  import argparse
  import json

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--ci", action="store_true",
                      help="reduced lane: 2 replicas, ladder (1, 2, 4), "
                           "short windows, the same structure")
  parser.add_argument("--devices", type=int, default=None,
                      help="replicas on the one device (default 2)")
  parser.add_argument("--device", default=None,
                      help="the device the replicas share (default the "
                           "card; 'cpu' to run on the CPU)")
  parser.add_argument("--duration", type=float, default=None,
                      help="seconds per offered-load point")
  parser.add_argument("--no-rollout", action="store_true",
                      help="skip the promotion/rollback cycles")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--out", default=None,
                      help="also write the JSON line to this file")
  args = parser.parse_args(argv)
  kwargs = dict(seed=args.seed, rollout=not args.no_rollout,
                device=args.device)
  if args.ci:
    kwargs.update(CI_SCALE)
  if args.devices is not None:
    kwargs["n_devices"] = args.devices
  if args.duration is not None:
    kwargs["duration_s"] = args.duration
  line = json.dumps(measure_fleet(**kwargs))
  if args.out:
    with open(args.out, "w") as f:
      f.write(line + "\n")
  print(line)


if __name__ == "__main__":
  main()
