"""The training-health sentinel of the host replay loop.

Counterpart of the parts of ``tensor2robot_tpu/obs/health.py`` that the
host loop runs:

- ``SUMMARY_KEYS``: the fixed health-summary schema every learn path
  emits; ``SCAN_MAX_KEYS`` and ``reduce_scanned_metrics``: the megastep's
  reduction of K inner steps' metrics (the max for the spike keys, the
  last step's value for the rest); ``merge_scan_metrics`` and
  ``zero_summary``: the Anakin loop's running form of the same reduction
  and its carry's initial value;
- ``tree_nonfinite_count`` / ``tree_global_norm``: the summary's
  reductions over a tree of tensors (non-finite elements of the float
  leaves; the global L2 norm, summed in float32), as a float32 scalar on
  the leaves' device;
- ``HealthRule`` and ``default_rules``: a hard nonfinite == 0 rule, EWMA
  z-score drift rules on grad norm, TD and Q, a priority-entropy floor
  and a sample-age ceiling;
- ``HealthMonitor``: evaluates the rules on each step's summary, keeps
  the breach record, escalates each breach (the ``health/breaches`` and
  ``health/breaches/<rule>`` counters of the metric registry, then a
  rate-limited ``health_breach`` flight-recorder dump carrying the step
  and any bound correlation ids, then ``on_breach``), runs an optional
  snapshot and, with ``halt_on_breach``, raises ``HealthHalt`` rather
  than training on garbage. Its drift baselines round-trip through
  ``state_dict``.

- ``q_drift_report``: the routed fleet's Q-drift guard, each replica's
  served-Q mean against the rest of the fleet's (leave-one-out).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from tensor2robot_tpu_torch.obs import context as context_lib
from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import registry as registry_lib
from tensor2robot_tpu_torch.utils.tree import tree_leaves

# The fixed health-summary schema every learn path emits (the megastep
# computes these on the device; the host loop assembles the same keys
# from its per-step host data), so a rule holds on every loop path.
SUMMARY_KEYS = (
    "health/nonfinite_grads",
    "health/nonfinite_params",
    "health/nonfinite_targets",
    "health/grad_norm",
    "health/param_norm",
    "health/td_mean",
    "health/td_max",
    "health/q_mean",
    "health/q_max",
    "health/priority_entropy",
    "health/sample_age",
)

# Keys reduced by their max over a megastep's inner steps (a transient
# NaN or spike inside the dispatch must survive to its readout); the rest
# report the last inner step.
SCAN_MAX_KEYS = frozenset({
    "health/nonfinite_grads",
    "health/nonfinite_params",
    "health/nonfinite_targets",
    "health/grad_norm",
    "health/td_max",
    "health/q_max",
})


# The fields of a health_breach flight-recorder trigger (the watchdog's
# STALL_FIELDS convention).
BREACH_FIELDS = ("rule", "metric", "value", "step")


class HealthHalt(RuntimeError):
  """Raised by a halting HealthMonitor breach: the loop stops instead of
  training on garbage. Carries the breaches that tripped it."""

  def __init__(self, step: int, breaches: List[dict]):
    self.step = step
    self.breaches = breaches
    names = ", ".join(sorted({b["rule"] for b in breaches}))
    super().__init__(
        f"health halt at step {step}: breached [{names}] — halting "
        "rather than training on garbage")


def _leaf_sums(tree, fn) -> torch.Tensor:
  """The float32 sum over a tree's float tensors of fn(leaf).sum()."""
  sums = [fn(leaf).sum(dtype=torch.float32) for leaf in tree_leaves(tree)
          if torch.is_tensor(leaf) and leaf.is_floating_point()]
  if not sums:
    return torch.zeros((), dtype=torch.float32)
  return torch.stack(sums).sum()


def tree_nonfinite_count(tree) -> torch.Tensor:
  """Non-finite elements across a tree's float tensors, one float32
  scalar (the hard rules' input)."""
  return _leaf_sums(tree, lambda leaf: ~torch.isfinite(leaf))


def tree_global_norm(tree) -> torch.Tensor:
  """Global L2 norm over a tree's float tensors, summed in float32."""
  return torch.sqrt(_leaf_sums(tree, lambda leaf: torch.square(leaf.float())))


def merge_scan_metrics(new: Mapping[str, torch.Tensor],
                       old: Mapping[str, torch.Tensor],
                       gate: torch.Tensor) -> Dict[str, torch.Tensor]:
  """The fused loops' per-key carry merge: where the 0-d bool `gate` is
  true the SCAN_MAX_KEYS keep their running max (a spike inside a
  dispatch survives to its readout) and every other key takes the new
  value; where false every key keeps its old value. No host sync, so a
  CUDA graph can hold it."""
  out = {}
  for key, new_value in new.items():
    old_value = old[key]
    if key in SCAN_MAX_KEYS:
      new_value = torch.maximum(new_value, old_value)
    out[key] = torch.where(gate, new_value, old_value)
  return out


def reduce_scanned_metrics(stacked: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
  """Metrics stacked along a leading axis of inner steps, reduced per key:
  the max for SCAN_MAX_KEYS, the last step's value otherwise."""
  return {key: (value.max(dim=0).values if key in SCAN_MAX_KEYS
                else value[-1])
          for key, value in stacked.items()}


def zero_summary(device=None) -> Dict[str, torch.Tensor]:
  """The all-zeros summary: the fused loops' carry before a dispatch's
  first trained step, and the placeholder of one that never trained."""
  return {key: torch.zeros((), dtype=torch.float32, device=device)
          for key in SUMMARY_KEYS}


@dataclasses.dataclass(frozen=True)
class HealthRule:
  """One declarative check over one summary metric.

  Attributes:
    name: the rule's id (the breach record's ``rule``).
    metric: the summary key it watches.
    kind: "max" (value > limit breaches; nonfinite == 0 is ``max`` with
      limit 0), "min" (value < limit breaches), or "drift" (EWMA z-score:
      |value - ewma_mean| / ewma_std > z_threshold after ``warmup``
      observations).
    limit: the bound of a max or min rule.
    z_threshold / ewma_alpha / min_std / min_rel_std: the drift rule's
      statistics. The z denominator is floored at ``max(min_std,
      min_rel_std * |ewma_mean|)``, so a series that settles to near
      constant values does not turn ordinary noise into a breach. The
      EWMA freezes on a breaching value, so persistent corruption keeps
      breaching instead of becoming the baseline.
    warmup: observations before the rule arms (hard max rules with
      warmup 0 are always armed).
    halt: a breach escalates to HealthHalt under halt_on_breach.
  """

  name: str
  metric: str
  kind: str = "max"
  limit: float = 0.0
  z_threshold: float = 6.0
  ewma_alpha: float = 0.1
  min_std: float = 1e-3
  min_rel_std: float = 0.25
  warmup: int = 10
  halt: bool = False

  def __post_init__(self):
    if self.kind not in ("max", "min", "drift"):
      raise ValueError(f"unknown rule kind {self.kind!r}; "
                       "known: max, min, drift")


def default_rules(capacity: Optional[int] = None) -> tuple:
  """The sentinel's default rules: nonfinite == 0 on grads, params and
  targets (halting); drift on grad norm, TD and Q; a priority-entropy
  floor; and, when the ring's capacity is known, a sample-age ceiling."""
  rules = [
      HealthRule("nonfinite_grads", "health/nonfinite_grads",
                 kind="max", limit=0.0, warmup=0, halt=True),
      HealthRule("nonfinite_params", "health/nonfinite_params",
                 kind="max", limit=0.0, warmup=0, halt=True),
      HealthRule("nonfinite_targets", "health/nonfinite_targets",
                 kind="max", limit=0.0, warmup=0, halt=True),
      HealthRule("grad_norm_drift", "health/grad_norm", kind="drift",
                 z_threshold=8.0, warmup=10),
      HealthRule("td_drift", "health/td_mean", kind="drift",
                 z_threshold=8.0, warmup=10),
      HealthRule("q_drift", "health/q_max", kind="drift",
                 z_threshold=8.0, warmup=10),
      HealthRule("priority_entropy_floor", "health/priority_entropy",
                 kind="min", limit=0.05, warmup=10),
  ]
  if capacity is not None:
    rules.append(HealthRule("sample_age_ceiling", "health/sample_age",
                            kind="max", limit=float(8 * capacity),
                            warmup=5))
  return tuple(rules)


class _DriftState:
  """EWMA mean and variance of one drift rule."""

  __slots__ = ("n", "mean", "var")

  def __init__(self):
    self.n = 0
    self.mean = 0.0
    self.var = 0.0

  def update(self, value: float, alpha: float) -> None:
    if self.n == 0:
      self.mean = value
    else:
      delta = value - self.mean
      self.mean += alpha * delta
      self.var = (1.0 - alpha) * (self.var + alpha * delta * delta)
    self.n += 1

  def std(self, min_std: float, min_rel_std: float = 0.0) -> float:
    return max(math.sqrt(max(self.var, 0.0)), min_std,
               min_rel_std * abs(self.mean))


class HealthMonitor:
  """Evaluates HealthRules over per-step summaries; escalates breaches.

  Each breach is recorded (``breaches``, ``breach_count``), then
  escalated: the registry's counters (default: the process registry), a
  rate-limited ``health_breach`` dump (default: the process recorder),
  ``on_breach``; each hop is isolated, so a failing one never stops the
  loop. A step with breaches runs ``snapshot_fn`` once; with
  ``halt_on_breach``, a breach of a ``halt`` rule then raises
  ``HealthHalt``. ``observe`` runs on one loop thread; the lock guards
  ``snapshot`` readers.
  """

  def __init__(self, rules: Optional[Sequence[HealthRule]] = None,
               registry: Optional[registry_lib.MetricRegistry] = None,
               recorder: Optional[flight_lib.FlightRecorder] = None,
               on_breach: Optional[Callable[[dict], None]] = None,
               halt_on_breach: bool = False,
               max_breach_history: int = 256):
    self._registry = registry
    self._recorder = recorder
    self.rules = tuple(default_rules() if rules is None else rules)
    names = [rule.name for rule in self.rules]
    if len(set(names)) != len(names):
      raise ValueError(f"duplicate rule names: {sorted(names)}")
    self._on_breach = on_breach
    self.halt_on_breach = halt_on_breach
    self._lock = threading.Lock()
    self._drift: Dict[str, _DriftState] = {
        rule.name: _DriftState() for rule in self.rules
        if rule.kind == "drift"}
    self._seen: Dict[str, int] = {rule.name: 0 for rule in self.rules}
    self.observations = 0
    self.breaches: List[dict] = []
    self._max_breaches = max_breach_history
    self.breach_count = 0
    self.last_summary: Dict[str, float] = {}

  def _check_rule(self, rule: HealthRule, value: float,
                  step: int) -> Optional[dict]:
    """One rule against one value; updates the rule's state. Returns the
    breach record or None."""
    seen = self._seen[rule.name]
    self._seen[rule.name] = seen + 1
    breach: Optional[dict] = None
    if rule.kind == "max":
      if seen >= rule.warmup and value > rule.limit:
        breach = {"threshold": rule.limit}
    elif rule.kind == "min":
      if seen >= rule.warmup and value < rule.limit:
        breach = {"threshold": rule.limit}
    else:
      state = self._drift[rule.name]
      if state.n >= rule.warmup:
        std = state.std(rule.min_std, rule.min_rel_std)
        z = abs(value - state.mean) / std
        if z > rule.z_threshold:
          breach = {"z": round(z, 3), "ewma_mean": round(state.mean, 6),
                    "ewma_std": round(std, 6),
                    "threshold": rule.z_threshold}
      if breach is None:
        state.update(value, rule.ewma_alpha)
    if breach is None:
      return None
    breach.update({
        "rule": rule.name, "metric": rule.metric,
        "value": float(value), "step": int(step), "kind": rule.kind,
        "halt": rule.halt,
    })
    return breach

  def observe(self, step: int, summary: Mapping[str, float]
              ) -> List[dict]:
    """One step's summary through every rule. Returns the breaches;
    raises HealthHalt when a halting rule breached under
    halt_on_breach."""
    return self.observe_with_snapshot(step, summary, snapshot_fn=None)

  def observe_with_snapshot(
      self, step: int, summary: Mapping[str, float],
      snapshot_fn: Optional[Callable[[], None]] = None) -> List[dict]:
    """observe(), and ``snapshot_fn`` once when any rule breached,
    before a halt."""
    breaches: List[dict] = []
    with self._lock:
      self.observations += 1
      self.last_summary = {key: float(value)
                           for key, value in summary.items()}
      for rule in self.rules:
        value = summary.get(rule.metric)
        if value is None:
          continue
        value = float(value)
        if math.isnan(value) and rule.kind == "drift":
          # NaN is the hard rules' to catch; it would poison the EWMA.
          continue
        breach = self._check_rule(rule, value, step)
        if breach is not None:
          breaches.append(breach)
      self.breach_count += len(breaches)
      self.breaches.extend(breaches)
      if len(self.breaches) > self._max_breaches:
        del self.breaches[:len(self.breaches) - self._max_breaches]
    for breach in breaches:
      self._escalate(breach)
    if breaches and snapshot_fn is not None:
      try:
        snapshot_fn()
      except Exception:  # noqa: BLE001 — the breach record stands
        pass
    if self.halt_on_breach:
      halting = [b for b in breaches if b.get("halt")]
      if halting:
        raise HealthHalt(step, halting)
    return breaches

  def _escalate(self, breach: dict) -> None:
    """counters -> rate-limited dump (the step and any bound correlation
    ids) -> callback; each hop isolated."""
    try:
      registry = self._registry or registry_lib.get_registry()
      registry.counter("health/breaches").inc()
      # Under health/breaches/, not the JAX monitor's health/<rule>: the
      # nonfinite rules share their names with the summary's keys, which
      # the loops set as gauges of that name (one name, one type).
      registry.counter(f"health/breaches/{breach['rule']}").inc()
    except Exception:  # noqa: BLE001 — a diagnostic never stops the loop
      pass
    try:
      recorder = self._recorder or flight_lib.get_recorder()
      fields = {key: breach[key] for key in BREACH_FIELDS}
      fields.update({key: breach[key] for key in ("z", "threshold")
                     if key in breach})
      attrs = context_lib.context_attrs()
      fields.update({key: attrs[key]
                     for key in ("request_id", "request_ids", "step_id")
                     if key in attrs})
      recorder.trigger("health_breach", **fields)
    except Exception:  # noqa: BLE001
      pass
    if self._on_breach is not None:
      try:
        self._on_breach(breach)
      except Exception:  # noqa: BLE001
        pass

  def state_dict(self) -> dict:
    """The drift baselines and per-rule seen counts (JSON-able), whose
    loss would leave a resumed loop drift-blind for ``warmup`` steps."""
    with self._lock:
      return {
          "drift": {name: [state.n, state.mean, state.var]
                    for name, state in self._drift.items()},
          "seen": dict(self._seen),
          "observations": self.observations,
      }

  def load_state_dict(self, state: Mapping) -> None:
    """Re-seats state_dict() baselines; rules the monitor does not know
    are ignored, and rules the state lacks keep their fresh state."""
    with self._lock:
      for name, entry in dict(state.get("drift", {})).items():
        drift = self._drift.get(name)
        if drift is None:
          continue
        drift.n, drift.mean, drift.var = (
            int(entry[0]), float(entry[1]), float(entry[2]))
      for name, count in dict(state.get("seen", {})).items():
        if name in self._seen:
          self._seen[name] = int(count)
      self.observations = int(state.get("observations",
                                        self.observations))

  def snapshot(self) -> dict:
    """The rule table, breach history, per-rule counts and the last
    summary observed."""
    with self._lock:
      per_rule: Dict[str, int] = {}
      for breach in self.breaches:
        per_rule[breach["rule"]] = per_rule.get(breach["rule"], 0) + 1
      return {
          "rules": [{
              "name": rule.name, "metric": rule.metric,
              "kind": rule.kind, "halt": rule.halt,
          } for rule in self.rules],
          "observations": self.observations,
          "breach_count": self.breach_count,
          "breaches_per_rule": per_rule,
          "breaches": [dict(breach) for breach in self.breaches],
          "last_summary": dict(self.last_summary),
      }


# -- fleet Q-drift guard ----------------------------------------------------


def q_drift_report(replica_summaries: Mapping[str, Mapping],
                   z_threshold: float = 8.0,
                   min_samples: int = 16,
                   min_scale: float = 1e-4) -> dict:
  """Cross-replica served-Q divergence vs the fleet (leave-one-out).

  ``replica_summaries`` maps a replica label to its served-Q sketch
  summary ({"count", "mean", "p50", "p90", ...} — ServingStats'
  ``q_sketch_summaries`` shape, or the aggregator's per-process form).
  Every replica serves the same request distribution through the same
  params, so their served-Q MEANS must agree up to sampling noise; one
  that doesn't is serving a different function (a corrupted replica,
  a botched ``set_variables`` that still returns finite numbers).

  The check is scale-free — Q heads range from ~1e-3 logits (the CI
  critics) to order-1 values, so no absolute threshold can be a
  default. For each qualifying replica (>= ``min_samples`` served
  values): the FLEET CENTER is the median of the OTHER replicas'
  means (leave-one-out, so the candidate cannot pull its own
  yardstick), and the SCALE is the larger of (a) the other replicas'
  median absolute deviation around that center and (b) half their
  median within-replica p90-p50 spread — MAD is zero at fleet size 2,
  where the within-replica dispersion is the honest noise floor —
  floored at ``min_scale``. A replica whose |mean - center| exceeds
  ``z_threshold`` x scale is DIVERGENT. (At fleet size 2 the guard
  cannot name the culprit — both sides of a wide gap flag — but the
  alarm still fires; >= 3 replicas isolate the corrupted one.)

  Verdicts: "ok", "divergent" (names in ``divergent``), or
  "insufficient" (< 2 qualifying replicas: no fleet to diverge from).
  """
  qualifying = {
      name: summary for name, summary in replica_summaries.items()
      if summary.get("count", 0) >= min_samples
      and summary.get("mean") is not None}
  report = {
      "z_threshold": z_threshold,
      "min_samples": min_samples,
      "min_scale": min_scale,
      "replicas": {},
      "divergent": [],
      "fleet_median": None,
  }
  for name, summary in sorted(replica_summaries.items()):
    report["replicas"][name] = {
        "count": int(summary.get("count", 0)),
        "mean": summary.get("mean"),
        "median": summary.get("p50"),
        "qualifying": name in qualifying,
    }
  if len(qualifying) < 2:
    report["verdict"] = "insufficient"
    return report
  means = {name: float(summary["mean"])
           for name, summary in qualifying.items()}
  spreads = {
      name: max(float(summary.get("p90") or 0.0)
                - float(summary.get("p50") or 0.0), 0.0)
      for name, summary in qualifying.items()}
  report["fleet_median"] = round(statistics.median(means.values()), 6)
  for name in qualifying:
    others = [means[other] for other in qualifying if other != name]
    center = statistics.median(others)
    mad = statistics.median(
        abs(value - center) for value in others)
    spread_floor = 0.5 * statistics.median(
        spreads[other] for other in qualifying if other != name)
    scale = max(mad, spread_floor, min_scale)
    z = abs(means[name] - center) / scale
    entry = report["replicas"][name]
    entry["delta"] = round(abs(means[name] - center), 6)
    entry["z"] = round(z, 3)
    if z > z_threshold:
      entry["divergent"] = True
      report["divergent"].append(name)
  report["divergent"].sort()
  report["verdict"] = "divergent" if report["divergent"] else "ok"
  return report
