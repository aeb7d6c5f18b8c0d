"""The port's routed serving fleet held against the JAX package.

TinyQ 8x8, CEM 32/4/2, ladder (1, 2, 4). The oracles of
``tests/test_fleet.py`` carry over: one build a bucket a replica (three
replicas on the CPU, ``check_compile_ledger`` over the nested ledger);
routed actions equal a single ``CEMFleetPolicy``'s bit for bit for pinned
seeds; least-loaded routing spreads concurrent traffic; a warmed but
unstarted router raises ``RouterNotStarted``; an ingress deadline
survives the hop; a healthy candidate is promoted and a regressed one
rolled back in shadow, the ledger unchanged; the shadow phase adds no
build and clients see the live variables.

Parity with the JAX package on the same inputs: ``q_drift_report``,
``check_compile_ledger`` (results and messages) and
``ExecutableLedger.attribution`` (flops ``None``; every field but the
free-text ``note``) exactly; ``_choose_replica``'s choices under the same
pending depths and breaker states; the quarantine -> probe -> reinstate
timeline under an injected clock with a replica whose flush raises
(replicas named by index: the JAX package names them by device, the port
by device and index); ``ExportWatcher``'s versions and rejection reasons
over one directory tree; ``FrontDoor``'s host choices, reconciliation and
``apply_drift_rollup``; the rollout's event sequence; and routed actions
in value space: CEM draws cannot match across the packages (numpy against
threefry), so the routed actions' mean TinyQ value must sit within the
rollout gate's 0.05 q-delta bar (``tpquant_bench.R17_Q_TOL``) of the JAX
router's on the same requests. ``variables=`` equals a fresh policy
serving the candidate bit for bit at every tier, and the next live call
equals the live answer bit for bit. ``bench_fleet --ci`` keeps the keys of
the JAX artifact ``FLEET_r11.json``. The rollout cycles end on sample
counts (the controller's own bars), bounded in time only against a hang.

On the card (``cuda`` marker): routed equals single, the override bit for
bit, a replica's shared graph pool against separate pools, and a
precision offer under live load that captures cleanly.
"""

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  from tensor2robot_tpu.export import variables_io as jax_variables_io
  from tensor2robot_tpu.obs import health as jax_health
  from tensor2robot_tpu.obs import ledger as jax_ledger
  from tensor2robot_tpu.obs import registry as jax_registry
  from tensor2robot_tpu.serving import frontdoor as jax_frontdoor
  from tensor2robot_tpu.serving import rollout as jax_rollout
  from tensor2robot_tpu.serving import router as jax_router
  from tensor2robot_tpu.serving import slo as jax_slo
  from tensor2robot_tpu.serving import smoke as jax_smoke
  from tensor2robot_tpu.serving import stats as jax_stats
except ImportError:
  jax = None

from tensor2robot_tpu_torch.obs import health  # noqa: E402
from tensor2robot_tpu_torch.obs import ledger  # noqa: E402
from tensor2robot_tpu_torch.obs import registry  # noqa: E402
from tensor2robot_tpu_torch.replay import loop  # noqa: E402
from tensor2robot_tpu_torch.replay import precision_bench  # noqa: E402
from tensor2robot_tpu_torch.replay import smoke as replay_smoke  # noqa: E402
from tensor2robot_tpu_torch.replay import tpquant_bench  # noqa: E402
from tensor2robot_tpu_torch.serving import frontdoor, rollout  # noqa: E402
from tensor2robot_tpu_torch.serving import router, slo, smoke  # noqa: E402
from tensor2robot_tpu_torch.serving import stats  # noqa: E402
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CEM = dict(num_samples=32, num_elites=4, iterations=2)
LADDER = (1, 2, 4)
HEALTHY_THEN_REGRESSED = ["shadow_start", "canary_start", "promote",
                          "shadow_start", "auto_rollback"]
CONFIG = dict(mirror_fraction=1.0, canary_fraction=0.5,
              min_shadow_samples=6, min_canary_samples=3)


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


def _predictor(device="cpu"):
  return smoke.TinyQPredictor(image_size=8, action_size=4, seed=0,
                              device=device)


def _router(predictor, n=2, device="cpu", **kwargs):
  return router.FleetRouter(predictor, devices=[device] * n, seed=0,
                            ladder_sizes=LADDER, **CEM, **kwargs)


def _single(predictor, **kwargs):
  return CEMFleetPolicy(predictor, action_size=4, seed=0, **CEM, **kwargs)


def _drive(controller, predictor, bound_s=60.0):
  """Submits frames until the controller is back to serving; the bound
  only guards against a hang."""
  deadline = time.monotonic() + bound_s
  i = 0
  while controller.state != "serving" and time.monotonic() < deadline:
    controller.act(predictor.make_image(300 + i), timeout=30)
    i += 1
  assert controller.state == "serving", "rollout cycle did not finish"


def _rollout_cycles(make_controller, predictor):
  """A healthy candidate, then a regressed one: the timeline."""
  controller = make_controller()
  with controller:
    assert controller.offer_candidate(
        1, predictor.make_candidate_variables(jitter=0.0))
    _drive(controller, predictor)
    assert controller.offer_candidate(
        2, predictor.make_candidate_variables(jitter=5.0, seed=9))
    _drive(controller, predictor)
  return controller.timeline()


@pytest.fixture(scope="module")
def jax_fleet():
  """One warmed JAX router over two virtual CPU devices, shared by the
  JAX-side tests (a healthy candidate carries the same weights, so its
  promotion leaves every later action unchanged)."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  predictor = jax_smoke.TinyQPredictor(image_size=8, action_size=4, seed=0)
  fleet = jax_router.FleetRouter(predictor, devices=jax.devices()[:2],
                                 seed=0, ladder_sizes=LADDER, **CEM)
  fleet.warmup(predictor.make_image)
  return predictor, fleet


# --- the router ---------------------------------------------------------------


class TestFleetRouter:

  def test_one_capture_per_bucket_per_replica(self):
    predictor = _predictor()
    fleet = _router(predictor, n=3)
    fleet.warmup(predictor.make_image)
    with fleet:
      futures = [fleet.submit(predictor.make_image(i)) for i in range(24)]
      for future in futures:
        assert np.asarray(future.result(timeout=30)).shape == (4,)
    counts = fleet.compile_ledger()
    assert list(counts) == ["cpu#0", "cpu#1", "cpu#2"]
    assert all(sorted(c) == list(LADDER) for c in counts.values())
    assert len(ledger.check_compile_ledger(counts)) == 9
    ledger.check_compile_ledger(
        fleet.ledger.compile_counts,
        require=[f"cem_bucket_{b}@cpu#{i}" for b in LADDER
                 for i in range(3)])
    rows = fleet.ledger.attribution()["executables"]
    assert sum(row["dispatches"] for row in rows) >= 24 // 4
    # Each bucket's build counted its control step's FLOPs.
    assert all(row["flops_per_dispatch"] > 0 for row in rows)

  def test_routed_actions_equal_the_single_policy(self):
    predictor = _predictor()
    fleet = _router(predictor)
    fleet.warmup(predictor.make_image)
    images = [predictor.make_image(50 + i) for i in range(6)]
    with fleet:
      futures = [fleet.submit(image, seed=1000 + i)
                 for i, image in enumerate(images)]
      routed = np.stack([f.result(timeout=30) for f in futures])
    single = _single(predictor)(images, np.arange(1000, 1006,
                                                  dtype=np.uint32))
    np.testing.assert_array_equal(routed, single)

  def test_least_loaded_spreads_concurrent_traffic(self):
    predictor = _predictor()
    fleet = _router(predictor, max_batch=2)
    fleet.warmup(predictor.make_image)
    flushed = {0: 0, 1: 0}
    for index, replica in enumerate(fleet.replicas):
      original = replica._flush

      def counting(items, _index=index, _original=original):
        flushed[_index] += len(items)
        return _original(items)

      replica.batcher._batch_fn = counting
    errors = []

    def client(i):
      try:
        for _ in range(6):
          fleet.act(predictor.make_image(i), timeout=30)
      except Exception as e:  # noqa: BLE001 — asserted below
        errors.append(e)

    with fleet:
      threads = [threading.Thread(target=client, args=(i,))
                 for i in range(8)]
      for thread in threads:
        thread.start()
      for thread in threads:
        thread.join(60)
    assert not any(thread.is_alive() for thread in threads)
    assert not errors, errors
    assert min(flushed.values()) > 0, flushed
    assert sum(flushed.values()) == 48

  def test_warmed_but_unstarted_router_raises_typed(self):
    predictor = _predictor()
    fleet = _router(predictor)
    fleet.warmup(predictor.make_image)
    with pytest.raises(slo.RouterNotStarted, match=r"start\(\)"):
      fleet.submit(predictor.make_image(0))
    with fleet:
      action = fleet.act(predictor.make_image(0), timeout=30)
    assert np.asarray(action).shape == (4,)

  def test_ingress_deadline_survives_the_hop(self):
    predictor = _predictor()
    fleet = _router(predictor)
    fleet.warmup(predictor.make_image)
    with fleet:
      with pytest.raises(slo.RequestShed) as info:
        fleet.act(predictor.make_image(0),
                  slo=slo.SLOClass("spent", 1, -5.0), timeout=10)
      assert info.value.reason == "expired"
      action = fleet.act(predictor.make_image(1),
                         slo=slo.SLOClass("fresh", 1, 200.0), timeout=30)
      assert np.asarray(action).shape == (4,)
    snap = fleet.snapshot()
    assert snap["per_class"]["spent"]["shed_expired"] == 1
    assert snap["health"]["health"] == "ok"
    assert snap["replicas"] == 2 and snap["precision"] == "f32"

  @pytest.mark.parametrize("kwargs", [
      dict(fault_plan=object()), dict(tp_group=2),
      dict(param_specs={}), dict(episode_recorder=object())],
                           ids=["fault_plan", "tp_group", "param_specs",
                                "episode_recorder"])
  def test_refusals_name_their_items(self, kwargs):
    with pytest.raises(NotImplementedError, match="item 15"):
      _router(_predictor(), **kwargs)

  def test_export_watcher_refuses_a_fault_plan(self, tmp_path):
    with pytest.raises(NotImplementedError, match="item 15"):
      rollout.ExportWatcher(str(tmp_path), fault_plan=object())


# --- the candidate override ---------------------------------------------------


def _critic_predictor(seed, device):
  model = replay_smoke.TinyQCriticModel(image_size=16)
  state = model.init_variables(torch.Generator().manual_seed(seed),
                               device=device)
  return model, loop._HotReloadPredictor(model, state)


def _override_case(device, tier):
  """(override answer, fresh policy's answer, live before, live after)
  on the TinyQ critic: the candidate's variables through the live
  policy's graphs against a policy that serves them."""
  model, predictor = _critic_predictor(0, device)
  candidate = model.init_variables(torch.Generator().manual_seed(1),
                                   device=device)
  images = list(np.random.default_rng(2).integers(0, 256, (3, 16, 16, 3),
                                                  np.uint8))
  seeds = np.arange(40, 43, dtype=np.uint32)
  policy = _single(predictor, precision=tier, device=device)
  live_before = policy(images, seeds, return_scores=True)
  override = policy(images, seeds, variables=candidate, return_scores=True)
  live_after = policy(images, seeds, return_scores=True)
  fresh = _single(loop._HotReloadPredictor(model, candidate),
                  precision=tier, device=device)
  fresh_answer = fresh(images, seeds, return_scores=True)
  assert policy.compile_counts == fresh.compile_counts == {4: 1}
  return override, fresh_answer, (live_before, live_after)


class TestVariablesOverride:

  @pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
  def test_equals_a_fresh_policy_and_restores_live(self, tier):
    override, fresh, (before, after) = _override_case("cpu", tier)
    for got, want in zip(override, fresh):
      np.testing.assert_array_equal(got, want)
    for got, want in zip(after, before):
      np.testing.assert_array_equal(got, want)
    assert not np.array_equal(override[1], before[1])

  def test_numpy_candidate_and_mismatches(self):
    predictor = _predictor()
    policy = _single(predictor)
    images = [predictor.make_image(i) for i in range(2)]
    seeds = np.array([5, 6], np.uint32)
    candidate = predictor.make_candidate_variables(jitter=0.5, seed=3)
    fresh_predictor = _predictor()
    fresh_predictor.set_variables(candidate)
    np.testing.assert_array_equal(
        policy(images, seeds, variables=candidate),
        _single(fresh_predictor)(images, seeds))
    with pytest.raises(ValueError, match="graphs read"):
      policy(images, seeds, variables={"w": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="keys"):
      policy(images, seeds, variables={"v": candidate["w"]})
    np.testing.assert_array_equal(policy(images, seeds),
                                  _single(predictor)(images, seeds))


# --- the rollout --------------------------------------------------------------


class TestRollout:

  def test_promote_then_regression_rolled_back(self):
    predictor = _predictor()
    fleet = _router(predictor)
    fleet.warmup(predictor.make_image)
    before = fleet.compile_ledger()
    with fleet:
      timeline = _rollout_cycles(
          lambda: rollout.RolloutController(
              fleet, predictor, rollout.RolloutConfig(**CONFIG)),
          predictor)
    assert [e["event"] for e in timeline] == HEALTHY_THEN_REGRESSED
    assert timeline[2]["q_delta_mean"] == 0.0
    assert timeline[2]["action_agreement_l2_mean"] == 0.0
    rollback = timeline[-1]
    assert rollback["stage"] == "shadow" and not rollback["q_bar_passed"]
    assert rollback["q_delta_mean"] < -0.05
    assert predictor.model_version == 1
    assert fleet.compile_ledger() == before
    ledger.check_compile_ledger(fleet.ledger.compile_counts)

  def test_event_sequence_equals_jax(self, jax_fleet):
    predictor, fleet = jax_fleet
    with fleet:
      timeline = _rollout_cycles(
          lambda: jax_rollout.RolloutController(
              fleet, predictor, jax_rollout.RolloutConfig(**CONFIG)),
          predictor)
    assert [e["event"] for e in timeline] == HEALTHY_THEN_REGRESSED
    assert timeline[-1]["stage"] == "shadow"

  def test_shadow_adds_no_captures_and_clients_see_live(self):
    predictor = _predictor()
    fleet = _router(predictor)
    fleet.warmup(predictor.make_image)
    before = dict(fleet.ledger.compile_counts)
    images = [predictor.make_image(70 + i) for i in range(4)]
    with fleet:
      controller = rollout.RolloutController(
          fleet, predictor,
          rollout.RolloutConfig(mirror_fraction=1.0, canary_fraction=0.0,
                                min_shadow_samples=10_000))
      with controller:
        controller.offer_candidate(
            1, predictor.make_candidate_variables(jitter=3.0))
        assert controller.state == "shadow"
        for future in [controller.submit(image) for image in images]:
          future.result(timeout=30)
        routed = np.stack([
            fleet.submit(image, seed=7000 + i).result(timeout=30)
            for i, image in enumerate(images)])
    np.testing.assert_array_equal(
        routed, _single(predictor)(images, np.arange(7000, 7004,
                                                     dtype=np.uint32)))
    assert fleet.ledger.compile_counts == before

  @pytest.mark.parametrize("tier", ["bf16", "int8"])
  def test_tier_rollout_promotes_and_rolls_back(self, tier):
    measure = (precision_bench._measure_rollout if tier == "bf16"
               else tpquant_bench._measure_rollout_int8)
    result = measure(device="cpu", min_shadow=4, min_canary=2)
    assert result["events"] == ["shadow_start", "auto_rollback",
                                "shadow_start", "canary_start", "promote"]
    assert result["breach_rolled_back"] and result["cycle_ok"]
    assert result["precision_served"] == tier
    assert result["post_promote_action_ok"]
    flat = ledger.check_compile_ledger(result["compile_ledger"])
    assert len(flat) == 2 * 2 * len(LADDER)  # replicas x tiers x rungs
    assert result["tier_shares"] == {"f32": 6, tier: 6}


# --- parity with the JAX package ----------------------------------------------


def _summaries(seed):
  rng = np.random.default_rng(seed)
  out = {}
  for i in range(int(rng.integers(1, 5))):
    count = int(rng.integers(0, 40))
    mean = float(rng.normal(0.5, 0.2))
    p50 = mean + float(rng.normal(0, 0.01))
    out[f"r{i}"] = {"count": count, "mean": mean if count else None,
                    "p50": p50, "p90": p50 + abs(float(rng.normal(0, 0.05)))}
  if seed % 3 == 0 and out:
    first = next(iter(out.values()))
    first["mean"] = (first["mean"] or 0.0) + 5.0
  return out


class TestObsParity:

  @pytest.mark.parametrize("seed", range(6))
  def test_q_drift_report_equals_jax(self, needs_jax, seed):
    summaries = _summaries(seed)
    for kwargs in ({}, dict(z_threshold=2.0, min_samples=4)):
      assert (health.q_drift_report(summaries, **kwargs)
              == jax_health.q_drift_report(summaries, **kwargs))

  @pytest.mark.parametrize("counts, require, forbid", [
      ({"a": 1, "b": {"c": 1, "d": {"e": 1}}}, ("b/*", "a"), ("z",)),
      ({"a": 1, "b": {"c": 2}}, (), ()),
      ({}, (), ()),
      ({"a": 1}, ("x*",), ()),
      ({"a": 1}, ("b",), ()),
      ({"a": 1, "b": 1}, (), ("b",)),
  ], ids=["ok", "twice", "empty", "prefix", "missing", "forbidden"])
  def test_check_compile_ledger_equals_jax(self, needs_jax, counts,
                                           require, forbid):
    def outcome(check):
      try:
        return check(counts, require=require, forbid=forbid)
      except AssertionError as e:
        return str(e)

    assert (outcome(ledger.check_compile_ledger)
            == outcome(jax_ledger.check_compile_ledger))

  def test_attribution_equals_jax(self, needs_jax):
    reports = []
    for lib in (ledger, jax_ledger):
      book = lib.ExecutableLedger()
      book.register("cem_bucket_4@r0", device="r0", dtype="f32",
                    shapes={"bucket": 4})
      book.register("cem_bucket_4_bf16@r0", device="r0", dtype="bf16")
      book.register("cem_bucket_4@r0", device="r0", dtype="f32")
      book.register("host_step")
      book.record_dispatch("cem_bucket_4@r0", 0.25, count=3)
      book.record_dispatch("cem_bucket_4_bf16@r0", 0.125)
      book.record_dispatch("unregistered", 0.5)
      reports.append((book.compile_counts, book.names(),
                      book.attribution(), book.attribution(2.0, "cpu")))
    for ours, theirs in zip(*reports):
      if isinstance(ours, dict) and "note" in ours:
        ours, theirs = (dict(r) for r in (ours, theirs))
        assert ours.pop("note") and theirs.pop("note")
      assert ours == theirs
    assert ledger.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12


class _Clock:
  def __init__(self):
    self.now = 1000.0

  def __call__(self):
    return self.now


def _stub_flushes(fleet, broken):
  """Replica 0's flush raises while `broken` holds True; every other
  flush answers zeros without touching the policy."""
  for index, replica in enumerate(fleet.replicas):
    def flush(items, _index=index):
      if _index == 0 and broken[0]:
        raise RuntimeError("replica down")
      return [np.zeros(4, np.float32) for _ in items]
    replica.batcher._batch_fn = flush


def _indexed(fleet, events):
  labels = {getattr(r, "label", None) or str(r.device): i
            for i, r in enumerate(fleet.replicas)}
  out = []
  for event in events:
    event = {k: v for k, v in event.items() if k not in ("t_s",
                                                         "request_id")}
    if "replica" in event:
      event["replica"] = labels[event["replica"]]
    out.append(event)
  return out


def _health_run(fleet, clock, submit_image):
  """Sequential requests through a fleet whose replica 0 fails until it
  is fixed: quarantine, a failed probe, a successful probe."""
  broken = [True]
  _stub_flushes(fleet, broken)
  served = []
  with fleet:
    for step in range(8):
      if step == 4:
        clock.now += 5.0  # the quarantine elapses: a probe, still broken
      if step == 6:
        broken[0] = False
        clock.now += 5.0  # the probe that reinstates
      served.append(np.asarray(fleet.submit(submit_image).result(30)))
    snapshot = fleet.health_snapshot()
  return _indexed(fleet, snapshot["timeline"]), [
      s["state"] for s in snapshot["replicas"].values()]


class TestRoutingParity:

  def test_choose_replica_equals_jax(self, needs_jax, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    fleets = (_router(_predictor(), n=3), jax_router.FleetRouter(
        jax_smoke.TinyQPredictor(image_size=8, action_size=4, seed=0),
        devices=jax.devices()[:3], seed=0, ladder_sizes=LADDER, **CEM))
    for fleet, lib in zip(fleets, (slo, jax_slo)):
      fleet._breakers = [lib.CircuitBreaker(3, 3.0) for _ in range(3)]
    rng = np.random.default_rng(4)
    plan = []
    for step in range(24):
      depths = rng.integers(0, 3, 3).tolist()
      action = ("open", int(rng.integers(0, 3))) if step in (6, 15) else (
          ("advance", 4.0) if step in (10, 20) else None)
      excluded = frozenset({int(rng.integers(0, 3))}) if step % 7 == 3 \
          else frozenset()
      plan.append((depths, action, excluded))
    plan.append(([0, 0, 0], ("open_all", None), frozenset()))
    plan += [([2, 1, 0], None, frozenset()), ([1, 1, 1], None, frozenset())]
    results = []
    for fleet in fleets:
      clock.now = 1000.0
      depths_now = [0, 0, 0]
      for index, replica in enumerate(fleet.replicas):
        replica.batcher.pending = (lambda _i=index: depths_now[_i])
      chosen = []
      for depths, action, excluded in plan:
        depths_now[:] = depths
        if action and action[0] == "open":
          for _ in range(3):
            fleet._breakers[action[1]].record_failure(now=clock.now)
        elif action and action[0] == "open_all":
          for breaker in fleet._breakers:
            for _ in range(3):
              breaker.record_failure(now=clock.now)
        elif action:
          clock.now += action[1]
        chosen.append(fleet._choose_replica(excluded))
      results.append((chosen, [b.state for b in fleet._breakers],
                      _indexed(fleet, fleet._health_events)))
    assert results[0] == results[1]
    assert any(probe for _, probe in results[0][0])

  def test_quarantine_probe_reinstate_equals_jax(self, needs_jax,
                                                 monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    config = dict(failure_threshold=2, quarantine_s=5.0)
    ours = _router(_predictor(), health=slo.HealthConfig(**config))
    theirs = jax_router.FleetRouter(
        jax_smoke.TinyQPredictor(image_size=8, action_size=4, seed=0),
        devices=jax.devices()[:2], seed=0, ladder_sizes=LADDER,
        health=jax_slo.HealthConfig(**config), **CEM)
    image = np.zeros((8, 8, 3), np.float32)
    timeline, states = _health_run(ours, clock, image)
    clock.now = 1000.0
    assert (timeline, states) == _health_run(theirs, clock, image)
    assert [e["event"] for e in timeline] == [
        "retry", "quarantine", "retry", "probe", "requarantine", "retry",
        "probe", "reinstate"]
    assert states == ["closed", "closed"]

  def test_routed_actions_score_with_jax(self, jax_fleet):
    jax_predictor, theirs = jax_fleet
    predictor = _predictor()
    ours = _router(predictor)
    ours.warmup(predictor.make_image)
    images = [predictor.make_image(50 + i) for i in range(16)]
    answers = []
    for fleet in (ours, theirs):
      with fleet:
        futures = [fleet.submit(image, seed=1000 + i)
                   for i, image in enumerate(images)]
        answers.append(np.stack([f.result(timeout=30) for f in futures]))
    np.testing.assert_array_equal(
        [predictor.best_action(image) for image in images],
        [jax_predictor.best_action(image) for image in images])

    def value(actions):
      return np.array([-np.sum((a - predictor.best_action(image)) ** 2)
                       for a, image in zip(actions, images)])

    delta = float(np.mean(value(answers[0]) - value(answers[1])))
    assert abs(delta) <= tpquant_bench.R17_Q_TOL, delta


def _publish(root, version, value=None, marker=None, npz="whole"):
  export_dir = os.path.join(root, str(version))
  os.makedirs(export_dir)
  if marker:
    open(os.path.join(export_dir, marker), "w").close()
  if npz != "none":
    path = os.path.join(export_dir, "variables.npz")
    jax_variables_io.save_variables(
        path, {"params": {"w": np.full((3, 2), value, np.float32)}})
    if npz == "truncated":
      with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 2)
  return export_dir


class TestExportWatcherAndFrontDoorParity:

  def test_export_watcher_equals_jax(self, needs_jax, tmp_path):
    root = str(tmp_path / "exports")
    watchers = (rollout.ExportWatcher(root),
                jax_rollout.ExportWatcher(root))

    def poll_both():
      found = [w.poll() for w in watchers]
      return [None if f is None else
              (f[0], np.asarray(f[1]["params"]["w"]).tolist())
              for f in found]

    steps = [poll_both()]
    _publish(root, 1, 1.0)
    steps.append(poll_both())
    steps.append(poll_both())  # seen
    _publish(root, 3, 3.0, marker="variables.npz.tmp-123")
    steps.append(poll_both())
    _publish(root, 4, npz="none")
    steps.append(poll_both())
    _publish(root, 5, 5.0, npz="truncated")
    steps.append(poll_both())
    for watcher in watchers:
      watcher.notify(str(tmp_path / "nowhere"), 9)
    steps.append(poll_both())
    _publish(root, 6, 6.0)
    steps.append(poll_both())
    for ours, theirs in steps:
      assert ours == theirs
    assert [s[0] for s in steps] == [None, (1, [[1.0] * 2] * 3), None,
                                     None, None, None, None,
                                     (6, [[6.0] * 2] * 3)]
    assert watchers[0].rejections == watchers[1].rejections
    reasons = [r["reason"] for r in watchers[0].rejections]
    assert len(reasons) == 4
    assert "tmp markers" in reasons[0] and "has no" in reasons[1]
    assert reasons[2].startswith("load failed")
    assert "does not exist" in reasons[3]

  def test_frontdoor_equals_jax(self, needs_jax, tmp_path):
    class Replica:
      def __init__(self):
        self.depth = 0
        self.batcher = self

      def pending(self):
        return self.depth

    class Host:
      def __init__(self, stats_lib):
        self.replicas = [Replica(), Replica()]
        self.stats = stats_lib.ServingStats(
            registry=(registry if stats_lib is stats
                      else jax_registry).MetricRegistry())
        self.deadlines = []

      def start(self):
        pass

      def stop(self):
        pass

      def submit(self, image, slo=None, seed=None, deadline_at=None,
                 request_id=None):
        self.stats.record_logical_request()
        self.deadlines.append((deadline_at is not None, bool(request_id)))
        future = Future()
        future.set_result(np.zeros(4))
        return future

    rng = np.random.default_rng(7)
    plan = [rng.integers(0, 4, (3, 2)).tolist() for _ in range(30)]
    rollup = {"q_drift": {"divergent": ["hostB:11/cpu#1", "zz:1/r0"]}}
    outcomes = []
    for lib, stats_lib in ((frontdoor, stats), (jax_frontdoor, jax_stats)):
      hosts = {name: Host(stats_lib) for name in ("hostA", "hostB",
                                                  "hostC")}
      door = lib.FrontDoor(hosts)
      chosen = []
      with door:
        for step, depths in enumerate(plan):
          for host, host_depths in zip(hosts.values(), depths):
            for replica, depth in zip(host.replicas, host_depths):
              replica.depth = depth
          if step == 10:
            quarantined = door.apply_drift_rollup(
                rollup, {"hostB:11": "hostB"})
          if step == 20:
            door.quarantine_host("hostA", reason="manual")
            door.quarantine_host("hostC")
          if step == 25:
            door.reinstate_host("hostA")
            door.reinstate_host("hostB")
          before = {n: h.stats.snapshot()["logical_requests"]
                    for n, h in hosts.items()}
          slo_class = (None if step % 3 else
                       slo.SLOClass("interactive", 2, 30.0))
          door.submit(np.zeros((8, 8, 3)), slo=slo_class)
          chosen.append(next(n for n, h in hosts.items()
                             if h.stats.snapshot()["logical_requests"]
                             > before[n]))
      snap = door.snapshot()
      snap["timeline"] = [{k: v for k, v in e.items() if k != "t_s"}
                          for e in snap["timeline"]]
      outcomes.append((chosen, quarantined, snap,
                       [h.deadlines for h in hosts.values()]))
      if lib is frontdoor:
        path = door.export_trace(str(tmp_path / "frontdoor.json"))
        with open(path) as f:
          events = json.load(f)["traceEvents"]
        assert sum(e.get("name") == "serve/frontdoor"
                   for e in events) == len(plan)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == ["hostB:cpu#1"]
    assert outcomes[0][2]["reconciled"] is True
    assert outcomes[0][2]["submitted"] == len(plan)


# --- the bench ----------------------------------------------------------------


def _keys(tree):
  if isinstance(tree, dict):
    return {key: _keys(value) for key, value in tree.items()
            if key not in ("compile_ledger", "per_class")}
  if isinstance(tree, list) and tree and isinstance(tree[0], dict):
    return [_keys(tree[0])]
  return None


def test_bench_fleet_ci_keeps_the_jax_keys():
  res = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.bin.bench_fleet",
       "--ci", "--device", "cpu"],
      capture_output=True, text=True, timeout=300, cwd=ROOT,
      env=dict(os.environ, OMP_NUM_THREADS="1"))
  assert res.returncode == 0, res.stderr[-2000:]
  lines = [line for line in res.stdout.splitlines() if line.strip()]
  assert len(lines) == 1, res.stdout
  ours = json.loads(lines[0])
  with open(os.path.join(ROOT, "FLEET_r11.json")) as f:
    theirs = json.loads(f.readline())
  assert sorted(ours) == sorted(theirs)
  for key in ("sweep", "overload_burst", "classes"):
    assert _keys(ours[key]) == _keys(theirs[key]), key
  assert (sorted(ours["sweep"][0]["per_class"]["batch"])
          == sorted(theirs["sweep"][0]["per_class"]["batch"]))
  assert sorted(ours["rollout"]) == sorted(theirs["rollout"])
  assert ours["devices"] == 2 and ours["bucket_ladder"] == list(LADDER)
  assert ours["virtual_mesh"] is True and ours["device_kind"] == "cpu"
  assert ours["ledger_ok"] is True
  assert ours["compile_ledger"] == {
      label: {"1": 1, "2": 1, "4": 1} for label in ("cpu#0", "cpu#1")}
  assert ours["overload_burst"]["shed_total"] > 0
  assert ours["overload_burst"]["priority_ordering_ok"] is True
  rollout_block = ours["rollout"]
  assert rollout_block["promotions"] == 1
  assert rollout_block["auto_rollbacks"] == 1
  assert rollout_block["served_model_version"] == 1
  for point in ours["sweep"]:
    for entry in point["per_class"].values():
      assert entry["latency_p99_ms"] >= entry["latency_p50_ms"] > 0


# --- on the card --------------------------------------------------------------


@pytest.fixture
def deterministic():
  before = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  yield
  torch.backends.cudnn.deterministic = before


@pytest.mark.cuda
def test_cuda_routed_equals_single(cuda_device, deterministic):
  """Held requests split over two replicas on the card; each replica's
  flush equals one policy called on the same group (the same rung)."""
  import contextlib

  model, predictor = _critic_predictor(0, cuda_device)
  fleet = router.FleetRouter(predictor, devices=[cuda_device] * 2, seed=0,
                             ladder_sizes=LADDER, **CEM)
  images = list(np.random.default_rng(3).integers(0, 256, (8, 16, 16, 3),
                                                  np.uint8))
  fleet.warmup(lambda i: images[i % len(images)])
  groups = []
  for replica in fleet.replicas:
    def recorded(items, _flush=replica._flush):
      groups.append([int(item[1]) for item in items])
      return _flush(items)
    replica.batcher._batch_fn = recorded
  with fleet:
    with contextlib.ExitStack() as stack:
      for replica in fleet.replicas:
        stack.enter_context(replica.batcher.hold_flushes())
      futures = [fleet.submit(image, seed=500 + i)
                 for i, image in enumerate(images)]
    routed = {500 + i: f.result(timeout=60) for i, f in enumerate(futures)}
  assert len(groups) == 2 and sorted(sum(groups, [])) == sorted(routed)
  single = _single(predictor)
  for group in groups:
    want = single([images[s - 500] for s in group],
                  np.asarray(group, np.uint32))
    np.testing.assert_array_equal(np.stack([routed[s] for s in group]),
                                  want)
  ledger.check_compile_ledger(fleet.compile_ledger())


@pytest.mark.cuda
def test_cuda_variables_override_bit_for_bit(cuda_device, deterministic):
  for tier in ("f32", "int8"):
    override, fresh, (before, after) = _override_case(cuda_device, tier)
    for got, want in zip(override, fresh):
      np.testing.assert_array_equal(got, want)
    for got, want in zip(after, before):
      np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_shared_graph_pool_equals_separate_pools(cuda_device,
                                                      deterministic):
  _, predictor = _critic_predictor(0, cuda_device)
  images = list(np.random.default_rng(5).integers(0, 256, (4, 16, 16, 3),
                                                  np.uint8))
  answers = []
  for shared in (True, False):
    policy = _single(predictor)
    policy.share_graph_pool = shared
    policy.warm(lambda i: images[i % len(images)])
    answers.append([policy(images[:b], np.arange(b, dtype=np.uint32),
                           return_scores=True) for b in LADDER])
    assert (policy._pool is not None) == shared
  for ours, theirs in zip(*answers):
    for got, want in zip(ours, theirs):
      np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_precision_offer_under_live_load(cuda_device):
  predictor = _predictor(cuda_device)
  fleet = _router(predictor, device=cuda_device)
  fleet.warmup(predictor.make_image)
  errors, stop = [], threading.Event()

  def client(i):
    try:
      while not stop.is_set():
        fleet.act(predictor.make_image(i), timeout=60)
    except Exception as e:  # noqa: BLE001 — asserted below
      errors.append(e)

  with fleet:
    controller = rollout.RolloutController(
        fleet, predictor, rollout.RolloutConfig(**CONFIG))
    with controller:
      threads = [threading.Thread(target=client, args=(i,))
                 for i in range(4)]
      for thread in threads:
        thread.start()
      time.sleep(0.2)  # traffic flowing before the capture
      assert controller.offer_precision_candidate("bf16")
      _drive(controller, predictor)
      stop.set()
      for thread in threads:
        thread.join(60)
  assert not errors, errors[:1]
  assert [e["event"] for e in controller.timeline()] == [
      "shadow_start", "canary_start", "promote"]
  assert fleet.precision == "bf16"
  flat = ledger.check_compile_ledger(fleet.ledger.compile_counts)
  assert len(flat) == 2 * 2 * len(LADDER)
