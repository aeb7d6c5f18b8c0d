"""The port's single serving replica held against the JAX package.

``serving/slo.py``, ``stats.py`` and ``batcher.py`` are copies: the same
samples give equal ``LatencyHistogram``, ``QSketch`` and ``ServingStats``
snapshots and registry counters; a burst submitted under ``hold_flushes``
(fixed deadlines, a queue bound) gives the same flush composition in the
same EDF order, the same shed set with the same reasons and the same
``slo_breach`` triggers; a poisoned dispatcher restarts and then goes down
the same way. ``TinyQPredictor`` draws the JAX predictor's weights bit for
bit, so ``best_action`` agrees bit for bit; ``predict`` agrees within
2^-20 of the scores' scale (XLA's fused dot and tanh round apart from
PyTorch's). ``predict_batched`` pads to the same rungs.
``CheckpointPredictor`` serves a port ``model_dir`` of the 64x64 flagship
critic equal to the model's ``predict_fn`` on the same variables and
within the critic's 1e-4 logit bound of the JAX ``predict_fn`` on the
bridged ones; it serves EMA parameters, polls newest-wins, and rejects
drifted candidates. ``FleetServer`` serves 16 client threads, each action
within 0.75 of its own optimum (the JAX bar), and
``bench_serving --fleet --smoke --device cpu`` keeps the JAX line's schema
with one build a rung. On the card (``cuda`` marker) a warmed server's held
flush of 16 equals the direct policy call bit for bit.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.obs import flight_recorder as jax_flight
  from tensor2robot_tpu.obs import registry as jax_registry
  from tensor2robot_tpu.obs import watchdog as jax_watchdog
  from tensor2robot_tpu.predictors import (
      abstract_predictor as jax_abstract_predictor,
  )
  from tensor2robot_tpu.research.qtopt import t2r_models as jax_models
  from tensor2robot_tpu.serving import batcher as jax_batcher
  from tensor2robot_tpu.serving import bucketing as jax_bucketing
  from tensor2robot_tpu.serving import slo as jax_slo
  from tensor2robot_tpu.serving import smoke as jax_smoke
  from tensor2robot_tpu.serving import stats as jax_stats
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
except ImportError:
  jax = None

from tensor2robot_tpu_torch.obs import flight_recorder  # noqa: E402
from tensor2robot_tpu_torch.obs import registry  # noqa: E402
from tensor2robot_tpu_torch.obs import watchdog  # noqa: E402
from tensor2robot_tpu_torch.predictors import abstract_predictor  # noqa: E402
from tensor2robot_tpu_torch.predictors import (  # noqa: E402
    checkpoint_predictor,
)
from tensor2robot_tpu_torch.research.qtopt import t2r_models  # noqa: E402
from tensor2robot_tpu_torch.serving import batcher, bucketing  # noqa: E402
from tensor2robot_tpu_torch.serving import slo, smoke, stats  # noqa: E402
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy  # noqa: E402
from tensor2robot_tpu_torch.serving.server import FleetServer  # noqa: E402
from tensor2robot_tpu_torch.train import checkpoints  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import backoff  # noqa: E402
from tensor2robot_tpu_torch.utils import metric_writer  # noqa: E402

CheckpointPredictor = checkpoint_predictor.CheckpointPredictor
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OWN_OPTIMUM_BAR = 0.75  # tests/test_serving.py's
LOGIT_ATOL = 1e-4  # the 64x64 critic at float32 (tests/test_torch_qtopt.py)
LADDER = (1, 2, 4, 8, 16)


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _packages():
  """The same module names in both packages: (JAX, port)."""
  return [
      dict(registry=jax_registry, stats=jax_stats, slo=jax_slo,
           batcher=jax_batcher, flight=jax_flight, watchdog=jax_watchdog),
      dict(registry=registry, stats=stats, slo=slo, batcher=batcher,
           flight=flight_recorder, watchdog=watchdog)]


# --- stats --------------------------------------------------------------------


def _stats_ops(pkg):
  reg = pkg["registry"].MetricRegistry()
  serving = pkg["stats"].ServingStats(registry=reg)
  rng = np.random.default_rng(11)
  for i, latency in enumerate(rng.exponential(4.0, 203)):
    name = ("interactive", "batch", None)[i % 3]
    serving.record_request(name)
    serving.record_latency_ms(float(latency), name)
  serving.record_logical_request()
  serving.record_shed("batch", "capacity")
  serving.record_shed(None, "expired")
  serving.record_shed("interactive", "fault")
  for bucket, size, depth in ((16, 13, 2), (4, 3, 0), (16, 16, 5)):
    serving.record_flush(size, bucket, depth, size < bucket)
  serving.record_q_values("r0", rng.normal(0.5, 0.1, 40).tolist())
  hist = pkg["stats"].LatencyHistogram()
  sketch = pkg["stats"].QSketch(max_samples=16)
  for value in rng.random(50):
    hist.record(float(value) * 10)
  sketch.record_many(rng.random(50).tolist())
  return serving, reg, hist, sketch


class TestStats:

  def test_snapshots_equal_jax_on_the_same_samples(self, needs_jax,
                                                   tmp_path):
    (theirs, jax_reg, jax_hist, jax_sketch), (ours, reg, hist, sketch) = (
        _stats_ops(pkg) for pkg in _packages())
    assert ours.snapshot() == theirs.snapshot()
    assert reg.snapshot() == jax_reg.snapshot()
    assert hist.summary() == jax_hist.summary()
    assert hist.percentile(90) == jax_hist.percentile(90)
    assert sketch.summary() == jax_sketch.summary()
    snap = ours.snapshot()
    assert snap["shed_total"] == 3 and snap["per_class"]["batch"][
        "shed_capacity"] == 1
    assert snap["batch_occupancy"] == round(32 / 36, 4)
    with metric_writer.MetricWriter(str(tmp_path)) as writer:
      ours.write_to(writer, step=3)
    with open(tmp_path / "metrics.jsonl") as f:
      record = json.load(f)
    assert record["serving/class/interactive/requests"] == 68
    assert record["serving/requests"] == 203

  def test_empty_and_percentiles(self, needs_jax):
    for lib in (jax_stats, stats):
      assert lib.LatencyHistogram().summary() == {"count": 0}
      assert lib.LatencyHistogram().percentile(50) is None
      assert lib.QSketch().summary() == {"count": 0, "p50": None}
    hist = stats.LatencyHistogram()
    for value in range(1, 101):
      hist.record(float(value))
    assert hist.summary()["p50_ms"] == 50.0
    assert hist.summary()["p99_ms"] == 99.0
    with pytest.raises(ValueError, match="unknown shed reason"):
      stats.ServingStats(registry=registry.MetricRegistry()).record_shed(
          "x", "boredom")


# --- the micro-batcher -------------------------------------------------------


# (item, class, deadline offset in s from a far base; None: already past)
_BURST = [("a", "batch", 5.0), ("b", "interactive", 1.0),
          ("c", "standard", 3.0), ("d", "batch", 6.0),
          ("e", "interactive", 2.0), ("f", "standard", 4.0),
          ("g", "batch", 0.5), ("x", "interactive", None),
          ("h", "interactive", 7.0), ("i", "standard", 0.25)]


def _held_burst(pkg):
  """The burst under hold_flushes into a queue bound of 5, then stop()
  (which overrides the hold and drains in EDF order)."""
  reg = pkg["registry"].MetricRegistry()
  serving = pkg["stats"].ServingStats(registry=reg)
  recorder = pkg["flight"].FlightRecorder()
  classes = {c.name: c for c in pkg["slo"].DEFAULT_CLASSES}
  flushes = []

  def batch_fn(items):
    flushes.append(list(items))
    return [f"ok-{item}" for item in items]

  base = time.perf_counter() + 600.0
  futures = {}
  mb = pkg["batcher"].MicroBatcher(
      batch_fn, max_batch=3, deadline_ms=50.0, stats=serving, max_queue=5,
      flight_recorder=recorder, watchdog=pkg["watchdog"].Watchdog(),
      bucket_for=lambda n: 4)
  with mb:
    with mb.hold_flushes():
      for item, name, offset in _BURST:
        deadline = (time.perf_counter() - 1.0 if offset is None
                    else base + offset)
        futures[item] = mb.submit(item, slo=classes[name],
                                  deadline_at=deadline)
      mb.stop()
  outcomes = {}
  for item, future in futures.items():
    try:
      outcomes[item] = future.result(timeout=30)
    except pkg["slo"].RequestShed as e:
      outcomes[item] = ("shed", e.class_name, e.reason)
  snap = serving.snapshot()
  for key in [k for k in snap if k.startswith("latency_")]:
    del snap[key]
  for entry in snap["per_class"].values():
    for key in [k for k in entry if k.startswith("latency_")]:
      del entry[key]
  counters = {k: v for k, v in reg.snapshot().items()
              if "latency_ms" not in k}
  triggers = [(e["name"], e["slo_class"], e["shed_reason"])
              for e in recorder.events() if e["kind"] == "trigger"]
  return flushes, outcomes, snap, counters, triggers


class TestMicroBatcher:

  def test_held_burst_equals_jax(self, needs_jax):
    theirs, ours = (_held_burst(pkg) for pkg in _packages())
    assert ours == theirs
    flushes, outcomes, snap, counters, triggers = ours
    # Full queue: f evicts d (batch, latest), g evicts a, h evicts g, i
    # evicts f (standard, latest); x expired. EDF over the survivors,
    # max_batch 3 a flush.
    assert flushes == [["i", "b", "e"], ["c", "h"]]
    assert {k for k, v in outcomes.items() if v[0] == "shed"} == {
        "a", "d", "f", "g", "x"}
    assert outcomes["x"] == ("shed", "interactive", "expired")
    assert outcomes["f"] == ("shed", "standard", "capacity")
    assert snap["flushes"] == 2 and snap["shed_total"] == 5
    assert counters["serving/shed_capacity"] == 4
    assert triggers[0] == ("slo_breach", "batch", "capacity")

  def test_dispatcher_restart_budget_equals_jax(self, needs_jax):

    def scenario(pkg):
      class Poison(BaseException):
        pass

      def batch_fn(items):
        if "poison" in items:
          raise Poison("boom")
        return list(items)

      recorder = pkg["flight"].FlightRecorder()
      mb = pkg["batcher"].MicroBatcher(
          batch_fn, max_batch=1, deadline_ms=0.0, restart_budget=1,
          flight_recorder=recorder, watchdog=pkg["watchdog"].Watchdog())
      mb.start()
      seen = []
      for item in ("poison", "ok", "poison"):
        try:
          seen.append(mb.submit(item).result(timeout=30))
        except pkg["slo"].DispatcherDead as e:
          seen.append(type(e).__name__)
      deadline = time.monotonic() + 30
      while not mb.dispatcher_dead and time.monotonic() < deadline:
        time.sleep(0.01)
      with pytest.raises(pkg["slo"].DispatcherDead):
        mb.submit("late")
      mb.stop()
      return (seen, mb.dispatcher_restarts, mb.dispatcher_dead,
              [(e["name"], e["recovered"]) for e in recorder.events()
               if e["kind"] == "trigger"])

    theirs, ours = (scenario(pkg) for pkg in _packages())
    assert ours == theirs == (
        ["DispatcherDead", "ok", "DispatcherDead"], 1, True,
        [("batcher_dispatcher_death", True),
         ("batcher_dispatcher_death", False)])

  def test_flush_spans_carry_the_batch_ids(self):
    from tensor2robot_tpu_torch.obs import trace
    tracer = trace.get_tracer()
    mb = batcher.MicroBatcher(lambda items: list(items), max_batch=2,
                              deadline_ms=10_000.0,
                              watchdog=watchdog.Watchdog())
    before = tracer.total_spans
    with mb:
      futures = [mb.submit(i, request_id=f"rid-{i}") for i in range(2)]
      assert [f.result(timeout=30) for f in futures] == [0, 1]
    spans = tracer.spans()[-(tracer.total_spans - before):]
    flush = [s for s in spans if s["name"] == "serve/flush"]
    enqueues = [s for s in spans if s["name"] == "serve/enqueue"]
    assert [s["request_id"] for s in enqueues] == ["rid-0", "rid-1"]
    assert flush[0]["request_ids"] == "rid-0,rid-1"
    assert "request_id" not in flush[0] and flush[0]["batch"] == 2

  def test_heartbeat_and_fault_plan(self):
    dog = watchdog.Watchdog()
    mb = batcher.MicroBatcher(lambda items: list(items), watchdog=dog)
    with mb:
      assert mb.submit(1).result(timeout=30) == 1
      assert dog.snapshot()["components"]["serve/batcher"]["beats"] >= 1
    assert dog.snapshot()["components"] == {}
    with pytest.raises(NotImplementedError, match="item 15"):
      batcher.MicroBatcher(lambda items: items, fault_plan=object())


class TestInjectedSLOBreachDump:
  """An SLO breach under hold_flushes dumps the flight recorder (the JAX
  tests/test_obs.py acceptance path), in both packages alike."""

  def test_capacity_breach_under_held_flushes_dumps(self, needs_jax,
                                                    tmp_path):
    payloads = []
    for pkg, name in zip(_packages(), ("jax", "port")):
      recorder = pkg["flight"].FlightRecorder(
          dump_dir=str(tmp_path / name), min_dump_interval_s=0.0)
      serving = pkg["stats"].ServingStats(
          registry=pkg["registry"].MetricRegistry())
      batch_class = pkg["slo"].SLOClass("batch", priority=0,
                                        deadline_ms=2000.0)
      with pkg["batcher"].MicroBatcher(
          lambda items: list(items), max_batch=4, deadline_ms=50.0,
          stats=serving, max_queue=2, flight_recorder=recorder,
          watchdog=pkg["watchdog"].Watchdog()) as mb:
        with mb.hold_flushes():
          futures = [mb.submit(i, slo=batch_class) for i in range(6)]
        shed = 0
        for future in futures:
          try:
            future.result(timeout=30)
          except pkg["slo"].RequestShed:
            shed += 1
      assert shed == 4
      dumps = sorted(os.listdir(tmp_path / name))
      assert len(dumps) == 4
      with open(tmp_path / name / dumps[0]) as f:
        payload = json.load(f)
      payloads.append((payload["schema"], payload["reason"],
                       {k: v for k, v in payload["trigger"].items()
                        if k != "request_id"},
                       "request_id" in payload))
    assert payloads[0] == payloads[1] == (
        "t2r-flightrec-1", "slo_breach",
        {"slo_class": "batch", "shed_reason": "capacity"}, True)

  def test_expired_at_enqueue_also_triggers(self, tmp_path):
    recorder = flight_recorder.FlightRecorder(dump_dir=str(tmp_path),
                                              min_dump_interval_s=0.0)
    with batcher.MicroBatcher(lambda items: list(items), max_batch=4,
                              flight_recorder=recorder,
                              watchdog=watchdog.Watchdog()) as mb:
      future = mb.submit("late", deadline_at=time.perf_counter() - 1.0)
      with pytest.raises(slo.RequestShed):
        future.result(timeout=10)
    assert recorder.dumps_written == 1
    event = [e for e in recorder.events() if e["kind"] == "trigger"][-1]
    assert event["shed_reason"] == "expired"


class TestCircuitBreaker:

  def test_transitions_equal_jax_under_an_injected_clock(self, needs_jax):
    seen = []
    for lib in (jax_slo, slo):
      breaker = lib.CircuitBreaker(failure_threshold=2, quarantine_s=1.0)
      trail = []
      for t, call in [(0.0, "fail"), (0.1, "fail"), (0.5, "allows"),
                      (1.2, "allows"), (1.3, "allows"), (1.4, "fail"),
                      (2.5, "allows"), (2.6, "release"), (2.7, "allows"),
                      (2.8, "ok"), (3.0, "allows")]:
        if call == "fail":
          breaker.record_failure(now=t)
        elif call == "ok":
          breaker.record_success(now=t)
        elif call == "release":
          breaker.release_probe()
        else:
          trail.append(breaker.allows(now=t))
        trail.append(breaker.state)
      seen.append((trail, breaker.events))
    assert seen[0] == seen[1]
    assert seen[1][1][-1]["state"] == "closed"


# --- the predictors ----------------------------------------------------------


def _images(n, seed=0, size=8):
  return np.random.default_rng(seed).random((n, size, size, 3)).astype(
      np.float32)


class TestTinyQPredictor:

  def test_weights_and_best_action_bit_for_bit(self, needs_jax):
    for seed in (0, 3):
      theirs = jax_smoke.TinyQPredictor(seed=seed)
      ours = smoke.TinyQPredictor(seed=seed, device="cpu")
      np.testing.assert_array_equal(
          ours.device_fn()[1]["w"].numpy(),
          np.asarray(theirs._variables["params"]["w"]))
      for i in range(8):
        np.testing.assert_array_equal(ours.make_image(i),
                                      theirs.make_image(i))
        np.testing.assert_array_equal(ours.best_action(ours.make_image(i)),
                                      theirs.best_action(
                                          theirs.make_image(i)))
      for jitter in (0.0, 0.5):
        np.testing.assert_array_equal(
            ours.make_candidate_variables(2.0, jitter, seed=4)["w"],
            np.asarray(theirs.make_candidate_variables(
                2.0, jitter, seed=4)["params"]["w"]))

  @pytest.mark.parametrize("n", [1, 5, 64])
  def test_predict_within_float32_rounding_of_jax(self, needs_jax, n):
    rng = np.random.default_rng(n)
    features = {"image": _images(n, n),
                "action": rng.uniform(-1, 1, (n, 4)).astype(np.float32)}
    want = np.asarray(jax_smoke.TinyQPredictor().predict(
        features)["q_predicted"])
    got = smoke.TinyQPredictor(device="cpu").predict(features)[
        "q_predicted"]
    bound = 2.0 ** -20 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)

  def test_set_variables_guard(self):
    predictor = smoke.TinyQPredictor(device="cpu")
    good = predictor.make_candidate_variables(jitter=0.1)
    with pytest.raises(ValueError, match="shape"):
      predictor.set_variables({"w": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="cast=True"):
      predictor.set_variables({"w": good["w"].astype(np.float64)})
    predictor.set_variables({"w": good["w"].astype(np.float64)}, cast=True)
    assert predictor.device_fn()[1]["w"].dtype == torch.float32
    predictor.set_variables(good, version=40)
    assert predictor.model_version == 40
    predictor.set_variables(good, version=10)  # never regresses
    assert predictor.model_version == 41
    predictor.set_variables(good)
    assert predictor.model_version == 42


class TestPredictBatched:

  @pytest.mark.parametrize("ladder", [None, LADDER, (3, 6)])
  def test_pads_like_jax_and_slices_back(self, needs_jax, ladder):
    def recorded(pkg_predictor, predict_batched, ladder_obj):
      seen = []
      inner = pkg_predictor.predict

      class Recording:
        def predict(self, features):
          seen.append(np.asarray(features["image"]))
          return inner(features)

      outs = []
      for n in (1, 3, 5, 6):
        rng = np.random.default_rng(n)
        features = {"image": _images(n, n),
                    "action": rng.uniform(-1, 1, (n, 4)).astype(np.float32)}
        outs.append(predict_batched(Recording(), features, ladder_obj))
        # The pad repeats the last real row.
        for row in seen[-1][n:]:
          np.testing.assert_array_equal(row, features["image"][-1])
      return [len(images) for images in seen], outs

    ours = recorded(
        smoke.TinyQPredictor(device="cpu"),
        abstract_predictor.AbstractPredictor.predict_batched,
        None if ladder is None else bucketing.BucketLadder(ladder))
    theirs = recorded(
        jax_smoke.TinyQPredictor(),
        jax_abstract_predictor.AbstractPredictor.predict_batched,
        None if ladder is None else jax_bucketing.BucketLadder(ladder))
    assert ours[0] == theirs[0]
    for got, want, n in zip(ours[1], theirs[1], (1, 3, 5, 6)):
      assert got["q_predicted"].shape == (n,)
      np.testing.assert_allclose(got["q_predicted"], want["q_predicted"],
                                 rtol=0, atol=2.0 ** -20 * 16)

  def test_inconsistent_batch_dims_rejected(self):
    with pytest.raises(ValueError, match="inconsistent"):
      smoke.TinyQPredictor(device="cpu").predict_batched({
          "image": np.zeros((2, 8, 8, 3), np.float32),
          "action": np.zeros((3, 4), np.float32)})


def _flagship_model_dir(root, step, ema=False, seed=0):
  """A port model_dir of the 64x64 float32 critic: the JAX package's
  initial variables (batch statistics moved off their init) through the
  bridge, saved at `step`; with `ema`, EMA parameters half the params."""
  jax_model = jax_models.QTOptGraspingModel(image_size=64,
                                            compute_dtype=jnp.float32)
  model = t2r_models.QTOptGraspingModel(
      image_size=64, compute_dtype=torch.float32, use_avg_model_params=ema)
  rng = np.random.default_rng(seed)
  features = {"image": rng.random((2, 64, 64, 3)).astype(np.float32),
              "action": rng.uniform(-1, 1, (2, 4)).astype(np.float32)}
  variables = jax.device_get(jax_model.module.init(
      jax.random.key(seed), jax_ts.TensorSpecStruct(features), "train"))
  variables = jax.tree_util.tree_map(np.asarray, variables)
  variables["batch_stats"] = jax.tree_util.tree_map(
      lambda x: x + np.float32(0.25) * rng.random(x.shape).astype(
          np.float32), variables["batch_stats"])
  state = Trainer(model, device="cpu").create_train_state(variables)
  if ema:
    with torch.no_grad():
      for key, value in state.ema_params.items():
        value.copy_(state.params[key] * 0.5)
  checkpoints.CheckpointManager(os.path.join(root, "checkpoints")).save(
      step, state)
  return jax_model, model, variables, state


class TestCheckpointPredictor:

  def test_serves_a_model_dir_like_predict_fn_and_jax(self, needs_jax,
                                                      tmp_path):
    jax_model, model, variables, state = _flagship_model_dir(
        str(tmp_path), step=3)
    predictor = CheckpointPredictor(model, str(tmp_path), device="cpu")
    assert predictor.restore()
    assert predictor.model_version == 3
    rng = np.random.default_rng(9)
    features = {"image": rng.random((5, 64, 64, 3)).astype(np.float32),
                "action": rng.uniform(-1, 1, (5, 4)).astype(np.float32)}
    got = predictor.predict(features)["q_predicted"]
    direct = model.predict_fn(
        state.variables(),
        {k: torch.from_numpy(v) for k, v in features.items()})
    np.testing.assert_array_equal(got, direct["q_predicted"].numpy())
    want = np.asarray(jax_model.predict_fn(
        variables, jax_ts.TensorSpecStruct(features))["q_predicted"])
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    fn, served = predictor.device_fn()
    assert fn == model.predict_fn and set(served) == set(
        state.variables())

  def test_ema_newest_wins_and_polling(self, needs_jax, tmp_path):
    _, model, _, state = _flagship_model_dir(str(tmp_path), step=1,
                                             ema=True)
    predictor = CheckpointPredictor(model, str(tmp_path / "checkpoints"),
                                    device="cpu")
    assert predictor.restore()
    served = predictor.device_fn()[1]
    for key, value in state.ema_params.items():
      assert torch.equal(served[key], value)
    assert predictor.restore()  # nothing newer: still serving
    assert predictor.model_version == 1
    checkpoints.CheckpointManager(str(tmp_path / "checkpoints")).save(
        5, state)
    assert predictor.restore() and predictor.model_version == 5
    empty = CheckpointPredictor(model, str(tmp_path / "none"), device="cpu")
    assert not empty.restore(timeout_s=0.0)
    with pytest.raises(backoff.PollTimeout):
      empty.restore(timeout_s=0.0, raise_on_timeout=True)
    with pytest.raises(ValueError, match="init_randomly"):
      CheckpointPredictor(model, device="cpu").restore()

  def test_refuses_orbax_and_drift(self, tmp_path):
    model = t2r_models.QTOptGraspingModel(image_size=64,
                                          compute_dtype=torch.float32)
    orbax = tmp_path / "orbax"
    (orbax / "7" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
      CheckpointPredictor(model, str(orbax), device="cpu").restore()
    predictor = CheckpointPredictor(model, device="cpu")
    with pytest.raises(ValueError, match="no model loaded"):
      predictor.set_variables({})
    predictor.init_randomly(torch.Generator().manual_seed(4))
    good = {k: v.clone() for k, v in predictor.device_fn()[1].items()}
    key = next(k for k, v in good.items() if v.is_floating_point())
    with pytest.raises(ValueError, match="shape"):
      predictor.set_variables({**good, key: torch.cat([good[key]] * 2)})
    with pytest.raises(ValueError, match="cast=True"):
      predictor.set_variables({**good, key: good[key].double()})
    with pytest.raises(ValueError, match="keys"):
      predictor.set_variables({k: v for k, v in good.items() if k != key})
    ints = [k for k, v in good.items() if not v.is_floating_point()]
    if ints:
      with pytest.raises(ValueError, match="structural"):
        predictor.set_variables({**good, ints[0]: good[ints[0]].float()},
                                cast=True)
    predictor.set_variables({**good, key: good[key].double() + 1},
                            version=42, cast=True)
    assert predictor.model_version == 42
    assert predictor.device_fn()[1][key].dtype == good[key].dtype
    assert torch.equal(predictor.device_fn()[1][key], good[key] + 1)
    predictor.close()
    with pytest.raises(ValueError, match="no model loaded"):
      predictor.predict({})


# --- the server ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_predictor():
  return smoke.TinyQPredictor(image_size=8, action_size=4, seed=0,
                              device="cpu")


@pytest.fixture(scope="module")
def fleet_policy(tiny_predictor):
  return CEMFleetPolicy(tiny_predictor, action_size=4, num_samples=64,
                        num_elites=6, iterations=3, seed=0)


class TestFleetServer:

  def test_concurrent_clients_get_their_own_answers(self, fleet_policy,
                                                    tiny_predictor):
    """16 client threads x 4 frames of distinct images; every action lands
    within the JAX bar of its own image's optimum."""
    n_clients, frames = 16, 4
    images = [tiny_predictor.make_image(200 + i) for i in range(n_clients)]
    optima = np.stack([tiny_predictor.best_action(im) for im in images])
    results = [None] * n_clients
    errors = []
    fleet_policy.warm(tiny_predictor.make_image)
    server = FleetServer(fleet_policy, max_batch=16, deadline_ms=20.0,
                         stats=stats.ServingStats(
                             registry=registry.MetricRegistry()))

    def client(i):
      try:
        for _ in range(frames):
          results[i] = server.act(images[i], timeout=60)
      except Exception as e:  # noqa: BLE001 — surfaced below
        errors.append(e)

    with server:
      threads = [threading.Thread(target=client, args=(i,))
                 for i in range(n_clients)]
      for t in threads:
        t.start()
      for t in threads:
        t.join()
    assert not errors, errors
    for i, action in enumerate(results):
      own = float(np.linalg.norm(action - optima[i]))
      assert own < OWN_OPTIMUM_BAR, (i, own)
    snap = server.snapshot()
    assert snap["requests"] == snap["latency_samples"] == n_clients * frames
    assert snap["latency_p99_ms"] >= snap["latency_p50_ms"] > 0
    assert 0 < snap["batch_occupancy"] <= 1
    assert snap["compile_counts"] == {b: 1 for b in LADDER}

  def test_held_flush_equals_the_direct_policy_call(self, fleet_policy,
                                                    tiny_predictor):
    """One held flush of 16 carries the seeds the server assigned; the
    policy called directly with those seeds answers the same."""
    images = [tiny_predictor.make_image(300 + i) for i in range(16)]
    server = FleetServer(fleet_policy, max_batch=16, deadline_ms=10_000.0,
                         stats=stats.ServingStats(
                             registry=registry.MetricRegistry()))
    with server:
      start = int(fleet_policy.assign_seeds(1)[0]) + 1
      with server.batcher.hold_flushes():
        futures = [server.submit(image) for image in images]
      served = np.stack([f.result(timeout=60) for f in futures])
    seeds = np.arange(start, start + 16, dtype=np.uint32)
    np.testing.assert_array_equal(served, fleet_policy(images, seeds))
    assert server.snapshot()["flushes"] == 1

  def test_metric_writer_and_ladder_bound(self, fleet_policy,
                                          tiny_predictor, tmp_path):
    writer = metric_writer.MetricWriter(str(tmp_path))
    server = FleetServer(fleet_policy, max_batch=2, deadline_ms=5.0,
                         metric_writer=writer,
                         stats=stats.ServingStats(
                             registry=registry.MetricRegistry()))
    with server:
      [f.result(timeout=60) for f in
       [server.submit(tiny_predictor.make_image(i)) for i in range(4)]]
      server.write_metrics()
    writer.close()
    with open(tmp_path / "metrics.jsonl") as f:
      record = json.loads(f.readlines()[-1])
    assert record["serving/requests"] == 4
    assert "serving/latency_p50_ms" in record
    with pytest.raises(ValueError, match="ladder top rung"):
      FleetServer(fleet_policy, max_batch=32)


class TestBenchServingSmoke:

  def test_fleet_smoke_line(self):
    res = subprocess.run(
        [sys.executable, "-m", "tensor2robot_tpu_torch.bin.bench_serving",
         "--fleet", "--smoke", "--device", "cpu", "--clients", "4",
         "--frames", "4", "--repeats", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [line for line in res.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert set(line) == {
        "metric", "device_kind", "mode", "cem", "bucket_ladder",
        "compile_counts", "deadline_ms", "frames_per_client", "repeats",
        "single_client_closed_loop_hz", "single_client_trials_hz",
        "fleet_sweep", "amortization_at_max_clients", "reference_note"}
    assert line["device_kind"] == "cpu" and line["mode"] == "smoke"
    assert line["compile_counts"] == {str(b): 1 for b in LADDER}
    (point,) = line["fleet_sweep"]
    assert point["clients"] == 4
    assert point["latency_p99_ms"] >= point["latency_p50_ms"] > 0
    assert 0 < point["batch_occupancy"] <= 1
    assert line["amortization_at_max_clients"] > 0

  def test_smoke_needs_fleet(self):
    from tensor2robot_tpu_torch.bin import bench_serving
    with pytest.raises(SystemExit):
      bench_serving._parse_args(["--smoke"])


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_held_flush_equals_the_policy_call(cuda_device):
  """On the card: a warmed server's held flush of 16 replays the rung-16
  graph, bit for bit the direct policy call with the same seeds, and
  builds nothing."""
  torch.backends.cudnn.deterministic = True
  predictor = smoke.TinyQPredictor(device=cuda_device)
  policy = CEMFleetPolicy(predictor, action_size=4, num_samples=32,
                          num_elites=4, iterations=2, seed=0)
  policy.warm(predictor.make_image)
  ledger = dict(policy.compile_counts)
  images = [predictor.make_image(500 + i) for i in range(16)]
  server = FleetServer(policy, deadline_ms=10_000.0,
                       stats=stats.ServingStats(
                           registry=registry.MetricRegistry()))
  with server:
    start = int(policy.assign_seeds(1)[0]) + 1
    with server.batcher.hold_flushes():
      futures = [server.submit(image) for image in images]
    served = np.stack([f.result(timeout=60) for f in futures])
  seeds = np.arange(start, start + 16, dtype=np.uint32)
  np.testing.assert_array_equal(served, policy(images, seeds))
  assert policy.compile_counts == ledger == {b: 1 for b in LADDER}
