"""The port's closed QT-Opt loop held against the JAX package.

The health sentinel gives the JAX monitor's breaches, drift state and
snapshot on one scripted stream (a drift, a non-finite value, a priority
collapse, a halt), and its tree reductions match JAX's within 1e-6
relative. ``train_step(with_health=True)`` reports the JAX step's
gradient norm within 1e-5 relative on bridged weights, and without the
flag the step is unchanged bit for bit. One 300-step
``run_qtopt_replay.run(smoke=True)`` on the CPU is held to the JAX
smoke's checks (``tests/test_replay.py``): the eval TD reduction bar of
0.30, every program built once, the loop's accounting, the JSONL keys and
the JAX result's keys less ``obs``. The collector threads race the
learner, so the loop is held to the JAX bar, not to bits.
"""

import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import optax
  from tensor2robot_tpu.bin import run_qtopt_replay as jax_cli
  from tensor2robot_tpu.obs import flight_recorder as jax_flight
  from tensor2robot_tpu.obs import health as jax_health
  from tensor2robot_tpu.obs import registry as jax_registry
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.replay import loop as jax_loop
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.obs import health  # noqa: E402
from tensor2robot_tpu_torch.obs.context import bind  # noqa: E402
from tensor2robot_tpu_torch.obs.flight_recorder import (  # noqa: E402
    FlightRecorder,
)
from tensor2robot_tpu_torch.obs.registry import MetricRegistry  # noqa: E402
from tensor2robot_tpu_torch.obs.watchdog import Watchdog  # noqa: E402
from tensor2robot_tpu_torch.replay import ingest, loop  # noqa: E402
from tensor2robot_tpu_torch.replay import ring_buffer, smoke  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402

SMOKE_BAR = 0.30  # the JAX smoke's eval TD reduction bar
NORM_RTOL = 1e-5  # the gradient norm against JAX's (float32)
REDUCTION_RTOL = 1e-6  # the tree reductions against JAX's (float32)


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


# --- the health sentinel ----------------------------------------------------


def _scripted_stream():
  """40 summaries: a noisy healthy run, a grad-norm spike at 15, NaN
  grads at 20, a priority collapse at 25-27, a stale sample at 30, then
  healthy again."""
  rng = np.random.default_rng(0)
  stream = []
  for step in range(1, 41):
    summary = {
        "health/nonfinite_grads": 0.0, "health/nonfinite_params": 0.0,
        "health/nonfinite_targets": 0.0,
        "health/grad_norm": float(1.0 + 0.05 * rng.standard_normal()),
        "health/param_norm": 12.0,
        "health/td_mean": float(0.2 + 0.01 * rng.standard_normal()),
        "health/td_max": 0.6,
        "health/q_mean": 0.5,
        "health/q_max": float(0.9 + 0.01 * rng.standard_normal()),
        "health/priority_entropy": 0.95,
        "health/sample_age": 100.0,
    }
    if step == 15:
      summary["health/grad_norm"] = 40.0
    if step == 20:
      summary["health/nonfinite_grads"] = 7.0
      summary["health/grad_norm"] = math.nan
    if 25 <= step <= 27:
      summary["health/priority_entropy"] = 0.01
    if step == 30:
      summary["health/sample_age"] = 1e6
    stream.append((step, summary))
  return stream


def _monitors(tmp_path, **kwargs):
  theirs = jax_health.HealthMonitor(
      rules=jax_health.default_rules(capacity=512),
      registry=jax_registry.MetricRegistry(),
      recorder=jax_flight.FlightRecorder(dump_dir=str(tmp_path)), **kwargs)
  ours = health.HealthMonitor(rules=health.default_rules(capacity=512),
                              **kwargs)
  return theirs, ours


class TestHealthMonitor:

  def test_rules_are_the_jax_rules(self, needs_jax):
    for capacity in (None, 512):
      assert ([dataclasses.asdict(r) for r in health.default_rules(capacity)]
              == [dataclasses.asdict(r)
                  for r in jax_health.default_rules(capacity)])

  def test_scripted_stream_matches_jax(self, needs_jax, tmp_path):
    theirs, ours = _monitors(tmp_path)
    seen = []
    ours._on_breach = seen.append
    for step, summary in _scripted_stream():
      assert ours.observe(step, summary) == theirs.observe(step, summary)
      assert ours.state_dict() == theirs.state_dict()
    snapshot = ours.snapshot()
    assert snapshot == theirs.snapshot()
    assert seen == snapshot["breaches"]
    assert snapshot["breaches_per_rule"] == {
        "grad_norm_drift": 1, "nonfinite_grads": 1,
        "priority_entropy_floor": 3, "sample_age_ceiling": 1}
    # The drift baseline froze on the spike and skipped the NaN.
    assert ours.state_dict()["drift"]["grad_norm_drift"][0] == 38

  def test_state_dict_round_trip_rearms_drift(self, needs_jax, tmp_path):
    theirs, ours = _monitors(tmp_path)
    stream = _scripted_stream()
    for step, summary in stream[:14]:
      ours.observe(step, summary)
      theirs.observe(step, summary)
    resumed = health.HealthMonitor(rules=health.default_rules(capacity=512))
    resumed.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    resumed.load_state_dict({"drift": {"unknown_rule": [1, 0.0, 0.0]}})
    step, summary = stream[14]  # the spike, caught with no re-warm-up
    assert (resumed.observe(step, summary) == theirs.observe(step, summary)
            != [])

  def test_halt_on_a_nonfinite_summary(self, needs_jax, tmp_path):
    theirs, ours = _monitors(tmp_path, halt_on_breach=True)
    snapshots = []
    summary = dict(_scripted_stream()[0][1], **{
        "health/nonfinite_targets": 3.0})
    with pytest.raises(jax_health.HealthHalt) as want:
      theirs.observe(1, summary)
    with pytest.raises(health.HealthHalt, match="nonfinite_targets") as got:
      ours.observe_with_snapshot(1, summary,
                                 snapshot_fn=lambda: snapshots.append(1))
    assert got.value.breaches == want.value.breaches
    assert got.value.step == 1 and snapshots == [1]
    # A failing callback or snapshot never stops the loop.
    quiet = health.HealthMonitor(on_breach=lambda b: 1 / 0)
    assert quiet.observe_with_snapshot(
        2, summary, snapshot_fn=lambda: 1 / 0)[0]["rule"] == (
            "nonfinite_targets")

  def test_refusals_and_validation(self, tmp_path):
    # The registry and recorder hooks (they refused until the obs spine
    # was ported): a breach counts into health/breaches and
    # health/breaches/<rule> and dumps a health_breach carrying the bound
    # step id; the loop's summary gauges of the same names still set.
    registry = MetricRegistry()
    recorder = FlightRecorder(dump_dir=str(tmp_path))
    monitor = health.HealthMonitor(registry=registry, recorder=recorder)
    summary = dict(_scripted_stream()[0][1], **{
        "health/nonfinite_targets": 2.0})
    with bind(step_id=7):
      (breach,) = monitor.observe(7, summary)
    assert registry.snapshot() == {
        "health/breaches": 1, "health/breaches/nonfinite_targets": 1}
    registry.set_gauges(monitor.last_summary)
    assert registry.snapshot()["health/nonfinite_targets"] == 2.0
    (dump,) = os.listdir(tmp_path)
    with open(tmp_path / dump) as f:
      payload = json.load(f)
    assert payload["reason"] == "health_breach"
    assert payload["trigger"] == {
        "rule": "nonfinite_targets", "metric": "health/nonfinite_targets",
        "value": 2.0, "step": 7, "threshold": breach["threshold"],
        "step_id": 7}
    with pytest.raises(ValueError, match="unknown rule kind"):
      health.HealthRule("r", "m", kind="median")
    with pytest.raises(ValueError, match="duplicate rule names"):
      health.HealthMonitor(rules=[health.HealthRule("r", "m")] * 2)

  def test_tree_reductions_match_jax(self, needs_jax):
    rng = np.random.default_rng(3)
    tree = {
        "a": rng.standard_normal((17, 5)).astype(np.float32) * 30,
        "b": {"c": rng.standard_normal(7).astype(np.float32),
              "d": np.arange(4, dtype=np.int32)},
    }
    tree["b"]["c"][[1, 4]] = [np.nan, np.inf]
    ours = {"a": torch.from_numpy(tree["a"]),
            "b": {"c": torch.from_numpy(tree["b"]["c"]),
                  "d": torch.from_numpy(tree["b"]["d"])}}
    assert float(health.tree_nonfinite_count(ours)) == float(
        jax_health.tree_nonfinite_count(tree)) == 2.0
    finite = {"a": ours["a"], "d": ours["b"]["d"]}
    got = health.tree_global_norm(finite)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        float(got), float(jax_health.tree_global_norm(
            {"a": tree["a"], "d": tree["b"]["d"]})), rtol=REDUCTION_RTOL)
    half = {"h": torch.full((3,), 2.0, dtype=torch.bfloat16)}
    assert float(health.tree_global_norm(half)) == pytest.approx(
        math.sqrt(12.0))
    assert float(health.tree_nonfinite_count({})) == 0.0


# --- the train step's health reductions -------------------------------------


def _bridged_trainers(lr=3e-3, size=16, batch_size=8):
  jax_model = jax_smoke.TinyQCriticModel(
      image_size=size, optimizer_fn=lambda: optax.adam(lr))
  model = smoke.TinyQCriticModel(
      image_size=size, optimizer_fn=optimizers.create_adam_optimizer(lr))
  jax_trainer = JaxTrainer(
      jax_model, mesh=jax_mesh.create_mesh(devices=jax.devices()[:1]),
      seed=0)
  jax_state = jax_trainer.create_train_state(batch_size=batch_size)
  initial = jax.device_get(jax_state.variables())
  return jax_trainer, jax_state, model, initial


def _batch(seed, size=16, n=8):
  rng = np.random.default_rng(seed)
  features = {"image": rng.integers(0, 256, (n, size, size, 3), np.uint8),
              "action": rng.uniform(-1, 1, (n, 4)).astype(np.float32)}
  return features, {"target_q": rng.random(n).astype(np.float32)}


def _torch_batch(features, labels):
  return ({k: torch.from_numpy(v) for k, v in features.items()},
          {k: torch.from_numpy(v) for k, v in labels.items()})


class TestTrainStepHealth:

  def test_grad_norm_matches_jax(self, needs_jax):
    jax_trainer, jax_state, model, initial = _bridged_trainers()
    step_fn = jax.jit(jax_trainer.train_step_fn(with_health=True))
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(initial)
    for seed in range(3):
      features, labels = _batch(seed)
      jax_state, want = step_fn(jax_state, *jax_trainer.shard_batch(
          (features, labels)))
      state, got = trainer.train_step(state, *_torch_batch(features, labels),
                                      with_health=True)
      np.testing.assert_allclose(float(got["grad_norm"]),
                                 float(want["grad_norm"]), rtol=NORM_RTOL)
      assert float(got["grads_nonfinite"]) == float(
          want["grads_nonfinite"]) == 0.0
      assert got["grad_norm"].dtype == torch.float32

  def test_nonfinite_gradients_are_counted(self, needs_jax):
    jax_trainer, jax_state, model, initial = _bridged_trainers()
    features, labels = _batch(5)
    labels["target_q"][2] = np.nan
    _, want = jax.jit(jax_trainer.train_step_fn(with_health=True))(
        jax_state, *jax_trainer.shard_batch((features, labels)))
    trainer = Trainer(model, device="cpu")
    _, got = trainer.train_step(trainer.create_train_state(initial),
                                *_torch_batch(features, labels),
                                with_health=True)
    assert float(got["grads_nonfinite"]) == float(want["grads_nonfinite"])
    assert float(got["grads_nonfinite"]) > 0

  def test_flag_off_changes_nothing(self):
    model = smoke.TinyQCriticModel(
        optimizer_fn=optimizers.create_adam_optimizer(3e-3))
    states, metrics = [], []
    for with_health in (False, True):
      trainer = Trainer(model, device="cpu")
      state = trainer.create_train_state()
      for seed in range(3):
        state, m = trainer.train_step(state, *_torch_batch(*_batch(seed)),
                                      with_health=with_health)
      states.append(state)
      metrics.append(m)
    assert set(metrics[1]) - set(metrics[0]) == {"grad_norm",
                                                 "grads_nonfinite"}
    for key, value in metrics[0].items():
      assert torch.equal(value, metrics[1][key]), key
    for name, param in states[0].params.items():
      assert torch.equal(param, states[1].params[name]), name
      for moment, value in states[0].opt_state.state[param].items():
        assert torch.equal(
            value, states[1].opt_state.state[states[1].params[name]][moment])


# --- the closed loop --------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_results(tmp_path_factory):
  """ONE 300-step closed-loop smoke shared by the acceptance checks."""
  logdir = str(tmp_path_factory.mktemp("replay_smoke"))
  return run_qtopt_replay.run(steps=300, smoke=True, logdir=logdir, seed=0,
                              device="cpu"), logdir


class TestClosedLoopSmoke:

  def test_td_error_reduction_meets_bar(self, smoke_results):
    results, _ = smoke_results
    assert results["eval_td_reduction"] >= SMOKE_BAR, results["eval_history"]
    assert (results["final_eval"]["eval_q_loss"]
            < results["initial_eval"]["eval_q_loss"])

  def test_every_program_built_exactly_once(self, smoke_results):
    results, _ = smoke_results
    ledger = results["compile_counts"]
    assert ledger == {"train_step": 1, "health_summary": 1,
                      "bellman_targets": 1, "bellman_td_error": 1,
                      "cem_bucket_4": 1}

  def test_loop_actually_ran_off_policy(self, smoke_results):
    results, _ = smoke_results
    assert results["episodes_collected"] > 50
    assert results["param_refreshes"] >= 10
    assert results["buffer"]["replay/fill_fraction"] == 1.0
    stats = results["queue"]
    assert stats["enqueued"] == (stats["dropped"] + stats["dequeued"]
                                 + stats["pending"])
    assert results["steps"] == 300 and results["mode"] == "smoke"

  def test_health_block_is_clean(self, smoke_results):
    results, _ = smoke_results
    block = results["health"]
    assert block["breach_count"] == 0 and block["observations"] == 300
    assert block["last_summary"]["health/nonfinite_grads"] == 0.0
    assert block["last_summary"]["health/grad_norm"] > 0.0

  def test_metrics_flow_through_metric_writer(self, smoke_results):
    _, logdir = smoke_results
    seen = set()
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
      for line in f:
        seen.update(json.loads(line).keys())
    for key in ("replay/fill_fraction", "replay/sample_staleness",
                "replay/drop_rate", "replay/target_lag",
                "replay/priority_entropy", "replay/eval_td_error",
                "replay/train_loss", "health/grad_norm",
                "health/nonfinite_params", "health/sample_age"):
      assert key in seen, (key, sorted(seen))

  def test_result_keys_are_the_jax_keys_less_obs(self, needs_jax,
                                                 smoke_results):
    results, _ = smoke_results
    fake = types.SimpleNamespace(
        _obs_block=dict, health_monitor=None,
        queue=ingest.TransitionQueue(4),
        buffer=ring_buffer.ReplayBuffer(loop.transition_spec(8, 4), 8, 2),
        _collectors=[], config=jax_loop.ReplayLoopConfig(), logdir="")
    evals = {"eval_td_error": 1.0, "eval_q_loss": 1.0}
    want = set(jax_loop.ReplayTrainLoop._assemble_result(
        fake, 1, evals, [dict(step=1, **evals)], {}, 0))
    # The result carries the JAX "obs" block: the executable ledger's
    # attribution and the spans' trace_stage_counts.
    assert set(results) == want | {"mode", "metric"}
    assert set(results["obs"]) == {"attribution", "trace_stage_counts"}
    assert {"act", "extend", "learn", "replay"} <= set(
        results["obs"]["trace_stage_counts"])
    json.dumps(results)


class TestLoopPieces:

  @pytest.mark.parametrize("smoke_mode", [True, False])
  def test_build_config_is_the_jax_config(self, needs_jax, smoke_mode):
    got = dataclasses.asdict(run_qtopt_replay.build_config(smoke_mode, 3))
    want = dataclasses.asdict(jax_cli.build_config(smoke_mode, 3))
    assert got == want

  def test_cli_emits_one_json_line(self, tmp_path, capsys):
    out = tmp_path / "replay_smoke.json"
    run_qtopt_replay.main([
        "--smoke", "--steps", "40", "--device", "cpu", "--logdir",
        str(tmp_path / "logs"), "--out", str(out)])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    obj = json.loads(lines[0])
    assert obj["mode"] == "smoke" and "eval_td_reduction" in obj
    assert obj["steps"] == 40 and obj["health"]["breach_count"] == 0
    assert json.loads(out.read_text()) == obj

  @pytest.mark.parametrize("argv, item", [
      # --mesh runs over ranks (tests/test_torch_mesh_loop.py); a mesh
      # the ranks present do not fill refuses, as does a TP degree with
      # the keep-default DP.
      (["--mesh", "8"], r"needs 8 rank\(s\), have 1"),
      (["--mesh", "0,2"], "keep-default sentinel")])
  def test_cli_refuses_by_name(self, tmp_path, argv, item):
    with pytest.raises(ValueError, match=item):
      run_qtopt_replay.main(["--smoke", "--device", "cpu", "--logdir",
                             str(tmp_path), *argv])

  def test_cli_precision_bf16(self, tmp_path, capsys):
    """``--precision bf16``, once item 11's refusal: the host path's smoke
    labels and acts at bf16, its TD metric float32."""
    run_qtopt_replay.main([
        "--smoke", "--steps", "40", "--device", "cpu", "--precision",
        "bf16", "--logdir", str(tmp_path)])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    obj = json.loads(lines[-1])
    assert obj["precision"] == "bf16" and obj["steps"] == 40
    assert set(obj["compile_counts"].values()) == {1}
    assert np.isfinite(obj["final_eval"]["eval_td_error"])

  def test_health_halt_stops_the_loop(self, tmp_path, monkeypatch):
    """health_halt=True: a non-finite summary (here the parameters' count)
    halts the loop at its first step, and every collector thread is
    stopped. Non-finite targets would stop it one stage earlier, in the
    priority write, as in the JAX host loop."""
    monkeypatch.setattr(
        loop.ReplayTrainLoop, "_host_param_health",
        lambda self, state: {"health/nonfinite_params": 5.0,
                             "health/param_norm": 1.0})
    config = loop.ReplayLoopConfig(health_halt=True, capacity=64,
                                   min_fill=32, batch_size=8)
    replay = loop.ReplayTrainLoop(config, str(tmp_path),
                                  model=smoke.TinyQCriticModel(),
                                  device="cpu")
    with pytest.raises(health.HealthHalt, match="nonfinite_params") as e:
      replay.run(5)
    assert e.value.step == 1
    assert [b["rule"] for b in e.value.breaches] == ["nonfinite_params"]
    assert replay._collectors and not any(
        c._thread.is_alive() for c in replay._collectors)

  def test_loop_hooks_refuse_by_name(self, tmp_path):
    # fault_plan waits for item 15; the recorder and the watchdog reach
    # the loop's queue, health monitor and threads (their effects are
    # held by the obs tests' loop run).
    with pytest.raises(NotImplementedError, match="item 15"):
      loop.ReplayTrainLoop(loop.ReplayLoopConfig(), str(tmp_path),
                           model=smoke.TinyQCriticModel(), device="cpu",
                           fault_plan=object())
    recorder, watchdog = FlightRecorder(), Watchdog()
    replay = loop.ReplayTrainLoop(
        loop.ReplayLoopConfig(), str(tmp_path), model=smoke.TinyQCriticModel(),
        device="cpu", flight_recorder=recorder, watchdog=watchdog)
    assert replay.recorder is recorder and replay.watchdog is watchdog
    assert replay.queue._recorder is recorder
    assert replay.health_monitor._recorder is recorder
    assert loop.ReplayTrainLoop(
        loop.ReplayLoopConfig(), str(tmp_path / "own"),
        model=smoke.TinyQCriticModel(),
        device="cpu").recorder.dump_dir == str(tmp_path / "own")
    assert loop.ReplayLoopConfig(health_halt=True).health_halt
