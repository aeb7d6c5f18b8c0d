"""The port's vector actor fleet held against the JAX package.

Driven by the same deterministic numpy policy at the same seed, the
port's ``VectorActor`` queues the JAX actor's chunks (image, action,
reward, done, next_image), episodes and successes bit for bit, one
fixed-size ``put_batch`` a step. ``ActorFleet`` splits its envs evenly
and sums its actors' accounts. Over TinyQ's ``CEMFleetPolicy`` the pinned
bucket is built once across three hot reloads. One module-scoped
``run_qtopt_replay --smoke --vector-actors`` on the CPU holds the JAX
smoke's checks (``tests/test_actor.py``): the eval TD reduction bar of
0.30, one acting bucket, every program built once, and the
``actor_throughput`` block with the JAX keys (its overlap phase: the
megastep learner beside a fresh fleet).
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  from tensor2robot_tpu.bin import run_qtopt_replay as jax_cli
  from tensor2robot_tpu.replay import actor as jax_actor
except ImportError:
  jax = None

from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.obs.flight_recorder import (  # noqa: E402
    FlightRecorder,
)
from tensor2robot_tpu_torch.obs.watchdog import Watchdog  # noqa: E402
from tensor2robot_tpu_torch.replay import actor, ingest, loop  # noqa: E402
from tensor2robot_tpu_torch.replay import learner_bench  # noqa: E402
from tensor2robot_tpu_torch.replay import smoke  # noqa: E402
from tensor2robot_tpu_torch.serving import BucketLadder  # noqa: E402
from tensor2robot_tpu_torch.serving import CEMFleetPolicy  # noqa: E402
from tensor2robot_tpu_torch.utils import profiling  # noqa: E402

IMG = 12  # tiny scenes for the structural tests
SMOKE_BAR = 0.30  # the JAX smoke's eval TD reduction bar
# The JAX actor_throughput block's keys (tensor2robot_tpu/replay/
# actor_bench.py).
BENCH_KEYS = {"num_envs", "scalar_collectors", "envs_per_collector",
              "window_s", "trials", "scalar_threads", "vector_actor",
              "speedup", "overlap", "compile_counts", "note"}


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _mean_policy(images):
  """A deterministic batched policy: actions from each image's mean."""
  means = np.asarray(images, np.float32).mean(axis=(1, 2, 3)) / 255.0
  return np.stack([np.cos(7 * means), np.sin(7 * means),
                   np.zeros_like(means), means], -1).astype(np.float32)


class _RecordingQueue:
  """Records every put_batch chunk (the actors' only queue call)."""

  def __init__(self):
    self.chunks = []

  def put_batch(self, batch, provenance="synthetic"):
    del provenance
    self.chunks.append({k: np.array(v) for k, v in batch.items()})
    return len(batch["image"])


class _CountingPolicy:

  def __init__(self):
    self.calls = []

  def __call__(self, images):
    self.calls.append(len(images))
    return np.zeros((len(images), 4), np.float32)


def _actor(policy, queue, num_envs=8, seed=0, **kwargs):
  worker = actor.VectorActor(policy, queue, IMG, num_envs=num_envs,
                             max_attempts=3, seed=seed, grasp_radius=0.4,
                             **kwargs)
  worker.reset()
  return worker


class TestVectorActor:

  @pytest.mark.parametrize("seed", [0, 3])
  def test_bit_identical_to_the_jax_actor(self, needs_jax, seed):
    ours, theirs = _RecordingQueue(), _RecordingQueue()
    port = _actor(_mean_policy, ours, seed=seed,
                  exploration_epsilon=0.25, scripted_fraction=0.25)
    ref = jax_actor.VectorActor(_mean_policy, theirs, IMG, num_envs=8,
                                max_attempts=3, seed=seed, grasp_radius=0.4,
                                exploration_epsilon=0.25,
                                scripted_fraction=0.25)
    ref._env.reset([ref._scene_seed() for _ in range(8)])
    for _ in range(20):
      port.step_once()
      ref.step_once()
    assert len(ours.chunks) == len(theirs.chunks) == 20
    for got, want in zip(ours.chunks, theirs.chunks):
      assert set(got) == set(want)
      for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (port.episodes, port.successes, port.env_steps) == (
        ref.episodes, ref.successes, ref.env_steps)
    assert port.episodes > 20 and port.successes > 0

  def test_one_fixed_size_put_batch_a_step(self):
    policy = _CountingPolicy()
    queue = ingest.TransitionQueue(4096)
    calls = []
    put_batch = queue.put_batch

    def counted(batch, provenance="synthetic"):
      calls.append({k: np.asarray(v).shape for k, v in batch.items()})
      return put_batch(batch, provenance)

    queue.put_batch = counted
    worker = _actor(policy, queue)
    for _ in range(6):
      worker.step_once()
    # One fleet-wide policy call and ONE chunk of the fleet's size a step.
    assert policy.calls == [8] * 6
    assert calls == [{"image": (8, IMG, IMG, 3), "action": (8, 4),
                      "reward": (8,), "done": (8,),
                      "next_image": (8, IMG, IMG, 3)}] * 6
    assert worker.env_steps == 48 and queue.stats()["enqueued"] == 48
    batch = queue.drain_batch(max_items=8)
    assert batch["done"].dtype == np.float32
    assert worker.busy_seconds > 0.0

  def test_thread_runs_and_stops(self):
    worker = actor.VectorActor(_CountingPolicy(), ingest.TransitionQueue(64),
                               IMG, num_envs=4, max_attempts=3)
    worker.start()
    deadline = time.perf_counter() + 30.0
    while worker.env_steps < 8 and time.perf_counter() < deadline:
      time.sleep(0.01)
    worker.stop()
    assert worker.env_steps >= 8 and not worker._thread.is_alive()

  def test_a_dying_policy_surfaces_through_stop(self):
    def broken(images):
      raise ValueError("policy broke")

    worker = actor.VectorActor(broken, ingest.TransitionQueue(64), IMG,
                               num_envs=4)
    worker.start()
    assert worker.join(30.0)
    with pytest.raises(RuntimeError, match="actor died") as info:
      worker.stop()
    assert isinstance(info.value.__cause__, ValueError)

  @pytest.mark.parametrize("owner", ["VectorActor", "ActorFleet"])
  @pytest.mark.parametrize("hook", ["flight_recorder", "watchdog"])
  def test_obs_hooks_refuse_by_name(self, owner, hook, tmp_path):
    """The actors' obs hooks (they refused until the obs spine was
    ported), passed through the fleet to its actors: a live actor beats
    an act/vector_actor heartbeat, unregistered when it stops; a dying
    one dumps the recorder."""
    def broken(images):
      raise ValueError("policy broke")

    watchdog = Watchdog()
    recorder = FlightRecorder(dump_dir=str(tmp_path))
    hooks = {"flight_recorder": recorder, "watchdog": watchdog}
    policy = learner_bench.uniform_policy(4, 0) if hook == "watchdog" \
        else broken
    if owner == "VectorActor":
      worker = actor.VectorActor(policy, ingest.TransitionQueue(10_000),
                                 IMG, num_envs=4, **{hook: hooks[hook]})
    else:
      worker = actor.ActorFleet(policy, ingest.TransitionQueue(10_000), IMG,
                                total_envs=4, **{hook: hooks[hook]})
    worker.start()
    if hook == "watchdog":
      deadline = time.monotonic() + 60
      while (not watchdog.snapshot()["components"].get(
          "act/vector_actor", {}).get("beats")) and time.monotonic() < deadline:
        time.sleep(0.01)
      assert watchdog.snapshot()["components"]["act/vector_actor"][
          "beats"] > 0
      worker.stop()
      assert watchdog.snapshot()["components"] == {}
      return
    with pytest.raises(RuntimeError, match="actor"):
      worker.stop()
    (dump,) = os.listdir(tmp_path)
    with open(tmp_path / dump) as f:
      payload = json.load(f)
    assert payload["reason"] == "actor_thread_exception"
    assert payload["trigger"]["error"] == "ValueError: policy broke"

  def test_one_bucket_across_three_hot_reloads(self):
    model = smoke.TinyQCriticModel(image_size=IMG)
    predictor = loop._HotReloadPredictor(
        model, model.init_variables(torch.Generator().manual_seed(0),
                                    device="cpu"))
    policy = CEMFleetPolicy(predictor, action_size=4, num_samples=8,
                            num_elites=2, iterations=2, seed=7,
                            ladder=BucketLadder((4,)))
    queue = ingest.TransitionQueue(4096)
    worker = _actor(policy, queue, num_envs=4)
    worker.step_once()
    for reload in range(1, 4):
      predictor.update(model.init_variables(
          torch.Generator().manual_seed(reload), device="cpu"))
      worker.step_once()
    assert policy.compile_counts == {4: 1}
    assert predictor.model_version == 3
    assert queue.stats()["enqueued"] == 16


class TestActorFleet:

  def test_splits_the_envs(self):
    fleet = actor.ActorFleet(_CountingPolicy(), ingest.TransitionQueue(64),
                             IMG, total_envs=8, num_actors=2, seed=5)
    assert [a.num_envs for a in fleet.actors] == [4, 4]
    # Each actor draws from its own stream, seed + i.
    assert [a._seed for a in fleet.actors] == [5, 6]

  @pytest.mark.parametrize("total_envs, num_actors", [(7, 2), (8, 0)])
  def test_refuses_an_uneven_split(self, total_envs, num_actors):
    with pytest.raises(ValueError, match="split evenly"):
      actor.ActorFleet(_CountingPolicy(), ingest.TransitionQueue(64), IMG,
                       total_envs=total_envs, num_actors=num_actors)

  def test_sums_its_accounts(self):
    fleet = actor.ActorFleet(_mean_policy, ingest.TransitionQueue(4096), IMG,
                             total_envs=8, num_actors=2, max_attempts=3,
                             grasp_radius=0.4)
    for worker in fleet.actors:
      worker.reset()
      for _ in range(5):
        worker.step_once()
    assert fleet.env_steps == 40
    assert fleet.episodes == sum(a.episodes for a in fleet.actors) > 0
    assert fleet.successes == sum(a.successes for a in fleet.actors)
    assert fleet.busy_seconds() == pytest.approx(
        sum(a.busy_seconds for a in fleet.actors))


# --- the CLI ---------------------------------------------------------------


class TestCLI:

  @pytest.mark.parametrize("spec, want", [
      (None, None), ("5,8", (5, 8)), ("0,1", (0, 1))])
  def test_parse_profile(self, spec, want):
    assert run_qtopt_replay.parse_profile(spec) == want

  @pytest.mark.parametrize("spec", ["5", "a,b", "8,5", "-1,3"])
  def test_parse_profile_refuses(self, spec):
    with pytest.raises(ValueError, match="--profile"):
      run_qtopt_replay.parse_profile(spec)

  @pytest.mark.parametrize("smoke_mode", [True, False])
  def test_build_config_passes_the_options_as_jax(self, needs_jax,
                                                  smoke_mode):
    got = run_qtopt_replay.build_config(smoke_mode, 3, vector_actors=True,
                                        profile_window=(5, 8))
    want = jax_cli.build_config(smoke_mode, 3, vector_actors=True,
                                profile_window=(5, 8))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)

  def test_vector_actors_and_profile_print_one_json_line(self, tmp_path,
                                                         capsys):
    logdir = tmp_path / "logs"
    run_qtopt_replay.main([
        "--smoke", "--steps", "12", "--device", "cpu", "--vector-actors",
        "--no-actor-bench", "--profile", "5,8", "--logdir", str(logdir)])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    obj = json.loads(lines[0])
    assert obj["vector_actors"] is True and obj["steps"] == 12
    assert "actor_throughput" not in obj
    assert [k for k in obj["compile_counts"]
            if k.startswith("cem_bucket")] == ["cem_bucket_4"]
    traces = os.listdir(logdir / "profile")
    assert len(traces) == 1 and traces[0].startswith(profiling.TRACE_PREFIX)


# --- the vector-actor smoke ------------------------------------------------


@pytest.fixture(scope="module")
def vector_smoke(tmp_path_factory):
  """ONE --vector-actors smoke with its actor bench, shared by the
  acceptance checks (the JAX smoke's protocol on the host path)."""
  logdir = str(tmp_path_factory.mktemp("vector_smoke"))
  results = run_qtopt_replay.run(300, smoke=True, logdir=logdir, seed=0,
                                 device="cpu", vector_actors=True)
  json.dumps(results)
  return results


class TestVectorSmoke:

  def test_td_reduction_meets_bar(self, vector_smoke):
    assert vector_smoke["vector_actors"] is True
    assert vector_smoke["eval_td_reduction"] >= SMOKE_BAR, (
        vector_smoke["eval_history"])

  def test_one_acting_bucket_every_program_built_once(self, vector_smoke):
    ledger = vector_smoke["compile_counts"]
    assert [k for k in ledger if k.startswith("cem_bucket_")] == [
        "cem_bucket_4"]
    assert all(v == 1 for v in ledger.values()), ledger
    # Ten hot reloads (refresh_every 15 over 300 steps) against that one.
    assert vector_smoke["param_refreshes"] >= 10

  def test_collection_actually_vectorized(self, vector_smoke):
    assert vector_smoke["episodes_collected"] > 50
    assert vector_smoke["env_steps_collected"] % 4 == 0
    stats = vector_smoke["queue"]
    assert stats["enqueued"] == (stats["dropped"] + stats["dequeued"]
                                 + stats["pending"])

  def test_actor_throughput_block_has_the_jax_keys(self, vector_smoke):
    block = vector_smoke["actor_throughput"]
    assert set(block) == BENCH_KEYS
    for path, keys in (
        ("scalar_threads", ("env_steps_per_sec", "transitions_per_sec")),
        ("vector_actor", ("env_steps_per_sec", "transitions_per_sec")),
        ("overlap", ("acting_learning_overlap_fraction",
                     "learner_steps_per_sec_while_acting"))):
      assert set(block[path]) == set(keys)
      for key in keys:
        spread = block[path][key]
        assert set(spread) == {"median", "min", "max", "trials"}
        assert spread["min"] > 0
    assert block["overlap"]["acting_learning_overlap_fraction"]["max"] <= 1
    assert set(block["speedup"]) == {"median", "min", "max", "trials"}
    assert block["compile_counts"] == {"scalar_cem_bucket_4": 1,
                                       "vector_cem_bucket_32": 1,
                                       "megastep": 1}
