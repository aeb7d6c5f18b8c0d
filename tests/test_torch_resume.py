"""The port's preemptible replay loop held against the JAX package.

A loop checkpoint is the train state's step directory plus a sidecar in
the JAX package's layout: a sidecar either package writes, the other
reads, with trees, flats and meta equal bit for bit. Validation rejects a
damaged step with its reason and the resume scan falls back to the older
step. The crash-resume parity harness (``serving/fault_bench.py``) holds
the JAX bar on the CPU: the resumed TD stream equals the uninterrupted
one bit for bit (delta 0.0) and the restored ring is bit-equal. A live
``ReplayTrainLoop`` stopped after its checkpoint at 10 resumes there and
keeps its step-0 eval baseline; a health breach lands as a checkpoint,
also at a cadence step; ``ProfilerHook`` writes one trace in its window.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  from tensor2robot_tpu.serving import fault_bench as jax_fault_bench
  from tensor2robot_tpu.train import checkpoints as jax_checkpoints
except ImportError:
  jax = None

from tensor2robot_tpu_torch.replay import loop, smoke  # noqa: E402
from tensor2robot_tpu_torch.serving import fault_bench  # noqa: E402
from tensor2robot_tpu_torch.train import checkpoints  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers, profiling  # noqa: E402


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _sidecar_contents():
  rng = np.random.default_rng(0)
  trees = {"target": {"params": {
      "Dense_0": {"kernel": rng.standard_normal((3, 2)).astype(np.float32),
                  "bias": np.zeros(2, np.float32)}},
      "batch_stats": {"count": np.arange(4, dtype=np.int32)}}}
  flats = {"buffer": {
      "storage/image": rng.integers(0, 255, (4, 6, 6, 3), np.uint8),
      "storage/reward": rng.random(4).astype(np.float32),
      "written_at": np.arange(4, dtype=np.int64)}}
  meta = {"target": {"refresh_count": 2, "last_refresh_step": 10},
          "next_label_seed": 320,
          "rng_state": {"state": {"state": 2**100 + 7, "inc": 3}}}
  return trees, flats, meta


def _leaves(tree, prefix=""):
  out = {}
  for key, value in tree.items():
    path = f"{prefix}/{key}" if prefix else key
    if isinstance(value, dict):
      out.update(_leaves(value, path))
    else:
      out[path] = np.asarray(value)
  return out


def _assert_sidecars_equal(got, want):
  got_trees, got_flats, got_meta = got
  want_trees, want_flats, want_meta = want
  assert got_meta == want_meta
  assert set(got_trees) == set(want_trees)
  for name in want_trees:
    got_leaves, want_leaves = (_leaves(got_trees[name]),
                               _leaves(want_trees[name]))
    assert set(got_leaves) == set(want_leaves)
    for key, value in want_leaves.items():
      assert got_leaves[key].dtype == value.dtype, key
      np.testing.assert_array_equal(got_leaves[key], value)
  assert set(got_flats) == set(want_flats)
  for name in want_flats:
    assert set(got_flats[name]) == set(want_flats[name])
    for key, value in want_flats[name].items():
      assert got_flats[name][key].dtype == value.dtype
      np.testing.assert_array_equal(got_flats[name][key], value)


def _state(seed=0):
  model = smoke.TinyQCriticModel(
      optimizer_fn=optimizers.create_adam_optimizer(3e-3))
  return Trainer(model, seed=seed, device="cpu").create_train_state()


def _complete_step(root, step, state):
  """A valid loop checkpoint at `step`: state.pt, then its sidecar."""
  checkpoints.CheckpointManager(root, max_to_keep=10).save(step, state)
  checkpoints.save_sidecar(root, step, trees={"target": {"w": np.ones(2)}},
                           flats={"buffer": {"storage/x": np.arange(3)}},
                           meta={"x": step})


# --- the sidecar -------------------------------------------------------------


class TestSidecar:

  def test_jax_sidecar_loads_in_the_port(self, needs_jax, tmp_path):
    trees, flats, meta = _sidecar_contents()
    jax_checkpoints.save_sidecar(str(tmp_path), 7, trees=trees, flats=flats,
                                 meta=meta)
    want = jax_checkpoints.load_sidecar(str(tmp_path), 7)
    _assert_sidecars_equal(checkpoints.load_sidecar(str(tmp_path), 7), want)

  def test_port_sidecar_loads_in_jax(self, needs_jax, tmp_path):
    trees, flats, meta = _sidecar_contents()
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    checkpoints.save_sidecar(str(ours), 7, trees=trees, flats=flats,
                             meta=meta)
    jax_checkpoints.save_sidecar(str(theirs), 7, trees=trees, flats=flats,
                                 meta=meta)
    _assert_sidecars_equal(jax_checkpoints.load_sidecar(str(ours), 7),
                           checkpoints.load_sidecar(str(ours), 7))
    # The same layout: the same files, the same meta.json text.
    port_dir = checkpoints.sidecar_dir(str(ours), 7)
    jax_dir = jax_checkpoints.sidecar_dir(str(theirs), 7)
    assert os.path.basename(port_dir) == os.path.basename(jax_dir)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    with open(os.path.join(port_dir, checkpoints.SIDECAR_META)) as f:
      port_meta = f.read()
    with open(os.path.join(jax_dir, jax_checkpoints.SIDECAR_META)) as f:
      assert port_meta == f.read()

  def test_colliding_names_refused(self, tmp_path):
    with pytest.raises(ValueError, match="collide"):
      checkpoints.save_sidecar(str(tmp_path), 1, trees={"a": {"w": 1.0}},
                               flats={"a": {"x": np.zeros(1)}})


# --- validation and the resume scan ------------------------------------------


def _remove_step_dir(root):
  import shutil
  shutil.rmtree(os.path.join(root, "20"))


def _remove_state(root):
  os.remove(os.path.join(root, "20", checkpoints.STATE_FILE))


def _truncate_state(root):
  path = os.path.join(root, "20", checkpoints.STATE_FILE)
  with open(path, "rb+") as f:
    f.truncate(os.path.getsize(path) // 2)


def _remove_sidecar(root):
  import shutil
  shutil.rmtree(checkpoints.sidecar_dir(root, 20))


def _truncate_buffer(root):
  # tests/test_faults.py's damage: half of one npz, so its CRC read fails.
  npz = os.path.join(checkpoints.sidecar_dir(root, 20), "buffer.npz")
  with open(npz, "rb+") as f:
    f.truncate(os.path.getsize(npz) // 2)


def _mismatch_step(root):
  path = os.path.join(checkpoints.sidecar_dir(root, 20),
                      checkpoints.SIDECAR_META)
  with open(path) as f:
    meta = json.load(f)
  meta["step"] = 21
  with open(path, "w") as f:
    json.dump(meta, f)


class TestValidation:

  @pytest.mark.parametrize("damage, reason", [
      (_remove_step_dir, "step dir missing"),
      (_remove_state, "state.pt missing"),
      (_truncate_state, "state.pt unreadable"),
      (_remove_sidecar, "sidecar missing"),
      (_truncate_buffer, "sidecar unreadable"),
      (_mismatch_step, "sidecar step 21 != dir step 20"),
  ])
  def test_damaged_step_rejected_and_older_step_resumes(
      self, tmp_path, damage, reason):
    root = str(tmp_path)
    state = _state()
    _complete_step(root, 10, state)
    _complete_step(root, 20, state)
    assert checkpoints.validate_checkpoint_dir(root, 20) == (True, "ok")
    assert checkpoints.latest_resumable_step(root) == 20
    damage(root)
    if damage is _remove_step_dir:
      # A sidecar whose step is gone is no step to resume.
      assert checkpoints.list_checkpoint_steps(root) == [10]
    ok, why = checkpoints.validate_checkpoint_dir(root, 20)
    assert not ok and reason in why, why
    assert checkpoints.latest_resumable_step(root) == 10

  def test_incomplete_step_is_listed_and_rejection_logged(self, tmp_path,
                                                          caplog):
    root = str(tmp_path)
    _complete_step(root, 10, _state())
    os.makedirs(os.path.join(root, "30"))  # a step cut before state.pt
    os.makedirs(os.path.join(root, ".tmp-40-1"))  # a save in progress
    assert checkpoints.list_checkpoint_steps(root) == [10, 30]
    triggers = []

    class Recorder:
      def trigger(self, reason, **fields):
        triggers.append((reason, fields["step"]))

    with caplog.at_level(logging.WARNING):
      assert checkpoints.latest_resumable_step(root, Recorder()) == 10
    assert triggers == [("checkpoint_rejected", 30)]
    assert "step 30" in caplog.text and "state.pt missing" in caplog.text

  def test_prune_sidecars_follows_all_steps(self, tmp_path):
    root = str(tmp_path)
    manager = checkpoints.CheckpointManager(root, max_to_keep=2)
    state = _state()
    for step in (5, 10, 15):
      manager.save(step, state)
      checkpoints.save_sidecar(root, step, meta={})
    checkpoints.prune_sidecars(root, manager.all_steps())
    assert manager.all_steps() == [10, 15]
    assert sorted(e for e in os.listdir(root)
                  if e.startswith(checkpoints.SIDECAR_PREFIX)) == [
                      "sidecar-10", "sidecar-15"]
    assert checkpoints.latest_resumable_step(root) == 15

  def test_restore_keeps_held_adam_tensors(self, tmp_path):
    """optimizers.load_state gives the saved moments and step count, in
    the tensors the optimizer already held (a graph may have captured
    them)."""
    model = smoke.TinyQCriticModel(
        optimizer_fn=optimizers.create_adam_optimizer(3e-3))
    trainer = Trainer(model, seed=0, device="cpu")
    features = {"image": torch.zeros((4, 16, 16, 3), dtype=torch.uint8),
                "action": torch.zeros((4, 4))}

    def trained(target):
      return trainer.train_step(trainer.create_train_state(), features,
                                {"target_q": torch.full((4,), target)})[0]

    state = trained(0.5)
    manager = checkpoints.CheckpointManager(str(tmp_path))
    manager.save(1, state)
    other = trained(0.0)
    held = {key: dict(other.opt_state.state[param])
            for key, param in other.params.items()}
    restored = manager.restore(other)
    for key, param in restored.params.items():
      torch.testing.assert_close(param, state.params[key], rtol=0, atol=0)
      mine = restored.opt_state.state[param]
      want = state.opt_state.state[state.params[key]]
      for name in ("exp_avg", "exp_avg_sq", "step"):
        assert mine[name] is held[key][name]
        torch.testing.assert_close(mine[name], want[name], rtol=0, atol=0)


# --- the crash-resume parity harness -----------------------------------------


class TestResumeParity:

  def test_fixed_stream_is_the_jax_stream(self, needs_jax):
    want = jax_fault_bench._fixed_stream(64, 16, 4, 0.4, 0.8, 3)
    got = fault_bench._fixed_stream(64, 16, 4, 0.4, 0.8, 3)
    assert set(got) == set(want)
    for key, value in want.items():
      assert got[key].dtype == value.dtype
      np.testing.assert_array_equal(got[key], value)

  def test_resume_parity_bit_exact(self):
    parity = fault_bench._measure_resume_parity(6, 6, seed=0, device="cpu")
    assert parity["restored_step"] == 6
    assert parity["buffer_bit_equal"] is True
    assert parity["pre_crash_stream_bit_equal"] is True
    assert parity["post_resume_stream_bit_equal"] is True
    assert parity["max_post_resume_td_delta"] == 0.0
    assert parity["parity_ok"] is True


# --- the live loop ------------------------------------------------------------


class _Stop(Exception):
  pass


def _make_loop(logdir, **fields):
  config = loop.ReplayLoopConfig(seed=0, eval_every=10, **fields)
  model = smoke.TinyQCriticModel(
      image_size=config.image_size, action_size=config.action_size,
      optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
  return loop.ReplayTrainLoop(config, logdir, model=model, device="cpu")


def _stop_at(replay, stop_step):
  """The port has no fault plan (item 15): stop the loop after its step
  `stop_step`, where the JAX test's injected crash lands."""

  def profile_step(hook, step, final=False):
    if step == stop_step and not final:
      raise _Stop()

  replay._profile_step = profile_step
  return replay


@pytest.fixture(scope="module")
def live_resume(tmp_path_factory):
  logdir = str(tmp_path_factory.mktemp("live_resume"))
  first = _stop_at(_make_loop(logdir, checkpoint_every=10), 15)
  with pytest.raises(_Stop):
    first.run(30)
  root = os.path.join(logdir, "checkpoints")
  steps_after_crash = checkpoints.list_checkpoint_steps(root)
  _, _, meta = checkpoints.load_sidecar(root, 10)
  result = _make_loop(logdir, checkpoint_every=10, resume=True).run(30)
  return {"steps_after_crash": steps_after_crash, "meta": meta,
          "result": result, "root": root}


class TestLiveResume:

  def test_resumes_at_the_checkpoint_and_continues_the_eval(self,
                                                           live_resume):
    assert live_resume["steps_after_crash"] == [10]
    result = live_resume["result"]
    assert result["steps"] == 30
    # Steps 0 and 10 come from the interrupted run (its checkpoint at 10),
    # 20 and 30 from the resumed run.
    assert [e["step"] for e in result["eval_history"]] == [0, 10, 20, 30]
    assert result["eval_history"][:2] == live_resume["meta"]["eval_history"]

  def test_keeps_the_step_zero_baseline(self, live_resume):
    result = live_resume["result"]
    assert result["initial_eval"] == live_resume["meta"]["initial_eval"]
    assert result["eval_history"][0] == dict(
        step=0, **live_resume["meta"]["initial_eval"])

  def test_every_program_built_once(self, live_resume):
    counts = live_resume["result"]["compile_counts"]
    assert all(v == 1 for v in counts.values()), counts
    assert checkpoints.list_checkpoint_steps(live_resume["root"]) == [
        10, 20, 30]

  def test_resume_on_an_empty_dir_starts_fresh(self, tmp_path):
    result = _make_loop(str(tmp_path), resume=True).run(10)
    assert result["steps"] == 10
    assert [e["step"] for e in result["eval_history"]] == [0, 10]

  def test_changed_batch_size_refused_by_the_fingerprint(self, tmp_path):
    _make_loop(str(tmp_path), checkpoint_every=5).run(5)
    changed = _make_loop(str(tmp_path), checkpoint_every=5, resume=True,
                         batch_size=16)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
      changed.run(10)

  def test_health_drift_baselines_survive_a_resume(self, tmp_path):
    _make_loop(str(tmp_path), checkpoint_every=10).run(10)
    _, _, meta = checkpoints.load_sidecar(
        os.path.join(str(tmp_path), "checkpoints"), 10)
    assert meta["health"]["observations"] == 10
    resumed = _make_loop(str(tmp_path), checkpoint_every=10, resume=True)
    state, _, _ = resumed._restore_checkpoint(
        resumed.trainer.create_train_state())
    assert state.step == 10
    assert resumed.health_monitor.state_dict() == meta["health"]

  @pytest.mark.parametrize("breach_step", [7, 10])
  def test_breach_snapshot_lands_as_a_checkpoint(self, tmp_path, monkeypatch,
                                                 breach_step):
    """A health breach saves the breaching step. At 10, a cadence step,
    the snapshot and then the cadence save meet at one step: the loop
    keeps the snapshot's state and rewrites its sidecar (the JAX loop's
    orbax manager raises StepAlreadyExistsError there)."""
    real = loop.ReplayTrainLoop._host_param_health

    def health(self, state):
      out = real(self, state)
      if state.step == breach_step:
        out["health/nonfinite_params"] = 3.0
      return out

    monkeypatch.setattr(loop.ReplayTrainLoop, "_host_param_health", health)
    result = _make_loop(str(tmp_path), checkpoint_every=10).run(12)
    assert result["health"]["breach_count"] == 1
    root = os.path.join(str(tmp_path), "checkpoints")
    assert checkpoints.list_checkpoint_steps(root) == sorted(
        {breach_step, 10})
    assert checkpoints.latest_resumable_step(root) == 10
    _, _, meta = checkpoints.load_sidecar(root, 10)
    # The cadence save's sidecar: the eval history includes step 10.
    assert [e["step"] for e in meta["eval_history"]] == [0, 10]
    assert checkpoints.validate_checkpoint_dir(root, breach_step)[0]


# --- the profiler window -------------------------------------------------------


class TestProfiler:

  def test_hook_writes_one_trace_in_its_window(self, tmp_path):
    log_dir = str(tmp_path / "profile")
    hook = profiling.ProfilerHook(start_step=2, end_step=4, log_dir=log_dir,
                                  device="cpu")
    x = torch.ones(8)
    for step in range(1, 7):
      x = x * 2
      hook.after_step(types_step(step), {})
      if step == 3:
        assert profiling.trace_active()
        # A second window while this one is open skips, not raises.
        assert profiling.start_trace(str(tmp_path / "second"), "cpu") is False
    hook.end(types_step(6))
    assert not profiling.trace_active()
    traces = os.listdir(log_dir)
    assert len(traces) == 1 and traces[0].startswith(profiling.TRACE_PREFIX)
    with open(os.path.join(log_dir, traces[0])) as f:
      assert json.load(f)["traceEvents"]
    assert not os.path.exists(tmp_path / "second" / traces[0])

  def test_end_closes_an_open_window_and_a_missed_one_warns(self, tmp_path,
                                                           caplog):
    hook = profiling.ProfilerHook(start_step=1, end_step=100,
                                  log_dir=str(tmp_path / "open"),
                                  device="cpu")
    hook.after_step(types_step(1), {})
    hook.end(types_step(3))
    assert len(os.listdir(tmp_path / "open")) == 1
    assert profiling.stop_trace() is None
    missed = profiling.ProfilerHook(start_step=50, end_step=60,
                                    log_dir=str(tmp_path / "missed"),
                                    device="cpu")
    with caplog.at_level(logging.WARNING):
      missed.after_step(types_step(3), {})
      missed.end(types_step(3))
    assert "never started" in caplog.text
    assert not os.path.exists(tmp_path / "missed")
    with pytest.raises(ValueError, match="must be >"):
      profiling.ProfilerHook(start_step=5, end_step=5)

  def test_loop_profile_window(self, tmp_path):
    replay = _make_loop(str(tmp_path), profile_window=(3, 5))
    assert replay.run(6)["steps"] == 6
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and not profiling.trace_active()


def types_step(step):
  return dataclasses.make_dataclass("Step", ["step"])(step)
