"""The port's run directory and config CLI held against the JAX package.

On the CPU, at image 32 and batch 8: checkpoints round-trip bit for bit
and keep the JAX manager's save rule; a resumed ``train_eval_model`` run
ends bit for bit where an uninterrupted one does, saves the steps the JAX
loop saves and restarts its input stream as the JAX loop does; warm start
from a JAX-written ``variables.npz`` gives the JAX parameters; the metric
files match the JAX writer's; and ``pose_env_train.cfg`` parses, and runs
through each package's CLI, to the same bindings and operative config.
"""

import json
import logging
import os
import shutil
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
torch.set_num_threads(1)

import jax  # noqa: E402
from tensorboard.compat.proto import event_pb2  # noqa: E402

from tensor2robot_tpu import config as jax_config  # noqa: E402
from tensor2robot_tpu.bin import run_t2r_trainer as jax_cli  # noqa: E402
from tensor2robot_tpu.data import (  # noqa: E402
    default_input_generator as jax_generators,
    tfrecord as jax_tfrecord,
)
from tensor2robot_tpu.export import variables_io as jax_variables_io  # noqa: E402
from tensor2robot_tpu.research.pose_env import (  # noqa: E402
    pose_env_models as jax_models,
)
from tensor2robot_tpu.train import (  # noqa: E402
    checkpoints as jax_checkpoints,
    train_eval as jax_train_eval,
)
from tensor2robot_tpu.utils import metric_writer as jax_metric_writer  # noqa: E402
from tensor2robot_tpu.utils.mocks import MockT2RModel  # noqa: E402

from tensor2robot_tpu_torch import bridge, config  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.config import config as config_lib  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    default_input_generator as generators,
    tfrecord,
)
from tensor2robot_tpu_torch.data.abstract_input_generator import (  # noqa: E402
    AbstractInputGenerator,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    pose_env,
    pose_env_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.train import checkpoints, train_eval  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import metric_writer  # noqa: E402
from tensor2robot_tpu_torch.utils.optimizers import (  # noqa: E402
    create_adam_optimizer,
)

IMAGE, BATCH = 32, 8
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CFG = os.path.join(_REPO_ROOT, "tensor2robot_tpu", "research",
                       "pose_env", "configs", "pose_env_train.cfg")
PORT_CFG = os.path.join(_REPO_ROOT, "tensor2robot_tpu_torch", "research",
                        "pose_env", "configs", "pose_env_train.cfg")


@pytest.fixture(autouse=True)
def _clean_configs():
  """Bindings are process-wide in both packages: none leaks in or out."""
  config.clear_config()
  jax_config.clear_config()
  yield
  config.clear_config()
  jax_config.clear_config()


def _model(**kwargs):
  kwargs.setdefault("optimizer_fn", create_adam_optimizer(
      1e-3, boundaries_and_scales=[(8, 0.5)]))
  return pose_env_models.PoseEnvRegressionModel(
      image_size=IMAGE, compute_dtype=torch.float32,
      use_avg_model_params=True, avg_model_params_decay=0.9, **kwargs)


def _uint8_batch(seed=0):
  images, poses = pose_env.collect_episodes(BATCH, seed=seed,
                                            image_size=IMAGE)
  return (ts.TensorSpecStruct({"image": images}),
          ts.TensorSpecStruct({"target_pose": poses}))


class _ConstantGenerator(AbstractInputGenerator):
  """Hands out the same batch every step, so a restarted stream is the
  same stream."""

  def __init__(self, batch):
    super().__init__(batch_size=BATCH)
    self._batch = batch

  def _create_iterator(self, mode):
    features, labels = self._batch
    while True:
      yield (ts.TensorSpecStruct({k: v.copy() for k, v in features.items()}),
             ts.TensorSpecStruct({k: v.copy() for k, v in labels.items()}))


def _assert_states_equal(got, want):
  assert got.step == want.step
  for name in ("params", "model_state", "ema_params"):
    a, b = getattr(got, name), getattr(want, name)
    assert list(a) == list(b)
    for key in b:
      torch.testing.assert_close(a[key], b[key], rtol=0, atol=0,
                                 msg=f"{name}/{key}")
  got_opt, want_opt = got.opt_state.state_dict(), want.opt_state.state_dict()
  assert got_opt["param_groups"] == want_opt["param_groups"]
  for index, moments in want_opt["state"].items():
    for key, value in moments.items():
      torch.testing.assert_close(got_opt["state"][index][key], value,
                                 rtol=0, atol=0, msg=f"adam {index}/{key}")
  assert (got.opt_state.lr_schedule.state_dict()
          == want.opt_state.lr_schedule.state_dict())


def _trained_state(steps, seed=0):
  model = _model()
  trainer = Trainer(model, seed=seed, device="cpu")
  state = trainer.create_train_state()
  features, labels = model.preprocessor.preprocess(*_uint8_batch(), "train")
  batch = ({k: torch.from_numpy(v) for k, v in features.items()},
           {k: torch.from_numpy(v) for k, v in labels.items()})
  for _ in range(steps):
    state, _ = trainer.train_step(state, *batch)
  return trainer, state, batch


class TestCheckpointManager:

  def test_round_trip_bit_for_bit(self, tmp_path):
    trainer, state, batch = _trained_state(9)
    manager = checkpoints.CheckpointManager(str(tmp_path), max_to_keep=3)
    assert manager.save(9, state)
    fresh = Trainer(_model(), seed=1, device="cpu").create_train_state()
    restored = manager.restore(fresh)
    _assert_states_equal(restored, state)
    assert restored.opt_state.param_groups[0]["lr"] == pytest.approx(5e-4)
    # The restored optimizer drives the restored tensors: one more step on
    # each side stays bit for bit.
    state, _ = trainer.train_step(state, *batch)
    restored, _ = trainer.train_step(restored, *batch)
    _assert_states_equal(restored, state)
    payload = torch.load(os.path.join(str(tmp_path), "9", "state.pt"),
                         weights_only=True)
    assert set(payload) == {"step", "params", "batch_stats", "ema_params",
                            "optimizer", "schedule"}

  def test_keeps_the_newest(self, tmp_path):
    _, state, _ = _trained_state(1)
    manager = checkpoints.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
      manager.save(step, state)
    assert manager.all_steps() == [3, 4]
    with pytest.raises(ValueError, match="already exists"):
      manager.save(4, state)

  def test_leftover_temporary_is_never_latest(self, tmp_path):
    _, state, _ = _trained_state(1)
    manager = checkpoints.CheckpointManager(str(tmp_path))
    manager.save(2, state)
    (tmp_path / ".tmp-7-123").mkdir()
    torch.save({}, str(tmp_path / ".tmp-7-123" / "state.pt"))
    (tmp_path / "9").mkdir()  # a step directory with no state in it
    assert manager.latest_step() == 2
    assert manager.restore(
        Trainer(_model(), device="cpu").create_train_state()).step == 2

  def test_should_save_as_jax(self, tmp_path):
    table = [(step, last, interval)
             for interval in (0, 1, 3, 5)
             for step, last in ((0, None), (3, None), (5, None), (6, 5),
                                (7, 4), (10, 0), (4, 3), (9, 8))]
    for interval in (0, 1, 3, 5):
      port = checkpoints.CheckpointManager(str(tmp_path / f"p{interval}"),
                                           save_interval_steps=interval)
      reference = jax_checkpoints.CheckpointManager(
          str(tmp_path / f"j{interval}"), save_interval_steps=interval)
      for step, last, each in table:
        if each == interval:
          assert port.should_save(step, last) == reference.should_save(
              step, last), (step, last, interval)
      reference.close()


def _port_run(model_dir, steps, generator):
  return train_eval.train_eval_model(
      _model(), input_generator_train=generator, max_train_steps=steps,
      model_dir=model_dir, save_checkpoints_steps=3, log_every_steps=2,
      device="cpu")


class _RecordingRandom:
  """Mixes into a package's DefaultRandomInputGenerator: records each
  created stream's batches (as bytes of their first feature)."""

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    self.streams = []

  def _create_iterator(self, mode):
    stream = []
    self.streams.append(stream)
    for features, labels in super()._create_iterator(mode):
      stream.append(np.asarray(next(iter(features.values()))).tobytes())
      yield features, labels


class _PortRecording(_RecordingRandom, generators.DefaultRandomInputGenerator):
  pass


class _JaxRecording(_RecordingRandom,
                    jax_generators.DefaultRandomInputGenerator):
  pass


class TestResume:

  def test_resumed_run_ends_at_the_uninterrupted_one(self, tmp_path):
    generator = _ConstantGenerator(_uint8_batch())
    first = _port_run(str(tmp_path / "a"), 6, generator)
    assert first.state.step == 6
    resumed = _port_run(str(tmp_path / "a"), 10, generator)
    straight = _port_run(str(tmp_path / "b"), 10, generator)
    _assert_states_equal(resumed.state, straight.state)
    for run in ("a", "b"):
      assert sorted(int(s) for s in os.listdir(
          tmp_path / run / "checkpoints")) == [3, 6, 9, 10]
    records = [json.loads(line) for line in open(tmp_path / "a" /
                                                  "metrics.jsonl")]
    assert [r["step"] for r in records] == [2, 4, 6, 8, 10]

  def test_saved_steps_and_stream_restart_as_jax(self, tmp_path):
    """Both loops save [3, 6, 9, 10] over a 6-step run resumed to 10, and
    both start the resumed run on a fresh stream from the generator's
    seed (so a shuffled stream does not continue where it stopped)."""
    port_gen = _PortRecording(batch_size=BATCH, seed=4)
    for steps in (6, 10):
      _port_run(str(tmp_path / "port"), steps, port_gen)
    jax_gen = _JaxRecording(batch_size=BATCH, seed=4)
    for steps in (6, 10):
      jax_train_eval.train_eval_model(
          MockT2RModel(), input_generator_train=jax_gen,
          max_train_steps=steps, model_dir=str(tmp_path / "jax"),
          save_checkpoints_steps=3, log_every_steps=2)
    saved = jax_checkpoints.CheckpointManager(
        str(tmp_path / "jax" / "checkpoints"))
    assert saved.all_steps() == [3, 6, 9, 10]
    saved.close()
    assert checkpoints.CheckpointManager(
        str(tmp_path / "port" / "checkpoints")).all_steps() == [3, 6, 9, 10]
    for recorded in (port_gen.streams, jax_gen.streams):
      assert len(recorded) == 2
      assert len(recorded[0]) >= 6 and len(recorded[1]) >= 4
      assert recorded[1][:4] == recorded[0][:4]  # restarted from the seed

  def test_jax_orbax_run_is_refused_for_warm_start(self, tmp_path):
    jax_train_eval.train_eval_model(
        MockT2RModel(), input_generator_train=jax_generators
        .DefaultRandomInputGenerator(batch_size=BATCH),
        max_train_steps=2, model_dir=str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="orbax"):
      checkpoints.restore_params(str(tmp_path / "jax"))


def test_preemption_leaves_through_the_final_checkpoint(tmp_path):
  """A SIGTERM mid-run (its handler called as the signal would) ends the
  loop at the next step boundary with a checkpoint there, and the
  previous handler comes back."""
  assert threading.current_thread() is threading.main_thread()
  before = signal.getsignal(signal.SIGTERM)

  class Preempting(_ConstantGenerator):
    def _create_iterator(self, mode):
      for index, batch in enumerate(super()._create_iterator(mode)):
        if index == 4:
          signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        yield batch

  result = _port_run(str(tmp_path / "run"), 10, Preempting(_uint8_batch()))
  assert 0 < result.state.step < 10
  saved = checkpoints.CheckpointManager(str(tmp_path / "run" /
                                            "checkpoints")).all_steps()
  assert saved[-1] == result.state.step
  assert signal.getsignal(signal.SIGTERM) == before


def _jax_variables(tmp_path, rename=None):
  """A JAX pose model's fresh variables, written as a variables.npz
  (optionally with the params' top scope `rename[0]` called `rename[1]`)."""
  jax_model = jax_models.PoseEnvRegressionModel(image_size=IMAGE)
  variables = jax.device_get(jax_model.init_variables(jax.random.key(7)))
  variables = jax.tree_util.tree_map(np.asarray, dict(variables))
  variables = {k: dict(v) for k, v in variables.items()}
  if rename:
    variables["params"][rename[1]] = variables["params"].pop(rename[0])
  path = str(tmp_path / "variables.npz")
  jax_variables_io.save_variables(path, variables)
  return path, variables


class TestWarmStart:

  def test_from_a_jax_variables_npz(self, tmp_path):
    path, variables = _jax_variables(tmp_path)
    model = _model(init_from_checkpoint=path)
    state = Trainer(model, device="cpu").create_train_state()
    want = bridge.params_to_state_dict(variables["params"], model.module)
    for key, value in want.items():
      torch.testing.assert_close(state.params[key].detach(), value,
                                 rtol=0, atol=0)
      torch.testing.assert_close(state.ema_params[key], value, rtol=0,
                                 atol=0)
    # Only params are warm-started; statistics keep the init's.
    fresh = Trainer(_model(), device="cpu").create_train_state()
    for key, value in fresh.model_state.items():
      torch.testing.assert_close(state.model_state[key], value)

  def test_assignment_map_renames(self, tmp_path, caplog):
    path, variables = _jax_variables(tmp_path, rename=("tower", "old_tower"))
    model = _model(init_from_checkpoint=path,
                   init_from_checkpoint_assignment_map={
                       "old_tower": "tower", "typo": "no_such_scope"})
    with caplog.at_level(logging.WARNING):
      state = Trainer(model, device="cpu").create_train_state()
    assert "'typo'" in caplog.text and "ZERO" in caplog.text
    variables["params"]["tower"] = variables["params"].pop("old_tower")
    want = bridge.params_to_state_dict(variables["params"], model.module)
    for key, value in want.items():  # head/ matched by its own name
      torch.testing.assert_close(state.params[key].detach(), value,
                                 rtol=0, atol=0)

  def test_merge_params_as_jax(self):
    rng = np.random.default_rng(0)
    target = {"a": {"kernel": np.zeros((2, 3), np.float32)},
              "b": {"bias": np.zeros((3,), np.float32)},
              "c": {"bias": np.zeros((4,), np.float32)}}
    restored = {"x": {"kernel": rng.random((2, 3), np.float32)},
                "b": {"bias": rng.random((3,), np.float32)},
                "c": {"bias": rng.random((5,), np.float32)}}
    want = jax.device_get(jax_checkpoints.merge_params(
        target, restored, assignment_map={"x": "a"}))
    got = checkpoints.merge_params(
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in target.items()}, restored, assignment_map={"x": "a"})
    for scope, leaves in want.items():
      for name, value in leaves.items():
        np.testing.assert_array_equal(got[scope][name].numpy(), value)

  def test_from_a_port_run(self, tmp_path):
    generator = _ConstantGenerator(_uint8_batch())
    result = _port_run(str(tmp_path / "run"), 3, generator)
    model = _model(init_from_checkpoint=str(tmp_path / "run"))
    state = Trainer(model, seed=5, device="cpu").create_train_state()
    for key, value in result.state.params.items():
      torch.testing.assert_close(state.params[key], value, rtol=0, atol=0)


class TestMetricWriter:

  SCALARS = [(1, {"loss": 0.5, "mse": 1.0 / 3.0}),
             (100, {"loss": 1e-7, "eval/mse": 12345.678})]

  def _events(self, logdir):
    path = [os.path.join(logdir, f) for f in os.listdir(logdir)
            if f.startswith("events.out.tfevents.")]
    assert len(path) == 1
    return [event_pb2.Event.FromString(record)
            for record in jax_tfrecord.read_tfrecords(path[0])]

  def test_files_match_the_jax_writer(self, tmp_path):
    for writer_cls, name in ((metric_writer.MetricWriter, "port"),
                             (jax_metric_writer.MetricWriter, "jax")):
      with writer_cls(str(tmp_path / name)) as writer:
        for step, scalars in self.SCALARS:
          writer.write_scalars(step, scalars)
    port, want = ([json.loads(line) for line in open(tmp_path / name /
                                                      "metrics.jsonl")]
                  for name in ("port", "jax"))
    assert len(port) == len(want) == 2
    for got, expected in zip(port, want):
      assert set(got) == set(expected)
      assert got["step"] == expected["step"]
      assert got["host"] == expected["host"]
      for key in expected:
        if key not in ("step", "wall_time", "host", "pid"):
          assert got[key] == pytest.approx(expected[key], rel=1e-5)
    port_events = self._events(str(tmp_path / "port"))
    jax_events = self._events(str(tmp_path / "jax"))
    assert port_events[0].file_version == jax_events[0].file_version
    assert len(port_events) == len(jax_events) == 3
    for got, expected in zip(port_events[1:], jax_events[1:]):
      assert got.step == expected.step
      assert [(v.tag, v.simple_value) for v in got.summary.value] == [
          (v.tag, v.simple_value) for v in expected.summary.value]

  def test_images_wait_and_closed_raises(self, tmp_path):
    """Images land in the event file (tests/test_torch_harness.py holds
    them against the JAX writer); a closed writer raises."""
    writer = metric_writer.MetricWriter(str(tmp_path))
    writer.write_images(0, {"x": np.zeros((2, 2, 3), np.uint8)})
    assert [v.tag for v in self._events(str(tmp_path))[1].summary.value] == [
        "x"]
    writer.close()
    with pytest.raises(RuntimeError, match="closed"):
      writer.write_images(1, {"x": np.zeros((2, 2, 3), np.uint8)})
    with pytest.raises(RuntimeError, match="closed"):
      writer.write_scalars(1, {"loss": 1.0})


def _bindings(config_module, path):
  config_module.clear_config()
  with open(path) as f:
    config_module.parse_config(f.read())
  bindings = {key: repr(value)
              for key, value in config_module.config._BINDINGS.items()}
  config_module.clear_config()
  return bindings


class TestConfig:

  def test_cfg_parses_to_equal_bindings(self):
    port = _bindings(config, JAX_CFG)
    assert port == _bindings(jax_config, JAX_CFG)
    assert _bindings(config, PORT_CFG) == port
    with open(PORT_CFG) as f:
      assert "tensor2robot_tpu_torch.bin.run_t2r_trainer" in f.read()
    for path in (JAX_CFG, PORT_CFG):
      with open(path) as f:
        text = f.read()
      config.parse_config(text)
      jax_config.parse_config(text)
      for key in ("DefaultRecordInputGenerator.batch_size",
                  "train_eval_model.max_train_steps",
                  "train_eval_model.save_checkpoints_steps",
                  "create_adam_optimizer.learning_rate"):
        assert config.query_binding(key) == jax_config.query_binding(key)

  def test_macros_and_refs(self):
    config.parse_config('BATCH = 4\nx.y = {"n": %BATCH, "f": [@f, @g()]}')
    jax_config.parse_config('BATCH = 4\nx.y = {"n": %BATCH, "f": [@f, @g()]}')
    assert repr(config_lib._BINDINGS["x.y"]) == repr(
        jax_config.config._BINDINGS["x.y"])
    assert config.query_binding("BATCH") == 4

  def test_cfg_optimizer_is_adam_1e3(self):
    import importlib
    importlib.import_module("tensor2robot_tpu_torch.config.registrations")
    with open(PORT_CFG) as f:
      config.parse_config(f.read())
    model = pose_env_models.PoseEnvRegressionModel(image_size=IMAGE)
    optimizer = model.create_optimizer([torch.zeros(2, requires_grad=True)])
    assert isinstance(optimizer, torch.optim.Adam)
    assert optimizer.param_groups[0]["lr"] == 1e-3
    assert "create_adam_optimizer.learning_rate = 0.001" in (
        config.operative_config_str())

  def test_cli_runs_write_equal_operative_configs(self, tmp_path):
    records = str(tmp_path / "train.tfrecord")
    pose_env.write_tfrecords(records, 24, seed=0)
    args = ["--binding",
            f'DefaultRecordInputGenerator.file_patterns = "{records}"',
            "--binding", "DefaultRecordInputGenerator.batch_size = 8",
            "--binding", "train_eval_model.max_train_steps = 4",
            "--binding", "train_eval_model.save_checkpoints_steps = 2",
            "--model_dir", str(tmp_path / "run")]
    assert jax_cli.main(["--config", JAX_CFG, "--import_module",
                         "tensor2robot_tpu.research.pose_env."
                         "pose_env_models"] + args) == 0
    want = (tmp_path / "run" / "operative_config.txt").read_text()
    shutil.move(str(tmp_path / "run"), str(tmp_path / "jax_run"))
    jax_config.clear_config()
    assert run_t2r_trainer.main(
        ["--config", PORT_CFG, "--import_module",
         "tensor2robot_tpu_torch.research.pose_env.pose_env_models",
         "--device", "cpu"] + args) == 0
    run = tmp_path / "run"
    assert (run / "operative_config.txt").read_text() == want
    assert "device" not in want
    assert sorted(os.listdir(run / "checkpoints")) == ["2", "4"]
    payload = torch.load(str(run / "checkpoints" / "4" / "state.pt"),
                         weights_only=True)
    assert payload["optimizer"]["param_groups"][0]["lr"] == 1e-3
    assert payload["optimizer"]["state"][0]["step"] == 4
    assert os.listdir(run / "export" / "latest")
    assert [json.loads(line)["step"] for line in
            open(run / "metrics.jsonl")] == [4]


def test_record_generator_trains(tmp_path):
  """The record generator feeds the loop, and the parser's choice shows in
  pipeline_stats."""
  records = str(tmp_path / "train.tfrecord")
  pose_env.write_tfrecords(records, 24, seed=1, image_size=IMAGE)
  generator = generators.DefaultRecordInputGenerator(
      records, batch_size=BATCH, shuffle_buffer_size=8, seed=2)
  result = train_eval.train_eval_model(
      _model(), input_generator_train=generator, max_train_steps=3,
      log_every_steps=1, device="cpu")
  assert result.state.step == 3
  assert np.isfinite(result.train_metrics["loss"])
  assert generator.pipeline_stats["native_calibration"]["decision"] == (
      "python")
  assert tfrecord.list_files(records) == [records]
