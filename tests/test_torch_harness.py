"""The port's training harness held against the JAX package.

On the CPU, with the mock model: the hooks' calls at the JAX loop's points
(the same sequence from both loops), the async export hook, the latest and
best exporters (the best exporter's decisions equal JAX's, across a
restart), image summaries in the event file (the same PNG events as the
JAX writer's), the test fixture, the continuous evaluator and its CLI
mode, the classification head (losses and accuracies against JAX's) and
the schedules (values against JAX's).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tensorboard.compat.proto import event_pb2  # noqa: E402

from tensor2robot_tpu import config as jax_config  # noqa: E402
from tensor2robot_tpu.config import registrations  # noqa: E402,F401
from tensor2robot_tpu.data import tfrecord as jax_tfrecord  # noqa: E402
from tensor2robot_tpu.data.default_input_generator import (  # noqa: E402
    DefaultRandomInputGenerator as JaxRandomGenerator,
)
from tensor2robot_tpu.export.exporters import (  # noqa: E402
    BestExporter as JaxBestExporter,
)
from tensor2robot_tpu.export.native_export_generator import (  # noqa: E402
    NativeExportGenerator as JaxNativeExportGenerator,
)
from tensor2robot_tpu.hooks.hook_builder import (  # noqa: E402
    Hook as JaxHook,
    HookBuilder as JaxHookBuilder,
)
from tensor2robot_tpu.models.classification_model import (  # noqa: E402
    ClassificationModel as JaxClassificationModel,
)
from tensor2robot_tpu.specs import tensorspec_utils as jax_ts  # noqa: E402
from tensor2robot_tpu.train import train_eval as jax_train_eval  # noqa: E402
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tensor2robot_tpu.utils import (  # noqa: E402
    global_step_functions as jax_schedules,
)
from tensor2robot_tpu.utils import metric_writer as jax_metric_writer  # noqa: E402
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock  # noqa: E402

from tensor2robot_tpu_torch import config  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.config import registrations as port_registrations  # noqa: E402,F401
from tensor2robot_tpu_torch.data.default_input_generator import (  # noqa: E402
    DefaultRandomInputGenerator,
)
from tensor2robot_tpu_torch.data.tfrecord import read_tfrecords  # noqa: E402
from tensor2robot_tpu_torch.export import export_utils  # noqa: E402
from tensor2robot_tpu_torch.export.exporters import (  # noqa: E402
    BestExporter,
    LatestExporter,
    create_default_exporters_fn,
)
from tensor2robot_tpu_torch.export.native_export_generator import (  # noqa: E402
    NativeExportGenerator,
)
from tensor2robot_tpu_torch.hooks import (  # noqa: E402
    AsyncExportHookBuilder,
    Hook,
    HookBuilder,
)
from tensor2robot_tpu_torch.models.classification_model import (  # noqa: E402
    ClassificationModel,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.train.train_eval import (  # noqa: E402
    continuous_eval_model,
    train_eval_model,
)
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import (  # noqa: E402
    global_step_functions as schedules,
)
from tensor2robot_tpu_torch.utils import metric_writer  # noqa: E402
from tensor2robot_tpu_torch.utils import profiling  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402
from tensor2robot_tpu_torch.utils.t2r_test_fixture import (  # noqa: E402
    T2RModelFixture,
)


@pytest.fixture(autouse=True)
def _clean_configs():
  """Bindings are process-wide in both packages: none leaks in or out."""
  config.clear_config()
  jax_config.clear_config()
  yield
  config.clear_config()
  jax_config.clear_config()


def _random(seed=0):
  return DefaultRandomInputGenerator(batch_size=8, seed=seed)


def _train(model_dir, steps=4, **kwargs):
  kwargs.setdefault("save_checkpoints_steps", 2)
  kwargs.setdefault("log_every_steps", 2)
  return train_eval_model(MockT2RModel(), input_generator_train=_random(),
                          max_train_steps=steps, model_dir=model_dir,
                          device="cpu", **kwargs)


def _event_values(logdir):
  path = [os.path.join(logdir, f) for f in os.listdir(logdir)
          if f.startswith("events.out.tfevents.")]
  assert len(path) == 1
  return [(event.step, value) for record in read_tfrecords(path[0])
          for event in [event_pb2.Event.FromString(record)]
          for value in event.summary.value]


class TestHooks:

  def test_calls_match_the_jax_loop(self, tmp_path):
    """A recording hook sees the same calls at the same steps in both
    loops: begin, after_step at each log step, after_checkpoint after each
    save (the final one too), end."""
    calls = {"port": [], "jax": []}

    def recorder(base, builder_base, name):
      class Recording(base):
        def begin(self, trainer, state, model_dir):
          calls[name].append(("begin", int(state.step)))

        def after_step(self, state, metrics):
          calls[name].append(("after_step", int(state.step),
                              sorted(metrics)))

        def after_checkpoint(self, step, state):
          calls[name].append(("after_checkpoint", int(step)))

        def end(self, state):
          calls[name].append(("end", int(state.step)))

      class Builder(builder_base):
        def create_hooks(self, trainer, model_dir):
          return [Recording()]

      return Builder()

    _train(str(tmp_path / "port"), steps=5,
           hook_builders=[recorder(Hook, HookBuilder, "port")])
    jax_train_eval.train_eval_model(
        JaxMock(), input_generator_train=JaxRandomGenerator(batch_size=8),
        max_train_steps=5, model_dir=str(tmp_path / "jax"),
        save_checkpoints_steps=2, log_every_steps=2,
        hook_builders=[recorder(JaxHook, JaxHookBuilder, "jax")])
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == [
        "begin", "after_step", "after_checkpoint", "after_step",
        "after_checkpoint", "after_step", "after_checkpoint", "end"]

  def test_async_export_hook_publishes_while_training(self, tmp_path):
    """Exports at checkpoints (2, 4, 6; one that waits while the worker is
    busy gives way to the next), the final step's always, each
    restorable."""
    model_dir = str(tmp_path / "run")
    _train(model_dir, steps=6, hook_builders=[
        AsyncExportHookBuilder(NativeExportGenerator(), keep=5)])
    root = os.path.join(model_dir, "export", "latest")
    versions = export_utils.list_export_versions(root)
    steps = []
    for version in versions:
      with open(os.path.join(root, str(version),
                             export_utils.SPEC_ASSET_NAME)) as f:
        steps.append(json.load(f)["global_step"])
    assert steps == sorted(set(steps)) and set(steps) <= {2, 4, 6}
    assert steps[-1] == 6
    predictor = ExportedModelPredictor(MockT2RModel(), root, device="cpu")
    assert predictor.restore()
    out = predictor.predict({"x": np.zeros((2, 3), np.float32)})
    assert out["inference_output"].shape == (2, 1)

  def test_profiler_hook_builder(self, tmp_path):
    hooks = profiling.ProfilerHookBuilder(start_step=2, end_step=4,
                                          log_dir=str(tmp_path)).create_hooks(
                                              None, str(tmp_path))
    assert len(hooks) == 1 and isinstance(hooks[0], profiling.ProfilerHook)
    assert isinstance(hooks[0], Hook)
    assert config.get_configurable("ProfilerHookBuilder") is (
        profiling.ProfilerHookBuilder)


class TestExporters:

  def test_latest_and_best(self, tmp_path):
    model_dir = str(tmp_path / "run")
    decisions = []

    class RecordingBest(BestExporter):
      def after_eval(self, variables, global_step, eval_metrics):
        out = super().after_eval(variables, global_step, eval_metrics)
        decisions.append((global_step, out is not None))
        return out

    def create_exporters_fn(model):
      return [LatestExporter(NativeExportGenerator(), keep=2),
              RecordingBest(NativeExportGenerator(), metric_key="loss")]

    _train(model_dir, steps=6, input_generator_eval=_random(1),
           eval_steps=2, eval_interval_steps=2,
           create_exporters_fn=create_exporters_fn)
    latest = os.path.join(model_dir, "export", "latest")
    best = os.path.join(model_dir, "export", "best")
    # Latest exports after every eval (2 interleaved and the final one),
    # kept to 2.
    assert len(export_utils.list_export_versions(latest)) == 2
    assert [step for step, _ in decisions] == [2, 4, 6]
    assert decisions[0][1]  # the first eval always improves
    assert len(export_utils.list_export_versions(best)) == sum(
        published for _, published in decisions)
    with open(os.path.join(best, "best_eval.json")) as f:
      assert json.load(f)["metric"] == "loss"
    predictor = ExportedModelPredictor(MockT2RModel(), best, device="cpu")
    assert predictor.restore()
    out = predictor.predict({"x": np.zeros((2, 3), np.float32)})
    assert out["inference_output"].shape == (2, 1)

  def test_best_decisions_match_jax_across_a_restart(self, tmp_path):
    """The same metric stream gives the JAX exporter's decisions, and a
    fresh exporter (a restarted job) compares against the best on disk."""
    model = MockT2RModel()
    variables = Trainer(model, device="cpu").create_train_state().variables()
    jax_model = JaxMock()
    jax_variables = JaxTrainer(jax_model).create_train_state().variables()
    stream = [(1, 1.0), (2, 2.0), (3, 0.5), (4, 0.7), (5, 0.3),
              (6, float("nan"))]
    got, want = [], []
    for cls, mdl, var, root, out in (
        (BestExporter, model, variables, tmp_path / "port", got),
        (JaxBestExporter, jax_model, jax_variables, tmp_path / "jax",
         want)):
      generator = (NativeExportGenerator if cls is BestExporter
                   else JaxNativeExportGenerator)
      exporter = cls(generator(), metric_key="loss")
      exporter.begin(mdl, str(root))
      for i, (step, value) in enumerate(stream):
        if i == 3:  # a restart: a fresh exporter reads best_eval.json
          exporter = cls(generator(), metric_key="loss")
          exporter.begin(mdl, str(root))
        out.append(exporter.after_eval(var, step, {"loss": value})
                   is not None)
      with pytest.raises(KeyError):
        exporter.after_eval(var, 7, {"other": 0.0})
    assert got == want == [True, False, True, False, True, False]

  def test_default_pair_and_collisions(self, tmp_path):
    exporters = create_default_exporters_fn(NativeExportGenerator)(None)
    assert [type(e) for e in exporters] == [LatestExporter, BestExporter]
    assert [e.name for e in exporters] == ["latest", "best"]
    with pytest.raises(ValueError, match="same root"):
      _train(str(tmp_path / "a"), steps=1, create_exporters_fn=lambda m: [
          LatestExporter(NativeExportGenerator()),
          LatestExporter(NativeExportGenerator())])
    with pytest.raises(ValueError, match="both publish"):
      _train(str(tmp_path / "b"), steps=1, input_generator_eval=_random(1),
             eval_steps=1, export_generator=NativeExportGenerator(),
             create_exporters_fn=lambda m: [
                 LatestExporter(NativeExportGenerator())])


class TestImages:

  def test_write_images_matches_the_jax_writer(self, tmp_path):
    rng = np.random.default_rng(1)
    images = {"rgb": rng.integers(0, 255, (6, 7, 3), np.uint8),
              "gray_float": rng.random((5, 4)).astype(np.float32)}
    for cls, name in ((metric_writer.MetricWriter, "port"),
                      (jax_metric_writer.MetricWriter, "jax")):
      with cls(str(tmp_path / name)) as writer:
        writer.write_images(3, images)
    got, want = (_event_values(str(tmp_path / name))
                 for name in ("port", "jax"))
    assert len(got) == len(want) == 2
    for (step_a, a), (step_b, b) in zip(got, want):
      assert step_a == step_b == 3
      assert (a.tag, a.image.height, a.image.width, a.image.colorspace,
              a.image.encoded_image_string) == (
                  b.tag, b.image.height, b.image.width, b.image.colorspace,
                  b.image.encoded_image_string)

  def test_eval_image_summaries_written(self, tmp_path):
    class ImageSummaryModel(MockT2RModel):
      def model_image_summaries_fn(self, variables, features):
        return {"probe": torch.full((8, 8, 3), 128, dtype=torch.uint8)}

    model_dir = str(tmp_path / "run")
    train_eval_model(ImageSummaryModel(), input_generator_train=_random(),
                     input_generator_eval=_random(1), max_train_steps=2,
                     eval_steps=1, model_dir=model_dir, log_every_steps=1,
                     device="cpu")
    tags = [value.tag for _, value in _event_values(model_dir)
            if value.HasField("image")]
    assert tags == ["eval/probe"]


class TestFixture:

  def test_fixture(self, tmp_path):
    fixture = T2RModelFixture(device="cpu")
    result = fixture.random_train(MockT2RModel(), max_train_steps=3,
                                  model_dir=str(tmp_path / "fix"))
    assert "loss" in result.eval_metrics  # the fixture wires an eval stream
    assert sorted(os.listdir(tmp_path / "fix" / "checkpoints")) == ["3"]
    fixture.random_train(MockT2RModel(use_batch_norm=True))


class TestStacksAndDropout:

  def test_iterations_per_loop_matches_single_steps(self, tmp_path):
    """The mock draws dropout from the step's generator, so stacks of 2
    (the last one of 1) end where 7 single steps do, bit for bit, and the
    crossing cadence still checkpoints mid-run."""
    results = [_train(str(tmp_path / f"ipl{ipl}"), steps=7,
                      iterations_per_loop=ipl) for ipl in (1, 2)]
    assert [r.state.step for r in results] == [7, 7]
    for key, value in results[0].state.params.items():
      torch.testing.assert_close(results[1].state.params[key], value,
                                 rtol=0, atol=0)
    assert len(os.listdir(tmp_path / "ipl2" / "checkpoints")) > 1


class TestContinuousEval:

  def test_evaluates_each_checkpoint_then_stops(self, tmp_path):
    model_dir = str(tmp_path / "run")
    _train(model_dir, steps=4)
    results = continuous_eval_model(
        MockT2RModel(), input_generator_eval=_random(1),
        model_dir=model_dir, eval_steps=2, poll_interval_s=0.1,
        timeout_s=5.0, stop_after_step=4, device="cpu")
    assert sorted(results) == [2, 4]  # every checkpoint, no holes
    assert "loss" in results[2] and "loss" in results[4]
    with open(os.path.join(model_dir, "eval", "metrics.jsonl")) as f:
      rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [2, 4]
    assert all("eval/loss" in r for r in rows)

  def test_exporters_and_timeout(self, tmp_path):
    model_dir = str(tmp_path / "run")
    _train(model_dir, steps=4)
    results = continuous_eval_model(
        MockT2RModel(), input_generator_eval=_random(1),
        model_dir=model_dir, eval_steps=1, poll_interval_s=0.05,
        timeout_s=0.2, device="cpu",
        create_exporters_fn=create_default_exporters_fn(
            NativeExportGenerator))
    assert sorted(results) == [2, 4]
    assert len(export_utils.list_export_versions(
        os.path.join(model_dir, "export", "latest"))) == 2
    os.makedirs(tmp_path / "empty" / "checkpoints")
    assert continuous_eval_model(
        MockT2RModel(), input_generator_eval=_random(1),
        model_dir=str(tmp_path / "empty"), eval_steps=1,
        poll_interval_s=0.05, timeout_s=0.2, device="cpu") == {}

  def test_cli_mode(self, tmp_path):
    model_dir = str(tmp_path / "run")
    _train(model_dir, steps=2, save_checkpoints_steps=0)
    cfg = tmp_path / "eval.cfg"
    cfg.write_text(
        "continuous_eval_model.model = @MockT2RModel()\n"
        "continuous_eval_model.input_generator_eval = "
        "@DefaultRandomInputGenerator()\n"
        "DefaultRandomInputGenerator.batch_size = 8\n"
        "continuous_eval_model.eval_steps = 1\n"
        "continuous_eval_model.poll_interval_s = 0.1\n"
        "continuous_eval_model.timeout_s = 1.0\n"
        "continuous_eval_model.stop_after_step = 2\n")
    assert run_t2r_trainer.main(["--config", str(cfg), "--model_dir",
                                 model_dir, "--mode", "continuous_eval",
                                 "--device", "cpu"]) == 0
    with open(os.path.join(model_dir, "eval", "metrics.jsonl")) as f:
      assert [json.loads(line)["step"] for line in f] == [2]


class _Classifier(ClassificationModel):
  def get_feature_specification(self, mode):
    raise NotImplementedError

  def build_module(self):
    raise NotImplementedError


class _JaxClassifier(JaxClassificationModel):
  def get_feature_specification(self, mode):
    raise NotImplementedError

  def build_module(self):
    raise NotImplementedError


class TestClassification:

  @pytest.mark.parametrize("labels", [
      np.array([0, 1, 2, 0, 1, 2], np.int32),
      np.array([[0], [1], [2], [0], [2], [2]], np.int32),
      np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 1]],
      np.full((6, 3), 1 / 3, np.float32)],
      ids=["ids", "ids_column", "one_hot", "soft"])
  def test_loss_and_accuracy_match_jax(self, labels):
    logits = np.random.default_rng(0).standard_normal((6, 3)).astype(
        np.float32)
    loss, metrics = _Classifier().loss_fn(
        {"logits": torch.from_numpy(logits)}, None,
        {"label": torch.from_numpy(labels)})
    want_loss, want = _JaxClassifier().loss_fn(
        {"logits": jnp.asarray(logits)}, None,
        jax_ts.TensorSpecStruct({"label": jnp.asarray(labels)}))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    for key in ("cross_entropy", "accuracy"):
      assert float(metrics[key]) == pytest.approx(float(want[key]),
                                                  rel=1e-6)

  def test_bad_labels_raise(self):
    logits = {"logits": torch.zeros(4, 3)}
    with pytest.raises(ValueError, match="one-hot"):
      _Classifier().loss_fn(logits, None, {"label": torch.zeros(4, 1)})
    with pytest.raises(ValueError, match="requires labels"):
      _Classifier().loss_fn(logits, None, None)


class TestSchedules:

  STEPS = [0, 5, 10, 15, 20, 30, 39, 40, 99, 100, 150, 200, 250, 1000]

  @pytest.mark.parametrize("name, args", [
      ("piecewise_linear", ([10, 20, 40], [1.0, 0.5, 0.1])),
      ("piecewise_constant", ([100, 200], [1e-3, 1e-4, 1e-5])),
      ("exponential_decay", (1.0, 100, 0.5)),
      ("exponential_decay", (0.3, 7, 0.9, True))])
  def test_values_match_jax(self, name, args):
    got = getattr(schedules, name)(*args)
    want = getattr(jax_schedules, name)(*args)
    for step in self.STEPS:
      assert isinstance(got(step), float)
      assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                        abs=1e-12), step

  def test_validation(self):
    with pytest.raises(ValueError, match="ascending"):
      schedules.piecewise_linear([20, 10], [1.0, 0.5])
    with pytest.raises(ValueError, match="one value per boundary"):
      schedules.piecewise_linear([1, 2], [1.0])
    with pytest.raises(ValueError, match="len"):
      schedules.piecewise_constant([1, 2], [1.0, 0.5])
    for name in ("piecewise_linear", "piecewise_constant",
                 "exponential_decay"):
      assert config.get_configurable(name) is getattr(schedules, name)
