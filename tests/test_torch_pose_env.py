"""The port's pose_env serving slice held against the JAX package.

Same numpy inputs through both frameworks: the env copy renders the same
images and rewards, the weight bridge round-trips a flax tree exactly, and
the port's ExportedModelPredictor serves an export written by the JAX
NativeExportGenerator with the JAX predictor's outputs. Everything runs
on the CPU at the model's real 64x64 size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu import modes  # noqa: E402
from tensor2robot_tpu.export.native_export_generator import (  # noqa: E402
    NativeExportGenerator,
)
from tensor2robot_tpu.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor as JaxExportedModelPredictor,
)
from tensor2robot_tpu.research.pose_env import (  # noqa: E402
    eval_policy as jax_eval_policy,
    pose_env as jax_pose_env,
    pose_env_models as jax_models,
)
from tensor2robot_tpu.specs import tensorspec_utils as jax_ts  # noqa: E402
from tensor2robot_tpu_torch import bridge, resolve_device  # noqa: E402
from tensor2robot_tpu_torch.export import variables_io  # noqa: E402
from tensor2robot_tpu_torch.layers import vision_layers  # noqa: E402
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    eval_policy,
    pose_env,
    pose_env_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.utils import backoff  # noqa: E402

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Port vs JAX on the same weights and images; poses are in table units
# ([-1, 1]), here of magnitude up to ~0.5. float32: only summation order
# differs (1.5e-7 seen). bfloat16, the default compute dtype: both sides
# round activations to 8-bit mantissas, at different points (torch adds a
# conv's bias before rounding, XLA after), through three convs, the
# spatial softmax and two dense layers (5e-4 seen); the bound keeps 10x.
F32_ATOL = 1e-4
BF16_ATOL = 5e-3


def _jax_variables(norm="batch", compute_dtype=jnp.float32, seed=0):
  """JAX PoseEnvRegressionModel variables with every leaf randomised.

  init gives zero biases, unit scales, zero means and unit variances,
  which would hide a bias, scale or swapped mean/var mapping: every leaf
  is perturbed, and the variances stay positive.
  """
  model = jax_models.PoseEnvRegressionModel(norm=norm,
                                            compute_dtype=compute_dtype)
  variables = jax.device_get(model.init_variables(
      jax.random.PRNGKey(seed), mode=modes.PREDICT))
  rng = np.random.default_rng(seed)

  def perturb(path, leaf):
    name = path[-1].key
    if name == "var":
      return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
    if name == "kernel":  # already drawn at random, at init's scale
      return np.asarray(leaf)
    noise = rng.standard_normal(leaf.shape).astype(np.float32)
    return (np.asarray(leaf) + 0.2 * noise).astype(np.float32)

  return model, jax.tree_util.tree_map_with_path(perturb, variables)


def _images(n_env=4, n_random=4, seed=0):
  env = jax_pose_env.PoseEnv(seed=seed)
  rendered = [env.reset()["image"].astype(np.float32) / 255.0
              for _ in range(n_env)]
  noise = np.random.default_rng(seed).random((n_random, 64, 64, 3),
                                             dtype=np.float32)
  return np.concatenate([np.stack(rendered), noise]).astype(np.float32)


def _torch_dtype(jax_dtype):
  return torch.float32 if jax_dtype == jnp.float32 else torch.bfloat16


class TestPoseEnvCopy:

  @pytest.mark.parametrize("seed", [0, 1, 7, 123])
  def test_images_and_rewards_bit_identical(self, seed):
    ours, theirs = pose_env.PoseEnv(seed=seed), jax_pose_env.PoseEnv(
        seed=seed)
    actions = np.random.default_rng(seed).uniform(-1, 1, (6, 2))
    for action in actions:
      a, b = ours.reset(), theirs.reset()
      np.testing.assert_array_equal(a["image"], b["image"])
      np.testing.assert_array_equal(a["target_pose"], b["target_pose"])
      sa, sb = ours.step(action), theirs.step(action)
      assert sa.reward == sb.reward
      assert sa.info["success"] == sb.info["success"]
      np.testing.assert_array_equal(sa.observation["image"],
                                    sb.observation["image"])

  def test_oracle_scores_the_same_under_both_evaluators(self):
    ours = eval_policy.evaluate_policy(
        eval_policy.oracle_policy, num_episodes=24, seed=3,
        extra_thresholds=(0.05,))
    theirs = jax_eval_policy.evaluate_policy(
        jax_eval_policy.oracle_policy, num_episodes=24, seed=3,
        extra_thresholds=(0.05,))
    assert ours == theirs
    assert ours["success_rate"] > 0.9


class TestBridge:

  @pytest.mark.parametrize("norm", ["batch", "group"])
  def test_round_trip_is_exact(self, norm):
    _, variables = _jax_variables(norm=norm)
    module = pose_env_models.PoseEnvRegressionModel(norm=norm).module
    state = bridge.variables_to_state_dict(variables, module)
    assert set(state) == set(module.state_dict())
    back = bridge.state_dict_to_variables(state)
    flat_want = jax_ts.flatten_spec_structure(variables)
    flat_got = jax_ts.flatten_spec_structure(back)
    assert list(sorted(flat_got)) == list(sorted(flat_want))
    for key in flat_want:
      np.testing.assert_array_equal(flat_got[key].numpy(),
                                    np.asarray(flat_want[key]))

  def test_layouts(self):
    _, variables = _jax_variables()
    module = pose_env_models.PoseEnvRegressionModel().module
    state = bridge.variables_to_state_dict(variables, module)
    kernel = variables["params"]["tower"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(state["tower.conv1.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    dense = variables["params"]["head"]["fc0"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(state["head.fc0.weight"].numpy(), dense.T)
    stats = variables["batch_stats"]["tower"]["bn2"]
    np.testing.assert_array_equal(state["tower.bn2.running_mean"].numpy(),
                                  stats["mean"])
    np.testing.assert_array_equal(state["tower.bn2.running_var"].numpy(),
                                  stats["var"])

  def test_raises_on_unmapped_and_missing(self):
    _, variables = _jax_variables()
    module = pose_env_models.PoseEnvRegressionModel().module
    extra = jax.tree_util.tree_map(lambda x: x, variables)
    extra["params"]["head"]["fc0"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="gamma"):
      bridge.variables_to_state_dict(extra, module)
    missing = jax.tree_util.tree_map(lambda x: x, variables)
    del missing["batch_stats"]["tower"]["bn1"]["var"]
    with pytest.raises(KeyError, match="tower.bn1.running_var"):
      bridge.variables_to_state_dict(missing, module)
    with pytest.raises(KeyError, match="cache/head/index"):
      bridge.variables_to_state_dict(
          {"cache": {"head": {"index": np.zeros(1)}}, **variables}, module)


class TestLayers:

  def test_same_padding_is_xla_asymmetric(self):
    assert vision_layers.same_padding((64, 64), 3, 2) == (0, 1, 0, 1)
    assert vision_layers.same_padding((32, 32), 3, 2) == (0, 1, 0, 1)
    assert vision_layers.same_padding((16, 16), 3, 1) == (1, 1, 1, 1)
    assert vision_layers.same_padding((7, 5), 3, 2) == (1, 1, 1, 1)

  @pytest.mark.parametrize("norm", ["batch", "group", "none"])
  def test_predict_fn_matches_jax_at_float32(self, norm):
    jax_model, variables = _jax_variables(norm=norm)
    images = _images()
    want = jax_model.predict_fn(
        variables, jax_ts.TensorSpecStruct({"image": images}))
    model = pose_env_models.PoseEnvRegressionModel(
        norm=norm, compute_dtype=torch.float32)
    state = bridge.variables_to_state_dict(variables, model.module)
    got = model.predict_fn(state, {"image": torch.from_numpy(images)})
    np.testing.assert_allclose(got["inference_output"].numpy(),
                               np.asarray(want["inference_output"]),
                               atol=F32_ATOL)

  def test_loss_matches_jax(self):
    rng = np.random.default_rng(4)
    pred, target = (rng.standard_normal((8, 2)).astype(np.float32)
                    for _ in range(2))
    jax_model = jax_models.PoseEnvRegressionModel()
    want_loss, want = jax_model.loss_fn(
        {"inference_output": jnp.asarray(pred)}, None,
        {"target_pose": jnp.asarray(target)})
    model = pose_env_models.PoseEnvRegressionModel()
    loss, got = model.loss_fn({"inference_output": torch.from_numpy(pred)},
                              None, {"target_pose": torch.from_numpy(target)})
    assert float(loss) == pytest.approx(float(want_loss), abs=1e-6)
    for key in want:
      assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-6)

  def test_train_mode_batch_norm_is_refused(self):
    """...where batch_stats is not a mutable collection: train-mode
    BatchNorm updates it, and flax refuses to update an immutable one."""

    class Frozen(pose_env_models.PoseEnvRegressionModel):

      def mutable_collections(self):
        return ()

    class JaxFrozen(jax_models.PoseEnvRegressionModel):

      def mutable_collections(self):
        return ()

    model = Frozen()
    variables = model.init_variables(torch.Generator().manual_seed(0),
                                     device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
      model.inference_network_fn(
          variables, {"image": torch.zeros(2, 64, 64, 3)}, modes.TRAIN)
    jax_model = JaxFrozen()
    with pytest.raises(Exception, match="batch_stats"):
      jax_model.inference_network_fn(
          jax_model.init_variables(jax.random.PRNGKey(0)),
          jax_ts.TensorSpecStruct({"image": jnp.zeros((2, 64, 64, 3))}),
          modes.TRAIN)
    # With batch_stats mutable, the pass runs and returns the statistics.
    _, state = pose_env_models.PoseEnvRegressionModel().inference_network_fn(
        variables, {"image": torch.zeros(2, 64, 64, 3)}, modes.TRAIN)
    assert sorted(state) == sorted(
        k for k in variables if k.endswith(("running_mean", "running_var")))


def _export(tmp_path, jax_model, variables):
  root = str(tmp_path / "exports")
  generator = NativeExportGenerator(export_root=root)
  generator.set_specification_from_model(jax_model)
  return root, generator.export(variables)


class TestServingSlice:

  @pytest.mark.parametrize("compute_dtype, atol", [(jnp.float32, F32_ATOL),
                                                   (jnp.bfloat16, BF16_ATOL)])
  def test_serves_a_jax_native_export(self, tmp_path, compute_dtype, atol):
    jax_model, variables = _jax_variables(compute_dtype=compute_dtype)
    root, export_dir = _export(tmp_path, jax_model, variables)
    images = _images()
    jax_predictor = JaxExportedModelPredictor(root)
    assert jax_predictor.restore()
    want = jax_predictor.predict({"image": images})["inference_output"]
    direct = np.asarray(jax_model.predict_fn(
        variables, jax_ts.TensorSpecStruct({"image": images}))[
            "inference_output"])

    model = pose_env_models.PoseEnvRegressionModel(
        compute_dtype=_torch_dtype(compute_dtype))
    predictor = ExportedModelPredictor(model, root, device="cpu")
    assert predictor.model_version == -1
    assert predictor.restore()
    assert predictor.model_version == int(os.path.basename(export_dir))
    got = predictor.predict({"image": images})["inference_output"]
    assert got.shape == (len(images), 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, direct, atol=atol)

  def test_refuses_an_export_of_another_input_size(self, tmp_path):
    jax_model, variables = _jax_variables()
    small = jax_models.PoseEnvRegressionModel(image_size=32,
                                              compute_dtype=jnp.float32)
    root, _ = _export(tmp_path, small, variables)
    predictor = ExportedModelPredictor(
        pose_env_models.PoseEnvRegressionModel(), root, device="cpu")
    with pytest.raises(ValueError, match="image"):
      predictor.restore()

  def test_validates_features(self, tmp_path):
    predictor = ExportedModelPredictor(
        pose_env_models.PoseEnvRegressionModel(), str(tmp_path),
        device="cpu")
    predictor.init_randomly()
    assert predictor.model_version == 0
    out = predictor.predict({"image": np.zeros((3, 64, 64, 3), np.float32)})
    assert out["inference_output"].shape == (3, 2)
    with pytest.raises(ValueError, match="shape"):
      predictor.predict({"image": np.zeros((3, 32, 32, 3), np.float32)})
    with pytest.raises(ValueError, match="dtype"):
      predictor.predict({"image": np.zeros((3, 64, 64, 3), np.float64)})
    predictor.close()
    with pytest.raises(ValueError, match="restore"):
      predictor.predict({"image": np.zeros((1, 64, 64, 3), np.float32)})

  def test_polls_and_hot_reloads(self, tmp_path):
    model = pose_env_models.PoseEnvRegressionModel()
    root = str(tmp_path / "exports")
    predictor = ExportedModelPredictor(model, root, device="cpu")
    assert not predictor.restore(timeout_s=0.05)
    with pytest.raises(backoff.PollTimeout, match="exports"):
      predictor.restore(timeout_s=0.05, raise_on_timeout=True)
    for version, seed in ((5, 0), (9, 1)):
      os.makedirs(os.path.join(root, str(version)))
      tree = bridge.state_dict_to_variables(model.init_variables(
          torch.Generator().manual_seed(seed), device="cpu"))
      variables_io.save_variables(
          os.path.join(root, str(version), "variables.npz"), tree)
      assert predictor.restore()
      assert predictor.model_version == version
    # Nothing newer: a healthy poll keeps serving version 9.
    assert predictor.restore(timeout_s=0.0)
    assert predictor.model_version == 9

  def test_evaluate_policy_drives_the_predictor(self, tmp_path):
    predictor = ExportedModelPredictor(
        pose_env_models.PoseEnvRegressionModel(), str(tmp_path),
        device="cpu")
    predictor.init_randomly()
    result = eval_policy.evaluate_policy(predictor, num_episodes=4)
    assert result["num_episodes"] == 4.0
    assert np.isfinite(result["mean_reward"])


class TestVariablesIo:

  def test_reads_jax_written_bfloat16(self, tmp_path):
    from tensor2robot_tpu.export import variables_io as jax_variables_io
    values = np.random.default_rng(0).standard_normal((3, 5))
    path = str(tmp_path / "v.npz")
    jax_variables_io.save_variables(path, {
        "params": {"a": {"kernel": values.astype(jnp.bfloat16)},
                   "b": {"bias": values[0].astype(np.float32)}},
        "batch_stats": {}})
    tree = variables_io.load_variables(path)
    assert tree["params"]["a"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tree["params"]["a"]["kernel"].float().numpy(),
        values.astype(jnp.bfloat16).astype(np.float32))
    assert tree["batch_stats"] == {}
    # And back: the JAX package reads what the port writes.
    out = str(tmp_path / "w.npz")
    variables_io.save_variables(out, tree)
    again = jax_variables_io.load_variables(out)
    np.testing.assert_array_equal(
        np.asarray(again["params"]["a"]["kernel"], np.float32),
        values.astype(jnp.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(again["params"]["b"]["bias"],
                                  values[0].astype(np.float32))


class TestDeviceRule:

  def test_cpu_only_when_asked(self):
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
      assert resolve_device(None).type == "cuda"
      return
    with pytest.raises(RuntimeError, match="device='cpu'"):
      resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
      ExportedModelPredictor(pose_env_models.PoseEnvRegressionModel(), "x")
    with pytest.raises(RuntimeError, match="device='cpu'"):
      pose_env_models.PoseEnvRegressionModel().init_variables()


def test_port_imports_no_jax():
  """Every module of the port imports without JAX or the JAX package."""
  script = r"""
import json, pkgutil, importlib, sys
import tensor2robot_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
  importlib.import_module(name)
banned = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                           "ml_dtypes")
    or m == "tensor2robot_tpu" or m.startswith("tensor2robot_tpu."))
print(json.dumps({"imported": names, "banned": banned}))
"""
  env = dict(os.environ, PYTHONPATH=_REPO_ROOT)
  result = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=_REPO_ROOT, capture_output=True, text=True,
                          timeout=120, check=True)
  report = json.loads(result.stdout.strip().splitlines()[-1])
  for name in ("predictors.exported_model_predictor", "data.tfrecord",
               "data.parser", "train.checkpoints", "config.registrations",
               "bin.run_t2r_trainer", "research.pose_env.collect_data",
               "models.critic_model", "replay.smoke", "ops.graph_launches",
               "ops.stem_conv", "ops.strided_conv", "ops.pool",
               "research.qtopt.t2r_models", "research.qtopt.cem",
               "research.qtopt.synthetic_grasping",
               "bin.run_capability_checks", "replay.sum_tree",
               "replay.ring_buffer", "replay.ingest", "replay.bellman",
               "replay.loop", "replay.learner_bench", "serving.bucketing",
               "serving.policy", "obs.health", "bin.run_qtopt_replay",
               "replay.actor", "replay.actor_bench", "utils.profiling",
               "serving.fault_bench", "replay.device_buffer"):
    assert f"tensor2robot_tpu_torch.{name}" in report["imported"]
  assert report["banned"] == []
