"""The port's pose_env training slice held against the JAX package.

Same numpy inputs through both frameworks, at image 32 and batch 8 on the
CPU: the data path (episodes, preprocessor, random generator) is
bit-identical; train-mode BatchNorm, K1's analytic gradient, Adam and the
EMA agree with flax, JAX and optax; five Trainer steps from one bridged
init follow the JAX Trainer's loss stream, parameters and batch
statistics; and a model trained by the port's train_eval_model exports
variables the JAX model serves. The test marked `cuda` runs a train step
on the card against the CPU and skips without one.
"""

import importlib
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none, and runs the cuda test only
  import flax.linen as flax_nn
  import jax
  import jax.numpy as jnp
  import optax
  from tensor2robot_tpu.data import (
      default_input_generator as jax_generators,
  )
  from tensor2robot_tpu.export import variables_io as jax_variables_io
  from tensor2robot_tpu.preprocessors import (
      image_preprocessors as jax_image_preprocessors,
  )
  from tensor2robot_tpu.research.pose_env import (
      pose_env as jax_pose_env,
      pose_env_models as jax_models,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
  jax_ss = importlib.import_module("tensor2robot_tpu.ops.spatial_softmax")
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge, modes  # noqa: E402
from tensor2robot_tpu_torch.data import default_input_generator  # noqa: E402
from tensor2robot_tpu_torch.data.prefetch import (  # noqa: E402
    PrefetchExhausted,
    prefetch_to_device,
)
from tensor2robot_tpu_torch.export import export_utils  # noqa: E402
from tensor2robot_tpu_torch.export.native_export_generator import (  # noqa: E402
    NativeExportGenerator,
)
from tensor2robot_tpu_torch.layers import vision_layers  # noqa: E402
from tensor2robot_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.preprocessors import (  # noqa: E402
    image_preprocessors,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    pose_env,
    pose_env_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.train import train_eval  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils.optimizers import (  # noqa: E402
    create_adam_optimizer,
)

ss = importlib.import_module("tensor2robot_tpu_torch.ops.spatial_softmax")

# LR: both packages' default Adam rate. At 1e-3 a few conv weights whose
# gradient is near 0 end five steps more than 1e-5 apart: Adam scales the
# two sides' float32 gradient differences (flax, for one, takes the batch
# variance in one pass, E[x^2] - E[x]^2) by the step size.
IMAGE, BATCH, STEPS, LR = 32, 8, 5, 1e-4
# Port vs JAX at float32: the same sums in another order.
F32_ATOL = 1e-5
LOSS_RTOL = 1e-5
# A conv bias that feeds train-mode BatchNorm has an exact gradient of 0
# (the batch mean takes it out again), so each side's gradient is rounding
# noise, which Adam scales into full steps. One Adam step (b1 0.9, b2
# 0.999) moves a parameter by at most lr sqrt(sum_i w_i^2 / u_i), w and u
# the bias-corrected weights of the two moments: 1.011 lr up to step 5.
# So each side's bias stays within n ADAM_STEP of the start after n
# steps, and the two sides within 2 n ADAM_STEP of each other. The noise
# reaches nothing else but the running mean of the BatchNorm it feeds
# (0.01 of the bias each step), which the comparison takes out.
ADAM_STEP = 1.011 * LR
BN_FED_BIASES = ("tower.conv0.bias", "tower.conv1.bias", "tower.conv2.bias")


@pytest.fixture(autouse=True)
def _needs_jax(request):
  if jax is None and "cuda" not in request.keywords:
    pytest.skip("needs JAX, the reference")


def _models(compute_dtype="float32", **kwargs):
  """The JAX and the port's pose model with the same knobs, each with its
  default optimizer (Adam, LR)."""
  jax_model = jax_models.PoseEnvRegressionModel(
      image_size=IMAGE, compute_dtype=getattr(jnp, compute_dtype), **kwargs)
  model = pose_env_models.PoseEnvRegressionModel(
      image_size=IMAGE, compute_dtype=getattr(torch, compute_dtype), **kwargs)
  return jax_model, model


def _batches(n, seed=0):
  """n (features, labels) numpy batches of real pose_env scenes."""
  images, poses = pose_env.collect_episodes(n * BATCH, seed=seed,
                                            image_size=IMAGE)
  images = images.astype(np.float32) / 255.0
  return [({"image": images[i * BATCH:(i + 1) * BATCH]},
           {"target_pose": poses[i * BATCH:(i + 1) * BATCH]})
          for i in range(n)]


def _torch_batch(batch):
  features, labels = batch
  return ({k: torch.from_numpy(v) for k, v in features.items()},
          {k: torch.from_numpy(v) for k, v in labels.items()})


def _flat(tree):
  return {k: np.asarray(v, np.float32) for k, v in
          jax_ts.flatten_spec_structure(tree).items()}


def _conv_biases(params):
  """{BN-fed bias key: numpy copy} of a state_dict or a flax params tree."""
  if "tower" in params:
    return {key: np.array(params["tower"][key.split(".")[1]]["bias"])
            for key in BN_FED_BIASES}
  return {key: params[key].detach().numpy().copy() for key in BN_FED_BIASES}


def _assert_trees_close(got_state_dict, want_tree, steps, got_biases=(),
                        want_biases=()):
  """Every leaf within F32_ATOL, apart from the BN-fed biases' noise.

  BN-fed biases: each side within steps ADAM_STEP of its start (the first
  entry of got_biases / want_biases, the biases before each step), the
  two within twice that. Running means: compared after taking out the
  share of the two sides' different biases they took in.
  """
  got = _flat(bridge.state_dict_to_variables(
      {k: v.detach() for k, v in got_state_dict.items()}))
  want = _flat(want_tree)
  assert sorted(got) == sorted(want)
  for key in want:
    scope = ".".join(key.split("/")[1:-1])
    atol = F32_ATOL
    if key.startswith("params/") and key.endswith("/bias") and (
        f"{scope}.bias" in BN_FED_BIASES):
      atol += 2 * steps * ADAM_STEP
      for side, history in ((got, got_biases), (want, want_biases)):
        if history:
          np.testing.assert_allclose(
              side[key], history[0][f"{scope}.bias"], rtol=0,
              atol=steps * ADAM_STEP + F32_ATOL, err_msg=key)
    bias = scope.replace(".bn", ".conv") + ".bias"
    if key.endswith("/mean") and bias in BN_FED_BIASES and got_biases:
      n = len(got_biases)
      got[key] = got[key] - sum(
          0.01 * 0.99 ** (n - 1 - k) * (got_biases[k][bias]
                                        - want_biases[k][bias])
          for k in range(n))
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                               err_msg=key)


class TestDataPath:

  @pytest.mark.parametrize("seed, image_size, clutter", [
      (0, 32, True), (5, 64, True), (2, 32, False)])
  def test_collect_episodes_bit_identical(self, seed, image_size, clutter):
    kwargs = dict(seed=seed, image_size=image_size,
                  num_distractors=4 if clutter else 0, occlusion=clutter)
    images, poses = pose_env.collect_episodes(6, **kwargs)
    want_images, want_poses = jax_pose_env.collect_episodes(6, **kwargs)
    assert images.dtype == np.uint8 and poses.dtype == np.float32
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(poses, want_poses)

  def _preprocessors(self, distort, out_dtype=np.float32, seed=3):
    def make(module, spec_module):
      spec = spec_module.TensorSpecStruct({
          "image": spec_module.ExtendedTensorSpec((IMAGE, IMAGE, 3),
                                                  out_dtype, name="image"),
          "state": spec_module.ExtendedTensorSpec((2,), np.float32)})
      return module.ImagePreprocessor(
          spec, in_image_shape=(IMAGE + 8, IMAGE + 6, 3), distort=distort,
          seed=seed)
    return (make(image_preprocessors, ts),
            make(jax_image_preprocessors, jax_ts))

  def _raw(self, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (BATCH, IMAGE + 8, IMAGE + 6, 3),
                                  dtype=np.uint8),
            "state": rng.standard_normal((BATCH, 2)).astype(np.float32)}

  @pytest.mark.parametrize("mode, distort, out_dtype", [
      (modes.TRAIN, True, np.float32), (modes.TRAIN, False, np.float32),
      (modes.TRAIN, True, np.uint8), (modes.EVAL, True, np.float32),
      (modes.PREDICT, False, np.uint8)])
  def test_image_preprocessor_bit_identical(self, mode, distort, out_dtype):
    ours, theirs = self._preprocessors(distort, out_dtype)
    for seed in (0, 1):  # two batches: the streams carry on
      raw = self._raw(seed)
      got, _ = ours.preprocess(ts.TensorSpecStruct(raw), None, mode)
      want, _ = theirs.preprocess(jax_ts.TensorSpecStruct(raw), None, mode)
      assert sorted(got) == sorted(want)
      for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))

  def test_image_preprocessor_streams_follow_thread_order(self):
    ours, theirs = self._preprocessors(True)
    results = []
    for preprocessor, struct in ((ours, ts.TensorSpecStruct),
                                 (theirs, jax_ts.TensorSpecStruct)):
      out = [preprocessor.preprocess(struct(self._raw(0)), None,
                                     modes.TRAIN)[0]["image"]]
      thread = threading.Thread(target=lambda: out.append(
          preprocessor.preprocess(struct(self._raw(0)), None,
                                  modes.TRAIN)[0]["image"]))
      thread.start()
      thread.join(timeout=60)
      assert not thread.is_alive()
      results.append(out)
    # The second thread drew from stream 1, so its crops differ from the
    # main thread's on the same images; both sides hand out the same k.
    assert not np.array_equal(results[0][0], results[0][1])
    for got, want in zip(*results):
      np.testing.assert_array_equal(got, np.asarray(want))

  @pytest.mark.parametrize("mode, shard_index", [
      (modes.TRAIN, 0), (modes.TRAIN, 1), (modes.EVAL, 0)])
  def test_random_input_generator_bit_identical(self, mode, shard_index):
    jax_model, model = _models()
    streams = []
    for module, m in ((default_input_generator, model),
                      (jax_generators, jax_model)):
      generator = module.DefaultRandomInputGenerator(
          seed=4, batch_size=BATCH, shard_index=shard_index, num_shards=2)
      generator.set_specification_from_model(m, mode)
      iterator = generator.create_dataset_fn(mode)()
      streams.append([next(iterator) for _ in range(3)])
    for (features, labels), (want_f, want_l) in zip(*streams):
      assert features["image"].dtype == np.float32
      assert features["image"].shape == (BATCH, IMAGE, IMAGE, 3)
      np.testing.assert_array_equal(features["image"], want_f["image"])
      np.testing.assert_array_equal(labels["target_pose"],
                                    want_l["target_pose"])

  def test_make_random_batch_and_serialized_specs_match(self):
    def specs(module):
      return module.TensorSpecStruct({
          "a": module.ExtendedTensorSpec((3, 2), np.float32, name="a"),
          "b/c": module.ExtendedTensorSpec((4,), np.int32),
          "b/d": module.ExtendedTensorSpec((2,), np.bool_, is_optional=True),
          "e": module.ExtendedTensorSpec((5,), np.uint8, data_format="jpeg")})
    for include_optional in (True, False):
      got = ts.make_random_batch(specs(ts), 3, np.random.default_rng(7),
                                 include_optional)
      want = jax_ts.make_random_batch(specs(jax_ts), 3,
                                      np.random.default_rng(7),
                                      include_optional)
      assert list(got) == list(want)
      for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    serialized = ts.to_serialized(specs(ts))
    assert serialized == jax_ts.to_serialized(specs(jax_ts))
    assert ts.from_serialized(serialized) == specs(ts)


class TestBatchNorm:

  @pytest.mark.parametrize("shape", [(8, 5, 6, 4), (3, 7, 7, 16)])
  def test_train_mode_matches_flax(self, shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.standard_normal(c).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    want, updated = flax_nn.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    layer = vision_layers.BatchNorm(c, torch.float32)
    with torch.no_grad():
      layer.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
      layer.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
      layer.running_mean.copy_(
          torch.from_numpy(variables["batch_stats"]["mean"]))
      layer.running_var.copy_(
          torch.from_numpy(variables["batch_stats"]["var"]))
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=0, atol=F32_ATOL)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0,
                               atol=F32_ATOL)
    # 0.99 old + 0.01 batch, with the biased variance (torch's own update
    # would keep 0.9 of the old value and use the unbiased one).
    np.testing.assert_allclose(
        layer.running_var.numpy(),
        0.99 * variables["batch_stats"]["var"] + 0.01 * x.var(axis=(0, 1, 2)),
        rtol=0, atol=F32_ATOL)

  @pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
  def test_model_train_pass_matches_flax_and_keeps_variables(
      self, compute_dtype):
    jax_model, model = _models(compute_dtype)
    variables = jax.device_get(jax_model.init_variables(
        jax.random.PRNGKey(1), mode=modes.TRAIN))
    features, _ = _batches(1)[0]
    want, want_state = jax_model.inference_network_fn(
        variables, jax_ts.TensorSpecStruct(features), modes.TRAIN)
    state_dict = bridge.variables_to_state_dict(variables, model.module)
    before = {k: v.clone() for k, v in state_dict.items()}
    got, new_state = model.inference_network_fn(
        state_dict, {"image": torch.from_numpy(features["image"])},
        modes.TRAIN)
    for key, value in state_dict.items():  # the caller's, untouched
      assert torch.equal(value, before[key]), key
    assert sorted(new_state) == sorted(
        k for k in state_dict if k.endswith(("running_mean", "running_var")))
    atol = F32_ATOL if compute_dtype == "float32" else 5e-3
    np.testing.assert_allclose(
        got["inference_output"].detach().numpy(),
        np.asarray(want["inference_output"]), rtol=0, atol=atol)
    got_stats = _flat(bridge.state_dict_to_variables(new_state))
    want_stats = _flat({"batch_stats": want_state["batch_stats"]})
    assert sorted(got_stats) == sorted(want_stats)
    for key in want_stats:
      np.testing.assert_allclose(got_stats[key], want_stats[key], rtol=0,
                                 atol=F32_ATOL if compute_dtype == "float32"
                                 else 1e-3, err_msg=key)


def _pretend_kernel(monkeypatch, calls):
  """Runs K1's autograd function on the CPU: its launch returns what the
  plain version gives, computed before the count starts, and every later
  call of the plain version is counted."""
  reference = ss.spatial_softmax_reference

  def launch(features, temperature, kernel=None):
    with torch.no_grad():
      return reference(features, temperature)

  def counted(features, temperature=1.0):
    calls.append(tuple(features.shape))
    return reference(features, temperature)

  monkeypatch.setattr(ss, "_launch", launch)
  monkeypatch.setattr(ss, "spatial_softmax_reference", counted)


class TestSpatialSoftmaxGradient:

  @pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                           ("bfloat16", 2e-2)])
  @pytest.mark.parametrize("layout", ["nhwc", "nchw"])
  @pytest.mark.parametrize("temperature", [1.0, 0.5])
  def test_first_order_is_analytic_and_matches_jax(
      self, monkeypatch, dtype, atol, layout, temperature):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    g = rng.standard_normal((2, 16)).astype(np.float32)
    x_jax = jnp.asarray(x, getattr(jnp, dtype))
    g_jax = jnp.asarray(g, getattr(jnp, dtype))
    wants = []
    for implementation in ("xla", "pallas"):
      _, vjp = jax.vjp(lambda f: jax_ss.spatial_softmax(
          f, temperature, implementation=implementation), x_jax)
      wants.append(np.asarray(vjp(g_jax)[0], np.float32))
    torch_dtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(torch_dtype)
    if layout == "nchw":
      xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    xt.requires_grad_()
    calls = []
    _pretend_kernel(monkeypatch, calls)
    out = ss._SpatialSoftmaxFn.apply(xt, temperature)
    (grad,) = torch.autograd.grad(out, xt,
                                  torch.from_numpy(g).to(torch_dtype))
    assert calls == []  # the first order never runs the plain version
    assert grad.dtype == torch_dtype
    for want in wants:
      np.testing.assert_allclose(grad.float().numpy(), want, rtol=0,
                                 atol=atol)

  def test_double_backward_goes_through_the_plain_version(self,
                                                          monkeypatch):
    x = np.random.default_rng(5).standard_normal((1, 4, 4, 2)).astype(
        np.float32)
    calls = []
    _pretend_kernel(monkeypatch, calls)
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(
        torch.sum(ss._SpatialSoftmaxFn.apply(xt, 1.0) ** 3), xt,
        create_graph=True)
    torch.sum(g ** 2).backward()
    assert calls == [(1, 4, 4, 2)]
    f = lambda v: jnp.sum(jax_ss.spatial_softmax(
        v, implementation="pallas") ** 3)
    want = jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-4)


class TestAdam:

  @pytest.mark.parametrize("scale", [1e-8, 1e-6, 1.0])
  def test_eps_sits_where_optax_puts_it(self, scale):
    """At gradients near eps (1e-8) the update is g / (|g| + eps): eps
    outside the square root, in optax and in torch alike."""
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal(6) * 1e-3).astype(np.float32)
    grads = [(rng.standard_normal(6) * scale).astype(np.float32)
             for _ in range(3)]
    tx = optax.adam(LR)
    params, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.from_numpy(p0.copy()).requires_grad_()
    optimizer = create_adam_optimizer(LR)([p])
    for i, grad in enumerate(grads):
      updates, opt_state = tx.update(jnp.asarray(grad), opt_state, params)
      params = optax.apply_updates(params, updates)
      p.grad = torch.from_numpy(grad)
      optimizer.step()
      np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                 rtol=0, atol=1e-7)
      if i == 0 and scale == 1e-8:  # half a step: |g| and eps compare
        moved = np.abs(p.detach().numpy() - p0) / LR
        want = np.abs(grads[0]) / (np.abs(grads[0]) + 1e-8)
        np.testing.assert_allclose(moved, want, rtol=1e-3)


def _spatial_softmax64(features, temperature=1.0):
  """K1's plain version in the input's dtype (float64 here)."""
  b, h, w, c = features.shape
  attention = torch.softmax(features.permute(0, 3, 1, 2).reshape(
      b, c, h * w) / temperature, dim=-1).reshape(b, c, h, w)
  xs = torch.linspace(-1.0, 1.0, w, dtype=features.dtype)
  ys = torch.linspace(-1.0, 1.0, h, dtype=features.dtype)
  return torch.cat([torch.sum(attention * xs, dim=(2, 3)),
                    torch.sum(attention * ys[:, None], dim=(2, 3))], dim=-1)


def _jax_run(jax_model, batches):
  """The JAX Trainer over `batches`: (trainer, initial variables, losses,
  final state, BN-fed biases before each step)."""
  trainer = JaxTrainer(jax_model, seed=0)
  state = trainer.create_train_state()
  initial = jax.device_get(state.variables())
  losses, biases = [], []
  for features, labels in batches:
    biases.append(_conv_biases(jax.device_get(state.params)))
    sharded = trainer.shard_batch((jax_ts.TensorSpecStruct(features),
                                   jax_ts.TensorSpecStruct(labels)))
    state, metrics = trainer.train_step(state, *sharded)
    losses.append(float(metrics["loss"]))
  return trainer, initial, losses, state, biases


def _port_run(trainer, state, batches):
  losses, biases = [], []
  for batch in batches:
    biases.append(_conv_biases(state.params))
    state, metrics = trainer.train_step(state, *_torch_batch(batch))
    losses.append(float(metrics["loss"]))
  return state, losses, biases


class TestTrainer:

  def test_five_steps_match_the_jax_trainer(self):
    jax_model, model = _models()
    batches = _batches(STEPS)
    _, initial, want_losses, want_state, want_biases = _jax_run(
        jax_model, batches)
    trainer = Trainer(model, device="cpu")
    state, losses, biases = _port_run(
        trainer, trainer.create_train_state(initial), batches)
    assert state.step == STEPS == int(want_state.step)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_trees_close(state.variables(),
                        jax.device_get(want_state.variables()), STEPS,
                        biases, want_biases)

  def test_ema_matches_optax_incremental_update(self):
    jax_model, model = _models(use_avg_model_params=True,
                               avg_model_params_decay=0.5)
    batches = _batches(3, seed=1)
    _, initial, _, want_state, _ = _jax_run(jax_model, batches)
    trainer = Trainer(model, device="cpu")
    state, _, _ = _port_run(trainer, trainer.create_train_state(initial),
                            batches)
    assert state.ema_params is not None
    _assert_trees_close(state.ema_params,
                        {"params": jax.device_get(want_state.ema_params)}, 3)
    # The EMA is the rule itself on the port's own parameters (updated in
    # place: keep copies of the old values).
    previous = {key: ema.clone() for key, ema in state.ema_params.items()}
    state, _ = trainer.train_step(state, *_torch_batch(batches[0]))
    for key, ema in state.ema_params.items():
      torch.testing.assert_close(
          ema, 0.5 * state.params[key].detach() + 0.5 * previous[key],
          rtol=0, atol=1e-7)

  def test_eval_and_predict_match_jax(self):
    """On the JAX Trainer's state after two steps, bridged: the BN-fed
    biases' noise would shift running-average outputs on its own."""
    jax_model, model = _models(use_avg_model_params=True,
                               avg_model_params_decay=0.9)
    batches = _batches(3, seed=2)
    jax_trainer, _, _, want_state, _ = _jax_run(jax_model, batches[:2])
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(
        jax.device_get(want_state.variables()))
    state.ema_params = bridge.params_to_state_dict(
        jax.device_get(want_state.ema_params), model.module)
    assert list(state.ema_params) == list(state.params)
    features, labels = batches[2]
    want = jax_trainer.eval_step(want_state, *jax_trainer.shard_batch(
        (jax_ts.TensorSpecStruct(features), jax_ts.TensorSpecStruct(labels))))
    got = trainer.eval_step(state, *_torch_batch(batches[2]))
    assert sorted(got) == sorted(want)
    for key in want:
      assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)
    predict = trainer.predict_fn(state)
    out = predict({"image": torch.from_numpy(features["image"])})
    state, _ = trainer.train_step(state, *_torch_batch(batches[0]))
    again = predict({"image": torch.from_numpy(features["image"])})
    torch.testing.assert_close(out["inference_output"],
                               again["inference_output"])  # a snapshot
    want_out = jax_trainer.predict_fn(want_state)(
        jax_ts.TensorSpecStruct(features))["inference_output"]
    np.testing.assert_allclose(out["inference_output"].numpy(),
                               np.asarray(want_out), rtol=0, atol=F32_ATOL)

  def test_float32_gradients_match_float64(self):
    """On chip_smoke's first float32 batch (64 scenes at 64x64), each
    tensor's float32 gradients lie within 1e-3 of its largest from the
    float64 ones (the conv biases that feed BatchNorm are pure noise).
    PyTorch's CPU batch norm on a channels-last map alone puts them a
    tenth of the largest away, so train-mode BatchNorm hands it a
    contiguous one."""
    images, poses = pose_env.collect_episodes(300, seed=0)
    idx = np.random.default_rng(3).choice(300, 64, replace=False)
    features = {"image": torch.from_numpy(images[idx].astype(np.float32)
                                          / 255.0)}
    labels = {"target_pose": torch.from_numpy(poses[idx])}
    model = pose_env_models.PoseEnvRegressionModel(
        compute_dtype=torch.float32)
    init = Trainer(model, device="cpu").create_train_state().variables()

    def grads(dtype):
      model = pose_env_models.PoseEnvRegressionModel(compute_dtype=dtype,
                                                     param_dtype=dtype)
      state = Trainer(model, device="cpu").create_train_state(
          {k: v.detach().to(dtype) for k, v in init.items()})
      loss, _ = model.model_train_fn(
          state.variables(), {k: v.to(dtype) for k, v in features.items()},
          {k: v.to(dtype) for k, v in labels.items()})
      loss.backward()
      return {k: p.grad.double() for k, p in state.params.items()}

    def batch_norm64(self, x, train=False):
      return torch.nn.functional.batch_norm(
          x.double(), None, None, self.weight, self.bias, training=True,
          eps=1e-5)

    want32 = grads(torch.float32)
    with pytest.MonkeyPatch.context() as patch:  # float64 end to end
      patch.setattr(vision_layers.BatchNorm, "forward", batch_norm64)
      patch.setattr(vision_layers, "fused_spatial_softmax",
                    _spatial_softmax64)
      want64 = grads(torch.float64)
    shares = {key: float((want32[key] - want64[key]).abs().max()
                         / want64[key].abs().max())
              for key in want64 if key not in BN_FED_BIASES}
    assert max(shares.values()) <= 1e-3, shares

  def test_bridge_maps_an_ema_tree(self):
    jax_model, model = _models()
    params = jax.device_get(jax_model.init_variables(
        jax.random.PRNGKey(2))["params"])
    state = bridge.params_to_state_dict(params, model.module)
    assert list(state) == [k for k, _ in model.module.named_parameters()]
    np.testing.assert_array_equal(state["head.fc0.weight"].numpy(),
                                  params["head"]["fc0"]["kernel"].T)
    back = bridge.state_dict_to_variables(state)
    assert sorted(back) == ["params"]
    del params["tower"]["bn1"]["scale"]
    with pytest.raises(KeyError, match="tower.bn1.weight"):
      bridge.params_to_state_dict(params, model.module)

  def test_create_train_state_from_seed_or_state_dict(self):
    _, model = _models()
    first = Trainer(model, seed=3, device="cpu").create_train_state()
    again = Trainer(model, seed=3, device="cpu").create_train_state()
    other = Trainer(model, seed=4, device="cpu").create_train_state()
    names = [name for name, _ in model.module.named_parameters()]
    assert list(first.params) == names
    assert all(p.requires_grad and p.is_leaf for p in first.params.values())
    assert sorted(first.model_state) == sorted(
        name for name, _ in model.module.named_buffers())
    assert first.step == 0 and first.ema_params is None
    for key in names:
      assert torch.equal(first.params[key], again.params[key])
    assert not torch.equal(first.params["tower.conv0.weight"],
                           other.params["tower.conv0.weight"])
    copied = Trainer(model, device="cpu").create_train_state(
        first.variables())
    assert copied.params["head.pose.weight"] is not (
        first.params["head.pose.weight"])
    with pytest.raises(KeyError, match="head.pose.bias"):
      variables = dict(first.variables())
      del variables["head.pose.bias"]
      Trainer(model, device="cpu").create_train_state(variables)


class TestPrefetch:

  def _stream(self, n):
    for i in range(n):
      yield (ts.TensorSpecStruct({"image": np.full((2, 3), i, np.float32)}),
             {"pose": np.arange(2, dtype=np.int64) + i})

  @pytest.mark.parametrize("depth", [1, 2, 4])
  def test_order_and_values(self, depth):
    got = list(prefetch_to_device(self._stream(5), device="cpu",
                                  depth=depth))
    assert len(got) == 5
    for i, (features, labels) in enumerate(got):
      assert isinstance(features, ts.TensorSpecStruct)
      assert features["image"].dtype == torch.float32
      torch.testing.assert_close(features["image"],
                                 torch.full((2, 3), float(i)))
      assert labels["pose"].tolist() == [i, i + 1]

  def test_keeps_depth_batches_ahead(self):
    pulled = []

    def stream():
      for i in range(4):
        pulled.append(i)
        yield {"x": np.zeros(1) + i}

    iterator = prefetch_to_device(stream(), device="cpu", depth=3)
    first = next(iterator)
    assert float(first["x"]) == 0.0 and pulled == [0, 1, 2]

  def test_exhaustion(self):
    iterator = prefetch_to_device(self._stream(3), device="cpu", depth=2,
                                  name="train", exhaust_error=True)
    for _ in range(3):
      next(iterator)
    with pytest.raises(PrefetchExhausted, match="'train' exhausted after 3"):
      next(iterator)
    with pytest.raises(ValueError, match="depth"):
      next(prefetch_to_device(self._stream(1), device="cpu", depth=0))


class TestTrainEval:

  def test_exports_what_the_jax_model_serves(self, tmp_path):
    jax_model, model = _models()
    root = str(tmp_path / "exports")
    result = train_eval.train_eval_model(
        model,
        input_generator_train=default_input_generator
        .DefaultRandomInputGenerator(batch_size=BATCH, seed=1),
        input_generator_eval=default_input_generator
        .DefaultRandomInputGenerator(batch_size=BATCH, seed=2),
        max_train_steps=10, eval_steps=2, eval_interval_steps=5,
        log_every_steps=5, export_generator=NativeExportGenerator(root),
        device="cpu")
    assert result.state.step == 10
    assert set(result.train_metrics) == {"loss", "mse", "mean_pose_error"}
    assert set(result.eval_metrics) == {"loss", "mse", "mean_pose_error"}
    assert all(np.isfinite(v) for v in result.eval_metrics.values())
    assert sorted(os.listdir(result.export_dir)) == [
        "serving_fn.pt2", "t2r_assets.json", "t2r_assets.pb",
        "variables.npz"]
    _, _, extra = export_utils.read_spec_assets(result.export_dir)
    assert extra["format"] == "torch_export_pt2"
    assert extra["feature_keys"] == ["image"]

    images = _batches(1, seed=3)[0][0]["image"]
    tree = jax_variables_io.load_variables(
        os.path.join(result.export_dir, "variables.npz"))
    want = jax_model.predict_fn(tree, jax_ts.TensorSpecStruct(
        {"image": images}))["inference_output"]
    predictor = ExportedModelPredictor(model, root, device="cpu")
    assert predictor.restore()
    got = predictor.predict({"image": images})["inference_output"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    # The export holds the trained state, batch statistics included.
    trained = result.state.variables()
    for key, value in bridge.variables_to_state_dict(
        tree, model.module).items():
      torch.testing.assert_close(value, trained[key].detach())

  def test_export_keeps_the_newest_versions(self, tmp_path):
    _, model = _models()
    generator = NativeExportGenerator(str(tmp_path / "exports"))
    generator.set_specification_from_model(model)
    variables = Trainer(model, device="cpu").create_train_state().variables()
    dirs = [export_utils.export_and_gc(
        generator, export_utils.fetch_variables_to_host(variables), keep=2,
        global_step=step) for step in range(3)]
    versions = export_utils.list_export_versions(generator.export_root)
    assert [int(os.path.basename(d)) for d in dirs[1:]] == versions
    assert not os.path.exists(dirs[0])
    with pytest.raises(FileExistsError, match="clobber"):
      export_utils.publish(dirs[1], dirs[2])
    with pytest.raises(ValueError, match="export_root"):
      export_utils.resolve_export_root(NativeExportGenerator(), None)

  @pytest.mark.parametrize("name, value", [
      ("model_dir", "run"), ("create_exporters_fn", lambda m: []),
      ("hook_builders", [type("NoHooks", (), {
          "create_hooks": lambda self, trainer, model_dir: []})()]),
      ("iterations_per_loop", 50),
      ("gradient_accumulation_steps", 2), ("mesh", "one rank"),
      ("param_specs", {}), ("shard_optimizer_state", True), ("fsdp", True)])
  def test_what_waits_raises(self, name, value, tmp_path):
    _, model = _models()
    if name == "model_dir":  # no longer waits: the run directory is written
      train_eval.train_eval_model(model, max_train_steps=0, device="cpu",
                                  model_dir=str(tmp_path / value))
      assert os.path.isfile(tmp_path / value / "operative_config.txt")
      assert os.listdir(tmp_path / value / "checkpoints") == ["0"]
      return
    if name == "mesh":
      value = create_mesh({"data": 1})
    if name in ("iterations_per_loop", "gradient_accumulation_steps",
                "create_exporters_fn", "hook_builders", "mesh",
                "param_specs", "shard_optimizer_state", "fsdp"):
      # No longer wait: tests/test_torch_train_steps.py trains with the
      # first two, tests/test_torch_harness.py drives the next two, and
      # tests/test_torch_parallel_train.py the parallel tier's over ranks
      # (on this one process they lay out nothing).
      result = train_eval.train_eval_model(model, max_train_steps=0,
                                           device="cpu", **{name: value})
      assert result.state.step == 0
      return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
      train_eval.train_eval_model(model, max_train_steps=0, device="cpu",
                                  **{name: value})


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
  """One float32 step (TF32 off) from one init on the card and on the CPU:
  the same loss and statistics, gradients within 1e-3 of each tensor's
  largest. Adam's first step is lr g / (|g| + eps), a step of lr however
  small g is, so an element whose gradient lies within that much of 0 may
  step the other way; every other element must agree."""
  model = pose_env_models.PoseEnvRegressionModel(
      image_size=IMAGE, compute_dtype=torch.float32)
  batch = _batches(1)[0]
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  runs = []
  for device in (cuda_device, torch.device("cpu")):
    trainer = Trainer(model, seed=0, device=device)
    features, labels = _torch_batch(batch)
    before = ss.spatial_softmax.launches
    state, metrics = trainer.train_step(
        trainer.create_train_state(),
        {k: v.to(device) for k, v in features.items()},
        {k: v.to(device) for k, v in labels.items()})
    if device.type == "cuda":
      assert ss.spatial_softmax.launches == before + 1
    runs.append((float(metrics["loss"]), state))
  (gpu_loss, gpu), (cpu_loss, cpu) = runs
  assert gpu_loss == pytest.approx(cpu_loss, rel=1e-4)
  for key, value in cpu.model_state.items():
    torch.testing.assert_close(gpu.model_state[key].cpu(), value, rtol=0,
                               atol=1e-4)
  for key, param in cpu.params.items():
    grad = param.grad.abs()
    noise = grad <= 1e-3 * grad.max()
    if key in BN_FED_BIASES:
      noise[:] = True
    else:
      assert float((gpu.params[key].grad.cpu() - param.grad).abs().max()) <= (
          1e-3 * float(grad.max())), key
    err = (gpu.params[key].detach().cpu() - param.detach()).abs()
    assert float(torch.where(noise, 0.0, err).max()) <= 1e-4, key
    assert float(err.max()) <= 2 * ADAM_STEP + 1e-4, key
