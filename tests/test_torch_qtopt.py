"""The port's QT-Opt critic slice held against the JAX package.

Same numpy inputs, made from seeds, through both frameworks on the CPU at
float32: the critic's loss and metrics, the TinyQ critic and every option
of the grasping critic through the weight bridge (logits, updated batch
statistics, gradients), the three TPU rewrites as torch functions and the
SAME padding of the stride-2 convolutions, the synthetic grasping task
(bit-identical arrays and records), and CEM with the JAX package's own
noise injected.

Tolerances: float32 logits and losses within 1e-4 at 64x64 and 1e-3 at
472x472 (the same sums in another order, over 4x and 54x more pixels);
gradients within 1e-3 of each tensor's largest; the ops within 1e-5;
CEM means within 1e-5 (the same elites, summed in the same order).
"""

import hashlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none, and runs the cuda test only
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.data import tfrecord as jax_tfrecord
  from tensor2robot_tpu.ops import (
      pool as jax_pool,
      stem_conv as jax_stem_conv,
      strided_conv as jax_strided_conv,
  )
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.research.qtopt import (
      cem as jax_cem,
      synthetic_grasping as jax_sg,
      t2r_models as jax_models,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge, modes  # noqa: E402
from tensor2robot_tpu_torch.data import tfrecord  # noqa: E402
from tensor2robot_tpu_torch.layers import vision_layers  # noqa: E402
from tensor2robot_tpu_torch.ops import (  # noqa: E402
    pool,
    stem_conv,
    strided_conv,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.replay import smoke  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    cem,
    synthetic_grasping as sg,
    t2r_models,
)

LOGIT_ATOL = {64: 1e-4, 472: 1e-3}
GRAD_SHARE = 1e-3
OP_ATOL = 1e-5
CEM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _needs_jax(request):
  if jax is None and "cuda" not in request.keywords:
    pytest.skip("needs JAX, the reference")


def _flat(tree):
  return {k: np.asarray(v, np.float32) for k, v in
          jax_ts.flatten_spec_structure(tree).items()}


def _randomize_stats(variables, seed):
  """Batch statistics and biases off init's zeros and ones: a swapped
  mapping shows."""
  rng = np.random.default_rng(seed)

  def walk(tree, path=()):
    out = {}
    for key, value in tree.items():
      if isinstance(value, dict):
        out[key] = walk(value, path + (key,))
      elif key == "var":
        out[key] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
      elif key in ("mean", "bias", "scale", "stem_s2d_bias"):
        out[key] = (np.asarray(value)
                    + 0.2 * rng.standard_normal(value.shape)).astype(
                        np.float32)
      else:
        out[key] = np.asarray(value)
    return out

  return walk(jax.device_get(variables))


def _torch_features(features):
  return {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in features.items()}


class TestCriticModel:

  @pytest.mark.parametrize("loss_type", ["cross_entropy", "mse"])
  def test_loss_and_metrics_match_jax(self, loss_type):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (64,)).astype(np.float32)
    targets = (rng.random(64) < 0.4).astype(np.float32)
    targets[:8] = rng.random(8)  # Bellman targets need not be 0 or 1
    jax_model = jax_smoke.TinyQCriticModel(loss_type=loss_type)
    model = smoke.TinyQCriticModel(loss_type=loss_type)
    want_loss, want = jax_model.loss_fn(
        {"q_predicted": jnp.asarray(logits)}, None,
        {"target_q": jnp.asarray(targets)})
    loss, got = model.loss_fn({"q_predicted": torch.from_numpy(logits)},
                              None, {"target_q": torch.from_numpy(targets)})
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert sorted(got) == sorted(want)
    for key in want:
      assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6,
                                              abs=1e-7), key
    q = model.q_value({"q_predicted": torch.from_numpy(logits)})
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jax_model.q_value(
            {"q_predicted": jnp.asarray(logits)})), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="requires labels"):
      model.loss_fn({"q_predicted": torch.from_numpy(logits)}, None, None)

  def test_unknown_loss_type_raises(self):
    with pytest.raises(ValueError, match="loss_type"):
      smoke.TinyQCriticModel(loss_type="hinge")


def _tiny_pair(seed=0, batch=8):
  jax_model = jax_smoke.TinyQCriticModel()
  model = smoke.TinyQCriticModel()
  rng = np.random.default_rng(seed)
  features = {
      "image": rng.integers(0, 256, (batch, 16, 16, 3), np.uint8),
      "action": rng.uniform(-1, 1, (batch, 4)).astype(np.float32)}
  variables = jax.device_get(jax_model.module.init(
      jax.random.key(seed), jax_ts.TensorSpecStruct(features), "train"))
  variables = _randomize_stats(variables, seed)
  return jax_model, model, features, variables


class TestTinyQ:

  def test_logits_encode_and_q_from_code_match_jax(self):
    jax_model, model, features, variables = _tiny_pair()
    state = bridge.variables_to_state_dict(variables, model.module)
    want = jax_model.predict_fn(variables, jax_ts.TensorSpecStruct(features))
    got = model.predict_fn(state, _torch_features(features))
    np.testing.assert_allclose(got["q_predicted"].numpy(),
                               np.asarray(want["q_predicted"]), rtol=0,
                               atol=OP_ATOL)
    jax_encode, jax_q = jax_model.factored_cem_fns()
    encode, q_from_code = model.factored_cem_fns()
    code = encode(state, _torch_features(features))
    want_code = jax_encode(variables, jax_ts.TensorSpecStruct(features))
    np.testing.assert_allclose(code.detach().numpy(), np.asarray(want_code),
                               rtol=0, atol=OP_ATOL)
    actions = np.random.default_rng(1).uniform(-1, 1, (8, 4)).astype(
        np.float32)
    got_q = q_from_code(state, {"image": code,
                                "action": torch.from_numpy(actions)})
    want_q = jax_q(variables, {"image": want_code,
                               "action": jnp.asarray(actions)})
    np.testing.assert_allclose(got_q["q_predicted"].detach().numpy(),
                               np.asarray(want_q["q_predicted"]), rtol=0,
                               atol=OP_ATOL)
    # The factored pair composed is the module's forward.
    np.testing.assert_array_equal(
        q_from_code(state, {"image": code,
                            "action": torch.from_numpy(
                                features["action"])})["q_predicted"]
        .detach().numpy(), got["q_predicted"].numpy())

  def test_floating_image_keeps_its_dtype(self):
    _, model, features, variables = _tiny_pair()
    state = bridge.variables_to_state_dict(variables, model.module)
    encode, _ = model.factored_cem_fns()
    image = torch.from_numpy(features["image"]).to(torch.bfloat16)
    code = encode({k: v.to(torch.bfloat16) for k, v in state.items()},
                  {"image": image})
    assert code.dtype == torch.bfloat16
    assert encode(state, {"image": torch.from_numpy(
        features["image"])}).dtype == torch.float32


def _grasping_pair(size, batch=2, **kwargs):
  jax_model = jax_models.QTOptGraspingModel(
      image_size=size, compute_dtype=jnp.float32, **kwargs)
  model = t2r_models.QTOptGraspingModel(
      image_size=size, compute_dtype=torch.float32, **kwargs)
  rng = np.random.default_rng(size)
  image = rng.random((batch, size, size, 3)).astype(np.float32)
  if kwargs.get("uint8_images"):
    image = (image * 255).astype(np.uint8)
  features = {"image": image,
              "action": rng.uniform(-1, 1, (batch, 4)).astype(np.float32)}
  if kwargs.get("state_size"):
    features["state"] = rng.normal(
        0, 1, (batch, kwargs["state_size"])).astype(np.float32)
  labels = {"target_q": (rng.random(batch) < 0.5).astype(np.float32)}
  variables = jax.device_get(jax_model.module.init(
      jax.random.key(1), jax_ts.TensorSpecStruct(features), "train"))
  return (jax_model, model, features, labels,
          _randomize_stats(variables, size))


def _compare_forward(size, mode, **kwargs):
  jax_model, model, features, _, variables = _grasping_pair(size, **kwargs)
  want, want_state = jax_model.inference_network_fn(
      variables, jax_ts.TensorSpecStruct(features), mode)
  state = bridge.variables_to_state_dict(variables, model.module)
  got, got_state = model.inference_network_fn(
      state, _torch_features(features), mode)
  atol = LOGIT_ATOL[size]
  np.testing.assert_allclose(got["q_predicted"].detach().numpy(),
                             np.asarray(want["q_predicted"]), rtol=0,
                             atol=atol)
  if mode == modes.TRAIN and kwargs.get("norm", "batch") == "batch":
    got_stats = _flat(bridge.state_dict_to_variables(got_state))
    want_stats = _flat({"batch_stats": want_state["batch_stats"]})
    assert sorted(got_stats) == sorted(want_stats)
    for key in want_stats:
      np.testing.assert_allclose(got_stats[key], want_stats[key], rtol=0,
                                 atol=atol, err_msg=key)
  else:
    assert not got_state


_OPTIONS = [dict(norm=n, stem=s, impl=i) for n, s, i in itertools.product(
    ("batch", "group"), ("conv", "space_to_depth"), ("parity", "fast"))]
_OPTIONS += [dict(state_size=3), dict(uint8_images=True),
             dict(uint8_images=True, stem="space_to_depth", impl="fast")]


class TestGraspingModel:

  @pytest.mark.parametrize("mode", [modes.TRAIN, modes.EVAL])
  @pytest.mark.parametrize("options", _OPTIONS,
                           ids=lambda o: "-".join(f"{k}={v}"
                                                  for k, v in o.items()))
  def test_forward_at_64_matches_jax(self, options, mode):
    _compare_forward(64, mode, **options)

  @pytest.mark.parametrize("mode", [modes.TRAIN, modes.EVAL])
  def test_forward_at_472_matches_jax(self, mode):
    _compare_forward(472, mode)

  @pytest.mark.parametrize("options", [
      dict(), dict(norm="group", stem="space_to_depth", impl="fast")],
      ids=["default", "group-s2d-fast"])
  def test_gradients_at_64_match_jax(self, options):
    jax_model, model, features, labels, variables = _grasping_pair(
        64, batch=4, **options)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
      loss, _ = jax_model.model_train_fn(
          {"params": p, **rest}, jax_ts.TensorSpecStruct(features),
          jax_ts.TensorSpecStruct(labels))
      return loss

    want = _flat({"params": jax.grad(loss_fn)(params)})
    state = bridge.variables_to_state_dict(variables, model.module)
    names = {name for name, _ in model.module.named_parameters()}
    for name in names:
      state[name] = state[name].clone().requires_grad_()
    loss, _ = model.model_train_fn(state, _torch_features(features),
                                   _torch_features(labels))
    loss.backward()
    got = _flat(bridge.state_dict_to_variables(
        {name: state[name].grad for name in names}))
    assert sorted(got) == sorted(want)
    largest = max(np.abs(v).max() for v in want.values())
    for key, value in want.items():
      # A conv bias that feeds train-mode BatchNorm has an exact gradient
      # of 0: both sides give rounding noise, held to the model's scale.
      scale = np.abs(value).max()
      if options.get("norm", "batch") == "batch" and key.endswith(
          "/bias") and ("conv" in key or key.startswith("params/stem/")):
        scale = largest
      np.testing.assert_allclose(got[key], value, rtol=0,
                                 atol=GRAD_SHARE * scale, err_msg=key)

  def test_bridge_round_trip_and_refusals(self):
    _, model, _, _, variables = _grasping_pair(
        64, stem="space_to_depth", norm="group", impl="fast")
    state = bridge.variables_to_state_dict(variables, model.module)
    assert tuple(state["stem_s2d_kernel"].shape) == (8, 2, 12, 64)
    assert "stem_bn.weight" in state and "post_conv2.weight" in state
    back = _flat(bridge.state_dict_to_variables(state))
    want = _flat(variables)
    assert sorted(back) == sorted(want)
    for key in want:
      np.testing.assert_array_equal(back[key], want[key])
    extra = {**variables,
             "params": {**variables["params"], "stem_extra": np.zeros(3)}}
    with pytest.raises(KeyError, match="stem_extra"):
      bridge.variables_to_state_dict(extra, model.module)
    with pytest.raises(KeyError, match="no flax counterpart"):
      bridge.state_dict_to_variables({"stem_bogus": torch.zeros(2)})
    missing = {**variables, "params": {
        k: v for k, v in variables["params"].items() if k != "stem_s2d_bias"}}
    with pytest.raises(KeyError, match="stem_s2d_bias"):
      bridge.variables_to_state_dict(missing, model.module)

  def test_options_and_parallel_tier_refusals(self):
    with pytest.raises(ValueError, match="impl"):
      t2r_models.QTOptGraspingModel(impl="turbo")
    with pytest.raises(ValueError, match="wire_format"):
      t2r_models.QTOptGraspingModel(wire_format="png")
    rules = t2r_models.QTOptGraspingModel().partition_rules()
    assert rules[-1][0] == ".*" and rules[-1][1] == ()
    model = t2r_models.QTOptGraspingModel(image_size=64, state_size=2,
                                          uint8_images=True)
    spec = model.get_feature_specification(modes.TRAIN)
    assert spec["image"].dtype == np.uint8 and spec["state"].shape == (2,)
    assert model.preprocessor.get_in_feature_specification(
        modes.TRAIN)["image"].data_format == "jpeg"


class TestRewrites:

  @pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 18, 22, 3),
                                     (2, 64, 64, 4)])
  def test_folded_s2d_stem(self, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.1, (8, 2, 4 * shape[3], 5)).astype(np.float32)
    want = jax_stem_conv.folded_s2d_stem(jnp.asarray(x), jnp.asarray(w))
    got = stem_conv.folded_s2d_stem(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_ATOL)
    init = stem_conv.init_folded_stem_weights(
        3, 64, torch.Generator().manual_seed(0))
    assert tuple(init.shape) == (8, 2, 12, 64)
    assert float(init.std()) == pytest.approx(1 / np.sqrt(192), rel=0.05)

  @pytest.mark.parametrize("size", [59, 30, 15, 8, 16, 4, 7])
  def test_strided3x3_same(self, size):
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size + 1, 6)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, 6, 5)).astype(np.float32)
    want = jax_strided_conv.strided3x3_same(jnp.asarray(x), jnp.asarray(w))
    got = strided_conv.strided3x3_same(torch.from_numpy(x),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_ATOL)
    np.testing.assert_array_equal(
        strided_conv.fold_strided3x3_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jax_strided_conv.fold_strided3x3_weights(jnp.asarray(w))))

  @pytest.mark.parametrize("window", [2, 4])
  def test_max_pool_reshape(self, window):
    rng = np.random.default_rng(window)
    x = rng.normal(0, 1, (2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pool.max_pool_reshape(torch.from_numpy(x), window).numpy(),
        np.asarray(jax_pool.max_pool_reshape(jnp.asarray(x), window)))
    with pytest.raises(ValueError, match="divisible"):
      pool.max_pool_reshape(torch.zeros(1, 5, 4, 1))

  def test_max_pool_reshape_gradient_splits_ties(self):
    x = torch.zeros(1, 2, 2, 1, requires_grad=True)
    pool.max_pool_reshape(x).sum().backward()
    want = jax.grad(lambda v: jax_pool.max_pool_reshape(v).sum())(
        jnp.zeros((1, 2, 2, 1)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want))

  @pytest.mark.parametrize("size, kernel, stride, pads", [
      (472, 6, 4, (1, 1)), (128, 6, 4, (1, 1)),
      (59, 3, 2, (1, 1)), (30, 3, 2, (0, 1)), (15, 3, 2, (1, 1)),
      (16, 3, 2, (0, 1)), (8, 3, 2, (0, 1)), (4, 3, 2, (0, 1))])
  def test_same_padding_of_strided_convs(self, size, kernel, stride, pads):
    """XLA's SAME puts the odd pixel at the high end: torch's symmetric
    padding would shift every output of the even sizes by one pixel."""
    assert vision_layers.same_padding((size, size), kernel, stride) == (
        pads + pads)
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (1, size, size, 3)).astype(np.float32)
    w = rng.normal(0, 0.2, (kernel, kernel, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = vision_layers.Conv(3, 4, kernel, stride, torch.float32)
    with torch.no_grad():
      conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
      conv.bias.zero_()
      got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_ATOL)


class TestSyntheticGrasping:

  @pytest.mark.parametrize("seed, size, clutter", [(0, 64, True),
                                                   (3, 128, True),
                                                   (5, 16, False)])
  def test_generate_grasps_bit_identical(self, seed, size, clutter):
    kwargs = dict(image_size=size, seed=seed,
                  num_distractors=4 if clutter else 0, occlusion=clutter)
    got = sg.generate_grasps(24, **kwargs)
    want = jax_sg.generate_grasps(24, **kwargs)
    for a, b in zip(got, want):
      assert a.dtype == b.dtype
      np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        sg.grasp_success(want[1][:, :2], want[1]),
        jax_sg.grasp_success(want[1][:, :2], want[1]))

  def test_first_16_records_sha256_equal(self, tmp_path):
    digests = []
    for module, reader in ((sg, tfrecord), (jax_sg, jax_tfrecord)):
      path = str(tmp_path / f"{module.__name__.split('.')[0]}.tfrecord")
      module.write_tfrecords(path, 20, image_size=64, seed=0)
      digest = hashlib.sha256()
      for _, record in zip(range(16), reader.read_tfrecords(path)):
        digest.update(record)
      digests.append(digest.hexdigest())
    assert digests[0] == digests[1]

  def test_retry_and_vector_envs_match_jax(self):
    rng = np.random.default_rng(0)
    envs = [sg.GraspRetryEnv(image_size=32, max_attempts=2),
            jax_sg.GraspRetryEnv(image_size=32, max_attempts=2)]
    for seed in range(3):
      images = [env.reset(seed) for env in envs]
      np.testing.assert_array_equal(*images)
      for _ in range(2):
        action = rng.uniform(-1, 1, 4).astype(np.float32)
        assert envs[0].step(action) == envs[1].step(action)
    vectors = [sg.VectorGraspEnv(4, image_size=32),
               jax_sg.VectorGraspEnv(4, image_size=32)]
    for env in vectors:
      env.reset([10, 11, 12, 13])
    np.testing.assert_array_equal(vectors[0].images, vectors[1].images)
    counters = [iter(range(100, 200)), iter(range(100, 200))]
    for _ in range(5):
      actions = np.concatenate(
          [vectors[0].targets + rng.normal(0, 0.2, (4, 2)),
           rng.uniform(-1, 1, (4, 2))], axis=1).astype(np.float32)
      outs = [env.step(actions, seed_fn=lambda c=c: next(c))
              for env, c in zip(vectors, counters)]
      for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
      np.testing.assert_array_equal(vectors[0].images, vectors[1].images)
    assert (vectors[0].episodes, vectors[0].successes) == (
        vectors[1].episodes, vectors[1].successes)

  def test_evaluate_grasp_policy_paths_agree(self):
    def policy(image):  # deterministic per image, batched or not
      image = np.asarray(image, np.float32)
      mean = image.mean(axis=(-3, -2))
      return np.concatenate([mean[..., :2] * 2 - 1, mean[..., 2:3],
                             np.zeros_like(mean[..., :1])], axis=-1)

    kwargs = dict(num_scenes=12, image_size=32, seed=7)
    scalar = sg.evaluate_grasp_policy(policy, **kwargs)
    assert sg.evaluate_grasp_policy(policy, vectorized=True,
                                    **kwargs) == scalar
    assert jax_sg.evaluate_grasp_policy(policy, **kwargs) == scalar


def _jax_noise(key, iterations, samples, action_size=4):
  return np.stack([np.asarray(jax.random.normal(
      jax.random.fold_in(key, i), (samples, action_size)))
                   for i in range(iterations)])


class _QuadraticPredictor:
  """Numpy Q: a smooth bump around an image-dependent target, the same
  scores for both packages (no ties among continuous samples)."""

  def __init__(self):
    self.weights = np.array([1.0, 0.7, 0.3, 0.1], np.float32)

  def target(self, image):
    mean = np.asarray(image, np.float32).mean(axis=(-3, -2))
    return np.concatenate([mean[..., :3] * 1.6 - 0.8, [0.25]], axis=-1)

  def device_fn(self):
    raise NotImplementedError("served through predict() only")

  def predict(self, features):
    target = self.target(features["image"][0])
    delta = np.asarray(features["action"], np.float32) - target
    return {"q_predicted": -(self.weights * delta * delta).sum(axis=-1)}


class TestCEM:

  @pytest.mark.parametrize("samples, elites, iterations", [
      (64, 6, 3), (128, 10, 4)])
  def test_cem_optimize_with_jax_noise(self, samples, elites, iterations):
    key = jax.random.key(3)
    target = np.array([0.3, -0.2, 0.5, -0.7], np.float32)
    initial = np.array([0.1, 0.0, -0.1, 0.2], np.float32)

    def jax_score(actions):
      return -jnp.sum(jnp.square(actions - target) * jnp.arange(1.0, 5.0),
                      axis=-1)

    def score(actions):
      return -torch.sum(torch.square(actions - torch.from_numpy(target))
                        * torch.arange(1.0, 5.0), dim=-1)

    want, want_score = jax_cem.cem_optimize(
        jax_score, key, 4, num_samples=samples, num_elites=elites,
        iterations=iterations, initial_mean=jnp.asarray(initial),
        initial_std=0.4)
    got, got_score = cem.cem_optimize(
        score, None, 4, num_samples=samples, num_elites=elites,
        iterations=iterations, initial_mean=torch.from_numpy(initial),
        initial_std=0.4,
        noise=torch.from_numpy(_jax_noise(key, iterations, samples)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CEM_ATOL)
    assert float(got_score) == pytest.approx(float(want_score), abs=CEM_ATOL)

  def test_refit_is_the_population_std(self):
    samples = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    scores = torch.tensor([0.1, 0.9, 0.5, 0.7, 0.3, 0.2])
    mean, std = cem._refit(samples, scores, 3)
    want_mean, want_std = jax_cem._refit(jnp.asarray(samples.numpy()),
                                         jnp.asarray(scores.numpy()), 3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean))
    np.testing.assert_allclose(std.numpy(), np.asarray(want_std), rtol=1e-6)

  def test_host_call_with_jax_noise(self):
    predictor = _QuadraticPredictor()
    image = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    key = jax.random.key(11)
    jax_policy = jax_cem.CEMPolicy(predictor, num_samples=64, num_elites=6,
                                   iterations=3)
    want = jax_policy._host_call(image, key)
    policy = cem.CEMPolicy(predictor, num_samples=64, num_elites=6,
                           iterations=3)
    got = policy(image, noise=torch.from_numpy(_jax_noise(key, 3, 64)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=CEM_ATOL)
    # Without injected noise the policy draws its own, from its seed.
    first = cem.CEMPolicy(predictor, seed=5)(image)
    again = cem.CEMPolicy(predictor, seed=5)(image)
    np.testing.assert_array_equal(first, again)
    assert np.abs(first - predictor.target(image)).max() < 0.5

  def test_device_path_equals_host_path(self, tmp_path):
    model = smoke.TinyQCriticModel()
    predictor = ExportedModelPredictor(model, str(tmp_path), device="cpu")
    predictor.init_randomly()
    image = np.random.default_rng(2).integers(0, 256, (16, 16, 3), np.uint8)
    noise = torch.randn((3, 64, 4), generator=torch.Generator().manual_seed(4))
    policy = cem.CEMPolicy(predictor)
    device = policy(image, noise=noise)  # through device_fn
    host = policy._host_call(image, noise=noise)
    np.testing.assert_allclose(device, host, rtol=0, atol=1e-6)
    fn, variables = predictor.device_fn()
    score = cem.make_tiled_q_score_fn(fn, variables)
    actions = noise[0].clamp(-1, 1)
    np.testing.assert_allclose(
        score(torch.from_numpy(image), actions).numpy(),
        predictor.predict({
            "image": np.repeat(image[None], 64, axis=0),
            "action": actions.numpy()})["q_predicted"], rtol=0, atol=1e-6)
    best, scores = cem.fleet_cem_optimize(
        cem.make_batched_tiled_q_score_fn(fn, variables),
        torch.from_numpy(np.stack([image, image])),
        torch.stack([noise, noise]), 4)
    assert best.shape == (2, 4) and scores.shape == (2,)
    np.testing.assert_array_equal(best[0].numpy(), best[1].numpy())

  def test_waiting_tiers_raise_by_name(self, tmp_path):
    """The tiers that waited for item 11 now score: each builds its score
    closure and runs one fleet CEM call at its tier, with float32 scores;
    an unknown tier still raises with the supported set named."""
    assert cem.scoring_dtype("f32") == torch.float32
    predictor = ExportedModelPredictor(smoke.TinyQCriticModel(),
                                       str(tmp_path), device="cpu")
    predictor.init_randomly()
    fn, variables = predictor.device_fn()
    image = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (16, 16, 3), np.uint8))
    noise = torch.randn((1, 3, 64, 4),
                        generator=torch.Generator().manual_seed(5))
    for tier in ("bf16", "int8"):
      assert cem.scoring_dtype(tier) == torch.bfloat16
      best, scores = cem.fleet_cem_optimize(
          cem.make_batched_tiled_q_score_fn(fn, variables, precision=tier),
          image[None], noise, 4, precision=tier)
      assert best.shape == (1, 4) and scores.dtype == torch.float32
      assert torch.isfinite(scores).all() and best.abs().max() <= 1.0
    with pytest.raises(ValueError, match="supported tiers"):
      cem.validate_precision("fp8")
    with pytest.raises(ValueError, match="supported tiers"):
      cem.fleet_cem_optimize(None, torch.zeros(1, 2), torch.zeros(1, 3, 64, 4),
                             4, precision="fp8")


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_cem_graph_equals_eager_step(cuda_device, tmp_path):
  """The control step replayed as a CUDA graph gives the eager step's
  action bit for bit on the same noise; new variables recapture."""
  model = t2r_models.QTOptGraspingModel(image_size=64)
  predictor = ExportedModelPredictor(model, str(tmp_path), device=cuda_device)
  predictor.init_randomly()
  policy = cem.CEMPolicy(predictor)
  image = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
  noise = torch.randn((3, 64, 4), device=cuda_device)
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    graphed = policy(image, noise=noise)
    fn, variables = predictor.device_fn()
    with torch.inference_mode():
      eager = policy._control(fn, variables, torch.from_numpy(image),
                              noise).cpu().numpy()
    np.testing.assert_array_equal(graphed, eager)
    first = policy._graph
    held = variables  # keeps the old tensors' addresses taken
    predictor.init_randomly()  # fresh variables: another graph
    policy(image, noise=noise)
    assert policy._graph is not first
    del held
  finally:
    torch.backends.cudnn.deterministic = deterministic
