"""The port's research zoo held against the JAX package.

On the CPU at small sizes, with the same weights (through the bridge) and
the same numpy inputs: the ResNet at depths 18 and 50 over every norm,
FiLM on and off, remat on and off and both impls (outputs, the spatial
map and the TRAIN running averages within OUT_RTOL of their scale,
gradients within GRAD_RTOL of each tensor's largest); remat against no
remat bit for bit; the SAME max-pool; the MDN head; the n-pairs loss;
the synthetic scenes and episode transitions bit for bit; the VRGripper
records through the port's preprocessor. The models are held in
``test_torch_zoo_models.py``, the configs and the capability checks in
``test_torch_zoo_configs.py``.

PREDICT and EVAL compare in float32 where the network normalizes with
running averages. TRAIN, and GroupNorm in every mode, compare in float64
on both sides (``jax.enable_x64``): they normalize with statistics of the
batch or of each example, which at these sizes cover a few values a
channel or a group, and float32 rounding is amplified through 50
normalized layers. At depth 50, 64x64,
batch 8, the float32 sides part by up to 0.42 of a gradient tensor's
largest (BatchNorm) and 0.014 (GroupNorm); in float64 they agree within
2e-12 of it (measured when these tests were written).
The test marked ``cuda`` holds the ResNet-50 Grasp2Vec step as a CUDA
graph against eager steps on the card.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none, and runs the cuda test only
  import flax.linen as jnn
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.layers import mdn as jax_mdn
  from tensor2robot_tpu.layers import resnet as jax_resnet
  from tensor2robot_tpu.research.grasp2vec import (
      losses as jax_losses,
      synthetic_scenes as jax_scenes,
  )
  from tensor2robot_tpu.research.vrgripper import (
      episode_to_transitions as jax_e2t,
  )
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge, modes  # noqa: E402
from tensor2robot_tpu_torch.layers import mdn, resnet  # noqa: E402
from tensor2robot_tpu_torch.research.grasp2vec import (  # noqa: E402
    grasp2vec_model,
    losses,
    synthetic_scenes,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    episode_to_transitions,
    vrgripper_env_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402

IMAGE = 32
# The same sums in other orders: outputs, maps and running averages within
# OUT_RTOL of their scale; gradients within GRAD_RTOL of each tensor's
# largest.
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
# A tensor whose largest gradient sits below NOISE_SHARE of the tree's
# largest holds rounding noise only (a conv bias that a norm removes):
# both sides must then stay below it.
NOISE_SHARE = 1e-6


def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _close(got, want, rtol=OUT_RTOL, what=""):
  if torch.is_tensor(got):
    got = got.detach()
    got = got.float() if got.dtype == torch.bfloat16 else got
  got, want = np.asarray(got), np.asarray(want)
  scale = max(float(np.abs(want).max()), 1e-12)
  np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                             err_msg=what)


def _check_grads(got: dict, want: dict):
  """Each gradient within GRAD_RTOL of its tensor's largest; noise-only
  tensors below NOISE_SHARE of the tree's largest on both sides."""
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name, value in want.items():
    value = np.asarray(value)
    largest = float(np.abs(value).max())
    mine = got[name].detach().numpy()
    if largest <= NOISE_SHARE * top:
      assert np.abs(mine).max() <= NOISE_SHARE * top, name
      continue
    np.testing.assert_allclose(mine, value, rtol=0,
                               atol=GRAD_RTOL * largest, err_msg=name)


def _flax_variables(module, seed):
  """Fresh port variables of `module` (flax's initializers, a torch
  generator) as the flax tree of numpy arrays the JAX side applies: the
  bridge's torch -> flax direction."""
  from tensor2robot_tpu_torch.models.abstract_model import flax_default_init_
  flax_default_init_(module, torch.Generator().manual_seed(seed))
  tree = bridge.state_dict_to_variables(module.state_dict())
  return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _state_dict(variables, module, grad=False):
  state = bridge.variables_to_state_dict(jax.device_get(variables), module)
  names = {n for n, _ in module.named_parameters()}
  return {k: (v.clone().requires_grad_() if grad and k in names
              else v.clone()) for k, v in state.items()}


# --- ResNet -----------------------------------------------------------------

# (depth, norm, film, remat, impl): each depth meets every norm, FiLM on
# and off, remat on and off, and both impls.
RESNET_CASES = [
    (18, "batch", False, False, "parity"),
    (18, "group", True, True, "fast"),
    (18, "none", False, True, "fast"),
    (50, "batch", True, True, "fast"),
    (50, "group", False, False, "parity"),
    (50, "none", True, False, "parity"),
]
# Width 8: every GroupNorm group holds at least two values at 32x32.
_WIDTH, _CONTEXT, _BATCH = 8, 5, 3


def _resnet_inputs(seed=0):
  rng = np.random.default_rng(seed)
  return (rng.random((_BATCH, IMAGE, IMAGE, 3), np.float32),
          rng.normal(size=(_BATCH, _CONTEXT)).astype(np.float32))


def _port_resnet(depth, norm, film, remat, impl, dtype=torch.float32):
  return resnet.ResNet(depth=depth, width=_WIDTH, film=film,
                       return_spatial=True, remat=remat, norm=norm,
                       impl=impl, dtype=dtype, context_size=_CONTEXT)


def _jax_resnet(depth, norm, film, remat, impl, dtype):
  return jax_resnet.ResNet(depth=depth, width=_WIDTH, film=film,
                           return_spatial=True, remat=remat, norm=norm,
                           impl=impl, dtype=dtype)


def _port_resnet_train(module, state, images, context):
  """(features, map, loss, new buffers) of one TRAIN forward whose loss
  weighs the features and the map by fixed draws; grads land in state."""
  params = {k: v for k, v in state.items() if v.requires_grad}
  buffers = {k: v.clone() for k, v in state.items() if k not in params}
  features, spatial = torch.func.functional_call(
      module, {**params, **buffers},
      (torch.from_numpy(images),
       None if context is None else torch.from_numpy(context), True))
  wf, ws = _loss_weights(features.shape, spatial.shape)
  loss = (features * torch.from_numpy(wf).to(features.dtype)).sum() + (
      spatial * torch.from_numpy(ws).to(spatial.dtype)).sum()
  loss.backward()
  return features, spatial, loss, buffers


def _loss_weights(feature_shape, spatial_shape):
  rng = np.random.default_rng(7)
  return (rng.normal(size=tuple(feature_shape)).astype(np.float32),
          rng.normal(size=tuple(spatial_shape)).astype(np.float32))


class TestResNet:

  @pytest.mark.parametrize("depth, norm, film, remat, impl", RESNET_CASES)
  def test_train_matches_jax_in_float64(self, depth, norm, film, remat,
                                        impl):
    _needs_jax()
    images, context = (x.astype(np.float64) for x in _resnet_inputs())
    module = _port_resnet(depth, norm, film, remat, impl,
                          torch.float64).double()
    variables = _flax_variables(module, depth)
    rest = {k: v for k, v in variables.items() if k != "params"}
    with jax.enable_x64(True):
      net = _jax_resnet(depth, norm, film, remat, impl, jnp.float64)
      ctx = jnp.asarray(context) if film else None

      def loss_fn(params):
        (features, spatial), state = net.apply(
            {**rest, "params": params}, images, ctx, train=True,
            mutable=["batch_stats"])
        wf, ws = _loss_weights(features.shape, spatial.shape)
        return (features * wf).sum() + (spatial * ws).sum(), (
            features, spatial, state)

      (_, (features, spatial, new_state)), grads = jax.jit(
          jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
      features, spatial, new_state, grads = jax.device_get(
          (features, spatial, new_state, grads))
    state = _state_dict(variables, module, grad=True)
    got_f, got_s, _, buffers = _port_resnet_train(
        module, state, images, context if film else None)
    assert got_s.shape == spatial.shape  # (B, H, W, F), as JAX
    _close(got_f, features, what="features")
    _close(got_s, spatial, what="spatial")
    if norm == "batch":
      want_stats = bridge.variables_to_state_dict(
          {**variables, **new_state}, module)
      for key, value in buffers.items():
        _close(value, want_stats[key].numpy(), what=key)
    else:
      assert not buffers
    _check_grads({k: v.grad for k, v in state.items() if v.requires_grad},
                 bridge.params_to_state_dict(grads, module))

  @pytest.mark.parametrize("depth, norm, film, remat, impl", RESNET_CASES)
  def test_eval_matches_jax(self, depth, norm, film, remat, impl):
    """EVAL: BatchNorm normalizes with running averages (set away from
    their init), in float32; GroupNorm with each example's own
    statistics, as in TRAIN, so it compares in float64."""
    _needs_jax()
    float64 = norm == "group"
    images, context = _resnet_inputs()
    if float64:
      images, context = images.astype(np.float64), context.astype(np.float64)
    module = _port_resnet(depth, norm, film, remat, impl,
                          torch.float64 if float64 else torch.float32)
    variables = _flax_variables(module, depth)
    if norm == "batch":
      rng = np.random.default_rng(depth)
      variables["batch_stats"] = jax.tree_util.tree_map(
          lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
          variables["batch_stats"])
    with jax.enable_x64(float64):
      net = _jax_resnet(depth, norm, film, remat, impl,
                        jnp.float64 if float64 else jnp.float32)
      ctx = jnp.asarray(context) if film else None
      want_f, want_s = jax.device_get(jax.jit(functools.partial(
          net.apply, train=False))(variables, images, ctx))
    with torch.no_grad():
      got_f, got_s = torch.func.functional_call(
          module, _state_dict(variables, module),
          (torch.from_numpy(images),
           torch.from_numpy(context) if film else None, False))
    _close(got_f, want_f, what="eval features")
    _close(got_s, want_s, what="eval spatial")

  @pytest.mark.parametrize("norm", ["batch", "group"])
  def test_remat_equals_no_remat_bit_for_bit(self, norm):
    """The loss, every gradient and the running averages (moved once)."""
    images, context = _resnet_inputs(1)
    plain = _port_resnet(18, norm, True, False, "parity")
    torch.manual_seed(0)
    for p in plain.parameters():
      torch.nn.init.normal_(p, std=0.3)
    base = plain.state_dict()
    results = []
    for remat in (False, True):
      module = _port_resnet(18, norm, True, remat, "parity")
      state = {k: v.clone().requires_grad_() if v.is_floating_point()
               and k in dict(module.named_parameters()) else v.clone()
               for k, v in base.items()}
      _, _, loss, buffers = _port_resnet_train(module, state, images,
                                               context)
      results.append((loss, {k: v.grad for k, v in state.items()
                             if v.requires_grad}, buffers))
    (loss0, grads0, stats0), (loss1, grads1, stats1) = results
    assert torch.equal(loss0, loss1)
    for key in grads0:
      assert torch.equal(grads0[key], grads1[key]), key
    for key in stats0:
      assert torch.equal(stats0[key], stats1[key]), key
      assert not torch.equal(stats0[key], base[key]), key  # they moved

  def test_film_is_identity_at_zero_projection(self):
    film = resnet._Film(3, 4, torch.float32)
    torch.nn.init.zeros_(film.film_proj.weight)
    torch.nn.init.zeros_(film.film_proj.bias)
    x = torch.randn(2, 4, 5, 5)
    assert torch.equal(film(x, torch.randn(2, 3)), x)

  def test_film_needs_a_context(self):
    with pytest.raises(ValueError, match="context"):
      resnet.ResNet(depth=18, film=True)
    net = resnet.ResNet(depth=18, width=4, film=True, context_size=2,
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="context"):
      net(torch.zeros(1, 16, 16, 3))
    with pytest.raises(ValueError, match="depth"):
      resnet.ResNet(depth=20)

  @pytest.mark.parametrize("size", [7, 8, 112])
  def test_same_max_pool_matches_flax(self, size):
    _needs_jax()
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    want = jnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = resnet.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


# --- MDN and n-pairs ----------------------------------------------------------

_K, _D, _F = 3, 4, 6


def _jax_mdn_head():
  class Head(jnn.Module):
    @jnn.compact
    def __call__(self, x):
      return jax_mdn.predict_mixture_params(x, _K, _D, name="mdn")
  return Head()


class TestMDN:

  def test_head_log_prob_nll_and_mode_match_jax(self):
    _needs_jax()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, _F)).astype(np.float32)
    target = rng.normal(size=(5, _D)).astype(np.float32)
    head = _jax_mdn_head()
    variables = jax.device_get(head.init(jax.random.key(0), x))
    want = head.apply(variables, x)
    projection = mdn.mixture_projection(_F, _K, _D)
    projection.load_state_dict({
        "weight": torch.from_numpy(np.asarray(
            variables["params"]["mdn"]["kernel"]).T.copy()),
        "bias": torch.from_numpy(np.asarray(
            variables["params"]["mdn"]["bias"]))})
    got = mdn.predict_mixture_params(torch.from_numpy(x), _K, _D,
                                     projection)
    for name in mdn.MixtureParams._fields:
      _close(getattr(got, name), getattr(want, name), what=name)
    _close(mdn.log_prob(got, torch.from_numpy(target)),
           jax_mdn.log_prob(want, jnp.asarray(target)), what="log_prob")
    _close(mdn.negative_log_likelihood(got, torch.from_numpy(target)),
           jax_mdn.negative_log_likelihood(want, jnp.asarray(target)),
           what="nll")
    np.testing.assert_array_equal(
        mdn.gaussian_mixture_approximate_mode(got).detach().numpy(),
        np.asarray(jax_mdn.gaussian_mixture_approximate_mode(want)))

  def test_sample_moments(self):
    """Samples of a fixed two-component mixture (no draw can equal
    JAX's): the mixture's mean and variance within 4 standard errors."""
    n = 200_000
    log_alphas = torch.log(torch.tensor([0.25, 0.75]))
    mus = torch.tensor([[-2.0, 1.0], [1.0, 3.0]])
    sigmas = torch.tensor([[0.5, 1.0], [0.2, 2.0]])
    params = mdn.MixtureParams(log_alphas.expand(n, 2), mus.expand(n, 2, 2),
                               torch.log(sigmas).expand(n, 2, 2))
    x = mdn.sample(params, torch.Generator().manual_seed(0)).double()
    w = torch.tensor([0.25, 0.75], dtype=torch.float64)[:, None]
    mean = (w * mus.double()).sum(0)
    var = (w * (sigmas.double() ** 2 + mus.double() ** 2)).sum(0) - mean ** 2
    assert x.shape == (n, 2)
    assert torch.all((x.mean(0) - mean).abs() <= 4 * (var / n).sqrt())
    assert torch.allclose(x.var(0), var, rtol=0.02)


class TestNPairs:

  def test_loss_and_accuracy_match_jax(self):
    _needs_jax()
    rng = np.random.default_rng(0)
    a = rng.normal(size=(8, 16)).astype(np.float32)
    p = a + rng.normal(scale=1.5, size=(8, 16)).astype(np.float32)
    want_loss, want_acc = jax_losses.npairs_loss(jnp.asarray(a),
                                                 jnp.asarray(p))
    got_loss, got_acc = losses.npairs_loss(torch.from_numpy(a),
                                           torch.from_numpy(p))
    _close(got_loss, want_loss, what="loss")
    assert float(got_acc) == float(want_acc)
    loss_match, acc = losses.npairs_loss(torch.from_numpy(a),
                                         torch.from_numpy(a), l2_reg=0.0)
    loss_roll, _ = losses.npairs_loss(
        torch.from_numpy(a), torch.from_numpy(np.roll(a, 1, 0)), l2_reg=0.0)
    assert float(acc) == 1.0 and float(loss_match) < float(loss_roll)


class TestVRGripperRecords:

  def test_records_parse_through_the_preprocessor(self, tmp_path):
    """The port's VRGripper models read the jpeg records
    episode_to_transitions writes (the JAX models cannot: ROADMAP
    Facts)."""
    from tensor2robot_tpu_torch.data.default_input_generator import (
        DefaultRecordInputGenerator,
    )
    path = str(tmp_path / "demos.tfrecord")
    episode_to_transitions.write_episodes(path, [_episode(0, 5)])
    model = vrgripper_env_models.VRGripperEnvModel(image_size=16)
    generator = DefaultRecordInputGenerator(file_patterns=path,
                                            batch_size=5)
    generator.set_specification_from_model(model, modes.TRAIN)
    assert generator.feature_spec["image"].data_format == "jpeg"
    features, labels = next(generator.create_dataset_fn(modes.TRAIN)())
    assert features["image"].dtype == np.float32  # preprocessed
    assert features["image"].shape == (5, 16, 16, 3)
    assert 0.0 <= features["image"].min() and features["image"].max() <= 1.0
    assert labels["action"].shape == (5, 7)


# --- helpers bit for bit ----------------------------------------------------


def _episode(seed, steps, size=16):
  rng = np.random.default_rng(seed)
  return {"images": rng.integers(0, 256, (steps, size, size, 3), np.uint8),
          "gripper_poses": rng.normal(size=(steps, 14)).astype(np.float32),
          "actions": rng.normal(size=(steps, 7)).astype(np.float32)}


class TestHelpers:

  @pytest.mark.parametrize("seed, size", [(0, 32), (3, 64)])
  def test_synthetic_triplets_bit_for_bit(self, seed, size):
    _needs_jax()
    want = jax_scenes.sample_triplets(6, image_size=size, seed=seed)
    got = synthetic_scenes.sample_triplets(6, image_size=size, seed=seed)
    assert set(got) == set(want)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key])
    idx = np.array([4, 0, 2])
    for key, value in jax_scenes.as_model_batch(want, idx).items():
      np.testing.assert_array_equal(
          synthetic_scenes.as_model_batch(got, idx)[key], value)

  def test_episode_transitions_bit_for_bit(self, tmp_path):
    _needs_jax()
    episodes = [_episode(0, 4), _episode(1, 3)]
    want = tmp_path / "jax.tfrecord"
    got = tmp_path / "port.tfrecord"
    jax_e2t.write_episodes(str(want), episodes)
    episode_to_transitions.write_episodes(str(got), episodes)
    assert got.read_bytes() == want.read_bytes()
    bad = dict(episodes[0], actions=episodes[0]["actions"][:2])
    with pytest.raises(ValueError, match="disagree"):
      list(episode_to_transitions.episode_to_examples(bad))


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_resnet50_graph_equals_eager(cuda_device, remat):
  """Grasp2Vec's ResNet-50 towers (BatchNorm, bf16, 64x64, batch 8): 2
  warm-up steps, then a stack of 3 as one CUDA graph against the same
  steps eagerly, bit for bit with cuDNN deterministic."""
  from tensor2robot_tpu_torch.train.trainer import _index
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    model = grasp2vec_model.Grasp2VecModel(image_size=64, remat=remat)
    data = synthetic_scenes.sample_triplets(40, image_size=64, seed=0)
    rng = np.random.default_rng(0)

    def stack(k):
      batches = [synthetic_scenes.as_model_batch(
          data, rng.choice(40, 8, replace=False)) for _ in range(k)]
      return ts.TensorSpecStruct(
          (key, torch.from_numpy(np.stack([b[key] for b in batches])).to(
              cuda_device)) for key in batches[0])

    warm, steps = stack(2), stack(3)
    graphed, eager = (Trainer(model, device=cuda_device) for _ in range(2))
    g_state, e_state = graphed.create_train_state(), eager.create_train_state()
    g_state, _ = graphed.train_steps(g_state, warm, None)
    g_state, g_metrics = graphed.train_steps(g_state, steps, None)
    for batch in (warm, steps):
      for i in range(next(iter(batch.values())).shape[0]):
        e_state, e_metrics = eager.train_step(e_state, _index(batch, i))
    for key in g_state.params:
      assert torch.equal(g_state.params[key], e_state.params[key]), key
    for key in g_state.model_state:
      assert torch.equal(g_state.model_state[key],
                         e_state.model_state[key]), key
    assert float(g_metrics["loss"]) == float(e_metrics["loss"])
  finally:
    torch.backends.cudnn.deterministic = deterministic

