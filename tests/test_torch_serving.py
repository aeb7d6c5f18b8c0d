"""The port's fleet serving policy held against the JAX package.

``serving/bucketing.py`` is a copy: the same ladders, buckets and padding,
bit for bit. ``CEMFleetPolicy`` serves TinyQ at float32 through the weight
bridge with the JAX package's own draws injected (threefry cannot be
matched): actions and scores within 1e-4 of the JAX policy's. An action
depends only on (image, seed, variables): alone and inside a padded flush
of 5 it agrees within 1e-5. Every rung is built once across three hot
reloads, the host fallback agrees with the device path within 1e-5, and
each refusal names its ROADMAP item. On the card (``cuda`` marker) a
bucket's graph equals its eager control bit for bit.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.replay import loop as jax_loop
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.serving import bucketing as jax_bucketing
  from tensor2robot_tpu.serving import policy as jax_policy
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch.replay import loop, smoke  # noqa: E402
from tensor2robot_tpu_torch.serving import (  # noqa: E402
    BucketLadder,
    CEMFleetPolicy,
    bucketing,
)

IMG = 8
CEM = dict(num_samples=16, num_elites=4, iterations=3)
POLICY_SEED = 5
ACTION_ATOL = 1e-4  # the port against the JAX policy (float32)
FLUSH_ATOL = 1e-5  # one request alone against inside a padded flush


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _images(n, seed=0, img=IMG):
  rng = np.random.default_rng(seed)
  return list(rng.integers(0, 256, (n, img, img, 3), np.uint8))


def _tiny_state(seed=0):
  model = smoke.TinyQCriticModel(image_size=IMG)
  return model, model.init_variables(torch.Generator().manual_seed(seed),
                                     device="cpu")


def _policy(seed=0, **kwargs):
  model, state = _tiny_state(seed)
  predictor = loop._HotReloadPredictor(model, state)
  return predictor, CEMFleetPolicy(predictor, action_size=4,
                                   seed=POLICY_SEED, **CEM, **kwargs)


def _jax_draws(seed, seeds, iterations, samples, action_size=4):
  """The JAX policy's draws: request s's iteration i is normal(fold_in(
  fold_in(key(seed), s), i), (N, A))."""
  base = jax.random.key(seed)
  keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(
      jnp.asarray(np.asarray(seeds, np.uint32)))
  return np.stack([np.asarray(jax.vmap(
      lambda k, i=i: jax.random.normal(jax.random.fold_in(k, i),
                                       (samples, action_size)))(keys))
                   for i in range(iterations)], axis=1)


class _HostOnly:
  """A predictor without a device path: the policy serves it through
  ``predict``."""

  def __init__(self, predictor):
    self._predictor = predictor
    self.model_version = predictor.model_version

  def predict(self, features):
    return self._predictor.predict(features)

  def device_fn(self):
    raise NotImplementedError


# --- bucketing --------------------------------------------------------------


class TestBucketing:

  @pytest.mark.parametrize("sizes", [(1, 2, 4, 8, 16), (3, 1, 3, 12), (5,)])
  def test_ladder_bit_identical_to_jax(self, needs_jax, sizes):
    assert bucketing.DEFAULT_LADDER == jax_bucketing.DEFAULT_LADDER
    ours, theirs = BucketLadder(sizes), jax_bucketing.BucketLadder(sizes)
    assert ours.sizes == theirs.sizes and ours.max_batch == theirs.max_batch
    rng = np.random.default_rng(len(sizes))
    for n in range(1, ours.max_batch + 1):
      assert ours.bucket_for(n) == theirs.bucket_for(n)
      batch = rng.integers(0, 256, (n, 3, 2), np.uint8)
      got, got_bucket = ours.pad_batch(batch)
      want, want_bucket = theirs.pad_batch(batch)
      assert got_bucket == want_bucket and got.dtype == want.dtype
      np.testing.assert_array_equal(got, want)
    for n in (0, ours.max_batch + 1):
      with pytest.raises(ValueError, match="outside ladder"):
        ours.bucket_for(n)

  def test_pad_to_repeats_the_last_row(self, needs_jax):
    batch = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(bucketing.pad_to(batch, 5),
                                  jax_bucketing.pad_to(batch, 5))
    assert bucketing.pad_to(batch, 3) is batch
    with pytest.raises(ValueError, match="cannot pad"):
      bucketing.pad_to(batch, 2)
    with pytest.raises(ValueError, match="non-empty positive"):
      BucketLadder((0, 2))


# --- the policy against the JAX policy -------------------------------------


class TestAgainstJax:

  def test_actions_and_scores_match_jax_with_its_draws(self, needs_jax):
    jax_model = jax_smoke.TinyQCriticModel(image_size=IMG)
    model = smoke.TinyQCriticModel(image_size=IMG)
    variables = jax.device_get(
        jax_model.init_variables(jax.random.key(1), batch_size=2))
    theirs = jax_policy.CEMFleetPolicy(
        jax_loop._HotReloadPredictor(jax_model, variables), action_size=4,
        seed=POLICY_SEED, **CEM)
    ours = CEMFleetPolicy(
        loop._HotReloadPredictor(
            model, bridge.variables_to_state_dict(variables, model.module)),
        action_size=4, seed=POLICY_SEED, **CEM)
    images = _images(5, 2)
    seeds = np.array([3, 10, 11, 40, 7], np.uint32)
    want, want_scores = theirs(images, seeds, return_scores=True)
    got, got_scores = ours(
        images, seeds, return_scores=True,
        noise=_jax_draws(POLICY_SEED, seeds, CEM["iterations"],
                         CEM["num_samples"]))
    assert got.shape == (5, 4) and got_scores.shape == (5,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ACTION_ATOL)
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), rtol=0,
                               atol=ACTION_ATOL)
    assert ours.compile_counts == {8: 1} == theirs.compile_counts

  def test_hot_reload_predictor_matches_jax(self, needs_jax):
    jax_model = jax_smoke.TinyQCriticModel(image_size=IMG)
    model = smoke.TinyQCriticModel(image_size=IMG)
    variables = jax.device_get(
        jax_model.init_variables(jax.random.key(2), batch_size=2))
    theirs = jax_loop._HotReloadPredictor(jax_model, variables)
    ours = loop._HotReloadPredictor(
        model, bridge.variables_to_state_dict(variables, model.module))
    features = {"image": np.stack(_images(3, 4)),
                "action": np.random.default_rng(0).uniform(
                    -1, 1, (3, 4)).astype(np.float32)}
    got, want = ours.predict(features), theirs.predict(features)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["q_predicted"], want["q_predicted"],
                               rtol=0, atol=1e-5)
    assert isinstance(got["q_predicted"], np.ndarray)
    spec, jax_spec = (p.get_feature_specification() for p in (ours, theirs))
    assert {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in spec.items()
            } == {k: (tuple(v.shape), np.dtype(v.dtype))
                  for k, v in jax_spec.items()}
    for predictor in (ours, theirs):
      assert predictor.model_version == 0 and predictor.restore()
      predictor.update(predictor.device_fn()[1])
      predictor.set_variables(predictor.device_fn()[1], version=40)
      assert predictor.model_version == 40
      predictor.set_variables(predictor.device_fn()[1])
    assert ours.model_version == theirs.model_version == 41
    fn, served = ours.device_fn()
    assert fn == model.predict_fn and all(
        v.device.type == "cpu" for v in served.values())


# --- the policy's own contracts --------------------------------------------


class TestPolicy:

  def test_action_does_not_depend_on_the_flush(self):
    _, policy = _policy(3)
    images = _images(5, 6)
    seeds = np.array([21, 4, 9, 77, 5], np.uint32)
    together, scores = policy(images, seeds, return_scores=True)
    for i in range(5):
      alone, alone_score = policy([images[i]], seeds[i:i + 1],
                                  return_scores=True)
      np.testing.assert_allclose(alone, together[i:i + 1], rtol=0,
                                 atol=FLUSH_ATOL)
      np.testing.assert_allclose(alone_score, scores[i:i + 1], rtol=0,
                                 atol=FLUSH_ATOL)
    order = np.array([3, 0, 4, 1, 2])
    shuffled = policy([images[i] for i in order], seeds[order])
    np.testing.assert_allclose(shuffled, together[order], rtol=0,
                               atol=FLUSH_ATOL)
    assert policy.compile_counts == {1: 1, 8: 1}
    assert policy.executable_buckets == [1, 8]

  def test_every_rung_built_once_across_hot_reloads(self):
    predictor, policy = _policy(4)
    policy.warm(lambda i: _images(1, 100 + i)[0])
    assert policy.compile_counts == {b: 1 for b in (1, 2, 4, 8, 16)}
    images, seeds = _images(3, 8), np.arange(3, dtype=np.uint32)
    before = policy(images, seeds)
    model = smoke.TinyQCriticModel(image_size=IMG)
    for reload in range(1, 4):
      _, fresh = _tiny_state(10 + reload)
      predictor.update(fresh)
      for bucket in (1, 2, 4, 8, 16):
        policy(_images(bucket, bucket), np.arange(bucket, dtype=np.uint32))
      got = policy(images, seeds)
      want = CEMFleetPolicy(loop._HotReloadPredictor(model, fresh),
                            action_size=4, seed=POLICY_SEED, **CEM)(
                                images, seeds)
      np.testing.assert_array_equal(got, want)  # serves the new variables
      assert not np.array_equal(got, before)
    assert predictor.model_version == 3
    assert policy.compile_counts == {b: 1 for b in (1, 2, 4, 8, 16)}

  def test_host_fallback_agrees_with_the_device_path(self):
    predictor, policy = _policy(5)
    host = CEMFleetPolicy(_HostOnly(predictor), action_size=4,
                          seed=POLICY_SEED, **CEM)
    images, seeds = _images(3, 9), np.array([1, 2, 30], np.uint32)
    want, scores = policy(images, seeds, return_scores=True)
    got, none = host(images, seeds, return_scores=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLUSH_ATOL)
    assert none is None and scores.shape == (3,)
    assert np.all(np.abs(got) <= 1.0) and host.compile_counts == {}

  def test_seeds_are_monotonic_and_thread_safe(self):
    _, policy = _policy()
    assert list(policy.assign_seeds(3)) == [0, 1, 2]
    got, lock = [], threading.Lock()

    def client():
      for _ in range(200):
        seeds = policy.assign_seeds(3)
        assert list(np.diff(seeds)) == [1, 1]
        with lock:
          got.extend(seeds.tolist())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
      threads = [threading.Thread(target=client) for _ in range(16)]
      for thread in threads:
        thread.start()
      for thread in threads:
        thread.join(60)
      assert not any(thread.is_alive() for thread in threads)
    finally:
      sys.setswitchinterval(interval)
    assert sorted(got) == list(range(3, 3 + 16 * 200 * 3))

  def test_default_seeds_come_from_the_counter(self):
    _, policy = _policy(6)
    images = _images(2, 11)
    first, again = policy(images), policy(images, np.array([0, 1]))
    np.testing.assert_array_equal(first, again)
    with pytest.raises(ValueError, match="need 2 seeds"):
      policy(images, [1, 2, 3])
    with pytest.raises(ValueError, match="noise must be"):
      policy(images, noise=np.zeros((2, 1, 16, 4), np.float32))

  @pytest.mark.parametrize("kwargs, item", [
      (dict(param_specs={}), "item 15")])
  def test_refusals_name_their_items(self, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
      _policy(**kwargs)

  @pytest.mark.parametrize("tier", ["bf16", "int8"])
  def test_policy_serves_the_scoring_tiers(self, tier):
    _, policy = _policy(precision=tier)
    actions, scores = policy(_images(2, 12), [4, 5], return_scores=True)
    assert policy.precision == tier and policy.compile_counts == {2: 1}
    assert actions.shape == (2, 4) and scores.dtype == np.float32
    assert np.isfinite(scores).all() and np.abs(actions).max() <= 1.0


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graph_equals_eager_and_captures_once(cuda_device):
  """Each rung's graph replays its eager control bit for bit (cuDNN
  deterministic), captured once across three hot reloads, and the card
  agrees with the CPU."""
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    model, state = _tiny_state(7)
    predictor = loop._HotReloadPredictor(
        model, {k: v.to(cuda_device) for k, v in state.items()})
    policy = CEMFleetPolicy(predictor, action_size=4, seed=POLICY_SEED,
                            **CEM)
    cpu = CEMFleetPolicy(loop._HotReloadPredictor(model, state),
                         action_size=4, seed=POLICY_SEED, **CEM)
    for reload in range(4):
      if reload:
        _, fresh = _tiny_state(20 + reload)
        predictor.update({k: v.to(cuda_device) for k, v in fresh.items()})
        cpu = CEMFleetPolicy(loop._HotReloadPredictor(model, fresh),
                             action_size=4, seed=POLICY_SEED, **CEM)
      for bucket in (1, 2, 4, 8, 16):
        images = _images(bucket, bucket + reload)
        seeds = np.arange(bucket, dtype=np.uint32)
        graphed = policy(images, seeds)
        fn, _ = predictor.device_fn()
        with torch.inference_mode():
          eager, _ = policy._control(
              fn, torch.from_numpy(np.stack(images)).to(cuda_device),
              torch.from_numpy(policy.noise_for(seeds)).to(cuda_device))
        np.testing.assert_array_equal(graphed, eager.cpu().numpy())
        np.testing.assert_allclose(graphed, cpu(images, seeds), rtol=0,
                                   atol=ACTION_ATOL)
    assert policy.compile_counts == {b: 1 for b in (1, 2, 4, 8, 16)}
  finally:
    torch.backends.cudnn.deterministic = deterministic
