"""The port's bf16 and int8 Q-scoring tiers held against the JAX package.

Same numpy inputs, from seeds, through both packages on the CPU, the JAX
variables mapped onto the port's through the weight bridge:

- the tiers' weights: the f32 cast is the same object, the bf16 cast and
  the int8 ``q`` and ``scale`` (and their dequantized bf16 views) equal the
  JAX package's bit for bit, leaf for leaf, for TinyQ and for the 64x64
  flagship critic at each option;
- scores at each tier within SCORE_BOUND of JAX's, f32 scores from the
  pre-tier closure;
- fleet CEM with the JAX draws injected, held by value agreement under
  the f32 oracle (the precision bench's statistic; elite sets may differ
  on bf16 ties);
- Bellman targets at each tier (float32, clipped, near JAX's);
- the fleet policy's tiers, its int8 placement and hot reload, the host
  path's refusal, the precision bench's first phase at a miniature size,
  and the refusals that stay.

**The score bounds.** bfloat16 keeps 8 significant bits, so one rounding
moves a value by at most 2^-9 of itself. Each bound is relative to the
reference logits' own scale, max |q|, with no floor:

- TinyQ: its dense layers promote their inputs and parameters to the
  tier's dtype in both packages, which run the same bf16 products with
  float32 accumulation; the bound is one bf16 rounding of the logit,
  2^-9 * max |q| (measured: bit for bit on the CPU). A sigmoid value
  (Bellman's q_next) moves by at most a quarter of its logit's move.
- The flagship with float32 activations (``compute_dtype`` float32,
  GroupNorm): a tier moves only the weights' values, and the packages sit
  within float32 rounding, DEPTH * 2^-20 * max |q| (2^-24 a stage, with
  4 bits for the summation order over the convolutions' fan-in).
- The flagship at its bfloat16 activations: over DEPTH rounding stages,
  none of which amplifies a relative error here, two implementations that
  round at different points sit within DEPTH * 2^-8 * max |q|. The
  flagship's depth is 19 (the stem, three pre-merge and three post-merge
  convolutions, seven norms, two action layers, the merge, the global mean
  and the last hidden layer; its head is float32). This bound cannot tell
  the tiers apart: a tier moves the scores (JAX's own f32-to-tier gap) by
  less than the packages' bf16 activations round apart, and the BatchNorm
  tower's bf16 statistics round in flax's rsqrt where the port normalises
  in float32. The float32-activation cases resolve the tiers instead.

``test_the_bound_rejects_a_wrong_tier`` holds the resolvable bounds
against controls that must fall outside them: the tier's score made to
read the float32 weights, and int8 made to score the bf16 cast (the
quantize -> dequantize round trip skipped), on the score and on the
Bellman label path.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.replay import bellman as jax_bellman
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.replay import tpquant_bench as jax_tpquant
  from tensor2robot_tpu.research.qtopt import cem as jax_cem
  from tensor2robot_tpu.research.qtopt import t2r_models as jax_models
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger  # noqa: E402
from tensor2robot_tpu_torch.replay import (  # noqa: E402
    bellman,
    loop,
    precision_bench,
    smoke,
    tpquant_bench,
)
from tensor2robot_tpu_torch.research.qtopt import cem  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import t2r_models  # noqa: E402
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy  # noqa: E402

FLAGSHIP_DEPTH = 19
Q_TOL = 0.05  # the precision bench's value-space bar
CEM = dict(num_samples=16, num_elites=4, iterations=2)
FLAGSHIP_OPTIONS = [
    dict(norm="batch", stem="conv", impl="parity"),
    dict(norm="group", stem="space_to_depth", impl="fast"),
    dict(norm="batch", stem="space_to_depth", impl="parity"),
    dict(norm="group", stem="conv", impl="fast"),
]


def _score_bound(name, q):
  """The bound of the module docstring for the pair `name`'s scores."""
  scale = float(np.max(np.abs(q)))
  if name == "tinyq":
    return 2.0 ** -9 * scale
  if name.endswith("_f32"):
    return FLAGSHIP_DEPTH * 2.0 ** -20 * scale
  return FLAGSHIP_DEPTH * 2.0 ** -8 * scale


def _sigmoid_bound(q):
  """TinyQ's bound on sigmoid values `q`: one bf16 rounding of their
  logits, through the sigmoid's slope <= 1/4."""
  q = np.clip(np.asarray(q, np.float64), 1e-12, 1 - 1e-12)
  return 2.0 ** -9 * float(np.max(np.abs(np.log(q / (1 - q))))) / 4


# The faults the bounds must reject, as replacements of
# cem.scoring_weights_view: the tier's score reading the float32 weights,
# and int8 scoring the bf16 cast without the quantize -> dequantize round
# trip.
_FAULTS = {
    "f32_weights": lambda variables, precision: variables,
    "no_round_trip": lambda variables, precision: cem.cast_scoring_variables(
        variables, "bf16"),
}

@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _tinyq(seed=0):
  """(JAX TinyQ, port TinyQ, JAX variables, port state_dict)."""
  jax_model = jax_smoke.TinyQCriticModel()
  model = smoke.TinyQCriticModel()
  variables = jax.device_get(
      jax_model.init_variables(jax.random.key(seed), batch_size=2))
  return jax_model, model, variables, bridge.variables_to_state_dict(
      variables, model.module)


def _flagship(options, seed=0):
  """The 64x64 flagship pair, the batch statistics and biases moved off
  init's zeros and ones so that a swapped or mis-cast leaf shows."""
  jax_model = jax_models.QTOptGraspingModel(image_size=64, **options)
  model = t2r_models.QTOptGraspingModel(image_size=64, **options)
  variables = jax.device_get(
      jax_model.init_variables(jax.random.key(seed), batch_size=2))
  rng = np.random.default_rng(seed + 3)

  def move(tree):
    out = {}
    for key, value in tree.items():
      if isinstance(value, dict):
        out[key] = move(value)
      elif key == "var":
        out[key] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
      elif key in ("mean", "bias", "scale", "stem_s2d_bias"):
        out[key] = (np.asarray(value) + 0.2 * rng.standard_normal(
            value.shape)).astype(np.float32)
      else:
        out[key] = np.asarray(value)
    return out

  variables = move(variables)
  return jax_model, model, variables, bridge.variables_to_state_dict(
      variables, model.module)


@functools.lru_cache(maxsize=None)
def _pair(name):
  """One (JAX model, port model, JAX variables, state_dict) per name for
  the module: nothing here changes them."""
  if name == "tinyq":
    return _tinyq()
  option = FLAGSHIP_OPTIONS[int(name[len("flagship")])]
  if not name.endswith("_f32"):
    return _flagship(option)
  # The same variables, both models with float32 activations.
  _, _, variables, state = _pair(name[:-len("_f32")])
  return (jax_models.QTOptGraspingModel(image_size=64,
                                        compute_dtype=jnp.float32, **option),
          t2r_models.QTOptGraspingModel(image_size=64,
                                        compute_dtype=torch.float32,
                                        **option),
          variables, state)


def _score_inputs(name):
  size = 16 if name == "tinyq" else 64
  rng = np.random.default_rng(5)
  image = rng.integers(0, 256, (size, size, 3), np.uint8)
  if name != "tinyq":
    image = image.astype(np.float32) / 255.0  # the float wire
  return image, rng.uniform(-1, 1, (16, 4)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_scores(name, tier):
  jax_model, _, variables, _ = _pair(name)
  image, actions = _score_inputs(name)
  return np.asarray(jax_cem.make_tiled_q_score_fn(
      jax_model.predict_fn, variables, tier)(jnp.asarray(image),
                                             jnp.asarray(actions)))


def _port_scores(name, tier):
  _, model, _, state = _pair(name)
  image, actions = _score_inputs(name)
  return cem.make_tiled_q_score_fn(model.predict_fn, state, tier)(
      torch.from_numpy(image), torch.from_numpy(actions))


def _as_f32(array):
  """A JAX leaf (any float dtype, bf16 included) as an exact float32
  tensor: every bf16 value is a float32 value."""
  return torch.from_numpy(np.array(jnp.asarray(array, jnp.float32)))


def _wrappers(tree, prefix=()):
  """(collection, scope..., name) paths and JAX int8 wrapper leaves."""
  for key, value in tree.items():
    if isinstance(value, dict) and set(value) == {"int8_q", "int8_scale"}:
      yield prefix + (key,), value
    elif isinstance(value, dict):
      yield from _wrappers(value, prefix + (key,))


def _leaves(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, dict) and not (set(value)
                                        == {"int8_q", "int8_scale"}):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def _bridged(path, leaf):
  """The state_dict key and the port-layout tensor of one JAX leaf."""
  return bridge._to_torch(path[0], tuple(path[1:]), leaf)


class TestTierWeights:

  @pytest.mark.parametrize("name", ["tinyq", "flagship0", "flagship1"])
  def test_cast_through_the_bridge(self, needs_jax, name):
    _, _, variables, state = _pair(name)
    assert cem.cast_scoring_variables(state, "f32") is state
    assert cem.scoring_weights_view(state, "f32") is state
    ours = cem.cast_scoring_variables(state, "bf16")
    theirs = jax_cem.cast_scoring_variables(variables, "bf16")
    seen = set()
    for path, leaf in _leaves(theirs):
      key, want = _bridged(path, _as_f32(leaf))
      assert ours[key].dtype == torch.bfloat16, key
      assert torch.equal(ours[key].float(), want), key
      seen.add(key)
    # Every floating tensor was cast, the BatchNorm statistics included.
    assert seen == set(state)

  @pytest.mark.parametrize("name", ["tinyq"] + [
      f"flagship{i}" for i in range(len(FLAGSHIP_OPTIONS))])
  def test_quantize_and_dequantize_bit_for_bit(self, needs_jax, name):
    """Every quantized leaf's int8 values and float32 scales equal JAX's
    through the bridge (the scale's (1, .., O) maps to the port's output
    axis), as do the dequantized bf16 views of every leaf."""
    _, _, variables, state = _pair(name)
    ours = cem.quantize_scoring_variables(state)
    theirs = jax_cem.quantize_scoring_variables(variables)
    wrapped = list(_wrappers(theirs))
    assert {_bridged(path, _as_f32(w["int8_q"]))[0] for path, w in wrapped
            } == {k for k, v in ours.items() if cem._is_quant_wrapper(v)}
    for path, w in wrapped:
      key, q = _bridged(path, torch.from_numpy(np.array(w["int8_q"])))
      _, scale = _bridged(path, torch.from_numpy(np.array(
          w["int8_scale"])))
      assert ours[key]["int8_q"].dtype == torch.int8
      assert torch.equal(ours[key]["int8_q"], q), key
      assert torch.equal(ours[key]["int8_scale"], scale), key
    dense = cem.dequantize_scoring_variables(ours)
    for path, leaf in _leaves(jax_cem.dequantize_scoring_variables(theirs)):
      key, want = _bridged(path, _as_f32(leaf))
      assert dense[key].dtype == torch.bfloat16
      assert torch.equal(dense[key].float(), want), key
    view = cem.scoring_weights_view(state, "int8")
    assert all(torch.equal(view[k], dense[k]) for k in dense)

  def test_idempotence_and_the_all_zero_channel(self, needs_jax):
    state = {"conv.weight": torch.randn(
        (3, 2, 3, 3), generator=torch.Generator().manual_seed(0)),
             "conv.bias": torch.zeros(3), "steps": torch.arange(3)}
    state["conv.weight"][1] = 0.0
    once = cem.quantize_scoring_variables(state)
    twice = cem.cast_scoring_variables(once, "int8")
    assert twice["conv.weight"] is once["conv.weight"]
    assert twice["conv.bias"] is state["conv.bias"]
    assert twice["steps"] is state["steps"] and cem.is_quantized_variables(
        twice) and not cem.is_quantized_variables(state)
    q, scale = once["conv.weight"]["int8_q"], once["conv.weight"][
        "int8_scale"]
    assert scale.shape == (3, 1, 1, 1) and not q[1].any()
    assert float(scale[1]) == np.float32(1e-8) / np.float32(127.0)
    dense = cem.dequantize_scoring_variables(once)
    assert torch.isfinite(dense["conv.weight"].float()).all()
    assert not dense["conv.weight"][1].any()
    assert dense["steps"].dtype == torch.int64
    # JAX on the same kernel in its HWIO layout.
    hwio = state["conv.weight"].permute(2, 3, 1, 0).numpy()
    theirs = jax_cem.quantize_scoring_variables({"k": jnp.asarray(hwio)})
    np.testing.assert_array_equal(
        np.asarray(theirs["k"]["int8_q"]).transpose(3, 2, 0, 1), q.numpy())
    np.testing.assert_array_equal(
        np.asarray(theirs["k"]["int8_scale"]).reshape(3), scale.reshape(3))

  def test_output_axis_follows_the_bridge(self):
    assert bridge.flax_last_axis("stem.weight", 4) == 0
    assert bridge.flax_last_axis("fc1.weight", 2) == 0
    assert bridge.flax_last_axis("stem_s2d_kernel", 4) == 3
    assert bridge.flax_last_axis("stem_bn.running_mean", 1) == 0
    with pytest.raises(KeyError, match="no flax counterpart"):
      bridge.flax_last_axis("orphan", 2)
    state = t2r_models.QTOptGraspingModel(
        image_size=64, stem="space_to_depth").init_variables(
            torch.Generator().manual_seed(0), device="cpu")
    quantized = cem.quantize_scoring_variables(state)
    assert quantized["stem_s2d_kernel"]["int8_scale"].shape == (1, 1, 1, 64)
    assert quantized["post_conv0.weight"]["int8_scale"].shape == (
        64, 1, 1, 1)


class TestScores:

  def test_f32_score_fns_are_the_pre_tier_closures(self, needs_jax):
    """The f32 score is the pre-tier body's, bit for bit: the wire dtype
    passes, the actions go in as float32."""
    _, model, _, state = _tinyq(2)
    rng = np.random.default_rng(4)
    states = torch.from_numpy(rng.integers(0, 256, (3, 16, 16, 3),
                                           np.uint8))
    actions = torch.from_numpy(rng.uniform(-1, 1, (3, 8, 4)).astype(
        np.float32))
    tiled = states[:, None].expand(3, 8, 16, 16, 3).reshape(24, 16, 16, 3)
    want = model.predict_fn(state, {"image": tiled, "action": actions.reshape(
        24, 4)})["q_predicted"].reshape(3, 8)
    got = cem.make_batched_tiled_q_score_fn(model.predict_fn, state)(
        states, actions)
    assert torch.equal(got, want)

  @pytest.mark.parametrize("name, tier", [
      ("tinyq", "f32"), ("tinyq", "bf16"), ("tinyq", "int8"),
      ("flagship0", "bf16"), ("flagship0", "int8"), ("flagship1", "bf16"),
      ("flagship1", "int8"), ("flagship1_f32", "f32"),
      ("flagship1_f32", "bf16"), ("flagship1_f32", "int8")])
  def test_scores_against_jax(self, needs_jax, name, tier):
    want = _jax_scores(name, tier)
    got = _port_scores(name, tier)
    assert got.dtype == torch.float32
    bound = (1e-5 if tier == "f32" and name == "tinyq"
             else _score_bound(name, want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)

  @pytest.mark.parametrize("name", ["tinyq", "flagship1_f32"])
  @pytest.mark.parametrize("tier, fault", [
      ("bf16", "f32_weights"), ("int8", "f32_weights"),
      ("int8", "no_round_trip")])
  def test_the_bound_rejects_a_wrong_tier(self, needs_jax, monkeypatch,
                                          name, tier, fault):
    """Controls: the port's tier score made to read the wrong weights
    falls outside the bound of JAX's scores at that tier."""
    want = _jax_scores(name, tier)
    monkeypatch.setattr(cem, "scoring_weights_view", _FAULTS[fault])
    got = _port_scores(name, tier)
    assert np.abs(got.numpy() - want).max() > _score_bound(name, want)

  def test_uint8_wire_under_the_tiers(self, needs_jax):
    """A uint8-wire flagship under a tier scores its wire (kept uint8
    through the tiling, scaled by the model) as the float wire's scores. The JAX model does not scale
    a floating image, so its uint8-wire critic under a tier scores images
    255 times too bright (the BatchNorm critic's scores move by far more
    than the bound; ROADMAP.md Facts)."""
    options = FLAGSHIP_OPTIONS[0]
    jax_model, model, variables, state = _flagship(options, seed=1)
    wire = t2r_models.QTOptGraspingModel(image_size=64, uint8_images=True,
                                         **options)
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (64, 64, 3), np.uint8)
    actions = torch.from_numpy(rng.uniform(-1, 1, (8, 4)).astype(
        np.float32))
    for tier in ("f32", "bf16", "int8"):
      as_uint8 = cem.make_tiled_q_score_fn(wire.predict_fn, state, tier)(
          torch.from_numpy(image), actions)
      as_float = cem.make_tiled_q_score_fn(model.predict_fn, state, tier)(
          torch.from_numpy(image.astype(np.float32) / 255.0), actions)
      np.testing.assert_allclose(
          as_uint8.float().numpy(), as_float.float().numpy(), rtol=0,
          atol=_score_bound("flagship0", as_float.numpy()))
    jax_wire = jax_models.QTOptGraspingModel(image_size=64,
                                             uint8_images=True, **options)
    f32, bf16 = (np.asarray(jax_cem.make_tiled_q_score_fn(
        jax_wire.predict_fn, variables, tier)(jnp.asarray(image),
                                              jnp.asarray(actions.numpy())))
                 for tier in ("f32", "bf16"))
    assert np.abs(f32 - bf16).max() > _score_bound("flagship0", f32)


def _jax_draws(keys, iterations, samples, action_size=4):
  return np.stack([np.stack([np.asarray(jax.random.normal(
      jax.random.fold_in(k, i), (samples, action_size)))
                             for i in range(iterations)]) for k in keys])


_LABEL_ARGS = (4, 0.8, 16, 4, 2, True)


def _label_inputs():
  rng = np.random.default_rng(8)
  next_images = rng.integers(0, 256, (6, 16, 16, 3), np.uint8)
  rewards = np.asarray([1, 0, 1, 0, 0, 1], np.float32)
  dones = np.asarray([1, 0, 0, 0, 1, 1], np.float32)
  keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(7), s))(
      jnp.arange(6, dtype=jnp.uint32))
  return next_images, rewards, dones, keys


@functools.lru_cache(maxsize=None)
def _label_pair():
  return _tinyq(4)


@functools.lru_cache(maxsize=None)
def _jax_targets(tier, factored):
  """JAX's (targets, q_next) at `tier` on TinyQ seed 4."""
  jax_model, _, variables, _ = _label_pair()
  out = jax_bellman.make_bellman_targets_fn(
      jax_model, *_LABEL_ARGS, factored=factored, precision=tier)(
          variables, *_label_inputs())
  return tuple(np.asarray(x) for x in out)


def _port_targets(tier, factored):
  _, model, _, state = _label_pair()
  next_images, rewards, dones, keys = _label_inputs()
  with torch.inference_mode():
    return bellman.make_bellman_targets_fn(
        model, *_LABEL_ARGS, factored=factored, precision=tier)(
            state, torch.from_numpy(next_images), torch.from_numpy(rewards),
            torch.from_numpy(dones), torch.from_numpy(_jax_draws(keys, 2,
                                                                 16)))


class TestFleetCEMAndLabels:

  @pytest.mark.parametrize("tier", ["bf16", "int8"])
  def test_fleet_cem_with_jax_draws_by_value(self, needs_jax, tier):
    """Twelve states, the JAX draws injected: the port's selected action
    is worth, under the f32 oracle, what JAX's is (within Q_TOL, both
    ways), for every state; the scores of the selected actions sit within
    the bound of JAX's."""
    jax_model, model, variables, state = _tinyq(3)
    images = np.random.default_rng(7).integers(0, 256, (12, 16, 16, 3),
                                               np.uint8)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(9), s))(
        jnp.arange(12, dtype=jnp.uint32))
    want, want_scores = jax_cem.fleet_cem_optimize(
        jax_cem.make_tiled_q_score_fn(jax_model.predict_fn, variables, tier),
        jnp.asarray(images), keys, 4, precision=tier, **CEM)
    got, got_scores = cem.fleet_cem_optimize(
        cem.make_batched_tiled_q_score_fn(model.predict_fn, state, tier),
        torch.from_numpy(images), torch.from_numpy(_jax_draws(keys, 2, 16)),
        4, precision=tier, **CEM)
    assert got_scores.dtype == torch.float32

    def oracle(actions):
      return model.q_value(model.predict_fn(state, {
          "image": torch.from_numpy(images),
          "action": torch.as_tensor(np.array(actions))})).numpy()

    np.testing.assert_array_less(np.abs(oracle(want) - oracle(got.numpy())),
                                 Q_TOL)
    # Where the packages selected the same action, its tier score sits
    # within the bound of JAX's (a bf16 tie can swap an elite and move
    # the mean elsewhere: those states are held by value above).
    same = np.abs(got.numpy() - np.asarray(want)).max(axis=1) < 1e-5
    assert same.sum() >= 6, same
    np.testing.assert_allclose(
        got_scores.numpy()[same], np.asarray(want_scores)[same], rtol=0,
        atol=_score_bound("tinyq", want_scores))

  @pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
  @pytest.mark.parametrize("factored", [False, True])
  def test_bellman_targets_at_each_tier(self, needs_jax, tier, factored):
    want, want_q = _jax_targets(tier, factored)
    got, got_q = _port_targets(tier, factored)
    assert got.dtype == got_q.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    # A target moves by gamma <= 1 times its q_next's move.
    bound = 1e-4 if tier == "f32" else _sigmoid_bound(want_q)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=0, atol=bound)

  @pytest.mark.parametrize("tier, fault", [
      ("bf16", "f32_weights"), ("int8", "f32_weights"),
      ("int8", "no_round_trip")])
  def test_labels_reject_a_wrong_tier(self, needs_jax, monkeypatch, tier,
                                      fault):
    """Controls on the factored label path (the megastep's and the Anakin
    loop's): the encode and the scores made to read the wrong weights
    fall outside the bound of JAX's labels at that tier."""
    _, want_q = _jax_targets(tier, True)
    monkeypatch.setattr(cem, "scoring_weights_view", _FAULTS[fault])
    _, got_q = _port_targets(tier, True)
    assert np.abs(got_q.numpy() - want_q).max() > _sigmoid_bound(want_q)

  def test_updater_labels_at_the_tier_and_td_stays_f32(self):
    model = smoke.TinyQCriticModel(image_size=8)
    state = model.init_variables(torch.Generator().manual_seed(5),
                                 device="cpu")
    batch = {"next_image": np.full((4, 8, 8, 3), 9, np.uint8),
             "image": np.full((4, 8, 8, 3), 7, np.uint8),
             "action": np.zeros((4, 4), np.float32),
             "reward": np.zeros(4, np.float32),
             "done": np.zeros(4, np.float32)}
    out = {}
    for tier in cem.SCORING_PRECISIONS:
      updater = bellman.BellmanUpdater(model, state, precision=tier,
                                       device="cpu", **CEM)
      targets, _ = updater.compute_targets(batch, seeds=np.arange(4))
      td = updater.td_errors(state, batch, targets)
      out[tier] = targets
      assert updater.precision == tier and td.dtype == np.float32
    # One TD function under every tier: the same targets give the same TD.
    f32 = bellman.BellmanUpdater(model, state, device="cpu", **CEM)
    np.testing.assert_array_equal(
        f32.td_errors(state, batch, out["bf16"]),
        bellman.BellmanUpdater(model, state, precision="bf16", device="cpu",
                               **CEM).td_errors(state, batch, out["bf16"]))


def _policy(tier, seed=0, image_size=16, bucket=4):
  model = smoke.TinyQCriticModel(image_size=image_size)
  predictor = loop._HotReloadPredictor(model, model.init_variables(
      torch.Generator().manual_seed(seed), device="cpu"))
  from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
  return model, predictor, CEMFleetPolicy(
      predictor, action_size=4, seed=11, ladder=BucketLadder((bucket,)),
      precision=tier, **CEM)


class TestFleetPolicyTiers:

  def test_int8_placement_and_hot_reload(self):
    """The int8 policy keeps int8 weights and float32 scales; a reload
    quantizes into the same tensors and builds nothing; the actions are
    the eager tiered search over the live variables'."""
    model, predictor, policy = _policy("int8")
    images = list(np.random.default_rng(9).integers(0, 256, (4, 16, 16, 3),
                                                    np.uint8))
    seeds = np.arange(4, dtype=np.uint32)
    first = policy(images, seeds)
    served = policy._served
    pointers = {k: v["int8_q"].data_ptr() for k, v in served.items()
                if cem._is_quant_wrapper(v)}
    assert pointers and all(
        served[k]["int8_q"].dtype == torch.int8
        and served[k]["int8_scale"].dtype == torch.float32 for k in pointers)
    fresh = model.init_variables(torch.Generator().manual_seed(1),
                                 device="cpu")
    predictor.set_variables(fresh)
    second = policy(images, seeds)
    assert not np.array_equal(first, second)
    assert {k: served[k]["int8_q"].data_ptr() for k in pointers} == pointers
    want = cem.quantize_scoring_variables(fresh)
    assert all(torch.equal(served[k]["int8_q"], want[k]["int8_q"])
               and torch.equal(served[k]["int8_scale"], want[k]["int8_scale"])
               for k in pointers)
    assert policy.compile_counts == {4: 1}
    best, _ = cem.fleet_cem_optimize(
        cem.make_batched_tiled_q_score_fn(model.predict_fn, fresh, "int8"),
        torch.from_numpy(np.stack(images)),
        torch.from_numpy(policy.noise_for(seeds)), 4, precision="int8",
        **CEM)
    np.testing.assert_array_equal(second, best.numpy())

  @pytest.mark.parametrize("tier", ["bf16", "int8"])
  def test_host_fallback_refuses_the_tier(self, tier):
    class HostOnly:
      model_version = 0

      def device_fn(self):
        raise NotImplementedError

      def predict(self, features):
        raise AssertionError("a low tier must not score through predict")

    policy = CEMFleetPolicy(HostOnly(), precision=tier, **CEM)
    with pytest.raises(ValueError, match=f"{tier!r}.*supported tiers"):
      policy([np.zeros((16, 16, 3), np.uint8)], [0])


class TestBenches:

  def test_precision_bench_phase_one_miniature(self):
    model, variables, loss = precision_bench._pretrain_critic(
        16, 4, 0.8, 0.4, steps=80, batch_size=64, seed=0, device="cpu")
    assert np.isfinite(loss)
    book = ExecutableLedger()
    agreement = precision_bench._measure_agreement(
        model, variables, (1, 2, 4), 16, precision_bench.R14_Q_TOL,
        precision_bench.R14_GEO_TOL, 16, 4, 2, 4, 16, 0, ledger=book)
    assert agreement["pairs"] == 48
    assert agreement["overall_rate"] >= precision_bench.R14_AGREEMENT_BAR
    # The paired policies' builds, once a bucket a tier (the seed-noise
    # control stays off the ledger).
    assert book.compile_counts == {
        f"cem_bucket_{b}{t}": 1 for b in (1, 2, 4) for t in ("", "_bf16")}
    assert agreement["seed_noise_control"]["pairs"] == 16
    int8 = tpquant_bench._measure_int8_agreement(
        model, variables, (4,), 16, tpquant_bench.R17_Q_TOL, 16, 4, 2, 4,
        16, 0)
    assert int8["overall_rate"] >= tpquant_bench.R17_INT8_AGREEMENT_BAR

  def test_bytes_reduction_equals_jax(self, needs_jax):
    ours = tpquant_bench._flagship_bytes_reduction(64, 0)
    theirs = jax_tpquant._flagship_bytes_reduction(64, 0)
    assert {k: round(v, 3) for k, v in ours.items()} == theirs
    assert ours["flagship"] >= tpquant_bench.R17_INT8_BYTES_REDUCTION_BAR

  @pytest.mark.parametrize("call, item", [
      # The ladder runs (tests/test_torch_mesh_loop.py); it refuses a
      # ladder without its tp=1 oracle rung.
      (lambda: tpquant_bench._measure_tp_ladder(ladder=(2,)), "tp=1"),
      (None, None),
  ], ids=["tp_ladder", "cast_seam"])
  def test_refusals_that_stay(self, call, item):
    if call is None:
      self._cast_seam_installs_at_the_live_dtype()
      return
    with pytest.raises(ValueError, match=item):
      call()

  @staticmethod
  def _cast_seam_installs_at_the_live_dtype():
    """The hot-reload predictor's cast seam (it refused until the
    predictors' set_variables was ported): a bf16 candidate without
    cast=True raises ValueError; with it, its values land at the served
    float32 dtype and the policy serves them with no rebuild."""
    model, predictor, policy = _policy("f32")
    images = list(np.random.default_rng(9).integers(
        0, 256, (4, 16, 16, 3), np.uint8))
    seeds = np.arange(4, dtype=np.uint32)
    policy(images, seeds)
    fresh = model.init_variables(torch.Generator().manual_seed(5),
                                 device="cpu")
    drifted = {k: v.bfloat16() if v.is_floating_point() else v
               for k, v in fresh.items()}
    with pytest.raises(ValueError, match="cast=True"):
      predictor.set_variables(drifted)
    with pytest.raises(ValueError, match="keys"):
      predictor.set_variables({}, cast=True)
    predictor.set_variables(drifted, version=9, cast=True)
    served = predictor.device_fn()[1]
    assert predictor.model_version == 9
    for key, value in served.items():
      assert value.dtype == fresh[key].dtype
      assert torch.equal(value, drifted[key].to(fresh[key].dtype))
    ledger = dict(policy.compile_counts)
    predictor.update(served)  # the same values through update()
    want = policy(images, seeds)
    predictor.set_variables(drifted, cast=True)
    np.testing.assert_array_equal(policy(images, seeds), want)
    assert policy.compile_counts == ledger


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", cem.SCORING_PRECISIONS)
def test_policy_graph_equals_eager_on_the_card(cuda_device, tier):
  """Each tier's bucket graph against its eager control, bit for bit with
  cuDNN deterministic, captured once over a hot reload."""
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    model = smoke.TinyQCriticModel()
    predictor = loop._HotReloadPredictor(model, model.init_variables(
        torch.Generator().manual_seed(0), device=cuda_device))
    policy = CEMFleetPolicy(predictor, action_size=4, seed=3,
                            precision=tier, **CEM)
    images = list(np.random.default_rng(1).integers(0, 256, (4, 16, 16, 3),
                                                    np.uint8))
    seeds = np.arange(4, dtype=np.uint32)
    for reload in range(2):
      if reload:
        predictor.set_variables(model.init_variables(
            torch.Generator().manual_seed(reload), device=cuda_device))
      graphed, scores = policy(images, seeds, return_scores=True)
      fn, _ = predictor.device_fn()
      with torch.inference_mode():
        eager, eager_scores = policy._control(
            fn, torch.from_numpy(np.stack(images)).to(cuda_device),
            torch.from_numpy(policy.noise_for(seeds)).to(cuda_device))
      np.testing.assert_array_equal(graphed, eager.cpu().numpy())
      np.testing.assert_array_equal(scores, eager_scores.cpu().numpy())
    assert policy.compile_counts == {4: 1}
  finally:
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_megastep_bf16_graph_equals_eager_on_the_card(cuda_device):
  """The megastep's label stage at bf16: two dispatches graphed (the
  second captured) against two eager, bit for bit."""
  from tensor2robot_tpu_torch.replay import learner_bench
  from tensor2robot_tpu_torch.replay.device_buffer import (
      DeviceReplayBuffer,
      MegastepLearner,
  )
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils import optimizers
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    runs = []
    for graphs in (True, False):
      model = smoke.TinyQCriticModel(
          optimizer_fn=optimizers.create_adam_optimizer(3e-3))
      trainer = Trainer(model, seed=0, device=cuda_device)
      state = trainer.create_train_state()
      ring = DeviceReplayBuffer(loop.transition_spec(16, 4), 256, 32,
                                seed=0, prioritized=True, ingest_chunk=64,
                                device=cuda_device)
      ring.extend(learner_bench._synthetic_transitions(256, 16, 4, 5))
      learner = MegastepLearner(model, trainer, ring, inner_steps=3,
                                precision="bf16", graphs=graphs, **CEM)
      learner.refresh(state.variables(use_ema=True), step=0)
      metrics = []
      for _ in range(2):
        state, out = learner.step(state)
        metrics.append(out)
      runs.append(metrics)
    assert runs[0] == runs[1]
  finally:
    torch.backends.cudnn.deterministic = deterministic
