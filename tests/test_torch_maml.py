"""The port's MAML slice held against the JAX package.

On the CPU: the meta data and the two-object meta-reaching tasks bit for
bit; MAML weights carried across the bridge both ways, learned inner rates
included; ``MAMLModel`` against JAX's with the same weights (the mock in
EVAL, the pose_env MAML model at 16x16 in TRAIN: outer gradients at second
order, first order and with learned rates, and Adam's first update); the
dropout generator's masks; the adaptation bar of the JAX test; the
meta-export served by the JAX package; the config and the capability
check in miniature. The tests marked ``cuda`` hold MAML's CUDA graphs
against eager steps and count K1's launches on the card.
"""

import dataclasses
import functools
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none, and runs the cuda tests only
  import jax
  import jax.numpy as jnp
  import optax
  from tensor2robot_tpu import config as jax_config
  from tensor2robot_tpu.export import variables_io as jax_variables_io
  from tensor2robot_tpu.meta_learning import (
      MAMLModel as JaxMAML,
      meta_batch_from_arrays as jax_meta_batch,
      multi_batch_apply as jax_multi_batch_apply,
  )
  from tensor2robot_tpu.research.pose_env import meta_reaching as jax_mr
  from tensor2robot_tpu.research.pose_env import (
      pose_env_maml_models as jax_maml_models,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
  from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge, config, modes  # noqa: E402
from tensor2robot_tpu_torch.bin import (  # noqa: E402
    run_capability_checks,
    run_t2r_trainer,
)
from tensor2robot_tpu_torch.export import export_utils  # noqa: E402
from tensor2robot_tpu_torch.export.native_export_generator import (  # noqa: E402
    NativeExportGenerator,
)
from tensor2robot_tpu_torch.meta_learning import (  # noqa: E402
    MAMLModel,
    meta_batch_from_arrays,
    multi_batch_apply,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    meta_reaching as mr,
    pose_env_maml_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import mocks  # noqa: E402
from tensor2robot_tpu_torch.utils.optimizers import (  # noqa: E402
    create_adam_optimizer,
)

IMAGE = 16
# Port vs JAX at float32: the same sums in other orders. An outer gradient
# goes through three inner steps' second derivatives; every tensor sits
# within GRAD_RTOL of the largest gradient of the tree (measured: 2e-7 of
# it at most).
GRAD_RTOL = 1e-5
# tower.conv0's bias feeds a GroupNorm of one channel a group, which
# normalises it away: its exact gradient is 0, and both sides hold rounding
# noise, each under NOISE_RTOL of the tree's largest gradient.
NOISE_ONLY = ("tower.conv0.bias",)
NOISE_RTOL = 1e-4
OUT_ATOL = OUT_RTOL = 1e-5  # EVAL outputs and losses, float32
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CFG = os.path.join(_REPO_ROOT, "tensor2robot_tpu", "research",
                       "pose_env", "configs", "pose_env_maml_train.cfg")
PORT_CFG = os.path.join(_REPO_ROOT, "tensor2robot_tpu_torch", "research",
                        "pose_env", "configs", "pose_env_maml_train.cfg")


@pytest.fixture(autouse=True)
def _clean_configs():
  """Bindings are process-wide in both packages: none leaks in or out."""
  config.clear_config()
  if jax is not None:
    jax_config.clear_config()
  yield
  config.clear_config()
  if jax is not None:
    jax_config.clear_config()


def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _torch_struct(struct):
  return ts.TensorSpecStruct(
      (k, torch.from_numpy(np.asarray(v))) for k, v in struct.items())


def _jax_struct(struct):
  return jax_ts.TensorSpecStruct(
      (k, jnp.asarray(np.asarray(v))) for k, v in struct.items())


def _mock_meta(num_tasks, seed, k_c=4, k_i=2):
  rng = np.random.default_rng(seed)
  pool = k_c + k_i
  return meta_batch_from_arrays(
      ts.TensorSpecStruct(
          {"x": rng.standard_normal((num_tasks, pool, 3)).astype(
              np.float32)}),
      ts.TensorSpecStruct(
          {"target": rng.standard_normal((num_tasks, pool, 1)).astype(
              np.float32)}), k_c, k_i)


def _port_variables(jax_variables, model, grad=False):
  """The JAX variables as the port model's state_dict (parameters that
  require grad when `grad`)."""
  state = bridge.variables_to_state_dict(jax.device_get(jax_variables),
                                         model.module)
  names = {n for n, _ in model.module.named_parameters()}
  return {k: (v.clone().requires_grad_() if grad and k in names else v)
          for k, v in state.items()}


class TestMetaData:

  def test_multi_batch_apply_matches_jax(self):
    _needs_jax()
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    y = np.arange(2 * 3, dtype=np.float32).reshape(2, 3, 1)

    def fn(a, b):
      return {"sum": a * 2 + b, "first": a[:, :1]}

    got = multi_batch_apply(fn, 2, x, y)
    want = jax_multi_batch_apply(fn, 2, jnp.asarray(x), jnp.asarray(y))
    for key in want:
      np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    torch_got = multi_batch_apply(fn, 2, torch.from_numpy(x),
                                  torch.from_numpy(y))
    np.testing.assert_array_equal(torch_got["sum"].numpy(), got["sum"])

  @pytest.mark.parametrize("shuffle", [False, True])
  def test_meta_batch_from_arrays_bit_for_bit(self, shuffle):
    _needs_jax()
    features = {"x": np.arange(3 * 7 * 2, dtype=np.float32).reshape(3, 7, 2)}
    labels = {"target": np.arange(3 * 7, dtype=np.float32).reshape(3, 7, 1)}
    rngs = [np.random.default_rng(5) if shuffle else None for _ in range(2)]
    got = meta_batch_from_arrays(ts.TensorSpecStruct(features),
                                 ts.TensorSpecStruct(labels), 4, 2, rngs[0])
    want = jax_meta_batch(jax_ts.TensorSpecStruct(features),
                          jax_ts.TensorSpecStruct(labels), 4, 2, rngs[1])
    assert list(got.keys()) == list(want.keys())
    for key in want:
      np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="pool"):
      meta_batch_from_arrays(ts.TensorSpecStruct(features),
                             ts.TensorSpecStruct(labels), 5, 3)


class TestMetaReaching:

  @pytest.mark.parametrize("args", [(4, 3, 2, 32, 0, 0.0),
                                    (8, 4, 4, 64, 100_000, 0.22)])
  def test_meta_batch_bit_for_bit(self, args):
    _needs_jax()
    tasks, k_c, k_i, size, seed, noise = args
    got, got_info = mr.sample_meta_batch(tasks, k_c, k_i, image_size=size,
                                         seed=seed,
                                         condition_label_noise=noise)
    want, want_info = jax_mr.sample_meta_batch(
        tasks, k_c, k_i, image_size=size, seed=seed,
        condition_label_noise=noise)
    assert list(got.keys()) == list(want.keys())
    for key in want:
      np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for key in want_info:
      np.testing.assert_array_equal(got_info[key], want_info[key])
    predictions = np.random.default_rng(1).uniform(
        -1, 1, got_info["query_target"].shape).astype(np.float32)
    for radius in (mr.OBJECT_RADIUS, mr.OBJECT_RADIUS / 2):
      assert mr.reach_success(predictions, got_info, radius) == (
          jax_mr.reach_success(predictions, want_info, radius))

  def test_noise_jitters_condition_labels_only(self):
    clean, info_c = mr.sample_meta_batch(4, 3, 2, image_size=32, seed=7)
    noisy, info_n = mr.sample_meta_batch(4, 3, 2, image_size=32, seed=7,
                                         condition_label_noise=0.1)
    delta = np.abs(noisy["condition/labels/target_pose"]
                   - clean["condition/labels/target_pose"])
    assert delta.max() > 0.01
    np.testing.assert_array_equal(noisy["inference/labels/target_pose"],
                                  clean["inference/labels/target_pose"])
    assert mr.reach_success(info_n["query_target"],
                            info_n)["success_rate"] == 1.0
    assert mr.reach_success(info_c["query_target"],
                            info_c)["wrong_object_rate"] == 0.0


class TestBridge:

  @pytest.mark.parametrize("learn_inner_lr", [False, True])
  def test_maml_weights_cross_both_ways(self, learn_inner_lr):
    """The JAX tree (base params, or {base, inner_lrs}, and the base's
    batch statistics) maps onto the port's state_dict and back leaf for
    leaf, the rates at inner_lrs.<base key>."""
    _needs_jax()
    jax_model = JaxMAML(JaxMock(use_batch_norm=True), inner_lr=0.05,
                        learn_inner_lr=learn_inner_lr)
    want = jax.device_get(jax_model.init_variables(jax.random.key(0)))
    model = MAMLModel(mocks.MockT2RModel(use_batch_norm=True),
                      inner_lr=0.05, learn_inner_lr=learn_inner_lr)
    state = bridge.variables_to_state_dict(want, model.module)
    assert list(state) == list(model.module.state_dict())
    rates = [k for k in state if k.startswith("inner_lrs.")]
    assert len(rates) == (6 if learn_inner_lr else 0)
    for key in rates:
      assert state[key].shape == () and float(state[key]) == pytest.approx(
          0.05)
      assert key[len("inner_lrs."):] in state
    back = bridge.state_dict_to_variables(state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for got, expected in zip(jax.tree_util.tree_leaves(back),
                             jax.tree_util.tree_leaves(want)):
      np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    # The port's own init has the same layout and rates.
    fresh = model.init_variables(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert set(fresh) == set(state)
    assert all(float(fresh[k]) == pytest.approx(0.05) for k in rates)
    # An EMA copy (params only) maps too.
    ema = bridge.params_to_state_dict(want["params"], model.module)
    assert set(ema) == {n for n, _ in model.module.named_parameters()}


_VARIANTS = {"second_order": {}, "first_order": {"first_order": True},
             "learned_rates": {"learn_inner_lr": True}}
_POSE_MAML = dict(num_inner_steps=2, inner_lr=0.05, num_condition_samples=3,
                  num_inference_samples=2, image_size=IMAGE)


def _pose_maml(variant):
  return pose_env_maml_models.pose_env_maml_model(**_POSE_MAML,
                                                  **_VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _jax_outer(variant):
  """JAX's pose_env MAML loss, inner loss and outer gradients (jitted) on
  3 meta-reaching tasks at 16x16: (variables, meta, loss, inner loss,
  gradients), all on the host."""
  model = jax_maml_models.pose_env_maml_model(**_POSE_MAML,
                                              **_VARIANTS[variant])
  variables = jax.device_get(model.init_variables(jax.random.key(0)))
  meta, _ = mr.sample_meta_batch(3, 3, 2, image_size=IMAGE, seed=3,
                                 condition_label_noise=0.2)

  def loss_fn(params):
    loss, (metrics, _) = model.model_train_fn(
        {**variables, "params": params}, _jax_struct(meta), None)
    return loss, metrics["inner_loss_final"]

  (loss, inner), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      variables["params"])
  return variables, meta, float(loss), float(inner), jax.device_get(grads)


def _jax_mock_maml(**kwargs):
  return JaxMAML(JaxMock(compute_dtype=jnp.float32,
                         use_batch_norm=kwargs.pop("use_batch_norm")),
                 optimizer_fn=lambda: optax.adam(1e-3), **kwargs)


def _port_mock_maml(**kwargs):
  return MAMLModel(mocks.MockT2RModel(
      compute_dtype=torch.float32,
      use_batch_norm=kwargs.pop("use_batch_norm")), **kwargs)


class TestMAMLAgainstJax:

  @pytest.mark.parametrize("use_batch_norm", [False, True])
  @pytest.mark.parametrize("learn_inner_lr", [False, True])
  def test_mock_eval_outputs_and_losses(self, use_batch_norm,
                                        learn_inner_lr):
    """MockT2RModel (float32) wrapped in MAML, 2 inner steps, in EVAL:
    query outputs, condition_loss and the metrics within OUT_ATOL plus
    OUT_RTOL of their size."""
    _needs_jax()
    kwargs = dict(use_batch_norm=use_batch_norm, num_inner_steps=2,
                  inner_lr=0.3, learn_inner_lr=learn_inner_lr,
                  num_condition_samples=4, num_inference_samples=2)
    jax_model, model = _jax_mock_maml(**kwargs), _port_mock_maml(**kwargs)
    variables = jax_model.init_variables(jax.random.key(3))
    meta = _mock_meta(5, seed=2)
    want = jax_model.model_eval_fn(
        variables, _jax_struct(meta), None)
    want_out, _ = jax_model.inference_network_fn(
        variables, _jax_struct(meta), modes.EVAL)
    port_vars = _port_variables(variables, model)
    with torch.no_grad():  # as the trainer's eval step
      got = model.model_eval_fn(port_vars, _torch_struct(meta), None)
    got_out, state = model.inference_network_fn(
        port_vars, _torch_struct(meta), modes.EVAL)
    assert state == {}
    for key in ("inference_output", "condition_loss"):
      np.testing.assert_allclose(got_out[key].detach().numpy(),
                                 np.asarray(want_out[key]), rtol=OUT_RTOL,
                                 atol=OUT_ATOL)
    assert set(got) == set(want)
    for key in ("outer_loss", "inner_loss_final", "mse", "loss"):
      assert float(got[key]) == pytest.approx(float(want[key]),
                                              rel=OUT_RTOL, abs=OUT_ATOL)
    # Adaptation is live: with no inner step the outputs differ.
    unadapted, _ = _port_mock_maml(**{**kwargs, "num_inner_steps": 0}
                                   ).inference_network_fn(
                                       port_vars, _torch_struct(meta),
                                       modes.EVAL)
    assert (got_out["inference_output"]
            - unadapted["inference_output"]).abs().max() > 1e-4

  @pytest.mark.parametrize("variant", ["second_order", "first_order",
                                       "learned_rates"])
  def test_pose_env_outer_gradients(self, variant):
    """The pose_env MAML model (GroupNorm, float32, K1 on the path) at
    16x16 in TRAIN: 3 tasks of 3 + 2 scenes, 2 inner steps. The outer
    loss and the inner loss within OUT_ATOL; every outer gradient, the
    learned rates' included, within GRAD_RTOL of the tree's largest."""
    _needs_jax()
    variables, meta, want_loss, want_metrics, want_grads = _jax_outer(
        variant)
    model = _pose_maml(variant)
    port_vars = _port_variables(variables, model, grad=True)
    loss, (metrics, state) = model.model_train_fn(port_vars,
                                                  _torch_struct(meta), None)
    loss.backward()
    assert state == {}
    assert float(loss.detach()) == pytest.approx(want_loss, abs=OUT_ATOL)
    assert float(metrics["inner_loss_final"]) == pytest.approx(
        want_metrics, abs=OUT_ATOL)
    want = bridge.params_to_state_dict(want_grads, model.module)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    names = [n for n, _ in model.module.named_parameters()]
    assert set(want) == set(names)
    assert any(n.startswith("inner_lrs.") for n in names) == (
        variant == "learned_rates")
    for name in names:
      got = port_vars[name].grad.numpy()
      if name in NOISE_ONLY:
        assert np.abs(got).max() <= NOISE_RTOL * scale, name
        assert np.abs(want[name].numpy()).max() <= NOISE_RTOL * scale, name
        continue
      np.testing.assert_allclose(got, want[name].numpy(), rtol=0,
                                 atol=GRAD_RTOL * scale, err_msg=name)

  def test_adam_first_update_matches_jax(self):
    """One meta-step through the port's Trainer from the JAX weights:
    Adam's first update equals optax.adam's on the JAX gradients (ROADMAP
    Facts: compare updates, not parameters after several steps) within
    1e-6 where the gradient is well above Adam's eps; elsewhere it is a
    step of at most the rate."""
    _needs_jax()
    lr = 1e-3
    variables, meta, _, _, grads = _jax_outer("second_order")
    optimizer = optax.adam(lr)
    updates, _ = optimizer.update(grads, optimizer.init(variables["params"]),
                                  variables["params"])
    model = _pose_maml("second_order")
    model._optimizer_fn = create_adam_optimizer(lr)
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(variables)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = trainer.train_step(state, _torch_struct(meta), None)
    want_delta = bridge.params_to_state_dict(jax.device_get(updates),
                                             model.module)
    grad = bridge.params_to_state_dict(grads, model.module)
    for name, value in state.params.items():
      delta = (value.detach() - start[name]).numpy()
      want = want_delta[name].numpy()
      big = np.abs(grad[name].numpy()) > 1e-6
      np.testing.assert_allclose(delta[big], want[big], rtol=0, atol=1e-6,
                                 err_msg=name)
      assert np.all(np.abs(delta) <= 1.011 * lr), name

  def test_factory_optimizer_reaches_the_base_only(self):
    """Reference quirk kept for the bar's sake: both factories hand
    `optimizer_fn` to the base model, so the MAML model trains with its
    own default, Adam 1e-4 (the JAX check's bar was measured so)."""
    _needs_jax()
    model = pose_env_maml_models.pose_env_maml_model(
        image_size=IMAGE, optimizer_fn=create_adam_optimizer(1e-3))
    optimizer = model.create_optimizer([torch.zeros(2, requires_grad=True)])
    assert optimizer.param_groups[0]["lr"] == 1e-4
    base = model.base_model.create_optimizer(
        [torch.zeros(2, requires_grad=True)])
    assert base.param_groups[0]["lr"] == 1e-3
    jax_model = jax_maml_models.pose_env_maml_model(
        image_size=IMAGE, optimizer_fn=lambda: optax.adam(1e-3))
    assert jax_model._optimizer_fn is None
    assert jax_model.base_model._optimizer_fn is not None


class TestMAMLModel:

  def test_spec_shapes_and_layout(self):
    model = _port_mock_maml(use_batch_norm=False, num_condition_samples=5,
                            num_inference_samples=3)
    spec = model.get_feature_specification(modes.TRAIN)
    assert spec["condition/features/x"].shape == (5, 3)
    assert spec["inference/features/x"].shape == (3, 3)
    assert spec["condition/labels/target"].shape == (5, 1)
    assert list(model.get_label_specification(modes.TRAIN).keys()) == []

  def test_second_order_differs_from_first_order(self):
    def grads(first_order):
      model = _port_mock_maml(use_batch_norm=False, first_order=first_order,
                              inner_lr=0.1)
      variables = model.init_variables(torch.Generator().manual_seed(0),
                                       device="cpu")
      names = [n for n, _ in model.module.named_parameters()]
      variables = {k: (v.requires_grad_() if k in names else v)
                   for k, v in variables.items()}
      loss, _ = model.model_train_fn(variables,
                                     _torch_struct(_mock_meta(4, seed=0)),
                                     None,
                                     generator=torch.Generator().manual_seed(
                                         1))
      return torch.autograd.grad(loss, [variables[n] for n in names])

    diffs = [float((a - b).abs().max())
             for a, b in zip(grads(True), grads(False))]
    assert max(diffs) > 1e-7

  def test_batch_norm_statistics_never_change(self):
    """A BatchNorm base normalises each support set by itself, and the
    inner loop's statistics are thrown away: the variables' running
    statistics stay at their init through meta-training."""
    model = _port_mock_maml(use_batch_norm=True, num_inner_steps=2)
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state()
    init = {k: v.clone() for k, v in state.model_state.items()}
    assert set(init) == {"BatchNorm_0.running_mean",
                         "BatchNorm_0.running_var"}
    for step in range(3):
      state, metrics = trainer.train_step(
          state, _torch_struct(_mock_meta(4, seed=step)), None)
      assert np.isfinite(float(metrics["loss"]))
    for key, value in state.model_state.items():
      torch.testing.assert_close(value, init[key], rtol=0, atol=0)

  def test_dropout_masks(self, monkeypatch):
    """Masks are a function of the seed and the step: they differ across
    steps, tasks and inner steps, and repeat for the same seed and step
    (so after a resume)."""
    masks = []
    real = mocks.dropout

    def recording(x, rate, train, generator):
      y = real(x, rate, train, generator)
      if train:
        masks.append((y == 0) & (x != 0))
      return y

    monkeypatch.setattr(mocks, "dropout", recording)

    def step_masks(seed, step):
      masks.clear()
      model = _port_mock_maml(use_batch_norm=False, num_inner_steps=2)
      trainer = Trainer(model, seed=seed, device="cpu")
      state = dataclasses.replace(trainer.create_train_state(), step=step)
      trainer.train_step(state, _torch_struct(_mock_meta(3, seed=0)), None)
      return [m.clone() for m in masks]

    first = step_masks(0, 5)
    assert len(first) == 3 * 3  # 3 tasks x (2 inner steps + the query)
    flat = [m.flatten() for m in first]
    assert all(m.any() for m in flat)
    assert len({tuple(m.tolist()) for m in flat}) == len(flat)
    for again in (step_masks(0, 5), step_masks(0, 5)):
      assert all(torch.equal(a, b) for a, b in zip(first, again))
    other_step, other_seed = step_masks(0, 6), step_masks(1, 5)
    assert not all(torch.equal(a, b) for a, b in zip(first, other_step))
    assert not all(torch.equal(a, b) for a, b in zip(first, other_seed))
    with pytest.raises(ValueError, match="generator"):
      model = _port_mock_maml(use_batch_norm=False)
      model.model_train_fn(
          model.init_variables(device="cpu"),
          _torch_struct(_mock_meta(2, seed=0)), None)

  def test_adaptation_beats_no_adaptation(self):
    """The JAX test's bar: meta-train on linear tasks y = w_t x (600
    meta-steps of 8 tasks, 3 inner steps, float32); on fresh tasks the
    adapted query loss is under half the unadapted one."""
    def make_meta_batch(num_tasks, seed):
      task_rng = np.random.default_rng(seed)
      ws = task_rng.uniform(-2, 2, size=(num_tasks, 3, 1))
      xs = task_rng.standard_normal((num_tasks, 16, 3)).astype(np.float32)
      ys = np.einsum("tnd,tdo->tno", xs, ws).astype(np.float32)
      return _torch_struct(meta_batch_from_arrays(
          ts.TensorSpecStruct({"x": xs}),
          ts.TensorSpecStruct({"target": ys}), 8, 8))

    def build(num_inner_steps):
      return MAMLModel(
          mocks.MockT2RModel(compute_dtype=torch.float32),
          num_inner_steps=num_inner_steps, inner_lr=0.05,
          num_condition_samples=8, num_inference_samples=8,
          optimizer_fn=create_adam_optimizer(3e-3))

    model = build(3)
    trainer = Trainer(model, seed=0, device="cpu")
    state = trainer.create_train_state()
    for step in range(600):
      state, _ = trainer.train_step(state, make_meta_batch(8, step), None)
    features = make_meta_batch(16, 10_000)
    variables = state.variables()

    def query_loss(m):
      with torch.no_grad():
        return float(m.model_eval_fn(variables, features, None)["outer_loss"])

    adapted, unadapted = query_loss(model), query_loss(build(0))
    assert adapted < unadapted * 0.5, (adapted, unadapted)

  def test_group_norm_default_and_mode_consistency(self):
    """The pose_env factory's base has no batch statistics, and its
    adapt-then-predict forward gives the same outputs in TRAIN and EVAL."""
    model = pose_env_maml_models.pose_env_maml_model(
        num_condition_samples=2, num_inference_samples=2, image_size=IMAGE)
    variables = model.init_variables(torch.Generator().manual_seed(0),
                                     device="cpu")
    assert not list(model.module.buffers())
    meta, _ = mr.sample_meta_batch(2, 2, 2, image_size=IMAGE, seed=3)
    with torch.no_grad():
      train, _ = model.inference_network_fn(variables, _torch_struct(meta),
                                            modes.TRAIN)
      evaluated, _ = model.inference_network_fn(
          variables, _torch_struct(meta), modes.EVAL)
    torch.testing.assert_close(train["inference_output"],
                               evaluated["inference_output"], rtol=0,
                               atol=1e-5)
    assert model.base_model.compute_dtype == torch.float32


class TestMAMLServing:

  def _export(self, tmp_path, learn_inner_lr):
    model = MAMLModel(mocks.MockT2RModel(), num_condition_samples=4,
                      num_inference_samples=2,
                      learn_inner_lr=learn_inner_lr)
    variables = model.init_variables(torch.Generator().manual_seed(0),
                                     device="cpu")
    generator = NativeExportGenerator(export_root=str(tmp_path / "export"))
    generator.set_specification_from_model(model)
    export_dir = export_utils.export_and_gc(generator, variables, keep=1)
    return model, generator.export_root, export_dir

  @pytest.mark.parametrize("learn_inner_lr", [False, True])
  def test_meta_export_round_trip(self, tmp_path, learn_inner_lr):
    """The port's meta-export answers requests with condition data by
    adapt-then-forward; the JAX package serves the same export through
    its variables_io and inference_network_fn to the same outputs."""
    model, root, export_dir = self._export(tmp_path, learn_inner_lr)
    predictor = ExportedModelPredictor(model, root, device="cpu")
    assert predictor.restore()
    rng = np.random.default_rng(0)
    batch = {
        "condition/features/x": rng.random((3, 4, 3)).astype(np.float32),
        "condition/labels/target": rng.random((3, 4, 1)).astype(np.float32),
        "inference/features/x": rng.random((3, 2, 3)).astype(np.float32),
        "inference/labels/target": rng.random((3, 2, 1)).astype(np.float32),
    }
    out = predictor.predict(batch)
    assert out["inference_output"].shape == (3, 2, 1)
    assert out["condition_loss"].shape == (3,)
    moved = dict(batch)
    moved["condition/labels/target"] = batch["condition/labels/target"] + 5
    assert np.abs(predictor.predict(moved)["inference_output"]
                  - out["inference_output"]).max() > 1e-6
    fn, variables = predictor.device_fn()
    direct = fn(variables, _torch_struct(batch))
    np.testing.assert_array_equal(
        direct["inference_output"].float().numpy(), out["inference_output"])
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
      fn(variables, _torch_struct(batch))
    _needs_jax()
    jax_model = JaxMAML(JaxMock(), num_condition_samples=4,
                        num_inference_samples=2,
                        learn_inner_lr=learn_inner_lr)
    jax_vars = jax_variables_io.load_variables(
        os.path.join(export_dir, export_utils.VARIABLES_NPZ))
    want, _ = jax_model.inference_network_fn(
        jax_vars, _jax_struct(batch), modes.PREDICT)
    # bfloat16 compute on both sides: within a few bf16 ulps of the output.
    np.testing.assert_allclose(out["inference_output"],
                               np.asarray(want["inference_output"],
                                          np.float32), rtol=0, atol=2e-2)
    np.testing.assert_allclose(out["condition_loss"],
                               np.asarray(want["condition_loss"]), rtol=0,
                               atol=2e-2)


class TestConfigAndCheck:

  def test_cfg_parses_to_the_jax_bindings(self):
    _needs_jax()

    def bindings(module, path):
      module.clear_config()
      with open(path) as f:
        module.parse_config(f.read())
      out = {k: repr(v) for k, v in module.config._BINDINGS.items()}
      module.clear_config()
      return out

    assert bindings(config, PORT_CFG) == bindings(jax_config, JAX_CFG)
    assert bindings(config, PORT_CFG) == bindings(config, JAX_CFG)

  def test_cfg_trains_through_the_cli(self, tmp_path):
    """The port's pose_env_maml_train.cfg through its CLI, at a miniature
    binding, with both configurable names."""
    for name in ("pose_env_maml_model", "PoseEnvRegressionModelMAML"):
      run = tmp_path / name
      args = ["--config", PORT_CFG, "--import_module",
              "tensor2robot_tpu_torch.research.pose_env."
              "pose_env_maml_models",
              "--binding", f"train_eval_model.model = @{name}()",
              "--binding", f"{name}.image_size = 16",
              "--binding", "DefaultRandomInputGenerator.batch_size = 2",
              "--binding", "train_eval_model.max_train_steps = 2",
              "--binding", "train_eval_model.save_checkpoints_steps = 1",
              "--model_dir", str(run), "--device", "cpu"]
      assert run_t2r_trainer.main(args) == 0
      assert sorted(os.listdir(run / "checkpoints")) == ["1", "2"]
      config.clear_config()

  def test_capability_check_in_miniature(self, monkeypatch, capsys):
    """check_maml at a miniature size on the CPU: the record carries the
    JAX check's keys and the K1 counts (0 here: the plain version)."""
    import json
    monkeypatch.setitem(run_capability_checks._SCALES["maml"], "fast",
                        dict(steps=4, image=16))
    monkeypatch.setattr(run_capability_checks, "MAML_ITERATIONS_PER_LOOP",
                        2)
    monkeypatch.setitem(run_capability_checks._EXPECT, ("maml", "fast"),
                        0.0)
    assert run_capability_checks.main(["--checks", "maml", "--device",
                                       "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["check"] == "maml" and record["passed"] is True
    for key in ("success_rate_at_object_radius", "unadapted_success_rate",
                "adapted_vs_unadapted_margin_ok", "k1_launches_train",
                "k1_launches_eval_adapted", "k1_launches_eval_unadapted"):
      assert key in record
    assert record["k1_launches_train"] == 0


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


def _stack(structs, device):
  return ts.TensorSpecStruct(
      (k, torch.stack([torch.as_tensor(np.asarray(s[k])) for s in structs])
       .to(device)) for k in structs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [{}, {"first_order": True},
                                     {"learn_inner_lr": True}, "dropout"],
                         ids=["second_order", "first_order",
                              "learned_rates", "mock_dropout"])
def test_cuda_maml_graph_equals_eager(cuda_device, variant):
  """Two warm meta-steps, then 3 as one CUDA graph, against 5 eager
  steps: the states agree bit for bit (cuDNN deterministic), the mock's
  dropout included (its masks come from the generators registered with
  the graph), and the pose_env model launches K1 32 times a meta-step
  through the replay (8 tasks x (3 inner steps + the query))."""
  ss = importlib.import_module(
      "tensor2robot_tpu_torch.ops.spatial_softmax").spatial_softmax
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    if variant == "dropout":
      def build():
        return MAMLModel(mocks.MockT2RModel(use_batch_norm=True),
                         num_inner_steps=2,
                         optimizer_fn=create_adam_optimizer(1e-3))
      metas = [_mock_meta(4, seed=s) for s in range(5)]
      per_step = 0
    else:
      def build():
        return pose_env_maml_models.pose_env_maml_model(
            num_inner_steps=3, inner_lr=0.05, image_size=64,
            optimizer_fn=create_adam_optimizer(1e-3), **variant)
      metas = [mr.sample_meta_batch(8, 4, 4, seed=s)[0] for s in range(5)]
      per_step = 8 * 4
    states = []
    for graphed in (True, False):
      trainer = Trainer(build(), device=cuda_device)
      state = trainer.create_train_state()
      if graphed:
        state, _ = trainer.train_steps(state, _stack(metas[:2], cuda_device))
        before = ss.launches
        state, metrics = trainer.train_steps(state,
                                             _stack(metas[2:], cuda_device))
        torch.cuda.synchronize()
        assert ss.launches - before == 3 * per_step
      else:
        for meta in metas:
          one = _stack([meta], cuda_device)
          state, metrics = trainer.train_step(
              state, ts.TensorSpecStruct((k, v[0]) for k, v in one.items()))
      states.append((state, float(metrics["loss"])))
    (a, loss_a), (b, loss_b) = states
    assert loss_a == loss_b
    for key, value in b.params.items():
      torch.testing.assert_close(a.params[key], value, rtol=0, atol=0)
  finally:
    torch.backends.cudnn.deterministic = deterministic
