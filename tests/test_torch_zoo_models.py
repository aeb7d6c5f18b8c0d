"""The port's zoo models held against the JAX package.

On the CPU at small sizes, with the same weights (fresh port variables
carried to flax by the bridge) and the same numpy inputs: Grasp2Vec,
VRGripper regression and MDN, TEC and meta-BC (``vrgripper_maml_model``).
TRAIN computes in float64 on both sides (``jax.enable_x64``; the
parameters stay float32), for the reason ``test_torch_zoo.py`` gives: the
loss, every metric and the batch statistics within OUT_RTOL of their
scale, every gradient within GRAD_RTOL of its tensor's largest, and
Adam's first update through the port's Trainer against optax.adam's on
the JAX gradients. PREDICT computes in float32: every output within
OUT_RTOL of its scale; Grasp2Vec's EVAL map, heatmap and image summaries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none
  import jax
  import jax.numpy as jnp
  import optax
  from tensor2robot_tpu.research.grasp2vec import (
      grasp2vec_model as jax_g2v,
      visualization as jax_vis,
  )
  from tensor2robot_tpu.research.vrgripper import (
      vrgripper_env_models as jax_vr,
      vrgripper_env_tec_models as jax_tec,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge, modes  # noqa: E402
from tensor2robot_tpu_torch.research.grasp2vec import (  # noqa: E402
    grasp2vec_model,
    visualization,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    vrgripper_env_models,
    vrgripper_env_tec_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils.optimizers import (  # noqa: E402
    create_adam_optimizer,
)

IMAGE = 32
OUT_RTOL = 1e-5  # outputs, losses, metrics, statistics: of their scale
GRAD_RTOL = 1e-4  # gradients: of each tensor's largest
# A tensor whose largest gradient sits below NOISE_SHARE of the tree's
# largest holds rounding noise only (a conv bias that BatchNorm removes):
# both sides must then stay below it.
NOISE_SHARE = 1e-6
# Adam's first update, lr * g / (|g| + eps), compared where the gradient
# is at least ADAM_MASK_SHARE of its tensor's largest (so known to 1e-3 of
# itself); elsewhere a step of at most the rate.
ADAM_ATOL = 1e-6
ADAM_MASK_SHARE = 0.1
MODEL_KINDS = ["grasp2vec", "regression", "mdn", "tec", "meta_bc"]


def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _torch_struct(struct):
  return ts.TensorSpecStruct(
      (k, torch.from_numpy(np.asarray(v))) for k, v in struct.items())


def _jax_struct(struct):
  return jax_ts.TensorSpecStruct(
      (k, jnp.asarray(np.asarray(v))) for k, v in struct.items())


def _close(got, want, what=""):
  if torch.is_tensor(got):
    got = got.detach()
    got = got.float() if got.dtype == torch.bfloat16 else got
  got, want = np.asarray(got), np.asarray(want)
  scale = max(float(np.abs(want).max()), 1e-12)
  np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * scale,
                             err_msg=what)


def _models(kind, float64=False):
  """(jax model, port model) at a small size, computing in float32 or
  float64."""
  dtype = ((dict(compute_dtype=jnp.float64),
            dict(compute_dtype=torch.float64)) if float64 else
           (dict(compute_dtype=jnp.float32),
            dict(compute_dtype=torch.float32)))
  if kind == "grasp2vec":
    kw = dict(image_size=IMAGE, depth=18, width=4, embedding_size=16)
    return (jax_g2v.Grasp2VecModel(**kw, **dtype[0]),
            grasp2vec_model.Grasp2VecModel(**kw, **dtype[1]))
  if kind in ("regression", "mdn"):
    name = ("VRGripperRegressionModel" if kind == "regression"
            else "VRGripperEnvModel")
    kw = dict(image_size=IMAGE)
    if kind == "mdn":
      kw["num_mixture_components"] = 3
    return (getattr(jax_vr, name)(**kw, **dtype[0]),
            getattr(vrgripper_env_models, name)(**kw, **dtype[1]))
  if kind == "tec":
    kw = dict(image_size=IMAGE, embedding_size=8)
    return (jax_tec.VRGripperEnvTecModel(**kw, **dtype[0]),
            vrgripper_env_tec_models.VRGripperEnvTecModel(**kw, **dtype[1]))
  kw = dict(image_size=16, num_condition_samples=2, num_inference_samples=2,
            inner_lr=0.05)
  return (jax_vr.vrgripper_maml_model(**kw, **dtype[0]),
          vrgripper_env_models.vrgripper_maml_model(**kw, **dtype[1]))


def _variables(model, seed):
  """Fresh port variables (flax's initializers, a torch generator) as the
  flax tree of numpy arrays, the running averages moved off their init."""
  state = model.init_variables(torch.Generator().manual_seed(seed),
                               device="cpu")
  tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                bridge.state_dict_to_variables(state))
  if "batch_stats" in tree:
    rng = np.random.default_rng(seed)
    tree["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        tree["batch_stats"])
  return tree


def _state_dict(variables, model, grad=False):
  state = bridge.variables_to_state_dict(variables, model.module)
  names = {n for n, _ in model.module.named_parameters()}
  return {k: (v.clone().requires_grad_() if grad and k in names
              else v.clone()) for k, v in state.items()}


def _batch(model, mode, batch, seed):
  """Spec-conformant numpy features and labels (images in [0, 1])."""
  rng = np.random.default_rng(seed)

  def draw(spec_struct):
    return {key: (rng.random((batch,) + spec.shape, np.float32)
                  if "image" in key else
                  rng.normal(size=(batch,) + spec.shape).astype(np.float32))
            for key, spec in ts.flatten_spec_structure(spec_struct).items()}

  return (draw(model.get_feature_specification(mode)),
          draw(model.get_label_specification(mode)) or None)


def _check_grads(got: dict, want: dict):
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


class TestModels:

  @pytest.mark.parametrize("kind", MODEL_KINDS)
  def test_train_step_matches_jax(self, kind):
    """TRAIN in float64: the loss, every metric, the gradients and the new
    batch statistics; then Adam's first update, compared as updates
    (ROADMAP Facts)."""
    _needs_jax()
    jax_model, model = _models(kind, float64=True)
    variables = _variables(model, seed=1)
    features, labels = _batch(model, modes.TRAIN, 4, seed=2)
    with jax.enable_x64(True):
      jf = _jax_struct(features)
      jl = _jax_struct(labels) if labels else None

      def loss_fn(params):
        loss, (metrics, state) = jax_model.model_train_fn(
            {**variables, "params": params}, jf, jl)
        return loss, (metrics, state)

      (loss, (metrics, new_state)), grads = jax.device_get(jax.jit(
          jax.value_and_grad(loss_fn, has_aux=True))(variables["params"]))
    port_vars = _state_dict(variables, model, grad=True)
    got_loss, (got_metrics, got_state) = model.model_train_fn(
        port_vars, _torch_struct(features),
        _torch_struct(labels) if labels else None)
    got_loss.backward()
    _close(got_loss, loss, what="loss")
    assert set(got_metrics) == set(metrics)
    for key, value in metrics.items():
      _close(got_metrics[key], value, what=key)
    want_grads = bridge.params_to_state_dict(grads, model.module)
    _check_grads({k: v.grad for k, v in port_vars.items()
                  if v.requires_grad}, want_grads)
    assert bool(got_state) == bool(new_state)
    if got_state:
      want_state = bridge.variables_to_state_dict(
          {**variables, **new_state}, model.module)
      for key, value in got_state.items():
        _close(value, want_state[key].numpy(), what=key)
    lr = 1e-3
    optimizer = optax.adam(lr)
    updates, _ = optimizer.update(grads, optimizer.init(variables["params"]),
                                  variables["params"])
    want_delta = bridge.params_to_state_dict(jax.device_get(updates),
                                             model.module)
    model._optimizer_fn = create_adam_optimizer(lr)
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(variables)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = trainer.train_step(state, _torch_struct(features),
                                  _torch_struct(labels) if labels else None)
    for name, value in state.params.items():
      delta = (value.detach() - start[name]).numpy()
      grad = np.abs(want_grads[name].numpy())
      known = grad > max(1e-6, ADAM_MASK_SHARE * float(grad.max()))
      np.testing.assert_allclose(delta[known], want_delta[name].numpy()[known],
                                 rtol=0, atol=ADAM_ATOL, err_msg=name)
      assert np.all(np.abs(delta) <= 1.011 * lr), name

  @pytest.mark.parametrize("kind", MODEL_KINDS)
  def test_predict_matches_jax(self, kind):
    _needs_jax()
    jax_model, model = _models(kind)
    variables = _variables(model, seed=4)
    features, _ = _batch(model, modes.PREDICT, 3, seed=5)
    want = jax.device_get(jax.jit(jax_model.predict_fn)(
        variables, _jax_struct(features)))
    got = model.predict_fn(_state_dict(variables, model),
                           _torch_struct(features))
    assert set(got) == set(want)
    for key, value in want.items():
      assert tuple(got[key].shape) == tuple(value.shape), key
      _close(got[key], value, what=key)

  def test_grasp2vec_eval_heatmap_and_summaries(self):
    _needs_jax()
    jax_model, model = _models("grasp2vec")
    variables = _variables(model, seed=2)
    features, _ = _batch(model, modes.EVAL, 2, seed=3)
    want, _ = jax.device_get(jax.jit(
        lambda v, f: jax_model.inference_network_fn(v, f, modes.EVAL))(
            variables, _jax_struct(features)))
    port_vars = _state_dict(variables, model)
    got, _ = model.inference_network_fn(port_vars, _torch_struct(features),
                                        modes.EVAL)
    assert tuple(got["scene_spatial"].shape) == want["scene_spatial"].shape
    _close(got["scene_spatial"], want["scene_spatial"], what="spatial")
    _close(visualization.embedding_heatmap(got["scene_spatial"],
                                           got["outcome_embedding"]),
           jax_vis.embedding_heatmap(want["scene_spatial"],
                                     want["outcome_embedding"]),
           what="heatmap")
    images = model.model_image_summaries_fn(port_vars, features)
    assert set(images) == {"grasp2vec_heatmap", "grasp2vec_pre_image"}
    assert images["grasp2vec_heatmap"].dtype == np.uint8
    np.testing.assert_array_equal(images["grasp2vec_pre_image"],
                                  features["pre_image"][0])
    heat = np.random.default_rng(0).random((4, 5)).astype(np.float32)
    np.testing.assert_array_equal(visualization.heatmap_to_image(heat),
                                  jax_vis.heatmap_to_image(heat))

  def test_tec_predict_has_no_query_embedding(self):
    model = vrgripper_env_tec_models.VRGripperEnvTecModel(
        image_size=16, embedding_size=8, compute_dtype=torch.float32)
    variables = model.init_variables(torch.Generator().manual_seed(0),
                                     device="cpu")
    assert "inference/labels/action" not in model.get_feature_specification(
        modes.PREDICT)
    features, _ = _batch(model, modes.PREDICT, 2, seed=0)
    out = model.predict_fn(variables, _torch_struct(features))
    assert set(out) == {"inference_output", "task_embedding"}
    assert tuple(out["inference_output"].shape) == (2, 2, 7)
    np.testing.assert_allclose(
        torch.linalg.norm(out["task_embedding"], dim=-1).numpy(), 1.0,
        atol=1e-5)
