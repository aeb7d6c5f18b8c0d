"""The port's program format and the ``t2r_assets.pb`` twin.

On the CPU: the port's ``t2r_assets.pb`` parses with the JAX package's
``t2r_pb2`` to the message JAX's ``make_t2r_assets`` builds, and its bytes
are protobuf's deterministic serialization; JAX's pb reads back through
the port; an export without its JSON asset reads its specs from the pb.
A ``serving_fn.pt2`` exported and loaded on the CPU equals the eager model
at batch 1 and 7 through one program (pose_env with K1 held as the custom
op, the VRGripper MDN model's argmax mode, TEC's batch reshapes), serves
with no model object, swaps variables without a new export, and leaves a
``variables.npz`` the JAX package serves. The tests marked ``cuda`` serve
a program on the card: K1's custom op launches the kernel, counted, and
agrees with the plain version.
"""

import importlib
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none, and runs the cuda tests only
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.export import export_utils as jax_export_utils
  from tensor2robot_tpu.export import variables_io as jax_variables_io
  from tensor2robot_tpu.proto import proto_utils as jax_proto_utils
  from tensor2robot_tpu.proto import t2r_pb2
  from tensor2robot_tpu.research.pose_env import (
      pose_env_models as jax_pose_env_models,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
except ImportError:
  jax = None

from tensor2robot_tpu_torch import modes  # noqa: E402
from tensor2robot_tpu_torch.export import export_utils  # noqa: E402
from tensor2robot_tpu_torch.export import (  # noqa: E402
    native_export_generator as native,
)
from tensor2robot_tpu_torch.ops import dispatch  # noqa: E402
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.proto import proto_utils  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    PoseEnvRegressionModel,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (  # noqa: E402
    pose_env_maml_model,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    vrgripper_env_models,
    vrgripper_env_tec_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402

ss = importlib.import_module("tensor2robot_tpu_torch.ops.spatial_softmax")
# A program runs the eager model's kernels in the same order: float32
# outputs within 1e-6 of their scale (measured: equal, or 1e-9 apart).
PROGRAM_RTOL = 1e-6
BATCHES = (1, 7)


def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _specs(module):
  return module.TensorSpecStruct({
      "image": module.ExtendedTensorSpec((64, 64, 3), np.uint8, name="image",
                                         data_format="jpeg"),
      "pose": module.ExtendedTensorSpec((14,), np.float32, is_optional=True,
                                        dataset_key="b"),
      "seq": module.ExtendedTensorSpec((5, 2), np.int64, is_sequence=True,
                                       varlen_default_value=0.0),
      "pad": module.ExtendedTensorSpec((3,), np.float32,
                                       varlen_default_value=-1.5),
  })


_EXTRA = {"format": "x", "feature_keys": ["image", "pose"], "a": {"b": [1]}}


class TestAssetsProto:

  def test_port_bytes_are_the_jax_message(self):
    _needs_jax()
    want = jax_proto_utils.make_t2r_assets(
        _specs(jax_ts), _specs(jax_ts), extra=_EXTRA, global_step=2 ** 40)
    got = proto_utils.make_t2r_assets(_specs(ts), _specs(ts), extra=_EXTRA,
                                      global_step=2 ** 40).serialize()
    assert got == want.SerializeToString(deterministic=True)
    assert t2r_pb2.T2RAssets.FromString(got) == want

  def test_jax_bytes_read_back_through_the_port(self):
    _needs_jax()
    data = jax_proto_utils.make_t2r_assets(
        _specs(jax_ts), None, extra=_EXTRA, global_step=3).SerializeToString()
    features, labels, extra = proto_utils.parse_t2r_assets(
        proto_utils.T2RAssets.parse(data))
    assert features == _specs(ts) and labels is None and extra == _EXTRA
    assert proto_utils.T2RAssets.parse(data).global_step == 3

  def test_unset_and_zero_varlen_defaults_differ(self):
    unset = proto_utils.spec_to_proto(ts.ExtendedTensorSpec((2,), np.float32))
    zero = proto_utils.spec_to_proto(
        ts.ExtendedTensorSpec((2,), np.float32, varlen_default_value=0.0))
    assert unset.serialize() != zero.serialize()
    assert proto_utils.ExtendedTensorSpecProto.parse(
        unset.serialize()).varlen_default_value is None
    assert proto_utils.ExtendedTensorSpecProto.parse(
        zero.serialize()).varlen_default_value == 0.0

  def test_jsonless_export_reads_its_specs_from_the_pb(self, tmp_path):
    export_utils.write_spec_assets(str(tmp_path), _specs(ts),
                                   label_spec=_specs(ts), extra=_EXTRA,
                                   global_step=9)
    from_json = export_utils.read_spec_assets(str(tmp_path))
    os.remove(tmp_path / export_utils.SPEC_ASSET_NAME)
    features, labels, extra = export_utils.read_spec_assets(str(tmp_path))
    # The proto keeps the specs' order; the JSON asset sorts its keys.
    assert features == _specs(ts) and labels == _specs(ts)
    assert dict(features) == dict(from_json[0]) and extra == from_json[2]

  def test_jax_reads_the_port_pb(self, tmp_path):
    _needs_jax()
    export_utils.write_spec_assets(str(tmp_path), _specs(ts), extra=_EXTRA)
    os.remove(tmp_path / export_utils.SPEC_ASSET_NAME)
    features, labels, extra = jax_export_utils.read_spec_assets(
        str(tmp_path))
    assert features == _specs(jax_ts) and labels is None
    assert extra == _EXTRA


# --- programs ---------------------------------------------------------------


def _export(model, root, variables):
  generator = native.NativeExportGenerator(export_root=str(root))
  generator.set_specification_from_model(model)
  return generator, generator.export(variables, global_step=5)


def _features(model, batch, seed):
  rng = np.random.default_rng(seed)
  spec = ts.flatten_spec_structure(
      model.preprocessor.get_out_feature_specification(modes.PREDICT))
  return {key: (rng.random((batch,) + s.shape, np.float32)
                if "image" in key else
                rng.normal(size=(batch,) + s.shape).astype(np.float32))
          for key, s in spec.items()}


def _eager(model, variables, features):
  out = model.predict_fn(variables, ts.TensorSpecStruct(
      (k, torch.from_numpy(v)) for k, v in features.items()))
  return {k: v.float().numpy() for k, v in out.items()}


def _close(got, want):
  assert set(got) == set(want)
  for key, value in want.items():
    assert got[key].shape == value.shape, key
    scale = max(float(np.abs(value).max()), 1e-12)
    np.testing.assert_allclose(got[key], value, rtol=0,
                               atol=PROGRAM_RTOL * scale, err_msg=key)


MODELS = {
    "pose_env": lambda: PoseEnvRegressionModel(compute_dtype=torch.float32),
    "vrgripper_mdn": lambda: vrgripper_env_models.VRGripperEnvModel(
        image_size=32, num_mixture_components=3,
        compute_dtype=torch.float32),
    "vrgripper_tec": lambda: vrgripper_env_tec_models.VRGripperEnvTecModel(
        image_size=16, embedding_size=8, compute_dtype=torch.float32),
}


class TestProgram:

  @pytest.mark.parametrize("name", sorted(MODELS))
  def test_program_equals_eager_at_each_batch(self, name, tmp_path):
    model = MODELS[name]()
    variables = model.init_variables(torch.Generator().manual_seed(0),
                                     device="cpu")
    _, export_dir = _export(model, tmp_path, variables)
    assert sorted(os.listdir(export_dir)) == [
        native.SERVING_FN_NAME, "t2r_assets.json", "t2r_assets.pb",
        "variables.npz"]
    _, _, extra = export_utils.read_spec_assets(export_dir)
    assert extra["format"] == native.PROGRAM_FORMAT
    assert [k for k, _, _ in extra["variables"]] == list(variables)
    predictor = ExportedModelPredictor(export_root=str(tmp_path),
                                       device="cpu")
    assert predictor.restore() and predictor.model_version > 0
    for batch in BATCHES:
      features = _features(model, batch, seed=batch)
      _close(predictor.predict(features), _eager(model, variables, features))

  def test_pose_env_program_holds_k1_as_the_custom_op(self, tmp_path):
    model = MODELS["pose_env"]()
    variables = model.init_variables(torch.Generator().manual_seed(1),
                                     device="cpu")
    program = native.export_program(
        model, ts.flatten_spec_structure(
            model.get_feature_specification(modes.PREDICT)), variables)
    targets = [str(node.target) for node in program.graph.nodes
               if node.op == "call_function"]
    assert targets.count("t2r.spatial_softmax.default") == 1
    x = torch.randn(3, 5, 6, 4)
    assert torch.equal(torch.ops.t2r.spatial_softmax(x, 0.5),
                       ss.spatial_softmax_reference(x, 0.5))

  def test_hot_swap_needs_no_export(self, tmp_path):
    model = MODELS["vrgripper_mdn"]()
    first, second = (model.init_variables(torch.Generator().manual_seed(s),
                                          device="cpu") for s in (0, 1))
    _export(model, tmp_path, first)
    predictor = ExportedModelPredictor(export_root=str(tmp_path),
                                       device="cpu")
    predictor.restore()
    version = predictor.model_version
    predictor.set_variables(second)
    features = _features(model, 4, seed=3)
    _close(predictor.predict(features), _eager(model, second, features))
    assert predictor.model_version == version + 1
    assert len(export_utils.list_export_versions(str(tmp_path))) == 1
    with pytest.raises(ValueError, match="keys differ"):
      predictor.set_variables({k: v for k, v in list(second.items())[1:]})

  def test_device_fn_and_examples_serve_the_program(self, tmp_path):
    from tensor2robot_tpu_torch.data import example_proto
    model = MODELS["vrgripper_mdn"]()
    variables = model.init_variables(torch.Generator().manual_seed(2),
                                     device="cpu")
    _export(model, tmp_path, variables)
    predictor = ExportedModelPredictor(export_root=str(tmp_path),
                                       device="cpu")
    predictor.restore()
    features = _features(model, 2, seed=4)
    fn, served = predictor.device_fn()
    out = fn(served, {k: torch.from_numpy(v) for k, v in features.items()})
    _close({k: v.numpy() for k, v in out.items()},
           _eager(model, variables, features))
    # The program's spec is the model-ready one: float images as values.
    records = [example_proto.encode_example(
        {key: value[i].reshape(-1).tolist() for key, value in
         features.items()}) for i in range(2)]
    _close(predictor.predict_examples(records),
           _eager(model, variables, features))
    with pytest.raises(NotImplementedError, match="model"):
      predictor.init_randomly()

  def test_jax_serves_the_variables(self, tmp_path):
    """The version's variables.npz in the JAX package: its pose_env model
    serves it as the port's program does."""
    _needs_jax()
    model = MODELS["pose_env"]()
    variables = model.init_variables(torch.Generator().manual_seed(3),
                                     device="cpu")
    _, export_dir = _export(model, tmp_path, variables)
    tree = jax_variables_io.load_variables(
        os.path.join(export_dir, "variables.npz"))
    features = _features(model, 3, seed=5)
    jax_model = jax_pose_env_models.PoseEnvRegressionModel(
        compute_dtype=jnp.float32)
    want = jax_model.predict_fn(tree, jax_ts.TensorSpecStruct(
        (k, jnp.asarray(v)) for k, v in features.items()))
    predictor = ExportedModelPredictor(export_root=str(tmp_path),
                                       device="cpu")
    predictor.restore()
    got = predictor.predict(features)
    np.testing.assert_allclose(got["inference_output"],
                               np.asarray(want["inference_output"]),
                               rtol=0, atol=1e-5)

  def test_maml_exports_no_program_and_the_model_serves_it(self, tmp_path):
    model = pose_env_maml_model(image_size=16, num_condition_samples=2,
                                num_inference_samples=2)
    variables = model.init_variables(torch.Generator().manual_seed(0),
                                     device="cpu")
    _, export_dir = _export(model, tmp_path, variables)
    assert native.SERVING_FN_NAME not in os.listdir(export_dir)
    assert export_utils.read_spec_assets(export_dir)[2]["format"] == (
        native.EXPORT_FORMAT)
    with pytest.raises(ValueError, match="no serving program"):
      ExportedModelPredictor(export_root=str(tmp_path),
                             device="cpu").restore()
    predictor = ExportedModelPredictor(model, str(tmp_path), device="cpu")
    assert predictor.restore()

  def test_custom_op_route_is_thread_local(self):
    seen = []
    with dispatch.custom_ops():
      worker = threading.Thread(
          target=lambda: seen.append(dispatch.use_custom_ops()))
      worker.start()
      worker.join()
      assert dispatch.use_custom_ops()
    assert seen == [False] and not dispatch.use_custom_ops()


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_program_launches_k1(cuda_device, dtype, tmp_path):
  """pose_env's program on the card: K1's custom op launches the channel
  kernel once a request (counted), and the served outputs sit where the
  eager model's do (bf16 within 5e-3, float32 with TF32 off within
  1e-4, as chip_smoke's serving checks)."""
  model = PoseEnvRegressionModel(compute_dtype=dtype)
  variables = model.init_variables(torch.Generator().manual_seed(0),
                                   device="cpu")
  _export(model, tmp_path, variables)
  predictor = ExportedModelPredictor(export_root=str(tmp_path))
  assert predictor.restore() and predictor.device.type == "cuda"
  tf32 = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    for batch in BATCHES:
      features = _features(model, batch, seed=batch)
      before = ss.spatial_softmax.launches
      got = predictor.predict(features)["inference_output"]
      assert ss.spatial_softmax.launches - before == 1
      eager = model.predict_fn(
          {k: v.to(cuda_device) for k, v in variables.items()},
          {"image": torch.from_numpy(features["image"]).to(cuda_device)})
      want = eager["inference_output"].float().cpu().numpy()
      atol = 5e-3 if dtype == torch.bfloat16 else 1e-4
      np.testing.assert_allclose(got, want, rtol=0, atol=atol)
  finally:
    torch.backends.cudnn.allow_tf32 = tf32
