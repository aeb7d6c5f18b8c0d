"""The port's parallel tier (meshes, specs, ring and Ulysses attention, the
SNAIL ring block) held against the JAX package.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
gives, its meshes over the first N; the port's side on N CPU gloo ranks
that ``parallel/launch.py`` spawns (``tests/torch_parallel_ranks.py``),
many cases to a spawn. Both take the same numpy inputs made from seeds.

Tolerances are the JAX tests' (``tests/test_parallel.py``): float32
attention outputs within 2e-5 and gradients within 2e-4, bfloat16 outputs
within 0.05; spec trees equal leaf for leaf.
"""

import concurrent.futures
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has no flax
  import jax
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as JaxP
  from tensor2robot_tpu import parallel as jax_parallel
  from tensor2robot_tpu.layers import snail as jax_snail
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.parallel import tp_rules as jax_tp_rules
  from tensor2robot_tpu.research.qtopt import t2r_models as jax_qtopt
  from tensor2robot_tpu.train import checkpoints as jax_checkpoints
  from tensor2robot_tpu.utils import mocks as jax_mocks
except ImportError:
  jax = None

import torch_parallel_ranks as ranks  # noqa: E402
from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch import parallel  # noqa: E402
from tensor2robot_tpu_torch.layers import snail  # noqa: E402
from tensor2robot_tpu_torch.parallel import (  # noqa: E402
    collectives,
    distributed,
    launch,
    mesh as mesh_lib,
    tp_rules,
)
from tensor2robot_tpu_torch.parallel.mesh import PartitionSpec as P  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import t2r_models  # noqa: E402
from tensor2robot_tpu_torch.train import checkpoints  # noqa: E402
from tensor2robot_tpu_torch.utils import mocks  # noqa: E402

F32_ATOL, GRAD_ATOL, BF16_ATOL = 2e-5, 2e-4, 0.05


@pytest.fixture(autouse=True)
def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _qkv(b=2, t=32, h=4, d=16, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((b, t, h, d)).astype(np.float32)
          for _ in range(3)]


def _jax_attention(op, qkv, axes, dtype, **kwargs):
  """JAX's output and sum(out ** 2) gradients on a mesh of its first
  devices."""
  mesh = jax_parallel.create_mesh(
      axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
  fn = {"ring": jax_parallel.ring_attention,
        "ulysses": jax_parallel.ulysses_attention}[op]
  q, k, v = (jnp.asarray(x, dtype) for x in qkv)

  @jax.jit
  def run(q, k, v):
    def loss(q, k, v):
      out = fn(q, k, v, mesh, **kwargs)
      return jnp.sum(out.astype(jnp.float32) ** 2), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return out, grads

  out, grads = run(q, k, v)
  return (np.asarray(out, np.float32),
          [np.asarray(g, np.float32) for g in grads])


def _snail_case(name, axes, b, batch_axis=None, seed=0):
  """The SNAIL block's variables from the JAX init, and its input."""
  x = np.random.default_rng(seed).standard_normal((b, 16, 8)).astype(
      np.float32)
  block = jax_snail.AttentionBlock(key_size=8, value_size=8,
                                   dtype=jnp.float32)
  variables = block.init(jax.random.key(0), jnp.asarray(x))
  module = snail.AttentionBlock(8, 8, 8, torch.float32)
  state_dict = {k: v.numpy() for k, v in bridge.variables_to_state_dict(
      jax.tree_util.tree_map(np.asarray, variables), module).items()}
  return {"name": name, "op": "snail", "axes": axes, "x": x,
          "key_size": 8, "state_dict": state_dict,
          "batch_axis": batch_axis, "variables": variables}


# name: (op, axes, dtype, causal, shape (b, t, h, d), extra kwargs)
_CASES_2 = {
    "ring_f32": ("ring", {"seq": 2}, "float32", False, (2, 32, 4, 16), {}),
    "ring_f32_causal": ("ring", {"seq": 2}, "float32", True, (2, 32, 4, 16),
                        {}),
    "ring_bf16_causal": ("ring", {"seq": 2}, "bfloat16", True,
                         (2, 32, 4, 16), {}),
    "ulysses_f32": ("ulysses", {"seq": 2}, "float32", False, (2, 32, 4, 16),
                    {}),
    "ulysses_f32_causal": ("ulysses", {"seq": 2}, "float32", True,
                           (2, 32, 4, 16), {}),
    "ulysses_flash_causal": ("ulysses", {"seq": 2}, "float32", True,
                             (2, 64, 2, 32), {"impl": "pallas"}),
    "ulysses_bf16_causal": ("ulysses", {"seq": 2}, "bfloat16", True,
                            (2, 32, 4, 16), {}),
}
_CASES_4 = {
    "ring_dp_sp": ("ring", {"data": 2, "seq": 2}, "float32", False,
                   (2, 16, 4, 16), {"batch_axis": "data"}),
    "ring_seq4_causal": ("ring", {"seq": 4}, "float32", True,
                         (2, 32, 4, 16), {}),
    "ulysses_dp_sp_bf16": ("ulysses", {"data": 2, "seq": 2}, "bfloat16",
                           True, (2, 16, 4, 16), {"batch_axis": "data"}),
    "ulysses_seq4_causal": ("ulysses", {"seq": 4}, "float32", True,
                            (2, 32, 4, 16), {}),
    "ulysses_indivisible_heads": ("ulysses", {"seq": 4}, "float32", True,
                                  (2, 32, 2, 16), {}),
    "ulysses_unknown_impl": ("ulysses", {"seq": 2, "data": 2}, "float32",
                             True, (2, 32, 4, 16), {"impl": "triton"}),
}


def _port_cases(cases):
  out = []
  for i, (name, (op, axes, dtype, causal, shape, extra)) in enumerate(
      cases.items()):
    out.append({"name": name, "op": op, "axes": axes, "dtype": dtype,
                "causal": causal, "qkv": _qkv(*shape, seed=i), **extra})
  return out


@pytest.fixture(scope="module")
def spawned():
  """Two spawns at once: every case on 2 ranks, and on 4."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  snail2 = _snail_case("snail_ring", {"seq": 2}, 2)
  snail4 = _snail_case("snail_ring_dp_sp", {"data": 2, "seq": 2}, 4,
                       batch_axis="data", seed=1)
  port2 = _port_cases(_CASES_2) + [
      {k: v for k, v in snail2.items() if k != "variables"}]
  port4 = _port_cases(_CASES_4) + [
      {k: v for k, v in snail4.items() if k != "variables"}]
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    two = pool.submit(launch.launch, ranks.attention_cases, 2, (port2,),
                      timeout_s=300)
    four = pool.submit(launch.launch, ranks.attention_cases, 4, (port4,),
                       timeout_s=300)
    two, four = two.result(), four.result()
  return {"two": two, "four": four, "snail": {"snail_ring": snail2,
                                              "snail_ring_dp_sp": snail4}}


def _results(spawned, name):
  group = "two" if name in _CASES_2 or name == "snail_ring" else "four"
  return spawned[group]


@pytest.mark.parametrize("name", list(_CASES_2) + [
    n for n in _CASES_4 if n not in ("ulysses_indivisible_heads",
                                     "ulysses_unknown_impl")])
def test_attention_matches_jax(spawned, name):
  cases = {**_CASES_2, **_CASES_4}
  op, axes, dtype, causal, shape, extra = cases[name]
  index = list((_CASES_2 if name in _CASES_2 else _CASES_4)).index(name)
  kwargs = {"causal": causal}
  if "batch_axis" in extra:
    kwargs["batch_axis"] = extra["batch_axis"]
  if op == "ulysses" and extra.get("impl") == "pallas":
    # The port's "pallas" core is the flash kernels' plain version here;
    # JAX's dense core is the same function.
    kwargs["attn_impl"] = "xla"
  want, want_grads = _jax_attention(
      op, _qkv(*shape, seed=index), axes,
      jnp.bfloat16 if dtype == "bfloat16" else jnp.float32, **kwargs)
  results = _results(spawned, name)
  got = results[0][name]
  for other in results[1:]:  # every rank returns the same global output
    np.testing.assert_array_equal(other[name]["out"], got["out"])
  if dtype == "bfloat16":
    assert got["dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(got["out"], want, atol=BF16_ATOL)
    return
  np.testing.assert_allclose(got["out"], want, atol=F32_ATOL)
  for g, w in zip(got["grads"], want_grads):
    # The dense gradient, not the ranks' count times it.
    np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


def test_ring_agrees_with_flash_attention(spawned):
  """The in-device blockwise core and the ring are one accumulation at two
  levels (``tests/test_ops.py::test_agrees_with_ring_attention``)."""
  from tensor2robot_tpu_torch.ops.flash_attention import flash_attention
  q, k, v = (torch.from_numpy(x) for x in _qkv(
      *_CASES_2["ring_f32_causal"][4], seed=1))
  np.testing.assert_allclose(
      spawned["two"][0]["ring_f32_causal"]["out"],
      flash_attention(q, k, v, causal=True).numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("name, match", [
    ("ulysses_indivisible_heads", "divisible"),
    ("ulysses_unknown_impl", "attn_impl must be")])
def test_ulysses_refusals_as_jax(spawned, name, match):
  got = spawned["four"][0][name]["error"]
  assert got.startswith("ValueError") and match in got
  op, axes, dtype, causal, shape, extra = _CASES_4[name]
  with pytest.raises(ValueError, match=match):
    _jax_attention(op, _qkv(*shape), axes, jnp.float32, causal=causal,
                   attn_impl=extra.get("impl", "xla"))


@pytest.mark.parametrize("name", ["snail_ring", "snail_ring_dp_sp"])
def test_snail_ring_block_matches_jax(spawned, name):
  case = spawned["snail"][name]
  got = _results(spawned, name)[0][name]
  mesh = jax_parallel.create_mesh(
      case["axes"], devices=jax.devices()[:int(np.prod(
          list(case["axes"].values())))])
  ring = jax_snail.AttentionBlock(key_size=8, value_size=8,
                                  dtype=jnp.float32, seq_mesh=mesh,
                                  batch_axis=case["batch_axis"])
  x = jnp.asarray(case["x"])
  variables = case["variables"]

  @jax.jit
  def run(params):
    def loss(params):
      out = ring.apply({**variables, "params": params}, x)
      return jnp.sum(out ** 2), out
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return out, grads

  out, grads = run(variables["params"])
  np.testing.assert_allclose(got["out"], np.asarray(out), atol=F32_ATOL)
  want = bridge.variables_to_state_dict(
      {"params": jax.tree_util.tree_map(np.asarray, grads)},
      snail.AttentionBlock(8, 8, 8, torch.float32))
  for key, value in want.items():
    np.testing.assert_allclose(got["grads"][key], value.numpy(),
                               atol=GRAD_ATOL)


def test_snail_refuses_flash_with_seq_mesh_as_jax():
  with pytest.raises(ValueError, match="seq_mesh alone"):
    snail.AttentionBlock(8, 8, 8, use_flash=True, seq_mesh=object())


def test_shard_batch_on_ranks(spawned):
  """Batched leaves split over the data axis, scalar riders whole."""
  for rank, result in enumerate(spawned["two"]):
    got = result["shard_batch"]
    np.testing.assert_array_equal(
        got["x"], np.arange(32, dtype=np.float32).reshape(16, 2)[
            8 * rank:8 * (rank + 1)])
    assert got["aux"] == {"mask_weight": 0.5, "step": 7.0}
    assert got["is_primary"] == (rank == 0)


def test_gloo_cuda_routes_from_the_table(spawned):
  """The probe's answer on the card: gloo stages send/recv only."""
  assert spawned["two"][0]["collectives"] == {"all_reduce": "native",
                                              "send_recv": "staged"}
  assert collectives.ROUTES == {("gloo", "send_recv"): "staged"}


# --- specs -------------------------------------------------------------------


def _virtual(axes):
  return mesh_lib.create_mesh(axes, devices=range(int(np.prod(
      list(axes.values())))))


def _jax_mesh(axes):
  return jax_parallel.create_mesh(axes, devices=jax.devices()[:int(np.prod(
      list(axes.values())))])


def _assert_same_specs(port, want):
  flat_port = dict(tp_rules.tree_flatten_with_path(port))
  flat_want = {tuple(str(getattr(k, "key", k)) for k in path): spec
               for path, spec in jax.tree_util.tree_flatten_with_path(
                   want, is_leaf=lambda x: isinstance(x, JaxP))[0]}
  assert set(flat_port) == set(flat_want)
  for path, spec in flat_want.items():
    assert flat_port[path] == tuple(spec), path


def test_dense_tp_spec_inference_as_jax():
  params = {"dense": {"kernel": np.zeros((32, 128)),
                      "bias": np.zeros((128,))},
            "head": {"kernel": np.zeros((128, 3))},
            "norm": {"scale": np.zeros((128,))}}
  specs = tp_rules.infer_dense_tp_specs(params, _virtual({"data": 4,
                                                          "model": 2}))
  assert specs["dense"]["kernel"] == P(None, "model")
  assert specs["dense"]["bias"] == P()
  assert specs["head"]["kernel"] == P()
  assert specs["norm"]["scale"] == P()
  assert tp_rules.infer_dense_tp_specs(
      {"k": np.zeros((32, 128))}, _virtual({"data": 8}))["k"] == P()
  _assert_same_specs(specs, jax_tp_rules.infer_dense_tp_specs(
      params, _jax_mesh({"data": 4, "model": 2})))


def test_fsdp_spec_inference_as_jax():
  params = {"dense": {"kernel": np.zeros((32, 256)),
                      "bias": np.zeros((256,))},
            "tiny": {"kernel": np.zeros((4, 4))},
            "tall": {"kernel": np.zeros((1024, 6))}}
  specs = tp_rules.infer_fsdp_specs(params, _virtual({"data": 8}),
                                    min_size=1024)
  assert specs["dense"]["kernel"] == P(None, "data")
  assert specs["tall"]["kernel"] == P("data", None)
  assert specs["tiny"]["kernel"] == P() == specs["dense"]["bias"]
  _assert_same_specs(specs, jax_tp_rules.infer_fsdp_specs(
      params, _jax_mesh({"data": 8}), min_size=1024))


def _models(name):
  if name == "mock":
    return mocks.MockT2RModel(hidden_size=128), jax_mocks.MockT2RModel(
        hidden_size=128)
  return (t2r_models.QTOptGraspingModel(image_size=64),
          jax_qtopt.QTOptGraspingModel(image_size=64))


@pytest.mark.parametrize("model_name", ["mock", "critic"])
@pytest.mark.parametrize("kind, axes", [
    ("dense_tp", {"data": 4, "model": 2}),
    ("dense_tp", {"data": 8}),
    ("fsdp", {"data": 8}),
    ("fsdp", {"data": 2, "model": 4}),
])
def test_spec_trees_from_model_as_jax(model_name, kind, axes):
  port_model, jax_model = _models(model_name)
  if kind == "dense_tp":
    got = tp_rules.infer_dense_tp_specs_from_model(port_model,
                                                   _virtual(axes))
    want = jax_tp_rules.infer_dense_tp_specs_from_model(jax_model,
                                                        _jax_mesh(axes))
  else:
    got = tp_rules.infer_fsdp_specs_from_model(port_model, _virtual(axes),
                                               min_size=128)
    want = jax_tp_rules.infer_fsdp_specs_from_model(
        jax_model, _jax_mesh(axes), min_size=128)
  _assert_same_specs(got, want)


@pytest.mark.parametrize("axes", [{"data": 4, "model": 2},
                                  {"data": 1, "model": 8}, {"data": 8}])
def test_critic_partition_rules_as_jax(axes):
  port_model, jax_model = _models("critic")
  got = tp_rules.partition_specs_for_model(port_model, _virtual(axes))
  _assert_same_specs(got, jax_tp_rules.partition_specs_for_model(
      jax_model, _jax_mesh(axes)))
  if axes.get("model", 1) > 1:
    assert got["stem"]["kernel"] == P(None, None, None, "model")
    assert got["q_head"]["kernel"] == P()


def test_partition_rules_refusals_as_jax():
  port_model, jax_model = _models("critic")
  with pytest.raises(ValueError, match="does not divide"):
    tp_rules.partition_specs_for_model(port_model, _virtual({"model": 3}))
  with pytest.raises(ValueError, match="does not divide"):
    jax_tp_rules.partition_specs_for_model(jax_model,
                                           _jax_mesh({"model": 3}))
  with pytest.raises(ValueError, match="Partition rule not found"):
    tp_rules.match_partition_rules([("nothing", P())],
                                   {"a": {"kernel": np.zeros((2, 2))}})


@pytest.mark.parametrize("shape, base", [
    ((3, 3, 64, 64), ()), ((3, 3, 64, 64), (None, None, None, "model")),
    ((64,), ("model",)), ((4, 6), ()), ((1024, 6), ()), ((7,), ())])
def test_zero1_composition_as_jax(shape, base):
  got = tp_rules.compose_data_axis_spec(shape, P(*base), "data", 2)
  want = jax_tp_rules.compose_data_axis_spec(shape, JaxP(*base), "data", 2)
  assert got == tuple(want)
  assert tp_rules.largest_divisible_dim_spec(shape, "data", 2) == tuple(
      jax_tp_rules.largest_divisible_dim_spec(shape, "data", 2))


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "model": 2}])
def test_zero1_optimizer_layout_as_jax(axes):
  """ZeRO-1's optimizer specs (state_dict layout, mapped back to flax)
  equal the JAX trainer's Adam moment shardings, composed onto the
  critic's TP specs where the mesh has a model axis."""
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
  port_model, jax_model = _models("critic")
  mesh = _jax_mesh(axes)
  jax_specs = (jax_tp_rules.partition_specs_for_model(jax_model, mesh)
               if "model" in axes else None)
  state = JaxTrainer(jax_model, mesh=mesh, param_specs=jax_specs,
                     shard_optimizer_state=True).create_train_state()
  want = {}
  for path, leaf in jax.tree_util.tree_flatten_with_path(
      state.opt_state)[0]:
    name = jax_tp_rules.path_key(path)
    if "/mu/" in f"/{name}":
      want[name.split("mu/", 1)[1]] = tuple(leaf.sharding.spec)
  params = dict(port_model.module.named_parameters())
  specs = ({k: P() for k in params} if jax_specs is None else
           tp_rules.state_dict_specs(tp_rules.partition_specs_for_model(
               port_model, _virtual(axes)), params))
  got = tp_rules.zero1_specs(params, specs, "data", axes["data"])
  keys = ranks.bridge_keys(port_model.module)
  assert set(keys.values()) == set(want)
  for key, spec in got.items():
    assert tp_rules.flax_spec(key, params[key].dim(), spec) == want[
        keys[key]], key


def test_specs_map_onto_state_dict_layout():
  model, _ = _models("critic")
  params = dict(model.module.named_parameters())
  specs = tp_rules.state_dict_specs(tp_rules.partition_specs_for_model(
      model, _virtual({"model": 2})), params)
  assert specs["stem.weight"] == P("model", None, None, None)  # OIHW
  assert specs["fc1.weight"] == P("model", None)  # (out, in)
  assert specs["stem_bn.weight"] == P("model")
  assert specs["q_head.weight"] == P()
  for key, spec in specs.items():
    assert tp_rules.torch_spec(key, params[key].dim(), tp_rules.flax_spec(
        key, params[key].dim(), spec)) == spec


def test_partition_spec_equality_as_jax():
  assert P(None, None) == P() == () and P("data") == ("data",)
  assert P(None, "model") != P("model")
  assert tuple(JaxP(None, "model")) == tuple(P(None, "model"))
  assert P(None, "model").at(5) is None and P("x").axes() == ("x",)
  with pytest.raises(NotImplementedError, match="one mesh axis"):
    P(("data", "model"))


# --- meshes and helpers ------------------------------------------------------


@pytest.mark.parametrize("axes, n, match", [
    ({"data": -1, "model": -1}, 8, "At most one axis may be -1"),
    ({"data": 3}, 8, "not divisible by fixed axes"),
    ({"data": 2, "model": 2}, 8, "require 4 devices"),
])
def test_create_mesh_refusals_as_jax(axes, n, match):
  with pytest.raises(ValueError, match=match):
    mesh_lib.create_mesh(axes, devices=range(n))
  with pytest.raises(ValueError, match=match):
    jax_mesh.create_mesh(axes, devices=jax.devices()[:n])


def test_create_mesh_layout_as_jax():
  got = mesh_lib.create_mesh({"data": 2, "model": -1}, devices=range(8))
  want = jax_mesh.create_mesh({"data": 2, "model": -1})
  assert dict(got.shape) == dict(want.shape)
  assert got.is_virtual and got.size == 8
  assert mesh_lib.mesh_devices(got) == list(range(8))
  assert mesh_lib.nearest_multiples(10, 4) == jax_mesh.nearest_multiples(
      10, 4)
  single = mesh_lib.create_mesh()
  assert dict(single.shape) == {"data": 1} and single.coords() == {"data": 0}


def test_named_shardings_as_jax():
  mesh = _virtual({"data": 8})
  for rule in ("batch_sharding", "env_sharding", "ring_sharding",
               "stacked_batch_sharding", "replicated_sharding"):
    got = getattr(mesh_lib, rule)(mesh).spec
    assert got == tuple(getattr(jax_mesh, rule)(_jax_mesh({"data": 8})).spec)


def test_shard_batch_refusals_as_jax():
  mesh = _virtual({"data": 8})
  with pytest.raises(ValueError, match="not divisible"):
    mesh_lib.shard_batch(mesh, {"x": np.ones((3, 2), np.float32)})
  with pytest.raises(ValueError, match="not divisible"):
    mesh_lib.shard_batch(mesh, {"a": np.ones((16, 2), np.float32),
                                "b": np.ones((3,), np.float32)})
  with pytest.raises(ValueError, match="not divisible"):
    jax_mesh.shard_batch(_jax_mesh({"data": 8}),
                         {"x": np.ones((3, 2), np.float32)})
  one = mesh_lib.create_mesh({"data": 1}, devices=[0])
  np.testing.assert_array_equal(
      mesh_lib.shard_batch(one, {"x": np.ones((3, 2))})["x"], np.ones((3, 2)))


def test_local_batch_slice_as_jax(monkeypatch):
  assert mesh_lib.local_batch_slice(32) == 32 == jax_mesh.local_batch_slice(
      32)
  monkeypatch.setattr(distributed, "process_count", lambda: 4)
  assert mesh_lib.local_batch_slice(12) == 3
  with pytest.raises(ValueError, match="not divisible by process"):
    mesh_lib.local_batch_slice(10)


def test_distributed_single_process():
  distributed.initialize()  # no environment: a single-process no-op
  assert not distributed.is_initialized()
  assert distributed.is_primary() and distributed.process_count() == 1
  distributed.sync_global_devices("nothing to wait for")
  mesh = distributed.create_hybrid_mesh({"model": 1}, {"data": -1})
  assert dict(mesh.shape) == {"data": 1, "model": 1}
  with pytest.raises(ValueError, match="repeat"):
    distributed.create_hybrid_mesh({"data": 1}, {"data": 1})
  with pytest.raises(ValueError, match="only allowed on dcn"):
    distributed.create_hybrid_mesh({"model": -1}, {"data": 1})
  placed = distributed.global_put({"x": np.arange(4.0)},
                                  mesh_lib.batch_sharding(mesh))
  np.testing.assert_array_equal(placed["x"].numpy(), np.arange(4.0))
  with pytest.raises(ValueError, match="rank"):
    distributed.initialize(num_processes=2)


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 2, "nccl"), ("cuda", 1, "gloo"), ("cpu", 2, "gloo"),
    ("cpu", 0, "gloo")])
def test_backend_follows_the_device(monkeypatch, device, cards, want):
  # A host with `cards` cards, two local ranks training on `device`.
  monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
  assert distributed.default_backend(2, device) == want


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_trainer_cli_joins_on_its_device(monkeypatch, device):
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  joined, trained = [], []
  monkeypatch.setattr(distributed, "initialize",
                      lambda **kwargs: joined.append(kwargs))
  monkeypatch.setattr(run_t2r_trainer, "train_eval_model",
                      lambda **kwargs: trained.append(kwargs) or
                      types.SimpleNamespace(train_metrics={},
                                            eval_metrics={}))
  assert run_t2r_trainer.main(["--device", device]) == 0
  assert joined == [{"device": device}]
  assert trained == [{"device": device}]


def test_a_mesh_of_ranks_runs_no_cuda_graph():
  from tensor2robot_tpu_torch.train.trainer import check_graphable
  optimizer = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
  check_graphable(optimizer, mesh=_virtual({"data": 1}))
  with pytest.raises(NotImplementedError, match="K eager steps"):
    check_graphable(optimizer, mesh=_virtual({"data": 2}))


@pytest.mark.parametrize("name", ["pipeline_apply", "stack_stage_params",
                                  "expert_parallel_moe", "init_moe_params",
                                  "switch_moe", "MoEParams"])
def test_pipeline_and_experts_wait_for_15c(name):
  with pytest.raises(NotImplementedError, match="item 15c"):
    getattr(parallel, name)()


def test_mesh_stamp_and_refusal_as_jax():
  for axes in ({"data": 2}, {"data": 1, "model": 2}):
    assert checkpoints.mesh_geometry(_virtual(axes)) == (
        jax_checkpoints.mesh_geometry(_jax_mesh(axes)))
  saved = checkpoints.mesh_geometry(_virtual({"data": 2}))
  checkpoints.validate_restore_mesh(saved, _virtual({"data": 2}))
  checkpoints.validate_restore_mesh(None, _virtual({"data": 4}))
  with pytest.raises(ValueError) as port_error:
    checkpoints.validate_restore_mesh(saved, _virtual({"data": 1,
                                                       "model": 2}))
  with pytest.raises(ValueError) as jax_error:
    jax_checkpoints.validate_restore_mesh(saved, _jax_mesh({"data": 1,
                                                            "model": 2}))
  assert str(port_error.value) == str(jax_error.value)


def test_a_failed_rank_fails_the_launch():
  with pytest.raises(RuntimeError, match="of 2 failed"):
    launch.launch(ranks.attention_cases, 2, ([{"name": "bad",
                                                "op": "ring",
                                                "axes": {"seq": 3}}],),
                  timeout_s=120)
