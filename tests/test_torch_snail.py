"""The port's SNAIL blocks and optimizers held against the JAX package.

A small stack in SNAIL's block pattern (attention, temporal convs,
attention, a dense head) is built on both sides, from the JAX package's own
blocks and from the port's, with the same weights through the bridge. Its
flash cores run the JAX Pallas kernels in interpret mode and the port's
plain versions. Outputs, every parameter's gradient and three Adam steps
must agree within the tolerances stated beside them.
"""

import collections
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch.layers import snail  # noqa: E402
from tensor2robot_tpu_torch.layers.vision_layers import Dense  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import (  # noqa: E402
    flax_default_init_,
)
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402

fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")

# The small stack: B 2, T 256, 8 input features, filters 4, key size 16.
BATCH, SEQ, FEATURES, FILTERS, KEY = 2, 256, 8, 4, 16
# float32 through 19 layers, sums in another order than XLA.
OUT_ATOL = 1e-4
GRAD_ATOL = 2e-4  # as tests/test_layers.py's flash-vs-dense gradients
# bfloat16: both sides round activations at every layer, at points that
# differ by a cast or two.
BF16_ATOL = 2e-2


def torch_stack(in_features, seq_len, filters, key_size, dtype, use_flash):
  """The port's stack; submodule names are flax's auto names."""
  first = snail.AttentionBlock(in_features, key_size, key_size, dtype,
                               use_flash)
  temporal = snail.TCBlock(first.out_features, seq_len, filters, dtype)
  second = snail.AttentionBlock(temporal.out_features, key_size, key_size,
                                dtype, use_flash)
  head = Dense(second.out_features, 1, torch.float32)
  return torch.nn.Sequential(collections.OrderedDict([
      ("AttentionBlock_0", first), ("TCBlock_0", temporal),
      ("AttentionBlock_1", second), ("Dense_0", head)]))


@pytest.fixture(scope="module")
def jax_side():
  """JAX, flax, optax and the JAX SNAIL blocks, imported only here."""
  jax = pytest.importorskip("jax")
  import flax.linen as nn
  import optax
  from tensor2robot_tpu.layers import snail as jax_snail
  return jax, nn, optax, jax_snail


def flax_stack(jax_side, dtype, use_flash=True):
  jax, nn, _, jax_snail = jax_side
  flash = dict(use_flash=use_flash, flash_implementation="pallas")

  class Stack(nn.Module):

    @nn.compact
    def __call__(self, x):
      x = jax_snail.AttentionBlock(KEY, KEY, dtype=dtype, **flash)(x)
      x = jax_snail.TCBlock(SEQ, FILTERS, dtype=dtype)(x)
      x = jax_snail.AttentionBlock(KEY, KEY, dtype=dtype, **flash)(x)
      return nn.Dense(1)(x)

  return Stack()


def _data(seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((BATCH, SEQ, FEATURES)).astype(np.float32)
  target = rng.standard_normal((BATCH, SEQ, 1)).astype(np.float32)
  return x, target


@pytest.fixture(scope="module")
def bridged(jax_side):
  """Flax variables of the f32 stack and the port's stack holding them."""
  jax = jax_side[0]
  x, _ = _data()
  variables = flax_stack(jax_side, jax.numpy.float32).init(
      jax.random.key(0), jax.numpy.asarray(x))
  module = torch_stack(FEATURES, SEQ, FILTERS, KEY, torch.float32, True)
  module.load_state_dict(bridge.variables_to_state_dict(variables, module))
  return variables, module


def _mse(out, target):
  return ((out - target) ** 2).mean()


class TestStackAgainstJax:

  def test_outputs_and_gradients(self, jax_side, bridged):
    jax = jax_side[0]
    jnp = jax.numpy
    variables, module = bridged
    x, target = _data()
    stack = flax_stack(jax_side, jnp.float32)

    def loss_fn(params):
      out = stack.apply({"params": params}, jnp.asarray(x))
      return _mse(out, jnp.asarray(target)), out

    (_, want_out), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    module.zero_grad()
    out = module(torch.from_numpy(x))
    _mse(out, torch.from_numpy(target)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=OUT_ATOL)
    want = bridge.variables_to_state_dict({"params": want_grads}, module)
    grads = {name: p.grad for name, p in module.named_parameters()}
    assert set(grads) == set(want)
    for name, grad in grads.items():
      np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                 atol=GRAD_ATOL, err_msg=name)

  def test_bfloat16_forward(self, jax_side, bridged):
    jax = jax_side[0]
    variables, module32 = bridged
    x, _ = _data()
    want = flax_stack(jax_side, jax.numpy.bfloat16).apply(
        variables, jax.numpy.asarray(x))
    module = torch_stack(FEATURES, SEQ, FILTERS, KEY, torch.bfloat16, True)
    module.load_state_dict(module32.state_dict())
    with torch.no_grad():
      out = module(torch.from_numpy(x))
    assert out.dtype == torch.float32  # the head computes in float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL)

  def test_three_adam_steps(self, jax_side, bridged):
    jax, _, optax, _ = jax_side
    jnp = jax.numpy
    variables, module32 = bridged
    x, target = _data(1)
    stack = flax_stack(jax_side, jnp.float32)
    loss_fn = lambda p: _mse(stack.apply({"params": p}, jnp.asarray(x)),
                             jnp.asarray(target))
    tx = optax.adam(1e-4)

    @jax.jit
    def step(params, state):
      loss, grads = jax.value_and_grad(loss_fn)(params)
      updates, state = tx.update(grads, state, params)
      return optax.apply_updates(params, updates), state, loss

    params = variables["params"]
    state = tx.init(params)
    want_losses = []
    for _ in range(3):
      params, state, loss = step(params, state)
      want_losses.append(float(loss))

    module = torch_stack(FEATURES, SEQ, FILTERS, KEY, torch.float32, True)
    module.load_state_dict(module32.state_dict())
    opt = optimizers.create_adam_optimizer()(module.parameters())
    losses = []
    for _ in range(3):
      opt.zero_grad()
      loss = _mse(module(torch.from_numpy(x)), torch.from_numpy(target))
      loss.backward()
      opt.step()
      losses.append(float(loss.detach()))
    # Losses: float32 forward sums (OUT_ATOL on outputs of size ~1).
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # Parameters: three updates of at most lr = 1e-4 each; the update's
    # direction m / sqrt(v) is insensitive to gradient noise of 1e-6. Not
    # so the key biases: their gradient is zero in exact arithmetic (a
    # softmax ignores a shift shared by all of a query's scores), so Adam
    # scales each side's rounding noise up to steps of lr: three steps
    # each way, 6 lr apart at most.
    want = bridge.variables_to_state_dict({"params": params}, module)
    for name, value in module.state_dict().items():
      atol = 6e-4 if name.endswith("key.bias") else 1e-6
      np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                 atol=atol, err_msg=name)

  @pytest.mark.parametrize("use_flash", [False, True])
  def test_attention_block_matches_flax(self, jax_side, use_flash):
    jax, nn, _, jax_snail = jax_side
    x = np.random.default_rng(2).random((2, 40, 6)).astype(np.float32)
    block = jax_snail.AttentionBlock(8, 8, dtype=jax.numpy.float32,
                                     use_flash=use_flash,
                                     flash_implementation="pallas")
    variables = block.init(jax.random.key(1), jax.numpy.asarray(x))
    module = snail.AttentionBlock(6, 8, 8, torch.float32, use_flash)
    module.load_state_dict(bridge.variables_to_state_dict(variables, module))
    np.testing.assert_allclose(
        module(torch.from_numpy(x)).detach().numpy(),
        np.asarray(block.apply(variables, jax.numpy.asarray(x))),
        atol=2e-5)

  def test_causal_conv_matches_flax(self, jax_side):
    jax, _, _, jax_snail = jax_side
    x = np.random.default_rng(3).random((2, 9, 3)).astype(np.float32)
    conv = jax_snail.CausalConv(features=5, kernel_size=3, dilation=2,
                                dtype=jax.numpy.float32)
    variables = conv.init(jax.random.key(2), jax.numpy.asarray(x))
    module = snail.CausalConv(3, 5, kernel_size=3, dilation=2,
                              dtype=torch.float32)
    module.load_state_dict(bridge.variables_to_state_dict(variables, module))
    np.testing.assert_allclose(
        module(torch.from_numpy(x)).detach().numpy(),
        np.asarray(conv.apply(variables, jax.numpy.asarray(x))), atol=1e-6)

  def test_bridge_round_trip_with_conv1d_kernels(self, bridged):
    variables, module = bridged
    back = bridge.state_dict_to_variables(module.state_dict())
    kernel = variables["params"]["TCBlock_0"]["dense0"]["filter"]["Conv_0"][
        "kernel"]
    assert kernel.ndim == 3  # (k, in, out)
    flat = lambda tree: dict(bridge._leaves(tree))
    want = flat(variables)
    got = flat(back)
    assert set(got) == set(want)
    for path, value in got.items():
      np.testing.assert_array_equal(value.numpy(), np.asarray(want[path]),
                                    err_msg="/".join(path))


class TestBlocks:

  def test_causal_conv_is_causal(self):
    """Perturbing input at time t must not change outputs before t."""
    module = snail.CausalConv(3, 4, kernel_size=2, dilation=2,
                              dtype=torch.float32)
    x = torch.from_numpy(
        np.random.default_rng(0).random((1, 8, 3)).astype(np.float32))
    with torch.no_grad():
      base = module(x)
      perturbed = x.clone()
      perturbed[0, 5] += 10.0
      out = module(perturbed)
    torch.testing.assert_close(out[0, :5], base[0, :5], rtol=0, atol=1e-6)
    assert (out[0, 5:] - base[0, 5:]).abs().max() > 1e-3

  @pytest.mark.parametrize("use_flash", [False, True])
  def test_attention_is_causal(self, use_flash):
    module = snail.AttentionBlock(4, 8, 8, torch.float32, use_flash)
    x = torch.from_numpy(
        np.random.default_rng(1).random((1, 6, 4)).astype(np.float32))
    with torch.no_grad():
      base = module(x)
      perturbed = x.clone()
      perturbed[0, 4] += 10.0
      out = module(perturbed)
    torch.testing.assert_close(out[0, :4], base[0, :4], rtol=0, atol=1e-5)
    assert (out[0, 4:] - base[0, 4:]).abs().max() > 1e-3

  def test_flash_matches_dense_core(self):
    dense = snail.AttentionBlock(4, 8, 8, torch.float32)
    flash = snail.AttentionBlock(4, 8, 8, torch.float32, use_flash=True)
    flash.load_state_dict(dense.state_dict())
    x = torch.from_numpy(
        np.random.default_rng(2).random((2, 128, 4)).astype(np.float32))
    torch.testing.assert_close(flash(x), dense(x), rtol=0, atol=2e-5)

  def test_tc_block_concat_growth_and_length_guard(self):
    module = snail.TCBlock(3, seq_len=8, filters=5, dtype=torch.float32)
    out = module(torch.zeros(2, 8, 3))
    # log2(8) = 3 dense blocks, each concatenating 5 channels.
    assert out.shape == (2, 8, 3 + 3 * 5) == (2, 8, module.out_features)
    with pytest.raises(ValueError, match="seq_len=8"):
      module(torch.zeros(2, 9, 3))

  def test_flash_requires_matching_sizes(self):
    with pytest.raises(ValueError, match="key_size == value_size"):
      snail.AttentionBlock(4, 8, 4, use_flash=True)

  def test_flax_init_covers_conv1d(self):
    module = snail.CausalConv(64, 256, kernel_size=2)
    flax_default_init_(module, torch.Generator().manual_seed(0))
    weight = module.Conv_0.weight
    std = np.sqrt(1.0 / (64 * 2))  # lecun_normal: fan_in = in x kernel
    assert abs(float(weight.std()) / std - 1) < 0.03
    assert float(weight.abs().max()) <= 2 * std / 0.87962566103423978
    assert not module.Conv_0.bias.any()


class TestOptimizersAgainstOptax:

  @pytest.mark.parametrize("name, kwargs", [
      ("adam", {}),
      ("adam", {"boundaries_and_scales": [(2, 0.5), (4, 0.1)]}),
      ("momentum", {}),
      ("momentum", {"nesterov": True, "boundaries_and_scales": [(3, 0.1)]}),
      ("sgd", {}),
      ("rmsprop", {}),
      ("rmsprop", {"momentum": 0.5}),
  ])
  def test_steps_match_optax(self, jax_side, name, kwargs):
    # A least-squares problem, six steps from the same start.
    jax, _, _, _ = jax_side
    jnp = jax.numpy
    from tensor2robot_tpu.utils import optimizers as jax_optimizers
    factory = f"create_{name}_optimizer"
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 5)).astype(np.float32)
    y = rng.standard_normal(16).astype(np.float32)
    w0 = rng.standard_normal(5).astype(np.float32)

    tx = getattr(jax_optimizers, factory)(**kwargs)()
    loss_fn = lambda w: jnp.mean((jnp.asarray(a) @ w - jnp.asarray(y)) ** 2)
    w, state = jnp.asarray(w0), None
    state = tx.init(w)
    for _ in range(6):
      updates, state = tx.update(jax.grad(loss_fn)(w), state, w)
      w = w + updates

    weight = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = getattr(optimizers, factory)(**kwargs)([weight])
    for _ in range(6):
      opt.zero_grad()
      torch.mean((torch.from_numpy(a) @ weight - torch.from_numpy(y)) ** 2
                 ).backward()
      opt.step()
    np.testing.assert_allclose(weight.detach().numpy(), np.asarray(w),
                               rtol=1e-5, atol=1e-6)

  def test_negative_schedule_scale_raises(self):
    with pytest.raises(ValueError, match="non-negative"):
      optimizers.create_sgd_optimizer(
          boundaries_and_scales=[(1, -0.5)])([torch.nn.Parameter(
              torch.zeros(1))])
