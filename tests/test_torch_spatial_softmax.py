"""The port's spatial softmax held against the JAX ops/spatial_softmax.py.

The port's plain version (the one a CPU tensor takes) must agree with the
JAX Pallas kernel, run here in interpret mode, and with the JAX reference,
on the shapes and tolerances of tests/test_ops.py. The map's strides pick
one of two CUDA kernels (`_kernel_for`, tested here); the kernels run only
on a GPU: the test marked `cuda` holds each against the plain version
there and skips on a machine without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tensor2robot_tpu_torch.ops.spatial_softmax import (  # noqa: E402
    _kernel_for,
    spatial_softmax,
    spatial_softmax_reference,
)

SHAPES = [(2, 8, 8, 16), (1, 7, 5, 3), (3, 1, 9, 130)]


@pytest.fixture(scope="module")
def jax_ops():
  """JAX and its spatial-softmax module, imported only where compared."""
  jax = pytest.importorskip("jax")
  from tensor2robot_tpu import ops as jax_ss
  return jax, jax_ss


def _normal(shape, seed):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def _layout(x, layout):
  """x's values as a (B, H, W, C) map in the named memory layout: "nhwc"
  contiguous, "nchw" the NCHW view a conv tower hands over, "slice_even"
  / "slice_odd" the channels of a wider map from channel 8 / 1."""
  if layout == "nchw":
    return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
  if layout.startswith("slice"):
    offset = 8 if layout == "slice_even" else 1
    wide = torch.zeros(x.shape[:3] + (x.shape[3] + 9,), dtype=x.dtype,
                       device=x.device)
    wide[..., offset:offset + x.shape[3]] = x
    return wide[..., offset:offset + x.shape[3]]
  return x


# The kernel each layout takes: channels contiguous -> the channel-group
# kernel; the NCHW view (stride_w 1) -> the warp-per-(b, c) kernel.
_KERNEL_OF_LAYOUT = {"nhwc": "channels", "nchw": "warp",
                     "slice_even": "channels", "slice_odd": "channels"}


class TestAgainstJax:

  @pytest.mark.parametrize("shape", SHAPES)
  def test_matches_pallas_and_reference(self, jax_ops, shape):
    jax, jax_ss = jax_ops
    x = _normal(shape, 0)
    got = spatial_softmax(torch.from_numpy(x))
    assert got.shape == (shape[0], 2 * shape[3])
    assert got.dtype == torch.float32
    pallas = jax_ss.spatial_softmax(jax.numpy.asarray(x),
                                    implementation="pallas")
    reference = jax_ss.spatial_softmax_reference(jax.numpy.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(reference),
                               atol=1e-5)

  def test_temperature(self, jax_ops):
    jax, jax_ss = jax_ops
    x = _normal((2, 6, 6, 4), 1)
    got = spatial_softmax(torch.from_numpy(x), temperature=0.5)
    want = jax_ss.spatial_softmax(jax.numpy.asarray(x), temperature=0.5,
                                  implementation="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

  def test_bfloat16_io(self, jax_ops):
    jax, jax_ss = jax_ops
    x = _normal((2, 4, 4, 8), 2)
    got = spatial_softmax(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jax_ss.spatial_softmax(
        jax.numpy.asarray(x, jax.numpy.bfloat16), implementation="pallas")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)

  def test_gradients_match_jax(self, jax_ops):
    jax, jax_ss = jax_ops
    x = _normal((2, 6, 6, 4), 3)
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(spatial_softmax(xt) ** 2).backward()
    want = jax.grad(lambda f: jax.numpy.sum(
        jax_ss.spatial_softmax(f, implementation="pallas") ** 2))(
            jax.numpy.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5)

  def test_second_order_gradients_match_jax(self, jax_ops):
    jax, jax_ss = jax_ops
    jnp = jax.numpy
    x = _normal((1, 4, 4, 2), 5)
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(spatial_softmax(xt) ** 3), xt,
                               create_graph=True)
    torch.sum(g ** 2).backward()
    f = lambda v: jnp.sum(jax_ss.spatial_softmax(
        v, implementation="pallas") ** 3)
    want = jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-4)


class TestPlainVersion:

  def test_peak_location(self):
    # A sharp peak at (row 2, col 5) of an 8x8 map: expected coordinates
    # near linspace(-1, 1, 8)[5] (x) and [2] (y).
    x = np.full((1, 8, 8, 1), -10.0, np.float32)
    x[0, 2, 5, 0] = 10.0
    out = spatial_softmax(torch.from_numpy(x)).numpy()
    grid = np.linspace(-1, 1, 8)
    assert abs(out[0, 0] - grid[5]) < 1e-3
    assert abs(out[0, 1] - grid[2]) < 1e-3

  def test_output_order_is_all_x_then_all_y(self):
    # Channel c peaks at column c and row (3 - c): the x block rises with
    # c and the y block falls, which an interleaved (x0, y0, ...) order
    # would not give.
    x = np.full((1, 4, 4, 4), -20.0, np.float32)
    for c in range(4):
      x[0, 3 - c, c, c] = 20.0
    out = spatial_softmax(torch.from_numpy(x)).numpy()[0]
    grid = np.linspace(-1, 1, 4)
    np.testing.assert_allclose(out[:4], grid, atol=1e-5)
    np.testing.assert_allclose(out[4:], grid[::-1], atol=1e-5)

  def test_one_pixel_axis_is_minus_one(self):
    out = spatial_softmax(torch.from_numpy(_normal((2, 1, 1, 3), 6)))
    np.testing.assert_array_equal(out.numpy(), -np.ones((2, 6), np.float32))

  def test_cpu_tensor_takes_the_plain_version(self):
    x = torch.from_numpy(_normal((2, 5, 6, 7), 7))
    before = spatial_softmax.launches
    torch.testing.assert_close(spatial_softmax(x),
                               spatial_softmax_reference(x), rtol=0, atol=0)
    assert spatial_softmax.launches == before

  @pytest.mark.parametrize("shape, layout, kernel", [
      ((2, 8, 8, 16), "nhwc", "channels"),
      ((64, 16, 16, 64), "nhwc", "channels"),
      ((2, 8, 8, 16), "nchw", "warp"),
      ((64, 16, 16, 64), "nchw", "warp"),
      ((2, 8, 8, 16), "slice_even", "channels"),
      ((2, 8, 8, 16), "slice_odd", "channels"),
      ((1, 7, 5, 3), "nhwc", "channels"),
      ((1, 7, 5, 3), "nchw", "warp"),
      ((3, 1, 9, 130), "nhwc", "channels"),
      ((3, 1, 9, 130), "nchw", "warp"),
      ((1, 8, 8, 1), "nhwc", "warp"),  # one channel: pixels contiguous
  ])
  def test_kernel_for_picks_by_strides(self, shape, layout, kernel):
    x = _layout(torch.from_numpy(_normal(shape, 9)), layout)
    assert tuple(x.shape) == shape
    assert _kernel_for(x.shape, x.stride()) == kernel
    torch.testing.assert_close(
        spatial_softmax(x), spatial_softmax_reference(x.contiguous()),
        rtol=0, atol=1e-6)

  def test_cpu_tensor_moves_no_kernel_count(self):
    x = torch.from_numpy(_normal((2, 5, 6, 7), 10))
    before = dict(spatial_softmax.launches_by_kernel)
    spatial_softmax(x)
    assert spatial_softmax.launches_by_kernel == before
    assert set(before) == {"warp", "channels"}

  @pytest.mark.parametrize("bad, error", [
      (torch.zeros(2, 3, 4), ValueError),
      (torch.zeros(1, 2, 2, 3, dtype=torch.float64), TypeError),
      (torch.zeros(1, 2, 2, 3, device="meta"), ValueError),
  ])
  def test_rejects_what_the_kernel_does_not_take(self, bad, error):
    with pytest.raises(error):
      spatial_softmax(bad)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 16, 16, 64), (64, 16, 16, 64),
                                   (2, 9, 11, 65)] + SHAPES)
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", sorted(_KERNEL_OF_LAYOUT))
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype, atol,
                                           layout):
  x = torch.from_numpy(_normal(shape, 8)).to(cuda_device, dtype)
  features = _layout(x, layout)
  kernel = _KERNEL_OF_LAYOUT[layout]
  before = dict(spatial_softmax.launches_by_kernel)
  total = spatial_softmax.launches
  got = spatial_softmax(features, temperature=0.7)
  torch.cuda.synchronize()
  assert got.dtype == dtype and got.device.type == "cuda"
  want = spatial_softmax_reference(features, temperature=0.7)
  torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
  assert spatial_softmax.launches == total + 1
  assert spatial_softmax.launches_by_kernel == {
      **before, kernel: before[kernel] + 1}

  xg = x.float().detach().requires_grad_()
  torch.sum(spatial_softmax(xg) ** 2).backward()
  xr = x.float().detach().requires_grad_()
  torch.sum(spatial_softmax_reference(xr) ** 2).backward()
  torch.testing.assert_close(xg.grad, xr.grad, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_cuda_kernels_keep_the_inf_and_nan_rules(cuda_device, layout):
  # Channel 0 is -inf on half its rows (they take no weight), channel 1 is
  # -inf everywhere and channel 2 holds one NaN (both give NaN), as in the
  # plain version.
  x = torch.from_numpy(_normal((2, 8, 8, 5), 11))
  x[:, :4, :, 0] = -np.inf
  x[:, :, :, 1] = -np.inf
  x[1, 3, 5, 2] = np.nan
  features = _layout(x.to(cuda_device), layout)
  before = dict(spatial_softmax.launches_by_kernel)
  got = spatial_softmax(features)
  torch.cuda.synchronize()
  kernel = _KERNEL_OF_LAYOUT[layout]
  assert spatial_softmax.launches_by_kernel[kernel] == before[kernel] + 1
  torch.testing.assert_close(got, spatial_softmax_reference(features),
                             rtol=0, atol=1e-5, equal_nan=True)
