"""The port's flash attention held against the JAX ops/flash_attention.py.

The port's plain versions (what a CPU tensor takes) must agree with the JAX
Pallas kernels, run here in interpret mode, and with the JAX reference, on
the shapes and tolerances of tests/test_ops.py: forward out and lse (K2),
dq (K3), dk and dv (K4). The CUDA kernels run only on a GPU: the tests
marked `cuda` hold each against its plain version there and skip on a
machine without one.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")

LENGTHS = [16, 40, 128, 256]
# float32 sums in another order than the JAX kernels (tests/test_ops.py).
OUT_ATOL = 2e-5
GRAD_ATOL = 5e-5
# bfloat16 outputs: both sides sum in float32 and round once; one bf16 ulp
# is 2^-8 of the value, and |out| < 2 here.
BF16_ATOL = 2e-2


@pytest.fixture(scope="module")
def jax_fa():
  """JAX and its flash-attention module, imported only where compared."""
  jax = pytest.importorskip("jax")
  return jax, importlib.import_module("tensor2robot_tpu.ops.flash_attention")


def _inputs(t, b=2, h=2, d=16, seed=0, count=4):
  """q, k, v (and dout) as in tests/test_ops.py: 0.5 * standard normal."""
  rng = np.random.default_rng(seed)
  return [(rng.standard_normal((b, t, h, d)) * 0.5).astype(np.float32)
          for _ in range(count)]


def _torch(*arrays):
  return [torch.from_numpy(np.array(a)) for a in arrays]


def _lse_rows(jax_lse, b, h):
  """The JAX (B*H, T, 1) lse as the port's (B, H, T)."""
  lse = np.asarray(jax_lse)
  return lse.reshape(b, h, lse.shape[1])


class TestAgainstJax:

  @pytest.mark.parametrize("t", LENGTHS)
  @pytest.mark.parametrize("causal", [False, True])
  def test_forward_matches_pallas_and_reference(self, jax_fa, t, causal):
    jax, jfa = jax_fa
    q, k, v = _inputs(t, seed=t, count=3)
    scale = 1.0 / np.sqrt(16)
    out, lse = fa.flash_forward(*_torch(q, k, v), causal, scale)
    assert out.dtype == torch.float32 and lse.shape == (2, 2, t)
    jq, jk, jv = (jax.numpy.asarray(x) for x in (q, k, v))
    want_out, want_lse = jfa._pallas_forward(jq, jk, jv, causal, scale,
                                             with_residuals=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), _lse_rows(want_lse, 2, 2),
                               atol=OUT_ATOL)
    public = fa.flash_attention(*_torch(q, k, v), causal=causal)
    reference = jfa.flash_attention_reference(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(public.numpy(), np.asarray(reference),
                               atol=OUT_ATOL)

  @pytest.mark.parametrize("t", LENGTHS)
  @pytest.mark.parametrize("causal", [False, True])
  def test_backward_matches_pallas_kernels(self, jax_fa, t, causal):
    # The same residuals (the JAX kernel's out and lse) through both
    # backwards: K3's dq and K4's dk, dv against _kernel_dq, _kernel_dkv.
    jax, jfa = jax_fa
    q, k, v, dout = _inputs(t, seed=t + 1)
    scale = 1.0 / np.sqrt(16)
    jq, jk, jv, jdo = (jax.numpy.asarray(x) for x in (q, k, v, dout))
    out, lse = jfa._pallas_forward(jq, jk, jv, causal, scale,
                                   with_residuals=True)
    want = jfa._pallas_backward(jq, jk, jv, out, lse, jdo, causal, scale)
    tq, tk, tv, tdo, tout = _torch(q, k, v, dout, out)
    tlse = torch.from_numpy(_lse_rows(lse, 2, 2).copy())
    delta = fa.flash_delta(tout, tdo)
    got = (fa.flash_dq(tq, tk, tv, tdo, tlse, delta, causal, scale),
           *fa.flash_dkv(tq, tk, tv, tdo, tlse, delta, causal, scale))
    whole = fa.flash_attention_backward_reference(tq, tk, tv, tout, tlse,
                                                  tdo, causal, scale)
    for name, a, c, b in zip(("dq", "dk", "dv"), got, whole, want):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                 err_msg=name)
      torch.testing.assert_close(c, a, rtol=0, atol=0)

  @pytest.mark.parametrize("t", LENGTHS)
  @pytest.mark.parametrize("causal", [False, True])
  def test_gradients_match_jax_grad(self, jax_fa, t, causal):
    # Autograd through the port's function against jax.grad of the JAX
    # reference, loss sum(out ** 2) as tests/test_ops.py.
    jax, jfa = jax_fa
    q, k, v = _inputs(t, seed=t + 2, count=3)
    leaves = [x.requires_grad_() for x in _torch(q, k, v)]
    torch.sum(fa.flash_attention(*leaves, causal=causal) ** 2).backward()
    want = jax.grad(
        lambda a, b, c: jax.numpy.sum(
            jfa.flash_attention_reference(a, b, c, causal=causal) ** 2),
        argnums=(0, 1, 2))(*(jax.numpy.asarray(x) for x in (q, k, v)))
    for leaf, b in zip(leaves, want):
      np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b),
                                 atol=GRAD_ATOL)

  @pytest.mark.parametrize("causal", [False, True])
  def test_bfloat16_in_and_out(self, jax_fa, causal):
    jax, jfa = jax_fa
    q, k, v = _inputs(128, seed=5, count=3)
    got = fa.flash_attention(
        *(x.to(torch.bfloat16) for x in _torch(q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    bf16 = jax.numpy.bfloat16
    want = jfa.flash_attention(
        *(jax.numpy.asarray(x, bf16) for x in (q, k, v)), causal=causal,
        implementation="pallas")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_ATOL)

  def test_ragged_length_against_reference(self, jax_fa):
    # T = 1030 is neither a multiple of 128 nor <= 1024: the JAX kernel
    # refuses it, the port takes it (the CUDA kernels mask the tail).
    jax, jfa = jax_fa
    q, k, v = _inputs(1030, b=1, h=1, d=8, seed=6, count=3)
    jq, jk, jv = (jax.numpy.asarray(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="divisible"):
      jfa.flash_attention(jq, jk, jv, implementation="pallas")
    leaves = [x.requires_grad_() for x in _torch(q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    want = jfa.flash_attention_reference(jq, jk, jv, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL)
    torch.sum(out ** 2).backward()
    grads = jax.grad(
        lambda a, b, c: jax.numpy.sum(
            jfa.flash_attention_reference(a, b, c, causal=True) ** 2),
        argnums=(0, 1, 2))(jq, jk, jv)
    for leaf, b in zip(leaves, grads):
      np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b),
                                 atol=GRAD_ATOL)


class TestContract:

  def test_default_scale_is_inverse_sqrt_head_dim(self):
    q, k, v = _torch(*_inputs(40, d=32, seed=7, count=3))
    torch.testing.assert_close(
        fa.flash_attention(q, k, v),
        fa.flash_attention(q, k, v, scale=1.0 / np.sqrt(32)),
        rtol=0, atol=0)
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, causal=True, scale=0.3),
        fa.flash_attention_reference(q, k, v, causal=True, scale=0.3),
        rtol=0, atol=1e-6)

  def test_cpu_tensors_take_the_plain_versions(self):
    q, k, v = (x.requires_grad_() for x in _torch(*_inputs(16, seed=8,
                                                           count=3)))
    before = dict(fa.flash_attention.launches)
    torch.sum(fa.flash_attention(q, k, v, causal=True)).backward()
    assert fa.flash_attention.launches == before

  def test_strided_head_view_needs_no_copy(self):
    # AttentionBlock hands over (B, T, 1, D) views of (B, T, D) slices.
    wide = torch.from_numpy(_inputs(40, b=2, h=1, d=48, seed=9,
                                    count=1)[0])[:, :, 0, :]
    q, k, v = (wide[:, :, None, i * 16:(i + 1) * 16] for i in range(3))
    assert not q.is_contiguous()
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, causal=True),
        fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True), rtol=0, atol=0)

  def test_second_order_raises(self):
    # First order only, like the JAX custom_vjp.
    q, k, v = (x.requires_grad_() for x in _torch(*_inputs(16, seed=10,
                                                           count=3)))
    out = fa.flash_attention(q, k, v, causal=True)
    (grad_q,) = torch.autograd.grad(torch.sum(out ** 2), q,
                                    create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
      torch.sum(grad_q ** 2).backward()

  def test_one_length_token(self):
    q, k, v = _torch(*_inputs(1, seed=11, count=3))
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal=True), v,
                               rtol=0, atol=1e-7)

  @pytest.mark.parametrize("shapes, dtype, device, error", [
      ([(1, 8, 1, 12)] * 3, torch.float32, "cpu", ValueError),   # head dim
      ([(1, 8, 1, 136)] * 3, torch.float32, "cpu", ValueError),  # > 128
      ([(1, 8, 1, 16)] * 3, torch.float64, "cpu", TypeError),
      ([(1, 8, 1, 16)] * 3, torch.float32, "meta", ValueError),
      ([(1, 8, 1, 16), (1, 9, 1, 16), (1, 8, 1, 16)], torch.float32, "cpu",
       ValueError),
      ([(8, 1, 16)] * 3, torch.float32, "cpu", ValueError),
      ([(1, 0, 1, 16)] * 3, torch.float32, "cpu", ValueError),
  ])
  def test_rejects_what_the_kernels_do_not_take(self, shapes, dtype, device,
                                                error):
    q, k, v = (torch.zeros(s, dtype=dtype, device=device) for s in shapes)
    with pytest.raises(error):
      fa.flash_attention(q, k, v)

  def test_rejects_mixed_dtypes(self):
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(TypeError):
      fa.flash_attention(q, q.to(torch.bfloat16), q)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048, 1, 64), (2, 256, 4, 64),
                                   (2, 40, 2, 8), (1, 1030, 1, 128),
                                   (3, 1, 2, 16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, shape, causal,
                                           dtype):
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v, dout = (x.to(cuda_device, dtype) for x in _torch(
      *_inputs(shape[1], b=shape[0], h=shape[2], d=shape[3], seed=12)))
  scale = 1.0 / np.sqrt(shape[3])
  # float32: sums in another order; bfloat16: one rounding of a float32
  # result, up to one ulp (2^-8 relative) apart.
  tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
         else dict(rtol=2 ** -7, atol=1e-2))
  before = dict(fa.flash_attention.launches)
  out, lse = fa.flash_forward(q, k, v, causal, scale)
  want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, scale)
  torch.testing.assert_close(out, want_out, **tol)
  torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
  delta = fa.flash_delta(out, dout)
  torch.testing.assert_close(
      fa.flash_dq(q, k, v, dout, lse, delta, causal, scale),
      fa.flash_dq_reference(q, k, v, dout, lse, delta, causal, scale), **tol)
  for got, want in zip(
      fa.flash_dkv(q, k, v, dout, lse, delta, causal, scale),
      fa.flash_dkv_reference(q, k, v, dout, lse, delta, causal, scale)):
    torch.testing.assert_close(got, want, **tol)
  torch.cuda.synchronize()
  assert fa.flash_attention.launches == {
      name: count + 1 for name, count in before.items()}


@pytest.mark.cuda
def test_cuda_autograd_matches_reference(cuda_device):
  q, k, v = (x.to(cuda_device).requires_grad_() for x in _torch(
      *_inputs(300, b=2, h=2, d=32, seed=13, count=3)))
  torch.sum(fa.flash_attention(q, k, v, causal=True) ** 2).backward()
  got = [x.grad for x in (q, k, v)]
  for x in (q, k, v):
    x.grad = None
  torch.sum(fa.flash_attention_reference(q, k, v, causal=True) ** 2
            ).backward()
  for a, x in zip(got, (q, k, v)):
    torch.testing.assert_close(a, x.grad, rtol=1e-4, atol=1e-4)
