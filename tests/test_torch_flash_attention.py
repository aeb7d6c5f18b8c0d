"""The port's flash attention held against the JAX ops/flash_attention.py.

The port's plain versions (what a CPU tensor takes) must agree with the JAX
Pallas kernels, run here in interpret mode, and with the JAX reference, on
the shapes and tolerances of tests/test_ops.py: forward out and lse (K2),
dq (K3), dk and dv (K4). The bfloat16 K2-K4 run on the tensor cores,
which round P (and dS) to bfloat16 before the product that follows:
TestTensorCoreNumerics rounds at the same points on the CPU and holds the
result to the bfloat16 tolerance that chip_smoke.py holds the kernels to.
The CUDA kernels run only on a GPU: the tests marked `cuda` hold each
against its plain version there and skip on a machine without one.
"""

import importlib
import math

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
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
HEAD_DIMS = [16, 64, 128]


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


def _bf16(x):
  """x rounded to bfloat16, kept in float32."""
  return x.to(torch.bfloat16).float()


def _tensor_core_forward(q, k, v, causal, scale, dropped_keys=None):
  """What the tensor-core K2 computes, in float32 on the CPU: the online
  softmax over 64-key tiles, each tile's P rounded to bf16 before P V.
  `dropped_keys` (a slice) plants a fault: those keys take no weight."""
  s = fa._scores(q, k, causal, scale)  # (B, H, T, T)
  if dropped_keys is not None:
    s[..., dropped_keys] = -math.inf
  m = torch.full(s.shape[:-1] + (1,), -math.inf)
  l = torch.zeros_like(m)
  acc = torch.zeros(s.shape[:-1] + (q.shape[-1],))
  for k0 in range(0, s.shape[-1], 64):
    tile = s[..., k0:k0 + 64]
    m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
    shift = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
    correction = torch.exp(m - shift)
    e = torch.exp(tile - shift)
    l = l * correction + e.sum(dim=-1, keepdim=True)
    acc = acc * correction + torch.einsum(
        "bhqk,bkhd->bhqd", _bf16(e), v.float()[:, k0:k0 + 64])
    m = m_new
  lse = torch.where(m == -math.inf, torch.zeros_like(m), m) + torch.log(
      l.clamp_min(1e-37))
  out = acc / torch.where(l == 0, torch.ones_like(l), l)
  return out.permute(0, 2, 1, 3).to(q.dtype), lse[..., 0]


def _tensor_core_dq(q, k, v, dout, lse, delta, causal, scale,
                    dropped_keys=None):
  """What the tensor-core K3 computes, in float32 on the CPU: dS rounded
  to bf16 before dq = dS k * scale. `dropped_keys` (a slice) plants a
  fault: those keys add nothing to dq."""
  _, ds = fa._probabilities_and_ds(q, k, v, dout, lse, delta, causal, scale)
  if dropped_keys is not None:
    ds[..., dropped_keys] = 0.0
  dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), k.float()) * scale
  return dq.to(q.dtype)


def _tensor_core_dkv(q, k, v, dout, lse, delta, causal, scale):
  """What the tensor-core K4 computes, in float32 on the CPU: P and dS
  rounded to bf16 before dv = P^T dout and dk = dS^T q * scale."""
  p, ds = fa._probabilities_and_ds(q, k, v, dout, lse, delta, causal, scale)
  dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q.float()) * scale
  dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dout.float())
  return dk.to(k.dtype), dv.to(v.dtype)


def _bf16_limit(want):
  """The largest |got - want| of a bf16 flash output, element by element:
  1e-5 + 2^-5 rms(row) + 2^-7 |want| over rows of D, as chip_smoke.py's
  flash_limit (the reason for each term is written there)."""
  w = want.float()
  rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
  return 1e-5 + 2 ** -5 * rms + 2 ** -7 * w.abs()


def _assert_bf16_within(got, want, name):
  diff = (got.float() - want.float()).abs()
  share = float((diff / _bf16_limit(want)).max())
  assert share <= 1.0, (f"{name}: max err {float(diff.max())}, {share} "
                        "times its limit at worst")


def _assert_lse_within(got, want, name):
  torch.testing.assert_close(got.float(), want.float(), **LSE_TOL,
                             msg=lambda m: f"{name}: {m}")


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


class TestTensorCoreNumerics:
  """The tensor-core kernels' rounding, rebuilt on the CPU, against the
  JAX Pallas kernels (interpret mode) and the float32 plain versions."""

  @pytest.mark.parametrize("d", HEAD_DIMS)
  @pytest.mark.parametrize("t", LENGTHS)
  @pytest.mark.parametrize("causal", [False, True])
  def test_rounded_forward_holds_the_bf16_tolerance(self, jax_fa, t, causal,
                                                    d):
    jax, jfa = jax_fa
    q, k, v = (x.to(torch.bfloat16) for x in _torch(
        *_inputs(t, d=d, seed=20 + t + d, count=3)))
    scale = 1.0 / np.sqrt(d)
    out, lse = _tensor_core_forward(q, k, v, causal, scale)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, scale)
    _assert_bf16_within(out, want_out, "out vs the plain version")
    _assert_lse_within(lse, want_lse, "lse vs the plain version")
    bf16 = jax.numpy.bfloat16
    pallas_out, pallas_lse = jfa._pallas_forward(
        *(jax.numpy.asarray(x.float().numpy(), bf16) for x in (q, k, v)),
        causal, scale, with_residuals=True)
    _assert_bf16_within(
        out, torch.from_numpy(np.asarray(pallas_out, np.float32)),
        "out vs the Pallas kernel")
    _assert_lse_within(
        lse, torch.from_numpy(_lse_rows(pallas_lse, 2, 2).copy()),
        "lse vs the Pallas kernel")

  @pytest.mark.parametrize("d", HEAD_DIMS)
  @pytest.mark.parametrize("t", LENGTHS)
  @pytest.mark.parametrize("causal", [False, True])
  def test_rounded_dkv_holds_the_bf16_tolerance(self, jax_fa, t, causal, d):
    # The same residuals (the plain forward's out and lse) through both
    # backwards.
    jax, jfa = jax_fa
    q, k, v, dout = (x.to(torch.bfloat16) for x in _torch(
        *_inputs(t, d=d, seed=40 + t + d)))
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_forward_reference(q, k, v, causal, scale)
    delta = fa.flash_delta(out, dout)
    got = _tensor_core_dkv(q, k, v, dout, lse, delta, causal, scale)
    want = fa.flash_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
    bf16 = jax.numpy.bfloat16
    jq, jk, jv, jdo, jout = (jax.numpy.asarray(x.float().numpy(), bf16)
                             for x in (q, k, v, dout, out))
    _, *pallas = jfa._pallas_backward(
        jq, jk, jv, jout, jax.numpy.asarray(lse.numpy().reshape(4, t, 1)),
        jdo, causal, scale)
    for name, a, b, c in zip(("dk", "dv"), got, want, pallas):
      _assert_bf16_within(a, b, f"{name} vs the plain version")
      _assert_bf16_within(a, torch.from_numpy(np.asarray(c, np.float32)),
                          f"{name} vs the Pallas kernel")

  @pytest.mark.parametrize("d", HEAD_DIMS)
  @pytest.mark.parametrize("t", LENGTHS)
  @pytest.mark.parametrize("causal", [False, True])
  def test_rounded_dq_holds_the_bf16_tolerance(self, jax_fa, t, causal, d):
    # The same residuals (the plain forward's out and lse) through both
    # backwards: the rounded dq against the plain version and _kernel_dq.
    jax, jfa = jax_fa
    q, k, v, dout = (x.to(torch.bfloat16) for x in _torch(
        *_inputs(t, d=d, seed=60 + t + d)))
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_forward_reference(q, k, v, causal, scale)
    delta = fa.flash_delta(out, dout)
    got = _tensor_core_dq(q, k, v, dout, lse, delta, causal, scale)
    want = fa.flash_dq_reference(q, k, v, dout, lse, delta, causal, scale)
    _assert_bf16_within(got, want, "dq vs the plain version")
    bf16 = jax.numpy.bfloat16
    jq, jk, jv, jdo, jout = (jax.numpy.asarray(x.float().numpy(), bf16)
                             for x in (q, k, v, dout, out))
    pallas_dq, _, _ = jfa._pallas_backward(
        jq, jk, jv, jout, jax.numpy.asarray(lse.numpy().reshape(4, t, 1)),
        jdo, causal, scale)
    _assert_bf16_within(
        got, torch.from_numpy(np.asarray(pallas_dq, np.float32)),
        "dq vs the Pallas kernel")

  @pytest.mark.parametrize("fault", [
      "key tile dropped", "next stage's v", "late rows 10% off",
      "query tile dropped", "next stage's dout", "dq key tile dropped",
      "dq next stage's k"])
  @pytest.mark.parametrize("causal", [False, True])
  def test_bf16_limit_catches_planted_faults(self, fault, causal):
    # The limit is tight enough to catch a kernel that is slightly wrong:
    # each fault, planted in the rounding helpers, exceeds it somewhere,
    # while the same helpers without it hold (the tests above).
    q, k, v, dout = (x.to(torch.bfloat16) for x in _torch(
        *_inputs(256, d=64, seed=50)))
    scale = 1.0 / 8.0
    out, lse = fa.flash_forward_reference(q, k, v, causal, scale)
    delta = fa.flash_delta(out, dout)
    want = {"out": out,
            "dq": fa.flash_dq_reference(q, k, v, dout, lse, delta, causal,
                                        scale)}
    want["dk"], want["dv"] = fa.flash_dkv_reference(q, k, v, dout, lse,
                                                    delta, causal, scale)
    # One 64-row tile, its neighbour: the next stage of the ring.
    tile, nxt = slice(128, 192), slice(192, 256)
    if fault == "key tile dropped":
      got = {"out": _tensor_core_forward(q, k, v, causal, scale,
                                         dropped_keys=tile)[0]}
    elif fault == "next stage's v":
      v = v.clone()
      v[:, tile] = v[:, nxt]
      got = {"out": _tensor_core_forward(q, k, v, causal, scale)[0]}
    elif fault == "late rows 10% off":
      good = _tensor_core_forward(q, k, v, causal, scale)[0]
      got = {"out": torch.cat([good[:, :192], good[:, 192:] * 1.1], dim=1)}
    elif fault == "query tile dropped":
      dout, delta = dout.clone(), delta.clone()
      dout[:, tile] = 0.0
      delta[..., tile] = 0.0
      got = dict(zip(("dk", "dv"), _tensor_core_dkv(
          q, k, v, dout, lse, delta, causal, scale)))
    elif fault == "next stage's dout":
      dout = dout.clone()
      dout[:, tile] = dout[:, nxt]
      got = dict(zip(("dk", "dv"), _tensor_core_dkv(
          q, k, v, dout, lse, delta, causal, scale)))
    elif fault == "dq key tile dropped":
      got = {"dq": _tensor_core_dq(q, k, v, dout, lse, delta, causal, scale,
                                   dropped_keys=tile)}
    else:
      k = k.clone()
      k[:, tile] = k[:, nxt]
      got = {"dq": _tensor_core_dq(q, k, v, dout, lse, delta, causal,
                                   scale)}
    exceeded = [name for name, x in got.items()
                if bool(((x.float() - want[name].float()).abs()
                         > _bf16_limit(want[name])).any())]
    assert exceeded, f"{fault} stays within the bf16 limit"


def _layouts():
  """(name, bf16 tensor, whether the tensor-core kernels read it in place)."""
  x = torch.from_numpy(_inputs(40, d=48, seed=30, count=1)[0]).to(
      torch.bfloat16)
  wide = x[:, :, :1, :]  # (2, 40, 1, 48): rows of 96 bytes
  return [
      ("contiguous", x[..., :16].contiguous(), True),
      ("column slice 16 bytes in", wide[..., 8:24], True),
      ("column slice 8 bytes in", wide[..., 4:20], False),
      ("row stride of 20 elements", x[..., :20].contiguous()[..., :16],
       False),
      ("stride 0", torch.ones((), dtype=torch.bfloat16).expand(2, 40, 2, 16),
       False),
      ("time and head dim transposed",
       x[:, :16, :1, :16].contiguous().transpose(1, 3), False),
      ("size-1 head dim of any stride",
       torch.zeros(2, 40, 16, dtype=torch.bfloat16).as_strided(
           (2, 40, 1, 16), (640, 16, 3, 1)), True),
  ]


class TestContract:

  @pytest.mark.parametrize("index", range(len(_layouts())),
                           ids=[name for name, _, _ in _layouts()])
  def test_tensor_core_operand_layout_rule(self, index):
    # bf16 operands of the tensor-core kernels: read in place when rows
    # are 16-byte pieces, else one contiguous copy (never a plain version).
    _, x, in_place = _layouts()[index]
    got = fa._tensor_core_operand(x)
    assert (got is x) == in_place
    torch.testing.assert_close(got, x, rtol=0, atol=0)
    assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
    assert all(stride % 8 == 0 for size, stride in zip(got.shape[:-1],
                                                       got.stride()[:-1])
               if size > 1)

  def test_cpu_bfloat16_takes_the_plain_versions(self):
    # A stride-0 dout (what out.sum() gives) and all: the CPU runs the
    # plain versions as they are, without the tensor cores' rounding.
    q, k, v = (x.to(torch.bfloat16) for x in _torch(
        *_inputs(40, seed=31, count=3)))
    dout = torch.ones((), dtype=torch.bfloat16).expand(q.shape)
    before = dict(fa.flash_attention.launches)
    out, lse = fa.flash_forward(q, k, v, True, 0.25)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, True, 0.25)
    delta = fa.flash_delta(out, dout)
    args = (q, k, v, dout, lse, delta, True, 0.25)
    for got, want in zip(
        (out, lse, fa.flash_dq(*args), *fa.flash_dkv(*args)),
        (want_out, want_lse, fa.flash_dq_reference(*args),
         *fa.flash_dkv_reference(*args))):
      torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fa.flash_attention.launches == before

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


def _moved(before):
  return {name: count - before[name]
          for name, count in fa.flash_attention.launches.items()}


# The counts one forward + dq + dkv moves, by dtype.
_TENSOR_CORES = {"forward": 0, "dq": 0, "dkv": 0, "forward_tc": 1,
                 "dq_tc": 1, "dkv_tc": 1}
_CUDA_CORES = {"forward": 1, "dq": 1, "dkv": 1, "forward_tc": 0,
               "dq_tc": 0, "dkv_tc": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048, 1, 64), (2, 256, 4, 64),
                                   (2, 40, 2, 8), (2, 40, 2, 64),
                                   (1, 1030, 1, 128), (2, 1030, 1, 64),
                                   (2, 300, 2, 16), (2, 300, 2, 128),
                                   (3, 1, 2, 16)])
@pytest.mark.parametrize("dout_layout", ["contiguous", "offset", "stride0"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, shape, dout_layout,
                                           causal, dtype):
  # bf16 K2-K4 on the tensor cores, float32 on the CUDA cores. dout as a
  # column slice 16 bytes into wider rows (the tensor cores read it in
  # place) or with stride 0 (they get a copy first).
  torch.backends.cuda.matmul.allow_tf32 = False
  b, t, h, d = shape
  q, k, v, dout = (x.to(cuda_device, dtype) for x in _torch(
      *_inputs(t, b=b, h=h, d=d, seed=12)))
  if dout_layout == "offset":
    offset = 16 // dout.element_size()
    wide = torch.zeros(b, t, h, d + 2 * offset, dtype=dtype,
                       device=cuda_device)
    wide[..., offset:offset + d] = dout
    dout = wide[..., offset:offset + d]
    assert fa._tensor_core_operand(dout) is dout
  elif dout_layout == "stride0":
    dout = torch.ones((), dtype=dtype, device=cuda_device).expand(shape)
  scale = 1.0 / np.sqrt(d)

  def assert_within(got, want):
    # float32: sums in another order; bfloat16: chip_smoke.py's limit.
    if dtype == torch.float32:
      torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
      _assert_bf16_within(got, want, "bf16 kernel vs its plain version")

  before = dict(fa.flash_attention.launches)
  out, lse = fa.flash_forward(q, k, v, causal, scale)
  want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, scale)
  assert_within(out, want_out)
  torch.testing.assert_close(lse, want_lse, **LSE_TOL)
  delta = fa.flash_delta(out, dout)
  assert_within(fa.flash_dq(q, k, v, dout, lse, delta, causal, scale),
                fa.flash_dq_reference(q, k, v, dout, lse, delta, causal,
                                      scale))
  for got, want in zip(
      fa.flash_dkv(q, k, v, dout, lse, delta, causal, scale),
      fa.flash_dkv_reference(q, k, v, dout, lse, delta, causal, scale)):
    assert_within(got, want)
  torch.cuda.synchronize()
  assert _moved(before) == (_CUDA_CORES if dtype == torch.float32
                            else _TENSOR_CORES)


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
