"""Flash attention: CUDA kernels K2-K4 + their plain PyTorch versions.

Counterpart of ``tensor2robot_tpu/ops/flash_attention.py``: attention over
(B, T, H, D) without a (T, T) tensor in device memory. The forward (K2)
returns the output and the per-row logsumexp; the backward recomputes the
probabilities from that logsumexp, dq in one pass (K3) and dk, dv in
another (K4), with delta = rowsum(dout * out) taken in float32 beside them.

``flash_attention`` takes the plain versions only for tensors on the CPU.
For CUDA tensors it launches the hand-written kernels
(``csrc/flash_attention.cu``) or raises: there is no switch that picks the
plain version on the card. Its gradient is first order only, as the JAX
``custom_vjp``: differentiating it twice raises.

The kernels' limits are the card's, not the TPU's: they stream key and
query tiles and mask the ragged tail, so every T >= 1 runs; the head dim
is a multiple of 8 up to 128; float32 and bfloat16, with float32 sums.

The dtype picks the kernel. bfloat16 runs K2, K3 and K4 on the tensor
cores (wgmma), which round the probabilities P (and dS) to bfloat16 before
the product that follows them, where the plain versions keep float32; they
read rows in 16-byte pieces, so ``_tensor_core_operand`` hands them a
contiguous copy of any operand laid out otherwise. float32 runs all three
on the CUDA cores, whose float32 products keep the 1e-4 float32 tolerance
that a TF32 tensor-core product would miss. The CUDA-core kernels still
take bfloat16, but no wrapper sends it to them: that form exists only as
the yardstick ``chip_smoke.py`` times the tensor-core kernels against.
``flash_attention.launches`` counts each kernel apart: ``forward``, ``dq``
and ``dkv`` the CUDA-core kernels, ``forward_tc``, ``dq_tc`` and
``dkv_tc`` the tensor-core ones.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from tensor2robot_tpu_torch.ops import _build, graph_launches

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # rows of the kernels' query and key tiles
_MAX_TILES = 65535  # the launch grid's second dimension
_MAX_ROWS = (1 << 31) - 1  # B*H, the grid's first dimension


# --- plain versions ---------------------------------------------------------


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
  """(B, H, Tq, Tk) float32 scores, -inf above the diagonal if causal."""
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    t = q.shape[1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -math.inf)
  return s


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
  """Dense attention that materialises the scores. (B, T, H, D) in/out."""
  if scale is None:
    scale = 1.0 / math.sqrt(q.shape[-1])
  weights = torch.softmax(_scores(q, k, causal, scale), dim=-1)
  out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
  return out.to(q.dtype)


def flash_forward_reference(q, k, v, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
  """What K2 computes: out in q's dtype and the (B, H, T) float32 lse."""
  s = _scores(q, k, causal, scale)
  m = s.amax(dim=-1, keepdim=True)
  shift = torch.where(m == -math.inf, torch.zeros_like(m), m)
  e = torch.exp(s - shift)
  l = e.sum(dim=-1, keepdim=True)
  lse = shift + torch.log(l.clamp_min(1e-37))
  p = e / torch.where(l == 0, torch.ones_like(l), l)
  out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
  return out, lse[..., 0]


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
  """delta = rowsum(dout * out) in float32, as contiguous (B, H, T) rows."""
  delta = torch.sum(dout.float() * out.float(), dim=-1)  # (B, T, H)
  return delta.permute(0, 2, 1).contiguous()


def _probabilities_and_ds(q, k, v, dout, lse, delta, causal, scale):
  p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
  dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
  return p, p * (dp - delta[..., None])


def flash_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
  """What K3 computes: dq = (P * (dout v^T - delta)) k * scale."""
  _, ds = _probabilities_and_ds(q, k, v, dout, lse, delta, causal, scale)
  dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
  return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
  """What K4 computes: dk = dS^T q * scale and dv = P^T dout."""
  p, ds = _probabilities_and_ds(q, k, v, dout, lse, delta, causal, scale)
  dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
  dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
  return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, out, lse, dout, causal: bool,
                                       scale: float):
  """The whole plain backward: (dq, dk, dv) from the forward's residuals."""
  delta = flash_delta(out, dout)
  dq = flash_dq_reference(q, k, v, dout, lse, delta, causal, scale)
  dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
  return dq, dk, dv


# --- the kernels ------------------------------------------------------------


class _Operand(ctypes.Structure):
  _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_int64),
              ("st", ctypes.c_int64), ("sh", ctypes.c_int64),
              ("sd", ctypes.c_int64)]


class _Params(ctypes.Structure):
  """Mirror of ``FlashParams`` in csrc/flash_attention.cu, field by field."""
  _fields_ = ([(name, _Operand) for name in
               ("q", "k", "v", "o", "dout", "dq", "dk", "dv")]
              + [("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
                 ("batch", ctypes.c_int64), ("seq", ctypes.c_int64),
                 ("heads", ctypes.c_int64), ("dim", ctypes.c_int64),
                 ("scale", ctypes.c_float), ("causal", ctypes.c_int)])


def _operand(x: Optional[torch.Tensor]) -> _Operand:
  if x is None:
    return _Operand()
  return _Operand(x.data_ptr(), *x.stride())


def _launch(entry: str, counter: str, q, k, v, causal, scale, *, o=None,
            dout=None, dq=None, dk=None, dv=None, lse=None,
            delta=None) -> None:
  """Runs one kernel on the current stream; raises if it fails."""
  b, t, h, d = q.shape
  if t > _MAX_TILES * _TILE or b * h > _MAX_ROWS:
    raise ValueError(
        f"flash_attention kernels take T <= {_MAX_TILES * _TILE} and "
        f"B*H <= {_MAX_ROWS}; got shape {tuple(q.shape)}.")
  lib = _build.load_library("flash_attention")
  fn = getattr(lib, entry)
  if fn.argtypes is None:
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
  params = _Params(
      _operand(q), _operand(k), _operand(v), _operand(o), _operand(dout),
      _operand(dq), _operand(dk), _operand(dv), lse.data_ptr(),
      None if delta is None else delta.data_ptr(), b, t, h, d, scale,
      int(causal))
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(ctypes.byref(params), _DTYPE_CODES[q.dtype], stream)
  if err != 0:
    raise RuntimeError(
        f"flash_attention {counter} kernel launch failed with CUDA error "
        f"{err}.")
  graph_launches.count(_add_launches, counter)


def _add_launches(counter: str, n: int) -> None:
  flash_attention.launches[counter] += n


def _check_rows(q, lse, delta) -> None:
  b, t, h, _ = q.shape
  for name, rows in (("lse", lse), ("delta", delta)):
    if (rows.dtype != torch.float32 or tuple(rows.shape) != (b, h, t)
        or not rows.is_contiguous() or rows.device != q.device):
      raise ValueError(
          f"{name} must be contiguous float32 (B, H, T) = {(b, h, t)} on "
          f"{q.device}; got {rows.dtype} {tuple(rows.shape)}.")


def _tensor_core_operand(x: torch.Tensor) -> torch.Tensor:
  """``x`` if the tensor-core kernels can read it in place, else a copy.

  They copy 16-byte pieces of each row, so they need a last-dim stride of
  1, a 16-byte-aligned base and strides of whole 16 bytes (8 elements) in
  every other dim of size above 1. Any other layout (a stride-0 ``dout``
  from ``out.sum()``, a transposed view, an odd offset) gets an explicit
  contiguous copy here; the call never goes to a plain version.
  """
  in_place = x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
      stride % 8 == 0 for size, stride in zip(x.shape[:-1], x.stride()[:-1])
      if size > 1)
  return x if in_place else x.clone(memory_format=torch.contiguous_format)


def flash_forward(q, k, v, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
  """K2's wrapper: (out in q's dtype, (B, H, T) float32 lse).

  bfloat16 on the card runs the tensor-core kernel, on operands that
  ``_tensor_core_operand`` passes or copies; float32 the CUDA-core one."""
  _check(q, k, v)
  if q.device.type == "cpu":
    return flash_forward_reference(q, k, v, causal, scale)
  b, t, h, _ = q.shape
  out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
  lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
  if q.dtype == torch.bfloat16:
    q, k, v = (_tensor_core_operand(x) for x in (q, k, v))
    _launch("t2r_flash_forward_tc", "forward_tc", q, k, v, causal, scale,
            o=out, lse=lse)
  else:
    _launch("t2r_flash_forward", "forward", q, k, v, causal, scale, o=out,
            lse=lse)
  return out, lse


def flash_dq(q, k, v, dout, lse, delta, causal: bool,
             scale: float) -> torch.Tensor:
  """K3's wrapper: dq in q's dtype.

  bfloat16 on the card runs the tensor-core kernel, on operands that
  ``_tensor_core_operand`` passes or copies; float32 the CUDA-core one."""
  _check(q, k, v, dout)
  _check_rows(q, lse, delta)
  if q.device.type == "cpu":
    return flash_dq_reference(q, k, v, dout, lse, delta, causal, scale)
  dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
  if q.dtype == torch.bfloat16:
    q, k, v, dout = (_tensor_core_operand(x) for x in (q, k, v, dout))
    _launch("t2r_flash_dq_tc", "dq_tc", q, k, v, causal, scale, dout=dout,
            dq=dq, lse=lse, delta=delta)
  else:
    _launch("t2r_flash_dq", "dq", q, k, v, causal, scale, dout=dout, dq=dq,
            lse=lse, delta=delta)
  return dq


def flash_dkv(q, k, v, dout, lse, delta, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
  """K4's wrapper: (dk, dv) in the input dtype.

  bfloat16 on the card runs the tensor-core kernel, on operands that
  ``_tensor_core_operand`` passes or copies; float32 the CUDA-core one."""
  _check(q, k, v, dout)
  _check_rows(q, lse, delta)
  if q.device.type == "cpu":
    return flash_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
  dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
  dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
  if q.dtype == torch.bfloat16:
    q, k, v, dout = (_tensor_core_operand(x) for x in (q, k, v, dout))
    _launch("t2r_flash_dkv_tc", "dkv_tc", q, k, v, causal, scale, dout=dout,
            dk=dk, dv=dv, lse=lse, delta=delta)
  else:
    _launch("t2r_flash_dkv", "dkv", q, k, v, causal, scale, dout=dout, dk=dk,
            dv=dv, lse=lse, delta=delta)
  return dk, dv


class _FlashAttentionFn(torch.autograd.Function):
  """K2 forward; K3 and K4 backward. First order only."""

  @staticmethod
  def forward(ctx, q, k, v, causal, scale):
    out, lse = flash_forward(q, k, v, causal, scale)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    return out

  @staticmethod
  @once_differentiable
  def backward(ctx, dout):
    q, k, v, out, lse = ctx.saved_tensors
    dout = dout.to(q.dtype)
    delta = flash_delta(out, dout)
    dq = flash_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
    dk, dv = flash_dkv(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


def _check(*tensors: torch.Tensor) -> None:
  """Raises on what the kernels do not take; the CPU obeys the same rules."""
  q = tensors[0]
  if q.dim() != 4 or q.numel() == 0:
    raise ValueError(
        f"flash_attention takes non-empty (B, T, H, D); got shape "
        f"{tuple(q.shape)}.")
  if any(x.shape != q.shape for x in tensors):
    raise ValueError(
        f"flash_attention takes q, k and v (and dout) of one shape; got "
        f"{[tuple(x.shape) for x in tensors]}.")
  if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in tensors):
    raise TypeError(
        f"flash_attention takes float32 or bfloat16, one dtype for all; got "
        f"{[x.dtype for x in tensors]}.")
  d = q.shape[-1]
  if d % 8 or d > 128:
    raise ValueError(
        f"flash_attention takes a head dim that is a multiple of 8 up to "
        f"128; got {d}.")
  if q.device.type not in ("cuda", "cpu") or any(
      x.device != q.device for x in tensors):
    raise ValueError(
        f"flash_attention runs on one 'cuda' or 'cpu' device; got "
        f"{[str(x.device) for x in tensors]}.")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
  """Multi-head attention over (B, T, H, D) without the (T, T) tensor.

  Args:
    q, k, v: (B, T, H, D), float32 or bfloat16, one shape, any strides.
    causal: apply a causal mask.
    scale: attention scale; default 1/sqrt(D).

  Returns:
    (B, T, H, D) attention output in q's dtype.
  """
  _check(q, k, v)
  scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
  causal = bool(causal)
  if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
    return _FlashAttentionFn.apply(q, k, v, causal, scale)
  return flash_forward(q, k, v, causal, scale)[0]


# Kernel launches by kernel (CUDA cores: forward, dq, dkv; tensor cores:
# forward_tc, dq_tc, dkv_tc); the plain versions count none. A launch
# inside a CUDA graph counts at each replay (``graph_launches``).
flash_attention.launches = {"forward": 0, "dq": 0, "dkv": 0,
                            "forward_tc": 0, "dq_tc": 0, "dkv_tc": 0}
