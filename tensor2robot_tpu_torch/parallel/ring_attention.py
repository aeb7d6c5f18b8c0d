"""Ring attention: exact attention with the sequence split over ranks.

Counterpart of ``tensor2robot_tpu/parallel/ring_attention.py``. Each rank
keeps its block of the queries; the key and value blocks travel round the
ring of the mesh axis (``collectives.ring_shift``: send to the next rank,
receive from the previous), and the softmax accumulates block by block
with a running maximum, so a rank holds O(T / P) keys at a time. The
causal mask reads global positions; a row with every key masked gives 0.

The backward is a second ring pass (an ``autograd.Function``): the
queries, their output's gradient, the logsumexp and delta = rowsum(dO ⊙ O)
(O in float32) stay home while each key block travels with its dK and dV,
which gather every rank's contribution and arrive home after P hops.

``ring_attention`` takes the global (B, T, H, D) tensors, replicated on
every rank as a JAX caller passes them, and returns the global output in
the same layout: each rank computes its block and the blocks are gathered.
A replicated input's gradient is the dense gradient (each rank's block of
it, gathered), not P times it. JAX computes this outside any Pallas
kernel; these are plain torch products.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import Mesh


def _scores(q, k, scale, causal, q_start, k_start):
  """(B, H, Tq, Tk) float32 scores of a query and a key block, -inf where
  the global causal mask hides a key."""
  s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
  if causal:
    q_pos = q_start + torch.arange(q.shape[1], device=q.device)
    k_pos = k_start + torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), -math.inf)
  return s


class _RingAttention(torch.autograd.Function):
  """One rank's block of ring attention; q, k, v are local (B, Tl, H, D)."""

  @staticmethod
  def forward(ctx, q, k, v, group, causal, scale):
    size, me = collectives.group_size(group), collectives.group_rank(group)
    t = q.shape[1]
    qf = q.float()
    b, _, h, d = q.shape
    row_max = q.new_full((b, h, t), -math.inf, dtype=torch.float32)
    denom = q.new_zeros((b, h, t), dtype=torch.float32)
    acc = q.new_zeros((b, t, h, d), dtype=torch.float32)
    kb, vb = k, v
    for step in range(size):
      source = (me - step) % size
      s = _scores(qf, kb.float(), scale, causal, me * t, source * t)
      new_max = torch.maximum(row_max, s.amax(dim=-1))
      # A row masked so far keeps a finite shift, so exp gives 0, not nan.
      safe = torch.where(torch.isneginf(new_max), 0.0, new_max)
      correction = torch.exp(row_max - safe)
      weights = torch.exp(s - safe[..., None])
      denom = denom * correction + weights.sum(dim=-1)
      acc = (acc * correction.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", weights, vb.float()))
      row_max = new_max
      if step < size - 1:
        kb = collectives.ring_shift(kb, group)
        vb = collectives.ring_shift(vb, group)
    empty = denom == 0.0
    out = acc / torch.where(empty, 1.0, denom).transpose(1, 2)[..., None]
    # Rows with no key: lse = +inf, so the backward's probabilities are 0.
    lse = torch.where(empty, math.inf, row_max + torch.log(denom))
    # The backward's delta reads the float32 output, as differentiating
    # the float32 forward does (a bfloat16 copy would put its rounding
    # into every dS).
    ctx.save_for_backward(q, k, v, out, lse)
    out = out.to(q.dtype)
    ctx.group, ctx.causal, ctx.scale = group, causal, scale
    return out

  @staticmethod
  def backward(ctx, dout):
    q, k, v, out, lse = ctx.saved_tensors
    group, causal, scale = ctx.group, ctx.causal, ctx.scale
    size, me = collectives.group_size(group), collectives.group_rank(group)
    t = q.shape[1]
    qf, dof = q.float(), dout.float()
    delta = (dof * out).sum(dim=-1).transpose(1, 2)  # (B, H, Tl)
    dq = torch.zeros_like(qf)
    kb, vb = k, v
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros_like(dkb)
    for step in range(size):
      source = (me - step) % size
      kf, vf = kb.float(), vb.float()
      p = torch.exp(_scores(qf, kf, scale, causal, me * t, source * t)
                    - lse[..., None])
      dvb = dvb + torch.einsum("bhqk,bqhd->bkhd", p, dof)
      ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
      dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
      dkb = dkb + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
      # Each block carries its gradients on; P hops bring them home.
      dkb = collectives.ring_shift(dkb, group)
      dvb = collectives.ring_shift(dvb, group)
      if step < size - 1:
        kb = collectives.ring_shift(kb, group)
        vb = collectives.ring_shift(vb, group)
    return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None,
            None)


def _local(x, mesh: Optional[Mesh], axis: str, batch_axis: Optional[str]):
  """This rank's (batch, sequence) block of a replicated (B, T, ...)."""
  if mesh is None:
    return x
  if batch_axis is not None:
    x = collectives.slice_gather_grad(x, mesh.group(batch_axis), 0)
  return collectives.slice_gather_grad(x, mesh.group(axis), 1)


def _global(x, mesh: Optional[Mesh], axis: str, batch_axis: Optional[str]):
  """The replicated (B, T, ...) of every rank's block."""
  if mesh is None:
    return x
  x = collectives.gather_slice_grad(x, mesh.group(axis), 1)
  if batch_axis is not None:
    x = collectives.gather_slice_grad(x, mesh.group(batch_axis), 0)
  return x


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Optional[Mesh], axis: str = "seq",
                   causal: bool = False, scale: Optional[float] = None,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
  """Exact multi-head attention with the sequence split over `axis`.

  Args:
    q, k, v: (B, T, H, D), replicated on every rank; T must divide over
      the axis (and B over `batch_axis`).
    mesh: the rank mesh (``create_mesh({"data": 1, "seq": P})``); None runs
      the one block on this rank.
    axis: the mesh axis carrying the sequence.
    causal: mask by global positions.
    scale: default 1/sqrt(D).
    batch_axis: the mesh axis carrying the batch on dp x sp meshes.

  Returns:
    (B, T, H, D) in q's dtype, replicated on every rank.
  """
  if scale is None:
    scale = 1.0 / math.sqrt(q.shape[-1])
  group = None if mesh is None else mesh.group(axis)
  ql, kl, vl = (_local(x, mesh, axis, batch_axis) for x in (q, k, v))
  out = _RingAttention.apply(ql, kl, vl, group, bool(causal), float(scale))
  return _global(out, mesh, axis, batch_axis)


def dense_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
  """Unsharded O(T²) attention in float32, in q's dtype out."""
  if scale is None:
    scale = 1.0 / math.sqrt(q.shape[-1])
  scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    t = q.shape[1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -math.inf)
  weights = torch.softmax(scores, dim=-1)
  out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
  return out.to(q.dtype)
