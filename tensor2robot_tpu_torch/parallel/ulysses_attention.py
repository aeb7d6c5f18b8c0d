"""All-to-all (Ulysses) sequence parallelism for attention.

Counterpart of ``tensor2robot_tpu/parallel/ulysses_attention.py``: one
``all_to_all`` of the stacked q, k, v re-splits them from sequence blocks
(B, T/P, H, D) to head blocks (B, T, H/P, D); each rank runs attention
over the whole sequence for its heads; a second ``all_to_all`` restores
the sequence split. Both collectives are differentiable (each one's
backward is the other's direction). Heads must divide over the ranks; ring
attention has no such limit.

``attn_impl="pallas"`` keeps the JAX name for the blockwise local core:
the port's ``ops.flash_attention``, which on the card launches the hand
kernels (K2 forward; K3 and K4 backward) and on the CPU their plain
versions. ``"xla"`` is the dense O(T²) reference. Like ``ring_attention``
it takes the global tensors, replicated on every rank, and returns the
global output replicated.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tensor2robot_tpu_torch.ops.flash_attention import flash_attention
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import Mesh
from tensor2robot_tpu_torch.parallel.ring_attention import (
    _global,
    _local,
    dense_attention_reference,
)


def _local_attention(q, k, v, causal: bool, scale: float, attn_impl: str):
  if attn_impl == "pallas":
    return flash_attention(q, k, v, causal=causal, scale=scale)
  return dense_attention_reference(q, k, v, causal=causal, scale=scale)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Optional[Mesh], axis: str = "seq",
                      causal: bool = False, scale: Optional[float] = None,
                      batch_axis: Optional[str] = None,
                      attn_impl: str = "xla") -> torch.Tensor:
  """Exact multi-head attention with the sequence split over `axis`,
  through a head-scatter / sequence-gather all_to_all.

  Args:
    q, k, v: (B, T, H, D), replicated on every rank; T and H must divide
      over the axis.
    mesh: the rank mesh; None runs the whole attention on this rank.
    axis, causal, scale, batch_axis: as ``ring_attention``.
    attn_impl: "xla" (dense local attention) or "pallas" (the flash
      kernels K2-K4 locally).

  Returns:
    (B, T, H, D) in q's dtype, replicated on every rank.
  """
  if attn_impl not in ("xla", "pallas"):
    raise ValueError(
        f"attn_impl must be 'xla' or 'pallas', got {attn_impl!r} — a "
        "typo here would silently fall back to the dense O(T²) path.")
  num_shards = 1 if mesh is None else mesh.shape[axis]
  if q.shape[2] % num_shards != 0:
    raise ValueError(
        f"Ulysses needs heads ({q.shape[2]}) divisible by the {axis!r} "
        f"axis size ({num_shards}); use ring_attention otherwise.")
  if scale is None:
    scale = 1.0 / math.sqrt(q.shape[-1])
  group = None if mesh is None else mesh.group(axis)
  qkv = torch.stack([_local(x, mesh, axis, batch_axis) for x in (q, k, v)])
  # Sequence blocks -> head blocks: (3, B, Tl, H, D) -> (3, B, T, H/P, D).
  qkv = collectives.differentiable_all_to_all(qkv, group, 3, 2)
  out = _local_attention(qkv[0], qkv[1], qkv[2], bool(causal), float(scale),
                         attn_impl)
  # Head blocks -> sequence blocks: the inverse all_to_all.
  out = collectives.differentiable_all_to_all(out, group, 1, 2)
  return _global(out, mesh, axis, batch_axis)
