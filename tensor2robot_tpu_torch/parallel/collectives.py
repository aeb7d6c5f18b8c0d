"""The parallel tier's one layer over ``torch.distributed``.

What the tier needs, over a mesh axis's process group (``Mesh.group``; a
group of None is an axis of size 1, where every op is the identity):
``all_reduce``, ``all_gather`` and ``reduce_scatter`` along a dimension,
``all_to_all`` between two dimensions, ``ring_shift`` (send to the
next rank of the ring, receive from the previous one), and over the whole
world ``broadcast_object`` (one rank's picklable object on every rank: the
replay loop's host batches). Below them, the
autograd functions that the trainer, ring and Ulysses attention
differentiate through.

Gloo takes some collectives on CUDA tensors and refuses others, and which
differs from one op to the next (``scripts/probe_gloo_collectives.py``,
run on the card; ``ROADMAP.md`` Facts keeps its answer). ``ROUTES`` is
that answer as a table keyed by backend and op: "native" calls the
backend on the tensor as it is; "staged" copies it into a pinned host
buffer, runs the op there and copies the answer back. The route comes from
the table alone, never from catching a failure. CPU tensors and NCCL run
every op natively. ``staged_bytes`` counts the bytes copied between the
card and the host, by op; ``payload_bytes`` the bytes each op's caller
hands it, by op; ``calls`` the ops, by op.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# (backend, op) -> route for CUDA tensors. From the probe on torch
# 2.11.0+cu128, two gloo ranks on one H100 (ROADMAP.md Facts): gloo takes
# all_reduce (sum, avg, max), all_gather, reduce_scatter, all_to_all and
# broadcast on CUDA tensors and answers right; send/recv of a CUDA tensor
# aborts the process (gloo's TCP pair writes from the device pointer).
# Ops absent here are native.
ROUTES: Dict[Tuple[str, str], str] = {
    ("gloo", "send_recv"): "staged",
}

staged_bytes: collections.Counter = collections.Counter()
payload_bytes: collections.Counter = collections.Counter()
calls: collections.Counter = collections.Counter()
_pinned: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}


def reset_counts() -> None:
  for counter in (staged_bytes, payload_bytes, calls):
    counter.clear()


def route(group, op: str, device: torch.device) -> str:
  """"native" or "staged": how `op` runs on a tensor on `device`."""
  if device.type != "cuda":
    return "native"
  return ROUTES.get((dist.get_backend(group), op), "native")


def group_size(group) -> int:
  return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
  return 0 if group is None else dist.get_rank(group)


def _host(tag: str, like: torch.Tensor) -> torch.Tensor:
  """A pinned host buffer of `like`'s shape and dtype, reused by tag."""
  key = (tag, like.dtype)
  buffer = _pinned.get(key)
  if buffer is None or buffer.numel() < like.numel():
    buffer = torch.empty(like.numel(), dtype=like.dtype,
                         pin_memory=torch.cuda.is_available())
    _pinned[key] = buffer
  return buffer[:like.numel()].view(like.shape)


def _run(op: str, group, inputs: Dict[str, torch.Tensor],
         outputs: Dict[str, torch.Tensor], call,
         in_place: bool = False) -> None:
  """Runs ``call(**inputs, **outputs)`` on the route of `op`: on the
  tensors themselves, or staged through pinned host copies of them. An
  `in_place` op reads its outputs too."""
  calls[op] += 1
  for tensor in (inputs or outputs).values():
    payload_bytes[op] += tensor.numel() * tensor.element_size()
  device = next(iter(outputs.values())).device
  if route(group, op, device) == "native":
    call(**inputs, **outputs)
    return
  host_in = {}
  for name, tensor in inputs.items():
    host_in[name] = _host(f"{op}:{name}", tensor)
    host_in[name].copy_(tensor)
    staged_bytes[op] += tensor.numel() * tensor.element_size()
  host_out = {name: _host(f"{op}:{name}", tensor)
              for name, tensor in outputs.items()}
  if in_place:
    for name, tensor in outputs.items():
      host_out[name].copy_(tensor)
      staged_bytes[op] += tensor.numel() * tensor.element_size()
  call(**host_in, **host_out)
  for name, tensor in outputs.items():
    tensor.copy_(host_out[name])
    staged_bytes[op] += tensor.numel() * tensor.element_size()


def all_reduce(x: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
  """The elementwise sum of `x` over the group (its mean with `mean`), as
  a new tensor."""
  if group is None:
    return x.clone()
  out = x.contiguous().clone()
  _run("all_reduce", group, {}, {"out": out},
       lambda out: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group),
       in_place=True)
  return out / group_size(group) if mean else out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """Every rank's `x`, concatenated along `dim` in group-rank order."""
  if group is None:
    return x
  size = group_size(group)
  moved = x.movedim(dim, 0).contiguous()
  out = moved.new_empty((size * moved.shape[0],) + moved.shape[1:])
  _run("all_gather", group, {"x": moved}, {"out": out},
       lambda x, out: dist.all_gather_into_tensor(out, x, group=group))
  return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """This rank's block along `dim` of the elementwise sum of every rank's
  `x`."""
  if group is None:
    return x
  size = group_size(group)
  moved = x.movedim(dim, 0).contiguous()
  if moved.shape[0] % size:
    raise ValueError(f"dim {dim} (size {moved.shape[0]}) does not divide "
                     f"over {size} ranks")
  out = moved.new_empty((moved.shape[0] // size,) + moved.shape[1:])
  _run("reduce_scatter", group, {"x": moved}, {"out": out},
       lambda x, out: dist.reduce_scatter_tensor(
           out, x, op=dist.ReduceOp.SUM, group=group))
  return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
  """`x` split into group-size blocks along `split_dim`, block j sent to
  group rank j; the blocks received concatenated along `concat_dim` in
  group-rank order (``jax.lax.all_to_all(tiled=True)``)."""
  if group is None:
    return x
  size = group_size(group)
  if x.shape[split_dim] % size:
    raise ValueError(f"dim {split_dim} (size {x.shape[split_dim]}) does "
                     f"not divide over {size} ranks")
  send = torch.stack(x.chunk(size, dim=split_dim)).contiguous()
  out = torch.empty_like(send)
  _run("all_to_all", group, {"x": send}, {"out": out},
       lambda x, out: dist.all_to_all_single(out, x, group=group))
  return torch.cat(out.unbind(0), dim=concat_dim)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
  """The `x` of the previous rank on the ring (each rank sends its own to
  the next)."""
  if group is None:
    return x
  size, me = group_size(group), group_rank(group)
  to = dist.get_global_rank(group, (me + 1) % size)
  source = dist.get_global_rank(group, (me - 1) % size)
  send = x.contiguous()
  out = torch.empty_like(send)

  def call(x, out):
    for request in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, to, group=group),
        dist.P2POp(dist.irecv, out, source, group=group)]):
      request.wait()

  _run("send_recv", group, {"x": send}, {"out": out}, call)
  return out


def _nbytes(obj) -> int:
  """The array bytes in `obj` and the dicts, tuples and lists it holds."""
  if isinstance(obj, dict):
    return sum(_nbytes(value) for value in obj.values())
  if isinstance(obj, (tuple, list)):
    return sum(_nbytes(value) for value in obj)
  return int(getattr(obj, "nbytes", 0))


def broadcast_object(obj, src: int = 0):
  """`obj` as global rank `src` holds it, on every rank of the world
  (pickled, through ``broadcast_object_list``); the identity without a
  process group. ``payload_bytes`` counts the arrays the source sends."""
  if not dist.is_initialized() or dist.get_world_size() == 1:
    return obj
  calls["broadcast_object"] += 1
  if dist.get_rank() == src:
    payload_bytes["broadcast_object"] += _nbytes(obj)
  box = [obj]
  dist.broadcast_object_list(box, src=src)
  return box[0]


def local_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
  """This rank's block of `x` along `dim` (a view)."""
  size = group_size(group)
  step = x.shape[dim] // size
  return x.narrow(dim, group_rank(group) * step, step)


# --- differentiable forms ----------------------------------------------------


class _GatherScatter(torch.autograd.Function):
  """all_gather forward; reduce_scatter (sum) backward: the FSDP gather of
  a parameter shard, whose gradient sums every rank's."""

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return all_gather(x, group, dim)

  @staticmethod
  def backward(ctx, grad):
    return reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _GatherSlice(torch.autograd.Function):
  """all_gather forward; this rank's block of the gradient backward: for
  what every rank then computes alike, so each gradient is whole."""

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return all_gather(x, group, dim)

  @staticmethod
  def backward(ctx, grad):
    return local_block(grad, ctx.group, ctx.dim).contiguous(), None, None


class _SliceGather(torch.autograd.Function):
  """This rank's block forward; all_gather of the blocks' gradients
  backward: a replicated tensor feeding a sharded computation."""

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return local_block(x, group, dim)

  @staticmethod
  def backward(ctx, grad):
    return all_gather(grad.contiguous(), ctx.group, ctx.dim), None, None


class _IdentitySum(torch.autograd.Function):
  """Identity forward; all_reduce (sum) backward: a replicated input whose
  consumers each see part of the computation (Megatron's f)."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce(grad, ctx.group), None


class _Mean(torch.autograd.Function):
  """all_reduce (mean) forward and backward: a statistic averaged over the
  group, each rank's loss reading the average."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return all_reduce(x, group, mean=True)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce(grad, ctx.group, mean=True), None


class _AllToAll(torch.autograd.Function):
  """all_to_all forward; the inverse all_to_all backward."""

  @staticmethod
  def forward(ctx, x, group, split_dim, concat_dim):
    ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
    return all_to_all(x, group, split_dim, concat_dim)

  @staticmethod
  def backward(ctx, grad):
    return (all_to_all(grad, ctx.group, ctx.concat_dim, ctx.split_dim),
            None, None, None)


def gather_sum_grad(x, group, dim: int = 0):
  return x if group is None else _GatherScatter.apply(x, group, dim)


def gather_slice_grad(x, group, dim: int = 0):
  return x if group is None else _GatherSlice.apply(x, group, dim)


def slice_gather_grad(x, group, dim: int = 0):
  return x if group is None else _SliceGather.apply(x, group, dim)


def identity_sum_grad(x, group):
  if group is None or not x.requires_grad:
    return x
  return _IdentitySum.apply(x, group)


def mean(x, group):
  return x if group is None else _Mean.apply(x, group)


def differentiable_all_to_all(x, group, split_dim: int, concat_dim: int):
  if group is None:
    return x
  return _AllToAll.apply(x, group, split_dim, concat_dim)


def describe(group: Optional[object] = None) -> dict:
  """The backend and each op's route for CUDA tensors (for a result
  line)."""
  backend = dist.get_backend(group) if dist.is_initialized() else None
  ops = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "send_recv")
  return {"backend": backend,
          "cuda_routes": {op: ROUTES.get((backend, op), "native")
                          for op in ops}}
