"""How a train state lies over a mesh of ranks, and the step's collectives.

The JAX trainer pins shardings and lets XLA insert the collectives; here
they are written where each layout needs them. Every rank holds:

- **parameters**: its block of each parameter's spec (``tp_rules``): the
  whole tensor when replicated (data parallelism); a block of the data
  axis under FSDP; a block of the model axis under tensor parallelism.
- **optimizer state**: over the parameters' blocks, or under ZeRO-1 over
  a block of each of them that the data axis splits further on its
  largest divisible unclaimed dim (``tp_rules.compose_data_axis_spec``,
  the JAX trainer's ``_constrain_opt_state``); with tensor parallelism
  alone the moments mirror the parameter spec exactly.
- **batch statistics**: whole, the same on every rank.
- **the batch**: its block of the data axis (``mesh.shard_batch``).

A step, on each rank:

1. The forward's parameters. FSDP blocks are gathered over the data axis
   (their gradient is reduce-scattered). A module that computes with its
   own ``weight`` (``vision_layers.Conv``, ``Dense``,
   ``strided_conv.FoldedStridedConv3x3``, torch's ``Linear``/``Conv*d``)
   and whose weight the model axis splits on its output channels is
   **column-parallel**: it keeps its block and computes its block of the
   output channels from the whole input; a forward hook gathers the
   output's channels, and a pre-hook makes its input's gradient the sum
   over the model axis (Megatron's f). A replicated bias of such a module
   enters as its block. Every other parameter the model axis splits (norm
   scales, a raw kernel a parent uses) is gathered for the forward: its
   computation runs on every rank alike. Activations between modules are
   therefore whole, so dropout, residual adds and pooling see what the
   one-rank run sees.
2. BatchNorm in training normalises with the global batch's moments
   (``vision_layers.synced_statistics``), and dropout draws the global
   batch's mask and keeps this rank's rows (``dropout.batch_shard``), so
   the step equals the one-rank step on the global batch up to float
   reassociation.
3. The loss is divided by the data axis's size before the backward, so
   the data axis's reductions are sums: a replicated parameter's gradient
   is all-reduced, a ZeRO-1 block's reduce-scattered, an FSDP block's
   already summed by its gather.
4. The optimizer steps its blocks; ZeRO-1's updated blocks are gathered
   back over the data axis into the parameters. The EMA moves each
   parameter block; metrics are averaged over the data axis.

``full_payload`` gathers a state into the one-rank checkpoint layout
(parameters, statistics, EMA and optimizer moments whole), stamped with
the mesh's geometry; ``load_payload`` takes each rank's blocks of one.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.layers import dropout as dropout_lib
from tensor2robot_tpu_torch.layers import vision_layers
from tensor2robot_tpu_torch.ops.strided_conv import FoldedStridedConv3x3
from tensor2robot_tpu_torch.parallel import collectives, mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import tp_rules
from tensor2robot_tpu_torch.parallel.mesh import Mesh, PartitionSpec
from tensor2robot_tpu_torch.train.checkpoints import mesh_geometry

Tensors = Dict[str, torch.Tensor]

# Modules whose forward computes with their own ``weight`` (and ``bias``)
# and nothing else of theirs: these can compute a block of their output.
_COLUMN_MODULES = (vision_layers.Conv, vision_layers.Dense,
                   FoldedStridedConv3x3, nn.Linear, nn.Conv1d, nn.Conv2d,
                   nn.Conv3d)
_ACTIVE = threading.local()


def _exact_type(module: nn.Module) -> bool:
  """A module of one of the column classes, not a subclass with a forward
  of its own."""
  return any(type(module).forward is cls.forward for cls in _COLUMN_MODULES)


class MeshLayout:
  """One model's layout over a mesh: each parameter's spec, the optimizer
  blocks', the column-parallel modules, and the collectives of a step."""

  def __init__(self, model, mesh: Mesh, param_specs=None,
               shard_optimizer_state: bool = False, data_axis: str = "data"):
    if mesh.is_virtual:
      raise ValueError(f"{mesh} has no process groups on this process; "
                       "initialize the ranks before building the trainer.")
    self.model = model
    self.mesh = mesh
    self.data_axis = data_axis
    self.shard_optimizer_state = shard_optimizer_state
    self.data_size = mesh.shape.get(data_axis, 1)
    self.data_group = (mesh.group(data_axis) if data_axis in mesh.shape
                       else None)
    params = dict(model.module.named_parameters())
    if param_specs is None:
      self.specs = {key: PartitionSpec() for key in params}
    else:
      self.specs = tp_rules.state_dict_specs(param_specs, params)
    for key, spec in self.specs.items():
      self._check_spec(key, tuple(params[key].shape), spec)
      if shard_optimizer_state and data_axis in spec.axes():
        raise ValueError(
            f"{key}: its spec {spec} already splits over {data_axis!r} "
            "(FSDP shards the optimizer state with the parameters; ZeRO-3 "
            "subsumes ZeRO-1); drop shard_optimizer_state.")
    self.opt_specs = (
        tp_rules.zero1_specs(params, self.specs, data_axis, self.data_size)
        if shard_optimizer_state and self.data_size > 1 else self.specs)
    # Column-parallel modules: {module name: model axis}.
    self.columns: Dict[str, str] = {}
    for name, module in model.module.named_modules():
      weight = f"{name}.weight" if name else "weight"
      if not _exact_type(module) or weight not in self.specs:
        continue
      axes = [a for a in self.specs[weight] if a not in (None, data_axis)]
      if len(axes) == 1 and self.specs[weight].at(0) == axes[0]:
        self.columns[name] = axes[0]
    self._hooked = set()
    self._fired = set()
    self._checked = False

  def _check_spec(self, key: str, shape: Tuple[int, ...],
                  spec: PartitionSpec) -> None:
    if len(spec) > len(shape):
      raise ValueError(f"{key}: spec {spec} has more entries than its "
                       f"shape {shape}")
    for dim, axis in enumerate(spec):
      if axis is None:
        continue
      if axis not in self.mesh.shape:
        raise ValueError(f"{key}: spec {spec} names axis {axis!r}, which "
                         f"the mesh {dict(self.mesh.shape)} lacks")
      if shape[dim] % self.mesh.shape[axis]:
        raise ValueError(
            f"{key}: dim {dim} (size {shape[dim]}) does not divide over "
            f"{axis!r} of size {self.mesh.shape[axis]}")

  # --- blocks -----------------------------------------------------------------

  def local(self, tensor: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of a whole tensor (a view)."""
    return mesh_lib.local_block(tensor, self.mesh, spec)

  def gather(self, tensor: torch.Tensor, spec: PartitionSpec
             ) -> torch.Tensor:
    """The whole tensor of every rank's block (no gradient)."""
    for dim, axis in enumerate(spec):
      if axis is not None:
        tensor = collectives.all_gather(tensor, self.mesh.group(axis), dim)
    return tensor

  def _column_of(self, key: str) -> Optional[str]:
    module, _, name = key.rpartition(".")
    if name in ("weight", "bias") and module in self.columns:
      return self.columns[module]
    return None

  # --- state ------------------------------------------------------------------

  def shard(self, state, create_optimizer):
    """A whole one-rank state -> this rank's blocks of it, with the
    optimizer built over the blocks it steps."""
    import dataclasses
    params = {key: self.local(value, self.specs[key]).detach().clone()
              .requires_grad_() for key, value in state.params.items()}
    ema = None
    if state.ema_params is not None:
      ema = {key: self.local(value, self.specs[key]).detach().clone()
             for key, value in state.ema_params.items()}
    owned = None
    if self.shard_optimizer_state:
      owned = {key: self.local(value, self.opt_specs[key]).detach().clone()
               .requires_grad_() for key, value in state.params.items()}
    stepped = owned if owned is not None else params
    return dataclasses.replace(
        state, params=params, ema_params=ema, opt_params=owned,
        opt_state=create_optimizer(list(stepped.values())), layout=self)

  # --- the forward ------------------------------------------------------------

  def forward_variables(self, state, use_ema: bool = False) -> Tensors:
    """The variables a forward on this rank reads (see the docstring)."""
    source = state.eval_params if use_ema else state.params
    out = {}
    for key, value in source.items():
      spec = self.specs[key]
      for dim, axis in enumerate(spec):
        if axis == self.data_axis:
          value = collectives.gather_sum_grad(value, self.data_group, dim)
      column = self._column_of(key)
      if column is not None and spec.at(0) != column:
        value = collectives.slice_gather_grad(
            value, self.mesh.group(column), 0)
      elif column is None:
        for dim, axis in enumerate(spec):
          if axis not in (None, self.data_axis):
            value = collectives.gather_slice_grad(
                value, self.mesh.group(axis), dim)
      out[key] = value
    return {**out, **state.model_state}

  def _hook(self, module: nn.Module, axis: str) -> None:
    group = self.mesh.group(axis)
    dim = -1 if isinstance(module, (vision_layers.Dense, nn.Linear)) else 1

    def pre_hook(module, args):
      if getattr(_ACTIVE, "layout", None) is not self:
        return None
      self._fired.add(module)
      return (collectives.identity_sum_grad(args[0], group),) + args[1:]

    def post_hook(module, args, output):
      if getattr(_ACTIVE, "layout", None) is not self:
        return None
      return collectives.gather_slice_grad(output, group,
                                           dim % output.dim())

    module.register_forward_pre_hook(pre_hook)
    module.register_forward_hook(post_hook)

  @contextlib.contextmanager
  def forward_context(self, train: bool):
    """Hooks on, and in training the synced statistics and dropout's
    batch block, on this thread."""
    template = self.model.thread_module()
    if id(template) not in self._hooked:
      modules = dict(template.named_modules())
      for name, axis in self.columns.items():
        self._hook(modules[name], axis)
      self._hooked.add(id(template))
    previous = getattr(_ACTIVE, "layout", None)
    _ACTIVE.layout = self
    self._fired = set()
    with contextlib.ExitStack() as stack:
      if train and self.data_size > 1:
        stack.enter_context(vision_layers.synced_statistics(
            lambda x: collectives.mean(x, self.data_group)))
        stack.enter_context(dropout_lib.batch_shard(
            self.data_size, self.mesh.axis_index(self.data_axis)))
      try:
        yield
      finally:
        _ACTIVE.layout = previous
    if not self._checked:
      modules = dict(template.named_modules())
      idle = sorted(name for name in self.columns
                    if modules[name] not in self._fired)
      if idle:
        raise NotImplementedError(
            f"Tensor parallelism cannot split {idle}: their parent computes "
            "with their weight, so they never compute a block of their own "
            "output. Leave their weights off the model axis.")
      self._checked = True

  # --- the update -------------------------------------------------------------

  def reduce_gradients(self, state) -> None:
    """Sums the data axis's gradients; under ZeRO-1 into the optimizer
    blocks' ``grad``."""
    for key, param in state.params.items():
      grad = param.grad
      if grad is None:
        continue
      spec = self.specs[key]
      if self.data_axis in spec.axes():
        summed = grad  # the FSDP gather's backward summed it
      elif state.opt_params is not None:
        dims = [d for d, a in enumerate(self.opt_specs[key])
                if a == self.data_axis]
        summed = (collectives.reduce_scatter(grad, self.data_group, dims[0])
                  if dims else collectives.all_reduce(grad, self.data_group))
      else:
        summed = collectives.all_reduce(grad, self.data_group)
      if state.opt_params is not None:
        state.opt_params[key].grad = summed
        param.grad = None
      else:
        param.grad = summed

  def after_step(self, state) -> None:
    """ZeRO-1: gathers the stepped blocks back into the parameters."""
    if state.opt_params is None:
      return
    with torch.no_grad():
      for key, owned in state.opt_params.items():
        dims = [d for d, a in enumerate(self.opt_specs[key])
                if a == self.data_axis and self.specs[key].at(d) is None]
        value = owned
        for dim in dims:
          value = collectives.all_gather(value, self.data_group, dim)
        state.params[key].copy_(value)

  def full_gradients(self, state) -> Tensors:
    """The reduced gradients whole (the optimizer's blocks' under ZeRO-1),
    on every rank; for checks."""
    stepped = state.opt_params if state.opt_params is not None else (
        state.params)
    specs = self.opt_specs if state.opt_params is not None else self.specs
    return {key: self.gather(value.grad, specs[key])
            for key, value in stepped.items() if value.grad is not None}

  def average(self, metrics: Tensors) -> Tensors:
    """Metrics averaged over the data axis (one collective for all)."""
    if self.data_group is None or not metrics:
      return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(())
                           for k in keys])
    averaged = collectives.all_reduce(stacked, self.data_group, mean=True)
    return {k: averaged[i].to(metrics[k].dtype) for i, k in enumerate(keys)}

  def gradient_health(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global L2 norm, non-finite count) of the reduced gradients."""
    specs = self.opt_specs if state.opt_params is not None else self.specs
    tensors = state.opt_params if state.opt_params is not None else (
        state.params)
    return self._health({key: tensor.grad for key, tensor in tensors.items()
                         if tensor.grad is not None}, specs)

  def parameter_health(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global L2 norm, non-finite count) of the parameters: every rank's
    blocks counted once."""
    return self._health({key: value.detach()
                         for key, value in state.params.items()}, self.specs)

  def _health(self, tensors: Tensors, specs
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L2 norm, non-finite count) of whole tensors whose blocks `tensors`
    holds under `specs`: each block's sums added over its spec's axes."""
    by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for key, tensor in tensors.items():
      value = tensor.float()
      entry = torch.stack([value.square().sum(),
                           (~torch.isfinite(value)).sum().float()])
      by_axes.setdefault(specs[key].axes(), []).append(entry)
    total = None
    for axes, entries in by_axes.items():
      summed = torch.stack(entries).sum(dim=0)
      for axis in dict.fromkeys(axes):
        summed = collectives.all_reduce(summed, self.mesh.group(axis))
      total = summed if total is None else total + summed
    if total is None:
      total = torch.zeros(2)
    return total[0].sqrt(), total[1].to(torch.int32)

  # --- checkpoints ------------------------------------------------------------

  def full_payload(self, state) -> dict:
    """The state whole, as the one-rank ``CheckpointManager`` saves it,
    on every rank (every rank joins the gathers)."""
    params = {key: self.gather(value.detach(), self.specs[key])
              for key, value in state.params.items()}
    ema = None
    if state.ema_params is not None:
      ema = {key: self.gather(value, self.specs[key])
             for key, value in state.ema_params.items()}
    return {"params": params, "batch_stats": dict(state.model_state),
            "ema_params": ema,
            "optimizer": self._map_moments(state, self.gather),
            "mesh": mesh_geometry(self.mesh)}

  def _map_moments(self, state, fn) -> dict:
    """The optimizer's state_dict with `fn(tensor, spec)` applied to each
    per-parameter tensor shaped like its block (Adam's moments)."""
    state_dict = state.opt_state.state_dict()
    stepped = state.opt_params if state.opt_params is not None else (
        state.params)
    keys = list(stepped)
    specs = self.opt_specs if state.opt_params is not None else self.specs
    moments = {}
    for index, values in state_dict["state"].items():
      key = keys[index]
      shape = stepped[key].shape
      moments[index] = {
          name: (fn(value, specs[key]) if torch.is_tensor(value)
                 and value.shape == shape and value.dim() > 0 else value)
          for name, value in values.items()}
    return {**state_dict, "state": moments}

  def load_payload(self, state, payload: dict) -> dict:
    """`payload` (whole tensors) with each parameter, EMA and moment cut to
    this rank's block, for the one-rank restore to copy in."""
    params = {key: self.local(value, self.specs[key])
              for key, value in payload["params"].items()}
    ema = payload["ema_params"]
    if ema is not None:
      ema = {key: self.local(value, self.specs[key])
             for key, value in ema.items()}
    stepped = state.opt_params if state.opt_params is not None else (
        state.params)
    keys = list(stepped)
    specs = self.opt_specs if state.opt_params is not None else self.specs
    moments = {}
    for index, values in payload["optimizer"]["state"].items():
      key = keys[int(index)]
      full = payload["params"][key].shape
      moments[index] = {
          name: (self.local(value, specs[key]) if torch.is_tensor(value)
                 and value.shape == full and value.dim() > 0 else value)
          for name, value in values.items()}
    if state.opt_params is not None:
      with torch.no_grad():
        for key, owned in state.opt_params.items():
          owned.copy_(self.local(payload["params"][key], specs[key]))
    return {**payload, "params": params, "ema_params": ema,
            "optimizer": {**payload["optimizer"], "state": moments}}


def describe(layout: Optional[MeshLayout]) -> dict:
  """The layout for a result line: mesh, sharded parameter and optimizer
  elements on this rank against the whole."""
  if layout is None:
    return {"mesh": mesh_geometry(None)}
  params = dict(layout.model.module.named_parameters())
  whole = sum(p.numel() for p in params.values())

  def local(specs):
    total = 0
    for key, p in params.items():
      parts = math.prod(layout.mesh.shape[a] for a in specs[key].axes())
      total += p.numel() // parts
    return total

  return {"mesh": mesh_geometry(layout.mesh),
          "column_parallel_modules": sorted(layout.columns),
          "param_elements_local": local(layout.specs),
          "optimizer_elements_local": local(layout.opt_specs),
          "param_elements_whole": whole}
