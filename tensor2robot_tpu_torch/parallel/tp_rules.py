"""Partition rules and spec inference for parameter trees.

Counterpart of ``tensor2robot_tpu/parallel/tp_rules.py``, on the same
trees: a parameter tree here is the flax params tree of the model
(``bridge.state_dict_to_variables``), nested dicts keyed by flax's names
(``pre_conv0/kernel``, HWIO), so one rule table reads the same leaves in
both packages and the inferred spec trees equal JAX's leaf for leaf. The
trainer maps a flax spec onto its ``state_dict`` tensor's layout with
``state_dict_specs`` (an OIHW ``weight``'s dims are the HWIO kernel's
permuted).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.parallel.mesh import Mesh, PartitionSpec


def _shape(leaf) -> Tuple[int, ...]:
  return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _is_spec(x) -> bool:
  return isinstance(x, PartitionSpec)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Tuple = ()) -> Any:
  """``fn(path, leaf, *rest_leaves)`` over nested dicts; a spec is a leaf."""
  if isinstance(tree, Mapping) and not _is_spec(tree):
    return {key: tree_map_with_path(fn, value, *(r[key] for r in rest),
                                    path=path + (key,))
            for key, value in tree.items()}
  return fn(path, tree, *rest)


def tree_flatten_with_path(tree: Any, path: Tuple = ()):
  """[(path, leaf)] of nested dicts, in order."""
  if isinstance(tree, Mapping) and not _is_spec(tree):
    out = []
    for key, value in tree.items():
      out += tree_flatten_with_path(value, path + (key,))
    return out
  return [(path, tree)]


def path_key(path, sep: str = "/") -> str:
  """Slash-joined name of a key path: ``("pre_conv0", "kernel")`` ->
  ``pre_conv0/kernel`` (JAX key objects' ``key``/``idx``/``name`` too)."""
  parts = []
  for entry in path:
    for attr in ("key", "idx", "name"):
      if hasattr(entry, attr):
        parts.append(str(getattr(entry, attr)))
        break
    else:
      parts.append(str(entry))
  return sep.join(parts)


def infer_dense_tp_specs(params: Any, mesh: Mesh, axis: str = "model",
                         min_width: int = 64) -> Any:
  """Column parallelism by shape: every leaf of ndim >= 2 whose last dim
  is >= min_width and divisible by the axis size gets P(..., axis); the
  rest, and every leaf when the mesh lacks `axis` or it has size 1, P()."""
  axis_size = mesh.shape.get(axis, 1)

  def rule(path, leaf):
    shape = _shape(leaf)
    if (axis_size > 1 and len(shape) >= 2
        and shape[-1] >= min_width and shape[-1] % axis_size == 0):
      return PartitionSpec(*([None] * (len(shape) - 1)), axis)
    return PartitionSpec()

  return tree_map_with_path(rule, params)


def match_partition_rules(rules: Sequence[Tuple[str, PartitionSpec]],
                          params: Any, sep: str = "/") -> Any:
  """Regex rules over a named tree -> spec tree: each leaf's path is
  matched with ``re.search`` in order and the first hit's spec wins.
  Scalar and size-1 leaves are P() before any rule runs. A leaf no rule
  matches raises (end a table with ``(".*", P())`` to replicate the
  rest)."""
  def match(path, leaf):
    name = path_key(path, sep)
    shape = _shape(leaf)
    if len(shape) == 0 or int(np.prod(shape, dtype=np.int64)) == 1:
      return PartitionSpec()
    for pattern, spec in rules:
      if re.search(pattern, name) is not None:
        return spec
    raise ValueError(f"Partition rule not found for param: {name}")

  return tree_map_with_path(match, params)


def param_shapes(model) -> Dict[str, Any]:
  """The model's flax params tree (of CPU tensors: the port builds its
  template module, whose initial values are never read)."""
  return bridge.state_dict_to_variables(
      dict(model.module.named_parameters()))["params"]


def partition_specs_for_model(model, mesh: Mesh, axis: str = "model"
                              ) -> Any:
  """The model's own TP layout (``model.partition_rules(axis=)``) over its
  params tree, checked against the mesh: every P() when the mesh lacks
  `axis`, the axis has size 1 or the model declares no rules; a sharded
  dim the axis size does not divide raises, naming the param."""
  shapes = param_shapes(model)
  axis_size = mesh.shape.get(axis, 1)
  rules_fn = getattr(model, "partition_rules", None)
  if axis_size <= 1 or rules_fn is None:
    return tree_map_with_path(lambda path, leaf: PartitionSpec(), shapes)
  specs = match_partition_rules(rules_fn(axis=axis), shapes)

  def validate(path, leaf, spec):
    shape = _shape(leaf)
    for dim, entry in enumerate(spec):
      if entry == axis and shape[dim] % axis_size != 0:
        raise ValueError(
            f"partition rule for {path_key(path)!r} shards dim {dim} "
            f"(size {shape[dim]}) over {axis!r} of size {axis_size}, "
            f"which does not divide it; fix the rule or the mesh")
    return spec

  return tree_map_with_path(validate, shapes, specs)


def compose_data_axis_spec(shape, base_spec: PartitionSpec, axis: str,
                           axis_size: int) -> PartitionSpec:
  """ZeRO-1's data-axis shard composed onto a (TP) spec: the largest
  `axis_size`-divisible dim the base leaves unclaimed splits over `axis`;
  with ``P()`` this is ``largest_divisible_dim_spec``."""
  base = list(base_spec) + [None] * (len(shape) - len(base_spec))
  divisible = [i for i, s in enumerate(shape)
               if base[i] is None and s >= axis_size
               and s % axis_size == 0]
  if not divisible:
    if any(entry is not None for entry in base):
      return PartitionSpec(*base)
    return PartitionSpec()
  dim = max(divisible, key=lambda i: shape[i])
  base[dim] = axis
  return PartitionSpec(*base)


def largest_divisible_dim_spec(shape, axis: str, axis_size: int
                               ) -> PartitionSpec:
  """`shape`'s largest axis_size-divisible dim split over `axis`; P() when
  none is (the rule behind FSDP and ZeRO-1)."""
  divisible = [i for i, s in enumerate(shape)
               if s >= axis_size and s % axis_size == 0]
  if not divisible:
    return PartitionSpec()
  dim = max(divisible, key=lambda i: shape[i])
  spec = [None] * len(shape)
  spec[dim] = axis
  return PartitionSpec(*spec)


def infer_dense_tp_specs_from_model(model, mesh: Mesh, axis: str = "model",
                                    min_width: int = 64) -> Any:
  return infer_dense_tp_specs(param_shapes(model), mesh, axis=axis,
                              min_width=min_width)


def infer_fsdp_specs(params: Any, mesh: Mesh, axis: str = "data",
                     min_size: int = 4096) -> Any:
  """FSDP (ZeRO-3) over the data axis: each leaf of >= min_size elements
  splits its largest axis-divisible dim over `axis`; smaller leaves, and
  every leaf when the axis is absent or of size 1, P()."""
  axis_size = mesh.shape.get(axis, 1)

  def rule(path, leaf):
    shape = _shape(leaf)
    if axis_size <= 1 or int(np.prod(shape, dtype=np.int64)) < min_size:
      return PartitionSpec()
    return largest_divisible_dim_spec(shape, axis, axis_size)

  return tree_map_with_path(rule, params)


def infer_fsdp_specs_from_model(model, mesh: Mesh, axis: str = "data",
                                min_size: int = 4096) -> Any:
  return infer_fsdp_specs(param_shapes(model), mesh, axis=axis,
                          min_size=min_size)


# flax dim of each torch dim, for the tensors the bridge transposes.
_TORCH_FROM_FLAX = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def torch_spec(key: str, ndim: int, flax_spec: PartitionSpec
               ) -> PartitionSpec:
  """`flax_spec` in the layout of state_dict tensor `key` (of rank
  `ndim`): a bridged ``weight``'s dims permuted as the bridge permutes the
  kernel; other tensors as they are."""
  entries = list(flax_spec) + [None] * (ndim - len(flax_spec))
  *scope, name = key.split(".")
  if scope and name == "weight" and ndim in _TORCH_FROM_FLAX:
    entries = [entries[d] for d in _TORCH_FROM_FLAX[ndim]]
  return PartitionSpec(*entries)


def flax_spec(key: str, ndim: int, spec: PartitionSpec) -> PartitionSpec:
  """`torch_spec`'s inverse: a state_dict tensor's spec in its flax leaf's
  layout."""
  entries = list(spec) + [None] * (ndim - len(spec))
  *scope, name = key.split(".")
  if scope and name == "weight" and ndim in _TORCH_FROM_FLAX:
    back = [None] * ndim
    for torch_dim, flax_dim in enumerate(_TORCH_FROM_FLAX[ndim]):
      back[flax_dim] = entries[torch_dim]
    entries = back
  return PartitionSpec(*entries)


def zero1_specs(params: Mapping[str, Any], specs: Mapping[str, PartitionSpec],
                axis: str, axis_size: int) -> Dict[str, PartitionSpec]:
  """ZeRO-1's optimizer specs in state_dict layout: each parameter's spec
  with the data axis composed on as the JAX trainer composes it, over the
  flax leaf's dims (so a tie between equal dims breaks as in JAX)."""
  out = {}
  for key, tensor in params.items():
    _, _, leaf = bridge._to_flax(key, tensor)  # noqa: SLF001
    composed = compose_data_axis_spec(
        tuple(leaf.shape), flax_spec(key, tensor.dim(), specs[key]), axis,
        axis_size)
    out[key] = torch_spec(key, tensor.dim(), composed)
  return out


def state_dict_specs(specs: Any, params: Mapping[str, Any]
                     ) -> Dict[str, PartitionSpec]:
  """{state_dict key: spec in that tensor's layout} for the parameters
  `params` ({key: tensor}), from a flax spec tree (or a prefix of one: a
  single spec applies to every leaf under it). Every key must be found."""
  flat = {}
  for key, tensor in params.items():
    _, path, _ = bridge._to_flax(key, tensor)  # noqa: SLF001
    node = specs
    for part in path:
      if _is_spec(node):
        break
      if not isinstance(node, Mapping) or part not in node:
        raise KeyError(f"param_specs has no spec for {'/'.join(path)!r} "
                       f"(state_dict key {key!r}).")
      node = node[part]
    if not _is_spec(node):
      raise KeyError(f"param_specs at {'/'.join(path)!r} is not a "
                     "PartitionSpec.")
    flat[key] = torch_spec(key, tensor.dim(), node)
  return flat
