"""Weight bridge: a flax variables tree <-> the port's ``state_dict``.

The flax tree is nested dicts of arrays or tensors, as ``load_variables``
of either package returns it: ``{"params": ..., "batch_stats": ...}``. A
leaf at ``<collection>/<scope...>/<name>`` maps to the state_dict key
``<scope...>.<torch name>``:

    params/<scope>/kernel   4-d HWIO conv kernel -> weight, OIHW
    params/<scope>/kernel   3-d (k, in, out) conv -> weight, (out, in, k)
    params/<scope>/kernel   2-d (in, out) Dense  -> weight, (out, in)
    params/<scope>/scale    norm scale           -> weight
    params/<scope>/bias                          -> bias
    batch_stats/<scope>/mean                     -> running_mean
    batch_stats/<scope>/var                      -> running_var
    params/stem_s2d_kernel, params/stem_s2d_bias -> the same names, as they
                           are (the QT-Opt critic's folded stem, which keeps
                           the JAX op's (8, 2, 4C, O) layout in the port)

A params-only tree (the EMA copy a JAX ``TrainState`` keeps in
``ema_params``) maps with ``params_to_state_dict`` onto the module's
parameters alone.

Both directions raise on any leaf they cannot map, and the flax->torch
direction also on any key of the module that no leaf fills: nothing is
skipped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

from tensor2robot_tpu_torch.export.variables_io import to_tensor

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
# Top-level parameters that keep their flax name and layout (the
# flagship's space-to-depth stem; the serving smokes' TinyQ ``w``).
_VERBATIM = ("stem_s2d_kernel", "stem_s2d_bias", "w")


def _leaves(tree: Mapping[str, Any], prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def _to_torch(collection: str, path, leaf) -> tuple:
  """(state_dict key, tensor) of one flax leaf; raises if unmapped."""
  *scope, name = path
  tensor = to_tensor(leaf)
  where = "/".join((collection,) + tuple(path))
  if collection == "params" and not scope and name in _VERBATIM:
    return name, tensor
  if not scope:
    raise KeyError(f"Flax leaf {where!r} has no module scope.")
  if collection == "params" and name == "kernel" and tensor.dim() == 4:
    name, tensor = "weight", tensor.permute(3, 2, 0, 1)
  elif collection == "params" and name == "kernel" and tensor.dim() == 3:
    name, tensor = "weight", tensor.permute(2, 1, 0)
  elif collection == "params" and name == "kernel" and tensor.dim() == 2:
    name, tensor = "weight", tensor.t()
  elif collection == "params" and name == "scale":
    name = "weight"
  elif collection == "params" and name == "bias":
    pass
  elif collection == "batch_stats" and name in _STATS:
    name = _STATS[name]
  else:
    raise KeyError(f"Flax leaf {where!r} has no mapping to a state_dict key.")
  return ".".join(scope + [name]), tensor


def flax_last_axis(key: str, ndim: int) -> int:
  """The axis of state_dict tensor `key` (of rank `ndim`) that holds its
  flax leaf's LAST axis, the output channel of a flax kernel: 0 for a
  ``weight`` the bridge transposes (OIHW, (out, in, k), (out, in)), the
  last for a leaf kept verbatim (``stem_s2d_kernel``) and for a vector.
  Raises for a key with no flax counterpart."""
  *scope, name = key.split(".")
  if not scope and name in _VERBATIM or ndim < 2:
    return ndim - 1
  if scope and name == "weight" and ndim in (2, 3, 4):
    return 0
  raise KeyError(f"state_dict key {key!r} of rank {ndim} has no flax "
                 "counterpart.")


def variables_to_state_dict(variables: Mapping[str, Any],
                            module: nn.Module) -> Dict[str, torch.Tensor]:
  """The flax variables tree as a state_dict for `module`, on the CPU.

  Every key of ``module.state_dict()`` must be filled, with its shape, and
  every leaf of the tree must land on one; tensors take the module's dtype.
  """
  return _map_onto(variables, module.state_dict(), type(module).__name__)


def params_to_state_dict(params: Mapping[str, Any],
                         module: nn.Module) -> Dict[str, torch.Tensor]:
  """A flax params tree (no collection level, as an EMA copy) as `module`'s
  parameters, on the CPU: every parameter filled, no buffer."""
  return _map_onto({"params": params}, dict(module.named_parameters()),
                   type(module).__name__)


def _map_onto(variables: Mapping[str, Any],
              expected: Mapping[str, torch.Tensor],
              owner: str) -> Dict[str, torch.Tensor]:
  out: Dict[str, torch.Tensor] = {}
  for collection, tree in variables.items():
    if not isinstance(tree, Mapping):
      raise KeyError(f"Flax collection {collection!r} is not a tree.")
    for path, leaf in _leaves(tree):
      key, tensor = _to_torch(collection, path, leaf)
      if key not in expected:
        raise KeyError(
            f"Flax leaf {'/'.join((collection,) + path)!r} maps to {key!r}, "
            f"which {owner} does not have.")
      if tuple(tensor.shape) != tuple(expected[key].shape):
        raise ValueError(
            f"{key!r}: flax gives shape {tuple(tensor.shape)}, the module "
            f"has {tuple(expected[key].shape)}.")
      out[key] = tensor.to(expected[key].dtype).contiguous()
  missing = sorted(set(expected) - set(out))
  if missing:
    raise KeyError(f"Flax variables leave module keys unfilled: {missing}")
  return {key: out[key] for key in expected}  # in the module's order


def state_dict_to_variables(
    state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """Inverse of `variables_to_state_dict`: nested dicts of CPU tensors."""
  tree: Dict[str, Any] = {}
  for key, tensor in state_dict.items():
    *scope, name = key.split(".")
    tensor = tensor.detach().cpu()
    if not scope and name in _VERBATIM:
      tree.setdefault("params", {})[name] = tensor.contiguous()
      continue
    if name == "weight" and tensor.dim() == 4:
      collection, leaf, tensor = "params", "kernel", tensor.permute(2, 3, 1, 0)
    elif name == "weight" and tensor.dim() == 3:
      collection, leaf, tensor = "params", "kernel", tensor.permute(2, 1, 0)
    elif name == "weight" and tensor.dim() == 2:
      collection, leaf, tensor = "params", "kernel", tensor.t()
    elif name == "weight" and tensor.dim() == 1:
      collection, leaf = "params", "scale"
    elif name == "bias":
      collection, leaf = "params", "bias"
    elif name in _STATS_BACK:
      collection, leaf = "batch_stats", _STATS_BACK[name]
    else:
      raise KeyError(f"state_dict key {key!r} has no flax counterpart.")
    if not scope:
      raise KeyError(f"state_dict key {key!r} has no module scope.")
    node = tree.setdefault(collection, {})
    for part in scope:
      node = node.setdefault(part, {})
    node[leaf] = tensor.contiguous()
  return tree
