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

A MAML model that learns its inner rates keeps, in JAX,
``params = {"base": <the base's params>, "inner_lrs": <the same tree, one
scalar a leaf>}`` (``tensor2robot_tpu/meta_learning/maml_model.py``). The
base maps as above; the rate at ``params/inner_lrs/<path>`` maps, as it is,
to ``inner_lrs.<key>``, where ``<key>`` is the state_dict key of the base
leaf at ``params/base/<path>``.

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
INNER_RATES = "inner_lrs"  # MAML's learned inner rates (see the docstring)
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


def variables_to_tensors(variables: Mapping[str, Any],
                         specs: Mapping[str, tuple],
                         owner: str) -> Dict[str, torch.Tensor]:
  """The flax variables tree as tensors of the given {key: (shape, dtype)}
  specs, on the CPU, with `variables_to_state_dict`'s checks: for a
  consumer with no module, as a serving program."""
  expected = {key: torch.empty(shape, dtype=dtype, device="meta")
              for key, (shape, dtype) in specs.items()}
  return _map_onto(variables, expected, owner)


def _split_rates(variables: Mapping[str, Any]):
  """(variables with the base's params, the MAML rates tree or None)."""
  params = variables.get("params")
  if isinstance(params, Mapping) and set(params) == {"base", INNER_RATES}:
    return {**variables, "params": params["base"]}, params[INNER_RATES]
  return variables, None


def _map_onto(variables: Mapping[str, Any],
              expected: Mapping[str, torch.Tensor],
              owner: str) -> Dict[str, torch.Tensor]:
  variables, rates = _split_rates(variables)
  mapped = []  # (flax path with its collection, state_dict key, tensor)
  for collection, tree in variables.items():
    if not isinstance(tree, Mapping):
      raise KeyError(f"Flax collection {collection!r} is not a tree.")
    for path, leaf in _leaves(tree):
      mapped.append(((collection,) + path,)
                    + _to_torch(collection, path, leaf))
  if rates is not None:
    base_keys = {where[1:]: key for where, key, _ in mapped
                 if where[0] == "params"}
    for path, leaf in _leaves(rates):
      where = ("params", INNER_RATES) + path
      if path not in base_keys:
        raise KeyError(f"Flax leaf {'/'.join(where)!r} has no base "
                       "parameter at its path.")
      mapped.append((where, f"{INNER_RATES}.{base_keys[path]}", to_tensor(leaf)))
  out: Dict[str, torch.Tensor] = {}
  for where, key, tensor in mapped:
    if key not in expected:
      raise KeyError(f"Flax leaf {'/'.join(where)!r} maps to {key!r}, which "
                     f"{owner} does not have.")
    if tuple(tensor.shape) != tuple(expected[key].shape):
      raise ValueError(
          f"{key!r}: flax gives shape {tuple(tensor.shape)}, the module "
          f"has {tuple(expected[key].shape)}.")
    out[key] = tensor.to(expected[key].dtype).contiguous()
  missing = sorted(set(expected) - set(out))
  if missing:
    raise KeyError(f"Flax variables leave module keys unfilled: {missing}")
  return {key: out[key] for key in expected}  # in the module's order


def _to_flax(key: str, tensor: torch.Tensor) -> tuple:
  """(collection, flax path, tensor) of one state_dict entry; raises if
  unmapped."""
  *scope, name = key.split(".")
  if not scope and name in _VERBATIM:
    return "params", (name,), tensor
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
  return collection, tuple(scope) + (leaf,), tensor


def _insert(tree: Dict[str, Any], path, tensor: torch.Tensor) -> None:
  *scope, leaf = path
  for part in scope:
    tree = tree.setdefault(part, {})
  tree[leaf] = tensor.contiguous()


def state_dict_to_variables(
    state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """Inverse of `variables_to_state_dict`: nested dicts of CPU tensors."""
  tree: Dict[str, Any] = {}
  rates: Dict[str, Any] = {}
  for key, tensor in state_dict.items():
    tensor = tensor.detach().cpu()
    if key.startswith(INNER_RATES + "."):
      base_key = key[len(INNER_RATES) + 1:]
      if base_key not in state_dict:
        raise KeyError(f"state_dict key {key!r} rates no base parameter.")
      _, path, _ = _to_flax(base_key, state_dict[base_key])
      _insert(rates, path, tensor)
      continue
    collection, path, tensor = _to_flax(key, tensor)
    _insert(tree.setdefault(collection, {}), path, tensor)
  if rates:
    tree["params"] = {"base": tree.get("params", {}), INNER_RATES: rates}
  return tree
