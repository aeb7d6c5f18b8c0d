"""Self-contained variables artifact: one flat .npz, no checkpoint deps.

Counterpart of ``tensor2robot_tpu/export/variables_io.py``, reading and
writing the same file: flat "/"-joined tree paths plus an embedded JSON
manifest. Leaves come back as CPU ``torch.Tensor``s. bfloat16 entries are
stored as raw byte views with the true dtype in the manifest; they are
read with ``torch.frombuffer`` so no numpy extension dtype is needed.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping

import numpy as np
import torch

MANIFEST_KEY = "__t2r_manifest__"
_EMPTY_DICTS_KEY = "__empty_dicts__"
_RESERVED_KEYS = (MANIFEST_KEY, _EMPTY_DICTS_KEY)
_SEP = "/"


def to_tensor(value: Any) -> torch.Tensor:
  """A tensor or array leaf as a CPU tensor; bfloat16 arrays included."""
  if isinstance(value, torch.Tensor):
    return value.detach().cpu()
  array = np.array(value)  # a copy: the tensor must own writable memory
  if array.dtype.name == "bfloat16":
    return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
  return torch.from_numpy(array)


def _flatten(variables: Mapping[str, Any], prefix: str = "",
             out: Dict[str, torch.Tensor] = None,
             empty: list = None) -> Dict[str, torch.Tensor]:
  if out is None:
    out = {}
  if empty is None:
    empty = []
  if prefix and not variables:
    # Empty collections (a stateless model's batch_stats) survive the
    # round trip: the JAX serving fn was traced with the exact tree.
    empty.append(prefix)
    return out
  for key, value in variables.items():
    if not isinstance(key, str):
      raise TypeError(f"Variable tree keys must be str, got {key!r}")
    if _SEP in key:
      raise ValueError(f"Variable name may not contain '{_SEP}': {key!r}")
    if key in _RESERVED_KEYS:
      raise ValueError(f"Variable name {key!r} is reserved")
    path = f"{prefix}{_SEP}{key}" if prefix else key
    if isinstance(value, Mapping):
      _flatten(value, path, out, empty)
    else:
      out[path] = to_tensor(value)
  return out


def _unflatten(flat: Mapping[str, torch.Tensor],
               empty_dicts: list = ()) -> Dict[str, Any]:
  tree: Dict[str, Any] = {}
  for path in empty_dicts:
    node = tree
    for part in path.split(_SEP):
      node = node.setdefault(part, {})
  for path, value in flat.items():
    parts = path.split(_SEP)
    node = tree
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = value
  return tree


def save_variables(path: str, variables: Mapping[str, Any]) -> None:
  """Writes a nested {str: tensor or array} tree to one npz file at `path`."""
  empty: list = []
  flat = _flatten(variables, empty=empty)
  manifest = {_EMPTY_DICTS_KEY: sorted(empty)}
  arrays = {}
  for key, value in flat.items():
    value = value.contiguous()
    if value.dtype == torch.bfloat16:
      manifest[key] = {"dtype": "bfloat16", "shape": list(value.shape)}
      arrays[key] = value.reshape(-1).view(torch.uint8).numpy()
    else:
      array = value.numpy()
      manifest[key] = {"dtype": array.dtype.name, "shape": list(array.shape)}
      arrays[key] = array
  arrays[MANIFEST_KEY] = np.frombuffer(
      json.dumps(manifest, sort_keys=True).encode("utf-8"), dtype=np.uint8)
  with open(path, "wb") as f:
    np.savez(f, **arrays)


def load_variables(path: str) -> Dict[str, Any]:
  """Inverse of `save_variables`; returns nested dicts of CPU tensors."""
  with np.load(path) as data:
    manifest = json.loads(bytes(data[MANIFEST_KEY]).decode("utf-8"))
    empty_dicts = manifest.pop(_EMPTY_DICTS_KEY, [])
    flat = {}
    for key, meta in manifest.items():
      value = data[key]
      if meta["dtype"] == "bfloat16":
        tensor = torch.frombuffer(bytearray(value.tobytes()),
                                  dtype=torch.bfloat16)
        flat[key] = tensor.reshape(meta["shape"])
        continue
      dtype = np.dtype(meta["dtype"])
      if value.dtype != dtype:
        value = value.view(dtype).reshape(meta["shape"])
      flat[key] = torch.from_numpy(np.array(value))
  return _unflatten(flat, empty_dicts)
