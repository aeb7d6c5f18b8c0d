"""Meta-batched data: nested (task, sample, ...) batches.

Counterpart of ``tensor2robot_tpu/meta_learning/meta_data.py``:
``multi_batch_apply`` pushes (task, sample, ...) arrays through a function
that takes one batch axis, and ``meta_batch_from_arrays`` splits per-task
sample pools into the condition/inference meta-batch ``MAMLModel`` takes.
Both are numpy (or tensor) code that gives the JAX package's arrays bit
for bit on the same inputs and seeds.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.utils.tree import tree_leaves, tree_map


def multi_batch_apply(fn: Callable, num_batch_dims: int, *arrays: Any,
                      **kwargs) -> Any:
  """Applies `fn` with the leading `num_batch_dims` axes merged into one,
  then splits them again on every leaf of its output."""
  leaves = list(tree_leaves(arrays))
  if not leaves:
    return fn(*arrays, **kwargs)
  lead = tuple(leaves[0].shape[:num_batch_dims])

  def merge(x):
    return x.reshape((-1,) + tuple(x.shape[num_batch_dims:]))

  def split(x):
    return x.reshape(lead + tuple(x.shape[1:]))

  out = fn(*tree_map(merge, arrays), **kwargs)
  return tree_map(split, out)


def meta_batch_from_arrays(
    features_per_task: ts.TensorSpecStruct,
    labels_per_task: ts.TensorSpecStruct,
    num_condition_samples: int,
    num_inference_samples: int,
    rng: Optional[np.random.Generator] = None,
) -> ts.TensorSpecStruct:
  """One MAML meta-feature struct from per-task sample pools.

  Args:
    features_per_task / labels_per_task: flat structs of arrays shaped
      (num_tasks, pool_size, ...).
    num_condition_samples / num_inference_samples: the split sizes; the
      pool must hold at least their sum.
    rng: shuffles each task's pool before the split when given.

  Returns:
    A flat struct with condition/features/*, condition/labels/*,
    inference/features/* and inference/labels/*.
  """
  flat_features = ts.flatten_spec_structure(features_per_task)
  flat_labels = ts.flatten_spec_structure(labels_per_task)
  any_leaf = next(iter(flat_features.values()))
  num_tasks, pool = any_leaf.shape[:2]
  need = num_condition_samples + num_inference_samples
  if pool < need:
    raise ValueError(
        f"Per-task pool of {pool} samples cannot supply "
        f"{num_condition_samples}+{num_inference_samples}.")
  if rng is not None:
    order = np.stack([rng.permutation(pool) for _ in range(num_tasks)])
  else:
    order = np.broadcast_to(np.arange(pool), (num_tasks, pool))
  cond_idx = order[:, :num_condition_samples]
  inf_idx = order[:, num_condition_samples:need]

  def gather(array, idx):
    return np.stack([array[t][idx[t]] for t in range(num_tasks)])

  out = ts.TensorSpecStruct()
  for key, value in flat_features.items():
    out[f"condition/features/{key}"] = gather(value, cond_idx)
    out[f"inference/features/{key}"] = gather(value, inf_idx)
  for key, value in flat_labels.items():
    out[f"condition/labels/{key}"] = gather(value, cond_idx)
    out[f"inference/labels/{key}"] = gather(value, inf_idx)
  return out
