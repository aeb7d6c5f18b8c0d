"""Maps over the nested batches the port passes around.

A batch is a TensorSpecStruct, a mapping, a tuple or a list of arrays or
tensors, nested; None stands for an absent part (labels, say). The
counterpart of the ``jax.tree_util`` calls the JAX package makes on them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
  """Applies `fn` to every leaf of `tree`, and the matching leaves of the
  `rest` trees (of the same structure), keeping the containers' types;
  None stays None."""
  if tree is None:
    return None
  if isinstance(tree, ts.TensorSpecStruct):
    return ts.TensorSpecStruct(
        (k, fn(v, *(r[k] for r in rest))) for k, v in tree.items())
  if isinstance(tree, Mapping):
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
  return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
  """The leaves of `tree`, in ``tree_map``'s order."""
  if tree is None:
    return
  if isinstance(tree, Mapping):
    for value in tree.values():
      yield from tree_leaves(value)
  elif isinstance(tree, (tuple, list)):
    for value in tree:
      yield from tree_leaves(value)
  else:
    yield tree
